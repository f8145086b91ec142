"""The data x model mesh of the parallel paths.

Port of `egt_tpu/parallel/mesh.py`. JAX opens every local device in one
process and lays them out as a `jax.sharding.Mesh`; the port runs one
process a rank (`torchrun --standalone --nproc_per_node N -m ...`, or
processes that a caller starts with a `file://` store) and lays the ranks
out the same way: `make_mesh(n, model_parallel=mp)` reshapes ranks 0..n-1
to (n // mp, mp), so a rank's model group holds the mp ranks of its row
(its edge shards, or its tensor-parallel shards) and its data group the
n // mp ranks of its column (its batch shards).

A rank's device is `cuda:{local_rank % device_count}` unless the caller
names one (`--device cpu`); with no card and none named it raises. The
backend is NCCL where each rank has a card of its own, gloo otherwise (ranks
that share a card, or the CPU; gloo stages CUDA tensors through the host).
The choice is printed.

Every rank builds the same global batch (the dataset is seeded alike) and
keeps its data group's rows (`batch_shard`, `put_global_batch`), as JAX's
`put_global_batch` gives each process its devices' rows; a ragged last batch
is padded to the batch size by the reader, with `sample_mask` 0, so a rank
may hold only padding.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import Group, broadcast_


@dataclass
class Mesh:
    rank: int
    world: Group          # every rank
    data: Group           # this rank's batch shards (its mesh column)
    model: Group          # this rank's edge / tensor shards (its mesh row)
    device: torch.device
    backend: str | None   # None for a world of one

    @property
    def size(self) -> int:
        return self.world.size


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """`device` if named, else this rank's card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank; pass "
                           "--device cpu to run on the CPU")
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each local rank has a card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(num_devices: int | None = None, model_parallel: int = 1,
              device=None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              verbose: bool = True) -> Mesh:
    """Join the world and lay it out as (n // model_parallel,
    model_parallel). The world comes from an initialised
    `torch.distributed`, else from `init_method` (a `file://` store) with
    `rank` / `world_size`, else from the `RANK` / `WORLD_SIZE` /
    `MASTER_ADDR` / `MASTER_PORT` variables that `torchrun` sets; without
    any of them it is this process alone. `num_devices` (None: the world's
    size) must be the world's size."""
    if dist.is_initialized():
        rank, n = dist.get_rank(), dist.get_world_size()
        local_rank = _env_int("LOCAL_RANK", rank)
        dev = rank_device(device, local_rank)
        backend = dist.get_backend()
    else:
        rank = _env_int("RANK", 0) if rank is None else rank
        n = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
        local_rank = _env_int("LOCAL_RANK", rank)
        dev = rank_device(device, local_rank)
        backend = None
        if n > 1:
            backend = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE", n))
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=n)
    want = n if num_devices is None else int(num_devices)
    if want != n or n % model_parallel:
        ask = (f"{want} ranks" if want != n else
               f"a multiple of model_parallel={model_parallel} ranks")
        raise ValueError(
            f"the config asks for {ask} and this world has {n}: start one "
            f"process a rank with `torchrun --standalone --nproc_per_node N "
            f"-m egt_torch.run_training <config>`")
    dp = n // model_parallel
    rows = [tuple(range(d * model_parallel, (d + 1) * model_parallel))
            for d in range(dp)]
    cols = [tuple(d * model_parallel + j for d in range(dp))
            for j in range(model_parallel)]

    def groups(layout):
        # every rank creates every group, in the same order
        mine = None
        for ranks in layout:
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine = Group(pg, ranks, ranks.index(rank))
        return mine

    if n > 1:
        world = Group(dist.new_group(list(range(n))), tuple(range(n)), rank)
        model = groups(rows)
        data = groups(cols)
    else:
        world = model = data = Group(None, (0,), 0)
    if verbose and n > 1:
        print(f"rank {rank}/{n}: device {dev}, backend {backend}, mesh "
              f"{dp} data x {model_parallel} model", flush=True)
    return Mesh(rank=rank, world=world, data=data, model=model, device=dev,
                backend=backend)


def batch_shard(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (every field's leading axis split
    over the data group in order). The batch size must divide by it."""
    dp = mesh.data.size
    if dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % dp:
            raise ValueError(f"batch of {b} does not divide over {dp} data "
                             "shards")
        n = b // dp
        out[k] = v[mesh.data.index * n:(mesh.data.index + 1) * n]
    return out


def put_global_batch(batch: dict, mesh: Mesh) -> dict:
    """`batch_shard` on the mesh's device, as tensors."""
    return {k: torch.as_tensor(v).to(mesh.device)
            for k, v in batch_shard(batch, mesh).items()}


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer from rank 0 (JAX's
    `replicate_tree`)."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                broadcast_(t.data, mesh.world)
    return module
