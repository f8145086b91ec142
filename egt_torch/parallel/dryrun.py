"""Multi-rank dry run: one full training step (forward, backward, Adam) of a
tiny model over a data x model mesh.

Port of `egt_tpu/parallel/dryrun.py`. `run_one_step(n, model_parallel)`
runs data parallelism over n / model_parallel ranks and tensor parallelism
over model_parallel (`parallel/partitioning.py`); `run_one_step_sp(n, sp)`
data parallelism over n / sp and edge partitioning over sp
(`parallel/edge_partition.py`). Each is called in every rank of a world of
n (`launch.spawn_ranks`, or `torchrun`) and returns the step's loss, the
global batch's, on every rank.

    python -m egt_torch.parallel.dryrun N [--device cpu]

starts N ranks on this machine (on the card, or the CPU with `--device
cpu`) and prints both steps' losses beside the one-rank loss, and the
bytes, calls and host ms of rank 0's collectives in each.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.graph_model import EGTGraphModel, GraphModelConfig
from ..ops.rng import fold_seed
from ..training import metrics as M
from ..training import optim
from ..training.steps import DATA_RANK_TAG
from ..weights import load_npz
from . import collectives as C
from . import mesh as meshlib
from .edge_partition import forward_shard
from .launch import spawn_ranks
from .partitioning import shard_model


def tiny_model_config(**kw) -> GraphModelConfig:
    defaults = dict(
        model_width=32, edge_width=16, num_heads=4, model_height=2,
        node_input_kind="tokens", edge_input_kind="tokens",
        num_node_features=28, num_edge_features=4, num_targets=1,
        readout_kind="graph", upto_hop=2, random_mask_prob=0.1,
    )
    defaults.update(kw)
    return GraphModelConfig(**defaults)


def synthetic_batch(rng, b, l, num_node_feats=28, num_edge_feats=4):
    num_nodes = rng.integers(l // 2, l + 1, size=b)
    nodef = np.full((b, l), -1, np.int32)
    fmat = np.full((b, l, l), -1, np.int32)
    adj = np.zeros((b, l, l), np.float32)
    for i, n in enumerate(num_nodes):
        nodef[i, :n] = rng.integers(0, num_node_feats, size=n)
        m = 2 * n
        src = rng.integers(0, n, size=m)
        dst = (src + 1 + rng.integers(0, max(n - 1, 1), size=m)) % n
        adj[i, src, dst] = 1.0
        adj[i, np.arange(n), np.arange(n)] += 1.0
        fmat[i, src, dst] = rng.integers(0, num_edge_feats, size=m)
    return {
        "node_features": nodef,
        "feature_matrix": fmat,
        "graph_matrix": adj,
        "target": rng.normal(size=(b, 1)).astype(np.float32),
        "sample_mask": np.ones((b,), np.float32),
    }


def _steps(mesh, cfg, batch_size, max_len, weights, tensor_parallel,
           steps: int = 1, seed: int = 1) -> float:
    """The steps of both dry runs on `mesh`; the global batch's loss at the
    last step (before its update)."""
    model = EGTGraphModel(cfg, device=mesh.device)
    if weights is not None:
        load_npz(model, weights)
    meshlib.replicate(model, mesh)
    if tensor_parallel:
        shard_model(model, mesh.model)
    params = optim.trainable(model.named_parameters())
    optimizer = optim.make_optimizer(params, "adam", 1e-3)
    batch = meshlib.put_global_batch(
        synthetic_batch(np.random.default_rng(0), batch_size, max_len), mesh)
    for step in range(steps):
        loss = _step(model, optimizer, params, batch, mesh, tensor_parallel,
                     fold_seed(seed, step))
    return loss


def _step(model, optimizer, params, batch, mesh, tensor_parallel,
          seed) -> float:
    cfg = model.cfg
    # one seed a layer, with the data rank folded in (`training/steps.py`)
    tags = () if mesh.data.size == 1 else (DATA_RANK_TAG, mesh.data.index)
    seeds = [fold_seed(seed, *tags, 1000 + i) for i in range(cfg.model_height)]
    if tensor_parallel:
        out, ctx = model(batch, training=True, seeds=seeds,
                         with_context=True, tp=mesh.model,
                         data=mesh.data if mesh.data.size > 1 else None)
    else:
        out, ctx = forward_shard(model, batch, mesh, training=True,
                                 seeds=seeds, with_context=True)
    s, c = M.mae_loss(out, batch["target"], None, batch["sample_mask"])
    count = c.detach().clone()
    if mesh.data.size > 1:
        C.all_reduce_(count, mesh.data)
    loss = s / torch.clamp(count, min=1.0)
    for v in ctx.losses.values():
        loss = loss + v / mesh.data.size
    optimizer.zero_grad()
    (loss / mesh.model.size).backward()
    if tensor_parallel:
        sharded = [p for p in params if getattr(p, "tp_sharded", False)]
        whole = [p for p in params if not getattr(p, "tp_sharded", False)]
        C.sum_gradients(sharded, mesh.data)
        C.sum_gradients(whole, mesh.world)
    else:
        C.sum_gradients(params, mesh.world)
    optimizer.step()
    total = loss.detach().clone()
    if mesh.data.size > 1:
        C.all_reduce_(total, mesh.data)
    return float(total)


def run_one_step(n_devices: int, model_parallel: int | None = None,
                 batch_size: int | None = None, max_len: int = 16,
                 init: dict | None = None, weights: str | None = None,
                 device=None, steps: int = 1, **model_kw) -> float:
    """One Adam step with the batch sharded over 'data' and the layers'
    QKV / FFN-up columns and attention-out / FFN-down rows over 'model'
    (tensor parallelism); the loss. `init` joins the world (`make_mesh`'s
    keywords), `weights` a flat npz to start from (None: the model's own
    draw), `steps` > 1 takes more steps on the batch and gives the last
    one's loss, `model_kw` overrides `tiny_model_config`."""
    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = meshlib.make_mesh(n_devices, model_parallel=model_parallel,
                             device=device, verbose=False, **(init or {}))
    if batch_size is None:
        batch_size = 2 * mesh.data.size
    return _steps(mesh, tiny_model_config(**model_kw), batch_size, max_len,
                  weights, model_parallel > 1, steps)


def run_one_step_sp(n_devices: int, sp: int | None = None,
                    batch_size: int | None = None, max_len: int = 16,
                    init: dict | None = None, weights: str | None = None,
                    device=None, steps: int = 1, **model_kw) -> float:
    """One Adam step with the batch sharded over 'data' and the N x N grid
    and edge channel over 'model' (edge partitioning); the loss. The draws
    are off, as in JAX's. The keywords are `run_one_step`'s."""
    if sp is None:
        sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if max_len % sp:
        raise ValueError("max_len must divide by sp")
    mesh = meshlib.make_mesh(n_devices, model_parallel=sp, device=device,
                             verbose=False, **(init or {}))
    if batch_size is None:
        batch_size = 2 * mesh.data.size
    cfg = tiny_model_config(**{"random_mask_prob": 0.0, **model_kw})
    return _steps(mesh, cfg, batch_size, max_len, weights, False, steps)


def _rank(init, n, device):
    out = []
    for fn in (run_one_step, run_one_step_sp):
        C.STATS.reset()
        loss = fn(n, init=init, device=device)
        out.append((loss, C.STATS.summary()))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="ranks")
    parser.add_argument("--device", default=None,
                        help="torch device of every rank (default: the GPU)")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --device cpu")
    one = run_one_step(1, device=args.device)
    losses = spawn_ranks(_rank, args.n, args.n, args.device)
    (tp, tp_coll), (sp, sp_coll) = losses[0]
    print(f"1 rank: loss {one:.6f}; {args.n} ranks: dp x tp loss {tp:.6f}, "
          f"dp x sp loss {sp:.6f}", flush=True)
    print(f"rank 0's collectives: dp x tp {tp_coll}; dp x sp {sp_coll}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
