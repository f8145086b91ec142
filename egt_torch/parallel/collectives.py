"""Autograd-aware collectives of the parallel paths.

The port's counterpart of the collectives that JAX's `shard_map` code calls
(`jax.lax.psum`, `jax.lax.all_gather(..., tiled=True)`) and of the
sequence-parallel row helpers of `egt_tpu/models/layers.py:50-75`. Each is
a `torch.autograd.Function` over a `Group` (a `torch.distributed` process
group, its size and this rank's index in it); a `Group` of one, or None,
makes each of them the identity, so one code path serves one process and
many.

Gradients (the rule that makes replicated work count once): every rank of
a group computes the same replicated loss and back-propagates it scaled by
1 / size; `psum`'s backward is a psum; `all_gather_rows`' backward sums the
cotangent over the ranks and keeps this rank's block (an `all_reduce` and a
slice: gloo has no reduce-scatter for CUDA tensors); the parameter
gradients are then summed over the group (`training/steps.py`). A row
block's contribution to a replicated tensor (K2's dk / dv of a block of
query rows, say) thus reaches it through the sum and nothing else.

`STATS` counts the bytes each collective kind moved (the result's bytes,
as `tools/bench_multichip.py::hlo_collective_bytes` counts them in JAX's
HLO), its calls and its seconds on the host clock (with gloo a collective
waits for its data, so that includes the copies through the host).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """A process group (None for one rank), its ranks in order and this
    rank's index among them."""
    pg: object
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class CollectiveStats:
    """Bytes, calls and host seconds a kind of collective ("all-reduce",
    "all-gather", "broadcast") took since the last `reset`."""

    def __init__(self):
        self.bytes = Counter()
        self.calls = Counter()
        self.seconds = Counter()

    def reset(self) -> None:
        self.bytes.clear()
        self.calls.clear()
        self.seconds.clear()

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.bytes[kind] += nbytes
        self.calls[kind] += 1
        self.seconds[kind] += seconds

    def summary(self) -> dict:
        return {k: {"bytes": self.bytes[k], "calls": self.calls[k],
                    "ms": 1e3 * self.seconds[k]} for k in sorted(self.bytes)}


STATS = CollectiveStats()


def _trivial(group: Group | None) -> bool:
    return group is None or group.size == 1


def all_reduce_(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum `x` in place over the group (no autograd)."""
    t0 = time.perf_counter()
    dist.all_reduce(x, group=group.pg)
    STATS.add("all-reduce", x.numel() * x.element_size(),
              time.perf_counter() - t0)
    return x


def all_gather_cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in group order (no
    autograd)."""
    x = x.contiguous()
    t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    out = torch.cat(parts, dim=dim)
    STATS.add("all-gather", out.numel() * out.element_size(),
              time.perf_counter() - t0)
    return out


def broadcast_(x: torch.Tensor, group: Group, src_index: int = 0):
    """Overwrite `x` with the group's rank `src_index`'s (no autograd)."""
    t0 = time.perf_counter()
    dist.broadcast(x, src=group.ranks[src_index], group=group.pg)
    STATS.add("broadcast", x.numel() * x.element_size(),
              time.perf_counter() - t0)
    return x


def sum_gradients(params, group: Group | None) -> None:
    """Sum the gradients of `params` over the group in one all-reduce (a
    parameter no loss reached counts zeros)."""
    if _trivial(group):
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]),
                       group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None


def psum(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """`jax.lax.psum`: the sum of `x` over the group, on every rank."""
    return x if _trivial(group) else _PSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group: Group | None,
                    dim: int = 1) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis, axis=dim, tiled=True)`: the ranks'
    blocks end to end along `dim`, in group order."""
    return x if _trivial(group) else _AllGather.apply(x, group, dim)


# ------------------------------------------------ sequence-parallel row helpers


def sp_row_slice(x, sp, dim: int = 1):
    """This shard's rows of a full-length tensor (past the virtual-node
    prefix): rows vn + index * lq to vn + (index + 1) * lq."""
    return x.narrow(dim, sp.vn + sp.index * sp.lq, sp.lq)


def sp_take_rows(x, sp, dim: int = 1):
    """The query-side rows of a full tensor: the replicated virtual-node
    prefix, then this shard's rows (the row layout of every pair tensor
    under edge partitioning)."""
    local = sp_row_slice(x, sp, dim)
    if sp.vn == 0:
        return local
    return torch.cat([x.narrow(dim, 0, sp.vn), local], dim=dim)


def sp_gather_rows(x, sp, dim: int = 1):
    """Full rows from the shards' row blocks; the virtual-node prefix,
    identical on every shard, is taken from this rank's block once."""
    if sp.vn == 0:
        return all_gather_rows(x, sp.group, dim)
    vn_part = x.narrow(dim, 0, sp.vn)
    local = x.narrow(dim, sp.vn, x.shape[dim] - sp.vn)
    return torch.cat([vn_part, all_gather_rows(local, sp.group, dim)],
                     dim=dim)
