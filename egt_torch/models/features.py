"""Feature embeddings, initialisers and the adjacency hop stack.

Port of the parts of `egt_tpu/models/features.py` the ported schemes run:
Keras-style initialisers (drawn from an explicit `torch.Generator`), `dense`,
the -1-masked token embedding, the masked dense embedding (MNIST / CIFAR10
superpixel features), the clipped hop stack, the distance objective's
targets, the pairwise concatenation of the TSP edge readout, and the SVD
and eigenvector positional encodings with their training-time sign flips.

The flips are drawn from the port's Philox (`ops/rng.py`, draw index
`PE_FLIP`) on the input tensor's device from an explicit seed: one uniform a
(graph, feature), keyed by (graph, feature), with no host read and no global
generator. JAX's bits differ, so parity with JAX is statistical, as for the
attention draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import rng


# ---------------------------------------------------------------------- initializers


def glorot_uniform(shape, generator: torch.Generator, device=None):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    x = torch.rand(shape, generator=generator, device=device)
    return (2.0 * x - 1.0) * limit


def uniform_05(shape, generator: torch.Generator, device=None):
    """Keras 'uniform' initializer: U(-0.05, 0.05) (embeddings)."""
    x = torch.rand(shape, generator=generator, device=device)
    return (2.0 * x - 1.0) * 0.05


def dense_params(in_dim, out_dim, generator, device=None) -> nn.ParameterDict:
    """A Dense layer's parameters under the JAX names: kernel (in, out), bias."""
    return nn.ParameterDict({
        "kernel": nn.Parameter(glorot_uniform((in_dim, out_dim), generator,
                                              device)),
        "bias": nn.Parameter(torch.zeros(out_dim, device=device))})


def embedding_params(vocab, dim, generator, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "table": nn.Parameter(uniform_05((vocab, dim), generator, device))})


def dense(p, x):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


# ----------------------------------------------------------------------- embeddings


# Below this vocab size a lookup is a one-hot product: the table's gradient
# is then a small matrix product, where indexing's is a scatter-add of
# b * l * l rows onto a handful of table rows (the edge-token table has 5).
_ONEHOT_VOCAB_MAX = 64


def token_embed(p, ids):
    """-1-masked token lookup: table[ids + 1] (-1 padding hits row 0)."""
    table = p["table"]
    idx = ids.long() + 1
    if table.shape[0] <= _ONEHOT_VOCAB_MAX:
        oh = torch.nn.functional.one_hot(idx, table.shape[0]).to(table.dtype)
        return oh @ table
    return table[idx]


def masked_dense_embed(p, x, mask_value: float = -1.0):
    """Keras Masking + Dense: rows whose features all equal `mask_value` are
    zeroed before the projection."""
    valid = torch.any(x != mask_value, dim=-1, keepdim=True)
    return dense(p, x * valid.to(x.dtype))


# -------------------------------------------------------------- adjacency structure


def stack_hops(adj, upto_hop: int, clip_hops: bool = True):
    """[A, clip(A@A), ...] stacked on a new trailing axis. `upto_hop == 1`
    is just A[..., None]."""
    hops = [adj]
    hop = adj
    for _ in range(upto_hop - 1):
        hop = torch.matmul(adj, hop)
        if clip_hops:
            hop = torch.clamp(hop, 0.0, 1.0)
        hops.append(hop)
    return torch.stack(hops, dim=-1)


def distance_targets(adj, distance_target: int):
    """k-hop reachability counts: round(sum_k clip(A^k, 0, 1)) as int64, the
    distance objective's target."""
    total = adj
    hop = adj
    for _ in range(distance_target - 1):
        hop = torch.clamp(torch.matmul(adj, hop), 0.0, 1.0)
        total = total + hop
    return torch.round(total).long()


def pairwise_cat(row, col):
    """PairwiseOp 'cat': (b, l, w), (b, m, w') -> (b, l, m, w + w'), the row
    node's features then the column node's on every pair."""
    b, l, w = row.shape
    m = col.shape[1]
    return torch.cat([row[:, :, None, :].expand(b, l, m, w),
                      col[:, None, :, :].expand(b, l, m, col.shape[-1])],
                     dim=-1)


# --------------------------------------------------------------- positional encodings


def sign_flips(seed: int, b: int, k: int, device) -> torch.Tensor:
    """(b, k) f32 of -1 or +1, each with probability 1/2, one a (graph,
    feature), keyed by `seed`."""
    zero = torch.zeros((1, 1), dtype=torch.int64, device=device)
    u = rng.uniform(seed, torch.arange(b, device=device)[:, None], zero,
                    torch.arange(k, device=device)[None, :], zero, rng.PE_FLIP)
    return torch.where(u < 0.5, -1.0, 1.0)


def _flip_seed(random_neg: bool, training: bool, seed):
    if not (random_neg and training):
        return None
    if seed is None:
        raise ValueError("random_neg requires a seed at training time")
    return seed


def process_svd(p, svd, *, sel: int, model_width: int, transform: bool,
                random_neg: bool, training: bool, seed=None):
    """Keep `sel` singular-vector pairs of `svd` (b, l, k, 2), zero-pad them
    to width/2 unless `transform`, flip each (graph, feature)'s sign at
    training time with `random_neg` (the same flip for U and V and for
    every node), flatten [U, V] on the feature axis, and with `transform`
    project through `p`."""
    v = svd[:, :, :sel, :]
    if not transform:
        pad = max(0, model_width // 2 - sel)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    seed = _flip_seed(random_neg, training, seed)
    if seed is not None:
        flips = sign_flips(seed, v.shape[0], v.shape[2], v.device)
        v = v * flips[:, None, :, None].to(v.dtype)
    flat = torch.cat([v[..., 0], v[..., 1]], dim=-1)
    if transform:
        flat = dense(p, flat)
    return flat


def process_eig(p, eig, *, sel: int, model_width: int, transform: bool,
                random_neg: bool, training: bool, seed=None):
    """The eigenvector PE: keep `sel` eigenvectors of `eig` (b, l, k), pad
    to the width unless `transform`, the training-time sign flips as
    `process_svd`'s, and with `transform` project through `p`."""
    v = eig[:, :, :sel]
    if not transform:
        pad = max(0, model_width - sel)
        v = torch.nn.functional.pad(v, (0, pad))
    seed = _flip_seed(random_neg, training, seed)
    if seed is not None:
        flips = sign_flips(seed, v.shape[0], v.shape[2], v.device)
        v = v * flips[:, None, :].to(v.dtype)
    if transform:
        v = dense(p, v)
    return v
