"""Feature embeddings, initialisers and the adjacency hop stack.

Port of the parts of `egt_tpu/models/features.py` the ZINC serving path runs:
Keras-style initialisers (drawn from an explicit `torch.Generator`), `dense`,
the -1-masked token embedding and the clipped hop stack.
"""

from __future__ import annotations

import math

import torch
from torch import nn


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


def token_embed(p, ids):
    """-1-masked token lookup: table[ids + 1] (-1 padding hits row 0)."""
    return p["table"][ids.long() + 1]


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
