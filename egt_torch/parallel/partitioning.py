"""Tensor parallelism over the mesh's model group.

Port of `egt_tpu/parallel/partitioning.py` (`_RULES`, Megatron-style): in
every layer `dense_qkv` and `lr1` (of both FFNs) are column-parallel, each
rank keeping its share of the output features and of their bias, and
`dense_mha` and `lr2` row-parallel, each rank keeping the matching input
rows of the kernel, its partial products summed over the group (a psum)
before the bias, which every rank keeps whole. Everything else stays whole
on every rank.

A rank takes the columns of its own heads: JAX's QKV columns are ordered
(3, d, h) and dense_mha's rows (d, h), so a rank's columns are strided.
Its attention then runs on h / tp heads (K1 / K2 on CUDA tensors), with
those heads' columns of the edge bias and the gates, and h_hat is gathered
over the heads before dense_edge_r (`models/layers.py`). The weights are
loaded whole under the JAX flat names (`weights.py`) and sliced here.

Gradients: a sharded parameter's gradient is complete on its rank (its
output reaches the loss through psums, whose backward sums the group's
cotangents); it is summed over the data group only. A whole parameter's is
summed over every rank (`parallel/collectives.py`). `shard_model` marks the
sharded ones with `tp_sharded`.
"""

from __future__ import annotations

import torch
from torch import nn

from .collectives import Group

COLUMN, ROW = "column", "row"
# param-name -> how its kernel is split
RULES = {"dense_qkv": COLUMN, "dense_mha": ROW, "lr1": COLUMN, "lr2": ROW}


def head_columns(d: int, h: int, heads: range, parts: int) -> list[int]:
    """The indices of `heads`' features in a (parts, d, h) feature axis."""
    return [(i * d + dd) * h + hd for i in range(parts) for dd in range(d)
            for hd in heads]


def _shard(dense: nn.ParameterDict, rule: str, idx) -> None:
    with torch.no_grad():
        if rule == COLUMN:
            dense["kernel"] = nn.Parameter(dense["kernel"][:, idx].clone())
            dense["bias"] = nn.Parameter(dense["bias"][idx].clone())
            dense["bias"].tp_sharded = True
        else:
            dense["kernel"] = nn.Parameter(dense["kernel"][idx].clone())
        dense["kernel"].tp_sharded = True


def check_tensor_parallel(cfg, size: int) -> None:
    """Raise for a config that tensor parallelism over `size` ranks
    cannot split."""
    if cfg.num_heads % size:
        raise ValueError(f"{cfg.num_heads} heads do not divide over {size} "
                         "tensor-parallel ranks")
    if cfg.node2edge_xtalk > 0.0 or cfg.edge2node_xtalk > 0.0:
        raise NotImplementedError("tensor parallelism with FFN cross-talk "
                                  "(it splits the FFN's hidden features)")
    hn = round(cfg.model_width * cfg.ffn_multiplier)
    he = round(cfg.edge_width * cfg.ffn_multiplier)
    if hn % size or he % size:
        raise ValueError(f"FFN widths {hn} / {he} do not divide over {size} "
                         "tensor-parallel ranks")


def shard_model(model, group: Group):
    """Keep this rank's shard of every layer's split parameters (in place;
    the rest stays whole). Returns the model."""
    cfg = model.cfg
    tp = group.size
    if tp == 1:
        return model
    check_tensor_parallel(cfg, tp)
    h = cfg.num_heads
    d = cfg.model_width // h
    hl = h // tp
    heads = range(group.index * hl, (group.index + 1) * hl)
    for layer in model.stack["layers"]:
        _shard(layer["dense_qkv"], RULES["dense_qkv"],
               head_columns(d, h, heads, 3))
        _shard(layer["dense_mha"], RULES["dense_mha"],
               head_columns(d, h, heads, 1))
        for ffn in ("node_ffn", "edge_ffn"):
            if ffn not in layer:
                continue
            hid = layer[ffn]["lr1"]["kernel"].shape[1] // tp
            part = slice(group.index * hid, (group.index + 1) * hid)
            _shard(layer[ffn]["lr1"], RULES["lr1"], part)
            _shard(layer[ffn]["lr2"], RULES["lr2"], part)
    return model
