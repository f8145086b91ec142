"""The EGT attention op (plain model path), inference only.

Port of `egt_tpu/models/egt.py::split_qkv` and `egt_attention_core`: scaled
QK^T logits, clipping, additive edge bias, additive `(mask-1)*1e9` key masking
on BOTH logits and gates, optional hard mask, softmax(keys) x sigmoid gating,
value aggregation and the degree scaler with virtual-node rows pinned to 1.

Layout follows the reference: the flat qkv feature axis factors as [3, d, h];
per-pair tensors are (b, l_q, l_k, h). Products take working-type operands and
accumulate in f32; with `chain_f32` the logits/softmax/gate chain is f32.
The JAX `impl="vpu"` is a TPU layout choice with the same math, so the port
has this one path (the config's `attention_impl` is not read).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EGTOutput(NamedTuple):
    v_att: torch.Tensor         # (b, l_q, d*h) aggregated values (degree-scaled)
    h_hat: torch.Tensor         # (b, l_q, l_k, h) logits+edge bias
    a_tild: torch.Tensor        # (b, l_q, l_k, h) post-gating attention matrix


def split_qkv(qkv: torch.Tensor, num_heads: int):
    """(b, l, 3*d*h) -> q, k, v each (b, l, d, h)."""
    b, l, f = qkv.shape
    if f % (3 * num_heads):
        raise ValueError(f"qkv feature dim {f} not divisible by 3*num_heads")
    d = f // (3 * num_heads)
    qkv = qkv.reshape(b, l, 3, d, num_heads)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def egt_attention_core(
    q, k, v,                    # q: (b, l_q, d, h);  k, v: (b, l_k, d, h)
    e_bias,                     # (b, l_q, l_k, h) | None
    gates,                      # (b, l_q, l_k, h) | None  (pre-sigmoid)
    *,
    node_mask=None,             # (b, l_k) bool/0-1 key-validity mask
    attn_mask=None,             # (b, l_q, l_k, h) hard mask (added as (m-1)*1e9)
    clip_logits_value=(-5.0, 5.0),
    scale_degree=False,
    scaler_type="log",
    num_virtual_nodes=0,
    random_mask_prob=0.0,
    attn_dropout=0.0,
    training=False,
    chain_f32=True,
) -> EGTOutput:
    if scale_degree and gates is None:
        raise ValueError("scale_degree requires gated attention")
    if scaler_type not in ("log", "linear"):
        raise ValueError(f"scaler_type must be log or linear, got {scaler_type}")
    if training and (random_mask_prob > 0.0 or attn_dropout > 0.0):
        raise NotImplementedError("random attention masking and attention "
                                  "dropout (training) are not ported yet")

    b, lq, d, h = q.shape
    out_dtype = q.dtype
    ct = torch.float32 if chain_f32 else out_dtype
    big = torch.tensor(1e9, dtype=ct, device=q.device)

    a_hat = (torch.einsum("bldh,bmdh->blmh", q.float(), k.float())
             * (d ** -0.5)).to(ct)
    if clip_logits_value is not None:
        a_hat = torch.clamp(a_hat, clip_logits_value[0], clip_logits_value[1])
    h_hat = a_hat
    if e_bias is not None:
        h_hat = h_hat + e_bias.to(ct)

    logits = h_hat
    g = None if gates is None else gates.to(ct)
    if node_mask is not None:
        madd = (node_mask.to(ct)[:, None, :, None] - 1.0) * big
        logits = logits + madd
        if g is not None:
            g = g + madd
    if attn_mask is not None:
        aadd = (attn_mask.to(ct) - 1.0) * big
        logits = logits + aadd
        if g is not None:
            g = g + aadd

    a_tild = torch.softmax(logits, dim=2)
    sg = None
    if g is not None:
        sg = torch.sigmoid(g)
        a_tild = a_tild * sg

    v_att = torch.einsum("blmh,bmdh->bldh", a_tild.to(out_dtype).float(),
                         v.float())

    if scale_degree:
        degrees = torch.sum(sg, dim=2, keepdim=True)        # (b, l_q, 1, h)
        scalers = torch.log1p(degrees) if scaler_type == "log" else degrees
        if num_virtual_nodes > 0:
            scalers = scalers.clone()
            scalers[:, :num_virtual_nodes] = 1.0
        v_att = v_att * scalers

    v_att = v_att.to(out_dtype).reshape(b, lq, d * h)
    return EGTOutput(v_att=v_att, h_hat=h_hat.to(out_dtype),
                     a_tild=a_tild.to(out_dtype))
