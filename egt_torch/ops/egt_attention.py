"""EGT attention core with a hand-written CUDA forward kernel.

Port of `egt_tpu/ops/egt_pallas.py::egt_attention_fused` and `_egt_core_fwd`
(inference only). Head-major I/O as in JAX: q, k, v are (b, h, l, d); the edge
bias, the gates and h_hat are (b, h, lq, lk); `lq < lk` (a row block of the
queries against all keys) is allowed.

`egt_core_fwd` dispatches on the device of its inputs: a CPU tensor takes
`egt_core_fwd_plain`, a CUDA tensor launches `csrc/egt_attention_fwd.cu` (or
raises). The degree scaler stays in the wrapper, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda

KERNEL = _cuda.CudaKernel("egt_attention_fwd", _cuda.argtypes(
    "i ppppp pp ppp iiiii i fff"))


class FusedAttentionOutput(NamedTuple):
    v_att: torch.Tensor                 # (b, lq, d*h), degree-scaled
    h_hat: torch.Tensor                 # (b, h, lq, lk) head-major
    degrees: torch.Tensor | None        # (b, h, lq) f32, gated only


def egt_core_fwd_plain(q, k, v, e, g, madd, maddf, clip):
    """Plain PyTorch version of the kernel, with its rounding points: f32
    math, h_hat and A rounded to the working type, v_att stored in it.
    madd is (b, lk) and maddf (b, lq, lk) additive f32 masks."""
    dt = q.dtype
    d = q.shape[-1]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * d ** -0.5
    if clip is not None:
        s = torch.clamp(s, clip[0], clip[1])
    hh = s + e.float()
    madd = madd[:, None, None, :]
    lm = hh + madd
    if maddf is not None:
        lm = lm + maddf[:, None]
    a = torch.softmax(lm, dim=-1)
    deg = None
    if g is not None:
        gm = g.float() + madd
        if maddf is not None:
            gm = gm + maddf[:, None]
        sg = torch.sigmoid(gm)
        a = a * sg
        deg = sg.sum(-1)
    v_att = torch.einsum("bhij,bhjd->bhid", a.to(dt).float(), v.float())
    return v_att.to(dt), hh.to(dt), deg


def _egt_core_fwd_cuda(q, k, v, e, g, madd, maddf, clip):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dt = q.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"egt_attention_fwd: unsupported dtype {dt}")
    for name, t, shape in (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)),
                           ("v", v, (b, h, lk, d)),
                           ("e", e, (b, h, lq, lk))):
        _cuda.check_cuda(name, t, shape, dt)
    if g is not None:
        _cuda.check_cuda("g", g, (b, h, lq, lk), dt)
    _cuda.check_cuda("madd", madd, (b, lk), torch.float32)
    if maddf is not None:
        _cuda.check_cuda("maddf", maddf, (b, lq, lk), torch.float32)
    smem = 4 * (2 * lk + d + 32) * 4
    if smem > 227 * 1024:
        raise ValueError(f"egt_attention_fwd: lk={lk} needs {smem} bytes of "
                         "shared memory per block (max 227 KB)")
    v_att = torch.empty((b, h, lq, d), dtype=dt, device=q.device)
    h_hat = torch.empty((b, h, lq, lk), dtype=dt, device=q.device)
    deg = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if g is not None else None)
    lo, hi = clip if clip is not None else (0.0, 0.0)
    KERNEL(_cuda.DTYPE_CODES[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           e.data_ptr(), _cuda.ptr(g), madd.data_ptr(), _cuda.ptr(maddf),
           v_att.data_ptr(), h_hat.data_ptr(), _cuda.ptr(deg),
           b, h, lq, lk, d, int(clip is not None), float(lo), float(hi),
           float(d) ** -0.5)
    return v_att, h_hat, deg


def egt_core_fwd(q, k, v, e, g, madd, maddf, clip):
    """(v_att (b, h, lq, d), h_hat (b, h, lq, lk), degrees (b, h, lq) | None):
    the kernel on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return egt_core_fwd_plain(q, k, v, e, g, madd, maddf, clip)
    return _egt_core_fwd_cuda(q, k, v, e, g, madd, maddf, clip)


def egt_attention_fused(
    q, k, v,                       # q: (b, h, lq, d); k, v: (b, h, lk, d)
    e_bias,                        # (b, h, lq, lk)
    gates,                         # (b, h, lq, lk) | None
    *,
    node_mask=None,                # (b, lk) bool / 0-1
    attn_mask_hm=None,             # (b, lq, lk) 0/1 hard mask (head-shared)
    clip_logits_value=(-5.0, 5.0),
    scale_degree=False,
    scaler_type="log",
    num_virtual_nodes=0,
    random_mask_prob=0.0,
    attn_dropout=0.0,
    training=False,
) -> FusedAttentionOutput:
    """The semantics of `egt_tpu.ops.egt_pallas.egt_attention_fused` at
    inference (head-major I/O)."""
    if training and (random_mask_prob > 0.0 or attn_dropout > 0.0):
        raise NotImplementedError("random attention masking and attention "
                                  "dropout (training) are not ported yet")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    gated = gates is not None
    if scale_degree and not gated:
        raise ValueError("scale_degree requires gated attention")
    if scaler_type not in ("log", "linear"):
        raise ValueError(f"scaler_type must be log or linear, got {scaler_type}")

    if node_mask is None:
        madd = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
    else:
        madd = (node_mask.float() - 1.0) * 1e9
    maddf = None
    if attn_mask_hm is not None:
        maddf = ((attn_mask_hm.float() - 1.0) * 1e9).contiguous()

    dt = q.dtype
    clip = tuple(clip_logits_value) if clip_logits_value is not None else None
    v_att, h_hat, degrees = egt_core_fwd(
        q.contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous(),
        e_bias.to(dt).contiguous(),
        gates.to(dt).contiguous() if gated else None,
        madd.contiguous(), maddf, clip)

    if scale_degree:
        scalers = torch.log1p(degrees) if scaler_type == "log" else degrees
        if num_virtual_nodes > 0:
            scalers = scalers.clone()
            scalers[:, :, :num_virtual_nodes] = 1.0
        v_att = v_att * scalers[..., None].to(v_att.dtype)

    # (b, h, lq, d) -> (b, lq, d, h) -> (b, lq, d*h): the reference's [d, h]
    # head flattening
    v_flat = v_att.permute(0, 2, 3, 1).reshape(b, lq, d * h)
    return FusedAttentionOutput(v_att=v_flat, h_hat=h_hat, degrees=degrees)
