"""EGT attention core with hand-written CUDA kernels, forward and backward.

Port of `egt_tpu/ops/egt_pallas.py::egt_attention_fused`, `_egt_core_fwd`
and `_egt_core_bwd_impl`. Head-major I/O as in JAX: q, k, v are (b, h, l, d);
the edge bias, the gates and h_hat are (b, h, lq, lk); `lq < lk` (a row block
of the queries against all keys) is allowed.

Each op dispatches on the device of its inputs: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel (or raises):
`csrc/egt_attention_fwd.cu` (K1) forward, `csrc/egt_attention_bwd.cu` (K2)
backward, which re-enters the softmax chain at the saved h_hat and
regenerates the training draws (`ops/rng.py`, draw 0 the random mask, draw 1
dropout). `EGTCoreFn` is the `torch.autograd.Function` around them. The
degree scaler stays in the wrapper, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda, rng
from .rng import OFF, Draws

KERNEL = _cuda.CudaKernel("egt_attention_fwd", _cuda.argtypes(
    "i ppppp pp ppp iiiii i fff uu fff"))
BWD_KERNEL = _cuda.CudaKernel("egt_attention_bwd", _cuda.argtypes(
    "i pppp pp ppp p ppppp iiiii i fff uu fff"))
_SMEM_MAX = 227 * 1024      # shared memory a block may use on an H100


class FusedAttentionOutput(NamedTuple):
    v_att: torch.Tensor                 # (b, lq, d*h), degree-scaled
    h_hat: torch.Tensor                 # (b, h, lq, lk) head-major
    degrees: torch.Tensor | None        # (b, h, lq) f32, gated only


def _masked_logits(hh, g, madd, maddf, draws: Draws):
    """logits and gates with the additive masks and the random mask."""
    madd = madd[:, None, None, :]
    lm = hh + madd
    gm = None if g is None else g.float() + madd
    if maddf is not None:
        lm = lm + maddf[:, None]
        gm = None if gm is None else gm + maddf[:, None]
    if draws.mask_p > 0.0:
        u = rng.pair_uniform(draws.seed, hh.shape, rng.RANDOM_MASK, hh.device,
                             head_major=True)
        rm = torch.where(u < draws.mask_p, -1e9, 0.0)
        lm = lm + rm
        gm = None if gm is None else gm + rm
    return lm, gm


def _kept(shape, draws: Draws, device):
    u = rng.pair_uniform(draws.seed, shape, rng.DROPOUT, device,
                         head_major=True)
    return u >= draws.drop_p


def egt_core_fwd_plain(q, k, v, e, g, madd, maddf, clip, draws: Draws = OFF):
    """Plain PyTorch version of K1, with its rounding points: f32 math,
    h_hat and A rounded to the working type, v_att stored in it. madd is
    (b, lk) and maddf (b, lq, lk) additive f32 masks."""
    dt = q.dtype
    d = q.shape[-1]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * d ** -0.5
    if clip is not None:
        s = torch.clamp(s, clip[0], clip[1])
    hh = s + e.float()
    lm, gm = _masked_logits(hh, g, madd, maddf, draws)
    a = torch.softmax(lm, dim=-1)
    deg = None
    if g is not None:
        sg = torch.sigmoid(gm)
        a = a * sg
        deg = sg.sum(-1)
    if draws.drop_p > 0.0:
        a = torch.where(_kept(a.shape, draws, a.device),
                        a / (1.0 - draws.drop_p), 0.0)
    v_att = torch.einsum("bhij,bhjd->bhid", a.to(dt).float(), v.float())
    return v_att.to(dt), hh.to(dt), deg


def _egt_core_fwd_cuda(q, k, v, e, g, madd, maddf, clip, draws: Draws = OFF):
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
    if smem > _SMEM_MAX:
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
           float(d) ** -0.5, *draws.args())
    return v_att, h_hat, deg


@_cuda.dispatch(egt_core_fwd_plain, _egt_core_fwd_cuda)
def egt_core_fwd(q, k, v, e, g, madd, maddf, clip, draws: Draws = OFF):
    """(v_att (b, h, lq, d), h_hat (b, h, lq, lk), degrees (b, h, lq) | None):
    K1 on CUDA tensors, its plain version on CPU tensors."""


def egt_core_bwd_plain(q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, clip,
                       draws: Draws = OFF):
    """Plain PyTorch version of K2 (`_bwd_kernel`): the softmax chain from
    the saved h_hat with the same draws, the gate / softmax / dropout
    backward, and the clip gate on the recomputed raw logits (inclusive, as
    the TPU kernel tests it). gdeg (b, h, lq) may be None (zeros). Returns
    dq, de, dg (working type; dg None when ungated) and dk, dv (f32)."""
    dt = q.dtype
    d = q.shape[-1]
    scale = d ** -0.5
    lm, gm = _masked_logits(h_hat.float(), g, madd, maddf, draws)
    s = torch.softmax(lm, dim=-1)
    a = s
    if g is not None:
        sg = torch.sigmoid(gm)
        a = s * sg
    dA = torch.einsum("bhid,bhjd->bhij", gv.float(), v.float())
    if draws.drop_p > 0.0:
        dmask = _kept(a.shape, draws, a.device).float() / (1.0 - draws.drop_p)
        dA = dA * dmask
        a = a * dmask
    dg = None
    dS = dA
    if g is not None:
        dS = dA * sg
        dsg = dA * s
        if gdeg is not None:
            dsg = dsg + gdeg[..., None]
        dg = (dsg * sg * (1.0 - sg)).to(dt)
    dH = s * (dS - (dS * s).sum(-1, keepdim=True)) + gh.float()
    dr = dH
    if clip is not None:
        raw = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
        dr = torch.where((raw >= clip[0]) & (raw <= clip[1]), dH, 0.0)
    dr = dr.to(dt).float()
    dq = (torch.einsum("bhij,bhjd->bhid", dr, k.float()) * scale).to(dt)
    dk = torch.einsum("bhij,bhid->bhjd", dr, q.float()) * scale
    dv = torch.einsum("bhij,bhid->bhjd", a.to(dt).float(), gv.float())
    return dq, dk, dv, dH.to(dt), dg


def bwd_smem(lk: int, d: int) -> int:
    """Shared memory K2 needs for one block (one graph and head), bytes."""
    return BWD_KERNEL.query("egt_attention_bwd_smem", "ii", lk, d)


def _egt_core_bwd_cuda(q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, clip,
                       draws: Draws = OFF):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dt = q.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"egt_attention_bwd: unsupported dtype {dt}")
    for name, t, shape in (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)),
                           ("v", v, (b, h, lk, d)), ("gv", gv, (b, h, lq, d)),
                           ("h_hat", h_hat, (b, h, lq, lk)),
                           ("gh", gh, (b, h, lq, lk))):
        _cuda.check_cuda(name, t, shape, dt)
    if g is not None:
        _cuda.check_cuda("g", g, (b, h, lq, lk), dt)
        if gdeg is not None:
            _cuda.check_cuda("gdeg", gdeg, (b, h, lq), torch.float32)
    _cuda.check_cuda("madd", madd, (b, lk), torch.float32)
    if maddf is not None:
        _cuda.check_cuda("maddf", maddf, (b, lq, lk), torch.float32)
    smem = bwd_smem(lk, d)
    if smem > _SMEM_MAX:
        raise ValueError(f"egt_attention_bwd: lk={lk}, d={d} need {smem} "
                         "bytes of shared memory per block (max 227 KB)")
    dq = torch.empty_like(q)
    dk = torch.empty((b, h, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    de = torch.empty_like(h_hat)
    dg = torch.empty_like(h_hat) if g is not None else None
    lo, hi = clip if clip is not None else (0.0, 0.0)
    BWD_KERNEL(_cuda.DTYPE_CODES[dt], q.data_ptr(), k.data_ptr(),
               v.data_ptr(), _cuda.ptr(g), madd.data_ptr(), _cuda.ptr(maddf),
               h_hat.data_ptr(), gv.data_ptr(), gh.data_ptr(),
               _cuda.ptr(gdeg if g is not None else None), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), de.data_ptr(), _cuda.ptr(dg),
               b, h, lq, lk, d, int(clip is not None), float(lo), float(hi),
               float(d) ** -0.5, *draws.args())
    return dq, dk, dv, de, dg


@_cuda.dispatch(egt_core_bwd_plain, _egt_core_bwd_cuda)
def egt_core_bwd(q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, clip,
                 draws: Draws = OFF):
    """(dq, dk, dv, de, dg): K2 on CUDA tensors, its plain version on CPU
    tensors."""


class EGTCoreFn(torch.autograd.Function):
    """The attention core with its backward (the counterpart of the JAX
    `_egt_core` custom VJP): K1 forward, K2 backward. The cotangents are
    those of v_att, h_hat (from dense_edge_r) and the degrees (zeros when
    the degree scaler is off). dk and dv come back in the working type, as
    JAX casts its f32 accumulators."""

    @staticmethod
    def forward(ctx, q, k, v, e, g, madd, maddf, clip, draws):
        ctx.set_materialize_grads(False)
        v_att, h_hat, deg = egt_core_fwd(q, k, v, e, g, madd, maddf, clip,
                                         draws)
        ctx.clip, ctx.draws = clip, draws
        ctx.save_for_backward(q, k, v, g, madd, maddf, h_hat)
        return v_att, h_hat, deg

    @staticmethod
    def backward(ctx, gv, gh, gdeg):
        q, k, v, g, madd, maddf, h_hat = ctx.saved_tensors
        gv = torch.zeros_like(q) if gv is None else gv.contiguous()
        gh = torch.zeros_like(h_hat) if gh is None else gh.contiguous()
        if gdeg is not None:
            gdeg = gdeg.float().contiguous()
        dq, dk, dv, de, dg = egt_core_bwd(q, k, v, g, madd, maddf, h_hat, gv,
                                          gh, gdeg, ctx.clip, ctx.draws)
        dt = q.dtype
        return dq, dk.to(dt), dv.to(dt), de, dg, None, None, None, None


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
    seed: int | None = None,
) -> FusedAttentionOutput:
    """The semantics of `egt_tpu.ops.egt_pallas.egt_attention_fused`
    (head-major I/O). `seed` keys the training draws (the JAX `rng`). With
    gradients enabled the core goes through `EGTCoreFn`."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    gated = gates is not None
    if scale_degree and not gated:
        raise ValueError("scale_degree requires gated attention")
    if scaler_type not in ("log", "linear"):
        raise ValueError(f"scaler_type must be log or linear, got {scaler_type}")
    draws = OFF
    if training and (random_mask_prob > 0.0 or attn_dropout > 0.0):
        if seed is None:
            raise ValueError("training stochasticity requires a seed")
        draws = Draws(seed, float(random_mask_prob), float(attn_dropout))

    if node_mask is None:
        madd = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
    else:
        madd = (node_mask.float() - 1.0) * 1e9
    maddf = None
    if attn_mask_hm is not None:
        maddf = ((attn_mask_hm.float() - 1.0) * 1e9).contiguous()

    dt = q.dtype
    clip = tuple(clip_logits_value) if clip_logits_value is not None else None
    args = (q.contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous(),
            e_bias.to(dt).contiguous(),
            gates.to(dt).contiguous() if gated else None,
            madd.contiguous(), maddf, clip, draws)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args[:5]):
        v_att, h_hat, degrees = EGTCoreFn.apply(*args)
    else:
        v_att, h_hat, degrees = egt_core_fwd(*args)

    if scale_degree:
        scalers = torch.log1p(degrees) if scaler_type == "log" else degrees
        if num_virtual_nodes > 0:
            scalers = torch.cat([torch.ones_like(scalers[:, :, :num_virtual_nodes]),
                                 scalers[:, :, num_virtual_nodes:]], dim=2)
        v_att = v_att * scalers[..., None].to(v_att.dtype)

    # (b, h, lq, d) -> (b, lq, d, h) -> (b, lq, d*h): the reference's [d, h]
    # head flattening
    v_flat = v_att.permute(0, 2, 3, 1).reshape(b, lq, d * h)
    return FusedAttentionOutput(v_att=v_flat, h_hat=h_hat, degrees=degrees)
