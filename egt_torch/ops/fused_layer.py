"""Whole-layer EGT edge core with hand-written CUDA kernels, forward and
backward.

Port of `egt_tpu/ops/fused_layer_pallas.py::fused_layer_apply`,
`_fused_layer_fwd_call`, its three backwards (`_fused_layer_bwd`:
`_bwd_tail_kernel` and `_bwd_attn_kernel` split, `_bwd_merged_kernel`,
`_bwd_kernel` "mono"), `make_spec` and `can_fuse_layer`:

    e_ln = LayerNorm(e)                       # pre-LN on the edge channel
    G    = e_ln @ Wg + bg                     # attention gates
    E    = act(e_ln @ Wb + bb)                # edge bias
    H    = clip(q k^T / sqrt(d)) + E          # h_hat
    A    = softmax_j(H + masks) * sigmoid(G + masks)   (+ random mask, train)
    v_att= dropout(A) @ v                     # dropout at training time
    e_mid= H @ Wr + br + e                    # dense_edge_r + residual
    e_out= act(LN(e_mid) @ W1 + b1) @ W2 + b2 + e_mid

The interface is the unpacked one: `e (b, l, l, ew)` and `qkv (b, l, 3*d*h)`
in, `(e_out, v_att (b, l, d*h))` out. The TPU kernel's 128-lane packing does
not exist here. Each op dispatches on the device of its inputs: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel (or
raises):

- forward: `csrc/fused_layer_fwd.cu` (K3); in training it also writes h_hat
  unless the backward is "mono";
- backward, chosen by `EGT_FUSED_BWD` (read at import into `BWD_IMPL`, as
  JAX reads it into `_BWD_IMPL`; a caller may set the attribute):
  "split" (default): `csrc/fused_layer_bwd_tail.cu` (K4: the edge tail from
  the saved h_hat) then `csrc/fused_layer_bwd_attn.cu` (K5: the softmax chain
  re-entered at h_hat, the edge head); "merged":
  `csrc/fused_layer_bwd_merged.cu` (K7), the same two bodies in one call
  with de_mid and dhh handed over in f32, as the TPU kernel does; "mono":
  `csrc/fused_layer_bwd_mono.cu` (K6), nothing saved but the inputs: a small
  kernel recomputes h_hat from q.k and the edge head (`mono_head`), then
  K7's two bodies run from it, the clip's test on the raw logit.

`FusedLayerFn` is the `torch.autograd.Function` around them. The random
mask and dropout draw from `ops/rng.py` (Philox; `csrc/philox.cuh`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from . import _cuda, rng

KERNEL = _cuda.CudaKernel("fused_layer_fwd", _cuda.argtypes(
    "i pppp pppp pppp pppp pp ppp iiiiii ii fff ifif uu fff"))
BWD_TAIL_KERNEL = _cuda.CudaKernel("fused_layer_bwd_tail", _cuda.argtypes(
    "i ppp pppp pppp pp pp i L iii if"))
BWD_ATTN_KERNEL = _cuda.CudaKernel("fused_layer_bwd_attn", _cuda.argtypes(
    "i pppp pppp pp pppp pppp ppp iiiii ii fff if uu fff"))
# K5's launches by body: "f32" (one block a graph), "cluster" (bf16, a query
# row a warp) and "tiled" (bf16, 16 keys a warp); `bwd_attn_geometry` names
# the bf16 body a shape takes
BWD_ATTN_BODIES = {"f32": 0, "cluster": 0, "tiled": 0}
BWD_MERGED_KERNEL = _cuda.CudaKernel("fused_layer_bwd_merged", _cuda.argtypes(
    "i pppp pppp pp pppp pppp ppp pp pppp pp i iiiiiiii fff ifif uu fff"))
BWD_MONO_KERNEL = _cuda.CudaKernel("fused_layer_bwd_mono", _cuda.argtypes(
    "i pppp pppp pp pppp pppp pp ppp pp pppp pp i iiiiiiii fff ifif uu fff"))
# K6's first launch alone: h_hat recomputed, with the clip's in-range flags
MONO_HEAD_KERNEL = _cuda.CudaKernel(
    "fused_layer_bwd_mono", _cuda.argtypes("i pp pppp ppp iiiii i fff if"),
    entry="fused_layer_bwd_mono_head")

BWD_IMPLS = ("split", "merged", "mono")
BWD_IMPL = os.environ.get("EGT_FUSED_BWD", "split")

_EPS = 1e-3                 # Keras LayerNormalization default
_LANES = 128                # the TPU kernel's lane->head mapping needs h | 128
_ACT_CODES = {None: 0, "elu": 1, "relu": 2}
_SMEM_MAX = 227 * 1024      # shared memory a block may use on an H100
W_KEYS = ("wg", "bg", "wb", "bb", "g1", "b1", "wr", "br", "g2", "b2",
          "w1", "bb1", "w2", "bb2")
TAIL_KEYS = ("wr", "br", "g2", "b2", "w1", "bb1", "w2", "bb2")


class LayerSpec(NamedTuple):
    """Static shape and behaviour of one fused layer call."""
    l: int                   # padded node count
    ew: int                  # edge width
    h: int                   # heads
    dh: int                  # d*h = qkv width per stream
    hidden: int              # edge FFN hidden width (ew * ffn_multiplier)
    gated: bool
    constrained: bool        # hard attention mask input present
    clip: tuple | None       # (lo, hi) logit clip
    edge_act: str | None     # activation on the edge bias projection
    act: str                 # FFN activation
    scale: float             # d^-1/2
    random_mask_prob: float = 0.0
    attn_dropout: float = 0.0
    training: bool = False

    @property
    def draws(self) -> bool:
        """Whether a call draws random bits (the random mask or dropout)."""
        return self.training and (self.random_mask_prob > 0.0
                                  or self.attn_dropout > 0.0)


def make_spec(cfg, l: int, training: bool = False) -> LayerSpec:
    h = cfg.num_heads
    dh = cfg.model_width
    clip = (tuple(cfg.clip_logits_value)
            if cfg.clip_logits_value is not None else None)
    return LayerSpec(
        l=l, ew=cfg.edge_width, h=h, dh=dh,
        hidden=round(cfg.edge_width * cfg.ffn_multiplier),
        gated=cfg.gate_attention,
        constrained=(cfg.edge_channel_type == "constrained"),
        clip=clip, edge_act=cfg.edge_activation, act=cfg.activation,
        scale=float(dh // h) ** -0.5,
        random_mask_prob=float(cfg.random_mask_prob),
        attn_dropout=float(cfg.attn_dropout), training=bool(training))


def draw_args(spec: LayerSpec, seed: int) -> tuple:
    """The kernels' draw arguments (`rng.Draws.args`); off outside
    training."""
    if not spec.training:
        return rng.Draws(seed).args()
    return rng.Draws(seed, spec.random_mask_prob, spec.attn_dropout).args()


def can_fuse_layer(cfg, training: bool = False, capture: bool = False) -> bool:
    """Eligibility of the whole-layer kernel: the structural conditions of
    the JAX `can_fuse_layer` (without edge partitioning, which the port does
    not run; analysis capture refuses it, as does `combine_layer_repr`).
    `cfg.fused_layer` "auto" counts as on: the TPU's measured crossover rule
    is not a rule for this card."""
    if not cfg.fused_layer or capture:
        return False
    if cfg.edge_channel_type not in ("residual", "constrained"):
        return False
    if cfg.combine_layer_repr:
        return False
    if cfg.add_n_norm or cfg.edge_normalization != "layer":
        return False
    if cfg.node_normalization != "layer":
        return False
    if cfg.node2edge_xtalk > 0.0 or cfg.edge2node_xtalk > 0.0:
        return False
    if training and cfg.edge_dropout > 0.0:
        return False         # the kernel has no edge dropout
    if cfg.scale_degree:
        return False
    if cfg.activation not in ("elu", "relu") and \
            not str(cfg.activation).startswith("lrelu"):
        return False
    ea = cfg.edge_activation
    if ea is not None and ea not in ("elu", "relu") and \
            not str(ea).startswith("lrelu"):
        return False
    if cfg.model_width % cfg.num_heads:
        return False
    if _LANES % cfg.num_heads:
        return False
    return True


def _act(name, x):
    if name is None:
        return x
    if name == "elu":
        return torch.nn.functional.elu(x)
    if name == "relu":
        return torch.relu(x)
    if name.startswith("lrelu"):
        return torch.nn.functional.leaky_relu(x, float(name[-1]) / 10.0)
    raise ValueError(f"fused layer: unsupported activation {name!r}")


def _act_grad(name, pre, post):
    """d act / d pre (the JAX kernels' `_act_grad`)."""
    if name is None:
        return torch.ones_like(pre)
    if name == "elu":
        return torch.where(pre > 0, 1.0, post + 1.0)
    if name == "relu":
        return (pre > 0).float()
    if name.startswith("lrelu"):
        return torch.where(pre > 0, 1.0, float(name[-1]) / 10.0)
    raise ValueError(f"fused layer: unsupported activation {name!r}")


def _act_code(name) -> tuple[int, float]:
    if name is not None and name.startswith("lrelu"):
        return 3, float(name[-1]) / 10.0
    return _ACT_CODES[name], 0.0


def layer_weights(p_layer, dt) -> dict:
    """The kernel's weights from a layer's parameters: matrices in the
    working type, biases and LayerNorm parameters in f32 (as the JAX kernel
    takes them). The casts are differentiable, so a matrix gradient reaches
    its f32 parameter rounded to the working type, as in JAX."""
    def mat(sub):
        return sub["kernel"].to(dt).contiguous()

    def vec(x):
        return x.float().contiguous()

    gated = "attention_gates" in p_layer
    ffn = p_layer["edge_ffn"]
    return dict(
        wg=mat(p_layer["attention_gates"]) if gated else None,
        bg=vec(p_layer["attention_gates"]["bias"]) if gated else None,
        wb=mat(p_layer["dense_edge_b"]), bb=vec(p_layer["dense_edge_b"]["bias"]),
        g1=vec(p_layer["norm_edge"]["gamma"]),
        b1=vec(p_layer["norm_edge"]["beta"]),
        wr=mat(p_layer["dense_edge_r"]), br=vec(p_layer["dense_edge_r"]["bias"]),
        g2=vec(ffn["norm"]["gamma"]), b2=vec(ffn["norm"]["beta"]),
        w1=mat(ffn["lr1"]), bb1=vec(ffn["lr1"]["bias"]),
        w2=mat(ffn["lr2"]), bb2=vec(ffn["lr2"]["bias"]))


def _ln_stats(x):
    """(x - mu) * rstd and rstd over the last axis."""
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    return (x - mu) * rstd, rstd


def _ln_bwd(dxn, gamma, xhat, rstd):
    """Gradient of gamma * xhat + beta with respect to its input."""
    dx = dxn * gamma
    m1 = dx.mean(-1, keepdim=True)
    m2 = (dx * xhat).mean(-1, keepdim=True)
    return (dx - m1 - xhat * m2) * rstd


def _mm(a, w):
    """Product of working-type operands accumulated in f32."""
    return a.float() @ w.float()


def _wgrad(x, y):
    """sum over all pairs of x^T y: the (in, out) gradient of a weight."""
    return x.reshape(-1, x.shape[-1]).float().T @ y.reshape(-1, y.shape[-1]).float()


def _colsum(x):
    return x.reshape(-1, x.shape[-1]).sum(0)


def _edge_head(spec: LayerSpec, e, w):
    """Edge pre-LN and the gate / bias projections: (x1, rstd1, e_ln (dt),
    G (f32 or None), P (pre-activation), E)."""
    dt = e.dtype
    x1, rstd1 = _ln_stats(e.float())
    e_ln = (w["g1"] * x1 + w["b1"]).to(dt)
    G = _mm(e_ln, w["wg"]) + w["bg"] if spec.gated else None
    P = _mm(e_ln, w["wb"]) + w["bb"]
    return x1, rstd1, e_ln, G, P, _act(spec.edge_act, P)


def _softmax_gate(spec: LayerSpec, hh, G, mask, amask, seed):
    """The softmax x gate chain from h_hat (b, l, l, h), with the training
    draws: (a_sm, sg or None, kept or None, a_drop). Shared by the forward and
    by the backward, which re-enters it at the saved h_hat."""
    madd = ((mask - 1.0) * 1e9)[:, None, :, None]
    logits = hh + madd
    g = G + madd if spec.gated else None
    if amask is not None:
        aadd = ((amask - 1.0) * 1e9)[..., None]
        logits = logits + aadd
        g = g + aadd if g is not None else None
    if spec.training and spec.random_mask_prob > 0.0:
        u = rng.pair_uniform(seed, hh.shape, rng.RANDOM_MASK, hh.device)
        radd = torch.where(u < spec.random_mask_prob, -1e9, 0.0)
        logits = logits + radd
        g = g + radd if g is not None else None
    ex = torch.exp(logits - logits.amax(dim=2, keepdim=True))
    a_sm = ex / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-30)
    sg = torch.sigmoid(g) if spec.gated else None
    a = a_sm * sg if spec.gated else a_sm
    kept = None
    if spec.training and spec.attn_dropout > 0.0:
        u = rng.pair_uniform(seed, hh.shape, rng.DROPOUT, hh.device)
        kept = u >= spec.attn_dropout
        a = torch.where(kept, a / (1.0 - spec.attn_dropout), 0.0)
    return a_sm, sg, kept, a


def _split_qkv(spec: LayerSpec, qkv):
    """(b, l, 3*dh) -> q, k, v each (b, l, d, h)."""
    b, l = qkv.shape[:2]
    qkv4 = qkv.reshape(b, l, 3, spec.dh // spec.h, spec.h)
    return qkv4[:, :, 0], qkv4[:, :, 1], qkv4[:, :, 2]


def fused_layer_plain(spec: LayerSpec, e, qkv, mask, amask, w, seed: int = 0,
                      save_hh: bool = False):
    """Plain PyTorch version of K3, with its rounding points: f32 math; the
    LN outputs, h_hat before Wr, A before A@V and the FFN hidden activations
    rounded to the working type; e_out and v_att (and h_hat, with `save_hh`)
    stored in it. Returns (e_out, v_att[, hh])."""
    dt = e.dtype
    b, l = mask.shape
    _, _, _, G, _, E = _edge_head(spec, e, w)
    q, k, v = _split_qkv(spec, qkv)
    s = torch.einsum("bidh,bjdh->bijh", q.float(), k.float()) * spec.scale
    if spec.clip is not None:
        s = torch.clamp(s, spec.clip[0], spec.clip[1])
    hh = s + E                                                  # h_hat
    a = _softmax_gate(spec, hh, G, mask, amask, seed)[3]
    v_att = torch.einsum("bijh,bjdh->bidh", a.to(dt).float(), v.float())
    t = tail_fwd(spec.act, hh, e, w)
    e_out = tail_out(t, w)
    out = (e_out.to(dt), v_att.reshape(b, l, spec.dh).to(dt))
    return out + (hh.to(dt).contiguous(),) if save_hh else out


def _check_weights(spec: LayerSpec, w, dt, keys=W_KEYS):
    ew, h, hid = spec.ew, spec.h, spec.hidden
    shapes = dict(wg=(ew, h), wb=(ew, h), wr=(h, ew), w1=(ew, hid),
                  w2=(hid, ew), bg=(h,), bb=(h,), g1=(ew,), b1=(ew,),
                  br=(ew,), g2=(ew,), b2=(ew,), bb1=(hid,), bb2=(ew,))
    for name in keys:
        if name in ("wg", "bg") and not spec.gated:
            continue
        _cuda.check_cuda(name, w[name], shapes[name],
                         dt if name.startswith("w") else torch.float32)


def _fused_layer_cuda(spec: LayerSpec, e, qkv, mask, amask, w, seed: int = 0,
                      save_hh: bool = False):
    b, l = mask.shape
    dt = e.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"fused_layer_fwd: unsupported dtype {dt}")
    ew, h, dh, hid = spec.ew, spec.h, spec.dh, spec.hidden
    _cuda.check_cuda("e", e, (b, l, l, ew), dt)
    _cuda.check_cuda("qkv", qkv, (b, l, 3 * dh), dt)
    _cuda.check_cuda("mask", mask, (b, l), torch.float32)
    if amask is not None:
        _cuda.check_cuda("amask", amask, (b, l, l), torch.float32)
    _check_weights(spec, w, dt)
    e_out = torch.empty_like(e)
    v_att = torch.empty((b, l, dh), dtype=dt, device=e.device)
    hh = (torch.empty((b, l, l, h), dtype=dt, device=e.device)
          if save_hh else None)
    clip = spec.clip if spec.clip is not None else (0.0, 0.0)
    ea, ea_alpha = _act_code(spec.edge_act)
    act, act_alpha = _act_code(spec.act)
    KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), qkv.data_ptr(),
           mask.data_ptr(), _cuda.ptr(amask),
           _cuda.ptr(w["wg"]), _cuda.ptr(w["bg"]), w["wb"].data_ptr(),
           w["bb"].data_ptr(), w["g1"].data_ptr(), w["b1"].data_ptr(),
           w["wr"].data_ptr(), w["br"].data_ptr(), w["g2"].data_ptr(),
           w["b2"].data_ptr(), w["w1"].data_ptr(), w["bb1"].data_ptr(),
           w["w2"].data_ptr(), w["bb2"].data_ptr(),
           e_out.data_ptr(), v_att.data_ptr(), _cuda.ptr(hh),
           b, l, ew, h, dh, hid, int(spec.gated), int(spec.clip is not None),
           float(clip[0]), float(clip[1]), spec.scale,
           ea, ea_alpha, act, act_alpha, *draw_args(spec, seed))
    return (e_out, v_att, hh) if save_hh else (e_out, v_att)


@_cuda.dispatch(fused_layer_plain, _fused_layer_cuda)
def fused_layer_core(spec: LayerSpec, e, qkv, mask, amask, w, seed: int = 0,
                     save_hh: bool = False):
    """(e_out, v_att[, hh]): K3 on CUDA tensors, its plain version on CPU
    tensors."""


# ------------------------------------------------------------------ backward


class TailFwd(NamedTuple):
    """The edge tail's forward intermediates (f32 unless noted)."""
    e_mid: torch.Tensor
    x2: torch.Tensor          # LN(e_mid) normalised
    rstd2: torch.Tensor
    xn2: torch.Tensor         # g2 x2 + b2, in the working type
    pre: torch.Tensor
    hid: torch.Tensor         # act(pre)


def tail_fwd(act, hh, e, w) -> TailFwd:
    """The edge tail up to the FFN hidden layer, from h_hat (rounded to the
    working type of e) and the residual e: the JAX kernels'
    `_edge_tail_fwd` / `_recompute_fwd`."""
    dt = e.dtype
    e_mid = _mm(hh.to(dt), w["wr"]) + w["br"] + e.float()
    x2, rstd2 = _ln_stats(e_mid)
    xn2 = (w["g2"] * x2 + w["b2"]).to(dt)
    pre = _mm(xn2, w["w1"]) + w["bb1"]
    return TailFwd(e_mid, x2, rstd2, xn2, pre, _act(act, pre))


def tail_out(t: TailFwd, w):
    """e_out (f32) = rnd(hid) W2 + b2 + e_mid."""
    return _mm(t.hid.to(w["w2"].dtype), w["w2"]) + w["bb2"] + t.e_mid


def tail_bwd(act, e, hh, g_eout, w):
    """The edge tail's backward by recomputation from h_hat: the math of K4
    (`_bwd_tail_kernel`) and of the edge block's `_bwd_kernel`. Returns
    de_mid and dhh in f32 (each caller rounds where its kernel does) and the
    eight f32 weight gradients {wr, br, g2, b2, w1, bb1, w2, bb2}."""
    dt = e.dtype
    t = tail_fwd(act, hh, e, w)
    g_out = g_eout.float()
    dpre = _mm(g_eout, w["w2"].T) * _act_grad(act, t.pre, t.hid)
    dpre_dt = dpre.to(dt)
    dxn2 = _mm(dpre_dt, w["w1"].T)
    de_mid = _ln_bwd(dxn2, w["g2"], t.x2, t.rstd2) + g_out
    de_mid_dt = de_mid.to(dt)
    dhh = _mm(de_mid_dt, w["wr"].T)
    dw = dict(wr=_wgrad(hh.to(dt), de_mid_dt), br=_colsum(de_mid),
              g2=_colsum(dxn2 * t.x2), b2=_colsum(dxn2),
              w1=_wgrad(t.xn2, dpre_dt), bb1=_colsum(dpre),
              w2=_wgrad(t.hid.to(dt), g_eout), bb2=_colsum(g_out))
    return de_mid, dhh, dw


def fused_layer_bwd_tail_plain(spec: LayerSpec, e, hh, g_eout, w):
    """Plain PyTorch version of K4 (`_bwd_tail_kernel`): recompute e_mid,
    LN2 and the FFN from the saved h_hat, then the FFN / LN2 / Wr backward.
    Returns (de_mid, dhh) in the working type and the eight f32 weight
    gradients {wr, br, g2, b2, w1, bb1, w2, bb2}."""
    de_mid, dhh, dw = tail_bwd(spec.act, e, hh, g_eout, w)
    return de_mid.to(e.dtype), dhh.to(e.dtype), dw


def _bwd_tail_cuda(spec: LayerSpec, e, hh, g_eout, w):
    dt = e.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"fused_layer_bwd_tail: unsupported dtype {dt}")
    b, l, _, ew = e.shape
    h, hid = spec.h, spec.hidden
    for name, t, width in (("e", e, ew), ("hh", hh, h), ("g_eout", g_eout, ew)):
        _cuda.check_cuda(name, t, (b, l, l, width), dt)
    _check_weights(spec, w, dt, TAIL_KEYS)
    de_mid = torch.empty_like(e)
    dhh = torch.empty_like(hh)
    sizes = (h * ew, ew, ew, ew, ew * hid, hid, hid * ew, ew)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=e.device)
    max_grid = 2 * torch.cuda.get_device_properties(
        e.device).multi_processor_count
    partials = torch.empty((max_grid, dw.numel()), dtype=torch.float32,
                           device=e.device)
    act, act_alpha = _act_code(spec.act)
    BWD_TAIL_KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), hh.data_ptr(),
                    g_eout.data_ptr(), w["wr"].data_ptr(), w["br"].data_ptr(),
                    w["g2"].data_ptr(), w["b2"].data_ptr(), w["w1"].data_ptr(),
                    w["bb1"].data_ptr(), w["w2"].data_ptr(),
                    w["bb2"].data_ptr(), de_mid.data_ptr(), dhh.data_ptr(),
                    dw.data_ptr(), partials.data_ptr(), max_grid, b * l * l,
                    ew, h, hid, act, act_alpha)
    parts = torch.split(dw, sizes)
    shapes = dict(wr=(h, ew), w1=(ew, hid), w2=(hid, ew))
    return de_mid, dhh, {k: x.view(shapes.get(k, (-1,)))
                         for k, x in zip(TAIL_KEYS, parts)}


@_cuda.dispatch(fused_layer_bwd_tail_plain, _bwd_tail_cuda)
def fused_layer_bwd_tail(spec: LayerSpec, e, hh, g_eout, w):
    """(de_mid, dhh, dw): K4 on CUDA tensors, its plain version on CPU
    tensors."""


def fused_layer_bwd_attn_plain(spec: LayerSpec, e, qkv, mask, amask, w, hh,
                               dhh, de_mid, g_vatt, seed: int = 0,
                               inrange=None):
    """Plain PyTorch version of K5 (`_bwd_attn_kernel`): recompute LN1, the
    gates and E; re-enter the softmax chain at the saved h_hat with the same
    draws; run the softmax / gate / dropout / clip backward and the edge-head
    backward; add de_mid. Returns (de, dq) in the working type, (dk, dv)
    (b, l, dh) f32, and the f32 weight gradients {wg, bg, wb, bb, g1, b1}
    (without wg, bg when ungated). The clip's in-range test is strict, on
    hh - E. K6 and K7 share it: `hh`, `dhh` and `de_mid` may be f32, and
    K6's mono switch hands over `inrange` (b, l, l, h), the test taken on
    the raw logit (`mono_head_plain`), in its place."""
    dt = e.dtype
    b, l = mask.shape
    x1, rstd1, e_ln, G, P, E = _edge_head(spec, e, w)
    hhf = hh.float()
    a_sm, sg, kept, a_drop = _softmax_gate(spec, hhf, G, mask, amask, seed)
    q, k, v = _split_qkv(spec, qkv)
    gv = g_vatt.reshape(q.shape)
    da = torch.einsum("bidh,bjdh->bijh", gv.float(), v.float())
    if kept is not None:
        da = torch.where(kept, da / (1.0 - spec.attn_dropout), 0.0)
    if spec.gated:
        da_sm = da * sg
        dgate = da * a_sm * sg * (1.0 - sg)
    else:
        da_sm = da
    t = (da_sm * a_sm).sum(dim=2, keepdim=True)
    dH = a_sm * (da_sm - t) + dhh.float()
    ds = dH * spec.scale
    if spec.clip is not None:
        if inrange is None:     # hh - E = clip(q.k scale): in range strictly
            s_c = hhf - E
            inrange = (s_c > spec.clip[0]) & (s_c < spec.clip[1])
        ds = torch.where(inrange.bool(), ds, 0.0)
    ds_dt = ds.to(dt).float()
    dq = torch.einsum("bijh,bjdh->bidh", ds_dt, k.float()).to(dt)
    dk = torch.einsum("bijh,bidh->bjdh", ds_dt, q.float())
    dv = torch.einsum("bijh,bidh->bjdh", a_drop.to(dt).float(), gv.float())
    dP = dH * _act_grad(spec.edge_act, P, E)
    dP_dt = dP.to(dt)
    de_ln = _mm(dP_dt, w["wb"].T)
    dw = {}
    if spec.gated:
        dgate_dt = dgate.to(dt)
        de_ln = de_ln + _mm(dgate_dt, w["wg"].T)
        dw.update(wg=_wgrad(e_ln, dgate_dt), bg=_colsum(dgate))
    dw.update(wb=_wgrad(e_ln, dP_dt), bb=_colsum(dP),
              g1=_colsum(de_ln * x1), b1=_colsum(de_ln))
    de = _ln_bwd(de_ln, w["g1"], x1, rstd1) + de_mid.float()
    flat = (b, l, spec.dh)
    return de.to(dt), dq.reshape(flat), dk.reshape(flat), dv.reshape(flat), dw


@functools.lru_cache(maxsize=None)
def _attn_smem(code: int, l: int, ew: int, h: int, dh: int, gated: int) -> int:
    return BWD_ATTN_KERNEL.query("fused_layer_bwd_attn_smem", "iiiiii", code,
                                 l, ew, h, dh, gated)


def bwd_attn_smem(spec: LayerSpec, dtype) -> int:
    """Shared memory K5 needs for one block, in bytes (f32: one block a
    graph, with k, v, dk and dv in device memory where they do not fit in
    shared memory; bf16: the body `bwd_attn_geometry` names, the cluster
    body at the most warps a block that fit)."""
    return _attn_smem(_cuda.DTYPE_CODES[dtype], spec.l, spec.ew, spec.h,
                      spec.dh, int(spec.gated))


@functools.lru_cache(maxsize=None)
def _attn_geometry(l: int, ew: int, h: int, dh: int, gated: int,
                   f32_handoff: int) -> tuple | None:
    out = (ctypes.c_int * 9)()
    if BWD_ATTN_KERNEL.query("fused_layer_bwd_attn_geometry", "iiiiiip",
                             l, ew, h, dh, gated, f32_handoff,
                             ctypes.addressof(out)):
        return None
    return tuple(out)


def bwd_attn_geometry(spec: LayerSpec,
                      f32_handoff: bool = False) -> dict | None:
    """How K5's bf16 body spreads one graph over the card, from the kernel's
    own layout, with de_mid and dhh handed over in bf16 (K5) or in f32
    (`f32_handoff`, K7, and K6 under its mono switch): `body` ("tiled": a
    warp takes 16 keys of every row of its block, K5 only; "cluster": a
    warp takes whole query rows), `warps` a block, `cluster` blocks a graph,
    `rows_per_block`, `passes` (rows a warp), `keys_per_warp` (of a row),
    `general` (the cluster body for shapes past the register body's tiles),
    `smem` bytes a block and `kv_global` (the cluster body with k, v, dk
    and dv in device memory, one block a graph, where no layout with them in
    shared memory fits); None when no layout fits 227 KB."""
    g = _attn_geometry(spec.l, spec.ew, spec.h, spec.dh, int(spec.gated),
                       int(f32_handoff))
    if g is None:
        return None
    keys = ("warps", "cluster", "rows_per_block", "passes", "general", "smem",
            "kv_global")
    return dict(zip(keys, g), body="tiled" if g[7] else "cluster",
                keys_per_warp=g[8])


@functools.lru_cache(maxsize=None)
def _tail_geometry(code: int, ew: int, h: int, hid: int,
                   f32_handoff: int) -> tuple | None:
    out = (ctypes.c_int * 4)()
    if BWD_TAIL_KERNEL.query("fused_layer_bwd_tail_geometry", "iiiiip", code,
                             ew, h, hid, f32_handoff, ctypes.addressof(out)):
        return None
    return tuple(out)


def bwd_tail_geometry(spec: LayerSpec, dtype,
                      f32_handoff: bool = False) -> dict | None:
    """Which of K4's bodies takes a shape, from the kernel's own layouts:
    `tensor_cores` (the bf16 body), `tile` (warps a block there, pairs a
    tile in the CUDA-core body), `copies` (the CUDA-core body's transposed
    weights) and `smem` bytes a block; with `f32_handoff` (K7) a bf16 shape
    the tensor-core body cannot take runs the CUDA-core body in bf16. None
    when no body fits 227 KB."""
    g = _tail_geometry(_cuda.DTYPE_CODES[dtype], spec.ew, spec.h, spec.hidden,
                       int(f32_handoff))
    keys = ("tensor_cores", "tile", "copies", "smem")
    return None if g is None else dict(zip(keys, g))


def _bwd_attn_cuda(spec: LayerSpec, e, qkv, mask, amask, w, hh, dhh, de_mid,
                   g_vatt, seed: int = 0, inrange=None):
    dt = e.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"fused_layer_bwd_attn: unsupported dtype {dt}")
    if inrange is not None and dt != torch.float32:
        raise ValueError("fused_layer_bwd_attn: the mono switch (inrange) "
                         "is taken in f32 only; bf16 runs it inside "
                         "fused_layer_bwd_mono")
    b, l = mask.shape
    ew, h, dh = spec.ew, spec.h, spec.dh
    for name, t, shape in (("e", e, (b, l, l, ew)), ("qkv", qkv, (b, l, 3 * dh)),
                           ("hh", hh, (b, l, l, h)), ("dhh", dhh, (b, l, l, h)),
                           ("de_mid", de_mid, (b, l, l, ew)),
                           ("g_vatt", g_vatt, (b, l, dh))):
        _cuda.check_cuda(name, t, shape, dt)
    _cuda.check_cuda("mask", mask, (b, l), torch.float32)
    if amask is not None:
        _cuda.check_cuda("amask", amask, (b, l, l), torch.float32)
    if inrange is not None:
        _cuda.check_cuda("inrange", inrange, (b, l, l, h), torch.bool)
    _check_weights(spec, w, dt, ("wg", "bg", "wb", "bb", "g1", "b1"))
    smem = bwd_attn_smem(spec, dt)
    if smem > _SMEM_MAX:
        raise ValueError(f"fused_layer_bwd_attn: l={l}, ew={ew}, h={h}, "
                         f"dh={dh} need {smem} bytes of shared memory per "
                         "block (max 227 KB)")
    nproj = 2 * h if spec.gated else h
    de = torch.empty_like(e)
    dq = torch.empty((b, l, dh), dtype=dt, device=e.device)
    dk = torch.empty((b, l, dh), dtype=torch.float32, device=e.device)
    dv = torch.empty_like(dk)
    sizes = (ew * nproj, nproj, ew, ew)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=e.device)
    partials = torch.empty((b, dw.numel()), dtype=torch.float32,
                           device=e.device)
    clip = spec.clip if spec.clip is not None else (0.0, 0.0)
    ea, ea_alpha = _act_code(spec.edge_act)
    BWD_ATTN_KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), qkv.data_ptr(),
                    mask.data_ptr(), _cuda.ptr(amask), _cuda.ptr(w["wg"]),
                    _cuda.ptr(w["bg"]), w["wb"].data_ptr(), w["bb"].data_ptr(),
                    w["g1"].data_ptr(), w["b1"].data_ptr(), hh.data_ptr(),
                    dhh.data_ptr(), de_mid.data_ptr(), g_vatt.data_ptr(),
                    de.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    dw.data_ptr(), partials.data_ptr(), _cuda.ptr(inrange),
                    b, l, ew, h, dh, int(spec.gated),
                    int(spec.clip is not None),
                    float(clip[0]), float(clip[1]), spec.scale, ea, ea_alpha,
                    *draw_args(spec, seed))
    BWD_ATTN_BODIES["f32" if dt == torch.float32
                    else bwd_attn_geometry(spec)["body"]] += 1
    dwgb, dbgb, dg1, db1 = torch.split(dw, sizes)
    dwgb = dwgb.view(ew, nproj)
    grads = dict(wb=dwgb[:, nproj - h:], bb=dbgb[nproj - h:], g1=dg1, b1=db1)
    if spec.gated:
        grads.update(wg=dwgb[:, :h], bg=dbgb[:h])
    return de, dq, dk, dv, grads


@_cuda.dispatch(fused_layer_bwd_attn_plain, _bwd_attn_cuda)
def fused_layer_bwd_attn(spec: LayerSpec, e, qkv, mask, amask, w, hh, dhh,
                         de_mid, g_vatt, seed: int = 0, inrange=None):
    """(de, dq, dk, dv, dw): K5 on CUDA tensors, its plain version on CPU
    tensors; with `inrange`, K5's body under K6's mono switch."""


def fused_layer_bwd_merged_plain(spec: LayerSpec, e, qkv, mask, amask, w,
                                 hh, g_eout, g_vatt, seed: int = 0):
    """Plain PyTorch version of K7 (`_bwd_merged_kernel`): K4's and K5's
    math from the saved h_hat, with de_mid and dhh passed on in f32.
    Returns (de, dq, dk, dv, dw) as `fused_layer_bwd_attn_plain`, dw with
    all 14 weight gradients."""
    de_mid, dhh, dw = tail_bwd(spec.act, e, hh, g_eout, w)
    *out, dw_head = fused_layer_bwd_attn_plain(
        spec, e, qkv, mask, amask, w, hh, dhh, de_mid, g_vatt, seed)
    return (*out, {**dw, **dw_head})


def mono_head_plain(spec: LayerSpec, e, qkv, w):
    """Plain PyTorch version of K6's head kernel: h_hat recomputed in f32 as
    the forward computes it (the edge head, q.k scale, the clip, + E).
    Returns (hh (b, l, l, h) f32, rnd(hh) in the working type, the clip's
    in-range flags lo < q.k scale < hi on the raw logit, strict, as bool;
    None without a clip)."""
    E = _edge_head(spec, e, w)[5]
    q, k, _ = _split_qkv(spec, qkv)
    s = torch.einsum("bidh,bjdh->bijh", q.float(), k.float()) * spec.scale
    inrange = None
    if spec.clip is not None:
        inrange = (s > spec.clip[0]) & (s < spec.clip[1])
        s = torch.clamp(s, spec.clip[0], spec.clip[1])
    hh = s + E
    return hh, hh.to(e.dtype), inrange


def _mono_head_outputs(spec: LayerSpec, e, b: int, l: int):
    """hh (f32), rnd(hh) (bf16 only, else None) and the in-range flags
    (with a clip, else None) of K6's head kernel."""
    shape = (b, l, l, spec.h)
    hh = torch.empty(shape, dtype=torch.float32, device=e.device)
    hhw = (torch.empty(shape, dtype=e.dtype, device=e.device)
           if e.dtype != torch.float32 else None)
    inrange = (torch.empty(shape, dtype=torch.bool, device=e.device)
               if spec.clip is not None else None)
    return hh, hhw, inrange


def _mono_head_cuda(spec: LayerSpec, e, qkv, w):
    dt = e.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"fused_layer_bwd_mono_head: unsupported dtype {dt}")
    b, l, _, ew = e.shape
    _cuda.check_cuda("e", e, (b, l, l, ew), dt)
    _cuda.check_cuda("qkv", qkv, (b, l, 3 * spec.dh), dt)
    _check_weights(spec, w, dt, ("wb", "bb", "g1", "b1"))
    hh, hhw, inrange = _mono_head_outputs(spec, e, b, l)
    has_clip, lo, hi, scale, ea, ea_alpha, _, _ = _layer_args(spec, w)
    MONO_HEAD_KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), qkv.data_ptr(),
                     w["wb"].data_ptr(), w["bb"].data_ptr(),
                     w["g1"].data_ptr(), w["b1"].data_ptr(), hh.data_ptr(),
                     _cuda.ptr(hhw), _cuda.ptr(inrange), b, l, ew, spec.h,
                     spec.dh, has_clip, lo, hi, scale, ea, ea_alpha)
    return hh, hh if hhw is None else hhw, inrange


@_cuda.dispatch(mono_head_plain, _mono_head_cuda)
def mono_head(spec: LayerSpec, e, qkv, w):
    """(hh f32, rnd(hh), in-range flags): K6's head kernel on CUDA tensors,
    its plain version on CPU tensors."""


def fused_layer_bwd_mono_plain(spec: LayerSpec, e, qkv, mask, amask, w,
                               g_eout, g_vatt, seed: int = 0):
    """Plain PyTorch version of K6 (`_bwd_kernel`, "mono"): no saved h_hat.
    K6's head (`mono_head_plain`: h_hat recomputed in f32 as the forward
    does, the clip's in-range flags on the raw logit), then K7's math: the
    tail backward from rnd(h_hat) and the attention backward with the
    softmax chain at the f32 h_hat and the clip's test from the flags,
    de_mid and dhh in f32. Returns what `fused_layer_bwd_merged_plain`
    does."""
    hh, _, inrange = mono_head_plain(spec, e, qkv, w)
    de_mid, dhh, dw = tail_bwd(spec.act, e, hh, g_eout, w)
    *out, dw_head = fused_layer_bwd_attn_plain(
        spec, e, qkv, mask, amask, w, hh, dhh, de_mid, g_vatt, seed,
        inrange=inrange)
    return (*out, {**dw, **dw_head})


def _check_bwd_inputs(name, spec: LayerSpec, e, qkv, mask, amask, w, g_eout,
                      g_vatt, hh=None):
    dt = e.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {dt}")
    b, l = mask.shape
    ew, h, dh = spec.ew, spec.h, spec.dh
    for arg, t, shape in (("e", e, (b, l, l, ew)),
                          ("qkv", qkv, (b, l, 3 * dh)),
                          ("g_eout", g_eout, (b, l, l, ew)),
                          ("g_vatt", g_vatt, (b, l, dh))):
        _cuda.check_cuda(arg, t, shape, dt)
    if hh is not None:
        _cuda.check_cuda("hh", hh, (b, l, l, h), dt)
    _cuda.check_cuda("mask", mask, (b, l), torch.float32)
    if amask is not None:
        _cuda.check_cuda("amask", amask, (b, l, l), torch.float32)
    _check_weights(spec, w, dt)


def _bwd_outputs(spec: LayerSpec, e, b: int, l: int):
    """de, dq, dk, dv and the 14 f32 weight-gradient sums (tail, then head)
    of K6 and K7."""
    dt, dh = e.dtype, spec.dh
    de = torch.empty_like(e)
    dq = torch.empty((b, l, dh), dtype=dt, device=e.device)
    dk = torch.empty((b, l, dh), dtype=torch.float32, device=e.device)
    dv = torch.empty_like(dk)
    dw = torch.empty(_tail_len(spec) + _head_len(spec), dtype=torch.float32,
                     device=e.device)
    return de, dq, dk, dv, dw


def _tail_len(spec: LayerSpec) -> int:
    ew, h, hid = spec.ew, spec.h, spec.hidden
    return h * ew + 4 * ew + 2 * ew * hid + hid


def _head_len(spec: LayerSpec) -> int:
    nproj = 2 * spec.h if spec.gated else spec.h
    return spec.ew * nproj + nproj + 2 * spec.ew


def _split_dw(spec: LayerSpec, dw):
    """The 14 weight gradients from [tail sums | head sums]."""
    ew, h, hid = spec.ew, spec.h, spec.hidden
    nproj = 2 * h if spec.gated else h
    tail_sizes = (h * ew, ew, ew, ew, ew * hid, hid, hid * ew, ew)
    head_sizes = (ew * nproj, nproj, ew, ew)
    tail, head = torch.split(dw, (sum(tail_sizes), sum(head_sizes)))
    shapes = dict(wr=(h, ew), w1=(ew, hid), w2=(hid, ew))
    grads = {k: x.view(shapes.get(k, (-1,)))
             for k, x in zip(TAIL_KEYS, torch.split(tail, tail_sizes))}
    dwgb, dbgb, dg1, db1 = torch.split(head, head_sizes)
    dwgb = dwgb.view(ew, nproj)
    grads.update(wb=dwgb[:, nproj - h:], bb=dbgb[nproj - h:], g1=dg1, b1=db1)
    if spec.gated:
        grads.update(wg=dwgb[:, :h], bg=dbgb[:h])
    return grads


def _layer_args(spec: LayerSpec, w):
    """The C entry points' draw-free layer arguments after the shape ones:
    (has_clip, lo, hi, scale, edge_act, edge_alpha, act, act_alpha)."""
    clip = spec.clip if spec.clip is not None else (0.0, 0.0)
    ea, ea_alpha = _act_code(spec.edge_act)
    act, act_alpha = _act_code(spec.act)
    return (int(spec.clip is not None), float(clip[0]), float(clip[1]),
            spec.scale, ea, ea_alpha, act, act_alpha)


def _weight_ptrs(w):
    return (_cuda.ptr(w["wg"]), _cuda.ptr(w["bg"]),
            *(w[k].data_ptr() for k in ("wb", "bb", "g1", "b1", "wr", "br",
                                        "g2", "b2", "w1", "bb1", "w2",
                                        "bb2")))


def _check_bodies(name: str, spec: LayerSpec, dtype) -> None:
    """Raise a ValueError naming the limit when K4's or K5's bodies cannot
    take a shape with de_mid and dhh handed over in f32 (K7, K6)."""
    if bwd_tail_geometry(spec, dtype, f32_handoff=True) is None:
        raise ValueError(
            f"{name}: ew={spec.ew}, h={spec.h}, hidden={spec.hidden}: no "
            "body of the tail backward (K4) fits 227 KB of shared memory "
            "per block")
    if dtype == torch.bfloat16:
        fits = bwd_attn_geometry(spec, f32_handoff=True) is not None
    else:                  # the f32 body reads the working type: the split's
        fits = bwd_attn_smem(spec, dtype) <= _SMEM_MAX
    if not fits:
        raise ValueError(
            f"{name}: l={spec.l}, ew={spec.ew}, h={spec.h}, dh={spec.dh}: "
            "the attention backward (K5) needs more than 227 KB of shared "
            "memory per block")


def bwd_merged_check(spec: LayerSpec, dtype) -> None:
    """Raise a ValueError naming the limit when K4's or K5's bodies cannot
    take a shape with de_mid and dhh handed over in f32 (K7)."""
    _check_bodies("fused_layer_bwd_merged", spec, dtype)


def bwd_mono_check(spec: LayerSpec, dtype) -> None:
    """Raise a ValueError naming the limit when K6's bodies cannot take a
    shape: K4's and K5's as K7 runs them (K5's mono switch keeps K7's
    layout). The head kernel takes every shape they take: its shared memory
    is (32 + h) rows of ew + 4 floats, 166 KB at ew 256, h 128."""
    _check_bodies("fused_layer_bwd_mono", spec, dtype)


def _handoff(spec: LayerSpec, e, b: int, l: int):
    """K7's and K6's f32 hand-off (de_mid, dhh), the row count of K4's
    partial sums and the partial rows of both bodies' sums: K4's sum pass
    reads its rows before K5's body, later on the same stream, writes its
    own."""
    de_mid = torch.empty((b, l, l, spec.ew), dtype=torch.float32,
                         device=e.device)
    dhh = torch.empty((b, l, l, spec.h), dtype=torch.float32, device=e.device)
    max_grid = 2 * torch.cuda.get_device_properties(
        e.device).multi_processor_count
    partials = torch.empty(max(max_grid * _tail_len(spec),
                               b * _head_len(spec)),
                           dtype=torch.float32, device=e.device)
    return de_mid, dhh, max_grid, partials


def _bwd_merged_cuda(spec: LayerSpec, e, qkv, mask, amask, w, hh, g_eout,
                     g_vatt, seed: int = 0):
    _check_bwd_inputs("fused_layer_bwd_merged", spec, e, qkv, mask, amask, w,
                      g_eout, g_vatt, hh)
    dt = e.dtype
    bwd_merged_check(spec, dt)
    b, l = mask.shape
    ew, h = spec.ew, spec.h
    de, dq, dk, dv, dw = _bwd_outputs(spec, e, b, l)
    # the hand-off: de_mid and dhh in f32, written by K4's body, read by K5's
    de_mid, dhh, max_grid, partials = _handoff(spec, e, b, l)
    BWD_MERGED_KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), qkv.data_ptr(),
                      mask.data_ptr(), _cuda.ptr(amask), *_weight_ptrs(w),
                      hh.data_ptr(), g_eout.data_ptr(), g_vatt.data_ptr(),
                      de_mid.data_ptr(), dhh.data_ptr(), de.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dw.data_ptr(), partials.data_ptr(), max_grid, b, l, ew,
                      h, spec.dh, spec.hidden, int(spec.gated),
                      *_layer_args(spec, w), *draw_args(spec, seed))
    return de, dq, dk, dv, _split_dw(spec, dw)


def _bwd_mono_cuda(spec: LayerSpec, e, qkv, mask, amask, w, g_eout, g_vatt,
                   seed: int = 0):
    _check_bwd_inputs("fused_layer_bwd_mono", spec, e, qkv, mask, amask, w,
                      g_eout, g_vatt)
    dt = e.dtype
    bwd_mono_check(spec, dt)
    b, l = mask.shape
    de, dq, dk, dv, dw = _bwd_outputs(spec, e, b, l)
    # the head kernel's h_hat and flags, then K7's f32 hand-off
    hh, hhw, inrange = _mono_head_outputs(spec, e, b, l)
    de_mid, dhh, max_grid, partials = _handoff(spec, e, b, l)
    BWD_MONO_KERNEL(_cuda.DTYPE_CODES[dt], e.data_ptr(), qkv.data_ptr(),
                    mask.data_ptr(), _cuda.ptr(amask), *_weight_ptrs(w),
                    g_eout.data_ptr(), g_vatt.data_ptr(), hh.data_ptr(),
                    _cuda.ptr(hhw), _cuda.ptr(inrange), de_mid.data_ptr(),
                    dhh.data_ptr(), de.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                    partials.data_ptr(), max_grid, b, l, spec.ew, spec.h,
                    spec.dh, spec.hidden, int(spec.gated),
                    *_layer_args(spec, w), *draw_args(spec, seed))
    return de, dq, dk, dv, _split_dw(spec, dw)


@_cuda.dispatch(fused_layer_bwd_merged_plain, _bwd_merged_cuda)
def fused_layer_bwd_merged(spec: LayerSpec, e, qkv, mask, amask, w, hh,
                           g_eout, g_vatt, seed: int = 0):
    """(de, dq, dk, dv, dw): K7 on CUDA tensors, its plain version on CPU
    tensors."""


@_cuda.dispatch(fused_layer_bwd_mono_plain, _bwd_mono_cuda)
def fused_layer_bwd_mono(spec: LayerSpec, e, qkv, mask, amask, w, g_eout,
                         g_vatt, seed: int = 0):
    """(de, dq, dk, dv, dw): K6 on CUDA tensors, its plain version on CPU
    tensors."""


class FusedLayerFn(torch.autograd.Function):
    """The whole-layer core with its backward (the counterpart of the JAX
    `_fused_layer` custom VJP), chosen by `BWD_IMPL` when the forward runs:
    "split" and "merged" run K3 with h_hat saved, then K4 and K5, or K7;
    "mono" runs K3 without h_hat and saves only the inputs, then K6.
    Gradients come back in their input's dtype: `qkv` and the weight
    matrices in the working type, the vectors in f32."""

    @staticmethod
    def forward(ctx, spec, seed, e, qkv, mask, amask, *wts):
        impl = BWD_IMPL
        if impl not in BWD_IMPLS:
            raise ValueError(f"EGT_FUSED_BWD must be one of {BWD_IMPLS}, "
                             f"got {impl!r}")
        w = dict(zip(W_KEYS, wts))
        out = fused_layer_core(spec, e, qkv, mask, amask, w, seed,
                               save_hh=impl != "mono")
        ctx.spec, ctx.seed, ctx.impl = spec, seed, impl
        hh = out[2] if impl != "mono" else None
        ctx.save_for_backward(e, qkv, mask, amask, hh, *wts)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, g_eout, g_vatt):
        e, qkv, mask, amask, hh, *wts = ctx.saved_tensors
        spec, seed = ctx.spec, ctx.seed
        w = dict(zip(W_KEYS, wts))
        g_eout, g_vatt = g_eout.contiguous(), g_vatt.contiguous()
        if ctx.impl == "split":
            de_mid, dhh, dw = fused_layer_bwd_tail(spec, e, hh, g_eout, w)
            de, dq, dk, dv, dw_head = fused_layer_bwd_attn(
                spec, e, qkv, mask, amask, w, hh, dhh, de_mid, g_vatt, seed)
            dw.update(dw_head)
        elif ctx.impl == "merged":
            de, dq, dk, dv, dw = fused_layer_bwd_merged(
                spec, e, qkv, mask, amask, w, hh, g_eout, g_vatt, seed)
        else:
            de, dq, dk, dv, dw = fused_layer_bwd_mono(
                spec, e, qkv, mask, amask, w, g_eout, g_vatt, seed)
        dt = qkv.dtype
        dqkv = torch.stack([dq, dk.to(dt), dv.to(dt)], dim=2).reshape(qkv.shape)
        dws = [None if w[k] is None else dw[k].to(w[k].dtype) for k in W_KEYS]
        return (None, None, de, dqkv, None, None, *dws)


def fused_layer_apply(p_layer, cfg, e, qkv, node_mask, attn_mask,
                      training: bool = False, seed: int | None = None):
    """Run the fused layer core. `e` is (b, l, l, ew); `qkv` is the (b, l,
    3*d*h) projection of the LN'd node stream. Returns (e_out, v_att) with
    v_att (b, l, d*h). The node-stream projections stay outside the kernel.
    With gradients enabled the call goes through `FusedLayerFn` (its
    backward chosen by `BWD_IMPL`); without, through the custom op
    `torch.ops.egt.fused_layer_fwd` (`custom_ops.py`), which `torch.export`
    keeps in an exported graph. `seed` keys the random mask and dropout
    (training)."""
    b, l, _, _ = e.shape
    spec = make_spec(cfg, l, training)
    if spec.draws and seed is None:
        raise ValueError("random attention masking / attention dropout "
                         "need a seed at training time")
    seed = 0 if seed is None else seed
    dt = e.dtype
    mask = (torch.ones((b, l), dtype=torch.float32, device=e.device)
            if node_mask is None else node_mask.float().reshape(b, l))
    am = None
    if spec.constrained:
        am = attn_mask.float().reshape(b, l, l).contiguous()
    w = layer_weights(p_layer, dt)
    args = (e.contiguous(), qkv.to(dt).contiguous(), mask.contiguous(), am)
    wts = [w[k] for k in W_KEYS]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*args[:2], *wts)):
        return FusedLayerFn.apply(spec, seed, *args, *wts)
    from . import custom_ops
    return custom_ops.layer_forward(spec, *args, w, seed)
