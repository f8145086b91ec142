"""Whole-layer EGT edge core with a hand-written CUDA forward kernel.

Port of `egt_tpu/ops/fused_layer_pallas.py::fused_layer_apply`,
`_fused_layer_fwd_call`, `make_spec` and `can_fuse_layer` (inference only):

    e_ln = LayerNorm(e)                       # pre-LN on the edge channel
    G    = e_ln @ Wg + bg                     # attention gates
    E    = act(e_ln @ Wb + bb)                # edge bias
    H    = clip(q k^T / sqrt(d)) + E          # h_hat
    A    = softmax_j(H + masks) * sigmoid(G + masks)
    v_att= A @ v
    e_mid= H @ Wr + br + e                    # dense_edge_r + residual
    e_out= act(LN(e_mid) @ W1 + b1) @ W2 + b2 + e_mid

The interface is the unpacked one: `e (b, l, l, ew)` and `qkv (b, l, 3*d*h)`
in, `(e_out, v_att (b, l, d*h))` out. The TPU kernel's 128-lane packing does
not exist here. `fused_layer_core` dispatches on the device of its inputs: a
CPU tensor takes `fused_layer_plain`, a CUDA tensor launches
`csrc/fused_layer_fwd.cu` (or raises).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda

KERNEL = _cuda.CudaKernel("fused_layer_fwd", _cuda.argtypes(
    "i pppp pppp pppp pppp pp pp iiiiii ii fff ifif"))

_EPS = 1e-3                 # Keras LayerNormalization default
_LANES = 128                # the TPU kernel's lane->head mapping needs h | 128
_ACT_CODES = {None: 0, "elu": 1, "relu": 2}


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


def make_spec(cfg, l: int) -> LayerSpec:
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
        scale=float(dh // h) ** -0.5)


def can_fuse_layer(cfg) -> bool:
    """Eligibility of the whole-layer kernel at inference: the structural
    conditions of the JAX `can_fuse_layer` (without edge partitioning or
    analysis capture, which the port does not run). `cfg.fused_layer` "auto"
    counts as on: the TPU's measured crossover rule is not a rule for this
    card."""
    if not cfg.fused_layer:
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


def _act_code(name) -> tuple[int, float]:
    if name is not None and name.startswith("lrelu"):
        return 3, float(name[-1]) / 10.0
    return _ACT_CODES[name], 0.0


def layer_weights(p_layer, dt) -> dict:
    """The kernel's weights from a layer's parameters: matrices in the
    working type, biases and LayerNorm parameters in f32 (as the JAX kernel
    takes them)."""
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


def _ln(x, gamma, beta):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return gamma * ((x - mu) * torch.rsqrt(var + _EPS)) + beta


def _mm(a, w):
    """Product of working-type operands accumulated in f32."""
    return a.float() @ w.float()


def fused_layer_plain(spec: LayerSpec, e, qkv, mask, amask, w):
    """Plain PyTorch version of the kernel, with its rounding points: f32
    math; the LN outputs, h_hat before Wr, A before A@V and the FFN hidden
    activations rounded to the working type; e_out and v_att stored in it."""
    dt = e.dtype
    b, l = mask.shape
    h, dh = spec.h, spec.dh
    ef = e.float()
    e_ln = _ln(ef, w["g1"], w["b1"]).to(dt)
    E = _act(spec.edge_act, _mm(e_ln, w["wb"]) + w["bb"])       # (b, l, l, h)
    qkv4 = qkv.reshape(b, l, 3, dh // h, h)
    q, k, v = qkv4[:, :, 0], qkv4[:, :, 1], qkv4[:, :, 2]       # (b, l, d, h)
    s = torch.einsum("bidh,bjdh->bijh", q.float(), k.float()) * spec.scale
    if spec.clip is not None:
        s = torch.clamp(s, spec.clip[0], spec.clip[1])
    hh = s + E                                                  # h_hat
    madd = ((mask - 1.0) * 1e9)[:, None, :, None]
    logits = hh + madd
    if amask is not None:
        aadd = ((amask - 1.0) * 1e9)[..., None]
        logits = logits + aadd
    ex = torch.exp(logits - logits.amax(dim=2, keepdim=True))
    a = ex / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-30)
    if spec.gated:
        g = _mm(e_ln, w["wg"]) + w["bg"] + madd
        if amask is not None:
            g = g + aadd
        a = a * torch.sigmoid(g)
    v_att = torch.einsum("bijh,bjdh->bidh", a.to(dt).float(), v.float())
    e_mid = _mm(hh.to(dt), w["wr"]) + w["br"] + ef
    x2 = _ln(e_mid, w["g2"], w["b2"]).to(dt)
    hid = _act(spec.act, _mm(x2, w["w1"]) + w["bb1"]).to(dt)
    e_out = _mm(hid, w["w2"]) + w["bb2"] + e_mid
    return e_out.to(dt), v_att.reshape(b, l, dh).to(dt)


def _fused_layer_cuda(spec: LayerSpec, e, qkv, mask, amask, w):
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
    shapes = dict(wg=(ew, h), wb=(ew, h), wr=(h, ew), w1=(ew, hid),
                  w2=(hid, ew), bg=(h,), bb=(h,), g1=(ew,), b1=(ew,),
                  br=(ew,), g2=(ew,), b2=(ew,), bb1=(hid,), bb2=(ew,))
    for name, shape in shapes.items():
        if w[name] is None and name in ("wg", "bg") and not spec.gated:
            continue
        _cuda.check_cuda(name, w[name], shape,
                         dt if name.startswith("w") else torch.float32)
    e_out = torch.empty_like(e)
    v_att = torch.empty((b, l, dh), dtype=dt, device=e.device)
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
           e_out.data_ptr(), v_att.data_ptr(),
           b, l, ew, h, dh, hid, int(spec.gated), int(spec.clip is not None),
           float(clip[0]), float(clip[1]), spec.scale,
           ea, ea_alpha, act, act_alpha)
    return e_out, v_att


def fused_layer_core(spec: LayerSpec, e, qkv, mask, amask, w):
    """(e_out, v_att): the kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if e.device.type == "cpu":
        return fused_layer_plain(spec, e, qkv, mask, amask, w)
    return _fused_layer_cuda(spec, e, qkv, mask, amask, w)


def fused_layer_apply(p_layer, cfg, e, qkv, node_mask, attn_mask):
    """Run the fused layer core. `e` is (b, l, l, ew); `qkv` is the (b, l,
    3*d*h) projection of the LN'd node stream. Returns (e_out, v_att) with
    v_att (b, l, d*h). The node-stream projections stay outside the kernel."""
    b, l, _, _ = e.shape
    spec = make_spec(cfg, l)
    dt = e.dtype
    mask = (torch.ones((b, l), dtype=torch.float32, device=e.device)
            if node_mask is None else node_mask.float().reshape(b, l))
    am = None
    if spec.constrained:
        am = attn_mask.float().reshape(b, l, l).contiguous()
    w = layer_weights(p_layer, dt)
    return fused_layer_core(spec, e.contiguous(), qkv.to(dt).contiguous(),
                            mask.contiguous(), am, w)
