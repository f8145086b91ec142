"""The dual-stream (node + edge channel) EGT layer.

Port of `egt_tpu/models/layers.py` for the residual / constrained edge
channels with LayerNorm and no cross-talk: `layer_norm` (eps 1e-3, f32
island), `activation`, `dropout`, `_attention`, `_mha_block`, `edge_update`,
`ffn_block` and `layer_forward` with its whole-layer branch. A layer is an
`nn.ModuleDict` whose keys are the JAX parameter names, so the functions below
read it as they read the JAX params tree.

Dispatch per layer: the whole-layer kernel when `can_fuse_layer` holds; else
the attention kernel when `cfg.fused_attention` is on; else the plain
`egt_attention_core`. Each kernel wrapper takes its plain version on CPU
tensors.

Training: one seed per layer and step (`seed`). It keys the attention
draws (the random mask and attention dropout, `ops/rng.py`) directly, and
node / edge dropout through `fold_seed(seed, tag)` with the JAX fold tags
(2 after attention, 3 after dense_edge_r, 4 edge FFN, 5 node FFN).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.egt_attention import egt_attention_fused
from ..ops.fused_layer import can_fuse_layer, fused_layer_apply
from ..ops.rng import fold_seed
from .egt import egt_attention_core, split_qkv
from .features import dense, dense_params


# -------------------------------------------------------------------- normalization


def layer_norm(p, x, eps: float = 1e-3):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["gamma"] + p["beta"]).to(x.dtype)


def norm_params(dim: int, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "gamma": nn.Parameter(torch.ones(dim, device=device)),
        "beta": nn.Parameter(torch.zeros(dim, device=device))})


# --------------------------------------------------------------------- activations


def activation(name, x):
    if name is None:
        return x
    if name.lower().startswith("lrelu"):
        return torch.nn.functional.leaky_relu(x, float(name[-1]) / 10.0)
    if name == "elu":
        return torch.nn.functional.elu(x)
    if name == "relu":
        return torch.relu(x)
    raise NotImplementedError(f"activation {name!r} is not ported yet")


def dropout(x, rate: float, training: bool, seed: int | None):
    """Inverted dropout; the keep mask comes from a `torch.Generator` on
    x's device seeded with `seed`."""
    if not training or rate <= 0.0:
        return x
    if seed is None:
        raise ValueError("dropout requires a seed at training time")
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def _sub_seed(seed, tag):
    return None if seed is None else fold_seed(seed, tag)


# ------------------------------------------------------------------ attention block


def _attention(p, cfg, h_n, e_bias_raw, gates_raw, node_mask, edge_mask,
               training=False, seed=None):
    """QKV projection + EGT attention. `e_bias_raw`/`gates_raw` are the
    (b, l, l, h) projections; `edge_mask` is (b, l, l) head-shared or None.
    Returns (v_att (b, l, d*h), h_hat (b, l, l, h))."""
    kw = dict(
        clip_logits_value=(tuple(cfg.clip_logits_value)
                           if cfg.clip_logits_value is not None else None),
        scale_degree=cfg.scale_degree,
        scaler_type=cfg.scaler_type,
        num_virtual_nodes=cfg.num_virtual_nodes,
        random_mask_prob=cfg.random_mask_prob,
        attn_dropout=cfg.attn_dropout,
        training=training,
        seed=seed,
    )
    qkv = dense(p["dense_qkv"], h_n)
    if cfg.fused_attention:
        b, l, f = qkv.shape
        d = f // (3 * cfg.num_heads)
        qkv_hm = qkv.reshape(b, l, 3, d, cfg.num_heads)
        q, k, v = (qkv_hm[:, :, i].permute(0, 3, 1, 2) for i in range(3))
        e_hm = e_bias_raw.permute(0, 3, 1, 2)
        g_hm = None if gates_raw is None else gates_raw.permute(0, 3, 1, 2)
        out = egt_attention_fused(q, k, v, e_hm, g_hm, node_mask=node_mask,
                                  attn_mask_hm=edge_mask, **kw)
        return out.v_att, out.h_hat.permute(0, 2, 3, 1)

    q, k, v = split_qkv(qkv, cfg.num_heads)
    am = None if edge_mask is None else edge_mask[..., None]
    out = egt_attention_core(q, k, v, e_bias_raw, gates_raw,
                             node_mask=node_mask, attn_mask=am,
                             chain_f32=bool(cfg.attn_chain_f32), **kw)
    return out.v_att, out.h_hat


def _mha_block(p, cfg, h, e_bias, gates, node_mask, edge_mask,
               training=False, seed=None):
    """Pre/post-norm MHA with residual. Returns (h, h_hat)."""
    y = h
    if not cfg.add_n_norm:
        h = layer_norm(p["norm_mha"], h)
    v_att, h_hat = _attention(p, cfg, h, e_bias, gates, node_mask, edge_mask,
                              training, seed)
    h = dropout(dense(p["dense_mha"], v_att), cfg.node_dropout, training,
                _sub_seed(seed, 2)) + y
    if cfg.add_n_norm:
        h = layer_norm(p["norm_mha"], h)
    return h, h_hat


def _edge_bias(p, cfg, e):
    return activation(cfg.edge_activation, dense(p["dense_edge_b"], e))


def edge_update(p, cfg, h, e, node_mask, edge_mask, training=False,
                seed=None):
    """The attention sub-layer of the residual / constrained edge channels.
    Returns (h, e)."""
    if cfg.edge_channel_type not in ("residual", "constrained"):
        raise NotImplementedError(f"edge_channel_type "
                                  f"{cfg.edge_channel_type!r} is not ported yet")
    y_e = e
    if not cfg.add_n_norm:
        e = layer_norm(p["norm_edge"], e)
    gates = dense(p["attention_gates"], e) if cfg.gate_attention else None
    eb = _edge_bias(p, cfg, e)
    h, h_hat = _mha_block(p, cfg, h, eb, gates, node_mask, edge_mask,
                          training, seed)
    e = dropout(dense(p["dense_edge_r"], h_hat), cfg.edge_dropout, training,
                _sub_seed(seed, 3)) + y_e
    if cfg.add_n_norm:
        e = layer_norm(p["norm_edge"], e)
    return h, e


# ------------------------------------------------------------------------ FFN block


def _ffn(p, cfg, x, rate=0.0, training=False, seed=None):
    """Norm (pre-LN) -> lr1 -> act -> lr2 (-> dropout) + residual
    (post-norm after)."""
    y = x
    if not cfg.add_n_norm:
        x = layer_norm(p["norm"], x)
    x = activation(cfg.activation, dense(p["lr1"], x))
    x = dropout(dense(p["lr2"], x), rate, training, seed) + y
    if cfg.add_n_norm:
        x = layer_norm(p["norm"], x)
    return x


def ffn_block(p, cfg, h, e, skip_edge: bool = False, training=False,
              seed=None):
    """Dual FFN without cross-talk. Returns (h, e); `skip_edge` when the
    whole-layer kernel already applied the edge-side FFN."""
    if cfg.node2edge_xtalk > 0.0 or cfg.edge2node_xtalk > 0.0:
        raise NotImplementedError("FFN cross-talk is not ported yet")
    if cfg.edge_channel_type in ("residual", "constrained") and not skip_edge:
        e = _ffn(p["edge_ffn"], cfg, e, cfg.edge_dropout, training,
                 _sub_seed(seed, 4))
    h = _ffn(p["node_ffn"], cfg, h, cfg.node_dropout, training,
             _sub_seed(seed, 5))
    return h, e


# ------------------------------------------------------------------- one full layer


class EGTLayer(nn.ModuleDict):
    """One layer's parameters under the JAX names, and its forward."""

    def __init__(self, cfg, generator, device=None):
        w, ew, h = cfg.model_width, cfg.edge_width, cfg.num_heads
        hn = round(w * cfg.ffn_multiplier)
        he = round(ew * cfg.ffn_multiplier)
        mods = {
            "norm_mha": norm_params(w, device),
            "dense_qkv": dense_params(w, 3 * w, generator, device),
            "dense_mha": dense_params(w, w, generator, device),
            "node_ffn": nn.ModuleDict({
                "norm": norm_params(w, device),
                "lr1": dense_params(w, hn, generator, device),
                "lr2": dense_params(hn, w, generator, device)}),
            "dense_edge_b": dense_params(ew, h, generator, device),
        }
        if cfg.gate_attention:
            mods["attention_gates"] = dense_params(ew, h, generator, device)
        mods["norm_edge"] = norm_params(ew, device)
        mods["dense_edge_r"] = dense_params(h, ew, generator, device)
        mods["edge_ffn"] = nn.ModuleDict({
            "norm": norm_params(ew, device),
            "lr1": dense_params(ew, he, generator, device),
            "lr2": dense_params(he, ew, generator, device)})
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, h, e, node_mask, edge_mask, training=False, seed=None):
        return layer_forward(self, self.cfg, h, e, node_mask, edge_mask,
                             training, seed)


def layer_forward(p, cfg, h, e, node_mask, edge_mask, training=False,
                  seed=None):
    """Attention sub-layer + FFN sub-layer. Returns (h, e). `seed` is this
    layer's seed for the step (training)."""
    if (can_fuse_layer(cfg, training)
            and (cfg.edge_channel_type != "constrained"
                 or edge_mask is not None)):
        # whole-layer kernel: edge pre-LN -> gates/bias -> attention ->
        # dense_edge_r + residual -> edge-FFN; the node-stream denses stay out
        y_h = h
        h_n = layer_norm(p["norm_mha"], h)
        qkv = dense(p["dense_qkv"], h_n)
        e, v_att = fused_layer_apply(p, cfg, e, qkv, node_mask, edge_mask,
                                     training, seed)
        h = dropout(dense(p["dense_mha"], v_att), cfg.node_dropout, training,
                    _sub_seed(seed, 2)) + y_h
        h, _ = ffn_block(p, cfg, h, None, skip_edge=True, training=training,
                         seed=seed)
        return h, e
    h, e = edge_update(p, cfg, h, e, node_mask, edge_mask, training, seed)
    return ffn_block(p, cfg, h, e, training=training, seed=seed)
