"""The dual-stream (node + edge channel) EGT layer.

Port of `egt_tpu/models/layers.py` for the four edge channels with
LayerNorm and no cross-talk: `layer_norm` (eps 1e-3, f32 island),
`activation`, `dropout`, `_attention`, `_mha_block`, `edge_update`,
`ffn_block`, `can_fuse_edge_block` and `layer_forward` with its whole-layer
and edge-block branches. The residual and constrained channels update e
(pre-LN, edge bias and gates, dense_edge_r, residual, edge FFN); the
`bias` channel feeds the raw e to the edge bias and the gates and passes
it through unchanged; the `none` channel has no edge bias and no gates. A
layer is an `nn.ModuleDict` whose keys are the JAX parameter names, so the
functions below read it as they read the JAX params tree.

Dispatch per layer: the whole-layer kernel when `can_fuse_layer` holds
(residual / constrained only); else the attention kernel when
`cfg.fused_attention` is on (under "auto", only for a layer with an edge
bias), or the plain `egt_attention_core`, followed by
the edge-block kernel for the edge tail when `can_fuse_edge_block` holds.
Each kernel wrapper takes its plain version on CPU tensors.

Training: one seed per layer and step (`seed`). It keys the attention
draws (the random mask and attention dropout, `ops/rng.py`) directly, and
node / edge dropout through `fold_seed(seed, tag)` with the JAX fold tags
(2 after attention, 3 after dense_edge_r, 4 edge FFN, 5 node FFN).

Analysis capture (JAX's `capture` argument): given an `analysis` dict, a
layer runs the plain path (no kernel) and writes JAX's keys under its tag
`{i:0>2d}`: `mha_{tag}/e` (h_hat) and `mha_{tag}/mat` (a_tild, the
post-gate, post-dropout attention), `attention_gates_{tag}/gates` (the
pre-sigmoid gates) and `dense_edge_b_{tag}/e` (the edge bias; for the
`none` channel the raw e). Given a `reprs` list, it appends its
(node_repr, edge_repr): the normed h before attention, and the normed e of
the residual / constrained channels (None for the others), the inputs of
`combine_layer_repr`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.edge_block import edge_block_apply
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
               training=False, seed=None, capture: bool = False):
    """QKV projection + EGT attention. `e_bias_raw`/`gates_raw` are the
    (b, l, l, h) projections; `edge_mask` is (b, l, l) head-shared or None.
    Returns (v_att (b, l, d*h), h_hat (b, l, l, h), a_tild (b, l, l, h), None
    from the attention kernel); `capture` takes the plain core."""
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
    # "auto" takes the kernel where it can run the layer: a layer with no
    # edge bias (the `none` channel) runs the plain core, as
    # `can_fuse_layer` sends the `bias` channel past the whole-layer kernel
    if cfg.fused_attention and not capture and not (
            e_bias_raw is None and cfg.fused_attention == "auto"):
        if e_bias_raw is None:
            # JAX's kernel path fails here too: `egt_attention_fused` casts
            # its edge bias (`egt_tpu/ops/egt_pallas.py:538`)
            raise ValueError(
                "the attention kernel needs an edge bias, and the 'none' "
                "edge channel has none (as in JAX, egt_tpu/ops/egt_pallas.py"
                ":538); set use_pallas: false to run it on the plain "
                "attention core")
        b, l, f = qkv.shape
        d = f // (3 * cfg.num_heads)
        qkv_hm = qkv.reshape(b, l, 3, d, cfg.num_heads)
        q, k, v = (qkv_hm[:, :, i].permute(0, 3, 1, 2) for i in range(3))
        e_hm = e_bias_raw.permute(0, 3, 1, 2)
        g_hm = None if gates_raw is None else gates_raw.permute(0, 3, 1, 2)
        out = egt_attention_fused(q, k, v, e_hm, g_hm, node_mask=node_mask,
                                  attn_mask_hm=edge_mask, **kw)
        return out.v_att, out.h_hat.permute(0, 2, 3, 1), None

    q, k, v = split_qkv(qkv, cfg.num_heads)
    am = None if edge_mask is None else edge_mask[..., None]
    out = egt_attention_core(q, k, v, e_bias_raw, gates_raw,
                             node_mask=node_mask, attn_mask=am,
                             chain_f32=bool(cfg.attn_chain_f32), **kw)
    return out.v_att, out.h_hat, out.a_tild


def _mha_block(p, cfg, h, e_bias, gates, node_mask, edge_mask,
               training=False, seed=None, analysis=None, tag="00"):
    """Pre/post-norm MHA with residual. Returns (h, h_hat, node_repr)."""
    y = h
    if not cfg.add_n_norm:
        h = layer_norm(p["norm_mha"], h)
    node_repr = h
    v_att, h_hat, a_tild = _attention(p, cfg, h, e_bias, gates, node_mask,
                                      edge_mask, training, seed,
                                      analysis is not None)
    if analysis is not None:
        analysis[f"mha_{tag}/e"] = h_hat
        analysis[f"mha_{tag}/mat"] = a_tild
    h = dropout(dense(p["dense_mha"], v_att), cfg.node_dropout, training,
                _sub_seed(seed, 2)) + y
    if cfg.add_n_norm:
        h = layer_norm(p["norm_mha"], h)
    return h, h_hat, node_repr


def _edge_bias(p, cfg, e):
    return activation(cfg.edge_activation, dense(p["dense_edge_b"], e))


def edge_update(p, cfg, h, e, node_mask, edge_mask, training=False,
                seed=None, defer_edge_tail: bool = False, analysis=None,
                tag="00"):
    """The attention sub-layer of each edge channel. Returns (h, e,
    node_repr, edge_repr); with `defer_edge_tail` (residual / constrained),
    the edge tail is left to the edge-block kernel and `e` comes back as the
    pair (h_hat, e_residual). `none` and `bias` pass e through unchanged:
    `none` attends with no edge bias and no gates, `bias` takes both from
    the raw e. `analysis` (a dict) captures this layer's tensors."""
    cap = analysis is not None
    if cfg.edge_channel_type == "none":
        if cap:
            analysis[f"dense_edge_b_{tag}/e"] = e
        h, _, node_repr = _mha_block(p, cfg, h, None, None, node_mask,
                                     edge_mask, training, seed, analysis, tag)
        return h, e, node_repr, None
    y_e = e
    if cfg.edge_residual and not cfg.add_n_norm:
        e = layer_norm(p["norm_edge"], e)
    edge_repr = e if cfg.edge_residual else None
    gates = dense(p["attention_gates"], e) if cfg.gate_attention else None
    eb = _edge_bias(p, cfg, e)
    if cap:
        if gates is not None:
            analysis[f"attention_gates_{tag}/gates"] = gates
        analysis[f"dense_edge_b_{tag}/e"] = eb
    h, h_hat, node_repr = _mha_block(p, cfg, h, eb, gates, node_mask,
                                     edge_mask, training, seed, analysis, tag)
    if not cfg.edge_residual:
        return h, y_e, node_repr, None
    if defer_edge_tail:
        return h, (h_hat, y_e), node_repr, edge_repr
    e = dropout(dense(p["dense_edge_r"], h_hat), cfg.edge_dropout, training,
                _sub_seed(seed, 3)) + y_e
    if cfg.add_n_norm:
        e = layer_norm(p["norm_edge"], e)
    return h, e, node_repr, edge_repr


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
        }
        if cfg.edge_channel_type != "none":
            mods["dense_edge_b"] = dense_params(ew, h, generator, device)
            if cfg.gate_attention:
                mods["attention_gates"] = dense_params(ew, h, generator,
                                                       device)
        if cfg.edge_residual:
            mods["norm_edge"] = norm_params(ew, device)
            mods["dense_edge_r"] = dense_params(h, ew, generator, device)
            mods["edge_ffn"] = nn.ModuleDict({
                "norm": norm_params(ew, device),
                "lr1": dense_params(ew, he, generator, device),
                "lr2": dense_params(he, ew, generator, device)})
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, h, e, node_mask, edge_mask, training=False, seed=None,
                analysis=None, layer_idx: int = 0, reprs=None):
        return layer_forward(self, self.cfg, h, e, node_mask, edge_mask,
                             training, seed, analysis, layer_idx, reprs)


def layer_forward(p, cfg, h, e, node_mask, edge_mask, training=False,
                  seed=None, analysis=None, layer_idx: int = 0, reprs=None):
    """Attention sub-layer + FFN sub-layer. Returns (h, e). `seed` is this
    layer's seed for the step (training). With `analysis` (a dict) the
    layer runs the plain path and captures its tensors under the tag of
    `layer_idx`; with `reprs` (a list) it appends (node_repr, edge_repr)."""
    capture = analysis is not None
    if (can_fuse_layer(cfg, training, capture)
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
    fuse_edge = can_fuse_edge_block(cfg, training, capture)
    h, e, node_repr, edge_repr = edge_update(
        p, cfg, h, e, node_mask, edge_mask, training, seed,
        defer_edge_tail=fuse_edge, analysis=analysis,
        tag=f"{layer_idx:0>2d}")
    if reprs is not None:
        reprs.append((node_repr, edge_repr))
    if fuse_edge:
        # edge-block kernel: dense_edge_r + residual + edge FFN in one pass
        h_hat, y_e = e
        e = edge_block_apply(p, h_hat, y_e)
        h, _ = ffn_block(p, cfg, h, None, skip_edge=True, training=training,
                         seed=seed)
        return h, e
    return ffn_block(p, cfg, h, e, training=training, seed=seed)


def can_fuse_edge_block(cfg, training: bool = False,
                        capture: bool = False) -> bool:
    """Eligibility of the edge-block kernel: the JAX `can_fuse_edge_block`
    (without sequence parallelism, which the port does not run; analysis
    capture refuses it). Like the JAX rule it does not look at
    `cfg.activation`: the kernel's activation is ELU."""
    return (bool(cfg.fused_edge_block)
            and not capture
            and cfg.edge_width >= 64
            and cfg.edge_channel_type in ("residual", "constrained")
            and not cfg.add_n_norm
            and cfg.edge_normalization == "layer"
            and not (training and cfg.edge_dropout > 0)
            and cfg.node2edge_xtalk == 0.0 and cfg.edge2node_xtalk == 0.0)
