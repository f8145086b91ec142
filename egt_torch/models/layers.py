"""The dual-stream (node + edge channel) EGT layer.

Port of `egt_tpu/models/layers.py` for the four edge channels:
`layer_norm` and `batch_norm` (eps 1e-3, f32 islands; BatchNorm's batch
statistics over every axis but the last, padding included, and its
moving statistics with momentum 0.99, returned and never written here),
`activation` (every `jax.nn` function that keeps its input's shape, with
JAX's defaults), `dropout`, `_attention`, `_mha_block`, `edge_update`,
`_xtalk` and `ffn_block` (the node <-> edge cross-talk of the FFN hidden
features), `can_fuse_edge_block` and `layer_forward` with its whole-layer
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

BatchNorm's moving-statistics updates go into the `updates` dict a caller
hands `layer_forward`, under JAX's paths (`("norm_mha",)`, `("node_ffn",
"norm")`, ...): a training step writes them after its backward, so a
recomputed forward (`remat`) cannot write them twice.

Parallel runs (`egt_torch/parallel/`): under edge partitioning (`sp`, an
`SPContext`, JAX's `sp` branches) e and every pair tensor hold one
shard's query rows (a replicated virtual-node prefix, then its own rows)
against every key, and the node stream is whole: the queries are the
shard's rows (K1 / K2 on a row block), the attention output is gathered by
rows, cross-talk psums its row sums, the edge-stream BatchNorm psums its
statistics, and row dropout folds the shard in (`sp_dropout_rows`). Under
tensor parallelism (`tp`, `parallel/partitioning.py`) the QKV and FFN-up
Dense layers hold this rank's columns, the attention-out and FFN-down
layers its rows (`dense_rows` psums them), and h_hat is gathered over the
heads. With `data` (the batch one shard of the global batch) BatchNorm
takes the global batch's statistics. A sharded layer never takes the
whole-layer or edge-block kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops.edge_block import edge_block_apply
from ..ops.egt_attention import egt_attention_fused
from ..ops.fused_layer import can_fuse_layer, fused_layer_apply
from ..ops.rng import fold_seed
from ..parallel import collectives as C
from ..parallel.collectives import sp_gather_rows, sp_take_rows
from .egt import egt_attention_core, split_qkv
from .features import dense, dense_params


class SPContext(NamedTuple):
    """Edge partitioning (JAX's `SPContext`, `layers.py:41-47`): the pair
    tensors of this rank hold the query rows of its shard (after a
    replicated virtual-node prefix of `vn` rows) against every key; the
    node stream is whole on every rank."""
    group: object     # `collectives.Group` of the shards
    size: int         # shards
    index: int        # this shard's position
    lq: int           # query rows a shard (virtual nodes excluded)
    vn: int = 0       # virtual-node rows, replicated at the top of each shard
    stats: object = None  # the group of the edge-stream BatchNorm statistics


# -------------------------------------------------------------------- normalization


def layer_norm(p, x, eps: float = 1e-3):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["gamma"] + p["beta"]).to(x.dtype)


def batch_norm(p, x, training: bool, eps: float = 1e-3,
               momentum: float = 0.99, group=None):
    """(y, moving-statistics updates | None). In training the statistics
    run over every axis but the last, with no mask (as Keras and JAX take
    them), and the updates are the new `moving_mean` / `moving_var`; in
    eval the norm reads the moving statistics. With a `group` of more than
    one rank, x is one shard of the logical tensor (a batch shard, a row
    shard or both) and the statistics are the whole tensor's: a psum of
    (sum, sum of squares, count) over the group (`layers.py:96-120` in
    JAX)."""
    xf = x.float()
    updates = None
    if training:
        axes = tuple(range(xf.dim() - 1))
        if group is not None and group.size > 1:
            n = torch.full((1,), float(xf.numel() // xf.shape[-1]),
                           device=xf.device)
            tot = C.psum(torch.cat([xf.sum(axes), torch.square(xf).sum(axes),
                                    n]), group)
            c = xf.shape[-1]
            mu = tot[:c] / tot[-1]
            var = tot[c:2 * c] / tot[-1] - torch.square(mu)
        else:
            mu = xf.mean(axes)
            var = torch.square(xf - mu).mean(axes)
        updates = {
            "moving_mean": (momentum * p["moving_mean"]
                            + (1 - momentum) * mu).detach(),
            "moving_var": (momentum * p["moving_var"]
                           + (1 - momentum) * var).detach()}
    else:
        mu, var = p["moving_mean"], p["moving_var"]
    y = (xf - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y.to(x.dtype), updates


def norm(kind: str, p, x, training: bool, updates: dict | None, path: tuple,
         group=None):
    """The `kind` ("layer" or "batch") norm of x; a BatchNorm's updates go
    into `updates` (if given) under `path`, and its statistics are taken
    over `group`'s shards of x."""
    if kind == "layer":
        return layer_norm(p, x)
    if kind != "batch":
        raise ValueError(f"unknown normalization {kind!r}")
    y, upd = batch_norm(p, x, training, group=group)
    if upd is not None and updates is not None:
        updates[path] = upd
    return y


def norm_params(dim: int, device=None, kind: str = "layer") -> nn.ParameterDict:
    """gamma and beta; a BatchNorm also its moving statistics, which no
    gradient reaches (`requires_grad` False) and the optimizer leaves out
    (`training/optim.py::trainable`)."""
    p = {"gamma": nn.Parameter(torch.ones(dim, device=device)),
         "beta": nn.Parameter(torch.zeros(dim, device=device))}
    if kind == "batch":
        p["moving_mean"] = nn.Parameter(torch.zeros(dim, device=device),
                                        requires_grad=False)
        p["moving_var"] = nn.Parameter(torch.ones(dim, device=device),
                                       requires_grad=False)
    return nn.ParameterDict(p)


# --------------------------------------------------------------------- activations


def _hard_sigmoid(x):
    return torch.nn.functional.relu6(x + 3.0) / 6.0


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _log1mexp(x):
    return torch.where(x < math.log(2.0), torch.log(-torch.expm1(-x)),
                       torch.log1p(-torch.exp(-x)))


def _standardize(x, eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp(torch.square(x).mean(-1, keepdim=True)
                      - torch.square(mean), min=0)
    return (x - mean) * torch.rsqrt(var + eps)


_F = torch.nn.functional
# every `jax.nn` function that maps an array to one of its shape, by name,
# with JAX's defaults (gelu's tanh form, leaky_relu's slope 0.01,
# squareplus's b 4; softmax, log_softmax and standardize over the last axis)
ACTIVATIONS = {
    "celu": lambda x: _F.celu(x, 1.0),
    "elu": _F.elu,
    "gelu": lambda x: _F.gelu(x, approximate="tanh"),
    "hard_sigmoid": _hard_sigmoid,
    "hard_silu": lambda x: x * _hard_sigmoid(x),
    "hard_swish": lambda x: x * _hard_sigmoid(x),
    "hard_tanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "identity": lambda x: x,
    "leaky_relu": lambda x: _F.leaky_relu(x, 0.01),
    "log_sigmoid": lambda x: -_softplus(-x),
    "log1mexp": _log1mexp,
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "relu": torch.relu,
    "relu6": _F.relu6,
    "selu": _F.selu,
    "sigmoid": torch.sigmoid,
    "silu": _F.silu,
    "soft_sign": lambda x: x / (torch.abs(x) + 1),
    "softplus": _softplus,
    "sparse_plus": lambda x: torch.where(
        x <= -1.0, 0.0, torch.where(x >= 1.0, x, torch.square(x + 1.0) / 4)),
    "sparse_sigmoid": lambda x: 0.5 * torch.clamp(x + 1.0, 0.0, 2.0),
    "squareplus": lambda x: (x + torch.sqrt(torch.square(x) + 4)) / 2,
    "swish": _F.silu,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, -1),
    "log_softmax": lambda x: torch.log_softmax(x, -1),
    "standardize": _standardize,
}


def activation(name, x):
    """`jax.nn.<name>` (JAX's `getattr`), or `lreluN`: a leaky ReLU of
    slope N / 10. `glu` halves the last axis, which no layer here can take
    (in JAX neither), and raises, as does a name outside the table."""
    if name is None:
        return x
    if name.lower().startswith("lrelu"):
        return _F.leaky_relu(x, float(name[-1]) / 10.0)
    fn = ACTIVATIONS.get(name)
    if fn is None:
        why = (" (it halves the last axis)" if name == "glu"
               else "; known: " + ", ".join(sorted(ACTIVATIONS)) + ", lreluN")
        raise ValueError(f"activation {name!r} cannot be used here{why}")
    return fn(x)


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


def sp_dropout_rows(x_rows, rate: float, training: bool, seed,
                    sp: SPContext):
    """Dropout on a shard's row block: the replicated virtual-node rows
    draw bits every shard shares (tag 7001), so they stay identical; the
    local rows draw with the shard folded in (7002, index)."""
    if not training or rate <= 0.0:
        return x_rows
    local = dropout(x_rows[:, sp.vn:], rate, training,
                    None if seed is None else fold_seed(seed, 7002, sp.index))
    if sp.vn == 0:
        return local
    return torch.cat([dropout(x_rows[:, :sp.vn], rate, training,
                              _sub_seed(seed, 7001)), local], dim=1)


def _row_dropout(x, rate, training, seed, sp):
    """Node / edge dropout of a tensor whose rows are this shard's under
    `sp`, with the seed JAX folds for each."""
    if sp is not None:
        return sp_dropout_rows(x, rate, training, seed, sp)
    return dropout(x, rate, training, seed)


# ------------------------------------------------------------------ attention block


def _attention(p, cfg, h_n, e_bias_raw, gates_raw, node_mask, edge_mask,
               training=False, seed=None, capture: bool = False, sp=None,
               tp=None):
    """QKV projection + EGT attention. `e_bias_raw`/`gates_raw` are the
    (b, l_q, l, h) projections; `edge_mask` is (b, l_q, l) head-shared or
    None. Returns (v_att (b, l_q, d*h), h_hat (b, l_q, l, h), a_tild (b,
    l_q, l, h), None from the attention kernel); `capture` takes the plain
    core. Under `sp` the queries are this shard's rows (l_q = vn + lq)
    against every key, and the draws fold in (613, index). Under `tp` (a
    tensor-parallel `collectives.Group`) the QKV projection holds this
    rank's heads, the attention runs on them with their columns of the
    edge bias and the gates, and h_hat is gathered over the heads."""
    heads = cfg.num_heads
    if tp is not None and tp.size > 1:
        heads //= tp.size
        cols = slice(tp.index * heads, (tp.index + 1) * heads)
        e_bias_raw = None if e_bias_raw is None else e_bias_raw[..., cols]
        gates_raw = None if gates_raw is None else gates_raw[..., cols]
    if sp is not None and training and (cfg.random_mask_prob > 0
                                        or cfg.attn_dropout > 0):
        if sp.vn > 0:
            raise NotImplementedError(
                "stochastic attention with virtual nodes under edge "
                "partitioning (replicated VN rows would diverge)")
        seed = None if seed is None else fold_seed(seed, 613, sp.index)
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
        d = f // (3 * heads)
        qkv_hm = qkv.reshape(b, l, 3, d, heads)
        q, k, v = (qkv_hm[:, :, i].permute(0, 3, 1, 2) for i in range(3))
        if sp is not None:
            # a rectangular block: this shard's query rows, every key
            q = sp_take_rows(q, sp, dim=2)
        e_hm = e_bias_raw.permute(0, 3, 1, 2)
        g_hm = None if gates_raw is None else gates_raw.permute(0, 3, 1, 2)
        out = egt_attention_fused(q, k, v, e_hm, g_hm, node_mask=node_mask,
                                  attn_mask_hm=edge_mask, **kw)
        return (out.v_att, C.all_gather_rows(out.h_hat.permute(0, 2, 3, 1),
                                             tp, dim=3), None)

    q, k, v = split_qkv(qkv, heads)
    if sp is not None:
        q = sp_take_rows(q, sp)
    am = None if edge_mask is None else edge_mask[..., None]
    out = egt_attention_core(q, k, v, e_bias_raw, gates_raw,
                             node_mask=node_mask, attn_mask=am,
                             chain_f32=bool(cfg.attn_chain_f32), **kw)
    return out.v_att, C.all_gather_rows(out.h_hat, tp, dim=3), out.a_tild


def dense_rows(p, x, tp=None):
    """A row-parallel Dense under `tp`: this rank's rows of the kernel on
    its share of the input features, the partial products summed over the
    group, then the bias (whole on every rank); a plain `dense` without."""
    if tp is None or tp.size == 1:
        return dense(p, x)
    return C.psum(x @ p["kernel"].to(x.dtype), tp) + p["bias"].to(x.dtype)


def _mha_block(p, cfg, h, e_bias, gates, node_mask, edge_mask,
               training=False, seed=None, analysis=None, tag="00",
               updates=None, sp=None, groups=(None, None), tp=None):
    """Pre/post-norm MHA with residual. Returns (h, h_hat, node_repr).
    Under `sp`, h is whole and the attention output's rows are gathered
    back to whole rows."""
    y = h
    if not cfg.add_n_norm:
        h = norm(cfg.node_normalization, p["norm_mha"], h, training, updates,
                 ("norm_mha",), groups[0])
    node_repr = h
    v_att, h_hat, a_tild = _attention(p, cfg, h, e_bias, gates, node_mask,
                                      edge_mask, training, seed,
                                      analysis is not None, sp, tp)
    if analysis is not None:
        analysis[f"mha_{tag}/e"] = h_hat
        analysis[f"mha_{tag}/mat"] = a_tild
    h = _row_dropout(dense_rows(p["dense_mha"], v_att, tp), cfg.node_dropout,
                     training, _sub_seed(seed, 2), sp)
    if sp is not None:
        h = sp_gather_rows(h, sp)
    h = h + y
    if cfg.add_n_norm:
        h = norm(cfg.node_normalization, p["norm_mha"], h, training, updates,
                 ("norm_mha",), groups[0])
    return h, h_hat, node_repr


def _edge_bias(p, cfg, e):
    return activation(cfg.edge_activation, dense(p["dense_edge_b"], e))


def edge_update(p, cfg, h, e, node_mask, edge_mask, training=False,
                seed=None, defer_edge_tail: bool = False, analysis=None,
                tag="00", updates=None, sp=None, groups=(None, None),
                tp=None):
    """The attention sub-layer of each edge channel. Returns (h, e,
    node_repr, edge_repr); with `defer_edge_tail` (residual / constrained),
    the edge tail is left to the edge-block kernel and `e` comes back as the
    pair (h_hat, e_residual). `none` and `bias` pass e through unchanged:
    `none` attends with no edge bias and no gates, `bias` takes both from
    the raw e. `analysis` (a dict) captures this layer's tensors. `groups`
    are those of the node and the edge stream's BatchNorm statistics."""
    cap = analysis is not None
    mha = dict(training=training, seed=seed, analysis=analysis, tag=tag,
               updates=updates, sp=sp, groups=groups, tp=tp)
    if cfg.edge_channel_type == "none":
        if cap:
            analysis[f"dense_edge_b_{tag}/e"] = e
        h, _, node_repr = _mha_block(p, cfg, h, None, None, node_mask,
                                     edge_mask, **mha)
        return h, e, node_repr, None
    y_e = e
    if cfg.edge_residual and not cfg.add_n_norm:
        e = norm(cfg.edge_normalization, p["norm_edge"], e, training,
                 updates, ("norm_edge",), groups[1])
    edge_repr = e if cfg.edge_residual else None
    gates = dense(p["attention_gates"], e) if cfg.gate_attention else None
    eb = _edge_bias(p, cfg, e)
    if cap:
        if gates is not None:
            analysis[f"attention_gates_{tag}/gates"] = gates
        analysis[f"dense_edge_b_{tag}/e"] = eb
    h, h_hat, node_repr = _mha_block(p, cfg, h, eb, gates, node_mask,
                                     edge_mask, **mha)
    if not cfg.edge_residual:
        return h, y_e, node_repr, None
    if defer_edge_tail:
        return h, (h_hat, y_e), node_repr, edge_repr
    e = _row_dropout(dense(p["dense_edge_r"], h_hat), cfg.edge_dropout,
                     training, _sub_seed(seed, 3), sp) + y_e
    if cfg.add_n_norm:
        e = norm(cfg.edge_normalization, p["norm_edge"], e, training,
                 updates, ("norm_edge",), groups[1])
    return h, e, node_repr, edge_repr


# ------------------------------------------------------------------------ FFN block


def xtalk_sizes(cfg, hidden: int, rate: float) -> int:
    """Features of a hidden vector of `hidden` that each direction of the
    cross-talk takes: round(rate * hidden / ffn_multiplier), 0 when off."""
    return round(rate * hidden / cfg.ffn_multiplier) if rate > 0.0 else 0


def ffn_dims(cfg) -> tuple[int, int, int, int]:
    """(node hidden, edge hidden, node lr2 input, edge lr2 input): with
    cross-talk each side gives up two slices (row and column) and takes the
    other side's exchanged features (JAX `graph_model.py::_ffn_dims`)."""
    hn = round(cfg.model_width * cfg.ffn_multiplier)
    he = round(cfg.edge_width * cfg.ffn_multiplier)
    nx_e2n = xtalk_sizes(cfg, he, cfg.edge2node_xtalk)
    nx_n2e = xtalk_sizes(cfg, hn, cfg.node2edge_xtalk)
    return hn, he, hn - 2 * nx_n2e + nx_e2n, he - 2 * nx_e2n + nx_n2e


def _xtalk(cfg, x_h, x_e, node_mask, sp=None):
    """Node <-> edge cross-talk on the FFN hidden features. Edge to node:
    the first slice of each pair's features summed over the valid rows, the
    second over the valid columns, both over the graph's valid nodes (zeros
    for a graph with none). Node to edge: a node's first slice on its row
    plus its second on its column. Each side keeps the rest of its features
    and the other side's exchange is concatenated after them. Under `sp`,
    x_e holds this shard's rows: the row sums are a psum of the shards'
    partial sums (the replicated virtual rows counted once), and the column
    sums are gathered by rows."""
    x_h_n = x_e_n = None
    if cfg.edge2node_xtalk > 0.0:
        he = x_e.shape[-1]
        nx = xtalk_sizes(cfg, he, cfg.edge2node_xtalk)
        x_er, x_ec, x_e = torch.split(x_e, [nx, nx, he - 2 * nx], dim=3)
        m = node_mask.to(x_h.dtype)
        if sp is not None:
            weighted = x_er * sp_take_rows(m, sp)[:, :, None, None]
            x_er = C.psum(torch.sum(weighted[:, sp.vn:], dim=1), sp.group)
            if sp.vn:
                x_er = x_er + torch.sum(weighted[:, :sp.vn], dim=1)
            x_ec = sp_gather_rows(
                torch.sum(x_ec * m[:, None, :, None], dim=2), sp)
        else:
            x_er = torch.sum(x_er * m[:, :, None, None], dim=1)
            x_ec = torch.sum(x_ec * m[:, None, :, None], dim=2)
        m_sum = torch.sum(m, dim=1)[:, None, None]
        x_h_n = torch.where(
            m_sum > 0, (x_er + x_ec) / torch.where(m_sum > 0, m_sum, 1.0),
            torch.zeros((), dtype=x_h.dtype, device=x_h.device))
    if cfg.node2edge_xtalk > 0.0:
        hn = x_h.shape[-1]
        nx = xtalk_sizes(cfg, hn, cfg.node2edge_xtalk)
        x_hr, x_hc, x_h = torch.split(x_h, [nx, nx, hn - 2 * nx], dim=2)
        if sp is not None:
            x_hr = sp_take_rows(x_hr, sp)
        x_e_n = x_hr[:, :, None, :] + x_hc[:, None, :, :]
    if x_h_n is not None:
        x_h = torch.cat([x_h, x_h_n], dim=-1)
    if x_e_n is not None:
        x_e = torch.cat([x_e, x_e_n], dim=-1)
    return x_h, x_e


def ffn_block(p, cfg, h, e, skip_edge: bool = False, training=False,
              seed=None, node_mask=None, updates=None, sp=None,
              groups=(None, None), tp=None):
    """Dual FFN: norm (pre-norm) -> lr1 -> act -> lr2 (-> dropout) +
    residual (post-norm after) on each stream. With cross-talk the
    activation comes after the exchange (which needs `node_mask`). Returns
    (h, e); `skip_edge` when a kernel already applied the edge-side FFN."""
    xtalk = cfg.node2edge_xtalk > 0.0 or cfg.edge2node_xtalk > 0.0
    act = cfg.activation
    edge = cfg.edge_channel_type in ("residual", "constrained") \
        and not skip_edge
    pn = p["node_ffn"]

    def pre(kind, q, x, path, group):
        if not cfg.add_n_norm:
            x = norm(kind, q["norm"], x, training, updates, path, group)
        x = dense(q["lr1"], x)
        return x if xtalk else activation(act, x)

    def post(kind, q, x, y, rate, tag, path, group, rows):
        if xtalk:
            x = activation(act, x)
        x = _row_dropout(dense_rows(q["lr2"], x, tp), rate, training,
                         _sub_seed(seed, tag), rows) + y
        if cfg.add_n_norm:
            x = norm(kind, q["norm"], x, training, updates, path, group)
        return x

    x_h = pre(cfg.node_normalization, pn, h, ("node_ffn", "norm"), groups[0])
    if edge:
        pe = p["edge_ffn"]
        x_e = pre(cfg.edge_normalization, pe, e, ("edge_ffn", "norm"),
                  groups[1])
        if xtalk:
            x_h, x_e = _xtalk(cfg, x_h, x_e, node_mask, sp)
        e = post(cfg.edge_normalization, pe, x_e, e, cfg.edge_dropout, 4,
                 ("edge_ffn", "norm"), groups[1], sp)
    h = post(cfg.node_normalization, pn, x_h, h, cfg.node_dropout, 5,
             ("node_ffn", "norm"), groups[0], None)
    return h, e


# ------------------------------------------------------------------- one full layer


class EGTLayer(nn.ModuleDict):
    """One layer's parameters under the JAX names, and its forward."""

    def __init__(self, cfg, generator, device=None):
        w, ew, h = cfg.model_width, cfg.edge_width, cfg.num_heads
        hn, he, node_lr2_in, edge_lr2_in = ffn_dims(cfg)
        nk, ek = cfg.node_normalization, cfg.edge_normalization
        mods = {
            "norm_mha": norm_params(w, device, nk),
            "dense_qkv": dense_params(w, 3 * w, generator, device),
            "dense_mha": dense_params(w, w, generator, device),
            "node_ffn": nn.ModuleDict({
                "norm": norm_params(w, device, nk),
                "lr1": dense_params(w, hn, generator, device),
                "lr2": dense_params(node_lr2_in, w, generator, device)}),
        }
        if cfg.edge_channel_type != "none":
            mods["dense_edge_b"] = dense_params(ew, h, generator, device)
            if cfg.gate_attention:
                mods["attention_gates"] = dense_params(ew, h, generator,
                                                       device)
        if cfg.edge_residual:
            mods["norm_edge"] = norm_params(ew, device, ek)
            mods["dense_edge_r"] = dense_params(h, ew, generator, device)
            mods["edge_ffn"] = nn.ModuleDict({
                "norm": norm_params(ew, device, ek),
                "lr1": dense_params(ew, he, generator, device),
                "lr2": dense_params(edge_lr2_in, ew, generator, device)})
        super().__init__(mods)
        self.cfg = cfg

    def forward(self, h, e, node_mask, edge_mask, training=False, seed=None,
                analysis=None, layer_idx: int = 0, reprs=None, updates=None,
                sp=None, data=None, tp=None):
        return layer_forward(self, self.cfg, h, e, node_mask, edge_mask,
                             training, seed, analysis, layer_idx, reprs,
                             updates, sp, data, tp)


def layer_forward(p, cfg, h, e, node_mask, edge_mask, training=False,
                  seed=None, analysis=None, layer_idx: int = 0, reprs=None,
                  updates=None, sp=None, data=None, tp=None):
    """Attention sub-layer + FFN sub-layer. Returns (h, e). `seed` is this
    layer's seed for the step (training). With `analysis` (a dict) the
    layer runs the plain path and captures its tensors under the tag of
    `layer_idx`; with `reprs` (a list) it appends (node_repr, edge_repr);
    with `updates` (a dict) it puts its BatchNorms' moving-statistics
    updates there under JAX's paths.

    Parallel runs: `sp` (an `SPContext`) when e, the edge mask and the
    pair tensors hold one shard's rows; the layer then takes the attention
    kernel (K1 / K2) on its row block and never the whole-layer or
    edge-block kernels (JAX's `can_fuse_layer` / `can_fuse_edge_block`
    refuse `sp`). `data` (a `collectives.Group`) when the batch is one
    shard of the global batch: the node stream's BatchNorm statistics are
    taken over it, the edge stream's over `sp.stats` under `sp`. `tp` (a
    `collectives.Group`) when the layer's parameters are its tensor-parallel
    shards (`parallel/partitioning.py`): the attention kernel on this
    rank's heads, no whole-layer or edge-block kernel."""
    capture = analysis is not None
    groups = (data, sp.stats if sp is not None else data)
    ffn = dict(training=training, seed=seed, node_mask=node_mask,
               updates=updates, sp=sp, groups=groups, tp=tp)
    sharded = sp is not None or tp is not None
    if (not sharded and can_fuse_layer(cfg, training, capture)
            and (cfg.edge_channel_type != "constrained"
                 or edge_mask is not None)):
        # whole-layer kernel: edge pre-LN -> gates/bias -> attention ->
        # dense_edge_r + residual -> edge-FFN; the node-stream denses stay out
        # (LayerNorm only: `can_fuse_layer` refuses BatchNorm)
        y_h = h
        h_n = layer_norm(p["norm_mha"], h)
        qkv = dense(p["dense_qkv"], h_n)
        e, v_att = fused_layer_apply(p, cfg, e, qkv, node_mask, edge_mask,
                                     training, seed)
        h = dropout(dense(p["dense_mha"], v_att), cfg.node_dropout, training,
                    _sub_seed(seed, 2)) + y_h
        h, _ = ffn_block(p, cfg, h, None, skip_edge=True, **ffn)
        return h, e
    fuse_edge = not sharded and can_fuse_edge_block(cfg, training, capture)
    h, e, node_repr, edge_repr = edge_update(
        p, cfg, h, e, node_mask, edge_mask, training, seed,
        defer_edge_tail=fuse_edge, analysis=analysis,
        tag=f"{layer_idx:0>2d}", updates=updates, sp=sp, groups=groups,
        tp=tp)
    if reprs is not None:
        reprs.append((node_repr, edge_repr))
    if fuse_edge:
        # edge-block kernel: dense_edge_r + residual + edge FFN in one pass
        h_hat, y_e = e
        e = edge_block_apply(p, h_hat, y_e)
        h, _ = ffn_block(p, cfg, h, None, skip_edge=True, **ffn)
        return h, e
    return ffn_block(p, cfg, h, e, **ffn)


def can_fuse_edge_block(cfg, training: bool = False,
                        capture: bool = False) -> bool:
    """Eligibility of the edge-block kernel: the JAX `can_fuse_edge_block`
    (analysis capture refuses it; `layer_forward` takes it only on an
    unsharded layer). Like the JAX rule it does not look at
    `cfg.activation`: the kernel's activation is ELU."""
    return (bool(cfg.fused_edge_block)
            and not capture
            and cfg.edge_width >= 64
            and cfg.edge_channel_type in ("residual", "constrained")
            and not cfg.add_n_norm
            and cfg.edge_normalization == "layer"
            and not (training and cfg.edge_dropout > 0)
            and cfg.node2edge_xtalk == 0.0 and cfg.edge2node_xtalk == 0.0)
