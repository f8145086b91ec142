"""A plain PyTorch Edge-augmented Graph Transformer, forward and training.

Written from the EGT paper (Hussain et al., "Global Self-Attention as a
Replacement for Graph Convolution", KDD 2022) and the run configs' model
settings, in float32 with no kernels and no batching tricks. It imports
nothing of the program. The layer, per graph of l nodes (k virtual nodes
first) with node features h (l, w) and edge features e (l, l, ew):

    e_n = LN(e);  G = e_n Wg + bg;  E = e_n Wb + bb         (l, l, H)
    q, k, v = split(LN(h) Wqkv + bqkv)                      [3, d, H] order
    H_hat = clip(q.k / sqrt(d), -5, 5) + E
    A = softmax_keys(H_hat + mask) * sigmoid(G + mask)      (random mask
        and attention dropout drawn from `rng.py` in training)
    V = A v  (times log(1 + sum_keys sigmoid(G + mask)) with the degree
        scaler, 1 on the virtual nodes' rows)
    h = h + V Wo + bo;   e = e + H_hat Wr + br
    h = h + elu(LN(h) W1 + b1) W2 + b2;   e likewise with the edge FFN

LayerNorm has eps 1e-3. The graph readout reads the k virtual nodes' rows
side by side after a final LN (or the mean node without them), the node
readout every node; an MLP of ELUs maps them to the targets. Node and edge
tokens are embedded by one table per input (multi-column tokens: the
columns' rows summed from one table, offset by column; -1 padding takes
row 0 in every column), hops by a dense map of the clipped k-hop
adjacency stack, virtual nodes and their edges as learned rows.

`precision` says where values are rounded: "float32" rounds nothing;
"float8" rounds every dense product's inputs, weights and output, the
node and edge streams and the attention output to float8 (e4m3), the
step below the bfloat16 the configurations state (the control), and
passes gradients through unrounded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import rng


@dataclass(frozen=True)
class Spec:
    width: int
    edge_width: int
    heads: int
    height: int
    ffn_multiplier: float
    num_virtual_nodes: int
    scale_degree: bool
    attn_dropout: float
    random_mask_prob: float
    upto_hop: int
    node_vocab: tuple            # rows per node-token column
    edge_vocab: tuple | None     # rows per edge-token column; None: no input
    readout: str                 # graph | node
    num_targets: int
    mlp_layers: tuple
    loss: str                    # mae | weighted_xent
    class_sizes: tuple = ()
    clip: tuple = (-5.0, 5.0)
    multi_column: bool = True    # node tokens carry a column axis

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        kw = dict(d)
        for key in ("node_vocab", "edge_vocab", "mlp_layers", "class_sizes",
                    "clip"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)


def param_spec(s: Spec) -> list[tuple[str, tuple, str]]:
    """(flat name, shape, initialiser) of every parameter: `glorot`
    uniform, `uniform05` U(-0.05, 0.05), `zeros` or `ones`."""
    w, ew, H = s.width, s.edge_width, s.heads
    out = []

    def dense(name, i, o):
        out.append((f"{name}/kernel", (i, o), "glorot"))
        out.append((f"{name}/bias", (o,), "zeros"))

    def norm(name, n):
        out.append((f"{name}/gamma", (n,), "ones"))
        out.append((f"{name}/beta", (n,), "zeros"))

    out.append(("node_emb/table", (sum(s.node_vocab) + 1, w), "uniform05"))
    if s.edge_vocab is not None:
        out.append(("fm_emb/table", (sum(s.edge_vocab) + 1, ew), "uniform05"))
    dense("adj_emb", s.upto_hop, ew)
    if s.num_virtual_nodes:
        out.append(("virtual_node_embeddings", (s.num_virtual_nodes, w),
                    "uniform05"))
        out.append(("virtual_edge_embeddings", (s.num_virtual_nodes, ew),
                    "uniform05"))
    hn, he = round(w * s.ffn_multiplier), round(ew * s.ffn_multiplier)
    for i in range(s.height):
        p = f"stack/layers/{i}"
        norm(f"{p}/norm_mha", w)
        dense(f"{p}/dense_qkv", w, 3 * w)
        dense(f"{p}/dense_mha", w, w)
        norm(f"{p}/node_ffn/norm", w)
        dense(f"{p}/node_ffn/lr1", w, hn)
        dense(f"{p}/node_ffn/lr2", hn, w)
        dense(f"{p}/dense_edge_b", ew, H)
        dense(f"{p}/attention_gates", ew, H)
        norm(f"{p}/norm_edge", ew)
        dense(f"{p}/dense_edge_r", H, ew)
        norm(f"{p}/edge_ffn/norm", ew)
        dense(f"{p}/edge_ffn/lr1", ew, he)
        dense(f"{p}/edge_ffn/lr2", he, ew)
    norm("stack/node_norm_final", w)
    norm("stack/edge_norm_final", ew)
    din = w * max(1, s.num_virtual_nodes) if s.readout == "graph" else w
    for j, f in enumerate(s.mlp_layers):
        dout = round(f * w)
        dense(f"mlp_out/dense/{j}", din, dout)
        din = dout
    dense("target", din, s.num_targets)
    return out


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "float8":
        # rounded values forward; gradients pass unrounded (rounding them
        # too, to e5m2 under a scale, moved PATTERN's gradient numbers
        # little, on the CPU at 32 graphs a step)
        return lambda x: x + (x.detach().to(torch.float8_e4m3fn)
                              .to(torch.float32) - x.detach())
    raise ValueError(f"unknown precision {precision!r}")


def _ln(P, name, x, eps=1e-3):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * P[f"{name}/gamma"] \
        + P[f"{name}/beta"]


class Forward:
    """The forward of one batch (a dict of tensors on one device)."""

    def __init__(self, spec: Spec, params: dict, precision: str = "float32"):
        self.s = spec
        self.P = params
        self.r = _rounder(precision)

    def dense(self, name, x):
        r = self.r
        return r(r(x) @ r(self.P[f"{name}/kernel"]) + self.P[f"{name}/bias"])

    def _tokens(self, table, ids, vocab):
        """Sum of each column's row of `table` (-1 padding: row 0)."""
        offsets = torch.tensor([0] + list(vocab[:-1]), device=ids.device)
        offsets = torch.cumsum(offsets, 0)
        idx = ids.long() + 1 + offsets
        idx = torch.where(ids[..., :1] >= 0, idx, 0)
        return table[idx].sum(-2)

    def embed(self, batch):
        s, P = self.s, self.P
        nf = batch["node_features"]
        if s.multi_column:
            h = self._tokens(P["node_emb/table"], nf, s.node_vocab)
            node_mask = nf[..., 0] >= 0
        else:
            h = P["node_emb/table"][nf.long() + 1]
            node_mask = nf >= 0
        adj = batch["graph_matrix"].float()
        hops, hop = [adj], adj
        for _ in range(s.upto_hop - 1):
            hop = torch.clamp(adj @ hop, 0.0, 1.0)
            hops.append(hop)
        e = self.dense("adj_emb", torch.stack(hops, -1))
        if s.edge_vocab is not None:
            e = self._tokens(P["fm_emb/table"], batch["feature_matrix"],
                             s.edge_vocab) + e
        k = s.num_virtual_nodes
        if k:
            b, l = h.shape[:2]
            vn, ve = P["virtual_node_embeddings"], P["virtual_edge_embeddings"]
            h = torch.cat([vn[None].expand(b, k, -1), h], 1)
            ew = ve.shape[1]
            rows = ve[None, :, None, :].expand(b, k, l, ew)
            cols = ve[None, None, :, :].expand(b, l, k, ew)
            box = (0.5 * (ve[:, None] + ve[None, :]))[None].expand(b, k, k, ew)
            e = torch.cat([torch.cat([box, cols], 1),
                           torch.cat([rows, e], 1)], 2)
            node_mask = torch.nn.functional.pad(node_mask, (k, 0), value=True)
        return self.r(h), self.r(e), node_mask

    def attention(self, i, h_n, eb, gates, node_mask, seed, b0):
        s = self.s
        p = f"stack/layers/{i}"
        qkv = self.dense(f"{p}/dense_qkv", h_n)
        b, l, _ = qkv.shape
        H = s.heads
        d = s.width // H
        qkv = qkv.reshape(b, l, 3, d, H)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        a_hat = torch.einsum("bldh,bmdh->blmh", q, k) * d ** -0.5
        h_hat = torch.clamp(a_hat, *s.clip) + eb
        madd = (node_mask.float()[:, None, :, None] - 1.0) * 1e9
        logits, g = h_hat + madd, gates + madd
        if seed is not None and s.random_mask_prob > 0:
            u = rng.pair_uniform(seed, b0, logits.shape, rng.RANDOM_MASK,
                                 logits.device)
            rm = torch.where(u < s.random_mask_prob, -1e9, 0.0)
            logits, g = logits + rm, g + rm
        sg = torch.sigmoid(g)
        a = torch.softmax(logits, dim=2) * sg
        if seed is not None and s.attn_dropout > 0:
            u = rng.pair_uniform(seed, b0, a.shape, rng.DROPOUT, a.device)
            a = torch.where(u >= s.attn_dropout, a / (1.0 - s.attn_dropout),
                            0.0)
        v_att = torch.einsum("blmh,bmdh->bldh", self.r(a), v)
        if s.scale_degree:
            scal = torch.log1p(sg.sum(2, keepdim=True))
            kv = s.num_virtual_nodes
            if kv:
                scal = torch.cat([torch.ones_like(scal[:, :kv]),
                                  scal[:, kv:]], 1)
            v_att = v_att * scal
        return self.r(v_att.reshape(b, l, d * H)), self.r(h_hat)

    def layer(self, i, h, e, node_mask, seed, b0):
        p = f"stack/layers/{i}"
        e_n = self.r(_ln(self.P, f"{p}/norm_edge", e))
        gates = self.dense(f"{p}/attention_gates", e_n)
        eb = self.dense(f"{p}/dense_edge_b", e_n)
        h_n = self.r(_ln(self.P, f"{p}/norm_mha", h))
        v_att, h_hat = self.attention(i, h_n, eb, gates, node_mask, seed, b0)
        h = self.r(self.dense(f"{p}/dense_mha", v_att) + h)
        e = self.r(self.dense(f"{p}/dense_edge_r", h_hat) + e)
        for x_name, stream in (("node_ffn", "h"), ("edge_ffn", "e")):
            x = h if stream == "h" else e
            y = self.r(_ln(self.P, f"{p}/{x_name}/norm", x))
            y = torch.nn.functional.elu(self.dense(f"{p}/{x_name}/lr1", y))
            y = self.r(self.dense(f"{p}/{x_name}/lr2", y) + x)
            if stream == "h":
                h = y
            else:
                e = y
        return h, e

    def __call__(self, batch, seeds=None, b0: int = 0):
        """Predictions (b, targets) or (b, l, targets); `seeds` (one a
        layer) draw the training bits for graphs b0, b0 + 1, ... of the
        batch."""
        s = self.s
        h, e, node_mask = self.embed(batch)
        for i in range(s.height):
            h, e = self.layer(i, h, e, node_mask,
                              None if seeds is None else seeds[i], b0)
        h = self.r(_ln(self.P, "stack/node_norm_final", h))
        k = s.num_virtual_nodes
        if s.readout == "graph":
            if k:
                x = h[:, :k].reshape(h.shape[0], -1)
            else:
                m = node_mask.float()[..., None]
                x = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        else:
            x = h[:, k:]
        for j in range(len(s.mlp_layers)):
            x = torch.nn.functional.elu(self.dense(f"mlp_out/dense/{j}", x))
        return self.dense("target", x)


def class_weights(sizes) -> torch.Tensor:
    sz = torch.tensor(sizes, dtype=torch.float64)
    w = sz.sum() - sz
    return (w / w.sum()).float()


def loss_terms(spec: Spec, pred, batch):
    """(sum, count) of the scheme's loss over a batch: the MAE of the graph
    target, or the class-weighted cross-entropy over the valid nodes (the
    count unweighted)."""
    sm = batch["sample_mask"].float()
    if spec.loss == "mae":
        err = torch.abs(pred - batch["target"].float())
        w = sm[:, None].expand_as(err)
        return (err * w).sum(), w.sum()
    target = batch["target"].long()
    valid = (batch["node_features"] >= 0).float() * sm[:, None]
    logp = torch.log_softmax(pred, -1)
    idx = torch.clamp(target, 0, pred.shape[-1] - 1)
    elem = -torch.gather(logp, -1, idx[..., None])[..., 0]
    elem = elem * class_weights(spec.class_sizes).to(pred.device)[target]
    return (elem * valid).sum(), valid.sum()


def init_params(spec: Spec, seed: int, device, dtype=torch.float32) -> dict:
    """The parameters drawn from `seed` on `device` in one call of a
    generator there: glorot-uniform kernels, U(-0.05, 0.05) embeddings,
    zero biases, unit LayerNorm scales."""
    entries = param_spec(spec)
    total = sum(math.prod(shape) for _, shape, _ in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, init in entries:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        if init == "glorot":
            lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            out[name] = u.mul_(2.0).sub_(1.0).mul_(lim)
        elif init == "uniform05":
            out[name] = u.mul_(2.0).sub_(1.0).mul_(0.05)
        elif init == "zeros":
            out[name] = u.zero_()
        else:
            out[name] = u.fill_(1.0)
    return out
