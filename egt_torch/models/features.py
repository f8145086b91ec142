"""Feature embeddings, initialisers and the adjacency hop stack.

Port of the parts of `egt_tpu/models/features.py` the ported schemes run:
Keras-style initialisers (drawn from an explicit `torch.Generator`), `dense`,
the -1-masked token embedding and its multi-column form (the OGB atom and
bond features of PCQM4Mv2), the masked dense embedding (MNIST / CIFAR10
superpixel features), the clipped hop stack, the distance objective's
targets, the one-hot degree encoding, the diffusion of the edge features
over the column-normalised adjacency, the pairwise sum of a node2edge
embedding, the pairwise concatenation of the TSP edge readout, the virtual
nodes' rows, edge blocks and hard-mask extension, and the SVD and
eigenvector positional encodings with their training-time sign flips.
The `_sp` twins (`stack_hops_sp`, `distance_targets_sp`,
`degree_encoding_sp`, `edge_diffusion_sp`, `pairwise_add_sp`,
`prepend_virtual_edges_sp`) build the same from one shard's rows of the
adjacency and the edge features under edge partitioning, gathering rows or
summing over the shards where a row needs the whole matrix.

The flips are drawn from the port's Philox (`ops/rng.py`, draw index
`PE_FLIP`) on the input tensor's device from an explicit seed: one uniform a
(graph, feature), keyed by (graph, feature), with no host read and no global
generator. JAX's bits differ, so parity with JAX is statistical, as for the
attention draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import rng
from ..parallel.collectives import all_gather_rows, psum


# ---------------------------------------------------------------------- initializers


def glorot_uniform(shape, generator: torch.Generator, device=None):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    x = torch.rand(shape, generator=generator, device=device)
    return (2.0 * x - 1.0) * limit


def uniform_05(shape, generator: torch.Generator, device=None):
    """Keras 'uniform' initializer: U(-0.05, 0.05) (embeddings)."""
    x = torch.rand(shape, generator=generator, device=device)
    return (2.0 * x - 1.0) * 0.05


def dense_params(in_dim, out_dim, generator, device=None) -> nn.ParameterDict:
    """A Dense layer's parameters under the JAX names: kernel (in, out), bias."""
    return nn.ParameterDict({
        "kernel": nn.Parameter(glorot_uniform((in_dim, out_dim), generator,
                                              device)),
        "bias": nn.Parameter(torch.zeros(out_dim, device=device))})


def dense_params_uniform(in_dim, out_dim, generator,
                         device=None) -> nn.ParameterDict:
    """A Dense layer with the Keras 'uniform' kernel (the degree
    encoding's, as the reference draws it)."""
    return nn.ParameterDict({
        "kernel": nn.Parameter(uniform_05((in_dim, out_dim), generator,
                                          device)),
        "bias": nn.Parameter(torch.zeros(out_dim, device=device))})


def embedding_params(vocab, dim, generator, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "table": nn.Parameter(uniform_05((vocab, dim), generator, device))})


def dense(p, x):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


# ----------------------------------------------------------------------- embeddings


# Below this vocab size a lookup is a one-hot product: the table's gradient
# is then a small matrix product, where indexing's is a scatter-add of
# b * l * l rows onto a handful of table rows (the edge-token table has 5).
_ONEHOT_VOCAB_MAX = 64


def token_embed(p, ids):
    """-1-masked token lookup: table[ids + 1] (-1 padding hits row 0)."""
    table = p["table"]
    idx = ids.long() + 1
    if table.shape[0] <= _ONEHOT_VOCAB_MAX:
        oh = torch.nn.functional.one_hot(idx, table.shape[0]).to(table.dtype)
        return oh @ table
    return table[idx]


def multi_token_embed(p, ids, vocab_sizes):
    """Multi-column tokens (the OGB atom and bond features): each column's
    lookup in one offset-concatenated table (row 0 the shared mask row),
    summed over the columns. A node or edge is padding when its column 0 is
    -1; its every column then takes row 0. The lookup is the rows' counts
    times the table (JAX's one-hot product, which it takes up to 64 rows
    and gathers past them; in f32 the two agree), so the table's gradient
    is a product too. A gather's backward accumulates the rows one index
    at a time: on an H100 it took 11 ms of a 215 ms EGT-Large micro-batch
    for the 175-row atom table, whose mask row every padding node hits in
    all 9 columns (PERF.md)."""
    offsets = [0]
    for s in vocab_sizes[:-1]:
        offsets.append(offsets[-1] + int(s))
    idx = ids.long() + 1 + torch.tensor(offsets, device=ids.device)
    idx = torch.where(ids[..., :1] >= 0, idx, 0)
    table = p["table"]
    counts = torch.zeros(idx.shape[:-1] + (table.shape[0],),
                         dtype=table.dtype, device=idx.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx, dtype=table.dtype))
    return counts @ table


def masked_dense_embed(p, x, mask_value: float = -1.0):
    """Keras Masking + Dense: rows whose features all equal `mask_value` are
    zeroed before the projection."""
    valid = torch.any(x != mask_value, dim=-1, keepdim=True)
    return dense(p, x * valid.to(x.dtype))


# -------------------------------------------------------------- adjacency structure


def stack_hops(adj, upto_hop: int, clip_hops: bool = True):
    """[A, clip(A@A), ...] stacked on a new trailing axis. `upto_hop == 1`
    is just A[..., None]."""
    hops = [adj]
    hop = adj
    for _ in range(upto_hop - 1):
        hop = torch.matmul(adj, hop)
        if clip_hops:
            hop = torch.clamp(hop, 0.0, 1.0)
        hops.append(hop)
    return torch.stack(hops, dim=-1)


def stack_hops_sp(adj_rows, upto_hop: int, group, clip_hops: bool = True,
                  include_xpose: bool = False, index: int = 0,
                  lq: int | None = None):
    """`stack_hops` of a row shard (`features.py:122` in JAX): each hop's
    rows need the previous hop whole, so its rows are gathered over the
    shards first. With `include_xpose` each hop's transposed rows (the
    whole hop's columns of this shard) follow the hops."""
    hops = [adj_rows]
    hops_full = []
    hop_rows = adj_rows
    for _ in range(upto_hop - 1):
        hop_full = all_gather_rows(hop_rows, group)
        hops_full.append(hop_full)
        hop_rows = torch.matmul(adj_rows, hop_full)
        if clip_hops:
            hop_rows = torch.clamp(hop_rows, 0.0, 1.0)
        hops.append(hop_rows)
    stacked = torch.stack(hops, dim=-1)
    if not include_xpose:
        return stacked
    hops_full.append(all_gather_rows(hop_rows, group))
    xpose = [hf.transpose(1, 2).narrow(1, index * lq, lq) for hf in hops_full]
    return torch.cat([stacked, torch.stack(xpose, dim=-1)], dim=-1)


def distance_targets(adj, distance_target: int):
    """k-hop reachability counts: round(sum_k clip(A^k, 0, 1)) as int64, the
    distance objective's target."""
    total = adj
    hop = adj
    for _ in range(distance_target - 1):
        hop = torch.clamp(torch.matmul(adj, hop), 0.0, 1.0)
        total = total + hop
    return torch.round(total).long()


def distance_targets_sp(adj_rows, distance_target: int, group):
    """`distance_targets` of a row shard: each hop gathered whole first,
    as in `stack_hops_sp`."""
    total = adj_rows
    hop_rows = adj_rows
    for _ in range(distance_target - 1):
        hop_full = all_gather_rows(hop_rows, group)
        hop_rows = torch.clamp(torch.matmul(adj_rows, hop_full), 0.0, 1.0)
        total = total + hop_rows
    return torch.round(total).long()


def _degree_one_hot(deg, max_degree: int):
    deg = torch.clamp(deg, max=max_degree).long()
    return torch.nn.functional.one_hot(deg, max_degree + 1).float()


def degree_encoding(adj, max_degree: int, bidir: bool):
    """(b, l, max_degree + 1) f32: the one-hot in-degree (column sums of
    the adjacency, clipped to `max_degree`), with `bidir` the one-hot
    out-degree (row sums) beside it."""
    in_oh = _degree_one_hot(torch.sum(adj, dim=1), max_degree)
    if not bidir:
        return in_oh
    return torch.cat([in_oh, _degree_one_hot(torch.sum(adj, dim=2),
                                             max_degree)], dim=-1)


def degree_encoding_sp(adj_rows, max_degree: int, bidir: bool, group):
    """`degree_encoding` from a row shard, whole on every rank: the
    in-degrees (column sums) a psum of the shards' partial sums, the
    out-degrees (row sums) gathered by rows."""
    in_oh = _degree_one_hot(psum(torch.sum(adj_rows, dim=1), group),
                            max_degree)
    if not bidir:
        return in_oh
    out_deg = all_gather_rows(torch.sum(adj_rows, dim=2), group)
    return torch.cat([in_oh, _degree_one_hot(out_deg, max_degree)], dim=-1)


def edge_diffusion(e, adj, edge_valid, steps: int):
    """The edge features `e` (b, l, l, w), zeroed on invalid pairs,
    diffused `steps` times over the column-normalised adjacency (a column
    of no edges stays 0): (b, l, l, w * steps), each step's result after
    the last."""
    den = torch.sum(adj, dim=1, keepdim=True)
    a_norm = torch.where(den > 0, adj / torch.where(den > 0, den, 1.0), 0.0)
    ed = e * edge_valid.to(e.dtype)[..., None]
    b, l, _, w = ed.shape
    outs = []
    for _ in range(steps):
        ed = torch.bmm(a_norm, ed.reshape(b, l, l * w)).reshape(b, l, l, w)
        outs.append(ed)
    return torch.cat(outs, dim=-1)


def edge_diffusion_sp(e_rows, adj_rows, edge_valid_rows, steps: int, group):
    """`edge_diffusion` of a row shard: the column normaliser a psum of
    the shards' column sums, and each step's rows gathered whole before the
    next contraction."""
    den = psum(torch.sum(adj_rows, dim=1, keepdim=True), group)
    a_norm = torch.where(den > 0, adj_rows / torch.where(den > 0, den, 1.0),
                         0.0)
    ed = e_rows * edge_valid_rows.to(e_rows.dtype)[..., None]
    outs = []
    for _ in range(steps):
        ed = torch.einsum("bij,bjkl->bikl", a_norm, all_gather_rows(ed, group))
        outs.append(ed)
    return torch.cat(outs, dim=-1)


def pairwise_add(x):
    """(b, l, 2w) -> (b, l, l, w): the row node's first half plus the
    column node's second half on every pair."""
    w = x.shape[-1] // 2
    return x[:, :, None, :w] + x[:, None, :, w:]


def pairwise_add_sp(x, index: int, lq: int):
    """`pairwise_add` for a row shard: this shard's rows' first half
    against every column's second half."""
    w = x.shape[-1] // 2
    return x[:, index * lq:(index + 1) * lq, None, :w] + x[:, None, :, w:]


def pairwise_cat(row, col):
    """PairwiseOp 'cat': (b, l, w), (b, m, w') -> (b, l, m, w + w'), the row
    node's features then the column node's on every pair."""
    b, l, w = row.shape
    m = col.shape[1]
    return torch.cat([row[:, :, None, :].expand(b, l, m, w),
                      col[:, None, :, :].expand(b, l, m, col.shape[-1])],
                     dim=-1)


# --------------------------------------------------------------------- virtual nodes


def prepend_virtual_nodes(h, vn_emb):
    """(b, l, w) -> (b, k + l, w): the k learned virtual-node rows first."""
    b = h.shape[0]
    tiled = vn_emb.to(h.dtype)[None].expand((b,) + tuple(vn_emb.shape))
    return torch.cat([tiled, h], dim=1)


def prepend_virtual_edges(e, ve_emb):
    """(b, l, l, w) -> (b, k + l, k + l, w): virtual row i's pairs take row
    embedding i, virtual column j's take embedding j, and the k x k box
    between virtual nodes 0.5 (r_i + c_j), in e's dtype."""
    b, l, _, w = e.shape
    k = ve_emb.shape[0]
    emb = ve_emb.to(e.dtype)
    emb_r, emb_c = emb[None, :, None, :], emb[None, None, :, :]
    rows = emb_r.expand(b, k, l, w)
    cols = emb_c.expand(b, l, k, w)
    box = (0.5 * (emb_r + emb_c)).expand(b, k, k, w)
    return torch.cat([torch.cat([box, cols], dim=1),
                      torch.cat([rows, e], dim=1)], dim=2)


def prepend_virtual_edges_sp(e_rows, ve_emb):
    """`prepend_virtual_edges` for a row shard (b, lq, l, w) -> (b, k + lq,
    k + l, w): every shard holds the k virtual rows whole (replicated query
    rows), then its own rows with the k virtual columns before them."""
    b, lq, l, w = e_rows.shape
    k = ve_emb.shape[0]
    emb = ve_emb.to(e_rows.dtype)
    emb_r, emb_c = emb[None, :, None, :], emb[None, None, :, :]
    box = (0.5 * (emb_r + emb_c)).expand(b, k, k, w)
    vn_rows = torch.cat([box, emb_r.expand(b, k, l, w)], dim=2)
    local = torch.cat([emb_c.expand(b, lq, k, w), e_rows], dim=2)
    return torch.cat([vn_rows, local], dim=1)


def extend_edge_mask_for_vn(edge_mask, num_virtual_nodes: int):
    """A (b, l_q, l, h) hard attention mask (l_q = l, or a shard's rows)
    with the k virtual rows and columns always on: (b, k + l_q, k + l,
    h)."""
    b, lq, l, h = edge_mask.shape
    k = num_virtual_nodes
    m = torch.cat([edge_mask.new_ones((b, k, l, h)), edge_mask], dim=1)
    return torch.cat([edge_mask.new_ones((b, lq + k, k, h)), m], dim=2)


# --------------------------------------------------------------- positional encodings


def sign_flips(seed: int, b: int, k: int, device) -> torch.Tensor:
    """(b, k) f32 of -1 or +1, each with probability 1/2, one a (graph,
    feature), keyed by `seed`."""
    zero = torch.zeros((1, 1), dtype=torch.int64, device=device)
    u = rng.uniform(seed, torch.arange(b, device=device)[:, None], zero,
                    torch.arange(k, device=device)[None, :], zero, rng.PE_FLIP)
    return torch.where(u < 0.5, -1.0, 1.0)


def _flip_seed(random_neg: bool, training: bool, seed):
    if not (random_neg and training):
        return None
    if seed is None:
        raise ValueError("random_neg requires a seed at training time")
    return seed


def process_svd(p, svd, *, sel: int, model_width: int, transform: bool,
                random_neg: bool, training: bool, seed=None):
    """Keep `sel` singular-vector pairs of `svd` (b, l, k, 2), zero-pad them
    to width/2 unless `transform`, flip each (graph, feature)'s sign at
    training time with `random_neg` (the same flip for U and V and for
    every node), flatten [U, V] on the feature axis, and with `transform`
    project through `p`."""
    v = svd[:, :, :sel, :]
    if not transform:
        pad = max(0, model_width // 2 - sel)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    seed = _flip_seed(random_neg, training, seed)
    if seed is not None:
        flips = sign_flips(seed, v.shape[0], v.shape[2], v.device)
        v = v * flips[:, None, :, None].to(v.dtype)
    flat = torch.cat([v[..., 0], v[..., 1]], dim=-1)
    if transform:
        flat = dense(p, flat)
    return flat


def process_eig(p, eig, *, sel: int, model_width: int, transform: bool,
                random_neg: bool, training: bool, seed=None):
    """The eigenvector PE: keep `sel` eigenvectors of `eig` (b, l, k), pad
    to the width unless `transform`, the training-time sign flips as
    `process_svd`'s, and with `transform` project through `p`."""
    v = eig[:, :, :sel]
    if not transform:
        pad = max(0, model_width - sel)
        v = torch.nn.functional.pad(v, (0, pad))
    seed = _flip_seed(random_neg, training, seed)
    if seed is not None:
        flips = sign_flips(seed, v.shape[0], v.shape[2], v.device)
        v = v * flips[:, None, :].to(v.dtype)
    if transform:
        v = dense(p, v)
    return v
