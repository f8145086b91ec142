"""Padded batches of graph records, and the order a shuffled epoch takes.

A record holds `num_nodes`, `edges` (E, 2) in both directions,
`node_features` ((n,) tokens or (n, c) token columns), optionally
`edge_features` ((E, c) token columns) and a target (`value` (1,) or
`node_labels` (n,)). A batch pads every graph to the pad length l: node
tokens -1 past a graph's nodes, the adjacency with a self-loop on each
node (uint8), edge tokens -1 where there is no edge, the graph target
(b, 1) f32 or the node labels (b, l) int32 (0 past the nodes), and
`sample_mask` (b,) f32, 1 for the batch's real graphs.

An epoch's order is the one the run's reader uses for a shuffled split:
the records permuted by `default_rng(SeedSequence([seed, epoch]))`; with
length buckets each record goes to the smallest bucket that holds it (the
largest cut to the split's largest graph rounded up to 8), the batches are
cut bucket by bucket, and the same generator then permutes the batches.
"""

from __future__ import annotations

import numpy as np


def collate(records: list[dict], batch_size: int, pad: int) -> dict:
    b, n_real = batch_size, len(records)
    first = records[0]
    nf0 = np.asarray(first["node_features"])
    cols = nf0.shape[1:] if nf0.ndim > 1 else ()
    nf = np.full((b, pad) + tuple(cols), -1, np.int32)
    gm = np.zeros((b, pad, pad), np.uint8)
    fm = None
    if "edge_features" in first:
        ec = np.asarray(first["edge_features"]).shape[1:]
        fm = np.full((b, pad, pad) + tuple(ec), -1, np.int32)
    graph_target = "value" in first
    tgt = (np.zeros((b, 1), np.float32) if graph_target
           else np.zeros((b, pad), np.int32))
    sm = np.zeros((b,), np.float32)
    sm[:n_real] = 1.0
    num = np.zeros((b,), np.int32)
    for j, rec in enumerate(records):
        n = int(rec["num_nodes"])
        num[j] = n
        nf[j, :n] = rec["node_features"]
        ed = np.asarray(rec["edges"]).reshape(-1, 2)
        gm[j, ed[:, 0], ed[:, 1]] += 1
        gm[j, np.arange(n), np.arange(n)] += 1
        if fm is not None:
            fm[j, ed[:, 0], ed[:, 1]] = rec["edge_features"]
        if graph_target:
            tgt[j] = rec["value"]
        else:
            tgt[j, :n] = rec["node_labels"]
    out = {"num_nodes": num, "sample_mask": sm, "node_features": nf,
           "graph_matrix": gm, "target": tgt}
    if fm is not None:
        out["feature_matrix"] = fm
    if not cols:
        out["node_features"] = nf.astype(np.int8)
    return out


def epoch_batches(num_nodes: np.ndarray, batch_size: int, seed: int,
                  epoch: int, pad: int, buckets=None) -> list:
    """[(pad, record indices)] of one shuffled epoch, in order."""
    n = len(num_nodes)
    idx = np.arange(n)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    rng.shuffle(idx)
    if buckets is None:
        return [(pad, idx[s:s + batch_size]) for s in range(0, n, batch_size)]
    need = int(num_nodes.max())
    top = min(max(buckets), -(-need // 8) * 8)
    buckets = sorted(x for x in buckets if x < top) + [top]
    assign = np.searchsorted(np.asarray(buckets), num_nodes[idx], side="left")
    chunks = []
    for bi, blen in enumerate(buckets):
        bidx = idx[assign == bi]
        for s in range(0, len(bidx), batch_size):
            chunks.append((blen, bidx[s:s + batch_size]))
    rng.shuffle(chunks)
    return chunks


def pad_length(num_nodes: np.ndarray) -> int:
    """The pad of a split without buckets: its largest graph rounded up
    to a multiple of 8."""
    return int(-(-int(num_nodes.max()) // 8) * 8)
