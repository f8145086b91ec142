"""Seeded stand-ins for trained weights and for ZINC, PATTERN and CLUSTER
graphs, for runs on a machine that holds neither (the chip smoke test and
the serving and training profiles).

`random_flat_params` draws a {JAX flat name: array} dict, the form a JAX
`saved/*.npz` snapshot takes, so loading it exercises the weight transfer.
`zinc_batch` draws ZINC-shaped graphs in the JAX batch format: 9-38 atoms
padded to 40, atom tokens 0-27, bond tokens 0-3 on a spanning tree plus a few
ring closures (symmetric), -1 padding, a self-looped uint8 adjacency, and a
standard-normal f32 regression `target (b, 1)`. `zinc_records` draws the
same molecules as records of a dataset split (the form of
`data/hdf5_io.write_records`), each bond in both directions, with the
learnable target n/10 + mean(token)/30 of `tests/synth.py::make_zinc_like`.

`sbm_records` and `sbm_batch` draw the two stochastic-block-model datasets
as Dwivedi et al., *Benchmarking Graph Neural Networks* (JMLR 2023),
describe them. PATTERN: 5 communities of 5-35 nodes each, edge probability
0.5 within a community and 0.35 across; node tokens uniform in {0, 1, 2}; a
planted 20-node pattern (0.5 within it, 0.5 to the rest) whose nodes carry
label 1; 44-188 nodes. CLUSTER: 6 communities of 5-35 nodes, 0.55 within and
0.25 across; one node a community carries its community's label + 1 as its
token, every other node 0; the label of a node is its community; 40-190
nodes. A graph whose node count falls outside the published range is drawn
again. Nodes come in a random order; edges are listed in both directions.
"""

from __future__ import annotations

import numpy as np

from .models.graph_model import EGTGraphModel, GraphModelConfig
from .weights import flat_names


def random_flat_params(cfg: GraphModelConfig, seed: int = 0) -> dict:
    shapes = {k: tuple(p.shape) for k, p in
              flat_names(EGTGraphModel(cfg, device="cpu")).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in sorted(shapes.items()):
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            lim = (6.0 / (shape[-2] + shape[-1])) ** 0.5
            x = rng.uniform(-lim, lim, shape)
        elif leaf == "table":
            x = rng.uniform(-0.05, 0.05, shape)
        elif leaf == "gamma":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            x = 0.1 * rng.normal(size=shape)
        flat[name] = x.astype(np.float32)
    return flat


def _zinc_graph(rng: np.random.Generator, min_nodes: int, max_nodes: int):
    """One molecule: n atoms, their tokens, and its bonds as (s, t, token)
    in draw order (a later bond of the same pair overwrites an earlier)."""
    n = int(rng.integers(min_nodes, max_nodes + 1))
    tokens = rng.integers(0, 28, n)
    src = list(range(1, n)) + list(rng.integers(0, n, n // 8))
    dst = [int(rng.integers(0, s)) for s in range(1, n)] + \
        list(rng.integers(0, n, n // 8))
    bonds = [(s, t, rng.integers(0, 4)) for s, t in zip(src, dst) if s != t]
    return n, tokens, bonds


def zinc_batch(rng: np.random.Generator, b: int, pad: int = 40,
               min_nodes: int = 9, max_nodes: int = 38) -> dict:
    nf = np.full((b, pad), -1, np.int8)
    fm = np.full((b, pad, pad), -1, np.int8)
    adj = np.zeros((b, pad, pad), np.uint8)
    for i in range(b):
        n, tokens, bonds = _zinc_graph(rng, min_nodes, max_nodes)
        nf[i, :n] = tokens
        for s, t, bond in bonds:
            fm[i, s, t] = fm[i, t, s] = bond
            adj[i, s, t] = adj[i, t, s] = 1
        adj[i, np.arange(n), np.arange(n)] = 1
    target = rng.normal(size=(b, 1)).astype(np.float32)
    return {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj,
            "target": target}


def zinc_records(rng: np.random.Generator, count: int, min_nodes: int = 9,
                 max_nodes: int = 38) -> list[dict]:
    records = []
    for _ in range(count):
        n, tokens, bonds = _zinc_graph(rng, min_nodes, max_nodes)
        pairs = {}
        for s, t, bond in bonds:
            pairs[(min(s, t), max(s, t))] = bond
        edges = list(pairs) + [(t, s) for s, t in pairs]
        records.append(dict(
            num_nodes=n,
            edges=np.asarray(edges, np.int64).reshape(-1, 2),
            node_features=tokens.astype(np.int64),
            edge_features=np.asarray(list(pairs.values()) * 2, np.int64),
            value=np.asarray([n / 10 + tokens.mean() / 30], np.float32)))
    return records


# Dwivedi et al. (JMLR 2023), the SBM datasets: communities, edge
# probabilities within / across communities, the published node-count range
SBM = {"pattern": dict(communities=5, p=0.5, q=0.35, nodes=(44, 188)),
       "cluster": dict(communities=6, p=0.55, q=0.25, nodes=(40, 190))}
PATTERN_NODES, PATTERN_P, PATTERN_Q = 20, 0.5, 0.5


def _sbm_graph(rng: np.random.Generator, kind: str, lo: int, hi: int):
    """One SBM graph of `kind` with lo <= n <= hi nodes: (n, edges (E, 2)
    in both directions, tokens, labels)."""
    s = SBM[kind]
    lo, hi = max(lo, s["nodes"][0]), min(hi, s["nodes"][1])
    extra = PATTERN_NODES if kind == "pattern" else 0
    while True:
        sizes = rng.integers(5, 36, s["communities"])
        n = int(sizes.sum()) + extra
        if lo <= n <= hi:
            break
    comm = np.repeat(np.arange(s["communities"]), sizes)
    same = comm[:, None] == comm[None, :]
    prob = np.where(same, s["p"], s["q"])
    if kind == "pattern":
        m = n - extra
        full = np.full((n, n), PATTERN_Q)
        full[:m, :m] = prob
        full[m:, m:] = PATTERN_P
        prob = full
        tokens = rng.integers(0, 3, n)
        labels = (np.arange(n) >= m).astype(np.int64)
    else:
        labels = comm.astype(np.int64)
        tokens = np.zeros(n, np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        tokens[starts + rng.integers(0, sizes)] = np.arange(1, len(sizes) + 1)
    src, dst = np.nonzero(np.triu(rng.random((n, n)) < prob, 1))
    order = rng.permutation(n)              # node i of the draw is order[i]
    src, dst = order[src], order[dst]
    inv = np.argsort(order)
    edges = np.concatenate([np.stack([src, dst], 1), np.stack([dst, src], 1)])
    return n, edges.astype(np.int64), tokens[inv], labels[inv]


def sbm_records(rng: np.random.Generator, count: int, kind: str) -> list[dict]:
    """`count` graphs of PATTERN or CLUSTER (`kind`) as records of a dataset
    split (the form of `data/hdf5_io.write_records`)."""
    records = []
    for _ in range(count):
        n, edges, tokens, labels = _sbm_graph(rng, kind, 0, 1 << 30)
        records.append(dict(num_nodes=n, edges=edges, node_features=tokens,
                            node_labels=labels))
    return records


def sbm_batch(rng: np.random.Generator, b: int, pad: int, kind: str,
              above: int = 0) -> dict:
    """A batch of `b` PATTERN or CLUSTER graphs of more than `above` and at
    most `pad` nodes (a length bucket), in the reader's batch format: node
    tokens (b, pad) int8 with -1 padding, a self-looped uint8 adjacency and
    the node labels `target` (b, pad) int32, 0 on padding."""
    nf = np.full((b, pad), -1, np.int8)
    adj = np.zeros((b, pad, pad), np.uint8)
    target = np.zeros((b, pad), np.int32)
    for i in range(b):
        n, edges, tokens, labels = _sbm_graph(rng, kind, above + 1, pad)
        nf[i, :n] = tokens
        adj[i, edges[:, 0], edges[:, 1]] = 1
        adj[i, np.arange(n), np.arange(n)] = 1
        target[i, :n] = labels
    return {"node_features": nf, "graph_matrix": adj, "target": target}
