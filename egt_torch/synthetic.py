"""Seeded stand-ins for trained weights and for ZINC, PATTERN, CLUSTER,
MNIST, CIFAR10, TSP and PCQM4Mv2 graphs, for runs on a machine that holds
neither (the chip smoke test and the serving and training profiles).

`random_flat_params` draws a {JAX flat name: array} dict, the form a JAX
`saved/*.npz` snapshot takes, so loading it exercises the weight transfer.
`zinc_batch` draws ZINC-shaped graphs in the JAX batch format: 9-38 atoms
padded to 40, atom tokens 0-27, bond tokens 0-3 on a spanning tree plus a few
ring closures (symmetric), -1 padding, a self-looped uint8 adjacency, and a
standard-normal f32 regression `target (b, 1)`. `zinc_records` draws the
same molecules as records of a dataset split (the form of
`data/hdf5_io.write_records`), each bond in both directions, with the
learnable target n/10 + mean(token)/30 of `tests/synth.py::make_zinc_like`;
they serve ZINC-full as well, which shares ZINC's tokens, atom range and
schema (its splits are larger).

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

`superpixel_records` and `superpixel_batch` draw the two superpixel
datasets as Dwivedi et al. build them from MNIST and CIFAR10 images: a
node a superpixel, at its centroid in the unit square, with its mean
intensity (MNIST; RGB for CIFAR10) and (x, y) as features; 40-75 nodes
(MNIST) or 85-150 (CIFAR10); each node's edges to its k = 8 nearest
centroids, an edge's feature the Gaussian kernel exp(-(d / sigma)^2) of
the centroid distance d, sigma a node's mean distance to those 8; a label
0-9. Here the image is a blob around a point of the label's own, so the
label can be learned from the intensities. The batches carry the SVD (or
eigenvector) PE the reader's cache would hold (`data/graph_ops.py`);
`add_pe` gives any of these batches the PE of its adjacency.

`tsp_records` and `tsp_batch` draw TSP graphs as Dwivedi et al. build them
(benchmarking-gnns `data/TSP.py`): 50-500 points uniform in the unit
square with (x, y) as node features, each node's edges to its k = 25
nearest points with the Euclidean length as the edge feature, and label 1
on the edges of a tour. The benchmark's tours come from Concorde; here the
tour is a deterministic function of the points, the nearest-neighbour tour
from point 0 improved by 2-opt until no exchange shortens it. Only the
k-nearest-neighbour edges are kept, as in the benchmark, so a tour edge
outside them carries no label.

`pcqm_records` and `pcqm_batch` draw PCQM4Mv2-like molecules in the schema
of the OGB converter (`tools/convert_pcqm4mv2.py`), as `tools/synth_pcqm.py`
draws them (the port keeps its own copy): a random tree plus chords,
degree at most 4, 4-32 heavy atoms (or up to `max_nodes`), 9 atom and 3
bond columns within the OGB vocabularies, and a structural target (pair
terms of the bonded atoms' numbers, path lengths, triangles, bond types)
in place of the HOMO-LUMO gap, whose data needs OGB's download.
"""

from __future__ import annotations

import numpy as np

from .data import datasets as D
from .data import graph_ops
from .data.dataset import GraphDataset
from .models.graph_model import EGTGraphModel, GraphModelConfig
from .weights import flat_names


def random_flat_params(cfg: GraphModelConfig, seed: int = 0) -> dict:
    shapes = {k: tuple(p.shape) for k, p in
              flat_names(EGTGraphModel(cfg, device="cpu")).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in sorted(shapes.items()):
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "kernel":
            lim = (6.0 / (shape[-2] + shape[-1])) ** 0.5
            x = rng.uniform(-lim, lim, shape)
        elif leaf in ("table", "virtual_node_embeddings",
                      "virtual_edge_embeddings"):
            x = rng.uniform(-0.05, 0.05, shape)
        elif leaf == "gamma":
            x = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf == "moving_var":
            x = rng.uniform(0.5, 1.5, shape)
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


# Dwivedi et al. (JMLR 2023), the superpixel datasets: the reader's spec,
# the node-count range, the intensity channels
SUPERPIXEL = {"mnist": dict(spec=D.MNIST, nodes=(40, 75), channels=1),
              "cifar10": dict(spec=D.CIFAR10, nodes=(85, 150), channels=3)}
SUPERPIXEL_K = 8
# a point of the unit square a label, around which its images are bright
_CLASS_CENTRES = np.random.default_rng(1234).uniform(0.2, 0.8, (10, 2))


def _superpixel_graph(rng: np.random.Generator, kind: str):
    """One image's superpixel graph: (n, edges (E, 2), node features (n,
    channels + 2), edge features (E, 1), label)."""
    s = SUPERPIXEL[kind]
    n = int(rng.integers(s["nodes"][0], s["nodes"][1] + 1))
    label = int(rng.integers(0, 10))
    xy = rng.uniform(0.0, 1.0, (n, 2))
    blob = np.exp(-np.sum((xy - _CLASS_CENTRES[label]) ** 2, -1) / 0.05)
    colour = rng.uniform(0.5, 1.0, s["channels"])
    inten = np.clip(blob[:, None] * colour
                    + 0.1 * rng.normal(size=(n, s["channels"])), 0.0, 1.0)
    d = np.sqrt(np.sum((xy[:, None] - xy[None]) ** 2, -1))
    np.fill_diagonal(d, np.inf)
    nbr = np.argsort(d, axis=1)[:, :SUPERPIXEL_K]
    dn = np.take_along_axis(d, nbr, axis=1)
    sigma = dn.mean(axis=1, keepdims=True) + 1e-8
    src = np.repeat(np.arange(n), SUPERPIXEL_K)
    edges = np.stack([src, nbr.reshape(-1)], 1).astype(np.int64)
    feat = np.exp(-(dn / sigma) ** 2).reshape(-1, 1)
    nodes = np.concatenate([inten, xy], axis=1)
    return n, edges, nodes.astype(np.float32), feat.astype(np.float32), label


def superpixel_records(rng: np.random.Generator, count: int,
                       kind: str) -> list[dict]:
    """`count` MNIST or CIFAR10 (`kind`) superpixel graphs as records of a
    dataset split (the form of `data/hdf5_io.write_records`)."""
    records = []
    for _ in range(count):
        n, edges, nodes, feat, label = _superpixel_graph(rng, kind)
        records.append(dict(num_nodes=n, edges=edges, node_features=nodes,
                            edge_features=feat, label=label))
    return records


def superpixel_batch(rng: np.random.Generator, b: int, kind: str,
                     pe: str = "svd", num_features: int = 16) -> dict:
    """A batch of `b` MNIST or CIFAR10 superpixel graphs as the reader
    builds it from its cache: node_features (b, pad, f) and
    feature_matrix (b, pad, pad, 1) f32 with -1 padding, a self-looped
    uint8 adjacency, the PE (`singular_vectors` (b, pad, k, 2) or
    `eigen_vectors` (b, pad, k)), the labels `target` (b,) int32 and
    `sample_mask`; pad 75 (MNIST) or 150 (CIFAR10)."""
    spec = SUPERPIXEL[kind]["spec"]
    ds = GraphDataset(spec, "", "", pe=pe, num_features=num_features)
    data = ds._cache_from_records(
        [{**r, "target": r["label"]} for r in superpixel_records(rng, b, kind)])
    return ds._build_batch(data, np.arange(b), b, spec.max_length)


def add_pe(batch: dict, pe: str, num_features: int) -> dict:
    """`batch` with the positional encoding the reader's cache would give
    it (`data/dataset.py`), computed from its self-looped `graph_matrix`
    (one self-loop on every real node): `singular_vectors` (b, pad, k, 2)
    of the adjacency (`pe` "svd") or `eigen_vectors` (b, pad, k) of the
    Laplacian of its edges without the self-loops ("eig", by the dense
    solver, so that a seed gives the same batch every run), zero on
    padding."""
    adj = np.asarray(batch["graph_matrix"], np.float32)
    b, pad = adj.shape[:2]
    shape = (num_features, 2) if pe == "svd" else (num_features,)
    out = np.zeros((b, pad) + shape, np.float32)
    for i in range(b):
        n = int(np.count_nonzero(np.diagonal(adj[i])))
        a = adj[i, :n, :n]
        if pe == "svd":
            out[i, :n] = graph_ops.svd_features(a, num_features)
        else:
            off = a - np.eye(n, dtype=np.float32)
            out[i, :n] = graph_ops.eigen_features(
                np.argwhere(off > 0).astype(np.int64), n, num_features,
                sparse=False)
    key = "singular_vectors" if pe == "svd" else "eigen_vectors"
    return {**batch, key: out}


# Dwivedi et al. (JMLR 2023), TSP: the node-count range, the neighbours a node
TSP_NODES, TSP_K = (50, 500), 25


def _two_opt(d: np.ndarray, tour: np.ndarray) -> np.ndarray:
    """`tour` improved by 2-opt exchanges until none shortens it. Each round
    takes, for every tour position i, the exchange of edges (i, i + 1) and
    (j, j + 1) that gains most, and applies the best of them whose
    reversed segments do not overlap (those exchanges are independent)."""
    n = len(tour)
    nxt = np.roll(np.arange(n), -1)
    while True:
        p = d[np.ix_(tour, tour)]                 # distances in tour order
        a = p[np.arange(n), nxt]                  # edge i -> i + 1
        gain = np.triu(a[:, None] + a[None, :] - p - p[np.ix_(nxt, nxt)], 2)
        gain[0, n - 1] = 0.0                      # the same two edges
        best_j = gain.argmax(1)
        best = gain[np.arange(n), best_j]
        cand = np.nonzero(best > 1e-12)[0]
        if not len(cand):
            return tour
        busy = np.zeros(n + 1, bool)
        tour = tour.copy()
        for i in cand[np.argsort(-best[cand], kind="stable")]:
            j = best_j[i]
            if busy[i:j + 2].any():
                continue
            busy[i:j + 2] = True
            tour[i + 1:j + 1] = tour[i + 1:j + 1][::-1].copy()


def _tsp_graph(rng: np.random.Generator, lo: int, hi: int):
    """One TSP graph with lo <= n <= hi points: (n, edges (n k, 2), node
    features (n, 2), edge features (n k, 1), edge labels (n k,))."""
    n = int(rng.integers(max(lo, TSP_NODES[0]), min(hi, TSP_NODES[1]) + 1))
    xy = rng.uniform(0.0, 1.0, (n, 2))
    d = np.sqrt(np.sum((xy[:, None] - xy[None]) ** 2, -1))
    visited = np.zeros(n, bool)
    visited[0] = True
    tour = [0]
    for _ in range(n - 1):
        j = int(np.where(visited, np.inf, d[tour[-1]]).argmin())
        tour.append(j)
        visited[j] = True
    tour = _two_opt(d, np.asarray(tour))
    on_tour = np.zeros((n, n), bool)
    on_tour[tour, np.roll(tour, -1)] = True
    on_tour |= on_tour.T
    dn = d + np.diag(np.full(n, np.inf))
    nbr = np.argsort(dn, axis=1, kind="stable")[:, :TSP_K]
    src = np.repeat(np.arange(n), TSP_K)
    dst = nbr.reshape(-1)
    edges = np.stack([src, dst], 1).astype(np.int64)
    return (n, edges, xy.astype(np.float32),
            d[src, dst].astype(np.float32)[:, None],
            on_tour[src, dst].astype(np.int64))


def tsp_records(rng: np.random.Generator, count: int, lo: int = 0,
                hi: int = 1 << 30) -> list[dict]:
    """`count` TSP graphs (of lo to hi points, within the published 50-500)
    as records of a dataset split (the form of
    `data/hdf5_io.write_records`)."""
    records = []
    for _ in range(count):
        n, edges, nodes, feat, labels = _tsp_graph(rng, lo, hi)
        records.append(dict(num_nodes=n, edges=edges, node_features=nodes,
                            edge_features=feat, edge_labels=labels))
    return records


def tsp_batch(rng: np.random.Generator, b: int, pad: int, above: int = 0,
              pe: str | None = None, num_features: int = 16) -> dict:
    """A batch of `b` TSP graphs of more than `above` and at most `pad`
    points (a length bucket) as the reader builds it: node_features (b,
    pad, 2) and feature_matrix (b, pad, pad, 1) f32 with -1 padding, a
    self-looped uint8 adjacency of the neighbour edges, the edge labels
    `target` (b, pad, pad) int8, `sample_mask`, and with `pe` "svd" the
    `singular_vectors` (b, pad, k, 2) of the reader's SVD cache."""
    ds = GraphDataset(D.TSP, "", "", pe=pe, num_features=num_features)
    data = ds._cache_from_records(
        [{**r, "target": r["edge_labels"]}
         for r in tsp_records(rng, b, above + 1, pad)])
    return ds._build_batch(data, np.arange(b), b, pad)


# PCQM4Mv2 (OGB-LSC): 4-32 heavy atoms in the synthetic corpus (the
# dataset's mean is about 14); column 0 of an atom, its atomic number, from
# the organic head of the 119-entry vocabulary
PCQM_NODES, PCQM_ATOM_HEAD = (4, 32), 36
# the target's pair and bond-type terms: fixed tables, whatever the seed
_PCQM_TERMS = np.random.default_rng(54321)
_PCQM_T = _PCQM_TERMS.normal(0, 0.5, size=(PCQM_ATOM_HEAD, PCQM_ATOM_HEAD))
_PCQM_T = (_PCQM_T + _PCQM_T.T) / 2.0
_PCQM_B = _PCQM_TERMS.normal(0, 0.5, size=(D.OGB_BOND_DIMS[0],))


def _molecular_graph(rng: np.random.Generator, n_min: int, n_max: int,
                     max_degree: int = 4):
    """A random connected sparse graph: a random tree (each node attached
    to an earlier one with a spare bond) plus up to n / 3 chords, every
    degree at most `max_degree`. (n, edges (E, 2) in both directions,
    degrees)."""
    n = int(rng.integers(n_min, n_max + 1))
    deg = np.zeros(n, np.int64)
    edges = []
    for v in range(1, n):
        cands = np.flatnonzero(deg[:v] < max_degree)
        u = int(rng.choice(cands)) if len(cands) else int(rng.integers(0, v))
        edges.append((u, v))
        deg[u] += 1
        deg[v] += 1
    have = set(edges)
    for _ in range(int(rng.integers(0, max(2, n // 3)))):
        u, v = rng.integers(0, n, size=2)
        u, v = int(min(u, v)), int(max(u, v))
        if u == v or (u, v) in have or deg[u] >= max_degree \
                or deg[v] >= max_degree:
            continue
        edges.append((u, v))
        have.add((u, v))
        deg[u] += 1
        deg[v] += 1
    e = np.array(edges, np.int64)
    return n, np.concatenate([e, e[:, ::-1]], axis=0), deg


def _pcqm_target(n, edges_undir, z, bond) -> float:
    """The structural target: the mean pair term of the bonded atoms'
    numbers, a quarter of the mean shortest-path length, the triangles a
    node and half the mean bond-type term."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    u, v = edges_undir[:, 0], edges_undir[:, 1]
    adj = csr_matrix((np.ones(len(u)), (u, v)), shape=(n, n))
    adj = adj + adj.T
    sp = shortest_path(adj, method="D", unweighted=True)
    a = (adj > 0).astype(np.int64).toarray()
    tri = np.trace(a @ a @ a) / 6.0
    return (float(_PCQM_T[z[u], z[v]].mean())
            + 0.25 * float(sp[np.isfinite(sp)].mean()) + tri / n
            + 0.5 * float(_PCQM_B[bond].mean()))


def pcqm_records(rng: np.random.Generator, count: int,
                 max_nodes: int = PCQM_NODES[1]) -> list[dict]:
    """`count` PCQM4Mv2-like molecules of 4 to `max_nodes` heavy atoms as
    records of a dataset split (the form of `data/hdf5_io.write_records`,
    the schema of the OGB converter): a tree plus chords of degree at most
    4; 9 int atom columns within `OGB_ATOM_DIMS` (column 0 the atomic
    number from the 36-entry organic head, tied to the degree; column 3 the
    degree; the others uniform) and 3 int bond columns within
    `OGB_BOND_DIMS` (uniform, the same both ways); the structural target
    of `_pcqm_target` as `value`."""
    atom, bond_dims = D.OGB_ATOM_DIMS, D.OGB_BOND_DIMS
    records = []
    for _ in range(count):
        n, edges, deg = _molecular_graph(rng, PCQM_NODES[0], max_nodes)
        z = ((deg * 5 + rng.integers(0, 9, size=n)) % PCQM_ATOM_HEAD
             ).astype(np.int64)
        nodef = np.empty((n, len(atom)), np.int64)
        nodef[:, 0] = z
        nodef[:, 3] = np.minimum(deg, atom[3] - 1)
        for ci in (1, 2, 4, 5, 6, 7, 8):
            nodef[:, ci] = rng.integers(0, atom[ci], size=n)
        ne2 = len(edges) // 2
        bond = rng.integers(0, bond_dims[0], size=ne2)
        edgef = np.empty((2 * ne2, len(bond_dims)), np.int64)
        edgef[:, 0] = np.concatenate([bond, bond])
        for ci in (1, 2):
            col = rng.integers(0, bond_dims[ci], size=ne2)
            edgef[:, ci] = np.concatenate([col, col])
        records.append(dict(
            num_nodes=n, edges=edges, node_features=nodef,
            edge_features=edgef,
            value=np.array([_pcqm_target(n, edges[:ne2], z, bond)],
                           np.float32)))
    return records


def pcqm_batch(rng: np.random.Generator, b: int,
               max_nodes: int = PCQM_NODES[1]) -> dict:
    """A batch of `b` molecules of `pcqm_records` as the reader builds it,
    padded as the reader pads PCQM4Mv2 (the largest molecule of 4 to
    `max_nodes` atoms, rounded up to 8: 32 by default): node_features (b,
    pad, 9) and feature_matrix (b, pad, pad, 3) int32 with -1 padding, a
    self-looped uint8 adjacency, the targets (b, 1) f32 and
    `sample_mask`."""
    ds = GraphDataset(D.PCQM4MV2, "", "")
    data = ds._cache_from_records(
        [{**r, "target": r["value"]} for r in pcqm_records(rng, b, max_nodes)])
    return ds._build_batch(data, np.arange(b), b, -(-max_nodes // 8) * 8)
