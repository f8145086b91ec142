"""Seeded stand-ins for trained weights and ZINC batches, for runs on a
machine that holds neither (the chip smoke test and the serving and
training profiles).

`random_flat_params` draws a {JAX flat name: array} dict, the form a JAX
`saved/*.npz` snapshot takes, so loading it exercises the weight transfer.
`zinc_batch` draws ZINC-shaped graphs in the JAX batch format: 9-38 atoms
padded to 40, atom tokens 0-27, bond tokens 0-3 on a spanning tree plus a few
ring closures (symmetric), -1 padding, a self-looped uint8 adjacency, and a
standard-normal f32 regression `target (b, 1)`. `zinc_records` draws the
same molecules as records of a dataset split (the form of
`data/hdf5_io.write_records`), each bond in both directions, with the
learnable target n/10 + mean(token)/30 of `tests/synth.py::make_zinc_like`.
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
