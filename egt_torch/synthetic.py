"""Seeded stand-ins for trained weights and ZINC batches, for runs on a
machine that holds neither (the chip smoke test and the serving profile).

`random_flat_params` draws a {JAX flat name: array} dict, the form a JAX
`saved/*.npz` snapshot takes, so loading it exercises the weight transfer.
`zinc_batch` draws ZINC-shaped graphs in the JAX batch format: 9-38 atoms
padded to 40, atom tokens 0-27, bond tokens 0-3 on a spanning tree plus a few
ring closures (symmetric), -1 padding, a self-looped uint8 adjacency.
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


def zinc_batch(rng: np.random.Generator, b: int, pad: int = 40,
               min_nodes: int = 9, max_nodes: int = 38) -> dict:
    nf = np.full((b, pad), -1, np.int8)
    fm = np.full((b, pad, pad), -1, np.int8)
    adj = np.zeros((b, pad, pad), np.uint8)
    for i in range(b):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        nf[i, :n] = rng.integers(0, 28, n)
        src = list(range(1, n)) + list(rng.integers(0, n, n // 8))
        dst = [int(rng.integers(0, s)) for s in range(1, n)] + \
            list(rng.integers(0, n, n // 8))
        for s, t in zip(src, dst):
            if s != t:
                fm[i, s, t] = fm[i, t, s] = rng.integers(0, 4)
                adj[i, s, t] = adj[i, t, s] = 1
        adj[i, np.arange(n), np.arange(n)] = 1
    return {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}
