"""The benchmark's traffic: seeded graph corpora and requests, made by one
generator from the parameters in a cell's file.

Frozen copies of the program's synthetic PCQM4Mv2 and SBM generators
(`pcqm_records`, `sbm_records`), with two changes: every graph's node
count comes from a fixed list that the seed only permutes, so every seed
gives the same sizes and pads in another order; and the PCQM4Mv2 target's
shortest paths are a breadth-first search in numpy (with the tree drawn
in plain Python), which makes a molecule about 0.4 ms instead of 2.2 ms
on the build host's CPU.

PCQM4Mv2 (OGB-LSC, Hu et al. 2021): a molecule of n heavy atoms is a random
tree (each atom bonded to an earlier one with a spare bond) plus up to
n / 3 chords, degree at most 4; 9 atom token columns within the OGB atom
vocabulary (column 0 the atomic number from a 36-entry organic head, tied
to the degree; column 3 the degree), 3 bond token columns (the same both
ways), and a structural target on the scale of the dataset's HOMO-LUMO gap
(mean 5.68 eV, sd 1.16), far from an untrained model's outputs as the real
targets are. PATTERN (Dwivedi et al., JMLR 2023): 5
communities of 5-35 nodes (edge probability 0.5 within, 0.35 across) and
a planted 20-node pattern (0.5 within it and to the rest) whose nodes
carry label 1; node tokens uniform in {0, 1, 2}; nodes in random order.
"""

from __future__ import annotations

import numpy as np

OGB_ATOM_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
OGB_BOND_DIMS = (5, 6, 2)
ATOM_HEAD = 36
# the structural target is mapped onto the scale of PCQM4Mv2's HOMO-LUMO
# gap (eV): its own mean and sd over these molecules to the dataset's
T_MEAN, T_SD = 0.58, 0.24
GAP_MEAN, GAP_SD = 5.68, 1.16
# the target's pair and bond-type terms: fixed tables, whatever the seed
_TERMS = np.random.default_rng(54321)
_T = _TERMS.normal(0, 0.5, size=(ATOM_HEAD, ATOM_HEAD))
_T = (_T + _T.T) / 2.0
_B = _TERMS.normal(0, 0.5, size=(OGB_BOND_DIMS[0],))

PATTERN = dict(communities=5, p=0.5, q=0.35, lo=5, hi=35, planted=20,
               planted_p=0.5, planted_q=0.5)


def sizes(groups, rng: np.random.Generator) -> np.ndarray:
    """Node counts: for each [count, lo, hi] group, `count` values spread
    evenly from lo to hi (both included), all groups permuted by `rng`."""
    out = np.concatenate([np.rint(np.linspace(lo, hi, count)).astype(np.int64)
                          for count, lo, hi in groups])
    return out[rng.permutation(len(out))]


def _molecule(rng: np.random.Generator, n: int, max_degree: int = 4):
    deg = [0] * n
    edges = []
    pick = rng.random(n).tolist()
    for v in range(1, n):
        cands = [u for u in range(v) if deg[u] < max_degree]
        u = cands[int(pick[v] * len(cands))] if cands else int(pick[v] * v)
        edges.append((u, v))
        deg[u] += 1
        deg[v] += 1
    have = set(edges)
    chords = int(rng.integers(0, max(2, n // 3)))
    for u, v in rng.integers(0, n, size=(chords, 2)).tolist():
        u, v = min(u, v), max(u, v)
        if u == v or (u, v) in have or deg[u] >= max_degree \
                or deg[v] >= max_degree:
            continue
        edges.append((u, v))
        have.add((u, v))
        deg[u] += 1
        deg[v] += 1
    return np.array(edges, np.int64), np.array(deg, np.int64)


def _mean_path(a: np.ndarray) -> float:
    """Mean shortest-path length over ordered pairs (self pairs, 0,
    included) of a connected graph's adjacency, by breadth-first search."""
    n = len(a)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n)
    total, k = 0, 0
    while True:
        k += 1
        frontier = ((frontier @ a) > 0) & ~reach
        found = int(frontier.sum())
        if not found:
            break
        total += k * found
        reach |= frontier
        frontier = frontier.astype(np.float64)
    return total / float(reach.sum())


def _target(n, und, z, bond) -> float:
    a = np.zeros((n, n))
    a[und[:, 0], und[:, 1]] = 1.0
    a = a + a.T
    tri = np.trace(a @ a @ a) / 6.0
    u, v = und[:, 0], und[:, 1]
    t = (float(_T[z[u], z[v]].mean()) + 0.25 * _mean_path(a)
         + tri / n + 0.5 * float(_B[bond].mean()))
    return GAP_MEAN + GAP_SD * (t - T_MEAN) / T_SD


def pcqm_records(rng: np.random.Generator, counts) -> list[dict]:
    """One PCQM4Mv2-like molecule record per node count in `counts`."""
    atom, bond_dims = OGB_ATOM_DIMS, OGB_BOND_DIMS
    records = []
    for n in counts:
        n = int(n)
        und, deg = _molecule(rng, n)
        z = ((deg * 5 + rng.integers(0, 9, size=n)) % ATOM_HEAD).astype(np.int64)
        nodef = np.empty((n, len(atom)), np.int64)
        nodef[:, 0] = z
        nodef[:, 3] = np.minimum(deg, atom[3] - 1)
        for ci in (1, 2, 4, 5, 6, 7, 8):
            nodef[:, ci] = rng.integers(0, atom[ci], size=n)
        ne = len(und)
        bond = rng.integers(0, bond_dims[0], size=ne)
        edgef = np.empty((2 * ne, len(bond_dims)), np.int64)
        edgef[:, 0] = np.concatenate([bond, bond])
        for ci in (1, 2):
            col = rng.integers(0, bond_dims[ci], size=ne)
            edgef[:, ci] = np.concatenate([col, col])
        records.append(dict(
            num_nodes=n, edges=np.concatenate([und, und[:, ::-1]]),
            node_features=nodef, edge_features=edgef,
            value=np.array([_target(n, und, z, bond)], np.float32)))
    return records


def _community_sizes(rng, total: int, parts: int, lo: int, hi: int):
    """`parts` community sizes in [lo, hi] summing to `total`: uniform
    draws, then single nodes moved in or out of random communities."""
    s = rng.integers(lo, hi + 1, parts)
    while s.sum() != total:
        i = int(rng.integers(0, parts))
        if s.sum() < total and s[i] < hi:
            s[i] += 1
        elif s.sum() > total and s[i] > lo:
            s[i] -= 1
    return s


def pattern_records(rng: np.random.Generator, counts) -> list[dict]:
    """One PATTERN graph record per node count in `counts` (45-195)."""
    P = PATTERN
    records = []
    for n in counts:
        n = int(n)
        m = n - P["planted"]
        cs = _community_sizes(rng, m, P["communities"], P["lo"], P["hi"])
        comm = np.repeat(np.arange(P["communities"]), cs)
        prob = np.full((n, n), P["planted_q"])
        prob[:m, :m] = np.where(comm[:, None] == comm[None, :], P["p"], P["q"])
        prob[m:, m:] = P["planted_p"]
        tokens = rng.integers(0, 3, n)
        labels = (np.arange(n) >= m).astype(np.int64)
        src, dst = np.nonzero(np.triu(rng.random((n, n)) < prob, 1))
        order = rng.permutation(n)
        src, dst = order[src], order[dst]
        inv = np.argsort(order)
        edges = np.concatenate([np.stack([src, dst], 1),
                                np.stack([dst, src], 1)]).astype(np.int64)
        records.append(dict(num_nodes=n, edges=edges,
                            node_features=tokens[inv],
                            node_labels=labels[inv]))
    return records


GENERATORS = {"pcqm": pcqm_records, "pattern": pattern_records}


def records(kind: str, groups, rng: np.random.Generator) -> list[dict]:
    return GENERATORS[kind](rng, sizes(groups, rng))
