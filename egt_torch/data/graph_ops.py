"""Host-side (numpy/scipy) graph preprocessing.

The port's own copy of `egt_tpu/data/graph_ops.py`. All preprocessing runs
offline in numpy/scipy and is cached once per split (see `dataset.py`), so
the card sees only ready-made dense arrays. Semantics match the reference
(`lib/data/graph.py`, `lib/data/svd.py`, `lib/data/eigen_gt.py`):

  * dense matrices are built by scatter-add (duplicate edges sum), with optional
    self-loops added as extra identity edges (`graph.py:4-40`),
  * edge-feature matrices use the +-1 shift so that "no edge" (-1) is distinguishable
    from a real feature value of 0 (`graph.py:80-106`),
  * SVD features: full SVD of the (self-looped) adjacency, top-k singular triplets,
    U and V scaled by sqrt(S), stacked to (n, k, 2) (`svd.py:7-72`),
  * eigen features: normalized-Laplacian eigenvectors, smallest-real first, the trivial
    first vector dropped (`eigen_gt.py:6-71`).

The cache builder computes the SVD and eigen features for the schemes that
ask; the model reads them as `singular_vectors` and `eigen_vectors`.
"""

from __future__ import annotations

import numpy as np


def scatter_matrix(edges: np.ndarray, num_nodes: int, values: np.ndarray | None = None,
                   out_len: int | None = None, fill=0.0, feature_dims: tuple = (),
                   dtype=np.float32) -> np.ndarray:
    """Scatter-add `values` at `edges` into a dense (out_len, out_len, *feature_dims)
    matrix initialized to `fill`. Cells never touched keep `fill`; touched cells hold
    fill + sum(values)."""
    n = num_nodes if out_len is None else out_len
    mat = np.full((n, n) + tuple(feature_dims), fill, dtype=dtype)
    if len(edges):
        if values is None:
            values = np.ones((len(edges),), dtype=dtype)
        np.add.at(mat, (edges[:, 0], edges[:, 1]), values.astype(dtype))
    return mat


def adjacency_matrix(edges: np.ndarray, num_nodes: int, out_len: int | None = None,
                     add_self_loops: bool = True, normalize: bool = False,
                     symmetric: bool = False) -> np.ndarray:
    """Dense adjacency padded to `out_len` (`graph.py:57-66`). Self-loops are appended
    as extra edges (so an explicit self-edge in the data yields a diagonal value 2)."""
    a = scatter_matrix(edges, num_nodes, out_len=out_len)
    if add_self_loops:
        idx = np.arange(num_nodes)
        a[idx, idx] += 1.0
    if normalize:
        a = normalize_adjacency(a, symmetric=symmetric)
    return a


def normalize_adjacency(a: np.ndarray, symmetric: bool = False) -> np.ndarray:
    d = a.sum(axis=1, keepdims=True)
    if not symmetric:
        return np.divide(a, d, out=np.zeros_like(a), where=d != 0)
    d_mh = np.divide(1.0, np.sqrt(d), out=np.zeros_like(d), where=d != 0)
    return d_mh * a * d_mh.T


def feature_matrix(edges: np.ndarray, num_nodes: int, features: np.ndarray,
                   out_len: int | None = None, mark_invalid: bool = True,
                   dtype=None) -> np.ndarray:
    """Edge features -> dense matrix with the +-1 invalid-cell trick
    (`graph.py:80-106` with increment_by_1=decrement_by_1=True): real cells hold the
    feature value, all other cells (incl. padding) hold -1."""
    features = np.asarray(features)
    dtype = dtype or features.dtype
    fdims = features.shape[1:]
    if mark_invalid:
        return scatter_matrix(edges, num_nodes, features + 1, out_len=out_len,
                              fill=-1.0, feature_dims=fdims, dtype=dtype)
    return scatter_matrix(edges, num_nodes, features, out_len=out_len,
                          fill=0.0, feature_dims=fdims, dtype=dtype)


def svd_features(a: np.ndarray, num_features: int, mult_sing_vals: bool = True,
                 norm_first: bool = False, norm_symmetric: bool = False) -> np.ndarray:
    """Top-`num_features` SVD positional encodings of a dense matrix -> (n, k, 2).

    Matches `SVDFeatures` (`svd.py:43-79`): optional row/symmetric normalization first,
    sqrt-singular-value scaling, [U, V] stacked on the last axis, zero-padded to k when
    the graph has fewer than k nodes.
    """
    if norm_first:
        a = normalize_adjacency(a, symmetric=norm_symmetric)
    u, s, vh = np.linalg.svd(a.astype(np.float64))
    v = vh.T
    n = a.shape[0]
    k = num_features
    u, s, v = u[:, :k], s[:k], v[:, :k]
    if mult_sing_vals:
        scale = np.sqrt(s)
        u = u * scale
        v = v * scale
    out = np.zeros((n, k, 2), dtype=np.float32)
    kk = min(k, n)
    out[:, :kk, 0] = u[:, :kk]
    out[:, :kk, 1] = v[:, :kk]
    return out


def eigen_features(edges: np.ndarray, num_nodes: int, pos_enc_dim: int,
                   sparse: bool = True) -> np.ndarray:
    """Laplacian-eigenvector positional encodings -> (n, pos_enc_dim).

    Matches `eigen_pe_sp` / `eigen_pe_np` (`eigen_gt.py:6-71`): normalized Laplacian
    L = I - D^-1/2 A D^-1/2 built from the raw edge list (no self-loops), eigenvectors
    sorted by (real) eigenvalue ascending, first (trivial) one dropped, real parts kept.
    Columns beyond what the graph supports are zero.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg  # noqa: F401  (binds sp.linalg)

    rows, cols = edges[:, 0], edges[:, 1]
    data = np.ones(len(rows), dtype="float32")
    a = sp.csr_matrix((data, (rows, cols)), shape=(num_nodes, num_nodes),
                      dtype="float32")
    deg = np.asarray(a.sum(axis=1)).squeeze(-1)
    n_mh = sp.diags(np.clip(deg, 1, None) ** -0.5, dtype=float)
    lap = sp.eye(num_nodes) - n_mh * a * n_mh

    out = np.zeros((num_nodes, pos_enc_dim), dtype=np.float32)
    if sparse and num_nodes > pos_enc_dim + 2:
        try:
            eigval, eigvec = sp.linalg.eigs(lap, k=pos_enc_dim + 1, which="SR",
                                            tol=1e-2)
        except Exception:
            eigval, eigvec = np.linalg.eig(lap.toarray())
    else:
        eigval, eigvec = np.linalg.eig(lap.toarray())
    eigvec = np.real(eigvec[:, np.argsort(eigval)])
    pe = eigvec[:, 1: pos_enc_dim + 1].astype(np.float32)
    out[:, : pe.shape[1]] = pe
    return out


def laplacian_matrix(edges: np.ndarray, num_nodes: int,
                     add_self_loops: bool = True) -> np.ndarray:
    """Dense normalized Laplacian (`graph.py:69-77`)."""
    a = adjacency_matrix(edges, num_nodes, add_self_loops=add_self_loops,
                         normalize=True, symmetric=True)
    return np.eye(num_nodes, dtype=np.float32) - a
