"""Datasets: a one-time host-side preprocessing cache per split, and
fixed-shape padded batches.

The port's own copy of `egt_tpu/data/dataset.py`. Each split is preprocessed
once into a ragged numpy cache (`<cache_dir>/<split>_<tag>.npz`, the same
format and file names as the JAX package's, so either package reads the
other's cache), and batches are assembled as fixed-shape padded numpy arrays:
the pad length is the declared `max_length`, or the max observed across the
cached splits rounded up, or one of the `buckets`.

A cache is built from the HDF5 file (h5py is imported only then), or written
directly from records with `GraphDataset.write_cache` on a machine without
h5py. Every batch carries ``sample_mask`` (b,) marking real vs. padding
graphs: the final partial batch is padded to the full batch size, so
evaluation covers every record at one shape. The dense scatters run in the
native assembler (`egt_torch/native`) when it builds, else in numpy here (the
plain version).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import graph_ops
from . import hdf5_io
from .. import native

# the target's key in a record of `hdf5_io.write_records`, per target kind
TARGET_KEYS = {"graph_value": "value", "graph_label": "label",
               "node_labels": "node_labels", "edge_matrix": "edge_labels"}


@dataclass
class DatasetSpec:
    """Schema + preprocessing recipe for one benchmark dataset."""

    name: str                       # HDF5 top-level group, e.g. 'ZINC'
    node_feat_kind: str             # 'int' | 'float'
    node_feat_dim: int | None       # None for 1-D int token arrays
    edge_feat_kind: str | None      # 'int' | 'float' | None
    edge_feat_dim: int | None
    target_kind: str                # 'graph_value'|'graph_label'|'node_labels'|'edge_matrix'
    max_length: int | None          # fixed pad length; None -> derived from data
    mask_value: float = -1.0

    @property
    def has_edge_features(self) -> bool:
        return self.edge_feat_kind is not None

    def record_keys(self):
        keys = [("data", "num_nodes"), "data/edges", "data/features/nodes/feat"]
        names = ["num_nodes", "edges", "node_features"]
        if self.has_edge_features:
            keys.append("data/features/edges/feat")
            names.append("edge_features")
        keys.append("targets/" + TARGET_KEYS[self.target_kind])
        names.append("target")
        return names, keys


class RaggedField:
    """Variable-length per-record arrays stored as (flat, offsets)."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets

    def __getitem__(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i]: self.offsets[i + 1]]

    def __len__(self):
        return len(self.offsets) - 1

    @classmethod
    def from_list(cls, arrays: list[np.ndarray]) -> "RaggedField":
        offsets = np.zeros(len(arrays) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in arrays], out=offsets[1:])
        flat = (np.concatenate(arrays, axis=0) if arrays
                else np.zeros((0,), dtype=np.float32))
        return cls(flat, offsets)


class GraphDataset:
    """One dataset + positional-encoding configuration, cached per split."""

    def __init__(
        self,
        spec: DatasetSpec,
        dataset_path: str,
        cache_dir: str,
        splits=("training", "validation"),
        pe: str | None = None,            # None | 'svd' | 'eig'
        num_features: int = 16,           # PE feature count
        eig_sparse: bool = True,
        mult_sing_vals: bool = True,
        norm_for_svd: bool = False,
        norm_sym_for_svd: bool = False,
    ):
        self.spec = spec
        self.dataset_path = dataset_path
        self.cache_dir = Path(cache_dir)
        self.splits = list(splits)
        self.pe = pe
        self.num_features = num_features
        self.eig_sparse = eig_sparse
        self.mult_sing_vals = mult_sing_vals
        self.norm_for_svd = norm_for_svd
        self.norm_sym_for_svd = norm_sym_for_svd
        self._cache: dict[str, dict] = {}

    # -------------------------------------------------------------------- caching

    def _cache_path(self, split: str) -> Path:
        tag = f"{self.pe or 'raw'}_{self.num_features}" if self.pe else "raw"
        return self.cache_dir / f"{split}_{tag}.npz"

    def ensure_cache(self, split: str) -> dict:
        if split in self._cache:
            return self._cache[split]
        path = self._cache_path(split)
        if path.exists():
            data = dict(np.load(path, allow_pickle=False))
        else:
            data = self._build_cache(split)
            self._save_cache(path, data)
        self._cache[split] = data
        # a newly-loaded split can raise the max token id, so any previous
        # int8-narrowing decision must be re-derived over all loaded splits
        self._token_max_cache = None
        return data

    def _save_cache(self, path: Path, data: dict) -> None:
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        # one temporary file a process: the ranks of a parallel run build
        # the same cache at once
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **data)
        os.replace(tmp, path)

    def write_cache(self, split: str, records: list[dict]) -> None:
        """Build and write a split's cache from records in the form of
        `hdf5_io.write_records` (num_nodes, edges, node_features,
        edge_features and the target under its schema key), without an HDF5
        file. The cache equals the one built from those records written to
        HDF5."""
        names, _ = self.spec.record_keys()
        tkey = TARGET_KEYS[self.spec.target_kind]
        data = self._cache_from_records(
            [{n: rec[tkey if n == "target" else n] for n in names}
             for rec in records])
        self._save_cache(self._cache_path(split), data)
        self._cache.pop(split, None)
        self._token_max_cache = None

    def _build_cache(self, split: str) -> dict:
        import h5py

        names, keys = self.spec.record_keys()
        with h5py.File(self.dataset_path, "r") as f:
            records = [dict(zip(names, hdf5_io.read_record(f, tok, keys)))
                       for tok in hdf5_io.get_tokens(f, self.spec.name, split)]
        return self._cache_from_records(records)

    def _cache_from_records(self, records: list[dict]) -> dict:
        """Ragged cache arrays of records keyed by `spec.record_keys` names."""
        spec = self.spec
        names, _ = spec.record_keys()
        out_lists: dict[str, list] = {n: [] for n in names}
        pe_list: list[np.ndarray] = []
        for rec in records:
            n = int(rec["num_nodes"])
            edges = np.asarray(rec["edges"], dtype=np.int64).reshape(-1, 2)
            rec = {**rec, "edges": edges}
            for name in names:
                out_lists[name].append(np.asarray(rec[name]))
            if self.pe == "svd":
                adj = graph_ops.adjacency_matrix(edges, n)
                pe_list.append(graph_ops.svd_features(
                    adj, self.num_features,
                    mult_sing_vals=self.mult_sing_vals,
                    norm_first=self.norm_for_svd,
                    norm_symmetric=self.norm_sym_for_svd))
            elif self.pe == "eig":
                pe_list.append(graph_ops.eigen_features(
                    edges, n, self.num_features, sparse=self.eig_sparse))

        data: dict[str, np.ndarray] = {}
        data["num_nodes"] = np.asarray(out_lists["num_nodes"], dtype=np.int32)
        for name in names:
            if name == "num_nodes":
                continue
            arrays = [np.atleast_1d(a) for a in out_lists[name]]
            if name == "target" and spec.target_kind == "graph_value":
                data["target"] = np.stack(
                    [a.reshape(-1) for a in arrays]).astype(np.float32)
                continue
            if name == "target" and spec.target_kind == "graph_label":
                data["target"] = np.asarray(
                    [a.reshape(-1)[0] for a in arrays], dtype=np.int32)
                continue
            rf = RaggedField.from_list(arrays)
            data[f"{name}_flat"] = rf.flat
            data[f"{name}_off"] = rf.offsets
        if self.pe is not None:
            rf = RaggedField.from_list(pe_list)
            data["pe_flat"] = rf.flat
            data["pe_off"] = rf.offsets
        return data

    # ------------------------------------------------------------------- batching

    def num_records(self, split: str) -> int:
        return len(self.ensure_cache(split)["num_nodes"])

    def pad_length(self, splits=None) -> int:
        """Static pad length: the declared max_length, else the max node count over
        the given splits rounded up to a multiple of 8."""
        if self.spec.max_length is not None:
            return self.spec.max_length
        mx = 0
        for s in splits or self.splits:
            mx = max(mx, int(self.ensure_cache(s)["num_nodes"].max()))
        return int(np.ceil(mx / 8) * 8)

    def batches(self, split: str, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, pad_len: int | None = None,
                drop_remainder: bool = False, epoch: int = 0,
                buckets=None):
        """Yield dicts of fixed-shape numpy arrays (see `_build_batch`).

        With `buckets` (ascending pad lengths), each record goes to the smallest
        bucket that fits it and batches are formed per bucket: one batch shape a
        bucket instead of everything padded to the global max (the fixed-shape
        answer to the reference's per-batch dynamic `padded_batch`,
        `dataset_base.py:100-111`). Bucket batches are interleaved
        pseudo-randomly when shuffling. The shuffle draws from
        `default_rng(SeedSequence([seed, epoch]))`, as the JAX package does, so
        both packages see the same order.
        """
        data = self.ensure_cache(split)
        n = len(data["num_nodes"])
        idx = np.arange(n)
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        if shuffle:
            rng.shuffle(idx)

        if buckets is None:
            if pad_len is None:
                pad_len = self.pad_length()
            for start in range(0, n, batch_size):
                sel = idx[start: start + batch_size]
                if len(sel) < batch_size and drop_remainder:
                    return
                yield self._build_batch(data, sel, batch_size, pad_len)
            return

        # clip to what the data actually needs: drop buckets above the split's
        # max graph size and cap the largest at that max (rounded to 8) —
        # scheme-default buckets sized for the real
        # datasets then do no harm on small fixtures
        max_needed = int(data["num_nodes"].max())
        max_pad = min(max(buckets), -(-max_needed // 8) * 8)
        buckets = sorted(b for b in buckets if b < max_pad) + [max_pad]
        if buckets[-1] < max_needed:
            raise ValueError(f"largest bucket {buckets[-1]} < max graph size "
                             f"{max_needed}")
        sizes = data["num_nodes"][idx]
        assignment = np.searchsorted(np.asarray(buckets), sizes, side="left")
        chunks = []
        for bi, blen in enumerate(buckets):
            bidx = idx[assignment == bi]
            for start in range(0, len(bidx), batch_size):
                sel = bidx[start: start + batch_size]
                if len(sel) < batch_size and drop_remainder:
                    continue
                chunks.append((blen, sel))
        if shuffle:
            rng.shuffle(chunks)
        for blen, sel in chunks:
            yield self._build_batch(data, sel, batch_size, blen)

    def _build_batch(self, data: dict, sel: np.ndarray, batch_size: int,
                     pad_len: int) -> dict:
        spec = self.spec
        b, L = batch_size, pad_len
        nb = len(sel)
        num_nodes = data["num_nodes"][sel]

        def ragged(name, i):
            off = data[f"{name}_off"]
            return data[f"{name}_flat"][off[i]: off[i + 1]]

        batch: dict[str, np.ndarray] = {
            "num_nodes": np.zeros((b,), np.int32),
            "sample_mask": np.zeros((b,), np.float32),
        }
        batch["num_nodes"][:nb] = num_nodes
        batch["sample_mask"][:nb] = 1.0

        # node features (int may be (l,) tokens or (l, C) multi-column tokens)
        if spec.node_feat_kind == "int":
            shape = (b, L) if spec.node_feat_dim is None \
                else (b, L, spec.node_feat_dim)
            nf = np.full(shape, -1, np.int32)
        else:
            nf = np.full((b, L, spec.node_feat_dim), spec.mask_value, np.float32)
        # graph matrix
        gm = np.zeros((b, L, L), np.float32)
        # edge features
        fm = None
        if spec.has_edge_features:
            if spec.edge_feat_kind == "int":
                shape = (b, L, L) if spec.edge_feat_dim is None \
                    else (b, L, L, spec.edge_feat_dim)
                fm = np.full(shape, -1, np.int32)
            else:
                fm = np.full((b, L, L, spec.edge_feat_dim), spec.mask_value,
                             np.float32)
        # targets
        if spec.target_kind == "graph_value":
            tgt = np.zeros((b, data["target"].shape[1]), np.float32)
            tgt[:nb] = data["target"][sel]
        elif spec.target_kind == "graph_label":
            tgt = np.zeros((b,), np.int32)
            tgt[:nb] = data["target"][sel]
        elif spec.target_kind == "node_labels":
            tgt = np.zeros((b, L), np.int32)
        else:  # edge_matrix
            tgt = np.zeros((b, L, L), np.int32)

        pe_out = None
        if self.pe == "svd":
            pe_out = np.zeros((b, L, self.num_features, 2), np.float32)
        elif self.pe == "eig":
            pe_out = np.zeros((b, L, self.num_features), np.float32)

        use_native = native.available() and nb > 0
        if use_native:
            # C++ assembler (egt_torch/native): all O(B*E) dense scatters in
            # one OpenMP pass; semantics identical to the numpy path below
            native.assemble_adjacency(sel, data["num_nodes"],
                                      data["edges_flat"], data["edges_off"],
                                      L, gm)
            if fm is not None:
                if spec.edge_feat_kind == "int" \
                        and spec.edge_feat_dim is not None:
                    # multi-column tokens (PCQM4Mv2 bond features, (E, F) int)
                    native.assemble_feature_matrix_i32_multi(
                        sel, data["edges_flat"], data["edges_off"],
                        data["edge_features_flat"].reshape(
                            -1, spec.edge_feat_dim),
                        data["edge_features_off"], spec.edge_feat_dim, L, fm)
                elif spec.edge_feat_kind == "int":
                    native.assemble_feature_matrix_i32(
                        sel, data["edges_flat"], data["edges_off"],
                        data["edge_features_flat"], data["edge_features_off"],
                        L, fm)
                else:
                    F = spec.edge_feat_dim
                    native.assemble_feature_matrix_f32(
                        sel, data["edges_flat"], data["edges_off"],
                        data["edge_features_flat"].reshape(-1, F),
                        data["edge_features_off"], F, L, fm)
            if spec.target_kind == "edge_matrix":
                native.assemble_edge_targets(
                    sel, data["edges_flat"], data["edges_off"],
                    data["target_flat"], data["target_off"], L, tgt)

        for j, i in enumerate(sel):
            n = int(num_nodes[j])
            nodes = ragged("node_features", i)
            if spec.node_feat_kind == "int" and spec.node_feat_dim is None:
                nf[j, :n] = nodes
            else:
                nf[j, :n] = nodes.reshape(n, spec.node_feat_dim)

            if not use_native:
                edges = ragged("edges", i).reshape(-1, 2)
                gm[j] = graph_ops.adjacency_matrix(edges, n, out_len=L)
                if fm is not None:
                    ef = ragged("edge_features", i)
                    if spec.edge_feat_kind == "int":
                        if spec.edge_feat_dim is not None:
                            ef = ef.reshape(-1, spec.edge_feat_dim)
                        fm[j] = graph_ops.feature_matrix(
                            edges, n, ef.astype(np.int32), out_len=L,
                            dtype=np.int32)
                    else:
                        fm[j] = graph_ops.feature_matrix(
                            edges, n, ef.reshape(-1, spec.edge_feat_dim),
                            out_len=L)
                if spec.target_kind == "edge_matrix":
                    labels = ragged("target", i).astype(np.int32)
                    np.add.at(tgt[j], (edges[:, 0], edges[:, 1]), labels)

            if spec.target_kind == "node_labels":
                tgt[j, :n] = ragged("target", i)

            if pe_out is not None:
                pe = ragged("pe", i)
                if self.pe == "svd":
                    pe_out[j, :n] = pe.reshape(n, self.num_features, 2)
                else:
                    pe_out[j, :n] = pe.reshape(n, self.num_features)

        batch["node_features"] = nf
        batch["graph_matrix"] = gm
        if fm is not None:
            batch["feature_matrix"] = fm
        if self.pe == "svd":
            batch["singular_vectors"] = pe_out
        elif self.pe == "eig":
            batch["eigen_vectors"] = pe_out
        batch["target"] = tgt
        return self._compress(batch)

    def _compress(self, batch: dict) -> dict:
        """Losslessly narrow the wire dtypes of the big per-pair fields: the
        adjacency is small-integer-valued (0/1 edges + self-loops) and token ids
        fit int8 for these vocabularies, so host->device transfers shrink ~4x on
        the dominant (b, L, L) tensors; the model upcasts on the card."""
        spec = self.spec
        out = dict(batch)
        out["graph_matrix"] = batch["graph_matrix"].astype(np.uint8)
        if spec.node_feat_kind == "int" and spec.node_feat_dim is None \
                and self._int8_ok("node"):
            nf = batch["node_features"]
            assert nf.size == 0 or nf.max() < 127, "int8 narrowing bound"
            out["node_features"] = nf.astype(np.int8)
        if spec.edge_feat_kind == "int" and spec.edge_feat_dim is None \
                and self._int8_ok("edge"):
            fm = batch["feature_matrix"]
            assert fm.size == 0 or fm.max() < 127, "int8 narrowing bound"
            out["feature_matrix"] = fm.astype(np.int8)
        if spec.target_kind == "edge_matrix":
            out["target"] = batch["target"].astype(np.int8)
        return out

    def _int8_ok(self, which: str) -> bool:
        mx = self._token_max(which)
        return mx is not None and mx < 127

    def _token_max(self, which: str):
        """Max token id over the splits loaded so far: forcing every split
        (incl. test) to load at first training batch would front-load minutes
        of featurization. `ensure_cache` invalidates this memo whenever a new
        split loads, so the int8-ok decision is re-derived (a flip merely
        changes the wire dtype, which the device upcasts anyway; `_compress`
        additionally hard-asserts the <127 bound per narrowed batch)."""
        cache = getattr(self, "_token_max_cache", None)
        if cache is None:
            cache = self._token_max_cache = {}
        if which not in cache:
            key = "node_features_flat" if which == "node" \
                else "edge_features_flat"
            loaded = [s for s in self.splits if s in self._cache]
            if not loaded:
                return None  # nothing cached yet; decide later
            mx = 0
            for s in loaded:
                data = self._cache[s]
                if key not in data:
                    cache[which] = None
                    return None
                if len(data[key]):
                    mx = max(mx, int(data[key].max()))
            cache[which] = mx
        return cache[which]
