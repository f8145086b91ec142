"""HDF5 dataset reading and writing for the benchmark-graph schema.

The port's own copy of `egt_tpu/data/hdf5_io.py`. The on-disk schema is the
one of the reference's `lib/data/reader.py:11-65`:

    /<DSNAME>/<split>/<%010d>/data            (group; attrs: num_nodes, num_edges)
    /<DSNAME>/<split>/<%010d>/data/edges      (E, 2) int
    /<DSNAME>/<split>/<%010d>/data/features/nodes/feat
    /<DSNAME>/<split>/<%010d>/data/features/edges/feat
    /<DSNAME>/<split>/<%010d>/targets/{value|label|node_labels|edge_labels}

Reading happens host-side, once, while a split's cache is built
(`dataset.py`), never in the training loop. h5py is imported inside the
functions that open a file, so the rest of the package imports without it:
a machine without h5py starts from the per-split cache instead
(`dataset.write_cache`).
"""

from __future__ import annotations

import numpy as np


def get_tokens(db_file, db_name: str, split: str) -> list[str]:
    grp = db_file[db_name][split]
    prefix = f"/{db_name}/{split}/"
    return [prefix + t for t in grp]


def get_meta(db_file, db_name: str) -> dict:
    return dict(db_file[db_name].attrs.items())


def read_record(db_file, token: str, keys: list) -> tuple:
    """Read one record; a key may be a dataset path or a (path, attr) tuple."""
    grp = db_file[token]
    out = []
    for key in keys:
        if isinstance(key, tuple):
            out.append(grp[key[0]].attrs[key[1]])
        else:
            out.append(grp[key][()])
    return tuple(out)


def write_records(path: str, db_name: str, split: str, records: list[dict],
                  meta: dict | None = None) -> None:
    """Write records in the reference schema. Each record dict may contain:
    num_nodes, edges, node_features, edge_features, and one of the target keys
    ('value' | 'label' | 'node_labels' | 'edge_labels')."""
    import h5py

    with h5py.File(path, "a") as f:
        root = f.require_group(db_name)
        if meta:
            for k, v in meta.items():
                root.attrs[k] = v
        sgrp = root.require_group(split)
        for i, rec in enumerate(records):
            g = sgrp.require_group(f"{i:010d}")
            d = g.require_group("data")
            d.attrs["num_nodes"] = np.int64(rec["num_nodes"])
            d.attrs["num_edges"] = np.int64(len(rec["edges"]))
            d.create_dataset("edges", data=np.asarray(rec["edges"], dtype=np.int64))
            feats = d.require_group("features")
            if "node_features" in rec:
                feats.require_group("nodes").create_dataset(
                    "feat", data=np.asarray(rec["node_features"]))
            if "edge_features" in rec:
                feats.require_group("edges").create_dataset(
                    "feat", data=np.asarray(rec["edge_features"]))
            t = g.require_group("targets")
            for tk in ("value", "label", "node_labels", "edge_labels"):
                if tk in rec:
                    t.create_dataset(tk, data=np.asarray(rec[tk]))
