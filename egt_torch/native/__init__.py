"""ctypes loader and builder of the native batch assembler.

The port's own counterpart of `egt_tpu/native/__init__.py`. At first use,
`batch_builder.cpp` (next to this file) is compiled by g++ (-O3 -fopenmp)
into `build/egt_torch/batch_builder-<hash>.so` (the hash covers the source
and the flags, so an edit rebuilds), then its C entry points are bound.
Nothing is compiled at import time.

Which assembly runs is decided once per process, at the first batch, and
printed: the native library when g++ builds it, else the numpy assembly of
`data/dataset.py` (the plain version, which the tests hold the library to).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "batch_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egt_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_ll = ctypes.c_int64
_ARGTYPES = {
    "assemble_adjacency": [_i64p, _ll, _i32p, _i64p, _i64p, _ll, _f32p],
    "assemble_feature_matrix_i32": [
        _i64p, _ll, _i64p, _i64p, _i32p, _i64p, _ll, _i32p],
    "assemble_feature_matrix_f32": [
        _i64p, _ll, _i64p, _i64p, _f32p, _i64p, _ll, _ll, _f32p],
    "assemble_feature_matrix_i32_multi": [
        _i64p, _ll, _i64p, _i64p, _i32p, _i64p, _ll, _ll, _i32p],
    "assemble_edge_targets": [
        _i64p, _ll, _i64p, _i64p, _i32p, _i64p, _ll, _i32p],
}

_lock = threading.Lock()
_decided = False
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"batch_builder-{digest[:16]}.so"


def _build_and_load():
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def available() -> bool:
    """Whether this process assembles batches natively (decided, and
    printed, at the first call)."""
    global _decided, _lib
    with _lock:
        if not _decided:
            try:
                _lib = _build_and_load()
                print(f"batch assembly: native ({_lib._name}, OpenMP)",
                      flush=True)
            except (OSError, subprocess.SubprocessError) as exc:
                detail = getattr(exc, "stderr", None) or exc
                print(f"batch assembly: numpy (the native builder did not "
                      f"build: {detail})", flush=True)
            _decided = True
    return _lib is not None


def assemble_adjacency(sel, num_nodes, edges_flat, edges_off, L, adj_out):
    _lib.assemble_adjacency(
        np.ascontiguousarray(sel, np.int64), len(sel),
        np.ascontiguousarray(num_nodes, np.int32),
        np.ascontiguousarray(edges_flat, np.int64),
        np.ascontiguousarray(edges_off, np.int64), L, adj_out)


def assemble_feature_matrix_i32(sel, edges_flat, edges_off, feat_flat, feat_off,
                                L, fm_out):
    _lib.assemble_feature_matrix_i32(
        np.ascontiguousarray(sel, np.int64), len(sel),
        np.ascontiguousarray(edges_flat, np.int64),
        np.ascontiguousarray(edges_off, np.int64),
        np.ascontiguousarray(feat_flat, np.int32),
        np.ascontiguousarray(feat_off, np.int64), L, fm_out)


def assemble_feature_matrix_f32(sel, edges_flat, edges_off, feat_flat, feat_off,
                                F, L, fm_out):
    _lib.assemble_feature_matrix_f32(
        np.ascontiguousarray(sel, np.int64), len(sel),
        np.ascontiguousarray(edges_flat, np.int64),
        np.ascontiguousarray(edges_off, np.int64),
        np.ascontiguousarray(feat_flat, np.float32),
        np.ascontiguousarray(feat_off, np.int64), F, L, fm_out)


def assemble_feature_matrix_i32_multi(sel, edges_flat, edges_off, feat_flat,
                                      feat_off, F, L, fm_out):
    _lib.assemble_feature_matrix_i32_multi(
        np.ascontiguousarray(sel, np.int64), len(sel),
        np.ascontiguousarray(edges_flat, np.int64),
        np.ascontiguousarray(edges_off, np.int64),
        np.ascontiguousarray(feat_flat, np.int32),
        np.ascontiguousarray(feat_off, np.int64), F, L, fm_out)


def assemble_edge_targets(sel, edges_flat, edges_off, labels_flat, labels_off,
                          L, tgt_out):
    _lib.assemble_edge_targets(
        np.ascontiguousarray(sel, np.int64), len(sel),
        np.ascontiguousarray(edges_flat, np.int64),
        np.ascontiguousarray(edges_off, np.int64),
        np.ascontiguousarray(labels_flat, np.int32),
        np.ascontiguousarray(labels_off, np.int64), L, tgt_out)
