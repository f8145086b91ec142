"""Build and bind the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exports a plain C function that returns
`cudaGetLastError()`. It is compiled by `nvcc` into
`build/egt_torch/<name>-<hash>.so` at first use (the hash covers the source,
the shared `csrc/*.cuh` headers and the flags, so an edit rebuilds) and loaded
with `ctypes`. Nothing here runs at import time: this module is imported on
machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "egt_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = (_CSRC / f"{source}.cu").read_bytes()
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source}-{digest[:16]}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (process, tmp, out) or None if the
    library for the current source hash already exists."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(source: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(sources) -> dict[str, str]:
    """Build every source that is missing, all nvcc processes at once.
    Returns {source: compiler log} for the sources built now."""
    jobs = {s: _start_build(s) for s in sources}
    return {s: _finish_build(s, job) for s, job in jobs.items()
            if job is not None}


class CudaKernel:
    """One exported C entry point of a `csrc/*.cu` file: `entry`, by default
    the function named as the file.

    `launches` counts the launches made through `__call__` (and nowhere
    else), so a run can show that its main path went through the kernel."""

    def __init__(self, source: str, argtypes: list, entry: str | None = None):
        self.source = source
        self.entry = entry or source
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None

    def _library(self):
        if self._lib is None:
            job = _start_build(self.source)
            if job is not None:
                _finish_build(self.source, job)
            self._lib = ctypes.CDLL(str(library_path(self.source)))
        return self._lib

    def _load(self):
        if self._fn is None:
            fn = getattr(self._library(), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def query(self, symbol: str, spec: str, *args) -> int:
        """Call a helper `long long symbol(...)` of the same library (for
        example the shared memory a shape needs); not a launch."""
        fn = getattr(self._library(), symbol)
        fn.argtypes = [_ARG[c] for c in spec.replace(" ", "")]
        fn.restype = ctypes.c_longlong
        return int(fn(*args))

    def __call__(self, *args) -> None:
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.entry}: CUDA error {rc} at launch")
        self.launches += 1


def dispatch(plain, cuda):
    """Make the decorated stub (its signature and docstring) the public form
    of a kernel: `plain` when the first tensor argument lies on the CPU, else
    `cuda`, which launches the kernel or raises (no fallback from a CUDA
    tensor)."""
    def wrap(stub):
        @functools.wraps(stub)
        def fn(*args, **kwargs):
            t = next(a for a in args if isinstance(a, torch.Tensor))
            return (plain if t.device.type == "cpu" else cuda)(*args, **kwargs)
        return fn
    return wrap


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(name: str, t: torch.Tensor, shape: tuple, dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this shape and dtype."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


_ARG = dict(p=ctypes.c_void_p, i=ctypes.c_int, f=ctypes.c_float,
            u=ctypes.c_uint32, L=ctypes.c_longlong)


def argtypes(spec: str) -> list:
    """'ppi f' -> [c_void_p, c_void_p, c_int, c_float]: pointers (p), ints
    (i), unsigned 32-bit ints (u), long longs (L) and floats (f) of a C entry
    point, in order; the trailing stream pointer is appended."""
    return [_ARG[c] for c in spec.replace(" ", "")] + [ctypes.c_void_p]
