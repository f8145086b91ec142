#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`egt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure makes the exit code non-zero and suppresses the
final result line):
  1. host record: `nvidia-smi` name and power limit, torch and CUDA versions,
     `nvcc --version`;
  2. build both CUDA kernels from `egt_torch/csrc` (one nvcc each, in
     parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     ZINC-500k serving shapes in f32 and bf16 with ragged node masks, plus one
     awkward shape; errors, kernel / plain times (CUDA events, median of 30
     launches with L2 flushed before each) and the reckoned bound;
  4. path A: `load_predictor` on configs/main/zinc/500k/egt.json with seeded
     weights under the JAX names answers 4 requests of 128 synthetic
     ZINC-shaped graphs through the whole-layer kernel (10 launches a
     request), checked against the model's plain path;
  5. path B: the same with use_pallas true, use_pallas_layer false (the
     attention kernel, 10 launches a request);
  6. one JSON line listing every kernel with its launches on the main paths;
  7. last line: {"ok": true, "device": {...}}.
Exits non-zero without a result when no CUDA device is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "main" / "zinc" / "500k" / "egt.json"
N_REQUESTS, GRAPHS, PAD = 4, 128, 40

# published dense peaks (NVIDIA data sheets): memory B/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores; matched on the device name
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),          # SXM
    "H200": (4.8e12, 989e12, 67e12),
}

# kernel-vs-plain tolerances: f32 sums are taken in another order (1e-4);
# bf16 is compared in the working type, where that order can flip one
# rounding of an intermediate: about two bf16 ulps of the output
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}   # (atol, rtol)
# whole-model agreement of a kernel path with the plain model path on the
# card, on predictions of magnitude ~1: f32 differs only by summation order;
# in bf16 the plain path rounds the gates, the edge bias and h_hat to bf16
# where the kernels keep f32, and 10 layers compound it
MODEL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (res.stdout + res.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    return CARDS["H100"]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "egt_torch").is_dir() or not CONFIG.is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(egt_torch/ and configs/ are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from egt_torch import schemes, serving, synthetic
    from egt_torch.ops import _cuda
    from egt_torch.ops import egt_attention as att
    from egt_torch.ops import fused_layer as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. host record
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc = run([_cuda._nvcc(), "--version"]).splitlines()
    print("nvcc: " + " | ".join(x for x in nvcc if "release" in x or
                                "Build" in x))
    name = torch.cuda.get_device_name(0)
    mem_bw, peak_bf16, peak_f32 = card_peaks(name)
    print(f"device {name}: bound rates {mem_bw / 1e12} TB/s, "
          f"{peak_bf16 / 1e12} TFLOP/s bf16, {peak_f32 / 1e12} TFLOP/s f32")

    # ---- 2. build
    t0 = time.perf_counter()
    logs = _cuda.build(["fused_layer_fwd", "egt_attention_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            # a ~1 ms spin keeps the card busy while the host enqueues the
            # launch, so the events time the device work and not the Python
            # wrapper's overhead
            torch.cuda._sleep(2_000_000)
            flush.zero_()                    # the caller finds L2 cold
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in times)

    def bound_ms(nbytes, mm_flops, ew_flops, dtype):
        peak_mm = peak_bf16 if dtype == torch.bfloat16 else peak_f32
        t_bytes = nbytes / mem_bw
        t_ops = mm_flops / peak_mm + ew_flops / peak_f32
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def max_err(out, ref, dtype):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        ok = bool(torch.all(err <= atol + rtol * ref.abs())) and \
            bool(torch.isfinite(out).all())
        return float(err.max()), ok

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def ragged_mask(b, l, lo=9, hi=38):
        n = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
        return (torch.arange(l, device=dev)[None, :] < n[:, None]).float()

    results = {}

    # ---- 3a. attention kernel (K1) against its plain version
    def attention_case(b, h, l, d, dtype, gated=True, hard=False):
        q, k, v = (randn(b, h, l, d).to(dtype) for _ in range(3))
        e = randn(b, h, l, l).to(dtype)
        g = randn(b, h, l, l).to(dtype) if gated else None
        madd = (ragged_mask(b, l, lo=min(9, l), hi=min(38, l)) - 1.0) * 1e9
        maddf = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.6)
                 .float() - 1.0) * 1e9 if hard else None
        args = (q, k, v, e, g, madd, maddf, (-5.0, 5.0))
        out = att._egt_core_fwd_cuda(*args)
        ref = att.egt_core_fwd_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)
                if r is not None]
        err = max(x[0] for x in errs)
        tag = f"attention_fwd b{b} h{h} l{l} d{d} {str(dtype)[6:]}" + \
            (" hard-mask" if hard else "") + ("" if gated else " ungated")
        check(all(x[1] for x in errs), f"{tag}: max |kernel - plain| {err:.3g}")
        it = q.element_size()
        nbytes = (3 * b * h * l * d + (2 if gated else 1) * b * h * l * l
                  + b * h * l * d + b * h * l * l) * it + b * l * 4 + \
            (b * h * l * 4 if gated else 0) + (b * l * l * 4 if hard else 0)
        bnd, by = bound_ms(nbytes, 4 * b * h * l * l * d, 15 * b * h * l * l,
                           dtype)
        ms = time_ms(lambda: att._egt_core_fwd_cuda(*args))
        plain = time_ms(lambda: att.egt_core_fwd_plain(*args))
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bnd:.4f} ms ({by})", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)

    # ---- 3b. whole-layer kernel (K3) against its plain version
    def layer_case(b, l, ew, h, dh, dtype, constrained=False):
        hid = 2 * ew
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=True,
                            constrained=constrained, clip=(-5.0, 5.0),
                            edge_act=None, act="elu",
                            scale=float(dh // h) ** -0.5)

        def dense(i, o):
            lim = (6.0 / (i + o)) ** 0.5
            return {"kernel": (torch.rand((i, o), generator=gen, device=dev)
                               * 2 - 1) * lim, "bias": randn(o, scale=0.1)}

        def ln(n):
            return {"gamma": 1 + randn(n, scale=0.1), "beta": randn(n, scale=0.1)}

        p = {"attention_gates": dense(ew, h), "dense_edge_b": dense(ew, h),
             "norm_edge": ln(ew), "dense_edge_r": dense(h, ew),
             "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, hid),
                          "lr2": dense(hid, ew)}}
        w = fl.layer_weights(p, dtype)
        e = randn(b, l, l, ew).to(dtype)
        qkv = randn(b, l, 3 * dh).to(dtype)
        mask = ragged_mask(b, l, lo=min(9, l), hi=min(38, l))
        am = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.3)
              .float() if constrained else None)
        args = (spec, e, qkv, mask, am, w)
        out = fl._fused_layer_cuda(*args)
        ref = fl.fused_layer_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)]
        err = max(x[0] for x in errs)
        tag = (f"fused_layer_fwd b{b} l{l} ew{ew} h{h} dh{dh} "
               f"{str(dtype)[6:]}" + (" constrained" if constrained else ""))
        check(all(x[1] for x in errs), f"{tag}: max |kernel - plain| {err:.3g}")
        it = e.element_size()
        pairs = b * l * l
        nbytes = (2 * pairs * ew + b * l * 3 * dh + b * l * dh
                  + 2 * ew * h + h * ew + 2 * ew * hid) * it + b * l * 4 + \
            (pairs * 4 if constrained else 0)
        mm = pairs * (2 * ew * 2 * h + 2 * dh + 2 * dh + 2 * h * ew
                      + 2 * 2 * ew * hid)
        elementwise = pairs * (20 * ew + hid + 15 * h)
        bnd, by = bound_ms(nbytes, mm, elementwise, dtype)
        ms = time_ms(lambda: fl._fused_layer_cuda(*args))
        plain = time_ms(lambda: fl.fused_layer_plain(*args))
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bnd:.4f} ms ({by}); {mm / 1e9:.2f} GFLOP in products, "
              f"{nbytes / 1e6:.1f} MB", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)

    try:
        for dtype in (torch.float32, torch.bfloat16):
            results[("attention", dtype)] = attention_case(GRAPHS, 8, PAD, 8,
                                                           dtype)
            results[("layer", dtype)] = layer_case(GRAPHS, PAD, 64, 8, 64,
                                                   dtype)
        attention_case(16, 4, 37, 8, torch.float32, gated=False, hard=True)
        attention_case(16, 4, 37, 8, torch.bfloat16, hard=True)
        layer_case(16, 37, 32, 4, 32, torch.float32, constrained=True)
        layer_case(16, 37, 32, 4, 32, torch.bfloat16, constrained=True)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 3: kernels against their plain versions")

    # ---- 4-5. the serving paths
    raw = json.loads(CONFIG.read_text())
    # seeded weights under the JAX flat names: loading them exercises the
    # weight transfer
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    rng = np.random.default_rng(0)
    requests = [synthetic.zinc_batch(rng, GRAPHS, PAD)
                for _ in range(N_REQUESTS)]
    plain_cfg = {**raw, "use_pallas": False, "use_pallas_layer": False}
    plain_bf16 = serving.load_predictor(plain_cfg, flat)
    ref_out = [plain_bf16(r) for r in requests]

    def serve(tag, overrides, kernel, other):
        predict = serving.load_predictor(
            {**raw, **overrides} if overrides else str(CONFIG), flat)
        predict(requests[0])                       # warm-up
        torch.cuda.synchronize()
        fl.KERNEL.launches = att.KERNEL.launches = 0
        lat, outs = [], []
        for r in requests:
            t = time.perf_counter()
            outs.append(predict(r))                # returns host numpy: synced
            lat.append(time.perf_counter() - t)
        launches = (kernel.launches, other.launches)
        check(launches == (10 * N_REQUESTS, 0),
              f"{tag}: {kernel.source} launched {launches[0]} times, "
              f"{other.source} {launches[1]} times for {N_REQUESTS} requests "
              f"(expected {10 * N_REQUESTS}, 0)")
        ok_shape = all(o.shape == (GRAPHS, 1) and np.isfinite(o).all()
                       for o in outs)
        check(ok_shape, f"{tag}: outputs finite, shape ({GRAPHS}, 1)")
        diff = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref_out))
        check(diff <= MODEL_TOL["bfloat16"],
              f"{tag}: bf16 max |kernel path - plain path| {diff:.4g} "
              f"(tol {MODEL_TOL['bfloat16']}, |plain| max "
              f"{max(float(np.abs(r).max()) for r in ref_out):.3g})")
        # f32 run of the same weights: only the summation order differs
        f32 = serving.load_predictor({**raw, **overrides,
                                      "compute_dtype": "float32"}, flat)
        pf32 = serving.load_predictor({**plain_cfg,
                                       "compute_dtype": "float32"}, flat)
        d32 = float(np.abs(f32(requests[1]) - pf32(requests[1])).max())
        check(d32 <= MODEL_TOL["float32"],
              f"{tag}: f32 max |kernel path - plain path| {d32:.4g} "
              f"(tol {MODEL_TOL['float32']})")
        med = statistics.median(lat)
        print(f"  {tag}: request latency ms {[round(x * 1e3, 3) for x in lat]}"
              f", median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
              f"(batch {GRAPHS}, 10 layers, bf16)", flush=True)
        return launches[0]

    launches = {}
    try:
        launches["layer"] = serve("path A (whole-layer kernel)", {},
                                  fl.KERNEL, att.KERNEL)
        launches["attention"] = serve(
            "path B (attention kernel)",
            {"use_pallas": True, "use_pallas_layer": False},
            att.KERNEL, fl.KERNEL)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phases 4-5: serving paths")

    # ---- 6. kernels line
    rows = []
    for key, source, replaces in (
            ("layer", "egt_torch/csrc/fused_layer_fwd.cu",
             "egt_tpu/ops/fused_layer_pallas.py:373"),
            ("attention", "egt_torch/csrc/egt_attention_fwd.cu",
             "egt_tpu/ops/egt_pallas.py:116")):
        r = results.get((key, torch.bfloat16))
        if r is None or key not in launches:
            continue
        rows.append({"name": Path(source).stem, "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": launches[key], **r, "library_ms": None})
    print(json.dumps({"kernels": rows}))

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
