#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`egt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure makes the exit code non-zero and suppresses the
final result line):
  1. host record: `nvidia-smi` name and power limit, torch and CUDA versions,
     `nvcc --version`;
  2. build the five CUDA kernels from `egt_torch/csrc` (one nvcc each, in
     parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     ZINC-500k shapes in f32 and bf16 with ragged node masks, plus one
     awkward shape (l 37, ew 32, h 4, hard mask): the forwards K1 and K3 at
     inference and in training mode (random mask 0.1 and dropout 0.1 live,
     h_hat out), the backwards K4, K5 and K2 with the same draws; errors,
     kernel / plain times (CUDA events, median of 30 launches with L2 flushed
     before each) and the reckoned bound;
  4. serving path A: `load_predictor` on configs/main/zinc/500k/egt.json with
     seeded weights under the JAX names answers 4 requests of 128 synthetic
     ZINC-shaped graphs through the whole-layer kernel (10 launches a
     request), checked against the model's plain path;
  5. serving path B: the same with use_pallas true, use_pallas_layer false
     (the attention kernel, 10 launches a request);
  6. training path A: `load_trainer` on the same config and weights takes a
     warm-up step, then 4 timed steps on 128-graph batches (bf16, random
     mask 0.1 live) through K3, K4 and K5 (10 launches each a step, K1 and K2
     none); its first-step gradients of every parameter and its losses over
     3 steps agree with the plain path's (f32 and bf16, same weights and
     seeds, the same draws); 20 steps on one batch lower the loss;
  7. training path B: the same through K1 and K2 (10 each a step, K3-K5
     none);
  8. one JSON line listing every kernel with its launches on its training
     path, its times and its bound;
  9. last line: {"ok": true, "device": {...}}.
TF32 is off for matrix products and convolutions (full f32 references).
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
N_STEPS, N_FALL = 4, 20          # timed training steps; the loss-falls run
SOURCES = ("fused_layer_fwd", "egt_attention_fwd", "fused_layer_bwd_tail",
           "fused_layer_bwd_attn", "egt_attention_bwd")

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
# training agreement with the plain path (same weights, seeds and draws):
# losses relative; each parameter's step-1 gradient by max |kernel - plain|
# over max(max |plain|, 1e-2 G), G the largest gradient of the model, so a
# parameter whose gradient is only rounding noise (the key bias: softmax is
# shift-invariant) is held in absolute terms. f32: summation order, and a
# pair whose logit sits at the clip edge may fall on the other side of the
# whole-layer backward's strict in-range test on the saved h_hat. bf16: the
# plain path rounds the gates, the edge bias and h_hat where the kernels keep
# f32, through 10 layers forward and back.
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-3, 5e-2)}  # loss, grad

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
    from egt_torch.training.steps import load_trainer

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
    logs = _cuda.build(SOURCES)
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

    def max_err(out, ref, dtype, scaled=False):
        """Largest |kernel - plain| and whether every element is within
        atol + rtol |plain|; `scaled` multiplies atol by max(1, max |plain|)
        (sums over many pairs: weight gradients, dk, dv)."""
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        out, ref = out.float(), ref.float()
        if scaled:
            atol *= max(1.0, float(ref.abs().max()))
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

    def timed(tag, errs, kernel_fn, plain_fn, nbytes, mm, elementwise, dtype,
              timing=True):
        """Check the errors; with `timing`, time kernel and plain version
        and print them beside the bound."""
        err = max(x[0] for x in errs)
        check(all(x[1] for x in errs), f"{tag}: max |kernel - plain| {err:.3g}")
        if not timing:
            return None
        ms, plain = time_ms(kernel_fn), time_ms(plain_fn)
        bnd, by = bound_ms(nbytes, mm, elementwise, dtype)
        print(f"  {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}); {mm / 1e9:.3f} GFLOP in products, "
              f"{nbytes / 1e6:.1f} MB", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by)

    # ---- 3a. attention kernels (K1 forward, K2 backward)
    def attention_case(b, h, l, d, dtype, gated=True, hard=False,
                       training=False, timing=True):
        q, k, v = (randn(b, h, l, d).to(dtype) for _ in range(3))
        e = randn(b, h, l, l).to(dtype)
        g = randn(b, h, l, l).to(dtype) if gated else None
        madd = (ragged_mask(b, l, lo=min(9, l), hi=min(38, l)) - 1.0) * 1e9
        maddf = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.6)
                 .float() - 1.0) * 1e9 if hard else None
        draws = att.Draws(123, 0.1, 0.1) if training else att.OFF
        args = (q, k, v, e, g, madd, maddf, (-5.0, 5.0), draws)
        out = att._egt_core_fwd_cuda(*args)
        ref = att.egt_core_fwd_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)
                if r is not None]
        shape = (f"b{b} h{h} l{l} d{d} {str(dtype)[6:]}" +
                 (" hard-mask" if hard else "") + ("" if gated else " ungated"))
        it = q.element_size()
        pairs = b * h * l * l
        nbytes = (3 * b * h * l * d + (2 if gated else 1) * pairs
                  + b * h * l * d + pairs) * it + b * l * 4 + \
            (b * h * l * 4 if gated else 0) + (b * l * l * 4 if hard else 0)
        res = {"fwd": timed(
            f"attention_fwd{' training' if training else ''} {shape}", errs,
            lambda: att._egt_core_fwd_cuda(*args),
            lambda: att.egt_core_fwd_plain(*args), nbytes, 4 * pairs * d,
            15 * pairs, dtype, timing)}
        if not training:
            return res
        # K2 from the forward's h_hat, with the cotangents of v_att, h_hat
        # and (gated) the degrees
        h_hat = ref[1]
        gv, gh = randn(b, h, l, d).to(dtype), randn(b, h, l, l).to(dtype)
        gdeg = randn(b, h, l) if gated else None
        bargs = (q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, (-5.0, 5.0),
                 draws)
        out = att._egt_core_bwd_cuda(*bargs)
        ref = att.egt_core_bwd_plain(*bargs)
        torch.cuda.synchronize()
        # dk, dv (indices 1, 2) are sums over query rows: scaled absolute
        # part; dq, de and dg are per-element values
        errs = [max_err(o, r, dtype, scaled=i in (1, 2))
                for i, (o, r) in enumerate(zip(out, ref)) if r is not None]
        nbytes = (3 * b * h * l * d + (3 if gated else 2) * pairs
                  + 2 * b * h * l * d + (2 if gated else 1) * pairs) * it + \
            2 * b * h * l * d * 4 + b * l * 4 + \
            (b * h * l * 4 if gated else 0) + (b * l * l * 4 if hard else 0)
        res["bwd"] = timed(f"attention_bwd {shape}", errs,
                           lambda: att._egt_core_bwd_cuda(*bargs),
                           lambda: att.egt_core_bwd_plain(*bargs), nbytes,
                           10 * pairs * d, 30 * pairs, dtype, timing)
        return res

    # ---- 3b. whole-layer kernels (K3 forward, K4 and K5 backward)
    def layer_case(b, l, ew, h, dh, dtype, constrained=False, training=False,
                   timing=True):
        hid = 2 * ew
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=True,
                            constrained=constrained, clip=(-5.0, 5.0),
                            edge_act=None, act="elu",
                            scale=float(dh // h) ** -0.5,
                            random_mask_prob=0.1, attn_dropout=0.1,
                            training=training)

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
        args = (spec, e, qkv, mask, am, w, 77, training)
        out = fl._fused_layer_cuda(*args)
        ref = fl.fused_layer_plain(*args)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out, ref)]
        shape = (f"b{b} l{l} ew{ew} h{h} dh{dh} {str(dtype)[6:]}"
                 + (" constrained" if constrained else ""))
        it = e.element_size()
        pairs = b * l * l
        wbytes = (2 * ew * h + h * ew + 2 * ew * hid) * it
        nbytes = (2 * pairs * ew + b * l * 3 * dh + b * l * dh) * it + \
            wbytes + b * l * 4 + (pairs * 4 if constrained else 0) + \
            (pairs * h * it if training else 0)
        mm = pairs * (2 * ew * 2 * h + 2 * dh + 2 * dh + 2 * h * ew
                      + 2 * 2 * ew * hid)
        res = {"fwd": timed(
            f"fused_layer_fwd{' training' if training else ''} {shape}", errs,
            lambda: fl._fused_layer_cuda(*args),
            lambda: fl.fused_layer_plain(*args), nbytes, mm,
            pairs * (20 * ew + hid + 15 * h), dtype, timing)}
        if not training:
            return res
        # K4 and K5 from an h_hat drawn on its own (3 sigma): many pairs lie
        # beyond the clip, none at its edge. (A forward's own h_hat puts
        # every clipped pair at hh - E = lo or hi up to an ulp, where the
        # strict in-range test of K5 follows the last bit of E, which the
        # kernel and its plain version sum in another order.)
        hh = randn(b, l, l, h, scale=3.0).to(dtype)
        ge, gv = randn(b, l, l, ew).to(dtype), randn(b, l, dh).to(dtype)
        targs = (spec, e, hh, ge, w)
        out = fl._bwd_tail_cuda(*targs)
        tref = fl.fused_layer_bwd_tail_plain(*targs)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out[:2], tref[:2])]
        errs += [max_err(out[2][k], r, dtype, scaled=True)
                 for k, r in tref[2].items()]
        nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
        nbytes = (3 * pairs * ew + 2 * pairs * h) * it + \
            (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4 + nw * 4
        mm = pairs * 2 * (3 * h * ew + 5 * ew * hid)
        res["tail"] = timed(f"fused_layer_bwd_tail {shape}", errs,
                            lambda: fl._bwd_tail_cuda(*targs),
                            lambda: fl.fused_layer_bwd_tail_plain(*targs),
                            nbytes, mm, pairs * (30 * ew + 5 * hid), dtype,
                            timing)
        # K5 from h_hat, K4's outputs and a cotangent of v_att
        de_mid, dhh = tref[0], tref[1]
        aargs = (spec, e, qkv, mask, am, w, hh, dhh, de_mid, gv, 77)
        out = fl._bwd_attn_cuda(*aargs)
        aref = fl.fused_layer_bwd_attn_plain(*aargs)
        torch.cuda.synchronize()
        # de, dq per element; dk, dv sums over query rows (scaled)
        errs = [max_err(o, r, dtype, scaled=i >= 2)
                for i, (o, r) in enumerate(zip(out[:4], aref[:4]))]
        errs += [max_err(out[4][k], r, dtype, scaled=True)
                 for k, r in aref[4].items()]
        nproj = 2 * h
        nbytes = (3 * pairs * ew + 2 * pairs * h + b * l * 3 * dh
                  + 2 * b * l * dh + 2 * ew * h) * it + \
            (2 * b * l * dh + ew * nproj + nproj + 2 * ew) * 4 + b * l * 4 + \
            (pairs * 4 if constrained else 0)
        mm = pairs * (6 * ew * nproj + 8 * dh)
        res["attn"] = timed(f"fused_layer_bwd_attn {shape}", errs,
                            lambda: fl._bwd_attn_cuda(*aargs),
                            lambda: fl.fused_layer_bwd_attn_plain(*aargs),
                            nbytes, mm, pairs * (20 * ew + 40 * h), dtype,
                            timing)
        return res

    try:
        for dtype in (torch.float32, torch.bfloat16):
            for training in (False, True):
                results[("attention", dtype, training)] = attention_case(
                    GRAPHS, 8, PAD, 8, dtype, training=training)
                results[("layer", dtype, training)] = layer_case(
                    GRAPHS, PAD, 64, 8, 64, dtype, training=training)
            for training in (False, True):
                attention_case(16, 4, 37, 8, dtype, gated=False, hard=True,
                               training=training, timing=False)
                attention_case(16, 4, 37, 8, dtype, hard=True,
                               training=training, timing=False)
                layer_case(16, 37, 32, 4, 32, dtype, constrained=True,
                           training=training, timing=False)
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
        """Serve N_REQUESTS requests; check launches, outputs and agreement
        with the plain path."""
        predict = serving.load_predictor(
            {**raw, **overrides} if overrides else str(CONFIG), flat)
        predict(requests[0])                       # warm-up
        torch.cuda.synchronize()
        for kern in (fl.KERNEL, att.KERNEL):
            kern.launches = 0
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

    try:
        serve("serving path A (whole-layer kernel)", {}, fl.KERNEL,
              att.KERNEL)
        serve("serving path B (attention kernel)",
              {"use_pallas": True, "use_pallas_layer": False},
              att.KERNEL, fl.KERNEL)
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phases 4-5: serving paths")

    # ---- 6-7. the training paths
    kernels = {"K1": att.KERNEL, "K2": att.BWD_KERNEL, "K3": fl.KERNEL,
               "K4": fl.BWD_TAIL_KERNEL, "K5": fl.BWD_ATTN_KERNEL}
    trng = np.random.default_rng(1)
    train_batches = [synthetic.zinc_batch(trng, GRAPHS, PAD)
                     for _ in range(N_STEPS + 1)]

    def run_steps(overrides, dtype, n=3):
        """Losses of n steps on train_batches and the first step's
        gradients, from the seeded weights."""
        tr = load_trainer({**raw, **overrides, "compute_dtype": dtype}, flat)
        losses, grads = [], None
        for i in range(n):
            losses.append(tr.train_step(train_batches[i])["loss"])
            if i == 0:
                grads = {k: (None if p.grad is None else p.grad.clone())
                         for k, p in tr.model.named_parameters()}
        return losses, grads

    plain_ref = {}

    def agreement(tag, overrides, dtype):
        if dtype not in plain_ref:
            plain_ref[dtype] = run_steps(plain_cfg, dtype)
        (lp, gp), (lk, gk) = plain_ref[dtype], run_steps(overrides, dtype)
        ltol, gtol = TRAIN_TOL[dtype]
        dl = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(lk, lp))
        check(dl <= ltol and np.all(np.isfinite(lk)),
              f"{tag} {dtype}: losses {[round(x, 6) for x in lk]} vs plain "
              f"{[round(x, 6) for x in lp]}, max rel diff {dl:.3g} "
              f"(tol {ltol})")
        top = max(float(g.abs().max()) for g in gp.values() if g is not None)
        worst, where = 0.0, ""
        for k, g in gp.items():
            if g is None:
                # no loss reaches it: the kernel path may hand back zeros
                # (the last layer's unused edge output); both leave the
                # parameter unchanged
                if gk[k] is not None and bool(gk[k].any()):
                    check(False, f"{tag}: {k} has a nonzero gradient only "
                          "on the kernel path")
                continue
            e = float((gk[k] - g).abs().max()) / max(float(g.abs().max()),
                                                     1e-2 * top)
            if not e <= worst:
                worst, where = e, k
        check(worst <= gtol,
              f"{tag} {dtype}: step-1 gradients of every parameter, worst "
              f"normalised |kernel - plain| {worst:.3g} at {where} "
              f"(tol {gtol}; largest gradient {top:.3g})")

    def train(tag, overrides, on):
        tr = load_trainer({**raw, **overrides}, flat)      # bf16, as shipped
        tr.train_step(train_batches[0])                    # warm-up
        torch.cuda.synchronize()
        for kern in kernels.values():
            kern.launches = 0
        times, losses = [], []
        for bt in train_batches[1:]:
            t = time.perf_counter()
            losses.append(tr.train_step(bt)["loss"])       # .item(): synced
            times.append(time.perf_counter() - t)
        launches = {k: kern.launches for k, kern in kernels.items()}
        want = {k: (10 * N_STEPS if k in on else 0) for k in kernels}
        check(launches == want, f"{tag}: launches in {N_STEPS} steps "
              f"{launches} (expected {want})")
        check(bool(np.all(np.isfinite(losses))),
              f"{tag}: losses finite {[round(x, 5) for x in losses]}")
        med = statistics.median(times)
        print(f"  {tag}: step ms {[round(x * 1e3, 3) for x in times]}, "
              f"median {med * 1e3:.3f} ms, {GRAPHS / med:.1f} graphs/s "
              f"(batch {GRAPHS}, 10 layers, bf16)", flush=True)
        for dtype in ("float32", "bfloat16"):
            agreement(tag, overrides, dtype)
        fall = load_trainer({**raw, **overrides}, flat)
        fl_losses = [fall.train_step(train_batches[0])["loss"]
                     for _ in range(N_FALL)]
        first, last = np.mean(fl_losses[:5]), np.mean(fl_losses[-5:])
        check(last < first, f"{tag}: {N_FALL} steps on one batch, mean loss "
              f"of the first 5 {first:.5f} -> last 5 {last:.5f}")
        return launches

    train_launches = {}
    try:
        launches = train("training path A (K3, K4, K5)", {},
                         ("K3", "K4", "K5"))
        train_launches.update({k: launches[k] for k in ("K3", "K4", "K5")})
        launches = train("training path B (K1, K2)",
                         {"use_pallas": True, "use_pallas_layer": False},
                         ("K1", "K2"))
        train_launches.update({k: launches[k] for k in ("K1", "K2")})
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phases 6-7: training paths")

    # ---- 8. kernels line: the training-mode cases at the flagship shape,
    # bf16, each kernel's launches on its training path
    rows = []
    for key, case, part, source, replaces in (
            ("K1", "attention", "fwd", "egt_torch/csrc/egt_attention_fwd.cu",
             "egt_tpu/ops/egt_pallas.py:116"),
            ("K2", "attention", "bwd", "egt_torch/csrc/egt_attention_bwd.cu",
             "egt_tpu/ops/egt_pallas.py:184"),
            ("K3", "layer", "fwd", "egt_torch/csrc/fused_layer_fwd.cu",
             "egt_tpu/ops/fused_layer_pallas.py:373"),
            ("K4", "layer", "tail", "egt_torch/csrc/fused_layer_bwd_tail.cu",
             "egt_tpu/ops/fused_layer_pallas.py:789"),
            ("K5", "layer", "attn", "egt_torch/csrc/fused_layer_bwd_attn.cu",
             "egt_tpu/ops/fused_layer_pallas.py:868")):
        r = results.get((case, torch.bfloat16, True), {}).get(part)
        if r is None or key not in train_launches:
            continue
        rows.append({"name": Path(source).stem, "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": train_launches[key], **r,
                     "library_ms": None})
    print(json.dumps({"kernels": rows}))

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
