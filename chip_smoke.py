#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`egt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure makes the exit code non-zero and suppresses the
final result line):
  1. host record: `nvidia-smi` name and power limit, torch and CUDA versions,
     `nvcc --version`;
  2. build the nine CUDA kernels from `egt_torch/csrc` (one nvcc each, in
     parallel); the HMMA (tensor-core) instruction count of K1's, K2's,
     K3's, K4's, K5's, K7's, K6's and K8's libraries per kernel function from
     `cuobjdump -sass` ("not available" without it): non-zero in the bf16
     tensor-core bodies, zero in the f32 ones;
  3. each kernel against its plain PyTorch version on the card, at the
     ZINC-500k shapes in f32 and bf16 with ragged node masks, plus one
     awkward shape: the forwards K1 and K3 at inference and in training mode
     (random mask 0.1 and dropout 0.1 live, h_hat out), the backwards K4, K5,
     K7 (merged: K4's and K5's bodies, de_mid and dhh handed over in f32),
     K6 (mono: a head kernel recomputes h_hat and the clip's in-range flags,
     then K7's bodies, K5's under the mono switch; the head kernel also
     alone against its plain version, flags equal; K7 and K6 bit-identical
     across two launches, and in f32 equal to their parts run in turn bit
     for bit) and K2 with the same draws (awkward: l 37, ew 32, h 4, hard
     mask; K1 and K2 tagged with the body their geometry queries name, q
     and k scaled by 2 on a 1/8 grid so that the clip binds on a share of
     pairs and q.k is exact in any summation order); the edge block's K8 and K9 with h_hat head-major, as
     path C hands it over, and as rows (awkward: ew 32, hidden 64, h 4,
     rows, a pair count that is no multiple of the 32-pair tile; ew 128,
     hidden 256, h 16, l 11 head-major: K8's bf16 body at fewer warps a
     block; ew 160, hidden 160: K8's CUDA-core body; both bf16 only and
     without K9, whose bodies do not fit there),
     each tagged with the body K8's geometry query names, K8's bf16 output
     bit-identical across two launches; K3, K4 and K9 (and K5-
     K7) also at the other shipped edge widths, 8 (hidden 16) and 48
     (hidden 96), with 8 heads and 6845 pairs (no multiple of the bf16
     128-pair tile); K5 alone at the flagship batch with ragged l (9, 41:
     a cluster's last block with fewer rows, keys padded to 16) at ew 8,
     48 and 80, gated and ungated, constrained, and at l 150 (several rows
     a warp), and through its general body at h 32 gated (the PCQM4Mv2
     large config's heads), h 64, h 6, ew 136, odd dh and one warp a
     block; two launches of K4, K5 and K9 give bit-identical weight
     gradients (and K5's dk, dv); errors, kernel / plain
     times (CUDA events, median of 30 launches with L2 flushed before each)
     and the reckoned bound;
  4. serving paths: `load_predictor` on configs/main/zinc/500k/egt.json with
     seeded weights under the JAX names answers 4 requests of 128 synthetic
     ZINC-shaped graphs, checked against the model's plain path (bf16 and
     f32): path A through the whole-layer kernel K3 (10 launches a request);
     path B (use_pallas true, use_pallas_layer false) through the attention
     kernel K1; path C (also use_pallas_edge true) through K1 and the edge
     block K8 (10 launches each a request);
  5. training paths: `load_trainer` on the same config and weights takes a
     warm-up step, then 4 timed steps on 128-graph batches (bf16, random
     mask 0.1 live); each path's launches a step are checked, its
     first-step gradients of every parameter and its losses over 3 steps
     agree with the plain path's (f32 and bf16, same weights and seeds, the
     same draws), and 20 steps on one batch lower the loss. Path A (K3; K4
     and K5), path B (K1; K2), path C (K1, K8; K9, K2: 9 K9 launches a step,
     as the last layer's edge output feeds no loss and autograd never runs
     its backward), A-merged (K3; K7) and A-mono (K3; K6), the last two with
     `fused_layer.BWD_IMPL` set as `EGT_FUSED_BWD` would set it;
  6. one JSON line listing every kernel with its launches on its training
     path, its times and its bound;
  7. last line: {"ok": true, "device": {...}}.
TF32 is off for matrix products and convolutions (full f32 references).
Exits non-zero without a result when no CUDA device is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "main" / "zinc" / "500k" / "egt.json"
N_REQUESTS, GRAPHS, PAD = 4, 128, 40
N_STEPS, N_FALL = 4, 20          # timed training steps; the loss-falls run
SOURCES = ("fused_layer_fwd", "egt_attention_fwd", "fused_layer_bwd_tail",
           "fused_layer_bwd_attn", "egt_attention_bwd", "fused_layer_bwd_merged",
           "fused_layer_bwd_mono", "edge_block_fwd", "edge_block_bwd")

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
    from egt_torch.ops import edge_block as eb
    from egt_torch.ops import egt_attention as att
    from egt_torch.ops import fused_layer as fl
    from egt_torch.training import metrics as M
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
    print("host packages: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("h5py", "scipy")) + " (the engine phase starts from the "
        "reader's cache either way)")
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

    # tensor-core instructions in the SASS of K1's, K2's, K3's, K4's, K5's,
    # K7's, K6's and K8's libraries, per kernel function: the bf16 bodies
    # run mma.sync (HMMA), the f32 ones none (exact f32, no TF32)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src in ("egt_attention_fwd", "egt_attention_bwd",
                "fused_layer_fwd", "fused_layer_bwd_tail",
                "fused_layer_bwd_attn", "fused_layer_bwd_merged",
                "fused_layer_bwd_mono", "edge_block_fwd"):
        if not Path(cuobjdump).exists():
            print(f"  {src}: HMMA count not available (no cuobjdump)")
            continue
        sass = run([cuobjdump, "-sass", str(_cuda.library_path(src))])
        counts = {}
        for part in sass.split("Function : ")[1:]:
            counts[part.split()[0]] = part.count("HMMA")
        print(f"  {src}: HMMA {sum(counts.values())} in all; " + ", ".join(
            f"{fn} {n}" for fn, n in counts.items()))
        mma = [n for fn, n in counts.items() if "mma_kernel" in fn]
        f32 = [n for fn, n in counts.items() if "kernelIf" in fn]
        check(bool(mma) and all(mma) and not any(f32),
              f"{src}: the bf16 body runs HMMA ({mma}), the f32 body "
              f"none ({f32})")

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

    def off_clip(spec, e, w, hh):
        """hh with every pair at least 0.05 from the clip's edges in
        hh - E (moved by 0.25 where it is not): at an edge, K5's strict
        in-range test follows E's last bits, and E moves by ~1e-3 where the
        kernel and its plain version, which take LN1's sums in another
        order, round one element of e_ln to neighbouring bf16 values."""
        lo, hi = spec.clip
        d = hh.float() - fl._edge_head(spec, e, w)[5]
        near = ((d - lo).abs() < 0.05) | ((d - hi).abs() < 0.05)
        return torch.where(near, hh.float() + 0.25, hh.float()).to(hh.dtype)

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
                       training=False, timing=True, qk_scale=2.0, grid=True):
        # q and k scaled so that the clip binds on a share of pairs; with
        # `grid`, on a 1/8 grid: q.k is then exact in f32 in any summation
        # order, and K2's inclusive clip test on the recomputed raw logit
        # falls alike in kernel and plain version at the clip's edges.
        # Without it, general values: K2's test may fall otherwise on a
        # pair whose raw logit lies within a few ulps of an edge, and such
        # pairs are left out of K2's comparison with their rows' dq and
        # their columns' dk
        if grid:
            q, k = (torch.round(randn(b, h, l, d, scale=8 * qk_scale)) / 8
                    for _ in range(2))
        else:
            q, k = (randn(b, h, l, d, scale=qk_scale) for _ in range(2))
        q, k, v = q.to(dtype), k.to(dtype), randn(b, h, l, d).to(dtype)
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
        raw = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * d ** -0.5
        binds = float((raw.abs() > 5.0).float().mean())
        shape = (f"b{b} h{h} l{l} d{d} {str(dtype)[6:]}" +
                 (" hard-mask" if hard else "") + ("" if gated else " ungated")
                 + ("" if grid else " general q, k")
                 + f" clip binds {binds:.2f}")

        def body(geo):
            return " [tensor cores]" if geo["tensor_cores"] else \
                " [CUDA cores]"
        it = q.element_size()
        pairs = b * h * l * l
        nbytes = (3 * b * h * l * d + (2 if gated else 1) * pairs
                  + b * h * l * d + pairs) * it + b * l * 4 + \
            (b * h * l * 4 if gated else 0) + (b * l * l * 4 if hard else 0)
        res = {"fwd": timed(
            f"attention_fwd{' training' if training else ''} {shape}"
            + body(att.fwd_geometry(dtype, l, l, d)), errs,
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
        if not grid:
            # the pairs within 16 f32 ulps of a clip edge: their row's dq
            # and their column's dk take the plain version's values
            ulp = 16 * float(np.spacing(np.float32(5.0)))
            near = ((raw - 5.0).abs() <= ulp) | ((raw + 5.0).abs() <= ulp)
            rows, cols = near.any(-1, keepdim=True), near.any(-2)[..., None]
            out = (torch.where(rows, ref[0], out[0]),
                   torch.where(cols, ref[1], out[1]), *out[2:])
            n_near = int(near.sum())
            check(n_near <= 1e-4 * near.numel(),
                  f"attention_bwd {shape}: {n_near} of {near.numel()} pairs "
                  f"within 16 ulps of a clip edge left out ({int(rows.sum())} "
                  f"dq rows, {int(cols.sum())} dk rows)")
        # dk, dv (indices 1, 2) are sums over query rows: scaled absolute
        # part; dq, de and dg are per-element values
        errs = [max_err(o, r, dtype, scaled=i in (1, 2))
                for i, (o, r) in enumerate(zip(out, ref)) if r is not None]
        nbytes = (3 * b * h * l * d + (3 if gated else 2) * pairs
                  + 2 * b * h * l * d + (2 if gated else 1) * pairs) * it + \
            2 * b * h * l * d * 4 + b * l * 4 + \
            (b * h * l * 4 if gated else 0) + (b * l * l * 4 if hard else 0)
        res["bwd"] = timed(f"attention_bwd {shape}"
                           + body(att.bwd_geometry(dtype, l, l, d)), errs,
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
        hh = off_clip(spec, e, w, randn(b, l, l, h, scale=3.0).to(dtype))
        ge, gv = randn(b, l, l, ew).to(dtype), randn(b, l, dh).to(dtype)
        targs = (spec, e, hh, ge, w)
        out = fl._bwd_tail_cuda(*targs)
        tref = fl.fused_layer_bwd_tail_plain(*targs)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out[:2], tref[:2])]
        errs += [max_err(out[2][k], r, dtype, scaled=True)
                 for k, r in tref[2].items()]
        rerun = fl._bwd_tail_cuda(*targs)
        check(all(torch.equal(out[2][k], rerun[2][k]) for k in out[2]),
              f"fused_layer_bwd_tail {shape}: weight gradients bit-identical "
              "across two launches")
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
        check_attn_rerun(f"fused_layer_bwd_attn {shape}", out, aargs)
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
        # K6's head kernel alone: h_hat recomputed, the clip's flags equal
        # to the plain version's (random q, k: no raw logit within an ulp
        # of the clip)
        hargs = (spec, e, qkv, w)
        out, ref = fl._mono_head_cuda(*hargs), fl.mono_head_plain(*hargs)
        torch.cuda.synchronize()
        check(torch.equal(out[2], ref[2]),
              f"mono_head {shape}: in-range flags equal the plain "
              f"version's ({int(ref[2].sum())} of {ref[2].numel()} in range)")
        res["mono_head"] = timed(
            f"mono_head {shape}", [max_err(o, r, dtype)
                                   for o, r in zip(out[:2], ref[:2])],
            lambda: fl._mono_head_cuda(*hargs),
            lambda: fl.mono_head_plain(*hargs),
            (pairs * ew + b * l * 2 * dh + ew * h) * it + (h + 2 * ew) * 4
            + pairs * h * (4 + (it if it == 2 else 0) + 1),
            pairs * (2 * ew * h + 2 * dh), pairs * (10 * ew + 10 * h), dtype,
            timing)
        # K7 from the same h_hat and cotangents; K6 recomputes h_hat from
        # q.k (random q, k: no raw logit within an ulp of the clip)
        bytes_k6 = (3 * pairs * ew + b * l * 3 * dh + 2 * b * l * dh) * it + \
            (h * ew + 2 * ew * hid + 2 * ew * h) * it + \
            (2 * b * l * dh + nw + ew * nproj + nproj + 2 * ew) * 4 + \
            b * l * 4 + (pairs * 4 if constrained else 0)
        mm_k6 = pairs * 2 * (3 * h * ew + 5 * ew * hid) + \
            pairs * (6 * ew * nproj + 8 * dh)
        for key, name, kfn, pfn, rargs, nbytes, mm in (
                ("merged", "fused_layer_bwd_merged", fl._bwd_merged_cuda,
                 fl.fused_layer_bwd_merged_plain,
                 (spec, e, qkv, mask, am, w, hh, ge, gv, 77),
                 bytes_k6 + pairs * h * it, mm_k6),
                ("mono", "fused_layer_bwd_mono", fl._bwd_mono_cuda,
                 fl.fused_layer_bwd_mono_plain,
                 (spec, e, qkv, mask, am, w, ge, gv, 77), bytes_k6,
                 mm_k6 + pairs * 2 * dh)):
            out, ref = kfn(*rargs), pfn(*rargs)
            torch.cuda.synchronize()
            errs = [max_err(o, r, dtype, scaled=i >= 2)
                    for i, (o, r) in enumerate(zip(out[:4], ref[:4]))]
            errs += [max_err(out[4][k], r, dtype, scaled=True)
                     for k, r in ref[4].items()]
            check(same_bwd(out, kfn(*rargs)),
                  f"{name} {shape}: every output bit-identical across two "
                  "launches")
            if dtype == torch.float32:
                # K7: K4 then K5; K6: its head kernel, K4 from the head's
                # h_hat, then K5 under the mono switch
                hh_, flags = (hh, None) if key == "merged" else \
                    fl._mono_head_cuda(spec, e, qkv, w)[::2]
                t4 = fl._bwd_tail_cuda(spec, e, hh_, ge, w)
                s5 = fl._bwd_attn_cuda(spec, e, qkv, mask, am, w, hh_, t4[1],
                                       t4[0], gv, 77, inrange=flags)
                check(same_bwd(out, (*s5[:4], {**t4[2], **s5[4]})),
                      f"{name} {shape}: equals " + (
                          "K4 then K5" if key == "merged" else
                          "its head kernel, K4, then K5 under the mono "
                          "switch") + " bit for bit")
            res[key] = timed(f"{name} {shape}", errs,
                             lambda: kfn(*rargs), lambda: pfn(*rargs),
                             nbytes, mm, pairs * (50 * ew + 5 * hid + 40 * h),
                             dtype, timing)
        return res

    def same_bwd(a, b):
        """(de, dq, dk, dv, dw) a and b equal bit for bit."""
        return (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
                and sorted(a[4]) == sorted(b[4])
                and all(torch.equal(a[4][k], b[4][k]) for k in a[4]))

    def check_attn_rerun(tag, out, aargs):
        rerun = fl._bwd_attn_cuda(*aargs)
        check(torch.equal(out[2], rerun[2]) and torch.equal(out[3], rerun[3])
              and all(torch.equal(out[4][k], rerun[4][k]) for k in out[4]),
              f"{tag}: dk, dv and the weight gradients bit-identical across "
              "two launches")

    def attn_bwd_case(b, l, ew, h, dh, dtype, gated, constrained):
        """K5 alone against its plain version (draws live, edge
        activation elu), and its sums across two launches."""
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew,
                            gated=gated, constrained=constrained,
                            clip=(-5.0, 5.0), edge_act="elu", act="elu",
                            scale=float(dh // h) ** -0.5,
                            random_mask_prob=0.1, attn_dropout=0.1,
                            training=True)
        lim = (6.0 / (ew + h)) ** 0.5
        w = dict(wb=(randn(ew, h) * lim).to(dtype), bb=randn(h, scale=0.1),
                 g1=1 + randn(ew, scale=0.1), b1=randn(ew, scale=0.1),
                 wg=(randn(ew, h) * lim).to(dtype) if gated else None,
                 bg=randn(h, scale=0.1) if gated else None)
        mask = ragged_mask(b, l, lo=1, hi=l)
        am = ((torch.rand((b, l, l), generator=gen, device=dev) < 0.3)
              .float() if constrained else None)
        e = randn(b, l, l, ew).to(dtype)
        aargs = (spec, e, randn(b, l, 3 * dh).to(dtype), mask, am, w,
                 off_clip(spec, e, w, randn(b, l, l, h, scale=3.0).to(dtype)),
                 randn(b, l, l, h).to(dtype), randn(b, l, l, ew).to(dtype),
                 randn(b, l, dh).to(dtype), 77)
        out = fl._bwd_attn_cuda(*aargs)
        ref = fl.fused_layer_bwd_attn_plain(*aargs)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype, scaled=i >= 2)
                for i, (o, r) in enumerate(zip(out[:4], ref[:4]))]
        errs += [max_err(out[4][k], r, dtype, scaled=True)
                 for k, r in ref[4].items()]
        tag = (f"fused_layer_bwd_attn b{b} l{l} ew{ew} h{h} dh{dh} "
               f"{str(dtype)[6:]}{'' if gated else ' ungated'}"
               f"{' constrained' if constrained else ''}")
        if dtype == torch.bfloat16:
            g = fl.bwd_attn_geometry(spec)
            tag += (f" ({'general' if g['general'] else 'register'} body, "
                    f"{g['warps']} warps x {g['cluster']} blocks)")
        check(all(x[1] for x in errs),
              f"{tag}: max |kernel - plain| {max(x[0] for x in errs):.3g}")
        check_attn_rerun(tag, out, aargs)

    # ---- 3c. edge block (K8 forward, K9 backward)
    def edge_case(b, l, ew, h, dtype, head_major, timing=True, hid=None,
                  bwd=True):
        hid = hid or 2 * ew
        w = dict(wr=randn(h, ew, scale=0.3).to(dtype), br=randn(ew, scale=0.1),
                 g2=1 + randn(ew, scale=0.1), b2=randn(ew, scale=0.1),
                 w1=randn(ew, hid, scale=0.2).to(dtype),
                 bb1=randn(hid, scale=0.1),
                 w2=randn(hid, ew, scale=0.2).to(dtype),
                 bb2=randn(ew, scale=0.1))
        # path C hands K8 the attention kernel's head-major h_hat
        hh = randn(b, h, l, l, scale=2.0).to(dtype).permute(0, 2, 3, 1)
        if not head_major:
            hh = hh.contiguous()
        e, g = randn(b, l, l, ew).to(dtype), randn(b, l, l, ew).to(dtype)
        shape = (f"n{b * l * l} ew{ew} h{h} hidden{hid} {str(dtype)[6:]} "
                 + ("head-major" if head_major else "rows"))
        it = e.element_size()
        n = b * l * l
        wbytes = (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4
        geo = eb.fwd_geometry(dtype, ew, h, hid, head_major)
        body = (f"{'tensor-core' if geo['tensor_cores'] else 'CUDA-core'} "
                f"body, {geo['warps']} warps, {geo['smem']} B")
        out = eb._edge_block_fwd_cuda(hh, e, w)
        ref = eb.edge_block_fwd_plain(hh, e, w)
        torch.cuda.synchronize()
        if geo["tensor_cores"]:
            check(torch.equal(out, eb._edge_block_fwd_cuda(hh, e, w)),
                  f"edge_block_fwd {shape} ({body}): output bit-identical "
                  "across two launches")
        res = {"fwd": timed(
            f"edge_block_fwd {shape} ({body})", [max_err(out, ref, dtype)],
            lambda: eb._edge_block_fwd_cuda(hh, e, w),
            lambda: eb.edge_block_fwd_plain(hh, e, w),
            n * (h + 2 * ew) * it + wbytes,
            n * 2 * (h * ew + 2 * ew * hid), n * (12 * ew + 2 * hid), dtype,
            timing)}
        if not bwd:
            return res
        out = eb._edge_block_bwd_cuda(hh, e, g, w)
        ref = eb.edge_block_bwd_plain(hh, e, g, w)
        torch.cuda.synchronize()
        errs = [max_err(o, r, dtype) for o, r in zip(out[:2], ref[:2])]
        errs += [max_err(out[2][k], r, dtype, scaled=True)
                 for k, r in ref[2].items()]
        check(out[0].stride() == hh.stride(),
              f"edge_block_bwd {shape}: dhh in h_hat's layout")
        rerun = eb._edge_block_bwd_cuda(hh, e, g, w)
        check(all(torch.equal(out[2][k], rerun[2][k]) for k in out[2]),
              f"edge_block_bwd {shape}: weight gradients bit-identical "
              "across two launches")
        nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
        res["bwd"] = timed(
            f"edge_block_bwd {shape}", errs,
            lambda: eb._edge_block_bwd_cuda(hh, e, g, w),
            lambda: eb.edge_block_bwd_plain(hh, e, g, w),
            n * (2 * h + 3 * ew) * it + wbytes + nw * 4,
            n * 2 * (3 * h * ew + 5 * ew * hid), n * (30 * ew + 5 * hid),
            dtype, timing)
        return res

    try:
        for dtype in (torch.float32, torch.bfloat16):
            for training in (False, True):
                results[("attention", dtype, training)] = attention_case(
                    GRAPHS, 8, PAD, 8, dtype, training=training)
                results[("layer", dtype, training)] = layer_case(
                    GRAPHS, PAD, 64, 8, 64, dtype, training=training)
            results[("edge", dtype)] = edge_case(GRAPHS, PAD, 64, 8, dtype,
                                                 head_major=True)
            edge_case(GRAPHS, PAD, 64, 8, dtype, head_major=False)
            edge_case(5, 7, 32, 4, dtype, head_major=False, timing=False)
            if dtype == torch.bfloat16:
                # the f32 CUDA-core body's weights pass 227 KB at these
                # widths, as do K9's weight-gradient sums in bf16
                edge_case(3, 11, 128, 16, dtype, head_major=True,
                          timing=False, hid=256, bwd=False)
                edge_case(2, 6, 160, 8, dtype, head_major=False,
                          timing=False, hid=160, bwd=False)
            # the other shipped edge widths (ZINC-100k: 48, hidden 96;
            # PATTERN, CLUSTER, MNIST, CIFAR10, TSP: 8, hidden 16) with 8
            # heads, over 5 * 37 * 37 = 6845 pairs: no multiple of K4's and
            # K9's 128-pair tile in bf16, nor of 32 in f32
            for ew, dh in ((8, 64), (48, 48)):
                layer_case(5, 37, ew, 8, dh, dtype, training=True,
                           timing=False)
                edge_case(5, 37, ew, 8, dtype, head_major=True, timing=False)
            # K5 alone: ragged l at the flagship batch, ew 8 / 48 / 80,
            # gated and ungated, constrained; l 150 loops rows in a warp;
            # then shapes of its general body (2h past 16, h 64 two heads a
            # lane, h 6 no divisor of 32, ew 136 three edge chunks, odd dh,
            # one warp a block at h 64, ew 96, l 4)
            for b, l, ew, h, dh, gated, constrained in (
                    (GRAPHS, 41, 8, 8, 64, True, False),
                    (GRAPHS, 41, 48, 8, 48, False, True),
                    (GRAPHS, 9, 48, 8, 48, True, True),
                    (GRAPHS, 41, 80, 8, 64, True, True),
                    (16, 150, 8, 8, 64, False, False),
                    (16, 20, 64, 32, 64, True, False),
                    (16, 12, 16, 64, 64, False, True),
                    (16, 13, 24, 6, 18, True, True),
                    (16, 23, 136, 8, 64, True, False),
                    (16, 11, 10, 1, 7, False, False),
                    (16, 4, 96, 64, 64, True, True)):
                attn_bwd_case(b, l, ew, h, dh, dtype, gated, constrained)
            if dtype == torch.bfloat16:
                # K1 and K2 on general-valued q and k, through each body:
                # the tensor cores (d 8) and the CUDA cores (d 24)
                for d in (8, 24):
                    attention_case(16, 4, PAD, d, dtype, training=True,
                                   timing=False, grid=False)
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

    # ---- 4. the serving paths
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

    kernels = {"K1": att.KERNEL, "K2": att.BWD_KERNEL, "K3": fl.KERNEL,
               "K4": fl.BWD_TAIL_KERNEL, "K5": fl.BWD_ATTN_KERNEL,
               "K6": fl.BWD_MONO_KERNEL, "K7": fl.BWD_MERGED_KERNEL,
               "K8": eb.KERNEL, "K9": eb.BWD_KERNEL}

    def counted(run, want, what):
        """Run `run` with every count set to 0; check the launches against
        `want` ({kernel: launches}, the others 0) and return them."""
        for kern in kernels.values():
            kern.launches = 0
        out = run()
        launches = {k: kern.launches for k, kern in kernels.items()}
        full = {k: want.get(k, 0) for k in kernels}
        check(launches == full, f"{what}: launches {launches} "
              f"(expected {full})")
        return out, launches

    def serve(tag, overrides, on):
        """Serve N_REQUESTS requests; check launches (10 a request for each
        kernel in `on`), outputs and agreement with the plain path."""
        predict = serving.load_predictor(
            {**raw, **overrides} if overrides else str(CONFIG), flat)
        predict(requests[0])                       # warm-up
        torch.cuda.synchronize()

        def run():
            lat, outs = [], []
            for r in requests:
                t = time.perf_counter()
                outs.append(predict(r))            # returns host numpy: synced
                lat.append(time.perf_counter() - t)
            return lat, outs

        (lat, outs), _ = counted(run, {k: 10 * N_REQUESTS for k in on},
                                 f"{tag}, {N_REQUESTS} requests")
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

    path_b = {"use_pallas": True, "use_pallas_layer": False}
    path_c = {**path_b, "use_pallas_edge": True}
    try:
        serve("serving path A (whole-layer kernel)", {}, ("K3",))
        serve("serving path B (attention kernel)", path_b, ("K1",))
        serve("serving path C (attention kernel, edge block)", path_c,
              ("K1", "K8"))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 4: serving paths")

    # ---- 5. the training paths
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

    def train(tag, overrides, want, impl="split"):
        """Timed steps with the launches a step in `want`, agreement with
        the plain path, and a falling loss; the whole-layer backward is
        `impl` (fused_layer.BWD_IMPL) for the phase."""
        fl.BWD_IMPL = impl
        try:
            tr = load_trainer({**raw, **overrides}, flat)  # bf16, as shipped
            tr.train_step(train_batches[0])                # warm-up
            torch.cuda.synchronize()

            def run():
                times, losses = [], []
                for bt in train_batches[1:]:
                    t = time.perf_counter()
                    losses.append(tr.train_step(bt)["loss"])  # .item(): synced
                    times.append(time.perf_counter() - t)
                return times, losses

            (times, losses), launches = counted(
                run, {k: n * N_STEPS for k, n in want.items()},
                f"{tag}, {N_STEPS} steps")
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
            check(last < first, f"{tag}: {N_FALL} steps on one batch, mean "
                  f"loss of the first 5 {first:.5f} -> last 5 {last:.5f}")
            return launches
        finally:
            fl.BWD_IMPL = "split"

    # each kernel's launches on the training path that runs it; path C
    # launches K9 9 times a step: the last layer's edge output feeds no loss,
    # so autograd never runs that layer's edge-block backward (its tail
    # parameters get no gradient, as on the plain path)
    train_launches = {}
    for tag, overrides, want, impl in (
            ("training path A (K3; K4, K5)", {},
             dict(K3=10, K4=10, K5=10), "split"),
            ("training path B (K1; K2)", path_b, dict(K1=10, K2=10), "split"),
            ("training path C (K1, K8; K9, K2)", path_c,
             dict(K1=10, K8=10, K9=9, K2=10), "split"),
            ("training path A-merged (K3; K7)", {}, dict(K3=10, K7=10),
             "merged"),
            ("training path A-mono (K3; K6)", {}, dict(K3=10, K6=10),
             "mono")):
        try:
            launches = train(tag, overrides, want, impl)
            train_launches.update({k: launches[k] for k in want
                                   if k not in train_launches})
        except Exception:                           # noqa: BLE001 - report
            traceback.print_exc()
            check(False, f"phase 5: {tag}")

    # ---- 6. the engine: the CLI triple on synthetic ZINC at the ZINC-12k
    # split sizes, the flagship config as shipped (path A: K3; K4, K5)
    from egt_torch import do_evaluations, end_training, native, run_training
    from egt_torch.data import datasets as D
    from egt_torch.data.dataset import GraphDataset

    def engine(tmp: Path):
        sizes = {"training": 10_000, "validation": 1_000, "test": 1_000}
        erng = np.random.default_rng(2)
        cache = tmp / "cache"
        t = time.perf_counter()
        ds = GraphDataset(D.ZINC, str(tmp / "ZINC.h5"), str(cache),
                          splits=list(sizes))
        # no HDF5 file: the reader starts from its cache, written from
        # records (h5py need not be on the host)
        for split, n in sizes.items():
            ds.write_cache(split, synthetic.zinc_records(erng, n))
        print(f"  engine: wrote the cache of {sum(sizes.values())} synthetic "
              f"ZINC graphs in {time.perf_counter() - t:.1f} s", flush=True)

        # the native batch builder loaded, and its batch equals numpy's
        check(native.available(), "engine: the native batch builder loaded")
        first = next(ds.batches("training", raw["batch_size"], shuffle=True))
        swap, native.available = native.available, lambda: False
        try:
            ref = next(ds.batches("training", raw["batch_size"], shuffle=True))
        finally:
            native.available = swap
        check(sorted(first) == sorted(ref) and all(
            first[k].dtype == ref[k].dtype and np.array_equal(first[k], ref[k])
            for k in ref), "engine: the native batch equals the numpy batch")

        cfg = {**raw, "dataset_path": str(tmp / "ZINC.h5"),
               "cache_dir": str(cache), "save_path": str(tmp / "run"),
               "num_epochs": 2, "log_tensorboard": True}
        path = tmp / "config.json"

        def cli(main, **over):
            path.write_text(json.dumps({**cfg, **over}))
            return main([str(path)])

        bs = raw["batch_size"]
        steps = math.ceil(sizes["training"] / bs)
        val = math.ceil(sizes["validation"] / bs)
        evals = sum(math.ceil(n / (2 * bs)) for n in sizes.values())
        s1, _ = counted(lambda: cli(run_training.main),
                        dict(K3=20 * (steps + val), K4=20 * steps,
                             K5=20 * steps),
                        f"engine run_training, 2 epochs of {steps} steps and "
                        f"{val} validation batches")
        s2, _ = counted(lambda: cli(run_training.main, num_epochs=3),
                        dict(K3=10 * (steps + val), K4=10 * steps,
                             K5=10 * steps), "engine run_training, resumed "
                        "to epoch 3")
        s3, _ = counted(lambda: cli(do_evaluations.main, num_epochs=3,
                                    weight_file=""), dict(K3=10 * evals),
                        f"engine do_evaluations, {evals} batches")
        s4, _ = counted(lambda: cli(end_training.main, num_epochs=3), {},
                        "engine end_training")

        run_dir = tmp / "run"
        name = raw["model_name"]
        for rel in ("config/config.json", "config/config_input.json",
                    "summary.txt", f"saved/{name}.npz", "logs/metrics.jsonl",
                    "checkpoint/ckpt_3.pt", "checkpoint/train_state_3.json"):
            check((run_dir / rel).is_file(), f"engine: run dir holds {rel}")
        check(bool(list((run_dir / "logs").glob("events.out.tfevents.*"))),
              "engine: TensorBoard events written")
        check(s2.state["current_epoch"] == 3 and
              s2.state["global_step"] == 3 * steps and
              s2.state["save_best_value"] < float("inf"),
              f"engine: resumed to epoch 3 ({s2.state})")
        recs = [json.loads(x) for x in
                (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(len(recs) == 3 and recs[2]["mae"] < recs[0]["mae"],
              "engine: training MAE by epoch "
              f"{[round(r['mae'], 5) for r in recs]}, val MAE "
              f"{[round(r['val_mae'], 5) for r in recs]}")
        for r in recs:
            check(all(np.isfinite(r[k]) for k in
                      ("loss", "mae", "val_loss", "val_mae")),
                  f"engine: epoch {r['epoch']} metrics finite")
        for split in ("trainset", "valset", "testset"):
            text = (run_dir / "predictions" / f"{split}_evals.txt").read_text()
            check("MAE = " in text, f"engine: {split}_evals.txt: "
                  f"{text.strip()}")

        # the saved weights serve, and predict what the trainer's model does
        predict = serving.load_predictor(str(path),
                                         str(run_dir / "saved" / f"{name}.npz"))
        batch = next(ds.batches("test", bs))
        served = predict(batch)
        with torch.inference_mode():
            own = s4.model({k: batch[k] for k in (
                "node_features", "feature_matrix", "graph_matrix")})
        diff = float(np.abs(served - own.float().cpu().numpy()).max())
        check(served.shape == (bs, 1) and np.isfinite(served).all()
              and diff <= MODEL_TOL["bfloat16"],
              f"engine: load_predictor on the saved npz against the "
              f"trainer's model, max diff {diff:.3g} (tol "
              f"{MODEL_TOL['bfloat16']})")

        # a step of the engine reads nothing back from the card
        tr = s4.trainer
        dbatch = s4._to_device(first)
        acc = M.DeviceAccumulator()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                tr.train_into(acc, [dbatch])
            tr.eval_into(acc, dbatch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(np.isfinite(acc.result()["loss"]),
              "engine: train_into and eval_into ran with CUDA synchronization "
              "as an error")

        for st in s1.epoch_stats + s2.epoch_stats:
            print(f"  engine epoch {st['epoch']}: {st['seconds']:.3f} s "
                  f"({st['train_seconds']:.3f} s training, {st['steps']} steps,"
                  f" {1e3 * st['train_seconds'] / st['steps']:.2f} ms a step),"
                  f" {st['graphs_per_s']:.1f} graphs/s, "
                  f"{st['wait_share']:.4f} of the training time waiting for "
                  f"the next batch [{smi}]", flush=True)

    try:
        (REPO / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="engine-",
                                         dir=REPO / "build") as tmp:
            engine(Path(tmp))
    except Exception:                               # noqa: BLE001 - report
        traceback.print_exc()
        check(False, "phase 6: engine")

    # ---- 7. kernels line: the training-mode cases at the flagship shape,
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
             "egt_tpu/ops/fused_layer_pallas.py:868"),
            ("K6", "layer", "mono", "egt_torch/csrc/fused_layer_bwd_mono.cu",
             "egt_tpu/ops/fused_layer_pallas.py:438"),
            ("K7", "layer", "merged",
             "egt_torch/csrc/fused_layer_bwd_merged.cu",
             "egt_tpu/ops/fused_layer_pallas.py:1021"),
            ("K8", "edge", "fwd", "egt_torch/csrc/edge_block_fwd.cu",
             "egt_tpu/ops/edge_block_pallas.py:92"),
            ("K9", "edge", "bwd", "egt_torch/csrc/edge_block_bwd.cu",
             "egt_tpu/ops/edge_block_pallas.py:101")):
        key_ = (case, torch.bfloat16) if case == "edge" else \
            (case, torch.bfloat16, True)
        r = results.get(key_, {}).get(part)
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
