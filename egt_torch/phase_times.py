"""Which phase of the bf16 K2, K3, K4, K5 and K8 bodies and of K6's head
kernel takes their time, by ablation.

    python3 -m egt_torch.phase_times [K2 K3 K4 K5 K6 K8]

Copies `egt_torch/csrc` into `build/egt_torch/phases/<kernel>/` for each
kernel named, and builds one library per variant in which one phase's
loops run no iteration (the `all` variant skips every phase listed), then
times each variant's kernel at the flagship ZINC-500k shapes (b 128, l 40,
ew 64, h 8, dh 64, hidden 128, bf16; K3 and K5 in training mode with the
draws live; K8 with h_hat head-major, as path C hands it over; K2 at the
per-head width 8 with the draws live and the clip binding) as
`chip_smoke.py` does (CUDA events, median of 30 launches, L2 flushed
before each). A
skipped phase's outputs are wrong, so the variants are timed, never
checked; the time a variant saves is what that phase costs beside the
others (phases overlap, so the savings need not add up). K9 runs K4's body.
K5's phases: `head_mma` the three edge-head products, `chain` the softmax /
gate / dropout / clip chain (its da dot product included), `per_head` the
per-head products (da = gv . v, dq, dk and dv); with all three skipped, the
loads, LayerNorm and its backward, the stores and the cluster's sum remain.
K6: its head kernel (`mono_head_kernel`) alone, phases `ln1` (LayerNorm of
e), `p` (the edge-bias product), `qk` (q . k) and `wt` (staging Wb
transposed); with all four skipped, the loads of e and the stores remain.
K8: `hh` (staging h_hat), `wr` (the rnd(h_hat) . Wr product), `ln` (the
LayerNorm of e_mid: its statistics and the rounded store) and `ffn` (the
W1 -> ELU -> W2 chain); with all four skipped, the staging of e, the
residual sums and the stores of out remain. K3's `ffn` and K8's `wr`,
`ln` and `ffn` lie in the tail chain the two share (`edge_tail_mma.cuh`).
K2's tensor-core body: `chain` (the softmax chain with the draws, the
clip's flags, the gate / softmax / dropout backward: every loop over a
tile's key columns, the Philox words included), `products` (q.k^T, gv.v^T and rnd(dr).K, and the
packing of rnd(dr) into A fragments) and `sums` (the dk- and dv-shaped
products, the warps' partial sums and the block's fixed-order sum); with
all three skipped, the staging and the stores of de, dg and dq remain.
Times the kernels named (all six by default). Prints the card's name and
power limit, one line per variant, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import torch

from .ops import _cuda
from .ops import edge_block as eb
from .ops import egt_attention as att
from .ops import fused_layer as fl

B, L, EW, H, DH, HID = 128, 40, 64, 8, 64, 128

# kernel: (source, files patched, {phase: {loop header: how many times it
# occurs in those files}}); each header's bound becomes SKIP_<PHASE> ? 0 :
# bound at every occurrence, and a count that differs stops the build
PHASES = {
    # the chain's loops over key columns, in the shared header and the body
    "K2": ("egt_attention_bwd", ("egt_attention_bwd.cu", "attn_core_mma.cuh"), {
        "chain": {"for (int jc = 0; jc < NT; ++jc)": 7,
                  "for (int jd = 0; jd < NT; ++jd) {": 1},
        "products": {"for (int kb = 0; kb < NKT; ++kb) {": 3},
        "sums": {"for (int mt = 0; mt < NKT; ++mt)": 2,
                 "for (int t = threadIdx.x; t < lk * d; "
                 "t += blockDim.x) {": 1},
    }),
    "K3": ("fused_layer_fwd", ("fused_layer_fwd.cu", "edge_tail_mma.cuh"), {
        "projection": {"for (int n0 = 0; n0 < NP; n0 += 16) {": 1},
        "pair": {"for (int it = lane; it < 16 * h; it += 32) {": 1},
        "ffn": {"for (int u0 = 0; u0 < UK; u0 += 16) {": 1},
        "softmax": {"for (int base = warp * per; base < nr * h; "
                    "base += nw * per) {": 1},
        "av": {"for (int t = tid; t < nr * dh; t += blockDim.x) {\n"
               "      const int rg = t / dh, f = t - rg * dh;\n"
               "      const int row = row0 + rg, b = row / l;": 1},
    }),
    "K4": ("fused_layer_bwd_tail", ("tail_bwd.cuh",), {
        "e_mid": {"for (int k0 = 0; k0 < HK; k0 += 16) {": 1},
        "ffn": {"for (int ub = 0; ub < ucw; ub += 16) {": 1},
        "wgrad_ffn": {"for (int bi = warp; bi < 2 * n2; bi += nw) {": 1},
        "dhh": {"for (int n0 = 0; n0 < HK; n0 += 16) {": 1},
        "wgrad_r": {"for (int bi = warp; bi < (HK / 16) * nbr; "
                    "bi += nw) {": 1},
    }),
    # the register body's products (the flagship's); the chain's four key
    # loops, shared by both bodies
    "K5": ("fused_layer_bwd_attn", ("attn_bwd.cuh",), {
        "head_mma": {"for (int ke = 0; ke < NTE / 2; ++ke) {": 1,
                     "for (int kp = 0; kp < NPT / 2; ++kp) {": 1,
                     "for (int mb = 0; mb < NTE / 2; ++mb) {": 1},
        "chain": {"for (int j = kg; j < l; j += KG) {": 4},
        "per_head": {"for (int dd = 0; dd < ndd; ++dd) {": 1,
                     "for (int f0 = 2 * lane; f0 < dh; f0 += 64) {": 1,
                     "for (int w = 0; w < nrows; ++w) {": 1},
    }),
    "K6": ("fused_layer_bwd_mono", ("fused_layer_bwd_mono.cu",), {
        "ln1": {"for (int c = g; c < ew; c += 8)": 3},
        "p": {"for (int c = 0; c < ew4 / 4; ++c) {": 1},
        "qk": {"for (int f = hd; f < dh; f += h) sc": 1},
        "wt": {"for (int t = tid; t < ew4 * h; t += HEAD_NT) {": 1},
    }),
    # the head-major staging; the tail chain's loops and ln_stats's two
    "K8": ("edge_block_fwd",
           ("edge_block_fwd.cu", "edge_tail_mma.cuh", "mma.cuh"), {
        "hh": {"for (int t = lane; t < 2 * h; t += 32) {": 1},
        "wr": {"for (int k0 = 0; k0 < HK; k0 += 16) {": 1},
        "ln": {"for (int jn = 0; jn < NTE; ++jn) {": 1,
               "for (int j = 0; j < NT; ++j)": 2},
        "ffn": {"for (int u0 = 0; u0 < UK; u0 += 16) {": 1},
    }),
}


def _patch(texts: dict, phases: dict) -> dict:
    """texts {file: source} with every phase's loop headers rewritten."""
    for name, headers in phases.items():
        for header, count in headers.items():
            found = sum(t.count(header) for t in texts.values())
            if found != count:
                raise RuntimeError(f"phase {name}: {header!r} occurs {found} "
                                   f"times, expected {count}")
            first = header.split("\n")[0]
            init, rest = first.split("; ", 1)
            cond, step = rest.split("; ", 1)
            var, bound = cond.split(" < ", 1)
            new = (f"{init}; {var} < (SKIP_{name.upper()} ? 0 : {bound}); "
                   f"{step}")
            texts = {f: t.replace(header, header.replace(first, new, 1))
                     for f, t in texts.items()}
    return texts


def _build(out_dir, kernel):
    source, _, phases = PHASES[kernel]
    variants = {"base": set(), **{p: {p} for p in phases}, "all": set(phases)}
    jobs = {}
    for v, skip in variants.items():
        defs = [f"-DSKIP_{p.upper()}={int(p in skip)}" for p in phases]
        so = out_dir / f"{v}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defs, "-o", str(so),
               str(out_dir / "csrc" / f"{source}.cu")]
        jobs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True), so)
    for v, (proc, _) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {v}:\n{log}")
    return {v: so for v, (_, so) in jobs.items()}


def main(argv=None) -> int:
    kernels = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = set(kernels) - set(PHASES)
    if unknown:
        raise SystemExit(f"phase_times: unknown kernels {sorted(unknown)}; "
                         f"choose from {list(PHASES)}")
    if not torch.cuda.is_available():
        raise SystemExit("phase_times needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = _cuda.BUILD_DIR / "phases"
    shutil.rmtree(out_dir, ignore_errors=True)
    for k in kernels:         # one copy a kernel: K3 and K8 share a header
        _, files, phases = PHASES[k]
        csrc = out_dir / k / "csrc"
        shutil.copytree(_cuda._CSRC, csrc)
        texts = _patch({f: (csrc / f).read_text() for f in files}, phases)
        for f, text in texts.items():
            (csrc / f).write_text(text)
    libs = {k: _build(out_dir / k, k) for k in kernels}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        marks = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    dt = torch.bfloat16
    w = dict(wg=randn(EW, H, scale=0.2), bg=randn(H, scale=0.1),
             wb=randn(EW, H, scale=0.2), bb=randn(H, scale=0.1),
             g1=1 + randn(EW, scale=0.1), b1=randn(EW, scale=0.1),
             wr=randn(H, EW, scale=0.3), br=randn(EW, scale=0.1),
             g2=1 + randn(EW, scale=0.1), b2=randn(EW, scale=0.1),
             w1=randn(EW, HID, scale=0.2), bb1=randn(HID, scale=0.1),
             w2=randn(HID, EW, scale=0.2), bb2=randn(EW, scale=0.1))
    w = {k: (v.to(dt) if k.startswith("w") else v) for k, v in w.items()}
    spec = fl.LayerSpec(l=L, ew=EW, h=H, dh=DH, hidden=HID, gated=True,
                        constrained=False, clip=(-5.0, 5.0), edge_act=None,
                        act="elu", scale=float(DH // H) ** -0.5,
                        random_mask_prob=0.1, attn_dropout=0.1, training=True)
    e = randn(B, L, L, EW).to(dt)
    qkv = randn(B, L, 3 * DH).to(dt)
    n = torch.randint(9, 39, (B,), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
    hh = randn(B, L, L, H, scale=3.0).to(dt)
    g = randn(B, L, L, EW).to(dt)
    dhh, gv = randn(B, L, L, H).to(dt), randn(B, L, DH).to(dt)
    hm = randn(B, H, L, L, scale=2.0).to(dt).permute(0, 2, 3, 1)
    d = DH // H
    qa, ka = (randn(B, H, L, d, scale=2.0).to(dt) for _ in range(2))
    va, gva = (randn(B, H, L, d).to(dt) for _ in range(2))
    ga, gha = randn(B, H, L, L).to(dt), randn(B, H, L, L).to(dt)
    draws = att.Draws(123, 0.1, 0.1)
    k2 = (qa, ka, va, ga, (mask - 1.0) * 1e9, None,
          randn(B, H, L, L, scale=2.0).to(dt), gva, gha, randn(B, H, L),
          (-5.0, 5.0), draws)
    runs = {"K2": (att.BWD_KERNEL, lambda: att._egt_core_bwd_cuda(*k2)),
            "K3": (fl.KERNEL, lambda: fl._fused_layer_cuda(
                spec, e, qkv, mask, None, w, 77, True)),
            "K4": (fl.BWD_TAIL_KERNEL, lambda: fl._bwd_tail_cuda(
                spec, e, hh, g, w)),
            "K5": (fl.BWD_ATTN_KERNEL, lambda: fl._bwd_attn_cuda(
                spec, e, qkv, mask, None, w, hh, dhh, g, gv, 77)),
            "K6": (fl.MONO_HEAD_KERNEL, lambda: fl._mono_head_cuda(
                spec, e, qkv, w)),
            "K8": (eb.KERNEL, lambda: eb._edge_block_fwd_cuda(
                hm, e, {k: w[k] for k in fl.TAIL_KEYS}))}
    res = {"device": smi}
    for kernel in kernels:
        kern, fn = runs[kernel]
        times = {}
        for v, so in libs[kernel].items():
            kern._lib, kern._fn = ctypes.CDLL(str(so)), None
            times[v] = time_ms(fn)
        kern._lib, kern._fn = None, None
        for v, t in times.items():
            print(f"  {kernel} {v}: {t:.4f} ms (saves "
                  f"{times['base'] - t:.4f})", flush=True)
        res[kernel] = times
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
