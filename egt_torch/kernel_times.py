"""Times of the port's kernels and of the paths that run them, for
comparing two checkouts of the port on one card.

    python3 egt_torch/kernel_times.py [--root DIR]

Imports `egt_torch` from DIR (default: the checkout that holds this file),
so the same script times an older checkout unpacked elsewhere; run it once
per checkout, in turns, in one session on the card. At the flagship
ZINC-500k shapes (b 128, l 40, ew 64, h 8, dh 64, hidden 128), in bf16 and
f32: K1 (`egt_attention_fwd`, training mode with the draws live, and
inference) and K2 (`egt_attention_bwd`, the draws live, a degree
cotangent), q and k scaled by 2 so that the clip binds on a share of
pairs; K3 (`fused_layer_fwd`, training mode with the draws and h_hat out,
and inference), K4 (`fused_layer_bwd_tail`), K5 (`fused_layer_bwd_attn`,
the draws live), K7 (`fused_layer_bwd_merged`, the draws live), K6
(`fused_layer_bwd_mono`, the draws live; `K6 head`: its head kernel
alone, where the checkout has one), K8 (`edge_block_fwd`, h_hat as rows
and head-major) and K9 (`edge_block_bwd`, h_hat head-major as path C
hands it over); K5 and K7 also at h 32 gated (`h32`: K5's general
body); CUDA events, median of 30 launches with L2 flushed before each.
The host time of one K4, K5, K7 and K6 call (the
wrapper's checks and launches, mean of 100 calls while a spin kernel
keeps the card busy, so the clock sees the host's work alone). A digest
(sha256 of the output bytes) of K1's (training and inference), K2's,
K3's (training), K4's, K5's, K7's, K6's and K9's outputs, and of K8's in
both layouts, to show that two checkouts compute them bit for bit alike
(K2 from the plain version's h_hat, the same in both). The bytes K7's and K6's
launches move in bf16 and the floor they set. Then, in bf16 as shipped,
the median wall time of 24 training steps on path A (K3; K4, K5), on
path B (K1; K2), on path C (K1, K8; K9, K2), on A-merged (K3; K7) and on
A-mono (K3; K6), and of 24 serving requests on paths A, B and C, 128
graphs each, after a warm-up. Prints the card's name and power limit, then one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, L, EW, H, DH, HID = 128, 40, 64, 8, 64, 128
H32 = 32            # K5's general body: 2h = 64 projection columns
STEPS = 24


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    from egt_torch import schemes, serving, synthetic
    from egt_torch.ops import _cuda
    from egt_torch.ops import edge_block as eb
    from egt_torch.ops import egt_attention as att
    from egt_torch.ops import fused_layer as fl
    from egt_torch.training.steps import load_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    _cuda.build(("fused_layer_fwd", "fused_layer_bwd_tail", "edge_block_bwd",
                 "fused_layer_bwd_attn", "egt_attention_fwd",
                 "egt_attention_bwd", "edge_block_fwd",
                 "fused_layer_bwd_merged", "fused_layer_bwd_mono"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        marks = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)      # the card waits, not the host
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            marks.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks)

    def host_us(fn, iters=100):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)        # the queue never drains
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return 1e6 * dt / iters

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def digest(out):
        """sha256 of every tensor in out (nested tuples and dicts)."""
        h = hashlib.sha256()

        def add(x):
            if isinstance(x, dict):
                for k in sorted(x):
                    add(x[k])
            elif isinstance(x, (tuple, list)):
                for y in x:
                    add(y)
            else:
                h.update(x.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
        torch.cuda.synchronize()
        add(out)
        return h.hexdigest()[:16]

    def weights(dt, h):
        w = dict(wg=randn(EW, h, scale=0.2), bg=randn(h, scale=0.1),
                 wb=randn(EW, h, scale=0.2), bb=randn(h, scale=0.1),
                 g1=1 + randn(EW, scale=0.1), b1=randn(EW, scale=0.1),
                 wr=randn(h, EW, scale=0.3), br=randn(EW, scale=0.1),
                 g2=1 + randn(EW, scale=0.1), b2=randn(EW, scale=0.1),
                 w1=randn(EW, HID, scale=0.2), bb1=randn(HID, scale=0.1),
                 w2=randn(HID, EW, scale=0.2), bb2=randn(EW, scale=0.1))
        return {k: (v.to(dt) if k.startswith("w") else v)
                for k, v in w.items()}

    res = {"root": str(root), "device": smi}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        w = weights(dt, H)
        e = randn(B, L, L, EW).to(dt)
        qkv = randn(B, L, 3 * DH).to(dt)
        n = torch.randint(9, 39, (B,), generator=gen, device=dev)
        mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
        hh = randn(B, L, L, H, scale=3.0).to(dt)
        g = randn(B, L, L, EW).to(dt)
        # K1 and K2, head-major, per-head width dh / h
        d = DH // H
        qa, ka, va = (randn(B, H, L, d, scale=2.0).to(dt) for _ in range(3))
        ea, ga = randn(B, H, L, L).to(dt), randn(B, H, L, L).to(dt)
        fa = (qa, ka, va, ea, ga, (mask - 1.0) * 1e9, None, (-5.0, 5.0))
        draws = att.Draws(123, 0.1, 0.1)
        res[f"K1 train {name}"] = time_ms(
            lambda: att._egt_core_fwd_cuda(*fa, draws))
        res[f"K1 infer {name}"] = time_ms(lambda: att._egt_core_fwd_cuda(*fa))
        ba = (qa, ka, va, ga, fa[5], None,
              att.egt_core_fwd_plain(*fa, draws)[1], randn(B, H, L, d).to(dt),
              randn(B, H, L, L).to(dt), randn(B, H, L), fa[7], draws)
        res[f"K2 {name}"] = time_ms(lambda: att._egt_core_bwd_cuda(*ba))
        res[f"digest K1 train, infer, K2 {name}"] = " ".join(
            digest(x) for x in (att._egt_core_fwd_cuda(*fa, draws),
                                att._egt_core_fwd_cuda(*fa),
                                att._egt_core_bwd_cuda(*ba)))
        for training in (True, False):
            spec = fl.LayerSpec(l=L, ew=EW, h=H, dh=DH, hidden=HID, gated=True,
                                constrained=False, clip=(-5.0, 5.0),
                                edge_act=None, act="elu", scale=0.125 ** 0.5,
                                random_mask_prob=0.1, attn_dropout=0.1,
                                training=training)
            args_ = (spec, e, qkv, mask, None, w, 77, training)
            res[f"K3 {'train' if training else 'infer'} {name}"] = time_ms(
                lambda: fl._fused_layer_cuda(*args_))
        res[f"K4 {name}"] = time_ms(lambda: fl._bwd_tail_cuda(spec, e, hh, g, w))
        tspec = spec._replace(training=True)
        dhh, dm = randn(B, L, L, H).to(dt), randn(B, L, L, EW).to(dt)
        gv = randn(B, L, DH).to(dt)
        res[f"K5 {name}"] = time_ms(lambda: fl._bwd_attn_cuda(
            tspec, e, qkv, mask, None, w, hh, dhh, dm, gv, 77))
        margs = (tspec, e, qkv, mask, None, w, hh, g, gv, 77)
        res[f"K7 {name}"] = time_ms(lambda: fl._bwd_merged_cuda(*margs))
        oargs = (tspec, e, qkv, mask, None, w, g, gv, 77)
        res[f"K6 {name}"] = time_ms(lambda: fl._bwd_mono_cuda(*oargs))
        if hasattr(fl, "_mono_head_cuda"):
            res[f"K6 head {name}"] = time_ms(
                lambda: fl._mono_head_cuda(tspec, e, qkv, w))
        res[f"K4 host us {name}"] = host_us(
            lambda: fl._bwd_tail_cuda(spec, e, hh, g, w))
        res[f"K5 host us {name}"] = host_us(lambda: fl._bwd_attn_cuda(
            tspec, e, qkv, mask, None, w, hh, dhh, dm, gv, 77))
        res[f"K7 host us {name}"] = host_us(
            lambda: fl._bwd_merged_cuda(*margs))
        res[f"K6 host us {name}"] = host_us(
            lambda: fl._bwd_mono_cuda(*oargs))
        hm = randn(B, H, L, L, scale=2.0).to(dt).permute(0, 2, 3, 1)
        tw = {k: w[k] for k in fl.TAIL_KEYS}
        res[f"K9 {name}"] = time_ms(lambda: eb._edge_block_bwd_cuda(hm, e, g, tw))
        rows = hm.contiguous()
        res[f"K8 rows {name}"] = time_ms(
            lambda: eb._edge_block_fwd_cuda(rows, e, tw))
        res[f"K8 head-major {name}"] = time_ms(
            lambda: eb._edge_block_fwd_cuda(hm, e, tw))
        res[f"digest K8 rows, head-major {name}"] = " ".join(
            digest(eb._edge_block_fwd_cuda(x, e, tw)) for x in (rows, hm))
        res[f"digest K3 K4 K5 K7 K6 K9 {name}"] = " ".join(
            digest(x) for x in (
                fl._fused_layer_cuda(tspec, e, qkv, mask, None, w, 77, True),
                fl._bwd_tail_cuda(spec, e, hh, g, w),
                fl._bwd_attn_cuda(tspec, e, qkv, mask, None, w, hh, dhh, dm,
                                  gv, 77),
                fl._bwd_merged_cuda(*margs), fl._bwd_mono_cuda(*oargs),
                eb._edge_block_bwd_cuda(hm, e, g, tw)))
        # K5's general body (and K7 through it): h 32 gated, 2h past 16
        w32 = weights(dt, H32)
        spec32 = tspec._replace(h=H32, scale=float(DH // H32) ** -0.5)
        hh32 = randn(B, L, L, H32, scale=3.0).to(dt)
        dhh32 = randn(B, L, L, H32).to(dt)
        res[f"K5 h32 {name}"] = time_ms(lambda: fl._bwd_attn_cuda(
            spec32, e, qkv, mask, None, w32, hh32, dhh32, dm, gv, 77))
        try:           # an older K7 may refuse the shape (227 KB a block)
            res[f"K7 h32 {name}"] = time_ms(lambda: fl._bwd_merged_cuda(
                spec32, e, qkv, mask, None, w32, hh32, g, gv, 77))
        except ValueError as exc:
            res[f"K7 h32 {name}"] = f"refused ({exc})"
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in res.items() if k.endswith(name)), flush=True)

    # bytes K7's two launches move in bf16, each tensor read or written once
    # per launch: K4's body reads e, hh, g and writes de_mid, dhh in f32;
    # K5's reads e, hh, qkv, gv and the f32 de_mid, dhh, writes de, dq and
    # the f32 dk, dv. The f32 hand-off is written once and read once.
    pairs, it = B * L * L, 2
    handoff = pairs * (EW + H) * 4
    tail = pairs * (2 * EW + H) * it + handoff
    attn = (pairs * (2 * EW + H) + B * L * 5 * DH) * it + handoff + \
        2 * B * L * DH * 4
    res["K7 hand-off MB written + read"] = 2 * handoff / 1e6
    res["K7 composition MB"] = (tail + attn) / 1e6
    res["K7 composition floor ms at 3.35 TB/s"] = (tail + attn) / 3.35e9
    # K6 adds its head kernel (e, q and k in; hh in f32, rnd(hh) and one
    # flag byte a (pair, head) out), and its K5 body reads hh in f32 (2
    # bytes more a value than K7's) and the flags
    head = (pairs * EW + B * L * 2 * DH) * it + pairs * H * (4 + it + 1)
    mono = tail + attn + head + pairs * H * (4 - it + 1)
    res["K6 head MB"] = head / 1e6
    res["K6 composition MB"] = mono / 1e6
    res["K6 composition floor ms at 3.35 TB/s"] = mono / 3.35e9

    config = root / "configs" / "main" / "zinc" / "500k" / "egt.json"
    raw = json.loads(config.read_text())
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    rng = np.random.default_rng(1)
    batches = [synthetic.zinc_batch(rng, B, L) for _ in range(STEPS + 2)]
    path_b = {"use_pallas": True, "use_pallas_layer": False}
    path_c = {**path_b, "use_pallas_edge": True}
    for tag, over, impl in (("train A", {}, "split"),
                            ("train B", path_b, "split"),
                            ("train C", path_c, "split"),
                            ("train A-merged", {}, "merged"),
                            ("train A-mono", {}, "mono")):
        fl.BWD_IMPL = impl
        tr = load_trainer({**raw, **over}, flat)
        for bt in batches[:2]:
            tr.train_step(bt)                           # warm-up
        times = []
        for bt in batches[2:]:
            t = time.perf_counter()
            tr.train_step(bt)                           # ends in .item()
            times.append(time.perf_counter() - t)
        res[f"{tag} step ms"] = 1e3 * statistics.median(times)
    fl.BWD_IMPL = "split"
    for tag, over in (("serve A", {}), ("serve B", path_b),
                      ("serve C", path_c)):
        predict = serving.load_predictor({**raw, **over}, flat)
        predict(batches[0])
        times = []
        for bt in batches[2:]:
            t = time.perf_counter()
            predict(bt)                                 # returns host numpy
            times.append(time.perf_counter() - t)
        res[f"{tag} request ms"] = 1e3 * statistics.median(times)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
