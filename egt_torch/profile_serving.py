"""Where a serving request's time goes on the card.

    python -m egt_torch.profile_serving [--path A|B|C] [--requests N]

Serves the flagship ZINC-500k config (seeded weights, synthetic 128-graph
requests; see `egt_torch.synthetic`) under `torch.profiler` and prints the
wall time per request, the device-busy time per request and the device's
idle share, then the operators ranked by device time. Path A is the config as
shipped (whole-layer kernel); path B sets use_pallas true and
use_pallas_layer false (attention kernel); path C also sets use_pallas_edge
true (attention kernel, then the edge-block kernel). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import schemes, serving, synthetic

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "main" / "zinc" \
    / "500k" / "egt.json"
PATHS = {"A": {}, "B": {"use_pallas": True, "use_pallas_layer": False},
         "C": {"use_pallas": True, "use_pallas_layer": False,
               "use_pallas_edge": True}}


def device_kernels(prof) -> dict[str, tuple[float, int]]:
    """{kernel / copy name: (device microseconds, count)} of a profile.
    User annotations on the device timeline (for example the optimizer's
    `Optimizer.step` range) span kernels already counted, so they are left
    out."""
    out: dict[str, tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="A")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--graphs", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")

    raw = {**json.loads(CONFIG.read_text()), **PATHS[args.path]}
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    predict = serving.load_predictor(raw, flat)
    rng = np.random.default_rng(1)
    reqs = [synthetic.zinc_batch(rng, args.graphs)
            for _ in range(args.requests)]
    for r in reqs[:2]:
        predict(r)                                   # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            predict(r)
        wall = (time.perf_counter() - t0) / args.requests
    kernels = device_kernels(prof)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / args.requests
    print(f"path {args.path}: {args.requests} requests x {args.graphs} "
          f"graphs, wall {wall * 1e3:.3f} ms/request, device busy "
          f"{busy * 1e3:.3f} ms/request, device idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    print(f"{'device ms/req':>14} {'share':>6} {'calls/req':>9}  kernel")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"{us / 1e3 / args.requests:14.4f} "
              f"{us / 1e6 / args.requests / busy:6.3f} "
              f"{n / args.requests:9.1f}  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
