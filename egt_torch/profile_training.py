"""Where a training step's time goes on the card.

    python -m egt_torch.profile_training [--path A|B]

Trains the flagship ZINC-500k config (seeded weights, STEPS synthetic batches
of GRAPHS graphs, the config's batch size; see `egt_torch.synthetic`) and
prints the wall time per step
(without the profiler, which slows the host), the device-busy time per step
under `torch.profiler` and the device's idle share (1 - busy / wall), then
the operators ranked by device time. Path A is the config as
shipped (whole-layer kernels K3 forward, K4 and K5 backward); path B sets
use_pallas true and use_pallas_layer false (attention kernels K1 forward, K2
backward). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import schemes, synthetic
from .profile_serving import CONFIG, PATHS, device_kernels
from .training.steps import load_trainer

STEPS, GRAPHS = 6, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="A")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")

    raw = {**json.loads(CONFIG.read_text()), **PATHS[args.path]}
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    trainer = load_trainer(raw, flat)
    rng = np.random.default_rng(1)
    batches = [synthetic.zinc_batch(rng, GRAPHS) for _ in range(STEPS)]
    for b in batches[:2]:
        trainer.train_step(b)                        # warm-up
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(b)                    # ends in .item(): synced
        return (time.perf_counter() - t0) / STEPS

    wall = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = run()
    kernels = device_kernels(prof)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / STEPS
    print(f"path {args.path}: {STEPS} steps x {GRAPHS} graphs, "
          f"wall {wall * 1e3:.3f} ms/step ({wall_prof * 1e3:.3f} under the "
          f"profiler), device busy {busy * 1e3:.3f} ms/step, device idle "
          f"share {max(0.0, 1 - busy / wall):.3f}")
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"{us / 1e3 / STEPS:14.4f} "
              f"{us / 1e6 / STEPS / busy:6.3f} "
              f"{n / STEPS:10.1f}  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
