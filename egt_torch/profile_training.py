"""Where a training step's time goes on the card.

    python -m egt_torch.profile_training [--path A|B|C]
        [--scheme zinc|pattern|cluster|mnist|cifar10|tsp|pcqm4mv2] [--pad L]
        [--config PATH] [--accum A]

Trains the config of a scheme (the flagship ZINC 500k by default; the SBM
and TSP 500k, the superpixel 100k `egt_spe_do`; seeded weights, STEPS
synthetic batches of the config's batch size, 128 graphs, TSP's 8, taken
as `--accum` microbatches a step (PCQM4Mv2 EGT-Large: its batch of 1,024
as 8 x 128, `--accum 8`): ZINC
padded to 40, PATTERN / CLUSTER graphs of one length bucket, `--pad` 192
by default, MNIST / CIFAR10 at 75 / 150, TSP graphs of one length
bucket, `--pad` 512 by default, PCQM4Mv2-like molecules at pad 32 by
default; see `egt_torch.synthetic` and
`profile_serving.workload`; `--config` trains another config on the
scheme's batches, for example `--scheme zinc --config
configs/ablation/egt_simple/zinc/500k/egt_simple.json`) and prints the wall time per step (without
the profiler, which slows the host), the device-busy time per step under
`torch.profiler` and the device's idle share (1 - busy / wall), then the
operators ranked by device time. Path A is the config as shipped
(whole-layer kernel K3 forward; backward K4 and K5, or K7 with
EGT_FUSED_BWD=merged, or K6 with EGT_FUSED_BWD=mono); path B sets
use_pallas true and use_pallas_layer false (attention kernels K1 forward,
K2 backward); path C also sets use_pallas_edge true (K1 then the edge
block K8 forward; K9 then K2 backward). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import schemes, synthetic
from .ops import fused_layer
from .profile_serving import add_workload_args, device_kernels, workload
from .training import metrics as M
from .training.steps import load_trainer

STEPS = 6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_workload_args(ap)
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatches the config's batch is split into")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")

    raw, make = workload(args.scheme, args.path, args.pad, args.config)
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    trainer = load_trainer(raw, flat)
    A = args.accum
    graphs = schemes.resolve_config(raw).batch_size // A
    batches = make(np.random.default_rng(1), STEPS * A, graphs)
    groups = [batches[i * A:(i + 1) * A] for i in range(STEPS)]

    def step(group):
        if A == 1:
            trainer.train_step(group[0])             # ends in .item(): synced
        else:
            trainer.train_into(M.DeviceAccumulator(), group)
            torch.cuda.synchronize()

    for g in groups[:2]:
        step(g)                                      # warm-up
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        for g in groups:
            step(g)
        return (time.perf_counter() - t0) / STEPS

    wall = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = run()
    kernels = device_kernels(prof)
    busy = sum(us for us, _ in kernels.values()) / 1e6 / STEPS
    print(f"{args.config or args.scheme} path {args.path}, pad "
          f"{batches[0]['graph_matrix'].shape[1]} (whole-layer backward "
          f"{fused_layer.BWD_IMPL}): {STEPS} steps x {A} x {graphs} graphs, "
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
