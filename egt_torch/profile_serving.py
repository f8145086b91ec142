"""Where a serving request's time goes on the card.

    python -m egt_torch.profile_serving [--path A|B|C] [--requests N]
        [--scheme zinc|pattern|cluster|mnist|cifar10|tsp|pcqm4mv2]
        [--pad L] [--config PATH] [--graphs N]

Serves the 500k config of a scheme (the flagship ZINC by default; for
MNIST and CIFAR10 the 100k `egt_spe_do` config: the SVD PE and the
distance head; for PCQM4Mv2 EGT-Large, `configs/pcqm4mv2/egt_large.json`)
with seeded weights on synthetic requests (see `egt_torch.synthetic`) of
128 graphs (TSP: 24, its prediction batch; PCQM4Mv2: 1,024, its batch):
ZINC padded to 40, PATTERN / CLUSTER graphs of one length bucket, `--pad`
192 by default, 128 the other, MNIST / CIFAR10 superpixel graphs with
their SVD PE at their pads, 75 and 150, TSP graphs of one length bucket,
`--pad` 512 by default, 128 or 256 the others, PCQM4Mv2-like molecules
padded as the reader pads them, `--pad` 32 by default (l 36 with EGT-Large's
4 virtual nodes; 56, whose molecules reach 56 atoms, is the real data's);
`--config` serves another
config on the scheme's requests, for example `--scheme tsp --config
configs/ablation/egt_simple/tsp/500k/egt_simple.json`) under
`torch.profiler` and
prints the wall time per request, the device-busy time per request and
the device's idle share, then the operators ranked by device time. Path A
is the config as shipped (whole-layer kernel); path B sets use_pallas true
and use_pallas_layer false (attention kernel); path C also sets
use_pallas_edge true (attention kernel, then the edge-block kernel).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import schemes, serving, synthetic

_MAIN = Path(__file__).resolve().parents[1] / "configs" / "main"
CONFIGS = {**{kind: _MAIN / kind / "500k" / "egt.json"
              for kind in ("zinc", "pattern", "cluster", "tsp")},
           **{kind: _MAIN / kind / "100k" / "egt_spe_do.json"
              for kind in ("mnist", "cifar10")},
           "pcqm4mv2": _MAIN.parent / "pcqm4mv2" / "egt_large.json"}
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


def workload(scheme: str, path: str, pad: int | None,
             config: str | None = None):
    """(run config, fn(rng, n, graphs) -> batches) of a scheme's config
    (`CONFIGS`, or the file `config`) on a path: ZINC padded to `pad` (40),
    PATTERN / CLUSTER (TSP) graphs of the length bucket `pad` (192; TSP
    512), more nodes than the next smaller bucket, MNIST / CIFAR10
    superpixel graphs at their pad, or PCQM4Mv2-like molecules of up to
    `pad` (32) atoms."""
    path_k = Path(config) if config else CONFIGS[scheme]
    raw = {**json.loads(path_k.read_text()), **PATHS[path]}
    if scheme in synthetic.SUPERPIXEL:
        return raw, lambda rng, n, graphs: [
            synthetic.superpixel_batch(rng, graphs, scheme)
            for _ in range(n)]
    if scheme == "zinc":
        return raw, lambda rng, n, graphs: [
            synthetic.zinc_batch(rng, graphs, pad or 40) for _ in range(n)]
    if scheme == "pcqm4mv2":
        return raw, lambda rng, n, graphs: [
            synthetic.pcqm_batch(rng, graphs, pad or synthetic.PCQM_NODES[1])
            for _ in range(n)]
    pad = pad or (512 if scheme == "tsp" else 192)
    buckets = schemes.resolve_config(raw).length_buckets
    above = max([b for b in buckets if b < pad], default=0)
    if scheme == "tsp":
        return raw, lambda rng, n, graphs: [
            synthetic.tsp_batch(rng, graphs, pad, above) for _ in range(n)]
    return raw, lambda rng, n, graphs: [
        synthetic.sbm_batch(rng, graphs, pad, scheme, above)
        for _ in range(n)]


def add_workload_args(ap) -> None:
    ap.add_argument("--path", choices=sorted(PATHS), default="A")
    ap.add_argument("--scheme", choices=sorted(CONFIGS), default="zinc")
    ap.add_argument("--pad", type=int, default=None,
                    help="pad length (zinc 40; pattern, cluster: the length "
                         "bucket, 192 or 128; tsp: 512, 256 or 128; mnist, "
                         "cifar10: theirs; pcqm4mv2: 32, a multiple of 8, "
                         "before the virtual nodes)")
    ap.add_argument("--config", default=None,
                    help="run config to use in place of the scheme's (the "
                         "scheme still makes the batches)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_workload_args(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--graphs", type=int, default=None,
                    help="graphs a request (128; tsp 24; pcqm4mv2 1024)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")

    raw, make = workload(args.scheme, args.path, args.pad, args.config)
    if args.graphs is None:
        # TSP's prediction batch (batch size 8 x prediction_bmult 3),
        # PCQM4Mv2's batch
        c = schemes.resolve_config(raw)
        args.graphs = {"tsp": c.batch_size * c.prediction_bmult,
                       "pcqm4mv2": c.batch_size}.get(args.scheme, 128)
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    predict = serving.load_predictor(raw, flat)
    reqs = make(np.random.default_rng(1), args.requests, args.graphs)
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
    print(f"{args.config or args.scheme} path {args.path}, pad "
          f"{reqs[0]['graph_matrix'].shape[1]}: {args.requests} requests x "
          f"{args.graphs} graphs, wall {wall * 1e3:.3f} ms/request, device busy "
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
