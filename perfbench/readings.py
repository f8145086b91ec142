"""The readings the limits of `correct` are set from, on the chip.

    python3 -m perfbench.readings --workload <cell> --seeds 1,2,3 [--program] [--control] [--rates r1,r2]

`--program` runs the cell once a seed (a short window) and prints the
numbers its check compared. `--control` puts the reference, computed in
float8 (forward values rounded to e4m3, the step below the bfloat16 the
configurations state), in the program's place and prints its numbers
against the float32 reference; for a training cell also those of a step
that leaves half of every micro-batch out and takes the mean over the
rest. (A step that returns its state unchanged reads 1 on `change` by
its definition.) `--rates` runs a serving cell once a seed at each offered
rate (requests a second), for the sweep that finds the highest rate the
program sustains. One JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import harness, traffic
from .reference import batch as rbatch
from .reference import compare, model as rmodel, rng, train as rtrain


def control_train(cell, seed: int, device) -> dict:
    from .train import check_batches
    spec = rmodel.Spec.from_dict(cell.config["reference"])
    rc = cell.config["run_config"]
    cfg_seed = seed % 2 ** 62
    recs = traffic.records(cell.traffic["generator"], cell.traffic["groups"],
                           np.random.default_rng([cfg_seed, 2]))
    n = int(cell.traffic["check_steps"])
    steps = check_batches(cell, recs, cfg_seed, n)
    lrs = rtrain.rates(rc, n)
    w = rmodel.init_params(spec, rng.fold_seed(cfg_seed, 1), device)
    kw = dict(clip=float(rc.get("gradient_clipval") or 1e30), device=device,
              chunk=cell.config.get("reference_chunk"))
    ref = rtrain.run_steps(spec, w, steps, lrs, cfg_seed, **kw)
    out = {}
    for name, extra in (("control", {"precision": "float8"}),
                        ("half_batch", {"fault": "half_batch"})):
        got = rtrain.run_steps(spec, w, steps, lrs, cfg_seed, **kw, **extra)
        out[name] = compare.train_numbers(got, ref, steps[0][0])
    return out


def control_serve(cell, seed: int, device) -> dict:
    spec = rmodel.Spec.from_dict(cell.config["reference"])
    cfg_seed = seed % 2 ** 62
    w = rmodel.init_params(spec, rng.fold_seed(cfg_seed, 1), device)
    chunk = int(cell.config.get("reference_chunk") or 1 << 30)
    r = np.random.default_rng([cfg_seed, 2])
    gaps = []
    for req in cell.traffic["pool"]:
        recs = traffic.records(cell.traffic["generator"], req["groups"], r)
        b = rbatch.collate(recs, len(recs), int(req["pad"]))
        t = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        preds = []
        for prec in ("float32", "float8"):
            f = rmodel.Forward(spec, w, prec)
            with torch.no_grad():
                preds.append(torch.cat(
                    [f({k: v[s:s + chunk] for k, v in t.items()})
                     for s in range(0, len(recs), chunk)]).cpu().numpy())
        gaps.append(compare.serve_numbers(preds[1], preds[0], b))
    return {"control": compare.worst(gaps)}


def sweep(name: str, seed: int, rate: float, seconds: float) -> dict:
    """One run of serving cell `name` offered `rate` requests a second."""
    from . import run

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "perfbench"
        shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(
            "tests", "__pycache__"))
        cell = harness.load_json(root / "workloads" / f"{name}.json")
        cell["traffic"]["rate"] = rate
        cell["end_to_end"] = ["serve_graphs_per_s", "serve_latency_p95_ms"]
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        line = run.run_cell(name, seed, seconds, False, root=root)
    return {k: v["value"] for k, v in line["metrics"].items()} | {
        "requests": line["attempted"], "correct": line["correct"]}


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            line = run.run_cell(args.workload, seed, args.seconds, False,
                                readings=True)
            print(json.dumps({"seed": seed, "program": line["readings"],
                              "correct": line["correct"]}), flush=True)
        for rate in filter(None, args.rates.split(",")):
            print(json.dumps({"seed": seed, "rate": float(rate),
                              **sweep(args.workload, seed, float(rate),
                                      args.seconds)}), flush=True)
        if args.control:
            fn = control_train if cell.mode == "train" else control_serve
            print(json.dumps({"seed": seed, **fn(cell, seed, dev)}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
