"""How far the bf16 training paths drift from the f32 plain path.

    python -m egt_torch.precision_drift [--config PATH] [--depths 16 8 4]
        [--graphs 32] [--pad 128] [--seeds 40 41]

For a run config (PATTERN-500k `egt_epe` by default) at each depth: seeded
weights (`synthetic.random_flat_params`) and 3 synthetic batches of
`--graphs` graphs with the config's positional encoding
(`synthetic.add_pe`; PATTERN / CLUSTER graphs of the length bucket `--pad`,
ZINC at 40, MNIST / CIFAR10 at their pads), then 3 Adam steps from the same
weights on the same batches three times: the plain path in f32 (the
reference), the plain path in bf16, and path A (the whole-layer kernels) in
bf16, the draws of each step alike. Prints the f32 losses and, for each
bf16 path against the f32 one and for the two bf16 paths against each
other, the largest relative difference of the 3 losses and the largest
normalised step-1 gradient difference, max |a - b| over max(max |b|, 1e-2
G) with G the largest f32 gradient (`chip_smoke.py`'s agreement measure).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from . import schemes, synthetic
from .training.steps import load_trainer

DEFAULT = (Path(__file__).resolve().parents[1] / "configs" / "main"
           / "pattern" / "500k" / "egt_epe.json")
PLAIN = {"use_pallas": False, "use_pallas_layer": False}


def batches(raw: dict, rng, graphs: int, pad: int, n: int = 3) -> list:
    """`n` synthetic batches for a run config, with its PE."""
    c = schemes.resolve_config(raw)
    ds = c.scheme.partition(".")[0]
    if ds in synthetic.SUPERPIXEL:
        return [synthetic.superpixel_batch(rng, graphs, ds) for _ in range(n)]
    if ds == "zinc":
        out = [synthetic.zinc_batch(rng, graphs, 40) for _ in range(n)]
    else:
        above = max([b for b in c.length_buckets if b < pad], default=0)
        out = [synthetic.sbm_batch(rng, graphs, pad, ds, above)
               for _ in range(n)]
    if c.get("use_svd", False):
        return [synthetic.add_pe(b, "svd", c.num_svd_features) for b in out]
    if c.get("use_eig", False):
        return [synthetic.add_pe(b, "eig", c.num_eig_features) for b in out]
    return out


def run(raw: dict, flat: dict, bs: list, overrides: dict, dtype: str):
    """Losses of len(bs) steps and the step-1 gradients."""
    tr = load_trainer({**raw, **overrides, "compute_dtype": dtype}, flat)
    losses, grads = [], None
    for i, b in enumerate(bs):
        losses.append(tr.train_step(b)["loss"])
        if i == 0:
            grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()
                     if p.grad is not None}
    return losses, grads


def drift(a, b, top: float) -> tuple[float, float]:
    """(largest relative loss difference, largest normalised step-1
    gradient difference) of run `a` from run `b`."""
    dl = max(abs(x - y) / max(abs(y), 1e-6) for x, y in zip(a[0], b[0]))
    dg = max(float((a[1][k] - g).abs().max())
             / max(float(g.abs().max()), 1e-2 * top) for k, g in b[1].items())
    return dl, dg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(DEFAULT))
    ap.add_argument("--depths", type=int, nargs="+", default=[16, 8, 4])
    ap.add_argument("--graphs", type=int, default=32)
    ap.add_argument("--pad", type=int, default=128,
                    help="length bucket of PATTERN / CLUSTER graphs")
    ap.add_argument("--seeds", type=int, nargs="+", default=[40, 41],
                    help="seeds of the batches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("precision_drift needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = json.loads(Path(args.config).read_text())
    for depth in args.depths:
        raw = {**base, "model_height": depth}
        flat = synthetic.random_flat_params(
            schemes.model_config_from_config(raw), seed=3)
        for seed in args.seeds:
            bs = batches(raw, np.random.default_rng(seed), args.graphs,
                         args.pad)
            ref = run(raw, flat, bs, PLAIN, "float32")
            plain = run(raw, flat, bs, PLAIN, "bfloat16")
            kern = run(raw, flat, bs, {}, "bfloat16")
            top = max(float(g.abs().max()) for g in ref[1].values())
            cols = [("plain bf16 - f32", drift(plain, ref, top)),
                    ("path A bf16 - f32", drift(kern, ref, top)),
                    ("path A bf16 - plain bf16", drift(kern, plain, top))]
            print(f"{Path(args.config).name} depth {depth}, {args.graphs} "
                  f"graphs, batch seed {seed}: f32 losses "
                  f"{[round(x, 5) for x in ref[0]]}; " + "; ".join(
                      f"{name}: loss {dl:.4g}, gradient {dg:.4g}"
                      for name, (dl, dg) in cols), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
