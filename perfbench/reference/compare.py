"""The numbers that decide `correct`.

Training (three steps from the same weights, batches and draws):
- `loss`: the largest gap of a step's loss, relative to the reference's;
  `loss1` the first step's alone;
- `logits1`: the largest |program - reference| over the first
  micro-batch's predictions of its real graphs or nodes, as `pred` below;
- `lr`: the largest gap of a step's learning rate as the optimizer held
  it from the rate the reference works out from the run config, relative;
- `count`: the gap of the graphs or nodes the loss counted over the steps
  (the scheme's (sum, count) pair), relative: exact;
- `grad`: the worst leaf's gap between the norms of the first step's
  gradient as the optimizer took it, over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
- `change`: the same of the norm of each leaf's change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of `grad` and `change`: no loss reaches them (the
final edge norm under a node or graph readout) or only round-off does
(a key's bias under softmax), and Adam moves such a leaf by round-off.

Serving: `pred`, the largest |program - reference| over the predictions
of the real graphs (graph readout) or of the real nodes (node readout)
of the requests compared; `pred_rel` the same over the root mean square
of the reference's predictions of the request (the largest over the
requests).
"""

from __future__ import annotations

import statistics

import numpy as np

LEAF_FLOOR = 1e-3


def counted_leaves(ref_grad: dict) -> list[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= LEAF_FLOOR * med)


def _leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in leaves}


def train_numbers(prog: dict, ref: dict, first: dict | None = None) -> dict:
    """prog / ref: {"losses", "count", "grad", "change", "lrs"} and, with
    `first` (the first micro-batch, numpy), "logits1" (see
    `train.run_steps`).
    Besides the numbers above, the first step's loss gap (`loss1`), the
    median leaf's gaps (`grad_median`, `change_median`) and the worst
    leaves' names, for the readings the limits are set from."""
    leaves = counted_leaves(ref["grad"])
    gaps = [abs(p - r) / max(abs(r), 1e-12)
            for p, r in zip(prog["losses"], ref["losses"])]
    out = {"loss": max(gaps), "loss1": gaps[0],
           "count": abs(prog["count"] - ref["count"]) / ref["count"],
           "lr": max(abs(p - r) / r for p, r in zip(prog["lrs"], ref["lrs"]))}
    if first is not None:
        out["logits1"] = serve_gap(prog["logits1"], ref["logits1"], first)
    for key in ("grad", "change"):
        g = _leaf_gaps(prog[key], ref[key], leaves)
        worst = max(g, key=g.get)
        out[key] = g[worst]
        out[f"{key}_median"] = statistics.median(g.values())
        out[f"{key}_leaf"] = worst
    return out


def _real(pred, ref, batch):
    """(pred, ref) of the request's real graphs or nodes, or None where
    the shapes differ."""
    pred = np.asarray(pred, np.float64)
    ref = np.asarray(ref, np.float64)
    if pred.shape != ref.shape:
        return None
    sm = np.asarray(batch["sample_mask"]) > 0
    if pred.ndim == 2:
        return pred[sm], ref[sm]
    nf = np.asarray(batch["node_features"])
    valid = (nf if nf.ndim == 2 else nf[..., 0]) >= 0
    valid &= sm[:, None]
    return pred[valid], ref[valid]


def serve_gap(pred: np.ndarray, ref: np.ndarray, batch: dict) -> float:
    """The largest |pred - ref| over the request's real graphs or nodes."""
    return serve_numbers(pred, ref, batch)["pred"]


def serve_numbers(pred: np.ndarray, ref: np.ndarray, batch: dict) -> dict:
    """`pred` and `pred_rel` of one request."""
    real = _real(pred, ref, batch)
    if real is None:
        return dict.fromkeys(("pred", "pred_rel"), float("inf"))
    p, r = real
    scale = max(float(np.sqrt(np.mean(r ** 2))), 1e-12)
    gap = float(np.abs(p - r).max())
    return {"pred": gap, "pred_rel": gap / scale}


def worst(numbers: list[dict]) -> dict:
    """Each number's largest over requests."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]}); a number
    that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and bool(good)
        out[name] = [v, limit]
    return ok, out
