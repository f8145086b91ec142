"""The reference's training steps: the loss of each micro-batch, gradients
averaged over a step's micro-batches, clipped element-wise, and Adam
(beta 0.9 / 0.999, eps 1e-7 outside the square root) at the step's rate.

Per step it returns the loss (the mean of its micro-batches' losses), and
it keeps the predictions of the first micro-batch, the gradient of the
first step and the parameters' change over all the steps, per leaf, for
`compare.py`. `rates` works out each step's learning rate from the run
config.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .model import Forward, Spec, loss_terms

BETA1, BETA2, EPS = 0.9, 0.999, 1e-7


def rates(run_config: dict, n: int) -> list[float]:
    """The learning rates of steps 0 .. n - 1: a linear warm-up from 0 to
    `initial_lr` over `warmup_steps` (evaluated at step + 1), then a
    cosine to 0 at `total_steps`; `initial_lr` without a warm-up."""
    hi = float(run_config["initial_lr"])
    warm = int(run_config.get("warmup_steps") or 0)
    total = run_config.get("total_steps")
    out = []
    for t in range(n):
        if warm and t < warm:
            out.append(hi * (t + 1) / warm)
        elif warm and total is not None:
            w = 0.5 * math.pi / (int(total) - warm)
            out.append(hi * math.cos(w * (t - warm)))
        else:
            out.append(hi)
    return out


def layer_seeds(base: int, step: int, micro: int | None, height: int):
    tags = (step,) if micro is None else (step, micro)
    return [rng.fold_seed(base, *tags, 1000 + i) for i in range(height)]


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def run_steps(spec: Spec, params: dict, steps: list, lrs: list, seed: int,
              clip: float, device, precision: str = "float32",
              chunk: int | None = None, fault: str | None = None) -> dict:
    """`steps`: per step, its list of micro-batches (numpy dicts). `seed`:
    the run config's seed (the draws' base seed is fold(seed + 1)).
    `chunk` splits a micro-batch into row blocks that share its loss's
    denominator. `fault` "half_batch" leaves the second half of every
    micro-batch out and takes the mean over the rest.

    Returns {"losses": [...], "count": the graphs or nodes the loss
    counted over all steps, "logits1": the first micro-batch's
    predictions (numpy), "grad": {leaf: |g_1|}, "change": {leaf:
    |p_n - p_0|}} with leaves by flat name."""
    base = rng.fold_seed(int(seed) + 1)
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in P.items()}
    fwd = Forward(spec, P, precision)
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses, grad1, count, logits1 = [], None, 0.0, []
    for t, (micros, lr) in enumerate(zip(steps, lrs)):
        grads = {k: torch.zeros_like(v) for k, v in P.items()}
        seen = set()
        loss_sum = 0.0
        accum = len(micros) > 1
        for mi, mb in enumerate(micros):
            seeds = layer_seeds(base, t, mi if accum else None, spec.height)
            batch = _to(mb, device)
            b = batch["sample_mask"].shape[0]
            if fault == "half_batch":
                sm = batch["sample_mask"].clone()
                sm[b // 2:] = 0.0
                batch["sample_mask"] = sm
            cs = chunk or b
            denom = _count(spec, batch)
            count += float(denom)
            mb_loss = 0.0
            for b0 in range(0, b, cs):
                part = {k: v[b0:b0 + cs] for k, v in batch.items()}
                pred = fwd(part, seeds, b0)
                if t == 0 and mi == 0:
                    logits1.append(pred.detach().cpu().numpy())
                s, _ = loss_terms(spec, pred, part)
                loss = s / torch.clamp(denom, min=1.0)
                gs = torch.autograd.grad(
                    loss, list(P.values()), allow_unused=True)
                for (k, _), g in zip(P.items(), gs):
                    if g is not None:
                        grads[k] += g
                        seen.add(k)
                mb_loss += float(loss.detach())
            loss_sum += mb_loss
        losses.append(loss_sum / len(micros))
        with torch.no_grad():
            for k in seen:
                g = torch.clamp(grads[k] / len(micros), -clip, clip)
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                mh = m[k] / (1 - BETA1 ** (t + 1))
                vh = v2[k] / (1 - BETA2 ** (t + 1))
                P[k].sub_(lr * mh / (torch.sqrt(vh) + EPS))
            if grad1 is None:
                grad1 = {k: float(torch.linalg.vector_norm(
                    m[k].double() / (1 - BETA1))) for k in P}
    change = {k: float(torch.linalg.vector_norm((P[k].detach() - p0[k])
                                                .double())) for k in P}
    return {"losses": losses, "count": count, "grad": grad1,
            "change": change, "logits1": np.concatenate(logits1),
            "lrs": list(lrs)}


def _count(spec: Spec, batch: dict) -> torch.Tensor:
    """The loss's denominator over a whole micro-batch."""
    sm = batch["sample_mask"].float()
    if spec.loss == "mae":
        return sm.sum() * batch["target"].shape[-1]
    return ((batch["node_features"] >= 0).float() * sm[:, None]).sum()
