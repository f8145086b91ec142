"""Learning-rate schedules and the reduce-on-plateau state machine.

The port's own copy of `egt_tpu/training/schedules.py`.

Host-side, epoch/step granular, mirroring the reference's semantics:

  * `warmup_cosine_lr` mirrors `WarmUpAndCosine` (`lib/base/genutil/warmup.py:41-69`):
    linear ramp min_lr -> max_lr over `warmup_steps` (evaluated at step+1), then
    `min_lr + span * cos(0.5*pi*(step - warmup)/(total - warmup))` until `total_steps`,
    after which training stops.
  * `PlateauState` mirrors the save-best + ReduceLROnPlateau + stop-on-min-lr logic in
    `TrainingBase.get_state_updates` (`lib/training/training_base.py:133-181`): lr is
    halved (rlr_factor) when the monitored value hasn't improved for `patience` epochs
    since max(best_epoch, last_reduce_epoch), floored at `min_lr`; training stops when
    lr falls below `stopping_lr`.

All state lives in a plain dict so it round-trips through checkpoints unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def warmup_cosine_lr(step: int, *, warmup_steps: int, max_lr: float,
                     min_lr: float = 0.0, total_steps: int | None = None):
    """Returns (lr or None, stop). None means "leave lr unchanged" (past total or no
    schedule active), matching the callback's conditional assignment."""
    span = max_lr - min_lr
    if warmup_steps > 0 and step < warmup_steps:
        return min_lr + span * (step + 1) / warmup_steps, False
    if total_steps is not None:
        if step <= total_steps:
            w = 0.5 * math.pi / (total_steps - warmup_steps)
            return min_lr + span * math.cos(w * (step - warmup_steps)), False
        return None, True
    return None, False


@dataclass
class PlateauConfig:
    monitor: str = "val_loss"
    rlr_factor: float = 0.5
    rlr_patience: int = 10
    min_lr: float = 0.0
    stopping_lr: float = 0.0
    save_best: bool = True


def default_plateau_state() -> dict:
    return {
        "save_best_value": float("inf"),
        "save_best_epoch": 0,
        "last_reduce_lr": 0,
    }


def plateau_update(state: dict, cfg: PlateauConfig, lr: float, epoch: int,
                   logs: dict, log_fn=print):
    """One epoch-end update. Mutates `state`; returns (new_lr, improved, stop)."""
    value = logs.get(cfg.monitor, float("inf"))
    old_value = state["save_best_value"]
    old_epoch = state["save_best_epoch"]
    improved = value < old_value
    stop = False

    if improved:
        state["save_best_value"] = float(value)
        state["save_best_epoch"] = int(epoch)
        log_fn(f"SAVE BEST: {cfg.monitor} improved from "
               f"(epoch:{old_epoch},value:{old_value:0.5f}) to "
               f"(epoch:{epoch},value:{value:0.5f})")
    else:
        log_fn(f"SAVE BEST: {cfg.monitor} did NOT improve from "
               f"(epoch:{old_epoch},value:{old_value:0.5f})")
        if cfg.rlr_factor < 1.0:
            gap = epoch - max(old_epoch, state["last_reduce_lr"])
            if gap >= cfg.rlr_patience:
                lr = max(lr * cfg.rlr_factor, cfg.min_lr)
                state["last_reduce_lr"] = int(epoch)
                log_fn(f"RLR: {cfg.monitor} did NOT improve for {gap} epochs, "
                       f"new lr = {lr}")

    if lr < cfg.stopping_lr:
        stop = True
        log_fn(f"STOP: lr fell below {cfg.stopping_lr}, STOPPING TRAINING!")

    return lr, improved, stop
