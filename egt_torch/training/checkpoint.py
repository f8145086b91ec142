"""Checkpoints and weight snapshots.

Port of `egt_tpu/training/checkpoint.py`:

  * flat-npz weight snapshots under the JAX flat names (`save_weights`,
    `load_weights`, through `egt_torch/weights.py`), readable by either
    package: the way weights move between the two;
  * `latest_epoch_snapshot`, the `weight_file ":"` lookup;
  * `SaveWhen`, the 'event;cond;format' snapshot rule of the reference's
    `SaveWhenCallback` (`checkpoint.py:86-138`);
  * `TrainCheckpointer`, the resumable training checkpoint. The JAX package
    keeps it with orbax; here it is one `torch.save` of the model's and the
    optimizer's state dicts, `ckpt_<epoch>.pt`, beside a JSON sidecar
    `train_state_<epoch>.json` with the same keys as the JAX package's (epoch,
    global step, plateau state, lr). One checkpoint is kept (max_to_keep=1);
    each file is written to a temporary name, then moved into place. The
    checkpoint is the port's own: the JAX package does not read it.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from ..weights import flat_arrays, load_npz


# ----------------------------------------------------------- flat weight snapshots


def save_weights(model, path: str) -> None:
    """Weight-only snapshot (flat npz under the JAX names), the `.h5` analog."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat_arrays(model))
    os.replace(tmp, path)


def load_weights(model, path: str):
    """Load a flat npz (written by either package) into `model`; every name
    and shape must match."""
    return load_npz(model, path)


def latest_epoch_snapshot(saved_dir: str) -> str:
    """Find the newest `...epochNNNN.npz` snapshot, mirroring
    `TrainingBase.get_latest_save_file` (`training_base.py:375-388`)."""
    pattern = re.compile(r"(?<=epoch)[0-9]+")
    cur_epoch, cur_file = 0, ""
    d = Path(saved_dir)
    if d.is_dir():
        for fp in d.glob("*.npz"):
            m = pattern.search(fp.name)
            e = 0 if m is None else int(m.group())
            if e > cur_epoch:
                cur_epoch, cur_file = e, str(fp)
    return cur_file


# --------------------------------------------------------------- training checkpoint


class TrainCheckpointer:
    """The resumable checkpoint of {model, optimizer} and the host-side
    training state, in `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.directory.glob("ckpt_*.pt"))

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer, train_state: dict) -> None:
        """`optimizer`: an `optim.Optimizer`."""
        path = self.directory / f"ckpt_{step}.pt"
        tmp = path.with_suffix(".pt.tmp")
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.inner.state_dict()}, tmp)
        os.replace(tmp, path)
        state_file = self.directory / f"train_state_{step}.json"
        tmp = state_file.with_suffix(".json.tmp")
        with open(tmp, "w") as fp:
            json.dump(train_state, fp)
        os.replace(tmp, state_file)
        for old in self._steps()[:-self.max_to_keep]:
            for name in (f"ckpt_{old}.pt", f"train_state_{old}.json"):
                (self.directory / name).unlink(missing_ok=True)

    def restore(self, model, optimizer):
        """Load the latest checkpoint into `model` and `optimizer`; returns
        the training state, or None when no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self.directory / f"ckpt_{step}.pt",
                           map_location="cpu", weights_only=True)
        model.load_state_dict(saved["model"])
        optimizer.inner.load_state_dict(saved["optimizer"])
        state_file = self.directory / f"train_state_{step}.json"
        train_state = {}
        if state_file.exists():
            with open(state_file) as fp:
                train_state = json.load(fp)
        return train_state


# ------------------------------------------------------------------- save-when DSL


class SaveWhen:
    """'event;cond;format' (multiple criteria '#'-separated) snapshot rule engine,
    mirroring `SaveWhenCallback` (`checkpoint.py:86-138`). Conditions are evaluated
    against a scope of {logs..., epoch/batch, training-state values}."""

    def __init__(self, saved_dir: str, when: str, verbose: bool = True):
        self.saved_dir = saved_dir
        self.verbose = verbose
        self.criterions = []
        if when:
            for item in when.split("#"):
                event, cond, fmt = (s.strip() for s in item.split(";"))
                self.criterions.append((event.lower(), cond, fmt))

    def maybe_save(self, event: str, scope: dict, model) -> list[str]:
        saved = []
        for e, cond, fmt in self.criterions:
            if e != event:
                continue
            try:
                ok = eval(cond, {"__builtins__": {}}, dict(scope))
            except NameError:
                if self.verbose:
                    print(f"SAVE:{e};{cond}: did not find log, IGNORING",
                          flush=True)
                continue
            if ok:
                fname = fmt.format(**scope) + ".npz"
                path = os.path.join(self.saved_dir, fname)
                save_weights(model, path)
                saved.append(path)
                if self.verbose:
                    print(f"SAVE:{e};{cond}: model saved to {path}", flush=True)
        return saved
