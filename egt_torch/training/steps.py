"""The training step of a run config.

Port of `egt_tpu/training/trainer.py::_compute_loss`,
`_grads_over_microbatches`, `train_step` and `eval_step`: the model's
forward in training mode with one seed per layer and step, the scheme's loss
(`schemes.py`), the `l2_reg` penalty on every `kernel` and `table`, backward
over one or more microbatches with their gradients averaged uniformly, and
one optimizer update. The run engine around it (epochs, schedules,
checkpoints, the data reader) is `training/trainer.py`.

    trainer = load_trainer("configs/main/zinc/500k/egt.json", weights)
    trainer.train_step(batch)    # {"loss": ..., "mae": ...}

`train_step` and `eval_step` read their batch's loss and metrics back to
the host. The engine's `train_into` and `eval_into` instead add the (sum,
count) pairs into a `metrics.DeviceAccumulator` and read nothing, as the
JAX engine keeps its sums on the device until the end of an epoch.

On a CUDA device the layers' forward and backward run through the
hand-written kernels (see `models/layers.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import schemes
from ..models.graph_model import EGTGraphModel
from ..ops.rng import fold_seed
from ..weights import flat_arrays, load_flat_params, load_npz
from . import optim

L2_KEYS = ("kernel", "table")


class Trainer:
    """Model, optimizer and step counter of one training run."""

    def __init__(self, config, weights=None, device=None):
        c = schemes.resolve_config(config)
        cfg = schemes.model_config_from_config(config)
        self.model = EGTGraphModel(
            cfg, device=device,
            generator=torch.Generator().manual_seed(int(c.seed)))
        if isinstance(weights, str):
            load_npz(self.model, weights)
        elif weights is not None:
            load_flat_params(self.model, weights)
        named = list(self.model.named_parameters())
        self.optimizer = optim.make_optimizer(
            optim.trainable(named), c.optimizer, float(c.initial_lr),
            c.gradient_clipval)
        self._l2 = [p for name, p in named if name.rsplit(".", 1)[-1] in L2_KEYS]
        self.l2_reg = float(cfg.l2_reg)
        self.grad_accum_steps = max(1, int(c.grad_accum_steps))
        # the JAX trainer's base key is PRNGKey(seed + 1), folded per step
        self.base_seed = fold_seed(int(c.seed) + 1)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def layer_seeds(self, step: int, micro: int | None = None) -> list[int]:
        """One seed per layer for a step (`fold_rng(rng, 1000 + i)`), and
        for microbatch `micro` of it under gradient accumulation (the JAX
        step folds the microbatch index in first)."""
        tags = (step,) if micro is None else (step, micro)
        return [fold_seed(self.base_seed, *tags, 1000 + i)
                for i in range(self.model.cfg.model_height)]

    def compute_loss(self, batch: dict, training: bool, seeds=None):
        """(total loss, {metric: (sum, count)}) of a batch."""
        out = self.model(batch, training=training, seeds=seeds)
        target = torch.as_tensor(batch["target"], device=self.device)
        if not torch.is_floating_point(target):
            target = target.long()
        sample_mask = batch.get("sample_mask")
        loss, pairs = schemes.loss_and_metrics(
            out, target, self.model.output_mask(batch),
            None if sample_mask is None
            else torch.as_tensor(sample_mask, device=self.device))
        if self.l2_reg > 0:
            loss = loss + self.l2_reg * sum(torch.sum(torch.square(p))
                                            for p in self._l2)
        return loss, pairs

    @staticmethod
    def _report(loss, pairs) -> dict:
        res = {"loss": loss.detach().item()}
        for name, (s, c) in pairs.items():
            res[name] = s.detach().item() / max(c.detach().item(), 1.0)
        return res

    @staticmethod
    def _with_loss(loss, pairs) -> dict:
        """The pairs a step adds up: (loss, 1) first, as in JAX."""
        loss = loss.detach()
        return {"loss": (loss, torch.ones_like(loss)), **pairs}

    def _update(self, microbatches: list, acc=None):
        """One optimizer update: the gradients of the microbatches' losses
        summed, then divided by their number (`trainer.py:381-408`: uniform
        averaging, the big batch's gradient for graph-level targets). Each
        microbatch's pairs go into `acc` if given. Returns the last
        microbatch's (loss, pairs)."""
        self.optimizer.zero_grad()
        accum = self.grad_accum_steps > 1
        for i, mb in enumerate(microbatches):
            loss, pairs = self.compute_loss(
                mb, True, self.layer_seeds(self.step, i if accum else None))
            loss.backward()
            if acc is not None:
                acc.add(self._with_loss(loss, pairs))
        if len(microbatches) > 1:
            with torch.no_grad():
                for group in self.optimizer.inner.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(len(microbatches))
        self.optimizer.step()
        self.step += 1
        return loss, pairs

    def train_step(self, batch: dict) -> dict:
        """One update on a batch (numpy arrays or tensors, with `target`).
        Returns the batch's loss and metrics before the update."""
        loss, pairs = self._update([batch])
        return self._report(loss.detach(), pairs)

    def train_into(self, acc, microbatches: list) -> None:
        """One update over `microbatches` (1 to `grad_accum_steps` batches of
        one shape), adding each one's (loss, 1) and metric pairs into `acc`
        (a `metrics.DeviceAccumulator`); reads no device value."""
        self._update(microbatches, acc)

    def eval_step(self, batch: dict) -> dict:
        with torch.no_grad():
            loss, pairs = self.compute_loss(batch, False)
        return self._report(loss, pairs)

    def eval_into(self, acc, batch: dict) -> None:
        """Add a batch's (loss, 1) and metric pairs, at inference, into
        `acc`; reads no device value."""
        with torch.no_grad():
            loss, pairs = self.compute_loss(batch, False)
        acc.add(self._with_loss(loss, pairs))

    def set_learning_rate(self, lr: float) -> None:
        optim.set_learning_rate(self.optimizer, lr)

    def flat_params(self) -> dict[str, np.ndarray]:
        """{JAX flat name: array} of the current parameters."""
        return flat_arrays(self.model)


def load_trainer(config, weights=None, device=None) -> Trainer:
    """A `Trainer` for a run config (a dict or JSON path), starting from
    `weights` ({JAX flat name: array} or a flat npz path; None draws them
    from `config.seed`), on `device` (CUDA unless the caller names a
    device; raises with no GPU)."""
    return Trainer(config, weights, device)
