"""The training step of a run config.

Port of `egt_tpu/training/trainer.py::_compute_loss`, `train_step` and
`eval_step` (`grad_accum_steps` 1): the model's forward in training mode
with one seed per layer and step, the scheme's loss (`schemes.py`), the
`l2_reg` penalty on every `kernel` and `table`, backward, and one optimizer
update. The run engine around it (epochs, schedules, checkpoints, the data
reader) is not ported yet.

    trainer = load_trainer("configs/main/zinc/500k/egt.json", weights)
    trainer.train_step(batch)    # {"loss": ..., "mae": ...}

On a CUDA device the layers' forward and backward run through the
hand-written kernels (see `models/layers.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import schemes
from ..models.graph_model import EGTGraphModel
from ..ops.rng import fold_seed
from ..weights import flat_names, load_flat_params, load_npz
from . import optim

L2_KEYS = ("kernel", "table")


class Trainer:
    """Model, optimizer and step counter of one training run."""

    def __init__(self, config, weights=None, device=None):
        c = schemes.resolve_config(config)
        if int(c.grad_accum_steps) != 1:
            raise NotImplementedError("grad_accum_steps > 1 is not ported yet")
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
        # the JAX trainer's base key is PRNGKey(seed + 1), folded per step
        self.base_seed = fold_seed(int(c.seed) + 1)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def layer_seeds(self, step: int) -> list[int]:
        """One seed per layer for a step (`fold_rng(rng, 1000 + i)`)."""
        return [fold_seed(self.base_seed, step, 1000 + i)
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

    def train_step(self, batch: dict) -> dict:
        """One update on a batch (numpy arrays or tensors, with `target`).
        Returns the batch's loss and metrics before the update."""
        self.optimizer.zero_grad()
        loss, pairs = self.compute_loss(batch, True,
                                        self.layer_seeds(self.step))
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return self._report(loss.detach(), pairs)

    def eval_step(self, batch: dict) -> dict:
        with torch.no_grad():
            loss, pairs = self.compute_loss(batch, False)
        return self._report(loss, pairs)

    def set_learning_rate(self, lr: float) -> None:
        optim.set_learning_rate(self.optimizer, lr)

    def flat_params(self) -> dict[str, np.ndarray]:
        """{JAX flat name: array} of the current parameters."""
        return {k: p.detach().float().cpu().numpy()
                for k, p in flat_names(self.model).items()}


def load_trainer(config, weights=None, device=None) -> Trainer:
    """A `Trainer` for a run config (a dict or JSON path), starting from
    `weights` ({JAX flat name: array} or a flat npz path; None draws them
    from `config.seed`), on `device` (CUDA unless the caller names a
    device; raises with no GPU)."""
    return Trainer(config, weights, device)
