"""The training step of a run config.

Port of `egt_tpu/training/trainer.py::_compute_loss`,
`_grads_over_microbatches`, `train_step` and `eval_step`: the model's
forward in training mode with one seed per layer and step (and the step's
seed for the positional encodings' sign flips), the scheme's loss
(`schemes.py`) plus the model's auxiliary losses (the distance objective),
whose unweighted values join the metrics as (value, 1) pairs, the
`l2_reg` penalty on every `kernel` and `table`, backward
over one or more microbatches with their gradients averaged uniformly, the
BatchNorm moving statistics written after each microbatch's backward (in
order, as JAX's scan merges them, with no gradient and outside the
optimizer; a recomputed forward under `remat` returns none), and one
optimizer update. The scheme's loss is the config's: the MAE of the
graph target (ZINC), the cross-entropy of the graph's class with the
accuracy beside it (MNIST, CIFAR10), the class-weighted cross-entropy
over the valid nodes with the accuracy beside it (PATTERN, CLUSTER), or the
cross-entropy over the valid pairs with the accuracy beside it (TSP). The
run engine around it (epochs, schedules,
checkpoints, the data reader) is `training/trainer.py`.

    trainer = load_trainer("configs/main/zinc/500k/egt.json", weights)
    trainer.train_step(batch)    # {"loss": ..., "mae": ...} (ZINC)

`train_step` and `eval_step` read their batch's loss and metrics back to
the host. The engine's `train_into` and `eval_into` instead add the (sum,
count) pairs into a `metrics.DeviceAccumulator` and read nothing, as the
JAX engine keeps its sums on the device until the end of an epoch.

On a CUDA device the layers' forward and backward run through the
hand-written kernels (see `models/layers.py`).

Parallel runs (a `parallel.mesh.Mesh` of more than one rank): each rank
holds its data group's graphs and, with a model group of more than one
rank, its edge rows (`parallel/edge_partition.py`). The loss is the global
batch's, as JAX's jitted loss over a sharded batch gives it: the scheme's
loss is the mean of its first (sum, count) pair, whose counts are summed
over the data group before the division; the model's auxiliary losses and
the L2 penalty count 1 / data ranks a rank. Every rank of a model group
computes the same loss and back-propagates it scaled by 1 / model ranks
(`parallel/collectives.py`), and after a step's micro-batches the
gradients are summed over every rank. The pairs a step adds into a
`DeviceAccumulator` are this rank's share, which its read sums over the
data group. The draws fold in the data rank, so that two ranks never draw
the same bits for their graph 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import schemes, tracing
from ..models.graph_model import EGTGraphModel
from ..ops.rng import fold_seed
from ..parallel import collectives as C
from ..parallel.edge_partition import forward_shard
from ..parallel.mesh import replicate
from ..weights import flat_arrays, load_flat_params, load_npz
from . import metrics as M
from . import optim

L2_KEYS = ("kernel", "table")
DATA_RANK_TAG = 7003      # folded with the data rank into a rank's seeds


class Trainer:
    """Model, optimizer and step counter of one training run.

    `model_config` (a `GraphModelConfig`) replaces the model the run config
    gives: the model API's variants that no run config names (cross-talk,
    BatchNorm, the encodings, `readout_edges`), trained with the scheme's
    loss. `mesh` (a `parallel.mesh.Mesh`) runs it on every rank of the
    mesh, on the mesh's device."""

    def __init__(self, config, weights=None, device=None, model_config=None,
                 mesh=None):
        c = schemes.resolve_config(config)
        cfg = (schemes.model_config_from_config(config)
               if model_config is None else model_config)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            device = self.mesh.device
        self.model = EGTGraphModel(
            cfg, device=device,
            generator=torch.Generator().manual_seed(int(c.seed)))
        if isinstance(weights, str):
            load_npz(self.model, weights)
        elif weights is not None:
            load_flat_params(self.model, weights)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        named = list(self.model.named_parameters())
        self.optimizer = optim.make_optimizer(
            optim.trainable(named), c.optimizer, float(c.initial_lr),
            c.gradient_clipval)
        self._l2 = [p for name, p in named if name.rsplit(".", 1)[-1] in L2_KEYS]
        self.l2_reg = float(cfg.l2_reg)
        self.loss_and_metrics = schemes.loss_fn(c)
        self.grad_accum_steps = max(1, int(c.grad_accum_steps))
        # the JAX trainer's base key is PRNGKey(seed + 1), folded per step
        # (and here with the data rank, where there are several)
        self.base_seed = (fold_seed(int(c.seed) + 1) if self.data_size == 1
                          else fold_seed(int(c.seed) + 1, DATA_RANK_TAG,
                                         self.mesh.data.index))
        self.step = 0

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.data.size

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.model.size

    def accumulator(self) -> M.DeviceAccumulator:
        """A `DeviceAccumulator` whose read sums over the data group."""
        return M.DeviceAccumulator(None if self.mesh is None
                                   else self.mesh.data)

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

    def pe_seed(self, step: int, micro: int | None = None) -> int:
        """The seed of a step (and microbatch) that the model folds into
        its positional encodings' sign-flip seeds (`fold_rng(rng, 101)` /
        `102` of the step's rng in JAX)."""
        tags = (step,) if micro is None else (step, micro)
        return fold_seed(self.base_seed, *tags)

    def compute_loss(self, batch: dict, training: bool, seeds=None,
                     pe_seed=None):
        """(total loss, {metric: (sum, count)}) of a batch: the scheme's
        loss plus the model's auxiliary losses and the L2 penalty; the
        model's metrics join the scheme's as (value, 1) pairs."""
        loss, pairs, _ = self._loss(batch, training, seeds, pe_seed)
        return loss, pairs

    def _forward(self, batch, training: bool, seeds=None, pe_seed=None):
        """(predictions, `ModelContext`) of this rank's batch (its data
        shard under a mesh)."""
        if self.mesh is None:
            return self.model(batch, training=training, seeds=seeds,
                              pe_seed=pe_seed, with_context=True)
        return forward_shard(self.model, batch, self.mesh, training=training,
                             seeds=seeds, pe_seed=pe_seed, with_context=True)

    def _loss(self, batch, training, seeds=None, pe_seed=None):
        """`compute_loss` and the forward's BatchNorm updates. Under a mesh
        of several data ranks, this rank's share of the global loss (see
        the module's docstring) and of the model's metrics."""
        with tracing.span("forward"):
            out, ctx = self._forward(batch, training, seeds, pe_seed)
        with tracing.span("loss"):
            target = torch.as_tensor(batch["target"], device=self.device)
            if not torch.is_floating_point(target):
                # class labels: (b,), (b, l), (b, l, l)
                target = target.long()
            sample_mask = batch.get("sample_mask")
            loss, pairs = self.loss_and_metrics(
                out, target, self.model.output_mask(batch),
                None if sample_mask is None
                else torch.as_tensor(sample_mask, device=self.device))
            dp = self.data_size
            if dp > 1:
                # the scheme's loss is the mean of its first pair: the global
                # mean divides this rank's sum by the data group's count
                s, c = next(iter(pairs.values()))
                count = C.all_reduce_(c.detach().float().clone(),
                                      self.mesh.data)
                loss = s / torch.clamp(count, min=1.0)
            for v in ctx.losses.values():
                loss = loss + v / dp
            if self.l2_reg > 0:
                loss = loss + self.l2_reg / dp * sum(
                    torch.sum(torch.square(p)) for p in self._l2)
            for name, v in ctx.metrics.items():
                pairs[name] = (v / dp, torch.full_like(v, 1.0 / dp))
            return loss, pairs, ctx.stats_updates

    @torch.no_grad()
    def write_stats(self, stats_updates: dict) -> None:
        """Write a forward's BatchNorm moving statistics ({path under
        `stack`: {name: tensor}}) into the model."""
        for path, upd in stats_updates.items():
            mod = self.model.stack
            for key in path:
                mod = mod[key]
            for name, value in upd.items():
                mod[name].copy_(value)

    def _report(self, loss, pairs) -> dict:
        acc = self.accumulator()
        acc.add(self._with_loss(loss, pairs))
        return acc.result()

    def _with_loss(self, loss, pairs) -> dict:
        """The pairs a step adds up: (loss, 1) first, as in JAX (this
        rank's share, (loss, 1 / data ranks), under a mesh)."""
        loss = loss.detach()
        return {"loss": (loss, torch.full_like(loss, 1.0 / self.data_size)),
                **pairs}

    def _update(self, microbatches: list, acc=None):
        """One optimizer update: the gradients of the microbatches' losses
        summed, then divided by their number (`trainer.py:381-408`: uniform
        averaging, the big batch's gradient for graph-level targets). Each
        microbatch's pairs go into `acc` if given, and its BatchNorm
        moving statistics into the model after its backward. Returns the
        last microbatch's (loss, pairs)."""
        with tracing.span("step", group=self.step):
            self.optimizer.zero_grad()
            accum = self.grad_accum_steps > 1
            for i, mb in enumerate(microbatches):
                micro = i if accum else None
                loss, pairs, stats = self._loss(
                    mb, True, self.layer_seeds(self.step, micro),
                    self.pe_seed(self.step, micro))
                with tracing.span("backward"):
                    # each rank of a model group holds the same loss: its
                    # backward counts 1 / model ranks of it
                    (loss / self.model_size).backward()
                with tracing.span("accumulate"):
                    self.write_stats(stats)
                    if acc is not None:
                        acc.add(self._with_loss(loss, pairs))
            if self.mesh is not None:
                C.sum_gradients((p for g in self.optimizer.inner.param_groups
                                 for p in g["params"]), self.mesh.world)
            with tracing.span("optimizer"):
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
        """One update on a batch (numpy arrays or tensors, with `target`:
        (b, 1) values for ZINC, (b, l) node labels for PATTERN and
        CLUSTER, (b,) class labels for MNIST and CIFAR10, (b, l, l) edge
        labels for TSP). Returns the batch's loss and metrics before the
        update."""
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


def load_trainer(config, weights=None, device=None, model_config=None,
                 mesh=None) -> Trainer:
    """A `Trainer` for a run config (a dict or JSON path), starting from
    `weights` ({JAX flat name: array} or a flat npz path; None draws them
    from `config.seed`), on `device` (CUDA unless the caller names a
    device; raises with no GPU); `model_config` replaces the run config's
    model (see `Trainer`); `mesh` runs it on a mesh's ranks (train and
    evaluate each rank's data shard of the same global batch)."""
    return Trainer(config, weights, device, model_config, mesh)
