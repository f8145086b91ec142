"""The training engine.

Port of `egt_tpu/training/trainer.py::TrainingBase` (the reference's
`lib/training/training_base.py`): the same config surface, run-directory
layout, save-best / reduce-on-plateau / early-stop / resume semantics and
CLI entry points, around the port's `steps.Trainer`. Each step adds its
(sum, count) metric pairs into an accumulator on the card, which is read
once per epoch; the next batch is built and copied to the card by a host
thread (`data/prefetch.py`) while the current step runs.

Run directory (as the JAX package's):
    <save_path>/
        config/config.json, config/config_input.json
        summary.txt                  (parameter-count summary)
        logs/                        (JSONL metrics + optional TensorBoard events)
        checkpoint/                  (ckpt_<epoch>.pt + train_state_<epoch>.json, one kept)
        saved/epochNNNN.npz          (save-best weight snapshots, JAX flat names)
        saved/<model_name>.npz       (final weights)
        predictions/<split>_evals.txt

Not ported yet, and refused rather than ignored: `edge_partition` > 1 and
`num_devices` > 1 (ROADMAP §A item 8), `profile_dir` (item 4).
`steps_per_dispatch` is accepted and runs one step a dispatch, which gives
the JAX `multi_step` result. `distributed` on one card is a mesh of one, as
in JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import schemes
from ..data.prefetch import Prefetcher
from ..models.graph_model import resolve_device
from ..utils.hparams import HParams, join_path, save_config_to_file
from ..weights import flat_names
from . import checkpoint as ckpt
from . import metrics as M
from . import schedules
from .steps import Trainer


def accum_groups(src, A: int):
    """Groups of A consecutive same-shape batches, one pending group per
    batch shape; the short groups left at the end follow in the order their
    shapes first came. (The JAX engine's `_stack_accum` flushes a short
    group at every change of shape instead, so length buckets accumulate
    fewer than A microbatches: ROADMAP §C.) With one shape this is the JAX
    grouping."""
    pending: dict[tuple, list] = {}
    for b in src:
        key = tuple(sorted((k, v.shape) for k, v in b.items()))
        group = pending.setdefault(key, [])
        group.append(b)
        if len(group) == A:
            yield pending.pop(key)
    yield from pending.values()


class TrainingBase:
    """Config-driven training / evaluation engine; schemes subclass this.

    `device`: where the run goes, CUDA unless the caller names a device
    (raises with no GPU)."""

    def __init__(self, config: dict | None = None, device=None):
        self.config_input = config
        self.config = self.get_default_config().strict_update(config)
        self.device = resolve_device(device)
        self.state = self.get_default_state()
        self.pred_flag = False
        self.eval_flag = False
        self.trainer: Trainer | None = None
        self.model = None
        # one record per epoch run by train_model: its seconds, the training
        # part's seconds, graphs and the time spent waiting for a batch
        self.epoch_stats: list[dict] = []

    # --------------------------------------------------------------- config surface

    def get_default_config(self) -> HParams:
        return schemes.trainer_defaults()

    def get_default_state(self) -> dict:
        return {
            "current_epoch": 0,
            "global_step": 0,
            "lr": None,  # filled at load_model
            **schedules.default_plateau_state(),
        }

    # ------------------------------------------------------------- scheme overrides

    def get_dataset(self, splits):
        raise NotImplementedError

    # ------------------------------------------------------------------ data access

    def load_data(self, splits=("training", "validation")):
        self.dataset = self.get_dataset(list(splits))
        for s in splits:
            n = self.dataset.num_records(s)
            print(f"split {s}: {n} records", flush=True)
        self.splits = list(splits)
        self.pad_len = self.dataset.pad_length(self.splits)

    def _batches(self, split: str, shuffle: bool, epoch: int = 0):
        # the reference applies batch_size*prediction_bmult only when the run
        # itself is an eval/predict run (`training_base.py:202-207`); during
        # training every split, in-training validation included, uses the
        # plain batch_size
        bmult = self.config.prediction_bmult \
            if (self.eval_flag or self.pred_flag) else 1
        bs = self.config.batch_size * bmult
        return self.dataset.batches(
            split, bs, shuffle=shuffle, seed=self.config.seed, epoch=epoch,
            pad_len=self.pad_len, buckets=self.config.length_buckets)

    def _to_device(self, batch: dict) -> dict:
        """A numpy batch on the run's device. On the card the copy starts
        from pinned memory without blocking, on the prefetch thread."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                       non_blocking=True)
                for k, v in batch.items()}

    # ----------------------------------------------------------------- model build

    def load_model(self):
        c = self.config
        if int(c.edge_partition) > 1:
            raise NotImplementedError(
                "edge_partition > 1 is not ported yet (ROADMAP §A item 8)")
        if c.num_devices is not None and int(c.num_devices) > 1:
            raise NotImplementedError(
                "num_devices > 1 is not ported yet (ROADMAP §A item 8)")
        if c.profile_dir:
            raise NotImplementedError(
                "profile_dir is not ported yet (ROADMAP §A item 4)")
        self.trainer = Trainer(c, device=self.device)
        self.model = self.trainer.model
        if self.state["lr"] is None:
            self.state["lr"] = float(c.initial_lr)
        self.model_summary()

    def model_summary(self):
        """Architecture summary written to summary.txt (the reference writes
        the Keras `model.summary()` there, `training_base.py:220-224`)."""
        path = Path(self.config.summary_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        params = flat_names(self.model)
        total = sum(p.numel() for p in params.values())
        lines = [f"model: {self.config.model_name}",
                 f"total params: {total:,}", ""]
        width = max(len(n) for n in params) + 2
        tops: dict[str, int] = {}
        for name, p in params.items():
            shape = tuple(p.shape)
            lines.append(f"{name:<{width}}{str(shape):<20}{p.numel():>10,}")
            top = name.split("/", 1)[0]
            tops[top] = tops.get(top, 0) + p.numel()
        lines += ["", "per-subtree totals:"]
        lines += [f"  {top}: {n:,}" for top, n in tops.items()]
        with open(str(path) + ".txt", "w") as fp:
            fp.write("\n".join(lines) + "\n")
        print(f"model: {self.config.model_name}  params: {total:,} "
              f"(full summary: {path}.txt)", flush=True)

    # -------------------------------------------------------------------- training

    def config_summary(self):
        for k, v in self.config.resolved().items():
            print(f"{k} : {v}", flush=True)

    def save_config_file(self):
        os.makedirs(self.config.config_path, exist_ok=True)
        save_config_to_file(self.config.resolved(),
                            join_path(self.config.config_path, "config.json"))
        save_config_to_file(self.config_input or {},
                            join_path(self.config.config_path,
                                      "config_input.json"))

    def load_state(self):
        self.checkpointer = ckpt.TrainCheckpointer(self.config.checkpoint_path)
        train_state = self.checkpointer.restore(self.model,
                                                self.trainer.optimizer)
        if train_state is not None:
            self.state.update(train_state)
            print(f"Checkpoint loaded from {self.config.checkpoint_path} "
                  f"(epoch {self.state['current_epoch']})", flush=True)

    def _make_loggers(self):
        os.makedirs(self.config.log_path, exist_ok=True)
        self._jsonl = open(
            join_path(self.config.log_path, "metrics.jsonl"), "a")
        self._tb = None
        if self.config.log_tensorboard:
            from ..utils.tbevents import EventWriter
            self._tb = EventWriter(self.config.log_path)

    def _log_epoch(self, epoch: int, logs: dict):
        rec = {"epoch": epoch, "time": time.time(), **logs}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in logs.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, epoch)
            self._tb.flush()

    def train_model(self):
        cfg = self.config
        state = self.state
        self._make_loggers()
        save_when = ckpt.SaveWhen(os.path.dirname(cfg.saved_model_path),
                                  cfg.save_when)
        plateau_cfg = schedules.PlateauConfig(
            monitor=cfg.save_best_monitor,
            rlr_factor=cfg.rlr_factor,
            rlr_patience=cfg.rlr_patience,
            min_lr=cfg.initial_lr * cfg.min_lr_factor,
            stopping_lr=cfg.stopping_lr,
            save_best=cfg.save_best,
        )
        warmup_steps = getattr(cfg, "warmup_steps", 0) or 0
        total_steps = getattr(cfg, "total_steps", None)
        early_stop_patience = cfg.stopping_patience
        early_stop_best, early_stop_count = float("inf"), 0
        A = max(1, int(cfg.grad_accum_steps))
        n_graphs = 0            # real graphs fed this epoch (prefetch thread)

        def feed(epoch):
            src = self._batches("training", shuffle=True, epoch=epoch)
            if cfg.steps_per_epoch:
                # steps_per_epoch counts OPTIMIZER steps; each consumes A
                # microbatches
                src = itertools.islice(src, cfg.steps_per_epoch * A)
            return accum_groups(src, A)

        def to_device(group):
            nonlocal n_graphs
            n_graphs += sum(int(b["sample_mask"].sum()) for b in group)
            return [self._to_device(b) for b in group]

        stop = False
        epoch = state["current_epoch"]
        log_interval = float(getattr(cfg, "log_interval", 60) or 0)
        while epoch < cfg.num_epochs and not stop:
            t0 = time.perf_counter()
            last_log = t0
            acc = M.DeviceAccumulator()
            n_steps = 0
            n_graphs = 0
            batches = Prefetcher(feed(epoch), transform=to_device)
            for group in batches:
                step = state["global_step"]
                if warmup_steps > 0:
                    lr, stop_sched = schedules.warmup_cosine_lr(
                        step, warmup_steps=warmup_steps,
                        max_lr=cfg.initial_lr, total_steps=total_steps)
                    if lr is not None:
                        state["lr"] = lr
                    if stop_sched:
                        stop = True
                        break
                self.trainer.step = step
                self.trainer.set_learning_rate(state["lr"])
                self.trainer.train_into(acc, group)
                state["global_step"] = step + 1
                n_steps += 1
                now = time.perf_counter()
                if log_interval and now - last_log >= log_interval:
                    rate = n_steps * A * cfg.batch_size / (now - t0)
                    print(f"  epoch {epoch + 1}: step {n_steps} "
                          f"({rate:.0f} graphs/s)", flush=True)
                    last_log = now
            train_logs = acc.result()      # the epoch's one read of the card
            t_train = time.perf_counter() - t0

            if cfg.reload_on_nan and not np.isfinite(train_logs.get("loss", 0.0)):
                print("Invalid loss, reloading checkpoint!!!", flush=True)
                self.load_state()
                continue

            val_logs = {}
            if "validation" in self.splits:
                val_logs = {f"val_{k}": v for k, v in
                            self.evaluate_split("validation",
                                                max_steps=cfg.validation_steps
                                                ).items()}
            logs = {**train_logs, **val_logs, "lr": state["lr"]}
            dt = time.perf_counter() - t0
            self.epoch_stats.append(dict(
                epoch=epoch + 1, seconds=dt, train_seconds=t_train,
                steps=n_steps, graphs=n_graphs,
                graphs_per_s=n_graphs / t_train,
                wait_share=batches.waited / t_train))
            msg = " - ".join(f"{k}: {v:.5f}" for k, v in logs.items())
            print(f"Epoch {epoch + 1}/{cfg.num_epochs} [{dt:.1f}s, "
                  f"{n_steps} steps, {n_graphs / t_train:.0f} graphs/s, "
                  f"{batches.waited / t_train:.1%} waiting for data] {msg}",
                  flush=True)

            # 1) save-when snapshots (evaluated against the PRE-update best value,
            #    matching the reference callback ordering)
            scope = {**logs, "epoch": epoch + 1,
                     **{k: v for k, v in state.items()
                        if isinstance(v, (int, float))}}
            save_when.maybe_save("epoch", scope, self.model)

            # 2) plateau / save-best / stop bookkeeping
            state["current_epoch"] = epoch + 1
            if cfg.save_best:
                new_lr, _, stop_pl = schedules.plateau_update(
                    state, plateau_cfg, state["lr"], epoch + 1, logs)
                state["lr"] = new_lr
                stop = stop or stop_pl

            # 3) early stopping on val_loss (`training_base.py:276-280`)
            if early_stop_patience > 0:
                v = logs.get("val_loss", float("inf"))
                if v < early_stop_best:
                    early_stop_best, early_stop_count = v, 0
                else:
                    early_stop_count += 1
                    if early_stop_count >= early_stop_patience:
                        print("Early stopping!", flush=True)
                        stop = True

            # 4) checkpoint every epoch
            self.checkpointer.save(epoch + 1, self.model,
                                   self.trainer.optimizer, dict(state))
            print(f"CHECKPOINT Epoch: {epoch + 1}", flush=True)

            self._log_epoch(epoch + 1, logs)
            epoch += 1

        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    # ------------------------------------------------------------------ evaluation

    def evaluate_split(self, split: str, max_steps=None) -> dict:
        acc = M.DeviceAccumulator()
        src = self._batches(split, shuffle=False)
        if max_steps:
            src = itertools.islice(src, max_steps)
        for batch in Prefetcher(src, transform=self._to_device):
            self.trainer.eval_into(acc, batch)
        return acc.result()

    # ----------------------------------------------------------- top-level commands

    def execute_training(self):
        self.config_summary()
        self.save_config_file()
        self.load_data()
        self.load_model()
        self.load_state()
        self.train_model()
        self.finalize_training(skip_init=True)

    def save_model(self):
        path = self.config.saved_model_path + ".npz"
        ckpt.save_weights(self.model, path)
        print(f"Saved model to {path}", flush=True)

    def finalize_training(self, skip_init: bool = False):
        if not skip_init:
            self.config_summary()
            self.load_data()
            self.load_model()
            self.load_state()
        self.save_model()
        print("DONE!!!", flush=True)

    def prepare_for_test(self):
        self.config_summary()
        self.load_data(splits=("training", "validation", "test"))
        self.load_model()

        wf = self.config.weight_file
        if wf == ":":
            wf = ckpt.latest_epoch_snapshot(
                os.path.dirname(self.config.saved_model_path))
        if wf == "":
            wf = self.config.saved_model_path + ".npz"
        if wf == "-":
            self.load_state()
            print("LOADED TRAINING STATE FOR PREDICTIONS!", flush=True)
        else:
            ckpt.load_weights(self.model, wf)
            print(f'LOADED WEIGHT FILE "{wf}" FOR PREDICTIONS!', flush=True)

    def do_evaluations_on_split(self, split: str):
        raise NotImplementedError

    def do_evaluations(self):
        self.eval_flag = True
        self.prepare_for_test()
        os.makedirs(self.config.predictions_path, exist_ok=True)
        for split in ("training", "validation", "test"):
            print("=" * 40, flush=True)
            print(f"Evaluation on {split}.", flush=True)
            self.do_evaluations_on_split(split)
            print(flush=True)

    def append_eval(self, split: str, lines: list[str]):
        os.makedirs(self.config.predictions_path, exist_ok=True)
        name = {"training": "trainset", "validation": "valset",
                "test": "testset"}.get(split, split)
        path = join_path(self.config.predictions_path, f"{name}_evals.txt")
        with open(path, "a") as fp:
            for ln in lines:
                print(ln, file=fp)
        for ln in lines:
            print(ln, flush=True)
