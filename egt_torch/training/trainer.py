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
        predictions/<split>_evals.txt, <split>_predictions.npz,
                     <split>_analysis.npz
        serving/model.pt2            (`export_serving`: torch.export artifact)

Length buckets give a split's batches different pad lengths. Where a dump
concatenates per-pair or per-node outputs of such batches
(`make_predictions` with a node or edge readout, `do_analysis` over
several batches), each batch's rows are padded with NaN to the split's
largest pad first (`concat_padded`); JAX's concatenation raises there
(ROADMAP §C). Wherever JAX completes, the arrays are JAX's.

`profile_dir` traces global steps 10 to 15 with `torch.profiler` (the
host's activity with the port's spans, `tracing.py`, and the card's on a
CUDA device) into
`<profile_dir>/trace_steps_10-15.json`, a Chrome trace, as JAX traces
them with `jax.profiler`; a run that ends inside the window writes what it
traced.

Parallel runs: `distributed`, `num_devices` and `edge_partition` size the
world as JAX sizes its mesh (`trainer.py:295-305`): `edge_partition` ranks
without `distributed`, else `num_devices` (None: the world as started),
laid out as (ranks / edge_partition) data x edge_partition model
(`parallel/mesh.py`). JAX opens its devices in one process; here a run of
several ranks is one process a rank, started by
`torchrun --standalone --nproc_per_node N -m egt_torch.run_training <config>`,
and a world that does not match the config raises. Every rank iterates the
same global batches and trains on its data shard's graphs (with its edge
rows, `parallel/edge_partition.py`); evaluation sums the shards; predictions
and analysis run whole batches on every rank (their edge rows under edge
partitioning). Only rank 0 writes the run directory (config, summary, logs,
checkpoints, weight snapshots, predictions); every rank reads it.
`steps_per_dispatch` is accepted and runs one step a dispatch, which gives
the JAX `multi_step` result.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import schemes, tracing
from ..data.prefetch import Prefetcher
from ..models.graph_model import resolve_device
from ..parallel import mesh as meshlib
from ..parallel.edge_partition import forward_shard
from ..utils.hparams import HParams, join_path, save_config_to_file
from ..weights import flat_names
from . import checkpoint as ckpt
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


def concat_padded(arrays: list) -> np.ndarray:
    """`np.concatenate(arrays)` along axis 0. Where the arrays' other axes
    differ (batches of different pad lengths), each is padded with NaN at
    the end of every axis to the largest size first."""
    sizes = {a.shape[1:] for a in arrays}
    if len(sizes) > 1 and len({len(s) for s in sizes}) == 1:
        full = tuple(max(s) for s in zip(*sizes))
        arrays = [np.pad(a.astype(np.result_type(a.dtype, np.float32)),
                         [(0, 0)] + [(0, f - n)
                                     for f, n in zip(full, a.shape[1:])],
                         constant_values=np.nan) for a in arrays]
    return np.concatenate(arrays, axis=0)


SPLIT_FILES = {"training": "trainset", "validation": "valset",
               "test": "testset"}


class StepTracer:
    """`profile_dir`: a `torch.profiler` trace of global steps 10 to 15
    (JAX's window), the host's activity with the port's spans
    (`tracing.py`) and, on a CUDA device, the card's, written as a Chrome
    trace under `directory`. Without a directory it does nothing."""

    START, STOP = 10, 16

    def __init__(self, directory: str | None, device: torch.device):
        self.directory = directory
        self.device = device
        self.prof = None

    @property
    def path(self) -> str:
        return join_path(self.directory,
                         f"trace_steps_{self.START}-{self.STOP - 1}.json")

    def at_step(self, step: int) -> None:
        """Called before global step `step` runs."""
        if not self.directory:
            return
        if step == self.START and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            tracing.start(annotate=True)
        elif step == self.STOP:
            self.stop()

    def stop(self) -> None:
        """End the trace if one runs, and write it."""
        if self.prof is None:
            return
        tracing.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print(f"device trace written to {self.directory}", flush=True)


class TrainingBase:
    """Config-driven training / evaluation engine; schemes subclass this.

    `device`: where the run goes, CUDA unless the caller names a device
    (raises with no GPU)."""

    def __init__(self, config: dict | None = None, device=None):
        self.config_input = config
        self.config = self.get_default_config().strict_update(config)
        self.device_arg = device
        self.device = resolve_device(device)
        self.mesh = None
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

    @property
    def is_main(self) -> bool:
        """Whether this rank writes the run directory (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            torch.distributed.barrier(group=self.mesh.world.pg)

    def _to_shard(self, batch: dict) -> dict:
        """This rank's data shard of a global batch, on the device."""
        if self.mesh is not None:
            batch = meshlib.batch_shard(batch, self.mesh)
        return self._to_device(batch)

    def _to_device(self, batch: dict) -> dict:
        """A numpy batch on the run's device. On the card the copy starts
        from pinned memory without blocking, on the prefetch thread."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                       non_blocking=True)
                for k, v in batch.items()}

    # ----------------------------------------------------------------- model build

    def make_mesh(self):
        """The run's mesh, sized as JAX sizes it (`trainer.py:295-303`):
        the pad length must divide by `edge_partition`; `edge_partition`
        ranks without `distributed`, else `num_devices` (None: the world as
        started), else one."""
        c = self.config
        ep = int(c.edge_partition)
        if ep > 1 and self.pad_len % ep:
            raise ValueError(f"pad length {self.pad_len} must divide by "
                             f"edge_partition={ep}")
        if ep > 1 and not c.distributed:
            n_dev = ep
        else:
            n_dev = c.num_devices if c.distributed else 1
        return meshlib.make_mesh(n_dev, model_parallel=ep,
                                 device=self.device_arg)

    def load_model(self):
        c = self.config
        self.mesh = self.make_mesh()
        self.device = self.mesh.device
        self.trainer = Trainer(c, device=self.device, mesh=self.mesh)
        self.model = self.trainer.model
        if self.state["lr"] is None:
            self.state["lr"] = float(c.initial_lr)
        self.model_summary()

    def model_summary(self):
        """Architecture summary written to summary.txt (the reference writes
        the Keras `model.summary()` there, `training_base.py:220-224`)."""
        if not self.is_main:
            return
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
        if not self.is_main:
            return
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
        self._jsonl = self._tb = None
        if not self.is_main:
            return
        os.makedirs(self.config.log_path, exist_ok=True)
        self._jsonl = open(
            join_path(self.config.log_path, "metrics.jsonl"), "a")
        self._tb = None
        if self.config.log_tensorboard:
            from ..utils.tbevents import EventWriter
            self._tb = EventWriter(self.config.log_path)

    def _log_epoch(self, epoch: int, logs: dict):
        if self._jsonl is None:
            return
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
                                  cfg.save_when if self.is_main else "")
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
            return [self._to_shard(b) for b in group]

        stop = False
        epoch = state["current_epoch"]
        log_interval = float(getattr(cfg, "log_interval", 60) or 0)
        tracer = StepTracer(cfg.profile_dir if self.is_main else None,
                            self.device)
        while epoch < cfg.num_epochs and not stop:
            t0 = time.perf_counter()
            last_log = t0
            acc = self.trainer.accumulator()
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
                tracer.at_step(step)
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
            if self.is_main:
                self.checkpointer.save(epoch + 1, self.model,
                                       self.trainer.optimizer, dict(state))
            self._barrier()
            print(f"CHECKPOINT Epoch: {epoch + 1}", flush=True)

            self._log_epoch(epoch + 1, logs)
            epoch += 1

        tracer.stop()
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    # ------------------------------------------------------------------ evaluation

    def evaluate_split(self, split: str, max_steps=None) -> dict:
        """The split's loss and metrics at inference, over its batches (one
        shape a length bucket, with `length_buckets`)."""
        acc = self.trainer.accumulator()
        src = self._batches(split, shuffle=False)
        if max_steps:
            src = itertools.islice(src, max_steps)
        for batch in Prefetcher(src, transform=self._to_shard):
            self.trainer.eval_into(acc, batch)
        return acc.result()

    def predict_split(self, split: str):
        """Yield (host batch, f32 numpy predictions) over a split, batched
        and bucketed as evaluation is, for custom eval loops."""
        def pair(batch):
            return batch, self._to_device(batch)

        for batch, dbatch in Prefetcher(self._batches(split, shuffle=False),
                                        transform=pair):
            with torch.no_grad():
                # every rank runs the whole batch (its edge rows)
                out = forward_shard(self.model, dbatch, self.mesh)
            yield batch, out.float().cpu().numpy()

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
        if not self.is_main:
            return
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

    def make_predictions_on_split(self, split: str):
        """The prediction dump (JAX's `make_predictions_on_split`): the
        model's outputs on the split's real records (`sample_mask` > 0),
        stacked, to predictions/<split>_predictions.npz under
        `predictions`; batches of different pads NaN-padded to the
        largest."""
        outs = [out[batch["sample_mask"] > 0]
                for batch, out in self.predict_split(split)]
        path = join_path(self.config.predictions_path,
                         f"{SPLIT_FILES.get(split, split)}_predictions.npz")
        if self.is_main:
            np.savez(path, predictions=concat_padded(outs))
        print(f"saved predictions to {path}", flush=True)

    def make_predictions(self):
        self.pred_flag = True
        self.prepare_for_test()
        os.makedirs(self.config.predictions_path, exist_ok=True)
        for split in ("training", "validation", "test"):
            print("=" * 40, flush=True)
            print(f"Prediction on {split}.", flush=True)
            self.make_predictions_on_split(split)
            print(flush=True)

    def do_analysis(self, split: str = "test", max_batches: int = 1) -> str:
        """Dump the per-layer attention logits, matrices, gates and edge
        biases (`EGTGraphModel.analyze`, the plain path) of the split's
        first `max_batches` batches to predictions/<split>_analysis.npz,
        `/` in each key turned into `.` (JAX's `do_analysis`). The
        `combine_layer_repr` lists are skipped, as in JAX, and so is a
        capture that is None (the `none` channel's e when nothing builds an
        edge embedding, which JAX cannot concatenate). Captures are written
        in f32 (bf16 values exactly)."""
        self.pred_flag = True
        self.prepare_for_test()
        os.makedirs(self.config.predictions_path, exist_ok=True)
        dumps: dict[str, list] = {}
        for i, batch in enumerate(self._batches(split, shuffle=False)):
            if i >= max_batches:
                break
            with torch.no_grad():
                analysis = self.model.analyze(self._to_device(batch))
            for k, v in analysis.items():
                if v is None or isinstance(v, (list, tuple)):
                    continue
                dumps.setdefault(k, []).append(v.float().cpu().numpy())
        path = join_path(self.config.predictions_path,
                         f"{SPLIT_FILES.get(split, split)}_analysis.npz")
        if self.is_main:
            np.savez(path, **{k.replace("/", "."): concat_padded(v)
                              for k, v in dumps.items()})
        print(f"saved analysis tensors to {path}", flush=True)
        return path

    def export_serving(self, path: str | None = None) -> str:
        """Export the model with its weights (`weight_file` semantics) as a
        `torch.export` serving artifact (see `egt_torch/serving.py`), by
        default <save_path>/serving/model.pt2, at the pad length and the
        prediction batch; it runs on this engine's device."""
        from .. import serving

        self.pred_flag = True
        self.prepare_for_test()
        if path is None:
            path = join_path(self.config.save_path, "serving", "model.pt2")
        if not self.is_main:
            return path
        spec = serving.batch_spec(
            self.dataset, self.pad_len,
            self.config.batch_size * self.config.prediction_bmult)
        out = serving.save_serving(self.model, spec, path)
        print(f"Serving artifact exported to {out}", flush=True)
        return out

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
        path = join_path(self.config.predictions_path,
                         f"{SPLIT_FILES.get(split, split)}_evals.txt")
        if self.is_main:
            with open(path, "a") as fp:
                for ln in lines:
                    print(ln, file=fp)
        for ln in lines:
            print(ln, flush=True)
