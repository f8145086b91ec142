"""Training cells: the engine's step loop over a seeded corpus.

Set-up writes the corpus as the reader's cache, builds the scheme's
engine (`TrainingBase`: the dataset, the model and its `Trainer`), loads
the weights drawn from the seed, and starts the feed the engine's loop
uses: batches of shuffled epochs, chained without end, grouped into a
step's micro-batches and copied to the card by a `Prefetcher` thread.
The first steps go through `Trainer.train_into` as every later step does;
the loss and the learning rate of each of the first `check_steps` are
read, the predictions of the first micro-batch (a forward hook on the
model), the gradient of the first step as the optimizer took it (Adam's
first moment over 1 - beta1), and the parameters' change after the
last. Steps then run to the end of the first epoch, so that every batch
shape has run once. The window runs
steps until its seconds are up and ends when the card has finished them
(under `--trace 1` its second half is traced).
After it, the reference repeats the checked steps from the same weights,
records and draws.
"""

from __future__ import annotations

import gc
import itertools
import tempfile
import threading
import time

import numpy as np
import torch

from . import harness, traffic
from .reference import batch as rbatch
from .reference import compare, model as rmodel, train as rtrain

BETA1 = 0.9


class Recorder:
    """Takes a step's (sum, count) pairs in the engine accumulator's place,
    each micro-batch's apart."""

    def __init__(self):
        self.pairs = []

    def add(self, pairs: dict) -> None:
        self.pairs.append({k: (s.detach(), c.detach())
                           for k, (s, c) in pairs.items()})

    def read(self) -> tuple[float, float]:
        """(the step's loss: its micro-batches' mean, the graphs or nodes
        the scheme's loss counted: the first pair after the loss)."""
        losses = [float(p["loss"][0]) for p in self.pairs]
        count = sum(float(list(p.values())[1][1]) for p in self.pairs)
        return sum(losses) / len(losses), count


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def run(ctx) -> dict:
    from egt_torch.data.prefetch import Prefetcher
    from egt_torch.training import optim, schedules
    from egt_torch.training.schemes import import_scheme
    from egt_torch.training.trainer import accum_groups

    cell, cfg = ctx.cell, ctx.cell.config
    tr = cell.traffic
    spec = rmodel.Spec.from_dict(cfg["reference"])
    dev = ctx.device
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
    ctx.cleanup.append(tmp.cleanup)
    rc = dict(cfg["run_config"], seed=ctx.cfg_seed, log_tensorboard=False,
              dataset_path=f"{tmp.name}/unused.h5",
              cache_dir=f"{tmp.name}/cache", save_path=f"{tmp.name}/run")
    ctx.lap("imports")

    with ctx.phase("corpus"):
        records = traffic.records(tr["generator"], tr["groups"],
                                  ctx.traffic_rng())
        scheme = import_scheme(rc["scheme"])(rc, device=dev)
        scheme.get_dataset(["training"]).write_cache("training", records)
        scheme.load_data(splits=("training",))
    with ctx.phase("model"):
        scheme.load_model()
        trainer = scheme.trainer
        c = scheme.config
    with ctx.phase("weights"):
        w0 = rmodel.init_params(spec, ctx.weight_seed, dev)
        params = dict(trainer.model.named_parameters())
        names = {k.replace(".", "/") for k in params}
        if names != set(w0):
            raise KeyError(f"weight names differ: {sorted(names ^ set(w0))[:5]}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(w0[k.replace(".", "/")])

    A = max(1, int(c.grad_accum_steps))
    bs = int(c.batch_size)
    k_vn = spec.num_virtual_nodes
    stop = threading.Event()

    def epochs():
        for epoch in itertools.count():
            for b in scheme.dataset.batches(
                    "training", bs, shuffle=True, seed=c.seed, epoch=epoch,
                    pad_len=scheme.pad_len, buckets=c.length_buckets):
                if stop.is_set():
                    return
                yield b

    def to_device(group):
        graphs = sum(int(b["sample_mask"].sum()) for b in group)
        pad = group[0]["node_features"].shape[1]
        if dev.type == "cpu":
            on = [{k: torch.from_numpy(v) for k, v in b.items()}
                  for b in group]
        else:
            on = [{k: torch.from_numpy(v).pin_memory().to(dev,
                                                          non_blocking=True)
                   for k, v in b.items()} for b in group]
        return on, graphs, pad

    feed = Prefetcher(accum_groups(epochs(), A), transform=to_device)
    it = iter(feed)
    warmup_steps = int(getattr(c, "warmup_steps", 0) or 0)
    total_steps = getattr(c, "total_steps", None)
    lr = float(c.initial_lr)

    def rate(step):
        nonlocal lr
        if warmup_steps > 0:
            new, _ = schedules.warmup_cosine_lr(
                step, warmup_steps=warmup_steps, max_lr=c.initial_lr,
                total_steps=total_steps)
            if new is not None:
                lr = new
        return lr

    step_no = 0

    def one_step(group, acc):
        nonlocal step_no
        trainer.step = step_no
        trainer.set_learning_rate(rate(step_no))
        trainer.train_into(acc, group)
        step_no += 1

    check_steps = int(tr["check_steps"])
    prog = {"losses": [], "count": 0.0, "lrs": []}

    def first_forward(module, args, output):
        out = output[0] if isinstance(output, tuple) else output
        prog["logits1"] = out.detach().float().cpu().numpy()
        hook.remove()

    hook = trainer.model.register_forward_hook(first_forward)
    with ctx.phase("warm-up"):
        for t in range(int(tr["warm_steps"])):
            group, graphs, pad = next(it)
            acc = Recorder() if t < check_steps else trainer.accumulator()
            one_step(group, acc)
            if t < check_steps:
                loss, count = acc.read()
                prog["losses"].append(loss)
                prog["count"] += count
                prog["lrs"].append(optim.get_learning_rate(trainer.optimizer))
            if t == 0:
                st = trainer.optimizer.inner.state
                prog["grad"] = _leaf_norms(
                    {k: st[p]["exp_avg"] / (1 - BETA1)
                     for k, p in ((n.replace(".", "/"), p)
                                  for n, p in params.items()) if p in st})
            if t == check_steps - 1:
                prog["change"] = _leaf_norms(
                    {k.replace(".", "/"): p.detach() - w0[k.replace(".", "/")]
                     for k, p in params.items()})
                del w0
        if dev.type == "cuda":
            torch.cuda.synchronize()

    spans = harness.Spans(harness.kernel_counters() if ctx.trace else None)
    acc = trainer.accumulator()
    graphs_done = steps = 0
    wait0 = feed.waited
    wait_split = None
    t0 = ctx.start_window()
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.tick():
            wait_split = feed.waited
        group, graphs, pad = spans.run("batch fetch", lambda: next(it))
        spans.run("train_into", lambda: one_step(group, acc),
                  graphs=graphs, pad=pad + k_vn, batch=bs)
        graphs_done += graphs
        steps += 1
    summary, t1_ns = ctx.end_window()
    window_s = t1_ns * 1e-9 - t0
    wait_s = (feed.waited if wait_split is None else wait_split) - wait0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    loss_window = acc.result().get("loss")

    stop.set()
    for _ in it:
        pass
    del it, feed, group, acc, trainer, scheme, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check(cell, spec, records, ctx, check_steps, prog)
    ctx.log(f"reference: {time.perf_counter() - t:.3f} s "
            f"(after the window; not part of setup_s)")
    if loss_window is None or not np.isfinite(loss_window):
        # a window whose losses are not finite fails every number
        numbers = {k: v if isinstance(v, str) else float("nan")
                   for k, v in numbers.items()}
    run_rec = harness.Run(
        mode="train", model=cfg["reference"], bf16=ctx.bf16, peaks=ctx.peaks,
        t0_ns=ctx.t0_ns, t1_ns=t1_ns, spans=spans.items,
        split_ns=ctx.split_ns, wait_s=wait_s, trace=summary)
    return dict(
        attempted=steps, failed=0, window_s=window_s, peak=peak,
        numbers=numbers, run=run_rec,
        e2e={"train_graphs_per_s": (graphs_done / window_s, "graphs/s"),
             "train_peak_mem_gib": (peak / 2 ** 30, "GiB")})


def check_batches(cell, records, cfg_seed, n_steps: int) -> list:
    """The micro-batches of the first `n_steps` steps, built by the
    reference from the records in the reader's shuffled order."""
    run_cfg = cell.config["run_config"]
    bs = int(run_cfg["batch_size"])
    A = int(run_cfg.get("grad_accum_steps", 1))
    buckets = cell.config.get("length_buckets")
    num = np.array([r["num_nodes"] for r in records])
    pad = rbatch.pad_length(num)
    steps, pending = [], {}
    for epoch in itertools.count():
        for blen, sel in rbatch.epoch_batches(num, bs, cfg_seed, epoch, pad,
                                              buckets):
            group = pending.setdefault(blen, [])
            group.append(rbatch.collate([records[i] for i in sel], bs, blen))
            if len(group) == A:
                steps.append(pending.pop(blen))
                if len(steps) == n_steps:
                    return steps
    return steps


def check(cell, spec, records, ctx, n_steps: int, prog) -> dict:
    """The reference's numbers against the program's readings; the
    reference's learning rates are its own, from the run config."""
    cfg = cell.config
    steps = check_batches(cell, records, ctx.cfg_seed, n_steps)
    w0 = rmodel.init_params(spec, ctx.weight_seed, ctx.device)
    ref = rtrain.run_steps(spec, w0, steps,
                           rtrain.rates(cfg["run_config"], n_steps),
                           ctx.cfg_seed,
                           float(cfg["run_config"].get("gradient_clipval")
                                 or 1e30),
                           ctx.device, chunk=cfg.get("reference_chunk"))
    return compare.train_numbers(prog, ref, steps[0][0])
