"""Serving cells: an open loop of requests through `load_predictor`.

Set-up draws the weights from the seed, hands them to `load_predictor`,
builds a pool of requests (numpy batches of seeded graphs at their pads)
and serves each once. The window offers the pool's requests in its fixed
order at the cell's fixed rate, one due every 1 / rate seconds from the
window's start; one server takes them in order, each as soon as it is due
and the last is done, until the window's seconds are up. A request's
latency is the host clock from when it was due until its predictions are
back on the host (numpy in and out), so it counts the wait behind earlier
ones. The window ends with the last response. After it, a sample of the
requests due in the window, drawn from the seed with the last served
request of the largest pad in it, is compared with the reference's
predictions; a sampled request that the window did not reach (the queue
of a cell offered more than the program sustains) is served then.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from . import harness, traffic
from .reference import batch as rbatch
from .reference import compare, model as rmodel


def run(ctx) -> dict:
    from egt_torch.serving import load_predictor

    cell, cfg = ctx.cell, ctx.cell.config
    tr = cell.traffic
    spec = rmodel.Spec.from_dict(cfg["reference"])
    dev = ctx.device
    rc = dict(cfg["run_config"])
    ctx.lap("imports")

    with ctx.phase("weights"):
        w = rmodel.init_params(spec, ctx.weight_seed, dev)
        flat = {k: v.cpu().numpy() for k, v in w.items()}
        del w
    with ctx.phase("model"):
        predict = load_predictor(rc, flat, device=dev)
        del flat
    with ctx.phase("corpus"):
        rng = ctx.traffic_rng()
        pool = []
        for req in tr["pool"]:
            recs = traffic.records(tr["generator"], req["groups"], rng)
            pool.append(rbatch.collate(recs, len(recs), int(req["pad"])))
    with ctx.phase("warm-up"):
        for req in pool:
            predict(req)

    spans = harness.Spans(harness.kernel_counters() if ctx.trace else None)
    lat, outs = [], []
    graphs = 0
    k_vn = spec.num_virtual_nodes
    t0 = ctx.start_window()
    gap = 1.0 / float(tr["rate"])
    due_n = math.ceil(ctx.seconds / gap)
    i = 0
    while i < due_n and time.perf_counter() - t0 < ctx.seconds:
        ctx.tick()
        due = t0 + i * gap
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        req = pool[i % len(pool)]
        n = int(req["sample_mask"].sum())
        outs.append(spans.run("predict", lambda: predict(req), graphs=n,
                              pad=req["node_features"].shape[1] + k_vn,
                              batch=len(req["sample_mask"])))
        lat.append(time.perf_counter() - due)
        graphs += n
        i += 1
    summary, t1_ns = ctx.end_window()
    window_s = t1_ns * 1e-9 - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    order = [j % len(pool) for j in range(due_n)]
    picked = sample(ctx, order, len(outs), pool, int(tr["compare"]))
    late = {j: predict(pool[order[j]]) for j in picked if j >= len(outs)}
    del predict
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    answers = {j: outs[j] if j < len(outs) else late[j] for j in picked}
    numbers = check(cell, spec, ctx, pool, answers, order)
    ctx.log(f"reference: {time.perf_counter() - t:.3f} s "
            f"(after the window; not part of setup_s)")
    run_rec = harness.Run(
        mode="serve", model=cfg["reference"], bf16=ctx.bf16, peaks=ctx.peaks,
        t0_ns=ctx.t0_ns, t1_ns=t1_ns, spans=spans.items,
        split_ns=ctx.split_ns, trace=summary)
    return dict(
        attempted=len(lat), failed=0, window_s=window_s, peak=peak,
        numbers=numbers, run=run_rec,
        e2e={"serve_graphs_per_s": (graphs / window_s, "graphs/s"),
             "serve_latency_p95_ms": (1e3 * float(np.percentile(lat, 95)),
                                      "ms")})


def sample(ctx, order, served: int, pool, k: int) -> list[int]:
    """Indices of requests due in the window to compare: k drawn from the
    seed, and the last served one of the pool's largest pad."""
    rng = np.random.default_rng([ctx.cfg_seed, 17])
    idx = set(rng.choice(len(order), size=min(k, len(order)),
                         replace=False).tolist())
    big = max(range(len(pool)), key=lambda j: pool[j]["node_features"].shape[1])
    last = [i for i in range(min(served, len(order))) if order[i] == big]
    if last:
        idx.add(last[-1])
    return sorted(idx)


def check(cell, spec, ctx, pool, answers: dict, order) -> dict:
    """The sampled answers' gaps from the reference's predictions for
    their requests (`compare.serve_numbers`, the largest of each)."""
    w = rmodel.init_params(spec, ctx.weight_seed, ctx.device)
    fwd = rmodel.Forward(spec, w)
    chunk = int(cell.config.get("reference_chunk") or 1 << 30)
    refs, gaps = {}, []
    for i, out in answers.items():
        j = order[i]
        if j not in refs:
            req = {k: torch.as_tensor(v, device=ctx.device)
                   for k, v in pool[j].items()}
            b = req["sample_mask"].shape[0]
            with torch.no_grad():
                refs[j] = torch.cat(
                    [fwd({k: v[s:s + chunk] for k, v in req.items()})
                     for s in range(0, b, chunk)]).cpu().numpy()
        gaps.append(compare.serve_numbers(out, refs[j], pool[j]))
    return compare.worst(gaps)
