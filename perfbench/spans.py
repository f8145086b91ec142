"""The program's own spans in a cell's traced half, with the card's idle
time and the device time of the work they launched charged to them.

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python3 -m perfbench.run ... --trace 1` does (the same
set-up, window, device trace and check, and the same result line), with
the program's recorder (`egt_torch/tracing.py`) on over the traced half:
from just after the device trace starts to the window's end. Device work
is charged to a span by its launch: a device event's correlation id leads
to its runtime launch record, whose host time falls in the innermost span
open on the launching thread, or, on a thread with none open (autograd's
device thread), in the innermost span open on the thread that opened the
step or the request. Idle time is charged on the host's clock: each idle
interval inside the benchmark's traced spans (what `device_idle_share`
reads) is split at the program's span boundaries and charged to the
innermost span open then, and to the outermost of `forward`, `backward`
and `optimizer` open then, if any. Host times go on the trace's clock
through the marker's launch record; `trace.Summary` places them through
the marker's start on the card, which trails its launch by the marker
kernel's first load (`marker_lag_ms` below), so this `device_idle_share`
can differ a little from the result line's.

Standard error gets a table per span name, per step or request: the
host's self time, the device time of the kernels, copies and memsets
launched inside it (and of those the port's kernels K1-K9), the card's
idle time while it was the innermost open span, and the kernels it
launched (rows in brackets: inside a benchmark
span and outside every program span). The last line of standard output
is a JSON object: `forward_idle_share`, `backward_idle_share` and
`optimizer_idle_share` (% of the traced benchmark spans' time, the
denominator of `device_idle_share`, so that their sum is at most it),
`ffn_ms_per_graph` (device ms of the work launched inside `ffn` spans, a
graph of the traced half), `device_idle_share`, and the longest idle gaps,
each named by the benchmark span and the innermost program span covering
its middle (`train_into/backward`). The harness's result line does not
carry these: its `Context` would have to start the recorder (PERF.md, open
questions).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict
from dataclasses import dataclass, field

from . import harness, run
from .trace import _is_kernel

PHASES = ("forward", "backward", "optimizer")


@dataclass
class Launched:
    """The traced half's device events and their launches, on the host's
    clock (perf_counter ns)."""
    events: list            # (name, start, end, correlation id): trace ns
    launches: dict          # correlation id -> (host ns, `_low32` thread)
    offset: int             # trace ns = host ns + offset
    matched: float = 0.0    # share of device events with a launch record


def _low32(tid: int) -> int:
    """A thread's identifier as the profiler's runtime records carry it:
    its low 32 bits, signed."""
    return (tid + 2 ** 31) % 2 ** 32 - 2 ** 31


def read_launches(prof, summary, mark: int) -> Launched:
    """The device events of a stopped `torch.profiler.profile` clipped to
    the summary's window, and the runtime records that launched them. The
    host's records go on the host's clock through the marker's own launch
    record (`mark`: perf_counter ns just before it), else the summary's
    offset (the marker's start on the card, which trails its launch by the
    kernel's first load, milliseconds)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], {}
    for ev in prof.profiler.kineto_results.events():
        corr = ev.correlation_id()
        if ev.device_type() == cuda:
            dev.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns(), corr))
        elif corr and (corr not in host or ev.start_ns() < host[corr][0]):
            # the API call itself: the profiler's own records under its
            # correlation id (module loading, buffer requests) come after
            host[corr] = (ev.start_ns(), _low32(ev.device_resource_id()))
    spins = sorted((s, c) for n, s, _, c in dev if "spin" in n)
    offset = summary.offset
    if spins and spins[0][1] in host:
        offset = host[spins[0][1]][0] - mark
    a, b = summary.t0, summary.t1
    events = [(n, max(s, a), min(e, b), c) for n, s, e, c in dev
              if e > a and s < b]
    launches = {c: (t - offset, tid) for c, (t, tid) in host.items()}
    matched = (sum(c in launches for *_, c in events) / len(events)
               if events else 0.0)
    return Launched(events, launches, offset, matched)


class Innermost:
    """The innermost of a thread's spans open at a time."""

    def __init__(self, spans, idxs):
        marks = []
        for i in idxs:
            # at one time: closes before opens, inner closes first
            marks.append((spans[i].t0, 1, i, i))
            marks.append((spans[i].t1, 0, -i, i))
        marks.sort()
        stack, self.times, self.tops = [], [], []
        for t, opens, _, i in marks:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            self.times.append(t)
            self.tops.append(stack[-1] if stack else -1)

    def at(self, t: int) -> int:
        k = bisect.bisect_right(self.times, t) - 1
        return self.tops[k] if k >= 0 else -1

    def pieces(self, a: int, b: int):
        """[a, b) cut where the innermost span changes: (t0, t1, span)."""
        k = bisect.bisect_right(self.times, a)
        t, top = a, self.at(a)
        while k < len(self.times) and self.times[k] < b:
            if self.times[k] > t:
                yield t, self.times[k], top
                t = self.times[k]
            top = self.tops[k]
            k += 1
        if b > t:
            yield t, b, top


@dataclass
class Charged:
    rows: dict = field(default_factory=lambda: defaultdict(
        lambda: {"n": 0, "self_ms": 0.0, "device_ms": 0.0, "port_ms": 0.0,
                 "idle_ms": 0.0, "kernels": 0}))
    phase_idle_ns: dict = field(default_factory=lambda: dict.fromkeys(
        PHASES, 0))
    ffn_ns: int = 0
    span_ns: int = 0        # the traced benchmark spans' time
    idle_ns: int = 0        # the card's idle time within them
    calls: int = 0
    graphs: int = 0
    own_thread: int = 0     # launches inside a span of their own thread
    marker_lag_ms: float = 0.0
    gaps: list = field(default_factory=list)

    def shares(self) -> dict:
        out = {f"{p}_idle_share": 100.0 * v / self.span_ns
               for p, v in self.phase_idle_ns.items()} if self.span_ns else {}
        if self.graphs:
            out["ffn_ms_per_graph"] = 1e-6 * self.ffn_ns / self.graphs
        if self.span_ns:
            out["device_idle_share"] = 100.0 * self.idle_ns / self.span_ns
        return out

    def table(self) -> str:
        per = max(self.calls, 1)
        lines = [f"{'span':<16}{'n':>8}{'host self ms':>14}"
                 f"{'device ms':>12}{'K1-K9 ms':>10}{'idle ms':>10}"
                 f"{'kernels':>10}"
                 f"   (a step or request, {self.calls} in the traced half)"]
        for name, r in self.rows.items():
            lines.append(f"{name:<16}{r['n'] / per:>8.2f}"
                         f"{r['self_ms'] / per:>14.3f}"
                         f"{r['device_ms'] / per:>12.3f}"
                         f"{r['port_ms'] / per:>10.3f}"
                         f"{r['idle_ms'] / per:>10.3f}"
                         f"{r['kernels'] / per:>10.1f}")
        return "\n".join(lines)


def _idle(busy, starts, a: int, b: int):
    """The idle intervals of [a, b) against sorted, disjoint busy ones
    (`starts`: their starts)."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    t = a
    while k < len(busy) and busy[k][0] < b:
        s, e = busy[k]
        if s > t:
            yield t, min(s, b)
        t = max(t, e)
        k += 1
    if b > t:
        yield t, b


def charge(run_rec, program, launched: Launched | None,
           n_gaps: int = 10) -> Charged:
    """Charge the traced half of `run_rec` (a `harness.Run` with its
    `trace.Summary`) to `program`, the recorder's spans."""
    summary = run_rec.trace
    out = Charged()
    calls = run_rec.calls(traced=True)
    out.calls = len(calls)
    out.graphs = sum(sp.graphs for sp in calls)
    bench = sorted((sp.t0, sp.t1, sp.name) for sp in run_rec.part(True))
    out.span_ns = sum(t1 - t0 for t0, t1, _ in bench)

    def bench_at(t):
        k = bisect.bisect_right(bench, (t, float("inf"), "")) - 1
        return bench[k][2] if k >= 0 and bench[k][1] >= t else None

    by_thread = defaultdict(list)
    for i, sp in enumerate(program):
        by_thread[_low32(sp.thread)].append(i)
    main = next((_low32(sp.thread) for sp in program if sp.parent == -1),
                None)
    inner = {tid: Innermost(program, idxs) for tid, idxs in by_thread.items()}
    none = Innermost(program, [])
    main_inner = inner.get(main, none)

    phase, under_ffn = [], []
    for i, sp in enumerate(program):
        up = phase[sp.parent] if sp.parent >= 0 else None
        phase.append(up if up is not None
                     else sp.name if sp.name in PHASES else None)
        under_ffn.append(sp.name == "ffn" or (
            sp.parent >= 0 and under_ffn[sp.parent]))

    def row(i, t):
        if i >= 0:
            return out.rows[program[i].name]
        return out.rows[f"({bench_at(t) or 'between calls'})"]

    for i, sp in enumerate(program):
        r = out.rows[sp.name]
        r["n"] += 1
        r["self_ms"] += 1e-6 * (sp.t1 - sp.t0)
        if sp.parent >= 0:
            out.rows[program[sp.parent].name]["self_ms"] -= \
                1e-6 * (sp.t1 - sp.t0)

    if launched is not None:
        for name, s, e, corr in launched.events:
            if corr not in launched.launches:
                continue
            t, tid = launched.launches[corr]
            i = inner[tid].at(t) if tid in inner else -1
            out.own_thread += i >= 0
            if i < 0:
                i = main_inner.at(t)
            r = row(i, t)
            r["device_ms"] += 1e-6 * (e - s)
            if any(k in name for k in harness.KERNELS):
                r["port_ms"] += 1e-6 * (e - s)
            r["kernels"] += _is_kernel(name)
            if i >= 0 and under_ffn[i]:
                out.ffn_ns += e - s

    busy = summary.busy_intervals()
    starts = [s for s, _ in busy]
    off = summary.offset if launched is None else launched.offset
    out.marker_lag_ms = 1e-6 * (summary.offset - off)
    for t0, t1, _ in bench:
        for a, b in _idle(busy, starts, t0 + off, t1 + off):
            out.idle_ns += b - a
            for p0, p1, i in main_inner.pieces(a - off, b - off):
                row(i, p0)["idle_ms"] += 1e-6 * (p1 - p0)
                if i >= 0 and phase[i] is not None:
                    out.phase_idle_ns[phase[i]] += p1 - p0

    gaps = list(_idle(busy, starts, summary.t0, summary.t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:n_gaps]:
        mid = (a + b) // 2 - off
        name = bench_at(mid)
        i = main_inner.at(mid)
        if name is None:
            name = "host between calls"
        elif i >= 0:
            name = f"{name}/{program[i].name}"
        out.gaps.append([name, (b - a) * 1e-9])
    return out


class SpanContext(run.Context):
    """`run.Context` that records the program's spans over the traced
    half and keeps the device trace's launches."""

    program: list = []
    launched: Launched | None = None

    def tick(self) -> bool:
        started = super().tick()
        if started:
            from egt_torch import tracing
            tracing.start()
        return started

    def end_window(self):
        from egt_torch import tracing
        tracer = self.tracer
        prof = tracer.prof if tracer is not None else None
        summary, t1_ns = super().end_window()
        self.program = tracing.stop()
        if prof is not None:
            self.launched = read_launches(prof, summary, tracer.mark)
        return summary, t1_ns


def run_cell(name: str, seed: int, seconds: float):
    """`run.run_cell` of a traced run on the card, with the spans:
    returns (the result line, its `Charged`, the share of device events
    whose launch was found)."""
    import torch

    cell = harness.load_cell(name)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(run.CHECKOUT / "build" / sub)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    ctx = SpanContext(cell, seed, seconds, True, torch.device("cuda"))
    try:
        ctx.lap("imports")
        with ctx.phase("kernel build"):
            run.build(cell)
        if cell.mode == "train":
            from . import train as mode
        else:
            from . import serve as mode
        out = mode.run(ctx)
    finally:
        for fn in ctx.cleanup:
            fn()
    line = run.result(ctx, cell, out, harness.ROOT)
    charged = charge(out["run"], ctx.program, ctx.launched)
    return line, charged, ctx.launched.matched if ctx.launched else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.CHECKOUT))
    line, charged, matched = run_cell(args.workload, args.seed, args.seconds)
    print(charged.table(), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": line["correct"],
                      "launches_found": matched, **charged.shares(),
                      "idle_gaps": charged.gaps,
                      "marker_lag_ms": charged.marker_lag_ms,
                      "launches_on_own_thread": charged.own_thread}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
