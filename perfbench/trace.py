"""The device trace of a measured window, and what the metrics read of it.

`torch.profiler` records the card's activity (kernels, copies, memsets)
through CUPTI; the host's own spans (`harness.Spans`) are on the host's
monotonic clock. They are placed on the trace's clock by a marker: a
spin kernel launched on an idle card just before the window, whose start
on the device follows its launch on the host by a few microseconds (by
the system clock's offset where the marker is not found).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

COPY = ("Memcpy HtoD", "Memcpy DtoH")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Summary:
    def __init__(self, events, t0: int, t1: int, offset: int):
        # events: (name, start_ns, end_ns) clipped to [t0, t1]
        self.events = sorted(events, key=lambda e: e[1])
        self.t0, self.t1 = t0, t1
        self.offset = offset            # trace ns = perf_counter ns + offset

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in self.events:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def busy_within(self, spans) -> float:
        """Seconds of device activity inside `spans`, (t0, t1) pairs on
        the host's clock (perf_counter ns) that do not overlap."""
        busy = self.busy_intervals()
        total, j = 0, 0
        for t0, t1 in sorted(spans):
            a, b = t0 + self.offset, t1 + self.offset
            while j < len(busy) and busy[j][1] <= a:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < b:
                total += min(b, busy[k][1]) - max(a, busy[k][0])
                k += 1
        return total * 1e-9

    def time_s(self, pred) -> float:
        return sum(e - s for n, s, e in self.events if pred(n)) * 1e-9

    def kernel_s(self, patterns) -> float:
        return self.time_s(lambda n: any(p in n for p in patterns))

    def other_kernel_s(self, patterns) -> float:
        return self.time_s(lambda n: _is_kernel(n)
                           and not any(p in n for p in patterns))

    def copy_s(self) -> float:
        return self.time_s(lambda n: n.startswith(COPY))

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(int)
        for name, s, e in self.events:
            tot[name[:96]] += e - s
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> list:
        """The longest gaps with no device activity, each named by the
        host span that covers its middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2 - self.offset
            name = next((sp.name for sp in spans if sp.t0 <= mid <= sp.t1),
                        "host between calls")
            out.append([name, (e - s) * 1e-9])
        return out


class DeviceTrace:
    """Profile the card from `start` to `stop`."""

    def start(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.clock = time.time_ns() - time.perf_counter_ns()
        self.mark = time.perf_counter_ns()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> Summary:
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self.prof.stop()
        raw = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
               for ev in self.prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA]
        self.prof = None
        marks = [s for n, s, _ in raw if "spin" in n]
        offset = min(marks) - self.mark if marks else self.clock
        a, b = self.t0 + offset, t1 + offset
        events = [(n, max(s, a), min(e, b)) for n, s, e in raw
                  if e > a and s < b]
        return Summary(events, a, b, offset)
