"""Spans of the port's own work on the host's clock: a training step's
phases, the model's embedding, layers and readout, each layer's attention
and FFN sub-layers, and a request's forward and readback.

    from egt_torch import tracing
    tracing.start()
    trainer.train_into(acc, group)
    spans = tracing.stop()      # [Span], in the order they opened

`span(name)` is a context manager. While nothing records it returns one
shared no-op object (`NO_SPAN`), so a span costs the test of a global.
`start()` begins recording into a new `Recorder` and `stop()` ends it and
returns its spans. A `Span` holds its `name`; `t0` and `t1` from
`time.perf_counter_ns()`; `parent`, the index of the innermost span open
on its thread when it opened (on a thread with none open, such as
autograd's device thread running a recomputed layer under `remat`, the
innermost span open on the thread that called `start()`; -1 for none);
`thread`, the opening thread's `threading.get_ident()` (whose low 32
bits the profiler's runtime records carry); `group`, the identifier its
outermost span was given and every span under it shares (the trainer's
step, or `load_predictor`'s count of requests); and `index`, a layer's
index. With `annotate` (`StepTracer`, under `profile_dir`) each span also
opens a `torch.profiler.record_function` of its name, so the profiler's
trace shows the spans with the kernels they launched under them.

The spans: `training/steps.py` `step`, then for each micro-batch
`forward`, `loss`, `backward` and `accumulate`, then `optimizer`;
`models/graph_model.py` `embed`, `layer` (with its `index`) and
`readout`; `models/layers.py` `attention` (the attention sub-layer with
its node and edge tails, and the whole-layer or edge-block kernel where
the layer takes one) and `ffn` (`ffn_block`); `serving.py` `predict`,
holding `forward` and `readback` (the wait for the card and the copy of
the predictions to the host). The exported artifact records none.
"""

from __future__ import annotations

import threading
import time

import torch


class Span:
    """A recorded span, and the context manager that records it."""

    __slots__ = ("name", "t0", "t1", "parent", "thread", "group", "index",
                 "_rec", "_rf")

    def __init__(self, rec, name, group=None, index=None):
        self.name, self.group, self.index = name, group, index
        self.t0 = self.t1 = self.thread = self._rf = None
        self.parent = -1
        self._rec = rec

    def __enter__(self):
        rec = self._rec
        if rec.annotate:
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        self.thread = tid = threading.get_ident()
        stack = rec.open.get(tid)
        if stack is None:
            stack = rec.open[tid] = []
        outer = stack or rec.open.get(rec.main)
        if outer:
            self.parent = outer[-1]
            if self.group is None:
                self.group = rec.spans[self.parent].group
        with rec.lock:
            stack.append(len(rec.spans))
            rec.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self._rec.open[self.thread].pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, "
                f"parent={self.parent}, group={self.group}, "
                f"index={self.index})")


class Recorder:
    """The spans of one recording, and the indices of those open on each
    thread."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: list[Span] = []
        self.main = threading.get_ident()
        self.open: dict[int, list[int]] = {}
        self.lock = threading.Lock()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


_active: Recorder | None = None


def span(name: str, group=None, index: int | None = None):
    """A span named `name` while recording (`group` for an outermost span,
    `index` for a layer), else `NO_SPAN`."""
    rec = _active
    if rec is None:
        return NO_SPAN
    return Span(rec, name, group, index)


def start(annotate: bool = False) -> None:
    """Begin recording; with `annotate`, each span also opens a
    `record_function` of its name."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing: already recording")
    _active = Recorder(annotate)


def stop() -> list[Span]:
    """End the recording; returns its spans (none if nothing recorded)."""
    global _active
    rec, _active = _active, None
    return [] if rec is None else rec.spans
