"""`perfbench/spans.py` on a synthetic traced step: the card's idle time
and the launched work charged to the program's spans, and the idle gaps
named by them."""

import pytest

from egt_torch.tracing import Span as ProgramSpan
from perfbench import harness, spans
from perfbench.trace import Summary

MAIN, AUTOGRAD = 11, 12
OFFSET = 1000                   # trace ns = host ns + OFFSET


def _program():
    """step ⊃ forward ⊃ layer ⊃ (attention, ffn); loss; backward;
    accumulate; optimizer, on the main thread (host ns)."""
    out = []
    for name, t0, t1, parent in (
            ("step", 110, 990, -1), ("forward", 120, 400, 0),
            ("layer", 130, 390, 1), ("attention", 140, 250, 2),
            ("ffn", 260, 380, 2), ("loss", 400, 420, 0),
            ("backward", 430, 800, 0), ("accumulate", 800, 820, 0),
            ("optimizer", 830, 980, 0)):
        sp = ProgramSpan(None, name, group=0)
        sp.t0, sp.t1, sp.parent, sp.thread = t0, t1, parent, MAIN
        out.append(sp)
    return out


# device work, trace ns: an attention kernel, an FFN kernel, a kernel of
# the backward (launched on autograd's thread, which opened no span) and
# one of the optimizer
EVENTS = [("attn", 1150, 1240, 1), ("ffn_lr1", 1270, 1370, 2),
          ("bwd", 1450, 1600, 3), ("adam", 1850, 1900, 4)]
LAUNCHES = {1: (145, MAIN), 2: (265, MAIN), 3: (450, AUTOGRAD),
            4: (840, MAIN)}


@pytest.fixture
def charged():
    summary = Summary([(n, s, e) for n, s, e, _ in EVENTS], OFFSET,
                      OFFSET + 1000, OFFSET)
    bench = [harness.Span("batch fetch", 0, 100),
             harness.Span("train_into", 100, 1000, graphs=10)]
    run_rec = harness.Run(mode="train", model={}, bf16=True, peaks=None,
                          t0_ns=0, t1_ns=1000, spans=bench, split_ns=0,
                          trace=summary)
    return spans.charge(run_rec, _program(),
                        spans.Launched(EVENTS, LAUNCHES, OFFSET, 1.0))


def test_idle_time_goes_to_the_outermost_phase(charged):
    s = charged.shares()
    # busy 390 of the 1000 ns in the benchmark's spans
    assert s["device_idle_share"] == pytest.approx(61.0)
    # forward: 120-150, 240-270, 370-400; backward: 430-450, 600-800;
    # optimizer: 830-850, 900-980
    assert s["forward_idle_share"] == pytest.approx(9.0)
    assert s["backward_idle_share"] == pytest.approx(22.0)
    assert s["optimizer_idle_share"] == pytest.approx(10.0)
    assert sum(s[f"{p}_idle_share"] for p in spans.PHASES) <= \
        s["device_idle_share"]
    # the rest: the fetch, the step outside its phases, loss, accumulate
    rows = charged.rows
    assert rows["(batch fetch)"]["idle_ms"] * 1e6 == pytest.approx(100)
    assert rows["loss"]["idle_ms"] * 1e6 == pytest.approx(20)
    assert rows["attention"]["idle_ms"] * 1e6 == pytest.approx(20)


def test_work_goes_to_the_span_that_launched_it(charged):
    assert charged.shares()["ffn_ms_per_graph"] == pytest.approx(1e-5)
    rows = charged.rows
    assert (rows["ffn"]["kernels"], rows["ffn"]["device_ms"] * 1e6) == (
        1, pytest.approx(100))
    # autograd's thread opened no span: its launch is the main thread's
    assert rows["backward"]["kernels"] == 1
    assert rows["backward"]["device_ms"] * 1e6 == pytest.approx(150)
    assert rows["optimizer"]["kernels"] == 1
    assert rows["step"]["self_ms"] * 1e6 == pytest.approx(880 - 280 - 20
                                                          - 370 - 20 - 150)


def test_idle_gaps_are_named_by_the_program(charged):
    assert charged.gaps[0][0] == "train_into/backward"
    assert charged.gaps[0][1] == pytest.approx(250e-9)
    names = [g[0] for g in charged.gaps]
    assert names[:3] == ["train_into/backward", "batch fetch",
                         "train_into/optimizer"]
    assert "between calls" not in " ".join(names)


def test_innermost_cuts_at_each_boundary():
    inner = spans.Innermost(_program(), range(9))
    assert [inner.at(t) for t in (100, 115, 145, 255, 265, 395, 985)] == [
        -1, 0, 3, 2, 4, 1, 0]
    assert list(inner.pieces(235, 270)) == [(235, 250, 3), (250, 260, 2),
                                            (260, 270, 4)]
