"""The port's spans (`egt_torch/tracing.py`) on the CPU at a small size
(2 layers, width 16, edge width 8, 4 heads, l 12, b 4, f32): nothing is
recorded unless asked; a recorded step and a recorded request give the
tree of spans that `tracing.py` lists, nested in time, one identifier a
step or a request, on the plain path, the whole-layer kernel's path and
under `remat`; recording changes nothing a step computes; threads keep
their own nesting."""

import sys
import threading

import numpy as np
import pytest
import torch

from egt_torch import tracing
from egt_torch.serving import load_predictor
from egt_torch.training.steps import load_trainer
from tests.test_model_forward import random_zinc_batch

PATHS = {"plain": dict(use_pallas=False, attention_impl="einsum"),
         "whole_layer_kernel": dict(use_pallas=True, use_pallas_layer=True)}
HEIGHT = 2


def _config(**kw):
    return {"scheme": "zinc.svd", "use_svd": False, "model_width": 16,
            "edge_width": 8, "model_height": HEIGHT, "num_heads": 4,
            "upto_hop": 2, "compute_dtype": "float32",
            "random_mask_prob": 0.1, "attn_dropout": 0.1, "dropout": 0.1,
            **kw}


def _tree(spans, parent=-1):
    """The spans under `parent` as (name, [children]) in opening order."""
    return [(sp.name, _tree(spans, i)) for i, sp in enumerate(spans)
            if sp.parent == parent]


def _nested_in_time(spans):
    for sp in spans:
        assert sp.t0 <= sp.t1
        if sp.parent >= 0:
            outer = spans[sp.parent]
            assert outer.t0 <= sp.t0 and sp.t1 <= outer.t1, sp


LAYER = ("layer", [("attention", []), ("ffn", [])])
FORWARD = ("forward", [("embed", [])] + [LAYER] * HEIGHT + [("readout", [])])


def test_nothing_is_recorded_by_default():
    assert tracing.span("step", group=3) is tracing.NO_SPAN
    with tracing.span("forward") as sp:
        assert sp is None
    assert tracing.stop() == []
    tracing.start()
    try:
        with pytest.raises(RuntimeError, match="already recording"):
            tracing.start()
    finally:
        tracing.stop()
    assert tracing.span("step") is tracing.NO_SPAN


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("path", list(PATHS))
def test_a_step_of_two_micro_batches(path, remat):
    tr = load_trainer(_config(grad_accum_steps=2, remat=remat,
                              **PATHS[path]), device="cpu")
    rng = np.random.default_rng(0)
    group = [random_zinc_batch(rng), random_zinc_batch(rng)]
    assert tr.model.cfg.fused_layer == (path == "whole_layer_kernel")
    tr.step = 5
    tracing.start()
    try:
        tr.train_into(tr.accumulator(), group)
    finally:
        spans = tracing.stop()
    backward = ("backward", [LAYER] * HEIGHT if remat else [])
    micro = [FORWARD, ("loss", []), backward, ("accumulate", [])]
    assert _tree(spans) == [("step", micro * 2 + [("optimizer", [])])]
    _nested_in_time(spans)
    assert {sp.group for sp in spans} == {5}
    # the backward recomputes the layers last to first
    order = list(range(HEIGHT))
    assert [sp.index for sp in spans if sp.name == "layer"] == 2 * (
        order + order[::-1] if remat else order)
    assert {sp.thread for sp in spans} == {threading.get_ident()}


def test_a_request():
    cfg = _config(**PATHS["plain"])
    predict = load_predictor(cfg, load_trainer(cfg, device="cpu")
                             .flat_params(), device="cpu")
    batch = random_zinc_batch(np.random.default_rng(1))
    predict(batch)
    tracing.start()
    try:
        out = [predict(batch), predict(batch)]
    finally:
        spans = tracing.stop()
    np.testing.assert_array_equal(out[0], out[1])
    request = ("predict", [FORWARD, ("readback", [])])
    assert _tree(spans) == [request, request]
    _nested_in_time(spans)
    heads = [i for i, sp in enumerate(spans) if sp.parent == -1]
    assert [spans[i].group for i in heads] == [1, 2]
    for i, sp in enumerate(spans):
        top = i
        while spans[top].parent >= 0:
            top = spans[top].parent
        assert sp.group == spans[top].group


@pytest.mark.parametrize("path", list(PATHS))
def test_recording_changes_nothing_a_step_computes(path):
    cfg = _config(grad_accum_steps=2, **PATHS[path])
    rng = np.random.default_rng(2)
    group = [random_zinc_batch(rng), random_zinc_batch(rng)]
    runs = []
    for record in (False, True):
        tr = load_trainer(cfg, device="cpu")
        acc = tr.accumulator()
        if record:
            tracing.start()
        try:
            tr.train_into(acc, group)
        finally:
            spans = tracing.stop()
        assert bool(spans) == record
        runs.append((acc.result()["loss"],
                     {k: p.detach().clone()
                      for k, p in tr.model.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert sorted(p0) == sorted(p1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_threads_keep_their_own_nesting():
    """Spans opened on several threads at once: each inner span's parent
    is its own thread's, and a thread with none open hangs its spans
    under the recording thread's innermost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.start()
    try:
        with tracing.span("outer", group="main"):
            def work(k):
                for _ in range(200):
                    with tracing.span("a", group=k), tracing.span("b"):
                        pass
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        spans = tracing.stop()
    assert len(spans) == 1 + 8 * 200 * 2
    for sp in spans[1:]:
        if sp.name == "a":
            assert sp.parent == 0
        else:
            outer = spans[sp.parent]
            assert (outer.name, outer.thread, outer.group) == (
                "a", sp.thread, sp.group)
    _nested_in_time(spans)
