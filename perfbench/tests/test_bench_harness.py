"""The harness is driven by data: a configuration, a cell and a per-layer
metric added as files only are found and run. And `correct` comes out
false when the timed path is broken underneath: a step that returns its
state unchanged, half of the batch left out with the mean over the rest,
an answer altered where it is produced. (The exchange between chips is
not a fault a one-chip cell can have.) The control, the reference in
float8 in the program's place, fails each cell's limits at a small
size."""

import json

import numpy as np
import pytest
import torch

from perfbench import harness, run, traffic
from perfbench.reference import compare, model as rmodel, rng, train as rtrain

NEW_METRIC = '''
NAME = "graphs_per_call"
UNIT = "graphs"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "step"
MOVES = ("train_graphs_per_s",)


def read(run):
    calls = run.calls(traced=False)
    return sum(sp.graphs for sp in calls) / len(calls) if calls else None
'''


def test_new_files_are_found_and_run(tiny_bf16):
    root = tiny_bf16
    cfg = json.loads((root / "configs" / "tiny-pattern-500k.json").read_text())
    cfg["name"] = "tiny-pattern-wide"
    cfg["run_config"]["model_width"] = cfg["reference"]["width"] = 32
    (root / "configs" / "tiny-pattern-wide.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "tiny-pattern-500k.train.json")
                      .read_text())
    cell["config"] = "tiny-pattern-wide"
    cell["traffic"]["name"] = "pattern-corpus-small"
    (root / "workloads" / "tiny-pattern-wide.train.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "graphs_per_call.py").write_text(NEW_METRIC)
    line = run.run_cell("tiny-pattern-wide.train", 7, 0.5, False,
                        device="cpu", root=root)
    assert line["correct"]
    assert line["metrics"]["graphs_per_call.train_graphs_per_s"]["value"] == 8
    assert "train_graphs_per_s" in line["metrics"]
    assert "data_wait_share.train_graphs_per_s" in line["metrics"]
    # device metrics are not measured on the CPU: left out of the line
    for name in ("mfu", "kernel_roofline", "device_idle_share",
                 "torch_ops_ms_per_graph"):
        assert f"{name}.train_graphs_per_s" not in line["metrics"]
    entries = {e["name"]: e for e in harness.per_layer_entries(root)}
    assert entries["graphs_per_call.train_graphs_per_s"]["workloads"] == [
        "pattern-500k.train", "tiny-pattern-500k.train",
        "tiny-pattern-wide.train"]
    assert line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks"


def test_benchmark_json_follows_the_files():
    """`BENCHMARK.json` lists what the cells' and metrics' files give."""
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    assert bench["per_layer"] == harness.per_layer_entries()
    cells = {w["name"]: harness.load_cell(w["name"])
             for w in bench["workloads"]}
    for w in bench["workloads"]:
        c = cells[w["name"]]
        assert (w["config"], w["chips"], w["why"]) == (
            c.spec["config"], c.spec["chips"], c.spec["why"])
    for m in bench["end_to_end"]:
        if m["name"] != "setup_s":
            assert m["workloads"] == sorted(
                n for n, c in cells.items()
                if m["name"] in c.spec["end_to_end"])


def test_device_metrics_read_the_traced_half():
    """Idle within the program's spans of the traced half, on a trace
    whose clock is the host's plus an offset; `mfu` over the untraced
    half's calls."""
    from perfbench.trace import Summary

    ms = 1_000_000
    off = 7 * ms
    # the card busy 10-14 and 16-17 ms on the host's clock
    tr = Summary([("k", 10 * ms + off, 14 * ms + off),
                  ("k", 16 * ms + off, 17 * ms + off)],
                 8 * ms + off, 20 * ms + off, off)
    spans = [harness.Span("predict", 0, 4 * ms, graphs=2, pad=8, batch=2),
             harness.Span("predict", 9 * ms, 12 * ms, graphs=2, pad=8,
                          batch=2),
             harness.Span("predict", 13 * ms, 18 * ms, graphs=2, pad=8,
                          batch=2)]
    r = harness.Run(mode="serve", model={}, bf16=True, peaks=None, t0_ns=0,
                    t1_ns=20 * ms, spans=spans, split_ns=8 * ms, trace=tr)
    idle = harness.load_metrics(["serve_latency_p95_ms"])
    read = {m.name.split(".")[0]: m.read for m in idle}
    # spans 9-12 and 13-18 ms: 8 ms, of which 2 + 1 + 1 busy
    assert abs(read["device_idle_share"](r) - 50.0) < 1e-9
    assert [sp.t0 for sp in r.calls(traced=False)] == [0]
    assert r.untraced_s == 8e-3


def _half_batch(monkeypatch):
    from egt_torch.training import steps

    orig = steps.Trainer._loss

    def loss(self, batch, training, seeds=None, pe_seed=None):
        sm = torch.as_tensor(batch["sample_mask"]).clone()
        sm[sm.shape[0] // 2:] = 0.0
        return orig(self, {**batch, "sample_mask": sm}, training, seeds,
                    pe_seed)
    monkeypatch.setattr(steps.Trainer, "_loss", loss)


def _unchanged(monkeypatch):
    from egt_torch.training import optim
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)


def _altered(monkeypatch):
    from egt_torch import serving

    orig = serving.load_predictor

    def load(*a, **k):
        fn = orig(*a, **k)

        def predict(batch):
            out = fn(batch)
            out[0] += 0.5
            return out
        return predict
    monkeypatch.setattr(serving, "load_predictor", load)


@pytest.mark.parametrize("cell,fault", [
    ("egt-large.train", _unchanged), ("egt-large.train", _half_batch),
    ("pattern-500k.train", _unchanged), ("pattern-500k.train", _half_batch),
    ("egt-large.serve", _altered), ("pattern-500k.serve", _altered)])
def test_faults_make_correct_false(cell, fault, tiny_bf16, monkeypatch):
    fault(monkeypatch)
    line = run.run_cell(f"tiny-{cell}", 12, 0.5, False, device="cpu",
                        root=tiny_bf16)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["egt-large.train", "pattern-500k.train",
                                  "egt-large.serve", "pattern-500k.serve"])
def test_control_fails_the_limits(cell, small):
    """The reference computed in float8 against the float32 reference at
    the configuration's widths and depth, on small batches of the cell's
    traffic with its weights and draws, over three seeds; each seed fails
    the cell's limits."""
    c = harness.load_cell(f"tiny-{cell}", small)
    limits = harness.load_cell(cell).spec["limits"]
    spec = rmodel.Spec.from_dict(c.config["reference"])
    for seed in (1, 2, 3):
        w = rmodel.init_params(spec, rng.fold_seed(seed, 1), "cpu")
        r = np.random.default_rng([seed, 2])
        if c.mode == "train":
            from perfbench.train import check_batches
            recs = traffic.records(c.traffic["generator"], c.traffic["groups"],
                                   r)
            steps = check_batches(c, recs, seed, 3)
            lrs = [float(c.config["run_config"]["initial_lr"])] * 3
            ref = rtrain.run_steps(spec, w, steps, lrs, seed, 5.0, "cpu")
            ctl = rtrain.run_steps(spec, w, steps, lrs, seed, 5.0, "cpu",
                                   precision="float8")
            numbers = compare.train_numbers(ctl, ref)
        else:
            from perfbench.reference import batch as rbatch
            gaps = []
            for req in c.traffic["pool"]:
                recs = traffic.records(c.traffic["generator"], req["groups"],
                                       r)
                b = rbatch.collate(recs, len(recs), req["pad"])
                t = {k: torch.as_tensor(v) for k, v in b.items()}
                with torch.no_grad():
                    p32 = rmodel.Forward(spec, w)(t).numpy()
                    p8 = rmodel.Forward(spec, w, "float8")(t).numpy()
                gaps.append(compare.serve_numbers(p8, p32, b))
            numbers = compare.worst(gaps)
        ok, checks = compare.judge(numbers, limits)
        assert not ok, (seed, checks)
