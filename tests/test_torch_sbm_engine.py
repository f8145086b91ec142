"""The port's training engine on a PATTERN scheme against the JAX package's
on the CPU, with length buckets.

- A 2-epoch run of `pattern.svd` (2 layers, width 16, edge width 8, 4
  heads, f32, no random draws, buckets 24 / 32) on `make_pattern_like`
  graphs of 10-30 nodes, from the same initial weights: every field of
  every `metrics.jsonl` record (loss, xent, acc, val_loss, val_xent,
  val_acc, lr) to 1e-4 relative, as the ZINC engine test holds them, and
  the plateau state.
- Both bucket shapes run in every split, through `predict_split` too.
- Resuming to epoch 3 equals 3 straight epochs bit for bit, with the draws
  live; gradient accumulation keeps one pending group a bucket shape.
- `do_evaluations` on the JAX run's final weights prints the JAX module's
  SBM lines (its scikit-learn metrics) for each split.
- `python -m egt_torch.run_training` on the shipped PATTERN config refuses
  to start without a GPU unless asked for the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.trainer import accum_groups
from egt_torch.weights import flat_arrays, load_flat_params
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_pattern_like

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("loss", "xent", "acc", "val_loss", "val_xent", "val_acc", "lr")
BUCKETS = [24, 32]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sbm_engine")
    # 20 records a split at batch 8: each bucket gets a full batch and a
    # partial one
    make_pattern_like(str(d / "pattern.h5"), n_records=20, n_min=10,
                      n_max=30)
    return d


def tiny_config(d, name, **kw):
    cfg = {
        "scheme": "pattern.svd",
        "model_name": name,
        "dataset_path": str(d / "pattern.h5"),
        "cache_dir": str(d / "cache" / name),
        "save_path": str(d / "models" / name),
        "batch_size": 8,
        "num_epochs": 2,
        "model_width": 16,
        "edge_width": 8,
        "model_height": 2,
        "num_heads": 4,
        "use_svd": False,
        "upto_hop": 2,
        "initial_lr": 1e-3,
        "rlr_patience": 1,
        "log_tensorboard": False,
        "compute_dtype": "float32",
        "attention_impl": "einsum",
        "use_pallas": False,
        "random_mask_prob": 0.0,
        "dropout": 0.0,
        "length_buckets": BUCKETS,
    }
    cfg.update(kw)
    return cfg


def records(d, name):
    with open(d / "models" / name / "logs" / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


@pytest.fixture(scope="module")
def jax_run(workdir):
    js = jimport("pattern.svd")(tiny_config(workdir, "jax"))
    js.save_config_file()
    js.load_data()
    js.load_model()
    init = jckpt._flatten_params(jax.device_get(js.params))
    js.load_state()
    js.train_model()
    js.finalize_training(skip_init=True)
    return js, init


@pytest.fixture(scope="module")
def port_run(workdir, jax_run):
    ts = timport("pattern.svd")(tiny_config(workdir, "port"), device="cpu")
    ts.save_config_file()
    ts.load_data()
    ts.load_model()
    load_flat_params(ts.model, jax_run[1])
    ts.load_state()
    ts.train_model()
    ts.finalize_training(skip_init=True)
    return ts


def test_bucketed_epoch_loop_matches_jax(workdir, jax_run, port_run):
    js = jax_run[0]
    got, ref = records(workdir, "port"), records(workdir, "jax")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["epoch"] == r["epoch"]
        for k in FIELDS:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=k)
    for k in ("current_epoch", "global_step", "save_best_epoch",
              "last_reduce_lr"):
        assert port_run.state[k] == js.state[k], k
    np.testing.assert_allclose(port_run.state["save_best_value"],
                               js.state["save_best_value"], rtol=1e-4)
    assert port_run.config.save_best_monitor == "val_xent"


def test_every_split_runs_both_buckets(port_run):
    for split in ("training", "validation"):
        pads = {b["node_features"].shape[1]
                for b in port_run._batches(split, shuffle=False)}
        assert pads == set(BUCKETS), (split, pads)
    shapes = set()
    for batch, out in port_run.predict_split("validation"):
        assert out.shape == batch["target"].shape + (2,)
        assert out.dtype == np.float32 and np.all(np.isfinite(out))
        shapes.add(out.shape[1])
    assert shapes == set(BUCKETS)


def _run(d, name, **kw):
    ts = timport("pattern.svd")(tiny_config(d, name, **kw), device="cpu")
    ts.execute_training()
    return flat_arrays(ts.model), ts


def test_resume_equals_uninterrupted_run(workdir):
    draws = dict(random_mask_prob=0.1, dropout=0.1)
    _run(workdir, "resumed", num_epochs=2, **draws)
    resumed, ts = _run(workdir, "resumed", num_epochs=3, **draws)
    straight, _ = _run(workdir, "straight", num_epochs=3, **draws)
    assert ts.state["current_epoch"] == 3
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)
    a, b = records(workdir, "resumed"), records(workdir, "straight")
    assert [r["loss"] for r in a] == [r["loss"] for r in b]


def test_grad_accum_keeps_a_group_per_bucket(workdir):
    _, ts = _run(workdir, "accum", num_epochs=1, grad_accum_steps=2)
    groups = list(accum_groups(ts._batches("training", shuffle=True), 2))
    assert all(len({b["node_features"].shape for b in g}) == 1
               for g in groups)
    assert ts.state["global_step"] == len(groups)


def test_do_evaluations_prints_the_jax_lines(workdir, jax_run, port_run):
    final = str(workdir / "models" / "jax" / "saved" / "jax.npz")
    lines = {}
    for name, make in (("jax_eval", jimport), ("port_eval", timport)):
        cfg = tiny_config(workdir, name, weight_file=final)
        s = make("pattern.svd")(cfg) if make is jimport else \
            make("pattern.svd")(cfg, device="cpu")
        s.do_evaluations()
        preds = workdir / "models" / name / "predictions"
        lines[name] = {split: (preds / f"{split}_evals.txt").read_text()
                       for split in ("trainset", "valset", "testset")}
    assert lines["port_eval"] == lines["jax_eval"]
    for text in lines["port_eval"].values():
        assert [ln.split(" =")[0].split(":")[0] for ln in text.splitlines()] \
            == ["Accuracy", "Micro Recall", "Macro Recall",
                "Weighted Accuracy", "Log loss"]


def test_cli_on_the_shipped_config_needs_a_gpu_or_the_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    res = subprocess.run(
        [sys.executable, "-m", "egt_torch.run_training",
         "configs/main/pattern/500k/egt.json"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device is available; pass --device cpu" in res.stderr
