"""The port's training engine on the TSP scheme against the JAX package's on
the CPU.

- A 2-epoch run of `tsp.svd` (2 layers, width 16, edge width 8, 4 heads,
  f32, length buckets 16 / 24) on `make_tsp_like` graphs of 10-24 points
  with dense node and edge features, the SVD PE from the reader's cache
  and the (b, l, l) edge labels, from the same initial weights: every
  field of every `metrics.jsonl` record (loss, xent, acc, val_loss,
  val_xent, val_acc, lr) to 1e-4 relative, as the ZINC, PATTERN and MNIST
  engine tests hold them, and the plateau state. The run keeps
  `random_neg` and the random mask off: the two packages draw different
  bits.
- `do_evaluations` through the port's CLI entry point on the JAX run's
  final weights prints the JAX module's accuracy, precision, recall and F1
  lines (scikit-learn's there, numpy's here) for each split.
"""

import json

import jax
import numpy as np
import pytest

from egt_torch import do_evaluations
from egt_torch.training.schemes import import_scheme as timport
from egt_torch.weights import load_flat_params
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_tsp_like

FIELDS = ("loss", "xent", "acc", "val_loss", "val_xent", "val_acc", "lr")
BUCKETS = [16, 24]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsp_engine")
    # 20 records a split at batch 8, in two buckets
    make_tsp_like(str(d / "tsp.h5"), n_records=20, n_min=10, n_max=24)
    return d


def tiny_config(d, name, **kw):
    cfg = {
        "scheme": "tsp.svd",
        "model_name": name,
        "dataset_path": str(d / "tsp.h5"),
        "cache_dir": str(d / "cache" / name),
        "save_path": str(d / "models" / name),
        "batch_size": 8,
        "num_epochs": 2,
        "model_width": 16,
        "edge_width": 8,
        "model_height": 2,
        "num_heads": 4,
        "use_svd": True,
        "num_svd_features": 8,
        "sel_svd_features": 4,
        "random_neg": False,
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
    js = jimport("tsp.svd")(tiny_config(workdir, "jax"))
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
    ts = timport("tsp.svd")(tiny_config(workdir, "port"), device="cpu")
    ts.save_config_file()
    ts.load_data()
    ts.load_model()
    load_flat_params(ts.model, jax_run[1])
    ts.load_state()
    ts.train_model()
    ts.finalize_training(skip_init=True)
    return ts


def test_epoch_loop_matches_jax(workdir, jax_run, port_run):
    js = jax_run[0]
    got, ref = records(workdir, "port"), records(workdir, "jax")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["epoch"] == r["epoch"]
        assert sorted(g) == sorted(r)
        for k in FIELDS:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=k)
    for k in ("current_epoch", "global_step", "save_best_epoch",
              "last_reduce_lr"):
        assert port_run.state[k] == js.state[k], k
    np.testing.assert_allclose(port_run.state["save_best_value"],
                               js.state["save_best_value"], rtol=1e-4)
    assert port_run.config.save_best_monitor == "val_xent"
    # both buckets in the split, edge logits a pair
    shapes = set()
    for batch, out in port_run.predict_split("validation"):
        assert out.shape == batch["target"].shape + (2,)
        assert out.dtype == np.float32 and np.all(np.isfinite(out))
        shapes.add(out.shape[1])
    assert shapes == set(BUCKETS)


def test_do_evaluations_prints_the_jax_lines(workdir, jax_run, port_run):
    final = str(workdir / "models" / "jax" / "saved" / "jax.npz")
    js = jimport("tsp.svd")(tiny_config(workdir, "jax_eval",
                                        weight_file=final))
    js.do_evaluations()
    path = workdir / "port_eval.json"
    path.write_text(json.dumps(tiny_config(workdir, "port_eval",
                                           weight_file=final)))
    do_evaluations.main([str(path), "--device", "cpu"])
    for split in ("trainset", "valset", "testset"):
        got = (workdir / "models" / "port_eval" / "predictions"
               / f"{split}_evals.txt").read_text()
        ref = (workdir / "models" / "jax_eval" / "predictions"
               / f"{split}_evals.txt").read_text()
        assert got == ref
        assert [ln.split(" = ")[0] for ln in got.splitlines()] == [
            "Accuracy", "Precision", "Recall", "f1"]
