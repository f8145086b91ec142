"""The port's training engine against the JAX package's on the CPU.

- A 2-epoch run of a tiny ZINC config (2 layers, width 16, edge width 8, 4
  heads, f32, no random draws) from the same initial weights: every field
  of every `metrics.jsonl` record (loss, mae, val_loss, val_mae, lr) to 1e-4
  relative, the plateau state, and the saved weights to 1e-4 of each
  parameter's scale. The two sum the same f32 products in other orders
  (`tests/test_torch_training.py` holds one step's gradients to 1e-4), and
  Adam steps of lr 1e-3 over 6 steps keep that far below 1e-4 of a weight.
- Resuming: 2 epochs and a resume to 3 equal 3 straight epochs bit for bit
  (the CPU sums in one order; the draws follow the global step).
- Gradient accumulation: 2 microbatches of 16 give the gradients of one
  batch of 32 (f32 round-off: 1e-5 of the largest gradient) on graph-level
  data with a fixed pad, as `tests/test_grad_accum.py` checks in JAX.
- The L2 penalty: the loss and every gradient of `Trainer.compute_loss`
  with `l2_reg` > 0 against the JAX `_compute_loss` (1e-5 and 1e-4, as the
  model's gradients).
- Weight files move both ways, and `weight_file` ":", "" and "-" pick the
  same file as in JAX.
- The CLI triple runs in a subprocess on the CPU, and refuses to start
  without a GPU unless asked for the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from egt_torch import tracing
from egt_torch.training import checkpoint as tckpt
from egt_torch.training import metrics as tm
from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.trainer import accum_groups
from egt_torch.weights import flat_arrays, load_flat_params
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_zinc_like

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("loss", "mae", "val_loss", "val_mae", "lr")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine")
    # 40 records at batch 16: two full batches and a partial one of 8
    make_zinc_like(str(d / "zinc.h5"), n_records=40)
    return d


def tiny_config(d, name, **kw):
    cfg = {
        "scheme": "zinc.svd",
        "model_name": name,
        "dataset_path": str(d / "zinc.h5"),
        "cache_dir": str(d / "cache" / name),
        "save_path": str(d / "models" / name),
        "batch_size": 16,
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
    }
    cfg.update(kw)
    return cfg


def run(scheme, weights=None):
    """execute_training, with the initial weights set after load_model."""
    scheme.save_config_file()
    scheme.load_data()
    scheme.load_model()
    if weights is not None:
        load_flat_params(scheme.model, weights)
    scheme.load_state()
    scheme.train_model()
    scheme.finalize_training(skip_init=True)
    return scheme


def records(d, name):
    with open(d / "models" / name / "logs" / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


@pytest.fixture(scope="module")
def jax_run(workdir):
    js = jimport("zinc.svd")(tiny_config(workdir, "jax"))
    js.save_config_file()
    js.load_data()
    js.load_model()
    init = jckpt._flatten_params(jax.device_get(js.params))
    # the initial gradient, to find the elements whose exact gradient is 0
    batch = next(js._batches("training", shuffle=True))
    grads = jax.grad(lambda p: js._compute_loss(p, batch, None, True)[0])(
        js.params)
    js.load_state()
    js.train_model()
    js.finalize_training(skip_init=True)
    return js, init, jckpt._flatten_params(grads)


@pytest.fixture(scope="module")
def port_run(workdir, jax_run):
    ts = timport("zinc.svd")(tiny_config(workdir, "port"), device="cpu")
    return run(ts, jax_run[1])


def test_epoch_loop_matches_jax(workdir, jax_run, port_run):
    js, _, grads = jax_run
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
    np.testing.assert_allclose(port_run.state["lr"], js.state["lr"],
                               rtol=1e-7)
    assert js.state["global_step"] == 6          # 3 steps an epoch
    # the run-dir artifacts (`tests/test_end_to_end.py:52-60`)
    base = workdir / "models" / "port"
    for rel in ("config/config.json", "config/config_input.json",
                "summary.txt", "saved/port.npz", "logs/metrics.jsonl",
                "checkpoint/ckpt_2.pt", "checkpoint/train_state_2.json"):
        assert (base / rel).is_file(), rel
    assert not (base / "checkpoint" / "ckpt_1.pt").exists()   # one kept
    saved = sorted(p.name for p in (base / "saved").glob("epoch*.npz"))
    assert saved == sorted(p.name for p in (
        workdir / "models" / "jax" / "saved").glob("epoch*.npz"))
    a = np.load(base / "saved" / "port.npz")
    b = np.load(workdir / "models" / "jax" / "saved" / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    n_noise = 0
    for k in b.files:
        # an element whose exact gradient is 0 (the key bias and the edge
        # bias's bias: softmax is invariant to a shift of a row's logits)
        # gets rounding noise on both sides, which Adam normalises to steps
        # of up to lr either way: held to 3 lr, as in
        # `test_torch_training.py::test_adam_trajectory_matches_jax`
        noise = (np.abs(grads[k]) < 1e-6) & (grads[k] != 0)
        n_noise += int(noise.sum())
        np.testing.assert_allclose(a[k][noise], b[k][noise], atol=3e-3,
                                   err_msg=k)
        scale = max(float(np.abs(b[k]).max()), 1e-3)
        np.testing.assert_allclose(a[k][~noise], b[k][~noise], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    assert n_noise <= 2 * (16 + 4)             # 2 layers: width + heads


def test_eval_of_jax_weights_matches_jax(workdir, jax_run):
    """The port's do_evaluations on the JAX run's final weights: its
    validation MAE is the JAX run's last val_mae (the same weights)."""
    final = str(workdir / "models" / "jax" / "saved" / "jax.npz")
    ts = timport("zinc.svd")(tiny_config(workdir, "port_eval",
                                         weight_file=final), device="cpu")
    ts.do_evaluations()
    preds = workdir / "models" / "port_eval" / "predictions"
    text = (preds / "valset_evals.txt").read_text()
    mae = float(text.split("=")[1])
    np.testing.assert_allclose(mae, records(workdir, "jax")[-1]["val_mae"],
                               atol=2e-5)
    for split in ("trainset", "testset"):
        assert "MAE = " in (preds / f"{split}_evals.txt").read_text()


def test_weight_files_move_both_ways(workdir, jax_run, port_run):
    js = jax_run[0]
    port_npz = str(workdir / "models" / "port" / "saved" / "port.npz")
    jax_npz = str(workdir / "models" / "jax" / "saved" / "jax.npz")
    loaded = jckpt.load_weights(jax.device_get(js.params), port_npz)
    flat = jckpt._flatten_params(loaded)
    ref = flat_arrays(port_run.model)
    assert sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    tckpt.load_weights(port_run.model, jax_npz)
    for k, v in flat_arrays(port_run.model).items():
        np.testing.assert_array_equal(v, np.load(jax_npz)[k], err_msg=k)


@pytest.mark.parametrize("wf", [":", "", "-"])
def test_weight_file_picks_the_same_file(workdir, port_run, wf):
    """':' the newest epochNNNN snapshot, '' the final weights, '-' the
    training checkpoint (`tests/test_end_to_end.py::test_eval_latest_snapshot`)."""
    saved = workdir / "models" / "port" / "saved"
    latest = tckpt.latest_epoch_snapshot(str(saved))
    assert latest == jckpt.latest_epoch_snapshot(str(saved))
    assert latest.endswith(".npz") and "epoch" in latest
    ts = timport("zinc.svd")(tiny_config(workdir, "port", weight_file=wf),
                             device="cpu")
    ts.eval_flag = True
    ts.prepare_for_test()
    want = {":": latest, "": str(saved / "port.npz"),
            "-": str(saved / "port.npz")}[wf]   # the checkpoint = the end
    for k, v in flat_arrays(ts.model).items():
        np.testing.assert_array_equal(v, np.load(want)[k], err_msg=k)


def _flat_params_of(d, name, **kw):
    ts = timport("zinc.svd")(tiny_config(d, name, **kw), device="cpu")
    ts.execute_training()
    return flat_arrays(ts.model), ts


def test_resume_equals_uninterrupted_run(workdir):
    draws = dict(random_mask_prob=0.1, dropout=0.1)
    _flat_params_of(workdir, "resumed", num_epochs=2, **draws)
    resumed, ts = _flat_params_of(workdir, "resumed", num_epochs=3, **draws)
    straight, _ = _flat_params_of(workdir, "straight", num_epochs=3, **draws)
    assert ts.state["current_epoch"] == 3 and ts.state["global_step"] == 9
    assert ts.state["save_best_value"] < float("inf")
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)
    a, b = records(workdir, "resumed"), records(workdir, "straight")
    assert [r["loss"] for r in a] == [r["loss"] for r in b]


def test_accum_groups_keep_one_pending_group_per_shape():
    def b(l):
        return {"x": np.zeros((2, l))}

    groups = list(accum_groups([b(8), b(16), b(8), b(16), b(16), b(8)], 2))
    assert [[x["x"].shape[1] for x in g] for g in groups] == \
        [[8, 8], [16, 16], [16], [8]]


def test_microbatch_grads_equal_big_batch_grads(workdir):
    ts = timport("zinc.svd")(tiny_config(workdir, "accum", batch_size=32,
                                         grad_accum_steps=2), device="cpu")
    ts.load_data()
    ts.load_model()
    tr = ts.trainer
    batch = next(ts._batches("training", shuffle=False))
    assert batch["sample_mask"].all()
    tr.optimizer.zero_grad()
    tr.compute_loss(batch, True, tr.layer_seeds(0))[0].backward()
    big = {k: p.grad.clone() for k, p in tr.model.named_parameters()
           if p.grad is not None}
    micro = [{k: v[i * 16:(i + 1) * 16] for k, v in batch.items()}
             for i in range(2)]
    acc = tm.DeviceAccumulator()
    tr.set_learning_rate(0.0)                 # keep the weights, read grads
    tr.train_into(acc, micro)
    scale = max(float(g.abs().max()) for g in big.values())
    for k, p in tr.model.named_parameters():
        if k in big:
            err = float((p.grad - big[k]).abs().max())
            assert err < 1e-5 * max(scale, 1.0), (k, err, scale)
    assert tr.step == 1
    np.testing.assert_allclose(acc._acc[0, 1].item(), 2.0)   # loss count
    np.testing.assert_allclose(acc.result()["mae"], tr.eval_step(batch)["mae"],
                               rtol=1e-5)


def test_accum2_trains_like_the_big_batch(workdir):
    big, s_big = _flat_params_of(workdir, "big32", batch_size=32)
    acc, s_acc = _flat_params_of(workdir, "acc16", batch_size=16,
                                 grad_accum_steps=2)
    # 40 records: one full step of 32 (two microbatches of 16) and a tail
    # of 8 (one microbatch), twice
    assert s_big.state["global_step"] == s_acc.state["global_step"] == 4
    err = max(float(np.abs(big[k] - acc[k]).max()) for k in big)
    assert err < 5e-4, err      # Adam noise bound of test_grad_accum.py


def test_l2_loss_and_grads_match_jax(workdir):
    cfg = tiny_config(workdir, "l2", l2_reg=1e-3)
    js = jimport("zinc.svd")(cfg)
    js.load_data()
    js.load_model()
    params = jax.device_get(js.params)
    batch = next(js._batches("training", shuffle=False))
    (loss_j, _), grads_j = jax.value_and_grad(js._compute_loss, has_aux=True)(
        params, batch, jax.random.PRNGKey(0), True)
    flat_j = jckpt._flatten_params(params)
    ts = timport("zinc.svd")(cfg, device="cpu")
    ts.load_data()
    ts.load_model()
    tr = ts.trainer
    load_flat_params(tr.model, flat_j)
    # the penalty's parameters: every kernel and table, as JAX selects them
    l2_names = sorted(k for k, p in tr.model.named_parameters()
                      if any(p is q for q in tr._l2))
    assert l2_names == sorted(k.replace("/", ".") for k in flat_j
                              if k.rsplit("/", 1)[1] in ("kernel", "table"))
    loss_t, _ = tr.compute_loss(batch, True, tr.layer_seeds(0))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    gj = jckpt._flatten_params(grads_j)
    for k, p in tr.model.named_parameters():
        name = k.replace(".", "/")
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, gj[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_refuses_what_is_not_ported(workdir):
    # edge partitioning and several ranks run (tests/test_torch_parallel_*);
    # every scheme of the JAX package is ported, PCQM4Mv2's last
    assert timport("pcqm4mv2.svd").__name__ == "Pcqm4mv2SVD"


@pytest.mark.parametrize("kw", [
    dict(edge_partition=2), dict(edge_partition=2, distributed=True),
    dict(num_devices=2, distributed=True)])
def test_a_world_of_one_refuses_a_parallel_config(workdir, kw):
    """A config that needs several ranks, in one process: JAX opens the
    devices itself, the port is started one process a rank by torchrun,
    and says so."""
    ts = timport("zinc.svd")(tiny_config(workdir, "world", **kw),
                             device="cpu")
    ts.load_data()
    with pytest.raises(ValueError, match="torchrun"):
        ts.load_model()


def test_pad_must_divide_by_edge_partition(workdir):
    """JAX's check (`trainer.py:295-298`), before any rank is started."""
    ts = timport("zinc.svd")(tiny_config(workdir, "pad", edge_partition=3),
                             device="cpu")
    ts.load_data()
    assert ts.pad_len % 3
    with pytest.raises(ValueError, match="must divide by edge_partition=3"):
        ts.load_model()


def test_profile_dir_writes_a_trace(workdir, capsys):
    """`profile_dir`: a run of 17 steps traces global steps 10 to 15 (JAX's
    window) into a Chrome trace, with JAX's line and the port's spans; the
    run itself goes on as without it."""
    trace = workdir / "trace"
    ts = timport("zinc.svd")(tiny_config(
        workdir, "profile", batch_size=2, num_epochs=1, steps_per_epoch=17,
        validation_steps=1, profile_dir=str(trace)), device="cpu")
    run(ts)
    assert ts.state["global_step"] == 17
    assert f"device trace written to {trace}" in capsys.readouterr().out
    with open(trace / "trace_steps_10-15.json") as fp:
        events = json.load(fp)["traceEvents"]
    # the window holds the steps' matrix products, and nothing of the
    # evaluation that follows step 16
    assert any(ev.get("name") == "aten::mm" for ev in events)
    names = {ev.get("name") for ev in events}
    assert {"step", "forward", "layer", "backward", "optimizer"} <= names
    assert tracing.span("step") is tracing.NO_SPAN


def _cli(module, cfg_path, *extra):
    return subprocess.run(
        [sys.executable, "-m", f"egt_torch.{module}", str(cfg_path), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_triple_on_cpu(workdir):
    cfg = tiny_config(workdir, "cli", num_epochs=1, weight_file="")
    path = workdir / "cli.json"
    path.write_text(json.dumps(cfg))
    res = _cli("run_training", path, "--device", "cpu")
    assert res.returncode == 0 and "DONE!!!" in res.stdout, res.stderr[-2000:]
    for module in ("do_evaluations", "end_training"):
        res = _cli(module, path, "--device", "cpu")
        assert res.returncode == 0, res.stderr[-2000:]
    assert "test MAE = " in res.stdout or (
        workdir / "models" / "cli" / "predictions" / "testset_evals.txt"
    ).read_text().startswith("test MAE = ")
    assert "DONE!!!" in res.stdout


def test_cli_needs_a_gpu_or_the_cpu_flag(workdir):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    path = workdir / "cli_gpu.json"
    path.write_text(json.dumps(tiny_config(workdir, "cli_gpu")))
    res = _cli("run_training", path)
    assert res.returncode != 0
    assert "no CUDA device is available; pass --device cpu" in res.stderr
