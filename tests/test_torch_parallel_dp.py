"""The port's data parallelism (and DP x SP) on CPU ranks against one
process and against JAX's dry runs.

Two worlds of gloo ranks run the checks (`tests/torch_parallel_ranks.py`):
two data ranks (one `Trainer` step on a ragged batch, the draws, the
BatchNorm statistics, the dry runs) and four ranks laid out 2 data x 2 edge
shards (one `Trainer` step, the dry runs, and the engine with
`edge_partition` 4). With the draws off, each gives one process's loss,
gradients and, after one Adam step, parameters at 1e-5 (f32; see
`check_step` for the elements whose exact gradient is 0).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from egt_torch import schemes, synthetic
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.parallel import dryrun
from egt_torch.parallel.launch import spawn_ranks
from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.steps import load_trainer
from egt_torch.weights import load_npz
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.parallel import dryrun as jdryrun
from egt_tpu.training import checkpoint as jckpt
from tests import torch_parallel_ranks as ranks
from tests.synth import make_zinc_like
from tests.test_model_forward import random_zinc_batch, small_cfg

RUN = {"scheme": "zinc.svd", "model_width": 16, "edge_width": 8,
       "model_height": 2, "num_heads": 4, "use_svd": False, "upto_hop": 2,
       "compute_dtype": "float32", "l2_reg": 1e-4, "seed": 3}


def ragged_batch():
    """8 graphs of pad 16, 5 of them real: the first data rank of two holds
    4, the second 1 and three of padding."""
    batch = synthetic.zinc_batch(np.random.default_rng(4), 8, pad=16,
                                 max_nodes=14)
    batch["sample_mask"] = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    return batch


def engine_config(d, name, **kw):
    return {"scheme": "zinc.svd", "model_name": name,
            "dataset_path": str(d / "z.h5"),
            "cache_dir": str(d / "cache"),
            "save_path": str(d / "models" / name),
            "batch_size": 8, "num_epochs": 2, "model_width": 16,
            "edge_width": 8, "model_height": 2, "num_heads": 4,
            "use_svd": False, "upto_hop": 2, "log_tensorboard": False,
            "compute_dtype": "float32", **kw}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    weights = str(d / "run.npz")
    np.savez(weights, **synthetic.random_flat_params(
        schemes.model_config_from_config(RUN), seed=1))
    jweights = str(d / "dry.npz")
    np.savez(jweights, **jckpt._flatten_params(
        JModel(jdryrun.tiny_model_config()).init(jax.random.PRNGKey(0))))
    bn_cfg = small_cfg(node_normalization="batch", edge_normalization="batch")
    bn_weights = str(d / "bn.npz")
    np.savez(bn_weights, **jckpt._flatten_params(
        JModel(bn_cfg).init(jax.random.PRNGKey(0))))
    bn_batch = random_zinc_batch(np.random.default_rng(2), l=16)
    make_zinc_like(str(d / "z.h5"), n_records=16, n_min=6, n_max=14)
    return dict(d=d, weights=weights, jweights=jweights, batch=ragged_batch(),
                bn=(dataclasses.asdict(bn_cfg), bn_weights, bn_batch))


@pytest.fixture(scope="module")
def worlds(setup):
    """Both worlds, started at once; their results are read by `dp2` and
    `dp2_sp2` (the JAX dry runs go on meanwhile)."""
    s = setup
    with ThreadPoolExecutor(2) as pool:
        futures = (
            pool.submit(spawn_ranks, ranks.data_parallel_checks, 2, RUN,
                        s["batch"], s["bn"], s["weights"], s["jweights"],
                        timeout=300),
            pool.submit(spawn_ranks, ranks.dp_sp_checks, 4, RUN, s["batch"],
                        s["weights"], s["jweights"],
                        engine_config(s["d"], "sp", edge_partition=4),
                        timeout=300))
        yield futures


@pytest.fixture(scope="module")
def dp2(worlds):
    return worlds[0].result()


@pytest.fixture(scope="module")
def dp2_sp2(worlds):
    return worlds[1].result()


@pytest.fixture(scope="module")
def one_process(setup):
    trainer = load_trainer(RUN, setup["weights"], device="cpu")
    report = trainer.train_step(setup["batch"])
    return {"report": report, "grads": ranks.grads_of(trainer.model),
            "params": trainer.flat_params()}


def check_step(step, ref):
    """The reported loss and metrics and the parameters after the step at
    1e-5, and the gradients at 1e-5 of each parameter's largest (or of a
    tenth of the model's largest). Where the exact gradient is 0 (a key
    bias: softmax is shift-invariant) the two runs hold only rounding
    noise of different sums, and Adam's first step, g / (|g| + eps), moves
    such an element by up to the learning rate either way: those elements
    are held to that bound instead."""
    for k, v in ref["report"].items():
        np.testing.assert_allclose(step["report"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert step["params"].keys() == ref["params"].keys()
    top = max(float(np.max(np.abs(g))) for g in ref["grads"].values())
    lr = 5e-4      # the run config's initial_lr (the trainer default)
    for k, v in ref["params"].items():
        g, g_ref = step["grads"][k], ref["grads"][k]
        scale = max(float(np.max(np.abs(g_ref))), 0.1 * top)
        np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)
        noise = np.abs(g_ref) <= 1e-6 * top
        np.testing.assert_allclose(step["params"][k][~noise], v[~noise],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        assert np.all(np.abs(step["params"][k] - v)[noise] <= 2 * lr), k


@pytest.mark.parametrize("rank", [0, 1])
def test_dp2_step_matches_one_process(worlds, jax_dry, one_process, dp2,
                                      rank):
    """The global masked mean over a ragged batch whose second shard is
    mostly padding, its gradient summed over the ranks, one Adam step."""
    check_step(dp2[rank]["step"], one_process)


@pytest.mark.parametrize("rank", [0, 2])
def test_dp2_sp2_step_matches_one_process(dp2_sp2, one_process, rank):
    check_step(dp2_sp2[rank]["step"], one_process)


def test_dp_ranks_draw_different_masks(dp2):
    """The seeds fold in the data rank: the ranks' layer seeds differ, and
    so do the random-mask bits they draw for the same (graph 0, pair,
    head); the step with the draws on is finite."""
    assert set(dp2[0]["seeds"]).isdisjoint(dp2[1]["seeds"])
    assert not np.array_equal(dp2[0]["bits"], dp2[1]["bits"])
    for r in (0, 1):
        assert np.isfinite(dp2[r]["drawn_step"]["loss"])
    assert dp2[0]["drawn_step"] == dp2[1]["drawn_step"]


def test_dp_batch_norm_statistics_are_the_global_batchs(dp2, setup):
    """JAX's mean over a batch-sharded array is the global batch's: the
    moving statistics of a training forward on each rank's half equal
    those of the whole batch."""
    cfg_kw, path, batch = setup["bn"]
    model = load_npz(TModel(TCfg(**cfg_kw), device="cpu"), path)
    _, ctx = model(batch, training=True, with_context=True)
    ref = {"/".join(map(str, k)): v for k, v in ctx.stats_updates.items()}
    assert len(ref) > 0
    for r in (0, 1):
        stats = dp2[r]["stats"]
        assert stats.keys() == ref.keys()
        for k, upd in ref.items():
            for n, v in upd.items():
                np.testing.assert_allclose(stats[k][n], v.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{k}/{n}")


@pytest.fixture(scope="module")
def jax_dry():
    """JAX's dry runs with the draws off (the port's draws are its own)."""
    mp = pytest.MonkeyPatch()
    orig = jdryrun.tiny_model_config
    mp.setattr(jdryrun, "tiny_model_config",
               lambda **kw: orig(**{**kw, "random_mask_prob": 0.0}))
    try:
        return {"dp2": jdryrun.run_one_step(2, model_parallel=1),
                "sp2": jdryrun.run_one_step_sp(2, sp=2),
                "dp2_sp2": jdryrun.run_one_step_sp(4, sp=2, batch_size=4)}
    finally:
        mp.undo()


def test_dry_runs_match_jax(dp2, dp2_sp2, jax_dry):
    """The port's dry runs from JAX's weights give JAX's dry-run losses
    (the first step's, before its update)."""
    np.testing.assert_allclose(dp2[0]["dry"]["dp", 1], jax_dry["dp2"],
                               rtol=1e-5)
    np.testing.assert_allclose(dp2[0]["dry"]["sp", 1], jax_dry["sp2"],
                               rtol=1e-5)
    np.testing.assert_allclose(dp2_sp2[0]["dry"]["sp2", 1],
                               jax_dry["dp2_sp2"], rtol=1e-5)


def test_dry_runs_second_step_matches_one_process(dp2, dp2_sp2, setup):
    """After one Adam step the sharded runs' losses are one process's: the
    gradients reached every parameter once."""
    w = setup["jweights"]
    kw = dict(weights=w, steps=2, device="cpu", random_mask_prob=0.0)
    np.testing.assert_allclose(dp2[0]["dry"]["dp", 2],
                               dryrun.run_one_step(1, batch_size=4, **kw),
                               rtol=1e-5)
    np.testing.assert_allclose(dp2[0]["dry"]["sp", 2],
                               dryrun.run_one_step(1, batch_size=2, **kw),
                               rtol=1e-5)
    one4 = dryrun.run_one_step(1, batch_size=4, **kw)
    for key in ("sp2", "sp4"):
        np.testing.assert_allclose(dp2_sp2[0]["dry"][key, 2], one4,
                                   rtol=1e-5, err_msg=key)


def test_engine_edge_partition_matches_one_device(dp2_sp2, setup):
    """The counterpart of `tests/test_sp_training.py`: the engine trained
    with `edge_partition` 4 on four ranks validates as one device's."""
    one = timport("zinc.svd")(engine_config(setup["d"], "ref"), device="cpu")
    one.execute_training()
    ref = one.evaluate_split("validation")
    assert dp2_sp2[0]["engine_epoch"] == 2
    np.testing.assert_allclose(dp2_sp2[0]["engine"]["mae"], ref["mae"],
                               rtol=1e-4, atol=1e-5)
    assert (setup["d"] / "models" / "sp" / "checkpoint").is_dir()


@pytest.mark.slow
def test_four_rank_uneven_buckets(setup):
    """The counterpart of `tests/test_multihost.py::
    test_four_process_uneven_buckets`: four data ranks over an epoch that
    crosses a length bucket (pad 16, then 24) and ends in a ragged batch of
    16 whose 3 real graphs reach only the first rank; every loss is one
    process's."""
    rng = np.random.default_rng(0)
    batches = [synthetic.zinc_batch(rng, 16, pad=p, max_nodes=14)
               for p in (16, 24, 16)]
    for b in batches:
        b["sample_mask"] = np.ones((16,), np.float32)
    batches[2]["sample_mask"][3:] = 0.0
    losses = spawn_ranks(ranks.uneven_bucket_losses, 4, RUN,
                         setup["weights"], batches, timeout=300)
    one = load_trainer(RUN, setup["weights"], device="cpu")
    ref = [one.eval_step(b)["loss"] for b in batches]
    for r in range(4):
        np.testing.assert_allclose(losses[r], ref, rtol=1e-5, atol=1e-7)
