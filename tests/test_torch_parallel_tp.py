"""The port's tensor parallelism on CPU ranks against data parallelism and
against JAX's dry run.

A world of four gloo ranks runs the dry run (`parallel/dryrun.py`) from
JAX's weights with the draws off, as DP 4, DP 2 x TP 2 and TP 4 on the same
batch of 4 (`tests/torch_parallel_ranks.py::tensor_parallel_checks`): the
losses of the first step and, after one Adam step, of the second agree at
1e-5, and the first is JAX's dry-run loss on the same mesh.
"""

import jax
import numpy as np
import pytest

from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.parallel import partitioning
from egt_torch.parallel.launch import spawn_ranks
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.parallel import dryrun as jdryrun
from egt_tpu.training import checkpoint as jckpt
from tests import torch_parallel_ranks as ranks


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "dry.npz")
    np.savez(path, **jckpt._flatten_params(
        JModel(jdryrun.tiny_model_config()).init(jax.random.PRNGKey(0))))
    return path


@pytest.fixture(scope="module")
def losses(weights):
    return spawn_ranks(ranks.tensor_parallel_checks, 4, weights,
                       timeout=300)


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("step", [0, 1])
def test_tensor_parallel_matches_data_parallel(losses, mp, step):
    for r in range(4):
        np.testing.assert_allclose(losses[r][mp][step], losses[r][1][step],
                                   rtol=1e-5)


def test_tensor_parallel_matches_jax_dry_run(losses):
    """JAX's DP 2 x TP 2 step (its params sharded by `_RULES`) on the
    batch of 4, the draws off."""
    mp = pytest.MonkeyPatch()
    orig = jdryrun.tiny_model_config
    mp.setattr(jdryrun, "tiny_model_config",
               lambda **kw: orig(**{**kw, "random_mask_prob": 0.0}))
    try:
        ref = jdryrun.run_one_step(4, model_parallel=2, batch_size=4)
    finally:
        mp.undo()
    np.testing.assert_allclose(losses[0][2][0], ref, rtol=1e-5)


def test_head_columns_are_strided():
    """JAX's QKV columns are ordered (3, d, h): heads 2 and 3 of 4, d 2."""
    assert partitioning.head_columns(2, 4, range(2, 4), 3) == [
        2, 3, 6, 7, 10, 11, 14, 15, 18, 19, 22, 23]
    assert partitioning.head_columns(2, 4, range(0, 2), 1) == [0, 1, 4, 5]


def test_tensor_parallel_refuses_what_it_cannot_split():
    cfg = TCfg(model_width=32, edge_width=16, num_heads=4)
    partitioning.check_tensor_parallel(cfg, 2)
    with pytest.raises(ValueError, match="heads"):
        partitioning.check_tensor_parallel(cfg, 3)
    with pytest.raises(NotImplementedError, match="cross-talk"):
        partitioning.check_tensor_parallel(
            TCfg(model_width=32, edge_width=16, num_heads=4,
                 node2edge_xtalk=0.5), 2)
