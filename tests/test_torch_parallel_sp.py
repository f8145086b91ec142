"""The port's edge partitioning on CPU ranks against the unsharded port and
against JAX's `edge_partitioned_forward`.

Every case of `tests/test_edge_partition.py` runs once in a world of four
gloo ranks (`tests/torch_parallel_ranks.py::sp_cases`), laid out as 4 edge
shards and as 2 data x 2 edge shards, with JAX's weights. The sharded
forward matches the unsharded port at 1e-5 (f32), and so do the gradients
of the sum of the squared outputs, summed over the ranks (each parameter's
at 1e-5 of its largest gradient, or of a tenth of the model's largest);
one case of each
readout kind matches JAX's `edge_partitioned_forward` on 4 shards at its
2e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.parallel.launch import spawn_ranks
from egt_torch.weights import load_npz
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.parallel import mesh as jmesh
from egt_tpu.parallel.edge_partition import edge_partitioned_forward
from egt_tpu.training import checkpoint as jckpt
from tests import torch_parallel_ranks as ranks
from tests.test_model_forward import random_zinc_batch, small_cfg


def dense_batch(rng, b=4, l=16):
    return {
        "node_features": rng.normal(size=(b, l, 2)).astype(np.float32),
        "feature_matrix": rng.normal(size=(b, l, l, 1)).astype(np.float32),
        "graph_matrix": (rng.random((b, l, l)) < 0.3).astype(np.float32),
    }


def node_batch(rng):
    batch = random_zinc_batch(rng, l=16, nf=3)
    del batch["feature_matrix"]
    return batch


DENSE_EDGE = dict(node_input_kind="dense", node_feature_dim=2,
                  edge_input_kind="dense", edge_feature_dim=1,
                  readout_kind="edge", num_targets=2, upto_hop=2)
# name: (config, batch, training); the cases of tests/test_edge_partition.py
CASES = {
    "graph": (dict(upto_hop=3), lambda r: random_zinc_batch(r, l=16), False),
    "node": (dict(edge_input_kind="none", readout_kind="node", num_targets=2,
                  num_node_features=3, upto_hop=3), node_batch, False),
    "edge": (DENSE_EDGE, dense_batch, False),
    "pairwise_cat": ({**DENSE_EDGE, "edge_channel_type": "bias",
                      "use_node_embeddings": True}, dense_batch, False),
    "xtalk": (dict(node2edge_xtalk=0.5, edge2node_xtalk=0.5),
              lambda r: random_zinc_batch(r, l=16), False),
    "virtual_nodes": (dict(num_virtual_nodes=2),
                      lambda r: random_zinc_batch(r, l=16), False),
    "distance_loss": (dict(distance_loss=0.05, distance_target=3),
                      lambda r: random_zinc_batch(r, l=16), False),
    "node2edge_xpose": (dict(node2edge_embed=True, include_xpose=True,
                             upto_hop=3),
                        lambda r: random_zinc_batch(r, l=16), False),
    "readout_edges_degree": (dict(readout_edges=True, max_degree_enc=4,
                                  max_diffuse_t=2),
                             lambda r: random_zinc_batch(r, l=16), False),
    "batch_norm": (dict(node_normalization="batch",
                        edge_normalization="batch"),
                   lambda r: random_zinc_batch(r, l=16), True),
    "constrained_vn_kernel": (dict(edge_channel_type="constrained",
                                   num_virtual_nodes=2, scale_degree=True,
                                   fused_attention=True),
                              lambda r: random_zinc_batch(r, l=16), True),
    "refused": (dict(num_virtual_nodes=2, edge_normalization="batch"),
                lambda r: random_zinc_batch(r, l=16), True),
}
MESHES = {"sp4": 4, "dp2_sp2": 2}


def jax_params(jcfg):
    params = JModel(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [np.asarray(x) + (0.05 * rng.normal(size=x.shape)).astype(
        np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases' inputs, JAX weights and the four ranks' results."""
    d = tmp_path_factory.mktemp("sp")
    inputs, cases = {}, {}
    for i, (name, (kw, make, training)) in enumerate(CASES.items()):
        jcfg = small_cfg(**kw)
        params = jax_params(jcfg)
        path = str(d / f"{name}.npz")
        np.savez(path, **jckpt._flatten_params(params))
        batch = make(np.random.default_rng(i))
        cfg_kw = dataclasses.asdict(jcfg)
        inputs[name] = (jcfg, params, path, batch, training)
        cases[name] = (cfg_kw, path, batch, training, name != "refused")
    results = spawn_ranks(ranks.sp_cases, 4, cases, timeout=300)
    return inputs, results


def unsharded(name, inputs, grads=True):
    jcfg, _, path, batch, training = inputs[name]
    model = load_npz(TModel(TCfg(**dataclasses.asdict(jcfg)), device="cpu"),
                     path)
    seeds = [11 + i for i in range(jcfg.model_height)]
    y = model(batch, training=training, seeds=seeds)
    g = None
    if grads:
        torch.sum(y ** 2).backward()
        g = ranks.grads_of(model)
    return y.detach().numpy(), g


def logical(results, mesh, name):
    """The logical output: rank 0's, with the other data shard's rows after
    it on the 2 x 2 layout (rank 2 holds data shard 1)."""
    mp = MESHES[mesh]
    shards = [results[r][(mp, name)] for r in range(0, 4, mp)]
    assert [s[0] for s in shards] == list(range(len(shards)))
    return np.concatenate([s[1] for s in shards]), shards[0][2]


SHARDED = [n for n in CASES if n != "refused"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", SHARDED)
def test_sp_forward_matches_unsharded(world, name, mesh):
    inputs, results = world
    out, _ = logical(results, mesh, name)
    ref, _ = unsharded(name, inputs, grads=False)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", SHARDED)
def test_sp_gradients_match(world, name, mesh):
    inputs, results = world
    _, grads = logical(results, mesh, name)
    _, ref = unsharded(name, inputs)
    assert grads.keys() == ref.keys()
    top = max(float(np.max(np.abs(g))) for g in ref.values())
    for k in ref:
        # each element at 1e-5 of the parameter's largest gradient, or of
        # a tenth of the model's where the parameter's exact gradient is 0
        # (an edge-bias bias: softmax is shift-invariant; a bias before a
        # BatchNorm) and only rounding noise of the sums is left: the
        # shards take the sums in another order
        scale = max(float(np.max(np.abs(ref[k]))), 0.1 * top)
        np.testing.assert_allclose(grads[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["graph", "node", "edge"])
def test_sp_matches_jax_edge_partitioned_forward(world, name):
    inputs, results = world
    jcfg, params, _, batch, training = inputs[name]
    mesh = jmesh.make_mesh(4, model_parallel=4)
    ref = jax.jit(lambda p, b: edge_partitioned_forward(
        JModel(jcfg), p, b, mesh))(params, batch)
    out, _ = logical(results, "sp4", name)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_unsupported_combination_raises(world, mesh):
    """Virtual nodes under an edge-stream BatchNorm: every rank refuses,
    with JAX's message."""
    _, results = world
    for r in range(4):
        _, out, _, err = results[r][(MESHES[mesh], "refused")]
        assert out is None
        assert "BatchNorm edge normalization with virtual nodes" in err
