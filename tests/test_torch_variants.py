"""The model variants of the port against the JAX package on the CPU, at a
small size (2 layers, width 16, edge width 8, 4 heads, l 12, b 4), f32:

- per op, within 1e-5: BatchNorm in training mode (the output and the
  moving-statistics updates, statistics over every axis but the last with
  no mask) and in eval mode (the moving statistics read); the FFN
  cross-talk (`_xtalk`), a graph with no valid node among the batch; the
  degree encoding (one and both directions), the edge diffusion and the
  pairwise sum of the node2edge embedding; one layer of cross-talk,
  BatchNorm and gelu (`layer_forward`) with its updates, in training mode
  and at inference;
- per model, within 1e-4 (the loss 1e-5), on the plain path (the kernel
  paths in `test_torch_variants_kernels.py`): cross-talk with BatchNorm
  and gelu (variant X), the encodings with `readout_edges` (variant E:
  degree, diffusion, node2edge, transposed hops), and `readout_edges`
  with virtual nodes and BatchNorm: outputs, the ZINC loss and every
  parameter's gradient against `jax.grad` in training mode with the draws
  off, every moving-statistics update, and with BatchNorm the outputs at
  inference;
- the moving statistics after one step of two accumulated micro-batches
  equal JAX's `_grads_over_microbatches` merge (`_merge_stats_updates`
  micro-batch by micro-batch), within 1e-5;
- the moving statistics travel under JAX's flat names through the npz
  weights and the `torch.export` artifact, which normalises with them
  (the live model's output, which `test_model_matches_jax` holds to
  JAX's at inference, within 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from egt_torch import serving, weights
from egt_torch.models import features as TF
from egt_torch.models import layers as TL
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.training import checkpoint as tckpt
from egt_torch.training.steps import load_trainer
from egt_tpu.models import features as JF
from egt_tpu.models import layers as JL
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.trainer import _merge_stats_updates
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model
from tests.test_torch_superpixel import _mae

VARIANT_X = dict(node2edge_xtalk=0.5, edge2node_xtalk=0.5,
                 node_normalization="batch", edge_normalization="batch",
                 activation="gelu")
VARIANT_E = dict(max_degree_enc=3, bidir_degree=True, max_diffuse_t=2,
                 node2edge_embed=True, include_xpose=True, readout_edges=True)
PLAIN = dict(attention_impl="einsum")
MODELS = {
    "X_plain": {**VARIANT_X, **PLAIN},
    "E_plain": {**VARIANT_E, **PLAIN},
    "readout_edges_vn_batch_norm": dict(
        readout_edges=True, num_virtual_nodes=2, node_normalization="batch",
        edge_normalization="batch", **PLAIN),
}
# the kernels' plain versions (JAX's Pallas kernels in interpret mode),
# held to JAX in `test_torch_variants_kernels.py`
KERNEL_MODELS = {
    "X_attention_kernel": {**VARIANT_X, "fused_attention": True},
    "E_whole_layer_kernel": {**VARIANT_E, "fused_layer": True},
    "E_edge_block_kernel": {**VARIANT_E, "fused_attention": True,
                            "fused_edge_block": True, "edge_width": 64},
}


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _updates_close(got: dict, ref: dict, tol):
    assert sorted(got) == sorted(ref)
    for path, upd in ref.items():
        for name in ("moving_mean", "moving_var"):
            _close(got[path][name].numpy(), upd[name], tol, f"{path} {name}")


# ------------------------------------------------------------------------ per op


def _bn_params(rng, dim):
    return {"gamma": 1 + 0.1 * rng.normal(size=dim).astype(np.float32),
            "beta": 0.1 * rng.normal(size=dim).astype(np.float32),
            "moving_mean": 0.1 * rng.normal(size=dim).astype(np.float32),
            "moving_var": rng.uniform(0.5, 1.5, dim).astype(np.float32)}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(training):
    rng = np.random.default_rng(0)
    p = _bn_params(rng, 8)
    # a pair tensor with zero padding rows and pairs, counted as JAX counts
    x = rng.normal(size=(4, 12, 12, 8)).astype(np.float32)
    x[:, 9:] = 0.0
    y_j, upd_j = JL.batch_norm(p, x, training)
    y_t, upd_t = TL.batch_norm({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), training)
    _close(y_t.numpy(), y_j, 1e-5)
    if training:
        _updates_close({(): upd_t}, {(): upd_j}, 1e-5)
    else:
        assert upd_t is None and upd_j is None


def test_xtalk_matches_jax():
    cfg = small_cfg(**VARIANT_X)
    hn, he, _, _ = TL.ffn_dims(cfg)
    rng = np.random.default_rng(1)
    x_h = rng.normal(size=(4, 12, hn)).astype(np.float32)
    x_e = rng.normal(size=(4, 12, 12, he)).astype(np.float32)
    mask = np.arange(12)[None] < np.array([12, 7, 0, 3])[:, None]
    ref_h, ref_e = JL._xtalk(cfg, x_h, x_e, mask, None)
    out_h, out_e = TL._xtalk(cfg, torch.from_numpy(x_h), torch.from_numpy(x_e),
                             torch.from_numpy(mask))
    _close(out_h.numpy(), ref_h, 1e-5)
    _close(out_e.numpy(), ref_e, 1e-5)
    # the graph with no valid node takes zeros from the edges
    nx = TL.xtalk_sizes(cfg, he, cfg.edge2node_xtalk)
    assert not out_h[2, :, -nx:].any()
    assert (out_h.shape[-1], out_e.shape[-1]) == TL.ffn_dims(cfg)[2:]


@pytest.mark.parametrize("bidir", [True, False])
def test_encodings_match_jax(bidir):
    batch = random_zinc_batch(np.random.default_rng(2))
    adj = batch["graph_matrix"]
    ta = torch.from_numpy(adj)
    np.testing.assert_array_equal(
        TF.degree_encoding(ta, 3, bidir).numpy(),
        np.asarray(JF.degree_encoding(adj, 3, bidir)))
    rng = np.random.default_rng(3)
    e = rng.normal(size=adj.shape + (8,)).astype(np.float32)
    valid = batch["feature_matrix"] >= 0
    _close(TF.edge_diffusion(torch.from_numpy(e), ta, torch.from_numpy(valid),
                             2).numpy(),
           JF.edge_diffusion(e, adj, valid, 2), 1e-5)
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    _close(TF.pairwise_add(torch.from_numpy(x)).numpy(), JF.pairwise_add(x),
           1e-6)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_layer_matches_jax(training):
    """One layer of cross-talk, BatchNorm and gelu, with its updates."""
    jcfg = small_cfg(**VARIANT_X, **PLAIN)
    params = jax_params(jcfg)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(4, 12, 16)).astype(np.float32)
    e = rng.normal(size=(4, 12, 12, 8)).astype(np.float32)
    mask = np.arange(12)[None] < np.array([12, 7, 5, 3])[:, None]
    ref_h, ref_e, _, _, ref_upd, _ = jax.jit(
        lambda p, h, e, m: JL.layer_forward(p, jcfg, h, e, m, None, training,
                                            None, None, False, 0))(
        params["stack"]["layers"][0], h, e, mask)
    model = port_model(jcfg, jckpt._flatten_params(params))
    updates = {}
    with torch.no_grad():
        out_h, out_e = TL.layer_forward(
            model.stack["layers"][0], model.cfg, torch.from_numpy(h),
            torch.from_numpy(e), torch.from_numpy(mask), None, training,
            updates=updates)
    _close(out_h.numpy(), ref_h, 1e-5)
    _close(out_e.numpy(), ref_e, 1e-5)
    _updates_close(updates, ref_upd, 1e-5)
    assert len(updates) == (4 if training else 0)


# --------------------------------------------------------------------- per model


def _jax_step(jcfg):
    """JAX's training-mode loss (the ZINC MAE), outputs, moving-statistics
    updates and gradients, jitted."""
    model = JModel(jcfg)

    def loss_fn(p, batch):
        out, ctx = model.apply(p, batch, training=True)
        return _mae(out, batch), (out, ctx.stats_updates)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _batch(cfg, seed=5):
    return random_zinc_batch(np.random.default_rng(seed), b=4, l=12)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    check_model(MODELS[name])


def check_model(kw):
    """The model of `small_cfg(**kw)` against JAX: training-mode outputs,
    loss, updates and gradients, and with BatchNorm the inference
    outputs."""
    jcfg = small_cfg(**kw)
    params = jax_params(jcfg, seed=2)
    batch = _batch(jcfg)
    (loss_j, (out_j, upd_j)), grads_j = _jax_step(jcfg)(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    out, ctx = model(batch, training=True, seeds=[1, 2], with_context=True)
    _close(out.detach().numpy(), out_j, 1e-4)
    loss = torch.mean(torch.abs(out - torch.from_numpy(batch["target"])))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _updates_close(ctx.stats_updates, upd_j, 1e-5)
    flat_j = jckpt._flatten_params(grads_j)
    for k, p in weights.flat_names(model).items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        _close(g, flat_j[k], 1e-4, k)
    # every new parameter is reached, and with `readout_edges` the last
    # layer's edge output through the final edge norm
    reached = ["degree_emb/kernel", "node2edge_emb/table", "adj_emb/kernel",
               "diffusion_emb/kernel", "virtual_edge_embeddings"]
    if jcfg.readout_edges:
        reached += ["stack/edge_norm_final/gamma",
                    "stack/layers/1/edge_ffn/lr2/kernel"]
    for k in reached:
        if k in flat_j:
            assert np.abs(flat_j[k]).max() > 0, k
    if "batch" in (jcfg.node_normalization, jcfg.edge_normalization):
        # at inference the norms read the moving statistics (the other
        # variants compute alike in both modes with the draws off)
        ref = jax.jit(lambda p, b: JModel(jcfg).apply(p, b)[0])(params,
                                                                batch)
        with torch.inference_mode():
            _close(model(batch).numpy(), ref, 1e-4)


def test_moving_stats_after_two_microbatches_match_jax():
    jcfg = small_cfg(**VARIANT_X, **PLAIN)
    params = jax_params(jcfg, seed=3)
    mbs = [_batch(jcfg, seed) for seed in (6, 7)]
    stats = jax.jit(lambda p, b: JModel(jcfg).apply(
        p, b, training=True)[1].stats_updates)
    merged = params
    for mb in mbs:
        merged = _merge_stats_updates(merged, stats(merged, mb))
    tr = load_trainer({"scheme": "zinc.svd", "use_svd": False,
                       "grad_accum_steps": 2, "compute_dtype": "float32"},
                      jckpt._flatten_params(params), device="cpu",
                      model_config=TCfg(**dataclasses.asdict(jcfg)))
    tr._update(mbs)
    got = tr.flat_params()
    ref = jckpt._flatten_params(merged)
    stats = [k for k in ref if k.rsplit("/", 1)[1].startswith("moving_")]
    assert len(stats) == 2 * 10        # 4 norms a layer, the final 2
    for k in stats:
        _close(got[k], ref[k], 1e-5, k)
        assert not np.array_equal(ref[k], jckpt._flatten_params(params)[k])



def test_moving_stats_travel_with_the_weights(tmp_path):
    """The moving statistics carry JAX's flat names through the npz
    weights and the `torch.export` artifact, which normalises with them; no
    gradient reaches them."""
    jcfg = small_cfg(**VARIANT_X, **PLAIN)
    params = jax_params(jcfg, seed=4)
    flat = jckpt._flatten_params(params)
    model = port_model(jcfg, flat)
    names = sorted(weights.flat_names(model))
    assert names == sorted(flat)
    assert "stack/layers/0/norm_mha/moving_mean" in names
    assert all(not p.requires_grad for k, p in model.named_parameters()
               if "moving_" in k)
    path = str(tmp_path / "w.npz")
    tckpt.save_weights(model, path)
    batch = _batch(jcfg)
    keys = ("node_features", "feature_matrix", "graph_matrix")
    tm = tckpt.load_weights(TModel(model.cfg, device="cpu"), path).eval()
    spec = {k: (batch[k].shape, batch[k].dtype.name) for k in keys}
    art = serving.save_serving(tm, spec, str(tmp_path / "model.pt2"))
    out = serving.load_serving(art)(batch)
    with torch.inference_mode():
        np.testing.assert_allclose(out, tm(batch).numpy(), rtol=1e-6,
                                   atol=1e-6)
    # the statistics are read: the initial ones give other outputs
    with torch.no_grad():
        for k, p in tm.named_parameters():
            if "moving_" in k:
                p.fill_(1.0 if k.endswith("var") else 0.0)
        assert not np.allclose(tm(batch).numpy(), out, atol=1e-3)
