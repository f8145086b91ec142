"""The TSP edge-classification scheme of the port against the JAX package on
the CPU, at a small size (2 layers, width 16, edge width 8, 4 heads, pad
lengths 24 and 28):

- a TSP-shaped model (dense node and edge inputs, the edge readout on the
  final-normed edge channel): outputs within 1e-4 of `GraphModel.apply` in
  f32 at inference, and the edge-validity mask equal to JAX's;
- in training mode with the draws off, on the plain path and through the
  whole-layer kernel's plain versions (JAX runs its Pallas kernel as its
  own CPU tests do), the cross-entropy and the accuracy over the valid
  pairs within 1e-5, and every parameter's gradient within 1e-4 of
  `jax.grad`, the last layer's edge tail and `edge_norm_final` among them,
  non-zero; the same for a `_spe`-shaped model (the SVD PE, no sign
  flips);
- config resolution of all nine shipped TSP configs against JAX's
  `get_model_config` plus the dispatch-knob copy (`include_xpose` accepted,
  not forwarded); each builds a model with JAX's parameter names and
  shapes, the two `egt_simple` ones (the `bias` edge channel) with the
  pairwise-cat edge readout;
- `tsp_eval` against scikit-learn's binary scores, with no predicted and
  no true positives among the cases;
- the synthetic TSP graphs' shape (`synthetic.tsp_records`) and
  `load_predictor` serving (b, l, l, 2) edge logits.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import (accuracy_score, f1_score, precision_score,
                             recall_score)

from egt_torch import schemes, serving, synthetic, weights
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.schemes import tsp_eval
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training.schemes import import_scheme as jimport
from tests.test_model_forward import small_cfg
from tests.test_torch_model import jax_params, port_model

REPO = Path(__file__).resolve().parents[1]
PATHS = {"whole_layer_kernel": dict(fused_layer=True),
         "plain": dict(attention_impl="einsum")}
TSP_CONFIGS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.json")
    if json.loads(p.read_text()).get("scheme") == "tsp.svd")
LAST_EDGE_TAIL = ("edge_ffn/lr2/kernel", "edge_ffn/lr1/kernel",
                  "edge_ffn/norm/gamma", "dense_edge_r/kernel",
                  "norm_edge/gamma")


def tsp_cfg(**kw):
    """A TSP-shaped model at the small size."""
    return small_cfg(node_input_kind="dense", node_feature_dim=2,
                     edge_input_kind="dense", edge_feature_dim=1,
                     num_targets=2, readout_kind="edge", **kw)


def tsp_batch(seed, b=4, l=24, k=4, sv=False):
    """Small TSP-like graphs: points in the unit square, each point's edges
    to its k nearest with their lengths, label 1 on an edge to one of the
    2 nearest, -1 padding, a self-looped adjacency, a padding graph last;
    with `sv`, singular vectors."""
    rng = np.random.default_rng(seed)
    nf = np.full((b, l, 2), -1.0, np.float32)
    fm = np.full((b, l, l, 1), -1.0, np.float32)
    adj = np.zeros((b, l, l), np.float32)
    target = np.zeros((b, l, l), np.int32)
    for i in range(b):
        n = int(rng.integers(k + 2, l + 1))
        xy = rng.random((n, 2))
        d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        nbr = np.argsort(d, 1)[:, :k]
        src, dst = np.repeat(np.arange(n), k), nbr.reshape(-1)
        nf[i, :n] = xy
        fm[i, src, dst, 0] = d[src, dst]
        adj[i, src, dst] = 1.0
        adj[i, np.arange(n), np.arange(n)] = 1.0
        target[i, src, dst] = np.tile(np.arange(k) < 2, n)
    batch = {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj,
             "target": target,
             "sample_mask": np.array([1.0] * (b - 1) + [0.0], np.float32)}
    if sv:
        batch["singular_vectors"] = np.where(
            (nf[..., :1] >= 0)[..., None],
            rng.normal(size=(b, l, 8, 2)), 0).astype(np.float32)
    return batch


def test_model_matches_jax():
    jcfg = tsp_cfg(**PATHS["plain"])
    params = jax_params(jcfg)
    assert params["mlp_out"]["dense"][0]["kernel"].shape[0] == 8
    batch = tsp_batch(5)
    ref = jax.jit(lambda p, b: JModel(jcfg).apply(p, b)[0])(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out = model(batch)
    assert out.shape == (4, 24, 24, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    mask = model.output_mask(batch)
    assert mask.shape == (4, 24, 24)
    assert torch.equal(mask, torch.from_numpy(
        np.array(JModel(jcfg).output_mask(batch))))
    assert torch.equal(mask, torch.from_numpy(
        batch["feature_matrix"][..., 0] >= 0))
    assert model.input_keys == ("node_features", "feature_matrix",
                                "graph_matrix")


def _check_loss_and_grads(jcfg, batch):
    """The port's xent and acc over the edge mask and every gradient
    against JAX, in training mode with the draws off; returns the port
    model."""
    params = jax_params(jcfg, seed=2)
    jmodel = JModel(jcfg)

    def loss_fn(p, batch):
        out, _ = jmodel.apply(p, batch, training=True,
                              rng=jax.random.PRNGKey(0))
        mask = jmodel.output_mask(batch)
        s, c = jm.sparse_xent_loss(out, batch["target"], mask,
                                   batch["sample_mask"])
        sa, ca = jm.accuracy(out, batch["target"], mask, batch["sample_mask"])
        return s / jnp.maximum(c, 1.0), (s, c, sa, ca)

    (loss_j, pairs_j), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    out = model(batch, training=True, seeds=[1, 2], pe_seed=3)
    loss_t, pairs = schemes.loss_fn({"scheme": "tsp.svd"})(
        out, torch.from_numpy(batch["target"]).long(),
        model.output_mask(batch), torch.from_numpy(batch["sample_mask"]))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for (s, c), sj, cj in ((pairs["xent"], *pairs_j[:2]),
                           (pairs["acc"], *pairs_j[2:])):
        np.testing.assert_allclose(s.item(), float(sj), rtol=1e-5)
        assert c.item() == float(cj)
    flat_j = jckpt._flatten_params(grads_j)
    named = weights.flat_names(model)
    for name, p in named.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, flat_j[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the edge readout reads the last layer's edge output through the final
    # edge norm: their gradients are non-zero
    last = f"stack/layers/{jcfg.model_height - 1}"
    for name in [f"{last}/{n}" for n in LAST_EDGE_TAIL] + [
            "stack/edge_norm_final/gamma", "stack/edge_norm_final/beta"]:
        g = named[name].grad
        assert g is not None and float(g.abs().max()) > 0, name
        assert float(np.abs(flat_j[name]).max()) > 0, name
    return model


@pytest.mark.parametrize("path", list(PATHS))
def test_loss_and_grads_match_jax(path):
    _check_loss_and_grads(tsp_cfg(**PATHS[path]), tsp_batch(6))


def test_spe_model_matches_jax():
    """`egt_spe`-shaped: the SVD PE through `svd_emb`, flips off, the
    whole-layer kernel."""
    jcfg = tsp_cfg(use_svd=True, transform_svd=True, num_svd_features=8,
                   sel_svd_features=4, random_neg=False, fused_layer=True)
    model = _check_loss_and_grads(jcfg, tsp_batch(7, l=28, sv=True))
    assert "svd_emb/kernel" in weights.flat_names(model)
    assert model.input_keys[-1] == "singular_vectors"


@pytest.mark.parametrize("path", TSP_CONFIGS)
def test_tsp_config_resolution_matches_jax(path):
    raw = json.loads((REPO / path).read_text())
    scheme = jimport(raw["scheme"])(raw)
    ref = scheme.get_model_config()
    c = scheme.config
    ref.max_length = scheme.DATASET_SPEC.max_length
    up, upl = c.use_pallas, c.use_pallas_layer
    ref.fused_attention = "auto" if up == "auto" else bool(up)
    ref.fused_edge_block = bool(c.use_pallas_edge)
    ref.fused_layer = ("auto" if up == "auto" else False) \
        if upl == "auto" else bool(upl)
    ref.attention_impl = str(c.attention_impl)
    ref.attn_chain_f32 = bool(c.attn_chain_f32)
    ref.compute_dtype = c.compute_dtype
    ref.remat = c.remat if c.remat == "dots" else bool(c.remat)
    port = schemes.model_config_from_config(str(REPO / path))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    ported = schemes.resolve_config(raw)
    for key in ("length_buckets", "save_best_monitor", "rlr_monitor",
                "dataset_name", "batch_size", "prediction_bmult",
                "include_xpose"):
        assert ported[key] == c[key], key
    # accepted, and not forwarded to the model
    assert ported.include_xpose is True and port.include_xpose is False
    assert timport(raw["scheme"])(raw, device="cpu").config.resolved() \
        == c.resolved()
    port.model_height = 1
    model = TModel(port, device="cpu")
    # the channels without an edge residual read both nodes' features
    assert port.use_node_embeddings == (port.edge_channel_type == "bias")
    shapes = jax.eval_shape(JModel(dataclasses.replace(ref, model_height=1))
                            .init, jax.random.PRNGKey(0))
    assert {k: tuple(p.shape) for k, p in weights.flat_names(model).items()} \
        == {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def test_distance_head_with_the_edge_readout_is_refused():
    cfg = schemes.model_config_from_config(
        {**json.loads((REPO / TSP_CONFIGS[0]).read_text()),
         "distance_loss": 0.1})
    with pytest.raises(NotImplementedError, match="distance head"):
        TModel(cfg, device="cpu")


def _labels(case, rng, n=2000):
    t = rng.integers(0, 2, n)
    p = rng.integers(0, 2, n)
    if case == "no_predicted_positives":
        p[:] = 0
    elif case == "no_true_positives":
        t[:] = 0
    elif case == "all_negative":
        t[:] = 0
        p[:] = 0
    elif case == "skewed":
        t = (rng.random(n) < 0.08).astype(np.int64)
        p = np.where(rng.random(n) < 0.9, t, 1 - t)
    return t, p


@pytest.mark.parametrize("case", ["random", "skewed", "no_predicted_positives",
                                  "no_true_positives", "all_negative"])
def test_tsp_eval_equals_sklearn(case):
    t, p = _labels(case, np.random.default_rng(3))
    got = tsp_eval.scores(t, p)
    ref = {"accuracy": accuracy_score(t, p),
           "precision": precision_score(t, p, zero_division=0.0),
           "recall": recall_score(t, p, zero_division=0.0),
           "f1": f1_score(t, p, zero_division=0.0)}
    assert got == ref
    assert tsp_eval.tsp_lines(t, p) == [
        f"Accuracy = {ref['accuracy']}", f"Precision = {ref['precision']}",
        f"Recall = {ref['recall']}", f"f1 = {ref['f1']}"]


def test_tsp_records_follow_the_benchmark():
    """50-500 points, 25 neighbour edges a point with their lengths, the
    labels of a tour on them."""
    recs = synthetic.tsp_records(np.random.default_rng(4), 3, hi=120)
    for r in recs:
        n, e = r["num_nodes"], r["edges"]
        assert 50 <= n <= 120 and e.shape == (25 * n, 2)
        assert np.all(np.bincount(e[:, 0], minlength=n) == 25)
        assert not np.any(e[:, 0] == e[:, 1])
        xy = r["node_features"]
        np.testing.assert_allclose(
            r["edge_features"][:, 0],
            np.linalg.norm(xy[e[:, 0]] - xy[e[:, 1]], axis=-1), rtol=1e-5)
        lab = np.zeros((n, n), np.int64)
        lab[e[:, 0], e[:, 1]] = r["edge_labels"]
        has = np.zeros((n, n), bool)
        has[e[:, 0], e[:, 1]] = True
        both = has & has.T
        assert np.array_equal(lab[both], lab.T[both])
        # at most 2 tour edges a point; nearly all of the tour's n edges
        # lie among the neighbours of one of their ends
        tour = lab | lab.T
        assert np.all(tour.sum(1) <= 2) and tour.sum() >= 0.95 * 2 * n


def test_load_predictor_serves_edge_logits():
    path = REPO / "configs/main/tsp/100k/egt_spe.json"
    raw = {**json.loads(path.read_text()), "model_height": 1,
           "compute_dtype": "float32"}
    cfg = schemes.model_config_from_config(raw)
    flat = synthetic.random_flat_params(cfg)
    assert flat["mlp_out/dense/0/kernel"].shape == (8, 32)
    assert flat["target/kernel"].shape == (16, 2)
    predict = serving.load_predictor(raw, flat, device="cpu")
    batch = synthetic.tsp_batch(np.random.default_rng(1), 2, 64, pe="svd")
    out = predict(batch)
    assert out.shape == (2, 64, 64, 2) and out.dtype == np.float32
    assert np.all(np.isfinite(out))
    # the edge logits follow the edge features
    moved = {**batch, "feature_matrix": np.where(
        batch["feature_matrix"] >= 0, batch["feature_matrix"] * 2.0, -1.0)}
    assert not np.allclose(predict(moved), out)
