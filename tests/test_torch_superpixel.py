"""The superpixel graph-classification schemes (MNIST, CIFAR10) and the
positional-encoding configs of the port against the JAX package on the
CPU, at a small size (2 layers, width 16, edge width 8, 4 heads, pad
lengths 24 and 28):

- an `egt_spe_do`-shaped model (dense node and edge inputs, the SVD PE
  through `svd_emb`, the distance head): outputs and the distance metric
  within 1e-4 of `GraphModel.apply` in f32 at inference; in training mode
  with the draws off (no random mask, no sign flips), on the plain path and
  through the whole-layer kernel's plain versions (JAX runs its Pallas
  kernel as its own CPU tests do), the total loss (cross-entropy plus the
  weighted distance loss) within 1e-5 and every parameter's gradient within
  1e-4 of `jax.grad`, the last layer's edge tail and `edge_norm_final`
  among them, non-zero;
- the same checks for a PATTERN `_epe` model (eigenvectors padded to the
  width, no transform) and a ZINC `_spe_do` model;
- config resolution of every shipped MNIST / CIFAR10 config and every
  `_spe` / `_epe` / `_spe_do` config of ZINC, PATTERN and CLUSTER against
  JAX's `get_model_config` plus the dispatch-knob copy; each builds a
  model with JAX's parameter names and shapes (the `bias` edge channel's
  without the edge tail);
- `load_predictor` on dense inputs with the SVD PE.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch import schemes, serving, synthetic, weights
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.training.schemes import import_scheme as timport
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training.schemes import import_scheme as jimport
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model

REPO = Path(__file__).resolve().parents[1]
FEAT = {"mnist": 3, "cifar10": 5}
PAD = {"mnist": 24, "cifar10": 28}
PATHS = {"whole_layer_kernel": dict(fused_layer=True),
         "plain": dict(attention_impl="einsum")}
# every shipped MNIST / CIFAR10 config, and every PE config of the others
PE_CONFIGS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.json")
    if json.loads(p.read_text()).get("scheme", "").split(".")[0]
    in ("mnist", "cifar10")
    or (json.loads(p.read_text()).get("scheme", "").split(".")[0]
        in ("zinc", "pattern", "cluster")
        and p.stem.endswith(("_spe", "_epe", "_spe_do"))))


def sp_cfg(kind, **kw):
    """An `egt_spe_do`-shaped model at the small size."""
    kw = {"random_neg": True, **kw}
    return small_cfg(node_input_kind="dense", node_feature_dim=FEAT[kind],
                     edge_input_kind="dense", edge_feature_dim=1,
                     num_targets=10, upto_hop=1, use_svd=True,
                     transform_svd=True, num_svd_features=8,
                     sel_svd_features=4, distance_loss=0.05,
                     distance_target=3, **kw)


def sp_batch(kind, seed, b=4):
    """Small superpixel-like graphs: dense node features in [0, 1], each
    node's edges to its 3 nearest points with a Gaussian-kernel feature,
    -1 padding, a self-looped adjacency, singular vectors, labels 0-9."""
    rng = np.random.default_rng(seed)
    l, f = PAD[kind], FEAT[kind]
    nf = np.full((b, l, f), -1.0, np.float32)
    fm = np.full((b, l, l, 1), -1.0, np.float32)
    adj = np.zeros((b, l, l), np.float32)
    sv = np.zeros((b, l, 8, 2), np.float32)
    for i in range(b):
        n = int(rng.integers(6, l + 1))
        xy = rng.random((n, 2))
        nf[i, :n] = np.concatenate([rng.random((n, f - 2)), xy], 1)
        d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        nbr = np.argsort(d, 1)[:, :3]
        src = np.repeat(np.arange(n), 3)
        fm[i, src, nbr.reshape(-1), 0] = np.exp(-np.take_along_axis(
            d, nbr, 1).reshape(-1) ** 2 / 0.05)
        adj[i, src, nbr.reshape(-1)] = 1.0
        adj[i, np.arange(n), np.arange(n)] = 1.0
        sv[i, :n] = rng.normal(size=(n, 8, 2))
    sample_mask = np.ones((b,), np.float32)
    sample_mask[-1] = 0.0                      # a padding graph
    return {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj,
            "singular_vectors": sv,
            "target": rng.integers(0, 10, b).astype(np.int32),
            "sample_mask": sample_mask}


def _xent(out, batch):
    s, c = jm.sparse_xent_loss(out, batch["target"], None,
                               batch["sample_mask"])
    return s / jnp.maximum(c, 1.0)


def _mae(out, batch):
    s, c = jm.mae_loss(out, batch["target"], None, batch["sample_mask"])
    return s / jnp.maximum(c, 1.0)


def _class_xent(class_sizes):
    cw = jm.class_weights_from_sizes(class_sizes)

    def loss(out, batch, model):
        s, c = jm.sparse_xent_loss(out, batch["target"],
                                   model.output_mask(batch),
                                   batch["sample_mask"], class_weights=cw)
        return s / jnp.maximum(c, 1.0)
    return loss


def _loss_jax(jcfg, scheme_loss):
    """JAX's `_compute_loss` total: the scheme's loss plus ctx.losses."""
    model = JModel(jcfg)

    def loss_fn(p, batch):
        out, ctx = model.apply(p, batch, training=True,
                               rng=jax.random.PRNGKey(0))
        loss = scheme_loss(out, batch, model) if scheme_loss.__code__.\
            co_argcount == 3 else scheme_loss(out, batch)
        for v in ctx.losses.values():
            loss = loss + v
        return loss, (out, ctx.metrics)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _check_loss_and_grads(jcfg, batch, scheme, scheme_loss, check_out):
    """The port's trainer loss (scheme loss + the model's auxiliary losses)
    and every gradient against JAX, in training mode with the draws off;
    returns the port model."""
    params = jax_params(jcfg, seed=2)
    (loss_j, (out_j, metrics_j)), grads_j = _loss_jax(jcfg, scheme_loss)(
        params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    loss_fn = schemes.loss_fn({"scheme": scheme})
    out, ctx = model(batch, training=True, seeds=[1, 2], pe_seed=3,
                     with_context=True)
    check_out(out.detach().numpy(), np.asarray(out_j))
    target = torch.from_numpy(batch["target"])
    loss_t, _ = loss_fn(out, target.long() if not torch.is_floating_point(
        target) else target, model.output_mask(batch),
        torch.from_numpy(batch["sample_mask"]))
    for v in ctx.losses.values():
        loss_t = loss_t + v
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert sorted(ctx.metrics) == sorted(metrics_j)
    for k, v in ctx.metrics.items():
        np.testing.assert_allclose(v.item(), float(metrics_j[k]), rtol=1e-5)
    flat_j = jckpt._flatten_params(grads_j)
    for name, p in weights.flat_names(model).items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, flat_j[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    return model


def _assert_edge_tail_reached(model):
    """The distance head reads the last layer's edge output through the
    final edge norm: their gradients are non-zero."""
    last = f"stack/layers/{model.cfg.model_height - 1}"
    named = weights.flat_names(model)
    for name in (f"{last}/edge_ffn/lr2/kernel", f"{last}/edge_ffn/lr1/kernel",
                 f"{last}/dense_edge_r/kernel", f"{last}/norm_edge/gamma",
                 f"{last}/edge_ffn/norm/gamma",
                 "stack/edge_norm_final/gamma", "stack/edge_norm_final/beta",
                 "distance_head/distance_target/kernel",
                 "distance_head/mlp/dense/0/kernel"):
        g = named[name].grad
        assert g is not None and float(g.abs().max()) > 0, name


@pytest.mark.parametrize("kind", list(FEAT))
def test_model_matches_jax(kind):
    """Inference on the plain path, with the distance metric."""
    jcfg = sp_cfg(kind, **PATHS["plain"])
    params = jax_params(jcfg)
    assert {"svd_emb", "distance_head", "fm_emb"} <= set(params)
    batch = sp_batch(kind, 5)
    def apply(p, b):
        out, ctx = JModel(jcfg).apply(p, b)
        return out, ctx.metrics, ctx.losses
    ref, jmetrics, jlosses = jax.jit(apply)(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out, ctx = model(batch, with_context=True)
    assert out.shape == (4, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ctx.metrics["distance_loss"].item(),
                               float(jmetrics["distance_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(ctx.losses["distance_loss"].item(),
                               float(jlosses["distance_loss"]), rtol=1e-5)
    assert model.output_mask(batch) is None
    assert torch.equal(model.node_valid(batch), torch.from_numpy(
        np.array(JModel(jcfg).node_valid(batch))))
    assert model.input_keys == ("node_features", "feature_matrix",
                                "graph_matrix", "singular_vectors")


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,path", [("mnist", "whole_layer_kernel"),
                                       ("cifar10", "whole_layer_kernel"),
                                       ("mnist", "plain")])
def test_loss_and_grads_match_jax(kind, path):
    """Training mode, the draws off: the cross-entropy plus the distance
    loss, and every gradient, through K3 then K4 and K5's plain versions or
    the plain path."""
    jcfg = sp_cfg(kind, random_neg=False, **PATHS[path])
    model = _check_loss_and_grads(jcfg, sp_batch(kind, 6), f"{kind}.svd",
                                  _xent, _close)
    _assert_edge_tail_reached(model)


def test_pattern_epe_model_matches_jax():
    """PATTERN `_epe`: eigenvectors (sel 2) padded to the width, no
    transform, node readout, whole-layer kernel."""
    jcfg = small_cfg(edge_input_kind="none", num_node_features=3,
                     num_targets=2, readout_kind="node", use_eig=True,
                     num_eig_features=6, sel_eig_features=2,
                     transform_eig=False, random_neg=False, fused_layer=True)
    rng = np.random.default_rng(7)
    batch = random_zinc_batch(rng, b=4, l=24, nf=3)
    del batch["feature_matrix"]
    valid = batch["node_features"] >= 0
    batch["target"] = np.where(valid, rng.integers(0, 2, valid.shape),
                               0).astype(np.int32)
    batch["eigen_vectors"] = np.where(
        valid[..., None], rng.normal(size=(4, 24, 6)), 0).astype(np.float32)
    sizes = [979220, 209900]

    def check(out, ref):
        _close(out[valid], ref[valid])
    model = _check_loss_and_grads(jcfg, batch, "pattern.eig",
                                  _class_xent(sizes), check)
    assert "eig_emb/kernel" not in weights.flat_names(model)
    assert model.input_keys == ("node_features", "graph_matrix",
                                "eigen_vectors")


def test_zinc_spe_do_model_matches_jax():
    """ZINC `_spe_do`: token inputs, the SVD PE and the distance head,
    whole-layer kernel."""
    jcfg = small_cfg(use_svd=True, transform_svd=True, num_svd_features=8,
                     sel_svd_features=4, random_neg=False, distance_loss=0.05,
                     distance_target=3, fused_layer=True)
    batch = random_zinc_batch(np.random.default_rng(8), b=4, l=12, pe="svd")
    model = _check_loss_and_grads(jcfg, batch, "zinc.svd", _mae, _close)
    _assert_edge_tail_reached(model)


@pytest.mark.parametrize("path", PE_CONFIGS)
def test_pe_config_resolution_matches_jax(path):
    raw = json.loads((REPO / path).read_text())
    scheme = jimport(raw["scheme"])(raw)
    ref = scheme.get_model_config()
    c = scheme.config
    # what TrainingBase.load_model copies in (the pad length: the
    # dataset's declared one, None for the SBM schemes)
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
    assert timport(raw["scheme"])(raw, device="cpu").config.resolved() \
        == c.resolved()
    port.model_height = 1
    model = TModel(port, device="cpu")
    shapes = jax.eval_shape(JModel(dataclasses.replace(ref, model_height=1))
                            .init, jax.random.PRNGKey(0))
    assert {k: tuple(p.shape) for k, p in weights.flat_names(model).items()} \
        == {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("kind", list(FEAT))
def test_load_predictor_serves_dense_inputs_with_pes(kind):
    path = REPO / f"configs/main/{kind}/100k/egt_spe_do.json"
    raw = {**json.loads(path.read_text()), "model_height": 1,
           "compute_dtype": "float32"}
    cfg = schemes.model_config_from_config(raw)
    flat = synthetic.random_flat_params(cfg)
    assert {"svd_emb/kernel", "node_emb/kernel", "fm_emb/kernel",
            "distance_head/distance_target/kernel"} <= set(flat)
    predict = serving.load_predictor(raw, flat, device="cpu")
    batch = synthetic.superpixel_batch(np.random.default_rng(1), 3, kind)
    assert batch["node_features"].shape == (3, cfg.max_length, FEAT[kind])
    out = predict(batch)
    assert out.shape == (3, 10) and out.dtype == np.float32
    assert np.all(np.isfinite(out))
    again = predict({k: batch[k] for k in ("node_features", "feature_matrix",
                                           "graph_matrix",
                                           "singular_vectors")})
    np.testing.assert_array_equal(out, again)
