"""The SBM node-classification schemes (PATTERN, CLUSTER) of the port against
the JAX package on the CPU, at a small size (2 layers, width 16, edge width
8, 4 heads, pad lengths 24 and 32):

- the model with no edge inputs (the edge channel from the hop embedding
  alone) and the per-node readout: outputs on the valid nodes within 1e-4
  of the JAX `GraphModel.apply` in f32, at inference on the plain path, and
  in training mode (no draws) on the plain path and through the whole-layer
  kernel's plain versions (JAX runs its Pallas kernel as its own CPU tests
  do);
- there, the class-weighted cross-entropy within 1e-5 and every
  parameter's gradient within 1e-4 of `jax.grad`;
- the flat-name round trip of a model without `fm_emb`;
- the loss pieces (`class_weights_from_sizes`, the weighted sparse xent,
  the accuracy) on a node mask, and `sbm_eval`'s numpy metrics and printed
  lines against the JAX module's scikit-learn ones;
- config resolution of every shipped PATTERN / CLUSTER config, the
  positional encodings building and serving, and `load_predictor` on a
  node readout.
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
from egt_torch.training import metrics as tm
from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.schemes import sbm_eval as tsbm
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training.schemes import import_scheme as jimport
from egt_tpu.training.schemes import sbm_eval as jsbm
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model

REPO = Path(__file__).resolve().parents[1]
# node-token vocabulary, classes and class sizes of each scheme
KINDS = {"pattern": (3, 2, [979220, 209900]),
         "cluster": (7, 6, [19695, 19222, 19559, 19417, 19801, 20139])}
PATHS = {"whole_layer_kernel": dict(fused_layer=True),
         "plain": dict(attention_impl="einsum")}
# (kind, path) of the training-mode checks: the whole-layer kernel for both
# schemes, the plain path for one (each case compiles the JAX step anew)
GRAD_CASES = [("pattern", "whole_layer_kernel"),
              ("cluster", "whole_layer_kernel"), ("cluster", "plain")]
PAD = {"pattern": 24, "cluster": 32}
SBM_CONFIGS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.json")
    if json.loads(p.read_text()).get("scheme", "").split(".")[0]
    in ("pattern", "cluster"))


def sbm_cfg(kind, **kw):
    nf, nt, _ = KINDS[kind]
    return small_cfg(edge_input_kind="none", num_node_features=nf,
                     num_targets=nt, readout_kind="node", **kw)


def sbm_batch(kind, seed, b=4):
    """Small graphs with node tokens and node labels, no edge inputs."""
    nf, nt, _ = KINDS[kind]
    rng = np.random.default_rng(seed)
    batch = random_zinc_batch(rng, b=b, l=PAD[kind], nf=nf)
    del batch["feature_matrix"]
    valid = batch["node_features"] >= 0
    batch["target"] = np.where(valid, rng.integers(0, nt, valid.shape),
                               0).astype(np.int32)
    batch["sample_mask"][-1] = 0.0          # a padding graph
    return batch


def _check_outputs(out, ref, batch, kind):
    assert out.shape == ref.shape == (4, PAD[kind], KINDS[kind][1])
    valid = batch["node_features"] >= 0
    np.testing.assert_allclose(out[valid], ref[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(kind):
    """Inference on the plain path (the kernel paths: the training-mode
    cases below)."""
    jcfg = sbm_cfg(kind, **PATHS["plain"])
    params = jax_params(jcfg)
    assert "fm_emb" not in params and "adj_emb" in params
    batch = sbm_batch(kind, 5)
    ref = np.asarray(jax.jit(lambda p, b: JModel(jcfg).apply(p, b)[0])(
        params, batch))
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out = model(batch).numpy()
    _check_outputs(out, ref, batch, kind)
    assert torch.equal(model.output_mask(batch),
                       torch.from_numpy(np.asarray(
                           JModel(jcfg).output_mask(batch))))


def _loss_jax(jcfg, class_sizes):
    model = JModel(jcfg)
    cw = jm.class_weights_from_sizes(class_sizes)

    def loss_fn(p, batch):
        out, _ = model.apply(p, batch, training=True,
                             rng=jax.random.PRNGKey(0))
        s, c = jm.sparse_xent_loss(out, batch["target"],
                                   model.output_mask(batch),
                                   batch["sample_mask"], class_weights=cw)
        return s / jnp.maximum(c, 1.0), out

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("kind,path", GRAD_CASES)
def test_loss_and_grads_match_jax(kind, path):
    """The outputs in training mode, and the scheme's loss as the port's
    trainer takes it (`schemes.loss_fn`) with its gradients, through the
    whole-layer kernel's plain versions (K3; K4 then K5) or the plain path,
    against the JAX model and `jax.grad` of the JAX scheme's loss."""
    jcfg = sbm_cfg(kind, **PATHS[path])
    params = jax_params(jcfg, seed=2)
    batch = sbm_batch(kind, 6)
    (loss_j, out_j), grads_j = _loss_jax(jcfg, KINDS[kind][2])(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    loss_fn = schemes.loss_fn({"scheme": f"{kind}.svd", "use_svd": False})
    out = model(batch, training=True, seeds=[1, 2])
    _check_outputs(out.detach().numpy(), np.asarray(out_j), batch, kind)
    loss_t, pairs = loss_fn(out, torch.from_numpy(batch["target"]).long(),
                            model.output_mask(batch),
                            torch.from_numpy(batch["sample_mask"]))
    loss_t.backward()
    assert sorted(pairs) == ["acc", "xent"]
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    flat_j = jckpt._flatten_params(grads_j)
    for name, p in weights.flat_names(model).items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, flat_j[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_weights_round_trip_without_fm_emb(kind, tmp_path):
    jcfg = sbm_cfg(kind)
    params = jax_params(jcfg, seed=1)
    flat = jckpt._flatten_params(params)
    model = port_model(jcfg, flat)
    names = set(weights.flat_names(model))
    assert names == set(flat)
    assert not any(n.startswith("fm_emb/") for n in names)
    assert {"node_emb/table", "adj_emb/kernel", "mlp_out/dense/0/kernel",
            "target/kernel", "stack/layers/1/dense_qkv/kernel"} <= names
    assert set(synthetic.random_flat_params(model.cfg)) == names
    path = str(tmp_path / "w.npz")
    jckpt.save_weights(params, path)
    loaded = weights.load_npz(TModel(model.cfg, device="cpu"), path)
    for k, v in weights.flat_arrays(loaded).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    back = jckpt._flatten_params(jckpt.load_weights(params, path))
    assert sorted(back) == sorted(flat)


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_pieces_match_jax_on_a_node_mask(kind):
    nf, nt, sizes = KINDS[kind]
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(3, 9, nt)).astype(np.float32)
    target = rng.integers(0, nt, (3, 9)).astype(np.int32)
    mask = rng.random((3, 9)) < 0.7
    smask = np.array([1.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(tm.class_weights_from_sizes(sizes),
                                  jm.class_weights_from_sizes(sizes))
    cw = jm.class_weights_from_sizes(sizes)
    for fn_t, fn_j, kw in ((tm.sparse_xent_loss, jm.sparse_xent_loss,
                            dict(class_weights=cw)),
                           (tm.accuracy, jm.accuracy, {})):
        got = fn_t(torch.from_numpy(pred), torch.from_numpy(target).long(),
                   torch.from_numpy(mask), torch.from_numpy(smask), **kw)
        ref = fn_j(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                   jnp.asarray(smask), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.item(), float(r), rtol=1e-6)


# fixed label arrays: 6 classes with one never a target (sklearn's macro
# recall counts it as 0), two classes, and predictions missing a class
EVAL_CASES = {
    "six": (np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 2, 2]),
            np.array([0, 1, 2, 5, 4, 1, 1, 2, 0, 4, 3, 2])),
    "two": (np.array([0, 0, 1, 1, 0, 1, 0, 0]),
            np.array([0, 1, 1, 0, 0, 1, 0, 0])),
    "missing": (np.array([0, 1, 2, 2, 1]), np.array([0, 0, 2, 2, 2])),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_sbm_eval_metrics_equal_sklearn(case):
    from sklearn.metrics import accuracy_score, confusion_matrix, recall_score
    t, p = EVAL_CASES[case]
    np.testing.assert_array_equal(tsbm.confusion_matrix(t, p),
                                  confusion_matrix(t, p))
    assert tsbm.accuracy(t, p) == accuracy_score(t, p)
    for avg in ("micro", "macro"):
        assert tsbm.recall(t, p, avg) == recall_score(
            t, p, average=avg, zero_division=0)
    assert tsbm.accuracy_sbm(t, p) == jsbm.accuracy_sbm(t, p)


class _FakeScheme:
    """`predict_split` over fixed batches: (host batch, logits)."""

    def __init__(self, kind, seed):
        nt = KINDS[kind][1]
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(3):
            b = sbm_batch(kind, int(rng.integers(1 << 30)))
            self.items.append((b, rng.normal(
                size=b["target"].shape + (nt,)).astype(np.float32)))

    def predict_split(self, split):
        yield from self.items


@pytest.mark.parametrize("kind", list(KINDS))
def test_sbm_eval_lines_equal_jax(kind):
    scheme = _FakeScheme(kind, 4)
    if kind == "pattern":
        got = tsbm.evaluate_pattern(scheme, "test", KINDS[kind][2])
        ref = jsbm.evaluate_pattern(scheme, "test", KINDS[kind][2])
    else:
        got = tsbm.evaluate_cluster(scheme, "test")
        ref = jsbm.evaluate_cluster(scheme, "test")
    assert got == ref and len(got) == (5 if kind == "pattern" else 4)


@pytest.mark.parametrize("path", SBM_CONFIGS)
def test_sbm_config_resolution_matches_jax(path):
    raw = json.loads((REPO / path).read_text())
    scheme = jimport(raw["scheme"])(raw)
    ref = scheme.get_model_config()
    c = scheme.config
    # what TrainingBase.load_model copies in (the pad length comes from the
    # batch: no fixed max_length)
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
    for key in ("length_buckets", "class_sizes", "save_best_monitor",
                "rlr_monitor", "dataset_name", "batch_size"):
        assert ported[key] == c[key], key
    assert timport(raw["scheme"])(raw, device="cpu").config.resolved() \
        == c.resolved()


@pytest.mark.parametrize("kind", list(KINDS))
def test_shipped_config_builds_the_model(kind):
    """The shipped 500k config at full width and depth: 16 layers, no
    `fm_emb`, 2 or 6 node classes, length buckets 128 / 192."""
    path = str(REPO / f"configs/main/{kind}/500k/egt.json")
    cfg = schemes.model_config_from_config(path)
    model = TModel(cfg, device="cpu")
    assert len(model.stack["layers"]) == 16 and not hasattr(model, "fm_emb")
    assert model.target["kernel"].shape[1] == KINDS[kind][1]
    assert model.input_keys == ("node_features", "graph_matrix")
    assert schemes.resolve_config(path).length_buckets == [128, 192]


@pytest.mark.parametrize("kind", list(KINDS))
def test_positional_encodings_build(kind):
    """`<kind>.svd` with `use_svd` and `<kind>.eig` build and serve node
    logits from their PE arrays, and so does the SVD config with a virtual
    node."""
    raw = json.loads((REPO / f"configs/main/{kind}/500k/egt.json").read_text())
    raw.update(model_height=1, compute_dtype="float32")
    eig = {k: v for k, v in raw.items() if k != "use_svd"}
    nf = KINDS[kind][0]
    for cfg_raw, key, shape in (
            ({**raw, "use_svd": True}, "singular_vectors", (16, 2)),
            ({**eig, "scheme": f"{kind}.eig"}, "eigen_vectors", (20,))):
        cfg = schemes.model_config_from_config(cfg_raw)
        model = TModel(cfg, device="cpu")
        assert key in model.input_keys
        flat = synthetic.random_flat_params(cfg)
        predict = serving.load_predictor(cfg_raw, flat, device="cpu")
        rng = np.random.default_rng(2)
        batch = random_zinc_batch(rng, b=3, l=PAD[kind], nf=nf)
        batch[key] = rng.normal(size=(3, PAD[kind]) + shape).astype(
            np.float32)
        out = predict(batch)
        assert out.shape == (3, PAD[kind], KINDS[kind][1])
        assert np.all(np.isfinite(out))
        # the PE reaches the outputs
        batch[key] = batch[key] * 2.0
        assert not np.allclose(predict(batch), out)
    # with a virtual node the model serves the same nodes: the readout
    # leaves the virtual row out
    vn = dataclasses.replace(
        schemes.model_config_from_config({**raw, "use_svd": True}),
        num_virtual_nodes=1)
    model = TModel(vn, device="cpu")
    weights.load_flat_params(model, synthetic.random_flat_params(vn))
    rng = np.random.default_rng(3)
    batch = random_zinc_batch(rng, b=3, l=PAD[kind], nf=nf)
    batch["singular_vectors"] = rng.normal(size=(3, PAD[kind], 16, 2)).astype(
        np.float32)
    with torch.inference_mode():
        out = model.eval()(batch)
    assert out.shape == (3, PAD[kind], KINDS[kind][1])
    assert torch.isfinite(out).all()
    assert model.virtual_node_embeddings.shape == (1, vn.model_width)


@pytest.mark.parametrize("kind", list(KINDS))
def test_load_predictor_serves_nodes_at_any_pad(kind):
    raw = json.loads((REPO / f"configs/main/{kind}/500k/egt.json").read_text())
    raw.update(model_height=1, compute_dtype="float32")
    flat = synthetic.random_flat_params(schemes.model_config_from_config(raw))
    predict = serving.load_predictor(raw, flat, device="cpu")
    for pad in (PAD["pattern"], PAD["cluster"]):
        batch = random_zinc_batch(np.random.default_rng(pad), b=3, l=pad,
                                  nf=KINDS[kind][0])
        batch["graph_matrix"] = batch["graph_matrix"].astype(np.uint8)
        out = predict(batch)                    # feature_matrix not read
        assert out.shape == (3, pad, KINDS[kind][1])
        assert out.dtype == np.float32 and np.all(np.isfinite(out))
