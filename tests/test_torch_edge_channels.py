"""The `bias` and `none` edge channels, the pairwise-cat edge readout and the
ZINC-full schemes of the port against the JAX package on the CPU, at a small
size (2 layers, width 16, or 20 for a per-head width of 5, edge width 8, 4
heads, pads 12-24):

- one layer (`layer_forward`) of the `bias` channel, gated and ungated, and
  of the `none` channel, against JAX's in f32 within 1e-5, at inference and
  in training mode with the draws off: `bias` through the attention
  kernel's plain versions (JAX runs its Pallas kernel as its own CPU tests
  do) and through the plain core (JAX's einsum path), `none` through the
  plain core; e passes through unchanged. With the attention kernel asked
  for, `none` raises a ValueError naming JAX's `egt_pallas.py:538`, where
  JAX's kernel path fails too; under "auto" it runs the plain core and
  matches JAX's "auto" output within 1e-5;
- three `egt_simple`-shaped models on the attention kernel's path (ZINC:
  tokens and hops; PATTERN: no edge inputs, the hops alone; TSP: dense
  inputs and the pairwise-cat edge readout) and a `none` model with the
  pairwise-cat edge readout on the plain path (e passes through the stack):
  outputs within 1e-4 of `GraphModel.apply`, the scheme's loss within 1e-5
  and every parameter's gradient within 1e-4 of `jax.grad`, the edge
  embeddings' gradients (every layer's de and dg summed) non-zero;
- the flat parameter names of a `bias` and a `none` model equal JAX's
  `init` (no edge LN, `dense_edge_r`, edge FFN or `edge_norm_final`; for
  `none` no edge bias or gates);
- config resolution of all 18 `egt_simple` and all 10 `zinc_full` configs
  against JAX's `get_model_config` plus the dispatch-knob copy, each
  building a model with JAX's parameter shapes; `pcqm4mv2/egt_large.json`
  built at full size with JAX's parameter names, shapes and count;
- a 1-epoch `zinc_full.svd` run of an `egt_simple`-shaped model against the
  JAX engine's `metrics.jsonl`, and `do_evaluations` through the port's CLI
  entry point printing JAX's MAE lines.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch import do_evaluations, schemes, weights
from egt_torch.models import layers as TL
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops.fused_layer import can_fuse_layer
from egt_torch.training.schemes import import_scheme as timport
from egt_tpu.models import layers as JL
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_zinc_like
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model
from tests.test_torch_sbm import sbm_batch, sbm_cfg
from tests.test_torch_superpixel import (_check_loss_and_grads, _class_xent,
                                         _mae)
from tests.test_torch_tsp import tsp_batch, tsp_cfg

REPO = Path(__file__).resolve().parents[1]
PATHS = {"attention_kernel": dict(fused_attention=True),
         "plain": dict(attention_impl="einsum")}
LAYERS = {"bias_gated": dict(edge_channel_type="bias"),
          "bias_ungated_d5": dict(edge_channel_type="bias",
                                  gate_attention=False, model_width=20),
          "none": dict(edge_channel_type="none")}
LAYER_CASES = [(k, p) for k in LAYERS for p in PATHS
               if not (k == "none" and p == "attention_kernel")]
EDGE_TAIL = ("norm_edge", "dense_edge_r", "edge_ffn")


def _configs(select):
    return sorted(str(p.relative_to(REPO))
                  for p in (REPO / "configs").rglob("*.json") if select(p))


SIMPLE_CONFIGS = _configs(lambda p: "egt_simple" in p.parts)
ZINC_FULL_CONFIGS = _configs(lambda p: json.loads(p.read_text()).get(
    "scheme", "").startswith("zinc_full."))


def _layer_inputs(cfg, seed, b=3, l=12):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, l, cfg.model_width)).astype(np.float32)
    e = rng.normal(size=(b, l, l, cfg.edge_width)).astype(np.float32)
    n = rng.integers(4, l + 1, size=b)
    mask = np.arange(l)[None] < n[:, None]
    return h, e, mask


@pytest.mark.parametrize("training", [False, True],
                         ids=["inference", "training"])
@pytest.mark.parametrize("layer,path", LAYER_CASES)
def test_layer_matches_jax(layer, path, training):
    jcfg = small_cfg(**LAYERS[layer], **PATHS[path])
    params = jax_params(jcfg)
    h, e, mask = _layer_inputs(jcfg, 1)
    rng = jax.random.PRNGKey(0) if training else None
    ref_h, ref_e = jax.jit(lambda p, h, e, m: JL.layer_forward(
        p, jcfg, h, e, m, None, training, rng, None, False, 0)[:2])(
        params["stack"]["layers"][0], h, e, mask)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out_h, out_e = TL.layer_forward(
            model.stack["layers"][0], model.cfg, torch.from_numpy(h),
            torch.from_numpy(e), torch.from_numpy(mask), None, training,
            seed=1 if training else None)
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), rtol=1e-5,
                               atol=1e-5)
    # the channel is not updated: e comes back as it went in
    assert torch.equal(out_e, torch.from_numpy(e))
    np.testing.assert_array_equal(np.asarray(ref_e), e)


@pytest.mark.parametrize("knob", [True, "auto"])
def test_none_channel_refuses_the_attention_kernel(knob):
    """With the kernel asked for, `none` raises where JAX's kernel path
    fails; under "auto" it runs the plain core, as JAX's "auto" runs it
    below its crossover, and its outputs match JAX's within 1e-5."""
    jcfg = small_cfg(edge_channel_type="none", fused_attention=knob)
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(2))
    model = port_model(jcfg, jckpt._flatten_params(params))
    if knob == "auto":
        ref, _ = JModel(jcfg).apply(params, batch)
        with torch.inference_mode():
            out = model(batch)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        return
    # JAX's kernel path casts the edge bias it hands the kernel
    with pytest.raises(AttributeError, match="astype"):
        JModel(jcfg).apply(params, batch)
    with pytest.raises(ValueError, match="egt_pallas.py:538") as exc:
        model(batch)
    assert "use_pallas: false" in str(exc.value)


def _tsp_xent(out, batch, model):
    s, c = jm.sparse_xent_loss(out, batch["target"], model.output_mask(batch),
                               batch["sample_mask"])
    return s / jnp.maximum(c, 1.0)


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _close_valid_nodes(batch):
    valid = batch["node_features"] >= 0

    def check(out, ref):
        _close(out[valid], ref[valid])
    return check


def _models():
    """(config, batch, scheme, JAX scheme loss, output check) a model."""
    zinc = random_zinc_batch(np.random.default_rng(3), b=4, l=12)
    zinc["sample_mask"][-1] = 0.0
    pattern = sbm_batch("pattern", 4)
    return {
        "zinc_simple": (small_cfg(edge_channel_type="bias", upto_hop=3,
                                  **PATHS["attention_kernel"]),
                        zinc, "zinc.svd", _mae, _close),
        "pattern_simple": (sbm_cfg("pattern", edge_channel_type="bias",
                                   upto_hop=3, **PATHS["attention_kernel"]),
                           pattern, "pattern.svd",
                           _class_xent([979220, 209900]),
                           _close_valid_nodes(pattern)),
        "tsp_simple": (tsp_cfg(edge_channel_type="bias",
                               use_node_embeddings=True,
                               **PATHS["attention_kernel"]),
                       tsp_batch(5, l=16), "tsp.svd", _tsp_xent, _close),
        "tsp_none_plain": (tsp_cfg(edge_channel_type="none",
                                   use_node_embeddings=True,
                                   **PATHS["plain"]),
                           tsp_batch(6, l=16), "tsp.svd", _tsp_xent, _close),
    }


@pytest.mark.parametrize("kind", ["zinc_simple", "pattern_simple",
                                  "tsp_simple", "tsp_none_plain"])
def test_model_loss_and_grads_match_jax(kind):
    jcfg, batch, scheme, loss, check = _models()[kind]
    model = _check_loss_and_grads(jcfg, batch, scheme, loss, check)
    named = weights.flat_names(model)
    embeddings = [k for k in ("fm_emb/kernel", "fm_emb/table",
                              "adj_emb/kernel") if k in named]
    assert "adj_emb/kernel" in embeddings
    for name in embeddings:
        assert float(named[name].grad.abs().max()) > 0, name
    if jcfg.readout_kind == "edge":
        # the readout MLP reads both nodes' features and the edge channel
        assert named["mlp_out/dense/0/kernel"].shape[0] == \
            2 * jcfg.model_width + jcfg.edge_width


def _jax_names(jcfg):
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("channel", ["bias", "none"])
def test_parameter_names_match_jax_init(channel):
    jcfg = small_cfg(edge_channel_type=channel)
    model = TModel(TCfg(**dataclasses.asdict(jcfg)), device="cpu")
    names = {k: tuple(p.shape) for k, p in weights.flat_names(model).items()}
    assert names == _jax_names(jcfg)
    layer = {k.split("/")[3] for k in names if k.startswith("stack/layers/")}
    assert not layer & set(EDGE_TAIL)
    assert "stack/edge_norm_final/gamma" not in names
    edge_stream = {"dense_edge_b", "attention_gates"}
    assert edge_stream <= layer if channel == "bias" \
        else not layer & edge_stream
    # `none` reads no edges, so it builds no edge embedding
    assert ("fm_emb/table" in names) == (channel == "bias")


@pytest.mark.parametrize("path", SIMPLE_CONFIGS + ZINC_FULL_CONFIGS)
def test_config_resolution_matches_jax(path):
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
    assert timport(raw["scheme"])(raw, device="cpu").config.resolved() \
        == c.resolved()
    port.model_height = 1
    model = TModel(port, device="cpu")
    assert {k: tuple(p.shape) for k, p in weights.flat_names(model).items()} \
        == _jax_names(dataclasses.replace(ref, model_height=1))
    if port.edge_channel_type == "bias":
        # the main path of the `egt_simple` configs: the attention kernel
        assert port.fused_attention == "auto" and not can_fuse_layer(port)


def test_pcqm4mv2_still_raises():
    """`pcqm4mv2/egt_large.json` builds at full width and depth (30 layers
    of width 768, 4 virtual nodes, the OGB token tables) with JAX's
    parameter names, shapes and count."""
    path = REPO / "configs/pcqm4mv2/egt_large.json"
    raw = json.loads(path.read_text())
    ref = jimport(raw["scheme"])(raw).get_model_config()
    model = TModel(schemes.model_config_from_config(str(path)), device="cpu")
    names = {k: tuple(p.shape) for k, p in weights.flat_names(model).items()}
    assert names == _jax_names(ref)
    count = sum(int(np.prod(s)) for s in names.values())
    assert count == sum(p.numel() for p in model.parameters())
    assert 100e6 < count < 120e6 and len(model.stack["layers"]) == 30


# ------------------------------------------------------------ the ZINC-full engine

FIELDS = ("loss", "mae", "val_loss", "val_mae", "lr")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("zinc_full_engine")
    make_zinc_like(str(d / "zinc_full.h5"), n_records=16, name="ZINC_full")
    return d


def tiny_config(d, name, **kw):
    """An `egt_simple`-shaped `zinc_full.svd` run, f32, no random draws."""
    cfg = {
        "scheme": "zinc_full.svd",
        "model_name": name,
        "dataset_path": str(d / "zinc_full.h5"),
        "cache_dir": str(d / "cache" / name),
        "save_path": str(d / "models" / name),
        "batch_size": 8,
        "num_epochs": 1,
        "model_width": 16,
        "edge_width": 8,
        "model_height": 2,
        "num_heads": 4,
        "use_svd": False,
        "edge_channel_type": "bias",
        "upto_hop": 3,
        "initial_lr": 1e-3,
        "log_tensorboard": False,
        "compute_dtype": "float32",
        "attention_impl": "einsum",
        "use_pallas": False,
        "random_mask_prob": 0.0,
    }
    cfg.update(kw)
    return cfg


def _records(d, name):
    with open(d / "models" / name / "logs" / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


@pytest.fixture(scope="module")
def runs(workdir):
    js = jimport("zinc_full.svd")(tiny_config(workdir, "jax"))
    js.save_config_file()
    js.load_data()
    js.load_model()
    init = jckpt._flatten_params(jax.device_get(js.params))
    js.load_state()
    js.train_model()
    js.finalize_training(skip_init=True)
    ts = timport("zinc_full.svd")(tiny_config(workdir, "port"), device="cpu")
    ts.save_config_file()
    ts.load_data()
    ts.load_model()
    weights.load_flat_params(ts.model, init)
    ts.load_state()
    ts.train_model()
    ts.finalize_training(skip_init=True)
    return js, ts


def test_zinc_full_epoch_matches_jax(workdir, runs):
    js, ts = runs
    assert ts.DATASET_SPEC.name == "ZINC_full"
    assert ts.config.dataset_name == "zinc_full"
    assert ts.config.save_best_monitor == "val_mae"
    got, ref = _records(workdir, "port"), _records(workdir, "jax")
    assert len(got) == len(ref) == 1
    for k in FIELDS:
        np.testing.assert_allclose(got[0][k], ref[0][k], rtol=1e-4,
                                   err_msg=k)
    assert ts.state["global_step"] == js.state["global_step"]


def test_zinc_full_evaluation_lines_match_jax(workdir, runs):
    final = str(workdir / "models" / "jax" / "saved" / "jax.npz")
    js = jimport("zinc_full.svd")(tiny_config(workdir, "jax_eval",
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
        assert " MAE = " in got
