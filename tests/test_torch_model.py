"""The port's serving slice as a whole against the JAX package on the CPU:
the 2-layer model with weights carried from JAX, weight files, config
resolution, the entry point's device rule and import hygiene."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from egt_torch import schemes, serving, weights
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops import egt_attention as tatt
from egt_torch.ops import fused_layer as tfl
from egt_tpu.data import datasets as jdatasets
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.models.graph_model import GraphModelConfig as JCfg
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.schemes import import_scheme
from tests.test_model_forward import random_zinc_batch, small_cfg

REPO = Path(__file__).resolve().parents[1]
ZINC_CONFIGS = ["configs/main/zinc/500k/egt.json",
                "configs/main/zinc/100k/egt.json"]
# every shipped config of the two ZINC schemes (main and ablations)
ALL_ZINC_CONFIGS = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.json")
    if json.loads(p.read_text()).get("scheme") in ("zinc.svd", "zinc.eig"))

# the JAX side picks its path through the config; the port reads the same
# fields ("einsum" pins the JAX plain path that the port's plain path mirrors)
PATHS = {
    "whole_layer_kernel": dict(fused_layer=True),
    "attention_kernel": dict(fused_attention=True),
    "plain": dict(attention_impl="einsum"),
    "constrained_whole_layer": dict(fused_layer=True,
                                    edge_channel_type="constrained"),
    "constrained_plain": dict(attention_impl="einsum",
                              edge_channel_type="constrained"),
    "post_norm_plain": dict(attention_impl="einsum", add_n_norm=True),
}


def jax_params(cfg, seed=0):
    """JAX init, with every leaf moved off its init value so biases and norm
    parameters are load-bearing."""
    params = JModel(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [np.asarray(x) + (0.05 * rng.normal(size=x.shape)).astype(
        np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def port_model(jcfg, flat):
    model = TModel(TCfg(**dataclasses.asdict(jcfg)), device="cpu")
    return weights.load_flat_params(model, flat).eval()


def run_both(kw, **extra):
    jcfg = small_cfg(**kw, **extra)
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(5), b=4, l=12)
    ref, _ = JModel(jcfg).apply(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out = model(batch)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("path", list(PATHS))
def test_model_matches_jax_f32(path):
    out, ref = run_both(PATHS[path])
    assert out.shape == (4, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# bf16: both models round h, e, the per-layer activations and the kernels'
# intermediates to bf16 at the same points, so here they agree to f32 noise
# (2.4e-7 on outputs of magnitude 2.5). The tolerance leaves room for a
# summation-order change in either framework to flip one bf16 rounding of an
# intermediate (2^-8 relative), which moves the output by a fraction of that.
@pytest.mark.parametrize("path", ["whole_layer_kernel", "attention_kernel",
                                  "plain"])
def test_model_matches_jax_bf16(path):
    out, ref = run_both(PATHS[path], compute_dtype="bfloat16")
    np.testing.assert_allclose(out, ref, rtol=5e-3, atol=5e-3)


def test_npz_round_trip(tmp_path):
    jcfg = small_cfg(fused_layer=True)
    params = jax_params(jcfg, seed=1)
    path = str(tmp_path / "w.npz")
    jckpt.save_weights(params, path)
    batch = random_zinc_batch(np.random.default_rng(2), b=4, l=12)
    a = port_model(jcfg, jckpt._flatten_params(params))
    b = weights.load_npz(TModel(a.cfg, device="cpu"), path)
    with torch.inference_mode():
        np.testing.assert_array_equal(a(batch).numpy(), b(batch).numpy())


def test_load_flat_params_is_strict():
    jcfg = small_cfg()
    flat = jckpt._flatten_params(jax_params(jcfg))
    model = TModel(TCfg(**dataclasses.asdict(jcfg)), device="cpu")
    with pytest.raises(KeyError):
        weights.load_flat_params(model, {k: v for k, v in flat.items()
                                         if k != "target/bias"})
    with pytest.raises(KeyError):
        weights.load_flat_params(model, {**flat, "extra/kernel": flat["target/bias"]})
    bad = dict(flat)
    bad["target/kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        weights.load_flat_params(model, bad)


@pytest.mark.parametrize("path", ALL_ZINC_CONFIGS)
def test_zinc_config_resolution_matches_jax(path):
    raw = json.loads((REPO / path).read_text())
    scheme = import_scheme(raw["scheme"])(raw)
    ref = scheme.get_model_config()
    # what TrainingBase.load_model does before building the model
    c = scheme.config
    ref.max_length = jdatasets.ZINC.max_length
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


def test_config_knobs_select_paths():
    raw = json.loads((REPO / ZINC_CONFIGS[0]).read_text())
    a = schemes.model_config_from_config(raw)
    assert a.fused_layer and a.compute_dtype == "bfloat16"
    b = schemes.model_config_from_config(
        {**raw, "use_pallas": True, "use_pallas_layer": False})
    assert b.fused_attention is True and b.fused_layer is False
    assert tfl.can_fuse_layer(a)
    assert not tfl.can_fuse_layer(b)


def test_config_field_sets_match():
    assert ({f.name for f in dataclasses.fields(TCfg)}
            == {f.name for f in dataclasses.fields(JCfg)})


def test_unknown_config_key_raises():
    raw = json.loads((REPO / ZINC_CONFIGS[0]).read_text())
    with pytest.raises(KeyError):
        schemes.model_config_from_config({**raw, "no_such_key": 1})


def test_load_predictor_needs_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = str(REPO / ZINC_CONFIGS[1])
    with pytest.raises(RuntimeError):
        serving.load_predictor(cfg, {})


def test_load_predictor_on_cpu_serves():
    raw = json.loads((REPO / ZINC_CONFIGS[1]).read_text())
    raw.update(model_height=1, compute_dtype="float32")
    cfg = schemes.model_config_from_config(raw)
    flat = {k: p.detach().numpy() for k, p in weights.flat_names(
        TModel(cfg, device="cpu")).items()}
    predict = serving.load_predictor(raw, flat, device="cpu")
    batch = random_zinc_batch(np.random.default_rng(3), b=3, l=40)
    batch["graph_matrix"] = batch["graph_matrix"].astype(np.uint8)
    out = predict(batch)
    assert out.shape == (3, 1) and out.dtype == np.float32
    assert np.all(np.isfinite(out))


def _port_sources():
    return sorted((REPO / "egt_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_statically():
    banned = ("jax", "jaxlib", "egt_tpu")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_port_imports_no_jax_at_runtime():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "egt_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'egt_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_sources_exist_and_cpu_takes_plain_path():
    kernels = (tfl.KERNEL, tfl.BWD_TAIL_KERNEL, tfl.BWD_ATTN_KERNEL,
               tatt.KERNEL, tatt.BWD_KERNEL)
    for kern in kernels:
        assert (REPO / "egt_torch" / "csrc" / f"{kern.source}.cu").is_file()
    launches = tuple(k.launches for k in kernels)
    for kw in (PATHS["whole_layer_kernel"], PATHS["attention_kernel"]):
        run_both(kw)
    assert tuple(k.launches for k in kernels) == launches == (0,) * 5
