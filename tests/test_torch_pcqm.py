"""Virtual nodes, multi-column OGB tokens and the PCQM4Mv2 schemes of the port
against the JAX package on the CPU, at a small size:

- `multi_token_embed` (the 175-row atom table, JAX's gather; the 14-row
  bond table, JAX's one-hot product), `prepend_virtual_nodes`,
  `prepend_virtual_edges` and `extend_edge_mask_for_vn` against JAX's
  within 1e-6;
- an EGT-Large-shaped model (4 virtual nodes, the degree scaler, 9 / 3
  token columns, the graph readout from the virtual nodes' rows, `ffn_multiplier`
  1, one hop; width 32, edge width 8, 2 layers, 4 heads, pad 16) in training
  mode with the draws off: outputs, the MAE loss and every parameter's
  gradient within 1e-4 of JAX's plain path (`jax.grad`), on the port's
  plain core and through the attention kernel's plain versions (the
  degree scaler's virtual rows pinned to 1 in both);
- virtual nodes with the node readout (SBM), the edge readout on the edge
  channel and in its pairwise-cat form (TSP), and the constrained channel
  with the distance head (ZINC), each against `jax.grad`;
- `pcqm4mv2.base` (`configs/pcqm4mv2/egt_large.json`) and `.svd`
  resolving to JAX's `GraphModelConfig` and resolved config; every one of
  the 77 shipped configs resolving and building at its own widths;
- the synthetic corpus against `tools/synth_pcqm.py`'s generator;
- the port's CLI triple on a 16-record PCQM fixture in f32.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch import (do_evaluations, end_training, run_training, schemes,
                       synthetic, weights)
from egt_torch.data import hdf5_io
from egt_torch.models import features as TF
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.training.schemes import import_scheme as timport
from egt_tpu.data.datasets import OGB_ATOM_DIMS, OGB_BOND_DIMS
from egt_tpu.models import features as JF
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from egt_tpu.training.schemes import import_scheme as jimport
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model
from tests.test_torch_sbm import sbm_batch, sbm_cfg
from tests.test_torch_superpixel import (_check_loss_and_grads, _class_xent,
                                         _mae)
from tests.test_torch_tsp import tsp_batch, tsp_cfg
from tools import synth_molecular, synth_pcqm

REPO = Path(__file__).resolve().parents[1]
EGT_LARGE = REPO / "configs" / "pcqm4mv2" / "egt_large.json"


def _close(out, ref, tol=1e-4):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


# ------------------------------------------------------------------- features

def test_multi_token_embed_matches_jax():
    rng = np.random.default_rng(0)
    for dims, shape in ((OGB_ATOM_DIMS, (3, 7)), (OGB_BOND_DIMS, (3, 7, 7))):
        table = rng.normal(size=(sum(dims) + 1, 5)).astype(np.float32)
        ids = np.stack([rng.integers(0, d, size=shape) for d in dims], -1)
        ids[:, -2:] = -1                       # padding nodes / rows
        ref = JF.multi_token_embed({"table": table}, ids, dims)
        out = TF.multi_token_embed({"table": torch.from_numpy(table)},
                                   torch.from_numpy(ids), dims)
        _close(out.numpy(), np.asarray(ref), 1e-6)
        # a padding node or row reads the mask row in every column
        pad = out.numpy()[:, -2:]
        _close(pad, np.broadcast_to(len(dims) * table[0], pad.shape), 1e-6)


@pytest.mark.parametrize("fn", ["prepend_virtual_nodes",
                                "prepend_virtual_edges",
                                "extend_edge_mask_for_vn"])
def test_virtual_node_features_match_jax(fn):
    rng = np.random.default_rng(1)
    b, l, k, w = 2, 5, 3, 4
    if fn == "prepend_virtual_nodes":
        args = (rng.normal(size=(b, l, w)), rng.normal(size=(k, w)))
    elif fn == "prepend_virtual_edges":
        args = (rng.normal(size=(b, l, l, w)), rng.normal(size=(k, w)))
    else:
        args = ((rng.random((b, l, l, 2)) < 0.5), k)
    args = tuple(a.astype(np.float32) if isinstance(a, np.ndarray) else a
                 for a in args)
    ref = np.asarray(getattr(JF, fn)(*args))
    out = getattr(TF, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args)).numpy()
    assert out.shape == ref.shape
    assert out.shape[1:3] == ((k + l, w) if fn == "prepend_virtual_nodes"
                              else (k + l, k + l))
    _close(out, ref, 1e-6)


# ------------------------------------------------------ the EGT-Large shape

def large_cfg(**kw):
    """EGT-Large's recipe at a small width and depth."""
    return small_cfg(model_width=32, edge_width=8, num_heads=4,
                     model_height=2, ffn_multiplier=1.0, num_virtual_nodes=4,
                     scale_degree=True, upto_hop=1,
                     node_vocab_sizes=OGB_ATOM_DIMS,
                     edge_vocab_sizes=OGB_BOND_DIMS, **kw)


@pytest.fixture(scope="module")
def large():
    """JAX's outputs, MAE loss and gradients of the EGT-Large-shaped model
    on a synthetic PCQM batch (pad 16), in training mode, draws off."""
    jcfg = large_cfg()
    params = jax_params(jcfg, seed=3)
    batch = synthetic.pcqm_batch(np.random.default_rng(4), 4, max_nodes=14)
    batch["sample_mask"][-1] = 0.0
    model = JModel(jcfg)

    def loss_fn(p):
        out, _ = model.apply(p, batch, training=True,
                             rng=jax.random.PRNGKey(0))
        s, c = jm.mae_loss(out, batch["target"], None, batch["sample_mask"])
        return s / jnp.maximum(c, 1.0), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return jcfg, params, batch, float(loss), np.asarray(out), \
        jckpt._flatten_params(grads)


@pytest.mark.parametrize("path", ["plain", "attention_kernel"])
def test_large_shaped_model_matches_jax(large, path):
    jcfg, params, batch, loss_j, out_j, grads_j = large
    assert batch["node_features"].shape == (4, 16, 9)
    assert batch["feature_matrix"].shape == (4, 16, 16, 3)
    model = port_model(dataclasses.replace(
        jcfg, fused_attention=path == "attention_kernel"),
        jckpt._flatten_params(params))
    out = model(batch, training=True, seeds=[1, 2])
    _close(out.detach().numpy(), out_j)
    loss_fn = schemes.loss_fn({"scheme": "pcqm4mv2.base"})
    loss, _ = loss_fn(out, torch.from_numpy(batch["target"]), None,
                      torch.from_numpy(batch["sample_mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    named = weights.flat_names(model)
    assert sorted(named) == sorted(grads_j)
    for name, p in named.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        _close(g, grads_j[name])
    # the graph is read from the virtual nodes' rows, whose embeddings and
    # edge blocks learn
    assert named["mlp_out/dense/0/kernel"].shape[0] == 4 * 32
    for name in ("virtual_node_embeddings", "virtual_edge_embeddings",
                 "node_emb/table", "fm_emb/table"):
        assert float(named[name].grad.abs().max()) > 0, name


def test_vn_rows_of_the_degree_scaler_are_pinned():
    """The virtual rows' degree scalers are 1 on the plain core and around
    the attention kernel: those rows equal the unscaled core's, the graph's
    rows do not."""
    from egt_torch.models.egt import egt_attention_core
    from egt_torch.ops.egt_attention import egt_attention_fused
    rng = np.random.default_rng(5)
    b, l, d, h, k = 2, 7, 4, 3, 2
    q, kk, v = (torch.from_numpy(rng.normal(size=(b, l, d, h)).astype(
        np.float32)) for _ in range(3))
    e, g = (torch.from_numpy(rng.normal(size=(b, l, l, h)).astype(
        np.float32)) for _ in range(2))
    kw = dict(scale_degree=True, num_virtual_nodes=k)
    plain = egt_attention_core(q, kk, v, e, g, **kw).v_att
    hm = [t.permute(0, 3, 1, 2) for t in (q, kk, v)]
    fused = egt_attention_fused(*hm, e.permute(0, 3, 1, 2),
                                g.permute(0, 3, 1, 2), **kw).v_att
    _close(fused.numpy(), plain.numpy(), 1e-6)
    unscaled = egt_attention_core(q, kk, v, e, g).v_att
    _close(plain[:, :k].numpy(), unscaled[:, :k].numpy(), 1e-6)
    assert not np.allclose(plain[:, k:].numpy(), unscaled[:, k:].numpy())


def _vn_cases():
    """(config, batch, scheme, JAX scheme loss, output check) a case."""
    def xent(out, batch, model):
        s, c = jm.sparse_xent_loss(out, batch["target"],
                                   model.output_mask(batch),
                                   batch["sample_mask"])
        return s / jnp.maximum(c, 1.0)

    def close_valid_nodes(batch):
        valid = batch["node_features"] >= 0
        return lambda out, ref: _close(out[valid], ref[valid])

    pattern = sbm_batch("pattern", 7)
    zinc = random_zinc_batch(np.random.default_rng(8), b=4, l=12)
    return {
        "sbm_node": (sbm_cfg("pattern", num_virtual_nodes=2,
                             attention_impl="einsum"),
                     pattern, "pattern.svd", _class_xent([979220, 209900]),
                     close_valid_nodes(pattern)),
        "tsp_edge": (tsp_cfg(num_virtual_nodes=2, attention_impl="einsum"),
                     tsp_batch(9, l=16), "tsp.svd", xent, _close),
        "tsp_pairwise_cat": (tsp_cfg(num_virtual_nodes=2,
                                     edge_channel_type="bias",
                                     use_node_embeddings=True,
                                     attention_impl="einsum"),
                             tsp_batch(10, l=16), "tsp.svd", xent, _close),
        "zinc_constrained_distance": (
            small_cfg(num_virtual_nodes=2, edge_channel_type="constrained",
                      distance_loss=0.1, distance_target=3,
                      attention_impl="einsum"),
            zinc, "zinc.svd", _mae, _close),
    }


@pytest.mark.parametrize("case", ["sbm_node", "tsp_edge", "tsp_pairwise_cat",
                                  "zinc_constrained_distance"])
def test_virtual_nodes_with_every_readout_match_jax(case):
    jcfg, batch, scheme, loss, check = _vn_cases()[case]
    model = _check_loss_and_grads(jcfg, batch, scheme, loss, check)
    named = weights.flat_names(model)
    assert float(named["virtual_node_embeddings"].grad.abs().max()) > 0
    if "virtual_edge_embeddings" in named:
        assert float(named["virtual_edge_embeddings"].grad.abs().max()) > 0


# ---------------------------------------------------------------- the scheme

@pytest.mark.parametrize("pe", ["base", "svd"])
def test_pcqm_config_resolution_matches_jax(pe):
    raw = {**json.loads(EGT_LARGE.read_text()), "scheme": f"pcqm4mv2.{pe}"}
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
    port = schemes.model_config_from_config(raw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.num_virtual_nodes, port.scale_degree, port.use_svd) == \
        (4, True, pe == "svd")
    assert timport(raw["scheme"])(raw, device="cpu").config.resolved() \
        == c.resolved()


SHIPPED = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "configs").rglob("*.json"))


@pytest.mark.parametrize("path", SHIPPED)
def test_every_shipped_config_builds(path):
    """Each of the shipped configs resolves and builds on the CPU at its
    own widths (one layer of its depth; no forward pass)."""
    cfg = schemes.model_config_from_config(str(REPO / path))
    model = TModel(dataclasses.replace(cfg, model_height=1), device="cpu")
    layer = model.stack["layers"][0]
    assert layer["dense_qkv"]["kernel"].shape == (cfg.model_width,
                                                   3 * cfg.model_width)
    assert model.target["kernel"].shape[1] == cfg.num_targets


def test_pcqm_records_follow_the_tools_generator():
    """The port's copy of `tools/synth_pcqm.py`: the same graphs, columns
    and targets from the same seed."""
    recs = synthetic.pcqm_records(np.random.default_rng(11), 6)
    rng = np.random.default_rng(11)
    trng = np.random.default_rng(54321)
    T = trng.normal(0, 0.5, size=(synth_pcqm.ATOM_HEAD, synth_pcqm.ATOM_HEAD))
    T = (T + T.T) / 2.0
    B = trng.normal(0, 0.5, size=(OGB_BOND_DIMS[0],))
    for r in recs:
        n, edges, deg = synth_molecular._molecular_graph(rng, n_min=4,
                                                         n_max=32)
        assert r["num_nodes"] == n and np.array_equal(r["edges"], edges)
        z = r["node_features"][:, 0]
        assert np.array_equal(z, (deg * 5 + rng.integers(0, 9, size=n))
                              % synth_pcqm.ATOM_HEAD)
        for ci in (1, 2, 4, 5, 6, 7, 8):
            assert np.array_equal(r["node_features"][:, ci],
                                  rng.integers(0, OGB_ATOM_DIMS[ci], size=n))
        ne2 = len(edges) // 2
        bond = rng.integers(0, OGB_BOND_DIMS[0], size=ne2)
        for ci in (1, 2):
            rng.integers(0, OGB_BOND_DIMS[ci], size=ne2)
        assert np.array_equal(r["edge_features"][:ne2, 0], bond)
        np.testing.assert_allclose(
            r["value"][0], synth_pcqm._target(n, edges[:ne2], z, bond, T, B),
            rtol=1e-6)
        assert (r["node_features"].max(0) < np.asarray(OGB_ATOM_DIMS)).all()
        assert (r["edge_features"].max(0) < np.asarray(OGB_BOND_DIMS)).all()


def test_pcqm_cli_triple_on_cpu(tmp_path):
    rng = np.random.default_rng(12)
    path = tmp_path / "pcqm.h5"
    for split in ("training", "validation", "test"):
        hdf5_io.write_records(str(path), "PCQM4MV2", split,
                              synthetic.pcqm_records(rng, 16, max_nodes=14))
    cfg = {"scheme": "pcqm4mv2.base", "model_name": "pq",
           "dataset_path": str(path), "cache_dir": str(tmp_path / "cache"),
           "save_path": str(tmp_path / "run"), "batch_size": 8,
           "grad_accum_steps": 2, "num_epochs": 1, "model_width": 16,
           "edge_width": 8, "num_heads": 4, "model_height": 2,
           "num_virtual_nodes": 2, "attn_dropout": 0.3,
           "compute_dtype": "float32", "weight_file": "",
           "log_tensorboard": False, "warmup_steps": 2, "total_steps": 100}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    s = run_training.main([str(cfg_path), "--device", "cpu"])
    # 16 records: one optimizer step of 2 microbatches of 8; pad 16
    assert s.state["global_step"] == 1 and s.pad_len == 16
    rec = json.loads((tmp_path / "run" / "logs" / "metrics.jsonl")
                     .read_text().splitlines()[0])
    assert all(np.isfinite(rec[k]) for k in ("loss", "mae", "val_mae"))
    do_evaluations.main([str(cfg_path), "--device", "cpu"])
    text = (tmp_path / "run" / "predictions" / "testset_evals.txt").read_text()
    assert text.startswith("test MAE = ")
    end_training.main([str(cfg_path), "--device", "cpu"])
    flat = dict(np.load(tmp_path / "run" / "saved" / "pq.npz"))
    assert flat["virtual_node_embeddings"].shape == (2, 16)
    assert flat["node_emb/table"].shape == (sum(OGB_ATOM_DIMS) + 1, 16)
