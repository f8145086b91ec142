"""Rematerialization (`remat`) in the port, the mirror of
`tests/test_precision_remat.py`, on the CPU at a small size (2 layers,
width 16, edge width 8, 4 heads, l 12, b 4), f32:

- `remat` True and "dots" give the outputs and every gradient of the port
  without `remat` within 1e-6, on the plain path and through the plain
  versions of the attention kernel and the whole-layer kernel (whose
  `autograd.Function`s run again in the backward), and JAX's with the same
  `remat` within 1e-4;
- a training step with the draws live (random mask, attention, node and
  edge dropout) gives the loss and every gradient of the step without
  `remat` bit for bit: the draws are keyed by explicit seeds, so the
  recompute draws the same bits;
- the BatchNorm moving statistics are written once a step under `remat`:
  after two steps they equal those without it bit for bit (a second write
  would apply the momentum twice);
- the "dots" policy saves the Dense layers' products and nothing else;
  `remat` is off under analysis capture, as in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from egt_torch import weights
from egt_torch.models import graph_model as tgm
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.training.steps import load_trainer
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params

PATHS = {"plain": dict(attention_impl="einsum"),
         "attention_kernel": dict(fused_attention=True),
         "whole_layer_kernel": dict(fused_layer=True)}
DRAWS = dict(random_mask_prob=0.1, attn_dropout=0.1, dropout=0.1)


def _port(jcfg, flat, **kw):
    model = tgm.EGTGraphModel(TCfg(**{**dataclasses.asdict(jcfg), **kw}),
                              device="cpu")
    return weights.load_flat_params(model, flat)


def _port_loss_grads(model, batch):
    out = model(batch)
    loss = torch.sum(out ** 2)
    loss.backward()
    return out.detach(), {k: p.grad.clone() for k, p in
                          weights.flat_names(model).items()
                          if p.grad is not None}


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_matches_no_remat_and_jax(path):
    jcfg = small_cfg(**PATHS[path])
    params = jax_params(jcfg)
    flat = jckpt._flatten_params(params)
    batch = random_zinc_batch(np.random.default_rng(1))
    out0, g0 = _port_loss_grads(_port(jcfg, flat), batch)
    for mode in (True, "dots"):
        out, g = _port_loss_grads(_port(jcfg, flat, remat=mode), batch)
        np.testing.assert_allclose(out.numpy(), out0.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert sorted(g) == sorted(g0)
        for k in g0:
            np.testing.assert_allclose(g[k].numpy(), g0[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        jm = JModel(dataclasses.replace(jcfg, remat=mode))
        gj = jckpt._flatten_params(jax.jit(jax.grad(
            lambda p: jnp.sum(jm.apply(p, batch)[0] ** 2)))(params))
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), gj[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def _trainer(remat, **kw):
    cfg = {"scheme": "zinc.svd", "use_svd": False, "model_width": 16,
           "edge_width": 8, "model_height": 2, "num_heads": 4,
           "upto_hop": 2, "compute_dtype": "float32", "use_pallas": True,
           "use_pallas_layer": True, "remat": remat, **DRAWS}
    return load_trainer(cfg, device="cpu", **kw)


@pytest.mark.parametrize("mode", [True, "dots"])
def test_training_step_with_draws_is_bit_equal(mode):
    batch = random_zinc_batch(np.random.default_rng(2))
    runs = []
    for remat in (False, mode):
        tr = _trainer(remat)
        loss = tr.train_step(batch)["loss"]
        grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()
                 if p.grad is not None}
        runs.append((loss, grads, tr.train_step(batch)["loss"]))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert l0 == l1 and n0 == n1
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_moving_stats_are_written_once_a_step():
    jcfg = small_cfg(node_normalization="batch", edge_normalization="batch")
    mcfg = TCfg(**dataclasses.asdict(jcfg))
    batch = random_zinc_batch(np.random.default_rng(3))
    stats = []
    for remat in (False, True):
        tr = _trainer(remat, model_config=dataclasses.replace(
            mcfg, remat=remat, random_mask_prob=0.1))
        for _ in range(2):
            tr.train_step(batch)
        stats.append({k: v for k, v in tr.flat_params().items()
                      if "moving_" in k})
    assert len(stats[0]) == 2 * 10
    for k, v in stats[0].items():
        np.testing.assert_array_equal(stats[1][k], v, err_msg=k)


def test_dots_policy_and_capture():
    def op(name):
        return getattr(torch.ops.aten, name).default
    saved = [n for n in ("mm", "addmm", "bmm", "exp", "mul")
             if tgm._dots_policy(None, op(n)) == CheckpointPolicy.MUST_SAVE]
    assert saved == ["mm", "addmm"]
    jcfg = small_cfg(attention_impl="einsum")
    model = _port(jcfg, jckpt._flatten_params(jax_params(jcfg)), remat=True)
    batch = random_zinc_batch(np.random.default_rng(4))
    # capture runs the plain forward once: no checkpoint, the captures kept
    analysis = model.analyze(batch)
    assert sorted(analysis) == sorted(
        f"{k}_{i:02d}/{v}" for i in range(2)
        for k, v in (("mha", "e"), ("mha", "mat"), ("attention_gates",
                                                     "gates"),
                     ("dense_edge_b", "e")))


@pytest.mark.parametrize("mode", [False, True, "dots"])
def test_each_layer_runs_again_in_the_backward(mode):
    jcfg = small_cfg(attention_impl="einsum")
    model = _port(jcfg, jckpt._flatten_params(jax_params(jcfg)), remat=mode)
    calls = []
    # a pre-hook: the recompute stops once the backward's saved tensors are
    # back, before the layer's forward returns
    for i, layer in enumerate(model.stack["layers"]):
        layer.register_forward_pre_hook(lambda *_, i=i: calls.append(i))
    out = model(random_zinc_batch(np.random.default_rng(5)), training=True,
                seeds=[1, 2])
    assert calls == [0, 1]
    out.sum().backward()
    assert sorted(calls) == ([0, 1] if mode is False else [0, 0, 1, 1])
