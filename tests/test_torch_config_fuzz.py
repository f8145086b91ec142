"""Configs drawn by the JAX package's config fuzz (`tests/test_config_fuzz.py
::sample_cfg`, the same seeds as its first cases) build in the port and
match JAX on the CPU: the outputs, the loss (mean squared output plus
the model's auxiliary losses) and every parameter's gradient within 1e-4,
and every BatchNorm moving-statistics update within 1e-5, in training mode.
Each config runs in f32 with the draws off (random mask, dropout, the PE's
sign flips): the two packages draw other bits, and bf16 is no 1e-4
comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch import weights
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.models.graph_model import unsupported
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.models.graph_model import GraphModelConfig as JCfg
from egt_tpu.training import checkpoint as jckpt
from tests.test_config_fuzz import sample_cfg
from tests.test_model_forward import random_zinc_batch
from tests.test_torch_model import jax_params, port_model

N_CASES = 8
NO_DRAWS = dict(random_mask_prob=0.0, attn_dropout=0.0, node_dropout=0.0,
                edge_dropout=0.0, random_neg=False, compute_dtype="float32")


@pytest.mark.parametrize("case", range(N_CASES))
def test_fuzzed_config_matches_jax(case):
    rng = np.random.default_rng(1234 + case)
    kw = sample_cfg(rng)
    assert unsupported(TCfg(**kw)) == []
    jcfg = JCfg(**{**kw, **NO_DRAWS})
    params = jax_params(jcfg, seed=case)
    batch = random_zinc_batch(rng, b=3, l=10,
                              pe="svd" if jcfg.use_svd else None, k=8)
    model_j = JModel(jcfg)

    def loss_fn(p):
        out, ctx = model_j.apply(p, batch, training=True)
        total = jnp.mean(out ** 2) + sum(ctx.losses.values())
        return total, (out, ctx.stats_updates)

    (loss_j, (out_j, upd_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = port_model(jcfg, jckpt._flatten_params(params))
    out, ctx = model(batch, training=True,
                     seeds=list(range(jcfg.model_height)), with_context=True)
    loss = torch.mean(out ** 2) + sum(ctx.losses.values())
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4, err_msg=str(kw))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    assert sorted(ctx.stats_updates) == sorted(upd_j)
    for path, upd in upd_j.items():
        for name, v in upd.items():
            np.testing.assert_allclose(ctx.stats_updates[path][name].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{path} {name}")
    flat_j = jckpt._flatten_params(grads_j)
    for k, p in weights.flat_names(model).items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, flat_j[k], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{k} {kw}")


def test_sampled_configs_cover_the_variants():
    """The drawn configs reach the variants this file is for."""
    cfgs = [sample_cfg(np.random.default_rng(1234 + c))
            for c in range(N_CASES)]
    assert any(c["node_normalization"] == "batch" for c in cfgs)
    assert any(c.get("node2edge_xtalk", 0) > 0 for c in cfgs)
    assert any(c["remat"] for c in cfgs)
    assert any(c["max_degree_enc"] or c["max_diffuse_t"]
               or c["node2edge_embed"] or c["include_xpose"] for c in cfgs)
