"""The port's whole-layer wrapper (its plain version on CPU tensors) against
the JAX package's `fused_layer_apply` (the Pallas kernel in interpret mode).

Same numpy inputs and weights on both sides, b 3, l 12, width 16, ew 8, h 4.
f32: atol = rtol = 1e-5. bf16: 0.1, the tolerance the JAX package's own bf16
test of the kernel uses (tests/test_fused_layer.py::test_fused_layer_bf16):
both sides round at the same points, but one bf16 ulp of an intermediate near
|x| ~ 8 is 0.03 and the two frameworks sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops import fused_layer as tfl
from egt_tpu.models.graph_model import GraphModelConfig as JCfg
from egt_tpu.ops import fused_layer_pallas as jfl

BASE = dict(model_width=16, edge_width=8, num_heads=4, model_height=2,
            node_input_kind="tokens", edge_input_kind="tokens",
            num_node_features=28, num_edge_features=4,
            readout_kind="graph", num_targets=1)


def make_params(rng, ew, h, hidden, gated):
    def dense(i, o):
        return {"kernel": rng.uniform(-0.5, 0.5, (i, o)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    def ln(dim):
        return {"gamma": (1 + 0.1 * rng.normal(size=dim)).astype(np.float32),
                "beta": (0.1 * rng.normal(size=dim)).astype(np.float32)}

    p = {"dense_edge_b": dense(ew, h), "norm_edge": ln(ew),
         "dense_edge_r": dense(h, ew),
         "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, hidden),
                      "lr2": dense(hidden, ew)}}
    if gated:
        p["attention_gates"] = dense(ew, h)
    return p


def tree(p, fn):
    return {k: tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def make_case(seed, kw, b=3, l=12):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = JCfg(**BASE, **kw), TCfg(**BASE, **kw)
    ew, w, h = jcfg.edge_width, jcfg.model_width, jcfg.num_heads
    p = make_params(rng, ew, h, round(ew * jcfg.ffn_multiplier),
                    jcfg.gate_attention)
    e = rng.normal(size=(b, l, l, ew)).astype(np.float32)
    qkv = rng.normal(size=(b, l, 3 * w)).astype(np.float32)
    n = rng.integers(3, l + 1, size=b)
    mask = (np.arange(l)[None, :] < n[:, None]).astype(np.float32)
    am = (rng.random((b, l, l)) > 0.4).astype(np.float32)
    return jcfg, tcfg, p, e, qkv, mask, am


VARIANTS = {
    "residual_gated": dict(),
    "residual_ungated": dict(gate_attention=False),
    "constrained_gated": dict(edge_channel_type="constrained"),
    "constrained_ungated": dict(edge_channel_type="constrained",
                                gate_attention=False),
}


def _run_pair(kw, dtype):
    jcfg, tcfg, p, e, qkv, mask, am = make_case(3, kw)
    am = am if jcfg.edge_channel_type == "constrained" else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = tree(p, jnp.asarray)
    ref = jfl.fused_layer_apply(jp, jcfg, jnp.asarray(e, jdt),
                                jnp.asarray(qkv, jdt), jnp.asarray(mask),
                                None if am is None else jnp.asarray(am),
                                training=False, rng=None)
    tp = tree(p, torch.from_numpy)
    before = tfl.KERNEL.launches
    out = tfl.fused_layer_apply(tp, tcfg, torch.from_numpy(e).to(dtype),
                                torch.from_numpy(qkv).to(dtype),
                                torch.from_numpy(mask),
                                None if am is None else torch.from_numpy(am))
    assert tfl.KERNEL.launches == before        # CPU tensors: plain version
    return ([o.float().numpy() for o in out],
            [np.asarray(r, np.float32) for r in ref])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fused_layer_matches_jax_f32(name):
    outs, refs = _run_pair(VARIANTS[name], torch.float32)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fused_layer_matches_jax_bf16(name):
    outs, refs = _run_pair(VARIANTS[name], torch.bfloat16)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o, r, rtol=0.1, atol=0.1)


INELIGIBLE = [dict(edge_channel_type="bias"), dict(add_n_norm=True),
              dict(node2edge_xtalk=0.5),
              dict(scale_degree=True, gate_attention=True),
              dict(combine_layer_repr=True)]


# edge dropout is refused only at training time (the kernel has none)
TRAINING = [dict(training=True), dict(edge_dropout=0.1),
            dict(edge_dropout=0.1, training=True)]


@pytest.mark.parametrize("kw", [dict(), dict(fused_layer="auto")] + INELIGIBLE
                         + TRAINING,
                         ids=lambda kw: ",".join(kw) or "eligible")
def test_can_fuse_layer_agrees_with_jax(kw):
    """The structural rule is the JAX one; "auto" is on in the port (the JAX
    "auto" consults TPU measurements, so it is compared as True)."""
    kw = {"fused_layer": True, **kw}
    training = kw.pop("training", False)
    jkw = {**kw, "fused_layer": True}
    port = tfl.can_fuse_layer(TCfg(**BASE, upto_hop=2, **kw), training)
    ref = jfl.can_fuse_layer(JCfg(**BASE, upto_hop=2, **jkw), training, None,
                             False, 12)
    assert port == ref
    eligible = kw in ({"fused_layer": True}, {"fused_layer": "auto"})
    if kw == {"fused_layer": True, "edge_dropout": 0.1}:
        eligible = not training
    assert port == eligible
