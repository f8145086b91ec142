"""The port's merged and mono whole-layer backwards (`FusedLayerFn` with
`BWD_IMPL` "merged" and "mono": the plain versions of K7 and K6 on CPU
tensors) against `jax.grad` of the JAX package's
`fused_layer_apply(training=True)` with `_BWD_IMPL` set to the same value
(its `_bwd_merged_kernel` and `_bwd_kernel` in interpret mode), with the
random draws off.

Inputs, cases and tolerances are those of `test_torch_fused_layer_bwd.py`
(the split backward): f32 atol = rtol = 2e-4, bf16 0.1. Both sides are shown
to take the backward under test: the JAX caches are cleared before each
case (a trace cached under another `_BWD_IMPL` would silently run that
backward) and the calls are counted. The explicit plain backwards are also
held against torch autograd of the plain forward (f32 1e-5), with and
without the training draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.ops import fused_layer as tfl
from egt_tpu.ops import fused_layer_pallas as jfl
from tests.test_torch_fused_layer import VARIANTS, tree
from tests.test_torch_fused_layer_bwd import (_case, _flat, _jax_grads,
                                              _port_grads)

# the JAX backward call and the port's public backward of each impl
CALLS = {"merged": ("_fused_layer_bwd_call_merged", "fused_layer_bwd_merged"),
         "mono": ("_fused_layer_bwd_call", "fused_layer_bwd_mono")}


def _counted(monkeypatch, module, name, counts, key):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


# bf16 at the ZINC-100k widths is left to the card's checks, as in
# test_torch_fused_layer_bwd.py: weight gradients reach ~100 there
CASES = [pytest.param(n, dt, tol, id=f"{n}-{tag}") for n in VARIANTS
         for dt, tol, tag in ((torch.float32, 2e-4, "f32"),
                              (torch.bfloat16, 0.1, "bf16"))
         if not (tag == "bf16" and "ew48" in n)]


@pytest.mark.parametrize("impl", list(CALLS))
@pytest.mark.parametrize("name,dt,tol", CASES)
def test_alt_backward_matches_jax(name, dt, tol, impl, monkeypatch):
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case(name)
    monkeypatch.setattr(jfl, "_BWD_IMPL", impl)
    monkeypatch.setattr(tfl, "BWD_IMPL", impl)
    counts = {"jax": 0, "port": 0}
    _counted(monkeypatch, jfl, CALLS[impl][0], counts, "jax")
    _counted(monkeypatch, tfl, CALLS[impl][1], counts, "port")
    jax.clear_caches()
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    gp_j, ge_j, gq_j = _jax_grads(jcfg, p, e, qkv, mask, am, ge, gv, jdt)
    gp_t, ge_t, gq_t = _port_grads(tcfg, p, e, qkv, mask, am, ge, gv, dt)
    jax.clear_caches()
    assert counts == {"jax": 1, "port": 1}
    np.testing.assert_allclose(ge_t.numpy(), np.asarray(ge_j, np.float32),
                               rtol=tol, atol=tol, err_msg="de")
    np.testing.assert_allclose(gq_t.numpy(), np.asarray(gq_j, np.float32),
                               rtol=tol, atol=tol, err_msg="dqkv")
    fj, ft = _flat(gp_j), _flat(tree(gp_t, lambda x: x.numpy()))
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("name", ["residual_gated", "constrained_ungated"])
@pytest.mark.parametrize("impl", list(CALLS))
def test_alt_plain_backward_matches_autograd(impl, name, draws):
    """K7 and K6 plain versions = torch autograd of the K3 plain version,
    with and without the training draws (the same Philox bits)."""
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case(name)
    if draws:
        tcfg.random_mask_prob, tcfg.attn_dropout = 0.2, 0.15
    spec = tfl.make_spec(tcfg, e.shape[1], training=True)
    tp = tree(p, torch.from_numpy)
    mask_t = torch.from_numpy(mask)
    am_t = None if am is None else torch.from_numpy(am)
    w = {k: (None if x is None else x.clone().requires_grad_())
         for k, x in tfl.layer_weights(tp, torch.float32).items()}
    te = torch.from_numpy(e).requires_grad_()
    tq = torch.from_numpy(qkv).requires_grad_()
    eo, vo, hh = tfl.fused_layer_plain(spec, te, tq, mask_t, am_t, w, seed=5,
                                       save_hh=True)
    ((eo * torch.from_numpy(ge)).sum()
     + (vo * torch.from_numpy(gv)).sum()).backward()
    g = (torch.from_numpy(ge), torch.from_numpy(gv))
    with torch.no_grad():
        if impl == "merged":
            de, dq, dk, dv, dw = tfl.fused_layer_bwd_merged_plain(
                spec, te, tq, mask_t, am_t, w, hh, *g, seed=5)
        else:
            de, dq, dk, dv, dw = tfl.fused_layer_bwd_mono_plain(
                spec, te, tq, mask_t, am_t, w, *g, seed=5)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(de, te.grad, **tol)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(tq.shape)
    torch.testing.assert_close(dqkv, tq.grad, **tol)
    for k, x in w.items():
        if x is not None:
            torch.testing.assert_close(dw[k], x.grad, **tol, msg=k)


def test_unknown_backward_raises(monkeypatch):
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case("residual_gated")
    monkeypatch.setattr(tfl, "BWD_IMPL", "fused")
    with pytest.raises(ValueError):
        _port_grads(tcfg, p, e, qkv, mask, am, ge, gv, torch.float32)


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("name", ["residual_gated", "constrained_ungated"])
def test_merged_plain_f32_equals_split_plain(name, draws):
    """In f32 the merged backward's hand-off (de_mid and dhh in f32) is the
    split's own: K7's plain version equals K4's then K5's bit for bit, as
    K7 equals K4 then K5 on the card."""
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case(name)
    if draws:
        tcfg.random_mask_prob, tcfg.attn_dropout = 0.2, 0.15
    spec = tfl.make_spec(tcfg, e.shape[1], training=True)
    w = tfl.layer_weights(tree(p, torch.from_numpy), torch.float32)
    te, tq = torch.from_numpy(e), torch.from_numpy(qkv)
    mask_t = torch.from_numpy(mask)
    am_t = None if am is None else torch.from_numpy(am)
    hh = tfl.fused_layer_plain(spec, te, tq, mask_t, am_t, w, seed=5,
                               save_hh=True)[2]
    g_e, g_v = torch.from_numpy(ge), torch.from_numpy(gv)
    merged = tfl.fused_layer_bwd_merged(spec, te, tq, mask_t, am_t, w, hh,
                                        g_e, g_v, seed=5)
    de_mid, dhh, dw = tfl.fused_layer_bwd_tail(spec, te, hh, g_e, w)
    *split, dw_head = tfl.fused_layer_bwd_attn(spec, te, tq, mask_t, am_t, w,
                                               hh, dhh, de_mid, g_v, seed=5)
    for a, b in zip(merged[:4], split):
        assert torch.equal(a, b)
    dw.update(dw_head)
    assert sorted(merged[4]) == sorted(dw)
    for k in dw:
        assert torch.equal(merged[4][k], dw[k]), k


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_kernel_weight_gradient_layout(gated):
    """K6's and K7's one f32 row of weight-gradient sums, [the tail's eight
    | the head's four], splits into every weight's gradient at its shape,
    each element once."""
    spec = tfl.LayerSpec(l=5, ew=6, h=2, dh=4, hidden=12, gated=gated,
                         constrained=False, clip=None, edge_act=None,
                         act="elu", scale=0.5)
    n = tfl._tail_len(spec) + tfl._head_len(spec)
    grads = tfl._split_dw(spec, torch.arange(n, dtype=torch.float32))
    shapes = dict(wg=(6, 2), bg=(2,), wb=(6, 2), bb=(2,), g1=(6,), b1=(6,),
                  wr=(2, 6), br=(6,), g2=(6,), b2=(6,), w1=(6, 12),
                  bb1=(12,), w2=(12, 6), bb2=(6,))
    if not gated:
        del shapes["wg"], shapes["bg"]
    assert {k: tuple(v.shape) for k, v in grads.items()} == shapes
    seen = torch.cat([v.reshape(-1) for v in grads.values()])
    assert sorted(seen.tolist()) == list(range(n))
