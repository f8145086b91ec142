"""The port's whole-layer backward (`FusedLayerFn`: the plain versions of K3
with h_hat saved, K4 and K5, on CPU tensors) against `jax.grad` of the JAX
package's `fused_layer_apply(training=True)` (its split backward, the Pallas
kernels in interpret mode), with the random draws off: the two packages'
random bits differ by design.

Same numpy inputs, weights and output cotangents on both sides; b 3, l 12,
width 16, ew 8, h 4; qkv scaled so that the logit clip is active on some
pairs. Gradients of e, qkv and every weight: f32 at atol = rtol = 2e-4 (the
tolerance of the JAX package's own gradient test of the kernel,
tests/test_fused_layer.py::test_fused_layer_grads); bf16 at 0.1, as the
forward test (both sides round at the same points, but a sum taken in another
order can flip one bf16 rounding of an intermediate). The explicit plain
backward is also held against torch autograd of the plain forward (f32 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.ops import fused_layer as tfl
from egt_tpu.ops import fused_layer_pallas as jfl
from tests.test_torch_fused_layer import VARIANTS, make_case, tree

QKV_SCALE = 2.5          # |q.k| * d^-1/2 beyond the clip of 5 on some pairs


def _case(name):
    jcfg, tcfg, p, e, qkv, mask, am = make_case(4, VARIANTS[name])
    am = am if jcfg.edge_channel_type == "constrained" else None
    rng = np.random.default_rng(11)
    ge = rng.normal(size=e.shape).astype(np.float32)
    gv = rng.normal(size=(e.shape[0], e.shape[1], jcfg.model_width)
                    ).astype(np.float32)
    return jcfg, tcfg, p, e, QKV_SCALE * qkv, mask, am, ge, gv


def _jax_grads(jcfg, p, e, qkv, mask, am, ge, gv, jdt):
    def loss(p_, e_, qkv_):
        eo, vo = jfl.fused_layer_apply(
            p_, jcfg, e_, qkv_, jnp.asarray(mask),
            None if am is None else jnp.asarray(am),
            training=True, rng=jax.random.PRNGKey(0))
        return (jnp.sum(eo.astype(jnp.float32) * ge)
                + jnp.sum(vo.astype(jnp.float32) * gv))

    gp, g_e, g_qkv = jax.grad(loss, argnums=(0, 1, 2))(
        tree(p, jnp.asarray), jnp.asarray(e, jdt), jnp.asarray(qkv, jdt))
    return gp, g_e, g_qkv


def _port_grads(tcfg, p, e, qkv, mask, am, ge, gv, dt):
    tp = tree(p, lambda x: torch.from_numpy(x).requires_grad_())
    te = torch.from_numpy(e).requires_grad_()
    tq = torch.from_numpy(qkv).requires_grad_()
    before = (tfl.KERNEL.launches, tfl.BWD_TAIL_KERNEL.launches,
              tfl.BWD_ATTN_KERNEL.launches)
    eo, vo = tfl.fused_layer_apply(
        tp, tcfg, te.to(dt), tq.to(dt), torch.from_numpy(mask),
        None if am is None else torch.from_numpy(am), training=True, seed=0)
    loss = (eo.float() * torch.from_numpy(ge)).sum() + \
        (vo.float() * torch.from_numpy(gv)).sum()
    loss.backward()
    assert (tfl.KERNEL.launches, tfl.BWD_TAIL_KERNEL.launches,
            tfl.BWD_ATTN_KERNEL.launches) == before     # CPU: plain versions
    return tree(tp, lambda x: x.grad), te.grad, tq.grad


def _flat(g, prefix=""):
    out = {}
    for k, v in g.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _compare(name, dt, tol):
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case(name)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    gp_j, ge_j, gq_j = _jax_grads(jcfg, p, e, qkv, mask, am, ge, gv, jdt)
    gp_t, ge_t, gq_t = _port_grads(tcfg, p, e, qkv, mask, am, ge, gv, dt)
    np.testing.assert_allclose(ge_t.numpy(), np.asarray(ge_j, np.float32),
                               rtol=tol, atol=tol, err_msg="de")
    np.testing.assert_allclose(gq_t.numpy(), np.asarray(gq_j, np.float32),
                               rtol=tol, atol=tol, err_msg="dqkv")
    fj, ft = _flat(gp_j), _flat(tree(gp_t, lambda x: x.numpy()))
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fused_layer_grads_match_jax_f32(name):
    _compare(name, torch.float32, 2e-4)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fused_layer_grads_match_jax_bf16(name):
    _compare(name, torch.bfloat16, 0.1)


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("name", ["residual_gated", "constrained_ungated"])
def test_plain_backward_matches_autograd(name, draws):
    """K4 + K5 plain versions = torch autograd of the K3 plain version, with
    and without the training draws (the same Philox bits on both sides)."""
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
    with torch.no_grad():
        de_mid, dhh, dw = tfl.fused_layer_bwd_tail_plain(
            spec, te, hh, torch.from_numpy(ge), w)
        de, dq, dk, dv, dw_head = tfl.fused_layer_bwd_attn_plain(
            spec, te, tq, mask_t, am_t, w, hh, dhh, de_mid,
            torch.from_numpy(gv), seed=5)
    dw.update(dw_head)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(de, te.grad, **tol)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(tq.shape)
    torch.testing.assert_close(dqkv, tq.grad, **tol)
    for k, x in w.items():
        if x is not None:
            torch.testing.assert_close(dw[k], x.grad, **tol, msg=k)
