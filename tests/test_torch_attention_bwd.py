"""The port's attention-core backward (`EGTCoreFn`: the plain versions of K1
and K2 on CPU tensors) against `jax.grad` of the JAX package's
`egt_attention_fused` (its custom VJP, the Pallas kernels in interpret mode),
training mode with the random draws off.

Same numpy inputs and output cotangents on both sides (the cotangents of
v_att and of h_hat, as dense_edge_r gives them). Cases: gated with the
degree scaler (so the degree cotangent is live), ungated with a hard mask,
and a rectangular row block (lq < lk). Inputs are scaled so that the logit
clip is active on some pairs. f32, atol = rtol = 1e-4. The explicit plain
backward is also held against torch autograd of the plain forward, with and
without the draws (f32 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.ops import egt_attention as tatt
from egt_tpu.ops import egt_pallas as jpl
from tests.test_torch_attention import _j, _t, make_inputs

CASES = {
    "gated_degree": dict(scale_degree=True),
    "ungated_hard_mask": dict(gated=False, hard=True),
    "rect_rows": dict(lq=5, hard=True),
}
QK_SCALE = 3.0           # |q.k| * d^-1/2 beyond the clip of 5 on some pairs


def _inputs(case):
    q, k, v, e, g, mask, am = make_inputs(
        9, lq=case.get("lq"), gated=case.get("gated", True),
        hard=case.get("hard", False))
    rng = np.random.default_rng(13)
    gvo = rng.normal(size=(q.shape[0], q.shape[2], q.shape[1] * q.shape[3])
                     ).astype(np.float32)
    gho = rng.normal(size=e.shape).astype(np.float32)
    return QK_SCALE * q, QK_SCALE * k, v, e, g, mask, am, gvo, gho


@pytest.mark.parametrize("name", list(CASES))
def test_attention_grads_match_jax(name):
    case = CASES[name]
    q, k, v, e, g, mask, am, gvo, gho = _inputs(case)
    kw = dict(clip_logits_value=(-5.0, 5.0),
              scale_degree=case.get("scale_degree", False), training=True)
    gated = g is not None

    def jloss(*xs):
        out = jpl.egt_attention_fused(
            *xs[:4], xs[4] if gated else None, node_mask=_j(mask),
            attn_mask_hm=_j(am), rng=jax.random.PRNGKey(0), **kw)
        return jnp.sum(out.v_att * gvo) + jnp.sum(out.h_hat * gho)

    args = [q, k, v, e] + ([g] if gated else [])
    ref = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(_j, args))

    ts = [_t(x).requires_grad_() for x in args]
    before = (tatt.KERNEL.launches, tatt.BWD_KERNEL.launches)
    out = tatt.egt_attention_fused(
        *ts[:4], ts[4] if gated else None, node_mask=_t(mask),
        attn_mask_hm=_t(am), seed=0, **kw)
    ((out.v_att * _t(gvo)).sum() + (out.h_hat * _t(gho)).sum()).backward()
    assert (tatt.KERNEL.launches, tatt.BWD_KERNEL.launches) == before
    for name_, t, r in zip("qkveg", ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name_}")


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
def test_plain_backward_matches_autograd(draws):
    """K2's plain version = torch autograd of K1's plain version (the same
    Philox bits on both sides with the draws live), all three cotangents."""
    q, k, v, e, g, mask, am, gvo, gho = _inputs(dict(hard=True))
    d = tatt.Draws(7, 0.2, 0.15) if draws else tatt.OFF
    madd = (_t(mask).float() - 1.0) * 1e9
    maddf = (_t(am) - 1.0) * 1e9
    ts = [_t(x).requires_grad_() for x in (q, k, v, e, g)]
    v_att, h_hat, deg = tatt.egt_core_fwd_plain(*ts, madd, maddf, (-5.0, 5.0),
                                                d)
    gv = torch.from_numpy(np.random.default_rng(2).normal(
        size=v_att.shape).astype(np.float32))
    gdeg = torch.from_numpy(np.random.default_rng(3).normal(
        size=deg.shape).astype(np.float32))
    ((v_att * gv).sum() + (h_hat * _t(gho)).sum()
     + (deg * gdeg).sum()).backward()
    with torch.no_grad():
        dq, dk, dv, de, dg = tatt.egt_core_bwd_plain(
            ts[0], ts[1], ts[2], ts[4], madd, maddf, h_hat, gv, _t(gho), gdeg,
            (-5.0, 5.0), d)
    for got, t in zip((dq, dk, dv, de, dg), ts):
        torch.testing.assert_close(got, t.grad, rtol=1e-5, atol=1e-5)
