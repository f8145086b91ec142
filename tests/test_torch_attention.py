"""The port's EGT attention (plain op and kernel wrapper) against the JAX
package on the CPU.

`egt_torch.models.egt.egt_attention_core` is held against
`egt_tpu.models.egt.egt_attention_core`, and the attention-kernel wrapper
`egt_torch.ops.egt_attention.egt_attention_fused` (its plain version on CPU
tensors) against `egt_tpu.ops.egt_pallas.egt_attention_fused` (the Pallas
kernel in interpret mode). Same numpy inputs on both sides; f32; atol = rtol
= 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.models import egt as tegt
from egt_torch.ops import egt_attention as tatt
from egt_tpu.models import egt as jegt
from egt_tpu.ops import egt_pallas as jpl

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "gated": dict(),
    "ungated": dict(gated=False),
    "hard_mask": dict(hard=True),
    "degree_log_vn": dict(scale_degree=True, vn=2),
    "degree_linear": dict(scale_degree=True, scaler="linear"),
    "rect_rows": dict(lq=5, hard=True),
    "no_clip": dict(clip=None),
}


def make_inputs(seed, b=3, lk=12, d=4, h=4, lq=None, gated=True, hard=False):
    rng = np.random.default_rng(seed)
    lq = lk if lq is None else lq
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    e = rng.normal(size=(b, h, lq, lk)).astype(np.float32)
    g = rng.normal(size=(b, h, lq, lk)).astype(np.float32) if gated else None
    n = rng.integers(3, lk + 1, size=b)
    mask = np.arange(lk)[None, :] < n[:, None]
    am = (rng.random((b, lq, lk)) < 0.6).astype(np.float32) if hard else None
    return q, k, v, e, g, mask, am


def _kw(case):
    return dict(
        clip_logits_value=case.get("clip", (-5.0, 5.0)),
        scale_degree=case.get("scale_degree", False),
        scaler_type=case.get("scaler", "log"),
        num_virtual_nodes=case.get("vn", 0))


def _inputs(case):
    return make_inputs(7, lq=case.get("lq"), gated=case.get("gated", True),
                       hard=case.get("hard", False))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bldh(x):
    """head-major (b, h, l, d) / (b, h, lq, lk) -> (b, l, d, h) / (b, lq, lk, h)"""
    return None if x is None else np.ascontiguousarray(
        np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("name", list(CASES))
def test_attention_core_matches_jax(name):
    case = CASES[name]
    q, k, v, e, g, mask, am = _inputs(case)
    q, k, v, e, g = (_bldh(x) for x in (q, k, v, e, g))
    am4 = None if am is None else np.repeat(am[..., None], q.shape[-1], -1)
    kw = _kw(case)
    ref = jegt.egt_attention_core(*map(_j, (q, k, v, e, g)),
                                  node_mask=_j(mask), attn_mask=_j(am4), **kw)
    out = tegt.egt_attention_core(*map(_t, (q, k, v, e, g)),
                                  node_mask=_t(mask), attn_mask=_t(am4), **kw)
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_attention_wrapper_matches_jax_kernel(name):
    case = CASES[name]
    q, k, v, e, g, mask, am = _inputs(case)
    kw = _kw(case)
    ref = jpl.egt_attention_fused(*map(_j, (q, k, v, e, g)),
                                  node_mask=_j(mask), attn_mask_hm=_j(am), **kw)
    before = tatt.KERNEL.launches
    out = tatt.egt_attention_fused(*map(_t, (q, k, v, e, g)),
                                   node_mask=_t(mask), attn_mask_hm=_t(am),
                                   **kw)
    assert tatt.KERNEL.launches == before      # CPU tensors: plain version
    np.testing.assert_allclose(out.v_att.numpy(), np.asarray(ref.v_att), **TOL)
    np.testing.assert_allclose(out.h_hat.numpy(), np.asarray(ref.h_hat), **TOL)
    assert (out.degrees is None) == (g is None)


def test_stochastic_attention_not_ported():
    """The training draws are ported: like JAX without an rng, they raise
    without a seed; with one, both ops draw the same bits (ops/rng.py), so
    the kernel wrapper and the plain op agree with the draws live."""
    q, k, v, e, g, mask, _ = make_inputs(0)
    with pytest.raises(ValueError):
        tatt.egt_attention_fused(*map(_t, (q, k, v, e, g)), training=True,
                                 random_mask_prob=0.1)
    hm = [_t(_bldh(x)) for x in (q, k, v, e, g)]
    with pytest.raises(ValueError):
        tegt.egt_attention_core(*hm, training=True, attn_dropout=0.1)
    kw = dict(training=True, random_mask_prob=0.2, attn_dropout=0.1, seed=3)
    fused = tatt.egt_attention_fused(*map(_t, (q, k, v, e, g)),
                                     node_mask=_t(mask), **kw)
    plain = tegt.egt_attention_core(*hm, node_mask=_t(mask), **kw)
    np.testing.assert_allclose(fused.v_att.numpy(), plain.v_att.numpy(), **TOL)
    off = tegt.egt_attention_core(*hm, node_mask=_t(mask))
    assert not np.allclose(plain.v_att.numpy(), off.v_att.numpy())
