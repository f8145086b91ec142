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
without the training draws. K6's plain version is also held, bit for bit,
to its parts: its head (`mono_head_plain`) against K3's plain h_hat and the
clip's test on the raw logit, and the whole against the one-piece formula
it had before it was split into the head and K7's math.
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


def _plain_case(name, draws=False, dt=torch.float32):
    """A case's spec (training), inputs and cotangents as torch tensors in
    `dt`, and its weights as the kernels take them."""
    jcfg, tcfg, p, e, qkv, mask, am, ge, gv = _case(name)
    if draws:
        tcfg.random_mask_prob, tcfg.attn_dropout = 0.2, 0.15
    spec = tfl.make_spec(tcfg, e.shape[1], training=True)
    w = tfl.layer_weights(tree(p, torch.from_numpy), dt)
    return (spec, torch.from_numpy(e).to(dt), torch.from_numpy(qkv).to(dt),
            torch.from_numpy(mask),
            None if am is None else torch.from_numpy(am), w,
            torch.from_numpy(ge).to(dt), torch.from_numpy(gv).to(dt))


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("name", ["residual_gated", "constrained_ungated"])
def test_merged_plain_f32_equals_split_plain(name, draws):
    """In f32 the merged backward's hand-off (de_mid and dhh in f32) is the
    split's own: K7's plain version equals K4's then K5's bit for bit, as
    K7 equals K4 then K5 on the card."""
    spec, te, tq, mask_t, am_t, w, g_e, g_v = _plain_case(name, draws)
    hh = tfl.fused_layer_plain(spec, te, tq, mask_t, am_t, w, seed=5,
                               save_hh=True)[2]
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,clip", [("residual_gated", True),
                                       ("constrained_ungated", True),
                                       ("residual_gated", False)])
def test_mono_head_plain_equals_the_forward_h_hat(name, clip, dt):
    """K6's head, plain: its f32 h_hat is K3's plain h_hat bit for bit (in
    the working type, its rnd(h_hat) is), and its flags are the strict test
    lo < q.k scale < hi on the raw logit; no flags without a clip."""
    spec, e, qkv, mask, am, w, _, _ = _plain_case(name, dt=dt)
    if not clip:
        spec = spec._replace(clip=None)
    hh, hh_dt, inrange = tfl.mono_head_plain(spec, e, qkv, w)
    ref = tfl.fused_layer_plain(spec, e, qkv, mask, am, w, seed=5,
                                save_hh=True)[2]
    assert hh.dtype == torch.float32 and hh_dt.dtype == dt
    assert torch.equal(hh_dt, ref) and torch.equal(hh.to(dt), ref)
    if dt == torch.float32:
        assert torch.equal(hh, ref)
    if not clip:
        assert inrange is None
        return
    b, l = mask.shape
    qkv4 = qkv.float().reshape(b, l, 3, spec.dh // spec.h, spec.h)
    s = torch.einsum("bidh,bjdh->bijh", qkv4[:, :, 0], qkv4[:, :, 1]) * \
        spec.scale
    lo, hi = spec.clip
    assert torch.equal(inrange, (s > lo) & (s < hi))
    assert bool(inrange.any()) and not bool(inrange.all())  # the clip bites


def _mono_plain_one_piece(spec, e, qkv, mask, amask, w, g_eout, g_vatt,
                          seed):
    """K6's plain version as one piece, frozen as it was before it was
    split into its head (`mono_head_plain`) and K7's math: h_hat, the tail
    backward, then the attention backward with the clip's test on the raw
    logit s."""
    dt = e.dtype
    b, l = mask.shape
    x1, rstd1, e_ln, G, P, E = tfl._edge_head(spec, e, w)
    q, k, v = tfl._split_qkv(spec, qkv)
    s = torch.einsum("bidh,bjdh->bijh", q.float(), k.float()) * spec.scale
    hh = (torch.clamp(s, *spec.clip) if spec.clip is not None else s) + E
    de_mid, dhh, dw = tfl.tail_bwd(spec.act, e, hh, g_eout, w)
    a_sm, sg, kept, a_drop = tfl._softmax_gate(spec, hh, G, mask, amask, seed)
    gv = g_vatt.reshape(q.shape)
    da = torch.einsum("bidh,bjdh->bijh", gv.float(), v.float())
    if kept is not None:
        da = torch.where(kept, da / (1.0 - spec.attn_dropout), 0.0)
    if spec.gated:
        da_sm = da * sg
        dgate = da * a_sm * sg * (1.0 - sg)
    else:
        da_sm = da
    t = (da_sm * a_sm).sum(dim=2, keepdim=True)
    dH = a_sm * (da_sm - t) + dhh.float()
    ds = dH * spec.scale
    if spec.clip is not None:
        ds = torch.where((s > spec.clip[0]) & (s < spec.clip[1]), ds, 0.0)
    ds_dt = ds.to(dt).float()
    dq = torch.einsum("bijh,bjdh->bidh", ds_dt, k.float()).to(dt)
    dk = torch.einsum("bijh,bidh->bjdh", ds_dt, q.float())
    dv = torch.einsum("bijh,bidh->bjdh", a_drop.to(dt).float(), gv.float())
    dP = dH * tfl._act_grad(spec.edge_act, P, E)
    dP_dt = dP.to(dt)
    de_ln = tfl._mm(dP_dt, w["wb"].T)
    if spec.gated:
        dgate_dt = dgate.to(dt)
        de_ln = de_ln + tfl._mm(dgate_dt, w["wg"].T)
        dw.update(wg=tfl._wgrad(e_ln, dgate_dt), bg=tfl._colsum(dgate))
    dw.update(wb=tfl._wgrad(e_ln, dP_dt), bb=tfl._colsum(dP),
              g1=tfl._colsum(de_ln * x1), b1=tfl._colsum(de_ln))
    de = tfl._ln_bwd(de_ln, w["g1"], x1, rstd1) + de_mid.float()
    flat = (b, l, spec.dh)
    return de.to(dt), dq.reshape(flat), dk.reshape(flat), dv.reshape(flat), dw


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("name", ["residual_gated", "constrained_ungated"])
def test_mono_plain_equals_its_one_piece_formula(name, draws, dt):
    """Split into its head and K7's math, K6's plain version gives what its
    one-piece formula gave, bit for bit, with and without the draws."""
    args = _plain_case(name, draws, dt)
    out = tfl.fused_layer_bwd_mono_plain(*args, seed=5)
    ref = _mono_plain_one_piece(*args, seed=5)
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)
    assert sorted(out[4]) == sorted(ref[4])
    for k in ref[4]:
        assert torch.equal(out[4][k], ref[4][k]), k
