"""The port's edge-block path against the JAX package on the CPU.

- The plain versions of K8 and K9 (`edge_block_apply` through `EdgeBlockFn`
  on CPU tensors) against `edge_block_pallas.edge_block_apply` and its VJP
  (the Pallas kernels in interpret mode), on the same numpy inputs: b 2,
  l 7, h 4, ew 16, hidden 32 (98 pairs: not a multiple of any row block),
  and two shapes that K8's bf16 body on the card takes through other
  branches: b 3, l 5, h 4, ew 16, hidden 40 (odd l, tiles across graphs, a
  hidden width no multiple of 16) and b 2, l 6, h 16, ew 128, hidden 256
  (16 n8 tiles a lane, fewer warps a block).
  f32 at 1e-5 (the same formulas); bf16 at 0.1, as the whole-layer forward
  test (`test_torch_fused_layer.py`). h_hat is given as rows (b, l, l, h)
  and as a view of a head-major (b, h, l, l) tensor, the attention kernel's
  layout, which the port reads in place.
- The 2-layer model on path C (attention kernel, then the edge block) with
  ew 64 against the JAX model with `fused_edge_block`: outputs at 1e-4, the
  ZINC loss's gradients of every parameter at 2e-4 (f32, draws off). ew 64
  because the JAX rule (`can_fuse_edge_block`) takes the unfused path below
  it; both sides' `edge_block_apply` calls are counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch.models import layers as tlayers
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops import edge_block as teb
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.ops import edge_block_pallas as jeb
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import metrics as jm
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_fused_layer import tree
from tests.test_torch_model import jax_params, port_model
from tests.test_torch_training import _zinc_loss_port

# name: (b, l, h, ew, hidden)
BLOCK_SHAPES = {"base": (2, 7, 4, 16, 32), "l5_h4_ew16": (3, 5, 4, 16, 40),
                "ew128_h16": (2, 6, 16, 128, 256)}


def _block_case(seed=0, shape="base"):
    B, L, H, EW, HID = BLOCK_SHAPES[shape]
    rng = np.random.default_rng(seed)

    def dense(i, o):
        # uniform in +-0.5, narrowed past 32 inputs so that the activations
        # of a wide layer keep the narrow ones' scale
        lim = 0.5 * min(1.0, (32 / i) ** 0.5)
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    p = {"dense_edge_r": dense(H, EW),
         "edge_ffn": {"norm": {"gamma": (1 + 0.1 * rng.normal(size=EW)
                                         ).astype(np.float32),
                               "beta": (0.1 * rng.normal(size=EW)
                                        ).astype(np.float32)},
                      "lr1": dense(EW, HID), "lr2": dense(HID, EW)}}
    hh = (2 * rng.normal(size=(B, L, L, H))).astype(np.float32)
    e = rng.normal(size=(B, L, L, EW)).astype(np.float32)
    g = rng.normal(size=(B, L, L, EW)).astype(np.float32)
    return p, hh, e, g


def _port_hh(hh, dt, head_major):
    t = torch.from_numpy(hh).to(dt)
    if head_major:            # the same values stored (b, h, l, l)
        t = t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return t.requires_grad_()


def _flat(g, prefix=""):
    out = {}
    for k, v in g.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize(
    "shape,head_major", [(s, hm) for s in BLOCK_SHAPES for hm in (False, True)],
    ids=[("" if s == "base" else f"{s}-") + ("head_major" if hm else "rows")
         for s in BLOCK_SHAPES for hm in (False, True)])
@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-5),
                                    (torch.bfloat16, 0.1)],
                         ids=["f32", "bf16"])
def test_edge_block_matches_jax(dt, tol, shape, head_major):
    p, hh, e, g = _block_case(shape=shape)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32

    def jfn(p_, hh_, e_):
        return jeb.edge_block_apply(p_, hh_, e_)

    out_j, vjp = jax.vjp(jfn, tree(p, jnp.asarray), jnp.asarray(hh, jdt),
                         jnp.asarray(e, jdt))
    gp_j, ghh_j, ge_j = vjp(jnp.asarray(g, jdt))

    tp = tree(p, lambda x: torch.from_numpy(x).requires_grad_())
    thh = _port_hh(hh, dt, head_major)
    te = torch.from_numpy(e).to(dt).requires_grad_()
    before = (teb.KERNEL.launches, teb.BWD_KERNEL.launches)
    out_t = teb.edge_block_apply(tp, thh, te)
    out_t.backward(torch.from_numpy(g).to(dt))
    assert (teb.KERNEL.launches, teb.BWD_KERNEL.launches) == before
    assert out_t.dtype == dt and thh.grad.dtype == dt

    def close(a, b, what):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol, err_msg=what)

    close(out_t.detach(), out_j, "out")
    close(thh.grad, ghh_j, "dhh")
    close(te.grad, ge_j, "de_res")
    fj, ft = _flat(gp_j), _flat(tree(tp, lambda x: x.grad.numpy()))
    assert sorted(fj) == sorted(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_plain_backward_matches_autograd():
    """K9's plain version = torch autograd of K8's plain version."""
    p, hh, e, g = _block_case(1)
    w = {k: torch.from_numpy(x).requires_grad_() for k, x in dict(
        wr=p["dense_edge_r"]["kernel"], br=p["dense_edge_r"]["bias"],
        g2=p["edge_ffn"]["norm"]["gamma"], b2=p["edge_ffn"]["norm"]["beta"],
        w1=p["edge_ffn"]["lr1"]["kernel"], bb1=p["edge_ffn"]["lr1"]["bias"],
        w2=p["edge_ffn"]["lr2"]["kernel"],
        bb2=p["edge_ffn"]["lr2"]["bias"]).items()}
    thh = torch.from_numpy(hh).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    teb.edge_block_fwd_plain(thh, te, w).backward(torch.from_numpy(g))
    with torch.no_grad():
        dhh, de, dw = teb.edge_block_bwd_plain(thh, te, torch.from_numpy(g), w)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dhh, thh.grad, **tol)
    torch.testing.assert_close(de, te.grad, **tol)
    for k, x in w.items():
        torch.testing.assert_close(dw[k], x.grad, **tol, msg=k)


# ------------------------------------------------------ the model on path C

# path C: the attention kernel, then the edge block; the JAX edge block runs
# ELU whatever the activation ("relu": the port follows that quirk)
PATH_C = dict(edge_width=64, fused_attention=True, fused_edge_block=True)
VARIANTS = {"residual": dict(),
            "constrained": dict(edge_channel_type="constrained"),
            "relu": dict(activation="relu")}


def _count_edge_blocks(monkeypatch):
    counts = {"jax": 0, "port": 0}
    for mod, key in ((jeb, "jax"), (tlayers, "port")):
        fn = mod.edge_block_apply

        def wrapper(*args, _fn=fn, _key=key, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, "edge_block_apply", wrapper)
    return counts


@pytest.mark.parametrize("name", list(VARIANTS))
def test_path_c_model_matches_jax(name, monkeypatch):
    jcfg = small_cfg(**PATH_C, **VARIANTS[name])
    assert tlayers.can_fuse_edge_block(TCfg(**dataclasses.asdict(jcfg)))
    counts = _count_edge_blocks(monkeypatch)
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(5), b=3, l=9)
    ref, _ = JModel(jcfg).apply(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.inference_mode():
        out = model(batch)
    assert counts == {"jax": jcfg.model_height, "port": jcfg.model_height}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["residual", "constrained"])
def test_path_c_model_grads_match_jax(name, monkeypatch):
    jcfg = small_cfg(**PATH_C, **VARIANTS[name])
    counts = _count_edge_blocks(monkeypatch)
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(6), b=3, l=9)

    def loss_fn(p):
        out, _ = JModel(jcfg).apply(p, batch, training=True,
                                    rng=jax.random.PRNGKey(0))
        s, c = jm.mae_loss(out, batch["target"])
        return s / jnp.maximum(c, 1.0)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = port_model(jcfg, jckpt._flatten_params(params))
    loss_t = _zinc_loss_port(model, batch)
    loss_t.backward()
    assert counts == {"jax": jcfg.model_height, "port": jcfg.model_height}
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    flat_j = jckpt._flatten_params(grads_j)
    for k, p in model.named_parameters():
        ref = flat_j[k.replace(".", "/")]
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, ref, rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("kw,training,fused", [
    (dict(), False, True),
    (dict(edge_width=32), False, False),        # narrower than 64
    (dict(edge_dropout=0.1), False, True),
    (dict(edge_dropout=0.1), True, False),      # no edge dropout in the kernel
    (dict(add_n_norm=True), False, False),
    (dict(fused_edge_block=False), False, False),
])
def test_can_fuse_edge_block_follows_jax(kw, training, fused):
    from egt_tpu.models.layers import can_fuse_edge_block as jrule
    jcfg = small_cfg(**{**PATH_C, **kw})
    tcfg = TCfg(**dataclasses.asdict(jcfg))
    assert tlayers.can_fuse_edge_block(tcfg, training) is fused
    assert jrule(jcfg, training, None, False) is fused
