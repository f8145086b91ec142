"""The port's CUDA kernels against their plain versions on the card, at small
shapes. Marked `cuda`: they skip on a machine without a GPU. Run on one:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: f32 1e-4 (the sums run in another order);
bf16, compared in the working type, 5e-2 + 2e-2 * |plain| (an order change
can flip one rounding of an intermediate). Weight gradients, sums over every
pair, and dk, dv, sums over query rows, are compared with the absolute
part scaled by max(1, max |plain|).
The training cases run with the random mask and dropout live: kernel and
plain version draw the same Philox bits. TF32 is off for matrix products
(the `dev` fixture), so the plain references are full f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from egt_torch import weights
from egt_torch.models.graph_model import EGTGraphModel, GraphModelConfig
from egt_torch.ops import custom_ops
from egt_torch.ops import edge_block as eb
from egt_torch.ops import egt_attention as att
from egt_torch.ops import fused_layer as fl

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype, scaled=False):
    atol, rtol = TOL[dtype]
    if scaled:
        atol *= max(1.0, float(ref.float().abs().max()))
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


# K1's and K2's shapes (b, h, lq, lk, d, clip): the flagship tile; the other
# shipped per-head widths (48/8 and 80/8) and the widest the tensor-core
# body takes; odd lengths (element loads); a row block (lq < lk); 4 and 16
# heads; 64 keys, the body's limit; no clip; past d 16 and past 64 keys the
# CUDA-core body
ATT_SHAPES = {
    "flagship": (4, 8, 40, 40, 8, (-5.0, 5.0)),
    "d6": (3, 4, 21, 21, 6, (-5.0, 5.0)),
    "d10": (3, 4, 21, 21, 10, (-5.0, 5.0)),
    "d16": (3, 4, 24, 24, 16, (-5.0, 5.0)),
    "l13": (3, 4, 13, 13, 8, (-5.0, 5.0)),
    "l37": (2, 4, 37, 37, 8, (-5.0, 5.0)),
    "rows": (3, 4, 9, 13, 6, (-5.0, 5.0)),
    "h16": (2, 16, 20, 20, 8, (-5.0, 5.0)),
    "lk64": (2, 4, 64, 64, 8, (-5.0, 5.0)),
    "no_clip": (3, 8, 40, 40, 8, None),
    "d24": (2, 4, 20, 20, 24, (-5.0, 5.0)),
    "lk80": (2, 4, 30, 80, 8, (-5.0, 5.0)),
    # the PATTERN / CLUSTER tile: 8 heads of 8 at their longer bucket
    "sbm_l192": (2, 8, 192, 192, 8, (-5.0, 5.0)),
    # the `egt_simple` main path: ZINC's 8 heads of 10 at pad 40 (the
    # tensor-core bodies on 20-byte rows), TSP's longest bucket
    "simple_zinc_d10": (4, 8, 40, 40, 10, (-5.0, 5.0)),
    "tsp_l512": (2, 8, 512, 512, 8, (-5.0, 5.0)),
    # PCQM4Mv2's EGT-Large: 32 heads of 24 (the CUDA-core bodies, lanes
    # 24-31 idle in A.V) at the synthetic pad 32 plus 4 virtual nodes
    "pcqm_l36": (2, 32, 36, 36, 24, (-5.0, 5.0)),
    # the row blocks of edge partitioning over 2 shards: one shard's query
    # rows against every key at ZINC's pad 40 (the tensor-core bodies),
    # TSP's l 512 and PCQM4Mv2's 4 virtual rows and 16 of its 32 atoms
    "zinc_sp2_rows": (4, 8, 20, 40, 8, (-5.0, 5.0)),
    "tsp_sp2_rows": (2, 8, 256, 512, 8, (-5.0, 5.0)),
    "pcqm_sp2_rows": (2, 32, 20, 36, 24, (-5.0, 5.0)),
}


def _att_case(dev, dtype, shape, gated, hard, qk_scale=1.0, on_grid=True):
    """Inputs of K1 and K2 at ATT_SHAPES[shape], and the body the geometry
    queries name, asserted: the tensor cores in bf16 with d <= 16 and lq,
    lk <= 64, else the CUDA cores. With `on_grid`, q and k lie on a 1/8
    grid: q.k is then exact in f32 in any summation order, so K2's inclusive
    clip test on the recomputed raw logit falls alike in kernel and plain
    version even at the clip's edges. Without it they take general values
    (see `test_attention_training_kernels_general_qk`)."""
    g_ = _gen(dev)
    b, h, lq, lk, d, clip = ATT_SHAPES[shape]
    body = int(dtype == torch.bfloat16 and d <= 16 and max(lq, lk) <= 64)
    for geo in (att.fwd_geometry(dtype, lq, lk, d),
                att.bwd_geometry(dtype, lq, lk, d)):
        assert geo["tensor_cores"] == body and geo["smem"] <= 227 * 1024
        assert geo["warps"] == ((lq + 15) // 16 if body else 4)

    def rnd(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g_, device=dev)).to(dtype)

    def grid(*s):
        if not on_grid:
            return rnd(*s, scale=qk_scale)
        return (torch.round(qk_scale * 8 * torch.randn(s, generator=g_,
                                                       device=dev)) / 8
                ).to(dtype)

    q, k, v = grid(b, h, lq, d), grid(b, h, lk, d), rnd(b, h, lk, d)
    e, g = rnd(b, h, lq, lk), rnd(b, h, lq, lk) if gated else None
    n = torch.randint(min(3, lk), lk + 1, (b,), generator=g_, device=dev)
    n[0] = lk
    madd = (torch.arange(lk, device=dev)[None] < n[:, None]).float() \
        .sub(1).mul(1e9)
    maddf = ((torch.rand((b, lq, lk), generator=g_, device=dev) < 0.5)
             .float() - 1) * 1e9 if hard else None
    return q, k, v, e, g, madd, maddf, clip


@pytest.mark.parametrize("shape", list(ATT_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated,hard", [(True, False), (False, True),
                                        (True, True)])
def test_attention_kernel_matches_plain(dev, dtype, gated, hard, shape):
    """K1 at inference against its plain version, through the body its
    geometry query names."""
    args = _att_case(dev, dtype, shape, gated, hard)
    before = att.KERNEL.launches
    out = att.egt_core_fwd(*args)
    assert att.KERNEL.launches == before + 1
    ref = att.egt_core_fwd_plain(*args)
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if r is not None:
            _close(o, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False)])
def test_fused_layer_kernel_matches_plain(dev, dtype, constrained, gated):
    g_ = _gen(dev)
    b, l, ew, h, dh = 3, 37, 24, 4, 16      # l spans two key chunks

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    def dense(i, o):
        return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

    p = {"dense_edge_b": dense(ew, h),
         "norm_edge": {"gamma": 1 + rnd(ew, scale=0.1), "beta": rnd(ew, scale=0.1)},
         "dense_edge_r": dense(h, ew),
         "edge_ffn": {"norm": {"gamma": 1 + rnd(ew, scale=0.1),
                               "beta": rnd(ew, scale=0.1)},
                      "lr1": dense(ew, 2 * ew), "lr2": dense(2 * ew, ew)}}
    if gated:
        p["attention_gates"] = dense(ew, h)
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=gated,
                        constrained=constrained, clip=(-5.0, 5.0),
                        edge_act="relu", act="elu", scale=float(dh // h) ** -0.5)
    w = fl.layer_weights(p, dtype)
    e, qkv = rnd(b, l, l, ew).to(dtype), rnd(b, l, 3 * dh).to(dtype)
    mask = (torch.arange(l, device=dev)[None] < torch.tensor(
        [[9], [37], [20]], device=dev)).float()
    am = (torch.rand((b, l, l), generator=g_, device=dev) < 0.4).float() \
        if constrained else None
    before = fl.KERNEL.launches
    out = fl.fused_layer_core(spec, e, qkv, mask, am, w)
    assert fl.KERNEL.launches == before + 1
    ref = fl.fused_layer_plain(spec, e, qkv, mask, am, w)
    for o, r in zip(out, ref):
        _close(o, r, dtype)


@pytest.mark.parametrize("knobs", [dict(fused_layer=True),
                                   dict(fused_attention=True)])
def test_model_kernel_path_matches_plain_path(dev, knobs):
    cfg = GraphModelConfig(model_width=32, edge_width=16, num_heads=4,
                           model_height=2, upto_hop=3)
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(
        EGTGraphModel(dataclasses.replace(cfg, **knobs), device=dev), flat)
    rng = np.random.default_rng(0)
    b, l = 4, 20
    n = rng.integers(5, l + 1, size=b)
    nf = np.where(np.arange(l)[None] < n[:, None], rng.integers(0, 28, (b, l)),
                  -1)
    valid = (nf[:, :, None] >= 0) & (nf[:, None, :] >= 0)
    adj = ((rng.random((b, l, l)) < 0.2) & valid).astype(np.uint8)
    fm = np.where(adj > 0, rng.integers(0, 4, (b, l, l)), -1)
    batch = {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}
    with torch.inference_mode():
        torch.testing.assert_close(fast(batch), base(batch), atol=1e-4,
                                   rtol=1e-4)


def test_wrappers_reject_unsupported_dtype(dev):
    x = torch.zeros((1, 1, 4, 2), dtype=torch.float16, device=dev)
    m = torch.zeros((1, 4), device=dev)
    with pytest.raises(ValueError):
        att.egt_core_fwd(x, x, x, torch.zeros((1, 1, 4, 4), dtype=torch.float16,
                                              device=dev), None, m, None, None)


# (b, l, ew, h, dh): l 37 spans two key chunks; the ZINC-500k layer shape
LAYER_SHAPES = {"awkward": (3, 37, 24, 4, 16), "flagship": (4, 40, 64, 8, 64)}
# and for K6's head kernel an edge width of no whole 16-byte loads a row
HEAD_SHAPES = {**LAYER_SHAPES, "ew10": (2, 9, 10, 2, 6)}


def _layer_case(dev, dtype, constrained, gated, training=True,
                shape="awkward"):
    g_ = _gen(dev)
    b, l, ew, h, dh = HEAD_SHAPES[shape]

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    def dense(i, o):
        return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

    p = {"dense_edge_b": dense(ew, h),
         "norm_edge": {"gamma": 1 + rnd(ew, scale=0.1), "beta": rnd(ew, scale=0.1)},
         "dense_edge_r": dense(h, ew),
         "edge_ffn": {"norm": {"gamma": 1 + rnd(ew, scale=0.1),
                               "beta": rnd(ew, scale=0.1)},
                      "lr1": dense(ew, 2 * ew), "lr2": dense(2 * ew, ew)}}
    if gated:
        p["attention_gates"] = dense(ew, h)
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=gated,
                        constrained=constrained, clip=(-2.0, 2.0),
                        edge_act="relu", act="elu", scale=float(dh // h) ** -0.5,
                        random_mask_prob=0.1, attn_dropout=0.1,
                        training=training)
    w = fl.layer_weights(p, dtype)
    e, qkv = rnd(b, l, l, ew).to(dtype), rnd(b, l, 3 * dh).to(dtype)
    mask = (torch.arange(l, device=dev)[None] < torch.tensor(
        [[9], [l], [20], [31]][:b], device=dev)).float()
    am = (torch.rand((b, l, l), generator=g_, device=dev) < 0.4).float() \
        if constrained else None
    cot = (rnd(b, l, l, ew).to(dtype), rnd(b, l, dh).to(dtype))
    return spec, e, qkv, mask, am, w, cot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False)])
def test_fused_layer_training_kernels_match_plain(dev, dtype, constrained,
                                                  gated):
    """K3 with the draws and h_hat out, K4 and K5, each against its plain
    version on the same inputs."""
    spec, e, qkv, mask, am, w, (ge, gv) = _layer_case(dev, dtype, constrained,
                                                      gated)
    counts = (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
              fl.BWD_ATTN_KERNEL.launches)
    out = fl.fused_layer_core(spec, e, qkv, mask, am, w, 7, save_hh=True)
    ref = fl.fused_layer_plain(spec, e, qkv, mask, am, w, 7, save_hh=True)
    for o, r in zip(out, ref):
        _close(o, r, dtype)
    # the backward from an h_hat drawn on its own: pairs beyond the clip but
    # none at its edge, where K5's strict in-range test on hh - E follows
    # the last bit of E (summed in another order by the plain version)
    hh = (3.0 * torch.randn(ref[2].shape, generator=_gen(dev),
                            device=dev)).to(dtype)
    tail = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)
    tail_ref = fl.fused_layer_bwd_tail_plain(spec, e, hh, ge, w)
    for o, r in zip(tail[:2], tail_ref[:2]):
        _close(o, r, dtype)
    for k, r in tail_ref[2].items():
        _close(tail[2][k], r, dtype, scaled=True)
    de_mid, dhh = tail_ref[:2]
    att_ = fl.fused_layer_bwd_attn(spec, e, qkv, mask, am, w, hh, dhh, de_mid,
                                   gv, 7)
    att_ref = fl.fused_layer_bwd_attn_plain(spec, e, qkv, mask, am, w, hh, dhh,
                                            de_mid, gv, 7)
    for i, (o, r) in enumerate(zip(att_[:4], att_ref[:4])):   # de dq dk dv
        _close(o, r, dtype, scaled=i >= 2)
    assert sorted(att_[4]) == sorted(att_ref[4])
    for k, r in att_ref[4].items():
        _close(att_[4][k], r, dtype, scaled=True)
    assert (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
            fl.BWD_ATTN_KERNEL.launches) == tuple(c + 1 for c in counts)


def _att_training(dev, dtype, shape, gated, hard, on_grid=True):
    """K2's inputs: K1's with q and k scaled by 3, so that the clip binds on
    many pairs, the draws live, and the cotangents of v_att, h_hat and (when
    gated) the degrees; h_hat from K1's plain version."""
    q, k, v, e, g, madd, maddf, clip = _att_case(dev, dtype, shape, gated,
                                                 hard, qk_scale=3.0,
                                                 on_grid=on_grid)
    g_ = torch.Generator(device=dev).manual_seed(1)
    gv = torch.randn(q.shape, generator=g_, device=dev).to(dtype)
    gh = torch.randn(e.shape, generator=g_, device=dev).to(dtype)
    gdeg = torch.randn(q.shape[:3], generator=g_, device=dev) if gated \
        else None
    draws = att.Draws(11, 0.1, 0.1)
    fargs = (q, k, v, e, g, madd, maddf, clip, draws)
    h_hat = att.egt_core_fwd_plain(*fargs)[1]
    return fargs, (q, k, v, g, madd, maddf, h_hat, gv, gh, gdeg, clip, draws)


@pytest.mark.parametrize("shape", list(ATT_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated,hard", [(True, False), (False, True)])
def test_attention_training_kernels_match_plain(dev, dtype, gated, hard,
                                                shape):
    """K1 with the draws and K2 (with a degree cotangent when gated) against
    their plain versions, through the bodies their geometry queries name."""
    fargs, bargs = _att_training(dev, dtype, shape, gated, hard)
    fwd = att.egt_core_fwd(*fargs)
    fwd_ref = att.egt_core_fwd_plain(*fargs)
    for o, r in zip(fwd, fwd_ref):
        assert (o is None) == (r is None)
        if r is not None:
            _close(o, r, dtype)
    before = att.BWD_KERNEL.launches
    bwd = att.egt_core_bwd(*bargs)
    assert att.BWD_KERNEL.launches == before + 1
    bwd_ref = att.egt_core_bwd_plain(*bargs)
    for i, (o, r) in enumerate(zip(bwd, bwd_ref)):   # dq dk dv de dg
        assert (o is None) == (r is None)
        if r is not None:
            _close(o, r, dtype, scaled=i in (1, 2))


@pytest.mark.parametrize("shape", ["flagship", "d24"])
def test_attention_training_kernels_general_qk(dev, shape):
    """K1 and K2 in bf16 on general-valued q and k, through the tensor-core
    body (flagship) and the CUDA-core body (d 24). K2's inclusive clip test
    on its recomputed raw logit may fall otherwise than the plain version's
    where that logit lies within a few ulps of a clip edge: such pairs (few)
    are left out with their row's dq and their column's dk."""
    dtype = torch.bfloat16
    fargs, bargs = _att_training(dev, dtype, shape, True, False,
                                 on_grid=False)
    for o, r in zip(att.egt_core_fwd(*fargs), att.egt_core_fwd_plain(*fargs)):
        if r is not None:
            _close(o, r, dtype)
    q, k, clip = fargs[0], fargs[1], fargs[7]
    raw = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * \
        q.shape[-1] ** -0.5
    assert float(((raw < clip[0]) | (raw > clip[1])).float().mean()) > 0.1
    ulp = 16 * float(np.spacing(np.float32(max(map(abs, clip)))))
    near = ((raw - clip[0]).abs() <= ulp) | ((raw - clip[1]).abs() <= ulp)
    assert int(near.sum()) <= max(1, 1e-4 * near.numel()), int(near.sum())
    rows, cols = near.any(-1, keepdim=True), near.any(-2)[..., None]
    bwd = att.egt_core_bwd(*bargs)
    ref = att.egt_core_bwd_plain(*bargs)
    bwd = (torch.where(rows, ref[0], bwd[0]),
           torch.where(cols, ref[1], bwd[1]), *bwd[2:])
    for i, (o, r) in enumerate(zip(bwd, ref)):      # dq dk dv de dg
        if r is not None:
            _close(o, r, dtype, scaled=i in (1, 2))


@pytest.mark.parametrize("shape", ["flagship", "d10", "l37", "rows",
                                   "tsp_l512"])
@pytest.mark.parametrize("gated,hard", [(True, False), (False, True)])
def test_attention_bwd_bf16_bit_identical_across_launches(dev, gated, hard,
                                                          shape):
    """K2's bf16 body: two launches give the same bits, dk and dv (sums over
    the query rows, added in warp order) included."""
    _, bargs = _att_training(dev, torch.bfloat16, shape, gated, hard)
    first = att.egt_core_bwd(*bargs)
    again = att.egt_core_bwd(*bargs)
    for o, r in zip(first, again):
        assert (o is None) == (r is None)
        if r is not None:
            assert torch.equal(o, r)


def test_attention_bodies_at_egt_simple_shapes(dev):
    """The bodies the `egt_simple` configs take: the tensor cores at ZINC's
    d 10 and l 40 in bf16; past 64 keys the CUDA cores, K2's block at TSP's
    l 512 holding 164,608 B (4 warps of 2 (l, d) sums and 4 l-rows of f32),
    which fits one block a SM."""
    for dtype in (torch.float32, torch.bfloat16):
        fwd, bwd = att.fwd_geometry(dtype, 40, 40, 10), \
            att.bwd_geometry(dtype, 40, 40, 10)
        assert fwd["tensor_cores"] == bwd["tensor_cores"] == \
            int(dtype == torch.bfloat16)
        for l in (75, 128, 150, 192, 256, 512):
            assert att.fwd_geometry(dtype, l, l, 8)["tensor_cores"] == 0
            assert att.bwd_geometry(dtype, l, l, 8)["tensor_cores"] == 0
        assert att.bwd_geometry(dtype, 512, 512, 8)["smem"] == 164_608


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_model_kernel_path_matches_plain_path(dev, dtype):
    """A 2-layer `bias` model (the `egt_simple` ablations' channel), one
    training forward and backward with the draws live: the attention
    kernel's path (K1, K2 once each a layer; never K3) against the plain
    path, in outputs, loss and every gradient, the edge embeddings' (every
    layer's de and dg summed) among them."""
    cfg = GraphModelConfig(model_width=40, edge_width=8, num_heads=4,
                           model_height=2, upto_hop=3, random_mask_prob=0.1,
                           attn_dropout=0.1, edge_channel_type="bias",
                           compute_dtype=str(dtype)[6:])
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(EGTGraphModel(
        dataclasses.replace(cfg, fused_attention=True, fused_layer=True),
        device=dev), flat)
    rng = np.random.default_rng(1)
    b, l = 4, 40
    n = rng.integers(9, l + 1, size=b)
    nf = np.where(np.arange(l)[None] < n[:, None], rng.integers(0, 28, (b, l)),
                  -1)
    valid = (nf[:, :, None] >= 0) & (nf[:, None, :] >= 0)
    adj = ((rng.random((b, l, l)) < 0.1) & valid).astype(np.uint8)
    fm = np.where(adj > 0, rng.integers(0, 4, (b, l, l)), -1)
    batch = {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}
    target = torch.randn((b, 1), device=dev)
    before = (att.KERNEL.launches, att.BWD_KERNEL.launches, fl.KERNEL.launches)
    outs, grads = [], []
    for model in (fast, base):
        out = model(batch, training=True, seeds=[3, 4])
        (out - target).abs().mean().backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in weights.flat_names(model).items()})
    assert (att.KERNEL.launches, att.BWD_KERNEL.launches,
            fl.KERNEL.launches) == (before[0] + 2, before[1] + 2, before[2])
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(outs[0], outs[1], atol=tol, rtol=tol)
    top = max(float(g.abs().max()) for g in grads[1].values())
    for k, r in grads[1].items():
        err = float((grads[0][k] - r).abs().max()) / max(
            float(r.abs().max()), 1e-2 * top)
        assert err <= (1e-3 if dtype == torch.float32 else 5e-2), (k, err)
    for k in ("fm_emb/table", "adj_emb/kernel"):
        assert float(grads[0][k].abs().max()) > 0, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pcqm_model_kernel_path_matches_plain_path(dev, dtype):
    """A 2-layer EGT-Large-shaped model (8 heads of 24, 4 virtual nodes,
    the degree scaler, the OGB token columns, the graph readout from the
    virtual rows), one training forward and backward with the attention
    dropout live: K1 and K2 once each a layer (the scaler refuses K3)
    against the plain path, in outputs and every gradient."""
    from egt_torch import synthetic
    from egt_torch.data.datasets import OGB_ATOM_DIMS, OGB_BOND_DIMS
    cfg = GraphModelConfig(model_width=192, edge_width=16, num_heads=8,
                           model_height=2, ffn_multiplier=1.0,
                           num_virtual_nodes=4, scale_degree=True,
                           attn_dropout=0.3, node_vocab_sizes=OGB_ATOM_DIMS,
                           edge_vocab_sizes=OGB_BOND_DIMS,
                           compute_dtype=str(dtype)[6:])
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(EGTGraphModel(
        dataclasses.replace(cfg, fused_attention=True, fused_layer=True),
        device=dev), flat)
    batch = synthetic.pcqm_batch(np.random.default_rng(2), 6)
    target = torch.from_numpy(batch["target"]).to(dev)
    before = (att.KERNEL.launches, att.BWD_KERNEL.launches, fl.KERNEL.launches)
    outs, grads = [], []
    for model in (fast, base):
        out = model(batch, training=True, seeds=[3, 4])
        (out - target).abs().mean().backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in weights.flat_names(model).items()})
    assert (att.KERNEL.launches, att.BWD_KERNEL.launches,
            fl.KERNEL.launches) == (before[0] + 2, before[1] + 2, before[2])
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(outs[0], outs[1], atol=tol, rtol=tol)
    top = max(float(g.abs().max()) for g in grads[1].values()
              if g is not None)
    for k, r in grads[1].items():
        if r is None:
            # the last layer's edge tail: no loss reads its output
            assert grads[0][k] is None or not grads[0][k].any(), k
            continue
        err = float((grads[0][k] - r).abs().max()) / max(
            float(r.abs().max()), 1e-2 * top)
        assert err <= (1e-3 if dtype == torch.float32 else 5e-2), (k, err)
    for k in ("virtual_node_embeddings", "virtual_edge_embeddings"):
        assert float(grads[0][k].abs().max()) > 0, k


@pytest.mark.parametrize("knobs", [dict(fused_layer=True),
                                   dict(fused_attention=True)])
def test_model_training_grads_kernel_path_match_plain_path(dev, knobs):
    """One training forward and backward of a small f32 model, with the
    random mask and dropout live: the kernel path's loss and gradients
    against the plain path's (the same Philox bits)."""
    cfg = GraphModelConfig(model_width=32, edge_width=16, num_heads=4,
                           model_height=2, upto_hop=3, random_mask_prob=0.1,
                           attn_dropout=0.1)
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(
        EGTGraphModel(dataclasses.replace(cfg, **knobs), device=dev), flat)
    rng = np.random.default_rng(0)
    b, l = 4, 20
    n = rng.integers(5, l + 1, size=b)
    nf = np.where(np.arange(l)[None] < n[:, None], rng.integers(0, 28, (b, l)),
                  -1)
    valid = (nf[:, :, None] >= 0) & (nf[:, None, :] >= 0)
    adj = ((rng.random((b, l, l)) < 0.2) & valid).astype(np.uint8)
    fm = np.where(adj > 0, rng.integers(0, 4, (b, l, l)), -1)
    batch = {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}
    target = torch.randn((b, 1), device=dev)
    grads = []
    for model in (fast, base):
        loss = (model(batch, training=True, seeds=[3, 4]) - target).abs().mean()
        loss.backward()
        grads.append({k: p.grad for k, p in weights.flat_names(model).items()})
    for k, r in grads[1].items():
        if r is None:      # the last layer's unused edge output: zeros or None
            assert grads[0][k] is None or not grads[0][k].any(), k
            continue
        torch.testing.assert_close(grads[0][k], r, atol=1e-4, rtol=1e-4,
                                   msg=k)


@pytest.mark.parametrize("shape", list(LAYER_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False)])
def test_merged_and_mono_kernels_match_plain(dev, dtype, constrained, gated,
                                             shape):
    """K7 (from an h_hat drawn on its own, as K4 and K5 above, with no pair
    near the clip's edges) and K6 (which recomputes h_hat; its strict clip
    test is on the recomputed raw logit) against their plain versions, with
    the draws live."""
    spec, e, qkv, mask, am, w, (ge, gv) = _layer_case(
        dev, dtype, constrained, gated, shape=shape)
    hh = _off_clip(spec, e, w, 3.0 * torch.randn(
        (e.shape[0], spec.l, spec.l, spec.h), generator=_gen(dev),
        device=dev), dtype)
    counts = (fl.BWD_MERGED_KERNEL.launches, fl.BWD_MONO_KERNEL.launches)
    cases = ((fl.fused_layer_bwd_merged(spec, e, qkv, mask, am, w, hh, ge, gv, 7),
              fl.fused_layer_bwd_merged_plain(spec, e, qkv, mask, am, w, hh,
                                              ge, gv, 7)),
             (fl.fused_layer_bwd_mono(spec, e, qkv, mask, am, w, ge, gv, 7),
              fl.fused_layer_bwd_mono_plain(spec, e, qkv, mask, am, w, ge, gv,
                                            7)))
    for out, ref in cases:
        for i, (o, r) in enumerate(zip(out[:4], ref[:4])):   # de dq dk dv
            _close(o, r, dtype, scaled=i >= 2)
        assert sorted(out[4]) == sorted(ref[4])
        for k, r in ref[4].items():
            _close(out[4][k], r, dtype, scaled=True)
    assert (fl.BWD_MERGED_KERNEL.launches,
            fl.BWD_MONO_KERNEL.launches) == tuple(c + 1 for c in counts)


def _off_clip(spec, e, w, hh, dtype):
    """hh in dtype with every pair at least 0.05 from the clip's edges in
    hh - E (moved by 0.25 where it is not): at an edge, K5's strict
    in-range test follows E's last bits (one bf16 rounding of e_ln, taken
    after LN1's sums in another order, moves E by ~1e-3)."""
    hh = hh.to(dtype).float()
    d = hh - fl._edge_head(spec, e, w)[5]
    lo, hi = spec.clip
    near = ((d - lo).abs() < 0.05) | ((d - hi).abs() < 0.05)
    return torch.where(near, hh + 0.25, hh).to(dtype)


def _merged_args(dev, dtype, shape, gated=True, constrained=True):
    """K7's arguments at a shape of MERGED_SHAPES or LAYER_SHAPES."""
    if shape in LAYER_SHAPES:
        spec, e, qkv, mask, am, w, (ge, gv) = _layer_case(
            dev, dtype, constrained, gated, shape=shape)
    else:
        b, l, ew, h, dh, hid = MERGED_SHAPES[shape][1:]
        g_ = _gen(dev)

        def rnd(*s, scale=1.0):
            return scale * torch.randn(s, generator=g_, device=dev)

        def dense(i, o):
            return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

        def ln(n):
            return {"gamma": 1 + rnd(n, scale=0.1), "beta": rnd(n, scale=0.1)}

        p = {"dense_edge_b": dense(ew, h), "norm_edge": ln(ew),
             "dense_edge_r": dense(h, ew),
             "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, hid),
                          "lr2": dense(hid, ew)}}
        if gated:
            p["attention_gates"] = dense(ew, h)
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=gated,
                            constrained=constrained, clip=(-2.0, 2.0),
                            edge_act="elu", act="elu",
                            scale=float(dh // h) ** -0.5,
                            random_mask_prob=0.1, attn_dropout=0.1,
                            training=True)
        w = fl.layer_weights(p, dtype)
        e, qkv = rnd(b, l, l, ew).to(dtype), rnd(b, l, 3 * dh).to(dtype)
        mask = (torch.arange(l, device=dev)[None] < torch.tensor(
            [[l], [max(1, l // 2)]][:b], device=dev)).float()
        am = (torch.rand((b, l, l), generator=g_, device=dev) < 0.4).float() \
            if constrained else None
        ge, gv = rnd(b, l, l, ew).to(dtype), rnd(b, l, dh).to(dtype)
    hh = _off_clip(spec, e, w, 3.0 * torch.randn(
        (e.shape[0], spec.l, spec.l, spec.h), generator=_gen(dev),
        device=dev), dtype)
    return spec, e, qkv, mask, am, w, hh, ge, gv, 7


# K7 at the edges of its bodies' layouts, shapes the old one-block-a-graph
# K7 took: (dtype, b, l, ew, h, dh, hidden), edge activation elu as in
# K5's cases (at relu's kink, P's last bits, summed in another order by the
# plain version, decide dP). kv_global: K5's layouts with
# k, v, dk and dv in shared memory do not fit (bf16: dh 768 at l 64; f32:
# dh 128 at l 100); f32 ew 80 / hidden 160: K4's CUDA-core body without its
# transposed weight copies; bf16 ew 128 / hidden 128: past K4's tensor-core
# body at one warp, so K4's CUDA-core body runs in bf16
MERGED_SHAPES = {
    "kv_global_bf16": (torch.bfloat16, 2, 64, 64, 8, 768, 128),
    "kv_global_f32": (torch.float32, 2, 100, 8, 8, 128, 16),
    "tail_no_copies_f32": (torch.float32, 2, 7, 80, 1, 8, 160),
    "tail_cuda_cores_bf16": (torch.bfloat16, 2, 6, 128, 1, 8, 128),
}


@pytest.mark.parametrize("shape", list(MERGED_SHAPES))
def test_merged_kernel_at_the_edges_of_its_layouts(dev, shape):
    """K7 against its plain version where its bodies take their other
    layouts, with the draws live, edge activation elu; one launch a
    call."""
    dtype = MERGED_SHAPES[shape][0]
    args = _merged_args(dev, dtype, shape)
    g = (fl.bwd_tail_geometry(args[0], dtype, f32_handoff=True),
         fl.bwd_attn_geometry(args[0], f32_handoff=True)
         if dtype == torch.bfloat16 else None)
    if shape.startswith("kv_global") and dtype == torch.bfloat16:
        assert g[1]["kv_global"] == 1 and g[1]["cluster"] == 1
    if shape.startswith("tail"):
        assert g[0]["tensor_cores"] == 0 and g[0]["copies"] == 0, g
    before = fl.BWD_MERGED_KERNEL.launches
    out = fl.fused_layer_bwd_merged(*args)
    assert fl.BWD_MERGED_KERNEL.launches == before + 1
    _close_bwd_row_scaled(out, fl.fused_layer_bwd_merged_plain(*args), dtype)


def _close_bwd_row_scaled(out, ref, dtype):
    """K7's or K6's outputs against the plain version's."""
    # de with the absolute part scaled by each pair's largest |de|: de_mid
    # and dhh reach de and dH in f32, summed in another order by K4's
    # tensor cores than by the plain version, and where dH sits at a bf16
    # rounding boundary of rnd(dP) or rnd(dgate) one step of it moves the
    # pair's whole row of de (by the step times a row of [Wg | Wb]); an
    # element that cancels to well below its row's scale can then differ
    # by more than 2% of itself (kv_global_bf16: 0.117 at |de| 0.85). The
    # plain version's own de moves so when its f32 hand-off is scaled by
    # 1 + 1e-7, and K5 alone, fed one bf16 hand-off on both sides, agrees
    # with its plain version at that element.
    atol, rtol = TOL[dtype]
    row = ref[0].float().abs().amax(-1, keepdim=True).clamp(min=1.0)
    err = (out[0].float() - ref[0].float()).abs()
    assert bool((err <= atol * row + rtol * ref[0].float().abs()).all()), \
        float(err.max())
    for i, (o, r) in enumerate(zip(out[1:4], ref[1:4])):    # dq dk dv
        _close(o, r, dtype, scaled=i >= 1)
    assert sorted(out[4]) == sorted(ref[4])
    for k, r in ref[4].items():
        _close(out[4][k], r, dtype, scaled=True)


def _same_bwd(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
            and sorted(a[4]) == sorted(b[4])
            and all(torch.equal(a[4][k], b[4][k]) for k in a[4]))


@pytest.mark.parametrize("shape,dtype", [
    pytest.param(s, dt, id=f"{s}-{str(dt)[6:]}")
    for s in LAYER_SHAPES for dt in (torch.float32, torch.bfloat16)] + [
    pytest.param(s, MERGED_SHAPES[s][0], id=s)
    for s in ("kv_global_bf16", "kv_global_f32")])
def test_merged_outputs_bit_identical_across_launches(dev, dtype, shape):
    """K7's sums run in a fixed order (partial rows, the cluster's ranks in
    order, no float atomics): two launches agree to the bit."""
    args = _merged_args(dev, dtype, shape)
    assert _same_bwd(fl.fused_layer_bwd_merged(*args),
                     fl.fused_layer_bwd_merged(*args))


@pytest.mark.parametrize("shape", list(LAYER_SHAPES))
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False)])
def test_merged_f32_equals_tail_then_attn(dev, constrained, gated, shape):
    """In f32 the hand-off is the split's own: K7 equals K4 followed by K5
    (fed K4's de_mid and dhh) bit for bit."""
    spec, e, qkv, mask, am, w, hh, ge, gv, seed = _merged_args(
        dev, torch.float32, shape, gated, constrained)
    out = fl.fused_layer_bwd_merged(spec, e, qkv, mask, am, w, hh, ge, gv,
                                    seed)
    de_mid, dhh, dw = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)
    split = fl.fused_layer_bwd_attn(spec, e, qkv, mask, am, w, hh, dhh,
                                    de_mid, gv, seed)
    assert _same_bwd(out, (*split[:4], {**dw, **split[4]}))


def _row_smem(dtype, l, ew, h, dh, hid, gated):
    """Shared memory in bytes a block of the one-block-a-graph row kernel
    took (RowLayout of the deleted `fused_layer_bwd_row.cuh`, which ran the
    first K6 and K7) at the largest tail tile that fitted 227 KB: a whole
    row up to l 64, else 32, 16 or 8 pairs. Frozen from its source, and
    checked equal to it at every shape of the sweep below before the header
    went, so the sweep keeps the set of shapes that kernel took."""
    it = 4 if dtype == torch.float32 else 2

    def pad(n):                 # pad_stride: an odd number of 32-bit words
        if it == 4:
            return n | 1
        n2 = (n + 1) & ~1
        return n2 if (n2 // 2) % 2 else n2 + 2

    nproj = 2 * h if gated else h

    def smem(tp):
        nf = (h * ew + 4 * ew + 2 * ew * hid + hid      # the tail's sums
              + ew * nproj + nproj + 2 * ew              # the head's sums
              + 4 * ew + hid + nproj + 2 * ew            # biases, LN vectors
              + 3 * l * ew + 2 * l + 12 * l * h + h + 2 * dh   # row buffers
              + tp * (3 * ew + hid + 1))                 # the tail's tile
        nf = (nf + 3) & ~3
        nt = ew * pad(nproj) + h * pad(ew) + ew * pad(hid) + hid * pad(ew)
        return nf * 4 + nt * it

    for tp in ((l,) if l <= 64 else ()) + (32, 16, 8):
        if smem(tp) <= 227 * 1024:
            return smem(tp)
    return smem(8)


@pytest.mark.parametrize("h", [1, 2, 4, 6, 8, 16, 32, 64, 128])
def test_merged_takes_every_shape_the_row_kernel_took(dev, h):
    """Every shape whose shared memory fitted 227 KB in the old
    one-block-a-graph row kernel (`_row_smem`, the layout the first K7 and
    K6 ran), at l 1-256, edge widths 8-256, FFN hidden 1x and 2x the edge
    width, f32 and bf16, gets a layout of K4's body and a geometry of K5's
    body for the f32 hand-off (K6's mono switch keeps K7's layout), and
    passes K7's and K6's own checks."""
    for dt in (torch.float32, torch.bfloat16):
        for dh in sorted({h, 2 * h, 7 * h, max(64, h) // h * h, 768 // h * h}):
            for ew in (8, 10, 48, 64, 80, 96, 128, 136, 256):
                for hid in (ew, 2 * ew):
                    for gated in (True, False):
                        for l in range(1, 257):
                            if _row_smem(dt, l, ew, h, dh, hid, gated) > \
                                    227 * 1024:
                                continue
                            spec = fl.LayerSpec(
                                l=l, ew=ew, h=h, dh=dh, hidden=hid,
                                gated=gated, constrained=False, clip=None,
                                edge_act=None, act="elu", scale=0.35)
                            where = (str(dt), l, ew, h, dh, hid, gated)
                            t = fl.bwd_tail_geometry(spec, dt, True)
                            assert t is not None, where
                            assert t["smem"] <= 227 * 1024, where
                            if dt == torch.bfloat16:
                                g = fl.bwd_attn_geometry(spec, True)
                                assert g is not None, where
                                w, c, rows = (g["warps"], g["cluster"],
                                              g["rows_per_block"])
                                assert g["smem"] <= 227 * 1024, where
                                assert c * rows >= l > (c - 1) * rows, where
                                assert g["passes"] * w >= rows > \
                                    (g["passes"] - 1) * w, where
                            else:
                                assert fl.bwd_attn_smem(spec, dt) <= \
                                    227 * 1024, where
                            fl.bwd_merged_check(spec, dt)
                            fl.bwd_mono_check(spec, dt)


def test_merged_refuses_a_shape_past_227_kb(dev):
    """A shape no layout of K5's body fits raises a ValueError that names
    the limit, and launches nothing."""
    spec = fl.LayerSpec(l=256, ew=64, h=64, dh=64, hidden=128, gated=True,
                        constrained=False, clip=None, edge_act=None,
                        act="elu", scale=0.35, training=True)
    assert fl.bwd_attn_geometry(spec, f32_handoff=True) is None
    b, l, ew, h, dh = 1, spec.l, spec.ew, spec.h, spec.dh

    def z(*s, dt=torch.bfloat16):
        return torch.zeros(s, device=dev, dtype=dt)

    w = dict(wg=z(ew, h), bg=z(h, dt=torch.float32), wb=z(ew, h),
             bb=z(h, dt=torch.float32), g1=torch.ones(ew, device=dev),
             b1=z(ew, dt=torch.float32), wr=z(h, ew),
             br=z(ew, dt=torch.float32), g2=torch.ones(ew, device=dev),
             b2=z(ew, dt=torch.float32), w1=z(ew, 128),
             bb1=z(128, dt=torch.float32), w2=z(128, ew),
             bb2=z(ew, dt=torch.float32))
    before = fl.BWD_MERGED_KERNEL.launches
    with pytest.raises(ValueError, match="227 KB"):
        fl.fused_layer_bwd_merged(spec, z(b, l, l, ew), z(b, l, 3 * dh),
                                  torch.ones(b, l, device=dev), None, w,
                                  z(b, l, l, h), z(b, l, l, ew), z(b, l, dh))
    assert fl.BWD_MERGED_KERNEL.launches == before


def _mono_args(dev, dtype, shape, gated=True, constrained=True):
    """K6's arguments: K7's without the saved h_hat."""
    args = _merged_args(dev, dtype, shape, gated, constrained)
    return args[:6] + args[7:]


@pytest.mark.parametrize("shape", list(HEAD_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_mono_head_kernel_matches_plain(dev, dtype, shape, clip):
    """K6's head kernel against `mono_head_plain`: the f32 h_hat within the
    tolerance of its dtype (bf16: e_ln rounds to bf16 after LN1's sums in
    another order), rnd(h_hat) likewise, and the clip's in-range flags
    equal (random q and k put no raw logit within an ulp of an edge)."""
    spec, e, qkv, mask, am, w, _ = _layer_case(dev, dtype, True, True,
                                               shape=shape)
    if not clip:
        spec = spec._replace(clip=None)
    before = fl.MONO_HEAD_KERNEL.launches
    out = fl.mono_head(spec, e, qkv, w)
    assert fl.MONO_HEAD_KERNEL.launches == before + 1
    ref = fl.mono_head_plain(spec, e, qkv, w)
    _close(out[0], ref[0], dtype)
    _close(out[1], ref[1], dtype)
    assert out[0].dtype == torch.float32 and out[1].dtype == dtype
    if clip:
        assert out[2].dtype == torch.bool and torch.equal(out[2], ref[2])
        assert bool(ref[2].any()) and not bool(ref[2].all())
    else:
        assert out[2] is None and ref[2] is None


@pytest.mark.parametrize("shape,dtype", [
    pytest.param(s, dt, id=f"{s}-{str(dt)[6:]}")
    for s in LAYER_SHAPES for dt in (torch.float32, torch.bfloat16)] + [
    pytest.param(s, MERGED_SHAPES[s][0], id=s)
    for s in ("kv_global_bf16", "kv_global_f32")])
def test_mono_outputs_bit_identical_across_launches(dev, dtype, shape):
    """K6's three launches sum in a fixed order (partial rows, the
    cluster's ranks in order, no float atomics): two calls agree to the
    bit, one launch counted a call."""
    args = _mono_args(dev, dtype, shape)
    before = fl.BWD_MONO_KERNEL.launches
    assert _same_bwd(fl.fused_layer_bwd_mono(*args),
                     fl.fused_layer_bwd_mono(*args))
    assert fl.BWD_MONO_KERNEL.launches == before + 2


@pytest.mark.parametrize("shape", list(LAYER_SHAPES))
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False)])
def test_mono_f32_equals_head_then_tail_then_attn(dev, constrained, gated,
                                                  shape):
    """In f32, K6 is its three parts run in turn, bit for bit: the head
    kernel, K4 from its h_hat, then K5 under the mono switch (the head's
    f32 h_hat and flags, K4's de_mid and dhh)."""
    spec, e, qkv, mask, am, w, ge, gv, seed = _mono_args(
        dev, torch.float32, shape, gated, constrained)
    out = fl.fused_layer_bwd_mono(spec, e, qkv, mask, am, w, ge, gv, seed)
    hh, hh_w, inrange = fl.mono_head(spec, e, qkv, w)
    assert hh_w is hh
    de_mid, dhh, dw = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)
    split = fl.fused_layer_bwd_attn(spec, e, qkv, mask, am, w, hh, dhh,
                                    de_mid, gv, seed, inrange=inrange)
    assert _same_bwd(out, (*split[:4], {**dw, **split[4]}))


@pytest.mark.parametrize("shape", list(MERGED_SHAPES))
def test_mono_kernel_at_the_edges_of_its_layouts(dev, shape):
    """K6 against its plain version where its bodies take their other
    layouts (K5's kv_global under the mono switch; K4's CUDA-core body,
    in bf16 too), with the draws live, edge activation elu."""
    dtype = MERGED_SHAPES[shape][0]
    args = _mono_args(dev, dtype, shape)
    if shape.startswith("kv_global") and dtype == torch.bfloat16:
        g = fl.bwd_attn_geometry(args[0], f32_handoff=True)
        assert g["kv_global"] == 1 and g["cluster"] == 1
    before = fl.BWD_MONO_KERNEL.launches
    out = fl.fused_layer_bwd_mono(*args)
    assert fl.BWD_MONO_KERNEL.launches == before + 1
    _close_bwd_row_scaled(out, fl.fused_layer_bwd_mono_plain(*args), dtype)


def test_mono_refuses_a_shape_past_227_kb(dev):
    """A shape no layout of K5's body fits raises a ValueError that names
    the limit, and launches nothing."""
    spec = fl.LayerSpec(l=256, ew=64, h=64, dh=64, hidden=128, gated=True,
                        constrained=False, clip=(-5.0, 5.0), edge_act=None,
                        act="elu", scale=0.35, training=True)
    assert fl.bwd_attn_geometry(spec, f32_handoff=True) is None
    b, l, ew, h, dh = 1, spec.l, spec.ew, spec.h, spec.dh

    def z(*s, dt=torch.bfloat16):
        return torch.zeros(s, device=dev, dtype=dt)

    w = dict(wg=z(ew, h), bg=z(h, dt=torch.float32), wb=z(ew, h),
             bb=z(h, dt=torch.float32), g1=torch.ones(ew, device=dev),
             b1=z(ew, dt=torch.float32), wr=z(h, ew),
             br=z(ew, dt=torch.float32), g2=torch.ones(ew, device=dev),
             b2=z(ew, dt=torch.float32), w1=z(ew, 128),
             bb1=z(128, dt=torch.float32), w2=z(128, ew),
             bb2=z(ew, dt=torch.float32))
    before = fl.BWD_MONO_KERNEL.launches
    with pytest.raises(ValueError, match="227 KB"):
        fl.fused_layer_bwd_mono(spec, z(b, l, l, ew), z(b, l, 3 * dh),
                                torch.ones(b, l, device=dev), None, w,
                                z(b, l, l, ew), z(b, l, dh))
    assert fl.BWD_MONO_KERNEL.launches == before


# (b, l, ew, h, hidden): 4 * 7 * 7 pairs is not a multiple of the 32-pair
# tile. The rest take each branch of K8's bf16 body in both h_hat layouts:
# h 12 (no multiple of 8: element loads of rows) with l 6 (tiles straddle
# graphs, head-major units at and off 16-byte boundaries), h 16 with l 12
# (every head-major unit one 16-byte copy), ew 8, 48, 80 and 128 (8 and 16
# n8 tiles a lane; 128: fewer warps a block), odd l and pair counts no
# multiple of the 16-pair tile. ew 160 (hidden 160) takes the CUDA-core
# body in bf16. In f32 the CUDA-core body's f32 weights pass 227 KB at ew
# 128 with hidden 256 and at ew 160: no body fits and the launch is
# refused.
EDGE_SHAPES = {"awkward": (4, 7, 32, 4, 64), "flagship": (8, 40, 64, 8, 128),
               "h12_ew48_l6": (3, 6, 48, 12, 96),
               "h16_ew8_l12": (4, 12, 8, 16, 16),
               "h4_ew80_l5": (5, 5, 80, 4, 160),
               "h16_ew128_l11": (3, 11, 128, 16, 256),
               "h8_ew160_l6": (2, 6, 160, 8, 160)}


def _edge_case(dev, dtype, head_major, shape):
    g_ = _gen(dev)
    b, l, ew, h, hid = EDGE_SHAPES[shape]

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    w = dict(wr=rnd(h, ew, scale=0.3).to(dtype), br=rnd(ew, scale=0.1),
             g2=1 + rnd(ew, scale=0.1), b2=rnd(ew, scale=0.1),
             w1=rnd(ew, hid, scale=0.2).to(dtype), bb1=rnd(hid, scale=0.1),
             w2=rnd(hid, ew, scale=0.2).to(dtype), bb2=rnd(ew, scale=0.1))
    hh = rnd(b, h, l, l, scale=2.0).to(dtype)
    hh = hh.permute(0, 2, 3, 1) if head_major else \
        hh.permute(0, 2, 3, 1).contiguous()
    e, g = rnd(b, l, l, ew).to(dtype), rnd(b, l, l, ew).to(dtype)
    return hh, e, g, w


def _edge_geometry(dtype, head_major, shape):
    """K8's body for the shape from its geometry query, asserted: the
    tensor cores in bf16 up to ew 128, else the CUDA cores; None (no body
    fits 227 KB) only in f32 at ew 128 and past."""
    _, _, ew, h, hid = EDGE_SHAPES[shape]
    geo = eb.fwd_geometry(dtype, ew, h, hid, head_major)
    if geo is None:
        assert dtype == torch.float32 and ew >= 128
        return None
    assert geo["smem"] <= 227 * 1024
    assert geo["tensor_cores"] == int(dtype == torch.bfloat16 and ew <= 128)
    return geo


@pytest.mark.parametrize("shape", list(EDGE_SHAPES))
@pytest.mark.parametrize("head_major", [False, True], ids=["rows", "head_major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_block_kernels_match_plain(dev, dtype, head_major, shape):
    """K8 and K9 against their plain versions; h_hat as rows and as a view of
    a head-major tensor (K9 writes dhh in the same layout). K8's body is the
    one its geometry query names; where none fits, the launch raises and
    counts nothing. K9 runs where one of its bodies takes the shape (its
    bf16 body stops at ew 128)."""
    geo = _edge_geometry(dtype, head_major, shape)
    hh, e, g, w = _edge_case(dev, dtype, head_major, shape)
    b, l, ew, h, hid = EDGE_SHAPES[shape]
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=h, hidden=hid, gated=False,
                        constrained=False, clip=None, edge_act=None,
                        act="elu", scale=1.0)
    k9 = fl.bwd_tail_geometry(spec, dtype) is not None
    counts = (eb.KERNEL.launches, eb.BWD_KERNEL.launches)
    if geo is None:
        with pytest.raises(RuntimeError, match="edge_block_fwd"):
            eb.edge_block_fwd(hh, e, w)
    else:
        _close(eb.edge_block_fwd(hh, e, w), eb.edge_block_fwd_plain(hh, e, w),
               dtype)
    if k9:
        out = eb.edge_block_bwd(hh, e, g, w)
        ref = eb.edge_block_bwd_plain(hh, e, g, w)
        assert out[0].stride() == hh.stride()
        for o, r in zip(out[:2], ref[:2]):                   # dhh, de_res
            _close(o, r, dtype)
        for k, r in ref[2].items():
            _close(out[2][k], r, dtype, scaled=True)
    assert (eb.KERNEL.launches, eb.BWD_KERNEL.launches) == \
        (counts[0] + (geo is not None), counts[1] + k9)


@pytest.mark.parametrize("shape", ["awkward", "flagship", "h12_ew48_l6",
                                   "h16_ew128_l11"])
@pytest.mark.parametrize("head_major", [False, True], ids=["rows", "head_major"])
def test_edge_block_fwd_bf16_bit_identical_across_launches(dev, head_major,
                                                           shape):
    """K8's bf16 body: two launches give the same bits (no sum depends on
    the schedule)."""
    dtype = torch.bfloat16
    assert _edge_geometry(dtype, head_major, shape)["tensor_cores"] == 1
    hh, e, _, w = _edge_case(dev, dtype, head_major, shape)
    first = eb.edge_block_fwd(hh, e, w)
    assert torch.equal(first, eb.edge_block_fwd(hh, e, w))


@pytest.mark.parametrize("knobs,impl", [
    (dict(fused_attention=True, fused_edge_block=True), "split"),
    (dict(fused_layer=True), "merged"),
    (dict(fused_layer=True), "mono")])
def test_model_training_grads_third_slice_paths(dev, knobs, impl, monkeypatch):
    """As above, for path C (the attention kernel, then the edge block) and
    the whole-layer kernel with the merged and the mono backward."""
    monkeypatch.setattr(fl, "BWD_IMPL", impl)
    cfg = GraphModelConfig(model_width=32, edge_width=64, num_heads=4,
                           model_height=2, upto_hop=3, random_mask_prob=0.1,
                           attn_dropout=0.1)
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(
        EGTGraphModel(dataclasses.replace(cfg, **knobs), device=dev), flat)
    rng = np.random.default_rng(1)
    b, l = 4, 20
    n = rng.integers(5, l + 1, size=b)
    nf = np.where(np.arange(l)[None] < n[:, None], rng.integers(0, 28, (b, l)),
                  -1)
    valid = (nf[:, :, None] >= 0) & (nf[:, None, :] >= 0)
    adj = ((rng.random((b, l, l)) < 0.2) & valid).astype(np.uint8)
    fm = np.where(adj > 0, rng.integers(0, 4, (b, l, l)), -1)
    batch = {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}
    target = torch.randn((b, 1), device=dev)
    kernels = (eb.KERNEL, eb.BWD_KERNEL, fl.BWD_MERGED_KERNEL,
               fl.BWD_MONO_KERNEL)
    before = [k.launches for k in kernels]
    grads = []
    for model in (fast, base):
        loss = (model(batch, training=True, seeds=[3, 4]) - target).abs().mean()
        loss.backward()
        grads.append({k: p.grad for k, p in weights.flat_names(model).items()})
    # path C: K8 in both layers, K9 in the first only (the last layer's edge
    # output feeds no loss); the A paths: one backward kernel a layer
    want = {"split": (2, 1, 0, 0), "merged": (0, 0, 2, 0),
            "mono": (0, 0, 0, 2)}[impl]
    assert tuple(k.launches - c for k, c in zip(kernels, before)) == want
    for k, r in grads[1].items():
        if r is None:      # the last layer's unused edge output: zeros or None
            assert grads[0][k] is None or not grads[0][k].any(), k
            continue
        torch.testing.assert_close(grads[0][k], r, atol=1e-4, rtol=1e-4,
                                   msg=k)


# the other shipped edge widths, with 8 heads, and 80, about the widest the
# first (f32-core) K4 took in bf16, which the bf16 bodies run with 16 n8
# tiles a lane: (ew, dh, b, l); b 5, l 37 gives 6845 pairs, no multiple of
# K4's and K9's 128-pair tile in bf16 (nor of 32 in f32). l 150 (TSP-like
# rows) is longer than the bf16 K3's 8 warps of 16 keys: one query row a
# group, each warp taking several tiles.
WIDTHS = {"ew8_hidden16": (8, 64, 5, 37), "ew48_hidden96": (48, 48, 5, 37),
          "ew80_hidden160": (80, 64, 5, 37), "ew8_l150": (8, 64, 2, 150)}


def _width_case(dev, dtype, ew, dh, b=5, l=37, h=8):
    g_ = _gen(dev)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    def dense(i, o):
        return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

    def ln(n):
        return {"gamma": 1 + rnd(n, scale=0.1), "beta": rnd(n, scale=0.1)}

    p = {"attention_gates": dense(ew, h), "dense_edge_b": dense(ew, h),
         "norm_edge": ln(ew), "dense_edge_r": dense(h, ew),
         "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, 2 * ew),
                      "lr2": dense(2 * ew, ew)}}
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=True,
                        constrained=False, clip=(-2.0, 2.0), edge_act=None,
                        act="elu", scale=float(dh // h) ** -0.5,
                        random_mask_prob=0.1, attn_dropout=0.1, training=True)
    e, qkv = rnd(b, l, l, ew).to(dtype), rnd(b, l, 3 * dh).to(dtype)
    n = torch.tensor([[9], [l], [20], [31], [2]][:b], device=dev)
    mask = (torch.arange(l, device=dev)[None] < n).float()
    hh = (3.0 * rnd(b, l, l, h)).to(dtype)
    ge = rnd(b, l, l, ew).to(dtype)
    return spec, fl.layer_weights(p, dtype), e, qkv, mask, hh, ge


# f32 at ew 80: the f32-core K4 and K9 need more than 227 KB of shared
# memory there, as before
@pytest.mark.parametrize("dtype,width", [
    pytest.param(dt, w, id=f"{str(dt)[6:]}-{w}") for w in WIDTHS
    for dt in (torch.float32, torch.bfloat16)
    if not (dt == torch.float32 and w.startswith("ew80"))])
def test_layer_and_edge_kernels_at_other_widths(dev, dtype, width):
    """K3 (draws live, h_hat out), K4, and K9 with h_hat head-major, each
    against its plain version at edge widths 8, 48 and 80."""
    ew, dh, b, l = WIDTHS[width]
    spec, w, e, qkv, mask, hh, ge = _width_case(dev, dtype, ew, dh, b, l)
    counts = (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
              eb.BWD_KERNEL.launches)
    out = fl.fused_layer_core(spec, e, qkv, mask, None, w, 7, save_hh=True)
    ref = fl.fused_layer_plain(spec, e, qkv, mask, None, w, 7, save_hh=True)
    for o, r in zip(out, ref):
        _close(o, r, dtype)
    tail = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)
    tail_ref = fl.fused_layer_bwd_tail_plain(spec, e, hh, ge, w)
    for o, r in zip(tail[:2], tail_ref[:2]):
        _close(o, r, dtype)
    for k, r in tail_ref[2].items():
        _close(tail[2][k], r, dtype, scaled=True)
    tw = {k: w[k] for k in fl.TAIL_KEYS}
    hm = hh.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    out = eb.edge_block_bwd(hm, e, ge, tw)
    ref = eb.edge_block_bwd_plain(hm, e, ge, tw)
    assert out[0].stride() == hm.stride()
    for o, r in zip(out[:2], ref[:2]):
        _close(o, r, dtype)
    for k, r in ref[2].items():
        _close(out[2][k], r, dtype, scaled=True)
    assert (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
            eb.BWD_KERNEL.launches) == tuple(c + 1 for c in counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_weight_gradients_bit_identical_across_launches(dev, dtype):
    """K4 and K9 sum their weight gradients in a fixed order (per-block
    partial rows, then a second pass): two launches agree to the bit."""
    spec, w, e, _, _, hh, ge = _width_case(dev, dtype, 64, 64, b=4, l=40)
    runs = [fl.fused_layer_bwd_tail(spec, e, hh, ge, w)[2] for _ in range(2)]
    hm = hh.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    tw = {k: w[k] for k in fl.TAIL_KEYS}
    runs += [eb.edge_block_bwd(hm, e, ge, tw)[2] for _ in range(2)]
    for a, b in (runs[:2], runs[2:]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# K5 alone, (b, l, ew, h, dh): the bf16 body spreads a graph's query rows
# over a cluster of blocks, one row a warp, keys padded to 16; l 9 and 41 are
# no multiple of 8 or 16 (a last block with fewer rows, padded keys), ew 48
# the other shipped width of its register body, l 150 several rows a warp.
# The rest run its general body: ew 80, 136 and 256 (64-column chunks), h 16
# gated and h 32 (2h past 16), h 64 and 128 (two and four heads a lane), h 6
# (no divisor of 32), odd dh, ew 10; h 64 at ew 96, l 4 gated takes one warp
# a block (its dW sums in the block's). PATTERN's pads, l 128 and 192 at ew
# 8, take the tiled body (16 keys a warp; l 150 too), and so do l 121 at ew
# 10, h 4, dh 36 (element copies of the row's tiles, the da dot product over
# 9 features) and l 200 at h 1 (one key a lane, 16 features a head); the
# rest take the cluster body
BWD_ATTN_SHAPES = {"flagship": (4, 40, 64, 8, 64), "ew8_l9": (3, 9, 8, 8, 64),
                   "ew48_l41": (3, 41, 48, 8, 48), "ew80_l41": (2, 41, 80, 8, 64),
                   "ew8_l150": (2, 150, 8, 8, 64), "h4_l37": (3, 37, 32, 4, 32),
                   "h16_l41": (2, 41, 64, 16, 64), "h32_l20": (2, 20, 64, 32, 64),
                   "h64_l12": (2, 12, 16, 64, 64), "h128_l9": (2, 9, 8, 128, 128),
                   "ew136_l23": (2, 23, 136, 8, 64),
                   "ew256_h4_l17": (2, 17, 256, 4, 32),
                   "h6_dh18_l13": (3, 13, 24, 6, 18),
                   "h1_dh7_l11": (2, 11, 10, 1, 7),
                   "h64_ew96_l4": (2, 4, 96, 64, 64),
                   "ew8_l128": (3, 128, 8, 8, 64),
                   "ew8_l192": (3, 192, 8, 8, 64),
                   "ew10_h4_dh36_l121": (2, 121, 10, 4, 36),
                   "ew16_h1_dh16_l200": (2, 200, 16, 1, 16)}


def _bwd_attn_case(dev, dtype, shape, gated, constrained):
    g_ = _gen(dev)
    b, l, ew, h, dh = BWD_ATTN_SHAPES[shape]

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    def dense(i, o):
        return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

    p = {"dense_edge_b": dense(ew, h), "dense_edge_r": dense(h, ew),
         "norm_edge": {"gamma": 1 + rnd(ew, scale=0.1), "beta": rnd(ew, scale=0.1)},
         "edge_ffn": {"norm": {"gamma": 1 + rnd(ew, scale=0.1),
                               "beta": rnd(ew, scale=0.1)},
                      "lr1": dense(ew, 2 * ew), "lr2": dense(2 * ew, ew)}}
    if gated:
        p["attention_gates"] = dense(ew, h)
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=gated,
                        constrained=constrained, clip=(-2.0, 2.0),
                        edge_act="elu", act="elu", scale=float(dh // h) ** -0.5,
                        random_mask_prob=0.1, attn_dropout=0.1, training=True)
    n = torch.tensor([[l], [max(1, l // 2)], [min(3, l)], [l - 1]][:b],
                     device=dev)
    mask = (torch.arange(l, device=dev)[None] < n).float()
    am = (torch.rand((b, l, l), generator=g_, device=dev) < 0.4).float() \
        if constrained else None
    # h_hat drawn on its own (3 sigma): pairs beyond the clip, and none
    # within 0.05 of its edges in hh - E, where K5's strict in-range test
    # follows E's last bits (one bf16 rounding of e_ln, taken after LN1's
    # sums in another order, moves E by ~1e-3)
    e, w = rnd(b, l, l, ew).to(dtype), fl.layer_weights(p, dtype)
    hh = rnd(b, l, l, h, scale=3.0).to(dtype).float()
    d = hh - fl._edge_head(spec, e, w)[5]
    near = ((d - spec.clip[0]).abs() < 0.05) | ((d - spec.clip[1]).abs() < 0.05)
    hh = torch.where(near, hh + 0.25, hh).to(dtype)
    return (spec, e, rnd(b, l, 3 * dh).to(dtype), mask, am, w, hh,
            rnd(b, l, l, h).to(dtype), rnd(b, l, l, ew).to(dtype),
            rnd(b, l, dh).to(dtype), 7)


@pytest.mark.parametrize("shape", list(BWD_ATTN_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("constrained,gated", [(False, True), (True, False),
                                               (True, True)])
def test_bwd_attn_kernel_matches_plain(dev, dtype, constrained, gated, shape):
    """K5 (bf16: the tensor-core body its geometry names, tiled or
    cluster; f32: one block a graph) against its plain version, the draws
    live, edge activation elu; one launch, counted on that body."""
    args = _bwd_attn_case(dev, dtype, shape, gated, constrained)
    before = fl.BWD_ATTN_KERNEL.launches
    body = "f32" if dtype == torch.float32 else \
        fl.bwd_attn_geometry(args[0])["body"]
    bodies = dict(fl.BWD_ATTN_BODIES)
    out = fl.fused_layer_bwd_attn(*args)
    assert fl.BWD_ATTN_KERNEL.launches == before + 1
    assert fl.BWD_ATTN_BODIES == {**bodies, body: bodies[body] + 1}
    ref = fl.fused_layer_bwd_attn_plain(*args)
    for i, (o, r) in enumerate(zip(out[:4], ref[:4])):      # de dq dk dv
        _close(o, r, dtype, scaled=i >= 2)
    assert sorted(out[4]) == sorted(ref[4])
    for k, r in ref[4].items():
        _close(out[4][k], r, dtype, scaled=True)


@pytest.mark.parametrize("shape", ["flagship", "ew8_l150", "ew136_l23",
                                   "h64_ew96_l4", "ew8_l192"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_attn_sums_bit_identical_across_launches(dev, dtype, shape):
    """dk, dv and the six weight gradients: fixed-order sums (the cluster's
    ranks in order in bf16, per-graph partial rows), no float atomics."""
    args = _bwd_attn_case(dev, dtype, shape, True, True)
    runs = [fl.fused_layer_bwd_attn(*args) for _ in range(2)]
    assert torch.equal(runs[0][2], runs[1][2])
    assert torch.equal(runs[0][3], runs[1][3])
    for k in runs[0][4]:
        assert torch.equal(runs[0][4][k], runs[1][4][k]), k


@pytest.mark.parametrize("shape,body", [("flagship", "cluster"),
                                        ("ew8_l128", "tiled"),
                                        ("ew8_l192", "tiled")])
def test_bwd_attn_counts_launches_by_body(dev, shape, body):
    """The ZINC flagship keeps the cluster body (8 warps a block there);
    PATTERN's pads take the tiled body, 16 keys a warp, at least 8 warps a
    block; `BWD_ATTN_BODIES` counts each launch on its body."""
    args = _bwd_attn_case(dev, torch.bfloat16, shape, True, False)
    g = fl.bwd_attn_geometry(args[0])
    assert g["body"] == body and g["warps"] >= 8, g
    assert g["keys_per_warp"] == (16 if body == "tiled" else args[0].l), g
    before = dict(fl.BWD_ATTN_BODIES)
    fl.fused_layer_bwd_attn(*args)
    assert fl.BWD_ATTN_BODIES == {**before, body: before[body] + 1}


def _first_body_bytes(l, ew, h, dh, gated):
    """Shared memory of the first K5 body in bf16 (one block a graph, f32
    staging and a transposed weight copy), as its `Layout` computed it."""
    nproj = 2 * h if gated else h
    floats = (ew * nproj + nproj + 2 * ew + nproj + 2 * ew + 4 * l * dh
              + 2 * dh + 2 * l * ew + l + 11 * l * h + l + h)
    return 4 * ((floats + 3) & ~3) + 2 * (2 * ew * nproj)


@pytest.mark.parametrize("h", [1, 2, 4, 6, 8, 16, 32, 64, 128])
def test_bwd_attn_bf16_takes_every_shape_the_first_body_took(dev, h):
    """Every shape whose bf16 shared memory fitted 227 KB in the first K5
    body (one block a graph) fits in the tiled or the cluster body, at l
    1-256 and edge widths 8-512: every query row has a block and a warp
    (tiled: every key too, 16 a warp), at most 8 blocks a cluster, and the
    geometry's bytes are those the wrapper checks."""
    for dh in sorted({h, 2 * h, 7 * h, max(64, h) // h * h, 768 // h * h}):
        for ew in (8, 10, 48, 64, 80, 96, 128, 136, 256, 512):
            for gated in (True, False):
                for l in range(1, 257):
                    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh,
                                        hidden=2 * ew, gated=gated,
                                        constrained=False, clip=None,
                                        edge_act=None, act="elu", scale=0.35)
                    g = fl.bwd_attn_geometry(spec)
                    smem = fl.bwd_attn_smem(spec, torch.bfloat16)
                    where = (l, ew, h, dh, gated, g)
                    if g is None:
                        assert smem > 227 * 1024, where
                        assert _first_body_bytes(l, ew, h, dh, gated) > \
                            227 * 1024, where
                        continue
                    w, c, rows = g["warps"], g["cluster"], g["rows_per_block"]
                    assert g["smem"] == smem <= 227 * 1024, where
                    assert 1 <= c <= 8, where
                    assert c * rows >= l > (c - 1) * rows, where
                    if g["body"] == "tiled":
                        assert 16 * w >= l > 16 * (w - 1) and w <= 16, where
                        assert g["passes"] == rows, where
                        assert g["keys_per_warp"] == 16, where
                        assert ew <= 16 and h <= 8 and dh % 2 == 0 \
                            and dh <= 64, where
                        assert not g["general"] and not g["kv_global"], where
                        continue
                    assert g["body"] == "cluster", where
                    assert g["keys_per_warp"] == l, where
                    assert 1 <= w <= 8, where
                    assert g["passes"] * w >= rows > (g["passes"] - 1) * w, \
                        where
                    assert g["general"] == (ew > 64 or (2 * h if gated else h)
                                            > 16 or 32 % h != 0), where


def test_bwd_attn_refuses_a_shape_past_227_kb(dev):
    """A shape whose one-warp block needs more than 227 KB, even with k, v,
    dk and dv in device memory (kv_global), raises a ValueError that names
    the limit, and launches nothing."""
    spec = fl.LayerSpec(l=256, ew=64, h=64, dh=64, hidden=128, gated=True,
                        constrained=False, clip=None, edge_act=None,
                        act="elu", scale=0.35, training=True)
    # the warp's per-(key, head) values alone: 3 x 256 x 64 f32, 196 KB
    assert fl.bwd_attn_geometry(spec) is None
    b, l, ew, h, dh = 1, spec.l, spec.ew, spec.h, spec.dh

    def z(*s):
        return torch.zeros(s, device=dev, dtype=torch.bfloat16)

    w = dict(wg=z(ew, h), bg=torch.zeros(h, device=dev), wb=z(ew, h),
             bb=torch.zeros(h, device=dev), g1=torch.ones(ew, device=dev),
             b1=torch.zeros(ew, device=dev))
    before = fl.BWD_ATTN_KERNEL.launches
    with pytest.raises(ValueError, match="227 KB"):
        fl.fused_layer_bwd_attn(spec, z(b, l, l, ew), z(b, l, 3 * dh),
                                torch.ones(b, l, device=dev), None, w,
                                z(b, l, l, h), z(b, l, l, h), z(b, l, l, ew),
                                z(b, l, dh))
    assert fl.BWD_ATTN_KERNEL.launches == before


# The whole-layer kernels at the shapes of the PATTERN / CLUSTER 500k configs
# (edge width 8, hidden 16, 8 heads, width 64) in both length buckets, on a
# small batch with ragged node masks: l 128 is the last length at which the
# bf16 K3 packs several query rows a block, l 192 the first shipped one of
# one row and 8 warps (12 tiles of 16 keys); K5 takes its tiled body there,
# 16 keys a warp (`bwd_attn_geometry`).
SBM_LENGTHS = (128, 192)


def _sbm_layer(dev, dtype, l, b=3, nodes=None):
    """A layer's weights and inputs at edge width 8; graphs of l, l - 60 and
    44 nodes, or with `nodes` (lo, hi) b graphs of a node count drawn in
    that range."""
    g_ = _gen(dev)
    ew, h, dh = 8, 8, 64

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    def dense(i, o):
        return {"kernel": rnd(i, o, scale=0.3), "bias": rnd(o, scale=0.1)}

    def ln(n):
        return {"gamma": 1 + rnd(n, scale=0.1), "beta": rnd(n, scale=0.1)}

    p = {"attention_gates": dense(ew, h), "dense_edge_b": dense(ew, h),
         "norm_edge": ln(ew), "dense_edge_r": dense(h, ew),
         "edge_ffn": {"norm": ln(ew), "lr1": dense(ew, 2 * ew),
                      "lr2": dense(2 * ew, ew)}}
    spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=True,
                        constrained=False, clip=(-5.0, 5.0), edge_act=None,
                        act="elu", scale=float(dh // h) ** -0.5,
                        random_mask_prob=0.1, attn_dropout=0.1, training=True)
    w = fl.layer_weights(p, dtype)
    e, qkv = rnd(b, l, l, ew).to(dtype), rnd(b, l, 3 * dh).to(dtype)
    n = torch.tensor([[l], [l - 60], [44]][:b], device=dev) if nodes is None \
        else torch.randint(nodes[0], nodes[1] + 1, (b, 1), generator=g_,
                           device=dev)
    mask = (torch.arange(l, device=dev)[None] < n).float()
    # h_hat drawn on its own, none of it within 0.05 of the clip's edges in
    # hh - E (see `_bwd_attn_case`)
    hh = rnd(b, l, l, h, scale=3.0).to(dtype).float()
    d = hh - fl._edge_head(spec, e, w)[5]
    near = ((d - spec.clip[0]).abs() < 0.05) | ((d - spec.clip[1]).abs() < 0.05)
    hh = torch.where(near, hh + 0.25, hh).to(dtype)
    cot = (rnd(b, l, l, ew).to(dtype), rnd(b, l, dh).to(dtype))
    return spec, w, e, qkv, mask, hh, cot


@pytest.mark.parametrize("l", SBM_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_layer_kernels_at_sbm_shapes(dev, dtype, l):
    """K3 at inference and in training (draws live, h_hat out), K4 and K5
    against their plain versions at the SBM shapes; K4's and K5's sums
    bit-identical across two launches."""
    _check_whole_layer(dev, dtype, l)


# The pads of the superpixel configs (MNIST 75, CIFAR10 150: edge width 8,
# hidden 16, 8 heads, width 64): 75 is no multiple of 8, and neither
# length's f32 mask row (300 and 600 bytes) of 16; K3's last 16-row tile is
# partial at both, and K5's layout at l 150 lies between l 128's and 192's.
SP_LENGTHS = (75, 150)


@pytest.mark.parametrize("l", SP_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_layer_kernels_at_superpixel_shapes(dev, dtype, l):
    """K3, K4 and K5 as `test_whole_layer_kernels_at_sbm_shapes` checks
    them, at the superpixel pads."""
    _check_whole_layer(dev, dtype, l)


# The TSP configs (100k and 500k: edge width 8, hidden 16, 8 heads, width
# 64) at their batch of 8 in the three length buckets, each graph of its
# bucket's node range (the data: 50-500 points). At l 256 and 512 no layout
# of K5's bf16 body with k, v, dk and dv in shared memory fits 227 KB: it
# keeps them in device memory (kv_global), one block a graph.
TSP_BUCKETS = {128: (50, 128), 256: (129, 256), 512: (257, 500)}


@pytest.mark.parametrize("l", list(TSP_BUCKETS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whole_layer_kernels_at_tsp_shapes(dev, dtype, l):
    """K3, K4 and K5 as `test_whole_layer_kernels_at_sbm_shapes` checks
    them, at the TSP batch and pads."""
    _check_whole_layer(dev, dtype, l, b=8, nodes=TSP_BUCKETS[l])


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("l", (256, 512))
def test_bwd_attn_takes_kv_global_at_tsp_lengths(dev, l, gated):
    """At l 512 K5's bf16 body keeps k, v, dk and dv in device memory, one
    block a graph (the cluster body's kv_global); at l 256 the tiled body
    takes the shape, 16 warps of 16 keys, a cluster of 8 blocks a graph."""
    spec = fl.LayerSpec(l=l, ew=8, h=8, dh=64, hidden=16, gated=gated,
                        constrained=False, clip=(-5.0, 5.0), edge_act=None,
                        act="elu", scale=8 ** -0.5, training=True)
    g = fl.bwd_attn_geometry(spec)
    if l == 256:
        assert g is not None and g["body"] == "tiled", g
        assert g["warps"] == 16 and g["cluster"] == 8, g
        assert g["rows_per_block"] == 32 and not g["kv_global"], g
        return
    assert g is not None and g["kv_global"] and g["cluster"] == 1, g
    assert g["rows_per_block"] == l and not g["general"], g


def _check_whole_layer(dev, dtype, l, b=3, nodes=None):
    spec, w, e, qkv, mask, hh, (ge, gv) = _sbm_layer(dev, dtype, l, b, nodes)
    counts = (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
              fl.BWD_ATTN_KERNEL.launches)
    infer = spec._replace(training=False)
    for o, r in zip(fl.fused_layer_core(infer, e, qkv, mask, None, w),
                    fl.fused_layer_plain(infer, e, qkv, mask, None, w)):
        _close(o, r, dtype)
    out = fl.fused_layer_core(spec, e, qkv, mask, None, w, 7, save_hh=True)
    ref = fl.fused_layer_plain(spec, e, qkv, mask, None, w, 7, save_hh=True)
    for o, r in zip(out, ref):
        _close(o, r, dtype)
    tail = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)
    tail_ref = fl.fused_layer_bwd_tail_plain(spec, e, hh, ge, w)
    for o, r in zip(tail[:2], tail_ref[:2]):
        _close(o, r, dtype)
    for k, r in tail_ref[2].items():
        _close(tail[2][k], r, dtype, scaled=True)
    de_mid, dhh = tail_ref[:2]
    args = (spec, e, qkv, mask, None, w, hh, dhh, de_mid, gv, 7)
    att_ = fl.fused_layer_bwd_attn(*args)
    att_ref = fl.fused_layer_bwd_attn_plain(*args)
    for i, (o, r) in enumerate(zip(att_[:4], att_ref[:4])):   # de dq dk dv
        _close(o, r, dtype, scaled=i >= 2)
    for k, r in att_ref[4].items():
        _close(att_[4][k], r, dtype, scaled=True)
    assert (fl.KERNEL.launches, fl.BWD_TAIL_KERNEL.launches,
            fl.BWD_ATTN_KERNEL.launches) == (counts[0] + 2, counts[1] + 1,
                                             counts[2] + 1)
    again = fl.fused_layer_bwd_tail(spec, e, hh, ge, w)[2]
    assert all(torch.equal(tail[2][k], again[k]) for k in again)
    again = fl.fused_layer_bwd_attn(*args)
    assert torch.equal(att_[2], again[2]) and torch.equal(att_[3], again[3])
    assert all(torch.equal(att_[4][k], again[4][k]) for k in again[4])
    if dtype == torch.bfloat16:
        g = fl.bwd_attn_geometry(spec)
        assert g is not None and not g["general"]
        assert g["cluster"] * g["rows_per_block"] >= l


# the custom ops an exported artifact calls (`ops/custom_ops.py`), through
# their CUDA kernels at the flagship shapes: K3 (b 128, l 40, ew 64, h 8, dh
# 64, hidden 128), K1 (b 128, h 8, l 40, d 8) and K8 (b 128, l 40, ew 64, h
# 8, hidden 128, h_hat head-major as path C hands it over)
@pytest.mark.parametrize("kernel", ["K3", "K1", "K8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_match_plain(dev, dtype, kernel):
    g_ = _gen(dev)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=g_, device=dev)

    b, l, ew, h, dh, hid = 128, 40, 64, 8, 64, 128
    mask = (torch.arange(l, device=dev)[None] < torch.randint(
        9, l + 1, (b, 1), generator=g_, device=dev)).float()
    w = dict(wg=rnd(ew, h, scale=0.3).to(dtype), bg=rnd(h, scale=0.1),
             wb=rnd(ew, h, scale=0.3).to(dtype), bb=rnd(h, scale=0.1),
             g1=1 + rnd(ew, scale=0.1), b1=rnd(ew, scale=0.1),
             wr=rnd(h, ew, scale=0.3).to(dtype), br=rnd(ew, scale=0.1),
             g2=1 + rnd(ew, scale=0.1), b2=rnd(ew, scale=0.1),
             w1=rnd(ew, hid, scale=0.2).to(dtype), bb1=rnd(hid, scale=0.1),
             w2=rnd(hid, ew, scale=0.2).to(dtype), bb2=rnd(ew, scale=0.1))
    e = rnd(b, l, l, ew).to(dtype)
    if kernel == "K3":
        spec = fl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=True,
                            constrained=False, clip=(-5.0, 5.0),
                            edge_act=None, act="elu",
                            scale=float(dh // h) ** -0.5)
        qkv = rnd(b, l, 3 * dh).to(dtype)
        kern = fl.KERNEL
        run = lambda: custom_ops.layer_forward(spec, e, qkv, mask, None, w)
        ref = fl.fused_layer_plain(spec, e, qkv, mask, None, w)
    elif kernel == "K1":
        q, k, v = (rnd(b, h, l, dh // h).to(dtype) for _ in range(3))
        eh, gh = rnd(b, h, l, l).to(dtype), rnd(b, h, l, l).to(dtype)
        madd = (mask - 1.0) * 1e9
        kern = att.KERNEL
        run = lambda: custom_ops.attention_forward(
            q, k, v, eh, gh, madd, None, (-5.0, 5.0), att.OFF)
        ref = att.egt_core_fwd_plain(q, k, v, eh, gh, madd, None,
                                     (-5.0, 5.0))
    else:
        hh = rnd(b, h, l, l, scale=2.0).to(dtype).permute(0, 2, 3, 1)
        tail = {key: w[key] for key in eb.KEYS}
        kern = eb.KERNEL
        run = lambda: (custom_ops.edge_forward(hh, e, tail),)
        ref = (eb.edge_block_fwd_plain(hh, e, tail),)
    before = kern.launches
    out = run()
    assert kern.launches == before + 1
    for o, r in zip(out, ref):
        _close(o, r, dtype)


# the model API's variants on their kernel paths: cross-talk, BatchNorm and
# gelu (`can_fuse_layer` refuses each: K1 / K2), and the encodings with
# `readout_edges` on path A (K3 / K4 / K5) and path C (K1, K8 / K9, K2; the
# readout reads the last layer's edge output, so K9 runs in both layers)
VARIANTS = {
    "variant_x": (dict(node2edge_xtalk=0.5, edge2node_xtalk=0.5,
                       node_normalization="batch", edge_normalization="batch",
                       activation="gelu"),
                  dict(fused_attention=True), dict(K1=2, K2=2)),
    "variant_e_path_a": (dict(max_degree_enc=3, max_diffuse_t=2,
                              node2edge_embed=True, include_xpose=True,
                              readout_edges=True),
                         dict(fused_layer=True), dict(K3=2, K4=2, K5=2)),
    "variant_e_path_c": (dict(max_degree_enc=3, max_diffuse_t=2,
                              node2edge_embed=True, include_xpose=True,
                              readout_edges=True),
                         dict(fused_attention=True, fused_edge_block=True),
                         dict(K1=2, K8=2, K9=2, K2=2)),
}
COUNTERS = {"K1": att.KERNEL, "K2": att.BWD_KERNEL, "K3": fl.KERNEL,
            "K4": fl.BWD_TAIL_KERNEL, "K5": fl.BWD_ATTN_KERNEL,
            "K8": eb.KERNEL, "K9": eb.BWD_KERNEL}


def _variant_batch(rng, b=4, l=20):
    n = rng.integers(5, l + 1, size=b)
    nf = np.where(np.arange(l)[None] < n[:, None], rng.integers(0, 28, (b, l)),
                  -1)
    valid = (nf[:, :, None] >= 0) & (nf[:, None, :] >= 0)
    adj = ((rng.random((b, l, l)) < 0.2) & valid).astype(np.uint8)
    fm = np.where(adj > 0, rng.integers(0, 4, (b, l, l)), -1)
    return {"node_features": nf, "feature_matrix": fm, "graph_matrix": adj}


def _variant_models(dev, variant, knobs, **over):
    cfg = GraphModelConfig(model_width=32, edge_width=64, num_heads=4,
                           model_height=2, upto_hop=3, random_mask_prob=0.1,
                           attn_dropout=0.1, **variant, **over)
    base = EGTGraphModel(cfg, device=dev)
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(base).items()}
    fast = weights.load_flat_params(
        EGTGraphModel(dataclasses.replace(cfg, **knobs), device=dev), flat)
    return fast, base


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_kernel_paths_match_plain(dev, name):
    """f32, training with the draws live: the loss, every gradient and the
    moving-statistics updates of the kernel path against the plain path,
    the kernels each launched once a layer; then the outputs at
    inference."""
    variant, knobs, want = VARIANTS[name]
    fast, base = _variant_models(dev, variant, knobs)
    batch = _variant_batch(np.random.default_rng(2))
    target = torch.randn((4, 1), device=dev)
    before = {k: c.launches for k, c in COUNTERS.items()}
    runs = []
    for model in (fast, base):
        out, ctx = model(batch, training=True, seeds=[3, 4],
                         with_context=True)
        loss = (out - target).abs().mean()
        loss.backward()
        runs.append((loss, {k: p.grad for k, p in
                            weights.flat_names(model).items()},
                     ctx.stats_updates))
        if model is fast:
            assert {k: c.launches - before[k] for k, c in COUNTERS.items()} \
                == {k: want.get(k, 0) for k in COUNTERS}
    (lf, gf, sf), (lb, gb, sb) = runs
    torch.testing.assert_close(lf, lb, atol=1e-5, rtol=1e-5)
    for k, r in gb.items():
        if r is None:
            assert gf[k] is None or not gf[k].any(), k
            continue
        torch.testing.assert_close(gf[k], r, atol=1e-4, rtol=1e-4, msg=k)
    assert sorted(sf) == sorted(sb)
    for path, upd in sb.items():
        for key, v in upd.items():
            torch.testing.assert_close(sf[path][key], v, atol=1e-5,
                                       rtol=1e-5)
    with torch.no_grad():
        torch.testing.assert_close(fast.eval()(batch), base.eval()(batch),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", [True, "dots"])
def test_remat_gradients_bit_equal_on_path_a(dev, mode):
    """Path A (K3; K4, K5), f32, the draws live: with `remat` the loss and
    every gradient equal the step without it bit for bit, and K3 runs twice
    a layer (the forward's and the recompute's)."""
    plain, _ = _variant_models(dev, {}, dict(fused_layer=True))
    flat = {k: p.detach().cpu().numpy()
            for k, p in weights.flat_names(plain).items()}
    remat = weights.load_flat_params(EGTGraphModel(
        dataclasses.replace(plain.cfg, remat=mode), device=dev), flat)
    batch = _variant_batch(np.random.default_rng(3))
    target = torch.randn((4, 1), device=dev)
    runs = []
    for model in (plain, remat):
        k3 = fl.KERNEL.launches
        loss = (model(batch, training=True, seeds=[5, 6]) - target).abs().mean()
        loss.backward()
        runs.append((loss, fl.KERNEL.launches - k3,
                     {k: p.grad for k, p in model.named_parameters()}))
    (l0, n0, g0), (l1, n1, g1) = runs
    assert (n0, n1) == (2, 4)
    assert torch.equal(l0, l1)
    for k, g in g0.items():
        assert (g is None and g1[k] is None) or torch.equal(g, g1[k]), k


def test_edge_partitioned_forward_on_two_ranks_of_one_card(dev, tmp_path):
    """Two ranks on this card over gloo (`parallel/launch.py`), each with
    half the query rows, give the unsharded forward through K1 (f32, the
    attention kernel's tolerance); K1 runs once a layer on every rank."""
    from egt_torch.parallel.launch import spawn_ranks
    from tests import torch_parallel_ranks as ranks

    cfg = GraphModelConfig(model_width=32, edge_width=16, num_heads=4,
                           model_height=2, upto_hop=3, fused_attention=True,
                           readout_edges=True, max_degree_enc=4)
    model = EGTGraphModel(cfg, device=dev)
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: p.detach().cpu().numpy()
                      for k, p in weights.flat_names(model).items()})
    batch = _variant_batch(np.random.default_rng(4))
    with torch.no_grad():
        ref = model(batch).cpu().numpy()
    out = spawn_ranks(ranks.sp_forward, 2, dataclasses.asdict(cfg), path,
                      batch, timeout=300)
    for y, launches in out:
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)
        assert launches == cfg.model_height
