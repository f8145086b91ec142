"""The port's CUDA kernels against their plain versions on the card, at small
shapes. Marked `cuda`: they skip on a machine without a GPU. Run on one:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: f32 1e-4 (the sums run in another order);
bf16, compared in the working type, 5e-2 + 2e-2 * |plain| (an order change
can flip one rounding of an intermediate).
"""

import dataclasses

import numpy as np
import pytest
import torch

from egt_torch import weights
from egt_torch.models.graph_model import EGTGraphModel, GraphModelConfig
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


def _close(out, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated,hard", [(True, False), (False, True),
                                        (True, True)])
def test_attention_kernel_matches_plain(dev, dtype, gated, hard):
    g_ = _gen(dev)
    b, h, lq, lk, d = 3, 4, 9, 13, 6

    def rnd(*s):
        return torch.randn(s, generator=g_, device=dev).to(dtype)

    q, k, v = rnd(b, h, lq, d), rnd(b, h, lk, d), rnd(b, h, lk, d)
    e, g = rnd(b, h, lq, lk), rnd(b, h, lq, lk) if gated else None
    madd = (torch.arange(lk, device=dev)[None] < torch.tensor(
        [[5], [13], [9]], device=dev)).float().sub(1).mul(1e9)
    maddf = ((torch.rand((b, lq, lk), generator=g_, device=dev) < 0.5)
             .float() - 1) * 1e9 if hard else None
    args = (q, k, v, e, g, madd, maddf, (-5.0, 5.0))
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
