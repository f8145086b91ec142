"""K5's plain version (`fused_layer_bwd_attn_plain`, the reference that the
bf16 kernel is held to on the card) against torch autograd of the plain
forward, at the shapes that K5's bf16 kernel runs through its general body
rather than its register body: more than 32 heads or a head count that does
not divide 32, 2h past 16 (gated), edge widths past 64 or not a multiple of
8, odd dh. Then the phase ablation's patches of the kernels' sources
(`egt_torch/phase_times.py`): each names its loops by their headers, and
each header occurs as often as it says.

b 2, the random mask and dropout on and off, the edge activation elu, the
logit clip at +-50 (no logit at it: there the strict in-range test on
h_hat - E follows the last bit of E, so autograd and K5 may part); gradients of e, qkv and every weight, f32 at atol =
rtol = 1e-5, as `test_torch_fused_layer_bwd.py::
test_plain_backward_matches_autograd`.
"""

import numpy as np
import pytest
import torch

from egt_torch import phase_times as pt
from egt_torch.ops import _cuda
from egt_torch.ops import fused_layer as tfl
from tests.test_torch_fused_layer import make_params, tree

# (l, ew, h, dh, gated, constrained)
SHAPES = {
    "h32_gated": (7, 16, 32, 64, True, False),    # PCQM4Mv2 large's heads
    "h64_ungated": (6, 16, 64, 64, False, True),
    "h64_gated": (5, 8, 64, 128, True, False),
    "h128_ungated": (5, 8, 128, 128, False, False),
    "h16_gated_ew96": (9, 96, 16, 32, True, True),
    "h8_ew80": (10, 80, 8, 64, True, False),
    "h8_ew136": (7, 136, 8, 64, True, True),
    "h4_ew256": (5, 256, 4, 32, False, False),
    "h6_dh18": (9, 24, 6, 18, True, True),
    "h1_dh7": (8, 10, 1, 7, False, True),
    "h2_ew10": (11, 10, 2, 8, True, False),
    "h8_ew64_l17": (17, 64, 8, 64, False, True),
}


@pytest.mark.parametrize("draws", [False, True], ids=["no_draws", "draws"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_bwd_attn_matches_autograd(shape, draws):
    l, ew, h, dh, gated, constrained = SHAPES[shape]
    b = 2
    rng = np.random.default_rng(3)
    p = tree(make_params(rng, ew, h, 2 * ew, gated), torch.from_numpy)
    spec = tfl.LayerSpec(
        l=l, ew=ew, h=h, dh=dh, hidden=2 * ew, gated=gated,
        constrained=constrained, clip=(-50.0, 50.0), edge_act="elu", act="elu",
        scale=float(dh // h) ** -0.5,
        random_mask_prob=0.2 if draws else 0.0,
        attn_dropout=0.15 if draws else 0.0, training=True)
    mask = torch.from_numpy(
        (np.arange(l)[None] < np.array([[l], [max(1, l - 3)]])
         ).astype(np.float32))
    am = (torch.from_numpy((rng.random((b, l, l)) > 0.4).astype(np.float32))
          if constrained else None)
    w = {k: (None if x is None else x.clone().requires_grad_())
         for k, x in tfl.layer_weights(p, torch.float32).items()}
    te = torch.from_numpy(rng.normal(size=(b, l, l, ew)).astype(np.float32)
                          ).requires_grad_()
    tq = torch.from_numpy(2.5 * rng.normal(size=(b, l, 3 * dh)).astype(
        np.float32)).requires_grad_()
    ge = torch.from_numpy(rng.normal(size=(b, l, l, ew)).astype(np.float32))
    gv = torch.from_numpy(rng.normal(size=(b, l, dh)).astype(np.float32))
    eo, vo, hh = tfl.fused_layer_plain(spec, te, tq, mask, am, w, seed=5,
                                       save_hh=True)
    ((eo * ge).sum() + (vo * gv).sum()).backward()
    with torch.no_grad():
        de_mid, dhh, dw = tfl.fused_layer_bwd_tail_plain(spec, te, hh, ge, w)
        de, dq, dk, dv, dw_head = tfl.fused_layer_bwd_attn_plain(
            spec, te, tq, mask, am, w, hh, dhh, de_mid, gv, seed=5)
    dw.update(dw_head)

    def close(out, ref, msg):
        atol = 1e-5 * max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=atol, msg=msg)

    close(de, te.grad, "de")
    close(torch.stack([dq, dk, dv], dim=2).reshape(tq.shape), tq.grad, "dqkv")
    for k, x in w.items():
        if x is not None:
            close(dw[k], x.grad, k)


@pytest.mark.parametrize("kernel", list(pt.PHASES))
def test_phase_ablation_patches_the_loops_it_names(kernel):
    _, files, phases = pt.PHASES[kernel]
    texts = {f: (_cuda._CSRC / f).read_text() for f in files}
    out = pt._patch(texts, phases)
    for name, headers in phases.items():
        assert sum(t.count(f"(SKIP_{name.upper()} ? 0 : ")
                   for t in out.values()) == sum(headers.values()), name
    header = next(iter(next(iter(phases.values()))))
    with pytest.raises(RuntimeError, match="occurs"):
        pt._patch({**texts, files[0]: texts[files[0]] + header}, phases)
