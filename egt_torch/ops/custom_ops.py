"""The three forward kernels as PyTorch custom operators.

- `torch.ops.egt.fused_layer_fwd`: K3, the whole-layer forward without
  h_hat (`fused_layer.fused_layer_core`);
- `torch.ops.egt.attention_fwd`: K1, the attention core forward
  (`egt_attention.egt_core_fwd`);
- `torch.ops.egt.edge_block_fwd`: K8, the edge tail forward
  (`edge_block.edge_block_fwd`).

Each op has the plain PyTorch version as its CPU kernel and the
hand-written kernel as its CUDA kernel (which launches or raises: no
fallback), and a fake kernel that only gives the outputs' shapes, so that
`torch.export` traces a model through the op and a loaded artifact calls
it. An op takes tensors, ints, floats, bools and strings only: the helpers
below flatten a `LayerSpec`, the `Draws` and the weight dicts into its
arguments. The no-grad branches of `fused_layer_apply`,
`egt_attention_fused` and `edge_block_apply` call these helpers, so eager
serving and an exported artifact run the same route; training keeps the
`autograd.Function`s.

This module imports the three kernel modules and nothing of the model,
the schemes, the training or the config code: a loader of an exported
artifact (`egt_torch.serving.load_serving`) imports it alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import edge_block as eb
from . import egt_attention as att
from . import fused_layer as fl
from .rng import Draws

NAMESPACE = "egt"
# the op of each forward kernel, as it appears in an exported graph
OPS = {"K3": "egt.fused_layer_fwd.default", "K1": "egt.attention_fwd.default",
       "K8": "egt.edge_block_fwd.default"}


# ---------------------------------------------------------------- K3 (whole layer)


def _layer_spec(e, qkv, amask, wg, w1, h, has_clip, lo, hi, edge_act, act,
                mask_p, drop_p) -> fl.LayerSpec:
    dh = qkv.shape[-1] // 3
    return fl.LayerSpec(
        l=e.shape[1], ew=e.shape[-1], h=h, dh=dh, hidden=w1.shape[1],
        gated=wg is not None, constrained=amask is not None,
        clip=(lo, hi) if has_clip else None, edge_act=edge_act or None,
        act=act, scale=float(dh // h) ** -0.5, random_mask_prob=mask_p,
        attn_dropout=drop_p, training=mask_p > 0.0 or drop_p > 0.0)


def _layer_impl(core, e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, wr, br,
                g2, b2, w1, bb1, w2, bb2, h, has_clip, lo, hi, edge_act, act,
                seed, mask_p, drop_p):
    spec = _layer_spec(e, qkv, amask, wg, w1, h, has_clip, lo, hi, edge_act,
                       act, mask_p, drop_p)
    w = dict(zip(fl.W_KEYS, (wg, bg, wb, bb, g1, b1, wr, br, g2, b2, w1,
                             bb1, w2, bb2)))
    e_out, v_att = core(spec, e, qkv, mask, amask, w, seed)
    return e_out.contiguous(), v_att.contiguous()


@torch.library.custom_op(f"{NAMESPACE}::fused_layer_fwd", mutates_args=(),
                         device_types="cpu")
def fused_layer_fwd(e: Tensor, qkv: Tensor, mask: Tensor,
                    amask: Optional[Tensor], wg: Optional[Tensor],
                    bg: Optional[Tensor], wb: Tensor, bb: Tensor, g1: Tensor,
                    b1: Tensor, wr: Tensor, br: Tensor, g2: Tensor,
                    b2: Tensor, w1: Tensor, bb1: Tensor, w2: Tensor,
                    bb2: Tensor, h: int, has_clip: bool, lo: float,
                    hi: float, edge_act: str, act: str, seed: int,
                    mask_p: float, drop_p: float) -> tuple[Tensor, Tensor]:
    """(e_out, v_att) of K3; the plain version on the CPU. `edge_act` ""
    is none."""
    return _layer_impl(fl.fused_layer_plain, e, qkv, mask, amask, wg, bg,
                       wb, bb, g1, b1, wr, br, g2, b2, w1, bb1, w2, bb2, h,
                       has_clip, lo, hi, edge_act, act, seed, mask_p, drop_p)


@fused_layer_fwd.register_kernel("cuda")
def _fused_layer_fwd_cuda(e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, wr,
                          br, g2, b2, w1, bb1, w2, bb2, h, has_clip, lo, hi,
                          edge_act, act, seed, mask_p, drop_p):
    return _layer_impl(fl._fused_layer_cuda, e, qkv, mask, amask, wg, bg,
                       wb, bb, g1, b1, wr, br, g2, b2, w1, bb1, w2, bb2, h,
                       has_clip, lo, hi, edge_act, act, seed, mask_p, drop_p)


@fused_layer_fwd.register_fake
def _fused_layer_fwd_fake(e, qkv, *args):
    b, l = e.shape[:2]
    return (e.new_empty(e.shape),
            e.new_empty((b, l, qkv.shape[-1] // 3)))


def layer_forward(spec: fl.LayerSpec, e, qkv, mask, amask, w, seed: int = 0):
    """(e_out, v_att) through `torch.ops.egt.fused_layer_fwd`: the arguments
    of `fused_layer_core` (without h_hat), flattened."""
    clip = spec.clip if spec.clip is not None else (0.0, 0.0)
    mask_p, drop_p = ((spec.random_mask_prob, spec.attn_dropout)
                      if spec.training else (0.0, 0.0))
    return torch.ops.egt.fused_layer_fwd(
        e, qkv, mask, amask, *(w[k] for k in fl.W_KEYS), spec.h,
        spec.clip is not None, float(clip[0]), float(clip[1]),
        spec.edge_act or "", spec.act, int(seed), float(mask_p),
        float(drop_p))


# ------------------------------------------------------------ K1 (attention core)


def _attention_impl(core, q, k, v, e, g, madd, maddf, has_clip, lo, hi, seed,
                    mask_p, drop_p):
    v_att, h_hat, deg = core(q, k, v, e, g, madd, maddf,
                             (lo, hi) if has_clip else None,
                             Draws(seed, mask_p, drop_p))
    if deg is None:
        deg = madd.new_empty((0,))
    return v_att.contiguous(), h_hat.contiguous(), deg.contiguous()


@torch.library.custom_op(f"{NAMESPACE}::attention_fwd", mutates_args=(),
                         device_types="cpu")
def attention_fwd(q: Tensor, k: Tensor, v: Tensor, e: Tensor,
                  g: Optional[Tensor], madd: Tensor, maddf: Optional[Tensor],
                  has_clip: bool, lo: float, hi: float, seed: int,
                  mask_p: float, drop_p: float) -> tuple[Tensor, Tensor,
                                                         Tensor]:
    """(v_att, h_hat, degrees) of K1; the plain version on the CPU. The
    degrees are empty when the attention is ungated."""
    return _attention_impl(att.egt_core_fwd_plain, q, k, v, e, g, madd,
                           maddf, has_clip, lo, hi, seed, mask_p, drop_p)


@attention_fwd.register_kernel("cuda")
def _attention_fwd_cuda(q, k, v, e, g, madd, maddf, has_clip, lo, hi, seed,
                        mask_p, drop_p):
    return _attention_impl(att._egt_core_fwd_cuda, q, k, v, e, g, madd,
                           maddf, has_clip, lo, hi, seed, mask_p, drop_p)


@attention_fwd.register_fake
def _attention_fwd_fake(q, k, v, e, g, madd, *args):
    b, h, lq, _ = q.shape
    deg = (madd.new_empty((b, h, lq)) if g is not None
           else madd.new_empty((0,)))
    return q.new_empty(q.shape), q.new_empty((b, h, lq, k.shape[2])), deg


def attention_forward(q, k, v, e, g, madd, maddf, clip, draws: Draws):
    """(v_att, h_hat, degrees or None) through `torch.ops.egt.attention_fwd`:
    the arguments of `egt_core_fwd`, flattened."""
    lo, hi = clip if clip is not None else (0.0, 0.0)
    v_att, h_hat, deg = torch.ops.egt.attention_fwd(
        q, k, v, e, g, madd, maddf, clip is not None, float(lo), float(hi),
        int(draws.seed), float(draws.mask_p), float(draws.drop_p))
    return v_att, h_hat, deg if g is not None else None


# ----------------------------------------------------------------- K8 (edge tail)


def _edge_impl(core, hh, e_res, wr, br, g2, b2, w1, bb1, w2, bb2):
    w = dict(zip(eb.KEYS, (wr, br, g2, b2, w1, bb1, w2, bb2)))
    return core(hh, e_res, w).contiguous()


@torch.library.custom_op(f"{NAMESPACE}::edge_block_fwd", mutates_args=(),
                         device_types="cpu")
def edge_block_fwd(hh: Tensor, e_res: Tensor, wr: Tensor, br: Tensor,
                   g2: Tensor, b2: Tensor, w1: Tensor, bb1: Tensor,
                   w2: Tensor, bb2: Tensor) -> Tensor:
    """e_out of K8; the plain version on the CPU. `hh` may be a view of a
    head-major h_hat, as the kernel reads it."""
    return _edge_impl(eb.edge_block_fwd_plain, hh, e_res, wr, br, g2, b2, w1,
                      bb1, w2, bb2)


@edge_block_fwd.register_kernel("cuda")
def _edge_block_fwd_cuda(hh, e_res, wr, br, g2, b2, w1, bb1, w2, bb2):
    return _edge_impl(eb._edge_block_fwd_cuda, hh, e_res, wr, br, g2, b2, w1,
                      bb1, w2, bb2)


@edge_block_fwd.register_fake
def _edge_block_fwd_fake(hh, e_res, *args):
    return e_res.new_empty(e_res.shape)


def edge_forward(hh, e_res, w):
    """e_out through `torch.ops.egt.edge_block_fwd`: the arguments of
    `edge_block.edge_block_fwd`, flattened."""
    return torch.ops.egt.edge_block_fwd(hh, e_res, *(w[k] for k in eb.KEYS))
