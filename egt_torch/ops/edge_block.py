"""Fused edge tail of one EGT layer with hand-written CUDA kernels, forward
and backward.

Port of `egt_tpu/ops/edge_block_pallas.py` (`fused_edge_block`,
`edge_block_apply`, `_fwd_kernel`, `_bwd_kernel`):

    e_mid = h_hat @ Wr + br + e_res            (dense_edge_r + residual)
    e_out = ELU(LN(e_mid) @ W1 + b1) @ W2 + b2 + e_mid   (edge FFN + residual)

over the flattened (b, l, l) pairs. Products take working-type operands into
f32 sums; the LayerNorm (eps 1e-3) and the activation are f32; LN(e_mid) and
the hidden activation are rounded to the working type before their products.
The activation is ELU whatever the model's activation is, as in the JAX
kernel. Each op dispatches on the device of its inputs: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel (or raises):
`csrc/edge_block_fwd.cu` (K8) forward, `csrc/edge_block_bwd.cu` (K9) the
backward by recomputation from the saved inputs. `EdgeBlockFn` is the
`torch.autograd.Function` around them. K8 has two bodies: in bf16 up to
edge width 128 the tensor-core body (K3's tail chain, `edge_tail_mma.cuh`),
otherwise the CUDA-core body; `fwd_geometry` says which takes a shape.

h_hat is (b, l, l, h) as in JAX. Where it is a view of the attention
kernel's head-major (b, h, l, l) h_hat, both kernels read it, and K9 writes
its gradient, in that layout: no copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from .fused_layer import TAIL_KEYS as KEYS
from .fused_layer import tail_bwd, tail_fwd, tail_out

KERNEL = _cuda.CudaKernel("edge_block_fwd", _cuda.argtypes(
    "i pp pppp pppp p L iiii"))
BWD_KERNEL = _cuda.CudaKernel("edge_block_bwd", _cuda.argtypes(
    "i ppp pppp pppp pp pp i L iiii"))


@functools.lru_cache(maxsize=None)
def _fwd_geometry(code: int, ew: int, h: int, hid: int,
                  head_major: int) -> tuple | None:
    out = (ctypes.c_int * 3)()
    if KERNEL.query("edge_block_fwd_geometry", "iiiiip", code, ew, h, hid,
                    head_major, ctypes.addressof(out)):
        return None
    return tuple(out)


def fwd_geometry(dtype, ew: int, h: int, hid: int,
                 head_major: bool = False) -> dict | None:
    """Which of K8's bodies takes a shape, from the kernel's own rule:
    `tensor_cores` (1 the bf16 body, 0 the CUDA-core body), `warps` a block
    and `smem` bytes a block; `head_major` for h_hat as a view of a
    (b, h, l, l) tensor. None when no body fits 227 KB."""
    g = _fwd_geometry(_cuda.DTYPE_CODES[dtype], ew, h, hid, int(head_major))
    return None if g is None else dict(zip(("tensor_cores", "warps", "smem"),
                                           g))


def edge_block_fwd_plain(hh, e_res, w):
    """Plain PyTorch version of K8 (`_fwd_kernel`): e_out in the working
    type. w holds {wr, br, g2, b2, w1, bb1, w2, bb2}: matrices in the
    working type, vectors f32."""
    return tail_out(tail_fwd("elu", hh, e_res, w), w).to(e_res.dtype)


def edge_block_bwd_plain(hh, e_res, g, w):
    """Plain PyTorch version of K9 (`_bwd_kernel`): recompute the chain from
    (hh, e_res), then its backward from g. Returns dhh, de_res (= de_mid) in
    the working type and the eight f32 weight gradients."""
    de_mid, dhh, dw = tail_bwd("elu", e_res, hh, g, w)
    return dhh.to(e_res.dtype), de_mid.to(e_res.dtype), dw


def _layout(hh) -> int:
    """The kernels' hh layout code: 0 for (b, l, l, h) rows, l for a view of
    a head-major (b, h, l, l) tensor."""
    if hh.is_contiguous():
        return 0
    if hh.permute(0, 3, 1, 2).is_contiguous():
        return hh.shape[1]
    raise ValueError("edge block: h_hat must be contiguous as (b, l, l, h) "
                     "or as (b, h, l, l)")


def _check(hh, e_res, w):
    dt = e_res.dtype
    if dt not in _cuda.DTYPE_CODES:
        raise ValueError(f"edge block: unsupported dtype {dt}")
    b, l, _, h = hh.shape
    ew = e_res.shape[-1]
    hid = w["w1"].shape[1]
    hm = _layout(hh)
    _cuda.check_cuda("hh", hh.permute(0, 3, 1, 2) if hm else hh,
                     (b, h, l, l) if hm else (b, l, l, h), dt)
    _cuda.check_cuda("e_res", e_res, (b, l, l, ew), dt)
    shapes = dict(wr=(h, ew), w1=(ew, hid), w2=(hid, ew), br=(ew,), g2=(ew,),
                  b2=(ew,), bb1=(hid,), bb2=(ew,))
    for k in KEYS:
        _cuda.check_cuda(k, w[k], shapes[k],
                         dt if k.startswith("w") else torch.float32)
    return b * l * l, ew, h, hid, hm


def _edge_block_fwd_cuda(hh, e_res, w):
    n, ew, h, hid, hm = _check(hh, e_res, w)
    out = torch.empty_like(e_res)
    KERNEL(_cuda.DTYPE_CODES[e_res.dtype], hh.data_ptr(), e_res.data_ptr(),
           *(w[k].data_ptr() for k in KEYS), out.data_ptr(), n, ew, h, hid,
           hm)
    return out


@_cuda.dispatch(edge_block_fwd_plain, _edge_block_fwd_cuda)
def edge_block_fwd(hh, e_res, w):
    """e_out: K8 on CUDA tensors, its plain version on CPU tensors."""


def _edge_block_bwd_cuda(hh, e_res, g, w):
    n, ew, h, hid, hm = _check(hh, e_res, w)
    _cuda.check_cuda("g", g, e_res.shape, e_res.dtype)
    dhh = torch.empty_like(hh)             # keeps hh's layout
    de = torch.empty_like(e_res)
    sizes = (h * ew, ew, ew, ew, ew * hid, hid, hid * ew, ew)
    dw = torch.empty(sum(sizes), dtype=torch.float32, device=g.device)
    max_grid = 2 * torch.cuda.get_device_properties(
        g.device).multi_processor_count
    partials = torch.empty((max_grid, dw.numel()), dtype=torch.float32,
                           device=g.device)
    BWD_KERNEL(_cuda.DTYPE_CODES[e_res.dtype], hh.data_ptr(),
               e_res.data_ptr(), g.data_ptr(),
               *(w[k].data_ptr() for k in KEYS), dhh.data_ptr(),
               de.data_ptr(), dw.data_ptr(), partials.data_ptr(), max_grid,
               n, ew, h, hid, hm)
    shapes = dict(wr=(h, ew), w1=(ew, hid), w2=(hid, ew))
    return dhh, de, {k: x.view(shapes.get(k, (-1,)))
                     for k, x in zip(KEYS, torch.split(dw, sizes))}


@_cuda.dispatch(edge_block_bwd_plain, _edge_block_bwd_cuda)
def edge_block_bwd(hh, e_res, g, w):
    """(dhh, de_res, dw): K9 on CUDA tensors, its plain version on CPU
    tensors."""


class EdgeBlockFn(torch.autograd.Function):
    """The edge block with its backward by recomputation (the counterpart
    of the JAX `_edge_block_rows` custom VJP): K8 forward, K9 backward; only
    the inputs are saved. Gradients come back in their input's dtype."""

    @staticmethod
    def forward(ctx, hh, e_res, *wts):
        ctx.save_for_backward(hh, e_res, *wts)
        return edge_block_fwd(hh, e_res, dict(zip(KEYS, wts)))

    @staticmethod
    def backward(ctx, g):
        hh, e_res, *wts = ctx.saved_tensors
        w = dict(zip(KEYS, wts))
        dhh, de, dw = edge_block_bwd(hh, e_res, g.contiguous(), w)
        return (dhh, de, *(dw[k].to(w[k].dtype) for k in KEYS))


def edge_block_apply(p_layer, h_hat, e_res):
    """Run the fused block from a layer's parameters (dense_edge_r and
    edge_ffn {norm, lr1, lr2}), casting as the JAX `edge_block_apply` does:
    h_hat and the matrices to the working type of e_res, the vectors as
    stored. With gradients enabled the call goes through `EdgeBlockFn`;
    without, through the custom op `torch.ops.egt.edge_block_fwd`
    (`custom_ops.py`)."""
    dt = e_res.dtype
    ffn = p_layer["edge_ffn"]
    w = dict(wr=p_layer["dense_edge_r"]["kernel"].to(dt),
             br=p_layer["dense_edge_r"]["bias"],
             g2=ffn["norm"]["gamma"], b2=ffn["norm"]["beta"],
             w1=ffn["lr1"]["kernel"].to(dt), bb1=ffn["lr1"]["bias"],
             w2=ffn["lr2"]["kernel"].to(dt), bb2=ffn["lr2"]["bias"])
    w = {k: x.contiguous() for k, x in w.items()}
    hh = h_hat.to(dt)
    if not (hh.is_contiguous() or hh.permute(0, 3, 1, 2).is_contiguous()):
        hh = hh.contiguous()
    args = (hh, e_res.contiguous())
    wts = [w[k] for k in KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*args, *wts)):
        return EdgeBlockFn.apply(*args, *wts)
    from . import custom_ops
    return custom_ops.edge_forward(*args, w)
