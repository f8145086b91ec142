// Fused edge block of one EGT layer, backward by recomputation, for sm_90a.
//
// Replaces: egt_tpu/ops/edge_block_pallas.py::_bwd_kernel, called through
// _rows_bwd (the custom VJP of fused_edge_block).
//
// From the saved inputs hh (h) and e_res (ew) and the cotangent g of the
// output, for every pair: recompute e_mid, the LayerNorm and the ELU FFN,
// run their backward, write dhh and de_res (= de_mid: the residual passes
// it on) in the working type, and sum the eight weight gradients
// (dWr, dbr, dgamma, dbeta, dW1, db1, dW2, db2) over all pairs in f32. This
// is the chain of the whole-layer tail backward with the activation fixed
// to ELU, so the kernel is tail_bwd.cuh's tail_bwd_kernel, which
// fused_layer_bwd_tail.cu (K4) launches too; here hh and dhh may be in the
// attention kernel's head-major (b, h, l, l) layout, read and written in
// place.
//
// What bounds it on an H100: at the ZINC-500k shape (204,800 pairs, ew 64,
// h 8, hidden 128, bf16) it moves ~85 MB (hh, e_res and g in; dhh and
// de_res out), ~25 us at 3.35 TB/s, and does ~17 GFLOP of products, ~18 us
// at the bf16 tensor-core peak: bytes bound it. The bf16 body runs its
// products on the tensor cores (mma.sync), the f32 body on the CUDA cores;
// h_hat head-major is read and written two bytes at a time.
//
// Design: see tail_bwd.cuh. The TPU kernel sums the weight gradients in
// VMEM across its in-order grid; here each block of a persistent grid keeps
// them in shared memory, writes one partial row, and a second pass adds the
// rows in a fixed order: no float atomics, reruns are bit-identical.

#include "tail_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. hh and dhh (pairs, h) as rows when hh_l
// is 0, else head-major (b, h, l, l) with l = hh_l; e, g and de (pairs, ew);
// the weight matrices in the working type, the vectors f32. dw receives
// [dwr | dbr | dg2 | db2 | dw1 | dbb1 | dw2 | dbb2] (f32); `partials` is f32
// scratch of max_grid rows of that length. Launches the kernel and the
// partial-sum pass; returns cudaGetLastError().
extern "C" int edge_block_bwd(
    int dtype, const void* hh, const void* e, const void* g, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, void* dhh, void* de,
    float* dw, float* partials, int max_grid, long long pairs, int ew, int h,
    int hid, int hh_l, void* stream) {
  egt::TailParams p{e, hh, g, wr, br, g2, b2, w1, bb1, w2, bb2, de, dhh,
                    partials, pairs, ew, h, hid, 0, /*elu*/ 1, 0.f, hh_l};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return egt::tail_bwd_launch<float>(p, dw, max_grid, s);
  if (dtype == 1) return egt::tail_bwd_launch<__nv_bfloat16>(p, dw, max_grid, s);
  return (int)cudaErrorInvalidValue;
}
