// Whole EGT layer, backward of the edge tail (dense_edge_r + residual ->
// LayerNorm -> FFN + residual), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_tail_kernel, called
// through _fused_layer_bwd_call_split (the first of the two split-backward
// kernels).
//
// For every pair p = (b, i, j), with e (.., ew), the saved h_hat hh (.., h)
// and the cotangent g of e_out, all in the working type, it recomputes
// e_mid, the LayerNorm and the FFN from the saved hh (attention is not
// recomputed), runs their backward, writes de_mid and dhh in the working
// type and sums the eight weight gradients over all pairs in f32: the math
// and the kernel are in tail_bwd.cuh (tail_bwd_kernel), which
// edge_block_bwd.cu (K9) shares.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, hidden 128, bf16) it moves ~85 MB (e, hh and g in; de_mid and
// dhh out), ~25 us at 3.35 TB/s, and does ~17 GFLOP of products (the FFN
// recompute, its two backward products and the weight gradients), ~18 us
// at the bf16 tensor-core peak: bytes bound it. The bf16 body runs its
// products on the tensor cores (mma.sync); the f32 body, exact f32, on the
// CUDA cores (67 TFLOP/s), where those FLOPs set its time. tail_bwd.cuh
// says what bounds the bf16 body now.

#include "tail_bwd.cuh"

// Which body takes a shape, in bytes of shared memory up to 227 KB: out =
// [1 for the tensor-core body (bf16), warps a block there or pairs a tile
// in the CUDA-core body, 1 with the transposed weight copies, shared memory
// bytes a block]. f32_handoff 1 asks for K7's (de_mid and dhh written in
// f32), which in bf16 also takes the CUDA-core body where the tensor-core
// one does not fit. Returns 0, or 1 (out untouched) when no body does.
extern "C" long long fused_layer_bwd_tail_geometry(int dtype, int ew, int h,
                                                   int hid, int f32_handoff,
                                                   int* out) {
  const size_t optin = 227 * 1024;
  if (dtype == 1) {
    const int nw = egt::tail_mma_warps(ew, h, hid, optin);
    if (nw > 0) {
      out[0] = 1; out[1] = nw; out[2] = 0;
      out[3] = (int)egt::TailMmaLayout(ew, h, hid, nw).bytes;
      return 0;
    }
    if (!f32_handoff) return 1;
  }
  const egt::TailLayout L = dtype == 1
      ? egt::tail_simt_layout<__nv_bfloat16>(ew, h, hid, optin)
      : egt::tail_simt_layout<float>(ew, h, hid, optin);
  if (L.tp == 0) return 1;
  out[0] = 0; out[1] = L.tp; out[2] = L.copies ? 1 : 0;
  out[3] = (int)(dtype == 1 ? L.bytes<__nv_bfloat16>() : L.bytes<float>());
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. e, g (pairs, ew), hh (pairs, h) and the
// weight matrices (wr (h, ew), w1 (ew, hid), w2 (hid, ew)) are in the
// working type; br, g2, b2, bb1, bb2 are f32. Writes de_mid (pairs, ew) and
// dhh (pairs, h) in the working type and dw, the f32 weight gradients
// [dwr | dbr | dg2 | db2 | dw1 | dbb1 | dw2 | dbb2]. `partials` is f32
// scratch of max_grid rows of that length. Launches the kernel and the
// partial-sum pass; returns cudaGetLastError().
extern "C" int fused_layer_bwd_tail(
    int dtype, const void* e, const void* hh, const void* g, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, void* demid,
    void* dhh, float* dw, float* partials, int max_grid, long long pairs,
    int ew, int h, int hid, int act, float act_alpha, void* stream) {
  egt::TailParams p{e, hh, g, wr, br, g2, b2, w1, bb1, w2, bb2, demid, dhh,
                    partials, pairs, ew, h, hid, 0, act, act_alpha, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return egt::tail_bwd_launch<float>(p, dw, max_grid, s);
  if (dtype == 1) return egt::tail_bwd_launch<__nv_bfloat16>(p, dw, max_grid, s);
  return (int)cudaErrorInvalidValue;
}
