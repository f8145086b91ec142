// Whole EGT layer, backward of the attention and the edge head (softmax,
// sigmoid gate, dropout and clip; dense_edge_b / attention_gates / edge
// LayerNorm), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_attn_kernel, called
// through _fused_layer_bwd_call_split (the second of the two split-backward
// kernels, after fused_layer_bwd_tail.cu).
//
// For every query row it recomputes the edge head (LN1, gates, edge bias),
// re-enters the softmax chain at the saved h_hat, runs the softmax / gate /
// dropout / clip backward and the edge-head backward, and adds de_mid and
// dhh as the tail kernel wrote them, in the working type: the math, the
// bodies and their design are in attn_bwd.cuh, which
// fused_layer_bwd_merged.cu (K7) and fused_layer_bwd_mono.cu (K6) share.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, dh 64, bf16) it moves ~91 MB (e, de_mid and de; hh and dhh;
// q, k, v, gv, dq, dk, dv), ~27 us at 3.35 TB/s, against ~1.4 GFLOP of
// products: bytes bound it. In bf16 one of two bodies takes a shape, by the
// shape alone: the tiled body (16 keys a warp, a block a graph's keys and a
// range of its rows) at the long pads of narrow edges, the SBM, superpixel
// and TSP l <= 256 pads, and the cluster body (a query row a warp) at every
// other shape; attn_bwd.cuh gives both designs, what bounds each and their
// measured times.

#include "attn_bwd.cuh"

// Shared memory the kernel needs, in bytes: f32 the one-block-a-graph
// body's; bf16 the tiled body's where it takes the shape, else the cluster
// body's at the most warps a block that fit in 227 KB (at one warp and
// kv_global, above 227 KB, when none does). The wrapper checks it.
extern "C" long long fused_layer_bwd_attn_smem(int dtype, int l, int ew, int h,
                                               int dh, int gated) {
  if (dtype == 0)
    return (long long)egt::attn_simt_layout(l, ew, h, dh, gated).bytes();
  if (egt::attn_takes_tile(l, ew, h, dh, gated))
    return (long long)egt::AttnTileLayout(l, ew, h, dh, gated).bytes;
  return (long long)egt::attn_mma_layout(l, ew, h, dh, gated, false).bytes;
}

// How the bf16 body spreads one graph, with de_mid and dhh handed over in
// bf16 (K5) or, f32_handoff 1, in f32 (K7, and K6 under its mono switch):
// out = [warps a block, blocks a graph (the cluster), rows a block, rows a
// warp, 1 for the general body, shared memory bytes a block, 1 for
// kv_global, 1 for the tiled body (K5 only), keys a warp takes of a row];
// returns 0, or 1 (out untouched) when no layout fits 227 KB. The one source
// of this layout for the three kernels' wrappers.
extern "C" long long fused_layer_bwd_attn_geometry(int l, int ew, int h,
                                                   int dh, int gated,
                                                   int f32_handoff, int* out) {
  if (!f32_handoff && egt::attn_takes_tile(l, ew, h, dh, gated)) {
    const egt::AttnTileLayout T(l, ew, h, dh, gated);
    out[0] = T.W; out[1] = T.C; out[2] = T.RB; out[3] = T.RB;
    out[4] = 0; out[5] = (int)T.bytes; out[6] = 0; out[7] = 1; out[8] = 16;
    return 0;
  }
  const egt::AttnMmaLayout L =
      egt::attn_mma_layout(l, ew, h, dh, gated, f32_handoff != 0);
  if (L.W == 0) return 1;
  out[0] = L.W; out[1] = L.C; out[2] = L.RB; out[3] = L.P;
  out[4] = L.general ? 1 : 0; out[5] = (int)L.bytes; out[6] = L.kvg ? 1 : 0;
  out[7] = 0; out[8] = l;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. e, de_mid, de (B, l, l, ew), hh, dhh
// (B, l, l, h), qkv (B, l, 3 dh), gv, dq (B, l, dh) and the weight matrices
// wg, wb (ew, h) are in the working type; mask (B, l), amask (B, l, l), the
// biases and LN parameters, dk, dv (B, l, dh) and dw are f32. amask and
// (ungated) wg / bg may be null. dw receives [dwgb (ew, nproj) | dbgb
// (nproj) | dg1 | db1], nproj = 2h gated ([gates | bias] columns) else h;
// `partials` is f32 scratch of B rows of that length. `inrange` (f32 only;
// null otherwise) turns on the mono switch: the clip's in-range test is
// read from these flags (B, l, l, h), one byte a (pair, head), as K6 runs
// the body. Launches the kernel (f32: one block a graph; bf16: a cluster
// of blocks a graph) and the partial-sum pass; returns cudaGetLastError().
extern "C" int fused_layer_bwd_attn(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* hh,
    const void* dhh, const void* demid, const void* gv, void* de, void* dq,
    float* dk, float* dv, float* dw, float* partials,
    const unsigned char* inrange, int B, int l, int ew, int h, int dh,
    int gated, int has_clip, float lo, float hi, float scale, int edge_act,
    float edge_alpha, unsigned seed_lo, unsigned seed_hi, float mask_p,
    float drop_p, float keep, void* stream) {
  egt::AttnParams p{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, hh, dhh,
                    demid, gv, de, dq, dk, dv, partials, B, l, ew, h, dh,
                    gated, has_clip, lo, hi, scale, edge_act, edge_alpha,
                    Draws{seed_lo, seed_hi, mask_p, drop_p, keep}, inrange};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return inrange ? egt::launch_simt<true>(p, dw, s)
                   : egt::launch_simt(p, dw, s);
  if (dtype == 1 && !inrange)
    return egt::launch_bf16<__nv_bfloat16>(p, dw, s);
  return (int)cudaErrorInvalidValue;
}
