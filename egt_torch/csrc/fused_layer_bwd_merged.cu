// Whole EGT layer, merged backward from the saved h_hat (K7), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_merged_kernel, called
// through _fused_layer_bwd_call_merged (_BWD_IMPL "merged").
//
// What it computes: the split backward's two halves with de_mid and dhh
// passed on in f32, as the TPU kernel passes them (it reads dhh in f32 and
// adds de_mid unrounded). For every pair (b, i, j), from the saved h_hat
// hh, e and the cotangent g of e_out: the edge tail's backward (tail_bwd.cuh:
// e_mid, LN2 and the FFN recomputed from rnd(hh); de_mid, dhh and the eight
// tail weight gradients), then for every query row the attention and
// edge-head backward (attn_bwd.cuh: LN1, gates and edge bias recomputed,
// the softmax chain re-entered at hh, the clip's strict in-range test on
// hh - E; de, dq, dk, dv and the six head weight gradients), with dhh added
// to dH and de_mid to de in f32. The rounding points are those of the
// plain fused_layer_bwd_merged_plain.
//
// Design: two launches on the caller's stream, both bodies the split's own.
// K4's tensor-core tail body (bf16; the CUDA-core body in f32) writes de_mid
// (b, l, l, ew) and dhh (b, l, l, h) in f32 into scratch the wrapper
// allocates: de_mid unrounded from the registers that computed it, dhh
// from its f32 sums, while the body's own products keep rnd(de_mid). Then
// K5's cluster body (register or general, bf16; the one-block-a-graph body
// in f32) reads them in f32: dhh staged with the row, de_mid loaded by
// each lane straight into the registers that add it. Each launch ends with
// its fixed-order sum of partial rows into its part of dw (tail sums, then
// head sums): no float atomics, a rerun is bit-identical. In f32 the
// hand-off is the split's own, so K7 equals K4 followed by K5 bit for bit.
//
// Why the hand-off goes through L2 / device memory and not shared memory:
// each body already fills one SM with one 8-warp block (K4's ~225 KB of
// weight-gradient sums, weights and staging; K5's ~217 KB of staged rows
// and per-(key, head) values), so the two cannot share a block's shared
// memory without re-deriving both. Handing over in f32 costs bytes: at the
// ZINC-500k training shape (b 128, l 40, ew 64, h 8, bf16) de_mid is
// 52.4 MB and dhh 6.6 MB, written once and read once, ~118 MB or ~35 us at
// 3.35 TB/s. That is the composition's floor above the function's own
// (e, g, hh, qkv and gv in; de, dq, dk, dv out); an on-chip hand-off is
// left for later.
//
// What bounds it now: the two bodies, each latency-bound at one block a SM
// (tail_bwd.cuh, attn_bwd.cuh); the f32 hand-off adds its bytes. Where K4's
// tensor-core body cannot take a shape in bf16 (ew > 128, or past 227 KB
// at one warp), K7 runs K4's CUDA-core body in bf16; where K5's layouts do
// not fit with k, v, dk and dv in shared memory, its kv_global layout: the
// shapes the old one-block-a-graph K7 took all run.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; egt_torch/kernel_times.py, L2
// flushed, draws live, in turns with the one-block-a-graph row kernel it
// replaces): bf16 0.798-0.799 ms at the training shape above, against
// 7.53-7.58 ms; f32 4.158-4.160 ms against 9.505-9.510. In an A-merged
// training step (`EGT_FUSED_BWD=merged python3 -m
// egt_torch.profile_training --path A`) the tail body takes 0.439 ms a
// call and the attention body 0.331 ms, against 0.434 and 0.318 ms for the
// split's bf16 hand-off in the same call: the f32 hand-off's bytes cost
// about 0.02 ms. The composition moves ~235 MB, a floor of 0.070 ms at
// 3.35 TB/s, against the function's own ~88 MB.

#include "attn_bwd.cuh"
#include "tail_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. e, g_eout, de (B, l, l, ew), hh
// (B, l, l, h), qkv (B, l, 3 dh), gv, dq (B, l, dh) and the weight matrices
// (wg, wb (ew, h), wr (h, ew), w1 (ew, hid), w2 (hid, ew)) are in the
// working type; mask (B, l), amask (B, l, l; may be null), the biases and
// LN parameters, dk, dv (B, l, dh), dw and the scratch are f32; ungated, wg
// and bg are null. demid (B, l, l, ew) and dhh (B, l, l, h) are f32 scratch
// for the hand-off. dw receives the tail's sums [dwr | dbr | dg2 | db2 |
// dw1 | dbb1 | dw2 | dbb2] then the head's [dwgb (ew, nproj) | dbgb (nproj)
// | dg1 | db1], nproj = 2h gated ([gates | bias] columns) else h.
// `partials` is f32 scratch of max(max_grid rows of the tail's sums, B rows
// of the head's): the tail's sum pass has read its rows before the second
// body, later on the same stream, writes its own. Returns
// cudaGetLastError() of the first launch that fails, else of the last.
extern "C" int fused_layer_bwd_merged(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, const void* hh,
    const void* geout, const void* gv, float* demid, float* dhh, void* de,
    void* dq, float* dk, float* dv, float* dw, float* partials, int max_grid,
    int B, int l, int ew, int h, int dh, int hid, int gated, int has_clip,
    float lo, float hi, float scale, int edge_act, float edge_alpha, int act,
    float act_alpha, unsigned seed_lo, unsigned seed_hi, float mask_p,
    float drop_p, float keep, void* stream) {
  egt::TailParams tp{e, hh, geout, wr, br, g2, b2, w1, bb1, w2, bb2, demid,
                     dhh, partials, (long long)B * l * l, ew, h, hid, 0, act,
                     act_alpha, 0};
  egt::AttnParams ap{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, hh, dhh,
                     demid, gv, de, dq, dk, dv, partials, B, l, ew, h, dh,
                     gated, has_clip, lo, hi, scale, edge_act, edge_alpha,
                     Draws{seed_lo, seed_hi, mask_p, drop_p, keep}};
  float* dw_head = dw + egt::TailAcc(ew, h, hid).n;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dtype == 0) {
    rc = egt::tail_bwd_launch<float>(tp, dw, max_grid, s);
    return rc ? rc : egt::launch_simt(ap, dw_head, s);
  }
  if (dtype == 1) {
    rc = egt::tail_bwd_launch<__nv_bfloat16, float>(tp, dw, max_grid, s);
    return rc ? rc : egt::launch_bf16<float>(ap, dw_head, s);
  }
  return (int)cudaErrorInvalidValue;
}
