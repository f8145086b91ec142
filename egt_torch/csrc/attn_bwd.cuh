// The attention and edge-head backward of an EGT layer, the kernels of
// fused_layer_bwd_attn.cu (K5) and, fed by K4's body, of
// fused_layer_bwd_merged.cu (K7) and fused_layer_bwd_mono.cu (K6).
//
// For every query row (b, i) and key j, head hd (feature f = dd * h + hd):
//   x1 = LN(e) normalised, e_ln = rnd(g1 x1 + b1)
//   G = e_ln . Wg + bg,  P = e_ln . Wb + bb,  E = act_e(P)          (recomputed)
//   softmax chain re-entered at the SAVED h_hat hh (q.k is not recomputed):
//     logits = hh + madd (+ aadd) (+ rmask),  gates = G + madd (+ aadd) (+ rmask)
//     a_sm = softmax_j(logits),  sg = sigmoid(gates),  a = a_sm sg
//     a_drop = kept ? a / keep : 0          (draws regenerated: philox.cuh)
//   da = (gv_i . v_j per head), then / keep where kept, 0 where dropped
//   da_sm = da sg,  dgate = da a_sm sg (1 - sg)
//   dH = a_sm (da_sm - sum_j da_sm a_sm) + dhh      (dhh from the tail kernel)
//   ds = (lo < hh - E < hi) ? dH * scale : 0       (the clip's in-range test,
//                                                    strict, on the saved hh)
//   dq_i = sum_j rnd(ds) k_j;  dk_j += rnd(ds) q_i;  dv_j += rnd(a_drop) gv_i
//   dP = dH act_e'(P);  de_ln = rnd(dP) . Wb^T + rnd(dgate) . Wg^T
//   de = LN backward of de_ln + de_mid
// and the weight gradients dWg = e_ln^T rnd(dgate), dbg = sum dgate,
// dWb = e_ln^T rnd(dP), dbb = sum dP, dg1 = sum de_ln x1, db1 = sum de_ln.
// de and dq are written in the working type; dk, dv and the weight
// gradients are f32.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, dh 64, bf16) it moves ~91 MB (e, de_mid and de; hh and dhh;
// q, k, v, gv, dq, dk, dv), ~27 us at 3.35 TB/s, against ~1.4 GFLOP of
// products: bytes bound it.
//
// Two bf16 bodies, chosen by shape (attn_takes_tile; no setting): the tiled
// body (bwd_attn_tile_kernel) takes the shapes of its class (ew <= 16, h <= 8
// dividing 32, nproj <= 16, dh even and <= 64, l <= 256) at which the
// cluster body would seat fewer than 8 warps a block: the SBM pads (l 128,
// 192), the superpixel pads (75, 150) and TSP's l 128 and 256, all at ew 8,
// h 8, dh 64. The cluster body (bwd_attn_mma_kernel) takes every other
// shape: the ZINC flagship (l 40, 8 warps a block), the wide and
// many-headed shapes (its general body), TSP's l 512 (kv_global), and K7's
// and K6's f32 hand-off. The tiled body's design is at its kernel below.
//
// Design of the cluster body (bwd_attn_mma_kernel). dk and dv are sums over a
// graph's query rows and the weight gradients sums over every pair; the TPU
// kernel carried both across its in-order grid of row blocks. Here a
// graph's rows are spread over a thread-block cluster of up to 8 blocks,
// and a warp owns one query row at a time (5 blocks of 8 rows at l 40):
//   - the row's keys are padded to a multiple of 16 with zero rows, so the
//     three edge-head products run on the tensor cores in whole m16 tiles,
//     mma.sync m16n8k16 with f32 sums (mma.cuh): [G | P] = rnd(e_ln) .
//     [Wg | Wb], de_ln = rnd([dgate | dP]) . [Wg | Wb]^T and dW +=
//     rnd(e_ln)^T rnd([dgate | dP]), from ldmatrix reads of the weights as
//     stored (no transposed copy) and of the warp's staging. Every operand
//     already sits at a bf16 rounding point, so only the order of summation
//     changes;
//   - the softmax over a head's keys reduces inside the warp: when h divides
//     32, lane (kg, hd) takes keys kg, kg + 32 / h, ... of head hd and the
//     head's sums are shuffles; otherwise a lane takes every key of heads
//     lane, lane + 32, ... So no block barrier sits in the softmax chain;
//     da = gv . v, dq and the per-head dot products stay on the CUDA cores;
//   - the row's e, hh and dhh are staged with 16-byte cp.async, de_mid a
//     16-key tile at a time, and de goes out 16 bytes a lane;
//   - dk and dv: each block keeps f32 partials for its rows (one thread an
//     element, rows added in row order); after cluster.sync() rank r adds
//     its 1/C share of [dk | dv | weight-gradient sums] over the ranks'
//     shared memory (DSMEM) in rank order and writes it once. The weight
//     gradients are kept per warp (each element one owning lane), added to
//     the block's sums in warp order, reduced across the cluster with dk
//     and dv into one partial row per graph, and the rows summed in a fixed
//     order by launch_sum_partials. No float atomics: a rerun is
//     bit-identical.
// Two instantiations. The register body (ew <= 64, nproj <= 16 and h
// dividing 32: every shipped config) keeps a key tile's whole edge row and
// the warp's dW in mma fragments; e_ln goes from the C-fragment layout of
// LN1 straight into A fragments and is then written over e's own rows, so
// de_mid can run a whole tile ahead in a second buffer. The general body
// takes every other shape: it writes rnd(e_ln) into a tile buffer of its
// own, runs the products in chunks of 64 edge columns and 32 projection
// columns (LN1's backward takes two passes over the chunks, the second
// recomputing de_ln), and keeps dW and [dbg | dbb] in per-warp f32 shared
// memory (in the block's sums when a block has one warp), de_mid one tile
// buffer. Blocks take the most warps (up to 8) whose shared memory fits
// 227 KB; longer graphs loop rows within a warp (several passes of W rows a
// block), so the cluster stays at 8 blocks. At one warp a block the layout
// needs no more shared memory than the first port's one-block-a-graph body
// did, so every shape that body took still runs; a shape that needs more
// than 227 KB at one warp is refused.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; egt_torch/kernel_times.py, L2
// flushed, draws live): 0.342-0.344 ms at the training shape above (the
// register body), against 1.519-1.529 ms for the first port's
// one-block-a-graph body on the CUDA cores, timed in turns with it. What
// bounds it now is latency, not bytes or FLOPs: ~217 KB of shared memory a
// block (most of it the row's staged e and the per-(key, head) values), so
// one 8-warp block a SM. By ablation (`python3 -m egt_torch.phase_times
// K5`) the softmax chain with its Philox draws takes ~0.09 ms, the
// per-head products ~0.06 ms and the tensor-core products ~0.015 ms; with
// all three skipped ~0.20 ms remain: the loads, LN1 and its backward over
// the key tiles, the stores and the cluster's sum. Its shared memory grows
// with l (a block holds the graph's k, v and f32 dk, dv; a warp its row's
// whole key row), so past l ~48 at ew 8 it seats fewer warps: three a
// block at l 128, one at l 192 (4.76 and 37.6 ms at b 128), which is why
// those shapes take the tiled body.
//
// The f32 body (bwd_attn_kernel, exact f32 products on the CUDA cores) is
// the first port's: one block takes one whole graph and loops over its
// query rows; dk and dv sit in shared memory (l x dh f32 each) and are
// written once; the weight-gradient sums are kept per block and written as
// one partial row, summed by the same fixed-order pass. A query row's whole
// key row (l edge rows, l x h logits and gates) lives in shared memory
// between the softmax's forward and backward passes; the graph's k and v
// are cached in shared memory, or, where those four l x dh arrays do not
// fit (kv_global), read from device memory, with dk and dv summed in the
// graph's own rows of the outputs.
//
// The mono switch (K6, template flag MONO): K6 saves no h_hat, so its head
// kernel recomputes it and hands over hh in f32 with one in-range flag byte
// per (pair, head), lo < q.k scale < hi on the raw logit, strict, as the
// TPU kernel tests it. Under the switch both bodies re-enter the softmax
// chain at that f32 hh and take the clip's test from the flags in place of
// lo < hh - E < hi; de_mid and dhh come in f32, as K7's, at K7's layout.
// The bf16 body reads hh and the flags where it uses them, through the
// read-only path, having asked for the row's lines in L1 where K5 and K7
// stage hh: staged in shared memory, they pushed its register body past
// 255 registers into spills (ptxas -v). Without the switch the code is
// K5's and K7's.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace egt {

constexpr int ATT_NT = 256;
constexpr int ATT_SMEM_MAX = 227 * 1024;   // shared memory a block may use

struct AttnParams {
  const void* e; const void* qkv; const float* mask; const float* amask;
  const void* wg; const float* bg; const void* wb; const float* bb;
  const float* g1; const float* b1;
  const void* hh; const void* dhh; const void* demid; const void* gv;
  void* de; void* dq; float* dk; float* dv; float* partials;
  int B, l, ew, h, dh, gated, has_clip;
  float lo, hi, scale;
  int edge_act; float edge_alpha;
  Draws dr;
  const unsigned char* inrange;   // the mono switch's flags (B, l, l, h)
};

// Lets kernel K take `bytes` of dynamic shared memory on the current
// device; the attribute is set again only for a larger size. Internal
// linkage: K5's and K7's libraries both include this header and are loaded
// into one process, and the static of a function template with external
// linkage is one object across them (a GNU unique symbol), so one library
// would skip setting the attribute of the other's kernel.
template <void (*K)(AttnParams)>
static cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// ---------------------------------------------------------------- f32
// kv_global: k, v, dk and dv are read and summed in device memory (the
// block's own rows of dk and dv) instead of shared memory
struct AttnLayout {
  int dwgb, dbgb, dg1, db1, nw;                 // weight-gradient sums
  int vec, k, v, dk, dv, q, gv, x1, eln, rstd;
  int gpre, ppre, ev, hv, lm, sg, dasm, dgt, ds, dp, ad, madd, tsum;
  int wgb, wgbT, n;                             // weights, the total
  bool kvg;
  __host__ __device__ AttnLayout(int l, int ew, int h, int dh, int nproj,
                                 bool kv_global) {
    kvg = kv_global;
    const int kv = kv_global ? 0 : l * dh;
    int o = 0;
    dwgb = o; o += ew * nproj;    // [gates | bias] columns
    dbgb = o; o += nproj;
    dg1 = o;  o += ew;
    db1 = o;  o += ew;
    nw = o;
    vec = o;  o += nproj + 2 * ew;  // bgb g1 b1
    k = o;    o += kv;
    v = o;    o += kv;
    dk = o;   o += kv;
    dv = o;   o += kv;
    q = o;    o += dh;
    gv = o;   o += dh;
    x1 = o;   o += l * ew;
    eln = o;  o += l * ew;          // e_ln, later de_ln
    rstd = o; o += l;
    gpre = o; o += l * h;
    ppre = o; o += l * h;
    ev = o;   o += l * h;
    hv = o;   o += l * h;
    lm = o;   o += l * h;           // logits, then a_sm
    sg = o;   o += l * h;
    dasm = o; o += l * h;
    dgt = o;  o += l * h;
    ds = o;   o += l * h;
    dp = o;   o += l * h;
    ad = o;   o += l * h;
    madd = o; o += l;
    tsum = o; o += h;
    wgb = o;  o += ew * nproj;
    wgbT = o; o += nproj * ew;
    n = o;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)n * sizeof(float);
  }
};

// KVG: k, v, dk and dv in device memory (AttnLayout's kv_global); MONO:
// the clip's test from p.inrange (the mono switch; hh is f32 as it is)
template <bool KVG, bool MONO = false>
__global__ void __launch_bounds__(ATT_NT) bwd_attn_kernel(AttnParams p) {
  constexpr int NT = ATT_NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh;
  const int nproj = p.gated ? 2 * h : h;
  const AttnLayout L(l, ew, h, dh, nproj, KVG);
  const int b = blockIdx.x;
  float *acc = sm, *dwgb = sm + L.dwgb, *dbgb = sm + L.dbgb;
  float *dg1 = sm + L.dg1, *db1 = sm + L.db1;
  float *bgb = sm + L.vec, *g1 = bgb + nproj, *b1 = g1 + ew;
  const float* QKV = (const float*)p.qkv;
  // k and v rows of the graph (stride kst); the block's rows of dk and dv
  const int kst = KVG ? 3 * dh : dh;
  const float* k_s = KVG ? QKV + (size_t)b * l * 3 * dh + dh : sm + L.k;
  const float* v_s = KVG ? QKV + (size_t)b * l * 3 * dh + 2 * dh : sm + L.v;
  float* dk_s = KVG ? p.dk + (size_t)b * l * dh : sm + L.dk;
  float* dv_s = KVG ? p.dv + (size_t)b * l * dh : sm + L.dv;
  float *q_s = sm + L.q, *gv_s = sm + L.gv, *x1 = sm + L.x1, *eln = sm + L.eln;
  float *rstd = sm + L.rstd, *gpre = sm + L.gpre, *ppre = sm + L.ppre;
  float *ev = sm + L.ev, *hv = sm + L.hv, *lm = sm + L.lm, *sg = sm + L.sg;
  float *dasm = sm + L.dasm, *dgt = sm + L.dgt, *ds = sm + L.ds;
  float *dp = sm + L.dp, *ad = sm + L.ad, *madd = sm + L.madd;
  float *tsum = sm + L.tsum, *wgb = sm + L.wgb, *wgbT = sm + L.wgbT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool dropping = p.dr.dropping();

  // ---- weights, the graph's k / v and its key mask; zero the sums
  const float* Wg = (const float*)p.wg;
  const float* Wb = (const float*)p.wb;
  for (int t = tid; t < ew * nproj; t += NT) {
    const int c = t / nproj, n = t % nproj;
    const float w = (p.gated && n < h) ? Wg[c * h + n] : Wb[c * h + (n - (nproj - h))];
    wgb[t] = w;
    wgbT[n * ew + c] = w;
  }
  for (int t = tid; t < nproj; t += NT)
    bgb[t] = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
  for (int t = tid; t < ew; t += NT) { g1[t] = p.g1[t]; b1[t] = p.b1[t]; }
  for (int t = tid; t < l * dh; t += NT) {
    const int j = t / dh, f = t % dh;
    if (!KVG) {
      const float* r = QKV + ((size_t)b * l + j) * 3 * dh;
      sm[L.k + t] = r[dh + f];
      sm[L.v + t] = r[2 * dh + f];
    }
    dk_s[t] = 0.f;
    dv_s[t] = 0.f;
  }
  for (int t = tid; t < l; t += NT) madd[t] = (p.mask[(size_t)b * l + t] - 1.f) * 1e9f;
  for (int t = tid; t < L.nw; t += NT) acc[t] = 0.f;

  const float* E = (const float*)p.e;
  const float* HH = (const float*)p.hh;
  const float* DHH = (const float*)p.dhh;
  const float* DM = (const float*)p.demid;
  const float* GV = (const float*)p.gv;
  float* DE = (float*)p.de;
  float* DQ = (float*)p.dq;

  for (int i = 0; i < l; ++i) {
    const size_t row = (size_t)b * l + i;
    const size_t ebase = row * l * ew;          // e[b, i, 0, 0]
    const size_t hbase = row * l * h;           // hh[b, i, 0, 0]
    const float* arow = p.amask ? p.amask + row * l : nullptr;
    __syncthreads();  // setup done; the previous row is done
    for (int t = tid; t < dh; t += NT) {
      q_s[t] = QKV[row * 3 * dh + t];
      gv_s[t] = GV[row * dh + t];
    }
    for (int t = tid; t < l * ew; t += NT) x1[t] = E[ebase + t];
    __syncthreads();

    // ---- edge pre-LN, one warp per key: x1 normalised, e_ln
    for (int j = warp; j < l; j += NT / 32) {
      float* x = x1 + j * ew;
      float s = 0.f;
      for (int c = lane; c < ew; c += 32) s += x[c];
      const float mu = warp_sum(s) / ew;
      float s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float d = x[c] - mu;
        s2 += d * d;
      }
      const float rs = rsqrtf(warp_sum(s2) / ew + LN_EPS);
      for (int c = lane; c < ew; c += 32) {
        const float xv = (x[c] - mu) * rs;
        x[c] = xv;
        eln[j * ew + c] = g1[c] * xv + b1[c];
      }
      if (lane == 0) rstd[j] = rs;
    }
    __syncthreads();

    // ---- gates and edge-bias pre-activations
    tile_gemm<NT>(l, nproj, ew,
        [&](int m, int k) { return eln[m * ew + k]; },
        [&](int k, int n) { return wgb[k * nproj + n]; },
        [&](int m, int n, float y) {
          const float z = y + bgb[n];
          if (p.gated && n < h) gpre[m * h + n] = z;
          else ppre[m * h + (n - (nproj - h))] = z;
        });
    __syncthreads();

    // ---- re-enter the softmax chain at the saved h_hat
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      const float hval = HH[hbase + t];
      const float Ev = act_fn(p.edge_act, p.edge_alpha, ppre[t]);
      ev[t] = Ev;
      hv[t] = hval;
      float add = madd[j];
      if (arow) add += (arow[j] - 1.f) * 1e9f;
      const float rm = p.dr.mask_add(b, i, j, hd);
      lm[t] = hval + add + rm;
      sg[t] = p.gated ? sigmoid(gpre[t] + add + rm) : 1.f;
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < l; j += 32) mx = fmaxf(mx, lm[j * h + hd]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < l; j += 32) {
        const float ex = expf(lm[j * h + hd] - mx);
        lm[j * h + hd] = ex;
        s += ex;
      }
      const float den = fmaxf(warp_sum(s), 1e-30f);
      for (int j = lane; j < l; j += 32) lm[j * h + hd] /= den;
    }
    __syncthreads();

    // ---- dropout and gate backward
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      float da = 0.f;
      for (int dd = hd; dd < dh; dd += h) da = fmaf(gv_s[dd], v_s[j * kst + dd], da);
      const float a_sm = lm[t], s = sg[t];
      float a = p.gated ? a_sm * s : a_sm;
      if (dropping) {
        const bool kp = p.dr.kept(b, i, j, hd);
        da = kp ? da / p.dr.keep : 0.f;
        a = kp ? a / p.dr.keep : 0.f;
      }
      ad[t] = a;
      if (p.gated) {
        dasm[t] = da * s;
        dgt[t] = da * a_sm * s * (1.f - s);
      } else {
        dasm[t] = da;
        dgt[t] = 0.f;
      }
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float s = 0.f;
      for (int j = lane; j < l; j += 32) s += dasm[j * h + hd] * lm[j * h + hd];
      s = warp_sum(s);
      if (lane == 0) tsum[hd] = s;
    }
    __syncthreads();

    // ---- softmax and clip backward; edge-bias activation backward
    for (int t = tid; t < l * h; t += NT) {
      const int hd = t % h;
      const float dH = lm[t] * (dasm[t] - tsum[hd]) + DHH[hbase + t];
      float d = dH * p.scale;
      if (p.has_clip) {
        if constexpr (MONO) {
          if (!p.inrange[hbase + t]) d = 0.f;
        } else {
          const float sc = hv[t] - ev[t];
          if (!(sc > p.lo && sc < p.hi)) d = 0.f;
        }
      }
      ds[t] = d;
      dp[t] = dH * act_grad(p.edge_act, p.edge_alpha, ppre[t], ev[t]);
    }
    __syncthreads();

    // ---- dq, dk, dv
    for (int f = tid; f < dh; f += NT) {
      const int hd = f % h;
      float s = 0.f;
      for (int j = 0; j < l; ++j) s = fmaf(ds[j * h + hd], k_s[j * kst + f], s);
      DQ[row * dh + f] = s;
    }
    for (int t = tid; t < l * dh; t += NT) {
      const int j = t / dh, f = t % dh, hd = f % h;
      dk_s[t] = fmaf(ds[j * h + hd], q_s[f], dk_s[t]);
      dv_s[t] = fmaf(ad[j * h + hd], gv_s[f], dv_s[t]);
    }

    // ---- head weight gradients: dW[gb] += e_ln^T [dgate | dP], db[gb]
    auto dcol = [&](int j, int n) {
      return (p.gated && n < h) ? dgt[j * h + n] : dp[j * h + (n - (nproj - h))];
    };
    tile_gemm<NT>(ew, nproj, l,
        [&](int m, int k) { return eln[k * ew + m]; },
        [&](int k, int n) { return dcol(k, n); },
        [&](int m, int n, float y) { dwgb[m * nproj + n] += y; });
    for (int n = tid; n < nproj; n += NT) {
      float s = 0.f;
      for (int j = 0; j < l; ++j) s += dcol(j, n);
      dbgb[n] += s;
    }
    __syncthreads();  // e_ln is read above; de_ln replaces it below

    // ---- de_ln = [dgate | dP] . [Wg | Wb]^T
    tile_gemm<NT>(l, ew, nproj,
        [&](int m, int k) { return dcol(m, k); },
        [&](int k, int n) { return wgbT[k * ew + n]; },
        [&](int m, int n, float y) { eln[m * ew + n] = y; });
    __syncthreads();
    for (int c = tid; c < ew; c += NT) {
      float s = 0.f, s2 = 0.f;
      for (int j = 0; j < l; ++j) {
        s += eln[j * ew + c] * x1[j * ew + c];
        s2 += eln[j * ew + c];
      }
      dg1[c] += s;
      db1[c] += s2;
    }
    // ---- edge LayerNorm backward + de_mid, one warp per key
    for (int j = warp; j < l; j += NT / 32) {
      const float* d = eln + j * ew;
      const float* xr = x1 + j * ew;
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        s += dx;
        s2 += dx * xr[c];
      }
      const float m1 = warp_sum(s) / ew, m2 = warp_sum(s2) / ew;
      const float rs = rstd[j];
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        const size_t o = ebase + (size_t)j * ew + c;
        DE[o] = (dx - m1 - xr[c] * m2) * rs + DM[o];
      }
    }
  }
  __syncthreads();
  if (!KVG)
    for (int t = tid; t < l * dh; t += NT) {
      p.dk[(size_t)b * l * dh + t] = dk_s[t];
      p.dv[(size_t)b * l * dh + t] = dv_s[t];
    }
  float* part = p.partials + (size_t)b * L.nw;
  for (int t = tid; t < L.nw; t += NT) part[t] = acc[t];
}

// ---------------------------------------------------------------- bf16
// The tensor-core body. A graph's query rows are spread over a cluster of
// C blocks (cluster rank r takes rows r RB .. r RB + RB - 1); a block of W
// warps takes W rows at a time, one a warp. Shared memory:
//   block f32:  the reduced values [dk (l, dh) | dv (l, dh) | the weight-
//               gradient sums in output order], the biases [bg | bb] (NPK),
//               g1, b1 (EK each, zero-padded) and the key mask's additive
//               term (LK);
//   warp f32:   per (key, head) of the warp's row: s0 (logit, exp, a_sm),
//               s1 (gate pre-activation, sigmoid, da_sm), P (pre-activation
//               of the edge bias); per key: mean and rstd of LN1; the warp's
//               dg1 / db1 column sums (EK each); general body: the warp's
//               [dW | dbg, dbb] sums (none at one warp a block: the block's
//               sums take them); f32 hand-off: the row's dhh;
//   block bf16: [Wg | Wb] as stored (EK x NPK, zero-padded), k and v of the
//               graph (l x skv);
//   warp bf16:  the row's e (LK x EK; de on its way out, and in the
//               register body a tile's rows take rnd(e_ln) for the dW
//               product once LN1 has read them); de_mid tiles of 16 keys
//               (register body: two, tile t + 1 in flight while tile t is
//               worked; none with the f32 hand-off); rnd([dgate | dP]) of
//               the row (LK x NPK); the row's hh (not under the mono
//               switch) and (bf16 hand-off) dhh;
//               rnd(ds), rnd(a_drop) per (key, head); q_i and gv_i; general
//               body: a 16-key tile of rnd(e_ln).
// LK = l rounded up to 16 (keys past l are zero rows), EK = ew and NPK =
// nproj rounded up to 16 (zero columns). Staged rows are padded by 8
// columns so the eight rows one ldmatrix reads fall in distinct banks.
//
// The f32 hand-off (K7: de_mid and dhh as K4's body wrote them, in f32,
// HT = float): the row's dhh is staged in f32, and de_mid is not staged at
// all: each lane loads the f32 values it adds in LN1's backward straight
// into registers from device memory (L2), in the register body at the start
// of the key tile, ahead of the tile's products. That keeps the block within
// 227 KB where a staged f32 tile would not.
//
// kv_global: where even one warp a block does not fit (long graphs at wide
// dh), k and v are read from device memory, the cluster is one block (C
// 1), and dk and dv are summed in the graph's own rows of the outputs (one
// thread an element, rows in order), so shared memory holds no l x dh
// array. The old one-block-a-graph row kernel took those shapes so.
constexpr int ATT_MMA_WARPS = 8;
constexpr int ATT_MAX_CLUSTER = 8;    // the portable cluster size

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int r8(int n) { return (n + 7) & ~7; }

// Whether a shape takes the general body: the register body holds ew <= 64
// and nproj <= 16 in its fragments and reduces a head over lanes, h | 32
__host__ __device__ inline bool attn_mma_general(int ew, int h, int gated) {
  const int nproj = gated ? 2 * h : h;
  return !(ew <= 64 && nproj <= 16 && 32 % h == 0);
}

struct AttnMmaLayout {
  int W, C, RB, P;                 // warps a block, blocks a graph (the
                                   // cluster), rows a block, rows a warp
  bool general, kvg;
  int LK, EK, NPK, nproj, se, sd, skv, nwg, nkv;
  int red, vec, madd, nfb;                         // block f32 offsets
  int s0, s1, pp, mu, rs, wrow, wdw, dhf, nfw;     // warp f32 offsets
  int w, k, v, nbb;                                // block bf16 offsets
  int erow, tb, dcol, hh, dhh, ds, ad, qb, gb, et, nbw;  // warp bf16 offsets
  size_t bytes;
  // f32h: de_mid and dhh handed over in f32; kvg: kv_global
  __host__ __device__ AttnMmaLayout(int l, int ew, int h, int dh, int gated,
                                    int W_, bool f32h, bool kvg_) {
    W = W_;
    kvg = kvg_;
    C = kvg ? 1 : (l + W - 1) / W;
    if (C > ATT_MAX_CLUSTER) C = ATT_MAX_CLUSTER;
    RB = (l + C - 1) / C;
    C = (l + RB - 1) / RB;         // no block without a row
    P = (RB + W - 1) / W;
    general = attn_mma_general(ew, h, gated);
    nproj = gated ? 2 * h : h;
    LK = round16(l); EK = round16(ew); NPK = round16(nproj);
    se = EK + 8; sd = NPK + 8; skv = ((dh + 1) & ~1) + 8;
    nwg = ew * nproj + nproj + 2 * ew;
    nkv = kvg ? 0 : 2 * l * dh;      // dk and dv in the reduced values
    int o = 0;
    red = o;  o += r4(nkv + nwg);
    vec = o;  o += r4(NPK + 2 * EK);
    madd = o; o += r4(LK);
    nfb = o;
    o = 0;
    s0 = o;   o += r4(LK * h);
    s1 = o;   o += r4(LK * h);
    pp = o;   o += r4(LK * h);
    mu = o;   o += r4(LK);
    rs = o;   o += r4(LK);
    wrow = o; o += r4(2 * EK);
    wdw = o;  if (general && W > 1) o += r4(ew * nproj + nproj);
    dhf = o;  if (f32h) o += r4(LK * h);
    nfw = o;
    o = 0;
    w = o;    o += r8(EK * sd);
    k = o;    if (!kvg) o += r8(l * skv);
    v = o;    if (!kvg) o += r8(l * skv);
    nbb = o;
    o = 0;
    erow = o; o += LK * se;
    tb = o;   if (!f32h) o += (general ? 16 : 32) * se;
    dcol = o; o += LK * sd;
    hh = o;   o += r8(LK * h);
    dhh = o;  if (!f32h) o += r8(LK * h);
    ds = o;   o += r8(LK * h);
    ad = o;   o += r8(LK * h);
    qb = o;   o += r8(dh);
    gb = o;   o += r8(dh);
    et = o;   if (general) o += 16 * se;
    nbw = o;
    bytes = (size_t)(nfb + W * nfw) * 4 + (size_t)(nbb + W * nbw) * 2;
  }
};

// The layout a shape runs at: the most warps a block (up to 8) whose shared
// memory fits 227 KB, k / v / dk / dv in shared memory where one warp a
// block fits so, else kv_global. W is 0 when no layout fits (at one warp
// and kv_global: the bytes of that layout).
__host__ __device__ inline AttnMmaLayout attn_mma_layout(int l, int ew, int h,
                                                        int dh, int gated,
                                                        bool f32h) {
  for (int kvg = 0; kvg < 2; ++kvg)
    for (int W = ATT_MMA_WARPS; W > 0; --W) {
      const AttnMmaLayout L(l, ew, h, dh, gated, W, f32h, kvg);
      if (L.bytes <= (size_t)ATT_SMEM_MAX) return L;
    }
  AttnMmaLayout L(l, ew, h, dh, gated, 1, f32h, true);
  L.W = 0;
  return L;
}

// One warp stages rows r < nrows of a (rows, w) bf16 matrix at src into S
// (row stride ld): rows r >= nvalid are zeros. 16-byte cp.async copies when
// w is a multiple of 8, else plain loads. The caller commits and waits.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* S, int ld,
                                           const __nv_bfloat16* src,
                                           int nrows, int nvalid, int w) {
  const int lane = threadIdx.x & 31;
  if ((w & 7) == 0) {
    const int cpr = w >> 3;
    for (int t = lane; t < nrows * cpr; t += 32) {
      const int r = t / cpr, c = (t - r * cpr) << 3;
      const bool ok = r < nvalid;
      cp_async16(S + r * ld + c, ok ? src + (size_t)r * w + c : src, ok);
    }
  } else {
    for (int t = lane; t < nrows * w; t += 32) {
      const int r = t / w, c = t - r * w;
      S[r * ld + c] = r < nvalid ? src[(size_t)r * w + c]
                                 : __float2bfloat16_rn(0.f);
    }
  }
}

// One warp stages n contiguous bf16 values (cp.async when n is a multiple
// of 8, which keeps src 16-byte aligned at every row of its tensor)
__device__ __forceinline__ void stage_vec(__nv_bfloat16* S,
                                          const __nv_bfloat16* src, int n) {
  const int lane = threadIdx.x & 31;
  if ((n & 7) == 0) {
    for (int t = lane; t < (n >> 3); t += 32)
      cp_async16(S + 8 * t, src + 8 * t, true);
  } else {
    for (int t = lane; t < n; t += 32) S[t] = src[t];
  }
}

// One warp stages n contiguous f32 values (cp.async when n is a multiple
// of 4, which keeps src 16-byte aligned at every row of its tensor)
__device__ __forceinline__ void stage_vec_f32(float* S, const float* src,
                                              int n) {
  const int lane = threadIdx.x & 31;
  if ((n & 3) == 0) {
    for (int t = lane; t < (n >> 2); t += 32)
      cp_async16(S + 4 * t, src + 4 * t, true);
  } else {
    for (int t = lane; t < n; t += 32) S[t] = src[t];
  }
}

// Columns c and c + 1 (zero past w) of an f32 row r of width w in device
// memory; one 8-byte load when w is even (c is)
__device__ __forceinline__ float2 ld_f2_row(const float* r, int c, int w) {
  if ((w & 1) == 0)
    return c < w ? *reinterpret_cast<const float2*>(r + c)
                 : make_float2(0.f, 0.f);
  return make_float2(c < w ? r[c] : 0.f, c + 1 < w ? r[c + 1] : 0.f);
}

// Sum (max) over the lanes of one head: lanes hd, hd + hl, hd + 2 hl, ...
// (hl lanes a key group; none to add when hl is 32)
__device__ __forceinline__ float head_sum(float v, int hl) {
  for (int o = hl; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float head_max(float v, int hl) {
  for (int o = hl; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The column sums of one n8 tile of two C-fragment matrices X and Y over
// their 16 rows: x0, x1 (y0, y1) are the lane's columns 2 tq and 2 tq + 1,
// rows gq and gq + 8 already added. Two exchange steps and one sum over the
// eight row groups (lane bits 4, 3, 2; 4 shuffles against 12 for four full
// sums) leave, in the lanes with bit 2 clear, the total of one column: of Y
// where bit 4 is set, else of X, and column 2 tq + 1 where bit 3 is set.
__device__ __forceinline__ float tile_colsum(float x0, float x1, float y0,
                                             float y1) {
  const int lane = threadIdx.x & 31;
  const bool u4 = lane & 16, u3 = lane & 8;
  float k0 = u4 ? y0 : x0, k1 = u4 ? y1 : x1;
  k0 += __shfl_xor_sync(0xffffffffu, u4 ? x0 : y0, 16);
  k1 += __shfl_xor_sync(0xffffffffu, u4 ? x1 : y1, 16);
  float k = u3 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, u3 ? k0 : k1, 8);
  return k + __shfl_xor_sync(0xffffffffu, k, 4);
}

// LN1 of the lane's rows gq and gq + 8 of a 16-key tile S of e (row stride
// ld, columns past n zero): their mean and rsqrt(variance + eps), the
// variance taken about the mean, as ln_stats
__device__ __forceinline__ void tile_ln_stats(const __nv_bfloat16* S, int ld,
                                              int n, float (&mu)[2],
                                              float (&rs)[2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
  for (int c = 2 * tq; c < n; c += 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = ld_bf2(S + (gq + 8 * r) * ld + c);
      s[r] += x.x + (c + 1 < n ? x.y : 0.f);
    }
  mu[0] = quad_sum(s[0]) / n; mu[1] = quad_sum(s[1]) / n;
  for (int c = 2 * tq; c < n; c += 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = ld_bf2(S + (gq + 8 * r) * ld + c);
      const float d0 = x.x - mu[r], d1 = c + 1 < n ? x.y - mu[r] : 0.f;
      v[r] += d0 * d0 + d1 * d1;
    }
  rs[0] = rsqrtf(quad_sum(v[0]) / n + LN_EPS);
  rs[1] = rsqrtf(quad_sum(v[1]) / n + LN_EPS);
}

// rnd(g1 x1 + b1), x1 = (e - mu) rs, of the lane's rows gq and gq + 8 of the
// tile S into D (same stride; zeros in the columns past n, up to nk)
__device__ __forceinline__ void tile_eln(__nv_bfloat16* D,
                                         const __nv_bfloat16* S, int ld,
                                         int n, int nk, const float* g1,
                                         const float* b1, const float (&mu)[2],
                                         const float (&rs)[2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  for (int c = 2 * tq; c < nk; c += 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = ld_bf2(S + (gq + 8 * r) * ld + c);
      const float y0 = c < n ? g1[c] * ((x.x - mu[r]) * rs[r]) + b1[c] : 0.f;
      const float y1 =
          c + 1 < n ? g1[c + 1] * ((x.y - mu[r]) * rs[r]) + b1[c + 1] : 0.f;
      st_bf2(D + (gq + 8 * r) * ld + c, y0, y1);
    }
}

// GENERAL picks the general body (see the top of the file). NTE: n8 tiles
// of the edge width a lane holds at once (all of ew <= 64 in the register
// body, a 64-column chunk in the general one); NPT: n8 tiles of the
// [gates | bias] projections (all of nproj <= 16, or a 32-column chunk).
// HT: the type de_mid and dhh are handed over in (bf16 for K5, float for
// K7 and K6); KVG: the layout's kv_global; MONO: the mono switch (K6).
template <bool GENERAL, typename HT, bool KVG, bool MONO = false>
__global__ void __launch_bounds__(ATT_MMA_WARPS * 32, 1)
    bwd_attn_mma_kernel(AttnParams p) {
  constexpr int NTE = 8, NPT = GENERAL ? 4 : 2;
  constexpr bool F32H = std::is_same<HT, float>::value;
  static_assert(F32H || !MONO, "the mono switch hands over in f32");
  using bf = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh;
  const int nw = blockDim.x >> 5;
  const AttnMmaLayout L(l, ew, h, dh, p.gated, nw, F32H, KVG);
  const int nproj = L.nproj, LK = L.LK, EK = L.EK, NPK = L.NPK;
  const int se = L.se, sd = L.sd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int C = L.C, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const bool dropping = p.dr.dropping();

  float* red = sm + L.red;                 // [dk | dv | weight-gradient sums]
  // KVG: dk and dv summed in the graph's rows of the outputs
  float* dk_s = KVG ? p.dk + (size_t)b * l * dh : red;
  float* dv_s = KVG ? p.dv + (size_t)b * l * dh : red + l * dh;
  float* acc = red + L.nkv;
  float *bgb = sm + L.vec, *g1 = bgb + NPK, *b1 = g1 + EK;
  float* madd = sm + L.madd;
  float* wf = sm + L.nfb + warp * L.nfw;
  float *s0 = wf + L.s0, *s1 = wf + L.s1, *pp = wf + L.pp;
  float *mu_s = wf + L.mu, *rs_s = wf + L.rs, *wrow = wf + L.wrow;
  // general body: the warp's [dW (ew, nproj) | dbg, dbb] sums
  float* wdw = nw > 1 ? wf + L.wdw : acc;
  float* wdb = wdw + ew * nproj;
  float* dhf = wf + L.dhf;                 // f32 hand-off: the row's dhh
  bf* bs = reinterpret_cast<bf*>(sm + L.nfb + nw * L.nfw);
  bf* Ws = bs + L.w;
  bf* wb = bs + L.nbb + warp * L.nbw;
  bf *erow = wb + L.erow, *tb = wb + L.tb, *dcol = wb + L.dcol;
  bf *hh_s = wb + L.hh, *dhh_s = wb + L.dhh, *ds_s = wb + L.ds;
  bf *ad_s = wb + L.ad, *qb = wb + L.qb, *gb = wb + L.gb, *et = wb + L.et;

  const bf* E = (const bf*)p.e;
  const bf* QKV = (const bf*)p.qkv;
  const bf* HH = (const bf*)p.hh;
  const HT* DHH = (const HT*)p.dhh;
  const HT* DM = (const HT*)p.demid;
  const bf* GV = (const bf*)p.gv;
  // the graph's k and v rows (stride kst): staged, or KVG in device memory
  const int kst = KVG ? 3 * dh : L.skv;
  const bf* ks = KVG ? QKV + (size_t)b * l * 3 * dh + dh : bs + L.k;
  const bf* vs = KVG ? QKV + (size_t)b * l * 3 * dh + 2 * dh : bs + L.v;
  bf* DE = (bf*)p.de;
  bf* DQ = (bf*)p.dq;

  // ---- zero the sums and the staging (padding rows and columns are never
  // written again); then weights, biases, the key mask and the graph's k
  // and v, with the first row of every warp in flight beside them
  zero_smem(bs, L.nbb + nw * L.nbw);
  for (int t = tid; t < L.nfb + nw * L.nfw; t += blockDim.x) sm[t] = 0.f;
  __syncthreads();
  const bf* Wg = (const bf*)p.wg;
  const bf* Wb = (const bf*)p.wb;
  const int nvec = nproj + 2 * ew + l;
  for (int t = tid; t < nvec; t += blockDim.x) {
    if (t < nproj) {
      bgb[t] = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
    } else if (t < nproj + ew) {
      g1[t - nproj] = p.g1[t - nproj];
    } else if (t < nproj + 2 * ew) {
      b1[t - nproj - ew] = p.b1[t - nproj - ew];
    } else {
      const int j = t - nproj - 2 * ew;
      madd[j] = (p.mask[(size_t)b * l + j] - 1.f) * 1e9f;
    }
  }
  if ((h & 7) == 0) {                       // 16-byte rows of Wg and Wb
    const int cpr = nproj >> 3;
    for (int t = tid; t < ew * cpr; t += blockDim.x) {
      const int c = t / cpr, n = (t - c * cpr) << 3;
      cp_async16(Ws + c * sd + n,
                 (p.gated && n < h) ? Wg + c * h + n
                                    : Wb + c * h + (n - (nproj - h)), true);
    }
  } else {
    for (int t = tid; t < ew * nproj; t += blockDim.x) {
      const int c = t / nproj, n = t - c * nproj;
      Ws[c * sd + n] = (p.gated && n < h) ? Wg[c * h + n]
                                          : Wb[c * h + (n - (nproj - h))];
    }
  }
  if (KVG) {                                // the graph's rows of dk, dv
    for (int t = tid; t < l * dh; t += blockDim.x) dk_s[t] = dv_s[t] = 0.f;
  } else {
    bf *kw = bs + L.k, *vw = bs + L.v;
    const int skv = L.skv;
    if ((dh & 7) == 0) {
      const int cpr = dh >> 3;
      for (int t = tid; t < l * cpr; t += blockDim.x) {
        const int j = t / cpr, f = (t - j * cpr) << 3;
        const bf* r = QKV + ((size_t)b * l + j) * 3 * dh;
        cp_async16(kw + j * skv + f, r + dh + f, true);
        cp_async16(vw + j * skv + f, r + 2 * dh + f, true);
      }
    } else if ((dh & 1) == 0) {
      const int hdh = dh >> 1;
      for (int t = tid; t < l * hdh; t += blockDim.x) {
        const int j = t / hdh, f = 2 * (t - j * hdh);
        const bf* r = QKV + ((size_t)b * l + j) * 3 * dh;
        *reinterpret_cast<uint32_t*>(kw + j * skv + f) =
            *reinterpret_cast<const uint32_t*>(r + dh + f);
        *reinterpret_cast<uint32_t*>(vw + j * skv + f) =
            *reinterpret_cast<const uint32_t*>(r + 2 * dh + f);
      }
    } else {
      for (int t = tid; t < l * dh; t += blockDim.x) {
        const int j = t / dh, f = t - j * dh;
        const bf* r = QKV + ((size_t)b * l + j) * 3 * dh;
        kw[j * skv + f] = r[dh + f];
        vw[j * skv + f] = r[2 * dh + f];
      }
    }
  }
  cp_async_commit();

  // a warp's row i: e, hh, dhh, q_i and gv_i (one group), then de_mid's
  // first tile into tile buffer 0 (a second group, empty with the f32
  // hand-off, which reads de_mid from device memory where it adds it)
  auto issue_row = [&](int i) {
    const size_t row = (size_t)b * l + i;
    stage_rows(erow, se, E + row * l * ew, LK, l, ew);
    if constexpr (!MONO) {
      stage_vec(hh_s, HH + row * l * h, l * h);
    } else {       // the mono switch: the row's f32 hh and flags into L1
      const char* ph = (const char*)((const float*)p.hh + row * l * h);
      for (int t = lane * 128; t < l * h * 4; t += 32 * 128)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(ph + t));
      if (p.has_clip) {
        const char* pf = (const char*)(p.inrange + row * l * h);
        for (int t = lane * 128; t < l * h; t += 32 * 128)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(pf + t));
      }
    }
    if constexpr (F32H) stage_vec_f32(dhf, DHH + row * l * h, l * h);
    else stage_vec(dhh_s, DHH + row * l * h, l * h);
    stage_vec(qb, QKV + row * 3 * dh, dh);
    stage_vec(gb, GV + row * dh, dh);
    cp_async_commit();
    if constexpr (!F32H) stage_rows(tb, se, DM + row * l * ew, 16, min(16, l), ew);
    cp_async_commit();
  };

  // [G | P] + [bg | bb] of the columns n0 + (n8 tiles of gp) at key tile t
  // into s1 (gates) and pp (edge bias)
  auto proj_out = [&](const float (&gp)[NPT][4], int n0, int t) {
#pragma unroll
    for (int jn = 0; jn < NPT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 8 * jn + 2 * tq + (q & 1);
        const int j = 16 * t + gq + ((q >> 1) << 3);
        if (j < l && n < nproj) {
          const float z = gp[jn][q] + bgb[n];
          if (p.gated && n < h) s1[j * h + n] = z;
          else pp[j * h + n - (nproj - h)] = z;
        }
      }
  };
  // general body: de_ln = rnd([dgate | dP]) . [Wg | Wb]^T of key tile j0,
  // edge columns c0 .. c0 + 63
  auto de_ln_chunk = [&](float (&dl)[NTE][4], int j0, int c0) {
#pragma unroll
    for (int j = 0; j < NTE; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dl[j][q] = 0.f;
    for (int kp = 0; kp < NPK / 16; ++kp) {
      uint32_t a[4];
      lda(a, dcol, sd, j0, 16 * kp);
#pragma unroll
      for (int jb = 0; jb < NTE / 2; ++jb) {
        if (c0 + 16 * jb < EK) {
          uint32_t bb[4];
          ldb_nk(bb, Ws, sd, 16 * kp, c0 + 16 * jb);
          mma16816(dl[2 * jb], a, bb[0], bb[1]);
          mma16816(dl[2 * jb + 1], a, bb[2], bb[3]);
        }
      }
    }
  };

  const int rbeg = rank * L.RB, rend = min(l, rbeg + L.RB);
  // lane (kg, hd0): key group kg of KG, first head hd0 (heads hd0, hd0 + 32,
  // ... when a lane takes whole heads, HL = 32)
  const int HL = (32 % h == 0) ? h : 32, KG = 32 / HL;
  const int kg = lane / HL, hd0 = lane - kg * HL;
  const int ndd = dh / h, ntile = LK / 16;
  float dwacc[NTE / 2][NPT][4];              // register body: the warp's dW
#pragma unroll
  for (int a = 0; a < NTE / 2; ++a)
#pragma unroll
    for (int n = 0; n < NPT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) dwacc[a][n][q] = 0.f;
  float sdg = 0.f, sdp = 0.f;                // register body: dbg, dbb parts
  if (rbeg + warp < rend) {
    issue_row(rbeg + warp);
  } else {                                   // the same count of groups
    cp_async_commit();
    cp_async_commit();
  }
  cp_async_wait<1>();                        // the setup and the first row
  __syncthreads();

  for (int pass = 0; pass < L.P; ++pass) {
    const int i = rbeg + pass * nw + warp;
    if (i < rend) {
      const size_t row = (size_t)b * l + i;
      cp_async_wait<1>();                    // e, hh, dhh, q_i, gv_i
      __syncwarp();

      // ---- LN1 and [G | P] = rnd(e_ln) . [Wg | Wb] + [bg | bb], 16 keys a
      // tile
      for (int t = 0; t < ntile; ++t) {
        if constexpr (GENERAL) {
          // rnd(e_ln) into the tile buffer, the products in 32-column chunks
          float mu[2], rs[2];
          tile_ln_stats(erow + 16 * t * se, se, ew, mu, rs);
          if (tq == 0) {
            mu_s[16 * t + gq] = mu[0]; rs_s[16 * t + gq] = rs[0];
            mu_s[16 * t + gq + 8] = mu[1]; rs_s[16 * t + gq + 8] = rs[1];
          }
          tile_eln(et, erow + 16 * t * se, se, ew, EK, g1, b1, mu, rs);
          __syncwarp();
          for (int n0 = 0; n0 < NPK; n0 += 8 * NPT) {
            float gp[NPT][4];
#pragma unroll
            for (int n = 0; n < NPT; ++n)
#pragma unroll
              for (int q = 0; q < 4; ++q) gp[n][q] = 0.f;
            for (int ke = 0; ke < EK / 16; ++ke) {
              uint32_t a[4];
              lda(a, et, se, 0, 16 * ke);
#pragma unroll
              for (int nb = 0; nb < NPT / 2; ++nb) {
                if (n0 + 16 * nb < NPK) {
                  uint32_t bb[4];
                  ldb_kn(bb, Ws, sd, 16 * ke, n0 + 16 * nb);
                  mma16816(gp[2 * nb], a, bb[0], bb[1]);
                  mma16816(gp[2 * nb + 1], a, bb[2], bb[3]);
                }
              }
            }
            proj_out(gp, n0, t);
          }
          __syncwarp();                      // et is the next tile's
        } else {
          // e_ln goes from the C-fragment layout of e straight into the A
          // fragments
          float x[NTE][4];
#pragma unroll
          for (int j = 0; j < NTE; ++j) {
            if (j < EK / 8) {
              const int c = 8 * j + 2 * tq;
              const float2 e0 = ld_bf2(erow + (16 * t + gq) * se + c);
              const float2 e1 = ld_bf2(erow + (16 * t + gq + 8) * se + c);
              x[j][0] = e0.x; x[j][1] = e0.y; x[j][2] = e1.x; x[j][3] = e1.y;
            } else {
              x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
            }
          }
          float mu[2], rs[2];
          ln_stats(x, ew, mu, rs);
          if (tq == 0) {
            mu_s[16 * t + gq] = mu[0]; rs_s[16 * t + gq] = rs[0];
            mu_s[16 * t + gq + 8] = mu[1]; rs_s[16 * t + gq + 8] = rs[1];
          }
          float gp[NPT][4];
#pragma unroll
          for (int n = 0; n < NPT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) gp[n][q] = 0.f;
#pragma unroll
          for (int ke = 0; ke < NTE / 2; ++ke) {
            if (ke < EK / 16) {
              float v[2][4];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int c = 16 * ke + 8 * jj + 2 * tq + (q & 1);
                  v[jj][q] = c < ew ? g1[c] * ((x[2 * ke + jj][q] - mu[q >> 1]) *
                                               rs[q >> 1]) + b1[c]
                                    : 0.f;
                }
              const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]),
                                     pack_bf16(v[0][2], v[0][3]),
                                     pack_bf16(v[1][0], v[1][1]),
                                     pack_bf16(v[1][2], v[1][3])};
#pragma unroll
              for (int nb = 0; nb < NPT / 2; ++nb) {
                uint32_t bb[4];
                ldb_kn(bb, Ws, sd, 16 * ke, 16 * nb);
                mma16816(gp[2 * nb], a, bb[0], bb[1]);
                mma16816(gp[2 * nb + 1], a, bb[2], bb[3]);
              }
            }
          }
          proj_out(gp, 0, t);
        }
      }
      __syncwarp();

      // ---- the softmax chain re-entered at the saved h_hat: lane (kg, hd)
      // takes keys kg, kg + KG, ... of head hd, so a head's sums over its
      // keys stay inside the warp
      const float* arow = p.amask ? p.amask + row * l : nullptr;
      for (int hd = hd0; hd < h; hd += 32) {
        float mx = -INFINITY;
#pragma unroll 4
        for (int j = kg; j < l; j += KG) {
          const int t = j * h + hd;
          float add = madd[j];
          if (arow) add += (arow[j] - 1.f) * 1e9f;
          const float rm = p.dr.mask_add(b, i, j, hd);
          const float lg = (MONO ? __ldg((const float*)p.hh + row * l * h + t)
                                 : to_f(hh_s[t])) + add + rm;
          s0[t] = lg;
          if (p.gated) s1[t] = sigmoid(s1[t] + add + rm);
          mx = fmaxf(mx, lg);
        }
        mx = head_max(mx, HL);
        float sum = 0.f;
#pragma unroll 4
        for (int j = kg; j < l; j += KG) {
          const int t = j * h + hd;
          const float ex = expf(s0[t] - mx);
          s0[t] = ex;
          sum += ex;
        }
        const float den = fmaxf(head_sum(sum, HL), 1e-30f);
        // dropout and gate backward; a_sm and da_sm replace exp and sg
        float ts = 0.f, dgs = 0.f, dps = 0.f;
#pragma unroll 2
        for (int j = kg; j < l; j += KG) {
          const int t = j * h + hd;
          float da = 0.f;
#pragma unroll 8
          for (int dd = 0; dd < ndd; ++dd) {
            const int f = dd * h + hd;
            da = fmaf(to_f(gb[f]), to_f(vs[j * kst + f]), da);
          }
          const float a_sm = s0[t] / den, s = s1[t];
          float a = p.gated ? a_sm * s : a_sm;
          if (dropping) {
            const bool kp = p.dr.kept(b, i, j, hd);
            da = kp ? da / p.dr.keep : 0.f;
            a = kp ? a / p.dr.keep : 0.f;
          }
          ad_s[t] = __float2bfloat16_rn(a);
          float dasm = da;
          if (p.gated) {
            dasm = da * s;
            const float dgt = da * a_sm * s * (1.f - s);
            dcol[j * sd + hd] = __float2bfloat16_rn(dgt);
            dgs += dgt;
          }
          s0[t] = a_sm;
          s1[t] = dasm;
          ts += dasm * a_sm;
        }
        ts = head_sum(ts, HL);
        // softmax and clip backward; edge-bias activation backward
#pragma unroll 4
        for (int j = kg; j < l; j += KG) {
          const int t = j * h + hd;
          const float dH = s0[t] * (s1[t] - ts) + (F32H ? dhf[t] : to_f(dhh_s[t]));
          float d = dH * p.scale;
          const float P = pp[t];
          const float Ev = act_fn(p.edge_act, p.edge_alpha, P);
          if (p.has_clip) {
            if constexpr (MONO) {
              if (!__ldg(p.inrange + row * l * h + t)) d = 0.f;
            } else {
              const float sc = to_f(hh_s[t]) - Ev;
              if (!(sc > p.lo && sc < p.hi)) d = 0.f;
            }
          }
          ds_s[t] = __float2bfloat16_rn(d);
          const float dp = dH * act_grad(p.edge_act, p.edge_alpha, P, Ev);
          dcol[j * sd + (nproj - h) + hd] = __float2bfloat16_rn(dp);
          dps += dp;
        }
        if constexpr (GENERAL) {             // the head's owning lane adds
          dgs = head_sum(dgs, HL);
          dps = head_sum(dps, HL);
          if (kg == 0) {
            if (p.gated) wdb[hd] += dgs;
            wdb[(nproj - h) + hd] += dps;
          }
        } else {
          sdg += dgs;
          sdp += dps;
        }
      }
      __syncwarp();

      // ---- dq_i = sum_j rnd(ds) k_j, two features a lane
      if ((dh & 1) == 0) {
        for (int f0 = 2 * lane; f0 < dh; f0 += 64) {
          const int h0 = f0 % h, h1 = (f0 + 1) % h;
          float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
          for (int j = 0; j < l; ++j) {
            const float2 kv = ld_bf2(ks + j * kst + f0);
            a0 = fmaf(to_f(ds_s[j * h + h0]), kv.x, a0);
            a1 = fmaf(to_f(ds_s[j * h + h1]), kv.y, a1);
          }
          st_bf2(DQ + row * dh + f0, a0, a1);
        }
      } else {
        for (int f = lane; f < dh; f += 32) {
          const int hf = f % h;
          float a0 = 0.f;
          for (int j = 0; j < l; ++j)
            a0 = fmaf(to_f(ds_s[j * h + hf]), to_f(ks[j * kst + f]), a0);
          DQ[row * dh + f] = __float2bfloat16_rn(a0);
        }
      }

      // ---- per 16-key tile: de_ln = rnd([dgate | dP]) . [Wg | Wb]^T,
      // dW += rnd(e_ln)^T rnd([dgate | dP]), LN1 backward plus de_mid
      for (int t = 0; t < ntile; ++t) {
        const int j0 = 16 * t;
        // de_mid's tile t: register body, in flight since tile t - 1 in
        // buffer t & 1, with tile t + 1 staged now into the other (its
        // tile t - 1 is read); general body, staged now into its one buffer
        bf* dmb = GENERAL ? tb : tb + (t & 1) * 16 * se;
        const int jn = GENERAL ? j0 : j0 + 16;
        if constexpr (!F32H)
          if (GENERAL ? t > 0 : t + 1 < ntile)
            stage_rows(GENERAL ? tb : tb + ((t + 1) & 1) * 16 * se, se,
                       DM + (row * l + jn) * ew, 16, min(16, l - jn), ew);
        cp_async_commit();
        // f32 hand-off: the lane's rows of de_mid in device memory (keys
        // past l read as 0); the register body loads its values now, ahead
        // of the tile's products
        const float* dmr0 = (const float*)DM + (row * l + j0 + gq) * ew;
        const float* dmr1 = dmr0 + 8 * ew;
        const bool dv0 = j0 + gq < l, dv1 = j0 + gq + 8 < l;
        float dmf[NTE][4];
        if constexpr (F32H && !GENERAL) {
#pragma unroll
          for (int j = 0; j < NTE; ++j) {
            if (j < EK / 8) {
              const int c = 8 * j + 2 * tq;
              const float2 a = dv0 ? ld_f2_row(dmr0, c, ew) : make_float2(0.f, 0.f);
              const float2 z = dv1 ? ld_f2_row(dmr1, c, ew) : make_float2(0.f, 0.f);
              dmf[j][0] = a.x; dmf[j][1] = a.y; dmf[j][2] = z.x; dmf[j][3] = z.y;
            }
          }
        }
        const float mu0 = mu_s[j0 + gq], rs0 = rs_s[j0 + gq];
        const float mu1 = mu_s[j0 + gq + 8], rs1 = rs_s[j0 + gq + 8];
        if constexpr (GENERAL) {
          const float mu[2] = {mu0, mu1}, rs[2] = {rs0, rs1};
          bf* e_t = erow + j0 * se;
          tile_eln(et, e_t, se, ew, EK, g1, b1, mu, rs);
          __syncwarp();
          // dW into the warp's f32 sums, 16 x 32 a chunk (one owning lane
          // an element)
          for (int mb = 0; mb < EK / 16; ++mb) {
            uint32_t a[4];
            lda_t(a, et, se, 0, 16 * mb);
            for (int n0 = 0; n0 < NPK; n0 += 8 * NPT) {
              float d[NPT][4];
#pragma unroll
              for (int n = 0; n < NPT; ++n)
#pragma unroll
                for (int q = 0; q < 4; ++q) d[n][q] = 0.f;
#pragma unroll
              for (int nb = 0; nb < NPT / 2; ++nb) {
                if (n0 + 16 * nb < NPK) {
                  uint32_t bb[4];
                  ldb_kn(bb, dcol, sd, j0, n0 + 16 * nb);
                  mma16816(d[2 * nb], a, bb[0], bb[1]);
                  mma16816(d[2 * nb + 1], a, bb[2], bb[3]);
                }
              }
#pragma unroll
              for (int jn2 = 0; jn2 < NPT; ++jn2)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int m = 16 * mb + gq + ((q >> 1) << 3);
                  const int n = n0 + 8 * jn2 + 2 * tq + (q & 1);
                  if (m < ew && n < nproj) wdw[m * nproj + n] += d[jn2][q];
                }
            }
          }
          // LN1 backward, first pass: the row sums of dx = de_ln g1 and of
          // dx x1, and the tile's dg1 / db1 column sums
          float a0 = 0.f, c0 = 0.f, a1 = 0.f, c1 = 0.f;
          for (int cc = 0; cc < EK; cc += 8 * NTE) {
            float dl[NTE][4];
            de_ln_chunk(dl, j0, cc);
#pragma unroll
            for (int j = 0; j < NTE; ++j) {
              const int cb = cc + 8 * j + 2 * tq;
              if (cc + 8 * j < EK) {
                const float2 e0 = ld_bf2(e_t + gq * se + cb);
                const float2 e1 = ld_bf2(e_t + (gq + 8) * se + cb);
                const float ev[4] = {e0.x, e0.y, e1.x, e1.y};
                float sg1[2], sb1[2];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const int c = cb + q;
                  const bool ok = c < ew;
                  const float x0 = ok ? (ev[q] - mu0) * rs0 : 0.f;
                  const float x1 = ok ? (ev[2 + q] - mu1) * rs1 : 0.f;
                  const float d0 = dl[j][q], d1 = dl[j][2 + q];
                  if (ok) {
                    a0 += d0 * g1[c]; c0 += d0 * g1[c] * x0;
                    a1 += d1 * g1[c]; c1 += d1 * g1[c] * x1;
                  }
                  sg1[q] = d0 * x0 + d1 * x1;
                  sb1[q] = d0 + d1;
                }
                const float cs = tile_colsum(sg1[0], sg1[1], sb1[0], sb1[1]);
                if (!(lane & 4))
                  wrow[(lane & 16 ? EK : 0) + cb + (lane & 8 ? 1 : 0)] += cs;
              }
            }
          }
          const float m10 = quad_sum(a0) / ew, m20 = quad_sum(c0) / ew;
          const float m11 = quad_sum(a1) / ew, m21 = quad_sum(c1) / ew;
          cp_async_wait<0>();                    // de_mid's tile t
          __syncwarp();
          // second pass: de_ln again, de over e's own elements
          for (int cc = 0; cc < EK; cc += 8 * NTE) {
            float dl[NTE][4];
            de_ln_chunk(dl, j0, cc);
#pragma unroll
            for (int j = 0; j < NTE; ++j) {
              const int cb = cc + 8 * j + 2 * tq;
              if (cc + 8 * j < EK) {
                const float2 e0 = ld_bf2(e_t + gq * se + cb);
                const float2 e1 = ld_bf2(e_t + (gq + 8) * se + cb);
                float2 dm0, dm1;
                if constexpr (F32H) {
                  dm0 = dv0 ? ld_f2_row(dmr0, cb, ew) : make_float2(0.f, 0.f);
                  dm1 = dv1 ? ld_f2_row(dmr1, cb, ew) : make_float2(0.f, 0.f);
                } else {
                  dm0 = ld_bf2(dmb + gq * se + cb);
                  dm1 = ld_bf2(dmb + (gq + 8) * se + cb);
                }
                const float ev[4] = {e0.x, e0.y, e1.x, e1.y};
                const float dmv[4] = {dm0.x, dm0.y, dm1.x, dm1.y};
                float de[4];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const int c = cb + q;
                  const bool ok = c < ew;
                  const float x0 = (ev[q] - mu0) * rs0;
                  const float x1 = (ev[2 + q] - mu1) * rs1;
                  de[q] = ok ? (dl[j][q] * g1[c] - m10 - x0 * m20) * rs0 + dmv[q]
                             : 0.f;
                  de[2 + q] = ok ? (dl[j][2 + q] * g1[c] - m11 - x1 * m21) * rs1 +
                                       dmv[2 + q]
                                 : 0.f;
                }
                st_bf2(e_t + gq * se + cb, de[0], de[1]);
                st_bf2(e_t + (gq + 8) * se + cb, de[2], de[3]);
              }
            }
          }
        } else {
          bf* eln = erow + j0 * se;              // rnd(e_ln) over e's tile
          float x1[NTE][4];
#pragma unroll
          for (int j = 0; j < NTE; ++j) {
            if (j < EK / 8) {
              const int c = 8 * j + 2 * tq;
              const float2 e0 = ld_bf2(erow + (j0 + gq) * se + c);
              const float2 e1 = ld_bf2(erow + (j0 + gq + 8) * se + c);
              const float ev[4] = {e0.x, e0.y, e1.x, e1.y};
              float y[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const bool ok = c + (q & 1) < ew;
                x1[j][q] = ok ? (ev[q] - (q < 2 ? mu0 : mu1)) * (q < 2 ? rs0 : rs1)
                              : 0.f;
                y[q] = ok ? g1[c + (q & 1)] * x1[j][q] + b1[c + (q & 1)] : 0.f;
              }
              st_bf2(eln + gq * se + c, y[0], y[1]);
              st_bf2(eln + (gq + 8) * se + c, y[2], y[3]);
            } else {
              x1[j][0] = x1[j][1] = x1[j][2] = x1[j][3] = 0.f;
            }
          }
          __syncwarp();
          float dl[NTE][4];
#pragma unroll
          for (int j = 0; j < NTE; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) dl[j][q] = 0.f;
#pragma unroll
          for (int kp = 0; kp < NPT / 2; ++kp) {
            uint32_t a[4];
            lda(a, dcol, sd, j0, 16 * kp);
#pragma unroll
            for (int jb = 0; jb < NTE / 2; ++jb) {
              if (jb < EK / 16) {
                uint32_t bb[4];
                ldb_nk(bb, Ws, sd, 16 * kp, 16 * jb);
                mma16816(dl[2 * jb], a, bb[0], bb[1]);
                mma16816(dl[2 * jb + 1], a, bb[2], bb[3]);
              }
            }
          }
#pragma unroll
          for (int mb = 0; mb < NTE / 2; ++mb) {
            if (mb < EK / 16) {
              uint32_t a[4];
              lda_t(a, eln, se, 0, 16 * mb);
#pragma unroll
              for (int nb = 0; nb < NPT / 2; ++nb) {
                uint32_t bb[4];
                ldb_kn(bb, dcol, sd, j0, 16 * nb);
                mma16816(dwacc[mb][2 * nb], a, bb[0], bb[1]);
                mma16816(dwacc[mb][2 * nb + 1], a, bb[2], bb[3]);
              }
            }
          }
          cp_async_wait<1>();                    // de_mid's tile t
          __syncwarp();
          // LN1 backward: de = (dx - m1 - x1 m2) rstd + de_mid, dx = de_ln
          // g1; dg1 += sum de_ln x1, db1 += sum de_ln (keys past l add 0)
          float a0 = 0.f, c0 = 0.f, a1 = 0.f, c1 = 0.f;
#pragma unroll
          for (int j = 0; j < NTE; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int c = 8 * j + 2 * tq + q;
              if (c < ew) {
                const float d0 = dl[j][q] * g1[c], d1 = dl[j][2 + q] * g1[c];
                a0 += d0; c0 += d0 * x1[j][q];
                a1 += d1; c1 += d1 * x1[j][2 + q];
              }
            }
          const float m10 = quad_sum(a0) / ew, m20 = quad_sum(c0) / ew;
          const float m11 = quad_sum(a1) / ew, m21 = quad_sum(c1) / ew;
#pragma unroll
          for (int j = 0; j < NTE; ++j) {
            if (j < EK / 8) {
              const int cb = 8 * j + 2 * tq;
              float dmv[4];
              if constexpr (F32H) {
#pragma unroll
                for (int q = 0; q < 4; ++q) dmv[q] = dmf[j][q];
              } else {
                const float2 dm0 = ld_bf2(dmb + gq * se + cb);
                const float2 dm1 = ld_bf2(dmb + (gq + 8) * se + cb);
                dmv[0] = dm0.x; dmv[1] = dm0.y; dmv[2] = dm1.x; dmv[3] = dm1.y;
              }
              float de[4], sg1[2], sb1[2];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int c = cb + q;
                const bool ok = c < ew;
                const float d0 = dl[j][q], d1 = dl[j][2 + q];
                de[q] = ok ? (d0 * g1[c] - m10 - x1[j][q] * m20) * rs0 + dmv[q]
                           : 0.f;
                de[2 + q] = ok ? (d1 * g1[c] - m11 - x1[j][2 + q] * m21) * rs1 +
                                     dmv[2 + q]
                               : 0.f;
                sg1[q] = d0 * x1[j][q] + d1 * x1[j][2 + q];
                sb1[q] = d0 + d1;
              }
              st_bf2(erow + (j0 + gq) * se + cb, de[0], de[1]);
              st_bf2(erow + (j0 + gq + 8) * se + cb, de[2], de[3]);
              // the tile's dg1 (X), db1 (Y) column sums; one owning lane each
              const float cs = tile_colsum(sg1[0], sg1[1], sb1[0], sb1[1]);
              if (!(lane & 4))
                wrow[(lane & 16 ? EK : 0) + cb + (lane & 8 ? 1 : 0)] += cs;
            }
          }
        }
        __syncwarp();
        store_rows16(DE + (row * l + j0) * ew, erow + j0 * se, se,
                     min(16, l - j0), ew);
      }
    }

    // ---- dk_j += rnd(ds)_ij q_i, dv_j += rnd(a_drop)_ij gv_i over the
    // block's rows of this pass, in row order; one thread an element
    __syncthreads();
    const int nrows = min(nw, rend - (rbeg + pass * nw));
    for (int t = tid; t < l * dh; t += blockDim.x) {
      const int j = t / dh, f = t - j * dh, hf = f % h;
      float dk = dk_s[t], dv = dv_s[t];
#pragma unroll 4
      for (int w = 0; w < nrows; ++w) {
        const bf* wbw = bs + L.nbb + w * L.nbw;
        dk = fmaf(to_f(wbw[L.ds + j * h + hf]), to_f(wbw[L.qb + f]), dk);
        dv = fmaf(to_f(wbw[L.ad + j * h + hf]), to_f(wbw[L.gb + f]), dv);
      }
      dk_s[t] = dk;
      dv_s[t] = dv;
    }
    __syncthreads();
    // the warp's next row (q_i and gv_i are read now)
    if (pass + 1 < L.P && i + nw < rend) issue_row(i + nw);
  }
  cp_async_wait<0>();

  // ---- the warps' weight-gradient parts into the block's sums, in warp
  // order (each element has one owning lane or thread)
  if constexpr (GENERAL) {
    if (nw > 1) {                            // one warp: already there
      const int nd = ew * nproj + nproj;
      for (int t = tid; t < nd + 2 * ew; t += blockDim.x) {
        float s = acc[t];
        for (int w = 0; w < nw; ++w) {
          const float* ww = sm + L.nfb + w * L.nfw;
          s += t < nd ? ww[L.wdw + t]
                      : ww[L.wrow + (t - nd < ew ? t - nd : EK + t - nd - ew)];
        }
        acc[t] = s;
      }
    } else {
      for (int c = tid; c < ew; c += blockDim.x) {
        acc[ew * nproj + nproj + c] += wrow[c];
        acc[ew * nproj + nproj + ew + c] += wrow[EK + c];
      }
    }
    __syncthreads();
  } else {
    sdg = head_sum(sdg, HL);
    sdp = head_sum(sdp, HL);
    for (int w = 0; w < nw; ++w) {
      if (warp == w) {
#pragma unroll
        for (int mo = 0; mo < NTE / 2; ++mo)
#pragma unroll
          for (int jn = 0; jn < NPT; ++jn)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = 16 * mo + gq + ((q >> 1) << 3);
              const int n = 8 * jn + 2 * tq + (q & 1);
              if (m < ew && n < nproj) acc[m * nproj + n] += dwacc[mo][jn][q];
            }
        if (kg == 0) {
          if (p.gated) acc[ew * nproj + hd0] += sdg;
          acc[ew * nproj + (nproj - h) + hd0] += sdp;
        }
        for (int c = lane; c < ew; c += 32) {
          acc[ew * nproj + nproj + c] += wrow[c];
          acc[ew * nproj + nproj + ew + c] += wrow[EK + c];
        }
      }
      __syncthreads();
    }
  }

  // ---- the cluster's sum: rank r adds its share of [dk | dv | sums] over
  // the ranks' shared memory in rank order and writes it once (KVG: the
  // sums only; dk and dv are in place)
  cluster.sync();
  const int nred = L.nkv + L.nwg;
  const int chunk = (nred + C - 1) / C;
  const int e0 = rank * chunk, e1 = min(nred, e0 + chunk);
  const float* rp[ATT_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < ATT_MAX_CLUSTER; ++q)
    rp[q] = cluster.map_shared_rank(red, q < C ? q : 0);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    float v[ATT_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < ATT_MAX_CLUSTER; ++q) v[q] = q < C ? rp[q][e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < ATT_MAX_CLUSTER; ++q)
      if (q < C) s += v[q];
    if (e >= L.nkv) p.partials[(size_t)b * L.nwg + e - L.nkv] = s;
    else if (e < l * dh) p.dk[(size_t)b * l * dh + e] = s;
    else p.dv[(size_t)b * l * dh + e - l * dh] = s;
  }
  cluster.sync();      // no block leaves while another reads its memory
}

template <bool GENERAL, typename HT, bool KVG, bool MONO>
int launch_mma(const AttnParams& p, float* dw, const AttnMmaLayout& L,
               cudaStream_t stream) {
  auto kern = bwd_attn_mma_kernel<GENERAL, HT, KVG, MONO>;
  cudaError_t err =
      allow_smem<bwd_attn_mma_kernel<GENERAL, HT, KVG, MONO>>(L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.B * L.C));
  cfg.blockDim = dim3((unsigned)(32 * L.W));
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)L.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, p.B, L.nwg, dw, stream);
}

// ---------------------------------------------------------------- bf16 tiled
// The key-tiled body (K5 only). A block takes all of a graph's keys, 16 a
// warp (warp w owns keys 16 w .. 16 w + 15), and a contiguous range of its
// query rows; a cluster of C blocks splits the rows. The block's warps take
// its rows one at a time together: each warp runs the row's pairs with its
// own 16 keys (one m16 tile of the edge head), and the softmax's three sums
// over the row's keys (max, denominator, sum_j da_sm a_sm) are per-warp parts
// in shared memory, added in warp order after a block barrier each. So no
// shared memory holds a whole key row, and a warp's shared memory is that of
// its 16 keys whatever l is. Shared memory:
//   block f32:  the weight-gradient sums (output order), [bg | bb], g1, b1,
//               the key mask's additive term (LK), the warps' parts of the
//               three row sums (W x h each) and of the row's dq (W x dh);
//   warp f32:   the tile's G and P, rnd(ds) and rnd(a_drop) (16 x h
//               each), the warp's dg1 / db1 column sums (EK each);
//   block bf16: [Wg | Wb] as stored (EK x NPK);
//   warp bf16:  k of the warp's keys (16 x skv) and v head-major (v[j][hd
//               ndd + c] = v_j's feature c h + hd, for the da dot product);
//               two row buffers, each the row's e and de_mid tiles (16 x
//               se), hh and dhh tiles (16 x h), q_i and gv_i;
//               rnd([dgate | dP]) (16 x sd).
// dk and dv of the warp's keys are sums over the block's rows kept in
// registers (two features a lane, rows in order); dq_i is the warps' parts
// added in warp order by one warp after the next row's first barrier. At the
// end the block puts [weight-gradient sums | dk | dv] in shared memory and
// rank r of the cluster adds its 1/C share over the ranks in rank order, as
// the cluster body does. No float atomics: a rerun is bit-identical. The
// arithmetic is the cluster body's: the same bf16 rounding points, the
// strict clip test on the saved h_hat, the same Philox draws by (graph,
// query, key, head); only the order of the sums changes (the row's three
// sums, dq, dk, dv and the weight gradients).
//
// The block's shape follows l: W = l / 16 warps (rounded up; at most 16, so
// l <= 256 with 128 registers a thread, 168 where W is 9-12 and one block
// takes an SM anyway), and a cluster of C blocks (C the power of two up to 8
// that leaves at least 32 rows a block: 4 at l 128 and 192). A warp's shared
// memory is ~12.2 KB at ew 8, h 8, dh 64, so l 128 seats two 8-warp blocks
// a SM (102 KB each) and l 192 one of 12 warps (152 KB).
//
// What bounds it is instruction issue, not bytes or FLOPs: ~1,400
// instructions a lane a row, most of them in the mask's Philox draws, the
// softmax's and gate's IEEE divisions, the da dot products and the dk / dv /
// dq updates on the CUDA cores. By ablation at l 192 (b 128, the mask's
// draws live), on an earlier build of this body at ~4.0 ms: the dk / dv / dq
// updates ~0.9 ms, the tile's edge-head backward ~0.65, the da dot products
// ~0.35, the draws ~0.2; warp barriers in place of the three block barriers
// a row did not make it faster.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; CUDA events, L2 flushed, both
// draws live, medians of 15 launches, in turns with the cluster body): b
// 128, ew 8, h 8, dh 64: l 192 3.60-3.62 ms (cluster body, one warp a
// block: 37.6), l 128 1.74 (4.76), l 150 2.76-2.78 (10.3), l 75 0.72-0.73
// (1.03); b 8: l 128 0.527 (0.551), l 256 0.630-0.631 (17.3, kv_global).
constexpr int ATT_TILE_MAX_WARPS = 16;   // 256 keys a block

// Whether the tiled body can take a shape: the register body's class (ew
// <= 64, nproj <= 16, h | 32) cut to ew <= 16 (one n16 step of LN1's
// tile), h <= 8 (at most four keys of a head a lane), dh even and at most 64
// (two features a lane) and l <= 256 (16 warps)
__host__ __device__ inline bool attn_tile_class(int l, int ew, int h, int dh,
                                                int gated) {
  return !attn_mma_general(ew, h, gated) && ew <= 16 && h <= 8 &&
         (dh & 1) == 0 && dh <= 64 && round16(l) <= 16 * ATT_TILE_MAX_WARPS;
}

struct AttnTileLayout {
  int W, C, RB;                    // warps a block (16 keys each), blocks a
                                   // graph (the cluster), rows a block
  int LK, EK, NPK, nproj, se, sd, skv, nwg;
  int acc, vec, madd, smx, sden, sts, sdq, nfb;   // block f32 offsets
  int gs, ps, ds, ad, wrow, nfw;                  // warp f32 offsets
  int w, nbb;                                     // block bf16 offsets
  int kv, rb, nrb, e, dm, hh, dhh, qg, dcol, nbw; // warp bf16 offsets
  size_t bytes;
  __host__ __device__ AttnTileLayout(int l, int ew, int h, int dh, int gated) {
    LK = round16(l);
    W = LK / 16;
    C = 1;                         // at least 32 rows a block
    while (C < ATT_MAX_CLUSTER && l >= 64 * C) C *= 2;
    RB = (l + C - 1) / C;
    C = (l + RB - 1) / RB;         // no block without a row
    nproj = gated ? 2 * h : h;
    EK = round16(ew); NPK = round16(nproj);
    se = EK + 8; sd = NPK + 8;
    skv = dh + 8;                  // rows 4 banks apart (the da loop)
    nwg = ew * nproj + nproj + 2 * ew;
    int o = 0;
    acc = o;  o += r4(nwg);
    vec = o;  o += r4(NPK + 2 * EK);
    madd = o; o += r4(LK);
    smx = o;  o += r4(W * h);
    sden = o; o += r4(W * h);
    sts = o;  o += r4(W * h);
    sdq = o;  o += r4(W * dh);
    nfb = o;
    o = 0;
    gs = o;   o += 16 * h;
    ps = o;   o += 16 * h;
    ds = o;   o += 16 * h;
    ad = o;   o += 16 * h;
    wrow = o; o += 2 * EK;
    nfw = o;
    o = 0;
    w = o;    o += r8(EK * sd);
    nbb = o;
    o = 0;
    kv = o;   o += r8(2 * 16 * skv);
    rb = o;                        // row buffer b at rb + b nrb
    e = 0;    int q = 16 * se;
    dm = q;   q += 16 * se;
    hh = q;   q += 16 * h;
    dhh = q;  q += 16 * h;
    qg = q;   q += 2 * r8(dh);     // q_i, then gv_i
    nrb = r8(q);
    o += 2 * nrb;
    dcol = o; o += 16 * sd;
    nbw = r8(o);
    const size_t stage = (size_t)(nfb + W * nfw) * 4 + (size_t)(nbb + W * nbw) * 2;
    const size_t red = (size_t)(r4(nwg) + 2 * l * dh) * 4;
    bytes = stage > red ? stage : red;
  }
};

// NTE: n8 tiles of the edge width (EK = 16); MAXW: the most warps a block
// the instantiation takes (its registers a thread: 65,536 / (32 MAXW))
template <int NTE, int MAXW>
__global__ void __launch_bounds__(MAXW * 32, 1)
    bwd_attn_tile_kernel(AttnParams p) {
  constexpr int NPT = 2;           // n8 tiles of [gates | bias] (NPK 16)
  using bf = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh;
  const AttnTileLayout L(l, ew, h, dh, p.gated);
  const int nw = L.W, nproj = L.nproj, EK = L.EK, NPK = L.NPK;
  const int se = L.se, sd = L.sd, skv = L.skv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int C = L.C, rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const bool dropping = p.dr.dropping();
  const int j0 = 16 * warp, nk = min(16, l - j0);   // the warp's keys

  float* acc = sm + L.acc;                 // weight-gradient sums
  float *bgb = sm + L.vec, *g1 = bgb + NPK, *b1 = g1 + EK;
  float* madd = sm + L.madd;
  float *smx = sm + L.smx, *sden = sm + L.sden, *sts = sm + L.sts;
  float* sdq = sm + L.sdq;
  float* wf = sm + L.nfb + warp * L.nfw;
  float *gs = wf + L.gs, *ps = wf + L.ps, *wrow = wf + L.wrow;
  float *ds_s = wf + L.ds, *ad_s = wf + L.ad;
  bf* bs = reinterpret_cast<bf*>(sm + L.nfb + nw * L.nfw);
  bf* Ws = bs + L.w;
  bf* wb = bs + L.nbb + warp * L.nbw;
  bf *ks = wb + L.kv, *vs = ks + 16 * skv;
  bf* dcol = wb + L.dcol;

  const bf* E = (const bf*)p.e;
  const bf* QKV = (const bf*)p.qkv;
  const bf* HH = (const bf*)p.hh;
  const bf* DHH = (const bf*)p.dhh;
  const bf* DM = (const bf*)p.demid;
  const bf* GV = (const bf*)p.gv;
  bf* DE = (bf*)p.de;
  bf* DQ = (bf*)p.dq;

  // ---- zero the sums and the staging (padding rows and columns are never
  // written again); weights, biases, the key mask, the warp's k and v
  zero_smem(bs, L.nbb + nw * L.nbw);
  for (int t = tid; t < L.nfb + nw * L.nfw; t += blockDim.x) sm[t] = 0.f;
  __syncthreads();
  const bf* Wg = (const bf*)p.wg;
  const bf* Wb = (const bf*)p.wb;
  for (int t = tid; t < nproj + 2 * ew + l; t += blockDim.x) {
    if (t < nproj) {
      bgb[t] = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
    } else if (t < nproj + ew) {
      g1[t - nproj] = p.g1[t - nproj];
    } else if (t < nproj + 2 * ew) {
      b1[t - nproj - ew] = p.b1[t - nproj - ew];
    } else {
      const int j = t - nproj - 2 * ew;
      madd[j] = (p.mask[(size_t)b * l + j] - 1.f) * 1e9f;
    }
  }
  for (int t = tid; t < ew * nproj; t += blockDim.x) {
    const int c = t / nproj, n = t - c * nproj;
    Ws[c * sd + n] = (p.gated && n < h) ? Wg[c * h + n]
                                        : Wb[c * h + (n - (nproj - h))];
  }
  {
    const int hdh = dh >> 1;                 // dh is even: 4-byte copies
    for (int t = lane; t < nk * hdh; t += 32) {
      const int j = t / hdh, f = 2 * (t - j * hdh);
      const bf* r = QKV + ((size_t)b * l + j0 + j) * 3 * dh;
      *reinterpret_cast<uint32_t*>(ks + j * skv + f) =
          *reinterpret_cast<const uint32_t*>(r + dh + f);
    }
    const int ndd = dh / h;
    for (int t = lane; t < nk * dh; t += 32) {
      const int j = t / dh, f = t - j * dh, hd = f % h, c = f / h;
      vs[j * skv + hd * ndd + c] =
          QKV[((size_t)b * l + j0 + j) * 3 * dh + 2 * dh + f];
    }
  }

  // a row's tiles into row buffer rbuf: e, de_mid, hh, dhh of the warp's
  // keys (zeros past l), q_i and gv_i; one group. Where the widths allow
  // 16-byte copies (ew and dh multiples of 8, l h of 8), each lane's copy
  // of a tile is the same every row: lane c takes e's and de_mid's 16-byte
  // chunk c (row c / ecpr), hh's and dhh's chunk c, q's chunk c or gv's
  // chunk c - dh / 8
  const bool fast = (ew & 7) == 0 && (dh & 7) == 0 && ((l * h) & 7) == 0;
  const int ecpr = ew >> 3, er = lane / max(ecpr, 1);
  const int ec = 8 * (lane - er * ecpr);
  const bool ecp = lane < 16 * ecpr, eok = er < nk;
  const bool hcp = 8 * lane < 16 * h, hok = 8 * lane + 8 <= nk * h;
  const bool qcp = lane < (dh >> 3), gcp = !qcp && lane < (dh >> 2);
  auto issue_row = [&](int i, int rbuf) {
    const size_t row = (size_t)b * l + i;
    bf* rp = wb + L.rb + rbuf * L.nrb;
    const bf* esrc = E + (row * l + j0) * ew;
    const bf* msrc = DM + (row * l + j0) * ew;
    const bf* hsrc = HH + (row * l + j0) * h;
    const bf* dsrc = DHH + (row * l + j0) * h;
    if (fast) {
      if (ecp) {
        const int o = er * ew + ec;
        cp_async16(rp + L.e + er * se + ec, eok ? esrc + o : esrc, eok);
        cp_async16(rp + L.dm + er * se + ec, eok ? msrc + o : msrc, eok);
      }
      if (hcp) {                   // nk h is a multiple of 8 here
        cp_async16(rp + L.hh + 8 * lane, hok ? hsrc + 8 * lane : hsrc, hok);
        cp_async16(rp + L.dhh + 8 * lane, hok ? dsrc + 8 * lane : dsrc, hok);
      }
      if (qcp) cp_async16(rp + L.qg + 8 * lane, QKV + row * 3 * dh + 8 * lane,
                          true);
      if (gcp) cp_async16(rp + L.qg + r8(dh) + 8 * lane - dh,
                          GV + row * dh + 8 * lane - dh, true);
    } else {
      stage_rows(rp + L.e, se, esrc, 16, nk, ew);
      stage_rows(rp + L.dm, se, msrc, 16, nk, ew);
      for (int t = lane; t < nk * h; t += 32) {   // keys past l stay zero
        rp[L.hh + t] = hsrc[t];
        rp[L.dhh + t] = dsrc[t];
      }
      stage_vec(rp + L.qg, QKV + row * 3 * dh, dh);
      stage_vec(rp + L.qg + r8(dh), GV + row * dh, dh);
    }
    cp_async_commit();
  };

  const int rbeg = rank * L.RB, rend = min(l, rbeg + L.RB);
  // lane (kg, hd0): keys kg, kg + KG, ... (< 16) of the tile, head hd0
  const int HL = h, KG = 32 / HL;
  const int kg = lane / HL, hd0 = lane - kg * HL;
  const int ndd = dh / h;
  // lane's features f0, f0 + 1 in dq, dk and dv; their heads hf0, hf0 + 1
  // (h > 1: h is even, so hf0 is)
  const int f0 = 2 * lane, hf0 = f0 % h;
  const bool fown = f0 < dh;
  float dka[16][2], dva[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    dka[j][0] = dka[j][1] = dva[j][0] = dva[j][1] = 0.f;
  float dwacc[NTE / 2][NPT][4];
#pragma unroll
  for (int a = 0; a < NTE / 2; ++a)
#pragma unroll
    for (int n = 0; n < NPT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) dwacc[a][n][q] = 0.f;
  float sdg = 0.f, sdp = 0.f;

  // dq_i: the warps' parts in warp order, by one warp, two features a lane
  auto sum_dq = [&](int i) {
    if (fown) {
      float a0 = 0.f, a1 = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(sdq + w * dh + f0);
        a0 += v.x;
        a1 += v.y;
      }
      st_bf2(DQ + ((size_t)b * l + i) * dh + f0, a0, a1);
    }
  };

  issue_row(rbeg, 0);                        // every block has a row
  __syncthreads();                           // setup done

  for (int i = rbeg; i < rend; ++i) {
    const int rbuf = (i - rbeg) & 1;
    const size_t row = (size_t)b * l + i;
    if (i + 1 < rend) issue_row(i + 1, rbuf ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();                      // row i's tiles
    __syncwarp();
    bf* rp = wb + L.rb + rbuf * L.nrb;
    bf *erow = rp + L.e, *dmb = rp + L.dm, *hh_s = rp + L.hh;
    bf *dhh_s = rp + L.dhh, *qb = rp + L.qg, *gb = qb + r8(dh);

    // ---- LN1 and [G | P] = rnd(e_ln) . [Wg | Wb] + [bg | bb] of the tile;
    // e_ln goes from the C-fragment layout of e straight into A fragments
    float mu[2], rs[2];
    {
      float x[NTE][4];
#pragma unroll
      for (int j = 0; j < NTE; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 e0 = ld_bf2(erow + gq * se + c);
        const float2 e1 = ld_bf2(erow + (gq + 8) * se + c);
        x[j][0] = e0.x; x[j][1] = e0.y; x[j][2] = e1.x; x[j][3] = e1.y;
      }
      ln_stats(x, ew, mu, rs);
      float gp[NPT][4];
#pragma unroll
      for (int n = 0; n < NPT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) gp[n][q] = 0.f;
#pragma unroll
      for (int kb = 0; kb < NTE / 2; ++kb) {
        float v[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 16 * kb + 8 * jj + 2 * tq + (q & 1);
            v[jj][q] = c < ew ? g1[c] * ((x[2 * kb + jj][q] - mu[q >> 1]) *
                                         rs[q >> 1]) + b1[c]
                              : 0.f;
          }
        const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]),
                               pack_bf16(v[0][2], v[0][3]),
                               pack_bf16(v[1][0], v[1][1]),
                               pack_bf16(v[1][2], v[1][3])};
        uint32_t bb[4];
        ldb_kn(bb, Ws, sd, 16 * kb, 0);
        mma16816(gp[0], a, bb[0], bb[1]);
        mma16816(gp[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int jn = 0; jn < NPT; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 8 * jn + 2 * tq + (q & 1);
          const int j = gq + ((q >> 1) << 3);
          if (n < nproj) {
            const float z = gp[jn][q] + bgb[n];
            if (p.gated && n < h) gs[j * h + n] = z;
            else ps[j * h + n - (nproj - h)] = z;
          }
        }
    }
    __syncwarp();

    // ---- the softmax chain re-entered at the saved h_hat; the row's sums
    // over its keys are the warps' parts, added in warp order. The draws
    // and da = gv_i . v_j come first, for every key slot of the lane at
    // once, so that their chains overlap
    const float* arow = p.amask ? p.amask + row * l : nullptr;
    float s0[4], s1[4];          // logit, exp, a_sm; gate's sigmoid, da_sm
    float dav[4];                // da, then / keep where kept, 0 where not
    unsigned kept = 0xfu;        // dropout's kept bit of each slot
    float gvh[8];                // ndd 8: gv_i's features of head hd0
    if (ndd == 8)
#pragma unroll
      for (int c = 0; c < 8; ++c) gvh[c] = to_f(gb[c * h + hd0]);
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jj = kg + KG * t, j = j0 + jj;
      const int jc = min(j, l - 1);          // a key of the row, for loads
      float add = madd[jc];
      if (arow) add += (arow[jc] - 1.f) * 1e9f;
      const float rm = p.dr.mask_add(b, i, j, hd0);
      const int u = (jj & 15) * h + hd0;
      const bf* vr = vs + (jj & 15) * skv + hd0 * ndd;
      float da = 0.f;
      if (ndd == 8) {              // one 16-byte read of v_j's head
        const uint4 v8 = *reinterpret_cast<const uint4*>(vr);
        const uint32_t vw[4] = {v8.x, v8.y, v8.z, v8.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 v2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&vw[c]));
          da = fmaf(gvh[2 * c], v2.x, da);
          da = fmaf(gvh[2 * c + 1], v2.y, da);
        }
      } else {
        for (int c = 0; c < ndd; ++c)
          da = fmaf(to_f(gb[c * h + hd0]), to_f(vr[c]), da);
      }
      if (dropping) {
        const bool kp = p.dr.kept(b, i, j, hd0);
        if (!kp) kept &= ~(1u << t);
        da = kp ? da / p.dr.keep : 0.f;
      }
      dav[t] = da;
      s0[t] = to_f(hh_s[u]) + add + rm;
      s1[t] = p.gated ? sigmoid(gs[u] + add + rm) : 1.f;
      if (jj < 16 && j < l) mx = fmaxf(mx, s0[t]);
    }
    mx = head_max(mx, HL);
    if (kg == 0) smx[warp * h + hd0] = mx;
    __syncthreads();
    if (i > rbeg && warp == (i - 1 - rbeg) % nw) sum_dq(i - 1);
    mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, smx[w * h + hd0]);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jj = kg + KG * t;
      if (jj < 16 && j0 + jj < l) {
        const float ex = expf(s0[t] - mx);
        s0[t] = ex;
        sum += ex;
      }
    }
    sum = head_sum(sum, HL);
    if (kg == 0) sden[warp * h + hd0] = sum;
    __syncthreads();
    float den = 0.f;
    for (int w = 0; w < nw; ++w) den += sden[w * h + hd0];
    den = fmaxf(den, 1e-30f);
    // dropout and gate backward; a_sm and da_sm replace exp and sg
    float ts = 0.f, dgs = 0.f, dps = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jj = kg + KG * t;
      if (jj < 16 && j0 + jj < l) {
        const float da = dav[t];
        const float a_sm = s0[t] / den, s = s1[t];
        float a = p.gated ? a_sm * s : a_sm;
        if (dropping) a = (kept >> t) & 1u ? a / p.dr.keep : 0.f;
        ad_s[jj * h + hd0] = rnd<bf>(a);
        float dasm = da;
        if (p.gated) {
          dasm = da * s;
          const float dgt = da * a_sm * s * (1.f - s);
          dcol[jj * sd + hd0] = __float2bfloat16_rn(dgt);
          dgs += dgt;
        }
        s0[t] = a_sm;
        s1[t] = dasm;
        ts += dasm * a_sm;
      }
    }
    ts = head_sum(ts, HL);
    if (kg == 0) sts[warp * h + hd0] = ts;
    __syncthreads();
    ts = 0.f;
    for (int w = 0; w < nw; ++w) ts += sts[w * h + hd0];
    // softmax and clip backward; edge-bias activation backward
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int jj = kg + KG * t;
      if (jj < 16 && j0 + jj < l) {
        const int u = jj * h + hd0;
        const float dH = s0[t] * (s1[t] - ts) + to_f(dhh_s[u]);
        float d = dH * p.scale;
        const float P = ps[u];
        const float Ev = act_fn(p.edge_act, p.edge_alpha, P);
        if (p.has_clip) {
          const float sc = to_f(hh_s[u]) - Ev;
          if (!(sc > p.lo && sc < p.hi)) d = 0.f;
        }
        ds_s[u] = rnd<bf>(d);
        const float dp = dH * act_grad(p.edge_act, p.edge_alpha, P, Ev);
        dcol[jj * sd + (nproj - h) + hd0] = __float2bfloat16_rn(dp);
        dps += dp;
      }
    }
    sdg += dgs;
    sdp += dps;
    __syncwarp();

    // ---- dq_i's part over the warp's keys; dk_j += rnd(ds) q_i, dv_j +=
    // rnd(a_drop) gv_i (keys past l add zeros)
    if (fown) {
      const float2 qv = ld_bf2(qb + f0), gv = ld_bf2(gb + f0);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 dsv, av;
        if (h > 1) {
          dsv = *reinterpret_cast<const float2*>(ds_s + j * h + hf0);
          av = *reinterpret_cast<const float2*>(ad_s + j * h + hf0);
        } else {
          dsv.x = dsv.y = ds_s[j];
          av.x = av.y = ad_s[j];
        }
        const float2 kv = ld_bf2(ks + j * skv + f0);
        a0 = fmaf(dsv.x, kv.x, a0);
        a1 = fmaf(dsv.y, kv.y, a1);
        dka[j][0] = fmaf(dsv.x, qv.x, dka[j][0]);
        dka[j][1] = fmaf(dsv.y, qv.y, dka[j][1]);
        dva[j][0] = fmaf(av.x, gv.x, dva[j][0]);
        dva[j][1] = fmaf(av.y, gv.y, dva[j][1]);
      }
      *reinterpret_cast<float2*>(sdq + warp * dh + f0) = make_float2(a0, a1);
    }

    // ---- the tile's de_ln = rnd([dgate | dP]) . [Wg | Wb]^T, dW +=
    // rnd(e_ln)^T rnd([dgate | dP]), LN1 backward plus de_mid
    {
      float x1[NTE][4];
#pragma unroll
      for (int j = 0; j < NTE; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 e0 = ld_bf2(erow + gq * se + c);
        const float2 e1 = ld_bf2(erow + (gq + 8) * se + c);
        const float ev[4] = {e0.x, e0.y, e1.x, e1.y};
        float y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = c + (q & 1) < ew;
          x1[j][q] = ok ? (ev[q] - mu[q >> 1]) * rs[q >> 1] : 0.f;
          y[q] = ok ? g1[c + (q & 1)] * x1[j][q] + b1[c + (q & 1)] : 0.f;
        }
        st_bf2(erow + gq * se + c, y[0], y[1]);   // rnd(e_ln) over e
        st_bf2(erow + (gq + 8) * se + c, y[2], y[3]);
      }
      __syncwarp();
      float dl[NTE][4];
#pragma unroll
      for (int j = 0; j < NTE; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) dl[j][q] = 0.f;
      {
        uint32_t a[4];
        lda(a, dcol, sd, 0, 0);
#pragma unroll
        for (int jb = 0; jb < NTE / 2; ++jb) {
          uint32_t bb[4];
          ldb_nk(bb, Ws, sd, 0, 16 * jb);
          mma16816(dl[2 * jb], a, bb[0], bb[1]);
          mma16816(dl[2 * jb + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < NTE / 2; ++mt) {
        uint32_t a[4], bb[4];
        lda_t(a, erow, se, 0, 16 * mt);
        ldb_kn(bb, dcol, sd, 0, 0);
        mma16816(dwacc[mt][0], a, bb[0], bb[1]);
        mma16816(dwacc[mt][1], a, bb[2], bb[3]);
      }
      // de = (dx - m1 - x1 m2) rstd + de_mid, dx = de_ln g1; dg1 += sum
      // de_ln x1, db1 += sum de_ln (keys past l add 0)
      float a0 = 0.f, c0 = 0.f, a1 = 0.f, c1 = 0.f;
#pragma unroll
      for (int j = 0; j < NTE; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = 8 * j + 2 * tq + q;
          if (c < ew) {
            const float d0 = dl[j][q] * g1[c], d1 = dl[j][2 + q] * g1[c];
            a0 += d0; c0 += d0 * x1[j][q];
            a1 += d1; c1 += d1 * x1[j][2 + q];
          }
        }
      const float m10 = quad_sum(a0) / ew, m20 = quad_sum(c0) / ew;
      const float m11 = quad_sum(a1) / ew, m21 = quad_sum(c1) / ew;
      __syncwarp();                          // e_ln is read
#pragma unroll
      for (int j = 0; j < NTE; ++j) {
        const int cb = 8 * j + 2 * tq;
        const float2 dm0 = ld_bf2(dmb + gq * se + cb);
        const float2 dm1 = ld_bf2(dmb + (gq + 8) * se + cb);
        const float dmv[4] = {dm0.x, dm0.y, dm1.x, dm1.y};
        float de[4], sg1[2], sb1[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = cb + q;
          const bool ok = c < ew;
          const float d0 = dl[j][q], d1 = dl[j][2 + q];
          de[q] = ok ? (d0 * g1[c] - m10 - x1[j][q] * m20) * rs[0] + dmv[q]
                     : 0.f;
          de[2 + q] = ok ? (d1 * g1[c] - m11 - x1[j][2 + q] * m21) * rs[1] +
                               dmv[2 + q]
                         : 0.f;
          sg1[q] = d0 * x1[j][q] + d1 * x1[j][2 + q];
          sb1[q] = d0 + d1;
        }
        st_bf2(erow + gq * se + cb, de[0], de[1]);
        st_bf2(erow + (gq + 8) * se + cb, de[2], de[3]);
        // the tile's dg1 (X), db1 (Y) column sums; one owning lane each
        const float cs = tile_colsum(sg1[0], sg1[1], sb1[0], sb1[1]);
        if (!(lane & 4))
          wrow[(lane & 16 ? EK : 0) + cb + (lane & 8 ? 1 : 0)] += cs;
      }
      __syncwarp();
      store_rows16(DE + (row * l + j0) * ew, erow, se, nk, ew);
    }
    __syncwarp();                  // this row buffer is staged again next
  }
  cp_async_wait<0>();
  __syncthreads();
  if (warp == (rend - 1 - rbeg) % nw) sum_dq(rend - 1);

  // ---- the warps' weight-gradient parts into the block's sums, in warp
  // order (each element has one owning lane)
  sdg = head_sum(sdg, HL);
  sdp = head_sum(sdp, HL);
  for (int w = 0; w < nw; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mo = 0; mo < NTE / 2; ++mo)
#pragma unroll
        for (int jn = 0; jn < NPT; ++jn)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = 16 * mo + gq + ((q >> 1) << 3);
            const int n = 8 * jn + 2 * tq + (q & 1);
            if (m < ew && n < nproj) acc[m * nproj + n] += dwacc[mo][jn][q];
          }
      if (kg == 0) {
        if (p.gated) acc[ew * nproj + hd0] += sdg;
        acc[ew * nproj + (nproj - h) + hd0] += sdp;
      }
      for (int c = lane; c < ew; c += 32) {
        acc[ew * nproj + nproj + c] += wrow[c];
        acc[ew * nproj + nproj + ew + c] += wrow[EK + c];
      }
    }
    __syncthreads();
  }

  // ---- [sums | dk | dv] in shared memory (over the dead staging); rank r
  // of the cluster adds its share over the ranks' shared memory in rank
  // order and writes it once
  const int kvo = r4(L.nwg);
  float* red = acc;
  if (fown)
    for (int j = 0; j < nk; ++j) {
      float* dkr = red + kvo + (j0 + j) * dh + f0;
      float* dvr = red + kvo + l * dh + (j0 + j) * dh + f0;
      *reinterpret_cast<float2*>(dkr) = make_float2(dka[j][0], dka[j][1]);
      *reinterpret_cast<float2*>(dvr) = make_float2(dva[j][0], dva[j][1]);
    }
  cluster.sync();
  const int nred = kvo + 2 * l * dh;
  const int chunk = (nred + C - 1) / C;
  const int e0 = rank * chunk, e1 = min(nred, e0 + chunk);
  const float* rpk[ATT_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < ATT_MAX_CLUSTER; ++q)
    rpk[q] = cluster.map_shared_rank(red, q < C ? q : 0);
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    if (e >= L.nwg && e < kvo) continue;     // padding
    float v[ATT_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < ATT_MAX_CLUSTER; ++q) v[q] = q < C ? rpk[q][e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < ATT_MAX_CLUSTER; ++q)
      if (q < C) s += v[q];
    if (e < L.nwg) p.partials[(size_t)b * L.nwg + e] = s;
    else if (e < kvo + l * dh) p.dk[(size_t)b * l * dh + e - kvo] = s;
    else p.dv[(size_t)b * l * dh + e - kvo - l * dh] = s;
  }
  cluster.sync();      // no block leaves while another reads its memory
}

template <int NTE, int MAXW>
int launch_tile(const AttnParams& p, float* dw, const AttnTileLayout& L,
                cudaStream_t stream) {
  auto kern = bwd_attn_tile_kernel<NTE, MAXW>;
  cudaError_t err = allow_smem<bwd_attn_tile_kernel<NTE, MAXW>>(L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.B * L.C));
  cfg.blockDim = dim3((unsigned)(32 * L.W));
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)L.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, p.B, L.nwg, dw, stream);
}

// Whether K5 (bf16, de_mid and dhh handed over in bf16) runs a shape on the
// tiled body: where the shape is of its class, fits 227 KB and the cluster
// body would seat fewer than 8 warps a block. K7 and K6 (f32 hand-off) keep
// the cluster body.
__host__ __device__ inline bool attn_takes_tile(int l, int ew, int h, int dh,
                                                int gated) {
  if (!attn_tile_class(l, ew, h, dh, gated)) return false;
  if (AttnTileLayout(l, ew, h, dh, gated).bytes > (size_t)ATT_SMEM_MAX)
    return false;
  return attn_mma_layout(l, ew, h, dh, gated, false).W < ATT_MMA_WARPS;
}

// f32: the CUDA-core body (exact f32 products), one block a graph; k, v,
// dk and dv in shared memory where they fit, else kv_global
inline AttnLayout attn_simt_layout(int l, int ew, int h, int dh, int gated) {
  const int nproj = gated ? 2 * h : h;
  const AttnLayout L(l, ew, h, dh, nproj, false);
  return L.bytes() <= (size_t)ATT_SMEM_MAX ? L
                                           : AttnLayout(l, ew, h, dh, nproj, true);
}

// MONO: the mono switch (K6)
template <bool MONO = false>
int launch_simt(const AttnParams& p, float* dw, cudaStream_t stream) {
  const AttnLayout L = attn_simt_layout(p.l, p.ew, p.h, p.dh, p.gated);
  const size_t smem = L.bytes();
  if (smem > (size_t)ATT_SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = L.kvg ? allow_smem<bwd_attn_kernel<true, MONO>>(smem)
                          : allow_smem<bwd_attn_kernel<false, MONO>>(smem);
  if (err != cudaSuccess) return (int)err;
  if (L.kvg)
    bwd_attn_kernel<true, MONO><<<(unsigned)p.B, ATT_NT, smem, stream>>>(p);
  else
    bwd_attn_kernel<false, MONO><<<(unsigned)p.B, ATT_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, p.B, L.nw, dw, stream);
}

// bf16: the tiled body where attn_takes_tile says so (K5 only), else the
// tensor-core cluster body, de_mid and dhh read as HT; MONO: the mono switch
// (K6; HT float)
template <typename HT, bool MONO = false>
int launch_bf16(const AttnParams& p, float* dw, cudaStream_t stream) {
  constexpr bool F32H = std::is_same<HT, float>::value;
  if constexpr (!F32H)
    if (attn_takes_tile(p.l, p.ew, p.h, p.dh, p.gated)) {
      // 9-12 warps (l 129-192): one block a SM either way, so up to 170
      // registers a thread; else 128 (two blocks a SM up to 8 warps)
      const AttnTileLayout T(p.l, p.ew, p.h, p.dh, p.gated);
      return T.W > 8 && T.W <= 12 ? launch_tile<2, 12>(p, dw, T, stream)
                                  : launch_tile<2, ATT_TILE_MAX_WARPS>(p, dw, T,
                                                                       stream);
    }
  const AttnMmaLayout L = attn_mma_layout(p.l, p.ew, p.h, p.dh, p.gated, F32H);
  if (L.W == 0) return (int)cudaErrorInvalidConfiguration;
  if (L.general)
    return L.kvg ? launch_mma<true, HT, true, MONO>(p, dw, L, stream)
                 : launch_mma<true, HT, false, MONO>(p, dw, L, stream);
  return L.kvg ? launch_mma<false, HT, true, MONO>(p, dw, L, stream)
               : launch_mma<false, HT, false, MONO>(p, dw, L, stream);
}

}  // namespace egt
