// Whole EGT layer, backward in one kernel with nothing saved but the inputs
// ("mono", K6), for sm_90a: the edge tail's backward (K4's chain,
// edge_tail.cuh's tile functions) and the attention and edge-head backward
// (K5's chain) run one query row after the other inside one block, so
// de_mid and dhh never go to device memory. It serves
// fused_layer_bwd_mono.cu (K6) only: no saved h_hat; q.k and h_hat are
// recomputed (egt_tpu/ops/fused_layer_pallas.py::_bwd_kernel). (K7, the
// merged backward from the saved h_hat, runs K4's and K5's own bodies:
// fused_layer_bwd_merged.cu.)
//
// For every query row (b, i) and key j, head hd (feature f = dd * h + hd):
//   x1 = LN(e) normalised, e_ln = rnd(g1 x1 + b1)
//   G = e_ln . Wg + bg,  P = e_ln . Wb + bb,  E = act_e(P)
//   s = q_i . k_j * scale,  hh = clip(s) + E  (f32),  sc = s
//   the tail backward of the l pairs (i, .) from rnd(hh) and g_eout:
//     de_mid (ew) and dhh (h) in f32, kept on chip; its 8 weight gradients
//   softmax chain at hh: logits = hh + madd (+ aadd) (+ rmask),
//     gates = G + madd (+ aadd) (+ rmask), a_sm = softmax_j, sg = sigmoid,
//     a_drop = kept ? a_sm sg / keep : 0      (draws regenerated: philox.cuh)
//   da = (gv_i . v_j per head), / keep where kept, 0 where dropped
//   da_sm = da sg,  dgate = da a_sm sg (1 - sg)
//   dH = a_sm (da_sm - sum_j da_sm a_sm) + dhh
//   ds = (lo < sc < hi) ? dH * scale : 0          (strict, as the TPU kernels)
//   dq_i = sum_j rnd(ds) k_j;  dk_j += rnd(ds) q_i;  dv_j += rnd(a_drop) gv_i
//   dP = dH act_e'(P);  de_ln = rnd(dP) . Wb^T + rnd(dgate) . Wg^T
//   de = LN backward of de_ln + de_mid
// and the head's weight gradients dWg = e_ln^T rnd(dgate), dbg = sum dgate,
// dWb = e_ln^T rnd(dP), dbb = sum dP, dg1 = sum de_ln x1, db1 = sum de_ln.
// de and dq are written in the working type; dk, dv and the 14 weight
// gradients are f32.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, hidden 128, dh 64, bf16) it moves ~62 MB (e, g_eout and de;
// qkv, g_vatt, dq, dk, dv), ~19 us at 3.35 TB/s, and does ~18 GFLOP of
// products, ~19 us at the bf16 tensor-core peak. This first kernel runs its products on the f32 CUDA
// cores (67 TFLOP/s), so those FLOPs set its time.
//
// Design: the TPU kernel carries dk, dv and the 14 weight-gradient sums in
// VMEM across an in-order grid. Here one block takes one graph and walks
// its query rows. A row's l pairs go through the tail backward as one tile
// (or tiles of 32, 16, 8 pairs where a row does not fit), whose de_mid and
// dhh land in the row's shared-memory buffers, where the attention
// backward reads them. The weight-gradient sums stay
// in shared memory (each element owned by one thread) and are written as
// one partial row per block; launch_sum_partials adds the rows in a fixed
// order. dk and dv accumulate in the block's own rows of the f32 outputs
// (each element owned by one thread); k and v are read from device memory
// (they stay in L1/L2). No float atomics: a rerun is bit-identical. Shared
// memory at the flagship shape: ~74 KB of f32 sums, the weights once each
// (rows padded so transposed reads have no bank conflicts), ~48 KB of row
// buffers and the tile's scratch: ~211 KB in bf16 (a whole row a tile),
// ~216 KB in f32 (16 pairs a tile). Measured on an H100, the tile
// functions run the tail ~40% slower than K4's inline body, and one block
// a graph fills 128 of 132 SMs (PERF.md).
#pragma once

#include "edge_tail.cuh"
#include "philox.cuh"

namespace egt {

constexpr int ROW_NT = 256;

struct RowParams {
  const void* e; const void* qkv; const float* mask; const float* amask;
  const void* wg; const float* bg; const void* wb; const float* bb;
  const float* g1; const float* b1;
  const void* wr; const float* br; const float* g2; const float* b2;
  const void* w1; const float* bb1; const void* w2; const float* bb2;
  const void* geout; const void* gv;
  void* de; void* dq; float* dk; float* dv; float* partials;
  int B, l, ew, h, dh, hid, gated, has_clip;
  float lo, hi, scale;
  int edge_act, act; float edge_alpha, act_alpha;
  Draws dr;
  int tp;           // tail pairs per tile
};

// shared-memory carve-up: floats, then working-type weights
struct RowLayout {
  int nw_tail, nw;                                       // sums
  int dwgb, dbgb, dg1, db1;                              // head sums
  int tailw, bgb, g1, b1;                                // vectors
  int x1, eln, rstd1, em, hh, dhh, sg, pp, ev, sc, lm;   // row buffers
  int dasm, dgt, ds, dp, ad, madd, tsum, q, gv, tile, nf;
  int sp, wgb, tailt, nt;                                // T offsets
  template <typename T>
  __host__ __device__ RowLayout(T*, int l, int ew, int h, int dh, int hid,
                                int nproj, int tp) {
    const TailW<T> W(h, ew, hid);
    int o = 0;
    nw_tail = TailAcc(ew, h, hid).n;
    o = nw_tail;
    dwgb = o; o += ew * nproj;     // [gates | bias] columns
    dbgb = o; o += nproj;
    dg1 = o;  o += ew;
    db1 = o;  o += ew;
    nw = o;
    tailw = o; o += W.nf();
    bgb = o;  o += nproj;
    g1 = o;   o += ew;
    b1 = o;   o += ew;
    x1 = o;   o += l * ew;
    eln = o;  o += l * ew;         // e_ln (rounded), later de_ln
    rstd1 = o; o += l;
    em = o;   o += l * ew;         // e, then e_mid, then de_mid
    hh = o;   o += l * h;
    dhh = o;  o += l * h;
    sg = o;   o += l * h;          // gate pre-activation, then sigmoid
    pp = o;   o += l * h;          // edge-bias pre-activation
    ev = o;   o += l * h;          // E
    sc = o;   o += l * h;          // the clip test's value
    lm = o;   o += l * h;          // logits, then a_sm
    dasm = o; o += l * h;
    dgt = o;  o += l * h;
    ds = o;   o += l * h;
    dp = o;   o += l * h;
    ad = o;   o += l * h;
    madd = o; o += l;
    tsum = o; o += h;
    q = o;    o += dh;
    gv = o;   o += dh;
    tile = o; o += TailTile::scratch(tp, ew, hid);
    nf = (o + 3) & ~3;
    sp = pad_stride<T>(nproj);
    int w = 0;
    wgb = w;   w += ew * sp;
    tailt = w; w += W.nt();
    nt = w;
  }
  template <typename T> __host__ __device__ size_t bytes() const {
    return (size_t)nf * sizeof(float) + (size_t)nt * sizeof(T);
  }
};

template <typename T>
__global__ void __launch_bounds__(ROW_NT) bwd_mono_kernel(RowParams p) {
  constexpr int NT = ROW_NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh, hid = p.hid;
  const int nproj = p.gated ? 2 * h : h;
  const RowLayout L((T*)nullptr, l, ew, h, dh, hid, nproj, p.tp);
  T* ws = reinterpret_cast<T*>(sm + L.nf);
  TailW<T> W(h, ew, hid);
  W.carve(sm + L.tailw, ws + L.tailt);
  float *acc = sm, *dwgb = sm + L.dwgb, *dbgb = sm + L.dbgb;
  float *dg1 = sm + L.dg1, *db1 = sm + L.db1;
  float *bgb = sm + L.bgb, *g1 = sm + L.g1, *b1 = sm + L.b1;
  float *x1 = sm + L.x1, *eln = sm + L.eln, *rstd1 = sm + L.rstd1;
  float *em = sm + L.em, *hh = sm + L.hh, *dhh = sm + L.dhh, *sg = sm + L.sg;
  float *pp = sm + L.pp, *ev = sm + L.ev, *sc = sm + L.sc, *lm = sm + L.lm;
  float *dasm = sm + L.dasm, *dgt = sm + L.dgt, *ds = sm + L.ds;
  float *dp = sm + L.dp, *ad = sm + L.ad, *madd = sm + L.madd;
  float *tsum = sm + L.tsum, *q_s = sm + L.q, *gv_s = sm + L.gv;
  T* wgb = ws + L.wgb;
  const int sp = L.sp;
  TailTile s;   // the tile's scratch; its hh and em point into the row
  s.carve_scratch(sm + L.tile, p.tp, ew, hid);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const bool dropping = p.dr.dropping();

  // ---- weights, the key mask; zero the sums and the graph's dk, dv
  W.load((const T*)p.wr, p.br, p.g2, p.b2, (const T*)p.w1, p.bb1,
         (const T*)p.w2, p.bb2);
  const T* Wg = (const T*)p.wg;
  const T* Wb = (const T*)p.wb;
  for (int t = tid; t < ew * nproj; t += NT) {
    const int c = t / nproj, n = t % nproj;
    wgb[c * sp + n] =
        (p.gated && n < h) ? Wg[c * h + n] : Wb[c * h + (n - (nproj - h))];
  }
  for (int t = tid; t < nproj; t += NT)
    bgb[t] = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
  for (int t = tid; t < ew; t += NT) { g1[t] = p.g1[t]; b1[t] = p.b1[t]; }
  for (int t = tid; t < l; t += NT) madd[t] = (p.mask[(size_t)b * l + t] - 1.f) * 1e9f;
  for (int t = tid; t < L.nw; t += NT) acc[t] = 0.f;
  float* DK = p.dk + (size_t)b * l * dh;
  float* DV = p.dv + (size_t)b * l * dh;
  for (int t = tid; t < l * dh; t += NT) { DK[t] = 0.f; DV[t] = 0.f; }

  const T* E = (const T*)p.e;
  const T* QKV = (const T*)p.qkv;
  const T* GE = (const T*)p.geout;
  const T* GV = (const T*)p.gv;
  T* DE = (T*)p.de;
  T* DQ = (T*)p.dq;
  auto kv = [&](int j, int f, int which) {   // which 1: k, 2: v
    return to_f(QKV[((size_t)b * l + j) * 3 * dh + which * dh + f]);
  };

  for (int i = 0; i < l; ++i) {
    const size_t row = (size_t)b * l + i;
    const size_t ebase = row * l * ew;          // e[b, i, 0, 0]
    const float* arow = p.amask ? p.amask + row * l : nullptr;
    __syncthreads();  // setup done; the previous row is done
    for (int t = tid; t < dh; t += NT) {
      q_s[t] = to_f(QKV[row * 3 * dh + t]);
      gv_s[t] = to_f(GV[row * dh + t]);
    }
    for (int t = tid; t < l * ew; t += NT) {
      const float x = to_f(E[ebase + t]);
      x1[t] = x;
      em[t] = x;
    }
    __syncthreads();

    // ---- edge pre-LN, one warp per key: x1 normalised, e_ln rounded
    for (int j = warp; j < l; j += NT / 32) {
      float* x = x1 + j * ew;
      float sum = 0.f;
      for (int c = lane; c < ew; c += 32) sum += x[c];
      const float mu = warp_sum(sum) / ew;
      float s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float d = x[c] - mu;
        s2 += d * d;
      }
      const float rs = rsqrtf(warp_sum(s2) / ew + LN_EPS);
      for (int c = lane; c < ew; c += 32) {
        const float xv = (x[c] - mu) * rs;
        x[c] = xv;
        eln[j * ew + c] = rnd<T>(g1[c] * xv + b1[c]);
      }
      if (lane == 0) rstd1[j] = rs;
    }
    __syncthreads();

    // ---- gates and edge-bias pre-activations
    tile_gemm<NT>(l, nproj, ew,
        [&](int m, int k) { return eln[m * ew + k]; },
        [&](int k, int n) { return to_f(wgb[k * sp + n]); },
        [&](int m, int n, float y) {
          const float z = y + bgb[n];
          if (p.gated && n < h) sg[m * h + n] = z;
          else pp[m * h + (n - (nproj - h))] = z;
        });
    __syncthreads();

    // ---- h_hat from q.k and the masked logits and gates
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      const float Ev = act_fn(p.edge_act, p.edge_alpha, pp[t]);
      ev[t] = Ev;
      float sv = 0.f;
      for (int f = hd; f < dh; f += h) sv = fmaf(q_s[f], kv(j, f, 1), sv);
      sv *= p.scale;
      sc[t] = sv;
      const float hval = (p.has_clip ? fminf(fmaxf(sv, p.lo), p.hi) : sv) + Ev;
      hh[t] = hval;
      float add = madd[j];
      if (arow) add += (arow[j] - 1.f) * 1e9f;
      const float rm = p.dr.mask_add(b, i, j, hd);
      lm[t] = hval + add + rm;
      sg[t] = p.gated ? sigmoid(sg[t] + add + rm) : 1.f;
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < l; j += 32) mx = fmaxf(mx, lm[j * h + hd]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < l; j += 32) {
        const float ex = expf(lm[j * h + hd] - mx);
        lm[j * h + hd] = ex;
        sum += ex;
      }
      const float den = fmaxf(warp_sum(sum), 1e-30f);
      for (int j = lane; j < l; j += 32) lm[j * h + hd] /= den;
    }

    // ---- the tail backward of the row's pairs, TP at a time: de_mid in
    // em and dhh (f32) stay in shared memory
    for (int j0 = 0; j0 < l; j0 += p.tp) {
      const int np = min(p.tp, l - j0);
      TailTile t = s;
      t.hh = hh + j0 * h;
      t.em = em + j0 * ew;
      __syncthreads();  // the previous tile (or the softmax) is done
      for (int u = tid; u < np * ew; u += NT)
        t.g[u] = to_f(GE[ebase + (size_t)j0 * ew + u]);
      __syncthreads();
      tail_fwd_tile<NT, T>(W, t, np, p.act, p.act_alpha);
      tail_bwd_tile<NT, T>(W, t, np, p.act, p.act_alpha, acc,
          [&](int, int, float) {},
          [&](int m, int k, float y) { dhh[(j0 + m) * h + k] = y; });
    }

    // ---- dropout and gate backward
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      float da = 0.f;
      for (int f = hd; f < dh; f += h) da = fmaf(gv_s[f], kv(j, f, 2), da);
      const float a_sm = lm[t], sgv = sg[t];
      float a = p.gated ? a_sm * sgv : a_sm;
      if (dropping) {
        const bool kp = p.dr.kept(b, i, j, hd);
        da = kp ? da / p.dr.keep : 0.f;
        a = kp ? a / p.dr.keep : 0.f;
      }
      ad[t] = rnd<T>(a);
      if (p.gated) {
        dasm[t] = da * sgv;
        dgt[t] = da * a_sm * sgv * (1.f - sgv);
      } else {
        dasm[t] = da;
        dgt[t] = 0.f;
      }
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float sum = 0.f;
      for (int j = lane; j < l; j += 32) sum += dasm[j * h + hd] * lm[j * h + hd];
      sum = warp_sum(sum);
      if (lane == 0) tsum[hd] = sum;
    }
    __syncthreads();

    // ---- softmax and clip backward; edge-bias activation backward
    for (int t = tid; t < l * h; t += NT) {
      const int hd = t % h;
      const float dH = lm[t] * (dasm[t] - tsum[hd]) + dhh[t];
      float d = dH * p.scale;
      if (p.has_clip && !(sc[t] > p.lo && sc[t] < p.hi)) d = 0.f;
      ds[t] = rnd<T>(d);
      dp[t] = dH * act_grad(p.edge_act, p.edge_alpha, pp[t], ev[t]);
    }
    __syncthreads();

    // ---- dq, dk, dv
    for (int f = tid; f < dh; f += NT) {
      const int hd = f % h;
      float sum = 0.f;
      for (int j = 0; j < l; ++j) sum = fmaf(ds[j * h + hd], kv(j, f, 1), sum);
      DQ[row * dh + f] = from_f<T>(sum);
    }
    for (int t = tid; t < l * dh; t += NT) {
      const int j = t / dh, f = t % dh, hd = f % h;
      DK[t] = fmaf(ds[j * h + hd], q_s[f], DK[t]);
      DV[t] = fmaf(ad[j * h + hd], gv_s[f], DV[t]);
    }

    // ---- head weight gradients: dW[gb] += e_ln^T rnd([dgate | dP]), db[gb]
    auto dcol = [&](int j, int n) {
      return (p.gated && n < h) ? dgt[j * h + n] : dp[j * h + (n - (nproj - h))];
    };
    tile_gemm<NT>(ew, nproj, l,
        [&](int m, int k) { return eln[k * ew + m]; },
        [&](int k, int n) { return rnd<T>(dcol(k, n)); },
        [&](int m, int n, float y) { dwgb[m * nproj + n] += y; });
    for (int n = tid; n < nproj; n += NT) {
      float sum = 0.f;
      for (int j = 0; j < l; ++j) sum += dcol(j, n);
      dbgb[n] += sum;
    }
    __syncthreads();  // e_ln is read above; de_ln replaces it below

    // ---- de_ln = rnd([dgate | dP]) . [Wg | Wb]^T
    tile_gemm<NT>(l, ew, nproj,
        [&](int m, int k) { return rnd<T>(dcol(m, k)); },
        [&](int k, int n) { return to_f(wgb[n * sp + k]); },
        [&](int m, int n, float y) { eln[m * ew + n] = y; });
    __syncthreads();
    for (int c = tid; c < ew; c += NT) {
      float sum = 0.f, s2 = 0.f;
      for (int j = 0; j < l; ++j) {
        sum += eln[j * ew + c] * x1[j * ew + c];
        s2 += eln[j * ew + c];
      }
      dg1[c] += sum;
      db1[c] += s2;
    }
    // ---- edge LayerNorm backward + de_mid, one warp per key
    for (int j = warp; j < l; j += NT / 32) {
      const float* d = eln + j * ew;
      const float* xr = x1 + j * ew;
      float sum = 0.f, s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        sum += dx;
        s2 += dx * xr[c];
      }
      const float m1 = warp_sum(sum) / ew, m2 = warp_sum(s2) / ew;
      const float rs = rstd1[j];
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        DE[ebase + (size_t)j * ew + c] =
            from_f<T>((dx - m1 - xr[c] * m2) * rs + em[j * ew + c]);
      }
    }
  }
  __syncthreads();
  float* part = p.partials + (size_t)b * L.nw;
  for (int t = tid; t < L.nw; t += NT) part[t] = acc[t];
}

template <typename T>
__host__ inline size_t row_smem(int l, int ew, int h, int dh, int hid,
                                int gated, int tp) {
  return RowLayout((T*)nullptr, l, ew, h, dh, hid, gated ? 2 * h : h, tp)
      .template bytes<T>();
}

// Pairs per tail tile: a whole row where it fits in `optin` bytes of shared
// memory (one pass of the tail a row), else the largest tile of 32, 16 or 8
// pairs that fits (0 if none does).
template <typename T>
__host__ inline int row_tp(int l, int ew, int h, int dh, int hid, int gated,
                           size_t optin) {
  if (l <= 64 && row_smem<T>(l, ew, h, dh, hid, gated, l) <= optin) return l;
  for (int tp = 32; tp >= 8; tp /= 2)
    if (row_smem<T>(l, ew, h, dh, hid, gated, tp) <= optin) return tp;
  return 0;
}

template <typename T>
int row_launch(RowParams p, float* dw, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  p.tp = row_tp<T>(p.l, p.ew, p.h, p.dh, p.hid, p.gated, (size_t)optin);
  if (p.tp == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = row_smem<T>(p.l, p.ew, p.h, p.dh, p.hid, p.gated, p.tp);
  auto kern = bwd_mono_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)p.B, ROW_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const RowLayout L((T*)nullptr, p.l, p.ew, p.h, p.dh, p.hid,
                    p.gated ? 2 * p.h : p.h, p.tp);
  return launch_sum_partials(p.partials, p.B, L.nw, dw, stream);
}

// The C entry point of K6. dtype: 0 = float32, 1 = bfloat16.
// e, g_eout, de (B, l, l, ew), qkv (B, l, 3 dh), gv, dq (B, l, dh) and the weight matrices (wg, wb (ew, h), wr
// (h, ew), w1 (ew, hid), w2 (hid, ew)) are in the working type; mask (B, l),
// amask (B, l, l; may be null), the biases and LN parameters, dk, dv
// (B, l, dh) and dw are f32; ungated, wg and bg are null. dw receives the
// tail's sums [dwr | dbr | dg2 | db2 | dw1 | dbb1 | dw2 | dbb2] then the
// head's [dwgb (ew, nproj) | dbgb (nproj) | dg1 | db1], nproj = 2h gated
// ([gates | bias] columns) else h; `partials` is f32 scratch of B rows of
// that length.
inline int row_entry(int dtype, RowParams p, float* dw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return row_launch<float>(p, dw, s);
  if (dtype == 1) return row_launch<__nv_bfloat16>(p, dw, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace egt

// Shared memory the kernel needs for one block (one graph), in bytes, at
// the largest tile that fits in 227 KB (the wrapper checks it). The old
// one-block-a-graph K7 ran this kernel's layout, so this is also the test
// of the shapes it took.
extern "C" long long fused_layer_bwd_row_smem(int dtype, int l, int ew, int h,
                                              int dh, int hid, int gated) {
  const size_t optin = 227 * 1024;
  if (dtype == 0) {
    const int tp = egt::row_tp<float>(l, ew, h, dh, hid, gated, optin);
    return (long long)egt::row_smem<float>(l, ew, h, dh, hid, gated,
                                           tp ? tp : 8);
  }
  const int tp = egt::row_tp<__nv_bfloat16>(l, ew, h, dh, hid, gated, optin);
  return (long long)egt::row_smem<__nv_bfloat16>(l, ew, h, dh, hid, gated,
                                                 tp ? tp : 8);
}

// The argument list of K6's entry point, and the RowParams it fills.
#define EGT_ROW_ARGS                                                         \
  int dtype, const void *e, const void *qkv, const float *mask,             \
      const float *amask, const void *wg, const float *bg, const void *wb,  \
      const float *bb, const float *g1, const float *b1, const void *wr,    \
      const float *br, const float *g2, const float *b2, const void *w1,    \
      const float *bb1, const void *w2, const float *bb2,                   \
      const void *geout, const void *gv, void *de, void *dq, float *dk,     \
      float *dv, float *dw, float *partials, int B, int l, int ew, int h,   \
      int dh, int hid, int gated, int has_clip, float lo, float hi,         \
      float scale, int edge_act, float edge_alpha, int act,                 \
      float act_alpha, unsigned seed_lo, unsigned seed_hi, float mask_p,    \
      float drop_p, float keep, void *stream
#define EGT_ROW_PARAMS                                                       \
  egt::RowParams {                                                           \
    e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, wr, br, g2, b2, w1, bb1,   \
        w2, bb2, geout, gv, de, dq, dk, dv, partials, B, l, ew, h, dh,  \
        hid, gated, has_clip, lo, hi, scale, edge_act, act, edge_alpha,     \
        act_alpha, Draws{seed_lo, seed_hi, mask_p, drop_p, keep}, 0    \
  }
