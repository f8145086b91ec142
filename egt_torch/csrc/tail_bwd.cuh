// The edge tail's backward over flattened pairs, the kernel of
// fused_layer_bwd_tail.cu (K4), edge_block_bwd.cu (K9), the first half of
// fused_layer_bwd_merged.cu (K7) and the second launch of
// fused_layer_bwd_mono.cu (K6); K7 and K6 take de_mid and dhh in f32.
//
// For every pair p, with e (.., ew), h_hat hh (.., h) and the cotangent g of
// the output, all in the working type:
//   e_mid = hh . Wr + br + e                 (recomputed from hh)
//   x2    = (e_mid - mu) * rstd
//   xn    = g2 x2 + b2,  pre = rnd(xn) . W1 + b1,  hid = act(pre)
//   dpre  = (g . W2^T) * act'(pre)
//   dxn   = rnd(dpre) . W1^T,  dx2 = dxn * g2
//   de_mid = (dx2 - mean(dx2) - x2 mean(dx2 x2)) * rstd + g     (written, dt)
//   dhh    = rnd(de_mid) . Wr^T                                 (written, dt)
// and the eight weight gradients summed over all pairs (f32):
//   dWr = rnd(hh)^T rnd(de_mid), dbr = sum de_mid, dg2 = sum dxn x2,
//   db2 = sum dxn, dW1 = rnd(xn)^T rnd(dpre), db1 = sum dpre,
//   dW2 = rnd(hid)^T g, db2' = sum g.
// Products take working-type operands into f32 sums, as the JAX kernels'
// _mm does; the rounding points are the JAX kernels'. hh and dhh are rows
// (pairs, h) or, for the edge block on path C, the attention kernel's
// head-major (b, h, l, l) layout, read and written in place.
//
// Design, both bodies: the TPU kernels sum their weight gradients in VMEM
// scratch across a grid that runs in order; on the card blocks run in no
// order. So a persistent grid walks tiles of consecutive pairs; each block
// keeps the ~17k f32 weight-gradient sums of its tiles in shared memory
// (each element owned by one thread, no atomics) and writes one partial row
// at the end; a second small kernel sums the partial rows in a fixed order,
// so a rerun is bit-identical. Only de_mid and dhh go back to device memory.
//
// What bounds it on an H100 (ZINC-500k training shape: 204,800 pairs, ew
// 64, h 8, hidden 128, bf16): ~85 MB to move (25 us at 3.35 TB/s) and
// ~17 GFLOP of products (18 us at the bf16 tensor-core peak). The products
// on the f32 CUDA cores (67 TFLOP/s; 2.74 ms as first ported) set the time,
// so the bf16 body (tail_bwd_mma_kernel) runs all eight on the tensor cores,
// mma.sync m16n8k16 with f32 sums (mma.cuh): every operand already sits at
// a bf16 rounding point, so only the order of summation changes. A warp
// owns 16 pairs and keeps their chain in registers, in mma fragments: the
// LayerNorms reduce a row within a quad of lanes, the FFN runs 16 hidden
// units at a time, and rnd(dpre) goes from the C fragments of g . W2^T
// straight into the A fragments of dxn = rnd(dpre) . W1^T. The transposed
// products read the weights as stored (ldmatrix without .trans), so no
// transposed copy is kept. Block barriers remain only around the weight-
// gradient products, whose depth is the tile's 128 pairs. e and g of the
// next tile are staged with cp.async by each warp as soon as its own rows
// are read, hh one tile ahead in a second buffer. What bounds the body now
// is latency, not bytes or peak FLOPs: one 8-warp block a SM (~225 KB of
// shared memory, most of it the f32 sums and the weights), the FFN chain of
// each warp and the barriers around the weight-gradient products
// (`python3 -m egt_torch.phase_times` times each phase by ablation). The
// f32 body (tail_bwd_kernel) is the first port's, on the CUDA cores, exact
// in f32: register-tiled shared-memory products with transposed weight
// copies, or, where those do not fit (f32 at ew 80, hidden 160), the
// weights as stored read by column. K7 and K6 also run it in bf16 where
// the tensor-core body cannot take a shape.
#pragma once

#include <type_traits>

#include "edge_tail.cuh"
#include "mma.cuh"

namespace egt {

constexpr int TAIL_NT = 256;


struct TailParams {
  const void* e; const void* hh; const void* g;
  const void* wr; const float* br; const float* g2; const float* b2;
  const void* w1; const float* bb1; const void* w2; const float* bb2;
  void* demid; void* dhh; float* partials;
  long long pairs; int ew, h, hid, tp, act; float act_alpha;
  int hh_l;   // layout of hh and dhh: 0 rows, else head-major with l = hh_l
              // (a template switch, so K4's rows kernel carries no layout code)
};

// shared-memory carve-up: floats first, then working-type weights: with
// copies, Wr and W1 as stored and transposed and W2 transposed (the
// products read rows); without (shapes whose copies do not fit), the three
// as stored, the transposed products reading columns
struct TailLayout {
  // weight-gradient sums, in output order
  int dwr, dbr, dg2, db2, dw1, dbb1, dw2, dbb2, nw;
  int vec, hh, em, x2, xn, hid, g, rstd, nf;  // float offsets
  int wr, wrT, w1, w1T, w2T, w2, nt;          // T offsets
  int tp;                                     // pairs a tile
  bool copies;
  __host__ __device__ TailLayout(int ew, int h, int hid_, int tp_,
                                 bool copies_) : tp(tp_), copies(copies_) {
    int o = 0;
    dwr = o;  o += h * ew;
    dbr = o;  o += ew;
    dg2 = o;  o += ew;
    db2 = o;  o += ew;
    dw1 = o;  o += ew * hid_;
    dbb1 = o; o += hid_;
    dw2 = o;  o += hid_ * ew;
    dbb2 = o; o += ew;
    nw = o;
    vec = o;  o += 4 * ew + hid_;  // br g2 b2 bb2 bb1
    hh = o;   o += tp * h;
    em = o;   o += tp * ew;        // e -> e_mid -> dxn -> de_mid
    x2 = o;   o += tp * ew;
    xn = o;   o += tp * ew;        // rnd(g2 x2 + b2)
    hid = o;  o += tp * hid_;      // hid -> dpre
    g = o;    o += tp * ew;
    rstd = o; o += tp;
    nf = (o + 3) & ~3;
    const int cp = copies ? 1 : 0;
    int w = 0;
    wr = w;  w += h * ew;
    wrT = w; w += cp * ew * h;
    w1 = w;  w += ew * hid_;
    w1T = w; w += cp * hid_ * ew;
    w2T = w; w += cp * ew * hid_;
    w2 = w;  w += (1 - cp) * hid_ * ew;
    nt = w;
  }
  template <typename T> __host__ __device__ size_t bytes() const {
    return (size_t)nf * sizeof(float) + (size_t)nt * sizeof(T);
  }
};

// HM: hh and dhh head-major (b, h, l, l) with l = p.hh_l; else rows. TR:
// the layout's transposed copies. OT: the type de_mid and dhh are written
// in (the working type; f32 for K7's hand-off).
template <typename T, bool HM, bool TR, typename OT>
__global__ void __launch_bounds__(TAIL_NT) tail_bwd_kernel(TailParams p) {
  constexpr int NT = TAIL_NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ew = p.ew, h = p.h, hid = p.hid, tp = p.tp;
  const TailLayout L(ew, h, hid, tp, TR);
  T* ws = reinterpret_cast<T*>(sm + L.nf);
  float *acc = sm, *dwr = sm + L.dwr, *dbr = sm + L.dbr, *dg2 = sm + L.dg2;
  float *db2 = sm + L.db2, *dw1 = sm + L.dw1, *dbb1 = sm + L.dbb1;
  float *dw2 = sm + L.dw2, *dbb2 = sm + L.dbb2;
  float *br = sm + L.vec, *g2 = br + ew, *b2 = g2 + ew, *bb2 = b2 + ew;
  float *bb1 = bb2 + ew;
  float *hh_s = sm + L.hh, *em = sm + L.em, *x2 = sm + L.x2, *xn = sm + L.xn;
  float *hid_s = sm + L.hid, *g_s = sm + L.g, *rstd = sm + L.rstd;
  T *wr = ws + L.wr, *wrT = ws + L.wrT, *w1 = ws + L.w1, *w1T = ws + L.w1T;
  T *w2T = ws + L.w2T, *w2 = ws + L.w2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- weights (and transposes) once per block; zero the sums
  const T* Wr = (const T*)p.wr;
  const T* W1 = (const T*)p.w1;
  const T* W2 = (const T*)p.w2;
  for (int t = tid; t < h * ew; t += NT) {
    const int k = t / ew, c = t % ew;
    wr[t] = Wr[t];
    if (TR) wrT[c * h + k] = Wr[t];
  }
  for (int t = tid; t < ew * hid; t += NT) {
    const int c = t / hid, u = t % hid;      // W1 (ew, hid)
    w1[t] = W1[t];
    const int u2 = t / ew, c2 = t % ew;      // W2 (hid, ew)
    if (TR) {
      w1T[u * ew + c] = W1[t];
      w2T[c2 * hid + u2] = W2[t];
    } else {
      w2[t] = W2[t];
    }
  }
  for (int t = tid; t < ew; t += NT) {
    br[t] = p.br[t]; g2[t] = p.g2[t]; b2[t] = p.b2[t]; bb2[t] = p.bb2[t];
  }
  for (int t = tid; t < hid; t += NT) bb1[t] = p.bb1[t];
  for (int t = tid; t < L.nw; t += NT) acc[t] = 0.f;

  const T* E = (const T*)p.e;
  const T* HH = (const T*)p.hh;
  const T* G = (const T*)p.g;
  OT* DM = (OT*)p.demid;
  OT* DH = (OT*)p.dhh;
  const long long ntiles = (p.pairs + tp - 1) / tp;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * tp;
    const int np = (int)min((long long)tp, p.pairs - p0);
    __syncthreads();  // weights loaded; the previous tile is done
    if (HM) load_hh<NT>(HH, p0, np, h, p.hh_l, hh_s);
    else for (int t = tid; t < np * h; t += NT) hh_s[t] = to_f(HH[p0 * h + t]);
    for (int t = tid; t < np * ew; t += NT) {
      em[t] = to_f(E[p0 * ew + t]);
      g_s[t] = to_f(G[p0 * ew + t]);
    }
    __syncthreads();

    // e_mid = hh . Wr + br + e
    tile_gemm<NT>(np, ew, h,
        [&](int m, int k) { return hh_s[m * h + k]; },
        [&](int k, int n) { return to_f(wr[k * ew + n]); },
        [&](int m, int n, float y) { em[m * ew + n] += y + br[n]; });
    __syncthreads();

    // LayerNorm of e_mid, one warp per pair
    for (int m = warp; m < np; m += NT / 32) {
      const float* x = em + m * ew;
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
        const float v = (x[c] - mu) * rs;
        x2[m * ew + c] = v;
        xn[m * ew + c] = rnd<T>(g2[c] * v + b2[c]);
      }
      if (lane == 0) rstd[m] = rs;
    }
    __syncthreads();

    // hid = act(rnd(xn) . W1 + b1), kept in f32
    tile_gemm<NT>(np, hid, ew,
        [&](int m, int k) { return xn[m * ew + k]; },
        [&](int k, int n) { return to_f(w1[k * hid + n]); },
        [&](int m, int n, float y) {
          hid_s[m * hid + n] = act_fn(p.act, p.act_alpha, y + bb1[n]);
        });
    __syncthreads();

    // dW2 += rnd(hid)^T g; db2' += sum g
    tile_gemm<NT>(hid, ew, np,
        [&](int m, int k) { return rnd<T>(hid_s[k * hid + m]); },
        [&](int k, int n) { return g_s[k * ew + n]; },
        [&](int m, int n, float y) { dw2[m * ew + n] += y; });
    for (int c = tid; c < ew; c += NT) {
      float s = 0.f;
      for (int m = 0; m < np; ++m) s += g_s[m * ew + c];
      dbb2[c] += s;
    }
    __syncthreads();

    // dpre = (g . W2^T) * act'(pre), in place of hid (each element is read
    // and written by the thread that owns it)
    tile_gemm<NT>(np, hid, ew,
        [&](int m, int k) { return g_s[m * ew + k]; },
        [&](int k, int n) { return to_f(TR ? w2T[k * hid + n] : w2[n * ew + k]); },
        [&](int m, int n, float y) {
          const float post = hid_s[m * hid + n];
          // act(pre) > 0 iff pre > 0 for elu, relu and leaky relu
          const float pre_sign = post > 0.f ? 1.f : -1.f;
          hid_s[m * hid + n] = y * act_grad(p.act, p.act_alpha, pre_sign, post);
        });
    __syncthreads();

    // dW1 += rnd(xn)^T rnd(dpre); db1 += sum dpre; dxn = rnd(dpre) . W1^T
    tile_gemm<NT>(ew, hid, np,
        [&](int m, int k) { return xn[k * ew + m]; },
        [&](int k, int n) { return rnd<T>(hid_s[k * hid + n]); },
        [&](int m, int n, float y) { dw1[m * hid + n] += y; });
    for (int u = tid; u < hid; u += NT) {
      float s = 0.f;
      for (int m = 0; m < np; ++m) s += hid_s[m * hid + u];
      dbb1[u] += s;
    }
    tile_gemm<NT>(np, ew, hid,
        [&](int m, int k) { return rnd<T>(hid_s[m * hid + k]); },
        [&](int k, int n) { return to_f(TR ? w1T[k * ew + n] : w1[n * hid + k]); },
        [&](int m, int n, float y) { em[m * ew + n] = y; });
    __syncthreads();

    // dg2 += sum dxn x2; db2 += sum dxn
    for (int c = tid; c < ew; c += NT) {
      float s = 0.f, s2 = 0.f;
      for (int m = 0; m < np; ++m) {
        s += em[m * ew + c] * x2[m * ew + c];
        s2 += em[m * ew + c];
      }
      dg2[c] += s;
      db2[c] += s2;
    }
    __syncthreads();

    // LayerNorm backward, one warp per pair: de_mid (f32 in em; dt out)
    for (int m = warp; m < np; m += NT / 32) {
      float* d = em + m * ew;
      const float* xr = x2 + m * ew;
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g2[c];
        s += dx;
        s2 += dx * xr[c];
      }
      const float m1 = warp_sum(s) / ew, m2 = warp_sum(s2) / ew;
      const float rs = rstd[m];
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g2[c];
        const float v = (dx - m1 - xr[c] * m2) * rs + g_s[m * ew + c];
        d[c] = v;
        DM[(p0 + m) * ew + c] = from_f<OT>(v);
      }
    }
    __syncthreads();

    // dWr += rnd(hh)^T rnd(de_mid); dbr += sum de_mid; dhh = rnd(de_mid) . Wr^T
    tile_gemm<NT>(h, ew, np,
        [&](int m, int k) { return hh_s[k * h + m]; },
        [&](int k, int n) { return rnd<T>(em[k * ew + n]); },
        [&](int m, int n, float y) { dwr[m * ew + n] += y; });
    for (int c = tid; c < ew; c += NT) {
      float s = 0.f;
      for (int m = 0; m < np; ++m) s += em[m * ew + c];
      dbr[c] += s;
    }
    tile_gemm<NT>(np, h, ew,
        [&](int m, int k) { return rnd<T>(em[m * ew + k]); },
        [&](int k, int n) { return to_f(TR ? wrT[k * h + n] : wr[n * ew + k]); },
        [&](int m, int n, float y) {
          DH[HM ? hh_index(p0 + m, n, h, p.hh_l) : (p0 + m) * h + n] =
              from_f<OT>(y);
        });
  }
  __syncthreads();
  float* part = p.partials + (size_t)blockIdx.x * L.nw;
  for (int t = tid; t < L.nw; t += NT) part[t] = acc[t];
}

// ---------------------------------------------------------------- bf16
// The tensor-core body. A block of nw warps takes tiles of 16 nw pairs;
// warp w owns pairs 16 w .. 16 w + 15 of a tile and runs their chain in
// registers, in mma fragments (see mma.cuh). Shared memory:
//   f32:  the weight-gradient sums (TailAcc order), one row of bias-sum
//         partials per warp, and br g2 b2 bb2 (EK each) bb1 (UK), zero-padded;
//   bf16: Wr (HK x EK), W1 (EK x UK), W2 (UK x EK) as given (the
//         transposed products read them with ldmatrix without .trans), and
//         the tile's staged rows: e, g, hh (two buffers), rnd(xn), a
//         buffer that holds rnd(hid) of a chunk of UC hidden units and
//         then rnd(de_mid), and rnd(dpre) of the chunk.
// Widths are padded with zeros to multiples of 16; rows past the last
// pair are zero-filled, which makes every padded pair's g, dpre, de_mid and
// hh exactly 0, so the weight-gradient products over the tile's pairs add
// nothing for them.
constexpr int TAIL_MMA_WARPS = 8;

struct TailMmaLayout {
  int EK, UK, HK, UC, se, su, sh, sb, sd, wr_len;
  int wrow, vec, nf;                      // float offsets; nf floats in all
  int wr, w1, w2, e, g, hh, xn, hd, dp;   // bf16 offsets
  size_t bytes;
  __host__ __device__ TailMmaLayout(int ew, int h, int hid, int nw) {
    EK = round16(ew); UK = round16(hid); HK = round16(h);
    UC = UK < 64 ? UK : 64;
    se = EK + 8; su = UK + 8; sh = HK + 8;
    sb = (UC > EK ? UC : EK) + 8; sd = UC + 8;
    const int tp = 16 * nw;
    wr_len = 4 * EK + UK;                 // br g2 b2 bb2 (EK) bb1 (UK)
    int o = TailAcc(ew, h, hid).n;
    wrow = o; o += nw * wr_len;
    vec = o;  o += wr_len;
    nf = (o + 3) & ~3;
    int b = 0;
    wr = b; b += HK * se;
    w1 = b; b += EK * su;
    w2 = b; b += UK * se;
    e = b;  b += tp * se;
    g = b;  b += tp * se;
    hh = b; b += 2 * tp * sh;
    xn = b; b += tp * se;
    hd = b; b += tp * sb;
    dp = b; b += tp * sd;
    bytes = (size_t)nf * 4 + (size_t)b * 2;
  }
};

// Stage one warp's 16 rows of h_hat, rows layout or head-major (b, h, l, l)
template <bool HM>
__device__ __forceinline__ void stage_hh16(__nv_bfloat16* S, int ld,
                                           const __nv_bfloat16* HH,
                                           long long p0, int nv, int h, int l) {
  if (!HM) {
    stage_rows16(S, ld, HH + p0 * h, nv, h);
  } else {
    for (int t = threadIdx.x & 31; t < 16 * h; t += 32) {
      const int k = t >> 4, r = t & 15;   // consecutive lanes, consecutive pairs
      S[r * ld + k] = r < nv ? HH[hh_index(p0 + r, k, h, l)]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// Columns c and c + 1 (those < w) of an f32 row r of width w, if ok; one
// 8-byte store when w is even (c is)
__device__ __forceinline__ void st_f2_row(float* r, int c, int w, bool ok,
                                          const float (&v)[2]) {
  if (!ok || c >= w) return;
  if ((w & 1) == 0) {
    *reinterpret_cast<float2*>(r + c) = make_float2(v[0], v[1]);
  } else {
    r[c] = v[0];
    if (c + 1 < w) r[c + 1] = v[1];
  }
}

// acc[base + m * ldo + n] += the 16 x 16 block of C fragments c, for
// m < M, n < N; (m0, n0) is the block's corner
__device__ __forceinline__ void add_block(float* acc, int ldo, int M, int N,
                                          int m0, int n0,
                                          const float (&c)[2][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + gq + ((q >> 1) << 3);
      const int n = n0 + 8 * jj + 2 * tq + (q & 1);
      if (m < M && n < N) acc[m * ldo + n] += c[jj][q];
    }
}

// C (16 x 16 at (m0, n0)) = sum over k < K of A^T B, with A stored K x M
// (row stride la) and B stored K x N (row stride lb): a weight gradient
// over the tile's pairs
__device__ __forceinline__ void wgrad_block(float (&c)[2][4],
                                            const __nv_bfloat16* A, int la,
                                            const __nv_bfloat16* B, int lb,
                                            int K, int m0, int n0) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[jj][q] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4], b[4];
    lda_t(a, A, la, k0, m0);
    ldb_kn(b, B, lb, k0, n0);
    mma16816(c[0], a, b[0], b[1]);
    mma16816(c[1], a, b[2], b[3]);
  }
}

// NTE: the most n8 tiles of the edge width a lane holds (ew <= 8 NTE).
// OT: the type de_mid and dhh are written in: bf16, from the staged
// rnd(de_mid) and rounded dhh sums (K4, K9), or f32 (K7's hand-off), de_mid
// unrounded from the registers that computed it and dhh from its f32 sums;
// the body's own products take rnd(de_mid) either way.
template <bool HM, int NTE, typename OT>
__global__ void __launch_bounds__(TAIL_MMA_WARPS * 32, 1)
    tail_bwd_mma_kernel(TailParams p) {
  constexpr bool F32OUT = std::is_same<OT, float>::value;
  using bf = __nv_bfloat16;
  constexpr int NKE = NTE / 2;            // k16 steps over the edge width
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int E = p.ew, H = p.h, U = p.hid;
  const int nw = blockDim.x >> 5, TP = 16 * nw;
  const TailMmaLayout L(E, H, U, nw);
  const int EK = L.EK, UK = L.UK, HK = L.HK, UC = L.UC;
  const int se = L.se, su = L.su, sh = L.sh, sb = L.sb, sd = L.sd;
  const TailAcc A(E, H, U);
  float* acc = sm;
  float *vbr = sm + L.vec, *vg2 = vbr + EK, *vb2 = vg2 + EK;
  float *vbb2 = vb2 + EK, *vbb1 = vbb2 + EK;
  bf* bs = reinterpret_cast<bf*>(sm + L.nf);
  bf *Wr = bs + L.wr, *W1 = bs + L.w1, *W2 = bs + L.w2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* wrow = sm + L.wrow + warp * L.wr_len;   // this warp's bias partials
  // this warp's 16 staged rows
  bf *eW = bs + L.e + warp * 16 * se, *gW = bs + L.g + warp * 16 * se;
  bf *xnW = bs + L.xn + warp * 16 * se, *hdW = bs + L.hd + warp * 16 * sb;
  bf* dpW = bs + L.dp + warp * 16 * sd;

  // ---- weights (zero-padded), vectors, sums; staging zeroed (its padding
  // columns are never written again)
  zero_smem(bs, L.dp + TP * sd);
  for (int t = tid; t < L.vec; t += blockDim.x) sm[t] = 0.f;  // sums, partials
  for (int t = tid; t < EK; t += blockDim.x) {
    const bool ok = t < E;
    vbr[t] = ok ? p.br[t] : 0.f; vg2[t] = ok ? p.g2[t] : 0.f;
    vb2[t] = ok ? p.b2[t] : 0.f; vbb2[t] = ok ? p.bb2[t] : 0.f;
  }
  for (int t = tid; t < UK; t += blockDim.x) vbb1[t] = t < U ? p.bb1[t] : 0.f;
  __syncthreads();
  stage_matrix(Wr, se, (const bf*)p.wr, H, E);
  stage_matrix(W1, su, (const bf*)p.w1, E, U);
  stage_matrix(W2, se, (const bf*)p.w2, U, E);
  __syncthreads();

  const bf* E_ = (const bf*)p.e;
  const bf* HH = (const bf*)p.hh;
  const bf* G = (const bf*)p.g;
  OT* DM = (OT*)p.demid;
  OT* DH = (OT*)p.dhh;
  const long long ntiles = (p.pairs + TP - 1) / TP;
  auto rows_of = [&](long long tile, long long& p0) {
    p0 = tile * TP + warp * 16;
    const long long r = p.pairs - p0;
    return (int)(r < 0 ? 0 : (r > 16 ? 16 : r));
  };

  // prologue: the first tile's e, g and hh
  if (blockIdx.x < ntiles) {
    long long p0;
    const int nv = rows_of(blockIdx.x, p0);
    stage_rows16(eW, se, E_ + p0 * E, nv, E);
    stage_rows16(gW, se, G + p0 * E, nv, E);
    stage_hh16<HM>(bs + L.hh + warp * 16 * sh, sh, HH, p0, nv, H, p.hh_l);
  }
  cp_async_commit();

  for (long long tile = blockIdx.x, it = 0; tile < ntiles;
       tile += gridDim.x, ++it) {
    const int cur = (int)(it & 1);
    bf* hhT = bs + L.hh + cur * TP * sh;        // the tile's hh, all warps
    bf* hhW = hhT + warp * 16 * sh;
    long long p0, pn;
    const int nv = rows_of(tile, p0);
    const long long next = tile + gridDim.x;
    const int nvn = next < ntiles ? rows_of(next, pn) : 0;
    if (next < ntiles)
      stage_hh16<HM>(bs + L.hh + (cur ^ 1) * TP * sh + warp * 16 * sh, sh, HH,
                     pn, nvn, H, p.hh_l);
    cp_async_commit();
    cp_async_wait<1>();                         // this tile's e, g, hh
    __syncwarp();

    // ---- e_mid = rnd(hh) . Wr + br + e, in C fragments (rows gq, gq + 8)
    float x2[NTE][4];
#pragma unroll
    for (int j = 0; j < NTE; ++j) {
      if (j < EK / 8) {
        const int c = 8 * j + 2 * tq;
        const float2 e0 = ld_bf2(eW + gq * se + c);
        const float2 e1 = ld_bf2(eW + (gq + 8) * se + c);
        x2[j][0] = e0.x + vbr[c]; x2[j][1] = e0.y + vbr[c + 1];
        x2[j][2] = e1.x + vbr[c]; x2[j][3] = e1.y + vbr[c + 1];
      }
    }
    for (int k0 = 0; k0 < HK; k0 += 16) {
      uint32_t a[4];
      lda(a, hhW, sh, 0, k0);
#pragma unroll
      for (int jb = 0; jb < NKE; ++jb) {
        if (jb < EK / 16) {
          uint32_t b[4];
          ldb_kn(b, Wr, se, k0, 16 * jb);
          mma16816(x2[2 * jb], a, b[0], b[1]);
          mma16816(x2[2 * jb + 1], a, b[2], b[3]);
        }
      }
    }
    __syncwarp();
    // e is read: prefetch the next tile's
    if (next < ntiles) stage_rows16(eW, se, E_ + pn * E, nvn, E);
    cp_async_commit();

    // ---- LayerNorm of e_mid over the E real columns; x2 in place
    float mu[2], rs[2];
    ln_stats(x2, E, mu, rs);
    const float mu0 = mu[0], mu1 = mu[1], rs0 = rs[0], rs1 = rs[1];
#pragma unroll
    for (int j = 0; j < NTE; ++j) {
      if (j < EK / 8) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool ok = 8 * j + 2 * tq + q < E;
          x2[j][q] = ok ? (x2[j][q] - mu0) * rs0 : 0.f;
          x2[j][2 + q] = ok ? (x2[j][2 + q] - mu1) * rs1 : 0.f;
        }
        const int c = 8 * j + 2 * tq;
        st_bf2(xnW + gq * se + c, vg2[c] * x2[j][0] + vb2[c],
               vg2[c + 1] * x2[j][1] + vb2[c + 1]);
        st_bf2(xnW + (gq + 8) * se + c, vg2[c] * x2[j][2] + vb2[c],
               vg2[c + 1] * x2[j][3] + vb2[c + 1]);
      }
    }
    __syncwarp();
    uint32_t axn[NKE][4], ag[NKE][4];     // A fragments of rnd(xn) and g
#pragma unroll
    for (int ks = 0; ks < NKE; ++ks)
      if (ks < EK / 16) {
        lda(axn[ks], xnW, se, 0, 16 * ks);
        lda(ag[ks], gW, se, 0, 16 * ks);
      }

    // ---- the FFN in chunks of UC hidden units: hid, dpre (staged for the
    // weight gradients), db1, and dxn += rnd(dpre) . W1^T from registers
    float dx[NTE][4];
#pragma unroll
    for (int j = 0; j < NTE; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dx[j][q] = 0.f;
    for (int uc = 0; uc < UK; uc += UC) {
      const int ucw = min(UC, UK - uc);
      for (int ub = 0; ub < ucw; ub += 16) {
        const int u0 = uc + ub;
        float pre[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < NKE; ++ks) {
          if (ks < EK / 16) {
            uint32_t b[4];
            ldb_kn(b, W1, su, 16 * ks, u0);
            mma16816(pre[0], axn[ks], b[0], b[1]);
            mma16816(pre[1], axn[ks], b[2], b[3]);
            ldb_nk(b, W2, se, 16 * ks, u0);
            mma16816(dp[0], ag[ks], b[0], b[1]);
            mma16816(dp[1], ag[ks], b[2], b[3]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int u = u0 + 8 * jj + 2 * tq + (q & 1);
            const float hv = act_fn(p.act, p.act_alpha, pre[jj][q] + vbb1[u]);
            // act(pre) > 0 iff pre > 0 for elu, relu and leaky relu
            const float dv = dp[jj][q] *
                act_grad(p.act, p.act_alpha, hv > 0.f ? 1.f : -1.f, hv);
            pre[jj][q] = u < U ? hv : 0.f;
            dp[jj][q] = u < U ? dv : 0.f;
          }
          const int c = ub + 8 * jj + 2 * tq;
          st_bf2(hdW + gq * sb + c, pre[jj][0], pre[jj][1]);
          st_bf2(hdW + (gq + 8) * sb + c, pre[jj][2], pre[jj][3]);
          st_bf2(dpW + gq * sd + c, dp[jj][0], dp[jj][1]);
          st_bf2(dpW + (gq + 8) * sd + c, dp[jj][2], dp[jj][3]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float s = rows16_sum(dp[jj][q] + dp[jj][2 + q]);
            if (gq == 0) wrow[4 * EK + u0 + 8 * jj + 2 * tq + q] += s;
          }
        }
        const uint32_t a[4] = {pack_bf16(dp[0][0], dp[0][1]),
                               pack_bf16(dp[0][2], dp[0][3]),
                               pack_bf16(dp[1][0], dp[1][1]),
                               pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
        for (int jb = 0; jb < NKE; ++jb) {
          if (jb < EK / 16) {
            uint32_t b[4];
            ldb_nk(b, W1, su, u0, 16 * jb);
            mma16816(dx[2 * jb], a, b[0], b[1]);
            mma16816(dx[2 * jb + 1], a, b[2], b[3]);
          }
        }
      }
      __syncthreads();   // every warp's chunk of hid and dpre is staged
      // dW2[uc + m, c] += sum_p rnd(hid)[p, m] g[p, c];
      // dW1[c, uc + n] += sum_p rnd(xn)[p, c] rnd(dpre)[p, n]
      const int mb2 = ucw / 16, nb2 = EK / 16, n2 = mb2 * nb2;
      for (int bi = warp; bi < 2 * n2; bi += nw) {
        float c[2][4];
        if (bi < n2) {
          const int m0 = 16 * (bi / nb2), n0 = 16 * (bi % nb2);
          wgrad_block(c, bs + L.hd, sb, bs + L.g, se, TP, m0, n0);
          add_block(acc + A.dw2 + uc * E, E, U - uc, E, m0, n0, c);
        } else {
          const int b2 = bi - n2, m0 = 16 * (b2 / mb2), n0 = 16 * (b2 % mb2);
          wgrad_block(c, bs + L.xn, se, bs + L.dp, sd, TP, m0, n0);
          add_block(acc + A.dw1 + uc, U, E, U - uc, m0, n0, c);
        }
      }
      __syncthreads();   // the chunk's staging may be overwritten
    }

    // ---- LayerNorm backward: de_mid = (dx - m1 - x2 m2) rstd + g, with
    // dx = dxn g2; the bias sums dbr, dg2, db2, dbb2
    float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;
#pragma unroll
    for (int j = 0; j < NTE; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = 8 * j + 2 * tq + q;
        if (c < E) {
          const float d0 = dx[j][q] * vg2[c], d1 = dx[j][2 + q] * vg2[c];
          a0 += d0; b0 += d0 * x2[j][q];
          a1 += d1; b1 += d1 * x2[j][2 + q];
        }
      }
    const float m10 = quad_sum(a0) / E, m20 = quad_sum(b0) / E;
    const float m11 = quad_sum(a1) / E, m21 = quad_sum(b1) / E;
#pragma unroll
    for (int j = 0; j < NTE; ++j) {
      if (j < EK / 8) {
        const int c0 = 8 * j + 2 * tq;
        const float2 gv0 = ld_bf2(gW + gq * se + c0);
        const float2 gv1 = ld_bf2(gW + (gq + 8) * se + c0);
        const float g0[2] = {gv0.x, gv0.y}, g1[2] = {gv1.x, gv1.y};
        float de0[2], de1[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q;
          const bool ok = c < E;
          const float d0 = dx[j][q], d1 = dx[j][2 + q];
          de0[q] = ok ? (d0 * vg2[c] - m10 - x2[j][q] * m20) * rs0 + g0[q] : 0.f;
          de1[q] = ok ? (d1 * vg2[c] - m11 - x2[j][2 + q] * m21) * rs1 + g1[q]
                      : 0.f;
          const float sbr = rows16_sum(de0[q] + de1[q]);
          const float sg2 = rows16_sum(d0 * x2[j][q] + d1 * x2[j][2 + q]);
          const float sb2 = rows16_sum(d0 + d1);
          const float sbb2 = rows16_sum(g0[q] + g1[q]);
          if (gq == 0) {
            wrow[c] += sbr; wrow[EK + c] += sg2;
            wrow[2 * EK + c] += sb2; wrow[3 * EK + c] += sbb2;
          }
        }
        st_bf2(hdW + gq * sb + c0, de0[0], de0[1]);
        st_bf2(hdW + (gq + 8) * sb + c0, de1[0], de1[1]);
        if constexpr (F32OUT) {
          st_f2_row(DM + (p0 + gq) * E, c0, E, gq < nv, de0);
          st_f2_row(DM + (p0 + gq + 8) * E, c0, E, gq + 8 < nv, de1);
        }
      }
    }
    __syncwarp();
    if constexpr (!F32OUT) store_rows16(DM + p0 * E, hdW, sb, nv, E);
    // g is read: prefetch the next tile's
    if (next < ntiles) stage_rows16(gW, se, G + pn * E, nvn, E);
    cp_async_commit();

    // ---- dhh = rnd(de_mid) . Wr^T
    for (int n0 = 0; n0 < HK; n0 += 16) {
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NKE; ++ks) {
        if (ks < EK / 16) {
          uint32_t a[4], b[4];
          lda(a, hdW, sb, 0, 16 * ks);
          ldb_nk(b, Wr, se, 16 * ks, n0);
          mma16816(c[0], a, b[0], b[1]);
          mma16816(c[1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = n0 + 8 * jj + 2 * tq + (q & 1);
          const int r = gq + ((q >> 1) << 3);
          if (k < H && r < nv)
            DH[HM ? hh_index(p0 + r, k, H, p.hh_l) : (p0 + r) * H + k] =
                from_f<OT>(c[jj][q]);
        }
    }
    __syncthreads();     // every warp's de_mid is staged
    // dWr[k, c] += sum_p rnd(hh)[p, k] rnd(de_mid)[p, c]
    const int nbr = EK / 16;
    for (int bi = warp; bi < (HK / 16) * nbr; bi += nw) {
      float c[2][4];
      const int m0 = 16 * (bi / nbr), n0 = 16 * (bi % nbr);
      wgrad_block(c, hhT, sh, bs + L.hd, sb, TP, m0, n0);
      add_block(acc + A.dwr, E, H, E, m0, n0, c);
    }
    __syncthreads();     // hh and de_mid staging may be overwritten
  }
  cp_async_wait<0>();
  __syncthreads();
  // the warps' bias partials, in warp order
  for (int t = tid; t < L.wr_len; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += sm[L.wrow + w * L.wr_len + t];
    if (t < 4 * EK) {
      const int v = t / EK, c = t - v * EK;
      if (c < E) acc[(v == 0 ? A.dbr : v == 1 ? A.dg2 : v == 2 ? A.db2 : A.dbb2) + c] += s;
    } else if (t - 4 * EK < U) {
      acc[A.dbb1 + t - 4 * EK] += s;
    }
  }
  __syncthreads();
  float* part = p.partials + (size_t)blockIdx.x * A.n;
  for (int t = tid; t < A.n; t += blockDim.x) part[t] = acc[t];
}

// The most warps a block (up to 8) whose tensor-core layout fits in optin
// bytes; 0 where none does or ew > 128 (the body holds at most 16 n8 tiles)
inline int tail_mma_warps(int ew, int h, int hid, size_t optin) {
  if (ew > 128) return 0;
  int nw = TAIL_MMA_WARPS;
  while (nw > 0 && TailMmaLayout(ew, h, hid, nw).bytes > optin) --nw;
  return nw;
}

// The bf16 launch at nw warps a block
template <bool HM, int NTE, typename OT>
int tail_bwd_mma_launch(TailParams p, float* dw, int max_grid, int sms,
                        int nw, cudaStream_t stream) {
  const TailMmaLayout L(p.ew, p.h, p.hid, nw);
  auto kern = tail_bwd_mma_kernel<HM, NTE, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, nw * 32,
                                                      L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (p.pairs + 16 * nw - 1) / (16 * nw);
  long long grid = (long long)sms * per_sm;
  if (grid > max_grid) grid = max_grid;
  if (grid > ntiles) grid = ntiles;
  kern<<<(unsigned)grid, nw * 32, L.bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, (int)grid, TailAcc(p.ew, p.h, p.hid).n,
                             dw, stream);
}

// The CUDA-core body (exact f32 products in f32): 32 pairs a tile, or 16 or
// 8 where that does not fit, with the transposed weight copies where they
// fit, else without. tp is 0 where no layout fits in optin bytes.
template <typename T>
inline TailLayout tail_simt_layout(int ew, int h, int hid, size_t optin) {
  for (int copies = 1; copies >= 0; --copies)
    for (int tp = 32; tp >= 8; tp /= 2) {
      const TailLayout L(ew, h, hid, tp, copies);
      if (L.bytes<T>() <= optin) return L;
    }
  TailLayout L(ew, h, hid, 8, false);
  L.tp = 0;
  return L;
}

template <typename T, typename OT>
int tail_bwd_simt_launch(TailParams p, float* dw, int max_grid, int sms,
                         int optin, cudaStream_t stream) {
  const TailLayout L = tail_simt_layout<T>(p.ew, p.h, p.hid, (size_t)optin);
  if (L.tp == 0) return (int)cudaErrorInvalidConfiguration;
  p.tp = L.tp;
  const size_t smem = L.bytes<T>();
  auto kern = p.hh_l ? (L.copies ? tail_bwd_kernel<T, true, true, OT>
                                 : tail_bwd_kernel<T, true, false, OT>)
                     : (L.copies ? tail_bwd_kernel<T, false, true, OT>
                                 : tail_bwd_kernel<T, false, false, OT>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TAIL_NT,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (p.pairs + p.tp - 1) / p.tp;
  long long grid = (long long)sms * per_sm;
  if (grid > max_grid) grid = max_grid;
  if (grid > ntiles) grid = ntiles;
  kern<<<(unsigned)grid, TAIL_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, (int)grid, L.nw, dw, stream);
}

// bf16 runs the tensor-core body. With de_mid and dhh written in f32 (K7,
// OT float) a shape that body cannot take (ew > 128, or past 227 KB at one
// warp a block) runs the CUDA-core body in bf16: the old one-block-a-graph
// K7 took such shapes. K4 and K9 refuse them, as before.
template <typename T, typename OT = T>
int tail_bwd_launch(TailParams p, float* dw, int max_grid,
                    cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int nw = tail_mma_warps(p.ew, p.h, p.hid, (size_t)optin);
    if (nw == 0) {
      if constexpr (std::is_same<OT, float>::value)
        return tail_bwd_simt_launch<T, OT>(p, dw, max_grid, sms, optin, stream);
      return (int)cudaErrorInvalidValue;
    }
    if (p.ew <= 64)
      return p.hh_l ? tail_bwd_mma_launch<true, 8, OT>(p, dw, max_grid, sms, nw, stream)
                    : tail_bwd_mma_launch<false, 8, OT>(p, dw, max_grid, sms, nw, stream);
    return p.hh_l ? tail_bwd_mma_launch<true, 16, OT>(p, dw, max_grid, sms, nw, stream)
                  : tail_bwd_mma_launch<false, 16, OT>(p, dw, max_grid, sms, nw, stream);
  } else {
    return tail_bwd_simt_launch<T, OT>(p, dw, max_grid, sms, optin, stream);
  }
}

}  // namespace egt
