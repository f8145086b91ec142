// The edge tail's backward over flattened pairs, the kernel of
// fused_layer_bwd_tail.cu (K4) and edge_block_bwd.cu (K9).
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
// Design: the TPU kernels sum their weight gradients in VMEM scratch across
// a grid that runs in order; on the card blocks run in no order. So a
// persistent grid walks tiles of TP consecutive pairs; each block keeps the
// ~17k f32 weight-gradient sums of its tiles in shared memory (each element
// owned by one thread, no atomics) and writes one partial row at the end;
// a second small kernel sums the partial rows in a fixed order, so a rerun
// is bit-identical. The weights and their transposes sit in shared memory
// for the whole block (row-major reads in every product). Per tile, the
// pair rows go through the chain in shared memory; only de_mid and dhh go
// back to device memory. (edge_tail.cuh has the same chain as functions on
// a tile, for the kernels that run it one query row at a time. Over
// flattened pairs this inline body, with transposed weight copies, took
// ~30% less time on an H100 than those functions, so K4 and K9 keep it.)
#pragma once

#include "edge_tail.cuh"

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

// shared-memory carve-up: floats first, then working-type weights
struct TailLayout {
  // weight-gradient sums, in output order
  int dwr, dbr, dg2, db2, dw1, dbb1, dw2, dbb2, nw;
  int vec, hh, em, x2, xn, hid, g, rstd, nf;  // float offsets
  int wr, wrT, w1, w1T, w2T, nt;              // T offsets
  __host__ __device__ TailLayout(int ew, int h, int hid_, int tp) {
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
    int w = 0;
    wr = w;  w += h * ew;
    wrT = w; w += ew * h;
    w1 = w;  w += ew * hid_;
    w1T = w; w += hid_ * ew;
    w2T = w; w += ew * hid_;
    nt = w;
  }
  template <typename T> __host__ __device__ size_t bytes() const {
    return (size_t)nf * sizeof(float) + (size_t)nt * sizeof(T);
  }
};

// HM: hh and dhh head-major (b, h, l, l) with l = p.hh_l; else rows
template <typename T, bool HM>
__global__ void __launch_bounds__(TAIL_NT) tail_bwd_kernel(TailParams p) {
  constexpr int NT = TAIL_NT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ew = p.ew, h = p.h, hid = p.hid, tp = p.tp;
  const TailLayout L(ew, h, hid, tp);
  T* ws = reinterpret_cast<T*>(sm + L.nf);
  float *acc = sm, *dwr = sm + L.dwr, *dbr = sm + L.dbr, *dg2 = sm + L.dg2;
  float *db2 = sm + L.db2, *dw1 = sm + L.dw1, *dbb1 = sm + L.dbb1;
  float *dw2 = sm + L.dw2, *dbb2 = sm + L.dbb2;
  float *br = sm + L.vec, *g2 = br + ew, *b2 = g2 + ew, *bb2 = b2 + ew;
  float *bb1 = bb2 + ew;
  float *hh_s = sm + L.hh, *em = sm + L.em, *x2 = sm + L.x2, *xn = sm + L.xn;
  float *hid_s = sm + L.hid, *g_s = sm + L.g, *rstd = sm + L.rstd;
  T *wr = ws + L.wr, *wrT = ws + L.wrT, *w1 = ws + L.w1, *w1T = ws + L.w1T;
  T *w2T = ws + L.w2T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- weights (and transposes) once per block; zero the sums
  const T* Wr = (const T*)p.wr;
  const T* W1 = (const T*)p.w1;
  const T* W2 = (const T*)p.w2;
  for (int t = tid; t < h * ew; t += NT) {
    const int k = t / ew, c = t % ew;
    wr[t] = Wr[t];
    wrT[c * h + k] = Wr[t];
  }
  for (int t = tid; t < ew * hid; t += NT) {
    const int c = t / hid, u = t % hid;      // W1 (ew, hid)
    w1[t] = W1[t];
    w1T[u * ew + c] = W1[t];
    const int u2 = t / ew, c2 = t % ew;      // W2 (hid, ew)
    w2T[c2 * hid + u2] = W2[t];
  }
  for (int t = tid; t < ew; t += NT) {
    br[t] = p.br[t]; g2[t] = p.g2[t]; b2[t] = p.b2[t]; bb2[t] = p.bb2[t];
  }
  for (int t = tid; t < hid; t += NT) bb1[t] = p.bb1[t];
  for (int t = tid; t < L.nw; t += NT) acc[t] = 0.f;

  const T* E = (const T*)p.e;
  const T* HH = (const T*)p.hh;
  const T* G = (const T*)p.g;
  T* DM = (T*)p.demid;
  T* DH = (T*)p.dhh;
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
        [&](int k, int n) { return to_f(w2T[k * hid + n]); },
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
        [&](int k, int n) { return to_f(w1T[k * ew + n]); },
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
        DM[(p0 + m) * ew + c] = from_f<T>(v);
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
        [&](int k, int n) { return to_f(wrT[k * h + n]); },
        [&](int m, int n, float y) {
          DH[HM ? hh_index(p0 + m, n, h, p.hh_l) : (p0 + m) * h + n] =
              from_f<T>(y);
        });
  }
  __syncthreads();
  float* part = p.partials + (size_t)blockIdx.x * L.nw;
  for (int t = tid; t < L.nw; t += NT) part[t] = acc[t];
}

template <typename T>
int tail_bwd_launch(TailParams p, float* dw, int max_grid,
                    cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // 32 pairs a tile, 16 where that does not fit (f32 at wide edges)
  p.tp = 32;
  if (TailLayout(p.ew, p.h, p.hid, p.tp).bytes<T>() > (size_t)optin) p.tp = 16;
  const TailLayout L(p.ew, p.h, p.hid, p.tp);
  const size_t smem = L.bytes<T>();
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  auto kern = p.hh_l ? tail_bwd_kernel<T, true> : tail_bwd_kernel<T, false>;
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

}  // namespace egt
