// The edge tail of an EGT layer (dense_edge_r + residual -> LayerNorm ->
// FFN + residual) on a tile of pairs in shared memory: the forward chain of
// edge_block_fwd.cu (K8). tail_bwd.cuh (K4, K9, K7, K6) runs the backward
// below inline over flattened pairs, and takes TailAcc, hh_index and
// load_hh from here.
//
// For every pair, with h_hat hh (h), the residual e (ew) and the cotangent g
// of the output (ew), in the working type:
//   e_mid = rnd(hh) . Wr + br + e
//   x2    = (e_mid - mu) * rstd,  xn = rnd(g2 x2 + b2)
//   pre   = xn . W1 + b1,  hid = act(pre)
//   out   = rnd(hid) . W2 + b2' + e_mid
//   dpre  = (g . W2^T) * act'(pre),  dxn = rnd(dpre) . W1^T
//   de_mid = (dxn g2 - mean(dxn g2) - x2 mean(dxn g2 x2)) * rstd + g
//   dhh   = rnd(de_mid) . Wr^T
// and the eight weight gradients summed over the pairs (f32, TailAcc order):
//   dWr = rnd(hh)^T rnd(de_mid), dbr = sum de_mid, dg2 = sum dxn x2,
//   db2 = sum dxn, dW1 = xn^T rnd(dpre), db1 = sum dpre,
//   dW2 = rnd(hid)^T g, db2' = sum g.
// Products take working-type operands into f32 sums and round where the JAX
// kernels (_edge_tail_fwd, _bwd_tail_kernel, edge_block_pallas._bwd_kernel)
// round.
#pragma once

#include "common.cuh"

namespace egt {

// A row stride of an odd number of 32-bit words, so that lanes reading one
// column of consecutive rows hit distinct shared-memory banks.
template <typename T> __host__ __device__ inline int pad_stride(int n) {
  if (sizeof(T) == 4) return n | 1;
  const int s = (n + 1) & ~1;
  return (s / 2) % 2 ? s : s + 2;
}

// Offsets of the eight weight-gradient sums, in output order.
struct TailAcc {
  int dwr, dbr, dg2, db2, dw1, dbb1, dw2, dbb2, n;
  __host__ __device__ TailAcc(int ew, int h, int hid) {
    int o = 0;
    dwr = o;  o += h * ew;
    dbr = o;  o += ew;
    dg2 = o;  o += ew;
    db2 = o;  o += ew;
    dw1 = o;  o += ew * hid;
    dbb1 = o; o += hid;
    dw2 = o;  o += hid * ew;
    dbb2 = o; o += ew;
    n = o;
  }
};

// The tail's weights in shared memory: Wr (h, ew), W1 (ew, hid) and
// W2 (hid, ew) once each, rows padded by pad_stride, so the backward's
// transposed reads are as free of bank conflicts as the forward's; the
// vectors in f32. nf floats and nt working-type elements.
template <typename T> struct TailW {
  int h, ew, hid, sr, s1, s2;
  T *wr, *w1, *w2;
  float *br, *g2, *b2, *bb1, *bb2;
  __host__ __device__ TailW(int h_, int ew_, int hid_)
      : h(h_), ew(ew_), hid(hid_), sr(pad_stride<T>(ew_)),
        s1(pad_stride<T>(hid_)), s2(pad_stride<T>(ew_)) {}
  __host__ __device__ int nf() const { return 4 * ew + hid; }
  __host__ __device__ int nt() const { return h * sr + ew * s1 + hid * s2; }
  __device__ void carve(float* f, T* w) {
    br = f; g2 = br + ew; b2 = g2 + ew; bb2 = b2 + ew; bb1 = bb2 + ew;
    wr = w; w1 = wr + h * sr; w2 = w1 + ew * s1;
  }
  // every thread of the block takes part
  __device__ void load(const T* Wr, const float* Br, const float* G2,
                       const float* B2, const T* W1, const float* Bb1,
                       const T* W2, const float* Bb2) {
    for (int t = threadIdx.x; t < h * ew; t += blockDim.x)
      wr[(t / ew) * sr + t % ew] = Wr[t];
    for (int t = threadIdx.x; t < ew * hid; t += blockDim.x) {
      w1[(t / hid) * s1 + t % hid] = W1[t];
      w2[(t / ew) * s2 + t % ew] = W2[t];
    }
    for (int t = threadIdx.x; t < ew; t += blockDim.x) {
      br[t] = Br[t]; g2[t] = G2[t]; b2[t] = B2[t]; bb2[t] = Bb2[t];
    }
    for (int t = threadIdx.x; t < hid; t += blockDim.x) bb1[t] = Bb1[t];
  }
};

// One tile of np pairs in shared memory (f32): hh (np, h); em (np, ew),
// e on entry, e_mid after the forward, de_mid after the backward; and the
// scratch x2, xn, g (np, ew), hid (np, hid), act(pre) after the forward,
// dpre during the backward, and rstd (np).
struct TailTile {
  float *hh, *em, *x2, *xn, *g, *hid, *rstd;
  __host__ __device__ static int scratch(int tp, int ew, int hid) {
    return tp * (3 * ew + hid + 1);
  }
  __host__ __device__ static int floats(int tp, int ew, int h, int hid) {
    return tp * (h + ew) + scratch(tp, ew, hid);
  }
  __device__ void carve(float* f, int tp, int ew, int h, int nh) {
    hh = f;
    em = hh + tp * h;
    carve_scratch(em + tp * ew, tp, ew, nh);
  }
  // the scratch only: the caller points hh and em
  __device__ void carve_scratch(float* f, int tp, int ew, int nh) {
    x2 = f; xn = x2 + tp * ew; g = xn + tp * ew; hid = g + tp * ew;
    rstd = hid + tp * nh;
  }
};

// Forward of the tail up to hid: e_mid (in em), x2, xn, rstd, hid. The
// caller has loaded hh and em and synchronised; returns synchronised.
template <int NT, typename T>
__device__ __forceinline__ void tail_fwd_tile(const TailW<T>& W,
                                              const TailTile& s, int np,
                                              int act, float alpha) {
  // the fields in locals, as plain pointers into shared memory
  const int ew = W.ew, h = W.h, nh = W.hid, sr = W.sr, s1 = W.s1;
  const T *wr = W.wr, *w1 = W.w1;
  const float *br = W.br, *g2 = W.g2, *b2 = W.b2, *bb1 = W.bb1;
  const float* hh = s.hh;
  float *em = s.em, *x2 = s.x2, *xn = s.xn, *hid = s.hid, *rstd = s.rstd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tile_gemm<NT>(np, ew, h,
      [&](int m, int k) { return rnd<T>(hh[m * h + k]); },
      [&](int k, int n) { return to_f(wr[k * sr + n]); },
      [&](int m, int n, float y) { em[m * ew + n] += y + br[n]; });
  __syncthreads();
  // LayerNorm of e_mid, one warp per pair
  for (int m = warp; m < np; m += NT / 32) {
    const float* x = em + m * ew;
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
      const float v = (x[c] - mu) * rs;
      x2[m * ew + c] = v;
      xn[m * ew + c] = rnd<T>(g2[c] * v + b2[c]);
    }
    if (lane == 0) rstd[m] = rs;
  }
  __syncthreads();
  // hid = act(xn . W1 + b1), kept in f32
  tile_gemm<NT>(np, nh, ew,
      [&](int m, int k) { return xn[m * ew + k]; },
      [&](int k, int n) { return to_f(w1[k * s1 + n]); },
      [&](int m, int n, float y) {
        hid[m * nh + n] = act_fn(act, alpha, y + bb1[n]);
      });
  __syncthreads();
}

// Where pair p's head k of h_hat lies: rows (pairs, h) when l == 0, else
// head-major (b, h, l, l) with p = (b * l + i) * l + j.
__device__ __forceinline__ long long hh_index(long long p, int k, int h,
                                              int l) {
  if (l == 0) return p * h + k;
  const long long ll = (long long)l * l;
  // a 32-bit division wherever the pair index fits (every shipped shape)
  const long long b = p <= 0xffffffffLL
                          ? (long long)((unsigned)p / (unsigned)ll) : p / ll;
  return (b * h + k) * ll + (p - b * ll);
}

// Load a tile's hh (np pairs from p0) as f32 rows, reading consecutive
// addresses in either layout.
template <int NT, typename T>
__device__ void load_hh(const T* HH, long long p0, int np, int h, int l,
                        float* hh) {
  if (l == 0) {
    for (int t = threadIdx.x; t < np * h; t += NT) hh[t] = to_f(HH[p0 * h + t]);
  } else {
    for (int t = threadIdx.x; t < np * h; t += NT) {
      const int k = t / np, m = t % np;
      hh[m * h + k] = to_f(HH[hh_index(p0 + m, k, h, l)]);
    }
  }
}

}  // namespace egt
