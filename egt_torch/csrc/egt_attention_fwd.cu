// EGT attention core, forward (inference and training), for sm_90a.
//
// Replaces: egt_tpu/ops/egt_pallas.py::_fwd_kernel, called through
// _egt_core_fwd / egt_attention_fused.
//
// Computes, for each (graph b, head hh, query row i), head-major:
//   h_hat[i, j] = clip(q_i . k_j * d^-1/2) + e[i, j]            (written out)
//   logits      = h_hat + madd[j] (+ maddf[i, j]) (+ rmask[i, j])
//   gates       = g[i, j] + madd[j] (+ maddf[i, j]) (+ rmask[i, j])
//   a[i, j]     = softmax_j(logits) * sigmoid(gates)
//   deg[i]      = sum_j sigmoid(gates)                          (f32, gated only)
//   a[i, j]     = kept[i, j] ? a[i, j] / keep : 0                (training dropout)
//   v_att[i, :] = sum_j a[i, j] * v_j
// The random mask (rmask, -1e9) and dropout draw from philox.cuh, draws 0
// and 1 of (b, i, j, head).
// Math is f32; q, k, v, e, g, h_hat and v_att are stored in the working type
// (f32 or bf16), rounded where the JAX kernel rounds (h_hat and a before A.V,
// v_att on store). The degree scaler stays in the Python wrapper.
//
// What bounds it on an H100: bytes. At the ZINC-500k serving shape (b 128,
// h 8, l 40, d 8, bf16) it reads e and g and writes h_hat, three
// (b, h, l, l) tensors of 3.3 MB each, against ~0.1 MFLOP per (b, h): about
// 13 MB in all, ~4 us at 3.35 TB/s, far below the ops ceiling.
//
// Design: one warp per query row, WARPS rows per block, one block per
// (b, h, row block); no cross-block sum is needed. Lanes stride over keys,
// so the e / g / h_hat row traffic is coalesced. The logits and gate row
// lives in shared memory (per warp, 2 * lk floats) between the max, sum and
// A.V passes; K and V are read through L1. Nothing of the per-pair chain is
// written to device memory except h_hat, which the edge stream needs.
// Tensor cores are not used: d = 8 makes the products tiny, and the kernel
// is bound by the per-pair bytes anyway. The draws are a template switch:
// with the Philox code compiled in, ptxas gives the kernel 56 registers a
// thread instead of 40, fewer warps fit an SM, and the inference launch ran
// 25% slower on an H100 (PERF.md).

#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace egt;

constexpr int WARPS = 4;

template <typename T, bool DRAWS>
__global__ void __launch_bounds__(WARPS * 32)
egt_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ e,
                         const T* __restrict__ g,
                         const float* __restrict__ madd,
                         const float* __restrict__ maddf,
                         T* __restrict__ vatt, T* __restrict__ hhat,
                         float* __restrict__ deg, int H, int lq, int lk, int d,
                         int has_clip, float lo, float hi, float scale,
                         Draws dr) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rowblocks = (lq + WARPS - 1) / WARPS;
  const int bh = blockIdx.x / rowblocks;
  const int i = (blockIdx.x % rowblocks) * WARPS + warp;
  if (i >= lq) return;  // whole warps leave; no block-wide barrier follows
  const int b = bh / H, hd = bh % H;
  const bool dropping = DRAWS && dr.dropping();

  float* lm = smem + (size_t)warp * (2 * lk + d + 32);  // logits, then A
  float* sg = lm + lk;                                   // sigmoid(gates)
  float* qs = sg + lk;                                   // this query row
  float* red = qs + d;                                   // A.V partials

  const size_t qrow = (size_t)bh * lq + i;
  const T* kb = k + (size_t)bh * lk * d;
  const T* vb = v + (size_t)bh * lk * d;
  const size_t prow = qrow * lk;
  const float* mrow = madd + (size_t)b * lk;
  const float* frow = maddf ? maddf + ((size_t)b * lq + i) * lk : nullptr;

  for (int c = lane; c < d; c += 32) qs[c] = to_f(q[qrow * d + c]);
  __syncwarp();

  float mx = -INFINITY;
  for (int j = lane; j < lk; j += 32) {
    const T* kr = kb + (size_t)j * d;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(qs[c], to_f(kr[c]), s);
    s *= scale;
    if (has_clip) s = fminf(fmaxf(s, lo), hi);
    const float hh = s + to_f(e[prow + j]);
    hhat[prow + j] = from_f<T>(hh);
    const float rm = DRAWS ? dr.mask_add(b, i, j, hd) : 0.f;
    float l = hh + mrow[j];
    if (frow) l += frow[j];
    l += rm;
    lm[j] = l;
    mx = fmaxf(mx, l);
    if (g) {
      float gm = to_f(g[prow + j]) + mrow[j];
      if (frow) gm += frow[j];
      sg[j] = sigmoid(gm + rm);
    }
  }
  mx = warp_max(mx);

  float sum = 0.f, dsum = 0.f;
  for (int j = lane; j < lk; j += 32) {
    const float ex = expf(lm[j] - mx);
    lm[j] = ex;
    sum += ex;
    if (g) dsum += sg[j];
  }
  sum = warp_sum(sum);
  const float den = fmaxf(sum, 1e-30f);
  for (int j = lane; j < lk; j += 32) {
    float a = lm[j] / den;
    if (g) a *= sg[j];
    if (dropping) a = dr.kept(b, i, j, hd) ? a / dr.keep : 0.f;
    lm[j] = rnd<T>(a);
  }
  __syncwarp();

  T* vout = vatt + qrow * d;
  if (d <= 32) {
    // lanes split as (key group, channel); partial sums meet in `red`
    const int G = 32 / d, c = lane % d, grp = lane / d;
    float acc = 0.f;
    if (grp < G)
      for (int j = grp; j < lk; j += G)
        acc = fmaf(lm[j], to_f(vb[(size_t)j * d + c]), acc);
    red[lane] = acc;
    __syncwarp();
    if (lane < d) {
      float s = 0.f;
      for (int gi = 0; gi < G; ++gi) s += red[gi * d + lane];
      vout[lane] = from_f<T>(s);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < lk; ++j)
        acc = fmaf(lm[j], to_f(vb[(size_t)j * d + c]), acc);
      vout[c] = from_f<T>(acc);
    }
  }
  if (g) {
    dsum = warp_sum(dsum);
    if (lane == 0) deg[qrow] = dsum;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* e,
           const void* g, const float* madd, const float* maddf, void* vatt,
           void* hhat, float* deg, int B, int H, int lq, int lk, int d,
           int has_clip, float lo, float hi, float scale, Draws dr,
           cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * (2 * lk + d + 32) * sizeof(float);
  auto kern = (dr.mask_p > 0.f || dr.drop_p > 0.f)
                  ? egt_attention_fwd_kernel<T, true>
                  : egt_attention_fwd_kernel<T, false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const long long blocks = (long long)B * H * ((lq + WARPS - 1) / WARPS);
  kern<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)e, (const T*)g, madd,
      maddf, (T*)vatt, (T*)hhat, deg, H, lq, lk, d, has_clip, lo, hi, scale,
      dr);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g, maddf and deg may be null (ungated /
// no hard mask). mask_p / drop_p 0 switch the draws off (inference).
// Returns cudaGetLastError() after the launch.
extern "C" int egt_attention_fwd(int dtype, const void* q, const void* k,
                                 const void* v, const void* e, const void* g,
                                 const float* madd, const float* maddf,
                                 void* vatt, void* hhat, float* deg, int B,
                                 int H, int lq, int lk, int d, int has_clip,
                                 float lo, float hi, float scale,
                                 unsigned seed_lo, unsigned seed_hi,
                                 float mask_p, float drop_p, float keep,
                                 void* stream) {
  const Draws dr{seed_lo, seed_hi, mask_p, drop_p, keep};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, e, g, madd, maddf, vatt, hhat, deg, B, H,
                         lq, lk, d, has_clip, lo, hi, scale, dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, e, g, madd, maddf, vatt, hhat, deg,
                                 B, H, lq, lk, d, has_clip, lo, hi, scale,
                                 dr, s);
  return (int)cudaErrorInvalidValue;
}
