// EGT attention core, backward, for sm_90a.
//
// Replaces: egt_tpu/ops/egt_pallas.py::_bwd_kernel, called through
// _egt_core_bwd_impl (the custom VJP of egt_attention_fused).
//
// For each (graph b, head hd, query row i), head-major, from the saved h_hat
// (the softmax chain is re-entered there; the draws are regenerated):
//   logits = h_hat + madd[j] (+ maddf[i, j]) (+ rmask),  gates likewise
//   s = softmax_j(logits),  sg = sigmoid(gates),  a = s sg
//   dmask = kept ? 1 / keep : 0,  a_d = a dmask
//   dA = (gv_i . v_j) dmask
//   dS = dA sg,  dsg = dA s + gdeg_i,  dG = dsg sg (1 - sg)        (dg, dt)
//   dH = s (dS - sum_j dS s) + gh                                  (de, dt)
//   raw = q_i . k_j * d^-1/2 (recomputed);  dr = (lo <= raw <= hi) ? dH : 0
//   dq_i = (sum_j rnd(dr) k_j) * scale                             (dt)
//   dk_j += rnd(dr) q_i * scale,  dv_j += rnd(a_d) gv_i            (f32)
// The clip test is inclusive on the recomputed raw logit, as the TPU kernel
// has it (the whole-layer backward tests strictly on the saved h_hat).
//
// What bounds it on an H100: bytes. At the ZINC-500k training shape (b 128,
// h 8, l 40, d 8, bf16) it reads h_hat, g and gh and writes de and dg, five
// (b, h, l, l) tensors of 3.3 MB each, against ~0.2 MFLOP per (b, h): ~17 MB,
// ~5 us at 3.35 TB/s.
//
// Design: dk and dv are sums over query rows, which the TPU kernel carried
// across its in-order grid. Here one block takes a whole (graph, head):
// each of its warps walks query rows (lanes over keys, as in the forward)
// and keeps its own dk / dv sums in shared memory; at the end the warps'
// sums are added in a fixed order and written once. No float atomics, so a
// rerun is bit-identical.

#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace egt;

constexpr int WARPS = 4;

// per-warp shared memory, in floats
__host__ __device__ inline int warp_floats(int lk, int d) {
  return 4 * lk + 2 * d + 32 + 2 * lk * d;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
egt_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ madd,
                         const float* __restrict__ maddf,
                         const T* __restrict__ hhat, const T* __restrict__ gv,
                         const T* __restrict__ gh,
                         const float* __restrict__ gdeg, T* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv,
                         T* __restrict__ de, T* __restrict__ dg, int H, int lq,
                         int lk, int d, int has_clip, float lo, float hi,
                         float scale, Draws dr) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int wf = warp_floats(lk, d);
  float* base = smem + (size_t)warp * wf;
  float* s_s = base;             // logits, then softmax
  float* sg_s = s_s + lk;        // sigmoid(gates)
  float* ds_s = sg_s + lk;       // dS
  float* r_s = ds_s + lk;        // rnd(a_d), then rnd(dr)... see below
  float* qs = r_s + lk;          // query row
  float* gvs = qs + d;           // its value cotangent
  float* red = gvs + d;          // dq partials
  float* dkw = red + 32;         // this warp's dk sums (lk, d)
  float* dvw = dkw + lk * d;     // this warp's dv sums (lk, d)

  const T* kb = k + (size_t)bh * lk * d;
  const T* vb = v + (size_t)bh * lk * d;
  const float* mrow = madd + (size_t)b * lk;
  const bool dropping = dr.dropping();
  const float inv_keep = 1.f / dr.keep;
  for (int t = lane; t < lk * d; t += 32) { dkw[t] = 0.f; dvw[t] = 0.f; }

  for (int i = warp; i < lq; i += WARPS) {
    const size_t qrow = (size_t)bh * lq + i;
    const size_t prow = qrow * lk;
    const float* frow = maddf ? maddf + ((size_t)b * lq + i) * lk : nullptr;
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      qs[c] = to_f(q[qrow * d + c]);
      gvs[c] = to_f(gv[qrow * d + c]);
    }
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      float add = mrow[j];
      if (frow) add += frow[j];
      const float rm = dr.mask_add(b, i, j, hd);
      const float lg = to_f(hhat[prow + j]) + add + rm;
      s_s[j] = lg;
      mx = fmaxf(mx, lg);
      sg_s[j] = g ? sigmoid(to_f(g[prow + j]) + add + rm) : 1.f;
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float ex = expf(s_s[j] - mx);
      s_s[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    const float gd = (g && gdeg) ? gdeg[qrow] : 0.f;
    float dot = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float s = s_s[j] / sum;
      s_s[j] = s;
      const float sgv = sg_s[j];
      float da = 0.f;
      for (int c = 0; c < d; ++c) da = fmaf(gvs[c], to_f(vb[(size_t)j * d + c]), da);
      float a = g ? s * sgv : s;
      if (dropping) {
        const float dm = dr.kept(b, i, j, hd) ? inv_keep : 0.f;
        da *= dm;
        a *= dm;
      }
      r_s[j] = rnd<T>(a);
      float dS = da;
      if (g) {
        dS = da * sgv;
        const float dsg = da * s + gd;
        dg[prow + j] = from_f<T>(dsg * sgv * (1.f - sgv));
      }
      ds_s[j] = dS;
      dot += dS * s;
    }
    dot = warp_sum(dot);
    __syncwarp();
    // dv sums take rnd(a_d) before r_s is reused for rnd(dr)
    for (int t = lane; t < lk * d; t += 32)
      dvw[t] = fmaf(r_s[t / d], gvs[t % d], dvw[t]);
    __syncwarp();
    for (int j = lane; j < lk; j += 32) {
      const float dH = s_s[j] * (ds_s[j] - dot) + to_f(gh[prow + j]);
      de[prow + j] = from_f<T>(dH);
      float dr_ = dH;
      if (has_clip) {
        float raw = 0.f;
        for (int c = 0; c < d; ++c) raw = fmaf(qs[c], to_f(kb[(size_t)j * d + c]), raw);
        raw *= scale;
        if (!(raw >= lo && raw <= hi)) dr_ = 0.f;
      }
      r_s[j] = rnd<T>(dr_);
    }
    __syncwarp();
    for (int t = lane; t < lk * d; t += 32)
      dkw[t] = fmaf(r_s[t / d], qs[t % d], dkw[t]);
    T* dqo = dq + qrow * d;
    if (d <= 32) {
      // lanes split as (key group, channel); partial sums meet in `red`
      const int G = 32 / d, c = lane % d, grp = lane / d;
      float acc = 0.f;
      if (grp < G)
        for (int j = grp; j < lk; j += G)
          acc = fmaf(r_s[j], to_f(kb[(size_t)j * d + c]), acc);
      red[lane] = acc;
      __syncwarp();
      if (lane < d) {
        float s = 0.f;
        for (int gi = 0; gi < G; ++gi) s += red[gi * d + lane];
        dqo[lane] = from_f<T>(s * scale);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < lk; ++j)
          acc = fmaf(r_s[j], to_f(kb[(size_t)j * d + c]), acc);
        dqo[c] = from_f<T>(acc * scale);
      }
    }
  }
  __syncthreads();
  // the warps' sums, added in warp order
  for (int t = threadIdx.x; t < lk * d; t += WARPS * 32) {
    float sk = 0.f, sv = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* bw = smem + (size_t)w * wf + 4 * lk + 2 * d + 32;
      sk += bw[t];
      sv += bw[lk * d + t];
    }
    dk[(size_t)bh * lk * d + t] = sk * scale;
    dv[(size_t)bh * lk * d + t] = sv;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           const float* madd, const float* maddf, const void* hhat,
           const void* gv, const void* gh, const float* gdeg, void* dq,
           float* dk, float* dv, void* de, void* dg, int B, int H, int lq,
           int lk, int d, int has_clip, float lo, float hi, float scale,
           Draws dr, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * warp_floats(lk, d) * sizeof(float);
  auto kern = egt_attention_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * H), WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, madd, maddf,
      (const T*)hhat, (const T*)gv, (const T*)gh, gdeg, (T*)dq, dk, dv,
      (T*)de, (T*)dg, H, lq, lk, d, has_clip, lo, hi, scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs, in bytes.
extern "C" long long egt_attention_bwd_smem(int lk, int d) {
  return (long long)WARPS * warp_floats(lk, d) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. q, gv, dq (B, H, lq, d); k, v (B, H, lk,
// d); g, h_hat, gh, de, dg (B, H, lq, lk) in the working type; madd (B, lk),
// maddf (B, lq, lk), gdeg (B, H, lq), dk, dv (B, H, lk, d) f32. g, dg and
// gdeg are null when ungated; maddf may be null; a null gdeg counts as
// zeros. Returns cudaGetLastError() after the launch.
extern "C" int egt_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* g,
    const float* madd, const float* maddf, const void* hhat, const void* gv,
    const void* gh, const float* gdeg, void* dq, float* dk, float* dv,
    void* de, void* dg, int B, int H, int lq, int lk, int d, int has_clip,
    float lo, float hi, float scale, unsigned seed_lo, unsigned seed_hi,
    float mask_p, float drop_p, float keep, void* stream) {
  const Draws dr{seed_lo, seed_hi, mask_p, drop_p, keep};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, g, madd, maddf, hhat, gv, gh, gdeg, dq, dk,
                         dv, de, dg, B, H, lq, lk, d, has_clip, lo, hi, scale,
                         dr, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, madd, maddf, hhat, gv, gh, gdeg,
                                 dq, dk, dv, de, dg, B, H, lq, lk, d, has_clip,
                                 lo, hi, scale, dr, s);
  return (int)cudaErrorInvalidValue;
}
