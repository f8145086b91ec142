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
// v_att on store). The softmax runs on the f32 h_hat. The degree scaler
// stays in the Python wrapper.
//
// What bounds it on an H100: bytes. At the ZINC-500k serving shape (b 128,
// h 8, l 40, d 8, bf16) it reads e and g and writes h_hat, three
// (b, h, l, l) tensors of 3.3 MB each, against ~0.1 MFLOP per (b, h): about
// 13 MB in all, ~4 us at 3.35 TB/s, far below the ops ceiling. With the
// draws live, the Philox words (two a pair) cost more instructions than
// the rest of the chain. Two bodies; the C launcher picks one from the
// shape before the launch (egt_attention_fwd_geometry says which):
//
// The bf16 body (egt_attention_fwd_mma_kernel: d <= 16, lq and lk <= 64)
// runs the per-head products on the tensor cores, through
// attn_core_mma.cuh: one block a (graph, head), one warp a tile of 16 query
// rows. The block stages K and V once, each warp its q rows and its rows
// of e and g (16-byte cp.async where the rows allow, element loads for odd
// widths); q.k^T comes out in C fragments, where the clip and + e make
// h_hat, rounded in place over e's staged rows and stored from there 16
// bytes at a time. The softmax chain runs on the f32 values in the
// fragments, reducing over a quad of lanes; rnd(a) is packed from the C
// fragments straight into A fragments and A.V runs with V as B. No
// barrier follows the staging's.
//
// The CUDA-core body (egt_attention_fwd_kernel: f32, and bf16 past d 16 or
// 64 keys) runs one warp per query row, WARPS rows per block, one block per
// (b, h, row block). Lanes stride over keys, so the e / g / h_hat row
// traffic is coalesced; the logits and gate row lives in shared memory
// (per warp, 2 * lk floats) between the max, sum and A.V passes; K and V
// are read through L1.
//
// In both the draws are a template switch: with the Philox code compiled
// in, ptxas gave the CUDA-core kernel 56 registers a thread instead of 40,
// fewer warps fit an SM, and its inference launch ran 25% slower on an H100
// (PERF.md).

#include "attn_core_mma.cuh"

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

// shared memory of the CUDA-core body, bytes
size_t core_smem(int lk, int d) {
  return (size_t)WARPS * (2 * lk + d + 32) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* e,
           const void* g, const float* madd, const float* maddf, void* vatt,
           void* hhat, float* deg, int B, int H, int lq, int lk, int d,
           int has_clip, float lo, float hi, float scale, Draws dr,
           cudaStream_t stream) {
  const size_t smem = core_smem(lk, d);
  auto kern = (dr.mask_p > 0.f || dr.drop_p > 0.f)
                  ? egt_attention_fwd_kernel<T, true>
                  : egt_attention_fwd_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * H * ((lq + WARPS - 1) / WARPS);
  kern<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)e, (const T*)g, madd,
      maddf, (T*)vatt, (T*)hhat, deg, H, lq, lk, d, has_clip, lo, hi, scale,
      dr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
struct MmaParams {
  const __nv_bfloat16 *q, *k, *v, *e, *g;
  const float *madd, *maddf;
  __nv_bfloat16 *vatt, *hhat;
  float* deg;
  int H, lq, lk, d, has_clip;
  float lo, hi, scale;
  bool vec_d, vec_l;   // 16-byte copies of the (l, d) and (l, l) rows
};

template <int NKT, bool DRAWS>
__global__ void __launch_bounds__(4 * 32)
egt_attention_fwd_mma_kernel(MmaParams p, Draws dr) {
  using bf = __nv_bfloat16;
  constexpr int NT = 2 * NKT;
  extern __shared__ float4 smem4[];
  bf* sm = reinterpret_cast<bf*>(smem4);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int lq = p.lq, lk = p.lk, d = p.d;
  const AttnLayout L(lk, nw, 1, 2);
  const int sp = L.sp;
  const int bh = blockIdx.x, b = bh / p.H, hd = bh - b * p.H;
  bf* Ks = sm;
  bf* Vs = sm + L.v;
  bf* Qs = sm + L.warp0 + warp * L.wsz;   // this warp's q rows
  bf* Es = Qs + 16 * ATT_SD;               // e, then rnd(h_hat)
  bf* Gs = Es + 16 * sp;

  const size_t kv0 = (size_t)bh * lk * d;
  stage_pad(Ks, ATT_SD, p.k + kv0, lk, L.LK, d, 16, p.vec_d, threadIdx.x,
            blockDim.x);
  stage_pad(Vs, ATT_SD, p.v + kv0, lk, L.LK, d, 16, p.vec_d, threadIdx.x,
            blockDim.x);
  const int i0 = 16 * warp, nr = min(16, lq - i0);
  const size_t row0 = (size_t)bh * lq + i0;
  stage_pad(Qs, ATT_SD, p.q + row0 * d, nr, 16, d, 16, p.vec_d, lane, 32);
  stage_pad(Es, sp, p.e + row0 * lk, nr, 16, lk, L.LK, p.vec_l, lane, 32);
  if (p.g) stage_pad(Gs, sp, p.g + row0 * lk, nr, 16, lk, L.LK, p.vec_l,
                     lane, 32);
  cp_async_commit();
  // the draws while the copies fly
  const TileRows R(p.madd, p.maddf, lq, lk, b, hd, i0);
  const bool dropping = DRAWS && dr.dropping();
  const uint32_t masked = DRAWS && dr.mask_p > 0.f
                              ? draw_bits<NT>(R, dr, 0, dr.mask_p) : 0u;
  const uint32_t kept = dropping ? draw_bits<NT>(R, dr, 1, dr.drop_p) : 0u;
  cp_async_wait<0>();
  __syncthreads();

  // h_hat = clip(q . k^T scale) + e: rounded over e's rows, f32 in x
  float x[NT][4] = {};
  tile_abt<NKT>(x, Qs, Ks);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf* ep = Es + (gq + 8 * r) * sp + 8 * j + 2 * tq;
      const float2 ev = ld_bf2(ep);
      float s0 = x[j][2 * r] * p.scale, s1 = x[j][2 * r + 1] * p.scale;
      if (p.has_clip) {
        s0 = fminf(fmaxf(s0, p.lo), p.hi);
        s1 = fminf(fmaxf(s1, p.lo), p.hi);
      }
      x[j][2 * r] = s0 + ev.x;
      x[j][2 * r + 1] = s1 + ev.y;
      st_bf2(ep, x[j][2 * r], x[j][2 * r + 1]);
    }

  float sg[NT][4];
  softmax_gate<NT>(x, sg, p.g ? Gs : nullptr, sp, R, masked);

  // a = s sg, dropped, rounded; the degree sums. A kept weight is
  // multiplied by 1 / keep where the plain version divides by keep: at
  // most an f32 ulp apart, below the bf16 rounding of a
  const float inv_keep = 1.f / dr.keep;
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a = x[j][q];
      if (p.g) {
        a *= sg[j][q];
        dsum[q >> 1] += sg[j][q];
      }
      if (dropping) a = (kept >> (4 * j + q)) & 1u ? a * inv_keep : 0.f;
      x[j][q] = a;
    }
  uint32_t pa[NKT][4];
  pack_a<NKT>(pa, x);
  float o[2][4] = {};
  tile_pm<NKT>(o, pa, Vs, d);

  bf* vo = p.vatt + row0 * d;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = gq + 8 * (q >> 1), c = 8 * n + 2 * tq + (q & 1);
      if (r < nr && c < d) vo[r * d + c] = __float2bfloat16_rn(o[n][q]);
    }
  if (p.g) {
    const float d0 = quad_sum(dsum[0]), d1 = quad_sum(dsum[1]);
    if (tq == 0) {
      if (R.ok[0]) p.deg[row0 + gq] = d0;
      if (R.ok[1]) p.deg[row0 + gq + 8] = d1;
    }
  }
  __syncwarp();
  store_tile(p.hhat + row0 * lk, Es, sp, nr, lk, p.vec_l);
}

template <bool DRAWS>
int launch_mma(const MmaParams& p, int B, Draws dr, cudaStream_t stream) {
  const int nw = attn_mma_warps(p.lq);
  const AttnLayout L(p.lk, nw, 1, 2);
  const int nkt = L.LK / 16;
  auto kern = nkt == 1   ? egt_attention_fwd_mma_kernel<1, DRAWS>
              : nkt == 2 ? egt_attention_fwd_mma_kernel<2, DRAWS>
              : nkt == 3 ? egt_attention_fwd_mma_kernel<3, DRAWS>
                         : egt_attention_fwd_mma_kernel<4, DRAWS>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<(unsigned)((long long)B * p.H), nw * 32, L.bytes, stream>>>(p, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// Which body takes a shape (dtype 0 f32, 1 bf16): out = [1 for the
// tensor-core body, 0 for the CUDA-core body; warps a block; shared memory
// bytes a block]. Returns 0, or 1 (out untouched) when the shape's body
// does not fit 227 KB. The launcher asks the same rule.
extern "C" long long egt_attention_fwd_geometry(int dtype, int lq, int lk,
                                                int d, int* out) {
  if (attn_mma_body(dtype, lq, lk, d)) {
    out[0] = 1;
    out[1] = attn_mma_warps(lq);
    out[2] = AttnLayout(lk, attn_mma_warps(lq), 1, 2).bytes;
    return 0;
  }
  const size_t bytes = core_smem(lk, d);
  if (bytes > 227 * 1024) return 1;
  out[0] = 0; out[1] = WARPS; out[2] = (int)bytes;
  return 0;
}

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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!attn_mma_body(dtype, lq, lk, d))
    return launch<__nv_bfloat16>(q, k, v, e, g, madd, maddf, vatt, hhat, deg,
                                 B, H, lq, lk, d, has_clip, lo, hi, scale,
                                 dr, s);
  using bf = __nv_bfloat16;
  const bool vec_d = (d & 7) == 0 && aligned16(q) && aligned16(k) &&
                     aligned16(v);
  const bool vec_l = (lk & 7) == 0 && aligned16(e) && aligned16(hhat) &&
                     (!g || aligned16(g));
  const MmaParams p{(const bf*)q, (const bf*)k, (const bf*)v, (const bf*)e,
                    (const bf*)g, madd, maddf, (bf*)vatt, (bf*)hhat, deg, H,
                    lq, lk, d, has_clip, lo, hi, scale, vec_d, vec_l};
  return (mask_p > 0.f || drop_p > 0.f) ? launch_mma<true>(p, B, dr, s)
                                        : launch_mma<false>(p, B, dr, s);
}
