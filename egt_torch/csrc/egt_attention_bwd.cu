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
// ~5 us at 3.35 TB/s. dk and dv are sums over query rows, which the TPU
// kernel carried across its in-order grid; here one block takes a whole
// (graph, head), and its warps' sums are added in a fixed order and written
// once. No float atomics, so a rerun is bit-identical. Two bodies; the C
// launcher picks one from the shape before the launch
// (egt_attention_bwd_geometry says which):
//
// The bf16 body (egt_attention_bwd_mma_kernel: d <= 16, lq and lk <= 64)
// runs every per-head product on the tensor cores, through
// attn_core_mma.cuh: one warp a tile of 16 query rows. The block stages K
// and V once, each warp its rows of q, gv, h_hat, g and gh (16-byte
// cp.async where the rows allow). q.k^T (for the clip's test) and gv.v^T
// come out in C fragments, where the chain re-enters the softmax at h_hat
// and runs its backward; de, dg, rnd(a_d) and rnd(dr) are written over the
// staged h_hat, g and gh rows and a fourth tile, de and dg stored from
// there. dq = rnd(dr).K takes rnd(dr) from the C fragments as A; the dk-
// and dv-shaped sums rnd(dr)^T.q and rnd(a_d)^T.gv read rnd(dr) and
// rnd(a_d) back transposed (ldmatrix.trans). Each warp leaves its two
// (lk, d) sums in f32 over its own staged rows; the block adds them in
// warp order.
//
// The CUDA-core body (egt_attention_bwd_kernel: f32, and bf16 past d 16 or
// 64 keys): each of the block's warps walks query rows (lanes over keys, as
// in the forward) and keeps its own dk / dv sums in shared memory; at the
// end the warps' sums are added in warp order.

#include "attn_core_mma.cuh"

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

// shared memory of the CUDA-core body, bytes
size_t core_smem(int lk, int d) {
  return (size_t)WARPS * warp_floats(lk, d) * sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           const float* madd, const float* maddf, const void* hhat,
           const void* gv, const void* gh, const float* gdeg, void* dq,
           float* dk, float* dv, void* de, void* dg, int B, int H, int lq,
           int lk, int d, int has_clip, float lo, float hi, float scale,
           Draws dr, cudaStream_t stream) {
  const size_t smem = core_smem(lk, d);
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

// ---------------------------------------------------------------- bf16
struct MmaParams {
  const __nv_bfloat16 *q, *k, *v, *g, *hhat, *gv, *gh;
  const float *madd, *maddf, *gdeg;
  __nv_bfloat16 *dq, *de, *dg;
  float *dk, *dv;
  int H, lq, lk, d, has_clip;
  float lo, hi, scale;
  bool vec_d, vec_l;   // 16-byte copies of the (l, d) and (l, l) rows
};

// per warp: q and gv rows; h_hat (then rnd(a_d)), g (then dg), gh (then
// de) and rnd(dr) pair rows
__host__ __device__ inline AttnLayout mma_layout(int lk, int nw) {
  return AttnLayout(lk, nw, 2, 4);
}

template <int NKT>
__global__ void __launch_bounds__(4 * 32)
egt_attention_bwd_mma_kernel(MmaParams p, Draws dr) {
  using bf = __nv_bfloat16;
  constexpr int NT = 2 * NKT;
  extern __shared__ float4 smem4[];
  bf* sm = reinterpret_cast<bf*>(smem4);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int lq = p.lq, lk = p.lk, d = p.d;
  const AttnLayout L = mma_layout(lk, nw);
  const int sp = L.sp;
  const int bh = blockIdx.x, b = bh / p.H, hd = bh - b * p.H;
  const bool gated = p.g != nullptr;
  bf* Ks = sm;
  bf* Vs = sm + L.v;
  bf* Qs = sm + L.warp0 + warp * L.wsz;    // this warp's q rows
  bf* GVs = Qs + 16 * ATT_SD;              // gv rows
  bf* Hs = GVs + 16 * ATT_SD;              // h_hat, then rnd(a_d)
  bf* Gs = Hs + 16 * sp;                   // g, then dg
  bf* GHs = Gs + 16 * sp;                  // gh, then de
  bf* Rs = GHs + 16 * sp;                  // rnd(dr)

  const size_t kv0 = (size_t)bh * lk * d;
  stage_pad(Ks, ATT_SD, p.k + kv0, lk, L.LK, d, 16, p.vec_d, threadIdx.x,
            blockDim.x);
  stage_pad(Vs, ATT_SD, p.v + kv0, lk, L.LK, d, 16, p.vec_d, threadIdx.x,
            blockDim.x);
  const int i0 = 16 * warp, nr = min(16, lq - i0);
  const size_t row0 = (size_t)bh * lq + i0;
  stage_pad(Qs, ATT_SD, p.q + row0 * d, nr, 16, d, 16, p.vec_d, lane, 32);
  stage_pad(GVs, ATT_SD, p.gv + row0 * d, nr, 16, d, 16, p.vec_d, lane, 32);
  stage_pad(Hs, sp, p.hhat + row0 * lk, nr, 16, lk, L.LK, p.vec_l, lane, 32);
  if (gated)
    stage_pad(Gs, sp, p.g + row0 * lk, nr, 16, lk, L.LK, p.vec_l, lane, 32);
  stage_pad(GHs, sp, p.gh + row0 * lk, nr, 16, lk, L.LK, p.vec_l, lane, 32);
  cp_async_commit();
  // the draws while the copies fly
  const TileRows R(p.madd, p.maddf, lq, lk, b, hd, i0);
  const bool dropping = dr.dropping();
  const uint32_t masked =
      dr.mask_p > 0.f ? draw_bits<NT>(R, dr, 0, dr.mask_p) : 0u;
  const uint32_t kept = dropping ? draw_bits<NT>(R, dr, 1, dr.drop_p) : 0u;
  cp_async_wait<0>();
  __syncthreads();

  // the clip's inclusive test on the recomputed raw logit, a bit a pair
  uint32_t inr = 0xffffffffu;
  if (p.has_clip) {
    float raw[NT][4] = {};
    tile_abt<NKT>(raw, Qs, Ks);
#pragma unroll
    for (int jc = 0; jc < NT; ++jc)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = raw[jc][q] * p.scale;
        if (!(x >= p.lo && x <= p.hi)) inr &= ~(1u << (4 * jc + q));
      }
  }

  // s and sg from the saved h_hat, the same draws
  float s[NT][4], sg[NT][4];
#pragma unroll
  for (int jc = 0; jc < NT; ++jc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 hv = ld_bf2(Hs + (gq + 8 * r) * sp + 8 * jc + 2 * tq);
      s[jc][2 * r] = hv.x;
      s[jc][2 * r + 1] = hv.y;
    }
  softmax_gate<NT>(s, sg, gated ? Gs : nullptr, sp, R, masked);

  // dA = gv . v^T, dropped; rnd(a_d) over h_hat's rows, dg over g's; dS in
  // da
  float da[NT][4] = {};
  tile_abt<NKT>(da, GVs, Vs);
  const float inv_keep = 1.f / dr.keep;
  float gd[2] = {0.f, 0.f};
  if (gated && p.gdeg) {
    if (R.ok[0]) gd[0] = p.gdeg[row0 + gq];
    if (R.ok[1]) gd[1] = p.gdeg[row0 + gq + 8];
  }
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int jc = 0; jc < NT; ++jc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float av[2], gv2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = 2 * r + u, c = 8 * jc + 2 * tq + u;
        const bool ok = c < lk && R.ok[r];
        float dav = da[jc][q];
        float a = gated ? s[jc][q] * sg[jc][q] : s[jc][q];
        if (dropping) {
          const float dm = (kept >> (4 * jc + q)) & 1u ? inv_keep : 0.f;
          dav *= dm;
          a *= dm;
        }
        av[u] = ok ? a : 0.f;
        float dS = dav;
        gv2[u] = 0.f;
        if (gated) {
          dS = dav * sg[jc][q];
          const float dsg = dav * s[jc][q] + gd[r];
          gv2[u] = dsg * sg[jc][q] * (1.f - sg[jc][q]);
        }
        da[jc][q] = dS;
        dot[r] += dS * s[jc][q];
      }
      const int off = (gq + 8 * r) * sp + 8 * jc + 2 * tq;
      st_bf2(Hs + off, av[0], av[1]);
      if (gated) st_bf2(Gs + off, gv2[0], gv2[1]);
    }
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);

  // dH = s (dS - dot) + gh: de over gh's rows; rnd(dr) to Rs and, in s, to
  // the A fragments of dq
#pragma unroll
  for (int jc = 0; jc < NT; ++jc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (gq + 8 * r) * sp + 8 * jc + 2 * tq;
      const float2 ghv = ld_bf2(GHs + off);
      float dh[2], drv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = 2 * r + u, c = 8 * jc + 2 * tq + u;
        dh[u] = s[jc][q] * (da[jc][q] - dot[r]) + (u ? ghv.y : ghv.x);
        const bool ok = c < lk && R.ok[r] && ((inr >> (4 * jc + q)) & 1u);
        drv[u] = ok ? dh[u] : 0.f;
        s[jc][q] = drv[u];
      }
      st_bf2(GHs + off, dh[0], dh[1]);
      st_bf2(Rs + off, drv[0], drv[1]);
    }
  uint32_t pdr[NKT][4];
  pack_a<NKT>(pdr, s);
  __syncwarp();

  // dq = rnd(dr) . K scale
  float oq[2][4] = {};
  tile_pm<NKT>(oq, pdr, Ks, d);
  bf* dqo = p.dq + row0 * d;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = gq + 8 * (q >> 1), c = 8 * n + 2 * tq + (q & 1);
      if (r < nr && c < d)
        dqo[r * d + c] = __float2bfloat16_rn(oq[n][q] * p.scale);
    }
  // this warp's dk- and dv-shaped sums: rnd(dr)^T . q and rnd(a_d)^T . gv
  float sk[NKT][2][4] = {}, sv[NKT][2][4] = {};
  {
    uint32_t bq[4], bg[4];
    ldb_kn(bq, Qs, ATT_SD, 0, 0);
    ldb_kn(bg, GVs, ATT_SD, 0, 0);
#pragma unroll
    for (int mt = 0; mt < NKT; ++mt) {
      uint32_t a[4];
      lda_t(a, Rs, sp, 0, 16 * mt);
      mma16816(sk[mt][0], a, bq[0], bq[1]);
      if (d > 8) mma16816(sk[mt][1], a, bq[2], bq[3]);
      lda_t(a, Hs, sp, 0, 16 * mt);
      mma16816(sv[mt][0], a, bg[0], bg[1]);
      if (d > 8) mma16816(sv[mt][1], a, bg[2], bg[3]);
    }
  }
  store_tile(p.de + row0 * lk, GHs, sp, nr, lk, p.vec_l);
  if (gated) store_tile(p.dg + row0 * lk, Gs, sp, nr, lk, p.vec_l);
  __syncwarp();

  // the sums over this warp's staged rows (f32 (LK, 16) each), then the
  // block adds the warps' in warp order
  float* part = reinterpret_cast<float*>(Qs);
#pragma unroll
  for (int mt = 0; mt < NKT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (16 * mt + gq + 8 * r) * 16 + 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(part + off) =
            make_float2(sk[mt][n][2 * r], sk[mt][n][2 * r + 1]);
        *reinterpret_cast<float2*>(part + L.LK * 16 + off) =
            make_float2(sv[mt][n][2 * r], sv[mt][n][2 * r + 1]);
      }
  __syncthreads();
  const float* part0 = reinterpret_cast<const float*>(sm + L.warp0);
  const int wf = L.wsz / 2;                  // a warp's region in floats
  for (int t = threadIdx.x; t < lk * d; t += blockDim.x) {
    const int j = t / d, c = t - j * d;
    float ak = 0.f, av = 0.f;
    for (int w = 0; w < nw; ++w) {
      ak += part0[w * wf + j * 16 + c];
      av += part0[w * wf + L.LK * 16 + j * 16 + c];
    }
    p.dk[kv0 + t] = ak * p.scale;
    p.dv[kv0 + t] = av;
  }
}

int launch_mma(const MmaParams& p, int B, Draws dr, cudaStream_t stream) {
  const int nw = attn_mma_warps(p.lq);
  const AttnLayout L = mma_layout(p.lk, nw);
  const int nkt = L.LK / 16;
  auto kern = nkt == 1   ? egt_attention_bwd_mma_kernel<1>
              : nkt == 2 ? egt_attention_bwd_mma_kernel<2>
              : nkt == 3 ? egt_attention_bwd_mma_kernel<3>
                         : egt_attention_bwd_mma_kernel<4>;
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
extern "C" long long egt_attention_bwd_geometry(int dtype, int lq, int lk,
                                                int d, int* out) {
  if (attn_mma_body(dtype, lq, lk, d)) {
    out[0] = 1;
    out[1] = attn_mma_warps(lq);
    out[2] = mma_layout(lk, attn_mma_warps(lq)).bytes;
    return 0;
  }
  const size_t bytes = core_smem(lk, d);
  if (bytes > 227 * 1024) return 1;
  out[0] = 0; out[1] = WARPS; out[2] = (int)bytes;
  return 0;
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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!attn_mma_body(dtype, lq, lk, d))
    return launch<__nv_bfloat16>(q, k, v, g, madd, maddf, hhat, gv, gh, gdeg,
                                 dq, dk, dv, de, dg, B, H, lq, lk, d,
                                 has_clip, lo, hi, scale, dr, s);
  using bf = __nv_bfloat16;
  const bool vec_d = (d & 7) == 0 && aligned16(q) && aligned16(k) &&
                     aligned16(v) && aligned16(gv);
  const bool vec_l = (lk & 7) == 0 && aligned16(hhat) && aligned16(gh) &&
                     aligned16(de) && (!g || (aligned16(g) && aligned16(dg)));
  const MmaParams p{(const bf*)q, (const bf*)k, (const bf*)v, (const bf*)g,
                    (const bf*)hhat, (const bf*)gv, (const bf*)gh, madd,
                    maddf, gdeg, (bf*)dq, (bf*)de, (bf*)dg, dk, dv, H, lq, lk,
                    d, has_clip, lo, hi, scale, vec_d, vec_l};
  return launch_mma(p, B, dr, s);
}
