// Whole EGT layer edge core, forward (inference and training), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_fwd_kernel, called through
// _fused_layer_fwd_call / fused_layer_apply.
//
// For each query row (b, i) and every key j, with e (b, l, l, ew) and the
// node projections qkv (b, l, 3 * dh) (dh = d * h, feature f = dd * h + hh):
//   x      = LN(e[b, i, j, :])                       (eps 1e-3)
//   G      = x . Wg + bg,  E = act_e(x . Wb + bb)    (ew -> h)
//   h_hat  = clip(q_i . k_j * d^-1/2) + E            (per head)
//   A      = softmax_j(h_hat + madd_j [+ aadd_ij] [+ rmask_ij])
//            * sigmoid(G + madd_j [+ aadd_ij] [+ rmask_ij])
//   A      = kept_ij ? A / keep : 0                    (training dropout)
//   v_att_i = sum_j A_ij v_j                          (written, (b, l, dh))
//   hh     = h_hat                                     (written when asked,
//                                                       (b, l, l, h), for the
//                                                       split backward)
//   e_mid  = h_hat . Wr + br + e[b, i, j, :]          (h -> ew)
//   e_out  = act(LN(e_mid) . W1 + b1) . W2 + b2 + e_mid   (written)
// Math is f32; e, qkv, the weight matrices, e_out and v_att are in the
// working type (f32 or bf16), rounded where the JAX kernel rounds: the LN
// outputs, h_hat before Wr, A before A.V, and the FFN hidden activations.
// The random mask and dropout (training) draw from philox.cuh: draw 0 and 1
// of (b, i, j, head). Only v_att sees them: e_out depends on the pre-mask
// h_hat.
//
// What bounds it on an H100: at the ZINC-500k serving shape (b 128, l 40,
// ew 64, h 8, hidden 128, bf16) it must move ~55 MB (e in, e_out out, qkv,
// v_att), 16 us at 3.35 TB/s, and do ~7.4 GFLOP, 7.5 us at the bf16
// tensor-core peak: bytes bound it. On the f32 CUDA cores (67 TFLOP/s) the
// FLOPs of the 64 -> 128 -> 64 edge FFN (>90% of the work) set its time
// (1.24 ms as first ported), so the bf16 body (fused_layer_fwd_mma_kernel,
// below) runs the edge-head projection, dense_edge_r and the FFN on the
// tensor cores, mma.sync m16n8k16 with f32 sums (mma.cuh), in tiles of 16
// pairs a warp, with the LayerNorms reduced in registers; q.k, the softmax,
// the gate, the draws and A.V stay on the CUDA cores. What bounds that body
// now is latency: the FFN chain of each warp, the per-(pair, head) q.k and
// logits, and the softmax and A.V of each group of query rows between block
// barriers, at two 5-warp blocks a SM (`python3 -m egt_torch.phase_times`
// times each phase by ablation).
//
// Design of the f32 body (fused_layer_fwd_kernel, exact f32 products): a
// persistent grid, sized by the occupancy API, walks the b * l query rows;
// each block loads every weight once into shared memory and keeps it for
// all its rows. Per row, keys are taken in chunks of TJ pairs so shared
// memory does not grow with l except for the (l, h) logits/gates/h_hat rows
// the softmax needs. The small products run as register-tiled 4 x 4
// shared-memory GEMMs. e is read once per phase (the second read, for the
// residual, hits L2) and e_out and v_att are written once; no per-pair
// intermediate goes to device memory.

#include <type_traits>

#include "common.cuh"
#include "edge_tail_mma.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

using namespace egt;

constexpr int NT = 256;  // threads per block
constexpr int TJ = 32;   // keys per chunk (a multiple of 4)

// Y[jj][n] = sum_k XT[k][jj] * W[k][n] for jj < nj, n < N, handed to
// epi(jj, n, y). XT is (K, TJ) f32 in shared memory, W is (K, N) row-major.
// Each thread owns a 4-row x 4-column tile: rows 4*rg..4*rg+3 (one float4
// load of XT per k) and columns cb + r*NQ (consecutive across lanes, so the
// W loads are free of bank conflicts).
template <typename W, typename Epi>
__device__ __forceinline__ void small_gemm(const float* XT, int nj,
                                           const W* w, int K, int N, Epi epi) {
  const int NQ = (N + 3) / 4, RG = (nj + 3) / 4;
  for (int t = threadIdx.x; t < RG * NQ; t += NT) {
    const int cb = t % NQ, rg = t / NQ;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][r] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(XT + kk * TJ + rg * 4);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      float wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = cb + r * NQ;
        wv[r] = n < N ? to_f(w[kk * N + n]) : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[a][r] = fmaf(xs[a], wv[r], acc[a][r]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jj = rg * 4 + a;
      if (jj >= nj) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = cb + r * NQ;
        if (n < N) epi(jj, n, acc[a][r]);
      }
    }
  }
}

// LayerNorm of rows src[jj * ew + c] (jj < nj), one warp per row, written
// transposed and rounded to the working type: dstT[c * TJ + jj].
template <typename T>
__device__ __forceinline__ void ln_rows_t(const float* src, int nj, int ew,
                                          const float* gamma,
                                          const float* beta, float* dstT) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int jj = warp; jj < nj; jj += NT / 32) {
    const float* x = src + jj * ew;
    float s = 0.f;
    for (int c = lane; c < ew; c += 32) s += x[c];
    const float mu = warp_sum(s) / ew;
    float s2 = 0.f;
    for (int c = lane; c < ew; c += 32) {
      const float dx = x[c] - mu;
      s2 += dx * dx;
    }
    const float rstd = rsqrtf(warp_sum(s2) / ew + LN_EPS);
    for (int c = lane; c < ew; c += 32)
      dstT[c * TJ + jj] = rnd<T>(gamma[c] * ((x[c] - mu) * rstd) + beta[c]);
  }
}

struct Params {
  const void* e; const void* qkv; const float* mask; const float* amask;
  const void* wg; const float* bg; const void* wb; const float* bb;
  const float* g1; const float* b1; const void* wr; const float* br;
  const float* g2; const float* b2; const void* w1; const float* bb1;
  const void* w2; const float* bb2;
  void* eout; void* vatt; void* hhout;
  int B, l, ew, h, dh, hid, gated, has_clip;
  float lo, hi, scale;
  int edge_act, act;
  float edge_alpha, act_alpha;
  Draws dr;
};

// shared-memory carve-up, in floats then working-type elements
struct Layout {
  int xT, hidT, em, gpre, hh, lm, sg, q, red, vec, nf;  // float offsets
  int wgb, wr, w1, w2, nw;                              // T offsets
  __host__ __device__ Layout(int l, int ew, int h, int dh, int hid) {
    int o = 0;
    xT = o;   o += ew * TJ;       // 16-byte aligned for the float4 loads
    hidT = o; o += hid * TJ;
    em = o;   o += TJ * ew;
    gpre = o; o += TJ * h;
    hh = o;   o += l * h;
    lm = o;   o += l * h;
    sg = o;   o += l * h;
    q = o;    o += dh;
    red = o;  o += NT;
    vec = o;  o += 2 * h + 6 * ew + hid;  // bg bb g1 b1 br g2 b2 bb2 bb1
    nf = (o + 3) & ~3;
    int w = 0;
    wgb = w; w += ew * 2 * h;
    wr = w;  w += h * ew;
    w1 = w;  w += ew * hid;
    w2 = w;  w += hid * ew;
    nw = w;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) fused_layer_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh, hid = p.hid;
  const Layout L(l, ew, h, dh, hid);
  T* ws = reinterpret_cast<T*>(sm + L.nf);
  float *xT = sm + L.xT, *hidT = sm + L.hidT, *em = sm + L.em;
  float *gpre = sm + L.gpre, *hh_s = sm + L.hh, *lm_s = sm + L.lm;
  float *sg_s = sm + L.sg, *q_s = sm + L.q, *red = sm + L.red;
  float *bg = sm + L.vec, *bb = bg + h, *g1 = bb + h, *b1 = g1 + ew;
  float *br = b1 + ew, *g2 = br + ew, *b2 = g2 + ew, *bb2 = b2 + ew;
  float *bb1 = bb2 + ew;
  T *wgb = ws + L.wgb, *wr = ws + L.wr, *w1 = ws + L.w1, *w2 = ws + L.w2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nproj = p.gated ? 2 * h : h;  // [gate | bias] projection columns

  // ---- weights, once per block
  const T* Wg = (const T*)p.wg;
  const T* Wb = (const T*)p.wb;
  for (int t = tid; t < ew * nproj; t += NT) {
    const int c = t / nproj, n = t % nproj;
    wgb[t] = (p.gated && n < h) ? Wg[c * h + n] : Wb[c * h + (n - (nproj - h))];
  }
  for (int t = tid; t < h * ew; t += NT) wr[t] = ((const T*)p.wr)[t];
  for (int t = tid; t < ew * hid; t += NT) {
    w1[t] = ((const T*)p.w1)[t];
    w2[t] = ((const T*)p.w2)[t];
  }
  for (int t = tid; t < h; t += NT) {
    bg[t] = p.gated ? p.bg[t] : 0.f;
    bb[t] = p.bb[t];
  }
  for (int t = tid; t < ew; t += NT) {
    g1[t] = p.g1[t]; b1[t] = p.b1[t]; br[t] = p.br[t];
    g2[t] = p.g2[t]; b2[t] = p.b2[t]; bb2[t] = p.bb2[t];
  }
  for (int t = tid; t < hid; t += NT) bb1[t] = p.bb1[t];

  const T* E = (const T*)p.e;
  const T* QKV = (const T*)p.qkv;
  T* EO = (T*)p.eout;
  T* VA = (T*)p.vatt;
  T* HO = (T*)p.hhout;
  const int rows = p.B * l;
  const bool dropping = p.dr.dropping();

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / l, i = row % l;
    const size_t ebase = (size_t)row * l * ew;  // e[b, i, 0, 0]
    const float* mrow = p.mask + (size_t)b * l;
    const float* arow = p.amask ? p.amask + (size_t)row * l : nullptr;
    const T* kbase = QKV + (size_t)b * l * 3 * dh + dh;
    __syncthreads();  // previous row done with every buffer; weights loaded
    for (int t = tid; t < dh; t += NT) q_s[t] = to_f(QKV[(size_t)row * 3 * dh + t]);

    // ---- phase 1: edge pre-LN -> gates, bias -> h_hat, logits, sigmoid
    for (int j0 = 0; j0 < l; j0 += TJ) {
      const int nj = min(TJ, l - j0);
      for (int t = tid; t < nj * ew; t += NT)
        em[t] = to_f(E[ebase + (size_t)j0 * ew + t]);
      __syncthreads();
      ln_rows_t<T>(em, nj, ew, g1, b1, xT);
      __syncthreads();
      small_gemm(xT, nj, wgb, ew, nproj, [&](int jj, int n, float y) {
        if (p.gated && n < h) {
          gpre[jj * h + n] = y + bg[n];
        } else {
          const int hh = n - (nproj - h);
          hh_s[(j0 + jj) * h + hh] = act_fn(p.edge_act, p.edge_alpha, y + bb[hh]);
        }
      });
      __syncthreads();
      for (int t = tid; t < nj * h; t += NT) {
        const int jj = t / h, hh = t % h, j = j0 + jj;
        const T* kr = kbase + (size_t)j * 3 * dh;
        float s = 0.f;
        for (int dd = hh; dd < dh; dd += h) s = fmaf(q_s[dd], to_f(kr[dd]), s);
        s *= p.scale;
        if (p.has_clip) s = fminf(fmaxf(s, p.lo), p.hi);
        const float hv = s + hh_s[j * h + hh];
        hh_s[j * h + hh] = hv;
        if (HO) HO[((size_t)row * l + j) * h + hh] = from_f<T>(hv);
        const float madd = (mrow[j] - 1.f) * 1e9f;
        const float rm = p.dr.mask_add(b, i, j, hh);
        float lg = hv + madd;
        if (arow) lg += (arow[j] - 1.f) * 1e9f;
        lm_s[j * h + hh] = lg + rm;
        if (p.gated) {
          float gm = gpre[t] + madd;
          if (arow) gm += (arow[j] - 1.f) * 1e9f;
          sg_s[j * h + hh] = sigmoid(gm + rm);
        }
      }
      __syncthreads();
    }

    // ---- phase 2: softmax over keys per head, times the gate
    for (int hh = warp; hh < h; hh += NT / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < l; j += 32) mx = fmaxf(mx, lm_s[j * h + hh]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < l; j += 32) {
        const float ex = expf(lm_s[j * h + hh] - mx);
        lm_s[j * h + hh] = ex;
        s += ex;
      }
      const float den = fmaxf(warp_sum(s), 1e-30f);
      for (int j = lane; j < l; j += 32) {
        float a = lm_s[j * h + hh] / den;
        if (p.gated) a *= sg_s[j * h + hh];
        if (dropping) a = p.dr.kept(b, i, j, hh) ? a / p.dr.keep : 0.f;
        lm_s[j * h + hh] = rnd<T>(a);
      }
    }
    __syncthreads();

    // ---- phase 3: v_att_i = sum_j A_ij v_j
    const T* vbase = QKV + (size_t)b * l * 3 * dh + 2 * dh;
    if (dh <= NT) {
      const int G = NT / dh, f = tid % dh, grp = tid / dh;
      float acc = 0.f;
      if (grp < G)
        for (int j = grp; j < l; j += G)
          acc = fmaf(lm_s[j * h + f % h], to_f(vbase[(size_t)j * 3 * dh + f]), acc);
      red[tid] = acc;
      __syncthreads();
      if (tid < dh) {
        float s = 0.f;
        for (int gi = 0; gi < G; ++gi) s += red[gi * dh + tid];
        VA[(size_t)row * dh + tid] = from_f<T>(s);
      }
    } else {
      for (int f = tid; f < dh; f += NT) {
        float acc = 0.f;
        for (int j = 0; j < l; ++j)
          acc = fmaf(lm_s[j * h + f % h], to_f(vbase[(size_t)j * 3 * dh + f]), acc);
        VA[(size_t)row * dh + f] = from_f<T>(acc);
      }
    }

    // ---- phase 4: dense_edge_r + residual -> LN -> FFN + residual
    for (int j0 = 0; j0 < l; j0 += TJ) {
      const int nj = min(TJ, l - j0);
      __syncthreads();
      for (int t = tid; t < nj * ew; t += NT) {
        const int jj = t / ew, c = t % ew;
        const float* hv = hh_s + (j0 + jj) * h;
        float acc = 0.f;
        for (int hh = 0; hh < h; ++hh)
          acc = fmaf(rnd<T>(hv[hh]), to_f(wr[hh * ew + c]), acc);
        em[t] = acc + br[c] + to_f(E[ebase + (size_t)j0 * ew + t]);
      }
      __syncthreads();
      ln_rows_t<T>(em, nj, ew, g2, b2, xT);
      __syncthreads();
      small_gemm(xT, nj, w1, ew, hid, [&](int jj, int u, float y) {
        hidT[u * TJ + jj] = rnd<T>(act_fn(p.act, p.act_alpha, y + bb1[u]));
      });
      __syncthreads();
      small_gemm(hidT, nj, w2, hid, ew, [&](int jj, int c, float y) {
        EO[ebase + (size_t)(j0 + jj) * ew + c] = from_f<T>(y + bb2[c] + em[jj * ew + c]);
      });
    }
  }
}

// ---------------------------------------------------------------- bf16
// The tensor-core body. A block takes a group of R consecutive query rows:
// its R l pairs, flattened, are cut into tiles of 16 pairs, and warp w
// takes tiles w, w + nw, ... Per tile the warp runs, in mma fragments
// (mma.cuh) and its own staged rows: LN(e) -> [Wg | Wb] -> q.k, clip,
// h_hat (hh out), logits and gates into the group's (R l, h) arrays; then,
// as e_out depends only on the pre-mask h_hat, the tail at once:
// rnd(h_hat) . Wr + br + e -> LN -> FFN (hid from the C fragments of the
// first product straight into the A fragments of the second) + residual ->
// e_out (edge_tail_mma.cuh's tail_fwd_mma, which K8's bf16 body runs too).
// Then the block takes the softmax per (row, head) and A.V.
// e is staged with cp.async one tile ahead (two buffers a warp) and read
// from device memory once.
// Shared memory: f32 vectors (the projection biases, g1 b1 br g2 b2 bb2
// (EK each), bb1 (UK)), q of the group's rows, logits and gates (R l h),
// each warp's projection outputs (16 x NP); bf16 [Wg | Wb] (EK x NP),
// Wr (HK x EK), W1 (EK x UK), W2 (UK x EK), and per warp two e buffers, the
// LN output (LN(e), then LN(e_mid)) and rnd(h_hat), 16 rows each.
constexpr int FWD_MMA_WARPS = 8;

struct MmaLayout {
  int EK, UK, HK, NP, se, su, sh, sn, nproj, R, nw;
  int vec, q, lm, sg, proj, nf;           // float offsets
  int wgb, wr, w1, w2, e, x, hh;          // bf16 offsets
  size_t bytes;
  __host__ __device__ MmaLayout(int l, int ew, int h, int dh, int hid,
                                int gated, int R_, int nw_) {
    EK = round16(ew); UK = round16(hid); HK = round16(h);
    nproj = gated ? 2 * h : h; NP = round16(nproj);
    se = EK + 8; su = UK + 8; sh = HK + 8; sn = NP + 8;
    R = R_; nw = nw_;
    int o = 0;
    vec = o;  o += NP + 6 * EK + UK;
    q = o;    o += R * dh;
    lm = o;   o += R * l * h;
    sg = o;   o += R * l * h;
    proj = o; o += nw * 16 * NP;
    nf = (o + 3) & ~3;
    int b = 0;
    wgb = b; b += EK * sn;
    wr = b;  b += HK * se;
    w1 = b;  b += EK * su;
    w2 = b;  b += UK * se;
    e = b;   b += nw * 2 * 16 * se;
    x = b;   b += nw * 16 * se;
    hh = b;  b += nw * 16 * sh;
    bytes = (size_t)nf * 4 + (size_t)b * 2;
  }
};

// rows of a group and warps a block: the R (tiles of 16 pairs <= 8) that
// wastes the least of its last tile, for l > 128 one row and 8 warps
__host__ inline void group_shape(int l, int& R, int& nw) {
  R = 1; nw = FWD_MMA_WARPS;
  if (l > 16 * FWD_MMA_WARPS) return;
  double best = -1.0;
  for (int r = 1; (r * l + 15) / 16 <= FWD_MMA_WARPS; ++r) {
    const int tiles = (r * l + 15) / 16;
    const double eff = (double)(r * l) / (16.0 * tiles);
    if (eff > best + 1e-9) { best = eff; R = r; nw = tiles; }
  }
}

template <int NTE>
__global__ void __launch_bounds__(FWD_MMA_WARPS * 32, 2)
    fused_layer_fwd_mma_kernel(Params p, int R) {
  using bf = __nv_bfloat16;
  constexpr int NKE = NTE / 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, E = p.ew, h = p.h, dh = p.dh, U = p.hid;
  const int nw = blockDim.x >> 5;
  const MmaLayout L(l, E, h, dh, U, p.gated, R, nw);
  const int EK = L.EK, UK = L.UK, HK = L.HK, NP = L.NP, nproj = L.nproj;
  const int se = L.se, su = L.su, sh = L.sh, sn = L.sn;
  float *vbp = sm + L.vec, *vg1 = vbp + NP, *vb1 = vg1 + EK, *vbr = vb1 + EK;
  float *vg2 = vbr + EK, *vb2 = vg2 + EK, *vbb2 = vb2 + EK, *vbb1 = vbb2 + EK;
  float *q_s = sm + L.q, *lm_s = sm + L.lm, *sg_s = sm + L.sg;
  bf* bs = reinterpret_cast<bf*>(sm + L.nf);
  bf *Wgb = bs + L.wgb, *Wr = bs + L.wr, *W1 = bs + L.w1, *W2 = bs + L.w2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* projW = sm + L.proj + warp * 16 * NP;
  bf* eW = bs + L.e + warp * 2 * 16 * se;
  bf* xW = bs + L.x + warp * 16 * se;
  bf* hhW = bs + L.hh + warp * 16 * sh;
  const bf zero = __float2bfloat16_rn(0.f);

  // ---- weights (zero-padded) and vectors, once per block; staging zeroed
  zero_smem(bs, L.hh + nw * 16 * sh);
  for (int t = tid; t < NP; t += blockDim.x) {
    float v = 0.f;
    if (t < nproj) v = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
    vbp[t] = v;
  }
  for (int t = tid; t < EK; t += blockDim.x) {
    const bool ok = t < E;
    vg1[t] = ok ? p.g1[t] : 0.f; vb1[t] = ok ? p.b1[t] : 0.f;
    vbr[t] = ok ? p.br[t] : 0.f; vg2[t] = ok ? p.g2[t] : 0.f;
    vb2[t] = ok ? p.b2[t] : 0.f; vbb2[t] = ok ? p.bb2[t] : 0.f;
  }
  for (int t = tid; t < UK; t += blockDim.x) vbb1[t] = t < U ? p.bb1[t] : 0.f;
  __syncthreads();
  if (p.gated) stage_matrix(Wgb, sn, (const bf*)p.wg, E, h);
  stage_matrix(Wgb + nproj - h, sn, (const bf*)p.wb, E, h);
  stage_matrix(Wr, se, (const bf*)p.wr, h, E);
  stage_matrix(W1, su, (const bf*)p.w1, E, U);
  stage_matrix(W2, se, (const bf*)p.w2, U, E);
  __syncthreads();
  const TailMmaW TW{Wr, W1, W2, vbr, vg2, vb2, vbb1, vbb2, E, U, EK, UK, HK,
                    se, su};

  const bf* E_ = (const bf*)p.e;
  const bf* QKV = (const bf*)p.qkv;
  bf* EO = (bf*)p.eout;
  bf* VA = (bf*)p.vatt;
  bf* HO = (bf*)p.hhout;
  const int rows = p.B * l;
  const int ngroups = (rows + R - 1) / R;
  const bool dropping = p.dr.dropping();
  // the warp's tiles, in order: (group, tile) with tile = warp, warp + nw..
  auto tiles_of = [&](int grp) {
    const int nr = min(R, rows - grp * R);
    return (nr * l + 15) / 16;
  };
  // pair range of a tile: first flattened pair and valid count
  auto tile_pairs = [&](int grp, int tt, long long& P0) {
    const long long g0 = (long long)grp * R * l;
    const long long gend = g0 + (long long)min(R, rows - grp * R) * l;
    P0 = g0 + 16 * tt;
    const long long r = gend - P0;
    return (int)(r > 16 ? 16 : r);
  };
  int item = 0;    // tiles this warp has taken: e buffer item & 1
  if (blockIdx.x < ngroups && warp < tiles_of(blockIdx.x)) {
    long long P0;
    const int nv = tile_pairs(blockIdx.x, warp, P0);
    stage_rows16(eW, se, E_ + P0 * E, nv, E);
  }
  cp_async_commit();

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const int row0 = grp * R, nr = min(R, rows - row0), ntl = tiles_of(grp);
    __syncthreads();      // the previous group's softmax and A.V are done
    for (int t = tid; t < nr * dh; t += blockDim.x) {
      const int rg = t / dh, f = t - rg * dh;
      q_s[t] = __bfloat162float(QKV[(size_t)(row0 + rg) * 3 * dh + f]);
    }
    __syncthreads();

    for (int tt = warp; tt < ntl; tt += nw, ++item) {
      bf* eC = eW + (item & 1) * 16 * se;
      long long P0;
      const int nv = tile_pairs(grp, tt, P0);
      // prefetch the warp's next tile
      {
        int ng = grp, nt = tt + nw;
        if (nt >= ntl) { ng = grp + gridDim.x; nt = warp; }
        if (ng < ngroups && nt < tiles_of(ng)) {
          long long Pn;
          const int nvn = tile_pairs(ng, nt, Pn);
          stage_rows16(eW + ((item + 1) & 1) * 16 * se, se, E_ + Pn * E, nvn, E);
        }
        cp_async_commit();
      }
      cp_async_wait<1>();
      __syncwarp();

      // ---- LN(e) -> xW (rounded)
      {
        float ev[NTE][4];
#pragma unroll
        for (int j = 0; j < NTE; ++j) {
          if (j < EK / 8) {
            const int c = 8 * j + 2 * tq;
            const float2 e0 = ld_bf2(eC + gq * se + c);
            const float2 e1 = ld_bf2(eC + (gq + 8) * se + c);
            ev[j][0] = e0.x; ev[j][1] = e0.y; ev[j][2] = e1.x; ev[j][3] = e1.y;
          }
        }
        float mu[2], rs[2];
        ln_stats(ev, E, mu, rs);
        const float mu0 = mu[0], mu1 = mu[1], rs0 = rs[0], rs1 = rs[1];
#pragma unroll
        for (int j = 0; j < NTE; ++j) {
          if (j < EK / 8) {
            const int c = 8 * j + 2 * tq;
            st_bf2(xW + gq * se + c, vg1[c] * ((ev[j][0] - mu0) * rs0) + vb1[c],
                   vg1[c + 1] * ((ev[j][1] - mu0) * rs0) + vb1[c + 1]);
            st_bf2(xW + (gq + 8) * se + c,
                   vg1[c] * ((ev[j][2] - mu1) * rs1) + vb1[c],
                   vg1[c + 1] * ((ev[j][3] - mu1) * rs1) + vb1[c + 1]);
          }
        }
      }
      __syncwarp();

      // ---- [gates | bias] = LN(e) . [Wg | Wb] + [bg | bb] -> projW (f32)
      for (int n0 = 0; n0 < NP; n0 += 16) {
        float c[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < NKE; ++ks) {
          if (ks < EK / 16) {
            uint32_t a[4], b[4];
            lda(a, xW, se, 0, 16 * ks);
            ldb_kn(b, Wgb, sn, 16 * ks, n0);
            mma16816(c[0], a, b[0], b[1]);
            mma16816(c[1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int n = n0 + 8 * jj + 2 * tq + (qq & 1);
            projW[(gq + ((qq >> 1) << 3)) * NP + n] = c[jj][qq] + vbp[n];
          }
      }
      __syncwarp();

      // ---- per (pair, head): q.k, clip, h_hat, logits, gates (unrolled:
      // the loads of k go out together)
#pragma unroll 4
      for (int it = lane; it < 16 * h; it += 32) {
        const int r = it / h, k = it - r * h;
        if (r >= nv) { hhW[r * sh + k] = zero; continue; }
        const long long P = P0 + r;
        const int loc = (int)(P - (long long)row0 * l);   // pair in the group
        const int rg = loc / l, j = loc - rg * l, row = row0 + rg;
        const int b = row / l, i = row - b * l;
        const bf* kr = QKV + ((size_t)b * l + j) * 3 * dh + dh;
        const float* qr = q_s + rg * dh;
        float s = 0.f;
        for (int dd = k; dd < dh; dd += h) s = fmaf(qr[dd], __bfloat162float(kr[dd]), s);
        s *= p.scale;
        if (p.has_clip) s = fminf(fmaxf(s, p.lo), p.hi);
        const float hv = s + act_fn(p.edge_act, p.edge_alpha,
                                    projW[r * NP + nproj - h + k]);
        hhW[r * sh + k] = __float2bfloat16_rn(hv);
        if (HO) HO[P * h + k] = __float2bfloat16_rn(hv);
        float madd = (p.mask[(size_t)b * l + j] - 1.f) * 1e9f;
        if (p.amask) madd += (p.amask[P] - 1.f) * 1e9f;
        const float rm = p.dr.mask_add(b, i, j, k);
        const int o = (rg * l + j) * h + k;
        lm_s[o] = hv + madd + rm;
        if (p.gated) sg_s[o] = sigmoid(projW[r * NP + k] + madd + rm);
      }
      __syncwarp();

      // ---- the tail (edge_tail_mma.cuh): e_out staged in eC
      tail_fwd_mma<NTE>(TW, eC, hhW, sh, xW, [&](float x) {
        return act_fn(p.act, p.act_alpha, x);
      });
      store_rows16(EO + P0 * E, eC, se, nv, E);
      __syncwarp();      // eC is free for the prefetch two tiles on
    }
    __syncthreads();     // the group's logits and gates are in

    // ---- softmax over keys per (row, head), times the gate: one (row,
    // head) a group of G lanes, 8 for rows of up to 64 keys (four a warp),
    // else the whole warp; every lane of a warp runs the same rounds
    {
      const int G = l <= 64 ? 8 : 32, per = 32 / G, gl = lane % G;
      for (int base = warp * per; base < nr * h; base += nw * per) {
        const int it = base + lane / G;
        const bool ok = it < nr * h;
        const int lj = ok ? l : 0;               // keys this lane's group takes
        const int rg = ok ? it / h : 0, k = ok ? it - rg * h : 0;
        const int row = row0 + rg, b = row / l, i = row - b * l;
        float* lmr = lm_s + rg * l * h + k;
        const float* sgr = sg_s + rg * l * h + k;
        float mx = -INFINITY;
        for (int j = gl; j < lj; j += G) mx = fmaxf(mx, lmr[j * h]);
        for (int o = G / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float s = 0.f;
        for (int j = gl; j < lj; j += G) {
          const float ex = expf(lmr[j * h] - mx);
          lmr[j * h] = ex;
          s += ex;
        }
        for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float den = fmaxf(s, 1e-30f);
        for (int j = gl; j < lj; j += G) {
          float a = lmr[j * h] / den;
          if (p.gated) a *= sgr[j * h];
          if (dropping) a = p.dr.kept(b, i, j, k) ? a / p.dr.keep : 0.f;
          lmr[j * h] = rnd<bf>(a);
        }
      }
    }
    __syncthreads();

    // ---- v_att_i = sum_j A_ij v_j
    for (int t = tid; t < nr * dh; t += blockDim.x) {
      const int rg = t / dh, f = t - rg * dh;
      const int row = row0 + rg, b = row / l;
      const bf* vb = QKV + (size_t)b * l * 3 * dh + 2 * dh + f;
      const float* ar = lm_s + rg * l * h + f % h;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < l; ++j)       // unrolled: the loads go out together
        acc = fmaf(ar[j * h], __bfloat162float(vb[(size_t)j * 3 * dh]), acc);
      VA[(size_t)row * dh + f] = __float2bfloat16_rn(acc);
    }
  }
  cp_async_wait<0>();
}

template <int NTE>
int launch_mma(const Params& p, cudaStream_t stream) {
  int R, nw;
  group_shape(p.l, R, nw);
  const MmaLayout L(p.l, p.ew, p.h, p.dh, p.hid, p.gated, R, nw);
  auto kern = fused_layer_fwd_mma_kernel<NTE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, nw * 32,
                                                      L.bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = ((long long)p.B * p.l + R - 1) / R;
  const long long cap = (long long)sms * per_sm;
  kern<<<(unsigned)(groups < cap ? groups : cap), nw * 32, L.bytes, stream>>>(p, R);
  return (int)cudaGetLastError();
}

// f32: the CUDA-core body (exact f32 products)
template <typename T>
int launch_simt(const Params& p, cudaStream_t stream) {
  const Layout L(p.l, p.ew, p.h, p.dh, p.hid);
  const size_t smem = (size_t)L.nf * sizeof(float) + (size_t)L.nw * sizeof(T);
  auto kern = fused_layer_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long rows = (long long)p.B * p.l;
  const long long grid = rows < (long long)sms * per_sm ? rows : (long long)sms * per_sm;
  kern<<<(unsigned)grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.ew > 128) return (int)cudaErrorInvalidValue;
    return p.ew <= 64 ? launch_mma<8>(p, stream) : launch_mma<16>(p, stream);
  } else {
    return launch_simt<T>(p, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Weight matrices (wg, wb: (ew, h);
// wr: (h, ew); w1: (ew, hid); w2: (hid, ew)) are in the working type;
// biases and LN parameters are f32. amask, hhout (inference) and (when not
// gated) wg / bg may be null. Activation codes: 0 identity, 1 elu, 2 relu,
// 3 leaky relu. mask_p / drop_p 0 switch the draws off (inference).
// Returns cudaGetLastError() after the launch.
extern "C" int fused_layer_fwd(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, void* eout,
    void* vatt, void* hhout, int B, int l, int ew, int h, int dh, int hid,
    int gated, int has_clip, float lo, float hi, float scale, int edge_act,
    float edge_alpha, int act, float act_alpha, unsigned seed_lo,
    unsigned seed_hi, float mask_p, float drop_p, float keep, void* stream) {
  Params p{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, wr, br, g2, b2,
           w1, bb1, w2, bb2, eout, vatt, hhout, B, l, ew, h, dh, hid, gated,
           has_clip, lo, hi, scale, edge_act, act, edge_alpha, act_alpha,
           Draws{seed_lo, seed_hi, mask_p, drop_p, keep}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
