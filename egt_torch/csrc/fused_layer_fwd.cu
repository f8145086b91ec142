// Whole EGT layer edge core, forward (inference), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_fwd_kernel, called through
// _fused_layer_fwd_call / fused_layer_apply.
//
// For each query row (b, i) and every key j, with e (b, l, l, ew) and the
// node projections qkv (b, l, 3 * dh) (dh = d * h, feature f = dd * h + hh):
//   x      = LN(e[b, i, j, :])                       (eps 1e-3)
//   G      = x . Wg + bg,  E = act_e(x . Wb + bb)    (ew -> h)
//   h_hat  = clip(q_i . k_j * d^-1/2) + E            (per head)
//   A      = softmax_j(h_hat + madd_j [+ aadd_ij]) * sigmoid(G + madd_j [+ aadd_ij])
//   v_att_i = sum_j A_ij v_j                          (written, (b, l, dh))
//   e_mid  = h_hat . Wr + br + e[b, i, j, :]          (h -> ew)
//   e_out  = act(LN(e_mid) . W1 + b1) . W2 + b2 + e_mid   (written)
// Math is f32; e, qkv, the weight matrices, e_out and v_att are in the
// working type (f32 or bf16), rounded where the JAX kernel rounds: the LN
// outputs, h_hat before Wr, A before A.V, and the FFN hidden activations.
//
// What bounds it on an H100: at the ZINC-500k serving shape (b 128, l 40,
// ew 64, h 8, hidden 128, bf16) it must move ~55 MB (e in, e_out out, qkv,
// v_att), 16 us at 3.35 TB/s, and do ~7.4 GFLOP, 7.5 us at the bf16
// tensor-core peak: bytes bound it. This first kernel does its products on
// the f32 CUDA cores (67 TFLOP/s peak), so the FLOPs of the 64 -> 128 -> 64
// edge FFN (>90% of the work) set its time instead.
//
// Design: a persistent grid, sized by the occupancy API, walks the b * l
// query rows; each block loads every weight once into shared memory
// (~36 KB in bf16 at ew 64) and keeps it for all its rows. Per row, keys are
// taken in chunks of TJ pairs so shared memory does not grow with l except
// for the (l, h) logits/gates/h_hat rows the softmax needs. The small
// products run as register-tiled 4 x 4 shared-memory GEMMs. e is read once
// per phase (the second read, for the residual, hits L2) and e_out and
// v_att are written once; no per-pair intermediate goes to device memory.
// wgmma tiles for the edge FFN and TMA loads of e are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TJ = 32;   // keys per chunk (a multiple of 4)
constexpr float LN_EPS = 1e-3f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 0 identity, 1 elu, 2 relu, 3 leaky relu (alpha)
__device__ __forceinline__ float act_fn(int kind, float alpha, float x) {
  switch (kind) {
    case 1: return x > 0.f ? x : expm1f(x);
    case 2: return fmaxf(x, 0.f);
    case 3: return x > 0.f ? x : alpha * x;
    default: return x;
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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
  void* eout; void* vatt;
  int B, l, ew, h, dh, hid, gated, has_clip;
  float lo, hi, scale;
  int edge_act, act;
  float edge_alpha, act_alpha;
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
  const int rows = p.B * l;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / l;
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
        const float madd = (mrow[j] - 1.f) * 1e9f;
        float lg = hv + madd;
        if (arow) lg += (arow[j] - 1.f) * 1e9f;
        lm_s[j * h + hh] = lg;
        if (p.gated) {
          float gm = gpre[t] + madd;
          if (arow) gm += (arow[j] - 1.f) * 1e9f;
          sg_s[j * h + hh] = sigmoid(gm);
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

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Weight matrices (wg, wb: (ew, h);
// wr: (h, ew); w1: (ew, hid); w2: (hid, ew)) are in the working type;
// biases and LN parameters are f32. amask and (when not gated) wg / bg may
// be null. Activation codes: 0 identity, 1 elu, 2 relu, 3 leaky relu.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_layer_fwd(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, void* eout,
    void* vatt, int B, int l, int ew, int h, int dh, int hid, int gated,
    int has_clip, float lo, float hi, float scale, int edge_act,
    float edge_alpha, int act, float act_alpha, void* stream) {
  Params p{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, wr, br, g2, b2,
           w1, bb1, w2, bb2, eout, vatt, B, l, ew, h, dh, hid, gated,
           has_clip, lo, hi, scale, edge_act, act, edge_alpha, act_alpha};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
