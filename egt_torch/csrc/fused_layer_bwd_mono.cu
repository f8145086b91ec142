// Whole EGT layer, backward with nothing saved but the inputs ("mono", K6),
// for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_kernel, called through
// _fused_layer_bwd_call (_BWD_IMPL "mono").
//
// What it computes: the merged backward (fused_layer_bwd_merged.cu, K7)
// with h_hat recomputed from the inputs as the forward computes it, and the
// clip's in-range test on the raw logit. For every pair (b, i, j) and head
// hd (feature f = dd * h + hd):
//   x1 = LN(e) normalised (eps 1e-3),  e_ln = rnd(g1 x1 + b1)
//   P = e_ln . Wb + bb,  E = act_e(P)
//   s = q_i . k_j scale (f32),  hh = clip(s) + E (f32)
//   in range: lo < s < hi, strict, on the raw logit (the TPU kernel's test)
// then K7's two halves: the edge tail's backward from rnd(hh) (de_mid and
// dhh in f32, the eight tail weight gradients), and the attention and
// edge-head backward with the softmax chain re-entered at the f32 hh and
// the clip's test read from the in-range flags (de, dq, dk, dv and the six
// head weight gradients). The rounding points are those of the plain
// fused_layer_bwd_mono_plain: mono_head_plain, then K4's and K5's math.
//
// Design: three launches on the caller's stream, K7's composition behind a
// small kernel. mono_head_kernel recomputes h_hat and writes hh in f32,
// rnd(hh) in bf16 (in f32 the f32 hh is rnd(hh)) and one flag byte a (pair,
// head) (none without a clip). A block takes 32 consecutive pairs: it stages
// their e rows (16-byte loads) and Wb transposed in shared memory in f32,
// runs LN1 eight lanes a pair, then one thread a (pair, head) for P (16-byte
// reads of a row of e_ln and of Wb^T) and q.k (q and k through L1), and
// writes with consecutive threads on consecutive addresses. Then K4's tail
// body reads rnd(hh) and writes de_mid and dhh in f32 into scratch, as in
// K7 (tail_bwd.cuh: the tensor-core body in bf16 where it fits, else the
// CUDA-core body), and K5's body runs under the mono switch (attn_bwd.cuh:
// hh and the flags read in f32 and bytes at K7's layout, kv_global where k,
// v, dk and dv do not fit in shared memory). Each backward launch ends with
// its fixed-order sum of partial rows, tail sums then head sums: no float
// atomics, so a rerun is bit-identical, and in f32 K6 equals the head
// kernel, then K4, then K5 under the switch, bit for bit.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, dh 64, hidden 128, bf16) the function itself moves ~85 MB (e,
// g_eout, qkv and gv in; de, dq, dk and dv out) against ~19 GFLOP of
// products. The composition moves ~279 MB: K7's ~235 MB, the head kernel's
// ~39 MB (e, q and k in; hh, rnd(hh) and the flags out) and ~5 MB more in
// K5's body (hh in f32, the flags), 0.083 ms at 3.35 TB/s. The head kernel
// does ~0.24 GFLOP on the CUDA cores: its bytes bound it (~12 us); by
// ablation its LN1, P and q.k phases, each a chain of dependent shared-
// memory or L1 reads, hold it above that. The two bodies are
// latency-bound at one block a SM, as in K7.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; egt_torch/kernel_times.py, L2
// flushed, draws live, in turns with the one-block-a-graph row kernel it
// replaces): bf16 0.874-0.876 ms at the training shape above, against
// 7.104-7.106 ms; f32 4.237-4.244 ms against 8.063-8.066; the head kernel
// alone 0.069 ms (f32 0.074). In an A-mono training step
// (`EGT_FUSED_BWD=mono python3 -m egt_torch.profile_training --path A`)
// the head takes 0.065 ms a call, K4's body 0.439 and K5's 0.343.

#include "attn_bwd.cuh"
#include "tail_bwd.cuh"

namespace {

using namespace egt;

constexpr int HEAD_NT = 256;   // threads a block
constexpr int HEAD_TP = 32;    // pairs a block

struct HeadParams {
  const void* e; const void* qkv; const void* wb; const float* bb;
  const float* g1; const float* b1;
  float* hh32; void* hhw; unsigned char* inrange;
  long long pairs; int l, ew, h, dh, has_clip;
  float lo, hi, scale;
  int edge_act; float edge_alpha;
};

// The head kernel's shared memory, f32: the block's rows of e, then
// rnd(e_ln) (HEAD_TP rows), and Wb transposed (h rows), each row ew
// rounded up to 4 and zero-padded, at a stride s with s / 4 odd, so the
// 16-byte reads of up to 8 rows at one column fall in distinct banks
struct HeadLayout {
  int ew4, s, w, n;
  __host__ __device__ HeadLayout(int ew, int h) {
    ew4 = (ew + 3) & ~3;
    s = (ew4 / 4) % 2 ? ew4 : ew4 + 4;
    w = HEAD_TP * s;
    n = w + h * s;
  }
  __host__ __device__ size_t bytes() const { return (size_t)n * 4; }
};

// Sum over the eight lanes of a group (lanes 8k .. 8k + 7)
__device__ __forceinline__ float group8_sum(float v) {
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static_assert(HEAD_TP * 8 == HEAD_NT, "LN1 takes eight lanes a pair");

template <typename T>
__global__ void __launch_bounds__(HEAD_NT) mono_head_kernel(HeadParams p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ew = p.ew, h = p.h, l = p.l, dh = p.dh;
  const HeadLayout L(ew, h);
  const int s = L.s, ew4 = L.ew4;
  float *x = sm, *wt = sm + L.w;          // e -> rnd(e_ln); Wb^T
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * HEAD_TP;
  const int np = (int)min((long long)HEAD_TP, p.pairs - p0);
  const T* E = (const T*)p.e + p0 * ew;
  const T* Wb = (const T*)p.wb;

  // ---- Wb transposed and the block's e rows, zero past ew; 16 bytes a
  // load of e where a row is whole loads
  for (int t = tid; t < ew4 * h; t += HEAD_NT) {
    const int c = t / h, hd = t - c * h;
    wt[hd * s + c] = c < ew ? to_f(Wb[t]) : 0.f;
  }
  constexpr int V = 16 / sizeof(T);
  if (ew % V == 0) {
    const int vpr = ew / V;
    for (int t = tid; t < np * vpr; t += HEAD_NT) {
      const int m = t / vpr, c = (t - m * vpr) * V;
      const uint4 u = *reinterpret_cast<const uint4*>(E + (size_t)m * ew + c);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) x[m * s + c + k] = to_f(v[k]);
    }
  } else {
    for (int t = tid; t < np * ew; t += HEAD_NT) {
      const int m = t / ew;
      x[m * s + t - m * ew] = to_f(E[t]);
    }
  }
  for (int t = tid; t < np * (ew4 - ew); t += HEAD_NT) {
    const int m = t / (ew4 - ew);
    x[m * s + ew + t - m * (ew4 - ew)] = 0.f;
  }
  __syncthreads();

  // ---- LN1, eight lanes a pair, the block's pairs at once: e_ln =
  // rnd(g1 (e - mu) rstd + b1) (every lane takes part in the shuffles; a
  // row past np is computed and not written)
  {
    float* r = x + (tid >> 3) * s;
    const int g = tid & 7;
    float sum = 0.f;
    for (int c = g; c < ew; c += 8) sum += r[c];
    const float mu = group8_sum(sum) / ew;
    float s2 = 0.f;
    for (int c = g; c < ew; c += 8) {
      const float d = r[c] - mu;
      s2 += d * d;
    }
    const float rs = rsqrtf(group8_sum(s2) / ew + LN_EPS);
    if ((tid >> 3) < np)
      for (int c = g; c < ew; c += 8)
        r[c] = rnd<T>(p.g1[c] * ((r[c] - mu) * rs) + p.b1[c]);
  }
  __syncthreads();

  // ---- one thread a (pair, head): P = rnd(e_ln) . Wb + bb (four columns
  // a step, summed in column order), E, s = q_i . k_j scale, h_hat and the
  // flag; consecutive threads write consecutive outputs
  const T* QKV = (const T*)p.qkv;
  for (int t = tid; t < np * h; t += HEAD_NT) {
    const int m = t / h, hd = t - m * h;
    const long long pr = p0 + m;               // ((b l) + i) l + j
    long long bi, bj;                          // b l + i, b l + j
    if (pr <= 0xffffffffLL) {   // 32-bit divisions (every shipped shape)
      const unsigned u = (unsigned)pr, lu = (unsigned)l, ui = u / lu;
      bi = ui;
      bj = ui - ui % lu + (u - ui * lu);
    } else {
      bi = pr / l;
      bj = bi - bi % l + (pr - bi * l);
    }
    const float4* r4 = reinterpret_cast<const float4*>(x + m * s);
    const float4* w4 = reinterpret_cast<const float4*>(wt + hd * s);
    float P = 0.f;
    for (int c = 0; c < ew4 / 4; ++c) {
      const float4 a = r4[c], w = w4[c];
      P = fmaf(a.x, w.x, P);
      P = fmaf(a.y, w.y, P);
      P = fmaf(a.z, w.z, P);
      P = fmaf(a.w, w.w, P);
    }
    P += p.bb[hd];
    const float Ev = act_fn(p.edge_act, p.edge_alpha, P);
    const T* q = QKV + bi * 3 * dh;
    const T* k = QKV + bj * 3 * dh + dh;
    float sc = 0.f;
#pragma unroll 8
    for (int f = hd; f < dh; f += h) sc = fmaf(to_f(q[f]), to_f(k[f]), sc);
    sc *= p.scale;
    float c = sc;
    const long long o = pr * h + hd;
    if (p.has_clip) {
      c = fminf(fmaxf(sc, p.lo), p.hi);
      p.inrange[o] = (sc > p.lo && sc < p.hi) ? 1 : 0;
    }
    const float hv = c + Ev;
    p.hh32[o] = hv;
    if constexpr (!std::is_same<T, float>::value)
      reinterpret_cast<T*>(p.hhw)[o] = from_f<T>(hv);
  }
}

template <typename T>
int head_launch(const HeadParams& p, cudaStream_t stream) {
  const size_t smem = HeadLayout(p.ew, p.h).bytes();
  auto kern = mono_head_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.pairs + HEAD_TP - 1) / HEAD_TP;
  kern<<<(unsigned)blocks, HEAD_NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int head_entry(int dtype, const HeadParams& p, cudaStream_t stream) {
  if (dtype == 0) return head_launch<float>(p, stream);
  if (dtype == 1) return head_launch<__nv_bfloat16>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The head kernel alone (K6's first launch). dtype: 0 = float32, 1 =
// bfloat16. e (B, l, l, ew), qkv (B, l, 3 dh) and wb (ew, h) are in the
// working type; bb, g1, b1 are f32. Writes hh32 (B, l, l, h) f32, hhw (the
// same shape, bf16 only; null in f32) = rnd(hh32), and, with a clip, the
// in-range flags (B, l, l, h), one byte each (null without a clip).
// Returns cudaGetLastError().
extern "C" int fused_layer_bwd_mono_head(
    int dtype, const void* e, const void* qkv, const void* wb,
    const float* bb, const float* g1, const float* b1, float* hh32,
    void* hhw, unsigned char* inrange, int B, int l, int ew, int h, int dh,
    int has_clip, float lo, float hi, float scale, int edge_act,
    float edge_alpha, void* stream) {
  const HeadParams hp{e, qkv, wb, bb, g1, b1, hh32, hhw, inrange,
                      (long long)B * l * l, l, ew, h, dh, has_clip, lo, hi,
                      scale, edge_act, edge_alpha};
  return head_entry(dtype, hp, (cudaStream_t)stream);
}

// dtype: 0 = float32, 1 = bfloat16. e, g_eout, de (B, l, l, ew), qkv
// (B, l, 3 dh), gv, dq (B, l, dh) and the weight matrices (wg, wb (ew, h),
// wr (h, ew), w1 (ew, hid), w2 (hid, ew)) are in the working type; mask
// (B, l), amask (B, l, l; may be null), the biases and LN parameters, dk,
// dv (B, l, dh), dw and the scratch are f32; ungated, wg and bg are null.
// Scratch: hh32 (B, l, l, h) f32, hhw of that shape in bf16 (null in f32),
// inrange of that shape in bytes (null without a clip), demid (B, l, l, ew)
// and dhh (B, l, l, h) f32 for the hand-off, and `partials`, f32 of
// max(max_grid rows of the tail's sums, B rows of the head's). dw receives
// the tail's sums [dwr | dbr | dg2 | db2 | dw1 | dbb1 | dw2 | dbb2] then the
// head's [dwgb (ew, nproj) | dbgb (nproj) | dg1 | db1], nproj = 2h gated
// ([gates | bias] columns) else h. Returns cudaGetLastError() of the first
// launch that fails, else of the last.
extern "C" int fused_layer_bwd_mono(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* wr,
    const float* br, const float* g2, const float* b2, const void* w1,
    const float* bb1, const void* w2, const float* bb2, const void* geout,
    const void* gv, float* hh32, void* hhw, unsigned char* inrange,
    float* demid, float* dhh, void* de, void* dq, float* dk, float* dv,
    float* dw, float* partials, int max_grid, int B, int l, int ew, int h,
    int dh, int hid, int gated, int has_clip, float lo, float hi,
    float scale, int edge_act, float edge_alpha, int act, float act_alpha,
    unsigned seed_lo, unsigned seed_hi, float mask_p, float drop_p,
    float keep, void* stream) {
  const long long pairs = (long long)B * l * l;
  const unsigned char* flags = has_clip ? inrange : nullptr;
  const HeadParams hp{e, qkv, wb, bb, g1, b1, hh32, hhw, inrange, pairs, l,
                      ew, h, dh, has_clip, lo, hi, scale, edge_act,
                      edge_alpha};
  // K4's body reads rnd(hh): bf16 hhw, or in f32 the f32 hh itself
  egt::TailParams tp{e, dtype == 1 ? (const void*)hhw : (const void*)hh32,
                     geout, wr, br, g2, b2, w1, bb1, w2, bb2, demid, dhh,
                     partials, pairs, ew, h, hid, 0, act, act_alpha, 0};
  egt::AttnParams ap{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, hh32, dhh,
                     demid, gv, de, dq, dk, dv, partials, B, l, ew, h, dh,
                     gated, has_clip, lo, hi, scale, edge_act, edge_alpha,
                     Draws{seed_lo, seed_hi, mask_p, drop_p, keep}, flags};
  float* dw_head = dw + egt::TailAcc(ew, h, hid).n;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = head_entry(dtype, hp, s);
  if (rc) return rc;
  if (dtype == 0) {
    rc = egt::tail_bwd_launch<float>(tp, dw, max_grid, s);
    return rc ? rc : egt::launch_simt<true>(ap, dw_head, s);
  }
  rc = egt::tail_bwd_launch<__nv_bfloat16, float>(tp, dw, max_grid, s);
  return rc ? rc : egt::launch_bf16<float, true>(ap, dw_head, s);
}
