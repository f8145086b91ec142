// Whole EGT layer, backward of the attention and the edge head (softmax,
// sigmoid gate, dropout and clip; dense_edge_b / attention_gates / edge
// LayerNorm), for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_attn_kernel, called
// through _fused_layer_bwd_call_split (the second of the two split-backward
// kernels, after fused_layer_bwd_tail.cu).
//
// For every query row (b, i) and key j, head hd (feature f = dd * h + hd):
//   x1 = LN(e) normalised, e_ln = rnd(g1 x1 + b1)
//   G = e_ln . Wg + bg,  P = e_ln . Wb + bb,  E = act_e(P)          (recomputed)
//   softmax chain re-entered at the SAVED h_hat hh (q.k is not recomputed):
//     logits = hh + madd (+ aadd) (+ rmask),  gates = G + madd (+ aadd) (+ rmask)
//     a_sm = softmax_j(logits),  sg = sigmoid(gates),  a = a_sm sg
//     a_drop = kept ? a / keep : 0          (draws regenerated: philox.cuh)
//   da = (gv_i . v_j per head), then / keep where kept, 0 where dropped
//   da_sm = da sg,  dgate = da a_sm sg (1 - sg)
//   dH = a_sm (da_sm - sum_j da_sm a_sm) + dhh      (dhh from the tail kernel)
//   ds = (lo < hh - E < hi) ? dH * scale : 0       (the clip's in-range test,
//                                                    strict, on the saved hh)
//   dq_i = sum_j rnd(ds) k_j;  dk_j += rnd(ds) q_i;  dv_j += rnd(a_drop) gv_i
//   dP = dH act_e'(P);  de_ln = rnd(dP) . Wb^T + rnd(dgate) . Wg^T
//   de = LN backward of de_ln + de_mid
// and the weight gradients dWg = e_ln^T rnd(dgate), dbg = sum dgate,
// dWb = e_ln^T rnd(dP), dbb = sum dP, dg1 = sum de_ln x1, db1 = sum de_ln.
// de and dq are written in the working type; dk, dv and the weight
// gradients are f32.
//
// What bounds it on an H100: at the ZINC-500k training shape (b 128, l 40,
// ew 64, h 8, dh 64, bf16) it moves ~60 MB (e, de_mid and de; hh and dhh),
// ~18 us at 3.35 TB/s, against ~1 GFLOP of products: bytes bound it.
//
// Design: dk and dv are sums over the query rows of a graph, and the weight
// gradients sums over every pair; the TPU kernel carried both across its
// in-order grid in VMEM. Here one block takes one whole graph and loops over
// its query rows: dk and dv sit in shared memory (l x dh f32 each) and are
// written once; the weight-gradient sums are kept per block and written as
// one partial row, which a second small kernel sums in a fixed order. No
// float atomics, so a rerun is bit-identical. A query row's whole key row
// (l edge rows, l x h logits and gates) lives in shared memory between the
// softmax's forward and backward passes; the graph's k and v are cached in
// shared memory in f32.

#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace egt;

constexpr int NT = 256;

struct Params {
  const void* e; const void* qkv; const float* mask; const float* amask;
  const void* wg; const float* bg; const void* wb; const float* bb;
  const float* g1; const float* b1;
  const void* hh; const void* dhh; const void* demid; const void* gv;
  void* de; void* dq; float* dk; float* dv; float* partials;
  int B, l, ew, h, dh, gated, has_clip;
  float lo, hi, scale;
  int edge_act; float edge_alpha;
  Draws dr;
};

struct Layout {
  int dwgb, dbgb, dg1, db1, nw;                 // weight-gradient sums
  int vec, k, v, dk, dv, q, gv, x1, eln, rstd;  // float offsets
  int gpre, ppre, ev, hv, lm, sg, dasm, dgt, ds, dp, ad, madd, tsum, nf;
  int wgb, wgbT, nt;                            // T offsets
  __host__ __device__ Layout(int l, int ew, int h, int dh, int nproj) {
    int o = 0;
    dwgb = o; o += ew * nproj;    // [gates | bias] columns
    dbgb = o; o += nproj;
    dg1 = o;  o += ew;
    db1 = o;  o += ew;
    nw = o;
    vec = o;  o += nproj + 2 * ew;  // bgb g1 b1
    k = o;    o += l * dh;
    v = o;    o += l * dh;
    dk = o;   o += l * dh;
    dv = o;   o += l * dh;
    q = o;    o += dh;
    gv = o;   o += dh;
    x1 = o;   o += l * ew;
    eln = o;  o += l * ew;          // e_ln (rounded), later de_ln
    rstd = o; o += l;
    gpre = o; o += l * h;
    ppre = o; o += l * h;
    ev = o;   o += l * h;
    hv = o;   o += l * h;
    lm = o;   o += l * h;           // logits, then a_sm
    sg = o;   o += l * h;
    dasm = o; o += l * h;
    dgt = o;  o += l * h;
    ds = o;   o += l * h;
    dp = o;   o += l * h;
    ad = o;   o += l * h;
    madd = o; o += l;
    tsum = o; o += h;
    nf = (o + 3) & ~3;
    int w = 0;
    wgb = w;  w += ew * nproj;
    wgbT = w; w += nproj * ew;
    nt = w;
  }
  template <typename T> __host__ __device__ size_t bytes() const {
    return (size_t)nf * sizeof(float) + (size_t)nt * sizeof(T);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) bwd_attn_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int l = p.l, ew = p.ew, h = p.h, dh = p.dh;
  const int nproj = p.gated ? 2 * h : h;
  const Layout L(l, ew, h, dh, nproj);
  T* ws = reinterpret_cast<T*>(sm + L.nf);
  float *acc = sm, *dwgb = sm + L.dwgb, *dbgb = sm + L.dbgb;
  float *dg1 = sm + L.dg1, *db1 = sm + L.db1;
  float *bgb = sm + L.vec, *g1 = bgb + nproj, *b1 = g1 + ew;
  float *k_s = sm + L.k, *v_s = sm + L.v, *dk_s = sm + L.dk, *dv_s = sm + L.dv;
  float *q_s = sm + L.q, *gv_s = sm + L.gv, *x1 = sm + L.x1, *eln = sm + L.eln;
  float *rstd = sm + L.rstd, *gpre = sm + L.gpre, *ppre = sm + L.ppre;
  float *ev = sm + L.ev, *hv = sm + L.hv, *lm = sm + L.lm, *sg = sm + L.sg;
  float *dasm = sm + L.dasm, *dgt = sm + L.dgt, *ds = sm + L.ds;
  float *dp = sm + L.dp, *ad = sm + L.ad, *madd = sm + L.madd;
  float *tsum = sm + L.tsum;
  T *wgb = ws + L.wgb, *wgbT = ws + L.wgbT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const bool dropping = p.dr.dropping();

  // ---- weights, the graph's k / v and its key mask; zero the sums
  const T* Wg = (const T*)p.wg;
  const T* Wb = (const T*)p.wb;
  for (int t = tid; t < ew * nproj; t += NT) {
    const int c = t / nproj, n = t % nproj;
    const T w = (p.gated && n < h) ? Wg[c * h + n] : Wb[c * h + (n - (nproj - h))];
    wgb[t] = w;
    wgbT[n * ew + c] = w;
  }
  for (int t = tid; t < nproj; t += NT)
    bgb[t] = (p.gated && t < h) ? p.bg[t] : p.bb[t - (nproj - h)];
  for (int t = tid; t < ew; t += NT) { g1[t] = p.g1[t]; b1[t] = p.b1[t]; }
  const T* QKV = (const T*)p.qkv;
  for (int t = tid; t < l * dh; t += NT) {
    const int j = t / dh, f = t % dh;
    const T* r = QKV + ((size_t)b * l + j) * 3 * dh;
    k_s[t] = to_f(r[dh + f]);
    v_s[t] = to_f(r[2 * dh + f]);
    dk_s[t] = 0.f;
    dv_s[t] = 0.f;
  }
  for (int t = tid; t < l; t += NT) madd[t] = (p.mask[(size_t)b * l + t] - 1.f) * 1e9f;
  for (int t = tid; t < L.nw; t += NT) acc[t] = 0.f;

  const T* E = (const T*)p.e;
  const T* HH = (const T*)p.hh;
  const T* DHH = (const T*)p.dhh;
  const T* DM = (const T*)p.demid;
  const T* GV = (const T*)p.gv;
  T* DE = (T*)p.de;
  T* DQ = (T*)p.dq;

  for (int i = 0; i < l; ++i) {
    const size_t row = (size_t)b * l + i;
    const size_t ebase = row * l * ew;          // e[b, i, 0, 0]
    const size_t hbase = row * l * h;           // hh[b, i, 0, 0]
    const float* arow = p.amask ? p.amask + row * l : nullptr;
    __syncthreads();  // setup done; the previous row is done
    for (int t = tid; t < dh; t += NT) {
      q_s[t] = to_f(QKV[row * 3 * dh + t]);
      gv_s[t] = to_f(GV[row * dh + t]);
    }
    for (int t = tid; t < l * ew; t += NT) x1[t] = to_f(E[ebase + t]);
    __syncthreads();

    // ---- edge pre-LN, one warp per key: x1 normalised, e_ln rounded
    for (int j = warp; j < l; j += NT / 32) {
      float* x = x1 + j * ew;
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
        const float xv = (x[c] - mu) * rs;
        x[c] = xv;
        eln[j * ew + c] = rnd<T>(g1[c] * xv + b1[c]);
      }
      if (lane == 0) rstd[j] = rs;
    }
    __syncthreads();

    // ---- gates and edge-bias pre-activations
    tile_gemm<NT>(l, nproj, ew,
        [&](int m, int k) { return eln[m * ew + k]; },
        [&](int k, int n) { return to_f(wgb[k * nproj + n]); },
        [&](int m, int n, float y) {
          const float z = y + bgb[n];
          if (p.gated && n < h) gpre[m * h + n] = z;
          else ppre[m * h + (n - (nproj - h))] = z;
        });
    __syncthreads();

    // ---- re-enter the softmax chain at the saved h_hat
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      const float hval = to_f(HH[hbase + t]);
      const float Ev = act_fn(p.edge_act, p.edge_alpha, ppre[t]);
      ev[t] = Ev;
      hv[t] = hval;
      float add = madd[j];
      if (arow) add += (arow[j] - 1.f) * 1e9f;
      const float rm = p.dr.mask_add(b, i, j, hd);
      lm[t] = hval + add + rm;
      sg[t] = p.gated ? sigmoid(gpre[t] + add + rm) : 1.f;
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < l; j += 32) mx = fmaxf(mx, lm[j * h + hd]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < l; j += 32) {
        const float ex = expf(lm[j * h + hd] - mx);
        lm[j * h + hd] = ex;
        s += ex;
      }
      const float den = fmaxf(warp_sum(s), 1e-30f);
      for (int j = lane; j < l; j += 32) lm[j * h + hd] /= den;
    }
    __syncthreads();

    // ---- dropout and gate backward
    for (int t = tid; t < l * h; t += NT) {
      const int j = t / h, hd = t % h;
      float da = 0.f;
      for (int dd = hd; dd < dh; dd += h) da = fmaf(gv_s[dd], v_s[j * dh + dd], da);
      const float a_sm = lm[t], s = sg[t];
      float a = p.gated ? a_sm * s : a_sm;
      if (dropping) {
        const bool kp = p.dr.kept(b, i, j, hd);
        da = kp ? da / p.dr.keep : 0.f;
        a = kp ? a / p.dr.keep : 0.f;
      }
      ad[t] = rnd<T>(a);
      if (p.gated) {
        dasm[t] = da * s;
        dgt[t] = da * a_sm * s * (1.f - s);
      } else {
        dasm[t] = da;
        dgt[t] = 0.f;
      }
    }
    __syncthreads();
    for (int hd = warp; hd < h; hd += NT / 32) {
      float s = 0.f;
      for (int j = lane; j < l; j += 32) s += dasm[j * h + hd] * lm[j * h + hd];
      s = warp_sum(s);
      if (lane == 0) tsum[hd] = s;
    }
    __syncthreads();

    // ---- softmax and clip backward; edge-bias activation backward
    for (int t = tid; t < l * h; t += NT) {
      const int hd = t % h;
      const float dH = lm[t] * (dasm[t] - tsum[hd]) + to_f(DHH[hbase + t]);
      float d = dH * p.scale;
      if (p.has_clip) {
        const float sc = hv[t] - ev[t];
        if (!(sc > p.lo && sc < p.hi)) d = 0.f;
      }
      ds[t] = rnd<T>(d);
      dp[t] = dH * act_grad(p.edge_act, p.edge_alpha, ppre[t], ev[t]);
    }
    __syncthreads();

    // ---- dq, dk, dv
    for (int f = tid; f < dh; f += NT) {
      const int hd = f % h;
      float s = 0.f;
      for (int j = 0; j < l; ++j) s = fmaf(ds[j * h + hd], k_s[j * dh + f], s);
      DQ[row * dh + f] = from_f<T>(s);
    }
    for (int t = tid; t < l * dh; t += NT) {
      const int j = t / dh, f = t % dh, hd = f % h;
      dk_s[t] = fmaf(ds[j * h + hd], q_s[f], dk_s[t]);
      dv_s[t] = fmaf(ad[j * h + hd], gv_s[f], dv_s[t]);
    }

    // ---- head weight gradients: dW[gb] += e_ln^T rnd([dgate | dP]), db[gb]
    auto dcol = [&](int j, int n) {
      return (p.gated && n < h) ? dgt[j * h + n] : dp[j * h + (n - (nproj - h))];
    };
    tile_gemm<NT>(ew, nproj, l,
        [&](int m, int k) { return eln[k * ew + m]; },
        [&](int k, int n) { return rnd<T>(dcol(k, n)); },
        [&](int m, int n, float y) { dwgb[m * nproj + n] += y; });
    for (int n = tid; n < nproj; n += NT) {
      float s = 0.f;
      for (int j = 0; j < l; ++j) s += dcol(j, n);
      dbgb[n] += s;
    }
    __syncthreads();  // e_ln is read above; de_ln replaces it below

    // ---- de_ln = rnd([dgate | dP]) . [Wg | Wb]^T
    tile_gemm<NT>(l, ew, nproj,
        [&](int m, int k) { return rnd<T>(dcol(m, k)); },
        [&](int k, int n) { return to_f(wgbT[k * ew + n]); },
        [&](int m, int n, float y) { eln[m * ew + n] = y; });
    __syncthreads();
    for (int c = tid; c < ew; c += NT) {
      float s = 0.f, s2 = 0.f;
      for (int j = 0; j < l; ++j) {
        s += eln[j * ew + c] * x1[j * ew + c];
        s2 += eln[j * ew + c];
      }
      dg1[c] += s;
      db1[c] += s2;
    }
    // ---- edge LayerNorm backward + de_mid, one warp per key
    for (int j = warp; j < l; j += NT / 32) {
      const float* d = eln + j * ew;
      const float* xr = x1 + j * ew;
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        s += dx;
        s2 += dx * xr[c];
      }
      const float m1 = warp_sum(s) / ew, m2 = warp_sum(s2) / ew;
      const float rs = rstd[j];
      for (int c = lane; c < ew; c += 32) {
        const float dx = d[c] * g1[c];
        const size_t o = ebase + (size_t)j * ew + c;
        DE[o] = from_f<T>((dx - m1 - xr[c] * m2) * rs + to_f(DM[o]));
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < l * dh; t += NT) {
    p.dk[(size_t)b * l * dh + t] = dk_s[t];
    p.dv[(size_t)b * l * dh + t] = dv_s[t];
  }
  float* part = p.partials + (size_t)b * L.nw;
  for (int t = tid; t < L.nw; t += NT) part[t] = acc[t];
}

template <typename T>
int launch(const Params& p, float* dw, cudaStream_t stream) {
  const int nproj = p.gated ? 2 * p.h : p.h;
  const Layout L(p.l, p.ew, p.h, p.dh, nproj);
  const size_t smem = L.bytes<T>();
  auto kern = bwd_attn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)p.B, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(p.partials, p.B, L.nw, dw, stream);
}

}  // namespace

// Shared memory the kernel needs, in bytes (the wrapper checks it against
// the 227 KB a block may use).
extern "C" long long fused_layer_bwd_attn_smem(int dtype, int l, int ew, int h,
                                               int dh, int gated) {
  const Layout L(l, ew, h, dh, gated ? 2 * h : h);
  return dtype == 0 ? (long long)L.bytes<float>()
                    : (long long)L.bytes<__nv_bfloat16>();
}

// dtype: 0 = float32, 1 = bfloat16. e, de_mid, de (B, l, l, ew), hh, dhh
// (B, l, l, h), qkv (B, l, 3 dh), gv, dq (B, l, dh) and the weight matrices
// wg, wb (ew, h) are in the working type; mask (B, l), amask (B, l, l), the
// biases and LN parameters, dk, dv (B, l, dh) and dw are f32. amask and
// (ungated) wg / bg may be null. dw receives [dwgb (ew, nproj) | dbgb
// (nproj) | dg1 | db1], nproj = 2h gated ([gates | bias] columns) else h;
// `partials` is f32 scratch of B rows of that length. Launches the kernel
// (one block per graph) and the partial-sum pass; returns
// cudaGetLastError().
extern "C" int fused_layer_bwd_attn(
    int dtype, const void* e, const void* qkv, const float* mask,
    const float* amask, const void* wg, const float* bg, const void* wb,
    const float* bb, const float* g1, const float* b1, const void* hh,
    const void* dhh, const void* demid, const void* gv, void* de, void* dq,
    float* dk, float* dv, float* dw, float* partials, int B, int l, int ew,
    int h, int dh, int gated, int has_clip, float lo, float hi, float scale,
    int edge_act, float edge_alpha, unsigned seed_lo, unsigned seed_hi,
    float mask_p, float drop_p, float keep, void* stream) {
  Params p{e, qkv, mask, amask, wg, bg, wb, bb, g1, b1, hh, dhh, demid, gv,
           de, dq, dk, dv, partials, B, l, ew, h, dh, gated, has_clip, lo,
           hi, scale, edge_act, edge_alpha,
           Draws{seed_lo, seed_hi, mask_p, drop_p, keep}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, dw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, dw, s);
  return (int)cudaErrorInvalidValue;
}
