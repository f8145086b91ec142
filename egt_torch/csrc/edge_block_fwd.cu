// Fused edge block of one EGT layer, forward, for sm_90a.
//
// Replaces: egt_tpu/ops/edge_block_pallas.py::_fwd_kernel, called through
// _rows_fwd / fused_edge_block / edge_block_apply.
//
// Over the flattened pairs p = (b, i, j), with h_hat hh (h) and the edge
// residual e_res (ew) in the working type:
//   e_mid = rnd(hh) . Wr + br + e_res
//   out   = ELU(rnd(LN(e_mid) g2 + b2) . W1 + b1) . W2 + b2' + e_mid
// (LN eps 1e-3; the hidden activation rounded to the working type before
// W2; math in f32; out written in the working type). The activation is ELU
// whatever the model's activation is, as in the TPU kernel.
//
// What bounds it on an H100: at the ZINC-500k shape (204,800 pairs, ew 64,
// h 8, hidden 128, bf16) it moves ~56 MB (hh and e_res in, out), ~17 us at
// 3.35 TB/s, against ~7 GFLOP of products, ~7 us at the bf16 tensor-core
// peak: bytes bound it. Two bodies; the C launcher picks one from the
// shape before the launch (edge_block_fwd_geometry says which):
//
// The bf16 body (edge_block_fwd_mma_kernel, ew <= 128, within 227 KB of
// shared memory) runs the products on the tensor cores: K3's tail chain,
// edge_tail_mma.cuh's tail_fwd_mma, on one warp's tile of 16 consecutive
// pairs. A persistent grid, sized by the occupancy API; each block stages
// Wr, W1 and W2 zero-padded once, and warp w of block k takes tiles
// k nw + w, then every gridDim nw-th, with no block barrier after the
// weights. e and hh are staged with cp.async one tile ahead into two
// buffers a warp: e_res read once, out written once from the staged
// e_out. hh goes from device memory straight into the warp's buffer, as
// pair rows (16-byte copies when h is a multiple of 8) or, from a view of
// the attention kernel's head-major (b, h, l, l) h_hat, as head rows of
// the tile's 16 pairs (two 16-byte copies a head where the pairs lie in
// one graph at a 16-byte boundary, else element loads), which the chain's
// first product reads transposed: h_hat is never copied or transposed in
// device memory. The ELU takes exp from the SFU (__expf) where K3 and the
// plain version take expm1: ~1e-7 apart, far below the bf16 rounding of
// the hidden units, and a fraction of expm1's instructions, which the
// body runs 64 times a lane a tile at hidden 128.
//
// The CUDA-core body (edge_block_fwd_kernel: f32, exact f32 products, and
// bf16 past ew 128 or 227 KB) runs edge_tail.cuh's tail_fwd_tile and
// tile_gemm on the f32 CUDA cores (67 TFLOP/s), where the products set its
// time. A persistent grid walks tiles of TP consecutive pairs; each block
// loads the weights once into shared memory (rows padded so no read has
// bank conflicts) and keeps them for all its tiles. Per tile the pairs go
// through the whole chain in shared memory: hh and e_res are read once and
// out is written once; hh may be a head-major view, read in place.

#include <stdint.h>

#include "edge_tail.cuh"
#include "edge_tail_mma.cuh"

namespace {

using namespace egt;

constexpr int NT = 256;
constexpr int TP = 32;
constexpr int MMA_WARPS = 8;
constexpr size_t OPTIN = 227 * 1024;   // shared memory a block may opt into

struct Params {
  const void* hh; const void* e;
  const void* wr; const float* br; const float* g2; const float* b2;
  const void* w1; const float* bb1; const void* w2; const float* bb2;
  void* out;
  long long pairs; int ew, h, hid, hh_l;
  int vec;   // bf16 body: 1 e and out, 2 hh take 16-byte copies
};

template <typename T> size_t smem_bytes(int ew, int h, int hid) {
  const TailW<T> W(h, ew, hid);
  const int nf = W.nf() + TailTile::floats(TP, ew, h, hid);
  return (size_t)((nf + 3) & ~3) * sizeof(float) + (size_t)W.nt() * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NT) edge_block_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ew = p.ew, h = p.h, hid = p.hid;
  TailW<T> W(h, ew, hid);
  const int nf = W.nf() + TailTile::floats(TP, ew, h, hid);
  W.carve(sm, reinterpret_cast<T*>(sm + ((nf + 3) & ~3)));
  TailTile s;
  s.carve(sm + W.nf(), TP, ew, h, hid);
  W.load((const T*)p.wr, p.br, p.g2, p.b2, (const T*)p.w1, p.bb1,
         (const T*)p.w2, p.bb2);

  const T* E = (const T*)p.e;
  T* OUT = (T*)p.out;
  const long long ntiles = (p.pairs + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * TP;
    const int np = (int)min((long long)TP, p.pairs - p0);
    __syncthreads();  // weights loaded; the previous tile is done
    load_hh<NT>((const T*)p.hh, p0, np, h, p.hh_l, s.hh);
    for (int t = threadIdx.x; t < np * ew; t += NT)
      s.em[t] = to_f(E[p0 * ew + t]);
    __syncthreads();
    tail_fwd_tile<NT, T>(W, s, np, /*elu*/ 1, 0.f);
    // out = rnd(hid) . W2 + b2' + e_mid
    tile_gemm<NT>(np, ew, hid,
        [&](int m, int k) { return rnd<T>(s.hid[m * hid + k]); },
        [&](int k, int n) { return to_f(W.w2[k * W.s2 + n]); },
        [&](int m, int n, float y) {
          OUT[(p0 + m) * ew + n] = from_f<T>(y + W.bb2[n] + s.em[m * ew + n]);
        });
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes<T>(p.ew, p.h, p.hid);
  auto kern = edge_block_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (p.pairs + TP - 1) / TP;
  long long grid = (long long)sms * per_sm;
  if (grid > ntiles) grid = ntiles;
  kern<<<(unsigned)grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
// Shared memory of the tensor-core body: f32 br g2 b2 bb2 (EK each), bb1
// (UK); bf16 Wr (HK x EK), W1 (EK x UK), W2 (UK x EK), and per warp two e
// buffers (16 x EK), the LN(e_mid) scratch (16 x EK) and two hh buffers:
// 16 pair rows of HK, or (head-major) HK head rows of 16 pairs. Every row
// is padded by 8 elements, an odd number of 16-byte units, so the eight
// rows an ldmatrix reads fall in distinct banks.
struct MmaLayout {
  int EK, UK, HK, se, su, sh, hb, nf;
  int wr, w1, w2, e, x, hh, nb;       // bf16 offsets; nb in all
  size_t bytes;
  __host__ __device__ MmaLayout(int ew, int h, int hid, bool hm, int nw) {
    EK = round16(ew); UK = round16(hid); HK = round16(h);
    se = EK + 8; su = UK + 8;
    sh = hm ? 16 + 8 : HK + 8;
    hb = hm ? HK * sh : 16 * sh;
    nf = 4 * EK + UK;                  // a multiple of 16
    int b = 0;
    wr = b; b += HK * se;
    w1 = b; b += EK * su;
    w2 = b; b += UK * se;
    e = b;  b += nw * 2 * 16 * se;
    x = b;  b += nw * 16 * se;
    hh = b; b += nw * 2 * hb;
    nb = b;
    bytes = (size_t)nf * 4 + (size_t)b * 2;
  }
};

// Warps a block of the tensor-core body (the most up to MMA_WARPS that fit
// in OPTIN), or 0 where the CUDA-core body takes the shape.
int mma_warps(int dtype, int ew, int h, int hid, bool hm) {
  if (dtype != 1 || ew > 128) return 0;
  for (int nw = MMA_WARPS; nw >= 1; --nw)
    if (MmaLayout(ew, h, hid, hm, nw).bytes <= OPTIN) return nw;
  return 0;
}

// One warp stages rows r < 16 of a (rows, w) bf16 matrix at src into S (row
// stride ld), rows r >= nvalid zero: stage_rows16 where vec (16-byte
// cp.async copies when w is a multiple of 8), else element loads.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* S, int ld,
                                           const __nv_bfloat16* src,
                                           int nvalid, int w, bool vec) {
  if (vec) {
    stage_rows16(S, ld, src, nvalid, w);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < 16 * w; t += 32) {
    const int r = t / w, c = t - r * w;
    S[r * ld + c] = r < nvalid ? src[(size_t)r * w + c]
                               : __float2bfloat16_rn(0.f);
  }
}

// One warp writes rows r < nvalid of S to dst, (rows, w): store_rows16
// where vec, else element stores.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* S, int ld,
                                           int nvalid, int w, bool vec) {
  if (vec) {
    store_rows16(dst, S, ld, nvalid, w);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < nvalid * w; t += 32) {
    const int r = t / w, c = t - r * w;
    dst[(size_t)r * w + c] = S[r * ld + c];
  }
}

// One warp stages the hh of the tile of nv pairs from P0 into H (row
// stride sh). Rows (HM false): 16 pair rows of h heads, as stage_rows.
// Head-major (HM, hh a (b, h, l, l) tensor): head k's 16 pairs into row k,
// in two units of 8 pairs; a unit whose pairs are valid, consecutive in
// memory (one graph) and 16-byte aligned is one cp.async, any other is 8
// element loads (zeros past nv). Heads past h stay zero.
template <bool HM>
__device__ __forceinline__ void stage_hh(__nv_bfloat16* H, int sh,
                                         const __nv_bfloat16* HH,
                                         long long P0, int nv, int h, int l,
                                         bool vec) {
  if (!HM) {
    stage_rows(H, sh, HH + P0 * h, nv, h, vec);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < 2 * h; t += 32) {
    const int k = t >> 1, m0 = 8 * (t & 1);
    __nv_bfloat16* dst = H + k * sh + m0;
    const long long i0 = hh_index(P0 + m0, k, h, l);
    if (vec && m0 + 8 <= nv && (i0 & 7) == 0 &&
        hh_index(P0 + m0 + 7, k, h, l) == i0 + 7) {
      cp_async16(dst, HH + i0, true);
    } else {
      for (int r = 0; r < 8; ++r)
        dst[r] = m0 + r < nv ? HH[hh_index(P0 + m0 + r, k, h, l)]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

template <int NTE, bool HM>
__global__ void __launch_bounds__(MMA_WARPS * 32, 2)
    edge_block_fwd_mma_kernel(Params p) {
  using bf = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int E = p.ew, h = p.h, U = p.hid, nw = blockDim.x >> 5;
  const MmaLayout L(E, h, U, HM, nw);
  const int EK = L.EK, UK = L.UK, se = L.se, sh = L.sh, hb = L.hb;
  float *vbr = sm, *vg2 = vbr + EK, *vb2 = vg2 + EK, *vbb2 = vb2 + EK;
  float* vbb1 = vbb2 + EK;
  bf* bs = reinterpret_cast<bf*>(sm + L.nf);
  const int warp = threadIdx.x >> 5;
  bf* eW = bs + L.e + warp * 2 * 16 * se;
  bf* xW = bs + L.x + warp * 16 * se;
  bf* hW = bs + L.hh + warp * 2 * hb;

  // ---- weights (zero-padded) and vectors, once per block; staging zeroed
  zero_smem(bs, L.nb);
  for (int t = threadIdx.x; t < EK; t += blockDim.x) {
    const bool ok = t < E;
    vbr[t] = ok ? p.br[t] : 0.f; vg2[t] = ok ? p.g2[t] : 0.f;
    vb2[t] = ok ? p.b2[t] : 0.f; vbb2[t] = ok ? p.bb2[t] : 0.f;
  }
  for (int t = threadIdx.x; t < UK; t += blockDim.x)
    vbb1[t] = t < U ? p.bb1[t] : 0.f;
  __syncthreads();
  stage_matrix(bs + L.wr, se, (const bf*)p.wr, h, E);
  stage_matrix(bs + L.w1, L.su, (const bf*)p.w1, E, U);
  stage_matrix(bs + L.w2, se, (const bf*)p.w2, U, E);
  __syncthreads();
  const TailMmaW TW{bs + L.wr, bs + L.w1, bs + L.w2, vbr, vg2, vb2, vbb1,
                    vbb2, E, U, EK, UK, L.HK, se, L.su};

  const bf* HH = (const bf*)p.hh;
  const bf* EI = (const bf*)p.e;
  bf* OUT = (bf*)p.out;
  const bool vec_e = p.vec & 1, vec_h = p.vec & 2;
  const long long ntiles = (p.pairs + 15) / 16;
  const long long stride = (long long)gridDim.x * nw;
  auto stage = [&](long long tile, int buf) {
    const long long P0 = 16 * tile;
    const int nv = (int)min(16LL, p.pairs - P0);
    stage_rows(eW + buf * 16 * se, se, EI + P0 * E, nv, E, vec_e);
    stage_hh<HM>(hW + buf * hb, sh, HH, P0, nv, h, p.hh_l, vec_h);
  };
  long long tile = (long long)blockIdx.x * nw + warp;
  if (tile < ntiles) stage(tile, 0);
  cp_async_commit();
  for (int item = 0; tile < ntiles; tile += stride, ++item) {
    const int buf = item & 1;
    if (tile + stride < ntiles) stage(tile + stride, buf ^ 1);  // prefetch
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    bf* eC = eW + buf * 16 * se;
    tail_fwd_mma<NTE, HM>(TW, eC, hW + buf * hb, sh, xW, [](float x) {
      return x > 0.f ? x : __expf(x) - 1.f;          // ELU
    });
    const long long P0 = 16 * tile;
    store_rows(OUT + P0 * E, eC, se, (int)min(16LL, p.pairs - P0), E, vec_e);
    __syncwarp();      // eC is free for the prefetch two tiles on
  }
  cp_async_wait<0>();
}

template <int NTE, bool HM>
int launch_mma(const Params& p, int nw, cudaStream_t stream) {
  const MmaLayout L(p.ew, p.h, p.hid, HM, nw);
  auto kern = edge_block_fwd_mma_kernel<NTE, HM>;
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
  const long long ntiles = (p.pairs + 15) / 16;
  const long long blocks = (ntiles + nw - 1) / nw;
  const long long cap = (long long)sms * per_sm;
  kern<<<(unsigned)(blocks < cap ? blocks : cap), nw * 32, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// Which body takes a shape (dtype 0 f32, 1 bf16; head_major 1 for a
// head-major hh): out = [1 for the tensor-core body, 0 for the CUDA-core
// body; warps a block; shared memory bytes a block]. Returns 0, or 1 (out
// untouched) when neither fits 227 KB. The launcher asks the same rule.
extern "C" long long edge_block_fwd_geometry(int dtype, int ew, int h,
                                             int hid, int head_major,
                                             int* out) {
  const int nw = mma_warps(dtype, ew, h, hid, head_major != 0);
  if (nw > 0) {
    out[0] = 1; out[1] = nw;
    out[2] = (int)MmaLayout(ew, h, hid, head_major != 0, nw).bytes;
    return 0;
  }
  const size_t bytes = dtype == 1 ? smem_bytes<__nv_bfloat16>(ew, h, hid)
                                  : smem_bytes<float>(ew, h, hid);
  if (bytes > OPTIN) return 1;
  out[0] = 0; out[1] = NT / 32; out[2] = (int)bytes;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. hh (pairs, h) as rows when hh_l is 0,
// else a head-major (b, h, l, l) tensor with l = hh_l; e and out
// (pairs, ew); the weight matrices wr (h, ew), w1 (ew, hid), w2 (hid, ew)
// in the working type; br, g2, b2, bb1, bb2 f32. Returns
// cudaGetLastError().
extern "C" int edge_block_fwd(
    int dtype, const void* hh, const void* e, const void* wr, const float* br,
    const float* g2, const float* b2, const void* w1, const float* bb1,
    const void* w2, const float* bb2, void* out, long long pairs, int ew,
    int h, int hid, int hh_l, void* stream) {
  const bool hm = hh_l != 0;
  const int vec = ((ew & 7) == 0 && aligned16(e) && aligned16(out) ? 1 : 0) |
                  (aligned16(hh) && (hm || (h & 7) == 0) ? 2 : 0);
  Params p{hh, e, wr, br, g2, b2, w1, bb1, w2, bb2, out, pairs, ew, h, hid,
           hh_l, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int nw = mma_warps(dtype, ew, h, hid, hm);
  if (nw == 0) return launch<__nv_bfloat16>(p, s);
  if (ew <= 64)
    return hm ? launch_mma<8, true>(p, nw, s) : launch_mma<8, false>(p, nw, s);
  return hm ? launch_mma<16, true>(p, nw, s) : launch_mma<16, false>(p, nw, s);
}
