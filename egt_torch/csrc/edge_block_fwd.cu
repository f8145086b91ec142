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
// whatever the model's activation is, as in the TPU kernel. The chain is
// edge_tail.cuh's tail_fwd_tile.
//
// What bounds it on an H100: at the ZINC-500k shape (204,800 pairs, ew 64,
// h 8, hidden 128, bf16) it moves ~56 MB (hh and e_res in, out), ~17 us at
// 3.35 TB/s, against ~7 GFLOP of products, ~7 us at the bf16 tensor-core
// peak: bytes bound it. This first kernel runs its products on the f32
// CUDA cores (67 TFLOP/s), so those FLOPs set its time instead.
//
// Design: a persistent grid, sized by the occupancy API, walks tiles of TP
// consecutive pairs; each block loads the weights once into shared memory
// (rows padded so no read has bank conflicts) and keeps them for all its
// tiles. Per tile the pairs go through the whole chain in shared memory:
// hh and e_res are read once and out is written once. hh may be a view of
// the attention kernel's head-major (b, h, l, l) h_hat, read in place.

#include "edge_tail.cuh"

namespace {

using namespace egt;

constexpr int NT = 256;
constexpr int TP = 32;

struct Params {
  const void* hh; const void* e;
  const void* wr; const float* br; const float* g2; const float* b2;
  const void* w1; const float* bb1; const void* w2; const float* bb2;
  void* out;
  long long pairs; int ew, h, hid, hh_l;
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

}  // namespace

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
  Params p{hh, e, wr, br, g2, b2, w1, bb1, w2, bb2, out, pairs, ew, h, hid,
           hh_l};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
