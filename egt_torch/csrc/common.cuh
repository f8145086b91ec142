// Helpers shared by the port's kernels: working-type conversion and rounding,
// warp reductions, activations, a register-tiled shared-memory product and
// the fixed-order sum of per-block partial weight gradients.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace egt {

constexpr float LN_EPS = 1e-3f;  // Keras LayerNormalization default

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// round an f32 value through the storage type, as the JAX kernels' casts do
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

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// 0 identity, 1 elu, 2 relu, 3 leaky relu (alpha)
__device__ __forceinline__ float act_fn(int kind, float alpha, float x) {
  switch (kind) {
    case 1: return x > 0.f ? x : expm1f(x);
    case 2: return fmaxf(x, 0.f);
    case 3: return x > 0.f ? x : alpha * x;
    default: return x;
  }
}
// d act / d pre at `pre`, given post = act(pre) (the JAX kernels' _act_grad)
__device__ __forceinline__ float act_grad(int kind, float alpha, float pre, float post) {
  switch (kind) {
    case 1: return pre > 0.f ? 1.f : post + 1.f;
    case 2: return pre > 0.f ? 1.f : 0.f;
    case 3: return pre > 0.f ? 1.f : alpha;
    default: return 1.f;
  }
}

// C(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, handed to epi(m, n, c).
// la(m, k) and lb(k, n) read the operands (from shared memory, rounded
// where the product rounds them). Each of the block's NT threads owns 4 x 4
// outputs: rows 4 rg .. 4 rg + 3 and columns cb + r NQ, consecutive across
// lanes, so a row-major B is read without bank conflicts and A is mostly
// broadcast. Every (m, n) belongs to one thread, so epi may accumulate in
// place without atomics.
template <int NT, typename LA, typename LB, typename Epi>
__device__ __forceinline__ void tile_gemm(int M, int N, int K, LA la, LB lb, Epi epi) {
  const int NQ = (N + 3) / 4, RG = (M + 3) / 4;
  for (int t = threadIdx.x; t < RG * NQ; t += NT) {
    const int cb = t % NQ, rg = t / NQ;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][r] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int m = rg * 4 + a;
        av[a] = m < M ? la(m, k) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = cb + r * NQ;
        bv[r] = n < N ? lb(k, n) : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[a][r] = fmaf(av[a], bv[r], acc[a][r]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int m = rg * 4 + a;
      if (m >= M) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = cb + r * NQ;
        if (n < N) epi(m, n, acc[a][r]);
      }
    }
  }
}

// out[t] = sum over blocks k = 0, 1, ... of partials[k][t], in that order:
// the second pass of a weight-gradient sum, bit-identical from run to run.
__global__ void sum_partials(const float* __restrict__ partials, int nblocks,
                             int nw, float* __restrict__ out) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < nw;
       t += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nblocks; ++k) s += partials[(size_t)k * nw + t];
    out[t] = s;
  }
}

inline int launch_sum_partials(const float* partials, int nblocks, int nw,
                               float* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nw + threads - 1) / threads;
  sum_partials<<<blocks, threads, 0, stream>>>(partials, nblocks, nw, out);
  return (int)cudaGetLastError();
}

}  // namespace egt
