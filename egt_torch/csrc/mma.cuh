// Tensor-core building blocks for the bf16 kernels (K1 to K9): mma.sync
// m16n8k16 with f32 sums, ldmatrix fragment loads, cp.async copies, and
// the staging of working-type rows in shared memory.
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n8 tiles are the A fragment of a
// k16 step: a product's output feeds the next product from registers.
//
// Staged rows are bf16, padded to a multiple of 16 columns (zeros past the
// data) plus 8 more, so a row is an odd number of 16-byte units and the
// eight rows one ldmatrix reads fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace egt {

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two working-type values <-> f32, 4-byte shared-memory accesses
__device__ __forceinline__ float2 ld_bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st_bf2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// x4: four 8 x 8 matrices; lane i gives the address of one row of matrix
// i / 8. trans loads each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b, bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand loads of one 16 x 16 block from a staged matrix S with row
// stride ld (elements); each lane gives the address of one 8-element row.
// A (16 x 16) from row-major M x K at (m0, k0)
__device__ __forceinline__ void lda(uint32_t (&a)[4], const __nv_bfloat16* S,
                                    int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, S + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}
// A (16 x 16) = X^T for X stored K x M (rows k) at (k0, m0)
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const __nv_bfloat16* S,
                                      int ld, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, S + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                   (((lane >> 3) & 1) << 3));
}
// B of the n8 tiles n0 and n0 + 8 (b[0], b[1] and b[2], b[3]) over k0..k0+15,
// from B stored K x N (rows k)
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const __nv_bfloat16* S,
                                       int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, S + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                   ((lane >> 4) << 3));
}
// the same from B stored N x K (rows n), i.e. the product with a transpose
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const __nv_bfloat16* S,
                                       int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, S + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 (((lane >> 3) & 1) << 3));
}

// ---- cp.async: 16 bytes, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp stages rows r < 16 of a (rows, w) bf16 matrix starting at src
// into S (row stride ld): rows r >= nvalid are zeros. 16-byte cp.async
// copies when w is a multiple of 8 (rows start 16-byte aligned), else
// plain loads. The caller commits, waits and syncs the warp.
__device__ __forceinline__ void stage_rows16(__nv_bfloat16* S, int ld,
                                             const __nv_bfloat16* src,
                                             int nvalid, int w) {
  const int lane = threadIdx.x & 31;
  if ((w & 7) == 0) {
    const int cpr = w >> 3;                       // 16-byte chunks a row
    for (int t = lane; t < 16 * cpr; t += 32) {
      const int r = t / cpr, c = (t - r * cpr) << 3;
      const bool ok = r < nvalid;
      cp_async16(S + r * ld + c, ok ? src + (size_t)r * w + c : src, ok);
    }
  } else {
    for (int t = lane; t < 16 * w; t += 32) {
      const int r = t / w, c = t - r * w;
      S[r * ld + c] = r < nvalid ? src[(size_t)r * w + c]
                                 : __float2bfloat16_rn(0.f);
    }
  }
}

// One warp writes rows r < nvalid of S (row stride ld) to dst, (rows, w)
__device__ __forceinline__ void store_rows16(__nv_bfloat16* dst,
                                             const __nv_bfloat16* S, int ld,
                                             int nvalid, int w) {
  const int lane = threadIdx.x & 31;
  if ((w & 7) == 0) {
    const int cpr = w >> 3;
    for (int t = lane; t < nvalid * cpr; t += 32) {
      const int r = t / cpr, c = (t - r * cpr) << 3;
      *reinterpret_cast<uint4*>(dst + (size_t)r * w + c) =
          *reinterpret_cast<const uint4*>(S + r * ld + c);
    }
  } else {
    for (int t = lane; t < nvalid * w; t += 32) {
      const int r = t / w, c = t - r * w;
      dst[(size_t)r * w + c] = S[r * ld + c];
    }
  }
}

// The block zeroes n bf16 elements at S (S and n multiples of 8 elements)
__device__ __forceinline__ void zero_smem(__nv_bfloat16* S, int n) {
  for (int t = threadIdx.x; t < (n >> 3); t += blockDim.x)
    reinterpret_cast<uint4*>(S)[t] = make_uint4(0u, 0u, 0u, 0u);
}

// The block copies a (rows, cols) bf16 matrix at src into S (row stride
// ld), 16 bytes at a time where the rows allow it; the rest of S is left
// as it is (the caller zeroed it and synchronised)
__device__ __forceinline__ void stage_matrix(__nv_bfloat16* S, int ld,
                                             const __nv_bfloat16* src,
                                             int rows, int cols) {
  const bool vec = ((cols | ld) & 7) == 0 &&
                   (((uintptr_t)src | (uintptr_t)S) & 15) == 0;
  if (vec) {
    const int cpr = cols >> 3;
    for (int t = threadIdx.x; t < rows * cpr; t += blockDim.x) {
      const int r = t / cpr, c = (t - r * cpr) << 3;
      *reinterpret_cast<uint4*>(S + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * cols + c);
    }
  } else {
    for (int t = threadIdx.x; t < rows * cols; t += blockDim.x) {
      const int r = t / cols, c = t - r * cols;
      S[r * ld + c] = src[(size_t)r * cols + c];
    }
  }
}

// Sum over the 16 rows of a C fragment value pair (rows g and g + 8 of a
// lane, summed by the caller): after the call every lane of a column
// group t holds the column's sum.
__device__ __forceinline__ float rows16_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
// Sum over the four lanes of a row (one row's 8 columns of an n8 tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// LayerNorm statistics of the lane's two rows (gq and gq + 8) of C
// fragments x, n8 tiles j < NT, over the first n columns: mean mu[r] and
// rsqrt(variance + eps) rs[r], the variance taken about the mean
template <int NT>
__device__ __forceinline__ void ln_stats(const float (&x)[NT][4], int n,
                                         float (&mu)[2], float (&rs)[2]) {
  const int tq = threadIdx.x & 3;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (8 * j + 2 * tq + (q & 1) < n) s[q >> 1] += x[j][q];
  mu[0] = quad_sum(s[0]) / n; mu[1] = quad_sum(s[1]) / n;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (8 * j + 2 * tq + (q & 1) < n) {
        const float d = x[j][q] - mu[q >> 1];
        v[q >> 1] += d * d;
      }
  rs[0] = rsqrtf(quad_sum(v[0]) / n + LN_EPS);
  rs[1] = rsqrtf(quad_sum(v[1]) / n + LN_EPS);
}

}  // namespace egt
