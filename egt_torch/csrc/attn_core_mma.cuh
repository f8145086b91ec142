// The attention core's tile on the tensor cores, shared by the bf16 bodies
// of K1 (egt_attention_fwd.cu) and K2 (egt_attention_bwd.cu). A block takes
// one (graph b, head hd) with one warp for each tile of 16 query rows; the
// head's K and V are staged once a block, each warp's rows of the (lq, d)
// and (lq, lk) slabs once a warp, all by 16-byte cp.async where the rows
// allow it (head-major I/O: a (b, h) slab is contiguous). Per warp:
//   - q.k^T (and gv.v^T in the backward) in mma.sync m16n8k16 with f32
//     sums, K (V) read as stored (ldb_nk), d zero-padded to 16;
//   - the softmax chain in C fragments (softmax_gate): the additive masks,
//     the random mask (philox.cuh, counter (j, i, b, head | draw << 16), so
//     the plain version's bits), the row max and sum over a quad of lanes,
//     the sigmoid gate;
//   - products with the attention weights as A (pack_a: the C fragments of
//     two n8 key tiles are the A fragment of one k16 step), keys padded to a
//     multiple of 16 with zeros.
// Exp and the sigmoid take the SFU's __expf: ~1e-7 from expf, far below
// the bf16 rounding of the weights.
#pragma once

#include "mma.cuh"
#include "philox.cuh"

namespace egt {

constexpr int ATT_MAX_L = 64;   // keys (and query rows) the bodies take
constexpr int ATT_MAX_D = 16;   // per-head width they take
constexpr int ATT_SD = 16 + 8;  // row stride of the staged (l, d) slabs

// The tensor-core bodies take bf16 (dtype 1) with d <= 16 and lq, lk <= 64,
// with one warp a tile of 16 query rows
inline bool attn_mma_body(int dtype, int lq, int lk, int d) {
  return dtype == 1 && d <= ATT_MAX_D && lk <= ATT_MAX_L && lq <= ATT_MAX_L;
}
inline int attn_mma_warps(int lq) { return (lq + 15) / 16; }
inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// Shared memory of one block, in bf16 elements: the head's K and V (LK
// rows, keys past lk zero; 16 columns, channels past d zero), then per warp
// NQ tiles of 16 (l, d) rows (row stride ATT_SD) and NP tiles of 16 pair
// rows (row stride sp). Every row is an odd number of 16-byte units, so the
// eight rows one ldmatrix reads fall in distinct banks.
struct AttnLayout {
  int LK, sp, v, warp0, wsz, bytes;
  __host__ __device__ AttnLayout(int lk, int nw, int nq, int np) {
    LK = round16(lk);
    sp = LK + 8;
    v = LK * ATT_SD;
    warp0 = 2 * v;
    wsz = nq * 16 * ATT_SD + np * 16 * sp;
    bytes = 2 * (warp0 + nw * wsz);
  }
};

// Threads tid, tid + nt, ... stage the (rpad, wpad) block of S (row stride
// ld, wpad a multiple of 8) from the row-major (rows, w) matrix at src,
// zeros past rows and past w: 16-byte cp.async copies (a chunk past the
// data zero-filled) when vec (w a multiple of 8, src 16-byte aligned), else
// element loads. The caller commits, waits and synchronises.
__device__ __forceinline__ void stage_pad(__nv_bfloat16* S, int ld,
                                          const __nv_bfloat16* src, int rows,
                                          int rpad, int w, int wpad, bool vec,
                                          int tid, int nt) {
  if (vec) {
    const int cpr = wpad >> 3;
    for (int t = tid; t < rpad * cpr; t += nt) {
      const int r = t / cpr, c = (t - r * cpr) << 3;
      const bool ok = r < rows && c < w;
      cp_async16(S + r * ld + c, ok ? src + (size_t)r * w + c : src, ok);
    }
  } else {
    for (int t = tid; t < rpad * wpad; t += nt) {
      const int r = t / wpad, c = t - r * wpad;
      S[r * ld + c] = r < rows && c < w ? src[(size_t)r * w + c]
                                        : __float2bfloat16_rn(0.f);
    }
  }
}

// One warp writes rows r < rows of S (row stride ld) to the row-major
// (rows, w) matrix at dst: 16-byte stores when vec, else element stores.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* S, int ld,
                                           int rows, int w, bool vec) {
  if (vec) {
    store_rows16(dst, S, ld, rows, w);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < rows * w; t += 32) {
    const int r = t / w, c = t - r * w;
    dst[(size_t)r * w + c] = S[r * ld + c];
  }
}

// x[2 kb], x[2 kb + 1] += A . B^T over the n8 tiles of keys 16 kb .. 16 kb
// + 15, kb < NKT: A the warp's 16 staged rows (d <= 16 columns, one k16
// step), B the staged (LK, 16) K or V slab as stored (rows n)
template <int NKT>
__device__ __forceinline__ void tile_abt(float (&x)[2 * NKT][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B) {
  uint32_t a[4];
  lda(a, A, ATT_SD, 0, 0);
#pragma unroll
  for (int kb = 0; kb < NKT; ++kb) {
    uint32_t b[4];
    ldb_nk(b, B, ATT_SD, 0, 16 * kb);
    mma16816(x[2 * kb], a, b[0], b[1]);
    mma16816(x[2 * kb + 1], a, b[2], b[3]);
  }
}

// o[0] (channels 0-7), o[1] (8-15, when d > 8) += P . M: P the rounded
// weights as A fragments (keys 16 kb .. 16 kb + 15 each), M the staged
// (LK, 16) K or V slab as stored (rows k)
template <int NKT>
__device__ __forceinline__ void tile_pm(float (&o)[2][4],
                                        const uint32_t (&p)[NKT][4],
                                        const __nv_bfloat16* M, int d) {
#pragma unroll
  for (int kb = 0; kb < NKT; ++kb) {
    uint32_t b[4];
    ldb_kn(b, M, ATT_SD, 16 * kb, 0);
    mma16816(o[0], p[kb], b[0], b[1]);
    if (d > 8) mma16816(o[1], p[kb], b[2], b[3]);
  }
}

// The A fragments of k16 step kb from the C fragments of key tiles 2 kb
// and 2 kb + 1, rounded to bf16
template <int NKT>
__device__ __forceinline__ void pack_a(uint32_t (&p)[NKT][4],
                                       const float (&x)[2 * NKT][4]) {
#pragma unroll
  for (int kb = 0; kb < NKT; ++kb) {
    p[kb][0] = pack_bf16(x[2 * kb][0], x[2 * kb][1]);
    p[kb][1] = pack_bf16(x[2 * kb][2], x[2 * kb][3]);
    p[kb][2] = pack_bf16(x[2 * kb + 1][0], x[2 * kb + 1][1]);
    p[kb][3] = pack_bf16(x[2 * kb + 1][2], x[2 * kb + 1][3]);
  }
}

// 1 / (1 + e^-x) by the SFU: the reciprocal of an infinite denominator
// (x near -1e9, a masked gate) is 0
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// The lane's two query rows of a warp's tile: rows i0 + gq and i0 + gq + 8
// of (graph b, head hd); C fragment q of an n8 tile lies in row q >> 1 and
// key 8 j + 2 tq + (q & 1).
struct TileRows {
  const float* madd;       // the graph's key mask (lk), additive
  const float* maddf[2];   // the hard mask's rows (lk), or null
  int lk, b, hd, i[2];
  bool ok[2];              // the row is < lq
  __device__ TileRows(const float* madd_, const float* maddf_, int lq,
                      int lk_, int b_, int hd_, int i0) {
    const int gq = (threadIdx.x & 31) >> 2;
    madd = madd_ + (size_t)b_ * lk_;
    lk = lk_; b = b_; hd = hd_;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      i[r] = i0 + gq + 8 * r;
      ok[r] = i[r] < lq;
      maddf[r] = maddf_ && ok[r]
                     ? maddf_ + ((size_t)b_ * lq + i[r]) * lk_ : nullptr;
    }
  }
};

// One draw of the lane's pairs as bits, bit 4 jc + q for C fragment q of
// key tile jc: set where the pair's uniform is below p (draw 0, the random
// mask: masked), or not below it (draw 1, dropout: kept). A key tile's four
// Philox words are made without a branch between them, so their chains
// overlap; tiles past lk are skipped, bits past lk or lq are not read.
template <int NT>
__device__ __forceinline__ uint32_t draw_bits(const TileRows& R,
                                              const Draws& dr, int draw,
                                              float p) {
  const int tq = threadIdx.x & 3;
  uint32_t bits = 0;
#pragma unroll
  for (int jd = 0; jd < NT; ++jd) {
    if (8 * jd < R.lk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float u = egt_uniform(dr.seed_lo, dr.seed_hi, R.b, R.i[q >> 1],
                                    8 * jd + 2 * tq + (q & 1), R.hd, draw);
        bits |= (uint32_t)(draw ? u >= p : u < p) << (4 * jd + q);
      }
    }
  }
  return bits;
}

// The forward chain of one warp's tile in C fragments, NT n8 key tiles. x
// holds the f32 h_hat on entry and softmax_j of the masked logits on
// return; sg gets the sigmoid of the masked gates read from the staged
// tile Gs (row stride sp), or 1 where Gs is null (ungated). Logits and
// gates take madd, then maddf, then the random mask, as the plain version
// adds them; the random mask where a bit of masked (draw_bits of draw 0)
// is set. Keys past lk give 0 in both.
template <int NT>
__device__ __forceinline__ void softmax_gate(float (&x)[NT][4],
                                             float (&sg)[NT][4],
                                             const __nv_bfloat16* Gs, int sp,
                                             const TileRows& R,
                                             uint32_t masked) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jc = 0; jc < NT; ++jc) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c0 = 8 * jc + 2 * tq;
      const float2 gg = Gs ? ld_bf2(Gs + (gq + 8 * r) * sp + c0)
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = 2 * r + u, c = c0 + u;
        if (c < R.lk) {
          const float m = R.madd[c];
          const float f = R.maddf[r] ? R.maddf[r][c] : 0.f;
          const float rm = (masked >> (4 * jc + q)) & 1u ? -1e9f : 0.f;
          float l = x[jc][q] + m;
          if (R.maddf[r]) l += f;
          l += rm;
          x[jc][q] = l;
          mx[r] = fmaxf(mx[r], l);
          if (Gs) {
            float gm = (u ? gg.y : gg.x) + m;
            if (R.maddf[r]) gm += f;
            sg[jc][q] = sigmoid_fast(gm + rm);
          } else {
            sg[jc][q] = 1.f;
          }
        } else {
          x[jc][q] = -INFINITY;
          sg[jc][q] = 0.f;
        }
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int jc = 0; jc < NT; ++jc)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float ex = __expf(x[jc][q] - mx[q >> 1]);
      x[jc][q] = ex;
      sum[q >> 1] += ex;
    }
  const float inv0 = 1.f / fmaxf(quad_sum(sum[0]), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(sum[1]), 1e-30f);
#pragma unroll
  for (int jc = 0; jc < NT; ++jc) {
    x[jc][0] *= inv0; x[jc][1] *= inv0;
    x[jc][2] *= inv1; x[jc][3] *= inv1;
  }
}

}  // namespace egt
