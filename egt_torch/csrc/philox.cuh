// The port's random bits on the card: Philox4x32-10, counter-based.
//
// The same function as egt_torch/ops/rng.py (the plain version): key =
// (seed mod 2^32, seed >> 32), counter = (key j, query i, graph b,
// head | draw << 16), uniform = (word 0 >> 8) * 2^-24. Draw 0 is the random
// attention mask, draw 1 attention dropout (the draw order of the TPU
// kernels egt_pallas.py::_fwd_kernel and
// fused_layer_pallas.py::_softmax_gate_fwd). Each (b, i, j, head, draw)
// names its own bits, so a forward kernel and its backward regenerate the
// same draws whatever their thread layout.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// uniform in [0, 1), exact in f32
__device__ __forceinline__ float egt_uniform(uint32_t seed_lo, uint32_t seed_hi,
                                             int b, int i, int j, int head,
                                             int draw) {
  const uint32_t w = philox_word0((uint32_t)j, (uint32_t)i, (uint32_t)b,
                                  (uint32_t)head | ((uint32_t)draw << 16),
                                  seed_lo, seed_hi);
  return (float)(w >> 8) * 5.9604644775390625e-08f;
}

// The stochastic part of the attention chain, shared by every kernel that
// draws: the random mask is an additive -1e9 on logits and gates; dropout
// keeps an attention weight with probability 1 - p (each kernel scales the
// kept weight by 1 / keep as its TPU kernel does: by division, or by a
// multiplication with 1 / keep).
struct Draws {
  uint32_t seed_lo, seed_hi;
  float mask_p;     // random_mask_prob; 0 = off
  float drop_p;     // attn_dropout; 0 = off
  float keep;       // 1 - attn_dropout
  __device__ __forceinline__ float mask_add(int b, int i, int j, int head) const {
    if (mask_p <= 0.f) return 0.f;
    return egt_uniform(seed_lo, seed_hi, b, i, j, head, 0) < mask_p ? -1e9f : 0.f;
  }
  __device__ __forceinline__ bool dropping() const { return drop_p > 0.f; }
  __device__ __forceinline__ bool kept(int b, int i, int j, int head) const {
    return egt_uniform(seed_lo, seed_hi, b, i, j, head, 1) >= drop_p;
  }
};
