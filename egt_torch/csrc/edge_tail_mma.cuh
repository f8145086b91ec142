// The edge tail's forward chain on the tensor cores, for one warp's tile of
// 16 pairs: the bf16 bodies of K3 (fused_layer_fwd.cu) and of K8
// (edge_block_fwd.cu) run it. For every pair, with h_hat and the residual e
// in bf16:
//   e_mid = rnd(h_hat) . Wr + br + e
//   e_out = rnd(act(rnd(LN(e_mid) g2 + b2) . W1 + b1)) . W2 + b2' + e_mid
// in mma.sync m16n8k16 fragments (mma.cuh) with f32 sums: e_mid stays in
// C fragments, LN(e_mid) is reduced in registers (eps 1e-3), and the
// hidden units go 16 at a time from the C fragments of W1's product
// straight into the A fragments of W2's, summed onto e_mid + b2' in place.
// The same chain on the CUDA cores, for K8's f32 body, is edge_tail.cuh's.
#pragma once

#include "mma.cuh"

namespace egt {

// The tail's weights as the block staged them, zero-padded (ew E to EK,
// hidden U to UK, h to HK, each a multiple of 16): Wr (HK x EK, row stride
// se), W1 (EK x UK, su) and W2 (UK x EK, se) in bf16; the f32 vectors br,
// g2, b2, bb2 (EK) and bb1 (UK), zero past the data.
struct TailMmaW {
  const __nv_bfloat16 *wr, *w1, *w2;
  const float *br, *g2, *b2, *bb1, *bb2;
  int E, U, EK, UK, HK, se, su;
};

// One warp's tile. eC holds the 16 staged rows of e (row stride se; zero
// past E, and past the tile's last pair) and receives e_out, staged there
// when the function returns (the warp synchronised). hhW holds rnd(h_hat),
// zero past h: 16 pair rows of HK heads (row stride sh) or, HT, HK head
// rows of the 16 pairs (row stride sh), K8's head-major staging, read
// transposed. xW (16 rows, stride se) is scratch. NTE: the n8 tiles of EK
// (8 up to ew 64, 16 up to 128). act(pre) is the hidden activation.
template <int NTE, bool HT = false, typename Act>
__device__ __forceinline__ void tail_fwd_mma(const TailMmaW& W,
                                             __nv_bfloat16* eC,
                                             const __nv_bfloat16* hhW, int sh,
                                             __nv_bfloat16* xW, Act act) {
  constexpr int NKE = NTE / 2;
  const int E = W.E, U = W.U, EK = W.EK, UK = W.UK, HK = W.HK;
  const int se = W.se, su = W.su;
  const __nv_bfloat16 *Wr = W.wr, *W1 = W.w1, *W2 = W.w2;
  const float *vbr = W.br, *vg2 = W.g2, *vb2 = W.b2, *vbb1 = W.bb1;
  const float* vbb2 = W.bb2;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;

  // ---- e_mid = rnd(h_hat) . Wr + br + e
  float em[NTE][4];
#pragma unroll
  for (int j = 0; j < NTE; ++j) {
    if (j < EK / 8) {
      const int c = 8 * j + 2 * tq;
      const float2 e0 = ld_bf2(eC + gq * se + c);
      const float2 e1 = ld_bf2(eC + (gq + 8) * se + c);
      em[j][0] = e0.x + vbr[c]; em[j][1] = e0.y + vbr[c + 1];
      em[j][2] = e1.x + vbr[c]; em[j][3] = e1.y + vbr[c + 1];
    }
  }
  for (int k0 = 0; k0 < HK; k0 += 16) {
    uint32_t a[4];
    if (HT)
      lda_t(a, hhW, sh, k0, 0);
    else
      lda(a, hhW, sh, 0, k0);
#pragma unroll
    for (int jb = 0; jb < NKE; ++jb) {
      if (jb < EK / 16) {
        uint32_t b[4];
        ldb_kn(b, Wr, se, k0, 16 * jb);
        mma16816(em[2 * jb], a, b[0], b[1]);
        mma16816(em[2 * jb + 1], a, b[2], b[3]);
      }
    }
  }

  // ---- LN(e_mid) -> xW (rounded)
  {
    float mu[2], rs[2];
    ln_stats(em, E, mu, rs);
    const float mu0 = mu[0], mu1 = mu[1], rs0 = rs[0], rs1 = rs[1];
    __syncwarp();   // every lane is done with the caller's reads of xW
#pragma unroll
    for (int jn = 0; jn < NTE; ++jn) {
      if (jn < EK / 8) {
        const int c = 8 * jn + 2 * tq;
        st_bf2(xW + gq * se + c, vg2[c] * ((em[jn][0] - mu0) * rs0) + vb2[c],
               vg2[c + 1] * ((em[jn][1] - mu0) * rs0) + vb2[c + 1]);
        st_bf2(xW + (gq + 8) * se + c,
               vg2[c] * ((em[jn][2] - mu1) * rs1) + vb2[c],
               vg2[c + 1] * ((em[jn][3] - mu1) * rs1) + vb2[c + 1]);
      }
    }
  }
  __syncwarp();

  // ---- e_out = rnd(act(xn . W1 + b1)) . W2 + b2 + e_mid, 16 hidden
  // units at a time, summed onto e_mid + b2 in place
  uint32_t axn[NKE][4];
#pragma unroll
  for (int ks = 0; ks < NKE; ++ks)
    if (ks < EK / 16) lda(axn[ks], xW, se, 0, 16 * ks);
#pragma unroll
  for (int j = 0; j < NTE; ++j)
    if (j < EK / 8) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) em[j][qq] += vbb2[8 * j + 2 * tq + (qq & 1)];
    }
#pragma unroll 2
  for (int u0 = 0; u0 < UK; u0 += 16) {
    float pre[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < NKE; ++ks) {
      if (ks < EK / 16) {
        uint32_t b[4];
        ldb_kn(b, W1, su, 16 * ks, u0);
        mma16816(pre[0], axn[ks], b[0], b[1]);
        mma16816(pre[1], axn[ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int u = u0 + 8 * jj + 2 * tq + (qq & 1);
        pre[jj][qq] = u < U ? act(pre[jj][qq] + vbb1[u]) : 0.f;
      }
    const uint32_t a[4] = {pack_bf16(pre[0][0], pre[0][1]),
                           pack_bf16(pre[0][2], pre[0][3]),
                           pack_bf16(pre[1][0], pre[1][1]),
                           pack_bf16(pre[1][2], pre[1][3])};
#pragma unroll
    for (int jb = 0; jb < NKE; ++jb) {
      if (jb < EK / 16) {
        uint32_t b[4];
        ldb_kn(b, W2, se, u0, 16 * jb);
        mma16816(em[2 * jb], a, b[0], b[1]);
        mma16816(em[2 * jb + 1], a, b[2], b[3]);
      }
    }
  }
  // e is read: stage e_out in its buffer
#pragma unroll
  for (int j = 0; j < NTE; ++j) {
    if (j < EK / 8) {
      const int c = 8 * j + 2 * tq;
      st_bf2(eC + gq * se + c, em[j][0], em[j][1]);
      st_bf2(eC + (gq + 8) * se + c, em[j][2], em[j][3]);
    }
  }
  __syncwarp();
}

}  // namespace egt
