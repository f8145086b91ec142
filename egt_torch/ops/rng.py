"""The port's random bits: counter-based Philox4x32-10.

One generator serves every stochastic draw of the attention paths (the plain
attention core, the attention kernel K1 and its backward K2, the whole-layer
kernel K3 and its backward K5), so the port's paths agree with each other
with the draws live. `csrc/philox.cuh` is the same function as a `__device__`
routine; both produce the same bits.

Contract (the draw order of `egt_tpu/ops/fused_layer_pallas.py:287-325` and
`egt_tpu/ops/egt_pallas.py:156-174`):

- key   = (seed mod 2^32, seed >> 32 mod 2^32), one seed per layer call;
- counter = (key index j, query index i, graph b, head | draw << 16);
- draw 0 is the random attention mask, draw 1 attention dropout;
  draw 2 the positional encodings' sign flips, counted by (feature j,
  query 0, graph b, head 0), drawn outside the kernels;
- uniform = (word 0 >> 8) * 2^-24, exact in f32 on both sides.

The counter names the pair and head, not a position in memory, so the
head-major (b, h, lq, lk) and pair-major (b, lq, lk, h) layouts draw the same
bit for the same (b, i, j, head). JAX's bits (`jax.random` in interpret mode,
`pltpu.prng_*` on the chip) differ: stochastic parity with the JAX package is
statistical only.

`fold_seed` derives per-step and per-layer seeds on the host.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
RANDOM_MASK, DROPOUT = 0, 1                # draw indices
PE_FLIP = 2       # the PEs' sign flips (models/features.py): (graph, feature)
SEED_BITS = 62


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a < 2^32, m < 2^32.
    a is split into 16-bit limbs so that no int64 product overflows."""
    p_lo = (a & 0xFFFF) * m                    # < 2^48
    p_hi = (a >> 16) * m                       # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)       # < 2^49
    return ((p_hi >> 16) + (mid >> 32)) & MASK32, mid & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32-R on int64 tensors holding 32-bit words (broadcasting);
    returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    if not 0 <= seed < 2 ** SEED_BITS:
        raise ValueError(f"seed must be in [0, 2^{SEED_BITS}), got {seed}")
    return seed & MASK32, (seed >> 32) & MASK32


def uniform(seed: int, b, i, j, head, draw: int) -> torch.Tensor:
    """f32 uniforms in [0, 1) for broadcastable int64 index tensors."""
    k0, k1 = seed_key(seed)
    word = philox4x32(j, i, b, head | (draw << 16), k0, k1)[0]
    return (word >> 8).to(torch.float32) * 2.0 ** -24


def pair_uniform(seed: int, shape, draw: int, device,
                 head_major: bool = False) -> torch.Tensor:
    """Uniforms over an attention grid: (b, lq, lk, h), or (b, h, lq, lk)
    with `head_major`; element (b, i, j, head) gets the same value in
    both."""
    if head_major:
        b, h, lq, lk = shape
    else:
        b, lq, lk, h = shape

    def ar(n, at):
        view = [1, 1, 1, 1]
        view[at] = n
        return torch.arange(n, device=device, dtype=torch.int64).view(view)

    if head_major:
        return uniform(seed, ar(b, 0), ar(lq, 2), ar(lk, 3), ar(h, 1), draw)
    return uniform(seed, ar(b, 0), ar(lq, 1), ar(lk, 2), ar(h, 3), draw)


class Draws(NamedTuple):
    """The training draws of one kernel call; probabilities 0 switch them
    off (inference)."""
    seed: int = 0
    mask_p: float = 0.0      # random_mask_prob
    drop_p: float = 0.0      # attn_dropout

    def args(self) -> tuple:
        """(seed_lo, seed_hi, mask_p, drop_p, keep) of the C interface."""
        return (*seed_key(self.seed), self.mask_p, self.drop_p,
                1.0 - self.drop_p)


OFF = Draws()


def fold_seed(seed: int, *tags: int) -> int:
    """A new seed in [0, 2^62) from a seed and integer tags (host only)."""
    data = ",".join(str(int(x)) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> (64 - SEED_BITS)
