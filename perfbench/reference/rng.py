"""The random bits the training step draws, as a frozen copy.

Philox4x32-10 keyed by a layer's seed, one draw per (graph, query, key,
head): draw 0 the random attention mask, draw 1 attention dropout; a
uniform is (word 0 >> 8) * 2^-24. Seeds are derived on the host with
BLAKE2b over the decimal seed and its tags. This is the draw order the
program's attention paths follow, written out here so that the reference
can draw the same bits without importing the program.
"""

from __future__ import annotations

import hashlib

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
RANDOM_MASK, DROPOUT = 0, 1
SEED_BITS = 62


def fold_seed(seed: int, *tags: int) -> int:
    """A seed in [0, 2^62) from a seed and integer tags."""
    data = ",".join(str(int(x)) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> (64 - SEED_BITS)


def _mulhilo(a: torch.Tensor, m: int):
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & MASK32, mid & MASK32


def _philox_word0(c0, c1, c2, c3, k0: int, k1: int) -> torch.Tensor:
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def pair_uniform(seed: int, b0: int, shape, draw: int, device) -> torch.Tensor:
    """f32 uniforms of shape (b, lq, lk, h) for graphs b0 .. b0 + b - 1 of
    a batch (a chunk of rows keeps its graphs' bits)."""
    if not 0 <= seed < 2 ** SEED_BITS:
        raise ValueError(f"seed out of range: {seed}")
    b, lq, lk, h = shape

    def ar(n, at, start=0):
        view = [1, 1, 1, 1]
        view[at] = n
        return torch.arange(start, start + n, device=device,
                            dtype=torch.int64).view(view)

    zeros = torch.zeros((b, lq, lk, h), dtype=torch.int64, device=device)
    c0 = ar(lk, 2) + zeros
    c1 = ar(lq, 1) + zeros
    c2 = ar(b, 0, b0) + zeros
    c3 = ar(h, 3) | (draw << 16)
    c3 = c3 + zeros
    word = _philox_word0(c0, c1, c2, c3, seed & MASK32, (seed >> 32) & MASK32)
    return (word >> 8).to(torch.float32) * 2.0 ** -24
