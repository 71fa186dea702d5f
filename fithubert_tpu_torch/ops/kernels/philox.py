"""Philox-4x32-10 in int64 torch ops, and the 24-bit keep test built on it:
the plain versions of the random bits that ``csrc/philox.cuh`` draws on the
card. The attention keep mask (``flash_attention.keep_mask``, K2-K4) and the
elementwise keep mask (``dropout.keep_flat``, K5) are both made here, so the
kernels and their plain versions share one generator.

A probability or activation is kept when the top 24 bits of its Philox word
reach ``threshold(p) = floor(p * 2^24)``, the test of the JAX package's
``_keep_mask`` (``fithubert_tpu/ops/pallas/flash_attention.py:49-60``) and
``_make_kernel`` (``fithubert_tpu/ops/pallas/dropout.py:55,66-68``).
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# the dropout seed: two 32-bit words as a (2,) int32 tensor on the data's
# device, which the kernels read from device memory when they start
Seed = torch.Tensor


def seed_tensor(w0: int, w1: int, device=None) -> torch.Tensor:
    """Two host words as a seed: their 32-bit patterns in a (2,) int32
    tensor on ``device``."""
    bits = [(int(w) & M32) - ((int(w) & M32) >> 31 << 32) for w in (w0, w1)]
    return torch.tensor(bits, dtype=torch.int32, device=device)


def check_seed(seed, device: torch.device) -> Seed:
    """``seed`` as the kernels take it: a contiguous (2,) int32 tensor on
    ``device``."""
    if not isinstance(seed, torch.Tensor):
        raise TypeError(f"a seed is a (2,) int32 tensor (seed_tensor makes one from two "
                        f"words), got {type(seed).__name__}")
    if tuple(seed.shape) != (2,) or seed.dtype != torch.int32 or not seed.is_contiguous():
        raise ValueError(f"a seed tensor must be a contiguous (2,) int32 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    if seed.device != device:
        raise ValueError(f"the seed lies on {seed.device}, the data on {device}")
    return seed


def key_words(seed: Seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """A seed's two words as int64 tensors in [0, 2^32): Philox's key."""
    s = seed.long() & M32
    return s[0], s[1]


def threshold(p: float) -> int:
    """Keep an element when its 24-bit draw is >= this."""
    return min(int(p * (1 << 24)), (1 << 24) - 1)


def check_rate(p: float) -> None:
    """Reject a rate the 24-bit keep test cannot apply as asked."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {p}")
    if p > 0.0 and threshold(p) == 0:
        # the kernels would drop nothing and skip the 1/(1-p) scale
        raise ValueError(f"dropout_p {p} is below 2^-24, the finest rate the "
                         "24-bit keep test resolves")


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product a * m, for a in
    [0, 2^32) held in int64: 16-bit limbs keep every partial product
    below 2^34."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_lo * m_hi + a_hi * m_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (a_hi * m_hi + (mid >> 16)) & M32
    return hi, lo


def philox4x32(c0, c1, c2, c3, key, rounds: int = 10):
    """Philox-4x32 (Salmon et al., SC'11) in int64 torch ops under ``key``,
    two words in [0, 2^32) (ints, or ``key_words`` of a seed): the same
    function as ``philox4x32`` in ``csrc/philox.cuh``."""
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & M32, (k1 + _PHILOX_W[1]) & M32
    return c0, c1, c2, c3


def pick_word(words, sel: torch.Tensor) -> torch.Tensor:
    """Word ``sel`` (0..3, elementwise) of a Philox output."""
    return torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))


def keep_bits(word: torch.Tensor, p: float) -> torch.Tensor:
    """True where a 32-bit draw keeps its element at rate p."""
    return (word >> 8) >= threshold(p)
