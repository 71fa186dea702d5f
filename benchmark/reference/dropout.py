"""The training forward's dropout masks, worked out again from the step's
seed the way the program under test derives them, so that the reference
drops what the program drops.

A step's seed is ``((train.seed * 1_000_003 + step) * 131_071 + micro)
mod 2^63``; a CPU ``torch.Generator`` seeded with it draws a table of 1024
pairs of 32-bit words in one ``randint`` call; the forward's random sites
take the table's pairs in order: the encoder's own sites from slot 0, the
sites of encoder layer-list slot i from slot 64 + 16 i. A site's keep mask
is Philox-4x32-10 under the key (word 0, word 1): for an elementwise
dropout of n elements, element e is word e & 3 of the counter (e >> 2,
e >> 34, 0, 0); for attention probabilities, key column j of query row i
of head z = b * H + h is word j & 3 of the counter (j >> 2, i, z, 0). An
element is kept when the word's top 24 bits reach floor(p * 2^24), and a
kept element is scaled by 1 / (1 - p).
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
TABLE_SLOTS, ENCODER_SLOTS, LAYER_SLOTS = 1024, 64, 16
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
CHUNK = 1 << 24  # elements of one Philox evaluation (~120 bytes each while it runs)


def step_seed(train_seed: int, step: int, micro: int = 0) -> int:
    return ((train_seed * 1_000_003 + step) * 131_071 + micro) % (1 << 63)


def seed_table(seed: int) -> torch.Tensor:
    """(1024, 2) int64 words in [0, 2^32)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, (TABLE_SLOTS, 2), generator=gen, dtype=torch.int64)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_lo * m_hi + a_hi * m_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (a_hi * m_hi + (mid >> 16)) & M32
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M[0])
        hi1, lo1 = _mulhilo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W[0]) & M32, (k1 + _W[1]) & M32
    return c0, c1, c2, c3


def _word(words, sel):
    return torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))


def _threshold(p: float) -> int:
    return min(int(p * (1 << 24)), (1 << 24) - 1)


def keep_flat(n: int, p: float, words: Tuple[int, int], device) -> torch.Tensor:
    """(n,) bool keep mask of an elementwise dropout."""
    out = torch.empty(n, dtype=torch.bool, device=device)
    for e0 in range(0, n, CHUNK):
        e = torch.arange(e0, min(n, e0 + CHUNK), device=device, dtype=torch.int64)
        g = e >> 2
        zero = torch.zeros_like(g)
        w = philox(g & M32, g >> 32, zero, zero, *words)
        out[e0:e0 + e.numel()] = (_word(w, e & 3) >> 8) >= _threshold(p)
    return out


def keep_attention(b: int, h: int, t: int, p: float, words: Tuple[int, int],
                   device) -> torch.Tensor:
    """(B, H, T, T) bool keep mask of the attention probabilities."""
    i = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, t, 1)
    j = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, 1, t)
    out = torch.empty((b, h, t, t), dtype=torch.bool, device=device)
    rows = max(1, CHUNK // (h * t * t))
    for b0 in range(0, b, rows):
        b1 = min(b, b0 + rows)
        z = torch.arange(b0 * h, b1 * h, device=device, dtype=torch.int64).view(b1 - b0, h, 1, 1)
        w = philox(j >> 2, i, z, torch.zeros_like(j), *words)
        out[b0:b1] = (_word(w, (j & 3).expand(b1 - b0, h, t, t)) >> 8) >= _threshold(p)
    return out


class Drops:
    """The sites of one training forward, in the order the model reaches
    them: ``take()`` the next encoder-level slot, ``layer(i)`` a view that
    takes slot i's own slots."""

    def __init__(self, table: torch.Tensor, start: int = 0, end: int = ENCODER_SLOTS):
        self.table, self.next, self.end = table, start, end

    def layer(self, slot: int) -> "Drops":
        base = ENCODER_SLOTS + slot * LAYER_SLOTS
        return Drops(self.table, base, base + LAYER_SLOTS)

    def take(self) -> Tuple[int, int]:
        if self.next >= self.end:
            raise RuntimeError("a block of the seed table is used up")
        w0, w1 = (int(v) for v in self.table[self.next])
        self.next += 1
        return w0, w1

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p <= 0.0:
            return x
        keep = keep_flat(x.numel(), p, self.take(), x.device).view(x.shape)
        return torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)
