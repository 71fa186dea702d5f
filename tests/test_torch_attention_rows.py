"""Attention calls of more than 65535 (b, h) pairs on the CPU: the CUDA
launchers no longer refuse them (the kernels take their blocks on grid x,
tests/test_torch_kernels_gpu.py checks them on the card), the plain keep
mask is drawn over batch rows in chunks and equals one draw, and the plain
versions' first rows equal a call on those rows alone, with dropout."""

import pytest
import torch

from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels.philox import (
    key_words,
    keep_bits,
    philox4x32,
    pick_word,
    seed_tensor,
)


def _one_draw(b, h, t, p, seed):
    z = torch.arange(b * h, dtype=torch.int64).view(b, h, 1, 1)
    i = torch.arange(t, dtype=torch.int64).view(1, 1, t, 1)
    j = torch.arange(t, dtype=torch.int64).view(1, 1, 1, t)
    words = philox4x32(j >> 2, i, z, torch.zeros_like(j), key_words(seed))
    return keep_bits(pick_word(words, (j & 3).expand(b, h, t, t)), p)


@pytest.mark.parametrize("chunk", [1, 7, 100, 1 << 24])
def test_keep_mask_in_chunks_is_one_draw(monkeypatch, chunk):
    seed = seed_tensor(0xDEADBEEF, 99)
    monkeypatch.setattr(fa, "KEEP_MASK_CHUNK", chunk)
    for b, h, t in ((5, 3, 7), (2, 1, 1), (3, 2, 9)):
        assert torch.equal(fa.keep_mask(b, h, t, 0.1, seed), _one_draw(b, h, t, 0.1, seed))


def test_cuda_arguments_take_more_than_65535_batch_heads():
    q = torch.zeros(5462, 1, 12, 40, dtype=torch.bfloat16)
    mask, strides = fa._cuda_args(q, q, q, torch.zeros(5462, 1, dtype=torch.bool))
    assert mask.shape == (5462, 1) and len(strides) == 9


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p0.1"])
def test_plain_first_rows_equal_a_call_on_them_alone(dropout_p):
    g = torch.Generator().manual_seed(65544)
    b, t, h, d = 5462, 2, 12, 8
    q, k, v, dout = (torch.randn(b, t, h, d, generator=g) for _ in range(4))
    mask = torch.zeros(b, t, dtype=torch.bool)
    mask[1::2, 1] = True
    seed = seed_tensor(3, 4) if dropout_p else None
    out, lse = fa.attention_plain(q, k, v, mask, dropout_p, seed)
    grads = fa.attention_bwd_plain(q, k, v, mask, out, lse, dout, dropout_p, seed)
    out16, lse16 = fa.attention_plain(q[:16], k[:16], v[:16], mask[:16], dropout_p, seed)
    grads16 = fa.attention_bwd_plain(q[:16], k[:16], v[:16], mask[:16], out16, lse16,
                                     dout[:16], dropout_p, seed)
    for a, a16 in zip((out, lse, *grads), (out16, lse16, *grads16)):
        assert torch.equal(a[:16], a16)
