"""The attention gradient of the PyTorch port (fithubert_tpu_torch/ops/
kernels/flash_attention.py): ``attention_bwd_plain`` and the autograd
Function around it against jax.grad through the JAX package's
flash_attention (its Pallas backward kernels in interpret mode, or its XLA
path where T is no multiple of 64), and the dropout keep mask by its
properties. The TPU's random bits cannot be reproduced, so with dropout the
port is held to autograd of its own plain forward on the same mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels.philox import key_words, seed_tensor

torch.set_num_threads(2)

# fp32: the same sums in another order (blockwise kernels vs einsum).
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: the JAX kernels round P, dS and the products to bf16 before each
# matmul, the port keeps fp32 from the same bf16 inputs and rounds once, so
# gradients of O(1) differ by a few bf16 steps (2^-8) of the largest entry.
BF16_REL = 3e-2


def _inputs(b, t, h, d, seed, full_pad_row=False):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    lengths = rng.integers(t // 3, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]
    if full_pad_row:
        mask[-1] = True
    return q, k, v, g, mask


def _jax_grads(q, k, v, g, mask, dtype):
    jd = jnp.dtype(dtype)

    def f(q_, k_, v_):
        out = j_flash(q_, k_, v_, jnp.asarray(mask), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a, jd) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_grads(q, k, v, g, mask, dtype, dropout_p=0.0, seed=None):
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(mask), dropout_p=dropout_p,
                             seed=seed)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(out.dtype))
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("case", [(2, 128, 2, 40, True), (3, 192, 2, 64, True),
                                  (2, 100, 3, 40, False)],
                         ids=["t128_d40_padrow", "t192_d64_padrow", "t100_xla"])
def test_backward_matches_jax_grad_fp32(case):
    """T = 128 and 192 run the JAX Pallas backward kernels (interpret); a
    fully padded row then has zero gradients on both sides. T = 100 is no
    multiple of 64, so JAX takes its XLA path there."""
    b, t, h, d, pad_row = case
    q, k, v, g, mask = _inputs(b, t, h, d, seed=t + d, full_pad_row=pad_row)
    want = _jax_grads(q, k, v, g, mask, "float32")
    got = _port_grads(q, k, v, g, mask, "float32")
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x, y, err_msg=f"d{name}", **F32_TOL)
    if pad_row:
        assert all((x[-1] == 0).all() for x in got)


@pytest.mark.parametrize("d", [40, 64])
def test_backward_matches_jax_grad_bf16(d):
    q, k, v, g, mask = _inputs(2, 128, 3, d, seed=11 + d)
    want = _jax_grads(q, k, v, g, mask, "bfloat16")
    got = _port_grads(q, k, v, g, mask, "bfloat16")
    for name, x, y in zip("qkv", got, want):
        rel = np.abs(x - y).max() / np.abs(y).max()
        assert rel < BF16_REL, (f"d{name}", rel)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1, 0.5])
def test_plain_backward_equals_autograd_of_plain_forward(dropout_p):
    """attention_bwd_plain (the kernels' formulas, mask regenerated from the
    seed) against autograd through attention_plain on the same mask; fp32,
    ragged mask, T = 77."""
    q, k, v, g, mask = _inputs(2, 77, 3, 8, seed=3)
    seed = seed_tensor(0x12345678, 0x9ABCDEF0)
    got = _port_grads(q, k, v, g, mask, "float32", dropout_p, seed if dropout_p else None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, _ = fa.attention_plain(tq, tk, tv, torch.from_numpy(mask), dropout_p, seed)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x, y.numpy(), err_msg=f"d{name}", atol=1e-5, rtol=1e-4)


def test_philox_matches_known_answers():
    """Random123's known-answer vectors for Philox-4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = fa.philox4x32(*(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_is_one_minus_p(p):
    b, h, t = 2, 12, 300
    keep = fa.keep_mask(b, h, t, p, seed_tensor(7, 9))
    n = keep.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - p)) < 4 * sigma


def test_dropout_scales_kept_probabilities_by_one_over_keep():
    """With v = I the output is the dropped probability matrix itself:
    every entry is 0 or softmax / (1 - p), and its mean is unbiased."""
    b, t, h, p, seed = 2, 64, 2, 0.25, seed_tensor(5, 6)
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((b, t, h, t)).astype(np.float32))
            for _ in range(2))
    v = torch.eye(t).expand(b, h, t, t).permute(0, 2, 1, 3).contiguous()  # v[b, j, h] = e_j
    dropped, _ = fa.attention_plain(q, k, v, None, p, seed)
    probs, _ = fa.attention_plain(q, k, v)
    dropped, probs = dropped.permute(0, 2, 1, 3), probs.permute(0, 2, 1, 3)  # (B, H, T, T)
    keep = fa.keep_mask(b, h, t, p, seed)
    torch.testing.assert_close(dropped, torch.where(keep, probs / (1 - p), 0.0))
    assert abs(dropped.sum(-1).mean().item() - 1.0) < 0.05


def test_mask_does_not_depend_on_tiling():
    """Each element is a function of (seed, z, i, j) alone: a sub-square of
    a larger mask equals the mask of the smaller T, and 64 x 16 tiles drawn
    one Philox call per four keys (the forward and dQ kernels' order) or
    one call per (row, key) (the dK/dV kernel's order) rebuild it."""
    b, h, t, p, seed = 1, 3, 150, 0.3, seed_tensor(11, 22)
    full = fa.keep_mask(b, h, t, p, seed)
    assert torch.equal(full[:, :, :70, :70], fa.keep_mask(b, h, 70, p, seed))
    thr = int(p * (1 << 24))
    z = 2
    i = torch.arange(64, 128).view(-1, 1)
    j = torch.arange(16, 32).view(1, -1)
    words = fa.philox4x32(j >> 2, i, torch.tensor(z), torch.tensor(0), key_words(seed))
    tile = torch.stack(words, -1).gather(-1, (j & 3).expand(64, 16)[..., None])[..., 0]
    assert torch.equal((tile >> 8) >= thr, full[0, z, 64:128, 16:32])
    one = fa.philox4x32(torch.tensor(149 >> 2), torch.tensor(3), torch.tensor(1),
                        torch.tensor(0), key_words(seed))[149 & 3]
    assert bool((one >> 8) >= thr) == bool(full[0, 1, 3, 149])


def test_masks_differ_across_seeds_and_heads():
    b, h, t, p = 1, 2, 200, 0.1
    a = fa.keep_mask(b, h, t, p, seed_tensor(1, 2))
    expect = 2 * p * (1 - p)  # fraction of elements where two independent masks differ
    for other in (fa.keep_mask(b, h, t, p, seed_tensor(1, 3)),
                  fa.keep_mask(b, h, t, p, seed_tensor(2, 2))):
        assert abs((a != other).float().mean().item() - expect) < 0.01
    assert abs((a[:, 0] != a[:, 1]).float().mean().item() - expect) < 0.01


def test_dropout_needs_a_seed_and_a_valid_rate():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(TypeError, match="seed_tensor"):  # host words are not a seed
        fa.flash_attention(q, q, q, dropout_p=0.1, seed=(1, 2))
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_attention(q, q, q, dropout_p=1.0, seed=seed_tensor(1, 2))
    with pytest.raises(ValueError, match="2\\^-24"):  # kernel and plain version would differ
        fa.flash_attention(q, q, q, dropout_p=2.0 ** -25, seed=seed_tensor(1, 2))
    fa.flash_attention(q, q, q, dropout_p=2.0 ** -24, seed=seed_tensor(1, 2))  # the finest rate
