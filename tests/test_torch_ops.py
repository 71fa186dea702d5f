"""The port's leaf ops (fithubert_tpu_torch/ops: activations, norms,
padding) against the JAX package's functions on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops import padding as jpad
from fithubert_tpu.ops.activations import gelu_exact as j_gelu_exact
from fithubert_tpu.ops.norms import FP32GroupNorm as JGroupNorm
from fithubert_tpu.ops.norms import FP32LayerNorm as JLayerNorm
from fithubert_tpu_torch.ops import padding as tpad
from fithubert_tpu_torch.ops.activations import gelu_exact, gelu_tanh
from fithubert_tpu_torch.ops.norms import FP32GroupNorm, FP32LayerNorm

torch.set_num_threads(2)

# fp32: the same formula evaluated by two libraries (erf / tanh
# implementations a few ulps apart at |gelu| up to ~10).
F32_ATOL = 5e-6
# bf16 outputs: both sides compute in fp32 and round once, so they differ by
# at most one bf16 step (2^-8 relative) where the fp32 values straddle a
# rounding boundary.
BF16_RTOL = 2 ** -7


def _x(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_gelu_exact_matches_jax_fp32():
    x = _x((4096,))
    want = np.asarray(j_gelu_exact(jnp.asarray(x)))
    got = gelu_exact(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_gelu_exact_matches_jax_bf16():
    x = _x((4096,), seed=1)
    want = np.asarray(j_gelu_exact(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = gelu_exact(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=F32_ATOL)


def test_gelu_tanh_matches_jax_approximate():
    x = _x((4096,), seed=2)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    x = _x((2, 17, 24), seed=3) + 1.5
    rng = np.random.default_rng(4)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = JLayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jx)
    ln = FP32LayerNorm(24)
    ln.weight.data = torch.from_numpy(scale)
    ln.bias.data = torch.from_numpy(bias)
    got = ln(torch.from_numpy(x).to(getattr(torch, dtype))).detach()
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":  # fp32 statistics, summation order only
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("groups", [24, 6])
def test_group_norm_matches_jax(groups):
    x = _x((2, 33, 24), seed=5) + 0.5
    rng = np.random.default_rng(6)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want = JGroupNorm(num_groups=groups).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    gn = FP32GroupNorm(groups, 24)
    gn.weight.data = torch.from_numpy(scale)
    gn.bias.data = torch.from_numpy(bias)
    np.testing.assert_allclose(gn(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)


SPEC = ((32, 10, 5), (32, 1, 1), (32, 3, 2), (32, 3, 2), (64, 1, 1), (64, 2, 2))


@pytest.mark.parametrize("length", [400, 4001, 16000, 16017])
def test_conv_lengths_match_jax(length):
    assert tpad.conv_out_length(length, 10, 5) == jpad.conv_out_length(length, 10, 5)
    assert tpad.feat_extract_output_lengths(length, SPEC) == \
        jpad.feat_extract_output_lengths(length, SPEC)
    lengths = np.array([length, length - 7, length // 2])
    want = np.asarray(jpad.feat_extract_output_lengths(jnp.asarray(lengths), SPEC))
    got = tpad.feat_extract_output_lengths(torch.from_numpy(lengths), SPEC).numpy()
    np.testing.assert_array_equal(got, want)


def _mask(lengths, t):
    return np.arange(t)[None, :] >= np.asarray(lengths)[:, None]


def test_lengths_and_masks_match_jax():
    lengths = np.array([5, 11, 0, 11])
    want = np.asarray(jpad.lengths_to_padding_mask(jnp.asarray(lengths), 11))
    got = tpad.lengths_to_padding_mask(torch.from_numpy(lengths), 11).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpad.padding_mask_to_lengths(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jpad.padding_mask_to_lengths(jnp.asarray(want))))


@pytest.mark.parametrize("t", [12, 13])
@pytest.mark.parametrize("ceil", [False, True])
@pytest.mark.parametrize("factor", [2, 3])
def test_reduce_padding_mask_matches_jax(t, ceil, factor):
    mask = _mask([t, t - 1, 4, 1], t)
    want = np.asarray(jpad.reduce_padding_mask(jnp.asarray(mask), factor, ceil=ceil))
    got = tpad.reduce_padding_mask(torch.from_numpy(mask), factor, ceil=ceil).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpad.reduce_padding_mask(None, factor) is None


@pytest.mark.parametrize("multiple", [1, 4, 7])
def test_pad_to_multiple_matches_jax(multiple):
    x = _x((2, 10, 3), seed=7)
    jx, jrem = jpad.pad_to_multiple(jnp.asarray(x), multiple, axis=-2)
    tx, trem = tpad.pad_to_multiple(torch.from_numpy(x), multiple, axis=-2)
    assert trem == jrem
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    mask = _mask([10, 6], 10)
    jm, _ = jpad.pad_to_multiple(jnp.asarray(mask), multiple, axis=-1, value=True)
    tm, _ = tpad.pad_to_multiple(torch.from_numpy(mask), multiple, axis=-1, value=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tpad.pad_to_multiple(None, multiple) == (None, 0)


def test_apply_padding_mask_matches_jax():
    x = _x((2, 9, 4), seed=8)
    mask = _mask([9, 3], 9)
    want = np.asarray(jpad.apply_padding_mask(jnp.asarray(x), jnp.asarray(mask)))
    got = tpad.apply_padding_mask(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tpad.apply_padding_mask(torch.from_numpy(x), None).shape == x.shape
