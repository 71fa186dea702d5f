"""The port's seeded elementwise dropout (fithubert_tpu_torch/ops/kernels/
dropout.py, K5) by its properties, and the Philox generator it shares with
the attention kernels (ops/kernels/philox.py). The TPU kernel draws its bits
from the TPU's hardware generator, which has no interpret mode
(``fithubert_tpu/ops/pallas/dropout.py:169-172``): no other device can
reproduce its masks, so K5 is held to what the JAX function promises: a
keep-rate of 1 - p, the 1/(1-p) scale, and a backward on the same mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.dropout import seeded_dropout as j_seeded_dropout
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import dropout as kd
from fithubert_tpu_torch.ops.kernels import philox

torch.set_num_threads(2)

WORDS = (0x2545F491, 0x9E3779B9)
SEED = philox.seed_tensor(*WORDS)
KEEP_SIGMAS = 4.0  # a binomial keep count within 4 sigma of n (1 - p)


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_is_one_minus_p(p):
    y = kd.seeded_dropout(torch.ones(4, 12, 64, 64), SEED, p)
    n = y.numel()
    rate = (y != 0).float().mean().item()
    assert abs(rate - (1 - p)) < KEEP_SIGMAS * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kept_values_are_scaled_by_one_over_keep(dtype):
    """Every output is 0 or x * 1/(1-p) computed in fp32 and rounded once
    to x's dtype: exact equality."""
    p = 0.3
    x = _x((3, 5, 77)).to(dtype)
    y = kd.seeded_dropout(x, SEED, p)
    assert y.dtype == dtype
    keep = kd.keep_flat(x.numel(), p, SEED).view(x.shape)
    inv = torch.tensor(1 / (1 - p), dtype=torch.float32)
    zero = torch.zeros((), dtype=dtype)
    assert torch.equal(y, torch.where(keep, (x.float() * inv).to(dtype), zero))
    assert torch.equal(y == 0, ~keep | (x == 0))


def test_backward_is_mask_times_scale_times_cotangent():
    p = 0.25
    x = _x((2, 3, 50, 50)).requires_grad_()
    cot = _x((2, 3, 50, 50), seed=1)
    (grad,) = torch.autograd.grad(kd.seeded_dropout(x, SEED, p), x, cot)
    keep = kd.keep_flat(x.numel(), p, SEED).view(x.shape)
    assert torch.equal(grad, torch.where(keep, cot * torch.tensor(1 / (1 - p)), 0.0))


def test_backward_of_a_non_contiguous_cotangent_uses_the_same_mask():
    """The backward indexes the cotangent in x's (row-major) order, even
    when autograd hands it over as a transposed view."""
    p = 0.4
    x = _x((30, 20)).requires_grad_()
    y = kd.seeded_dropout(x, SEED, p)
    w = _x((20, 30), seed=2)
    (grad,) = torch.autograd.grad((y * w.t()).sum(), x)
    keep = kd.keep_flat(x.numel(), p, SEED).view(x.shape)
    torch.testing.assert_close(grad, torch.where(keep, w.t() / (1 - p), 0.0), rtol=1e-6, atol=0)


def test_mask_depends_on_the_flat_index_alone():
    """The same elements in another shape, or a prefix of a longer tensor,
    draw the same mask."""
    p = 0.2
    x = _x((6, 7, 11))
    y = kd.seeded_dropout(x, SEED, p)
    assert torch.equal(kd.seeded_dropout(x.reshape(-1), SEED, p), y.reshape(-1))
    assert torch.equal(kd.seeded_dropout(x.reshape(42, 11), SEED, p), y.reshape(42, 11))
    assert torch.equal(kd.keep_flat(101, p, SEED), kd.keep_flat(1000, p, SEED)[:101])


def test_flat_index_is_read_as_a_64_bit_counter():
    """Element e draws word e & 3 of Philox on (e >> 2, e >> 34, 0, 0):
    past 2^34 elements the high word moves, so masks do not repeat."""
    p = 0.5
    e = torch.tensor([5, (1 << 34) + 5, (1 << 36) + 2, (1 << 40) - 1], dtype=torch.int64)
    got = kd.keep_at(e, p, SEED)
    for ei, gi in zip(e.tolist(), got.tolist()):
        words = philox.philox4x32(torch.tensor((ei >> 2) & 0xFFFFFFFF), torch.tensor(ei >> 34),
                                  torch.tensor(0), torch.tensor(0), WORDS)
        assert gi == bool((int(words[ei & 3]) >> 8) >= philox.threshold(p))


def test_distinct_seeds_draw_distinct_masks():
    p, n = 0.1, 200_000
    a = kd.keep_flat(n, p, philox.seed_tensor(1, 2))
    expect = 2 * p * (1 - p)  # fraction where two independent masks differ
    for other in ((1, 3), (2, 2), (2, 1)):
        diff = (a != kd.keep_flat(n, p, philox.seed_tensor(*other))).float().mean().item()
        assert abs(diff - expect) < 0.01, other


def test_zero_rate_is_the_identity_and_bad_rates_are_rejected():
    x = _x((4, 4))
    assert kd.seeded_dropout(x, SEED, 0.0) is x
    with pytest.raises(ValueError, match="2\\^-24"):
        kd.seeded_dropout(x, SEED, 2.0 ** -25)
    kd.seeded_dropout(x, SEED, 2.0 ** -24)  # the finest rate the 24-bit test resolves
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout_p"):
            kd.seeded_dropout(x, SEED, bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kd.seeded_dropout(x.half(), SEED, 0.1)


def test_cpu_tensor_runs_the_plain_version_and_launches_nothing():
    _build.reset_launches()
    x = _x((8, 9))
    assert torch.equal(kd.seeded_dropout(x, SEED, 0.3), kd.seeded_dropout_plain(x, SEED, 0.3))
    assert _build.LAUNCHES.get(kd.KERNEL, 0) == 0


def test_matches_the_jax_function_in_distribution():
    """The JAX package's seeded_dropout off the TPU (its bernoulli path,
    ``dropout.py:127-134``) and the port give the same kind of output: every
    entry 0 or x / (1 - p) (to fp32 rounding), and keep-rates within 4 sigma
    of 1 - p and of each other."""
    p, shape = 0.1, (4, 12, 40, 40)
    x = _x(shape, seed=5) + 3.0  # no zeros in x: a zero output means dropped
    want = np.asarray(j_seeded_dropout(jnp.asarray(x.numpy()), jnp.asarray([7, 9], jnp.int32), p))
    got = kd.seeded_dropout(x, SEED, p).numpy()
    n = x.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    for y in (want, got):
        kept = y != 0
        assert abs(kept.mean() - (1 - p)) < KEEP_SIGMAS * sigma
        np.testing.assert_allclose(y[kept], x.numpy()[kept] / (1 - p), rtol=1e-6)
    assert abs((want != 0).mean() - (got != 0).mean()) < KEEP_SIGMAS * 2 ** 0.5 * sigma


def test_shared_philox_matches_known_answers():
    """Random123's known-answer vectors for Philox-4x32-10, through the
    module both plain versions (K2-K4's keep_mask and K5's keep_flat) use."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox.philox4x32(*(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want
