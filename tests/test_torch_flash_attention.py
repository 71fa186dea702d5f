"""The port's attention (fithubert_tpu_torch/ops/kernels/flash_attention.py)
against the JAX package's flash_attention kernel in interpret mode and its
XLA reference. On the CPU the port runs its plain version (fp32 softmax).
Only query rows with at least one valid key are compared; rows whose keys are
all padding are checked to be finite (the kernel gives 0 there, the XLA
path a uniform softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.flash_attention import (
    _attention_reference,
    _flash_core_fwd,
    flash_attention as j_flash,
)
from fithubert_tpu_torch.ops.attention import MultiHeadSelfAttention
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(2)

# fp32: the same online-softmax sums in another order (the JAX kernel's own
# test holds it to the XLA reference at 2e-5).
F32_ATOL = 2e-5
# bf16: the JAX kernel casts the probabilities to bf16 before PV and the XLA
# reference also keeps bf16 logits and softmax, while the port keeps fp32
# throughout; outputs of ~1 then differ by a few bf16 steps (2^-8).
BF16_ATOL_KERNEL = 1.5e-2
BF16_ATOL_XLA = 3e-2


def _inputs(b, t, h, d, seed, full_pad_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    q *= d ** -0.5  # the caller pre-scales q
    lengths = rng.integers(t // 3, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]
    if full_pad_row:
        mask[-1] = True
    return q, k, v, mask


def _port(q, k, v, mask, dtype):
    tt = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return fa.flash_attention(tt(q), tt(k), tt(v), torch.from_numpy(mask),
                              return_lse=True)


@pytest.mark.parametrize("d", [40, 64])
@pytest.mark.parametrize("t", [128, 192])
def test_plain_matches_jax_interpret_kernel_fp32(d, t):
    q, k, v, mask = _inputs(3, t, 2, d, seed=d + t)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)
    got, _ = _port(q, k, v, mask, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("d", [40, 64])
def test_lse_matches_jax_kernel(d):
    """The kernel also returns the per-row logsumexp for the backward."""
    b, t, h = 2, 128, 2
    q, k, v, mask = _inputs(b, t, h, d, seed=5)
    _out, res = _flash_core_fwd(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                jnp.zeros((2,), jnp.int32), 0.0, 64, 64, True)
    want = np.asarray(res[5]).reshape(b, h, t)
    _got, lse = _port(q, k, v, mask, torch.float32)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("d", [40, 64])
def test_plain_matches_jax_interpret_kernel_bf16(d):
    q, k, v, mask = _inputs(2, 192, 3, d, seed=7)
    want = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask),
                   interpret=True)
    got, _ = _port(q, k, v, mask, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL_KERNEL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_reference_with_padded_rows(dtype):
    """The path the TPU takes at serving shapes (T=399 is no multiple of 64),
    with one batch row whose keys are all padding."""
    q, k, v, mask = _inputs(3, 99, 4, 40, seed=11, full_pad_row=True)
    jd = jnp.dtype(dtype)
    want = np.asarray(_attention_reference(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                           jnp.asarray(mask)).astype(jnp.float32))
    got, lse = _port(q, k, v, mask, getattr(torch, dtype))
    got = got.float().numpy()
    rows = ~mask.all(-1)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL_XLA
    np.testing.assert_allclose(got[rows], want[rows], atol=atol)
    assert np.isfinite(got).all() and torch.isfinite(lse).all()
    assert (lse[~torch.from_numpy(rows)] == fa.NEG_INF).all()


def test_no_mask_equals_all_valid_mask():
    q, k, v, _ = _inputs(2, 50, 2, 40, seed=13)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = fa.flash_attention(tq, tk, tv, None)
    b = fa.flash_attention(tq, tk, tv, torch.zeros(2, 50, dtype=torch.bool))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mha_no_taps_path_matches_jax():
    """MultiHeadSelfAttention (q scaled by head_dim**-0.5, projections, the
    attention and out_proj) on carried weights."""
    from fithubert_tpu.ops.attention import MultiHeadSelfAttention as JMHA

    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 30, 48)).astype(np.float32)
    mask = np.arange(30)[None, :] >= np.array([30, 21])[:, None]
    jm = JMHA(embed_dim=48, num_heads=4, use_pallas=True)
    import jax

    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    for name in params:  # non-zero biases
        params[name]["bias"] = (0.1 * rng.standard_normal(48)).astype(np.float32)
    want, _ = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tm = MultiHeadSelfAttention(48, 4, device="cpu")
    tm.load_state_dict({f"{n}.{p}": torch.from_numpy(
        np.ascontiguousarray(params[n]["kernel"].T if p == "weight" else params[n]["bias"]))
        for n in params for p in ("weight", "bias")})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 40, seed=1))
    with pytest.raises(ValueError, match="needs a seed"):
        fa.flash_attention(q, k, v, mask, dropout_p=0.1)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, k[:, :8], v, mask)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError, match="bool"):
        fa.flash_attention(q, k, v, mask.int())


def test_cpu_path_launches_no_kernel():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(2, 16, 2, 40, seed=2))
    _build.reset_launches()
    fa.flash_attention(q, k, v, mask)
    assert _build.LAUNCHES.get(fa.KERNEL, 0) == 0
