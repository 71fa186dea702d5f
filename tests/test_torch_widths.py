"""Head sizes and widths the card's kernels are not compiled for.

The attention kernels (K2-K4) are built for the head sizes
``flash_attention.HEAD_DIMS``; the conv-stack kernels (K1, its prefix, K6)
for widths that are multiples of ``conv_frontend.WIDTH_MULTIPLE``. Any
other head size (up to 128) or width is zero-padded on the way in and
cropped on the way out. On the CPU the pad-and-crop wrappers run here
around the plain versions, the same code the card runs around the
kernels, and must equal the unpadded plain versions; the port at such
sizes is also held to the JAX package's Pallas kernels in interpret mode
(which take any size: XLA pads the TPU's lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.conv_frontend import fused_conv_stack, fused_conv_stack_gn
from fithubert_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

torch.set_num_threads(2)

# Padded against unpadded plain versions, fp32: the padded columns are
# exact zeros, but an einsum or conv over a longer axis may sum the same
# terms in another order, a few fp32 ulps of O(1) values.
PAD_TOL = dict(atol=1e-5, rtol=1e-5)
# The port's fp32 attention against the JAX kernel in interpret mode: the
# online softmax sums in another order (the JAX kernel's own test: 2e-5).
JAX_ATTN_ATOL = 2e-5
# The bf16 conv stack against the Pallas stack, which keeps fp32
# intermediates where the port rounds each layer to bf16: norm-wise, one
# bf16 step (tests/test_torch_conv_frontend.py holds the same).
JAX_CONV_REL = 2e-2


def _attention_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    q *= d ** -0.5  # the caller pre-scales q
    mask = np.zeros((b, t), bool)
    mask[1:, t - t // 3:] = True
    return [torch.from_numpy(a) for a in (q, k, v, mask)]


@pytest.mark.parametrize("d, want", [(12, 16), (16, 16), (33, 40), (48, 48), (80, 80),
                                     (100, 128)])
def test_a_head_size_pads_to_the_next_compiled_one(d, want):
    assert fa.padded_head_dim(d) == want


def test_a_head_size_above_128_raises_naming_it():
    with pytest.raises(ValueError, match="head size 160"):
        fa.padded_head_dim(160)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("d", [12, 16, 80])
def test_padded_attention_equals_the_plain_version(d, p):
    q, k, v, mask = _attention_inputs(2, 40, 3, d, seed=d)
    seed = seed_tensor(7, 11) if p > 0 else None
    out, lse = fa.padded_attention(fa.attention_plain, q, k, v, mask, p, seed)
    want_out, want_lse = fa.attention_plain(q, k, v, mask, p, seed)
    assert out.shape == q.shape
    torch.testing.assert_close(out, want_out, **PAD_TOL)
    torch.testing.assert_close(lse, want_lse, **PAD_TOL)


@pytest.mark.parametrize("d", [12, 16, 80])
def test_padded_attention_backward_equals_the_plain_version(d):
    q, k, v, mask = _attention_inputs(2, 40, 3, d, seed=d + 1)
    seed = seed_tensor(3, 5)
    out, lse = fa.attention_plain(q, k, v, mask, 0.1, seed)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(d))
    delta = (dout * out).sum(-1).permute(0, 2, 1)

    def bwd(q, k, v, mask, lse, dout, delta, p, seed):
        # the plain backward reads delta from (dout, out); the padded O has
        # zero columns, so rowsum(dO * O) is unchanged
        o = torch.nn.functional.pad(out, (0, q.shape[-1] - out.shape[-1]))
        return fa.attention_bwd_plain(q, k, v, mask, o, lse, dout, p, seed)

    got = fa.padded_attention_bwd(bwd, q, k, v, mask, lse, dout, delta, 0.1, seed)
    want = fa.attention_bwd_plain(q, k, v, mask, out, lse, dout, 0.1, seed)
    for g, w in zip(got, want):
        assert g.shape == q.shape
        torch.testing.assert_close(g, w, **PAD_TOL)


def test_pad_heads_copies_only_what_the_kernels_cannot_read():
    """A compiled head size with aligned rows is read in place; unaligned
    bf16 rows are copied, and other head sizes padded with zeros."""
    x = torch.zeros(2, 16, 3, 40, dtype=torch.bfloat16)
    assert fa.pad_heads(x, 40) is x
    odd = torch.zeros(2, 16, 3, 41, dtype=torch.bfloat16)[..., 1:]
    y = fa.pad_heads(odd, 40)
    assert y is not odd and y.is_contiguous() and fa._readable(y)
    z = fa.pad_heads(torch.ones(2, 16, 3, 12), 16)
    assert z.shape == (2, 16, 3, 16)
    assert z[..., :12].eq(1).all() and z[..., 12:].eq(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_at_head_size_12_matches_jax_interpret_kernel(dtype):
    """The port's attention at D = 12 (the smoke config's student: 48 / 4)
    against the JAX kernel in interpret mode, as its own tests run it."""
    q, k, v, mask = _attention_inputs(2, 128, 4, 12, seed=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = j_flash(*(jnp.asarray(a.numpy(), jdt) for a in (q, k, v)),
                   jnp.asarray(mask.numpy()), interpret=True)
    tdt = getattr(torch, dtype)
    got = fa.flash_attention(q.to(tdt), k.to(tdt), v.to(tdt), mask)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATTN_ATOL)
    else:
        # the JAX kernel rounds P to bf16 before PV, the plain version keeps
        # fp32 (tests/test_torch_flash_attention.py: 1.5e-2)
        np.testing.assert_allclose(got.float().numpy(), want, atol=1.5e-2)


def test_padded_widths_rule():
    c0, spec = cf.padded_widths(48, ((48, 3, 2), (130, 2, 2)), torch.bfloat16)
    assert (c0, spec) == (64, ((64, 3, 2), (192, 2, 2)))
    c0, spec = cf.padded_widths(46, ((48, 3, 2),), torch.float32)
    assert (c0, spec) == (48, ((48, 3, 2),))
    cf.check_widths(c0, spec, torch.float32, "K1")  # what the kernels then take


def _stack_inputs(width, dtype, seed, t=300):
    rng = np.random.default_rng(seed)
    spec = ((width, 3, 2), (width, 2, 2))
    x = torch.from_numpy((rng.standard_normal((2, t, width)) * 0.5).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((k, width, d)) * np.sqrt(2.0 / (k * width)))
                           .astype(np.float32)) for (d, k, _s) in spec]
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(width)).astype(np.float32))
    return x.to(dtype), [w.to(dtype) for w in ws], spec, gamma, beta


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("dtype, width", [(torch.bfloat16, 48), (torch.float32, 46)])
def test_padded_conv_stack_equals_the_plain_version(dtype, width, prefix):
    x, ws, spec, gamma, beta = _stack_inputs(width, dtype, seed=width)
    ss = cf.gn_scale_shift(x, gamma, beta) if prefix else (None, None)
    got = cf.padded_conv_stack(cf.conv_stack_plain, x, ws, spec, *ss)
    want = cf.conv_stack_plain(x, ws, spec, *ss)
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **PAD_TOL)


@pytest.mark.parametrize("dtype, width", [(torch.bfloat16, 48), (torch.float32, 46)])
def test_padded_conv_stack_backward_equals_the_plain_version(dtype, width):
    x, ws, spec, _gamma, _beta = _stack_inputs(width, dtype, seed=width + 1)
    t_out = cf.out_len(x.shape[1], spec)
    g = torch.randn((2, t_out, width), generator=torch.Generator().manual_seed(0)).to(dtype)
    da0, dws = cf.padded_conv_stack_bwd(cf.conv_stack_bwd_plain, x, ws, g, spec)
    want_da0, want_dws = cf.conv_stack_bwd_plain(x, ws, g, spec)
    assert da0.shape == x.shape
    torch.testing.assert_close(da0, want_da0, **PAD_TOL)
    for got, want in zip(dws, want_dws):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **PAD_TOL)


@pytest.mark.parametrize("prefix", [True, False])
def test_conv_stack_at_width_48_matches_jax_interpret_kernel(prefix):
    """The bf16 conv stack at width 48 (the smoke config's with
    ``use_fp16``) through the pad-and-crop path against the Pallas stack in
    interpret mode."""
    x, ws, spec, gamma, beta = _stack_inputs(48, torch.bfloat16, seed=5, t=517)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jws = tuple(jnp.asarray(w.float().numpy(), jnp.bfloat16) for w in ws)
    if prefix:
        want = fused_conv_stack_gn(jx, jws, jnp.asarray(gamma.numpy()),
                                   jnp.asarray(beta.numpy()), spec, 16, True)
        ss = cf.gn_scale_shift(x, gamma, beta)
    else:
        want = fused_conv_stack(jx, jws, spec, 16, True)
        ss = (None, None)
    got = cf.padded_conv_stack(cf.conv_stack_plain, x, ws, spec, *ss).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < JAX_CONV_REL, rel
