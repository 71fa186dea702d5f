"""The port's conv front-end (fithubert_tpu_torch/ops/kernels/conv_frontend.py
and ops/conv.py ConvFeatureExtractor) against the JAX package: the Pallas
kernel in interpret mode, its XLA oracle, and the whole extractor on carried
weights. On the CPU the port runs conv_stack's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.conv import ConvFeatureExtractor as JExtractor
from fithubert_tpu.ops.pallas import force_interpret
from fithubert_tpu.ops.pallas.conv_frontend import (
    _gelu_for,
    _reference_stack,
    fused_conv_stack,
    fused_conv_stack_gn,
)
from fithubert_tpu_torch.ops.conv import ConvFeatureExtractor
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

torch.set_num_threads(2)

# the release spec's 9-block shape, narrowed
SPEC9 = ((32, 10, 5), (32, 1, 1), (32, 3, 2), (32, 3, 2), (64, 1, 1), (64, 2, 2))
REST = SPEC9[1:]
C0 = SPEC9[0][0]

# fp32: the same sums in another order (kernel taps / XLA conv vs F.conv1d).
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16, against the XLA oracle (which rounds every layer to bf16, as the port
# does): a rounding flip in one layer moves the next by about one bf16 step
# (2^-8 relative), which five layers can grow to a few steps.
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _inputs(b=2, t=700, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, C0)) * 0.5 + 0.2).astype(np.float32)
    ws, c_in = [], C0
    for (d, k, _s) in REST:
        ws.append((rng.standard_normal((k, c_in, d)) * np.sqrt(2.0 / (k * c_in)))
                  .astype(np.float32))
        c_in = d
    gamma = (1.0 + 0.1 * rng.standard_normal(C0)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C0)).astype(np.float32)
    return x, ws, gamma, beta


def _port(x, ws, gamma, beta, dtype):
    tx = torch.from_numpy(x).to(dtype)
    tws = [torch.from_numpy(w).to(dtype) for w in ws]
    ss = (None, None)
    if gamma is not None:
        ss = cf.gn_scale_shift(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    return cf.conv_stack(tx, tws, REST, *ss).float().numpy()


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stack_matches_jax_interpret_kernel(prefix, dtype):
    x, ws, gamma, beta = _inputs(t=517 if prefix else 700)
    jx = jnp.asarray(x, dtype)
    jws = tuple(jnp.asarray(w, dtype) for w in ws)
    if prefix:
        want = fused_conv_stack_gn(jx, jws, jnp.asarray(gamma), jnp.asarray(beta),
                                   REST, 16, True)
    else:
        want = fused_conv_stack(jx, jws, REST, 16, True)
    got = _port(x, ws, gamma if prefix else None, beta, getattr(torch, dtype))
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        # the Pallas kernel keeps fp32 intermediates; the port rounds each
        # layer to bf16 like the oracle: compare in norm, one bf16 step
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stack_matches_xla_oracle(prefix, dtype):
    x, ws, gamma, beta = _inputs(seed=1)
    jx = jnp.asarray(x, dtype)
    jws = [jnp.asarray(w, dtype) for w in ws]
    g = (jnp.asarray(gamma), jnp.asarray(beta)) if prefix else ()
    want = np.asarray(_reference_stack(jx, jws, REST, *g).astype(jnp.float32))
    got = _port(x, ws, gamma if prefix else None, beta, getattr(torch, dtype))
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_prefix_matches_the_kernels_prefix(dtype):
    """``gn_prefix_cuda`` on CPU tensors (its plain version, no launch)
    against the Pallas kernel's prefix (``conv_frontend.py:154-160``):
    gelu(x * scale + shift) in fp32, exact GELU in fp32 and tanh in bf16,
    rounded to bf16 once as the XLA oracle rounds a0."""
    x, _ws, gamma, beta = _inputs(t=301, seed=4)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    scale, shift = cf.gn_scale_shift(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    _build.reset_launches()
    got = cf.gn_prefix_cuda(tx, scale, shift).float().numpy()
    assert not _build.LAUNCHES
    jscale, jshift = (jnp.asarray(t.float().numpy())[:, None, :] for t in (scale, shift))
    want = _gelu_for(dtype)(jnp.asarray(tx.float().numpy()) * jscale + jshift)
    want = np.asarray(want.astype(dtype).astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else dict(atol=1e-3, rtol=2.0 ** -7)  # one bf16 step
    np.testing.assert_allclose(got, want, **tol)


def test_gn_scale_shift_folds_groupnorm():
    """gelu(x * scale + shift) == gelu(GroupNorm(C, C)(x)) in fp32."""
    x, _ws, gamma, beta = _inputs(seed=2)
    tx = torch.from_numpy(x)
    scale, shift = cf.gn_scale_shift(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    want = torch.nn.functional.group_norm(tx.transpose(1, 2), C0, torch.from_numpy(gamma),
                                          torch.from_numpy(beta), 1e-5).transpose(1, 2)
    np.testing.assert_allclose((tx * scale[:, None] + shift[:, None]).numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-4)


def _jax_extractor_params(dtype, seed=0):
    model = JExtractor(conv_layers=SPEC9, dtype=jnp.dtype(dtype))
    wav = jnp.zeros((1, 4000), dtype)
    params = model.init(jax.random.PRNGKey(seed), wav)["params"]
    # give the GroupNorm a non-trivial affine
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["group_norm"] = {
        "scale": (1.0 + 0.2 * rng.standard_normal(C0)).astype(np.float32),
        "bias": (0.2 * rng.standard_normal(C0)).astype(np.float32)}
    return model, params


def _port_extractor(params):
    fe = ConvFeatureExtractor(SPEC9, device="cpu")
    sd = {f"conv_layers.{i}.0.weight": torch.from_numpy(
        np.ascontiguousarray(np.asarray(params[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)))
        for i in range(len(SPEC9))}
    sd["conv_layers.0.2.weight"] = torch.from_numpy(params["group_norm"]["scale"])
    sd["conv_layers.0.2.bias"] = torch.from_numpy(params["group_norm"]["bias"])
    fe.load_state_dict(sd)
    return fe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_extractor_matches_jax_prepadded_path(dtype):
    """The whole extractor on carried weights. The JAX side runs under
    force_interpret, so it pre-pads the wav for the kernel's DMA windows and
    keeps those rows out of the GroupNorm statistics (valid_len); the port
    does no such padding. Ragged lengths: zero padding inside the batch
    counts in both sides' statistics."""
    model, params = _jax_extractor_params(dtype)
    rng = np.random.default_rng(3)
    lengths = [4800, 3217, 1800]
    wav = np.zeros((3, 4800), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.3
    with force_interpret():
        want = model.apply({"params": params}, jnp.asarray(wav, dtype))
    want = np.asarray(want.astype(jnp.float32))
    fe = _port_extractor(params)
    with torch.no_grad():
        got = fe(torch.from_numpy(wav).to(getattr(torch, dtype))).float().numpy()
    assert got.shape == want.shape == (3, cf.out_len(4800, SPEC9), 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:  # the JAX kernel keeps fp32 between layers: norm-wise, as above
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


def test_conv_stack_rejects_what_the_kernel_does_not_take():
    x, ws, _g, _b = _inputs(t=200)
    tx = torch.from_numpy(x)
    tws = [torch.from_numpy(w) for w in ws]
    with pytest.raises(ValueError, match="k <= 2s"):
        cf.conv_stack(tx, tws[:1], ((32, 5, 2),))
    with pytest.raises(ValueError, match="weight"):
        cf.conv_stack(tx, tws[::-1], REST)
    with pytest.raises(ValueError, match="dtype"):
        cf.conv_stack(tx.bfloat16(), tws, REST)
    with pytest.raises(ValueError, match="scale"):
        cf.conv_stack(tx, tws, REST, torch.ones(2, C0), None)
    with pytest.raises(ValueError, match="too short"):
        cf.conv_stack(tx[:, :5], tws, REST)


def test_cpu_path_launches_no_kernel():
    x, ws, _g, _b = _inputs(t=200)
    _build.reset_launches()
    cf.conv_stack(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], REST)
    assert _build.LAUNCHES.get(cf.KERNEL, 0) == 0
