"""The conv-stack backward kernel's plain version (fithubert_tpu_torch/ops/
kernels/conv_frontend.py ``conv_stack_bwd_plain``, K6) against the JAX
package's ``pallas_stack_bwd`` in interpret mode, and the whole conv_stack
gradient under ``FITHUBERT_CONV_BWD=pallas`` against the default library
recompute: with the GroupNorm prefix, at the release student's spec, with
k < s, k = s and s < k <= 2s layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.conv_frontend_bwd import pallas_stack_bwd
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

torch.set_num_threads(2)

SPEC_SMALL = ((32, 1, 1), (32, 3, 2), (64, 2, 2))  # tests/test_conv_frontend_bwd.py
SPEC_K_EQ_S = ((32, 2, 2), (64, 2, 2))
SPEC_K_LT_S = ((16, 1, 2), (24, 3, 2))
SPEC_STUDENT = ((256, 1, 1),) + ((256, 3, 2),) * 4 + ((512, 1, 1),) + ((512, 2, 2),) * 2

# Norm-wise relative limits of tests/test_conv_frontend_bwd.py:45. fp32: the
# same formulas summed in another order. bf16: the port rounds dz to bf16 as
# the operand of both products (the TPU kernel keeps it fp32), and each side
# rounds z and a once per layer.
LIMIT = {torch.float32: 5e-6, torch.bfloat16: 5e-2}
# The whole backward, kernel path vs the library recompute, fp32: the same
# chain, but the GroupNorm gradient sums ~400 frames in another order
# (tests/test_conv_frontend_bwd.py:111-131).
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(spec, c0=16, b=2, t=200, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, c0)) * 0.5).astype(np.float32)
    ws, cin = [], c0
    for (d, k, _s) in spec:
        ws.append((rng.standard_normal((k, cin, d)) / np.sqrt(k * cin)).astype(np.float32))
        cin = d
    g = rng.standard_normal((b, cf.out_len(t, spec), spec[-1][0])).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return to(x), [to(w) for w in ws], to(g)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("spec", [SPEC_SMALL, SPEC_K_EQ_S], ids=["small", "k_eq_s"])
def test_plain_backward_matches_jax_pallas_stack_bwd(spec, dtype):
    x, ws, g = _inputs(spec, t=256 if spec == SPEC_K_EQ_S else 200, dtype=dtype, seed=7)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda a: jnp.asarray(a.float().numpy(), jd)  # noqa: E731
    want_da0, want_dws = pallas_stack_bwd(j(x), [j(w) for w in ws], j(g), spec, f_tile=8,
                                          interpret=True)
    da0, dws = cf.conv_stack_bwd_plain(x, ws, g, spec)
    assert da0.dtype == torch.float32 and all(dw.dtype == torch.float32 for dw in dws)
    assert _rel(da0.numpy(), want_da0[:, :x.shape[1]]) < LIMIT[dtype]
    for dw, want in zip(dws, want_dws):
        assert dw.shape == want.shape
        assert _rel(dw.numpy(), want) < LIMIT[dtype]


def _stack_grads(x, ws, g, spec, gamma=None, beta=None):
    """d(x, weights[, gamma, beta]) of <conv_stack(...), g>."""
    leaves = [t.clone().requires_grad_() for t in [x, *ws] + ([gamma, beta] if gamma is not None
                                                              else [])]
    xs, wss = leaves[0], leaves[1:1 + len(ws)]
    ss = (None, None)
    if gamma is not None:
        ss = cf.gn_scale_shift(xs, leaves[-2], leaves[-1])
    out = cf.conv_stack(xs, wss, spec, *ss)
    return [t.float() for t in torch.autograd.grad(out, leaves, g)]


@pytest.mark.parametrize("prefix", [True, False], ids=["gn_prefix", "no_prefix"])
@pytest.mark.parametrize("spec", [SPEC_SMALL, SPEC_K_LT_S], ids=["small", "k_lt_s"])
def test_switch_matches_the_library_recompute_fp32(monkeypatch, spec, prefix):
    x, ws, g = _inputs(spec, seed=3)
    rng = np.random.default_rng(4)
    gb = (torch.from_numpy((1 + 0.1 * rng.standard_normal(16)).astype(np.float32)),
          torch.from_numpy((0.1 * rng.standard_normal(16)).astype(np.float32))) if prefix \
        else (None, None)
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "xla")
    want = _stack_grads(x, ws, g, spec, *gb)
    calls = []
    plain = cf.conv_stack_bwd_plain
    monkeypatch.setattr(cf, "conv_stack_bwd_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "pallas")
    got = _stack_grads(x, ws, g, spec, *gb)
    assert calls == [1]
    for name, a, b in zip(["dx"] + [f"dw{i}" for i in range(len(ws))] + ["dgamma", "dbeta"],
                          got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD_TOL)


def test_switch_is_read_when_the_backward_runs(monkeypatch):
    """The forward runs under the default; the backward takes K6 because
    the variable says so by then, as the JAX package reads it in its VJP."""
    x, ws, g = _inputs(SPEC_SMALL)
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "xla")
    xs = x.clone().requires_grad_()
    out = cf.conv_stack(xs, ws, SPEC_SMALL)
    calls = []
    plain = cf.conv_stack_bwd_plain
    monkeypatch.setattr(cf, "conv_stack_bwd_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "Pallas")
    out.backward(g)
    assert calls == [1] and torch.isfinite(xs.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_release_student_spec_matches_the_library_recompute(monkeypatch, dtype):
    """The student's 8 layers (C0 = 128) at a short T, GroupNorm prefix on.
    bf16: both sides round every layer's activations, the library also its
    cotangents; norm-wise within the JAX package's bf16 limit (5e-2)."""
    x, ws, g = _inputs(SPEC_STUDENT, c0=128, b=1, t=700, dtype=dtype, seed=5)
    rng = np.random.default_rng(6)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(128)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.standard_normal(128)).astype(np.float32))
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "xla")
    want = _stack_grads(x, ws, g, SPEC_STUDENT, gamma, beta)
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "pallas")
    got = _stack_grads(x, ws, g, SPEC_STUDENT, gamma, beta)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(i), **GRAD_TOL)
        else:
            assert _rel(a.numpy(), b.numpy()) < LIMIT[torch.bfloat16], i


def test_dw_split_is_fixed_by_the_shapes():
    """The dW reduction's chunks cover every row once, each a whole number
    of stages, fill the card's blocks at most once, and depend on nothing
    but the shapes (bf16 rows are (batch row, 64-frame tile) steps)."""
    for dtype in (torch.bfloat16, torch.float32):
        tile_m, tile_n, depth, blocks = cf.DW_GEOMETRY[dtype]
        for m_red, kdim, n in ((12 * 600, 128, 256), (12 * 10, 1024, 512), (5, 64, 64),
                               (12 * 38399, 768, 256)):
            chunk_len, n_chunks = cf._dw_split(m_red, kdim, n, dtype)
            assert chunk_len % depth == 0
            assert (n_chunks - 1) * chunk_len < m_red <= n_chunks * chunk_len
            tiles = -(-kdim // tile_m) * -(-n // tile_n)
            assert n_chunks == 1 or tiles * n_chunks <= blocks
            assert (chunk_len, n_chunks) == cf._dw_split(m_red, kdim, n, dtype)


@pytest.mark.parametrize("env, device, want", [
    (None, "cuda", "kernel"), ("pallas", "cuda", "kernel"), ("xla", "cuda", "library"),
    (None, "cpu", "library"), ("pallas", "cpu", "kernel"), ("xla", "cpu", "library"),
], ids=lambda v: str(v))
def test_conv_backward_kind_by_variable_and_device(env, device, want):
    """Unset or ``pallas``, K6 on the card; ``xla`` the library recompute;
    unset on the CPU the library, the JAX package's default."""
    assert cf.conv_backward_kind(env, device) == want
    if env is not None:  # any case, as the JAX package reads it
        assert cf.conv_backward_kind(env.upper(), device) == want


def test_unset_variable_on_the_cpu_runs_the_library_recompute(monkeypatch):
    """Without FITHUBERT_CONV_BWD a CPU backward never reaches K6's plain
    version, so the CPU parity tests pin the JAX package's default."""
    x, ws, g = _inputs(SPEC_SMALL)
    monkeypatch.delenv("FITHUBERT_CONV_BWD", raising=False)
    calls = []
    monkeypatch.setattr(cf, "conv_stack_bwd_plain", lambda *a: calls.append(1))
    xs = x.clone().requires_grad_()
    cf.conv_stack(xs, ws, SPEC_SMALL).backward(g)
    assert calls == [] and torch.isfinite(xs.grad).all()
