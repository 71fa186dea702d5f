"""The fused attention backward's arithmetic (fithubert_tpu_torch/ops/
kernels/flash_attention.py ``attention_bwd_tiles_plain``, ``dq_sum_plain``)
as the card's kernels compute it: dQ summed from fp32 partials of each key
tile in tile order, dS entering dQ in two parts (hi and lo, each rounded to
q's dtype), P_dropped and dS rounded before dV and dK. Held to jax.grad
through the JAX package's flash_attention (its Pallas backward in interpret
mode, or its XLA path where T is no multiple of 64) at p = 0, since the
TPU's dropout streams cannot be reproduced, and to ``attention_bwd_plain``
with dropout on the same keep mask. Also the wrapper's scratch arithmetic,
the backward's launch names, and its refusals without a card."""

import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels import philox
from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

torch.set_num_threads(2)

# fp32: the same sums in another order (blockwise kernels, key tiles vs
# einsum); the hi / lo split is exact in fp32 (lo = 0).
F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 against the JAX kernels, which round P, dS and the products to bf16
# before each matmul: max |error| / max |reference| (the bound of
# tests/test_torch_attention_grad.py).
BF16_REL = 3e-2
# |tiles - plain| <= atol + rtol * |plain|: the plain backward keeps fp32
# where the tiles round P_dropped and dS to bf16 (2^-9 relative each), which
# averages out over the key sum to about one bf16 step of a gradient.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)

# (B, T, H, D, a fully padded row): T = 33, 63, 65 and 130 take JAX's XLA
# path, whose softmax over a fully padded row is uniform, so only T = 128
# (its Pallas kernels) has one.
CASES = [(2, 63, 2, 40, False), (2, 65, 2, 64, False), (1, 65, 3, 16, False),
         (2, 128, 2, 40, True), (2, 128, 2, 16, True), (2, 33, 2, 32, False),
         (2, 130, 2, 48, False)]
IDS = ["t63_d40", "t65_d64", "t65_d16", "t128_d40_padrow", "t128_d16_padrow", "t33_d32",
       "t130_d48"]


def _inputs(b, t, h, d, pad_row):
    rng = np.random.default_rng(b * 1000 + t * 10 + d)
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    lengths = rng.integers(t // 3, t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]
    if pad_row:
        mask[-1] = True
    return q, k, v, g, mask


@functools.lru_cache(maxsize=None)
def _jax_grads(case, dtype):
    q, k, v, g, mask = _inputs(*case)

    def f(q_, k_, v_):
        out = j_flash(q_, k_, v_, jnp.asarray(mask), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _tiles_grads(q, k, v, g, mask, dtype, dropout_p=0.0, seed=None):
    """(dq, dk, dv) by the fused backward's arithmetic, from the port's plain
    forward on the same inputs."""
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = fa.attention_plain(tq, tk, tv, tm, dropout_p, seed)
    delta = fa.bwd_prep_plain(out, tg)
    parts, dk, dv = fa.attention_bwd_tiles_plain(tq, tk, tv, tm, lse, tg, delta, dropout_p,
                                                 seed)
    assert parts.shape == fa.dq_scratch_shape(*q.shape)
    assert parts.dtype == torch.float32
    return fa.dq_sum_plain(parts, dtype), dk, dv


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiles_match_jax_grad_fp32(case):
    q, k, v, g, mask = _inputs(*case)
    want = _jax_grads(case, "float32")
    got = _tiles_grads(q, k, v, g, mask, torch.float32)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), y, err_msg=f"d{name}", **F32_TOL)
    if case[-1]:
        assert all((x[-1] == 0).all() for x in got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiles_match_jax_grad_bf16(case):
    q, k, v, g, mask = _inputs(*case)
    want = _jax_grads(case, "bfloat16")
    got = _tiles_grads(q, k, v, g, mask, torch.bfloat16)
    for name, x, y in zip("qkv", got, want):
        rel = np.abs(x.float().numpy() - y).max() / np.abs(y).max()
        assert rel < BF16_REL, (f"d{name}", rel)
    if case[-1]:
        assert all((x[-1] == 0).all() for x in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [64, 150], ids=["t64", "t150"])
def test_tiles_match_the_plain_backward_with_dropout(t, dtype):
    """p = 0.1 on the same keep mask, T = 64 (one key tile) and 150 (three,
    the last ragged), a fully padded row: zero gradients there on both
    sides."""
    q, k, v, g, mask = _inputs(3, t, 2, 40, True)
    seed = seed_tensor(0x1234, 0x5678)
    got = _tiles_grads(q, k, v, g, mask, dtype, 0.1, seed)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = fa.attention_plain(tq, tk, tv, tm, 0.1, seed)
    want = fa.attention_bwd_plain(tq, tk, tv, tm, out, lse, tg, 0.1, seed)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for name, x, y in zip("qkv", got, want):
        torch.testing.assert_close(x.float(), y.float(), msg=f"d{name}", **tol)
        assert (x[-1] == 0).all()


def test_dq_sum_adds_the_partials_in_key_tile_order():
    """((p0 + p1) + p2), rounded once: not the same bits as another order."""
    parts = torch.tensor([[1.0], [2.0 ** -24], [2.0 ** -24]]).reshape(3, 1, 1, 1, 1)
    assert fa.dq_sum_plain(parts, torch.float32).item() == 1.0
    assert fa.dq_sum_plain(parts.flip(0), torch.float32).item() == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("t, tiles", [(1, 1), (63, 1), (64, 1), (65, 2), (299, 5), (600, 10)])
def test_scratch_has_one_slice_per_key_tile(t, tiles):
    assert fa.BWD_KEY_TILE == 64
    assert fa.dq_scratch_shape(2, t, 3, 40) == (tiles, 2, t, 3, 40)


def test_the_backward_launch_names():
    names = fa.BWD_KERNELS + (fa.KERNEL_DQ_F32, fa.KERNEL_DKV_F32)
    assert len(set(names + (fa.KERNEL, fa.KERNEL_DROPOUT))) == len(names) + 2
    assert fa.BWD_KERNELS == (fa.KERNEL_BWD_PREP, fa.KERNEL_BWD, fa.KERNEL_DQ_SUM)
    assert all(n.startswith("flash_attention_bwd") and n.endswith("_cuda") for n in names)


def _cpu_case(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(2, 64, 2, 40, generator=g).to(dtype) for _ in range(4))
    mask = torch.zeros(2, 64, dtype=torch.bool)
    out, lse = fa.attention_plain(q, k, v, mask)
    return q, k, v, mask, out.contiguous(), lse, dout


@pytest.mark.parametrize("call", ["prep", "fused", "dq_sum", "whole"])
def test_the_wrappers_refuse_cpu_tensors(call):
    """Each launches a CUDA kernel or raises: nothing falls back to a plain
    version, and nothing is built or counted."""
    q, k, v, mask, out, lse, dout = _cpu_case()
    delta = fa.bwd_prep_plain(out, dout)
    calls = {
        "prep": lambda: fa.bwd_prep_cuda(out, dout),
        "fused": lambda: fa.bwd_fused_cuda(q, k, v, mask, lse, dout, delta),
        "dq_sum": lambda: fa.dq_sum_cuda(torch.zeros(2, 2, 64, 2, 40)),
        "whole": lambda: fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, 0.0, None),
    }
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[call]()
    assert _build.LAUNCHES == before


def test_the_wrappers_check_their_arguments():
    q, k, v, mask, out, lse, dout = _cpu_case(torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.bwd_fused_cuda(q, k, v, mask, lse, dout, fa.bwd_prep_plain(out, dout))
    with pytest.raises(ValueError, match="one float32 or bfloat16 dtype"):
        fa.bwd_prep_cuda(out, dout.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fa.bwd_prep_cuda(out.transpose(1, 2), dout.transpose(1, 2))
    with pytest.raises(ValueError, match="float32 tensor"):
        fa.dq_sum_cuda(torch.zeros(2, 2, 64, 2, 40, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.dq_sum_cuda(torch.zeros(2, 2, 64, 2, 12))


def test_padded_head_sizes_keep_the_tiles_arithmetic():
    """D = 12 through padded_attention_bwd around the tiles' plain versions
    (as the card pads to the compiled 16) equals the unpadded tiles."""
    q, k, v, g, mask = _inputs(2, 70, 2, 12, False)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = fa.attention_plain(tq, tk, tv, tm)
    delta = fa.bwd_prep_plain(out, tg)

    def bwd(q_, k_, v_, m_, lse_, dout_, delta_, p, seed):
        parts, dk, dv = fa.attention_bwd_tiles_plain(q_, k_, v_, m_, lse_, dout_, delta_, p,
                                                     seed)
        return fa.dq_sum_plain(parts, q_.dtype), dk, dv

    got = fa.padded_attention_bwd(bwd, tq, tk, tv, tm, lse, tg, delta, 0.0, None)
    want = bwd(tq, tk, tv, tm, lse, tg, delta, 0.0, None)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        torch.testing.assert_close(x.float(), y.float(), atol=1e-5, rtol=1e-5)


# csrc/philox.cuh compiled for the host: its device qualifiers, uint4 and
# __umulhi given host meanings
_PHILOX_HOST = r"""
#include <cstdint>
#include <cstdio>
#define __device__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
#include "philox.cuh"
int main() {
  unsigned x, i, z, s0, s1;
  while (scanf("%u %u %u %u %u", &x, &i, &z, &s0, &s1) == 5) {
    const uint4 a = PhiloxRow(x, z, s0, s1).draw(i);
    const uint4 b = philox4x32(make_uint4(x, i, z, 0u), s0, s1);
    printf("%u %u %u %u %u %u %u %u\n", a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w);
  }
}
"""


def test_philox_row_draws_the_words_of_philox4x32(tmp_path):
    """The fused backward's PhiloxRow (its first three rounds' work that is
    free of the query row, and the key schedule, taken out of the loop)
    against philox4x32 in the same header and against philox.py, on random
    and edge counters: the card's keep mask must not change."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the host copy of csrc/philox.cuh"
    src = tmp_path / "philox_row.cc"
    src.write_text(_PHILOX_HOST)
    exe = tmp_path / "philox_row"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", _build.CSRC, "-o", str(exe), str(src)],
                   check=True)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, size=(2000, 5), dtype=np.uint64)
    rows[:8] = [[0, 0, 0, 0, 0], [2 ** 32 - 1] * 5, [1, 2, 3, 4, 5], [150, 299, 143, 7, 9],
                [0, 2 ** 32 - 1, 0, 2 ** 32 - 1, 0], [74, 0, 95, 123456789, 987654321],
                [2 ** 31, 2 ** 31, 2 ** 31, 2 ** 31, 2 ** 31], [7, 599, 1, 0, 2 ** 32 - 1]]
    out = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, r)) for r in rows),
                         capture_output=True, text=True, check=True).stdout.split()
    got = np.array(out, dtype=np.uint64).reshape(-1, 8)
    assert len(got) == len(rows)
    np.testing.assert_array_equal(got[:, :4], got[:, 4:])
    t = torch.from_numpy(rows.astype(np.int64))
    words = philox.philox4x32(t[:, 0], t[:, 1], t[:, 2], torch.zeros_like(t[:, 0]),
                              (t[:, 3], t[:, 4]))
    want = torch.stack(words, 1).numpy().astype(np.uint64)
    np.testing.assert_array_equal(got[:, :4], want)
