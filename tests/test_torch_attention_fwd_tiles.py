"""The bf16 attention forward's arithmetic (fithubert_tpu_torch/ops/kernels/
flash_attention.py ``attention_fwd_tiles_plain``) as the card's kernel
computes it: the online softmax over key tiles of ``FWD_KEY_TILE`` in fp32,
P rounded to q's dtype against each tile's running max before P V, O
rescaled by alpha. Held to the JAX package's flash_attention forward at p =
0 (its Pallas kernel in interpret mode where T is a multiple of 64 from 128
on, its XLA path elsewhere), since the TPU's dropout streams cannot be
reproduced, and to ``attention_plain`` with dropout on the same keep mask.
Also the kernel's launch geometry, the host copy of its Philox draws, and
the wrapper's refusals without a card."""

import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas.flash_attention import _flash_core_fwd
from fithubert_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels import philox
from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

torch.set_num_threads(2)

# fp32: the same online-softmax sums in another order (the tolerance of
# tests/test_torch_flash_attention.py, which holds the plain forward to the
# JAX kernel).
F32_ATOL = 2e-5
# bf16: max |error| / max |reference| (the bound of
# tests/test_torch_attention_grad.py): the JAX kernel rounds P to bf16 as
# the tiles do, its XLA path also keeps bf16 logits and softmax.
BF16_REL = 3e-2
# With dropout against attention_plain: the plain forward keeps P in fp32
# where the tiles round it to bf16 (2^-9 relative), which averages out over
# the key sum to about one bf16 step of the output (the card's limit for K2
# against attention_plain, chip_smoke.TOL).
BF16_TOL = dict(atol=1e-2, rtol=1e-2)

HEAD_SIZES = [16, 40, 64, 128]
# T = 1, 63, 64, 65 and 299 take JAX's XLA path (T < 128 or no multiple of
# 64), T = 128 and 192 its Pallas kernel in interpret mode
LENGTHS = [1, 63, 64, 65, 128, 192, 299]


def _inputs(b, t, h, d, pad_row=False, seed=0):
    rng = np.random.default_rng(seed + 1000 * t + d)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    q *= d ** -0.5  # the caller pre-scales q
    lengths = rng.integers(max(1, t // 3), t + 1, size=b)
    lengths[0] = t
    mask = np.arange(t)[None, :] >= lengths[:, None]
    if pad_row:
        mask[-1] = True
    return q, k, v, mask


def _tiles(q, k, v, mask, dtype, dropout_p=0.0, seed=None):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    return fa.attention_fwd_tiles_plain(tq, tk, tv, torch.from_numpy(mask), dropout_p, seed)


@functools.lru_cache(maxsize=None)
def _jax_out(b, t, h, d, dtype):
    q, k, v, mask = _inputs(b, t, h, d)
    jd = jnp.dtype(dtype)
    out = j_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("t", LENGTHS, ids=[f"t{t}" for t in LENGTHS])
@pytest.mark.parametrize("d", HEAD_SIZES, ids=[f"d{d}" for d in HEAD_SIZES])
def test_tiles_match_jax_forward_fp32(d, t):
    b, h = 2, 2
    q, k, v, mask = _inputs(b, t, h, d)
    got, lse = _tiles(q, k, v, mask, torch.float32)
    assert got.dtype == torch.float32 and lse.shape == (b, h, t)
    np.testing.assert_allclose(got.numpy(), _jax_out(b, t, h, d, "float32"), atol=F32_ATOL)
    # lse against the logsumexp of the masked fp32 logits
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    logits = np.where(mask[:, None, None, :], -np.inf, logits)
    want = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("t", LENGTHS, ids=[f"t{t}" for t in LENGTHS])
@pytest.mark.parametrize("d", HEAD_SIZES, ids=[f"d{d}" for d in HEAD_SIZES])
def test_tiles_match_jax_forward_bf16(d, t):
    b, h = 2, 2
    q, k, v, mask = _inputs(b, t, h, d)
    got, _lse = _tiles(q, k, v, mask, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax_out(b, t, h, d, "bfloat16")
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < BF16_REL, rel


@pytest.mark.parametrize("d", [40, 64])
def test_tiles_lse_matches_the_jax_kernel(d):
    """The Pallas kernel's own logsumexp (T = 128, its interpret mode)."""
    b, t, h = 2, 128, 2
    q, k, v, mask = _inputs(b, t, h, d)
    _out, res = _flash_core_fwd(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                jnp.zeros((2,), jnp.int32), 0.0, 64, 64, True)
    _got, lse = _tiles(q, k, v, mask, torch.float32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[5]).reshape(b, h, t), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [1, 63, 128, 299], ids=lambda t: f"t{t}")
def test_a_fully_padded_row_gives_zero_and_lse_minus_1e30(t, dtype):
    """Exactly, as the kernel (and the TPU kernel, :116-122) gives it, with
    and without dropout."""
    q, k, v, mask = _inputs(3, t, 2, 40, pad_row=True)
    for p, seed in ((0.0, None), (0.1, seed_tensor(9, 10))):
        out, lse = _tiles(q, k, v, mask, dtype, p, seed)
        assert (out[-1] == 0).all()
        assert (lse[-1] == fa.NEG_INF).all()
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [64, 150, 299], ids=lambda t: f"t{t}")
def test_tiles_match_the_plain_forward_with_dropout(t, dtype):
    """p = 0.1 on the same keep mask; lse stays the undropped one, equal to
    the forward's without dropout."""
    q, k, v, mask = _inputs(3, t, 2, 40, pad_row=True)
    seed = seed_tensor(0x1234, 0x5678)
    got, lse = _tiles(q, k, v, mask, dtype, 0.1, seed)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    want, want_lse = fa.attention_plain(tq, tk, tv, tm, 0.1, seed)
    rows = ~tm.all(-1)
    tol = dict(atol=F32_ATOL, rtol=1e-5) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)
    torch.testing.assert_close(lse[rows], want_lse[rows], atol=1e-5, rtol=1e-6)
    _out0, lse0 = _tiles(q, k, v, mask, dtype)
    assert torch.equal(lse, lse0)
    # the mask really drops: without it the outputs differ
    assert not torch.allclose(got[rows].float(), _out0[rows].float(), atol=1e-3)


def test_tiles_round_p_against_each_tiles_running_max():
    """In bf16 the tiles differ from one rounding of the final softmax (the
    plain forward's fp32 P) by P's roundings, and equal a recomputation
    that rounds exp(S - m_j) to bf16 tile by tile."""
    q, k, v, mask = _inputs(2, 150, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got, _ = fa.attention_fwd_tiles_plain(tq, tk, tv, torch.from_numpy(mask))
    s = torch.einsum("bqhd,bkhd->bhqk", tq.float(), tk.float())
    s = s.masked_fill(torch.from_numpy(mask)[:, None, None, :], fa.NEG_INF)
    m = torch.full(s.shape[:3], fa.NEG_INF)
    acc = torch.zeros(*s.shape[:3], 64)
    l_ = torch.zeros(s.shape[:3])
    for j in range(0, 150, fa.FWD_KEY_TILE):
        sj = s[..., j:j + fa.FWD_KEY_TILE]
        m_new = torch.maximum(m, sj.amax(-1))
        p = torch.exp(sj - m_new[..., None])
        p = p.masked_fill(torch.from_numpy(mask)[:, None, None, j:j + fa.FWD_KEY_TILE], 0.0)
        alpha = torch.exp(m - m_new)
        l_ = l_ * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), tv[:, j:j + fa.FWD_KEY_TILE].float())
        m = m_new
    want = (acc / l_[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape, blocks", [
    ((32, 399, 12, 40), 2688),  # serving, B = 32 x 16 s
    ((12, 599, 12, 64), 1440),  # the teacher's attention of a release step
    ((12, 299, 12, 40), 720),   # the student's
    ((8, 600, 12, 64), 960),    # the ex student's
    ((3, 299, 12, 40), 180),    # the abs conformer's, one microbatch
    ((12, 599, 16, 64), 1920),  # the wav2vec2-Large teacher's
    ((12, 599, 6, 64), 720),    # one model rank of the teacher's, tensor parallel
    ((1, 1, 1, 16), 1),
], ids=["serving", "teacher", "student", "ex", "conformer_abs", "large", "tp_teacher", "t1"])
def test_the_forward_launches_one_block_per_query_tile_and_head(shape, blocks):
    b, t, h, d = shape
    n_qt, got, _smem = fa.fwd_launch_geometry(b, t, h, d)
    assert n_qt == -(-t // fa.FWD_QUERY_TILE) and got == blocks
    assert fa.FWD_QUERY_TILE == fa.FWD_KEY_TILE == 64


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_the_forward_shares_an_sm_within_its_shared_memory(d):
    """Every compiled head size takes less than the 227 KB a block may use,
    and its blocks an SM (three at D <= 64, where the register plan gives 80
    a thread, two above at 128) fit the SM's 228 KB with the 1 KB each
    block reserves."""
    _n_qt, _blocks, smem = fa.fwd_launch_geometry(1, 64, 1, d)
    assert smem < 227 * 1024
    blocks_per_sm = 65536 // (256 * fa.FWD_REGS[d])
    assert blocks_per_sm == (3 if d <= 64 else 2)
    assert blocks_per_sm * (smem + 1024) <= 228 * 1024


def test_the_geometry_refuses_head_sizes_not_compiled():
    with pytest.raises(ValueError, match="head sizes"):
        fa.fwd_launch_geometry(1, 64, 1, 12)


def test_the_forward_launch_names_stay():
    """Every launch table counts K2 under these two names."""
    assert fa.KERNEL == "flash_attention_fwd_cuda"
    assert fa.KERNEL_DROPOUT == "flash_attention_fwd_dropout_cuda"


@pytest.mark.parametrize("call", ["kernel"])
def test_the_forward_wrappers_refuse_cpu_tensors(call):
    """The kernel's launcher takes CUDA tensors only: nothing falls back to
    a plain version, and nothing is built or counted."""
    q = torch.zeros(1, 64, 2, 40, dtype=torch.bfloat16)
    calls = {"kernel": lambda: fa._fwd_kernel(q, q, q, None, 0.0, None)}
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[call]()
    assert _build.LAUNCHES == before


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
    const uint4 a = PhiloxQuery(i, z, s0, s1).draw(x);
    const uint4 b = philox4x32(make_uint4(x, i, z, 0u), s0, s1);
    printf("%u %u %u %u %u %u %u %u\n", a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w);
  }
}
"""


def test_philox_query_draws_the_words_of_philox4x32(tmp_path):
    """The forward's PhiloxQuery (the halves of its first two rounds free of
    the key group, and the key schedule, taken out of the loop) against
    philox4x32 in the same header and against philox.py, on random and edge
    counters: the card's keep mask must not change."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the host copy of csrc/philox.cuh"
    src = tmp_path / "philox_query.cc"
    src.write_text(_PHILOX_HOST)
    exe = tmp_path / "philox_query"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", _build.CSRC, "-o", str(exe), str(src)],
                   check=True)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 2 ** 32, size=(2000, 5), dtype=np.uint64)
    rows[:8] = [[0, 0, 0, 0, 0], [2 ** 32 - 1] * 5, [1, 2, 3, 4, 5], [150, 299, 143, 7, 9],
                [0, 2 ** 32 - 1, 0, 2 ** 32 - 1, 0], [74, 0, 95, 123456789, 987654321],
                [2 ** 31, 2 ** 31, 2 ** 31, 2 ** 31, 2 ** 31], [149, 598, 383, 0, 2 ** 32 - 1]]
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
