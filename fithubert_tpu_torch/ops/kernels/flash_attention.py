"""Attention over (B, T, H, D) with probability dropout and its gradient:
``flash_attention`` and the plain versions ``attention_plain`` and
``attention_bwd_plain``.

Counterpart of ``fithubert_tpu/ops/pallas/flash_attention.py:392
flash_attention``: the forward kernel ``_make_fwd_kernel`` (``:64``, K2),
the backward kernels ``_make_bwd_dq_kernel`` (``:127``, K3) and
``_make_bwd_dkv_kernel`` (``:173``, K4), tied together by ``_flash_core``'s
custom VJP (``:271-357``). q is pre-scaled by the caller;
``key_padding_mask`` is (B, T) with True at padding.

On a CUDA tensor the forward launches ``csrc/flash_attention.cu`` (an fp32
online softmax that also returns the per-row logsumexp (B, H, T)) and the
backward launches ``csrc/flash_attention_bwd.cu``: one kernel for dQ and one
for dK and dV. On a CPU tensor both run their plain versions, which mirror
``_attention_reference`` (``:35-46``) with an fp32 softmax and the backward
formulas of ``:295-357``.

Dropout acts on the unnormalised probabilities while the normaliser keeps
the undropped sum (``:100-106``). The keep mask is a pure function of
(seed word 0, seed word 1, z = b * H + h, query row i, key column j):
Philox-4x32-10 on the counter (j >> 2, i, z, 0) under the key (seed 0,
seed 1), word j & 3, kept when its top 24 bits reach floor(p * 2^24) as in
``_keep_mask`` (``:49-60``). Unlike the TPU's per-block streams, this does
not depend on how a kernel tiles, so the forward, the dQ and the dK/dV
kernels and the plain versions all draw the same mask.

Rows whose keys are all padding differ, as in the JAX package: the kernel
gives out = 0 and lse = -1e30, the plain forward a uniform softmax over the
finite -1e30 logits. Both backwards give exactly zero gradients there.
The backward reads the forward's output O in q's dtype (the TPU kernel
keeps it in fp32), so in bf16 delta = rowsum(dO * O) carries O's rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fithubert_tpu_torch.ops.kernels import _build

KERNEL = "flash_attention_fwd_cuda"
KERNEL_DROPOUT = "flash_attention_fwd_dropout_cuda"
KERNEL_DQ = "flash_attention_bwd_dq_cuda"
KERNEL_DKV = "flash_attention_bwd_dkv_cuda"
NEG_INF = -1e30
HEAD_DIMS = (40, 64)  # head sizes the kernels are compiled for: student, teacher
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

Seed = Tuple[int, int]  # two 32-bit words


def _check(q, k, v, key_padding_mask, dropout_p, seed) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and _threshold(dropout_p) == 0:
        # the kernels would drop nothing and skip the 1/(1-p) scale
        raise ValueError(f"dropout_p {dropout_p} is below 2^-24, the finest rate the "
                         "24-bit keep test resolves")
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout needs a seed: two 32-bit words")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k and v must share one (B, T, H, D) shape")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}")
    if key_padding_mask is not None and (
            key_padding_mask.dtype != torch.bool
            or tuple(key_padding_mask.shape) != (q.shape[0], q.shape[1])):
        raise ValueError("key_padding_mask must be a (B, T) bool tensor")
    for t in (k, v) + (() if key_padding_mask is None else (key_padding_mask,)):
        if t.device != q.device:
            raise ValueError("all inputs must lie on one device")


def _threshold(dropout_p: float) -> int:
    """Keep a probability when its 24-bit draw is >= this (``:59``)."""
    return min(int(dropout_p * (1 << 24)), (1 << 24) - 1)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product a * m, for a in
    [0, 2^32) held in int64: 16-bit limbs keep every partial product
    below 2^34."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_lo * m_hi + a_hi * m_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (a_hi * m_hi + (mid >> 16)) & _M32
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed: Seed, rounds: int = 10):
    """Philox-4x32 (Salmon et al., SC'11) in int64 torch ops: the same
    function as ``philox4x32`` in ``csrc/philox.cuh``."""
    k0, k1 = seed[0] & _M32, seed[1] & _M32
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def keep_mask(b: int, h: int, t: int, dropout_p: float, seed: Seed,
              device=None) -> torch.Tensor:
    """(B, H, T, T) bool: True where a probability is kept."""
    z = torch.arange(b * h, device=device, dtype=torch.int64).view(b, h, 1, 1)
    i = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, t, 1)
    j = torch.arange(t, device=device, dtype=torch.int64).view(1, 1, 1, t)
    words = philox4x32(j >> 2, i, z, torch.zeros_like(j), seed)
    sel = (j & 3).expand(b, h, t, t)
    word = torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))
    return (word >> 8) >= _threshold(dropout_p)


def _logits(q, k, key_padding_mask):
    """fp32 logits (B, H, T, T) with masked keys at -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    dropout_p: float = 0.0, seed: Optional[Seed] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax attention in fp32, probabilities dropped by
    ``keep_mask``; returns (out in q's dtype, lse)."""
    logits = _logits(q, k, key_padding_mask)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        b, t, h, _d = q.shape
        keep = keep_mask(b, h, t, dropout_p, seed, q.device)
        probs = probs * keep * (1.0 / (1.0 - dropout_p))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    if key_padding_mask is not None:
        lse = lse.masked_fill(key_padding_mask.all(-1)[:, None, None], NEG_INF)
    return out, lse


def attention_bwd_plain(q, k, v, key_padding_mask, out, lse, dout,
                        dropout_p: float = 0.0, seed: Optional[Seed] = None):
    """(dq, dk, dv) in q's dtype by the formulas of the backward kernels:
    P = exp(s - lse) with masked keys zeroed explicitly, dV = P_dropped^T dO,
    dS = P * (dP_dropped - rowsum(dO * O)), dQ = dS K, dK = dS^T Q."""
    logits = _logits(q, k, key_padding_mask)
    p = torch.exp(logits - lse[..., None])
    if key_padding_mask is not None:
        p = p.masked_fill(key_padding_mask[:, None, None, :], 0.0)
    do32 = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    pv = p
    if dropout_p > 0.0:
        b, t, h, _d = q.shape
        scale = torch.where(keep_mask(b, h, t, dropout_p, seed, q.device),
                            1.0 / (1.0 - dropout_p), 0.0)
        pv, dp = p * scale, dp * scale
    delta = (do32 * out.float()).sum(-1).permute(0, 2, 1)  # (B, H, T)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pv, do32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_uint, ctypes.c_float, ctypes.c_uint,
                                     ctypes.c_uint, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("flash_attention_bwd")
    fns = (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv)
    for fn, n_out in zip(fns, (1, 2)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * (7 + n_out) \
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 9 \
            + [ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    return fns


def _cuda_args(q, k, v, key_padding_mask):
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernels are built for head sizes {HEAD_DIMS}, not {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit stride along D")
    if b * h > 65535:
        raise ValueError("B * H must be at most 65535 (one grid row per (b, h))")
    mask = None if key_padding_mask is None else key_padding_mask.contiguous()
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    return mask, strides


def _dropout_args(dropout_p: float, seed: Optional[Seed]):
    if dropout_p <= 0.0:
        return [0, 1.0, 0, 0]
    return [_threshold(dropout_p), 1.0 / (1.0 - dropout_p), seed[0] & _M32, seed[1] & _M32]


def _flash_cuda(q, k, v, key_padding_mask, dropout_p, seed):
    b, t, h, d = q.shape
    mask, strides = _cuda_args(q, k, v, key_padding_mask)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, t, h, *strides, *_dropout_args(dropout_p, seed),
                    torch.cuda.current_stream(q.device).cuda_stream)
    name = KERNEL_DROPOUT if dropout_p > 0.0 else KERNEL
    _build.check(err, name)
    _build.count_launch(name)
    return out, lse


def _bwd_args(q, k, v, key_padding_mask, lse, dout, delta):
    """The leading arguments both backward kernels share."""
    mask, strides = _cuda_args(q, k, v, key_padding_mask)
    head = [_DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr()]
    return head, [q.shape[0], q.shape[1], q.shape[2], *strides], mask


def _check_bwd(q, dout, lse, delta) -> None:
    b, t, h, _d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_contiguous():
        raise ValueError("dout must be a contiguous (B, T, H, D) tensor in q's dtype")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, T) float32 tensor")


def bwd_dq_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p=0.0, seed=None):
    """K3: dQ (B, T, H, D) in q's dtype. ``delta`` is rowsum(dO * O), (B, H, T)."""
    _check_bwd(q, dout, lse, delta)
    head, tail, _mask = _bwd_args(q, k, v, key_padding_mask, lse, dout, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bwd_fns()[0](*head, dq.data_ptr(), *tail, *_dropout_args(dropout_p, seed),
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL_DQ)
    _build.count_launch(KERNEL_DQ)
    return dq


def bwd_dkv_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p=0.0, seed=None):
    """K4: (dK, dV), each (B, T, H, D) in q's dtype."""
    _check_bwd(q, dout, lse, delta)
    head, tail, _mask = _bwd_args(q, k, v, key_padding_mask, lse, dout, delta)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    err = _bwd_fns()[1](*head, dk.data_ptr(), dv.data_ptr(), *tail,
                        *_dropout_args(dropout_p, seed),
                        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL_DKV)
    _build.count_launch(KERNEL_DKV)
    return dk, dv


def _flash_bwd_cuda(q, k, v, key_padding_mask, out, lse, dout, dropout_p, seed):
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()  # (B, H, T)
    dq = bwd_dq_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed)
    dk, dv = bwd_dkv_cuda(q, k, v, key_padding_mask, lse, dout, delta, dropout_p, seed)
    return dq, dk, dv


def _on_device(fn_cuda, fn_plain, x, *args):
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):  # launch on the tensors' card
            return fn_cuda(*args)
    if x.device.type == "cpu":
        return fn_plain(*args)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {x.device}")


class _FlashAttention(torch.autograd.Function):
    """K2 forward, K3 + K4 backward; saves q, k, v, the mask, O, lse and the
    seed, and regenerates the dropout mask in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_p, seed):
        out, lse = _on_device(_flash_cuda, attention_plain, q,
                              q, k, v, key_padding_mask, dropout_p, seed)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.dropout_p, ctx.seed = dropout_p, seed
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _on_device(_flash_bwd_cuda, attention_bwd_plain, q,
                                q, k, v, mask, out, lse, dout, ctx.dropout_p, ctx.seed)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, *,
                    dropout_p: float = 0.0, seed: Optional[Seed] = None,
                    return_lse: bool = False):
    """Softmax attention of pre-scaled q over k, v, all (B, T, H, D), with
    probability dropout ``dropout_p`` drawn from ``seed`` (two 32-bit
    words). Differentiable in q, k and v.

    Returns (B, T, H, D) in q's dtype, and the fp32 logsumexp (B, H, T) too
    when ``return_lse``. CUDA tensors run the kernels, CPU tensors the plain
    versions."""
    _check(q, k, v, key_padding_mask, dropout_p, seed)
    seed = None if dropout_p == 0.0 else (int(seed[0]) & _M32, int(seed[1]) & _M32)
    out, lse = _FlashAttention.apply(q, k, v, key_padding_mask, float(dropout_p), seed)
    return (out, lse) if return_lse else out
