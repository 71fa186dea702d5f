"""Attention forward over (B, T, H, D): ``flash_attention`` and its plain
version.

Counterpart of ``fithubert_tpu/ops/pallas/flash_attention.py:392
flash_attention`` (forward kernel ``_make_fwd_kernel``, ``:64``). q is
pre-scaled by the caller; ``key_padding_mask`` is (B, T) with True at
padding. On a CUDA tensor this launches ``csrc/flash_attention.cu``, which
keeps an fp32 online softmax and also returns the per-row logsumexp
(B, H, T) that a backward needs; on a CPU tensor it runs
``attention_plain``, which mirrors ``_attention_reference`` (``:35-46``) with
an fp32 softmax.

Rows whose keys are all padding differ, as in the JAX package: the kernel
gives 0 and the plain version a uniform softmax over the finite -1e30
logits. Serving never produces such a row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from fithubert_tpu_torch.ops.kernels import _build

KERNEL = "flash_attention_fwd_cuda"
NEG_INF = -1e30
HEAD_DIMS = (40, 64)  # head sizes the kernel is compiled for: student, teacher
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, key_padding_mask, dropout_p) -> None:
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout comes with the port's training slice; serving "
            "runs with dropout_p = 0")
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


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax attention in fp32; returns (out in q's dtype, lse)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    if key_padding_mask is not None:
        lse = lse.masked_fill(key_padding_mask.all(-1)[:, None, None], NEG_INF)
    return out, lse


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
    return fn


def _flash_cuda(q, k, v, key_padding_mask):
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd_cuda is built for head sizes {HEAD_DIMS}, not {d}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need unit stride along D")
    if b * h > 65535:
        raise ValueError("B * H must be at most 65535 (one grid row per (b, h))")
    mask = None if key_padding_mask is None else key_padding_mask.contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    err = _fwd_fn()(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, t, h, *strides,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    _build.count_launch(KERNEL)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None, *,
                    dropout_p: float = 0.0, return_lse: bool = False):
    """Softmax attention of pre-scaled q over k, v, all (B, T, H, D).

    Returns (B, T, H, D) in q's dtype, and the fp32 logsumexp (B, H, T) too
    when ``return_lse``. CUDA tensors run the kernel, CPU tensors the plain
    version; ``dropout_p > 0`` is not implemented yet and raises."""
    _check(q, k, v, key_padding_mask, dropout_p)
    if q.device.type == "cuda":
        with torch.cuda.device(q.device):  # launch on the tensors' card
            out, lse = _flash_cuda(q, k, v, key_padding_mask)
    elif q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, key_padding_mask)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return (out, lse) if return_lse else out
