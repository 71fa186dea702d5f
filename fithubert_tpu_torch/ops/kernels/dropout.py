"""Seeded elementwise dropout whose backward regenerates the keep mask from
the seed: ``seeded_dropout`` and its plain version ``seeded_dropout_plain``.

Counterpart of ``fithubert_tpu/ops/pallas/dropout.py:152 seeded_dropout``:
the Pallas kernel ``_make_kernel`` (``:54``, K5) run by ``_run`` (``:75``),
and the custom VJP (``:96-111``) that applies the same kernel to the
cotangent, since dropout's Jacobian is the diagonal mask. The autograd
Function here saves only the seed: no mask is stored between the passes.

The output is ``where(keep, x * 1/(1-p), 0)`` in x's dtype, computed in
fp32. The keep mask is a pure function of (seed word 0, seed word 1, flat
element index e): word e & 3 of Philox-4x32-10 on the counter
(e >> 2, e >> 34, 0, 0), kept when its top 24 bits reach floor(p * 2^24)
(``philox.py``, ``csrc/philox.cuh``). The TPU kernel seeds its hardware
generator per grid block, whose bits no other device reproduces; the JAX
function is matched by the keep-rate, the scale and the regenerated mask.

On a CUDA tensor the wrapper launches ``csrc/seeded_dropout.cu``; on a CPU
tensor it runs ``seeded_dropout_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels.philox import (
    M32,
    Seed,
    check_rate,
    check_seed,
    keep_bits,
    key_words,
    philox4x32,
    pick_word,
    threshold,
)

KERNEL = "seeded_dropout_cuda"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def keep_at(e: torch.Tensor, p: float, seed: Seed) -> torch.Tensor:
    """True where the flat elements of int64 indices ``e`` are kept."""
    g = e >> 2
    zero = torch.zeros((), device=e.device, dtype=torch.int64)
    words = philox4x32(g & M32, g >> 32, zero, zero, key_words(seed))
    return keep_bits(pick_word(words, e & 3), p)


def keep_flat(n: int, p: float, seed: Seed, device=None) -> torch.Tensor:
    """(n,) bool: True where flat element e < n is kept."""
    return keep_at(torch.arange(n, device=device, dtype=torch.int64), p, seed)


def seeded_dropout_plain(x: torch.Tensor, seed: Seed, p: float) -> torch.Tensor:
    """``where(keep_flat, x * 1/(1-p), 0)`` in fp32, returned in x's dtype."""
    keep = keep_flat(x.numel(), p, seed, x.device).view(x.shape)
    # x * 1/(1-p) with the scale rounded to fp32 first, as the kernel does
    inv = float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))
    return torch.where(keep, x.float() * inv, 0.0).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _dropout_fn():
    fn = _build.load("seeded_dropout").seeded_dropout
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_uint, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


@_build.one_launch(KERNEL)
def seeded_dropout_cuda(x: torch.Tensor, seed: Seed, p: float) -> torch.Tensor:
    """K5 on a CUDA tensor: one launch. ``seed`` is a (2,) int32 tensor
    on x's card, read by the kernel."""
    seed = check_seed(seed, x.device)
    x = x.contiguous()
    y = torch.empty_like(x)
    group = 4 * x.element_size()  # a thread's four elements, loaded as one vector
    vec = int(x.data_ptr() % group == 0 and y.data_ptr() % group == 0)
    with torch.cuda.device(x.device):
        err = _dropout_fn()(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), x.numel(),
                            threshold(p), 1.0 / (1.0 - p), seed.data_ptr(), vec,
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, KERNEL)
    _build.count_launch(KERNEL)
    return y


def _run(x: torch.Tensor, seed: Seed, p: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return seeded_dropout_cuda(x, seed, p)
    if x.device.type == "cpu":
        return seeded_dropout_plain(x, seed, p)
    raise ValueError(f"seeded_dropout runs on cuda or cpu, not {x.device}")


class _SeededDropout(torch.autograd.Function):
    """K5 forward; the backward runs the same kernel on the cotangent."""

    @staticmethod
    def forward(ctx, x, seed, p):
        ctx.seed, ctx.p = seed, p
        return _run(x, seed, p)

    @staticmethod
    def backward(ctx, grad):
        return _run(grad, ctx.seed, ctx.p), None, None


def seeded_dropout(x: torch.Tensor, seed: Seed, p: float) -> torch.Tensor:
    """Drop each element of x with probability p, scale the rest by
    1/(1-p); the mask comes from ``seed`` (a (2,) int32 tensor on x's
    device holding two 32-bit words, ``philox.seed_tensor``). x is float32
    or bfloat16; p = 0
    returns x. Differentiable in x."""
    check_rate(p)
    if p == 0.0:
        return x
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"seeded_dropout takes float32 or bfloat16, got {x.dtype}")
    if seed is None:
        raise ValueError("dropout needs a seed: a (2,) int32 tensor")
    return _SeededDropout.apply(x, check_seed(seed, x.device), float(p))
