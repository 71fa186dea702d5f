"""Conv blocks 1..N of the waveform front-end: ``conv_stack`` and its plain
version.

Counterpart of ``fithubert_tpu/ops/pallas/conv_frontend.py``:
``fused_conv_stack`` (``:309``) and ``fused_conv_stack_gn`` (``:397``), the
Pallas kernel ``_make_kernel`` (``:112``). For each layer (d, k, s) of the
spec, ``y = gelu(sum_j tap_j(x) @ W[j])`` with fp32 accumulation, where
``tap_j`` takes input rows ``f*s + j``; GELU is exact in fp32 and tanh in
bf16. An optional per-(batch, channel) prefix ``gelu(x * scale + shift)``
folds the block-0 GroupNorm(C, C) in; ``gn_scale_shift`` computes it as
``_fused_gn_fwd`` does (``:406-418``).

On a CUDA tensor ``conv_stack`` launches ``csrc/conv_frontend.cu`` once per
layer; on a CPU tensor it runs ``conv_stack_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fithubert_tpu_torch.ops.activations import gelu_exact, gelu_tanh
from fithubert_tpu_torch.ops.kernels import _build

Spec = Tuple[Tuple[int, int, int], ...]  # (dim, kernel, stride) per layer
KERNEL = "conv_stack_cuda"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fusable(spec: Spec) -> bool:
    """The reference's tap rule: every layer has k <= 2s."""
    return len(spec) > 0 and all(k <= 2 * s for (_d, k, s) in spec)


def out_len(t: int, spec: Spec) -> int:
    for (_d, k, s) in spec:
        t = (t - k) // s + 1
    return t


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, c) scale and shift of GroupNorm(C, C) over the time axis of
    x (B, T, C): fp32 one-pass moments, returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(1)
    var = ((x32 * x32).mean(1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean * rstd * gamma.float()[None, :]
    return scale.to(x.dtype), shift.to(x.dtype)


def _gelu(dtype: torch.dtype):
    return gelu_exact if dtype == torch.float32 else gelu_tanh


def _check(x: torch.Tensor, weights: Sequence[torch.Tensor], spec: Spec,
           scale: Optional[torch.Tensor], shift: Optional[torch.Tensor]) -> None:
    if not fusable(spec):
        raise ValueError(f"conv_stack needs k <= 2s for every layer: {spec}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv_stack takes float32 or bfloat16, got {x.dtype}")
    if len(weights) != len(spec):
        raise ValueError("one weight per layer of the spec")
    c_in = x.shape[-1]
    for w, (d, k, _s) in zip(weights, spec):
        if tuple(w.shape) != (k, c_in, d):
            raise ValueError(f"weight {tuple(w.shape)} != {(k, c_in, d)}")
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError("weights must match x in dtype and device")
        c_in = d
    if (scale is None) != (shift is None):
        raise ValueError("pass both scale and shift, or neither")
    if scale is not None:
        for t in (scale, shift):
            if tuple(t.shape) != (x.shape[0], x.shape[-1]) or t.dtype != x.dtype \
                    or t.device != x.device:
                raise ValueError("scale/shift must be (B, C0) in x's dtype and device")
    if out_len(x.shape[1], spec) < 1:
        raise ValueError(f"input of {x.shape[1]} frames is too short for {spec}")


def conv_stack_plain(x: torch.Tensor, weights: Sequence[torch.Tensor], spec: Spec,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Strided ``F.conv1d`` + GELU per layer, as ``_reference_stack``
    (``conv_frontend.py:242-259``); intermediates in x's dtype."""
    gelu = _gelu(x.dtype)
    if scale is not None:
        x = gelu(x.float() * scale.float()[:, None] + shift.float()[:, None]).to(x.dtype)
    h = x.transpose(1, 2)
    for w, (_d, _k, s) in zip(weights, spec):
        h = gelu(F.conv1d(h, w.permute(2, 1, 0), stride=s))
    return h.transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _conv_layer_fn():
    fn = _build.load("conv_frontend").conv_layer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return fn


def _conv_stack_cuda(x, weights, spec, scale, shift) -> torch.Tensor:
    fn = _conv_layer_fn()
    vec = 16 // x.element_size()  # the kernel moves 16-byte vectors along C
    if any(c % vec for c in [x.shape[-1]] + [d for (d, _k, _s) in spec]):
        raise ValueError(f"conv_stack_cuda needs every width to be a multiple of {vec}")
    if not x.is_contiguous() or (scale is not None and not (
            scale.is_contiguous() and shift.is_contiguous())):
        raise ValueError("conv_stack_cuda needs contiguous x, scale and shift")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b = x.shape[0]
    h = x
    for i, (w, (d, k, s)) in enumerate(zip(weights, spec)):
        wt = w.permute(2, 0, 1).contiguous()  # (C_out, k, C_in): rows of K = k*C_in
        t_in, c_in = h.shape[1], h.shape[2]
        t_out = (t_in - k) // s + 1
        y = torch.empty((b, t_out, d), dtype=x.dtype, device=x.device)
        prefix = scale is not None and i == 0
        err = fn(_DTYPE_CODE[x.dtype], h.data_ptr(), wt.data_ptr(),
                 scale.data_ptr() if prefix else None,
                 shift.data_ptr() if prefix else None,
                 y.data_ptr(), b, t_in, c_in, t_out, d, k, s, stream)
        _build.check(err, KERNEL)
        _build.count_launch(KERNEL)
        h = y
    return h


def conv_stack(x: torch.Tensor, weights: Sequence[torch.Tensor], spec: Spec,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, C0) -> (B, T_out, C_last) through the conv + GELU stack.

    weights[i] is (k, C_in, C_out) in x's dtype; scale and shift, if given,
    are (B, C0) in x's dtype. CUDA tensors run the kernel, CPU tensors the
    plain version."""
    _check(x, weights, spec, scale, shift)
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):  # launch on the tensors' card
            return _conv_stack_cuda(x, weights, spec, scale, shift)
    if x.device.type == "cpu":
        return conv_stack_plain(x, weights, spec, scale, shift)
    raise ValueError(f"conv_stack runs on cuda or cpu, not {x.device}")
