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
layer; on a CPU tensor it runs ``conv_stack_plain``. In bf16 the layer is a
wgmma GEMM fed by TMA, whose A operand is two strided views of the layer's
input (``a_operand_view``); the kernels take widths that are multiples of
``WIDTH_MULTIPLE`` (``check_widths``). Other widths are zero-padded on the
way in and cropped on the way out (``padded_conv_stack``,
``padded_conv_stack_bwd``), as the Pallas stack takes any width: a padded
input channel meets zero weight rows, a padded output channel has zero
weights, so its pre-activation is 0 and gelu(0) = 0 feeds the next layer
zeros; the prefix's padded channels get scale and shift 0, so they are
gelu(0) = 0 too. The bf16 GroupNorm prefix is a kernel of its own,
``gn_prefix_cuda``, launched before the first layer. The TMA tensor maps
are encoded on the host at each launch from that call's addresses and
passed by value (``__grid_constant__``); nothing outlives the call, so a
CUDA graph keeps the maps of the buffers it captured, which its replays
reuse.

Its gradient has the JAX package's two backwards. ``conv_backward_kind``,
a function of ``FITHUBERT_CONV_BWD`` (the JAX package's variable, read at
backward time) and the tensors' device, picks one:
- ``kernel``: the conv-stack backward kernel K6 (``conv_frontend_bwd.py:290
  pallas_stack_bwd``), ``csrc/conv_frontend_bwd.cu`` on a CUDA tensor and
  ``conv_stack_bwd_plain`` on a CPU tensor. As in the JAX package's
  ``_fused_gn_bwd`` (``:426-443``), the GroupNorm + GELU prefix
  a0 = gelu(x * scale + shift) is materialised once, K6 runs on a0, and
  autograd carries da0 through the prefix into x, scale and shift.
- ``library``: the counterpart of ``_fused_bwd`` (``:353-357``) and
  ``_fused_gn_bwd`` (``:444-449``), which recompute the stack with XLA
  convolutions and differentiate that. Here the recompute is ``F.conv1d``
  with the same GELU flavour, library convolution as it is XLA's there.
``pallas`` selects the kernel and ``xla`` the library, as in the JAX
package. Unset, the two packages differ on the card: the port runs K6 there
(2.3x faster than the recompute on an H100), where the JAX package's
default is the recompute, set because its Pallas kernel lost on a TPU v5e
(``_pallas_bwd_enabled``, ``:322-335``). On a CPU tensor the unset default
stays the recompute, so the CPU parity tests pin the JAX package's
default. Either way autograd then carries dscale and dshift through
``gn_scale_shift`` into x, gamma and beta, which gives the GroupNorm
gradient that ``_gn_prefix_bwd`` (``:216-236``) writes by hand.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fithubert_tpu_torch.ops.activations import gelu_exact, gelu_tanh
from fithubert_tpu_torch.ops.kernels import _build

Spec = Tuple[Tuple[int, int, int], ...]  # (dim, kernel, stride) per layer
KERNEL = "conv_stack_cuda"
KERNEL_BWD = "conv_stack_bwd_cuda"
KERNEL_PREFIX = "gn_prefix_cuda"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# What every width (C0 and each layer's d) must be a multiple of on the card:
# bf16 K chunks are 64 elements, one 128-byte swizzled TMA row, and must lie
# in one tap group; fp32 tiles move 16-byte vectors along C.
WIDTH_MULTIPLE = {torch.float32: 4, torch.bfloat16: 64}


class AView(NamedTuple):
    """The A operand of one bf16 layer as views of its input X (B, T_in,
    C_in): group g is the (B, T_out, cols_g) view of X's storage at element
    offset off_g (off_0 = 0) with strides (batch_stride, row_stride, 1), and
    A[b, f] = [group 0 | group 1] is the K = k * C_in row of frame f."""
    off1: int
    row_stride: int
    batch_stride: int
    cols0: int
    cols1: int


def a_operand_view(t_in: int, c_in: int, k: int, s: int) -> AView:
    """X[b] seen as rows of s * C_in elements (the TPU kernel's pair rows,
    ``conv_frontend.py:100-103``): taps j < s are the first min(k, s) * C_in
    elements of row f, taps j >= s the first (k - s) * C_in of row f + 1.
    Neither view overlaps itself, and none reads past frame f * s + k - 1 of
    its own batch row, so the partial last row at odd T_in is read only where
    it holds valid frames."""
    return AView(off1=s * c_in, row_stride=s * c_in, batch_stride=t_in * c_in,
                 cols0=min(k, s) * c_in, cols1=max(k - s, 0) * c_in)


def check_widths(c0: int, spec: Spec, dtype: torch.dtype, what: str) -> None:
    """Raise unless C0 and every layer's width suit the card's kernels
    (``padded_widths`` makes them so)."""
    mult = WIDTH_MULTIPLE[dtype]
    if any(c % mult for c in [c0] + [d for (d, _k, _s) in spec]):
        raise ValueError(f"{what} needs every width to be a multiple of {mult} in {dtype}")


def padded_widths(c0: int, spec: Spec, dtype: torch.dtype) -> Tuple[int, Spec]:
    """(C0, spec) with C0 and every layer's width rounded up to a multiple
    of ``WIDTH_MULTIPLE[dtype]``."""
    mult = WIDTH_MULTIPLE[dtype]

    def up(c: int) -> int:
        return -(-c // mult) * mult

    return up(c0), tuple((up(d), k, s) for (d, k, s) in spec)


def _pad_last(x: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return x if x is None or x.shape[-1] == n else F.pad(x, (0, n - x.shape[-1]))


def _pad_weights(weights: Sequence[torch.Tensor], c0: int, spec: Spec) -> List[torch.Tensor]:
    """Each (k, C_in, d) weight zero-padded to the padded (C_in, d)."""
    out, c_in = [], c0
    for w, (d, _k, _s) in zip(weights, spec):
        out.append(w if tuple(w.shape[1:]) == (c_in, d) else
                   F.pad(w, (0, d - w.shape[2], 0, c_in - w.shape[1])))
        c_in = d
    return out


def padded_conv_stack(fwd, x: torch.Tensor, weights: Sequence[torch.Tensor], spec: Spec,
                      scale: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fwd(x, weights, spec, scale, shift)`` run at the padded widths
    (``padded_widths``), its output cropped to the last layer's width."""
    c0, pspec = padded_widths(x.shape[-1], spec, x.dtype)
    out = fwd(_pad_last(x, c0), _pad_weights(weights, c0, pspec), pspec,
              _pad_last(scale, c0), _pad_last(shift, c0))
    d = spec[-1][0]
    return out if out.shape[-1] == d else out[..., :d].contiguous()


def padded_conv_stack_bwd(bwd, a0: torch.Tensor, weights: Sequence[torch.Tensor],
                          g: torch.Tensor, spec: Spec) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``bwd(a0, weights, g, spec) -> (da0, dWs)`` run at the padded
    widths, da0 and each dW cropped back."""
    c0, pspec = padded_widths(a0.shape[-1], spec, a0.dtype)
    da0, dws = bwd(_pad_last(a0, c0), _pad_weights(weights, c0, pspec),
                   _pad_last(g, pspec[-1][0]), pspec)
    shapes = [tuple(w.shape) for w in weights]
    return (da0[..., :a0.shape[-1]].contiguous() if c0 != a0.shape[-1] else da0,
            [dw if tuple(dw.shape) == shp else dw[:, :shp[1], :shp[2]].contiguous()
             for dw, shp in zip(dws, shapes)])


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


def gelu_grad_exact(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU: Phi(x) + x * phi(x) (``conv_frontend_bwd.py:68``)."""
    return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) \
        + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


def gelu_grad_tanh(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-form GELU (``conv_frontend_bwd.py:75``)."""
    t = torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x))
    du = 0.7978845608028654 * (1.0 + 3.0 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _gelu_grad(dtype: torch.dtype):
    return gelu_grad_exact if dtype == torch.float32 else gelu_grad_tanh


def _prefix(x, scale, shift):
    """The block-0 GroupNorm + GELU prefix, gelu(x * scale + shift), in x's dtype."""
    return _gelu(x.dtype)(x.float() * scale.float()[:, None] + shift.float()[:, None]).to(x.dtype)


def conv_backward_kind(env: Optional[str], device_type: str) -> str:
    """Which backward the conv stack takes: ``"kernel"`` (K6) or
    ``"library"`` (autograd through the ``F.conv1d`` recompute), from the
    value of ``FITHUBERT_CONV_BWD`` (``None`` when unset) and the device
    type of the tensors. ``pallas`` is K6 and any other value the library,
    as the JAX package reads its variable; unset, K6 on the card and the
    library on the CPU (the module docstring says why)."""
    if env:
        return "kernel" if env.lower() == "pallas" else "library"
    return "kernel" if device_type == "cuda" else "library"


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
        x = _prefix(x, scale, shift)
    h = x.transpose(1, 2)
    for w, (_d, _k, s) in zip(weights, spec):
        h = gelu(F.conv1d(h, w.permute(2, 1, 0), stride=s))
    return h.transpose(1, 2).contiguous()


_I32, _I64, _PTR = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_VIEW_ARGS = [_I64] * 3 + [_I32] * 2  # an AView


@functools.lru_cache(maxsize=None)
def _conv_layer_fn():
    fn = _build.load("conv_frontend").conv_layer
    fn.restype = ctypes.c_int
    fn.argtypes = [_I32] + [_PTR] * 5 + [_I32] * 7 + _VIEW_ARGS + [_PTR]
    return fn


@functools.lru_cache(maxsize=None)
def _gn_prefix_fn():
    fn = _build.load("conv_frontend").gn_prefix
    fn.restype = ctypes.c_int
    fn.argtypes = [_PTR] * 4 + [_I32] * 3 + [_PTR]
    return fn


def gn_prefix_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The block-0 GroupNorm + GELU prefix, gelu_tanh(x * scale + shift), of
    bf16 x (B, T, C) with scale and shift (B, C): on a CUDA tensor one launch
    of ``gn_prefix_bf16`` (``conv_frontend.cu``), on a CPU tensor ``_prefix``.
    fp32 has no kernel of its own (K1's fp32 body applies the prefix to each
    A tile) and raises on the card."""
    if x.device.type == "cpu":
        return _prefix(x, scale, shift)
    if x.dtype != torch.bfloat16 or scale.dtype != x.dtype or shift.dtype != x.dtype:
        raise ValueError(f"{KERNEL_PREFIX} takes bfloat16 x, scale and shift")
    b, t, c = x.shape
    if c % 8 or tuple(scale.shape) != (b, c) or tuple(shift.shape) != (b, c):
        raise ValueError(f"{KERNEL_PREFIX} needs C a multiple of 8 and (B, C) scale and shift")
    if not (x.is_contiguous() and scale.is_contiguous() and shift.is_contiguous()):
        raise ValueError(f"{KERNEL_PREFIX} needs contiguous x, scale and shift")
    a0 = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _gn_prefix_fn()(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), a0.data_ptr(),
                              b, t, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, KERNEL_PREFIX)
    _build.count_launch(KERNEL_PREFIX)
    return a0


def _conv_stack_cuda(x, weights, spec, scale, shift) -> torch.Tensor:
    return padded_conv_stack(_conv_stack_kernels, x, weights, spec, scale, shift)


def _conv_stack_kernels(x, weights, spec, scale, shift) -> torch.Tensor:
    fn = _conv_layer_fn()
    check_widths(x.shape[-1], spec, x.dtype, KERNEL)
    if not x.is_contiguous() or (scale is not None and not (
            scale.is_contiguous() and shift.is_contiguous())):
        raise ValueError("conv_stack_cuda needs contiguous x, scale and shift")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    b = x.shape[0]
    h = x
    if scale is not None and x.dtype == torch.bfloat16:
        h, scale, shift = gn_prefix_cuda(x, scale, shift), None, None
    for i, (w, (d, k, s)) in enumerate(zip(weights, spec)):
        wt = w.permute(2, 0, 1).contiguous()  # (C_out, k, C_in): rows of K = k*C_in
        t_in, c_in = h.shape[1], h.shape[2]
        t_out = (t_in - k) // s + 1
        y = torch.empty((b, t_out, d), dtype=x.dtype, device=x.device)
        prefix = scale is not None and i == 0  # fp32: applied to each A tile
        err = fn(_DTYPE_CODE[x.dtype], h.data_ptr(), wt.data_ptr(),
                 scale.data_ptr() if prefix else None,
                 shift.data_ptr() if prefix else None,
                 y.data_ptr(), b, t_in, c_in, t_out, d, k, s,
                 *a_operand_view(t_in, c_in, k, s), stream)
        _build.check(err, KERNEL)
        _build.count_launch(KERNEL)
        h = y
    return h


def _taps(a: torch.Tensor, j: int, s: int, t_out: int) -> torch.Tensor:
    """Rows f * s + j of a (B, T, C), f < t_out: tap j of every output frame."""
    return a[:, j: j + (t_out - 1) * s + 1: s]


def conv_stack_bwd_plain(a0: torch.Tensor, weights: Sequence[torch.Tensor],
                         g: torch.Tensor, spec: Spec) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(da0, [dW_i]), all fp32, the stack's backward by K6's own steps
    (``pallas_stack_bwd``): an up pass with explicit tap matmuls storing
    z_i (pre-GELU) and a_{i+1} = gelu(z_i) in a0's dtype, whose last layer
    gives dz = g * gelu'(z) rounded to a0's dtype in their place; then from
    the last layer down dW_i[j] = tap_j(a_i)^T dz, da_i = sum_j dz W_i[j]^T
    placed at the rows tap j read, kept fp32, and the next dz = da_i *
    gelu'(z_{i-1}) rounded to a0's dtype. Not autograd."""
    dtype = a0.dtype
    gelu, gelu_grad = _gelu(dtype), _gelu_grad(dtype)
    a_store, z_store = [a0], []
    for i, (w, (_d, k, s)) in enumerate(zip(weights, spec)):
        a = a_store[-1].float()
        t_out = (a.shape[1] - k) // s + 1
        z = sum(_taps(a, j, s, t_out) @ w[j].float() for j in range(k)).to(dtype)
        if i == len(spec) - 1:
            dz = (g.float() * gelu_grad(z.float())).to(dtype).float()
        else:
            z_store.append(z)
            a_store.append(gelu(z.float()).to(dtype))
    dws = [None] * len(spec)
    for i in reversed(range(len(spec))):
        _d, k, s = spec[i]
        a, w = a_store[i].float(), weights[i].float()
        t_out = dz.shape[1]
        dws[i] = torch.stack([torch.einsum("btc,btd->cd", _taps(a, j, s, t_out), dz)
                              for j in range(k)])
        da = torch.zeros_like(a)
        for j in range(k):
            _taps(da, j, s, t_out).add_(dz @ w[j].t())
        if i == 0:
            return da, dws
        dz = (da * gelu_grad(z_store[i - 1].float())).to(dtype).float()


# The dW kernels' geometry: (tile rows, tile columns, reduction rows a chunk
# is a multiple of, blocks to aim for). bf16 reduces over (batch row,
# 64-frame tile) steps, one block per SM of an H100 (132 SMs); fp32 over
# frames, 16 a stage, two blocks per SM.
DW_GEOMETRY = {torch.bfloat16: (128, 256, 1, 132), torch.float32: (64, 64, 16, 264)}


def _dw_split(m_red: int, kdim: int, n: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(chunk_len, n_chunks) of the dW reduction over m_red rows (bf16:
    steps, fp32: frames): as many chunks as let the (kdim, n) tiles fill the
    card's blocks once, each chunk a whole number of stages. A function of
    the shapes alone, so the sum order is fixed."""
    tile_m, tile_n, depth, blocks = DW_GEOMETRY[dtype]
    tiles = math.ceil(kdim / tile_m) * math.ceil(n / tile_n)
    chunks = max(1, min(blocks // tiles, math.ceil(m_red / depth)))
    chunk_len = math.ceil(math.ceil(m_red / chunks) / depth) * depth
    return chunk_len, math.ceil(m_red / chunk_len)


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("conv_frontend_bwd")
    ptr, i32, i64 = _PTR, _I32, _I64
    sig = {"conv_bwd_up": [i32] + [ptr] * 5 + [i32] * 7 + _VIEW_ARGS + [ptr],
           "conv_bwd_da": [i32] + [ptr] * 5 + [i32] * 7 + [ptr],
           "conv_bwd_dw": [i32] + [ptr] * 3 + [i32] * 7 + _VIEW_ARGS + [i32] * 2 + [ptr],
           "conv_bwd_dw_reduce": [ptr] * 2 + [i64, i32, ptr]}
    fns = {}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
    return fns


def _launch(fn, *args) -> None:
    _build.check(fn(*args), KERNEL_BWD)
    _build.count_launch(KERNEL_BWD)


def up_cuda(a: torch.Tensor, wt: torch.Tensor, layer: Tuple[int, int, int],
            g: Optional[torch.Tensor] = None):
    """K6's up pass over one layer (d, k, s) of contiguous CUDA a (B, T_in,
    C_in), wt the weight as (d, k, C_in): (z, gelu(z)) in a's dtype, z the
    pre-GELU sum; or, given g (B, T_out, d) fp32, dz = g * gelu'(z) alone.
    K1's launch on K1's tile geometry. One K6 launch."""
    d, k, s = layer
    b, t_in, c_in = a.shape
    t_out = (t_in - k) // s + 1
    out = torch.empty((b, t_out, d), dtype=a.dtype, device=a.device)
    z = None if g is not None else torch.empty_like(out)
    _launch(_bwd_fns()["conv_bwd_up"], _DTYPE_CODE[a.dtype], a.data_ptr(), wt.data_ptr(),
            None if z is None else z.data_ptr(), out.data_ptr(),
            None if g is None else g.data_ptr(), b, t_in, c_in, t_out, d, k, s,
            *a_operand_view(t_in, c_in, k, s), torch.cuda.current_stream(a.device).cuda_stream)
    return out if g is not None else (z, out)


def up_pass_cuda(a: torch.Tensor, w: torch.Tensor, layer: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's up pass over one layer of contiguous CUDA a and w (k, C_in, d):
    (z, gelu(z)); gelu(z) is K1's output bit for bit."""
    return up_cuda(a, w.permute(2, 0, 1).contiguous(), layer)


def dw_partials_cuda(a: torch.Tensor, dz: torch.Tensor, layer: Tuple[int, int, int]
                     ) -> torch.Tensor:
    """K6's dW launch for one layer (d, k, s): fp32 partials (n_chunks, k *
    C_in, d) of tap(a)^T dz over fixed chunks of the frames (``_dw_split``).
    One K6 launch."""
    d, k, s = layer
    b, t_in, c_in = a.shape
    t_out = dz.shape[1]
    m_red = b * (math.ceil(t_out / 64) if a.dtype == torch.bfloat16 else t_out)
    chunk_len, n_chunks = _dw_split(m_red, k * c_in, d, a.dtype)
    part = torch.empty((n_chunks, k * c_in, d), dtype=torch.float32, device=a.device)
    _launch(_bwd_fns()["conv_bwd_dw"], _DTYPE_CODE[a.dtype], a.data_ptr(), dz.data_ptr(),
            part.data_ptr(), b, t_in, c_in, t_out, d, k, s, *a_operand_view(t_in, c_in, k, s),
            chunk_len, n_chunks, torch.cuda.current_stream(a.device).cuda_stream)
    return part


def dw_reduce_cuda(part: torch.Tensor, layer: Tuple[int, int, int]) -> torch.Tensor:
    """The ordered sum of the dW partials: dW (k, C_in, d) fp32. One K6 launch."""
    d, k, _s = layer
    dw = torch.empty((k, part.shape[1] // k, d), dtype=torch.float32, device=part.device)
    _launch(_bwd_fns()["conv_bwd_dw_reduce"], part.data_ptr(), dw.data_ptr(), dw.numel(),
            part.shape[0], torch.cuda.current_stream(part.device).cuda_stream)
    return dw


def da_cuda(dz: torch.Tensor, wk: torch.Tensor, layer: Tuple[int, int, int], t_in: int,
            z_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's da launch for one layer (d, k, s) from dz (B, T_out, d) and wk =
    w (k, C_in, d) contiguous: with z_prev (B, t_in, C_in), the layer
    below's dz = da * gelu'(z_prev) in the dtype; without, da0 in fp32. One
    K6 launch."""
    d, k, s = layer
    b, t_out = dz.shape[0], dz.shape[1]
    c_in = wk.shape[1]
    if z_prev is not None:
        out = torch.empty_like(z_prev)
        ptrs = (z_prev.data_ptr(), out.data_ptr(), None)
    else:
        out = torch.empty((b, t_in, c_in), dtype=torch.float32, device=dz.device)
        ptrs = (None, None, out.data_ptr())
    _launch(_bwd_fns()["conv_bwd_da"], _DTYPE_CODE[dz.dtype], dz.data_ptr(), wk.data_ptr(),
            *ptrs, b, t_in, c_in, t_out, d, k, s, torch.cuda.current_stream(dz.device).cuda_stream)
    return out


def conv_stack_bwd_cuda(a0: torch.Tensor, weights: Sequence[torch.Tensor],
                        g: torch.Tensor, spec: Spec) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K6 on CUDA tensors: (da0, [dW_i]), fp32, in 4L launches: L up passes
    (the last writes dz), L dW, L ordered sums of its chunks, L da; at any
    width (``padded_conv_stack_bwd``)."""
    return padded_conv_stack_bwd(_conv_stack_bwd_kernels, a0, weights, g, spec)


def _conv_stack_bwd_kernels(a0, weights, g, spec):
    check_widths(a0.shape[-1], spec, a0.dtype, KERNEL_BWD)  # its up pass is K1's GEMM
    # the weights' layouts, once per backward: (C_out, k, C_in) rows of K for
    # the up pass, (k, C_in, C_out) with C_out contiguous for da
    wts = [w.permute(2, 0, 1).contiguous() for w in weights]
    wks = [w.contiguous() for w in weights]
    a_store, z_store = [a0.contiguous()], []
    for i, layer in enumerate(spec[:-1]):
        z, a_next = up_cuda(a_store[-1], wts[i], layer)
        z_store.append(z)
        a_store.append(a_next)
    dz = up_cuda(a_store[-1], wts[-1], spec[-1], g.float().contiguous())
    dws = [None] * len(spec)
    for i in reversed(range(len(spec))):
        dws[i] = dw_reduce_cuda(dw_partials_cuda(a_store[i], dz, spec[i]), spec[i])
        t_in = a_store[i].shape[1]
        a_store[i] = None  # no longer read: free it early
        dz = da_cuda(dz, wks[i], spec[i], t_in, z_store[i - 1] if i > 0 else None)
        if i > 0:
            z_store[i - 1] = None
    return dz, dws


class _ConvStack(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU). Backward, as
    ``conv_backward_kind`` picks: K6, or autograd through
    ``conv_stack_plain`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, shift, spec, *weights):
        ctx.spec = spec
        ctx.save_for_backward(x, scale, shift, *weights)
        if x.device.type == "cuda":
            with torch.cuda.device(x.device):  # launch on the tensors' card
                return _conv_stack_cuda(x, weights, spec, scale, shift)
        if x.device.type == "cpu":
            return conv_stack_plain(x, weights, spec, scale, shift)
        raise ValueError(f"conv_stack runs on cuda or cpu, not {x.device}")

    @staticmethod
    def backward(ctx, grad):
        if conv_backward_kind(os.environ.get("FITHUBERT_CONV_BWD"), grad.device.type) == "kernel":
            return _kernel_backward(ctx, grad)
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[4:]
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        x, scale, shift, *weights = inputs
        with torch.enable_grad():
            y = conv_stack_plain(x, weights, ctx.spec, scale, shift)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, grad))
        dx, dscale, dshift, *dws = [next(grads) if t is not None and t.requires_grad else None
                                    for t in inputs]
        return (dx, dscale, dshift, None, *dws)


def _kernel_backward(ctx, grad):
    """The backward through K6 (``_fused_bwd`` / ``_fused_gn_bwd`` under
    ``FITHUBERT_CONV_BWD=pallas``, ``conv_frontend.py:345-352, 426-443``)."""
    x, scale, shift, *weights = ctx.saved_tensors
    if scale is not None:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, scale, shift)]
            a0 = _prefix(*leaves)
    else:
        a0 = x
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            da0, dws = conv_stack_bwd_cuda(a0.detach(), weights, grad, ctx.spec)
    elif x.device.type == "cpu":
        da0, dws = conv_stack_bwd_plain(a0.detach(), weights, grad, ctx.spec)
    else:
        raise ValueError(f"conv_stack runs on cuda or cpu, not {x.device}")
    if scale is not None:
        dx, dscale, dshift = torch.autograd.grad(a0, leaves, da0.to(a0.dtype))
    else:
        dx, dscale, dshift = da0.to(x.dtype), None, None
    needs = ctx.needs_input_grad
    return (dx if needs[0] else None, dscale if needs[1] else None,
            dshift if needs[2] else None, None,
            *[dw.to(w.dtype) if n else None for dw, w, n in zip(dws, weights, needs[4:])])


def conv_stack(x: torch.Tensor, weights: Sequence[torch.Tensor], spec: Spec,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, C0) -> (B, T_out, C_last) through the conv + GELU stack.

    weights[i] is (k, C_in, C_out) in x's dtype; scale and shift, if given,
    are (B, C0) in x's dtype. CUDA tensors run the kernel, CPU tensors the
    plain version. Differentiable in x, weights, scale and shift."""
    _check(x, weights, spec, scale, shift)
    return _ConvStack.apply(x, scale, shift, tuple(spec), *weights)
