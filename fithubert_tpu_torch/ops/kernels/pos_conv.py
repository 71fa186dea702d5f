"""The encoder's positional conv, forward and input gradient:
``positional_conv`` and its plain version ``pos_conv_plain``.

Replaces no Pallas kernel: the JAX package computes the conv with
``jax.lax.conv_general_dilated`` (``fithubert_tpu/ops/conv.py:338-373``,
run by ``PositionalConv`` at ``:384``). On the card the port ran it as
cuDNN's grouped conv, the largest single item on the device in every
benchmark cell and far from its bound; ``csrc/pos_conv.cu`` says why the
kernel is built as it is.

``pos_conv(x, w, bias, pad)`` computes, for x (B, T, C) and the grouped
weight w (C, C / groups, k) in x's dtype,
``y[b, t, o] = bias[o] + sum_{j, i} w[o, i, j] * x[b, t + j - pad, g(o) * cg + i]``
for t < T, frames outside [0, T) reading as zero, summed in fp32 and rounded
once to x's dtype. ``positional_conv`` runs it with pad = k // 2, which is
``F.conv1d(padding=k // 2)`` followed by SamePad's drop of the trailing frame
at even k, and its input gradient as the same conv of the cotangent with
each group's kernel transposed and flipped in time (``flipped``), pad = k -
1 - k // 2. Both are deterministic: one fixed order of the sum. The weight
and bias gradients stay on cuDNN's deterministic ``convolution_backward``.

On a CUDA tensor ``pos_conv`` launches the kernel, ``pos_conv_cuda`` (one
launch a call, counted under ``KERNEL``); on a CPU tensor it runs
``pos_conv_plain``, ``F.conv1d`` summed in fp32 (the CPU's bf16 grouped
conv1d returns wrong values at some shapes, C=48, groups=4, k=16). The bf16
kernel takes the weights packed by ``pack_weights``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fithubert_tpu_torch.ops.kernels import _build

KERNEL = "pos_conv_cuda"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The group widths the bf16 kernel is built for: a group of cg channels runs
# at the first of these that holds it, with zero weights past cg.
GROUP_WIDTHS = (16, 32, 48, 64)


def padded_group_width(cg: int) -> int:
    for width in GROUP_WIDTHS:
        if cg <= width:
            return width
    raise ValueError(f"{KERNEL} takes groups of at most {GROUP_WIDTHS[-1]} channels in "
                     f"bfloat16, got {cg}")


def pos_conv_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                   pad: int) -> torch.Tensor:
    """``pos_conv`` as ``F.conv1d`` on fp32 copies of x, w and bias: the
    conv of ``padding=pad`` (after the zero frames past T that a right
    padding of k - 1 - pad needs beyond pad), its first T frames, rounded
    once to x's dtype; (B, T, C)."""
    t, groups, k = x.shape[1], x.shape[2] // w.shape[1], w.shape[2]
    xt, w32 = x.transpose(1, 2).float(), w.float()
    extra = k - 1 - 2 * pad
    if extra > 0:
        xt = F.pad(xt, (0, extra))
    y = F.conv1d(xt, w32, None if bias is None else bias.float(), padding=pad, groups=groups)
    return y[:, :, :t].to(x.dtype).transpose(1, 2)


def flipped(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The input gradient's weight of a grouped conv with w (C_out, C_in /
    groups, k): each group's kernel transposed and flipped in time,
    wt[g * ci + i, o, j] = w[g * co + o, i, k - 1 - j] with co = C_out /
    groups and ci = C_in / groups; (C_in, co, k)."""
    c_out, ci, k = w.shape
    co = c_out // groups
    return w.reshape(groups, co, ci, k).transpose(1, 2).flip(-1).reshape(groups * ci, co, k)


def conv_weight_grads(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, pad: int,
                      groups: int, need_w: bool, need_b: bool
                      ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dw, dbias) of ``F.conv1d(x, w, padding=pad, groups=groups)`` (stride
    1, x and its cotangent gy in (B, C, T)) by ``convolution_backward`` with
    cuDNN's deterministic algorithms. The flag is read when the call runs,
    so it is set here."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                    deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32):
        _, dw, db = torch.ops.aten.convolution_backward(
            gy, x, w, [w.shape[0]], [1], [pad], [1], False, [0], groups,
            [False, need_w, need_b])
    return dw, db


def pack_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """w (C, cg, k) as the bf16 kernel reads it: (groups, k, cgp, cgp), each
    tap's (output, input) slab zero-padded to cgp = ``padded_group_width``
    and laid out in wgmma's K-major core matrices without swizzle, (cgp / 8,
    cgp / 8, 8, 8): 8 outputs x 8 inputs a core, the cores of one row of 8
    outputs adjacent."""
    c, cg, k = w.shape
    cgp = padded_group_width(cg)
    wg = w.reshape(groups, cg, cg, k)
    if cgp != cg:
        wg = F.pad(wg, (0, 0, 0, cgp - cg, 0, cgp - cg))
    # (g, o, i, k) -> (g, k, o / 8, i / 8, o % 8, i % 8): one copy
    return wg.reshape(groups, cgp // 8, 8, cgp // 8, 8, k).permute(0, 5, 1, 3, 2, 4).contiguous()


@functools.lru_cache(maxsize=None)
def _pos_conv_fn():
    fn = _build.load("pos_conv").pos_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return fn


@_build.one_launch(KERNEL)
def pos_conv_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                  pad: int) -> torch.Tensor:
    """``pos_conv`` on CUDA tensors: one launch of ``csrc/pos_conv.cu``."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{KERNEL} takes float32 or bfloat16 x and w of one dtype, "
                         f"got {x.dtype} and {w.dtype}")
    b, t, c = x.shape
    cg, k = w.shape[1], w.shape[2]
    if w.shape[0] != c or c % cg:
        raise ValueError(f"{KERNEL}: weight {tuple(w.shape)} does not group {c} channels")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"{KERNEL}: bias {tuple(bias.shape)} is not ({c},)")
    groups, xg = c // cg, cg
    y = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        cgp = padded_group_width(cg)
        if cg % 8:  # each group's window starts on a 16-byte boundary: groups padded to cgp
            xg = cgp
            x = F.pad(x.view(b, t, groups, cg), (0, cgp - cg)).view(b, t, groups * cgp)
        if x.data_ptr() % 16:  # the tensor map's base
            x = x.clone()
        wk = pack_weights(w, groups)
    else:
        cgp, wk = cg, w.permute(2, 1, 0).contiguous()  # (k, cg, C)
    b32 = None if bias is None else bias.float().contiguous()
    with torch.cuda.device(x.device):
        err = _pos_conv_fn()(_DTYPE_CODE[x.dtype], x.data_ptr(), wk.data_ptr(),
                             None if b32 is None else b32.data_ptr(), y.data_ptr(), b, t, c, cg,
                             groups * xg, xg, cgp, k, pad,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, KERNEL)
    _build.count_launch(KERNEL)
    return y


def pos_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
             pad: int) -> torch.Tensor:
    """The conv of the module docstring: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return pos_conv_cuda(x, w, bias, pad)
    if x.device.type == "cpu":
        return pos_conv_plain(x, w, bias, pad)
    raise ValueError(f"pos_conv runs on cuda or cpu, not {x.device}")


def weight_grads(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, groups: int,
                 need_w: bool, need_b: bool) -> Tuple[Optional[torch.Tensor],
                                                      Optional[torch.Tensor]]:
    """(dw, dbias) of ``positional_conv`` from its cotangent gy (B, T, C):
    ``conv_weight_grads`` of the conv of ``padding=k // 2``, the cotangent
    of SamePad's dropped frame zero; on the CPU in fp32, rounded to w's
    dtype."""
    k = w.shape[-1]
    pad = k // 2
    g = gy.transpose(1, 2)
    dropped = 2 * pad - (k - 1)  # SamePad's trailing frames: 1 at even k
    if dropped:
        g = F.pad(g, (0, dropped))
    xt, wc = x.transpose(1, 2), w
    if x.device.type == "cpu" and x.dtype != torch.float32:
        g, xt, wc = g.float(), xt.float(), wc.float()
    dw, db = conv_weight_grads(g, xt, wc, pad, groups, need_w, need_b)
    return (None if dw is None else dw.to(w.dtype)), (None if db is None else db.to(w.dtype))


class _PositionalConv(torch.autograd.Function):
    """``pos_conv`` with pad = k // 2; its input gradient is ``pos_conv`` of
    the cotangent over ``flipped`` weights, its weight and bias gradients
    ``weight_grads``."""

    @staticmethod
    def forward(ctx, x, w, bias, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        return pos_conv(x, w, bias, w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        k = w.shape[-1]
        gx = None
        if ctx.needs_input_grad[0]:
            gx = pos_conv(gy.contiguous(), flipped(w, ctx.groups), None, k - 1 - k // 2)
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = weight_grads(gy, x, w, ctx.groups, ctx.needs_input_grad[1],
                                  ctx.needs_input_grad[2])
        return gx, dw, db, None


def positional_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    groups: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, C): the grouped conv of ``padding=k // 2`` and
    SamePad (its first T frames), w (C, C / groups, k) and bias (C,) in x's
    dtype. Differentiable in x, w and bias."""
    if w.shape[0] != x.shape[-1] or w.shape[0] != groups * w.shape[1]:
        raise ValueError(f"positional_conv: weight {tuple(w.shape)} is not ({x.shape[-1]}, "
                         f"{x.shape[-1]} / {groups}, k)")
    return _PositionalConv.apply(x, w, bias, groups)
