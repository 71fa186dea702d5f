"""1-D convolution building blocks in channels-last (B, T, C) layout
(``fithubert_tpu/ops/conv.py``). Parameters keep torch's layouts and the
reference's state-dict names; the JAX kernels are their transposes (see
``export/jax_params.py``).

  ConvFeatureExtractor  ≙ conv.py:225 (the fused path: block 0, then the
                          conv_stack kernel with GroupNorm + GELU folded in)
  PositionalConv        ≙ conv.py:384 (weight norm over the kernel axis,
                          SamePad, exact GELU)
  Conv1D                ≙ conv.py:38, the k == s branch (the TR conv1d)
  ConvTranspose1D       ≙ conv.py:161, the k == s branch (the upsampler)
  grad_multiply         ≙ conv.py:468 (identity forward, gradient scaled)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fithubert_tpu_torch.ops.activations import gelu_exact
from fithubert_tpu_torch.ops.kernels.conv_frontend import conv_stack, fusable, gn_scale_shift
from fithubert_tpu_torch.ops.norms import FP32GroupNorm


class Conv1D(nn.Conv1d):
    """Conv with kernel == stride over (B, T, C_in) -> (B, T // s, C_out):
    non-overlapping windows fold into one matmul (conv.py:88-99)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, device=None):
        super().__init__(c_in, c_out, kernel_size, stride=kernel_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        k = self.kernel_size[0]
        t_out = t // k
        r = x[:, : t_out * k].reshape(b, t_out, k * c)
        # (C_out, C_in, K) -> (C_out, K * C_in), matching r's (tap, channel) order
        w = self.weight.to(x.dtype).permute(0, 2, 1).reshape(self.out_channels, k * c)
        return F.linear(r, w, self.bias.to(x.dtype))


class ConvTranspose1D(nn.ConvTranspose1d):
    """Transposed conv with kernel == stride over (B, T, C_in) ->
    (B, T * k, C_out): out[t*k + j] = x[t] @ W[:, :, j] + bias (conv.py:188-203)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, device=None):
        super().__init__(c_in, c_out, kernel_size, stride=kernel_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        k = self.kernel_size[0]
        # (C_in, C_out, K) -> (C_in, K * C_out): output index j * C_out + o
        w = self.weight.to(x.dtype).permute(0, 2, 1).reshape(c, k * self.out_channels)
        y = torch.matmul(x, w).reshape(b, t * k, self.out_channels)
        return y + self.bias.to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """Waveform (B, T) -> features (B, T', C) in the waveform's dtype.

    Block 0 (C_in = 1) is a plain unfold + matmul; its GroupNorm(C, C)
    statistics are an fp32 reduce over all T1 rows of the batch as given,
    and the normalization, the GELU and blocks 1..N run in ``conv_stack``.
    State-dict keys follow the reference: ``conv_layers.{i}.0.weight``, and
    ``conv_layers.0.2.*`` for the GroupNorm."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]], device=None):
        super().__init__()
        self.spec = tuple(tuple(c) for c in conv_layers)
        if len(self.spec) < 2 or not fusable(self.spec[1:]):
            raise NotImplementedError(
                f"the port's extractor needs block 0 plus blocks with k <= 2s: {self.spec}")
        blocks, c_in = [], 1
        for i, (d, k, s) in enumerate(self.spec):
            conv = nn.Conv1d(c_in, d, k, stride=s, bias=False, device=device)
            extra = [nn.Identity(), FP32GroupNorm(d, d, device=device)] if i == 0 else []
            blocks.append(nn.ModuleList([conv] + extra))
            c_in = d
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        dtype = wav.dtype
        conv0, _, gn = self.conv_layers[0]
        d0, k0, s0 = self.spec[0]
        x = wav.unfold(1, k0, s0) @ conv0.weight.to(dtype).reshape(d0, k0).t()
        scale, shift = gn_scale_shift(x, gn.weight, gn.bias, gn.eps)
        weights = [blk[0].weight.to(dtype).permute(2, 1, 0) for blk in self.conv_layers[1:]]
        return conv_stack(x, weights, self.spec[1:], scale, shift)


class _WeightNormConv(nn.Module):
    """The parameters of a torch weight-normed Conv1d (weight_norm dim=2):
    weight_g (1, 1, K), weight_v (C_out, C_in / g, K), bias (C_out,)."""

    def __init__(self, dim: int, kernel_size: int, groups: int, device=None):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel_size, device=device))
        self.weight_v = nn.Parameter(torch.empty(dim, dim // groups, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        nn.init.normal_(self.weight_v)


class _GroupedConv1d(torch.autograd.Function):
    """``F.conv1d`` (stride 1) with a deterministic backward. cuDNN's
    heuristics pick an input-gradient algorithm for the 768-wide positional
    conv (groups 16, k 128) that sums in another order from run to run on an
    H100, so two identical train steps gave different gradients below it;
    its deterministic input-gradient kernel took 22 ms a step there. So the
    input gradient is computed as the forward convolution it equals: each
    group's kernel transposed and flipped in time, padded by k - 1 - p. The
    weight gradient keeps cuDNN's with the deterministic flag, which is
    read when the backward runs and so is set here."""

    @staticmethod
    def forward(ctx, x, w, b, padding: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.groups = padding, groups
        return F.conv1d(x, w, b, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g, k = ctx.groups, w.shape[-1]
        gx = None
        if ctx.needs_input_grad[0]:
            c_out, c_in_g = w.shape[0], w.shape[1]
            wt = w.reshape(g, c_out // g, c_in_g, k).transpose(1, 2).flip(-1)
            gx = F.conv1d(grad, wt.reshape(g * c_in_g, c_out // g, k),
                          padding=k - 1 - ctx.padding, groups=g)
        gw = gb = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                            benchmark=False, deterministic=True,
                                            allow_tf32=torch.backends.cudnn.allow_tf32):
                _, gw, gb = torch.ops.aten.convolution_backward(
                    grad, x, w, [w.shape[0]], [1], [ctx.padding], [1], False, [0], g,
                    [False, ctx.needs_input_grad[1], ctx.needs_input_grad[2]])
        return gx, gw, gb, None, None


class PositionalConv(nn.Module):
    """Grouped weight-normed conv + SamePad + exact GELU over (B, T, C).
    w[:, :, k] = g[k] * v[:, :, k] / ||v[:, :, k]||. The single child is
    named ``0`` so the keys read ``pos_conv.0.weight_g`` as in the reference."""

    def __init__(self, embed_dim: int, kernel_size: int = 128, groups: int = 16,
                 device=None):
        super().__init__()
        self.kernel_size, self.groups = kernel_size, groups
        self.add_module("0", _WeightNormConv(embed_dim, kernel_size, groups, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self._modules["0"]
        v = conv.weight_v
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
        w = (v * (conv.weight_g / norm)).to(x.dtype)
        b = conv.bias.to(x.dtype)
        xt = x.transpose(1, 2)
        if x.device.type == "cpu" and x.dtype != torch.float32:
            # the CPU's bf16 grouped conv1d returns wrong values at some
            # shapes (C=48, groups=4, k=16); sum the bf16 operands in fp32
            xt, w, b = xt.float(), w.float(), b.float()
        y = _GroupedConv1d.apply(xt, w, b, self.kernel_size // 2, self.groups).to(x.dtype)
        if self.kernel_size % 2 == 0:  # SamePad: drop the trailing step
            y = y[:, :, :-1]
        return gelu_exact(y.transpose(1, 2))


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x in the forward; the gradient into x is multiplied by ``scale``
    (``feature_grad_mult``)."""
    return _GradMultiply.apply(x, scale)
