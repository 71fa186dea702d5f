"""1-D convolution building blocks in channels-last (B, T, C) layout
(``fithubert_tpu/ops/conv.py``). Parameters keep torch's layouts and the
reference's state-dict names; the JAX kernels are their transposes (see
``export/jax_params.py``).

  ConvFeatureExtractor  ≙ conv.py:225 (the fused path: block 0, then the
                          conv_stack kernel with GroupNorm + GELU folded in;
                          otherwise the unfused loop, layer_norm mode and
                          conv bias included)
  PositionalConv        ≙ conv.py:384 (weight norm over the kernel axis,
                          SamePad, exact GELU; the conv in kernels/pos_conv.py)
  MultiLayerPositionalConv ≙ conv.py:435 (pos_conv_depth > 1)
  Conv1D                ≙ conv.py:38, the k == s branch (the TR conv1d)
  SameConv1d            ≙ conv.py:38, stride 1 with padding (the conformer's
                          pointwise and depthwise convs, MelSpecHead)
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
from fithubert_tpu_torch.ops.kernels.pos_conv import conv_weight_grads, flipped, positional_conv
from fithubert_tpu_torch.ops.norms import FP32GroupNorm, FP32LayerNorm


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

    Where the JAX package takes its fused path (``conv.py:260-264``:
    ``default`` mode, no conv bias, blocks 1..N that ``fusable`` takes),
    block 0 (C_in = 1) is a plain unfold + matmul; its GroupNorm(C, C)
    statistics are an fp32 reduce over all T1 rows of the batch as given,
    and the normalization, the GELU and blocks 1..N run in ``conv_stack``
    (K1). Otherwise the blocks run one at a time as JAX's unfused loop
    (``conv.py:306-321``) does: the strided conv, the optional bias added in
    fp32 before the cast, in ``layer_norm`` mode an fp32 LayerNorm on every
    block (in ``default`` mode block 0's GroupNorm), then the exact GELU.
    State-dict keys follow fairseq: ``conv_layers.{i}.0.weight`` and
    ``.0.bias``, ``conv_layers.0.2.*`` for the GroupNorm and
    ``conv_layers.{i}.2.1.*`` for a block's LayerNorm."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]], mode: str = "default",
                 conv_bias: bool = False, device=None):
        super().__init__()
        self.spec = tuple(tuple(c) for c in conv_layers)
        self.mode = mode
        self.fused = mode == "default" and not conv_bias and len(self.spec) > 1 \
            and fusable(self.spec[1:])
        blocks, c_in = [], 1
        for i, (d, k, s) in enumerate(self.spec):
            conv = nn.Conv1d(c_in, d, k, stride=s, bias=conv_bias, device=device)
            if mode == "layer_norm":  # fairseq's (TransposeLast, LayerNorm, TransposeLast)
                extra = [nn.Identity(), nn.ModuleList([nn.Identity(),
                                                       FP32LayerNorm(d, device=device)])]
            else:
                extra = [nn.Identity(), FP32GroupNorm(d, d, device=device)] if i == 0 else []
            blocks.append(nn.ModuleList([conv] + extra))
            c_in = d
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        dtype = wav.dtype
        conv0 = self.conv_layers[0][0]
        d0, k0, s0 = self.spec[0]
        if self.fused:
            gn = self.conv_layers[0][2]
            x = wav.unfold(1, k0, s0) @ conv0.weight.to(dtype).reshape(d0, k0).t()
            scale, shift = gn_scale_shift(x, gn.weight, gn.bias, gn.eps)
            weights = [blk[0].weight.to(dtype).permute(2, 1, 0) for blk in self.conv_layers[1:]]
            return conv_stack(x, weights, self.spec[1:], scale, shift)
        # block 0: an im2col matmul summed in fp32 (JAX's tap-decomposed
        # einsum with preferred_element_type=f32), the bias added before the cast
        w0 = conv0.weight.to(dtype).float().reshape(d0, k0)
        x = F.linear(wav.unfold(1, k0, s0).float(), w0,
                     None if conv0.bias is None else conv0.bias.float()).to(dtype)
        x = gelu_exact(self._norm(0, x))
        for i, blk in enumerate(self.conv_layers[1:], start=1):
            conv, (d, k, s) = blk[0], self.spec[i]
            w = conv.weight.to(dtype)
            bias = None if conv.bias is None else conv.bias.float()
            if k == s:  # non-overlapping windows: one matmul summed in fp32 (conv.py:88-99)
                b, t, c = x.shape
                r = x[:, : t // s * s].reshape(b, t // s, s * c)
                y = F.linear(r.float(), w.permute(0, 2, 1).reshape(d, s * c).float(), bias)
            else:  # a conv in dtype, then the fp32 bias
                y = F.conv1d(x.transpose(1, 2), w, stride=s).transpose(1, 2)
                if bias is not None:
                    y = y.float() + bias
            x = gelu_exact(self._norm(i, y.to(dtype)))
        return x

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "layer_norm":
            return self.conv_layers[i][2][1](x)
        return self.conv_layers[0][2](x) if i == 0 else x


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
    """``F.conv1d`` (stride 1) with a deterministic backward, for
    ``SameConv1d``'s grouped convs (the multi-layer positional conv, the
    conformer's depthwise conv, the heads' convs). cuDNN's heuristics pick an
    input-gradient algorithm for a wide grouped conv (768 wide, groups 16, k
    128) that sums in another order from run to run on an H100, so two
    identical train steps gave different gradients below it; its
    deterministic input-gradient kernel took 22 ms a step there. So the
    input gradient is computed as the forward convolution it equals: each
    group's kernel transposed and flipped in time (``flipped``), padded by
    k - 1 - p. The weight gradient keeps cuDNN's with the deterministic flag
    (``conv_weight_grads``), as the positional conv's does."""

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
            gx = F.conv1d(grad, flipped(w, g), padding=k - 1 - ctx.padding, groups=g)
        gw = gb = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw, gb = conv_weight_grads(grad, x, w, ctx.padding, g, ctx.needs_input_grad[1],
                                       ctx.needs_input_grad[2])
        return gx, gw, gb, None, None


class SameConv1d(nn.Conv1d):
    """Stride-1 conv over (B, T, C_in) -> (B, T', C_out), zero-padded by
    ``padding`` on both sides, in x's dtype. The product is rounded to
    x's dtype before the fp32 bias is added (a JAX bf16 conv plus an fp32
    bias). On the CPU a bf16 conv sums in fp32 and rounds once: the CPU's
    bf16 grouped conv1d is wrong at some shapes. A grouped conv's input
    gradient is ``_GroupedConv1d``'s forward conv of flipped kernels, which
    sums in the same order on every run."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, padding: int = 0,
                 groups: int = 1, bias: bool = True, device=None):
        super().__init__(c_in, c_out, kernel_size, padding=padding, groups=groups, bias=bias,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if self.kernel_size[0] == 1 and self.groups == 1:  # pointwise: one matmul
            y = F.linear(x, self.weight[:, :, 0].to(dtype))
        else:
            xt, w = x.transpose(1, 2), self.weight.to(dtype)
            if x.device.type == "cpu" and dtype != torch.float32:
                xt, w = xt.float(), w.float()
            y = _GroupedConv1d.apply(xt, w, None, self.padding[0], self.groups)
            y = y.to(dtype).transpose(1, 2)
        if self.bias is not None:
            y = (y + self.bias).to(dtype)
        return y


class PositionalConv(nn.Module):
    """Grouped weight-normed conv + SamePad + exact GELU over (B, T, C).
    w[:, :, k] = g[k] * v[:, :, k] / ||v[:, :, k]||. The conv is
    ``kernels/pos_conv.py positional_conv``: the kernel on the card, the
    fp32-summed ``F.conv1d`` on the CPU, in the (B, T, C) layout either way.
    The single child is named ``0`` so the keys read ``pos_conv.0.weight_g``
    as in the reference."""

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
        return gelu_exact(positional_conv(x, w, conv.bias.to(x.dtype), self.groups))


class MultiLayerPositionalConv(nn.Module):
    """``pos_conv_depth`` > 1 (``fithubert_tpu/ops/conv.py:435-462``):
    ``depth`` blocks, each a grouped conv of kernel k = max(3, conv_pos //
    depth), padding k // 2 and a bias (``SameConv1d``), SamePad for an even
    k, an fp32 LayerNorm without affine, then the exact GELU. Block i is
    child ``i`` and its conv child ``0``, so the keys read
    ``pos_conv.{i}.0.weight`` as fairseq's ``make_conv_block`` names them."""

    def __init__(self, embed_dim: int, depth: int, kernel_size: int, groups: int,
                 device=None):
        super().__init__()
        self.k = max(3, kernel_size // depth)
        for i in range(depth):
            self.add_module(str(i), nn.ModuleList([
                SameConv1d(embed_dim, embed_dim, self.k, padding=self.k // 2, groups=groups,
                           device=device),
                nn.Identity(),
                FP32LayerNorm(embed_dim, device=device, use_affine=False)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, _, norm in self.children():
            x = conv(x)
            if self.k % 2 == 0:
                x = x[:, :-1]
            x = gelu_exact(norm(x))
        return x


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
