"""Projection heads (``fithubert_tpu/ops/heads.py``).

  LayerWiseProjHead  ≙ heads.py:193: a ConvTranspose upsampler (k = s = TR
                       factor) that undoes the time reduction, then
                       ``lin_proj`` from the student width to the teacher's
  SplitLinear        ≙ heads.py:23: one independent Linear per task over
                       the task's slice of the input, as one batched product
  MelSpecHead        ≙ heads.py:219: stride-1 convs over the mel features,
                       padding k // 2, ReLU between them
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fithubert_tpu_torch.ops.attention import linear
from fithubert_tpu_torch.ops.conv import ConvTranspose1D, SameConv1d


class LayerWiseProjHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, enable_tr_layer: bool = True,
                 tr_reduce_factor: int = 2, device=None):
        super().__init__()
        self.upsampler = (ConvTranspose1D(in_dim, in_dim, tr_reduce_factor, device=device)
                          if enable_tr_layer else None)
        self.lin_proj = (nn.Linear(in_dim, out_dim, device=device)
                         if in_dim != out_dim else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsampler is not None:
            x = self.upsampler(x)
        if self.lin_proj is not None:
            x = linear(x, self.lin_proj)
        return x


class SplitLinear(nn.Module):
    """x (B, T, N * D_in) -> (B, T, N * D_out), task n's slice through its
    own weight. ``weight`` is (N, D_in, D_out) and ``bias`` (1, 1, N, D_out),
    the reference's shapes; with N = 1 it is a plain Linear named
    ``layer``. The product takes the operands rounded to x's dtype and sums
    in fp32, the bias is added in fp32, then the result is cast to x's
    dtype, as the JAX einsum with ``preferred_element_type=float32`` does."""

    def __init__(self, in_dim: int, in_split: int, out_dim: int, device=None):
        super().__init__()
        self.in_dim, self.in_split, self.out_dim = in_dim, in_split, out_dim
        if in_split == 1:
            self.layer = nn.Linear(in_dim, out_dim, device=device)
        else:
            self.weight = nn.Parameter(torch.empty(in_split, in_dim, out_dim, device=device))
            self.bias = nn.Parameter(torch.empty(1, 1, in_split, out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_split == 1:
            return linear(x, self.layer)
        b, t, _ = x.shape
        xs = x.reshape(b, t, self.in_split, self.in_dim)
        w = self.weight.to(x.dtype)
        out = torch.einsum("btni,nio->btno", xs.float(), w.float()) + self.bias
        return out.reshape(b, t, self.in_split * self.out_dim).to(x.dtype)


class MelSpecHead(nn.Module):
    """(B, T, n_mels) -> (B, T', C_last); the convs are
    ``conv_layers.{i}``, the reference's keys. A conv spec's stride is
    ignored (1), as in the reference."""

    def __init__(self, n_mels: int, conv_layers, device=None):
        super().__init__()
        convs, c_in = [], n_mels
        for dim, k, _stride in conv_layers:
            convs.append(SameConv1d(c_in, dim, k, padding=k // 2, device=device))
            c_in = dim
        self.conv_layers = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.conv_layers):
            x = conv(x)
            if i < len(self.conv_layers) - 1:
                x = torch.relu(x)
        return x
