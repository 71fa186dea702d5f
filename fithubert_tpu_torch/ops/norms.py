"""Normalization layers computed in float32 whatever the activation dtype
(``fithubert_tpu/ops/norms.py:77 FP32LayerNorm``, ``:98 FP32GroupNorm``).
Parameters are named ``weight``/``bias`` as in torch, so state dicts keep the
reference's keys."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class FP32LayerNorm(nn.Module):
    """LayerNorm over the trailing dim; statistics and affine in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class FP32GroupNorm(nn.Module):
    """GroupNorm over (C, T) for inputs shaped (B, T, C), fp32 statistics.

    The reference's block 0 uses GroupNorm(d, d): each channel is normalized
    over time alone."""

    def __init__(self, num_groups: int, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.transpose(1, 2).to(x.dtype)
