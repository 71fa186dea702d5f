"""Layer-wise projection head (``fithubert_tpu/ops/heads.py:193``): a
ConvTranspose upsampler (k = s = TR factor) that undoes the time reduction,
then ``lin_proj`` from the student width to the teacher's."""

from __future__ import annotations

import torch
import torch.nn as nn

from fithubert_tpu_torch.ops.attention import linear
from fithubert_tpu_torch.ops.conv import ConvTranspose1D


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
