"""Multi-head self-attention (``fithubert_tpu/ops/attention.py:33``), the
no-taps path: q is scaled by head_dim**-0.5 before QK^T and the attention
itself runs in ``flash_attention``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fithubert_tpu_torch.ops.kernels.flash_attention import flash_attention


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (fp32 parameters, compute-dtype matmul)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, c = x.shape
        h = self.num_heads
        shape = (b, t, h, c // h)
        q = (linear(x, self.q_proj) * (c // h) ** -0.5).view(shape)
        k = linear(x, self.k_proj).view(shape)
        v = linear(x, self.v_proj).view(shape)
        out = flash_attention(q, k, v, key_padding_mask)
        return linear(out.reshape(b, t, c), self.out_proj)
