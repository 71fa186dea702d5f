"""Padding-mask machinery (``fithubert_tpu/ops/padding.py``).

Masks use the reference convention: ``True`` marks a PADDING position.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def conv_out_length(length, kernel: int, stride: int):
    """floor((L - k)/s + 1)."""
    return (length - kernel) // stride + 1


def feat_extract_output_lengths(lengths, conv_layers: Sequence[Tuple[int, int, int]]):
    """The conv length formula over a full extractor spec; ints or tensors."""
    for (_, k, s) in conv_layers:
        lengths = conv_out_length(lengths, k, s)
    return lengths


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean (B, max_len) mask, True at positions t >= length."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return positions >= lengths[:, None]


def padding_mask_to_lengths(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool padding mask -> (B,) int32 valid lengths."""
    return torch.logical_not(mask).sum(-1).to(torch.int32)


def reduce_padding_mask(mask: Optional[torch.Tensor], factor: int,
                        ceil: bool = False) -> Optional[torch.Tensor]:
    """Time-reduce a padding mask for a TR layer of stride ``factor``: a
    reduced position is padding if ANY source position in its chunk is.
    ``ceil=False`` drops a trailing partial chunk; ``ceil=True`` keeps it,
    reduced over its real positions only."""
    if mask is None:
        return None
    b, t = mask.shape
    if ceil and t % factor:
        mask = F.pad(mask, (0, factor - t % factor), value=False)
        t = mask.shape[1]
    t_out = t // factor
    return mask[:, : t_out * factor].reshape(b, t_out, factor).any(-1)


def pad_to_multiple(x: Optional[torch.Tensor], multiple: int, axis: int = -1,
                    value=0):
    """Pad ``axis`` of ``x`` up to a multiple of ``multiple``.
    Returns (padded, remainder)."""
    if x is None:
        return None, 0
    if multiple <= 1:
        return x, 0
    tsz = x.shape[axis]
    remainder = math.ceil(tsz / multiple) * multiple - tsz
    if remainder == 0:
        return x, 0
    axis = axis % x.ndim
    pad = [0, 0] * (x.ndim - axis - 1) + [0, remainder]
    return F.pad(x, pad, value=value), remainder


def apply_padding_mask(x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                       value=0.0) -> torch.Tensor:
    """Fill features at padded positions: x is (B, T, C), mask (B, T)."""
    if padding_mask is None:
        return x
    return x.masked_fill(padding_mask[..., None], value)
