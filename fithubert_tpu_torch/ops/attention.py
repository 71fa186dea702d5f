"""Multi-head self-attention (``fithubert_tpu/ops/attention.py:33``): q is
scaled by head_dim**-0.5 before QK^T.

Without taps the attention runs in ``flash_attention``: in a training
forward the probabilities are dropped with ``dropout`` inside the kernel,
from two seed words drawn per call from the forward's ``DropoutRNG``
(``attention.py:80-96``), and no taps are returned.

With ``need_taps`` the probabilities are materialised, as the JAX package's
taps branch does (``:99-147``), and the layer also returns
``AttentionTaps``: the fp32 pre-softmax logits with -inf at padded keys and
the value relation (v * scaling) @ v^T, both (B*H, T, T) b-major, the
tensors the attention-transfer losses read. There the dropout of the
probabilities is ``seeded_dropout`` (K5), whose backward regenerates the
mask. The products are plain matmuls, as they are XLA einsums outside any
Pallas kernel there; they upcast bf16 operands to fp32, which gives the
fp32 accumulation of ``preferred_element_type=f32`` as long as fp32
matmuls stay out of TF32 (PyTorch's default).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fithubert_tpu_torch.ops.dropout import DropoutRNG
from fithubert_tpu_torch.ops.kernels.dropout import seeded_dropout
from fithubert_tpu_torch.ops.kernels.flash_attention import flash_attention
from fithubert_tpu_torch.ops.quant import dense, quantized_linear


class AttentionTaps(NamedTuple):
    attn_logits: torch.Tensor  # (B*H, T, T) fp32, -inf at padded keys
    v_rel: torch.Tensor  # (B*H, T, T) fp32: (v * scaling) @ v^T


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (fp32 parameters, compute-dtype matmul),
    through the int8 product where ``layer`` is marked ``quantize``
    (``ops/quant.py``)."""
    if getattr(layer, "quantize", False):
        return quantized_linear(x, layer)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def attention_with_taps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: Optional[torch.Tensor], dropout_p: float,
                        rng: Optional[DropoutRNG]) -> Tuple[torch.Tensor, AttentionTaps]:
    """The materialised branch over pre-scaled q and k, v, all (B, T, H, D):
    returns the attention output (B, T, H, D) in q's dtype and the taps."""
    b, t, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # a fully padded row softmaxes to NaN; zero it so the value path stays
    # finite (the losses scrub the -inf logits themselves)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    if rng is not None and dropout_p > 0.0:
        probs = seeded_dropout(probs, rng.seed_words(), dropout_p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float()).to(q.dtype)
    v32 = v.float().permute(0, 2, 1, 3).reshape(b * h, t, d)
    v_rel = torch.matmul(v32 * d ** -0.5, v32.transpose(1, 2))
    return out, AttentionTaps(logits.reshape(b * h, t, t), v_rel)


class MultiHeadSelfAttention(nn.Module):
    """fairseq's MultiheadAttention: the projections ``q_proj``, ``k_proj``,
    ``v_proj`` and ``out_proj`` (``PROJ_NAMES``), int8 with ``quantize``."""

    PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj")

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device=None,
                 quantize: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        for name in self.PROJ_NAMES:
            self.add_module(name, dense(embed_dim, embed_dim, quantize, device=device))

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False
                ) -> Tuple[torch.Tensor, Optional[AttentionTaps]]:
        """(out, taps): taps is None unless ``need_taps``. Deterministic
        unless a ``rng`` is given."""
        q_proj, k_proj, v_proj, out_proj = (self._modules[n] for n in self.PROJ_NAMES)
        b, t, c = x.shape
        h = self.num_heads
        shape = (b, t, h, c // h)
        q = (linear(x, q_proj) * (c // h) ** -0.5).view(shape)
        k = linear(x, k_proj).view(shape)
        v = linear(x, v_proj).view(shape)
        p = self.dropout if rng is not None else 0.0
        if need_taps:
            out, taps = attention_with_taps(q, k, v, key_padding_mask, p, rng)
        else:
            out = flash_attention(q, k, v, key_padding_mask, dropout_p=p,
                                  seed=rng.seed_words() if p > 0.0 else None)
            taps = None
        return linear(out.reshape(b, t, c), out_proj), taps


class EspnetAttention(MultiHeadSelfAttention):
    """espnet's ESPNETMultiHeadedAttention, a conformer's ``abs`` attention
    under ``attn_type: espnet``: the same scaled-dot attention (the JAX
    package runs its MultiHeadSelfAttention there,
    ``fithubert_tpu/ops/conformer.py:338-346``) under espnet's names."""

    PROJ_NAMES = ("linear_q", "linear_k", "linear_v", "linear_out")
