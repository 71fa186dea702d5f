"""Multi-head self-attention (``fithubert_tpu/ops/attention.py:33``): q is
scaled by head_dim**-0.5 before QK^T.

Without taps the attention runs in ``flash_attention``: in a training
forward the probabilities are dropped with ``dropout`` inside the kernel,
seeded per call by the next slot of the forward's ``DropoutRNG`` seed
table, which the kernel reads from device memory (``attention.py:80-96``),
and no taps are returned.

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

Under a model axis (``parallel/mesh.py``) a sharded attention computes its
``num_heads / model`` local heads: ``linear`` runs q/k/v column-parallel
and the output projection row-parallel, the kernels see (B, T, H_local,
D), the dropout of its probabilities folds in the model rank
(``DropoutRNG.seed_words(sharded=True)``), and its taps are gathered over
the row into one process's (B*H, T, T) order (``gather_taps``).
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
from fithubert_tpu_torch.parallel.mesh import COLUMN, ROW


class AttentionTaps(NamedTuple):
    attn_logits: torch.Tensor  # (B*H, T, T) fp32, -inf at padded keys
    v_rel: torch.Tensor  # (B*H, T, T) fp32: (v * scaling) @ v^T


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (fp32 parameters, compute-dtype matmul),
    through the int8 product where ``layer`` is marked ``quantize``
    (``ops/quant.py``). A column-parallel layer (``tp_mode``, set by
    ``parallel/mesh.py shard_``) reads ``copy_to_model(x)``; a row-parallel
    one sums its partial products over the row, then adds its bias."""
    tp, mode = getattr(layer, "tp", None), getattr(layer, "tp_mode", None)
    if mode == COLUMN:
        x = tp.copy(x)
    if getattr(layer, "quantize", False):
        return quantized_linear(x, layer)
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    if mode == ROW:
        y = tp.reduce(F.linear(x, layer.weight.to(x.dtype)))
        return y if bias is None else y + bias
    return F.linear(x, layer.weight.to(x.dtype), bias)


def gather_taps(taps: AttentionTaps, tp, b: int) -> AttentionTaps:
    """Taps of (B*H_local, T, T), b-major, gathered over the model row on
    the head axis into one process's (B*H, T, T); the backward slices."""
    def gather(t):
        return tp.gather(t.reshape(b, -1, *t.shape[1:]), 1).flatten(0, 1)

    return AttentionTaps(gather(taps.attn_logits), gather(taps.v_rel))


def attention_with_taps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: Optional[torch.Tensor], dropout_p: float,
                        rng: Optional[DropoutRNG], sharded: bool = False
                        ) -> Tuple[torch.Tensor, AttentionTaps]:
    """The materialised branch over pre-scaled q and k, v, all (B, T, H, D):
    returns the attention output (B, T, H, D) in q's dtype and the taps.
    ``sharded``: the heads are a model rank's (the dropout's words fold in
    its rank)."""
    b, t, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # a fully padded row softmaxes to NaN; zero it so the value path stays
    # finite (the losses scrub the -inf logits themselves)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    if rng is not None and dropout_p > 0.0:
        probs = seeded_dropout(probs, rng.seed_words(sharded), dropout_p)
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
        self.tp = None  # the model axis, when its projections are sharded
        for name in self.PROJ_NAMES:
            self.add_module(name, dense(embed_dim, embed_dim, quantize, device=device))

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False
                ) -> Tuple[torch.Tensor, Optional[AttentionTaps]]:
        """(out, taps): taps is None unless ``need_taps``. Deterministic
        unless a ``rng`` is given."""
        q_proj, k_proj, v_proj, out_proj = (self._modules[n] for n in self.PROJ_NAMES)
        b, t, c = x.shape
        d = c // self.num_heads
        q = linear(x, q_proj) * d ** -0.5
        shape = (b, t, q.shape[-1] // d, d)  # this rank's heads
        q = q.view(shape)
        k = linear(x, k_proj).view(shape)
        v = linear(x, v_proj).view(shape)
        p = self.dropout if rng is not None else 0.0
        sharded = self.tp is not None
        if need_taps:
            out, taps = attention_with_taps(q, k, v, key_padding_mask, p, rng, sharded)
            if sharded:
                taps = gather_taps(taps, self.tp, b)
        else:
            out = flash_attention(q, k, v, key_padding_mask, dropout_p=p,
                                  seed=rng.seed_words(sharded) if p > 0.0 else None)
            taps = None
        return linear(out.reshape(b, t, -1), out_proj), taps


class EspnetAttention(MultiHeadSelfAttention):
    """espnet's ESPNETMultiHeadedAttention, a conformer's ``abs`` attention
    under ``attn_type: espnet``: the same scaled-dot attention (the JAX
    package runs its MultiHeadSelfAttention there,
    ``fithubert_tpu/ops/conformer.py:338-346``) under espnet's names."""

    PROJ_NAMES = ("linear_q", "linear_k", "linear_v", "linear_out")
