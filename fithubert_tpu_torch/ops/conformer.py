"""The conformer family (``fithubert_tpu/ops/conformer.py``): fairseq's
ConformerWav2Vec2EncoderLayer and the reference's ConformerEncoder, with
espnet's relative-position (``rel_pos``), rotary (``rope``) or absolute
(``abs``) attention.

  rel_positional_encoding  ≙ conformer.py:31, positions T-1 .. -(T-1)
  rel_shift                ≙ :41, (B, H, T, 2T-1) -> (B, H, T, T)
  RelPositionAttention     ≙ :50, Transformer-XL style (pos_bias_u / _v)
  apply_rotary             ≙ :115, RotaryAttention ≙ :130
  FeedForwardModule        ≙ :180, LayerNorm -> w_1 -> SiLU -> w_2
  RowMaskedBatchNorm       ≙ :201
  ConvolutionModule        ≙ :257, pointwise -> GLU -> depthwise ->
                             BatchNorm -> SiLU -> pointwise, bias-free
  ConformerEncoderLayer    ≙ :292, macaron: 1/2 FFN, attention, conv
                             module, 1/2 FFN, LayerNorm
  ConformerEncoder         ≙ :394, rel_pos / rope: no TR module, no
                             pad_to_multiple, no positional conv

The QK, positional and PV products are plain matmuls, as they are XLA
einsums outside any Pallas kernel there; the materialised probabilities are
dropped by ``seeded_dropout`` (K5), seeded per call from the forward's
``DropoutRNG``, whose backward regenerates the mask. Masked keys get the
finite -1e30, so a row of padding only (``pad_batch_to_full``) attends
uniformly instead of turning NaN; with taps they get -inf and the NaN
probabilities of such a row are zeroed, as the attention losses read true
fairseq logits (``:90-97``).

``RowMaskedBatchNorm`` keeps torch's buffer names (``running_mean``,
``running_var``) beside ``weight`` / ``bias``. A training forward (one
given a ``DropoutRNG``) normalises with the batch's statistics, weighting
out the rows that are padding end to end, and moves the buffers by
0.9 old + 0.1 batch (the variance biased); every other forward normalises
with the buffers. ``num_batches_tracked`` of a torch BatchNorm's state is
accepted on load and dropped.

Parameter names are fairseq's and espnet's: ``ffn1`` / ``ffn2``
(``layer_norm``, ``w_1``, ``w_2``), ``self_attn`` (``linear_q/k/v/out``,
``linear_pos``, ``pos_bias_u``, ``pos_bias_v``; ``q_proj`` ... for an
``attn_type`` other than ``espnet``), ``self_attn_layer_norm``,
``conv_module`` (``layer_norm``, ``pointwise_conv1``, ``depthwise_conv``,
``batch_norm``, ``pointwise_conv2``) and ``final_layer_norm``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.ops.activations import glu, silu
from fithubert_tpu_torch.ops.attention import (
    AttentionTaps,
    EspnetAttention,
    MultiHeadSelfAttention,
    linear,
)
from fithubert_tpu_torch.ops.conv import SameConv1d
from fithubert_tpu_torch.ops.dropout import DropoutRNG, dropout
from fithubert_tpu_torch.ops.kernels.dropout import seeded_dropout
from fithubert_tpu_torch.ops.norms import FP32LayerNorm
from fithubert_tpu_torch.ops.padding import apply_padding_mask
from fithubert_tpu_torch.ops.quant import dense
from fithubert_tpu_torch.ops.transformer import EncoderOutput


def rel_positional_encoding(t: int, d: int, dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """espnet's RelPositionalEncoding table (2T-1, d): rows for relative
    positions T-1 .. -(T-1), sin on even channels and cos on odd ones,
    built in fp32 and cast to ``dtype``."""
    pos = torch.arange(t - 1, -t, -1.0, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / d))[None, :]
    pe = torch.zeros(2 * t - 1, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """espnet's rel_shift: (B, H, T, 2T-1) scores against the table's rows
    -> (B, H, T, T), entry (i, j) taken at relative position i - j."""
    b, h, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)
    return x[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def _attend(logits: torch.Tensor, v: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
            p: float, rng: Optional[DropoutRNG], neg_inf: bool, need_taps: bool
            ) -> Tuple[torch.Tensor, Optional[AttentionTaps]]:
    """Softmax over fp32 ``logits`` (B, H, T, T), K5 dropout, then the
    probabilities in v's dtype times v (B, T, H, D) summed in fp32: the
    output (B, T, H * D) in v's dtype, and the taps when asked."""
    b, t, h, d = v.shape
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf") if neg_inf else -1e30)
    probs = torch.softmax(logits, dim=-1)
    if neg_inf:  # a row of padding only softmaxes -inf to NaN
        probs = torch.where(torch.isnan(probs), 0.0, probs)
    if rng is not None and p > 0.0:  # a training forward
        probs = seeded_dropout(probs, rng.seed_words(), p)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()).to(v.dtype)
    taps = None
    if need_taps:
        v32 = v.float().permute(0, 2, 1, 3).reshape(b * h, t, d)
        taps = AttentionTaps(logits.reshape(b * h, t, t),
                             torch.matmul(v32 / math.sqrt(d), v32.transpose(1, 2)))
    return out.reshape(b, t, h * d), taps


class _EspnetProjections(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device=None,
                 quantize: bool = False):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            self.add_module(name, dense(embed_dim, embed_dim, quantize, device=device))


class RelPositionAttention(_EspnetProjections):
    """espnet's RelPositionMultiHeadedAttention: logits (q + u) k^T plus
    rel_shift((q + v_bias) p^T), p = linear_pos(the table), over sqrt(d_k).
    q + u is fp32 (a bf16 q meets the fp32 biases), so both products are."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device=None,
                 quantize: bool = False):
        super().__init__(embed_dim, num_heads, dropout, device, quantize)
        dk = embed_dim // num_heads
        self.linear_pos = dense(embed_dim, embed_dim, quantize, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dk, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dk, device=device))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False,
                neg_inf: Optional[bool] = None):
        b, t, c = x.shape
        h = self.num_heads
        dk = c // h
        q = linear(x, self.linear_q).view(b, t, h, dk)
        k = linear(x, self.linear_k).view(b, t, h, dk)
        v = linear(x, self.linear_v).view(b, t, h, dk)
        p = linear(pos_emb, self.linear_pos).view(1, -1, h, dk)
        ac = torch.einsum("bqhd,bkhd->bhqk", q.float() + self.pos_bias_u, k.float())
        bd = torch.einsum("bqhd,zkhd->bhqk", q.float() + self.pos_bias_v, p.float())
        logits = (ac + rel_shift(bd)) / math.sqrt(dk)
        out, taps = _attend(logits, v, key_padding_mask, self.dropout, rng,
                            need_taps if neg_inf is None else neg_inf, need_taps)
        return linear(out, self.linear_out), taps


def apply_rotary(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding of (B, T, H, D), D even: each half-dim pair rotated
    by position x frequency; cos and sin are built in fp32 and cast to x's
    dtype, and the rotation computes in x's dtype."""
    b, t, h, d = x.shape
    half = d // 2
    inv = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class RotaryAttention(_EspnetProjections):
    """fairseq's RotaryPositionMultiHeadedAttention: the input, viewed per
    head, is rotated BEFORE linear_q / linear_k; linear_v reads it
    unrotated. Logits q k^T summed in fp32 over sqrt(d_k)."""

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False,
                neg_inf: Optional[bool] = None):
        b, t, c = x.shape
        h = self.num_heads
        dk = c // h
        x_rot = apply_rotary(x.reshape(b, t, h, dk)).reshape(b, t, c)
        q = linear(x_rot, self.linear_q).view(b, t, h, dk)
        k = linear(x_rot, self.linear_k).view(b, t, h, dk)
        v = linear(x, self.linear_v).view(b, t, h, dk)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dk)
        out, taps = _attend(logits, v, key_padding_mask, self.dropout, rng,
                            need_taps if neg_inf is None else neg_inf, need_taps)
        return linear(out, self.linear_out), taps


class FeedForwardModule(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float, device=None,
                 quantize: bool = False):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = FP32LayerNorm(embed_dim, device=device)
        self.w_1 = dense(embed_dim, ffn_dim, quantize, device=device)
        self.w_2 = dense(ffn_dim, embed_dim, quantize, device=device)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = dropout(silu(linear(self.layer_norm(x), self.w_1)), self.dropout, rng)
        return dropout(linear(x, self.w_2), self.dropout, rng)


class RowMaskedBatchNorm(nn.Module):
    """BatchNorm over the (B, T) rows of (B, T, C) whose batch statistics
    leave out the rows that are padding end to end (``row_valid`` False):
    the reference's batches never hold such rows, so their responses must
    not move the statistics. A real row's padded frames count, as in
    fairseq's unmasked BatchNorm. Under data parallelism
    (``sum_over_ranks``) the statistics are the global batch's, as the JAX
    mesh takes them, in the manner of SyncBatchNorm: the row weights and
    the weighted sum of x are summed over the ranks, then, after the global
    mean, the weighted squares (JAX's two-pass variance); the backward sums
    their gradients over the ranks, and every rank moves its buffers the
    same way."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))
        # set by a data-parallel Distiller: a sum over the ranks with its
        # gradient summed too (DataParallel.sum_with_grad)
        self.sum_over_ranks: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, row_valid: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train:
            w = torch.ones(x.shape[:2], device=x.device) if row_valid is None else \
                row_valid.float()[:, None].expand(x.shape[:2])
            total = self.sum_over_ranks or (lambda t: t)
            sums = total(torch.cat([w.sum()[None], (x32 * w[..., None]).sum((0, 1))]))
            denom = torch.clamp(sums[0], min=1.0)
            mean = sums[1:] / denom
            var = total(((x32 - mean) ** 2 * w[..., None]).sum((0, 1))) / denom
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class ConvolutionModule(nn.Module):
    def __init__(self, embed_dim: int, kernel_size: int, dropout: float, device=None):
        super().__init__()
        if (kernel_size - 1) % 2:
            raise ValueError(f"depthwise_conv_kernel_size {kernel_size} must be odd")
        self.dropout = dropout
        self.layer_norm = FP32LayerNorm(embed_dim, device=device)
        self.pointwise_conv1 = SameConv1d(embed_dim, 2 * embed_dim, 1, bias=False, device=device)
        self.depthwise_conv = SameConv1d(embed_dim, embed_dim, kernel_size,
                                         padding=(kernel_size - 1) // 2, groups=embed_dim,
                                         bias=False, device=device)
        self.batch_norm = RowMaskedBatchNorm(embed_dim, device=device)
        self.pointwise_conv2 = SameConv1d(embed_dim, embed_dim, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = glu(self.pointwise_conv1(self.layer_norm(x)))
        x = self.batch_norm(self.depthwise_conv(x), row_valid, train=rng is not None)
        return dropout(self.pointwise_conv2(silu(x)), self.dropout, rng)


class ConformerEncoderLayer(nn.Module):
    """Returns (x, taps, layer_result), layer_result the second FFN's
    output before its residual. The attention follows fairseq's dispatch:
    the espnet attentions only under ``attn_type == 'espnet'`` (rel_pos,
    rope, else abs), the plain fairseq MHA for any other attn_type. Every
    dropout of the layer is ``dropout`` (the conformer reads no
    attention_dropout or activation_dropout)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, dropout: float,
                 depthwise_conv_kernel_size: int = 31, pos_enc_type: str = "abs",
                 attn_type: str = "espnet", device=None, quantize: bool = False):
        super().__init__()
        self.dropout = dropout
        self.ffn1 = FeedForwardModule(embed_dim, ffn_dim, dropout, device, quantize)
        self.self_attn_layer_norm = FP32LayerNorm(embed_dim, device=device)
        if attn_type != "espnet":
            attn = MultiHeadSelfAttention
        else:
            attn = {"rel_pos": RelPositionAttention,
                    "rope": RotaryAttention}.get(pos_enc_type, EspnetAttention)
        self.self_attn = attn(embed_dim, num_heads, dropout, device, quantize)
        self.conv_module = ConvolutionModule(embed_dim, depthwise_conv_kernel_size, dropout,
                                             device)
        self.ffn2 = FeedForwardModule(embed_dim, ffn_dim, dropout, device, quantize)
        self.final_layer_norm = FP32LayerNorm(embed_dim, device=device)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False,
                pos_emb: Optional[torch.Tensor] = None, neg_inf: Optional[bool] = None):
        """``neg_inf`` (default ``need_taps``): -inf at masked keys of the
        espnet attentions, as the JAX package's layers take with taps."""
        x = self.ffn1(x, rng) * 0.5 + x
        y = self.self_attn_layer_norm(x)
        if isinstance(self.self_attn, RelPositionAttention):
            y, taps = self.self_attn(y, pos_emb, padding_mask, rng, need_taps, neg_inf)
        elif isinstance(self.self_attn, RotaryAttention):
            y, taps = self.self_attn(y, padding_mask, rng, need_taps, neg_inf)
        else:
            y, taps = self.self_attn(y, padding_mask, rng, need_taps)
        x = dropout(y, self.dropout, rng) + x
        row_valid = None if padding_mask is None else ~padding_mask.all(-1)
        x = x + self.conv_module(x, rng, row_valid)
        layer_result = self.ffn2(x, rng)
        return self.final_layer_norm(layer_result * 0.5 + x), taps, layer_result


class ConformerEncoder(nn.Module):
    """The rel_pos / rope conformer stack: the padding zeroed, the position
    table (rel_pos), the LayerNorm (unless ``layer_norm_first``), input
    dropout, the layers and layerdrop; no TR module, no pad_to_multiple.
    The reference's encoder keeps the positional conv it inherits but never
    runs it: its ``pos_conv.*`` keys are dropped on load."""

    def __init__(self, cfg: StudentConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embed_dim
        self.layer_norm = FP32LayerNorm(e, device=device)
        self.layers = nn.ModuleList([
            ConformerEncoderLayer(e, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads,
                                  cfg.dropout, cfg.depthwise_conv_kernel_size, cfg.pos_enc_type,
                                  cfg.attn_type, device=device, quantize=cfg.quantize_matmuls)
            for _ in range(cfg.encoder_layers)])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in [k for k in state_dict if k.startswith(prefix + "pos_conv.")]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                tgt_slot: Optional[int] = None, rng: Optional[DropoutRNG] = None,
                need_taps: bool = False):
        """``tgt_slot`` stops after that layer (no TR module: slots are
        layers). ``need_taps``: the last layer that runs returns its taps,
        and every layer masks keys with -inf, as the JAX package's layers
        do when all of them return taps."""
        cfg = self.cfg
        x = apply_padding_mask(x, padding_mask)
        pos_emb = (rel_positional_encoding(x.shape[1], cfg.encoder_embed_dim, x.dtype, x.device)
                   if cfg.pos_enc_type == "rel_pos" else None)
        if not cfg.layer_norm_first:
            x = self.layer_norm(x)
        x = dropout(x, cfg.dropout, rng)
        last = len(self.layers) - 1 if tgt_slot is None else min(tgt_slot, len(self.layers) - 1)
        layer_results = []
        for i, layer in enumerate(self.layers[:last + 1]):
            y, taps, layer_result = layer(x, padding_mask, rng, need_taps and i == last,
                                          pos_emb, need_taps)
            if rng is None or cfg.encoder_layerdrop <= 0.0 \
                    or rng.uniform() > cfg.encoder_layerdrop:
                x = y
            layer_results.append((x, taps, layer_result))
        return EncoderOutput(x, layer_results, [], padding_mask)
