"""Transformer encoder with the time-reduction layer in its layer list
(``fithubert_tpu/ops/transformer.py``): ``TransformerEncoderLayer`` (:52,
its FFN's activation from ``ACTIVATIONS``),
the ``TimeReduction`` types (:135-194: conv1d, fc1, fc2) and
``TransformerEncoder`` (:215, the positional conv of ``pos_conv_depth``
blocks when it is above 1), run as an unrolled loop. With ``layer_type:
conformer`` (and ``pos_enc_type: abs``; rel_pos and rope have their own
encoder in ``ops/conformer.py``) its layers are ``ConformerEncoderLayer``s
with fairseq's attention (:349-371). As in the
reference, the TR module sits in ``encoder.layers`` at ``tr_layer_index``,
so state-dict indices count it: ``encoder.layers.{slot}.weight`` for conv1d
and fc1, ``.0`` / ``.2`` for fc2's two Linears (the keys the reference
importer maps, ``fithubert_tpu/export/reference_import.py:91-103``).

Given a ``DropoutRNG`` a forward trains: drop1/drop2/drop3 in both LN orders
(``:99-130``), the dropout of the encoder input (``:283``), attention
dropout, and the layerdrop gate (``:386-389``). Without one it is
deterministic.

With ``need_taps`` only the last transformer layer that runs takes the
attention's materialised taps branch and returns ``AttentionTaps`` in its
``layer_results`` entry; every other layer keeps the flash kernel and its
in-kernel dropout, and its taps entry is None. The attention-transfer
losses read only ``layer_results[-1]``'s taps (``fithubert_tpu/train/
losses.py:310-311,342-343``), and the JAX package leaves XLA to drop the
other layers' taps (``transformer.py:296-298``): materialising (B*H, T, T)
logits in every layer would cost memory and time for tensors no one reads.
So with dropout off the output equals the JAX package's need_taps forward
except in rows whose keys are all padding, where the other layers give what
``flash_attention`` gives there; with dropout on the random bits differ too
(K2's mask in the other layers where the JAX package draws K5's)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.ops.activations import ACTIVATIONS, gelu_exact
from fithubert_tpu_torch.ops.attention import AttentionTaps, MultiHeadSelfAttention, linear
from fithubert_tpu_torch.ops.conv import Conv1D, MultiLayerPositionalConv, PositionalConv
from fithubert_tpu_torch.ops.dropout import DropoutRNG, dropout
from fithubert_tpu_torch.ops.norms import FP32LayerNorm
from fithubert_tpu_torch.ops.padding import (
    apply_padding_mask,
    pad_to_multiple,
    reduce_padding_mask,
)
from fithubert_tpu_torch.ops.quant import dense


class EncoderOutput(NamedTuple):
    x: torch.Tensor  # (B, T', C) final hidden states
    # per transformer layer: (hidden, taps (None but in the taps layer), ffn pre-residual)
    layer_results: List[Tuple[torch.Tensor, Optional[AttentionTaps], torch.Tensor]]
    tr_layer_results: List[torch.Tensor]
    padding_mask: Optional[torch.Tensor]  # time-reduced (B, T')


class TransformerEncoderLayer(nn.Module):
    """Pre-/post-LN block. Returns (x, taps, layer_result), where taps is the
    attention's ``AttentionTaps`` (None unless ``need_taps``) and
    layer_result the FFN output before drop3 and the residual. The FFN's
    activation is ``ACTIVATIONS[activation_fn]``; ``quantize`` makes q/k/v,
    out, fc1 and fc2 int8."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 layer_norm_first: bool = False, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 device=None, activation_fn: str = "gelu", quantize: bool = False):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.act = ACTIVATIONS[activation_fn]
        self.self_attn = MultiHeadSelfAttention(embed_dim, num_heads, attention_dropout,
                                                device=device, quantize=quantize)
        self.self_attn_layer_norm = FP32LayerNorm(embed_dim, device=device)
        self.fc1 = dense(embed_dim, ffn_dim, quantize, device=device)
        self.fc2 = dense(ffn_dim, embed_dim, quantize, device=device)
        self.final_layer_norm = FP32LayerNorm(embed_dim, device=device)

    def _ffn(self, x, rng):
        h = dropout(self.act(linear(x, self.fc1)), self.activation_dropout, rng)
        return linear(h, self.fc2)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False):
        if self.layer_norm_first:
            y, taps = self.self_attn(self.self_attn_layer_norm(x), padding_mask, rng, need_taps)
            x = x + dropout(y, self.dropout, rng)
            y = self._ffn(self.final_layer_norm(x), rng)
            return x + dropout(y, self.dropout, rng), taps, y
        y, taps = self.self_attn(x, padding_mask, rng, need_taps)
        x = self.self_attn_layer_norm(x + dropout(y, self.dropout, rng))
        y = self._ffn(x, rng)
        return self.final_layer_norm(x + dropout(y, self.dropout, rng)), taps, y


def concat_frames(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, ceil(T / f), f * C): T zero-padded to a multiple of
    f, then each f consecutive frames concatenated channel-wise in frame
    order (the reference's ``concat_channelwise``)."""
    b, t, c = x.shape
    x, _ = pad_to_multiple(x, factor, axis=-2)
    return x.reshape(b, x.shape[1] // factor, factor * c)


class TimeReductionFC1(nn.Linear):
    """fc1: concatenated frames -> Linear(f * d -> d)."""

    def __init__(self, embed_dim: int, factor: int, device=None):
        super().__init__(embed_dim * factor, embed_dim, device=device)
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(concat_frames(x, self.factor), self)


class TimeReductionFC2(nn.Module):
    """fc2: concatenated frames -> Linear(f * d -> f * d) -> exact GELU ->
    Linear(f * d -> d); the Linears are children ``0`` and ``2``, as in the
    reference's Sequential."""

    def __init__(self, embed_dim: int, factor: int, device=None):
        super().__init__()
        self.factor = factor
        self.add_module("0", nn.Linear(embed_dim * factor, embed_dim * factor, device=device))
        self.add_module("2", nn.Linear(embed_dim * factor, embed_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_exact(linear(concat_frames(x, self.factor), self._modules["0"]))
        return linear(h, self._modules["2"])


def time_reduction(cfg: StudentConfig, device=None) -> nn.Module:
    """The TR module of ``cfg.tr_layer_type``. conv1d's kernel is the
    factor (the reference ignores ``tr_conv1d_kernel``)."""
    e, f = cfg.encoder_embed_dim, cfg.tr_reduce_factor
    if cfg.tr_layer_type == "conv1d":
        return Conv1D(e, e, f, device=device)
    if cfg.tr_layer_type == "fc1":
        return TimeReductionFC1(e, f, device=device)
    if cfg.tr_layer_type == "fc2":
        return TimeReductionFC2(e, f, device=device)
    raise NotImplementedError("tr_layer_type must be one of ['fc1', 'fc2', 'conv1d']")


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: StudentConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embed_dim
        self.pos_conv = (MultiLayerPositionalConv(e, cfg.pos_conv_depth, cfg.conv_pos,
                                                  cfg.conv_pos_groups, device=device)
                         if cfg.pos_conv_depth > 1 else
                         PositionalConv(e, cfg.conv_pos, cfg.conv_pos_groups, device=device))
        self.layer_norm = FP32LayerNorm(e, device=device)
        self.tr_slot = cfg.tr_layer_index if cfg.enable_tr_layer else -1
        n_slots = cfg.encoder_layers + (1 if cfg.enable_tr_layer else 0)
        if cfg.layer_type == "conformer":
            # abs conformer layers in this encoder (fithubert_tpu/ops/
            # transformer.py:349-371): fairseq's MHA, every dropout cfg.dropout
            from fithubert_tpu_torch.ops.conformer import ConformerEncoderLayer

            def layer():
                return ConformerEncoderLayer(e, cfg.encoder_ffn_embed_dim,
                                             cfg.encoder_attention_heads, cfg.dropout,
                                             cfg.depthwise_conv_kernel_size, "abs",
                                             cfg.attn_type, device=device,
                                             quantize=cfg.quantize_matmuls)
        else:
            def layer():
                return TransformerEncoderLayer(e, cfg.encoder_ffn_embed_dim,
                                               cfg.encoder_attention_heads,
                                               cfg.layer_norm_first, cfg.dropout,
                                               cfg.attention_dropout, cfg.activation_dropout,
                                               device=device, activation_fn=cfg.activation_fn,
                                               quantize=cfg.quantize_matmuls)
        self.layers = nn.ModuleList([
            time_reduction(cfg, device=device) if slot == self.tr_slot else layer()
            for slot in range(n_slots)
        ])

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                tgt_slot: Optional[int] = None,
                rng: Optional[DropoutRNG] = None, need_taps: bool = False) -> EncoderOutput:
        """``tgt_slot`` stops after that slot of the layer list (the TR
        module counts), like the reference's tgt_layer. Deterministic
        unless a ``rng`` is given. ``need_taps``: the last transformer
        layer that runs returns its attention taps."""
        cfg = self.cfg
        last = len(self.layers) - 1 if tgt_slot is None else min(tgt_slot, len(self.layers) - 1)
        taps_slot = max((s for s in range(last + 1) if s != self.tr_slot), default=-1) \
            if need_taps else -1
        x = apply_padding_mask(x, padding_mask)
        x = x + self.pos_conv(x)
        if not cfg.layer_norm_first:
            x = self.layer_norm(x)

        x, pad_length = pad_to_multiple(x, cfg.required_seq_len_multiple, axis=-2)
        if pad_length > 0 and padding_mask is None:
            padding_mask = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
            padding_mask[:, -pad_length:] = True
        elif padding_mask is not None:
            padding_mask, _ = pad_to_multiple(
                padding_mask, cfg.required_seq_len_multiple, axis=-1, value=True)
        x = dropout(x, cfg.dropout, rng)

        layer_results, tr_layer_results = [], []
        for slot, layer in enumerate(self.layers):
            if slot == self.tr_slot:
                x = layer(x)
                tr_layer_results.append(x)
                # the fc types pad x to ceil(T / f) frames; the mask follows
                padding_mask = reduce_padding_mask(padding_mask, cfg.tr_reduce_factor,
                                                   ceil=cfg.tr_layer_type in ("fc1", "fc2"))
            else:
                y, taps, layer_result = layer(x, padding_mask, rng, slot == taps_slot)
                if rng is None or cfg.encoder_layerdrop <= 0.0 \
                        or rng.uniform() > cfg.encoder_layerdrop:
                    x = y
                layer_results.append((x, taps, layer_result))
            if tgt_slot is not None and slot >= tgt_slot:
                break

        # undo pad_to_multiple; after a TR layer the pad is folded into frames.
        # The taps keep the padded length, as in the JAX package (:407-410).
        if pad_length > 0 and not cfg.enable_tr_layer:
            x = x[:, :-pad_length]
            if padding_mask is not None:
                padding_mask = padding_mask[:, :-pad_length]
            layer_results = [(h[:, :-pad_length], taps, lr[:, :-pad_length])
                             for (h, taps, lr) in layer_results]

        if cfg.layer_norm_first and tgt_slot is None:
            x = self.layer_norm(x)
        return EncoderOutput(x, layer_results, tr_layer_results, padding_mask)
