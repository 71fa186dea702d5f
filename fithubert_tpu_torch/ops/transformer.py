"""Transformer encoder with the time-reduction layer in its layer list
(``fithubert_tpu/ops/transformer.py``): ``TransformerEncoderLayer`` (:52),
the conv1d ``TimeReduction`` (:135) and ``TransformerEncoder`` (:215), run as
an unrolled loop. As in the reference, the TR conv sits in
``encoder.layers`` at ``tr_layer_index``, so state-dict indices count it.

Given a ``DropoutRNG`` a forward trains: drop1/drop2/drop3 in both LN orders
(``:99-130``), the dropout of the encoder input (``:283``), attention
dropout, and the layerdrop gate (``:386-389``). Without one it is
deterministic."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.ops.activations import gelu_exact
from fithubert_tpu_torch.ops.attention import MultiHeadSelfAttention, linear
from fithubert_tpu_torch.ops.conv import Conv1D, PositionalConv
from fithubert_tpu_torch.ops.dropout import DropoutRNG, dropout
from fithubert_tpu_torch.ops.norms import FP32LayerNorm
from fithubert_tpu_torch.ops.padding import (
    apply_padding_mask,
    pad_to_multiple,
    reduce_padding_mask,
)


class EncoderOutput(NamedTuple):
    x: torch.Tensor  # (B, T', C) final hidden states
    # per transformer layer: (hidden, taps (always None here), ffn pre-residual)
    layer_results: List[Tuple[torch.Tensor, None, torch.Tensor]]
    tr_layer_results: List[torch.Tensor]
    padding_mask: Optional[torch.Tensor]  # time-reduced (B, T')


class TransformerEncoderLayer(nn.Module):
    """Pre-/post-LN block. Returns (x, layer_result), where layer_result is
    the FFN output before drop3 and the residual."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 layer_norm_first: bool = False, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MultiHeadSelfAttention(embed_dim, num_heads, attention_dropout,
                                                device=device)
        self.self_attn_layer_norm = FP32LayerNorm(embed_dim, device=device)
        self.fc1 = nn.Linear(embed_dim, ffn_dim, device=device)
        self.fc2 = nn.Linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = FP32LayerNorm(embed_dim, device=device)

    def _ffn(self, x, rng):
        h = dropout(gelu_exact(linear(x, self.fc1)), self.activation_dropout, rng)
        return linear(h, self.fc2)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        if self.layer_norm_first:
            y = self.self_attn(self.self_attn_layer_norm(x), padding_mask, rng)
            x = x + dropout(y, self.dropout, rng)
            y = self._ffn(self.final_layer_norm(x), rng)
            return x + dropout(y, self.dropout, rng), y
        y = self.self_attn(x, padding_mask, rng)
        x = self.self_attn_layer_norm(x + dropout(y, self.dropout, rng))
        y = self._ffn(x, rng)
        return self.final_layer_norm(x + dropout(y, self.dropout, rng)), y


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: StudentConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embed_dim
        self.pos_conv = PositionalConv(e, cfg.conv_pos, cfg.conv_pos_groups, device=device)
        self.layer_norm = FP32LayerNorm(e, device=device)
        self.tr_slot = cfg.tr_layer_index if cfg.enable_tr_layer else -1
        n_slots = cfg.encoder_layers + (1 if cfg.enable_tr_layer else 0)
        self.layers = nn.ModuleList([
            Conv1D(e, e, cfg.tr_reduce_factor, device=device) if slot == self.tr_slot
            else TransformerEncoderLayer(e, cfg.encoder_ffn_embed_dim,
                                         cfg.encoder_attention_heads, cfg.layer_norm_first,
                                         cfg.dropout, cfg.attention_dropout,
                                         cfg.activation_dropout, device=device)
            for slot in range(n_slots)
        ])

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                tgt_slot: Optional[int] = None,
                rng: Optional[DropoutRNG] = None) -> EncoderOutput:
        """``tgt_slot`` stops after that slot of the layer list (the TR
        module counts), like the reference's tgt_layer. Deterministic
        unless a ``rng`` is given."""
        cfg = self.cfg
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
                padding_mask = reduce_padding_mask(padding_mask, cfg.tr_reduce_factor)
            else:
                y, layer_result = layer(x, padding_mask, rng)
                if rng is None or cfg.encoder_layerdrop <= 0.0 \
                        or rng.uniform() > cfg.encoder_layerdrop:
                    x = y
                layer_results.append((x, None, layer_result))
            if tgt_slot is not None and slot >= tgt_slot:
                break

        # undo pad_to_multiple; after a TR layer the pad is folded into frames
        if pad_length > 0 and not cfg.enable_tr_layer:
            x = x[:, :-pad_length]
            if padding_mask is not None:
                padding_mask = padding_mask[:, :-pad_length]
            layer_results = [(h[:, :-pad_length], taps, lr[:, :-pad_length])
                             for (h, taps, lr) in layer_results]

        if cfg.layer_norm_first and tgt_slot is None:
            x = self.layer_norm(x)
        return EncoderOutput(x, layer_results, tr_layer_results, padding_mask)
