"""The frozen teacher (``fithubert_tpu/models/teacher.py:37-207``): a
fairseq HuBERT / wav2vec2 encoder built from the student's blocks with no TR
layer and no heads (any extractor mode, conv bias, pre- or post-LN, so
wav2vec2-Large LV-60's geometry too); a ``wav2vec_ctc`` teacher (a fine-tuned wav2vec2) adds
``ctc_proj`` on the encoder's output, whose logits
(``TeacherOutput.ctc_logits``, (B, T', vocab_size)) seed CTC pseudo-labels.

    waveform -> conv features (K1, C0 = 512) -> fp32 LayerNorm -> padding
    mask -> post_extract_proj -> encoder (pos conv, 12 layers, K2 at D = 64)

``TeacherOutput.x`` is the last layer's hidden (``:194``), the hook value
the reference distills to. Parameters are named by the fairseq state-dict
keys, so ``export/jax_params.py`` and a fairseq ``.pt``
(``export/fairseq_import.py``) fill them.
The teacher runs under ``torch.no_grad()``; ``freeze()`` casts its matmul
weights to the compute dtype once, as ``Distiller.prepare_teacher_params``
does (``fithubert_tpu/train/step.py:128-153``); ``ctc_proj`` is stored
fp32 and computes in the compute dtype, as the JAX cast leaves it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from fithubert_tpu_torch.config import StudentConfig, TeacherConfig
from fithubert_tpu_torch.device import resolve_device, torch_dtype
from fithubert_tpu_torch.models.student import init_parameters
from fithubert_tpu_torch.ops.attention import linear
from fithubert_tpu_torch.ops.conv import ConvFeatureExtractor
from fithubert_tpu_torch.ops.norms import FP32LayerNorm
from fithubert_tpu_torch.ops.padding import (
    feat_extract_output_lengths,
    lengths_to_padding_mask,
    padding_mask_to_lengths,
)
from fithubert_tpu_torch.ops.quant import dense, prequantize_
from fithubert_tpu_torch.ops.transformer import TransformerEncoder
from fithubert_tpu_torch.parallel.mesh import shard_


@dataclass(frozen=True)
class TeacherGeometry:
    """Geometry of a fairseq wav2vec2 / HuBERT teacher (Base defaults)."""

    model_type: str = "hubert"  # 'hubert' | 'wav2vec2' | 'wav2vec_ctc'
    extractor_mode: str = "default"
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    conv_bias: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    vocab_size: int = 0  # > 0 for wav2vec_ctc: ctc_proj's width
    compute_dtype: str = "float32"
    # int8 matmuls (ops/quant.py) at post_extract_proj, q/k/v/out, fc1 and
    # fc2; ctc_proj stays in float, its argmax seeds the CTC pseudo-labels
    quantize_int8: bool = False

    @classmethod
    def from_teacher_config(cls, tc: TeacherConfig) -> "TeacherGeometry":
        return cls(model_type=tc.model_type, encoder_layers=tc.encoder_layers,
                   encoder_embed_dim=tc.encoder_embed_dim,
                   encoder_ffn_embed_dim=tc.encoder_ffn_embed_dim,
                   encoder_attention_heads=tc.encoder_attention_heads,
                   vocab_size=tc.vocab_size if tc.model_type == "wav2vec_ctc" else 0,
                   quantize_int8=tc.quantize_int8)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TeacherGeometry":
        """From a checkpoint's geometry fields (``dataclasses.asdict`` of one,
        as JSON keeps it: lists for tuples)."""
        d = dict(d)
        d["conv_feature_layers"] = tuple(tuple(int(x) for x in c)
                                         for c in d["conv_feature_layers"])
        return cls(**d)

    def to_student_config(self) -> StudentConfig:
        """The encoder view in the student's config: no TR layer, no heads,
        no dropout, no layerdrop, required_seq_len_multiple 1 (the reference
        forces the last three at load time)."""
        return StudentConfig(
            extractor_mode=self.extractor_mode,
            conv_feature_layers=self.conv_feature_layers,
            conv_bias=self.conv_bias,
            encoder_layers=self.encoder_layers,
            encoder_embed_dim=self.encoder_embed_dim,
            encoder_ffn_embed_dim=self.encoder_ffn_embed_dim,
            encoder_attention_heads=self.encoder_attention_heads,
            activation_fn=self.activation_fn,
            layer_norm_first=self.layer_norm_first,
            conv_pos=self.conv_pos,
            conv_pos_groups=self.conv_pos_groups,
            dropout=0.0,
            attention_dropout=0.0,
            activation_dropout=0.0,
            encoder_layerdrop=0.0,
            dropout_input=0.0,
            enable_tr_layer=False,
            layerwise_proj=False,
            pred_layer_id=(),
            required_seq_len_multiple=1,
            compute_dtype=self.compute_dtype,
            quantize_matmuls=self.quantize_int8,
        )


class TeacherOutput(NamedTuple):
    x: torch.Tensor  # last layer's hidden (B, T', D)
    layer_results: List  # [(hidden, taps or None, ffn_result)] per layer
    features: torch.Tensor  # post_extract_proj output (B, T', D)
    padding_mask: Optional[torch.Tensor]  # frame-rate (B, T')
    ctc_logits: Optional[torch.Tensor] = None  # wav2vec_ctc: (B, T', vocab_size)


class TeacherModel(nn.Module):
    def __init__(self, geometry: TeacherGeometry,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if geometry.model_type not in ("hubert", "wav2vec2", "wav2vec_ctc"):
            raise ValueError(f"teacher model_type={geometry.model_type!r}: one of "
                             "'hubert', 'wav2vec2', 'wav2vec_ctc'")
        cfg = geometry.to_student_config()
        cfg.check_supported()
        dev = resolve_device(device)
        self.geometry = geometry
        self.compute_dtype = torch_dtype(geometry.compute_dtype)
        embed, e = cfg.embed, geometry.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers,
                                                      geometry.extractor_mode,
                                                      geometry.conv_bias, device=dev)
        self.layer_norm = FP32LayerNorm(embed, device=dev)
        self.post_extract_proj = (dense(embed, e, geometry.quantize_int8, device=dev)
                                  if embed != e else None)
        self.encoder = TransformerEncoder(cfg, device=dev)
        self.ctc_proj = (nn.Linear(e, geometry.vocab_size, device=dev)
                         if geometry.model_type == "wav2vec_ctc" and geometry.vocab_size > 0
                         else None)

    def init_weights(self, generator: torch.Generator) -> "TeacherModel":
        init_parameters(self, generator)
        return self

    @torch.no_grad()
    def freeze(self, tp=None) -> "TeacherModel":
        """Stop gradients, and store the matmul weights (the extractor convs,
        post_extract_proj, q/k/v/out, fc1, fc2) in the compute dtype once;
        the norms, the weight-normed positional conv and ``ctc_proj`` stay
        fp32. With ``quantize_int8`` the int8 payloads are then taken once
        from the cast weights (``Distiller.prepare_teacher_params``'s order,
        ``fithubert_tpu/train/step.py:138-162``). With a model axis ``tp``
        (``parallel/mesh.py``) this rank's shards are kept last, as
        ``shard_teacher`` places the prepared weights (``:165-169``)."""
        self.requires_grad_(False)
        self.eval()
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)) and mod is not self.ctc_proj:
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        if self.geometry.quantize_int8:
            prequantize_(self)
        shard_(self, tp)
        return self

    def _frame_mask(self, padding_mask: torch.Tensor, t_frames: int) -> torch.Tensor:
        g = self.geometry
        if g.model_type == "hubert":
            # fairseq HubertModel.forward_padding_mask: crop the wave mask to a
            # multiple of T', a frame is padding iff all its samples are
            extra = padding_mask.shape[1] % t_frames
            pm = padding_mask[:, : padding_mask.shape[1] - extra] if extra else padding_mask
            return pm.reshape(pm.shape[0], t_frames, -1).all(-1)
        lengths = feat_extract_output_lengths(padding_mask_to_lengths(padding_mask),
                                              g.conv_feature_layers)
        return lengths_to_padding_mask(lengths, t_frames)

    @torch.no_grad()
    def forward(self, source: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                need_taps: bool = False) -> TeacherOutput:
        """source (B, T_wav) float; padding_mask (B, T_wav) bool, True = pad.
        ``need_taps``: the last layer returns its attention taps in
        ``layer_results[-1][1]`` (deterministic: no dropout)."""
        features = self.feature_extractor(source.to(self.compute_dtype))
        features = self.layer_norm(features)
        if padding_mask is not None:
            padding_mask = self._frame_mask(padding_mask, features.shape[1])
        if self.post_extract_proj is not None:
            features = linear(features, self.post_extract_proj)
        enc = self.encoder(features, padding_mask, need_taps=need_taps)
        x = enc.layer_results[-1][0] if enc.layer_results else enc.x
        # fairseq's Wav2VecCtc projects the encoder's own output (after a
        # pre-LN stack's final norm), not the last layer's hidden
        ctc_logits = linear(enc.x, self.ctc_proj) if self.ctc_proj is not None else None
        return TeacherOutput(x=x, layer_results=enc.layer_results, features=features,
                             padding_mask=enc.padding_mask, ctc_logits=ctc_logits)
