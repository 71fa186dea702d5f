"""The thin-and-deep student (``fithubert_tpu/models/student.py:52``):
waveform -> conv features -> fp32 LayerNorm -> padding-mask recompute ->
post-extract projection -> input dropout -> encoder (TR conv + transformer
layers) -> layer-wise projection heads.

Parameters are fp32 and named by the reference's state-dict keys; the
forward computes in ``cfg.compute_dtype``. ``forward`` is the serving
forward: deterministic and without autograd. ``forward_train`` is the
training forward: autograd through the kernels, with every dropout drawn
from a ``DropoutRNG`` (deterministic without one, as the eval step runs)."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Union

import torch
import torch.nn as nn

from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.device import resolve_device, torch_dtype
from fithubert_tpu_torch.ops.activations import gelu_exact
from fithubert_tpu_torch.ops.attention import linear
from fithubert_tpu_torch.ops.conv import (
    Conv1D,
    ConvFeatureExtractor,
    ConvTranspose1D,
    _WeightNormConv,
    grad_multiply,
)
from fithubert_tpu_torch.ops.dropout import DropoutRNG, dropout
from fithubert_tpu_torch.ops.heads import LayerWiseProjHead
from fithubert_tpu_torch.ops.norms import FP32GroupNorm, FP32LayerNorm
from fithubert_tpu_torch.ops.padding import (
    feat_extract_output_lengths,
    lengths_to_padding_mask,
    padding_mask_to_lengths,
)
from fithubert_tpu_torch.ops.transformer import TransformerEncoder


class StudentOutput(NamedTuple):
    """The reference's 6-key forward dict."""

    x: torch.Tensor  # final output (projected if layerwise heads ran)
    padding_mask: Optional[torch.Tensor]  # frame-rate, time-reduced
    features: torch.Tensor  # features to distill (B, T', C): post-extract proj (+ cnn head)
    layer_results: List  # [(hidden, taps or None, ffn_result)] per layer
    tr_layer_results: List  # outputs of the TR layer
    projections: Optional[Union[torch.Tensor, List[torch.Tensor]]]  # (B, L, T, D)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from ``generator`` (a CPU
    generator, so a seed gives the same weights on every device), with the
    JAX package's initializer scales."""

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    for name, mod in model.named_modules():
        if isinstance(mod, (FP32LayerNorm, FP32GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, _WeightNormConv):
            k, e = mod.weight_v.shape[2], mod.weight_v.shape[0]
            groups = e // mod.weight_v.shape[1]
            std = math.sqrt(4.0 / (k * e))
            normal(mod.weight_v, std)
            mod.weight_g.fill_(std * math.sqrt(e * e / groups))
            mod.bias.zero_()
        elif isinstance(mod, (Conv1D, ConvTranspose1D)):
            fan_in = mod.weight.shape[1] * mod.weight.shape[2] if isinstance(mod, Conv1D) \
                else mod.weight.shape[0] * mod.weight.shape[2]
            uniform(mod.weight, 1.0 / math.sqrt(fan_in))
            uniform(mod.bias, 1.0 / math.sqrt(fan_in))
        elif isinstance(mod, nn.Conv1d):  # extractor convs: kaiming normal
            normal(mod.weight, math.sqrt(2.0 / (mod.weight.shape[1] * mod.weight.shape[2])))
        elif isinstance(mod, nn.Linear):
            std = 0.02 if name.startswith("encoder.") else mod.in_features ** -0.5
            normal(mod.weight, std)
            mod.bias.zero_()


class StudentModel(nn.Module):
    """``disable_projections=True`` is the export model: only the last
    layer-wise head is built, and it maps the final hidden to ``x``.
    Otherwise all ``encoder_layers`` heads are built."""

    def __init__(self, cfg: StudentConfig, disable_projections: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        cfg.check_supported()
        if not cfg.layerwise_proj:
            raise NotImplementedError(
                "layerwise_proj=False: the PyTorch port supports only layer-wise heads")
        dev = resolve_device(device)
        self.cfg = cfg
        self.disable_projections = disable_projections
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        e = cfg.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers, device=dev)
        self.layer_norm = FP32LayerNorm(cfg.embed, device=dev)
        self.post_extract_proj = (nn.Linear(cfg.embed, e, device=dev)
                                  if cfg.embed != e else None)
        self.cnn_proj_head = (nn.Linear(e, cfg.pred_head_final_dim, device=dev)
                              if cfg.pred_head_final_dim != e and cfg.cnn_weight > 0
                              and not disable_projections else None)
        self.encoder = TransformerEncoder(cfg, device=dev)
        heads = ([cfg.encoder_layers - 1] if disable_projections
                 else range(cfg.encoder_layers))
        self.proj_head = nn.ModuleDict({
            str(i): LayerWiseProjHead(e, cfg.pred_head_final_dim, cfg.enable_tr_layer,
                                      cfg.tr_reduce_factor, device=dev)
            for i in heads
        })

    def init_weights(self, generator: torch.Generator) -> "StudentModel":
        init_parameters(self, generator)
        return self

    @torch.no_grad()
    def forward(self, source: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                layer: Optional[int] = None) -> StudentOutput:
        """source (B, T_wav) float; padding_mask (B, T_wav) bool, True = pad.
        ``layer`` stops after that encoder layer-list slot (the TR module
        counts) and returns its raw hidden, without heads."""
        return self._run(source, padding_mask, layer, None)

    def forward_train(self, source: torch.Tensor,
                      padding_mask: Optional[torch.Tensor] = None,
                      rng: Optional[DropoutRNG] = None,
                      need_taps: bool = False) -> StudentOutput:
        """The training forward (``deterministic=False`` in the JAX package),
        with autograd; every dropout is drawn from ``rng``. ``need_taps``:
        the last encoder layer returns its attention taps in
        ``layer_results[-1][1]``."""
        return self._run(source, padding_mask, None, rng, need_taps)

    def _run(self, source, padding_mask, layer, rng, need_taps=False) -> StudentOutput:
        cfg = self.cfg
        features = self.feature_extractor(source.to(self.compute_dtype))
        if 0 < cfg.feature_grad_mult != 1.0:
            features = grad_multiply(features, cfg.feature_grad_mult)
        elif cfg.feature_grad_mult <= 0:
            features = features.detach()
        features = self.layer_norm(features)

        if padding_mask is not None:
            lengths = feat_extract_output_lengths(padding_mask_to_lengths(padding_mask),
                                                  cfg.conv_feature_layers)
            padding_mask = lengths_to_padding_mask(lengths, features.shape[1])

        drop = features.shape[1] % cfg.crop_seq_to_multiple
        if drop:
            features = features[:, :-drop]
            if padding_mask is not None:
                padding_mask = padding_mask[:, :-drop]

        if self.post_extract_proj is not None:
            features = linear(features, self.post_extract_proj)
        features_to_distill = features
        if self.cnn_proj_head is not None:
            features_to_distill = linear(gelu_exact(features), self.cnn_proj_head)
        features = dropout(features, cfg.dropout_input, rng)

        enc = self.encoder(features, padding_mask, tgt_slot=layer, rng=rng,
                           need_taps=need_taps)
        x = enc.x
        n_slots = len(self.encoder.layers)
        projections = None
        if layer is None or layer + 1 >= n_slots:
            if self.disable_projections:
                x = self.proj_head[str(cfg.encoder_layers - 1)](x)
            else:
                projs = [self.proj_head[str(i)](h) for i, (h, _, _) in enumerate(enc.layer_results)]
                same = all(p.shape == projs[0].shape for p in projs)
                projections = torch.stack(projs, dim=1) if same else projs
                x = projs[-1]
        return StudentOutput(x=x, padding_mask=enc.padding_mask, features=features_to_distill,
                             layer_results=enc.layer_results,
                             tr_layer_results=enc.tr_layer_results,
                             projections=projections)
