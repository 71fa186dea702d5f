"""The thin-and-deep student (``fithubert_tpu/models/student.py:52``):
waveform -> conv features (or, with ``n_mels > 0``, fp32 log-mel features
cast to the compute dtype -> SpecAugment in training with ``train.specaug``
-> ``MelSpecHead``) -> fp32 LayerNorm -> padding-mask recompute ->
post-extract projection -> input dropout -> encoder (TR module + transformer
or abs conformer layers; or the rel_pos / rope ``ConformerEncoder``) ->
heads: layer-wise projection heads (``layerwise_proj``), or
(``:229-262``) an upsampler that undoes the time reduction, then
``proj_head_in`` -> GELU -> ``SplitLinear`` predicting the teacher layers
of ``pred_layer_id`` (the DistilHuBERT-style head of ``configs/ex.yaml``).

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

from fithubert_tpu_torch.config import SpecAugConfig, StudentConfig
from fithubert_tpu_torch.device import resolve_device, torch_dtype
from fithubert_tpu_torch.ops.activations import gelu_exact
from fithubert_tpu_torch.ops.attention import linear
from fithubert_tpu_torch.ops.conformer import (
    ConformerEncoder,
    FeedForwardModule,
    RelPositionAttention,
    RotaryAttention,
    RowMaskedBatchNorm,
)
from fithubert_tpu_torch.ops.conv import (
    Conv1D,
    ConvFeatureExtractor,
    ConvTranspose1D,
    SameConv1d,
    _WeightNormConv,
    grad_multiply,
)
from fithubert_tpu_torch.ops.dropout import DropoutRNG, dropout
from fithubert_tpu_torch.ops.heads import LayerWiseProjHead, MelSpecHead, SplitLinear
from fithubert_tpu_torch.ops.mel import mel_spectrogram
from fithubert_tpu_torch.ops.norms import FP32GroupNorm, FP32LayerNorm
from fithubert_tpu_torch.ops.padding import (
    feat_extract_output_lengths,
    lengths_to_padding_mask,
    padding_mask_to_lengths,
)
from fithubert_tpu_torch.ops.specaug import BatchStripe, spec_augment
from fithubert_tpu_torch.ops.transformer import TransformerEncoder


class StudentOutput(NamedTuple):
    """The reference's 6-key forward dict."""

    x: torch.Tensor  # final output (projected if layerwise heads ran, else upsampled)
    padding_mask: Optional[torch.Tensor]  # frame-rate, time-reduced
    features: torch.Tensor  # features to distill (B, T', C): post-extract proj (+ cnn head)
    layer_results: List  # [(hidden, taps or None, ffn_result)] per layer
    tr_layer_results: List  # outputs of the TR layer
    # (B, L, T, D) layer-wise (a list when a mid-encoder TR leaves them
    # ragged), or (B, N, T, D) from the SplitLinear head
    projections: Optional[Union[torch.Tensor, List[torch.Tensor]]]


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from ``generator`` (a CPU
    generator, so a seed gives the same weights on every device), with the
    JAX package's initializer scales."""

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def lecun(p, fan_in):  # flax's default kernel init, untruncated
        normal(p, fan_in ** -0.5)

    conformer_linears = set()
    for mod in model.modules():
        if isinstance(mod, (FeedForwardModule, RelPositionAttention, RotaryAttention)):
            conformer_linears.update(m for m in mod.children() if isinstance(m, nn.Linear))

    for name, mod in model.named_modules():
        if isinstance(mod, RelPositionAttention):  # xavier uniform over (H, d_k)
            for p in (mod.pos_bias_u, mod.pos_bias_v):
                uniform(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])))
        if mod in conformer_linears:  # flax Dense: lecun normal, zero bias
            lecun(mod.weight, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, RowMaskedBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        elif isinstance(mod, SameConv1d):
            fan_in = mod.weight.shape[1] * mod.weight.shape[2]
            if name.startswith("mel_spec_head."):  # variance_scaling(1/3, fan_in, uniform)
                uniform(mod.weight, fan_in ** -0.5)
            else:  # the conformer's bias-free convs: lecun normal
                lecun(mod.weight, fan_in)
            if mod.bias is not None:  # torch's conv bias init
                uniform(mod.bias, fan_in ** -0.5)
        elif isinstance(mod, SplitLinear) and mod.in_split > 1:  # heads.py:45-56
            uniform(mod.weight, mod.in_dim ** -0.5)
            uniform(mod.bias, mod.in_dim ** -0.5)
        elif isinstance(mod, (FP32LayerNorm, FP32GroupNorm)):
            if mod.weight is not None:
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
        elif isinstance(mod, nn.Conv1d):  # extractor convs: kaiming normal, torch's bias
            fan_in = mod.weight.shape[1] * mod.weight.shape[2]
            normal(mod.weight, math.sqrt(2.0 / fan_in))
            if mod.bias is not None:
                uniform(mod.bias, fan_in ** -0.5)
        elif isinstance(mod, nn.Linear):
            std = 0.02 if name.startswith("encoder.") else mod.in_features ** -0.5
            normal(mod.weight, std)
            mod.bias.zero_()


class StudentModel(nn.Module):
    """``disable_projections=True`` is the export model: with layer-wise
    heads only the last is built, and it maps the final hidden to ``x``;
    with the SplitLinear head none is (``x`` is the upsampled final
    hidden). Otherwise all ``encoder_layers`` layer-wise heads, or the
    upsampler and ``proj_head`` (``proj_head.0`` the Linear, ``proj_head.2``
    the SplitLinear, the reference's keys), are built."""

    def __init__(self, cfg: StudentConfig, disable_projections: bool = False,
                 device: Union[str, torch.device] = "cuda",
                 specaug: Optional[SpecAugConfig] = None):
        super().__init__()
        cfg.check_supported()
        dev = resolve_device(device)
        self.cfg = cfg
        self.disable_projections = disable_projections
        self.specaug = specaug
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        e = cfg.encoder_embed_dim
        self.feature_extractor = self.mel_spec_head = None
        if cfg.n_mels <= 0:
            self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers,
                                                          cfg.extractor_mode, cfg.conv_bias,
                                                          device=dev)
        elif cfg.mel_spec_head_conv_layers:
            self.mel_spec_head = MelSpecHead(cfg.n_mels, cfg.mel_spec_head_conv_layers,
                                             device=dev)
        self.layer_norm = FP32LayerNorm(cfg.embed, device=dev)
        self.post_extract_proj = (nn.Linear(cfg.embed, e, device=dev)
                                  if cfg.embed != e else None)
        self.cnn_proj_head = (nn.Linear(e, cfg.pred_head_final_dim, device=dev)
                              if cfg.pred_head_final_dim != e and cfg.cnn_weight > 0
                              and not disable_projections else None)
        self.encoder = (ConformerEncoder(cfg, device=dev) if cfg.dedicated_conformer
                        else TransformerEncoder(cfg, device=dev))
        self.upsampler = None
        if cfg.layerwise_proj:
            heads = ([cfg.encoder_layers - 1] if disable_projections
                     else range(cfg.encoder_layers))
            self.proj_head = nn.ModuleDict({
                str(i): LayerWiseProjHead(e, cfg.pred_head_final_dim, cfg.enable_tr_layer,
                                          cfg.tr_reduce_factor, device=dev)
                for i in heads
            })
        else:
            if cfg.enable_tr_layer:
                self.upsampler = ConvTranspose1D(e, e, cfg.tr_reduce_factor, device=dev)
            self.proj_head = nn.ModuleDict()
            if cfg.n_tasks > 0 and not disable_projections:
                inter = cfg.pred_head_inter_dim if cfg.pred_head_inter_dim > 0 else e
                self.proj_head["0"] = nn.Linear(e, inter * cfg.n_tasks, device=dev)
                self.proj_head["2"] = SplitLinear(inter, cfg.n_tasks, cfg.pred_head_final_dim,
                                                  device=dev)

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
                      need_taps: bool = False,
                      stripe: Optional[BatchStripe] = None) -> StudentOutput:
        """The training forward (``deterministic=False`` in the JAX package),
        with autograd; every dropout and SpecAugment is drawn from ``rng``,
        and the conformer's BatchNorm takes the batch's statistics and
        moves its running ones. Without ``rng`` it is deterministic, with
        the running statistics. ``need_taps``: the last encoder layer
        returns its attention taps in ``layer_results[-1][1]``. ``stripe``:
        this batch is a rank's rows of a global batch (SpecAugment's draws
        and mean are the global batch's)."""
        return self._run(source, padding_mask, None, rng, need_taps, stripe)

    def _front_end(self, source, rng, stripe) -> torch.Tensor:
        cfg = self.cfg
        if self.feature_extractor is not None:
            features = self.feature_extractor(source.to(self.compute_dtype))
            if 0 < cfg.feature_grad_mult != 1.0:
                features = grad_multiply(features, cfg.feature_grad_mult)
            elif cfg.feature_grad_mult <= 0:
                features = features.detach()
            return features
        features = mel_spectrogram(source.float(), cfg.n_mels,
                                   log=cfg.enable_log_mel).to(self.compute_dtype)
        if self.specaug is not None and rng is not None:
            features = spec_augment(rng.specaug, features, self.specaug, stripe=stripe)
        if self.mel_spec_head is not None:
            features = self.mel_spec_head(features)
        return features

    def _run(self, source, padding_mask, layer, rng, need_taps=False,
             stripe=None) -> StudentOutput:
        cfg = self.cfg
        features = self.layer_norm(self._front_end(source, rng, stripe))

        if padding_mask is not None:
            lengths = padding_mask_to_lengths(padding_mask)
            lengths = (feat_extract_output_lengths(lengths, cfg.conv_feature_layers)
                       if cfg.n_mels <= 0 else 1 + (lengths - 400) // 320)
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
        # the JAX package counts a TR slot even in the conformer encoder, which has none
        n_slots = cfg.encoder_layers + (1 if cfg.enable_tr_layer else 0)
        projections = None
        if (layer is None or layer + 1 >= n_slots) and not cfg.layerwise_proj:
            if self.upsampler is not None:
                x = self.upsampler(x)
            if len(self.proj_head):
                b, t, _ = x.shape
                h = gelu_exact(linear(x, self.proj_head["0"]))
                projections = self.proj_head["2"](h).reshape(
                    b, t, cfg.n_tasks, cfg.pred_head_final_dim).transpose(1, 2)  # (B, N, T, D)
        elif layer is None or layer + 1 >= n_slots:
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
