"""Carry weights from the JAX package's StudentModel and TeacherModel param
trees (and a conformer's ``batch_stats``) into the port's state dicts: the
inverses of
``fithubert_tpu/export/reference_import.py:42 map_student_state_dict`` and,
for the teacher, of ``fithubert_tpu/export/fairseq_import.py``'s
``map_extractor`` (``:139``), ``map_pos_conv`` (``:169``),
``map_conformer_layer`` (``:71``) and ``map_transformer_encoder``
(``:186``): the keys are fairseq's. The multi-layer positional conv
(``pos_conv/conv_{i}``, ``pos_conv_depth`` > 1) has no importer there; its
mapping to fairseq's ``pos_conv.{i}.0.*`` is this module's own.

The tree is a nested dict of arrays (numpy, or anything ``np.asarray``
takes); nothing of JAX is imported. Conv kernels are (K, C_in, C_out) in JAX
and (C_out, C_in, K) in torch; ConvTranspose kernels are (K, C_out, C_in) in
JAX and (C_in, C_out, K) in torch; Dense kernels are the transposes of
Linear weights; SplitLinear's (N, D_in, D_out) weight keeps its layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.models.teacher import TeacherGeometry


def _t(a, perm=None) -> torch.Tensor:
    arr = np.asarray(a, dtype=np.float32)
    if perm is not None:
        arr = arr.transpose(perm)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _dense(sd, name, p) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"], (1, 0))
    sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd, name, p) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conformer_layer(sd, prefix, p, stats, attn_type) -> None:
    """A ConformerEncoderLayer's params and its BatchNorm's batch_stats;
    the espnet attentions take espnet's names (``linear_q`` ...), the plain
    fairseq MHA of another attn_type its own."""
    for ffn in ("ffn1", "ffn2"):
        _norm(sd, f"{prefix}.{ffn}.layer_norm", p[ffn]["layer_norm"])
        _dense(sd, f"{prefix}.{ffn}.w_1", p[ffn]["w_1"])
        _dense(sd, f"{prefix}.{ffn}.w_2", p[ffn]["w_2"])
    attn = p["self_attn"]
    espnet = attn_type == "espnet"
    for proj, name in (("q_proj", "linear_q"), ("k_proj", "linear_k"), ("v_proj", "linear_v"),
                       ("out_proj", "linear_out")):
        _dense(sd, f"{prefix}.self_attn.{name if espnet else proj}", attn[proj])
    if "linear_pos" in attn:
        sd[f"{prefix}.self_attn.linear_pos.weight"] = _t(attn["linear_pos"]["kernel"], (1, 0))
        sd[f"{prefix}.self_attn.pos_bias_u"] = _t(attn["pos_bias_u"])
        sd[f"{prefix}.self_attn.pos_bias_v"] = _t(attn["pos_bias_v"])
    _norm(sd, f"{prefix}.self_attn_layer_norm", p["self_attn_layer_norm"])
    _norm(sd, f"{prefix}.final_layer_norm", p["final_layer_norm"])
    cm, cp = f"{prefix}.conv_module", p["conv_module"]
    _norm(sd, f"{cm}.layer_norm", cp["layer_norm"])
    for conv in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
        sd[f"{cm}.{conv}.weight"] = _t(cp[conv]["kernel"], (2, 1, 0))
    _norm(sd, f"{cm}.batch_norm", cp["batch_norm"])
    bn = stats["conv_module"]["batch_norm"]
    sd[f"{cm}.batch_norm.running_mean"] = _t(bn["mean"])
    sd[f"{cm}.batch_norm.running_var"] = _t(bn["var"])


def jax_student_params_to_state_dict(params: Mapping[str, Any], cfg: StudentConfig,
                                     batch_stats: Optional[Mapping[str, Any]] = None
                                     ) -> Dict[str, torch.Tensor]:
    """JAX StudentModel params -> the port's StudentModel state dict (the
    heads present in ``params`` only): the conv front-end or MelSpecHead,
    the TR module of any type, transformer or conformer layers, the
    layer-wise heads, or the upsampler and the SplitLinear head. A
    conformer also needs the ``batch_stats`` collection (the JAX
    variables' ``"batch_stats"``), whose running statistics become the
    BatchNorm buffers."""
    sd: Dict[str, torch.Tensor] = {}
    if cfg.n_mels <= 0:
        fe = params["feature_extractor"]
        for i in range(len(cfg.conv_feature_layers)):
            prefix, conv = f"feature_extractor.conv_layers.{i}", fe[f"conv_{i}"]
            sd[f"{prefix}.0.weight"] = _t(conv["kernel"], (2, 1, 0))
            if "bias" in conv:
                sd[f"{prefix}.0.bias"] = _t(conv["bias"])
            if f"layer_norm_{i}" in fe:  # layer_norm mode: every block's LayerNorm
                _norm(sd, f"{prefix}.2.1", fe[f"layer_norm_{i}"])
        if "group_norm" in fe:
            _norm(sd, "feature_extractor.conv_layers.0.2", fe["group_norm"])
    for i in range(len(cfg.mel_spec_head_conv_layers) if cfg.n_mels > 0 else 0):
        conv = params["mel_spec_head"][f"conv_{i}"]
        sd[f"mel_spec_head.conv_layers.{i}.weight"] = _t(conv["kernel"], (2, 1, 0))
        sd[f"mel_spec_head.conv_layers.{i}.bias"] = _t(conv["bias"])
    _norm(sd, "layer_norm", params["layer_norm"])
    if "post_extract_proj" in params:
        _dense(sd, "post_extract_proj", params["post_extract_proj"])

    enc = params["encoder"]
    if cfg.layer_type == "conformer":
        if batch_stats is None:
            raise ValueError("a conformer student's state needs the JAX batch_stats collection")
        enc_stats = batch_stats["encoder"]
    if not cfg.dedicated_conformer and cfg.pos_conv_depth > 1:
        # MultiLayerPositionalConv: conv_{i} (its LayerNorms have no parameters)
        for i in range(cfg.pos_conv_depth):
            conv = enc["pos_conv"][f"conv_{i}"]
            sd[f"encoder.pos_conv.{i}.0.weight"] = _t(conv["kernel"], (2, 1, 0))
            sd[f"encoder.pos_conv.{i}.0.bias"] = _t(conv["bias"])
    elif not cfg.dedicated_conformer:
        pos = enc["pos_conv"]
        sd["encoder.pos_conv.0.weight_g"] = _t(pos["weight_g"]).reshape(1, 1, -1)
        sd["encoder.pos_conv.0.weight_v"] = _t(pos["weight_v"], (2, 1, 0))
        sd["encoder.pos_conv.0.bias"] = _t(pos["bias"])
    _norm(sd, "encoder.layer_norm", enc["layer_norm"])
    tr_slot = cfg.tr_layer_index if cfg.enable_tr_layer and not cfg.dedicated_conformer else -1
    layer = 0
    for slot in range(cfg.encoder_layers + (1 if tr_slot >= 0 else 0)):
        prefix = f"encoder.layers.{slot}"
        if slot == tr_slot:
            tr = enc["tr_layer"]
            if "conv" in tr:
                sd[f"{prefix}.weight"] = _t(tr["conv"]["kernel"], (2, 1, 0))
                sd[f"{prefix}.bias"] = _t(tr["conv"]["bias"])
            elif "fc" in tr:
                _dense(sd, prefix, tr["fc"])
            else:
                _dense(sd, f"{prefix}.0", tr["fc_a"])
                _dense(sd, f"{prefix}.2", tr["fc_b"])
            continue
        p = enc[f"layers_{layer}"]
        if cfg.layer_type == "conformer":
            _conformer_layer(sd, prefix, p, enc_stats[f"layers_{layer}"], cfg.attn_type)
            layer += 1
            continue
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{prefix}.self_attn.{proj}", p["self_attn"][proj])
        _norm(sd, f"{prefix}.self_attn_layer_norm", p["self_attn_layer_norm"])
        _dense(sd, f"{prefix}.fc1", p["fc1"])
        _dense(sd, f"{prefix}.fc2", p["fc2"])
        _norm(sd, f"{prefix}.final_layer_norm", p["final_layer_norm"])
        layer += 1

    if "upsampler" in params:
        sd["upsampler.weight"] = _t(params["upsampler"]["kernel"], (2, 1, 0))
        sd["upsampler.bias"] = _t(params["upsampler"]["bias"])
    if "proj_head_in" in params:
        _dense(sd, "proj_head.0", params["proj_head_in"])
        split = params["proj_head_split"]
        if "layer" in split:
            _dense(sd, "proj_head.2.layer", split["layer"])
        else:
            sd["proj_head.2.weight"] = _t(split["weight"])
            sd["proj_head.2.bias"] = _t(split["bias"])
    for key, head in params.items():
        if not key.startswith("proj_head_") or key in ("proj_head_in", "proj_head_split"):
            continue
        prefix = f"proj_head.{key[len('proj_head_'):]}"
        if "upsampler" in head:
            sd[f"{prefix}.upsampler.weight"] = _t(head["upsampler"]["kernel"], (2, 1, 0))
            sd[f"{prefix}.upsampler.bias"] = _t(head["upsampler"]["bias"])
        if "lin_proj" in head:
            _dense(sd, f"{prefix}.lin_proj", head["lin_proj"])
    return sd


def jax_teacher_params_to_state_dict(params: Mapping[str, Any],
                                     geometry: TeacherGeometry) -> Dict[str, torch.Tensor]:
    """JAX TeacherModel params -> the port's TeacherModel state dict, under
    fairseq's key names. The teacher's tree is the student's without a TR
    layer or heads, plus a wav2vec_ctc teacher's ``ctc_proj``."""
    sd = jax_student_params_to_state_dict(params, geometry.to_student_config())
    if "ctc_proj" in params:
        _dense(sd, "ctc_proj", params["ctc_proj"])
    return sd
