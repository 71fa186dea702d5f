"""Carry weights from the JAX package's StudentModel and TeacherModel param
trees into the port's state dicts: the inverses of
``fithubert_tpu/export/reference_import.py:42 map_student_state_dict`` and,
for the teacher, of ``fithubert_tpu/export/fairseq_import.py``'s
``map_extractor`` (``:139``), ``map_pos_conv`` (``:169``) and
``map_transformer_encoder`` (``:186``): the keys are fairseq's.

The tree is a nested dict of arrays (numpy, or anything ``np.asarray``
takes); nothing of JAX is imported. Conv kernels are (K, C_in, C_out) in JAX
and (C_out, C_in, K) in torch; ConvTranspose kernels are (K, C_out, C_in) in
JAX and (C_in, C_out, K) in torch; Dense kernels are the transposes of
Linear weights; SplitLinear's (N, D_in, D_out) weight keeps its layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def jax_student_params_to_state_dict(params: Mapping[str, Any],
                                     cfg: StudentConfig) -> Dict[str, torch.Tensor]:
    """JAX StudentModel params -> the port's StudentModel state dict (the
    heads present in ``params`` only): the TR module of any type, the
    layer-wise heads, or the upsampler and the SplitLinear head."""
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _t(fe[f"conv_{i}"]["kernel"], (2, 1, 0))
    _norm(sd, "feature_extractor.conv_layers.0.2", fe["group_norm"])
    _norm(sd, "layer_norm", params["layer_norm"])
    if "post_extract_proj" in params:
        _dense(sd, "post_extract_proj", params["post_extract_proj"])

    enc = params["encoder"]
    pos = enc["pos_conv"]
    sd["encoder.pos_conv.0.weight_g"] = _t(pos["weight_g"]).reshape(1, 1, -1)
    sd["encoder.pos_conv.0.weight_v"] = _t(pos["weight_v"], (2, 1, 0))
    sd["encoder.pos_conv.0.bias"] = _t(pos["bias"])
    _norm(sd, "encoder.layer_norm", enc["layer_norm"])
    tr_slot = cfg.tr_layer_index if cfg.enable_tr_layer else -1
    layer = 0
    for slot in range(cfg.encoder_layers + (1 if cfg.enable_tr_layer else 0)):
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
