"""Read fairseq HuBERT / wav2vec2 checkpoints as the port's teacher
(``fithubert_tpu/export/fairseq_import.py:198-365``).

    geom, state = load_teacher_any("hubert_base_ls960.pt")
    teacher = TeacherModel(geom, device="cuda")
    teacher.load_state_dict(state)

The port's ``TeacherModel`` is named by fairseq's keys, so the state dict is
the checkpoint's own, less what the teacher does not run (HuBERT's
``label_embs_concat``, ``final_proj.*`` and ``mask_emb``, wav2vec2's
quantizer and ``project_q``), and with a positional conv saved by torch's
``parametrizations`` weight norm (PyTorch >= 2.1) renamed to
``weight_g`` / ``weight_v``. The geometry comes from the checkpoint's
``cfg`` (an omegaconf container, read through stubs) or legacy ``args``,
and from the weights' shapes; a conv spec the config lacks is recovered
from the kernels with fairseq's strides. A ``wav2vec_ctc`` checkpoint is
refused until CTC is ported.

A converted teacher is a pair: ``<prefix>.json`` (the geometry) and
``<prefix>.pt`` (the state dict), written by ``save_converted_teacher``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import torch

from fithubert_tpu_torch.config import parse_spec
from fithubert_tpu_torch.export.torch_pickle import tolerant_torch_load, unstub
from fithubert_tpu_torch.models.teacher import TeacherGeometry

StateDict = Dict[str, torch.Tensor]

# fairseq's standard extractor, kernel -> stride: [(512, 10, 5)] +
# [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
_DEFAULT_STRIDES = {10: 5, 3: 2, 2: 2}
# the modules TeacherModel has; the rest of a checkpoint is pretraining heads
_TEACHER_PREFIXES = ("feature_extractor.", "layer_norm.", "post_extract_proj.", "encoder.")
_PARAMETRIZED = {".parametrizations.weight.original0": ".weight_g",
                 ".parametrizations.weight.original1": ".weight_v"}


def _extract_model_cfg(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The model section of ``ckpt['cfg']`` (omegaconf, stubbed) or of
    ``ckpt['args']`` (an argparse Namespace, older fairseq). A nested
    ``w2v_args`` (fine-tuned checkpoints) wins over the outer keys, as
    fairseq builds the acoustic model from it alone."""
    cfg = unstub(ckpt.get("cfg"))
    if isinstance(cfg, dict) and isinstance(cfg.get("model"), dict):
        model = cfg["model"]
        inner = model.get("w2v_args")
        if isinstance(inner, dict) and isinstance(inner.get("model"), dict):
            return {**{k: v for k, v in model.items() if k != "w2v_args"}, **inner["model"]}
        return model
    args = unstub(ckpt.get("args"))
    if isinstance(args, dict):
        inner = args.get("w2v_args")
        if isinstance(inner, dict):
            inner_model = inner.get("model") if isinstance(inner.get("model"), dict) else inner
            return {**{k: v for k, v in args.items() if k != "w2v_args"}, **inner_model}
        return args
    return {}


def _conv_spec(mcfg: Dict[str, Any], sd: StateDict) -> Tuple[Tuple[int, int, int], ...]:
    spec = mcfg.get("conv_feature_layers")
    if spec:
        try:
            return tuple((int(d), int(k), int(s)) for d, k, s in parse_spec(spec))
        except (ValueError, TypeError):
            pass
    layers, i = [], 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in sd:
        c_out, _, k = sd[f"feature_extractor.conv_layers.{i}.0.weight"].shape
        layers.append((int(c_out), int(k), _DEFAULT_STRIDES.get(int(k), 1)))
        i += 1
    return tuple(layers)


def _rename(key: str) -> str:
    for old, new in _PARAMETRIZED.items():
        if key.endswith(old):
            return key[: -len(old)] + new
    return key


def load_fairseq_teacher(path: str) -> Tuple[TeacherGeometry, StateDict]:
    """A fairseq checkpoint -> (TeacherGeometry, state dict on the CPU).
    ``label_embs_concat`` marks HuBERT (the reference's dispatch,
    ``utils/utils.py:115-143``), otherwise wav2vec2."""
    ckpt = tolerant_torch_load(path)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {_rename(k): v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if any(k.startswith("w2v_encoder.") for k in sd):
        raise NotImplementedError(f"{path} is a wav2vec_ctc checkpoint: the PyTorch port "
                                  "has no CTC teacher yet (ROADMAP Queue 1 item 6)")
    mcfg = _extract_model_cfg(ckpt)
    embed_dim = int(sd["encoder.layers.0.self_attn.q_proj.weight"].shape[0])
    pos_out, pos_in_per_group, pos_k = sd["encoder.pos_conv.0.weight_v"].shape
    n_layers = 0
    while f"encoder.layers.{n_layers}.self_attn.q_proj.weight" in sd:
        n_layers += 1
    geom = TeacherGeometry(
        model_type="hubert" if "label_embs_concat" in sd else "wav2vec2",
        extractor_mode=mcfg.get("extractor_mode") or (
            "layer_norm" if "feature_extractor.conv_layers.1.2.1.weight" in sd else "default"),
        conv_feature_layers=_conv_spec(mcfg, sd),
        encoder_layers=n_layers,
        encoder_embed_dim=embed_dim,
        encoder_ffn_embed_dim=int(sd["encoder.layers.0.fc1.weight"].shape[0]),
        encoder_attention_heads=int(mcfg.get("encoder_attention_heads")
                                    or max(1, embed_dim // 64)),
        activation_fn=str(mcfg.get("activation_fn") or "gelu"),
        layer_norm_first=bool(mcfg.get("layer_norm_first", False)),
        conv_bias="feature_extractor.conv_layers.0.0.bias" in sd,
        conv_pos=int(pos_k),
        conv_pos_groups=int(pos_out // pos_in_per_group),
    )
    keep = _TEACHER_PREFIXES
    if geom.conv_feature_layers[-1][0] == embed_dim:  # fairseq builds no projection then
        keep = tuple(p for p in keep if p != "post_extract_proj.")
    return geom, {k: v for k, v in sd.items() if k.startswith(keep)}


def save_converted_teacher(geom: TeacherGeometry, state: StateDict,
                           prefix: str) -> Tuple[str, str]:
    """Write ``<prefix>.json`` and ``<prefix>.pt``; returns both paths."""
    json_path, pt_path = prefix + ".json", prefix + ".pt"
    with open(json_path, "w") as f:
        json.dump(dataclasses.asdict(geom), f, indent=1)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, pt_path)
    return json_path, pt_path


def load_converted_teacher(path: str) -> Tuple[TeacherGeometry, StateDict]:
    """The pair written by ``save_converted_teacher``, from either file."""
    prefix = path.rsplit(".", 1)[0] if path.endswith((".json", ".pt")) else path
    with open(prefix + ".json") as f:
        geom = TeacherGeometry.from_dict(json.load(f))
    return geom, torch.load(prefix + ".pt", map_location="cpu", weights_only=True)


def load_teacher_any(path: str) -> Tuple[TeacherGeometry, StateDict]:
    """A converted teacher's ``.json``, or a fairseq ``.pt``."""
    if path.endswith(".msgpack"):
        raise ValueError(f"{path}: a JAX-converted teacher needs msgpack, which the port does "
                         "not use; pass the fairseq .pt, or a pair written by "
                         "save_converted_teacher")
    if path.endswith(".json"):
        return load_converted_teacher(path)
    return load_fairseq_teacher(path)
