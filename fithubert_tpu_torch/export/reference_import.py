"""The reference's released Lightning checkpoints (FitHuBERT-100h,
FitHuBERT-960h, FitW2V2-960h): ``fithubert_tpu/export/reference_import.py:139
load_reference_student``.

A Lightning ``.ckpt`` pickles ``state_dict`` beside the trainer's state
(``optimizer_states``, ``epoch``, ``global_step``, hyper-parameters, objects
of Lightning's own classes), and keeps the student's weights under the
``student_model.`` prefix (the reference's ``fithubert/expert.py:40-45``
strips it). The port's parameter names are the reference's, the TR module
included (a slot of ``encoder.layers``, ``ops/transformer.py:96-98``), so
only the prefix goes; no key is mapped. Two kinds of key the port has no
tensor for are dropped when the student loads: a conformer BatchNorm's
``num_batches_tracked`` (``ops/conformer.py RowMaskedBatchNorm``) and the
``encoder.pos_conv.*`` that the reference's rel_pos / rope conformer
inherits and never runs (``ConformerEncoder``). The file is read with
``tolerant_torch_load``, which stands in for the classes that are not
installed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fithubert_tpu_torch.config import ExperimentConfig, config_from_yaml_dict, read_yaml
from fithubert_tpu_torch.export.torch_pickle import tolerant_torch_load

STUDENT_PREFIX = "student_model."


def reference_student_state_dict(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The student's weights of a Lightning ``.ckpt``, without their prefix."""
    ckpt = tolerant_torch_load(ckpt_path)
    sd = ckpt.get("state_dict", ckpt)
    out = {k[len(STUDENT_PREFIX):]: v for k, v in sd.items() if k.startswith(STUDENT_PREFIX)}
    if not out:
        raise KeyError(f"{ckpt_path}: no '{STUDENT_PREFIX}' weights in its state_dict")
    return out


def load_reference_student(ckpt_path: str, yaml_path: str
                           ) -> Tuple[ExperimentConfig, Dict[str, torch.Tensor]]:
    """(the experiment of the dumped YAML, the student's state dict). The
    teacher-init flags are turned off, as for serving; a ``distiller:`` key
    the JAX package does not know raises through the config's own check."""
    raw = read_yaml(yaml_path)
    raw["distiller"] = dict(raw.get("distiller") or {}, init_conv_layers=False,
                            init_encoder_layers=0)
    cfg = config_from_yaml_dict(raw)
    return cfg, reference_student_state_dict(ckpt_path)
