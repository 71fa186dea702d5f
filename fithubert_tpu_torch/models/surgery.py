"""The teacher hint-init (``fithubert_tpu/models/surgery.py:49``): graft
teacher weights into a student state dict where the shapes line up.

    state, copied, skipped = init_student_from_teacher(student_state,
                                                       teacher_state, cfg)

``init_conv_layers`` copies ``feature_extractor.*`` and
``post_extract_proj.*``; ``init_encoder_layers = n`` copies
``encoder.pos_conv.*`` and the teacher's first n transformer layers. A
tensor whose shape differs is skipped without a word, as the reference's
bare ``try/except`` does (``modules/model.py:560-588``). Teacher layer i
goes to the student's *transformer* layer i: the port's
``encoder.layers`` holds the TR module at its slot, so with TR at slot
``tr_layer_index <= i`` transformer layer i is slot i + 1. The copies keep
the student's dtype, from the teacher's tensors as given: pass the
teacher's full-precision weights, before ``TeacherModel.freeze`` casts
them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from fithubert_tpu_torch.config import StudentConfig

StateDict = Dict[str, torch.Tensor]


def _copy_prefix(out: StateDict, teacher: Mapping[str, torch.Tensor], src: str, dst: str,
                 copied: List[str], skipped: List[str]) -> None:
    """Every teacher tensor under ``src`` onto the student's key under ``dst``."""
    for key, value in teacher.items():
        if not key.startswith(src):
            continue
        name = dst + key[len(src):]
        if name not in out:
            continue
        if tuple(out[name].shape) == tuple(value.shape):
            out[name] = value.detach().to(out[name].dtype).clone()
            copied.append(name)
        else:
            skipped.append(name)


def transformer_slot(cfg: StudentConfig, layer: int) -> int:
    """The ``encoder.layers`` slot of transformer layer ``layer``."""
    tr = cfg.tr_layer_index if cfg.enable_tr_layer else -1
    return layer + 1 if 0 <= tr <= layer else layer


def init_student_from_teacher(student_state: Mapping[str, torch.Tensor],
                              teacher_state: Mapping[str, torch.Tensor],
                              cfg: StudentConfig, verbose: bool = True
                              ) -> Tuple[StateDict, List[str], List[str]]:
    """(the student state with the teacher's tensors grafted in, the copied
    student keys, the skipped ones). ``student_state`` is not changed."""
    out = dict(student_state)
    copied: List[str] = []
    skipped: List[str] = []
    if cfg.init_conv_layers:
        for prefix in ("feature_extractor.", "post_extract_proj."):
            _copy_prefix(out, teacher_state, prefix, prefix, copied, skipped)
    n = cfg.init_encoder_layers
    if n > 0:
        if n > cfg.encoder_layers:
            raise ValueError(f"init_encoder_layers={n} > encoder_layers={cfg.encoder_layers}")
        _copy_prefix(out, teacher_state, "encoder.pos_conv.", "encoder.pos_conv.", copied,
                     skipped)
        for i in range(n):
            _copy_prefix(out, teacher_state, f"encoder.layers.{i}.",
                         f"encoder.layers.{transformer_slot(cfg, i)}.", copied, skipped)
    if verbose and (copied or skipped):
        print(f"[teacher-init] copied {len(copied)} tensors, "
              f"skipped {len(skipped)} (shape mismatch)")
    return out, copied, skipped
