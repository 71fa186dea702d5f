"""The plain reference of the benchmark's cells: fp32 PyTorch, written
from the published models (fairseq's HuBERT and wav2vec 2.0 encoders, the
FitHuBERT and DistilHuBERT students and their losses, AdamW), importing
nothing of the program under test.

A configuration file (``configs/<name>.json``) names its model family's
module with the key ``"reference": "<stem>"``, the module being
``reference/<stem>.py``; without the key it is ``model``, the fairseq
transformer family. ``load(cfg)`` returns that module, checked against
this contract:

    QUANT                  {"fp32": identity, "fp8": the control's
                           rounding}: each product's operands go through
                           the chosen function;
    teacher_spec(g)        the teacher's leaves as (key, shape, kind,
                           scale), kind "normal", "uniform" or "fill",
                           keys as the program's state dict names them;
    student_spec(d, export) the student's, or with ``export`` the served
                           model's;
    teacher_forward(P, g, wav, wav_mask, q)
                           (layer hiddens, frame mask);
    student_forward(P, d, wav, wav_mask, drops, q, export=...)
                           {"x", "hiddens", "mask"} and, unless
                           ``export``, "projections";
    kd_loss(loss, d, proj, teacher_hiddens, rand_layers)
                           the distillation loss, a scalar;
    student_fwd_flops(d, n, live_heads=...)
                           model FLOPs of one forward over n samples;
    kd_step_flops(d, g, lengths)
                           model FLOPs of one optimizer step over rows
                           of those unpadded lengths;
    step_launches(cfg, lengths, t_pad), call_launches(cfg, lengths, t_pad)
                           the ``shapes.Launch`` list (family, what,
                           flops, bytes) of one train step or served
                           call over the family's own kernels; empty
                           where the model launches none of a family's.

``g`` is the configuration's ``teacher_geometry``, ``d`` its
``experiment.distiller``, ``loss`` its ``experiment.train``, ``cfg`` the
whole file, ``P`` a dict of fp32 leaves, ``q`` one of ``QUANT``.
"""

from __future__ import annotations

import importlib
import inspect
from types import ModuleType
from typing import Dict, List, Tuple

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # key, shape, init kind, scale

# each entry of the contract and the arguments its callers pass it
CONTRACT = {
    "teacher_spec": (1, ()),
    "student_spec": (2, ()),
    "teacher_forward": (5, ()),
    "student_forward": (6, ("export",)),
    "kd_loss": (5, ()),
    "student_fwd_flops": (2, ("live_heads",)),
    "kd_step_flops": (3, ()),
    "step_launches": (3, ()),
    "call_launches": (3, ()),
}


def load(cfg: Dict) -> ModuleType:
    """The reference module that configuration ``cfg`` names, checked
    against the contract; a module that breaks it raises TypeError."""
    stem = cfg.get("reference", "model")
    if not isinstance(stem, str) or not stem.isidentifier():
        raise ValueError(f"reference {stem!r}: not the stem of a file under reference/")
    mod = importlib.import_module(f"{__name__}.{stem}")
    quant = getattr(mod, "QUANT", None)
    if not isinstance(quant, dict) or not {"fp32", "fp8"} <= set(quant):
        raise TypeError(f"reference/{stem}.py: QUANT must map 'fp32' and 'fp8' to functions")
    for name, (n_args, keywords) in CONTRACT.items():
        fn = getattr(mod, name, None)
        if not callable(fn):
            raise TypeError(f"reference/{stem}.py has no function {name}")
        try:
            inspect.signature(fn).bind(*range(n_args), **{k: None for k in keywords})
        except TypeError as e:
            raise TypeError(f"reference/{stem}.py: {name} does not take its callers' "
                            f"arguments: {e}") from None
    return mod
