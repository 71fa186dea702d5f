"""The port held to the JAX package's frozen goldens: tests/goldens/
student_fwd.npz, teacher_fwd.npz and train_step.npz, which
tests/test_goldens.py checks for the JAX package. ``scripts/make_goldens.py
build()``'s JAX-initialised weights are carried into the port
(``export/jax_params.py``), as tests/test_torch_conformer.py does for
``conformer_fwd.npz``; the geometry is fp32 without dropout.

Tolerances: the forwards to fp32 summation order through two frameworks
(1e-4 + 1e-4, ``F32_TOL`` of tests/test_torch_student.py); the step's loss
as tests/test_torch_train_step.py holds one (rtol 1e-4), its grad_norm and
parameter probe as tests/test_goldens.py holds them (rtol 1e-3), with the
probe's atol at tests/test_torch_train_step.py's ``PARAM_TOL`` (5e-5):
AdamW moves a parameter by about lr where its gradient sits near eps."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_RTOL, PROBE_TOL = 1e-4, 1e-3, dict(rtol=1e-3, atol=5e-5)


def _port_section(cls, jax_section):
    """The port's section of the same values (the fields both have)."""
    return cls(**{f.name: getattr(jax_section, f.name) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def built():
    """build()'s JAX Distiller, params and inputs, and the port's
    experiment, teacher geometry and state dicts of the same weights."""
    from scripts.make_goldens import build

    d, tp, state, wav, mask = build()
    cfg = d.cfg
    texp = tc.ExperimentConfig(
        teacher=_port_section(tc.TeacherConfig, cfg.teacher),
        train=_port_section(tc.TrainConfig, cfg.train),
        loss=_port_section(tc.LossConfig, cfg.loss),
        distiller=_port_section(tc.StudentConfig, cfg.distiller),
        optimizer=_port_section(tc.OptimizerConfig, cfg.optimizer))
    geom = _port_section(TeacherGeometry, d.teacher_geometry)
    t_sd = jax_teacher_params_to_state_dict(jax.device_get(tp["params"]), geom)
    s_sd = jax_student_params_to_state_dict(jax.device_get(state.params), texp.distiller)
    return texp, geom, t_sd, s_sd, np.asarray(wav), np.asarray(mask), d.cfg.distiller


def test_teacher_forward_matches_golden(built):
    texp, geom, t_sd, _, wav, mask, _ = built
    teacher = TeacherModel(geom, device="cpu")
    teacher.load_state_dict(t_sd, strict=True)
    out = teacher(torch.from_numpy(wav), torch.from_numpy(mask))
    g = np.load(os.path.join(GOLD, "teacher_fwd.npz"))
    np.testing.assert_allclose(out.x.numpy(), g["x"], **F32_TOL)
    hiddens = np.stack([h.numpy() for (h, _, _) in out.layer_results])
    np.testing.assert_allclose(hiddens, g["hiddens"], **F32_TOL)


def test_student_forward_matches_golden(built):
    texp, _, _, s_sd, wav, mask, _ = built
    student = StudentModel(texp.distiller, device="cpu")
    student.load_state_dict(s_sd, strict=True)
    out = student(torch.from_numpy(wav), torch.from_numpy(mask))
    g = np.load(os.path.join(GOLD, "student_fwd.npz"))
    np.testing.assert_allclose(out.x.numpy(), g["x"], **F32_TOL)
    np.testing.assert_allclose(out.projections.numpy(), g["proj"], **F32_TOL)


def test_train_step_matches_golden(built):
    """One AdamW step on the batch of build() (the golden's random layer 0):
    loss, grad_norm, and the first element of every parameter in the JAX
    tree's leaf order (the port's state dict mapped by the JAX package's
    importer)."""
    texp, geom, t_sd, s_sd, wav, mask, jcfg = built
    d = Distiller(texp, t_sd, s_sd, device="cpu", num_training_steps=8,
                  teacher_geometry=geom)
    logs = d.train_step({"x": wav[None], "padding_mask": mask[None]}, np.zeros((1,), np.int64))
    g = np.load(os.path.join(GOLD, "train_step.npz"))
    np.testing.assert_allclose(logs["loss"], g["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(logs["grad_norm"], g["grad_norm"], rtol=GRAD_RTOL)
    tree = map_student_state_dict({k: v.numpy() for k, v in d.student.state_dict().items()},
                                  jcfg)
    probe = np.asarray([np.ravel(leaf)[0] for leaf in jax.tree_util.tree_leaves(tree)],
                       np.float32)
    assert probe.shape == g["param_probe"].shape
    np.testing.assert_allclose(probe, g["param_probe"], **PROBE_TOL)
