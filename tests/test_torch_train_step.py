"""The port's KD train step (fithubert_tpu_torch/train/step.py Distiller)
against the JAX package's Distiller.make_train_step() on the CPU: a tiny
teacher and student on carried weights, every dropout at 0, two
microbatches folded into one batch (fused accumulation), a ragged row and
a row fabricated as all padding. Three steps compare loss, grad_norm, lr,
the per-layer logs and every parameter after each step; the eval step's
v_loss is compared after them. With dropout on, the port's loss is finite
and the same seed replays the same step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import ExperimentConfig as JExperimentConfig
from fithubert_tpu.config import LossConfig as JLossConfig
from fithubert_tpu.config import OptimizerConfig as JOptimizerConfig
from fithubert_tpu.config import StudentConfig as JStudentConfig
from fithubert_tpu.config import TeacherConfig as JTeacherConfig
from fithubert_tpu.config import TrainConfig as JTrainConfig
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.parallel import make_mesh
from fithubert_tpu.train.step import Distiller as JDistiller
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

S_SPEC = ((32, 10, 5), (32, 3, 2), (48, 2, 2))  # stride 20
T_SPEC = ((32, 10, 5), (48, 3, 2), (48, 2, 2))
STUDENT = dict(conv_feature_layers=S_SPEC, encoder_layers=3, encoder_embed_dim=32,
               encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16,
               conv_pos_groups=4, layerwise_proj=True, enable_tr_layer=True,
               tr_layer_type="conv1d", tr_layer_index=0, pred_head_final_dim=48,
               pred_layer_id=(2,), required_seq_len_multiple=1)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
TEACHER = dict(conv_feature_layers=T_SPEC, encoder_layers=3, encoder_embed_dim=48,
               encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16,
               conv_pos_groups=4)
LOSS = dict(rec_loss_type="mse", sim_loss_weight=0.0, distil_random_layer=2,
            random_layer_weight=0.1)
OPT = dict(lr=5e-3, warmup_proportion=0.2, betas=(0.9, 0.98), eps=1e-6, weight_decay=0.01)
TRAIN = dict(batch_size=2, accumulate_grad_batches=2, fuse_grad_accum=True)
N_TRAIN_STEPS = 10  # warmup 2 steps: lr 0, 2.5e-3, 5e-3
RAND = [1, 0]

# fp32 on both sides, the same model: loss and grad_norm agree to
# summation order. Parameters after AdamW: an update is lr * m / (sqrt(v)
# + eps), so gradient entries near eps (1e-6) move by up to ~lr on a 1e-7
# difference; the bound is set well below lr = 5e-3.
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _configs(student_kw=NO_DROPOUT):
    jcfg = JExperimentConfig(
        teacher=JTeacherConfig(encoder_layers=3, encoder_embed_dim=48,
                               encoder_ffn_embed_dim=64, encoder_attention_heads=4),
        train=JTrainConfig(**TRAIN), loss=JLossConfig(**LOSS),
        distiller=JStudentConfig(**STUDENT, **NO_DROPOUT), optimizer=JOptimizerConfig(**OPT))
    tcfg = tc.ExperimentConfig(
        teacher=tc.TeacherConfig(encoder_layers=3, encoder_embed_dim=48,
                                 encoder_ffn_embed_dim=64, encoder_attention_heads=4),
        train=tc.TrainConfig(**TRAIN), loss=tc.LossConfig(**LOSS),
        distiller=tc.StudentConfig(**STUDENT, **student_kw), optimizer=tc.OptimizerConfig(**OPT))
    return jcfg, tcfg


def _batches(n, seed=0, fake_row=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
        mask = np.zeros((2, 2, 2000), bool)
        mask[0, 1, 1370:] = True  # ragged
        if fake_row:
            mask[1, 1] = True  # fabricated: all padding
            x[1, 1] = 0.0
        out.append({"x": x, "padding_mask": mask})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Distiller's initial weights and three steps' logs and params."""
    jcfg, _ = _configs()
    geom = JGeometry(**TEACHER, use_pallas_attention=False)
    d = JDistiller(jcfg, mesh=make_mesh(1), num_training_steps=N_TRAIN_STEPS,
                   teacher_geometry=geom)
    wav = jnp.zeros((2, 2000), jnp.float32)
    tp = d.init_teacher_params(jax.random.PRNGKey(0), wav)
    state = d.init_state(jax.random.PRNGKey(1), wav)
    init = (jax.tree_util.tree_map(np.asarray, tp["params"]),
            jax.tree_util.tree_map(np.asarray, state.params))
    step = d.make_train_step()
    rand = jnp.asarray(RAND, jnp.int32)
    logs, params = [], []
    for batch in _batches(3):
        state, lg = step(state, tp, jax.tree_util.tree_map(jnp.asarray, batch), rand,
                         jax.random.PRNGKey(2))
        logs.append({k: float(v) for k, v in lg.items()})
        params.append(jax.tree_util.tree_map(np.asarray, state.params))
    ev = _batches(1, seed=7)[0]
    ev = {k: jnp.asarray(v[0]) for k, v in ev.items()}
    v_loss = float(d.make_eval_step()(state, tp, ev, rand)["v_loss"])
    return init, logs, params, v_loss


def _port_distiller(init, student_kw=NO_DROPOUT, seed=0):
    _, tcfg = _configs(student_kw)
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, seed=seed))
    geom = TeacherGeometry(**TEACHER)
    t_sd = jax_teacher_params_to_state_dict(init[0], geom)
    s_sd = jax_student_params_to_state_dict(init[1], tcfg.distiller)
    return Distiller(tcfg, t_sd, s_sd, device="cpu", num_training_steps=N_TRAIN_STEPS,
                     teacher_geometry=geom)


def test_three_steps_match_the_jax_distiller(jax_run):
    init, want_logs, want_params, want_v_loss = jax_run
    d = _port_distiller(init)
    for i, batch in enumerate(_batches(3)):
        got = d.train_step(batch, RAND)
        assert set(got) == set(want_logs[i]), i
        for k, w in want_logs[i].items():
            np.testing.assert_allclose(got[k], w, err_msg=f"step {i} {k}", **LOSS_TOL)
        want_sd = jax_student_params_to_state_dict(want_params[i], d.cfg.distiller)
        got_sd = d.student.state_dict()
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       err_msg=f"step {i} {k}", **PARAM_TOL)
    assert [lg["lr"] for lg in want_logs] == pytest.approx([0.0, 2.5e-3, 5e-3])
    ev = _batches(1, seed=7)[0]
    got = d.eval_step({k: v[0] for k, v in ev.items()}, RAND)
    np.testing.assert_allclose(got["v_loss"], want_v_loss, **LOSS_TOL)
    assert got["v_loss"] == got["l2"]


def test_unfused_accumulation_matches_fused(jax_run):
    """The microbatch loop (grads summed, then divided by A) and the folded
    batch give the same step up to summation order. Without fabricated rows:
    with one, the fold takes the weighted mean over all real rows and the
    loop the mean of per-microbatch means (``step.py:266-275``)."""
    init = jax_run[0]
    a, b = _port_distiller(init), _port_distiller(init)
    b.cfg = dataclasses.replace(b.cfg, train=dataclasses.replace(b.cfg.train,
                                                                 fuse_grad_accum=False))
    for batch in _batches(2, fake_row=False):
        la, lb = a.train_step(batch, RAND), b.train_step(batch, RAND)
        np.testing.assert_allclose(lb["grad_norm"], la["grad_norm"], rtol=1e-4)
    for (k, pa), pb in zip(a.student.state_dict().items(), b.student.state_dict().values()):
        np.testing.assert_allclose(pb.numpy(), pa.numpy(), err_msg=k, **PARAM_TOL)


def test_dropout_step_is_finite_and_replays_from_its_seed(jax_run):
    init = jax_run[0]
    kw = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, dropout_input=0.05)
    runs = []
    for seed in (3, 3, 4):
        d = _port_distiller(init, kw, seed=seed)
        runs.append([d.train_step(batch, RAND)["loss"] for batch in _batches(2)])
    assert np.isfinite(runs[0]).all()
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TeacherModel(TeacherGeometry(**TEACHER))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Distiller(tcfg, {}, {})
    s = StudentModel(tcfg.distiller, device="cpu")
    assert next(s.parameters()).device.type == "cpu"
