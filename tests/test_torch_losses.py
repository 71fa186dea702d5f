"""The port's KD loss (fithubert_tpu_torch/train/losses.py) against the JAX
package's compute_losses on the same student and teacher tensors: the
release config's k = N-1 permutation path, the general random gather, the
pred_layer_id path, rec MSE and L1, the cosine-sim and cnn terms, the
common-length crop, masked reduction, a row fabricated as all padding, and
the attention-transfer terms on the last layer's taps. Values, logs and the
gradients into the student's projections and taps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import LossConfig as JLossConfig
from fithubert_tpu.config import StudentConfig as JStudentConfig
from fithubert_tpu.models.student import StudentOutput as JStudentOutput
from fithubert_tpu.models.teacher import TeacherOutput as JTeacherOutput
from fithubert_tpu.train.losses import compute_losses as j_compute_losses
from fithubert_tpu_torch.config import LossConfig, StudentConfig
from fithubert_tpu_torch.models.student import StudentOutput
from fithubert_tpu_torch.models.teacher import TeacherOutput
from fithubert_tpu_torch.train.losses import compute_losses

torch.set_num_threads(2)

# fp32 means over ~10^4 elements in another order.
TOL = dict(atol=1e-6, rtol=1e-5)

L, D = 4, 16  # layers, teacher width

CASES = {
    "release_perm_mse": (dict(rec_loss_type="mse", sim_loss_weight=0.0, distil_random_layer=3,
                              random_layer_weight=0.1), [2, 0, 1], {}),
    "gather_l1_sim": (dict(rec_loss_type="l1", sim_loss_weight=1.0, distil_random_layer=2,
                           random_layer_weight=0.3), [2, 0], {}),
    "pred_layer_id": (dict(rec_loss_type="l1", sim_loss_weight=1.0), None,
                      dict(pred_layer_id=(1, 3))),
    "masked_random": (dict(rec_loss_type="mse", sim_loss_weight=1.0, distil_random_layer=3,
                           random_layer_weight=0.1, masked_reduction=True), [1, 2, 0], {}),
    "masked_pred_layer_id": (dict(rec_loss_type="mse", sim_loss_weight=1.0,
                                  masked_reduction=True), None, dict(pred_layer_id=(3,))),
    "cnn_term": (dict(rec_loss_type="mse", sim_loss_weight=0.0, cnn_loss_weight=0.5,
                      distil_random_layer=3, random_layer_weight=0.1), [0, 1, 2], {}),
    "sim_only": (dict(rec_loss_weight=0.0, sim_loss_weight=1.0, distil_random_layer=3,
                      random_layer_weight=0.1), [1, 0, 2], {}),
}


def _data(seed, b=3, t_teacher=21, t_student=20, fake_row=True, mask=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    proj = f(b, L, t_student, D)
    hiddens = [f(b, t_teacher, D) for _ in range(L)]
    pm = None
    if mask:
        lengths = np.array([t_teacher, t_teacher - 6, 0 if fake_row else 9])[:b]
        pm = np.arange(t_teacher)[None, :] >= lengths[:, None]
    return dict(proj=proj, hiddens=hiddens, s_feat=f(b, t_student, D),
                t_feat=f(b, t_teacher, D), pm=pm)


def _jax(data, loss_kw, rand, scfg_kw):
    lc = JLossConfig(**loss_kw)
    sc = JStudentConfig(encoder_layers=L, layerwise_proj=True, **scfg_kw)
    teacher = JTeacherOutput(
        x=jnp.asarray(data["hiddens"][-1]),
        layer_results=[(jnp.asarray(h), None, None) for h in data["hiddens"]],
        features=jnp.asarray(data["t_feat"]),
        padding_mask=None if data["pm"] is None else jnp.asarray(data["pm"]))
    rl = None if rand is None else jnp.asarray(rand, jnp.int32)

    def total(proj):
        student = JStudentOutput(x=proj[:, -1], padding_mask=None,
                                 features=jnp.asarray(data["s_feat"]), layer_results=[],
                                 tr_layer_results=[], projections=proj)
        out = j_compute_losses(lc, sc, student, teacher, rand_layers=rl)
        return out.total, out

    (_, out), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(data["proj"]))
    logs = {k: float(v) for k, v in out.logs.items()}
    return logs, float(out.last_layer_loss), np.asarray(grad)


def _port(data, loss_kw, rand, scfg_kw):
    lc = LossConfig(**loss_kw)
    sc = StudentConfig(encoder_layers=L, layerwise_proj=True, **scfg_kw)
    proj = torch.from_numpy(data["proj"]).requires_grad_()
    teacher = TeacherOutput(
        x=torch.from_numpy(data["hiddens"][-1]),
        layer_results=[(torch.from_numpy(h), None, None) for h in data["hiddens"]],
        features=torch.from_numpy(data["t_feat"]),
        padding_mask=None if data["pm"] is None else torch.from_numpy(data["pm"]))
    student = StudentOutput(x=proj[:, -1], padding_mask=None,
                            features=torch.from_numpy(data["s_feat"]), layer_results=[],
                            tr_layer_results=[], projections=proj)
    out = compute_losses(lc, sc, student, teacher,
                         None if rand is None else torch.tensor(rand))
    out.total.backward()
    logs = {k: float(v.detach()) for k, v in out.logs.items()}
    return logs, float(out.last_layer_loss.detach()), proj.grad.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(case):
    loss_kw, rand, scfg_kw = CASES[case]
    data = _data(seed=len(case))
    want_logs, want_last, want_grad = _jax(data, loss_kw, rand, scfg_kw)
    got_logs, got_last, got_grad = _port(data, loss_kw, rand, scfg_kw)
    assert set(got_logs) == set(want_logs)
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k], want_logs[k], err_msg=k, **TOL)
    np.testing.assert_allclose(got_last, want_last, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)
    if data["pm"] is not None and not loss_kw.get("masked_reduction"):
        assert (got_grad[-1] == 0).all()  # the fabricated row weighs nothing


@pytest.mark.parametrize("lengths", [(20, 21), (21, 20)], ids=["teacher_longer",
                                                                 "student_longer"])
def test_common_length_crop_and_no_mask(lengths):
    """Either side one frame longer, no padding mask (plain means)."""
    loss_kw, rand, scfg_kw = CASES["gather_l1_sim"]
    data = _data(seed=5, t_teacher=lengths[0], t_student=lengths[1], mask=False)
    want_logs, _, want_grad = _jax(data, loss_kw, rand, scfg_kw)
    got_logs, _, got_grad = _port(data, loss_kw, rand, scfg_kw)
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k], want_logs[k], err_msg=k, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)


def test_permutation_path_logs_follow_the_slots():
    """With k = N-1 the gather is skipped, but rand_l{i} still reports the
    layer that slot i distilled: permuting rand_layers permutes the logs and
    leaves the total alone."""
    loss_kw, _, scfg_kw = CASES["release_perm_mse"]
    data = _data(seed=9)
    a, _, _ = _port(data, loss_kw, [0, 1, 2], scfg_kw)
    b, _, _ = _port(data, loss_kw, [2, 0, 1], scfg_kw)
    assert a["total"] == b["total"]
    assert [b[f"rand_l{i}"] for i in range(3)] == [a["rand_l2"], a["rand_l0"], a["rand_l1"]]


TAP_CASES = {
    "attn_mse": dict(rec_loss_weight=0.0, sim_loss_weight=0.0, attn_loss_weight=1.0,
                     attn_loss_type="mse"),
    "attn_kldiv": dict(rec_loss_weight=0.0, sim_loss_weight=0.0, attn_loss_weight=1.0,
                       attn_loss_type="kldiv"),
    "v_rel": dict(rec_loss_weight=0.0, sim_loss_weight=0.0, v_rel_loss_weight=1.0),
    "release_with_taps": dict(rec_loss_type="mse", sim_loss_weight=0.0, distil_random_layer=3,
                              random_layer_weight=0.1, attn_loss_weight=0.5,
                              attn_loss_type="kldiv", v_rel_loss_weight=0.25),
}
Z_HEADS, T_S = 2, 10  # heads; student frames (the teacher's T = 21 is cropped to it)


def _tap_data(seed):
    """Free student logits and value relations, the teacher's taps, and key
    masks: the teacher's at its frame rate (lengths 21, 15, 0: the last row
    fabricated), the student's at about half of it (10, 8, 0)."""
    data = _data(seed)
    rng = np.random.default_rng(seed + 100)
    z, t_t = 3 * Z_HEADS, 21
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    s_keys = np.repeat(np.arange(T_S)[None, :] >= np.array([10, 8, 0])[:, None], Z_HEADS, 0)
    t_keys = np.repeat(data["pm"], Z_HEADS, 0)
    t_logits = np.where(t_keys[:, None, :], -np.inf, f(z, t_t, t_t)).astype(np.float32)
    data.update(s_logits=f(z, T_S, T_S), s_vrel=f(z, T_S, T_S), t_logits=t_logits,
                t_vrel=f(z, t_t, t_t), s_keys=s_keys)
    return data


def _jax_taps(data, loss_kw):
    from fithubert_tpu.ops.attention import AttentionTaps as JTaps

    lc, sc = JLossConfig(**loss_kw), JStudentConfig(encoder_layers=L, layerwise_proj=True)
    hiddens = [jnp.asarray(h) for h in data["hiddens"]]
    t_taps = JTaps(jnp.asarray(data["t_logits"]), jnp.asarray(data["t_vrel"]))
    teacher = JTeacherOutput(x=hiddens[-1], layer_results=[(h, t_taps, None) for h in hiddens],
                             features=jnp.asarray(data["t_feat"]),
                             padding_mask=jnp.asarray(data["pm"]))

    def total(proj, logits, vrel):
        # padded keys at -inf, as the attention's taps branch gives them
        s_taps = JTaps(jnp.where(jnp.asarray(data["s_keys"])[:, None, :], -jnp.inf, logits),
                       vrel)
        student = JStudentOutput(x=proj[:, -1], padding_mask=None,
                                 features=jnp.asarray(data["s_feat"]),
                                 layer_results=[(None, s_taps, None)], tr_layer_results=[],
                                 projections=proj)
        out = j_compute_losses(lc, sc, student, teacher, rand_layers=jnp.asarray([2, 0, 1]))
        return out.total, out

    (_, out), grads = jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(data[k]) for k in ("proj", "s_logits", "s_vrel")))
    return {k: float(v) for k, v in out.logs.items()}, [np.asarray(g) for g in grads]


def _port_taps(data, loss_kw):
    from fithubert_tpu_torch.ops.attention import AttentionTaps

    lc, sc = LossConfig(**loss_kw), StudentConfig(encoder_layers=L, layerwise_proj=True)
    hiddens = [torch.from_numpy(h) for h in data["hiddens"]]
    t_taps = AttentionTaps(torch.from_numpy(data["t_logits"]), torch.from_numpy(data["t_vrel"]))
    teacher = TeacherOutput(x=hiddens[-1], layer_results=[(h, t_taps, None) for h in hiddens],
                            features=torch.from_numpy(data["t_feat"]),
                            padding_mask=torch.from_numpy(data["pm"]))
    proj, logits, vrel = (torch.from_numpy(data[k]).requires_grad_()
                          for k in ("proj", "s_logits", "s_vrel"))
    s_taps = AttentionTaps(
        logits.masked_fill(torch.from_numpy(data["s_keys"])[:, None, :], float("-inf")), vrel)
    student = StudentOutput(x=proj[:, -1], padding_mask=None,
                            features=torch.from_numpy(data["s_feat"]),
                            layer_results=[(None, s_taps, None)], tr_layer_results=[],
                            projections=proj)
    out = compute_losses(lc, sc, student, teacher, torch.tensor([2, 0, 1]))
    out.total.backward()
    return ({k: float(v.detach()) for k, v in out.logs.items()},
            [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
             for t in (proj, logits, vrel)])


@pytest.mark.parametrize("case", list(TAP_CASES))
def test_tap_losses_match_jax(case):
    """The attention-logit (mse, kldiv) and value-relation losses on the
    last layer's taps, student T = 10 against teacher T = 21 (cropped to the
    leading 10 x 10 block), padded keys at -inf and a fabricated row: logs
    and gradients into the student's logits, value relations and heads. The
    fabricated row's -inf logits give NaN terms, which both sides scrub, and
    its gradients are finite (zero)."""
    data = _tap_data(seed=len(case))
    want_logs, want_grads = _jax_taps(data, TAP_CASES[case])
    got_logs, got_grads = _port_taps(data, TAP_CASES[case])
    assert set(got_logs) == set(want_logs)
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k], want_logs[k], err_msg=k, **TOL)
    for name, got, want in zip(("proj", "logits", "v_rel"), got_grads, want_grads):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    fake = slice(2 * Z_HEADS, 3 * Z_HEADS)
    assert (got_grads[1][fake] == 0).all() and (got_grads[2][fake] == 0).all()
