"""``checkpoint_activations`` in the port (ops/remat.py), the counterpart of
the JAX package's ``nn.remat`` of each encoder layer (tests/test_remat.py).

On the port's side the flag must change nothing but memory: with dropout
on, a checkpointed layer replays its draws from its own slots of the seed
table (``DropoutRNG.fork``), so loss, gradients, parameters after AdamW and
the conformer's BatchNorm running statistics are bit for bit those of the
plain step, and the statistics move once (in the forward, not again in the
recompute). Against the JAX package, with the flag on in both and dropout
off, the student's value and gradients are held to test_remat.py's own
bounds, the gradients also to the port's fp32 parity with JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.jax_params import jax_student_params_to_state_dict
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.conformer import RowMaskedBatchNorm
from fithubert_tpu_torch.ops.dropout import ENCODER_SLOTS, LAYER_SLOTS, DropoutRNG
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

SMALL = dict(conv_feature_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2,
             encoder_embed_dim=32, encoder_ffn_embed_dim=48, encoder_attention_heads=4,
             conv_pos=16, conv_pos_groups=4, pred_head_final_dim=32, pred_layer_id=(1,),
             layerwise_proj=True, enable_tr_layer=False, required_seq_len_multiple=1,
             depthwise_conv_kernel_size=7)
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, dropout_input=0.05)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
DISPATCH = {
    "transformer": dict(layer_type="transformer", enable_tr_layer=True, tr_layer_type="conv1d",
                        tr_layer_index=0),
    # abs conformer layers inside the transformer encoder, with its TR
    "abs": dict(layer_type="conformer", pos_enc_type="abs", attn_type="espnet",
                enable_tr_layer=True, tr_layer_type="conv1d", tr_layer_index=0),
    "rel_pos": dict(layer_type="conformer", pos_enc_type="rel_pos", attn_type="espnet"),
    "rope": dict(layer_type="conformer", pos_enc_type="rope", attn_type="espnet"),
}
TEACHER = dict(conv_feature_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), encoder_layers=2,
               encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
               conv_pos=16, conv_pos_groups=4)
# Against JAX: the JAX package's own remat bounds (tests/test_remat.py), the
# loss to 1e-6 relative and each gradient entry to 1e-5 absolute, plus 1e-4
# relative on the gradients, the port's fp32 parity with the JAX student
# (tests/test_torch_student.py): two frameworks sum a gradient entry of
# up to ~30 (the positional conv's bias) in other orders.
REMAT_RTOL, REMAT_GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5, 1e-4


def _cfg(dispatch, remat, **over):
    return tc.StudentConfig(**{**SMALL, **DROPOUT, **DISPATCH[dispatch], **over},
                            checkpoint_activations=remat)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((rng.standard_normal((2, 4000)) * 0.3).astype(np.float32))
    mask = torch.zeros((2, 4000), dtype=torch.bool)
    mask[1, 2900:] = True
    return wav, mask


def _student_grads(cfg, state, seed=3):
    """Loss, every gradient and buffer after one training forward and backward."""
    model = StudentModel(cfg, device="cpu")
    model.load_state_dict(state)
    wav, mask = _batch()
    out = model.forward_train(wav, mask, DropoutRNG(seed, "cpu"))
    loss = (out.x.float() ** 2).sum() * 1e-3 + out.projections.float().pow(2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, {n: b.clone() for n, b in model.named_buffers()}


@pytest.mark.parametrize("dispatch", list(DISPATCH))
def test_remat_gives_the_plain_loss_and_gradients_bit_for_bit(dispatch):
    """Dropout on (every rate above 0): the checkpointed layers draw the
    same masks in the forward and again in the recompute."""
    state = StudentModel(_cfg(dispatch, False), device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    loss0, grads0, bufs0 = _student_grads(_cfg(dispatch, False), state)
    loss1, grads1, bufs1 = _student_grads(_cfg(dispatch, True), state)
    assert torch.equal(loss0, loss1)
    assert set(grads0) == set(grads1) and grads0
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
    for n in bufs0:
        assert torch.equal(bufs0[n], bufs1[n]), n


@pytest.mark.parametrize("dispatch", ["abs", "rel_pos"])
def test_batchnorm_statistics_advance_once_under_remat(dispatch):
    """The running statistics after forward and backward equal those after
    the forward alone: the recompute leaves them where the forward put
    them, as the JAX remat's batch_stats come from the forward."""
    cfg = _cfg(dispatch, True)
    state = StudentModel(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    _loss, _grads, after_backward = _student_grads(cfg, state)
    model = StudentModel(cfg, device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        model.forward_train(*_batch(), DropoutRNG(3, "cpu"))
    stats = [n for n, m in model.named_modules() if isinstance(m, RowMaskedBatchNorm)]
    assert stats
    for n, b in model.named_buffers():
        assert torch.equal(b, after_backward[n]), n
        if n.endswith("running_mean"):
            assert not torch.equal(b, state[n]), n  # the forward did move them


def _experiment(dispatch, remat):
    return tc.ExperimentConfig(
        teacher=tc.TeacherConfig(**{k: v for k, v in TEACHER.items()
                                    if k.startswith("encoder_")}),
        train=tc.TrainConfig(batch_size=2, accumulate_grad_batches=2),
        loss=tc.LossConfig(rec_loss_type="mse", distil_random_layer=0),
        distiller=_cfg(dispatch, remat),
        optimizer=tc.OptimizerConfig(lr=5e-3, warmup_proportion=0.2))


@pytest.mark.parametrize("dispatch", ["transformer", "rel_pos"])
def test_remat_distiller_steps_are_bit_for_bit(dispatch):
    """Two Distiller steps of two microbatches with dropout on: logs,
    parameters, AdamW's moments and the BatchNorm statistics bit for bit
    with the flag on and off."""
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry(**TEACHER)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(_cfg(dispatch, False), device="cpu").init_weights(gen).state_dict()
    rng = np.random.default_rng(0)
    batches = [{"x": (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32),
                "padding_mask": np.zeros((2, 2, 2000), bool)} for _ in range(2)]
    runs = []
    for remat in (False, True):
        d = Distiller(_experiment(dispatch, remat), t_state, s_state, device="cpu",
                      num_training_steps=10, teacher_geometry=geom)
        logs = [d.train_step(b, None) for b in batches]
        runs.append((logs, d.state_dict()))
    (logs0, sd0), (logs1, sd1) = runs
    assert logs0 == logs1
    for n, t in sd0["student"].items():
        assert torch.equal(t, sd1["student"][n]), n
    for i, st in sd0["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sd1["optimizer"]["state"][i][k]), (i, k)


def test_a_forked_layer_replays_its_own_slots():
    rng = DropoutRNG(9, "cpu")
    a = [rng.fork(3).seed_words() for _ in range(2)]
    assert torch.equal(a[0], a[1])
    assert torch.equal(a[0], rng.table[ENCODER_SLOTS + 3 * LAYER_SLOTS])
    assert not torch.equal(rng.fork(2).seed_words(), a[0])
    rng.seed_words()  # the encoder's own draws do not move a layer's
    assert torch.equal(rng.fork(3).seed_words(), a[0])


def test_layerdrop_gates_on_the_device_and_remats_bit_for_bit():
    """layerdrop 0.5: the gate is a drawn device flag, so the step makes no
    host decision; with the flag on the step is bit for bit the same."""
    state = StudentModel(_cfg("transformer", False), device="cpu").init_weights(
        torch.Generator().manual_seed(1)).state_dict()
    runs = [_student_grads(_cfg("transformer", r, encoder_layerdrop=0.5), state, seed=s)
            for r in (False, True) for s in (4, 5)]
    for (l0, g0, _b0), (l1, g1, _b1) in ((runs[0], runs[2]), (runs[1], runs[3])):
        assert torch.equal(l0, l1)
        for n in g0:
            assert torch.equal(g0[n], g1[n]), n


def _jax_pair(dispatch):
    kw = {**SMALL, **NO_DROPOUT, **DISPATCH[dispatch], "checkpoint_activations": True}
    return (JConfig(**kw, use_pallas_attention=False, use_pallas_conv=False),
            tc.StudentConfig(**kw))


@pytest.mark.parametrize("dispatch", ["transformer", "abs"])
def test_remat_student_matches_jax_with_the_flag_on(dispatch):
    """The flag on in both packages, a training forward with every dropout
    at 0 (the BatchNorm on batch statistics): the value and every gradient
    of sum(x^2) * 1e-3 within test_remat.py's bounds (the gradients also
    to 1e-4 relative, the port's parity with JAX). The weights are the
    port's seeded init, mapped by the JAX package's importer."""
    jcfg, tcfg = _jax_pair(dispatch)
    model = StudentModel(tcfg, device="cpu")
    sd = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
    collections = {}
    params = map_student_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg, collections)
    stats = collections.get("batch_stats")
    wav, mask = _batch()
    jmodel = JStudent(jcfg)

    def f(p):
        variables = {"params": p, **({"batch_stats": stats} if stats is not None else {})}
        out, _ = jmodel.apply(variables, jnp.asarray(wav.numpy()), jnp.asarray(mask.numpy()),
                              deterministic=False, mutable=["batch_stats"])
        return jnp.sum(out.x.astype(jnp.float32) ** 2) * 1e-3

    value, grads = jax.jit(jax.value_and_grad(f))(params)
    want = jax_student_params_to_state_dict(jax.device_get(grads), tcfg, stats)
    out = model.forward_train(wav, mask, DropoutRNG(0, "cpu"))
    loss = (out.x.float() ** 2).sum() * 1e-3
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=REMAT_RTOL)
    for n, p in model.named_parameters():
        if n in want and p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=REMAT_GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=n)
