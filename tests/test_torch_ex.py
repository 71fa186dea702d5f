"""The port's pieces of configs/ex.yaml (a DistilHuBERT-style student:
SplitLinear multi-task head, teacher hint-init, L1 + cosine on teacher
layers pred_layer_id) and the time-reduction variants, against the JAX
package on the same numpy-seeded inputs and carried weights, on the CPU:
SplitLinear, TimeReduction conv1d / fc1 / fc2 at TR slot 0 and mid-encoder
with an odd frame count (the ceil mask), the student with
layerwise_proj=False in fp32 and bf16, the surgery, an ex-shaped Distiller
fp32 step without dropout, the ex expert, the tr_fc1 golden, and the loop
on an ex-shaped config with synthetic data."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import ExperimentConfig as JExperimentConfig
from fithubert_tpu.config import LossConfig as JLossConfig
from fithubert_tpu.config import OptimizerConfig as JOptimizerConfig
from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.config import TeacherConfig as JTeacherConfig
from fithubert_tpu.config import TrainConfig as JTrainConfig
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.models import TeacherModel as JTeacher
from fithubert_tpu.models.surgery import init_student_from_teacher as j_surgery
from fithubert_tpu.ops.heads import SplitLinear as JSplitLinear
from fithubert_tpu.parallel import make_mesh
from fithubert_tpu.train.step import Distiller as JDistiller
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.surgery import init_student_from_teacher, transformer_slot
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.heads import SplitLinear
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.checkpoint import export_student
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

SPEC = ((32, 10, 5), (32, 3, 2), (48, 2, 2))  # stride 20
# ex.yaml's student at a small width: no TR, the SplitLinear head over
# teacher layers (0, 2), required_seq_len_multiple 2
EX = dict(conv_feature_layers=SPEC, encoder_layers=2, encoder_embed_dim=32,
          encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
          pred_head_final_dim=32, pred_layer_id=(0, 2), layerwise_proj=False,
          enable_tr_layer=False, tr_layer_type="fc1", tr_layer_index=1,
          required_seq_len_multiple=2)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
TEACHER = dict(conv_feature_layers=SPEC, encoder_layers=3, encoder_embed_dim=32,
               encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16,
               conv_pos_groups=4)

# fp32 on both sides, the same model: summation order only, at O(1) values.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 against the JAX package's bf16: at most BF16_FACTOR times the JAX
# package's own bf16-vs-fp32 difference (both round at slightly different
# places; the JAX CPU SplitLinear multiplies the unrounded fp32 weight).
BF16_FACTOR = 2.0


def _pair(dtype="float32", **over):
    kw = {**EX, **NO_DROPOUT, **over}
    return (JConfig(**kw, compute_dtype=dtype, use_pallas_attention=False,
                    use_pallas_conv=False),
            tc.StudentConfig(**kw, compute_dtype=dtype))


def _jax_params(jcfg, seed=0):
    """JAX init, every leaf perturbed so biases and norm affines are not
    trivial."""
    wav = jnp.zeros((1, 4000), jnp.float32)
    params = JStudent(jcfg).init(jax.random.PRNGKey(seed), wav, jnp.zeros((1, 4000), bool))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params["params"])


def _batch(lengths, seed=1):
    rng = np.random.default_rng(seed)
    t = max(lengths)
    wav = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.3
    return wav, np.arange(t)[None, :] >= np.asarray(lengths)[:, None]


def _f(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32))


def _outputs(out):
    d = {"x": _f(out.x), "features": _f(out.features), "mask": np.asarray(out.padding_mask)}
    for i, (h, _taps, lr) in enumerate(out.layer_results):
        d[f"hidden{i}"], d[f"ffn{i}"] = _f(h), _f(lr)
    for i, tr in enumerate(out.tr_layer_results):
        d[f"tr{i}"] = _f(tr)
    projs = out.projections
    if isinstance(projs, (list, tuple)):
        d.update({f"proj{i}": _f(p) for i, p in enumerate(projs)})
    elif projs is not None:
        d["projections"] = _f(projs)
    return d


def _run_both(jcfg, tcfg, params, wav, mask, **kw):
    jout = JStudent(jcfg, **kw).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    model = StudentModel(tcfg, device="cpu", **kw)
    model.load_state_dict(jax_student_params_to_state_dict(params, tcfg), strict=True)
    return _outputs(jout), _outputs(model(torch.from_numpy(wav), torch.from_numpy(mask)))


def _assert_close(want, got, tol=F32_TOL):
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name == "mask":
            np.testing.assert_array_equal(got[name], want[name])
        else:
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


# ---------------------------------------------------------------- SplitLinear
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_linear_matches_jax(n, dtype):
    """in_split 1 is a plain Linear named ``layer``; > 1 one batched product
    with fp32 sums, the bias added in fp32. bf16 within one bf16 step of the
    output (2^-8 relative) plus the weight's rounding the JAX CPU path
    skips."""
    din, dout = 16, 24
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, 7, n * din)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    mod = JSplitLinear(in_dim=din, in_split=n, out_dim=dout, dtype=jdt)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = _f(mod.apply({"params": params}, jnp.asarray(x).astype(jdt)))
    port = SplitLinear(din, n, dout)
    if n == 1:
        sd = {"layer.weight": torch.tensor(np.asarray(params["layer"]["kernel"]).T),
              "layer.bias": torch.tensor(np.asarray(params["layer"]["bias"]))}
    else:
        sd = {k: torch.tensor(np.asarray(params[k])) for k in ("weight", "bias")}
        assert tuple(sd["weight"].shape) == (n, din, dout)
        assert tuple(sd["bias"].shape) == (1, 1, n, dout)
    port.load_state_dict(sd, strict=True)
    got = _f(port(torch.from_numpy(x).to(getattr(torch, dtype))))
    tol = F32_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


# ------------------------------------------------------------- TimeReduction
@pytest.mark.parametrize("tr_type", ["conv1d", "fc1", "fc2"])
@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("layerwise", [True, False])
def test_time_reduction_matches_jax_with_an_odd_frame_count(tr_type, index, layerwise):
    """TR at slot 0 and mid-encoder (slot 1 of 3 layers: the heads of a
    layer-wise student are then ragged), 109 frames into the TR (odd: fc1
    and fc2 pad to 55 frames with the ceil mask, conv1d floors to 54)."""
    over = dict(encoder_layers=3, enable_tr_layer=True, tr_layer_type=tr_type,
                tr_layer_index=index, layerwise_proj=layerwise, required_seq_len_multiple=1)
    jcfg, tcfg = _pair(**over)
    wav, mask = _batch((2200, 1630), seed=index)
    want, got = _run_both(jcfg, tcfg, _jax_params(jcfg, seed=3), wav, mask)
    assert want["tr0"].shape[1] == (55 if tr_type != "conv1d" else 54)
    _assert_close(want, got)


def test_time_reduction_state_dict_keys_are_the_reference_importers():
    """fc1 is ``encoder.layers.{slot}.weight`` (f*d -> d), fc2 ``.0`` (f*d ->
    f*d) and ``.2`` (f*d -> d): the keys fithubert_tpu/export/
    reference_import.py:91-103 maps."""
    for tr_type, keys in (("fc1", {"weight": (32, 64), "bias": (32,)}),
                          ("fc2", {"0.weight": (64, 64), "0.bias": (64,), "2.weight": (32, 64),
                                   "2.bias": (32,)})):
        _, tcfg = _pair(enable_tr_layer=True, tr_layer_type=tr_type, tr_layer_index=1)
        sd = StudentModel(tcfg, device="cpu").state_dict()
        got = {k[len("encoder.layers.1."):]: tuple(v.shape) for k, v in sd.items()
               if k.startswith("encoder.layers.1.")}
        assert got == keys


def test_tr_fc1_golden_through_carried_weights():
    """tests/goldens/tr_fc1_fwd.npz: build_tr_fc1's JAX-initialised weights
    carried to the port give the golden output and mask."""
    from scripts.make_goldens import build_tr_fc1

    model, variables, wav, mask = build_tr_fc1()
    jcfg = model.cfg
    tcfg = tc.StudentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tc.StudentConfig)})
    port = StudentModel(tcfg, device="cpu")
    port.load_state_dict(jax_student_params_to_state_dict(variables["params"], tcfg))
    out = port(torch.tensor(np.asarray(wav)), torch.tensor(np.asarray(mask)))
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "tr_fc1_fwd.npz"))
    np.testing.assert_array_equal(out.padding_mask.numpy(), g["mask"])
    np.testing.assert_allclose(out.x.numpy(), g["x"], **F32_TOL)


# ------------------------------------------------ the layerwise_proj=False student
@pytest.mark.parametrize("over", [{}, dict(enable_tr_layer=True, tr_layer_index=1),
                                  dict(pred_layer_id=(2,)), dict(pred_head_inter_dim=24)],
                         ids=["ex", "tr_fc1_upsampler", "one_task", "inter_dim"])
def test_split_head_student_fp32_matches_jax(over):
    """(B, N, T, D) projections through proj_head_in -> GELU -> SplitLinear,
    the upsampler when TR is on; ragged rows; T padded to the multiple of 2
    and cut back."""
    jcfg, tcfg = _pair(**over)
    wav, mask = _batch((4000, 3170, 2210))
    want, got = _run_both(jcfg, tcfg, _jax_params(jcfg), wav, mask)
    n = len(jcfg.pred_layer_id)
    assert got["projections"].shape[:2] == (3, n) and got["projections"].shape[3] == 32
    _assert_close(want, got)


def test_split_head_student_bf16_matches_jax():
    jcfg32, tcfg32 = _pair()
    jcfg, tcfg = _pair("bfloat16")
    params = _jax_params(jcfg32)
    wav, mask = _batch((4000, 3170, 2210))
    want32, _ = _run_both(jcfg32, tcfg32, params, wav, mask)
    want, got = _run_both(jcfg, tcfg, params, wav, mask)
    for name in want:
        if name == "mask":
            continue
        ref_err = np.abs(want[name] - want32[name]).max()
        port_err = np.abs(got[name] - want[name]).max()
        assert port_err <= BF16_FACTOR * ref_err, (name, port_err, ref_err)


def test_disable_projections_builds_no_split_head():
    _, tcfg = _pair(enable_tr_layer=True)
    keys = StudentModel(tcfg, device="cpu", disable_projections=True).state_dict()
    assert not any(k.startswith("proj_head.") for k in keys)
    assert {"upsampler.weight", "upsampler.bias"} <= set(keys)


# ------------------------------------------------------------------ surgery
def _jax_teacher(geom_kw, seed):
    geom = JGeometry(**geom_kw, use_pallas_attention=False, use_pallas_conv=False)
    wav = jnp.zeros((1, 4000), jnp.float32)
    params = JTeacher(geometry=geom).init(jax.random.PRNGKey(seed), wav,
                                          jnp.zeros((1, 4000), bool))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("case", ["ex", "tr_slot_1", "tr_slot_0_narrow"])
def test_surgery_matches_jax(case, capsys):
    """init_conv_layers copies the extractor and post_extract_proj;
    init_encoder_layers = 2 the positional conv and teacher layers 0 and 1,
    onto the student's transformer layers 0 and 1 whatever slot the TR
    takes; tensors whose shapes differ are skipped. The copied and skipped
    counts and every tensor of the result equal the JAX surgery's."""
    over = {"ex": {}, "tr_slot_1": dict(enable_tr_layer=True, tr_layer_index=1),
            "tr_slot_0_narrow": dict(enable_tr_layer=True, tr_layer_index=0,
                                     encoder_ffn_embed_dim=48)}[case]
    over.update(init_conv_layers=True, init_encoder_layers=2)
    jcfg, tcfg = _pair(**over)
    student = _jax_params(jcfg, seed=1)
    teacher = _jax_teacher(TEACHER, seed=2)
    capsys.readouterr()
    want = j_surgery(student, {"params": teacher}, jcfg)
    j_line = capsys.readouterr().out.strip()

    geom = TeacherGeometry(**TEACHER)
    got, copied, skipped = init_student_from_teacher(
        jax_student_params_to_state_dict(student, tcfg),
        jax_teacher_params_to_state_dict(teacher, geom), tcfg)
    assert capsys.readouterr().out.strip() == j_line
    assert j_line == f"[teacher-init] copied {len(copied)} tensors, skipped {len(skipped)} " \
                     f"(shape mismatch)"
    # the extractor (3 convs, the GroupNorm's 2) and post_extract_proj 7, the
    # positional conv 3, two layers of 16; the narrow FFN skips fc1 and fc2.weight
    assert (len(copied), len(skipped)) == ((36, 6) if case == "tr_slot_0_narrow" else (42, 0))
    want_sd = jax_student_params_to_state_dict(want, tcfg)
    assert set(got) == set(want_sd)
    for k in want_sd:
        torch.testing.assert_close(got[k], want_sd[k], rtol=0, atol=0, msg=k)
    slot = transformer_slot(tcfg, 1)
    assert slot == {"ex": 1, "tr_slot_1": 2, "tr_slot_0_narrow": 2}[case]
    t_sd = jax_teacher_params_to_state_dict(teacher, geom)
    torch.testing.assert_close(got[f"encoder.layers.{slot}.self_attn.q_proj.weight"],
                               t_sd["encoder.layers.1.self_attn.q_proj.weight"], rtol=0, atol=0)


# --------------------------------------------------------- the ex train step
LOSS = dict(rec_loss_weight=1.0, rec_loss_type="l1", sim_loss_weight=1.0,
            distil_random_layer=0, random_layer_weight=0.0)
OPT = dict(lr=5e-3, warmup_proportion=0.2, betas=(0.9, 0.98), eps=1e-6, weight_decay=1e-6)
TRAIN = dict(batch_size=2, accumulate_grad_batches=2, fuse_grad_accum=True, use_fp16=False)
# as tests/test_torch_train_step.py: loss and grad_norm to summation order;
# AdamW moves a parameter by ~lr where its gradient sits near eps
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _step_batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
        mask = np.zeros((2, 2, 2000), bool)
        mask[0, 1, 1370:] = True  # ragged
        mask[1, 1] = True  # fabricated: all padding
        x[1, 1] = 0.0
        out.append({"x": x, "padding_mask": mask})
    return out


def test_ex_distiller_two_fp32_steps_match_jax():
    """The ex loss (L1 + cosine on teacher layers 0 and 2 from the SplitLinear
    head), two microbatches folded, a ragged and a fabricated row: loss,
    layer0, layer2, total, grad_norm, lr and every parameter after each of
    two steps, and the eval step's v_loss."""
    jcfg, tcfg = _pair()
    jexp = JExperimentConfig(
        teacher=JTeacherConfig(encoder_layers=3, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                               encoder_attention_heads=4),
        train=JTrainConfig(**TRAIN), loss=JLossConfig(**LOSS), distiller=jcfg,
        optimizer=JOptimizerConfig(**OPT))
    texp = tc.ExperimentConfig(
        teacher=tc.TeacherConfig(encoder_layers=3, encoder_embed_dim=32,
                                 encoder_ffn_embed_dim=64, encoder_attention_heads=4),
        train=tc.TrainConfig(**TRAIN), loss=tc.LossConfig(**LOSS), distiller=tcfg,
        optimizer=tc.OptimizerConfig(**OPT))
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=10,
                    teacher_geometry=JGeometry(**TEACHER, use_pallas_attention=False))
    wav = jnp.zeros((2, 2000), jnp.float32)
    tp = jd.init_teacher_params(jax.random.PRNGKey(0), wav)
    state = jd.init_state(jax.random.PRNGKey(1), wav)
    geom = TeacherGeometry(**TEACHER)
    pd = Distiller(texp, jax_teacher_params_to_state_dict(tp["params"], geom),
                   jax_student_params_to_state_dict(state.params, tcfg), device="cpu",
                   num_training_steps=10, teacher_geometry=geom)
    step = jd.make_train_step()
    for i, batch in enumerate(_step_batches(2)):
        state, jl = step(state, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                         jnp.zeros((0,), jnp.int32), jax.random.PRNGKey(2))
        got = pd.train_step(batch, None)
        want = {k: float(v) for k, v in jl.items()}
        assert set(got) == set(want) == {"layer0", "layer2", "total", "loss", "grad_norm", "lr"}
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, err_msg=f"step {i} {k}", **LOSS_TOL)
        want_sd = jax_student_params_to_state_dict(jax.device_get(state.params), tcfg)
        got_sd = pd.student.state_dict()
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       err_msg=f"step {i} {k}", **PARAM_TOL)
    ev = {k: v[0] for k, v in _step_batches(1)[0].items()}
    want_v = float(jd.make_eval_step()(state, tp, jax.tree_util.tree_map(jnp.asarray, ev),
                                       jnp.zeros((0,), jnp.int32))["v_loss"])
    got_v = pd.eval_step(ev, None)
    np.testing.assert_allclose(got_v["v_loss"], want_v, **LOSS_TOL)
    assert got_v["v_loss"] == got_v["total"]


def test_delete_projections_refuses_the_feature_losses():
    _, tcfg = _pair()
    texp = tc.ExperimentConfig(
        teacher=tc.TeacherConfig(**{k: v for k, v in TEACHER.items()
                                    if k.startswith("encoder")}),
        train=tc.TrainConfig(**TRAIN, delete_projections=True), loss=tc.LossConfig(**LOSS),
        distiller=tcfg)
    geom = TeacherGeometry(**TEACHER)
    gen = torch.Generator().manual_seed(0)
    s = StudentModel(tcfg, device="cpu", disable_projections=True).init_weights(gen)
    t = TeacherModel(geom, device="cpu").init_weights(gen)
    d = Distiller(texp, t.state_dict(), s.state_dict(), device="cpu", teacher_geometry=geom)
    with pytest.raises(ValueError, match="delete_projections"):
        d.train_step(_step_batches(1)[0], None)


# ----------------------------------------------------------------- the expert
def test_ex_expert_serves_the_upsampled_hidden_as_jax(tmp_path):
    """export_student's pair (every head in the .pt) loads back into
    UpstreamExpert, which drops the whole SplitLinear head and serves the
    upsampled final hidden; against the JAX export model on the same padded
    batch."""
    jcfg, tcfg = _pair(enable_tr_layer=True, tr_layer_index=1, encoder_layers=3)
    params = _jax_params(jcfg, seed=4)
    yaml_path, pt_path = export_student(
        tc.ExperimentConfig(distiller=tcfg), jax_student_params_to_state_dict(params, tcfg),
        str(tmp_path), tag="student")
    expert = UpstreamExpert(pt_path, yaml_path, device="cpu", length_quantum=1000)
    rng = np.random.default_rng(5)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 2421, 1700)]
    got = expert(wavs)
    wav, mask = _batch([len(w) for w in wavs])
    for i, w in enumerate(wavs):
        wav[i, :len(w)] = w
    jparams = {k: v for k, v in params.items() if not k.startswith("proj_head_")}
    jout = JStudent(jcfg, disable_projections=True).apply(
        {"params": jparams}, jnp.asarray(wav), jnp.asarray(mask))
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(jout.padding_mask))
    assert got["last_hidden_state"].shape[-1] == jcfg.encoder_embed_dim
    np.testing.assert_allclose(_f(got["last_hidden_state"]), _f(jout.x), **F32_TOL)
    assert len(got["hidden_states"]) == 3
    for h, (jh, _, _) in zip(got["hidden_states"], jout.layer_results):
        np.testing.assert_allclose(_f(h), _f(jh), **F32_TOL)


# ------------------------------------------------------------------- the loop
def _ex_loop_config(out_dir, **train):
    """configs/ex.yaml at a small width (the teacher's 3 layers, the
    student's 2), with synthetic data."""
    cfg = tc.ex_experiment()
    return dataclasses.replace(
        cfg,
        teacher=dataclasses.replace(cfg.teacher, teacher_model="",
                                    **{k: v for k, v in TEACHER.items()
                                       if k.startswith("encoder")}),
        distiller=dataclasses.replace(cfg.distiller, **{**EX, "compute_dtype": "float32",
                                                        "init_conv_layers": True,
                                                        "init_encoder_layers": 2}),
        data=dataclasses.replace(cfg.data, synthetic=True, synthetic_num_batches=4,
                                 synthetic_wav_length=4000, length_quantum=1000),
        train=dataclasses.replace(cfg.train, output_dir=str(out_dir), num_epochs=2,
                                  use_fp16=False, log_every=1, num_devices=1,
                                  batch_size=2, **train))


def test_ex_loop_trains_resumes_and_serves(tmp_path, capsys, monkeypatch):
    """run_training on an ex-shaped config: the hint-init runs on the random
    teacher before the Distiller casts it (its counts printed), two epochs
    of two steps; a run stopped after epoch 0 and resumed gives the
    uninterrupted losses bit for bit; the export serves."""
    # the teacher's conv spec is the student's here, so the extractor copies
    monkeypatch.setattr(TeacherGeometry, "from_teacher_config",
                        classmethod(lambda cls, t: cls(**TEACHER)))
    full = loop.run_training(_ex_loop_config(tmp_path / "full"), resume=False, device="cpu")
    assert "[teacher-init] copied 42 tensors, skipped 0" in capsys.readouterr().out
    assert full["steps"] == 4 and np.isfinite(full["best_v_loss"])
    first = loop.run_training(_ex_loop_config(tmp_path / "r", max_steps=2), resume=False,
                              device="cpu")
    second = loop.run_training(_ex_loop_config(tmp_path / "r"), resume=True, device="cpu")
    assert (first["steps"], second["steps"]) == (2, 4)
    import json

    def losses(d):
        with open(d / "metrics.jsonl") as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}

    assert losses(tmp_path / "r") == losses(tmp_path / "full")
    expert = UpstreamExpert(str(tmp_path / "full" / "student.pt"),
                            str(tmp_path / "full" / "student.yaml"), device="cpu")
    out = expert([np.zeros(3000, np.float32), np.ones(2000, np.float32) * 0.1])
    assert torch.isfinite(out["last_hidden_state"]).all()


@pytest.mark.parametrize("over", [{}, dict(pred_layer_id=(1,)),
                                  dict(enable_tr_layer=True, tr_layer_type="fc2")],
                         ids=["split3", "split1", "tr_fc2"])
def test_init_weights_draws_every_parameter(over):
    """Every parameter of the SplitLinear and TR variants is drawn from the
    seed: two models from one seed are equal and finite (a parameter left
    as torch.empty would differ)."""
    _, tcfg = _pair(**over)
    a, b = (StudentModel(tcfg, device="cpu").init_weights(torch.Generator().manual_seed(9))
            for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.isfinite(va).all() and va.abs().max() < 10, k
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)


def test_positional_conv_backward_equals_autograd_of_conv1d():
    """The positional conv's own backward (the input gradient as a forward
    convolution of flipped kernels, the weight gradient by cuDNN's
    deterministic algorithm on the card) gives autograd's gradients through
    F.conv1d: the weight and bias gradients bit for bit (the same aten call
    on the CPU), the input gradient to fp32 summation order."""
    from fithubert_tpu_torch.ops.conv import _GroupedConv1d

    gen = torch.Generator().manual_seed(2)
    x, w, b = (torch.randn(*s, generator=gen).requires_grad_()
               for s in ((2, 32, 40), (32, 8, 16), (32,)))
    g = torch.randn(2, 32, 41, generator=gen)
    got = torch.autograd.grad(_GroupedConv1d.apply(x, w, b, 8, 4), (x, w, b), g)
    want = torch.autograd.grad(torch.nn.functional.conv1d(x, w, b, padding=8, groups=4),
                               (x, w, b), g)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    for k, pad in ((16, 8), (5, 2), (8, 3)):  # SamePad's even k, an odd k, another padding
        w2 = torch.randn(32, 8, k, generator=gen).requires_grad_()
        got = torch.autograd.grad(_GroupedConv1d.apply(x, w2, b, pad, 4).square().sum(), x)
        want = torch.autograd.grad(torch.nn.functional.conv1d(x, w2, b, padding=pad,
                                                              groups=4).square().sum(), x)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
