"""int8 matmuls of the port (fithubert_tpu_torch/ops/quant.py) against the
JAX package's (fithubert_tpu/ops/quant.py): the cases of tests/test_quant.py
that have a meaning in the port (its TP-mesh case has none), and bit for
bit what the recipe makes exact: the int8 payloads and their fp32 scales,
and the int32 accumulators. The dequantized output rounds once more than
the accumulator, in another order of the multiplies where XLA fuses them:
within 1 bf16 ulp. Through a whole model the activations are quantized
again after every layer, so an output that moved by an ulp can move an
int8 step further on: models are compared by the JAX package's own test's
measure (cosine above 0.99 against the float model) and against the JAX
int8 model to the tolerance stated at each test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.models import TeacherModel as JTeacher
from fithubert_tpu.ops import quant as jquant
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops import quant
from fithubert_tpu_torch.ops.attention import linear
from tests.test_torch_student import batch, configs, jax_params

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7  # one bf16 step, relative
BF16_FACTOR = 2.0  # tests/test_torch_student.py's
TEACHER = dict(conv_feature_layers=((32, 10, 5), (32, 3, 2), (48, 2, 2)), encoder_layers=2,
               encoder_embed_dim=64, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
               conv_pos=16, conv_pos_groups=4)


def _cosine(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-9))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _operands(seed=0, shape=(4, 37, 256), n=512):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(scale=0.02, size=(shape[-1], n)).astype(np.float32)  # JAX's (K, N)
    return x, w


def test_int8_matmul_close_to_fp32():
    x, w = _operands()
    y = quant.int8_matmul_prequant(torch.from_numpy(x),
                                   *quant.quantize_weight(torch.from_numpy(w.T.copy())))
    ref = x @ w
    rel = float(np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref))
    assert 1e-5 < rel < 0.03, rel  # ~1% at K = 256, and the rounding bites


def test_int8_matmul_zero_rows_are_safe():
    y = quant.int8_matmul_prequant(torch.zeros(2, 5, 64),
                                   *quant.quantize_weight(torch.ones(32, 64)))
    assert bool((y == 0).all())


def test_int8_matmul_uses_an_integer_product(monkeypatch):
    seen = []
    plain = torch._int_mm

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        out = plain(a, b)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(torch, "_int_mm", spy)
    quant.int8_matmul_prequant(torch.randn(2, 24, 64), *quant.quantize_weight(torch.randn(32, 64)))
    assert seen == [(torch.int8, torch.int8), torch.int32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payloads_scales_and_accumulators_equal_jax(dtype):
    """quantize_weight and the per-token activation quantization give JAX's
    int8 payloads and fp32 scales bit for bit, from fp32 weights and from
    their bf16 cast (the frozen teacher's); the s8 x s8 -> s32 product
    gives JAX's int32 accumulators bit for bit; the dequantized output is
    within 1 bf16 ulp of JAX's (exactly equal in fp32)."""
    x, w = _operands(1)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jw, jx = jnp.asarray(w).astype(jdt), jnp.asarray(x).astype(jdt)
    tw, tx = torch.from_numpy(w.T.copy()).to(tdt), torch.from_numpy(x).to(tdt)
    jw_q, jw_s = jquant.quantize_weight(jw)
    tw_q, tw_s = quant.quantize_weight(tw)
    np.testing.assert_array_equal(tw_q.numpy().T, np.asarray(jw_q))
    np.testing.assert_array_equal(tw_s.numpy(), np.asarray(jw_s))
    jx_q, jx_s = jquant.quantize_weight(jnp.swapaxes(jx.reshape(-1, x.shape[-1]), 0, 1))
    tx_q, tx_s = quant._quantize(tx.float(), -1)
    np.testing.assert_array_equal(tx_q.reshape(-1, x.shape[-1]).numpy(), np.asarray(jx_q).T)
    np.testing.assert_array_equal(tx_s.reshape(-1).numpy(), np.asarray(jx_s))
    jacc = jax.lax.dot_general(jx_q.T, jw_q, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = quant.int_mm(tx_q.reshape(-1, x.shape[-1]), tw_q.t())
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    want = np.asarray(jquant.int8_matmul(jx, jw).astype(jdt).astype(jnp.float32))
    got = quant.int8_matmul_prequant(tx, tw_q, tw_s).to(tdt).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want))


def test_a_quantized_linear_keeps_nn_linear_s_state_dict():
    """dense(quantize=True) is an nn.Linear: the same parameters, so float
    weights load unchanged; prequantize_ adds buffers outside the state
    dict, and the prequantized layer gives the per-call path's output bit
    for bit (the same payloads)."""
    lin = torch.nn.Linear(32, 48)
    q = quant.dense(32, 48, quantize=True)
    q.load_state_dict(lin.state_dict())
    assert set(q.state_dict()) == set(lin.state_dict())
    x = torch.randn(3, 7, 32)
    dynamic = linear(x, q)
    rel = float((dynamic - lin(x)).norm() / lin(x).norm())
    assert 1e-5 < rel < 0.05, rel
    quant.prequantize_(q)
    assert q.weight_q.dtype == torch.int8 and q.weight_scale.dtype == torch.float32
    assert set(q.state_dict()) == set(lin.state_dict())
    torch.testing.assert_close(linear(x, q), dynamic, rtol=0, atol=0)


def test_quant_dense_output_equals_jax():
    """A QuantDense of JAX against the port's quantized Linear on the same
    fp32 weights and bias: equal bit for bit in fp32."""
    x = np.random.default_rng(2).standard_normal((3, 7, 32)).astype(np.float32)
    jd = jquant.QuantDense(48, param_dtype=jnp.float32)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jd.apply(variables, jnp.asarray(x)))
    q = quant.dense(32, 48, quantize=True)
    q.load_state_dict({"weight": torch.from_numpy(np.asarray(variables["params"]["kernel"]).T),
                       "bias": torch.from_numpy(np.asarray(variables["params"]["bias"]))})
    np.testing.assert_array_equal(linear(torch.from_numpy(x), q).detach().numpy(), want)
    assert isinstance(jd, nn.Dense)


def test_the_call_sites_are_jax_s():
    """Quantized: q/k/v/out, fc1, fc2, the teacher's post_extract_proj and
    the conformer's projections (linear_pos included) and FFN. Float, as
    prequantize_dense_kernels' ``exclude`` and the JAX modules' plain Dense
    leave them: ctc_proj, the TR fc types, the heads, the post-extract
    projection of the student."""
    _, tcfg = configs(quantize_matmuls=True, enable_tr_layer=True, tr_layer_type="fc2")
    student = StudentModel(tcfg, device="cpu")
    marked = {n for n, m in student.named_modules() if getattr(m, "quantize", False)}
    want = {f"encoder.layers.{slot}.{p}" for slot in (1, 2) for p in
            ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
             "fc1", "fc2")}
    assert marked == want
    teacher = TeacherModel(TeacherGeometry(**TEACHER, model_type="wav2vec_ctc", vocab_size=8,
                                           quantize_int8=True), device="cpu")
    marked = {n for n, m in teacher.named_modules() if getattr(m, "quantize", False)}
    assert "post_extract_proj" in marked and "ctc_proj" not in marked
    assert len(marked) == 1 + 6 * TEACHER["encoder_layers"]
    _, ccfg = configs(quantize_matmuls=True, layer_type="conformer", attn_type="espnet",
                      pos_enc_type="rel_pos", enable_tr_layer=False)
    conf = StudentModel(ccfg, device="cpu")
    marked = {n.split(".", 3)[-1] for n, m in conf.named_modules()
              if getattr(m, "quantize", False)}
    assert marked == {"ffn1.w_1", "ffn1.w_2", "ffn2.w_1", "ffn2.w_2", "self_attn.linear_q",
                      "self_attn.linear_k", "self_attn.linear_v", "self_attn.linear_out",
                      "self_attn.linear_pos"}


# ------------------------------------------------------------------ the teacher
def _teachers(dtype="float32", seed=0):
    """(JAX teacher geometry, its params, the port's state dict) at TEACHER."""
    jgeom = JGeometry(**TEACHER, use_pallas_attention=False, compute_dtype=dtype)
    wav = jnp.zeros((2, 4000), jnp.float32)
    params = JTeacher(geometry=jgeom).init(jax.random.PRNGKey(seed), wav,
                                           jnp.zeros((2, 4000), bool))
    sd = jax_teacher_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params["params"]),
                                          TeacherGeometry(**TEACHER))
    return jgeom, params, sd


def _teacher_batch():
    rng = np.random.default_rng(2)
    wav = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    mask = np.zeros(wav.shape, bool)
    mask[1, 2000:] = True
    return wav, mask


def _port_teacher(sd, dtype="float32", q=False, frozen=True):
    t = TeacherModel(TeacherGeometry(**TEACHER, compute_dtype=dtype, quantize_int8=q),
                     device="cpu")
    t.load_state_dict(sd)
    return t.freeze() if frozen else t


def _hiddens(out):
    return [out.x, out.features] + [h for (h, _, _) in out.layer_results]


def _assert_int8_like_jax(got, want, flt):
    """``got`` (the port's int8 output) is JAX's int8 output ``want``, not the
    float output ``flt``: its distance from JAX's is at most a quarter of its
    distance from the float output. Not closer: a payload that sits on a
    rounding tie flips with the last bit of its activation and moves the
    later frames of its row by an int8 step (one such flip in the expert's
    test moves 12% of the int8 effect's norm)."""
    ratio = np.linalg.norm(got - want) / np.linalg.norm(got - flt)
    assert ratio <= 0.25, ratio


def _valid(a, mask):
    """The frames of (B, T, D) that are not padding ((B, T') mask, T a
    multiple of T'): only they reach a loss or a served feature. A padded
    frame holds the same vector in every position, whose int8 payload sits
    on rounding ties, so its last bit decides the payload there."""
    mask = np.asarray(mask)
    return np.asarray(a)[~np.repeat(mask, a.shape[1] // mask.shape[1], axis=1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_teacher_matches_jax_and_stays_close_to_float(dtype):
    """teacher.quantize_int8 flips the call sites only: the state dict is
    the float teacher's; its outputs keep cosine > 0.99 against the float
    teacher (tests/test_quant.py's bound) and agree with the JAX int8
    teacher, whose params are prepared as the JAX Distiller prepares them
    (the bf16 cast, then quantized once): in fp32 on the valid frames as
    ``_assert_int8_like_jax`` holds them, in bf16 within BF16_FACTOR times the JAX int8
    teacher's own bf16 error against its fp32 run, as the bf16 forwards
    are compared in tests/test_torch_student.py."""
    from fithubert_tpu.train.step import Distiller as JDistiller

    wav, mask = _teacher_batch()
    want = {}
    for dt in ("float32", dtype):
        jgeom, params, sd = _teachers(dt)
        qgeom = dataclasses.replace(jgeom, quantize_int8=True)
        prep = JDistiller.__new__(JDistiller)
        prep.teacher_geometry = qgeom
        want[dt] = JTeacher(geometry=qgeom).apply(prep.prepare_teacher_params(params),
                                                  jnp.asarray(wav), jnp.asarray(mask))
    flt = _port_teacher(sd, dtype)(torch.from_numpy(wav), torch.from_numpy(mask))
    q = _port_teacher(sd, dtype, q=True)
    assert all(m.weight_q.dtype == torch.int8 for m in q.modules()
               if getattr(m, "quantize", False))
    got = q(torch.from_numpy(wav), torch.from_numpy(mask))
    pm = got.padding_mask.numpy()
    for g, f, w, w32 in zip(*(map(_np, _hiddens(o)) for o in (got, flt, want[dtype],
                                                                want["float32"]))):
        g, f, w, w32 = (_valid(a, pm) for a in (g, f, w, w32))
        assert _cosine(g, f) > 0.99
        assert not np.allclose(g, f)  # the int8 path engaged
        if dtype == "float32":
            _assert_int8_like_jax(g, w, f)
        else:
            assert np.abs(g - w).max() <= BF16_FACTOR * np.abs(w - w32).max()


def test_freeze_prequantizes_the_cast_weights_as_jax_prepares_them():
    """With bf16 compute the teacher's payloads come from the bf16-cast
    weights: equal to the int8 leaves and scales of the JAX Distiller's
    prepare_teacher_params, leaf for leaf."""
    from fithubert_tpu.train.step import Distiller as JDistiller

    jgeom, params, sd = _teachers("bfloat16")
    prep = JDistiller.__new__(JDistiller)
    prep.teacher_geometry = dataclasses.replace(jgeom, quantize_int8=True)
    prepared = prep.prepare_teacher_params(params)["params"]
    t = _port_teacher(sd, "bfloat16", q=True)
    lyr = prepared["encoder"]["layers_1"]
    for name, leaf in (("post_extract_proj", prepared["post_extract_proj"]),
                       ("encoder.layers.1.fc1", lyr["fc1"]),
                       ("encoder.layers.1.self_attn.v_proj", lyr["self_attn"]["v_proj"])):
        mod = t.get_submodule(name)
        np.testing.assert_array_equal(mod.weight_q.numpy().T, np.asarray(leaf["kernel"]))
        np.testing.assert_array_equal(mod.weight_scale.numpy(), np.asarray(leaf["kernel_scale"]))


# ------------------------------------------------------------------ the Distiller
def test_distiller_with_an_int8_teacher_takes_jax_s_int8_targets():
    """A Distiller built from a config with teacher.quantize_int8 (the
    geometry given without the flag, as a checkpoint's comes) distils from
    an int8 teacher: its targets (the teacher's layer hiddens on the step's
    batch) are the JAX Distiller's int8 teacher's on the valid frames
    (``_assert_int8_like_jax``), and its step's loss and
    grad_norm equal the JAX int8 step's to LOSS_TOL."""
    from fithubert_tpu.parallel import make_mesh
    from fithubert_tpu.train.step import Distiller as JDistiller
    from fithubert_tpu_torch.train.step import Distiller
    from tests.test_torch_train_step import (
        LOSS_TOL,
        N_TRAIN_STEPS,
        RAND,
        _batches,
        _configs,
    )
    from tests.test_torch_train_step import TEACHER as STEP_TEACHER

    jexp, texp = _configs()
    on = dict(quantize_int8=True)
    jexp = dataclasses.replace(jexp, teacher=dataclasses.replace(jexp.teacher, **on))
    texp_q = dataclasses.replace(texp, teacher=dataclasses.replace(texp.teacher, **on))
    jgeom = JGeometry(**STEP_TEACHER, use_pallas_attention=False, quantize_int8=True)
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=N_TRAIN_STEPS,
                    teacher_geometry=jgeom)
    wav0 = jnp.zeros((2, 2000), jnp.float32)
    tp = jd.init_teacher_params(jax.random.PRNGKey(0), wav0)
    state = jd.init_state(jax.random.PRNGKey(1), wav0)
    t_sd = jax_teacher_params_to_state_dict(tp["params"], TeacherGeometry(**STEP_TEACHER))
    s_sd = jax_student_params_to_state_dict(jax.device_get(state.params), texp.distiller)
    batch_ = _batches(1)[0]
    x, m = batch_["x"][0], batch_["padding_mask"][0]
    prepared = jd.prepare_teacher_params(tp)
    want_t = jd.teacher.apply(prepared, jnp.asarray(x), jnp.asarray(m))
    _, jl = jd.make_train_step()(state, prepared, jax.tree_util.tree_map(jnp.asarray, batch_),
                                 jnp.asarray(RAND, jnp.int32), jax.random.PRNGKey(2))
    targets, got = {}, None
    for name, exp in (("float", texp), ("int8", texp_q)):
        d = Distiller(exp, t_sd, s_sd, device="cpu", num_training_steps=N_TRAIN_STEPS,
                      teacher_geometry=TeacherGeometry(**STEP_TEACHER))
        assert d.teacher.geometry.quantize_int8 == (name == "int8")
        out = d.teacher(torch.from_numpy(x), torch.from_numpy(m))
        targets[name] = [_valid(_np(h), out.padding_mask.numpy())
                         for h in _hiddens(out)[2:]]
        got = d.train_step(batch_, RAND)
    pm = np.asarray(want_t.padding_mask)
    for q, f, w in zip(targets["int8"], targets["float"],
                       (_valid(_np(h), pm) for h in _hiddens(want_t)[2:])):
        _assert_int8_like_jax(q, w, f)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(jl[k]), err_msg=k, **LOSS_TOL)


def test_student_quantize_matmuls_is_refused_for_training():
    from fithubert_tpu_torch.train.step import Distiller
    from tests.test_torch_train_step import _configs

    _, texp = _configs()
    texp = dataclasses.replace(texp, distiller=dataclasses.replace(texp.distiller,
                                                                   quantize_matmuls=True))
    with pytest.raises(ValueError, match="quantize_matmuls"):
        Distiller(texp, {}, {}, device="cpu")


# ------------------------------------------------------------------ serving
def test_int8_upstream_expert_matches_the_jax_int8_expert(tmp_path):
    """UpstreamExpert(int8=True) on the JAX export pair's weights: within
    cosine 0.99 of the float expert, not equal to it, and on the valid
    frames the JAX expert's with int8=True (fp32 compute,
    ``_assert_int8_like_jax``), on ragged waveforms."""
    from fithubert_tpu.config import ExperimentConfig
    from fithubert_tpu.export.expert import UpstreamExpert as JExpert
    from fithubert_tpu.train.checkpoint import export_student
    from fithubert_tpu_torch.export.expert import UpstreamExpert

    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=5)
    yaml_path, weights_path = export_student(ExperimentConfig(distiller=jcfg), params,
                                             str(tmp_path), tag="student")
    pt = str(tmp_path / "student.pt")
    torch.save(jax_student_params_to_state_dict(params, tcfg), pt)
    rng = np.random.default_rng(6)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 4321, 1700)]
    want = JExpert(weights_path, yaml_path, length_quantum=1600, int8=True)(wavs)
    flt = UpstreamExpert(pt, yaml_path, device="cpu", length_quantum=1600)(wavs)
    got = UpstreamExpert(pt, yaml_path, device="cpu", length_quantum=1600, int8=True)(wavs)
    pm = got["padding_mask"].numpy()
    np.testing.assert_array_equal(pm, want["padding_mask"])
    for g, f, w in zip((got["last_hidden_state"], *got["hidden_states"]),
                       (flt["last_hidden_state"], *flt["hidden_states"]),
                       (want["last_hidden_state"], *want["hidden_states"])):
        g, f, w = (_valid(a, pm) for a in (_np(g), _np(f), np.asarray(w)))
        assert _cosine(g, f) > 0.99 and not np.allclose(g, f)
        _assert_int8_like_jax(g, w, f)


@pytest.mark.parametrize("pos_enc_type", ["rel_pos", "rope"])
def test_conformer_quantize_engages(pos_enc_type):
    """quantize_matmuls reaches the conformer's attention and FFN: the
    quantized student stays within cosine 0.98 of the float one
    (tests/test_quant.py's bound), differs from it, and agrees with the JAX
    quantized student."""
    over = dict(layer_type="conformer", attn_type="espnet", pos_enc_type=pos_enc_type,
                enable_tr_layer=False, depthwise_conv_kernel_size=7)
    jcfg, tcfg = configs(**over)
    wav, mask = batch()
    variables = JStudent(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 4000)),
                                    jnp.zeros((1, 4000), bool))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    jq = dataclasses.replace(jcfg, quantize_matmuls=True)
    want = jax.jit(lambda v, w, m: JStudent(jq).apply(v, w, m))(
        variables, jnp.asarray(wav), jnp.asarray(mask))
    sd = jax_student_params_to_state_dict(params, tcfg, stats)
    outs = {}
    for q in (False, True):
        m = StudentModel(dataclasses.replace(tcfg, quantize_matmuls=q), device="cpu")
        m.load_state_dict(sd)
        outs[q] = _np(m(torch.from_numpy(wav), torch.from_numpy(mask)).x)[:2]
    w = _np(want.x)[:2]
    assert _cosine(outs[True], outs[False]) > 0.98
    assert not np.allclose(outs[True], outs[False])
    _assert_int8_like_jax(outs[True], w, outs[False])


def test_int_mm_refuses_shapes_the_card_cannot_take():
    """On the card a product of 16 rows or fewer, or K or N not a multiple
    of 8, raises (no fallback). The CPU has no such limit."""
    a, b = torch.ones(8, 12, dtype=torch.int8), torch.ones(12, 24, dtype=torch.int8)
    assert quant.int_mm(a, b).shape == (8, 24)

    class CardTensor(torch.Tensor):
        is_cuda = True

    with pytest.raises(ValueError, match="16 rows"):
        quant.int_mm(a.as_subclass(CardTensor), b)
