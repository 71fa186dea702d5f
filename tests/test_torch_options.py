"""The encoder and extractor options of the port against the JAX package
on carried weights (``export/jax_params.py``): every FFN activation, the
multi-layer positional conv, the extractor's ``layer_norm`` mode and conv
bias, an extractor block with k > 2s, a wav2vec2-Large-shaped fairseq
teacher (``layer_norm`` extractor with conv bias, pre-LN) read by both
importers, a train step of a student with the options on, and the
configuration: a ``distiller:`` key that the JAX package does not know
raises in both, and the port refuses only what the JAX package refuses.

Tolerances: fp32 is summation order only (``F32_TOL`` of
tests/test_torch_student.py); bf16 is held against fp32 as there
(``BF16_FACTOR``); the train step as tests/test_torch_train_step.py
(``LOSS_TOL``, ``PARAM_TOL``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.config import config_from_yaml_dict as j_config_from_yaml_dict
from fithubert_tpu.export.fairseq_import import load_fairseq_teacher as j_load_fairseq
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models.teacher import TeacherModel as JTeacher
from fithubert_tpu.ops.transformer import ACTIVATIONS as J_ACTIVATIONS
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.fairseq_import import load_fairseq_teacher
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.activations import ACTIVATIONS
from tests.test_torch_student import (
    BF16_FACTOR,
    F32_TOL,
    batch,
    configs,
    jax_params,
    outputs,
    run_both,
)

torch.set_num_threads(2)

# the options together, as chip_smoke.py's [options] phase runs them
OPTIONS = dict(extractor_mode="layer_norm", conv_bias=True, pos_conv_depth=3,
               activation_fn="gelu_fast")
# an extractor whose block 1 has k > 2s: K1 cannot take it, JAX's unfused loop does
WIDE_K_SPEC = ((32, 10, 5), (32, 5, 2), (48, 3, 2), (64, 2, 2))
CASES = {
    **{f"activation_{a}": dict(activation_fn=a) for a in sorted(J_ACTIVATIONS)},
    "pos_conv_depth_2": dict(pos_conv_depth=2),
    "pos_conv_depth_3": dict(pos_conv_depth=3),
    "default_bias": dict(conv_bias=True),
    "layer_norm": dict(extractor_mode="layer_norm"),
    "layer_norm_bias": dict(extractor_mode="layer_norm", conv_bias=True),
    "k_over_2s": dict(conv_feature_layers=WIDE_K_SPEC),
    "all_options": OPTIONS,
}


def test_the_activation_table_is_jax_s():
    assert set(ACTIVATIONS) == set(J_ACTIVATIONS)
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    for name, fn in J_ACTIVATIONS.items():
        np.testing.assert_allclose(ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
                                   np.asarray(fn(jnp.asarray(x))), atol=1e-6, rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_student_option_fp32_matches_jax(case):
    over = CASES[case]
    params = jax_params(configs(**over)[0])
    wav, mask = batch()
    want, got = run_both("float32", params, wav, mask, over)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32_TOL)


@pytest.mark.parametrize("case", ["layer_norm_bias", "pos_conv_depth_3", "all_options"])
def test_student_option_bf16_matches_jax(case):
    over = CASES[case]
    params = jax_params(configs(**over)[0])
    wav, mask = batch()
    want32, _ = run_both("float32", params, wav, mask, over)
    want, got = run_both("bfloat16", params, wav, mask, over)
    for name in want:
        ref_err = np.abs(want[name] - want32[name]).max()
        port_err = np.abs(got[name] - want[name]).max()
        assert port_err <= BF16_FACTOR * ref_err, (name, port_err, ref_err)


def test_option_state_dict_keys_are_fairseq_s():
    """fairseq's names: the conv bias at ``.0.bias``, a block's LayerNorm at
    ``.2.1``, the multi-layer positional conv's blocks at ``pos_conv.{i}.0``
    (its LayerNorms have no parameters), and no GroupNorm in layer_norm mode."""
    _, tcfg = configs(**OPTIONS)
    keys = set(StudentModel(tcfg, device="cpu").state_dict())
    n = len(tcfg.conv_feature_layers)
    for i in range(n):
        assert {f"feature_extractor.conv_layers.{i}.0.weight",
                f"feature_extractor.conv_layers.{i}.0.bias",
                f"feature_extractor.conv_layers.{i}.2.1.weight",
                f"feature_extractor.conv_layers.{i}.2.1.bias"} <= keys
    assert "feature_extractor.conv_layers.0.2.weight" not in keys
    pos = sorted(k for k in keys if k.startswith("encoder.pos_conv."))
    assert pos == sorted(f"encoder.pos_conv.{i}.0.{p}" for i in range(3)
                         for p in ("weight", "bias"))


# ------------------------------------------------------- a Large-shaped teacher
# wav2vec2-Large LV-60's layout (fairseq wav2vec2_large_librivox.yaml:
# extractor_mode layer_norm, conv_bias, layer_norm_first) at a tiny width
LARGE_TINY = dict(_name="wav2vec2", extractor_mode="layer_norm", conv_bias=True,
                  layer_norm_first=True, activation_fn="gelu", encoder_attention_heads=4,
                  conv_feature_layers="[(32, 10, 5)] + [(48, 3, 2)] * 2 + [(48, 2, 2)]")
LARGE_GEOM = TeacherGeometry(
    model_type="wav2vec2", extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True,
    conv_feature_layers=((32, 10, 5), (48, 3, 2), (48, 3, 2), (48, 2, 2)), encoder_layers=3,
    encoder_embed_dim=64, encoder_ffn_embed_dim=96, encoder_attention_heads=4, conv_pos=16,
    conv_pos_groups=4)


def _write_large_tiny(path, seed=3):
    """A fairseq-shaped wav2vec2 checkpoint of LARGE_GEOM: the port's seeded
    init under fairseq's keys, every tensor perturbed so no affine or bias
    is trivial, with the quantizer's keys that the teacher does not run."""
    sd = TeacherModel(LARGE_GEOM, device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in sd.items()}
    sd["quantizer.vars"] = torch.zeros(1, 8, 16)
    torch.save({"model": sd, "cfg": {"model": dict(LARGE_TINY)}}, path)


def _teacher_pair(path, dtype):
    geom, state = load_fairseq_teacher(path)
    jgeom, jvars = j_load_fairseq(path)
    for f in dataclasses.fields(geom):
        assert getattr(geom, f.name) == getattr(jgeom, f.name), f.name
    geom = dataclasses.replace(geom, compute_dtype=dtype)
    jgeom = dataclasses.replace(jgeom, compute_dtype=dtype, use_pallas_attention=False)
    teacher = TeacherModel(geom, device="cpu")
    teacher.load_state_dict(state, strict=True)
    return teacher, JTeacher(geometry=jgeom), jvars


def _teacher_outputs(out):
    d = {"x": out.x, "features": out.features}
    for i, (h, _, ffn) in enumerate(out.layer_results):
        d[f"hidden{i}"], d[f"ffn{i}"] = h, ffn
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          else jnp.asarray(v).astype(jnp.float32)) for k, v in d.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_shaped_fairseq_teacher_matches_jax(dtype, tmp_path):
    """Both importers read the same geometry from the checkpoint; the
    teachers agree in fp32 to summation order, and in bf16 (the port
    frozen, the JAX params prepared as the JAX Distiller prepares them) by
    BF16_FACTOR times the JAX bf16 teacher's own error against fp32."""
    from fithubert_tpu.train.step import Distiller as JDistiller

    path = str(tmp_path / "w2v2_large_tiny.pt")
    _write_large_tiny(path)
    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal((3, 2400))).astype(np.float32)
    mask = np.arange(2400)[None, :] >= np.array([2400, 1900, 1250])[:, None]
    wav[mask] = 0.0

    def run(dt):
        teacher, jteacher, jvars = _teacher_pair(path, dt)
        if dt != "float32":
            teacher.freeze()
            prep = JDistiller.__new__(JDistiller)
            prep.teacher_geometry = jteacher.geometry
            jvars = prep.prepare_teacher_params(jvars)
        want = jteacher.apply(jvars, jnp.asarray(wav), jnp.asarray(mask))
        got = teacher(torch.from_numpy(wav), torch.from_numpy(mask))
        np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
        return _teacher_outputs(want), _teacher_outputs(got)

    want32, got32 = run("float32")
    if dtype == "float32":
        for k in want32:
            np.testing.assert_allclose(got32[k], want32[k], err_msg=k, **F32_TOL)
        return
    want, got = run(dtype)
    for k in want:
        ref_err = np.abs(want[k] - want32[k]).max()
        assert np.abs(got[k] - want[k]).max() <= BF16_FACTOR * ref_err, k


# ------------------------------------------------------------------ a train step
def test_a_step_of_a_student_with_the_options_matches_jax():
    """Distiller.train_step of a student with OPTIONS (gradients through
    the unfused extractor with its LayerNorms and biases, and through the
    multi-layer positional conv) against the JAX Distiller's step, fp32,
    no dropout, on a ragged batch with a fabricated row."""
    from fithubert_tpu.models import TeacherGeometry as JGeometry
    from fithubert_tpu.parallel import make_mesh
    from fithubert_tpu.train.step import Distiller as JDistiller
    from fithubert_tpu_torch.export.jax_params import (
        jax_student_params_to_state_dict,
        jax_teacher_params_to_state_dict,
    )
    from fithubert_tpu_torch.train.step import Distiller
    from tests.test_torch_train_step import (
        LOSS_TOL,
        N_TRAIN_STEPS,
        PARAM_TOL,
        RAND,
        TEACHER,
        _batches,
        _configs,
    )

    jexp, texp = _configs()
    jexp = dataclasses.replace(jexp, distiller=dataclasses.replace(jexp.distiller, **OPTIONS))
    texp = dataclasses.replace(texp, distiller=dataclasses.replace(texp.distiller, **OPTIONS))
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=N_TRAIN_STEPS,
                    teacher_geometry=JGeometry(**TEACHER, use_pallas_attention=False))
    batch_ = _batches(1)[0]
    wav0 = jnp.zeros((2, 2000), jnp.float32)
    tp = jd.init_teacher_params(jax.random.PRNGKey(0), wav0)
    state = jd.init_state(jax.random.PRNGKey(1), wav0)
    geom = TeacherGeometry(**TEACHER)
    d = Distiller(texp, jax_teacher_params_to_state_dict(tp["params"], geom),
                  jax_student_params_to_state_dict(jax.device_get(state.params),
                                                   texp.distiller),
                  device="cpu", num_training_steps=N_TRAIN_STEPS, teacher_geometry=geom)
    new_state, jl = jd.make_train_step()(state, tp, jax.tree_util.tree_map(jnp.asarray, batch_),
                                         jnp.asarray(RAND, jnp.int32), jax.random.PRNGKey(2))
    got = d.train_step(batch_, RAND)
    for k, v in jl.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **LOSS_TOL)
    want_sd = jax_student_params_to_state_dict(jax.device_get(new_state.params), texp.distiller)
    got_sd = d.student.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), err_msg=k,
                                   **PARAM_TOL)


# ------------------------------------------------------------------- the config
def _release_distiller():
    with open("configs/fithubert.yaml") as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("key", ["encoder_layer", "dropuot", "conv_pos_group"])
def test_a_misspelt_distiller_key_raises_in_both_packages(key):
    raw = _release_distiller()
    raw["distiller"] = {**raw["distiller"], key: 6}
    with pytest.raises(ValueError, match=key):
        j_config_from_yaml_dict(raw)
    with pytest.raises(ValueError, match=key):
        tc.config_from_yaml_dict(raw)


@pytest.mark.parametrize("key, value", [("checkpoint_activations", True), ("final_dim", 64),
                                        ("fp16", False), ("max_positions", 10),
                                        ("scan_layers", True), ("tr_conv1d_kernel", 5),
                                        ("use_pallas_attention", False),
                                        ("use_pallas_conv", False)])
def test_jax_only_keys_are_read_and_change_nothing(key, value):
    """The JAX StudentConfig's fields that build no other model load in
    both packages and leave the port's config as it was."""
    raw = _release_distiller()
    changed = dict(raw, distiller={**raw["distiller"], key: value})
    j_config_from_yaml_dict(changed)
    assert tc.config_from_yaml_dict(changed) == tc.config_from_yaml_dict(raw)


@pytest.mark.parametrize("over, error", [
    (dict(tr_layer_type="fc3"), NotImplementedError),
    (dict(activation_fn="elu"), (ValueError, KeyError)),
    (dict(extractor_mode="group_norm"), (ValueError, AssertionError)),
], ids=["fc3", "activation", "extractor_mode"])
def test_the_port_refuses_only_what_jax_refuses(over, error):
    """Each of these makes the JAX StudentModel's init raise, and the
    port's StudentModel too; the options above build in both."""
    jcfg, tcfg = configs(**over)
    wav = jnp.zeros((1, 4000), jnp.float32)
    with pytest.raises(error):
        JStudent(jcfg).init(jax.random.PRNGKey(0), wav, jnp.zeros((1, 4000), bool))
    with pytest.raises(error):
        StudentModel(tcfg, device="cpu")


def test_a_jax_config_s_to_dict_loads_in_the_port():
    """The JAX StudentConfig's to_dict (every JAX field) is a distiller
    section the port reads, and the port's to_dict one the JAX package
    reads, to the same shared fields."""
    jcfg, tcfg = configs(**OPTIONS)
    port = tc.StudentConfig.from_dict(jcfg.to_dict())
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(jcfg, f.name), f.name
    back = JConfig.from_dict(tcfg.to_dict())
    for f in dataclasses.fields(tcfg):
        assert getattr(back, f.name) == getattr(tcfg, f.name), f.name
