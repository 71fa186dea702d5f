"""Weight exchange and configuration of the PyTorch port against the JAX
package: the state-dict round trip through the JAX package's own importer,
the .pt path, the FitHuBERT-960h preset, spec parsing, and full-width
parameter shapes."""

import dataclasses
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import StudentConfig as JStudentConfig
from fithubert_tpu.config import conv_spec_tuple as j_conv_spec_tuple
from fithubert_tpu.config import load_yaml_config as j_load_yaml
from fithubert_tpu.config import parse_spec as j_parse_spec
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu_torch import config as tconfig
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.export.jax_params import jax_student_params_to_state_dict
from fithubert_tpu_torch.models.student import StudentModel
from tests.test_torch_student import configs, jax_params

torch.set_num_threads(2)

YAML = "configs/fithubert.yaml"


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_state_dict_round_trip_through_map_student_state_dict():
    """JAX tree -> port state dict -> the JAX package's importer -> the
    original tree, leaf for leaf."""
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    sd = jax_student_params_to_state_dict(params, tcfg)
    StudentModel(tcfg, device="cpu").load_state_dict(sd, strict=True)
    back = _leaves(map_student_state_dict(sd, jcfg))
    want = _leaves(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_pt_file_loads_with_plain_torch_load(tmp_path):
    """A .pt state dict serves through UpstreamExpert via
    torch.load(weights_only=True), identically to the in-memory dict."""
    jcfg, tcfg = configs()
    sd = jax_student_params_to_state_dict(jax_params(jcfg, seed=1), tcfg)
    path = str(tmp_path / "student.pt")
    torch.save(sd, path)
    wavs = [np.random.default_rng(0).standard_normal(n).astype(np.float32) for n in (2000, 900)]
    a = UpstreamExpert(path, tcfg, device="cpu", length_quantum=800)(wavs)
    b = UpstreamExpert(sd, tcfg, device="cpu", length_quantum=800)(wavs)
    torch.testing.assert_close(a["last_hidden_state"], b["last_hidden_state"], rtol=0, atol=0)
    # only the last projection head is kept
    kept = [k for k in UpstreamExpert(sd, tcfg, device="cpu").model.state_dict()
            if k.startswith("proj_head.")]
    assert kept and all(k.startswith(f"proj_head.{tcfg.encoder_layers - 1}.") for k in kept)


def test_fithubert_960h_equals_yaml_distiller_field_by_field():
    port = tconfig.fithubert_960h()
    ref = j_load_yaml(YAML).distiller
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.embed == ref.embed and port.downsample_rate == ref.downsample_rate == 320


def test_port_yaml_loader_matches_preset():
    assert tconfig.load_yaml_config(YAML) == tconfig.fithubert_960h()


@pytest.mark.parametrize("spec", [
    "[(128, 10, 5)] + [(256, 1, 1)] + [(256, 3, 2)] * 4",
    "[(512,10,5)] + [(512,3,2)]*4 + [(512,2,2)]*2",
    "[11]", "None", "", [[64, 2, 2]],
])
def test_spec_parsing_matches_jax(spec):
    assert tconfig.parse_spec(spec) == j_parse_spec(spec)
    if spec not in ("[11]",):
        assert tconfig.conv_spec_tuple(spec) == j_conv_spec_tuple(spec)


@pytest.mark.parametrize("bad", ["__import__('os')", "[(1, 2)]", "'a'"])
def test_spec_parsing_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        j_conv_spec_tuple(bad)
    with pytest.raises(ValueError):
        tconfig.conv_spec_tuple(bad)


def test_unsupported_options_raise():
    for over in (dict(conv_bias=True), dict(tr_layer_type="fc3"),
                 dict(extractor_mode="layer_norm"), dict(pos_conv_depth=2)):
        cfg = dataclasses.replace(tconfig.fithubert_960h(), **over)
        with pytest.raises(NotImplementedError):
            StudentModel(cfg, device="cpu")


def test_full_width_parameter_shapes_equal_jax():
    """Every JAX leaf of the release student (from jax.eval_shape of its init,
    no compute) has the shape that the port's parameter maps to."""
    jcfg = j_load_yaml(YAML).distiller
    shapes = jax.eval_shape(
        JStudent(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 16000)),
        jnp.zeros((1, 16000), bool))["params"]
    model = StudentModel(tconfig.fithubert_960h(), device="cpu")
    mapped = map_student_state_dict(model.state_dict(), jcfg)
    want = {k: tuple(v.shape) for k, v in
            ((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(shapes))}
    got = {k: v.shape for k, v in _leaves(mapped).items()}
    assert got == want
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == sum(int(np.prod(s)) for s in want.values())


def test_fithubert_960h_experiment_equals_yaml_field_by_field():
    """Every field of the port's experiment preset equals the JAX package's
    load of configs/fithubert.yaml (the port keeps a subset of each section)."""
    port = tconfig.fithubert_960h_experiment()
    ref = j_load_yaml(YAML)
    for section in ("teacher", "train", "loss", "distiller", "optimizer"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), f"{section}.{f.name}"


def test_expert_from_pt_and_yaml_matches_the_jax_expert(tmp_path):
    """UpstreamExpert(ckpt, model_config) in the reference's order: the JAX
    package's export pair (yaml + msgpack) serves through the JAX expert, the
    same weights as a .pt state dict with the same yaml through the port, on
    ragged waveforms. fp32, summation order only: 1e-4 (F32_TOL of
    tests/test_torch_student.py)."""
    from fithubert_tpu.config import ExperimentConfig
    from fithubert_tpu.export.expert import UpstreamExpert as JExpert
    from fithubert_tpu.train.checkpoint import export_student

    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=5)
    yaml_path, weights_path = export_student(ExperimentConfig(distiller=jcfg), params,
                                             str(tmp_path), tag="student")
    pt_path = str(tmp_path / "student.pt")
    torch.save(jax_student_params_to_state_dict(params, tcfg), pt_path)
    rng = np.random.default_rng(6)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 4321, 1700)]
    want = JExpert(weights_path, yaml_path, length_quantum=1600)(wavs)
    got = UpstreamExpert(pt_path, yaml_path, device="cpu", length_quantum=1600)(wavs)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), want["padding_mask"])
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), want["last_hidden_state"],
                               atol=1e-4, rtol=1e-4)
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == jcfg.encoder_layers
    for h, jh in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(h.numpy(), jh, atol=1e-4, rtol=1e-4)


def test_expert_accepts_and_ignores_hub_arguments():
    """s3prl's hub hook passes its own arguments through (hubconf.py:8-12)."""
    jcfg, tcfg = configs()
    sd = jax_student_params_to_state_dict(jax_params(jcfg, seed=1), tcfg)
    wavs = [np.random.default_rng(0).standard_normal(1200).astype(np.float32)]
    plain = UpstreamExpert(sd, tcfg, device="cpu", length_quantum=800)(wavs)
    hub = UpstreamExpert(sd, tcfg, "extra", device="cpu", length_quantum=800, refresh=True)(wavs)
    torch.testing.assert_close(hub["last_hidden_state"], plain["last_hidden_state"],
                               rtol=0, atol=0)


def _lightning_pair(tmp_path, distiller_over):
    """A Lightning-shaped .ckpt of the small student and a YAML whose
    distiller section is the student's with ``distiller_over``."""
    _jcfg, tcfg = configs()
    sd = jax_student_params_to_state_dict(jax_params(_jcfg, seed=1), tcfg)
    ckpt = str(tmp_path / "FitHuBERT.ckpt")
    torch.save({"state_dict": {f"student_model.{k}": v for k, v in sd.items()}}, ckpt)
    yaml_path = str(tmp_path / "student.yaml")
    sections = tconfig.dump_config(tconfig.ExperimentConfig(distiller=tcfg), yaml_path)
    with open(yaml_path, "w") as f:
        f.write("distiller:\n" + "".join(
            f"  {k}: {json.dumps(v)}\n" for k, v in {**sections["distiller"],
                                                      **distiller_over}.items()))
    return ckpt, yaml_path


@pytest.mark.parametrize("case, match", [("lightning_ckpt", "quantize_matmuls"),
                                         ("int8", "quantize_matmuls")],
                         ids=["lightning_ckpt", "int8"])
def test_expert_refuses_what_the_port_cannot_serve(case, match, tmp_path):
    """A reference Lightning .ckpt is read (tests/test_torch_export.py); one
    whose YAML asks for int8 matmuls, which the port lacks, is refused by
    the config's own check before any weight is read. int8 serving is
    refused."""
    _jcfg, tcfg = configs()
    if case == "lightning_ckpt":
        args, kwargs = _lightning_pair(tmp_path, {"quantize_matmuls": True}), {}
    else:
        args, kwargs = ({}, tcfg), dict(int8=True)
    with pytest.raises(NotImplementedError, match=match):
        UpstreamExpert(*args, device="cpu", **kwargs)


def test_expert_serves_a_lightning_ckpt_of_a_mel_student(tmp_path):
    """The YAML that the port refused before the mel front-end was ported (a
    mel head, log-mel features) now loads with a Lightning .ckpt of a mel
    student's weights, and serves at the hop of 320 samples."""
    from fithubert_tpu.config import StudentConfig as J

    mel = {"n_mels": 40, "enable_log_mel": True, "mel_spec_head_conv_layers": "[(24, 5, 1)]",
           "conv_feature_layers": "None"}
    _, yaml_path = _lightning_pair(tmp_path, mel)
    cfg = tconfig.load_yaml_config(yaml_path)
    assert (cfg.n_mels, cfg.enable_log_mel, cfg.mel_spec_head_conv_layers) == \
        (40, True, ((24, 5, 1),))
    assert cfg.embed == J(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)}).embed == 24
    sd = StudentModel(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))\
        .state_dict()
    ckpt = str(tmp_path / "FitHuBERT-mel.ckpt")
    torch.save({"state_dict": {f"student_model.{k}": v for k, v in sd.items()}}, ckpt)
    expert = UpstreamExpert(ckpt, yaml_path, device="cpu", length_quantum=800)
    out = expert([np.random.default_rng(0).standard_normal(3000).astype(np.float32)])
    assert expert.get_downsample_rates() == 320
    frames = 1 + (3200 - 400) // 320  # the mel frames, before the student's TR
    assert out["hidden_states"][0].shape[1] == frames // cfg.tr_reduce_factor
    assert torch.isfinite(out["last_hidden_state"]).all()


@pytest.mark.parametrize("field, value", [("quantize_matmuls", True)])
def test_from_dict_refuses_fields_the_port_lacks(field, value):
    """A field the port has no counterpart for, set away from its JAX
    default, raises and names itself; at the default it loads."""
    import yaml

    with open(YAML) as f:
        section = yaml.safe_load(f)["distiller"]
    name = field.lstrip("_")
    assert tconfig.StudentConfig.from_dict({**section, field: tconfig.REFUSED[name]}) \
        == tconfig.StudentConfig.from_dict(section)
    with pytest.raises(NotImplementedError, match=name):
        tconfig.StudentConfig.from_dict({**section, field: value})


@pytest.mark.parametrize("field, value", [
    ("n_mels", 80), ("enable_log_mel", True),
    ("mel_spec_head_conv_layers", "[(64, 3, 1)] * 2"), ("layer_type", "conformer"),
    ("depthwise_conv_kernel_size", 15), ("attn_type", "espnet"), ("pos_enc_type", "rope"),
])
def test_from_dict_reads_the_mel_and_conformer_fields(field, value):
    """The mel front-end's and the conformer's fields, which the port once
    refused or dropped, are read as the JAX StudentConfig.from_dict reads
    them, and change the config."""
    import yaml

    with open(YAML) as f:
        section = yaml.safe_load(f)["distiller"]
    port = tconfig.StudentConfig.from_dict({**section, field: value})
    ref = JStudentConfig.from_dict({**section, field: value})
    assert getattr(port, field) == getattr(ref, field)
    assert port != tconfig.StudentConfig.from_dict(section)
    assert (port.embed, port.downsample_rate) == (ref.embed, ref.downsample_rate)


@pytest.mark.parametrize("field, value", [
    ("init_conv_layers", True), ("init_encoder_layers", 2), ("teacher_task_agnostic", False),
    ("_teacher_task_agnostic", False), ("pred_head_inter_dim", 64),
])
def test_from_dict_reads_the_hint_init_and_task_fields(field, value):
    """The teacher hint-init, a task-specific teacher and the SplitLinear
    head's inner width are read as the JAX StudentConfig.from_dict reads
    them (the reference's private name included)."""
    import yaml

    with open(YAML) as f:
        section = yaml.safe_load(f)["distiller"]
    port = tconfig.StudentConfig.from_dict({**section, field: value})
    ref = JStudentConfig.from_dict({**section, field: value})
    name = field.lstrip("_")
    assert getattr(port, name) == getattr(ref, name) == value


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.yaml")))
def test_every_config_loads_to_the_jax_loaders_values(path):
    """Each file of configs/ loads for serving (ex.yaml's teacher-init flags
    are turned off, as the JAX expert does), and every field the port keeps
    equals the JAX loader's."""
    port = tconfig.load_yaml_config(path)
    # the JAX expert's replace (fithubert_tpu/export/expert.py:57-65)
    ref = dataclasses.replace(j_load_yaml(path).distiller, init_conv_layers=False,
                              init_encoder_layers=0)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
