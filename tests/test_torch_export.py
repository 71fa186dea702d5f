"""The rest of the port's export against the JAX package: the reference's
Lightning .ckpt (synthesised from a tiny seeded student: student_model.*
and teacher_model.* weights, the trainer's state and an object of a class
whose module is not installed) served by the port's UpstreamExpert and by
the JAX expert, the same weights as a .pt, the torch.hub entry of
fithubert_tpu_torch/hubconf.py, and the port's extract_features against
scripts/extract_features.py on tiny FLACs."""

import os
import pickle
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from fithubert_tpu.export.expert import UpstreamExpert as JExpert
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export import extract_features as ef
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.export.jax_params import jax_student_params_to_state_dict
from fithubert_tpu_torch.export.reference_import import (
    load_reference_student,
    reference_student_state_dict,
)
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from tests.flac_writer import write_flac
from tests.test_torch_student import configs, jax_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "fithubert_tpu_torch")
F32_TOL = dict(atol=1e-4, rtol=1e-4)  # test_expert_from_pt_and_yaml_matches_the_jax_expert
TEACHER = dict(conv_feature_layers=((32, 10, 5), (48, 3, 2)), encoder_layers=2,
               encoder_embed_dim=48, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
               conv_pos=16, conv_pos_groups=4)
LIGHTNING_MODULE = "pytorch_lightning.callbacks.model_checkpoint"


def write_lightning_ckpt(path, student_sd, teacher_sd):
    """A .ckpt shaped as Lightning saves the reference's distiller: the
    weights under state_dict with the module prefixes, the trainer's state,
    and a ModelCheckpoint object of a module that is not installed here (it
    exists only while the file is written)."""
    names = LIGHTNING_MODULE.split(".")
    mods = {".".join(names[:i + 1]): types.ModuleType(".".join(names[:i + 1]))
            for i in range(len(names))}
    cls = type("ModelCheckpoint", (), {"__module__": LIGHTNING_MODULE})
    mods[LIGHTNING_MODULE].ModelCheckpoint = cls
    callback = cls()
    callback.best_model_path, callback.monitor = "epoch=7.ckpt", "v_loss"
    sd = {**{f"student_model.{k}": v for k, v in student_sd.items()},
          **{f"teacher_model.{k}": v for k, v in teacher_sd.items()}}
    assert not set(mods) & set(sys.modules)
    sys.modules.update(mods)
    try:
        torch.save({"epoch": 7, "global_step": 812, "pytorch-lightning_version": "1.5.10",
                    "state_dict": sd, "callbacks": {"ModelCheckpoint": callback},
                    "optimizer_states": [{"state": {0: {"step": torch.tensor(812.0)}},
                                          "param_groups": [{"lr": 5e-4, "params": [0]}]}],
                    "lr_schedulers": [{"last_epoch": 812}]}, path)
    finally:
        for name in mods:
            del sys.modules[name]


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(directory, .ckpt, .pt, yaml, port StudentConfig, state dict) of a
    tiny fp32 student with every leaf perturbed."""
    d = tmp_path_factory.mktemp("release")
    jcfg, tcfg = configs()
    sd = jax_student_params_to_state_dict(jax_params(jcfg, seed=3), tcfg)
    teacher = TeacherModel(TeacherGeometry(**TEACHER), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    ckpt, pt, yaml_path = (str(d / n) for n in ("FitHuBERT.ckpt", "student.pt", "student.yaml"))
    write_lightning_ckpt(ckpt, sd, teacher.state_dict())
    torch.save(sd, pt)
    tc.dump_config(tc.ExperimentConfig(distiller=tcfg), yaml_path)
    return d, ckpt, pt, yaml_path, tcfg, sd


def _wavs(seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 4321, 1700)]


def test_the_ckpt_holds_an_object_of_a_module_that_is_not_installed(release):
    _, ckpt, *_ = release
    with pytest.raises((ModuleNotFoundError, pickle.UnpicklingError)):
        torch.load(ckpt, map_location="cpu", weights_only=False)


def test_expert_on_a_lightning_ckpt_matches_the_jax_expert(release):
    """The same .ckpt and YAML through the JAX expert (its importer maps the
    reference's keys) and the port's (the prefix stripped), ragged
    waveforms, fp32: summation order only."""
    _, ckpt, _, yaml_path, tcfg, _ = release
    want = JExpert(ckpt, yaml_path, length_quantum=1600)(_wavs())
    got = UpstreamExpert(ckpt, yaml_path, device="cpu", length_quantum=1600)(_wavs())
    np.testing.assert_array_equal(got["padding_mask"].numpy(), want["padding_mask"])
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), want["last_hidden_state"],
                               **F32_TOL)
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == tcfg.encoder_layers
    for h, jh in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(h.numpy(), jh, **F32_TOL)


def test_ckpt_and_pt_of_the_same_weights_give_equal_features(release):
    _, ckpt, pt, yaml_path, tcfg, sd = release
    a = UpstreamExpert(ckpt, yaml_path, device="cpu", length_quantum=1600)(_wavs())
    b = UpstreamExpert(pt, tcfg, device="cpu", length_quantum=1600)(_wavs())
    for x, y in zip((a["last_hidden_state"], *a["hidden_states"], a["padding_mask"]),
                    (b["last_hidden_state"], *b["hidden_states"], b["padding_mask"])):
        assert torch.equal(x, y)


def test_load_reference_student_strips_the_prefix_and_reads_the_experiment(release):
    _, ckpt, _, yaml_path, tcfg, sd = release
    cfg, got = load_reference_student(ckpt, yaml_path)
    assert cfg.distiller == tcfg
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    assert reference_student_state_dict(ckpt).keys() == sd.keys()


def test_a_ckpt_without_student_weights_or_with_a_missing_key_is_refused(release, tmp_path):
    """No quiet random init: a .ckpt with no student_model.* weights raises,
    and one that lacks a weight of the model fails the strict load."""
    _, _, _, yaml_path, tcfg, sd = release
    empty = str(tmp_path / "teacher_only.ckpt")
    torch.save({"state_dict": {"teacher_model.w": torch.zeros(1)}}, empty)
    with pytest.raises(KeyError, match="student_model"):
        UpstreamExpert(empty, yaml_path, device="cpu")
    short = str(tmp_path / "short.ckpt")
    torch.save({"state_dict": {f"student_model.{k}": v for k, v in sd.items()
                               if not k.startswith("encoder.layers.1.")}}, short)
    with pytest.raises(RuntimeError, match="Missing key"):
        UpstreamExpert(short, yaml_path, device="cpu")


def test_torch_hub_load_returns_the_same_expert(release):
    """torch.hub.load on the port's package directory, source="local": both
    entries, the s3prl hook's positional arguments, bit-equal features."""
    _, ckpt, _, yaml_path, _, _ = release
    want = UpstreamExpert(ckpt, yaml_path, device="cpu", length_quantum=1600)(_wavs())
    for entry in ("fithubert", "fithubert_local"):
        hub = torch.hub.load(PKG_DIR, entry, ckpt, yaml_path, source="local", device="cpu",
                             length_quantum=1600)
        assert type(hub).__name__ == "UpstreamExpert"
        got = hub(_wavs())
        for x, y in zip((got["last_hidden_state"], *got["hidden_states"]),
                        (want["last_hidden_state"], *want["hidden_states"])):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="required"):
        torch.hub.load(PKG_DIR, "fithubert", ckpt, "", source="local", device="cpu")


@pytest.fixture(scope="module")
def flacs(tmp_path_factory):
    """Five tiny FLACs in two directories, two of them sharing a file name."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(4)
    paths = []
    for i, (sub, name, n) in enumerate([("a", "1-2-0000", 5200), ("a", "1-2-0001", 2100),
                                        ("b", "1-2-0000", 3900), ("b", "7-7-0003", 7300),
                                        ("b", "7-7-0004", 1200)]):
        (root / sub).mkdir(exist_ok=True)
        sig = np.round(3000 * np.sin(np.arange(n) * 0.02 * (i + 1))
                       + 200 * rng.standard_normal(n)).astype(np.int64)
        paths.append(str(root / sub / f"{name}.flac"))
        write_flac(paths[-1], [sig], kind="fixed1" if i % 2 else "verbatim")
    return paths


@pytest.mark.parametrize("layer", [-1, 1])
def test_extract_features_matches_the_jax_script(release, flacs, tmp_path, monkeypatch, layer):
    """The same .ckpt, YAML and FLACs through scripts/extract_features.py
    and the port's module, batches of 2: the same file names (the repeated
    base name gets '.1'), frame counts and values to F32_TOL."""
    _, ckpt, _, yaml_path, _, _ = release
    common = ["--ckpt", ckpt, "--config", yaml_path, "--inputs", *flacs, "--batch-size", "2",
              "--layer", str(layer)]
    monkeypatch.setattr(sys, "argv", ["extract_features.py", *common,
                                      "--out", str(tmp_path / "jax")])
    runpy.run_path(os.path.join(ROOT, "scripts", "extract_features.py"), run_name="__main__")
    frames = ef.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == sorted(f"{n}.npy" for n in frames)
    assert "1-2-0000.1.npy" in names and len(names) == len(flacs)
    for name in names:
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.shape == want.shape and got.shape[0] == frames[name[:-4]], name
        np.testing.assert_allclose(got, want, err_msg=name, **F32_TOL)


def test_extract_features_refuses_int8_and_writes_nothing(release, flacs, tmp_path):
    """--int8, once refused, serves with int8 matmuls
    (UpstreamExpert(int8=True), held against the JAX int8 expert in
    tests/test_torch_quant.py): the same files and frame counts as the
    float run, each within cosine 0.99 of its float features (the bound of
    tests/test_quant.py) and not equal to them."""
    _, ckpt, _, yaml_path, _, _ = release
    common = ["--ckpt", ckpt, "--config", yaml_path, "--inputs", *flacs[:2], "--device", "cpu"]
    q = ef.main([*common, "--out", str(tmp_path / "int8"), "--int8"])
    f = ef.main([*common, "--out", str(tmp_path / "float")])
    assert q == f
    for name in q:
        a = np.load(tmp_path / "int8" / f"{name}.npy").astype(np.float64).ravel()
        b = np.load(tmp_path / "float" / f"{name}.npy").astype(np.float64).ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99, name
        assert not np.allclose(a, b), name


def test_output_names_are_unique_in_input_order():
    assert ef.output_names(["x/a.flac", "y/a.wav", "z/b.flac", "w/a.flac"]) == {
        "x/a.flac": "a", "y/a.wav": "a.1", "z/b.flac": "b", "w/a.flac": "a.2"}


def test_the_exported_experiment_round_trips_through_the_ckpt_reader(release, tmp_path):
    """A run's config.yaml (every section) beside a .ckpt: the experiment
    that load_reference_student returns is the one dumped."""
    _, ckpt, _, _, tcfg, _ = release
    exp = tc.load_experiment_yaml(os.path.join(ROOT, "configs", "smoke.yaml"))
    path = str(tmp_path / "config.yaml")
    tc.dump_config(exp, path)
    assert load_reference_student(ckpt, path)[0] == exp
