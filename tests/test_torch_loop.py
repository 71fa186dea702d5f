"""The port's training orchestration against the JAX package: the whole
experiment config read from each file of configs/ and written back, the
checkpoint manager, and run_training on configs/smoke.yaml on the CPU
(the loss falls, a resume continues where it stopped, test mode, a SIGTERM
mid-run, the CLI), with the exported pair served by the port's expert and,
mapped onto the JAX StudentModel, by the JAX package's forward."""

import dataclasses
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fithubert_tpu.config import config_from_yaml_dict as j_config_from_yaml_dict
from fithubert_tpu.config import load_yaml_config as j_load_yaml
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.checkpoint import CheckpointManager
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

SECTIONS = ("teacher", "train", "loss", "distiller", "optimizer", "data", "specaug")
SUPPORTED = ["configs/ex.yaml", "configs/fithubert.yaml", "configs/fitwav2vec2.yaml",
             "configs/rehearsal.yaml", "configs/smoke.yaml", "configs/smoke_ctc.yaml"]


def _raw(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _assert_shared_fields_equal(port, ref):
    for section in SECTIONS:
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), f"{section}.{f.name}"


@pytest.mark.parametrize("path", SUPPORTED)
def test_config_from_yaml_dict_equals_the_jax_loader(path):
    _assert_shared_fields_equal(tc.config_from_yaml_dict(_raw(path)),
                                j_config_from_yaml_dict(_raw(path)))
    assert tc.load_experiment_yaml(path) == tc.config_from_yaml_dict(_raw(path))


@pytest.mark.parametrize("path, field", [("configs/ex.yaml", "init_conv_layers"),
                                         ("configs/smoke_ctc.yaml", "wav2vec_ctc")])
def test_unsupported_configs_raise_naming_their_field(path, field):
    """ex.yaml's teacher hint-init and smoke_ctc.yaml's wav2vec_ctc teacher
    load (the port has both), with the setting on, and so does each with
    train.specaug; each file with a setting the port still lacks
    (teacher.quantize_int8) raises, naming it."""
    cfg = tc.config_from_yaml_dict(_raw(path))
    if field == "init_conv_layers":
        assert cfg.distiller.init_conv_layers and cfg.distiller.init_encoder_layers == 2
    else:
        assert cfg.teacher.model_type == field and cfg.data.load_labels
        assert not cfg.distiller.teacher_task_agnostic
    raw = _raw(path)
    raw["train"] = {**raw["train"], "specaug": True}
    assert tc.config_from_yaml_dict(raw).train.specaug
    raw["teacher"] = {**raw["teacher"], "quantize_int8": True}
    with pytest.raises(NotImplementedError, match="teacher.quantize_int8"):
        tc.config_from_yaml_dict(raw)


def test_ex_experiment_equals_ex_yaml_and_the_jax_loader():
    """The Python factory that chip_smoke.py uses (no YAML library on the
    card's machine) is configs/ex.yaml field for field."""
    assert tc.ex_experiment() == tc.load_experiment_yaml("configs/ex.yaml")
    _assert_shared_fields_equal(tc.ex_experiment(), j_load_yaml("configs/ex.yaml"))


def test_load_labels_is_honoured():
    """data.load_labels loads (the CTC path reads transcripts), with any
    teacher, as the JAX loader reads it."""
    raw = _raw("configs/smoke.yaml")
    raw["data"] = {**raw["data"], "load_labels": True}
    cfg = tc.config_from_yaml_dict(raw)
    assert cfg.data.load_labels and cfg.distiller.teacher_task_agnostic
    _assert_shared_fields_equal(cfg, j_config_from_yaml_dict(raw))


@pytest.mark.parametrize("change, field", [
    (dict(distiller=dict(layer_type="conformer", attn_type="espnet", pos_enc_type="rel_pos",
                         enable_tr_layer=False), train=dict(gpus=2)),
     "layer_type='conformer'"),
    (dict(teacher=dict(quantize_int8=True)), "teacher.quantize_int8"),
])
def test_settings_the_loop_cannot_honour_raise(change, field, monkeypatch, tmp_path):
    """run_training refuses, naming the field, what it cannot run: a
    conformer over 2 ranks (its BatchNorm statistics would be each rank's;
    the host is taken to have the cards it asks for) and an int8 teacher.
    The same conformer file loads, and runs on one rank."""
    monkeypatch.setattr(loop, "world_size", lambda cfg, dev: max(1, cfg.train.num_devices))
    raw = _raw("configs/smoke.yaml")
    raw["train"] = {**raw["train"], "output_dir": str(tmp_path / "run")}
    for section, kw in change.items():
        raw[section] = {**raw[section], **kw}
    with pytest.raises(NotImplementedError, match=field):
        loop.run_training(tc.config_from_yaml_dict(raw), device="cpu")
    assert not os.path.exists(tmp_path / "run")
    if "distiller" in raw and raw["distiller"].get("layer_type") == "conformer":
        assert tc.config_from_yaml_dict(raw).distiller.dedicated_conformer


@pytest.mark.parametrize("path", SUPPORTED)
def test_dump_reads_back_equal_through_the_jax_loader(path, tmp_path):
    """The dump needs no YAML library; PyYAML, the JAX loader and the
    port's reader read it back to the same values (floats such as 1e-6
    keep their '.', which PyYAML needs to read a float)."""
    cfg = tc.config_from_yaml_dict(_raw(path))
    out = str(tmp_path / "dump.yaml")
    tc.dump_config(cfg, out)
    _assert_shared_fields_equal(cfg, j_load_yaml(out))
    assert tc.load_experiment_yaml(out) == cfg
    assert isinstance(_raw(out)["optimizer"]["eps"], float)


@pytest.mark.parametrize("num_devices, visible, ranks", [
    (2, 1, 1), (0, 1, 1), (1, 4, 1), (2, 4, 2), (0, 2, 2)])
def test_more_than_one_card_is_refused(num_devices, visible, ranks, monkeypatch):
    """No card count is refused any more: num_devices resolves to the ranks
    a run starts, as the JAX mesh takes devices[:n] (0 = every visible
    card). configs/fithubert.yaml's gpus: 2 runs on one visible card; two or
    more cards are data parallelism, one rank each; the CPU is one rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = tc.ExperimentConfig(train=tc.TrainConfig(num_devices=num_devices))
    assert loop.world_size(cfg, torch.device("cuda")) == ranks
    assert loop.world_size(cfg, torch.device("cpu")) == 1


# ---------------------------------------------------------------- checkpoints
def _state(v):
    return {"student": {"w": torch.full((2, 3), float(v))}, "step": int(v),
            "optimizer": {"state": {0: {"exp_avg": torch.ones(2) * v}},
                          "param_groups": [{"lr": 0.1, "betas": (0.9, 0.98), "params": [0]}]}}


def test_checkpoint_round_trip_and_empty_directory(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)
    assert ckpt.latest_step() is None and ckpt.restore() is None and ckpt.restore(3) is None
    ckpt.save(3, _state(3), v_loss=0.5)
    back = ckpt.restore()
    assert back["step"] == 3 and back["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.98)
    torch.testing.assert_close(back["student"]["w"], torch.full((2, 3), 3.0), rtol=0, atol=0)
    assert sorted(os.listdir(tmp_path / "ckpt" / "last")) == ["step_3.pt"]


def test_checkpoint_keeps_top_k_by_v_loss_and_save_last_stays_out_of_best(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=2)
    for step, v in ((1, 0.9), (2, 0.4), (3, 0.7), (4, 0.8)):
        ckpt.save(step, _state(step), v_loss=v)
    assert ckpt.best_metrics() == {2: 0.4, 3: 0.7}
    assert sorted(os.listdir(tmp_path / "ckpt" / "best")) == ["index.json", "step_2.pt",
                                                               "step_3.pt"]
    ckpt.save_last(5, _state(5))
    assert ckpt.best_metrics() == {2: 0.4, 3: 0.7} and ckpt.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "ckpt" / "last")) == ["step_5.pt"]
    assert ckpt.restore(2)["step"] == 2  # an older step, found in best/
    assert ckpt.restore(4) is None
    assert not [f for f in os.listdir(tmp_path / "ckpt" / "best") if ".tmp." in f]


# ---------------------------------------------------------------- the loop
def _smoke(out_dir, **train):
    cfg = tc.load_experiment_yaml("configs/smoke.yaml")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, synthetic_num_batches=8, synthetic_wav_length=8000),
        train=dataclasses.replace(cfg.train, output_dir=str(out_dir), log_every=1,
                                  **{"max_steps": 0, **train}))


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """Two epochs of 4 steps, uninterrupted."""
    out = tmp_path_factory.mktemp("full")
    return out, loop.run_training(_smoke(out), resume=False, device="cpu")


def test_loop_trains_evaluates_and_exports(full_run):
    out, result = full_run
    assert result["steps"] == 8 and not result["preempted"]
    losses = _losses(out)
    assert sorted(losses) == list(range(1, 9)) and all(np.isfinite(list(losses.values())))
    assert losses[8] < losses[1]
    assert np.isfinite(result["best_v_loss"])
    names = set(os.listdir(out))
    assert {"config.yaml", "student.yaml", "student.pt", "metrics.jsonl"} <= names
    assert len([n for n in names if n.endswith(".yaml")]) == 3  # + the timestamped copy
    assert CheckpointManager(str(out / "ckpt")).latest_step() == 8


def test_resume_continues_from_the_saved_step(full_run, tmp_path):
    """A run stopped at the end of epoch 0 and resumed gives the
    uninterrupted run's losses for epoch 1, bit for bit: the optimizer
    state, the step (dropout seeds, lr) and the epoch's shuffle all come
    back, and smoke.yaml's one random layer leaves no order to redraw."""
    full_out, _ = full_run
    first = loop.run_training(_smoke(tmp_path, max_steps=4), resume=False, device="cpu")
    assert first["steps"] == 4
    second = loop.run_training(_smoke(tmp_path), resume=True, device="cpu")
    assert second["steps"] == 8
    got, want = _losses(tmp_path), _losses(full_out)
    assert sorted(got) == list(range(1, 9))
    for step in range(1, 9):
        assert got[step] == want[step], step


def test_profile_steps_writes_a_trace(tmp_path):
    result = loop.run_training(_smoke(tmp_path, max_steps=4, profile_steps=1), resume=False,
                               device="cpu")
    assert result["steps"] == 4
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_test_only_returns_test_loss(tmp_path):
    result = loop.run_training(_smoke(tmp_path), resume=False, test_only=True, device="cpu")
    assert set(result) == {"test_loss"} and np.isfinite(result["test_loss"])


def test_sigterm_mid_run_saves_last_and_returns_preempted(tmp_path, monkeypatch):
    step = Distiller.train_step_async
    calls = []

    def step_then_signal(self, batch, rand):
        logs = step(self, batch, rand)
        calls.append(1)
        if len(calls) == 3:
            # the loop's guard is installed: the signal only sets its flag
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
            signal.raise_signal(signal.SIGTERM)
        return logs

    monkeypatch.setattr(Distiller, "train_step_async", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    result = loop.run_training(_smoke(tmp_path), resume=False, device="cpu")
    assert result["preempted"] and result["steps"] == 3
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 3 and ckpt.best_metrics() == {}
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.setattr(Distiller, "train_step_async", step)
    # the interrupted epoch starts again from its first batch, as in the JAX
    # loop (start_epoch = step // steps per epoch): 3 + 4 + 4 steps
    assert loop.run_training(_smoke(tmp_path), resume=True, device="cpu")["steps"] == 11


def test_exported_pair_serves_and_crosses_to_jax(full_run):
    """student.yaml through the JAX loader, student.pt through
    map_student_state_dict onto the JAX StudentModel: its deterministic
    forward gives the port expert's features, fp32, to 1e-5."""
    out, _ = full_run
    _assert_shared_fields_equal(_smoke(out), j_load_yaml(str(out / "student.yaml")))
    jcfg = j_load_yaml(str(out / "student.yaml")).distiller
    sd = torch.load(out / "student.pt", map_location="cpu", weights_only=True)
    params = map_student_state_dict(sd, jcfg)
    last = f"proj_head_{jcfg.encoder_layers - 1}"
    params = {k: v for k, v in params.items() if not k.startswith("proj_head_") or k == last}

    rng = np.random.default_rng(2)
    wavs = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in (7000, 5200, 3100)]
    got = UpstreamExpert(str(out / "student.pt"), str(out / "student.yaml"), device="cpu",
                         length_quantum=4000)(wavs)
    wav = np.zeros((3, 8000), np.float32)
    mask = np.ones((3, 8000), bool)
    for i, w in enumerate(wavs):
        wav[i, : len(w)], mask[i, : len(w)] = w, False
    want = JStudent(jcfg, disable_projections=True).apply(
        {"params": params}, jnp.asarray(wav), jnp.asarray(mask), deterministic=True)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(want.padding_mask))
    np.testing.assert_allclose(got["last_hidden_state"].numpy(), np.asarray(want.x),
                               atol=1e-5, rtol=1e-5)
    for h, (jh, _, _) in zip(got["hidden_states"], want.layer_results):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_cli_runs_the_smoke_config_in_test_mode(tmp_path, monkeypatch):
    import train_torch

    monkeypatch.chdir(tmp_path)
    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "smoke.yaml")
    result = train_torch.main(["-c", smoke, "-t", "--no-resume", "--device", "cpu"])
    assert np.isfinite(result["test_loss"])
    assert (tmp_path / "results" / "pretrain" / "smoke" / "config.yaml").exists()
