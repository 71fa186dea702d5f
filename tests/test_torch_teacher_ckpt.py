"""Teacher checkpoints in the port (fithubert_tpu_torch/export/
fairseq_import.py) against the JAX package's importer: the tiny fairseq
pickles of tests/test_fairseq_pickle.py (an omegaconf cfg, and an argparse
args of older fairseq) and one written here with torch's parametrized
weight-norm keys, each read by both loaders and run through both teachers
on the same waveform, fp32, to 1e-5 (summation order only, at O(1)
activations); the converted pair, and what the port refuses."""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.export.fairseq_import import load_fairseq_teacher as j_load_fairseq
from fithubert_tpu.models.teacher import TeacherModel as JTeacher
from fithubert_tpu_torch.export.fairseq_import import (
    load_fairseq_teacher,
    load_teacher_any,
    save_converted_teacher,
)
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from tests.test_fairseq_pickle import D, VOCAB, _INNER_MODEL, _save_with_omegaconf_cfg, _tiny_sd

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_GEOM = TeacherGeometry(
    model_type="hubert", conv_feature_layers=((32, 10, 5), (48, 3, 2), (48, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=96,
    encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4)


def _omegaconf_hubert(path):
    sd = _tiny_sd()
    sd["label_embs_concat"] = torch.zeros(4, D)
    _save_with_omegaconf_cfg(path, sd, {"model": dict(_INNER_MODEL)})


def _legacy_args_wav2vec2(path):
    """Older fairseq: no cfg, the model's flags in an argparse Namespace."""
    torch.save({"model": _tiny_sd(), "cfg": None,
                "args": argparse.Namespace(**_INNER_MODEL)}, path)


def _parametrized_hubert(path):
    """A checkpoint saved after PyTorch 2.1: the positional conv's weight
    norm under ``parametrizations``; HuBERT's pretraining heads beside the
    encoder; a cfg without the conv spec or the head count, which then come
    from the kernels' shapes (fairseq's strides) and embed_dim // 64."""
    sd = TeacherModel(PARAM_GEOM, device="cpu").init_weights(
        torch.Generator().manual_seed(4)).state_dict()
    sd = {k.replace(".weight_g", ".parametrizations.weight.original0")
          .replace(".weight_v", ".parametrizations.weight.original1"): v
          for k, v in sd.items()}
    sd["encoder.pos_conv.0.parametrizations.weight.original0"] *= 1.7
    sd.update({"label_embs_concat": torch.zeros(3, 128), "mask_emb": torch.zeros(128),
               "final_proj.weight": torch.zeros(16, 128), "final_proj.bias": torch.zeros(16)})
    torch.save({"model": sd, "cfg": {"model": {"_name": "hubert", "layer_norm_first": False,
                                               "activation_fn": "gelu"}}}, path)


WRITERS = {"omegaconf_cfg": _omegaconf_hubert, "legacy_args": _legacy_args_wav2vec2,
           "parametrizations": _parametrized_hubert}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_fairseq_teacher_forward_matches_jax(kind, tmp_path):
    path = str(tmp_path / f"{kind}.pt")
    WRITERS[kind](path)
    geom, state = load_fairseq_teacher(path)
    jgeom, jvars = j_load_fairseq(path)
    for f in dataclasses.fields(geom):
        assert getattr(geom, f.name) == getattr(jgeom, f.name), f.name
    assert not any(k.startswith(("label_embs", "final_proj", "mask_emb")) for k in state)
    teacher = TeacherModel(geom, device="cpu")
    teacher.load_state_dict(state, strict=True)

    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal((3, 2400))).astype(np.float32)
    mask = np.arange(2400)[None, :] >= np.array([2400, 1900, 1250])[:, None]
    wav[mask] = 0.0
    want = JTeacher(geometry=jgeom).apply(jvars, jnp.asarray(wav), jnp.asarray(mask))
    got = teacher(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **TOL)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **TOL)
    assert len(got.layer_results) == len(want.layer_results) == geom.encoder_layers
    for (h, _, ffn), (jh, _, jffn) in zip(got.layer_results, want.layer_results):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(ffn.numpy(), np.asarray(jffn), **TOL)


def test_geometry_from_weights_and_defaults(tmp_path):
    path = str(tmp_path / "p.pt")
    _parametrized_hubert(path)
    geom, state = load_fairseq_teacher(path)
    assert dataclasses.replace(geom, encoder_attention_heads=2) == PARAM_GEOM
    assert geom.encoder_attention_heads == 128 // 64
    assert "encoder.pos_conv.0.weight_g" in state and "encoder.pos_conv.0.weight_v" in state
    assert not any("parametrizations" in k for k in state)


def test_converted_pair_round_trips_and_msgpack_is_refused(tmp_path):
    path = str(tmp_path / "h.pt")
    _omegaconf_hubert(path)
    geom, state = load_fairseq_teacher(path)
    json_path, pt_path = save_converted_teacher(geom, state, str(tmp_path / "conv"))
    for p in (json_path, str(tmp_path / "conv")):
        g2, s2 = load_teacher_any(json_path if p.endswith(".json") else p + ".json")
        assert g2 == geom and set(s2) == set(state)
        for k in state:
            torch.testing.assert_close(s2[k], state[k], rtol=0, atol=0)
    assert load_teacher_any(path)[0] == geom
    with pytest.raises(ValueError, match="msgpack"):
        load_teacher_any(str(tmp_path / "teacher.msgpack"))


def test_ctc_and_layer_norm_teachers_are_refused(tmp_path):
    """A wav2vec_ctc checkpoint is read now (tests/test_torch_ctc.py holds
    its forward against the JAX teacher): its body and its CTC head. A
    layer_norm extractor, once refused, builds, with fairseq's keys for
    every block's LayerNorm (tests/test_torch_options.py holds a
    wav2vec2-Large-shaped one against the JAX teacher)."""
    path = str(tmp_path / "ctc.pt")
    sd = {f"w2v_encoder.w2v_model.{k}": v for k, v in _tiny_sd().items()}
    sd["w2v_encoder.proj.weight"] = torch.zeros(VOCAB, D)
    sd["w2v_encoder.proj.bias"] = torch.zeros(VOCAB)
    torch.save({"model": sd, "cfg": {"model": {"w2v_args": {"model": dict(_INNER_MODEL)}}}},
               path)
    geom, state = load_fairseq_teacher(path)
    assert geom.model_type == "wav2vec_ctc" and geom.vocab_size == VOCAB
    assert tuple(state["ctc_proj.weight"].shape) == (VOCAB, D)
    assert not any(k.startswith("w2v_encoder.") for k in state)
    path = str(tmp_path / "ln.pt")
    torch.save({"model": _tiny_sd(),
                "cfg": {"model": dict(_INNER_MODEL, extractor_mode="layer_norm")}}, path)
    geom, _ = load_fairseq_teacher(path)
    assert geom.extractor_mode == "layer_norm"
    keys = TeacherModel(geom, device="cpu").state_dict()
    assert all(f"feature_extractor.conv_layers.{i}.2.1.weight" in keys
               for i in range(len(geom.conv_feature_layers)))
    assert "feature_extractor.conv_layers.0.2.weight" not in keys
