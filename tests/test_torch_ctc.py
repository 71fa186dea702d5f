"""The port's CTC path (a task-specific wav2vec_ctc teacher) against the
JAX package on the same numpy-seeded inputs and carried weights, on the
CPU: collapse_pseudo_labels, the CTC term against optax.ctc_loss, the
wav2vec_ctc teacher's forward and its fairseq import, a CTC train step on
scripts/make_goldens.py's build_ctc geometry (pseudo-labels and ground
truth), the predict step, utils/text, labels from FLACs with LibriSpeech
transcripts and from synthetic batches, and configs/smoke_ctc.yaml through
the loop."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fithubert_tpu.config import DataConfig as JDataConfig
from fithubert_tpu.data import librispeech as jls
from fithubert_tpu.export.fairseq_import import load_fairseq_teacher as j_load_fairseq
from fithubert_tpu.models.teacher import TeacherModel as JTeacher
from fithubert_tpu.train.losses import collapse_pseudo_labels as j_collapse
from fithubert_tpu.utils import text as jtext
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.data import librispeech as ls
from fithubert_tpu_torch.export.fairseq_import import load_fairseq_teacher, load_teacher_any
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.losses import collapse_pseudo_labels, ctc_per_sequence
from fithubert_tpu_torch.train.step import Distiller
from fithubert_tpu_torch.utils import text
from tests.flac_writer import write_flac
from tests.test_fairseq_pickle import D, VOCAB, _INNER_MODEL, _save_with_omegaconf_cfg, _tiny_sd

torch.set_num_threads(2)

# fp32 on both sides: summation order only (the CTC forward sums over T
# frames in log space).
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# as tests/test_torch_train_step.py: loss-type logs to summation order;
# parameters after AdamW within a small fraction of lr
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
# build_ctc's pseudo-labels cannot be aligned in the student's frames
# (ctc_loss ~5e4: optax's log(0) stand-in, -1e5, is in the sum). The
# gradient is then exp of differences of ~-1e5 values, whose fp32
# resolution is 2^-24 * 1e5 ~ 6e-3: both frameworks' gradients carry that
# much relative noise, so grad_norm is held to 1e-2 there.
INFEASIBLE_GRAD_RTOL = 1e-2


def _port(cls, j):
    """A port config dataclass from a JAX one, over the fields they share."""
    return cls(**{f.name: getattr(j, f.name) for f in dataclasses.fields(cls)
                  if hasattr(j, f.name)})


def _port_experiment(jcfg):
    return tc.ExperimentConfig(
        teacher=_port(tc.TeacherConfig, jcfg.teacher), train=_port(tc.TrainConfig, jcfg.train),
        loss=_port(tc.LossConfig, jcfg.loss), distiller=_port(tc.StudentConfig, jcfg.distiller),
        optimizer=_port(tc.OptimizerConfig, jcfg.optimizer), data=_port(tc.DataConfig, jcfg.data))


# ------------------------------------------------------------------- losses
def test_collapse_pseudo_labels_matches_jax():
    """Repeats merged, blanks dropped, front-packed at the fixed width T;
    rows all blank, without blanks, and one token repeated."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5, (6, 23))
    ids[2] = 0
    ids[3] = 4
    ids[4] = np.arange(23) % 4 + 1
    want_l, want_p = j_collapse(jnp.asarray(ids))
    got_l, got_p = collapse_pseudo_labels(torch.from_numpy(ids))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_p[2].all() and (1 - got_p[3]).sum() == 1


def test_ctc_term_matches_optax():
    """optax.ctc_loss semantics: blank 0, a log-softmax inside, T cut by
    logit_paddings, U by label_paddings; rows with padded frames, padded
    labels, none at all (all blank), and more labels than frames (optax's
    finite penalty, where F.ctc_loss would give inf)."""
    rng = np.random.default_rng(1)
    b, t, v, u = 7, 30, 12, 9
    logits = (rng.standard_normal((b, t, v)) * 2).astype(np.float32)
    logit_pads = np.zeros((b, t), np.float32)
    logit_pads[1, 20:] = logit_pads[3, 25:] = logit_pads[6, 6:] = 1.0
    label_pads = np.zeros((b, u), np.float32)
    label_pads[0, 5:] = label_pads[2] = label_pads[4, 7:] = label_pads[5, 1:] = 1.0
    labels = np.where(label_pads > 0, 0, rng.integers(1, v, (b, u))).astype(np.int32)
    want = optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pads), jnp.asarray(labels),
                          jnp.asarray(label_pads))
    got = ctc_per_sequence(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(label_pads), torch.from_numpy(logit_pads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert 1e4 < got[6] < 1e6  # 9 labels in 6 frames
    full = optax.ctc_loss(jnp.asarray(logits), jnp.zeros((b, t)), jnp.asarray(labels),
                          jnp.asarray(label_pads))
    np.testing.assert_allclose(ctc_per_sequence(torch.from_numpy(logits),
                                                torch.from_numpy(labels),
                                                torch.from_numpy(label_pads)).numpy(),
                               np.asarray(full), **F32_TOL)


# ------------------------------------------------------------------ teacher
def _ctc_checkpoint(path):
    """The fine-tuned layout of tests/test_fairseq_pickle.py:234-263: the
    body under w2v_encoder.w2v_model., the head w2v_encoder.proj, the
    acoustic config nested in w2v_args (outer keys that must lose)."""
    sd = {f"w2v_encoder.w2v_model.{k}": v for k, v in _tiny_sd().items()}
    g = torch.Generator().manual_seed(1)
    sd["w2v_encoder.proj.weight"] = 0.1 * torch.randn(VOCAB, D, generator=g)
    sd["w2v_encoder.proj.bias"] = 0.1 * torch.randn(VOCAB, generator=g)
    _save_with_omegaconf_cfg(path, sd, {"model": {
        "_name": "wav2vec_ctc", "activation_fn": "relu", "dropout": 0.5,
        "w2v_args": {"model": dict(_INNER_MODEL), "task": {"_name": "audio_pretraining"}}}})


def test_wav2vec_ctc_teacher_import_and_forward_match_jax(tmp_path):
    """Both importers on the same fine-tuned pickle give one geometry (the
    inner config wins) and teachers whose ctc_logits, hiddens and frame mask
    agree; ctc_proj stays fp32 when the teacher is frozen in bf16."""
    path = str(tmp_path / "ctc.pt")
    _ctc_checkpoint(path)
    geom, state = load_fairseq_teacher(path)
    jgeom, jvars = j_load_fairseq(path)
    for f in dataclasses.fields(geom):
        assert getattr(geom, f.name) == getattr(jgeom, f.name), f.name
    assert geom.model_type == "wav2vec_ctc" and geom.vocab_size == VOCAB
    assert geom.activation_fn == "gelu"
    assert load_teacher_any(path)[0] == geom
    teacher = TeacherModel(geom, device="cpu")
    teacher.load_state_dict(state, strict=True)
    rng = np.random.default_rng(2)
    wav = (0.3 * rng.standard_normal((3, 2400))).astype(np.float32)
    mask = np.arange(2400)[None, :] >= np.array([2400, 1900, 1250])[:, None]
    wav[mask] = 0.0
    want = JTeacher(geometry=jgeom).apply(jvars, jnp.asarray(wav), jnp.asarray(mask))
    got = teacher(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
    assert got.ctc_logits.shape == (3, want.ctc_logits.shape[1], VOCAB)
    np.testing.assert_allclose(got.ctc_logits.numpy(), np.asarray(want.ctc_logits), **F32_TOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **F32_TOL)
    frozen = TeacherModel(dataclasses.replace(geom, compute_dtype="bfloat16"), device="cpu")
    frozen.load_state_dict(state)
    frozen.freeze()
    assert frozen.ctc_proj.weight.dtype == torch.float32
    assert frozen.encoder.layers[0].fc1.weight.dtype == torch.bfloat16


# ---------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def ctc_setup():
    """build_ctc's JAX Distiller, teacher and state (pseudo-label path)."""
    from scripts.make_goldens import build_ctc

    return build_ctc()


def _port_distiller(d, tp, state, **loss):
    texp = _port_experiment(d.cfg)
    texp = dataclasses.replace(texp, loss=dataclasses.replace(texp.loss, **loss))
    geom = _port(TeacherGeometry, d.teacher_geometry)
    return Distiller(texp, jax_teacher_params_to_state_dict(tp["params"], geom),
                     jax_student_params_to_state_dict(jax.device_get(state.params),
                                                      texp.distiller),
                     device="cpu", num_training_steps=8, teacher_geometry=geom)


def _compare_step(d, got, want_logs, want_params, grad_rtol=LOSS_TOL["rtol"]):
    want = {k: float(v) for k, v in want_logs.items()}
    assert set(got) == set(want) and "ctc_loss" in got
    for k, w in want.items():
        tol = dict(LOSS_TOL, rtol=grad_rtol) if k == "grad_norm" else LOSS_TOL
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)
    want_sd = jax_student_params_to_state_dict(jax.device_get(want_params), d.cfg.distiller)
    for k, v in d.student.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), err_msg=k, **PARAM_TOL)


def test_ctc_pseudo_label_step_matches_jax_and_the_golden(ctc_setup):
    """The teacher's argmax, collapsed, supervises the student's output by
    CTC beside the L1 term: loss, ctc_loss, grad_norm and every parameter
    after the step against the JAX step, and the ctc_step golden. The
    labels are longer than the student's frames allow, so the loss is
    optax's finite penalty, which the port reproduces."""
    d, tp, state, wav, mask = ctc_setup
    batch = {"x": np.asarray(wav)[None], "padding_mask": np.asarray(mask)[None]}
    pd = _port_distiller(d, tp, state)
    got = pd.train_step(batch, None)
    new_state, logs = d.make_train_step()(jax.tree_util.tree_map(jnp.copy, state), tp,
                                          jax.tree_util.tree_map(jnp.asarray, batch),
                                          jnp.zeros((0,), jnp.int32), jax.random.PRNGKey(9))
    assert got["ctc_loss"] > 1e4  # the labels cannot be aligned: see INFEASIBLE_GRAD_RTOL
    _compare_step(pd, got, logs, new_state.params, INFEASIBLE_GRAD_RTOL)
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ctc_step.npz"))
    np.testing.assert_allclose(got["ctc_loss"], g["ctc_loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["loss"], g["loss"], **LOSS_TOL)


def test_ctc_ground_truth_step_and_predict_match_jax(ctc_setup):
    """use_gt_for_ctc with the batch's labels (A = 2 microbatches folded,
    label rows padded): the step against the JAX step; then the predict
    step's ids (argmax over the first 32 channels) and frame mask."""
    d0, tp, state, wav, mask = ctc_setup
    from fithubert_tpu.train.step import Distiller as JDistiller

    cfg = dataclasses.replace(d0.cfg, loss=dataclasses.replace(d0.cfg.loss,
                                                               use_gt_for_ctc=True))
    d = JDistiller(cfg, num_training_steps=8)
    rng = np.random.default_rng(3)
    x = np.stack([np.asarray(wav), np.asarray(wav)[::-1] * 0.5])
    m = np.stack([np.asarray(mask), np.asarray(mask)])
    labels = np.zeros((2, 2, 12), np.int32)
    pads = np.ones((2, 2, 12), np.float32)
    for a, b, n in ((0, 0, 7), (0, 1, 3), (1, 0, 10), (1, 1, 0)):
        labels[a, b, :n] = rng.integers(1, 32, n)
        pads[a, b, :n] = 0.0
    batch = {"x": x.astype(np.float32), "padding_mask": m, "labels": labels,
             "label_paddings": pads}
    pd = _port_distiller(d, tp, state, use_gt_for_ctc=True)
    got = pd.train_step(batch, None)
    new_state, logs = d.make_train_step()(jax.tree_util.tree_map(jnp.copy, state), tp,
                                          jax.tree_util.tree_map(jnp.asarray, batch),
                                          jnp.zeros((0,), jnp.int32), jax.random.PRNGKey(9))
    _compare_step(pd, got, logs, new_state.params)
    ids, fmask = pd.predict_step({"x": x[0], "padding_mask": m[0]}, 32)
    want_ids, want_mask = d.make_predict_step(32)(new_state, {"x": jnp.asarray(x[0]),
                                                              "padding_mask": jnp.asarray(m[0])})
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(want_mask))
    agree = (ids.numpy() == np.asarray(want_ids)).mean()
    assert agree >= 0.99, agree  # fp32 argmax: a near-tie may flip one frame


# --------------------------------------------------------------- utils/text
def test_text_utilities_equal_the_jax_package():
    rng = np.random.default_rng(4)
    sents = ["HELLO WORLD", "IT'S A TEST", "", "QZX J", "A  B"]
    hyps = ["HELO WORLD", "ITS A TEST", "X", "", "A B C"]
    pd, jd = text.LetterDictionary(), jtext.LetterDictionary()
    assert pd.symbols == jd.symbols and len(pd) == 32
    path = text.default_dict_path()
    assert os.path.exists(path) and text.LetterDictionary.load(path).symbols == \
        jtext.LetterDictionary.load(jtext.default_dict_path()).symbols
    for s in sents + ["hello, world!"]:
        assert pd.encode(s) == jd.encode(s)
    for _ in range(5):
        ids = rng.integers(0, 32, 40)
        assert text.GreedyCTCDecoder().decode(ids) == jtext.GreedyCTCDecoder().decode(ids)
        assert text.ctc_collapse(list(ids)) == jtext.ctc_collapse(list(ids))
    for r, h in zip(sents, hyps):
        assert text.edit_distance(r, h) == jtext.edit_distance(r, h)
    assert text.wer(sents, hyps) == jtext.wer(sents, hyps)
    assert text.cer(sents, hyps) == jtext.cer(sents, hyps)
    assert text.edit_stats(sents, hyps) == jtext.edit_stats(sents, hyps)


# ------------------------------------------------------------------- labels
@pytest.fixture(scope="module")
def labelled_corpus(tmp_path_factory):
    """<root>/dev-tiny/<spk>/<chap>/<utt>.flac with <spk>-<chap>.trans.txt;
    one utterance has no line in its transcript file."""
    root = tmp_path_factory.mktemp("labelled")
    rng = np.random.default_rng(5)
    lines = {}
    for u in range(6):
        spk = 3 + u % 2
        chap = root / "dev-tiny" / str(spk) / "9"
        chap.mkdir(parents=True, exist_ok=True)
        n = 1200 + 517 * u
        sig = np.round(2000 * np.sin(np.arange(n) * 0.05 * (u + 1))
                       + 200 * rng.standard_normal(n)).astype(np.int64)
        name = f"{spk}-9-{u:04d}"
        write_flac(str(chap / f"{name}.flac"), [sig], kind="fixed1" if u % 2 else "verbatim")
        if u != 4:
            lines.setdefault(chap / f"{spk}-9.trans.txt", []).append(
                f"{name} {'HELLO WORLD ' * (u + 1)}IT'S ME".strip())
    for p, rows in lines.items():
        p.write_text("\n".join(rows) + "\n")
    return str(root)


def test_labels_from_transcripts_equal_jax(labelled_corpus, tmp_path):
    """load_labels: letter ids and paddings per row (fabricated rows and the
    utterance without a line get none), U quantized, the texts beside, bit
    for bit against the JAX dataset."""
    common = dict(libri_root=labelled_corpus, length_quantum=1000, num_workers=2, prefetch=1,
                  load_labels=True, label_quantum=8)
    jd = jls.BucketedLibriSpeech(JDataConfig(bucketing_path=str(tmp_path / "j"), **common),
                                 ["dev-tiny"], batch_size=4, accum=2, seed=1)
    pd = ls.BucketedLibriSpeech(tc.DataConfig(bucketing_path=str(tmp_path / "p"), **common),
                                ["dev-tiny"], batch_size=4, accum=2, seed=1)
    for got, want in zip(pd.epoch(0), jd.epoch(0)):
        assert set(got) == set(want) == {"x", "padding_mask", "labels", "label_paddings",
                                         "_transcripts"}
        for k in ("x", "padding_mask", "labels", "label_paddings"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["_transcripts"] == want["_transcripts"]
        assert got["labels"].shape[2] % 8 == 0
    texts = [t for g in pd.epoch(0) for mb in g["_transcripts"] for t in mb]
    assert "" in texts and any(t.startswith("HELLO WORLD") for t in texts)


def test_synthetic_labels_equal_jax():
    cfg = dict(synthetic=True, synthetic_num_batches=4, synthetic_wav_length=8000,
               length_quantum=4000, load_labels=True)
    jd = jls.SyntheticDataset(JDataConfig(**cfg), batch_size=2, accum=2, seed=3)
    pd = ls.SyntheticDataset(tc.DataConfig(**cfg), batch_size=2, accum=2, seed=3)
    for got, want in zip(pd.epoch(1), jd.epoch(1)):
        assert set(got) == set(want)
        for k in ("x", "padding_mask", "labels", "label_paddings"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["_transcripts"] == want["_transcripts"]


# --------------------------------------------------------------------- loop
def test_smoke_ctc_config_trains_with_wer(tmp_path):
    """configs/smoke_ctc.yaml through train_torch.py (a random wav2vec_ctc
    teacher, synthetic labelled data; --set moves the output and cuts the
    run): the CTC term is logged every step, the evals report a WER and
    CER, and the export loads back."""
    import train_torch

    result = train_torch.main(["-c", "configs/smoke_ctc.yaml", "--device", "cpu", "--no-resume",
                               "--set", f"train.output_dir={tmp_path}",
                               "--set", "train.max_steps=4", "--set", "train.log_every=1"])
    assert result["steps"] == 4 and np.isfinite(result["best_v_loss"])
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "loss" in r]
    assert len(train) == 4 and all(np.isfinite(r["ctc_loss"]) for r in train)
    val = [r for r in rows if "val/wer" in r]
    assert val and 0.0 <= val[-1]["val/wer"] and np.isfinite(val[-1]["val/cer"])
    assert os.path.exists(tmp_path / "student.pt")
    with pytest.raises(SystemExit):
        train_torch.main(["-c", "configs/smoke_ctc.yaml", "--set", "max_steps=4"])
