"""The port's downstream probe (fithubert_tpu_torch/scripts/linear_probe.py)
against the JAX script (scripts/linear_probe.py) on the CPU: the synthetic
datasets, the CTC batch packing and greedy decoding are the same arrays
and strings; the frozen features of one tiny student exported by the JAX
package (its .msgpack carried into the port's state dict) agree within
fp32 summation order; both heads, started from JAX's own initial draw,
train to the same losses, accuracy and CER. Whether a probe beats its
shuffled control is a learned margin: those tests are marked slow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.linear_probe as jlp
from fithubert_tpu.export.expert import UpstreamExpert as JExpert
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.train.checkpoint import export_student, load_student_export
from fithubert_tpu_torch.config import load_yaml_config
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.export.jax_params import jax_student_params_to_state_dict
from fithubert_tpu_torch.scripts import linear_probe as lp
from tests.test_downstream_probe import _probe_cfg

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_export.py's fp32 features
# The heads' losses after 50 (linear) and 30 (CTC) full-batch steps from one
# initial draw, the same updates in another fp32 order. The linear head's
# stay within 3e-6 of JAX's (at 10-300 steps, seeds 0-2). Adam's first update
# moves each weight by about lr * sign(gradient), and some of the CTC head's
# gradients are ~1e-7, the size of the two fp32 orders' difference there,
# so those weights move differently: the CTC losses part by up to 1.1e-3
# over 1-30 steps (5e-4 at step 3).
LINEAR_LOSS_RTOL = 1e-4
CTC_LOSS_RTOL = 5e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tone_dataset_is_the_jax_scripts(seed):
    wavs, labels = lp.make_tone_dataset(10, 3, seed=seed)
    jwavs, jlabels = jlp.make_tone_dataset(10, 3, seed=seed)
    np.testing.assert_array_equal(labels, jlabels)
    assert len(wavs) == len(jwavs)
    for w, jw in zip(wavs, jwavs):
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spoken_dataset_is_the_jax_scripts(seed):
    wavs, texts = lp.make_spoken_dataset(8, seed=seed)
    jwavs, jtexts = jlp.make_spoken_dataset(8, seed=seed)
    assert texts == jtexts and lp.CTC_ALPHABET == jlp.CTC_ALPHABET
    for w, jw in zip(wavs, jwavs):
        np.testing.assert_array_equal(w, jw)


def test_greedy_decode_and_batch_packing_are_the_jax_scripts():
    rng = np.random.default_rng(4)
    for n in (1, 7, 20):
        logits = rng.standard_normal((20, 5)).astype(np.float32)
        logits[::3, 0] += 3.0  # runs of blanks between letters
        assert lp._greedy_ctc_decode(logits, n) == jlp._greedy_ctc_decode(logits, n)
    seqs = [rng.standard_normal((t, 6)).astype(np.float32) for t in (5, 9, 3)]
    texts = ["abc", "d", "abcdab"]
    mu = np.concatenate(seqs).mean(0, keepdims=True)
    sd = np.concatenate(seqs).std(0, keepdims=True) + 1e-6
    for got, want in zip(lp._pack_ctc_batch(seqs, texts, mu, sd),
                         jlp._pack_ctc_batch(seqs, texts, mu, sd)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_cosine_rate_is_optaxs_schedule():
    import optax

    sched = optax.cosine_decay_schedule(0.05, 30)
    for k in (0, 1, 15, 29, 30, 31):
        assert lp.cosine_lr(0.05, 30, k) == pytest.approx(float(sched(k)), rel=1e-6, abs=1e-9)


@pytest.fixture(scope="module")
def experts(tmp_path_factory):
    """The JAX expert and the port's (fp32, CPU) on one export of the tiny
    probe student of tests/test_downstream_probe.py."""
    d = tmp_path_factory.mktemp("probe_export")
    cfg = _probe_cfg()
    rng = jax.random.PRNGKey(0)
    variables = JStudent(cfg=cfg.distiller).init(
        {"params": rng, "dropout": rng, "specaug": rng, "layerdrop": rng},
        jnp.zeros((1, 8000), jnp.float32), jnp.zeros((1, 8000), bool))
    yaml_path, weights_path = export_student(cfg, variables["params"], str(d), tag="student")
    tcfg = load_yaml_config(yaml_path)
    params = jax.tree_util.tree_map(np.asarray, load_student_export(weights_path)["params"])
    sd = jax_student_params_to_state_dict(params, tcfg)
    return (JExpert(weights_path, yaml_path, length_quantum=8000),
            UpstreamExpert(sd, tcfg, device="cpu", length_quantum=8000))


@pytest.fixture(scope="module")
def tone_features(experts):
    jexpert, _ = experts
    wavs, labels = jlp.make_tone_dataset(12, 3, seed=0)
    return jlp.extract_frame_features(jexpert, wavs, labels)


def test_frame_features_match_the_jax_scripts(experts, tone_features):
    _, expert = experts
    wavs, labels = lp.make_tone_dataset(12, 3, seed=0)
    x, y = lp.extract_frame_features(expert, wavs, labels)
    jx, jy = tone_features
    assert x.dtype == np.float32 and x.shape == jx.shape and x.shape[1] == 48
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(x, jx, **F32_TOL)


@pytest.mark.parametrize("layer", [-1, 0])
def test_sequences_match_the_jax_scripts(experts, layer):
    jexpert, expert = experts
    wavs, _texts = lp.make_spoken_dataset(10, seed=1)
    seqs = lp.extract_sequences(expert, wavs, layer, batch_size=4)
    jseqs = jlp.extract_sequences(jexpert, wavs, layer, batch_size=4)
    assert [s.shape for s in seqs] == [s.shape for s in jseqs]
    for s, js in zip(seqs, jseqs):
        np.testing.assert_allclose(s, js, **F32_TOL)


def test_frames_from_a_mask_at_another_rate_are_derived_from_the_lengths():
    """The length-derived branch: a mask whose length is not the hidden
    state's (as past a time reduction) counts frames against the longest
    waveform of the batch, as the JAX script does."""

    class Stub:
        device = torch.device("cpu")

        def __call__(self, wavs):
            t = 10
            hs = torch.arange(len(wavs) * t * 2, dtype=torch.float32).view(len(wavs), t, 2)
            return {"hidden_states": (hs,), "padding_mask": torch.zeros(len(wavs), 2 * t,
                                                                        dtype=torch.bool)}

    wavs = [np.zeros(n, np.float32) for n in (1000, 250, 40)]
    seqs = lp.extract_sequences(Stub(), wavs)
    assert [len(s) for s in seqs] == [9, 2, 1]  # int(1000 * 10 / (1000 + 1e-9)) = 9
    jseqs = jlp.extract_sequences(lambda w: {k: tuple(x.numpy() for x in v) if
                                             isinstance(v, tuple) else v.numpy()
                                             for k, v in Stub()(w).items()}, wavs)
    for s, js in zip(seqs, jseqs):
        np.testing.assert_array_equal(s, js)


def test_linear_head_trains_as_the_jax_scripts(tone_features):
    x, y = tone_features
    steps, seed = 50, 0
    want_loss, want_acc = jlp.train_linear_probe(x, y, 3, steps=steps, seed=seed)
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (x.shape[1], 3)) * 0.01)
    loss, acc = lp.train_linear_probe(x, y, 3, steps=steps, device="cpu", init={"w": w0})
    assert loss == pytest.approx(want_loss, rel=LINEAR_LOSS_RTOL)
    assert acc == want_acc


def test_ctc_head_trains_as_the_jax_scripts(experts):
    jexpert, _ = experts
    wavs, texts = jlp.make_spoken_dataset(16, seed=0)
    seqs = jlp.extract_sequences(jexpert, wavs)
    tr_s, tr_t, ev_s, ev_t = seqs[:-6], texts[:-6], seqs[-6:], texts[-6:]
    steps, seed, hidden, n_cls = 30, 0, 64, 1 + len(jlp.CTC_ALPHABET)
    want_loss, want_cer = jlp.train_ctc_probe(tr_s, tr_t, steps, seed=seed, eval_seqs=ev_s,
                                              eval_texts=ev_t)
    d = tr_s[0].shape[1]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    init = {"w1": np.asarray(jax.random.normal(k1, (d, hidden)) / np.sqrt(d)),
            "w2": np.asarray(jax.random.normal(k2, (hidden, n_cls)) * 0.01)}
    loss, got_cer = lp.train_ctc_probe(tr_s, tr_t, steps, seed=seed, eval_seqs=ev_s,
                                       eval_texts=ev_t, device="cpu", init=init)
    assert loss == pytest.approx(want_loss, rel=CTC_LOSS_RTOL)
    assert got_cer == want_cer


def test_ctc_heads_side_by_side_train_as_apart():
    """run_ctc_probe trains its probe and control as one batch of heads:
    each head's loss and CER are those it gets alone."""
    rng = np.random.default_rng(7)
    _wavs, texts = lp.make_spoken_dataset(10, seed=3)
    seqs = [rng.standard_normal((n, 12)).astype(np.float32) for n in rng.integers(20, 40, 10)]
    sets = [texts[:6], texts[:6][::-1], texts[1:6] + texts[:1]]  # orders, as the control's
    kw = dict(steps=5, eval_seqs=seqs[6:], eval_texts=texts[6:], hidden=8, device="cpu")
    together = lp.train_ctc_probes(seqs[:6], sets, **kw)
    apart = [lp.train_ctc_probe(seqs[:6], t, **kw) for t in sets]
    assert together == apart


def test_heads_draw_their_first_weights_from_the_seed(tone_features):
    x, y = tone_features
    a = lp.train_linear_probe(x, y, 3, steps=3, seed=5, device="cpu")
    b = lp.train_linear_probe(x, y, 3, steps=3, seed=5, device="cpu")
    c = lp.train_linear_probe(x, y, 3, steps=3, seed=6, device="cpu")
    assert a == b and a != c


def test_pass_rules_are_the_cli_rules():
    assert lp.probe_passed({"probe_acc": 0.5, "control_acc": 0.25, "probe_loss": 0.5,
                            "control_loss": 1.0})
    assert not lp.probe_passed({"probe_acc": 0.625, "control_acc": 0.5, "probe_loss": 0.5,
                                "control_loss": 1.0})
    assert not lp.probe_passed({"probe_acc": 0.5, "control_acc": 0.25, "probe_loss": 1.0,
                                "control_loss": 1.0})
    assert lp.ctc_probe_passed({"probe_cer": 0.5, "control_cer": 0.75})
    assert not lp.ctc_probe_passed({"probe_cer": 0.5, "control_cer": 0.625})


@pytest.mark.slow
def test_probe_on_the_ports_features_beats_shuffled_control(experts):
    """tests/test_downstream_probe.py's assertions on the port's probe."""
    res = lp.run_probe(experts[1], n_utts=12, n_classes=3, steps=250, seed=0)
    assert res["probe_acc"] > 0.75, res
    assert res["probe_acc"] > res["control_acc"] + 0.25, res
    assert res["probe_loss"] < res["control_loss"], res
    assert res["control_acc"] < 0.6, res


@pytest.mark.slow
def test_ctc_probe_transcribes_the_ports_features(experts):
    res = lp.run_ctc_probe(experts[1], n_utts=60, steps=6000, seed=0)
    assert res["probe_cer"] < 0.8, res
    assert res["control_cer"] > 1.5, res
    assert res["probe_cer"] < res["control_cer"] / 2, res
