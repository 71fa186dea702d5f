"""``train.steps_per_launch``: K optimizer steps per launch (on the card one
CUDA graph, ``Distiller.train_step_chain``), checked on the CPU where no
graph can be captured: the loop's grouping against the JAX package's, the
chain as K single steps, ``max_steps``, the kernels' seed tensors against
their host words, the host draws a graph replay restages, and the gloo refusal."""

import dataclasses

import numpy as np
import pytest
import torch

from fithubert_tpu.train import loop as jloop
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.ops import specaug
from fithubert_tpu_torch.ops.attention import attention_with_taps
from fithubert_tpu_torch.ops.dropout import DropoutRNG, host_streams
from fithubert_tpu_torch.ops.kernels import dropout as kd
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels.philox import keep_bits, philox4x32, pick_word, seed_tensor
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.step import _Staged, check_graphable
from fithubert_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(2)


def _batch(t, tag):
    return {"x": np.zeros((2, t)), "padding_mask": np.zeros((2, t), bool), "_tag": tag}


SEQUENCES = {
    "shape_changes": [100, 100, 100, 200, 200, 100],
    "one_shape": [100] * 7,
    "alternating": [100, 200, 100, 200],
}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_launch_groups_match_the_jax_loop(seq, k):
    pairs = [(b, b) for b in (_batch(t, i) for i, t in enumerate(SEQUENCES[seq]))]
    got = [[raw["_tag"] for raw, _d in run] for run in loop._launch_groups(pairs, k)]
    want = [[raw["_tag"] for raw, _d in run] for run in jloop._launch_groups(pairs, k)]
    assert got == want


@pytest.mark.parametrize("k, n", [(4, 4), (3, 4), (1, 4), (1, 1), (2, 2)])
def test_use_chain_matches_the_jax_loop(k, n):
    assert loop._use_chain(k, n) == jloop._use_chain(k, n)


def test_step_timer_counts_every_step_of_a_launch():
    timer = StepTimer(sync_every=4, device=torch.device("cpu"))
    timer.tick()  # anchors the clock
    timer.tick(audio_sec=2.0, steps=3)
    rates = timer.tick(audio_sec=2.0, steps=3)
    assert timer._n == 6 and timer._audio == 4.0
    assert rates["steps_per_sec"] > 0


def _smoke(out_dir, **train):
    cfg = tc.load_experiment_yaml("configs/smoke.yaml")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, synthetic_num_batches=8, synthetic_wav_length=8000),
        train=dataclasses.replace(cfg.train, output_dir=str(out_dir), log_every=1, **train))


def test_run_training_with_two_steps_per_launch_respects_max_steps(tmp_path):
    """As the JAX loop (tests/test_loop.py): a launch is K steps, so a run
    may overshoot max_steps by fewer than K."""
    result = loop.run_training(_smoke(tmp_path, max_steps=6, steps_per_launch=2),
                               resume=False, device="cpu")
    assert 6 <= result["steps"] <= 7


def _distiller():
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.train.step import Distiller

    cfg = tc.load_experiment_yaml("configs/smoke.yaml")
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry.from_teacher_config(cfg.teacher)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(cfg.distiller, device="cpu").init_weights(gen).state_dict()
    return Distiller(cfg, t_state, s_state, device="cpu", num_training_steps=10)


def test_a_chain_on_the_cpu_is_k_single_steps_bit_for_bit():
    rng = np.random.default_rng(0)
    batches = [{"x": (rng.standard_normal((1, 2, 4000)) * 0.3).astype(np.float32),
                "padding_mask": np.zeros((1, 2, 4000), bool)} for _ in range(3)]
    rand = torch.tensor([0])
    chained, single = _distiller(), _distiller()
    got = [lg.to_floats() for lg in chained.train_step_chain(batches, rand)]
    want = [single.train_step(b, rand) for b in batches]
    assert got == want and chained.step == single.step == 3
    for p, q in zip(chained.params, single.params):
        assert torch.equal(p, q)


def _words(seed):
    """Two host words and the seed tensor made from them."""
    host = tuple(int(w) for w in np.random.default_rng(seed).integers(0, 2 ** 32, 2))
    return host, seed_tensor(*host)


def test_attention_fed_seed_words_from_a_tensor_equals_host_words():
    """K2's forward and K3/K4's backward (their plain versions here), fed a
    seed tensor, drop the probabilities Philox keeps under the host words it
    was made from: the mask is the one drawn from the words as Python ints,
    the output is the softmax dropped by that mask, and the gradients are
    autograd's through it (to 1e-5: the backward's formulas sum in another
    order than autograd's)."""
    rng = np.random.default_rng(1)
    b, t, h, d, p = 2, 24, 2, 12, 0.2
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               for _ in range(3))
    q = q * d ** -0.5  # pre-scaled, as the callers pass it
    for x in (q, k, v):
        x.requires_grad_()
    host, bits = _words(2)
    z = torch.arange(b * h).view(b, h, 1, 1)
    i = torch.arange(t).view(1, 1, t, 1)
    j = torch.arange(t).view(1, 1, 1, t)
    words = philox4x32(j >> 2, i, z, torch.zeros_like(j), host)
    keep = keep_bits(pick_word(words, (j & 3).expand(b, h, t, t)), p)
    assert torch.equal(fa.keep_mask(b, h, t, p, bits), keep)
    out = fa.flash_attention(q, k, v, None, dropout_p=p, seed=bits)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1) * keep * (1.0 / (1.0 - p))
    want = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = torch.autograd.grad(want.square().sum(), (q, k, v))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_seeded_dropout_fed_seed_words_from_a_tensor_equals_host_words():
    """K5 (its plain version here), fed a seed tensor, keeps what Philox
    keeps under the host words as Python ints, forward and backward."""
    x = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0), requires_grad=True)
    host, bits = _words(3)
    e = torch.arange(x.numel())
    zero = torch.zeros((), dtype=torch.int64)
    keep = keep_bits(pick_word(philox4x32(e >> 2, e >> 34, zero, zero, host), e & 3), 0.3)
    inv = float(torch.tensor(1.0 / 0.7, dtype=torch.float32))
    y = kd.seeded_dropout(x, bits, 0.3)
    assert torch.equal(y, torch.where(keep.view(x.shape), x * inv, 0.0))
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.where(keep.view(x.shape), inv, 0.0))


def test_taps_attention_draws_its_seed_from_the_table():
    """The materialised branch drops its probabilities with K5 seeded by
    the forward's next slot of the table, a (2,) int32 view."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    out, _taps = attention_with_taps(q, k, v, None, 0.3, DropoutRNG(11, "cpu"))
    words = DropoutRNG(11, "cpu").table[0]
    assert words.dtype == torch.int32 and words.shape == (2,)
    want, _ = attention_with_taps(q, k, v, None, 0.0, None)
    assert not torch.equal(out, want)  # something was dropped
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = kd.seeded_dropout_plain(torch.softmax(logits, -1), words, 0.3)
    torch.testing.assert_close(out, torch.einsum("bhqk,bkhd->bqhd", probs, v), rtol=1e-6,
                               atol=1e-6)


def test_staged_draws_replay_the_eager_draws(monkeypatch):
    """What a graph replay writes into its static tensors: the warm-up
    notes the draws' shapes, the static tensors are made at them, and each
    draw function the capture keeps, run on fresh host streams of the
    step's seeds, gives what an eager DropoutRNG of those seeds draws, its
    table and SpecAugment's draws alike, in the same order."""
    cfg = tc.SpecAugConfig(apply_time_warp=True, freq_mask_width_range=(0, 5),
                           time_mask_width_range=(0, 8))
    spec = torch.randn(3, 50, 20, generator=torch.Generator().manual_seed(0))
    staged = _Staged()
    specaug.staged_spec_augment(DropoutRNG(5, "cpu", specaug_seed=6,
                                           stage=staged.record(0, 0)), spec, cfg)
    staged.allocate(torch.device("cpu"))
    with monkeypatch.context() as m:  # the static tensors are not filled here
        m.setattr(specaug, "apply_spec_augment", lambda spec, *args: spec)
        specaug.staged_spec_augment(DropoutRNG(5, "cpu", specaug_seed=6,
                                               stage=staged.stage(0, 0)), spec, cfg)
    streams = host_streams(5, 6)
    replayed = [draw(streams) for (_k, _i, draw, _dst) in staged.entries]
    eager = []

    def stage(rng, draw):
        eager.append(draw(rng))
        return eager[-1]

    specaug.staged_spec_augment(DropoutRNG(5, "cpu", specaug_seed=6, stage=stage), spec, cfg)
    assert len(replayed) == len(eager) == 2  # the table, then SpecAugment's draws
    for got, want, (_k, _i, _draw, dst) in zip(replayed, eager, staged.entries):
        assert len(got) == len(want) == len(dst)
        for a, b, d in zip(got, want, dst):
            assert torch.equal(a, b) and a.shape == d.shape


@pytest.mark.parametrize("over, t", [
    (dict(apply_time_warp=True), 50),
    (dict(apply_time_warp=True), 10),  # too short to warp: t <= 2 windows
    (dict(adaptive=True, adaptive_number_ratio=0.01), 50),  # no time mask fits
    (dict(apply_freq_mask=False, num_time_mask=0), 50),
])
def test_the_staged_structure_is_what_spec_augment_draws(over, t):
    """Under a capture the draws are not made, so which of (warp, freq,
    time) a shape draws comes from the config alone; it must be what
    ``draw_spec_augment`` gives."""
    cfg = dataclasses.replace(tc.SpecAugConfig(), **over)
    draws = specaug.draw_spec_augment(torch.Generator().manual_seed(0), cfg, 2, t, 16)
    assert specaug._present(cfg, t, 16) == tuple(x is not None for x in draws)


@pytest.mark.parametrize("device, backend, raises", [
    ("cuda", "gloo", True), ("cuda", "nccl", False), ("cpu", "gloo", False)])
def test_steps_per_launch_refuses_host_collectives_on_the_card(device, backend, raises):
    """A gloo group's collectives run on the host and a CUDA graph cannot
    capture them: the chain and the loop raise, naming the backend."""
    if raises:
        with pytest.raises(ValueError, match="gloo"):
            check_graphable(torch.device(device), backend)
    else:
        check_graphable(torch.device(device), backend)
