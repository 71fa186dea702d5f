"""The port's mel front-end (ops/mel.py), MelSpecHead (ops/heads.py),
SpecAugment (ops/specaug.py) and the mel student, its train step, loop and
expert, against the JAX package on the same numpy-seeded inputs and carried
weights, on the CPU.

Tolerances: fp32 on both sides is the same arithmetic in another summation
order (the FFT of two libraries too) at O(1) values: F32_TOL. bf16 is held
against the JAX package's bf16: at most BF16_FACTOR times the JAX package's
own bf16-vs-fp32 difference. SpecAugment's apply step is held bit for bit
on JAX's draws: its inputs are multiples of 1/64 below 8, so every partial
sum of the replacement mean is exact in fp32 and the mean does not depend
on the summation order."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fithubert_tpu.config import ExperimentConfig as JExperimentConfig
from fithubert_tpu.config import LossConfig as JLossConfig
from fithubert_tpu.config import OptimizerConfig as JOptimizerConfig
from fithubert_tpu.config import SpecAugConfig as JSpecAugConfig
from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.config import TeacherConfig as JTeacherConfig
from fithubert_tpu.config import TrainConfig as JTrainConfig
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.models import student as jstudent_module
from fithubert_tpu.ops import heads as jheads
from fithubert_tpu.ops import mel as jmel
from fithubert_tpu.ops import specaug as jspec
from fithubert_tpu.parallel import make_mesh
from fithubert_tpu.train.step import Distiller as JDistiller
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops import mel as pmel
from fithubert_tpu_torch.ops import specaug as pspec
from fithubert_tpu_torch.ops.dropout import DropoutRNG
from fithubert_tpu_torch.ops.heads import MelSpecHead
from fithubert_tpu_torch.parallel import distributed as pd
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_FACTOR = 2.0
# a stride-320 teacher extractor (the mel hop), so both sides have T' frames
T_SPEC = ((32, 10, 5), (32, 8, 4), (32, 4, 4), (32, 4, 4))
MEL = dict(n_mels=16, enable_log_mel=True, mel_spec_head_conv_layers=((24, 5, 1), (40, 3, 1)),
           conv_feature_layers=(), encoder_layers=2, encoder_embed_dim=32,
           encoder_ffn_embed_dim=48, encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
           pred_head_final_dim=32, pred_layer_id=(1,), layerwise_proj=True,
           enable_tr_layer=False, required_seq_len_multiple=1)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
# masks that fit 12 frames and 16 mels
SPECAUG = dict(freq_mask_width_range=(0, 5), num_freq_mask=2, time_mask_width_range=(0, 4),
               num_time_mask=2)


def _pair(dtype="float32", **over):
    kw = {**MEL, **NO_DROPOUT, **over}
    return (JConfig(**kw, compute_dtype=dtype, use_pallas_attention=False,
                    use_pallas_conv=False),
            tc.StudentConfig(**kw, compute_dtype=dtype))


def _f(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _params(jcfg, seed=0):
    """The JAX student's params: the port's seeded init perturbed, mapped by
    the JAX package's importer (a JAX init would compile for seconds).
    Cached: read, do not write."""
    tcfg = tc.StudentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tc.StudentConfig)})
    model = StudentModel(dataclasses.replace(tcfg, compute_dtype="float32"), device="cpu")
    sd = model.init_weights(torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in sd.items()}
    return map_student_state_dict(sd, dataclasses.replace(jcfg, compute_dtype="float32"))


def _batch(n=4000, seed=1):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((3, n)) * 0.3).astype(np.float32)
    mask = np.zeros((3, n), bool)
    mask[1, 2900:] = True
    mask[2] = True
    wav[mask] = 0.0
    return wav, mask


# ------------------------------------------------------------ the front-end
@pytest.mark.parametrize("n_mels", [16, 40, 80])
def test_mel_filterbank_equals_jax(n_mels):
    np.testing.assert_array_equal(pmel.mel_filterbank(n_mels), jmel.mel_filterbank(n_mels))


@pytest.mark.parametrize("log", [False, True])
def test_mel_spectrogram_matches_jax(log):
    """Periodic Hann, center=False, power 2, HTK, norm=None; the frame
    count 1 + (T - 400) // 320 (odd lengths included). The two FFTs sum in
    other orders: relative 1e-4 of the power, the log to 1e-4."""
    rng = np.random.default_rng(0)
    for n in (400, 719, 4000, 6401):
        wav = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
        want = np.asarray(jmel.mel_spectrogram(jnp.asarray(wav), 40, log=log))
        got = pmel.mel_spectrogram(torch.from_numpy(wav), 40, log=log).numpy()
        assert got.shape == want.shape == (2, 1 + (n - 400) // 320, 40)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 if log else 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mel_spec_head_matches_jax(dtype):
    """Stride 1, padding k // 2, ReLU between the convs, keys
    conv_layers.{i}; bf16 within BF16_FACTOR of JAX's own bf16 error."""
    layers = ((24, 5, 1), (40, 3, 1), (8, 4, 1))  # an even k grows T by one
    x = np.random.default_rng(2).standard_normal((2, 13, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmod = jheads.MelSpecHead(layers, dtype=jdt)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.01),
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))["params"])
    want = _f(jmod.apply({"params": params}, jnp.asarray(x, jdt)))
    head = MelSpecHead(16, layers)
    head.load_state_dict({f"conv_layers.{i}.{n}": torch.from_numpy(np.ascontiguousarray(
        params[f"conv_{i}"]["kernel"].transpose(2, 1, 0) if n == "weight"
        else params[f"conv_{i}"]["bias"])) for i in range(3) for n in ("weight", "bias")},
        strict=True)
    got = _f(head(torch.from_numpy(x).to(getattr(torch, dtype))))
    assert got.shape == want.shape == (2, 14, 8)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        ref = _f(jheads.MelSpecHead(layers).apply({"params": params}, jnp.asarray(x)))
        assert np.abs(got - want).max() <= BF16_FACTOR * np.abs(want - ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mel_student_matches_jax(dtype):
    """The mel student deterministic (no SpecAugment): log-mel in fp32 cast
    to the compute dtype, MelSpecHead, LayerNorm, the mel frame formula's
    padding mask, the encoder and heads; ragged and fabricated rows."""
    jcfg, tcfg = _pair(dtype)
    params = _params(jcfg)
    wav, mask = _batch()
    model = StudentModel(tcfg, device="cpu")
    model.load_state_dict(jax_student_params_to_state_dict(params, tcfg), strict=True)
    assert model.feature_extractor is None
    out = model(torch.from_numpy(wav), torch.from_numpy(mask))
    run = lambda cfg: jax.jit(lambda p, w, m: JStudent(cfg).apply({"params": p}, w, m))(  # noqa
        params, jnp.asarray(wav), jnp.asarray(mask))
    jout = run(jcfg)
    np.testing.assert_array_equal(out.padding_mask.numpy(), np.asarray(jout.padding_mask))
    assert (~out.padding_mask).sum(-1).tolist() == [1 + (4000 - 400) // 320,
                                                     1 + (2900 - 400) // 320, 0]
    pairs = [(out.x, jout.x), (out.features, jout.features)] + [
        (h, jh) for (h, _, _), (jh, _, _) in zip(out.layer_results, jout.layer_results)]
    if dtype == "float32":
        for got, want in pairs:
            np.testing.assert_allclose(_f(got)[:2], _f(want)[:2], **F32_TOL)
        return
    j32 = run(_pair("float32")[0])
    refs = [j32.x, j32.features] + [jh for (jh, _, _) in j32.layer_results]
    for (got, want), ref in zip(pairs, refs):
        own = np.abs(_f(want)[:2] - _f(ref)[:2]).max()
        assert np.abs(_f(got)[:2] - _f(want)[:2]).max() <= BF16_FACTOR * own


def _jit_student_init(monkeypatch):
    """The JAX StudentModel's init under jax.jit (eagerly it compiles op by
    op for seconds); the same draws, summed in XLA's order."""
    real = JStudent.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: real(self, r, *a, **kwargs))(rngs, *args)

    monkeypatch.setattr(JStudent, "init", init)


def test_golden_mel_fwd_through_carried_weights(monkeypatch):
    """tests/goldens/mel_fwd.npz: build_mel's JAX-initialised weights carried
    to the port give the golden output."""
    import os

    from scripts.make_goldens import build_mel

    _jit_student_init(monkeypatch)
    model, variables, wav, mask = build_mel()
    jcfg = model.cfg
    tcfg = tc.StudentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tc.StudentConfig)})
    port = StudentModel(tcfg, device="cpu")
    port.load_state_dict(jax_student_params_to_state_dict(variables["params"], tcfg),
                         strict=True)
    out = port(torch.tensor(np.asarray(wav)), torch.tensor(np.asarray(mask)))
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "mel_fwd.npz"))
    np.testing.assert_allclose(out.x.numpy(), g["x"], **F32_TOL)


# ----------------------------------------------------------------- SpecAugment
def _jax_draws(key, cfg, b, t, d):
    """The draws of fithubert_tpu/ops/specaug.py spec_augment under ``key``,
    recomputed as its _mask_along_axis and _time_warp make them."""
    k_warp, k_freq, k_time = jax.random.split(key, 3)

    def mask(k, length, width_range, n, time_axis):
        n, lo, hi = pspec.mask_shape(length, tuple(width_range), n, time_axis, cfg.adaptive,
                                     cfg.adaptive_number_ratio, cfg.adaptive_size_ratio,
                                     cfg.max_n_time_masks) if time_axis else \
            pspec.mask_shape(length, tuple(width_range), n, False)
        if n <= 0:
            return None
        k_len, k_pos = jax.random.split(k)
        widths = jax.random.randint(k_len, (b, n, 1), lo, hi)
        bound = jnp.maximum(1, length - jnp.max(widths)).astype(jnp.float32)
        pos = jnp.floor(jax.random.uniform(k_pos, (b, n, 1)) * bound).astype(jnp.int32)
        return pspec.MaskDraw(torch.tensor(np.asarray(widths)).long(),
                              torch.tensor(np.asarray(pos)).long())

    warp = freq = time = None
    if cfg.apply_time_warp and t - cfg.time_warp_window > cfg.time_warp_window:
        w = cfg.time_warp_window
        kc, kw = jax.random.split(k_warp)
        center = jax.random.randint(kc, (b,), w, t - w)
        warped = jnp.clip(jax.random.randint(kw, (b,), -w, w) + center + 1, 1, t - 1)
        warp = pspec.WarpDraw(torch.tensor(np.asarray(center)).long(),
                              torch.tensor(np.asarray(warped)).long())
    if cfg.apply_freq_mask:
        freq = mask(k_freq, d, cfg.freq_mask_width_range, cfg.num_freq_mask, False)
    if cfg.apply_time_mask:
        time = mask(k_time, t, cfg.time_mask_width_range, cfg.num_time_mask, True)
    return pspec.SpecAugDraws(warp, freq, time)


def _exact_spec(b=3, t=120, d=40, seed=0, denom=64):
    """Multiples of 1 / denom in [0, 8) whose mean is one too: every partial
    sum of the batch is exact in fp32, before the masks and after the
    first mean fills them, so the means do not depend on the summation
    order. denom 16 keeps every value exact in bf16."""
    v = np.random.default_rng(seed).integers(0, 8 * denom, (b, t, d)).reshape(-1)
    excess, i = int(v.sum() % v.size), 0
    while excess:  # lower a few entries until the sum divides by the count
        take = min(excess, int(v[i]))
        v[i] -= take
        excess -= take
        i += 1
    return (v.reshape(b, t, d) / denom).astype(np.float32)


SPECAUG_CASES = {
    "release": dict(freq_mask_width_range=(0, 27)),
    "zero": dict(replace_with_zero=True, freq_mask_width_range=(3, 9)),
    "adaptive": dict(adaptive=True, time_mask_width_range=(0, 50)),
    "empty_range": dict(freq_mask_width_range=(4, 4), time_mask_width_range=(0, 0)),
    # the interpolation leaves multiples of 1/64, so no mean would be exact
    "time_warp": dict(apply_time_warp=True, time_warp_window=5, replace_with_zero=True),
}


@pytest.mark.parametrize("case", list(SPECAUG_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_augment_apply_on_jax_draws_is_jax_bit_for_bit(case, seed):
    """The port's apply step on the draws JAX makes from the same key equals
    the JAX spec_augment bit for bit, lengths zeroing included."""
    over = SPECAUG_CASES[case]
    jcfg, pcfg = JSpecAugConfig(**over), tc.SpecAugConfig(**over)
    spec = _exact_spec(seed=seed)
    lengths = np.array([120, 101, 0])
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jspec.spec_augment(key, jnp.asarray(spec), jcfg,
                                         lengths=jnp.asarray(lengths)))
    draws = _jax_draws(key, jcfg, *spec.shape)
    got = pspec.apply_spec_augment(torch.from_numpy(spec), draws, pcfg,
                                   lengths=torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], spec[0]) or case == "empty_range"


def test_spec_augment_apply_bf16_on_jax_draws_is_jax_bit_for_bit():
    """bf16 (the student applies SpecAugment to features in the compute
    dtype): the mean is summed in fp32 and rounded to bf16 on both sides."""
    cfg = dict(freq_mask_width_range=(0, 27))
    spec = _exact_spec(seed=4, denom=16)
    key = jax.random.PRNGKey(11)
    want = _f(jspec.spec_augment(key, jnp.asarray(spec, jnp.bfloat16), JSpecAugConfig(**cfg)))
    got = pspec.apply_spec_augment(torch.from_numpy(spec).to(torch.bfloat16),
                                   _jax_draws(key, JSpecAugConfig(**cfg), *spec.shape),
                                   tc.SpecAugConfig(**cfg))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f(got), want)


@settings(max_examples=40, deadline=None, database=None)
@given(b=st.integers(1, 5), t=st.integers(1, 60), d=st.integers(1, 40),
       f_lo=st.integers(0, 6), f_span=st.integers(0, 12), t_lo=st.integers(0, 6),
       t_span=st.integers(0, 30), n_f=st.integers(0, 3), n_t=st.integers(0, 3),
       adaptive=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
def test_own_draws_keep_espnet_semantics(b, t, d, f_lo, f_span, t_lo, t_span, n_f, n_t,
                                         adaptive, seed):
    """The port's draws: widths in [lo, max(hi, lo + 1)), positions in
    [0, max(1, L - the largest width)), one bound per batch, adaptive
    clamps on the time axis only, and the same seed draws the same masks;
    the masked frames and mels are exactly the drawn bands, replaced by the
    batch's mean."""
    cfg = tc.SpecAugConfig(freq_mask_width_range=(f_lo, f_lo + f_span), num_freq_mask=n_f,
                           time_mask_width_range=(t_lo, t_lo + t_span), num_time_mask=n_t,
                           adaptive=adaptive)
    draws = pspec.draw_spec_augment(torch.Generator().manual_seed(seed), cfg, b, t, d)
    again = pspec.draw_spec_augment(torch.Generator().manual_seed(seed), cfg, b, t, d)
    for axis_len, draw, other, (lo, hi), n, time_axis in (
            (d, draws.freq, again.freq, cfg.freq_mask_width_range, n_f, False),
            (t, draws.time, again.time, cfg.time_mask_width_range, n_t, True)):
        n_want, lo_want, hi_want = pspec.mask_shape(axis_len, (lo, hi), n, time_axis, adaptive)
        if not time_axis or not adaptive:
            assert (n_want, lo_want, hi_want) == (n, lo, max(hi, lo + 1))
        if n_want <= 0:
            assert draw is None
            continue
        assert draw.widths.shape == (b, n_want, 1)
        assert torch.equal(draw.widths, other.widths)
        assert torch.equal(draw.positions, other.positions)
        assert int(draw.widths.min()) >= lo_want and int(draw.widths.max()) < hi_want
        bound = max(1, axis_len - int(draw.widths.max()))
        assert int(draw.positions.min()) >= 0 and int(draw.positions.max()) < bound
    spec = torch.arange(1, b * t * d + 1, dtype=torch.float32).reshape(b, t, d)
    out = pspec.apply_spec_augment(spec, pspec.SpecAugDraws(None, draws.freq, None), cfg)
    hit = torch.zeros(b, d, dtype=torch.bool)
    if draws.freq is not None:
        for i in range(b):
            for p, w in zip(draws.freq.positions[i, :, 0].tolist(),
                            draws.freq.widths[i, :, 0].tolist()):
                hit[i, p:p + w] = True
    mean = spec.sum() * (1.0 / torch.tensor(float(spec.numel())))
    assert torch.equal(out, torch.where(hit[:, None, :], mean, spec))


# -------------------------------------------------------------- the train step
# the release's loss (rec mse, no cosine term: the cosine of the fabricated
# row's zero vectors has a NaN gradient on both sides)
LOSS = dict(rec_loss_weight=1.0, rec_loss_type="mse", sim_loss_weight=0.0,
            distil_random_layer=0, random_layer_weight=0.0)
OPT = dict(lr=5e-3, warmup_proportion=0.2, betas=(0.9, 0.98), eps=1e-6, weight_decay=1e-6)
TRAIN = dict(batch_size=2, accumulate_grad_batches=2, fuse_grad_accum=True, use_fp16=False,
             specaug=True)
TEACHER = dict(conv_feature_layers=T_SPEC, encoder_layers=2, encoder_embed_dim=32,
               encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16,
               conv_pos_groups=4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _step_batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = (rng.standard_normal((2, 2, 4000)) * 0.3).astype(np.float32)
        mask = np.zeros((2, 2, 4000), bool)
        mask[0, 1, 2900:] = True  # ragged
        mask[1, 1] = True  # fabricated: all padding
        x[mask] = 0.0
        out.append({"x": x, "padding_mask": mask})
    return out


def _experiments(jcfg, tcfg):
    teacher = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                   encoder_attention_heads=4)
    jexp = JExperimentConfig(teacher=JTeacherConfig(**teacher), train=JTrainConfig(**TRAIN),
                             loss=JLossConfig(**LOSS), distiller=jcfg,
                             optimizer=JOptimizerConfig(**OPT),
                             specaug=JSpecAugConfig(**SPECAUG))
    texp = tc.ExperimentConfig(teacher=tc.TeacherConfig(**teacher),
                               train=tc.TrainConfig(**TRAIN), loss=tc.LossConfig(**LOSS),
                               distiller=tcfg, optimizer=tc.OptimizerConfig(**OPT),
                               specaug=tc.SpecAugConfig(**SPECAUG))
    return jexp, texp


def test_mel_specaug_distiller_two_fp32_steps_match_jax(monkeypatch):
    """A mel + SpecAugment step (2 microbatches folded into 4 rows, a ragged
    and a fabricated row, no dropout) whose SpecAugment draws are the ones
    the JAX step makes from the key its spec_augment gets: loss, grad_norm,
    lr and every parameter after each of two steps."""
    jcfg, tcfg = _pair()
    jexp, texp = _experiments(jcfg, tcfg)
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=10,
                    teacher_geometry=JGeometry(**TEACHER, use_pallas_attention=False))
    wav = jnp.zeros((2, 4000), jnp.float32)
    tp = jax.jit(jd.init_teacher_params)(jax.random.PRNGKey(0), wav)
    state = jax.jit(jd.init_state)(jax.random.PRNGKey(1), wav)
    geom = TeacherGeometry(**TEACHER)
    pd_ = Distiller(texp, jax_teacher_params_to_state_dict(tp["params"], geom),
                    jax_student_params_to_state_dict(state.params, tcfg), device="cpu",
                    num_training_steps=10, teacher_geometry=geom)
    key = jax.random.PRNGKey(2)
    keys, calls = [], []  # the keys JAX's spec_augment gets (flax folds its own in)

    def recording(k, spec, cfg, lengths=None):
        jax.debug.callback(lambda k_: keys.append(np.asarray(k_)), k)
        return jspec.spec_augment(k, spec, cfg, lengths)

    def jax_draws(gen, cfg, b, t, d):
        calls.append(b)
        return _jax_draws(jnp.asarray(keys[len(calls) - 1]), jexp.specaug, b, t, d)

    monkeypatch.setattr(jstudent_module, "spec_augment", recording)
    monkeypatch.setattr(pspec, "draw_spec_augment", jax_draws)
    step = jd.make_train_step()
    for i, batch in enumerate(_step_batches(2)):
        state, jl = step(jax.tree_util.tree_map(jnp.copy, state), tp,
                         jax.tree_util.tree_map(jnp.asarray, batch),
                         jnp.zeros((0,), jnp.int32), key)
        want = {k: float(v) for k, v in jl.items()}  # waits for the step and its callback
        got = pd_.train_step(batch, None)
        assert set(got) == set(want) and np.isfinite(got["grad_norm"])
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, err_msg=f"step {i} {k}", **LOSS_TOL)
        want_sd = jax_student_params_to_state_dict(jax.device_get(state.params), tcfg)
        got_sd = pd_.student.state_dict()
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       err_msg=f"step {i} {k}", **PARAM_TOL)
    assert calls == [4, 4]  # one draw per step, over the 4 folded rows


def test_specaug_draws_are_the_host_streams_and_eval_has_none():
    """The draws come from the DropoutRNG's third (host) stream: the same
    step seed draws the same masks whatever the other streams did; eval and
    serving forwards draw none."""
    _, tcfg = _pair()
    cfg = tc.SpecAugConfig(**SPECAUG)
    model = StudentModel(tcfg, device="cpu", specaug=cfg).init_weights(
        torch.Generator().manual_seed(0))
    wav, mask = _batch()
    x, m = torch.from_numpy(wav), torch.from_numpy(mask)
    a = DropoutRNG(7, "cpu")
    a.seed_words()  # the host stream moves; the SpecAugment stream does not
    f1 = model.forward_train(x, m, a).features
    f2 = model.forward_train(x, m, DropoutRNG(7, "cpu")).features
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    f3 = model.forward_train(x, m, DropoutRNG(7, "cpu", specaug_seed=8)).features
    assert not torch.equal(f1, f3)
    torch.testing.assert_close(model(x, m).features, model.forward_train(x, m).features,
                               rtol=0, atol=0)


def test_stripe_rows_index_the_global_batch():
    """Distiller._stripe: the rows a rank holds (``[:, rank::world]`` of
    each microbatch, folded b-major as the step folds them) are the stripe's
    rows of the global batch folded the same way."""
    a, b_local, world = 3, 2, 2
    glob = torch.arange(a * b_local * world).reshape(a, b_local * world)
    fold = lambda x: x.transpose(0, 1).reshape(-1)  # noqa: E731
    for rank in range(world):
        d = Distiller.__new__(Distiller)
        d.dp = pd.DataParallel(rank, world)
        d.student = type("S", (), {"specaug": tc.SpecAugConfig()})()
        for folded in (a, 1):
            local = glob[:, rank::world]
            stripe = d._stripe(folded, b_local)
            if folded == 1:  # microbatch by microbatch
                for i in range(a):
                    assert torch.equal(glob[i][stripe.rows], local[i])
            else:
                assert torch.equal(fold(glob)[stripe.rows], fold(local))
            assert stripe.n_rows == folded * b_local * world


def test_two_ranks_with_specaug_take_the_one_process_step(tmp_path):
    """Two gloo ranks, each on its stripe of a mel + SpecAugment batch,
    take the step one process takes on the whole batch: the same masks
    (the seed is free of the rank, the draws the global batch's) and the
    global mean. fp32, no dropout: logs and parameters to summation order."""
    from tests import test_torch_ddp_worker

    _, tcfg = _pair()
    _, texp = _experiments(None, tcfg)
    texp = dataclasses.replace(texp, train=dataclasses.replace(texp.train, num_devices=2))
    geom = TeacherGeometry(**TEACHER)
    gen = torch.Generator().manual_seed(0)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(tcfg, device="cpu").init_weights(gen).state_dict()
    batch = _step_batches(1)[0]
    one = Distiller(texp, t_state, s_state, device="cpu", teacher_geometry=geom)
    want = one.train_step(batch, None)
    ranks = pd.launch(test_torch_ddp_worker.specaug_step_rank, 2, texp, t_state, s_state, geom,
                      batch, timeout=240)
    for logs, params in ranks:
        for k, w in want.items():
            np.testing.assert_allclose(logs[k], w, err_msg=k, **LOSS_TOL)
        for k, v in one.student.state_dict().items():
            np.testing.assert_allclose(params[k], v.numpy(), err_msg=k, **PARAM_TOL)


# ------------------------------------------------------ loop, expert, configs
def _loop_config(out_dir, **train):
    """mel_experiment at a small width, with synthetic data."""
    cfg = tc.mel_experiment()
    return dataclasses.replace(
        cfg,
        teacher=dataclasses.replace(cfg.teacher, teacher_model="",
                                    **{k: v for k, v in TEACHER.items()
                                       if k.startswith("encoder")}),
        distiller=dataclasses.replace(cfg.distiller, **MEL, compute_dtype="float32"),
        loss=dataclasses.replace(cfg.loss, distil_random_layer=1),
        specaug=dataclasses.replace(cfg.specaug, **SPECAUG),
        data=dataclasses.replace(cfg.data, synthetic=True, synthetic_num_batches=4,
                                 synthetic_wav_length=4000, length_quantum=1000),
        train=dataclasses.replace(cfg.train, **{"output_dir": str(out_dir), "num_epochs": 2,
                                                "use_fp16": False, "log_every": 1,
                                                "num_devices": 1, "batch_size": 2,
                                                "accumulate_grad_batches": 2, **train}))


def test_mel_loop_trains_resumes_bit_for_bit_and_serves_without_specaug(tmp_path,
                                                                        monkeypatch):
    """run_training of a small mel + SpecAugment student (train_torch.py's
    path with --device cpu): a run stopped at max_steps 2 and resumed gives
    the uninterrupted run's losses bit for bit; the export serves without
    SpecAugment (two calls agree bit for bit, and with the model's
    deterministic forward)."""
    monkeypatch.setattr(TeacherGeometry, "from_teacher_config",
                        classmethod(lambda cls, t: cls(**TEACHER)))
    full = loop.run_training(_loop_config(tmp_path / "full"), resume=False, device="cpu")
    first = loop.run_training(_loop_config(tmp_path / "r", max_steps=2), resume=False,
                              device="cpu")
    second = loop.run_training(_loop_config(tmp_path / "r"), resume=True, device="cpu")
    assert (full["steps"], first["steps"], second["steps"]) == (4, 2, 4)

    def losses(d):
        with open(d / "metrics.jsonl") as f:
            return {r["step"]: (r["loss"], r["grad_norm"]) for r in map(json.loads, f)
                    if "loss" in r}

    assert losses(tmp_path / "r") == losses(tmp_path / "full")
    expert = UpstreamExpert(str(tmp_path / "full" / "student.pt"),
                            str(tmp_path / "full" / "student.yaml"), device="cpu")
    assert expert.model.specaug is None and expert.get_downsample_rates() == 320
    wavs = [np.random.default_rng(0).standard_normal(4000).astype(np.float32) * 0.1,
            np.ones(2900, np.float32) * 0.1]
    out, again = expert(wavs), expert(wavs)
    torch.testing.assert_close(out["last_hidden_state"], again["last_hidden_state"],
                               rtol=0, atol=0)
    assert (~out["padding_mask"]).sum(-1).tolist() == [12, 8]


def test_mel_expert_matches_the_jax_export_model(tmp_path):
    """The mel student served (export model: the last head only) against the
    JAX package's disable_projections forward on the same padded batch."""
    jcfg, tcfg = _pair(enable_tr_layer=True, tr_layer_type="conv1d", tr_layer_index=0)
    params = _params(jcfg, seed=3)
    sd = jax_student_params_to_state_dict(params, tcfg)
    expert = UpstreamExpert(sd, tcfg, device="cpu", length_quantum=1000)
    wav, mask = _batch(seed=5)
    got = expert([wav[0], wav[1, :2900]])
    jparams = {k: v for k, v in params.items() if k != "proj_head_0"}
    jout = jax.jit(lambda p, w, m: JStudent(jcfg, disable_projections=True).apply(
        {"params": p}, w, m))(jparams, jnp.asarray(wav[:2]), jnp.asarray(mask[:2]))
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(jout.padding_mask))
    np.testing.assert_allclose(_f(got["last_hidden_state"]), _f(jout.x), **F32_TOL)


def test_mel_experiment_is_the_release_yaml_with_the_mel_front_end():
    """mel_experiment() is configs/fithubert.yaml with n_mels 80,
    enable_log_mel and train.specaug, as both loaders read such a file."""
    from fithubert_tpu.config import config_from_yaml_dict as j_config_from_yaml_dict

    raw = tc.read_yaml("configs/fithubert.yaml")
    raw["distiller"] = dict(raw["distiller"], n_mels=80, enable_log_mel=True)
    raw["train"] = dict(raw["train"], specaug=True)
    port, ref = tc.config_from_yaml_dict(raw), j_config_from_yaml_dict(raw)
    assert tc.mel_experiment() == port
    assert port.distiller.embed == ref.distiller.embed == 512
    assert port.distiller.downsample_rate == ref.distiller.downsample_rate == 320
    for section in ("teacher", "train", "loss", "distiller", "optimizer", "specaug"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), f"{section}.{f.name}"
    assert port.specaug.freq_mask_width_range == (0, 27)
    assert port.specaug.time_mask_width_range == (0, 100)
