"""The port's conformer family (ops/conformer.py, the abs conformer layers of
ops/transformer.py, the student's dispatch, the BatchNorm state in the step,
the loop and the expert) against the JAX package on the same numpy-seeded
inputs and carried weights, on the CPU.

Tolerances: fp32 on both sides is the same arithmetic in another summation
order at O(1) values: F32_TOL. bf16 is held against the JAX package's bf16
(both round at the same places, but for the summation order and the
libraries' transcendental functions): at most BF16_FACTOR times the JAX
package's own bf16-vs-fp32 difference."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import ExperimentConfig as JExperimentConfig
from fithubert_tpu.config import LossConfig as JLossConfig
from fithubert_tpu.config import OptimizerConfig as JOptimizerConfig
from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.config import TeacherConfig as JTeacherConfig
from fithubert_tpu.config import TrainConfig as JTrainConfig
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.ops import conformer as jconf
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
from fithubert_tpu_torch.ops import conformer as pconf
from fithubert_tpu_torch.ops.dropout import DropoutRNG
from fithubert_tpu_torch.parallel.distributed import DataParallel
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.step import Distiller

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_FACTOR = 2.0
SPEC = ((32, 10, 5), (32, 3, 2), (48, 2, 2))  # stride 20
SMALL = dict(conv_feature_layers=SPEC, encoder_layers=2, encoder_embed_dim=32,
             encoder_ffn_embed_dim=48, encoder_attention_heads=4, conv_pos=16,
             conv_pos_groups=4, pred_head_final_dim=32, pred_layer_id=(1,),
             layerwise_proj=True, enable_tr_layer=False, required_seq_len_multiple=1,
             layer_type="conformer", attn_type="espnet", depthwise_conv_kernel_size=7)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, dropout_input=0.0)
# the three dispatches of fithubert_tpu/ops/conformer.py:318-346, and abs
# inside the transformer encoder with its TR (transformer.py:349-371)
DISPATCH = {
    "rel_pos": dict(pos_enc_type="rel_pos"),
    "rope": dict(pos_enc_type="rope"),
    "abs_espnet": dict(pos_enc_type="abs", enable_tr_layer=True, tr_layer_type="conv1d",
                       tr_layer_index=0),
    "abs_plain_mha": dict(pos_enc_type="abs", attn_type=""),
}


def _pair(dtype="float32", **over):
    kw = {**SMALL, **NO_DROPOUT, **over}
    return (JConfig(**kw, compute_dtype=dtype, use_pallas_attention=False,
                    use_pallas_conv=False),
            tc.StudentConfig(**kw, compute_dtype=dtype))


def _perturb(tree, seed, positive=False):
    rng = np.random.default_rng(seed)

    def f(a):
        out = np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        return (np.abs(out) if positive else out).astype(np.float32)

    return jax.tree_util.tree_map(f, tree)


@functools.lru_cache(maxsize=None)
def _variables(jcfg, seed=0):
    """(params, batch_stats) of the JAX student: the port's seeded init,
    every tensor perturbed (variances kept positive) so that no affine or
    statistic is trivial, mapped by the JAX package's importer
    (``map_student_state_dict``; a JAX init would compile for seconds).
    Cached: read, do not write."""
    tcfg = tc.StudentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tc.StudentConfig)})
    model = StudentModel(dataclasses.replace(tcfg, compute_dtype="float32"), device="cpu")
    sd = model.init_weights(torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    sd = {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in sd.items()}
    sd = {k: np.abs(v) if k.endswith("running_var") else v for k, v in sd.items()}
    collections = {}
    params = map_student_state_dict(sd, jcfg, collections)
    return params, collections["batch_stats"]


def _batch(seed=1):
    """Three rows: whole, ragged, and a fabricated row of padding only."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((3, 4000)) * 0.3).astype(np.float32)
    mask = np.zeros((3, 4000), bool)
    mask[1, 2900:] = True
    mask[2] = True
    wav[2] = 0.0
    return wav, mask


def _apply(jcfg, variables, wav, mask, disable_projections=False, **kw):
    """The JAX student's forward, jitted (the eager forward of a conformer
    takes seconds); ``kw`` are static."""
    model = JStudent(jcfg, disable_projections=disable_projections)
    return jax.jit(lambda v, w, m: model.apply(v, w, m, **kw))(
        variables, jnp.asarray(wav), jnp.asarray(mask))


@functools.lru_cache(maxsize=None)
def _jax_student_outputs(dispatch, dtype):
    """The JAX student's outputs on ``_batch()`` for rows 0-1 (the
    fabricated row 2 is compared where a test says so). Cached."""
    jcfg, _ = _pair(dtype, **DISPATCH[dispatch])
    params, stats = _variables(jcfg)
    wav, mask = _batch()
    return _outputs(_apply(jcfg, {"params": params, "batch_stats": stats}, wav, mask),
                    slice(0, 2))


def _f(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32))


def _port(tcfg, params, stats, **kw):
    model = StudentModel(tcfg, device="cpu", **kw)
    model.load_state_dict(jax_student_params_to_state_dict(params, tcfg, stats), strict=True)
    return model


def _outputs(out, rows=slice(None)):
    d = {"x": _f(out.x)[rows], "mask": np.asarray(out.padding_mask)[rows]}
    for i, (h, _taps, lr) in enumerate(out.layer_results):
        d[f"hidden{i}"], d[f"ffn{i}"] = _f(h)[rows], _f(lr)[rows]
    return d


# ------------------------------------------------------------ the attentions
def test_rel_positional_encoding_matches_jax():
    """fp32 sin / cos of the same arguments in two libraries: ~1 ulp."""
    for t, d in ((1, 8), (7, 32), (50, 40)):
        np.testing.assert_allclose(pconf.rel_positional_encoding(t, d).numpy(),
                                   np.asarray(jconf.rel_positional_encoding(t, d)),
                                   atol=1e-6, rtol=0)


def test_rel_shift_matches_jax_exactly():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(pconf.rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jconf._rel_shift(jnp.asarray(x))))


def _attention_case(kind, dtype=jnp.float32, seed=0):
    """A JAX espnet attention with perturbed params, the port's with the
    same weights, and (x, mask) with a ragged and a fully padded row."""
    b, t, c, h = 3, 11, 32, 4
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[1, 7:] = True
    mask[2] = True
    jmod = (jconf.RelPositionAttention if kind == "rel_pos" else jconf.RotaryAttention)(
        c, h, dtype=dtype)
    args = (jnp.asarray(x, dtype),)
    if kind == "rel_pos":
        args += (jconf.rel_positional_encoding(t, c, dtype),)
    params = _perturb(jmod.init(jax.random.PRNGKey(seed), *args)["params"], seed)
    pmod = (pconf.RelPositionAttention if kind == "rel_pos" else pconf.RotaryAttention)(c, h)
    sd = {}
    for jname, pname in (("q_proj", "linear_q"), ("k_proj", "linear_k"),
                         ("v_proj", "linear_v"), ("out_proj", "linear_out")):
        sd[f"{pname}.weight"] = torch.from_numpy(params[jname]["kernel"].T.copy())
        sd[f"{pname}.bias"] = torch.from_numpy(params[jname]["bias"])
    if kind == "rel_pos":
        sd["linear_pos.weight"] = torch.from_numpy(params["linear_pos"]["kernel"].T.copy())
        sd["pos_bias_u"] = torch.from_numpy(params["pos_bias_u"])
        sd["pos_bias_v"] = torch.from_numpy(params["pos_bias_v"])
    pmod.load_state_dict(sd, strict=True)
    return jmod, params, pmod, x, mask, args


@pytest.mark.parametrize("taps", [False, True], ids=["no_taps", "taps"])
@pytest.mark.parametrize("kind", ["rel_pos", "rope"])
def test_espnet_attention_matches_jax(kind, taps):
    """Output and taps with a ragged and a fully padded row: without taps
    the padded row attends uniformly (finite -1e30), with taps its logits
    are -inf and its output is the out projection's bias (probabilities
    scrubbed to 0)."""
    jmod, params, pmod, x, mask, args = _attention_case(kind)
    jout, jtaps = jmod.apply({"params": params}, *args, key_padding_mask=jnp.asarray(mask),
                             need_taps=taps)
    pargs = (torch.from_numpy(x),)
    if kind == "rel_pos":
        pargs += (pconf.rel_positional_encoding(x.shape[1], x.shape[2]),)
    pout, ptaps = pmod(*pargs, torch.from_numpy(mask), None, taps)
    np.testing.assert_allclose(_f(pout), _f(jout), **F32_TOL)
    assert np.isfinite(_f(pout)).all()
    if not taps:
        assert ptaps is None
        return
    for got, want in ((ptaps.attn_logits, jtaps.attn_logits), (ptaps.v_rel, jtaps.v_rel)):
        got, want = _f(got), _f(want)
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **F32_TOL)
    np.testing.assert_allclose(_f(pout)[2], np.broadcast_to(params["out_proj"]["bias"], (11, 32)),
                               atol=1e-6, rtol=0)


def test_apply_rotary_bf16_matches_jax_bf16():
    """The rotation computes in bf16 (cos and sin cast to bf16 first, then
    each product and sum rounded): against the JAX package's bf16, not
    fp32; the two differ where the fp32 cos / sin of the two libraries
    round to different bf16 neighbours, by one bf16 step of the result."""
    x = np.random.default_rng(3).standard_normal((2, 37, 4, 8)).astype(np.float32)
    want = _f(jconf.apply_rotary(jnp.asarray(x, jnp.bfloat16)))
    got = _f(pconf.apply_rotary(torch.from_numpy(x).to(torch.bfloat16)))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
    assert (got == want).mean() > 0.99
    # bf16 is not fp32: the JAX bf16 result is off the fp32 one
    assert np.abs(want - _f(jconf.apply_rotary(jnp.asarray(x)))).max() > 1e-3


@pytest.mark.parametrize("kind", ["rel_pos", "rope"])
def test_espnet_attention_bf16_matches_jax_bf16(kind):
    jmod, params, pmod, x, mask, args = _attention_case(kind, jnp.bfloat16, seed=2)
    jout, _ = jmod.apply({"params": params}, *args, key_padding_mask=jnp.asarray(mask))
    j32, _ = (jconf.RelPositionAttention if kind == "rel_pos" else jconf.RotaryAttention)(
        32, 4).apply({"params": params}, jnp.asarray(x),
                     *((jconf.rel_positional_encoding(11, 32),) if kind == "rel_pos" else ()),
                     key_padding_mask=jnp.asarray(mask))
    pargs = (torch.from_numpy(x).to(torch.bfloat16),)
    if kind == "rel_pos":
        pargs += (pconf.rel_positional_encoding(11, 32, torch.bfloat16),)
    pout, _ = pmod(*pargs, torch.from_numpy(mask))
    assert pout.dtype == torch.bfloat16
    ref = np.abs(_f(jout) - _f(j32)).max()
    assert np.abs(_f(pout) - _f(jout)).max() <= BF16_FACTOR * ref


# --------------------------------------------------------------- the modules
def _bn_case(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 6, 8)) * 2 + 1).astype(np.float32)
    x[2] = 3.7  # a fabricated row's garbage
    row_valid = np.array([True, True, False])
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    mean = (0.2 * rng.standard_normal(8)).astype(np.float32)
    var = (1 + 0.2 * np.abs(rng.standard_normal(8))).astype(np.float32)
    bn = pconf.RowMaskedBatchNorm(8)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(5)}, strict=True)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    return bn, v, x, row_valid


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_row_masked_batchnorm_and_buffers_match_jax(train):
    """Train: the batch's statistics without the fabricated row (biased
    variance), the buffers moved by 0.9 old + 0.1 batch; eval: the buffers,
    unmoved. A torch BatchNorm's num_batches_tracked loads and is dropped."""
    bn, v, x, rv = _bn_case()
    assert "num_batches_tracked" not in bn.state_dict()
    want, upd = jconf.RowMaskedBatchNorm().apply(
        v, jnp.asarray(x), row_valid=jnp.asarray(rv), use_running_average=not train,
        mutable=["batch_stats"])
    got = bn(torch.from_numpy(x), torch.from_numpy(rv), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    if train:  # the fabricated row leaves the statistics alone
        bn2, _, _, _ = _bn_case()
        bn2(torch.from_numpy(x[:2]), None, train=True)
        torch.testing.assert_close(bn2.running_mean, bn.running_mean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(bn2.running_var, bn.running_var, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(bn.running_var.numpy(), v["batch_stats"]["var"])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_convolution_module_matches_jax(train):
    """pointwise -> GLU -> depthwise (k 7) -> BatchNorm -> SiLU -> pointwise
    with a fabricated row: output and buffers."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 13, 16)).astype(np.float32)
    rv = np.array([True, True, False])
    jmod = jconf.ConvolutionModule(16, 7, 0.0)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = _perturb(v["params"], 1), _perturb(v["batch_stats"], 2, positive=True)
    want, upd = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                           deterministic=not train, row_valid=jnp.asarray(rv),
                           mutable=["batch_stats"])
    pmod = pconf.ConvolutionModule(16, 7, 0.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sd = {"layer_norm.weight": t(params["layer_norm"]["scale"]),
          "layer_norm.bias": t(params["layer_norm"]["bias"]),
          "batch_norm.weight": t(params["batch_norm"]["scale"]),
          "batch_norm.bias": t(params["batch_norm"]["bias"]),
          "batch_norm.running_mean": t(stats["batch_norm"]["mean"]),
          "batch_norm.running_var": t(stats["batch_norm"]["var"])}
    for conv in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
        sd[f"{conv}.weight"] = t(params[conv]["kernel"].transpose(2, 1, 0))
    pmod.load_state_dict(sd, strict=True)
    got = pmod(torch.from_numpy(x), DropoutRNG(0, "cpu") if train else None,
               torch.from_numpy(rv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    bn = pmod.batch_norm
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["batch_norm"]["mean"]), **F32_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["batch_norm"]["var"]), **F32_TOL)


def test_depthwise_conv_bf16_on_the_cpu_agrees_with_fp32():
    """The CPU's bf16 grouped conv1d is wrong at some shapes; the port's
    depthwise conv sums bf16 operands in fp32 there: within a bf16 step or
    two of the fp32 conv of the same rounded operands."""
    from fithubert_tpu_torch.ops.conv import SameConv1d

    for c, k, t in ((16, 7, 13), (32, 31, 40), (48, 5, 9)):
        conv = SameConv1d(c, c, k, padding=(k - 1) // 2, groups=c, bias=False)
        x = torch.randn(2, t, c, generator=torch.Generator().manual_seed(c))
        xb = x.to(torch.bfloat16)
        got = conv(xb).float()
        with torch.no_grad():
            conv32 = SameConv1d(c, c, k, padding=(k - 1) // 2, groups=c, bias=False)
            conv32.weight.copy_(conv.weight.to(torch.bfloat16).float())
            want = conv32(xb.float())
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=2 ** -7)


# --------------------------------------------------- the layers and encoders
@pytest.mark.parametrize("dispatch", list(DISPATCH))
def test_conformer_student_fp32_matches_jax(dispatch):
    """The student through each dispatch (the layers, the encoder, the
    heads), deterministic (running statistics), ragged and fabricated rows."""
    jcfg, tcfg = _pair("float32", **DISPATCH[dispatch])
    params, stats = _variables(jcfg)
    wav, mask = _batch()
    got = _outputs(_port(tcfg, params, stats)(torch.from_numpy(wav), torch.from_numpy(mask)),
                   slice(0, 2))
    want = _jax_student_outputs(dispatch, "float32")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32_TOL)


@pytest.mark.parametrize("dispatch", ["rel_pos", "rope", "abs_espnet"])
def test_conformer_student_bf16_matches_jax_bf16(dispatch):
    """bf16 against the JAX package's bf16, within BF16_FACTOR of the JAX
    package's own bf16 error (the rotation of rope computes in bf16)."""
    _, tcfg = _pair("bfloat16", **DISPATCH[dispatch])
    params, stats = _variables(_pair(**DISPATCH[dispatch])[0])
    wav, mask = _batch()
    got = _outputs(_port(tcfg, params, stats)(torch.from_numpy(wav), torch.from_numpy(mask)),
                   slice(0, 2))
    want = _jax_student_outputs(dispatch, "bfloat16")
    ref = _jax_student_outputs(dispatch, "float32")
    assert set(got) == set(want)
    for k in want:
        if k == "mask":
            np.testing.assert_array_equal(got[k], want[k])
            continue
        own = np.abs(want[k] - ref[k]).max()
        assert np.abs(got[k] - want[k]).max() <= BF16_FACTOR * own + 1e-6, k


@pytest.mark.parametrize("tgt", [0, 1])
def test_conformer_encoder_tgt_slot_matches_jax(tgt):
    """The early exit (extract_features' layer): slots are layers."""
    jcfg, tcfg = _pair(pos_enc_type="rel_pos", encoder_layers=3)
    params, stats = _variables(jcfg)
    wav, mask = _batch()
    jout = _apply(jcfg, {"params": params, "batch_stats": stats}, wav, mask, layer=tgt,
                  method="extract_features")
    pout = _port(tcfg, params, stats)(torch.from_numpy(wav), torch.from_numpy(mask), layer=tgt)
    assert len(pout.layer_results) == len(jout.layer_results) == tgt + 1
    assert pout.projections is None
    np.testing.assert_allclose(_f(pout.x)[:2], _f(jout.x)[:2], **F32_TOL)


def test_dedicated_conformer_with_tr_on_upsamples_unreduced_frames_as_jax():
    """The rel_pos encoder has no TR module; with enable_tr_layer the JAX
    package still builds the heads' upsamplers, so the heads double frames
    that were never halved, and an early exit at the last layer counts a TR
    slot that is not there (no heads). The port does the same."""
    jcfg, tcfg = _pair(pos_enc_type="rel_pos", enable_tr_layer=True, tr_layer_type="conv1d",
                       tr_layer_index=0)
    params, stats = _variables(jcfg)
    wav, mask = _batch()
    model = _port(tcfg, params, stats)
    jout = _apply(jcfg, {"params": params, "batch_stats": stats}, wav, mask)
    pout = model(torch.from_numpy(wav), torch.from_numpy(mask))
    frames = pout.layer_results[-1][0].shape[1]
    assert pout.projections.shape[2] == 2 * frames == jout.projections.shape[2]
    assert pout.padding_mask.shape[1] == frames
    np.testing.assert_allclose(_f(pout.projections)[:2], _f(jout.projections)[:2], **F32_TOL)
    early = model(torch.from_numpy(wav), torch.from_numpy(mask), layer=1)
    assert early.projections is None and early.x.shape[1] == frames


def test_conformer_taps_for_attn_loss():
    """tests/test_model_families.py:113's case: the last layer's taps are
    (B*H, T, T), and with taps every layer masks with -inf (the fully
    padded row scrubbed), as the JAX package's need_taps forward."""
    jcfg, tcfg = _pair(pos_enc_type="rel_pos")
    params, stats = _variables(jcfg)
    wav, mask = _batch()
    jout, _ = _apply(jcfg, {"params": params, "batch_stats": stats}, wav, mask, need_taps=True,
                     mutable=["batch_stats"])
    model = _port(tcfg, params, stats)
    pout = model.forward_train(torch.from_numpy(wav), torch.from_numpy(mask), None,
                               need_taps=True)
    taps, jtaps = pout.layer_results[-1][1], jout.layer_results[-1][1]
    t = pout.x.shape[1]
    assert taps.attn_logits.shape == taps.v_rel.shape == (3 * 4, t, t)
    assert pout.layer_results[0][1] is None
    for got, want in ((taps.attn_logits, jtaps.attn_logits), (taps.v_rel, jtaps.v_rel)):
        got, want = _f(got), _f(want)
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **F32_TOL)
    np.testing.assert_allclose(_f(pout.x), _f(jout.x), **F32_TOL)  # the padded row too


def test_conformer_dropouts_are_cfg_dropout():
    """Every dropout of a conformer layer is cfg.dropout: with
    attention_dropout and activation_dropout at 0.9 and dropout 0 a
    training forward is the deterministic one (but for the BatchNorm
    statistics, taken in both: the running ones set to the batch's)."""
    _, tcfg = _pair(pos_enc_type="abs", attention_dropout=0.9, activation_dropout=0.9)
    model = StudentModel(tcfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    wav, mask = _batch()
    x, m = torch.from_numpy(wav), torch.from_numpy(mask)
    train = model.forward_train(x, m, DropoutRNG(3, "cpu"))
    for bn in (mod for mod in model.modules() if isinstance(mod, pconf.RowMaskedBatchNorm)):
        bn.momentum = 0.0  # the next training forward copies the batch's statistics
    model.forward_train(x, m, DropoutRNG(4, "cpu"))
    torch.testing.assert_close(model(x, m).x[:2], train.x.detach()[:2], rtol=1e-4, atol=1e-5)
    _, tcfg = _pair(pos_enc_type="abs", dropout=0.5)
    model = StudentModel(tcfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    a = model.forward_train(x, m, DropoutRNG(3, "cpu")).x
    b = model.forward_train(x, m, DropoutRNG(4, "cpu")).x
    assert not torch.allclose(a, b)


def test_conformer_state_dict_keys_are_the_reference_importers():
    """The port's state dict maps through the JAX importer
    (map_student_state_dict) onto the JAX init's tree, leaf for leaf, with
    the running statistics in batch_stats, for every dispatch."""
    for dispatch, over in DISPATCH.items():
        jcfg, tcfg = _pair(**over)
        params, stats = _variables(jcfg)
        sd = jax_student_params_to_state_dict(params, tcfg, stats)
        model = _port(tcfg, params, stats)
        assert set(model.state_dict()) == set(sd), dispatch
        collections = {}
        back = map_student_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg, collections)
        flat = jax.tree_util.tree_leaves_with_path
        assert {jax.tree_util.keystr(p): np.asarray(v).shape for p, v in flat(back)} == \
            {jax.tree_util.keystr(p): np.asarray(v).shape for p, v in flat(params)}, dispatch
        for (p, got), (_, want) in zip(flat(collections["batch_stats"]), flat(stats)):
            np.testing.assert_array_equal(got, want)


def _jit_student_init(monkeypatch):
    """The JAX StudentModel's init under jax.jit (eagerly it compiles op by
    op for seconds); the same draws, summed in XLA's order."""
    real = JStudent.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: real(self, r, *a, **kwargs))(rngs, *args)

    monkeypatch.setattr(JStudent, "init", init)


def test_golden_conformer_fwd_through_carried_weights(monkeypatch):
    """tests/goldens/conformer_fwd.npz: build_conformer's JAX-initialised
    weights and statistics carried to the port give the golden output."""
    from scripts.make_goldens import build_conformer

    _jit_student_init(monkeypatch)
    model, variables, wav, mask = build_conformer()
    jcfg = model.cfg
    tcfg = tc.StudentConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tc.StudentConfig)})
    port = _port(tcfg, variables["params"], variables["batch_stats"])
    out = port(torch.tensor(np.asarray(wav)), torch.tensor(np.asarray(mask)))
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "conformer_fwd.npz"))
    np.testing.assert_allclose(out.x.numpy(), g["x"], **F32_TOL)
    np.testing.assert_allclose(out.projections.numpy(), g["proj"], **F32_TOL)


def test_lightning_ckpt_of_a_rel_pos_student_loads_strictly(tmp_path):
    """A reference Lightning .ckpt of a rel_pos student holds BatchNorm
    num_batches_tracked and the encoder.pos_conv.* the reference's
    conformer inherits and never runs: the expert loads it strictly, and
    serves what the JAX forward gives on the JAX importer's tree."""
    jcfg, tcfg = _pair(pos_enc_type="rel_pos")
    params, stats = _variables(jcfg, seed=5)
    sd = jax_student_params_to_state_dict(params, tcfg, stats)
    extra = {"encoder.pos_conv.0.weight_g": torch.ones(1, 1, 16),
             "encoder.pos_conv.0.weight_v": torch.ones(32, 8, 16),
             "encoder.pos_conv.0.bias": torch.zeros(32)}
    for k in [k for k in sd if k.endswith("batch_norm.running_mean")]:
        extra[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    ckpt = str(tmp_path / "FitHuBERT-conformer.ckpt")
    torch.save({"state_dict": {f"student_model.{k}": v for k, v in {**sd, **extra}.items()},
                "epoch": 3}, ckpt)
    yaml_path = str(tmp_path / "student.yaml")
    tc.dump_config(tc.ExperimentConfig(distiller=tcfg), yaml_path)
    expert = UpstreamExpert(ckpt, yaml_path, device="cpu", length_quantum=1000)
    collections = {}
    jparams = map_student_state_dict({k: v.numpy() for k, v in {**sd, **extra}.items()}, jcfg,
                                     collections)
    wav, mask = _batch(6)
    wav[mask] = 0.0  # the expert pads with zeros
    wavs = [wav[0], wav[1, :2900]]
    got = expert(wavs)
    jout = _apply(jcfg, {"params": {k: v for k, v in jparams.items() if k != "proj_head_0"},
                         **collections}, wav[:2], mask[:2], disable_projections=True)
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(jout.padding_mask))
    np.testing.assert_allclose(_f(got["last_hidden_state"]), _f(jout.x), **F32_TOL)
    for h, (jh, _, _) in zip(got["hidden_states"], jout.layer_results):
        np.testing.assert_allclose(_f(h), _f(jh), **F32_TOL)
    with pytest.raises(RuntimeError, match="Unexpected"):  # any other stray key still fails
        StudentModel(tcfg, device="cpu").load_state_dict({**sd, "encoder.stray": torch.ones(1)})


# ------------------------------------------------------------- the train step
LOSS = dict(rec_loss_weight=1.0, rec_loss_type="mse", sim_loss_weight=1.0,
            distil_random_layer=0, random_layer_weight=0.0)
OPT = dict(lr=5e-3, warmup_proportion=0.2, betas=(0.9, 0.98), eps=1e-6, weight_decay=1e-6)
TRAIN = dict(batch_size=2, accumulate_grad_batches=2, fuse_grad_accum=True, use_fp16=False)
TEACHER = dict(conv_feature_layers=SPEC, encoder_layers=2, encoder_embed_dim=32,
               encoder_ffn_embed_dim=64, encoder_attention_heads=4, conv_pos=16,
               conv_pos_groups=4)
# as tests/test_torch_train_step.py: loss and grad_norm to summation order;
# AdamW moves a parameter by ~lr where its gradient sits near eps
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)


def _step_batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
        mask = np.zeros((2, 2, 2000), bool)
        mask[0, 1, 1370:] = True  # ragged
        mask[1, 1] = True  # fabricated: all padding
        x[1, 1] = 0.0
        out.append({"x": x, "padding_mask": mask})
    return out


def _experiments(jcfg, tcfg, **train):
    jexp = JExperimentConfig(
        teacher=JTeacherConfig(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                               encoder_attention_heads=4),
        train=JTrainConfig(**{**TRAIN, **train}), loss=JLossConfig(**LOSS), distiller=jcfg,
        optimizer=JOptimizerConfig(**OPT))
    texp = tc.ExperimentConfig(
        teacher=tc.TeacherConfig(encoder_layers=2, encoder_embed_dim=32,
                                 encoder_ffn_embed_dim=64, encoder_attention_heads=4),
        train=tc.TrainConfig(**{**TRAIN, **train}), loss=tc.LossConfig(**LOSS), distiller=tcfg,
        optimizer=tc.OptimizerConfig(**OPT))
    return jexp, texp


def test_conformer_distiller_two_fp32_steps_match_jax():
    """A rel_pos conformer step of 2 microbatches (never folded: the
    BatchNorm statistics advance microbatch by microbatch), a ragged and a
    fabricated row, no dropout: loss, grad_norm, lr, every parameter and
    both running statistics after each of two steps, and the eval step
    (running statistics) after them."""
    jcfg, tcfg = _pair(pos_enc_type="rel_pos")
    jexp, texp = _experiments(jcfg, tcfg)
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=10,
                    teacher_geometry=JGeometry(**TEACHER, use_pallas_attention=False))
    wav = jnp.zeros((2, 2000), jnp.float32)
    tp = jax.jit(jd.init_teacher_params)(jax.random.PRNGKey(0), wav)
    state = jax.jit(jd.init_state)(jax.random.PRNGKey(1), wav)
    geom = TeacherGeometry(**TEACHER)
    pd = Distiller(texp, jax_teacher_params_to_state_dict(tp["params"], geom),
                   jax_student_params_to_state_dict(state.params, tcfg,
                                                    state.extra_vars["batch_stats"]),
                   device="cpu", num_training_steps=10, teacher_geometry=geom)
    step = jd.make_train_step()
    for i, batch in enumerate(_step_batches(2)):
        state, jl = step(jax.tree_util.tree_map(jnp.copy, state), tp,
                         jax.tree_util.tree_map(jnp.asarray, batch),
                         jnp.zeros((0,), jnp.int32), jax.random.PRNGKey(2))
        got = pd.train_step(batch, None)
        want = {k: float(v) for k, v in jl.items()}
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, err_msg=f"step {i} {k}", **LOSS_TOL)
        want_sd = jax_student_params_to_state_dict(jax.device_get(state.params), tcfg,
                                                   jax.device_get(state.extra_vars["batch_stats"]))
        got_sd = pd.student.state_dict()
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       err_msg=f"step {i} {k}", **PARAM_TOL)
    ev = {k: v[0] for k, v in _step_batches(1)[0].items()}
    want_v = float(jd.make_eval_step()(state, tp, jax.tree_util.tree_map(jnp.asarray, ev),
                                       jnp.zeros((0,), jnp.int32))["v_loss"])
    np.testing.assert_allclose(pd.eval_step(ev, None)["v_loss"], want_v, **LOSS_TOL)


def test_conformer_microbatches_update_the_statistics_in_order():
    """Two microbatches move the running statistics twice (never folded
    into one batch of 4 rows that would move them once), and a transformer
    student with the same batch still folds."""
    _, tcfg = _pair(pos_enc_type="rope", **NO_DROPOUT)
    _, texp = _experiments(None, tcfg)
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry(**TEACHER)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(tcfg, device="cpu").init_weights(gen).state_dict()
    d = Distiller(texp, t_state, s_state, device="cpu", teacher_geometry=geom)
    batch = _step_batches(1)[0]
    d.train_step(batch, None)
    bn = d.student.encoder.layers[0].conv_module.batch_norm
    got = (bn.running_mean.clone(), bn.running_var.clone())
    # by hand: the two microbatches' forwards in order from the initial buffers
    model = StudentModel(tcfg, device="cpu")
    model.load_state_dict(s_state)
    for i in range(2):
        model.forward_train(torch.from_numpy(batch["x"][i]),
                            torch.from_numpy(batch["padding_mask"][i]), DropoutRNG(i, "cpu"))
    ref = model.encoder.layers[0].conv_module.batch_norm
    torch.testing.assert_close(got[0], ref.running_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got[1], ref.running_var, rtol=1e-6, atol=1e-7)


def test_conformer_refuses_more_than_one_rank(monkeypatch, tmp_path):
    """A conformer over 2 ranks, once refused, runs: a data-parallel
    Distiller hands every BatchNorm the sum over the ranks (its statistics
    are the global batch's; tests/test_torch_ddp.py runs two ranks against
    the JAX one-process step), and run_training of a conformer experiment
    that asks for 2 cards starts 2 ranks (``launch``, recorded here)."""
    _, tcfg = _pair(pos_enc_type="rel_pos")
    _, texp = _experiments(None, tcfg)
    geom = TeacherGeometry(**TEACHER)
    gen = torch.Generator().manual_seed(0)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(tcfg, device="cpu").init_weights(gen).state_dict()
    dp = DataParallel(0, 2)
    monkeypatch.setattr(DataParallel, "broadcast_", lambda self, tensors: None)
    d = Distiller(texp, t_state, s_state, device="cpu", teacher_geometry=geom, dp=dp)
    bns = [m for m in d.student.modules() if isinstance(m, pconf.RowMaskedBatchNorm)]
    assert len(bns) == tcfg.encoder_layers
    assert all(bn.sum_over_ranks == dp.sum_with_grad for bn in bns)
    from fithubert_tpu_torch.ops.kernels import _build

    started = []
    monkeypatch.setattr(loop, "world_size", lambda cfg, dev: cfg.train.num_devices)
    monkeypatch.setattr(_build, "build_all", lambda sources: None)
    monkeypatch.setattr(loop, "launch", lambda fn, n, *a: started.append(n) or [{}])
    cfg = _loop_config(tmp_path, "rel_pos", num_devices=2)
    loop.run_training(cfg, device="cpu")
    assert started == [2]


# ---------------------------------------------------------- loop and expert
def _loop_config(out_dir, pos_enc_type, **train):
    """conformer_experiment at a small width, with synthetic data."""
    cfg = tc.conformer_experiment(pos_enc_type)
    return dataclasses.replace(
        cfg,
        teacher=dataclasses.replace(cfg.teacher, teacher_model="",
                                    **{k: v for k, v in TEACHER.items()
                                       if k.startswith("encoder")}),
        distiller=dataclasses.replace(cfg.distiller, **{
            k: v for k, v in SMALL.items()
            if k not in ("attn_type", "enable_tr_layer", "pred_head_final_dim")},
            pos_enc_type=pos_enc_type, compute_dtype="float32", pred_head_final_dim=32),
        loss=dataclasses.replace(cfg.loss, distil_random_layer=1),
        data=dataclasses.replace(cfg.data, synthetic=True, synthetic_num_batches=4,
                                 synthetic_wav_length=4000, length_quantum=1000),
        train=dataclasses.replace(cfg.train, **{"output_dir": str(out_dir), "num_epochs": 2,
                                                "use_fp16": False, "log_every": 1,
                                                "num_devices": 1, "batch_size": 2,
                                                "accumulate_grad_batches": 2, **train}))


def test_conformer_loop_trains_resumes_bit_for_bit_and_serves(tmp_path, monkeypatch):
    """run_training of a small rel_pos conformer (train_torch.py's path with
    --device cpu): a run stopped at max_steps 2 and resumed gives the
    uninterrupted run's losses and final state bit for bit, running
    statistics included; the export serves from them."""
    monkeypatch.setattr(TeacherGeometry, "from_teacher_config",
                        classmethod(lambda cls, t: cls(**TEACHER)))
    full = loop.run_training(_loop_config(tmp_path / "full", "rel_pos"), resume=False,
                             device="cpu")
    first = loop.run_training(_loop_config(tmp_path / "r", "rel_pos", max_steps=2),
                              resume=False, device="cpu")
    second = loop.run_training(_loop_config(tmp_path / "r", "rel_pos"), resume=True,
                               device="cpu")
    assert (full["steps"], first["steps"], second["steps"]) == (4, 2, 4)

    def losses(d):
        with open(d / "metrics.jsonl") as f:
            return {r["step"]: (r["loss"], r["grad_norm"]) for r in map(json.loads, f)
                    if "loss" in r}

    assert losses(tmp_path / "r") == losses(tmp_path / "full")
    a = torch.load(tmp_path / "full" / "student.pt")
    b = torch.load(tmp_path / "r" / "student.pt")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    init = StudentModel(_loop_config(tmp_path, "rel_pos").distiller, device="cpu").state_dict()
    key = "encoder.layers.0.conv_module.batch_norm.running_var"
    assert key in a and not torch.equal(a[key], init[key])  # the statistics moved
    expert = UpstreamExpert(str(tmp_path / "full" / "student.pt"),
                            str(tmp_path / "full" / "student.yaml"), device="cpu")
    wavs = [np.zeros(3000, np.float32), np.ones(2000, np.float32) * 0.1]
    out = expert(wavs)
    assert torch.isfinite(out["last_hidden_state"]).all()
    again = expert(wavs)  # serving reads the running statistics, never moves them
    torch.testing.assert_close(again["last_hidden_state"], out["last_hidden_state"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("pos_enc_type", ["rel_pos", "rope", "abs"])
def test_conformer_experiment_is_the_release_yaml_with_conformer_layers(pos_enc_type):
    """conformer_experiment(p) is configs/fithubert.yaml with layer_type
    conformer, attn_type espnet, pos_enc_type p and (but for abs) no TR, as
    the JAX loader reads such a file."""
    from fithubert_tpu.config import config_from_yaml_dict as j_config_from_yaml_dict

    from fithubert_tpu_torch.config import read_yaml

    raw = read_yaml("configs/fithubert.yaml")
    raw["distiller"] = dict(raw["distiller"], layer_type="conformer", attn_type="espnet",
                            pos_enc_type=pos_enc_type,
                            enable_tr_layer=pos_enc_type == "abs")
    port, ref = tc.config_from_yaml_dict(raw), j_config_from_yaml_dict(raw)
    assert tc.conformer_experiment(pos_enc_type) == port
    for section in ("teacher", "train", "loss", "distiller", "optimizer", "specaug"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), f"{section}.{f.name}"
