"""The port's StudentModel and UpstreamExpert against the JAX package's
StudentModel on carried weights: a tiny geometry in fp32 and bf16, the
expert's padded batch, the layer= early exit, and one full-width
FitHuBERT-960h fp32 forward of 1 s. On the CPU the port runs the plain
versions of its kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.config import StudentConfig as JConfig
from fithubert_tpu.config import load_yaml_config as j_load_yaml
from fithubert_tpu.data.librispeech import quantize_length as j_quantize_length
from fithubert_tpu.export.reference_import import map_student_state_dict
from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu_torch.config import StudentConfig, fithubert_960h
from fithubert_tpu_torch.export.expert import UpstreamExpert, quantize_length
from fithubert_tpu_torch.export.jax_params import jax_student_params_to_state_dict
from fithubert_tpu_torch.models.student import StudentModel

torch.set_num_threads(2)

SPEC9 = ((32, 10, 5), (32, 1, 1), (32, 3, 2), (32, 3, 2), (64, 1, 1), (64, 2, 2))
TINY = dict(
    extractor_mode="default", conv_feature_layers=SPEC9, conv_bias=False, conv_pos=16,
    conv_pos_groups=4, pos_conv_depth=1, layer_type="transformer", encoder_layers=2,
    encoder_embed_dim=48, encoder_ffn_embed_dim=96, encoder_attention_heads=4,
    activation_fn="gelu", layer_norm_first=False, pred_head_final_dim=64,
    layerwise_proj=True, enable_tr_layer=True, tr_reduce_factor=2, tr_layer_type="conv1d",
    tr_layer_index=0, required_seq_len_multiple=1, crop_seq_to_multiple=1)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  dropout_input=0.0)

# fp32: the same model in two frameworks; summation order only, through
# conv, LayerNorm and matmul stacks with O(1) activations.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 is held against fp32: the port's bf16 output may differ from the JAX
# package's bf16 output by at most BF16_FACTOR times as much as the JAX
# package's own bf16 output differs from its fp32 output (both frameworks
# round at slightly different places).
BF16_FACTOR = 2.0


def configs(dtype="float32", **over):
    kw = {**TINY, **over}
    return (JConfig(**kw, **NO_DROPOUT, compute_dtype=dtype),
            StudentConfig(**kw, compute_dtype=dtype))


def jax_params(jcfg, seed=0):
    """JAX init from a PRNG key, every leaf perturbed so biases and norm
    affines are not trivial."""
    wav = jnp.zeros((1, 4000), jnp.float32)
    params = JStudent(jcfg).init(jax.random.PRNGKey(seed), wav, jnp.zeros((1, 4000), bool))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params["params"])


def batch(lengths=(4000, 3100, 2200), seed=1):
    rng = np.random.default_rng(seed)
    t = max(lengths)
    wav = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.3
    mask = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    return wav, mask


def port_model(tcfg, params, **kw):
    m = StudentModel(tcfg, device="cpu", **kw)
    m.load_state_dict(jax_student_params_to_state_dict(params, tcfg), strict=True)
    return m


def _f(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32))


def outputs(out):
    """The StudentOutput tensors, flattened to a name -> array dict."""
    d = {"x": _f(out.x), "features": _f(out.features)}
    for i, (h, _taps, lr) in enumerate(out.layer_results):
        d[f"hidden{i}"], d[f"ffn{i}"] = _f(h), _f(lr)
    for i, tr in enumerate(out.tr_layer_results):
        d[f"tr{i}"] = _f(tr)
    if out.projections is not None:
        d["projections"] = _f(out.projections)
    return d


def run_both(dtype, params, wav, mask, over=None, **kw):
    jcfg, tcfg = configs(dtype, **(over or {}))
    jout = JStudent(jcfg, **kw).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    tout = port_model(tcfg, params, **kw)(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(tout.padding_mask.numpy(), np.asarray(jout.padding_mask))
    return outputs(jout), outputs(tout)


@pytest.mark.parametrize("over", [
    {},
    dict(layer_norm_first=True),  # pre-LN, the teacher's layout
    dict(enable_tr_layer=False, required_seq_len_multiple=4),  # pad + unpad
], ids=["release", "pre_ln", "no_tr_pad4"])
def test_tiny_student_fp32_matches_jax(over):
    params = jax_params(configs(**over)[0])
    wav, mask = batch()
    want, got = run_both("float32", params, wav, mask, over)
    assert set(got) == set(want) and "projections" in got
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32_TOL)


def test_tiny_student_bf16_matches_jax():
    params = jax_params(configs()[0])
    wav, mask = batch()
    want32, _ = run_both("float32", params, wav, mask)
    want, got = run_both("bfloat16", params, wav, mask)
    for name in want:
        ref_err = np.abs(want[name] - want32[name]).max()
        port_err = np.abs(got[name] - want[name]).max()
        assert port_err <= BF16_FACTOR * ref_err, (name, port_err, ref_err)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_early_exit_matches_jax(layer):
    """layer= counts the TR module as slot 0, like the reference's tgt_layer;
    the last slot runs the heads."""
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    wav, mask = batch(seed=2)
    jout = JStudent(jcfg).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask),
                                layer, method="extract_features")
    tout = port_model(tcfg, params)(torch.from_numpy(wav), torch.from_numpy(mask),
                                    layer=layer)
    want, got = outputs(jout), outputs(tout)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32_TOL)


def test_upstream_expert_matches_jax_export_model():
    """UpstreamExpert.forward on ragged waveforms against the JAX export model
    (disable_projections=True, all heads but the last dropped) on the same
    quantized, padded batch."""
    jcfg, tcfg = configs()
    params = jax_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 4321, 1700)]
    expert = UpstreamExpert(jax_student_params_to_state_dict(params, tcfg), tcfg,
                            device="cpu", length_quantum=1600)
    got = expert(wavs)

    t_pad = j_quantize_length(max(map(len, wavs)), 1600)
    assert t_pad == quantize_length(max(map(len, wavs)), 1600) == 4800
    wav, mask = batch([len(w) for w in wavs])
    wav = np.pad(wav, ((0, 0), (0, t_pad - wav.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, t_pad - mask.shape[1])), constant_values=True)
    for i, w in enumerate(wavs):
        wav[i, :len(w)] = w
    last = f"proj_head_{jcfg.encoder_layers - 1}"
    jparams = {k: v for k, v in params.items() if not k.startswith("proj_head_") or k == last}
    jout = JStudent(jcfg, disable_projections=True).apply(
        {"params": jparams}, jnp.asarray(wav), jnp.asarray(mask))

    assert expert.get_downsample_rates("key") == jcfg.downsample_rate == 40
    np.testing.assert_array_equal(got["padding_mask"].numpy(), np.asarray(jout.padding_mask))
    np.testing.assert_allclose(_f(got["last_hidden_state"]), _f(jout.x), **F32_TOL)
    assert len(got["hidden_states"]) == jcfg.encoder_layers
    for h, (jh, _, _) in zip(got["hidden_states"], jout.layer_results):
        np.testing.assert_allclose(_f(h), _f(jh), **F32_TOL)


def test_full_width_fp32_one_second_matches_jax():
    """FitHuBERT-960h at full width, seeded port weights carried into the JAX
    model by the JAX package's own importer, 1 x 1 s in fp32."""
    tcfg = dataclasses.replace(fithubert_960h(), compute_dtype="float32")
    jcfg = dataclasses.replace(j_load_yaml("configs/fithubert.yaml").distiller,
                               compute_dtype="float32")
    model = StudentModel(tcfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    params = map_student_state_dict(model.state_dict(), jcfg)
    wav, mask = batch([16000], seed=5)
    jout = JStudent(jcfg).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    tout = model(torch.from_numpy(wav), torch.from_numpy(mask))
    want, got = outputs(jout), outputs(tout)
    assert got["x"].shape == (1, 48, 768) and got["hidden11"].shape == (1, 24, 480)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, atol=2e-4, rtol=2e-4)
