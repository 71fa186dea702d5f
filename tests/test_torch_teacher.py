"""The port's frozen teacher (fithubert_tpu_torch/models/teacher.py) against
the JAX package's TeacherModel on weights carried by
``jax_teacher_params_to_state_dict``: a tiny geometry, the HuBERT and the
wav2vec2 padding masks, fp32 and bf16, post-LN and pre-LN; the state dict's
fairseq keys through the JAX package's fairseq importers; the bf16 cast of
``freeze()``; and the positional conv at the teacher's full width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.export.fairseq_import import (
    _dense,
    _layernorm,
    map_extractor,
    map_pos_conv,
    map_transformer_encoder,
)
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.models import TeacherModel as JTeacher
from fithubert_tpu.ops.conv import PositionalConv as JPositionalConv
from fithubert_tpu_torch.export.jax_params import jax_teacher_params_to_state_dict
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.conv import PositionalConv
from tests.test_torch_student import BF16_FACTOR, F32_TOL, batch

torch.set_num_threads(2)

TINY = dict(conv_feature_layers=((32, 10, 5), (48, 3, 2), (48, 3, 2), (48, 2, 2)),
            encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=96,
            encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4)


def geometries(model_type="hubert", dtype="float32", **over):
    kw = {**TINY, **over, "model_type": model_type, "compute_dtype": dtype}
    return JGeometry(**kw), TeacherGeometry(**kw)


def jax_params(jgeom, seed=0):
    wav = jnp.zeros((1, 4000), jnp.float32)
    params = JTeacher(jgeom).init(jax.random.PRNGKey(seed), wav, jnp.zeros((1, 4000), bool))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params["params"])


def port_teacher(geom, params):
    m = TeacherModel(geom, device="cpu")
    m.load_state_dict(jax_teacher_params_to_state_dict(params, geom), strict=True)
    return m


def _f(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a).astype(jnp.float32))


def run_both(model_type, dtype, params, wav, mask, **over):
    jgeom, geom = geometries(model_type, dtype, **over)
    jout = JTeacher(jgeom).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    tout = port_teacher(geom, params)(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(tout.padding_mask.numpy(), np.asarray(jout.padding_mask))
    out = {}
    for name, o in (("jax", jout), ("port", tout)):
        d = {"x": _f(o.x), "features": _f(o.features)}
        for i, (h, _taps, lr) in enumerate(o.layer_results):
            d[f"hidden{i}"], d[f"ffn{i}"] = _f(h), _f(lr)
        out[name] = d
    return out["jax"], out["port"]


@pytest.mark.parametrize("model_type", ["hubert", "wav2vec2"])
@pytest.mark.parametrize("over", [{}, dict(layer_norm_first=True)], ids=["post_ln", "pre_ln"])
def test_tiny_teacher_fp32_matches_jax(model_type, over):
    params = jax_params(geometries(model_type, **over)[0])
    wav, mask = batch(lengths=(4000, 3137, 2210))
    want, got = run_both(model_type, "float32", params, wav, mask, **over)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **F32_TOL)


def test_hubert_and_wav2vec2_masks_differ_at_the_boundary():
    """HuBERT's chunked all() and wav2vec2's conv-length formula disagree on
    a frame that is partly padding; each side follows its model type."""
    jgeom, geom = geometries("hubert")
    params = jax_params(jgeom)
    wav, mask = batch(lengths=(4000, 3137))
    pm = {}
    for mt in ("hubert", "wav2vec2"):
        g = dataclasses.replace(geom, model_type=mt)
        pm[mt] = port_teacher(g, params)(torch.from_numpy(wav), torch.from_numpy(mask)).padding_mask
    assert not torch.equal(pm["hubert"], pm["wav2vec2"])


@pytest.mark.parametrize("model_type", ["hubert", "wav2vec2"])
def test_tiny_teacher_bf16_matches_jax(model_type):
    """bf16 held against fp32: the port's bf16 error may be at most
    BF16_FACTOR times the JAX package's own bf16-vs-fp32 error."""
    params = jax_params(geometries(model_type)[0])
    wav, mask = batch(lengths=(4000, 3137, 2210))
    want32, _ = run_both(model_type, "float32", params, wav, mask)
    want16, got16 = run_both(model_type, "bfloat16", params, wav, mask)
    for name in want32:
        ref = np.linalg.norm(want16[name] - want32[name]) + 1e-6 * np.linalg.norm(want32[name])
        err = np.linalg.norm(got16[name] - want32[name])
        assert err <= BF16_FACTOR * ref, (name, err, ref)


def test_freeze_casts_matmul_weights_once_without_changing_outputs():
    """freeze() stores the extractor convs and the Linear weights in bf16
    (norms, pos_conv and weight_g/weight_v stay fp32), which is the same
    rounding as casting on every use: outputs are bit-identical."""
    _jgeom, geom = geometries("hubert", "bfloat16")
    params = jax_params(geometries("hubert")[0])
    wav, mask = batch()
    a = port_teacher(geom, params)
    b = port_teacher(geom, params).freeze()
    for name, p in b.named_parameters():
        cast = name.endswith("0.weight") and "conv_layers" in name or (
            "proj" in name or ".fc" in name)
        assert p.dtype == (torch.bfloat16 if cast else torch.float32), name
        assert not p.requires_grad
    oa = a(torch.from_numpy(wav), torch.from_numpy(mask))
    ob = b(torch.from_numpy(wav), torch.from_numpy(mask))
    assert torch.equal(oa.x, ob.x) and torch.equal(oa.features, ob.features)


def test_state_dict_round_trips_through_the_fairseq_importers():
    """JAX tree -> the port's state dict (fairseq keys) -> map_extractor,
    map_pos_conv and map_transformer_encoder -> the original tree."""
    jgeom, geom = geometries()
    params = jax_params(jgeom)
    sd = jax_teacher_params_to_state_dict(params, geom)
    TeacherModel(geom, device="cpu").load_state_dict(sd, strict=True)
    back = {
        "feature_extractor": map_extractor(sd, "feature_extractor", "default"),
        "layer_norm": _layernorm(sd, "layer_norm"),
        "post_extract_proj": _dense(sd, "post_extract_proj"),
        "encoder": map_transformer_encoder(sd, "encoder"),
    }
    np.testing.assert_array_equal(map_pos_conv(sd, "encoder.pos_conv")["weight_v"],
                                  params["encoder"]["pos_conv"]["weight_v"])
    leaves = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                        for p, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = leaves(params), leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_positional_conv_at_the_teachers_width_matches_jax():
    """C = 768, groups 16, k = 128 (HuBERT-Base), fp32."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 150, 768)).astype(np.float32)
    jpc = JPositionalConv(embed_dim=768, kernel_size=128, groups=16)
    p = jpc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.01 * rng.standard_normal(a.shape)).astype(np.float32), p)
    want = np.asarray(jpc.apply({"params": p}, jnp.asarray(x)))
    pc = PositionalConv(768, 128, 16, device="cpu")
    pc.load_state_dict({
        "0.weight_g": torch.from_numpy(p["weight_g"]).reshape(1, 1, -1),
        "0.weight_v": torch.from_numpy(np.ascontiguousarray(p["weight_v"].transpose(2, 1, 0))),
        "0.bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = pc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
