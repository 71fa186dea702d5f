"""The gradient of the port's conv front-end (ops/conv.py
ConvFeatureExtractor over ops/kernels/conv_frontend.py conv_stack): dx
(into the waveform), every conv weight, and the block-0 GroupNorm's gamma
and beta against jax.vjp of the JAX package's ConvFeatureExtractor on the
same weights. The JAX side runs its default path here (the XLA oracle with
the hand-written GroupNorm VJP, ``_gn_prefix_bwd``) and, under
force_interpret, the fused kernel's custom VJP (``_fused_gn_bwd``). The
port differentiates its plain recompute and carries dscale and dshift
through ``gn_scale_shift``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.ops.pallas import force_interpret
from fithubert_tpu_torch.config import StudentConfig
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.ops.conv import grad_multiply
from tests.test_torch_conv_frontend import SPEC9, _jax_extractor_params, _port_extractor

torch.set_num_threads(2)

# fp32: the same sums in another order; the GroupNorm gradient reduces over
# ~900 frames, so relative errors up to ~1e-4 of the largest entry.
F32_REL = 2e-4
# bf16: both sides round activations to bf16 at every layer, at slightly
# different places (the JAX prefix normalises in fp32 and rounds once, the
# port rounds scale and shift); gradients agree norm-wise to a few percent.
BF16_FRO = 5e-2


def _wav(seed=3, lengths=(4800, 3217, 1800)):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = rng.standard_normal(n) * 0.3
    return wav


def _jax_grads(model, params, wav, cot, dtype, interpret):
    def f(p, w):
        return model.apply({"params": p}, w.astype(jnp.dtype(dtype)))

    p = jax.tree_util.tree_map(jnp.asarray, params)
    if interpret:
        with force_interpret():
            out, vjp = jax.vjp(f, p, jnp.asarray(wav))
            dp, dwav = vjp(jnp.asarray(cot, out.dtype))
    else:
        out, vjp = jax.vjp(f, p, jnp.asarray(wav))
        dp, dwav = vjp(jnp.asarray(cot, out.dtype))
    grads = {f"conv_layers.{i}.0.weight": np.asarray(dp[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)
             for i in range(len(SPEC9))}
    grads["conv_layers.0.2.weight"] = np.asarray(dp["group_norm"]["scale"])
    grads["conv_layers.0.2.bias"] = np.asarray(dp["group_norm"]["bias"])
    grads["wav"] = np.asarray(dwav)
    return {k: v.astype(np.float32) for k, v in grads.items()}


def _port_grads(params, wav, cot, dtype):
    fe = _port_extractor(params)
    tw = torch.from_numpy(wav).requires_grad_()
    out = fe(tw.to(getattr(torch, dtype)))
    out.backward(torch.from_numpy(cot).to(out.dtype))
    grads = {k: p.grad.float().numpy() for k, p in fe.named_parameters()}
    grads["wav"] = tw.grad.numpy()
    return grads


@pytest.mark.parametrize("path", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extractor_gradients_match_jax_vjp(dtype, path):
    model, params = _jax_extractor_params(dtype)
    wav = _wav()
    t_out = 4800
    for (_d, k, s) in SPEC9:
        t_out = (t_out - k) // s + 1
    cot = np.random.default_rng(4).standard_normal((3, t_out, SPEC9[-1][0])).astype(np.float32)
    want = _jax_grads(model, params, wav, cot, dtype, path == "interpret")
    got = _port_grads(params, wav, cot, dtype)
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            rel = np.abs(g - w).max() / np.abs(w).max()
            assert rel < F32_REL, (name, rel)
        else:
            fro = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert fro < BF16_FRO, (name, fro)


@pytest.mark.parametrize("mult", [0.1, 0.0])
def test_feature_grad_mult_scales_the_extractor_gradient(mult):
    """feature_grad_mult (grad_multiply, ``fithubert_tpu/ops/conv.py:468``):
    the forward is unchanged and the extractor's gradient is scaled by it;
    0 stops it, as the JAX student's stop_gradient does."""
    x = torch.randn(2, 3, requires_grad=True)
    y = grad_multiply(x, 0.25)
    y.backward(torch.ones(2, 3))
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full((2, 3), 0.25))

    cfg = StudentConfig(conv_feature_layers=((32, 10, 5), (32, 3, 2)), encoder_layers=1,
                        encoder_embed_dim=16, encoder_ffn_embed_dim=16,
                        encoder_attention_heads=2, conv_pos=4, conv_pos_groups=2,
                        layerwise_proj=True, tr_layer_type="conv1d", tr_layer_index=0,
                        pred_head_final_dim=16, required_seq_len_multiple=1)
    wav = torch.from_numpy(_wav(lengths=(900, 700)))
    grads = {}
    for m in (1.0, mult):
        model = StudentModel(dataclasses.replace(cfg, feature_grad_mult=m), device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        out = model.forward_train(wav)
        out.x.square().sum().backward()
        grads[m] = model.feature_extractor.conv_layers[1][0].weight.grad
    if mult == 0.0:
        assert grads[mult] is None
    else:
        torch.testing.assert_close(grads[mult], grads[1.0] * mult)
