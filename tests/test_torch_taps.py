"""The attention taps of the port (fithubert_tpu_torch/ops/attention.py, the
materialised branch) against the JAX package's MultiHeadSelfAttention with
``need_taps=True`` on carried weights: the output, the fp32 logits with -inf
at the same padded keys, and the value relation, with a fully padded row,
and their gradients. Then the last layer's taps of the tiny student and
teacher against the JAX models, and the taps branch's dropout (K5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.models import StudentModel as JStudent
from fithubert_tpu.models import TeacherModel as JTeacher
from fithubert_tpu.ops.attention import MultiHeadSelfAttention as JMHA
from fithubert_tpu_torch.ops.attention import MultiHeadSelfAttention, attention_with_taps
from fithubert_tpu_torch.ops.dropout import DropoutRNG
from fithubert_tpu_torch.ops.kernels import dropout as kd
from tests import test_torch_student as ts
from tests import test_torch_teacher as tt

torch.set_num_threads(2)

# fp32, the same einsums in another order over O(1) activations.
TOL = dict(atol=2e-5, rtol=2e-5)
E, H, T = 48, 4, 30


def _mha(seed=17):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, T, E)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.array([T, 21, 0])[:, None]  # the last row: all padding
    jm = JMHA(embed_dim=E, num_heads=H, use_pallas=False)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    for name in params:  # non-zero biases
        params[name]["bias"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    tm = MultiHeadSelfAttention(E, H, device="cpu")
    tm.load_state_dict({f"{n}.{p}": torch.from_numpy(
        np.ascontiguousarray(params[n]["kernel"].T if p == "weight" else params[n]["bias"]))
        for n in params for p in ("weight", "bias")})
    return jm, params, tm, x, mask


def _scalar(out, logits, v_rel, w):
    """A scalar that reads all three: the -inf logits enter as 0."""
    return (out * w[0]).sum() + (logits * w[1]).sum() + (v_rel * w[2]).sum()


def test_mha_taps_match_jax_need_taps():
    jm, params, tm, x, mask = _mha()
    (want, taps), vjp = jax.vjp(
        lambda xx: jm.apply({"params": params}, xx, jnp.asarray(mask), True, True),
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got, got_taps = tm(xt, torch.from_numpy(mask), need_taps=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_logits, got_logits = np.asarray(taps.attn_logits), got_taps.attn_logits.detach().numpy()
    assert got_logits.shape == want_logits.shape == (3 * H, T, T)
    assert got_logits.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got_logits), np.isneginf(want_logits))
    assert np.isneginf(got_logits[-H:]).all()  # the fully padded row
    fin = np.isfinite(want_logits)
    np.testing.assert_allclose(got_logits[fin], want_logits[fin], **TOL)
    np.testing.assert_allclose(got_taps.v_rel.detach().numpy(), np.asarray(taps.v_rel), **TOL)
    assert np.isfinite(got.detach().numpy()).all()

    # gradients into x through the output, the finite logits and v_rel
    rng = np.random.default_rng(3)
    w = [rng.standard_normal(s).astype(np.float32) for s in (want.shape, fin.shape, fin.shape)]
    cot = (jnp.asarray(w[0]), jax.tree_util.tree_map(jnp.asarray, type(taps)(
        np.where(fin, w[1], 0.0).astype(np.float32), w[2])))
    (want_dx,) = vjp(cot)
    safe = torch.where(torch.isinf(got_taps.attn_logits), 0.0, got_taps.attn_logits)
    _scalar(got, safe, got_taps.v_rel, [torch.from_numpy(a) for a in w]).backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-4, rtol=1e-4)


def test_mha_without_taps_returns_none_and_the_same_output():
    _, _, tm, x, mask = _mha()
    rows = ~mask.all(-1)  # the flash path gives a fully padded row another value
    with torch.no_grad():
        a, taps = tm(torch.from_numpy(x), torch.from_numpy(mask))
        b, _ = tm(torch.from_numpy(x), torch.from_numpy(mask), need_taps=True)
    assert taps is None
    np.testing.assert_allclose(a.numpy()[rows], b.numpy()[rows], **TOL)


def test_taps_branch_drops_probabilities_with_k5():
    """With a DropoutRNG the probabilities are dropped by seeded_dropout on
    the seed the rng draws next; the taps themselves are not dropped."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 3, 8)).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(np.arange(9)[None, :] >= np.array([9, 6])[:, None])
    out, taps = attention_with_taps(q, k, v, mask, 0.3, DropoutRNG(11, "cpu"))
    seed = DropoutRNG(11, "cpu").seed_words()
    _, ref_taps = attention_with_taps(q, k, v, mask, 0.0, None)
    probs = torch.softmax(ref_taps.attn_logits.view(2, 3, 9, 9), -1)
    dropped = kd.seeded_dropout_plain(probs, seed, 0.3)
    want = torch.einsum("bhqk,bkhd->bqhd", dropped, v)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(taps.attn_logits, ref_taps.attn_logits)
    assert torch.equal(taps.v_rel, ref_taps.v_rel)


def _compare_taps(jt, pt):
    want_l, got_l = np.asarray(jt.attn_logits), pt.attn_logits.numpy()
    np.testing.assert_array_equal(np.isneginf(got_l), np.isneginf(want_l))
    fin = np.isfinite(want_l)
    np.testing.assert_allclose(got_l[fin], want_l[fin], **ts.F32_TOL)
    np.testing.assert_allclose(pt.v_rel.numpy(), np.asarray(jt.v_rel), **ts.F32_TOL)


def test_tiny_student_last_layer_taps_match_jax():
    """Only the last layer carries taps in the port; its taps, and the
    hidden states of every layer, agree with the JAX student's need_taps
    forward (fp32, every dropout off)."""
    jcfg, tcfg = ts.configs()
    params = ts.jax_params(jcfg)
    wav, mask = ts.batch()
    jout = JStudent(jcfg).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask),
                                deterministic=True, need_taps=True)
    with torch.no_grad():
        tout = ts.port_model(tcfg, params).forward_train(torch.from_numpy(wav),
                                                         torch.from_numpy(mask), need_taps=True)
    assert all(taps is None for (_h, taps, _lr) in tout.layer_results[:-1])
    _compare_taps(jout.layer_results[-1][1], tout.layer_results[-1][1])
    for (jh, _, _), (th, _, _) in zip(jout.layer_results, tout.layer_results):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **ts.F32_TOL)


@pytest.mark.parametrize("model_type", ["hubert", "wav2vec2"])
def test_tiny_teacher_last_layer_taps_match_jax(model_type):
    jgeom, geom = tt.geometries(model_type)
    params = tt.jax_params(jgeom)
    wav, mask = ts.batch(lengths=(4000, 3137, 2210))
    jout = JTeacher(jgeom).apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask),
                                 need_taps=True)
    tout = tt.port_teacher(geom, params)(torch.from_numpy(wav), torch.from_numpy(mask),
                                         need_taps=True)
    assert tout.layer_results[0][1] is None
    _compare_taps(jout.layer_results[-1][1], tout.layer_results[-1][1])
    np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout.x), **ts.F32_TOL)
