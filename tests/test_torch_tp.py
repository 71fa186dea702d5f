"""Tensor parallelism of the port (fithubert_tpu_torch/parallel/mesh.py) on
the CPU: gloo ranks as subprocesses on a free local port, each with a time
limit and one thread.

- the parameters the port shards, and the dim of each, are those JAX's
  ``param_sharding`` shards on ``make_mesh(model_axis=2)`` and ``4``,
  mapped through ``export/jax_params.py``'s names, for the tiny release
  geometry, an ex-shaped one (TR fc1, proj_head_in + SplitLinear), the
  rel_pos and rope conformers, an int8 teacher (``kernel_scale``) and a
  geometry whose heads and width divide neither axis; where the heads do
  not divide but the width does, the port keeps the attention replicated
  and JAX shards it (the one layout difference);
- copy_to_model, reduce_from_model and gather_from_model on 2 ranks,
  forward and backward, equal single-process autograd;
- (data 1 x model 2), (data 2 x model 2) and (data 1 x model 4, one head
  per rank) at tests/test_torch_train_step.py's tiny geometry, fp32,
  dropout 0: two steps of one global batch with a fabricated row and the
  eval step after them match the JAX one-device Distiller at LOSS_TOL /
  PARAM_TOL, in parity and masked_reduction mode, with path B's taps, for
  the rel_pos conformer (BatchNorm statistics over the data axis) and
  with an int8 teacher; every rank gathers the same one-process state;
- with dropout on, the replicated parameters are bit for bit across the
  model ranks after a step, and model rank 0 draws one process's words at
  every site; the sharded sites draw apart on model rank 1: in the flash
  path, path B, the rel_pos conformer and under checkpoint_activations
  (whose shares equal the same mesh's without it);
- ``dryrun_multichip``'s tail on (data 2 x model 2): step, eval, save,
  restore into a fresh tensor-parallel Distiller, equal v_loss; and one
  process's checkpoint loaded into a tensor-parallel Distiller gathers
  back unchanged.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fithubert_tpu.models import StudentModel as JStudentModel
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.models import TeacherModel as JTeacherModel
from fithubert_tpu.ops.quant import prequantize_dense_kernels
from fithubert_tpu.parallel import make_mesh as jax_make_mesh
from fithubert_tpu.parallel import param_sharding
from fithubert_tpu.train.step import Distiller as JDistiller
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.parallel import distributed as pd
from fithubert_tpu_torch.parallel import mesh as pm
from fithubert_tpu_torch.train.step import Distiller
from tests import test_torch_conformer as tconf
from tests import test_torch_ex as tex
from tests import test_torch_tp_worker as worker
from tests.test_torch_ddp import _eval_batch, _global_batches
from tests.test_torch_train_step import (
    LOSS,
    LOSS_TOL,
    N_TRAIN_STEPS,
    PARAM_TOL,
    RAND,
    TAPS,
    TEACHER,
    _configs,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_tp_worker.py")
RANK_TIMEOUT = 180  # seconds; a gloo rendezvous that never completes would hang
MESHES = ((1, 2), (2, 2), (1, 4))  # (data, model)
CASES = ("parity", "masked", "taps", "rel_pos", "int8")
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, dropout_input=0.1)


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- the cases
def _case_configs(name):
    """(JAX experiment, port experiment, JAX teacher geometry, port teacher
    geometry, random layers) of a case."""
    if name == "rel_pos":
        jcfg, tcfg = tconf._pair(pos_enc_type="rel_pos")
        jexp, texp = tconf._experiments(jcfg, tcfg)
        return (jexp, texp, JGeometry(**tconf.TEACHER, use_pallas_attention=False),
                TeacherGeometry(**tconf.TEACHER), None)
    loss = {"parity": LOSS, "masked": dict(LOSS, masked_reduction=True), "taps": TAPS,
            "int8": LOSS}[name]
    jexp, texp = _configs(loss=loss)
    q = name == "int8"
    if q:
        jexp = dataclasses.replace(jexp, teacher=dataclasses.replace(jexp.teacher,
                                                                     quantize_int8=True))
        texp = dataclasses.replace(texp, teacher=dataclasses.replace(texp.teacher,
                                                                     quantize_int8=True))
    return (jexp, texp, JGeometry(**TEACHER, use_pallas_attention=False, quantize_int8=q),
            TeacherGeometry(**TEACHER), RAND)


def _jax_init(name, shared):
    """The JAX one-device Distiller of a case, its teacher params and state,
    and its initial weights as the port's state dicts. The cases of one
    geometry share one init (``shared``: geometry -> params and state)."""
    jexp, texp, jgeom, geom, _ = _case_configs(name)
    jd = JDistiller(jexp, mesh=jax_make_mesh(1), num_training_steps=N_TRAIN_STEPS,
                    teacher_geometry=jgeom)
    geometry = "rel_pos" if name == "rel_pos" else "release"
    if geometry not in shared:
        wav = jnp.zeros((2, 2000), jnp.float32)
        tp = jax.jit(jd.init_teacher_params)(jax.random.PRNGKey(0), wav)
        state = jax.jit(jd.init_state)(jax.random.PRNGKey(1), wav)
        init = (jax_teacher_params_to_state_dict(_np_tree(tp["params"]), geom),
                _student_sd(state, texp.distiller))
        shared[geometry] = (tp, state, init)
    return (jd,) + shared[geometry]


def _student_sd(state, cfg):
    stats = state.extra_vars.get("batch_stats")
    return jax_student_params_to_state_dict(_np_tree(state.params), cfg,
                                            None if stats is None else _np_tree(stats))


def _jax_steps(name, jd, tp, state):
    """The JAX Distiller's logs and student state after each of two steps on
    the global batches, then its eval logs."""
    _, texp, _, _, rand = _case_configs(name)
    prepared = jd.prepare_teacher_params(tp)
    jrand = jnp.asarray(rand if rand is not None else [], jnp.int32)
    step, steps = jd.make_train_step(), []
    for batch in _global_batches():
        state, lg = step(jax.tree_util.tree_map(jnp.copy, state), prepared,
                         jax.tree_util.tree_map(jnp.asarray, batch), jrand,
                         jax.random.PRNGKey(2))
        steps.append({"logs": {k: float(v) for k, v in lg.items()},
                      "student": _student_sd(state, texp.distiller)})
    ev = jd.make_eval_step()(state, prepared, jax.tree_util.tree_map(jnp.asarray, _eval_batch()),
                             jrand)
    return steps, {k: float(v) for k, v in ev.items()}


def _port_case(name, init, **student_kw):
    """The worker's case: the port's config, the carried states, the batches."""
    _, texp, _, geom, rand = _case_configs(name)
    if student_kw:
        texp = dataclasses.replace(texp, distiller=dataclasses.replace(texp.distiller,
                                                                       **student_kw))
    return dict(cfg=texp, geometry=geom, teacher=init[0], student=init[1],
                batches=_global_batches(), eval_batch=_eval_batch(), rand=rand,
                num_training_steps=N_TRAIN_STEPS)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Every case's JAX one-process run, and each mesh's ranks' records (the
    worker's mesh<d>x<m>_rank<r>.pt). The ranks start from the JAX inits and
    run while JAX compiles its steps."""
    out = tmp_path_factory.mktemp("tp")
    shared = {}
    jax_cases = {name: _jax_init(name, shared) for name in CASES}
    inputs = str(out / "inputs.pt")
    torch.save({"cases": {n: _port_case(n, jax_cases[n][3]) for n in CASES}}, inputs)
    procs = []  # (process, its log file): a file, so no rank blocks on a full pipe
    for data, model in MESHES:
        port, world = pd.free_port(), data * model
        for r in range(world):
            log = out / f"mesh{data}x{model}_rank{r}.log"
            with open(log, "w") as f:
                procs.append((subprocess.Popen(
                    [sys.executable, WORKER, str(r), str(world), str(port), str(model), inputs,
                     str(out)], env=_env(), stdout=f, stderr=subprocess.STDOUT), log))
    try:
        want = {name: _jax_steps(name, *jax_cases[name][:3]) for name in CASES}
        for p, log in procs:
            p.wait(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, log.read_text(errors="replace")[-3000:]
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = {(data, model): [torch.load(out / f"mesh{data}x{model}_rank{r}.pt",
                                        weights_only=False) for r in range(data * model)]
             for data, model in MESHES}
    return want, ranks


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"data{m[0]}xmodel{m[1]}")
def test_tp_steps_match_one_jax_process(mesh, case, tp_run):
    """Every log (loss, grad_norm, lr, the per-layer and tap terms) within
    LOSS_TOL and every parameter of the gathered student (with a
    conformer's BatchNorm statistics) within PARAM_TOL of the JAX
    Distiller's step on the whole global batch, after each of the two
    steps, on every rank; the ranks' gathered states bit for bit; the eval
    step's logs to LOSS_TOL."""
    want, ranks = tp_run
    steps, ev = want[case]
    for i, w in enumerate(steps):
        first = ranks[mesh][0][case]["steps"][i]["student"]
        for r, rank in enumerate(ranks[mesh]):
            got = rank[case]["steps"][i]
            assert set(got["logs"]) == set(w["logs"]), i
            for k, v in w["logs"].items():
                np.testing.assert_allclose(got["logs"][k], v, err_msg=f"step {i} rank {r} {k}",
                                           **LOSS_TOL)
            assert set(got["student"]) == set(w["student"])
            for k in w["student"]:
                assert got["student"][k].shape == w["student"][k].shape, k
                assert torch.equal(got["student"][k], first[k]), f"step {i} rank {r} {k}"
        for k, v in w["student"].items():
            np.testing.assert_allclose(first[k].numpy(), v.numpy(), err_msg=f"step {i} {k}",
                                       **PARAM_TOL)
    for r, rank in enumerate(ranks[mesh]):
        assert set(rank[case]["eval"]) == set(ev)
        for k, v in ev.items():
            np.testing.assert_allclose(rank[case]["eval"][k], v, err_msg=f"rank {r} {k}",
                                       **LOSS_TOL)


# ---------------------------------------------------------------- the rules
GEOMETRIES = ("release", "ex", "rel_pos", "rope", "int8_teacher", "heads_and_width_odd")


def _student_pair(name):
    """(JAX StudentConfig, port StudentConfig) of a geometry."""
    if name in ("rel_pos", "rope"):
        return tconf._pair(pos_enc_type=name)
    if name == "ex":  # TR fc1 before layer 1, proj_head_in + SplitLinear over 2 tasks
        return tex._pair(enable_tr_layer=True)
    jexp, texp = _configs()
    over = {"heads_and_width_odd": dict(encoder_embed_dim=27, encoder_attention_heads=3,
                                        conv_pos_groups=3),
            "heads_odd": dict(encoder_embed_dim=36, encoder_attention_heads=3)}.get(name, {})
    return (dataclasses.replace(jexp.distiller, **over),
            dataclasses.replace(texp.distiller, **over))


def _jax_axes(params, model_axis):
    """{tree path: the dim JAX's param_sharding shards on 'model', or None}."""
    shardings = param_sharding(jax_make_mesh(model_axis=model_axis), params)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            list(s.spec).index("model") if "model" in tuple(s.spec) else None
            for path, s in flat}


def _expected_dims(params, to_state_dict, model_axis):
    """{port state key: dim} that JAX's sharding of ``params`` (a tree of
    shapes) means under the port's names: each leaf carried through
    ``to_state_dict`` as markers (its id, plus its index along one JAX axis
    a pass), so each port tensor names its leaf and the port dim that
    varies along the leaf's sharded axis."""
    axes = _jax_axes(params, model_axis)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    passes = []
    for a in range(3):
        leaves = []
        for i, (_, leaf) in enumerate(flat):
            v = np.full(leaf.shape, (i + 1) * 4096.0, np.float32)
            if a < len(leaf.shape):
                v += np.arange(leaf.shape[a]).reshape([-1 if d == a else 1
                                                       for d in range(len(leaf.shape))])
            leaves.append(v)
        passes.append(to_state_dict(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), leaves)))
    want = {}
    for key, t in passes[0].items():
        leaf = int(t.reshape(-1)[0].item()) // 4096 - 1
        if leaf < 0 or axes[paths[leaf]] is None:
            continue  # not a parameter (BatchNorm statistics), or replicated
        moved = passes[axes[paths[leaf]]][key]
        want[key] = next(d for d in range(moved.dim()) if not torch.equal(
            moved, moved.narrow(d, 0, 1).expand_as(moved)))
    return want, paths


def _zeros(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


def _rule_case(name):
    """(port model, JAX params as shapes, their carrier into port keys, JAX
    prequantized shapes or None)."""
    key, wav = jax.random.PRNGKey(0), jnp.zeros((1, 2000), jnp.float32)
    mask = jnp.zeros(wav.shape, bool)
    if name == "int8_teacher":
        jgeom = JGeometry(**TEACHER, use_pallas_attention=False, quantize_int8=True)
        params = jax.eval_shape(lambda: JTeacherModel(jgeom).init(key, wav, mask))["params"]
        geom = TeacherGeometry(**TEACHER, quantize_int8=True)
        model = TeacherModel(geom, device="cpu").init_weights(
            torch.Generator().manual_seed(0)).freeze()
        return (model, params, lambda p: jax_teacher_params_to_state_dict(p, geom),
                jax.eval_shape(prequantize_dense_kernels, params))
    jcfg, tcfg = _student_pair(name)
    rngs = {k: key for k in ("params", "dropout", "specaug", "layerdrop")}
    variables = jax.eval_shape(lambda: JStudentModel(jcfg).init(rngs, wav, mask))
    stats = variables.get("batch_stats")
    return (StudentModel(tcfg, device="cpu"), variables["params"],
            lambda p: jax_student_params_to_state_dict(
                p, tcfg, None if stats is None else _zeros(stats)), None)


@pytest.mark.parametrize("model_axis", (2, 4))
@pytest.mark.parametrize("name", GEOMETRIES)
def test_the_port_shards_what_jax_param_sharding_shards(name, model_axis):
    """The port's sharded parameters and their dims equal the set JAX's
    param_sharding gives the same geometry, under the port's names; an
    int8 layer's payload follows its weight, and the column-parallel
    scales are the ones whose ``kernel_scale`` JAX shards."""
    model, params, to_sd, quantized = _rule_case(name)
    want, paths = _expected_dims(params, to_sd, model_axis)
    got = pm.shard_dims(model, model_axis)
    assert {k: d for k, d in got.items() if k.endswith(("weight", "bias"))} == want
    if name == "heads_and_width_odd":
        assert not any(".self_attn." in k for k in got)  # neither side shards the attention
    assert {k[:-len("weight_q")]: d for k, d in got.items() if k.endswith("weight_q")} == \
        ({k[:-len("weight")]: d for k, d in want.items() if k.endswith("weight")
          and model.get_submodule(k[:-len(".weight")]).quantize} if quantized else {})
    if quantized:
        axes = _jax_axes(quantized, model_axis)
        kernels = {p: k for k, p in zip(*_port_keys_of_kernels(params, to_sd))}
        want_scales = {kernels[p[:-len("_scale")]][:-len("weight")] + "weight_scale"
                       for p, a in axes.items() if p.endswith("kernel_scale") and a is not None}
        assert want_scales and {k for k in got if k.endswith("weight_scale")} == want_scales
        assert all(got[k] == 0 for k in want_scales)


def _port_keys_of_kernels(params, to_sd):
    """(port keys, JAX paths) of each Dense kernel: its ``.weight``."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    markers = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), [
        np.full(leaf.shape, (i + 1) * 4096.0, np.float32) for i, (_, leaf) in enumerate(flat)])
    keys, of = [], []
    for key, t in to_sd(markers).items():
        path = paths[int(t.reshape(-1)[0].item()) // 4096 - 1]
        if path.endswith("/kernel") and key.endswith(".weight"):
            keys.append(key)
            of.append(path)
    return keys, of


@pytest.mark.parametrize("model_axis", (2, 4))
def test_an_attention_whose_heads_do_not_divide_stays_replicated(model_axis):
    """Width 36 in 3 heads: JAX shards each projection on the width, which
    divides; the port keeps each such attention whole (its heads do not
    divide) and otherwise shards as JAX does (ROADMAP Queue 3)."""
    model, params, to_sd, _ = _rule_case("heads_odd")
    want, _ = _expected_dims(params, to_sd, model_axis)
    got = pm.shard_dims(model, model_axis)
    attn = {k for k in want if ".self_attn." in k}
    assert len(attn) == 3 * 7  # q, k, v weight and bias, out_proj's weight, 3 layers
    assert got == {k: d for k, d in want.items() if k not in attn}


# ---------------------------------------------------------------- collectives
def test_the_collectives_match_one_process_autograd():
    """copy_to_model, reduce_from_model and gather_from_model on 2 ranks, in
    fp32 and bf16: outputs and gradients equal single-process autograd of
    the identity / sum / concatenation under the ranks' loss weights, bit
    for bit (two addends sum alike in any order; bf16 sums in fp32)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    parts = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    w = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    got = pd.launch(worker.collectives_rank, 2, x, parts, w, timeout=RANK_TIMEOUT)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")

        def t(a):
            return torch.tensor(a, dtype=dtype)

        def grad_of(weight):  # the weight as the loss's gradient reaches a tensor of dtype
            return torch.tensor(weight).to(dtype).float().numpy()

        summed = (t(parts[0]).float() + t(parts[1]).float()).to(dtype).float().numpy()
        g_copy = (t(w[0]).float() + t(w[1]).float()).to(dtype).float().numpy()
        for r, rank in enumerate(got):
            cases = {"copy": (t(x).float().numpy(), g_copy),
                     "reduce": (summed, grad_of(w[0])),
                     "gather": (np.concatenate([t(p).float().numpy() for p in parts], -1),
                                grad_of(w[r]))}
            for name, (out, grad) in cases.items():
                np.testing.assert_array_equal(rank[f"{name} {tag}"][0], out, err_msg=name)
                np.testing.assert_array_equal(rank[f"{name} {tag}"][1], grad, err_msg=name)


# ---------------------------------------------------------------- dropout
def _dropout_case(name, **student_kw):
    """A case with dropout 0.1 at every site, on the port's own seeded init."""
    _, texp, _, geom, _ = _case_configs(name)
    gen = torch.Generator().manual_seed(0)
    t_sd = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_sd = StudentModel(texp.distiller, device="cpu").init_weights(gen).state_dict()
    return dict(_port_case(name, (t_sd, s_sd), **DROPOUT, **student_kw))


def _check_dropout(case, sites0, sd0, sites1, sd1):
    """At every site model rank 0 draws the words one process draws, a
    replicated site draws them on rank 1 too and a sharded one others; the
    replicated parameters are bit for bit across the ranks and the sharded
    ones hold different slices."""
    one = Distiller(case["cfg"], case["teacher"], case["student"], device="cpu",
                    num_training_steps=N_TRAIN_STEPS, teacher_geometry=case["geometry"])
    with worker.SiteRecorder() as sites:
        one.train_step(case["batches"][0], case["rand"])
    assert len(sites) == len(sites0) == len(sites1) > 0
    sharded = 0
    for (w, shape), (w0, s0), (w1, s1) in zip(sites, sites0, sites1):
        assert w0 == w and s0 == s1
        if s0 == shape:  # a replicated site
            assert w1 == w
        else:
            sharded += 1
            assert w1 != w0 and math.prod(s0) * 2 == math.prod(shape)
    assert 0 < sharded < len(sites)
    dims = pm.shard_dims(StudentModel(case["cfg"].distiller, device="cpu"), 2)
    for k in sd0:
        if k in dims:
            assert sd0[k].shape == sd1[k].shape and not np.array_equal(sd0[k], sd1[k]), k
        else:
            np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)


def test_dropout_under_the_model_axis():
    """A (1 x 2) mesh, dropout 0.1 everywhere: after two steps (the second
    at lr > 0) the replicated parameters are bit for bit across the two
    model ranks, and the sharded ones hold different slices; at every site
    model rank 0 draws the words one process draws; a replicated site
    draws them on rank 1 too, a sharded one (a sharded attention, the
    hidden of a sharded FFN) draws others there."""
    case = _dropout_case("parity")
    (sites0, sd0), (sites1, sd1) = pd.launch(worker.dropout_rank, 2, case, timeout=RANK_TIMEOUT)
    _check_dropout(case, sites0, sd0, sites1, sd1)


@pytest.mark.parametrize("path", ("taps", "rel_pos", "remat"))
def test_dropout_under_the_model_axis_in_each_path(path):
    """As test_dropout_under_the_model_axis on the other paths that draw
    under a model axis: path B's materialised probabilities (``taps``), a
    rel_pos conformer's (its ``_attend`` and sharded ``w_1`` hidden), and
    ``checkpoint_activations``, whose recompute repeats the layers' draws
    and their ``reduce_from_model`` in the backward; there the shares equal
    those of the same mesh without remat bit for bit."""
    remat = path == "remat"
    case = _dropout_case("parity" if remat else path, checkpoint_activations=remat)
    twin = _dropout_case("parity") if remat else None
    ranks = pd.launch(worker.dropout_rank, 2, case, twin, timeout=RANK_TIMEOUT)
    (sites0, sd0, *twin0), (sites1, sd1, *twin1) = ranks
    _check_dropout(case, sites0, sd0, sites1, sd1)
    if path == "taps":  # path B's probabilities: (B, H_local, T, T) per rank
        assert any(len(s) == 4 and s[2] == s[3] for _, s in sites0)
    if remat:  # the recompute draws the forward's words again, and no others
        for mine, (plain_sites, plain) in ((sites0, twin0), (sites1, twin1)):
            assert len(mine) > len(plain_sites) and set(mine) == set(plain_sites)
        for mine, plain in ((sd0, twin0[1]), (sd1, twin1[1])):
            for k in mine:
                np.testing.assert_array_equal(mine[k], plain[k], err_msg=k)


# ---------------------------------------------------------------- checkpoints
def test_dryrun_sequence_on_a_2x2_mesh(tmp_path):
    """dryrun_multichip's tail on (data 2 x model 2): a step, an eval, a
    checkpoint save by global rank 0 alone, a restore into a fresh
    tensor-parallel Distiller whose v_loss equals the first bit for bit;
    the saved state has one process's keys and shapes; and one process's
    state (weights and AdamW moments after a step) loaded into a
    tensor-parallel Distiller gathers back unchanged."""
    _, texp = _configs()
    geom = TeacherGeometry(**TEACHER)
    gen = torch.Generator().manual_seed(1)
    t_sd = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_sd = StudentModel(texp.distiller, device="cpu").init_weights(gen).state_dict()
    case = _port_case("parity", (t_sd, s_sd))
    one = Distiller(texp, t_sd, s_sd, device="cpu", num_training_steps=N_TRAIN_STEPS,
                    teacher_geometry=geom)
    one.train_step(case["batches"][1], RAND)
    one_state = one.state_dict()
    ranks = pd.launch(worker.dryrun_rank, 4, case, one_state, str(tmp_path), 2,
                      timeout=RANK_TIMEOUT)
    shapes = {k: tuple(v.shape) for k, v in one_state["student"].items()}
    for v0, v1, back, saved in ranks:
        assert v0 == v1 and np.isfinite(v0)
        assert saved == shapes
        for k, v in one_state["student"].items():
            np.testing.assert_array_equal(back["student"][k], v.numpy(), err_msg=k)
        for i, st in one_state["optimizer"]["state"].items():
            for k, v in st.items():
                np.testing.assert_array_equal(back["moments"][i][k], v.numpy(),
                                              err_msg=f"{i} {k}")
    assert sorted(os.listdir(tmp_path / "last")) == ["step_1.pt"]
    assert sorted(os.listdir(tmp_path / "best")) == ["index.json", "step_1.pt"]
    assert len({r[0] for r in ranks}) == 1


def test_a_sharded_student_on_jax_weights_serves_the_jax_forward():
    """shard_state_dict puts a state dict carried from the JAX tree into an
    ex-shaped StudentModel (TR fc1, proj_head_in + SplitLinear) sharded
    over 2 model ranks: its deterministic forward (every output of
    tests/test_torch_ex.py ``_outputs``) equals the JAX student's on the
    same weights at that file's F32_TOL, on both ranks."""
    jcfg, tcfg = tex._pair(enable_tr_layer=True)
    wav, mask = tex._batch([4000, 2900, 3500])
    model = JStudentModel(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(wav),
                                 jnp.asarray(mask))["params"]
    rng = np.random.default_rng(0)  # every leaf perturbed, as tex._jax_params does
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    want = tex._outputs(jax.jit(model.apply)({"params": params}, jnp.asarray(wav),
                                            jnp.asarray(mask)))
    sd = jax_student_params_to_state_dict(params, tcfg)
    for got in pd.launch(worker.sharded_forward_rank, 2, tcfg, sd, wav, mask,
                         timeout=RANK_TIMEOUT):
        tex._assert_close(want, got)
