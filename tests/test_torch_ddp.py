"""Data parallelism of the port (fithubert_tpu_torch/parallel) on the CPU:
gloo ranks as subprocesses on a free local port, each with a time limit and
one thread.

- the ranks' data stripes equal the JAX pipeline's make_dataset(host_id,
  num_hosts) bit for bit, synthetic and bucketed (tiny FLACs, a trailing
  partial bucket whose fabricated row falls on one rank), and make up the
  one-process global batch;
- two ranks at the tiny geometry of tests/test_torch_train_step.py (fp32,
  dropout 0) take two steps of one global batch with a fabricated row and
  match the JAX Distiller's one-process step on that batch, in parity and
  in masked_reduction mode, and so do their evals; after each step both
  ranks hold the same parameters bit for bit and draw the same random
  layers;
- one rank through the data-parallel path is the plain step bit for bit;
- run_training under torchrun (two ranks, configs/smoke.yaml, --device cpu)
  writes one config, one metrics.jsonl and one checkpoint tree, both ranks
  end on the same step, and a second launch resumes on both;
- a signal on one rank stops both on the same step;
- launch() spawns ranks that join one group, and stops them if one fails.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fithubert_tpu.config import DataConfig as JDataConfig
from fithubert_tpu.data import librispeech as jls
from fithubert_tpu.models import TeacherGeometry as JGeometry
from fithubert_tpu.parallel import make_mesh
from fithubert_tpu.train.step import Distiller as JDistiller
from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.config import DataConfig
from fithubert_tpu_torch.data import librispeech as ls
from fithubert_tpu_torch.export.jax_params import (
    jax_student_params_to_state_dict,
    jax_teacher_params_to_state_dict,
)
from fithubert_tpu_torch.models.teacher import TeacherGeometry
from fithubert_tpu_torch.parallel import distributed as pd
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.train.step import Distiller
from tests import test_torch_ddp_worker
from tests.flac_writer import write_flac
from tests.test_torch_train_step import (
    LOSS,
    LOSS_TOL,
    N_TRAIN_STEPS,
    PARAM_TOL,
    RAND,
    TEACHER,
    _configs,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_ddp_worker.py")
WORLD = 2
RANK_TIMEOUT = 120  # seconds; a gloo rendezvous that never completes would hang
CASES = {"parity": LOSS, "masked": dict(LOSS, masked_reduction=True)}


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)


# ---------------------------------------------------------------- data stripes
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven FLACs of ragged lengths: with a global batch of 4, buckets of 4
    and 3 rows, so the trailing bucket's fabricated row is rank 1's."""
    root = tmp_path_factory.mktemp("librispeech")
    rng = np.random.default_rng(1)
    for u in range(7):
        chap = root / "train-tiny" / str(1 + u % 2) / "7"
        chap.mkdir(parents=True, exist_ok=True)
        n = 1400 + 577 * u
        sig = np.round(3000 * np.sin(np.arange(n) * 0.02 * (u + 1))
                       + 300 * rng.standard_normal(n)).astype(np.int64)
        write_flac(str(chap / f"{1 + u % 2}-7-{u:04d}.flac"), [sig],
                   kind="fixed1" if u % 2 else "verbatim")
    return str(root)


def _datasets(kind, root, tmp_path, accum, rank, world):
    common = dict(length_quantum=1000, num_workers=2, prefetch=1)
    if kind == "synthetic":
        common.update(synthetic=True, synthetic_num_batches=4, synthetic_wav_length=3000)
    stripe = dict(accum=accum, shuffle=True, seed=3, host_id=rank, num_hosts=world)
    j = jls.make_dataset(JDataConfig(libri_root=root, bucketing_path=str(tmp_path / "jax"),
                                     **common), ["train-tiny"], 4, **stripe)
    p = ls.make_dataset(DataConfig(libri_root=root, bucketing_path=str(tmp_path / "port"),
                                   **common), ["train-tiny"], 4, **stripe)
    return j, p


@pytest.mark.parametrize("kind, accum", [("synthetic", 2), ("bucketed", 1), ("bucketed", 3)])
def test_rank_stripes_equal_the_jax_pipeline(kind, accum, corpus, tmp_path):
    """Each rank's batches, two epochs, bit for bit; every rank has the
    same number of steps. Bucketed with accum 3, the one group holds both
    buckets and a fabricated microbatch."""
    lengths = set()
    for rank in range(WORLD):
        j, p = _datasets(kind, corpus, tmp_path, accum, rank, WORLD)
        assert len(p) == len(j)
        lengths.add(len(p))
        for epoch in (0, 1):
            got, want = list(p.epoch(epoch)), list(j.epoch(epoch))
            assert len(got) == len(want) == len(p)
            for g, w in zip(got, want):
                assert set(g) == {"x", "padding_mask"} <= set(w)
                assert g["x"].shape[1] == 4 // WORLD
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{kind} {rank} {k}")
    assert len(lengths) == 1


def test_rank_stripes_make_up_the_global_batch(corpus, tmp_path):
    """Rank r's rows are rows r::2 of the one-process batch; the trailing
    bucket's fabricated row lies on rank 1 only."""
    _, whole = _datasets("bucketed", corpus, tmp_path, 1, 0, 1)
    ranks = [_datasets("bucketed", corpus, tmp_path, 1, r, WORLD)[1] for r in range(WORLD)]
    fake = {r: 0 for r in range(WORLD)}
    for step, batch in enumerate(whole.epoch(0)):
        for r, data in enumerate(ranks):
            mine = list(data.epoch(0))[step]
            for k in batch:
                np.testing.assert_array_equal(mine[k], batch[k][:, r::WORLD])
            fake[r] += int(mine["padding_mask"].all(-1).sum())
    assert fake == {0: 0, 1: 1}


def test_a_stripe_needs_a_batch_that_divides(tmp_path):
    with pytest.raises(ValueError, match="stripe"):
        ls.SyntheticDataset(DataConfig(synthetic=True), 3, host_id=0, num_hosts=2)
    with pytest.raises(ValueError, match="stripe"):
        ls.SyntheticDataset(DataConfig(synthetic=True), 4, host_id=2, num_hosts=2)


# ---------------------------------------------------------------- the step
def _global_batches(n=2):
    """(A = 2, B = 4) global batches: ragged rows, and in microbatch 1 a row
    fabricated as all padding at position 3, which is rank 1's."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        x = (rng.standard_normal((2, 4, 2000)) * 0.3).astype(np.float32)
        mask = np.zeros((2, 4, 2000), bool)
        mask[0, 1, 1370:] = True
        mask[1, 2, 900:] = True
        mask[1, 3] = True
        x[mask] = 0.0
        out.append({"x": x, "padding_mask": mask})
    return out


def _eval_batch():
    """(4, T) rows for the eval step: ragged, one fabricated (rank 1's)."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((4, 2000)) * 0.3).astype(np.float32)
    mask = np.arange(2000)[None, :] >= np.array([2000, 1100, 1700, 0])[:, None]
    return {"x": np.where(mask, 0.0, x).astype(np.float32), "padding_mask": mask}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dp_run(torchrun_loop, tmp_path_factory):
    """Both cases: the JAX Distiller's logs and parameters after each of two
    steps on the global batches, and each rank's record (the worker's
    rank<r>.pt). The ranks run while JAX compiles."""
    out = tmp_path_factory.mktemp("ddp")
    geom = JGeometry(**TEACHER, use_pallas_attention=False)
    wav = jnp.zeros((2, 2000), jnp.float32)
    # the cases differ only in the loss: one init (model and AdamW) serves both
    jax_distillers = {name: JDistiller(_configs(loss=loss)[0], mesh=make_mesh(1),
                                       num_training_steps=N_TRAIN_STEPS, teacher_geometry=geom)
                      for name, loss in CASES.items()}
    tp = jax_distillers["parity"].init_teacher_params(jax.random.PRNGKey(0), wav)
    state0 = jax_distillers["parity"].init_state(jax.random.PRNGKey(1), wav)
    batches = _global_batches()
    teacher = jax_teacher_params_to_state_dict(_np_tree(tp["params"]), TeacherGeometry(**TEACHER))
    spec = {}
    for name, loss in CASES.items():
        _, tcfg = _configs(loss=loss)
        spec[name] = dict(
            cfg=tcfg, geometry=TeacherGeometry(**TEACHER), batches=batches, rand=RAND,
            num_training_steps=N_TRAIN_STEPS, teacher=teacher, eval_batch=_eval_batch(),
            student=jax_student_params_to_state_dict(_np_tree(state0.params), tcfg.distiller))
    inputs = str(out / "inputs.pt")
    torch.save({"cases": spec}, inputs)
    port = pd.free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(port), inputs,
                               str(out)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        want = {}
        for name, jd in jax_distillers.items():
            # the step donates its state: each case steps from a copy
            step, state, steps = jd.make_train_step(), jax.tree_util.tree_map(jnp.copy, state0), []
            for batch in batches:
                state, lg = step(state, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                                 jnp.asarray(RAND, jnp.int32), jax.random.PRNGKey(2))
                steps.append({"logs": {k: float(v) for k, v in lg.items()},
                              "params": _np_tree(state.params)})
            ev = jax.tree_util.tree_map(jnp.asarray, _eval_batch())
            steps.append({"eval": {k: float(v) for k, v in jd.make_eval_step()(
                state, tp, ev, jnp.asarray(RAND, jnp.int32)).items()}})
            want[name] = steps
        for p in procs:
            log, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, log.decode(errors="replace")[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return want, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_jax_process(case, dp_run):
    """Every log (loss, grad_norm, lr, the per-layer terms) within LOSS_TOL
    and every parameter within PARAM_TOL of the JAX Distiller's step on the
    whole global batch, after each of the two steps."""
    want, ranks = dp_run
    _, tcfg = _configs(loss=CASES[case])
    for i, w in enumerate(want[case][:-1]):
        for rank in ranks:
            got = rank[case]["steps"][i]
            assert set(got["logs"]) == set(w["logs"]), i
            for k, v in w["logs"].items():
                np.testing.assert_allclose(got["logs"][k], v, err_msg=f"step {i} {k}",
                                           **LOSS_TOL)
        want_sd = jax_student_params_to_state_dict(w["params"], tcfg.distiller)
        got_sd = ranks[0][case]["steps"][i]["params"]
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                       err_msg=f"step {i} {k}", **PARAM_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_evaluate_the_global_batch(case, dp_run):
    """After the steps, each rank's eval_step on its stripe of a batch with
    a ragged and a fabricated row gives the JAX eval step's logs on the
    whole batch (v_loss included), the same on both ranks."""
    want, ranks = dp_run
    w = want[case][-1]["eval"]
    for rank in ranks:
        assert set(rank[case]["eval"]) == set(w)
        for k, v in w.items():
            np.testing.assert_allclose(rank[case]["eval"][k], v, err_msg=k, **LOSS_TOL)
    assert ranks[0][case]["eval"] == ranks[1][case]["eval"]


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_bit_for_bit(case, dp_run):
    """After each step the two ranks hold the same parameters and logs bit
    for bit, and they draw the loop's random layers alike; their dropout
    seeds differ."""
    _, (r0, r1) = dp_run
    for s0, s1 in zip(r0[case]["steps"], r1[case]["steps"]):
        assert s0["logs"] == s1["logs"]
        assert all(torch.equal(s0["params"][k], s1["params"][k]) for k in s0["params"])
        assert s0["seed"] != s1["seed"]
    assert r0[case]["rand_layers"] == r1[case]["rand_layers"]
    assert len({tuple(r) for r in r0[case]["rand_layers"]}) > 1 or \
        len(r0[case]["rand_layers"][0]) == 1


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{pd.free_port()}", rank=0,
                            world_size=1)
    try:
        yield pd.DataParallel.from_process_group()
    finally:
        dist.destroy_process_group()


def test_one_rank_through_the_data_parallel_path_is_the_plain_step(one_rank_group):
    """World 1: the all-reduces and the broadcast change no bit of the
    loss, grad_norm, lr or parameters, in either case; rank 0 keeps the
    plain step's dropout seeds."""
    dp = one_rank_group
    assert (dp.rank, dp.world) == (0, 1)
    gen = torch.Generator().manual_seed(0)
    for loss in CASES.values():
        _, tcfg = _configs(loss=loss)
        geom = TeacherGeometry(**TEACHER)
        from fithubert_tpu_torch.models.student import StudentModel
        from fithubert_tpu_torch.models.teacher import TeacherModel

        t_sd = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
        s_sd = StudentModel(tcfg.distiller, device="cpu").init_weights(gen).state_dict()
        plain, via_dp = (Distiller(tcfg, t_sd, s_sd, device="cpu",
                                   num_training_steps=N_TRAIN_STEPS, teacher_geometry=geom,
                                   dp=d) for d in (None, dp))
        for batch in _global_batches():
            assert plain.train_step(batch, RAND) == via_dp.train_step(batch, RAND)
            assert plain._seed(1) == via_dp._seed(1)
        for a, b in zip(plain.params, via_dp.params):
            assert torch.equal(a, b)
        ev = {k: v[0] for k, v in _global_batches(1)[0].items()}
        assert plain.eval_step(ev, RAND) == via_dp.eval_step(ev, RAND)


# ---------------------------------------------------------------- the loop
def _torchrun(yaml_path, log):
    return (f"{sys.executable} -m torch.distributed.run --nproc_per_node={WORLD} "
            f"--master_addr=127.0.0.1 --master_port={pd.free_port()} "
            f"{os.path.join(ROOT, 'train_torch.py')} -c {yaml_path} --device cpu > {log} 2>&1")


@pytest.fixture(scope="module")
def torchrun_loop(tmp_path_factory):
    """Two launches of train_torch.py under torchrun, one after the other,
    started in the background (the step's fixture asks for this one first,
    so they run while JAX compiles): epoch 0 (max_steps 2), then a resume
    that runs epoch 1. Yields (the launches' process, their directory)."""
    d = tmp_path_factory.mktemp("loop")
    cfg = tc.load_experiment_yaml(os.path.join(ROOT, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_num_batches=4,
                                      synthetic_wav_length=4000),
        train=dataclasses.replace(cfg.train, output_dir=str(d / "run"), log_every=1,
                                  max_steps=2))
    tc.dump_config(cfg, str(d / "first.yaml"))
    tc.dump_config(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=0)),
                   str(d / "second.yaml"))
    script = " && ".join(_torchrun(d / f"{n}.yaml", d / f"{n}.log") for n in ("first", "second"))
    proc = subprocess.Popen(["bash", "-c", script], cwd=str(d), env=_env())
    try:
        yield proc, d
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_the_loop_under_torchrun_writes_once_and_resumes_on_both_ranks(torchrun_loop):
    """Each launch's ranks return the same result (2 steps, then 4 after the
    resume, which both ranks report); rank 0 alone wrote one config.yaml
    (and at most one timestamped copy per launch), each step's log once, one
    checkpoint tree and the export pair."""
    proc, d = torchrun_loop
    proc.wait(timeout=2 * RANK_TIMEOUT)
    logs = {n: (d / f"{n}.log").read_text() if (d / f"{n}.log").exists() else ""
            for n in ("first", "second")}
    assert proc.returncode == 0, (logs["first"] + logs["second"])[-4000:]
    results = {n: [eval(line) for line in log.splitlines() if line.startswith("{'")]
               for n, log in logs.items()}
    for name, steps in (("first", 2), ("second", 4)):
        assert len(results[name]) == WORLD and results[name][0] == results[name][1]
        assert results[name][0]["steps"] == steps and not results[name][0]["preempted"]
    assert logs["second"].count("[resume] restored step 2") == WORLD
    out = d / "run"
    names = os.listdir(out)
    assert {"config.yaml", "student.yaml", "student.pt", "metrics.jsonl", "ckpt"} <= set(names)
    assert 1 <= len([n for n in names if n.endswith(".yaml")]) - 2 <= 2
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "val/v_loss" in r] == [2, 4]
    assert sorted(os.listdir(out / "ckpt" / "last")) == ["step_4.pt"]
    assert sorted(os.listdir(out / "ckpt" / "best")) == ["index.json", "step_2.pt",
                                                           "step_4.pt"]


def test_a_signal_on_one_rank_stops_every_rank_on_the_same_step(tmp_path):
    """SIGTERM on rank 1 after step 2: at that log boundary both ranks stop,
    last/ holds step 2 once, and both report the preemption."""
    cfg = tc.load_experiment_yaml(os.path.join(ROOT, "configs", "smoke.yaml"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic_num_batches=8,
                                      synthetic_wav_length=4000),
        train=dataclasses.replace(cfg.train, output_dir=str(tmp_path), log_every=1,
                                  max_steps=0))
    got = pd.launch(test_torch_ddp_worker.sigterm_on_rank_1, WORLD, cfg,
                    timeout=RANK_TIMEOUT)
    for result, steps in got:
        assert result == {"best_v_loss": float("inf"), "steps": 2, "preempted": True}
        assert steps == [1, 2]
    assert os.listdir(tmp_path / "ckpt" / "last") == ["step_2.pt"]
    assert os.listdir(tmp_path / "ckpt" / "best") == []


# ---------------------------------------------------------------- launch
def test_run_training_alone_builds_once_and_spawns_a_rank_per_card(monkeypatch, tmp_path):
    """Without torchrun and with num_devices 0 over two visible cards,
    run_training builds the kernels once, then starts two ranks of itself
    on the card, and returns rank 0's result; it writes nothing itself."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    from fithubert_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "build_all", lambda names: calls.append(("build", names)))
    monkeypatch.setattr(loop, "launch", lambda fn, n, *args: calls.append(
        ("launch", fn, n, args)) or [{"rank": 0}, {"rank": 1}])
    for k in pd.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    cfg = tc.ExperimentConfig(train=tc.TrainConfig(num_devices=0,
                                                   output_dir=str(tmp_path / "run")))
    assert loop.run_training(cfg, resume=False) == {"rank": 0}
    assert calls[0][0] == "build" and calls[1][:3] == ("launch", loop.run_training, 2)
    assert calls[1][3] == (cfg, False, False, "cuda")
    assert not (tmp_path / "run").exists()


def test_launch_spawns_ranks_that_join_one_group():
    got = pd.launch(test_torch_ddp_worker.summed_rank, WORLD, timeout=RANK_TIMEOUT)
    assert got == [(r, WORLD, float(sum(range(1, WORLD + 1)))) for r in range(WORLD)]


def test_launch_stops_every_rank_when_one_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        pd.launch(test_torch_ddp_worker.fail_on_rank_1, WORLD, timeout=RANK_TIMEOUT)


def test_maybe_initialize_without_torchrun_does_nothing(monkeypatch):
    for k in pd.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert pd.maybe_initialize("cpu") == (0, 1, torch.device("cpu"))
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK"):
        pd.maybe_initialize("cpu")


def test_a_rank_whose_card_is_missing_raises(monkeypatch):
    """LOCAL_RANK naming a card that is not there raises; it does not move
    the rank to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1"):
        pd.maybe_initialize("cuda")
    assert not dist.is_initialized()


def test_two_conformer_ranks_match_one_jax_process():
    """A rel_pos conformer over two gloo ranks, each on its stripe of a
    global batch of 2 microbatches (rank 1's row of microbatch 1 is all
    padding: its rank holds no valid row there), against the JAX
    Distiller's one-process step on the whole batch, fp32, no dropout: the
    logs to LOSS_TOL, every parameter and both BatchNorm running statistics
    of every layer to PARAM_TOL (tests/test_torch_conformer.py's), and the
    two ranks' states bit-identical."""
    from tests import test_torch_conformer as tconf

    jcfg, tcfg = tconf._pair(pos_enc_type="rel_pos")
    jexp, texp = tconf._experiments(jcfg, tcfg, num_devices=WORLD)
    jd = JDistiller(jexp, mesh=make_mesh(1), num_training_steps=10,
                    teacher_geometry=JGeometry(**tconf.TEACHER, use_pallas_attention=False))
    wav = jnp.zeros((2, 2000), jnp.float32)
    tp = jax.jit(jd.init_teacher_params)(jax.random.PRNGKey(0), wav)
    state = jax.jit(jd.init_state)(jax.random.PRNGKey(1), wav)
    geom = TeacherGeometry(**tconf.TEACHER)
    t_state = jax_teacher_params_to_state_dict(tp["params"], geom)
    s_state = jax_student_params_to_state_dict(jax.device_get(state.params), tcfg,
                                               jax.device_get(state.extra_vars["batch_stats"]))
    batch = tconf._step_batches(1)[0]
    state, jl = jd.make_train_step()(state, tp, jax.tree_util.tree_map(jnp.asarray, batch),
                                     jnp.zeros((0,), jnp.int32), jax.random.PRNGKey(2))
    want_sd = jax_student_params_to_state_dict(jax.device_get(state.params), tcfg,
                                               jax.device_get(state.extra_vars["batch_stats"]))
    ranks = pd.launch(test_torch_ddp_worker.specaug_step_rank, WORLD, texp, t_state, s_state,
                      geom, batch, timeout=RANK_TIMEOUT)
    for logs, params in ranks:
        for k, v in jl.items():
            np.testing.assert_allclose(logs[k], float(v), err_msg=k, **tconf.LOSS_TOL)
        assert set(params) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(params[k], v.numpy(), err_msg=k, **tconf.PARAM_TOL)
    (l0, p0), (l1, p1) = ranks
    assert l0 == l1
    stats = [k for k in p0 if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * tcfg.encoder_layers
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
