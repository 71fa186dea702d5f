"""The port's own spans, counters and phase times (``utils/profiling.py``)
on the CPU: the span helper in and out of the profiler, the served call's
spans and byte counter, the launch counts kept in the one registry, the
graph replay's staging spans, the train step's phases, and the step's
numbers unchanged by them."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.export.expert import UpstreamExpert
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels.philox import seed_tensor
from fithubert_tpu_torch.train.step import PHASES, Distiller
from fithubert_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CPU"]


def _named(prof, prefix):
    """(name, start ns, end ns) of the CPU events whose name starts with
    ``prefix``, in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in _host_events(prof) if e.name().startswith(prefix)),
                  key=lambda r: r[1])


# ------------------------------------------------------------------ span
def test_a_span_outside_the_profiler_is_the_one_shared_no_op():
    a, b = profiling.span("x.a"), profiling.span("x.b")
    assert a is b is profiling._OFF
    with a:
        with b:
            pass


def test_spans_nest_by_name_in_a_cpu_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("test.outer") is not profiling._OFF
        with profiling.span("test.outer"):
            with profiling.span("test.inner"):
                torch.zeros(4).add_(1)
    assert profiling.span("test.outer") is profiling._OFF
    (outer, o0, o1), (inner, i0, i1) = _named(prof, "test.")
    assert (outer, inner) == ("test.outer", "test.inner")
    assert o0 <= i0 < i1 <= o1


# ------------------------------------------------------------------ counters
def test_counts_under_the_profiler_keep_their_time_on_the_traces_clock():
    before = len(profiling.COUNTED)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("test.counted"):
            profiling.count("test_bytes", 7)
    profiling.count("test_bytes", 5)  # outside: counted, no time kept
    assert profiling.COUNTS["test_bytes"] >= 12
    kept = profiling.COUNTED[before:]
    assert [(c, n) for _t, c, n in kept] == [("test_bytes", 7)]
    (_name, s, e), = _named(prof, "test.counted")
    assert s <= kept[0][0] <= e


def test_launch_counts_live_in_the_one_registry_and_show_alone():
    _build.reset_launches()
    profiling.count("h2d_bytes", 100)
    _build.count_launch("test_kernel_cuda")
    _build.count_launch("test_kernel_cuda")
    assert _build.LAUNCHES["test_kernel_cuda"] == 2
    assert profiling.COUNTS["test_kernel_cuda"] == 2
    assert "h2d_bytes" not in _build.LAUNCHES and "h2d_bytes" in profiling.COUNTS
    assert dict(_build.LAUNCHES) == {"test_kernel_cuda": 2} and len(_build.LAUNCHES) == 1
    _build.reset_launches()
    assert not _build.LAUNCHES and dict(_build.LAUNCHES) == {}
    assert "h2d_bytes" in profiling.COUNTS  # a byte counter is no launch count


def _refused(call):
    x = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 64)
    seed = seed_tensor(1, 2)
    return {
        "fwd": lambda: fa._fwd_kernel(x, x, x, None, 0.0, None),
        "fwd_dropout": lambda: fa._fwd_kernel(x, x, x, None, 0.1, seed),
        "bwd_prep": lambda: fa.bwd_prep_cuda(x, x),
        "bwd_fused": lambda: fa.bwd_fused_cuda(x, x, x, None, lse, x, lse),
        "dq_sum": lambda: fa.dq_sum_cuda(torch.zeros(1, 2, 64, 2, 16)),
        "k1_prefix": lambda: cf._gn_prefix_kernel(torch.zeros(2, 8, 8),
                                                  torch.zeros(2, 8), torch.zeros(2, 8)),
    }[call]


@pytest.mark.parametrize("call, name", [("fwd", fa.KERNEL), ("fwd_dropout", fa.KERNEL_DROPOUT),
                                        ("bwd_prep", fa.KERNEL_BWD_PREP),
                                        ("bwd_fused", fa.KERNEL_BWD),
                                        ("dq_sum", fa.KERNEL_DQ_SUM),
                                        ("k1_prefix", cf.KERNEL_PREFIX)])
def test_a_wrapper_that_refuses_its_tensors_counts_nothing(call, name):
    """A CPU wrapper that refuses its tensors launches and counts nothing;
    its host work still shows in a span named after its launch counter."""
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        _refused(call)()
    assert dict(_build.LAUNCHES) == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            _refused(call)()
    assert [n for n, _s, _e in _named(prof, name) if n == name] == [name]
    assert dict(_build.LAUNCHES) == before


# ------------------------------------------------------------------ serving
def _expert():
    cfg = dataclasses.replace(tc.load_experiment_yaml("configs/smoke.yaml").distiller,
                              init_conv_layers=False, init_encoder_layers=0)
    gen = torch.Generator().manual_seed(0)
    state = StudentModel(cfg, device="cpu").init_weights(gen).state_dict()
    return UpstreamExpert(state, cfg, device="cpu", length_quantum=1600)


def _wavs(lengths=(3000, 5200, 4100)):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def test_a_served_call_shows_its_three_spans_in_order_and_counts_its_copies():
    expert, wavs = _expert(), _wavs()
    t_pad = 6400  # 5200 up to the quantum
    before = profiling.COUNTS.get("h2d_bytes", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = expert(wavs)
    spans = _named(prof, "expert.")
    assert [n for n, _s, _e in spans] == ["expert.pad", "expert.h2d", "expert.model"]
    assert all(spans[i][2] <= spans[i + 1][1] for i in range(2))
    batch = np.zeros((3, t_pad), np.float32)
    mask = np.ones((3, t_pad), bool)
    assert profiling.COUNTS["h2d_bytes"] - before == batch.nbytes + mask.nbytes == 3 * t_pad * 5
    assert out["last_hidden_state"].shape[0] == 3


def test_the_served_answer_is_the_same_under_the_profiler():
    expert, wavs = _expert(), _wavs()
    plain = expert(wavs)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = expert(wavs)
    for k in ("last_hidden_state", "padding_mask"):
        assert torch.equal(plain[k], traced[k])


# ------------------------------------------------------------------ train
def _distiller():
    cfg = tc.load_experiment_yaml("configs/smoke.yaml")
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry.from_teacher_config(cfg.teacher)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(cfg.distiller, device="cpu").init_weights(gen).state_dict()
    return Distiller(cfg, t_state, s_state, device="cpu", num_training_steps=10)


def _batches(n, a=1):
    rng = np.random.default_rng(0)
    return [{"x": (rng.standard_normal((a, 2, 4000)) * 0.3).astype(np.float32),
             "padding_mask": np.zeros((a, 2, 4000), bool)} for _ in range(n)]


def test_a_cpu_step_gives_four_phases_within_its_wall():
    import time

    d = _distiller()
    assert d.phase_ms() == []
    t0 = time.perf_counter()
    d.train_step(_batches(1)[0], torch.tensor([0]))
    wall_ms = (time.perf_counter() - t0) * 1e3
    (phases,) = d.phase_ms()
    assert tuple(phases) == PHASES
    assert all(v >= 0 for v in phases.values())
    assert 0 < sum(phases.values()) <= wall_ms


def test_unfolded_microbatches_sum_their_phases():
    d = _distiller()
    d.cfg = dataclasses.replace(d.cfg, train=dataclasses.replace(d.cfg.train,
                                                                 fuse_grad_accum=False))
    d.train_step(_batches(1, a=2)[0], torch.tensor([0]))
    marks = [p for p, _t in d._eager_timer.marks]
    assert marks == [None] + list(PHASES[:3]) * 2 + [PHASES[3]]
    (phases,) = d.phase_ms()
    segs = d._eager_timer.segments()
    for name in PHASES:
        assert phases[name] == pytest.approx(sum(t1 - t0 for p, t0, t1 in segs if p == name))


def test_the_phases_change_no_bit_of_the_steps():
    """The losses and parameters of CPU steps with the phase marks taken
    equal those with every mark a no-op, bit for bit."""
    rand = torch.tensor([0])
    batches = _batches(3)
    marked, bare = _distiller(), _distiller()
    got = [marked.train_step(b, rand) for b in batches]
    saved = profiling.PhaseTimer.mark
    profiling.PhaseTimer.mark = lambda self, phase=None: None
    try:
        want = [bare.train_step(b, rand) for b in batches]
    finally:
        profiling.PhaseTimer.mark = saved
    assert got == want
    for p, q in zip(marked.params, bare.params):
        assert torch.equal(p, q)


def test_phase_groups_split_at_unnamed_marks():
    t = profiling.PhaseTimer("cpu")
    t.marks = [(None, 0.0), ("a", 0.001), ("b", 0.003), (None, 0.004), ("a", 0.006),
               ("b", 0.007)]
    assert [(p, round(x, 9), round(y, 9)) for p, x, y in t.segments()] == [
        ("a", 0.0, 1.0), ("b", 1.0, 3.0), (None, 3.0, 4.0), ("a", 4.0, 6.0), ("b", 6.0, 7.0)]
    got = t.phase_ms()
    assert len(got) == 2
    assert got[0] == pytest.approx({"a": 1.0, "b": 2.0})
    assert got[1] == pytest.approx({"a": 2.0, "b": 1.0})


def test_a_deferred_reading_settles_only_once_the_profiler_stops():
    profiling.READINGS.pop("test.reading", None)
    calls = []
    profiling.defer("test.reading", lambda: calls.append(1) or "first")  # not recording
    profiling.settle()
    assert "test.reading" not in profiling.READINGS
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.defer("test.reading", lambda: calls.append(1) or "first")
        profiling.defer("test.reading", lambda: calls.append(2) or "second")
        profiling.settle()  # still recording: nothing runs
        assert calls == [] and "test.reading" not in profiling.READINGS
    profiling.settle()
    profiling.settle()
    assert calls == [2] and profiling.READINGS["test.reading"] == "second"


def test_a_replay_stages_in_its_four_spans(monkeypatch):
    """``_replay`` on the CPU, the graph's replay a stand-in: the batches,
    the lrs, the draws and the launch each in their span, in order, and the
    deferred phases settled at the next replay after the profile."""
    from fithubert_tpu_torch.train.step import _Chain, _Staged

    d = _distiller()
    timer = profiling.PhaseTimer("cpu")
    replays = []

    class Graph:
        def replay(self):
            timer.marks = [(None, 0.0), ("step.teacher", 0.002)]
            replays.append(1)

    inputs = [tuple(torch.zeros(2) for _ in range(2))]
    chain = _Chain(Graph(), [tuple(torch.zeros(2) for _ in range(2))], torch.zeros(1),
                   _Staged(), torch.zeros(1, 2), ("a", "b"), timer, 0.0)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    profiling.READINGS.pop("step.phases", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d._replay(chain, inputs)
    assert [n for n, _s, _e in _named(prof, "chain.")] == [
        "chain.batches", "chain.lrs", "chain.draws", "chain.launch"]
    assert "step.phases" not in profiling.READINGS
    d._replay(chain, inputs)  # settles the profiled replay's phases first
    assert profiling.READINGS["step.phases"] == [("step.teacher", 0.0, 2.0)]
    assert len(replays) == 2
