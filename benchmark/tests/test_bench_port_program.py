"""The readers of the program's own spans, counters and phases on a
synthetic stretch: serving's host split, its bytes copied, the kernel
wrappers' host time, the replay's draws, the train step's phases and their
largest device ops, the idle gaps named by the program's spans, and
nothing read (no error) from a program that keeps no such record."""

from types import SimpleNamespace

import pytest

from benchmark import harness, program
from benchmark.trace import Record, Stretch
from fithubert_tpu_torch.utils import profiling

US = 1_000
T0 = 1_800_000_000_000_000_000  # the stretch's start, unix ns as the trace stamps it


def _serve_stretch():
    """Two served calls of 100 us each: pad 30 us (the card idle), the copy
    10 us (a memcpy), the model 20 us (two kernel wrappers of 5 us and 4
    us), then the card's work and the harness's sync."""
    host, device = [], []
    for c in range(2):
        at = T0 + c * 100 * US
        host += [Record("bench.call", at, at + 100 * US),
                 Record("expert.pad", at, at + 30 * US),
                 Record("expert.h2d", at + 30 * US, at + 40 * US),
                 Record("aten::copy_", at + 31 * US, at + 39 * US),
                 Record("expert.model", at + 40 * US, at + 60 * US),
                 Record("conv_stack_cuda", at + 41 * US, at + 46 * US),
                 Record("flash_attention_fwd_cuda", at + 50 * US, at + 54 * US)]
        device += [Record("Memcpy HtoD (Pageable -> Device)", at + 31 * US, at + 39 * US),
                   Record("void conv_layer_wgmma<1>(int)", at + 46 * US, at + 70 * US),
                   Record("void flash_fwd_wgmma<64>(int)", at + 70 * US, at + 98 * US)]
    host.append(Record("bench.sync", T0 + 200 * US, T0 + 201 * US))
    host.append(Record("expert.pad", T0 - 50 * US, T0 - 20 * US))  # the call before the stretch
    kernels = [r for r in device if not r.name.startswith("Memcpy")]
    fams = {"void conv_layer_wgmma<1>(int)": "conv", "void flash_fwd_wgmma<64>(int)": "attention"}
    return Stretch(T0, T0 + 201 * US, kernels, device, host, fams)


def _serve_reading():
    return SimpleNamespace(kind="serve", stretch=_serve_stretch(), units=[{}, {}])


def test_serving_host_split_per_call():
    r = _serve_reading()
    assert harness.load_metric("pad_ms.serve").read(r) == pytest.approx(0.030)
    assert harness.load_metric("h2d_ms.serve").read(r) == pytest.approx(0.010)
    assert harness.load_metric("launch_ms.serve").read(r) == pytest.approx(0.009)
    assert program.span_ms(r.stretch, ["expert.model"]) == pytest.approx(0.020)
    assert program.calls(r.stretch) == 2


def test_a_serving_gap_inside_the_padding_is_named_by_its_span():
    gaps = _serve_stretch().breakdown()["idle_gaps"]
    # each call's padding with the card idle: 98-131 us into the stretch,
    # then its first 31 us; 7 us while the model is enqueued
    assert [g[0] for g in gaps[:3]] == ["expert.pad", "expert.pad", "conv_stack_cuda"]
    assert [g[1] for g in gaps[:3]] == pytest.approx([33e-6, 31e-6, 7e-6])
    assert all(name != "bench.call" for name, s in gaps if s >= 10e-6)


def test_bytes_copied_over_the_stretch_per_call(monkeypatch):
    kept = [(T0 - 40 * US, "h2d_bytes", 999),  # before the stretch
            (T0 + 35 * US, "h2d_bytes", 1_000_000), (T0 + 35 * US, "conv_stack_cuda", 1),
            (T0 + 135 * US, "h2d_bytes", 3_000_000),
            (T0 + 500 * US, "h2d_bytes", 7)]  # after it
    monkeypatch.setattr(profiling, "COUNTED", kept)
    r = _serve_reading()
    assert harness.load_metric("h2d_mb.serve").read(r) == pytest.approx(2.0)
    assert program.counted(r.stretch, "conv_stack_cuda") == 1


def _train_stretch():
    """One call of two graphed steps: staging on the host, then the replay's
    kernels; each step 10 us of teacher, 20 of student, 30 of backward, 10
    of optim, 2 us between the steps (the next step's lr copy)."""
    launch = T0 + 20 * US
    host = [Record("bench.call", T0, T0 + 30 * US),
            Record("chain.batches", T0, T0 + 5 * US),
            Record("chain.lrs", T0 + 5 * US, T0 + 6 * US),
            Record("chain.draws", T0 + 6 * US, T0 + 20 * US),
            Record("chain.launch", launch, launch + 8 * US),
            Record("bench.sync", T0 + 30 * US, T0 + 200 * US)]
    a = launch + 10 * US  # the first kernel: the replay's first mark's place
    kernels = []
    for step in range(2):
        s = a + step * 72 * US
        kernels += [Record("void teacher_gemm(int)", s, s + 10 * US),
                    Record("void student_gemm(int)", s + 10 * US, s + 25 * US),
                    Record("void direct_copy(int)", s + 25 * US, s + 30 * US),
                    Record("void dgrad(int)", s + 30 * US, s + 60 * US),
                    Record("void adam(int)", s + 60 * US, s + 70 * US)]
    return Stretch(T0, T0 + 200 * US, kernels, kernels, host, {})


SEGMENTS = [("step.teacher", 0.0, 0.010), ("step.student", 0.010, 0.030),
            ("step.backward", 0.030, 0.060), ("step.optim", 0.060, 0.070),
            (None, 0.070, 0.072),
            ("step.teacher", 0.072, 0.082), ("step.student", 0.082, 0.102),
            ("step.backward", 0.102, 0.132), ("step.optim", 0.132, 0.142)]


@pytest.mark.parametrize("metric, ms", [("teacher_ms.train", 0.010), ("student_ms.train", 0.020),
                                        ("backward_ms.train", 0.030),
                                        ("optim_ms.train", 0.010)])
def test_phases_a_step_of_the_last_replay(monkeypatch, capsys, metric, ms):
    monkeypatch.setattr(profiling, "READINGS", {"step.phases": SEGMENTS})
    monkeypatch.setattr(profiling, "_deferred", {})
    r = SimpleNamespace(kind="train", stretch=_train_stretch(), units=[{}, {}])
    assert harness.load_metric(metric).read(r) == pytest.approx(ms)
    assert metric.split("_")[0] in capsys.readouterr().err


def test_each_phases_largest_ops_sit_where_its_events_put_them(monkeypatch):
    monkeypatch.setattr(profiling, "READINGS", {"step.phases": SEGMENTS})
    st = _train_stretch()
    # an earlier call's replay, still running when the last was enqueued
    early = [Record("void earlier(int)", T0 + 21 * US + i * US, T0 + 22 * US + i * US)
             for i in range(10)]
    st.host.insert(0, Record("chain.launch", T0 + 2 * US, T0 + 3 * US))
    st.host.insert(0, Record("bench.call", T0 + 1 * US, T0 + 4 * US))
    st.kernels[:0] = early
    assert program.top_ops(st, "step.student") == [("student_gemm", pytest.approx(0.030)),
                                                    ("direct_copy", pytest.approx(0.010))]
    assert program.top_ops(st, "step.teacher") == [("teacher_gemm", pytest.approx(0.020))]
    assert program.top_ops(st, "step.optim", top=1) == [("adam", pytest.approx(0.020))]


def test_a_phase_reading_deferred_past_the_stretch_is_settled_by_the_reader(monkeypatch):
    monkeypatch.setattr(profiling, "READINGS", {})
    monkeypatch.setattr(profiling, "_deferred", {"step.phases": lambda: SEGMENTS})
    want = {"step.teacher": 0.010, "step.student": 0.020, "step.backward": 0.030,
            "step.optim": 0.010}
    assert program.step_phases() == [pytest.approx(want), pytest.approx(want)]
    assert profiling.READINGS["step.phases"] == SEGMENTS and not profiling._deferred


def test_the_replays_draws_per_call():
    r = SimpleNamespace(kind="train", stretch=_train_stretch(), units=[{}, {}])
    assert harness.load_metric("draws_ms.train").read(r) == pytest.approx(0.014)


@pytest.mark.parametrize("metric", ["pad_ms.serve", "h2d_ms.serve", "h2d_mb.serve",
                                    "launch_ms.serve", "draws_ms.train", "teacher_ms.train",
                                    "student_ms.train", "backward_ms.train", "optim_ms.train"])
def test_a_program_without_the_record_reads_nothing(monkeypatch, metric):
    """An older program: no program spans in the trace, a profiling module
    without the counters' times or the deferred readings."""
    plain = SimpleNamespace(StepTimer=object, trace=None)
    monkeypatch.setattr(program, "_profiling", lambda: plain)
    kind = metric.split(".")[1]
    host = [Record("bench.call", T0, T0 + 10 * US), Record("aten::copy_", T0, T0 + US)]
    st = Stretch(T0, T0 + 10 * US, [], [], host, {})
    assert harness.load_metric(metric).read(SimpleNamespace(kind=kind, stretch=st,
                                                            units=[{}])) is None
