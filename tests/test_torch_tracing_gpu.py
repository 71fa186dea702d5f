"""The train step's phase times and the served call's spans on the card:
timing events recorded inside a CUDA-graph capture (``external=True``),
a captured chain's phases against the replay's device time, the replay's
logs against eager steps with the phases in both, and a served call's spans
and bytes under the profiler. Skipped where there is no CUDA card. On a
machine with one (and without JAX, which the suite's conftest imports):

    python -m pytest --noconftest tests/test_torch_tracing_gpu.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from fithubert_tpu_torch import config as tc
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.train.step import PHASES, Distiller
from fithubert_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

K = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_the_card_takes_timing_events_in_a_capture(dev):
    x = torch.randn(1024, 1024, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x @ x
    torch.cuda.current_stream().wait_stream(side)
    timer = profiling.PhaseTimer(dev, external=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        timer.mark()
        y = x @ x
        timer.mark("a")
        for _ in range(3):
            y = y @ x
        timer.mark("b")
    for _ in range(2):
        graph.replay()
        (got,) = timer.phase_ms()
        assert got["b"] > got["a"] > 0


def _distiller(dev):
    cfg = tc.load_experiment_yaml("configs/smoke.yaml")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_fp16=True))
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry.from_teacher_config(cfg.teacher)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(cfg.distiller, device="cpu").init_weights(gen).state_dict()
    return Distiller(cfg, t_state, s_state, device=dev, num_training_steps=50)


def _batches(dev, n, t=32000):
    rng = np.random.default_rng(1)
    return [{"x": torch.from_numpy((rng.standard_normal((1, 4, t)) * 0.3).astype(np.float32))
             .to(dev), "padding_mask": torch.zeros((1, 4, t), dtype=torch.bool, device=dev)}
            for _ in range(n)]


def test_a_chain_times_every_phase_of_every_step_of_a_replay(dev):
    d = _distiller(dev)
    batches = _batches(dev, 2 * K)
    rand = torch.tensor([0], device=dev)
    d.train_step_chain(batches[:K], rand)  # K eager warm-up steps, then the capture
    (eager,) = d.phase_ms()
    assert tuple(eager) == PHASES and all(v > 0 for v in eager.values())
    (chain,) = d._chains.values()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    replay = chain.graph.replay

    def timed():
        start.record()
        replay()
        end.record()

    chain.graph.replay = timed
    d.train_step_chain(batches[K:], rand)
    torch.cuda.synchronize()
    steps = chain.phase_ms()
    assert len(steps) == K
    for s in steps:
        assert tuple(s) == PHASES and all(v > 0 for v in s.values()), s
    total = sum(sum(s.values()) for s in steps)
    assert abs(total - start.elapsed_time(end)) <= 0.02 * start.elapsed_time(end)


def test_a_replays_logs_equal_eager_steps_with_the_phases_in_both(dev):
    rand = torch.tensor([0], device=dev)
    batches = _batches(dev, 2 * K)
    dg = _distiller(dev)
    dg.train_step_chain(batches[:K], rand)
    de = _distiller(dev)
    # a copy: AdamW's load_state_dict keeps tensors already on the card
    de.load_state_dict(copy.deepcopy(dg.state_dict()))
    got = [lg.to_floats() for lg in dg.train_step_chain(batches[K:], rand)]
    want = [de.train_step(b, rand) for b in batches[K:]]
    assert got == want
    for p, q in zip(dg.params, de.params):
        assert torch.equal(p, q)


def test_a_served_call_on_the_card_shows_its_spans_and_bytes(dev):
    from torch.profiler import ProfilerActivity, profile

    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.ops.kernels import _build

    cfg = dataclasses.replace(tc.load_experiment_yaml("configs/smoke.yaml").distiller,
                              init_conv_layers=False, init_encoder_layers=0)
    state = StudentModel(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    expert = UpstreamExpert(state, cfg, device=dev, length_quantum=16000)
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
            for i, n in enumerate((20000, 31000))]
    expert(wavs)
    torch.cuda.synchronize()
    before, launched = profiling.COUNTS.get("h2d_bytes", 0), dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        expert(wavs)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type().name == "CPU"]
    assert [n for n in names if n.startswith("expert.")] == [
        "expert.pad", "expert.h2d", "expert.model"]
    assert profiling.COUNTS["h2d_bytes"] - before == 2 * 32000 * 5
    spans = {n: names.count(n) for n in set(names) if n in launched}
    counted = {n: c - launched.get(n, 0) for n, c in _build.LAUNCHES.items()}
    assert spans and all(spans[n] == counted[n] for n in spans)
