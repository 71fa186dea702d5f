"""The control and the faults come out as not correct under each cell's
limits: the reference computed in float8 in the program's place, and the
program with a fault planted under the timed path (a step that returns
its state unchanged; half of the batch left out; a served answer
altered). At a tiny size on the CPU; ``control.py`` reads them on the card
at the cells' own sizes."""

import json

import pytest
import torch

from benchmark import compare, faults, harness, weights
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 31


@pytest.mark.parametrize("kind", ["fithubert", "distilhubert"])
def test_float8_control_is_not_correct(kind):
    cell = tiny_cell(kind)
    cfg = harness.experiment(cell, SEED)
    pool, _ = harness.train_pool(cell, cfg, SEED, CPU)
    batches = harness.compared_batches(pool, harness.compared_steps(cfg))
    picks = harness.rand_layers(cfg, SEED)
    ref = harness.reference_steps(cell, SEED, batches, picks, CPU)
    ctrl = harness.reference_steps(cell, SEED, batches, picks, CPU, quant="fp8")
    readings = compare.train_readings(ctrl, ref, weights.student_state(cell.config, SEED, CPU))
    assert not compare.judge(readings, compare.load_limits(f"{kind}.train")), readings


def _run(capsys, cell, fault=None):
    """A whole run of ``cell`` on the CPU (the look for a card skipped):
    the result line's ``correct`` and its checks."""
    from benchmark import run

    argv = ["--workload", cell.name, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"]
    assert run.main(argv, device="cpu", cell=cell, fault=fault) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and "setup_s" in out["metrics"]
    return out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["fithubert", "distilhubert"])
def test_a_sound_run_is_correct(capsys, kind):
    """The same run in fp32, where the program agrees with the reference to
    rounding, with no fault: the faults below fail on the fault alone."""
    correct, checks = _run(capsys, tiny_cell(kind, fp16=False))
    assert correct, checks


@pytest.mark.parametrize("kind, fault", [(k, f) for k in ("fithubert", "distilhubert")
                                         for f in sorted(faults.TRAIN)])
def test_a_faulty_train_step_is_not_correct(capsys, kind, fault):
    correct, checks = _run(capsys, tiny_cell(kind, fp16=False), faults.TRAIN[fault])
    assert not correct, checks


def test_serving_sound_and_altered(capsys):
    cell = tiny_cell("distilhubert", fp16=False, mix="serve_b32")
    assert _run(capsys, cell)[0]
    correct, checks = _run(capsys, cell, faults.altered)
    assert not correct and checks["feature_gap"]["value"] > 0.5


def test_float8_control_of_serving_is_not_correct():
    cell = tiny_cell("distilhubert", mix="serve_b32")
    calls = harness.serve_pool(cell, SEED, CPU)[:2]
    from benchmark.reference import serve as ref_serve

    state = weights.student_state(cell.config, SEED, CPU, export=True)
    ctrl = [ref_serve.features(cell.config, state, w, 16000, CPU, "fp8") for w in calls]
    readings = harness.serve_compare(cell, SEED, calls, ctrl, CPU)
    assert not compare.judge(readings, compare.load_limits("distilhubert.serve")), readings
