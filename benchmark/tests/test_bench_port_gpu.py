"""On the card: each cell runs end to end for a short window, traced and
untraced, and its result line meets the contract; a train cell whose graph
replays are broken underneath comes out not correct (needs a CUDA card;
run with ``python -m pytest benchmark/tests/test_bench_port_gpu.py`` on the
chip machine)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults

pytestmark = pytest.mark.gpu
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["fithubert.train", "distilhubert.serve", "distilhubert.train"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(card, cell, trace):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2 ** 31 + 97), "--seconds", "3", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        want = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
        assert set(out["metrics"]) == want
        for name, m in out["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
        assert 0 < len(out["breakdown"]["device_ops"]) <= 10
    else:
        want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == want
        assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault", ["stale_batches"])
@pytest.mark.parametrize("cell", ["fithubert.train", "distilhubert.train"])
def test_a_faulty_graph_replay_is_not_correct(card, capsys, cell, fault):
    """A fault that only a CUDA-graph replay can have: the CPU runs no
    graph, so only the card shows that the comparison sees it. (Frozen
    draws read as a sound run in every compared number: another dropout
    realisation moves no loss or norm beyond rounding.)"""
    from benchmark import run

    argv = ["--workload", cell, "--seed", str(2 ** 31 + 98), "--seconds", "2", "--trace", "0"]
    assert run.main(argv, fault=faults.REPLAY[fault]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]
