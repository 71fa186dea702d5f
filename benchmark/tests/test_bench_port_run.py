"""run.py fails clearly where it cannot measure: no card, or no program."""

import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = ["--workload", "fithubert.train", "--seed", "2147483660", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
