"""A configuration, a traffic mix, a per-layer metric and a kernel family
are each found by name from files of their own: a copy of the benchmark
gains a dummy of each as new files and entries, and the harness picks
them up with no file of it edited."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import json, sys
sys.path.insert(0, ".")
from benchmark import harness, trace
cell = harness.Cell.load("dummy.cell", "BENCHMARK.json")
reader = harness.load_metric("dummy_ms.train")
print(json.dumps({"config": cell.config["name"], "mix": cell.mix["entry"],
                  "lengths": cell.lengths["sample_rate"], "metric": reader.read(None),
                  "families": sorted(trace.load_families())}))
"""


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "fithubert.json"))
    cfg["name"] = "dummy"
    (b / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"entry": "train_step_chain", "lengths": "librispeech_960", "pool_steps": 2}))
    (b / "metrics" / "dummy_ms.py").write_text("def read(r):\n    return 1.5\n")
    (b / "kernels" / "dummy.json").write_text(json.dumps(
        {"kernels": ["dummy_kernel"], "launch_counters": ["dummy_kernel_cuda"]}))
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms.train", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "ops",
                               "moves": "train_audio_s_per_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: open(os.path.join(ROOT, "benchmark", p), "rb").read()
              for p in ("harness.py", "run.py", "trace.py", "traffic.py")}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "dummy", "mix": "train_step_chain", "lengths": 16000,
                   "metric": 1.5, "families": ["attention", "conv", "dropout", "dummy"]}
    for p, text in before.items():
        assert open(tmp_path / "benchmark" / p, "rb").read() == text
