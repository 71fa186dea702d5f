"""A configuration, its model family's reference module, a traffic mix, a
per-layer metric and a kernel family are each found by name from files of
their own: a copy of the benchmark gains a dummy of each as new files and
entries, and the harness picks them up with no file of it edited. The
module a configuration names (``reference.load``) must keep its contract."""

import glob
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import reference, work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HARNESS = ["harness.py", "run.py", "trace.py", "traffic.py", "weights.py", "work.py",
           "shapes.py"] + sorted(os.path.relpath(p, os.path.join(ROOT, "benchmark"))
                                 for p in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                                                 "*.py")))

# a model family of one leaf: its forward, FLOPs and launches are its own
DUMMY_REFERENCE = '''
import torch

from ..work import BF16_PEAK
from .model import QUANT


def teacher_spec(g):
    return [("teacher.weight", (2,), "fill", 3.0)]


def student_spec(d, export=False):
    return [("dummy.weight", (3,), "fill", 7.0 if export else 5.0)]


def teacher_forward(P, g, wav, wav_mask, q=None):
    return [], wav_mask


def student_forward(P, d, wav, wav_mask, drops=None, q=None, export=False):
    x = P["dummy.weight"].sum() * torch.ones(wav.shape[0], 2, 3, device=wav.device)
    return {"x": x, "hiddens": [x + 1], "mask": wav_mask[:, :2]}


def kd_loss(loss, d, proj, teacher_hiddens, rand_layers):
    return proj.sum()


def student_fwd_flops(d, n, live_heads=None):
    return 1000 * n


def kd_step_flops(d, g, lengths):
    return 3000 * sum(lengths)


def step_launches(cfg, lengths, t_pad):
    return []


def call_launches(cfg, lengths, t_pad):
    return [("conv", "dummy", int(BF16_PEAK) // 2, 0)]
'''

PROBE = r"""
import json, sys, types
sys.path.insert(0, ".")
import numpy as np
import torch
from benchmark import harness, shapes, trace, weights
from benchmark.reference import serve as ref_serve
cell = harness.Cell.load("dummy.cell", "BENCHMARK.json")
reader = harness.load_metric("dummy_ms.train")
cpu = torch.device("cpu")
state = weights.student_state(cell.config, 7, cpu, export=True)
wavs = [np.zeros(16000, np.float32), np.zeros(8000, np.float32)]
feats = ref_serve.features(cell.config, state, wavs, 16000, cpu)
second = [types.SimpleNamespace(start=0, end=10 ** 9)]
r = types.SimpleNamespace(cell=cell, kind="serve", units=[{"lengths": [16000, 8000],
                          "t_pad": 16000}], stretch=types.SimpleNamespace(
                          window_s=1.0, family=lambda _fam: second))
print(json.dumps({"config": cell.config["name"], "mix": cell.mix["entry"],
                  "lengths": cell.lengths["sample_rate"], "metric": reader.read(None),
                  "families": sorted(trace.load_families()),
                  "state": {k: v.tolist() for k, v in state.items()},
                  "features": feats["last_hidden_state"][:, 0, 0].tolist(),
                  "layers": [h[:, 0, 0].tolist() for h in feats["hidden_states"]],
                  "mfu": harness.load_metric("mfu_pct.serve").read(r),
                  "conv_roofline": shapes.roofline_pct(r, "conv")}))
"""


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "fithubert.json"))
    cfg.update(name="dummy", reference="dummy")
    (b / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (b / "reference" / "dummy.py").write_text(DUMMY_REFERENCE)
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
    before = {p: open(os.path.join(ROOT, "benchmark", p), "rb").read() for p in HARNESS}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "dummy", "mix": "train_step_chain", "lengths": 16000,
                   "metric": 1.5,
                   "families": ["attention", "conv", "dropout", "dummy", "pos_conv"],
                   # the dummy's leaf, its forward over it, its FLOPs and launches
                   "state": {"dummy.weight": [7.0, 7.0, 7.0]},
                   "features": [21.0, 21.0], "layers": [[22.0, 22.0]],
                   "mfu": 100.0 * 1000 * 24000 / work.BF16_PEAK, "conv_roofline": 50.0}
    for p, text in before.items():
        assert open(tmp_path / "benchmark" / p, "rb").read() == text, p


def _module(**drop_or_replace):
    """A copy of ``reference/model.py``'s contract with entries dropped
    (None) or replaced."""
    model = reference.load({})
    mod = types.ModuleType("benchmark.reference.broken")
    mod.QUANT = model.QUANT
    for name in reference.CONTRACT:
        setattr(mod, name, getattr(model, name))
    for name, value in drop_or_replace.items():
        if value is None:
            delattr(mod, name)
        else:
            setattr(mod, name, value)
    return mod


@pytest.mark.parametrize("broken", [
    {"call_launches": None},
    {"QUANT": {"fp32": lambda x: x}},
    {"student_forward": lambda P, d, wav, wav_mask, drops, q: None},  # no ``export``
    {"kd_step_flops": lambda d, g: 0},
])
def test_a_module_that_breaks_the_contract_is_refused(monkeypatch, broken):
    assert reference.load({"reference": "model"}).__name__ == "benchmark.reference.model"
    monkeypatch.setitem(sys.modules, "benchmark.reference.broken", _module())
    assert reference.load({"reference": "broken"}).step_launches
    monkeypatch.setitem(sys.modules, "benchmark.reference.broken", _module(**broken))
    with pytest.raises(TypeError, match="reference/broken.py"):
        reference.load({"reference": "broken"})


@pytest.mark.parametrize("stem", ["../model", "model.x", "", 3])
def test_a_reference_is_a_stem(stem):
    with pytest.raises(ValueError):
        reference.load({"reference": stem})
