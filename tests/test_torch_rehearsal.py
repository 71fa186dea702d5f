"""The port's dress rehearsal (fithubert_tpu_torch/scripts/dress_rehearsal.py):
its coupling to the port's log lines, as tests/test_dress_rehearsal.py pins
the JAX harness's to the JAX loop's, its watchdog, and one rehearsal of the
whole chain on the CPU (configs/smoke.yaml: train, SIGTERM after step 8, the
preemption checkpoint, the resume, the export pair, the CTC probe on it).
Torch only."""

import inspect
import io
import json
import math
import os
import subprocess
import sys

import pytest

from fithubert_tpu_torch.scripts import dress_rehearsal as dr
from fithubert_tpu_torch.train import loop
from fithubert_tpu_torch.utils import logging as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REHEARSAL_TIMEOUT_S = 900  # ~40 s on 8 CPU cores: two 16-step smoke runs and a 60-step probe


def _echo(step, metrics, prefix=""):
    """The [train] line the port's MetricsLogger prints for these metrics."""
    lg = tlog.MetricsLogger.__new__(tlog.MetricsLogger)
    lg._f, lg._t0 = io.StringIO(), 0.0
    real, cap = sys.stderr, io.StringIO()
    try:
        sys.stderr = cap
        lg.log(step, metrics, prefix=prefix)
    finally:
        sys.stderr = real
    return cap.getvalue()


def test_step_regex_matches_the_ports_echo():
    line = _echo(105, {"rand_l0": 0.0358, "l11": 0.3062, "total": 0.7589, "loss": 0.7589,
                       "grad_norm": 0.1912, "lr": 0.0004, "steps_per_sec": 0.2967})
    m = dr.STEP_RE.search(line)
    assert m and m.group(1) == "105" and m.group(2) == "0.7589"


def test_step_regex_skips_other_loss_keys_and_catches_nan():
    """ctc_loss and attn_loss come before loss in the port's echo: the
    regex takes the total, and a nan loss matches (the continuity check
    then fails loudly) rather than dropping the line."""
    m = dr.STEP_RE.search(_echo(10, {"attn_loss": 0.31, "ctc_loss": 0.2, "loss": 0.75}))
    assert m and m.group(2) == "0.7500"
    m = dr.STEP_RE.search(_echo(11, {"ctc_loss": 0.1, "loss": float("nan")}))
    assert m and math.isnan(float(m.group(2)))


def test_step_regex_ignores_eval_lines():
    line = _echo(16, {"total": 0.86, "v_loss": 0.93}, prefix="val/")
    assert line.startswith("[train] step=16 val/")
    assert dr.STEP_RE.search(line) is None


def test_resume_regex_matches_the_loops_line():
    assert "[resume] restored step" in inspect.getsource(loop)
    assert '"[train]"' in inspect.getsource(tlog)
    m = dr.RESUME_RE.search("[resume] restored step 100 (epoch 1)")
    assert m and m.group(1) == "100"


def test_pump_kills_a_silently_hung_child():
    """A child that prints nothing is killed by the watchdog after the
    phase's timeout (2 s), within the 30 s after which it would have ended
    by itself with rc 0 and raised nothing."""
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            bufsize=1)
    with pytest.raises(TimeoutError):
        dr._pump(proc, io.StringIO(), lambda s: None, timeout_s=2.0)
    assert proc.returncode == -9


def test_output_dir_follows_the_set_overrides(tmp_path):
    assert dr._output_dir("configs/smoke.yaml", []) == os.path.join(
        ROOT, "results/pretrain/smoke")
    assert dr._output_dir("configs/smoke.yaml", [f"train.output_dir={tmp_path}/r",
                                                 "train.max_steps=4"]) == f"{tmp_path}/r"


def test_cpu_rehearsal_links_the_whole_chain(tmp_path):
    """Every link but the probe's verdict, which is a learned margin (the
    CTC head against its shuffled control over 8 held-out utterances):
    the probe must run and report, and the harness's exit code must follow
    its verdict."""
    run, out = tmp_path / "run", tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "fithubert_tpu_torch.scripts.dress_rehearsal", "--cpu",
         "--set", f"train.output_dir={run}", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=REHEARSAL_TIMEOUT_S)
    assert proc.stdout.splitlines(), proc.stderr[-3000:]
    summary = json.loads(proc.stdout.splitlines()[-1])
    assert summary == json.loads((out / "dress_rehearsal_cpu.json").read_text())
    assert summary["config"] == "configs/smoke.yaml" and summary["backend"] == "cpu"
    assert summary["preempt_step"] >= 8
    assert summary["checkpointed_step"] >= summary["preempt_step"]
    assert os.listdir(run / "ckpt" / "last")  # the preemption checkpoint
    assert summary["resumed_from"] == summary["checkpointed_step"]
    assert summary["post_resume_step"] > summary["preempt_step"]
    assert summary["loss_continuity_rel"] <= 0.35
    assert summary["final_step"] == 16
    assert (run / "student.yaml").exists() and (run / "student.pt").exists()
    probe = summary["probe"]
    assert probe["n_utts"] == 16 and probe["n_eval"] == 8
    assert all(math.isfinite(probe[k]) for k in ("probe_ctc_loss", "probe_cer",
                                                 "control_ctc_loss", "control_cer"))
    assert summary["probe_tail"].startswith("CTC PROBE ")
    assert summary["ok"] == (summary["probe_rc"] == 0)
    assert proc.returncode == (0 if summary["ok"] else 1), proc.stderr[-3000:]
    log = (out / "dress_rehearsal_cpu.log").read_text()
    assert "[preemption] signal 15 received" in log
    assert f"[resume] restored step {summary['resumed_from']}" in log
