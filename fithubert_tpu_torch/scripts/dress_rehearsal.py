"""Dress rehearsal of the port's whole chain as a user runs it
(``scripts/dress_rehearsal.py``): train, be preempted, resume, export, probe.

    python -m fithubert_tpu_torch.scripts.dress_rehearsal [--cpu]
        [--config configs/rehearsal.yaml] [--sigterm-after 100]
        [--set section.key=value ...] [--out DIR]
        [--probe-utts N] [--probe-steps N]

  1. ``train_torch.py -c <config>`` (the release geometry over a synthetic
     corpus) in a subprocess; once a ``[train]`` line reports step
     ``--sigterm-after`` or later, SIGTERM (the cloud's preemption signal)
     goes to it, and the run must print ``[preemption] checkpointed step``
     and exit 0. On a machine with several cards ``train_torch.py`` passes
     the signal on to its ranks (``parallel/distributed.py launch``).
  2. The same command again: it must print ``[resume] restored step`` at or
     past the preempted step, and its first loss must lie within
     ``--continuity-tol`` (relative) of the last loss before the signal; a
     fresh start would sit at the cold-start loss. It runs to
     ``train.max_steps`` and writes the export pair, ``student.yaml`` and
     ``student.pt``.
  3. ``python -m fithubert_tpu_torch.scripts.linear_probe --ctc`` on that
     pair, whose CTC head must beat the shuffled control by the probe's
     own rule.

``--cpu`` trains ``configs/smoke.yaml`` on the CPU (unless ``--config`` is
given), sends the signal after step 8 and probes 16 utterances for 60
steps, as the JAX harness's ``--cpu`` does. ``--set`` goes to
``train_torch.py`` (e.g. ``--set train.max_steps=40``): the config file is
not edited. The run's directory is emptied first. The log of every phase
(the ``[train]`` lines come on stderr, merged here into stdout) and the JSON
summary go to ``dress_rehearsal_{cpu,gpu}.{log,json}`` under the run's
``output_dir``, or under ``--out``. A broken link in phases 1-2 raises; the
summary is written after phase 3 with ``ok`` the probe's verdict, printed as
the last line, and the exit code is 0 only when ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# '(?:.* )?loss=': loss must start a key (preceded by a space or the step
# field), so a ctc_loss or attn_loss before it is not taken for the total;
# 'nan|inf' included so a diverged step fails the continuity check loudly
# instead of being dropped from it.
STEP_RE = re.compile(r"\[train\] step=(\d+) (?:.* )?loss=([0-9.]+|nan|inf)")
RESUME_RE = re.compile(r"\[resume\] restored step (\d+)")


def _launch(cmd, log_path):
    log = open(log_path, "a", buffering=1)
    proc = subprocess.Popen(
        cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env={**os.environ, "PYTHONUNBUFFERED": "1"},
    )
    return proc, log


def _pump(proc, log, on_line, timeout_s):
    """Stream the subprocess's output to the log, calling on_line per line.

    A watchdog thread kills the subprocess after ``timeout_s``: a check on
    the reading side alone never fires while the child hangs silently, and
    the kill ends the read with EOF."""
    timed_out = threading.Event()

    def watchdog():
        if not timed_out.wait(timeout=timeout_s):
            proc.kill()

    th = threading.Thread(target=watchdog, daemon=True)
    th.start()
    try:
        for line in proc.stdout:
            log.write(line)
            on_line(line.rstrip("\n"))
        rc = proc.wait()
    finally:
        timed_out.set()
        log.close()
    if rc != 0 and proc.returncode in (-9,):  # killed by the watchdog
        raise TimeoutError(f"phase exceeded {timeout_s}s")
    return rc


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dress rehearsal: {msg}")


def _output_dir(cfg_path: str, sets) -> str:
    """``train.output_dir`` of the config under the ``--set`` overrides."""
    import yaml

    from fithubert_tpu_torch.config import read_yaml

    out = (read_yaml(os.path.join(HERE, cfg_path)).get("train") or {}).get("output_dir")
    for item in sets:
        name, _, value = item.partition("=")
        if name == "train.output_dir":
            out = yaml.safe_load(value)
    _require(bool(out), f"{cfg_path} names no train.output_dir")
    return os.path.join(HERE, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/rehearsal.yaml")
    ap.add_argument("--cpu", action="store_true",
                    help="train and probe on the CPU (configs/smoke.yaml unless --config is "
                         "given)")
    ap.add_argument("--sigterm-after", type=int, default=100,
                    help="optimizer steps before the preemption SIGTERM")
    ap.add_argument("--continuity-tol", type=float, default=0.35,
                    help="max |post-resume loss / pre-SIGTERM loss - 1| (dropout and data "
                         "differ across the boundary; a fresh start would be several x off)")
    ap.add_argument("--phase-timeout", type=float, default=2400.0)
    ap.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                    help="passed on to train_torch.py")
    ap.add_argument("--out", default=None,
                    help="directory of the log and the summary (default: the run's)")
    ap.add_argument("--probe-utts", type=int, default=None,
                    help="the CTC probe's --n-utts (default: the probe's; 16 under --cpu)")
    ap.add_argument("--probe-steps", type=int, default=None,
                    help="the CTC probe's --steps (default: the probe's; 60 under --cpu)")
    args = ap.parse_args(argv)

    cfg = args.config
    if args.cpu and cfg == ap.get_default("config"):
        # a release-geometry run is too slow for the CPU
        cfg = "configs/smoke.yaml"
        if args.sigterm_after == ap.get_default("sigterm_after"):
            args.sigterm_after = 8  # smoke trains 16 steps
    if args.cpu:
        args.probe_utts = 16 if args.probe_utts is None else args.probe_utts
        args.probe_steps = 60 if args.probe_steps is None else args.probe_steps
    device = ["--device", "cpu"] if args.cpu else []
    train_cmd = [sys.executable, "train_torch.py", "-c", cfg, *device]
    for item in args.set:
        train_cmd += ["--set", item]

    out_dir = _output_dir(cfg, args.set)
    shutil.rmtree(out_dir, ignore_errors=True)  # a fresh run
    report_dir = args.out or out_dir
    os.makedirs(report_dir, exist_ok=True)
    tag = "cpu" if args.cpu else "gpu"
    log_path = os.path.join(report_dir, f"dress_rehearsal_{tag}.log")
    open(log_path, "w").close()
    summary = {"metric": "dress_rehearsal", "config": cfg, "backend": tag, "set": args.set}

    # ---- phase 1: train until SIGTERM ------------------------------------
    state = {"steps": [], "sent": False, "resumed_from": None}
    t0 = time.perf_counter()
    proc, log = _launch(train_cmd + ["--no-resume"], log_path)

    def phase1(line):
        m = STEP_RE.search(line)
        if m and "val/" not in line:
            state["steps"].append((int(m.group(1)), float(m.group(2))))
            if not state["sent"] and int(m.group(1)) >= args.sigterm_after:
                print(f"[rehearsal] SIGTERM at step {m.group(1)}", flush=True)
                proc.send_signal(signal.SIGTERM)
                state["sent"] = True

    rc = _pump(proc, log, phase1, args.phase_timeout)
    summary["phase1_s"] = round(time.perf_counter() - t0, 1)
    _require(state["sent"], "the run finished before the SIGTERM step was reached")
    _require(rc == 0, f"the preempted run exited rc={rc}")
    pre_step, pre_loss = state["steps"][-1]
    summary["preempt_step"] = pre_step
    summary["preempt_loss"] = pre_loss
    with open(log_path) as f:
        m = re.search(r"\[preemption\] checkpointed step (\d+)", f.read())
    _require(m is not None, "no preemption checkpoint recorded")
    summary["checkpointed_step"] = int(m.group(1))

    # ---- phase 2: resume to completion ------------------------------------
    state["steps"] = []
    t0 = time.perf_counter()
    proc, log = _launch(train_cmd, log_path)

    def phase2(line):
        m = RESUME_RE.search(line)
        if m:
            state["resumed_from"] = int(m.group(1))
        m = STEP_RE.search(line)
        if m and "val/" not in line:
            state["steps"].append((int(m.group(1)), float(m.group(2))))

    rc = _pump(proc, log, phase2, args.phase_timeout)
    summary["phase2_s"] = round(time.perf_counter() - t0, 1)
    _require(rc == 0, f"the resumed run exited rc={rc}")
    _require(state["resumed_from"] is not None, "no [resume] line printed")
    _require(state["resumed_from"] >= pre_step,
             f"resumed from step {state['resumed_from']}, before the preempted {pre_step}")
    _require(bool(state["steps"]), "no post-resume training steps")
    first_step, first_loss = state["steps"][0]
    _require(first_step > pre_step, f"first resumed step {first_step} <= {pre_step}")
    drift = abs(first_loss / pre_loss - 1.0)
    summary["resumed_from"] = state["resumed_from"]
    summary["post_resume_step"] = first_step
    summary["post_resume_loss"] = first_loss
    summary["loss_continuity_rel"] = round(drift, 4)
    _require(drift <= args.continuity_tol,
             f"loss discontinuity across resume: {pre_loss} -> {first_loss} "
             f"({drift:.2%} > {args.continuity_tol:.0%})")
    summary["final_step"] = state["steps"][-1][0]
    summary["final_loss"] = state["steps"][-1][1]

    # ---- phase 3: CTC probe on the export ---------------------------------
    yaml_path = os.path.join(out_dir, "student.yaml")
    ckpt_path = os.path.join(out_dir, "student.pt")
    _require(os.path.exists(yaml_path) and os.path.exists(ckpt_path),
             f"export pair missing under {out_dir}")
    probe_cmd = [sys.executable, "-m", "fithubert_tpu_torch.scripts.linear_probe",
                 "--ckpt", ckpt_path, "--config", yaml_path, "--ctc", *device]
    if args.probe_utts is not None:
        probe_cmd += ["--n-utts", str(args.probe_utts)]
    if args.probe_steps is not None:
        probe_cmd += ["--steps", str(args.probe_steps)]
    t0 = time.perf_counter()
    probe = subprocess.run(probe_cmd, cwd=HERE, capture_output=True, text=True,
                           timeout=args.phase_timeout)
    summary["probe_s"] = round(time.perf_counter() - t0, 1)
    with open(log_path, "a") as f:
        f.write(probe.stdout + probe.stderr)
    lines = probe.stdout.strip().splitlines()
    _require(len(lines) >= 2 and lines[-1].startswith("CTC PROBE "),
             f"the probe printed no verdict (rc {probe.returncode}): {probe.stderr[-2000:]}")
    summary["probe"] = json.loads(lines[-2])
    summary["probe_tail"] = lines[-1]
    summary["probe_rc"] = probe.returncode
    summary["ok"] = probe.returncode == 0

    with open(os.path.join(report_dir, f"dress_rehearsal_{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
