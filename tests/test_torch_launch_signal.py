"""``parallel/distributed.py launch`` passes SIGTERM and SIGINT on to the
ranks it spawned: a preemption signal sent to the launching process (as the
cloud sends it to ``train_torch.py`` over several cards) reaches every
rank's ``PreemptionGuard``, and the launch returns the ranks' results.
Torch only, on the CPU."""

import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT = """
import sys
sys.path.insert(0, {root!r})
from fithubert_tpu_torch.parallel.distributed import launch
from tests.test_torch_launch_signal import guarded_rank
print("results", launch(guarded_rank, 2, {ready!r}), flush=True)
"""
READY_S = 120  # for both ranks to start, import the loop and install their guards
STOP_S = 60  # for the signal to reach them and the launch to return
WAIT_CAP_S = 300  # a rank that never gets the signal returns after this


def guarded_rank(ready_dir):
    """A rank that installs ``PreemptionGuard``, writes ``<rank>.<pid>`` into
    ready_dir and waits for a signal (at most ``WAIT_CAP_S``)."""
    from fithubert_tpu_torch.train.loop import PreemptionGuard

    guard = PreemptionGuard()
    open(os.path.join(ready_dir, f"{os.environ['RANK']}.{os.getpid()}"), "w").close()
    end = time.monotonic() + WAIT_CAP_S
    while not guard.should_stop and time.monotonic() < end:
        time.sleep(0.05)
    guard.restore()
    return "stopped" if guard.should_stop else "not stopped"


def _rank_pids(ready):
    return [int(name.split(".")[1]) for name in os.listdir(ready)]


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_a_signal_to_the_launching_process_reaches_every_rank(tmp_path, sig):
    ready = tmp_path / "ready"
    ready.mkdir()
    proc = subprocess.Popen([sys.executable, "-c", PARENT.format(root=ROOT, ready=str(ready))],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        end = time.monotonic() + READY_S
        while len(os.listdir(ready)) < 2 and proc.poll() is None and time.monotonic() < end:
            time.sleep(0.1)
        assert len(os.listdir(ready)) == 2, "the ranks did not install their guards"
        proc.send_signal(sig)
        out, _ = proc.communicate(timeout=STOP_S)
        assert proc.returncode == 0, out
        assert "results ['stopped', 'stopped']" in out, out
        assert out.count(f"[preemption] signal {int(sig)} received") == 2, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in _rank_pids(ready):  # no rank outlives the test
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _rank_name():
    return os.environ["RANK"]


def test_launch_restores_the_signal_handlers():
    from fithubert_tpu_torch.parallel.distributed import launch

    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        before_int = signal.getsignal(signal.SIGINT)
        assert launch(_rank_name, 2) == ["0", "1"]
        assert signal.getsignal(signal.SIGTERM) is mine
        assert signal.getsignal(signal.SIGINT) is before_int
    finally:
        signal.signal(signal.SIGTERM, prev)
