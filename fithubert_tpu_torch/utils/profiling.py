"""Step timing and a device trace (``fithubert_tpu/utils/profiling.py``).

    StepTimer   steps/s and audio-s/s from the host clock, with a device
                barrier (``torch.cuda.synchronize``) every ``sync_every``
                steps so the rates count finished work; on the CPU, where
                the work is done when the call returns, no barrier
    trace       ``torch.profiler`` over a window of steps, written as a
                Chrome trace into a directory
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the CPU and, where there is one, the card; the trace is
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling steps/s and audio-s/s. The first ``tick`` anchors the clock
    (its step carries the warm-up); each later one counts its steps."""

    def __init__(self, sync_every: int, device: torch.device):
        self.sync_every = max(1, sync_every)
        self.device = torch.device(device)
        self._n = 0
        self._t0: Optional[float] = None
        self._audio = 0.0
        self.steps_per_sec = 0.0
        self.audio_sec_per_sec = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, audio_sec: float = 0.0, steps: int = 1) -> Dict[str, float]:
        """After each launch; ``audio_sec`` is its unpadded audio, ``steps``
        its optimizer steps (K under ``train.steps_per_launch``); the
        barrier comes when a multiple of ``sync_every`` was crossed."""
        now = time.perf_counter()
        if self._t0 is None:
            self._sync()
            self._t0 = time.perf_counter()
        else:
            self._n += steps
            self._audio += audio_sec
            if self._n % self.sync_every < steps:
                self._sync()
                now = time.perf_counter()
            dt = max(now - self._t0, 1e-9)
            self.steps_per_sec = self._n / dt
            self.audio_sec_per_sec = self._audio / dt
        return {"steps_per_sec": self.steps_per_sec,
                "audio_sec_per_sec": self.audio_sec_per_sec}
