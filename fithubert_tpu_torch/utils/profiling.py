"""Step timing, a device trace, and the program's own spans, counters and
phase times (``fithubert_tpu/utils/profiling.py``).

    StepTimer   steps/s and audio-s/s from the host clock, with a device
                barrier (``torch.cuda.synchronize``) every ``sync_every``
                steps so the rates count finished work; on the CPU, where
                the work is done when the call returns, no barrier
    trace       ``torch.profiler`` over a window of steps, written as a
                Chrome trace into a directory
    span        a named range of host time: a ``record_function`` range
                while ``torch.profiler`` records, so it lands in the same
                trace as the card's records and on its clock; otherwise one
                shared no-op context
    count       the program's one counter registry (``COUNTS``): kernel
                launches by entry name (``ops/kernels/_build.py``), bytes
                handed from host memory to the card (``h2d_bytes``); a count
                made while the profiler records is also kept with its time
                on the trace's clock (``COUNTED``)
    PhaseTimer  the time of consecutive phases of work on one device, from
                timing events on the card (graph-capturable) or the host
                clock on the CPU
    defer, settle
                a reading of device times (a ``PhaseTimer``'s) taken while
                the profiler records, run once its work is done and kept in
                ``READINGS``

No span name starts with ``bench.``: that prefix is a benchmark harness's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()

COUNTS: Dict[str, int] = {}
# (unix ns, name, n) of each count made while the profiler records: the
# kineto trace's host records are stamped on the same clock
COUNTED: List[Tuple[int, str, int]] = []
READINGS: Dict[str, Any] = {}  # name -> the settled result of a deferred reading
_deferred: Dict[str, Callable[[], Any]] = {}


def span(name: str):
    """A context over a range of host work named ``name``: a
    ``record_function`` range while the profiler records, else the shared
    no-op context (one boolean read, nothing allocated or dispatched)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    COUNTS[name] = COUNTS.get(name, 0) + n
    if _profiler._is_profiler_enabled:
        COUNTED.append((time.time_ns(), name, n))


def defer(name: str, read: Callable[[], Any]) -> None:
    """While the profiler records, keep ``read`` (a reading of the device
    times of work just enqueued, which waits for that work) to run at the
    next ``settle``; a later one of the same name replaces it. Outside the
    profiler nothing is kept."""
    if _profiler._is_profiler_enabled:
        _deferred[name] = read


def settle() -> None:
    """Once the profiler has stopped, run the readings ``defer`` kept and
    keep their results in ``READINGS``. Call it before work that would
    overwrite what they read (a graph replay re-records its events)."""
    if _deferred and not _profiler._is_profiler_enabled:
        for name, read in _deferred.items():
            READINGS[name] = read()
        _deferred.clear()


class PhaseTimer:
    """The time of consecutive phases of work on ``device``. ``mark(phase)``
    ends ``phase`` where the work stands and opens the next; ``mark(None)``
    ends a stretch that is no phase and starts a new group (a step). On the
    card each mark records a timing event in the current stream,
    ``external`` under a CUDA-graph capture so that every replay records
    it; the times are read once the work is done. On the CPU, where work is
    done when its call returns, the host clock."""

    def __init__(self, device, external: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.external = external
        self.marks: List[Tuple[Optional[str], Any]] = []

    def mark(self, phase: Optional[str] = None) -> None:
        if self.cuda:
            at = torch.cuda.Event(enable_timing=True, external=self.external)
            at.record()
        else:
            at = time.perf_counter()
        self.marks.append((phase, at))

    def segments(self) -> List[Tuple[Optional[str], float, float]]:
        """(phase, start ms, end ms) of each stretch between two marks, from
        the first mark; waits for the last mark's work."""
        if len(self.marks) < 2:
            return []
        origin = self.marks[0][1]
        if self.cuda:
            self.marks[-1][1].synchronize()
            at = [0.0] + [origin.elapsed_time(ev) for _p, ev in self.marks[1:]]
        else:
            at = [(t - origin) * 1e3 for _p, t in self.marks]
        return [(p, at[i], at[i + 1]) for i, (p, _ev) in enumerate(self.marks[1:])]

    def phase_ms(self) -> List[Dict[str, float]]:
        """Each group's ms in each phase, its repeats (microbatches) summed."""
        groups: List[Dict[str, float]] = []
        for i, (phase, t0, t1) in enumerate(self.segments()):
            if i == 0 or self.marks[i][0] is None:
                groups.append({})
            if phase is not None:
                groups[-1][phase] = groups[-1].get(phase, 0.0) + t1 - t0
        return groups


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
