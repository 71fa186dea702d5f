"""What the program records of itself in the traced stretch, for the
per-layer metrics of its own spans, counters and phases.

    spans        its host spans (``utils/profiling.py span``): profiler
                 ranges in the stretch's host records, on the trace's clock
    counted      its counters' change over the stretch, from the counts it
                 kept with their times while the profiler recorded
                 (``profiling.COUNTED``)
    step_phases  the device ms of each train step's phases in the stretch's
                 last graph replay (``profiling.READINGS["step.phases"]``)

A program that keeps none of these (one older than its spans) gives
nothing: each function then returns None and raises nothing.
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, Iterable, List, Optional

from . import trace

CALL = "bench.call"  # the harness's span around each call of the stretch


def _profiling():
    try:
        return importlib.import_module("fithubert_tpu_torch.utils.profiling")
    except ImportError:
        return None


def _inside(st: trace.Stretch, name_ok) -> List[trace.Record]:
    return [h for h in st.host if name_ok(h.name) and h.start >= st.lo and h.end <= st.hi]


def calls(st: trace.Stretch) -> int:
    """The calls of the stretch: the harness's spans around them."""
    return len(_inside(st, lambda n: n == CALL))


def span_ms(st: trace.Stretch, names: Iterable[str]) -> Optional[float]:
    """Host ms a call in the program's spans named ``names`` (their union,
    so nested spans count once), or None where the stretch holds none."""
    names = set(names)
    found = _inside(st, lambda n: n in names)
    n_calls = calls(st)
    if not found or not n_calls:
        return None
    ns = sum(e - s for s, e in trace.union((h.start, h.end) for h in found))
    return ns / 1e6 / n_calls


def launch_spans(st: trace.Stretch) -> Optional[float]:
    """Host ms a call inside the kernel wrappers' spans, each named after
    the launch counter of a family of ``kernels/``."""
    names = {c for fam in trace.load_families().values() for c in fam["launch_counters"]}
    return span_ms(st, names)


def counted(st: trace.Stretch, name: str) -> Optional[int]:
    """Counter ``name``'s change over the stretch."""
    prof = _profiling()
    kept = getattr(prof, "COUNTED", None)
    if kept is None:
        return None
    got = [n for t, c, n in kept if c == name and st.lo <= t < st.hi]
    return sum(got) if got else None


def step_phases() -> Optional[List[Dict[str, float]]]:
    """Each step's device ms in each phase of the stretch's last graph
    replay, its microbatches summed."""
    prof = _profiling()
    if prof is None or not hasattr(prof, "settle"):
        return None
    prof.settle()  # where no replay came after the stretch to do it
    segments = prof.READINGS.get("step.phases")
    if not segments:
        return None
    steps: List[Dict[str, float]] = [{}]
    for phase, t0, t1 in segments:
        if phase is None:  # between two steps
            steps.append({})
        else:
            steps[-1][phase] = steps[-1].get(phase, 0.0) + t1 - t0
    return [s for s in steps if s]


def phase_ms(r, phase: str) -> Optional[float]:
    """Device ms a step in ``phase`` over the last replay's steps; prints
    the phase's three largest device ops there (``top_ops``)."""
    steps = step_phases()
    if not steps or any(phase not in s for s in steps):
        return None
    top = top_ops(r.stretch, phase)
    if top:
        print(f"{phase}: largest device ops of the stretch's last replay (ms): "
              + ", ".join(f"{k} {v!r}" for k, v in top), file=sys.stderr)
    return sum(s[phase] for s in steps) / len(steps)


def top_ops(st: trace.Stretch, phase: str, top: int = 3) -> List:
    """The ``top`` device ops by time inside ``phase`` in the stretch's
    last replay: its phase boundaries put on the trace's clock by anchoring
    its first mark at that replay's first kernel. Every call of the stretch
    replays the same graph, so each runs the same number of kernels, and
    the last call's are the stretch's last; the first kernel to start after
    the last ``chain.launch`` span opened can be an earlier replay's, which
    the card may still be running when the host enqueues the last."""
    prof = _profiling()
    segments = prof.READINGS.get("step.phases") if prof is not None else None
    n_calls = len(_inside(st, lambda n: n == "chain.launch"))
    if not segments or not n_calls or len(st.kernels) % n_calls:
        return []
    last = sorted(st.kernels, key=lambda k: k.start)[-(len(st.kernels) // n_calls):]
    anchor = last[0].start
    spans = [(anchor + int(t0 * 1e6), anchor + int(t1 * 1e6))
             for p, t0, t1 in segments if p == phase]
    by_op: Dict[str, float] = {}
    for k in last:
        if any(s <= k.start < e for s, e in spans):
            key = trace.short_name(k.name, 64)
            by_op[key] = by_op.get(key, 0.0) + (k.end - k.start) / 1e6
    return sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
