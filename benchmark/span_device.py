"""The device work the program's own spans launched in the traced stretch:
for each span of a name, the device records (kernels, copies and sets)
whose runtime call (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) lies
inside it, matched by the profiler's correlation id, as
``trace.from_profiler`` matches the stretch's own work. A span is host time;
what it enqueued runs on the card later, so its device time is read through
the calls it made, not by its bounds.

A program that records no such span gives nothing: ``device_ms`` returns
None and raises nothing."""

from __future__ import annotations

import bisect
from typing import List, Optional

from . import program, trace


def launched(st: trace.Stretch, name: str) -> List[trace.Record]:
    """The device records launched by runtime calls inside the host spans
    named ``name`` that lie in the stretch."""
    spans = trace.union((h.start, h.end) for h in st.host
                        if h.name == name and h.start >= st.lo and h.end <= st.hi)
    if not spans:
        return []
    starts = [s for s, _e in spans]
    corr = set()
    for h in st.host:
        if h.corr and trace.RUNTIME_CALL.match(h.name):
            i = bisect.bisect_right(starts, h.start) - 1
            if i >= 0 and h.start < spans[i][1]:
                corr.add(h.corr)
    return [r for r in st.device if r.corr in corr]


def device_ms(st: trace.Stretch, name: str) -> Optional[float]:
    """Device ms a call of the stretch (its ``bench.call`` spans) in what
    the spans named ``name`` launched, or None where none launched any."""
    recs = launched(st, name)
    calls = program.calls(st)
    if not recs or not calls:
        return None
    return sum(r.end - r.start for r in recs) / 1e6 / calls
