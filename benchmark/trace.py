"""Reduction of a profiler trace of the traced stretch to what the
per-layer metrics read: the device's kernel records, the union of its
busy intervals, the idle gaps named by the host operation open during
them, and the kernels of each family (``kernels/<family>.json``), matched
by name. Everything is computed in memory; no trace file is written."""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))

Interval = Tuple[int, int]


@dataclass
class Record:
    name: str
    start: int  # ns
    end: int  # ns
    corr: int = 0  # the profiler's correlation id: a runtime call and what it launched


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle stretches of [lo, hi) between the disjoint sorted ``busy``."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def port_kernel_names(csrc: str) -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    for path in glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return sorted(names)


def name_matches(kernel: str, record: str) -> bool:
    """``record`` (a demangled kernel signature) is a launch of ``kernel``."""
    return re.search(rf"(?<!\w){re.escape(kernel)}(?=\s*[<(])", record) is not None


def load_families() -> Dict[str, Dict]:
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        with open(path) as f:
            out[os.path.splitext(os.path.basename(path))[0]] = json.load(f)
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel or operation name without its parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:width]


@dataclass
class Stretch:
    """The traced stretch: its bounds, the device's records in it and the
    host's operations."""

    lo: int
    hi: int
    kernels: List[Record]
    device: List[Record]  # kernels, copies and sets
    host: List[Record]
    family_of: Dict[str, str] = field(default_factory=dict)  # kernel name -> family

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy(self) -> List[Interval]:
        return union(clip(((r.start, r.end) for r in self.device), self.lo, self.hi))

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def idle_by_size(self, edges_ns: Sequence[int] = (2_000, 10_000, 100_000)) -> List[List]:
        """The stretch's idle gaps by length: [[up to ns, count, seconds], ...],
        the last bucket open-ended (its bound None)."""
        bounds = list(edges_ns) + [None]
        out = [[b, 0, 0.0] for b in bounds]
        for s, e in gaps(self.busy(), self.lo, self.hi):
            i = next(j for j, b in enumerate(bounds) if b is None or e - s < b)
            out[i][1] += 1
            out[i][2] += (e - s) / 1e9
        return out

    def family(self, name: str) -> List[Record]:
        return [r for r in self.kernels if self.family_of.get(r.name) == name]

    def unmapped(self, port_kernels: Sequence[str]) -> List[str]:
        return sorted(n for n in {r.name for r in self.kernels} if n not in self.family_of
                      and any(name_matches(k, n) for k in port_kernels))

    def library(self) -> List[Record]:
        return [r for r in self.kernels if r.name not in self.family_of]

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        by_name: Dict[str, float] = {}
        for r in self.kernels:
            key = short_name(r.name)
            ns = min(r.end, self.hi) - max(r.start, self.lo)
            by_name[key] = by_name.get(key, 0.0) + ns / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.busy(), self.lo, self.hi), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_open((s + e) // 2), (e - s) / 1e9] for s, e in idle]}

    def host_open(self, t: int) -> str:
        """The innermost host operation open at time t."""
        best: Optional[Record] = None
        for r in self.host:
            if r.start <= t < r.end and (best is None or r.start >= best.start):
                best = r
        return short_name(best.name, 64) if best is not None else "(no host operation)"


RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]\w*$")  # cudaGraphLaunch, cuLaunchKernel, ...


def from_profiler(events, families: Dict[str, Dict], span: str = "bench.") -> Stretch:
    """The stretch of a profile's kineto events: from the first host span
    whose name starts with ``span`` to the end of the last, widened to take
    in every device record that a runtime call inside the spans launched.
    The device's times, mapped onto the host's clock, can put the
    stretch's own work milliseconds outside the spans: past the last one,
    which waited for it, or before the first, which launched it."""
    kernels, device, host = [], [], []
    for ev in events:
        rec = Record(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                     ev.correlation_id())
        if ev.device_type().name == "CUDA":
            if ev.is_user_annotation():
                continue
            device.append(rec)
            if not rec.name.startswith(("Memcpy", "Memset")):
                kernels.append(rec)
        else:
            host.append(rec)
    spans = [r for r in host if r.name.startswith(span)]
    if not spans:
        raise RuntimeError("the traced stretch holds none of the harness's spans")
    lo, hi = min(r.start for r in spans), max(r.end for r in spans)
    launched = {r.corr for r in host
                if r.corr and lo <= r.start < hi and RUNTIME_CALL.match(r.name)}
    own = [r for r in device if r.corr in launched]
    lo = min([lo] + [r.start for r in own])
    hi = max([hi] + [r.end for r in own])
    kernels = [r for r in kernels if r.end > lo and r.start < hi]
    device = [r for r in device if r.end > lo and r.start < hi]
    family_of = {}
    for name in {r.name for r in kernels}:
        for fam, spec in families.items():
            if any(name_matches(k, name) for k in spec["kernels"]):
                family_of[name] = fam
                break
    return Stretch(lo, hi, kernels, device, host, family_of)
