"""Build the CUDA sources under ``fithubert_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions and compiles
with ``nvcc`` alone into ``build/<name>-<hash>/lib<name>.so`` inside the
package (``build/`` is git-ignored), at first use, keyed on a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags. The library is
loaded with ``ctypes``; ptxas's report of each kernel's registers and
spills (``-Xptxas -v``) is kept beside it (``ptxas_usage``). Nothing here
runs at import time, so the modules import on a machine without ``nvcc``.

Every kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` for each kernel
launch it makes, and nowhere else, so a run can show which kernels it went
through, and holds the wrapper's host work for each launch (its checks,
allocations, tensor maps and the launch) in a span of that name
(``utils/profiling.py span``). The counts live in the program's one counter
registry, ``profiling.COUNTS``; ``LAUNCHES`` shows its launch counts alone.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from collections.abc import Mapping
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from fithubert_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LAUNCHED: Dict[str, None] = {}  # the names count_launch has counted, in order


class _Launches(Mapping):
    """The launch counts of ``profiling.COUNTS``: its entries that
    ``count_launch`` made."""

    def __getitem__(self, name: str) -> int:
        if name not in _LAUNCHED or name not in profiling.COUNTS:
            raise KeyError(name)
        return profiling.COUNTS[name]

    def __iter__(self) -> Iterator[str]:
        return (n for n in _LAUNCHED if n in profiling.COUNTS)

    def __len__(self) -> int:
        return sum(1 for _ in self)


LAUNCHES = _Launches()


def count_launch(name: str) -> None:
    _LAUNCHED[name] = None
    profiling.count(name)


def reset_launches() -> None:
    for name in _LAUNCHED:
        profiling.COUNTS.pop(name, None)


def one_launch(name: str):
    """Decorate a wrapper that makes one launch of ``name``: its host work,
    from its checks to the launch, in a span of that name."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with profiling.span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    return os.path.join(BUILD, f"{name}-{digest[:16]}", f"lib{name}.so")


_Build = Tuple[str, subprocess.Popen, str, str]  # (name, nvcc, tmp .so, final .so)


def _start_build(name: str) -> Optional[_Build]:
    """Start nvcc for ``name`` unless its library is built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return name, proc, tmp, out


def _finish_build(build: Optional[_Build]) -> None:
    if build is None:
        return
    name, proc, tmp, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                           + log.decode(errors="replace"))
    with open(os.path.join(os.path.dirname(out), "nvcc.log"), "wb") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: Iterable[str]) -> None:
    """Compile every named source at once, one nvcc process each."""
    builds = [_start_build(n) for n in names]
    errors = []
    for b in builds:  # wait for every nvcc, even after one has failed
        try:
            _finish_build(b)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def _kernel_name(mangled: str) -> str:
    """The unqualified name of a mangled kernel symbol: the last
    <length><identifier> of its nested name (``_ZN ... E``), or its one
    name (``_Z``), with literal template arguments (``ILb1EE``: ``<1>``)."""
    nested = mangled.startswith("_ZN")
    i, name = (3 if nested else 2), mangled
    while (m := re.compile(r"\d+").match(mangled, i)):
        n = int(m.group())
        name, i = mangled[m.end():m.end() + n], m.end() + n
        if not nested:
            break
    args = re.compile(r"I((?:L[a-z]+\d+E)+)E").match(mangled, i)
    if args:
        name += "<" + ", ".join(re.findall(r"L[a-z]+(\d+)E", args.group(1))) + ">"
    return name


def parse_ptxas(log: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill-store bytes, spill-load bytes) of each entry
    function in an ``nvcc -Xptxas -v`` log, in the log's order."""
    rows, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            cur = [_kernel_name(entry.group(1)), 0, 0, 0]
        elif cur and spill:
            cur[2], cur[3] = int(spill.group(1)), int(spill.group(2))
        elif cur and regs:
            cur[1] = int(regs.group(1))
            rows.append(tuple(cur))
            cur = None
    return rows


def ptxas_usage(name: str) -> List[Tuple[str, int, int, int]]:
    """``parse_ptxas`` of the report kept when ``csrc/<name>.cu`` was built."""
    with open(os.path.join(os.path.dirname(_lib_path(name)), "nvcc.log"),
              errors="replace") as f:
        return parse_ptxas(f.read())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    _finish_build(_start_build(name))
    return ctypes.CDLL(_lib_path(name))


# Codes a launch returns besides cudaError_t (csrc/hopper.cuh): a TMA
# tensor map that cuTensorMapEncodeTiled refused (TMA_ERROR + its CUresult),
# or a CUDA driver without that entry point; a kernel whose setmaxnreg plan
# does not match the register count ptxas gave it (REG_ERROR + the count,
# csrc/flash_attention_bwd.cu).
TMA_ERROR, TMA_MISSING, REG_ERROR = 100000, 200000, 300000


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError() or a
    tensor-map error."""
    if err == TMA_MISSING:
        raise RuntimeError(f"{what}: the CUDA driver has no cuTensorMapEncodeTiled")
    if TMA_ERROR <= err < TMA_MISSING:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed, CUresult {err - TMA_ERROR}")
    if REG_ERROR <= err < REG_ERROR + 256:
        raise RuntimeError(f"{what}: built with {err - REG_ERROR} registers a thread, not the "
                           "count its setmaxnreg plan assumes; not launched")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
