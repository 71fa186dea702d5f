"""Build the CUDA sources under ``fithubert_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions and compiles
with ``nvcc`` alone into ``build/<name>-<hash>/lib<name>.so`` inside the
package (``build/`` is git-ignored), at first use, keyed on a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags. The library is
loaded with ``ctypes``. Nothing here runs at import time, so the modules
import on a machine without ``nvcc``.

Every kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` for each kernel
launch it makes, and nowhere else, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


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


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    _finish_build(_start_build(name))
    return ctypes.CDLL(_lib_path(name))


# Codes a launch returns besides cudaError_t (csrc/conv_gemm.cuh): a TMA
# tensor map that cuTensorMapEncodeTiled refused (TMA_ERROR + its CUresult),
# or a CUDA driver without that entry point.
TMA_ERROR, TMA_MISSING = 100000, 200000


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError() or a
    tensor-map error."""
    if err == TMA_MISSING:
        raise RuntimeError(f"{what}: the CUDA driver has no cuTensorMapEncodeTiled")
    if TMA_ERROR <= err < TMA_MISSING:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed, CUresult {err - TMA_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
