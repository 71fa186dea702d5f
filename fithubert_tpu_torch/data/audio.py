"""FLAC / WAV decoding through the repo's own native decoder
(``native/audioio.cc``, the decoder of ``fithubert_tpu/data/audio.py``).

The source is compiled with ``g++`` at first use into the package's
git-ignored ``build/`` directory, keyed on a hash of the source and the
flags, under a file lock so that concurrent processes build it once; it is
loaded with ``ctypes``. ``native/`` is only read. A failed build, and a file
that does not decode, raise: nothing falls back to another decoder and no
utterance turns into silence.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "audioio.cc")
BUILD = os.path.join(_ROOT, "fithubert_tpu_torch", "build")
# native/Makefile's flags less -march=native: a checkout copied to another
# host with its build directory must not load code for this host's CPU
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")

_LOAD_LOCK = threading.Lock()


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD, f"audioio-{digest.hexdigest()[:16]}", "libaudioio.so")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # another process built it meanwhile
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        try:
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise RuntimeError(f"building the audio decoder from {SOURCE} failed: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building the audio decoder from {SOURCE} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def _load_locked() -> ctypes.CDLL:
    out = _lib_path()
    if not os.path.exists(out):
        _build(out)
    lib = ctypes.CDLL(out)
    lib.audioio_decode.restype = ctypes.c_longlong
    lib.audioio_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    lib.audioio_load_batch.restype = ctypes.c_int
    lib.audioio_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    return lib


def load() -> ctypes.CDLL:
    """The decoder library, built on first use."""
    with _LOAD_LOCK:  # the data pipeline decodes on a thread pool
        return _load_locked()


def _check_format(path: str) -> None:
    if not path.lower().endswith((".flac", ".wav")):
        raise ValueError(f"{path}: the native decoder reads .flac and .wav only")


def decode(path: str) -> np.ndarray:
    """One file -> mono float32 in [-1, 1]."""
    _check_format(path)
    lib = load()
    sr = ctypes.c_int(0)
    n = lib.audioio_decode(path.encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        raise RuntimeError(f"{path}: the native decoder could not read it")
    buf = np.empty(int(n), np.float32)
    got = lib.audioio_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             int(n), ctypes.byref(sr))
    if got != n:
        raise RuntimeError(f"{path}: decoded {got} samples of {n}")
    return buf


def decode_batch(paths: Sequence[str], t_pad: int,
                 n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode files on the decoder's own threads into a zero-padded
    (B, t_pad) float32 array, with each file's length clipped to t_pad
    (B = 0 gives an empty batch: a fabricated microbatch)."""
    n = len(paths)
    out = np.zeros((n, t_pad), np.float32)
    lengths = np.zeros(n, np.int64)
    if n == 0:
        return out, lengths
    for p in paths:
        _check_format(p)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = load().audioio_load_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   t_pad, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                                   n_threads)
    bad = [p for p, m in zip(paths, lengths) if m <= 0]
    if rc != 0 or bad:
        raise RuntimeError(f"the native decoder could not read {bad or paths}")
    return out, lengths
