"""The log-mel front-end (``fithubert_tpu/ops/mel.py``): torchaudio's
``MelSpectrogram(sample_rate=16000, n_fft=400, hop_length=320,
center=False, power=2.0, window=hann, mel_scale='htk', norm=None)`` as the
reference configures it, then ``log(mel + 1e-15)``.

  mel_filterbank   the (n_fft // 2 + 1, n_mels) triangular HTK filterbank,
                   in numpy (a copy of the JAX package's)
  mel_spectrogram  (B, T) -> (B, T', n_mels), T' = 1 + (T - 400) // 320

The frames are strided windows of the waveform times a periodic Hann
window; the power spectrum is ``torch.fft.rfft`` (an XLA op there, no
Pallas kernel) and the filterbank a plain fp32 matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int = 400, sample_rate: int = 16000,
                   f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """(n_freqs, n_mels) float32 triangular HTK filterbank, norm=None
    (torchaudio's default). Cached: do not write to the result."""
    f_max = f_max or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(np.array(f_min)), _hz_to_mel_htk(np.array(f_max)),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@lru_cache(maxsize=8)
def _hann(n_fft: int) -> np.ndarray:
    """The periodic Hann window (torch.hann_window's default), in float64."""
    return 0.5 * (1.0 - np.cos(2.0 * math.pi * np.arange(n_fft) / n_fft))


def mel_spectrogram(wav: torch.Tensor, n_mels: int, n_fft: int = 400, hop_length: int = 320,
                    sample_rate: int = 16000, log: bool = False) -> torch.Tensor:
    """wav (B, T) -> power mel features (B, T', n_mels) in fp32, log'd with
    eps 1e-15 when ``log``; T' = 1 + (T - n_fft) // hop_length (center=False:
    no frame reads past the waveform)."""
    frames = wav.unfold(1, n_fft, hop_length)  # (B, T', n_fft)
    frames = frames * torch.from_numpy(_hann(n_fft)).to(wav.device, wav.dtype)
    power = torch.fft.rfft(frames.float(), n=n_fft, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(wav.device)
    mel = torch.matmul(power, fb)
    if log:
        mel = torch.log(mel + 1e-15)
    return mel
