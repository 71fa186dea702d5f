"""The one traffic generator: every mix under ``traffic/`` is parameters
that this module reads.

Lengths: a pool of groups (a train step's rows, a served call's
utterances) takes the lengths at the midpoint quantiles (i + 0.5) / N of
the mix's length mixture, one of each stratum of neighbouring lengths a
group, drawn from ``--seed`` (``pool_groups``). So every seed serves the
same lengths in another order and every group does nearly the same work:
the work of a run does not move with its seed, and the mixture's mean
holds to the last utterance. The waveforms are
Gaussian noise drawn on the card from the seed.

``quantize_length`` is a frozen copy of the port's
``data/librispeech.py quantize_length``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def quantize_length(length: int, quantum: int, max_length: int = 0) -> int:
    """``length`` rounded up to a multiple of ``quantum``, capped at
    ``max_length`` when that is set, and at least one quantum."""
    q = ((length + quantum - 1) // quantum) * quantum if quantum > 1 else length
    if max_length > 0:
        q = min(q, max_length)
    return max(q, quantum if quantum > 1 else length)


def mixture_quantile(mix: Dict, u: np.ndarray) -> np.ndarray:
    """Seconds at the quantiles u of a mixture of uniform parts."""
    parts = sorted(mix["mixture"], key=lambda p: p["low_s"])
    weights = np.array([p["weight"] for p in parts], float)
    weights = weights / weights.sum()
    # the parts may overlap only at their ends: the CDF is piecewise linear
    edges = sorted({p["low_s"] for p in parts} | {p["high_s"] for p in parts})
    cdf = [0.0]
    for lo, hi in zip(edges[:-1], edges[1:]):
        mass = sum(w * max(0.0, min(hi, p["high_s"]) - max(lo, p["low_s"]))
                   / (p["high_s"] - p["low_s"]) for w, p in zip(weights, parts))
        cdf.append(cdf[-1] + mass)
    return np.interp(u, np.array(cdf), np.array(edges, float))


def mixture_mean(mix: Dict) -> float:
    total = sum(p["weight"] for p in mix["mixture"])
    return sum(p["weight"] * (p["low_s"] + p["high_s"]) / 2 for p in mix["mixture"]) / total


def pool_groups(mix: Dict, groups: int, size: int, seed: int) -> List[List[int]]:
    """``groups`` groups (steps or calls) of ``size`` lengths in samples.
    The groups * size midpoint quantiles of the mixture are cut into
    ``size`` strata of neighbouring lengths; each group takes one length
    of each stratum, drawn from ``seed``, in an order drawn from it. So
    every group carries nearly the same audio and the same longest
    utterance, and every seed serves the same lengths."""
    n = groups * size
    seconds = mixture_quantile(mix, (np.arange(n) + 0.5) / n)
    samples = np.round(seconds * mix["sample_rate"]).astype(np.int64).reshape(size, groups)
    rng = np.random.Generator(np.random.PCG64(seed % (1 << 63)))
    picks = np.stack([rng.permutation(groups) for _ in range(size)])  # (size, groups)
    out = []
    for g in range(groups):
        group = [int(samples[s, picks[s, g]]) for s in range(size)]
        out.append([group[i] for i in rng.permutation(size)])
    return out
