"""The comparison that decides ``correct``: the numbers read from the
program against the plain reference, each beside its limit
(``limits/<workload>.json``).

Training (the first steps of the object the window then drives: the
eager warm-up's and those of the graph replays after it):
  loss_gap    the largest |loss - reference loss| / |reference loss| over
              the steps compared;
  grad_gap    the first step's gradient as the optimizer got it, by the
              worst leaf: |norm - reference norm| over the larger of the
              reference's norm of that leaf and of the median leaf;
  change_gap  the parameters' change over the steps compared, by the worst
              leaf as above, leaving out the leaves whose reference
              gradient is nought to rounding (under a thousandth of the
              median leaf's norm: a key's bias under softmax).
Which of these a cell compares, its limits file says.
Serving (a sample of the window's calls):
  feature_gap the largest |row - reference row| / |reference row| over the
              valid frames of every row of the last hidden state and of
              each layer's hidden state;
  mask_diff   the frames whose padding flag differs (limit 0).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, Mapping, Sequence

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["limits"].items()}


def _norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keys: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| / max(its reference norm, the
    median leaf's)."""
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def worst(gaps: Mapping[str, float], n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def train_readings(prog: Dict, ref: Dict, start: Mapping[str, torch.Tensor],
                   leaves: Dict = None) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``loss`` (per step), ``grad0`` and
    ``params`` by leaf; ``start`` the parameters both began from.
    ``leaves``, if given, gets each number's worst leaves."""
    n = len(ref["loss"])
    if len(prog.get("loss", ())) < n or not prog.get("grad0") or not prog.get("params"):
        return dict.fromkeys(("loss_gap", "grad_gap", "change_gap"), float("inf"))
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"][:n], ref["loss"]))
    g_ref, g_prog = _norms(ref["grad0"]), _norms(prog["grad0"])
    keys = sorted(g_ref)
    median_g = statistics.median(g_ref.values())
    moving = [k for k in keys if g_ref[k] >= 1e-3 * median_g]
    d_ref = _norms({k: ref["params"][k].float() - start[k].float() for k in moving})
    d_prog = _norms({k: prog["params"][k].float() - start[k].float() for k in moving})
    grad, change = leaf_gaps(g_prog, g_ref, keys), leaf_gaps(d_prog, d_ref, moving)
    if leaves is not None:
        leaves.update(grad_gap=worst(grad), change_gap=worst(change))
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def serve_readings(prog: Sequence[Dict], ref: Sequence[Dict]) -> Dict[str, float]:
    """Each entry: one call's ``last_hidden_state``, ``hidden_states`` and
    ``padding_mask``."""
    gap, diff = 0.0, 0
    for p, r in zip(prog, ref):
        mask = r["padding_mask"]
        pm = p["padding_mask"].to(mask.device)
        if pm.shape != mask.shape:
            return {"feature_gap": float("inf"), "mask_diff": float(mask.numel())}
        diff += int((pm != mask).sum())
        valid = (~mask)[..., None].float()
        pairs = [(p["last_hidden_state"], r["last_hidden_state"])]
        pairs += list(zip(p["hidden_states"], r["hidden_states"]))
        if len(p["hidden_states"]) != len(r["hidden_states"]):
            return {"feature_gap": float("inf"), "mask_diff": float(diff)}
        for a, b in pairs:
            a = a.to(b.device).float()
            if a.shape != b.shape:
                return {"feature_gap": float("inf"), "mask_diff": float(diff)}
            num = ((a - b) * valid).norm(dim=(1, 2))
            den = (b * valid).norm(dim=(1, 2)).clamp_min(1e-30)
            gap = max(gap, float((num / den).max()))
    return {"feature_gap": gap, "mask_diff": float(diff)}


def judge(readings: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """True when every reading is finite and at most its limit."""
    return all(k in readings and readings[k] == readings[k] and readings[k] <= lim
               for k, lim in limits.items())
