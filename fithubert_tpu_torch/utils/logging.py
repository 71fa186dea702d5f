"""Metrics logging (``fithubert_tpu/utils/logging.py``): one JSON record
per call appended to ``<output_dir>/metrics.jsonl``, and a ``[train]`` line
on stderr. A logger made with ``enabled=False`` (a data-parallel rank but
0) writes and prints nothing."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl", enabled: bool = True):
        self.path = os.path.join(output_dir, filename)
        self._f = None
        if enabled:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict, prefix: str = "") -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                # arrays become lists, anything else that JSON cannot take a string
                if hasattr(v, "tolist"):
                    rec[prefix + k] = v.tolist()
                elif isinstance(v, (str, int, bool, list, dict, type(None))):
                    rec[prefix + k] = v
                else:
                    rec[prefix + k] = str(v)
        self._f.write(json.dumps(rec) + "\n")
        parts = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in rec.items() if k != "time"]
        print("[train]", " ".join(parts), file=sys.stderr)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
