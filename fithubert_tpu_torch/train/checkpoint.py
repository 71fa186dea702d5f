"""Checkpoints and the export pair (``fithubert_tpu/train/checkpoint.py``),
with ``torch.save`` in place of Orbax.

    <directory>/best/step_<N>.pt   the top-k saves by v_loss (lowest kept)
    <directory>/best/index.json    {step: v_loss} of the files in best/
    <directory>/last/step_<N>.pt   the newest save

A save writes a temporary file beside its target and renames it over the
target, so a reader, or a run that is killed, finds a whole file or none.
``save_last`` (the preemption snapshot, which has no v_loss) never enters
``best/``. Under data parallelism (``dp``) every rank calls the saves at
the same step, rank 0 alone writes, and the others wait for it at a
barrier; every rank reads. ``export_student`` writes the pair that
``UpstreamExpert`` serves:
``<tag>.yaml`` and ``<tag>.pt``, the student's state dict.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from fithubert_tpu_torch.config import ExperimentConfig, dump_config
from fithubert_tpu_torch.parallel.distributed import DataParallel

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def _atomic(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 3,
                 dp: Optional[DataParallel] = None):
        self.dp = dp
        self.writer = dp is None or dp.rank == 0
        self.best = os.path.join(os.path.abspath(directory), "best")
        self.last = os.path.join(os.path.abspath(directory), "last")
        self.save_top_k = max(1, save_top_k)
        os.makedirs(self.best, exist_ok=True)
        os.makedirs(self.last, exist_ok=True)

    @staticmethod
    def _steps(directory: str) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)

    @staticmethod
    def _file(directory: str, step: int) -> str:
        return os.path.join(directory, f"step_{step}.pt")

    def _write(self, directory: str, step: int, state: Mapping[str, Any]) -> None:
        cpu = _to_cpu(dict(state))
        _atomic(self._file(directory, step), lambda tmp: torch.save(cpu, tmp))

    def best_metrics(self) -> Dict[int, float]:
        """{step: v_loss} of the checkpoints in ``best/``."""
        path = os.path.join(self.best, "index.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): float(v) for k, v in json.load(f).items()}

    def _done(self) -> None:
        if self.dp is not None:
            self.dp.barrier()  # rank 0's files are whole before anyone goes on

    def save(self, step: int, state: Mapping[str, Any], v_loss: float) -> None:
        """Keep ``state`` in ``best/`` if its v_loss is among the k lowest,
        and as ``last/``."""
        if self.writer:
            self._save(step, state, v_loss)
        self._done()

    def _save(self, step: int, state: Mapping[str, Any], v_loss: float) -> None:
        metrics = {**self.best_metrics(), int(step): float(v_loss)}
        keep = dict(sorted(metrics.items(), key=lambda kv: (kv[1], kv[0]))[: self.save_top_k])
        if step in keep:
            self._write(self.best, step, state)
        def write_index(tmp):
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in keep.items()}, f)

        _atomic(os.path.join(self.best, "index.json"), write_index)
        for s in self._steps(self.best):
            if s not in keep:
                os.unlink(self._file(self.best, s))
        self._save_last(step, state)

    def save_last(self, step: int, state: Mapping[str, Any]) -> None:
        """The newest snapshot alone, in ``last/``."""
        if self.writer:
            self._save_last(step, state)
        self._done()

    def _save_last(self, step: int, state: Mapping[str, Any]) -> None:
        self._write(self.last, step, state)
        for s in self._steps(self.last):
            if s != step:
                os.unlink(self._file(self.last, s))

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self.last)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (the newest when None), from
        ``last/`` or ``best/``, on the CPU; None when there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        for directory in (self.last, self.best):
            path = self._file(directory, step)
            if os.path.exists(path):
                return torch.load(path, map_location="cpu", weights_only=True)
        return None


def export_student(cfg: ExperimentConfig, student_state: Mapping[str, torch.Tensor],
                   out_dir: str, tag: str = "student") -> Tuple[str, str]:
    """Write ``<tag>.yaml`` (the experiment's config) and ``<tag>.pt`` (the
    student's state dict, every head included); returns both paths."""
    os.makedirs(out_dir, exist_ok=True)
    yaml_path = os.path.join(out_dir, f"{tag}.yaml")
    pt_path = os.path.join(out_dir, f"{tag}.pt")
    dump_config(cfg, yaml_path)
    cpu = _to_cpu(dict(student_state))
    _atomic(pt_path, lambda tmp: torch.save(cpu, tmp))
    return yaml_path, pt_path
