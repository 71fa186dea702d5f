"""AdamW under linear warmup and decay (``fithubert_tpu/train/optim.py``).

``torch.optim.AdamW`` computes what ``optax.adamw`` does: bias-corrected
moments, eps outside the square root, and weight decay decoupled from the
gradient and scaled by the learning rate, on every parameter. The schedule
is optax's ``join_schedules`` of two linear ramps, indexed by the number of
steps already taken: step 0 runs at lr 0. ``optimizer_step`` sets the
schedule's lr for the caller's step count before each update, so that count
is the only step counter.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from fithubert_tpu_torch.config import OptimizerConfig


def linear_warmup_decay(lr: float, num_training_steps: int,
                        warmup_proportion: float) -> Callable[[int], float]:
    """The learning rate of step ``s`` (0-based)."""
    warmup = max(1, int(num_training_steps * warmup_proportion))
    decay = max(1, num_training_steps - warmup)

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * step / warmup
        return lr * (1.0 - min(step - warmup, decay) / decay)

    return schedule


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimizerConfig,
                    num_training_steps: int
                    ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(optimizer, schedule); step it with ``optimizer_step``."""
    if cfg.name not in ("AdamW_with_schedule", "AdamW", "adamw"):
        raise NotImplementedError(f"optimizer '{cfg.name}' is not supported.")
    lr = float(cfg.lr)
    schedule = linear_warmup_decay(lr, num_training_steps, float(cfg.warmup_proportion))
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=tuple(float(b) for b in cfg.betas),
                            eps=float(cfg.eps), weight_decay=float(cfg.weight_decay))
    return opt, schedule


def optimizer_step(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                   step: int) -> float:
    """One update at the lr of 0-based ``step``; returns that lr."""
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return lr
