"""AdamW under linear warmup and decay (``fithubert_tpu/train/optim.py``).

``torch.optim.AdamW`` computes what ``optax.adamw`` does: bias-corrected
moments, eps outside the square root, and weight decay decoupled from the
gradient and scaled by the learning rate, on every parameter. The schedule
is optax's ``join_schedules`` of two linear ramps, indexed by the number of
steps already taken: step 0 runs at lr 0. ``optimizer_step`` (or
``set_lr``, then ``step``) sets the schedule's lr for the caller's step
count before each update, so that count is the only step counter.

On the card the optimizer is ``AdamW(capturable=True)`` with its lr a 0-d
fp32 tensor on the card (``set_lr`` writes it): its bias corrections and
step counts stay on the device, so the same update runs eagerly and inside
a CUDA graph, where each captured step reads its lr from a staged buffer
(``train/step.py``). On the CPU it keeps a host lr and host step counts,
whose arithmetic is optax's to 2.5e-5 (``tests/test_torch_optim.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, Optional, Tuple, Union

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
                    num_training_steps: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(optimizer, schedule); step it with ``optimizer_step``. On a
    ``device`` of type cuda, capturable with a device lr."""
    if cfg.name not in ("AdamW_with_schedule", "AdamW", "adamw"):
        raise NotImplementedError(f"optimizer '{cfg.name}' is not supported.")
    lr = float(cfg.lr)
    schedule = linear_warmup_decay(lr, num_training_steps, float(cfg.warmup_proportion))
    capturable = device is not None and torch.device(device).type == "cuda"
    lr0 = (torch.tensor(schedule(0), dtype=torch.float32, device=device) if capturable
           else schedule(0))
    opt = torch.optim.AdamW(params, lr=lr0, betas=tuple(float(b) for b in cfg.betas),
                            eps=float(cfg.eps), weight_decay=float(cfg.weight_decay),
                            capturable=capturable)
    return opt, schedule


def lr_tensor(optimizer: torch.optim.Optimizer) -> Optional[torch.Tensor]:
    """The device lr of a capturable optimizer, else None."""
    lr = optimizer.param_groups[0]["lr"]
    return lr if isinstance(lr, torch.Tensor) else None


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The lr of the next update: written into the device lr on the card."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def optimizer_step(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                   step: int) -> float:
    """One update at the lr of 0-based ``step``; returns that lr."""
    lr = schedule(step)
    set_lr(optimizer, lr)
    optimizer.step()
    return lr


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Mapping[str, Any]) -> None:
    """``optimizer.load_state_dict`` that keeps a capturable optimizer so:
    its device lr tensor, ``capturable`` and step counts on the card, from
    a checkpoint written on any device."""
    lr = lr_tensor(optimizer)
    optimizer.load_state_dict(state)
    if lr is None:
        return
    for group in optimizer.param_groups:
        lr.fill_(float(group["lr"]))
        group["lr"], group["capturable"] = lr, True
    for st in optimizer.state.values():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].to(lr.device, torch.float32)
