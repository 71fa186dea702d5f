"""The reference's first training steps, in the configuration's reference
module (``load``): a frozen teacher's forward, the student's training
forward with the program's dropout masks
(``dropout.py``), the KD loss, autograd's gradient, and AdamW (decoupled
weight decay, bias-corrected moments, eps outside the root) at the
schedule's rate: linear warm-up over ``warmup_proportion`` of
``num_training_steps``, then linear decay, step s (0-based) at
lr * s / warmup in the warm-up."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import load
from .dropout import Drops, seed_table, step_seed


def schedule(opt: Dict, num_training_steps: int, step: int) -> float:
    lr = float(opt["lr"])
    warmup = max(1, int(num_training_steps * float(opt["warmup_proportion"])))
    decay = max(1, num_training_steps - warmup)
    if step < warmup:
        return lr * step / warmup
    return lr * (1.0 - min(step - warmup, decay) / decay)


def fold(x: torch.Tensor) -> torch.Tensor:
    """(A, B, ...) microbatches -> (A * B, ...): row j * A + i is row j of
    microbatch i, the order the program folds them in."""
    return x.transpose(0, 1).reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def run_steps(cfg: Dict, teacher: Dict[str, torch.Tensor], student: Dict[str, torch.Tensor],
              batches: Sequence[Dict[str, torch.Tensor]], rand_layers: Optional[List[int]],
              train_seed: int, quant: str = "fp32", fault: Optional[str] = None) -> Dict:
    """len(batches) optimizer steps from ``student`` at ``cfg['start_step']``.
    Returns each step's ``loss``, the first step's gradient (``grad0``,
    by parameter) and the parameters after the last step (``params``).
    ``fault`` plants a fault of the program in the reference:
    ``half_batch`` leaves out the second half of each step's rows;
    ``frozen_norms`` leaves the layer norms' weights and biases (about a
    fifth of the leaves) unchanged, as a parameter group dropped from the
    optimizer would."""
    model = load(cfg)
    q = model.QUANT[quant]
    exp = cfg["experiment"]
    d, loss_cfg, opt = exp["distiller"], exp["train"], exp["optimizer"]
    g = cfg["teacher_geometry"]
    t_params = {k: v.float() for k, v in teacher.items()}
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in student.items()}
    beta1, beta2 = (float(b) for b in opt["betas"])
    eps, wd = float(opt["eps"]), float(opt["weight_decay"])
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad0 = [], {}
    for n, batch in enumerate(batches):
        step = int(cfg["start_step"]) + n
        x, mask = fold(batch["x"].float()), fold(batch["padding_mask"].bool())
        if fault == "half_batch":
            x, mask = x[: x.shape[0] // 2], mask[: mask.shape[0] // 2]
        with torch.no_grad():
            t_hiddens, _t_mask = model.teacher_forward(t_params, g, x, mask, q)
        drops = Drops(seed_table(step_seed(train_seed, step)))
        out = model.student_forward(params, d, x, mask, drops, q)
        loss = model.kd_loss(loss_cfg, d, out["projections"], t_hiddens, rand_layers)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        lr = schedule(opt, int(cfg["num_training_steps"]), step)
        with torch.no_grad():
            for (k, p), gr in zip(params.items(), grads):
                gr = torch.zeros_like(p) if gr is None else gr
                if n == 0:
                    grad0[k] = gr.clone()
                if fault == "frozen_norms" and "norm" in k:
                    continue
                p.mul_(1.0 - lr * wd)
                m[k].mul_(beta1).add_(gr, alpha=1.0 - beta1)
                v2[k].mul_(beta2).addcmul_(gr, gr, value=1.0 - beta2)
                bc1, bc2 = 1.0 - beta1 ** (n + 1), 1.0 - beta2 ** (n + 1)
                denom = (v2[k].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
        del out, loss, grads, t_hiddens
    return {"loss": losses, "grad0": grad0,
            "params": {k: p.detach() for k, p in params.items()}}
