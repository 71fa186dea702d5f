"""The KD train step (``fithubert_tpu/train/step.py:44 Distiller``): a
frozen teacher forward, the student's training forward and backward, the KD
loss, and AdamW under the warmup/decay schedule.

    d = Distiller(cfg, teacher_state, student_state, device="cuda")
    logs = d.train_step({"x": (A, B, T_wav), "padding_mask": (A, B, T_wav)},
                        rand_layers)
    logs = d.eval_step({"x": (B, T_wav), "padding_mask": (B, T_wav)}, rand_layers)
    d.load_state_dict(d.state_dict())  # what a checkpoint holds

The A accumulation microbatches fold into one batch of A * B rows when the
losses allow it (``fuse_ok``, ``:276-295``); otherwise each microbatch runs
its own forward and backward and the summed gradients are divided by A
(``:344-353``). Every random draw of a step comes from a ``DropoutRNG``
seeded by (train.seed, step, microbatch), so the same seed replays the same
step. With an attention or value-relation loss weight the last layer of
both models returns its attention taps (``need_taps``, ``:86-88``); an
attention-logit loss also keeps the microbatches apart, since its scrub
divides by a count that depends on the data. CTC, SpecAug and the conformer
are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from fithubert_tpu_torch.config import ExperimentConfig
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.dropout import DropoutRNG
from fithubert_tpu_torch.train.losses import LossOutput, compute_losses
from fithubert_tpu_torch.train.optim import build_optimizer, optimizer_step

Batch = Mapping[str, torch.Tensor]


class StepLogs(NamedTuple):
    """A train step's logs: ``values`` on the device, one per name."""

    names: Tuple[str, ...]
    values: torch.Tensor
    lr: float

    def to_floats(self) -> Dict[str, float]:
        out = dict(zip(self.names, self.values.tolist()))
        out["lr"] = self.lr
        return out


class Distiller:
    def __init__(self, cfg: ExperimentConfig, teacher_state: Mapping[str, torch.Tensor],
                 student_state: Mapping[str, torch.Tensor],
                 device: Union[str, torch.device] = "cuda",
                 num_training_steps: int = 10000,
                 teacher_geometry: Optional[TeacherGeometry] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.need_taps = cfg.loss.attn_loss_weight > 0 or cfg.loss.v_rel_loss_weight > 0
        geom = teacher_geometry or TeacherGeometry.from_teacher_config(cfg.teacher)
        if cfg.train.use_fp16:
            geom = dataclasses.replace(geom, compute_dtype="bfloat16")
        self.teacher = TeacherModel(geom, device=self.device)
        self.teacher.load_state_dict(teacher_state)
        self.teacher.freeze()
        self.student = StudentModel(cfg.distiller,
                                    disable_projections=cfg.train.delete_projections,
                                    device=self.device)
        self.student.load_state_dict(student_state)
        self.params = list(self.student.parameters())
        self.optimizer, self.schedule = build_optimizer(
            self.params, cfg.optimizer, num_training_steps)
        self.step = 0

    def _seed(self, micro: int) -> int:
        return ((self.cfg.train.seed * 1_000_003 + self.step) * 131_071 + micro) % (1 << 63)

    def _forward_loss(self, wav, mask, rand_layers, rng: Optional[DropoutRNG]) -> LossOutput:
        t_out = self.teacher(wav, mask, need_taps=self.need_taps)
        s_out = self.student.forward_train(wav, mask, rng, need_taps=self.need_taps)
        return compute_losses(self.cfg.loss, self.cfg.distiller, s_out, t_out, rand_layers)

    def _inputs(self, batch: Batch, rand_layers):
        x = torch.as_tensor(batch["x"]).to(self.device, torch.float32)
        mask = torch.as_tensor(batch["padding_mask"]).to(self.device, torch.bool)
        rand = None if rand_layers is None else torch.as_tensor(
            rand_layers, dtype=torch.long).to(self.device)
        return x, mask, rand

    def train_step(self, batch: Batch, rand_layers) -> Dict[str, float]:
        """One optimizer step over A microbatches. Returns the mean of the
        loss logs over microbatches, ``loss``, ``grad_norm`` and ``lr``;
        reading them waits for the device."""
        return self.train_step_async(batch, rand_layers).to_floats()

    def train_step_async(self, batch: Batch, rand_layers) -> "StepLogs":
        """``train_step`` whose logs stay on the device until asked for, so
        a loop that reads them every few steps does not wait for each."""
        cfg = self.cfg
        x, mask, rand = self._inputs(batch, rand_layers)
        if x.dim() != 3:
            raise ValueError("train_step takes x of shape (A, B, T_wav)")
        fuse_ok = (cfg.train.fuse_grad_accum and not cfg.loss.masked_reduction
                   and cfg.loss.attn_loss_weight == 0)
        if fuse_ok and x.shape[0] > 1:
            a, b = x.shape[:2]
            x, mask = (t.transpose(0, 1).reshape(1, a * b, t.shape[2]) for t in (x, mask))
        n_micro = x.shape[0]
        self.optimizer.zero_grad(set_to_none=True)
        losses, logs = [], []
        for i in range(n_micro):
            out = self._forward_loss(x[i], mask[i], rand, DropoutRNG(self._seed(i), self.device))
            out.total.backward()
            losses.append(out.total.detach())
            logs.append(out.logs)
        grads = []
        for p in self.params:
            if p.grad is None:  # unused this step: optax still decays it
                p.grad = torch.zeros_like(p)
            elif n_micro > 1:
                p.grad.div_(n_micro)
            grads.append(p.grad)
        grad_norm = torch.nn.utils.get_total_norm(grads)
        lr = optimizer_step(self.optimizer, self.schedule, self.step)
        self.step += 1
        names = list(logs[0])
        values = torch.stack([torch.stack([lg[k].detach().float() for lg in logs]).mean()
                              for k in names] + [torch.stack(losses).mean(), grad_norm.float()])
        return StepLogs(tuple(names) + ("loss", "grad_norm"), values, lr)

    def state_dict(self) -> Dict[str, Any]:
        """What a resume needs: the student's weights, AdamW's moments and
        the step count, which seeds dropout (``_seed``) and sets the lr."""
        return {"student": self.student.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.student.load_state_dict(state["student"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    @torch.no_grad()
    def eval_step(self, batch: Batch, rand_layers) -> Dict[str, float]:
        """Deterministic loss logs of one (B, T_wav) batch, with ``v_loss``:
        the last layer's loss in random-layer mode, else the total."""
        x, mask, rand = self._inputs(batch, rand_layers)
        out = self._forward_loss(x, mask, rand, None)
        logs = dict(out.logs)
        logs["v_loss"] = (out.last_layer_loss if self.cfg.loss.distil_random_layer > 0
                          else out.total)
        names = list(logs)
        return dict(zip(names, torch.stack([logs[k].float() for k in names]).tolist()))
