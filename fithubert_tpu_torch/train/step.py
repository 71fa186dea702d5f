"""The KD train step (``fithubert_tpu/train/step.py:44 Distiller``): a
frozen teacher forward, the student's training forward and backward, the KD
loss, and AdamW under the warmup/decay schedule.

    d = Distiller(cfg, teacher_state, student_state, device="cuda")
    logs = d.train_step({"x": (A, B, T_wav), "padding_mask": (A, B, T_wav)},
                        rand_layers)
    logs = d.eval_step({"x": (B, T_wav), "padding_mask": (B, T_wav)}, rand_layers)
    ids, mask = d.predict_step({"x": (B, T_wav), "padding_mask": (B, T_wav)}, vocab)
    d.load_state_dict(d.state_dict())  # what a checkpoint holds

The A accumulation microbatches fold into one batch of A * B rows when the
losses allow it (``fuse_ok``, ``:276-295``); otherwise each microbatch runs
its own forward and backward and the summed gradients are divided by A
(``:344-353``). Every random draw of a step comes from a ``DropoutRNG``
seeded by (train.seed, step, microbatch), so the same seed replays the same
step. With an attention or value-relation loss weight the last layer of
both models returns its attention taps (``need_taps``, ``:86-88``); an
attention-logit loss also keeps the microbatches apart, since its scrub
divides by a count that depends on the data. For a task-specific
(wav2vec_ctc) teacher the student's output is also read as CTC logits
(``:188-215``): against the batch's ``labels`` / ``label_paddings`` ((A,
B, U), folded with the rest), or, without them or with ``use_gt_for_ctc:
false``, against the teacher's greedy predictions collapsed by
``collapse_pseudo_labels``. With ``train.specaug`` the mel student's
features are masked in training (``ops/specaug.py``), from the
``DropoutRNG``'s third stream. A conformer student carries BatchNorm
running statistics that advance microbatch by microbatch
(``_has_batch_stats``, ``:90,276-281``): its microbatches never fold, and
run in order, each moving the buffers that the next one reads, as the JAX
scan carries ``extra_vars`` (``:316-366``).

With ``dp`` (``parallel/distributed.py DataParallel``) the batch is this
rank's stripe of the global batch: every rank starts from rank 0's student,
the losses divide by the global batch's denominators, the gradients are
summed over the ranks in one all-reduce after the microbatches, and the
logs are the global batch's on every rank, so all ranks take the step that
one process takes on the whole batch. Each rank folds its rank into the
dropout seeds, so their keep masks differ; SpecAugment's seed stays free of
the rank, so every rank draws the global batch's masks and applies its own
rows. A conformer student is refused there
(``parallel/distributed.py check_data_parallel``).
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
from fithubert_tpu_torch.ops.specaug import BatchStripe
from fithubert_tpu_torch.parallel.distributed import DataParallel, check_data_parallel
from fithubert_tpu_torch.train.losses import LossOutput, collapse_pseudo_labels, compute_losses
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
                 teacher_geometry: Optional[TeacherGeometry] = None,
                 dp: Optional[DataParallel] = None):
        self.device = resolve_device(device)
        if dp is not None:
            check_data_parallel(cfg, dp.world)
        self.cfg = cfg
        self.dp = dp
        self.need_taps = cfg.loss.attn_loss_weight > 0 or cfg.loss.v_rel_loss_weight > 0
        geom = teacher_geometry or TeacherGeometry.from_teacher_config(cfg.teacher)
        if cfg.train.use_fp16:
            geom = dataclasses.replace(geom, compute_dtype="bfloat16")
        self.teacher = TeacherModel(geom, device=self.device)
        self.teacher.load_state_dict(teacher_state)
        self.teacher.freeze()
        self.student = StudentModel(cfg.distiller,
                                    disable_projections=cfg.train.delete_projections,
                                    device=self.device,
                                    specaug=cfg.specaug if cfg.train.specaug else None)
        self._has_batch_stats = cfg.distiller.layer_type == "conformer"
        self.student.load_state_dict(student_state)
        self.params = list(self.student.parameters())
        if dp is not None:
            with torch.no_grad():
                dp.broadcast_(self.params + list(self.student.buffers()))
        self.optimizer, self.schedule = build_optimizer(
            self.params, cfg.optimizer, num_training_steps)
        self.step = 0

    def _seed(self, micro: int, rank_free: bool = False) -> int:
        seed = (self.cfg.train.seed * 1_000_003 + self.step) * 131_071 + micro
        if self.dp is not None and not rank_free:  # rank 0 keeps one process's seeds
            seed += self.dp.rank * 0x9E3779B97F4A7C15
        return seed % (1 << 63)

    def _rng(self, micro: int) -> DropoutRNG:
        return DropoutRNG(self._seed(micro), self.device,
                          specaug_seed=self._seed(micro, rank_free=True))

    def _stripe(self, a: int, b: int) -> Optional[BatchStripe]:
        """This rank's rows of the global batch of SpecAugment, for a batch
        of ``b`` local rows each holding ``a`` microbatches folded in
        (row j * a + i: local row j of microbatch i, the global batch's row
        (rank + world * j) * a + i)."""
        if self.dp is None or self.student.specaug is None:
            return None
        j = torch.arange(b).repeat_interleave(a)
        rows = (self.dp.rank + self.dp.world * j) * a + torch.arange(a).repeat(b)
        return BatchStripe(rows, a * b * self.dp.world, self.dp.sum)

    def _forward_loss(self, wav, mask, rand_layers, rng: Optional[DropoutRNG],
                      labels=None, label_paddings=None,
                      stripe: Optional[BatchStripe] = None) -> LossOutput:
        cfg = self.cfg
        t_out = self.teacher(wav, mask, need_taps=self.need_taps)
        s_out = self.student.forward_train(wav, mask, rng, need_taps=self.need_taps,
                                           stripe=stripe)
        ctc_logits = None
        if not cfg.distiller.teacher_task_agnostic and cfg.loss.ctc_loss_weight > 0:
            ctc_logits = s_out.x  # the student's output is read as CTC logits
            if not cfg.loss.use_gt_for_ctc:
                labels = label_paddings = None  # the teacher's pseudo-labels
            if labels is None and t_out.ctc_logits is not None:
                pseudo = t_out.ctc_logits.argmax(-1)
                if t_out.padding_mask is not None:
                    pseudo = pseudo.masked_fill(t_out.padding_mask, 0)
                labels, label_paddings = collapse_pseudo_labels(pseudo)
            if labels is None:
                ctc_logits = None  # nothing to supervise against
        return compute_losses(cfg.loss, cfg.distiller, s_out, t_out, rand_layers,
                              None if self.dp is None else self.dp.sum,
                              ctc_logits=ctc_logits, labels=labels,
                              label_paddings=label_paddings)

    def _inputs(self, batch: Batch, rand_layers):
        """(x, mask, rand, labels, label_paddings) on the device; the last
        two None where the batch has no labels."""
        x = torch.as_tensor(batch["x"]).to(self.device, torch.float32)
        mask = torch.as_tensor(batch["padding_mask"]).to(self.device, torch.bool)
        rand = None if rand_layers is None else torch.as_tensor(
            rand_layers, dtype=torch.long).to(self.device)
        labels = pads = None
        if "labels" in batch:
            labels = torch.as_tensor(batch["labels"]).to(self.device, torch.long)
            pads = torch.as_tensor(batch["label_paddings"]).to(self.device, torch.float32)
        return x, mask, rand, labels, pads

    def train_step(self, batch: Batch, rand_layers) -> Dict[str, float]:
        """One optimizer step over A microbatches. Returns the mean of the
        loss logs over microbatches, ``loss``, ``grad_norm`` and ``lr``;
        reading them waits for the device."""
        return self.train_step_async(batch, rand_layers).to_floats()

    def train_step_async(self, batch: Batch, rand_layers) -> "StepLogs":
        """``train_step`` whose logs stay on the device until asked for, so
        a loop that reads them every few steps does not wait for each."""
        cfg = self.cfg
        x, mask, rand, labels, pads = self._inputs(batch, rand_layers)
        if x.dim() != 3:
            raise ValueError("train_step takes x of shape (A, B, T_wav)")
        fuse_ok = (cfg.train.fuse_grad_accum and not self._has_batch_stats
                   and not cfg.loss.masked_reduction and cfg.loss.attn_loss_weight == 0)
        folded = 1
        if fuse_ok and x.shape[0] > 1:
            folded, b = x.shape[:2]
            x, mask, labels, pads = (None if t is None else
                                     t.transpose(0, 1).reshape(1, folded * b, t.shape[2])
                                     for t in (x, mask, labels, pads))
        n_micro = x.shape[0]
        stripe = self._stripe(folded, x.shape[1] // folded)
        self.optimizer.zero_grad(set_to_none=True)
        losses, logs = [], []
        for i in range(n_micro):
            out = self._forward_loss(x[i], mask[i], rand, self._rng(i),
                                     None if labels is None else labels[i],
                                     None if pads is None else pads[i], stripe)
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
        if self.dp is not None:
            self.dp.all_reduce_grads(grads)
        grad_norm = torch.nn.utils.get_total_norm(grads)
        lr = optimizer_step(self.optimizer, self.schedule, self.step)
        self.step += 1
        names = list(logs[0])
        means = torch.stack([torch.stack([lg[k].detach().float() for lg in logs]).mean()
                             for k in names] + [torch.stack(losses).mean()])
        if self.dp is not None:  # each rank's logs are its share of the global batch's
            means = self.dp.sum(means)
        values = torch.cat([means, grad_norm.float()[None]])
        return StepLogs(tuple(names) + ("loss", "grad_norm"), values, lr)

    def state_dict(self) -> Dict[str, Any]:
        """What a resume needs: the student's weights (and a conformer's
        BatchNorm running statistics), AdamW's moments and the step count,
        which seeds dropout (``_seed``) and sets the lr."""
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
        x, mask, rand, labels, pads = self._inputs(batch, rand_layers)
        out = self._forward_loss(x, mask, rand, None, labels, pads)
        logs = dict(out.logs)
        logs["v_loss"] = (out.last_layer_loss if self.cfg.loss.distil_random_layer > 0
                          else out.total)
        names = list(logs)
        values = torch.stack([logs[k].float() for k in names])
        if self.dp is not None:
            values = self.dp.sum(values)
        return dict(zip(names, values.tolist()))

    @torch.no_grad()
    def predict_step(self, batch: Batch, vocab_size: int = 32
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Greedy predictions of a (B, T_wav) batch for WER / CER
        (``fithubert_tpu/train/step.py:372``): the argmax over the first
        ``vocab_size`` channels of the student's deterministic output (the
        dictionary's rows, so the ids decode), and its frame padding mask."""
        x, mask, _, _, _ = self._inputs(batch, None)
        out = self.student(x, mask)
        return out.x[..., :vocab_size].argmax(-1), out.padding_mask
