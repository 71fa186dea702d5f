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
rows. A conformer student's BatchNorm then takes the global batch's
statistics (``ops/conformer.py RowMaskedBatchNorm``), summed over the ranks
inside autograd (``DataParallel.sum_with_grad``).

With ``mesh`` (``parallel/mesh.py make_mesh``: a ('data', 'model') grid
of the ranks) the data axis works as ``dp`` does over this rank's column
(``Mesh.dp``: the batch is the column's stripe, every sum and the seeds'
rank are the data axis's), and the model axis shards both models by
``TP_RULES`` (JAX's ``shard_state`` / ``shard_teacher``,
``fithubert_tpu/train/step.py:116-127, 165-169``): the teacher after its
cast and int8 payloads (``TeacherModel.freeze``), the student after
``load_state_dict`` and a broadcast of rank 0's weights to every rank. The
ranks of a row compute the same loss and the same replicated parameters;
``grad_norm`` is the logical parameters' (the sharded ones' squares summed
over the row), as optax's ``global_norm``. ``state_dict`` gathers the
student and AdamW's moments into one process's keys and shapes, and
``load_state_dict`` cuts one process's state to this rank's shards, so
checkpoints, resume and export keep one format. ``dp=`` alone is the mesh
of model axis 1. Over gloo the chain is refused as for ``dp``; with a
model axis above 1 it runs only over NCCL, which one card cannot show.

``train_step_chain(batches, rand_layers)`` takes K optimizer steps in one
launch, the counterpart of the JAX package's ``make_train_step_chain``
(``fithubert_tpu/train/step.py:242-262``, a ``lax.scan`` over K steps). On
the card the K steps (teacher forward, student forward and backward, the
gradient all-reduce under NCCL, AdamW) are captured once per shape of the
K batches into one ``torch.cuda.CUDAGraph`` (``_Chain``), after the first K
steps of that shape have run eagerly on a side stream as its warm-up; the
graphs share one memory pool. A replay copies the K batches into the
graph's static inputs, the K learning rates into its lr buffer, and the
host draws of each step and microbatch (its seed table, SpecAugment's
draws: ``ops/dropout.py``), made by the same generators from the same
seeds as an eager step, into the static tensors the capture read. Those
tensors are allocated before the capture, at the shapes the warm-up drew
(``_Staged``): made inside it, a later step's would share memory with an
earlier step's temporaries, which the replay overwrites before the later
step reads them. So the graph computes what K eager steps compute. A capture that fails raises; a
gloo process group on the card raises ValueError (``check_graphable``):
host collectives cannot be captured. On the CPU the chain is K single
steps. Launch counts (``_build.LAUNCHES``) count kernels where Python
launches them, so a replay adds none: a captured chain counted its
launches once, when it was captured.

Every step marks the device time of its phases (``PHASES``: teacher
forward, student forward and losses, backward, gradients and AdamW) with a
``utils/profiling.py PhaseTimer``; a captured chain's marks are event-record
nodes of its graph, so each replay times them. ``Distiller.phase_ms()``
reads the last eager step's, ``_Chain.phase_ms()`` a chain's last replay's.
A replay's host staging is in the spans ``chain.batches``, ``chain.lrs``,
``chain.draws`` and ``chain.launch``; a replay made while ``torch.profiler``
records leaves its phases to ``profiling.READINGS["step.phases"]``.

``distiller.quantize_matmuls`` raises ValueError, as the JAX Distiller does
(``fithubert_tpu/train/step.py:60-67``): training through int8 matmuls
would stop learning. ``teacher.quantize_int8`` makes the frozen teacher's
matmuls int8 (``TeacherModel.freeze``); it is read from the config even
where a checkpoint's geometry is given, which the JAX loop's checkpoint
geometry drops (``fithubert_tpu/train/loop.py:158-162``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fithubert_tpu_torch.config import ExperimentConfig
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.ops.dropout import DropoutRNG, host_streams, to_device
from fithubert_tpu_torch.ops.specaug import BatchStripe
from fithubert_tpu_torch.ops.conformer import RowMaskedBatchNorm
from fithubert_tpu_torch.parallel.distributed import DataParallel
from fithubert_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state,
    global_norm,
    local_state,
    shard_,
)
from fithubert_tpu_torch.train.losses import LossOutput, collapse_pseudo_labels, compute_losses
from fithubert_tpu_torch.train.optim import (
    build_optimizer,
    load_optimizer_state,
    lr_tensor,
    set_lr,
)
from fithubert_tpu_torch.utils import profiling
from fithubert_tpu_torch.utils.profiling import PhaseTimer, span

Batch = Mapping[str, torch.Tensor]
PHASES = ("step.teacher", "step.student", "step.backward", "step.optim")


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
                 dp: Optional[DataParallel] = None, mesh: Optional[Mesh] = None):
        if cfg.distiller.quantize_matmuls:
            raise ValueError(
                "distiller.quantize_matmuls is inference/serving-only: round() has zero "
                "gradient almost everywhere, so training through int8 matmuls silently stops "
                "learning. To quantize the FROZEN teacher (exact student gradients) set "
                "teacher.quantize_int8 instead.")
        if dp is not None:  # the mesh of model axis 1 over dp's ranks
            if mesh is not None:
                raise ValueError("give the Distiller a mesh or dp, not both")
            mesh = Mesh(rank=dp.rank, data=dp.world, model=1, dp=dp, tp=None, world=dp)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.dp = None if mesh is None else mesh.dp
        self.tp = None if mesh is None else mesh.tp
        # the step runs collectives: some axis of the mesh has a process group
        self._grouped = mesh is not None and (mesh.dp is not None or mesh.world.world > 1)
        self.need_taps = cfg.loss.attn_loss_weight > 0 or cfg.loss.v_rel_loss_weight > 0
        geom = teacher_geometry or TeacherGeometry.from_teacher_config(cfg.teacher)
        if cfg.train.use_fp16:
            geom = dataclasses.replace(geom, compute_dtype="bfloat16")
        if cfg.teacher.quantize_int8:
            geom = dataclasses.replace(geom, quantize_int8=True)
        self.teacher = TeacherModel(geom, device=self.device)
        self.teacher.load_state_dict(teacher_state)
        self.teacher.freeze(self.tp)
        self.student = StudentModel(cfg.distiller,
                                    disable_projections=cfg.train.delete_projections,
                                    device=self.device,
                                    specaug=cfg.specaug if cfg.train.specaug else None)
        self._has_batch_stats = cfg.distiller.layer_type == "conformer"
        self.student.load_state_dict(student_state)
        if self._grouped:
            with torch.no_grad():
                mesh.world.broadcast_(list(self.student.parameters())
                                      + list(self.student.buffers()))
        if self.dp is not None:
            for mod in self.student.modules():
                if isinstance(mod, RowMaskedBatchNorm):
                    mod.sum_over_ranks = self.dp.sum_with_grad
        self._shards = shard_(self.student, self.tp)  # {state key: sharded dim}
        names = [n for n, _ in self.student.named_parameters()]
        self._param_dims = [self._shards.get(n) for n in names]
        self.params = list(self.student.parameters())
        self.optimizer, self.schedule = build_optimizer(
            self.params, cfg.optimizer, num_training_steps, device=self.device)
        self.step = 0
        self._chains: Dict[Any, _Chain] = {}  # captured K-step graphs, by shape
        self._pool = None  # their shared memory pool
        self._timer: Optional[PhaseTimer] = None  # the one the next _step marks
        self._eager_timer: Optional[PhaseTimer] = None  # the last eager step's

    def _seed(self, micro: int, rank_free: bool = False, step: Optional[int] = None) -> int:
        step = self.step if step is None else step
        seed = (self.cfg.train.seed * 1_000_003 + step) * 131_071 + micro
        if self.dp is not None and not rank_free:  # rank 0 keeps one process's seeds
            seed += self.dp.rank * 0x9E3779B97F4A7C15
        return seed % (1 << 63)

    def _rng(self, micro: int, step: Optional[int] = None, stage=None) -> DropoutRNG:
        return DropoutRNG(self._seed(micro, step=step), self.device,
                          specaug_seed=self._seed(micro, rank_free=True, step=step), stage=stage,
                          model_rank=0 if self.tp is None else self.tp.rank)

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
                      stripe: Optional[BatchStripe] = None,
                      timer: Optional[PhaseTimer] = None) -> LossOutput:
        cfg = self.cfg
        t_out = self.teacher(wav, mask, need_taps=self.need_taps)
        if timer is not None:
            timer.mark("step.teacher")
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
        return self._eager_step(self._inputs(batch, rand_layers), self._rng)

    def _eager_step(self, inputs, make_rng: Callable[[int], DropoutRNG]) -> "StepLogs":
        lr = self.schedule(self.step)
        set_lr(self.optimizer, lr)
        self._timer = self._eager_timer = PhaseTimer(self.device)
        names, values = self._step(inputs, make_rng)
        self.step += 1
        return StepLogs(names, values, lr)

    def phase_ms(self) -> List[Dict[str, float]]:
        """The last eager step's ms in each of ``PHASES`` (``_step``), as
        a one-step list; waits for the step."""
        return [] if self._eager_timer is None else self._eager_timer.phase_ms()

    def _step(self, inputs, make_rng: Callable[[int], DropoutRNG]
              ) -> Tuple[Tuple[str, ...], torch.Tensor]:
        """The device work of one step at the optimizer's current lr: the
        microbatches' forwards and backwards, the gradient sums, AdamW.
        ``make_rng(i)`` gives microbatch i's draws. Returns the log names
        and their values on the device; nothing here waits for the card or
        copies from the host, so a CUDA graph can capture it. ``_timer``,
        set by the caller, marks the step's start and the end of each of
        ``PHASES``: each microbatch's teacher forward, its student forward
        with the losses, its backward, then the gradients' fill, division,
        all-reduce and norm, AdamW and the logs (``step.optim``)."""
        cfg = self.cfg
        x, mask, rand, labels, pads = inputs
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
        timer = self._timer
        self.optimizer.zero_grad(set_to_none=True)
        timer.mark()
        losses, logs = [], []
        for i in range(n_micro):
            out = self._forward_loss(x[i], mask[i], rand, make_rng(i),
                                     None if labels is None else labels[i],
                                     None if pads is None else pads[i], stripe, timer)
            timer.mark("step.student")
            out.total.backward()
            timer.mark("step.backward")
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
        grad_norm = global_norm(grads, [d is not None for d in self._param_dims], self.tp)
        self.optimizer.step()
        names = list(logs[0])
        means = torch.stack([torch.stack([lg[k].detach().float() for lg in logs]).mean()
                             for k in names] + [torch.stack(losses).mean()])
        if self.dp is not None:  # each rank's logs are its share of the global batch's
            means = self.dp.sum(means)
        values = torch.cat([means, grad_norm.float()[None]])
        timer.mark("step.optim")
        return tuple(names) + ("loss", "grad_norm"), values

    def train_step_chain(self, batches: Sequence[Batch], rand_layers) -> List["StepLogs"]:
        """K = len(batches) optimizer steps, one per batch, all of one
        shape: on the card one replay of the K-step CUDA graph of that
        shape (captured after its first K steps, which run eagerly as the
        warm-up), on the CPU K single steps. Returns each step's logs."""
        if self.device.type != "cuda" or len(batches) < 2:
            return [self.train_step_async(b, rand_layers) for b in batches]
        check_graphable(self.device, self.mesh.backend if self._grouped else None)
        inputs = [self._inputs(b, rand_layers) for b in batches]
        key = tuple(tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inp)
                    for inp in inputs)
        if key not in self._chains:
            # the warm-up: K eager steps on a side stream, which also note
            # the shapes of each step's host draws (_Staged.record)
            staged = _Staged()
            side = _warmup_stream(self.device.index)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                logs = [self._eager_step(inp, lambda i, k=k: self._rng(
                    i, stage=staged.record(k, i))) for k, inp in enumerate(inputs)]
            torch.cuda.current_stream(self.device).wait_stream(side)
            t0 = time.perf_counter()
            chain = self._capture(inputs, staged)
            self._chains[key] = chain._replace(capture_s=time.perf_counter() - t0)
            return logs
        return self._replay(self._chains[key], inputs)

    def _capture(self, inputs, staged: "_Staged") -> "_Chain":
        """The K steps over static copies of ``inputs`` captured in one
        CUDA graph (nothing runs): each step reads its lr from ``lrs``, its
        host draws from the static tensors ``staged`` allocated before the
        capture (outside the graph's pool, so no step's temporaries share
        their memory), and writes its logs to ``out``. The gradients are
        dropped at the end, so no tensor of the graph's pool outlives it but
        ``out``, which the last kernels write."""
        lr = lr_tensor(self.optimizer)
        static = [tuple(None if t is None else t.clone() for t in inp) for inp in inputs]
        lrs = torch.zeros(len(inputs), dtype=torch.float32, device=self.device)
        staged.allocate(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # the phases' events become event-record nodes of the graph
        self._timer = timer = PhaseTimer(self.device, external=True)
        values = []
        with torch.cuda.graph(graph, pool=self._pool):
            for k, inp in enumerate(static):
                lr.copy_(lrs[k])
                names, v = self._step(inp, lambda i, k=k: self._rng(
                    i, step=self.step + k, stage=staged.stage(k, i)))
                values.append(v)
            out = torch.stack(values)
            self.optimizer.zero_grad(set_to_none=True)
        return _Chain(graph, static, lrs, staged, out, names, timer, 0.0)

    def _replay(self, chain: "_Chain", inputs) -> List["StepLogs"]:
        """One replay of ``chain``: the K batches, lrs and host draws
        written into its static tensors, in stream order before it runs."""
        k_steps = len(inputs)
        profiling.settle()  # a profiled replay's phases, before this one re-records them
        with span("chain.batches"):
            for dst, src in zip(chain.inputs, inputs):
                for d, t in zip(dst, src):
                    if d is not None:
                        d.copy_(t, non_blocking=True)
        with span("chain.lrs"):
            lrs = [self.schedule(self.step + k) for k in range(k_steps)]
            chain.lrs.copy_(torch.tensor(lrs, dtype=torch.float32).pin_memory(),
                            non_blocking=True)
        with span("chain.draws"):
            streams = {}
            for k, i, draw, dst in chain.staged.entries:
                if (k, i) not in streams:
                    step = self.step + k
                    streams[k, i] = host_streams(self._seed(i, step=step),
                                                 self._seed(i, rank_free=True, step=step))
                for d, t in zip(dst, draw(streams[k, i])):
                    if d.shape != t.shape:
                        raise RuntimeError(f"a host draw of shape {tuple(t.shape)} for a "
                                           f"static tensor of {tuple(d.shape)}")
                    d.copy_(t.pin_memory(), non_blocking=True)
        with span("chain.launch"):
            chain.graph.replay()
        profiling.defer("step.phases", chain.phases.segments)
        out = chain.out.clone()
        self.step += k_steps
        return [StepLogs(chain.names, out[k], lrs[k]) for k in range(k_steps)]

    def state_dict(self) -> Dict[str, Any]:
        """What a resume needs: the student's weights (and a conformer's
        BatchNorm running statistics), AdamW's moments and the step count,
        which seeds dropout (``_seed``) and sets the lr; under a model axis
        gathered into one process's keys and shapes (every rank of the row
        calls it)."""
        return {"student": gather_state(self.student.state_dict(), self._shards, self.tp),
                "optimizer": self._optimizer_state(self.optimizer.state_dict(), gather=True),
                "step": self.step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """One process's state (``state_dict``), cut to this rank's shards
        under a model axis."""
        self.student.load_state_dict(local_state(state["student"], self._shards, self.tp))
        load_optimizer_state(self.optimizer,
                             self._optimizer_state(state["optimizer"], gather=False))
        self.step = int(state["step"])
        self._chains.clear()  # they read the optimizer's former state tensors

    def _optimizer_state(self, state: Mapping[str, Any], gather: bool) -> Mapping[str, Any]:
        """AdamW's state with each sharded parameter's moments gathered over
        the row (``gather``) or cut to this rank's slice; a new dict, the
        optimizer's own tensors untouched."""
        if self.tp is None:
            return state
        moments = {}
        for i, per_param in state["state"].items():
            dim, local = self._param_dims[int(i)], self.params[int(i)]
            out = dict(per_param)
            for key, v in per_param.items():
                if dim is None or not isinstance(v, torch.Tensor) or v.dim() != local.dim():
                    continue
                out[key] = self.tp.all_gather(v, dim) if gather else \
                    self.tp.local(v, dim).clone()
            moments[i] = out
        return {**state, "state": moments}

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


@functools.lru_cache(maxsize=None)
def _warmup_stream(index: Optional[int]) -> "torch.cuda.Stream":
    """The side stream of every chain's warm-up on card ``index``: cuBLAS
    keeps workspaces for each stream it has run on until the process ends,
    so a new stream per capture would hold card memory for good."""
    return torch.cuda.Stream(torch.device("cuda", index))


def check_graphable(device: torch.device, backend: Optional[str]) -> None:
    """Raise ValueError where K steps cannot be captured in a CUDA graph:
    on the card under a process group whose collectives run on the host
    (gloo), which a graph cannot capture."""
    if torch.device(device).type == "cuda" and backend is not None and backend != "nccl":
        raise ValueError(f"train.steps_per_launch > 1 on the card needs the nccl backend: "
                         f"the {backend} backend's collectives run on the host, and a CUDA "
                         "graph cannot capture them")


class _Staged:
    """The host draws a captured chain reads (``DropoutRNG.stage``). The
    warm-up's eager steps ``record`` the shapes of each (step k, microbatch
    i)'s draws; ``allocate`` makes their static tensors before the capture;
    in the capture ``stage`` hands them out in order and keeps, in capture
    order, each draw function with the tensors it fills (``entries``)."""

    def __init__(self):
        self.shapes: Dict[Tuple[int, int], List[List[Tuple[torch.Size, torch.dtype]]]] = {}
        self.buffers: Dict[Tuple[int, int], List[Tuple[torch.Tensor, ...]]] = {}
        self.entries: List[Tuple[int, int, Callable, Tuple[torch.Tensor, ...]]] = []

    def record(self, k: int, i: int):
        def stage(rng: DropoutRNG, draw) -> Tuple[torch.Tensor, ...]:
            out = to_device(rng, draw)
            self.shapes.setdefault((k, i), []).append([(t.shape, t.dtype) for t in out])
            return out
        return stage

    def allocate(self, device: torch.device) -> None:
        self.buffers = {key: [tuple(torch.empty(shape, dtype=dtype, device=device)
                                    for shape, dtype in call) for call in calls]
                        for key, calls in self.shapes.items()}

    def stage(self, k: int, i: int):
        calls = iter(self.buffers.get((k, i), ()))

        def stage(rng: DropoutRNG, draw) -> Tuple[torch.Tensor, ...]:
            dst = next(calls, None)
            if dst is None:
                raise RuntimeError(f"step {k} microbatch {i} draws more under capture than in "
                                   "its warm-up")
            self.entries.append((k, i, draw, dst))
            return dst
        return stage


class _Chain(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: List[Tuple[Optional[torch.Tensor], ...]]  # per step: x, mask, rand, labels, pads
    lrs: torch.Tensor  # (K,) fp32: each step's lr
    staged: _Staged
    out: torch.Tensor  # (K, n_logs): each step's log values
    names: Tuple[str, ...]
    phases: PhaseTimer  # its events: every replay records them
    capture_s: float  # host seconds the capture took

    def phase_ms(self) -> List[Dict[str, float]]:
        """Each step's ms in each of ``PHASES`` in the last replay; waits
        for it."""
        return self.phases.phase_ms()
