"""The training loop (``fithubert_tpu/train/loop.py:112 run_training``):
epochs, the random distill layers drawn per epoch, the teacher hint-init
(``init_conv_layers`` / ``init_encoder_layers``, ``models/surgery.py``,
from the teacher's full-precision weights; a resume restores over it),
validation with v_loss (and WER / CER for a task-specific teacher:
``Distiller.predict_step`` decoded by ``GreedyCTCDecoder`` against the
batch's transcripts), top-k and last checkpoints, early stopping, resume,
a checkpoint on SIGTERM or SIGINT, and the final export.

    run_training(cfg, resume=True, test_only=False, device="cuda")
        -> {"best_v_loss", "steps", "preempted"}  ({"test_loss"} in test mode)

Data parallel over ``torch.distributed``, one process per card (the JAX
mesh's 'data' axis): under torchrun, or an initialised process group, the
run trains on its ranks; otherwise ``train.num_devices`` (0 = every
visible card) counts the visible cards as the JAX mesh takes
``devices[:n]``, and more than one starts that many workers
(``parallel/distributed.py launch``), after the kernels are built. The
datasets take the global batch (``batch_size`` per rank) and each rank
reads its stripe; evals are the global batch's, so v_loss, the top-k and
early stop agree on every rank; a stop on any rank (a signal, checked at
``log_every`` boundaries and at each epoch's end) stops every rank on the
same step; rank 0 writes the configs, ``metrics.jsonl``, the checkpoints,
the trace and the export while the others wait. ``train.steps_per_launch`` >
1 runs its steps one call at a time: the JAX package documents its chain
of K steps as byte-identical to K single launches, so results do not
change. The step's logs stay on the device between ``log_every``
boundaries, so only a logged step (and ``StepTimer``'s barrier, every
``log_every`` steps) waits for the card; the next batches are copied to the
card from pinned memory ahead of the step that reads them.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import signal
from typing import Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from fithubert_tpu_torch.config import ExperimentConfig, dump_config, timestamp_tag
from fithubert_tpu_torch.data.librispeech import make_dataset
from fithubert_tpu_torch.device import resolve_device
from fithubert_tpu_torch.export.fairseq_import import load_teacher_any
from fithubert_tpu_torch.models.student import StudentModel
from fithubert_tpu_torch.models.surgery import init_student_from_teacher
from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
from fithubert_tpu_torch.parallel.distributed import (
    DataParallel,
    launch,
    maybe_initialize,
)
from fithubert_tpu_torch.train.checkpoint import CheckpointManager, export_student
from fithubert_tpu_torch.train.step import Distiller
from fithubert_tpu_torch.utils.logging import MetricsLogger
from fithubert_tpu_torch.utils.profiling import StepTimer, trace
from fithubert_tpu_torch.utils.text import GreedyCTCDecoder, edit_stats

SR = 16000


def _sample_rand_layers(rng: random.Random, cfg: ExperimentConfig) -> np.ndarray:
    """The epoch's distill layers: ``sample(range(N - 1), k)`` (the
    reference's ``train.py:88-91``); k = N - 1 takes every layer."""
    n, k = cfg.distiller.encoder_layers, cfg.loss.distil_random_layer
    return np.asarray(rng.sample(range(n - 1), k), dtype=np.int64)


def load_teacher_checkpoint(cfg: ExperimentConfig
                            ) -> Tuple[Optional[TeacherGeometry], Optional[Dict]]:
    """(geometry, state dict) of ``teacher.teacher_model`` if the file
    exists, else (None, None): a random teacher (smoke mode). A
    checkpoint's geometry wins over the config's."""
    path = cfg.teacher.teacher_model
    if path and os.path.exists(path):
        return load_teacher_any(path)
    print(f"[teacher] checkpoint '{path}' not found: using a randomly initialized "
          f"{cfg.teacher.model_type} teacher (smoke mode)")
    return None, None


def world_size(cfg: ExperimentConfig, dev: torch.device) -> int:
    """The ranks a run starts without torchrun: ``num_devices`` of the
    visible cards (0 = all of them), as the JAX mesh takes ``devices[:n]``;
    one on the CPU."""
    n_visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    return n_visible if cfg.train.num_devices <= 0 else min(cfg.train.num_devices, n_visible)


class PreemptionGuard:
    """SIGTERM / SIGINT set ``should_stop``; the loop then saves ``last/``
    and returns. Off the main thread no handler can be installed, and the
    signals keep their handlers."""

    def __init__(self):
        self.should_stop = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        print(f"[preemption] signal {signum} received: will checkpoint and stop")
        self.should_stop = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def _to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays on ``dev`` (a key starting with ``_`` stays on
    the host): on the card, copied from pinned memory without waiting.
    torch's pinned-memory allocator reuses a buffer only after the copy that
    reads it has finished, so the buffer may be dropped here."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out


def _prefetched(batches: Iterable[Dict[str, np.ndarray]], dev: torch.device,
                depth: int = 2) -> Iterator[Tuple[Dict[str, np.ndarray], Dict]]:
    """(host batch, device batch), the copies issued ``depth`` batches ahead."""
    q: collections.deque = collections.deque()
    for batch in batches:
        q.append((batch, _to_device(batch, dev)))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def run_training(cfg: ExperimentConfig, resume: bool = True, test_only: bool = False,
                 device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Train (or evaluate on the test set) on every rank of the run; each
    rank returns the same result."""
    dev = resolve_device(device)
    rank, world, dev = maybe_initialize(dev)
    if world == 1 and not torch.distributed.is_initialized():
        n = world_size(cfg, dev)
        if n > 1:
            from fithubert_tpu_torch.ops.kernels import SOURCES, _build

            _build.build_all(SOURCES)  # once, before the ranks load them
            return launch(run_training, n, cfg, resume, test_only, "cuda")[0]
    dp = DataParallel.from_process_group()
    out_dir = cfg.train.output_dir
    os.makedirs(out_dir, exist_ok=True)
    if rank == 0:
        # the model-config half of the checkpoint contract, and a timestamped copy
        dump_config(cfg, os.path.join(out_dir, "config.yaml"))
        dump_config(cfg, os.path.join(out_dir, timestamp_tag() + ".yaml"))
    with contextlib.closing(MetricsLogger(out_dir, enabled=rank == 0)) as logger:
        return _train(cfg, dev, out_dir, logger, resume, test_only, dp)


def _train(cfg: ExperimentConfig, dev: torch.device, out_dir: str, logger: MetricsLogger,
           resume: bool, test_only: bool, dp: Optional[DataParallel]) -> Dict[str, float]:
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    batch_size, seed = cfg.train.batch_size * world, cfg.train.seed  # the global batch
    stripe = dict(seed=seed, host_id=rank, num_hosts=world)
    train_data = make_dataset(cfg.data, cfg.data.train_set, batch_size,
                              accum=cfg.train.accumulate_grad_batches, shuffle=True, **stripe)
    eval_data = make_dataset(cfg.data, cfg.data.dev_set, batch_size, accum=1, shuffle=False,
                             **stripe)

    tg, teacher_state = load_teacher_checkpoint(cfg)
    gen = torch.Generator().manual_seed(seed)
    student_state = StudentModel(cfg.distiller, device="cpu").init_weights(gen).state_dict()
    if teacher_state is None:
        geom = TeacherGeometry.from_teacher_config(cfg.teacher)
        teacher_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    if cfg.distiller.init_conv_layers or cfg.distiller.init_encoder_layers > 0:
        # before the Distiller casts the teacher: the student's fp32
        # masters take the teacher's full-precision weights
        student_state, _, _ = init_student_from_teacher(student_state, teacher_state,
                                                        cfg.distiller, verbose=rank == 0)
    distiller = Distiller(cfg, teacher_state, student_state, device=dev,
                          num_training_steps=max(1, cfg.train.num_epochs * len(train_data)),
                          teacher_geometry=tg, dp=dp)
    del teacher_state, student_state
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"), cfg.train.save_top_k, dp=dp)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        distiller.load_state_dict(ckpt.restore())
        start_epoch = distiller.step // max(1, len(train_data))
        print(f"[resume] restored step {distiller.step} (epoch {start_epoch})")

    py_rng = random.Random(seed)

    def sample_rand() -> torch.Tensor:
        layers = (_sample_rand_layers(py_rng, cfg) if cfg.loss.distil_random_layer > 0
                  else np.zeros((0,), np.int64))
        return torch.from_numpy(layers).to(dev)

    decoder = None if cfg.distiller.teacher_task_agnostic else GreedyCTCDecoder()

    def run_eval(data, epoch: int, name: str, rand: torch.Tensor) -> float:
        # the layers the epoch trained on (the reference resamples only at
        # training_epoch_end, train.py:172-174)
        totals: Dict[str, float] = {}
        n = 0
        refs, hyps = [], []
        for batch in data.epoch(epoch):
            b = {k: v[0] for k, v in _to_device(batch, dev).items()}
            logs = distiller.eval_step(b, rand)
            for k, v in logs.items():
                totals[k] = totals.get(k, 0.0) + v
            n += 1
            if decoder is not None and batch.get("_transcripts"):
                ids, _ = distiller.predict_step(b, len(decoder.dictionary))
                for row_ids, ref in zip(ids.cpu().numpy(), batch["_transcripts"][0]):
                    hyps.append(decoder.decode(row_ids))
                    refs.append(ref)
        means = {k: v / max(n, 1) for k, v in totals.items()}
        if decoder is not None:
            # corpus-level rates over every rank's rows
            stats = torch.tensor((*edit_stats(refs, hyps), len(refs)), dtype=torch.float64,
                                 device=dev)
            if dp is not None:
                stats = dp.sum(stats)
            w_err, w_tot, c_err, c_tot, n_refs = stats.tolist()
            if n_refs > 0:
                means["wer"] = w_err / max(w_tot, 1.0)
                means["cer"] = c_err / max(c_tot, 1.0)
        logger.log(distiller.step, means, prefix=f"{name}/")
        return means.get("v_loss", float("inf"))

    if test_only:
        test_data = make_dataset(cfg.data, cfg.data.test_set, batch_size, accum=1,
                                 shuffle=False, **stripe)
        v = run_eval(test_data, 0, "test", sample_rand())
        if rank == 0:
            print(f"[test] loss {v:.4f}")
        return {"test_loss": v}

    def any_rank(flag: bool) -> bool:
        return flag if dp is None else dp.any(flag, dev)

    best_v = float("inf")
    epochs_no_improve = 0
    global_step = distiller.step
    stop = False
    guard = PreemptionGuard()
    timer = StepTimer(sync_every=cfg.train.log_every, device=dev)
    prof_start = global_step + 2  # past the warm-up steps
    prof_stop = prof_start + cfg.train.profile_steps
    profiler = None
    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            rand = sample_rand()
            for raw, batch in _prefetched(train_data.epoch(epoch), dev):
                if rank == 0 and profiler is None and prof_start <= global_step < prof_stop:
                    profiler = trace(os.path.join(out_dir, "trace"))
                    profiler.__enter__()
                logs = distiller.train_step_async(batch, rand)
                global_step += 1
                if profiler is not None and global_step >= prof_stop:
                    profiler.__exit__(None, None, None)
                    profiler = None
                rates = timer.tick(audio_sec=float(np.sum(~raw["padding_mask"])) / SR)
                if cfg.train.monitor_losses and global_step % cfg.train.log_every == 0:
                    logger.log(global_step, {**logs.to_floats(), **rates})
                # a signal on any rank stops them all on one step; the
                # ranks agree at log boundaries, one process at every step
                if (dp is None or global_step % cfg.train.log_every == 0) and \
                        any_rank(guard.should_stop):
                    guard.should_stop = True
                    # last/ only: a snapshot without v_loss takes no best/ slot
                    ckpt.save_last(global_step, distiller.state_dict())
                    if rank == 0:
                        print(f"[preemption] checkpointed step {global_step}; exiting")
                    stop = True
                    break
                if cfg.train.max_steps and global_step >= cfg.train.max_steps:
                    stop = True
                    break
            if stop and guard.should_stop:
                break
            v_loss = run_eval(eval_data, epoch, "val", rand)
            ckpt.save(global_step, distiller.state_dict(), v_loss)
            if v_loss < best_v:
                best_v, epochs_no_improve = v_loss, 0
            else:
                epochs_no_improve += 1
                if epochs_no_improve >= cfg.train.early_stop_patience:
                    if rank == 0:
                        print(f"[early-stop] no v_loss improvement in "
                              f"{cfg.train.early_stop_patience} epochs")
                    stop = True
            if dp is not None and dp.any(guard.should_stop, dev):
                guard.should_stop = stop = True  # a signal since the last boundary
            if any_rank(stop):
                break
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
        guard.restore()
    if rank == 0:
        export_student(cfg, distiller.student.state_dict(), out_dir, tag="student")
    if dp is not None:
        dp.barrier()
    return {"best_v_loss": best_v, "steps": global_step, "preempted": guard.should_stop}
