"""Data parallelism over ``torch.distributed`` (the 'data' axis of
``fithubert_tpu/parallel/mesh.py``; ``parallel/distributed.py:19``
``maybe_initialize``).

One process per card. Every rank builds the same global batch's bucket
list and reads its stripe of rows (``data/librispeech.py``); the losses
divide by denominators summed over every rank, so the gradients are summed,
not averaged, in one all-reduce per step (``DataParallel.all_reduce_grads``);
that is the step the JAX mesh computes over the global batch.

    rank, world, device = maybe_initialize("cuda")   # torchrun's environment
    dp = DataParallel.from_process_group()           # None when world is 1
    launch(fn, n, *args)                             # n workers, as torchrun

Without torchrun's environment ``maybe_initialize`` does nothing and
returns ``(0, 1, device)``, as the JAX function does without a coordinator.
The backend is ``nccl`` on the card and ``gloo`` on the CPU; a caller that
wants another (two gloo ranks sharing one card) initialises the group
itself. Under a ('data', 'model') mesh (``parallel/mesh.py``, the tensor
parallelism of ``mesh.py:47-59``) a ``DataParallel`` runs over one column
of the grid (its ``group``): ``rank`` and ``world`` are the data
coordinates, and the sums count each stripe of the batch once.

A conformer student's BatchNorm takes its statistics over the global
microbatch, as the JAX mesh does: its sums go through
``DataParallel.sum_with_grad``, an all-reduce whose backward all-reduces
the gradient.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from fithubert_tpu_torch.device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize(device: Union[str, torch.device] = "cuda"
                     ) -> Tuple[int, int, torch.device]:
    """(rank, world size, this rank's device). Under an initialised process
    group: its rank and size, and ``device`` as given. Under torchrun's
    environment: the group is initialised (``nccl`` for a card, ``gloo`` for
    the CPU) and a ``cuda`` device becomes ``cuda:LOCAL_RANK``, which must
    exist. Otherwise nothing happens: ``(0, 1, device)``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dev
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, dev
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun environment without {', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local} names a card that is not there: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return rank, world, dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn: Callable, rank: int, world: int, port: int, results, args) -> None:
    """A spawned rank: torchrun's environment, then ``fn(*args)``; its
    result, or its traceback, goes to ``results``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, True, out))


def launch(fn: Callable, n: int, *args: Any, timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` processes started with ``spawn`` (CUDA
    cannot fork), each with torchrun's environment for its rank on a free
    local port, so ``maybe_initialize`` there joins them into one group.
    Returns the ranks' results in rank order. If a rank fails, or
    ``timeout`` seconds pass, every rank is stopped and this raises.
    Results come back through a queue: plain values and numpy arrays, not
    tensors, which torch would share through memory of a rank that has
    exited."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, r, n, port, results, args), daemon=False)
             for r in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == n else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    return [got[r] for r in range(n)]


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


@dataclass(frozen=True)
class DataParallel:
    """The collectives of a data-parallel step over ``group`` (None: the
    default process group): ``rank`` of ``world`` ranks."""

    rank: int
    world: int
    group: Any = None

    @classmethod
    def from_process_group(cls) -> Optional["DataParallel"]:
        """The initialised default group, or None without one."""
        if not dist.is_initialized():
            return None
        return cls(dist.get_rank(), dist.get_world_size())

    @property
    def backend(self) -> str:
        """The process group's backend: ``nccl`` or ``gloo``."""
        return str(dist.get_backend(self.group))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (a copy; no gradient flows)."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def sum_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, inside autograd: every rank's output
        depends on every rank's ``x``, so the gradient into ``x`` is the
        output's gradient summed over the ranks."""
        return _SumOverRanks.apply(x, self.group)

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Sum every gradient over the ranks in place, through one flat
        buffer and one all-reduce."""
        grads = list(grads)
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=self.group)
        torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank, in one broadcast."""
        tensors = list(tensors)
        flat = torch._utils._flatten_dense_tensors(tensors)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(flat, src=src, group=self.group)
        torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))

    def any(self, flag: bool, device: torch.device) -> bool:
        """True on every rank when ``flag`` is True on some rank (a MAX
        all-reduce; it waits for the device)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def barrier(self) -> None:
        """Every process of the run, this group's or not, waits here."""
        dist.barrier()
