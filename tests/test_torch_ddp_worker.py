"""One gloo rank of tests/test_torch_ddp.py (torch only, no JAX); no tests
of its own.

    python tests/test_torch_ddp_worker.py <rank> <world> <port> <inputs.pt> <outputs dir>

The inputs hold, per case, the port's ExperimentConfig, the teacher's
geometry, the carried teacher and student state dicts, the global batches
and the random layers. For each case the rank builds a data-parallel
Distiller, takes one step per global batch on its stripe of rows
(``[:, rank::world]``, as the data pipeline stripes a bucket) and records
the logs and the parameters after each step, then the eval step's logs on
its stripe of the eval batch; it also records the random layers the loop
draws for three epochs. The record goes to
``<outputs dir>/rank<rank>.pt``. ``summed_rank``, ``fail_on_rank_1``,
``sigterm_on_rank_1`` and ``specaug_step_rank`` (for tests/test_torch_mel.py)
are ranks for ``launch``.
"""

import os
import random
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fithubert_tpu_torch.parallel.distributed import DataParallel, maybe_initialize  # noqa: E402
from fithubert_tpu_torch.train import loop  # noqa: E402
from fithubert_tpu_torch.train.step import Distiller  # noqa: E402


def main(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        dp = DataParallel.from_process_group()
        spec = torch.load(inputs, weights_only=False)
        record = {}
        for name, case in spec["cases"].items():
            d = Distiller(case["cfg"], case["teacher"], case["student"], device="cpu",
                          num_training_steps=case["num_training_steps"],
                          teacher_geometry=case["geometry"], dp=dp)
            steps = []
            for batch in case["batches"]:
                local = {k: torch.as_tensor(v)[:, rank::world] for k, v in batch.items()}
                logs = d.train_step(local, case["rand"])
                steps.append({"logs": logs, "params": {k: v.clone() for k, v in
                                                       d.student.state_dict().items()},
                              "seed": d._seed(0)})
            py_rng = random.Random(case["cfg"].train.seed)
            ev = {k: torch.as_tensor(v)[rank::world] for k, v in case["eval_batch"].items()}
            record[name] = {"steps": steps, "eval": d.eval_step(ev, case["rand"]),
                            "rand_layers": [loop._sample_rand_layers(py_rng, case["cfg"]).tolist()
                                            for _ in range(3)]}
        torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def summed_rank():
    """A ``launch``ed rank: joins the group from torchrun's environment and
    sums rank + 1 over the ranks."""
    torch.set_num_threads(1)
    rank, world, dev = maybe_initialize("cpu")
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    return rank, world, t.item()


def fail_on_rank_1():
    rank, _, _ = maybe_initialize("cpu")
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()  # rank 0 waits here for a peer that never comes


def sigterm_on_rank_1(cfg):
    """A ``launch``ed rank of run_training on the CPU whose rank 1 gets
    SIGTERM after its second step; returns (result, steps this rank took)."""
    import signal

    torch.set_num_threads(1)
    rank, _, _ = maybe_initialize("cpu")
    plain, steps = Distiller.train_step_async, []

    def step(self, batch, rand):
        logs = plain(self, batch, rand)
        steps.append(self.step)
        if rank == 1 and self.step == 2:
            signal.raise_signal(signal.SIGTERM)
        return logs

    Distiller.train_step_async = step
    return loop.run_training(cfg, resume=False, device="cpu"), steps


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])


def specaug_step_rank(cfg, teacher, student, geometry, batch):
    """A ``launch``ed rank: one data-parallel step of ``cfg`` on this rank's
    stripe (``[:, rank::world]``) of ``batch``; returns (logs, the student's
    state dict as numpy arrays)."""
    torch.set_num_threads(1)
    rank, world, _ = maybe_initialize("cpu")
    d = Distiller(cfg, teacher, student, device="cpu", teacher_geometry=geometry,
                  dp=DataParallel.from_process_group())
    local = {k: torch.as_tensor(v)[:, rank::world] for k, v in batch.items()}
    logs = d.train_step(local, None)
    return logs, {k: v.numpy() for k, v in d.student.state_dict().items()}
