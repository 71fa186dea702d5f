"""The gloo ranks of tests/test_torch_tp.py (torch only, no JAX); no tests
of their own.

    python tests/test_torch_tp_worker.py <rank> <world> <port> <model axis> <inputs.pt> <outputs dir>

runs one rank of a ('data', 'model') mesh of ``world / model axis`` x
``model axis`` ranks: for each case of the inputs (the port's
ExperimentConfig, the teacher's geometry, the carried teacher and student
state dicts, the global batches, the random layers) a tensor-parallel
Distiller takes one step per global batch on its data stripe of rows
(``[:, data_rank::data]``) and records the logs and the gathered student
state dict after each step, then the eval step's logs on its stripe of the
eval batch. The record goes to ``<outputs dir>/mesh<data>x<model>_rank<rank>.pt``.
``collectives_rank``, ``dropout_rank``, ``dryrun_rank`` and
``sharded_forward_rank`` are ranks for ``launch``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fithubert_tpu_torch.parallel.distributed import maybe_initialize  # noqa: E402
from fithubert_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from fithubert_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from fithubert_tpu_torch.train.step import Distiller  # noqa: E402


def _stripe(batch, mesh, microbatched=True):
    """This rank's data stripe of a global batch: rows data_rank::data."""
    rows = slice(mesh.data_rank, None, mesh.data)
    return {k: torch.as_tensor(v)[:, rows] if microbatched else torch.as_tensor(v)[rows]
            for k, v in batch.items()}


def _distiller(case, mesh):
    return Distiller(case["cfg"], case["teacher"], case["student"], device="cpu",
                     num_training_steps=case["num_training_steps"],
                     teacher_geometry=case["geometry"], mesh=mesh)


def main(rank, world, port, model_axis, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(model_axis=model_axis)
        spec = torch.load(inputs, weights_only=False)
        record = {}
        for name, case in spec["cases"].items():
            d = _distiller(case, mesh)
            steps = []
            for batch in case["batches"]:
                logs = d.train_step(_stripe(batch, mesh), case["rand"])
                steps.append({"logs": logs, "student": {  # a copy: the state shares the weights
                    k: v.clone() for k, v in d.state_dict()["student"].items()}})
            record[name] = {"steps": steps, "eval": d.eval_step(
                _stripe(case["eval_batch"], mesh, microbatched=False), case["rand"])}
        torch.save(record, os.path.join(out_dir, f"mesh{mesh.data}x{model_axis}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def collectives_rank(x, parts, w):
    """A ``launch``ed rank of a one-row mesh: copy_to_model, reduce_from_model
    and gather_from_model forward and backward, in fp32 and bf16, on ``x``
    (the same on every rank), ``parts[rank]`` and the loss weights ``w``
    (``w[rank]`` for the copy). Returns numpy arrays: {name: (out, grad)}."""
    torch.set_num_threads(1)
    rank, world, _ = maybe_initialize("cpu")
    tp = make_mesh(model_axis=world).tp
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        for name, leaf, fn, weight in (
                ("copy", x, tp.copy, w[rank]),
                ("reduce", parts[rank], tp.reduce, w[0]),
                ("gather", parts[rank], lambda t: tp.gather(t, -1), np.concatenate(w, -1))):
            t = torch.tensor(leaf, dtype=dtype, requires_grad=True)
            y = fn(t)
            (y.float() * torch.tensor(weight)).sum().backward()
            out[f"{name} {tag}"] = (y.detach().float().numpy(), t.grad.float().numpy())
    return out


def dropout_rank(case, twin=None):
    """A ``launch``ed rank of a (1 x 2) mesh: two training steps with
    dropout on (the first at lr 0); every dropout site's (seed words,
    shape) of the first, in the order drawn, and this rank's share of the
    student after the second (numpy). With ``twin`` (another case), the
    twin's sites and share after the same two steps follow."""
    torch.set_num_threads(1)
    maybe_initialize("cpu")
    mesh = make_mesh(model_axis=dist.get_world_size())
    out = _two_steps(case, mesh)
    return out if twin is None else out + _two_steps(twin, mesh)


def _two_steps(case, mesh):
    d = _distiller(case, mesh)
    with SiteRecorder() as sites:
        d.train_step(case["batches"][0], case["rand"])
    d.train_step(case["batches"][1], case["rand"])
    return sites, {k: v.numpy() for k, v in d.student.state_dict().items()}


class SiteRecorder:
    """Records (seed words, shape) at every dropout site of a step, in the
    order drawn (a recomputed layer's draws again in the backward): the
    elementwise ones (``ops/dropout.py``'s K5), the probabilities' K5 of
    path B (``ops/attention.py attention_with_taps``) and of the conformers
    (``ops/conformer.py _attend``), and the flash attention's."""

    def __enter__(self):
        from fithubert_tpu_torch.ops import attention, conformer, dropout

        drop, flash = dropout.seeded_dropout, attention.flash_attention
        self.patched = [(mod, "seeded_dropout", drop) for mod in (dropout, attention, conformer)]
        self.patched.append((attention, "flash_attention", flash))
        self.sites = []

        def dropped(x, seed, p):
            self.sites.append((tuple(seed.tolist()), tuple(x.shape)))
            return drop(x, seed, p)

        def attended(q, k, v, mask, dropout_p=0.0, seed=None, **kw):
            if seed is not None:
                self.sites.append((tuple(seed.tolist()), tuple(q.shape)))
            return flash(q, k, v, mask, dropout_p=dropout_p, seed=seed, **kw)

        for mod, name, _ in self.patched:
            setattr(mod, name, attended if name == "flash_attention" else dropped)
        return self.sites

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)


def dryrun_rank(case, one_state, ckpt_dir, model_axis):
    """A ``launch``ed rank of ``dryrun_multichip``'s tail on a mesh: a step,
    an eval, a checkpoint save, a restore into a fresh tensor-parallel
    Distiller and its eval; then ``one_state`` (one process's state) loaded
    into a third and gathered back. Returns (v_loss before, v_loss after
    the restore, the gathered state back as numpy, the names and shapes of
    the saved state)."""
    torch.set_num_threads(1)
    maybe_initialize("cpu")
    mesh = make_mesh(model_axis=model_axis)
    ev = _stripe(case["eval_batch"], mesh, microbatched=False)
    d = _distiller(case, mesh)
    d.train_step(_stripe(case["batches"][0], mesh), case["rand"])
    v0 = d.eval_step(ev, case["rand"])["v_loss"]
    ckpt = CheckpointManager(ckpt_dir, dp=mesh.world)
    ckpt.save(d.step, d.state_dict(), v0)
    fresh = _distiller(case, mesh)
    saved = ckpt.restore()
    fresh.load_state_dict(saved)
    v1 = fresh.eval_step(ev, case["rand"])["v_loss"]
    third = _distiller(case, mesh)
    third.load_state_dict(one_state)
    back = third.state_dict()
    return (v0, v1, {"student": {k: v.numpy() for k, v in back["student"].items()},
                     "moments": {i: {k: v.numpy() for k, v in s.items()}
                                 for i, s in back["optimizer"]["state"].items()}},
            {k: tuple(v.shape) for k, v in saved["student"].items()})


def sharded_forward_rank(cfg, state, wav, mask):
    """A ``launch``ed rank of a one-row mesh: a StudentModel sharded over the
    row, given ``state`` (one process's, carried from the JAX tree) through
    ``shard_state_dict``; its deterministic forward's outputs as
    tests/test_torch_ex.py ``_outputs`` names them (numpy)."""
    from fithubert_tpu_torch.export.jax_params import shard_state_dict
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.parallel.mesh import shard_

    torch.set_num_threads(1)
    maybe_initialize("cpu")
    tp = make_mesh(model_axis=dist.get_world_size()).tp
    model = StudentModel(cfg, device="cpu")
    shard_(model, tp)
    model.load_state_dict(shard_state_dict(state, model, tp))
    out = model(torch.from_numpy(wav), torch.from_numpy(mask))
    d = {"x": out.x.numpy(), "features": out.features.numpy(), "mask": out.padding_mask.numpy()}
    for i, (h, _taps, lr) in enumerate(out.layer_results):
        d[f"hidden{i}"], d[f"ffn{i}"] = h.numpy(), lr.numpy()
    for i, tr in enumerate(out.tr_layer_results):
        d[f"tr{i}"] = tr.numpy()
    d["projections"] = out.projections.numpy()
    return d


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:5]), sys.argv[5], sys.argv[6])
