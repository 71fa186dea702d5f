"""Card memory that stays allocated across the port's train-step phases.

Runs the given phases of ``chip_smoke.py`` on one card (``smoke``:
[smoke-configs], ``remat``: [remat], ``chain``: [chain]) after the kernels'
build and the release set-up, and prints before and after each: the
memory still allocated, the same after ``gc.collect()``, the CUDA
storages Python objects still reach, and the live Distillers, models,
optimizers and CUDA graphs. Memory allocated but reached by no Python
object is held by the libraries (cuBLAS workspaces, graph pools).

    python3 scripts/torch_memory_probe.py smoke remat chain
"""

import collections
import dataclasses
import gc
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

KINDS = ("Distiller", "StudentModel", "TeacherModel", "AdamW", "CUDAGraph", "_Chain")


def report(tag):
    import torch

    before = torch.cuda.memory_allocated()
    gc.collect()
    after = torch.cuda.memory_allocated()
    storages, kinds = {}, collections.Counter()
    for o in gc.get_objects():
        if type(o).__name__ in KINDS:
            kinds[type(o).__name__] += 1
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    print(f"[memory] {tag}: allocated {before / 2 ** 30:.3f} GiB, {after / 2 ** 30:.3f} GiB "
          f"after gc.collect(); CUDA storages reached from Python {len(storages)}, "
          f"{sum(storages.values()) / 2 ** 30:.3f} GiB; live {dict(kinds)}", flush=True)


def main():
    import torch

    from fithubert_tpu_torch.config import conformer_experiment, fithubert_960h_experiment
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.ops.kernels import SOURCES, _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import dropout as kd
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        cs.fail("the memory probe needs a CUDA card")
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    _build.build_all(SOURCES)
    for name in SOURCES:
        _build.load(name)
    exp = fithubert_960h_experiment()
    geom = TeacherGeometry.from_teacher_config(exp.teacher)
    gen = torch.Generator().manual_seed(0)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(exp.distiller, device="cpu").init_weights(gen).state_dict()
    rand = torch.randperm(exp.distiller.encoder_layers - 1, generator=gen)
    per_step = cs.release_per_step(exp, geom)
    a, l_s, l_t = exp.train.accumulate_grad_batches, exp.distiller.encoder_layers, \
        geom.encoder_layers
    exp_taps = dataclasses.replace(exp, loss=dataclasses.replace(exp.loss, **cs.TAP_LOSS))
    per_step_taps = cs.plus_k5({cf.KERNEL: a * per_step[cf.KERNEL],
                                cf.KERNEL_PREFIX: a * per_step[cf.KERNEL_PREFIX],
                                fa.KERNEL: a * (l_t - 1), fa.KERNEL_DROPOUT: a * (l_s - 1),
                                fa.KERNEL_DQ: a * (l_s - 1), fa.KERNEL_DKV: a * (l_s - 1),
                                kd.KERNEL: 2 * a, cf.KERNEL_BWD: a * per_step[cf.KERNEL_BWD]},
                               exp.distiller, a)
    work = tempfile.TemporaryDirectory(prefix="memory_probe_")
    report("start")
    if "smoke" in sys.argv[1:]:
        cs.smoke_configs_phase(gen, smi, work.name, {})
        report("after [smoke-configs]")
    if "remat" in sys.argv[1:]:
        cs.remat_phase(exp, geom, t_state, s_state, rand, gen, smi)
        report("after [remat]")
    if "chain" in sys.argv[1:]:
        exp_c = conformer_experiment("rel_pos")
        c_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
        cs.chain_phase({"release": (exp, s_state, rand, per_step),
                        "path B": (exp_taps, s_state, rand, per_step_taps),
                        "rel_pos conformer": (exp_c, c_state,
                                              torch.randperm(exp_c.distiller.encoder_layers - 1,
                                                             generator=gen),
                                              cs.conformer_per_step(exp_c, geom))},
                       t_state, gen, smi, work.name)
        report("after [chain]")
    work.cleanup()
    print(f"[memory] done in {time.perf_counter() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
