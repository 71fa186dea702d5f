"""Device busy of serving (``UpstreamExpert`` at B = 32 x 16 s) and of the
release train step (``Distiller.train_step`` on 3 x 4 x 12 s), bf16,
seeded weights, and the attention forward's (K2's) share of each: the
device time of every kernel over 3 calls (torch.profiler), as
``chip_smoke.py``'s [timing] profiles them, three times. Times the tree
whose root is given, so two trees (one unpacked with ``git archive`` into a
git-ignored directory) compare on one card when their runs alternate in
one call:

    python3 scripts/torch_busy_ab.py build/parent
    python3 scripts/torch_busy_ab.py .

Prints one ``RESULT`` line of JSON: per path, the busy ms per call and K2's
ms per call of each profile.
"""
import dataclasses
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs  # noqa: E402


def device_ms(fn, n=3):
    """(busy, K2) device ms per call of fn over n calls: the sum of every
    kernel's device time (user-annotated ranges left out), and of the
    attention forward's kernels (``flash_fwd``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ranges = {e.key for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]
    busy = sum(t for _k, t in rows)
    k2 = sum(t for k, t in rows if "flash_fwd" in k)
    return round(busy, 4), round(k2, 4)


def main():
    import torch
    from fithubert_tpu_torch.config import fithubert_960h, fithubert_960h_experiment
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.ops.kernels import SOURCES, _build
    from fithubert_tpu_torch.train.step import Distiller

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(SOURCES)
    cfg, exp = fithubert_960h(), fithubert_960h_experiment()
    geom = TeacherGeometry.from_teacher_config(exp.teacher)
    gen = torch.Generator().manual_seed(0)
    out = {"tree": os.path.basename(tree), "smi": cs.smi_line(), "serving": [], "train": []}

    student = StudentModel(dataclasses.replace(cfg, compute_dtype="float32"),
                           device="cpu").init_weights(gen)
    expert = UpstreamExpert(student.state_dict(), cfg, device="cuda")
    bench = [torch.randn(16 * cs.SR, generator=gen) * 0.1 for _ in range(32)]
    with torch.no_grad():
        for _ in range(3):
            expert(bench)
        for _ in range(3):
            out["serving"].append(device_ms(lambda: expert(bench)))
    del expert

    teacher = TeacherModel(geom, device="cpu").init_weights(gen)
    s_state = StudentModel(exp.distiller, device="cpu").init_weights(gen).state_dict()
    rand_layers = torch.randperm(exp.distiller.encoder_layers - 1, generator=gen)
    d = Distiller(exp, teacher.state_dict(), s_state, device="cuda", num_training_steps=40)
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size
    fixed = cs.train_batch(gen, a, b, 12.0, ragged=False)
    for _ in range(3):
        d.train_step(fixed, rand_layers)
    for _ in range(3):
        out["train"].append(device_ms(lambda: d.train_step(fixed, rand_layers)))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
