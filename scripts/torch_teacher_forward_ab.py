"""The int8 and bf16 HuBERT-Base teachers' forward on 12 x 12 s (random
weights from seed 0), timed as ``chip_smoke.py``'s [int8] phase times it
(``cuda_ms``, reps 5): ten rounds in turns, then each one's device busy
from torch.profiler. Times the tree whose root is given, so two trees (one
unpacked with ``git archive`` into a git-ignored directory) compare on one
card when their runs alternate in one call:

    python3 scripts/torch_teacher_forward_ab.py build/parent
    python3 scripts/torch_teacher_forward_ab.py .

Prints one ``RESULT`` line of JSON.
"""
import dataclasses
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from fithubert_tpu_torch.config import fithubert_960h_experiment
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.ops.kernels import SOURCES, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all(SOURCES)
    for n in SOURCES:
        _build.load(n)
    build_s = time.time() - t0
    exp = fithubert_960h_experiment()
    geom = TeacherGeometry.from_teacher_config(exp.teacher)
    gen = torch.Generator().manual_seed(0)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    teachers = {}
    for what, q in (("int8", True), ("bf16", False)):
        g = dataclasses.replace(geom, compute_dtype="bfloat16", quantize_int8=q)
        t = TeacherModel(g, device="cuda")
        t.load_state_dict(t_state)
        teachers[what] = t.freeze()
    fixed = cs.train_batch(gen, 4, 3, 12.0, ragged=False)
    x = fixed["x"].reshape(-1, fixed["x"].shape[-1]).cuda()
    m = fixed["padding_mask"].reshape(x.shape).cuda()
    out = {"tree": os.path.basename(tree), "build_s": round(build_s, 1), "int8": [], "bf16": []}
    with torch.no_grad():
        for _ in range(10):
            for what, t in teachers.items():
                out[what].append(round(cs.cuda_ms(lambda: t(x, m), reps=5, warmup=2), 3))
        for what, t in teachers.items():
            out[f"{what} busy"] = round(cs.profile_device(lambda: t(x, m), f"{what} teacher forward", top=0), 3)
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
