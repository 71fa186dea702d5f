"""The bf16 attention forward (K2, ``flash_attention.flash_attention``) and
SDPA's forward at the attention shapes of ``chip_smoke.py``'s paths, with
each path's dropout, no padding, timed as ``chip_smoke.py`` times kernels
(``cuda_ms``, reps 50), five rounds in turns. Times the tree whose root is
given, so two trees (one unpacked with ``git archive`` into a git-ignored
directory) compare on one card when their runs alternate in one call:

    python3 scripts/torch_attention_fwd_ab.py build/parent
    python3 scripts/torch_attention_fwd_ab.py .

Prints one ``RESULT`` line of JSON: per shape, K2's and SDPA's times of
each round.
"""
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs  # noqa: E402

# (B, T, H, D), p: serving, the teacher, the wav2vec2-Large teacher, one
# model rank of the teacher, the student, ex, the abs conformer, one model
# rank of the student, and head sizes 80 and 128 on no path
SHAPES = {"serving": ((32, 399, 12, 40), 0.0), "teacher": ((12, 599, 12, 64), 0.0),
          "large": ((12, 599, 16, 64), 0.0), "tp-teacher": ((12, 599, 6, 64), 0.0),
          "student": ((12, 299, 12, 40), 0.1), "ex": ((8, 600, 12, 64), 0.1),
          "conformer-abs": ((3, 299, 12, 40), 0.1), "tp-student": ((12, 299, 6, 40), 0.1),
          "d80": ((12, 599, 12, 80), 0.1), "d128": ((12, 599, 12, 128), 0.1)}


def main():
    import torch
    import torch.nn.functional as F
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

    t0 = time.time()
    _build.build_all(["flash_attention"])
    build_s = time.time() - t0
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for name, ((b, t, h, d), p) in SHAPES.items():
        q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        q = q * d ** -0.5
        mask = torch.zeros(b, t, dtype=torch.bool, device=dev)
        seed = seed_tensor(5, 6, dev) if p else None
        cases[name] = (lambda q=q, k=k, v=v, m=mask, p=p, s=seed:
                       fa.flash_attention(q, k, v, m, dropout_p=p, seed=s),
                       lambda q=q, k=k, v=v, m=mask, p=p: F.scaled_dot_product_attention(
                           q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           attn_mask=~m[:, None, None, :], dropout_p=p, scale=1.0))
    out = {"tree": os.path.basename(tree), "build_s": round(build_s, 1),
           "smi": cs.smi_line(), "k2": {n: [] for n in SHAPES}, "sdpa": {n: [] for n in SHAPES}}
    with torch.no_grad():
        for _ in range(5):
            for name, (k2, lib) in cases.items():
                out["k2"][name].append(round(cs.cuda_ms(k2, reps=50), 4))
                out["sdpa"][name].append(round(cs.cuda_ms(lib, reps=50), 4))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
