"""The whole bf16 attention backward (``flash_attention._flash_bwd_cuda``:
delta = rowsum(dO * O), then dQ, dK and dV) and SDPA's backward at the
attention shapes of ``chip_smoke.py``'s training paths, p = 0.1, no
padding, timed as ``chip_smoke.py`` times kernels (``cuda_ms``, reps 50),
five rounds in turns. Times the tree whose root is given, so two trees (one
unpacked with ``git archive`` into a git-ignored directory) compare on one
card when their runs alternate in one call:

    python3 scripts/torch_attention_bwd_ab.py build/parent
    python3 scripts/torch_attention_bwd_ab.py .

Prints one ``RESULT`` line of JSON: per shape, the backward's and SDPA's
times of each round.
"""
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs  # noqa: E402

# (B, T, H, D): train (the student), ex, conformer-abs, tp (one model
# rank's heads of the student), and head sizes 80 and 128 on no path
SHAPES = {"train": (12, 299, 12, 40), "ex": (8, 600, 12, 64),
          "conformer-abs": (3, 299, 12, 40), "tp": (12, 299, 6, 40),
          "d80": (12, 599, 12, 80), "d128": (12, 599, 12, 128)}


def main():
    import torch
    import torch.nn.functional as F
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

    t0 = time.time()
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    build_s = time.time() - t0
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for name, (b, t, h, d) in SHAPES.items():
        q, k, v, dout = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16)
                         for _ in range(4))
        q = q * d ** -0.5
        mask = torch.zeros(b, t, dtype=torch.bool, device=dev)
        seed = seed_tensor(5, 6, dev)
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, dropout_p=0.1, seed=seed,
                                          return_lse=True)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(
            qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
            attn_mask=~mask[:, None, None, :], dropout_p=0.1, scale=1.0)
        cases[name] = (lambda q=q, k=k, v=v, m=mask, o=out, l_=lse, g=dout, s=seed:
                       fa._flash_bwd_cuda(q, k, v, m, o, l_, g, 0.1, s),
                       lambda o=o_lib, x=(qs, ks, vs), g=dout.transpose(1, 2):
                       torch.autograd.grad(o, x, g, retain_graph=True))
    out = {"tree": os.path.basename(tree), "build_s": round(build_s, 1),
           "smi": cs.smi_line(), "backward": {n: [] for n in SHAPES},
           "sdpa": {n: [] for n in SHAPES}}
    with torch.no_grad():
        for _ in range(5):
            for name, (bwd, lib) in cases.items():
                out["backward"][name].append(round(cs.cuda_ms(bwd, reps=50), 4))
                with torch.enable_grad():
                    out["sdpa"][name].append(round(cs.cuda_ms(lib, reps=50), 4))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
