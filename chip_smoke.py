#!/usr/bin/env python3
"""Build and drive the PyTorch port (fithubert_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own line(s) and any failed check ending the
run with a non-zero exit and no final line:

  1. device: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel of csrc/, one nvcc each, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes, bf16 and fp32 (TF32 off), ragged inputs: the
     conv stack (K1) of the student (C0 = 128) and of the teacher (C0 =
     512), the attention forward (K2) at the serving and the teacher's
     shapes and with dropout on the same keep mask, and the attention
     backward (K3 dQ, K4 dK/dV);
  4. serving end to end: UpstreamExpert at FitHuBERT-960h width (seeded
     weights) serves three ragged requests in bf16, through K1 and K2
     (launch counters are zeroed just before and read just after); then the
     same weights in fp32 on the card against the CPU's plain versions;
  5. training end to end: the Distiller of configs/fithubert.yaml (HuBERT-
     Base teacher, FitHuBERT-960h student, seeded weights, bf16, dropout
     0.1) takes a ragged 3 x 4 step with a fabricated row, then 10 steps on
     one 3 x 4 x 12 s batch; every step goes through K1, K2 (teacher p = 0,
     student p = 0.1), K3 and K4, and the loss falls; then one fp32 step
     without dropout on the card against the CPU's plain versions;
  6. timing: serving at B = 32 x 16 s and the train step at 3 x 4 x 12 s,
     with a profile of each, and every kernel against its bound, its plain
     version and the library call, one row per kernel and path at that
     path's shapes, with the launches that path's run counted;
  7. a JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

SR = 16000
BF16_PEAK, HBM_BPS = 989e12, 3.35e12  # H100 SXM data sheet: bf16 tensor cores, HBM3

# Tolerances. Elementwise, |kernel - plain| <= ATOL + RTOL * |plain|:
#   fp32: only the summation order differs (kernel tiles vs cuDNN / einsum);
#   bf16 attention: both sides compute in fp32 from the same bf16 inputs and
#   round once, so they differ by at most one bf16 step (2^-8 relative).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
LAYER_TOL = {"float32": TOL["float32"], "bfloat16": (1e-2, 2 ** -6)}
# Each conv layer is also checked alone (given the plain version's input),
# elementwise within LAYER_TOL: the two sides then differ only where their
# fp32 sums straddle a bf16 rounding boundary of the pre-activation, and
# the GELU and its own rounding can turn that one step into two of the
# output. On an H100 the plain version gave 2.015625 where the kernel gave
# 2.046875: the exact sum is 2.0703129, 1e-7 above a bf16 tie, and the
# kernel agreed with the exactly summed value. So LAYER_TOL allows two bf16
# steps (2^-6 relative) in bf16 and is TOL in fp32.
# Through the whole bf16 stack, where each side rounds its own layer
# outputs, those flips compound (3.8e-3 relative at the student's 8 layers
# on an H100), so the whole stack is checked norm-wise:
#   ||kernel - plain|| / ||plain|| <= STACK_FRO and
#   max |kernel - plain| <= STACK_PEAK * max |plain|  (4 bf16 steps).
STACK_FRO, STACK_PEAK = 1e-2, 2 ** -6
# fp32 card vs fp32 CPU through the whole model (21 layers of matmuls and
# norms, two BLAS libraries): summation order only.
E2E_ATOL = E2E_RTOL = 2e-3
# bf16 card vs fp32 card, norm-wise per output: bf16 keeps 8 bits, so the
# outputs differ by a few percent at most; a broken op differs by ~100%.
BF16_VS_FP32_FRO = 0.1
# The attention backward (K3, K4) against attention_bwd_plain: the same fp32
# formulas from the same bf16 inputs (q, k, v, dO, lse, delta), rounded once:
# TOL above. Against autograd of attention_plain (p = 0), whose implicit
# delta uses the unrounded fp32 output where the kernels read O in bf16:
# that rounding (2^-9 of |dO . O|) moves dS by a few bf16 steps, within TOL.
# The fp32 train step, card vs CPU, full width, no dropout: the loss and
# grad_norm through 24 layers and a backward agree to summation order
# (relative TRAIN_RTOL); AdamW normalises each update to about lr, so
# parameters after a step agree to a small fraction of lr (TRAIN_PARAM_ATOL
# = 5% of the release lr) unless a gradient sits at eps.
TRAIN_RTOL, TRAIN_PARAM_ATOL = 1e-3, 2.5e-5
# The dropout keep-rate over a (B, H, T, T) mask: within 4 binomial sigmas.
KEEP_SIGMAS = 4.0
ATTN_P = 0.1  # attention_dropout of configs/fithubert.yaml


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
        else f"nvidia-smi failed: {r.stderr.strip()}"


def compare(name, got, want, dtype_name, rows=None, normwise=False, tol=TOL):
    """Check got against want (optionally on a row subset); returns max abs err."""
    import torch

    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    max_abs = err.max().item()
    peak = w.abs().max().item()
    fro = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
    if normwise:
        ok = fro <= STACK_FRO and max_abs <= STACK_PEAK * peak
        tol = f"fro<={STACK_FRO}, max<={STACK_PEAK}*max|plain|"
    else:
        atol, rtol = tol[dtype_name]
        ok = bool((err <= atol + rtol * w.abs()).all())
        tol = f"({atol}, {rtol})"
    print(f"  {name}: max_abs_err={max_abs:.3e} max|plain|={peak:.3e} "
          f"rel_fro={fro:.3e} tol={tol} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of fn over reps launches, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ragged_wavs(gen, n, lo_s, hi_s):
    import torch

    lengths = torch.randint(int(lo_s * SR), int(hi_s * SR) + 1, (n,), generator=gen)
    return [torch.randn(int(t), generator=gen) * 0.1 for t in lengths]


def block0_features(model, wavs, dtype, device):
    """The block-0 output of the expert's padded batch: the conv stack's input."""
    import torch

    from fithubert_tpu_torch.export.expert import quantize_length

    t_pad = quantize_length(max(len(w) for w in wavs), SR)
    batch = torch.zeros(len(wavs), t_pad)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    fe = model.feature_extractor
    d0, k0, s0 = fe.spec[0]
    w0 = fe.conv_layers[0][0].weight.to(device, dtype).reshape(d0, k0)
    return batch.to(device, dtype).unfold(1, k0, s0) @ w0.t()


def stack_inputs(model, wavs, dtype, device):
    """(x, weights, scale, shift): what the extractor of ``model`` hands
    conv_stack for the padded batch of ``wavs``."""
    import torch

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    fe = model.feature_extractor
    gn = fe.conv_layers[0][2]
    x = block0_features(model, wavs, dtype, device)
    ws = [blk[0].weight.to(device, dtype).permute(2, 1, 0) for blk in fe.conv_layers[1:]]
    with torch.no_grad():
        scale, shift = cf.gn_scale_shift(x, gn.weight.to(device), gn.bias.to(device), gn.eps)
    return x, ws, scale, shift


def check_conv_stack(model, wavs, dev, who):
    """conv_stack against conv_stack_plain on ``model``'s block-0 features:
    bf16 and fp32, with and without the GroupNorm prefix, and each layer
    alone given the plain version's input. Returns the bf16 whole-stack
    max abs error."""
    import torch

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    spec = model.feature_extractor.spec[1:]
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x, ws, scale, shift = stack_inputs(model, wavs, dtype, dev)
        for prefix in (True, False):
            ss = (scale, shift) if prefix else (None, None)
            with torch.no_grad():
                got = cf.conv_stack(x, ws, spec, *ss)
                want = cf.conv_stack_plain(x, ws, spec, *ss)
            torch.cuda.synchronize()
            tag = f"{who} {dtype_name} {'GN prefix' if prefix else 'no prefix'} {tuple(x.shape)}"
            e = compare(f"conv_stack {tag}", got, want, dtype_name,
                        normwise=dtype_name == "bfloat16")
            if dtype_name == "bfloat16":
                worst = max(worst, e)
            del got, want
        h = x
        for i, (w, layer) in enumerate(zip(ws, spec)):
            ss = (scale, shift) if i == 0 else (None, None)
            with torch.no_grad():
                got = cf.conv_stack(h, [w], (layer,), *ss)
                h = cf.conv_stack_plain(h, [w], (layer,), *ss)
            compare(f"conv_stack {who} {dtype_name} layer {i} {layer}", got, h, dtype_name,
                    tol=LAYER_TOL)
        del x, h, got
    return worst


def conv_times(model, wavs, dev):
    """(kernel ms, plain ms, library ms, (flops, bytes)) of conv_stack in
    bf16 on ``model``'s block-0 features of ``wavs``. The library call is
    the GroupNorm prefix and a cuDNN conv1d + GELU per layer."""
    import torch
    import torch.nn.functional as F

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    spec = model.feature_extractor.spec[1:]
    x, ws, scale, shift = stack_inputs(model, wavs, torch.bfloat16, dev)
    wl = [w.permute(2, 1, 0).contiguous() for w in ws]  # torch (C_out, C_in, k) layout

    def library():
        h = F.gelu(x * scale[:, None] + shift[:, None], approximate="tanh").transpose(1, 2)
        for w, (_d, _k, s) in zip(wl, spec):
            h = F.gelu(F.conv1d(h, w, stride=s), approximate="tanh")
        return h

    with torch.no_grad():
        return (cuda_ms(lambda: cf.conv_stack(x, ws, spec, scale, shift), reps=10),
                cuda_ms(lambda: cf.conv_stack_plain(x, ws, spec, scale, shift), reps=10),
                cuda_ms(library, reps=10), conv_work(x, spec))


def stack_shape(model, wavs):
    """The (B, T, C0) input that conv_stack gets for the padded batch of wavs."""
    from fithubert_tpu_torch.export.expert import quantize_length

    d0, k0, s0 = model.feature_extractor.spec[0]
    t_pad = quantize_length(max(len(w) for w in wavs), SR)
    return (len(wavs), (t_pad - k0) // s0 + 1, d0)


def conv_work(x, spec):
    """(flops, bytes) the conv stack needs: inputs read once, output once."""
    b, t, c = x.shape
    flops, bytes_ = 0, x.numel() * x.element_size() + 2 * b * c * x.element_size()
    for (d, k, s) in spec:
        t_out = (t - k) // s + 1
        flops += 2 * b * t_out * d * k * c
        bytes_ += k * c * d * x.element_size()
        t, c = t_out, d
    return flops, bytes_ + b * t * c * x.element_size()


def attn_work(q, mask):
    """(flops, bytes) of attention over the valid keys of this input."""
    b, t, h, d = q.shape
    valid = (~mask).sum().item() if mask is not None else b * t
    flops = 4 * h * d * t * valid  # QK^T and PV over the valid keys
    bytes_ = 4 * q.numel() * q.element_size() + b * t + b * h * t * 4
    return flops, bytes_


def attn_bwd_work(q, mask, n_out):
    """(flops, bytes) of one attention backward kernel over the valid keys:
    K3 (n_out = 1) recomputes QK^T and dO V^T and forms dS K (6 D per query
    and key); K4 (n_out = 2) also forms P^T dO and dS^T Q (8 D). Each reads
    q, k, v, dO, lse, delta and the mask once and writes its outputs once."""
    b, t, h, d = q.shape
    valid = (~mask).sum().item() if mask is not None else b * t
    flops = (4 + 2 * n_out) * h * d * t * valid
    bytes_ = (4 + n_out) * q.numel() * q.element_size() + b * t + 2 * b * h * t * 4
    return flops, bytes_


def bound(flops, bytes_, peak):
    t_ops, t_bytes = flops / peak * 1e3, bytes_ / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_device(fn, what, n=3, top=14, unprofiled_ms=None):
    """Device time by kernel over n calls of fn (torch.profiler), the
    device's busy share of the wall time (and of ``unprofiled_ms``, the same
    call timed without the profiler), and peak memory. Ranges that user code
    annotates (torch.optim's ``Optimizer.step#...``) span kernels counted
    already and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    ranges = {e.key for e in prof.events() if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(t for _k, t in rows)
    if not rows:
        print("  profile: the profiler saw no device time (not measured)", flush=True)
        return
    share = "" if unprofiled_ms is None else \
        f", {100 * busy / unprofiled_ms:.1f}% of the unprofiled {unprofiled_ms:.3f} ms"
    print(f"  profile: wall {wall:.3f} ms per {what}, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%{share}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for key, t in rows[:top]:
        print(f"    {t:8.3f} ms {100 * t / busy:5.1f}%  {key[:90]}", flush=True)


def attention_case(gen, b, t, h, d, dtype, dev, full_pad_row):
    """Pre-scaled q, k, v, an output gradient and a ragged (B, T) mask."""
    import torch

    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lengths[0] = t
    mask = torch.arange(t)[None, :] >= lengths[:, None]
    if full_pad_row:
        mask[-1] = True
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen) for _ in range(4))
    q = q * d ** -0.5
    return [x.to(dev, dtype) for x in (q, k, v, dout)] + [mask.to(dev)]


def seed_words(gen):
    import torch

    w = torch.randint(0, 2 ** 32, (2,), generator=gen)
    return int(w[0]), int(w[1])


def check_attention_training_kernels(fa, gen, dev, errs):
    """K2 with dropout, K3 and K4 against their plain versions on the same
    keep mask, and K3/K4 at p = 0 against autograd of attention_plain."""
    import torch

    for (b, t, h, d, pad_row) in ((12, 299, 12, 40, False), (4, 130, 2, 40, True)):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v, dout, m = attention_case(gen, b, t, h, d, dtype, dev, pad_row)
            seed = seed_words(gen)
            rows = ~m.all(-1)
            tag = f"{dtype_name} {(b, t, h, d)}"
            keep = fa.keep_mask(b, h, t, ATTN_P, seed, dev)
            rate, sigma = keep.float().mean().item(), (ATTN_P * (1 - ATTN_P) / keep.numel()) ** 0.5
            if abs(rate - (1 - ATTN_P)) > KEEP_SIGMAS * sigma:
                fail(f"keep-rate {rate:.6f} is not within {KEEP_SIGMAS} sigma of {1 - ATTN_P}")
            print(f"  keep mask {tag}: keep-rate {rate:.6f} (1 - p = {1 - ATTN_P}, "
                  f"sigma {sigma:.2e}) ok", flush=True)
            out, lse = fa.flash_attention(q, k, v, m, dropout_p=ATTN_P, seed=seed,
                                          return_lse=True)
            want, want_lse = fa.attention_plain(q, k, v, m, ATTN_P, seed)
            torch.cuda.synchronize()
            e = compare(f"K2 dropout p={ATTN_P} {tag}", out, want, dtype_name, rows)
            compare(f"K2 dropout lse {tag}", lse, want_lse, "float32", rows)
            if dtype_name == "bfloat16" and not pad_row:
                errs[fa.KERNEL_DROPOUT] = e
            for p in (ATTN_P, 0.0):
                s = seed if p else None
                o, l_ = (out, lse) if p else fa.flash_attention(q, k, v, m, return_lse=True)
                got = fa._flash_bwd_cuda(q, k, v, m, o, l_, dout, p, s)
                want = fa.attention_bwd_plain(q, k, v, m, o, l_, dout, p, s)
                refs = [("attention_bwd_plain", want)]
                if p == 0.0:
                    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
                    o_plain, _ = fa.attention_plain(qs, ks, vs, m)
                    refs.append(("autograd of attention_plain",
                                 torch.autograd.grad(o_plain, (qs, ks, vs), dout)))
                torch.cuda.synchronize()
                for ref_name, ref in refs:
                    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
                        e = compare(f"K{3 if gname == 'dq' else 4} {gname} p={p} {tag} vs "
                                    f"{ref_name}", g, r, dtype_name, rows)
                        if dtype_name == "bfloat16" and not pad_row and p and \
                                ref_name == "attention_bwd_plain":
                            key = fa.KERNEL_DQ if gname == "dq" else fa.KERNEL_DKV
                            errs[key] = max(errs.get(key, 0.0), e)
                if not rows.all():
                    if any(g[~rows].abs().max().item() != 0.0 for g in got):
                        fail("a fully padded row must get exactly zero gradients")
                    print(f"  fully padded row: dq = dk = dv = 0 (p={p}) ok", flush=True)


def train_batch(gen, a, b, seconds, ragged):
    """{"x": (A, B, T), "padding_mask": (A, B, T)}: full-length rows, or
    ragged rows (2 s up to the full length) with the last one fabricated as
    all padding, as the data pipeline pads a partial accumulation group."""
    import torch

    t = int(seconds * SR)
    x = torch.randn(a, b, t, generator=gen) * 0.1
    mask = torch.zeros(a, b, t, dtype=torch.bool)
    if ragged:
        lengths = torch.randint(2 * SR, t + 1, (a, b), generator=gen)
        lengths[0, 0] = t
        lengths[-1, -1] = 0
        mask = torch.arange(t)[None, None, :] >= lengths[..., None]
        x = x.masked_fill(mask, 0.0)
    return {"x": x, "padding_mask": mask}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    try:
        from fithubert_tpu_torch.config import fithubert_960h, fithubert_960h_experiment
        from fithubert_tpu_torch.export.expert import UpstreamExpert
        from fithubert_tpu_torch.models.student import StudentModel
        from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
        from fithubert_tpu_torch.train.step import Distiller
        from fithubert_tpu_torch.ops.kernels import SOURCES, _build
        from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
        from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    except ImportError as e:
        fail(f"the fithubert_tpu_torch package is not importable here ({e})")
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device
    smi = smi_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    # ---- 2. build
    t0 = time.time()
    _build.build_all(SOURCES)
    for name in SOURCES:
        _build.load(name)
    print(f"[build] {len(SOURCES)} kernels built and loaded in {time.time() - t0:.1f} s",
          flush=True)

    cfg = fithubert_960h()
    exp = fithubert_960h_experiment()
    geom = TeacherGeometry.from_teacher_config(exp.teacher)
    gen = torch.Generator().manual_seed(0)
    cpu_model = StudentModel(dataclasses.replace(cfg, compute_dtype="float32"),
                             device="cpu").init_weights(gen)
    state = cpu_model.state_dict()
    teacher_cpu = TeacherModel(geom, device="cpu").init_weights(gen)
    errs = {}

    # ---- 3. kernels against their plain versions
    print("[kernels] conv_stack_cuda vs conv_stack_plain: the student's stack at B=4 x "
          "(ragged, up to 16 s), the teacher's at B=12 x (ragged, up to 12 s)", flush=True)
    wavs = ragged_wavs(gen, 3, 2.0, 15.0) + [torch.randn(16 * SR, generator=gen) * 0.1]
    errs["conv"] = check_conv_stack(cpu_model, wavs, dev, "student")
    wavs = ragged_wavs(gen, 11, 2.0, 12.0) + [torch.randn(12 * SR, generator=gen) * 0.1]
    errs["conv_teacher"] = check_conv_stack(teacher_cpu, wavs, dev, "teacher")

    print("[kernels] flash_attention_fwd_cuda vs attention_plain, ragged masks", flush=True)
    teacher_attn = (12, cf.out_len(12 * SR, geom.conv_feature_layers), geom.encoder_attention_heads,
                    geom.encoder_embed_dim // geom.encoder_attention_heads)
    for (b, t, h, d) in ((8, 399, 12, 40), (4, 799, 12, 64), teacher_attn, (2, 130, 2, 40)):
        lengths = torch.randint(t // 2, t + 1, (b,), generator=gen)
        lengths[0] = t
        mask = torch.arange(t)[None, :] >= lengths[:, None]
        if b == 2:
            mask[1] = True  # one fully padded row: kernel gives 0 and lse -1e30
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (torch.randn(b, t, h, d, generator=gen) for _ in range(3))
            q = (q * d ** -0.5).to(dev, dtype)
            k, v, m = k.to(dev, dtype), v.to(dev, dtype), mask.to(dev)
            got, lse = fa.flash_attention(q, k, v, m, return_lse=True)
            want, want_lse = fa.attention_plain(q, k, v, m)
            torch.cuda.synchronize()
            rows = ~m.all(-1)
            tag = f"{dtype_name} {(b, t, h, d)}"
            e = compare(f"flash_attention {tag}", got, want, dtype_name, rows)
            compare(f"flash_attention lse {tag}", lse, want_lse, "float32", rows)
            if not rows.all():
                if got[~rows].abs().max().item() != 0.0 or \
                        (lse[~rows] != fa.NEG_INF).any().item():
                    fail("a fully padded row must give out = 0 and lse = -1e30")
                print("  fully padded row: out = 0, lse = -1e30 ok", flush=True)
            if dtype_name == "bfloat16" and (b, t, h, d) == teacher_attn:
                errs["attn_train"] = e
            elif dtype_name == "bfloat16" and b != 2:
                errs["attn"] = max(errs.get("attn", 0.0), e)

    print(f"[kernels] K2 with dropout p={ATTN_P}, K3 and K4 vs the plain versions on the "
          f"same keep mask, ragged masks", flush=True)
    check_attention_training_kernels(fa, gen, dev, errs)

    # ---- 4. the slice end to end
    print("[e2e] UpstreamExpert(fithubert_960h(), seeded weights), bf16, 3 requests",
          flush=True)
    expert = UpstreamExpert(cfg, state, device="cuda")
    requests = [
        [torch.randn(int(3.7 * SR), generator=gen) * 0.1],
        ragged_wavs(gen, 4, 2.0, 16.0),
        [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(8)],
    ]
    expert(requests[0])  # warm-up: cuBLAS / cuDNN handles
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = []
    for wav_list in requests:
        before = dict(_build.LAUNCHES)
        outs.append(expert(wav_list))
        torch.cuda.synchronize()
        delta = {n: _build.LAUNCHES.get(n, 0) - before.get(n, 0) for n in (cf.KERNEL, fa.KERNEL)}
        if delta[cf.KERNEL] < 1 or delta[fa.KERNEL] < cfg.encoder_layers:
            fail(f"request of {len(wav_list)} did not run through both kernels: {delta}")
    main_path_launches = dict(_build.LAUNCHES)
    for wav_list, out in zip(requests, outs):
        b = len(wav_list)
        t_frames = cf.out_len((max(len(w) for w in wav_list) + SR - 1) // SR * SR,
                              cfg.conv_feature_layers)
        t_red = t_frames // cfg.tr_reduce_factor
        last, hid, pm = out["last_hidden_state"], out["hidden_states"], out["padding_mask"]
        if tuple(last.shape) != (b, t_red * cfg.tr_reduce_factor, cfg.pred_head_final_dim):
            fail(f"last_hidden_state shape {tuple(last.shape)}")
        if len(hid) != cfg.encoder_layers or any(
                tuple(h.shape) != (b, t_red, cfg.encoder_embed_dim) for h in hid):
            fail("hidden_states shapes")
        want_len = torch.tensor([cf.out_len(len(w), cfg.conv_feature_layers) // 2
                                 for w in wav_list])
        if tuple(pm.shape) != (b, t_red) or not torch.equal((~pm).sum(-1).cpu(), want_len):
            fail("padding_mask")
        if not all(torch.isfinite(t).all().item() for t in (last, *hid)):
            fail("non-finite output")
        print(f"  request B={b}: last_hidden_state {tuple(last.shape)} "
              f"hidden_states {len(hid)} x {tuple(hid[0].shape)} frames "
              f"{want_len.tolist()} finite ok", flush=True)
    print(f"  launches on the serving path: {json.dumps(main_path_launches)}", flush=True)

    print("[e2e] fp32 on the card vs fp32 on the CPU (plain versions), 1 x 4 s",
          flush=True)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    wav4 = [torch.randn(4 * SR, generator=gen) * 0.1]
    gpu32 = UpstreamExpert(cfg32, state, device="cuda")(wav4)
    cpu32 = UpstreamExpert(cfg32, state, device="cpu")(wav4)
    worst = 0.0
    for name, g, c in [("last_hidden_state", gpu32["last_hidden_state"],
                        cpu32["last_hidden_state"])] + [
            (f"hidden_states[{i}]", g, c) for i, (g, c) in
            enumerate(zip(gpu32["hidden_states"], cpu32["hidden_states"]))]:
        err = (g.cpu() - c).abs()
        worst = max(worst, err.max().item())
        if not bool((err <= E2E_ATOL + E2E_RTOL * c.abs()).all()):
            fail(f"fp32 card vs CPU: {name} max_abs_err {err.max().item():.3e}")
    print(f"  13 outputs agree: max_abs_err={worst:.3e} "
          f"tol=({E2E_ATOL}, {E2E_RTOL}) ok", flush=True)
    bf16 = expert(wav4)
    fro = max((torch.linalg.vector_norm(b.float() - g) / torch.linalg.vector_norm(g)).item()
              for b, g in zip((bf16["last_hidden_state"], *bf16["hidden_states"]),
                              (gpu32["last_hidden_state"], *gpu32["hidden_states"])))
    if fro > BF16_VS_FP32_FRO:
        fail(f"bf16 forward vs fp32 forward on the card: rel_fro {fro:.3e}")
    print(f"  bf16 vs fp32 on the card: worst rel_fro={fro:.3e} "
          f"tol={BF16_VS_FP32_FRO} ok", flush=True)

    # ---- 5. training end to end
    print("[train] Distiller(fithubert_960h_experiment(), HuBERT-Base teacher, seeded "
          "weights), bf16, dropout 0.1, num_training_steps=20", flush=True)
    t_state = teacher_cpu.state_dict()
    student_cpu = StudentModel(exp.distiller, device="cpu").init_weights(gen)
    s_state = student_cpu.state_dict()
    rand_layers = torch.randperm(exp.distiller.encoder_layers - 1, generator=gen)
    per_step = {
        cf.KERNEL: len(exp.distiller.conv_feature_layers) - 1 + len(geom.conv_feature_layers) - 1,
        fa.KERNEL: geom.encoder_layers, fa.KERNEL_DROPOUT: exp.distiller.encoder_layers,
        fa.KERNEL_DQ: exp.distiller.encoder_layers, fa.KERNEL_DKV: exp.distiller.encoder_layers}
    distiller = Distiller(exp, t_state, s_state, device="cuda", num_training_steps=20)
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size

    train_launches = {}  # the counts of the last checked step

    def step_checked(batch, what):
        _build.reset_launches()
        logs = distiller.train_step(batch, rand_layers)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        if got != per_step:
            fail(f"{what}: launches {got}, want {per_step} per step")
        train_launches.clear()
        train_launches.update(got)
        if not all(math.isfinite(logs[k]) for k in ("loss", "grad_norm")):
            fail(f"{what}: non-finite loss or gradients {logs}")
        return logs

    logs = step_checked(train_batch(gen, a, b, 12.0, ragged=True), "ragged step")
    if not all(torch.isfinite(p).all().item() for p in distiller.params):
        fail("ragged step: non-finite parameters")
    print(f"  step 0 (ragged 3 x 4, one fabricated row, lr {logs['lr']}): loss "
          f"{logs['loss']:.6f} grad_norm {logs['grad_norm']:.6f} finite ok; launches "
          f"{json.dumps(train_launches)} ok", flush=True)
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    losses = []
    for i in range(10):
        logs = step_checked(fixed, f"step {i + 1}")
        losses.append(logs["loss"])
    print(f"  steps 1-10 on one 3 x 4 x 12 s batch: loss {[round(x, 6) for x in losses]}, "
          f"lr {logs['lr']:.3e} at step 10", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 10 steps: {losses}")
    print(f"  loss fell {losses[0]:.6f} -> {losses[-1]:.6f}; every step launched "
          f"{json.dumps(train_launches)} ok", flush=True)

    print("[train] fp32 steps without dropout, card vs CPU (plain versions), full "
          "width, 1 x 2 s: step 0 at lr 0, then two at lr > 0", flush=True)
    exp32 = dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, use_fp16=False),
        distiller=dataclasses.replace(exp.distiller, compute_dtype="float32", dropout=0.0,
                                      attention_dropout=0.0, activation_dropout=0.0,
                                      dropout_input=0.0))
    small = train_batch(gen, 1, 1, 2.0, ragged=False)
    on_card = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20)
    on_cpu = Distiller(exp32, t_state, s_state, device="cpu", num_training_steps=20)
    for i in range(3):
        lg, lc = on_card.train_step(small, rand_layers), on_cpu.train_step(small, rand_layers)
        for key in ("loss", "grad_norm"):
            rel = abs(lg[key] - lc[key]) / abs(lc[key])
            if rel > TRAIN_RTOL:
                fail(f"fp32 step {i}: {key} card {lg[key]} vs CPU {lc[key]} (rel {rel:.3e})")
        print(f"  step {i} (lr {lg['lr']:.3e}): loss {lg['loss']:.8f} vs {lc['loss']:.8f}, "
              f"grad_norm {lg['grad_norm']:.8f} vs {lc['grad_norm']:.8f} "
              f"tol rel {TRAIN_RTOL} ok", flush=True)
    worst = max((pg.detach().cpu() - pc.detach()).abs().max().item()
                for pg, pc in zip(on_card.params, on_cpu.params))
    if worst > TRAIN_PARAM_ATOL:
        fail(f"fp32 step: parameters differ by {worst:.3e} > {TRAIN_PARAM_ATOL}")
    print(f"  parameters after 3 steps: max_abs_err={worst:.3e} tol={TRAIN_PARAM_ATOL} ok",
          flush=True)
    del on_card, on_cpu

    # ---- 6. timing
    print("[timing] B=32 x 16 s, bf16", flush=True)
    bench = [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(32)]
    for _ in range(3):
        expert(bench)
    torch.cuda.synchronize()
    _build.reset_launches()
    expert(bench)
    torch.cuda.synchronize()
    per_fwd = dict(_build.LAUNCHES)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        expert(bench)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(times)
    print(f"  forward: median {fwd_ms:.3f} ms over 10 (min {min(times):.3f}, "
          f"max {max(times):.3f}), {32 * 16 / (fwd_ms / 1e3):.1f} audio-s/s; "
          f"launches per forward {json.dumps(per_fwd)}", flush=True)

    profile_device(lambda: expert(bench), "forward", unprofiled_ms=fwd_ms)

    print("[timing] train step, 3 x 4 x 12 s (144 s of audio), bf16", flush=True)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        distiller.train_step(fixed, rand_layers)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    audio_s = a * b * 12.0
    print(f"  train step: median {step_ms:.3f} ms over 10 (min {min(times):.3f}, "
          f"max {max(times):.3f}), {1e3 / step_ms:.3f} steps/s, "
          f"{audio_s / (step_ms / 1e3):.1f} audio-s/s", flush=True)
    profile_device(lambda: distiller.train_step(fixed, rand_layers), "train step", top=30,
                   unprofiled_ms=step_ms)

    # One row per kernel and path. "launches" is the count the path's run
    # made: over the three serving requests, or in the last checked train
    # step. Each row is timed at that path's shape.
    print("[timing] kernels against their bounds, plain versions and library calls",
          flush=True)
    kernels = []

    def row(name, src, replaces, path, shape, err, ms, plain_ms, work, library_ms):
        b_ms, b_by = bound(*work, BF16_PEAK)
        launches = (main_path_launches if path == "serving" else train_launches).get(name, 0)
        kernels.append(dict(
            name=name, route="cuda", source=f"fithubert_tpu_torch/csrc/{src}",
            replaces=f"fithubert_tpu/ops/pallas/{replaces}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, path=path, shape=shape))

    def attention_qkv(b, t, h, d, n=3):
        x = [torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16) for _ in range(n)]
        x[0] = x[0] * d ** -0.5
        return x + [torch.zeros(b, t, dtype=torch.bool, device=dev)]

    def sdpa(q, k, v, mask, p=0.0):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=~mask[:, None, None, :], dropout_p=p, scale=1.0)

    def attention_fwd_times(q, k, v, mask, p=0.0, seed=None):
        with torch.no_grad():
            return (cuda_ms(lambda: fa.flash_attention(q, k, v, mask, dropout_p=p, seed=seed),
                            reps=50),
                    cuda_ms(lambda: fa.attention_plain(q, k, v, mask, p, seed), reps=10),
                    attn_work(q, mask), cuda_ms(lambda: sdpa(q, k, v, mask, p), reps=50))

    # serving: K1 and K2 at B = 32 x 16 s
    c_ms, c_plain, c_lib, c_work = conv_times(cpu_model, bench, dev)
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "serving",
        f"B=32 x 16 s, {stack_shape(cpu_model, bench)}", errs["conv"], c_ms, c_plain,
        c_work, c_lib)
    t_att = cf.out_len(16 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    h, d = cfg.encoder_attention_heads, cfg.encoder_embed_dim // cfg.encoder_attention_heads
    q, k, v, mask = attention_qkv(32, t_att, h, d)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "serving",
        f"{tuple(q.shape)}", errs["attn"], a_ms, a_plain, a_work, a_lib)
    del q, k, v, mask

    # train: K1 over the student's and the teacher's stacks of one step
    step_wavs = list(fixed["x"].reshape(-1, fixed["x"].shape[-1]))
    (s_ms, s_plain, s_lib, s_work), (t_ms, t_plain, t_lib, t_work) = (
        conv_times(m, step_wavs, dev) for m in (student_cpu, teacher_cpu))
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "train",
        f"student {stack_shape(student_cpu, step_wavs)} + teacher "
        f"{stack_shape(teacher_cpu, step_wavs)}", max(errs["conv"], errs["conv_teacher"]),
        s_ms + t_ms, s_plain + t_plain, (s_work[0] + t_work[0], s_work[1] + t_work[1]),
        s_lib + t_lib)

    # train: K2 at p = 0, the teacher's attention, (12, 599, 12, 64)
    q, k, v, mask = attention_qkv(*teacher_attn)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "train",
        f"teacher {tuple(q.shape)}", errs["attn_train"], a_ms, a_plain, a_work, a_lib)
    del q, k, v, mask

    # train: the student's attention, (12, 299, 12, 40), p = 0.1: K2, K3, K4
    t_att = cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    q, k, v, dout, mask = attention_qkv(a * b, t_att, h, d, n=4)
    seed = seed_words(gen)
    shape = f"student {tuple(q.shape)}, p={ATTN_P}"
    f_ms, f_plain, f_work, f_lib = attention_fwd_times(q, k, v, mask, ATTN_P, seed)
    row(fa.KERNEL_DROPOUT, "flash_attention.cu", "flash_attention.py:243 (dropout branch "
        ":100-106)", "train", shape, errs[fa.KERNEL_DROPOUT], f_ms, f_plain, f_work, f_lib)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, mask, dropout_p=ATTN_P, seed=seed,
                                      return_lse=True)
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        dq_ms = cuda_ms(lambda: fa.bwd_dq_cuda(q, k, v, mask, lse, dout, delta, ATTN_P, seed),
                        reps=50)
        dkv_ms = cuda_ms(lambda: fa.bwd_dkv_cuda(q, k, v, mask, lse, dout, delta, ATTN_P,
                                                 seed), reps=50)
        bwd_plain = cuda_ms(lambda: fa.attention_bwd_plain(
            q, k, v, mask, out, lse, dout, ATTN_P, seed), reps=10)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o_lib = sdpa(qs, ks, vs, mask, ATTN_P)
    do_lib = dout.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do_lib,
                                                  retain_graph=True), reps=50)
    row(fa.KERNEL_DQ, "flash_attention_bwd.cu", "flash_attention.py:304", "train", shape,
        errs[fa.KERNEL_DQ], dq_ms, bwd_plain, attn_bwd_work(q, mask, 1), lib_bwd)
    row(fa.KERNEL_DKV, "flash_attention_bwd.cu", "flash_attention.py:323", "train", shape,
        errs[fa.KERNEL_DKV], dkv_ms, bwd_plain, attn_bwd_work(q, mask, 2), lib_bwd)
    for kd in kernels:
        print(f"  {kd['name']} ({kd['path']}, {kd['shape']}): {kd['ms']:.4f} ms (bound "
              f"{kd['bound_ms']:.4f} ms by {kd['bound_by']}, plain {kd['plain_ms']:.4f}, "
              f"library {kd['library_ms']:.4f}), {kd['launches']} launches "
              f"{'over the 3 serving requests' if kd['path'] == 'serving' else 'per train step'}",
              flush=True)

    # ---- 7. result lines
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
