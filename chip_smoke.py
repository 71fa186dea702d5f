#!/usr/bin/env python3
"""Build and drive the PyTorch port (fithubert_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own line(s) and any failed check ending the
run with a non-zero exit and no final line:

  1. device: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel of csrc/, one nvcc each, all at once, and each
     kernel's registers and spills as ptxas reports them;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes, bf16 and fp32 (TF32 off), ragged inputs: the
     conv stack (K1) of the student (C0 = 128) and of the teacher (C0 =
     512) with its bf16 GroupNorm prefix kernel, the attention forward
     (K2) at the serving and the teacher's shapes and with dropout on the
     same keep mask, the attention
     backward (K3 dQ, K4 dK/dV), the seeded dropout (K5), the conv-stack
     backward (K6, and its dW bit for bit across two calls), and K6's up
     pass against K1's output bit for bit;
  4. serving end to end: UpstreamExpert at FitHuBERT-960h width (seeded
     weights) serves three ragged requests in bf16, through K1 and K2
     (launch counters are zeroed just before and read just after); then the
     same weights in fp32 on the card against the CPU's plain versions;
  5. training end to end: the Distiller of configs/fithubert.yaml (HuBERT-
     Base teacher, FitHuBERT-960h student, seeded weights, bf16, dropout
     0.1), FITHUBERT_CONV_BWD unset, takes a ragged 3 x 4 step with a
     fabricated row, then 10 steps on one 3 x 4 x 12 s batch; every step
     goes through K1, K2 (teacher p = 0, student p = 0.1), K3, K4 and the
     conv stack's backward K6 (32 launches), and the loss falls; then fp32
     steps without dropout on the card against the CPU's plain versions;
  6. train-library: the same step with FITHUBERT_CONV_BWD=xla, whose conv
     stack backward is the library recompute (autograd through F.conv1d):
     one ragged step's conv-front-end gradients against the same step
     through K6, then 3 steps, each with phase 5's launches but no K6;
  7. train-taps: the release config with the attention-transfer losses
     (attn kldiv 1.0, v_rel 1.0): the last layer returns its taps, the
     student's probabilities go through K5, the step loops over its 4
     microbatches of 3 rows; a ragged step with a fabricated row, then 3
     steps, with every launch count checked (K6 once per microbatch); then
     fp32 steps without dropout on the card against the CPU;
  8. timing: serving at B = 32 x 16 s and the train step at 3 x 4 x 12 s,
     with a profile of each, the steps of paths 6 and 7, and every kernel
     against its bound, its plain version and the library call, one row per
     kernel and path at that path's shapes, with the launches that path's
     run counted; on text lines K1's per-layer floor, each K1 layer's time
     beside its own floor, each K6 launch's time beside its own floor, and
     the goals: K2's, K3's and K4's times as multiples of SDPA's, K1's (the
     conv_stack call with its prefix) and K6's in ms;
  9. a JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

SR = 16000
# H100 SXM data sheet: bf16 tensor cores, fp32 outside the tensor cores, HBM3
BF16_PEAK, FP32_PEAK, HBM_BPS = 989e12, 67e12, 3.35e12
# torch.cuda._sleep spins for a count of SM cycles; the H100 SXM clocks at
# most 1.98 GHz, so 2e6 cycles last at least a millisecond.
SLEEP_CYCLES_PER_MS = 2e6

# Tolerances. Elementwise, |kernel - plain| <= ATOL + RTOL * |plain|:
#   fp32: only the summation order differs (kernel tiles vs cuDNN / einsum);
#   bf16 attention: both sides sum in fp32 from the same bf16 inputs; the
#   plain version rounds once, the kernels (K2, K4) also round P, and K4 dS,
#   to bf16 before the second product, as the TPU kernels do. Those roundings
#   (2^-9 relative each) average out over the key sum, so the two stay within
#   about one bf16 step of the output (2^-8 relative): 1e-2 + 1e-2 holds
#   with room (worst 7.8e-3 on gradients up to 1.8 on an H100).
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
# The attention backward (K3, K4) against attention_bwd_plain: the same
# formulas from the same bf16 inputs (q, k, v, dO, lse, delta): TOL above.
# K4 rounds dS to bf16 once, as the TPU kernel does; K3 feeds dS K with dS
# in two bf16 parts (~16 bits), since one rounding times the unscaled K
# moves dQ past TOL where a row has few valid keys. Against autograd of
# attention_plain (p = 0), whose implicit delta uses the unrounded fp32
# output where the kernels read O in bf16: that rounding (2^-9 of
# |dO . O|) moves dS by a few bf16 steps, within TOL.
# The fp32 train step, card vs CPU, full width, no dropout: the loss and
# grad_norm through 24 layers and a backward agree to summation order
# (relative TRAIN_RTOL); AdamW normalises each update to about lr, so
# parameters after a step agree to a small fraction of lr (TRAIN_PARAM_ATOL
# = 5% of the release lr) unless a gradient sits at eps.
TRAIN_RTOL, TRAIN_PARAM_ATOL = 1e-3, 2.5e-5
# The dropout keep-rate over a (B, H, T, T) mask: within 4 binomial sigmas.
KEEP_SIGMAS = 4.0
ATTN_P = 0.1  # attention_dropout of configs/fithubert.yaml
# K6 against its plain version, norm-wise (||kernel - plain|| / ||plain||)
# for da0 and every dW: fp32 sums the same products in another order (dW
# over 460788 frames); in bf16 that order can flip the rounding of z or dz
# by one bf16 step, which moves a gradient well below 1e-2 of its norm.
K6_LIMIT = {"float32": 1e-4, "bfloat16": 1e-2}
# K6 against the library recompute (autograd through F.conv1d), bf16,
# norm-wise: the library rounds each layer's cotangent to bf16 where K6
# keeps it fp32; the JAX package's own bf16 limit for the kernel against
# its oracle (tests/test_conv_frontend_bwd.py:155-157).
K6_VS_LIBRARY = 5e-2
# The tap losses on the release config (the values of tests/test_losses.py:171-172).
TAP_LOSS = dict(attn_loss_weight=1.0, attn_loss_type="kldiv", v_rel_loss_weight=1.0)


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


def normwise(name, got, want, limit):
    """Fail unless got is finite and ||got - want|| <= limit * ||want||."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    fro = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
    max_abs = (g - w).abs().max().item()
    ok = fro <= limit
    print(f"  {name}: rel_fro={fro:.3e} max_abs_err={max_abs:.3e} "
          f"max|ref|={w.abs().max().item():.3e} limit={limit} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees")
    return max_abs


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of fn over reps launches, from CUDA events. A sleep
    kernel first holds the stream for twice the host's time to queue the
    reps calls, so the events time the device's back-to-back work, not the
    host's Python and launch overhead (which exceeds a short kernel's run)."""
    import torch

    enqueue_ms = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3  # the last, warm call's
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * enqueue_ms, 500.0) * SLEEP_CYCLES_PER_MS))
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
    alone given the plain version's input; the bf16 prefix kernel against
    ``_prefix``. Returns the bf16 max abs errors (whole stack, prefix)."""
    import torch

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    spec = model.feature_extractor.spec[1:]
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x, ws, scale, shift = stack_inputs(model, wavs, dtype, dev)
        if dtype_name == "bfloat16":
            with torch.no_grad():
                got, want = cf.gn_prefix_cuda(x, scale, shift), cf._prefix(x, scale, shift)
            torch.cuda.synchronize()
            prefix_err = compare(f"gn_prefix_cuda {who} {tuple(x.shape)}", got, want, dtype_name)
            del got, want
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
    return worst, prefix_err


def conv_times(model, wavs, dev, who):
    """Times of the bf16 conv stack on ``model``'s block-0 features of
    ``wavs``: {"k1": K1's launches from a0 = the prefix's output (kernel ms,
    plain ms, (flops, bytes), library ms), "prefix": the prefix kernel's
    (the same, no library call), "call_ms": the conv_stack call, prefix
    included, "floor_ms": the stack's per-layer floor}. K1's library call
    is a cuDNN conv1d + GELU per layer. Prints each layer's time alone (on
    the output of the layer below) beside its floor, and the stack's
    per-layer floor."""
    import torch
    import torch.nn.functional as F

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    spec = model.feature_extractor.spec[1:]
    x, ws, scale, shift = stack_inputs(model, wavs, torch.bfloat16, dev)
    wl = [w.permute(2, 1, 0).contiguous() for w in ws]  # torch (C_out, C_in, k) layout

    with torch.no_grad():
        a0 = cf.gn_prefix_cuda(x, scale, shift)

        def library():
            h = a0.transpose(1, 2)
            for w, (_d, _k, s) in zip(wl, spec):
                h = F.gelu(F.conv1d(h, w, stride=s), approximate="tanh")
            return h

        h, layer_ms = a0, []
        for w, layer in zip(ws, spec):
            layer_ms.append(cuda_ms(lambda: cf.conv_stack(h, [w], (layer,)), reps=10))
            h = cf.conv_stack(h, [w], (layer,))
        del h
        floors = conv_layer_floors(a0, spec)
        print(f"  K1 layers, {who} {tuple(x.shape)}, ms (floor): " + ", ".join(
            f"{layer} {ms:.4f} ({fl:.4f})" for layer, ms, fl in zip(spec, layer_ms, floors))
            + f"; per-layer floor of the stack {sum(floors):.4f} ms", flush=True)
        out = {
            "k1": (cuda_ms(lambda: cf.conv_stack(a0, ws, spec), reps=10),
                   cuda_ms(lambda: cf.conv_stack_plain(a0, ws, spec), reps=10),
                   conv_work(a0, spec), cuda_ms(library, reps=10)),
            "prefix": (cuda_ms(lambda: cf.gn_prefix_cuda(x, scale, shift), reps=10),
                       cuda_ms(lambda: cf._prefix(x, scale, shift), reps=10),
                       prefix_work(x), None),
            "call_ms": cuda_ms(lambda: cf.conv_stack(x, ws, spec, scale, shift), reps=10),
            "floor_ms": sum(floors)}
    print(f"  prefix kernel, {who} {tuple(x.shape)}: {out['prefix'][0]:.4f} ms (bound "
          f"{bound(*prefix_work(x), FP32_PEAK)[0]:.4f}); the conv_stack call with it "
          f"{out['call_ms']:.4f} ms", flush=True)
    return out


def stack_shape(model, wavs):
    """The (B, T, C0) input that conv_stack gets for the padded batch of wavs."""
    from fithubert_tpu_torch.export.expert import quantize_length

    d0, k0, s0 = model.feature_extractor.spec[0]
    t_pad = quantize_length(max(len(w) for w in wavs), SR)
    return (len(wavs), (t_pad - k0) // s0 + 1, d0)


def conv_work(x, spec):
    """(flops, bytes) the conv stack from x needs: inputs read once, output once."""
    b, t, c = x.shape
    flops, bytes_ = 0, x.numel() * x.element_size()
    for (d, k, s) in spec:
        t_out = (t - k) // s + 1
        flops += 2 * b * t_out * d * k * c
        bytes_ += k * c * d * x.element_size()
        t, c = t_out, d
    return flops, bytes_ + b * t * c * x.element_size()


def prefix_work(x):
    """(flops, bytes) of the GroupNorm + GELU prefix of x (B, T, C): x, scale
    and shift read once, a0 written once; ten fp32 operations per element
    (the affine map's multiply-add, the tanh GELU's polynomial, exponential,
    add, divide and multiply)."""
    b, _t, c = x.shape
    return 10 * x.numel(), (2 * x.numel() + 2 * b * c) * x.element_size()


def conv_layer_floors(x, spec):
    """The least time of each layer run alone, as K1 runs the stack:
    max(operations / bf16 peak, bytes / HBM rate), the layer reading its
    input and weights once and writing its output once (the whole-stack
    bound of conv_work reads and writes each only at the ends)."""
    b, t, c = x.shape
    el = x.element_size()
    floors = []
    for (d, k, s) in spec:
        t_out = (t - k) // s + 1
        flops = 2 * b * t_out * d * k * c
        bytes_ = (b * t * c + k * c * d + b * t_out * d) * el
        floors.append(bound(flops, bytes_, BF16_PEAK)[0])
        t, c = t_out, d
    return floors


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


def check_seeded_dropout(kd, shape, gen, dev):
    """K5 against seeded_dropout_plain at ``shape``, fp32 and bf16:
    bit-identical forward and backward, and the keep-rate within 4 sigma."""
    import torch

    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = torch.rand(shape, generator=gen).to(dev, dtype).requires_grad_()
        cot = torch.randn(shape, generator=gen).to(dev, dtype)
        seed = seed_words(gen)
        y = kd.seeded_dropout(x, seed, ATTN_P)
        (dx,) = torch.autograd.grad(y, x, cot)
        want = (kd.seeded_dropout_plain(x.detach(), seed, ATTN_P),
                kd.seeded_dropout_plain(cot, seed, ATTN_P))
        torch.cuda.synchronize()
        for what, got, ref in zip(("forward", "backward"), (y, dx), want):
            if not torch.equal(got, ref):
                err = (got.float() - ref.float()).abs().max().item()
                fail(f"K5 {what} {dtype_name}: max_abs_err {err:.3e}, want bit-identical")
        keep = kd.keep_flat(x.numel(), ATTN_P, seed, dev)
        rate = keep.float().mean().item()
        sigma = (ATTN_P * (1 - ATTN_P) / keep.numel()) ** 0.5
        if abs(rate - (1 - ATTN_P)) > KEEP_SIGMAS * sigma:
            fail(f"K5 keep-rate {rate:.6f} is not within {KEEP_SIGMAS} sigma of {1 - ATTN_P}")
        print(f"  K5 {dtype_name} {shape}: forward and backward bit-identical to "
              f"seeded_dropout_plain, keep-rate {rate:.6f} (sigma {sigma:.2e}) ok", flush=True)


def check_conv_backward(cf, model, wavs, gen, dev):
    """K6 against conv_stack_bwd_plain on ``model``'s stack at the input its
    extractor gives for ``wavs`` (the GroupNorm prefix applied), bf16 and
    fp32, and against the library recompute in bf16. Returns the bf16 max
    abs error against the plain version."""
    import torch

    spec = model.feature_extractor.spec[1:]
    worst = 0.0
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x, ws, scale, shift = stack_inputs(model, wavs, dtype, dev)
        with torch.no_grad():
            a0 = cf._prefix(x, scale, shift)
        del x
        g = torch.randn((a0.shape[0], cf.out_len(a0.shape[1], spec), spec[-1][0]),
                        generator=gen).to(dev, dtype)
        got = cf.conv_stack_bwd_cuda(a0, ws, g, spec)
        again = cf.conv_stack_bwd_cuda(a0, ws, g, spec)
        want = cf.conv_stack_bwd_plain(a0, ws, g, spec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip([got[0], *got[1]], [again[0], *again[1]])):
            fail(f"K6 {dtype_name}: two calls on the same inputs differ")
        print(f"  K6 {dtype_name}: da0 and every dW bit-identical across two calls ok", flush=True)
        del again
        names = ["da0"] + [f"dW{i}" for i in range(len(spec))]
        tag = f"{dtype_name} a0 {tuple(a0.shape)}"
        for name, gg, ww in zip(names, [got[0], *got[1]], [want[0], *want[1]]):
            e = normwise(f"K6 {name} {tag} vs conv_stack_bwd_plain", gg, ww,
                         K6_LIMIT[dtype_name])
            if dtype_name == "bfloat16":
                worst = max(worst, e)
        del want
        if dtype_name == "bfloat16":
            leaves = [t.detach().requires_grad_() for t in [a0, *ws]]
            lib = torch.autograd.grad(cf.conv_stack_plain(leaves[0], leaves[1:], spec), leaves, g)
            for name, gg, ww in zip(names, [got[0], *got[1]], lib):
                normwise(f"K6 {name} {tag} vs the library recompute", gg, ww, K6_VS_LIBRARY)
            del lib, leaves
        del got, a0, g
    return worst


def check_up_pass(cf, model, wavs, dev):
    """K6's up pass against K1 on each bf16 layer of ``model``'s stack, each
    given K1's output of the layer below: a_next must equal K1's y bit for
    bit, since both are the same GEMM launch on the same tile geometry."""
    import torch

    spec = model.feature_extractor.spec[1:]
    x, ws, scale, shift = stack_inputs(model, wavs, torch.bfloat16, dev)
    with torch.no_grad():
        h = cf._prefix(x, scale, shift)
        del x
        for i, (w, layer) in enumerate(zip(ws, spec)):
            y = cf.conv_stack(h, [w], (layer,))
            _z, a_next = cf.up_pass_cuda(h, w, layer)
            torch.cuda.synchronize()
            if not torch.equal(a_next, y):
                err = (a_next.float() - y.float()).abs().max().item()
                fail(f"K6 up pass layer {i} {layer}: max_abs_err {err:.3e}, want bit-identical")
            h = y
    print(f"  {len(spec)} layers from a0 {stack_shape(model, wavs)}: a_next == K1's y bit for "
          f"bit ok", flush=True)


def conv_bwd_work(a0, spec):
    """(flops, bytes) of the conv stack's backward from a0: the recompute,
    dW and da are each as large as the forward's products; a0, the weights
    and the output gradient are read once, da0 and every dW written once
    in fp32."""
    el = a0.element_size()
    flops, _ = conv_work(a0, spec)
    b, t, c = a0.shape
    bytes_ = a0.numel() * (el + 4)
    for (d, k, s) in spec:
        bytes_ += k * c * d * (el + 4)
        t, c = (t - k) // s + 1, d
    return 3 * flops, bytes_ + b * t * c * el


def k6_breakdown(cf, a0, ws, g, spec):
    """Each K6 launch at a0, in the order conv_stack_bwd_cuda runs them,
    timed alone on its own inputs beside its own floor, max(operations /
    peak, bytes / HBM rate), the launch reading each input once and writing
    each output once. Prints one line per layer; returns (the launches'
    summed time, the sum of their floors)."""
    import torch

    el = a0.element_size()
    b = a0.shape[0]
    wts = [w.permute(2, 0, 1).contiguous() for w in ws]
    wks = [w.contiguous() for w in ws]
    g32 = g.float().contiguous()
    times, floors = {}, {}

    def timed(key, fn, flops, bytes_, peak=BF16_PEAK):
        times[key] = cuda_ms(fn, reps=10)
        floors[key] = bound(flops, bytes_, peak)[0]
        return fn()

    with torch.no_grad():
        a_store, z_store, shapes = [a0.contiguous()], [], []
        for i, (d, k, s) in enumerate(spec):
            a = a_store[-1]
            _b, t_in, c_in = a.shape
            t_out = (t_in - k) // s + 1
            shapes.append((t_in, c_in, t_out))
            flops = 2 * b * t_out * d * k * c_in
            last = i == len(spec) - 1
            out_bytes = b * t_out * d * ((4 + el) if last else 2 * el)  # g in, dz out; or z, a
            res = timed(("up", i), lambda: cf.up_cuda(a, wts[i], spec[i], g32 if last else None),
                        flops, (a.numel() + wks[i].numel()) * el + out_bytes)
            if last:
                dz = res
            else:
                z_store.append(res[0])
                a_store.append(res[1])
        for i in reversed(range(len(spec))):
            d, k, s = spec[i]
            t_in, c_in, t_out = shapes[i]
            a = a_store[i]
            flops = 2 * b * t_out * d * k * c_in
            part = cf.dw_partials_cuda(a, dz, spec[i])
            timed(("dW", i), lambda: cf.dw_partials_cuda(a, dz, spec[i]), flops,
                  (a.numel() + dz.numel()) * el + part.numel() * 4)
            timed(("reduce", i), lambda: cf.dw_reduce_cuda(part, spec[i]), part.numel(),
                  part.numel() * 4 + part[0].numel() * 4, FP32_PEAK)
            z_prev = z_store[i - 1] if i > 0 else None
            out_bytes = 2 * b * t_in * c_in * el if i > 0 else b * t_in * c_in * 4
            dz = timed(("da", i), lambda: cf.da_cuda(dz, wks[i], spec[i], t_in, z_prev), flops,
                       (dz.numel() + wks[i].numel()) * el + out_bytes)
    for i, layer in enumerate(spec):
        print(f"  K6 layer {i} {layer}, ms (floor): " + ", ".join(
            f"{kind} {times[(kind, i)]:.4f} ({floors[(kind, i)]:.4f})"
            for kind in ("up", "dW", "reduce", "da")), flush=True)
    by_kind = {kind: (sum(t for (k_, _), t in times.items() if k_ == kind),
                      sum(f for (k_, _), f in floors.items() if k_ == kind))
               for kind in ("up", "dW", "reduce", "da")}
    print("  K6 by launch kind, ms (floor): " + ", ".join(
        f"{kind} {t:.4f} ({f:.4f})" for kind, (t, f) in by_kind.items()), flush=True)
    return sum(times.values()), sum(floors.values())


@contextlib.contextmanager
def conv_backward(mode):
    """FITHUBERT_CONV_BWD=mode while the block runs: "xla" sends the conv
    stack's backward through the library recompute; None (unset) through K6,
    the card's default."""
    old = os.environ.get("FITHUBERT_CONV_BWD")
    if mode is None:
        os.environ.pop("FITHUBERT_CONV_BWD", None)
    else:
        os.environ["FITHUBERT_CONV_BWD"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FITHUBERT_CONV_BWD", None)
        else:
            os.environ["FITHUBERT_CONV_BWD"] = old


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


# The loop's resumed steps hold the uninterrupted run's logged loss,
# grad_norm and lr bit for bit. The state at the resume point is restored
# exactly; the resumed epoch redraws its 11 distill layers fresh, as the JAX
# loop does, which with distil_random_layer 11 over 11 layers is the same
# set in another order, and the loss then takes the layers in layer order
# (losses.py skips the gather as a permutation), so the draw's order enters
# only the per-slot logs rand_l<i>. The step's own kernels use no atomics
# (K6 is bit for bit across calls), and its library calls gave the same
# bits in every run of this script on the card. A lost
# optimizer state moves step 4 (the first update that reads the restored
# moments); a lost step moves step 3's dropout masks and lr.
LOOP_RESUME_KEYS = ("loss", "grad_norm", "lr")
# The loop's rate: a run of this many 2-step epochs, logging (and so
# holding a device barrier) every LOOP_RATE_LOG_EVERY steps.
LOOP_RATE_EPOCHS = 10
LOOP_RATE_LOG_EVERY = 10


def write_wav16(path, wav):
    """A 16 kHz mono 16-bit PCM WAV (stdlib wave)."""
    import wave

    import numpy as np

    pcm = np.clip(np.round(wav.numpy() * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def write_corpus(root, gen, counts):
    """A LibriSpeech-shaped tree of WAVs, ragged 2-12 s:
    <root>/<split>/<spk>/<chap>/<spk>-<chap>-<utt>.wav."""
    import torch

    for split, n in counts.items():
        for u in range(n):
            spk, chap = 100 + u % 3, 7
            d = os.path.join(root, split, str(spk), str(chap))
            os.makedirs(d, exist_ok=True)
            seconds = 2.0 + 10.0 * torch.rand((), generator=gen).item()
            wav = torch.randn(int(seconds * SR), generator=gen) * 0.1
            write_wav16(os.path.join(d, f"{spk}-{chap}-{u:04d}.wav"), wav)


def logged(run_dir):
    """Train records of <run_dir>/metrics.jsonl by step, and the val ones."""
    train, val = {}, []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for rec in map(json.loads, f):
            if "loss" in rec:
                train[rec["step"]] = rec
            elif "val/v_loss" in rec:
                val.append(rec)
    return train, val


def fairseq_cfg(geom):
    """The fairseq model config of a teacher of ``geom``, as a checkpoint's
    cfg carries it."""
    return {"_name": geom.model_type, "extractor_mode": geom.extractor_mode,
            "conv_feature_layers": str(list(geom.conv_feature_layers)),
            "encoder_layers": geom.encoder_layers, "encoder_embed_dim": geom.encoder_embed_dim,
            "encoder_ffn_embed_dim": geom.encoder_ffn_embed_dim,
            "encoder_attention_heads": geom.encoder_attention_heads,
            "activation_fn": geom.activation_fn, "layer_norm_first": geom.layer_norm_first,
            "conv_pos": geom.conv_pos, "conv_pos_groups": geom.conv_pos_groups}


def loop_phase(exp, geom, teacher_cpu, per_step, per_eval, smi):
    """The training loop end to end on ``exp``: a fairseq HuBERT .pt written
    from ``teacher_cpu``'s weights, a WAV corpus decoded by the native
    decoder, three runs (1 epoch; resumed to 2; 2 from scratch), the
    launches of every step (``per_step``) and eval batch (``per_eval``), the
    export served against the student's own forward, and a 20-step run at
    the default logging cadence for the loop's rates."""
    import tempfile

    import torch

    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.export.fairseq_import import load_fairseq_teacher
    from fithubert_tpu_torch.data.librispeech import quantize_length
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.checkpoint import CheckpointManager
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.step import Distiller

    gen = torch.Generator().manual_seed(7)
    e = geom.encoder_embed_dim
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        pt = os.path.join(tmp, "hubert_base_seeded.pt")
        # HuBERT's pretraining heads ride along, as in a released checkpoint
        sd = dict(teacher_cpu.state_dict(), label_embs_concat=torch.randn(504, 256, generator=gen),
                  mask_emb=torch.randn(e, generator=gen),
                  **{"final_proj.weight": torch.randn(256, e, generator=gen),
                     "final_proj.bias": torch.zeros(256)})
        torch.save({"model": sd, "cfg": {"model": fairseq_cfg(geom)}}, pt)
        loaded_geom, _ = load_fairseq_teacher(pt)
        if loaded_geom != geom:
            fail(f"the fairseq teacher's geometry {loaded_geom} is not HuBERT-Base's {geom}")
        libri = os.path.join(tmp, "LibriSpeech")
        write_corpus(libri, gen, {"train-clean-100": 24, "dev-clean": 6})
        print(f"  wrote a fairseq HuBERT .pt ({os.path.getsize(pt) / 2 ** 20:.0f} MiB, "
              f"geometry read back ok) and 24 + 6 WAVs of 2-12 s", flush=True)

        def config(run, epochs, log_every):
            return dataclasses.replace(
                exp, teacher=dataclasses.replace(exp.teacher, teacher_model=pt),
                data=dataclasses.replace(exp.data, libri_root=libri,
                                         bucketing_path=os.path.join(tmp, "len_for_bucket"),
                                         train_set=("train-clean-100",),
                                         dev_set=("dev-clean",)),
                train=dataclasses.replace(exp.train, output_dir=os.path.join(tmp, run),
                                          num_epochs=epochs, log_every=log_every))

        step_launches = []
        pauses = []  # (what, seconds) of each eval batch and checkpoint write
        plain_step = Distiller.train_step_async
        plain_eval = Distiller.eval_step
        plain_save = CheckpointManager.save

        def counted_step(self, batch, rand):
            before = dict(_build.LAUNCHES)
            out = plain_step(self, batch, rand)
            step_launches.append({n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
                                  if c != before.get(n, 0)})
            return out

        def timed(what, fn):
            # the queued steps finish first, so their time is not the pause's
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                pauses.append((what, time.perf_counter() - t0))
                return out
            return wrapper

        def run(name, run_dir, epochs, resume, want_steps, n_steps, n_evals, log_every=1):
            step_launches.clear()
            pauses.clear()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            Distiller.train_step_async = counted_step
            Distiller.eval_step = timed("eval", plain_eval)
            CheckpointManager.save = timed("save", plain_save)
            _build.reset_launches()
            t0 = time.perf_counter()
            try:
                result = run_training(config(run_dir, epochs, log_every), resume=resume,
                                      device="cuda")
            finally:
                Distiller.train_step_async = plain_step
                Distiller.eval_step = plain_eval
                CheckpointManager.save = plain_save
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            if result["steps"] != want_steps or result["preempted"]:
                fail(f"loop {name}: {result}, want {want_steps} steps")
            if len(step_launches) != n_steps or any(d != per_step for d in step_launches):
                fail(f"loop {name}: launches per step {step_launches}, want {per_step}")
            want_total = {n: len(step_launches) * per_step.get(n, 0) + 2 * n_evals * per_eval.get(
                n, 0) for n in set(per_step) | set(per_eval)}
            if total != want_total:
                fail(f"loop {name}: launches {total}, want {want_total} ({len(step_launches)} "
                     f"steps, {n_evals} evals of 2 batches)")
            train, val = logged(os.path.join(tmp, run_dir))
            values = [v for rec in train.values() for k, v in rec.items()
                      if k not in ("step", "time")] + [r["val/v_loss"] for r in val]
            if not all(math.isfinite(v) for v in values):
                fail(f"loop {name}: a logged value is not finite")
            last = max(train)
            timed_steps = last - (want_steps - n_steps) - 1  # the first step anchors the clock
            print(f"  {name}: {result['steps']} steps, {len(step_launches)} in this run, each "
                  f"launching {json.dumps(per_step)}; {n_evals} eval(s) of 2 batches; all "
                  f"launches {json.dumps(total)} ok; losses "
                  f"{[round(train[s]['loss'], 6) for s in sorted(train)]}, val v_loss "
                  f"{[round(r['val/v_loss'], 6) for r in val]} finite; StepTimer at step "
                  f"{last} over {timed_steps} timed step(s), a barrier every {log_every}: "
                  f"{train[last]['steps_per_sec']:.3f} steps/s, "
                  f"{train[last]['audio_sec_per_sec']:.1f} audio-s/s; wall {wall:.1f} s; peak "
                  f"memory {peak / 2 ** 30:.2f} GiB ({resident / 2 ** 30:.2f} GiB resident "
                  f"before); {smi}", flush=True)
            return train, timed_steps

        print("[loop] run 1: 1 epoch (2 steps of 3 x 4), eval, best/ + last/, export",
              flush=True)
        run("run 1", "resumed", 1, True, 2, 2, 1)
        ckpt = os.path.join(tmp, "resumed", "ckpt")
        for sub, want in (("best", {"index.json", "step_2.pt"}), ("last", {"step_2.pt"})):
            if set(os.listdir(os.path.join(ckpt, sub))) != want:
                fail(f"loop run 1: {sub}/ holds {os.listdir(os.path.join(ckpt, sub))}")
        for name in ("student.yaml", "student.pt", "config.yaml"):
            if not os.path.exists(os.path.join(tmp, "resumed", name)):
                fail(f"loop run 1: {name} was not written")
        print("[loop] run 2: resumed to 2 epochs", flush=True)
        resumed, _ = run("run 2", "resumed", 2, True, 4, 2, 1)
        print("[loop] run 3: 2 epochs from scratch", flush=True)
        straight, _ = run("run 3", "straight", 2, False, 4, 4, 2)
        for s in (1, 2, 3, 4):
            for key in LOOP_RESUME_KEYS:
                if resumed[s][key] != straight[s][key]:
                    fail(f"loop: step {s} {key} {resumed[s][key]!r} (runs 1 + 2) vs "
                         f"{straight[s][key]!r} (run 3): a resume must give the same bits")
        print(f"  steps 1-4, runs 1 + 2 vs run 3: {', '.join(LOOP_RESUME_KEYS)} bit for bit; "
              f"loss {[resumed[s]['loss'] for s in (1, 2, 3, 4)]}", flush=True)

        print("[loop] the export pair served on the card against the student's own bf16 "
              "forward from the loop's final weights", flush=True)
        state = CheckpointManager(ckpt).restore()
        if state is None or state["step"] != 4:
            fail("loop: no checkpoint at step 4")
        student = StudentModel(exp.distiller, device="cuda")
        student.load_state_dict(state["student"])
        student.eval()
        wavs = [torch.randn(int(s * SR), generator=gen) * 0.1 for s in (3.3, 7.9, 5.1)]
        _build.reset_launches()
        expert = UpstreamExpert(os.path.join(tmp, "resumed", "student.pt"), exp.distiller,
                                device="cuda")
        got = expert(wavs)
        served = dict(_build.LAUNCHES)
        t_pad = quantize_length(max(len(w) for w in wavs), SR)
        x = torch.zeros(len(wavs), t_pad)
        mask = torch.ones(len(wavs), t_pad, dtype=torch.bool)
        for i, w in enumerate(wavs):
            x[i, : len(w)], mask[i, : len(w)] = w, False
        want = student(x.cuda(), mask.cuda())
        torch.cuda.synchronize()
        if not torch.equal(got["last_hidden_state"], want.x) or \
                not torch.equal(got["padding_mask"], want.padding_mask):
            err = (got["last_hidden_state"].float() - want.x.float()).abs().max().item()
            fail(f"loop: the export's features differ from the student's by {err:.3e}")
        if not torch.isfinite(want.x).all().item():
            fail("loop: the exported student's features are not finite")
        print(f"  UpstreamExpert(student.pt) B=3 ragged: last_hidden_state "
              f"{tuple(want.x.shape)} equal to the student's forward, bit for bit; launches "
              f"{json.dumps(served)} ok", flush=True)
        del student, expert

        print(f"[loop] rate: {LOOP_RATE_EPOCHS} epochs from scratch ({2 * LOOP_RATE_EPOCHS} "
              f"steps), log_every {LOOP_RATE_LOG_EVERY}", flush=True)
        train, timed_steps = run("rate", "rate", LOOP_RATE_EPOCHS, False, 2 * LOOP_RATE_EPOCHS,
                                 2 * LOOP_RATE_EPOCHS, LOOP_RATE_EPOCHS, LOOP_RATE_LOG_EVERY)
        # the window runs from step 1's tick to the last step's; every epoch
        # but the last ends inside it with its eval (2 batches) and its save
        window = timed_steps / train[max(train)]["steps_per_sec"]
        inside = pauses[:-3]
        evals = sum(t for what, t in inside if what == "eval")
        saves = sum(t for what, t in inside if what == "save")
        print(f"  rate: StepTimer window {window:.3f} s over {timed_steps} steps holds "
              f"{LOOP_RATE_EPOCHS - 1} evals ({evals:.3f} s) and checkpoint saves "
              f"({saves:.3f} s); the steps alone {timed_steps / (window - evals - saves):.3f} "
              f"steps/s; {smi}", flush=True)


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
        from fithubert_tpu_torch.ops.kernels import dropout as kd
        from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    except ImportError as e:
        fail(f"the fithubert_tpu_torch package is not importable here ({e})")
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # the main paths run the card's default conv backward (K6); phase 6 and
    # the library yardsticks set FITHUBERT_CONV_BWD=xla for their own blocks
    os.environ.pop("FITHUBERT_CONV_BWD", None)

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
    for name in SOURCES:
        for kernel, regs, stores, loads in _build.ptxas_usage(name):
            print(f"[build] {name}.cu {kernel}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B (nvcc -Xptxas -v)", flush=True)

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
    errs["conv"], errs["prefix"] = check_conv_stack(cpu_model, wavs, dev, "student")
    wavs = ragged_wavs(gen, 11, 2.0, 12.0) + [torch.randn(12 * SR, generator=gen) * 0.1]
    errs["conv_teacher"], errs["prefix_teacher"] = check_conv_stack(teacher_cpu, wavs, dev,
                                                                    "teacher")

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

    # the student's last-layer probabilities of one microbatch of the release step
    t_student = cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    probs_shape = (exp.train.batch_size, cfg.encoder_attention_heads, t_student, t_student)
    print(f"[kernels] seeded_dropout_cuda (K5) vs seeded_dropout_plain, p={ATTN_P}, the "
          f"student's last-layer probabilities of one microbatch {probs_shape}", flush=True)
    check_seeded_dropout(kd, probs_shape, gen, dev)
    errs[kd.KERNEL] = 0.0

    print("[kernels] conv_stack_bwd_cuda (K6) vs conv_stack_bwd_plain and the library "
          "recompute: the student's stack at its train input, 12 x 12 s", flush=True)
    train_wavs = [torch.randn(12 * SR, generator=gen) * 0.1 for _ in range(12)]
    errs[cf.KERNEL_BWD] = check_conv_backward(cf, cpu_model, train_wavs, gen, dev)

    print("[kernels] K6's up pass (up_pass_cuda) vs K1 (conv_stack_cuda), bit for bit: the "
          "student's stack at its train input, 12 x 12 s", flush=True)
    check_up_pass(cf, cpu_model, train_wavs, dev)

    # ---- 4. the slice end to end
    print("[e2e] UpstreamExpert(fithubert_960h(), seeded weights), bf16, 3 requests",
          flush=True)
    expert = UpstreamExpert(state, cfg, device="cuda")
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
        delta = {n: _build.LAUNCHES.get(n, 0) - before.get(n, 0)
                 for n in (cf.KERNEL_PREFIX, cf.KERNEL, fa.KERNEL)}
        if delta[cf.KERNEL_PREFIX] < 1 or delta[cf.KERNEL] < 1 or \
                delta[fa.KERNEL] < cfg.encoder_layers:
            fail(f"request of {len(wav_list)} did not run through every kernel: {delta}")
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
    gpu32 = UpstreamExpert(state, cfg32, device="cuda")(wav4)
    cpu32 = UpstreamExpert(state, cfg32, device="cpu")(wav4)
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
          "weights), bf16, dropout 0.1, num_training_steps=20, FITHUBERT_CONV_BWD unset: "
          "the conv stack's backward runs K6", flush=True)
    t_state = teacher_cpu.state_dict()
    student_cpu = StudentModel(exp.distiller, device="cpu").init_weights(gen)
    s_state = student_cpu.state_dict()
    rand_layers = torch.randperm(exp.distiller.encoder_layers - 1, generator=gen)
    n_stack = len(exp.distiller.conv_feature_layers) - 1
    per_step = {
        cf.KERNEL: len(exp.distiller.conv_feature_layers) - 1 + len(geom.conv_feature_layers) - 1,
        cf.KERNEL_PREFIX: 2,  # one per extractor, student and teacher: block 0's GroupNorm
        fa.KERNEL: geom.encoder_layers, fa.KERNEL_DROPOUT: exp.distiller.encoder_layers,
        fa.KERNEL_DQ: exp.distiller.encoder_layers, fa.KERNEL_DKV: exp.distiller.encoder_layers,
        cf.KERNEL_BWD: 4 * n_stack}  # K6: up, dW, its ordered sum and da per layer
    distiller = Distiller(exp, t_state, s_state, device="cuda", num_training_steps=20)
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size

    # the counts of the last checked step of each training path
    path_launches = {"train": {}, "train-library": {}, "train-taps": {}}

    def step_checked(d, batch, want, what, path):
        """One train step with every count set to 0 just before it and read
        just after; fails unless they are ``want`` and the logs finite."""
        _build.reset_launches()
        logs = d.train_step(batch, rand_layers)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        if got != want:
            fail(f"{what}: launches {got}, want {want} per step")
        path_launches[path] = got
        if not all(math.isfinite(v) for v in logs.values()):
            fail(f"{what}: non-finite logs {logs}")
        return logs

    logs = step_checked(distiller, train_batch(gen, a, b, 12.0, ragged=True), per_step,
                        "ragged step", "train")
    if not all(torch.isfinite(p).all().item() for p in distiller.params):
        fail("ragged step: non-finite parameters")
    print(f"  step 0 (ragged 3 x 4, one fabricated row, lr {logs['lr']}): loss "
          f"{logs['loss']:.6f} grad_norm {logs['grad_norm']:.6f} finite ok; launches "
          f"{json.dumps(path_launches['train'])} ok", flush=True)
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    losses = []
    for i in range(10):
        logs = step_checked(distiller, fixed, per_step, f"step {i + 1}", "train")
        losses.append(logs["loss"])
    print(f"  steps 1-10 on one 3 x 4 x 12 s batch: loss {[round(x, 6) for x in losses]}, "
          f"lr {logs['lr']:.3e} at step 10", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 10 steps: {losses}")
    print(f"  loss fell {losses[0]:.6f} -> {losses[-1]:.6f}; every step launched "
          f"{json.dumps(path_launches['train'])} ok", flush=True)

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

    # ---- 6. the library path: the conv stack's backward by the F.conv1d recompute
    print("[train-library] the release Distiller with FITHUBERT_CONV_BWD=xla: the conv "
          "stack's backward is the library recompute (autograd through F.conv1d)", flush=True)
    per_step_lib = {n: c for n, c in per_step.items() if n != cf.KERNEL_BWD}
    ragged = train_batch(gen, a, b, 12.0, ragged=True)
    front = {}  # conv front-end gradients of one ragged step, per backward
    for mode, want, path in ((None, per_step, "train"), ("xla", per_step_lib, "train-library")):
        d = Distiller(exp, t_state, s_state, device="cuda", num_training_steps=20)
        what = "library" if mode else "K6"
        with conv_backward(mode):
            logs = step_checked(d, ragged, want, f"ragged step, {what} backward", path)
        front[what] = {n: p.grad.detach().clone()
                       for n, p in d.student.feature_extractor.named_parameters()}
        print(f"  ragged step ({what} backward): loss {logs['loss']:.6f} grad_norm "
              f"{logs['grad_norm']:.6f}", flush=True)
        if mode:
            distiller_lib = d
        del d
    for n in front["library"]:
        normwise(f"conv front-end grad {n}, K6 vs the library backward", front["K6"][n],
                 front["library"][n], K6_VS_LIBRARY)
    del front
    with conv_backward("xla"):
        losses = [step_checked(distiller_lib, fixed, per_step_lib, f"library step {i + 1}",
                               "train-library")["loss"] for i in range(3)]
    print(f"  steps 1-3 on the 3 x 4 x 12 s batch: loss {[round(x, 6) for x in losses]}; "
          f"every step launched {json.dumps(path_launches['train-library'])} ok", flush=True)

    # ---- 7. path B: the attention-transfer losses, with K5
    print(f"[train-taps] the release Distiller with tap losses {TAP_LOSS}: the last layer "
          f"returns its taps, K5 drops the student's probabilities, {a} microbatches looped",
          flush=True)
    exp_taps = dataclasses.replace(exp, loss=dataclasses.replace(exp.loss, **TAP_LOSS))
    l_s, l_t = exp.distiller.encoder_layers, geom.encoder_layers
    per_step_taps = {cf.KERNEL: a * per_step[cf.KERNEL],
                     cf.KERNEL_PREFIX: a * per_step[cf.KERNEL_PREFIX], fa.KERNEL: a * (l_t - 1),
                     fa.KERNEL_DROPOUT: a * (l_s - 1), fa.KERNEL_DQ: a * (l_s - 1),
                     fa.KERNEL_DKV: a * (l_s - 1), kd.KERNEL: 2 * a,
                     cf.KERNEL_BWD: a * per_step[cf.KERNEL_BWD]}
    distiller_taps = Distiller(exp_taps, t_state, s_state, device="cuda", num_training_steps=20)
    logs = step_checked(distiller_taps, ragged, per_step_taps, "taps ragged step", "train-taps")
    if not all(torch.isfinite(p).all().item() for p in distiller_taps.params):
        fail("taps ragged step: non-finite parameters")
    print(f"  step 0 (ragged 3 x 4, one fabricated row): loss {logs['loss']:.6f} attn_loss "
          f"{logs['attn_loss']:.6f} v_rel_loss {logs['v_rel_loss']:.6f} grad_norm "
          f"{logs['grad_norm']:.6f}, parameters finite ok", flush=True)
    losses = [step_checked(distiller_taps, fixed, per_step_taps, f"taps step {i + 1}",
                           "train-taps")["loss"] for i in range(3)]
    print(f"  steps 1-3 on the 3 x 4 x 12 s batch: loss {[round(x, 6) for x in losses]}; "
          f"every step launched {json.dumps(path_launches['train-taps'])} ok", flush=True)

    print("[train-taps] fp32 steps without dropout, card vs CPU (plain versions), full "
          "width, 1 x 2 s: step 0 at lr 0, then one at lr > 0", flush=True)
    exp_taps32 = dataclasses.replace(exp32, loss=exp_taps.loss)
    on_card = Distiller(exp_taps32, t_state, s_state, device="cuda", num_training_steps=20)
    on_cpu = Distiller(exp_taps32, t_state, s_state, device="cpu", num_training_steps=20)
    for i in range(2):
        lg, lc = on_card.train_step(small, rand_layers), on_cpu.train_step(small, rand_layers)
        for key in ("loss", "grad_norm", "attn_loss", "v_rel_loss"):
            rel = abs(lg[key] - lc[key]) / abs(lc[key])
            if rel > TRAIN_RTOL:
                fail(f"fp32 taps step {i}: {key} card {lg[key]} vs CPU {lc[key]} (rel {rel:.3e})")
        print(f"  step {i}: loss {lg['loss']:.8f} vs {lc['loss']:.8f}, attn_loss "
              f"{lg['attn_loss']:.8f} vs {lc['attn_loss']:.8f}, v_rel_loss "
              f"{lg['v_rel_loss']:.8f} vs {lc['v_rel_loss']:.8f}, grad_norm "
              f"{lg['grad_norm']:.8f} vs {lc['grad_norm']:.8f} tol rel {TRAIN_RTOL} ok",
              flush=True)
    worst = max((pg.detach().cpu() - pc.detach()).abs().max().item()
                for pg, pc in zip(on_card.params, on_cpu.params))
    if worst > TRAIN_PARAM_ATOL:
        fail(f"fp32 taps step: parameters differ by {worst:.3e} > {TRAIN_PARAM_ATOL}")
    print(f"  parameters after 2 steps: max_abs_err={worst:.3e} tol={TRAIN_PARAM_ATOL} ok",
          flush=True)
    del on_card, on_cpu

    # ---- 8. the training loop
    print("[loop] run_training on the release config: a fairseq HuBERT-Base .pt teacher, "
          "a WAV corpus, FITHUBERT_CONV_BWD unset", flush=True)
    per_eval = {cf.KERNEL_PREFIX: 2, cf.KERNEL: per_step[cf.KERNEL],  # teacher + student
                fa.KERNEL: geom.encoder_layers + exp.distiller.encoder_layers}  # p = 0
    loop_phase(exp, geom, teacher_cpu, per_step, per_eval, smi)

    # ---- 9. timing
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

    for what, d, mode in (("the library path: FITHUBERT_CONV_BWD=xla, the conv stack's "
                           "backward by the F.conv1d recompute", distiller_lib, "xla"),
                          (f"path B: tap losses with K5, {a} microbatches looped",
                           distiller_taps, None)):
        print(f"[timing] train step, {what}, 3 x 4 x 12 s, bf16", flush=True)
        times = []
        with conv_backward(mode):
            for _ in range(7):
                t0 = time.perf_counter()
                d.train_step(fixed, rand_layers)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            med = statistics.median(times)
            print(f"  train step: median {med:.3f} ms over 7 (min {min(times):.3f}, max "
                  f"{max(times):.3f}), {1e3 / med:.3f} steps/s, {audio_s / (med / 1e3):.1f} "
                  f"audio-s/s; the release step above {step_ms:.3f} ms", flush=True)
            profile_device(lambda: d.train_step(fixed, rand_layers), "train step", top=20,
                           unprofiled_ms=med)

    # One row per kernel and path. "launches" is the count the path's run
    # made: over the three serving requests, or in the last checked train
    # step. Each row is timed at that path's shape.
    print("[timing] kernels against their bounds, plain versions and library calls",
          flush=True)
    kernels = []

    launches_of = dict(path_launches, serving=main_path_launches)
    # (what, kernel ms, library ms, goal and acceptance as multiples of the
    # library's time; acceptance None where none was set)
    goals = []
    k1_goals = []  # (what, conv_times-like dict, goal ms, acceptance ms)

    def row(name, src, replaces, path, shape, err, ms, plain_ms, work, library_ms,
            peak=BF16_PEAK):
        b_ms, b_by = bound(*work, peak)
        launches = launches_of[path].get(name, 0)
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

    # serving: the prefix, K1 and K2 at B = 32 x 16 s
    prefix_src, prefix_of = "conv_frontend.cu", "conv_frontend.py:283 (prefix :160)"
    serve = conv_times(cpu_model, bench, dev, "serving")
    shape = f"B=32 x 16 s, {stack_shape(cpu_model, bench)}"
    row(cf.KERNEL_PREFIX, prefix_src, prefix_of, "serving", shape, errs["prefix"],
        *serve["prefix"], peak=FP32_PEAK)
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "serving",
        f"{shape}, from a0", errs["conv"], *serve["k1"])
    k1_goals.append((f"K1 serving {stack_shape(cpu_model, bench)}", serve, 2.0, 2.5))
    t_att = cf.out_len(16 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    h, d = cfg.encoder_attention_heads, cfg.encoder_embed_dim // cfg.encoder_attention_heads
    q, k, v, mask = attention_qkv(32, t_att, h, d)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "serving",
        f"{tuple(q.shape)}", errs["attn"], a_ms, a_plain, a_work, a_lib)
    goals.append((f"K2 p=0 serving {tuple(q.shape)}", a_ms, a_lib, 1.5, None))
    del q, k, v, mask

    # train: the prefix and K1 over the student's and the teacher's stacks of one step
    step_wavs = list(fixed["x"].reshape(-1, fixed["x"].shape[-1]))
    stu, tea = (conv_times(m, step_wavs, dev, f"{who}, train")
                for m, who in ((student_cpu, "student"), (teacher_cpu, "teacher")))
    shape = f"student {stack_shape(student_cpu, step_wavs)} + teacher " \
        f"{stack_shape(teacher_cpu, step_wavs)}"

    def both(key):  # the two stacks' numbers, summed field by field
        sk, tk = stu[key], tea[key]
        return (sk[0] + tk[0], sk[1] + tk[1], (sk[2][0] + tk[2][0], sk[2][1] + tk[2][1]),
                None if sk[3] is None else sk[3] + tk[3])

    row(cf.KERNEL_PREFIX, prefix_src, prefix_of, "train", shape,
        max(errs["prefix"], errs["prefix_teacher"]), *both("prefix"), peak=FP32_PEAK)
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "train", f"{shape}, from a0",
        max(errs["conv"], errs["conv_teacher"]), *both("k1"))
    k1_goals.append(("K1 train, student + teacher", {
        "call_ms": stu["call_ms"] + tea["call_ms"], "k1": both("k1"),
        "floor_ms": stu["floor_ms"] + tea["floor_ms"]}, 2.0, 3.0))

    # train: K2 at p = 0, the teacher's attention, (12, 599, 12, 64)
    q, k, v, mask = attention_qkv(*teacher_attn)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "train",
        f"teacher {tuple(q.shape)}", errs["attn_train"], a_ms, a_plain, a_work, a_lib)
    goals.append((f"K2 p=0 teacher {tuple(q.shape)}", a_ms, a_lib, 1.5, None))
    del q, k, v, mask

    # train: the student's attention, (12, 299, 12, 40), p = 0.1: K2, K3, K4
    t_att = cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    q, k, v, dout, mask = attention_qkv(a * b, t_att, h, d, n=4)
    seed = seed_words(gen)
    shape = f"student {tuple(q.shape)}, p={ATTN_P}"
    f_ms, f_plain, f_work, f_lib = attention_fwd_times(q, k, v, mask, ATTN_P, seed)
    row(fa.KERNEL_DROPOUT, "flash_attention.cu", "flash_attention.py:243 (dropout branch "
        ":100-106)", "train", shape, errs[fa.KERNEL_DROPOUT], f_ms, f_plain, f_work, f_lib)
    goals.append((f"K2 {shape}", f_ms, f_lib, 1.0, None))
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
    goals.append((f"K3 {shape}, against SDPA's whole backward", dq_ms, lib_bwd, 0.75, 1.0))
    goals.append((f"K4 {shape}, against SDPA's whole backward", dkv_ms, lib_bwd, 1.0, None))
    print(f"  SDPA backward (dQ, dK, dV) at {shape}: {lib_bwd:.4f} ms; K3 {dq_ms:.4f}, "
          f"K4 {dkv_ms:.4f} ms", flush=True)
    del q, k, v, dout, mask, qs, ks, vs, o_lib

    # train-taps: K5 at the student's last-layer probabilities of one microbatch
    x = torch.rand((b, h, t_att, t_att), generator=gen).to(dev)
    seed = seed_words(gen)
    with torch.no_grad():
        k5_ms = cuda_ms(lambda: kd.seeded_dropout_cuda(x, seed, ATTN_P), reps=50)
        k5_plain = cuda_ms(lambda: kd.seeded_dropout_plain(x, seed, ATTN_P), reps=5)
        k5_lib = cuda_ms(lambda: F.dropout(x, ATTN_P, training=True), reps=50)
    # one multiply per element; 4 bytes read and 4 written
    row(kd.KERNEL, "seeded_dropout.cu", "dropout.py:83", "train-taps",
        f"student probabilities {tuple(x.shape)} fp32, p={ATTN_P}", errs[kd.KERNEL], k5_ms,
        k5_plain, (x.numel(), 8 * x.numel()), k5_lib, peak=FP32_PEAK)
    del x

    # train: K6 over the student's stack of one step, from a0 = the prefix's output
    spec = student_cpu.feature_extractor.spec[1:]
    x, ws, scale, shift = stack_inputs(student_cpu, step_wavs, torch.bfloat16, dev)
    with torch.no_grad():
        a0 = cf._prefix(x, scale, shift)
    del x, scale, shift
    g = torch.randn((a0.shape[0], cf.out_len(a0.shape[1], spec), spec[-1][0]),
                    generator=gen).to(dev, torch.bfloat16)
    k6_ms = cuda_ms(lambda: cf.conv_stack_bwd_cuda(a0, ws, g, spec), reps=5, warmup=1)
    k6_plain = cuda_ms(lambda: cf.conv_stack_bwd_plain(a0, ws, g, spec), reps=2, warmup=1)
    leaves = [t.detach().requires_grad_() for t in [a0, *ws]]
    k6_lib = cuda_ms(lambda: torch.autograd.grad(
        cf.conv_stack_plain(leaves[0], leaves[1:], spec), leaves, g), reps=5, warmup=1)
    k6_shape = f"student a0 {tuple(a0.shape)}, g {tuple(g.shape)}"
    row(cf.KERNEL_BWD, "conv_frontend_bwd.cu", "conv_frontend_bwd.py:290", "train", k6_shape,
        errs[cf.KERNEL_BWD], k6_ms, k6_plain, conv_bwd_work(a0, spec), k6_lib)
    del leaves
    k6_launches_ms, k6_floor = k6_breakdown(cf, a0, ws, g, spec)
    del a0, g, ws

    def met(ok):
        return "met" if ok else "missed"

    k1_floor = {"serving": serve["floor_ms"], "train": stu["floor_ms"] + tea["floor_ms"]}
    for kr in kernels:
        lib = "none" if kr["library_ms"] is None else f"{kr['library_ms']:.4f}"
        floor = f", per-layer floor {k1_floor[kr['path']]:.4f} ms" \
            if kr["name"] == cf.KERNEL else ""
        print(f"  {kr['name']} ({kr['path']}, {kr['shape']}): {kr['ms']:.4f} ms (bound "
              f"{kr['bound_ms']:.4f} ms by {kr['bound_by']}{floor}, plain "
              f"{kr['plain_ms']:.4f}, library {lib}), {kr['launches']} launches "
              f"{'over the 3 serving requests' if kr['path'] == 'serving' else 'per train step'}",
              flush=True)

    for what, ms, lib, goal, accept in goals:
        acc = "" if accept is None else f", acceptance <= {accept}x {met(ms <= accept * lib)}"
        print(f"  goal {what}: {ms:.4f} ms = {ms / lib:.2f}x the library's {lib:.4f} ms; "
              f"goal <= {goal}x {met(ms <= goal * lib)}{acc}", flush=True)
    print(f"  goal K6 train ({k6_shape}): {k6_ms:.4f} ms (its launches timed alone "
          f"{k6_launches_ms:.4f}, their summed floors {k6_floor:.4f}); goal <= 2.2 ms "
          f"{met(k6_ms <= 2.2)}, acceptance <= 3.0 ms {met(k6_ms <= 3.0)}", flush=True)
    for what, t, goal, accept in k1_goals:
        ms = t["call_ms"]
        print(f"  goal {what}, the conv_stack call with its prefix kernel: {ms:.4f} ms (K1's "
              f"launches alone {t['k1'][0]:.4f}, their per-layer floor {t['floor_ms']:.4f}); "
              f"goal <= {goal} ms {met(ms <= goal)}, acceptance <= {accept} ms "
              f"{met(ms <= accept)}", flush=True)

    # ---- 10. result lines
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
