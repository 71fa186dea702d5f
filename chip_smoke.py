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
     same keep mask, and at the wav2vec2-Large teacher's (12, 599, 16, 64),
     K2 in bf16 against attention_fwd_tiles_plain (the kernel's own
     roundings) at the student's and the teacher's shapes, bit for bit
     across two runs and a CUDA-graph replay with new seed words, the
     attention
     backward (K3 + K4: the delta pre-pass, the fused wgmma pass and the dQ
     sum, each against its plain version, the whole backward bit for bit
     across two runs and a CUDA-graph replay), the seeded dropout (K5), the conv-stack
     backward (K6, and its dW bit for bit across two calls), and K6's up
     pass against K1's output bit for bit; then at the ex student's shapes
     (configs/ex.yaml): K2 with dropout and the backward at (8, 600, 12, 64), and
     K1, its prefix and K6 on its 512-wide stack at 8 x 12 s; then K5 at
     the rel_pos conformer's probabilities, (3, 12, 599, 599) and
     (32, 12, 799, 799) fp32, bit for bit forward and backward, and K2 with
     dropout and the backward at the abs conformer's (3, 299, 12, 40); then
     K2 (p = 0 and 0.1) and the whole backward past grid y's 65535 (B x H =
     65544, T = 1 and 80), the first 16 rows bit for bit against a call on
     them alone;
  4. serving end to end: UpstreamExpert at FitHuBERT-960h width (seeded
     weights) serves three ragged requests in bf16, through K1 and K2
     (launch counters are zeroed just before and read just after); then the
     same weights in fp32 on the card against the CPU's plain versions;
  5. training end to end: the Distiller of configs/fithubert.yaml (HuBERT-
     Base teacher, FitHuBERT-960h student, seeded weights, bf16, dropout
     0.1), FITHUBERT_CONV_BWD unset, takes a ragged 3 x 4 step with a
     fabricated row, then 10 steps on one 3 x 4 x 12 s batch; every step
     goes through K1, K2 (teacher p = 0, student p = 0.1), the attention
     backward (its pre-pass, fused pass and dQ sum) and the
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
  8. the training loop: run_training on the release config, a seeded
     fairseq HuBERT-Base .pt and WAVs it writes, resumed runs bit for bit,
     the export served, a 20-step rate run;
  8a. rehearsal: the port's dress rehearsal (train_torch.py on
     configs/rehearsal.yaml, 240 steps, SIGTERM after step 100, the
     preemption checkpoint, the resume with a continuous loss, the export,
     the CTC probe on it), started after the loop in the background beside
     phases 8b-8e (so the walls that [int8], [options], [remat] and [chain]
     print are taken while it shares the card) and read before [tp]: each
     training process's launches, the export's fp32
     features on the card against the CPU, and the framewise probe on the
     card, both probes under the probe CLI's rules;
  8b. ex: the DistilHuBERT-style student of configs/ex.yaml
     (``ex_experiment()``: 2 layers of 768, SplitLinear head on teacher
     layers 3, 7, 11, L1 + cosine) with the HuBERT-Base teacher: the
     hint-init bit for bit, a ragged step and 6 steps with exact launches
     and a falling loss, fp32 steps against the CPU, run_training stopped
     at max_steps and resumed bit for bit against an uninterrupted run,
     and the export served in bf16 and fp32;
     ctc: the release student with a seeded wav2vec2-Base-shaped CTC
     teacher read from a fairseq fine-tuned .pt: pseudo-label steps with
     the release launches and a falling loss, then run_training on labels
     from transcripts written beside the WAVs, with an eval's WER;
  8c. conformer: ``conformer_experiment(p)`` (the release config with
     conformer layers) for p = rel_pos, rope (the conformer encoder of its
     own, K5 in every layer) and abs (conformer layers in the transformer
     encoder, K2-K4): a ragged step with a fabricated row and steps on one
     batch with exact launches (4 microbatches looped: the BatchNorm
     statistics), the statistics moving, fp32 steps against the CPU,
     run_training on rel_pos stopped at max_steps 3 and resumed to 6 bit
     for bit against 6 straight steps (statistics included), the export
     served in bf16 and fp32; mel: ``mel_experiment()`` (80 log-mels,
     MelSpecHead, SpecAugment): steps with exact launches (no student K1,
     prefix or K6) and a falling loss, SpecAugment's draws equal on the
     card and the CPU and its bands within their ranges, an fp32 step
     against the CPU with SpecAugment on, the export served without it;
  8d. large: the release student (pred_head_final_dim 1024) distilling a
     seeded fairseq-shaped wav2vec2-Large LV-60 teacher (layer_norm
     extractor with conv bias, pre-LN, 24 x 1024, 16 heads of 64) written
     as a .pt and read by load_fairseq_teacher: steps with exact launches
     (no teacher K1 or prefix; K2 24 at (12, 599, 16, 64)) and a falling
     loss, fp32 steps against the CPU; int8: torch._int_mm's accumulators
     against the CPU's bit for bit, the release step with
     teacher.quantize_int8 (its targets within cosine 0.99 of the bf16
     teacher's, the launches unchanged), UpstreamExpert(int8=True) on three
     ragged requests and B = 32 x 16 s against the bf16 expert, the int8
     and bf16 steps, teacher forwards and serving forwards timed; options:
     a release-width student with a layer_norm extractor, conv bias, a
     3-deep positional conv and gelu_fast (no student K1, prefix or K6),
     steps with exact launches, fp32 against the CPU; conformer-dp: the
     rel_pos conformer (4 layers) over two gloo ranks sharing the card,
     fp32 against one process (BatchNorm statistics included) and bf16,
     each rank's state bit-identical to the other's;
  8e. smoke-configs: configs/smoke.yaml in fp32 and bf16 and
     configs/smoke_ctc.yaml through train_torch.py (heads of 12 and 16,
     widths 32 and 48: the kernels pad them), each with a falling loss and
     its launches; K2-K4 at head sizes 12, 16, 80 and 128 and K1 / K6 on the
     smoke student's stack against their plain versions; remat:
     checkpoint_activations on against off for the release and rel_pos
     steps, bit for bit, with each step's peak memory; chain:
     train.steps_per_launch 4 as one CUDA graph against 4 eager steps for
     the release step, path B and rel_pos (bit for bit, the launches
     counted at the warm-up and capture, none at a replay), eager and
     graphed walls, the replay's device time, the capture time, and
     run_training with
     steps_per_launch 4;
  9. timing: serving at B = 32 x 16 s and the train step at 3 x 4 x 12 s,
     with a profile of each, the host's time of a whole K2 call,
     the steps of paths 6 and 7, and every kernel against its bound, its
     plain version and the library call, one row per
     kernel and path at that path's shapes, with the launches that path's
     run counted; on text lines K1's per-layer floor, each K1 layer's time
     beside its own floor, each K6 launch's time beside its own floor, and
     the goals: every K2 row's time as a multiple of SDPA's forward, with
     its share of its bound and the exp2 floor, the whole attention
     backward's as a multiple of SDPA's (each backward launch also has its
     row), K1's (the
     conv_stack call with its prefix) and K6's in ms; the ex train step
     and the ex serving forward (B = 32 x 16 s) with their profiles, and
     the ex rows (path "ex") of K1, its prefix, K2 p = 0.1, the backward, K6;
     the rel_pos, abs and mel train steps and the rel_pos serving forward
     (B = 32 x 16 s) with their profiles, and the rows of K5 (path
     "conformer") and K2 p = 0.1, the backward (path "conformer-abs"); the large
     train step with its profile and K2's row at (12, 599, 16, 64) (path
     "large");
  10. data parallelism: NCCL as one rank on the card, two release steps
     through the data-parallel path bit for bit against the plain step;
     two gloo ranks sharing the card (spawned by ``launch``), fp32 against
     one process on the same global batch, and the bf16 release step with
     its parameters bit-identical across the ranks, each rank's launches
     the release step's and the ranks' keep masks differing; the loop over
     two gloo ranks for one epoch, one checkpoint, an export that serves;
  11. export: a full-width Lightning .ckpt through the torch.hub entry,
     bit for bit against UpstreamExpert on the state dict, and
     ``python -m fithubert_tpu_torch.export.extract_features`` on the WAVs,
     each .npy against the expert's forward;
  12. a JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

SR = 16000
# H100 SXM data sheet: bf16 tensor cores, fp32 outside the tensor cores, HBM3
BF16_PEAK, FP32_PEAK, HBM_BPS = 989e12, 67e12, 3.35e12
# The special-function units: 16 exp2 a clock per SM (the CUDA programming
# guide's throughput table for compute capability 9.0), 132 SMs, ~1.755 GHz
# under load: the floor of K2's one exp2 per (query, valid key).
SFU_RATE = 16 * 132 * 1.755e9
# torch.cuda._sleep spins for a count of SM cycles; the H100 SXM clocks at
# most 1.98 GHz, so 2e6 cycles last at least a millisecond.
SLEEP_CYCLES_PER_MS = 2e6

# Tolerances. Elementwise, |kernel - plain| <= ATOL + RTOL * |plain|:
#   fp32: only the summation order differs (kernel tiles vs cuDNN / einsum);
#   bf16 attention: both sides sum in fp32 from the same bf16 inputs; the
#   plain version rounds once, the kernels (K2, the fused backward) also
#   round P, and dS for dK, to bf16 before the second product, as the TPU
#   kernels do. Those roundings
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
# The attention backward (K3 + K4) against attention_bwd_plain: the same
# formulas from the same bf16 inputs (q, k, v, dO, lse, delta): TOL above.
# The fused pass rounds dS to bf16 once for dK, as the TPU kernel does, and
# feeds dS K with dS in two bf16 parts (~16 bits), since one rounding times
# the unscaled K moves dQ past TOL where a row has few valid keys. Each
# launch against its own plain version (the same roundings): TOL too; the
# dQ sum adds the same fp32 partials in the same order: bit for bit. Against autograd of
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
# K2 in bf16 against attention_fwd_tiles_plain, which repeats the kernel's
# arithmetic (the online softmax over its 64-key tiles in fp32, P rounded to
# bf16 against each tile's running max): the two differ in the order of
# their fp32 sums only. That can flip P's bf16 rounding where a value lies
# within ~1e-6 of a rounding boundary (a flip moves the output by 2^-9 of one
# P V term over the row's sum, well under 1e-3 at these widths), and the
# output's own bf16 rounding by one step (2^-8 relative).
FWD_TILES_TOL = {"bfloat16": (1e-3, 2 ** -8)}
# The tap losses on the release config (the values of tests/test_losses.py:171-172).
TAP_LOSS = dict(attn_loss_weight=1.0, attn_loss_type="kldiv", v_rel_loss_weight=1.0)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


# Failures whose phase leaves nothing the later phases use: printed where
# they happen, and the script fails with them after its last phase.
DEFERRED: list = []


def fail_at_end(msg: str) -> None:
    print(f"chip_smoke FAILED (the later phases still run; the script fails at its end): "
          f"{msg}", flush=True)
    DEFERRED.append(msg)


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


def valid_keys(q, mask):
    b, t = q.shape[:2]
    return (~mask).sum().item() if mask is not None else b * t


def attn_bwd_whole_work(q, mask):
    """(flops, bytes) of the whole attention backward over the valid keys:
    S, dP, dV, dK and dQ recomputed or formed (10 D per query and key); q,
    k, v, O, dO, lse and the mask read once, dQ, dK and dV written once."""
    b, t, h, d = q.shape
    flops = 10 * h * d * t * valid_keys(q, mask)
    return flops, 8 * q.numel() * q.element_size() + b * t + b * h * t * 4


def attn_prep_work(q):
    """(flops, bytes) of the delta pre-pass: a multiply-add per element of
    dO * O, both read once, delta (B, H, T) fp32 written once."""
    b, t, h, _d = q.shape
    return 2 * q.numel(), 2 * q.numel() * q.element_size() + b * h * t * 4


def attn_fused_work(q, mask, key_tile):
    """(flops, bytes) of the fused backward pass over the valid keys: S, dP,
    dV, dK and dS K with dS in two parts (12 D per query and key); q, k, v,
    dO, lse, delta and the mask read once, dK, dV and the fp32 dQ partials
    of its key tiles written once. The partials and the lo part of dS are
    the design's own work: attn_bwd_whole_work counts what the function
    needs."""
    b, t, h, d = q.shape
    flops = 12 * h * d * t * valid_keys(q, mask)
    n_kt = -(-t // key_tile)
    bytes_ = 6 * q.numel() * q.element_size() + b * t + 2 * b * h * t * 4 + n_kt * q.numel() * 4
    return flops, bytes_


def attn_dq_sum_work(q, key_tile):
    """(flops, bytes) of the dQ sum: the partials of every key tile read
    once and added in fp32, dQ written once."""
    n_kt = -(-q.shape[1] // key_tile)
    return (n_kt - 1) * q.numel(), n_kt * q.numel() * 4 + q.numel() * q.element_size()


def bound(flops, bytes_, peak):
    t_ops, t_bytes = flops / peak * 1e3, bytes_ / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_device(fn, what, n=3, top=14, unprofiled_ms=None):
    """Device time by kernel over n calls of fn (torch.profiler), the
    device's busy share of the wall time (and of ``unprofiled_ms``, the same
    call timed without the profiler), and peak memory: the calls' own, above
    what was allocated before them (the path's weights, and whatever the
    script still holds), and that resident amount. Ranges that user code
    annotates (torch.optim's ``Optimizer.step#...``) span kernels counted
    already and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
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
        return None
    share = "" if unprofiled_ms is None else \
        f", {100 * busy / unprofiled_ms:.1f}% of the unprofiled {unprofiled_ms:.3f} ms"
    print(f"  profile: wall {wall:.3f} ms per {what}, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%{share}), peak memory "
          f"{(torch.cuda.max_memory_allocated() - resident) / 2**30:.2f} GiB above the "
          f"{resident / 2**30:.2f} GiB resident before it", flush=True)
    for key, t in rows[:top]:
        print(f"    {t:8.3f} ms {100 * t / busy:5.1f}%  {key[:90]}", flush=True)
    return busy


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


def seed_words(gen, dev):
    """Two random 32-bit words as a dropout seed, a (2,) int32 tensor on dev."""
    import torch

    from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

    w = torch.randint(0, 2 ** 32, (2,), generator=gen)
    return seed_tensor(int(w[0]), int(w[1]), dev)


def check_bwd_launches(fa, q, k, v, m, out, lse, dout, p, seed, tag):
    """Each launch of the bf16 backward against its plain version at the
    compiled head size the wrapper pads to: the
    pre-pass (fp32 sums in another order), the fused pass (dQ partials, dK,
    dV against attention_bwd_tiles_plain, the kernel's own roundings), the
    dQ sum bit for bit. Returns their max abs errors."""
    import torch
    import torch.nn.functional as F

    delta = fa.bwd_prep_cuda(out.contiguous(), dout.contiguous())
    errs = {fa.KERNEL_BWD_PREP: compare(f"{fa.KERNEL_BWD_PREP} {tag}", delta,
                                        fa.bwd_prep_plain(out, dout), "float32")}
    d = q.shape[-1]
    dp = fa.padded_head_dim(d)
    qp, kp, vp = (fa.pad_heads(x, dp) for x in (q, k, v))
    dop = F.pad(dout, (0, dp - d)).contiguous()
    got = fa.bwd_fused_cuda(qp, kp, vp, m, lse, dop, delta, p, seed)
    want = fa.attention_bwd_tiles_plain(qp, kp, vp, m, lse, dop, delta, p, seed)
    torch.cuda.synchronize()
    errs[fa.KERNEL_BWD] = max(
        compare(f"{fa.KERNEL_BWD} {what} {tag} vs attention_bwd_tiles_plain", g, w,
                "bfloat16")
        for what, g, w in zip(("dq partials", "dk", "dv"), got, want))
    if not torch.equal(fa.dq_sum_cuda(got[0]), fa.dq_sum_plain(got[0], torch.bfloat16)):
        fail(f"{fa.KERNEL_DQ_SUM} {tag}: not bit-identical to dq_sum_plain")
    print(f"  {fa.KERNEL_DQ_SUM} {tag}: bit-identical to dq_sum_plain ok", flush=True)
    errs[fa.KERNEL_DQ_SUM] = 0.0
    return errs


def check_bwd_replays(fa, q, k, v, m, out, lse, dout, p, seed, tag):
    """The bf16 backward twice, and captured in a CUDA graph and replayed
    twice: all bit-identical to the first eager run."""
    import torch

    def bwd():
        return fa._flash_bwd_cuda(q, k, v, m, out, lse, dout, p, seed)

    eager = bwd()
    runs = [bwd()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = bwd()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append(tuple(x.clone() for x in static))
    if not all(torch.equal(a, b) for run in runs for a, b in zip(run, eager)):
        fail(f"attention backward {tag}: a second run or a graph replay differs")
    print(f"  attention backward {tag}: a second eager run and two CUDA-graph replays "
          f"bit-identical ok", flush=True)
    del graph, static


def check_fwd_tiles(fa, gen, dev, cases):
    """K2 in bf16 against attention_fwd_tiles_plain at each (B, T, H, D, p)
    of ``cases`` on the same keep mask (FWD_TILES_TOL; lse at TOL); two runs
    bit for bit; with dropout, a CUDA graph captured over K2 and replayed
    after new seed words are written into its seed tensor, bit for bit
    against an eager call with those words. Returns the max abs error."""
    import torch

    worst = 0.0
    for (b, t, h, d, p) in cases:
        q, k, v, _dout, m = attention_case(gen, b, t, h, d, torch.bfloat16, dev, False)
        seed = seed_words(gen, dev) if p else None
        tag = f"bfloat16 {(b, t, h, d)} p={p}"

        def fwd():
            return fa.flash_attention(q, k, v, m, dropout_p=p, seed=seed, return_lse=True)

        out, lse = fwd()
        want, want_lse = fa.attention_fwd_tiles_plain(q, k, v, m, p, seed)
        torch.cuda.synchronize()
        worst = max(worst, compare(f"K2 {tag} vs attention_fwd_tiles_plain", out, want,
                                   "bfloat16", tol=FWD_TILES_TOL))
        compare(f"K2 lse {tag} vs attention_fwd_tiles_plain", lse, want_lse, "float32")
        again = fwd()
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            fail(f"K2 {tag}: a second run differs")
        print(f"  K2 {tag}: a second run bit-identical ok", flush=True)
        if not p:
            continue
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fwd()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fwd()
        seed.copy_(seed_words(gen, dev))  # new words into the captured seed tensor
        graph.replay()
        torch.cuda.synchronize()
        eager = fwd()
        if not (torch.equal(static[0], eager[0]) and torch.equal(static[1], eager[1])):
            fail(f"K2 {tag}: a CUDA-graph replay with new seed words differs from an eager "
                 "call with those words")
        if torch.equal(static[0], out):
            fail(f"K2 {tag}: the replay drew the old words' mask")
        print(f"  K2 {tag}: a CUDA-graph replay with new seed words bit-identical to an eager "
              f"call with them ok", flush=True)
        del graph, static
    return worst


def attn_exp2_floor(b, t, h):
    """ms of K2's exp2s on the special-function units: one per (query,
    key) of (B, T, H) attention without padding."""
    return b * h * t * t / SFU_RATE * 1e3


def check_attention_training_kernels(fa, gen, dev, errs,
                                     cases=((12, 299, 12, 40, False), (4, 130, 2, 40, True)),
                                     path=""):
    """K2 with dropout and the attention backward against their plain
    versions on the same keep mask, and the backward at p = 0 against
    autograd of attention_plain, at each (B, T, H, D, a fully padded row) of
    ``cases``; in bf16 also each backward launch against its plain version
    (check_bwd_launches) and, with dropout, the backward's determinism and
    its CUDA-graph replay. The bf16 errors of the cases without a padded row
    go to errs[kernel + path], the whole backward's to errs["attn_bwd" +
    path]."""
    import torch

    for (b, t, h, d, pad_row) in cases:
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v, dout, m = attention_case(gen, b, t, h, d, dtype, dev, pad_row)
            seed = seed_words(gen, dev)
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
                errs[fa.KERNEL_DROPOUT + path] = e
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
                        e = compare(f"attention backward {gname} p={p} {tag} vs {ref_name}",
                                    g, r, dtype_name, rows)
                        if dtype_name == "bfloat16" and not pad_row and p and \
                                ref_name == "attention_bwd_plain":
                            errs["attn_bwd" + path] = max(errs.get("attn_bwd" + path, 0.0), e)
                if dtype_name == "bfloat16":
                    launch_errs = check_bwd_launches(fa, q, k, v, m, o, l_, dout, p, s,
                                                     f"p={p} {tag}")
                    for name, e in launch_errs.items():
                        if not pad_row and p:
                            errs[name + path] = max(errs.get(name + path, 0.0), e)
                    if p:
                        check_bwd_replays(fa, q, k, v, m, o, l_, dout, p, s, tag)
                if not rows.all():
                    if any(g[~rows].abs().max().item() != 0.0 for g in got):
                        fail("a fully padded row must get exactly zero gradients")
                    print(f"  fully padded row: dq = dk = dv = 0 (p={p}) ok", flush=True)


# More (b, h) pairs than grid y's 65535: 5462 rows of 12 heads, at one key
# tile (T = 1) and two (T = 80), the student's head size
BIG_BH = (5462, 12, 40)
BIG_BH_HEAD = 16  # rows of the big call held bit for bit against a call on them alone


def check_attention_past_65535(fa, gen, dev):
    """K2 (p = 0 and p = 0.1) and the whole backward at B x H = 65544, T = 1
    and 80, ragged masks, bf16 and fp32, against the plain versions
    (``compare``'s tolerances); the first ``BIG_BH_HEAD`` rows bit for bit
    against a call on those rows alone, whose Philox words are the same.
    Returns the worst bf16 error of the forward and of the backward."""
    import torch

    b, h, d = BIG_BH
    worst = {"fwd": 0.0, "bwd": 0.0}
    for t in (1, 80):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v, dout, m = attention_case(gen, b, t, h, d, dtype, dev, False)
            rows = ~m.all(-1)
            for p in (0.0, ATTN_P):
                seed = seed_words(gen, dev) if p else None
                tag = f"{dtype_name} {(b, t, h, d)} p={p}"

                def both(n):
                    out, lse = fa.flash_attention(q[:n], k[:n], v[:n], m[:n], dropout_p=p,
                                                  seed=seed, return_lse=True)
                    return (out, lse) + tuple(fa._flash_bwd_cuda(
                        q[:n], k[:n], v[:n], m[:n], out, lse, dout[:n], p, seed))

                got = both(b)
                want, want_lse = fa.attention_plain(q, k, v, m, p, seed)
                torch.cuda.synchronize()
                e = compare(f"K2 {tag}", got[0], want, dtype_name, rows)
                compare(f"K2 lse {tag}", got[1], want_lse, "float32", rows)
                del want, want_lse
                wants = fa.attention_bwd_plain(q, k, v, m, got[0], got[1], dout, p, seed)
                torch.cuda.synchronize()
                eb = max(compare(f"attention backward {name} {tag}", g, w, dtype_name, rows)
                         for name, g, w in zip(("dq", "dk", "dv"), got[2:], wants))
                del wants
                if any((g[~rows] != 0).any().item() for g in got[2:]):
                    fail(f"attention backward {tag}: a fully padded row has a gradient")
                head = both(BIG_BH_HEAD)
                if not all(torch.equal(a[:BIG_BH_HEAD], a16) for a, a16 in zip(got, head)):
                    fail(f"attention {tag}: rows b < {BIG_BH_HEAD} differ from a call on "
                         f"those rows alone")
                print(f"  {tag} (B x H = {b * h}): rows b < {BIG_BH_HEAD} bit-identical to a "
                      f"call on them alone ok", flush=True)
                if dtype_name == "bfloat16":
                    worst["fwd"], worst["bwd"] = max(worst["fwd"], e), max(worst["bwd"], eb)
                del got, head
            del q, k, v, dout, m
            torch.cuda.empty_cache()
    return worst


def check_seeded_dropout(kd, shape, gen, dev, dtypes=None):
    """K5 against seeded_dropout_plain at ``shape``, in each of ``dtypes``
    (fp32 and bf16 by default): bit-identical forward and backward, and the
    keep-rate within 4 sigma."""
    import torch

    dtypes = dtypes or (torch.float32, torch.bfloat16)
    for dtype in dtypes:
        dtype_name = str(dtype).removeprefix("torch.")
        x = torch.rand(shape, generator=gen).to(dev, dtype).requires_grad_()
        cot = torch.randn(shape, generator=gen).to(dev, dtype)
        seed = seed_words(gen, dev)
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


def loop_config(exp, tmp, pt, libri, run, epochs, log_every):
    """``exp`` on the loop phase's teacher ``pt`` and corpus ``libri``, its
    run in ``<tmp>/<run>``."""
    return dataclasses.replace(
        exp, teacher=dataclasses.replace(exp.teacher, teacher_model=pt),
        data=dataclasses.replace(exp.data, libri_root=libri,
                                 bucketing_path=os.path.join(tmp, "len_for_bucket"),
                                 train_set=("train-clean-100",), dev_set=("dev-clean",)),
        train=dataclasses.replace(exp.train, output_dir=os.path.join(tmp, run),
                                  num_epochs=epochs, log_every=log_every))


def loop_phase(exp, geom, teacher_cpu, per_step, per_eval, smi, tmp):
    """The training loop end to end on ``exp``: a fairseq HuBERT .pt written
    from ``teacher_cpu``'s weights, a WAV corpus decoded by the native
    decoder (both in ``tmp``), three runs (1 epoch; resumed to 2; 2 from
    scratch), the launches of every step (``per_step``) and eval batch
    (``per_eval``), the export served against the student's own forward, and
    a 20-step run at the default logging cadence for the loop's rates.
    Returns the teacher's .pt and the corpus root."""
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
            result = run_training(loop_config(exp, tmp, pt, libri, run_dir, epochs, log_every),
                                  resume=resume, device="cuda")
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
    return pt, libri


# ---- the rehearsal ([rehearsal]): the port's dress rehearsal and probes
REHEARSAL_CONFIG = "configs/rehearsal.yaml"
# The rehearsal at the config's own length (train.max_steps 240) and the JAX
# harness's SIGTERM step. Cut to 40 steps (SIGTERM after 20), the student's
# features failed the CTC probe's rule at every setting tried on an H100
# (60 utterances x 6000 steps: CER 0.831 against the control's 0.847; 60 x
# 300: 0.746 / 0.831; 24 x 300: 0.907 / 0.926; 16 x 60: 0.861 / 0.806),
# while after 240 steps it passed at 60 x 6000 (0.576 / 0.864).
REHEARSAL_SIGTERM = 100
# the framewise probe at the probe CLI's defaults (utterances, classes, steps)
PROBE_ARGS = (24, 4, 300)
# the CTC probe at run_ctc_probe's defaults (utterances, steps): ~100 s on
# an H100, two heads of 6000 steps each replayed as a CUDA graph
CTC_PROBE_ARGS = (60, 6000)
REHEARSAL_TIMEOUT = 900  # seconds for the whole harness, from its start


def start_rehearsal(tmp):
    """Start the port's dress rehearsal (fithubert_tpu_torch/scripts/
    dress_rehearsal.py) on the card in the background: REHEARSAL_CONFIG at
    the release geometry, SIGTERM after step REHEARSAL_SIGTERM, the
    preemption checkpoint, the resume, the export pair and the CTC probe on
    it (CTC_PROBE_ARGS), each training process's launches written through
    ``FITHUBERT_LAUNCH_COUNTS``. It shares the card with the phases that
    follow until ``rehearsal_phase`` reads it; the harness and its
    children end with this script in any case."""
    root = os.path.dirname(os.path.abspath(__file__))
    paths = {name: os.path.join(tmp, name) for name in (
        "rehearsal", "rehearsal_report", "rehearsal_launches.jsonl", "rehearsal.out",
        "rehearsal.err")}
    n_utts, steps = CTC_PROBE_ARGS
    cmd = [sys.executable, "-m", "fithubert_tpu_torch.scripts.dress_rehearsal",
           "--config", REHEARSAL_CONFIG, "--sigterm-after", str(REHEARSAL_SIGTERM),
           "--set", f"train.output_dir={paths['rehearsal']}", "--out", paths["rehearsal_report"],
           "--probe-utts", str(n_utts), "--probe-steps", str(steps)]
    with open(paths["rehearsal.out"], "w") as out, open(paths["rehearsal.err"], "w") as err:
        proc = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=err, start_new_session=True,
                                env={**os.environ,
                                     "FITHUBERT_LAUNCH_COUNTS": paths["rehearsal_launches.jsonl"]})

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    atexit.register(stop)
    return proc, time.perf_counter(), paths


def rehearsal_phase(started, smi):
    """The dress rehearsal that ``start_rehearsal`` started: its chain
    (SIGTERM, the checkpoint, the resume with a continuous loss, the
    export, the CTC probe under the probe CLI's rule) and its launches:
    those of the training step alone exactly the release step's times the
    process's steps, the rest at least that. Then on the export: fp32
    features on the card against the CPU, and the framewise probe at the
    CLI's defaults on the card with its launches counted, under the CLI's
    rule."""
    import torch

    from fithubert_tpu_torch.config import load_experiment_yaml, load_yaml_config
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.teacher import TeacherGeometry
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import dropout as kd
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.scripts import linear_probe as lp

    proc, t0, paths = started
    root = os.path.dirname(os.path.abspath(__file__))
    exp_r = load_experiment_yaml(os.path.join(root, REHEARSAL_CONFIG))
    per_step = release_per_step(exp_r, TeacherGeometry.from_teacher_config(exp_r.teacher))
    run, report, counts = paths["rehearsal"], paths["rehearsal_report"], \
        paths["rehearsal_launches.jsonl"]
    n_utts, steps = CTC_PROBE_ARGS
    try:
        proc.wait(timeout=max(1.0, REHEARSAL_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"the dress rehearsal did not end within {REHEARSAL_TIMEOUT} s")
    stdout, stderr = (open(paths[n]).read() for n in ("rehearsal.out", "rehearsal.err"))
    wall = time.perf_counter() - t0
    log = os.path.join(report, "dress_rehearsal_gpu.log")
    try:  # its last line: the summary, written once the CTC probe has run
        summary = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        summary = {}
    # exit 1 with a summary whose probe failed: the CTC probe's verdict alone
    probe_only = proc.returncode == 1 and summary.get("probe_rc", 0) != 0
    if proc.returncode != 0 and not probe_only:
        tail = open(log).read()[-3000:] if os.path.exists(log) else ""
        fail(f"the dress rehearsal exited {proc.returncode}:\n{stdout[-2000:]}\n"
             f"{stderr[-3000:]}\n{tail}")
    print(f"  train_torch.py -c {REHEARSAL_CONFIG} (train.max_steps {exp_r.train.max_steps}): "
          f"SIGTERM at step {summary['preempt_step']}, [preemption] checkpointed step "
          f"{summary['checkpointed_step']}, rc 0 ({summary['phase1_s']} s); resumed from step "
          f"{summary['resumed_from']}, loss {summary['preempt_loss']} -> "
          f"{summary['post_resume_loss']} at step {summary['post_resume_step']} (relative "
          f"{summary['loss_continuity_rel']}, limit 0.35), final step {summary['final_step']} "
          f"loss {summary['final_loss']} ({summary['phase2_s']} s)", flush=True)
    print(f"  CTC probe on the export ({n_utts} utterances, {steps} steps, on the card, "
          f"{summary['probe_s']} s): {summary['probe_tail']}; {json.dumps(summary['probe'])}",
          flush=True)
    if not summary.get("ok"):
        fail_at_end(f"the dress rehearsal's CTC probe: {summary['probe_tail']}")
    with open(counts) as f:
        runs = [json.loads(line) for line in f]
    if len(runs) != 2:
        fail(f"{len(runs)} launch records for the rehearsal's two training runs")
    step_only = (cf.KERNEL_BWD, kd.KERNEL, fa.KERNEL_DROPOUT, *fa.BWD_KERNELS)  # no eval runs them
    for what, got, n in (("preempted", runs[0], summary["checkpointed_step"]),
                         ("resumed", runs[1], summary["final_step"] - summary["resumed_from"])):
        if any(got.get(name, 0) != per_step[name] * n for name in step_only) or \
                any(got.get(name, 0) < per_step[name] * n for name in per_step):
            fail(f"the {what} run's launches {got} over {n} steps and its evals, the release "
                 f"step's {per_step}")
        print(f"  launches of the {what} run: {json.dumps(got)} ({n} steps, each the release "
              f"step's, and its evals) ok", flush=True)

    pt, yml = os.path.join(run, "student.pt"), os.path.join(run, "student.yaml")
    cfg32 = dataclasses.replace(load_yaml_config(yml), compute_dtype="float32")
    wavs, _texts = lp.make_spoken_dataset(8, seed=0)
    outs = [UpstreamExpert(pt, cfg32, device=where, length_quantum=8000)(wavs)
            for where in ("cuda", "cpu")]
    worst = 0.0
    for g, c in zip((outs[0]["last_hidden_state"], *outs[0]["hidden_states"]),
                    (outs[1]["last_hidden_state"], *outs[1]["hidden_states"])):
        err = (g.cpu() - c).abs()
        worst = max(worst, err.max().item())
        if not bool((err <= E2E_ATOL + E2E_RTOL * c.abs()).all()):
            fail(f"the export's fp32 features, card vs CPU: max_abs_err {err.max().item():.3e}")
    print(f"  the export's fp32 features on the card vs the CPU (8 spoken utterances, "
          f"{1 + len(outs[0]['hidden_states'])} outputs): max_abs_err={worst:.3e} "
          f"tol=({E2E_ATOL}, {E2E_RTOL}) ok", flush=True)
    del outs

    n_utts, n_classes, steps = PROBE_ARGS
    expert = UpstreamExpert(pt, yml, device="cuda", length_quantum=8000)
    expert([wavs[0]])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = lp.run_probe(expert, n_utts, n_classes, steps)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    probe_launches = dict(_build.LAUNCHES)
    want = set(plus_pos_conv({cf.KERNEL_PREFIX: 1, cf.KERNEL: 1, fa.KERNEL: 1},
                             load_yaml_config(yml), 1, teacher=False, backward=False))
    if set(probe_launches) != want:
        fail(f"the probe's forwards launched {probe_launches}, not K1, its prefix, K2 and the "
             f"positional conv")
    ok = lp.probe_passed(res)
    print(f"  framewise probe on the export ({n_utts} utterances, {n_classes} classes, {steps} "
          f"steps, bf16 features, {probe_s:.1f} s): PROBE {'PASSED' if ok else 'FAILED'}: "
          f"acc {res['probe_acc']:.3f} vs control {res['control_acc']:.3f}; "
          f"{json.dumps(res)}; launches {json.dumps(probe_launches)}", flush=True)
    if not ok:
        fail("the framewise probe did not beat its shuffled control by the CLI's rule")
    print(f"  [rehearsal] harness wall {wall:.1f} s from its start, beside the phases "
          f"between [loop] and [tp]; {smi}", flush=True)
    del expert
    torch.cuda.empty_cache()


# ---- data parallelism ([dp]) and the rest of export ([export])
# The [dp] gloo ranks share the one card and stage every collective through
# the host, so their times measure gloo on this host, not data-parallel
# speed; NCCL runs here as one rank only (two NCCL ranks on one card are
# refused), so no number below is a scaling number.
DP_WORLD = 2
DP_RANK_TIMEOUT = 300  # seconds for a launch of ranks; a lost rendezvous would hang
ALL_REDUCE_REPS = 3
LIGHTNING_MODULE = "pytorch_lightning.callbacks.model_checkpoint"


def gloo_rank_setup():
    """This spawned rank's gloo group on the one card: (DataParallel, device)."""
    import torch
    import torch.distributed as dist

    from fithubert_tpu_torch.parallel.distributed import DataParallel

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return DataParallel.from_process_group(), dev


def gloo_step_rank(spec_path, out_dir):
    """One of the [dp] gloo ranks: for each case of the spec, a data-parallel
    Distiller takes one step per global batch on this rank's stripe of rows;
    per step its logs, launches (counts zeroed just before), wall time, and
    whether its parameters equal rank 0's bit for bit. Rank 0 saves the fp32
    case's final parameters; then both time the gradient all-reduce, and
    draw their first dropout keep mask. The result holds no tensor: a
    tensor would reach the parent through shared memory that this process,
    which exits next, owns."""
    import torch
    import torch.distributed as dist

    from fithubert_tpu_torch.ops.dropout import DropoutRNG
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.step import Distiller

    dp, dev = gloo_rank_setup()
    spec = torch.load(spec_path, weights_only=False)
    out = {}
    for case in ("fp32", "bf16"):
        c = spec[case]
        d = Distiller(c["exp"], spec["t_state"], spec["s_state"], device=dev,
                      num_training_steps=20, dp=dp)
        steps = []
        for batch in c["batches"]:
            local = {k: v[:, dp.rank::dp.world] for k, v in batch.items()}
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            logs = d.train_step(local, spec["rand"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(_build.LAUNCHES)
            flat = torch.cat([p.detach().reshape(-1) for p in d.params])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            steps.append(dict(logs=logs, launches=launches, ms=ms,
                              same_as_rank0=bool(torch.equal(flat, ref))))
        out[case] = {"steps": steps}
        if case == "fp32" and dp.rank == 0:
            torch.save({n: p.detach().cpu() for n, p in d.student.state_dict().items()},
                       os.path.join(out_dir, "fp32_params.pt"))
        if case == "bf16":
            grads = [p.grad for p in d.params]
            times = []
            for _ in range(ALL_REDUCE_REPS):
                dp.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dp.all_reduce_grads(grads)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            rng = DropoutRNG(d._seed(0), dev)
            out[case].update(
                all_reduce_ms=times, grad_bytes=sum(g.numel() * g.element_size() for g in grads),
                seed_words=rng.seed_words().tolist(),
                keep=(rng.dropout(torch.ones(1 << 16, device=dev), ATTN_P) != 0).cpu().numpy())
        del d
        torch.cuda.empty_cache()
    return out


def dp_nccl_phase(exp, t_state, s_state, batches, rand_layers, per_step, gen, smi):
    """[dp] NCCL, one rank: the process group on the card, two release steps
    through the data-parallel path against the plain Distiller on the same
    batches, bit for bit, each launching the release step's kernels; the
    world-1 gradient all-reduce timed on the card; then ``nccl_slice12``."""
    import torch
    import torch.distributed as dist

    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.parallel.distributed import DataParallel, free_port
    from fithubert_tpu_torch.train.step import Distiller

    dev = torch.device("cuda", 0)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        dp = DataParallel.from_process_group()
        print(f"  process group: {dist.get_backend()}, rank {dp.rank} of {dp.world} on {dev}",
              flush=True)
        plain = Distiller(exp, t_state, s_state, device=dev, num_training_steps=20)
        via = Distiller(exp, t_state, s_state, device=dev, num_training_steps=20, dp=dp)
        for i, batch in enumerate(batches):
            lp = plain.train_step(batch, rand_layers)
            torch.cuda.synchronize()
            _build.reset_launches()
            lv = via.train_step(batch, rand_layers)
            torch.cuda.synchronize()
            if dict(_build.LAUNCHES) != per_step:
                fail(f"[dp] nccl step {i}: launches {dict(_build.LAUNCHES)}, want {per_step}")
            if lv != lp:
                fail(f"[dp] nccl step {i}: logs {lv} vs the plain step's {lp}")
            print(f"  step {i}: loss {lv['loss']!r} grad_norm {lv['grad_norm']!r} lr "
                  f"{lv['lr']!r} equal to the plain step's bit for bit; launches "
                  f"{json.dumps(dict(_build.LAUNCHES))} ok", flush=True)
        for (n, a), b in zip(plain.student.named_parameters(), via.params):
            if not torch.equal(a, b):
                fail(f"[dp] nccl: parameter {n} differs from the plain step's")
        print("  parameters after 2 steps equal to the plain Distiller's, bit for bit",
              flush=True)
        grads = [p.grad for p in via.params]
        flat = torch._utils._flatten_dense_tensors(grads)
        ar_ms = cuda_ms(lambda: dist.all_reduce(flat), reps=20)
        grads_ms = cuda_ms(lambda: dp.all_reduce_grads(grads), reps=20)
        print(f"  NCCL world-1 all_reduce of the {flat.numel() * 4 / 1e6:.1f} MB fp32 gradient "
              f"buffer: {ar_ms:.4f} ms; all_reduce_grads (flatten, all_reduce, copy back): "
              f"{grads_ms:.4f} ms (CUDA events, mean of 20); {smi}", flush=True)
        walls = {"plain": [], "dp": []}
        for _ in range(3):
            for name, d in (("plain", plain), ("dp", via), ("dp", via), ("plain", plain)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d.train_step(batches[-1], rand_layers)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        print(f"  release step wall, median of 6 interleaved: plain "
              f"{statistics.median(walls['plain']):.3f} ms, through the world-1 DP path "
              f"{statistics.median(walls['dp']):.3f} ms; {smi}", flush=True)
        del plain, via, grads, flat
        torch.cuda.empty_cache()
        nccl_slice12(exp, t_state, s_state, batches, rand_layers, dp, dev, gen, smi)
    finally:
        dist.destroy_process_group()


def nccl_slice12(exp, t_state, s_state, batches, rand_layers, dp, dev, gen, smi):
    """[dp] the slice's features through the NCCL path of one rank: the
    K-step CUDA graph with the gradient all-reduce captured, against K
    eager data-parallel steps from the same state; and
    checkpoint_activations on against off for a rel_pos conformer (cut to
    CONFORMER_DP_LAYERS layers) whose BatchNorm sums run over the ranks
    again in each recompute. Both bit for bit."""
    import torch

    from fithubert_tpu_torch.config import conformer_experiment
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.train.step import Distiller

    run = [batches[i % len(batches)] for i in range(CHAIN_K)]
    chained = Distiller(exp, t_state, s_state, device=dev, num_training_steps=20, dp=dp)
    eager = Distiller(exp, t_state, s_state, device=dev, num_training_steps=20, dp=dp)
    chained.train_step_chain(run, rand_layers)  # the eager warm-up, then the capture
    for batch in run:
        eager.train_step(batch, rand_layers)
    logs_g = [lg.to_floats() for lg in chained.train_step_chain(run, rand_layers)]
    logs_e = [eager.train_step(batch, rand_layers) for batch in run]
    diff, worst = _student_state_equal(chained, eager)
    if logs_g != logs_e or diff:
        fail(f"[dp] nccl chain: logs {logs_g} vs {logs_e}; {len(diff)} tensors differ "
             f"(worst {worst:.3e})")
    print(f"  steps_per_launch {CHAIN_K} through the NCCL path: the graph (its all-reduce "
          f"captured) == {CHAIN_K} eager data-parallel steps, logs and parameters bit for bit "
          f"ok; losses {[round(lg['loss'], 6) for lg in logs_g]}", flush=True)
    del chained, eager
    torch.cuda.empty_cache()
    exp_c = conformer_experiment("rel_pos")
    exp_c = dataclasses.replace(exp_c, distiller=dataclasses.replace(
        exp_c.distiller, encoder_layers=CONFORMER_DP_LAYERS))
    c_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
    rand = torch.randperm(CONFORMER_DP_LAYERS - 1, generator=gen)
    a, b = exp_c.train.accumulate_grad_batches, exp_c.train.batch_size
    batch = train_batch(gen, a, b, 12.0, ragged=True)
    runs = []
    for remat in (False, True):
        er = dataclasses.replace(exp_c, distiller=dataclasses.replace(
            exp_c.distiller, checkpoint_activations=remat))
        d = Distiller(er, t_state, c_state, device=dev, num_training_steps=20, dp=dp)
        runs.append((d, d.train_step(batch, rand)))
    (d0, l0), (d1, l1) = runs
    diff, worst = _student_state_equal(d0, d1)
    if l0 != l1 or diff:
        fail(f"[dp] nccl remat: logs {l0} vs {l1}; {len(diff)} tensors differ (worst "
             f"{worst:.3e}), first {diff[:3]}")
    print(f"  checkpoint_activations through the NCCL path, rel_pos conformer cut to "
          f"{CONFORMER_DP_LAYERS} layers, a ragged step of {a} microbatches: loss "
          f"{l0['loss']:.6f}, parameters and BatchNorm statistics bit for bit with the flag "
          f"on and off ok; {smi}", flush=True)
    del runs, d0, d1
    torch.cuda.empty_cache()


def dp_gloo_phase(exp, exp32, t_state, s_state, rand_layers, gen, per_step, tmp, smi):
    """[dp] two gloo ranks sharing the card, full width: fp32 without dropout
    against one process on the same global batch; the release step in bf16
    with dropout, its parameters bit-identical across the ranks after each
    step, its launches per rank the release step's, its keep masks differing
    between the ranks."""
    import torch

    from fithubert_tpu_torch.parallel.distributed import launch
    from fithubert_tpu_torch.train.step import Distiller

    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size
    spec = {"t_state": t_state, "s_state": s_state, "rand": rand_layers,
            "fp32": {"exp": exp32, "batches": [train_batch(gen, 2, DP_WORLD, 3.0, ragged=True),
                                               train_batch(gen, 2, DP_WORLD, 3.0, ragged=False)]},
            "bf16": {"exp": exp, "batches": [train_batch(gen, a, DP_WORLD * b, 12.0, ragged=True),
                                             train_batch(gen, a, DP_WORLD * b, 12.0,
                                                         ragged=False)]}}
    for case in ("fp32", "bf16"):
        mask = spec[case]["batches"][0]["padding_mask"]
        fake = [int(mask[:, r::DP_WORLD].all(-1).sum()) for r in range(DP_WORLD)]
        print(f"  {case}: global batches {tuple(mask.shape)}, each rank {mask.shape[0]} x "
              f"{mask.shape[1] // DP_WORLD} rows; fabricated rows per rank in the ragged one "
              f"{fake}", flush=True)
    spec_path = os.path.join(tmp, "dp_spec.pt")
    torch.save(spec, spec_path)
    t0 = time.perf_counter()
    try:
        ranks = launch(gloo_step_rank, DP_WORLD, spec_path, tmp, timeout=DP_RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"[dp] gloo ranks: {e}")
    print(f"  {DP_WORLD} ranks spawned, joined and done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # fp32: the ranks against one process on the whole global batch
    one = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20)
    for i, batch in enumerate(spec["fp32"]["batches"]):
        want = one.train_step(batch, rand_layers)
        for r, rank in enumerate(ranks):
            got = rank["fp32"]["steps"][i]["logs"]
            for key in ("loss", "grad_norm"):
                rel = abs(got[key] - want[key]) / abs(want[key])
                if rel > TRAIN_RTOL:
                    fail(f"[dp] gloo fp32 step {i} rank {r}: {key} {got[key]} vs one process "
                         f"{want[key]} (rel {rel:.3e})")
            if got["lr"] != want["lr"] or not rank["fp32"]["steps"][i]["same_as_rank0"]:
                fail(f"[dp] gloo fp32 step {i} rank {r}: lr or parameters differ")
        print(f"  fp32 step {i}: loss {want['loss']:.8f} (ranks "
              f"{[rk['fp32']['steps'][i]['logs']['loss'] for rk in ranks]}), grad_norm "
              f"{want['grad_norm']:.8f}, tol rel {TRAIN_RTOL} ok", flush=True)
    got_params = torch.load(os.path.join(tmp, "fp32_params.pt"), weights_only=True)
    worst = max((got_params[n] - p.detach().cpu()).abs().max().item()
                for n, p in one.student.state_dict().items())
    if worst > TRAIN_PARAM_ATOL:
        fail(f"[dp] gloo fp32: parameters differ from one process's by {worst:.3e}")
    print(f"  fp32 parameters after 2 steps vs one process: max_abs_err={worst:.3e} "
          f"tol={TRAIN_PARAM_ATOL} ok", flush=True)
    del one
    torch.cuda.empty_cache()

    # bf16 with the release dropout
    for i in range(2):
        steps = [rank["bf16"]["steps"][i] for rank in ranks]
        for r, st in enumerate(steps):
            if st["launches"] != per_step:
                fail(f"[dp] gloo bf16 step {i} rank {r}: launches {st['launches']}, "
                     f"want {per_step}")
            if not st["same_as_rank0"] or st["logs"] != steps[0]["logs"]:
                fail(f"[dp] gloo bf16 step {i} rank {r}: parameters or logs differ from rank 0")
            if not all(math.isfinite(v) for v in st["logs"].values()):
                fail(f"[dp] gloo bf16 step {i}: non-finite logs {st['logs']}")
        print(f"  bf16 step {i}: loss {steps[0]['logs']['loss']:.6f} grad_norm "
              f"{steps[0]['logs']['grad_norm']:.6f} on both ranks; parameters bit-identical "
              f"across the ranks; launches per rank {json.dumps(steps[0]['launches'])} ok; "
              f"wall per rank {[round(st['ms'], 3) for st in steps]} ms", flush=True)
    r0, r1 = (rank["bf16"] for rank in ranks)
    if r0["seed_words"] == r1["seed_words"] or (r0["keep"] == r1["keep"]).all():
        fail("[dp] gloo: the ranks drew the same dropout keep masks")
    agree = float((r0["keep"] == r1["keep"]).mean())
    print(f"  dropout: first attention seed words {r0['seed_words']} vs {r1['seed_words']}; "
          f"the ranks' first keep masks agree on {agree:.3f} of 65536 positions (independent "
          f"at p = {ATTN_P}: {1 - 2 * ATTN_P * (1 - ATTN_P):.3f}) ok", flush=True)
    print(f"  gloo all_reduce_grads of {r0['grad_bytes'] / 1e6:.1f} MB on CUDA tensors (staged "
          f"through the host), host clock per rank: "
          f"{[[round(t, 3) for t in rk['bf16']['all_reduce_ms']] for rk in ranks]} ms; {smi}",
          flush=True)


def gloo_loop_rank(cfg):
    """One of the [dp] loop's gloo ranks: run_training on the card, each
    step's launches counted. Returns (result, launches per step)."""
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.step import Distiller

    _, dev = gloo_rank_setup()
    step_launches = []
    plain_step = Distiller.train_step_async

    def counted_step(self, batch, rand):
        before = dict(_build.LAUNCHES)
        out = plain_step(self, batch, rand)
        step_launches.append({n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
                              if c != before.get(n, 0)})
        return out

    Distiller.train_step_async = counted_step
    return run_training(cfg, resume=False, device=dev), step_launches


def dp_loop_phase(exp, tmp, pt, libri, per_step, smi):
    """[dp] the loop over two gloo ranks: one epoch on the loop phase's WAVs
    (a global batch of 6 rows, so 24 WAVs make one step of 4 x 3 per rank),
    one checkpoint, each step logged once, and an export that serves."""
    import torch

    from fithubert_tpu_torch.data.librispeech import quantize_length
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.parallel.distributed import launch
    from fithubert_tpu_torch.train.checkpoint import CheckpointManager

    cfg = loop_config(exp, tmp, pt, libri, "dp_loop", 1, 1)
    t0 = time.perf_counter()
    try:
        ranks = launch(gloo_loop_rank, DP_WORLD, cfg, timeout=DP_RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"[dp] loop ranks: {e}")
    wall = time.perf_counter() - t0
    results = [r[0] for r in ranks]
    if results[0] != results[1] or results[0]["steps"] != 1 or results[0]["preempted"]:
        fail(f"[dp] loop: the ranks returned {results}, want 1 step each, alike")
    for r, (_, launches) in enumerate(ranks):
        if launches != [per_step]:
            fail(f"[dp] loop rank {r}: launches per step {launches}, want [{per_step}]")
    run_dir = os.path.join(tmp, "dp_loop")
    train, val = logged(run_dir)
    if sorted(train) != [1] or len(val) != 1:
        fail(f"[dp] loop: metrics.jsonl holds train steps {sorted(train)} and {len(val)} "
             f"val records, want [1] and 1 (rank 0 alone writes)")
    ckpt = os.path.join(run_dir, "ckpt")
    for sub, want in (("best", {"index.json", "step_1.pt"}), ("last", {"step_1.pt"})):
        if set(os.listdir(os.path.join(ckpt, sub))) != want:
            fail(f"[dp] loop: {sub}/ holds {os.listdir(os.path.join(ckpt, sub))}")
    print(f"  {DP_WORLD} ranks: {results[0]}; each launched {json.dumps(per_step)} in its "
          f"step; one checkpoint (best/ + last/ step_1.pt), one train and one val record; loss "
          f"{train[1]['loss']:.6f}, val v_loss {val[0]['val/v_loss']:.6f}; wall {wall:.1f} s "
          f"(spawn, set-up, decode, step, eval, save, export); {smi}", flush=True)
    state = CheckpointManager(ckpt).restore()
    student = StudentModel(exp.distiller, device="cuda")
    student.load_state_dict(state["student"])
    student.eval()
    gen = torch.Generator().manual_seed(8)
    wavs = [torch.randn(int(s * SR), generator=gen) * 0.1 for s in (2.9, 6.4)]
    got = UpstreamExpert(os.path.join(run_dir, "student.pt"), exp.distiller, device="cuda")(wavs)
    t_pad = quantize_length(max(len(w) for w in wavs), SR)
    x = torch.zeros(len(wavs), t_pad)
    mask = torch.ones(len(wavs), t_pad, dtype=torch.bool)
    for i, w in enumerate(wavs):
        x[i, : len(w)], mask[i, : len(w)] = w, False
    want = student(x.cuda(), mask.cuda())
    if not torch.equal(got["last_hidden_state"], want.x):
        fail("[dp] loop: the export's features differ from the checkpoint's student")
    print(f"  the export pair (student.pt) served B=2: last_hidden_state "
          f"{tuple(want.x.shape)} equal to the checkpoint's student, bit for bit", flush=True)


def write_lightning_ckpt(path, student_sd, teacher_sd):
    """A .ckpt shaped as Lightning saves the reference's distiller: the
    weights under state_dict with the module prefixes, the trainer's state,
    and a ModelCheckpoint object of a module that is not installed (it exists
    only while the file is written)."""
    import types

    import torch

    names = LIGHTNING_MODULE.split(".")
    mods = {".".join(names[:i + 1]): types.ModuleType(".".join(names[:i + 1]))
            for i in range(len(names))}
    if set(mods) & set(sys.modules):
        fail(f"{LIGHTNING_MODULE} is installed here: the .ckpt would not need the stubs")
    cls = type("ModelCheckpoint", (), {"__module__": LIGHTNING_MODULE})
    mods[LIGHTNING_MODULE].ModelCheckpoint = cls
    callback = cls()
    callback.best_model_path, callback.monitor = "epoch=99.ckpt", "v_loss"
    sd = {**{f"student_model.{k}": v for k, v in student_sd.items()},
          **{f"teacher_model.{k}": v for k, v in teacher_sd.items()}}
    sys.modules.update(mods)
    try:
        torch.save({"epoch": 99, "global_step": 23400, "pytorch-lightning_version": "1.5.10",
                    "state_dict": sd, "callbacks": {"ModelCheckpoint": callback},
                    "optimizer_states": [{"state": {}, "param_groups": [{"lr": 5e-4,
                                                                         "params": []}]}],
                    "lr_schedulers": [{"last_epoch": 23400}]}, path)
    finally:
        for name in mods:
            del sys.modules[name]


def export_phase(exp, s_state, t_state, libri, tmp, smi):
    """[export] a full-width release-student Lightning .ckpt, loaded through
    fithubert_tpu_torch/hubconf.py, against UpstreamExpert on the state
    dict, bit for bit; then python -m ...extract_features on the loop
    phase's WAVs, each .npy against the expert's forward of the same batch,
    bit for bit, with its frame count."""
    import glob

    import numpy as np
    import torch

    from fithubert_tpu_torch.config import dump_config
    from fithubert_tpu_torch.data import audio
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.export.extract_features import output_names
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(tmp, "FitHuBERT-960h.ckpt")
    yaml_path = os.path.join(tmp, "FitHuBERT-960h.yaml")
    write_lightning_ckpt(ckpt, s_state, t_state)
    dump_config(exp, yaml_path)
    print(f"  wrote a Lightning-shaped .ckpt ({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB: "
          f"student_model.* + teacher_model.*, trainer state, a {LIGHTNING_MODULE} object) "
          f"and its YAML", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hub = torch.hub.load(os.path.join(root, "fithubert_tpu_torch"), "fithubert", ckpt, yaml_path,
                         source="local", device="cuda")
    torch.cuda.synchronize()
    hub_s = time.perf_counter() - t0
    pt = os.path.join(tmp, "student.pt")
    torch.save(s_state, pt)
    t0 = time.perf_counter()
    plain = UpstreamExpert(pt, exp.distiller, device="cuda")
    torch.cuda.synchronize()
    pt_s = time.perf_counter() - t0
    if hub.cfg != exp.distiller:
        fail(f"[export] the hub's config {hub.cfg} is not the release student's")
    gen = torch.Generator().manual_seed(9)
    wavs = ragged_wavs(gen, 3, 2.0, 16.0)
    _build.reset_launches()
    got = hub(wavs)
    torch.cuda.synchronize()
    served = dict(_build.LAUNCHES)
    want = plain(wavs)
    for g, w in zip((got["last_hidden_state"], *got["hidden_states"], got["padding_mask"]),
                    (want["last_hidden_state"], *want["hidden_states"], want["padding_mask"])):
        if not torch.equal(g, w):
            fail("[export] the hub's .ckpt expert differs from UpstreamExpert on the state dict")
    print(f"  torch.hub.load(fithubert_tpu_torch, 'fithubert', .ckpt, .yaml, source='local'): "
          f"B=3 ragged features equal to UpstreamExpert(student.pt), bit for bit; launches "
          f"{json.dumps(served)}; load {hub_s:.3f} s (the .pt: {pt_s:.3f} s); {smi}", flush=True)

    # train-clean-100 and dev-clean share file names: the later ones get .1
    paths = sorted(glob.glob(os.path.join(libri, "*", "*", "*", "*.wav")))
    names = output_names(paths)
    out = os.path.join(tmp, "feats")
    batch_size = 8
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "fithubert_tpu_torch.export.extract_features",
                          "--ckpt", ckpt, "--config", yaml_path, "--inputs", *paths, "--out", out,
                          "--batch-size", str(batch_size)], cwd=root, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=root))
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"[export] extract_features exited {run.returncode}:\n{run.stderr[-3000:]}")
    if sorted(os.listdir(out)) != sorted(n + ".npy" for n in names.values()) or \
            len(set(names.values())) != len(paths):
        fail(f"[export] extract_features wrote {sorted(os.listdir(out))}")
    for i in range(0, len(paths), batch_size):
        chunk = paths[i: i + batch_size]
        feats = plain([audio.decode(p) for p in chunk])["last_hidden_state"]
        for j, p in enumerate(chunk):
            n = len(audio.decode(p))
            frames = 2 * (cf.out_len(n, exp.distiller.conv_feature_layers) // 2)
            saved = np.load(os.path.join(out, names[p] + ".npy"))
            if saved.shape != (frames, exp.distiller.pred_head_final_dim):
                fail(f"[export] {p}: .npy of shape {saved.shape}, want {frames} frames")
            if not np.array_equal(saved, feats[j, :frames].float().cpu().numpy()):
                fail(f"[export] {p}: the .npy differs from the expert's forward")
    print(f"  python -m fithubert_tpu_torch.export.extract_features: {len(paths)} WAVs in "
          f"batches of {batch_size}, one .npy each ({sum('.' in n for n in names.values())} "
          f"repeated file names with a .1) with its frame count, equal to the expert's "
          f"forward of the same batch, bit for bit; wall {wall:.1f} s (a new process: "
          f"imports, the .ckpt read, decode, forwards); {smi}", flush=True)


# ---- the DistilHuBERT-style student of configs/ex.yaml ([ex]) and the CTC path ([ctc])
# Steps of the ex and CTC phases on their fixed batches after the ragged step.
EX_STEPS = 6
CTC_STEPS = 5
# A seeded CTC head emits letters on most frames, and those pseudo-labels
# cannot be aligned in the student's frames (CTC then returns optax's log(0)
# stand-in, -1e5, as a penalty). A fine-tuned CTC model emits blanks on most
# frames; the seeded head's blank bias is set so that it does on this share
# of the fixed batch's frames.
CTC_BLANK_SHARE = 0.75
# The ex fp32 steps, card vs CPU: the ex loss is L1, whose gradient sums
# signs, so an entry can sit near zero and take opposite signs on the two
# devices (fp32 summation order); AdamW then moves it by about +lr on one
# and -lr on the other. So each parameter's gradient is held norm-wise
# while both sides still hold the same weights (EX_GRAD_FRO; after one
# such flip the next gradients differ by more), the parameters to twice the
# lr summed over the steps, and the entries beyond TRAIN_PARAM_ATOL to a
# fraction EX_FLIP_FRACTION of all.
EX_GRAD_FRO, EX_FLIP_FRACTION = 1e-3, 1e-5


def attn_bwd(n):
    """The launches of n bf16 attention backwards: the pre-pass, the fused
    pass and the dQ sum, n each."""
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    return {name: n for name in fa.BWD_KERNELS}


def ex_per_step(exp_ex, geom):
    """The launches of one ex train step: K1 and the prefix on the student's
    and the teacher's extractors, the teacher's attention at p = 0, the
    student's at p = 0.1 with its backward, K6 over the student's stack
    (feature_grad_mult 1: every block trains), the positional conv's
    forwards and the student's input gradient."""
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    n_stack = len(exp_ex.distiller.conv_feature_layers) - 1
    l_s = exp_ex.distiller.encoder_layers
    return plus_pos_conv(plus_k5({cf.KERNEL: n_stack + len(geom.conv_feature_layers) - 1,
                                  cf.KERNEL_PREFIX: 2, fa.KERNEL: geom.encoder_layers,
                                  fa.KERNEL_DROPOUT: l_s, **attn_bwd(l_s),
                                  cf.KERNEL_BWD: 4 * n_stack}, exp_ex.distiller, 1),
                         exp_ex.distiller, 1)


def release_per_step(exp, geom):
    """The launches of one release train step (its microbatches folded
    into one forward): K1 on both extractors, one prefix each (block 0's
    GroupNorm), the teacher's K2 at p = 0, the student's K2 with dropout,
    the backward's three launches, K6's up, dW, ordered sum and da per layer, K5 at every
    elementwise dropout forward and backward, and the positional conv (the teacher's and
    the student's forwards, the student's input gradient)."""
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    cfg, n_stack = exp.distiller, len(exp.distiller.conv_feature_layers) - 1
    return plus_pos_conv(plus_k5({cf.KERNEL: n_stack + len(geom.conv_feature_layers) - 1,
                                  cf.KERNEL_PREFIX: 2, fa.KERNEL: geom.encoder_layers,
                                  fa.KERNEL_DROPOUT: cfg.encoder_layers,
                                  **attn_bwd(cfg.encoder_layers),
                                  cf.KERNEL_BWD: 4 * n_stack}, cfg, 1), cfg, 1)


def launches_of_step(d, batch, rand, want, what):
    """One train step with every count set to 0 just before it and read just
    after; fails unless they are ``want`` and the logs finite. Returns
    (logs, launches)."""
    import torch

    from fithubert_tpu_torch.ops.kernels import _build

    _build.reset_launches()
    logs = d.train_step(batch, rand)
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    if got != want:
        fail(f"{what}: launches {got}, want {want} per step")
    if not all(math.isfinite(v) for v in logs.values()):
        fail(f"{what}: non-finite logs {logs}")
    return logs, got


@contextlib.contextmanager
def counted_steps():
    """Each Distiller.train_step_async of the block appends its launches to
    the list yielded."""
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.step import Distiller

    record, plain = [], Distiller.train_step_async

    def counted(self, batch, rand):
        before = dict(_build.LAUNCHES)
        out = plain(self, batch, rand)
        record.append({n: c - before.get(n, 0) for n, c in _build.LAUNCHES.items()
                       if c != before.get(n, 0)})
        return out

    Distiller.train_step_async = counted
    try:
        yield record
    finally:
        Distiller.train_step_async = plain


def check_hint_init(cfg, s_rand, s_state, t_state, copied, skipped):
    """Every copied student tensor equals its teacher tensor (fp32) bit for
    bit, every other one is the student's own, and the copies are all the
    teacher's extractor, post_extract_proj, positional conv and first
    init_encoder_layers layers that the student has at the same shape."""
    import torch

    from fithubert_tpu_torch.models.surgery import transformer_slot

    slot_of = {transformer_slot(cfg, i): i for i in range(cfg.encoder_layers)}

    def teacher_key(name):
        if not name.startswith("encoder.layers."):
            return name
        slot, rest = name[len("encoder.layers."):].split(".", 1)
        return f"encoder.layers.{slot_of[int(slot)]}.{rest}"

    prefixes = ["encoder.pos_conv."] + [f"encoder.layers.{transformer_slot(cfg, i)}."
                                        for i in range(cfg.init_encoder_layers)]
    if cfg.init_conv_layers:
        prefixes += ["feature_extractor.", "post_extract_proj."]
    want = {k for k, v in s_rand.items() if k.startswith(tuple(prefixes))
            and teacher_key(k) in t_state and t_state[teacher_key(k)].shape == v.shape}
    if set(copied) != want:
        fail(f"hint-init copied {sorted(set(copied) ^ want)[:6]}... beyond or short of {len(want)}")
    for k, v in s_state.items():
        ref = t_state[teacher_key(k)] if k in want else s_rand[k]
        if not torch.equal(v, ref.float()):
            fail(f"hint-init: {k} is not {'the teacher' if k in want else 'the student'}'s "
                 f"tensor bit for bit")
    return len(copied), len(skipped)


def ex_phase(exp_ex, geom, t_state, gen, smi, tmp, pt, libri):
    """[ex] configs/ex.yaml at full width on the card: the hint-init, a
    ragged step and EX_STEPS on one batch with their launches, fp32 steps
    against the CPU, run_training with a resume bit for bit, and the export
    served in bf16 and fp32. Returns (the bf16 Distiller, its fixed batch,
    the launches per step, the served expert, the student on the CPU)."""
    import torch

    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.surgery import init_student_from_teacher
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.step import Distiller

    cfg = exp_ex.distiller
    student_cpu = StudentModel(cfg, device="cpu").init_weights(gen)
    s_rand = student_cpu.state_dict()
    s_state, copied, skipped = init_student_from_teacher(s_rand, t_state, cfg, verbose=False)
    n_copied, n_skipped = check_hint_init(cfg, s_rand, s_state, t_state, copied, skipped)
    student_cpu.load_state_dict(s_state)
    print(f"  hint-init (init_conv_layers, init_encoder_layers={cfg.init_encoder_layers}): "
          f"copied {n_copied} tensors, skipped {n_skipped}; each copy equals the teacher's "
          f"fp32 tensor bit for bit, every other tensor the student's own ok", flush=True)

    per_step = ex_per_step(exp_ex, geom)
    a, b = exp_ex.train.accumulate_grad_batches, exp_ex.train.batch_size
    d = Distiller(exp_ex, t_state, s_state, device="cuda", num_training_steps=20)
    logs, launches = launches_of_step(d, train_batch(gen, a, b, 12.0, ragged=True), None,
                                      per_step, "ex ragged step")
    if not all(torch.isfinite(p).all().item() for p in d.params):
        fail("ex ragged step: non-finite parameters")
    print(f"  step 0 (ragged {b} x {a}, one fabricated row, lr {logs['lr']}): loss "
          f"{logs['loss']:.6f} (layer3 {logs['layer3']:.6f}, layer7 {logs['layer7']:.6f}, "
          f"layer11 {logs['layer11']:.6f}) grad_norm {logs['grad_norm']:.6f}; launches "
          f"{json.dumps(launches)} ok", flush=True)
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    losses = [launches_of_step(d, fixed, None, per_step, f"ex step {i + 1}")[0]["loss"]
              for i in range(EX_STEPS)]
    if not losses[-1] < losses[0]:
        fail(f"ex: the loss did not fall over {EX_STEPS} steps: {losses}")
    print(f"  steps 1-{EX_STEPS} on one {b} x {a} x 12 s batch: loss "
          f"{[round(x, 6) for x in losses]} fell; every step launched prefix "
          f"{per_step[cf.KERNEL_PREFIX]}, K1 {per_step[cf.KERNEL]}, K2 teacher "
          f"{per_step[fa.KERNEL]} / student {per_step[fa.KERNEL_DROPOUT]}, the backward's "
          f"prep / fused / dQ sum {per_step[fa.KERNEL_BWD]} each, K6 {per_step[cf.KERNEL_BWD]} "
          f"ok", flush=True)

    print("[ex] fp32 steps without dropout, card vs CPU (plain versions), full width, "
          "1 x 2 s: step 0 at lr 0, then two at lr > 0", flush=True)
    exp32 = dataclasses.replace(
        exp_ex, train=dataclasses.replace(exp_ex.train, use_fp16=False),
        distiller=dataclasses.replace(cfg, compute_dtype="float32", dropout=0.0,
                                      attention_dropout=0.0, activation_dropout=0.0))
    small = train_batch(gen, 1, 1, 2.0, ragged=False)
    on_card = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20)
    on_cpu = Distiller(exp32, t_state, s_state, device="cpu", num_training_steps=20)
    names = [n for n, _ in on_cpu.student.named_parameters()]
    lr_sum = 0.0
    for i in range(3):
        lg, lc = on_card.train_step(small, None), on_cpu.train_step(small, None)
        same_weights = lr_sum == 0.0  # no update has moved them yet
        lr_sum += lg["lr"]
        for key in ("loss", "grad_norm", "layer3", "layer11"):
            rel = abs(lg[key] - lc[key]) / abs(lc[key])
            if rel > TRAIN_RTOL:
                fail(f"ex fp32 step {i}: {key} card {lg[key]} vs CPU {lc[key]} (rel {rel:.3e})")
        if not same_weights:
            print(f"  step {i} (lr {lg['lr']:.3e}): loss {lg['loss']:.8f} vs {lc['loss']:.8f}, "
                  f"grad_norm {lg['grad_norm']:.8f} vs {lc['grad_norm']:.8f} tol rel "
                  f"{TRAIN_RTOL} ok", flush=True)
            continue
        worst_g = 0.0
        g_total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                        for p in on_cpu.params]))
        for n, pg, pc in zip(names, on_card.params, on_cpu.params):
            ref = torch.linalg.vector_norm(pc.grad)
            if n.endswith("self_attn.k_proj.bias"):
                # zero in exact arithmetic (a softmax does not see a shift
                # of a query's logits): both sides hold rounding noise only
                if max(ref, torch.linalg.vector_norm(pg.grad).cpu()) > 1e-6 * g_total:
                    fail(f"ex fp32 step {i}: {n} has a gradient of norm {ref.item():.3e}")
                continue
            fro = (torch.linalg.vector_norm(pg.grad.cpu() - pc.grad) / ref).item()
            worst_g = max(worst_g, fro)
            if fro > EX_GRAD_FRO:
                fail(f"ex fp32 step {i}: the gradient of {n} differs by rel_fro {fro:.3e}")
        print(f"  step {i} (lr {lg['lr']:.3e}): loss {lg['loss']:.8f} vs {lc['loss']:.8f}, "
              f"grad_norm {lg['grad_norm']:.8f} vs {lc['grad_norm']:.8f} tol rel {TRAIN_RTOL}; "
              f"each parameter's gradient rel_fro <= {worst_g:.3e} tol {EX_GRAD_FRO} (the "
              f"k_proj biases' below 1e-6 of the whole on both) ok", flush=True)
    diffs = [(pg.detach().cpu() - pc.detach()).abs() for pg, pc in zip(on_card.params,
                                                                      on_cpu.params)]
    worst = max(d_.max().item() for d_ in diffs)
    flips = sum(int((d_ > TRAIN_PARAM_ATOL).sum()) for d_ in diffs)
    total = sum(d_.numel() for d_ in diffs)
    if worst > 2 * lr_sum or flips > EX_FLIP_FRACTION * total:
        fail(f"ex fp32 step: parameters differ by up to {worst:.3e} (limit {2 * lr_sum:.3e}), "
             f"{flips} of {total} beyond {TRAIN_PARAM_ATOL}")
    print(f"  parameters after 3 steps: max_abs_err={worst:.3e} (limit 2 x the summed lr "
          f"{2 * lr_sum:.3e}), {flips} of {total} entries beyond {TRAIN_PARAM_ATOL} (limit "
          f"{EX_FLIP_FRACTION} of them) ok", flush=True)
    del on_card, on_cpu, diffs

    print("[ex] run_training on ex over the loop phase's WAVs and teacher .pt (3 steps of "
          f"{b} x {a} an epoch, 2 epochs): stopped at max_steps 3 and resumed, and from "
          "scratch", flush=True)
    runs = {}
    for name, run_dir, max_steps, resume, want_steps in (("run 1", "ex_resumed", 3, True, 3),
                                                         ("run 2", "ex_resumed", 0, True, 6),
                                                         ("run 3", "ex_straight", 0, False, 6)):
        # one schedule for all three: the lr's decay spans num_epochs
        exp_run = dataclasses.replace(exp_ex, train=dataclasses.replace(
            exp_ex.train, num_devices=1, max_steps=max_steps))
        t0 = time.perf_counter()
        with counted_steps() as record:
            result = run_training(loop_config(exp_run, tmp, pt, libri, run_dir, 2, 1),
                                  resume=resume, device="cuda")
        torch.cuda.synchronize()
        if result["steps"] != want_steps or any(r != per_step for r in record):
            fail(f"ex loop {name}: {result}, launches per step {record}, want {want_steps} "
                 f"steps of {per_step}")
        runs[run_dir], val = logged(os.path.join(tmp, run_dir))
        if not all(math.isfinite(r["val/v_loss"]) for r in val):
            fail(f"ex loop {name}: val v_loss not finite")
        print(f"  {name}: {result['steps']} steps ({len(record)} in this run, each "
              f"launching the ex step's kernels), val v_loss "
              f"{[round(r['val/v_loss'], 6) for r in val]}, wall "
              f"{time.perf_counter() - t0:.1f} s ok", flush=True)
    resumed, straight = runs["ex_resumed"], runs["ex_straight"]
    for s in range(1, 7):
        for key in LOOP_RESUME_KEYS:
            if resumed[s][key] != straight[s][key]:
                fail(f"ex loop: step {s} {key} {resumed[s][key]!r} (runs 1 + 2) vs "
                     f"{straight[s][key]!r} (run 3): a resume must give the same bits")
    print(f"  steps 1-6, runs 1 + 2 vs run 3: {', '.join(LOOP_RESUME_KEYS)} bit for bit; loss "
          f"{[resumed[s]['loss'] for s in range(1, 7)]}", flush=True)

    print("[ex] export_student's pair served: 3 ragged requests in bf16, then fp32 on the "
          "card against the CPU", flush=True)
    pt_s = os.path.join(tmp, "ex_resumed", "student.pt")
    expert = UpstreamExpert(pt_s, cfg, device="cuda")
    requests = [[torch.randn(int(3.7 * SR), generator=gen) * 0.1],
                ragged_wavs(gen, 4, 2.0, 16.0),
                [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(8)]]
    for wav_list in requests:
        _build.reset_launches()
        out = expert(wav_list)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        n_stack = len(cfg.conv_feature_layers) - 1
        if got != plus_pos_conv({cf.KERNEL_PREFIX: 1, cf.KERNEL: n_stack,
                                 fa.KERNEL: cfg.encoder_layers}, cfg, 1, teacher=False,
                                backward=False):
            fail(f"ex serving: launches {got}")
        t = cf.out_len((max(len(w) for w in wav_list) + SR - 1) // SR * SR,
                       cfg.conv_feature_layers)
        last, hid = out["last_hidden_state"], out["hidden_states"]
        if tuple(last.shape) != (len(wav_list), t, cfg.encoder_embed_dim) or \
                len(hid) != cfg.encoder_layers or not torch.isfinite(last).all().item():
            fail(f"ex serving: last_hidden_state {tuple(last.shape)}, {len(hid)} hiddens")
        print(f"  request B={len(wav_list)}: last_hidden_state {tuple(last.shape)} (the final "
              f"hidden, no head) finite; launches {json.dumps(got)} ok", flush=True)
    served_card_vs_cpu(pt_s, cfg, requests[1][:3], "ex")
    print(f"  {smi}", flush=True)
    return d, fixed, launches, expert, student_cpu


def write_transcripts(root, gen):
    """A <spk>-<chap>.trans.txt beside each chapter's WAVs of ``root``: a
    few random words of letters per utterance."""
    import torch

    from fithubert_tpu_torch.utils.text import LETTERS

    letters = [c for c in LETTERS if c != "|"]  # '|' is the word separator
    n = 0
    for dirpath, _dirs, files in os.walk(root):
        wavs = sorted(f for f in files if f.endswith(".wav"))
        if not wavs:
            continue
        rows = []
        for f in wavs:
            words = []
            for _ in range(int(torch.randint(3, 12, (), generator=gen))):
                idx = torch.randint(0, len(letters), (int(torch.randint(1, 9, (),
                                                                        generator=gen)),),
                                    generator=gen)
                words.append("".join(letters[i] for i in idx.tolist()))
            rows.append(f"{f[:-4]} {' '.join(words)}")
            n += 1
        spk_chap = "-".join(wavs[0].split("-")[:2])
        with open(os.path.join(dirpath, f"{spk_chap}.trans.txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return n


def ctc_phase(exp, geom, s_state, rand_layers, per_step, gen, smi, tmp, libri):
    """[ctc] the release student with a seeded wav2vec2-Base-shaped CTC
    teacher written as a fairseq fine-tuned .pt and read by
    load_teacher_any: pseudo-label steps with the release launches, then
    run_training on ground-truth labels from transcripts written beside the
    loop phase's WAVs, with an eval through the predict step and its WER."""
    import torch

    from fithubert_tpu_torch.export.fairseq_import import load_teacher_any
    from fithubert_tpu_torch.models.teacher import TeacherModel
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.losses import collapse_pseudo_labels
    from fithubert_tpu_torch.train.step import Distiller

    geom_ctc = dataclasses.replace(geom, model_type="wav2vec_ctc", vocab_size=32)
    teacher = TeacherModel(geom_ctc, device="cpu").init_weights(gen)
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    x = fixed["x"].reshape(-1, fixed["x"].shape[-1]).cuda()
    with torch.no_grad():
        on_card = TeacherModel(geom_ctc, device="cuda")
        on_card.load_state_dict(teacher.state_dict())
        logits = on_card(x).ctc_logits.float()
        margin = logits[..., 1:].max(-1).values - logits[..., 0]
        teacher.ctc_proj.bias[0] += torch.quantile(margin.flatten()[::7], CTC_BLANK_SHARE).item()
        del on_card, logits, margin
    sd = {}
    for k, v in teacher.state_dict().items():
        sd[("w2v_encoder.proj." + k[len("ctc_proj."):]) if k.startswith("ctc_proj.")
           else "w2v_encoder.w2v_model." + k] = v
    inner = fairseq_cfg(dataclasses.replace(geom, model_type="wav2vec2"))
    pt = os.path.join(tmp, "wav2vec2_ctc_seeded.pt")
    torch.save({"model": sd, "cfg": {"model": {"_name": "wav2vec_ctc", "dropout": 0.5,
                                               "w2v_args": {"model": inner}}}}, pt)
    g_read, t_state = load_teacher_any(pt)
    if g_read != geom_ctc:
        fail(f"the CTC teacher's geometry read back as {g_read}, want {geom_ctc}")
    print(f"  wrote a fairseq wav2vec_ctc .pt ({os.path.getsize(pt) / 2 ** 20:.0f} MiB, "
          f"w2v_encoder. keys, vocab {g_read.vocab_size}); geometry read back ok", flush=True)

    exp_ctc = dataclasses.replace(
        exp, teacher=dataclasses.replace(exp.teacher, teacher_model=pt, model_type="wav2vec_ctc",
                                         vocab_size=32),
        distiller=dataclasses.replace(exp.distiller, teacher_task_agnostic=False),
        loss=dataclasses.replace(exp.loss, use_gt_for_ctc=False),
        data=dataclasses.replace(exp.data, load_labels=True))
    d = Distiller(exp_ctc, t_state, s_state, device="cuda", num_training_steps=20,
                  teacher_geometry=g_read)
    with torch.no_grad():
        ids = d.teacher(x, fixed["padding_mask"].reshape(x.shape).cuda()).ctc_logits.argmax(-1)
        _labels, pads = collapse_pseudo_labels(ids)
    blank = (ids == 0).float().mean().item()
    density = (1 - pads).sum().item() / pads.numel()
    if not 0.0 < density < 0.5:
        fail(f"ctc: {density:.3f} pseudo-labels per frame; the blank bias missed its share")
    print(f"  the bf16 teacher's argmax: blank on {blank:.3f} of the fixed batch's frames "
          f"(bias set for {CTC_BLANK_SHARE} in fp32), {density:.3f} pseudo-labels per "
          f"frame", flush=True)
    logs, launches = launches_of_step(d, train_batch(gen, a, b, 12.0, ragged=True),
                                      rand_layers, per_step, "ctc ragged step")
    print(f"  step 0 (ragged {a} x {b}, one fabricated row): loss {logs['loss']:.6f} "
          f"ctc_loss {logs['ctc_loss']:.6f} grad_norm {logs['grad_norm']:.6f}; launches "
          f"{json.dumps(launches)} (the release step's) ok", flush=True)
    steps = [launches_of_step(d, fixed, rand_layers, per_step, f"ctc step {i + 1}")[0]
             for i in range(CTC_STEPS)]
    losses = [lg["loss"] for lg in steps]
    if not losses[-1] < losses[0]:
        fail(f"ctc: the loss did not fall over {CTC_STEPS} steps: {losses}")
    print(f"  steps 1-{CTC_STEPS} (pseudo-labels): loss {[round(v, 4) for v in losses]} fell, "
          f"ctc_loss {[round(lg['ctc_loss'], 4) for lg in steps]} finite; the release "
          f"launches every step ok", flush=True)
    del d

    n = write_transcripts(libri, gen)
    print(f"[ctc] run_training with use_gt_for_ctc: ground-truth labels from {n} transcripts "
          f"written beside the loop phase's WAVs, 1 epoch, an eval with WER / CER", flush=True)
    exp_gt = dataclasses.replace(exp_ctc, loss=dataclasses.replace(exp_ctc.loss,
                                                                   use_gt_for_ctc=True))
    t0 = time.perf_counter()
    with counted_steps() as record:
        result = run_training(loop_config(exp_gt, tmp, pt, libri, "ctc", 1, 1), resume=False,
                              device="cuda")
    torch.cuda.synchronize()
    train, val = logged(os.path.join(tmp, "ctc"))
    if result["steps"] != 2 or any(r != per_step for r in record):
        fail(f"ctc loop: {result}, launches per step {record}, want 2 steps of {per_step}")
    if not all(math.isfinite(r["ctc_loss"]) for r in train.values()):
        fail(f"ctc loop: ctc_loss not finite: {train}")
    if not val or not all(math.isfinite(val[-1][k]) for k in ("val/wer", "val/cer",
                                                              "val/ctc_loss")):
        fail(f"ctc loop: the eval gave no finite WER / CER: {val}")
    print(f"  {result['steps']} steps, each the release launches; ctc_loss "
          f"{[round(r['ctc_loss'], 4) for r in train.values()]}; eval: ctc_loss "
          f"{val[-1]['val/ctc_loss']:.4f} WER {val[-1]['val/wer']:.4f} CER "
          f"{val[-1]['val/cer']:.4f} (a student of a few steps) finite; wall "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)


# ---- the conformer family ([conformer]) and the mel front-end ([mel])
CONFORMER_STEPS = 5
# The conformer's BatchNorm running statistics after fp32 steps, card vs CPU:
# each is 0.9 old + 0.1 a mean (or biased variance) over the microbatch's
# frames, summed in another order on the two devices.
BN_STATS_TOL = dict(atol=1e-5, rtol=1e-4)


def dropout_sites(cfg) -> int:
    """The elementwise dropouts of one training forward of a student
    ``cfg``, each a K5 launch (``ops/dropout.py``): the front end's
    ``dropout_input``, the encoder input, and per layer two (a transformer
    layer, plus its activation dropout) or six (a conformer layer)."""
    per_layer = (6 * (cfg.dropout > 0) if cfg.layer_type == "conformer" else
                 2 * (cfg.dropout > 0) + (cfg.activation_dropout > 0))
    return int(cfg.dropout_input > 0) + int(cfg.dropout > 0) + cfg.encoder_layers * per_layer


def plus_k5(per, cfg, forwards):
    """``per`` with K5's elementwise dropout launches added: a forward and
    a backward launch per site of each of the step's ``forwards``."""
    from fithubert_tpu_torch.ops.kernels import dropout as kd

    out = dict(per)
    n = 2 * forwards * dropout_sites(cfg)
    if n:
        out[kd.KERNEL] = out.get(kd.KERNEL, 0) + n
    return out


def plus_pos_conv(per, cfg, forwards, teacher=True, backward=True):
    """``per`` with the positional conv kernel's launches added
    (``ops/kernels/pos_conv.py``): for each of the step's ``forwards``, the
    teacher's forward (``teacher``), and the student ``cfg``'s forward and
    (``backward``) input gradient where its encoder runs the single-layer
    positional conv: not the rel_pos / rope conformer stack, nor
    ``pos_conv_depth`` > 1 (``SameConv1d``'s cuDNN path)."""
    from fithubert_tpu_torch.ops.kernels import pos_conv as kp

    student = int(not cfg.dedicated_conformer and cfg.pos_conv_depth == 1)
    n = forwards * (int(teacher) + student * (1 + int(backward)))
    out = dict(per)
    if n:
        out[kp.KERNEL] = out.get(kp.KERNEL, 0) + n
    return out


def conformer_per_step(exp_c, geom):
    """The launches of one train step of a conformer ``exp_c`` (4
    microbatches looped: its BatchNorm statistics never fold): per
    microbatch, the prefix and K1 on both extractors, the teacher's K2 at
    p = 0, K6 over the student's stack, and the student's attention: K5
    forward and backward in every layer (rel_pos, rope: the probabilities
    are materialised), or K2 with dropout and the backward (abs: fairseq's MHA)."""
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import dropout as kd
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    cfg, a = exp_c.distiller, exp_c.train.accumulate_grad_batches
    n_stack, l_s = len(cfg.conv_feature_layers) - 1, cfg.encoder_layers
    per = {cf.KERNEL: a * (n_stack + len(geom.conv_feature_layers) - 1),
           cf.KERNEL_PREFIX: 2 * a, fa.KERNEL: a * geom.encoder_layers,
           cf.KERNEL_BWD: a * 4 * n_stack}
    if cfg.dedicated_conformer:
        per[kd.KERNEL] = 2 * a * l_s
    else:
        per.update({fa.KERNEL_DROPOUT: a * l_s, **attn_bwd(a * l_s)})
    return plus_pos_conv(plus_k5(per, cfg, a), cfg, a)


def batch_norms(model):
    from fithubert_tpu_torch.ops.conformer import RowMaskedBatchNorm

    return [m for m in model.modules() if isinstance(m, RowMaskedBatchNorm)]


def fp32_card_vs_cpu(exp, t_state, s_state, gen, what, steps=2, rand=None, geometry=None):
    """fp32 steps without dropout on the card and on the CPU (plain
    versions), 1 x 2 s: loss and grad_norm to TRAIN_RTOL, the parameters to
    TRAIN_PARAM_ATOL and a conformer's running statistics to BN_STATS_TOL
    after the steps. ``geometry``: the teacher's, where not the config's."""
    import torch

    from fithubert_tpu_torch.train.step import Distiller

    exp32 = dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, use_fp16=False),
        distiller=dataclasses.replace(exp.distiller, compute_dtype="float32", dropout=0.0,
                                      attention_dropout=0.0, activation_dropout=0.0,
                                      dropout_input=0.0))
    small = train_batch(gen, 1, 1, 2.0, ragged=False)
    on_card = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20,
                        teacher_geometry=geometry)
    on_cpu = Distiller(exp32, t_state, s_state, device="cpu", num_training_steps=20,
                       teacher_geometry=geometry)
    for i in range(steps):
        lg, lc = on_card.train_step(small, rand), on_cpu.train_step(small, rand)
        for key in ("loss", "grad_norm"):
            rel = abs(lg[key] - lc[key]) / abs(lc[key])
            if rel > TRAIN_RTOL:
                fail(f"{what} fp32 step {i}: {key} card {lg[key]} vs CPU {lc[key]} "
                     f"(rel {rel:.3e})")
        print(f"  {what} fp32 step {i} (lr {lg['lr']:.3e}): loss {lg['loss']:.8f} vs "
              f"{lc['loss']:.8f}, grad_norm {lg['grad_norm']:.8f} vs {lc['grad_norm']:.8f} tol "
              f"rel {TRAIN_RTOL} ok", flush=True)
    worst = max((pg.detach().cpu() - pc.detach()).abs().max().item()
                for pg, pc in zip(on_card.params, on_cpu.params))
    if worst > TRAIN_PARAM_ATOL:
        fail(f"{what} fp32 steps: parameters differ by {worst:.3e} > {TRAIN_PARAM_ATOL}")
    stats = ""
    bns = list(zip(batch_norms(on_card.student), batch_norms(on_cpu.student)))
    if bns:
        worst_bn = 0.0
        for bg, bc in bns:
            for name in ("running_mean", "running_var"):
                g, c = getattr(bg, name).cpu(), getattr(bc, name)
                err = (g - c).abs()
                worst_bn = max(worst_bn, err.max().item())
                if not bool((err <= BN_STATS_TOL["atol"] + BN_STATS_TOL["rtol"] * c.abs()).all()):
                    fail(f"{what} fp32 steps: BatchNorm {name} differs by {err.max().item():.3e}")
        stats = (f"; {len(bns)} BatchNorms' running_mean / running_var max_abs_err="
                 f"{worst_bn:.3e} tol=({BN_STATS_TOL['atol']}, {BN_STATS_TOL['rtol']})")
    print(f"  {what} fp32: parameters after {steps} steps max_abs_err={worst:.3e} "
          f"tol={TRAIN_PARAM_ATOL}{stats} ok", flush=True)


def check_served(expert, cfg, requests, want_launches, what):
    """Each request through ``expert`` with its launches ``want_launches``;
    the output's shapes, frames and finiteness."""
    import torch

    from fithubert_tpu_torch.ops.kernels import _build

    for wav_list in requests:
        _build.reset_launches()
        out = expert(wav_list)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        if got != want_launches:
            fail(f"{what} serving: launches {got}, want {want_launches}")
        last, hid, pm = out["last_hidden_state"], out["hidden_states"], out["padding_mask"]
        if len(hid) != cfg.encoder_layers or not torch.isfinite(last).all().item() or \
                last.shape[0] != len(wav_list) or pm.shape[0] != len(wav_list):
            fail(f"{what} serving: last_hidden_state {tuple(last.shape)}, {len(hid)} hiddens")
        print(f"  {what} request B={len(wav_list)}: last_hidden_state {tuple(last.shape)}, "
              f"{len(hid)} hiddens {tuple(hid[0].shape)}, frames "
              f"{(~pm).sum(-1).tolist()} finite; launches {json.dumps(got)} ok", flush=True)


def served_card_vs_cpu(pt_s, cfg, wavs, what):
    """The export in fp32 on the card against the CPU (E2E tolerances), and
    the bf16 forward within BF16_VS_FP32_FRO of the fp32 one."""
    import torch

    from fithubert_tpu_torch.export.expert import UpstreamExpert

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gpu32 = UpstreamExpert(pt_s, cfg32, device="cuda")(wavs)
    cpu32 = UpstreamExpert(pt_s, cfg32, device="cpu")(wavs)
    outs = [(gpu32["last_hidden_state"], cpu32["last_hidden_state"])] + list(
        zip(gpu32["hidden_states"], cpu32["hidden_states"]))
    worst = 0.0
    for i, (g, c) in enumerate(outs):
        err = (g.cpu() - c).abs()
        worst = max(worst, err.max().item())
        if not bool((err <= E2E_ATOL + E2E_RTOL * c.abs()).all()):
            fail(f"{what} fp32 card vs CPU: output {i} max_abs_err {err.max().item():.3e}")
    bf16 = UpstreamExpert(pt_s, cfg, device="cuda")(wavs)
    fro = max((torch.linalg.vector_norm(b_.float() - g) / torch.linalg.vector_norm(g)).item()
              for b_, g in zip((bf16["last_hidden_state"], *bf16["hidden_states"]),
                               (gpu32["last_hidden_state"], *gpu32["hidden_states"])))
    if fro > BF16_VS_FP32_FRO:
        fail(f"{what} bf16 forward vs fp32 forward on the card: rel_fro {fro:.3e}")
    print(f"  {what} fp32 card vs CPU, B={len(wavs)} ragged, {len(outs)} outputs: "
          f"max_abs_err={worst:.3e} tol=({E2E_ATOL}, {E2E_RTOL}) ok; bf16 vs fp32 on the card "
          f"worst rel_fro={fro:.3e} tol={BF16_VS_FP32_FRO} ok", flush=True)


@contextlib.contextmanager
def k5_shapes(kd, seen):
    """Record into the set ``seen`` the (shape, dtype) of every tensor K5 is
    launched on while the block runs; the launches themselves are left as
    they are."""
    launch = kd.seeded_dropout_cuda

    def recorded(x, seed, p):
        seen.add((tuple(x.shape), x.dtype))
        return launch(x, seed, p)

    kd.seeded_dropout_cuda = recorded
    try:
        yield seen
    finally:
        kd.seeded_dropout_cuda = launch


def check_k5_at(kd, shape, dev):
    """K5 at a conformer's probabilities ``shape`` (fp32, p = ATTN_P), bit
    for bit against seeded_dropout_plain, forward and backward; the inputs
    are drawn on the card (one (32, 12, 799, 799) tensor is 981 MB)."""
    import torch

    from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

    g = torch.Generator(device=dev).manual_seed(int(shape[-1]))
    x = torch.rand(shape, device=dev, generator=g).requires_grad_()
    cot = torch.randn(shape, device=dev, generator=g)
    seed = seed_tensor(int(shape[0]) * 7919 + 1, int(shape[-1]) * 104729 + 3, dev)
    y = kd.seeded_dropout(x, seed, ATTN_P)
    (dx,) = torch.autograd.grad(y, x, cot)
    with torch.no_grad():
        fwd_ok = torch.equal(y, kd.seeded_dropout_plain(x.detach(), seed, ATTN_P))
        bwd_ok = torch.equal(dx, kd.seeded_dropout_plain(cot, seed, ATTN_P))
        rate = (y != 0).float().mean().item()
    torch.cuda.synchronize()
    if not (fwd_ok and bwd_ok):
        fail(f"K5 fp32 {shape}: forward {fwd_ok}, backward {bwd_ok} bit-identical to its plain "
             f"version")
    sigma = (ATTN_P * (1 - ATTN_P) / x.numel()) ** 0.5
    if abs(rate - (1 - ATTN_P)) > KEEP_SIGMAS * sigma + 1e-6:  # x is 0 with probability ~0
        fail(f"K5 keep-rate {rate:.6f} at {shape}")
    print(f"  K5 fp32 {shape} ({x.numel()} elements, {4 * x.numel() / 1e6:.1f} MB): forward "
          f"and backward bit-identical to seeded_dropout_plain, keep-rate {rate:.6f} ok",
          flush=True)
    del x, cot, y, dx
    torch.cuda.empty_cache()


def conformer_phase(geom, t_state, gen, smi, tmp, pt):
    """[conformer] conformer_experiment at full width on the card: rel_pos
    (a ragged step with a fabricated row, CONFORMER_STEPS on one batch,
    exact launches, a falling loss, the running statistics moving; fp32
    steps against the CPU), rope and abs (steps with exact launches, fp32
    against the CPU), run_training on rel_pos (the loop phase's teacher
    ``pt``, a corpus of its own under ``tmp``) stopped at max_steps 3 and
    resumed to 6 against 6 straight steps bit for bit, statistics included,
    and the export served in bf16 and fp32. Returns {path: (Distiller, its
    fixed batch, launches per step)} and the served rel_pos expert."""
    import torch

    from fithubert_tpu_torch.config import conformer_experiment
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.step import Distiller

    out = {}
    for pos_enc in ("rel_pos", "rope", "abs"):
        exp_c = conformer_experiment(pos_enc)
        path = "conformer" if pos_enc == "rel_pos" else f"conformer-{pos_enc}"
        a, b = exp_c.train.accumulate_grad_batches, exp_c.train.batch_size
        per_step = conformer_per_step(exp_c, geom)
        s_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
        d = Distiller(exp_c, t_state, s_state, device="cuda", num_training_steps=20)
        rand = torch.randperm(exp_c.distiller.encoder_layers - 1, generator=gen)
        bn0 = [bn.running_var.clone() for bn in batch_norms(d.student)]
        logs, launches = launches_of_step(d, train_batch(gen, a, b, 12.0, ragged=True), rand,
                                          per_step, f"{path} ragged step")
        moved = sum(int(not torch.equal(v0, bn.running_var))
                    for v0, bn in zip(bn0, batch_norms(d.student)))
        if not all(torch.isfinite(p).all().item() for p in d.params) or moved != len(bn0):
            fail(f"{path} ragged step: parameters not finite or {moved} of {len(bn0)} "
                 f"BatchNorms' statistics moved")
        print(f"  {path} step 0 (ragged {b} x {a}, one fabricated row): loss {logs['loss']:.6f} "
              f"grad_norm {logs['grad_norm']:.6f}, all {len(bn0)} BatchNorms' running "
              f"statistics moved; launches {json.dumps(launches)} ok", flush=True)
        fixed = train_batch(gen, a, b, 12.0, ragged=False)
        n_steps = CONFORMER_STEPS if pos_enc == "rel_pos" else 2
        losses = [launches_of_step(d, fixed, rand, per_step, f"{path} step {i + 1}")[0]["loss"]
                  for i in range(n_steps)]
        if pos_enc == "rel_pos" and not losses[-1] < losses[0]:
            fail(f"{path}: the loss did not fall over {n_steps} steps: {losses}")
        print(f"  {path} steps 1-{n_steps} on one {b} x {a} x 12 s batch: loss "
              f"{[round(x, 6) for x in losses]}"
              f"{' fell' if pos_enc == 'rel_pos' else ''}; every step launched "
              f"{json.dumps(per_step)} ok", flush=True)
        fp32_card_vs_cpu(exp_c, t_state, s_state, gen, path, steps=2 if pos_enc == "rel_pos"
                         else 1, rand=rand)
        out[path] = (d, fixed, launches, rand)

    exp_c = conformer_experiment("rel_pos")
    per_step = conformer_per_step(exp_c, geom)
    a, b = exp_c.train.accumulate_grad_batches, exp_c.train.batch_size
    # a corpus of its own: 36 WAVs make 3 steps an epoch, so max_steps 3 ends
    # an epoch (a resume restarts the epoch it stopped in)
    tmp = os.path.join(tmp, "conformer")
    libri = os.path.join(tmp, "LibriSpeech")
    write_corpus(libri, gen, {"train-clean-100": 3 * a * b, "dev-clean": 6})
    print(f"[conformer] run_training on rel_pos over {3 * a * b} + 6 WAVs it writes and the loop "
          f"phase's teacher .pt (3 steps of {b} x {a} an epoch): stopped at max_steps 3 and "
          f"resumed to 6, and 6 from scratch", flush=True)
    runs = {}
    for name, run_dir, max_steps, resume, want_steps in (
            ("run 1", "conformer_resumed", 3, True, 3), ("run 2", "conformer_resumed", 0, True, 6),
            ("run 3", "conformer_straight", 0, False, 6)):
        exp_run = dataclasses.replace(exp_c, train=dataclasses.replace(
            exp_c.train, num_devices=1, max_steps=max_steps))
        t0 = time.perf_counter()
        with counted_steps() as record:
            result = run_training(loop_config(exp_run, tmp, pt, libri, run_dir, 2, 1),
                                  resume=resume, device="cuda")
        torch.cuda.synchronize()
        if result["steps"] != want_steps or any(r != per_step for r in record):
            fail(f"conformer loop {name}: {result}, launches per step {record}, want "
                 f"{want_steps} steps of {per_step}")
        runs[run_dir], val = logged(os.path.join(tmp, run_dir))
        if not all(math.isfinite(r["val/v_loss"]) for r in val):
            fail(f"conformer loop {name}: val v_loss not finite")
        print(f"  {name}: {result['steps']} steps ({len(record)} in this run, each launching "
              f"the rel_pos step's kernels), val v_loss "
              f"{[round(r['val/v_loss'], 6) for r in val]}, wall "
              f"{time.perf_counter() - t0:.1f} s ok", flush=True)
    resumed, straight = runs["conformer_resumed"], runs["conformer_straight"]
    for s in range(1, 7):
        for key in LOOP_RESUME_KEYS:
            if resumed[s][key] != straight[s][key]:
                fail(f"conformer loop: step {s} {key} {resumed[s][key]!r} (runs 1 + 2) vs "
                     f"{straight[s][key]!r} (run 3): a resume must give the same bits")
    pt_s = os.path.join(tmp, "conformer_resumed", "student.pt")
    final = torch.load(pt_s), torch.load(os.path.join(tmp, "conformer_straight", "student.pt"))
    n_buffers = 0
    for k, v in final[0].items():
        if not torch.equal(v, final[1][k]):
            fail(f"conformer loop: the exported {k} differs between the resumed and the "
                 f"straight run")
        n_buffers += k.endswith(("running_mean", "running_var"))
    print(f"  steps 1-6, runs 1 + 2 vs run 3: {', '.join(LOOP_RESUME_KEYS)} bit for bit; the "
          f"exported state ({len(final[0])} tensors, {n_buffers} running statistics) bit for "
          f"bit; loss {[resumed[s]['loss'] for s in range(1, 7)]}", flush=True)

    print("[conformer] export_student's pair served: 3 ragged requests in bf16, then fp32 on "
          "the card against the CPU", flush=True)
    cfg = exp_c.distiller
    expert = UpstreamExpert(pt_s, cfg, device="cuda")
    requests = [[torch.randn(int(3.7 * SR), generator=gen) * 0.1],
                ragged_wavs(gen, 4, 2.0, 16.0),
                [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(8)]]
    check_served(expert, cfg, requests,
                 plus_pos_conv({cf.KERNEL_PREFIX: 1, cf.KERNEL: len(cfg.conv_feature_layers) - 1},
                               cfg, 1, teacher=False, backward=False), "conformer")
    served_card_vs_cpu(pt_s, cfg, requests[1][:3], "conformer")
    return out, expert


def mel_phase(geom, t_state, gen, smi, tmp):
    """[mel] mel_experiment at full width on the card: steps with exact
    launches (no student K1, prefix or K6) and a falling loss; SpecAugment's
    draws on the card equal the CPU's and its bands lie within their width
    ranges; one fp32 step card vs CPU with SpecAugment on; the export served
    without SpecAugment. Returns (the bf16 Distiller, its fixed batch, the
    launches per step, the served expert)."""
    import torch

    from fithubert_tpu_torch.config import mel_experiment
    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops import specaug
    from fithubert_tpu_torch.ops.dropout import DropoutRNG
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.ops.mel import mel_spectrogram
    from fithubert_tpu_torch.train.checkpoint import export_student
    from fithubert_tpu_torch.train.step import Distiller

    exp_m = mel_experiment()
    cfg = exp_m.distiller
    a, b = exp_m.train.accumulate_grad_batches, exp_m.train.batch_size
    l_s = cfg.encoder_layers
    # folded into one batch of a * b rows: the teacher's prefix and K1, its
    # K2 at p = 0, the student's attention with dropout and its backward
    per_step = plus_pos_conv(plus_k5({cf.KERNEL_PREFIX: 1,
                                      cf.KERNEL: len(geom.conv_feature_layers) - 1,
                                      fa.KERNEL: geom.encoder_layers, fa.KERNEL_DROPOUT: l_s,
                                      **attn_bwd(l_s)}, cfg, 1), cfg, 1)
    s_state = StudentModel(cfg, device="cpu").init_weights(gen).state_dict()
    d = Distiller(exp_m, t_state, s_state, device="cuda", num_training_steps=20)
    rand = torch.randperm(l_s - 1, generator=gen)
    logs, launches = launches_of_step(d, train_batch(gen, a, b, 12.0, ragged=True), rand,
                                      per_step, "mel ragged step")
    print(f"  mel step 0 (ragged {b} x {a}, one fabricated row): loss {logs['loss']:.6f} "
          f"grad_norm {logs['grad_norm']:.6f}; launches {json.dumps(launches)} ok", flush=True)
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    losses = [launches_of_step(d, fixed, rand, per_step, f"mel step {i + 1}")[0]["loss"]
              for i in range(CONFORMER_STEPS)]
    if not losses[-1] < losses[0]:
        fail(f"mel: the loss did not fall over {CONFORMER_STEPS} steps: {losses}")
    print(f"  mel steps 1-{CONFORMER_STEPS} on one {b} x {a} x 12 s batch: loss "
          f"{[round(x, 6) for x in losses]} fell; every step launched {json.dumps(per_step)} "
          f"ok", flush=True)

    print("[mel] SpecAugment on the card: the draws of one step seed on the card and on the "
          "CPU, and the masked bands", flush=True)
    sa = exp_m.specaug
    x = fixed["x"].reshape(a * b, -1)
    feats = mel_spectrogram(x.cuda(), cfg.n_mels, log=True)
    rows, frames, mels = feats.shape
    card = specaug.draw_spec_augment(DropoutRNG(11, "cuda").specaug, sa, rows, frames, mels)
    cpu = specaug.draw_spec_augment(DropoutRNG(11, "cpu").specaug, sa, rows, frames, mels)
    for name, dc, dh in (("freq", card.freq, cpu.freq), ("time", card.time, cpu.time)):
        if not (torch.equal(dc.widths, dh.widths) and torch.equal(dc.positions, dh.positions)):
            fail(f"SpecAugment {name} draws differ between the card and the CPU")
    (f_lo, f_hi), (t_lo, t_hi) = sa.freq_mask_width_range, sa.time_mask_width_range
    for draw, lo, hi, length in ((card.freq, f_lo, f_hi, mels), (card.time, t_lo, t_hi, frames)):
        w, p = draw.widths, draw.positions
        if int(w.min()) < lo or int(w.max()) >= hi or int(p.min()) < 0 or \
                int(p.max()) >= max(1, length - int(w.max())):
            fail(f"SpecAugment draws out of range: widths {w.flatten().tolist()}")
    got = specaug.apply_spec_augment(feats, card, sa)
    want = specaug.apply_spec_augment(feats.cpu(), cpu, sa)
    hit_f = torch.zeros(rows, mels, dtype=torch.bool)
    hit_t = torch.zeros(rows, frames, dtype=torch.bool)
    for hit, draw in ((hit_f, card.freq), (hit_t, card.time)):
        for i in range(rows):
            for p_, w_ in zip(draw.positions[i, :, 0].tolist(), draw.widths[i, :, 0].tolist()):
                hit[i, p_:p_ + w_] = True
    masked = hit_f[:, None, :] | hit_t[:, :, None]
    changed = (got.cpu() != feats.cpu())
    if bool((changed & ~masked).any()):
        fail("SpecAugment changed a value outside its bands on the card")
    err = (got.cpu() - want).abs()
    if not bool((err <= E2E_ATOL + E2E_RTOL * want.abs()).all()):
        fail(f"SpecAugment on the card vs the CPU: max_abs_err {err.max().item():.3e}")
    print(f"  {rows} rows x {frames} frames x {mels} mels: the draws of seed 11 equal on the "
          f"card and the CPU (freq widths {card.freq.widths.flatten().tolist()[:6]}..., time "
          f"widths {card.time.widths.flatten().tolist()[:6]}...), within [{f_lo}, {f_hi}) and "
          f"[{t_lo}, {t_hi}); {int(masked.sum())} of {masked.numel()} cells in the bands, none "
          f"changed outside; card vs CPU max_abs_err={err.max().item():.3e} tol=({E2E_ATOL}, "
          f"{E2E_RTOL}) ok", flush=True)

    print("[mel] fp32 steps without dropout, SpecAugment on (the same draws on both), card "
          "vs CPU, 1 x 2 s", flush=True)
    fp32_card_vs_cpu(exp_m, t_state, s_state, gen, "mel", steps=2, rand=rand)

    print("[mel] the export served without SpecAugment: 3 ragged requests in bf16, then fp32 "
          "on the card against the CPU", flush=True)
    _, pt_s = export_student(exp_m, d.student.state_dict(), os.path.join(tmp, "mel_export"))
    expert = UpstreamExpert(pt_s, cfg, device="cuda")
    if expert.model.specaug is not None or expert.get_downsample_rates() != 320:
        fail("mel serving: the expert applies SpecAugment or its rate is not 320")
    requests = [[torch.randn(int(3.7 * SR), generator=gen) * 0.1],
                ragged_wavs(gen, 4, 2.0, 16.0),
                [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(8)]]
    check_served(expert, cfg, requests,
                 plus_pos_conv({fa.KERNEL: l_s}, cfg, 1, teacher=False, backward=False), "mel")
    again = expert(requests[1])["last_hidden_state"]
    if not torch.equal(again, expert(requests[1])["last_hidden_state"]):
        fail("mel serving: two calls on one request differ")
    served_card_vs_cpu(pt_s, cfg, requests[1][:3], "mel")
    return d, fixed, launches, rand, expert


LARGE_STEPS = 5
# wav2vec2-Large LV-60 (fairseq examples/wav2vec/config/pretraining/
# wav2vec2_large_librivox.yaml): the standard 7-block extractor in
# layer_norm mode with conv bias, pre-LN, 24 layers of 1024, FFN 4096, 16
# heads of 64, the positional conv k 128 in 16 groups.
LARGE = dict(model_type="wav2vec2", extractor_mode="layer_norm", conv_bias=True,
             layer_norm_first=True, encoder_layers=24, encoder_embed_dim=1024,
             encoder_ffn_embed_dim=4096, encoder_attention_heads=16)
# The int8 targets against the bf16 teacher's: tests/test_quant.py's bound
# for the JAX package's int8 teacher (cosine above 0.99 for x, every layer's
# hidden and the features), and for the int8 expert against the float one.
INT8_COSINE = 0.99
# The options of the [options] phase: every encoder and extractor option
# that the port once refused, at the release student's width.
OPTIONS = dict(extractor_mode="layer_norm", conv_bias=True, pos_conv_depth=3,
               activation_fn="gelu_fast")
# [conformer-dp]: the rel_pos conformer at this depth (an earlier path, cut
# to keep the script inside its time limit), its global batch of 2
# microbatches of 2 x DP_WORLD rows.
CONFORMER_DP_LAYERS = 4


def cosine(a, b) -> float:
    import torch

    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / torch.clamp(a.norm() * b.norm(), min=1e-9))


def timed(fn, n):
    """(median, min, max) of n host-clock walls of fn, each to a device sync."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def large_phase(exp, gen, smi, tmp):
    """[large] the release student (pred_head_final_dim 1024) distilling a
    seeded fairseq-shaped wav2vec2-Large LV-60 teacher, written as a .pt
    and read by load_fairseq_teacher: a ragged step and LARGE_STEPS steps on
    one 3 x 4 x 12 s batch in bf16 with dropout 0.1, each with exact
    launches (the teacher's extractor runs no K1 and no prefix: layer_norm
    mode with conv bias), a falling loss, then fp32 steps card vs CPU.
    Returns (the Distiller, its fixed batch, the launches per step, its
    random layers)."""
    import torch

    from fithubert_tpu_torch.config import TeacherConfig
    from fithubert_tpu_torch.export.fairseq_import import load_fairseq_teacher
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.train.step import Distiller

    want_geom = TeacherGeometry(**LARGE)
    t0 = time.perf_counter()
    sd = TeacherModel(want_geom, device="cpu").init_weights(gen).state_dict()
    pt = os.path.join(tmp, "wav2vec2_large_lv60.pt")
    torch.save({"model": sd, "cfg": {"model": dict(fairseq_cfg(want_geom), conv_bias=True)}},
               pt)
    del sd
    geom, t_state = load_fairseq_teacher(pt)
    os.remove(pt)
    if geom != want_geom:
        fail(f"[large] load_fairseq_teacher read {geom}, want {want_geom}")
    n_params = sum(v.numel() for v in t_state.values())
    print(f"  teacher: a seeded wav2vec2-Large-shaped fairseq .pt of {n_params / 1e6:.1f} M "
          f"parameters, read by load_fairseq_teacher as {LARGE} in "
          f"{time.perf_counter() - t0:.1f} s ok", flush=True)
    exp_l = dataclasses.replace(
        exp, teacher=TeacherConfig(**{k: v for k, v in LARGE.items()
                                      if k.startswith(("model_type", "encoder_"))}),
        distiller=dataclasses.replace(exp.distiller, pred_head_final_dim=1024))
    s_state = StudentModel(exp_l.distiller, device="cpu").init_weights(gen).state_dict()
    cfg, a, b = exp_l.distiller, exp_l.train.accumulate_grad_batches, exp_l.train.batch_size
    n_stack, l_s = len(cfg.conv_feature_layers) - 1, cfg.encoder_layers
    per_step = plus_pos_conv(plus_k5({cf.KERNEL: n_stack, cf.KERNEL_PREFIX: 1,
                                      fa.KERNEL: geom.encoder_layers, fa.KERNEL_DROPOUT: l_s,
                                      **attn_bwd(l_s), cf.KERNEL_BWD: 4 * n_stack}, cfg, 1),
                             cfg, 1)
    rand = torch.randperm(cfg.encoder_layers - 1, generator=gen)
    d = Distiller(exp_l, t_state, s_state, device="cuda", num_training_steps=20,
                  teacher_geometry=geom)
    logs, launches = launches_of_step(d, train_batch(gen, a, b, 12.0, ragged=True), rand,
                                      per_step, "[large] ragged step")
    print(f"  step 0 (ragged 3 x 4, one fabricated row): loss {logs['loss']:.6f} grad_norm "
          f"{logs['grad_norm']:.6f}; launches {json.dumps(launches)} ok", flush=True)
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    losses = [launches_of_step(d, fixed, rand, per_step, f"[large] step {i + 1}")[0]["loss"]
              for i in range(LARGE_STEPS)]
    if not losses[-1] < losses[0]:
        fail(f"[large] the loss did not fall over {LARGE_STEPS} steps: {losses}")
    print(f"  steps 1-{LARGE_STEPS} on one 3 x 4 x 12 s batch: loss "
          f"{[round(x, 6) for x in losses]} fell; every step launched {json.dumps(launches)} "
          f"ok", flush=True)
    fp32_card_vs_cpu(exp_l, t_state, s_state, gen, "[large]", rand=rand, geometry=geom)
    return d, fixed, launches, rand


def int8_phase(exp, t_state, s_state, state, cfg, rand_layers, per_step, gen, smi):
    """[int8] s8 x s8 -> s32 on the card (torch._int_mm) against the CPU bit
    for bit at the teacher's shapes; the release step with
    teacher.quantize_int8 (launches unchanged, targets within INT8_COSINE
    of the bf16 teacher's); UpstreamExpert(int8=True) on three ragged
    requests and at B = 32 x 16 s against the bf16 expert; the int8 and
    bf16 teacher steps and serving forwards timed."""
    import torch

    from fithubert_tpu_torch.export.expert import UpstreamExpert
    from fithubert_tpu_torch.ops import quant
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.train.step import Distiller

    rows = exp.train.batch_size * exp.train.accumulate_grad_batches * cf.out_len(
        12 * SR, ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2)
    for k, n in ((512, 768), (768, 768), (768, 3072), (3072, 768)):
        g = torch.Generator().manual_seed(k * n)
        a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        got = quant.int_mm(a.cuda(), w.cuda().t())
        want = quant.int_mm(a, w.t())
        if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
            fail(f"[int8] int_mm ({rows}, {k}) x ({k}, {n}) on the card differs from the CPU")
    print(f"  int_mm (torch._int_mm, cuBLASLt) on the card: the int32 accumulators of "
          f"({rows}, K) x (K, N) for (K, N) in (512, 768), (768, 768), (768, 3072), "
          f"(3072, 768) equal the CPU's bit for bit ok", flush=True)

    exp_q = dataclasses.replace(exp, teacher=dataclasses.replace(exp.teacher,
                                                                 quantize_int8=True))
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size
    fixed = train_batch(gen, a, b, 12.0, ragged=False)
    d_q = Distiller(exp_q, t_state, s_state, device="cuda", num_training_steps=20)
    d_f = Distiller(exp, t_state, s_state, device="cuda", num_training_steps=20)
    marked = [m for m in d_q.teacher.modules() if getattr(m, "quantize", False)]
    if not marked or any(m.weight_q.dtype != torch.int8 for m in marked):
        fail("[int8] the teacher's call sites hold no int8 payloads")
    x = fixed["x"].reshape(-1, fixed["x"].shape[-1]).cuda()
    m = fixed["padding_mask"].reshape(x.shape).cuda()
    _build.reset_launches()
    tq = d_q.teacher(x, m)
    torch.cuda.synchronize()
    t_launches = dict(_build.LAUNCHES)
    tf = d_f.teacher(x, m)
    names = ["x", "features"] + [f"layer {i}" for i in range(len(tq.layer_results))]
    cos = [cosine(q.float(), f.float()) for q, f in zip(
        [tq.x, tq.features] + [h for h, _, _ in tq.layer_results],
        [tf.x, tf.features] + [h for h, _, _ in tf.layer_results])]
    if min(cos) <= INT8_COSINE:
        fail(f"[int8] int8 targets vs bf16: cosine {dict(zip(names, cos))}")
    print(f"  {len(marked)} teacher matmuls int8 ({len(marked) // 6} layers' q/k/v/out, fc1, "
          f"fc2 and post_extract_proj); its targets on the 3 x 4 x 12 s batch vs the bf16 "
          f"teacher's: min cosine {min(cos):.6f} ({names[cos.index(min(cos))]}), all > "
          f"{INT8_COSINE} ok; the teacher's launches {json.dumps(t_launches)}", flush=True)
    del tq, tf
    logs, launches = launches_of_step(d_q, fixed, rand_layers, per_step, "[int8] step")
    print(f"  release step with teacher.quantize_int8: loss {logs['loss']:.6f} grad_norm "
          f"{logs['grad_norm']:.6f}; launches {json.dumps(launches)} (the release step's) ok",
          flush=True)
    for what, d in (("int8", d_q), ("bf16", d_f), ("int8", d_q), ("bf16", d_f)):
        med, lo, hi = timed(lambda: d.train_step(fixed, rand_layers), 5)
        print(f"  [timing] release train step, {what} teacher: median {med:.3f} ms over 5 "
              f"(min {lo:.3f}, max {hi:.3f}); {smi}", flush=True)
    with torch.no_grad():
        for what, d in (("int8", d_q), ("bf16", d_f), ("int8", d_q), ("bf16", d_f)):
            ms = cuda_ms(lambda: d.teacher(x, m), reps=5, warmup=2)
            print(f"  [timing] the {what} teacher's forward on 12 x 12 s: {ms:.3f} ms (CUDA "
                  f"events, mean of 5); {smi}", flush=True)
    del d_q, d_f
    torch.cuda.empty_cache()

    e_q = UpstreamExpert(state, cfg, device="cuda", int8=True)
    e_f = UpstreamExpert(state, cfg, device="cuda")
    requests = [[torch.randn(int(3.7 * SR), generator=gen) * 0.1],
                ragged_wavs(gen, 4, 2.0, 16.0),
                [torch.randn(16 * SR, generator=gen) * 0.1 for _ in range(32)]]
    e_q(requests[0])
    for wav_list in requests:
        _build.reset_launches()
        oq = e_q(wav_list)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        want_l = plus_pos_conv({cf.KERNEL_PREFIX: 1, cf.KERNEL: len(cfg.conv_feature_layers) - 1,
                                fa.KERNEL: cfg.encoder_layers}, cfg, 1, teacher=False,
                               backward=False)
        if got != want_l:
            fail(f"[int8] serving: launches {got}, want {want_l}")
        of = e_f(wav_list)
        outs = list(zip((oq["last_hidden_state"], *oq["hidden_states"]),
                        (of["last_hidden_state"], *of["hidden_states"])))
        cos = [cosine(q.float(), f.float()) for q, f in outs]
        if min(cos) <= INT8_COSINE or all(torch.equal(q, f) for q, f in outs):
            fail(f"[int8] serving B={len(wav_list)}: cosine to the bf16 expert {cos}")
        if not torch.equal(oq["padding_mask"], of["padding_mask"]):
            fail("[int8] serving: padding masks differ")
        print(f"  int8 expert, request B={len(wav_list)}: {len(outs)} outputs, min cosine to "
              f"the bf16 expert's {min(cos):.6f} > {INT8_COSINE}, launches {json.dumps(got)} "
              f"ok", flush=True)
    bench = requests[-1]
    for what, e in (("int8", e_q), ("bf16", e_f), ("int8", e_q), ("bf16", e_f)):
        med, lo, hi = timed(lambda: e(bench), 10)
        print(f"  [timing] serving forward B=32 x 16 s, {what}: median {med:.3f} ms over 10 "
              f"(min {lo:.3f}, max {hi:.3f}), {32 * 16 / (med / 1e3):.1f} audio-s/s; {smi}",
              flush=True)
    profile_device(lambda: e_q(bench), "int8 forward", top=8)
    del e_q, e_f
    torch.cuda.empty_cache()


def options_phase(exp, geom, t_state, rand_layers, gen, smi):
    """[options] a release-width student with every option the port once
    refused (OPTIONS: layer_norm extractor, conv bias, a 3-deep positional
    conv, gelu_fast): a ragged bf16 step and one on a fixed batch with
    exact launches (the student's extractor takes JAX's unfused loop: no
    student K1, prefix or K6), then fp32 steps card vs CPU."""
    import torch

    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.train.step import Distiller

    exp_o = dataclasses.replace(exp, distiller=dataclasses.replace(exp.distiller, **OPTIONS))
    cfg, a, b = exp_o.distiller, exp_o.train.accumulate_grad_batches, exp_o.train.batch_size
    student = StudentModel(cfg, device="cpu").init_weights(gen)
    if student.feature_extractor.fused:
        fail("[options] the layer_norm extractor took the fused path")
    s_state = student.state_dict()
    l_s = cfg.encoder_layers
    per_step = plus_pos_conv(plus_k5({cf.KERNEL: len(geom.conv_feature_layers) - 1,
                                      cf.KERNEL_PREFIX: 1, fa.KERNEL: geom.encoder_layers,
                                      fa.KERNEL_DROPOUT: l_s, **attn_bwd(l_s)}, cfg, 1),
                             cfg, 1)
    d = Distiller(exp_o, t_state, s_state, device="cuda", num_training_steps=20)
    for what, batch in (("ragged", train_batch(gen, a, b, 12.0, ragged=True)),
                        ("fixed", train_batch(gen, a, b, 12.0, ragged=False))):
        logs, launches = launches_of_step(d, batch, rand_layers, per_step, f"[options] {what}")
        print(f"  {what} step: loss {logs['loss']:.6f} grad_norm {logs['grad_norm']:.6f}; "
              f"launches {json.dumps(launches)} ok", flush=True)
    if not all(torch.isfinite(p).all().item() for p in d.params):
        fail("[options] non-finite parameters")
    med, lo, hi = timed(lambda: d.train_step(batch, rand_layers), 5)
    print(f"  [timing] options train step, 3 x 4 x 12 s, bf16: median {med:.3f} ms over 5 "
          f"(min {lo:.3f}, max {hi:.3f}); {smi}", flush=True)
    profile_device(lambda: d.train_step(batch, rand_layers), "options train step", top=10,
                   unprofiled_ms=med)
    del d
    torch.cuda.empty_cache()
    fp32_card_vs_cpu(exp_o, t_state, s_state, gen, "[options]", rand=rand_layers)
    return launches


def conformer_dp_rank(spec_path):
    """One of the [conformer-dp] gloo ranks: for each case, a data-parallel
    conformer Distiller takes its steps on this rank's stripe; per step the
    logs and launches, and the state (parameters and BatchNorm statistics)
    as numpy arrays."""
    import torch

    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.step import Distiller

    dp, dev = gloo_rank_setup()
    spec = torch.load(spec_path, weights_only=False)
    out = {}
    for case in ("fp32", "bf16"):
        c = spec[case]
        d = Distiller(c["exp"], spec["t_state"], c["s_state"], device=dev,
                      num_training_steps=20, dp=dp)
        steps = []
        for batch in c["batches"]:
            local = {k: v[:, dp.rank::dp.world] for k, v in batch.items()}
            torch.cuda.synchronize()
            _build.reset_launches()
            logs = d.train_step(local, spec["rand"])
            torch.cuda.synchronize()
            steps.append(dict(logs=logs, launches=dict(_build.LAUNCHES)))
        out[case] = {"steps": steps, "state": {k: v.detach().cpu().numpy() for k, v in
                                               d.student.state_dict().items()}}
        del d
        torch.cuda.empty_cache()
    return out


def conformer_dp_phase(geom, t_state, per_step_of, gen, smi, tmp):
    """[conformer-dp] the rel_pos conformer (CONFORMER_DP_LAYERS layers)
    over two gloo ranks sharing the card: fp32 without dropout against one
    process on the global batch (logs, parameters, every BatchNorm's
    running statistics), and bf16 with dropout; in both, the ranks' states
    (statistics included) bit-identical, and each rank's launches a
    conformer step's on its rows."""
    import torch

    from fithubert_tpu_torch.config import conformer_experiment
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import dropout as kd
    from fithubert_tpu_torch.parallel.distributed import launch
    from fithubert_tpu_torch.train.step import Distiller

    exp_c = conformer_experiment("rel_pos")
    exp_c = dataclasses.replace(exp_c, distiller=dataclasses.replace(
        exp_c.distiller, encoder_layers=CONFORMER_DP_LAYERS, pred_layer_id=(3,)),
        loss=dataclasses.replace(exp_c.loss, distil_random_layer=CONFORMER_DP_LAYERS - 1))
    exp32 = dataclasses.replace(
        exp_c, train=dataclasses.replace(exp_c.train, use_fp16=False),
        distiller=dataclasses.replace(exp_c.distiller, compute_dtype="float32", dropout=0.0,
                                      attention_dropout=0.0, activation_dropout=0.0,
                                      dropout_input=0.0))
    s_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
    a, b = 2, exp_c.train.batch_size
    rand = torch.randperm(CONFORMER_DP_LAYERS - 1, generator=gen)
    spec = {"t_state": t_state, "rand": rand,
            "fp32": {"exp": exp32, "s_state": s_state,
                     "batches": [train_batch(gen, a, DP_WORLD * 1, 3.0, ragged=True),
                                 train_batch(gen, a, DP_WORLD * 1, 3.0, ragged=False)]},
            "bf16": {"exp": exp_c, "s_state": s_state,
                     "batches": [train_batch(gen, a, DP_WORLD * b, 12.0, ragged=True),
                                 train_batch(gen, a, DP_WORLD * b, 12.0, ragged=False)]}}
    spec_path = os.path.join(tmp, "conformer_dp_spec.pt")
    torch.save(spec, spec_path)
    t0 = time.perf_counter()
    try:
        ranks = launch(conformer_dp_rank, DP_WORLD, spec_path, timeout=DP_RANK_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"[conformer-dp] gloo ranks: {e}")
    print(f"  {DP_WORLD} ranks spawned, joined and done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for case in ("fp32", "bf16"):
        r0, r1 = ranks[0][case], ranks[1][case]
        for k in r0["state"]:
            if not (r0["state"][k] == r1["state"][k]).all():
                fail(f"[conformer-dp] {case}: {k} differs between the ranks")
        n_stats = sum(k.endswith(("running_mean", "running_var")) for k in r0["state"])
        for i, (s0, s1) in enumerate(zip(r0["steps"], r1["steps"])):
            if s0["logs"] != s1["logs"]:
                fail(f"[conformer-dp] {case} step {i}: logs differ between the ranks")
            local_rows = spec[case]["batches"][i]["x"].shape[1] // DP_WORLD
            want = per_step_of(dataclasses.replace(
                spec[case]["exp"], train=dataclasses.replace(
                    spec[case]["exp"].train, accumulate_grad_batches=a,
                    batch_size=local_rows)))
            if spec[case]["exp"].distiller.dropout == 0.0:
                want.pop(kd.KERNEL)  # no dropout: no probabilities dropped
            if spec[case]["exp"].distiller.compute_dtype == "float32":
                want.pop(cf.KERNEL_PREFIX)  # fp32: block 0's GroupNorm runs in K1's tiles
            for r, st in enumerate((s0, s1)):
                if st["launches"] != want:
                    fail(f"[conformer-dp] {case} step {i} rank {r}: launches {st['launches']}, "
                         f"want {want}")
        print(f"  {case}: after {len(r0['steps'])} steps the ranks' states ({len(r0['state'])} "
              f"tensors, {n_stats} BatchNorm running statistics) are bit-identical, their logs "
              f"equal; launches per rank {json.dumps(r0['steps'][-1]['launches'])} ok",
              flush=True)
    one = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20)
    for i, batch in enumerate(spec["fp32"]["batches"]):
        want = one.train_step(batch, rand)
        got = ranks[0]["fp32"]["steps"][i]["logs"]
        for key in ("loss", "grad_norm"):
            rel = abs(got[key] - want[key]) / abs(want[key])
            if rel > TRAIN_RTOL:
                fail(f"[conformer-dp] fp32 step {i}: {key} {got[key]} vs one process "
                     f"{want[key]} (rel {rel:.3e})")
        print(f"  fp32 step {i}: loss {got['loss']:.8f} vs one process {want['loss']:.8f}, "
              f"grad_norm {got['grad_norm']:.8f} vs {want['grad_norm']:.8f} tol rel "
              f"{TRAIN_RTOL} ok", flush=True)
    worst = worst_bn = 0.0
    for k, v in one.student.state_dict().items():
        g, c = torch.from_numpy(ranks[0]["fp32"]["state"][k]), v.detach().cpu()
        err = (g - c).abs()
        if k.endswith(("running_mean", "running_var")):
            worst_bn = max(worst_bn, err.max().item())
            if not bool((err <= BN_STATS_TOL["atol"] + BN_STATS_TOL["rtol"] * c.abs()).all()):
                fail(f"[conformer-dp] fp32: {k} differs from one process's by "
                     f"{err.max().item():.3e}")
        else:
            worst = max(worst, err.max().item())
    if worst > TRAIN_PARAM_ATOL:
        fail(f"[conformer-dp] fp32: parameters differ from one process's by {worst:.3e}")
    print(f"  fp32 vs one process on the global batch: parameters max_abs_err={worst:.3e} "
          f"tol={TRAIN_PARAM_ATOL}, BatchNorm statistics max_abs_err={worst_bn:.3e} "
          f"tol=({BN_STATS_TOL['atol']}, {BN_STATS_TOL['rtol']}) ok; {smi}", flush=True)
    del one
    torch.cuda.empty_cache()


# [tp]: tensor parallelism, the 'model' axis of the mesh (parallel/mesh.py),
# over gloo ranks that share the one card. NCCL refuses two ranks on one
# card, so every collective of the axis goes through the host, and the
# ranks' step walls measure gloo on this host, not tensor parallelism.
TP_MODEL = 2
# fp32 under the model axis against one process on the card: the row-parallel
# layers sum their partial products in another order, so the logs move by a
# few fp32 roundings (TP_LOGS_RTOL relative) and the parameters after AdamW
# by a small fraction of lr (TRAIN_PARAM_ATOL, the card-vs-CPU limit).
TP_LOGS_RTOL = 1e-5
TP_BF16_STEPS = 8  # on one fixed batch after a ragged one: the loss must fall


def tp_mesh_setup(model_axis):
    """This spawned rank's gloo group on the card and its mesh: (Mesh, device)."""
    from fithubert_tpu_torch.parallel.mesh import make_mesh

    _dp, dev = gloo_rank_setup()
    return make_mesh(model_axis=model_axis), dev


def tp_replicated_same(d, mesh):
    """True when this rank's replicated student parameters equal its row's
    rank 0's bit for bit (a broadcast over the row)."""
    import torch
    import torch.distributed as dist

    from fithubert_tpu_torch.parallel.mesh import shard_dims

    sharded = shard_dims(d.student, mesh.model)
    flat = torch.cat([p.detach().reshape(-1) for n, p in d.student.named_parameters()
                      if n not in sharded])
    ref = flat.clone()
    dist.broadcast(ref, mesh.data_rank * mesh.model, group=mesh.tp.group)
    return bool(torch.equal(flat, ref))


def tp_steps(d, mesh, batches, rand):
    """One step per batch on this rank's data stripe, each with the counts
    set to 0 just before it: per step the logs, launches, host wall (to a
    sync) and whether the replicated parameters equal the row's rank 0's."""
    import torch

    from fithubert_tpu_torch.ops.kernels import _build

    steps = []
    for batch in batches:
        local = {k: v[:, mesh.data_rank::mesh.data] for k, v in batch.items()}
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        logs = d.train_step(local, rand)
        torch.cuda.synchronize()
        steps.append(dict(logs=logs, launches=dict(_build.LAUNCHES),
                          ms=(time.perf_counter() - t0) * 1e3,
                          replicated_same=tp_replicated_same(d, mesh)))
    return steps


def tp_rank(spec_path, out_dir):
    """One of the [tp] (data 1 x model 2) gloo ranks: (a) fp32 without
    dropout, two steps (rank 0 saves the gathered state); (b) the bf16
    release step with dropout, a ragged step then TP_BF16_STEPS on one
    batch, and the keep masks of a sharded and a replicated site; (d) the
    int8 teacher sharded against one process's on this rank: payloads and
    forward. The result holds no tensor (see ``gloo_step_rank``)."""
    import torch

    from fithubert_tpu_torch.models.teacher import TeacherModel
    from fithubert_tpu_torch.parallel.mesh import COLUMN, shard_plan
    from fithubert_tpu_torch.train.step import Distiller

    mesh, dev = tp_mesh_setup(TP_MODEL)
    spec = torch.load(spec_path, weights_only=False)
    out = {}
    d = Distiller(spec["exp32"], spec["t_state"], spec["s_state"], device=dev,
                  num_training_steps=20, mesh=mesh)
    out["fp32"] = tp_steps(d, mesh, spec["fp32_batches"], spec["rand"])
    state = d.state_dict()["student"]
    if mesh.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(out_dir, "tp_fp32_params.pt"))
    out["fp32_shapes"] = {k: tuple(v.shape) for k, v in state.items()}
    out["fp32_local"] = sum(p.numel() for p in d.params)
    del d, state
    torch.cuda.empty_cache()

    d = Distiller(spec["exp"], spec["t_state"], spec["s_state"], device=dev,
                  num_training_steps=20, mesh=mesh)
    out["bf16"] = tp_steps(d, mesh, spec["bf16_batches"], spec["rand"])
    ones = torch.ones(1 << 16, device=dev)
    out["keep_sharded"] = (d._rng(0).dropout(ones, ATTN_P, sharded=True) != 0).cpu().numpy()
    out["keep_replicated"] = (d._rng(0).dropout(ones, ATTN_P) != 0).cpu().numpy()
    del d
    torch.cuda.empty_cache()

    geom_q = dataclasses.replace(spec["geom"], compute_dtype="bfloat16", quantize_int8=True)
    teachers = []
    for tp in (None, mesh.tp):
        t = TeacherModel(geom_q, device=dev)
        t.load_state_dict(spec["t_state"])
        teachers.append(t.freeze(tp))
    one, sharded = teachers
    payloads = 0
    for name, kind in shard_plan(one, TP_MODEL).items():
        dim = 0 if kind == COLUMN else 1
        a, b = one.get_submodule(name), sharded.get_submodule(name)
        same = torch.equal(mesh.tp.local(a.weight_q, dim), b.weight_q) and torch.equal(
            mesh.tp.local(a.weight_scale, 0) if kind == COLUMN else a.weight_scale,
            b.weight_scale)
        if not same:
            raise RuntimeError(f"[tp] int8 payload of {name} is not one process's slice")
        payloads += 1
    x, m = (spec["int8_batch"][k].to(dev) for k in ("x", "padding_mask"))
    with torch.no_grad():
        want, got = one(x, m), sharded(x, m)
    valid = ~want.padding_mask
    errs = []
    for (hw, _, _), (hg, _, _) in zip(want.layer_results, got.layer_results):
        errs.append(dict(max_abs=(hg.float() - hw.float())[valid].abs().max().item(),
                         scale=hw.float()[valid].abs().max().item(),
                         equal=bool(torch.equal(hg[valid], hw[valid]))))
    out["int8"] = dict(payloads=payloads, layers=errs)
    return out


def tp4_rank(spec_path, out_dir):
    """One of the [tp] (data 2 x model 2) gloo ranks: (c) fp32 steps on the
    data stripes (rank 0 saves the gathered state), then dryrun_multichip's
    tail: an eval, a checkpoint save, a restore into a fresh tensor-parallel
    Distiller and its eval."""
    import torch

    from fithubert_tpu_torch.train.checkpoint import CheckpointManager
    from fithubert_tpu_torch.train.step import Distiller

    mesh, dev = tp_mesh_setup(TP_MODEL)
    spec = torch.load(spec_path, weights_only=False)
    d = Distiller(spec["exp32"], spec["t_state"], spec["s_state"], device=dev,
                  num_training_steps=20, mesh=mesh)
    steps = tp_steps(d, mesh, spec["fp32_batches"], spec["rand"])
    state = d.state_dict()
    if mesh.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in state["student"].items()},
                   os.path.join(out_dir, "tp4_fp32_params.pt"))
    ev = {k: v[mesh.data_rank::mesh.data] for k, v in spec["eval_batch"].items()}
    v0 = d.eval_step(ev, spec["rand"])["v_loss"]
    ckpt = CheckpointManager(os.path.join(out_dir, "tp_ckpt"), dp=mesh.world)
    ckpt.save(d.step, state, v0)
    del d, state
    fresh = Distiller(spec["exp32"], spec["t_state"], spec["s_state"], device=dev,
                      num_training_steps=20, mesh=mesh)
    fresh.load_state_dict(ckpt.restore())
    return dict(steps=steps, v_loss=v0, v_loss_restored=fresh.eval_step(ev, spec["rand"])["v_loss"],
                step_restored=fresh.step)


def tp_phase(exp, exp32, geom, t_state, s_state, rand_layers, gen, per_step, tmp, smi, errs):
    """[tp] the model axis over gloo ranks sharing the card, the release
    config at full width: (a) (data 1 x model 2) fp32 without dropout
    against one process (logs, gathered parameters, replicated parameters
    bit for bit across the row, one process's keys and shapes); (b) the
    same mesh in bf16 with dropout (each rank's launches the release
    step's, K2 and the backward at 6 heads; a falling loss; replicated parameters bit
    for bit; keep masks apart on the sharded sites); (c) (data 2 x model 2)
    fp32 against one process, then an eval, a save, a restore and an equal
    v_loss; (d) the int8 teacher sharded: its payloads one process's
    slices, its forward against one process's. Returns rank 0's launches
    of its last bf16 step."""
    import torch

    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.parallel.distributed import launch
    from fithubert_tpu_torch.train.step import Distiller

    cfg = exp.distiller
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size
    h, d_head = cfg.encoder_attention_heads, cfg.encoder_embed_dim // cfg.encoder_attention_heads
    t_att = cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    t_teacher = cf.out_len(12 * SR, geom.conv_feature_layers)
    student_rank = (a * b, t_att, h // TP_MODEL, d_head)
    teacher_rank = (a * b, t_teacher, geom.encoder_attention_heads // TP_MODEL,
                    geom.encoder_embed_dim // geom.encoder_attention_heads)
    print(f"  K2 with dropout p={ATTN_P} and the backward at the student's per-rank "
          f"{student_rank}, and K2 at the teacher's per-rank {teacher_rank}, vs the plain "
          f"versions", flush=True)
    check_attention_training_kernels(fa, gen, torch.device("cuda"), errs,
                                     cases=(student_rank + (False,),), path="@tp")
    q, k, v, _dout, m = attention_case(gen, *teacher_rank, torch.bfloat16, "cuda", False)
    errs["attn_tp"] = compare(f"flash_attention bfloat16 {teacher_rank}",
                              fa.flash_attention(q, k, v, m), fa.attention_plain(q, k, v, m)[0],
                              "bfloat16", ~m.all(-1))
    del q, k, v, _dout, m

    fp32_batches = [train_batch(gen, 2, 2, 3.0, ragged=True),
                    train_batch(gen, 2, 2, 3.0, ragged=False)]
    bf16_batches = [train_batch(gen, a, b, 12.0, ragged=True)] + \
        [train_batch(gen, a, b, 12.0, ragged=False)] * TP_BF16_STEPS
    spec = {"t_state": t_state, "s_state": s_state, "rand": rand_layers, "geom": geom,
            "exp": exp, "exp32": exp32, "fp32_batches": fp32_batches,
            "bf16_batches": bf16_batches,
            "eval_batch": {k: v[0] for k, v in fp32_batches[0].items()},
            "int8_batch": {k: v[0] for k, v in train_batch(gen, 1, b, 12.0, ragged=True).items()}}
    spec_path = os.path.join(tmp, "tp_spec.pt")
    torch.save(spec, spec_path)
    runs = {}
    for name, fn, world in (("data 1 x model 2", tp_rank, TP_MODEL),
                            ("data 2 x model 2", tp4_rank, 2 * TP_MODEL)):
        t0 = time.perf_counter()
        try:
            runs[name] = launch(fn, world, spec_path, tmp, timeout=DP_RANK_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"[tp] {name} gloo ranks: {e}")
        print(f"  {name}: {world} gloo ranks spawned, joined and done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    r2, r4 = runs["data 1 x model 2"], runs["data 2 x model 2"]

    # (a) and (c): fp32 against one process on the card, on the global batch
    one = Distiller(exp32, t_state, s_state, device="cuda", num_training_steps=20)
    want_shapes = None
    for i, batch in enumerate(fp32_batches):
        want = one.train_step(batch, rand_layers)
        for mesh_name, ranks, steps_of in (("(a) data 1 x model 2", r2, lambda r: r["fp32"]),
                                           ("(c) data 2 x model 2", r4, lambda r: r["steps"])):
            for r, rank in enumerate(ranks):
                got = steps_of(rank)[i]
                worst = max(abs(got["logs"][key] - w) / max(abs(w), 1e-12)
                            for key, w in want.items() if key != "lr")
                if worst > TP_LOGS_RTOL or got["logs"]["lr"] != want["lr"]:
                    fail(f"[tp] {mesh_name} fp32 step {i} rank {r}: logs {got['logs']} vs one "
                         f"process {want} (worst rel {worst:.3e})")
                if not got["replicated_same"]:
                    fail(f"[tp] {mesh_name} fp32 step {i} rank {r}: replicated parameters "
                         "differ from the row's rank 0")
            print(f"  {mesh_name} fp32 step {i}: loss {want['loss']:.8f} (ranks "
                  f"{[steps_of(rk)[i]['logs']['loss'] for rk in ranks]}), grad_norm "
                  f"{want['grad_norm']:.8f} (ranks "
                  f"{[steps_of(rk)[i]['logs']['grad_norm'] for rk in ranks]}), every log within "
                  f"rel {TP_LOGS_RTOL}; replicated parameters bit for bit across the row ok",
                  flush=True)
    want_sd = {k: v.detach().cpu() for k, v in one.student.state_dict().items()}
    want_shapes = {k: tuple(v.shape) for k, v in want_sd.items()}
    for mesh_name, path in (("(a)", "tp_fp32_params.pt"), ("(c)", "tp4_fp32_params.pt")):
        got_sd = torch.load(os.path.join(tmp, path), weights_only=True)
        if {k: tuple(v.shape) for k, v in got_sd.items()} != want_shapes:
            fail(f"[tp] {mesh_name}: the gathered state's keys and shapes are not one process's")
        worst = max((got_sd[k] - v).abs().max().item() for k, v in want_sd.items())
        if worst > TRAIN_PARAM_ATOL:
            fail(f"[tp] {mesh_name}: gathered parameters differ from one process's by "
                 f"{worst:.3e}")
        print(f"  {mesh_name} the gathered state_dict: one process's {len(want_shapes)} keys and "
              f"shapes; parameters after 2 steps vs one process max_abs_err={worst:.3e} "
              f"tol={TRAIN_PARAM_ATOL} ok", flush=True)
    if any(r["fp32_shapes"] != want_shapes for r in r2):
        fail("[tp] (a): a rank's gathered state has other keys or shapes")
    total = sum(p.numel() for p in one.params)
    print(f"  (a) student parameters per model rank {[r['fp32_local'] for r in r2]} of "
          f"{total} in one process", flush=True)
    del one
    torch.cuda.empty_cache()
    for r, rank in enumerate(r4):
        if rank["v_loss_restored"] != rank["v_loss"] or not math.isfinite(rank["v_loss"]):
            fail(f"[tp] (c) rank {r}: v_loss {rank['v_loss']} after the restore "
                 f"{rank['v_loss_restored']}")
    if len({rank["v_loss"] for rank in r4}) != 1:
        fail(f"[tp] (c): the ranks' v_loss differ: {[rank['v_loss'] for rank in r4]}")
    print(f"  (c) dryrun tail: eval v_loss {r4[0]['v_loss']!r} on every rank; saved by rank 0, "
          f"restored into a fresh tensor-parallel Distiller at step {r4[0]['step_restored']}: "
          f"v_loss {r4[0]['v_loss_restored']!r}, equal bit for bit ok", flush=True)

    # (b): bf16 with the release dropout
    losses = []
    for i in range(len(bf16_batches)):
        steps = [rank["bf16"][i] for rank in r2]
        for r, st in enumerate(steps):
            if st["launches"] != per_step:
                fail(f"[tp] (b) bf16 step {i} rank {r}: launches {st['launches']}, "
                     f"want {per_step}")
            if not st["replicated_same"] or st["logs"] != steps[0]["logs"]:
                fail(f"[tp] (b) bf16 step {i} rank {r}: replicated parameters or logs differ "
                     "from the row's rank 0")
            if not all(math.isfinite(x) for x in st["logs"].values()):
                fail(f"[tp] (b) bf16 step {i}: non-finite logs {st['logs']}")
        if i:
            losses.append(steps[0]["logs"]["loss"])
        print(f"  (b) bf16 step {i} ({'ragged' if i == 0 else 'fixed batch'}): loss "
              f"{steps[0]['logs']['loss']:.6f} grad_norm {steps[0]['logs']['grad_norm']:.6f} "
              f"on both ranks; replicated parameters bit for bit; launches per rank the release "
              f"step's ok; wall per rank (gloo through the host, two ranks on one card) "
              f"{[round(st['ms'], 3) for st in steps]} ms", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"[tp] (b): the loss did not fall over {TP_BF16_STEPS} steps: {losses}")
    k0, k1 = r2[0], r2[1]
    if (k0["keep_sharded"] == k1["keep_sharded"]).all() or \
            not (k0["keep_replicated"] == k1["keep_replicated"]).all():
        fail("[tp] (b): the model ranks' keep masks agree on a sharded site or differ on a "
             "replicated one")
    agree = float((k0["keep_sharded"] == k1["keep_sharded"]).mean())
    print(f"  (b) loss fell {losses[0]:.6f} -> {losses[-1]:.6f} over {TP_BF16_STEPS} steps; "
          f"launches per rank {json.dumps(r2[0]['bf16'][-1]['launches'])}; keep masks of a "
          f"sharded site agree on {agree:.3f} of 65536 positions between the model ranks "
          f"(independent at p = {ATTN_P}: {1 - 2 * ATTN_P * (1 - ATTN_P):.3f}), a replicated "
          f"site's everywhere ok; {smi}", flush=True)

    # (d): the int8 teacher
    for r, rank in enumerate(r2):
        q8 = rank["int8"]
        rtol, atol = TOL["bfloat16"]
        for i, e in enumerate(q8["layers"]):
            if e["max_abs"] > atol + rtol * e["scale"]:
                fail(f"[tp] (d) rank {r} layer {i}: int8 teacher hidden max_abs_err "
                     f"{e['max_abs']:.3e} against one process's (scale {e['scale']:.3e})")
        equal = all(e["equal"] for e in q8["layers"])
        print(f"  (d) rank {r}: {q8['payloads']} sharded int8 payloads and scales equal one "
              f"process's slices bit for bit; the teacher's {len(q8['layers'])} layer hiddens "
              f"(valid frames, {b} x 12 s bf16) against one process's int8 forward: "
              f"{'bit for bit' if equal else 'max_abs_err ' + str(max(e['max_abs'] for e in q8['layers']))}"
              f" ok", flush=True)
    return r2[0]["bf16"][-1]["launches"]


# [smoke-configs]: the head sizes of the attention checks beside the
# compiled ones: the smoke configs' student (48 / 4) and teacher (64 / 4),
# one compiled as it is (80) and the largest (128). Each pads to
# flash_attention.HEAD_DIMS and is held to the plain version at TOL.
SMOKE_HEAD_DIMS = (12, 16, 80, 128)
SMOKE_RUNS = (("smoke fp32", "configs/smoke.yaml", ()),
              ("smoke bf16", "configs/smoke.yaml", ("train.use_fp16=true",)),
              ("smoke_ctc fp32", "configs/smoke_ctc.yaml", ()))
# [chain]: the K of train.steps_per_launch, and where the graph's steps are
# not bit for bit those of K eager steps, the JAX package's own bounds for
# its chain against single steps (tests/test_train_step.py:380-412): the
# loss to 2e-5 relative, each parameter to 1e-5 + 2e-4 relative.
CHAIN_K = 4
CHAIN_ROUNDS = 2  # eager, then graphed, K steps a round: the wall medians
# what a kernel row's launches count, where not one train step's
LAUNCHES_OVER = {"serving": "over the 3 serving requests", "ex-serving": "a served call",
                 "smoke": "over the whole smoke bf16 run, its steps and evals",
                 "tp": "per train step on each model rank"}
CHAIN_LOSS_RTOL, CHAIN_PARAM_ATOL, CHAIN_PARAM_RTOL = 2e-5, 1e-5, 2e-4


def smoke_configs_phase(gen, smi, tmp, errs):
    """[smoke-configs] configs/smoke.yaml through train_torch.py in fp32
    and bf16 (``use_fp16``), and configs/smoke_ctc.yaml, each in this
    process with a falling loss and the kernels it launched; then K2 and the backward at
    SMOKE_HEAD_DIMS against their plain versions in both dtypes, and K1 and
    K6 at the smoke student's widths (32, 48: padded to 64) in bf16.
    Returns {run label: its launches}."""
    import torch

    import train_torch
    from fithubert_tpu_torch.config import load_experiment_yaml
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa

    runs = {}
    for label, path, sets in SMOKE_RUNS:
        out = os.path.join(tmp, label.replace(" ", "_"))
        argv = ["-c", path, "--no-resume", "--set", f"train.output_dir={out}"]
        for item in sets:
            argv += ["--set", item]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        result = train_torch.main(argv)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        train, val = logged(out)
        losses = [train[k]["loss"] for k in sorted(train)]
        if not losses or not all(math.isfinite(x) for x in losses):
            fail(f"[smoke-configs] {label}: no finite losses logged: {losses}")
        first, last = statistics.mean(losses[:2]), statistics.mean(losses[-2:])
        if not last < first:
            fail(f"[smoke-configs] {label}: the loss did not fall: {losses}")
        want = [cf.KERNEL, fa.KERNEL, fa.KERNEL_BWD_PREP, cf.KERNEL_BWD]
        if "bf16" in label:
            want += [cf.KERNEL_PREFIX, fa.KERNEL_BWD, fa.KERNEL_DQ_SUM]
        else:
            want += [fa.KERNEL_DQ_F32, fa.KERNEL_DKV_F32]
        if any(launches.get(n, 0) < 1 for n in want):
            fail(f"[smoke-configs] {label}: launches {launches}, want every one of {want}")
        runs[label] = launches
        print(f"  {label}: train_torch.py -c {path} {' '.join(sets)}: {result['steps']} steps "
              f"in {time.perf_counter() - t0:.1f} s, loss {losses[0]:.6f} -> {losses[-1]:.6f} "
              f"(means of the first and last two logged {first:.6f} -> {last:.6f}), "
              f"{len(val)} evals, launches {json.dumps(launches)} ok", flush=True)

    print(f"[smoke-configs] K2 (p = 0 and p = {ATTN_P}) and the backward at head sizes "
          f"{SMOKE_HEAD_DIMS} (compiled {fa.HEAD_DIMS}), ragged, vs the plain versions",
          flush=True)
    dev = torch.device("cuda")
    for d in SMOKE_HEAD_DIMS:
        check_attention_training_kernels(fa, gen, dev, errs,
                                         cases=((4, 299, 4, d, False), (2, 130, 2, d, True)),
                                         path=f"@D={d}")
    exp_s = load_experiment_yaml("configs/smoke.yaml")
    student = StudentModel(exp_s.distiller, device="cpu").init_weights(gen)
    wavs = ragged_wavs(gen, 3, 0.5, 2.0) + [torch.randn(2 * SR, generator=gen) * 0.1]
    print(f"[smoke-configs] K1 and its prefix on the smoke student's stack "
          f"{student.feature_extractor.spec[1:]} (C0 {student.feature_extractor.spec[0][0]}), "
          f"B=4 x (ragged, up to 2 s); bf16 pads the widths to "
          f"{cf.WIDTH_MULTIPLE[torch.bfloat16]}", flush=True)
    errs["conv@smoke"], errs["prefix@smoke"] = check_conv_stack(student, wavs, dev, "smoke")
    print("[smoke-configs] K6 vs conv_stack_bwd_plain and the library recompute on the smoke "
          "student's stack, 4 x 2 s", flush=True)
    train_wavs = [torch.randn(2 * SR, generator=gen) * 0.1 for _ in range(4)]
    errs[cf.KERNEL_BWD + "@smoke"] = check_conv_backward(cf, student, train_wavs, gen, dev)
    print(f"[smoke-configs] every check passed; {smi}", flush=True)
    return runs


def _student_state_equal(d0, d1):
    """(names of the student tensors that differ, worst |difference|)."""
    import torch

    diff, worst = [], 0.0
    sd1 = d1.student.state_dict()
    for name, t in d0.student.state_dict().items():
        if not torch.equal(t, sd1[name]):
            diff.append(name)
            worst = max(worst, (t.float() - sd1[name].float()).abs().max().item())
    return diff, worst


def remat_phase(exp, geom, t_state, s_state, rand_layers, gen, smi):
    """[remat] ``checkpoint_activations`` on against off from one state: the
    release step and the rel_pos conformer step (4 microbatches, its
    BatchNorm statistics), two steps each; loss, grad_norm, every parameter
    and statistic bit for bit, and the peak memory of each."""
    import torch

    from fithubert_tpu_torch.config import conformer_experiment
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.train.step import Distiller

    exp_c = conformer_experiment("rel_pos")
    c_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
    for what, e, st, rand in (("release", exp, s_state, rand_layers),
                              ("rel_pos conformer", exp_c, c_state,
                               torch.randperm(exp_c.distiller.encoder_layers - 1,
                                              generator=gen))):
        a, b = e.train.accumulate_grad_batches, e.train.batch_size
        batch = train_batch(gen, a, b, 12.0, ragged=False)
        runs = []
        for remat in (False, True):
            er = dataclasses.replace(e, distiller=dataclasses.replace(
                e.distiller, checkpoint_activations=remat))
            d = Distiller(er, t_state, st, device="cuda", num_training_steps=20)
            d.train_step(batch, rand)  # warm-up: the first step's allocations
            d.optimizer.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()  # everything resident before the step
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logs = d.train_step(batch, rand)
            torch.cuda.synchronize()
            runs.append((d, logs, (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                         (time.perf_counter() - t0) * 1e3))
        (d0, l0, m0, t_off), (d1, l1, m1, t_on) = runs
        diff, worst = _student_state_equal(d0, d1)
        if l0 != l1 or diff:
            fail(f"[remat] {what}: logs {l0} vs {l1}; {len(diff)} tensors differ (worst "
                 f"{worst:.3e}), first {diff[:3]}")
        n_stats = sum(n.endswith(("running_mean", "running_var")) for n in
                      d0.student.state_dict())
        print(f"  {what}, {b} x {a} x 12 s bf16, 2 steps: loss {l0['loss']:.6f} grad_norm "
              f"{l0['grad_norm']:.6f} bit for bit, every parameter and {n_stats} BatchNorm "
              f"statistics bit for bit ok; the second step's peak memory above what was "
              f"resident before it {m0:.3f} GiB off -> {m1:.3f} GiB on, its wall "
              f"{t_off:.1f} -> {t_on:.1f} ms; {smi}", flush=True)
        del runs, d0, d1
        torch.cuda.empty_cache()


def _chain_compare(what, logs_g, logs_e, dg, de):
    """The graph's K steps against K eager steps from the same state: logs,
    parameters, AdamW's moments and the BatchNorm statistics bit for bit,
    or within the JAX chain test's bounds, naming what differs."""
    import torch

    for i, (g, e) in enumerate(zip(logs_g, logs_e)):
        for key in e:
            if g[key] != e[key] and abs(g[key] - e[key]) > CHAIN_LOSS_RTOL * abs(e[key]):
                fail(f"[chain] {what} step {i}: {key} graph {g[key]} vs eager {e[key]}")
    diff, worst = _student_state_equal(dg, de)
    moments = []
    for p_g, p_e in zip(dg.params, de.params):
        sg, se = dg.optimizer.state[p_g], de.optimizer.state[p_e]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(sg[key], se[key]):
                moments.append(key)
    exact = logs_g == logs_e and not diff and not moments
    if not exact:
        sd_e = de.student.state_dict()
        for name, t in dg.student.state_dict().items():
            ref = sd_e[name].float()
            if ((t.float() - ref).abs() > CHAIN_PARAM_ATOL + CHAIN_PARAM_RTOL * ref.abs()).any():
                fail(f"[chain] {what}: {name} outside the JAX chain bounds")
    return exact, diff, worst, moments


def bucketed_launches(e, k, tmp, n_rows=28539, epochs=3, seed=0):
    """How ``run_training`` launches a shuffled, length-bucketed corpus with
    ``steps_per_launch`` k, counted on the host through the loop's own
    grouping (``loop._launch_groups``, ``_use_chain``): ``n_rows``
    utterances (train-clean-100's count) with lengths drawn uniformly in
    [2, 16] s from ``seed`` (a synthetic distribution, not LibriSpeech's),
    bucketed by ``BucketedLibriSpeech`` with ``e``'s batch size, accumulation
    and length quantum, ``epochs`` shuffled epochs. Returns (steps, steps in
    full runs of k, that is chained, chained launches, distinct shapes)."""
    import csv

    import numpy as np

    from fithubert_tpu_torch.data.librispeech import BucketedLibriSpeech, quantize_length
    from fithubert_tpu_torch.train import loop as tloop

    lengths = np.random.default_rng(seed).integers(2 * SR, 16 * SR + 1, n_rows)
    root = os.path.join(tmp, "bucketed_lengths")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "synthetic.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["file_path", "length"])
        w.writeheader()
        for i, n in enumerate(lengths):
            w.writerow({"file_path": f"u{i}.wav", "length": int(n)})
    cfg = dataclasses.replace(e.data, bucketing_path=root, libri_root="")
    ds = BucketedLibriSpeech(cfg, ["synthetic"], e.train.batch_size,
                             e.train.accumulate_grad_batches, seed=seed)
    steps = chained = launches = 0
    shapes = set()
    for ep in range(epochs):
        raws = []
        for group in ds._groups(ep):  # _build_group's padded length, without the audio
            t_pad = max(quantize_length(max(n for _p, n in ds.buckets[int(g)]),
                                        cfg.length_quantum, cfg.max_wav_length)
                        for g in group if int(g) >= 0)
            shapes.add(t_pad)
            x = np.broadcast_to(np.float32(0), (len(group), ds.batch_size, t_pad))
            raws.append({"x": x})
        for run in tloop._launch_groups([(r, None) for r in raws], k):
            steps += len(run)
            if tloop._use_chain(len(run), k):
                chained += len(run)
                launches += 1
    return steps, chained, launches, len(shapes)


def chain_phase(paths, t_state, gen, smi, tmp):
    """[chain] ``train.steps_per_launch`` = CHAIN_K on the card: for each
    path in ``paths`` ({name: (experiment, student state, rand layers,
    per-step launches)}), the graph's K steps (its second call: the first
    ran K eager steps as the warm-up, then captured) against K eager steps
    from the same state; the launches counted at capture; the wall per
    step, eager against graphed, the replay's device time and the capture
    time. Then
    run_training with steps_per_launch CHAIN_K on a synthetic corpus."""
    import torch

    from fithubert_tpu_torch.ops.kernels import _build
    from fithubert_tpu_torch.train.loop import run_training
    from fithubert_tpu_torch.train.step import Distiller

    k = CHAIN_K
    for name, (e, st, rand, per_step) in paths.items():
        a, b = e.train.accumulate_grad_batches, e.train.batch_size
        batches = [train_batch(gen, a, b, 12.0, ragged=False) for _ in range(2 * k)]
        dg = Distiller(e, t_state, st, device="cuda", num_training_steps=50)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        dg.train_step_chain(batches[:k], rand)  # k eager warm-up steps, then the capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counted = dict(_build.LAUNCHES)
        want = {n: 2 * k * c for n, c in per_step.items()}
        if counted != want:
            fail(f"[chain] {name}: the first call launched {counted}, want 2 x {k} steps of "
                 f"{per_step} (the eager warm-up and the capture)")
        de = Distiller(e, t_state, st, device="cuda", num_training_steps=50)
        # a copy: AdamW's load_state_dict keeps tensors already on the card,
        # so dg's replay would move de's moments too
        de.load_state_dict(copy.deepcopy(dg.state_dict()))
        _build.reset_launches()
        logs_g = [lg.to_floats() for lg in dg.train_step_chain(batches[k:], rand)]
        torch.cuda.synchronize()
        if _build.LAUNCHES:
            fail(f"[chain] {name}: a replay launched from Python: {dict(_build.LAUNCHES)}")
        logs_e = [de.train_step(bt, rand) for bt in batches[k:]]
        exact, diff, worst, moments = _chain_compare(name, logs_g, logs_e, dg, de)
        n_stats = sum(n.endswith(("running_mean", "running_var")) for n in
                      dg.student.state_dict())
        how = "bit for bit" if exact else (
            f"within the JAX chain bounds, not bit for bit: {len(diff)} tensors differ "
            f"(worst {worst:.3e}, first {diff[:3]}), moments {sorted(set(moments))}")
        print(f"  {name}: {k} graphed steps == {k} eager steps from one state: logs "
              f"{[round(lg['loss'], 6) for lg in logs_g]}, parameters, AdamW moments and "
              f"{n_stats} statistics {how} ok; the first call (the {k} eager warm-up steps "
              f"and the capture) {first_s:.2f} s, counted {json.dumps(counted)}, a replay "
              f"counts none", flush=True)
        # wall and device busy per step, eager against graphed, in turns
        eager_ms, graph_ms = [], []
        for _ in range(CHAIN_ROUNDS):
            for d_, out in ((de, eager_ms), (dg, graph_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if d_ is dg:
                    dg.train_step_chain(batches[:k], rand)
                else:
                    for bt in batches[:k]:
                        de.train_step_async(bt, rand)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3 / k)
        e_med, g_med = statistics.median(eager_ms), statistics.median(graph_ms)
        # the replay's device time, from CUDA events around it (one launch:
        # the host queues nothing else inside it); the eager steps' device
        # busy is [timing]'s profile of the same path
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        dg.train_step_chain(batches[:k], rand)
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end)
        capture_s = next(iter(dg._chains.values())).capture_s  # the capture alone
        print(f"  {name} per step: wall eager {e_med:.3f} ms, graphed {g_med:.3f} ms (medians "
              f"of {CHAIN_ROUNDS} rounds of {k}: {sorted(eager_ms)}, {sorted(graph_ms)}); the "
              f"replay's device time {replay_ms / k:.3f} ms a step (CUDA events); capture "
              f"{capture_s:.2f} s; {smi}", flush=True)
        del dg, de, d_
        torch.cuda.empty_cache()

    name, (e, st, rand, per_step) = next(iter(paths.items()))
    n_batches, max_steps = 2 * k + 2, k + 2  # train steps an epoch; the cap
    e_loop = dataclasses.replace(
        e, data=dataclasses.replace(e.data, synthetic=True,
                                    synthetic_num_batches=n_batches * e.train.accumulate_grad_batches,
                                    synthetic_wav_length=12 * SR),
        train=dataclasses.replace(e.train, steps_per_launch=k, max_steps=max_steps,
                                  num_epochs=1, log_every=1,
                                  output_dir=os.path.join(tmp, "chain_loop")),
        teacher=dataclasses.replace(e.teacher, teacher_model=""))
    replays, chained = [], Distiller._replay

    def counted_replay(self, chain, inputs):
        replays.append(len(inputs))
        return chained(self, chain, inputs)

    Distiller._replay = counted_replay
    try:
        t0 = time.perf_counter()
        result = run_training(e_loop, resume=False, device="cuda")
    finally:
        Distiller._replay = chained
    train, _val = logged(e_loop.train.output_dir)
    # log_every 1: the loop logs each launch's last step, as the JAX loop does
    if not max_steps <= result["steps"] < max_steps + k or replays != [k] or \
            sorted(train) != [k, 2 * k] or not all(math.isfinite(train[s_]["loss"])
                                                  for s_ in train):
        fail(f"[chain] run_training: {result}, replays {replays}, logged steps {sorted(train)}")
    print(f"  run_training, {name}, steps_per_launch {k}, max_steps {max_steps}, "
          f"{n_batches} synthetic batches: {result['steps']} steps (may pass max_steps by "
          f"< {k}), the first {k} eager and captured, the next {k} one replay, losses "
          f"{[round(train[s_]['loss'], 6) for s_ in sorted(train)]} logged at each launch's "
          f"last step, in {time.perf_counter() - t0:.1f} s ok", flush=True)
    # real corpora are bucketed by length: a run of K equal shapes is rarer
    steps, chained, launches, n_shapes = bucketed_launches(e, k, tmp)
    print(f"  a shuffled, length-bucketed corpus (28539 utterances, lengths uniform in "
          f"[2, 16] s, {name}'s batch {e.train.accumulate_grad_batches} x "
          f"{e.train.batch_size}, quantum {e.data.length_quantum} samples, 3 epochs): "
          f"{steps} steps over {n_shapes} padded lengths, {chained} of them "
          f"({100.0 * chained / steps:.1f}%) in {launches} graph replays of {k}, the other "
          f"{steps - chained} single steps", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    laps = [("device and build", t_start)]

    def lap(name):
        """Print how long the phase that ends here took, the card memory
        still allocated after it and the Distillers the script still holds,
        then start ``name``."""
        what, t0 = laps[-1]
        now = time.perf_counter()
        torch_ = sys.modules.get("torch")
        held = ""
        if torch_ is not None and torch_.cuda.is_initialized():
            live = sum(type(o).__name__ == "Distiller" for o in gc.get_objects())
            held = (f", {torch_.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated after it, "
                    f"{live} Distillers alive")
        print(f"[phases] {what}: {now - t0:.1f} s{held}", flush=True)
        laps.append((name, now))

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    try:
        from fithubert_tpu_torch.config import (
            conformer_experiment,
            ex_experiment,
            fithubert_960h,
            fithubert_960h_experiment,
            load_experiment_yaml,
        )
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
            if kernel.startswith("flash_bwd_fused") and regs != fa.BWD_FUSED_REGS:
                fail(f"{kernel}: built with {regs} registers, not the {fa.BWD_FUSED_REGS} "
                     f"its setmaxnreg plan hands out")
            if kernel.startswith("flash_fwd_wgmma"):
                plan = fa.FWD_REGS[int(kernel.split("<")[1].split(",")[0])]
                if regs != plan:
                    fail(f"{kernel}: built with {regs} registers, not the {plan} its "
                         f"setmaxnreg plan hands out")

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
    lap("kernels")
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
    # the wav2vec2-Large teacher of [large]: 16 heads of 64 over the same frames
    large_attn = (12, teacher_attn[1], LARGE["encoder_attention_heads"],
                  LARGE["encoder_embed_dim"] // LARGE["encoder_attention_heads"])
    for (b, t, h, d) in ((8, 399, 12, 40), (4, 799, 12, 64), teacher_attn, large_attn,
                         (2, 130, 2, 40)):
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
            elif dtype_name == "bfloat16" and (b, t, h, d) == large_attn:
                errs["attn_large"] = e
            elif dtype_name == "bfloat16" and b != 2:
                errs["attn"] = max(errs.get("attn", 0.0), e)

    print(f"[kernels] K2 with dropout p={ATTN_P} and the backward vs the plain versions on the "
          f"same keep mask, ragged masks", flush=True)
    check_attention_training_kernels(fa, gen, dev, errs)

    student_attn = (exp.train.batch_size * exp.train.accumulate_grad_batches,
                    cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor,
                    cfg.encoder_attention_heads,
                    cfg.encoder_embed_dim // cfg.encoder_attention_heads)
    print(f"[kernels] K2 in bf16 vs attention_fwd_tiles_plain (the kernel's own roundings) at "
          f"the student's {student_attn}, p={ATTN_P}, and the teacher's {teacher_attn}, p=0; "
          f"two runs and a CUDA-graph replay with new seed words bit for bit", flush=True)
    errs["attn_tiles"] = check_fwd_tiles(fa, gen, dev, (student_attn + (ATTN_P,),
                                                        teacher_attn + (0.0,)))

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

    # the ex student (configs/ex.yaml): 2 layers of 768 (12 heads of 64), the
    # 512-wide extractor of the teacher's spec, trained from its first block
    exp_ex = ex_experiment()
    ex_cpu = StudentModel(exp_ex.distiller, device="cpu").init_weights(gen)
    a_ex, b_ex = exp_ex.train.accumulate_grad_batches, exp_ex.train.batch_size
    ex_wavs = ragged_wavs(gen, a_ex * b_ex - 1, 2.0, 12.0) + [torch.randn(12 * SR, generator=gen)
                                                               * 0.1]
    ex_frames = cf.out_len(12 * SR, exp_ex.distiller.conv_feature_layers)
    ex_t = -(-ex_frames // exp_ex.distiller.required_seq_len_multiple) \
        * exp_ex.distiller.required_seq_len_multiple  # 599 frames pad to 600
    ex_h = exp_ex.distiller.encoder_attention_heads
    ex_attn = (a_ex * b_ex, ex_t, ex_h, exp_ex.distiller.encoder_embed_dim // ex_h)
    print(f"[kernels] ex: K2 with dropout p={ATTN_P} and the backward at the ex student's "
          f"{ex_attn}, ragged, vs the plain versions", flush=True)
    check_attention_training_kernels(fa, gen, dev, errs, cases=(ex_attn + (False,),), path="@ex")
    print(f"[kernels] ex: K1 (conv_stack_cuda) and its prefix on the ex student's 512-wide "
          f"stack at B={a_ex * b_ex} x (ragged, up to 12 s)", flush=True)
    errs["conv_ex"], errs["prefix_ex"] = check_conv_stack(ex_cpu, ex_wavs, dev, "ex student")
    print(f"[kernels] ex: K6 vs conv_stack_bwd_plain and the library recompute on the ex "
          f"student's stack at {a_ex * b_ex} x 12 s, dW bit for bit across two calls; its up "
          f"pass vs K1", flush=True)
    ex_train_wavs = [torch.randn(12 * SR, generator=gen) * 0.1 for _ in range(a_ex * b_ex)]
    errs[cf.KERNEL_BWD + "@ex"] = check_conv_backward(cf, ex_cpu, ex_train_wavs, gen, dev)
    check_up_pass(cf, ex_cpu, ex_train_wavs, dev)

    # the conformers (conformer_experiment): rel_pos and rope drop their
    # materialised probabilities through K5 in every layer, at 599 frames a
    # 12 s row (no TR) and 799 a 16 s serving row; abs runs K2 and the backward at the TR'd 299
    t_conf = cf.out_len(12 * SR, cfg.conv_feature_layers)
    k5_train = (exp.train.batch_size, cfg.encoder_attention_heads, t_conf, t_conf)
    t_serve = cf.out_len(16 * SR, cfg.conv_feature_layers)
    print(f"[kernels] conformer: K5 (seeded_dropout_cuda) vs seeded_dropout_plain at the "
          f"rel_pos conformer's probabilities of one microbatch {k5_train} and of a serving "
          f"batch (32, 12, {t_serve}, {t_serve}), fp32, p={ATTN_P}", flush=True)
    for shape in (k5_train, (32, cfg.encoder_attention_heads, t_serve, t_serve)):
        check_k5_at(kd, shape, dev)
    errs[kd.KERNEL + "@conformer"] = 0.0
    conf_abs_attn = (exp.train.batch_size, t_student, cfg.encoder_attention_heads,
                     cfg.encoder_embed_dim // cfg.encoder_attention_heads)
    print(f"[kernels] conformer-abs: K2 with dropout p={ATTN_P} and the backward at the abs "
          f"conformer's {conf_abs_attn}, ragged, vs the plain versions", flush=True)
    check_attention_training_kernels(fa, gen, dev, errs, cases=(conf_abs_attn + (False,),),
                                     path="@conformer-abs")
    print(f"[kernels] K2 (p = 0 and {ATTN_P}) and the whole backward past grid y's 65535: "
          f"{BIG_BH[0]} rows of {BIG_BH[1]} heads (B x H = {BIG_BH[0] * BIG_BH[1]}), D = "
          f"{BIG_BH[2]}, T = 1 and 80, ragged, vs the plain versions", flush=True)
    big = check_attention_past_65535(fa, gen, dev)
    print(f"  B x H = {BIG_BH[0] * BIG_BH[1]}: bf16 max_abs_err forward {big['fwd']:.3e}, "
          f"backward {big['bwd']:.3e} ok", flush=True)

    # ---- 4. the slice end to end
    lap("serving")
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
    lap("training: release, library, path B")
    print("[train] Distiller(fithubert_960h_experiment(), HuBERT-Base teacher, seeded "
          "weights), bf16, dropout 0.1, num_training_steps=20, FITHUBERT_CONV_BWD unset: "
          "the conv stack's backward runs K6", flush=True)
    t_state = teacher_cpu.state_dict()
    student_cpu = StudentModel(exp.distiller, device="cpu").init_weights(gen)
    s_state = student_cpu.state_dict()
    rand_layers = torch.randperm(exp.distiller.encoder_layers - 1, generator=gen)
    per_step = release_per_step(exp, geom)
    distiller = Distiller(exp, t_state, s_state, device="cuda", num_training_steps=20)
    a, b = exp.train.accumulate_grad_batches, exp.train.batch_size

    # the counts of the last checked step of each training path
    path_launches = {"train": {}, "train-library": {}, "train-taps": {}}

    def step_checked(d, batch, want, what, path):
        """``launches_of_step`` on the release's random layers, its counts
        kept as ``path``'s."""
        logs, path_launches[path] = launches_of_step(d, batch, rand_layers, want, what)
        return logs

    k5_release = set()  # the (shape, dtype) of each elementwise dropout of the step
    with k5_shapes(kd, k5_release):
        logs = step_checked(distiller, train_batch(gen, a, b, 12.0, ragged=True), per_step,
                            "ragged step", "train")
    if not all(torch.isfinite(p).all().item() for p in distiller.params):
        fail("ragged step: non-finite parameters")
    print(f"  step 0 (ragged 3 x 4, one fabricated row, lr {logs['lr']}): loss "
          f"{logs['loss']:.6f} grad_norm {logs['grad_norm']:.6f} finite ok; launches "
          f"{json.dumps(path_launches['train'])} ok", flush=True)
    if not k5_release:
        fail("the release step launched K5 on no activation")
    print(f"[train] K5 vs seeded_dropout_plain at each shape the release step dropped "
          f"(dropout_input, the encoder's and the FFN's dropouts), p={ATTN_P}: "
          f"{sorted(k5_release, key=str)}", flush=True)
    for shape_, dtype_ in sorted(k5_release, key=str):
        check_seeded_dropout(kd, shape_, gen, dev, dtypes=(dtype_,))
    errs[kd.KERNEL + "@train"] = 0.0  # bit for bit at every shape
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
    per_step_taps = plus_k5({cf.KERNEL: a * per_step[cf.KERNEL],
                             cf.KERNEL_PREFIX: a * per_step[cf.KERNEL_PREFIX],
                             fa.KERNEL: a * (l_t - 1), fa.KERNEL_DROPOUT: a * (l_s - 1),
                             **attn_bwd(a * (l_s - 1)),
                             kd.KERNEL: 2 * a, cf.KERNEL_BWD: a * per_step[cf.KERNEL_BWD]},
                            exp.distiller, a)
    per_step_taps = plus_pos_conv(per_step_taps, exp.distiller, a)
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
    lap("loop")
    print("[loop] run_training on the release config: a fairseq HuBERT-Base .pt teacher, "
          "a WAV corpus, FITHUBERT_CONV_BWD unset", flush=True)
    per_eval = plus_pos_conv({cf.KERNEL_PREFIX: 2, cf.KERNEL: per_step[cf.KERNEL],  # both
                              fa.KERNEL: geom.encoder_layers + exp.distiller.encoder_layers},
                             exp.distiller, 1, backward=False)  # K2 at p = 0
    # the loop's teacher and corpus serve phases 10 and 11 too
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    pt, libri = loop_phase(exp, geom, teacher_cpu, per_step, per_eval, smi, work.name)

    # ---- 8a. the rehearsal: preempted, resumed, exported, probed; read before [timing]
    print(f"[rehearsal] python -m fithubert_tpu_torch.scripts.dress_rehearsal on "
          f"{REHEARSAL_CONFIG} (the release geometry, synthetic corpus) started in the "
          f"background; its results and the probes on its export are read before [tp]",
          flush=True)
    rehearsal = start_rehearsal(work.name)
    lap("ex, ctc, conformer, mel")

    # ---- 8b. configs/ex.yaml end to end, then the CTC path
    t_phase = time.perf_counter()
    print(f"[ex] Distiller(ex_experiment(), HuBERT-Base teacher, seeded weights), bf16, "
          f"dropout 0.1, {b_ex} x {a_ex} folded, FITHUBERT_CONV_BWD unset", flush=True)
    distiller_ex, fixed_ex, path_launches["ex"], expert_ex, ex_student_cpu = ex_phase(
        exp_ex, geom, t_state, gen, smi, work.name, pt, libri)
    print(f"[ex] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print("[ctc] the release student with a seeded wav2vec2-Base-shaped CTC teacher (vocab 32)",
          flush=True)
    ctc_phase(exp, geom, s_state, rand_layers, per_step, gen, smi, work.name, libri)
    print(f"[ctc] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 8c. the conformer family, then the mel front-end with SpecAugment
    t_phase = time.perf_counter()
    print("[conformer] Distiller(conformer_experiment(p)) for p = rel_pos, rope, abs: "
          "HuBERT-Base teacher, seeded weights, bf16, dropout 0.1, 4 microbatches of 3 looped",
          flush=True)
    conformers, expert_conf = conformer_phase(geom, t_state, gen, smi, work.name, pt)
    for path, (_d, _b, launches, _r) in conformers.items():
        path_launches[path] = launches
    print(f"[conformer] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print("[mel] Distiller(mel_experiment()): 80 log-mels, MelSpecHead, SpecAugment, "
          "HuBERT-Base teacher, seeded weights, bf16, dropout 0.1, 3 x 4 folded", flush=True)
    distiller_mel, fixed_mel, path_launches["mel"], rand_mel, expert_mel = mel_phase(
        geom, t_state, gen, smi, work.name)
    print(f"[mel] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 8d. this slice: a wav2vec2-Large teacher, int8, the encoder
    # options, and the conformer over two ranks
    lap("large, int8, options, conformer-dp")
    t_phase = time.perf_counter()
    print("[large] Distiller(the release student, pred_head_final_dim 1024, a seeded "
          "wav2vec2-Large LV-60 teacher from a fairseq .pt), bf16, dropout 0.1, 3 x 4 folded",
          flush=True)
    distiller_large, fixed_large, path_launches["large"], rand_large = large_phase(
        exp, gen, smi, work.name)
    print(f"[large] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print("[int8] int8 matmuls: torch._int_mm against the CPU, the release step with "
          "teacher.quantize_int8, UpstreamExpert(int8=True)", flush=True)
    int8_phase(exp, t_state, s_state, state, cfg, rand_layers, per_step, gen, smi)
    print(f"[int8] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print(f"[options] the release Distiller with the student's {OPTIONS}, HuBERT-Base "
          f"teacher, bf16, dropout 0.1, 3 x 4 folded", flush=True)
    path_launches["options"] = options_phase(exp, geom, t_state, rand_layers, gen, smi)
    print(f"[options] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print(f"[conformer-dp] the rel_pos conformer ({CONFORMER_DP_LAYERS} layers) over "
          f"{DP_WORLD} gloo ranks sharing the card, against one process", flush=True)
    conformer_dp_phase(geom, t_state, lambda e: conformer_per_step(e, geom), gen, smi,
                       work.name)
    print(f"[conformer-dp] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 8e. slice 12: the smoke configs at their head sizes and widths,
    # checkpoint_activations, and
    # train.steps_per_launch as one CUDA graph of K steps
    lap("smoke-configs, remat, chain")
    t_phase = time.perf_counter()
    print("[smoke-configs] configs/smoke.yaml in fp32 and bf16 and configs/smoke_ctc.yaml "
          "through train_torch.py (student heads of 12, teacher heads of 16, widths 32 and "
          "48), then the kernels at those head sizes and widths", flush=True)
    smoke_launches = smoke_configs_phase(gen, smi, work.name, errs)
    path_launches["smoke"] = smoke_launches["smoke bf16"]
    print(f"[smoke-configs] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print("[remat] checkpoint_activations on against off: the release step and the rel_pos "
          "conformer step, bf16, dropout 0.1", flush=True)
    remat_phase(exp, geom, t_state, s_state, rand_layers, gen, smi)
    print(f"[remat] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    print(f"[chain] train.steps_per_launch {CHAIN_K}: one CUDA graph of {CHAIN_K} steps "
          f"against {CHAIN_K} eager steps, for the release step, path B and the rel_pos "
          f"conformer; then run_training", flush=True)
    exp_c = conformer_experiment("rel_pos")
    c_state = StudentModel(exp_c.distiller, device="cpu").init_weights(gen).state_dict()
    chain_phase({"release": (exp, s_state, rand_layers, per_step),
                 "path B": (exp_taps, s_state, rand_layers, per_step_taps),
                 "rel_pos conformer": (exp_c, c_state,
                                       torch.randperm(exp_c.distiller.encoder_layers - 1,
                                                      generator=gen),
                                       conformer_per_step(exp_c, geom))},
                t_state, gen, smi, work.name)
    del c_state
    print(f"[chain] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 8f. slice 13: tensor parallelism, the 'model' axis
    # ---- 8f. the rehearsal's results, before [tp] and [timing] time their steps
    lap("rehearsal (its wait)")
    print("[rehearsal] the dress rehearsal's chain and launches, then the probes on its export",
          flush=True)
    rehearsal_phase(rehearsal, smi)

    lap("tensor parallelism")
    t_phase = time.perf_counter()
    print(f"[tp] the release config over a ('data', 'model') mesh of gloo ranks sharing the "
          f"card, model axis {TP_MODEL}: student {cfg.encoder_embed_dim} / "
          f"{cfg.encoder_attention_heads} heads / ffn {cfg.encoder_ffn_embed_dim}, HuBERT-Base "
          f"teacher {geom.encoder_embed_dim} / {geom.encoder_attention_heads} / "
          f"{geom.encoder_ffn_embed_dim}; {a} x {b} x 12 s bf16", flush=True)
    path_launches["tp"] = tp_phase(exp, exp32, geom, t_state, s_state, rand_layers, gen,
                                   per_step, work.name, smi, errs)
    print(f"[tp] phase done in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- 9. timing
    lap("timing")
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

    # the host's share of a K2 call (eager steps are host-bound)
    hq = [torch.randn(32, cf.out_len(16 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor,
                      cfg.encoder_attention_heads,
                      cfg.encoder_embed_dim // cfg.encoder_attention_heads,
                      generator=gen).to(dev, torch.bfloat16) for _ in range(3)]
    with torch.no_grad():
        fa.flash_attention(*hq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fa.flash_attention(*hq)
        call_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print(f"  K2 at serving's {tuple(hq[0].shape)}: a whole call {call_us:.1f} us on the host",
          flush=True)
    del hq

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

    print(f"[timing] ex train step, {b_ex} x {a_ex} x 12 s ({a_ex * b_ex * 12} s of audio), "
          f"bf16; {smi}", flush=True)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        distiller_ex.train_step(fixed_ex, None)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex_step_ms = statistics.median(times)
    print(f"  ex train step: median {ex_step_ms:.3f} ms over 10 (min {min(times):.3f}, max "
          f"{max(times):.3f}), {1e3 / ex_step_ms:.3f} steps/s, "
          f"{a_ex * b_ex * 12.0 / (ex_step_ms / 1e3):.1f} audio-s/s", flush=True)
    profile_device(lambda: distiller_ex.train_step(fixed_ex, None), "ex train step", top=20,
                   unprofiled_ms=ex_step_ms)
    print(f"[timing] ex serving forward, B=32 x 16 s, bf16; {smi}", flush=True)
    for _ in range(3):
        expert_ex(bench)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        expert_ex(bench)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex_fwd_ms = statistics.median(times)
    print(f"  ex forward: median {ex_fwd_ms:.3f} ms over 10 (min {min(times):.3f}, max "
          f"{max(times):.3f}), {32 * 16 / (ex_fwd_ms / 1e3):.1f} audio-s/s", flush=True)
    _build.reset_launches()
    expert_ex(bench)
    torch.cuda.synchronize()
    path_launches["ex-serving"] = dict(_build.LAUNCHES)
    profile_device(lambda: expert_ex(bench), "ex forward", unprofiled_ms=ex_fwd_ms)
    del expert_ex

    for path, what in (("conformer", "rel_pos conformer"), ("conformer-abs", "abs conformer"),
                       ("mel", "mel + SpecAugment")):
        d, batch, _launches, rand = conformers[path] if path in conformers else \
            (distiller_mel, fixed_mel, None, rand_mel)
        print(f"[timing] {what} train step, {b} x {a} x 12 s, bf16; {smi}", flush=True)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            d.train_step(batch, rand)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        print(f"  {what} train step: median {med:.3f} ms over 5 (min {min(times):.3f}, max "
              f"{max(times):.3f}), {1e3 / med:.3f} steps/s, {audio_s / (med / 1e3):.1f} "
              f"audio-s/s; the release step {step_ms:.3f} ms", flush=True)
        profile_device(lambda: d.train_step(batch, rand), f"{what} train step", top=12,
                       unprofiled_ms=med)
    conformers.clear()  # frees the conformers' Distillers
    print(f"[timing] large train step (the wav2vec2-Large teacher), 3 x 4 x 12 s, bf16; "
          f"{smi}", flush=True)
    med, lo, hi = timed(lambda: distiller_large.train_step(fixed_large, rand_large), 5)
    print(f"  large train step: median {med:.3f} ms over 5 (min {lo:.3f}, max {hi:.3f}), "
          f"{1e3 / med:.3f} steps/s, {audio_s / (med / 1e3):.1f} audio-s/s; the release step "
          f"{step_ms:.3f} ms", flush=True)
    profile_device(lambda: distiller_large.train_step(fixed_large, rand_large),
                   "large train step", top=14, unprofiled_ms=med)
    del distiller_large
    torch.cuda.empty_cache()
    print(f"[timing] rel_pos conformer serving forward, B=32 x 16 s, bf16; {smi}", flush=True)
    for _ in range(2):
        expert_conf(bench)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        expert_conf(bench)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    conf_fwd_ms = statistics.median(times)
    print(f"  rel_pos conformer forward: median {conf_fwd_ms:.3f} ms over 5 (min "
          f"{min(times):.3f}, max {max(times):.3f}), {32 * 16 / (conf_fwd_ms / 1e3):.1f} "
          f"audio-s/s", flush=True)
    profile_device(lambda: expert_conf(bench), "rel_pos conformer forward", top=10,
                   unprofiled_ms=conf_fwd_ms)
    del expert_conf, expert_mel
    torch.cuda.empty_cache()

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
            peak=BF16_PEAK, launches=None):
        b_ms, b_by = bound(*work, peak)
        launches = launches_of[path].get(name, 0) if launches is None else launches
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
    del q, k, v, mask
    # large: K2 at p = 0, the wav2vec2-Large teacher's attention, (12, 599, 16, 64)
    q, k, v, mask = attention_qkv(*large_attn)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "large",
        f"wav2vec2-Large teacher {tuple(q.shape)}", errs["attn_large"], a_ms, a_plain, a_work,
        a_lib)
    del q, k, v, mask

    def sdpa_bwd_ms(q, k, v, dout, mask, p, reps=50):
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = sdpa(qs, ks, vs, mask, p)
        return cuda_ms(lambda: torch.autograd.grad(o_lib, (qs, ks, vs), dout.transpose(1, 2),
                                                   retain_graph=True), reps=reps)

    def bwd_rows(q, k, v, dout, mask, p, seed, path, shape, lib_bwd, reps=50):
        """Rows of the backward's launches at the compiled head size the
        wrapper pads to (the pre-pass at q's own D), and of the whole
        backward beside SDPA's backward ``lib_bwd``. Returns the whole
        backward's ms."""
        sfx = "" if path == "train" else f"@{path}"
        if path == "smoke":
            sfx = f"@D={q.shape[-1]}"
        d_ = q.shape[-1]
        dp = fa.padded_head_dim(d_)
        qp, kp, vp = (fa.pad_heads(x, dp) for x in (q, k, v))
        dop = F.pad(dout, (0, dp - d_)).contiguous()
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, dropout_p=p, seed=seed,
                                          return_lse=True)
            delta = fa.bwd_prep_cuda(out, dout)
            parts = fa.bwd_fused_cuda(qp, kp, vp, mask, lse, dop, delta, p, seed)[0]
            prep = (cuda_ms(lambda: fa.bwd_prep_cuda(out, dout), reps=reps),
                    cuda_ms(lambda: fa.bwd_prep_plain(out, dout), reps=10), attn_prep_work(q),
                    None)
            fused = cuda_ms(lambda: fa.bwd_fused_cuda(qp, kp, vp, mask, lse, dop, delta, p,
                                                      seed), reps=reps)
            fused_plain = cuda_ms(lambda: fa.attention_bwd_tiles_plain(
                qp, kp, vp, mask, lse, dop, delta, p, seed), reps=3)
            # the library's call for the same sum: one reduction over the
            # key tiles, then the cast
            dq_sum = (cuda_ms(lambda: fa.dq_sum_cuda(parts), reps=reps),
                      cuda_ms(lambda: fa.dq_sum_plain(parts, torch.bfloat16), reps=10),
                      attn_dq_sum_work(qp, fa.BWD_KEY_TILE),
                      cuda_ms(lambda: parts.sum(0).to(torch.bfloat16), reps=reps))
            whole = cuda_ms(lambda: fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, p, seed),
                            reps=reps)
            whole_plain = cuda_ms(lambda: fa.attention_bwd_plain(q, k, v, mask, out, lse, dout,
                                                                 p, seed), reps=5)
        src, of = "flash_attention_bwd.cu", "flash_attention.py"
        row(fa.KERNEL_BWD_PREP, src, f"{of}:302 (delta, which the TPU sums outside its "
            f"kernels)", path, shape, errs[fa.KERNEL_BWD_PREP + sfx], *prep)
        row(fa.KERNEL_BWD, src, f"{of}:304 (K3) and :323 (K4)", path, shape,
            errs[fa.KERNEL_BWD + sfx], fused, fused_plain,
            attn_fused_work(qp, mask, fa.BWD_KEY_TILE), lib_bwd)
        row(fa.KERNEL_DQ_SUM, src, f"{of}:304 (K3's dQ, summed over the key tiles)", path,
            shape, errs[fa.KERNEL_DQ_SUM + sfx], *dq_sum)
        row("attention backward (prep + fused + dQ sum)", src, f"{of}:295-357 (_flash_core_bwd)",
            path, shape, errs["attn_bwd" + sfx], whole, whole_plain,
            attn_bwd_whole_work(q, mask), lib_bwd,
            launches=launches_of[path].get(fa.KERNEL_BWD, 0))
        print(f"  attention backward at {shape}: prep {prep[0]:.4f} + fused {fused:.4f} + dQ "
              f"sum {dq_sum[0]:.4f} ms; whole {whole:.4f} ms (bound "
              f"{bound(*attn_bwd_whole_work(q, mask), BF16_PEAK)[0]:.4f}) against SDPA's "
              f"backward {lib_bwd:.4f} ms: {whole / lib_bwd:.2f}x", flush=True)
        return whole

    def attention_train_rows(shape4, path, who):
        """K2 at p = 0.1 and the backward's rows at ``shape4``; returns (K2
        ms, SDPA's forward ms, the whole backward's ms, SDPA's backward ms,
        the shape's label)."""
        q, k, v, dout, mask = attention_qkv(*shape4, n=4)
        seed = seed_words(gen, dev)
        shape = f"{who} {tuple(q.shape)}, p={ATTN_P}"
        f_ms, f_plain, f_work, f_lib = attention_fwd_times(q, k, v, mask, ATTN_P, seed)
        row(fa.KERNEL_DROPOUT, "flash_attention.cu", "flash_attention.py:243 (dropout branch "
            ":100-106)", path, shape, errs[fa.KERNEL_DROPOUT + suffix[path]], f_ms, f_plain,
            f_work, f_lib)
        lib_bwd = sdpa_bwd_ms(q, k, v, dout, mask, ATTN_P)
        whole = bwd_rows(q, k, v, dout, mask, ATTN_P, seed, path, shape, lib_bwd)
        return f_ms, f_lib, whole, lib_bwd, shape

    suffix = {"train": "", "ex": "@ex", "conformer-abs": "@conformer-abs", "tp": "@tp"}
    # train: the student's attention, (12, 299, 12, 40), p = 0.1: K2 and the backward
    t_att = cf.out_len(12 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    f_ms, f_lib, whole, lib_bwd, shape = attention_train_rows(
        (a * b, t_att, h, d), "train", "student")
    goals.append((f"attention backward {shape}, against SDPA's whole backward", whole, lib_bwd,
                  1.0, None))
    # ex: the ex student's attention, (8, 600, 12, 64), p = 0.1; conformer-abs:
    # the abs conformer's fairseq MHA, one microbatch (3, 299, 12, 40); tp: each
    # model rank's heads of the release step, the student's (12, 299, 6, 40) at
    # p = 0.1 (and the teacher's (12, 599, 6, 64) at p = 0 below)
    for shape4, path, who in ((ex_attn, "ex", "ex student"),
                              (conf_abs_attn, "conformer-abs", "abs conformer"),
                              ((a * b, t_att, h // TP_MODEL, d), "tp",
                               "student, per model rank")):
        _f, _fl, whole, lib_bwd, shape = attention_train_rows(shape4, path, who)
        goals.append((f"attention backward {shape}, against SDPA's whole backward", whole,
                      lib_bwd, 1.0, None))
    tp_teacher = teacher_attn[:2] + (teacher_attn[2] // TP_MODEL, teacher_attn[3])
    q, k, v, mask = attention_qkv(*tp_teacher)
    a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
    row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "tp",
        f"teacher, per model rank {tuple(q.shape)}", errs["attn_tp"], a_ms, a_plain, a_work,
        a_lib)
    del q, k, v, mask

    # train-taps: K5 at the student's last-layer probabilities of one microbatch
    x = torch.rand((b, h, t_att, t_att), generator=gen).to(dev)
    seed = seed_words(gen, dev)
    with torch.no_grad():
        k5_ms = cuda_ms(lambda: kd.seeded_dropout_cuda(x, seed, ATTN_P), reps=50)
        k5_plain = cuda_ms(lambda: kd.seeded_dropout_plain(x, seed, ATTN_P), reps=5)
        k5_lib = cuda_ms(lambda: F.dropout(x, ATTN_P, training=True), reps=50)
    # one multiply per element; 4 bytes read and 4 written
    row(kd.KERNEL, "seeded_dropout.cu", "dropout.py:83", "train-taps",
        f"student probabilities {tuple(x.shape)} fp32, p={ATTN_P}", errs[kd.KERNEL], k5_ms,
        k5_plain, (x.numel(), 8 * x.numel()), k5_lib, peak=FP32_PEAK)
    del x
    # train: K5 at the largest of the release step's elementwise dropouts
    shape_, dtype_ = max(k5_release, key=lambda sd: math.prod(sd[0]))
    x = torch.randn(shape_, generator=gen).to(dev, dtype_)
    with torch.no_grad():
        k5_ms = cuda_ms(lambda: kd.seeded_dropout_cuda(x, seed, ATTN_P), reps=50)
        k5_plain = cuda_ms(lambda: kd.seeded_dropout_plain(x, seed, ATTN_P), reps=5)
        k5_lib = cuda_ms(lambda: F.dropout(x, ATTN_P, training=True), reps=50)
    row(kd.KERNEL, "seeded_dropout.cu", "dropout.py:83", "train",
        f"student activations {tuple(x.shape)} {str(dtype_).removeprefix('torch.')}, "
        f"p={ATTN_P}, the largest of the step's elementwise dropouts, each forward and "
        f"backward", errs[kd.KERNEL + "@train"], k5_ms, k5_plain,
        (x.numel(), 2 * x.element_size() * x.numel()), k5_lib, peak=FP32_PEAK)
    del x
    # conformer: K5 at the rel_pos conformer's probabilities of one microbatch
    x = torch.rand(k5_train, generator=gen).to(dev)
    with torch.no_grad():
        k5_ms = cuda_ms(lambda: kd.seeded_dropout_cuda(x, seed, ATTN_P), reps=30)
        k5_plain = cuda_ms(lambda: kd.seeded_dropout_plain(x, seed, ATTN_P), reps=3)
        k5_lib = cuda_ms(lambda: F.dropout(x, ATTN_P, training=True), reps=30)
    row(kd.KERNEL, "seeded_dropout.cu", "dropout.py:83", "conformer",
        f"rel_pos probabilities {tuple(x.shape)} fp32, p={ATTN_P}, every layer forward and "
        f"backward", errs[kd.KERNEL + "@conformer"], k5_ms, k5_plain,
        (x.numel(), 8 * x.numel()), k5_lib, peak=FP32_PEAK)
    del x

    # smoke: configs/smoke.yaml's bf16 run, 2 x 2 rows of 1 s folded into 4:
    # the student's attention at heads of 12 (padded to 16), the teacher's
    # at heads of 16, and the student's stack (widths 32, 48, padded to 64)
    exp_s = load_experiment_yaml("configs/smoke.yaml")
    smoke_student = StudentModel(exp_s.distiller, device="cpu").init_weights(gen)
    s_cfg = exp_s.distiller
    smoke_rows = exp_s.train.batch_size * exp_s.train.accumulate_grad_batches
    smoke_wav = exp_s.data.synthetic_wav_length
    t_s = cf.out_len(smoke_wav, s_cfg.conv_feature_layers) // s_cfg.tr_reduce_factor
    t_t = cf.out_len(smoke_wav, TeacherGeometry.from_teacher_config(
        exp_s.teacher).conv_feature_layers)
    for who, shape4 in (("student", (smoke_rows, t_s, s_cfg.encoder_attention_heads,
                                     s_cfg.encoder_embed_dim // s_cfg.encoder_attention_heads)),
                        ("teacher", (smoke_rows, t_t, exp_s.teacher.encoder_attention_heads,
                                     exp_s.teacher.encoder_embed_dim
                                     // exp_s.teacher.encoder_attention_heads))):
        q, k, v, dout, mask = attention_qkv(*shape4, n=4)
        a_ms, a_plain, a_work, a_lib = attention_fwd_times(q, k, v, mask)
        row(fa.KERNEL, "flash_attention.cu", "flash_attention.py:243", "smoke",
            f"{who} {tuple(q.shape)}", errs[fa.KERNEL_DROPOUT + f"@D={shape4[3]}"], a_ms,
            a_plain, a_work, a_lib)
        if who == "student":
            bwd_rows(q, k, v, dout, mask, 0.0, None, "smoke", f"student {tuple(q.shape)}, p=0",
                     sdpa_bwd_ms(q, k, v, dout, mask, 0.0))
        del q, k, v, dout, mask
    smoke_wavs = [torch.randn(smoke_wav, generator=gen) * 0.1 for _ in range(smoke_rows)]
    sm = conv_times(smoke_student, smoke_wavs, dev, "smoke student")
    shape = f"smoke student {stack_shape(smoke_student, smoke_wavs)}"
    row(cf.KERNEL_PREFIX, prefix_src, prefix_of, "smoke", shape, errs["prefix@smoke"],
        *sm["prefix"], peak=FP32_PEAK)
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "smoke",
        f"{shape}, from a0, widths padded to 64", errs["conv@smoke"], *sm["k1"])
    spec_s = smoke_student.feature_extractor.spec[1:]
    x, ws, scale, shift = stack_inputs(smoke_student, smoke_wavs, torch.bfloat16, dev)
    with torch.no_grad():
        a0 = cf._prefix(x, scale, shift)
    g = torch.randn((a0.shape[0], cf.out_len(a0.shape[1], spec_s), spec_s[-1][0]),
                    generator=gen).to(dev, torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in [a0, *ws]]
    row(cf.KERNEL_BWD, "conv_frontend_bwd.cu", "conv_frontend_bwd.py:290", "smoke",
        f"smoke student a0 {tuple(a0.shape)}, g {tuple(g.shape)}, widths padded to 64",
        errs[cf.KERNEL_BWD + "@smoke"],
        cuda_ms(lambda: cf.conv_stack_bwd_cuda(a0, ws, g, spec_s), reps=10),
        cuda_ms(lambda: cf.conv_stack_bwd_plain(a0, ws, g, spec_s), reps=3),
        conv_bwd_work(a0, spec_s),
        cuda_ms(lambda: torch.autograd.grad(cf.conv_stack_plain(leaves[0], leaves[1:], spec_s),
                                            leaves, g), reps=10))
    del x, ws, scale, shift, a0, g, leaves
    # head sizes on no path of the repo's configs, at the release teacher's
    # frames: printed, not rows (no run launches them)
    for d_ in (80, 128):
        shape4 = (12, teacher_attn[1], 12, d_)
        q, k, v, dout, mask = attention_qkv(*shape4, n=4)
        seed = seed_words(gen, dev)
        f_ms, _f_plain, f_work, f_lib = attention_fwd_times(q, k, v, mask, ATTN_P, seed)
        lib_bwd = sdpa_bwd_ms(q, k, v, dout, mask, ATTN_P, reps=30)
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, mask, dropout_p=ATTN_P, seed=seed,
                                          return_lse=True)
            delta = fa.bwd_prep_cuda(out, dout)
            fused = cuda_ms(lambda: fa.bwd_fused_cuda(q, k, v, mask, lse, dout, delta, ATTN_P,
                                                      seed), reps=30)
            whole = cuda_ms(lambda: fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, ATTN_P,
                                                       seed), reps=30)
        print(f"  D = {d_} ({tuple(q.shape)} bf16, p={ATTN_P}, no config's path): K2 "
              f"{f_ms:.4f} ms (bound {bound(*f_work, BF16_PEAK)[0]:.4f}, SDPA {f_lib:.4f}); "
              f"the fused backward pass {fused:.4f} ms (bound "
              f"{bound(*attn_fused_work(q, mask, fa.BWD_KEY_TILE), BF16_PEAK)[0]:.4f}), the "
              f"whole "
              f"backward {whole:.4f} ms (bound "
              f"{bound(*attn_bwd_whole_work(q, mask), BF16_PEAK)[0]:.4f}), SDPA backward "
              f"{lib_bwd:.4f} ms", flush=True)
        del q, k, v, dout, mask

    def k6_row(model, wavs, path, err):
        """K6's row over ``model``'s stack of one step, from a0 = the prefix's
        output, and its launch-by-launch breakdown; returns (ms, the launches'
        summed time, their summed floors, the shape's label)."""
        spec = model.feature_extractor.spec[1:]
        x, ws, scale, shift = stack_inputs(model, wavs, torch.bfloat16, dev)
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
        label = f"{'student' if path == 'train' else 'ex student'} a0 {tuple(a0.shape)}, " \
            f"g {tuple(g.shape)}"
        row(cf.KERNEL_BWD, "conv_frontend_bwd.cu", "conv_frontend_bwd.py:290", path, label,
            err, k6_ms, k6_plain, conv_bwd_work(a0, spec), k6_lib)
        del leaves
        launches_ms, floor = k6_breakdown(cf, a0, ws, g, spec)
        return k6_ms, launches_ms, floor, label

    k6_ms, k6_launches_ms, k6_floor, k6_shape = k6_row(student_cpu, step_wavs, "train",
                                                       errs[cf.KERNEL_BWD])
    ex_step_wavs = list(fixed_ex["x"].reshape(-1, fixed_ex["x"].shape[-1]))
    k6_row(ex_student_cpu, ex_step_wavs, "ex", errs[cf.KERNEL_BWD + "@ex"])

    def pos_conv_row(path, label, b, t, c, grad=False, groups=16, k=128):
        """The positional conv kernel at (b, t, c): the forward with its bias,
        or (``grad``) the input gradient over flipped weights; held to the
        plain version at TOL in bf16 and in fp32, timed against it and, as
        ``library_ms``, against the cuDNN conv the port called before (the
        forward on the (B, C, T) view, padding k // 2; the input gradient as
        that forward conv of flipped kernels on the cotangent with SamePad's
        zero frame, padding k - 1 - k // 2). Its launches are those the
        path's run counted."""
        import torch.nn.functional as F

        from fithubert_tpu_torch.ops.kernels import pos_conv as kp

        cg = c // groups
        x = torch.randn(b, t, c, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(c, cg, k, generator=gen) * (cg * k) ** -0.5).to(dev, torch.bfloat16)
        bias, pad = torch.randn(c, generator=gen).to(dev, torch.bfloat16), k // 2
        xt = x.transpose(1, 2)
        if grad:
            w, bias, pad = kp.flipped(w, groups), None, k - 1 - k // 2
            xt = F.pad(xt, (0, 1))
        what = f"{kp.KERNEL} vs pos_conv_plain, {label}"
        args32 = [x.float(), w.float(), None if bias is None else bias.float()]
        compare(f"{what}, fp32", kp.pos_conv_cuda(*args32, pad),
                kp.pos_conv_plain(*args32, pad), "float32")
        del args32
        err = compare(f"{what}, bf16", kp.pos_conv_cuda(x, w, bias, pad),
                      kp.pos_conv_plain(x, w, bias, pad), "bfloat16")
        ms = cuda_ms(lambda: kp.pos_conv_cuda(x, w, bias, pad), reps=20)
        plain = cuda_ms(lambda: kp.pos_conv_plain(x, w, bias, pad), reps=3, warmup=1)
        lib = cuda_ms(lambda: F.conv1d(xt, w, bias, padding=pad, groups=groups), reps=5,
                      warmup=2)
        work = (2 * b * t * c * cg * k, 2 * (2 * b * t * c + c * cg * k))
        row(kp.KERNEL, "pos_conv.cu", "", path, label, err, ms, plain, work, lib)
        kernels[-1]["replaces"] = ("none: jax.lax.conv_general_dilated "
                                   "(fithubert_tpu/ops/conv.py:338-373)")

    # the positional conv at every cell's shapes (distilhubert serving and
    # step, the release step's teacher and student), input gradients at the
    # train shapes
    pos_conv_row("ex-serving", "distilhubert serving (32, 849, 768)", 32, 849, 768)
    pos_conv_row("train", "release teacher (12, 599, 768)", 12, 599, 768)
    pos_conv_row("train", "release student (12, 599, 480)", 12, 599, 480)
    pos_conv_row("train", "release student (12, 599, 480), input gradient", 12, 599, 480,
                 grad=True)
    pos_conv_row("ex", "ex teacher and student (8, 599, 768)", 8, 599, 768)
    pos_conv_row("ex", "ex student (8, 599, 768), input gradient", 8, 599, 768, grad=True)

    # ex: the prefix and K1 over the ex student's and the teacher's stacks of one step
    ex_stu, ex_tea = (conv_times(m, ex_step_wavs, dev, f"{who}, ex train")
                      for m, who in ((ex_student_cpu, "ex student"), (teacher_cpu, "teacher")))
    shape = f"ex student {stack_shape(ex_student_cpu, ex_step_wavs)} + teacher " \
        f"{stack_shape(teacher_cpu, ex_step_wavs)}"

    def both_ex(key):
        sk, tk = ex_stu[key], ex_tea[key]
        return (sk[0] + tk[0], sk[1] + tk[1], (sk[2][0] + tk[2][0], sk[2][1] + tk[2][1]),
                None if sk[3] is None else sk[3] + tk[3])

    row(cf.KERNEL_PREFIX, prefix_src, prefix_of, "ex", shape,
        max(errs["prefix_ex"], errs["prefix_teacher"]), *both_ex("prefix"), peak=FP32_PEAK)
    row(cf.KERNEL, "conv_frontend.cu", "conv_frontend.py:283", "ex", f"{shape}, from a0",
        max(errs["conv_ex"], errs["conv_teacher"]), *both_ex("k1"))

    def met(ok):
        return "met" if ok else "missed"

    k1_floor = {"serving": serve["floor_ms"], "train": stu["floor_ms"] + tea["floor_ms"],
                "ex": ex_stu["floor_ms"] + ex_tea["floor_ms"], "smoke": sm["floor_ms"]}
    for kr in kernels:
        lib = "none" if kr["library_ms"] is None else f"{kr['library_ms']:.4f}"
        floor = f", per-layer floor {k1_floor[kr['path']]:.4f} ms" \
            if kr["name"] == cf.KERNEL else ""
        print(f"  {kr['name']} ({kr['path']}, {kr['shape']}): {kr['ms']:.4f} ms (bound "
              f"{kr['bound_ms']:.4f} ms by {kr['bound_by']}{floor}, plain "
              f"{kr['plain_ms']:.4f}, library {lib}), {kr['launches']} launches "
              f"{LAUNCHES_OVER.get(kr['path'], 'per train step')}",
              flush=True)

    # K2: every row a config's run launches, at or below SDPA's forward
    for kr in kernels:
        if kr["name"] not in (fa.KERNEL, fa.KERNEL_DROPOUT) or not kr["launches"]:
            continue
        b_, t_, h_ = (int(x) for x in re.search(r"\((\d+), (\d+), (\d+), \d+\)",
                                                kr["shape"]).groups())
        print(f"  goal K2 {kr['path']} {kr['shape']}: {kr['ms']:.4f} ms = "
              f"{kr['ms'] / kr['library_ms']:.2f}x SDPA's forward {kr['library_ms']:.4f} ms; "
              f"goal <= 1.0x {met(kr['ms'] <= kr['library_ms'])}; "
              f"{100 * kr['bound_ms'] / kr['ms']:.1f}% of its bound {kr['bound_ms']:.4f} ms "
              f"({kr['bound_by']}), the exp2 floor {attn_exp2_floor(b_, t_, h_):.4f} ms",
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

    # ---- 10. data parallelism
    lap("data parallelism")
    print("[dp] NCCL, one rank: two release steps through the data-parallel path against the "
          "plain Distiller on the same batches", flush=True)
    dp_nccl_phase(exp, t_state, s_state, [ragged, fixed], rand_layers, per_step, gen, smi)
    print(f"[dp] gloo, {DP_WORLD} ranks sharing the card, full width: fp32 without dropout "
          f"against one process, then the bf16 release step with dropout", flush=True)
    dp_gloo_phase(exp, exp32, t_state, s_state, rand_layers, gen, per_step, work.name, smi)
    print(f"[dp] the loop over {DP_WORLD} gloo ranks: one epoch on the loop phase's WAVs",
          flush=True)
    dp_loop_phase(exp, work.name, pt, libri, per_step, smi)

    # ---- 11. the rest of export
    lap("export")
    print("[export] the reference's Lightning .ckpt through torch.hub and extract_features",
          flush=True)
    export_phase(exp, s_state, t_state, libri, work.name, smi)
    work.cleanup()

    # ---- 12. result lines
    lap("result lines")
    if DEFERRED:
        print(json.dumps({"kernels": kernels}), flush=True)
        fail(f"every phase ran ({time.perf_counter() - t_start:.1f} s), but: "
             + "; ".join(DEFERRED))
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
