#!/usr/bin/env python3
"""Build and drive the PyTorch port (fithubert_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own line(s) and any failed check ending the
run with a non-zero exit and no final line:

  1. device: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel of csrc/, one nvcc each, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes, bf16 and fp32 (TF32 off), ragged inputs;
  4. end to end: UpstreamExpert at FitHuBERT-960h width (seeded weights)
     serves three ragged requests in bf16, through both kernels (launch
     counters are zeroed just before and read just after); then the same
     weights in fp32 on the card against the CPU's plain versions;
  5. timing at the bench.py serving shape, B = 32 x 16 s, bf16;
  6. a JSON line of the kernels, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
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
# Each conv layer is also checked alone (given the plain version's input)
# with the elementwise tolerance above: the two sides then differ only
# where their fp32 sums straddle a bf16 rounding boundary, by one step.
# Through the whole bf16 stack, where each side rounds its own layer
# outputs, those one-step flips compound (3.8e-3 relative at the student's
# 8 layers on an H100), so the whole stack is checked norm-wise:
#   ||kernel - plain|| / ||plain|| <= STACK_FRO and
#   max |kernel - plain| <= STACK_PEAK * max |plain|  (4 bf16 steps).
STACK_FRO, STACK_PEAK = 1e-2, 2 ** -6
# fp32 card vs fp32 CPU through the whole model (21 layers of matmuls and
# norms, two BLAS libraries): summation order only.
E2E_ATOL = E2E_RTOL = 2e-3
# bf16 card vs fp32 card, norm-wise per output: bf16 keeps 8 bits, so the
# outputs differ by a few percent at most; a broken op differs by ~100%.
BF16_VS_FP32_FRO = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
        else f"nvidia-smi failed: {r.stderr.strip()}"


def compare(name, got, want, dtype_name, rows=None, normwise=False):
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
        atol, rtol = TOL[dtype_name]
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


def bound(flops, bytes_, peak):
    t_ops, t_bytes = flops / peak * 1e3, bytes_ / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_forward(expert, wavs, n=3, top=14):
    """Device time by kernel over n forwards (torch.profiler), the device's
    busy share of the wall time, and peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            expert(wavs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(t for _k, t in rows)
    if not rows:
        print("  profile: the profiler saw no device time (not measured)", flush=True)
        return
    print(f"  profile: wall {wall:.3f} ms per forward, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for key, t in rows[:top]:
        print(f"    {t:8.3f} ms {100 * t / busy:5.1f}%  {key[:90]}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    try:
        from fithubert_tpu_torch.config import fithubert_960h
        from fithubert_tpu_torch.export.expert import UpstreamExpert
        from fithubert_tpu_torch.models.student import StudentModel
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
    gen = torch.Generator().manual_seed(0)
    cpu_model = StudentModel(dataclasses.replace(cfg, compute_dtype="float32"),
                             device="cpu").init_weights(gen)
    state = cpu_model.state_dict()
    spec = cfg.conv_feature_layers[1:]
    errs = {}

    # ---- 3. kernels against their plain versions
    print("[kernels] conv_stack_cuda vs conv_stack_plain, B=4 x (ragged, up to 16 s)",
          flush=True)
    wavs = ragged_wavs(gen, 3, 2.0, 15.0) + [torch.randn(16 * SR, generator=gen) * 0.1]
    fe = cpu_model.feature_extractor
    gn = fe.conv_layers[0][2]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = block0_features(cpu_model, wavs, dtype, dev)
        ws = [blk[0].weight.to(dev, dtype).permute(2, 1, 0) for blk in fe.conv_layers[1:]]
        scale, shift = cf.gn_scale_shift(x, gn.weight.to(dev), gn.bias.to(dev))
        for prefix in (True, False):
            ss = (scale, shift) if prefix else (None, None)
            got = cf.conv_stack(x, ws, spec, *ss)
            want = cf.conv_stack_plain(x, ws, spec, *ss)
            torch.cuda.synchronize()
            tag = f"{dtype_name} {'GN prefix' if prefix else 'no prefix'} {tuple(x.shape)}"
            e = compare(f"conv_stack {tag}", got, want, dtype_name,
                        normwise=dtype_name == "bfloat16")
            if dtype_name == "bfloat16":
                errs["conv"] = max(errs.get("conv", 0.0), e)
        h = x
        for i, (w, layer) in enumerate(zip(ws, spec)):
            ss = (scale, shift) if i == 0 else (None, None)
            got = cf.conv_stack(h, [w], (layer,), *ss)
            h = cf.conv_stack_plain(h, [w], (layer,), *ss)
            compare(f"conv_stack {dtype_name} layer {i} {layer}", got, h, dtype_name)

    print("[kernels] flash_attention_fwd_cuda vs attention_plain, ragged masks", flush=True)
    for (b, t, h, d) in ((8, 399, 12, 40), (4, 799, 12, 64), (2, 130, 2, 40)):
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
            if dtype_name == "bfloat16" and b != 2:
                errs["attn"] = max(errs.get("attn", 0.0), e)

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
    print(f"  launches on the main path: {json.dumps(main_path_launches)}", flush=True)

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

    # ---- 5. timing at the serving shape
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

    profile_forward(expert, bench)

    kernels = []
    x = block0_features(cpu_model, bench, torch.bfloat16, dev)
    ws = [blk[0].weight.to(dev, torch.bfloat16).permute(2, 1, 0) for blk in fe.conv_layers[1:]]
    scale, shift = cf.gn_scale_shift(x, gn.weight.to(dev), gn.bias.to(dev))
    wl = [w.permute(2, 1, 0).contiguous() for w in ws]  # torch (C_out, C_in, k) layout

    def conv_library():
        h = F.gelu(x * scale[:, None] + shift[:, None], approximate="tanh").transpose(1, 2)
        for w, (_d, _k, s) in zip(wl, spec):
            h = F.gelu(F.conv1d(h, w, stride=s), approximate="tanh")
        return h

    c_ms = cuda_ms(lambda: cf.conv_stack(x, ws, spec, scale, shift), reps=10)
    c_plain = cuda_ms(lambda: cf.conv_stack_plain(x, ws, spec, scale, shift), reps=10)
    c_lib = cuda_ms(conv_library, reps=10)
    c_bound, c_by = bound(*conv_work(x, spec), BF16_PEAK)
    kernels.append(dict(
        name=cf.KERNEL, route="cuda", source="fithubert_tpu_torch/csrc/conv_frontend.cu",
        replaces="fithubert_tpu/ops/pallas/conv_frontend.py:283",
        launches=main_path_launches.get(cf.KERNEL, 0), max_abs_err=errs["conv"],
        ms=c_ms, plain_ms=c_plain, bound_ms=c_bound, bound_by=c_by, library_ms=c_lib))
    del x, scale, shift

    t_att = cf.out_len(16 * SR, cfg.conv_feature_layers) // cfg.tr_reduce_factor
    h, d = cfg.encoder_attention_heads, cfg.encoder_embed_dim // cfg.encoder_attention_heads
    q, k, v = (torch.randn(32, t_att, h, d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    q = q * d ** -0.5
    mask = torch.zeros(32, t_att, dtype=torch.bool, device=dev)
    sdpa_mask = ~mask[:, None, None, :]
    a_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask), reps=50)
    a_plain = cuda_ms(lambda: fa.attention_plain(q, k, v, mask), reps=20)
    a_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=sdpa_mask,
        scale=1.0), reps=50)
    a_bound, a_by = bound(*attn_work(q, mask), BF16_PEAK)
    kernels.append(dict(
        name=fa.KERNEL, route="cuda", source="fithubert_tpu_torch/csrc/flash_attention.cu",
        replaces="fithubert_tpu/ops/pallas/flash_attention.py:243",
        launches=main_path_launches.get(fa.KERNEL, 0), max_abs_err=errs["attn"],
        ms=a_ms, plain_ms=a_plain, bound_ms=a_bound, bound_by=a_by, library_ms=a_lib))
    for kd in kernels:
        print(f"  {kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f} ms by "
              f"{kd['bound_by']}, plain {kd['plain_ms']:.4f}, library {kd['library_ms']:.4f}), "
              f"{per_fwd.get(kd['name'], 0)} launches per forward", flush=True)

    # ---- 6. result lines
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
