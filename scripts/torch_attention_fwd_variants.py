"""Variants of the bf16 attention forward (K2, ``csrc/flash_attention.cu``)
against the kept kernel on one card: each variant is the source with a few
text replacements (``VARIANTS``), built with ``nvcc`` and ``_build.NVCC_FLAGS``
into ``build/fwd_variants/<name>/`` (git-ignored), all at once; each is held
to ``attention_fwd_tiles_plain`` at a few shapes (a ``diag_`` variant,
which computes something else on purpose, is timed all the same), then
timed at the paths' shapes as ``chip_smoke.py`` times kernels (``cuda_ms``,
reps 50), four rounds in turns. Run from the repository's root:

    python3 scripts/torch_attention_fwd_variants.py

Prints each variant's registers and spills, its check, and one ``RESULT``
line of JSON: per shape and variant, the time of each round.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

# two blocks an SM at D <= 64 (80 -> 128 registers at launch) with 3 stages:
# the first version's occupancy
TWO_BLOCKS = [
    ("static constexpr int STAGES = D <= 64 ? 4 : 2;", "static constexpr int STAGES = D <= 64 ? 3 : 2;"),
    ("static constexpr int BLOCKS_PER_SM = D <= 64 ? 3 : 2;", "static constexpr int BLOCKS_PER_SM = 2;"),
]
# the producer issues a stage's copies first and tests its keys after,
# those of the next stage loaded while the copies run, with a second
# arrival on the stage's full barrier for the flags
COPIES_FIRST = [
    ("mbar_init(smem_u32(&full[s]), 1);", "mbar_init(smem_u32(&full[s]), 2);"),
    ("""    for (int it = 0; it < n_kt; ++it) {
      const int s = it % F::STAGES, k0 = it * FT;
      if (it >= F::STAGES) mbar_wait(smem_u32(&empty[s]), ((it / F::STAGES) - 1) & 1);
      // the tile's keys that count: lane l tests keys l and l + 32
      const int j0 = k0 + lane, j1 = j0 + 32;
      const bool ok0 = j0 < T_len && !(mrow != nullptr && mrow[j0]);
      const bool ok1 = j1 < T_len && !(mrow != nullptr && mrow[j1]);
      const uint32_t lo = __ballot_sync(FULL, ok0), hi = __ballot_sync(FULL, ok1);
      if (lane == 0) {
        valid[s] = static_cast<uint64_t>(hi) << 32 | lo;  // seen by whoever waits on full[s]
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, 2 * F::TILE);""",
     """    auto counts = [&](int j) { return j < T_len && !(mrow != nullptr && mrow[j]); };
    bool ok0 = counts(lane), ok1 = counts(lane + 32);
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % F::STAGES, k0 = it * FT;
      if (it >= F::STAGES) mbar_wait(smem_u32(&empty[s]), ((it / F::STAGES) - 1) & 1);
      const uint32_t fb = smem_u32(&full[s]);
      const uint32_t lo = __ballot_sync(FULL, ok0), hi = __ballot_sync(FULL, ok1);
      ok0 = counts(k0 + FT + lane);
      ok1 = counts(k0 + FT + 32 + lane);
      if (lane == 0) {
        mbar_expect_tx(fb, 2 * F::TILE);"""),
    ("""          tma_load_4d(st + F::TILE + c * BOXB, &vmap, fb, 64 * c, k0, h, b);
        }
      }
    }
    return;""", """          tma_load_4d(st + F::TILE + c * BOXB, &vmap, fb, 64 * c, k0, h, b);
        }
        valid[s] = static_cast<uint64_t>(hi) << 32 | lo;
        mbar_arrive(fb);
      }
    }
    return;"""),
]
# 128-query blocks: two consumer warpgroups share each K / V stage and take
# turns to issue their products on named barriers (FlashAttention-3's
# ping-pong), one block an SM (168 registers at launch, 24 / 240)
PINGPONG = [
    ("  static constexpr int KV_OFF = TILE; ", "  static constexpr int KV_OFF = 2 * TILE; "),
    ("  static constexpr int THREADS = 256;", "  static constexpr int THREADS = 384;"),
    ("static constexpr int BLOCKS_PER_SM = D <= 64 ? 3 : 2;", "static constexpr int BLOCKS_PER_SM = 1;"),
    ("CONSUMER_REGS = 2 * LAUNCH_REGS - PRODUCER_REGS;",
     "CONSUMER_REGS = (3 * LAUNCH_REGS - PRODUCER_REGS) / 2 / 8 * 8;"),
    ("static_assert((PRODUCER_REGS + CONSUMER_REGS) * 128 == LAUNCH_REGS * THREADS,",
     "static_assert((PRODUCER_REGS + 2 * CONSUMER_REGS) * 128 <= LAUNCH_REGS * THREADS,"),
    ("template <bool MASKED>\n__device__ __forceinline__ void online_softmax",
     """__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");
}

template <bool MASKED>
__device__ __forceinline__ void online_softmax"""),
    ("  const int q0 = blockIdx.x * FT;", "  const int q0 = blockIdx.x * 2 * FT;"),
    ("mbar_init(smem_u32(&empty[s]), 4);", "mbar_init(smem_u32(&empty[s]), 8);"),
    ("  if (warp >= 4) {", "  if (warp >= 8) {"),
    ("    if (warp > 4) return;", "    if (warp > 8) return;"),
    ("""      mbar_expect_tx(qb, F::TILE);
#pragma unroll
      for (int c = 0; c < F::CB; ++c) tma_load_4d(base + c * BOXB, &qmap, qb, 64 * c, q0, h, b);""",
     """      mbar_expect_tx(qb, 2 * F::TILE);
#pragma unroll
      for (int c = 0; c < F::CB; ++c) {
        tma_load_4d(base + c * BOXB, &qmap, qb, 64 * c, q0, h, b);
        tma_load_4d(base + F::TILE + c * BOXB, &qmap, qb, 64 * c, q0 + FT, h, b);
      }"""),
    ("  const int row = q0 + 16 * warp + g;", "  const int row = q0 + FT * (warp >> 2) + 16 * (warp & 3) + g;"),
    ("sw128_desc(base + o) + 2 * (ks & 3)", "sw128_desc(base + (warp >> 2) * F::TILE + o) + 2 * (ks & 3)"),
    ("""  pack();

#pragma unroll 1""", """  pack();
  if ((warp >> 2) == 1 && n_kt > 1) named_arrive(1);  // warpgroup 0 issues first

#pragma unroll 1"""),
    ("""    mbar_wait(smem_u32(&full[s]), (it / F::STAGES) & 1);
    wgmma_fence();""", """    mbar_wait(smem_u32(&full[s]), (it / F::STAGES) & 1);
    named_sync(1 + (warp >> 2));
    wgmma_fence();"""),
    ("""    issue_pv(ps);  // tile it - 1's P V
    wgmma_commit();""", """    issue_pv(ps);  // tile it - 1's P V
    wgmma_commit();
    if ((warp >> 2) == 0 || it + 1 < n_kt) named_arrive(1 + ((warp >> 2) ^ 1));"""),
    ("  const dim3 grid((T_len + FT - 1) / FT, B * H);", "  const dim3 grid((T_len + 2 * FT - 1) / (2 * FT), B * H);"),
]
# diagnostic: the producer copies K and V for the first STAGES tiles only,
# the later tiles reuse stale stages (wrong results): what the copies cost
DIAG_SKIP_COPIES = [
    ("""      if (lane == 0) {
        valid[s] = static_cast<uint64_t>(hi) << 32 | lo;  // seen by whoever waits on full[s]
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, 2 * F::TILE);""", """      if (lane == 0) {
        valid[s] = static_cast<uint64_t>(hi) << 32 | lo;
        const uint32_t fb = smem_u32(&full[s]);
        if (it >= F::STAGES) mbar_arrive(fb);
      }
      if (lane == 0 && it < F::STAGES) {
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, 2 * F::TILE);"""),
]
VARIANTS = {"kept": [], "two_blocks": TWO_BLOCKS, "copies_first": COPIES_FIRST,
            "pingpong": PINGPONG, "diag_skip_copies": DIAG_SKIP_COPIES}
CHECKS = [((3, 299, 4, 40), 0.1), ((2, 599, 3, 64), 0.0), ((2, 130, 2, 128), 0.1),
          ((2, 65, 2, 64), 0.1)]
SHAPES = {"serving": ((32, 399, 12, 40), 0.0), "teacher": ((12, 599, 12, 64), 0.0),
          "student": ((12, 299, 12, 40), 0.1), "ex": ((8, 600, 12, 64), 0.1),
          "conformer-abs": ((3, 299, 12, 40), 0.1), "teacher-d40": ((12, 599, 12, 40), 0.0),
          "teacher-d48": ((12, 599, 12, 48), 0.0), "d128": ((12, 599, 12, 128), 0.1)}


def build():
    from fithubert_tpu_torch.ops.kernels import _build

    src = open(os.path.join(_build.CSRC, "flash_attention.cu")).read()
    procs = {}
    for name, patches in VARIANTS.items():
        d = os.path.join("build", "fwd_variants", name)
        subprocess.run(["rm", "-rf", d], check=True)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        subprocess.run(["cp", "-r", _build.CSRC, d], check=True)
        s = src
        for old, new in patches:
            if s.count(old) != 1:
                raise SystemExit(f"{name}: {old[:60]!r} is not in the source once")
            s = s.replace(old, new)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        for kernel, regs, stores, loads in _build.parse_ptxas(log):
            if kernel.startswith("flash_fwd_wgmma<40") or kernel.startswith("flash_fwd_wgmma<64"):
                print(f"[build] {name} {kernel}: {regs} registers, spills {stores} / {loads} B",
                      flush=True)
        libs[name] = ctypes.CDLL(os.path.join("build", "fwd_variants", name, "lib.so"))
    return libs


def main():
    import torch
    import torch.nn.functional as F
    from fithubert_tpu_torch.ops.kernels import flash_attention as fa
    from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

    t0 = time.time()
    libs = build()
    print(f"built in {time.time() - t0:.1f} s; {cs.smi_line()}", flush=True)
    argtypes = fa._fwd_fn().argtypes
    fns = {}
    for name, lib in libs.items():
        fn = lib.flash_attention_fwd
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn

    def use(name):
        fa._fwd_fn = lambda: fns[name]

    dev = torch.device("cuda")
    atol, rtol = cs.FWD_TILES_TOL["bfloat16"]
    timed = []
    for name in fns:
        use(name)
        ok = True
        for (b, t, h, d), p in CHECKS:
            g = torch.Generator().manual_seed(t + d)
            q, k, v = (torch.randn(b, t, h, d, generator=g).to(dev, torch.bfloat16)
                       for _ in range(3))
            q = q * d ** -0.5
            m = torch.zeros(b, t, dtype=torch.bool, device=dev)
            m[0, t // 2:] = True
            m[-1] = True
            seed = seed_tensor(3, 4, dev) if p else None
            out, lse = fa.flash_attention(q, k, v, m, dropout_p=p, seed=seed, return_lse=True)
            want, want_lse = fa.attention_fwd_tiles_plain(q, k, v, m, p, seed)
            rows = ~m.all(-1)
            err = (out[rows].float() - want[rows].float()).abs()
            good = bool((err <= atol + rtol * want[rows].float().abs()).all()) \
                and out[~rows].abs().max().item() == 0 \
                and (lse[rows] - want_lse[rows]).abs().max().item() < 1e-3
            ok &= good
            print(f"  {name} {(b, t, h, d)} p={p}: max_abs_err {err.max().item():.2e} "
                  f"{'ok' if good else 'MISMATCH'}", flush=True)
        if ok or name.startswith("diag_"):
            timed.append(name)
    res = {}
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for shape, ((b, t, h, d), p) in SHAPES.items():
            q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16)
                       for _ in range(3))
            q = q * d ** -0.5
            m = torch.zeros(b, t, dtype=torch.bool, device=dev)
            seed = seed_tensor(5, 6, dev) if p else None
            row = {}
            for _ in range(2):
                for name in timed + timed[::-1]:
                    use(name)
                    row.setdefault(name, []).append(round(cs.cuda_ms(
                        lambda: fa.flash_attention(q, k, v, m, dropout_p=p, seed=seed),
                        reps=50), 4))
            row["sdpa"] = round(cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=~m[:, None, None, :], dropout_p=p, scale=1.0), reps=50), 4)
            res[shape] = row
            print(f"  {shape}: " + ", ".join(
                f"{n} {min(x) if isinstance(x, list) else x}" for n, x in row.items()),
                flush=True)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
