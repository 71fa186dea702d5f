// FlashAttention forward with an fp32 online softmax, a key-padding mask and
// optional dropout on the attention probabilities.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the forward Pallas
//   kernel _make_fwd_kernel (:64) run by _fwd_pallas (:243), both branches:
//   dropout_p = 0 (serving, the teacher) and dropout_p > 0 (the student's
//   training forward, :100-106).
//
// Bound on the H100: three floors of about one size. At the teacher's shape
//   (B = 12, T = 599, H = 12, D = 64) the two products are 13.2 GFLOP,
//   0.0134 ms at the bf16 tensor-core peak, and reading q, k, v and writing
//   o and lse (44.5 MB) takes 0.0133 ms at 3.35 TB/s; at the serving shape
//   (B = 32, T = 399, H = 12, D = 40) the bytes (49.6 MB) take 0.0148 ms,
//   the products (9.8 GFLOP) 0.0099. The exponentials are a floor of the
//   same size: one exp2 per (query, valid key), 51.7 M at the teacher's
//   shape and 61.1 M at serving's, 0.0140 and 0.0165 ms on the special-
//   function units (16 a clock per SM, ~3.7e12 a second over 132 SMs at
//   ~1.75 GHz). With dropout, the keep mask's Philox (36 32-bit products a
//   call, one call per 4 keys) adds an integer-pipe floor of the same order.
//   The T x T logits never reach device memory.
//
// Design: in bf16 (every main path), Hopper's wgmma fed by TMA with warp
//   specialisation, as the TPU kernel multiplies bf16 operands into fp32
//   (:83-85) and rounds P to bf16 before P V (:108-111).
//   - Roles. A block takes one (64-query tile, b, h): a producer warpgroup
//     and one consumer warpgroup (64 queries, wgmma's M), 256 threads.
//     Three blocks share an SM at D <= 64, two above: the block launches at
//     the register cap of that many (80 a thread, 128 above) and setmaxnreg
//     moves the producer's down to 24 and the consumers' up to 136 (232
//     above), as the backward does. The launch checks the register count
//     first (REG_ERROR). Grid: one block per (query tile, b * H + h), on x
//     alone with the query tile fastest (tile_grid), so B * H may pass
//     65535; 1440 blocks at the teacher's shape, 2688 at serving's, 180 at
//     the abs conformer's.
//   - The producer's first warp loads the block's Q tile once (TMA, [64
//     rows][64 columns] boxes under the 128-byte swizzle: D > 64 takes two
//     boxes, D = 40 one box whose columns past D TMA fills with zeros, rows
//     past T too), then keeps a ring of K and V stages of 64 keys full (4
//     stages at D <= 64, 2 above: 73 and 81 KB of shared memory a block),
//     with a full and an empty mbarrier a stage. Its 32 lanes test the
//     stage's 64 keys (past T or padded) and one 64-bit ballot goes to
//     shared memory beside the stage before its copies are issued.
//   - The consumer warpgroup, per key tile: S = Q K^T (wgmma m64n64k16, A
//     = Q and B = K both K-major in shared memory, K-dim D padded to a
//     multiple of 16 by the zero columns); the online softmax in base 2 on
//     the accumulator fragments (S times log2 e and minus the running max
//     in one FMA, ex2.approx: the row max over the lane quad, per-lane
//     partial row sums until the epilogue; a tile with a padded key or a
//     key past T sets its S to -1e30 and its P to an explicit 0, so a fully
//     padded row gives out = 0 and lse = -1e30, as the TPU kernel does,
//     :93-97, :116-122; a tile of valid keys skips the tests); dropout on
//     the unnormalised P, the normaliser l undropped (:100-106); O += P V
//     with P rounded to bf16 and packed from the S accumulator straight into
//     wgmma's A registers (for 16-bit types the accumulator layout of two n8
//     columns is the A layout of one k16 step) and B = V read N-major
//     through the descriptor's transpose bit, N = D rounded up to 16 (D = 40
//     runs N = 48 over V's zero columns); O rescaled by alpha in fp32.
//   - Overlap, which the design is for: the exponentials cost as much as
//     the products. Within a warpgroup, tile j's S is issued together with
//     tile j - 1's P V, tile j's keep mask is drawn while both run, and tile
//     j's softmax runs while P V still does (FlashAttention-3's intra-
//     warpgroup pipelining); across the blocks of an SM, one block's
//     softmax runs while another's products do. A stage goes back to the
//     producer when its P V has completed. Measured on the card
//     (scripts/torch_attention_fwd_variants.py, PERF.md): blocks of 128
//     queries with two consumer warpgroups that take turns on named
//     barriers (FlashAttention-3's ping-pong), one block an SM, ran the
//     teacher's shape 39% and ex's 15% slower than this design (26% faster
//     at (12, 599, 12, 40), whose copies they halve), and three blocks an SM
//     ran 5-26% faster than two at D <= 64.
//   - Dropout: the keep test is philox.cuh's pure function of (seed, z =
//     b * H + h, row i, key j): counter (j >> 2, i, z, 0), word j & 3. A
//     warp's 16 rows of the accumulator have the m16n8 C layout (rows g, g
//     + 8 of lane 4g + t4; keys 8n + 2t4, +1), so lanes 4g + 2c and 4g + 2c
//     + 1 hold the four keys of one j >> 2 group on rows g and g + 8: the
//     even lane draws row g's call, the odd lane row g + 8's (PhiloxQuery:
//     the row and (b, h) stay fixed, so the first two rounds' halves free of
//     the key group and the key schedule are computed once), each tests its
//     call's four words, and one shuffle of the 32 bits of a tile's eight
//     calls gives each lane the bits it lacks: one Philox call per four (i,
//     j). The seed's two words are read from seed_ptr in device memory as
//     the block starts, so a CUDA graph's replays draw new masks, as the
//     TPU kernel reads its seed from SMEM (:247).
//   - Epilogue: out = O / l in fp32, stored from registers in bf16 (l = 0
//     gives 0); lse = m + log l, or -1e30 where l = 0, (B, H, T) fp32; rows
//     past T are not written.
//   - Inputs: q, k and v are read in place through their (B, T, H, D)
//     strides: each gets a TMA map over (D, T, H, B), encoded on the host at
//     each call; every row starts on 16 bytes (the wrapper copies any other
//     view). Head sizes: compiled for FA_HEAD_DIMS (16 to 128; the wrapper
//     zero-pads any other D to the next one).
//   - Registers and spills (_build.ptxas_usage, on the card): 80 registers
//     at launch at D <= 64 and 128 above, as planned, no spills.
//   - What bounds it on the card: not the products and not the softmax
//     alone. At (12, 599, 12, 64) it runs at ~28% of its bound; TMA's
//     copies of rows that start on 16 but not 32 bytes (D = 40, 80-byte
//     rows) are slow: 0.082 ms at (12, 599, 12, 40) against 0.055 with the
//     copies after the first stages skipped (PERF.md).
//
// fp32 (only the card-vs-CPU checks, held to 2e-3 end to end): the FMA body
//   of the port's first version, one thread per query row over 64-key fp32
//   tiles in shared memory. The tensor cores would take fp32 only as TF32,
//   whose 10-bit mantissa breaks that limit, so fp32 stays on the FMA pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64, BKV = 64, CHUNK = 16;  // the fp32 body's tiles
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------- bf16, wgmma fed by TMA
constexpr int FT = 64;           // rows of a tile: a consumer warpgroup's queries, a stage's keys
constexpr int ROWB = 128;        // bytes of a staged row: 64 bf16 columns, one swizzle row
constexpr int BOXB = FT * ROWB;  // one [64 rows][64 columns] TMA box, 8 KB

template <int D>
struct Fwd {
  static constexpr int CB = (D + 63) / 64;        // 64-column boxes of a row
  static constexpr int KS = (D + 15) / 16;        // k16 steps of S = Q K^T
  static constexpr int NV = KS * 16;              // P V's N: D = 40 takes 48 (V's zero columns)
  static constexpr int STAGES = D <= 64 ? 4 : 2;  // K and V stages
  static constexpr int TILE = CB * BOXB;          // a Q, K or V tile: [box][64 rows][128 bytes]
  static constexpr int KV_OFF = TILE;             // the Q tile, then stage s's K, V
  static constexpr int SMEM = KV_OFF + STAGES * 2 * TILE + 1024;  // + room to align
  // the consumer warpgroup, then the producer's; at launch the register
  // cap of BLOCKS_PER_SM blocks an SM (80 a thread at D <= 64, 128 above),
  // then setmaxnreg moves the producer's down to 24 and the consumers' up
  // (136, 232) within the block
  static constexpr int THREADS = 256;
  static constexpr int BLOCKS_PER_SM = D <= 64 ? 3 : 2;
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * BLOCKS_PER_SM) / 8 * 8;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 2 * LAUNCH_REGS - PRODUCER_REGS;
  static_assert((PRODUCER_REGS + CONSUMER_REGS) * 128 == LAUNCH_REGS * THREADS,
                "setmaxnreg hands the producer's registers to the consumers, no more");
  static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 228 * 1024, "the blocks share an SM");
  static_assert(D % 8 == 0, "wgmma N is a multiple of 8");
};

// The online softmax of one key tile on a thread's S fragments, in place:
// s[4n + e] (row g + 8 (e >> 1), key 8n + 2 t4 + (e & 1)) becomes P =
// exp(S - m) against the updated running max m (per row, raw logits); l
// becomes l * alpha + the lane's part of the row sum; alpha goes to al.
// MASKED: bit 2n + c of okb says whether key 8n + 2 t4 + c counts; the
// others get S = -1e30 (out of the max) and P = 0 explicitly.
template <bool MASKED>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&al)[2], uint32_t okb) {
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!((okb >> (2 * (i >> 2) + (i & 1))) & 1u)) s[i] = NEG_INF;
  }
  float mx[2] = {m[0], m[1]}, mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    // m = -1e30 (no key so far) gives alpha = 0 against a finite max: O and l are 0
    al[r] = exp2_ftz((m[r] - mx[r]) * LOG2E);
    m[r] = mx[r];
    mb[r] = mx[r] * LOG2E;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2_ftz(fmaf(s[i], LOG2E, -mb[(i >> 1) & 1]));
    // masked keys are zeroed explicitly: in a row without a valid key so
    // far, s - m is 0 and exp2 would give 1
    s[i] = MASKED && !((okb >> (2 * (i >> 2) + (i & 1))) & 1u) ? 0.f : p;
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + sum[r];
}

// Block (query tile, b * H + h) of tile_grid. qmap, kmap, vmap: 4-D maps (D, T, H, B) of
// q, k and v with [64 rows][64 columns] boxes (map_rows).
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Fwd<D>::THREADS, Fwd<D>::BLOCKS_PER_SM)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ mask,
                bf16* __restrict__ out, float* __restrict__ lse, int T_len, int H, Dropout dr) {
  using F = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::STAGES], empty[F::STAGES], q_full;
  __shared__ uint64_t valid[F::STAGES];  // bit j: key j of the stage's tile counts
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_kt = (T_len + FT - 1) / FT;  // key tiles, and query tiles of the grid
  int qt, bh;
  block_tile(n_kt, qt, bh);
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * FT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);   // the producer's lane 0, with the bytes
      mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&q_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup: its first warp loads, the rest leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F::PRODUCER_REGS) : "memory");
    if (warp > 4) return;
    if (lane == 0) {
      const uint32_t qb = smem_u32(&q_full);
      mbar_expect_tx(qb, F::TILE);
#pragma unroll
      for (int c = 0; c < F::CB; ++c) tma_load_4d(base + c * BOXB, &qmap, qb, 64 * c, q0, h, b);
    }
    const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * T_len;
    for (int it = 0; it < n_kt; ++it) {
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
        mbar_expect_tx(fb, 2 * F::TILE);
        const uint32_t st = base + F::KV_OFF + s * 2 * F::TILE;
#pragma unroll
        for (int c = 0; c < F::CB; ++c) {
          tma_load_4d(st + c * BOXB, &kmap, fb, 64 * c, k0, h, b);
          tma_load_4d(st + F::TILE + c * BOXB, &vmap, fb, 64 * c, k0, h, b);
        }
      }
    }
    return;
  }

  // the consumers: queries q0 .. q0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F::CONSUMER_REGS) : "memory");
  const int g = lane >> 2, t4 = lane & 3;
  const bool odd = t4 & 1;
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8
  // this lane's Philox calls: counter (key group, row (+ 8 in an odd lane), b * H + h, 0)
  const PhiloxQuery rng(static_cast<uint32_t>(row + (odd ? 8 : 0)), static_cast<uint32_t>(bh),
                        dr.seed0, dr.seed1);
  const uint32_t thr8 = dr.thr << 8;  // (word >> 8) >= thr  <=>  word >= thr << 8

  float oacc[F::NV / 2];
#pragma unroll
  for (int i = 0; i < F::NV / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running row max of the raw logits
  float l_r[2] = {0.f, 0.f};          // this lane's part of the row sum
  float sacc[32], al[2];
  uint32_t pf[4][4];  // P as the A fragments of P V: k16 step kk = n8 tiles 2kk, 2kk + 1
  uint2 keep = make_uint2(0u, 0u);

  // S = Q K^T of the key tile in stage s; the first k16 step overwrites S
  auto issue_s = [&](int s) {
    const uint32_t kb = base + F::KV_OFF + s * 2 * F::TILE;
#pragma unroll
    for (int ks = 0; ks < F::KS; ++ks) {  // k16 step ks: box ks / 4, 32 bytes a step in it
      const uint32_t o = (ks >> 2) * BOXB;
      wgmma_ss<64, 0, 0>(sacc, sw128_desc(base + o) + 2 * (ks & 3),
                         sw128_desc(kb + o) + 2 * (ks & 3), ks > 0);
    }
  };
  // O += P V of the key tile in stage s; V [key][D], read N-major
  auto issue_pv = [&](int s) {
    const uint32_t vb = base + F::KV_OFF + s * 2 * F::TILE + F::TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<F::NV, 1>(oacc, pf[kk], sw128_mn_desc(vb + kk * 2048, BOXB));
  };
  // The keep bits of the key tile at k0: bit 4n + c of .x (row) and .y
  // (row + 8) keeps key k0 + 8n + 2 t4 + c. This lane's call n covers keys
  // k0 + 8n + 4 (t4 >> 1) .. + 3 of one row; its four tests, shifted to
  // bits 4n.., and the partner lane's (mask 1) hold both rows.
  auto draw = [&](int k0) {
    uint32_t own = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint4 w = rng.draw(static_cast<uint32_t>(k0 / 4 + 2 * n + (t4 >> 1)));
      own |= ((w.x >= thr8 ? 1u : 0u) | (w.y >= thr8 ? 2u : 0u) | (w.z >= thr8 ? 4u : 0u) |
              (w.w >= thr8 ? 8u : 0u)) << (4 * n);
    }
    const uint32_t other = __shfl_xor_sync(FULL, own, 1);
    const int sh = odd ? 2 : 0;  // an odd lane's keys are words 2 and 3 of the group
    return make_uint2((odd ? other : own) >> sh, (odd ? own : other) >> sh);
  };
  // the softmax of the tile in stage s, its keys' validity from the producer
  auto softmax = [&](int s) {
    const uint64_t vb = valid[s];
    if (vb == ~0ull) {
      online_softmax<false>(sacc, m_r, l_r, al, 0u);
    } else {
      const uint64_t sh = vb >> (2 * t4);
      uint32_t okb = 0;  // bit 2n + c: key 8n + 2 t4 + c
#pragma unroll
      for (int n = 0; n < 8; ++n) okb |= static_cast<uint32_t>((sh >> (8 * n)) & 3u) << (2 * n);
      online_softmax<true>(sacc, m_r, l_r, al, okb);
    }
  };
  // P, dropped and scaled by 1 / (1 - p) where DROPOUT, rounded to bf16
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int n = 2 * kk + (x >> 1), r = x & 1;
        float a = sacc[4 * n + 2 * r], c = sacc[4 * n + 2 * r + 1];
        if (DROPOUT) {
          const uint32_t kb = r ? keep.y : keep.x;
          a = (kb >> (4 * n)) & 1u ? a * dr.inv_keep : 0.f;
          c = (kb >> (4 * n + 1)) & 1u ? c * dr.inv_keep : 0.f;
        }
        pf[kk][x] = pack_bf16(a, c);
      }
  };

  mbar_wait(smem_u32(&q_full), 0);
  mbar_wait(smem_u32(&full[0]), 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  if (DROPOUT) keep = draw(0);
  wgmma_wait<0>();
  fence_acc(sacc);
  softmax(0);
  pack();

#pragma unroll 1
  for (int it = 1; it < n_kt; ++it) {
    const int s = it % F::STAGES, ps = (it - 1) % F::STAGES;
    mbar_wait(smem_u32(&full[s]), (it / F::STAGES) & 1);
    wgmma_fence();
    issue_s(s);  // tile it's S
    wgmma_commit();
    issue_pv(ps);  // tile it - 1's P V
    wgmma_commit();
    if (DROPOUT) keep = draw(it * FT);  // while both run
    wgmma_wait<1>();  // S
    fence_acc(sacc);
    softmax(s);  // while P V runs
    wgmma_wait<0>();  // P V
    fence_acc(oacc);
    fence_regs(pf);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[ps]));  // stage ps back to the producer
#pragma unroll
    for (int i = 0; i < F::NV / 2; ++i) oacc[i] *= al[(i >> 1) & 1];
    pack();
  }
  wgmma_fence();
  issue_pv((n_kt - 1) % F::STAGES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(oacc);
  fence_regs(pf);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row + 8 * r;
    if (t >= T_len) continue;
    const float inv = l_r[r] == 0.f ? 0.f : 1.f / l_r[r];
    bf16* op = out + ((static_cast<long long>(b) * T_len + t) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
          __floats2bfloat162_rn(oacc[4 * n + 2 * r] * inv, oacc[4 * n + 2 * r + 1] * inv);
    if (t4 == 0)
      lse[static_cast<long long>(bh) * T_len + t] =
          l_r[r] == 0.f ? NEG_INF : m_r[r] + logf(l_r[r]);
  }
}

// ------------------------------------------------------------- fp32, FMAs
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
          int T_len, int H, long long sqb, long long sqt, long long sqh, long long skb,
          long long skt, long long skh, long long svb, long long svt, long long svh,
          uint32_t thr, float inv_keep, const uint32_t* __restrict__ seed_ptr) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  extern __shared__ __align__(16) unsigned char smem[];  // fwd_smem<D>() bytes
  auto Ks = reinterpret_cast<float (*)[D]>(smem);
  auto Vs = reinterpret_cast<float (*)[D]>(smem + BKV * D * sizeof(float));
  auto valid = reinterpret_cast<float*>(smem + 2 * BKV * D * sizeof(float));
  const uint32_t seed0 = DROPOUT ? seed_ptr[0] : 0u, seed1 = DROPOUT ? seed_ptr[1] : 0u;

  int qt, bh;
  block_tile((T_len + BQ - 1) / BQ, qt, bh);
  const int b = bh / H, h = bh - b * H;
  const int t = qt * BQ + threadIdx.x;
  const bool row_ok = t < T_len;

  float qr[D], acc[D];
  {
    const float* qp = q + b * sqb + static_cast<long long>(row_ok ? t : 0) * sqt + h * sqh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? qp[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  for (int k0 = 0; k0 < T_len; k0 += BKV) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e - j * D, kt = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kt < T_len) {
        kv = kb[static_cast<long long>(kt) * skt + d];
        vv = vb[static_cast<long long>(kt) * svt + d];
      }
      Ks[j][d] = kv;
      Vs[j][d] = vv;
    }
    {
      const int kt = k0 + threadIdx.x;  // BQ == BKV: one flag per thread
      valid[threadIdx.x] =
          (kt < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + kt]))
              ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < BKV; c += CHUNK) {
      float sc[CHUNK];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(Ks[c + j]);
        float s = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = kr[d4];
          s = fmaf(qr[4 * d4], kv.x, s);
          s = fmaf(qr[4 * d4 + 1], kv.y, s);
          s = fmaf(qr[4 * d4 + 2], kv.z, s);
          s = fmaf(qr[4 * d4 + 3], kv.w, s);
        }
        sc[j] = valid[c + j] != 0.f ? s : NEG_INF;
        mc = fmaxf(mc, sc[j]);
      }
      float drop[CHUNK];  // 1/(1-p) where kept, 0 where dropped
      if (DROPOUT) {
#pragma unroll
        for (int g = 0; g < CHUNK / 4; ++g) {
          const uint4 w = philox4x32(make_uint4((k0 + c) / 4 + g, t, bh, 0u), seed0, seed1);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            drop[4 * g + e] = (philox_word(w, e) >> 8) >= thr ? inv_keep : 0.f;
        }
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        // masked keys are zeroed explicitly: for a fully masked row
        // sc - m_new is 0 and exp would give 1
        const float p = valid[c + j] != 0.f ? expf(sc[j] - m_new) : 0.f;
        l += p;
        const float pv = DROPOUT ? p * drop[j] : p;
        const float4* vr = reinterpret_cast<const float4*>(Vs[c + j]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(pv, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(pv, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pv, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pv, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
    float* op = out + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
    lse[(static_cast<long long>(b) * H + h) * T_len + t] = l == 0.f ? NEG_INF : m + logf(l);
  }
}


template <int D>
constexpr int fwd_smem() { return 2 * BKV * D * sizeof(float) + BKV * sizeof(float); }

// The TMA maps of q, k and v, encoded on the host.
int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int d,
                int B, int T_len, int H, const Strides& st) {
  int err = map_rows(&maps[0], static_cast<const bf16*>(q), d, B, T_len, H, st.qb, st.qt, st.qh);
  if (err == 0)
    err = map_rows(&maps[1], static_cast<const bf16*>(k), d, B, T_len, H, st.kb, st.kt, st.kh);
  if (err == 0)
    err = map_rows(&maps[2], static_cast<const bf16*>(v), d, B, T_len, H, st.vb, st.vt, st.vh);
  return err;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                float* lse, int B, int T_len, int H, const Strides& st, Dropout dr,
                cudaStream_t stream) {
  using F = Fwd<D>;
  CUtensorMap maps[3];
  int err = encode_maps(maps, q, k, v, D, B, T_len, H, st);
  if (err != 0) return err;
  const bool drop = dr.thr > 0;
  auto kernel = drop ? flash_fwd_wgmma<D, true> : flash_fwd_wgmma<D, false>;
  static bool ready[2] = {false, false};
  // setmaxnreg's budget holds only at the launch count it was planned on
  if (!ready[drop] && (err = check_regs(kernel, F::LAUNCH_REGS)) != 0) return err;
  if ((err = allow_smem(kernel, F::SMEM, &ready[drop])) != 0) return err;
  dim3 grid;
  if ((err = tile_grid((T_len + FT - 1) / FT, B, H, &grid)) != 0) return err;
  kernel<<<grid, F::THREADS, F::SMEM, stream>>>(maps[0], maps[1], maps[2], mask,
                                                static_cast<bf16*>(out), lse, T_len, H, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
               float* lse, int B, int T_len, int H, const Strides& st, Dropout dr,
               cudaStream_t stream) {
  static bool opted[2] = {false, false};
  auto kernel = dr.thr > 0 ? &flash_fwd<D, true> : &flash_fwd<D, false>;
  opt_in_smem(kernel, fwd_smem<D>(), opted[dr.thr > 0]);
  dim3 grid;
  if (const int err = tile_grid((T_len + BQ - 1) / BQ, B, H, &grid)) return err;
  kernel<<<grid, BQ, fwd_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), lse, T_len, H, st.qb, st.qt, st.qh, st.kb, st.kt, st.kh,
      st.vb, st.vt, st.vh, dr.thr, dr.inv_keep, dr.ptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim one of FA_HEAD_DIMS. q, k, v
// (B, T, H, D) with the given (b, t, h) element strides and unit stride
// along D (bf16: every row 16-byte aligned); mask (B, T) bool with True =
// padding, or null; out (B, T, H, D) and lse (B, H, T) fp32, contiguous.
// thr = floor(p * 2^24) (0: no dropout), inv_keep = 1/(1-p); seed_ptr
// points to the two dropout seed words in device memory, read by the kernel
// (null without dropout). Returns cudaGetLastError() after the launch, a
// tensor-map error code (hopper.cuh TMA_ERROR) or a register-plan error
// (flash_tile.cuh REG_ERROR).
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* mask, void* out, void* lse,
                                   int B, int T_len, int H, long long sqb, long long sqt,
                                   long long sqh, long long skb, long long skt, long long skh,
                                   long long svb, long long svt, long long svh,
                                   unsigned thr, float inv_keep, const void* seed_ptr,
                                   void* stream) {
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_FWD(DD)                                                                        \
  if (head_dim == DD) {                                                                   \
    if (dtype == 1) return launch_bf16<DD>(q, k, v, mk, out, ls, B, T_len, H, st, dr, s); \
    if (dtype == 0) return launch_f32<DD>(q, k, v, mk, out, ls, B, T_len, H, st, dr, s);  \
    return static_cast<int>(cudaErrorInvalidValue);                                       \
  }
  FA_HEAD_DIMS(FA_FWD)
#undef FA_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}
