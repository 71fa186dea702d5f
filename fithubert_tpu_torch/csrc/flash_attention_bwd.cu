// FlashAttention backward with the key-padding mask and the forward's
// dropout mask regenerated: in bf16 one fused pass for dK, dV and per-key-
// tile dQ partials, a pre-pass for delta and a pass that sums the partials;
// in fp32 a dQ body and a dK/dV body on FMA.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the backward Pallas
//   kernels _make_bwd_dq_kernel (:127, run at :304) and _make_bwd_dkv_kernel
//   (:173, run at :323), and the sum delta = rowsum(dO * O) that the TPU
//   computes outside them (:302).
//
// Per (query i, key j), as the TPU kernels compute it:
//   P  = exp(s - lse), zeroed explicitly at masked keys (:148-150), so a
//        fully padded row (lse = -1e30) gives exactly zero gradients;
//   dP = dO . v_j, dropped and scaled like P in the forward;
//   dS = P * (dP - delta_i);
//   dV += P_dropped dO,  dK += dS q_i,  dQ += dS k_j.
// The keep mask is philox.cuh's pure function of (seed, z = b * H + h, i,
// j): counter (j >> 2, i, z, 0), word j & 3, so it equals the forward's
// whatever the tiling; the seed is read from device memory (seed_ptr) as a
// block starts, so a CUDA graph replays with whatever words it holds. q, k,
// v are read through their (B, T, H, D) strides; dO, lse, delta and the
// outputs are contiguous. D is one of FA_HEAD_DIMS (the wrapper zero-pads
// others), T any length.
//
// Bound on the H100: bytes, for every pass. At the student's training shape
//   (bf16, B = 12, T = 299, H = 12, D = 40, p = 0.1) the fused pass reads q,
//   k, v, dO (13.8 MB), lse, delta and the mask (0.35 MB) and writes dK, dV
//   (6.9 MB) and the fp32 dQ partials of its 5 key tiles of 64 (34.4 MB):
//   55.4 MB, 0.0166 ms at 3.35 TB/s, against 12 D flops per (i, valid j)
//   (S, dP, dV, dK, and dS K twice, below): at most 6.2 GFLOP, 0.0063 ms at
//   the bf16 tensor-core peak. The pre-pass moves 7.1 MB (0.0021 ms), the dQ
//   sum 37.8 MB (0.0113 ms). The partials are the design's own bytes: the
//   whole backward must move only q, k, v, O, dO, lse and the mask in and
//   dQ, dK, dV out (27.9 MB, 0.0083 ms). The T x T matrices P and dS never
//   reach device memory: they are recomputed from lse.
//
// Design: in bf16, three launches.
//   1. flash_bwd_prep: delta (B, H, T) fp32 = rowsum(dO * O), one thread per
//      (b, t, h) row, reading dO and O in q's dtype once.
//   2. flash_bwd_fused, on Hopper's wgmma fed by TMA. A block takes one
//      (64-key tile, b, h): a producer warpgroup and one consumer warpgroup
//      (64 keys, the wgmma's M), at every head size. (Two consumer
//      warpgroups on 128 keys ran the pass slower at D = 40 and 64 on the
//      card; no config trains at a larger D.)
//      - Registers: a block (8 warps) launches at 128 registers a thread,
//        the cap of __launch_bounds__(256, 2), which ptxas gives a kernel
//        that uses setmaxnreg; setmaxnreg then moves them within the block,
//        the producers down to 24 and the consumers up to 232 (a
//        static_assert holds the balance). Shared memory lets two blocks
//        share an SM at D <= 64, one above. The launch checks the kernel's
//        register count first: at another count the consumers would wait
//        for registers the block does not hold (REG_ERROR).
//      - The producer's first warp loads the block's K and V once (TMA),
//        then keeps a ring of 3 stages full: each stage a 64-query tile of
//        Q and of dO (TMA, [64 rows][64 columns] boxes under the 128-byte
//        swizzle; D > 64 takes two boxes, D = 40 one box whose columns past
//        D TMA fills with zeros, rows past T too) and the tile's lse (times
//        log2 e, +1e30 past T, so exp2 gives 0 there) and delta, which its
//        32 lanes load and store themselves. Each stage has a full mbarrier
//        (the 32 lanes' arrivals and the TMA bytes) and an empty one (one
//        arrival per consumer warp).
//      - Each consumer warpgroup walks every query tile, key-major: S^T =
//        K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major in
//        shared memory, K-dim D padded to a multiple of 16 by the zero
//        columns), then P^T = exp2(S^T log2 e - lse log2 e) (exp2_ftz),
//        the keep mask and dS^T in registers; dV += P_dropped^T dO and dK +=
//        dS^T Q
//        (wgmma m64nDk16 with A from registers: the accumulator layout of
//        S^T is, per warp, the A fragment of the next product; B read
//        N-major through the descriptor's transpose bit), bf16 operands and
//        fp32 sums, P_dropped and dS rounded to bf16 as the TPU kernel
//        does (:212-220).
//      - The elementwise work, not the products or the bytes, bounds the
//        pass (on the card, drawing the keep mask took 40% of a first
//        version's time, and without dropout it ran at about 3x its
//        bound). So it is laid out to overlap them: a tile's keep mask is drawn while its S^T and
//        dP^T products run, and its dV, dK and dQ products run on while the
//        next tile's products are issued and its mask drawn (the dQ
//        partial, the A fragments and the stage are retired a tile late).
//      - Dropout: a warp's 16 x 8 slice of an accumulator has the lane
//        layout of an mma.sync m16n8 C tile: lanes 16a + 4u + t4 (u = 0..3)
//        hold keys 4a + u and 4a + u + 8, two j >> 2 groups, at queries 8n +
//        2t4, +1. Lane u draws the call (group + 2 (u >> 1), query + (u &
//        1)): one Philox call per four (i, j), as in the forward. Each lane
//        tests its call's four words, and two __shfl_xor_sync (masks 4, 8)
//        gather the four lanes' 4-bit results. A lane's counters keep their
//        key group and (b, h) at every query, so philox.cuh's PhiloxRow
//        takes what the first three rounds compute without the query, and
//        the key schedule, out of the loop (the same function, checked).
//      - dQ, deterministic, no atomics: the consumers stage dS^T in shared
//        memory as two bf16 parts, hi = bf16(dS) and lo = bf16(dS - hi)
//        ([key][64 queries], the 128-byte swizzle, double-buffered), and
//        after a barrier of the warpgroup compute the tile's dQ partial
//        over the block's keys: hi K + lo K (wgmma with A = dS read M-major
//        and B = K N-major from shared memory). With dS
//        in two parts it carries ~16 bits: K is not pre-scaled as q is, and
//        where a row has few valid keys its dS terms are large, so one
//        rounding moved single dQ elements past the 1e-2 + 1e-2 limit
//        (0.0625 at (2, 63, 3, 40) on the card). The partial goes to the
//        block's own slice of an fp32 scratch (key tiles, B, T, H, D).
//   3. flash_bwd_dq_sum: dQ = the slices summed in key-tile order, written in
//      q's dtype, as K6's dW sums its chunks (conv_frontend_bwd.cu). An
//      ordered sum in one buffer (a turn counter per query tile) was not
//      taken: it needs counters reset inside a captured graph and blocks
//      that wait on blocks the card may not have scheduled.
//   The three launch in order on one stream; every sum has a fixed order,
//   so the gradients are bit-identical run to run and in a graph replay.
//   Registers and spills (_build.ptxas_usage, on the card; the launch
//   count, before setmaxnreg): 128 at every D; no spills at D = 16-80, 128-
//   304 bytes a thread at 96 and 384-476 at 128, where dK, dV and the dQ
//   partial hold 3 D / 2 fp32 accumulators a thread (PERF.md).
// fp32 (only the card-vs-CPU checks): FMA bodies after the pre-pass. dQ:
//   one 64-thread block per (b, h, 64-row query tile), one thread per query
//   row i holding q_i, dO_i and the dQ accumulator in fp32 registers; the
//   block walks the key axis in 64-key tiles of K and V staged in shared
//   memory as fp32 (broadcast reads). dK/dV: one 64-thread block per (b, h,
//   64-key tile), one thread per key column j, the block walking every
//   query tile. The tensor cores would take fp32 only as TF32, whose 10-bit
//   mantissa breaks the 2e-3 end-to-end checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64, BKV = 64;  // the fp32 bodies' tiles
constexpr float LOG2E = 1.4426950408889634f;

constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ delta pre-pass
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

// delta[b, h, t] = sum_d dO[b, t, h, d] O[b, t, h, d] in fp32, one thread
// per (b, t, h) row (h fastest, so a warp reads consecutive rows); VEC: rows
// read in 16-byte chunks.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ delta,
               long long rows, int T_len, int H, int D) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* a = dout + r * D;
  const T* o = out + r * D;
  float s = 0.f;
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    for (int c = 0; c < D; c += E) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + c);
      const uint4 y = *reinterpret_cast<const uint4*>(o + c);
      const T* xe = reinterpret_cast<const T*>(&x);
      const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(as_float(xe[e]), as_float(ye[e]), s);
    }
  } else {
    for (int c = 0; c < D; ++c) s = fmaf(as_float(a[c]), as_float(o[c]), s);
  }
  const int h = static_cast<int>(r % H);
  const long long bt = r / H;
  const long long b = bt / T_len;
  delta[(b * H + h) * T_len + (bt - b * T_len)] = s;
}

// ------------------------------------------------------- fused bf16 backward
constexpr int FT = 64;            // queries of a ring stage; keys of a consumer warpgroup
constexpr int ROWB = 128;         // bytes of a staged row: 64 bf16 columns, one swizzle row
constexpr int BOXB = FT * ROWB;   // one [64 rows][64 columns] TMA box, 8 KB

template <int D>
struct Fused {
  static constexpr int CB = (D + 63) / 64;    // 64-column boxes of a row
  static constexpr int KS = (D + 15) / 16;    // k16 steps of a product over D
  static constexpr int STAGES = 3;
  static constexpr int TILE = CB * BOXB;      // a Q or dO tile: [box][64 rows][128 bytes]
  static constexpr int STAGE = 2 * TILE;      // Q, then dO
  static constexpr int KV = CB * BOXB;        // K or V: [box][64 keys][128 bytes]
  static constexpr int DS = 2 * BOXB;         // dS^T hi, then lo: [key][64 queries]
  static constexpr int K_OFF = STAGES * STAGE, V_OFF = K_OFF + KV, DS_OFF = V_OFF + KV;
  static constexpr int LD_OFF = DS_OFF + 2 * DS;  // lse and delta: [stage][2][64] fp32
  static constexpr int SMEM = LD_OFF + STAGES * 2 * FT * 4 + 1024;  // + room to align
  // the consumer warpgroup, then the producer's; at launch 128 registers a
  // thread (the cap of two blocks an SM), then setmaxnreg moves them from
  // the producer (24) to the consumers (232) within the block
  static constexpr int THREADS = 256;
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * BLOCKS_PER_SM);
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 232;
  static_assert((PRODUCER_REGS + CONSUMER_REGS) * 128 == LAUNCH_REGS * THREADS,
                "setmaxnreg hands the producer's registers to the consumers, no more");
  static_assert(D % 8 == 0, "wgmma N is a multiple of 8");
};

// A barrier of the consumer warpgroup's 128 threads alone.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The tile's dQ partial (64 queries x D) = dS (hi, then lo, each [key][64
// queries] at dsb) times K (at kb): issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void dq_issue(float (&acc)[D / 2], uint32_t dsb, uint32_t kb) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < FT / 16; ++ks) {
    const uint64_t db = sw128_mn_desc(kb + ks * 2048, FT * ROWB);
    wgmma_ss<D, 1, 1>(acc, sw128_mn_desc(dsb + ks * 2048, BOXB), db);
    wgmma_ss<D, 1, 1>(acc, sw128_mn_desc(dsb + FT * ROWB + ks * 2048, BOXB), db);
  }
  wgmma_commit();
}

// Rows q and q + 8 of a warp's 16 of a dQ partial to dst (row q's column 0
// for this thread), rows at or past T_len skipped.
template <int D>
__device__ __forceinline__ void dq_store(const float* acc, float* dst, long long row_stride,
                                         bool ok0, bool ok1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!(r == 0 ? ok0 : ok1)) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + r * 8 * row_stride + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Block (key tile kt, b * H + h) of tile_grid. qmap, kmap, vmap, omap: 4-D maps (D, T,
// H, B) of q, k, v and dO with [64 rows][64 columns] boxes.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(Fused<D>::THREADS, Fused<D>::BLOCKS_PER_SM)
flash_bwd_fused(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq_part,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int H, int B,
                Dropout dr) {
  using F = Fused<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[F::STAGES], empty[F::STAGES], kv_full;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const ld = reinterpret_cast<float*>(smem_raw + (base - raw) + F::LD_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_qt = (T_len + FT - 1) / FT;  // query tiles, and key tiles of the grid
  int kt, bh;
  block_tile(n_qt, kt, bh);
  const int b = bh / H, h = bh - b * H;
  const int key0 = kt * FT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 32);  // the producer's 32 lanes (lane 0 with the bytes)
      mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&kv_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup: its first warp loads, the rest leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F::PRODUCER_REGS) : "memory");
    if (warp > 4) return;
    if (lane == 0) {
      const uint32_t kvb = smem_u32(&kv_full);
      mbar_expect_tx(kvb, 2 * F::KV);
#pragma unroll
      for (int c = 0; c < F::CB; ++c) {
        tma_load_4d(base + F::K_OFF + c * BOXB, &kmap, kvb, 64 * c, key0, h, b);
        tma_load_4d(base + F::V_OFF + c * BOXB, &vmap, kvb, 64 * c, key0, h, b);
      }
    }
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % F::STAGES, q0 = it * FT;
      if (it >= F::STAGES) mbar_wait(smem_u32(&empty[s]), ((it / F::STAGES) - 1) & 1);
      float* lds = ld + s * 2 * FT;
#pragma unroll
      for (int e = lane; e < FT; e += 32) {
        const int t = q0 + e;
        const long long row = static_cast<long long>(bh) * T_len + t;
        // rows past T: exp2(s - 1e30) = 0, so they add nothing
        lds[e] = t < T_len ? lse[row] * LOG2E : 1e30f;
        lds[FT + e] = t < T_len ? delta[row] : 0.f;
      }
      const uint32_t fb = smem_u32(&full[s]);
      if (lane == 0) {
        mbar_expect_tx(fb, F::STAGE);
        const uint32_t st = base + s * F::STAGE;
#pragma unroll
        for (int c = 0; c < F::CB; ++c) {
          tma_load_4d(st + c * BOXB, &qmap, fb, 64 * c, q0, h, b);
          tma_load_4d(st + F::TILE + c * BOXB, &omap, fb, 64 * c, q0, h, b);
        }
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  // the consumers: keys key0 .. key0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F::CONSUMER_REGS) : "memory");
  const int wq = warp, g = lane >> 2, t4 = lane & 3;
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }
  // this thread's keys: rows krow and krow + 8 of the block's 64
  const int krow = 16 * wq + g;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + krow + 8 * r;
    key_ok[r] = j < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + j]);
  }
  const int u = g & 3;  // this lane's place among the 4 lanes of one key group
  const uint32_t jg = static_cast<uint32_t>((key0 + 16 * wq + (g & ~3)) / 4 + 2 * (u >> 1));
  // this lane's Philox calls: counter (jg, i, bh, 0) at each query row i it draws
  const PhiloxRow rng(jg, static_cast<uint32_t>(bh), dr.seed0, dr.seed1);
  const uint32_t thr8 = dr.thr << 8;  // (word >> 8) >= thr  <=>  word >= thr << 8

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  const uint32_t kb = base + F::K_OFF, vb = base + F::V_OFF;
  const long long dq_row = static_cast<long long>(H) * D;  // (t, h, d) stride of t
  float* const part = dq_part + (static_cast<long long>(kt) * B + b) * T_len * dq_row +
                      static_cast<long long>(h) * D + 2 * t4;
  // carried from tile it to it + 1: the dQ partial and the A fragments of
  // the tile's dV and dK products, which run on while the next tile starts
  float dqa[D / 2];
  uint32_t pf[4][4], hf[4][4];
  // the partial of tile it - 1 to its rows, and its stage back to the producer
  auto retire = [&](int it) {
    fence_acc(dqa);
    fence_regs(pf);
    fence_regs(hf);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[it % F::STAGES]));
    const int q = it * FT + 16 * wq + g;  // rows q and q + 8 of this warp's 16
    dq_store<D>(dqa, part + static_cast<long long>(q) * dq_row, dq_row, q < T_len,
                q + 8 < T_len);
  };
  mbar_wait(smem_u32(&kv_full), 0);

#pragma unroll 1
  for (int it = 0; it < n_qt; ++it) {
    const int s = it % F::STAGES, q0 = it * FT;
    mbar_wait(smem_u32(&full[s]), (it / F::STAGES) & 1);
    const uint32_t qs = base + s * F::STAGE, os = qs + F::TILE;
    const float* lds = ld + s * 2 * FT;

    // S^T = K Q^T and dP^T = V dO^T; element (j, e): key row krow + 8 (e >>
    // 1), query q0 + 8j + 2t4 + (e & 1)
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    fence_acc(sacc);
    fence_acc(pacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < F::KS; ++ks) {  // k16 step ks: box ks / 4, 32 bytes a step in it
      const uint32_t o = (ks >> 2) * BOXB;
      wgmma_ss<64, 0, 0>(sacc, sw128_desc(kb + o) + 2 * (ks & 3),
                         sw128_desc(qs + o) + 2 * (ks & 3));
    }
#pragma unroll
    for (int ks = 0; ks < F::KS; ++ks) {
      const uint32_t o = (ks >> 2) * BOXB;
      wgmma_ss<64, 0, 0>(pacc, sw128_desc(vb + o) + 2 * (ks & 3),
                         sw128_desc(os + o) + 2 * (ks & 3));
    }
    wgmma_commit();

    // the keep mask of the tile while the products run: bit 4e of keep[j],
    // element e of n8 tile j. The 4 lanes of a key group (lane bits 2-3 =
    // u) draw the calls of their 4 elements, call e = (group + 2 (e >> 1),
    // query + (e & 1)), lane u call u; element e of lane u is word u of
    // call e. Each lane tests its call's 4 words, and two shuffles gather
    // the group's 4-bit results, call e at bits 4e..4e + 3
    uint32_t keep[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      keep[j] = 0x1111u;
      if (DROPOUT) {
        const uint4 w = rng.draw(static_cast<uint32_t>(q0 + 8 * j + 2 * t4 + (u & 1)));
        const uint32_t m = (w.x >= thr8 ? 1u : 0u) | (w.y >= thr8 ? 2u : 0u) |
                           (w.z >= thr8 ? 4u : 0u) | (w.w >= thr8 ? 8u : 0u);
        const uint32_t m2 =
            (m << (4 * (u & 1))) | (__shfl_xor_sync(FULL, m, 4) << (4 * ((u & 1) ^ 1)));
        const uint32_t m4 =
            (m2 << (8 * (u >> 1))) | (__shfl_xor_sync(FULL, m2, 8) << (8 * ((u >> 1) ^ 1)));
        keep[j] = m4 >> u;
      }
    }
    wgmma_wait<0>();  // S^T, dP^T, and the previous tile's dV, dK and dQ
    fence_acc(sacc);
    fence_acc(pacc);
    fence_acc(dva);
    fence_acc(dka);
    if (it > 0) retire(it - 1);

    // P^T and dS^T; then P_dropped^T and dS^T (hi, lo) as the bf16 A
    // fragments of k16 step kk = n8 tiles 2kk and 2kk + 1
    uint32_t lf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lds + 8 * j + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(lds + FT + 8 * j + 2 * t4);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys and keys past T get an explicit 0, not exp2 of a huge number
        const float pe = key_ok[e >> 1]
                             ? exp2_ftz(fmaf(sacc[4 * j + e], LOG2E, -((e & 1) ? l2.y : l2.x)))
                             : 0.f;
        const float scale = DROPOUT ? ((keep[j] >> (4 * e)) & 1u ? dr.inv_keep : 0.f) : 1.f;
        ds[e] = pe * (pacc[4 * j + e] * scale - ((e & 1) ? d2.y : d2.x));
        p[e] = pe * scale;  // P_dropped, the operand of dV
      }
      const int kk = j >> 1, x = 2 * (j & 1);
      pf[kk][x] = pack_bf16(p[0], p[1]);
      pf[kk][x + 1] = pack_bf16(p[2], p[3]);
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(ds[0], ds[1]);
      const __nv_bfloat162 h1 = __floats2bfloat162_rn(ds[2], ds[3]);
      hf[kk][x] = *reinterpret_cast<const uint32_t*>(&h0);
      hf[kk][x + 1] = *reinterpret_cast<const uint32_t*>(&h1);
      lf[kk][x] = pack_bf16(ds[0] - __low2float(h0), ds[1] - __high2float(h0));
      lf[kk][x + 1] = pack_bf16(ds[2] - __low2float(h1), ds[3] - __high2float(h1));
    }

    // dV += P_dropped^T dO, dK += bf16(dS)^T Q; B N-major: [query][D]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(dva, pf[kk], sw128_mn_desc(os + kk * 2048, BOXB));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(dka, hf[kk], sw128_mn_desc(qs + kk * 2048, BOXB));
    wgmma_commit();

    // dS^T hi and lo into this tile's buffer ([key][query], 16-byte chunk c
    // of row r at c ^ (r % 8): the 8 rows of a warp's store hit distinct
    // banks; the other buffer is the previous tile's, whose dQ product may
    // still run), then the warpgroup's rows are in place
    const uint32_t dsb = base + F::DS_OFF + (it & 1) * F::DS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 2 * kk + (x >> 1), r = krow + 8 * (x & 1);  // r % 8 == g
        const uint32_t off = r * ROWB + ((j ^ g) << 4) + 4 * t4;
        st_shared_u32(dsb + off, hf[kk][x]);
        st_shared_u32(dsb + FT * ROWB + off, lf[kk][x]);
      }
    fence_proxy_async();
    consumers_sync();
    dq_issue<D>(dqa, dsb, kb);
  }
  wgmma_wait<0>();
  fence_acc(dva);
  fence_acc(dka);
  if (n_qt > 0) retire(n_qt - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + krow + 8 * r;
    if (j >= T_len) continue;
    const long long o = ((static_cast<long long>(b) * T_len + j) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * n) =
          __floats2bfloat162_rn(dka[4 * n + 2 * r], dka[4 * n + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * n) =
          __floats2bfloat162_rn(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
    }
  }
}

// dq[e] = the n_kt slices of part summed in order, rounded to bf16; n a
// multiple of 4.
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum(const float* __restrict__ part, bf16* __restrict__ dq, long long n, int n_kt) {
  const long long n4 = n / 4, stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 acc = __ldcs(reinterpret_cast<const float4*>(part) + i);
    for (int c0 = 1; c0 < n_kt; c0 += 4) {  // four loads in flight, then the adds in order
      float4 x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < n_kt) x[c] = __ldcs(reinterpret_cast<const float4*>(part + (c0 + c) * n) + i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < n_kt) {
          acc.x += x[c].x;
          acc.y += x[c].y;
          acc.z += x[c].z;
          acc.w += x[c].w;
        }
    }
    reinterpret_cast<__nv_bfloat162*>(dq)[2 * i] = __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(dq)[2 * i + 1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

template <int D>
int launch_fused(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask,
                 const bf16* dout, const float* lse, const float* delta, float* dq_part, bf16* dk,
                 bf16* dv, int B, int T_len, int H, Strides st, Dropout dr,
                 cudaStream_t stream) {
  using F = Fused<D>;
  CUtensorMap qmap, kmap, vmap, omap;
  const long long so = static_cast<long long>(H) * D;
  int err = map_rows(&qmap, q, D, B, T_len, H, st.qb, st.qt, st.qh);
  if (err == 0) err = map_rows(&kmap, k, D, B, T_len, H, st.kb, st.kt, st.kh);
  if (err == 0) err = map_rows(&vmap, v, D, B, T_len, H, st.vb, st.vt, st.vh);
  if (err == 0) err = map_rows(&omap, dout, D, B, T_len, H, T_len * so, so, D);
  if (err != 0) return err;
  const bool drop = dr.thr > 0;
  auto kernel = drop ? flash_bwd_fused<D, true> : flash_bwd_fused<D, false>;
  static bool smem_set[2] = {false, false};
  // setmaxnreg's budget holds only at the launch count it was planned on
  if (!smem_set[drop] && (err = check_regs(kernel, F::LAUNCH_REGS)) != 0) return err;
  if ((err = allow_smem(kernel, F::SMEM, &smem_set[drop])) != 0) return err;
  dim3 grid;
  if ((err = tile_grid((T_len + FT - 1) / FT, B, H, &grid)) != 0) return err;
  kernel<<<grid, F::THREADS, F::SMEM, stream>>>(qmap, kmap, vmap, omap, mask, lse, delta,
                                                dq_part, dk, dv, T_len, H, B, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// ------------------------------------------------------------ dQ, fp32
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq, int T_len, int H,
             Strides st, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem[];  // fp32_smem<D>() bytes
  auto Ks = reinterpret_cast<float (*)[D]>(smem);
  auto Vs = reinterpret_cast<float (*)[D]>(smem + BKV * D * sizeof(float));
  auto valid = reinterpret_cast<float*>(smem + 2 * BKV * D * sizeof(float));
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

  int qt, bh;
  block_tile((T_len + BQ - 1) / BQ, qt, bh);
  const int b = bh / H, h = bh - b * H;
  const int i = qt * BQ + threadIdx.x;
  const bool row_ok = i < T_len;
  const long long row = static_cast<long long>(row_ok ? i : 0);

  float qr[D], dor[D], acc[D];
  {
    const float* qp = q + b * st.qb + row * st.qt + h * st.qh;
    const float* dp = dout + ((static_cast<long long>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? qp[d] : 0.f;
      dor[d] = row_ok ? dp[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  const long long lrow = static_cast<long long>(bh) * T_len + row;
  const float lse_i = row_ok ? lse[lrow] : 0.f;
  const float delta_i = row_ok ? delta[lrow] : 0.f;

  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  for (int k0 = 0; k0 < T_len; k0 += BKV) {
    __syncthreads();
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e - j * D, kt = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kt < T_len) {
        kv = kb[static_cast<long long>(kt) * st.kt + d];
        vv = vb[static_cast<long long>(kt) * st.vt + d];
      }
      Ks[j][d] = kv;
      Vs[j][d] = vv;
    }
    {
      const int kt = k0 + threadIdx.x;
      valid[threadIdx.x] =
          (kt < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + kt]))
              ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < BKV; c += 4) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) w = philox4x32(make_uint4((k0 + c) / 4, i, bh, 0u), dr.seed0, dr.seed1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = c + e;
        const float p = valid[j] != 0.f ? expf(dot<D>(qr, Ks[j]) - lse_i) : 0.f;
        float dpv = dot<D>(dor, Vs[j]);
        if (DROPOUT) dpv = (philox_word(w, e) >> 8) >= dr.thr ? dpv * dr.inv_keep : 0.f;
        const float ds = p * (dpv - delta_i);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
      }
    }
  }

  if (row_ok) {
    float* op = dq + ((static_cast<long long>(b) * T_len + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d];
  }
}

// ------------------------------------------------------ dK, dV, fp32
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BKV)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
              int T_len, int H, Strides st, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem[];  // fp32_smem<D>() bytes
  auto Qs = reinterpret_cast<float (*)[D]>(smem);
  auto dOs = reinterpret_cast<float (*)[D]>(smem + BQ * D * sizeof(float));
  float* lse_s = reinterpret_cast<float*>(smem + 2 * BQ * D * sizeof(float));
  float* delta_s = lse_s + BQ;
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

  int kt, bh;
  block_tile((T_len + BKV - 1) / BKV, kt, bh);
  const int b = bh / H, h = bh - b * H;
  const int j = kt * BKV + threadIdx.x;
  const bool col_in = j < T_len;
  const long long col = static_cast<long long>(col_in ? j : 0);
  const bool col_ok =
      col_in && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + j]);
  // lane4 = j & 3; group_lane0: the warp lane that owns key j & ~3
  const int lane4 = threadIdx.x & 3, group_lane0 = threadIdx.x & 28;

  float kr[D], vr[D], dka[D], dva[D];
  {
    const float* kp = k + b * st.kb + col * st.kt + h * st.kh;
    const float* vp = v + b * st.vb + col * st.vt + h * st.vh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = col_in ? kp[d] : 0.f;
      vr[d] = col_in ? vp[d] : 0.f;
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
  }

  const float* qb = q + b * st.qb + h * st.qh;
  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * D; e += BKV) {
      const int r = e / D, d = e - r * D, qt = q0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qt < T_len) {
        qv = qb[static_cast<long long>(qt) * st.qt + d];
        dv_ = dout[((static_cast<long long>(b) * T_len + qt) * H + h) * D + d];
      }
      Qs[r][d] = qv;
      dOs[r][d] = dv_;
    }
    {
      const int qt = q0 + threadIdx.x;  // BQ == BKV: one row's scalars per thread
      const long long lrow = static_cast<long long>(bh) * T_len + qt;
      lse_s[threadIdx.x] = qt < T_len ? lse[lrow] : 0.f;
      delta_s[threadIdx.x] = qt < T_len ? delta[lrow] : 0.f;
    }
    __syncthreads();

    const int rows = min(BQ, T_len - q0);  // the same for every thread of the block
#pragma unroll 1
    for (int r4 = 0; r4 < rows; r4 += 4) {
      // One Philox call gives the words of 4 keys (j >> 2) of one row. The
      // 4 lanes that own those keys (lane & 3 = j & 3) each draw the call
      // of one of the next 4 rows, then fetch their word of each row from
      // its lane: one call per 4 (i, j), as in the forward and the dQ body.
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT)
        w = philox4x32(make_uint4(j >> 2, q0 + r4 + lane4, bh, 0u), dr.seed0, dr.seed1);
#pragma unroll 1
      for (int m = 0; m < 4; ++m) {
        float scale = 1.f;
        if (DROPOUT) {
          const int src = group_lane0 + m;
          const uint4 wm = make_uint4(__shfl_sync(0xffffffffu, w.x, src),
                                      __shfl_sync(0xffffffffu, w.y, src),
                                      __shfl_sync(0xffffffffu, w.z, src),
                                      __shfl_sync(0xffffffffu, w.w, src));
          scale = (philox_word(wm, lane4) >> 8) >= dr.thr ? dr.inv_keep : 0.f;
        }
        const int r = r4 + m;
        if (r >= rows) break;
        // rows past T were staged as zeros and are skipped; masked key
        // columns get P = 0 and so zero dK, dV
        const float p = col_ok ? expf(dot<D>(Qs[r], kr) - lse_s[r]) : 0.f;
        const float dpv = dot<D>(dOs[r], vr) * scale;
        const float pv = p * scale;
        const float ds = p * (dpv - delta_s[r]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(pv, dOs[r][d], dva[d]);
          dka[d] = fmaf(ds, Qs[r][d], dka[d]);
        }
      }
    }
  }

  if (col_in) {
    const long long o = ((static_cast<long long>(b) * T_len + j) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[o + d] = dka[d];
      dv[o + d] = dva[d];
    }
  }
}


template <int D>
constexpr int fp32_smem() { return 2 * BQ * D * sizeof(float) + 2 * BQ * sizeof(float); }

template <int D>
int launch_dq_f32(const float* q, const float* k, const float* v, const uint8_t* mask,
                  const float* dout, const float* lse, const float* delta, float* dq, int B,
                  int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  auto kernel = dr.thr > 0 ? &flash_bwd_dq<D, true> : &flash_bwd_dq<D, false>;
  opt_in_smem(kernel, fp32_smem<D>(), opted[dr.thr > 0]);
  dim3 grid;
  if (const int err = tile_grid((T_len + BQ - 1) / BQ, B, H, &grid)) return err;
  kernel<<<grid, BQ, fp32_smem<D>(), stream>>>(q, k, v, mask, dout, lse, delta, dq, T_len, H,
                                               st, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const float* q, const float* k, const float* v, const uint8_t* mask,
                   const float* dout, const float* lse, const float* delta, float* dk, float* dv,
                   int B, int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  auto kernel = dr.thr > 0 ? &flash_bwd_dkv<D, true> : &flash_bwd_dkv<D, false>;
  opt_in_smem(kernel, fp32_smem<D>(), opted[dr.thr > 0]);
  dim3 grid;
  if (const int err = tile_grid((T_len + BKV - 1) / BKV, B, H, &grid)) return err;
  kernel<<<grid, BKV, fp32_smem<D>(), stream>>>(q, k, v, mask, dout, lse, delta, dk, dv, T_len,
                                                H, st, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared arguments: head_dim one of FA_HEAD_DIMS; q, k, v (B, T, H, D) with
// the given (b, t, h) element strides and unit stride along D; mask (B, T)
// bool, True = padding, or null; dout (B, T, H, D) contiguous in q's dtype;
// lse and delta (B, H, T) fp32; the outputs (B, T, H, D) contiguous;
// thr = floor(p * 2^24) (0: no dropout), inv_keep = 1/(1-p), seed_ptr the
// forward's two seed words in device memory (null without dropout). Each
// returns cudaGetLastError() after its launch, or a tensor-map error code
// (hopper.cuh TMA_ERROR).

// delta (B, H, T) fp32 = rowsum(dout * out), both (B, T, H, D) contiguous in
// dtype (0 = float32, 1 = bfloat16), D any.
extern "C" int flash_attention_bwd_prep(int dtype, const void* dout, const void* out,
                                        void* delta, int B, int T_len, int H, int D,
                                        void* stream) {
  const long long rows = static_cast<long long>(B) * T_len * H;
  const unsigned blocks = static_cast<unsigned>((rows + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t el = dtype == 1 ? 2 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(out);
  const bool vec = (D * el) % 16 == 0 && (ptrs & 15) == 0;
#define FA_PREP(TT)                                                                        \
  if (vec)                                                                                 \
    flash_bwd_prep<TT, true><<<blocks, 256, 0, st>>>(                                      \
        static_cast<const TT*>(dout), static_cast<const TT*>(out),                         \
        static_cast<float*>(delta), rows, T_len, H, D);                                    \
  else                                                                                     \
    flash_bwd_prep<TT, false><<<blocks, 256, 0, st>>>(                                     \
        static_cast<const TT*>(dout), static_cast<const TT*>(out),                         \
        static_cast<float*>(delta), rows, T_len, H, D)
  if (rows == 0) return 0;
  if (dtype == 1) FA_PREP(bf16);
  else if (dtype == 0) FA_PREP(float);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef FA_PREP
  return static_cast<int>(cudaGetLastError());
}

// The fused bf16 pass: dk, dv and dq_part (ceil(T / 64), B, T, H, D) fp32,
// the dQ partial of each key tile of 64 keys.
extern "C" int flash_attention_bwd_fused(int head_dim, const void* q, const void* k,
                                         const void* v, const void* mask, const void* dout,
                                         const void* lse, const void* delta, void* dq_part,
                                         void* dk, void* dv, int B, int T_len, int H,
                                         long long sqb, long long sqt, long long sqh,
                                         long long skb, long long skt, long long skh,
                                         long long svb, long long svt, long long svh,
                                         unsigned thr, float inv_keep, const void* seed_ptr,
                                         void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
#define FA_FUSED_CASE(DD)                                                                    \
  if (head_dim == DD)                                                                        \
    return launch_fused<DD>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),        \
                            static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),  \
                            static_cast<const bf16*>(dout), static_cast<const float*>(lse),  \
                            static_cast<const float*>(delta), static_cast<float*>(dq_part),  \
                            static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, T_len, H, st, \
                            dr, static_cast<cudaStream_t>(stream));
  FA_HEAD_DIMS(FA_FUSED_CASE)
#undef FA_FUSED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq (n elements, bf16) = the n_kt slices of part (n_kt, n) fp32 summed in
// order; n a multiple of 4.
extern "C" int flash_attention_bwd_dq_sum(const void* part, void* dq, long long n, int n_kt,
                                          void* stream) {
  const long long blocks = (n / 4 + 255) / 256;
  flash_bwd_dq_sum<<<static_cast<unsigned>(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192), 256,
                     0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(part),
                                                             static_cast<bf16*>(dq), n, n_kt);
  return static_cast<int>(cudaGetLastError());
}

// fp32 dQ (FMA body).
extern "C" int flash_attention_bwd_dq_f32(int head_dim, const void* q, const void* k,
                                          const void* v, const void* mask, const void* dout,
                                          const void* lse, const void* delta, void* dq, int B,
                                          int T_len, int H, long long sqb, long long sqt,
                                          long long sqh, long long skb, long long skt,
                                          long long skh, long long svb, long long svt,
                                          long long svh, unsigned thr, float inv_keep,
                                          const void* seed_ptr, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
#define FA_DQ_CASE(DD)                                                                          \
  if (head_dim == DD) {                                                                         \
    return launch_dq_f32<DD>(                                                                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                             \
        static_cast<const float*>(v), static_cast<const uint8_t*>(mask),                        \
        static_cast<const float*>(dout), static_cast<const float*>(lse),                        \
        static_cast<const float*>(delta), static_cast<float*>(dq), B, T_len, H, st, dr,         \
        static_cast<cudaStream_t>(stream));                                                     \
  }
  FA_HEAD_DIMS(FA_DQ_CASE)
#undef FA_DQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// fp32 dK, dV (FMA body).
extern "C" int flash_attention_bwd_dkv_f32(int head_dim, const void* q, const void* k,
                                           const void* v, const void* mask, const void* dout,
                                           const void* lse, const void* delta, void* dk,
                                           void* dv, int B, int T_len, int H, long long sqb,
                                           long long sqt, long long sqh, long long skb,
                                           long long skt, long long skh, long long svb,
                                           long long svt, long long svh, unsigned thr,
                                           float inv_keep, const void* seed_ptr, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
#define FA_DKV_CASE(DD)                                                                          \
  if (head_dim == DD) {                                                                          \
    return launch_dkv_f32<DD>(                                                                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                              \
        static_cast<const float*>(v), static_cast<const uint8_t*>(mask),                         \
        static_cast<const float*>(dout), static_cast<const float*>(lse),                         \
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), B,   \
        T_len, H, st, dr, static_cast<cudaStream_t>(stream));                                    \
  }
  FA_HEAD_DIMS(FA_DKV_CASE)
#undef FA_DKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
