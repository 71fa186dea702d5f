// The encoder's positional conv: a grouped, stride-1 conv1d over (B, T, C),
// forward and input gradient.
//
// Replaces: fithubert_tpu/ops/pallas/ has no kernel for it. The JAX package
//   computes the conv with jax.lax.conv_general_dilated
//   (fithubert_tpu/ops/conv.py:338-373, run by PositionalConv at :384),
//   which XLA lowers for the TPU itself. Added because on the card the port
//   ran it as cuDNN's grouped conv: ~24 ms of wall a served call of 32 x 849
//   frames at 768 wide, 16 groups, k = 128 (legacy kernels without the
//   tensor cores, run side by side), and ~0.6 ms for each conv of a (8,
//   599, 768) train step (Ampere's mma.sync fprop), about 90x and 13x its
//   bound.
//
// What it computes, for each group g of cg = C / groups channels:
//   y[b, t, o] = bias[o] + sum_{j < k, i < cg} w[o, i, j] * x[b, t + j - pad, g * cg + i]
// for t < T (the output is as long as the input), frames outside [0, T)
// reading as zero. The forward runs it with pad = k / 2 (SamePad's trailing
// frame is never computed); the input gradient is the same conv of the
// cotangent with each group's kernel transposed and flipped in time, pad =
// k - 1 - k / 2 (the cotangent of SamePad's dropped frame is the zero past
// T). The sum is fp32 over all k * cg products in one fixed order, with no
// split-K: a call gives the same bits on every run. bf16: the fp32 bias is
// added and the result rounded once, as F.conv1d(x, w, b) does in bf16.
//
// Bound on the H100: 2 * B * T * C * cg * k FLOPs against a few MB of
// activations and weights, so operations: at serving's (32, 849, 768), cg =
// 48, k = 128, 256 GFLOP, 0.26 ms at 989 TFLOP/s; at the fithubert teacher's
// (12, 599, 768) 0.069 ms. Each group is a GEMM with K = k * cg (6,144)
// whose A operand is a sliding window of x: no im2col copy is needed, since
// tap j's A rows are the window's rows shifted by j.
//
// Design: in bf16 (every main path) one block per (256 frames, group, batch
// row), one producer warp and two consumer warpgroups.
//   - The window: (256 + k - 1) frames x (cgp + 8) channels, cgp the group
//     width rounded up to 16, in 128-row TMA loads of a 3-D tensor map over
//     (C, T, B) without swizzle. TMA's zero fill past the tensor's edges is
//     the conv's zero padding at both ends of each row (and the channels past
//     C of the last group). The 8 extra channels make a row's pitch an odd
//     number of 16-byte units, so the 8 rows an ldmatrix phase reads lie in 8
//     different bank groups at any shift. A window starts on a 16-byte
//     boundary: where cg is not a multiple of 8 (FitHuBERT's 480 / 16 = 30)
//     the wrapper pads x's groups to cgp first (a box starting mid-vector
//     faulted on the card).
//   - The weights: the wrapper lays them out once a call as (groups, k, cgp,
//     cgp), each tap's (output, input) slab in wgmma's K-major core-matrix
//     order without swizzle (8 x 8 cores, 128 bytes each, input-channel cores
//     adjacent), zero-padded from cg to cgp. They stream through a ring of
//     four stages of `tps` taps by bulk copies; a group's weights are shared
//     by all of its blocks from the L2.
//   - The products: for tap j the A operand is the window shifted by j rows,
//     which breaks the 8-row core matrices of a shared-memory descriptor, so
//     A is loaded to registers by ldmatrix (wgmma's RS form) and B, the tap's
//     slab, read from shared memory: m64 n(cgp) k16, cgp / 16 times a tap for
//     each 64-frame subtile. A warpgroup owns two subtiles, 128 frames
//     apart; a block whose second 128 frames lie wholly past T runs the
//     first 128 alone, a branch uniform over the block (a per-warpgroup skip made ptxas
//     serialize the products). The next tap's fragments load while the
//     current tap's products run; a stage goes back to the producer when the
//     products of its last tap are done. Two or four taps a commit group ran
//     slower (spills, products serialized again).
//   - Widths past cg: the stray channels of the next group that the window
//     holds meet zero weights and add nothing; output channels past cg are
//     not stored.
// 256 frames a block halve the weights each block streams from the L2 per
// frame against 128 and ran 6-17% faster on the card at every cell's shape.
//
// On the card (H100 80GB HBM3, 700 W): 0.63 ms at serving's (32, 849, 768),
// 41% of its bound, against cuDNN's 23.7 ms; 0.23 ms (29%) at (12, 599, 768).
//
// fp32 (the smoke configs and the card-vs-CPU checks): a direct FMA loop,
// one output channel and four frames a thread, in the same fixed order.

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int WIN_BOX = 128;  // window rows a TMA load brings
constexpr int MT = 2;         // 128-frame tiles a block
constexpr int STAGES = 4;
constexpr int MAX_TPS = 16;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);
constexpr int SMEM_DYN = 227 * 1024 - 1024;  // dynamic shared memory, beside the barriers

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes, the next along K `lbo` bytes on,
// the next 8 rows `sbo` bytes on.
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The consumers' taps over NM of a warpgroup's MT subtiles (the first NM):
// tap j's products from `cur`, then, once tap j - 1's are done, tap j + 1's
// fragments into `nxt` (tap j - 1's). Every branch around the products is
// uniform over the block, so ptxas keeps them asynchronous.
template <int CG, int NM>
__device__ __forceinline__ void taps(float (&acc)[MT][CG / 2], const uint32_t (&abase)[MT],
                                     uint32_t ring, int stage_bytes, uint64_t* full,
                                     uint64_t* empty, uint64_t* win_full, int k, int tps,
                                     int lane) {
  constexpr int KC = CG / 16, PITCH = (CG + 8) * 2, TAP_BYTES = CG * CG * 2;
  uint32_t fa[NM * KC][4], fb[NM * KC][4];
  auto load = [&](uint32_t (&f)[NM * KC][4], int j) {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(f[m * KC + kc], abase[m] + j * PITCH + kc * 32);
  };
  int c = 0, jj = 0;  // the chunk of the current tap, and the tap within it
  auto step = [&](int j, uint32_t (&cur)[NM * KC][4], uint32_t (&nxt)[NM * KC][4]) {
    const int s = c % STAGES;
    if (jj == 0) mbar_wait(smem_u32(&full[s]), (c / STAGES) & 1);
    const uint32_t bsm = ring + s * stage_bytes + jj * TAP_BYTES;
#pragma unroll
    for (int m = 0; m < NM; ++m) fence_acc(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        wgmma_rs<CG, 0>(acc[m], cur[m * KC + kc], plain_desc(bsm + kc * 256, 128, CG * 16));
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int m = 0; m < NM; ++m) fence_acc(acc[m]);
    fence_regs(nxt);
    if (jj == 0 && c > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(c - 1) % STAGES]));
    if (j + 1 < k) load(nxt, j + 1);
    if (++jj == tps) {
      jj = 0;
      ++c;
    }
  };

  mbar_wait(smem_u32(win_full), 0);
  load(fa, 0);
  for (int j = 0; j < k; j += 2) {
    step(j, fa, fb);
    if (j + 1 < k) step(j + 1, fb, fa);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) fence_acc(acc[m]);
  fence_regs(fa);
  fence_regs(fb);
}

// x is read with its own channel count Cx and group stride xg (the wrapper
// pads a group width that is not a multiple of 8 to cgp, so that every
// window starts on a 16-byte boundary); y is (B, T, C), cg channels a group.
template <int CG>
__global__ void __launch_bounds__(THREADS, 1)
pos_conv_wgmma(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ wpk,
               const float* __restrict__ bias, bf16* __restrict__ y, int T, int C, int cg, int xg,
               int k, int pad, int tps, int n_loads) {
  constexpr int PITCH = (CG + 8) * 2;       // bytes a window row
  constexpr int TAP_BYTES = CG * CG * 2;    // one tap's weight slab
  constexpr int NACC = CG / 2;              // accumulators a thread a subtile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], win_full;
  const uint32_t win = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = win + n_loads * WIN_BOX * PITCH;
  const int stage_bytes = tps * TAP_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * 128 * MT, g = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (k + tps - 1) / tps;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);                // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    mbar_init(smem_u32(&win_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: the window once, then the weight ring
    if (lane == 0) {
      const uint32_t wb = smem_u32(&win_full);
      mbar_expect_tx(wb, n_loads * WIN_BOX * PITCH);
      for (int l = 0; l < n_loads; ++l)
        tma_load_3d(win + l * WIN_BOX * PITCH, &xmap, wb, g * xg, t0 - pad + l * WIN_BOX, b);
      const char* src = reinterpret_cast<const char*>(wpk) + static_cast<long long>(g) * k * TAP_BYTES;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(smem_u32(&empty[s]), ((c / STAGES) - 1) & 1);
        const int n = min(tps, k - c * tps);
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, n * TAP_BYTES);
        bulk_load(ring + s * stage_bytes, src + static_cast<long long>(c) * tps * TAP_BYTES,
                  n * TAP_BYTES, fb);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns the 64-frame subtiles wg + 2m, m < MT;
  // where the block's second 128 frames lie past T, the first alone
  const int wg = warp >> 2, wq = warp & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  uint32_t abase[MT];  // this lane's ldmatrix address at tap 0, k16 step 0
  float acc[MT][NACC];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    abase[m] = win + ((wg + 2 * m) * 64 + wq * 16 + lrow) * PITCH + lcol * 2;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[m][i] = 0.f;
  }
  if (t0 + 128 >= T)
    taps<CG, 1>(acc, abase, ring, stage_bytes, full, empty, &win_full, k, tps, lane);
  else
    taps<CG, MT>(acc, abase, ring, stage_bytes, full, empty, &win_full, k, tps, lane);

  // the epilogue: bias, one rounding, channels past cg and frames past T not stored
  const long long ybase = static_cast<long long>(b) * T * C + static_cast<long long>(g) * cg;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nb = 0; nb < CG / 8; ++nb) {
      const int col = nb * 8 + 2 * (lane & 3);
      if (col >= cg) continue;
      const float b0 = bias != nullptr ? bias[g * cg + col] : 0.f;
      const float b1 = bias != nullptr && col + 1 < cg ? bias[g * cg + col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + (wg + 2 * m) * 64 + wq * 16 + (lane >> 2) + 8 * half;
        if (t >= T) continue;
        bf16* out = y + ybase + static_cast<long long>(t) * C + col;
        const float v0 = acc[m][4 * nb + 2 * half] + b0, v1 = acc[m][4 * nb + 2 * half + 1] + b1;
        if ((cg & 1) == 0) {  // an even pair at an even element: one 4-byte store
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16(v0);
          if (col + 1 < cg) out[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

template <int CG>
int launch_wgmma(const bf16* x, const bf16* wpk, const float* bias, bf16* y, int B, int T, int C,
                 int cg, int Cx, int xg, int k, int pad, cudaStream_t stream) {
  constexpr int PITCH = (CG + 8) * 2, TAP_BYTES = CG * CG * 2;
  CUtensorMap xmap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cx), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Cx) * 2,
                                 static_cast<cuuint64_t>(Cx) * T * 2};
  const cuuint32_t box[3] = {CG + 8, WIN_BOX, 1};
  int err = encode_map(&xmap, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const int n_loads = (128 * MT + k - 1 + WIN_BOX - 1) / WIN_BOX;
  const int win_bytes = n_loads * WIN_BOX * PITCH;
  const int room = (SMEM_DYN - 1024 - win_bytes) / (STAGES * TAP_BYTES);
  const int tps = room < MAX_TPS ? room : MAX_TPS;
  if (tps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + win_bytes + STAGES * tps * TAP_BYTES;
  static bool smem_set = false;  // above 48 KB only after opting in, once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pos_conv_wgmma<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((T + 128 * MT - 1) / (128 * MT), C / cg, B);
  pos_conv_wgmma<CG><<<grid, THREADS, smem, stream>>>(xmap, wpk, bias, y, T, C, cg, xg, k, pad,
                                                       tps, n_loads);
  return static_cast<int>(cudaGetLastError());
}

constexpr int F_FRAMES = 4, F_CH = 64;  // frames a thread, channels a block

// The fp32 body: w is (k, cg, C), output channel fastest.
__global__ void __launch_bounds__(256)
pos_conv_f32(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y, int T, int C, int cg, int k,
             int pad) {
  const int o = blockIdx.y * F_CH + (threadIdx.x % F_CH);
  const int t0 = (blockIdx.x * (256 / F_CH) + threadIdx.x / F_CH) * F_FRAMES;
  const int b = blockIdx.z;
  if (o >= C) return;
  const float* xb = x + static_cast<long long>(b) * T * C + (o / cg) * cg;
  float acc[F_FRAMES] = {};
  for (int j = 0; j < k; ++j) {
    for (int i = 0; i < cg; ++i) {
      const float wv = w[(static_cast<long long>(j) * cg + i) * C + o];
#pragma unroll
      for (int q = 0; q < F_FRAMES; ++q) {
        const int t = t0 + q + j - pad;
        const float xv = t >= 0 && t < T ? xb[static_cast<long long>(t) * C + i] : 0.f;
        acc[q] = fmaf(wv, xv, acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < F_FRAMES; ++q) {
    const int t = t0 + q;
    if (t < T) y[(static_cast<long long>(b) * T + t) * C + o] = acc[q] + (bias ? bias[o] : 0.f);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. y (B, T, C) contiguous in dtype, cg
// channels a group; bias (C,) fp32 or null. bf16: x (B, T, Cx) contiguous
// and 16-byte aligned, group g's channels from g * xg on, xg a multiple of 8
// (cg, or cgp where the wrapper padded x's groups); w the packed (groups,
// k, cgp, cgp) core-matrix layout (pos_conv.py pack_weights), cgp in {16,
// 32, 48, 64}. fp32: x (B, T, C) contiguous (Cx = C, xg = cg), w (k, cg,
// C); cgp unread. Returns
// cudaGetLastError() after the launch, or a tensor-map error code
// (hopper.cuh TMA_ERROR).
extern "C" int pos_conv(int dtype, const void* x, const void* w, const float* bias, void* y, int B,
                        int T, int C, int cg, int Cx, int xg, int cgp, int k, int pad,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || cg < 1 || C % cg != 0 || k < 1 || B > 65535 || C / cg > 65535 ||
      Cx != C / cg * xg || xg < cg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* yb = static_cast<bf16*>(y);
    if (cg > cgp || xg % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (cgp) {
      case 16: return launch_wgmma<16>(xb, wb, bias, yb, B, T, C, cg, Cx, xg, k, pad, st);
      case 32: return launch_wgmma<32>(xb, wb, bias, yb, B, T, C, cg, Cx, xg, k, pad, st);
      case 48: return launch_wgmma<48>(xb, wb, bias, yb, B, T, C, cg, Cx, xg, k, pad, st);
      case 64: return launch_wgmma<64>(xb, wb, bias, yb, B, T, C, cg, Cx, xg, k, pad, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 0 || Cx != C) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + (256 / F_CH) * F_FRAMES - 1) / ((256 / F_CH) * F_FRAMES),
                  (C + F_CH - 1) / F_CH, B);
  pos_conv_f32<<<grid, 256, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                     bias, static_cast<float*>(y), T, C, cg, k, pad);
  return static_cast<int>(cudaGetLastError());
}
