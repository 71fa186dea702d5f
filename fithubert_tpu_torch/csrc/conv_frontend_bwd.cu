// Backward of conv blocks 1..N of the waveform front-end: from a0 (the
// stack's input), the weights and g (the cotangent of the stack's output),
// da0 and every dW, all fp32.
//
// Replaces: fithubert_tpu/ops/pallas/conv_frontend_bwd.py, the Pallas kernel
//   _make_bwd_kernel (:155) run by pallas_stack_bwd (:244-344), the
//   backward of fused_conv_stack and fused_conv_stack_gn
//   (conv_frontend.py:345-352, :426-443) under FITHUBERT_CONV_BWD=pallas;
//   on the card the port runs it by default (ops/kernels/conv_frontend.py
//   conv_backward_kind).
//
// Bound on the H100: operations for the whole backward (the student's stack
//   at 12 x 12 s: ~690 GFLOP, 0.70 ms at the bf16 tensor-core peak), but
//   as launches over the whole (B, T) that write their intermediates back
//   (~4.5 GB through HBM at that shape, ~1.36 ms summed over the launches'
//   max(operations, bytes)), the first layers are bound by bytes: every pass
//   of layers 0-1 moves 0.1-0.25 GB at ~0.1 GFLOP per MB.
//
// Design: for layer i = (d, k, s) with input a_i, the TPU kernel walks a
//   sequential grid of frame tiles, recomputes each tile's layers in VMEM,
//   carries dW across grid steps and overlap-adds the tiles' dx windows. CUDA
//   blocks run in no order, so each pass here is a whole-(B, T) launch:
//   - up pass, one launch per layer: K1's GEMM (conv_gemm.cuh; in bf16 the
//     wgmma + TMA kernel, on K1's tile geometry) on a_i writes z_i (the
//     pre-GELU sum, rounded to the dtype) and a_{i+1} = gelu(z_i), the very
//     values K1's forward produced. The last layer's epilogue writes dz =
//     g * gelu'(z) in their place, rounded to the dtype (gelu' is the
//     exact-erf derivative in fp32 and the tanh form's in bf16,
//     conv_frontend_bwd.py:68-93; g fp32): nothing reads that layer's z or
//     a, and dz needs no launch of its own;
//   - dW_i = tap(a_i)^T dz_i, a reduction over all B * T_{i+1} frames, split
//     into a fixed number of chunks (a function of the shapes alone): one
//     block per (chunk, tile of (k * C_in, C_out)) writes fp32 partials,
//     and a second launch sums the chunks in order. Deterministic, no
//     atomics;
//   - da_i, a gather-GEMM: with k <= 2s, input row r = f * s + j receives
//     from output frame f through tap j and, when j + s < k, from frame
//     f - 1 through tap j + s. Within a phase j the taps are fixed, so each
//     output row is one GEMM row of K = (1 or 2) * C_out, written by one
//     thread: no overlap-add. Its epilogue multiplies by gelu'(z_{i-1}) and
//     writes dz_{i-1} in the dtype, so the fp32 g between layers never goes
//     to memory; for layer 0 it writes da0 in fp32.
//   Per stack: L up launches, L dW, L reductions, L da: 4L.
//
// bf16 (every main path): dW and da are Hopper GEMMs on K1's roles.
//   - dW (conv_dw_wgmma): a block per (chunk, 128 x 256 tile of (K, C_out)),
//     one producer thread and two consumer warpgroups (64 rows each). The
//     frame axis is the reduction axis, so both operands arrive
//     frame-major: A^T as K1's own A operand (the two tap-group views of
//     a_i, 3-D maps (cols, T_out, B), so no box crosses a batch row) and dz
//     through a map of its own, each a [64 frames][64 columns] box under
//     the 128-byte swizzle. wgmma reads both M- / N-major from shared memory
//     (the descriptor's transpose bits), so no operand is transposed by
//     hand. Four 48 KB stages (64 frames) ring on mbarriers; each chunk is
//     a run of (batch row, 64-frame tile) steps, and the chunks are sized so
//     that one wave of blocks fills the card. The partials leave the
//     accumulators directly as fp32 (one store per chunk and tile).
//   - da (conv_da_wgmma): K1's persistent grid and three roles on 128 x 128
//     tiles of (rows of phase j, C_in). A is dz rows [frame f | frame f - 1]
//     through one 3-D map (row -1 comes back as zeros from TMA), B is W[j]
//     with C_out contiguous: both K-major, as in K1. The consumers hand
//     their fp32 sums over in a 34 KB buffer per warpgroup (rows padded to
//     136 floats: conflict-free), and eleven epilogue warps read z_{i-1},
//     apply gelu' (two special-function operations) and write dz_{i-1} or
//     da0 while the consumers run the next tile's products. The epilogue
//     bounds da (on an H100, layer 1's da took 0.19 of its 0.38 ms in the
//     epilogue alone): each thread loads z_{i-1} half a tile ahead, six
//     rows at once (one row at a time, the loads' latency made da of the
//     stride-2 layers 3.8x its floor); its rows lie a fixed stride apart,
//     so one index per half tile places them all (the epilogue is bound
//     by its instruction count: an index per row made da slower); and
//     gelu' takes nine fp32 and two special-function operations.
// fp32 (only the card-vs-CPU checks): FMA bodies with cp.async staging.

#include "conv_gemm.cuh"

namespace {

// ------------------------------------------------------------------ dW, bf16
constexpr int DW_BM = 128;  // tile rows: positions of K = k * C_in
constexpr int DW_BN = 256;  // tile columns: C_out
constexpr int DW_BK = 64;   // frames per stage
constexpr int DW_STAGES = 4;
constexpr int BOX = 64 * 64 * 2;  // one [64 frames][64 columns] bf16 box, 8 KB
constexpr int DW_A_BYTES = 2 * BOX, DW_STAGE_BYTES = DW_A_BYTES + 4 * BOX;  // 16 + 32 KB
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 1024;  // + room to align the ring
constexpr int DW_THREADS = 32 * (CONSUMER_WARPS + 1);

// Block x = chunk * tiles + tile sums the frames of steps [chunk *
// chunk_steps, ...) of part[chunk, kk, n] = sum_m A[m, kk] dz[m, n] for its
// 128 x 256 tile, where step st is batch row st / frame_tiles, frames
// 64 (st % frame_tiles) ..+63 (past T_out TMA reads zeros). amap0 / amap1
// are the tap groups of A (K columns [0, cols0) and [cols0, K)), dzmap is
// dz (C_out, T_out, B); all take [64 frames][64 columns] boxes.
__global__ void __launch_bounds__(DW_THREADS, 1)
conv_dw_wgmma(const __grid_constant__ CUtensorMap amap0, const __grid_constant__ CUtensorMap amap1,
              const __grid_constant__ CUtensorMap dzmap, float* __restrict__ part, int K, int N,
              int cols0, int frame_tiles, int steps, int chunk_steps, int n_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DW_STAGES], empty[DW_STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
  const int kk0 = (tile / n_tiles) * DW_BM, n0 = (tile % n_tiles) * DW_BN;
  const int st0 = chunk * chunk_steps, st1 = min(st0 + chunk_steps, steps);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);                // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int st = st0, it = 0; st < st1; ++st, ++it) {
        const int s = it % DW_STAGES;
        if (it >= DW_STAGES) mbar_wait(smem_u32(&empty[s]), ((it / DW_STAGES) - 1) & 1);
        const uint32_t fb = smem_u32(&full[s]), sa = ring + s * DW_STAGE_BYTES;
        mbar_expect_tx(fb, DW_STAGE_BYTES);
        const int b = st / frame_tiles, f0 = (st % frame_tiles) * DW_BK;
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // a 64-column box lies in one tap group
          const int kk = kk0 + 64 * q;
          if (kk < cols0)
            tma_load_3d(sa + q * BOX, &amap0, fb, kk, f0, b);
          else
            tma_load_3d(sa + q * BOX, &amap1, fb, kk - cols0, f0, b);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load_3d(sa + DW_A_BYTES + q * BOX, &dzmap, fb, n0 + 64 * q, f0, b);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows kk0 + 64 wg .. + 63, in two
  // 64 x 128 accumulators (columns n0 .. + 127 and n0 + 128 .. + 255)
  const int wg = warp >> 2;
  float d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0.f;
  for (int st = st0, it = 0; st < st1; ++st, ++it) {
    const int s = it % DW_STAGES;
    mbar_wait(smem_u32(&full[s]), (it / DW_STAGES) & 1);
    const uint32_t sa = ring + s * DW_STAGE_BYTES;
    // [frame][64 columns] boxes, the next 64 columns BOX bytes on
    const uint64_t da = sw128_mn_desc(sa + wg * BOX, BOX);
    const uint64_t db0 = sw128_mn_desc(sa + DW_A_BYTES, BOX);
    const uint64_t db1 = sw128_mn_desc(sa + DW_A_BYTES + 2 * BOX, BOX);
    fence_acc(d0);
    fence_acc(d1);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < DW_BK / 16; ++k16) {
      wgmma_m64n128k16<1, 1>(d0, da + 128 * k16, db0 + 128 * k16);
      wgmma_m64n128k16<1, 1>(d1, da + 128 * k16, db1 + 128 * k16);
    }
    wgmma_commit();
    if (it > 0) {  // the products of the previous stage are done: free it
      wgmma_wait<1>();
      fence_acc(d0);
      fence_acc(d1);
      if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % DW_STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(d0);
  fence_acc(d1);

  float* out = part + static_cast<long long>(chunk) * K * N;
  const int row = kk0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = row + 8 * half;
      if (kk >= K) continue;
      float* o = out + static_cast<long long>(kk) * N + col;
      if (col < N) *reinterpret_cast<float2*>(o) = make_float2(d0[4 * j + 2 * half], d0[4 * j + 2 * half + 1]);
      if (col + 128 < N)
        *reinterpret_cast<float2*>(o + 128) = make_float2(d1[4 * j + 2 * half], d1[4 * j + 2 * half + 1]);
    }
  }
}

// ------------------------------------------------------------------ da, bf16
constexpr int DA_STAGES = 4;
// the epilogue bounds da: eleven warps for it (eight left da of the stride-2
// layers ~2.1x its floor on an H100). 20 warps in all are five per SM
// sub-partition, which leaves 96 registers a thread; a sixth would leave 80,
// fewer than wgmma's accumulators need.
constexpr int DA_EPI_WARPS = 11;
constexpr int DA_THREADS = 32 * (CONSUMER_WARPS + 1 + DA_EPI_WARPS);
constexpr int HB_LD = WBN + 8;        // fp32 hand-off rows of 544 bytes: conflict-free float2 stores
constexpr int HBUF = 64 * HB_LD * 4;  // a consumer warpgroup's 64 x 128 fp32 sums
constexpr int DA_SMEM = DA_STAGES * STAGE_BYTES + 2 * HBUF + 1024;

// A persistent grid as K1's: tile t = (((b * f_tiles + f-tile) * s + phase j)
// * n_tiles + n-tile) covers rows r = f * s + j, f in 128 frames, of batch
// row b and 128 channels of C_in; channel tiles fastest, then the phases, so
// the blocks in flight share dz tiles in the L2. K chunk kc < C_out / 64 is
// tap j on dz frame f, the rest tap j + s on frame f - 1. dzmap is dz
// (C_out, T_out, B), box (64, 128, 1); wmap is w (k, C_in, C_out) as
// (C_out, k * C_in), box (64, 128). With z_prev: dz_prev = sum * gelu'(z_prev)
// in bf16, else da = sum in fp32, both (B, T_in, C_in).
__global__ void __launch_bounds__(DA_THREADS, 1)
conv_da_wgmma(const __grid_constant__ CUtensorMap dzmap, const __grid_constant__ CUtensorMap wmap,
              const bf16* __restrict__ z_prev, bf16* __restrict__ dz_prev, float* __restrict__ da,
              int T_in, int C_in, int C_out, int k, int s, int n_tiles, int f_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DA_STAGES], empty[DA_STAGES], hfull[2], hempty[2];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const hand = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)) +
                                               DA_STAGES * STAGE_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int CC = C_out / WBK;  // K chunks of one tap
  // tile t -> (b, phase j, first frame f0, first channel n0), and its K chunks
  auto decode = [&](int t, int& b, int& j, int& f0, int& n0) {
    n0 = (t % n_tiles) * WBN;
    t /= n_tiles;
    j = t % s;
    t /= s;
    f0 = (t % f_tiles) * WBM;
    b = t / f_tiles;
    return ((j < k) + (j + s < k)) * CC;  // 0 when no tap reaches phase j (k < s)
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < DA_STAGES; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), CONSUMER_WARPS);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(smem_u32(&hfull[w]), 128);  // one arrival per thread of warpgroup w
      mbar_init(smem_u32(&hempty[w]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, j, f0, n0;
        const int KC = decode(tile, b, j, f0, n0);
        for (int kc = 0; kc < KC; ++kc, ++it) {
          const int st = it % DA_STAGES;
          if (it >= DA_STAGES) mbar_wait(smem_u32(&empty[st]), ((it / DA_STAGES) - 1) & 1);
          const uint32_t fb = smem_u32(&full[st]), sa = ring + st * STAGE_BYTES;
          mbar_expect_tx(fb, STAGE_BYTES);
          const int seg = kc / CC, kk = (kc - seg * CC) * WBK;
          tma_load_3d(sa, &dzmap, fb, kk, f0 - seg, b);  // frame -1 comes back as zeros
          tma_load_2d(sa + A_BYTES, &wmap, fb, kk, (j + seg * s) * C_in + n0);
        }
      }
    }
    return;
  }

  if (warp > CONSUMER_WARPS) {
    // the epilogue warps: for each tile and warpgroup, the sums times
    // gelu'(z_prev) in bf16, or as they are in fp32. Thread et takes
    // channels n0 + c .. + 3 of rows r0, r0 + 11, ... of each warpgroup's
    // 64; rows past T_in and channels past C_in are not written. The loads
    // of z_prev for the next warpgroup's rows go out before this one's are
    // processed, so their latency hides under the work.
    const int et = threadIdx.x - 32 * (CONSUMER_WARPS + 1);
    const int c = 4 * (et & 31), r0 = et >> 5;
    constexpr int ROWS = (64 + DA_EPI_WARPS - 1) / DA_EPI_WARPS;  // rows per thread and warpgroup
    const int rs = DA_EPI_WARPS * s;                          // frames between a thread's rows
    const long long step = static_cast<long long>(rs) * C_in;  // elements between them
    // the first row this thread writes of warpgroup w's 64 in tile: its row
    // of T_in (T_in when none: channels past C_in) and its element index
    auto first = [&](int tile, int w, int& row, long long& idx) {
      int b, j, f0, n0;
      decode(tile, b, j, f0, n0);
      row = n0 + c < C_in ? (f0 + 64 * w + r0) * s + j : T_in;
      idx = (static_cast<long long>(b) * T_in + row) * C_in + n0 + c;
    };
    auto valid = [&](int row, int q) {  // row q lies in the tile's 64 and before T_in
      return (q < ROWS - 1 || r0 + DA_EPI_WARPS * q < 64) && row + q * rs < T_in;
    };
    auto prefetch = [&](uint2 (&zr)[ROWS], int tile, int w) {
      if (z_prev == nullptr || tile >= tiles) return;
      int row;
      long long idx;
      first(tile, w, row, idx);
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        if (valid(row, q)) zr[q] = __ldg(reinterpret_cast<const uint2*>(z_prev + idx + q * step));
    };
    uint2 zr[2][ROWS];  // z_prev of warpgroup 0's rows and of warpgroup 1's
    prefetch(zr[0], blockIdx.x, 0);
    int ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 0)
          prefetch(zr[1], tile, 1);
        else
          prefetch(zr[0], tile + gridDim.x, 0);
        int row;
        long long idx;
        first(tile, w, row, idx);
        const float* hb = hand + w * (HBUF / 4);
        mbar_wait(smem_u32(&hfull[w]), ti & 1);
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          if (!valid(row, q)) continue;
          const float4 v =
              *reinterpret_cast<const float4*>(hb + (r0 + DA_EPI_WARPS * q) * HB_LD + c);
          if (z_prev != nullptr) {
            const __nv_bfloat162* zp = reinterpret_cast<const __nv_bfloat162*>(&zr[w][q]);
            uint2 o;
            __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
            op[0] = __floats2bfloat162_rn(v.x * gelu_grad_tanh(__low2float(zp[0])),
                                          v.y * gelu_grad_tanh(__high2float(zp[0])));
            op[1] = __floats2bfloat162_rn(v.z * gelu_grad_tanh(__low2float(zp[1])),
                                          v.w * gelu_grad_tanh(__high2float(zp[1])));
            *reinterpret_cast<uint2*>(dz_prev + idx + q * step) = o;
          } else {
            *reinterpret_cast<float4*>(da + idx + q * step) = v;
          }
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * DA_EPI_WARPS) : "memory");  // all read it
        if (et == 0) mbar_arrive(smem_u32(&hempty[w]));
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns frames f0 + 64 wg .. + 63 of each tile
  const int wg = warp >> 2;
  float* const hb = hand + wg * (HBUF / 4);
  int it = 0, ti = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    int b, j, f0, n0;
    const int KC = decode(tile, b, j, f0, n0);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kc = 0; kc < KC; ++kc, ++it) {
      const int st = it % DA_STAGES;
      mbar_wait(smem_u32(&full[st]), (it / DA_STAGES) & 1);
      const uint32_t sa = ring + st * STAGE_BYTES;
      const uint64_t da_ = sw128_desc(sa + wg * (64 * WBK * 2)), db = sw128_desc(sa + A_BYTES);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < WBK / 16; ++k16) wgmma_m64n128k16(d, da_ + 2 * k16, db + 2 * k16);
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % DA_STAGES]));
      }
    }
    wgmma_wait<0>();  // outside any branch: ptxas then keeps the products asynchronous
    fence_acc(d);
    if (KC > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % DA_STAGES]));
    if (ti > 0) mbar_wait(smem_u32(&hempty[wg]), (ti - 1) & 1);
    const int r = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int q = 0; q < WBN / 8; ++q) {
      const int c = 8 * q + 2 * (lane & 3);
      *reinterpret_cast<float2*>(hb + r * HB_LD + c) = make_float2(d[4 * q], d[4 * q + 1]);
      *reinterpret_cast<float2*>(hb + (r + 8) * HB_LD + c) = make_float2(d[4 * q + 2], d[4 * q + 3]);
    }
    mbar_arrive(smem_u32(&hfull[wg]));
  }
}

// ------------------------------------------------------------------ da, fp32
__global__ void __launch_bounds__(256)
bwd_da_f32(const float* __restrict__ dz, const float* __restrict__ w,
           const float* __restrict__ z_prev, float* __restrict__ dz_prev,
           float* __restrict__ da, int B, int T_in, int C_in, int T_out, int C_out, int k,
           int s) {
  __shared__ __align__(16) float As[2][FBM][FLDS];
  __shared__ __align__(16) float Bs[2][FBN][FLDS];
  const int j0 = blockIdx.z;
  const int F = (T_in - j0 + s - 1) / s;
  const long long M = static_cast<long long>(B) * F;
  const long long m0 = static_cast<long long>(blockIdx.x) * FBM;
  if (F <= 0 || m0 >= M) return;
  const int K = ((j0 < k) + (j0 + s < k)) * C_out;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * FBN;

  const int row = tid >> 2, col = (tid & 3) * 4;
  const long long m = m0 + row;
  const bool ok = m < M;
  const long long mm = ok ? m : 0;
  const int ab = static_cast<int>(mm / F);
  const int af = static_cast<int>(mm - static_cast<long long>(ab) * F);
  const float* a_src = dz + (static_cast<long long>(ab) * T_out + af) * C_out;
  const bool ok0 = ok && af < T_out, ok1 = ok && af >= 1 && af - 1 < T_out;
  const bool b_ok = n0 + row < C_in;
  const float* b_src = w + static_cast<long long>(b_ok ? n0 + row : 0) * C_out;

  auto load_tile = [&](int st, int k0) {
    const int kk = k0 + col;
    const int seg = kk >= C_out ? 1 : 0;
    const int nn = kk - seg * C_out;
    const bool oa = kk < K && (seg ? ok1 : ok0), ob = kk < K && b_ok;
    cp_async16(&As[st][row][col], oa ? a_src + (nn - seg * C_out) : dz, oa);
    cp_async16(&Bs[st][row][col],
               ob ? b_src + static_cast<long long>(j0 + seg * s) * C_in * C_out + nn : w, ob);
  };

  const int tm = tid >> 4, tn = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int KT = (K + FBK - 1) / FBK;
  if (KT > 0) {
    load_tile(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < KT) load_tile(st ^ 1, (kt + 1) * FBK);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      fma_stage(As[st], Bs[st], acc, tm, tn);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mr = m0 + tm * 4 + i;
    if (mr >= M) continue;
    const int b = static_cast<int>(mr / F);
    const long long f = mr - static_cast<long long>(b) * F;
    const long long base = (static_cast<long long>(b) * T_in + f * s + j0) * C_in;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cn = n0 + tn + 16 * j;
      if (cn >= C_in) continue;
      if (z_prev != nullptr)
        dz_prev[base + cn] = acc[i][j] * gelu_grad_exact(z_prev[base + cn]);
      else
        da[base + cn] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ dW partials, fp32
constexpr int FWLD = FBM + 4;  // 272-byte rows

__global__ void __launch_bounds__(256)
bwd_dw_f32(const float* __restrict__ a, const float* __restrict__ dz, float* __restrict__ part,
           int B, int T_in, int C_in, int T_out, int C_out, int k, int s, int chunk_len) {
  __shared__ __align__(16) float As[2][FBK][FWLD];
  __shared__ __align__(16) float Bs[2][FBK][FWLD];
  const int K = k * C_in;
  const long long r0 = static_cast<long long>(blockIdx.z) * chunk_len;
  const long long m_red = static_cast<long long>(B) * T_out;
  const long long r1 = r0 + chunk_len < m_red ? r0 + chunk_len : m_red;
  const int kk0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;

  const int lrow = tid >> 4, lcol = (tid & 15) * 4;  // one 4-element chunk per operand
  auto load_tile = [&](int st, long long base) {
    const long long m = base + lrow;
    const bool ok = m < r1;
    const long long mm = ok ? m : 0;
    const int b = static_cast<int>(mm / T_out);
    const long long f = mm - static_cast<long long>(b) * T_out;
    const bool oa = ok && kk0 + lcol < K, ob = ok && n0 + lcol < C_out;
    cp_async16(&As[st][lrow][lcol],
               oa ? a + (static_cast<long long>(b) * T_in + f * s) * C_in + kk0 + lcol : a, oa);
    cp_async16(&Bs[st][lrow][lcol], ob ? dz + mm * C_out + n0 + lcol : dz, ob);
  };

  const int tm = tid >> 4, tn = tid & 15;  // kk rows tm*4 + i, n cols tn + 16*j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int KT = r1 > r0 ? static_cast<int>((r1 - r0 + FBK - 1) / FBK) : 0;
  if (KT > 0) {
    load_tile(0, r0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < KT) load_tile(st ^ 1, r0 + static_cast<long long>(kt + 1) * FBK);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
#pragma unroll
      for (int r = 0; r < FBK; ++r) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[st][r][tm * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[st][r][tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* out = part + static_cast<long long>(blockIdx.z) * K * C_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = kk0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + 16 * j;
      if (kk < K && n < C_out) out[static_cast<long long>(kk) * C_out + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ dW reduction
__global__ void __launch_bounds__(256)
bwd_dw_reduce(const float* __restrict__ part, float* __restrict__ dw, long long n,
              int n_chunks) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) acc += part[static_cast<long long>(c) * n + e];
    dw[e] = acc;
  }
}

unsigned elementwise_blocks(long long n) {
  const long long blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

// Set a kernel's dynamic shared memory above 48 KB, once per process.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (!*done) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    *done = true;
  }
  return 0;
}

}  // namespace

// All entry points: dtype 0 = float32, 1 = bfloat16; tensors contiguous, in
// dtype unless marked fp32; layer (d = C_out, k, s) maps a (B, T_in, C_in) to
// (B, T_out, C_out); every bf16 width a multiple of 64 (the wrapper checks).
// Each returns cudaGetLastError() after its launch, or a tensor-map error
// code (hopper.cuh TMA_ERROR).

// Up pass: z (pre-GELU, rounded to dtype) and a_next = gelu(z) from a; or,
// with g (B, T_out, C_out) fp32, a_next = dz = g * gelu'(z) and no z. wt is
// the weight as (C_out, k, C_in). In bf16 it is K1's own launch
// (conv_layer_bf16, with the A view (off1, row_stride, batch_stride, cols0,
// cols1) of K1's conv_layer).
extern "C" int conv_bwd_up(int dtype, const void* a, const void* wt, void* z, void* a_next,
                           const void* g, int B, int T_in, int C_in, int T_out, int C_out, int k,
                           int s, long long off1, long long row_stride, long long batch_stride,
                           int cols0, int cols1, void* stream) {
  const long long M = static_cast<long long>(B) * T_out;
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return conv_layer_bf16(static_cast<const bf16*>(a), static_cast<const bf16*>(wt),
                           static_cast<bf16*>(a_next), static_cast<bf16*>(z),
                           static_cast<const float*>(g), B, T_out, C_out,
                           AView{off1, row_stride, batch_stride, cols0, cols1}, st);
  } else if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM), (C_out + FBN - 1) / FBN);
    conv_layer_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(wt), nullptr, nullptr,
        static_cast<float*>(a_next), static_cast<float*>(z), static_cast<const float*>(g), T_in,
        C_in, T_out, C_out, K, s, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Input-side gradient of one layer from dz (B, T_out, C_out) and w
// (k, C_in, C_out). With z_prev (B, T_in, C_in): dz_prev = da * gelu'(z_prev)
// in dtype; without it: da (B, T_in, C_in) in fp32.
extern "C" int conv_bwd_da(int dtype, const void* dz, const void* w, const void* z_prev,
                           void* dz_prev, void* da, int B, int T_in, int C_in, int T_out,
                           int C_out, int k, int s, void* stream) {
  const long long rows = static_cast<long long>(B) * ((T_in + s - 1) / s);  // phase 0, the most
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap dzmap, wmap;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C_out), static_cast<cuuint64_t>(T_out),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C_out) * 2,
                                   static_cast<cuuint64_t>(C_out) * T_out * 2};
    const cuuint32_t box[3] = {WBK, WBM, 1};
    int err = encode_map(&dzmap, dz, 3, dims, strides, box);
    if (err != 0) return err;
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(C_out),
                                 static_cast<cuuint64_t>(k) * C_in};
    const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(C_out) * 2};
    const cuuint32_t wbox[2] = {WBK, WBN};
    if ((err = encode_map(&wmap, w, 2, wdims, wstrides, wbox)) != 0) return err;
    static bool smem_set = false;
    if ((err = allow_smem(conv_da_wgmma, DA_SMEM, &smem_set)) != 0) return err;
    int sms = 0;
    if ((err = sm_count(&sms)) != 0) return err;
    const int n_tiles = (C_in + WBN - 1) / WBN;
    const int f_tiles = static_cast<int>(((T_in + s - 1) / s + WBM - 1) / WBM);
    const long long tiles = static_cast<long long>(B) * f_tiles * s * n_tiles;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
    conv_da_wgmma<<<blocks, DA_THREADS, DA_SMEM, st>>>(
        dzmap, wmap, static_cast<const bf16*>(z_prev), static_cast<bf16*>(dz_prev),
        static_cast<float*>(da), T_in, C_in, C_out, k, s, n_tiles, f_tiles,
        static_cast<int>(tiles));
  } else if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((rows + FBM - 1) / FBM), (C_in + FBN - 1) / FBN, s);
    bwd_da_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(dz), static_cast<const float*>(w),
        static_cast<const float*>(z_prev), static_cast<float*>(dz_prev),
        static_cast<float*>(da), B, T_in, C_in, T_out, C_out, k, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dW partials: part (n_chunks, k * C_in, C_out) fp32 from a (B, T_in, C_in)
// and dz (B, T_out, C_out). In bf16 chunk c sums the (batch row, 64-frame
// tile) steps [c * chunk_len, ...) over the A view (off1, row_stride,
// batch_stride, cols0, cols1) of K1's conv_layer; in fp32 the frames
// [c * chunk_len, ...) of the flattened (B * T_out) axis.
extern "C" int conv_bwd_dw(int dtype, const void* a, const void* dz, void* part, int B,
                           int T_in, int C_in, int T_out, int C_out, int k, int s,
                           long long off1, long long row_stride, long long batch_stride,
                           int cols0, int cols1, int chunk_len, int n_chunks, void* stream) {
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap amap0, amap1, dzmap;
    const cuuint32_t box[3] = {64, DW_BK, 1};
    const cuuint64_t astrides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                    static_cast<cuuint64_t>(batch_stride) * 2};
    const cuuint64_t adims0[3] = {static_cast<cuuint64_t>(cols0), static_cast<cuuint64_t>(T_out),
                                  static_cast<cuuint64_t>(B)};
    int err = encode_map(&amap0, a, 3, adims0, astrides, box);
    if (err != 0) return err;
    amap1 = amap0;  // k <= s: never read for a K position below K
    if (cols1 > 0) {
      const cuuint64_t adims1[3] = {static_cast<cuuint64_t>(cols1),
                                    static_cast<cuuint64_t>(T_out), static_cast<cuuint64_t>(B)};
      if ((err = encode_map(&amap1, static_cast<const bf16*>(a) + off1, 3, adims1, astrides,
                            box)) != 0)
        return err;
    }
    const cuuint64_t ddims[3] = {static_cast<cuuint64_t>(C_out), static_cast<cuuint64_t>(T_out),
                                 static_cast<cuuint64_t>(B)};
    const cuuint64_t dstrides[2] = {static_cast<cuuint64_t>(C_out) * 2,
                                    static_cast<cuuint64_t>(C_out) * T_out * 2};
    if ((err = encode_map(&dzmap, dz, 3, ddims, dstrides, box)) != 0) return err;
    static bool smem_set = false;
    if ((err = allow_smem(conv_dw_wgmma, DW_SMEM, &smem_set)) != 0) return err;
    const int frame_tiles = (T_out + DW_BK - 1) / DW_BK;
    const int n_tiles = (C_out + DW_BN - 1) / DW_BN;
    const int tiles = ((K + DW_BM - 1) / DW_BM) * n_tiles;
    conv_dw_wgmma<<<static_cast<unsigned>(tiles * n_chunks), DW_THREADS, DW_SMEM, st>>>(
        amap0, amap1, dzmap, static_cast<float*>(part), K, C_out, cols0, frame_tiles,
        B * frame_tiles, chunk_len, n_tiles, tiles);
  } else if (dtype == 0) {
    dim3 grid((K + FBM - 1) / FBM, (C_out + FBN - 1) / FBN, n_chunks);
    bwd_dw_f32<<<grid, 256, 0, st>>>(static_cast<const float*>(a),
                                     static_cast<const float*>(dz), static_cast<float*>(part), B,
                                     T_in, C_in, T_out, C_out, k, s, chunk_len);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw[e] = sum over c in order of part[c, e], n elements per chunk, fp32.
extern "C" int conv_bwd_dw_reduce(const void* part, void* dw, long long n, int n_chunks,
                                  void* stream) {
  bwd_dw_reduce<<<elementwise_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
