// FlashAttention forward with an fp32 online softmax, a key-padding mask and
// optional dropout on the attention probabilities.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the forward Pallas
//   kernel _make_fwd_kernel (:64) run by _fwd_pallas (:243), both branches:
//   dropout_p = 0 (serving, the teacher) and dropout_p > 0 (the student's
//   training forward, :100-106).
//
// Bound on the H100: at the teacher's shape (B=12, T=599, H=12, D=64) the
//   two products are 13.2 GFLOP, 0.0134 ms at the bf16 tensor-core peak; at
//   the serving shape (B=32, T=399, H=12, D=40) reading q/k/v and writing o
//   (~49 MB) takes 0.0148 ms at 3.35 TB/s. The T x T logits never reach
//   device memory, and with dropout the keep mask is regenerated on chip.
//   Only the tensor cores reach either bound: the card's fp32 FMA rate
//   (67 TFLOP/s) alone needs 0.197 ms for the teacher's products.
//
// Design: in bf16 (every main path) FlashAttention-2 on mma.sync
//   m16n8k16 bf16 -> fp32, as the TPU kernel multiplies bf16 operands into
//   fp32 (:83-85) and rounds P to bf16 before P V (:108-111).
//   - Block and tiles: 4 warps (128 threads) per (b, h, 64-row query tile),
//     16 query rows per warp. Q is copied once into shared memory with
//     cp.async and held as A fragments (ldmatrix); K and V pass through a
//     two-stage cp.async ring of 64-key tiles. Rows are padded by 16 bytes
//     (pitch 112 or 144 bytes, an odd number of 16-byte units), so the 8
//     row addresses of each ldmatrix fall in distinct bank groups. q, k and
//     v are read in place through their (B, T, H, D) strides; the wrapper
//     checks that every row starts on 16 bytes.
//   - S = Q K^T: D = 64 is four k16 steps; D = 40 is three over 48, with
//     columns 40-47 of Q and K zeroed in shared memory once and never
//     loaded. Each warp holds S as 8 n8 tiles (rows g, g + 8 of lane
//     4g + t4; keys 8n + 2t4, +1).
//   - Online softmax on those fragments, in base 2 (S scaled by log2 e,
//     exp2f; lse = m ln 2 + log l): the row max is reduced over the lane
//     quad with __shfl_xor_sync (masks 1, 2); the row sum stays a per-lane
//     partial until the epilogue. Keys past T and padded keys get -1e30 in
//     S and are zeroed explicitly in P, so a fully padded row gives out = 0
//     and lse = -1e30, as the TPU kernel does (:93-97, :116-122).
//   - P V: P rounded to bf16 goes straight from registers into the A
//     operand (the C layout of two n8 tiles of S is the A layout of one k16
//     step); V's B fragments come from ldmatrix.trans. D = 40 is five n8
//     output tiles, D = 64 eight.
//   - Dropout: the keep test is philox.cuh's pure function of (seed, z =
//     b * H + h, row i, key j): counter (j >> 2, i, z, 0), word j & 3. In a
//     C tile lanes 4g + 2c and 4g + 2c + 1 hold the four keys of one j >> 2
//     group on rows g and g + 8: the even lane draws row g's call, the odd
//     lane row g + 8's, and they swap the two words the other needs
//     (__shfl_xor_sync, mask 1): one Philox call per four (i, j). The
//     unnormalised P is dropped and scaled by 1/(1-p) on its way into P V;
//     the normaliser l and the returned lse stay undropped (:100-106).
//   - Epilogue: out = acc / l in fp32, stored in bf16; lse (B, H, T) fp32.
//   The tile steps (row copies, the two products) are flash_tile.cuh's,
//   shared with K4.
//   - Head sizes: the kernels are compiled for FA_HEAD_DIMS (16 to 128;
//     the wrapper zero-pads any other D to the next one). The tiles live in
//     dynamic shared memory (5 tiles of 64 rows: 46 KB at D = 64, 86 KB at
//     128), opted in above 48 KB.
//   - Seed: the two dropout words are read from seed_ptr in device memory,
//     once per thread as the block starts; under a CUDA graph
//     the host rewrites them there before each replay, as the TPU kernel
//     reads its seed from SMEM (:247).
//
// fp32 (only the card-vs-CPU checks, held to 2e-3 end to end): the FMA body
//   of the port's first version, one thread per query row over 64-key fp32
//   tiles in shared memory. The tensor cores would take fp32 only as TF32,
//   whose 10-bit mantissa breaks that limit, so fp32 stays on the FMA pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.69314718055994531f;
constexpr int BQ = 64, BKV = 64, CHUNK = 16;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------- bf16, mma.sync
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
              bf16* __restrict__ out, float* __restrict__ lse, int T_len, int H,
              long long sqb, long long sqt, long long sqh, long long skb, long long skt,
              long long skh, long long svb, long long svt, long long svh, uint32_t thr,
              float inv_keep, const uint32_t* __restrict__ seed_ptr) {
  constexpr int LD = Rows<D>::LD, KS = Rows<D>::KS, N8 = Rows<D>::N8;
  extern __shared__ __align__(16) unsigned char smem[];  // fwd_mma_smem<D>() bytes
  auto Qs = reinterpret_cast<bf16 (*)[LD]>(smem);
  auto Ks = reinterpret_cast<bf16 (*)[TILE][LD]>(smem + Rows<D>::BYTES);
  auto Vs = reinterpret_cast<bf16 (*)[TILE][LD]>(smem + 3 * Rows<D>::BYTES);
  auto valid = reinterpret_cast<float (*)[TILE]>(smem + 5 * Rows<D>::BYTES);
  // the words a graph replay finds there (no pointer without dropout)
  const uint32_t seed0 = DROPOUT ? seed_ptr[0] : 0u, seed1 = DROPOUT ? seed_ptr[1] : 0u;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * TILE;

  zero_pad<D>(Qs, TILE);
  zero_pad<D>(Ks[0], 2 * TILE);
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  auto load_kv = [&](int st, int k0) {
    load_rows<D>(Ks[st], kb, skt, k0, T_len);
    load_rows<D>(Vs[st], vb, svt, k0, T_len);
    if (threadIdx.x < TILE) {
      const int t = k0 + threadIdx.x;
      valid[st][threadIdx.x] =
          (t < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + t]))
              ? 1.f : 0.f;
    }
  };
  load_rows<D>(Qs, q + b * sqb + h * sqh, sqt, q0, T_len);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float m_r[2] = {NEG_INF, NEG_INF};  // running row max, base 2 (rows g, g + 8)
  float l_r[2] = {0.f, 0.f};          // this lane's part of the row sum
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = (T_len + TILE - 1) / TILE;
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * TILE;
    if (kt + 1 < n_kt) load_kv(st ^ 1, k0 + TILE);
    cp_async_commit();  // possibly empty: one group per iteration
    cp_async_wait1();   // tile kt (and Q) have landed
    __syncthreads();
    if (kt == 0) load_a<D>(qf, Qs, warp * 16, lane);

    // S = Q K^T; element e of tile n is (row g + 8 (e >> 1), key 8n + 2t4 + (e & 1))
    float s[8][4];
    mma_a_bt<D>(s, qf, Ks[st], lane);

    // online softmax in base 2
    uint32_t ok_bits = 0;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = valid[st][n * 8 + 2 * t4 + (e & 1)] != 0.f;
        ok_bits |= ok ? 1u << (4 * n + e) : 0u;
        s[n][e] = ok ? s[n][e] * LOG2E : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys are zeroed explicitly: for a fully masked row
        // s - m is 0 and exp2 would give 1
        const float p = (ok_bits >> (4 * n + e)) & 1u ? exp2f(s[n][e] - mx[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        s[n][e] = p;
      }

    if (DROPOUT) {
      const bool odd = t4 & 1;
      const uint32_t row = static_cast<uint32_t>(q0 + warp * 16 + g + (odd ? 8 : 0));
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t jg = static_cast<uint32_t>((k0 + n * 8) / 4 + (t4 >> 1));
        const uint4 w = philox4x32(make_uint4(jg, row, static_cast<uint32_t>(bh), 0u),
                                   seed0, seed1);
        // even lane: words 0, 1 (its keys) of row g; odd lane: words 2, 3 of row g + 8
        const uint32_t own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
        const uint32_t got0 = __shfl_xor_sync(FULL, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(FULL, odd ? w.y : w.w, 1);
        const uint32_t wd[4] = {odd ? got0 : own0, odd ? got1 : own1,
                                odd ? own0 : got0, odd ? own1 : got1};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= (wd[e] >> 8) >= thr ? inv_keep : 0.f;
      }
    }

    mma_c_b<D>(acc, s, Vs[st], lane);  // acc += P V
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T_len) continue;
    const float inv = l_r[r] == 0.f ? 0.f : 1.f / l_r[r];
    bf16* op = out + ((static_cast<long long>(b) * T_len + t) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t4 == 0)
      lse[static_cast<long long>(bh) * T_len + t] =
          l_r[r] == 0.f ? NEG_INF : m_r[r] * LN2 + logf(l_r[r]);
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

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t = blockIdx.x * BQ + threadIdx.x;
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
constexpr int fwd_mma_smem() { return 5 * Rows<D>::BYTES + 2 * TILE * sizeof(float); }
template <int D>
constexpr int fwd_smem() { return 2 * BKV * D * sizeof(float) + BKV * sizeof(float); }

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
            float* lse, int B, int T_len, int H, const long long* st, uint32_t thr,
            float inv_keep, const uint32_t* seed_ptr, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  if constexpr (sizeof(T) == 2) {
    auto kernel = thr > 0 ? &flash_fwd_mma<D, true> : &flash_fwd_mma<D, false>;
    opt_in_smem(kernel, fwd_mma_smem<D>(), opted[thr > 0]);
    kernel<<<grid, 128, fwd_mma_smem<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<bf16*>(out), lse, T_len, H, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], thr, inv_keep, seed_ptr);
  } else {
    auto kernel = thr > 0 ? &flash_fwd<D, true> : &flash_fwd<D, false>;
    opt_in_smem(kernel, fwd_smem<D>(), opted[thr > 0]);
    kernel<<<grid, BQ, fwd_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(out), lse, T_len, H, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], thr, inv_keep, seed_ptr);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim one of FA_HEAD_DIMS. q, k, v
// (B, T, H, D) with the given (b, t, h) element strides and unit stride
// along D (bf16: every row 16-byte aligned); mask (B, T) bool with True =
// padding, or null; out (B, T, H, D) and lse (B, H, T) fp32, contiguous.
// thr = floor(p * 2^24) (0: no dropout), inv_keep = 1/(1-p); seed_ptr
// points to the two dropout seed words in device memory, read by the kernel
// (null without dropout). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* mask, void* out, void* lse,
                                   int B, int T_len, int H, long long sqb, long long sqt,
                                   long long sqh, long long skb, long long skt, long long skh,
                                   long long svb, long long svt, long long svh,
                                   unsigned thr, float inv_keep, const void* seed_ptr,
                                   void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const uint32_t* sp = static_cast<const uint32_t*>(seed_ptr);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_FWD(DD)                                                                          \
  if (head_dim == DD) {                                                                     \
    if (dtype == 1)                                                                         \
      launch<bf16, DD>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, sp, s);       \
    else if (dtype == 0)                                                                    \
      launch<float, DD>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, sp, s);      \
    else                                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                                       \
    return static_cast<int>(cudaGetLastError());                                            \
  }
  FA_HEAD_DIMS(FA_FWD)
#undef FA_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}
