// FlashAttention forward with an fp32 online softmax, a key-padding mask and
// optional dropout on the attention probabilities.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the forward Pallas
//   kernel _make_fwd_kernel (:64) run by _fwd_pallas (:240), both branches:
//   dropout_p = 0 (serving, the teacher) and dropout_p > 0 (the student's
//   training forward, :100-106).
//
// Bound on the H100: memory. At the serving shape (B=32, T=399, H=12, D=40,
//   bf16) one call does ~9.8 GFLOP against ~49 MB of q/k/v/o, so reading and
//   writing those tensors (~15 us at 3.35 TB/s) is the floor, and the T x T
//   logits must never reach device memory. With dropout the keep mask is
//   regenerated on chip (Philox, philox.cuh), never stored.
//
// Design: one 64-thread block per (b, h, 64-row query tile); each thread
//   owns one query row, keeping q, the running max m, the normalizer l and
//   the output accumulator in fp32 registers. The block walks the key axis
//   in 64-key tiles staged in shared memory as fp32 (all threads read the
//   same key at once: broadcasts, no bank conflicts), 16 keys per rescale of
//   the accumulator. q, k and v are read in place through their (B, T, H, D)
//   strides: no flatten or transpose copy. The inner products are fp32 FMAs,
//   not tensor cores (D = 40 is no multiple of 16); the logits stay on chip.
//   Masked keys, and keys past T, contribute exactly 0; a fully masked row
//   gives out = 0 and lse = -1e30, as the TPU kernel does (:93-97, :116-122).
//   Any T works: the last tiles mask their own ragged tail. Dropout drops
//   the unnormalised probability on its way into the accumulator and scales
//   it by 1/(1-p); the normalizer l and the returned lse stay undropped. The
//   keep test is a pure function of (seed, b*H+h, row, key), so the backward
//   kernels (flash_attention_bwd.cu), which tile differently, regenerate the
//   same mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BKV = 64, CHUNK = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
          int T_len, int H, long long sqb, long long sqt, long long sqh, long long skb,
          long long skt, long long skh, long long svb, long long svt, long long svh,
          uint32_t thr, float inv_keep, uint32_t seed0, uint32_t seed1) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ float valid[BKV];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int t = blockIdx.x * BQ + threadIdx.x;
  const bool row_ok = t < T_len;

  float qr[D], acc[D];
  {
    const T* qp = q + b * sqb + static_cast<long long>(row_ok ? t : 0) * sqt + h * sqh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? to_f(qp[d]) : 0.f;
      acc[d] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int k0 = 0; k0 < T_len; k0 += BKV) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e - j * D, kt = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kt < T_len) {
        kv = to_f(kb[static_cast<long long>(kt) * skt + d]);
        vv = to_f(vb[static_cast<long long>(kt) * svt + d]);
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
    T* op = out + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f<T>(acc[d] * inv);
    lse[(static_cast<long long>(b) * H + h) * T_len + t] = l == 0.f ? NEG_INF : m + logf(l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
            float* lse, int B, int T_len, int H, const long long* st, uint32_t thr,
            float inv_keep, uint32_t seed0, uint32_t seed1, cudaStream_t stream) {
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  auto kernel = thr > 0 ? &flash_fwd<T, D, true> : &flash_fwd<T, D, false>;
  kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lse, T_len, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], thr, inv_keep, seed0, seed1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 40 or 64. q, k, v (B, T, H, D)
// with the given (b, t, h) element strides and unit stride along D; mask
// (B, T) bool with True = padding, or null; out (B, T, H, D) and lse
// (B, H, T) fp32, contiguous. thr = floor(p * 2^24) (0: no dropout),
// inv_keep = 1/(1-p), seed0/seed1 the dropout seed. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* mask, void* out, void* lse,
                                   int B, int T_len, int H, long long sqb, long long sqt,
                                   long long sqh, long long skb, long long skt, long long skh,
                                   long long svb, long long svt, long long svh,
                                   unsigned thr, float inv_keep, unsigned seed0,
                                   unsigned seed1, void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 40)
    launch<bf16, 40>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, seed0, seed1, s);
  else if (dtype == 1 && head_dim == 64)
    launch<bf16, 64>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, seed0, seed1, s);
  else if (dtype == 0 && head_dim == 40)
    launch<float, 40>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, seed0, seed1, s);
  else if (dtype == 0 && head_dim == 64)
    launch<float, 64>(q, k, v, mk, out, ls, B, T_len, H, st, thr, inv_keep, seed0, seed1, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
