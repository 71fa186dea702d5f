// FlashAttention backward: dQ (one kernel) and dK, dV (a second kernel),
// with the key-padding mask and the forward's dropout mask regenerated.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the backward Pallas
//   kernels _make_bwd_dq_kernel (:127, run at :304) and _make_bwd_dkv_kernel
//   (:173, run at :323).
//
// Bound on the H100: memory, like the forward. At the student's training
//   shape (B=12, T=299, H=12, D=40, bf16) the two kernels read q, k, v, dO,
//   lse and delta and write dQ, dK, dV (~10 MB) against ~1.2 GFLOP of
//   recomputed logits and products, so the T x T matrices P and dS must stay
//   on chip; they are recomputed from lse instead of being stored.
//
// Design: FlashAttention-2's split, without atomics. dQ: one 64-thread
//   block per (b, h, 64-row query tile), one thread per query row i holding
//   q_i, dO_i and the dQ accumulator in fp32 registers; the block walks the
//   key axis in 64-key tiles of K and V staged in shared memory as fp32
//   (broadcast reads). dK/dV: one 64-thread block per (b, h, 64-key tile),
//   one thread per key column j holding k_j, v_j and the dK, dV
//   accumulators; the block walks every query tile, staging Q, dO, lse and
//   delta. Each output element is summed by one thread in a fixed order, so
//   the gradients are deterministic run to run. Per element:
//     P  = exp(s - lse), zeroed explicitly at masked keys (:148-150), so a
//          fully padded row (lse = -1e30) gives exactly zero gradients;
//     dP = dO . v_j, dropped and scaled like P in the forward;
//     dS = P * (dP - delta),  delta = rowsum(dO * O) (computed by the
//          caller, as XLA does at :302);
//     dV += P_dropped dO,  dK += dS q_i,  dQ += dS k_j.
//   The keep mask is philox.cuh's pure function of (seed, b*H+h, i, j), so
//   it equals the forward's whatever the tiling. fp32 accumulation, written
//   in q's dtype (:351-353). D in {40, 64}, any T (ragged tails masked
//   here), q, k, v read through their (B, T, H, D) strides; dO, lse, delta
//   and the outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

struct Dropout {
  uint32_t thr;  // floor(p * 2^24); 0 = no dropout
  float inv_keep;
  uint32_t seed0, seed1;
};

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// ------------------------------------------------------------------ dQ (K3)
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ mask, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int T_len, int H, Strides st, Dropout dr) {
  __shared__ __align__(16) float Ks[BKV][D];
  __shared__ __align__(16) float Vs[BKV][D];
  __shared__ float valid[BKV];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int i = blockIdx.x * BQ + threadIdx.x;
  const bool row_ok = i < T_len;
  const long long row = static_cast<long long>(row_ok ? i : 0);

  float qr[D], dor[D], acc[D];
  {
    const T* qp = q + b * st.qb + row * st.qt + h * st.qh;
    const T* dp = dout + ((static_cast<long long>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? to_f(qp[d]) : 0.f;
      dor[d] = row_ok ? to_f(dp[d]) : 0.f;
      acc[d] = 0.f;
    }
  }
  const long long lrow = static_cast<long long>(bh) * T_len + row;
  const float lse_i = row_ok ? lse[lrow] : 0.f;
  const float delta_i = row_ok ? delta[lrow] : 0.f;

  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  for (int k0 = 0; k0 < T_len; k0 += BKV) {
    __syncthreads();
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e - j * D, kt = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kt < T_len) {
        kv = to_f(kb[static_cast<long long>(kt) * st.kt + d]);
        vv = to_f(vb[static_cast<long long>(kt) * st.vt + d]);
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
    T* op = dq + ((static_cast<long long>(b) * T_len + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f<T>(acc[d]);
  }
}

// ------------------------------------------------------------ dK, dV (K4)
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(BKV)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ mask, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int T_len, int H, Strides st,
              Dropout dr) {
  __shared__ __align__(16) float Qs[BQ][D];
  __shared__ __align__(16) float dOs[BQ][D];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int j = blockIdx.x * BKV + threadIdx.x;
  const bool col_in = j < T_len;
  const long long col = static_cast<long long>(col_in ? j : 0);
  const bool col_ok =
      col_in && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + j]);
  // lane4 = j & 3; group_lane0: the warp lane that owns key j & ~3
  const int lane4 = threadIdx.x & 3, group_lane0 = threadIdx.x & 28;

  float kr[D], vr[D], dka[D], dva[D];
  {
    const T* kp = k + b * st.kb + col * st.kt + h * st.kh;
    const T* vp = v + b * st.vb + col * st.vt + h * st.vh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = col_in ? to_f(kp[d]) : 0.f;
      vr[d] = col_in ? to_f(vp[d]) : 0.f;
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
  }

  const T* qb = q + b * st.qb + h * st.qh;
  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * D; e += BKV) {
      const int r = e / D, d = e - r * D, qt = q0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qt < T_len) {
        qv = to_f(qb[static_cast<long long>(qt) * st.qt + d]);
        dv_ = to_f(dout[((static_cast<long long>(b) * T_len + qt) * H + h) * D + d]);
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
      // its lane: one call per 4 (i, j), as in the forward and K3.
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
      dk[o + d] = from_f<T>(dka[d]);
      dv[o + d] = from_f<T>(dva[d]);
    }
  }
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const uint8_t* mask,
               const void* dout, const float* lse, const float* delta, void* dq, int B,
               int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  auto kernel = dr.thr > 0 ? &flash_bwd_dq<T, D, true> : &flash_bwd_dq<T, D, false>;
  kernel<<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), T_len, H, st, dr);
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const uint8_t* mask,
                const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                int B, int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  dim3 grid((T_len + BKV - 1) / BKV, B * H);
  auto kernel = dr.thr > 0 ? &flash_bwd_dkv<T, D, true> : &flash_bwd_dkv<T, D, false>;
  kernel<<<grid, BKV, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      T_len, H, st, dr);
}

}  // namespace

// Shared arguments: dtype 0 = float32, 1 = bfloat16; head_dim 40 or 64;
// q, k, v (B, T, H, D) with the given (b, t, h) element strides and unit
// stride along D; mask (B, T) bool, True = padding, or null; dout
// (B, T, H, D) contiguous in q's dtype; lse and delta (B, H, T) fp32; the
// outputs (B, T, H, D) contiguous in q's dtype; thr = floor(p * 2^24) (0:
// no dropout), inv_keep = 1/(1-p), seed0/seed1 the forward's seed. Each
// returns cudaGetLastError() after its launch.
#define FA_BWD_DISPATCH(CALL)                                             \
  if (dtype == 1 && head_dim == 40) CALL(bf16, 40);                       \
  else if (dtype == 1 && head_dim == 64) CALL(bf16, 64);                  \
  else if (dtype == 0 && head_dim == 40) CALL(float, 40);                 \
  else if (dtype == 0 && head_dim == 64) CALL(float, 64);                 \
  else return static_cast<int>(cudaErrorInvalidValue);                    \
  return static_cast<int>(cudaGetLastError());

extern "C" int flash_attention_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                      const void* v, const void* mask, const void* dout,
                                      const void* lse, const void* delta, void* dq, int B,
                                      int T_len, int H, long long sqb, long long sqt,
                                      long long sqh, long long skb, long long skt,
                                      long long skh, long long svb, long long svt,
                                      long long svh, unsigned thr, float inv_keep,
                                      unsigned seed0, unsigned seed1, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, seed0, seed1};
#define FA_DQ(TT, DD)                                                                    \
  launch_dq<TT, DD>(q, k, v, static_cast<const uint8_t*>(mask), dout,                    \
                    static_cast<const float*>(lse), static_cast<const float*>(delta), dq, \
                    B, T_len, H, st, dr, static_cast<cudaStream_t>(stream))
  FA_BWD_DISPATCH(FA_DQ)
#undef FA_DQ
}

extern "C" int flash_attention_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* mask, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       int B, int T_len, int H, long long sqb, long long sqt,
                                       long long sqh, long long skb, long long skt,
                                       long long skh, long long svb, long long svt,
                                       long long svh, unsigned thr, float inv_keep,
                                       unsigned seed0, unsigned seed1, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, seed0, seed1};
#define FA_DKV(TT, DD)                                                                   \
  launch_dkv<TT, DD>(q, k, v, static_cast<const uint8_t*>(mask), dout,                   \
                     static_cast<const float*>(lse), static_cast<const float*>(delta),    \
                     dk, dv, B, T_len, H, st, dr, static_cast<cudaStream_t>(stream))
  FA_BWD_DISPATCH(FA_DKV)
#undef FA_DKV
}
