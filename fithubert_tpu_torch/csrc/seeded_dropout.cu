// Elementwise dropout whose keep mask is regenerated from a seed, so the
// backward needs no stored mask: y = where(keep(e), x * 1/(1-p), 0).
//
// Replaces: fithubert_tpu/ops/pallas/dropout.py, the Pallas kernel
//   _make_kernel (:54) run by _run (:75) for seeded_dropout (:152); its
//   custom VJP (:96-111) applies the same kernel to the cotangent.
//
// Bound on the H100: bytes. Each element is read once and written once
//   (8 bytes in fp32); one Philox-4x32-10 call (~40 integer operations)
//   serves four elements, far below what the SMs issue per byte of HBM.
//
// Design: the keep decision of flat element e is word e & 3 of
//   philox4x32((e >> 2, e >> 34, 0, 0), (seed[0], seed[1])) (philox.cuh), kept
//   when its top 24 bits reach thr = floor(p * 2^24), so the mask depends
//   on the element alone and not on the launch's shape: the forward on x
//   and the backward on the cotangent draw the same mask. The TPU kernel
//   seeds its hardware generator per grid block instead; its bits cannot be
//   reproduced here. Each thread of a grid-stride loop owns four
//   consecutive elements, one Philox call: a 16-byte (fp32) or 8-byte
//   (bf16) vector load and store when the group is whole and aligned,
//   element by element at the tail. The arithmetic is fp32; the result is
//   rounded once to x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __bfloat162float(a.x); v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x); v[3] = __bfloat162float(b.y);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16(v[0]); a.y = __float2bfloat16(v[1]);
  b.x = __float2bfloat16(v[2]); b.y = __float2bfloat16(v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(256)
seeded_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t thr,
                      float inv, const uint32_t* __restrict__ seed, int vec) {
  const uint32_t k0 = seed[0], k1 = seed[1];  // the words a graph replay finds there
  const long long groups = (n + 3) >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 w = philox4x32(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), k0, k1);
    const long long e0 = g << 2;
    const bool whole = vec && e0 + 4 <= n;
    float v[4];
    if (whole) {
      load4(x + e0, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = e0 + e < n ? to_f(x[e0 + e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (philox_word(w, e) >> 8) >= thr ? v[e] * inv : 0.f;
    if (whole) {
      store4(y + e0, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e0 + e < n) y[e0 + e] = from_f<T>(v[e]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y contiguous, n elements each;
// vec != 0 when both are aligned to four elements. thr = floor(p * 2^24),
// inv = 1 / (1 - p); seed points to the two seed words in device memory,
// read by each thread as it starts (so a CUDA graph replays the words the
// host wrote there last, as the TPU kernel reads its seed from SMEM, :87).
// Returns cudaGetLastError() after the launch.
extern "C" int seeded_dropout(int dtype, const void* x, void* y, long long n, unsigned thr,
                              float inv, const void* seed, int vec, void* stream) {
  const uint32_t* sp = static_cast<const uint32_t*>(seed);
  const long long groups = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>(
      groups / 256 + 1 < 8192 ? groups / 256 + 1 : 8192);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    seeded_dropout_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, thr, inv, sp, vec);
  } else if (dtype == 1) {
    seeded_dropout_kernel<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), n, thr, inv, sp, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
