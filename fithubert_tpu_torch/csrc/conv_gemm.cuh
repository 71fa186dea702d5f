// The conv-layer GEMM of the waveform front-end, shared by K1
// (conv_frontend.cu, the forward) and K6 (conv_frontend_bwd.cu, whose up
// pass recomputes each layer's pre-GELU sum z and output a with the same
// kernels, so the recomputed a equals K1's forward output bit for bit).
// The design notes are in conv_frontend.cu.

#pragma once
#include "mma.cuh"

namespace {

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.79788456080286536f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

template <typename T> __device__ __forceinline__ float gelu(float v);
template <> __device__ __forceinline__ float gelu<float>(float v) { return gelu_exact(v); }
template <> __device__ __forceinline__ float gelu<bf16>(float v) { return gelu_tanh(v); }

// Apply the GroupNorm + GELU prefix to VEC elements that this thread copied
// into shared memory: element e sits at K index kk + e of output row batch b.
template <typename T, int VEC>
__device__ __forceinline__ void prefix_in_place(T* dst, int kk, int b, int C_in,
                                                const T* scale, const T* shift) {
  int c = kk % C_in;  // VEC divides C_in, so the chunk stays in one input row
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    size_t i = static_cast<size_t>(b) * C_in + c + e;
    float v = to_f(dst[e]) * to_f(scale[i]) + to_f(shift[i]);
    dst[e] = from_f<T>(gelu<T>(v));
  }
}

// ------------------------------------------------------------------ bf16
constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8;  // 80-byte rows: no bank conflicts

// One BK-deep stage of the 128 x 128 tile product: A rows (M) and B rows (N)
// both hold K contiguously. Warp (wm, wn) owns rows wm*32.., cols wn*64..;
// lane (g, t4) = (lane / 4, lane % 4) as in mma.sync's fragment layout.
__device__ __forceinline__ void mma_stage(const bf16 (&As)[BM][LDS], const bf16 (&Bs)[BN][LDS],
                                          float (&acc)[2][8][4], int wm, int wn, int g,
                                          int t4) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    const int c = ks + t4 * 2;
    uint32_t af[2][4], bfr[8][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = wn * 64 + ni * 8 + g;
      bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
      bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
  }
}

__global__ void __launch_bounds__(256)
conv_layer_bf16(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                const bf16* __restrict__ scale, const bf16* __restrict__ shift,
                bf16* __restrict__ y, bf16* __restrict__ z, int T_in, int C_in, int T_out,
                int N, int K, int s, long long M) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];
  __shared__ __align__(16) bf16 Bs[2][BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: rows wm*32, cols wn*64
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Each thread copies two 8-element chunks of A and of B per stage: rows
  // tid/4 and tid/4 + 64, columns (tid%4)*8.
  const int col = (tid & 3) * 8;
  const bf16* a_src[2];
  const bf16* b_src[2];
  bool a_ok[2], b_ok[2];
  int a_b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int row = (tid >> 2) + i * 64;
    long long m = m0 + row;
    a_ok[i] = m < M;
    long long mm = a_ok[i] ? m : 0;
    int b = static_cast<int>(mm / T_out);
    long long f = mm - static_cast<long long>(b) * T_out;
    a_b[i] = b;
    a_src[i] = x + (static_cast<long long>(b) * T_in + f * s) * C_in;
    int n = n0 + row;
    b_ok[i] = n < N;
    b_src[i] = wt + static_cast<long long>(b_ok[i] ? n : 0) * K;
  }

  auto load_tile = [&](int st, int k0) {
    int kk = k0 + col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int row = (tid >> 2) + i * 64;
      bool oa = a_ok[i] && kk < K, ob = b_ok[i] && kk < K;
      cp_async16(&As[st][row][col], oa ? a_src[i] + kk : x, oa);
      cp_async16(&Bs[st][row][col], ob ? b_src[i] + kk : wt, ob);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) load_tile(st ^ 1, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait1();   // this thread's copies of tile kt have landed
    if (scale != nullptr) {
      int kk = kt * BK + col;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (a_ok[i] && kk < K)
          prefix_in_place<bf16, 8>(&As[st][(tid >> 2) + i * 64][col], kk, a_b[i], C_in,
                                   scale, shift);
    }
    __syncthreads();
    mma_stage(As[st], Bs[st], acc, wm, wn, g, t4);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int cn = n0 + wn * 64 + ni * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (r < M && cn < N) {
          // round the sum to bf16 before the GELU, as the XLA oracle's conv
          // output is (conv_frontend.py:254-258)
          __nv_bfloat162 zb, v;
          zb.x = __float2bfloat16(acc[mi][ni][half * 2]);
          zb.y = __float2bfloat16(acc[mi][ni][half * 2 + 1]);
          v.x = __float2bfloat16(gelu_tanh(__bfloat162float(zb.x)));
          v.y = __float2bfloat16(gelu_tanh(__bfloat162float(zb.y)));
          *reinterpret_cast<__nv_bfloat162*>(y + r * N + cn) = v;
          if (z != nullptr) *reinterpret_cast<__nv_bfloat162*>(z + r * N + cn) = zb;
        }
      }
    }
}

// ------------------------------------------------------------------ fp32
constexpr int FBM = 64, FBN = 64, FBK = 16, FLDS = FBK + 4;  // 80-byte rows

// One FBK-deep stage of the 64 x 64 fp32 tile product (K contiguous in both
// operands): thread (tm, tn) owns rows tm*4 + i, cols tn + 16*j.
__device__ __forceinline__ void fma_stage(const float (&As)[FBM][FLDS],
                                          const float (&Bs)[FBN][FLDS], float (&acc)[4][4],
                                          int tm, int tn) {
#pragma unroll
  for (int kk = 0; kk < FBK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[tm * 4 + i][kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[tn + 16 * j][kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(256)
conv_layer_f32(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ scale, const float* __restrict__ shift,
               float* __restrict__ y, float* __restrict__ z, int T_in, int C_in, int T_out,
               int N, int K, int s, long long M) {
  __shared__ __align__(16) float As[2][FBM][FLDS];
  __shared__ __align__(16) float Bs[2][FBN][FLDS];
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * FBM;
  const int n0 = blockIdx.y * FBN;

  // one 4-element chunk of A and of B per thread per stage
  const int row = tid >> 2, col = (tid & 3) * 4;
  const long long m = m0 + row;
  const bool a_ok = m < M;
  const long long mm = a_ok ? m : 0;
  const int ab = static_cast<int>(mm / T_out);
  const float* a_src = x + (static_cast<long long>(ab) * T_in + (mm - static_cast<long long>(ab) * T_out) * s) * C_in;
  const bool b_ok = n0 + row < N;
  const float* b_src = wt + static_cast<long long>(b_ok ? n0 + row : 0) * K;

  auto load_tile = [&](int st, int k0) {
    int kk = k0 + col;
    bool oa = a_ok && kk < K, ob = b_ok && kk < K;
    cp_async16(&As[st][row][col], oa ? a_src + kk : x, oa);
    cp_async16(&Bs[st][row][col], ob ? b_src + kk : wt, ob);
  };

  const int tm = tid >> 4, tn = tid & 15;  // rows tm*4 + i, cols tn + 16*j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int KT = (K + FBK - 1) / FBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) load_tile(st ^ 1, (kt + 1) * FBK);
    cp_async_commit();
    cp_async_wait1();
    if (scale != nullptr) {
      int kk = kt * FBK + col;
      if (a_ok && kk < K) prefix_in_place<float, 4>(&As[st][row][col], kk, ab, C_in, scale, shift);
    }
    __syncthreads();
    fma_stage(As[st], Bs[st], acc, tm, tn);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cn = n0 + tn + 16 * j;
      if (r < M && cn < N) {
        y[r * N + cn] = gelu_exact(acc[i][j]);
        if (z != nullptr) z[r * N + cn] = acc[i][j];
      }
    }
  }
}

}  // namespace
