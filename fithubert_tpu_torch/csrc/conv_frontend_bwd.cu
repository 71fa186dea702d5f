// Backward of conv blocks 1..N of the waveform front-end: from a0 (the
// stack's input), the weights and g (the cotangent of the stack's output),
// da0 and every dW, all fp32.
//
// Replaces: fithubert_tpu/ops/pallas/conv_frontend_bwd.py, the Pallas kernel
//   _make_bwd_kernel (:155) run by pallas_stack_bwd (:244-344), the opt-in
//   backward of fused_conv_stack and fused_conv_stack_gn
//   (conv_frontend.py:345-352, :426-443; FITHUBERT_CONV_BWD=pallas).
//
// Bound on the H100: operations. The student's stack at 12 x 12 s is ~230
//   GFLOP forward; the backward recomputes it (up pass) and adds dW and da,
//   each as large: ~690 GFLOP against ~2 GB of activations written and read
//   back, above the ~295 FLOP/byte where bf16 tensor cores stop waiting on
//   memory.
//
// Design: for layer i = (d, k, s) with input a_i, the TPU kernel walks a
//   sequential grid of frame tiles, recomputes each tile's layers in VMEM,
//   carries dW across grid steps and overlap-adds the tiles' dx windows. CUDA
//   blocks run in no order, so each pass here is a whole-(B, T) launch:
//   - up pass, one launch per layer: K1's GEMM (conv_gemm.cuh: in bf16 the
//     wgmma + TMA kernel, on K1's tile geometry) on a_i writes z_i (the
//     pre-GELU sum, rounded to the dtype) and a_{i+1} = gelu(z_i), the very
//     values K1's forward produced;
//   - dz of the last layer: g * gelu'(z), rounded to the dtype, where gelu'
//     is the exact-erf derivative in fp32 and the tanh form's in bf16
//     (conv_frontend_bwd.py:68-93), g fp32;
//   - dW_i, a reduction over all B * T_{i+1} frames: the frame axis is split
//     into a fixed number of chunks, one block per (chunk, 128 x 128 tile of
//     (k * C_in, C_out)) writes fp32 partials, and a second launch sums the
//     chunks in order: deterministic, no atomics. Both operands hold the
//     reduction axis as rows, so the tiles are staged [frame][column] and
//     the mma.sync fragments are packed from two 16-bit reads;
//   - da_i, a gather-GEMM: with k <= 2s, input row r = f * s + j receives
//     from output frame f through tap j and, when j + s < k, from frame
//     f - 1 through tap j + s. One launch covers the s phases j (grid z);
//     within a phase the two taps are fixed, so each output row is one GEMM
//     row of K = (1 or 2) * C_out, written by one thread: no overlap-add.
//     Its epilogue multiplies by gelu'(z_{i-1}) and writes dz_{i-1} in the
//     dtype, so the fp32 g between layers never goes to memory; for layer 0
//     it writes da0 in fp32.
//   Per stack: L up launches, 1 dz, L dW, L reductions, L da: 4L + 1.
//   In dW and da, bf16 operands meet in mma.sync m16n8k16 with fp32
//   accumulation (fp32: FMA); wgmma, TMA and fusing the passes are later
//   work.

#include "conv_gemm.cuh"

namespace {

__device__ __forceinline__ float gelu_grad_exact(float x) {
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;  // 1 / sqrt(2 pi)
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) + x * phi;
}

__device__ __forceinline__ float gelu_grad_tanh(float x) {
  const float c = 0.79788456080286536f, c3 = 0.044715f;  // sqrt(2 / pi)
  const float t = tanhf(c * (x + c3 * x * x * x));
  const float du = c * (1.f + 3.f * c3 * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

template <typename T> __device__ __forceinline__ float gelu_grad(float v);
template <> __device__ __forceinline__ float gelu_grad<float>(float v) { return gelu_grad_exact(v); }
template <> __device__ __forceinline__ float gelu_grad<bf16>(float v) { return gelu_grad_tanh(v); }

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// ------------------------------------------------------------------ dz
template <typename T>
__global__ void __launch_bounds__(256)
bwd_dz(const float* __restrict__ g, const T* __restrict__ z, T* __restrict__ dz, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += stride)
    dz[e] = from_f<T>(g[e] * gelu_grad<T>(to_f(z[e])));
}

// ------------------------------------------------------------------ da, bf16
// Rows of phase j0 = blockIdx.z are the input rows r = f * s + j0 of every
// batch b, m = b * F + f. Their K axis is [dz[b, f] (tap j0) | dz[b, f - 1]
// (tap j0 + s)], the second segment only when j0 + s < k; B row c of tap j
// is w[j, c, :] (w is (k, C_in, C_out)).
__global__ void __launch_bounds__(256)
bwd_da_bf16(const bf16* __restrict__ dz, const bf16* __restrict__ w,
            const bf16* __restrict__ z_prev, bf16* __restrict__ dz_prev,
            float* __restrict__ da, int B, int T_in, int C_in, int T_out, int C_out, int k,
            int s) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];
  __shared__ __align__(16) bf16 Bs[2][BN][LDS];
  const int j0 = blockIdx.z;
  const int F = (T_in - j0 + s - 1) / s;
  const long long M = static_cast<long long>(B) * F;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  if (F <= 0 || m0 >= M) return;  // the whole block: phases past j0 = 0 have fewer rows
  const int K = ((j0 < k) + (j0 + s < k)) * C_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * BN;

  const int col = (tid & 3) * 8;
  const bf16* a_src[2];
  const bf16* b_src[2];
  bool ok0[2], ok1[2], b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const long long m = m0 + row;
    const bool ok = m < M;
    const long long mm = ok ? m : 0;
    const int b = static_cast<int>(mm / F);
    const int f = static_cast<int>(mm - static_cast<long long>(b) * F);
    a_src[i] = dz + (static_cast<long long>(b) * T_out + f) * C_out;
    ok0[i] = ok && f < T_out;
    ok1[i] = ok && f >= 1 && f - 1 < T_out;
    const int n = n0 + row;
    b_ok[i] = n < C_in;
    b_src[i] = w + static_cast<long long>(b_ok[i] ? n : 0) * C_out;
  }

  auto load_tile = [&](int st, int k0) {
    const int kk = k0 + col;
    const int seg = kk >= C_out ? 1 : 0;  // C_out is a multiple of 8: a chunk sits in one segment
    const int nn = kk - seg * C_out;
    const long long tap = static_cast<long long>(j0 + seg * s) * C_in * C_out;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const bool oa = kk < K && (seg ? ok1[i] : ok0[i]);
      cp_async16(&As[st][row][col], oa ? a_src[i] + (nn - seg * C_out) : dz, oa);
      const bool ob = kk < K && b_ok[i];
      cp_async16(&Bs[st][row][col], ob ? b_src[i] + tap + nn : w, ob);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int KT = (K + BK - 1) / BK;  // 0 when no tap reaches phase j0 (k < s)
  if (KT > 0) {
    load_tile(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < KT) load_tile(st ^ 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      mma_stage(As[st], Bs[st], acc, wm, wn, g, t4);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int cn = n0 + wn * 64 + ni * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (m < M && cn < C_in) {
          const int b = static_cast<int>(m / F);
          const long long f = m - static_cast<long long>(b) * F;
          const long long idx = (static_cast<long long>(b) * T_in + f * s + j0) * C_in + cn;
          const float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
          if (z_prev != nullptr) {
            const __nv_bfloat162 zp = *reinterpret_cast<const __nv_bfloat162*>(z_prev + idx);
            __nv_bfloat162 o;
            o.x = __float2bfloat16(v0 * gelu_grad_tanh(__bfloat162float(zp.x)));
            o.y = __float2bfloat16(v1 * gelu_grad_tanh(__bfloat162float(zp.y)));
            *reinterpret_cast<__nv_bfloat162*>(dz_prev + idx) = o;
          } else {
            *reinterpret_cast<float2*>(da + idx) = make_float2(v0, v1);
          }
        }
      }
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

// ------------------------------------------------------------------ dW partials, bf16
// Block (x, y, z) sums frames [z * chunk_len, (z + 1) * chunk_len) of
//   part[z, kk, n] = sum_m A[m, kk] * dz[m, n],  A[m, kk] = a[b, f*s + kk / C_in, kk % C_in]
// for a 128 x 128 tile of (kk, n): A's rows are read in place, as in K1.
constexpr int WLD = BM + 8;  // 272-byte rows of the [frame][column] tiles

__global__ void __launch_bounds__(256)
bwd_dw_bf16(const bf16* __restrict__ a, const bf16* __restrict__ dz, float* __restrict__ part,
            int B, int T_in, int C_in, int T_out, int C_out, int k, int s, int chunk_len) {
  __shared__ __align__(16) bf16 As[2][BK][WLD];
  __shared__ __align__(16) bf16 Bs[2][BK][WLD];
  const int K = k * C_in;
  const long long r0 = static_cast<long long>(blockIdx.z) * chunk_len;
  const long long m_red = static_cast<long long>(B) * T_out;
  const long long r1 = r0 + chunk_len < m_red ? r0 + chunk_len : m_red;
  const int kk0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;

  // each thread copies two 8-element chunks of each operand per stage:
  // frame rows tid/16 and tid/16 + 16, columns (tid%16)*8
  const int lrow = tid >> 4, lcol = (tid & 15) * 8;
  auto load_tile = [&](int st, long long base) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = lrow + i * 16;
      const long long m = base + rr;
      const bool ok = m < r1;
      const long long mm = ok ? m : 0;
      const int b = static_cast<int>(mm / T_out);
      const long long f = mm - static_cast<long long>(b) * T_out;
      const bool oa = ok && kk0 + lcol < K, ob = ok && n0 + lcol < C_out;
      cp_async16(&As[st][rr][lcol],
                 oa ? a + (static_cast<long long>(b) * T_in + f * s) * C_in + kk0 + lcol : a, oa);
      cp_async16(&Bs[st][rr][lcol], ob ? dz + mm * C_out + n0 + lcol : dz, ob);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int KT = r1 > r0 ? static_cast<int>((r1 - r0 + BK - 1) / BK) : 0;
  if (KT > 0) {
    load_tile(0, r0);
    cp_async_commit();
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < KT) load_tile(st ^ 1, r0 + static_cast<long long>(kt + 1) * BK);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        const int c = ks + t4 * 2;  // frame index within the stage
        uint32_t af[2][4], bfr[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;  // kk within the tile
          af[mi][0] = pack2(As[st][c][r], As[st][c + 1][r]);
          af[mi][1] = pack2(As[st][c][r + 8], As[st][c + 1][r + 8]);
          af[mi][2] = pack2(As[st][c + 8][r], As[st][c + 9][r]);
          af[mi][3] = pack2(As[st][c + 8][r + 8], As[st][c + 9][r + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int n = wn * 64 + ni * 8 + g;
          bfr[ni][0] = pack2(Bs[st][c][n], Bs[st][c + 1][n]);
          bfr[ni][1] = pack2(Bs[st][c + 8][n], Bs[st][c + 9][n]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }
  }

  float* out = part + static_cast<long long>(blockIdx.z) * K * C_out;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int cn = n0 + wn * 64 + ni * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = kk0 + wm * 32 + mi * 16 + g + half * 8;
        if (kk < K && cn < C_out)
          *reinterpret_cast<float2*>(out + static_cast<long long>(kk) * C_out + cn) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
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

}  // namespace

// All entry points: dtype 0 = float32, 1 = bfloat16; tensors contiguous, in
// dtype unless marked fp32; layer (d = C_out, k, s) maps a (B, T_in, C_in) to
// (B, T_out, C_out). Each returns cudaGetLastError() after its launch.

// Up pass: z (pre-GELU, rounded to dtype) and a_next = gelu(z) from a; wt is
// the weight as (C_out, k, C_in). In bf16 it is K1's own launch
// (conv_layer_bf16, with the A view of K1's conv_layer); a tensor-map error
// comes back as its code.
extern "C" int conv_bwd_up(int dtype, const void* a, const void* wt, void* z, void* a_next,
                           int B, int T_in, int C_in, int T_out, int C_out, int k, int s,
                           long long off1, long long row_stride, long long batch_stride,
                           int cols0, int cols1, void* stream) {
  const long long M = static_cast<long long>(B) * T_out;
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return conv_layer_bf16(static_cast<const bf16*>(a), static_cast<const bf16*>(wt),
                           static_cast<bf16*>(a_next), static_cast<bf16*>(z), B, T_out, C_out,
                           AView{off1, row_stride, batch_stride, cols0, cols1}, st);
  } else if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM), (C_out + FBN - 1) / FBN);
    conv_layer_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(wt), nullptr, nullptr,
        static_cast<float*>(a_next), static_cast<float*>(z), T_in, C_in, T_out, C_out, K, s, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dz = g * gelu'(z) over n elements, g fp32.
extern "C" int conv_bwd_dz(int dtype, const void* g, const void* z, void* dz, long long n,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    bwd_dz<bf16><<<elementwise_blocks(n), 256, 0, st>>>(
        static_cast<const float*>(g), static_cast<const bf16*>(z), static_cast<bf16*>(dz), n);
  } else if (dtype == 0) {
    bwd_dz<float><<<elementwise_blocks(n), 256, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(z), static_cast<float*>(dz), n);
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
    dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), (C_in + BN - 1) / BN, s);
    bwd_da_bf16<<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(dz), static_cast<const bf16*>(w),
        static_cast<const bf16*>(z_prev), static_cast<bf16*>(dz_prev), static_cast<float*>(da),
        B, T_in, C_in, T_out, C_out, k, s);
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
// and dz (B, T_out, C_out); chunk c sums frames [c * chunk_len, ...).
extern "C" int conv_bwd_dw(int dtype, const void* a, const void* dz, void* part, int B,
                           int T_in, int C_in, int T_out, int C_out, int k, int s, int chunk_len,
                           int n_chunks, void* stream) {
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((K + BM - 1) / BM, (C_out + BN - 1) / BN, n_chunks);
    bwd_dw_bf16<<<grid, 256, 0, st>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(dz),
                                      static_cast<float*>(part), B, T_in, C_in, T_out, C_out, k,
                                      s, chunk_len);
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
