// The conv-layer GEMM of the waveform front-end, shared by K1
// (conv_frontend.cu, the forward) and K6 (conv_frontend_bwd.cu, whose up
// pass recomputes each layer's pre-GELU sum z and output a with the same
// kernels, so the recomputed a equals K1's forward output bit for bit, and
// whose last layer writes dz = g * gelu'(z) in place of z and a): in bf16
// conv_layer_bf16 (wgmma fed by TMA), in fp32 conv_layer_f32 (FMA). The
// design notes are in conv_frontend.cu. The mbarrier, TMA and wgmma helpers
// are hopper.cuh's.

#pragma once
#include "hopper.cuh"
#include "mma.cuh"

namespace {

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// The tanh-form GELU as 0.5 x (1 + tanh(u)) = x / (1 + exp(-2u)), the
// exponential and the reciprocal on the special-function units: within a
// few fp32 ulps of the tanhf form, in about a third of its instructions
// (K1's epilogue and prefix pass evaluate it on every element they write).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);  // sqrt(2 / pi) (...)
  return __fdividef(x, 1.f + __expf(-2.f * u));  // x / inf = -0 for very negative x
}

// d/dx of the exact-erf GELU: Phi(x) + x phi(x) (conv_frontend_bwd.py:68).
__device__ __forceinline__ float gelu_grad_exact(float x) {
  const float phi = expf(-0.5f * x * x) * 0.3989422804014327f;  // 1 / sqrt(2 pi)
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) + x * phi;
}

// d/dx of the tanh-form GELU (conv_frontend_bwd.py:75), 0.5 (1 + t) +
// 0.5 x (1 - t^2) u' with t = tanh(u), u = sqrt(2 / pi) (x + 0.044715 x^3),
// written with sg = (1 + t) / 2 = 1 / (1 + 2^(x (A + B x^2))) as
// sg + x sg (1 - sg) 2u': nine fp32 operations and two special-function
// ones (K6's da epilogue evaluates it on every element it writes).
__device__ __forceinline__ float gelu_grad_tanh(float x) {
  constexpr float A = -2.f * 0.79788456080286536f * 1.4426950408889634f;  // -2 sqrt(2/pi) log2(e)
  constexpr float B = A * 0.044715f;
  constexpr float C = 2.f * 0.79788456080286536f, D = C * 0.134145f;  // 2u' = C + D x^2
  const float x2 = x * x;
  float e, sg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * fmaf(B, x2, A)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(sg) : "f"(1.f + e));  // 1 / inf = 0
  return fmaf(x * sg * (1.f - sg), fmaf(D, x2, C), sg);
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

// ------------------------------------------------------------------ bf16, K1's GEMM
// Y = gelu_tanh(round_bf16(A Wt^T)) (and z = round_bf16(A Wt^T) if asked) on
// wgmma, fed by TMA. The design notes are in conv_frontend.cu.
constexpr int WBM = 128, WBN = 128, WBK = 64;  // WBK bf16 = 128 bytes: one swizzle row
// A 64-deep chunk is 0.28 us of tensor-core work for a 128 x 128 tile, under
// a load's latency from HBM: the ring keeps six in flight.
constexpr int STAGES = 6;
constexpr int A_BYTES = WBM * WBK * 2, STAGE_BYTES = (WBM + WBN) * WBK * 2;
constexpr int ZBUF = 64 * WBN * 2;  // a consumer warpgroup's 64 x 128 rounded sums, bf16
// the ring (6 x 32 KB), the two hand-off buffers and room to align the ring
// to 1024 bytes: 225 KB, one block per SM
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 2 * ZBUF + 1024;
// 8 consumer warps, 1 producer warp, 8 epilogue warps
constexpr int CONSUMER_WARPS = 8, EPI_WARPS = 8;
constexpr int WG_THREADS = 32 * (CONSUMER_WARPS + 1 + EPI_WARPS);

// A consumer warpgroup's 64 x 128 sums into shared memory, rounded to bf16
// before the GELU as the XLA oracle's conv output is (conv_frontend.py
// :254-258): two 64 x 64 boxes in the 128-byte swizzle (16-byte chunk c of row
// r at chunk c ^ (r % 8), so the 8 rows of a warp's store hit distinct banks),
// as TMA stores them.
__device__ __forceinline__ void stage_z(const float (&d)[64], uint32_t buf, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < WBN / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (warp & 3) * 16 + (lane >> 2) + 8 * half;  // row of the warpgroup's 64
      const uint32_t off = (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) + (lane & 3) * 4;
      __nv_bfloat162 v;
      v.x = __float2bfloat16(d[4 * j + 2 * half]);
      v.y = __float2bfloat16(d[4 * j + 2 * half + 1]);
      st_shared_u32(buf + off, *reinterpret_cast<uint32_t*>(&v));
    }
  }
}

// A persistent grid, one block per SM: block i takes output tiles i, i +
// gridDim.x, ...; a tile is (batch b, 128 frames, 128 channels), channel
// tiles fastest, so the blocks running at one time share A tiles in the L2.
// One producer warp fills the ring; 8 consumer warps (two warpgroups, 64
// frames each) run the products, round the sums to bf16 and hand them over in
// shared memory; 8 epilogue warps apply the GELU and store by TMA while the
// consumers run the next tile's products.
// amap0 and amap1 are the two tap groups of the A operand (K columns
// [0, cols0) and [cols0, K)), each a (cols, T_out, B) view of the input;
// wmap is Wt (N, K); ymap and zmap are the outputs (N, T_out, B), written by
// TMA (zmap only when has_z). With DZ, ymap takes dz = g * gelu'(z) in
// place of gelu(z), g (B, T_out, N) fp32 (K6's last layer); a template
// argument, so that K1's own epilogue carries no branch for it.
template <bool DZ>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv_layer_wgmma(const __grid_constant__ CUtensorMap amap0,
                 const __grid_constant__ CUtensorMap amap1,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap ymap,
                 const __grid_constant__ CUtensorMap zmap, int has_z,
                 const float* __restrict__ g, int T_out, int N, int K, int cols0, int n_tiles,
                 int f_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], zfull[2], zempty[2];
  // the ring's stage s at ring + s * STAGE_BYTES, then the two hand-off buffers
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KC = K / WBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);                // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), CONSUMER_WARPS);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(smem_u32(&zfull[w]), 128);  // one arrival per thread of warpgroup w
      mbar_init(smem_u32(&zempty[w]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;  // chunks loaded so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * WBN, f0 = (tile / n_tiles % f_tiles) * WBM;
        const int b = tile / n_tiles / f_tiles;
        for (int kc = 0; kc < KC; ++kc, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), ((it / STAGES) - 1) & 1);
          const uint32_t fb = smem_u32(&full[s]), sa = ring + s * STAGE_BYTES;
          mbar_expect_tx(fb, STAGE_BYTES);
          const int kk = kc * WBK;  // a K chunk lies in one tap group: cols0 % WBK == 0
          if (kk < cols0)
            tma_load_3d(sa, &amap0, fb, kk, f0, b);
          else
            tma_load_3d(sa, &amap1, fb, kk - cols0, f0, b);
          tma_load_2d(sa + A_BYTES, &wmap, fb, kk, n0);
        }
      }
    }
    return;
  }

  const uint32_t zbase = ring + STAGES * STAGE_BYTES;  // ZBUF per consumer warpgroup
  if (warp > CONSUMER_WARPS) {
    // the epilogue warps: for each tile and warpgroup, z (K6's up pass) as it
    // is, then y = gelu(z) (or dz = g * gelu'(z)) in place, both stored by
    // TMA, which clips frames past T_out and channels past N; once TMA has
    // read the buffer it goes back to its warpgroup
    const int et = threadIdx.x - 32 * (CONSUMER_WARPS + 1);
    int ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
      const int n0 = (tile % n_tiles) * WBN, f0 = (tile / n_tiles % f_tiles) * WBM;
      const int b = tile / n_tiles / f_tiles;
      for (int w = 0; w < 2; ++w) {
        const uint32_t buf = zbase + w * ZBUF;
        const int fr = f0 + 64 * w;
        mbar_wait(smem_u32(&zfull[w]), ti & 1);
        auto store = [&](const CUtensorMap* map) {
          if (et == 0) {
            if (fr < T_out)
              for (int q = 0; q < WBN / 64 && n0 + 64 * q < N; ++q)
                tma_store_3d(map, buf + q * 8192, n0 + 64 * q, fr, b);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          }
        };
        if (has_z) {
          store(&zmap);
          asm volatile("bar.sync 1, %0;\n" ::"n"(32 * EPI_WARPS) : "memory");
        }
#pragma unroll
        for (int i = et; i < ZBUF / 16; i += 32 * EPI_WARPS) {  // 16 bytes at a time
          uint4 v;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(buf + 16 * i) : "memory");
          bf16* e = reinterpret_cast<bf16*>(&v);
          if constexpr (DZ) {
            // chunk i of the two swizzled 64 x 64 boxes: box i / 512, row
            // (i / 8) % 64, logical 8-column chunk (i % 8) ^ (row % 8)
            const int r = (i >> 3) & 63;
            const int f = fr + r, n = n0 + 64 * (i >> 9) + 8 * ((i & 7) ^ (r & 7));
            if (f < T_out && n < N) {  // what lies past them TMA does not store
              const float4* gp =
                  reinterpret_cast<const float4*>(g + (static_cast<long long>(b) * T_out + f) * N + n);
              const float4 g0 = __ldg(gp), g1 = __ldg(gp + 1);
              const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
              for (int k = 0; k < 8; ++k)
                e[k] = __float2bfloat16(gv[k] * gelu_grad_tanh(__bfloat162float(e[k])));
            }
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(gelu_tanh(__bfloat162float(e[k])));
          }
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(buf + 16 * i), "r"(v.x),
                       "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
        }
        fence_proxy_async();  // visible to TMA
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * EPI_WARPS) : "memory");
        store(&ymap);
        if (et == 0) mbar_arrive(smem_u32(&zempty[w]));
      }
    }
    if (et == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // the consumers: warpgroup wg owns frames f0 + 64 wg .. + 63 of each tile
  // and hands its rounded sums to the epilogue warps at zbase + wg * ZBUF
  const int wg = warp >> 2;
  const uint32_t zb = zbase + wg * ZBUF;
  int it = 0, ti = 0;  // chunks consumed so far, tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kc = 0; kc < KC; ++kc, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
      const uint32_t sa = ring + s * STAGE_BYTES;
      const uint64_t da = sw128_desc(sa + wg * (64 * WBK * 2)), db = sw128_desc(sa + A_BYTES);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < WBK / 16; ++k16) wgmma_m64n128k16(d, da + 2 * k16, db + 2 * k16);
      wgmma_commit();
      if (kc > 0) {  // the products of the previous chunk are done: free its stage
        wgmma_wait<1>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

    // hand the sums over once the epilogue warps are done with the last ones
    if (ti > 0) mbar_wait(smem_u32(&zempty[wg]), (ti - 1) & 1);
    stage_z(d, zb, warp, lane);
    fence_proxy_async();  // z's TMA store reads it
    mbar_arrive(smem_u32(&zfull[wg]));
  }
}

// The A operand of a layer (d, k, s) on X (B, T_in, C_in), as the wrapper
// computes it (conv_frontend.py a_operand_view): tap group g is the
// (B, T_out, cols_g) view of X's storage at element offset off_g (off_0 = 0)
// with strides (batch_stride, row_stride, 1), and A[b, f] = [group 0 |
// group 1]. Neither view overlaps itself, and every element either reads
// lies in X[b] of its own batch row.
struct AView {
  long long off1, row_stride, batch_stride;
  int cols0, cols1;
};

// K1's bf16 layer GEMM, shared with K6's up pass so that both launch one
// kernel on one tile geometry: y = gelu(z) (B, T_out, N) and, if z is not
// null, z itself; or, if g (B, T_out, N) fp32 is not null, y = dz = g *
// gelu'(z) and no z. wt is (N, K) with K = cols0 + cols1, every width a
// multiple of WBK (the wrapper checks). Returns 0 or an error code.
int conv_layer_bf16(const bf16* x, const bf16* wt, bf16* y, bf16* z, const float* g, int B,
                    int T_out, int N, AView av, cudaStream_t stream) {
  const int K = av.cols0 + av.cols1;
  CUtensorMap amap0, amap1, wmap;
  const cuuint64_t astrides[2] = {static_cast<cuuint64_t>(av.row_stride) * 2,
                                  static_cast<cuuint64_t>(av.batch_stride) * 2};
  const cuuint32_t abox[3] = {WBK, WBM, 1}, wbox[2] = {WBK, WBN};
  const cuuint64_t adims0[3] = {static_cast<cuuint64_t>(av.cols0),
                                static_cast<cuuint64_t>(T_out), static_cast<cuuint64_t>(B)};
  int err = encode_map(&amap0, x, 3, adims0, astrides, abox);
  if (err != 0) return err;
  amap1 = amap0;
  if (av.cols1 > 0) {
    const cuuint64_t adims1[3] = {static_cast<cuuint64_t>(av.cols1),
                                  static_cast<cuuint64_t>(T_out), static_cast<cuuint64_t>(B)};
    err = encode_map(&amap1, x + av.off1, 3, adims1, astrides, abox);
    if (err != 0) return err;
  }
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  err = encode_map(&wmap, wt, 2, wdims, wstrides, wbox);
  if (err != 0) return err;
  CUtensorMap ymap, zmap;
  const cuuint64_t odims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(T_out),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t ostrides[2] = {static_cast<cuuint64_t>(N) * 2,
                                  static_cast<cuuint64_t>(N) * T_out * 2};
  const cuuint32_t obox[3] = {64, 64, 1};
  err = encode_map(&ymap, y, 3, odims, ostrides, obox);
  if (err != 0) return err;
  zmap = ymap;
  if (z != nullptr && (err = encode_map(&zmap, z, 3, odims, ostrides, obox)) != 0) return err;

  const bool dz = g != nullptr;
  auto kernel = dz ? conv_layer_wgmma<true> : conv_layer_wgmma<false>;
  static bool smem_set[2] = {false, false};  // above 48 KB only after opting in, once per process
  if (!smem_set[dz]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dz] = true;
  }
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const int n_tiles = (N + WBN - 1) / WBN, f_tiles = (T_out + WBM - 1) / WBM;
  const long long tiles = static_cast<long long>(B) * f_tiles * n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<blocks, WG_THREADS, WG_SMEM, stream>>>(
      amap0, amap1, wmap, ymap, zmap, z != nullptr, g, T_out, N, K, av.cols0, n_tiles, f_tiles,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
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
               float* __restrict__ y, float* __restrict__ z, const float* __restrict__ g,
               int T_in, int C_in, int T_out, int N, int K, int s, long long M) {
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
      if (r < M && cn < N) {  // with g: y is K6's dz = g * gelu'(z)
        y[r * N + cn] = g != nullptr ? g[r * N + cn] * gelu_grad_exact(acc[i][j])
                                     : gelu_exact(acc[i][j]);
        if (z != nullptr) z[r * N + cn] = acc[i][j];
      }
    }
  }
}

}  // namespace
