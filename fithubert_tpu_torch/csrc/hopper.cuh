// Hopper's asynchronous building blocks, shared by the bf16 kernels that
// run on wgmma fed by TMA: K1 and K6 (conv_gemm.cuh, conv_frontend_bwd.cu),
// the attention kernels (flash_attention*.cu) and the positional conv
// (pos_conv.cu).
//   - mbarriers: a phase completes when its arrivals and the bytes TMA was
//     told to expect (expect_tx) have all come in; waits spin on a parity;
//   - TMA: one thread copies a 2- to 4-D box between device memory and
//     shared memory, rows past a tensor's edge zero-filled on loads and
//     skipped on stores; loads report to an mbarrier;
//   - wgmma: a warpgroup's asynchronous 64 x N x 16 bf16 product with fp32
//     sums in registers, A from shared memory (wgmma_ss) or from registers
//     (wgmma_rs), B from shared memory, both described by 64-bit
//     descriptors of 128-byte-swizzled tiles (sw128_desc, sw128_mn_desc);
//   - the tensor-map encoder, fetched from the CUDA driver at run time.
// The wgmma accumulator layout: thread (warp w of the warpgroup, lane l)
// holds, for each n8 block j, d[4j], d[4j+1] at row 16w + l/4, columns
// 8j + 2(l%4) + {0, 1}, and d[4j+2], d[4j+3] 8 rows below. A from registers
// is, per warp, an mma.sync m16n8k16 A fragment of its 16 rows (mma.cuh).

#pragma once
#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver's entry is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also tells the phase to expect `bytes` more from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// Shared-memory writes of this thread visible to the async proxy (TMA
// stores, wgmma operands) after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle, as TMA writes it: 8-row core groups 1024 bytes apart (SBO), the
// leading offset unused, the tile based on 1024 bytes. Adding 2 moves the
// start 32 bytes (one k16 step) along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma descriptor of an M- / N-major operand as TMA writes [k][64
// columns] boxes under the 128-byte swizzle: a k row's 64 columns are one
// 128-byte row, 8-row core groups lie 1024 bytes apart (SBO), the next 64
// columns lie `lbo` bytes on (LBO, the box's size). A k16 step is 16 rows:
// 2048 bytes, 128 in the descriptor. The start may lie inside a row (a
// column offset), as long as the columns read stay inside its box.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments that an asynchronous product reads from
// registers: they stay live, unchanged, up to the fence after its wait.
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x N), bf16, for
// N = 8, 16, ..., 128: wgmma_ss with A and B in shared memory, K-major
// (TRANS = 0) or M- / N-major (TRANS = 1, the descriptor's transpose bit);
// wgmma_rs with A from four registers per thread. The asm lists every
// accumulator register, so one instruction is spelt out per N below.
#define WG_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_REGS_8 "%0, %1, %2, %3"
#define WG_REGS_16 WG_REGS_8 ", %4, %5, %6, %7"
#define WG_REGS_24 WG_REGS_16 ", %8, %9, %10, %11"
#define WG_REGS_32 WG_REGS_24 ", %12, %13, %14, %15"
#define WG_REGS_40 WG_REGS_32 ", %16, %17, %18, %19"
#define WG_REGS_48 WG_REGS_40 ", %20, %21, %22, %23"
#define WG_REGS_56 WG_REGS_48 ", %24, %25, %26, %27"
#define WG_REGS_64 WG_REGS_56 ", %28, %29, %30, %31"
#define WG_REGS_72 WG_REGS_64 ", %32, %33, %34, %35"
#define WG_REGS_80 WG_REGS_72 ", %36, %37, %38, %39"
#define WG_REGS_88 WG_REGS_80 ", %40, %41, %42, %43"
#define WG_REGS_96 WG_REGS_88 ", %44, %45, %46, %47"
#define WG_REGS_104 WG_REGS_96 ", %48, %49, %50, %51"
#define WG_REGS_112 WG_REGS_104 ", %52, %53, %54, %55"
#define WG_REGS_120 WG_REGS_112 ", %56, %57, %58, %59"
#define WG_REGS_128 WG_REGS_120 ", %60, %61, %62, %63"
#define WG_ACC_8 WG_ACC4(0)
#define WG_ACC_16 WG_ACC_8, WG_ACC4(4)
#define WG_ACC_24 WG_ACC_16, WG_ACC4(8)
#define WG_ACC_32 WG_ACC_24, WG_ACC4(12)
#define WG_ACC_40 WG_ACC_32, WG_ACC4(16)
#define WG_ACC_48 WG_ACC_40, WG_ACC4(20)
#define WG_ACC_56 WG_ACC_48, WG_ACC4(24)
#define WG_ACC_64 WG_ACC_56, WG_ACC4(28)
#define WG_ACC_72 WG_ACC_64, WG_ACC4(32)
#define WG_ACC_80 WG_ACC_72, WG_ACC4(36)
#define WG_ACC_88 WG_ACC_80, WG_ACC4(40)
#define WG_ACC_96 WG_ACC_88, WG_ACC4(44)
#define WG_ACC_104 WG_ACC_96, WG_ACC4(48)
#define WG_ACC_112 WG_ACC_104, WG_ACC4(52)
#define WG_ACC_120 WG_ACC_112, WG_ACC4(56)
#define WG_ACC_128 WG_ACC_120, WG_ACC4(60)

template <int N, int TRANS_A, int TRANS_B>
struct WgmmaSS;
template <int N, int TRANS_B>
struct WgmmaRS;

#define WGMMA_SS(N, A, B, S, TA, TB)                                                          \
  template <int TRANS_A, int TRANS_B>                                                         \
  struct WgmmaSS<N, TRANS_A, TRANS_B> {                                                       \
    static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db,            \
                                               int scale_d) {                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_REGS_##N   \
                   "}, %" #A ", %" #B ", p, 1, 1, %" #TA ", %" #TB ";\n}\n"                    \
                   : WG_ACC_##N                                                               \
                   : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));             \
    }                                                                                         \
  };
#define WGMMA_RS(N, A0, A1, A2, A3, B, S, TB)                                                 \
  template <int TRANS_B>                                                                      \
  struct WgmmaRS<N, TRANS_B> {                                                                \
    static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t db,      \
                                               int scale_d) {                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" WG_REGS_##N   \
                   "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, %" #TB     \
                   ";\n}\n"                                                                   \
                   : WG_ACC_##N                                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),       \
                     "n"(TRANS_B));                                                           \
    }                                                                                         \
  };
WGMMA_SS(8, 4, 5, 6, 7, 8)
WGMMA_SS(16, 8, 9, 10, 11, 12)
WGMMA_SS(24, 12, 13, 14, 15, 16)
WGMMA_SS(32, 16, 17, 18, 19, 20)
WGMMA_SS(40, 20, 21, 22, 23, 24)
WGMMA_SS(48, 24, 25, 26, 27, 28)
WGMMA_SS(56, 28, 29, 30, 31, 32)
WGMMA_SS(64, 32, 33, 34, 35, 36)
WGMMA_SS(72, 36, 37, 38, 39, 40)
WGMMA_SS(80, 40, 41, 42, 43, 44)
WGMMA_SS(88, 44, 45, 46, 47, 48)
WGMMA_SS(96, 48, 49, 50, 51, 52)
WGMMA_SS(104, 52, 53, 54, 55, 56)
WGMMA_SS(112, 56, 57, 58, 59, 60)
WGMMA_SS(120, 60, 61, 62, 63, 64)
WGMMA_SS(128, 64, 65, 66, 67, 68)
WGMMA_RS(8, 4, 5, 6, 7, 8, 9, 10)
WGMMA_RS(16, 8, 9, 10, 11, 12, 13, 14)
WGMMA_RS(24, 12, 13, 14, 15, 16, 17, 18)
WGMMA_RS(32, 16, 17, 18, 19, 20, 21, 22)
WGMMA_RS(40, 20, 21, 22, 23, 24, 25, 26)
WGMMA_RS(48, 24, 25, 26, 27, 28, 29, 30)
WGMMA_RS(56, 28, 29, 30, 31, 32, 33, 34)
WGMMA_RS(64, 32, 33, 34, 35, 36, 37, 38)
WGMMA_RS(72, 36, 37, 38, 39, 40, 41, 42)
WGMMA_RS(80, 40, 41, 42, 43, 44, 45, 46)
WGMMA_RS(88, 44, 45, 46, 47, 48, 49, 50)
WGMMA_RS(96, 48, 49, 50, 51, 52, 53, 54)
WGMMA_RS(104, 52, 53, 54, 55, 56, 57, 58)
WGMMA_RS(112, 56, 57, 58, 59, 60, 61, 62)
WGMMA_RS(120, 60, 61, 62, 63, 64, 65, 66)
WGMMA_RS(128, 64, 65, 66, 67, 68, 69, 70)
#undef WGMMA_SS
#undef WGMMA_RS

template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d = 1) {
  WgmmaSS<N, TRANS_A, TRANS_B>::run(d, da, db, scale_d);
}
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  WgmmaRS<N, TRANS_B>::run(d, a, db, scale_d);
}
// d (64 x 128) += A (64 x 16) B (16 x 128), both from shared memory (K1, K6).
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_ss<128, TRANS_A, TRANS_B>(d, da, db, 1);
}

// Non-zero codes a launch returns besides cudaError_t: a tensor map that
// cuTensorMapEncodeTiled refused (TMA_ERROR + its CUresult), or a CUDA driver
// without it.
constexpr int TMA_ERROR = 100000, TMA_MISSING = 200000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map of rank 2 to 5 with 128-byte swizzled boxes (or, given
// CU_TENSOR_MAP_SWIZZLE_NONE, boxes laid out densely, row after row): loads
// fill zeros outside dims, stores skip what lies outside. strides in bytes,
// for dims 1.. only.
int encode_map(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static EncodeTiledFn encode = nullptr;  // cuTensorMapEncodeTiled, from the CUDA driver: no -lcuda
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return TMA_MISSING;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TMA_ERROR + static_cast<int>(res);
}

// The card's SM count, asked once per process.
int sm_count(int* sms) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *sms = count;
  return 0;
}

}  // namespace
