// Conv blocks 1..N of the waveform front-end, one launch per layer.
//
// Replaces: fithubert_tpu/ops/pallas/conv_frontend.py, the Pallas kernel
//   _make_kernel (:112) run by _pallas_stack (:262) for fused_conv_stack
//   (:309) and fused_conv_stack_gn (:397).
//
// Bound on the H100: a layer (d, k, s) with input X (B, T_in, C_in) is the
//   GEMM  Y[m, n] = gelu(sum_K A[m, K] * Wt[n, K])  with m = (b, f) over
//   B * T_out output frames and K = k * C_in. The teacher's layers (C_in =
//   512, K = 1024-1536) are bound by operations: its train stack is ~702
//   GFLOP, 0.71 ms at the bf16 tensor-core peak. The student's first layers
//   are bound by bytes: (256, 1, 1) on C_in = 128 does 128 multiply-adds per
//   output element and moves ~354 MB at the train shape (0.106 ms at 3.35
//   TB/s), and every layer writes its output back, so its train stack needs
//   ~0.34 ms where its operations alone need 0.23.
//
// Design: in bf16 (every main path), a Hopper GEMM per layer.
//   - Operands by TMA. The k input rows that frame f reads, X[b, f*s ..
//     f*s+k-1, :], lie contiguously, so A needs no im2col copy. Taps j < s
//     are the first min(k, s) * C_in elements of the "pair row" f of X[b]
//     (rows of s * C_in elements); taps j >= s are the first (k - s) * C_in
//     of pair row f + 1. Each group is a 3-D tensor map (cols, T_out, B)
//     with row stride s * C_in and batch stride T_in * C_in: no view
//     overlaps itself, no element it covers lies past X[b]'s last frame
//     (so the partial last pair row at odd T_in is read only where it is
//     valid), and frames past T_out are zero-filled by TMA. The batch
//     dimension keeps every 128-frame tile inside one batch row. The
//     wrapper computes the two views (conv_frontend.py a_operand_view) and
//     checks that every width is a multiple of 64, so a 64-wide K chunk lies
//     in one group and one 128-byte swizzle row. Wt (C_out, k * C_in) is
//     K-major, a 2-D map.
//   - Block: a persistent grid of one block per SM, each walking output
//     tiles (b, 128 frames, 128 channels), channel tiles fastest so the
//     blocks in flight share A tiles in the L2; 17 warps in three roles. One
//     producer thread keeps a six-stage ring of 32 KB stages full across
//     tiles (TMA with the 128-byte swizzle, one mbarrier per stage for
//     "full" and one for "empty"). Two consumer warpgroups each run
//     wgmma.mma_async m64n128k16 (bf16 in, fp32 sums) on 64 frames, reading
//     both operands K-major from shared memory and keeping one chunk of
//     products in flight; a 64-deep chunk is 0.28 us of tensor-core work,
//     under a load's latency from HBM, so the ring must be deep. At a tile's
//     end each warpgroup rounds its sums to bf16 into a 16 KB hand-off
//     buffer (the 128-byte swizzle: no bank conflicts) and goes on to the
//     next tile's products. Eight epilogue warps then store z (K6's up pass
//     only), apply the GELU in place and store y, both by TMA, which clips
//     frames past T_out: no per-element bounds tests. 225 KB of shared
//     memory in all.
//   - Why three roles: the epilogue's GELU takes two special-function
//     operations per output, and when the consumers ran it themselves the
//     tensor cores idled through it (on the card, a build without the GELU
//     ran the stacks clearly faster). Handed to warps of their own, it runs
//     under the next tile's products and loads. The epilogue is the GELU of
//     the XLA oracle (:254-258): the sum rounded to bf16, GELU in fp32 (the
//     tanh form as x / (1 + exp(-2u))), rounded again.
//   - The block-0 GroupNorm + GELU prefix of the first layer is a kernel
//     of its own (gn_prefix_bf16, entry gn_prefix, launched by the wrapper
//     before the first layer): it reads X once and writes a0 once (2 * 472
//     MB for the teacher's train input, 2 * 118 MB for the student's).
//     Applying it to each swizzled A chunk in shared memory instead
//     (fenced to the async proxy before the wgmma) was built and measured
//     on the card, in a version whose consumers ran the epilogue
//     themselves: no faster for the student's (256, 1, 1) layer, and slower
//     for the teacher's (512, 3, 2), where it redoes the GELU for each
//     channel tile and for the overlapping taps.
//   Unlike the TPU kernel, which keeps all eight layers' weights (~4 MB)
//   resident and runs the whole stack per 32-frame tile, this writes each
//   layer's output back; fusing layers is later work.
//
// fp32 (only the card-vs-CPU checks, held to 2e-3 end to end): the FMA GEMM
//   of the port's first version with cp.async staging and the prefix applied
//   to each A tile in shared memory; the tensor cores would take fp32 only
//   as TF32.

#include "conv_gemm.cuh"

namespace {

// The block-0 GroupNorm + GELU prefix as its own pass over x (B, T, C) bf16,
// 8 elements (16 bytes) per step: a0 = gelu_tanh(x * scale[b, c] + shift[b, c]),
// rounded as prefix_in_place rounds.
__global__ void __launch_bounds__(256)
gn_prefix_bf16(const bf16* __restrict__ x, const bf16* __restrict__ scale,
               const bf16* __restrict__ shift, bf16* __restrict__ a0, long long n_vec,
               long long batch_vecs, int C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < n_vec;
       e += stride) {
    uint4 v = reinterpret_cast<const uint4*>(x)[e];
    const int b = static_cast<int>(e / batch_vecs);
    prefix_in_place<bf16, 8>(reinterpret_cast<bf16*>(&v), static_cast<int>((8 * e) % C), b, C,
                             scale, shift);
    reinterpret_cast<uint4*>(a0)[e] = v;
  }
}

}  // namespace

// a0 = gelu_tanh(x * scale + shift) for bf16 x and a0 (B, T, C), scale and
// shift (B, C), all contiguous; C a multiple of 8. Returns
// cudaGetLastError() after the launch.
extern "C" int gn_prefix(const void* x, const void* scale, const void* shift, void* a0, int B,
                         int T, int C, void* stream) {
  const long long n_vec = static_cast<long long>(B) * T * C / 8;
  const long long blocks = (n_vec + 255) / 256;
  gn_prefix_bf16<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), static_cast<bf16*>(a0), n_vec,
      static_cast<long long>(T) * C / 8, C);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. x (B, T_in, C_in), wt (C_out, k, C_in),
// y (B, T_out, C_out); all contiguous, in dtype. scale/shift (B, C_in), the
// prefix applied to each A tile, are fp32 only (bf16 runs gn_prefix first):
// bf16 with a scale returns cudaErrorInvalidValue. bf16 only:
// (off1, row_stride, batch_stride, cols0, cols1) is the A operand's view
// (AView). Returns cudaGetLastError() after the launch, or a tensor-map
// error code (hopper.cuh TMA_ERROR).
extern "C" int conv_layer(int dtype, const void* x, const void* wt, const void* scale,
                          const void* shift, void* y, int B, int T_in, int C_in, int T_out,
                          int C_out, int k, int s, long long off1, long long row_stride,
                          long long batch_stride, int cols0, int cols1, void* stream) {
  const long long M = static_cast<long long>(B) * T_out;
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (scale != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return conv_layer_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                           static_cast<bf16*>(y), nullptr, nullptr, B, T_out, C_out,
                           AView{off1, row_stride, batch_stride, cols0, cols1}, st);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM), (C_out + FBN - 1) / FBN);
  conv_layer_f32<<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), nullptr, nullptr, T_in, C_in, T_out, C_out, K, s, M);
  return static_cast<int>(cudaGetLastError());
}
