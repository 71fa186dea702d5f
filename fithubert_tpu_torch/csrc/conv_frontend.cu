// Conv blocks 1..N of the waveform front-end, one launch per layer.
//
// Replaces: fithubert_tpu/ops/pallas/conv_frontend.py, the Pallas kernel
//   _make_kernel (:112) run by _pallas_stack (:262) for fused_conv_stack
//   (:309) and fused_conv_stack_gn (:397).
//
// Bound on the H100: operations. One 16 s utterance of the FitHuBERT student
//   stack is ~25.6 GFLOP against ~13 MB of bf16 input, far above the ~295
//   FLOP/byte at which bf16 tensor cores stop waiting on memory.
//
// Design: a layer (d, k, s) with input X (B, T_in, C_in) row-major is the
//   GEMM  Y[m, n] = gelu(sum_K A[m, K] * Wt[n, K])  with m = (b, f) over
//   B * T_out output frames and K = k * C_in, because the k input rows that
//   output frame f reads, X[b, f*s .. f*s+k-1, :], lie contiguously in
//   memory: A is X read with a row stride of s * C_in, no im2col copy. Wt is
//   the weight laid out (C_out, k, C_in). Each 256-thread block owns a tile
//   of output frames x output channels, stages A and Wt tiles through shared
//   memory with cp.async (two stages, so the next tile loads while the
//   tensor cores work on this one), accumulates in fp32 with
//   mma.sync m16n8k16 (bf16) or fp32 FMA (fp32), and applies GELU in the
//   epilogue. The block-0 GroupNorm + GELU prefix of the first layer is
//   applied to each A tile in shared memory right after it lands, so the
//   normalized block-0 activation never goes to device memory. Unlike the
//   TPU kernel, which keeps all eight layers' weights (~4 MB) resident and
//   runs the whole stack per 32-frame tile, this writes each layer's output
//   back (in the compute dtype, the rounding of the XLA oracle); fusing
//   layers, wgmma and TMA are later work.

#include "conv_gemm.cuh"

// dtype: 0 = float32, 1 = bfloat16. x (B, T_in, C_in), wt (C_out, k, C_in),
// optional scale/shift (B, C_in), y (B, T_out, C_out); all contiguous, in
// dtype. Returns cudaGetLastError() after the launch.
extern "C" int conv_layer(int dtype, const void* x, const void* wt, const void* scale,
                          const void* shift, void* y, int B, int T_in, int C_in, int T_out,
                          int C_out, int k, int s, void* stream) {
  const long long M = static_cast<long long>(B) * T_out;
  const int K = k * C_in;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (C_out + BN - 1) / BN);
    conv_layer_bf16<<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
        static_cast<const bf16*>(scale), static_cast<const bf16*>(shift),
        static_cast<bf16*>(y), nullptr, T_in, C_in, T_out, C_out, K, s, M);
  } else if (dtype == 0) {
    dim3 grid(static_cast<unsigned>((M + FBM - 1) / FBM), (C_out + FBN - 1) / FBN);
    conv_layer_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<float*>(y), nullptr, T_in, C_in, T_out, C_out, K, s, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
