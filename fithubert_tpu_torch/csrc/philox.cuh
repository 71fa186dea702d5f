// Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), the generator of every dropout keep mask of the port. The plain
// PyTorch version is fithubert_tpu_torch/ops/kernels/philox.py (philox4x32);
// the two must stay the same function.
//
// An element is kept when the top 24 bits of its word are >= thr =
// floor(p * 2^24). Its word is a pure function of the element, so every
// kernel draws the same mask however it tiles:
//   attention probability (z = b * H + h, query i, key j): word j & 3 of
//     philox4x32((j >> 2, i, z, 0), (seed0, seed1)), one call per 4 keys of
//     a row (K2, K3, K4; flash_attention.keep_mask);
//   element e of a flat tensor: word e & 3 of
//     philox4x32((e >> 2, e >> 34, 0, 0), (seed0, seed1)), one call per 4
//     consecutive elements (K5; dropout.keep_flat).

#pragma once
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(uint4 w, int idx) {
  return idx == 0 ? w.x : idx == 1 ? w.y : idx == 2 ? w.z : w.w;
}
