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
//     a row (K2 and the backward; flash_attention.keep_mask; the backward
//     draws it through PhiloxRow, K2 through PhiloxQuery, the same function);
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

// philox4x32((x, i, z, 0), (seed0, seed1)) for a thread whose x and z stay
// fixed while i varies (the fused attention backward: x its key group, z
// its (b, h)): what the first three rounds compute without i, and the key
// schedule of the other seven, are computed once. Round 0 then costs one
// xor, rounds 1 and 2 one 32 x 32 product each, rounds 3-9 two.
struct PhiloxRow {
  uint32_t x1, z2, x3, z3, w3;  // the parts of rounds 0-2 free of i
  uint32_t k0[7], k1[7];        // the keys of rounds 3-9

  __device__ __forceinline__ PhiloxRow(uint32_t x, uint32_t z, uint32_t s0, uint32_t s1) {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u, W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
    // round 0 on (x, i, z, 0): (M1 z)_hi ^ i ^ k0, (M1 z)_lo, (M0 x)_hi ^ k1, (M0 x)_lo
    x1 = __umulhi(M1, z) ^ s0;
    const uint32_t y1 = M1 * z, z1 = __umulhi(M0, x) ^ s1, w1 = M0 * x;
    // round 1: (M1 z1)_hi ^ y1 ^ k0, (M1 z1)_lo, (M0 x1')_hi ^ w1 ^ k1, (M0 x1')_lo
    const uint32_t x2 = __umulhi(M1, z1) ^ y1 ^ (s0 + W0), y2 = M1 * z1;
    z2 = w1 ^ (s1 + W1);
    // round 2: (M1 z2')_hi ^ y2 ^ k0, (M1 z2')_lo, (M0 x2)_hi ^ w2' ^ k1, (M0 x2)_lo
    x3 = y2 ^ (s0 + 2 * W0);
    z3 = __umulhi(M0, x2) ^ (s1 + 2 * W1);
    w3 = M0 * x2;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      k0[r] = s0 + (r + 3) * W0;
      k1[r] = s1 + (r + 3) * W1;
    }
  }

  __device__ __forceinline__ uint4 draw(uint32_t i) const {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t a = x1 ^ i;                               // round 0's x
    const uint32_t b = __umulhi(M0, a) ^ z2, w2 = M0 * a;    // round 1's z, w
    uint4 c = make_uint4(__umulhi(M1, b) ^ x3, M1 * b, w2 ^ z3, w3);  // after round 2
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
      const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
      c = make_uint4(hi1 ^ c.y ^ k0[r], lo1, hi0 ^ c.w ^ k1[r], lo0);
    }
    return c;
  }
};

// philox4x32((x, i, z, 0), (seed0, seed1)) for a thread whose i and z stay
// fixed while x varies (the attention forward: i its query row, z its (b,
// h), x the key group): round 0's half free of x, round 1's half free of
// it, and the key schedule of the other eight are computed once. Rounds 0
// and 1 then cost one 32 x 32 product each (hi and lo), rounds 2-9 two.
struct PhiloxQuery {
  uint32_t x1, y1k, z1k, w2, s1;  // the parts of rounds 0-1 free of x
  uint32_t k0[8], k1[8];          // the keys of rounds 2-9

  __device__ __forceinline__ PhiloxQuery(uint32_t i, uint32_t z, uint32_t s0, uint32_t s1_)
      : s1(s1_) {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u, W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
    // round 0 on (x, i, z, 0): (M1 z)_hi ^ i ^ k0, (M1 z)_lo, (M0 x)_hi ^ k1, (M0 x)_lo
    x1 = __umulhi(M1, z) ^ i ^ s0;
    // round 1: (M1 z1)_hi ^ y1 ^ k0, (M1 z1)_lo, (M0 x1)_hi ^ w1 ^ k1, (M0 x1)_lo
    y1k = (M1 * z) ^ (s0 + W0);
    z1k = __umulhi(M0, x1) ^ (s1 + W1);
    w2 = M0 * x1;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      k0[r] = s0 + (r + 2) * W0;
      k1[r] = s1 + (r + 2) * W1;
    }
  }

  __device__ __forceinline__ uint4 draw(uint32_t x) const {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t z1 = __umulhi(M0, x) ^ s1, w1 = M0 * x;                 // round 0's z, w
    uint4 c = make_uint4(__umulhi(M1, z1) ^ y1k, M1 * z1, z1k ^ w1, w2);   // after round 1
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
      const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
      c = make_uint4(hi1 ^ c.y ^ k0[r], lo1, hi0 ^ c.w ^ k1[r], lo0);
    }
    return c;
  }
};
