// FlashAttention backward: dQ (one kernel) and dK, dV (a second kernel),
// with the key-padding mask and the forward's dropout mask regenerated.
//
// Replaces: fithubert_tpu/ops/pallas/flash_attention.py, the backward Pallas
//   kernels _make_bwd_dq_kernel (:127, run at :304) and _make_bwd_dkv_kernel
//   (:173, run at :323).
//
// Bound on the H100: memory, for both. At the student's training shape
//   (B=12, T=299, H=12, D=40, bf16, p = 0.1) dK/dV reads q, k, v, dO, lse and delta and
//   writes dK and dV (~21 MB with the mask: 0.0063 ms at 3.35 TB/s) against
//   ~4.1 GFLOP of recomputed logits and products (0.0042 ms at the bf16
//   tensor-core peak). The T x T matrices P and dS never reach device
//   memory: they are recomputed from lse.
//
// Design: the split is FlashAttention-2's, without atomics: dQ and dK/dV
//   are two kernels, each output element summed by one warp (by one thread
//   in the fp32 bodies) in a fixed order, so the gradients are deterministic run
//   to run. Per element:
//     P  = exp(s - lse), zeroed explicitly at masked keys (:148-150), so a
//          fully padded row (lse = -1e30) gives exactly zero gradients;
//     dP = dO . v_j, dropped and scaled like P in the forward;
//     dS = P * (dP - delta),  delta = rowsum(dO * O) (computed by the
//          caller, as XLA does at :302);
//     dV += P_dropped dO,  dK += dS q_i,  dQ += dS k_j.
//   The keep mask is philox.cuh's pure function of (seed, z = b * H + h, i,
//   j): counter (j >> 2, i, z, 0), word j & 3, so it equals the forward's
//   whatever the tiling. fp32 accumulation, written in q's dtype
//   (:351-353). D one of FA_HEAD_DIMS (the wrapper zero-pads others), any
//   T (ragged tails masked here), q, k, v read through their (B, T, H, D)
//   strides; dO, lse, delta and the outputs are contiguous. Tiles live in
//   dynamic shared memory (opted in above 48 KB); the seed is read from
//   device memory (seed_ptr), as in the forward.
//
// dK/dV (K4), bf16: mma.sync m16n8k16 bf16 -> fp32, the TPU kernel's own
//   arithmetic (bf16 operands, fp32 sums, P_dropped and dS rounded to bf16
//   before their products, :212-220).
//   - Block and loop: 4 warps (128 threads) per (b, h, 64-key tile), 16
//     keys per warp. K and V are copied once (cp.async, through the ring's
//     second stage) and held as A fragments (ldmatrix). The block walks
//     every 64-row query tile with Q and dO in a two-stage cp.async ring,
//     lse (times log2 e) and delta staged beside them in shared memory.
//     Rows are padded by 16 bytes; D = 40 pads the k extent of S^T and
//     dP^T to 48 with columns zeroed in shared memory once.
//   - The four products, keys as rows (m) throughout:
//       S^T  = K Q^T   (B = Q, ldmatrix), P^T = exp2(S^T log2 e - lse_i log2 e);
//       dP^T = V dO^T  (B = dO, ldmatrix);
//       dV  += P_dropped^T dO   (A = P^T from registers, B = dO, ldmatrix.trans);
//       dK  += dS^T Q           (A = dS^T from registers, B = Q, ldmatrix.trans).
//     Computing S^T and dP^T key-major, rather than FA2's query-major S,
//     puts P^T and dS^T in C fragments whose layout is already the A
//     fragment of the dV and dK products (two n8 tiles = one k16 step), so
//     nothing is staged back through shared memory.
//   - Dropout: in a C tile lanes 16a + 4u + t4 (u = 0..3) hold keys
//     4a + u and 4a + u + 8, two j >> 2 groups, at queries 8n + 2t4, +1.
//     Lane u draws the call (group + 2 (u >> 1), query + (u & 1)); the four
//     lanes trade words with three __shfl_xor_sync (masks 4, 8, 12), each
//     sender choosing the word its partner needs: one Philox call per four
//     (i, j), as in the forward.
//   The tile steps (row copies, the two kinds of product) are
//   flash_tile.cuh's, shared with K2 and K3.
// dQ (K3), bf16: K2's forward loop without the online softmax, on the same
//   mma.sync m16n8k16 bf16 -> fp32 tile steps. Bound, at the student's
//   shape: bytes, ~17 MB read and written (0.0052 ms at 3.35 TB/s) against
//   ~3.1 GFLOP of recomputed logits and products (0.0031 ms at the bf16
//   tensor-core peak; 0.0041 with dS K done twice, below).
//   - Block and loop: 4 warps (128 threads) per (b, h, 64-row query tile),
//     16 query rows per warp (720 blocks at (12, 299, 12, 40)). Q and dO are
//     copied once through the ring's second stage and held as A fragments
//     (ldmatrix); lse (times log2 e) and delta of the lane's two rows sit in
//     registers. K and V walk a two-stage cp.async ring of 64-key tiles.
//   - The three products, query-major:
//       S  = Q K^T   (B = K, ldmatrix), P = exp2(S log2 e - lse log2 e);
//       dP = dO V^T  (B = V, ldmatrix);
//       dQ += dS K   (A = dS from registers; B = K, ldmatrix.trans),
//     as K2 feeds P into P V. Masked keys and keys past T get an explicit
//     P = 0, so a fully padded row (lse = -1e30) gives dQ = 0.
//   - dS in two bf16 parts. The TPU kernel rounds dS to bf16 before dS K
//     (:161-163). K is not pre-scaled as q is, and where a row has few
//     valid keys its dS terms are large, so that one rounding moved single
//     dQ elements from attention_bwd_plain by 0.0625 (at (2, 63, 3, 40), on
//     the card) and 0.125 (at (3, 65, 2, 64), emulated on the CPU), more than
//     the 1e-2 + 1e-2 |dQ| limit allows there. So dS K is two products, bf16(dS) K + bf16(dS -
//     bf16(dS)) K: dS carries ~16 bits, one more k-pass of tensor-core work
//     on a kernel bound by bytes.
//   - Dropout: K2's exchange on the query-major C tile (one __shfl_xor_sync
//     mask 1 per word pair): one Philox call per four (i, j).
//   - Each dQ element is summed by one warp in a fixed key order: no
//     atomics, deterministic.
// fp32 (dQ and dK/dV): FMA bodies. dQ: one 64-thread block per (b, h,
//   64-row query tile), one thread per query row i holding q_i, dO_i and
//   the dQ accumulator in fp32 registers; the block walks the key axis in
//   64-key tiles of K and V staged in shared memory as fp32 (broadcast
//   reads). dK/dV: one 64-thread block per (b, h, 64-key tile), one thread
//   per key column j, the block walking every query tile. fp32 inputs only
//   serve the card-vs-CPU checks (2e-3 end to end); the tensor cores would
//   take them only as TF32, whose 10-bit mantissa breaks that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64, BKV = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

struct Dropout {
  uint32_t thr;  // floor(p * 2^24); 0 = no dropout
  float inv_keep;
  const uint32_t* ptr;  // the seed's two words in device memory (null: no dropout)
  uint32_t seed0, seed1;  // read from ptr as each block starts
};

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// ------------------------------------------------------------ dQ (K3), fp32
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq, int T_len, int H,
             Strides st, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem[];  // fp32_smem<D>() bytes
  auto Ks = reinterpret_cast<float (*)[D]>(smem);
  auto Vs = reinterpret_cast<float (*)[D]>(smem + BKV * D * sizeof(float));
  auto valid = reinterpret_cast<float*>(smem + 2 * BKV * D * sizeof(float));
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int i = blockIdx.x * BQ + threadIdx.x;
  const bool row_ok = i < T_len;
  const long long row = static_cast<long long>(row_ok ? i : 0);

  float qr[D], dor[D], acc[D];
  {
    const float* qp = q + b * st.qb + row * st.qt + h * st.qh;
    const float* dp = dout + ((static_cast<long long>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = row_ok ? qp[d] : 0.f;
      dor[d] = row_ok ? dp[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  const long long lrow = static_cast<long long>(bh) * T_len + row;
  const float lse_i = row_ok ? lse[lrow] : 0.f;
  const float delta_i = row_ok ? delta[lrow] : 0.f;

  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  for (int k0 = 0; k0 < T_len; k0 += BKV) {
    __syncthreads();
    for (int e = threadIdx.x; e < BKV * D; e += BQ) {
      const int j = e / D, d = e - j * D, kt = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kt < T_len) {
        kv = kb[static_cast<long long>(kt) * st.kt + d];
        vv = vb[static_cast<long long>(kt) * st.vt + d];
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
    float* op = dq + ((static_cast<long long>(b) * T_len + i) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d];
  }
}

// ------------------------------------------------------ dK, dV (K4), fp32
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(BKV)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
              int T_len, int H, Strides st, Dropout dr) {
  extern __shared__ __align__(16) unsigned char smem[];  // fp32_smem<D>() bytes
  auto Qs = reinterpret_cast<float (*)[D]>(smem);
  auto dOs = reinterpret_cast<float (*)[D]>(smem + BQ * D * sizeof(float));
  float* lse_s = reinterpret_cast<float*>(smem + 2 * BQ * D * sizeof(float));
  float* delta_s = lse_s + BQ;
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

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
    const float* kp = k + b * st.kb + col * st.kt + h * st.kh;
    const float* vp = v + b * st.vb + col * st.vt + h * st.vh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = col_in ? kp[d] : 0.f;
      vr[d] = col_in ? vp[d] : 0.f;
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
  }

  const float* qb = q + b * st.qb + h * st.qh;
  for (int q0 = 0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * D; e += BKV) {
      const int r = e / D, d = e - r * D, qt = q0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qt < T_len) {
        qv = qb[static_cast<long long>(qt) * st.qt + d];
        dv_ = dout[((static_cast<long long>(b) * T_len + qt) * H + h) * D + d];
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
      dk[o + d] = dka[d];
      dv[o + d] = dva[d];
    }
  }
}

// ----------------------------------------------------- dK, dV (K4), bf16
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int T_len, int H, Strides st, Dropout dr) {
  constexpr int LD = Rows<D>::LD, KS = Rows<D>::KS, N8 = Rows<D>::N8;
  extern __shared__ __align__(16) unsigned char smem[];  // mma_smem<D>() bytes
  auto Qs = reinterpret_cast<bf16 (*)[TILE][LD]>(smem);
  auto dOs = reinterpret_cast<bf16 (*)[TILE][LD]>(smem + 2 * Rows<D>::BYTES);
  auto lse_s = reinterpret_cast<float (*)[TILE]>(smem + 4 * Rows<D>::BYTES);
  auto delta_s = lse_s + 2;
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int key0 = blockIdx.x * TILE;

  zero_pad<D>(Qs[0], 2 * TILE);
  zero_pad<D>(dOs[0], 2 * TILE);
  // K and V pass through stage 1 on their way into registers
  load_rows<D>(Qs[1], k + b * st.kb + h * st.kh, st.kt, key0, T_len);
  load_rows<D>(dOs[1], v + b * st.vb + h * st.vh, st.vt, key0, T_len);
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* ob = dout + static_cast<long long>(b) * T_len * H * D + static_cast<long long>(h) * D;
  auto load_q = [&](int s, int q0) {
    load_rows<D>(Qs[s], qb, st.qt, q0, T_len);
    load_rows<D>(dOs[s], ob, static_cast<long long>(H) * D, q0, T_len);
    if (threadIdx.x < TILE) {
      const int t = q0 + threadIdx.x;
      const long long lrow = static_cast<long long>(bh) * T_len + t;
      // rows past T: exp2(s - 1e30) = 0, so they add nothing
      lse_s[s][threadIdx.x] = t < T_len ? lse[lrow] * LOG2E : 1e30f;
      delta_s[s][threadIdx.x] = t < T_len ? delta[lrow] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];
  load_a<D>(kf, Qs[1], warp * 16, lane);
  load_a<D>(vf, dOs[1], warp * 16, lane);
  __syncthreads();  // stage 1 is free for the ring

  // this lane's keys: rows g and g + 8 of the warp's 16
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + warp * 16 + g + 8 * r;
    key_ok[r] = j < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + j]);
  }
  const int u = g & 3;  // this lane's place among the 4 lanes of one key group
  const uint32_t jg = static_cast<uint32_t>((key0 + warp * 16 + (g & ~3)) / 4 + 2 * (u >> 1));

  float dka[N8][4], dva[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_qt = (T_len + TILE - 1) / TILE;
#pragma unroll 1
  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt & 1, q0 = qt * TILE;
    if (qt + 1 < n_qt) load_q(s ^ 1, q0 + TILE);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    // element e of tile n: key row g + 8 (e >> 1), query 8n + 2t4 + (e & 1)
    float p[8][4], ds[8][4];
    mma_a_bt<D>(p, kf, Qs[s], lane);  // S^T = K Q^T, then P^T in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = key_ok[e >> 1]
                      ? exp2f(fmaf(p[n][e], LOG2E, -lse_s[s][n * 8 + 2 * t4 + (e & 1)]))
                      : 0.f;
    mma_a_bt<D>(ds, vf, dOs[s], lane);  // dP^T = V dO^T, then dS^T in place

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t keep = 0xfu;
      if (DROPOUT) {
        const uint32_t i = static_cast<uint32_t>(q0 + n * 8 + 2 * t4 + (u & 1));
        const uint4 w = philox4x32(make_uint4(jg, i, static_cast<uint32_t>(bh), 0u),
                                   dr.seed0, dr.seed1);
        // element e of this lane is word u of lane e's call (e = u ^ r)
        keep = ((philox_word(w, u) >> 8) >= dr.thr ? 1u : 0u) << u;
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          const uint32_t got = __shfl_xor_sync(FULL, philox_word(w, u ^ r), 4 * r);
          keep |= ((got >> 8) >= dr.thr ? 1u : 0u) << (u ^ r);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float scale = DROPOUT ? ((keep >> e) & 1u ? dr.inv_keep : 0.f) : 1.f;
        ds[n][e] = p[n][e] * (ds[n][e] * scale - delta_s[s][n * 8 + 2 * t4 + (e & 1)]);
        p[n][e] *= scale;  // P_dropped, the operand of dV
      }
    }

    mma_c_b<D>(dva, p, dOs[s], lane);  // dV += P_dropped^T dO
    mma_c_b<D>(dka, ds, Qs[s], lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + warp * 16 + g + 8 * r;
    if (j >= T_len) continue;
    const long long o = ((static_cast<long long>(b) * T_len + j) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * n) =
          __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * n) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// --------------------------------------------------------------- dQ (K3), bf16
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq, int T_len, int H,
                 Strides st, Dropout dr) {
  constexpr int LD = Rows<D>::LD, KS = Rows<D>::KS, N8 = Rows<D>::N8;
  extern __shared__ __align__(16) unsigned char smem[];  // mma_smem<D>() bytes
  auto Ks = reinterpret_cast<bf16 (*)[TILE][LD]>(smem);
  auto Vs = reinterpret_cast<bf16 (*)[TILE][LD]>(smem + 2 * Rows<D>::BYTES);
  auto valid = reinterpret_cast<float (*)[TILE]>(smem + 4 * Rows<D>::BYTES);
  if (DROPOUT) {  // the words a graph replay finds there
    dr.seed0 = dr.ptr[0];
    dr.seed1 = dr.ptr[1];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * TILE;

  zero_pad<D>(Ks[0], 2 * TILE);
  zero_pad<D>(Vs[0], 2 * TILE);  // dO's columns D..DP-1 and V's: both are read over DP
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  auto load_kv = [&](int s, int k0) {
    load_rows<D>(Ks[s], kb, st.kt, k0, T_len);
    load_rows<D>(Vs[s], vb, st.vt, k0, T_len);
    if (threadIdx.x < TILE) {
      const int t = k0 + threadIdx.x;
      valid[s][threadIdx.x] =
          (t < T_len && !(mask != nullptr && mask[static_cast<long long>(b) * T_len + t]))
              ? 1.f : 0.f;
    }
  };
  // Q and dO pass through stage 1 on their way into registers
  load_rows<D>(Ks[1], q + b * st.qb + h * st.qh, st.qt, q0, T_len);
  load_rows<D>(Vs[1],
               dout + static_cast<long long>(b) * T_len * H * D + static_cast<long long>(h) * D,
               static_cast<long long>(H) * D, q0, T_len);
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  uint32_t qf[KS][4], dof[KS][4];
  load_a<D>(qf, Ks[1], warp * 16, lane);
  load_a<D>(dof, Vs[1], warp * 16, lane);
  __syncthreads();  // stage 1 is free for the ring

  // this lane's query rows: g and g + 8 of the warp's 16
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    const long long lrow = static_cast<long long>(bh) * T_len + t;
    // rows past T: exp2(s - 1e30) = 0, and they are not stored
    lse_r[r] = t < T_len ? lse[lrow] * LOG2E : 1e30f;
    delta_r[r] = t < T_len ? delta[lrow] : 0.f;
  }
  const bool odd = t4 & 1;
  const uint32_t drow = static_cast<uint32_t>(q0 + warp * 16 + g + (odd ? 8 : 0));

  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = (T_len + TILE - 1) / TILE;
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * TILE;
    if (kt + 1 < n_kt) load_kv(s ^ 1, k0 + TILE);
    cp_async_commit();  // possibly empty: one group per iteration
    cp_async_wait1();   // tile kt has landed
    __syncthreads();

    // element e of tile n: query row g + 8 (e >> 1), key 8n + 2t4 + (e & 1)
    float p[8][4], ds[8][4];
    mma_a_bt<D>(p, qf, Ks[s], lane);  // S = Q K^T, then P in place
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        // masked keys and keys past T get an explicit 0, not exp2 of a huge number
        p[n][e] = valid[s][n * 8 + 2 * t4 + (e & 1)] != 0.f
                      ? exp2f(fmaf(p[n][e], LOG2E, -lse_r[e >> 1]))
                      : 0.f;
    mma_a_bt<D>(ds, dof, Vs[s], lane);  // dP = dO V^T, then dS in place

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float scale[4] = {1.f, 1.f, 1.f, 1.f};
      if (DROPOUT) {
        // K2's exchange: the even lane draws row g's call, the odd lane row
        // g + 8's, and they swap the two words the other needs
        const uint32_t jg = static_cast<uint32_t>((k0 + n * 8) / 4 + (t4 >> 1));
        const uint4 w = philox4x32(make_uint4(jg, drow, static_cast<uint32_t>(bh), 0u),
                                   dr.seed0, dr.seed1);
        const uint32_t own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
        const uint32_t got0 = __shfl_xor_sync(FULL, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(FULL, odd ? w.y : w.w, 1);
        const uint32_t wd[4] = {odd ? got0 : own0, odd ? got1 : own1,
                                odd ? own0 : got0, odd ? own1 : got1};
#pragma unroll
        for (int e = 0; e < 4; ++e) scale[e] = (wd[e] >> 8) >= dr.thr ? dr.inv_keep : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[n][e] = p[n][e] * (ds[n][e] * scale[e] - delta_r[e >> 1]);
        p[n][e] = ds[n][e] - __bfloat162float(__float2bfloat16(ds[n][e]));  // dS - bf16(dS)
      }
    }

    mma_c_b<D>(acc, ds, Ks[s], lane);  // dQ += bf16(dS) K
    mma_c_b<D>(acc, p, Ks[s], lane);   // dQ += bf16(dS - bf16(dS)) K
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T_len) continue;
    bf16* op = dq + ((static_cast<long long>(b) * T_len + t) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
constexpr int mma_smem() { return 4 * Rows<D>::BYTES + 4 * TILE * sizeof(float); }
template <int D>
constexpr int fp32_smem() { return 2 * BQ * D * sizeof(float) + 2 * BQ * sizeof(float); }

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const uint8_t* mask,
               const void* dout, const float* lse, const float* delta, void* dq, int B,
               int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  if constexpr (sizeof(T) == 2) {
    auto kernel = dr.thr > 0 ? &flash_bwd_dq_mma<D, true> : &flash_bwd_dq_mma<D, false>;
    opt_in_smem(kernel, mma_smem<D>(), opted[dr.thr > 0]);
    kernel<<<grid, 128, mma_smem<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), T_len, H, st,
        dr);
  } else {
    auto kernel = dr.thr > 0 ? &flash_bwd_dq<D, true> : &flash_bwd_dq<D, false>;
    opt_in_smem(kernel, fp32_smem<D>(), opted[dr.thr > 0]);
    kernel<<<grid, BQ, fp32_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), T_len, H, st, dr);
  }
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const uint8_t* mask,
                const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                int B, int T_len, int H, Strides st, Dropout dr, cudaStream_t stream) {
  static bool opted[2] = {false, false};
  dim3 grid((T_len + BKV - 1) / BKV, B * H);
  if constexpr (sizeof(T) == 2) {
    auto kernel = dr.thr > 0 ? &flash_bwd_dkv_mma<D, true> : &flash_bwd_dkv_mma<D, false>;
    opt_in_smem(kernel, mma_smem<D>(), opted[dr.thr > 0]);
    kernel<<<grid, 128, mma_smem<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), T_len, H, st, dr);
  } else {
    auto kernel = dr.thr > 0 ? &flash_bwd_dkv<D, true> : &flash_bwd_dkv<D, false>;
    opt_in_smem(kernel, fp32_smem<D>(), opted[dr.thr > 0]);
    kernel<<<grid, BKV, fp32_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), T_len, H, st, dr);
  }
}

}  // namespace

// Shared arguments: dtype 0 = float32, 1 = bfloat16; head_dim one of
// FA_HEAD_DIMS; q, k, v (B, T, H, D) with the given (b, t, h) element
// strides and unit stride along D; mask (B, T) bool, True = padding, or
// null; dout (B, T, H, D) contiguous in q's dtype; lse and delta (B, H, T)
// fp32; the outputs (B, T, H, D) contiguous in q's dtype; thr = floor(p *
// 2^24) (0: no dropout), inv_keep = 1/(1-p), seed_ptr the forward's two
// seed words in device memory (null without dropout). Each returns
// cudaGetLastError() after its launch.
#define FA_BWD_CASE(CALL, DD)                                             \
  if (head_dim == DD) {                                                   \
    if (dtype == 1) CALL(bf16, DD);                                       \
    else if (dtype == 0) CALL(float, DD);                                 \
    else return static_cast<int>(cudaErrorInvalidValue);                  \
    return static_cast<int>(cudaGetLastError());                          \
  }

extern "C" int flash_attention_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                      const void* v, const void* mask, const void* dout,
                                      const void* lse, const void* delta, void* dq, int B,
                                      int T_len, int H, long long sqb, long long sqt,
                                      long long sqh, long long skb, long long skt,
                                      long long skh, long long svb, long long svt,
                                      long long svh, unsigned thr, float inv_keep,
                                      const void* seed_ptr, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
#define FA_DQ(TT, DD)                                                                    \
  launch_dq<TT, DD>(q, k, v, static_cast<const uint8_t*>(mask), dout,                    \
                    static_cast<const float*>(lse), static_cast<const float*>(delta), dq, \
                    B, T_len, H, st, dr, static_cast<cudaStream_t>(stream))
#define FA_DQ_CASE(DD) FA_BWD_CASE(FA_DQ, DD)
  FA_HEAD_DIMS(FA_DQ_CASE)
#undef FA_DQ_CASE
#undef FA_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* mask, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       int B, int T_len, int H, long long sqb, long long sqt,
                                       long long sqh, long long skb, long long skt,
                                       long long skh, long long svb, long long svt,
                                       long long svh, unsigned thr, float inv_keep,
                                       const void* seed_ptr, void* stream) {
  const Strides st{sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  const Dropout dr{thr, inv_keep, static_cast<const uint32_t*>(seed_ptr), 0u, 0u};
#define FA_DKV(TT, DD)                                                                   \
  launch_dkv<TT, DD>(q, k, v, static_cast<const uint8_t*>(mask), dout,                   \
                     static_cast<const float*>(lse), static_cast<const float*>(delta),    \
                     dk, dv, B, T_len, H, st, dr, static_cast<cudaStream_t>(stream))
#define FA_DKV_CASE(DD) FA_BWD_CASE(FA_DKV, DD)
  FA_HEAD_DIMS(FA_DKV_CASE)
#undef FA_DKV_CASE
#undef FA_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
