// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the band predicates of
// distributed_model_parallel_tpu/ops/pallas_attention.py (`band_keep`,
// `_band_start_k`, `_last_k_block`, `_block_interior`, `_q_bounds_for_k`)
// with block sizes as template arguments, the wgmma issue loops of the
// two backward kernels over TMA-written tiles, and the bf16 epilogue.
//
// Layout: q/k/v/dO/o/dq/dk/dv are [B, T, H, D] bf16, contiguous (the JAX
// package's layout — no transpose or padding pass); lse and delta are
// [B, H, T] f32. TMA loads rows at or past T as zeros and the band
// predicates mask them, so T needs no padding.
//
// A tile in shared memory is what a TMA load of `rows` rows writes (see
// sm90.cuh): D / 64 boxes of rows x 128 bytes, 128-byte swizzle, one
// box `rows` · 128 bytes after the other. The same tile is read two ways
// by wgmma, so nothing is ever transposed in memory:
//   * K-major (D is the contraction): S = Q·K^T, dP = dO·V^T and their
//     transposes; a k16 step is 32 bytes along a row, a new box every
//     4 steps;
//   * MN-major with the transpose bit (the rows are the contraction):
//     dQ += dS·K, dV += P^T·dO, dK += dS^T·Q; a k16 step is 16 rows
//     (2048 bytes), LBO the box stride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // JAX's NEG_INF: lse of a keyless row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRowBytes = 128;  // one swizzled row of a box: 64 bf16

struct Problem {
  int B, T, H;
  int causal;
  int window;  // <= 0: none
  float scale;
};

// band_keep: k_pos in (q_pos - window, q_pos] (causal); everything kept
// otherwise. Rows and keys at or past T are never kept.
__device__ __forceinline__ bool keep(const Problem& p, int q_pos, int k_pos) {
  if (q_pos >= p.T || k_pos >= p.T) return false;
  if (!p.causal) return true;
  return k_pos <= q_pos && (p.window <= 0 || k_pos > q_pos - p.window);
}

// True when rows [q0, q0 + BQ) and keys [k0, k0 + BK) need no mask:
// strictly inside the causal band (`_block_interior`) and clear of the
// ragged edge. Each warpgroup asks for its own 64 rows (or keys).
template <int BQ, int BK>
__device__ __forceinline__ bool interior_rows(const Problem& p, int q0, int k0) {
  if (q0 + BQ > p.T || k0 + BK > p.T) return false;
  if (!p.causal) return true;
  bool in = k0 + BK - 1 <= q0;
  if (p.window > 0) in = in && k0 > q0 + BQ - 1 - p.window;
  return in;
}

// Key blocks [lo, hi] of BK keys that rows [q0, q0 + BQ) attend
// (`_band_start_k`, `_last_k_block`).
template <int BQ, int BK>
__device__ __forceinline__ void k_range_rows(const Problem& p, int q0, int& lo, int& hi) {
  const int num_k = (p.T + BK - 1) / BK;
  if (!p.causal) {
    lo = 0;
    hi = num_k - 1;
    return;
  }
  lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  hi = min((q0 + BQ - 1) / BK, num_k - 1);
}

// Q blocks [lo, hi) of BQ rows that attend any key of [k0, k0 + BK)
// (`_q_bounds_for_k`): from the block holding row k0 (the band's
// diagonal) to the block holding row k0 + BK - 1 + window - 1 (the last
// row whose window still reaches the block's last key).
template <int BQ, int BK>
__device__ __forceinline__ void q_range_rows(const Problem& p, int k0, int& lo, int& hi) {
  const int num_q = (p.T + BQ - 1) / BQ;
  if (!p.causal) {
    lo = 0;
    hi = num_q;
    return;
  }
  lo = k0 / BQ;
  hi = p.window > 0 ? min(num_q, (k0 + BK - 1 + p.window - 1) / BQ + 1) : num_q;
}

// ---------------------------------------------------------------------------
// wgmma over TMA-written tiles (the backward kernels)
// ---------------------------------------------------------------------------

// acc[64 x 64] = A · B^T over D: A is 64 rows of a tile whose boxes are
// a_box bytes apart, B the 64 rows of a tile with boxes b_box apart, both
// K-major (S = Q·K^T, dP = dO·V^T, S^T = K·Q^T, dP^T = V·dO^T).
template <int D>
__device__ __forceinline__ void issue_ss64(float (&acc)[8][4], const unsigned char* a,
                                           uint32_t a_box, const unsigned char* b,
                                           uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int step = (kk % 4) * 32;
    sm90::wgmma_ss_m64n64k16(acc, sm90::desc_sw128(a + (kk / 4) * a_box + step, 16, 1024),
                             sm90::desc_sw128(b + (kk / 4) * b_box + step, 16, 1024),
                             kk > 0);
  }
}

// acc[64 x D] += A · B over 64 rows: A in registers (a bf16 score tile,
// register-A fragments per k16 step), B the first 64 rows of a tile with
// boxes b_box apart, MN-major (dQ += dS·K, dV += P^T·dO, dK += dS^T·Q).
template <int D>
__device__ __forceinline__ void issue_rs64(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                           const unsigned char* b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<D>(acc, a[kk], sm90::desc_sw128(b + kk * 16 * kRowBytes, b_box, 1024), 1);
}

// ---------------------------------------------------------------------------
// registers and the epilogue
// ---------------------------------------------------------------------------

// Two f32 -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A [64 x 16·K] f32 accumulator tile in bf16 as register-A fragments: k
// step kk takes column blocks 2kk and 2kk + 1 (the accumulator's rows g,
// g + 8 at columns 2c.. and 2c + 8.. are the A operand's, as in
// mma.sync m16n8k16).
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K][4], const float (&acc)[2 * K][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * K; ++nt) {
    a[nt / 2][2 * (nt & 1)] = pack(acc[nt][0], acc[nt][1]);
    a[nt / 2][2 * (nt & 1) + 1] = pack(acc[nt][2], acc[nt][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Write accumulator rows (row0 + g, row0 + g + 8) of a [16 x D] tile,
// times mul[0] / mul[1], into rows of head (b, h) of a [B, T, H, D] bf16
// tensor; rows at or past T are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                           const Problem& p, int b, int h, int row0,
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + g + 8 * half;
    if (t >= p.T) continue;
    bf16* row = dst + (((size_t)b * p.T + t) * p.H + h) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * c) =
          pack(acc[nt][2 * half] * mul[half], acc[nt][2 * half + 1] * mul[half]);
  }
}

}  // namespace flash
