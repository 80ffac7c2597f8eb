// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile sizes, the band predicates of
// distributed_model_parallel_tpu/ops/pallas_attention.py (`band_keep`,
// `_band_start_k`, `_last_k_block`, `_block_interior`, `_q_bounds_for_k`),
// cp.async tile loads and the tensor-core primitives every kernel is
// built from: ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Layout: q/k/v/dO/o/dq/dk/dv are [B, T, H, D] bf16, contiguous (the JAX
// package's layout — no transpose or padding pass); lse and delta are
// [B, H, T] f32. A CTA works on one (b, h) and one 64-row block, one warp
// per 16 rows; rows at or past T are loaded as zeros and masked, so T
// needs no padding.
//
// Fragments (PTX ISA, mma.m16n8k16, lane = 4·g + c): an f32 accumulator
// tile [16 x 8] holds rows g and g + 8, columns 2c and 2c + 1 of the
// tile in its four registers; an A operand [16 x 16] holds the same rows
// at columns 2c, 2c + 1, 2c + 8, 2c + 9. So the accumulators of two
// neighbouring 8-column tiles, rounded to bf16, are the A operand of the
// next product without passing through shared memory (FlashAttention-2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;       // query and key rows per tile
constexpr int kWarps = 4;        // one warp per 16 rows of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 row padding: a 16-byte shift per
                                 // row keeps ldmatrix free of conflicts
constexpr float kNegInf = -1e30f;  // JAX's NEG_INF: lse of a keyless row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// True when the (q block qi, k block kj) tile needs no mask: strictly
// inside the causal band (`_block_interior`) and clear of the ragged edge.
__device__ __forceinline__ bool interior(const Problem& p, int qi, int kj) {
  if ((qi + 1) * kBlock > p.T || (kj + 1) * kBlock > p.T) return false;
  if (!p.causal) return true;
  bool in = (kj + 1) * kBlock - 1 <= qi * kBlock;
  if (p.window > 0) in = in && kj * kBlock > qi * kBlock + kBlock - 1 - p.window;
  return in;
}

// K blocks [lo, hi] a q block attends (`_band_start_k`, `_last_k_block`).
__device__ __forceinline__ void k_range(const Problem& p, int qi, int& lo, int& hi) {
  const int num_k = (p.T + kBlock - 1) / kBlock;
  if (!p.causal) {
    lo = 0;
    hi = num_k - 1;
    return;
  }
  lo = p.window > 0 ? max(0, qi * kBlock - p.window + 1) / kBlock : 0;
  hi = min((qi * kBlock + kBlock - 1) / kBlock, num_k - 1);
}

// Q blocks [lo, hi) attending any key of k block kj (`_q_bounds_for_k`).
__device__ __forceinline__ void q_range(const Problem& p, int kj, int& lo, int& hi) {
  const int num_q = (p.T + kBlock - 1) / kBlock;
  if (!p.causal) {
    lo = 0;
    hi = num_q;
    return;
  }
  lo = kj;
  hi = p.window > 0 ? min(num_q, ((kj + 1) * kBlock - 1 + p.window - 1) / kBlock + 1)
                    : num_q;
}

// ---------------------------------------------------------------------------
// asynchronous global -> shared copies
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + kBlock) of head (b, h) of a [B, T, H, D] tensor into
// a shared tile [kBlock][D + kPad], zeros past T; one commit group is the
// caller's to close.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          const Problem& p, int b, int h, int row0) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBlock * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c % kChunks) * 8;
    const int t = row0 + r;
    const bool valid = t < p.T;
    // An invalid chunk reads nothing; its address only has to be legal.
    const bf16* g = src + (((size_t)b * p.T + (valid ? t : 0)) * p.H + h) * D + d0;
    cp_async16(dst + r * (D + kPad) + d0, g, valid);
  }
}

// Rows [row0, row0 + kBlock) of a [B, H, T] f32 vector, times `mul`
// (0 past T), with plain loads.
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src,
                                         const Problem& p, int b, int h, int row0,
                                         float mul) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const int t = row0 + r;
    dst[r] = t < p.T ? src[((size_t)b * p.H + h) * p.T + t] * mul : 0.f;
  }
}

// ---------------------------------------------------------------------------
// tensor-core primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a · b, a [16 x 16] row-major, b [16 x 8] column-major, d f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of rows [16 x 16] at (row0, col0) of a shared tile with
// row stride ld: lane l points at row l % 16, column half l / 16.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B operands of two 8-column output tiles (n0, n0 + 8) for the k step
// [k0, k0 + 16), from a shared tile stored [n][k] (row n holds the k
// values: K for Q·K^T). b[0], b[1] feed tile n0; b[2], b[3] tile n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a shared tile stored [k][n] (row k holds the n values:
// V for P·V), transposed by ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// acc[N/8][4] += a_tile[16 x K] (rows row0.., shared, [row][k]) ·
// b_tile^T, b_tile [N][K] in shared ([n][k]): the scores Q·K^T and dO·V^T.
template <int K, int N>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], const bf16* a_tile,
                                         const bf16* b_tile, int ld, int row0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, ld, row0, kk * 16);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      load_b_nk(b, b_tile, ld, np * 16, kk * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8][4] += P[16 x K] · b_tile, P given as f32 accumulator tiles
// s[K/8][4] (rounded to bf16 here), b_tile [K][D] in shared ([k][n]):
// P·V, dS·K, P^T·dO, dS^T·Q.
template <int K, int D>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4], const float (&s)[K / 8][4],
                                        const bf16* b_tile, int ld, int k_row0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_kn(b, b_tile, ld, k_row0 + kk * 16, np * 16);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
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

// Shared-memory carve-up helper: 128-byte aligned offsets.
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

}  // namespace flash
