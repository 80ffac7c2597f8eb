// Flash-attention backward, dk and dv, for Hopper (sm_90a) —
// FlashAttention-2.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_bwd_dkv_call` there). Plain version: ops/flash_attention.py
// `flash_bwd_dkv_plain`. For each key row j:
//   p_ij  = exp(scale · q_i·k_j − lse_i)          (recomputed, f32)
//   dv_j  = Σ_i p_ij dO_i                          (p rounded to bf16)
//   ds_ij = p_ij · (dO_i·v_j − delta_i) · scale     (rounded to bf16)
//   dk_j  = Σ_i ds_ij q_i
// f32 accumulate, dk/dv out in bf16. The scale multiplies the f32 product.
//
// Design: one CTA per (b·h, 64-row k block), looping over the q blocks of
// `_q_bounds_for_k` (from the diagonal on; a window also stops at the
// band's lower edge). Keeping dq in its own kernel, as FlashAttention-2
// does, means no atomics and no cross-CTA reduction. Four warps each own
// 16 key rows. K and V stay in shared memory; Q, dO, lse and delta tiles
// are double-buffered with cp.async. The work is done in transposed score
// space, S^T = K·Q^T and dP^T = V·dO^T [keys x queries], so P^T and dS^T
// go from the accumulators straight into the A operands of dv += P^T·dO
// and dk += dS^T·Q; both accumulators stay in registers. A q tile is taken
// in two halves of 32 queries, which keeps the score registers small
// beside the two [16 x Dh] accumulators. Interior tiles skip band_keep;
// rows and keys at or past T load as zeros and are masked.
//
// Bound: operations, 8·B·H·pairs·Dh flops (four products) — 0.56 ms at
// B 2, H 8, T 8192, Dh 128 and 989 TFLOP/s. Shortfalls as in flash_fwd.cu.

#include "flash_common.cuh"

namespace flash {
namespace {

constexpr int kHalf = kBlock / 2;  // queries per score pass

template <int D>
struct DkvSmem {
  static constexpr size_t tile = kBlock * (D + kPad) * sizeof(bf16);
  static constexpr size_t vecs = 6 * tile;  // K, V, Q[2], dO[2], then
  static constexpr size_t bytes = vecs + 4 * kBlock * sizeof(float);  // lse[2], delta[2]
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = D + kPad;
  constexpr int kTile = kBlock * ld;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;        // two buffers
  bf16* do_s = q_s + 2 * kTile;   // two buffers
  float* lse_s = reinterpret_cast<float*>(smem + DkvSmem<D>::vecs);  // two buffers
  float* dl_s = lse_s + 2 * kBlock;                                 // two buffers

  const int kj = blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = kj * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_w = warp * 16;  // this warp's first key row in the block
  const float sl2 = p.scale * kLog2e;

  int lo, hi;
  q_range(p, kj, lo, hi);
  load_rows<D>(k_s, k, p, b, h, k0);
  load_rows<D>(v_s, v, p, b, h, k0);
  if (lo < hi) {
    load_rows<D>(q_s, q, p, b, h, lo * kBlock);
    load_rows<D>(do_s, dout, p, b, h, lo * kBlock);
    load_vec(lse_s, lse, p, b, h, lo * kBlock, kLog2e);
    load_vec(dl_s, delta, p, b, h, lo * kBlock, 1.f);
  }
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int qi = lo; qi < hi; ++qi) {
    const int buf = (qi - lo) & 1;
    if (qi + 1 < hi) {
      const int nb = buf ^ 1;
      load_rows<D>(q_s + nb * kTile, q, p, b, h, (qi + 1) * kBlock);
      load_rows<D>(do_s + nb * kTile, dout, p, b, h, (qi + 1) * kBlock);
      load_vec(lse_s + nb * kBlock, lse, p, b, h, (qi + 1) * kBlock, kLog2e);
      load_vec(dl_s + nb * kBlock, delta, p, b, h, (qi + 1) * kBlock, 1.f);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = q_s + buf * kTile;
    const bf16* dot = do_s + buf * kTile;
    const float* ls = lse_s + buf * kBlock;
    const float* dls = dl_s + buf * kBlock;
    const bool masked = !interior(p, qi, kj);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float st[kHalf / 8][4], dpt[kHalf / 8][4];
      zero(st);
      zero(dpt);
      gemm_abt<D, kHalf>(st, k_s, qt + half * kHalf * ld, ld, row_w);
      gemm_abt<D, kHalf>(dpt, v_s, dot + half * kHalf * ld, ld, row_w);
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = half * kHalf + nt * 8 + 2 * c + (e & 1);  // query
          float pr = exp2f(st[nt][e] * sl2 - ls[col]);
          if (masked && !keep(p, qi * kBlock + col, k0 + row_w + g + 8 * (e >> 1))) pr = 0.f;
          st[nt][e] = pr;
          dpt[nt][e] = pr * (dpt[nt][e] - dls[col]) * p.scale;  // ds^T
        }
      }
      gemm_pb<kHalf, D>(dv_acc, st, dot, ld, half * kHalf);
      gemm_pb<kHalf, D>(dk_acc, dpt, qt, ld, half * kHalf);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dk_acc, p, b, h, k0 + row_w, one);
  store_rows<D>(dv, dv_acc, p, b, h, k0 + row_w, one);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<D>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.T + kBlock - 1) / kBlock, p.B * p.H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/dout/dk/dv [B, T, H, D]
// bf16, lse/delta [B, H, T] f32; window <= 0 means none. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int T, int H, int D, int causal, int window, float scale,
                             void* stream) {
  if (B < 0 || T < 0 || H < 1 || B * H > 65535 || (D != 64 && D != 128) ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const flash::Problem p{B, T, H, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return flash::launch<64>(q, k, v, dout, lse, delta, dk, dv, p, s);
  return flash::launch<128>(q, k, v, dout, lse, delta, dk, dv, p, s);
}
