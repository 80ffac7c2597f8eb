// Flash-attention backward, dq, for Hopper (sm_90a) — FlashAttention-2.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_bwd_dq_call` there). Plain version: ops/flash_attention.py
// `flash_bwd_dq_plain`. For each query row i:
//   p_ij  = exp(scale · q_i·k_j − lse_i)       (recomputed, f32)
//   ds_ij = p_ij · (dO_i·v_j − delta_i) · scale  (rounded to bf16)
//   dq_i  = Σ_j ds_ij k_j                       (f32 accumulate, bf16 out)
// with delta = rowsum(dO·O) from the wrapper. The scale multiplies the
// f32 product, as in the Pallas backward and the port's forward.
//
// Design: one CTA per (b·h, 64-row q block), heavier blocks first, looping
// over the K blocks of the causal (or windowed) band; nothing crosses
// CTAs, so there are no atomics. Four warps each own 16 query rows. Q and
// dO stay in shared memory for the whole loop; K and V tiles are
// double-buffered with cp.async. S = Q·K^T and dP = dO·V^T are mma.sync
// products into registers; dS is formed there and goes from the
// accumulators straight into the A operand of dq += dS·K, whose
// accumulators stay in registers too. Interior tiles skip band_keep; rows
// and keys at or past T load as zeros and are masked, so nothing is
// padded.
//
// Bound: operations, 6·B·H·pairs·Dh flops (three products) — 0.42 ms at
// B 2, H 8, T 8192, Dh 128 and 989 TFLOP/s; S is recomputed here (that
// product is not counted as model work). Shortfalls as in flash_fwd.cu.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int D>
struct DqSmem {
  static constexpr size_t tile = kBlock * (D + kPad) * sizeof(bf16);
  static constexpr size_t bytes = 6 * tile;  // Q, dO, K[2], V[2]
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = D + kPad;
  constexpr int kTile = kBlock * ld;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTile;
  bf16* k_s = do_s + kTile;     // two buffers
  bf16* v_s = k_s + 2 * kTile;  // two buffers

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = qi * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_w = warp * 16;
  const float sl2 = p.scale * kLog2e;

  int lo, hi;
  k_range(p, qi, lo, hi);
  load_rows<D>(q_s, q, p, b, h, q0);
  load_rows<D>(do_s, dout, p, b, h, q0);
  load_rows<D>(k_s, k, p, b, h, lo * kBlock);
  load_rows<D>(v_s, v, p, b, h, lo * kBlock);
  cp_async_commit();

  // lse (log2 units) and delta of this lane's rows g and g + 8.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row_w + g + 8 * r;
    const size_t i = ((size_t)b * p.H + h) * p.T + (t < p.T ? t : 0);
    lse2[r] = t < p.T ? lse[i] * kLog2e : 0.f;
    dl[r] = t < p.T ? delta[i] : 0.f;
  }

  float acc[D / 8][4];
  zero(acc);
  for (int kj = lo; kj <= hi; ++kj) {
    const int buf = (kj - lo) & 1;
    if (kj < hi) {
      load_rows<D>(k_s + (buf ^ 1) * kTile, k, p, b, h, (kj + 1) * kBlock);
      load_rows<D>(v_s + (buf ^ 1) * kTile, v, p, b, h, (kj + 1) * kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;

    float s[kBlock / 8][4], dp[kBlock / 8][4];
    zero(s);
    zero(dp);
    gemm_abt<D, kBlock>(s, q_s, kt, ld, row_w);
    gemm_abt<D, kBlock>(dp, do_s, vt, ld, row_w);

    const bool masked = !interior(p, qi, kj);
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2f(s[nt][e] * sl2 - lse2[r]);
        if (masked && !keep(p, q0 + row_w + g + 8 * r, kj * kBlock + nt * 8 + 2 * c + (e & 1)))
          pr = 0.f;
        s[nt][e] = pr * (dp[nt][e] - dl[r]) * p.scale;  // ds
      }
    }
    gemm_pb<kBlock, D>(acc, s, kt, ld, 0);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, acc, p, b, h, q0 + row_w, one);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const Problem& p, cudaStream_t stream) {
  constexpr size_t smem = DqSmem<D>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.T + kBlock - 1) / kBlock, p.B * p.H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/dout/dq [B, T, H, D]
// bf16, lse/delta [B, H, T] f32; window <= 0 means none. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int T,
                            int H, int D, int causal, int window, float scale,
                            void* stream) {
  if (B < 0 || T < 0 || H < 1 || B * H > 65535 || (D != 64 && D != 128) ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const flash::Problem p{B, T, H, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return flash::launch<64>(q, k, v, dout, lse, delta, dq, p, s);
  return flash::launch<128>(q, k, v, dout, lse, delta, dq, p, s);
}
