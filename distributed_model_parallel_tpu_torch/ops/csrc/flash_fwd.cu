// Flash-attention forward for Hopper (sm_90a): o and the per-row f32
// logsumexp, causal (optionally sliding-window) or full.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_flash_impl` there). Plain version: ops/flash_attention.py
// `flash_forward_plain`. Scores are the f32 product q·k scaled by
// scale = Dh^-0.5 (the same placement as both backward kernels; the
// Pallas forward scales q in the input type instead, which rounds
// differently in bf16), softmax in f32, p rounded to bf16 for p·v, o in
// bf16, lse = m + ln(l) in f32, or -1e30 (JAX's NEG_INF) where l == 0.
//
// The TPU grid is not carried over. There, the third grid dimension runs
// in order and carries m/l/acc in VMEM scratch between steps. Here one CTA
// owns a (b·h, 64-row q block) and loops over the K blocks of its band,
// from `_band_start_k` to `_last_k_block`: blocks outside the band are
// never loaded. Heavier (later) q blocks are scheduled first.
//   * four warps, each owning 16 query rows. S = Q·K^T and acc += P·V run
//     on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate);
//     the Q operand, S, P and acc stay in registers — P goes from S's
//     accumulators straight into the A operand of P·V;
//   * K/V tiles are double-buffered in shared memory with cp.async: the
//     next tile loads while the current one is reduced;
//   * online softmax in f32, log2 domain (exp2f); a row's max and sum live
//     in the four lanes that hold it, the sum reduced once at the end;
//   * interior tiles (`_block_interior`) take the mask-free step; only
//     diagonal, window-edge and ragged-edge tiles evaluate band_keep;
//   * fully masked rows: a row whose max is still -inf exponentiates
//     against 0, so its p is exactly 0 (JAX zeroes masked p for the same
//     reason, exp(NEG_INF - NEG_INF) = 1);
//   * ragged T: rows and keys at or past T load as zeros and are masked;
//     nothing is padded in device memory.
//
// Bound: operations. 4·B·H·pairs·Dh flops (two products over the
// pairs = T(T+1)/2 causal positions) against a few MB of bytes; at the LM
// slice's B 2, H 8, T 8192, Dh 128 that is 0.28 ms at 989 TFLOP/s.
// Shortfalls left for later work: mma.sync instead of wgmma (which alone
// reaches the card's full tensor rate), no TMA or warp specialisation,
// diagonal tiles computed in full and masked.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int D>
struct FwdSmem {
  static constexpr size_t tile = kBlock * (D + kPad) * sizeof(bf16);
  static constexpr size_t bytes = 5 * tile;  // Q, K[2], V[2]
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = D + kPad;
  constexpr int kTile = kBlock * ld;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kTile;      // two buffers
  bf16* v_s = k_s + 2 * kTile;  // two buffers

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = qi * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_w = warp * 16;  // this warp's first row in the block
  const float sl2 = p.scale * kLog2e;

  int lo, hi;
  k_range(p, qi, lo, hi);
  load_rows<D>(q_s, q, p, b, h, q0);
  load_rows<D>(k_s, k, p, b, h, lo * kBlock);
  load_rows<D>(v_s, v, p, b, h, lo * kBlock);
  cp_async_commit();

  float acc[D / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's part of the running sum
  uint32_t qf[D / 16][4];               // Q as A operands, loaded once

  for (int kj = lo; kj <= hi; ++kj) {
    const int buf = (kj - lo) & 1;
    if (kj < hi) {  // prefetch the next K/V tile into the other buffer
      load_rows<D>(k_s + (buf ^ 1) * kTile, k, p, b, h, (kj + 1) * kBlock);
      load_rows<D>(v_s + (buf ^ 1) * kTile, v, p, b, h, (kj + 1) * kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kj == lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], q_s, ld, row_w, kk * 16);
    }
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;

    float s[kBlock / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlock / 16; ++np) {
        uint32_t bb[4];
        load_b_nk(bb, kt, ld, np * 16, kk * 16);
        mma(s[2 * np], qf[kk], bb[0], bb[1]);
        mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
    }

    const bool masked = !interior(p, qi, kj);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (masked && !keep(p, q0 + row_w + g + 8 * (e >> 1), kj * kBlock + nt * 8 + 2 * c + (e & 1)))
          x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // A row with no key yet exponentiates against 0: its p and alpha
      // are exp2(-inf) = 0, and l and acc stay 0.
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base);
      m[r] = m_new;
      mx[r] = base;  // reused below as the row's exponent base
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pr;
        l[e >> 1] += pr;
      }
    }
    gemm_pb<kBlock, D>(acc, s, vt, ld, 0);
    __syncthreads();  // all warps are done with this buffer before refill
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
  store_rows<D>(o, acc, p, b, h, q0 + row_w, inv);
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + row_w + g + 8 * r;
      if (t < p.T)
        lse[((size_t)b * p.H + h) * p.T + t] = l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const Problem& p,
           cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<D>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.T + kBlock - 1) / kBlock, p.B * p.H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/o [B, T, H, D] bf16,
// lse [B, H, T] f32; window <= 0 means none. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what the kernel does not
// take; the Python wrapper raises on any non-zero value.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int T, int H, int D, int causal, int window, float scale,
                         void* stream) {
  if (B < 0 || T < 0 || H < 1 || B * H > 65535 || (D != 64 && D != 128) ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const flash::Problem p{B, T, H, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return flash::launch<64>(q, k, v, o, lse, p, s);
  return flash::launch<128>(q, k, v, o, lse, p, s);
}
