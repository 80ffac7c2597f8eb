// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_bwd_dq_call` there). Plain version: ops/flash_attention.py
// `flash_bwd_dq_plain`. For each query row i:
//   p_ij  = exp2(scale·log2e · q_i·k_j − log2e · lse_i)  (recomputed, f32)
//   ds_ij = p_ij · (dO_i·v_j − delta_i) · scale          (rounded to bf16)
//   dq_i  = Σ_j ds_ij k_j                               (f32 accumulate, bf16 out)
// with delta = rowsum(dO·O) from the wrapper. The scale multiplies the
// f32 product, as in the Pallas backward and the port's forward.
//
// What bounds it: operations. 6·B·H·pairs·Dh flops (S = Q·K^T is
// recomputed beside dP = dO·V^T and dq += dS·K) against a few tens of MB;
// at the LM slice's B 2, H 8, T 8192, Dh 128 (causal) that is 0.42 ms at
// 989 TFLOP/s. Only wgmma reaches that rate, and only if the K/V loads
// and the elementwise dS hide behind it.
//
// The design (the forward's, flash_fwd.cu, with dq's products):
//   * one CTA owns a 128-row q block of one (b, h), heaviest (latest)
//     blocks first, and loops over the 64-key tiles of its band; nothing
//     crosses CTAs, so there are no atomics and dq is the same bit for bit
//     from run to run;
//   * one producer thread issues TMA loads: Q and dO once, then K and V
//     tiles through a ring of kStages slots (128-byte swizzle, zeros past
//     T), each with a full and an empty mbarrier. V's slot frees as soon
//     as dP is done, K's once dq += dS·K has read it;
//   * two consumer warpgroups own 64 rows each. S = Q·K^T and dP = dO·V^T
//     are SS wgmma m64n64k16 over Dh; dS is formed in registers and, in
//     bf16, is the register-A fragment of dq += dS·K, an RS wgmma with K
//     read MN-major through the transpose bit (the K tile is loaded once
//     and read both ways). lse and delta of a consumer's rows are read
//     into registers once; dq stays in registers for the whole loop;
//   * tile j's S and dP are issued with tile j − 1's dS·K behind them,
//     and dS of tile j is formed while that product is still in flight;
//   * setmaxnreg moves registers from the producer warpgroup (24 each)
//     to the consumers (240 each);
//   * interior tiles (`_block_interior`, per warpgroup) skip band_keep;
//     only diagonal, window-edge and ragged tiles evaluate it.

#include "flash_common.cuh"

namespace flash {
namespace {

constexpr int kBlockQ = 128;   // q rows per CTA
constexpr int kBlockK = 64;    // keys per tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kDqThreads = (kConsumers + 1) * 128;  // + the producer warpgroup

template <int D>
struct DqSmem {
  static constexpr int boxes = D / 64;                   // 64-column boxes per row
  static constexpr uint32_t q_box = kBlockQ * kRowBytes;  // 16 KB
  static constexpr uint32_t k_box = kBlockK * kRowBytes;  // 8 KB
  static constexpr uint32_t q_tile = boxes * q_box;       // Q or dO
  static constexpr uint32_t k_tile = boxes * k_box;       // a K or V slot
  static constexpr size_t do_off = q_tile;
  static constexpr size_t k_off = 2 * q_tile;
  static constexpr size_t v_off = k_off + kStages * k_tile;
  static constexpr size_t bar_off = v_off + kStages * k_tile;
  // q/dO full; per stage: k full, v full, k empty, v empty
  static constexpr int n_bars = 1 + 4 * kStages;
  // + 1024 to align the carve-up to the swizzle's 1024-byte period.
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

// dS = P ∘ (dP − delta) · scale in place of the scores, P = exp2(S·sl2 −
// lse2), 0 where band_keep is false. Rows row_w + g and row_w + g + 8 of
// this lane; keys from k0.
__device__ __forceinline__ void ds_tile(float (&sc)[kBlockK / 8][4],
                                        const float (&dp)[kBlockK / 8][4],
                                        const float (&lse2)[2], const float (&dl)[2],
                                        bool masked, const Problem& p, int row_w, int k0,
                                        float sl2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pr = sm90::fast_exp2(fmaf(sc[nt][e], sl2, -lse2[r]));
      if (masked && !keep(p, row_w + g + 8 * r, k0 + nt * 8 + 2 * c + (e & 1))) pr = 0.f;
      sc[nt][e] = pr * (dp[nt][e] - dl[r]) * p.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, Problem p) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + L::do_off;
  unsigned char* k_s = smem + L::k_off;
  unsigned char* v_s = smem + L::v_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = qi * kBlockQ;
  const int wg = threadIdx.x / 128;
  int lo, hi;
  k_range_rows<kBlockQ, kBlockK>(p, q0, lo, hi);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(k_empty + s, kConsumers * 128);
      sm90::mbar_init(v_empty + s, kConsumers * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128) {
      sm90::mbar_expect_tx(q_full, 2 * L::q_tile);
      for (int x = 0; x < L::boxes; ++x) {
        sm90::tma_load_4d(q_s + x * L::q_box, &tm_q, q_full, x * 64, h, q0, b);
        sm90::tma_load_4d(do_s + x * L::q_box, &tm_do, q_full, x * 64, h, q0, b);
      }
      for (int kj = lo; kj <= hi; ++kj) {
        const int it = kj - lo;
        const int s = it % kStages;
        const uint32_t reuse = ((it / kStages) - 1) & 1;  // phase that freed the slot
        if (it >= kStages) sm90::mbar_wait(k_empty + s, reuse);
        sm90::mbar_expect_tx(k_full + s, L::k_tile);
        for (int x = 0; x < L::boxes; ++x)
          sm90::tma_load_4d(k_s + s * L::k_tile + x * L::k_box, &tm_k, k_full + s, x * 64, h,
                            kj * kBlockK, b);
        if (it >= kStages) sm90::mbar_wait(v_empty + s, reuse);
        sm90::mbar_expect_tx(v_full + s, L::k_tile);
        for (int x = 0; x < L::boxes; ++x)
          sm90::tma_load_4d(v_s + s * L::k_tile + x * L::k_box, &tm_v, v_full + s, x * 64, h,
                            kj * kBlockK, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    sm90::reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int r0 = q0 + wg * 64;        // this warpgroup's first row
    const int row_w = r0 + warp * 16;   // this warp's first row
    const float sl2 = p.scale * kLog2e;
    // This warpgroup's 64 rows start 64 swizzled rows into each box.
    const unsigned char* q_wg = q_s + wg * 64 * kRowBytes;
    const unsigned char* do_wg = do_s + wg * 64 * kRowBytes;

    // lse (log2 units) and delta of this lane's rows g and g + 8.
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row_w + g + 8 * r;
      const size_t i = ((size_t)b * p.H + h) * p.T + (t < p.T ? t : 0);
      lse2[r] = t < p.T ? lse[i] * kLog2e : 0.f;
      dl[r] = t < p.T ? delta[i] : 0.f;
    }

    float acc[D / 8][4];
    zero(acc);
    float sc[kBlockK / 8][4], dp[kBlockK / 8][4];
    uint32_t pa[kBlockK / 16][4];

    // Tile lo: S and dP alone.
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(k_full, 0);
    sm90::mbar_wait(v_full, 0);
    sm90::wgmma_fence();
    issue_ss64<D>(sc, q_wg, L::q_box, k_s, L::k_box);
    issue_ss64<D>(dp, do_wg, L::q_box, v_s, L::k_box);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::mbar_arrive(v_empty);
    ds_tile(sc, dp, lse2, dl, !interior_rows<64, kBlockK>(p, r0, lo * kBlockK), p, row_w,
            lo * kBlockK, sl2);
    pack_a(pa, sc);

    // Tile kj: S and dP of kj are issued with dS·K of tile kj - 1 behind
    // them, and dS of kj is formed while that product is in flight.
    for (int kj = lo + 1; kj <= hi; ++kj) {
      const int it = kj - lo;
      const int s = it % kStages;
      const int sp = (it - 1) % kStages;
      const uint32_t par = (it / kStages) & 1;
      sm90::mbar_wait(k_full + s, par);
      sm90::mbar_wait(v_full + s, par);
      sm90::wgmma_fence();
      issue_ss64<D>(sc, q_wg, L::q_box, k_s + s * L::k_tile, L::k_box);
      issue_ss64<D>(dp, do_wg, L::q_box, v_s + s * L::k_tile, L::k_box);
      sm90::wgmma_commit();
      issue_rs64<D>(acc, pa, k_s + sp * L::k_tile, L::k_box);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::mbar_arrive(v_empty + s);
      ds_tile(sc, dp, lse2, dl, !interior_rows<64, kBlockK>(p, r0, kj * kBlockK), p, row_w,
              kj * kBlockK, sl2);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(k_empty + sp);
      pack_a(pa, sc);
    }

    // dS·K of tile hi.
    sm90::wgmma_fence();
    issue_rs64<D>(acc, pa, k_s + ((hi - lo) % kStages) * L::k_tile, L::k_box);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(pa);

    const float one[2] = {1.f, 1.f};
    store_rows<D>(dq, acc, p, b, h, row_w, one);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, const Problem& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = sm90::encode_bthd(&tq, q, p.B, p.T, p.H, D, kBlockQ);
  if (e == 0) e = sm90::encode_bthd(&tdo, dout, p.B, p.T, p.H, D, kBlockQ);
  if (e == 0) e = sm90::encode_bthd(&tk, k, p.B, p.T, p.H, D, kBlockK);
  if (e == 0) e = sm90::encode_bthd(&tv, v, p.B, p.T, p.H, D, kBlockK);
  if (e != 0) return e;
  constexpr size_t smem = DqSmem<D>::bytes;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((p.T + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_bwd_dq_kernel<D><<<grid, kDqThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/dout/dq [B, T, H, D]
// bf16, lse/delta [B, H, T] f32; window <= 0 means none. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take (or a TMA descriptor it cannot encode); the
// Python wrapper raises on any non-zero value.
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
