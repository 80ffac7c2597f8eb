// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_bwd_dkv_call` there). Plain version: ops/flash_attention.py
// `flash_bwd_dkv_plain`. For each key row j:
//   p_ij  = exp2(scale·log2e · q_i·k_j − log2e · lse_i)  (recomputed, f32)
//   dv_j  = Σ_i p_ij dO_i                               (p rounded to bf16)
//   ds_ij = p_ij · (dO_i·v_j − delta_i) · scale          (rounded to bf16)
//   dk_j  = Σ_i ds_ij q_i
// f32 accumulate, dk/dv out in bf16. The scale multiplies the f32 product.
//
// What bounds it: operations. 8·B·H·pairs·Dh flops (four products over
// the attended pairs) against a few tens of MB; at the LM slice's B 2,
// H 8, T 8192, Dh 128 (causal) that is 0.56 ms at 989 TFLOP/s. Only
// wgmma reaches that rate; the two [keys x Dh] f32 accumulators and the
// two score tiles all live in a consumer's registers, so the register
// budget decides the tile shape.
//
// The design (FlashAttention-3's tile shape at Dh 128; dq stays in its
// own kernel, so there are no atomics and dk/dv are the same bit for bit
// from run to run):
//   * one CTA owns a 128-key block of one (b, h), earliest (most
//     attended under causal) blocks first, and loops over the 64-query
//     tiles of `_q_bounds_for_k` (from the diagonal on; a window also
//     stops at the band's far edge);
//   * K and V are loaded once by TMA; one producer warp streams Q and dO
//     tiles through a ring of kStages slots (TMA, 128-byte swizzle, zeros
//     past T) with a full and an empty mbarrier per slot. lse and delta of
//     the tile's 64 queries go into the same slot by 4-byte cp.async
//     (zeros past T) whose completion the slot's full barrier counts —
//     a TMA map over [B, H, T] f32 would need T·4 to be a multiple of 16;
//   * two consumer warpgroups own 64 keys each and work in transposed
//     score space: S^T = K·Q^T and dP^T = V·dO^T are SS wgmma m64n64k16
//     over Dh; P^T and dS^T, rounded to bf16, are the register-A
//     fragments of dV += P^T·dO and dK += dS^T·Q, RS wgmma with dO and Q
//     read MN-major through the transpose bit (each tile is loaded once
//     and read both ways). dK and dV stay in registers for the loop;
//   * overlap inside a warpgroup: P^T is formed while dP^T is in flight
//     and dS^T while dV's product is; the two consumers interleave on
//     their own. Every product retires inside its own tile: with dK's
//     product left in flight under the next tile's S^T, ptxas serialized
//     the wgmma (C7515) and the kernel ran slower on the card;
//   * setmaxnreg moves registers from the producer warpgroup (24 each)
//     to the consumers (240 each): 64 + 64 accumulators, 32 + 32 scores
//     and 2 x 16 packed A registers at the peak (Dh 128);
//   * interior tiles (`_block_interior`, per warpgroup) skip band_keep;
//     only diagonal, window-edge and ragged tiles evaluate it.

#include "flash_common.cuh"

namespace flash {
namespace {

constexpr int kBlockK = 128;   // keys per CTA
constexpr int kBlockQ = 64;    // queries per tile
constexpr int kStages = 2;     // Q/dO ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 keys
constexpr int kDkvThreads = (kConsumers + 1) * 128;  // + the producer warpgroup

template <int D>
struct DkvSmem {
  static constexpr int boxes = D / 64;                   // 64-column boxes per row
  static constexpr uint32_t k_box = kBlockK * kRowBytes;  // 16 KB
  static constexpr uint32_t q_box = kBlockQ * kRowBytes;  // 8 KB
  static constexpr uint32_t k_tile = boxes * k_box;       // K or V
  static constexpr uint32_t q_tile = boxes * q_box;       // a Q or dO slot
  static constexpr size_t v_off = k_tile;
  static constexpr size_t q_off = 2 * k_tile;
  static constexpr size_t do_off = q_off + kStages * q_tile;
  static constexpr size_t lse_off = do_off + kStages * q_tile;     // f32 [kStages][64]
  static constexpr size_t dl_off = lse_off + kStages * kBlockQ * 4;  // f32 [kStages][64]
  static constexpr size_t bar_off = dl_off + kStages * kBlockQ * 4;
  // k/v full; per stage: full, empty
  static constexpr int n_bars = 1 + 2 * kStages;
  // + 1024 to align the carve-up to the swizzle's 1024-byte period.
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

// P^T = exp2(S^T·sl2 − lse2[col]) in place of the scores, 0 where
// band_keep is false. Keys row_w + g and row_w + g + 8 of this lane;
// queries from q0, whose lse (natural log) are ls[0..64).
__device__ __forceinline__ void p_tile(float (&sc)[kBlockQ / 8][4], const float* ls,
                                       bool masked, const Problem& p, int row_w, int q0,
                                       float sl2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kBlockQ / 8; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(ls + nt * 8 + 2 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse2 = ((e & 1) ? l.y : l.x) * kLog2e;
      float pr = sm90::fast_exp2(fmaf(sc[nt][e], sl2, -lse2));
      if (masked && !keep(p, q0 + nt * 8 + 2 * c + (e & 1), row_w + g + 8 * (e >> 1))) pr = 0.f;
      sc[nt][e] = pr;
    }
  }
}

// dS^T = P^T ∘ (dP^T − delta[col]) · scale in place of dP^T.
__device__ __forceinline__ void ds_tile(float (&dp)[kBlockQ / 8][4],
                                        const float (&pt)[kBlockQ / 8][4], const float* dls,
                                        float scale) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kBlockQ / 8; ++nt) {
    const float2 d = *reinterpret_cast<const float2*>(dls + nt * 8 + 2 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[nt][e] = pt[nt][e] * (dp[nt][e] - ((e & 1) ? d.y : d.x)) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + L::v_off;
  unsigned char* q_s = smem + L::q_off;
  unsigned char* do_s = smem + L::do_off;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl_s = reinterpret_cast<float*>(smem + L::dl_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kBlockK;
  const int wg = threadIdx.x / 128;
  int lo, hi;
  q_range_rows<kBlockQ, kBlockK>(p, k0, lo, hi);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1 + 32);  // the TMA thread + 32 cp.async arrivals
      sm90::mbar_init(empty + s, kConsumers * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp keeps the ring full ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x < kConsumers * 128 + 32) {
      const int lane = threadIdx.x & 31;
      const size_t vec0 = ((size_t)b * p.H + h) * p.T;
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_full, 2 * L::k_tile);
        for (int x = 0; x < L::boxes; ++x) {
          sm90::tma_load_4d(k_s + x * L::k_box, &tm_k, kv_full, x * 64, h, k0, b);
          sm90::tma_load_4d(v_s + x * L::k_box, &tm_v, kv_full, x * 64, h, k0, b);
        }
      }
      for (int qi = lo; qi < hi; ++qi) {
        const int it = qi - lo;
        const int s = it % kStages;
        const int t0 = qi * kBlockQ;
        // A slot is free once both consumers released its previous tile.
        if (it >= kStages) sm90::mbar_wait(empty + s, ((it / kStages) - 1) & 1);
        for (int r = lane; r < kBlockQ; r += 32) {
          const bool valid = t0 + r < p.T;
          const size_t i = vec0 + (valid ? t0 + r : 0);
          sm90::cp_async4(lse_s + s * kBlockQ + r, lse + i, valid);
          sm90::cp_async4(dl_s + s * kBlockQ + r, delta + i, valid);
        }
        sm90::cp_async_mbar_arrive(full + s);
        if (lane == 0) {
          sm90::mbar_expect_tx(full + s, 2 * L::q_tile);
          for (int x = 0; x < L::boxes; ++x) {
            sm90::tma_load_4d(q_s + s * L::q_tile + x * L::q_box, &tm_q, full + s, x * 64, h,
                              t0, b);
            sm90::tma_load_4d(do_s + s * L::q_tile + x * L::q_box, &tm_do, full + s, x * 64,
                              h, t0, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    sm90::reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int r0 = k0 + wg * 64;        // this warpgroup's first key
    const int row_w = r0 + warp * 16;   // this warp's first key
    const float sl2 = p.scale * kLog2e;
    // This warpgroup's 64 keys start 64 swizzled rows into each box.
    const unsigned char* k_wg = k_s + wg * 64 * kRowBytes;
    const unsigned char* v_wg = v_s + wg * 64 * kRowBytes;

    float dk_acc[D / 8][4], dv_acc[D / 8][4];
    zero(dk_acc);
    zero(dv_acc);
    float st[kBlockQ / 8][4], dpt[kBlockQ / 8][4];
    uint32_t pa[kBlockQ / 16][4], dsa[kBlockQ / 16][4];

    sm90::mbar_wait(kv_full, 0);
    for (int qi = lo; qi < hi; ++qi) {
      const int it = qi - lo;
      const int s = it % kStages;
      const int t0 = qi * kBlockQ;
      const unsigned char* qt = q_s + s * L::q_tile;
      const unsigned char* dot = do_s + s * L::q_tile;
      sm90::mbar_wait(full + s, (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_ss64<D>(st, k_wg, L::k_box, qt, L::q_box);
      sm90::wgmma_commit();
      issue_ss64<D>(dpt, v_wg, L::k_box, dot, L::q_box);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S^T
      sm90::fence_regs(st);
      p_tile(st, lse_s + s * kBlockQ, !interior_rows<kBlockQ, 64>(p, t0, r0), p, row_w, t0,
             sl2);
      pack_a(pa, st);
      sm90::wgmma_fence();
      issue_rs64<D>(dv_acc, pa, dot, L::q_box);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dP^T
      sm90::fence_regs(dpt);
      ds_tile(dpt, st, dl_s + s * kBlockQ, p.scale);
      pack_a(dsa, dpt);
      sm90::wgmma_fence();
      issue_rs64<D>(dk_acc, dsa, qt, L::q_box);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(pa);
      sm90::fence_regs(dk_acc);
      sm90::fence_regs(dsa);
      sm90::mbar_arrive(empty + s);
    }

    const float one[2] = {1.f, 1.f};
    store_rows<D>(dk, dk_acc, p, b, h, row_w, one);
    store_rows<D>(dv, dv_acc, p, b, h, row_w, one);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int e = sm90::encode_bthd(&tq, q, p.B, p.T, p.H, D, kBlockQ);
  if (e == 0) e = sm90::encode_bthd(&tdo, dout, p.B, p.T, p.H, D, kBlockQ);
  if (e == 0) e = sm90::encode_bthd(&tk, k, p.B, p.T, p.H, D, kBlockK);
  if (e == 0) e = sm90::encode_bthd(&tv, v, p.B, p.T, p.H, D, kBlockK);
  if (e != 0) return e;
  constexpr size_t smem = DkvSmem<D>::bytes;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((p.T + kBlockK - 1) / kBlockK, p.B * p.H);
  flash_bwd_dkv_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/dout/dk/dv [B, T, H, D]
// bf16, lse/delta [B, H, T] f32; window <= 0 means none. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take (or a TMA descriptor it cannot encode); the
// Python wrapper raises on any non-zero value.
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
