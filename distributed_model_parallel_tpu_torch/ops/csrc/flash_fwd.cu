// Flash-attention forward for Hopper (sm_90a): o and the per-row f32
// logsumexp, causal (optionally sliding-window) or full.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// distributed_model_parallel_tpu/ops/pallas_attention.py (launched by
// `_flash_impl` there). Plain version: ops/flash_attention.py
// `flash_forward_plain`. Scores are the f32 product q·k scaled by
// scale = Dh^-0.5 (the same placement as both backward kernels; the
// Pallas forward scales q in the input type instead, which rounds
// differently in bf16), softmax in f32 in the log2 domain, p rounded to
// bf16 for p·v, o in bf16, lse = m + ln(l) in f32, or -1e30 (JAX's
// NEG_INF) where l == 0.
//
// What bounds it: operations. 4·B·H·pairs·Dh flops (two products over
// the attended pairs) against a few MB of bytes; at the LM slice's B 2,
// H 8, T 8192, Dh 128 (causal) that is 0.28 ms at 989 TFLOP/s. Only
// wgmma reaches that tensor rate, and only if the operand loads and the
// softmax hide behind it.
//
// The design (FlashAttention-3's shape):
//   * one CTA owns a 128-row q block of one (b, h), heaviest (latest)
//     blocks first; it loops over the 128-key tiles of its band
//     (`_band_start_k` .. `_last_k_block`) — the TPU's sequential grid
//     axis that carries m/l/acc in VMEM becomes this loop;
//   * one producer thread issues TMA loads: Q once, then K and V tiles
//     through a 2-stage ring in shared memory (128-byte swizzle). K and V
//     each have a full and an empty mbarrier per stage, so S can start
//     before V lands and a K slot refills while its V is still in use.
//     TMA zero-fills rows at or past T: the ragged edge needs no code;
//   * two consumer warpgroups own 64 rows each. S = Q·K^T is
//     wgmma m64n128k16 with both operands in shared memory (Dh is the
//     contraction and is contiguous in both); O += P·V is wgmma with P
//     from registers — S's accumulator fragment rounded to bf16 is the
//     register-A fragment — and V from shared memory with the transpose
//     bit. S, P, O, m and l never leave registers;
//   * intra-warpgroup overlap: tile j's S is issued together with tile
//     j - 1's P·V, and tile j's softmax runs while that P·V is still in
//     flight on the tensor cores; the two consumers interleave on their
//     own (ordering them with named barriers measured no faster);
//   * setmaxnreg moves registers from the producer warpgroup (24 each)
//     to the consumers (240 each);
//   * online softmax in f32 (exp2 on the special-function unit):
//     interior tiles (`_block_interior`) take the mask-free step; only
//     diagonal, window-edge and ragged tiles evaluate band_keep; a row
//     whose max is still -inf exponentiates against 0, so its p is
//     exactly 0 (JAX zeroes masked p for the same reason,
//     exp(NEG_INF - NEG_INF) = 1).
// Left for later work: skipping the masked half of diagonal tiles, a
// persistent grid, TMA stores of o.

#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

constexpr int kBlockQ = 128;   // q rows per CTA
constexpr int kBlockK = 128;   // keys per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kFwdThreads = (kConsumers + 1) * 128;  // + the producer warpgroup

template <int D>
struct FwdSmem {
  static constexpr int boxes = D / 64;                 // 64-column boxes per row
  static constexpr uint32_t box = kBlockK * kRowBytes;  // 16 KB
  static constexpr uint32_t tile = boxes * box;        // a Q, K or V tile
  static constexpr size_t k_off = tile;
  static constexpr size_t v_off = k_off + kStages * tile;
  static constexpr size_t bar_off = v_off + kStages * tile;
  // q full; per stage: k full, v full, k empty, v empty
  static constexpr int n_bars = 1 + 4 * kStages;
  // + 1024 to align the carve-up to the swizzle's 1024-byte period.
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

// S = Q·K^T for one warpgroup's 64 rows: Dh / 16 k-steps, 32 bytes each
// inside a 128-byte swizzled row, boxes of 64 columns 16 KB apart.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kBlockK / 8][4], const unsigned char* q_wg,
                                        const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * FwdSmem<D>::box + (kk % 4) * 32;
    sm90::wgmma_ss_m64n128k16(sc, sm90::desc_sw128(q_wg + off, 16, 1024),
                              sm90::desc_sw128(kt + off, 16, 1024), kk > 0);
  }
}

// O += P·V: 8 k-steps of 16 keys (2048 bytes of V each); V is MN-major
// (Dh contiguous), its 64-column boxes one LBO apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 8][4],
                                         const uint32_t (&pa)[kBlockK / 16][4],
                                         const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    sm90::wgmma_rs<D>(acc, pa[kk],
                      sm90::desc_sw128(vt + kk * 16 * kRowBytes, FwdSmem<D>::box, 1024), 1);
}

// Online softmax of one tile of scores, in place: sc becomes p (f32),
// m and l advance, alpha is the factor the accumulator must be scaled by.
// Rows row_w + g and row_w + g + 8 of this lane; log2 units.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockK / 8][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], bool masked,
                                             const Problem& p, int row_w, int k0, float sl2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked && !keep(p, row_w + g + 8 * (e >> 1), k0 + nt * 8 + 2 * c + (e & 1)))
        sc[nt][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl2);
    // A row with no key yet exponentiates against 0: its p and alpha are
    // 2^-inf = 0, and l and acc stay 0.
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = sm90::fast_exp2(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = sm90::fast_exp2(fmaf(sc[nt][e], sl2, -base[e >> 1]));
      sc[nt][e] = pr;
      l[e >> 1] += pr;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, Problem p) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
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
      sm90::mbar_expect_tx(q_full, L::tile);
      for (int x = 0; x < L::boxes; ++x)
        sm90::tma_load_4d(q_s + x * L::box, &tm_q, q_full, x * 64, h, q0, b);
      for (int kj = lo; kj <= hi; ++kj) {
        const int it = kj - lo;
        const int s = it % kStages;
        const uint32_t reuse = ((it / kStages) - 1) & 1;  // phase that freed the slot
        // A slot is free once both consumers released its previous tile.
        if (it >= kStages) sm90::mbar_wait(k_empty + s, reuse);
        sm90::mbar_expect_tx(k_full + s, L::tile);
        for (int x = 0; x < L::boxes; ++x)
          sm90::tma_load_4d(k_s + s * L::tile + x * L::box, &tm_k, k_full + s, x * 64, h,
                            kj * kBlockK, b);
        if (it >= kStages) sm90::mbar_wait(v_empty + s, reuse);
        sm90::mbar_expect_tx(v_full + s, L::tile);
        for (int x = 0; x < L::boxes; ++x)
          sm90::tma_load_4d(v_s + s * L::tile + x * L::box, &tm_v, v_full + s, x * 64, h,
                            kj * kBlockK, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    sm90::reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int c = lane & 3;
    const int r0 = q0 + wg * 64;        // this warpgroup's first row
    const int row_w = r0 + warp * 16;   // this warp's first row
    const float sl2 = p.scale * kLog2e;
    // This warpgroup's 64 rows start 64 swizzled rows into each Q box.
    const unsigned char* q_wg = q_s + wg * 64 * kRowBytes;

    float acc[D / 8][4];
    zero(acc);
    float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows g, g + 8
    float l[2] = {0.f, 0.f};              // this lane's part of the running sum
    float alpha[2];
    float sc[kBlockK / 8][4];
    uint32_t pa[kBlockK / 16][4];

    // Tile lo: S alone.
    sm90::mbar_wait(q_full, 0);
    sm90::mbar_wait(k_full, 0);
    sm90::wgmma_fence();
    issue_s<D>(sc, q_wg, k_s);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::mbar_arrive(k_empty);
    softmax_tile(sc, m, l, alpha, !interior_rows<64, kBlockK>(p, r0, lo * kBlockK), p, row_w,
                 lo * kBlockK, sl2);
    pack_a(pa, sc);

    // Tile kj: S_kj is issued with P·V of tile kj - 1 behind it, and the
    // softmax of S_kj runs while P·V is in flight.
    for (int kj = lo + 1; kj <= hi; ++kj) {
      const int it = kj - lo;
      const int s = it % kStages;
      const int sp = (it - 1) % kStages;
      sm90::mbar_wait(k_full + s, (it / kStages) & 1);
      sm90::mbar_wait(v_full + sp, ((it - 1) / kStages) & 1);
      sm90::wgmma_fence();
      issue_s<D>(sc, q_wg, k_s + s * L::tile);
      sm90::wgmma_commit();
      issue_pv<D>(acc, pa, v_s + sp * L::tile);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      sm90::mbar_arrive(k_empty + s);
      softmax_tile(sc, m, l, alpha, !interior_rows<64, kBlockK>(p, r0, kj * kBlockK), p, row_w,
                   kj * kBlockK, sl2);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(v_empty + sp);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }
      pack_a(pa, sc);
    }

    // P·V of tile hi.
    {
      const int it = hi - lo;
      const int s = it % kStages;
      sm90::mbar_wait(v_full + s, (it / kStages) & 1);
      sm90::wgmma_fence();
      issue_pv<D>(acc, pa, v_s + s * L::tile);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    }
    store_rows<D>(o, acc, p, b, h, row_w, inv);
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row_w + g + 8 * r;
        if (t < p.T)
          lse[((size_t)b * p.H + h) * p.T + t] = l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const Problem& p,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = sm90::encode_bthd(&tq, q, p.B, p.T, p.H, D, kBlockQ);
  if (e == 0) e = sm90::encode_bthd(&tk, k, p.B, p.T, p.H, D, kBlockK);
  if (e == 0) e = sm90::encode_bthd(&tv, v, p.B, p.T, p.H, D, kBlockK);
  if (e != 0) return e;
  constexpr size_t smem = FwdSmem<D>::bytes;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((p.T + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_fwd_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes). q/k/v/o [B, T, H, D] bf16,
// lse [B, H, T] f32; window <= 0 means none. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what the kernel does not
// take (or a TMA descriptor it cannot encode); the Python wrapper raises
// on any non-zero value.
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
