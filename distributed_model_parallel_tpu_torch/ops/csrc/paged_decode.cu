// Paged decode attention for Hopper (sm_90a): one query token per row,
// read through a page table from a pool of fixed-size KV pages.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` of
// distributed_model_parallel_tpu/ops/paged_attention.py (launched by
// `paged_attention_kernel` there). It computes the same function as the
// plain PyTorch version beside it (ops/paged_attention.py:
// `paged_attention_gather` + `attend_rows`): grouped heads (query head h
// reads kv head h / G), the causal band (pos - window, pos], scores and
// softmax in f32, scale Dh^-0.5, output in the input type.
//
// What bounds it: HBM bytes. Per layer the kernel must read
//   sum_b 2 * (tokens read_b) * Hkv * Dh * sizeof(T)
// plus q, the tables and the output, and does ~4 flops per byte read —
// far below the card's ~295 bf16 flops/byte ridge. At the serving
// slice's shapes that is under 8 MB, a few microseconds at 3.35 TB/s, so
// what the kernel has to beat is latency: a row's pages must not be
// walked one after another by one CTA.
//
// The design (flash-decoding):
//   * split: the grid is (B·Hkv, S) with S = ceil(N / kPagesPerSplit);
//     CTA (b·Hkv + kvh, s) takes the logical pages
//     [s·kPagesPerSplit, (s+1)·kPagesPerSplit) ∩ [first, last] of its row
//     (first = the band's first page, last = pos / page). kPagesPerSplit
//     is a compile-time constant, so a row's splits depend only on its own
//     pos, window and table — never on B or the other rows: a request's
//     output does not depend on the batch. A CTA with no pages writes
//     m = -inf, l = 0 and exits;
//   * staging: each page's K and V rows of the CTA's kv head (page rows of
//     Dh at stride Hkv·Dh) are copied with 16-byte cp.async into shared
//     memory in the pool's own type (bf16), double-buffered: the next page
//     loads while this one is reduced. Positions outside the band or past
//     pos, and pages whose id is out of range, are zero-filled by
//     cp.async's src-size 0 — nothing is read, so stale slots (NaN
//     included) never reach arithmetic — and their scores are -inf;
//   * scores: the dot of query head g (f32, in shared memory) and token t
//     is split over a few neighbouring lanes and reduced by shuffles,
//     Dh^-0.5 and log2(e) folded in; all G ≤ 8 heads of the group share
//     one K/V read. Each head's page max and sum are reduced across one
//     warp (shuffles), not walked per thread; thread d then accumulates
//     dimension d of every head from V;
//   * merge: a second launch, one CTA per (b, h), combines the splits in
//     fixed split order — m* = max m_s, out = Σ 2^(m_s - m*)·acc_s /
//     Σ 2^(m_s - m*)·l_s — from f32 scratch the wrapper allocates
//     ((m, l) and acc[Dh] per (b, h, split), sized by paged_decode_splits).
//     No atomics: the result is the same run to run.
// The merge's scratch traffic (a few hundred KB) is the design's cost; it
// is not counted in the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;  // query heads per kv head held in registers
// Logical pages per split CTA: 64 tokens at page 16. 2 and 4 measured level
// on an H100 at the serving slice's shapes, 1 and 8 slower; 4 launches half
// the CTAs and writes half the scratch of 2.
constexpr int kPagesPerSplit = 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// Shared-memory plan of the split kernel. K/V rows are padded by 16 bytes
// so that the 16-byte reads of neighbouring tokens fall in different banks.
template <typename T>
struct Smem {
  int ldq, ldk;  // row strides in elements of q_s (f32) and k_s/v_s (T)
  size_t q, kv, s, stats, bytes;  // byte offsets and total
  __host__ __device__ Smem(int G, int Dh, int page) {
    ldq = Dh + 4;
    ldk = Dh + 16 / (int)sizeof(T);
    q = 0;
    kv = q + (size_t)G * ldq * sizeof(float);  // [2 buffers][K, V][page][ldk]
    s = kv + (size_t)4 * page * ldk * sizeof(T);
    stats = s + (size_t)G * page * sizeof(float);  // m, l, alpha per head
    bytes = stats + (size_t)3 * G * sizeof(float);
  }
};

// q [B, H, Dh]; k_pool/v_pool [P, page, Hkv, Dh]; tables [B, N] int32;
// positions [B] int32; part_ml [B, H, S, 2] and part_acc [B, H, S, Dh]
// f32 scratch. window <= 0 means no window. blockDim.x == Dh.
template <typename T>
__global__ void paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          const int* __restrict__ tables,
                                          const int* __restrict__ positions,
                                          float* __restrict__ part_ml,
                                          float* __restrict__ part_acc, int H, int Hkv, int Dh,
                                          int P, int page, int N, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int tid = threadIdx.x;  // == output dimension d
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const Smem<T> plan(G, Dh, page);
  float* q_s = reinterpret_cast<float*>(smem + plan.q);  // [G][ldq]
  T* kv_s = reinterpret_cast<T*>(smem + plan.kv);        // [2][2][page][ldk]
  float* s_s = reinterpret_cast<float*>(smem + plan.s);  // [G][page]
  float* m_s = reinterpret_cast<float*>(smem + plan.stats);
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  const int ldk = plan.ldk;
  const int kv_tile = page * ldk;

  const int pos = positions[b];
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int first = max(lo / page, split * kPagesPerSplit);
  const int last = min(min(pos / page, N - 1), (split + 1) * kPagesPerSplit - 1);
  // Partial results of head kvh·G + g of row b, split `split`.
  const size_t part0 = ((size_t)b * H + (size_t)kvh * G) * S + split;
  if (first > last) {
    if (tid < G) {
      part_ml[2 * (part0 + (size_t)tid * S)] = -INFINITY;
      part_ml[2 * (part0 + (size_t)tid * S) + 1] = 0.f;
    }
    return;
  }

  const size_t tok_stride = (size_t)Hkv * Dh;
  const size_t page_stride = (size_t)page * tok_stride;
  const int* table = tables + (size_t)b * N;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int chunks = Dh / kVec;

  // K and V of logical page j into buffer `buf`, zeros where not read.
  auto load_page = [&](int j, int buf) {
    const int pid = table[j];
    const bool pid_ok = pid >= 0 && pid < P;
    T* kd = kv_s + (size_t)buf * 2 * kv_tile;
    T* vd = kd + kv_tile;
    for (int cix = tid; cix < page * chunks; cix += blockDim.x) {
      const int t = cix / chunks;
      const int d0 = (cix % chunks) * kVec;
      const int kpos = j * page + t;
      const bool valid = pid_ok && kpos >= lo && kpos <= pos;
      // An invalid chunk reads nothing; its address only has to be legal.
      const size_t off =
          valid ? (size_t)pid * page_stride + (size_t)t * tok_stride + (size_t)kvh * Dh + d0 : 0;
      cp_async16(kd + t * ldk + d0, k_pool + off, valid);
      cp_async16(vd + t * ldk + d0, v_pool + off, valid);
    }
    cp_async_commit();
  };

  load_page(first, 0);
  for (int g = 0; g < G; ++g)
    q_s[g * plan.ldq + tid] = to_f32(q[((size_t)b * H + kvh * G + g) * Dh + tid]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  const float sl2 = scale * kLog2e;
  // Lanes per score: as many as the block has to spare, up to one 16-byte
  // chunk each.
  const int n_pairs = G * page;
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * kVec <= Dh && 2 * tpp * n_pairs <= (int)blockDim.x) tpp *= 2;

  for (int j = first; j <= last; ++j) {
    const int buf = (j - first) & 1;
    if (j < last) {  // the next page loads while this one is reduced
      load_page(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_t = kv_s + (size_t)buf * 2 * kv_tile;
    const T* v_t = k_t + kv_tile;

    // Scores of (head g, token t), log2 units; -inf outside the band. A
    // pair's dot product is split over tpp neighbouring lanes, each
    // taking every tpp-th 16-byte chunk of the row.
    const int pid = table[j];
    const bool pid_ok = pid >= 0 && pid < P;
    for (int w0 = warp * 32; w0 < n_pairs * tpp; w0 += blockDim.x) {
      const int w = w0 + lane;
      const int pr = w / tpp;
      const int t = pr % page;
      const int kpos = j * page + t;
      const bool in_band = pr < n_pairs && pid_ok && kpos >= lo && kpos <= pos;
      float dot = 0.f;
      if (in_band) {
        const float* qr = q_s + (pr / page) * plan.ldq;
        const T* kr = k_t + t * ldk;
        for (int d0 = (w % tpp) * kVec; d0 < Dh; d0 += tpp * kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
          const T* ke = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot = fmaf(qr[d0 + e], to_f32(ke[e]), dot);
        }
      }
      for (int o = tpp / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (pr < n_pairs && w % tpp == 0) s_s[pr] = in_band ? dot * sl2 : -INFINITY;
    }
    __syncthreads();

    // Each head's page max and sum across one warp; p overwrites s.
    for (int g = warp; g < G; g += n_warps) {
      float* sg = s_s + g * page;
      float mx = -INFINITY;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      // A head with no key yet exponentiates against 0: p = alpha = 0.
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float pt = exp2f(sg[t] - base);
        sg[t] = pt;
        sum += pt;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - base);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Thread d: dimension d of every head, acc = acc·alpha + Σ_t p·v.
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float* pg = s_s + g * page;
        float a = acc[g] * alpha_s[g];
        for (int t = 0; t < page; ++t) a = fmaf(pg[t], to_f32(v_t[t * ldk + tid]), a);
        acc[g] = a;
      }
    }
    __syncthreads();  // buffers, s_s and alpha_s are free for the next page
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G) part_acc[(part0 + (size_t)g * S) * Dh + tid] = acc[g];
  if (tid < G) {
    part_ml[2 * (part0 + (size_t)tid * S)] = m_s[tid];
    part_ml[2 * (part0 + (size_t)tid * S) + 1] = l_s[tid];
  }
}

// One CTA per (b, h), thread d: the splits of that head merged in split
// order; splits without pages (m = -inf) are skipped, their acc unread.
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ out, int S, int Dh) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * S * 2;
  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ms = ml[2 * s];
    if (ms == -INFINITY) continue;
    const float w = exp2f(ms - m);
    l = fmaf(w, ml[2 * s + 1], l);
    a = fmaf(w, part_acc[(bh * S + s) * Dh + d], a);
  }
  out[bh * Dh + d] = from_f32<T>(a / l);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* positions, void* out, float* part, int B, int H, int Hkv, int Dh, int P,
           int page, int N, int window, float scale, cudaStream_t stream) {
  const int S = (N + kPagesPerSplit - 1) / kPagesPerSplit;
  float* part_ml = part;
  float* part_acc = part + (size_t)B * H * S * 2;
  const Smem<T> plan(H / Hkv, Dh, page);
  if (plan.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_split_kernel<T><<<dim3(B * Hkv, S), Dh, plan.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      part_ml, part_acc, H, Hkv, Dh, P, page, N, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge_kernel<T><<<B * H, Dh, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), S, Dh);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits per row for N table pages: the wrapper allocates
// B * H * splits * (2 + Dh) f32 of scratch.
extern "C" int paged_decode_splits(int N) { return (N + kPagesPerSplit - 1) / kPagesPerSplit; }

// Plain C entry point (loaded with ctypes). part is f32 scratch:
// part_ml [B, H, S, 2], then part_acc [B, H, S, Dh], with
// S = paged_decode_splits(N). Returns the first cudaGetLastError() of the
// two launches, or cudaErrorInvalidValue for shapes the kernel does not
// take; the Python wrapper raises on any non-zero value.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* positions, void* out, void* part,
                            int B, int H, int Hkv, int Dh, int P, int page, int N, int window,
                            float scale, int is_bf16, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxGroup || Dh % 32 != 0 || Dh < 32 ||
      Dh > 1024 || page < 1 || N < 1 || paged_decode_splits(N) > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(part);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, positions, out, f, B, H, Hkv, Dh, P,
                                 page, N, window, scale, s);
  return launch<float>(q, k_pool, v_pool, tables, positions, out, f, B, H, Hkv, Dh, P, page, N,
                       window, scale, s);
}
