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
// The TPU design is not carried over. There, every page of a row is
// copied into one VMEM scratch and a dense softmax runs over it, which is
// bounded by VMEM and has no Hopper counterpart. Here:
//   * one CTA per (row b, kv head); blockDim.x == Dh, thread d owns output
//     dimension d of each of the group's G query heads (registers);
//   * the CTA reads its own page-table entries and streams only logical
//     pages [start, pos / page], `start` being the first page of the
//     window band (0 without a window), one page of K and V at a time
//     through shared memory, with 16-byte loads;
//   * online softmax: f32 running max, sum and accumulator per head, so
//     every K/V byte is read once for all G heads of the group;
//   * positions past `pos` or outside the band are never read (their
//     shared-memory slots are zeroed and their scores are -inf), so stale
//     page contents, NaN included, contribute exactly 0 — the invariant
//     continuous batching rests on.
//
// Bound: HBM bytes. Per layer the kernel must read
//   sum_b 2 * (tokens read_b) * Hkv * Dh * sizeof(T)
// plus q, the tables and the output, and does ~4 flops per byte read —
// far below the card's ~295 bf16 flops/byte ridge.
//
// Known shortfalls, left for a later change: B * Hkv CTAs (64 at the
// serving slice's 8 rows x 8 kv heads) under-fill the 132 SMs; splitting
// a row's page range across CTAs with a second merge pass
// (flash-decoding), cp.async/TMA double-buffered page staging and tensor
// cores for the grouped q.k products would each raise achieved bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;  // query heads per kv head held in registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q [B, H, Dh]; k_pool/v_pool [P, page, Hkv, Dh]; tables [B, N] int32;
// positions [B] int32; out [B, H, Dh]. window <= 0 means no window.
template <typename T>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ positions, T* __restrict__ out, int H, int Hkv,
    int Dh, int P, int page, int N, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int tid = threadIdx.x;  // == output dimension d
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  float* q_s = smem;              // [G][Dh]
  float* k_s = q_s + G * Dh;      // [page][Dh]
  float* v_s = k_s + page * Dh;   // [page][Dh]
  float* s_s = v_s + page * Dh;   // [G][page]

  const int pos = positions[b];
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int first = lo / page;
  const int last = min(pos / page, N - 1);

  for (int g = 0; g < G; ++g)
    q_s[g * Dh + tid] = to_f32(q[((size_t)b * H + kvh * G + g) * Dh + tid]);

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const size_t tok_stride = (size_t)Hkv * Dh;
  const size_t page_stride = (size_t)page * tok_stride;
  const int* table = tables + (size_t)b * N;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int chunks_per_row = Dh / kVec;

  for (int j = first; j <= last; ++j) {
    const int pid = table[j];
    const bool pid_ok = pid >= 0 && pid < P;
    __syncthreads();  // q_s written; k_s/v_s/s_s free for this page
    for (int c = tid; c < page * chunks_per_row; c += blockDim.x) {
      const int t = c / chunks_per_row;
      const int d0 = (c % chunks_per_row) * kVec;
      const int kpos = j * page + t;
      float* kd = k_s + t * Dh + d0;
      float* vd = v_s + t * Dh + d0;
      if (pid_ok && kpos >= lo && kpos <= pos) {
        const size_t off = (size_t)pid * page_stride + (size_t)t * tok_stride +
                           (size_t)kvh * Dh + d0;
        const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + off);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kd[e] = to_f32(ke[e]);
          vd[e] = to_f32(ve[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
      }
    }
    __syncthreads();
    // Scores: one (head, token) pair per warp at a time, lanes split Dh.
    for (int pr = warp; pr < G * page; pr += n_warps) {
      const int g = pr / page;
      const int t = pr % page;
      const int kpos = j * page + t;
      float part = 0.f;
      for (int d = lane; d < Dh; d += 32) part += q_s[g * Dh + d] * k_s[t * Dh + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0)
        s_s[g * page + t] =
            (pid_ok && kpos >= lo && kpos <= pos) ? part * scale : -INFINITY;
    }
    __syncthreads();
    // Online softmax update; thread tid owns dimension tid of each head.
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float* sg = s_s + g * page;
        float mx = m[g];
        for (int t = 0; t < page; ++t) mx = fmaxf(mx, sg[t]);
        if (mx != -INFINITY) {
          const float alpha = expf(m[g] - mx);
          float sum = 0.f, a = 0.f;
          for (int t = 0; t < page; ++t) {
            const float st = sg[t];
            if (st != -INFINITY) {
              const float p = expf(st - mx);
              sum += p;
              a += p * v_s[t * Dh + tid];
            }
          }
          l[g] = l[g] * alpha + sum;
          acc[g] = acc[g] * alpha + a;
          m[g] = mx;
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G)
      out[((size_t)b * H + kvh * G + g) * Dh + tid] = from_f32<T>(acc[g] / l[g]);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* positions, void* out, int B, int H,
           int Hkv, int Dh, int P, int page, int N, int window, float scale,
           cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = (size_t)(G * Dh + 2 * page * Dh + G * page) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<B * Hkv, Dh, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), H, Hkv, Dh, P,
      page, N, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes the kernel does
// not take; the Python wrapper raises on any non-zero value.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* positions, void* out, int B, int H,
                            int Hkv, int Dh, int P, int page, int N,
                            int window, float scale, int is_bf16,
                            void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxGroup || Dh % 32 != 0 ||
      Dh < 32 || Dh > 1024 || page < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, positions, out, B,
                                 H, Hkv, Dh, P, page, N, window, scale, s);
  return launch<float>(q, k_pool, v_pool, tables, positions, out, B, H, Hkv,
                       Dh, P, page, N, window, scale, s);
}
