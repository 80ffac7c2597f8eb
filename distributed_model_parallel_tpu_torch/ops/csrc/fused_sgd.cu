// Fused SGD update for Hopper (sm_90a): weight decay, momentum trace,
// nesterov, learning rate and the apply, in one pass over a flat f32
// parameter bucket.
//
// Replaces the Pallas TPU kernels of
// distributed_model_parallel_tpu/ops/pallas_optim.py: `_fused_sgd_kernel`
// (momentum variant) and `_plain_sgd_kernel` (momentum 0, no trace
// buffer), both launched by `_run_kernel` there, followed by
// `optax.apply_updates`. Per element, in this order:
//   g' = g + wd * p                 (only when wd != 0)
//   m' = mu * m + g'                (momentum variant; m updated in place)
//   d  = g' + mu * m'  (nesterov)  |  m'  (classic)  |  g'  (no momentum)
//   p' = p + (-lr) * d              (the apply, folded in)
// The TPU version writes delta to HBM and XLA adds it to the params in a
// second pass; folding the apply in saves that pass and changes no
// arithmetic. Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract a*b + c into one
// FMA), so the result is bit for bit the plain PyTorch version's
// (ops/fused_sgd.py: `fused_sgd_plain`, eager ops, one rounding each).
//
// Bound: HBM bytes. Elementwise with no reuse: the momentum variant
// reads p, m, g and writes p, m (20 B per parameter), the plain variant
// reads p, g and writes p (12 B), at ~4 flops per element.
//
// Design (chosen by a sweep on an H100, PERF.md §6). The bucket is
// a flat buffer that the optimizer's parameters and gradients are views
// of (ops/fused_sgd.py), so one launch covers it with no pointer table.
// It splits into a head (up to 3 elements before p's first 16-byte
// boundary), a body of float4 and a tail (n % 4 after the head); head and
// tail go through a scalar loop in the same launch, and buffers whose
// offsets differ mod 16 go through it whole. The body is cut into chunks
// of kUnroll x 256 float4 (4 KB x kUnroll per operand), dealt round-robin
// over a grid of a few CTAs per SM: at any moment the CTAs stream one
// compact window of the bucket, and each chunk starts on a 4 KB boundary
// of the body. Each thread issues its kUnroll float4 loads of every operand
// before any arithmetic, L1::no_allocate (nothing is reused).
//   * Giving each CTA one contiguous slice instead lost 7-10% (the
//     concurrent accesses spread over the whole bucket); chunk starts off
//     4 KB boundaries (balanced lengths rounded to 128 or 512 bytes) lost
//     up to 20%; L2 evict-first hints on g and m lost 1.5-4%; a ring of
//     1-D bulk copies (cp.async.bulk) through shared memory tied the
//     register path at best. All measured, none kept.
//   * Depth: a shallow geometry (1 float4 per operand in flight, 8 CTAs of
//     256 threads per SM, all resident: 4 KB chunks spread the last round
//     over every SM) wins on small buckets, where a launch is mostly ramp
//     and tail; a deep one (4 float4 per operand with a trace, 8 without;
//     2 CTAs resident per SM by the launch bounds and 4 launched, so a
//     second wave fills the SMs that finish first; an exact persistent
//     grid of 2 ran ~2% slower) wins once the bucket gives kDeepRounds
//     rounds of chunks, where the bytes in flight set the rate.
// lr is a kernel argument taken from the host schedule. Variants
// (momentum, weight decay, nesterov) and the depth are template
// parameters.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDeepRounds = 3;

struct Geometry {
  int unroll;       // float4 of each operand a thread keeps in flight
  int resident;     // CTAs per SM the launch bounds guarantee
  int ctas_per_sm;  // CTAs per SM launched
};

constexpr Geometry kShallow{1, 8, 8};
constexpr Geometry kDeepMomentum{4, 2, 4};
constexpr Geometry kDeepPlain{8, 2, 4};
static_assert(kDeepMomentum.resident == kDeepPlain.resident,
              "the launch bounds tell the depths apart by unroll only");

constexpr int resident_ctas(int unroll) {
  return unroll == kShallow.unroll ? kShallow.resident : kDeepMomentum.resident;
}

template <bool kMomentum, bool kWd, bool kNesterov>
__device__ __forceinline__ void update(float& p, float& m, float g,
                                       float neg_lr, float mu, float wd) {
  if (kWd) g = __fadd_rn(g, __fmul_rn(wd, p));
  float d = g;
  if (kMomentum) {
    m = __fadd_rn(__fmul_rn(mu, m), g);
    d = kNesterov ? __fadd_rn(g, __fmul_rn(mu, m)) : m;
  }
  p = __fadd_rn(p, __fmul_rn(neg_lr, d));
}

template <bool kMomentum, bool kWd, bool kNesterov>
__device__ __forceinline__ void update4(float4& p, float4& m, const float4& g,
                                        float neg_lr, float mu, float wd) {
  update<kMomentum, kWd, kNesterov>(p.x, m.x, g.x, neg_lr, mu, wd);
  update<kMomentum, kWd, kNesterov>(p.y, m.y, g.y, neg_lr, mu, wd);
  update<kMomentum, kWd, kNesterov>(p.z, m.z, g.z, neg_lr, mu, wd);
  update<kMomentum, kWd, kNesterov>(p.w, m.w, g.w, neg_lr, mu, wd);
}

__device__ __forceinline__ float4 ld_stream(const float4* a) {
  float4 v;
  asm volatile("ld.global.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(a));
  return v;
}

__device__ __forceinline__ void st_stream(float4* a, const float4& v) {
  asm volatile("st.global.L1::no_allocate.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// One chunk's share of this thread: float4 i + 256 j, j < kUnroll, those
// below `end`. All loads are issued before the first update.
template <bool kMomentum, bool kWd, bool kNesterov, int kUnroll>
__device__ __forceinline__ void chunk_step(float4* p4, float4* m4, const float4* g4,
                                           long long i, long long end, float neg_lr,
                                           float mu, float wd) {
  float4 pv[kUnroll], mv[kUnroll], gv[kUnroll];
  const bool full = i + (long long)(kUnroll - 1) * kThreads < end;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long k = i + (long long)j * kThreads;
    if (full || k < end) {
      pv[j] = ld_stream(p4 + k);
      gv[j] = ld_stream(g4 + k);
      if (kMomentum) mv[j] = ld_stream(m4 + k);
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long k = i + (long long)j * kThreads;
    if (full || k < end) {
      update4<kMomentum, kWd, kNesterov>(pv[j], mv[j], gv[j], neg_lr, mu, wd);
      st_stream(p4 + k, pv[j]);
      if (kMomentum) st_stream(m4 + k, mv[j]);
    }
  }
}

template <bool kMomentum, bool kWd, bool kNesterov, int kUnroll>
__global__ void __launch_bounds__(kThreads, resident_ctas(kUnroll))
    fused_sgd_kernel(float* __restrict__ p, float* __restrict__ m,
                     const float* __restrict__ g, long long n, long long head,
                     long long body4, float neg_lr, float mu, float wd) {
  // Body: chunk c covers float4 [c * kChunk, (c + 1) * kChunk) after the
  // head; CTA b takes chunks b, b + gridDim.x, ...
  constexpr long long kChunk = (long long)kUnroll * kThreads;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  float4* m4 = reinterpret_cast<float4*>(m + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  for (long long c0 = (long long)blockIdx.x * kChunk; c0 < body4;
       c0 += (long long)gridDim.x * kChunk)
    chunk_step<kMomentum, kWd, kNesterov, kUnroll>(p4, m4, g4, c0 + threadIdx.x, body4,
                                                   neg_lr, mu, wd);
  // Scalar part: the head [0, head) and the tail [head + 4 body4, n).
  const long long tail0 = head + 4 * body4;
  const long long count = head + (n - tail0);
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < count;
       j += (long long)gridDim.x * kThreads) {
    const long long i = j < head ? j : tail0 + (j - head);
    float pv = p[i];
    float mv = kMomentum ? m[i] : 0.f;
    update<kMomentum, kWd, kNesterov>(pv, mv, g[i], neg_lr, mu, wd);
    p[i] = pv;
    if (kMomentum) m[i] = mv;
  }
}

// The current device's SM count, read from the device (cached per
// device). Returns 0 or the CUDA error of the query.
int sm_count(int* out) {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && counts[dev] > 0) {
    *out = counts[dev];
    return 0;
  }
  int count = 0;
  e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (count <= 0) return (int)cudaErrorInvalidDevice;
  if (dev < kMaxDevices) counts[dev] = count;
  *out = count;
  return 0;
}

struct Plan {
  long long head, body4;
  int blocks, unroll;
};

// Head, body and grid for a bucket of n elements at p, m (nullptr without
// a trace) and g. Returns 0 or a CUDA error.
int plan(const float* p, const float* m, const float* g, long long n, Plan* out) {
  const unsigned long long mis = reinterpret_cast<unsigned long long>(p) & 15ull;
  const bool common =
      (reinterpret_cast<unsigned long long>(g) & 15ull) == mis &&
      (m == nullptr || (reinterpret_cast<unsigned long long>(m) & 15ull) == mis) &&
      (mis & 3ull) == 0;
  long long head = common ? (long long)(((16 - mis) & 15ull) / 4) : n;
  if (head > n) head = n;
  const long long body4 = (n - head) / 4;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e) return e;
  const Geometry deep = m != nullptr ? kDeepMomentum : kDeepPlain;
  const long long deep_round = (long long)deep.ctas_per_sm * sms * deep.unroll * kThreads;
  const Geometry geo = body4 >= kDeepRounds * deep_round ? deep : kShallow;
  const long long chunk = (long long)geo.unroll * kThreads;
  long long need = body4 > 0 ? (body4 + chunk - 1) / chunk : (n + kThreads - 1) / kThreads;
  long long blocks = (long long)geo.ctas_per_sm * sms;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  *out = Plan{head, body4, (int)blocks, geo.unroll};
  return 0;
}

template <bool kMomentum, bool kWd, bool kNesterov>
int launch(float* p, float* m, const float* g, long long n, float lr, float mu, float wd,
           cudaStream_t stream) {
  Plan pl;
  const int e = plan(p, m, g, n, &pl);
  if (e) return e;
  if (pl.unroll == kShallow.unroll)
    fused_sgd_kernel<kMomentum, kWd, kNesterov, kShallow.unroll>
        <<<pl.blocks, kThreads, 0, stream>>>(p, m, g, n, pl.head, pl.body4, -lr, mu, wd);
  else
    fused_sgd_kernel<kMomentum, kWd, kNesterov,
                     kMomentum ? kDeepMomentum.unroll : kDeepPlain.unroll>
        <<<pl.blocks, kThreads, 0, stream>>>(p, m, g, n, pl.head, pl.body4, -lr, mu, wd);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `m` == nullptr selects the
// momentum-free variant (the TPU's `_plain_sgd_kernel`); `nesterov` is
// read only with a momentum buffer. p and m are updated in place. Returns
// 0, or the CUDA error of the device query or of the launch
// (cudaGetLastError()); the Python wrapper raises on any non-zero value.
extern "C" int fused_sgd(float* p, float* m, const float* g, long long n,
                         float lr, float momentum, float weight_decay,
                         int nesterov, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wd = weight_decay != 0.f;
  if (m == nullptr)
    return wd ? launch<false, true, false>(p, m, g, n, lr, 0.f, weight_decay, s)
              : launch<false, false, false>(p, m, g, n, lr, 0.f, 0.f, s);
  if (nesterov)
    return wd ? launch<true, true, true>(p, m, g, n, lr, momentum,
                                         weight_decay, s)
              : launch<true, false, true>(p, m, g, n, lr, momentum, 0.f, s);
  return wd ? launch<true, true, false>(p, m, g, n, lr, momentum,
                                        weight_decay, s)
            : launch<true, false, false>(p, m, g, n, lr, momentum, 0.f, s);
}

// The grid `fused_sgd` launches on the current device for a 16-byte
// aligned bucket of n elements (with a trace when `momentum` != 0): CTAs,
// threads per CTA and float4 per operand a thread keeps in flight.
// Returns 0 or the CUDA error of the device query.
extern "C" int fused_sgd_grid(long long n, int momentum, int* blocks, int* threads,
                              int* unroll) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const float* a = reinterpret_cast<const float*>(256);
  Plan pl;
  const int e = plan(a, momentum ? a : nullptr, a, n, &pl);
  if (e) return e;
  *blocks = pl.blocks;
  *threads = kThreads;
  *unroll = pl.unroll;
  return 0;
}
