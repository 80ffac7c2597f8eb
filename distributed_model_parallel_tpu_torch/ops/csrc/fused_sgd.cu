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
// Design. No copy of the TPU's (rows, 128) padding and 512-row blocks:
// the bucket is a flat buffer that the optimizer's parameters and
// gradients are views of (ops/fused_sgd.py), so one launch covers it
// with no pointer table and no per-step concatenation. A grid-stride loop
// over float4 (16-byte loads and stores when all three buffers are
// 16-byte aligned, as the caching allocator's buffers are), then a scalar
// tail; the grid is capped at 8 blocks of 256 threads per SM. lr is a
// kernel argument taken from the host schedule. Variants (momentum,
// weight decay, nesterov) are template parameters.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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
__global__ void __launch_bounds__(kThreads)
    fused_sgd_kernel(float* __restrict__ p, float* __restrict__ m,
                     const float* __restrict__ g, long long n, long long n4,
                     float neg_lr, float mu, float wd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = tid; i < n4; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 mv = kMomentum ? m4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    update<kMomentum, kWd, kNesterov>(pv.x, mv.x, gv.x, neg_lr, mu, wd);
    update<kMomentum, kWd, kNesterov>(pv.y, mv.y, gv.y, neg_lr, mu, wd);
    update<kMomentum, kWd, kNesterov>(pv.z, mv.z, gv.z, neg_lr, mu, wd);
    update<kMomentum, kWd, kNesterov>(pv.w, mv.w, gv.w, neg_lr, mu, wd);
    p4[i] = pv;
    if (kMomentum) m4[i] = mv;
  }
  // Scalar tail: the last n % 4 elements, or everything when the buffers
  // are not 16-byte aligned (n4 == 0).
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    float pv = p[i];
    float mv = kMomentum ? m[i] : 0.f;
    update<kMomentum, kWd, kNesterov>(pv, mv, g[i], neg_lr, mu, wd);
    p[i] = pv;
    if (kMomentum) m[i] = mv;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

template <bool kMomentum, bool kWd, bool kNesterov>
int launch(float* p, float* m, const float* g, long long n, float lr,
           float mu, float wd, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<unsigned long long>(p) |
                         reinterpret_cast<unsigned long long>(m) |
                         reinterpret_cast<unsigned long long>(g)) &
                        15ull) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long work = aligned ? n4 + (n - 4 * n4) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  fused_sgd_kernel<kMomentum, kWd, kNesterov>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(p, m, g, n, n4, -lr, mu,
                                                  wd);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `m` == nullptr selects the
// momentum-free variant (the TPU's `_plain_sgd_kernel`); `nesterov` is
// read only with a momentum buffer. p and m are updated in place. Returns
// cudaGetLastError() after the launch; the Python wrapper raises on any
// non-zero value.
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
