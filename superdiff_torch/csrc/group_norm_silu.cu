// Fused GroupNorm (+ per-sample FiLM) + SiLU for Hopper (sm_90a):
//
//   y = SiLU(FiLM(GroupNorm(x)))      on NHWC x, statistics in float32
//
// Replaces the TPU kernel superdiff_tpu/ops/fused_norm.py::_gn_silu_kernel
// (launched by _pallas_gn_silu). Same function, not the same blocks: the
// TPU kernel keeps one sample's whole (H, W, chunk) slab in VMEM and reduces
// it in one grid cell. Here one block per (sample, group) would give 64
// blocks for the RefUNet at batch 16 (half of the 132 SMs), each reducing
// 2 M elements, so the work is cut along the flat H*W*C axis instead, in
// three short launches on the caller's stream:
//
//   1. gn_stats: grid (tiles, B). A tile is a contiguous run of whole rows
//      (H*W positions x C channels). Each thread owns a fixed set of
//      channels (the block's stride S = threads * VEC is a multiple of C),
//      sums x and x^2 for them in float32 registers over the tile, and the
//      block folds the threads together with a fixed shared-memory tree
//      (S / C is a power of two). Out: per-(sample, tile, channel) partial
//      sums in a float32 scratch that the wrapper allocates.
//   2. gn_finalize: grid (B). Sums the partials over tiles, then over each
//      group's channels, in a fixed order; mean, var = max(E[x^2] - E[x]^2,
//      0), rsqrt(var + eps); folds gamma, beta and FiLM (y*(1+scale)+shift)
//      into one float32 multiplier and offset per (sample, channel).
//   3. gn_apply: the same grid as gn_stats. y = x*mul + off, y / (1 +
//      exp(-y)), one cast on the store.
//
// Deterministic: fixed reduction orders and no float atomics, so a rerun
// gives the same bits (the port's bit-exact resume rests on it).
//
// Numerics follow the plain reference (_xla_gn_silu), not two quirks of
// the TPU kernel: the variance is clamped at 0, and the FMA and the SiLU
// run in float32 whatever the storage dtype (the TPU kernel does both in
// the storage dtype).
//
// What bounds it on this card: bytes. The function reads x once and writes
// y once (the RefUNet's largest call, 16 x 256 x 256 x 128 float32, moves
// 2 x 537 MB); the arithmetic is a few flops per element. This design
// reads x twice (a batch is far larger than the 50 MB L2), so it can reach
// at best 2/3 of the bound. Loads and stores are 16 bytes along the flat
// axis (VEC = 4 float32 or 8 bfloat16) when H*W*C allows, else scalar.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ psum,
                         float* __restrict__ psq, long long n, int C,
                         int iters) {
  extern __shared__ float smem[];
  const int S = blockDim.x * VEC;          // elements per block iteration
  float* ssum = smem;
  float* ssq = smem + S;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const T* xb = x + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;

  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const long long e = base + (long long)it * S;
    if (e < n) {                           // n % VEC == 0: whole vectors
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + e);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = to_f(p.v[j]);
        s[j] += v;
        q[j] = fmaf(v, v, q[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    ssum[threadIdx.x * VEC + j] = s[j];
    ssq[threadIdx.x * VEC + j] = q[j];
  }
  __syncthreads();
  // slot k holds channel k % C; k and k + half share it while half % C == 0
  for (int half = S >> 1; half >= C; half >>= 1) {
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      ssum[k] += ssum[k + half];
      ssq[k] += ssq[k + half];
    }
    __syncthreads();
  }
  float* osum = psum + ((long long)b * tiles + tile) * C;
  float* osq = psq + ((long long)b * tiles + tile) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    osum[c] = ssum[c];
    osq[c] = ssq[c];
  }
}

__global__ void gn_finalize(const float* __restrict__ psum,
                            const float* __restrict__ psq,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            float* __restrict__ mul, float* __restrict__ off,
                            int C, int G, int tiles, float inv_count,
                            float eps) {
  extern __shared__ float smem[];
  float* csum = smem;
  float* csq = smem + C;
  const int b = blockIdx.x, gw = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int t = 0; t < tiles; ++t) {
      s += psum[((long long)b * tiles + t) * C + c];
      q += psq[((long long)b * tiles + t) * C + c];
    }
    csum[c] = s;
    csq[c] = q;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int c0 = (c / gw) * gw;
    float s = 0.f, q = 0.f;
    for (int k = 0; k < gw; ++k) {
      s += csum[c0 + k];
      q += csq[c0 + k];
    }
    const float mean = s * inv_count;
    const float var = fmaxf(q * inv_count - mean * mean, 0.f);
    float m = rsqrtf(var + eps) * gamma[c];
    float o = beta[c] - mean * m;
    if (scale != nullptr) {
      const float fs = 1.f + scale[(long long)b * C + c];
      m *= fs;
      o = o * fs + shift[(long long)b * C + c];
    }
    mul[(long long)b * C + c] = m;
    off[(long long)b * C + c] = o;
  }
}

template <typename T, int VEC>
__global__ void gn_apply(const T* __restrict__ x, T* __restrict__ y,
                         const float* __restrict__ mul,
                         const float* __restrict__ off, long long n, int C,
                         int iters) {
  const int S = blockDim.x * VEC;
  const int b = blockIdx.y, tile = blockIdx.x;
  const T* xb = x + (long long)b * n;
  T* yb = y + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;
  float m[VEC], o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = (threadIdx.x * VEC + j) % C;
    m[j] = mul[(long long)b * C + c];
    o[j] = off[(long long)b * C + c];
  }
  for (int it = 0; it < iters; ++it) {
    const long long e = base + (long long)it * S;
    if (e < n) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + e);
      Pack<T, VEC> r;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float v = fmaf(to_f(p.v[j]), m[j], o[j]);
        r.v[j] = from_f<T>(v / (1.f + __expf(-v)));
      }
      *reinterpret_cast<Pack<T, VEC>*>(yb + e) = r;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, const float* gamma,
                   const float* beta, const float* scale, const float* shift,
                   float* work, int B, long long hw, int C, int G,
                   int threads, int iters, int tiles, float eps,
                   cudaStream_t st) {
  const long long n = hw * C;
  const int S = threads * VEC;
  if (n % VEC || S % C || (S / C) & (S / C - 1) || threads > 1024 ||
      (long long)tiles * iters * S < n || S > 4096 || C > 4096)
    return cudaErrorInvalidValue;
  float* psum = work;
  float* psq = psum + (long long)B * tiles * C;
  float* mul = psq + (long long)B * tiles * C;
  float* off = mul + (long long)B * C;
  const dim3 grid(tiles, B);
  gn_stats<T, VEC><<<grid, threads, 2 * S * sizeof(float), st>>>(
      static_cast<const T*>(x), psum, psq, n, C, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int fthreads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  gn_finalize<<<B, fthreads, 2 * C * sizeof(float), st>>>(
      psum, psq, gamma, beta, scale, shift, mul, off, C, G, tiles,
      1.f / (float)(hw * (C / G)), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, VEC><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mul, off, n, C, iters);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, H*W, C) contiguous, dtype 0 = bfloat16, 1 = float32. gamma,
// beta: (C,) float32; scale, shift: (B, C) float32, or both null (no FiLM).
// work: float32 scratch of 2*B*tiles*C + 2*B*C. vec, threads, iters and
// tiles are the launch geometry chosen by the Python wrapper
// (ops/fused_norm.py::_geometry). Returns a CUDA error code.
extern "C" int superdiff_gn_silu(const void* x, void* y, const float* gamma,
                                 const float* beta, const float* scale,
                                 const float* shift, float* work, int B,
                                 long long hw, int C, int G, int dtype,
                                 int vec, int threads, int iters, int tiles,
                                 float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 0 || C % G || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
#define SUPERDIFF_CASE(T, V)                                                \
  if (vec == V) return (int)launch<T, V>(x, y, gamma, beta, scale, shift, \
                                         work, B, hw, C, G, threads,      \
                                         iters, tiles, eps, st);
  if (dtype == 0) {
    SUPERDIFF_CASE(__nv_bfloat16, 8)
    SUPERDIFF_CASE(__nv_bfloat16, 1)
  } else if (dtype == 1) {
    SUPERDIFF_CASE(float, 4)
    SUPERDIFF_CASE(float, 1)
  }
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}
