// Fused GroupNorm (+ per-sample FiLM) + SiLU for Hopper (sm_90a):
//
//   y = SiLU(FiLM(GroupNorm(x)))      on NHWC x, statistics in float32
//
// Replaces the TPU kernel superdiff_tpu/ops/fused_norm.py::_gn_silu_kernel
// (launched by _pallas_gn_silu). Same function, not the same blocks: the
// TPU kernel keeps one sample's whole (H, W, chunk) slab in VMEM and reduces
// it in one grid cell; a block here has at most 227 KB of shared memory.
//
// What bounds it on this card: bytes. The function reads x once and writes
// y once; the arithmetic is a few flops per element. Two regimes, picked
// per shape by the Python geometry (ops/fused_norm.py::launch_geometry):
//
//   gn_cluster, one launch, for batches of up to 32 MB (at batch 16 every
//     CondUNet chain up to 64^2 x 256; at batch 4 all of them): one
//     thread-block cluster of K = 4-16 blocks per sample (16 is
//     non-portable; launched with cudaLaunchKernelEx). Each block owns a
//     contiguous share of the sample's flat H*W*C run, whole block steps of
//     S = C * 2^p elements, so every thread owns fixed channels. The first
//     `resident` steps of its share go to shared memory as bulk copies
//     (cp.async.bulk on an mbarrier: the copy engine keeps them all in
//     flight); the rest are read from global memory meanwhile, and read
//     again for the output, mostly from the 50 MB L2 (the geometry keeps
//     a block's shared memory to a quarter of the SM's, so that the
//     batch's clusters are all on the card at once). Each block sums x and
//     x^2 per channel in float32 and folds its threads in a fixed order;
//     after a cluster barrier every block reads all K blocks' per-channel
//     partials through distributed shared memory in rank order, so all K
//     form the same group statistics; then each applies the chain to its
//     share with 16-byte stores.
//   three passes (gn_stats, gn_finalize, gn_apply) for larger batches (the
//     CondUNet's 128^2 chains at batch 16, the RefUNet's 16 x 256^2 x
//     64/128 float32), where it measured faster than the cluster regime,
//     whose second read of x there misses L2: it reads x twice from HBM.
//
// Deterministic in both: fixed reduction orders and no float atomics, so a
// rerun gives the same bits (the port's bit-exact resume and the
// graph-equals-eager checks rest on it). Statistics: E[x^2] - E[x]^2
// clamped at 0.
//
// Two numerics modes, chosen by the caller:
//   policy = 1, the CondUNet's chain as PyTorch's eager ops compute it
//     (ops/fused_norm.py::gn_film_silu_policy_plain): (x - mean) * (rsqrt(var
//     + eps) * gamma) + beta as separate float32 operations (no FMA
//     contraction), rounded to the norm dtype TN; FiLM in TN as h * (1 +
//     scale) + shift with a rounding after 1 + scale, the product and the
//     shift; SiLU computed in float32 as v / (1 + expf(-v)) and rounded to
//     TN (for a bfloat16 TN looked up in a table of all 65536 values, made
//     by the same code). Only the statistics' summation order differs from
//     the plain chain.
//   policy = 0, the RefUNet's contract (gn_silu_plain): GroupNorm affine and
//     FiLM folded into one float32 multiplier and offset per (sample,
//     channel), one FMA, SiLU with __expf in float32, one cast on the store.
//     Numerics follow the plain reference (_xla_gn_silu), not two quirks of
//     the TPU kernel: the variance is clamped at 0, and the FMA and the SiLU
//     run in float32 whatever the storage dtype.
//
// Loads and stores are 16 bytes along the flat axis (VEC = 4 float32 or 8
// bfloat16) when H*W*C and the addresses allow, else scalar.
//
// Training (policy mode, TN = float32, a gradient wanted) launches the
// forward with its statistics written out (the ParamsStats instantiations:
// per (sample, group) the mean and rsqrt(var + eps) it used), then the
// backward below (gn_bwd_*), which recomputes the chain from x and them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;          // dynamic shared memory per block
constexpr int kStreamU = 4;   // vectors a thread loads before it uses them
constexpr int kClusterThreads = 256;      // at most, per cluster block

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
  return __float2bfloat16_rn(v);
}
// v rounded to TN (round to nearest even) and back to float
template <typename TN> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<TN>(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Params {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  const float* scale;          // null: no FiLM
  const float* shift;
  long long film_ld;           // elements between samples of scale / shift
  long long hw;
  int C, G, policy;
  float inv_count, eps;
};

// Params of a training forward: also writes each (sample, group)'s mean and
// rsqrt(var + eps) to stats[2 * (b * G + g) + {0, 1}]. The sampling path
// launches the Params instantiations, whose code does not write them.
struct ParamsStats : Params {
  float* stats;
};

template <typename P>
constexpr bool kStats = std::is_same_v<P, ParamsStats>;

// A group's mean and rsqrt(var + eps) from its float32 sums, as make_chan
// forms them in policy mode.
__device__ __forceinline__ void write_stats(const ParamsStats& p, int b,
                                            int g, float s, float q) {
  const float mean = s * p.inv_count;
  const float var = fmaxf(
      __fsub_rn(__fmul_rn(q, p.inv_count), __fmul_rn(mean, mean)), 0.f);
  p.stats[2 * ((long long)b * p.G + g)] = mean;
  p.stats[2 * ((long long)b * p.G + g) + 1] = rsqrtf(__fadd_rn(var, p.eps));
}
template <typename P>
__device__ __forceinline__ void maybe_write_stats(const P& p, int b, int g,
                                                  float s, float q) {
  if constexpr (kStats<P>) write_stats(p, b, g, s, q);
}

// The chain's inputs for one (sample, channel), read before the
// statistics are known: gamma, beta and the FiLM operands (policy mode: 1 +
// scale and shift already rounded to TN; folded mode: as given).
struct ChanIn {
  float gamma, beta, scale, shift;
};

// The chain's constants for one (sample, channel).
struct Chan {
  float mean, mul, add, fs, sh;
};

template <typename TN>
__device__ __forceinline__ ChanIn load_chan_in(const Params& p, int b,
                                               int c) {
  ChanIn in{p.gamma[c], p.beta[c], 1.f, 0.f};
  if (p.scale != nullptr) {
    const long long f = (long long)b * p.film_ld + c;
    in.scale = p.scale[f];
    in.shift = p.shift[f];
    if (p.policy) {
      in.scale = rnd<TN>(__fadd_rn(1.f, rnd<TN>(in.scale)));
      in.shift = rnd<TN>(in.shift);
    }
  }
  return in;
}

// Constants of one channel from its group's float32 sums s and q.
__device__ __forceinline__ Chan make_chan(const Params& p, float s, float q,
                                          const ChanIn& in) {
  Chan ch;
  const float mean = s * p.inv_count;
  if (p.policy) {
    const float var = fmaxf(
        __fsub_rn(__fmul_rn(q, p.inv_count), __fmul_rn(mean, mean)), 0.f);
    ch.mean = mean;
    ch.mul = __fmul_rn(rsqrtf(__fadd_rn(var, p.eps)), in.gamma);
    ch.add = in.beta;
    ch.fs = in.scale;
    ch.sh = in.shift;
  } else {
    const float var = fmaxf(q * p.inv_count - mean * mean, 0.f);
    float m = rsqrtf(var + p.eps) * in.gamma;
    float o = in.beta - mean * m;
    if (p.scale != nullptr) {
      const float fs = 1.f + in.scale;
      m *= fs;
      o = o * fs + in.shift;
    }
    ch.mean = 0.f;
    ch.mul = m;
    ch.add = o;
    ch.fs = 1.f;
    ch.sh = 0.f;
  }
  return ch;
}

// The policy's SiLU of one value in float32, as torch's silu computes it
// for a bf16 or float32 tensor: v / (1 + expf(-v)), IEEE division.
__device__ __forceinline__ float silu_f32(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// The policy's SiLU of every bfloat16 value, rounded to bfloat16 (indexed
// by the bit pattern): filled once per device by gn_fill_silu_table with
// silu_f32, so a lookup gives the same bits as computing it. It replaces
// the exponential and the division, whose dependent latency bounded the
// kernel, by one load from a table whose used part stays in L1.
__device__ __nv_bfloat16 gn_silu_bf16[65536];

__global__ void gn_fill_silu_table() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536)
    gn_silu_bf16[i] = __float2bfloat16_rn(
        silu_f32(__bfloat162float(__ushort_as_bfloat16((unsigned short)i))));
}

// One element of the chain, x in float32 -> y in TN.
template <typename TN, bool POLICY, bool FILM>
__device__ __forceinline__ TN chain(float x, const Chan& ch) {
  if constexpr (POLICY) {
    float h = __fadd_rn(__fmul_rn(__fsub_rn(x, ch.mean), ch.mul), ch.add);
    if constexpr (FILM) {
      h = rnd<TN>(__fmul_rn(rnd<TN>(h), ch.fs));
      h = __fadd_rn(h, ch.sh);
    }
    if constexpr (sizeof(TN) == 2) {
      const unsigned short i = __bfloat16_as_ushort(from_f<TN>(h));
      return __ldg(&gn_silu_bf16[i]);
    } else {
      return silu_f32(h);
    }
  } else {
    const float v = fmaf(x, ch.mul, ch.add);
    return from_f<TN>(v / (1.f + __expf(-v)));
  }
}

template <typename T, typename TN, int VEC, bool POLICY, bool FILM>
__device__ __forceinline__ void apply_pack(const Pack<T, VEC>& in, TN* out,
                                           const Chan* ch) {
  Pack<TN, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    r.v[j] = chain<TN, POLICY, FILM>(to_f(in.v[j]), ch[j]);
  *reinterpret_cast<Pack<TN, VEC>*>(out) = r;
}

// Steps it0, it0 + 1, ... below it1 of this thread's slots, read from xg
// (global memory) U at a time, loads first: fn(pack, element index).
template <typename T, int VEC, int U, typename Fn>
__device__ __forceinline__ void stream_steps(const T* xg, long long base,
                                             long long n, int S, int it0,
                                             int it1, Fn&& fn) {
  for (int it = it0; it < it1; it += U) {
    Pack<T, VEC> v[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (long long)(it + u) * S;
      live[u] = it + u < it1 && e < n;
      if (live[u]) v[u] = *reinterpret_cast<const Pack<T, VEC>*>(xg + e);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (live[u]) fn(v[u], base + (long long)(it + u) * S);
  }
}

// The chain over a block's share: the streamed steps from global memory
// (xg), then the resident steps from shared memory (xs).
template <typename T, typename TN, int VEC, bool POLICY, bool FILM, int U>
__device__ __forceinline__ void apply_share(const T* xg, const T* xs, TN* y,
                                            const Chan* ch, long long base,
                                            long long n, int S, int iters,
                                            int resident) {
  stream_steps<T, VEC, U>(xg, base, n, S, resident, iters,
                          [&](const Pack<T, VEC>& v, long long e) {
                            apply_pack<T, TN, VEC, POLICY, FILM>(v, y + e,
                                                                 ch);
                          });
  const int slot = threadIdx.x * VEC;
  for (int it = 0; it < resident; ++it) {
    const long long e = base + (long long)it * S;
    if (e < n)
      apply_pack<T, TN, VEC, POLICY, FILM>(
          *reinterpret_cast<const Pack<T, VEC>*>(xs + it * S + slot), y + e,
          ch);
  }
}

// apply_share for the launch's mode (policy or folded, FiLM or not)
template <typename T, typename TN, int VEC>
__device__ __forceinline__ void apply_share_by_mode(
    const Params& p, const T* xg, const T* xs, TN* y, const Chan* ch,
    long long base, long long n, int S, int iters, int resident) {
#define SUPERDIFF_APPLY(POLICY, FILM)                                    \
  apply_share<T, TN, VEC, POLICY, FILM, kStreamU>(xg, xs, y, ch, base, n, \
                                                  S, iters, resident)
  if (!p.policy)
    SUPERDIFF_APPLY(false, false);      // FiLM is folded into the constants
  else if (p.scale != nullptr)
    SUPERDIFF_APPLY(true, true);
  else
    SUPERDIFF_APPLY(true, false);
#undef SUPERDIFF_APPLY
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& in, float* s,
                                           float* q) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = to_f(in.v[j]);
    s[j] += v;
    q[j] = fmaf(v, v, q[j]);
  }
}

// Per-thread float32 sums of S = blockDim.x * VEC slots -> per-channel
// sums in red[0, C) and red[S, S + C). Slot k holds channel k % C (S / C
// is a power of two): halve the slots while more than 16 share a channel,
// then one thread per channel (and per sums / squares) adds its column of
// slots in slot order.
template <int VEC>
__device__ __forceinline__ void fold_columns(float* red, const float* s,
                                             const float* q, int C) {
  const int S = blockDim.x * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[threadIdx.x * VEC + j] = s[j];
    red[S + threadIdx.x * VEC + j] = q[j];
  }
  __syncthreads();
  int width = S;
  for (; width / C > 16; width >>= 1) {
    const int half = width >> 1;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      red[k] += red[k + half];
      red[S + k] += red[S + k + half];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float* col = red + (i < C ? i : S + i - C);   // only this thread's column
    float t = 0.f;
    for (int m = 0; m < width; m += C) t += col[m];
    col[0] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

#ifdef SUPERDIFF_GN_TRACE
// Timeline of a cluster launch, for tuning builds only: per block (the
// first 1024), thread 0's globaltimer at its start and end (ns) and its
// clock64 at each phase boundary between.
__device__ long long gn_trace[1024][10];
#define GN_CLOCK(i)                                                        \
  if (threadIdx.x == 0 && blockIdx.x < 1024) gn_trace[blockIdx.x][i] = clock64();
#define GN_GLOBAL(i)                                                       \
  if (threadIdx.x == 0 && blockIdx.x < 1024) {                             \
    long long t;                                                           \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                  \
    gn_trace[blockIdx.x][i] = t;                                           \
  }
#else
#define GN_CLOCK(i)
#define GN_GLOBAL(i)
#endif

// Bytes of shared memory before the resident x: the fold (2 S), the
// cluster's per-channel totals (2 C) and the group sums (2 G), in floats,
// rounded up to 16 bytes, then 16 bytes for the copy's mbarrier. The Python
// geometry mirrors it.
__host__ __device__ __forceinline__ int cluster_fixed_bytes(int S, int C,
                                                            int G) {
  return ((2 * S + 2 * C + 2 * G) * 4 + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          (uint32_t)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"((uint32_t)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nGN_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra GN_WAIT_%=;\n}\n" ::"r"(
          (uint32_t)__cvta_generic_to_shared(bar)),
      "r"(parity)
      : "memory");
}


// One cluster of K blocks per sample (the regime the module header
// describes). iters: block steps per block; resident: how many of them sit
// in shared memory (the rest stream from global memory, twice).
template <typename T, typename TN, int VEC, typename P>
__global__ void __launch_bounds__(kClusterThreads, 2)
    gn_cluster(P p, int iters, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int S = blockDim.x * VEC, C = p.C, G = p.G, gw = C / G;
  const long long n = p.hw * C;
  float* red = reinterpret_cast<float*>(smem);
  float* tot = red + 2 * S;
  float* gsum = tot + 2 * C;
  T* xs = reinterpret_cast<T*>(smem + cluster_fixed_bytes(S, C, G));
  const T* xb = static_cast<const T*>(p.x) + b * n;
  TN* yb = static_cast<TN*>(p.y) + b * n;
  const long long base = (long long)rank * iters * S + threadIdx.x * VEC;
  const int slot = threadIdx.x * VEC;     // this thread's slots in a step
  GN_GLOBAL(0)
  GN_CLOCK(1)

  // 1. the resident steps, HBM -> shared: as bulk copies (the copy engine
  // keeps them all in flight) where they are whole 16-byte vectors, else
  // (scalar accesses, for ragged shapes) by plain loads
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + cluster_fixed_bytes(S, C, G) - 16);
  const long long r0 = (long long)rank * iters * S;
  const long long r1 = min(r0 + (long long)resident * S, n);
  if constexpr (sizeof(T) * VEC == 16) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      if (r1 > r0) {
        const long long bytes = (r1 - r0) * (long long)sizeof(T);
        mbar_expect(bar, (uint32_t)bytes);
        for (long long off = 0; off < bytes; off += 32768)
          bulk_copy(reinterpret_cast<unsigned char*>(xs) + off,
                    reinterpret_cast<const unsigned char*>(xb + r0) + off,
                    (uint32_t)min(bytes - off, 32768LL), bar);
      } else {
        mbar_expect(bar, 0);
      }
    }
  } else {            // each thread copies the slots it reads back
    for (int it = 0; it < resident; ++it) {
      const long long e = base + (long long)it * S;
      if (e < n)
        *reinterpret_cast<Pack<T, VEC>*>(xs + it * S + slot) =
            *reinterpret_cast<const Pack<T, VEC>*>(xb + e);
    }
  }
  ChanIn cin[VEC];         // read while the copies land
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    cin[j] = load_chan_in<TN>(p, b, (slot + j) % C);
  // 2. the sums: streamed steps from global memory while the copies land,
  // then the resident steps from shared memory
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  stream_steps<T, VEC, kStreamU>(xb, base, n, S, resident, iters,
                          [&](const Pack<T, VEC>& v, long long) {
                            accumulate<T, VEC>(v, s, q);
                          });
  GN_CLOCK(2)
  if constexpr (sizeof(T) * VEC == 16) {
    __syncthreads();                     // the mbarrier is initialised
    mbar_wait(bar, 0);
  }
  for (int it = 0; it < resident; ++it) {
    if (base + (long long)it * S < n)
      accumulate<T, VEC>(
          *reinterpret_cast<const Pack<T, VEC>*>(xs + it * S + slot), s, q);
  }
  GN_CLOCK(3)
  fold_columns<VEC>(red, s, q, C);
  GN_CLOCK(4)

  // 3. the cluster's per-channel totals, from every block's partials in
  // rank order through distributed shared memory (16-byte reads, four
  // ranks' at a time in flight): the same sums in every block
  cluster_arrive();
  cluster_wait();
  GN_CLOCK(5)
  if (C % 4 == 0) {
    for (int c4 = threadIdx.x; c4 < C / 4; c4 += blockDim.x) {
      float4 ts = make_float4(0.f, 0.f, 0.f, 0.f), tq = ts;
      for (int k0 = 0; k0 < K; k0 += 4) {
        float4 vs[4], vq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k0 + u < K) {
            const float* r = cluster.map_shared_rank(red, k0 + u);
            vs[u] = reinterpret_cast<const float4*>(r)[c4];
            vq[u] = reinterpret_cast<const float4*>(r + S)[c4];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k0 + u < K) {
            ts.x += vs[u].x; ts.y += vs[u].y; ts.z += vs[u].z;
            ts.w += vs[u].w;
            tq.x += vq[u].x; tq.y += vq[u].y; tq.z += vq[u].z;
            tq.w += vq[u].w;
          }
        }
      }
      reinterpret_cast<float4*>(tot)[c4] = ts;
      reinterpret_cast<float4*>(tot + C)[c4] = tq;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float ts = 0.f, tq = 0.f;
      for (int k = 0; k < K; ++k) {
        const float* r = cluster.map_shared_rank(red, k);
        ts += r[c];
        tq += r[S + c];
      }
      tot[c] = ts;
      tot[C + c] = tq;
    }
  }
  cluster_arrive();        // done reading the other blocks' shared memory
  GN_CLOCK(6)
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float gs = 0.f, gq = 0.f;
    for (int k = 0; k < gw; ++k) {
      gs += tot[g * gw + k];
      gq += tot[C + g * gw + k];
    }
    gsum[g] = gs;
    gsum[G + g] = gq;
    if (rank == 0) maybe_write_stats(p, b, g, gs, gq);
  }
  __syncthreads();
  Chan ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int g = ((slot + j) % C) / gw;
    ch[j] = make_chan(p, gsum[g], gsum[G + g], cin[j]);
  }

  GN_CLOCK(7)
  // 4. the chain: streamed steps first (their second read, from L2 while
  // it still holds them), then the resident steps from shared memory
  apply_share_by_mode<T, TN, VEC>(p, xb, xs, yb, ch, base, n, S, iters,
                                  resident);
  GN_CLOCK(8)
  cluster_wait();          // no block leaves while another reads its partials
  GN_GLOBAL(9)
}

// --- the three-pass regime -------------------------------------------------

// grid (tiles, B): per-(sample, tile, channel) partial sums
template <typename T, int VEC>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ psum,
                         float* __restrict__ psq, long long n, int C,
                         int iters) {
  extern __shared__ float red[];
  const int S = blockDim.x * VEC;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const T* xb = x + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  stream_steps<T, VEC, kStreamU>(xb, base, n, S, 0, iters,  // whole vectors
                          [&](const Pack<T, VEC>& v, long long) {
                            accumulate<T, VEC>(v, s, q);
                          });
  fold_columns<VEC>(red, s, q, C);
  float* osum = psum + ((long long)b * tiles + tile) * C;
  float* osq = psq + ((long long)b * tiles + tile) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    osum[c] = red[c];
    osq[c] = red[S + c];
  }
}

// grid (B): the partials summed over tiles (P = blockDim / C threads per
// channel, each over every P-th tile, then the P slices in order), then
// over each group's channels, in a fixed order; the chain's constants per
// (sample, channel)
template <typename TN, typename PT>
__global__ void gn_finalize(PT p, const float* __restrict__ psum,
                            const float* __restrict__ psq,
                            Chan* __restrict__ chan, int tiles) {
  extern __shared__ float part[];   // 2 P C slice sums, then 2 C totals
  const int C = p.C, gw = C / p.G, b = blockIdx.x;
  const int P = max(1, (int)blockDim.x / C);
  float* csum = P > 1 ? part + 2 * P * C : part;   // in place for P = 1
  float* csq = csum + C;
  for (int i = threadIdx.x; i < P * C; i += blockDim.x) {
    const int c = i % C;
    float s = 0.f, q = 0.f;
    for (int t = i / C; t < tiles; t += P) {
      s += psum[((long long)b * tiles + t) * C + c];
      q += psq[((long long)b * tiles + t) * C + c];
    }
    part[i] = s;
    part[P * C + i] = q;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < P; ++j) {
      s += part[j * C + c];
      q += part[P * C + j * C + c];
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
    chan[(long long)b * C + c] =
        make_chan(p, s, q, load_chan_in<TN>(p, b, c));
    if (c == c0) maybe_write_stats(p, b, c / gw, s, q);
  }
}

// the same grid as gn_stats: the chain, one cast on the store
template <typename T, typename TN, int VEC, bool POLICY>
__global__ void gn_apply(Params p, const Chan* __restrict__ chan, int iters) {
  // one kernel per mode, so that the folded mode keeps two constants per
  // channel in registers, not five
  const int S = blockDim.x * VEC, C = p.C;
  const int b = blockIdx.y, tile = blockIdx.x;
  const long long n = p.hw * C;
  const T* xb = static_cast<const T*>(p.x) + (long long)b * n;
  TN* yb = static_cast<TN*>(p.y) + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;
  Chan ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    ch[j] = chan[(long long)b * C + (threadIdx.x * VEC + j) % C];
  if constexpr (POLICY) {
    if (p.scale != nullptr)
      apply_share<T, TN, VEC, true, true, kStreamU>(xb, xb, yb, ch, base, n,
                                                   S, iters, 0);
    else
      apply_share<T, TN, VEC, true, false, kStreamU>(xb, xb, yb, ch, base, n,
                                                    S, iters, 0);
  } else {    // FiLM is folded into the constants
    apply_share<T, TN, VEC, false, false, kStreamU>(xb, xb, yb, ch, base, n,
                                                   S, iters, 0);
  }
}

template <typename T, typename TN, int VEC, typename P>
cudaError_t launch_three_pass(const P& p, float* work, int B,
                              int threads, int iters, int tiles,
                              cudaStream_t st) {
  const long long n = p.hw * p.C;
  const int S = threads * VEC, C = p.C;
  if (n % VEC || S % C || (S / C) & (S / C - 1) || threads > 1024 ||
      (long long)tiles * iters * S < n || S > 4096 || C > 4096)
    return cudaErrorInvalidValue;
  float* psum = work;
  float* psq = psum + (long long)B * tiles * C;
  Chan* chan = reinterpret_cast<Chan*>(psq + (long long)B * tiles * C);
  const dim3 grid(tiles, B);
  gn_stats<T, VEC><<<grid, threads, 2 * S * sizeof(float), st>>>(
      static_cast<const T*>(p.x), psum, psq, n, C, iters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slices = C < 256 ? 256 / C : 1;  // as gn_finalize computes it
  gn_finalize<TN, P><<<B, 256, (slices > 1 ? 2 * slices * C + 2 * C
                                              : 2 * C) * sizeof(float),
                        st>>>(p, psum, psq, chan, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.policy)
    gn_apply<T, TN, VEC, true><<<grid, threads, 0, st>>>(p, chan, iters);
  else
    gn_apply<T, TN, VEC, false><<<grid, threads, 0, st>>>(p, chan, iters);
  return cudaGetLastError();
}

template <typename T, typename TN, int VEC, typename P>
cudaError_t launch_cluster(const P& p, int B, int threads, int cluster,
                           int iters, int resident, int smem,
                           cudaStream_t st) {
  const int S = threads * VEC, C = p.C;
  if (S % C || (S / C) & (S / C - 1) || threads > kClusterThreads ||
      cluster < 1 || cluster > 16 || resident < 0 || resident > iters ||
      (long long)cluster * iters * S < p.hw * C ||
      smem != cluster_fixed_bytes(S, C, p.G) + resident * S * (int)sizeof(T) ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_cluster<T, TN, VEC, P>, p, iters,
                            resident);
}

template <typename T, typename TN, int VEC, typename P>
cudaError_t set_cluster_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      gn_cluster<T, TN, VEC, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(gn_cluster<T, TN, VEC, P>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

template <typename T, typename TN, int VEC>
cudaError_t set_stats_cluster_attributes() {
  if constexpr (std::is_same_v<TN, float>)
    return set_cluster_attributes<T, TN, VEC, ParamsStats>();
  else
    return cudaSuccess;
}

// The statistics-writing forward, for the float32 norm dtype alone (the
// training policy): other output dtypes are refused.
template <typename T, typename TN, int VEC>
cudaError_t launch_stats(const ParamsStats& p, float* work, int B, int regime,
                         int threads, int cluster, int iters, int resident,
                         int tiles, int smem, cudaStream_t st) {
  if constexpr (std::is_same_v<TN, float>) {
    if (regime == 1)
      return launch_cluster<T, TN, VEC, ParamsStats>(p, B, threads, cluster,
                                                     iters, resident, smem,
                                                     st);
    return launch_three_pass<T, TN, VEC, ParamsStats>(p, work, B, threads,
                                                      iters, tiles, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

// --- the backward (training: policy mode, TN = float32) ----------------------
//
// Replaces no TPU kernel: the JAX package differentiates its chain with XLA
// autodiff (superdiff_tpu/ops/fused_norm.py::_fused_bwd). With the chain's
// statistics from the forward (mean and r = rsqrt(var + eps) per sample and
// group), in float32:
//
//   d = x - mean, v = (d * (r * gamma) + beta) * (1 + s) + t  (rounded as
//     the forward rounds it), g_v = g * silu'(v);
//   per (sample, channel) A = sum_hw g_v, B = r * sum_hw g_v * d;
//   dt = A, ds = gamma B + beta A, dbeta = sum_b (1 + s) A,
//     dgamma = sum_b (1 + s) B;
//   dx = r gamma (1 + s) g_v - r S1 / N - d r^2 S2 / N, with S1, S2 the sums
//     of gamma (1 + s) A and gamma (1 + s) B over the group's channels and N
//     the group's element count.
//
// What bounds it: bytes. It reads x and g to form A and B, then reads them
// again and writes dx: 14 bytes an element for bf16 x from HBM, 8 where the
// second read hits L2; about 30 flops an element. Two regimes, as the
// forward's (ops/fused_norm.py::backward_geometry):
//
//   gn_bwd_cluster for batches whose x and g fit in 64 MB: one cluster of
//     K = 4-16 blocks per sample; each block sums A and B over its share per
//     channel, every block reads all K blocks' partials in rank order through
//     distributed shared memory, then writes dx for its share, reading x and
//     g again from L2. x and g are not kept in shared memory: at 6 bytes an
//     element a quarter of an SM holds a few percent of a block's share.
//   three passes (gn_bwd_reduce, gn_bwd_finalize, gn_bwd_apply) above that
//     (the CondUNet's 128^2 chains at batch 16), where they measured
//     faster.
//
// Both end with gn_bwd_params, which sums the per-sample (1 + s) A and
// (1 + s) B over the batch into dbeta and dgamma. Deterministic: fixed
// reduction orders and no float atomics. Loads are 16 bytes of g (VEC = 4)
// and 8 or 16 of x where the length and the addresses allow, else scalar.

struct BwdParams {
  const void* x;
  const float* g;              // dL/dy, float32, x's layout
  void* dx;
  const float* stats;          // (B, G, 2): mean, rsqrt(var + eps)
  const float* gamma;
  const float* beta;
  const float* scale;          // null: no FiLM
  const float* shift;
  long long film_ld;
  long long hw;
  int C, G;
  float inv_count;
  float* dscale;               // (B, C) when FiLM
  float* dshift;
  float* fsa;                  // (B, C): (1 + s) A and (1 + s) B
  float* fsb;
  float* dgamma;               // (C,)
  float* dbeta;
};

// One (sample, channel)'s constants: the forward's chain (mean, mul = r *
// gamma, add = beta, fs = 1 + s, sh = t) and dx's (k = mul * fs, c0, c1).
struct BwdChan {
  float mean, mul, add, fs, sh, k, c0, c1;
};

__device__ __forceinline__ long long stat_at(const BwdParams& p, int b,
                                             int c) {
  return 2 * ((long long)b * p.G + c / (p.C / p.G));
}

__device__ __forceinline__ float film_fs(const BwdParams& p, int b, int c) {
  return p.scale == nullptr
             ? 1.f
             : __fadd_rn(1.f, p.scale[(long long)b * p.film_ld + c]);
}

__device__ __forceinline__ BwdChan load_bwd_chan(const BwdParams& p, int b,
                                                 int c) {
  BwdChan ch;
  const long long sg = stat_at(p, b, c);
  ch.mean = p.stats[sg];
  ch.mul = __fmul_rn(p.stats[sg + 1], p.gamma[c]);
  ch.add = p.beta[c];
  ch.fs = film_fs(p, b, c);
  ch.sh = p.scale == nullptr ? 0.f : p.shift[(long long)b * p.film_ld + c];
  ch.k = ch.c0 = ch.c1 = 0.f;
  return ch;
}

// g_v of one element, and d = x - mean; v as the forward computes it
template <bool FILM>
__device__ __forceinline__ float grad_v(float x, float g, const BwdChan& ch,
                                        float& d) {
  d = __fsub_rn(x, ch.mean);
  float v = __fadd_rn(__fmul_rn(d, ch.mul), ch.add);
  if constexpr (FILM) v = __fadd_rn(__fmul_rn(v, ch.fs), ch.sh);
  const float sig = __frcp_rn(__fadd_rn(1.f, expf(-v)));
  return g * (sig * fmaf(v, 1.f - sig, 1.f));
}

// Steps it0 .. it1 - 1 of this thread's slots of x and g, U at a time, loads
// first: fn(x pack, g pack, element index).
template <typename T, int VEC, int U, typename Fn>
__device__ __forceinline__ void stream_xg(const T* xg, const float* gg,
                                          long long base, long long n, int S,
                                          int it0, int it1, Fn&& fn) {
  for (int it = it0; it < it1; it += U) {
    Pack<T, VEC> xv[U];
    Pack<float, VEC> gv[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (long long)(it + u) * S;
      live[u] = it + u < it1 && e < n;
      if (live[u]) {
        xv[u] = *reinterpret_cast<const Pack<T, VEC>*>(xg + e);
        gv[u] = *reinterpret_cast<const Pack<float, VEC>*>(gg + e);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (live[u]) fn(xv[u], gv[u], base + (long long)(it + u) * S);
  }
}

// Per-thread sums of g_v (sa) and g_v * d (sb) over this thread's slots
template <typename T, int VEC, bool FILM>
__device__ __forceinline__ void bwd_sums(const T* xb, const float* gb,
                                         const BwdChan* ch, long long base,
                                         long long n, int S, int iters,
                                         float* sa, float* sb) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) sa[j] = sb[j] = 0.f;
  stream_xg<T, VEC, kStreamU>(
      xb, gb, base, n, S, 0, iters,
      [&](const Pack<T, VEC>& xv, const Pack<float, VEC>& gv, long long) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float d;
          const float gvj = grad_v<FILM>(to_f(xv.v[j]), gv.v[j], ch[j], d);
          sa[j] += gvj;
          sb[j] = fmaf(gvj, d, sb[j]);
        }
      });
}

// dx over this thread's slots
template <typename T, int VEC, bool FILM>
__device__ __forceinline__ void bwd_dx(const T* xb, const float* gb, T* db,
                                       const BwdChan* ch, long long base,
                                       long long n, int S, int iters) {
  stream_xg<T, VEC, kStreamU>(
      xb, gb, base, n, S, 0, iters,
      [&](const Pack<T, VEC>& xv, const Pack<float, VEC>& gv, long long e) {
        Pack<T, VEC> r;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float d;
          const float gvj = grad_v<FILM>(to_f(xv.v[j]), gv.v[j], ch[j], d);
          r.v[j] = from_f<T>(
              fmaf(ch[j].k, gvj, -fmaf(d, ch[j].c1, ch[j].c0)));
        }
        *reinterpret_cast<Pack<T, VEC>*>(db + e) = r;
      });
}

// One channel of one sample, from its totals a = A and bs = sum g_v * d:
// where `write`, its outputs (dt and ds where there is FiLM; (1 + s) A and
// (1 + s) B for the batch sums); returns gamma (1 + s) A and gamma (1 + s) B
// in a and bs, the terms of the group sums.
__device__ __forceinline__ void bwd_channel(const BwdParams& p, int b, int c,
                                            bool write, float& a, float& bs) {
  const float B = p.stats[stat_at(p, b, c) + 1] * bs;
  const float fs = film_fs(p, b, c);
  if (write) {
    const long long o = (long long)b * p.C + c;
    if (p.scale != nullptr) {
      p.dshift[o] = a;
      p.dscale[o] = fmaf(p.gamma[c], B, p.beta[c] * a);
    }
    p.fsa[o] = fs * a;
    p.fsb[o] = fs * B;
  }
  a = p.gamma[c] * (fs * a);
  bs = p.gamma[c] * (fs * B);
}

// dx's constants of one (sample, channel) from its group's sums s1, s2
__device__ __forceinline__ void bwd_dx_consts(const BwdParams& p, int b,
                                              int c, float s1, float s2,
                                              BwdChan& ch) {
  const float r = p.stats[stat_at(p, b, c) + 1];
  ch.k = ch.mul * ch.fs;
  ch.c0 = r * s1 * p.inv_count;
  ch.c1 = r * r * s2 * p.inv_count;
}

// The group sums of tot's two columns (C each) into gsum (G each), each
// group's channels in order.
__device__ __forceinline__ void group_sums(const float* tot, float* gsum,
                                           int C, int G) {
  const int gw = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < gw; ++k) {
      s1 += tot[g * gw + k];
      s2 += tot[C + g * gw + k];
    }
    gsum[g] = s1;
    gsum[G + g] = s2;
  }
}

// One cluster of K blocks per sample: sums, the cluster's totals through
// distributed shared memory, dx. Shared memory: the fold (2 S), the
// channel totals (2 C) and the group sums (2 G) in floats, within the
// forward's cluster_fixed_bytes.
template <typename T, int VEC, bool FILM>
__global__ void __launch_bounds__(kClusterThreads, 2)
    gn_bwd_cluster(BwdParams p, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int S = blockDim.x * VEC, C = p.C, G = p.G, gw = C / G;
  const long long n = p.hw * C;
  float* red = reinterpret_cast<float*>(smem);
  float* tot = red + 2 * S;
  float* gsum = tot + 2 * C;
  const T* xb = static_cast<const T*>(p.x) + b * n;
  const float* gb = p.g + b * n;
  T* db = static_cast<T*>(p.dx) + b * n;
  const long long base = (long long)rank * iters * S + threadIdx.x * VEC;
  const int slot = threadIdx.x * VEC;
  BwdChan ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) ch[j] = load_bwd_chan(p, b, (slot + j) % C);
  float sa[VEC], sb[VEC];
  bwd_sums<T, VEC, FILM>(xb, gb, ch, base, n, S, iters, sa, sb);
  fold_columns<VEC>(red, sa, sb, C);
  cluster_arrive();
  cluster_wait();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, bs = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* r = cluster.map_shared_rank(red, k);
      a += r[c];
      bs += r[S + c];
    }
    bwd_channel(p, b, c, rank == 0, a, bs);
    tot[c] = a;
    tot[C + c] = bs;
  }
  cluster_arrive();        // done reading the other blocks' shared memory
  __syncthreads();
  group_sums(tot, gsum, C, G);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = (slot + j) % C;
    bwd_dx_consts(p, b, c, gsum[c / gw], gsum[G + c / gw], ch[j]);
  }
  bwd_dx<T, VEC, FILM>(xb, gb, db, ch, base, n, S, iters);
  cluster_wait();          // no block leaves while another reads its partials
}

// grid (tiles, B): per-(sample, tile, channel) partial sums of g_v and
// g_v * d
template <typename T, int VEC, bool FILM>
__global__ void gn_bwd_reduce(BwdParams p, float* __restrict__ pa,
                              float* __restrict__ pb, int iters) {
  extern __shared__ float red[];
  const int S = blockDim.x * VEC, C = p.C;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const long long n = p.hw * C;
  const T* xb = static_cast<const T*>(p.x) + (long long)b * n;
  const float* gb = p.g + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;
  BwdChan ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    ch[j] = load_bwd_chan(p, b, (threadIdx.x * VEC + j) % C);
  float sa[VEC], sb[VEC];
  bwd_sums<T, VEC, FILM>(xb, gb, ch, base, n, S, iters, sa, sb);
  fold_columns<VEC>(red, sa, sb, C);
  float* oa = pa + ((long long)b * tiles + tile) * C;
  float* ob = pb + ((long long)b * tiles + tile) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    oa[c] = red[c];
    ob[c] = red[S + c];
  }
}

// grid (B): the partials summed over tiles (P = blockDim / C threads per
// channel, each over every P-th tile, then the P slices in order, as
// gn_finalize), each channel's outputs, the group sums, and dx's constants
// per (sample, channel)
__global__ void gn_bwd_finalize(BwdParams p, const float* __restrict__ pa,
                                const float* __restrict__ pb,
                                BwdChan* __restrict__ chan, int tiles) {
  extern __shared__ float part[];   // 2 P C slice sums, 2 C totals, 2 G
  const int C = p.C, G = p.G, gw = C / G, b = blockIdx.x;
  const int P = max(1, (int)blockDim.x / C);
  float* tot = part + 2 * P * C;
  float* gsum = tot + 2 * C;
  for (int i = threadIdx.x; i < P * C; i += blockDim.x) {
    const int c = i % C;
    float a = 0.f, bs = 0.f;
    for (int t = i / C; t < tiles; t += P) {
      a += pa[((long long)b * tiles + t) * C + c];
      bs += pb[((long long)b * tiles + t) * C + c];
    }
    part[i] = a;
    part[P * C + i] = bs;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, bs = 0.f;
    for (int j = 0; j < P; ++j) {
      a += part[j * C + c];
      bs += part[P * C + j * C + c];
    }
    bwd_channel(p, b, c, true, a, bs);
    tot[c] = a;
    tot[C + c] = bs;
  }
  __syncthreads();
  group_sums(tot, gsum, C, G);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    BwdChan ch = load_bwd_chan(p, b, c);
    bwd_dx_consts(p, b, c, gsum[c / gw], gsum[G + c / gw], ch);
    chan[(long long)b * C + c] = ch;
  }
}

// the same grid as gn_bwd_reduce: dx
template <typename T, int VEC, bool FILM>
__global__ void gn_bwd_apply(BwdParams p, const BwdChan* __restrict__ chan,
                             int iters) {
  const int S = blockDim.x * VEC, C = p.C;
  const int b = blockIdx.y, tile = blockIdx.x;
  const long long n = p.hw * C;
  const T* xb = static_cast<const T*>(p.x) + (long long)b * n;
  const float* gb = p.g + (long long)b * n;
  T* db = static_cast<T*>(p.dx) + (long long)b * n;
  const long long base = (long long)tile * iters * S + threadIdx.x * VEC;
  BwdChan ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    ch[j] = chan[(long long)b * C + (threadIdx.x * VEC + j) % C];
  bwd_dx<T, VEC, FILM>(xb, gb, db, ch, base, n, S, iters);
}

// grid (ceil(C / 256)): dbeta and dgamma, each channel's per-sample terms
// summed in sample order
__global__ void gn_bwd_params(BwdParams p, int B) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.C) return;
  float a = 0.f, bs = 0.f;
  for (int b = 0; b < B; ++b) {
    a += p.fsa[(long long)b * p.C + c];
    bs += p.fsb[(long long)b * p.C + c];
  }
  p.dbeta[c] = a;
  p.dgamma[c] = bs;
}

template <typename T, int VEC, bool FILM>
cudaError_t launch_bwd(const BwdParams& p, float* work, int B, int regime,
                       int threads, int cluster, int iters, int tiles,
                       int smem, cudaStream_t st) {
  const long long n = p.hw * p.C;
  const int S = threads * VEC, C = p.C;
  if (n % VEC || S % C || (S / C) & (S / C - 1) || S > 4096 || C > 4096)
    return cudaErrorInvalidValue;
  if (regime == 1) {
    if (threads > kClusterThreads || cluster < 1 || cluster > 16 ||
        (long long)cluster * iters * S < n ||
        smem < (2 * S + 2 * C + 2 * p.G) * (int)sizeof(float) ||
        smem > kMaxSmem)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, gn_bwd_cluster<T, VEC, FILM>,
                                         p, iters);
    if (err != cudaSuccess) return err;
  } else {
    if (threads > 1024 || (long long)tiles * iters * S < n)
      return cudaErrorInvalidValue;
    // work: pa, pb (B tiles C each), then the BwdChan of every (b, c)
    float* pa = work + 2LL * B * C;
    float* pb = pa + (long long)B * tiles * C;
    BwdChan* chan = reinterpret_cast<BwdChan*>(pb + (long long)B * tiles * C);
    const dim3 grid(tiles, B);
    gn_bwd_reduce<T, VEC, FILM><<<grid, threads, 2 * S * sizeof(float), st>>>(
        p, pa, pb, iters);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int slices = C < 256 ? 256 / C : 1;   // as gn_bwd_finalize
    gn_bwd_finalize<<<B, 256,
                      (2 * slices * C + 2 * C + 2 * p.G) * sizeof(float),
                      st>>>(p, pa, pb, chan, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn_bwd_apply<T, VEC, FILM><<<grid, threads, 0, st>>>(p, chan, iters);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  gn_bwd_params<<<(C + 255) / 256, 256, 0, st>>>(p, B);
  return cudaGetLastError();
}

template <typename T, int VEC, bool FILM>
cudaError_t set_bwd_cluster_attributes() {
  return cudaFuncSetAttribute(gn_bwd_cluster<T, VEC, FILM>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

// Every (input dtype, output dtype, VEC) the library holds: dtype 0 =
// bfloat16, 1 = float32; VEC elements per access (16 bytes, or scalars).
#define SUPERDIFF_GN_CASES(X)                                             \
  X(__nv_bfloat16, 0, __nv_bfloat16, 0, 8)                                \
  X(__nv_bfloat16, 0, __nv_bfloat16, 0, 1)                                \
  X(__nv_bfloat16, 0, float, 1, 8)                                        \
  X(__nv_bfloat16, 0, float, 1, 1)                                        \
  X(float, 1, float, 1, 4)                                                \
  X(float, 1, float, 1, 1)                                                \
  X(float, 1, __nv_bfloat16, 0, 4)                                        \
  X(float, 1, __nv_bfloat16, 0, 1)

// Every (x dtype, VEC) of the backward: 16 bytes of g, or scalars.
#define SUPERDIFF_GN_BWD_CASES(X)                                         \
  X(__nv_bfloat16, 0, 4)                                                  \
  X(__nv_bfloat16, 0, 1)                                                  \
  X(float, 1, 4)                                                          \
  X(float, 1, 1)

// Once per device, before the first launch: lets every cluster kernel use
// up to 227 KB of dynamic shared memory and clusters of 16 blocks, and
// fills the bfloat16 SiLU table.
extern "C" int superdiff_gn_init() {
#define SUPERDIFF_INIT(T, DT, TN, DN, V)                                  \
  if (cudaError_t e = set_cluster_attributes<T, TN, V, Params>();         \
      e != cudaSuccess)                                                   \
    return (int)e;                                                        \
  if (cudaError_t e = set_stats_cluster_attributes<T, TN, V>();           \
      e != cudaSuccess)                                                   \
    return (int)e;
  SUPERDIFF_GN_CASES(SUPERDIFF_INIT)
#undef SUPERDIFF_INIT
#define SUPERDIFF_BWD_INIT(T, DT, V)                                      \
  if (cudaError_t e = set_bwd_cluster_attributes<T, V, true>();           \
      e != cudaSuccess)                                                   \
    return (int)e;                                                        \
  if (cudaError_t e = set_bwd_cluster_attributes<T, V, false>();          \
      e != cudaSuccess)                                                   \
    return (int)e;
  SUPERDIFF_GN_BWD_CASES(SUPERDIFF_BWD_INIT)
#undef SUPERDIFF_BWD_INIT
  if (cudaError_t e = cudaFuncSetAttribute(
          gn_bwd_finalize, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      e != cudaSuccess)
    return (int)e;
  // the SiLU table, on a stream of its own (the caller's may be capturing)
  cudaStream_t st;
  cudaError_t e = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  gn_fill_silu_table<<<256, 256, 0, st>>>();
  e = cudaGetLastError();
  const cudaError_t e2 = cudaStreamSynchronize(st);
  cudaStreamDestroy(st);
  return (int)(e != cudaSuccess ? e : e2);
}

// x: (B, H*W, C) contiguous in in_dtype; y: the same shape in out_dtype.
// gamma, beta: (C,) float32; scale, shift: float32 with row stride film_ld
// (FiLM of sample b, channel c at [b * film_ld + c]), or both null.
// policy: 1 the CondUNet's rounding sequence, 0 the folded float32 chain.
// stats: null, or (policy mode, float32 y) (B, G, 2) float32 for each
// group's mean and rsqrt(var + eps), for the backward.
// regime: 0 three passes (work: float32 scratch of 2*B*tiles*C + 5*B*C;
// vec, threads, iters, tiles), 1 cluster (work unused; vec, threads,
// cluster, iters, resident, smem). The geometry is chosen by the Python
// wrapper (ops/fused_norm.py::launch_geometry). Returns a CUDA error code.
extern "C" int superdiff_gn_silu(const void* x, void* y, const float* gamma,
                                 const float* beta, const float* scale,
                                 const float* shift, long long film_ld,
                                 float* work, float* stats, int B,
                                 long long hw, int C, int G, int in_dtype,
                                 int out_dtype,
                                 int policy, int regime, int vec, int threads,
                                 int cluster, int iters, int resident,
                                 int tiles, int smem, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 0 || C % G || (scale == nullptr) != (shift == nullptr) ||
      (policy == 0 && in_dtype != out_dtype) ||
      (stats != nullptr && policy == 0))
    return (int)cudaErrorInvalidValue;
  Params p{x, y, gamma, beta, scale, shift, film_ld, hw, C, G, policy,
           1.f / (float)(hw * (C / G)), eps};
#define SUPERDIFF_STATS(T, DT, TN, DN, V)                                  \
  if (stats != nullptr && in_dtype == DT && out_dtype == DN && vec == V)   \
    return (int)launch_stats<T, TN, V>(ParamsStats{p, stats}, work, B,     \
                                       regime, threads, cluster, iters,    \
                                       resident, tiles, smem, st);
#define SUPERDIFF_CLUSTER(T, DT, TN, DN, V)                                \
  if (regime == 1 && in_dtype == DT && out_dtype == DN && vec == V)        \
    return (int)launch_cluster<T, TN, V, Params>(p, B, threads, cluster,   \
                                                 iters, resident, smem, st);
#define SUPERDIFF_THREE_PASS(T, DT, TN, DN, V)                             \
  if (regime == 0 && in_dtype == DT && out_dtype == DN && vec == V)        \
    return (int)launch_three_pass<T, TN, V, Params>(p, work, B, threads,   \
                                                    iters, tiles, st);
  SUPERDIFF_GN_CASES(SUPERDIFF_STATS)
  SUPERDIFF_GN_CASES(SUPERDIFF_CLUSTER)
  SUPERDIFF_GN_CASES(SUPERDIFF_THREE_PASS)
#undef SUPERDIFF_STATS
#undef SUPERDIFF_CLUSTER
#undef SUPERDIFF_THREE_PASS
  return (int)cudaErrorInvalidValue;
}

#ifdef SUPERDIFF_GN_TRACE
// The timeline of the last cluster launch's first `blocks` blocks, 10
// values each, into out.
extern "C" int superdiff_gn_trace(long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, gn_trace,
                                   sizeof(long long) * 10 * blocks);
}
#endif

// How many clusters of one cluster-regime geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out. Returns a CUDA error code.
extern "C" int superdiff_gn_max_clusters(int in_dtype, int out_dtype,
                                         int vec, int threads, int cluster,
                                         int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define SUPERDIFF_OCC(T, DT, TN, DN, V)                                   \
  if (in_dtype == DT && out_dtype == DN && vec == V)                      \
    return (int)cudaOccupancyMaxActiveClusters(                           \
        out, gn_cluster<T, TN, V, Params>, &cfg);
  SUPERDIFF_GN_CASES(SUPERDIFF_OCC)
#undef SUPERDIFF_OCC
  return (int)cudaErrorInvalidValue;
}

// The backward of the policy chain with a float32 norm dtype (see the
// backward's notes above). x: (B, H*W, C) contiguous in in_dtype; g: dL/dy,
// float32, contiguous, the same shape; dx: x's shape and dtype; stats: the
// forward's (B, G, 2). gamma, beta: (C,) float32; scale, shift as the
// forward's, or both null. dgamma, dbeta: (C,); dscale, dshift: (B, C)
// contiguous (unused without FiLM); all float32. regime: 0 three passes
// (work: float32 scratch of 2*B*C + 2*B*tiles*C + 8*B*C; vec, threads,
// iters, tiles), 1 cluster (work: 2*B*C; vec, threads, cluster, iters,
// smem). The geometry is chosen by the Python wrapper
// (ops/fused_norm.py::backward_geometry). Returns a CUDA error code.
extern "C" int superdiff_gn_silu_bwd(
    const void* x, const float* g, void* dx, const float* stats,
    const float* gamma, const float* beta, const float* scale,
    const float* shift, long long film_ld, float* dgamma, float* dbeta,
    float* dscale, float* dshift, float* work, int B, long long hw, int C,
    int G, int in_dtype, int regime, int vec, int threads, int cluster,
    int iters, int tiles, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 0 || C % G || (scale == nullptr) != (shift == nullptr) ||
      (scale != nullptr && (dscale == nullptr || dshift == nullptr)))
    return (int)cudaErrorInvalidValue;
  BwdParams p{x, g, dx, stats, gamma, beta, scale, shift, film_ld, hw, C, G,
              1.f / (float)(hw * (C / G)), dscale, dshift, work,
              work + (long long)B * C, dgamma, dbeta};
#define SUPERDIFF_BWD(T, DT, V)                                           \
  if (in_dtype == DT && vec == V)                                         \
    return (int)(scale != nullptr                                         \
                     ? launch_bwd<T, V, true>(p, work, B, regime, threads, \
                                              cluster, iters, tiles, smem, \
                                              st)                         \
                     : launch_bwd<T, V, false>(p, work, B, regime,        \
                                               threads, cluster, iters,   \
                                               tiles, smem, st));
  SUPERDIFF_GN_BWD_CASES(SUPERDIFF_BWD)
#undef SUPERDIFF_BWD
  return (int)cudaErrorInvalidValue;
}
