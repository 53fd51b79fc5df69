// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV,
// that recompute the probabilities from the forward's logsumexp.
//
// Replaces the TPU kernels superdiff_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (launched by
// _flash_backward). Same functions, not the same block structure: on the TPU
// the reduction axis is a sequential innermost grid axis whose f32
// accumulator (dq_scr, dk_scr/dv_scr) persists in VMEM scratch. Here blocks
// run in no order, so each block owns its output tile and loops itself:
//
//   dQ   : one block per (batch*head, 64-query tile); loops over 64-key tiles
//          S  = Q K^T * scale          P  = exp(S - lse)
//          dP = dO V^T                 dS = P o (dP - delta) * scale
//          dQ += dS K
//   dK/dV: one block per (batch*head, 64-key tile); loops over 64-query
//          tiles and forms the transposed tiles directly,
//          S^T = K Q^T, dP^T = V dO^T, so every product is a row-major
//          A-operand times a tile in shared memory:
//          dV += P^T dO                dK += dS^T Q
//
// Each output element is written exactly once by the block that owns it: no
// floating-point atomics, so the backward is deterministic run to run.
//
// Layout: q, k, v, dO are read and dQ, dK, dV written as (B, S, H, D)
// through the element strides the caller passes (contiguous last dim), so
// the split views of a fused qkv projection need no transpose copies. lse
// and delta = rowsum(dO o O) are (B*H, S) float32, row b*H + h.
//
// Numerics match the TPU kernels: scores, P, dP and the accumulators are
// f32; P is rounded to the input dtype before P^T dO, dS is rounded to the
// input dtype before dS K and dS^T Q; outputs are cast once at the end.
//
// What bounds them on this card: per score dQ does 6*D and dK/dV 8*D tensor
// flops against one exponential; at the training path's main shape
// (S=1024, D=32) the SFU's 16 exponentials per clock per SM still sets the
// floor for dQ, the tensor cores for dK/dV at D=64. This first version keeps
// the products on the tensor cores (nvcuda::wmma bf16 16x16x16, f32
// accumulate; the output accumulators stay in fragments across the loop)
// and does one exp2 per score with log2(e) folded in. The f32 variant (used
// by the parity checks) does every product with plain FMA loops. Tiles are
// staged in shared memory with 16-byte loads; A fragments are re-read from
// shared memory every tile (registers go to the accumulators); no
// cp.async/TMA pipelining or wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BT = 64;        // rows per tile (queries or keys)
constexpr int NWARPS = 4;     // each warp owns 16 rows of the block's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8; };  // 16 B
template <> struct Cfg<float> { static constexpr int PAD = 4; };          // 16 B

__host__ __device__ constexpr int align32(int bytes) { return (bytes + 31) & ~31; }

template <typename T, int D>
struct Smem {
  static constexpr int LD = D + Cfg<T>::PAD;          // tile row stride (elems)
  static constexpr int LDP = BT + Cfg<T>::PAD;        // P / dS row stride (elems)
  static constexpr int LDS = (BT > D ? BT : D) + 4;   // f32 scratch stride
  static constexpr bool WMMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int tile = align32(BT * LD * (int)sizeof(T));
  static constexpr int a_off = 0;                     // owned tile 1 (Q | K)
  static constexpr int b_off = a_off + tile;          // owned tile 2 (dO | V)
  static constexpr int x_off = b_off + tile;          // looped tile 1 (K | Q)
  static constexpr int y_off = x_off + tile;          // looped tile 2 (V | dO)
  static constexpr int p_off = y_off + tile;
  static constexpr int stat_off = p_off + align32(NWARPS * 16 * LDP * (int)sizeof(T));
  static constexpr int s_off = stat_off + align32(2 * BT * (int)sizeof(float));
  static constexpr int bytes =
      s_off + (WMMA ? align32(NWARPS * 16 * LDS * (int)sizeof(float)) : 0);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy a (64 x D) tile of one (b, h) slice into shared memory with 16-byte
// vectors; rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t s_stride,
                                          int row0, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                 // vectors per row
  constexpr int LD = Smem<T, D>::LD;
  for (int i = threadIdx.x; i < BT * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// s[j] = sum_d A[wrow][d] * X[half*32 + j][d] for this lane's row of the
// warp's 16-row slice `A` against the 64-row tile `X` (both row stride LD):
// a 16 x 64 tile of A X^T per warp. The wmma path goes through the warp's
// f32 scratch `Sw` to reach per-row registers.
template <typename T, int D>
__device__ __forceinline__ void tile_scores(const T* A, const T* X, float* Sw,
                                            int wrow, int half, float (&s)[32]) {
  using L = Smem<T, D>;
  if constexpr (L::WMMA) {
    using namespace nvcuda;
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(A);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(X);
#pragma unroll
    for (int nt = 0; nt < BT / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> xf;
        wmma::load_matrix_sync(af, a + kt * 16, L::LD);
        wmma::load_matrix_sync(xf, x + (nt * 16) * L::LD + kt * 16, L::LD);
        wmma::mma_sync(c, af, xf, c);
      }
      wmma::store_matrix_sync(Sw + nt * 16, c, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = Sw[wrow * L::LDS + half * 32 + j];
    __syncwarp();                              // Sw is rewritten by the caller
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    const T* arow = A + wrow * L::LD;
    for (int d = 0; d < D; ++d) {
      const float ad = to_f32(arow[d]);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = fmaf(ad, to_f32(X[(half * 32 + j) * L::LD + d]), s[j]);
    }
  }
}

// A warp's 16 x D f32 output accumulator, resident across the block's loop:
// wmma accumulator fragments (bf16) or D/2 registers per lane (f32).
template <typename T, int D>
struct Acc {
  using L = Smem<T, D>;
  static constexpr int DH = D / 2;            // output columns per lane
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      f[L::WMMA ? D / 16 : 1];
  float a[L::WMMA ? 1 : DH];

  __device__ __forceinline__ void zero() {
    if constexpr (L::WMMA) {
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) nvcuda::wmma::fill_fragment(f[dt], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < DH; ++i) a[i] = 0.f;
    }
  }

  // acc += Pw (16 x 64, row stride LDP, already rounded to T) . Y (64 x D)
  __device__ __forceinline__ void mma(const T* Pw, const T* Y, int wrow, int half) {
    if constexpr (L::WMMA) {
      using namespace nvcuda;
      const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(Pw);
      const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(Y);
#pragma unroll
      for (int kt = 0; kt < BT / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, p + kt * 16, L::LDP);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> yf;
          wmma::load_matrix_sync(yf, y + (kt * 16) * L::LD + dt * 16, L::LD);
          wmma::mma_sync(f[dt], pf, yf, f[dt]);
        }
      }
    } else {
      const T* prow = Pw + wrow * L::LDP;
      for (int c = 0; c < BT; ++c) {
        const float p = to_f32(prow[c]);
        const T* yrow = Y + c * L::LD + half * DH;
#pragma unroll
        for (int i = 0; i < DH; ++i) a[i] = fmaf(p, to_f32(yrow[i]), a[i]);
      }
    }
  }

  // Write this lane's half row (DH columns) to dst when `valid`; the wmma
  // path goes through the warp's f32 scratch, so every lane must call it.
  __device__ __forceinline__ void store(float* Sw, int wrow, int half, T* dst,
                                        bool valid) {
    if constexpr (L::WMMA) {
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
        nvcuda::wmma::store_matrix_sync(Sw + dt * 16, f[dt], L::LDS,
                                        nvcuda::wmma::mem_row_major);
      __syncwarp();
      if (valid) {
#pragma unroll
        for (int i = 0; i < DH; ++i)
          dst[i] = from_f32<T>(Sw[wrow * L::LDS + half * DH + i]);
      }
      __syncwarp();
    } else {
      if (valid) {
#pragma unroll
        for (int i = 0; i < DH; ++i) dst[i] = from_f32<T>(a[i]);
      }
    }
  }
};

struct Strides { int64_t b, s, h; };

// ------------------------------------------------------------------- dQ ---

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int H, float scale,
                    Strides qs, Strides ks, Strides vs, Strides gs, Strides dqs) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::a_off);
  T* Gs = reinterpret_cast<T*>(smem + L::b_off);
  T* Ks = reinterpret_cast<T*>(smem + L::x_off);
  T* Vs = reinterpret_cast<T*>(smem + L::y_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = lane / 2;                  // row within the warp's 16
  const int half = lane % 2;                  // which half of the columns
  const int qi = q0 + warp * 16 + wrow;       // this lane's query
  const float sl2 = scale * LOG2E;            // scores in the log2 domain

  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<T, D>(Gs, dout + b * gs.b + h * gs.h, gs.s, q0, S);

  const bool row_ok = qi < S;
  const float lse2 = row_ok ? lse[(int64_t)bh * S + qi] * LOG2E : 0.f;
  const float dlt = row_ok ? delta[(int64_t)bh * S + qi] : 0.f;

  T* Pw = Ps + warp * 16 * L::LDP;
  float* Sw = nullptr;
  if constexpr (L::WMMA)
    Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
  const T* Qw = Qs + warp * 16 * L::LD;
  const T* Gw = Gs + warp * 16 * L::LD;

  Acc<T, D> acc;
  acc.zero();

  for (int kv0 = 0; kv0 < S; kv0 += BT) {
    __syncthreads();                          // previous tile fully consumed
    load_tile<T, D>(Ks, kbase, ks.s, kv0, S);
    load_tile<T, D>(Vs, vbase, vs.s, kv0, S);
    __syncthreads();

    float s[32], dp[32];
    tile_scores<T, D>(Qw, Ks, Sw, wrow, half, s);      // Q K^T
    tile_scores<T, D>(Gw, Vs, Sw, wrow, half, dp);     // dO V^T
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool valid = kv0 + half * 32 + j < S;
      const float p = valid ? exp2f(s[j] * sl2 - lse2) : 0.f;
      Pw[wrow * L::LDP + half * 32 + j] = from_f32<T>(p * (dp[j] - dlt) * scale);
    }
    __syncwarp();
    acc.mma(Pw, Ks, wrow, half);                       // dQ += dS K
    __syncwarp();                                      // Pw is rewritten next tile
  }

  T* dst = dq + b * dqs.b + (int64_t)qi * dqs.s + h * dqs.h + half * (D / 2);
  acc.store(Sw, wrow, half, dst, row_ok);
}

// ---------------------------------------------------------------- dK/dV ---

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                     float scale, Strides qs, Strides ks, Strides vs, Strides gs,
                     Strides dks, Strides dvs) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::a_off);
  T* Vs = reinterpret_cast<T*>(smem + L::b_off);
  T* Qs = reinterpret_cast<T*>(smem + L::x_off);
  T* Gs = reinterpret_cast<T*>(smem + L::y_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::stat_off);   // * log2(e)
  float* dlt_s = lse_s + BT;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = lane / 2;
  const int half = lane % 2;
  const int ki = k0 + warp * 16 + wrow;       // this lane's key
  const float sl2 = scale * LOG2E;

  const T* qbase = q + b * qs.b + h * qs.h;
  const T* gbase = dout + b * gs.b + h * gs.h;
  load_tile<T, D>(Ks, k + b * ks.b + h * ks.h, ks.s, k0, S);
  load_tile<T, D>(Vs, v + b * vs.b + h * vs.h, vs.s, k0, S);

  T* Pw = Ps + warp * 16 * L::LDP;
  float* Sw = nullptr;
  if constexpr (L::WMMA)
    Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
  const T* Kw = Ks + warp * 16 * L::LD;
  const T* Vw = Vs + warp * 16 * L::LD;

  Acc<T, D> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();
    load_tile<T, D>(Qs, qbase, qs.s, q0, S);
    load_tile<T, D>(Gs, gbase, gs.s, q0, S);
    if (threadIdx.x < BT) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < S ? lse[(int64_t)bh * S + qi] * LOG2E : 0.f;
      dlt_s[threadIdx.x] = qi < S ? delta[(int64_t)bh * S + qi] : 0.f;
    }
    __syncthreads();

    float st[32], ds[32];
    tile_scores<T, D>(Kw, Qs, Sw, wrow, half, st);     // (Q K^T)^T = K Q^T
    tile_scores<T, D>(Vw, Gs, Sw, wrow, half, ds);     // (dO V^T)^T = V dO^T
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool valid = q0 + c < S;
      const float p = valid ? exp2f(st[j] * sl2 - lse_s[c]) : 0.f;
      Pw[wrow * L::LDP + c] = from_f32<T>(p);
      ds[j] = p * (ds[j] - dlt_s[c]) * scale;
    }
    __syncwarp();
    acc_dv.mma(Pw, Gs, wrow, half);                    // dV += P^T dO
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j)
      Pw[wrow * L::LDP + half * 32 + j] = from_f32<T>(ds[j]);
    __syncwarp();
    acc_dk.mma(Pw, Qs, wrow, half);                    // dK += dS^T Q
    __syncwarp();
  }

  const bool row_ok = ki < S;
  const int col = half * (D / 2);
  acc_dk.store(Sw, wrow, half,
               dk + b * dks.b + (int64_t)ki * dks.s + h * dks.h + col, row_ok);
  acc_dv.store(Sw, wrow, half,
               dv + b * dvs.b + (int64_t)ki * dvs.s + h * dvs.h + col, row_ok);
}

// ------------------------------------------------------------- launchers ---

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, float scale,
                      const long long* st, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::bytes;
  static bool attr_set = false;   // per instantiation; one device per process
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, bytes, &attr_set);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int H, float scale,
                       const long long* st, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::bytes;
  static bool attr_set = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes, &attr_set);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BT - 1) / BT, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. strides: element strides (batch, seq,
// head) of q, k, v, dO and then the outputs, in that order (15 values for
// dQ; 18 for dK/dV: ..., dK, dV). Both return the cudaError_t of the launch
// (0 = success); an unsupported (dtype, D) returns cudaErrorInvalidValue
// without launching.
#define SUPERDIFF_DISPATCH(FN, ...)                                            \
  if (dtype == 0) {                                                            \
    if (D == 32) return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);               \
    if (D == 64) return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);               \
    if (D == 128) return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);             \
  } else if (dtype == 1) {                                                     \
    if (D == 32) return (int)FN<float, 32>(__VA_ARGS__);                       \
    if (D == 64) return (int)FN<float, 64>(__VA_ARGS__);                       \
    if (D == 128) return (int)FN<float, 128>(__VA_ARGS__);                     \
  }                                                                            \
  return (int)cudaErrorInvalidValue;

extern "C" int superdiff_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int S, int H, int D,
    int dtype, float scale, const long long* strides, void* stream) {
  SUPERDIFF_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, S, H, scale,
                     strides, static_cast<cudaStream_t>(stream))
}

extern "C" int superdiff_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int S,
    int H, int D, int dtype, float scale, const long long* strides,
    void* stream) {
  SUPERDIFF_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, S, H,
                     scale, strides, static_cast<cudaStream_t>(stream))
}
