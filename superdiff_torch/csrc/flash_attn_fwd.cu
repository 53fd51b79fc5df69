// Flash-attention forward for Hopper (sm_90a): non-causal multi-head
// attention with an online softmax, plus the per-row logsumexp.
//
// Replaces the TPU kernel superdiff_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward). Same function, not the same block structure:
// on the TPU the K axis is a sequential grid axis whose running max / sum /
// accumulator persist in VMEM scratch; here one thread block owns one
// (batch*head, 64-query tile) and loops over 64-key K/V tiles itself, with
// the running statistics in registers.
//
// Layout: q, k, v are read as (B, S, H, D) through the element strides the
// caller passes (the last dim must be contiguous), so the split views of a
// fused qkv projection go in without transpose copies. out is written as
// (B, S, H, D) through its strides; lse is (B*H, S) float32 with row
// b*H + h, the fold the TPU kernel uses.
//
// Numerics match the TPU kernel: scores and the running statistics are f32;
// P is rounded to the input dtype before P.V (bf16 on the sampling path);
// out = acc / l in the input dtype; lse = m + log(l) in f32.
//
// What bounds it on this card: at the sampling path's main shape
// (S=1024, D=32) each score costs 4*D = 128 tensor-core flops but one
// exponential, and the SFU issues 16 exponentials per clock per SM against
// 1024 dense bf16 flops per clock per SM, so the exponentials, not the
// matrix units or the 16.8 MB of q/k/v/out traffic, set the floor. The
// design keeps the matrix products on the tensor cores (nvcuda::wmma bf16
// 16x16x16 fragments, f32 accumulate) and does one exp2 per score with the
// log2(e) factor folded into the score scale. The f32 variant (used by the
// parity checks, not by the sampling path) does both products with plain
// FMA loops. K/V tiles are staged in shared memory with 16-byte loads; no
// cp.async/TMA pipelining or wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = 4;     // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;   // finite "minus infinity" (as the TPU kernel)

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int PAD = 8; };  // 16 B
template <> struct Cfg<float> { static constexpr int PAD = 4; };          // 16 B

__host__ __device__ constexpr int align32(int bytes) { return (bytes + 31) & ~31; }

template <typename T, int D>
struct Smem {
  static constexpr int LD = D + Cfg<T>::PAD;          // q/k/v row stride (elems)
  static constexpr int LDP = BK + Cfg<T>::PAD;        // P row stride (elems)
  static constexpr int LDS = (BK > D ? BK : D) + 4;   // f32 scratch stride
  static constexpr bool WMMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + align32(BQ * LD * (int)sizeof(T));
  static constexpr int v_off = k_off + align32(BK * LD * (int)sizeof(T));
  static constexpr int p_off = v_off + align32(BK * LD * (int)sizeof(T));
  static constexpr int s_off = p_off + align32(NWARPS * 16 * LDP * (int)sizeof(T));
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

// Copy a (rows x D) tile of one (b, h) slice into shared memory with 16-byte
// vectors; rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t s_stride,
                                          int row0, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                 // vectors per row
  constexpr int LD = Smem<T, D>::LD;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, float scale,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = lane / 2;                  // row within the warp's 16
  const int half = lane % 2;                  // which half of the columns
  const int row = warp * 16 + wrow;           // row within the block's 64
  const float sl2 = scale * LOG2E;            // scores in the log2 domain

  const T* qbase = q + b * q_sb + h * q_sh;
  const T* kbase = k + b * k_sb + h * k_sh;
  const T* vbase = v + b * v_sb + h * v_sh;

  load_tile<T, D>(Qs, qbase, q_ss, q0, S);
  __syncthreads();

  constexpr int DH = D / 2;                   // output columns per lane
  float acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = NEG_BIG, l = 0.f;                 // running max (log2 units), sum

  T* Pw = Ps + warp * 16 * L::LDP;
  float* Sw = nullptr;

  using namespace nvcuda;
  // The warp's 16 query rows as bf16 A fragments, loaded once.
  constexpr int NKF = L::WMMA ? D / 16 : 1;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[NKF];
  if constexpr (L::WMMA) {
    Sw = reinterpret_cast<float*>(smem + L::s_off) + warp * 16 * L::LDS;
#pragma unroll
    for (int kt = 0; kt < NKF; ++kt)
      wmma::load_matrix_sync(qa[kt],
                             reinterpret_cast<const __nv_bfloat16*>(Qs) +
                                 (warp * 16) * L::LD + kt * 16,
                             L::LD);
  }

  for (int kv0 = 0; kv0 < S; kv0 += BK) {
    __syncthreads();                          // previous tile fully consumed
    load_tile<T, D>(Ks, kbase, k_ss, kv0, S);
    load_tile<T, D>(Vs, vbase, v_ss, kv0, S);
    __syncthreads();

    // ---- scores for this lane's row, columns half*32 .. half*32+31
    float s[32];
    if constexpr (L::WMMA) {
#pragma unroll
      for (int nt = 0; nt < BK / 16; ++nt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kt = 0; kt < NKF; ++kt) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb,
                                 reinterpret_cast<const __nv_bfloat16*>(Ks) +
                                     (nt * 16) * L::LD + kt * 16,
                                 L::LD);
          wmma::mma_sync(c, qa[kt], kb, c);
        }
        wmma::store_matrix_sync(Sw + nt * 16, c, L::LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = Sw[wrow * L::LDS + half * 32 + j];
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      const T* qrow = Qs + row * L::LD;
      for (int d = 0; d < D; ++d) {
        const float qd = to_f32(qrow[d]);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          s[j] = fmaf(qd, to_f32(Ks[(half * 32 + j) * L::LD + d]), s[j]);
      }
    }

    // ---- online softmax (log2 domain), ragged last tile masked
    float mx = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool valid = kv0 + half * 32 + j < S;
      s[j] = valid ? s[j] * sl2 : NEG_BIG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = exp2f(s[j] - m_new);
      rs += p;
      Pw[wrow * L::LDP + half * 32 + j] = from_f32<T>(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = alpha * l + rs;
    m = m_new;
    __syncwarp();

    // ---- acc = acc * alpha + P . V  (P already rounded to T)
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
    if constexpr (L::WMMA) {
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
          wmma::load_matrix_sync(pa, reinterpret_cast<const __nv_bfloat16*>(Pw) + kt * 16,
                                 L::LDP);
          wmma::load_matrix_sync(vb,
                                 reinterpret_cast<const __nv_bfloat16*>(Vs) +
                                     (kt * 16) * L::LD + dt * 16,
                                 L::LD);
          wmma::mma_sync(c, pa, vb, c);
        }
        wmma::store_matrix_sync(Sw + dt * 16, c, L::LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] += Sw[wrow * L::LDS + half * DH + i];
    } else {
      const T* prow = Pw + wrow * L::LDP;
      for (int c = 0; c < BK; ++c) {
        const float p = to_f32(prow[c]);
        const T* vrow = Vs + c * L::LD + half * DH;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] = fmaf(p, to_f32(vrow[i]), acc[i]);
      }
    }
    __syncwarp();   // Sw / Pw are rewritten by the next tile
  }

  const int qi = q0 + row;
  if (qi < S) {
    const float inv_l = 1.f / l;
    T* orow = out + b * o_sb + (int64_t)qi * o_ss + h * o_sh + half * DH;
#pragma unroll
    for (int i = 0; i < DH; ++i) orow[i] = from_f32<T>(acc[i] * inv_l);
    if (half == 0) lse[(int64_t)bh * S + qi] = m * LN2 + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int H, float scale,
                   const long long* st, cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::bytes;
  static bool attr_set = false;   // per instantiation; one device per process
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. strides: 12 element strides, (batch,
// seq, head) for q, k, v, out in that order. Returns the cudaError_t of the
// launch (0 = success); an unsupported (dtype, D) returns
// cudaErrorInvalidValue without launching.
extern "C" int superdiff_flash_attn_fwd(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int B, int S, int H, int D, int dtype,
                                        float scale, const long long* strides,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SUPERDIFF_CASE(T, DD)                                                   \
  if (D == DD) return (int)launch<T, DD>(q, k, v, out, lse, B, S, H, scale,   \
                                         strides, st);
  if (dtype == 0) {
    SUPERDIFF_CASE(__nv_bfloat16, 32)
    SUPERDIFF_CASE(__nv_bfloat16, 64)
    SUPERDIFF_CASE(__nv_bfloat16, 128)
  } else if (dtype == 1) {
    SUPERDIFF_CASE(float, 32)
    SUPERDIFF_CASE(float, 64)
    SUPERDIFF_CASE(float, 128)
  }
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}
