// Flash-attention forward for Hopper (sm_90a): non-causal multi-head
// attention with an online softmax, plus the per-row logsumexp.
//
// Replaces the TPU kernel superdiff_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward). Same function, not the same block structure:
// the TPU kernel holds a whole S=1024 K/V in VMEM, so its online rescale
// never runs; here a block owns one (batch*head, query tile) and streams
// K/V through a two-stage shared-memory ring, with the running max, sum and
// output in registers.
//
// Layout: q is read as (B, S, H, D) and k, v as (B, Skv, H, D) through the
// element strides the caller passes (last dim contiguous, rows 16-byte
// aligned), so the split views of a fused qkv projection go in without
// transpose copies. Skv = S is self-attention; cross-attention (Stable
// Diffusion's 77 text tokens against S up to 4096 latent positions) has keys
// and values of a length of their own, and only the K/V loop reads Skv: its
// tile count, its loads and the mask of its partial last tile. out is
// written as (B, S, H, D) through its strides; lse is (B*H, S) float32 with
// row b*H + h, the layout the backward kernels read.
//
// Numerics match the TPU kernel: scores and the running statistics are f32;
// P is rounded to the input dtype before P.V (bf16 on the sampling and
// training paths); out = acc / l rounded once; lse = m*ln2 + log(l) in f32.
// One exp2 per score (ex2.approx.ftz, one MUFU.EX2), with log2(e) folded
// into the score scale. No float atomics: a rerun gives the same bits.
//
// What bounds it on the card, per wide256 path shape (B=16, H=4; PERF.md):
// - S=1024, D=32: operations. 67 M exponentials at ~15 per clock per SM
//   (~16 us) and 8.6 GFLOP of mma.sync, which reaches ~600 TFLOP/s on this
//   card (~14 us), against 16.8 MB of q/k/v/out (5 us). Scores, P and the
//   output accumulator never leave registers: mma.sync m16n8k16, and the
//   m16n8 accumulator of QK^T is re-packed in registers as the bf16 A
//   operand of P.V. A warp owns MT = 2 m-tiles (32 query rows), so every K
//   and V fragment it loads by ldmatrix serves two m-tiles, and a block of
//   8 warps owns 256 query rows, so K and V are read from L2 four times per
//   head instead of sixteen. What is left between the kernel and the two
//   floors is the serial chain inside a warp (mma -> row max -> quad
//   shuffles -> exp -> mma) with 4 warps per scheduler: the per-phase clock
//   profile and ablations (no exp, no loads) each moved it by <20 %.
// - S=256 and S=64, D=64: latency (8.4 and 2.1 MB, a few tiles per warp).
//   The next K/V tile's cp.async overlaps the current tile's math (one
//   __syncthreads per tile); the query tile is as tall as S allows (fewer,
//   fuller blocks measured faster than a grid cut to fill all 132 SMs).
//
// Structure: a warp owns 16 * MT query rows (the block's warps and MT are
// chosen at launch by ops/flash_attention.py::_fwd_geometry; MT and BK keys
// per K/V tile are template arguments). Grid: x = batch*head, y = query
// tiles. Q, K and V tiles are staged by cp.async.cg (16 B, zero-filled past
// S); their shared-memory rows are padded by 16 bytes, which makes the row
// stride an odd number of 16-byte units, so the 8 row addresses of every
// ldmatrix phase fall in 8 distinct bank groups (no conflicts, no swizzle).
// The warp's Q fragments are loaded once by ldmatrix, K by ldmatrix as the
// B operand, V by ldmatrix.trans. The output goes out through the warp's
// own Q rows in shared memory as 16-byte stores.
//
// The f32 instantiation (parity checks only; off the sampling and training
// paths) shares the structure, the ring and the softmax, but computes both
// products with f32 FMA loops in the same register layout (P goes through a
// per-warp shared buffer for P.V): no TF32, f32 numerics as before.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int MAX_WARPS = 8;              // warps per block
constexpr int STAGES = 2;                 // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;         // finite "minus infinity" (as the TPU kernel)

// Shared-memory layout, mirrored by ops/flash_attention.py::_fwd_smem_bytes:
// [Q tile: 16 * MT * warps rows][STAGES x (K tile, V tile): BK rows each]
// [f32 only: P, 16 x (BK + 4) floats per warp]; every row padded by 16 B.
template <typename T, int D, int BK, int MT>
struct Layout {
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = D + 16 / (int)sizeof(T);   // row stride, elements
  static constexpr int ROW = LD * (int)sizeof(T);      // row stride, bytes
  static constexpr int TILE = BK * ROW;                // one K or V tile
  static constexpr int LDP = BK + 4;                   // f32 P row stride
  static constexpr int P_WARP = MMA ? 0 : 16 * LDP * 4;
  __host__ __device__ static constexpr int kv_off(int warps) {
    return 16 * MT * warps * ROW;
  }
  __host__ __device__ static constexpr int p_off(int warps) {
    return kv_off(warps) + STAGES * 2 * TILE;
  }
  __host__ __device__ static constexpr int bytes(int warps) {
    return p_off(warps) + warps * P_WARP;
  }
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the slot.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Stage `rows` rows of one (b, h) slice, starting at sequence row row0, into
// shared memory (row stride LD) with 16-byte cp.async; rows at or past S are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const T* src,
                                                int64_t s_stride, int row0,
                                                int rows, int S) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                          // 16 B chunks per row
  constexpr int ROW = (D + VEC) * (int)sizeof(T);
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i % VPR;
    const bool in = row0 + r < S;
    const T* g = in ? src + (int64_t)(row0 + r) * s_stride + c * VEC : src;
    cp_async16(dst + r * ROW + c * 16, g, in ? 16 : 0);
  }
}

// ------------------------------------------------------------------ kernel

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int S, Skv, H;
  float scale;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
};

// Lane layout (the mma.sync m16n8 accumulator, used by both dtypes): for
// each of the warp's MT 16-row m-tiles, a lane holds rows g = lane/4 and
// g + 8, and for each 8-column tile n the columns 8n + 2c, 8n + 2c + 1
// (c = lane % 4): s[mt][n][0..1] on row g, s[mt][n][2..3] on row g + 8. The
// output accumulator o[mt][j] has the same shape over 8-column tiles of D.
// Every K and V fragment a warp loads serves its MT m-tiles.
template <typename T, int D, int BK, int MT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_fwd_kernel(const Args a) {
  using L = Layout<T, D, BK, MT>;
  static_assert(L::MMA || MT == 1, "the f32 FMA variant has one m-tile");
  constexpr int NT = BK / 8;                  // 8-key score tiles
  constexpr int DT = D / 8;                   // 8-column output tiles
  constexpr int WR = 16 * MT;                 // query rows per warp
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int warps = blockDim.x / 32;
  const int S = a.S, Skv = a.Skv;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * WR * warps;
  const float sl2 = a.scale * LOG2E;          // scores in the log2 domain

  const T* qbase = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kbase = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_kv = s_base + L::kv_off(warps);
  T* Qw = reinterpret_cast<T*>(smem) + warp * WR * L::LD;   // this warp's rows

  // Q and tile 0 of K and V: one commit group
  load_rows_async<T, D>(s_base, qbase, a.q_ss, q0, WR * warps, S);
  load_rows_async<T, D>(s_kv, kbase, a.k_ss, 0, BK, Skv);
  load_rows_async<T, D>(s_kv + L::TILE, vbase, a.v_ss, 0, BK, Skv);
  cp_async_commit();
  const int ntiles = (Skv + BK - 1) / BK;

  float o[MT][DT][4];
  float m[MT][2], l[MT][2];   // running max (log2 units); lane-partial sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = NEG_BIG;
    l[mt][0] = l[mt][1] = 0.f;
  }

  constexpr int QF = L::MMA ? D / 16 : 1;
  uint32_t qf[MT][QF][4];                     // the warp's Q as A fragments

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BK;
    cp_async_wait_all();
    __syncthreads();      // tile t landed for all; tile t-1 fully consumed
    if (t + 1 < ntiles) { // prefetch tile t+1 into tile t-1's stage
      const uint32_t dst = s_kv + ((t + 1) % STAGES) * 2 * L::TILE;
      load_rows_async<T, D>(dst, kbase, a.k_ss, kv0 + BK, BK, Skv);
      load_rows_async<T, D>(dst + L::TILE, vbase, a.v_ss, kv0 + BK, BK, Skv);
      cp_async_commit();
    }
    const uint32_t sk = s_kv + (t % STAGES) * 2 * L::TILE;
    const uint32_t sv = sk + L::TILE;

    // ---- S = Q K^T for the warp's rows x BK keys, f32
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    if constexpr (L::MMA) {
      if (t == 0) {
        // lanes 0-15 address rows 0-15 at column 0, lanes 16-31 at column 8
        const uint32_t qa = smem_addr(Qw) + (lane & 15) * L::ROW + (lane >> 4) * 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < QF; ++kk)
            ldsm_x4(qa + mt * 16 * L::ROW + kk * 32, qf[mt][kk]);
      }
      // K as the B operand: one x4 covers two 8-key tiles x 16 of D
      const uint32_t ka = sk + ((lane & 7) + ((lane >> 4) << 3)) * L::ROW +
                          ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(ka + np * 16 * L::ROW + kk * 32, kb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt][kk], kb[0], kb[1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt][kk], kb[2], kb[3]);
          }
        }
      }
    } else {
      const T* Kt = reinterpret_cast<const T*>(smem + (sk - s_base));
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = Qw[g * L::LD + d], qb = Qw[(g + 8) * L::LD + d];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float ka = Kt[(8 * n + 2 * c) * L::LD + d];
          const float kb = Kt[(8 * n + 2 * c + 1) * L::LD + d];
          s[0][n][0] = fmaf(qa, ka, s[0][n][0]);
          s[0][n][1] = fmaf(qa, kb, s[0][n][1]);
          s[0][n][2] = fmaf(qb, ka, s[0][n][2]);
          s[0][n][3] = fmaf(qb, kb, s[0][n][3]);
        }
      }
    }

    // ---- ragged last tile: keys past Skv get the finite -1e30 (exp2 of it
    // is 0, so they add nothing to the row's sum or output)
    if (kv0 + BK > Skv) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + 8 * n + 2 * c + (e & 1) >= Skv) s[mt][n][e] = NEG_BIG;
    }

    // ---- online softmax in the log2 domain, per row: the max of the raw
    // scores times sl2 > 0 is the max of the scaled ones; max and sum are
    // trees over the lane's columns, then the quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2][NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0][n] = fmaxf(s[mt][n][0], s[mt][n][1]);
        mx[1][n] = fmaxf(s[mt][n][2], s[mt][n][3]);
      }
#pragma unroll
      for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          mx[0][i] = fmaxf(mx[0][i], mx[0][i + w]);
          mx[1][i] = fmaxf(mx[1][i], mx[1][i + w]);
        }
      float al[2], mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r][0] = fmaxf(mx[r][0], __shfl_xor_sync(0xffffffffu, mx[r][0], 1));
        mx[r][0] = fmaxf(mx[r][0], __shfl_xor_sync(0xffffffffu, mx[r][0], 2));
        mn[r] = fmaxf(m[mt][r], mx[r][0] * sl2);
        al[r] = ex2(m[mt][r] - mn[r]);
        m[mt][r] = mn[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[mt][j][0] *= al[0];
        o[mt][j][1] *= al[0];
        o[mt][j][2] *= al[1];
        o[mt][j][3] *= al[1];
      }
      float rs[2][NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[mt][n][0] = ex2(fmaf(s[mt][n][0], sl2, -mn[0]));
        s[mt][n][1] = ex2(fmaf(s[mt][n][1], sl2, -mn[0]));
        s[mt][n][2] = ex2(fmaf(s[mt][n][2], sl2, -mn[1]));
        s[mt][n][3] = ex2(fmaf(s[mt][n][3], sl2, -mn[1]));
        rs[0][n] = s[mt][n][0] + s[mt][n][1];
        rs[1][n] = s[mt][n][2] + s[mt][n][3];
      }
#pragma unroll
      for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) {
          rs[0][i] += rs[0][i + w];
          rs[1][i] += rs[1][i + w];
        }
      l[mt][0] = fmaf(l[mt][0], al[0], rs[0][0]);
      l[mt][1] = fmaf(l[mt][1], al[1], rs[1][0]);
    }

    // ---- o += P . V, P rounded to T
    if constexpr (L::MMA) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // the accumulators of score tiles 2kk, 2kk+1 are the A operand of
        // keys 16kk .. 16kk+15
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
        // V as the B operand through ldmatrix.trans: one x4 covers 16 keys
        // x two 8-column tiles of D
        const uint32_t va = sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::ROW +
                            (lane >> 4) * 16;
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(va + dp * 32, vb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
            mma_bf16(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    } else {
      float* Pw = reinterpret_cast<float*>(smem + L::p_off(warps)) + warp * 16 * L::LDP;
      const T* Vt = reinterpret_cast<const T*>(smem + (sv - s_base));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        Pw[g * L::LDP + 8 * n + 2 * c] = s[0][n][0];
        Pw[g * L::LDP + 8 * n + 2 * c + 1] = s[0][n][1];
        Pw[(g + 8) * L::LDP + 8 * n + 2 * c] = s[0][n][2];
        Pw[(g + 8) * L::LDP + 8 * n + 2 * c + 1] = s[0][n][3];
      }
      __syncwarp();
#pragma unroll 4
      for (int key = 0; key < BK; ++key) {
        const float pa = Pw[g * L::LDP + key], pb = Pw[(g + 8) * L::LDP + key];
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const float2 vv = *reinterpret_cast<const float2*>(
              Vt + key * L::LD + 8 * j + 2 * c);
          o[0][j][0] = fmaf(pa, vv.x, o[0][j][0]);
          o[0][j][1] = fmaf(pa, vv.y, o[0][j][1]);
          o[0][j][2] = fmaf(pb, vv.x, o[0][j][2]);
          o[0][j][3] = fmaf(pb, vv.y, o[0][j][3]);
        }
      }
      __syncwarp();       // Pw is rewritten by the next tile
    }
  }

  // ---- epilogue: full row sums, out = o / l through the warp's Q rows
  __syncwarp();           // all lanes done reading Qw (f32 path)
  const int r0 = q0 + warp * WR;
  float* lrow = a.lse + (int64_t)bh * S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      inv[r] = 1.f / l[mt][r];
      const int qi = r0 + mt * 16 + g + 8 * r;
      if (c == 0 && qi < S) lrow[qi] = m[mt][r] * LN2 + logf(l[mt][r]);
    }
    T* orow = Qw + (mt * 16 + g) * L::LD + 2 * c;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      store2(orow + 8 * j, o[mt][j][0] * inv[0], o[mt][j][1] * inv[0]);
      store2(orow + 8 * L::LD + 8 * j, o[mt][j][2] * inv[1], o[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  T* obase = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int i = lane; i < WR * VPR; i += 32) {
    const int r = i / VPR, cc = (i % VPR) * VEC;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(obase + (int64_t)(r0 + r) * a.o_ss + cc) =
          *reinterpret_cast<const uint4*>(Qw + r * L::LD + cc);
  }
}

// Allow the largest block's dynamic shared memory once per instantiation
// (one device per process); every layout fits in the 227 KB a block may use.
template <typename T, int D, int BK, int MT>
cudaError_t allow_smem() {
  using L = Layout<T, D, BK, MT>;
  static_assert(L::bytes(MAX_WARPS) <= 232448, "shared memory");
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BK, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(MAX_WARPS));
  done = e == cudaSuccess;
  return e;
}

template <typename T, int D, int BK, int MT>
cudaError_t launch(const Args& a, int B, int warps, cudaStream_t stream) {
  cudaError_t e = allow_smem<T, D, BK, MT>();
  if (e != cudaSuccess) return e;
  const int bq = 16 * MT * warps;
  dim3 grid(B * a.H, (a.S + bq - 1) / bq);
  flash_fwd_kernel<T, D, BK, MT>
      <<<grid, warps * 32, Layout<T, D, BK, MT>::bytes(warps), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, int BK, int MT>
cudaError_t info(int warps, int* res) {
  cudaError_t e = allow_smem<T, D, BK, MT>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, flash_fwd_kernel<T, D, BK, MT>);
  if (e != cudaSuccess) return e;
  const int bytes = Layout<T, D, BK, MT>::bytes(warps);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_kernel<T, D, BK, MT>, warps * 32, bytes);
  if (e != cudaSuccess) return e;
  res[0] = bytes;
  res[1] = attr.numRegs;
  res[2] = (int)attr.localSizeBytes;
  res[3] = blocks;
  return cudaSuccess;
}

}  // namespace

// The instantiations: (dtype code, type, D, BK, MT). dtype: 0 = bfloat16,
// 1 = float32. The launch geometry takes one (BK, MT) per dtype and D,
// mirrored by ops/flash_attention.py::_FWD_TILE. A build with
// -DSUPERDIFF_FWD_SWEEP adds the other tiles that
// tools/tune_flash_fwd.py --sweep measures (it reads them from
// SUPERDIFF_FWD_CASES here).
#define SUPERDIFF_FWD_TILES(X)                                                \
  X(0, __nv_bfloat16, 32, 32, 2) X(0, __nv_bfloat16, 64, 64, 1)               \
  X(0, __nv_bfloat16, 128, 64, 1)                                             \
  X(1, float, 32, 64, 1) X(1, float, 64, 64, 1) X(1, float, 128, 32, 1)
#ifdef SUPERDIFF_FWD_SWEEP
#define SUPERDIFF_FWD_CASES(X)                                                \
  SUPERDIFF_FWD_TILES(X)                                                      \
  X(0, __nv_bfloat16, 32, 32, 1) X(0, __nv_bfloat16, 32, 64, 1)               \
  X(0, __nv_bfloat16, 32, 64, 2) X(0, __nv_bfloat16, 32, 32, 4)               \
  X(0, __nv_bfloat16, 64, 32, 1) X(0, __nv_bfloat16, 64, 32, 2)               \
  X(0, __nv_bfloat16, 64, 64, 2) X(0, __nv_bfloat16, 128, 32, 1)
#else
#define SUPERDIFF_FWD_CASES(X) SUPERDIFF_FWD_TILES(X)
#endif

// S: query (and output) rows; Skv: key and value rows. strides: 12 element
// strides, (batch, seq, head) for q, k, v, out in that order. Geometry: warps (1..8) per block, each owning 16 * mt query rows;
// bk keys per K/V tile. Returns the cudaError_t of the launch (0 =
// success); a geometry that is not built returns cudaErrorInvalidValue
// without launching.
extern "C" int superdiff_flash_attn_fwd(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int B, int S, int Skv, int H, int D,
                                        int dtype,
                                        float scale, const long long* st,
                                        int warps, int bk, int mt,
                                        void* stream) {
  if (warps < 1 || warps > MAX_WARPS || Skv < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, S, Skv, H, scale, st[0], st[1], st[2], st[3],
               st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUPERDIFF_CASE(DT, T, DD, BKK, MTT)                       \
  if (dtype == DT && D == DD && bk == BKK && mt == MTT)           \
    return (int)launch<T, DD, BKK, MTT>(a, B, warps, s);
  SUPERDIFF_FWD_CASES(SUPERDIFF_CASE)
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the occupancy calculator say of one instantiation at
// `warps` warps per block: res = {dynamic shared bytes, registers per thread,
// local (spill) bytes per thread, resident blocks per SM}.
extern "C" int superdiff_flash_attn_fwd_info(int D, int dtype, int warps,
                                             int bk, int mt, int* res) {
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
#define SUPERDIFF_CASE(DT, T, DD, BKK, MTT)                       \
  if (dtype == DT && D == DD && bk == BKK && mt == MTT)           \
    return (int)info<T, DD, BKK, MTT>(warps, res);
  SUPERDIFF_FWD_CASES(SUPERDIFF_CASE)
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}
