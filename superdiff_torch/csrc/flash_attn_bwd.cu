// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV,
// that recompute the probabilities from the forward's logsumexp.
//
// Replaces the TPU kernels superdiff_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (launched by
// _flash_backward). Same functions, not the same block structure: on the TPU
// the reduction axis is a sequential innermost grid axis whose f32
// accumulator (dq_scr, dk_scr/dv_scr) persists in VMEM scratch. Here blocks
// run in no order, so each block owns its output rows and loops itself:
//
//   dQ   : a block owns 16 * MT * warps queries of one (batch*head) and
//          loops over tiles of BT keys:
//          S  = Q K^T * scale          P  = exp(S - lse)
//          dP = dO V^T                 dS = P o (dP - delta) * scale
//          dQ += dS K
//   dK/dV: a block owns 16 * MT * warps keys and loops over tiles of BT
//          queries, forming the transposed tiles directly,
//          S^T = K Q^T, dP^T = V dO^T, so every product has the warp's own
//          rows as its A operand:
//          dV += P^T dO                dK += dS^T Q
//
// Each output element is written exactly once by the block that owns it: no
// floating-point atomics, so the backward is deterministic run to run. (A
// single pass that adds dQ with atomics would recompute the exponentials
// once instead of twice, but its bits would change from run to run.)
//
// Layout: q, k, v, dO are read and dQ, dK, dV written as (B, S, H, D)
// through the element strides the caller passes (last dim contiguous, rows
// 16-byte aligned), so the split views of a fused qkv projection need no
// transpose copies. lse and delta = rowsum(dO o O) are (B*H, S) float32,
// row b*H + h.
//
// Numerics match the TPU kernels: scores, P, dP and the accumulators are
// f32; P is rounded to the input dtype before P^T dO, dS is rounded to the
// input dtype before dS K and dS^T Q; outputs are cast once at the end. One
// exp2 per score (ex2.approx.ftz, one MUFU.EX2), log2(e) folded in.
//
// What bounds them on this card, per wide256 path shape (B=16, H=4;
// measured on the H100, PERF.md):
// - S=1024, D=32: operations. Per score dQ does three products and dK/dV
//   four (2*D flops each) against one exponential: the floors are the SFU's
//   exponentials (~16 us for each kernel) and the tensor cores (~13 us for
//   dQ, ~17 us for dK/dV). The kernels take ~0.048 and ~0.059 ms, a third of
//   that, together ~0.94x SDPA's whole backward: as in the forward kernel,
//   the serial chain inside a warp (mma -> exp -> dS -> re-pack -> mma)
//   binds, with 8 to 16 warps per SM. dQ holds itself to 128 registers so
//   that two 8-warp blocks share an SM (Policy below); dK/dV keeps 255 for
//   its two D-wide accumulators and one block per SM.
// - S=256 and S=64, D=64: latency (8.4 and 2.1 MB moved; 2 and 1 looped
//   tiles per warp). The row tile is as tall as S allows, the looped tile
//   the tallest built one that S fills (128 rows at S=256, 64 at S=64; the
//   geometry), and the next tile's copy overlaps the current tile's math.
// The design is the forward kernel's (csrc/flash_attn_fwd.cu):
// - every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), and no
//   score, P or dS tile touches shared memory: the m16n8 accumulators of
//   S and dP become P and dS in registers and are re-packed
//   (cvt.rn.bf16x2) as the A operand of the next product;
// - the warp's own rows (Q and dO for dQ; K and V for dK/dV) are loaded as
//   A fragments once, by ldmatrix, and stay in registers across the loop
//   (dK/dV at D * MT > 64 re-reads them from shared memory per use: two
//   D-wide f32 accumulators already hold the registers); dQ keeps its rows'
//   lse and delta in registers, dK/dV takes the looped queries' lse and
//   delta with each tile;
// - the looped tiles stream through a two-stage cp.async.cg ring (16 B,
//   zero-filled past S; the statistics by 4-byte cp.async), so the next
//   tile's copy overlaps the current tile's math (one __syncthreads per
//   tile); rows are padded by 16 bytes, an odd number of 16-byte units, so
//   the 8 row addresses of every ldmatrix phase fall in 8 distinct bank
//   groups (no conflicts, no swizzle);
// - the looped tile is taken 16 rows at a time, so the live S and dP
//   accumulators are 16 columns wide whatever BT is;
// - a warp owns MT m-tiles, so every B fragment it loads serves MT products;
//   warps and (BT, MT) are chosen at launch by
//   ops/flash_attention.py::_bwd_geometry (measured by
//   tools/tune_flash_bwd.py);
// - the result leaves through the warp's own rows in shared memory as
//   16-byte stores.
//
// The f32 instantiation (parity checks only; off the training path) shares
// the structure, the ring and the register layout, but computes every
// product with f32 FMA loops (no TF32); P and dS go through a per-warp
// shared buffer for their products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int MAX_WARPS = 8;              // warps per block
constexpr int STAGES = 2;                 // looped-tile ring depth
constexpr float LOG2E = 1.4426950408889634f;
enum Kernel { DQ = 0, DKV = 1 };
// How each kernel is compiled, by kernel and D (measured with
// tools/tune_flash_bwd.py against builds of this source with the other
// constants; PERF.md): the unroll of the loop over a tile's
// 16-row chunks (0: all of them) and the resident 8-warp blocks per SM that
// the compiler must leave registers for (2 caps them at 128). dQ at D=32
// steps one chunk at a time within 128 registers, so two 8-warp blocks
// share an SM: 12 % faster than unrolled at 247 registers. dK/dV at D=32
// and both at D=64 unroll fully (held to 128 registers they spill or lose
// the overlap of chunks); at D=128 one chunk at a time, or the live
// fragments pass 255 registers.
template <int KERN, int D>
struct Policy {
  static constexpr int CHUNK_UNROLL = D > 64 || (KERN == DQ && D == 32) ? 1 : 0;
  static constexpr int MIN_BLOCKS = KERN == DQ && D == 32 ? 2 : 1;
};

// Shared-memory layout, mirrored by ops/flash_attention.py::_bwd_smem_bytes:
// [owned tile 1][owned tile 2]: 16 * MT * warps rows each (Q, dO | K, V)
// [STAGES x (looped tile 1, looped tile 2: BT rows each (K, V | Q, dO);
//            dK/dV only: BT lse and BT delta floats)]
// [f32 only: P / dS, 16 x LDP floats per warp]; every row padded by 16 B.
template <int KERN, typename T, int D, int BT, int MT>
struct Layout {
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LD = D + 16 / (int)sizeof(T);   // row stride, elements
  static constexpr int ROW = LD * (int)sizeof(T);      // row stride, bytes
  static constexpr int TILE = BT * ROW;                // one looped tile
  static constexpr int STAGE = 2 * TILE + (KERN == DKV ? 2 * BT * 4 : 0);
  static constexpr int LDP = 16 + 4;                   // f32 P / dS row stride
  static constexpr int P_WARP = MMA ? 0 : 16 * LDP * 4;
  __host__ __device__ static constexpr int own(int warps) {
    return 16 * MT * warps * ROW;
  }
  __host__ __device__ static constexpr int ring_off(int warps) {
    return 2 * own(warps);
  }
  __host__ __device__ static constexpr int p_off(int warps) {
    return ring_off(warps) + STAGES * STAGE;
  }
  __host__ __device__ static constexpr int bytes(int warps) {
    return p_off(warps) + warps * P_WARP;
  }
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Async copies global -> shared; src_bytes = 0 zero-fills the slot.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// The accumulators of two 8-column tiles as the A operand (16 x 16, the
// columns as k) of the next product, rounded to bf16.
__device__ __forceinline__ void pack_a(const float (&x)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Stage `rows` rows of one (b, h) slice, starting at sequence row row0, into
// shared memory (row stride D + 16 bytes) with 16-byte cp.async; rows at or
// past S are zero-filled.
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

// Stage `n` floats src[row0 .. row0 + n) with 4-byte cp.async; entries at or
// past S are zero-filled.
__device__ __forceinline__ void load_stats_async(uint32_t dst, const float* src,
                                                 int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = row0 + i < S;
    cp_async4(dst + 4 * i, in ? src + row0 + i : src, in ? 4 : 0);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;                     // dO
  const float* lse;
  const float* delta;
  void* out0;                        // dQ | dK
  void* out1;                        // unused | dV
  int S, H;
  float scale;
  int64_t st[18];                    // (batch, seq, head) of q, k, v, dO, out0, out1
};

template <typename T>
__device__ __forceinline__ const T* slice(const void* p, const int64_t* st,
                                          int b, int h) {
  return static_cast<const T*>(p) + b * st[0] + h * st[2];
}

// Lane layout (the mma.sync m16n8 accumulator, used by both dtypes): for
// each of the warp's MT 16-row m-tiles, a lane holds rows g = lane/4 and
// g + 8, and for each 8-column tile n the columns 8n + 2c, 8n + 2c + 1
// (c = lane % 4): x[mt][n][0..1] on row g, x[mt][n][2..3] on row g + 8.
//
// Per-lane ldmatrix offsets (bytes) within 16 rows of stride ROW:
// - A operand, rows x k (row-major): a_off, x4 -> the 16 x 16 block;
// - B operand stored n-major (k contiguous: K for Q K^T): bn_off, x4 ->
//   n-tiles 0 and 1 (8 rows each) x 16 of k;
// - B operand stored k-major (n contiguous: K for dS K): bk_off with .trans,
//   x4 -> 16 rows of k x n-tiles 0 and 1 (8 columns each).
template <int ROW>
struct Lane {
  uint32_t a_off, bn_off, bk_off;
  __device__ __forceinline__ explicit Lane(int lane)
      : a_off((lane & 15) * ROW + (lane >> 4) * 16),
        bn_off(((lane & 7) + ((lane >> 4) << 3)) * ROW + ((lane >> 3) & 1) * 16),
        bk_off(((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + (lane >> 4) * 16) {}
};

// acc += X (16 x 16 f32, row stride LDP: the warp's buffer) . Y (16 rows of
// stride LD, D columns): the f32 FMA product, in the accumulator layout.
template <typename T, int D, int LD, int LDP>
__device__ __forceinline__ void fma_buffer_product(float (&acc)[D / 8][4],
                                                   const float* X, const T* Y,
                                                   int g, int c) {
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const float xa = X[g * LDP + r], xb = X[(g + 8) * LDP + r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float ya = to_f32(Y[r * LD + 8 * j + 2 * c]);
      const float yb = to_f32(Y[r * LD + 8 * j + 2 * c + 1]);
      acc[j][0] = fmaf(xa, ya, acc[j][0]);
      acc[j][1] = fmaf(xa, yb, acc[j][1]);
      acc[j][2] = fmaf(xb, ya, acc[j][2]);
      acc[j][3] = fmaf(xb, yb, acc[j][3]);
    }
  }
}

// x[n][e] = sum_d A[row][d] . Y[col][d] for the lane's rows g, g + 8 of A
// (the warp's 16 rows) and columns 8n + 2c (+1) of Y's 16 rows: the f32 FMA
// version of A Y^T for one 16 x 16 block.
template <typename T, int D, int LD>
__device__ __forceinline__ void fma_scores(float (&x)[2][4], const T* A,
                                           const T* Y, int g, int c) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float aa = to_f32(A[g * LD + d]), ab = to_f32(A[(g + 8) * LD + d]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float y0 = to_f32(Y[(8 * n + 2 * c) * LD + d]);
      const float y1 = to_f32(Y[(8 * n + 2 * c + 1) * LD + d]);
      x[n][0] = fmaf(aa, y0, x[n][0]);
      x[n][1] = fmaf(aa, y1, x[n][1]);
      x[n][2] = fmaf(ab, y0, x[n][2]);
      x[n][3] = fmaf(ab, y1, x[n][3]);
    }
  }
}

// Write a 16 x 16 block in the accumulator layout to the warp's f32 buffer.
template <int LDP>
__device__ __forceinline__ void to_buffer(float* X, const float (&x)[2][4],
                                          int g, int c) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    X[g * LDP + 8 * n + 2 * c] = x[n][0];
    X[g * LDP + 8 * n + 2 * c + 1] = x[n][1];
    X[(g + 8) * LDP + 8 * n + 2 * c] = x[n][2];
    X[(g + 8) * LDP + 8 * n + 2 * c + 1] = x[n][3];
  }
}

// The warp's 16 * MT output rows: accumulators -> T in the warp's own rows
// of shared memory (`rows`, stride LD) -> 16-byte stores of rows < S.
template <typename T, int D, int MT, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][D / 8][4],
                                           T* rows, T* out, int64_t s_stride,
                                           int r0, int S, int lane) {
  const int g = lane / 4, c = lane % 4;
  __syncwarp();                 // every lane is done reading these rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    T* orow = rows + (mt * 16 + g) * LD + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(orow + 8 * j, acc[mt][j][0], acc[mt][j][1]);
      store2(orow + 8 * LD + 8 * j, acc[mt][j][2], acc[mt][j][3]);
    }
  }
  __syncwarp();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = lane; i < 16 * MT * VPR; i += 32) {
    const int r = i / VPR, cc = (i % VPR) * VEC;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(out + (int64_t)(r0 + r) * s_stride + cc) =
          *reinterpret_cast<const uint4*>(rows + r * LD + cc);
  }
}

template <int MT, int DT>
__device__ __forceinline__ void zero(float (&x)[MT][DT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mt][j][e] = 0.f;
}

// ------------------------------------------------------------------- dQ ---

template <typename T, int D, int BT, int MT>
__global__ void __launch_bounds__(MAX_WARPS * 32, (Policy<DQ, D>::MIN_BLOCKS))
flash_bwd_dq_kernel(const Args a) {
  using L = Layout<DQ, T, D, BT, MT>;
  using P = Policy<DQ, D>;
  static_assert(L::MMA || MT == 1, "the f32 FMA variant has one m-tile");
  static_assert(BT % 16 == 0 && D % 16 == 0, "tile shapes");
  constexpr int DT = D / 8;                   // 8-column tiles of D
  constexpr int DK = D / 16;                  // 16-deep k steps over D
  constexpr int WR = 16 * MT;                 // query rows per warp
  constexpr int KF = L::MMA ? DK : 1;
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int warps = blockDim.x / 32;
  const int S = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * WR * warps;
  const int r0 = q0 + warp * WR;              // the warp's first query
  const float sl2 = a.scale * LOG2E;          // scores in the log2 domain

  const T* qbase = slice<T>(a.q, a.st + 0, b, h);
  const T* kbase = slice<T>(a.k, a.st + 3, b, h);
  const T* vbase = slice<T>(a.v, a.st + 6, b, h);
  const T* gbase = slice<T>(a.g, a.st + 9, b, h);

  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_ring = s_base + L::ring_off(warps);
  T* Qw = reinterpret_cast<T*>(smem) + warp * WR * L::LD;   // the warp's rows
  T* Gw = reinterpret_cast<T*>(smem + L::own(warps)) + warp * WR * L::LD;
  const Lane<L::ROW> ln(lane);

  // Q, dO and tile 0 of K and V: one commit group
  load_rows_async<T, D>(s_base, qbase, a.st[1], q0, WR * warps, S);
  load_rows_async<T, D>(s_base + L::own(warps), gbase, a.st[10], q0, WR * warps, S);
  load_rows_async<T, D>(s_ring, kbase, a.st[4], 0, BT, S);
  load_rows_async<T, D>(s_ring + L::TILE, vbase, a.st[7], 0, BT, S);
  cp_async_commit();

  // the lane's rows' lse (log2 units) and delta, for the whole loop; rows
  // past S read 0 (their Q and dO are zero, their dQ is not written)
  float lse2[MT][2], dlt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + mt * 16 + g + 8 * r;
      const bool in = qi < S;
      lse2[mt][r] = in ? a.lse[(int64_t)bh * S + qi] * LOG2E : 0.f;
      dlt[mt][r] = in ? a.delta[(int64_t)bh * S + qi] : 0.f;
    }

  float dq[MT][DT][4];
  zero(dq);
  uint32_t qf[MT][KF][4], gf[MT][KF][4];      // the warp's Q, dO as A fragments
  float* Pw = reinterpret_cast<float*>(smem + L::p_off(warps)) + warp * 16 * L::LDP;
  const int ntiles = (S + BT - 1) / BT;

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BT;
    cp_async_wait_all();
    __syncthreads();      // tile t landed for all; tile t-1 fully consumed
    if (t + 1 < ntiles) { // prefetch tile t+1 into tile t-1's stage
      const uint32_t dst = s_ring + ((t + 1) % STAGES) * L::STAGE;
      load_rows_async<T, D>(dst, kbase, a.st[4], kv0 + BT, BT, S);
      load_rows_async<T, D>(dst + L::TILE, vbase, a.st[7], kv0 + BT, BT, S);
      cp_async_commit();
    }
    if constexpr (L::MMA) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kd = 0; kd < KF; ++kd) {
            const uint32_t off = mt * 16 * L::ROW + ln.a_off + kd * 32;
            ldsm_x4(smem_addr(Qw) + off, qf[mt][kd]);
            ldsm_x4(smem_addr(Gw) + off, gf[mt][kd]);
          }
      }
    }
    const uint32_t sk = s_ring + (t % STAGES) * L::STAGE;
    const uint32_t sv = sk + L::TILE;
    const bool ragged = kv0 + BT > S;

#pragma unroll (P::CHUNK_UNROLL ? P::CHUNK_UNROLL : BT / 16)
    for (int kk = 0; kk < BT / 16; ++kk) {    // 16 keys at a time
      const uint32_t sk16 = sk + kk * 16 * L::ROW, sv16 = sv + kk * 16 * L::ROW;
      // ---- S = Q K^T and dP = dO V^T for the warp's rows x 16 keys, f32
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
      if constexpr (L::MMA) {
#pragma unroll
        for (int kd = 0; kd < DK; ++kd) {
          uint32_t kb[4], vb[4];
          ldsm_x4(sk16 + ln.bn_off + kd * 32, kb);
          ldsm_x4(sv16 + ln.bn_off + kd * 32, vb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][0], qf[mt][kd], kb[0], kb[1]);
            mma_bf16(s[mt][1], qf[mt][kd], kb[2], kb[3]);
            mma_bf16(dp[mt][0], gf[mt][kd], vb[0], vb[1]);
            mma_bf16(dp[mt][1], gf[mt][kd], vb[2], vb[3]);
          }
        }
      } else {
        const T* Kt = reinterpret_cast<const T*>(smem + (sk16 - s_base));
        const T* Vt = reinterpret_cast<const T*>(smem + (sv16 - s_base));
        fma_scores<T, D, L::LD>(s[0], Qw, Kt, g, c);
        fma_scores<T, D, L::LD>(dp[0], Gw, Vt, g, c);
      }

      // ---- P = exp2(S sl2 - lse2) (0 for keys past S), dS = P (dP - delta)
      // scale, in place of S
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = ex2(fmaf(s[mt][n][e], sl2, -lse2[mt][r]));
            if (ragged && kv0 + kk * 16 + 8 * n + 2 * c + (e & 1) >= S) p = 0.f;
            s[mt][n][e] = p * (dp[mt][n][e] - dlt[mt][r]) * a.scale;
          }

      // ---- dQ += dS K, dS rounded to T
      if constexpr (L::MMA) {
        uint32_t da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) pack_a(s[mt], da[mt]);
#pragma unroll
        for (int dj = 0; dj < DT / 2; ++dj) {
          uint32_t kb[4];
          ldsm_x4_trans(sk16 + ln.bk_off + dj * 32, kb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(dq[mt][2 * dj], da[mt], kb[0], kb[1]);
            mma_bf16(dq[mt][2 * dj + 1], da[mt], kb[2], kb[3]);
          }
        }
      } else {
        const T* Kt = reinterpret_cast<const T*>(smem + (sk16 - s_base));
        to_buffer<L::LDP>(Pw, s[0], g, c);
        __syncwarp();
        fma_buffer_product<T, D, L::LD, L::LDP>(dq[0], Pw, Kt, g, c);
        __syncwarp();     // Pw is rewritten by the next 16 keys
      }
    }
  }

  T* out = static_cast<T*>(a.out0) + b * a.st[12] + h * a.st[14];
  store_rows<T, D, MT, L::LD>(dq, Qw, out, a.st[13], r0, S, lane);
}

// ---------------------------------------------------------------- dK/dV ---

template <typename T, int D, int BT, int MT>
__global__ void __launch_bounds__(MAX_WARPS * 32, (Policy<DKV, D>::MIN_BLOCKS))
flash_bwd_dkv_kernel(const Args a) {
  using L = Layout<DKV, T, D, BT, MT>;
  using P = Policy<DKV, D>;
  static_assert(L::MMA || MT == 1, "the f32 FMA variant has one m-tile");
  static_assert(BT % 16 == 0 && D % 16 == 0, "tile shapes");
  constexpr int DT = D / 8;
  constexpr int DK = D / 16;
  constexpr int WR = 16 * MT;                 // key rows per warp
  // K and V as A fragments in registers for the whole loop, unless the two
  // D-wide accumulators already hold the registers
  constexpr bool AREG = L::MMA && D * MT <= 64;
  constexpr int KF = AREG ? DK : 1;
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int warps = blockDim.x / 32;
  const int S = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * WR * warps;
  const int r0 = k0 + warp * WR;              // the warp's first key
  const float sl2 = a.scale * LOG2E;

  const T* qbase = slice<T>(a.q, a.st + 0, b, h);
  const T* kbase = slice<T>(a.k, a.st + 3, b, h);
  const T* vbase = slice<T>(a.v, a.st + 6, b, h);
  const T* gbase = slice<T>(a.g, a.st + 9, b, h);
  const float* lrow = a.lse + (int64_t)bh * S;
  const float* drow = a.delta + (int64_t)bh * S;

  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_ring = s_base + L::ring_off(warps);
  T* Kw = reinterpret_cast<T*>(smem) + warp * WR * L::LD;   // the warp's rows
  T* Vw = reinterpret_cast<T*>(smem + L::own(warps)) + warp * WR * L::LD;
  const uint32_t s_kw = smem_addr(Kw), s_vw = smem_addr(Vw);
  const Lane<L::ROW> ln(lane);

  // K, V and stage 0 (Q, dO, lse, delta of queries 0 .. BT): one group.
  // Queries past S are zero-filled with their statistics: P = 1 there, but
  // dO and dS are 0, so they add nothing to dV or dK.
  load_rows_async<T, D>(s_base, kbase, a.st[4], k0, WR * warps, S);
  load_rows_async<T, D>(s_base + L::own(warps), vbase, a.st[7], k0, WR * warps, S);
  load_rows_async<T, D>(s_ring, qbase, a.st[1], 0, BT, S);
  load_rows_async<T, D>(s_ring + L::TILE, gbase, a.st[10], 0, BT, S);
  load_stats_async(s_ring + 2 * L::TILE, lrow, 0, BT, S);
  load_stats_async(s_ring + 2 * L::TILE + 4 * BT, drow, 0, BT, S);
  cp_async_commit();

  float dk[MT][DT][4], dv[MT][DT][4];
  zero(dk);
  zero(dv);
  uint32_t kf[MT][KF][4], vf[MT][KF][4];      // the warp's K, V as A fragments
  float* Pw = reinterpret_cast<float*>(smem + L::p_off(warps)) + warp * 16 * L::LDP;
  const int ntiles = (S + BT - 1) / BT;

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BT;
    cp_async_wait_all();
    __syncthreads();      // tile t landed for all; tile t-1 fully consumed
    if (t + 1 < ntiles) {
      const uint32_t dst = s_ring + ((t + 1) % STAGES) * L::STAGE;
      load_rows_async<T, D>(dst, qbase, a.st[1], q0 + BT, BT, S);
      load_rows_async<T, D>(dst + L::TILE, gbase, a.st[10], q0 + BT, BT, S);
      load_stats_async(dst + 2 * L::TILE, lrow, q0 + BT, BT, S);
      load_stats_async(dst + 2 * L::TILE + 4 * BT, drow, q0 + BT, BT, S);
      cp_async_commit();
    }
    if constexpr (AREG) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kd = 0; kd < KF; ++kd) {
            ldsm_x4(s_kw + mt * 16 * L::ROW + ln.a_off + kd * 32, kf[mt][kd]);
            ldsm_x4(s_vw + mt * 16 * L::ROW + ln.a_off + kd * 32, vf[mt][kd]);
          }
      }
    }
    const uint32_t sq = s_ring + (t % STAGES) * L::STAGE;
    const uint32_t sg = sq + L::TILE;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + (sq - s_base) + 2 * L::TILE);
    const float* dlt_s = lse_s + BT;

#pragma unroll (P::CHUNK_UNROLL ? P::CHUNK_UNROLL : BT / 16)
    for (int kk = 0; kk < BT / 16; ++kk) {    // 16 queries at a time
      const uint32_t sq16 = sq + kk * 16 * L::ROW, sg16 = sg + kk * 16 * L::ROW;
      // ---- S^T = K Q^T and dP^T = V dO^T for the warp's keys x 16 queries
      float s[MT][2][4], dp[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = dp[mt][n][e] = 0.f;
      if constexpr (L::MMA) {
#pragma unroll
        for (int kd = 0; kd < DK; ++kd) {
          uint32_t qb[4], gb[4];
          ldsm_x4(sq16 + ln.bn_off + kd * 32, qb);
          ldsm_x4(sg16 + ln.bn_off + kd * 32, gb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (AREG) {
              mma_bf16(s[mt][0], kf[mt][kd], qb[0], qb[1]);
              mma_bf16(s[mt][1], kf[mt][kd], qb[2], qb[3]);
              mma_bf16(dp[mt][0], vf[mt][kd], gb[0], gb[1]);
              mma_bf16(dp[mt][1], vf[mt][kd], gb[2], gb[3]);
            } else {
              uint32_t ka[4], va[4];
              ldsm_x4(s_kw + mt * 16 * L::ROW + ln.a_off + kd * 32, ka);
              ldsm_x4(s_vw + mt * 16 * L::ROW + ln.a_off + kd * 32, va);
              mma_bf16(s[mt][0], ka, qb[0], qb[1]);
              mma_bf16(s[mt][1], ka, qb[2], qb[3]);
              mma_bf16(dp[mt][0], va, gb[0], gb[1]);
              mma_bf16(dp[mt][1], va, gb[2], gb[3]);
            }
          }
        }
      } else {
        const T* Qt = reinterpret_cast<const T*>(smem + (sq16 - s_base));
        const T* Gt = reinterpret_cast<const T*>(smem + (sg16 - s_base));
        fma_scores<T, D, L::LD>(s[0], Kw, Qt, g, c);
        fma_scores<T, D, L::LD>(dp[0], Vw, Gt, g, c);
      }

      // ---- P^T = exp2(S^T sl2 - lse2[query]) in place of S^T, dS^T =
      // P^T (dP^T - delta[query]) scale in place of dP^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = kk * 16 + 8 * n + 2 * c;
        const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d = *reinterpret_cast<const float2*>(dlt_s + col);
        const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float p0 = ex2(fmaf(s[mt][n][0], sl2, -l0));
          const float p1 = ex2(fmaf(s[mt][n][1], sl2, -l1));
          const float p2 = ex2(fmaf(s[mt][n][2], sl2, -l0));
          const float p3 = ex2(fmaf(s[mt][n][3], sl2, -l1));
          s[mt][n][0] = p0;
          s[mt][n][1] = p1;
          s[mt][n][2] = p2;
          s[mt][n][3] = p3;
          dp[mt][n][0] = p0 * (dp[mt][n][0] - d.x) * a.scale;
          dp[mt][n][1] = p1 * (dp[mt][n][1] - d.y) * a.scale;
          dp[mt][n][2] = p2 * (dp[mt][n][2] - d.x) * a.scale;
          dp[mt][n][3] = p3 * (dp[mt][n][3] - d.y) * a.scale;
        }
      }

      // ---- dV += P^T dO and dK += dS^T Q, P and dS rounded to T
      if constexpr (L::MMA) {
        uint32_t pa[MT][4], da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pack_a(s[mt], pa[mt]);
          pack_a(dp[mt], da[mt]);
        }
#pragma unroll
        for (int dj = 0; dj < DT / 2; ++dj) {
          uint32_t gb[4], qb[4];
          ldsm_x4_trans(sg16 + ln.bk_off + dj * 32, gb);
          ldsm_x4_trans(sq16 + ln.bk_off + dj * 32, qb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(dv[mt][2 * dj], pa[mt], gb[0], gb[1]);
            mma_bf16(dv[mt][2 * dj + 1], pa[mt], gb[2], gb[3]);
            mma_bf16(dk[mt][2 * dj], da[mt], qb[0], qb[1]);
            mma_bf16(dk[mt][2 * dj + 1], da[mt], qb[2], qb[3]);
          }
        }
      } else {
        const T* Qt = reinterpret_cast<const T*>(smem + (sq16 - s_base));
        const T* Gt = reinterpret_cast<const T*>(smem + (sg16 - s_base));
        to_buffer<L::LDP>(Pw, s[0], g, c);
        __syncwarp();
        fma_buffer_product<T, D, L::LD, L::LDP>(dv[0], Pw, Gt, g, c);
        __syncwarp();
        to_buffer<L::LDP>(Pw, dp[0], g, c);
        __syncwarp();
        fma_buffer_product<T, D, L::LD, L::LDP>(dk[0], Pw, Qt, g, c);
        __syncwarp();
      }
    }
  }

  T* dko = static_cast<T*>(a.out0) + b * a.st[12] + h * a.st[14];
  T* dvo = static_cast<T*>(a.out1) + b * a.st[15] + h * a.st[17];
  store_rows<T, D, MT, L::LD>(dk, Kw, dko, a.st[13], r0, S, lane);
  store_rows<T, D, MT, L::LD>(dv, Vw, dvo, a.st[16], r0, S, lane);
}

// ------------------------------------------------------------- launchers ---

using KernelFn = void (*)(const Args);

template <int KERN, typename T, int D, int BT, int MT>
KernelFn kernel_fn() {
  if constexpr (KERN == DQ) return flash_bwd_dq_kernel<T, D, BT, MT>;
  else return flash_bwd_dkv_kernel<T, D, BT, MT>;
}

// Allow the largest block's dynamic shared memory once per instantiation
// (one device per process); every layout fits in the 227 KB a block may use.
template <int KERN, typename T, int D, int BT, int MT>
cudaError_t allow_smem() {
  using L = Layout<KERN, T, D, BT, MT>;
  static_assert(L::bytes(MAX_WARPS) <= 232448, "shared memory");
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel_fn<KERN, T, D, BT, MT>(),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::bytes(MAX_WARPS));
  done = e == cudaSuccess;
  return e;
}

template <int KERN, typename T, int D, int BT, int MT>
cudaError_t launch(const Args& a, int B, int warps, cudaStream_t stream) {
  cudaError_t e = allow_smem<KERN, T, D, BT, MT>();
  if (e != cudaSuccess) return e;
  const int rows = 16 * MT * warps;
  dim3 grid(B * a.H, (a.S + rows - 1) / rows);
  const KernelFn fn = kernel_fn<KERN, T, D, BT, MT>();
  fn<<<grid, warps * 32, Layout<KERN, T, D, BT, MT>::bytes(warps), stream>>>(a);
  return cudaGetLastError();
}

template <int KERN, typename T, int D, int BT, int MT>
cudaError_t info(int warps, int* res) {
  cudaError_t e = allow_smem<KERN, T, D, BT, MT>();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel_fn<KERN, T, D, BT, MT>());
  if (e != cudaSuccess) return e;
  const int bytes = Layout<KERN, T, D, BT, MT>::bytes(warps);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_fn<KERN, T, D, BT, MT>(), warps * 32, bytes);
  if (e != cudaSuccess) return e;
  res[0] = bytes;
  res[1] = attr.numRegs;
  res[2] = (int)attr.localSizeBytes;
  res[3] = blocks;
  return cudaSuccess;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* out0, void* out1,
               int S, int H, float scale, const long long* st, int n_st) {
  Args a{q, k, v, dout, lse, delta, out0, out1, S, H, scale, {}};
  for (int i = 0; i < n_st; ++i) a.st[i] = st[i];
  return a;
}

}  // namespace

// The instantiations: (kernel: 0 = dQ, 1 = dK/dV; dtype code, type, D, BT,
// MT). dtype: 0 = bfloat16, 1 = float32. The launch geometry picks one of
// the (BT, MT) built per kernel, dtype and D, mirrored by
// ops/flash_attention.py::_BWD_TILE. A build with -DSUPERDIFF_BWD_SWEEP adds
// the other tiles that tools/tune_flash_bwd.py --sweep measures (it reads
// them from SUPERDIFF_BWD_CASES here).
#define SUPERDIFF_BWD_TILES(X)                                                \
  X(0, 0, __nv_bfloat16, 32, 128, 2) X(0, 0, __nv_bfloat16, 64, 64, 1)        \
  X(0, 0, __nv_bfloat16, 64, 128, 1) X(0, 0, __nv_bfloat16, 128, 64, 1)       \
  X(0, 1, float, 32, 64, 1) X(0, 1, float, 64, 64, 1) X(0, 1, float, 128, 32, 1) \
  X(1, 0, __nv_bfloat16, 32, 128, 2) X(1, 0, __nv_bfloat16, 64, 64, 1)        \
  X(1, 0, __nv_bfloat16, 64, 128, 1) X(1, 0, __nv_bfloat16, 128, 64, 1)       \
  X(1, 1, float, 32, 64, 1) X(1, 1, float, 64, 64, 1) X(1, 1, float, 128, 32, 1)
#ifdef SUPERDIFF_BWD_SWEEP
#define SUPERDIFF_BWD_CASES(X)                                                \
  SUPERDIFF_BWD_TILES(X)                                                      \
  X(0, 0, __nv_bfloat16, 32, 32, 1) X(0, 0, __nv_bfloat16, 32, 64, 1)         \
  X(0, 0, __nv_bfloat16, 32, 32, 2) X(0, 0, __nv_bfloat16, 32, 64, 2)         \
  X(0, 0, __nv_bfloat16, 64, 32, 1) X(0, 0, __nv_bfloat16, 64, 64, 2)         \
  X(1, 0, __nv_bfloat16, 32, 32, 1) X(1, 0, __nv_bfloat16, 32, 64, 1)         \
  X(1, 0, __nv_bfloat16, 32, 32, 2) X(1, 0, __nv_bfloat16, 32, 64, 2)         \
  X(1, 0, __nv_bfloat16, 64, 32, 1) X(1, 0, __nv_bfloat16, 64, 64, 2)
#else
#define SUPERDIFF_BWD_CASES(X) SUPERDIFF_BWD_TILES(X)
#endif

// strides: element strides (batch, seq, head) of q, k, v, dO and then the
// outputs, in that order (15 values for dQ; 18 for dK/dV: ..., dK, dV).
// Geometry: warps (1..8) per block, each owning 16 * mt rows; bt rows per
// looped tile. Both return the cudaError_t of the launch (0 = success); a
// geometry that is not built returns cudaErrorInvalidValue without
// launching.
extern "C" int superdiff_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int S, int H, int D,
    int dtype, float scale, const long long* strides, int warps, int bt,
    int mt, void* stream) {
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, S, H, scale,
                           strides, 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUPERDIFF_CASE(KK, DT, T, DD, BTT, MTT)                              \
  if (KK == DQ && dtype == DT && D == DD && bt == BTT && mt == MTT)           \
    return (int)launch<KK, T, DD, BTT, MTT>(a, B, warps, s);
  SUPERDIFF_BWD_CASES(SUPERDIFF_CASE)
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int superdiff_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int S,
    int H, int D, int dtype, float scale, const long long* strides, int warps,
    int bt, int mt, void* stream) {
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, S, H, scale,
                           strides, 18);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUPERDIFF_CASE(KK, DT, T, DD, BTT, MTT)                              \
  if (KK == DKV && dtype == DT && D == DD && bt == BTT && mt == MTT)          \
    return (int)launch<KK, T, DD, BTT, MTT>(a, B, warps, s);
  SUPERDIFF_BWD_CASES(SUPERDIFF_CASE)
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the occupancy calculator say of one instantiation
// (kernel: 0 = dQ, 1 = dK/dV) at `warps` warps per block: res = {dynamic
// shared bytes, registers per thread, local (spill) bytes per thread,
// resident blocks per SM}.
extern "C" int superdiff_flash_attn_bwd_info(int kernel, int D, int dtype,
                                             int warps, int bt, int mt,
                                             int* res) {
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
#define SUPERDIFF_CASE(KK, DT, T, DD, BTT, MTT)                              \
  if (kernel == KK && dtype == DT && D == DD && bt == BTT && mt == MTT)       \
    return (int)info<KK, T, DD, BTT, MTT>(warps, res);
  SUPERDIFF_BWD_CASES(SUPERDIFF_CASE)
#undef SUPERDIFF_CASE
  return (int)cudaErrorInvalidValue;
}
