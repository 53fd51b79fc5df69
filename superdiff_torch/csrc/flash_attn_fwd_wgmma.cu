// Flash-attention forward for Hopper (sm_90a), B1's second design: bf16,
// head dim 64, long sequences (Stable Diffusion's self-attention over 4,096
// and 1,024 latent positions). Same contract and numerics as
// csrc/flash_attn_fwd.cu; ops/flash_attention.py::_fwd_design picks this
// design from the launch's shape, and every other launch stays there.
//
// It replaces no TPU kernel of its own: it is a second design for the one
// TPU kernel that csrc/flash_attn_fwd.cu replaces,
// superdiff_tpu/ops/flash_attention.py::_flash_kernel, written for what this
// card has and that design does not use (TMA, wgmma, setmaxnreg).
//
// What bounds it: at S = Skv = 4096, H = 5, 16 rows (SD's 64^2 level) a
// launch does 4 * 16 * 5 * 4096^2 * 64 = 3.44e11 tensor FLOPs (0.347 ms at
// 989 TFLOP/s) and 16 * 5 * 4096^2 = 1.34e9 exponentials (about 0.32 ms at
// 16 per clock on each of 132 SMs), against 42 MB of q, k, v, out (13 us).
// Two floors of about the same size: one tile's exponentials must run
// under another tile's products, or the sum of the two is the limit. On the
// H100 it runs at about 0.70 ms, between the larger floor and the sum
// (PERF.md).
//
// Structure: one block per 64 query rows of one (batch, head), two
// warpgroups, two blocks resident on each SM.
// - Producer (warpgroup 0, one thread; setmaxnreg down to 24 registers):
//   loads the block's Q tile once by TMA, then K and V tiles of BN keys into
//   a ring of STAGES stages, each stage with a full and an empty mbarrier
//   for K and for V. The tensor maps describe the caller's (B, S, H, D)
//   strided views (dims D, H, S, B), are built on the host per launch and
//   passed as __grid_constant__ parameters, so a CUDA graph replays them
//   and no transpose copy is made. TMA writes every tile in the 128-byte
//   swizzle that wgmma reads, and zero-fills query rows past S.
// - Consumer (warpgroup 1, the block's 64 query rows; setmaxnreg up to
//   232): S = Q K^T as SS-wgmma m64n128k16 into f32 registers; P.V as
//   RS-wgmma m64n64k16 with P taken from registers as bf16 (the S
//   accumulator's layout is the A fragment's, so P is packed in place) and
//   V read MN-major (transposed by the instruction, no copy).
// - Overlap: the consumer issues the products of tile n (Q K_n^T) and of
//   tile n-1 (P_{n-1} V_{n-1}) together, waits for the first, runs tile
//   n's softmax, waits for the second, rescales O and packs P_n into the
//   registers the second read. The two consumers on an SM belong to two
//   blocks and run unsynchronised, so one's softmax runs under the other's
//   products; this measured 12 % faster on the H100 than two consumers of
//   one block taking turns through named barriers (ping-pong: PERF.md).
//   ptxas moves the wait for P_{n-1} V_{n-1} up to the softmax's start, as
//   P_n's registers are P_{n-1}'s; a loop that waits at the head of the
//   next iteration keeps the softmax under that product, and measured no
//   faster.
// - Epilogue: out = O / l rounded once to bf16 into the Q rows in shared
//   memory (swizzled as the TMA store reads them), one TMA store of the
//   64 x 64 tile (rows past S are not written); lse by the threads that
//   hold each row's sum.
//
// Numerics are B1's: scores and the running max and sum in f32, one
// ex2.approx.ftz per score with log2(e) folded into the scale, P rounded to
// bf16 before P.V, out = acc * (1 / l) rounded once, lse = m * ln2 + log(l)
// in f32 as (B*H, S). No float atomics and a fixed order of every sum: a
// rerun gives the same bits. Skv is a whole number of BN-key tiles (the
// rule in ops/flash_attention.py sends no other launch here), so no key is
// masked; S may end in a partial tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                     // head dim: one 128-byte row
constexpr int ROW = D * 2;                // bytes of one bf16 row
constexpr int BM = 64;                    // query rows per block
constexpr int THREADS = 256;              // a producer and a consumer
constexpr int BLOCKS_PER_SM = 2;
constexpr int BN = 128;                   // keys per K / V tile
constexpr int STAGES = 2;                 // K / V ring depth (3 and 4 measured
                                          // no faster on the H100)
constexpr int PRODUCER_REGS = 24;         // setmaxnreg of the producer
constexpr int CONSUMER_REGS = 232;        // and of the consumer
constexpr int EPI_BAR = 1;                // named barrier: the epilogue
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;         // finite "minus infinity"

static_assert(BLOCKS_PER_SM * 128 * (PRODUCER_REGS + CONSUMER_REGS) <= 65536,
              "register file");

// Shared memory, mirrored by ops/flash_attention.py::_fwd_wgmma_smem_bytes:
// [Q: BM rows][K: STAGES x BN rows][V: STAGES x BN rows]
// [mbarriers: full K, full V, empty K, empty V per stage, full Q], from a
// base aligned to 1024 bytes (the 128-byte swizzle's period), so ALLOC
// holds 1024 bytes of slack.
struct Smem {
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * ROW;
  static constexpr int V = K + STAGES * BN * ROW;
  static constexpr int BAR = V + STAGES * BN * ROW;
  static constexpr int ALLOC = BAR + (4 * STAGES + 1) * 8 + 1024;
};

struct Params {
  float* lse;
  int S, Skv, H, m_blocks;
  float scale_log2;                       // softmax scale * log2(e)
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA tile load of a 4-d map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// One TMA tile store from shared memory, waited for until it has read it.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma writes across the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle whose
// base is 1024-byte aligned: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A . B^T for one k16 slice: m64n128k16, A (64 x 16) and B (128 x 16)
// both K-major in shared memory (128-byte swizzle); accumulate = 0 overwrites
// d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B for one k16 slice: m64n64k16, A (64 x 16 bf16) from registers
// in the accumulator-shaped fragment, B (16 x 64) in shared memory with its
// 64 columns contiguous (MN-major, 128-byte swizzle: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// ------------------------------------------------------- consumer pieces
//
// Accumulator layout (wgmma m64nN, f32): thread t of the warpgroup, warp w =
// t / 32, g = (t % 32) / 4, c = t % 4, holds rows 16w + g and 16w + g + 8;
// for each 8-column chunk j, s[4j], s[4j + 1] at row 16w + g, columns 8j +
// 2c and 8j + 2c + 1, and s[4j + 2], s[4j + 3] at row 16w + g + 8.

// S = Q K^T over the four k16 slices of D (32 bytes each along the
// swizzled rows).
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V over the BN / 16 k16 slices of keys (16 rows = 2048 bytes of V
// each); P's slice kk is chunks 2kk and 2kk + 1 of the score accumulator.
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[BN / 4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs_n64(o, a, dv + kk * (16 * ROW >> 4));
  }
}

// Fold the first 2W entries of both rows of x into x[r][0], pairwise (a
// tree, so the steps are independent); W a power of two. Written as a
// template recursion: a loop whose bound halves is not unrolled, and its
// array would go to local memory.
template <int W, int N, typename F>
__device__ __forceinline__ void tree(float (&x)[2][N], F op) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    x[0][i] = op(x[0][i], x[0][i + W]);
    x[1][i] = op(x[1][i], x[1][i + W]);
  }
  if constexpr (W > 1) tree<W / 2>(x, op);
}

// Online softmax of one tile in the log2 domain (B1's): the new running max
// from the raw scores' row max times sl2, al = exp2(old - new), s replaced
// by exp2(s * sl2 - new), lane-partial sums l = l * al + rowsum.
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&al)[2],
                                             float sl2) {
  constexpr int NJ = BN / 8;
  float mx[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0][j] = fmaxf(s[4 * j], s[4 * j + 1]);
    mx[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
  tree<NJ / 2>(mx, [](float x, float y) { return fmaxf(x, y); });
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r][0] = fmaxf(mx[r][0], __shfl_xor_sync(0xffffffffu, mx[r][0], 1));
    mx[r][0] = fmaxf(mx[r][0], __shfl_xor_sync(0xffffffffu, mx[r][0], 2));
    mn[r] = fmaxf(m[r], mx[r][0] * sl2);
    al[r] = ex2(m[r] - mn[r]);
    m[r] = mn[r];
  }
  float rs[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], sl2, -mn[0]));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -mn[0]));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -mn[1]));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -mn[1]));
    rs[0][j] = s[4 * j] + s[4 * j + 1];
    rs[1][j] = s[4 * j + 2] + s[4 * j + 3];
  }
  tree<NJ / 2>(rs, [](float x, float y) { return x + y; });
  l[0] = fmaf(l[0], al[0], rs[0][0]);
  l[1] = fmaf(l[1], al[1], rs[1][0]);
}

// P = bf16(s) in the A-fragment order of issue_pv.
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2],
                                       uint32_t (&p)[BN / 4]) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// ------------------------------------------------------------------ kernel

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const Params a) {
  using L = Smem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sq = base + L::Q, sk = base + L::K, sv = base + L::V;
  const uint32_t bars = base + L::BAR;
  // mbarriers: full K, full V, empty K, empty V by stage, then full Q
  const uint32_t full_k = bars, full_v = bars + 8 * STAGES;
  const uint32_t empty_k = bars + 16 * STAGES, empty_v = bars + 24 * STAGES;
  const uint32_t full_q = bars + 32 * STAGES;

  const int wg = threadIdx.x / 128;
  const int m_block = blockIdx.x % a.m_blocks;
  const int bh = blockIdx.x / a.m_blocks;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = m_block * BM;
  const int ntiles = a.Skv / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4);   // one arrive per consumer warp
      mbar_init(empty_v + 8 * s, 4);
    }
    mbar_init(full_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, BM * ROW);
      tma_load(sq, &tq, full_q, 0, h, q0, b);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % STAGES;
        const uint32_t ph = (n / STAGES) & 1;
        mbar_wait(empty_k + 8 * st, ph ^ 1);
        mbar_expect_tx(full_k + 8 * st, BN * ROW);
        tma_load(sk + st * BN * ROW, &tk, full_k + 8 * st, 0, h, n * BN, b);
        mbar_wait(empty_v + 8 * st, ph ^ 1);
        mbar_expect_tx(full_v + 8 * st, BN * ROW);
        tma_load(sv + st * BN * ROW, &tv, full_v + 8 * st, 0, h, n * BN, b);
      }
    }
  } else {
    // Consumer. The two roles never meet again (no code after this if), as
    // setmaxnreg wants.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, c = lane % 4;
    const bool lead = lane == 0;
    const float sl2 = a.scale_log2;
    // K-major operands (Q, K): 8-row groups 1024 bytes apart, the leading
    // offset unused; V MN-major: 8-key groups 1024 bytes apart, its 64
    // columns one swizzle atom wide (the leading offset unused).
    const uint64_t dq = desc_sw128(sq, 16, 1024);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float s[BN / 2];
    uint32_t p[BN / 4];
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, al[2];

    mbar_wait(full_q, 0);

    // tile 0: S alone
    mbar_wait(full_k, 0);
    wgmma_fence();
    issue_qk(s, dq, desc_sw128(sk, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lead) mbar_arrive(empty_k);
    softmax_tile(s, m, l, al, sl2);
    pack_p(s, p);

#pragma unroll 1
    for (int n = 1; n < ntiles; ++n) {
      const int sk_st = n % STAGES, sv_st = (n - 1) % STAGES;
      mbar_wait(full_k + 8 * sk_st, (n / STAGES) & 1);
      mbar_wait(full_v + 8 * sv_st, ((n - 1) / STAGES) & 1);
      wgmma_fence();
      issue_qk(s, dq, desc_sw128(sk + sk_st * BN * ROW, 16, 1024));
      wgmma_commit();
      issue_pv(o, p, desc_sw128(sv + sv_st * BN * ROW, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();                        // S of tile n
      fence_regs(s);
      if (lead) mbar_arrive(empty_k + 8 * sk_st);
      softmax_tile(s, m, l, al, sl2);
      wgmma_wait<0>();                        // P_{n-1} V_{n-1}
      fence_regs(o);
      fence_regs(p);
      if (lead) mbar_arrive(empty_v + 8 * sv_st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= al[0];
        o[4 * j + 1] *= al[0];
        o[4 * j + 2] *= al[1];
        o[4 * j + 3] *= al[1];
      }
      pack_p(s, p);
    }

    // the last tile's P V
    {
      const int st = (ntiles - 1) % STAGES;
      mbar_wait(full_v + 8 * st, ((ntiles - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv(o, p, desc_sw128(sv + st * BN * ROW, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // ---- epilogue: full row sums over the quad, lse, out = O / l
    const int r = warp * 16 + g;              // this thread's rows r, r + 8
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / l[i];
      const int qi = q0 + r + 8 * i;
      if (c == 0 && qi < a.S)
        a.lse[(int64_t)bh * a.S + qi] = m[i] * LN2 + logf(l[i]);
    }
    // O into the Q rows (the last Q K^T has completed): 16-byte chunk j of
    // row r goes to chunk j ^ (r % 8), the TMA store's swizzle
    unsigned char* so = smem + L::Q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = ((j ^ (r & 7)) << 4) + 4 * c;
      *reinterpret_cast<uint32_t*>(so + r * ROW + off) =
          pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(so + (r + 8) * ROW + off) =
          pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(EPI_BAR, 128);
    if (t == 0) tma_store(&to, sq, 0, h, q0, b);
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, L, H, 64) bf16 view with element strides (batch, seq, head) as a
// 4-d map (dims D, H, L, B innermost first) whose box is `rows` rows of one
// (b, h), in the 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
              const long long* st, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t allow_smem() {
  static_assert(Smem::ALLOC <= 232448, "shared memory");
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::ALLOC);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

// q (B, S, H, 64), k and v (B, Skv, H, 64), bf16, through 9 element strides
// (batch, seq, head for q, k, v; rows 16-byte aligned); out is a contiguous
// (B, S, H, 64); lse (B*H, S) f32; Skv a multiple of 128. Returns the
// cudaError_t of the launch (0 = success); a head dim other than 64, a
// partial key tile or a view TMA cannot describe returns
// cudaErrorInvalidValue without launching.
extern "C" int superdiff_flash_attn_fwd_wgmma(const void* q, const void* k,
                                              const void* v, void* out,
                                              float* lse, int B, int S,
                                              int Skv, int H, int D_,
                                              float scale,
                                              const long long* st,
                                              void* stream) {
  if (D_ != D || S < 1 || Skv < BN || Skv % BN)
    return (int)cudaErrorInvalidValue;
  const long long ost[3] = {(long long)S * H * D, (long long)H * D, D};
  CUtensorMap maps[4];
  if (!make_map(&maps[0], q, B, S, H, st, BM) ||
      !make_map(&maps[1], k, B, Skv, H, st + 3, BN) ||
      !make_map(&maps[2], v, B, Skv, H, st + 6, BN) ||
      !make_map(&maps[3], out, B, S, H, ost, BM))
    return (int)cudaErrorInvalidValue;
  const int m_blocks = (S + BM - 1) / BM;
  const long long blocks = (long long)m_blocks * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const Params p{lse, S, Skv, H, m_blocks, scale * LOG2E};
  flash_fwd_kernel_wgmma<<<(int)blocks, THREADS, Smem::ALLOC,
                           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator say of the kernel: res =
// {dynamic shared bytes, registers per thread, local (spill) bytes per
// thread, resident blocks per SM}.
extern "C" int superdiff_flash_attn_fwd_wgmma_info(int* res) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, flash_fwd_kernel_wgmma);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_kernel_wgmma, THREADS, Smem::ALLOC);
  if (e != cudaSuccess) return (int)e;
  res[0] = Smem::ALLOC;
  res[1] = attr.numRegs;
  res[2] = (int)attr.localSizeBytes;
  res[3] = blocks;
  return (int)cudaSuccess;
}
