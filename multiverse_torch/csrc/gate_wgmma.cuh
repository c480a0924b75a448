// The gate launch of every fused decode step and of the ConvLSTM cell, on
// Hopper's wgmma (sm_90a): the implicit-GEMM 3x3 gate conv with the LSTM
// update in its epilogue. One design, instantiated per operand type:
//
//   kS8     K2/K3 (fused_decode_q8.cu): int8 x int8 -> s32, dequantised
//           as acc * t_c + b;
//   kS8Dyn  K7 (fused_decode_q8.cu): an int8 embedding half and a
//           recurrent half quantised by the consumers from staged f32
//           rows at per-row scales;
//   kBf16   K1, K8, K6 and K9 (fused_decode.cu): bf16 x bf16 -> f32,
//           gates = acc + b (K9: ((acc + dev) + bg) + b from its tables).
//
// M = NK*HW pixels, K = 9*(E+D), N = 4*D. Bound: operations (~0.98 TOP at
// 320 beam rows, 18x32, D=256, E=32: ~0.49 ms at the int8 peak, ~0.99 ms
// at the bf16 one, against ~0.5 GB of state traffic). mma.sync and wmma
// cannot reach those rates; wgmma can. So:
//   * wgmma.mma_async m64nNk32 (s8) or m64nNk16 (bf16), both operands
//     K-major in 128-byte-swizzled shared memory, issued by consumer
//     warpgroups. A is read from shared memory, not registers: the
//     producer or TMA writes it there in the swizzled layout, and K7's
//     quantised tile is shared by the two warpgroups of a block;
//   * K in two halves, the embedding rows of the nine taps and then the
//     recurrent ones (the weights' columns reordered to match once per
//     decode, ops/gate_layout.py), stages of 128 bytes (128 int8 or 64 bf16
//     values: the swizzle row, and four 32-byte wgmma K steps) never
//     straddling the halves;
//   * B by TMA: a tensor map over the weights ([4D, K], K-major, the gate
//     rows interleaved by 8-channel chunks), SWIZZLE_128B, one box per
//     stage, completion on an mbarrier. cuTensorMapEncodeTiled comes from
//     libcuda through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda. Maps are cached by what they encode (a map holds an address
//     and a shape, never data), so the weights' maps are encoded once per
//     prepared weights, and the shared-memory attribute and the SM count
//     are set and read once per kernel and card;
//   * A of a recurrent stage, where 64 pixels are whole image rows of one
//     beam row (W divides 64 and one stage's channels lie in one tap: D a
//     multiple of 128 int8 or 64 bf16 values; the paths' 18x32), is a TMA
//     box of h2 [NK, H, W, D] at the tap's offset, zero-filled outside the
//     grid: the hardware does the implicit im2col. The embedding stages,
//     and every stage of other shapes, are gathered by a producer
//     warpgroup with 16-byte cp.async vectors (no vector straddles a tap:
//     E and D are multiples of 16 int8 or 8 bf16 values) straight into the
//     swizzled layout. The producer never waits for its copies: each
//     thread's cp.async.mbarrier.arrive marks the stage full once they
//     land, and the consumers fence them to the async proxy before wgmma;
//   * tiles of 128 pixels (two 64-pixel units, each its own box) by 64
//     channels (256 gate columns) where D % 64 = 0, two consumer
//     warpgroups of 64 x 256, three stages of 48 KB; one persistent block
//     an SM walks the tiles, its producer filling the next tile's stages
//     while the consumers run the last one's epilogue;
//   * the interleaved gate rows put i, g, f and o of a thread's channels
//     in its own accumulator registers, so the LSTM update runs in
//     registers, each product and sum rounded on its own (__fmul_rn,
//     __fadd_rn), as the plain version's separate tensor operations round;
//     h' and c' leave through shared memory as whole 16-byte rows.
//   The s32 sums are exact, so with the same int8 inputs the gates equal
//   the plain version's; the f32 sums of the bf16 launch differ from the
//   plain product's only in their order.

#pragma once

#include <cuda.h>

#include <atomic>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BK = 128;  // K bytes per stage: one 128-byte swizzle row

enum GateOp { kS8 = 0, kS8Dyn = 1, kBf16 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// 2D TMA load of one box at (k, row) into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// 4D TMA load of one box at (c0, c1, c2, c3), completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// an arrival on bar when all of this thread's earlier cp.async copies have
// landed; counts as one of the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// named barrier `id` among n threads of the block
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rint(x * inv) as the low byte of a float: x * inv + 1.5 * 2^23 rounds to
// the nearest integer, ties to even (|x * inv| <= 127 << 2^22), and the
// integer n sits in the float's low bits as 0x4B400000 + n; each op
// rounded on its own. An FADD, not a cvt, which the SM issues at an
// eighth of the rate.
__device__ __forceinline__ unsigned rint_bits(float x, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(x, inv), 12582912.f));
}

// four values times inv, rounded half to even, as four int8 in a word
__device__ __forceinline__ unsigned quantize4(float4 x, float inv) {
  const unsigned lo = __byte_perm(rint_bits(x.x, inv), rint_bits(x.y, inv),
                                  0x0040);
  const unsigned hi = __byte_perm(rint_bits(x.z, inv), rint_bits(x.w, inv),
                                  0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// 1 / y rounded to nearest even, the bits of __frcp_rn(y), for y >= 1
// and NaN, with no call. __frcp_rn keeps its rare cases in a subroutine,
// and a call at each of the epilogue's 96 sigmoids a thread bound the
// registers around it: the accumulators spilled and the launch ran
// 10-16% slower. One Newton step on rcp.approx gives __frcp_rn's bits for every
// float in [1, 2^126) and every NaN; from 2^126 on 1 / y is subnormal,
// and comes from double precision (mv_rcp_rn_mismatches checks all of
// them on the card).
__device__ __forceinline__ float rcp_rn_ge1(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  r = fmaf(r, fmaf(-y, r, 1.f), r);
  if (y >= 0x1p126f) {
    const double d = y;
    double q;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(q) : "d"(d));
    q = fma(q, fma(-d, q, 1.0), q);
    q = fma(q, fma(-d, q, 1.0), q);
    r = y == INFINITY ? 0.f : __double2float_rn(q);
  }
  return r;
}

// 1 / (1 + exp(-x)), the reciprocal rounded as __frcp_rn rounds it
__device__ __forceinline__ float sigmoid_rn(float x) {
  return rcp_rn_ge1(__fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma matrix descriptor of a K-major tile with 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart; the tile starts 1024-aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The accumulator operands of one wgmma: 8 registers of d from i
#define MV_ACC8(C, d, i)                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define MV_ACC64(C, d)                                                     \
  MV_ACC8(C, d, 0), MV_ACC8(C, d, 8), MV_ACC8(C, d, 16), MV_ACC8(C, d, 24), \
      MV_ACC8(C, d, 32), MV_ACC8(C, d, 40), MV_ACC8(C, d, 48),             \
      MV_ACC8(C, d, 56)
#define MV_ACC128(C, d)                                                     \
  MV_ACC64(C, d), MV_ACC8(C, d, 64), MV_ACC8(C, d, 72), MV_ACC8(C, d, 80), \
      MV_ACC8(C, d, 88), MV_ACC8(C, d, 96), MV_ACC8(C, d, 104),             \
      MV_ACC8(C, d, 112), MV_ACC8(C, d, 120)
#define MV_R(x) "+r"(x)
#define MV_F(x) "+f"(x)
#define MV_REGS64                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MV_REGS128                                                          \
  MV_REGS64                                                                 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "     \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "  \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "   \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "      \
  "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"

// D (64 x NW, in registers) += A (64 x 32 bytes of K) * B (NW x 32 bytes of
// K)^T, both read from 128-byte-swizzled K-major tiles in shared memory:
// s8 x s8 -> s32 (k32) or bf16 x bf16 -> f32 (k16; scale-a, scale-b 1,
// neither operand transposed).
__device__ __forceinline__ void wgmma_op(int (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" MV_REGS128
      "}, %128, %129, p;\n}\n"
      : MV_ACC128(MV_R, d)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_op(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MV_REGS64
      "}, %64, %65, p;\n}\n"
      : MV_ACC64(MV_R, d)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_op(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" MV_REGS128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MV_ACC128(MV_F, d)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_op(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MV_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MV_ACC64(MV_F, d)
      : "l"(a), "l"(b));
}

// The operands of one gate launch. emb and h2 are int8 (K2/K3: emb_q,
// h2_q; K7: emb_q, h2f instead of h2) or bf16 (K1: the embedding table
// and h2; K8: one embedding row per state row; K6: x and h; K9: no
// embedding half, E = 0). prev_ids null: row r takes embedding rows
// r*HW.. (one per state row); parent_rows null: c is read from row r.
struct GateArgs {
  const int* prev_ids;
  const int* parent_rows;
  const void* emb;      // [HW, HW, E] table, or [NK*HW, E] rows
  const void* h2;       // [NK, HW, D] (K1, K2, K3, K6, K8, K9)
  const float* h2f;     // [NK, HW, D] (K7)
  const float* r_p;     // [NK * HW]   (K7)
  const bf16* c;        // [*, HW, D] old beam order
  const float* t_e;     // [4D] scales of acc (K2, K3) or of acc_e (K7)
  const float* u_c;     // [4D] (K7)
  const float* cell_b;  // [4D]
  const bf16* emb_bg;   // [HW, 4D] (K9)
  const bf16* emb_dev;  // [HW, 25, 4D] (K9)
  bf16* h_out;
  bf16* c_out;
  int NK, H, W, D, E;
  float forget_bias;
  int kb_rec;   // K coordinate of the recurrent half in its weights' map
  int upi;      // units per image where a unit is whole image rows, else 0
  int n_tiles;  // tiles of WGM units by BN gate columns
};

// A unit: the 64 pixels of one consumer warpgroup's rows, its first pixel
// m0 and its valid rows; where units are whole image rows (upi > 0), its
// beam row r and first image row y0, the last unit of an image partly
// empty; otherwise 64 consecutive pixels.
struct Unit {
  long long m0;
  int valid, r, y0;
};

__device__ __forceinline__ Unit unit_at(const GateArgs& g, long long u) {
  const int HW = g.H * g.W;
  Unit a;
  a.r = a.y0 = 0;
  if (g.upi > 0) {
    a.r = (int)u / g.upi;
    a.y0 = (int)u % g.upi * (64 / g.W);
    a.m0 = (long long)a.r * HW + a.y0 * g.W;
    a.valid = a.r < g.NK ? min(64, HW - a.y0 * g.W) : 0;
  } else {
    a.m0 = u * 64;
    a.valid = (int)max(0LL, min(64LL, (long long)g.NK * HW - a.m0));
  }
  return a;
}

// WGM x WGN consumer warpgroups of 64 rows by NW gate columns each share
// a tile of WGM units (BM pixels) by BN gate columns (BN / 4 channels);
// the producer warpgroup comes last. A persistent block (kPersist) walks
// tiles gridDim.x apart, its producer filling the next tile's stages
// while the consumers run the last one's epilogue; otherwise a block
// takes one tile. S stages, each of A (BM x 128 bytes, or for K7 the f32
// rows of a recurrent stage, BM x 128 f32) and B (BN x 128 bytes), in the
// order the tiles consume them. K7's quantised recurrent A tiles go round
// a ring of 3: a warpgroup writes slot j only after every consumer passed
// the barrier of stage j - 1, so after both warpgroups' wgmma of stage
// j - 3 completed.
template <int WGM, int WGN, int NW, int OP, int S, bool kPersist>
struct GateTile {
  static constexpr bool kDyn = OP == kS8Dyn, kBf = OP == kBf16;
  using A = typename std::conditional<kBf, bf16, signed char>::type;
  using Acc = typename std::conditional<kBf, float, int>::type;
  static constexpr int KE = BK / (int)sizeof(A);  // K values a stage
  static constexpr int BM = 64 * WGM, BN = NW * WGN, DT = BN / 4;
  static constexpr int NC = WGM * WGN, THREADS = 128 * (NC + 1);
  // registers: where the block's even share (REG, the launch bound's) is
  // short of the accumulators', the producer drops to REG_P and the
  // consumers take what it frees, no more: setmaxnreg.inc waits for free
  // registers, and the block holds only THREADS x REG of them
  static constexpr int REG = 65536 / THREADS / 8 * 8, REG_P = 56;
  static constexpr bool REBALANCE = REG < 200;
  static constexpr int REG_C = (REG * (NC + 1) - REG_P) / NC / 8 * 8;
  static_assert(!REBALANCE || REG_C * NC + REG_P <= REG * (NC + 1),
                "the consumers would wait for registers for ever");
  static constexpr int A_BYTES = BM * BK * (kDyn ? 4 : 1);
  static constexpr int B_BYTES = BN * BK;
  static constexpr int Q_SLOTS = kDyn ? 3 : 0, Q_BYTES = BM * BK;
  // the epilogue's h' and c' tiles, rows padded by 16 bytes against bank
  // conflicts: their own memory in a persistent block, else the stages'
  // once the products are done
  static constexpr int O_LD = DT * 2 + 16;
  static constexpr int O_BYTES = kPersist ? 2 * BM * O_LD : 0;
  static_assert(kPersist || 2 * BM * O_LD <= S * (A_BYTES + B_BYTES),
                "no room for h'");
  static_assert(!(kPersist && kDyn), "K7's consumers read the row scales");
  static constexpr size_t INFO = (size_t)BM * (4 + 4 + 8 + 8 + 4);
  static constexpr size_t SMEM = 1024 + (size_t)S * (A_BYTES + B_BYTES) +
                                 (size_t)Q_SLOTS * Q_BYTES + O_BYTES + INFO +
                                 2 * S * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "over the H100's 227 KB of shared memory");
};

// The gate product runs in two halves of K: the embedding rows of the nine
// taps (9E deep), then the recurrent rows (9D deep), stages of 128 bytes
// never straddling the two. K1, K2/K3, K6 and K8 sum both into one
// accumulator; K7 into acc_e and acc_h. An embedding stage's A is
// gathered by the producer warpgroup. A recurrent stage's A, where a tile
// is whole image rows of one beam row (upi > 0), is one TMA box of h2
// (K7: of the f32 h2_f) at the tap's offset, zero-filled outside the grid,
// one box a unit; otherwise the producer gathers it too.
template <int WGM, int WGN, int NW, int OP, int S, bool kPersist>
__global__ void __launch_bounds__(128 * (WGM * WGN + 1), 1)
gate_lstm_wgmma_kernel(const __grid_constant__ CUtensorMap map_we,
                       const __grid_constant__ CUtensorMap map_wh,
                       const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ GateArgs g) {
  using T = GateTile<WGM, WGN, NW, OP, S, kPersist>;
  using AT = typename T::A;
  constexpr bool kDyn = T::kDyn, kBf = T::kBf;
  constexpr int BM = T::BM, DT = T::DT, NC = T::NC, KE = T::KE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* As = base;
  signed char* Bs = reinterpret_cast<signed char*>(As + S * T::A_BYTES);
  signed char* Qs = Bs + S * T::B_BYTES;
  unsigned char* Os =
      kPersist ? reinterpret_cast<unsigned char*>(Qs + T::Q_SLOTS * T::Q_BYTES)
               : As;
  int* ry = reinterpret_cast<int*>(Qs + T::Q_SLOTS * T::Q_BYTES + T::O_BYTES);
  int* rx = ry + BM;
  long long* eoff = reinterpret_cast<long long*>(rx + BM);
  long long* hoff = eoff + BM;
  float* rinv = reinterpret_cast<float*>(hoff + BM);
  uint64_t* full = reinterpret_cast<uint64_t*>(rinv + BM);
  uint64_t* empty = full + S;

  const int H = g.H, W = g.W, D = g.D, E = g.E, HW = H * W;
  const int nb = D / DT;
  // tile t's units; returns its first channel
  auto tile_units = [&](int t, Unit (&un)[WGM]) {
#pragma unroll
    for (int w = 0; w < WGM; ++w)
      un[w] = unit_at(g, (long long)(t / nb) * WGM + w);
    return (t % nb) * DT;
  };
  // row i of a tile: where its pixel lies; rows past a unit's valid ones
  // read nothing
  auto row_info = [&](int i, const Unit (&un)[WGM]) {
    const Unit& u = un[i / 64];
    const bool ok = i % 64 < u.valid;
    const int mm = ok ? (int)u.m0 + i % 64 : 0;
    const int r = mm / HW, p = mm - r * HW;
    ry[i] = ok ? p / W : -4;
    rx[i] = p % W;
    eoff[i] = (long long)(g.prev_ids ? g.prev_ids[r] : r) * HW * E;
    hoff[i] = (long long)r * HW * D;
    if constexpr (kDyn) rinv[i] = ok ? __fdiv_rn(127.f, g.r_p[mm]) : 0.f;
  };
  const int nke = (9 * E + KE - 1) / KE;
  const int nk = nke + (9 * D + KE - 1) / KE;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer threads' cp.async arrivals + the TMA's bytes
      mbar_init(full + s, 128 + 1);
      mbar_init(empty + s, 128 * NC);  // consumer threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BM) {  // the first tile's rows
    Unit un[WGM];
    tile_units(blockIdx.x, un);
    row_info(tid, un);
  }
  __syncthreads();

  if (tid >= NC * 128) {
    // ---------------------------------------------------------- producer
    if constexpr (T::REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::REG_P));
    const int p = tid - NC * 128;

    // the swizzled A tile of im2col rows of `src0` (Cw channels a pixel,
    // rows at off[row]): 16 bytes of row `row`, chunk j
    auto gather = [&](int st, int kl, int Cw, const AT* src0,
                      const long long* off) {
      const int j = p & 7, rsub = p >> 3;
      const int k = kl * KE + (16 / (int)sizeof(AT)) * j;
      const bool kok = k < 9 * Cw;
      const int s = kok ? k / Cw : 0, ch = k - s * Cw;
      const int dy = s / 3 - 1, dx = s % 3 - 1;
      unsigned char* as = As + st * T::A_BYTES + ((j ^ (rsub & 7)) << 4);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int row = rsub + 16 * i;
        const int yy = ry[row] + dy, xx = rx[row] + dx;
        const bool ok = kok && yy >= 0 && yy < H && xx >= 0 && xx < W;
        const AT* src =
            ok ? src0 + off[row] + ((long long)yy * W + xx) * Cw + ch : src0;
        cp_async16(as + row * BK, src, ok);
      }
    };
    // K7's recurrent stage: the neighbours' f32 h + agg, rows of 128
    // values, 4 a copy
    auto gather_f32 = [&](int st, int kl) {
      const int v = p & 31, rq = p >> 5;
      const int k = kl * BK + 4 * v;
      const bool kok = k < 9 * D;
      const int s = kok ? k / D : 0, ch = k - s * D;
      const int dy = s / 3 - 1, dx = s % 3 - 1;
      unsigned char* fs = As + st * T::A_BYTES + v * 16;
#pragma unroll
      for (int i = 0; i < BM / 4; ++i) {
        const int row = rq + 4 * i;
        const int yy = ry[row] + dy, xx = rx[row] + dx;
        const bool ok = kok && yy >= 0 && yy < H && xx >= 0 && xx < W;
        const float* src =
            ok ? g.h2f + hoff[row] + ((long long)yy * W + xx) * D + ch
               : g.h2f;
        cp_async16(fs + row * BK * 4, src, ok);
      }
    };

    int gs = 0;  // stages filled, over the block's tiles
    for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
      Unit un[WGM];
      const int d0 = tile_units(t, un);
      if (t != blockIdx.x) {  // the next tile's rows, once every gather of
        bar_sync(2, 128);     // this warpgroup has read the last ones
        if (p < BM) row_info(p, un);
        bar_sync(2, 128);
      }
      for (int kt = 0; kt < nk; ++kt, ++gs) {
        const int st = gs % S;
        mbar_wait(empty + st, ((gs / S) & 1) ^ 1);
        const bool first = kt < nke;
        const int kl = first ? kt : kt - nke;
        const bool a_box = !first && g.upi > 0;
        if (p == 0) {
          int a_bytes = 0;
          if (a_box)
#pragma unroll
            for (int w = 0; w < WGM; ++w)
              a_bytes += un[w].valid > 0 ? T::A_BYTES / WGM : 0;
          mbar_arrive_expect_tx(full + st, T::B_BYTES + a_bytes);
          tma_load_2d(Bs + st * T::B_BYTES, first ? &map_we : &map_wh,
                      full + st, (first ? 0 : g.kb_rec) + kl * KE, 4 * d0);
          if (a_box) {
            // each unit's image rows shifted by the stage's tap: channels
            // ch .. ch + KE - 1 of pixels (y0 + dy - 1 .., dx - 1 ..); an
            // empty unit's rows are never stored
            const int s = kl * KE / D, ch = kl * KE - s * D;
#pragma unroll
            for (int w = 0; w < WGM; ++w)
              if (un[w].valid > 0)
                tma_load_4d(As + st * T::A_BYTES + w * (T::A_BYTES / WGM),
                            &map_x, full + st, ch, s % 3 - 1,
                            un[w].y0 + s / 3 - 1, un[w].r);
          }
        }
        if (first)
          gather(st, kl, E, static_cast<const AT*>(g.emb), eoff);
        else if (!a_box) {
          if constexpr (kDyn)
            gather_f32(st, kl);
          else
            gather(st, kl, D, static_cast<const AT*>(g.h2), hoff);
        }
        cp_async_arrive(full + st);  // never blocks: the ring runs S ahead
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    if constexpr (T::REBALANCE)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::REG_C));
    const int wg = tid >> 7;
    const int m_off = (wg / WGN) * 64, n_off = (wg % WGN) * NW;
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    typename T::Acc acc_e[NW / 2], acc_h[kDyn ? NW / 2 : 1];
    int gs0 = 0;  // the tile's first stage, over the block's tiles

    // stage gs's products into acc (one call site per accumulator, so
    // that no branch picks it: the compiler would serialise the wgmma);
    // the tile's previous stage is released once its products are done
    auto issue = [&](auto& acc, int gs, const void* a_tile) {
      const uint64_t da = sw128_desc(
          reinterpret_cast<const unsigned char*>(a_tile) + m_off * BK);
      const uint64_t db = sw128_desc(Bs + (gs % S) * T::B_BYTES + n_off * BK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // +32 bytes: +2 in the desc
        wgmma_op(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (gs > gs0) mbar_arrive(empty + (gs - 1) % S);
    };
    // stages whose A came by cp.async or TMA, straight into wgmma
    auto direct = [&](auto& acc, int k0, int k1) {
      for (int kt = k0; kt < k1; ++kt) {
        const int gs = gs0 + kt, st = gs % S;
        mbar_wait(full + st, (gs / S) & 1);
        fence_proxy_async();  // the producer's cp.async writes, for wgmma
        issue(acc, gs, As + st * T::A_BYTES);
      }
    };

    for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x, gs0 += nk) {
      Unit un[WGM];
      const int d0 = tile_units(t, un);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc_e[i] = 0;
#pragma unroll
      for (int i = 0; i < (kDyn ? NW / 2 : 1); ++i) acc_h[i] = 0;
      fence_operands(acc_e);
      fence_operands(acc_h);
      direct(acc_e, 0, nke);
      if constexpr (kDyn) {
        // the recurrent stages: the consumers quantise the staged f32 rows
        // by 127 / r_p of the output row into the swizzled int8 tile, each
        // its share of the rows, then run the stage's products
        const int v = tid & 31;
        for (int kt = nke; kt < nk; ++kt) {
          const int gs = gs0 + kt, st = gs % S;
          mbar_wait(full + st, (gs / S) & 1);
          const unsigned char* fs = As + st * T::A_BYTES + v * 16;
          signed char* q = Qs + ((kt - nke) % T::Q_SLOTS) * T::Q_BYTES;
#pragma unroll
          for (int row = tid >> 5; row < BM; row += 4 * NC)
            *reinterpret_cast<unsigned*>(
                q + row * BK + (((v >> 2) ^ (row & 7)) << 4) + (v & 3) * 4) =
                quantize4(*reinterpret_cast<const float4*>(fs + row * BK * 4),
                          rinv[row]);
          fence_proxy_async();
          bar_sync(1, 128 * NC);
          issue(acc_h, gs, q);
        }
      } else {
        direct(acc_e, nke, nk);
      }
      wgmma_wait<0>();
      fence_operands(acc_e);
      fence_operands(acc_h);
      mbar_arrive(empty + (gs0 + nk - 1) % S);

      // epilogue in registers: chunk j of the warpgroup's NW columns is
      // gate j % 4 of channels 8 * (j / 4) .. + 8, so a thread holds i, g,
      // f and o of its channels
      const int row0 = m_off + warp * 16 + (lane >> 2);
      const int dl = n_off / 4 + (lane & 3) * 2;  // channel within the tile
      const Unit& mine = un[wg / WGN];
      bool ok[2];
      const bf16* cpar[2];
      float rs[2];
      // K9: the embedding's gate rows of the background map and, inside
      // the 5x5 window of the row's id, of its deviation slab
      const bf16* bgp[2] = {nullptr, nullptr};
      const bf16* devp[2] = {nullptr, nullptr};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = row0 % 64 + 8 * half;
        ok[half] = l < mine.valid;
        const int m = ok[half] ? (int)mine.m0 + l : 0;
        const int r = m / HW, pix = m - r * HW;
        cpar[half] =
            g.c +
            ((long long)(g.parent_rows ? g.parent_rows[r] : r) * HW + pix) *
                D +
            d0;
        rs[half] = kDyn ? __fdiv_rn(g.r_p[m], 127.f) : 0.f;
        if constexpr (kBf) {
          if (g.emb_bg) {
            const int id = g.prev_ids[r];
            const int dy = pix / W - id / W + 2, dx = pix % W - id % W + 2;
            bgp[half] = g.emb_bg + (long long)pix * 4 * D;
            if (dy >= 0 && dy < 5 && dx >= 0 && dx < 5)
              devp[half] =
                  g.emb_dev + ((long long)id * 25 + dy * 5 + dx) * 4 * D;
          }
        }
      }
      // every c the thread needs, loaded before the math: each would
      // otherwise wait for memory on its own
      __nv_bfloat162 c_par[2][NW / 32];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int cg = 0; cg < NW / 32; ++cg)
          c_par[half][cg] = ok[half] ? *reinterpret_cast<const __nv_bfloat162*>(
                                           cpar[half] + dl + cg * 8)
                                     : __float2bfloat162_rn(0.f);
      // h' and c' of the tile go through shared memory so that the stores
      // to device memory are whole 16-byte rows
      unsigned char* o_h = Os;
      unsigned char* o_c = Os + BM * T::O_LD;
#pragma unroll
      for (int cg = 0; cg < NW / 32; ++cg) {
        const int d = d0 + dl + cg * 8;
        float te[4][2], tu[4][2], tb[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = u * D + d + e;
            te[u][e] = kBf ? 0.f : g.t_e[col];
            tu[u][e] = kDyn ? g.u_c[col] : 0.f;
            tb[u][e] = g.cell_b[col];
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 c_old = __bfloat1622float2(c_par[half][cg]);
          // K9's table entries of the thread's two channels, by pairs
          float dv[4][2] = {}, bg[4][2] = {};
          if constexpr (kBf) {
            if (bgp[half]) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float2 b2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(bgp[half] +
                                                             u * D + d));
                bg[u][0] = b2.x;
                bg[u][1] = b2.y;
                if (devp[half]) {
                  const float2 v2 = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(devp[half] +
                                                               u * D + d));
                  dv[u][0] = v2.x;
                  dv[u][1] = v2.y;
                }
              }
            }
          }
          float nh[2], nc[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float gt[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int idx = (4 * cg + u) * 4 + half * 2 + e;
              if constexpr (kDyn) {
                // the TPU kernel's order:
                // (acc_e * t_e + acc_h * (u_c * (r_p / 127))) + b
                const float ge = __fmul_rn((float)acc_e[idx], te[u][e]);
                const float gh = __fmul_rn((float)acc_h[idx],
                                           __fmul_rn(tu[u][e], rs[half]));
                gt[u] = __fadd_rn(__fadd_rn(ge, gh), tb[u][e]);
              } else if constexpr (kBf) {
                float a = acc_e[idx];
                if (bgp[half])  // K9: ((acc + dev) + bg) + b
                  a = __fadd_rn(__fadd_rn(a, dv[u][e]), bg[u][e]);
                gt[u] = __fadd_rn(a, tb[u][e]);
              } else {
                gt[u] = __fadd_rn(__fmul_rn((float)acc_e[idx], te[u][e]),
                                  tb[u][e]);
              }
            }
            // each product and sum rounded on its own, as the plain
            // version's separate tensor operations: an fma would move c'
            // where the two terms cancel
            nc[e] = __fadd_rn(
                __fmul_rn(sigmoid_rn(gt[2] + g.forget_bias),
                          e ? c_old.y : c_old.x),
                __fmul_rn(sigmoid_rn(gt[0]), tanhf(gt[1])));
            nh[e] = __fmul_rn(tanhf(nc[e]), sigmoid_rn(gt[3]));
          }
          const int o = (row0 + 8 * half) * T::O_LD + (dl + cg * 8) * 2;
          *reinterpret_cast<__nv_bfloat162*>(o_h + o) =
              __floats2bfloat162_rn(nh[0], nh[1]);
          *reinterpret_cast<__nv_bfloat162*>(o_c + o) =
              __floats2bfloat162_rn(nc[0], nc[1]);
        }
      }
      bar_sync(1, 128 * NC);
      constexpr int CHUNKS = DT * 2 / 16;  // 16-byte pieces of a tile row
      for (int i = tid; i < BM * CHUNKS; i += 128 * NC) {
        const int row = i / CHUNKS, ch = i % CHUNKS;
        const Unit& u = un[row / 64];
        if (row % 64 >= u.valid) continue;
        const long long at = (u.m0 + row % 64) * D + d0 + ch * 8;
        const int o = row * T::O_LD + ch * 16;
        *reinterpret_cast<int4*>(g.h_out + at) =
            *reinterpret_cast<const int4*>(o_h + o);
        *reinterpret_cast<int4*>(g.c_out + at) =
            *reinterpret_cast<const int4*>(o_c + o);
      }
      if (kPersist) bar_sync(1, 128 * NC);  // before the next tile's h'
    }
  }
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What a tensor map encodes, all of it: two equal keys give equal maps.
struct MapKey {
  const void* ptr;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  int type, rank, swizzle;
};

// Tensor map of `rank` dimensions (innermost first; byte strides of the
// outer ones), zeros outside the tensor. Encoded once per key: the last
// kMapCache maps are kept, so the weights' maps of a decode are encoded at
// its first step, and so is h2's wherever the allocator hands back the
// same address.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* ptr, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  constexpr int kMapCache = 32;
  static std::mutex lock;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int n_keys = 0, next = 0;
  MapKey key;
  std::memset(&key, 0, sizeof(key));
  key.ptr = ptr;
  key.type = (int)type;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_keys; ++i)
    if (std::memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return cudaSuccess;
    }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  n_keys = n_keys < kMapCache ? n_keys + 1 : kMapCache;
  return cudaSuccess;
}

// K-major weights [rows, K] of `op`'s type: boxes of 128 K bytes by
// box_rows rows, 128-byte swizzle
template <int OP>
cudaError_t weight_map(CUtensorMap* map, const void* w, int K, int rows,
                       int box_rows) {
  constexpr int es = OP == kBf16 ? 2 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * es};
  const cuuint32_t box[2] = {(cuuint32_t)(BK / es), (cuuint32_t)box_rows};
  return tensor_map(map,
                    OP == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    2, w, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// w_e: the embedding half's weights [4D, K_e]; w_h: the recurrent half's
// [4D, *], its first column at g.kb_rec; x: h2 (int8 or bf16) or h2_f (f32,
// K7), [NK, H, W, D].
template <int WGM, int WGN, int NW, int OP, int S, bool kPersist>
int launch_gate(const void* w_e, int K_e, const void* w_h, int K_h,
                const void* x, GateArgs g, cudaStream_t stream) {
  using T = GateTile<WGM, WGN, NW, OP, S, kPersist>;
  CUtensorMap map_we, map_wh, map_x;
  cudaError_t err = weight_map<OP>(&map_we, w_e, K_e, 4 * g.D, T::BN);
  if (err == cudaSuccess)
    err = weight_map<OP>(&map_wh, w_h, K_h, 4 * g.D, T::BN);
  if (err != cudaSuccess) return (int)err;
  // units of whole image rows take their recurrent A as boxes: 64 a
  // multiple of W, stages of KE whole channels of one tap
  const int xb = T::kDyn ? 4 : (int)sizeof(typename T::A);
  const int kx = T::kDyn ? BK : T::KE;  // channels of a stage
  g.upi = 0;
  map_x = map_wh;  // never read without boxes
  if (64 % g.W == 0 && g.D % kx == 0) {
    const int rows = 64 / g.W;
    const cuuint64_t dims[4] = {(cuuint64_t)g.D, (cuuint64_t)g.W,
                                (cuuint64_t)g.H, (cuuint64_t)g.NK};
    const cuuint64_t strides[3] = {(cuuint64_t)g.D * xb,
                                   (cuuint64_t)g.W * g.D * xb,
                                   (cuuint64_t)g.H * g.W * g.D * xb};
    const cuuint32_t box[4] = {(cuuint32_t)kx, (cuuint32_t)g.W,
                               (cuuint32_t)rows, 1};
    err = tensor_map(&map_x,
                     T::kDyn  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : T::kBf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     4, x, dims, strides, box,
                     T::kDyn ? CU_TENSOR_MAP_SWIZZLE_NONE
                             : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    g.upi = (g.H + rows - 1) / rows;
  }
  // pixel indices are ints in the kernel (no 64-bit division, a call)
  const long long M = (long long)g.NK * g.H * g.W;
  if (M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long units =
      g.upi > 0 ? (long long)g.NK * g.upi : (M + 63) / 64;
  const long long tiles = (units + WGM - 1) / WGM * (g.D / T::DT);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.n_tiles = (int)tiles;
  int blocks = g.n_tiles;  // persistent: one block an SM walks the tiles
  if (kPersist) {
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    blocks = blocks < sms ? blocks : sms;
  }
  auto kernel = gate_lstm_wgmma_kernel<WGM, WGN, NW, OP, S, kPersist>;
  static SmemAttr attr;
  err = attr.raise((const void*)kernel, (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, T::THREADS, T::SMEM, stream>>>(map_we, map_wh, map_x, g);
  return (int)cudaGetLastError();
}

}  // namespace
