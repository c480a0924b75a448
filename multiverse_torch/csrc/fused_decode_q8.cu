// Fused beam decode step of the int8 tiers for Hopper (sm_90a).
//
// Replaces the TPU kernels of multiverse_tpu/ops/pallas_decode.py
//   K2  decode_step_pallas_gathered_q8   ("int8": bf16 attention,
//       int8 x int8 -> int32 gate product)
//   K3  decode_step_pallas_gathered_q8a  ("int8a": the attention's two
//       products in int8 too, _gnn_attention_q8)
// (body _decode_kernel_gathered_q8), and
//   K7  decode_step_pallas_gathered_q8v2 ("int8_dyn", body
//       _decode_kernel_gathered_q8v2; see section 3 below).
// The structure is K1's (fused_decode.cu): an attention launch, an
// implicit-GEMM gate launch with the LSTM update in its epilogue, and
// K1's class readout launch.
//
//   1. The attention launch writes the int8 gate input
//      h2_q = clip(rint((h + agg) * 127/2), +-127) from the f32 sum.
//      K2 uses K1's bf16 attention (gnn_attention_kernel<kOutQ8> in
//      fused_decode.cu). K3 is gnn_attention_q8_kernel below: the node is
//      L2-normalised in f32 and quantised to rint(node * 127); edges are
//      the int32 dot products times the f32 constant 1/127^2; the softmax
//      over the nine neighbours runs in f32 (masked edges give exp = 0 in
//      the TPU kernel's dense softmax, so nine terms are exact); attn and
//      h are quantised to rint(* 127) (h clipped to +-127) and agg is
//      their int32 dot product times 1/127^2.
//      Bound: bytes (h and scene read, h2_q written: ~0.05 ms at 320 beam
//      rows, 18x32, D=256, C=64). A warp per pixel that normalised and
//      quantised each of its nine neighbours again spends its time on
//      instructions and L1/L2 latency, not bytes. So one block of 16 warps
//      takes a tile of up to 2 image rows by 32 pixels of one beam row,
//      stages the tile and its one-pixel halo in shared memory once
//      (node_q, D + C bytes, and h_q, D bytes, per pixel: each node
//      normalised and quantised once per block), then runs the nine edges
//      side by side as __dp4a int8 dot products and the aggregation as
//      integer MACs from shared memory.
//   2. gate_lstm_wgmma_kernel: M = NK*HW pixels, K = 9*(E+D), N = 4*D.
//      Bound: operations (~0.98 TOP of int8 at 320 rows, ~0.49 ms at the
//      H100's 1,979 TOP/s dense int8 peak, against ~0.5 GB of state
//      traffic). mma.sync cannot reach that rate; wgmma can. So:
//      * wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands K-major
//        in 128-byte-swizzled shared memory, issued by consumer
//        warpgroups. A is read from shared memory, not registers: the
//        producer or TMA writes it there in the swizzled layout, and K7's
//        quantised tile is shared by the two warpgroups of a block;
//      * K in two halves, the embedding rows of the nine taps and then the
//        recurrent ones (K7's split; K2/K3's weights reordered to match
//        when they are quantised, ops/quant.py), stages of 128 bytes never
//        straddling the halves;
//      * B by TMA: a tensor map over the weights ([4D, K] int8, K-major,
//        the gate rows interleaved by 8-channel chunks), SWIZZLE_128B, one
//        box per stage, completion on an mbarrier. cuTensorMapEncodeTiled
//        comes from libcuda through cudaGetDriverEntryPoint, so the
//        library needs no -lcuda;
//      * A of a recurrent stage, where 64 pixels are whole image rows of
//        one beam row (W divides 64, D % 128 = 0; the paths' 18x32), is a
//        TMA box of h2_q [NK, H, W, D] at the tap's offset, zero-filled
//        outside the grid: the hardware does the implicit im2col. The
//        embedding stages, and every stage of other shapes, are gathered
//        by a producer warpgroup with 16-byte cp.async vectors (no vector
//        straddles a tap: E % 16 = D % 32 = 0) straight into the swizzled
//        layout. The producer never waits for its copies: each thread's
//        cp.async.mbarrier.arrive marks the stage full once they land, and
//        the consumers fence them to the async proxy before wgmma;
//      * K2/K3: tiles of 128 pixels (two 64-pixel units, each its own
//        box) by 64 channels (256 gate columns) where D % 64 = 0, two
//        consumer warpgroups of 64 x 256, three stages of 48 KB; one
//        persistent block an SM walks the tiles, its producer filling the
//        next tile's stages while the consumers run the last one's
//        epilogue;
//      * the interleaved gate rows put i, g, f and o of a thread's
//        channels in its own accumulator registers, so the LSTM update
//        runs in registers: gates = acc * t_c + b, then the update, each
//        product and sum rounded on its own (__fmul_rn, __fadd_rn), as
//        the plain version's separate tensor operations round; h' and c'
//        leave through shared memory as whole 16-byte rows.
//      The int32 sums are exact, so with the same h2_q the gates equal
//      the plain version's.
//
// Rounding follows the TPU kernel: rint (half to even, as jnp.round),
// clip before the int8 cast, products by 63.5 and by the f32 constant
// 1/127^2 (never a division), each rounded on its own (__fmul_rn and
// __fadd_rn keep the compiler from contracting them into an fma).
//
//   3. K7 ("int8_dyn") splits the gate product into an embedding half
//      (9E deep, static table scales folded into w_eq, t_e) and a
//      recurrent half (9D deep) whose im2col rows are quantised by their
//      own 3x3 patch maximum r_p: ph_q = rint(patch * (127 / r_p)), no
//      clip, and gates = acc_e * t_e + acc_h * (u_c * (r_p / 127)) + b.
//      Three launches before K1's readout:
//      (a) K1's attention writing h + agg in f32 and each pixel's max
//          |h + agg| (gnn_attention_kernel<kOutF32> in fused_decode.cu);
//      (b) patch_max_kernel: r_p = max(3x3 max of the pixel maxima,
//          1e-6), equal to the patch max with its zero padding (max is
//          exact, and |.| >= 0);
//      (c) gate_lstm_wgmma_kernel<..., kDyn>: the same mainloop, the
//          embedding stages into acc_e, then the recurrent stages into
//          acc_h, each half's weights by its own tensor map. No int8 copy
//          of h2 can exist, since one h + agg value enters nine patch rows
//          at nine scales: a recurrent stage brings the neighbours' f32
//          h + agg (a TMA box of h2_f, or cp.async), and the consumers
//          quantise it from shared memory by 127 / r_p of the OUTPUT pixel
//          (IEEE division, never a reciprocal approximation, so ties land
//          where the TPU kernel's do; the rounding is an FADD of 1.5 * 2^23,
//          not a cvt, which the SM issues at an eighth of the rate) into
//          the swizzled int8 tile. Two accumulators of 64 x 128 per
//          warpgroup fit the registers, so a block is 64 pixels by 64
//          channels, one consumer warpgroup per 32 channels, three stages
//          of 64 KB.
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launch.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr float kQ8Scale = (float)(1.0 / (127.0 * 127.0));

// rint(x * inv * 127): a normalised node channel in int8 units.
__device__ __forceinline__ int quantize_node(float x, float inv) {
  return __float2int_rn(__fmul_rn(__fmul_rn(x, inv), 127.f));
}

// clip(rint(h * 127), +-127)
__device__ __forceinline__ int quantize_h(float x) {
  return min(max(__float2int_rn(__fmul_rn(x, 127.f)), -127), 127);
}

__device__ __forceinline__ char2 char2_of(int a, int b) {
  return make_char2((signed char)a, (signed char)b);
}

// byte b of a word as a signed int
__device__ __forceinline__ int sbyte(int w, int b) {
  return (w << (24 - 8 * b)) >> 24;
}

// ------------------------------------------------------- 1. K3 attention

constexpr int ATTN_THREADS = 512;
constexpr int ATTN_WARPS = ATTN_THREADS / 32;

// node_q row bytes in shared memory: D + C zero-padded to 16
__host__ __device__ __forceinline__ int node_bytes(int D, int C) {
  return (D + C + 15) & ~15;
}

__host__ __device__ __forceinline__ size_t attn_smem(int BR, int BW, int D,
                                                     int C) {
  return (size_t)(BR + 2) * (BW + 2) * (node_bytes(D, C) + D);
}

// One block per (beam row, BR x BW tile of pixels).
__global__ void __launch_bounds__(ATTN_THREADS)
gnn_attention_q8_kernel(const int* __restrict__ parent_rows,
                        const bf16* __restrict__ h,      // [*, HW, D] old
                        const bf16* __restrict__ scene,  // [NK, HW, C] / null
                        signed char* __restrict__ h2q,   // [NK, HW, D] new
                        int H, int W, int D, int C, int BR, int BW,
                        int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NQ = node_bytes(D, C);
  const int HC = BW + 2, HP = (BR + 2) * HC;
  signed char* nq = reinterpret_cast<signed char*>(smem);  // [HP, NQ]
  signed char* hq = nq + (size_t)HP * NQ;                  // [HP, D]

  const int HW = H * W;
  const int tiles = tiles_y * tiles_x;
  const int r = blockIdx.x / tiles;
  const int t = blockIdx.x - r * tiles;
  const int y0 = (t / tiles_x) * BR, x0 = (t % tiles_x) * BW;
  const bf16* hrow = h + (long long)parent_rows[r] * HW * D;
  const bf16* srow = scene ? scene + (long long)r * HW * C : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage the tile and its halo: each node normalised and quantised once
  for (int hp = warp; hp < HP; hp += ATTN_WARPS) {
    const int yy = y0 - 1 + hp / HC, xx = x0 - 1 + hp % HC;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // never read
    const int q = yy * W + xx;
    const bf16* hp_ = hrow + (long long)q * D;
    const bf16* sp_ = srow ? srow + (long long)q * C : nullptr;
    const float inv =
        1.0f / sqrtf(fmaxf(node_sumsq(hp_, sp_, D, C, lane), 1e-12f));
    signed char* nrow = nq + (size_t)hp * NQ;
    signed char* hrow_q = hq + (size_t)hp * D;
    for (int k = 2 * lane; k < D; k += 64) {
      const float2 v = load_bf16x2(hp_ + k);
      *reinterpret_cast<char2*>(nrow + k) =
          char2_of(quantize_node(v.x, inv), quantize_node(v.y, inv));
      *reinterpret_cast<char2*>(hrow_q + k) =
          char2_of(quantize_h(v.x), quantize_h(v.y));
    }
    for (int k = 2 * lane; k < C; k += 64) {
      const float2 v = load_bf16x2(sp_ + k);
      *reinterpret_cast<char2*>(nrow + D + k) =
          char2_of(quantize_node(v.x, inv), quantize_node(v.y, inv));
    }
    for (int k = D + C + lane; k < NQ; k += 32) nrow[k] = 0;
  }
  __syncthreads();

  for (int o = warp; o < BR * BW; o += ATTN_WARPS) {
    const int y = y0 + o / BW, x = x0 + o % BW;
    if (y >= H || x >= W) continue;
    const int hc = (o / BW + 1) * HC + o % BW + 1;  // halo index of (y, x)
    int hn[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
      hn[s] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? hc + (s / 3 - 1) * HC + (s % 3 - 1)
                  : -1;
    }
    // the nine dot products side by side, with no branch, so that their
    // loads and reductions overlap (a neighbour outside the grid reads
    // the pixel's own row and is masked below)
    const int* self = reinterpret_cast<const int*>(nq + (size_t)hc * NQ);
    const int* other[9];
#pragma unroll
    for (int s = 0; s < 9; ++s)
      other[s] = reinterpret_cast<const int*>(
          nq + (size_t)(hn[s] < 0 ? hc : hn[s]) * NQ);
    int dot[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) dot[s] = 0;
    for (int w = lane; w < NQ / 4; w += 32) {
      const int a = self[w];
#pragma unroll
      for (int s = 0; s < 9; ++s) dot[s] = __dp4a(a, other[s][w], dot[s]);
    }
    float e[9];
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      e[s] = __fmul_rn((float)warp_sum(dot[s]), kQ8Scale);
      if (hn[s] >= 0) m = fmaxf(m, e[s]);
    }
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (hn[s] < 0) continue;
      e[s] = expf(e[s] - m);
      total += e[s];
    }
    int attn_q[9];
#pragma unroll
    for (int s = 0; s < 9; ++s)
      attn_q[s] = hn[s] < 0 ? 0
                            : __float2int_rn(
                                  __fmul_rn(__fdiv_rn(e[s], total), 127.f));

    const int p = y * W + x;
    const bf16* own = hrow + (long long)p * D;
    int* out = reinterpret_cast<int*>(h2q + ((long long)r * HW + p) * D);
    for (int w = lane; w < D / 4; w += 32) {
      int a[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        if (hn[s] < 0) continue;
        const int v =
            reinterpret_cast<const int*>(hq + (size_t)hn[s] * D)[w];
#pragma unroll
        for (int b = 0; b < 4; ++b) a[b] += attn_q[s] * sbyte(v, b);
      }
      const float2 h01 = load_bf16x2(own + 4 * w);
      const float2 h23 = load_bf16x2(own + 4 * w + 2);
      const float hv[4] = {h01.x, h01.y, h23.x, h23.y};
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= (unsigned)(unsigned char)quantize_h2(
                    __fadd_rn(hv[b], __fmul_rn((float)a[b], kQ8Scale)))
                << (8 * b);
      out[w] = (int)word;
    }
  }
}

// ------------------------------------------ 2. gates + LSTM on wgmma s8

constexpr int BK = 128;    // K bytes per stage: one 128-byte swizzle row

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

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
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

// wgmma matrix descriptor of a K-major tile with 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart; the tile starts 1024-aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// D (64 x 256 s32, in registers) += A (64 x 32 s8) * B (256 x 32 s8)^T,
// both read from 128-byte-swizzled K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b));
}

// D (64 x 128 s32, in registers) += A (64 x 32 s8) * B (128 x 32 s8)^T,
// both read from 128-byte-swizzled K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b));
}

template <int NW>
__device__ __forceinline__ void wgmma_s8(int (&d)[NW / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (NW == 256)
    wgmma_s8_n256(d, a, b);
  else
    wgmma_s8_n128(d, a, b);
}

// The operands of one gate launch (K2/K3: h2q and t_c in t_e, no u_c; K7:
// h2f, r_p, t_e and u_c).
struct GateArgs {
  const int* prev_ids;
  const int* parent_rows;
  const signed char* emb_q;  // [HW, HW, E]
  const signed char* h2q;    // [NK, HW, D] (K2, K3)
  const float* h2f;          // [NK, HW, D] (K7)
  const float* r_p;          // [NK * HW]   (K7)
  const bf16* c;             // [*, HW, D] old beam order
  const float* t_e;          // [4D] scales of acc (K2, K3) or of acc_e (K7)
  const float* u_c;          // [4D] (K7)
  const float* cell_b;       // [4D]
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
    a.r = (int)(u / g.upi);
    a.y0 = (int)(u % g.upi) * (64 / g.W);
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
// takes one tile. S stages, each of A (BM x 128 int8, or for K7 the f32
// rows of a recurrent stage, BM x 128 f32) and B (BN x 128 int8), in the
// order the tiles consume them. K7's quantised recurrent A tiles go round
// a ring of 3: a warpgroup writes slot j only after every consumer passed
// the barrier of stage j - 1, so after both warpgroups' wgmma of stage
// j - 3 completed.
template <int WGM, int WGN, int NW, bool kDyn, int S, bool kPersist>
struct GateTile {
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
// taps (9E deep), then the recurrent rows (9D deep), stages of 128 never
// straddling the two. K2/K3 sum both into one accumulator; K7 into acc_e
// and acc_h. An embedding stage's A is gathered by the producer
// warpgroup. A recurrent stage's A, where a tile is whole image rows of
// one beam row (upi > 0), is one TMA box of h2_q (K7: of the f32 h2_f) at
// the tap's offset, zero-filled outside the grid, one box a unit;
// otherwise the producer gathers it too.
template <int WGM, int WGN, int NW, bool kDyn, int S, bool kPersist>
__global__ void __launch_bounds__(128 * (WGM * WGN + 1), 1)
gate_lstm_wgmma_kernel(const __grid_constant__ CUtensorMap map_we,
                       const __grid_constant__ CUtensorMap map_wh,
                       const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ GateArgs g) {
  using T = GateTile<WGM, WGN, NW, kDyn, S, kPersist>;
  constexpr int BM = T::BM, DT = T::DT, NC = T::NC;
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
    const long long mm = ok ? u.m0 + i % 64 : 0;
    const int r = (int)(mm / HW), p = (int)(mm - (long long)r * HW);
    ry[i] = ok ? p / W : -4;
    rx[i] = p % W;
    eoff[i] = (long long)g.prev_ids[r] * HW * E;
    hoff[i] = (long long)r * HW * D;
    if constexpr (kDyn) rinv[i] = ok ? __fdiv_rn(127.f, g.r_p[mm]) : 0.f;
  };
  const int nke = (9 * E + BK - 1) / BK;
  const int nk = nke + (9 * D + BK - 1) / BK;
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

    // the swizzled int8 A tile of im2col rows of `src` (Cw channels a
    // pixel, rows at off[row]): 16 bytes of row `row`, chunk j
    auto gather_s8 = [&](int st, int kl, int Cw, const signed char* src0,
                         const long long* off) {
      const int j = p & 7, rsub = p >> 3;
      const int k = kl * BK + 16 * j;
      const bool kok = k < 9 * Cw;
      const int s = kok ? k / Cw : 0, ch = k - s * Cw;
      const int dy = s / 3 - 1, dx = s % 3 - 1;
      unsigned char* as = As + st * T::A_BYTES + ((j ^ (rsub & 7)) << 4);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int row = rsub + 16 * i;
        const int yy = ry[row] + dy, xx = rx[row] + dx;
        const bool ok = kok && yy >= 0 && yy < H && xx >= 0 && xx < W;
        const signed char* src =
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
                      full + st, (first ? 0 : g.kb_rec) + kl * BK, 4 * d0);
          if (a_box) {
            // each unit's image rows shifted by the stage's tap: channels
            // ch .. ch + 127 of pixels (y0 + dy - 1 .., dx - 1 ..); an
            // empty unit's rows are never stored
            const int s = kl * BK / D, ch = kl * BK - s * D;
#pragma unroll
            for (int w = 0; w < WGM; ++w)
              if (un[w].valid > 0)
                tma_load_4d(As + st * T::A_BYTES + w * (T::A_BYTES / WGM),
                            &map_x, full + st, ch, s % 3 - 1,
                            un[w].y0 + s / 3 - 1, un[w].r);
          }
        }
        if (first)
          gather_s8(st, kl, E, g.emb_q, eoff);
        else if (!a_box) {
          if constexpr (kDyn)
            gather_f32(st, kl);
          else
            gather_s8(st, kl, D, g.h2q, hoff);
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
    int acc_e[NW / 2], acc_h[kDyn ? NW / 2 : 1];
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
        wgmma_s8<NW>(acc, da + 2 * kk, db + 2 * kk);
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
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = row0 % 64 + 8 * half;
        ok[half] = l < mine.valid;
        const long long m = ok[half] ? mine.m0 + l : 0;
        const int r = (int)(m / HW), pix = (int)(m - (long long)r * HW);
        cpar[half] = g.c + ((long long)g.parent_rows[r] * HW + pix) * D + d0;
        rs[half] = kDyn ? __fdiv_rn(g.r_p[m], 127.f) : 0.f;
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
            te[u][e] = g.t_e[col];
            tu[u][e] = kDyn ? g.u_c[col] : 0.f;
            tb[u][e] = g.cell_b[col];
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 c_old = __bfloat1622float2(c_par[half][cg]);
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

// Tensor map of `rank` dimensions (innermost first; byte strides of the
// outer ones), zeros outside the tensor.
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* ptr, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K-major int8 weights [rows, K]: boxes of 128 K bytes by box_rows rows,
// 128-byte swizzle
cudaError_t weight_map(CUtensorMap* map, const void* w, int K, int rows,
                       int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// w_e: the embedding half's weights [4D, K_e]; w_h: the recurrent half's
// [4D, *], its first column at kb_rec; x: h2_q (int8) or h2_f (f32,
// kDyn), [NK, H, W, D].
template <int WGM, int WGN, int NW, bool kDyn, int S, bool kPersist>
int launch_gate(const void* w_e, int K_e, const void* w_h, int K_h,
                const void* x, GateArgs g, cudaStream_t stream) {
  using T = GateTile<WGM, WGN, NW, kDyn, S, kPersist>;
  CUtensorMap map_we, map_wh, map_x;
  cudaError_t err = weight_map(&map_we, w_e, K_e, 4 * g.D, T::BN);
  if (err == cudaSuccess) err = weight_map(&map_wh, w_h, K_h, 4 * g.D, T::BN);
  if (err != cudaSuccess) return (int)err;
  // units of whole image rows take their recurrent A as boxes: 64 a
  // multiple of W, stages of 128 whole channels of one tap
  const int xb = kDyn ? 4 : 1;
  g.upi = 0;
  map_x = map_wh;  // never read without boxes
  if (64 % g.W == 0 && g.D % BK == 0) {
    const int rows = 64 / g.W;
    const cuuint64_t dims[4] = {(cuuint64_t)g.D, (cuuint64_t)g.W,
                                (cuuint64_t)g.H, (cuuint64_t)g.NK};
    const cuuint64_t strides[3] = {(cuuint64_t)g.D * xb,
                                   (cuuint64_t)g.W * g.D * xb,
                                   (cuuint64_t)g.H * g.W * g.D * xb};
    const cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)g.W,
                               (cuuint32_t)rows, 1};
    err = tensor_map(&map_x,
                     kDyn ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     4, x, dims, strides, box,
                     kDyn ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    g.upi = (g.H + rows - 1) / rows;
  }
  const long long M = (long long)g.NK * g.H * g.W;
  const long long units =
      g.upi > 0 ? (long long)g.NK * g.upi : (M + 63) / 64;
  const long long tiles = (units + WGM - 1) / WGM * (g.D / T::DT);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  g.n_tiles = (int)tiles;
  int blocks = g.n_tiles;  // persistent: one block an SM walks the tiles
  if (kPersist) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    blocks = blocks < sms ? blocks : sms;
  }
  auto kernel = gate_lstm_wgmma_kernel<WGM, WGN, NW, kDyn, S, kPersist>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, T::THREADS, T::SMEM, stream>>>(map_we, map_wh, map_x, g);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ 3. K7 (int8_dyn)

// r_p[m] = max(max over the in-grid 3x3 neighbours q of pix_max[q], 1e-6):
// the max |.| of pixel m's im2col row, zero padding included.
__global__ void __launch_bounds__(256)
patch_max_kernel(const float* __restrict__ pix_max,  // [NK, HW]
                 float* __restrict__ r_p,            // [NK, HW]
                 int NK, int H, int W) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (item >= (long long)NK * HW) return;
  const long long base = item - item % HW;
  const int p = (int)(item - base);
  int q[9];
  neighbours(p / W, p % W, H, W, q);
  float m = 0.f;
#pragma unroll
  for (int s = 0; s < 9; ++s)
    if (q[s] >= 0) m = fmaxf(m, pix_max[base + q[s]]);
  r_p[item] = fmaxf(m, 1e-6f);
}

}  // namespace

extern "C" {

int mv_gnn_attention_q8(const int* parent_rows, const void* h,
                        const void* scene, void* h2q, int NK, int H, int W,
                        int D, int C, void* stream) {
  // a tile of up to 2 image rows by 32 columns, narrower where its halo
  // would not fit in shared memory
  constexpr size_t kMaxSmem = 200 * 1024;
  int BR = H < 2 ? H : 2, BW = W < 32 ? W : 32;
  while (attn_smem(BR, BW, D, C) > kMaxSmem && (BR > 1 || BW > 1)) {
    if (BR > 1)
      BR = 1;
    else
      BW = (BW + 1) / 2;
  }
  const size_t smem = attn_smem(BR, BW, D, C);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gnn_attention_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + BR - 1) / BR, tiles_x = (W + BW - 1) / BW;
  gnn_attention_q8_kernel<<<(unsigned)((long long)NK * tiles_y * tiles_x),
                            ATTN_THREADS, smem, (cudaStream_t)stream>>>(
      parent_rows, (const bf16*)h, (const bf16*)scene, (signed char*)h2q, H,
      W, D, C, BR, BW, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

int mv_gate_lstm_q8(const int* prev_ids, const int* parent_rows,
                    const void* emb_q, const void* h2q, const void* c,
                    const void* w_qt, const float* t_c, const float* cell_b,
                    void* h_out, void* c_out, int NK, int H, int W, int D,
                    int E, float forget_bias, void* stream) {
  // w_qt's K columns: the 9E embedding rows, then the 9D recurrent ones
  const GateArgs g{prev_ids, parent_rows, (const signed char*)emb_q,
                   (const signed char*)h2q, nullptr, nullptr, (const bf16*)c,
                   t_c, nullptr, cell_b, (bf16*)h_out, (bf16*)c_out, NK, H, W,
                   D, E, forget_bias, 9 * E, 0, 0};
  const int K = 9 * (E + D);
  if (D % 64 == 0)
    return launch_gate<2, 1, 256, false, 3, true>(w_qt, K, w_qt, K, h2q, g,
                                                  (cudaStream_t)stream);
  return launch_gate<2, 1, 128, false, 4, true>(w_qt, K, w_qt, K, h2q, g,
                                                (cudaStream_t)stream);
}

int mv_patch_max(const float* pix_max, float* r_p, int NK, int H, int W,
                 void* stream) {
  const long long items = (long long)NK * H * W;
  patch_max_kernel<<<(unsigned)((items + 255) / 256), 256, 0,
                     (cudaStream_t)stream>>>(pix_max, r_p, NK, H, W);
  return (int)cudaGetLastError();
}

int mv_gate_lstm_q8dyn(const int* prev_ids, const int* parent_rows,
                       const void* emb_q, const float* h2f, const float* r_p,
                       const void* c, const void* w_eqt, const float* t_e,
                       const void* w_hqt, const float* u_c,
                       const float* cell_b, void* h_out, void* c_out, int NK,
                       int H, int W, int D, int E, float forget_bias,
                       void* stream) {
  const GateArgs g{prev_ids, parent_rows, (const signed char*)emb_q, nullptr,
                   h2f, r_p, (const bf16*)c, t_e, u_c, cell_b, (bf16*)h_out,
                   (bf16*)c_out, NK, H, W, D, E, forget_bias, 0, 0, 0};
  // with no embedding half (E = 0) the first map is never read
  const void* w_e = E > 0 ? w_eqt : w_hqt;
  const int K_e = E > 0 ? 9 * E : 9 * D;
  if (D % 64 == 0)
    return launch_gate<1, 2, 128, true, 3, false>(w_e, K_e, w_hqt, 9 * D, h2f,
                                                  g, (cudaStream_t)stream);
  return launch_gate<1, 1, 128, true, 3, false>(w_e, K_e, w_hqt, 9 * D, h2f,
                                                g, (cudaStream_t)stream);
}

}  // extern "C"
