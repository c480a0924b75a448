// Fused decode step for Hopper (sm_90a): GNN attention on the parent's
// hidden state, the 3x3 ConvLSTM gate conv over
// [emb_table[id] (+) h + agg] with the LSTM update fused into its
// epilogue, and the 3x3 single-channel class readout.
//
// Replaces these TPU kernels of multiverse_tpu/ops/pallas_decode.py and
// pallas_cell.py. Same math and the same rounding points as each; a
// different block structure, shared by all of them:
//
//   K1  decode_step_pallas_gathered (body _decode_kernel): the beam
//       step, parents and previous-cell ids read through parent_rows and
//       prev_ids;
//   K8  decode_step_pallas: K1 with identity parents and one embedding
//       row per state row (parent_rows and prev_ids null, emb the
//       [N*HW, E] rows);
//   K9  decode_step_pallas_v2 (body _decode_kernel_v2): K8 whose gate
//       product runs over the h half only (E = 0, K = 9D); the
//       embedding's gate contribution is added in the epilogue from a
//       background map and a 5x5 deviation slab per id. The TPU kernel's
//       corner-seed-and-roll placement is a Mosaic workaround: here each
//       output pixel reads its slab entry directly;
//   K6  convlstm_step_pallas (pallas_cell.py, body _cell_kernel): the
//       ConvLSTM cell alone, the gate launch over [x (+) h] with per-row
//       x and c and no attention or readout.
//
//   1. gnn_attention_kernel   the cosine attention over each pixel's 3x3
//      neighbourhood of [h (+) scene]. The TPU kernel forms the dense
//      [HW, HW] edge tile (1.3 MB in f32 at 18x32), far beyond a block's
//      227 KB of shared memory. The mask is the 3x3 neighbourhood and
//      exp(-1e30) is 0 in f32, so the softmax over the 9 neighbours is
//      exact. Bound: bytes (h and scene read, the output written: ~0.063
//      ms at 320 beam rows, 18x32, D=256, C=64, bf16 out). Each pixel's
//      row is read by nine pixels, three times by each (norm, dot,
//      aggregation), so the time goes to instructions and latency, not to
//      bytes. The design:
//      - the grid: one block of 16 warps per resident slot (two an SM),
//        each walking an equal share of the image rows in runs down one
//        beam row (and column tile), so no wave of the grid runs short;
//      - copies: rows roll through a ring of four raw h rows; row t + 3's h
//        and scene are in flight (16-byte cp.async) while row t computes,
//        and each row is read from device memory once per run;
//      - normalisation: each staged pixel's node round_bf16(x * inv) once,
//        into a ring of two rows, which each of its nine dots reads as it
//        is;
//      - edges: each edge once for both its pixels (self, east and the
//        three down to the next row; a pixel's other four are its
//        neighbours'), two columns a warp;
//      - softmax: nine lanes a pixel; aggregation: 8-byte loads, each
//        loaded row serving both pixels of the warp, and a tap outside the
//        grid weighing -0 on a zero row or column, so no tap is tested.
//      Every sum runs in a fixed order, whatever the grid: lane l takes the
//      channel pairs 2l + 64i of a node and the warp's butterfly reduces
//      them (node_sumsq's order; the gates on K2's h2_q and K7's h2_f were
//      set on sums in that order), the softmax and each channel's
//      aggregation run in tap order.
//      Writes h2 = bf16(h + agg) (K1, K8, K9); the int8 tier
//      (fused_decode_q8.cu) takes the same launch with the int8 gate input
//      quantize_h2(h + agg) as its output, the int8_dyn tier with h + agg
//      in f32 and each pixel's max |h + agg|.
//   2. The gate launch: gate_lstm_wgmma_kernel of gate_wgmma.cuh, bf16 x
//      bf16 -> f32 (m64nNk16), gates = acc + b (K9: ((acc + dev) + bg) +
//      b), then the LSTM update in registers. Bound: operations (~0.98
//      TFLOP at 320 rows, ~0.99 ms at the bf16 peak; K9 11% fewer, K6 at
//      the training encoder's shape ~68 GFLOP).
//   3. class_readout_kernel   the TPU kernel's channel-first form: one
//      block per (beam row, band of image rows) computes the nine tap
//      partials P[q, s] = h'[q] . w_s of the band and its one-row halo,
//      reading each h' row once (8 lanes a pixel, four pixels a weight
//      read: a 16-byte shared load is served a quarter-warp at a time),
//      into shared memory, then
//      logits[y, x] = sum_s P[y + dy_s, x + dx_s, s] in tap order. Bound:
//      bytes (h' read once: ~0.028 ms at 320 rows).
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launch.

#include "gate_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- 1. GNN

constexpr int ATTN_THREADS = 512;
constexpr int ATTN_WARPS = ATTN_THREADS / 32;
// each warp takes two image columns of a row in every phase, so a tile is
// at most 32 output columns wide
constexpr int ATTN_MAX_BW = 2 * ATTN_WARPS;
constexpr size_t ATTN_MAX_SMEM = 227 * 1024;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared memory of a block whose tile stages SC image columns (byte
// offsets; the raw ring first):
//   raw   [4][SC + 1][D]  bf16  h of image rows t - 1 .. t + 2, row j in
//                               slot j & 3; column SC stays zero
//   norm  [2][SC][D + C]  bf16  the normalised node round_bf16(x * inv)
//                               of rows t and t + 1, row j in slot j & 1
//   land  [SC][C]         bf16  the scene of the row in flight
//   se    [SC][2]         f32   row t's self and east edges
//   dn    [2][SC][3]      f32   the edges from row j down to row j + 1
//                               (dx = -1, 0, 1), row j in slot j & 1
struct AttnLayout {
  size_t norm, land, se, dn, bytes;
  __host__ __device__ AttnLayout(int SC, int D, int C) {
    norm = align16((size_t)4 * (SC + 1) * D * 2);
    land = norm + align16((size_t)2 * SC * (D + C) * 2);
    se = land + align16((size_t)SC * C * 2);
    dn = se + (size_t)SC * 2 * 4;
    bytes = dn + (size_t)2 * SC * 3 * 4;
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 4 : 0;  // 0 bytes read: the 4 bytes are zeroed
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// a bf16 pair read as one 32-bit word, both values exact in f32 (two
// integer instructions, where __bfloat1622float2 takes three)
__device__ __forceinline__ float2 bf16x2_bits(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return bf16x2_bits(*reinterpret_cast<const unsigned*>(p));
}

// What the attention launch writes for each (row, pixel, channel):
enum AttnOut {
  kOutBf16 = 0,  // K1, K8, K9: h2 = bf16(h + agg)
  kOutQ8 = 1,    // the int8 tier (K2): the gate input quantize_h2(h + agg)
                 // from the f32 sum, never from a bf16 copy
  kOutF32 = 2,   // the int8_dyn tier (K7): h + agg in f32, and the
                 // pixel's max |h + agg| over its D channels in pix_max
};

// The block walks its share of the NK * tiles_x * H image rows (beam row,
// column tile, image row; image rows fastest) in runs, each within one
// (beam row, tile); parent_rows null: identity parents (row r reads state
// row r).
template <int kOut>
__global__ void __launch_bounds__(ATTN_THREADS, 2)
gnn_attention_kernel(const int* __restrict__ parent_rows,
                     const bf16* __restrict__ h,      // [*, HW, D] old order
                     const bf16* __restrict__ scene,  // [NK, HW, C] or null
                     void* __restrict__ h2,           // [NK, HW, D] new order
                     float* __restrict__ pix_max,     // [NK, HW], kOutF32
                     int H, int W, int D, int C, int BW, int tiles_x,
                     long long rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SCM = min(W, BW + 2), NC = D + C;
  const AttnLayout L(SCM, D, C);
  bf16* raw = reinterpret_cast<bf16*>(smem);
  bf16* norm = reinterpret_cast<bf16*>(smem + L.norm);
  bf16* land = reinterpret_cast<bf16*>(smem + L.land);
  float* se = reinterpret_cast<float*>(smem + L.se);
  float* dnb = reinterpret_cast<float*>(smem + L.dn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HW = H * W;
  auto raw_row = [&](int j) {
    return raw + (size_t)(j & 3) * (SCM + 1) * D;
  };
  // the zero column of each raw slot: a tap outside the grid reads it
  for (int i = threadIdx.x; i < 4 * D / 8; i += ATTN_THREADS)
    *reinterpret_cast<uint4*>(raw_row(i / (D / 8)) + SCM * D +
                              8 * (i % (D / 8))) = make_uint4(0, 0, 0, 0);
  auto norm_row = [&](int j) { return norm + (size_t)(j & 1) * SCM * NC; };

  const long long g1 = rows * (blockIdx.x + 1) / gridDim.x;
  for (long long g = rows * blockIdx.x / gridDim.x; g < g1;) {
    const long long run = g / H;  // (beam row, tile)
    const int y0 = (int)(g - run * H);
    const int ye = (int)min((long long)H, y0 + (g1 - g));
    g += ye - y0;
    const int r = (int)(run / tiles_x);
    const int x0 = (int)(run - (long long)r * tiles_x) * BW;
    const int xs = max(x0 - 1, 0), SC = min(x0 + BW + 1, W) - xs;
    const int ox = x0 - xs, BWt = min(BW, W - x0);
    const bf16* hrow =
        h + (long long)(parent_rows ? parent_rows[r] : r) * HW * D;
    const bf16* srow = scene ? scene + (long long)r * HW * C : hrow;

    // image row j's h into its raw slot and its scene into sdst (pixel
    // stride ss); a row outside the grid is zeroed. The warp that copies
    // a column is the one that normalises it, so a warp waits only for
    // its own copies.
    auto stage = [&](int j, bf16* sdst, int ss) {
      const bool in = j >= 0 && j < H;
      const long long q0 = in ? (long long)j * W + xs : 0;
      const bf16* hg = hrow + q0 * D;
      const bf16* sg = srow + q0 * C;
      bf16* rdst = raw_row(j);
      for (int c = warp; c < SC; c += ATTN_WARPS) {
        for (int v = 8 * lane; v < D; v += 256)
          cp_async16(rdst + c * D + v, hg + c * D + v, in);
        if (C % 8 == 0) {
          for (int v = 8 * lane; v < C; v += 256)
            cp_async16(sdst + c * ss + v, sg + c * C + v, in);
        } else {
          for (int v = 2 * lane; v < C; v += 64)
            cp_async4(sdst + c * ss + v, sg + c * C + v, in);
        }
      }
    };
    // row j's node normalised once: inv as node_sumsq sums it, then each
    // value round_bf16(x * inv), exactly what every neighbour's dot
    // reads; the scene is read from ssrc (pixel stride ss), in place when
    // it lies in the node's own slot
    auto normalise = [&](int j, const bf16* ssrc, int ss) {
      // the warp's columns c and c + ATTN_WARPS side by side, their sums
      // independent (a lone last column is taken twice, written once)
      for (int c = warp; c < SC; c += 2 * ATTN_WARPS) {
        const bool two = c + ATTN_WARPS < SC;
        const int cq[2] = {c, two ? c + ATTN_WARPS : c};
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bf16* hq = raw_row(j) + cq[q] * D;
          const bf16* sq = ssrc + cq[q] * ss;
#pragma unroll 4
          for (int k = 2 * lane; k < D; k += 64) {
            const float2 v = bf16x2_at(hq + k);
            sum[q] += v.x * v.x + v.y * v.y;
          }
#pragma unroll 1
          for (int k = 2 * lane; k < C; k += 64) {
            const float2 v = bf16x2_at(sq + k);
            sum[q] += v.x * v.x + v.y * v.y;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !two) break;
          const float inv = rsqrtf(fmaxf(sum[q], 1e-12f));
          const bf16* hq = raw_row(j) + cq[q] * D;
          const bf16* sq = ssrc + cq[q] * ss;
          bf16* nq = norm_row(j) + cq[q] * NC;
#pragma unroll 4
          for (int k = 2 * lane; k < D; k += 64) {
            const float2 a = bf16x2_at(hq + k);
            *reinterpret_cast<__nv_bfloat162*>(nq + k) =
                __floats2bfloat162_rn(a.x * inv, a.y * inv);
          }
#pragma unroll 1
          for (int k = 2 * lane; k < C; k += 64) {
            const float2 a = bf16x2_at(sq + k);
            *reinterpret_cast<__nv_bfloat162*>(nq + D + k) =
                __floats2bfloat162_rn(a.x * inv, a.y * inv);
          }
        }
      }
    };
    // row t's edges, each computed once for both its pixels: self, east,
    // and down to row t + 1. A warp takes two columns; lane l sums the
    // channel pairs 2l + 64i as node_sumsq does, then the warp's
    // butterfly: its first level leaves the left column's five sums in
    // lanes 0-15 and the right column's in lanes 16-31, the other four
    // levels reduce both halves at once, so each sum is added in the
    // order warp_sum adds it.
    auto edges = [&](int t) {
      const bf16* n0 = norm_row(t) + 2 * lane;
      const bf16* n1 = norm_row(t + 1) + 2 * lane;
      float* dn = dnb + (t & 1) * SCM * 3;
      for (int c0 = 2 * warp; c0 < SC; c0 += 2 * ATTN_WARPS) {
        // a neighbour column outside the tile is clamped into it: its
        // edge is never read
        int ca[3], cb[4];
#pragma unroll
        for (int i = 0; i < 3; ++i) ca[i] = min(c0 + i, SC - 1) * NC;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cb[i] = min(max(c0 - 1 + i, 0), SC - 1) * NC;
        float v[2][5];  // self, east, down-left, down, down-right
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int s = 0; s < 5; ++s) v[p][s] = 0.f;
        auto dots = [&](const bf16* r0, const bf16* r1, int n) {
          for (int k = 2 * lane; k < n; k += 64, r0 += 64, r1 += 64) {
            float2 a[3], b[4];
#pragma unroll
            for (int i = 0; i < 3; ++i) a[i] = bf16x2_at(r0 + ca[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) b[i] = bf16x2_at(r1 + cb[i]);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              v[p][0] += a[p].x * a[p].x + a[p].y * a[p].y;
              v[p][1] += a[p].x * a[p + 1].x + a[p].y * a[p + 1].y;
#pragma unroll
              for (int d = 0; d < 3; ++d)
                v[p][2 + d] += a[p].x * b[p + d].x + a[p].y * b[p + d].y;
            }
          }
        };
        dots(n0, n1, D);
        dots(n0 + D, n1 + D, C);
        const bool right = lane >= 16;
        float e[5];
#pragma unroll
        for (int s = 0; s < 5; ++s)
          e[s] = (right ? v[1][s] : v[0][s]) +
                 __shfl_xor_sync(0xffffffffu, right ? v[0][s] : v[1][s], 16);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
#pragma unroll
          for (int s = 0; s < 5; ++s)
            e[s] += __shfl_xor_sync(0xffffffffu, e[s], o);
        const int c = c0 + (lane >> 4);
        if ((lane & 15) == 0 && c < SC) {
          se[2 * c] = e[0];
          se[2 * c + 1] = e[1];
#pragma unroll
          for (int d = 0; d < 3; ++d) dn[3 * c + d] = e[2 + d];
        }
      }
    };
    // output row t: the softmax over the nine edges (lane s < 9 of a half
    // warp takes tap s of the half's pixel; the sum in tap order), then
    // the aggregation of h rows t - 1 .. t + 1 in tap order, each loaded
    // row serving both pixels of the warp
    auto aggregate = [&](int t) {
      const float* up = dnb + ((t - 1) & 1) * SCM * 3;
      const float* down = dnb + (t & 1) * SCM * 3;
      for (int o0 = 2 * warp; o0 < BWt; o0 += 2 * ATTN_WARPS) {
        const int c0 = ox + o0;
        const int half = lane >> 4, s = lane & 15;
        const int c = c0 + half, x = xs + c;
        const int dy = s / 3 - 1, dx = s % 3 - 1;
        const bool valid = o0 + half < BWt && s < 9 && t + dy >= 0 &&
                           t + dy < H && x + dx >= 0 && x + dx < W;
        float edge = -INFINITY;
        if (valid)
          edge = dy < 0   ? up[3 * (c + dx) + 1 - dx]
                 : dy > 0 ? down[3 * c + dx + 1]
                 : dx < 0 ? se[2 * (c - 1) + 1]
                          : se[2 * c + dx];
        float m = edge;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float ex = valid ? expf(edge - m) : 0.f;
        float total = 0.f;
#pragma unroll
        for (int j = 0; j < 9; ++j)
          total += __shfl_sync(0xffffffffu, ex, (lane & 16) + j);
        // a tap outside the grid weighs -0 and reads +0 (a zero row or
        // the zero column): fma(-0, +0, acc) is acc for every acc, -0
        // included, so the tap adds exactly what the plain sum's skip adds
        const float wt = valid ? round_bf16(ex / total) : -0.f;
        float w[2][9];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < 9; ++j)
            w[p][j] = __shfl_sync(0xffffffffu, wt, 16 * p + j);

        int cc[4];  // the zero column outside the tile
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cc[i] = (c0 - 1 + i >= 0 && c0 - 1 + i < SC ? c0 - 1 + i : SCM) * D;
        const long long item =
            (long long)r * HW + (long long)t * W + xs + c0;
        using Out = std::conditional_t<
            kOut == kOutQ8, signed char,
            std::conditional_t<kOut == kOutF32, float, bf16>>;
        Out* const out[2] = {static_cast<Out*>(h2) + item * D,
                             static_cast<Out*>(h2) + (item + 1) * D};
        float amax[2] = {0.f, 0.f};
        // lane l sums channels 4l .. 4l + 3 of every 128 (the sum over
        // taps is per channel, so any lane may take any channel), each
        // tap in order
        for (int k = 4 * lane; k < D; k += 128) {
          float acc[2][4] = {};
          uint2 own[2];
#pragma unroll
          for (int ry = 0; ry < 3; ++ry) {
            const bf16* row = raw_row(t - 1 + ry) + k;
            uint2 v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = *reinterpret_cast<const uint2*>(row + cc[i]);
            if (ry == 1) own[0] = v[1], own[1] = v[2];
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int rx = 0; rx < 3; ++rx) {
                const float wt = w[p][3 * ry + rx];
                const float2 lo = bf16x2_bits(v[p + rx].x);
                const float2 hi = bf16x2_bits(v[p + rx].y);
                acc[p][0] += wt * lo.x;
                acc[p][1] += wt * lo.y;
                acc[p][2] += wt * hi.x;
                acc[p][3] += wt * hi.y;
              }
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if (o0 + p >= BWt) continue;
            const float2 lo = bf16x2_bits(own[p].x);
            const float2 hi = bf16x2_bits(own[p].y);
            const float o[4] = {lo.x + acc[p][0], lo.y + acc[p][1],
                                hi.x + acc[p][2], hi.y + acc[p][3]};
            if constexpr (kOut == kOutQ8) {
              *reinterpret_cast<char4*>(out[p] + k) =
                  make_char4(quantize_h2(o[0]), quantize_h2(o[1]),
                             quantize_h2(o[2]), quantize_h2(o[3]));
            } else if constexpr (kOut == kOutF32) {
              *reinterpret_cast<float4*>(out[p] + k) =
                  make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                amax[p] = fmaxf(amax[p], fabsf(o[i]));
            } else {
              const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
              const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
              *reinterpret_cast<uint2*>(out[p] + k) =
                  make_uint2(*reinterpret_cast<const unsigned*>(&a),
                             *reinterpret_cast<const unsigned*>(&b));
            }
          }
        }
        if constexpr (kOut == kOutF32) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float a = warp_max(amax[p]);
            if (lane == 0 && o0 + p < BWt) pix_max[item + p] = a;
          }
        }
      }
    };

    // rows y0 - 1 .. y0 + 1 in flight together, the first two with their
    // scene in their own node slots; then the rolling window: row t's
    // edges, output row t and row t + 2's node, while row t + 3's copies
    // are in flight
    stage(y0 - 1, norm_row(y0 - 1) + D, NC);
    stage(y0, norm_row(y0) + D, NC);
    stage(y0 + 1, land, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    normalise(y0 - 1, norm_row(y0 - 1) + D, NC);
    normalise(y0, norm_row(y0) + D, NC);
    __syncthreads();
    for (int t = y0 - 1; t < ye; ++t) {
      if (t >= 0) edges(t);
      __syncthreads();
      if (t >= y0) aggregate(t);
      if (t + 2 <= ye) {
        cp_async_wait<0>();
        __syncwarp();
        normalise(t + 2, land, C);
      }
      __syncthreads();
      if (t + 3 <= ye) {
        stage(t + 3, land, C);
        cp_async_commit();
      }
    }
  }
}

// Blocks of the attention launch resident on one SM of the current card
// at `smem` bytes of shared memory: asked once per card and size (the
// query costs about as much as the launch).
template <int kOut>
cudaError_t attn_resident(size_t smem, int* blocks) {
  static std::atomic<long long> known[kMaxDevices];  // smem << 8 | blocks
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const long long k = dev < kMaxDevices ? known[dev].load() : 0;
  if (k >> 8 == (long long)smem) {
    *blocks = (int)(k & 0xff);
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)gnn_attention_kernel<kOut>, ATTN_THREADS, smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    known[dev].store((long long)smem << 8 | *blocks);
  return err;
}

template <int kOut>
int launch_attention(const int* parent_rows, const void* h, const void* scene,
                     void* h2, float* pix_max, int NK, int H, int W, int D,
                     int C, void* stream) {
  // tiles as wide as the warps' columns; narrower where the shared memory
  // would not fit (a wide D)
  int BW = W < ATTN_MAX_BW ? W : ATTN_MAX_BW;
  auto bytes = [&](int bw) {
    return AttnLayout(W < bw + 2 ? W : bw + 2, D, C).bytes;
  };
  while (BW > 1 && bytes(BW) > ATTN_MAX_SMEM) BW = (BW + 1) / 2;
  const size_t smem = bytes(BW);
  if (smem > ATTN_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)gnn_attention_kernel<kOut>;
  static SmemAttr attr;
  cudaError_t err = attr.raise(kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one block per resident slot, each walking an equal share of the
  // image rows: no wave of the grid runs short
  int sms = 0, per_sm = 0;
  err = sm_count(&sms);
  if (err == cudaSuccess) err = attn_resident<kOut>(smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + BW - 1) / BW;
  const long long rows = (long long)NK * tiles_x * H;
  const long long slots = (long long)sms * (per_sm > 1 ? per_sm : 1);
  const long long grid = rows < slots ? rows : slots;
  gnn_attention_kernel<kOut><<<(unsigned)grid, ATTN_THREADS, smem,
                               (cudaStream_t)stream>>>(
      parent_rows, (const bf16*)h, (const bf16*)scene, h2, pix_max, H, W, D,
      C, BW, tiles_x, rows);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ 3. readout

constexpr int READ_THREADS = 256;

// shared memory of a band of TR image rows: the taps' f32 weights [9, D]
// and the partials P of the band and its halo rows [(TR + 2) * W, 9]
inline size_t readout_smem(int TR, int W, int D) {
  return (size_t)9 * D * 4 + (size_t)(TR + 2) * W * 9 * 4;
}

// One block per (beam row, band of TR image rows).
__global__ void __launch_bounds__(READ_THREADS)
class_readout_kernel(const bf16* __restrict__ h_new,  // [NK, HW, D]
                     const bf16* __restrict__ w,      // [D, ldw], taps 0..8
                     int ldw, float* __restrict__ logits,  // [NK, HW]
                     int H, int W, int D, int TR, int bands) {
  extern __shared__ __align__(16) float rsm[];
  float* w_s = rsm;         // [9, D]
  float* P = rsm + 9 * D;   // [(TR + 2) * W, 9], from image row ya
  const int HW = H * W;
  const int r = blockIdx.x / bands;
  const int y0 = (blockIdx.x - r * bands) * TR;
  const int ya = max(y0 - 1, 0), yb = min(y0 + TR + 1, H);
  for (int i = threadIdx.x; i < 9 * D; i += READ_THREADS) {
    const int d = i / 9, s = i - d * 9;  // consecutive taps of a row
    w_s[s * D + d] = __bfloat162float(w[(long long)d * ldw + s]);
  }
  __syncthreads();

  // P[q, s] = h'[q] . w_s: 8 lanes take RP pixels at once, lane j channels
  // 8j .. 8j + 7 of every 64 as 16-byte loads, so each h' row is read once
  // and each weight read from shared memory serves RP pixels; the warp's
  // trip count is uniform for its shuffles
  constexpr int RP = 4;
  const int j = threadIdx.x & 7, grp = threadIdx.x >> 3;
  const bf16* hb = h_new + ((long long)r * HW + (long long)ya * W) * D;
  const int n = (yb - ya) * W;
  for (int base = 0; base < n; base += RP * (READ_THREADS / 8)) {
    const bf16* row[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int px = base + q * (READ_THREADS / 8) + grp;
      row[q] = hb + (long long)(px < n ? px : 0) * D;
    }
    float acc[RP][9];
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int s = 0; s < 9; ++s) acc[q][s] = 0.f;
    for (int d0 = 8 * j; d0 < D; d0 += 64) {
      float v[RP][8];
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int4 raw = *reinterpret_cast<const int4*>(row[q] + d0);
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(v2[t]);
          v[q][2 * t] = f.x;
          v[q][2 * t + 1] = f.y;
        }
      }
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float4 wa = *reinterpret_cast<const float4*>(w_s + s * D + d0);
        const float4 wb =
            *reinterpret_cast<const float4*>(w_s + s * D + d0 + 4);
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          float a = acc[q][s];
          a = fmaf(v[q][0], wa.x, a);
          a = fmaf(v[q][1], wa.y, a);
          a = fmaf(v[q][2], wa.z, a);
          a = fmaf(v[q][3], wa.w, a);
          a = fmaf(v[q][4], wb.x, a);
          a = fmaf(v[q][5], wb.y, a);
          a = fmaf(v[q][6], wb.z, a);
          acc[q][s] = fmaf(v[q][7], wb.w, a);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RP; ++q) {
#pragma unroll
      for (int s = 0; s < 9; ++s)
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          acc[q][s] += __shfl_xor_sync(0xffffffffu, acc[q][s], o);
      const int px = base + q * (READ_THREADS / 8) + grp;
      if (j == 0 && px < n)
#pragma unroll
        for (int s = 0; s < 9; ++s) P[px * 9 + s] = acc[q][s];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < TR * W; o += READ_THREADS) {
    const int y = y0 + o / W, x = o % W;
    if (y >= H) break;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      acc += P[((yy - ya) * W + xx) * 9 + s];
    }
    logits[(long long)r * HW + y * W + x] = acc;
  }
}

// The floats with bits lo .. hi on which the gate epilogue's reciprocal
// (rcp_rn_ge1) and __frcp_rn give different bits, counted into *bad.
__global__ void rcp_rn_check_kernel(unsigned lo, unsigned hi,
                                    unsigned long long* bad) {
  unsigned long long n = 0;
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned long long b =
           (unsigned long long)lo + blockIdx.x * blockDim.x + threadIdx.x;
       b <= hi; b += step) {
    const float y = __uint_as_float((unsigned)b);
    n += __float_as_uint(rcp_rn_ge1(y)) != __float_as_uint(__frcp_rn(y));
  }
  if (n) atomicAdd(bad, n);
}

}  // namespace

extern "C" {

// K1, K8 (parent_rows null), K9: h2 = bf16(h + agg).
int mv_gnn_attention(const int* parent_rows, const void* h, const void* scene,
                     void* h2, int NK, int H, int W, int D, int C,
                     void* stream) {
  return launch_attention<kOutBf16>(parent_rows, h, scene, h2, nullptr, NK, H,
                                    W, D, C, stream);
}

// K2: the int8 gate input of the "int8" tier.
int mv_gnn_attention_h2q(const int* parent_rows, const void* h,
                         const void* scene, void* h2q, int NK, int H, int W,
                         int D, int C, void* stream) {
  return launch_attention<kOutQ8>(parent_rows, h, scene, h2q, nullptr, NK, H,
                                  W, D, C, stream);
}

// K7: h + agg in f32 and each pixel's max |h + agg|.
int mv_gnn_attention_f32(const int* parent_rows, const void* h,
                         const void* scene, float* h2f, float* pix_max,
                         int NK, int H, int W, int D, int C, void* stream) {
  return launch_attention<kOutF32>(parent_rows, h, scene, h2f, pix_max, NK, H,
                                   W, D, C, stream);
}

// The bf16 gate launch on weights w_t [4D, 9(E+D)] laid out once per
// decode (ops/gate_layout.py: K-major, the K columns the embedding taps
// then the recurrent ones, the rows in gate_row_order). Modes, by which
// operands are null:
//   K1      prev_ids, parent_rows: the embedding row of prev_ids[r] from
//           the [HW, HW, E] table, c from row parent_rows[r];
//   K8, K6  both null: emb holds one [HW, E] row per output row (K6: x,
//           with E = Cx) and c is read from the same row;
//   K9      E = 0 (the product over h2 alone, K = 9D), parent_rows null,
//           emb_bg and emb_dev set: the epilogue adds the embedding's gate
//           contribution of id prev_ids[r] from the tables,
//           gates = ((acc + dev) + bg) + b in the TPU kernel's order, dev
//           being 0 outside the 5x5 window around the id.
int mv_gate_lstm(const int* prev_ids, const int* parent_rows, const void* emb,
                 const void* h2, const void* c, const void* w_t,
                 const float* cell_b, const void* emb_bg, const void* emb_dev,
                 void* h_out, void* c_out, int NK, int H, int W, int D, int E,
                 float forget_bias, void* stream) {
  const GateArgs g{prev_ids, parent_rows, emb, h2, nullptr, nullptr,
                   (const bf16*)c, nullptr, nullptr, cell_b,
                   (const bf16*)emb_bg, (const bf16*)emb_dev, (bf16*)h_out,
                   (bf16*)c_out, NK, H, W, D, E, forget_bias, 9 * E, 0, 0};
  const int K = 9 * (E + D);
  if (D % 64 == 0)
    return launch_gate<2, 1, 256, kBf16, 3, true>(w_t, K, w_t, K, h2, g,
                                                  (cudaStream_t)stream);
  return launch_gate<2, 1, 128, kBf16, 4, true>(w_t, K, w_t, K, h2, g,
                                                (cudaStream_t)stream);
}

int mv_class_readout(const void* h_new, const void* w, int ldw, float* logits,
                     int NK, int H, int W, int D, void* stream) {
  // the tallest band whose partials fit in 48 KB
  int TR = H;
  while (TR > 1 && readout_smem(TR, W, D) > 48 * 1024) TR = (TR + 1) / 2;
  const size_t smem = readout_smem(TR, W, D);
  static SmemAttr attr;
  cudaError_t err = attr.raise((const void*)class_readout_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (H + TR - 1) / TR;
  class_readout_kernel<<<(unsigned)((long long)NK * bands), READ_THREADS,
                         smem, (cudaStream_t)stream>>>(
      (const bf16*)h_new, (const bf16*)w, ldw, logits, H, W, D, TR, bands);
  return (int)cudaGetLastError();
}

// *bad (zeroed by the caller) += the floats with bits lo .. hi on which
// the gate epilogue's reciprocal differs from __frcp_rn
int mv_rcp_rn_mismatches(unsigned lo, unsigned hi, unsigned long long* bad,
                         void* stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  rcp_rn_check_kernel<<<sms * 8, 256, 0, (cudaStream_t)stream>>>(lo, hi, bad);
  return (int)cudaGetLastError();
}

const char* mv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
