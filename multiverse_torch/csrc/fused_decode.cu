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
//   1. gnn_attention_kernel   one block of 16 warps per (beam row, tile of
//      up to 2 image rows by 32 pixels). The TPU kernel forms the dense
//      [HW, HW] edge tile (1.3 MB in f32 at 18x32), far beyond a block's
//      227 KB of shared memory. The mask is the 3x3 neighbourhood and
//      exp(-1e30) is 0 in f32, so the softmax over the 9 neighbours is
//      exact. Bound: bytes (h and scene read, the output written: ~0.063
//      ms at 320 beam rows, 18x32, D=256, C=64, bf16 out). Each pixel's
//      row is a neighbour of nine pixels and read three times by each
//      (norm, dot, aggregation): from L1/L2 that is latency, not bytes. So
//      the block stages the tile and its one-pixel halo once by cp.async
//      (raw bf16 h and scene rows, ~87 KB at those widths: two blocks an
//      SM) and one f32 inverse norm per staged pixel, keeps the
//      normalised node implicit as round_bf16(x * inv), runs the nine
//      edges side by side from shared memory, then the aggregation. Lane
//      l takes the channel pairs 2l + 64i and the warp sums reduce them
//      (node_sumsq's order): the gates on K2's h2_q and K7's h2_f were
//      set on sums in that order. Writes h2 = bf16(h + agg) (K1, K8, K9);
//      the int8 tier (fused_decode_q8.cu) takes the same launch with the
//      int8 gate input quantize_h2(h + agg) as its output, the int8_dyn
//      tier with h + agg in f32 and each pixel's max |h + agg|.
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

// shared memory of one staged pixel: its bf16 h and scene rows and the f32
// inverse norm of its node
__host__ __device__ __forceinline__ size_t attn_pixel_bytes(int D, int C) {
  return (size_t)(D + C) * 2 + 4;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// two values rounded to bf16 by one conversion, back in f32
__device__ __forceinline__ float2 round_bf16x2(float x, float y) {
  return __bfloat1622float2(__floats2bfloat162_rn(x, y));
}

// What the attention launch writes for each (row, pixel, channel):
enum AttnOut {
  kOutBf16 = 0,  // K1, K8, K9: h2 = bf16(h + agg)
  kOutQ8 = 1,    // the int8 tier (K2): the gate input quantize_h2(h + agg)
                 // from the f32 sum, never from a bf16 copy
  kOutF32 = 2,   // the int8_dyn tier (K7): h + agg in f32, and the
                 // pixel's max |h + agg| over its D channels in pix_max
};

// One block per (beam row, BR x BW tile of pixels); parent_rows null:
// identity parents (row r reads state row r).
template <int kOut>
__global__ void __launch_bounds__(ATTN_THREADS, 2)
gnn_attention_kernel(const int* __restrict__ parent_rows,
                     const bf16* __restrict__ h,      // [*, HW, D] old order
                     const bf16* __restrict__ scene,  // [NK, HW, C] or null
                     void* __restrict__ h2,           // [NK, HW, D] new order
                     float* __restrict__ pix_max,     // [NK, HW], kOutF32
                     int H, int W, int D, int C, int BR, int BW, int tiles_y,
                     int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HC = BW + 2, HP = (BR + 2) * HC;
  bf16* hs = reinterpret_cast<bf16*>(smem);                    // [HP, D]
  bf16* ss = hs + (size_t)HP * D;                              // [HP, C]
  float* inv = reinterpret_cast<float*>(ss + (size_t)HP * C);  // [HP]

  const int HW = H * W;
  const int tiles = tiles_y * tiles_x;
  const int r = blockIdx.x / tiles;
  const int t = blockIdx.x - r * tiles;
  const int y0 = (t / tiles_x) * BR, x0 = (t % tiles_x) * BW;
  const bf16* hrow =
      h + (long long)(parent_rows ? parent_rows[r] : r) * HW * D;
  const bf16* srow = scene ? scene + (long long)r * HW * C : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage the tile and its halo, every copy in flight at once; a halo
  // pixel outside the grid is never read
  const int hv = D / 8, sv = srow ? C / 2 : 0;  // 16-byte / 4-byte copies
  for (int i = threadIdx.x; i < HP * (hv + sv); i += ATTN_THREADS) {
    const int hp = i / (hv + sv), v = i - hp * (hv + sv);
    const int yy = y0 - 1 + hp / HC, xx = x0 - 1 + hp % HC;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const long long q = (long long)yy * W + xx;
    if (v < hv)
      cp_async16(hs + (size_t)hp * D + 8 * v, hrow + q * D + 8 * v, true);
    else
      cp_async4(ss + (size_t)hp * C + 2 * (v - hv),
                srow + q * C + 2 * (v - hv));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int hp = warp; hp < HP; hp += ATTN_WARPS) {
    const int yy = y0 - 1 + hp / HC, xx = x0 - 1 + hp % HC;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const float sumsq =
        node_sumsq(hs + (size_t)hp * D, ss + (size_t)hp * C, D, C, lane);
    if (lane == 0) inv[hp] = rsqrtf(fmaxf(sumsq, 1e-12f));
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
    // the nine edges side by side, with no branch, so that their loads
    // and reductions overlap (a neighbour outside the grid reads the
    // pixel's own row and is masked below); each lane's sum and the warp
    // sum as node_sumsq's
    const float inv_p = inv[hc];
    float iq[9], dot[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      iq[s] = inv[hn[s] < 0 ? hc : hn[s]];
      dot[s] = 0.f;
    }
    for (int k = 2 * lane; k < D; k += 64) {
      const float2 a = load_bf16x2(hs + (size_t)hc * D + k);
      const float2 an = round_bf16x2(a.x * inv_p, a.y * inv_p);
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float2 b =
            load_bf16x2(hs + (size_t)(hn[s] < 0 ? hc : hn[s]) * D + k);
        const float2 bn = round_bf16x2(b.x * iq[s], b.y * iq[s]);
        dot[s] += an.x * bn.x + an.y * bn.y;
      }
    }
    for (int k = 2 * lane; k < C; k += 64) {
      const float2 a = load_bf16x2(ss + (size_t)hc * C + k);
      const float2 an = round_bf16x2(a.x * inv_p, a.y * inv_p);
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float2 b =
            load_bf16x2(ss + (size_t)(hn[s] < 0 ? hc : hn[s]) * C + k);
        const float2 bn = round_bf16x2(b.x * iq[s], b.y * iq[s]);
        dot[s] += an.x * bn.x + an.y * bn.y;
      }
    }
    float e[9];
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      e[s] = warp_sum(dot[s]);
      if (hn[s] >= 0) m = fmaxf(m, e[s]);
    }
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (hn[s] < 0) continue;
      e[s] = expf(e[s] - m);
      total += e[s];
    }
#pragma unroll
    for (int s = 0; s < 9; ++s)
      e[s] = hn[s] < 0 ? 0.f : round_bf16(e[s] / total);

    const long long item = (long long)r * HW + y * W + x;
    float amax = 0.f;
    for (int k = 2 * lane; k < D; k += 64) {
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        if (hn[s] < 0) continue;
        const float2 v = load_bf16x2(hs + (size_t)hn[s] * D + k);
        ax += e[s] * v.x;
        ay += e[s] * v.y;
      }
      const float2 own = load_bf16x2(hs + (size_t)hc * D + k);
      if constexpr (kOut == kOutQ8) {
        *reinterpret_cast<char2*>(static_cast<signed char*>(h2) + item * D +
                                  k) =
            make_char2(quantize_h2(own.x + ax), quantize_h2(own.y + ay));
      } else if constexpr (kOut == kOutF32) {
        const float vx = own.x + ax, vy = own.y + ay;
        *reinterpret_cast<float2*>(static_cast<float*>(h2) + item * D + k) =
            make_float2(vx, vy);
        amax = fmaxf(amax, fmaxf(fabsf(vx), fabsf(vy)));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(h2) +
                                           item * D + k) =
            __floats2bfloat162_rn(own.x + ax, own.y + ay);
      }
    }
    if constexpr (kOut == kOutF32) {
      amax = warp_max(amax);
      if (lane == 0) pix_max[item] = amax;
    }
  }
}

template <int kOut>
int launch_attention(const int* parent_rows, const void* h, const void* scene,
                     void* h2, float* pix_max, int NK, int H, int W, int D,
                     int C, void* stream) {
  // two blocks an SM at the paths' widths
  int BR, BW;
  const size_t smem = attn_tile(H, W, attn_pixel_bytes(D, C), 0,
                                110 * 1024, &BR, &BW);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  static SmemAttr attr;
  cudaError_t err =
      attr.raise((const void*)gnn_attention_kernel<kOut>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + BR - 1) / BR, tiles_x = (W + BW - 1) / BW;
  gnn_attention_kernel<kOut><<<(unsigned)((long long)NK * tiles_y * tiles_x),
                               ATTN_THREADS, smem, (cudaStream_t)stream>>>(
      parent_rows, (const bf16*)h, (const bf16*)scene, h2, pix_max, H, W, D,
      C, BR, BW, tiles_y, tiles_x);
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

const char* mv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
