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
//       row per state row (parent_rows and prev_ids null, emb_table the
//       [N, HW, E] rows);
//   K9  decode_step_pallas_v2 (body _decode_kernel_v2): K8 whose gate
//       product runs over the h half only (K = 9D); the embedding's gate
//       contribution is added in the epilogue from a background map and a
//       5x5 deviation slab per id (mv_gate_lstm_tables). The TPU kernel's
//       corner-seed-and-roll placement is a Mosaic workaround: here each
//       output pixel reads its slab entry directly;
//   K6  convlstm_step_pallas (pallas_cell.py, body _cell_kernel): the
//       ConvLSTM cell alone, the gate launch over [x (+) h] with per-row
//       x and c and no attention or readout (mv_convlstm_cell).
//
//   1. gnn_attention_kernel   one warp per (beam row, pixel). The TPU
//      kernel forms the dense [HW, HW] edge tile (1.3 MB in f32 at
//      18x32), far beyond a block's 227 KB of shared memory. The mask is
//      the 3x3 neighbourhood and exp(-1e30) is 0 in f32, so the softmax
//      over the 9 neighbours is exact. Writes h2 = bf16(h + agg) (K1,
//      K8, K9); the int8 tier (fused_decode_q8.cu) uses the same launch
//      with the int8 gate input quantize_h2(h + agg) as its output, the
//      int8_dyn tier with h + agg in f32 and each pixel's max |h + agg|.
//   2. gate_lstm_kernel       implicit-GEMM 3x3 conv: M = NK*HW pixels,
//      K = 9*(E+D), N = 4*D gates, bf16 wmma with f32 accumulation,
//      3-stage cp.async pipeline. A block's 128 gate columns are the
//      i, g, f, o columns of 32 channels, so the LSTM update runs in the
//      epilogue from shared memory; the gates never reach device memory.
//   3. class_readout_kernel   one warp per output pixel: the nine
//      (neighbour, tap) dot products over D, summed in tap order.
//
// Bound: at NK=320, 18x32, D=256, E=32 one step is ~0.98 TFLOP in the
// gate product against ~0.4 GB of state traffic (h and c read and
// written), ~2.4 kFLOP/byte, far above the H100's ~295 FLOP/byte bf16
// ridge: the gate product is compute-bound, so its tensor-core
// throughput is what later work on this kernel should raise (wgmma, TMA).
// K9 does 11% fewer gate operations (K = 9D); K6 at the training
// encoder's shape (N = 20, Cx = 64) is ~68 GFLOP, compute-bound too.
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launch.

#include <mma.h>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;

// ---------------------------------------------------------------- 1. GNN

// Dot product of the two bf16-rounded normalised nodes, f32 accumulation.
__device__ float node_dot(const bf16* hp, const bf16* sp, float inv_p,
                          const bf16* hq, const bf16* sq, float inv_q, int D,
                          int C, int lane) {
  float s = 0.f;
  for (int k = 2 * lane; k < D; k += 64) {
    float2 a = load_bf16x2(hp + k), b = load_bf16x2(hq + k);
    s += round_bf16(a.x * inv_p) * round_bf16(b.x * inv_q) +
         round_bf16(a.y * inv_p) * round_bf16(b.y * inv_q);
  }
  for (int k = 2 * lane; k < C; k += 64) {
    float2 a = load_bf16x2(sp + k), b = load_bf16x2(sq + k);
    s += round_bf16(a.x * inv_p) * round_bf16(b.x * inv_q) +
         round_bf16(a.y * inv_p) * round_bf16(b.y * inv_q);
  }
  return warp_sum(s);
}

// What the attention launch writes for each (row, pixel, channel):
enum AttnOut {
  kOutBf16 = 0,  // K1, K8, K9: h2 = bf16(h + agg)
  kOutQ8 = 1,    // the int8 tier (K2): the gate input quantize_h2(h + agg)
                 // from the f32 sum, never from a bf16 copy
  kOutF32 = 2,   // the int8_dyn tier (K7): h + agg in f32, and the
                 // pixel's max |h + agg| over its D channels in pix_max
};

// parent_rows null: identity parents (row r reads state row r).
template <int kOut>
__global__ void __launch_bounds__(256)
gnn_attention_kernel(const int* __restrict__ parent_rows,
                     const bf16* __restrict__ h,      // [*, HW, D] old order
                     const bf16* __restrict__ scene,  // [NK, HW, C] or null
                     void* __restrict__ h2,           // [NK, HW, D] new order
                     float* __restrict__ pix_max,     // [NK, HW], kOutF32
                     int NK, int H, int W, int D, int C) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int HW = H * W;
  if (item >= (long long)NK * HW) return;
  const int r = (int)(item / HW);
  const int p = (int)(item - (long long)r * HW);
  const int y = p / W, x = p - (p / W) * W;
  const bf16* hrow =
      h + (long long)(parent_rows ? parent_rows[r] : r) * HW * D;
  const bf16* srow = scene ? scene + (long long)r * HW * C : nullptr;

  int q[9];
  neighbours(y, x, H, W, q);
  const bf16* hp = hrow + (long long)p * D;
  const bf16* sp = srow ? srow + (long long)p * C : nullptr;
  const float inv_p =
      rsqrtf(fmaxf(node_sumsq(hp, sp, D, C, lane), 1e-12f));

  float e[9];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    e[s] = 0.f;
    if (q[s] < 0) continue;
    const bf16* hq = hrow + (long long)q[s] * D;
    const bf16* sq = srow ? srow + (long long)q[s] * C : nullptr;
    const float inv_q =
        s == 4 ? inv_p : rsqrtf(fmaxf(node_sumsq(hq, sq, D, C, lane), 1e-12f));
    e[s] = node_dot(hp, sp, inv_p, hq, sq, inv_q, D, C, lane);
    m = fmaxf(m, e[s]);
  }
  float total = 0.f;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    if (q[s] < 0) continue;
    e[s] = expf(e[s] - m);
    total += e[s];
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) e[s] = q[s] < 0 ? 0.f : round_bf16(e[s] / total);

  float amax = 0.f;
  for (int k = 2 * lane; k < D; k += 64) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (q[s] < 0) continue;
      float2 v = load_bf16x2(hrow + (long long)q[s] * D + k);
      ax += e[s] * v.x;
      ay += e[s] * v.y;
    }
    float2 own = load_bf16x2(hp + k);
    if constexpr (kOut == kOutQ8) {
      *reinterpret_cast<char2*>(static_cast<signed char*>(h2) + item * D + k) =
          make_char2(quantize_h2(own.x + ax), quantize_h2(own.y + ay));
    } else if constexpr (kOut == kOutF32) {
      const float vx = own.x + ax, vy = own.y + ay;
      *reinterpret_cast<float2*>(static_cast<float*>(h2) + item * D + k) =
          make_float2(vx, vy);
      amax = fmaxf(amax, fmaxf(fabsf(vx), fabsf(vy)));
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(h2) + item * D +
                                         k) =
          __floats2bfloat162_rn(own.x + ax, own.y + ay);
    }
  }
  if constexpr (kOut == kOutF32) {
    amax = warp_max(amax);
    if (lane == 0) pix_max[item] = amax;
  }
}

// ------------------------------------------------------- 2. gates + LSTM

constexpr int BM = 128;           // pixels per block
constexpr int DT = 32;            // hidden channels per block
constexpr int BN = 4 * DT;        // gate columns per block: i, g, f, o
constexpr int BK = 32;            // depth per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;      // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int A_LD = BK + 8;      // bf16, padded against bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;      // f32 epilogue tile
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr size_t PIPE_BYTES = (size_t)STAGES * (A_STAGE + B_STAGE) * 2;
constexpr size_t EPI_BYTES = (size_t)BM * C_LD * 4;
constexpr size_t GATE_SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

// Modes, by which operands are null:
//   K1      prev_ids, parent_rows: the embedding row of prev_ids[r] from
//           the [HW, HW, E] table, c from row parent_rows[r];
//   K8, K6  both null: emb_table holds one [HW, E] row per output row
//           (K6: x, with E = Cx) and c is read from the same row;
//   K9      E = 0 (the product runs over h2 alone, K = 9D), parent_rows
//           null, emb_bg and emb_dev set: the epilogue adds the
//           embedding's gate contribution of id prev_ids[r] from the
//           tables, gates = ((acc + dev) + bg) + b in the TPU kernel's
//           order, dev being 0 outside the 5x5 window around the id.
__global__ void __launch_bounds__(THREADS)
gate_lstm_kernel(const int* __restrict__ prev_ids,
                 const int* __restrict__ parent_rows,
                 const bf16* __restrict__ emb_table,  // [HW, HW, E] / rows
                 const bf16* __restrict__ h2,         // [NK, HW, D]
                 const bf16* __restrict__ c,          // [*, HW, D] old order
                 const bf16* __restrict__ cell_w,     // [9*(E+D), 4*D]
                 const float* __restrict__ cell_b,    // [4*D]
                 const bf16* __restrict__ emb_bg,     // [HW, 4D] (K9)
                 const bf16* __restrict__ emb_dev,    // [HW, 25, 4D] (K9)
                 bf16* __restrict__ h_out, bf16* __restrict__ c_out,
                 int NK, int H, int W, int D, int E, float forget_bias) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int HW = H * W;
  const int Cin = E + D;
  const int Kdim = 9 * Cin;
  const int N4 = 4 * D;
  const long long M = (long long)NK * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * DT;
  const int tid = threadIdx.x;

  // this thread's two A rows (pixels) and 16-byte column within a stage
  const int a_col = (tid & 3) * 8;
  bool a_ok[2];
  int a_y[2], a_x[2];
  long long a_emb[2], a_h2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int r = (int)(mm / HW), p = (int)(mm - (long long)r * HW);
    a_y[i] = p / W;
    a_x[i] = p - a_y[i] * W;
    a_emb[i] = (long long)(prev_ids ? prev_ids[r] : r) * HW * E;
    a_h2[i] = (long long)r * HW * D;
  }

  auto load_stage = [&](int kt, int stage) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
    const int k = kt * BK + a_col;
    const int s = k / Cin, ch = k - s * Cin;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + s / 3 - 1, xx = a_x[i] + s % 3 - 1;
      const bool ok = a_ok[i] && k < Kdim && yy >= 0 && yy < H && xx >= 0 &&
                      xx < W;
      const bf16* src = h2;  // read nothing: any valid address
      if (ok) {
        const long long qq = (long long)yy * W + xx;
        src = ch < E ? emb_table + a_emb[i] + qq * E + ch
                     : h2 + a_h2[i] + qq * D + (ch - E);
      }
      cp_async16(as + ((tid >> 2) + i * 64) * A_LD + a_col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * THREADS;
      const int krow = v >> 4, j = (v & 15) * 8;
      const int kk = kt * BK + krow;
      const bool ok = kk < Kdim;
      const bf16* src =
          ok ? cell_w + (long long)kk * N4 + (j / DT) * D + d0 + (j % DT)
             : cell_w;
      cp_async16(bs + krow * B_LD + j, src, ok);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (Kdim + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < nk) load_stage(pre, pre % STAGES);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue tile reuses the pipeline's shared memory

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * DT; e += THREADS) {
    const int row = e / DT, dd = e % DT;
    const long long m = m0 + row;
    if (m >= M) continue;
    const int r = (int)(m / HW), p = (int)(m - (long long)r * HW);
    const int d = d0 + dd;
    const float* g = Cs + row * C_LD + dd;
    float gate[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) gate[u] = g[u * DT];
    if (emb_bg) {
      const int id = prev_ids[r];
      const int dy = p / W - id / W + 2, dx = p % W - id % W + 2;
      if (dy >= 0 && dy < 5 && dx >= 0 && dx < 5) {
        const bf16* dev = emb_dev + ((long long)id * 25 + dy * 5 + dx) * N4;
#pragma unroll
        for (int u = 0; u < 4; ++u) gate[u] += __bfloat162float(dev[u * D + d]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        gate[u] += __bfloat162float(emb_bg[(long long)p * N4 + u * D + d]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) gate[u] += cell_b[u * D + d];
    const float c_old = __bfloat162float(
        c[((long long)(parent_rows ? parent_rows[r] : r) * HW + p) * D + d]);
    const float nc = sigmoidf_(gate[2] + forget_bias) * c_old +
                     sigmoidf_(gate[0]) * tanhf(gate[1]);
    const float nh = tanhf(nc) * sigmoidf_(gate[3]);
    h_out[m * D + d] = __float2bfloat16(nh);
    c_out[m * D + d] = __float2bfloat16(nc);
  }
}

// ------------------------------------------------------------ 3. readout

__global__ void __launch_bounds__(256)
class_readout_kernel(const bf16* __restrict__ h_new,  // [NK, HW, D]
                     const bf16* __restrict__ w,      // [D, ldw], taps 0..8
                     int ldw, float* __restrict__ logits,  // [NK, HW]
                     int NK, int H, int W, int D) {
  extern __shared__ float w_s[];  // [9, D]
  for (int i = threadIdx.x; i < 9 * D; i += blockDim.x) {
    const int s = i / D, d = i - (i / D) * D;
    w_s[i] = __bfloat162float(w[(long long)d * ldw + s]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int HW = H * W;
  if (item >= (long long)NK * HW) return;
  const int r = (int)(item / HW);
  const int p = (int)(item - (long long)r * HW);
  const int y = p / W, x = p - (p / W) * W;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    const bf16* hq = h_new + ((long long)r * HW + yy * W + xx) * D;
    const float* ws = w_s + s * D;
    float part = 0.f;
    for (int k = 2 * lane; k < D; k += 64) {
      float2 v = load_bf16x2(hq + k);
      part += v.x * ws[k] + v.y * ws[k + 1];
    }
    acc += warp_sum(part);
  }
  if (lane == 0) logits[item] = acc;
}

// ------------------------------------------------------------- launches

int launch_gate_lstm(const int* prev_ids, const int* parent_rows,
                     const void* emb_table, const void* h2, const void* c,
                     const void* cell_w, const float* cell_b,
                     const void* emb_bg, const void* emb_dev, void* h_out,
                     void* c_out, int NK, int H, int W, int D, int E,
                     float forget_bias, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gate_lstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GATE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)NK * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / DT));
  gate_lstm_kernel<<<grid, THREADS, GATE_SMEM, (cudaStream_t)stream>>>(
      prev_ids, parent_rows, (const bf16*)emb_table, (const bf16*)h2,
      (const bf16*)c, (const bf16*)cell_w, cell_b, (const bf16*)emb_bg,
      (const bf16*)emb_dev, (bf16*)h_out, (bf16*)c_out, NK, H, W, D, E,
      forget_bias);
  return (int)cudaGetLastError();
}

template <int kOut>
int launch_attention(const int* parent_rows, const void* h, const void* scene,
                     void* h2, float* pix_max, int NK, int H, int W, int D,
                     int C, void* stream) {
  gnn_attention_kernel<kOut><<<row_blocks(NK, H * W), ROW_THREADS, 0,
                               (cudaStream_t)stream>>>(
      parent_rows, (const bf16*)h, (const bf16*)scene, h2, pix_max, NK, H, W,
      D, C);
  return (int)cudaGetLastError();
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

// K1 (ids and parents) and K8 (both null).
int mv_gate_lstm(const int* prev_ids, const int* parent_rows,
                 const void* emb_table, const void* h2, const void* c,
                 const void* cell_w, const float* cell_b, void* h_out,
                 void* c_out, int NK, int H, int W, int D, int E,
                 float forget_bias, void* stream) {
  return launch_gate_lstm(prev_ids, parent_rows, emb_table, h2, c, cell_w,
                          cell_b, nullptr, nullptr, h_out, c_out, NK, H, W, D,
                          E, forget_bias, stream);
}

// K9: the product over h2 alone (cell_wh [9D, 4D]); the embedding's gates
// of ids[r] from the background map and the deviation slabs.
int mv_gate_lstm_tables(const int* ids, const void* h2, const void* c,
                        const void* cell_wh, const float* cell_b,
                        const void* emb_bg, const void* emb_dev, void* h_out,
                        void* c_out, int N, int H, int W, int D,
                        float forget_bias, void* stream) {
  return launch_gate_lstm(ids, nullptr, nullptr, h2, c, cell_wh, cell_b,
                          emb_bg, emb_dev, h_out, c_out, N, H, W, D, 0,
                          forget_bias, stream);
}

// K6: the ConvLSTM cell, gates over [x (+) h], per-row x, h and c.
int mv_convlstm_cell(const void* x, const void* h, const void* c,
                     const void* cell_w, const float* cell_b, void* h_out,
                     void* c_out, int N, int H, int W, int D, int Cx,
                     float forget_bias, void* stream) {
  return launch_gate_lstm(nullptr, nullptr, x, h, c, cell_w, cell_b, nullptr,
                          nullptr, h_out, c_out, N, H, W, D, Cx, forget_bias,
                          stream);
}

int mv_class_readout(const void* h_new, const void* w, int ldw, float* logits,
                     int NK, int H, int W, int D, void* stream) {
  class_readout_kernel<<<row_blocks(NK, H * W), ROW_THREADS,
                         9 * D * sizeof(float), (cudaStream_t)stream>>>(
      (const bf16*)h_new, (const bf16*)w, ldw, logits, NK, H, W, D);
  return (int)cudaGetLastError();
}

const char* mv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
