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
//      K2 uses K1's staged bf16 attention (gnn_attention_kernel<kOutQ8>
//      in fused_decode.cu). K3 is gnn_attention_q8_kernel below: the node is
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
//   2. The gate launch: gate_lstm_wgmma_kernel of gate_wgmma.cuh, s8 x s8
//      -> s32 (m64nNk32), gates = acc * t_c + b, then the LSTM update.
//      The int32 sums are exact, so with the same h2_q the gates equal
//      the plain version's. K2/K3: tiles of 128 pixels by 64 channels, two
//      consumer warpgroups of 64 x 256, a persistent grid.
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
//      (c) gate_lstm_wgmma_kernel<..., kS8Dyn>: the same mainloop, the
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

#include "gate_wgmma.cuh"

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

// ------------------------------------------------------ 2. K7 (int8_dyn)

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
  int BR, BW;
  const size_t smem = attn_tile(H, W, node_bytes(D, C) + D, 0, 200 * 1024,
                                &BR, &BW);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  static SmemAttr attr;
  cudaError_t err = attr.raise((const void*)gnn_attention_q8_kernel,
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
  const GateArgs g{prev_ids, parent_rows, emb_q, h2q, nullptr, nullptr,
                   (const bf16*)c, t_c, nullptr, cell_b, nullptr, nullptr,
                   (bf16*)h_out, (bf16*)c_out, NK, H, W, D, E, forget_bias,
                   9 * E, 0, 0};
  const int K = 9 * (E + D);
  if (D % 64 == 0)
    return launch_gate<2, 1, 256, kS8, 3, true>(w_qt, K, w_qt, K, h2q, g,
                                                (cudaStream_t)stream);
  return launch_gate<2, 1, 128, kS8, 4, true>(w_qt, K, w_qt, K, h2q, g,
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
  const GateArgs g{prev_ids, parent_rows, emb_q, nullptr, h2f, r_p,
                   (const bf16*)c, t_e, u_c, cell_b, nullptr, nullptr,
                   (bf16*)h_out, (bf16*)c_out, NK, H, W, D, E, forget_bias,
                   0, 0, 0};
  // with no embedding half (E = 0) the first map is never read
  const void* w_e = E > 0 ? w_eqt : w_hqt;
  const int K_e = E > 0 ? 9 * E : 9 * D;
  if (D % 64 == 0)
    return launch_gate<1, 2, 128, kS8Dyn, 3, false>(
        w_e, K_e, w_hqt, 9 * D, h2f, g, (cudaStream_t)stream);
  return launch_gate<1, 1, 128, kS8Dyn, 3, false>(
      w_e, K_e, w_hqt, 9 * D, h2f, g, (cudaStream_t)stream);
}

}  // extern "C"
