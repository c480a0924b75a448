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
// The structure is K1's
// (fused_decode.cu): an attention launch, an implicit-GEMM gate launch
// with the LSTM update in its epilogue, and K1's class readout launch.
//
//   1. The attention launch writes the int8 gate input
//      h2_q = clip(rint((h + agg) * 127/2), +-127) from the f32 sum.
//      K2 uses K1's bf16 attention (gnn_attention_kernel<true> in
//      fused_decode.cu). K3 is gnn_attention_q8_kernel below: the node is
//      L2-normalised in f32 and quantised to rint(node * 127); edges are
//      the int32 dot products times the f32 constant 1/127^2; the softmax
//      over the nine neighbours runs in f32 (masked edges give exp = 0 in
//      the TPU kernel's dense softmax, so nine terms are exact); attn and
//      h are quantised to rint(* 127) (h clipped to +-127) and agg is
//      their int32 dot product times 1/127^2.
//   2. gate_lstm_q8_kernel: M = NK*HW pixels, K = 9*(E+D), N = 4*D.
//      The A tile gathers 16-byte vectors of the int8 embedding row of
//      prev_ids[i] and of h2_q, zero outside the grid; B is w_q stored
//      K-contiguous per gate column ([4D, 9(E+D)]), as the int8 MMA takes
//      it. mma.sync m16n8k32 s8 x s8 -> s32, 3-stage cp.async pipeline;
//      the int32 sums are exact, so with the same h2_q the gates equal
//      the plain version's. Epilogue: gates = acc * t_c + b in f32, then
//      K1's LSTM update with c read from the parent row.
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
//      (c) gate_lstm_q8dyn_kernel: K2's mma.sync s8 pipeline running the
//          embedding tiles into acc_e, then the recurrent tiles into
//          acc_h (two K loops: 9E = 288 does not divide into 64-deep
//          tiles, and no tile straddles the halves). No int8 copy of h2
//          can exist, since one h + agg value enters nine patch rows at
//          nine scales: the A loader of a recurrent tile reads the
//          neighbour's f32 h + agg, multiplies by 127 / r_p of the OUTPUT
//          pixel (IEEE division, never a reciprocal approximation, so
//          ties land where the TPU kernel's do), rounds half to even and
//          stores int8 to shared memory. Its B operands come by cp.async.
//
// Bound: at NK=320, 18x32, D=256, E=32 the gate product is ~0.98 TOP of
// int8 (~0.49 ms at the H100's 1,979 TOP/s dense int8 peak) against
// ~0.5 GB of state traffic: compute-bound, like K1. mma.sync is not the
// card's fastest int8 path (wgmma is); a simple correct kernel first.
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launch.

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

// int32 dot product of two quantised nodes (h (+) scene rows), over the warp.
__device__ int node_dot_q8(const bf16* hp, const bf16* sp, float inv_p,
                           const bf16* hq, const bf16* sq, float inv_q, int D,
                           int C, int lane) {
  int s = 0;
  for (int k = 2 * lane; k < D; k += 64) {
    float2 a = load_bf16x2(hp + k), b = load_bf16x2(hq + k);
    s += quantize_node(a.x, inv_p) * quantize_node(b.x, inv_q) +
         quantize_node(a.y, inv_p) * quantize_node(b.y, inv_q);
  }
  for (int k = 2 * lane; k < C; k += 64) {
    float2 a = load_bf16x2(sp + k), b = load_bf16x2(sq + k);
    s += quantize_node(a.x, inv_p) * quantize_node(b.x, inv_q) +
         quantize_node(a.y, inv_p) * quantize_node(b.y, inv_q);
  }
  return warp_sum(s);
}

__device__ __forceinline__ float inv_norm(const bf16* hq, const bf16* sq,
                                          int D, int C, int lane) {
  return 1.0f / sqrtf(fmaxf(node_sumsq(hq, sq, D, C, lane), 1e-12f));
}

// ------------------------------------------------------- 1. K3 attention

__global__ void __launch_bounds__(256)
gnn_attention_q8_kernel(const int* __restrict__ parent_rows,
                        const bf16* __restrict__ h,      // [*, HW, D] old
                        const bf16* __restrict__ scene,  // [NK, HW, C] / null
                        signed char* __restrict__ h2q,   // [NK, HW, D] new
                        int NK, int H, int W, int D, int C) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int HW = H * W;
  if (item >= (long long)NK * HW) return;
  const int r = (int)(item / HW);
  const int p = (int)(item - (long long)r * HW);
  const int y = p / W, x = p - (p / W) * W;
  const bf16* hrow = h + (long long)parent_rows[r] * HW * D;
  const bf16* srow = scene ? scene + (long long)r * HW * C : nullptr;

  int q[9];
  neighbours(y, x, H, W, q);
  const bf16* hp = hrow + (long long)p * D;
  const bf16* sp = srow ? srow + (long long)p * C : nullptr;
  const float inv_p = inv_norm(hp, sp, D, C, lane);

  float e[9];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    e[s] = 0.f;
    if (q[s] < 0) continue;
    const bf16* hq = hrow + (long long)q[s] * D;
    const bf16* sq = srow ? srow + (long long)q[s] * C : nullptr;
    const float inv_q = s == 4 ? inv_p : inv_norm(hq, sq, D, C, lane);
    e[s] = __fmul_rn((float)node_dot_q8(hp, sp, inv_p, hq, sq, inv_q, D, C,
                                        lane),
                     kQ8Scale);
    m = fmaxf(m, e[s]);
  }
  float total = 0.f;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    if (q[s] < 0) continue;
    e[s] = expf(e[s] - m);
    total += e[s];
  }
  int attn_q[9];
#pragma unroll
  for (int s = 0; s < 9; ++s)
    attn_q[s] =
        q[s] < 0 ? 0 : __float2int_rn(__fmul_rn(__fdiv_rn(e[s], total), 127.f));

  signed char* out = h2q + item * D;
  for (int k = 2 * lane; k < D; k += 64) {
    int ax = 0, ay = 0;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (q[s] < 0) continue;
      float2 v = load_bf16x2(hrow + (long long)q[s] * D + k);
      ax += attn_q[s] * quantize_h(v.x);
      ay += attn_q[s] * quantize_h(v.y);
    }
    float2 own = load_bf16x2(hp + k);
    *reinterpret_cast<char2*>(out + k) = make_char2(
        quantize_h2(__fadd_rn(own.x, __fmul_rn((float)ax, kQ8Scale))),
        quantize_h2(__fadd_rn(own.y, __fmul_rn((float)ay, kQ8Scale))));
  }
}

// ------------------------------------------------------- 2. gates + LSTM

constexpr int BM = 128;           // pixels per block
constexpr int DT = 32;            // hidden channels per block
constexpr int BN = 4 * DT;        // gate columns per block: i, g, f, o
constexpr int BK = 64;            // depth (bytes) per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;      // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int LD = BK + 16;       // bytes a smem row: 16-byte aligned and
                                  // free of bank conflicts for the
                                  // fragment loads (20 words a row)
constexpr int A_STAGE = BM * LD;
constexpr int B_STAGE = BN * LD;
constexpr int C_LD = BN + 4;      // epilogue tile: int32 (K2), f32 (K7)
constexpr size_t PIPE_BYTES = (size_t)STAGES * (A_STAGE + B_STAGE);
constexpr size_t EPI_BYTES = (size_t)BM * C_LD * 4;
constexpr size_t GATE_SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ unsigned lds32(const signed char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// D += A (16x32 s8, row) * B (32x8 s8, col), s32 accumulation.
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage (BK deep) into a warp's 64x32 accumulator tile.
__device__ __forceinline__ void mma_stage(int (&acc)[4][4][4],
                                          const signed char* as,
                                          const signed char* bs, int wm,
                                          int wn, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const signed char* ap = as + (wm * 64 + i * 16 + g) * LD + kk + t4;
      a[i][0] = lds32(ap);
      a[i][1] = lds32(ap + 8 * LD);
      a[i][2] = lds32(ap + 16);
      a[i][3] = lds32(ap + 8 * LD + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const signed char* bp = bs + (wn * 32 + j * 8 + g) * LD + kk + t4;
      b[j][0] = lds32(bp);
      b[j][1] = lds32(bp + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
  }
}

__global__ void __launch_bounds__(THREADS)
gate_lstm_q8_kernel(const int* __restrict__ prev_ids,
                    const int* __restrict__ parent_rows,
                    const signed char* __restrict__ emb_q,  // [HW, HW, E]
                    const signed char* __restrict__ h2q,    // [NK, HW, D]
                    const bf16* __restrict__ c,       // [*, HW, D] old order
                    const signed char* __restrict__ w_qt,   // [4D, 9(E+D)]
                    const float* __restrict__ t_c,    // [4D]
                    const float* __restrict__ cell_b,  // [4D]
                    bf16* __restrict__ h_out, bf16* __restrict__ c_out,
                    int NK, int H, int W, int D, int E, float forget_bias) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);
  signed char* Bs = As + STAGES * A_STAGE;
  int* Cs = reinterpret_cast<int*>(smem);

  const int HW = H * W;
  const int Cin = E + D;
  const int Kdim = 9 * Cin;
  const long long M = (long long)NK * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * DT;
  const int tid = threadIdx.x;

  // this thread's two A rows (pixels) and 16-byte column within a stage;
  // the same (row, column) split serves the B tile's gate columns
  const int v_col = (tid & 3) * 16;
  bool a_ok[2];
  int a_y[2], a_x[2];
  long long a_emb[2], a_h2[2];
  const signed char* b_src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const long long m = m0 + row;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int r = (int)(mm / HW), p = (int)(mm - (long long)r * HW);
    a_y[i] = p / W;
    a_x[i] = p - a_y[i] * W;
    a_emb[i] = (long long)prev_ids[r] * HW * E;
    a_h2[i] = (long long)r * HW * D;
    // gate column `row` of the block: (row / DT) selects i, g, f or o
    b_src[i] = w_qt + (long long)((row / DT) * D + d0 + row % DT) * Kdim;
  }

  auto load_stage = [&](int kt, int stage) {
    signed char* as = As + stage * A_STAGE;
    signed char* bs = Bs + stage * B_STAGE;
    const int k = kt * BK + v_col;
    const int s = k / Cin, ch = k - s * Cin;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + s / 3 - 1, xx = a_x[i] + s % 3 - 1;
      const bool ok = a_ok[i] && k < Kdim && yy >= 0 && yy < H && xx >= 0 &&
                      xx < W;
      const signed char* src = emb_q;
      if (ok) {
        const long long qq = (long long)yy * W + xx;
        src = ch < E ? emb_q + a_emb[i] + qq * E + ch
                     : h2q + a_h2[i] + qq * D + (ch - E);
      }
      const int row = (tid >> 2) + i * 64;
      cp_async16(as + row * LD + v_col, src, ok);
      cp_async16(bs + row * LD + v_col, k < Kdim ? b_src[i] + k : w_qt,
                 k < Kdim);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

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

    mma_stage(acc, As + (kt % STAGES) * A_STAGE,
              Bs + (kt % STAGES) * B_STAGE, wm, wn, g, t4);
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue tile reuses the pipeline's shared memory

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int* cp = Cs + (wm * 64 + i * 16 + g) * C_LD + wn * 32 + j * 8 +
                (lane & 3) * 2;
      cp[0] = acc[i][j][0];
      cp[1] = acc[i][j][1];
      cp[8 * C_LD] = acc[i][j][2];
      cp[8 * C_LD + 1] = acc[i][j][3];
    }
  __syncthreads();

  for (int e = tid; e < BM * DT; e += THREADS) {
    const int row = e / DT, dd = e % DT;
    const long long m = m0 + row;
    if (m >= M) continue;
    const int r = (int)(m / HW), p = (int)(m - (long long)r * HW);
    const int d = d0 + dd;
    const int* gt = Cs + row * C_LD + dd;
    float gate[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = u * D + d;
      gate[u] = __fadd_rn(__fmul_rn((float)gt[u * DT], t_c[col]), cell_b[col]);
    }
    const float c_old = __bfloat162float(
        c[((long long)parent_rows[r] * HW + p) * D + d]);
    const float nc = sigmoidf_(gate[2] + forget_bias) * c_old +
                     sigmoidf_(gate[0]) * tanhf(gate[1]);
    const float nh = tanhf(nc) * sigmoidf_(gate[3]);
    h_out[m * D + d] = __float2bfloat16(nh);
    c_out[m * D + d] = __float2bfloat16(nc);
  }
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

// 16 f32 values times inv, rounded half to even, as 16 int8 (no clip:
// |x| <= r_p, so |x * 127 / r_p| rounds to at most 127).
__device__ __forceinline__ int4 quantize16(const float* src, float inv) {
  int4 out;
  int* w = reinterpret_cast<int*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(src)[j];
    w[j] = (int)(((unsigned)__float2int_rn(__fmul_rn(v.x, inv)) & 0xffu) |
                 (((unsigned)__float2int_rn(__fmul_rn(v.y, inv)) & 0xffu)
                  << 8) |
                 (((unsigned)__float2int_rn(__fmul_rn(v.z, inv)) & 0xffu)
                  << 16) |
                 ((unsigned)__float2int_rn(__fmul_rn(v.w, inv)) << 24));
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
gate_lstm_q8dyn_kernel(const int* __restrict__ prev_ids,
                       const int* __restrict__ parent_rows,
                       const signed char* __restrict__ emb_q,  // [HW, HW, E]
                       const float* __restrict__ h2f,    // [NK, HW, D]
                       const float* __restrict__ r_p,    // [NK, HW]
                       const bf16* __restrict__ c,       // [*, HW, D] old
                       const signed char* __restrict__ w_eqt,  // [4D, 9E]
                       const float* __restrict__ t_e,    // [4D]
                       const signed char* __restrict__ w_hqt,  // [4D, 9D]
                       const float* __restrict__ u_c,    // [4D]
                       const float* __restrict__ cell_b,  // [4D]
                       bf16* __restrict__ h_out, bf16* __restrict__ c_out,
                       int NK, int H, int W, int D, int E,
                       float forget_bias) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);
  signed char* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int HW = H * W;
  const int Ke = 9 * E, Kh = 9 * D;
  const int nke = (Ke + BK - 1) / BK, nkh = (Kh + BK - 1) / BK;
  const long long M = (long long)NK * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * DT;
  const int tid = threadIdx.x;

  // this thread's two A rows (pixels) and 16-byte column within a stage;
  // the same (row, column) split serves the B tile's gate columns
  const int v_col = (tid & 3) * 16;
  bool a_ok[2];
  int a_y[2], a_x[2];
  long long a_emb[2], a_h2[2];
  float a_inv[2];  // 127 / r_p of the row's own (output) pixel
  const signed char *be_src[2], *bh_src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const long long m = m0 + row;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int r = (int)(mm / HW), p = (int)(mm - (long long)r * HW);
    a_y[i] = p / W;
    a_x[i] = p - a_y[i] * W;
    a_emb[i] = (long long)prev_ids[r] * HW * E;
    a_h2[i] = (long long)r * HW * D;
    a_inv[i] = __fdiv_rn(127.f, r_p[mm]);
    const int col = (row / DT) * D + d0 + row % DT;
    be_src[i] = w_eqt + (long long)col * Ke;
    bh_src[i] = w_hqt + (long long)col * Kh;
  }

  auto load_stage = [&](int kt, int stage) {
    signed char* as = As + stage * A_STAGE;
    signed char* bs = Bs + stage * B_STAGE;
    const bool emb_half = kt < nke;
    const int Cw = emb_half ? E : D, Kw = emb_half ? Ke : Kh;
    const int k = (emb_half ? kt : kt - nke) * BK + v_col;
    const int s = k / Cw, ch = k - s * Cw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int yy = a_y[i] + s / 3 - 1, xx = a_x[i] + s % 3 - 1;
      const bool ok = a_ok[i] && k < Kw && yy >= 0 && yy < H && xx >= 0 &&
                      xx < W;
      const long long qq = (long long)yy * W + xx;
      if (emb_half) {
        cp_async16(as + row * LD + v_col,
                   ok ? emb_q + a_emb[i] + qq * E + ch : emb_q, ok);
        cp_async16(bs + row * LD + v_col, k < Kw ? be_src[i] + k : w_eqt,
                   k < Kw);
      } else {
        *reinterpret_cast<int4*>(as + row * LD + v_col) =
            ok ? quantize16(h2f + a_h2[i] + qq * D + ch, a_inv[i])
               : make_int4(0, 0, 0, 0);
        cp_async16(bs + row * LD + v_col, k < Kw ? bh_src[i] + k : w_hqt,
                   k < Kw);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc_e[4][4][4], acc_h[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc_e[i][j][v] = acc_h[i][j][v] = 0;

  const int nk = nke + nkh;
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

    const signed char* as = As + (kt % STAGES) * A_STAGE;
    const signed char* bs = Bs + (kt % STAGES) * B_STAGE;
    if (kt < nke)
      mma_stage(acc_e, as, bs, wm, wn, g, t4);
    else
      mma_stage(acc_h, as, bs, wm, wn, g, t4);
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue tile reuses the pipeline's shared memory

  // dequantise in registers, in the TPU kernel's order:
  // (acc_e * t_e + acc_h * (u_c * (r_p / 127))) + b
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 64 + i * 16 + g + half * 8;
      const long long m = m0 + row;
      const float rs = m < M ? __fdiv_rn(r_p[m], 127.f) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int cl = wn * 32 + j * 8 + (lane & 3) * 2 + v;
          const int col = (cl / DT) * D + d0 + cl % DT;
          const float ge = __fmul_rn((float)acc_e[i][j][half * 2 + v],
                                     t_e[col]);
          const float gh = __fmul_rn((float)acc_h[i][j][half * 2 + v],
                                     __fmul_rn(u_c[col], rs));
          Cs[row * C_LD + cl] = __fadd_rn(__fadd_rn(ge, gh), cell_b[col]);
        }
    }
  __syncthreads();

  for (int e = tid; e < BM * DT; e += THREADS) {
    const int row = e / DT, dd = e % DT;
    const long long m = m0 + row;
    if (m >= M) continue;
    const int r = (int)(m / HW), p = (int)(m - (long long)r * HW);
    const int d = d0 + dd;
    const float* gt = Cs + row * C_LD + dd;
    const float c_old = __bfloat162float(
        c[((long long)parent_rows[r] * HW + p) * D + d]);
    // each product and sum rounded on its own, as the plain version's
    // separate tensor operations: an fma would move c' where the two
    // terms cancel
    const float nc = __fadd_rn(
        __fmul_rn(sigmoidf_(gt[2 * DT] + forget_bias), c_old),
        __fmul_rn(sigmoidf_(gt[0]), tanhf(gt[DT])));
    const float nh = __fmul_rn(tanhf(nc), sigmoidf_(gt[3 * DT]));
    h_out[m * D + d] = __float2bfloat16(nh);
    c_out[m * D + d] = __float2bfloat16(nc);
  }
}

}  // namespace

extern "C" {

int mv_gnn_attention_q8(const int* parent_rows, const void* h,
                        const void* scene, void* h2q, int NK, int H, int W,
                        int D, int C, void* stream) {
  gnn_attention_q8_kernel<<<row_blocks(NK, H * W), ROW_THREADS, 0,
                            (cudaStream_t)stream>>>(
      parent_rows, (const bf16*)h, (const bf16*)scene, (signed char*)h2q, NK,
      H, W, D, C);
  return (int)cudaGetLastError();
}

int mv_gate_lstm_q8(const int* prev_ids, const int* parent_rows,
                    const void* emb_q, const void* h2q, const void* c,
                    const void* w_qt, const float* t_c, const float* cell_b,
                    void* h_out, void* c_out, int NK, int H, int W, int D,
                    int E, float forget_bias, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gate_lstm_q8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GATE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)NK * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / DT));
  gate_lstm_q8_kernel<<<grid, THREADS, GATE_SMEM, (cudaStream_t)stream>>>(
      prev_ids, parent_rows, (const signed char*)emb_q,
      (const signed char*)h2q, (const bf16*)c, (const signed char*)w_qt, t_c,
      cell_b, (bf16*)h_out, (bf16*)c_out, NK, H, W, D, E, forget_bias);
  return (int)cudaGetLastError();
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
  cudaError_t err = cudaFuncSetAttribute(
      gate_lstm_q8dyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GATE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)NK * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(D / DT));
  gate_lstm_q8dyn_kernel<<<grid, THREADS, GATE_SMEM, (cudaStream_t)stream>>>(
      prev_ids, parent_rows, (const signed char*)emb_q, h2f, r_p,
      (const bf16*)c, (const signed char*)w_eqt, t_e,
      (const signed char*)w_hqt, u_c, cell_b, (bf16*)h_out, (bf16*)c_out, NK,
      H, W, D, E, forget_bias);
  return (int)cudaGetLastError();
}

}  // extern "C"
