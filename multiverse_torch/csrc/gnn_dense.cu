// Grid graph attention for training on Hopper (sm_90a): the forward
// softmax(node . node^T + mask) . states per sample (K4) and its
// backward (K5), the two halves of one torch.autograd.Function
// (multiverse_torch/ops/fused_gnn.py GnnDense).
//
// Replaces the TPU kernels of multiverse_tpu/ops/pallas_gnn.py:
// _gnn_dense_fwd (body _gnn_kernel) and _gnn_dense_bwd (body
// _gnn_bwd_kernel), with their math and rounding points. The TPU kernels
// form the dense [HW, HW] f32 edge tile per sample on the MXU (1.3 MB at
// 18x32, far beyond a block's 227 KB of shared memory). The additive mask
// is -1e30 outside the 3x3 neighbourhood and exp(-1e30 - m) is 0 in f32,
// so a dense product restricted to a band of candidates is exact. Here
// every product is such a band product on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulation):
//
//   * a warp owns a tile of 16 pixels of one image row, columns
//     [x0, x0 + 16); its candidates are columns [x0 - 1, x0 + 17) of the
//     three image rows around it, 54 of them, padded to 64 (eight n8
//     tiles). Pixel i's nine neighbours are candidates 18 dy + i + dx
//     (dy, dx in 0..2), in (dy, dx) order j = 3 dy + dx;
//     ops/gnn_band.py mirrors this map for the CPU tests;
//   * a block owns a band of one image row y by BW columns of one sample
//     and stages rows y - 1 .. y + 1 and columns c0 - 1 .. c0 + BW
//     (zero-filled off the grid, so nothing is read from the next
//     sample) in chunks of 64 channels through a ring of three cp.async
//     stages: one slot of 128 bytes a pixel, its 16-byte groups
//     XOR-swizzled by the slot so that ldmatrix reads are free of bank
//     conflicts. Each slot's global row is computed once a band, into a
//     table in shared memory; a block has at least four warps, those
//     past its tiles only stage;
//   * the softmax keeps only each pixel's in-grid neighbours (absent, not
//     zero-padded), in f32 from the accumulators: max, exp, sum over the
//     quad of lanes that holds a row, then a division.
//
//   K4  gnn_band_kernel<kFwd>: edges over Dn, softmax, the weights
//       rounded to bf16 (the states' type) straight from the accumulator
//       into A fragments, then weights [16 x 64] . staged states
//       [64 x Ds chunk], f32 out.
//   K5  two launches, no atomics (deterministic):
//       1. gnn_band_kernel<kBwdEdges>: recomputes the f32 weights, then
//          dattn = bf16(g)[16 x Ds] . states[64 x Ds]^T, each warp
//          rounding its pixels' staged f32 g to bf16 on their way to the
//          A operand (and writing them out as g_c [N*HW, Ds] bf16), and
//          dedges = attn * (dattn - sum dattn attn) in f32; writes attn
//          and dedges as [N*HW, 9] f32 scratch.
//       2. gnn_band_kernel<kBwdGather>: for pixel b and neighbour a =
//          nb_j(b), for which b = nb_{8-j}(a), lays out in shared memory
//          the band weights bf16(attn[a, 8-j]) and bf16(dedges[b, j] +
//          dedges[a, 8-j]) and runs dstates = [16 x 64] . g_c band
//          and dnode = [16 x 64] . node band, the dense form's attn^T g
//          and (dedges + dedges^T) node; f32 sums written as bf16.
//       One cooperative launch with a grid-wide barrier between the two
//       passes measured slower (PERF.md).
//
// Bound: at the training shape (N = 20 samples, 18x32, node width 320,
// state width 256) the band products are ~0.8 GFLOP (K4) against ~25 MB
// (K4) and ~38 MB (K5) of inputs and outputs: both are bound by device
// memory (7.5 us and 11.4 us at 3.35 TB/s). Staging a band in shared
// memory reads each input row from device memory about once (the halo
// rows a neighbouring block stages again come from L2), and the
// products, on the tensor cores, take far less than the bytes.
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launches.

#include "common.cuh"

namespace {

constexpr int TILE = 16;         // pixels of one image row a warp (mma M)
constexpr int CAND_COLS = 18;    // candidate columns x0 - 1 .. x0 + 16
constexpr int LIVE_CANDS = 3 * CAND_COLS;   // 54; 54..63 are padding
constexpr int CHUNK = 64;        // channels of one staged chunk
constexpr int SLOT_BYTES = CHUNK * 2;       // one pixel's bf16 chunk
constexpr int MAX_THREADS = 128;

enum Mode { kFwd, kBwdEdges, kBwdGather };

// chunks in the ring, two loading while one is in use: the edges launch,
// whose stages also hold f32 g, then has room for three blocks an SM at
// the training shape (two at four stages)
constexpr int STAGES = 3;

struct Args {
  const bf16* node;    // [N*HW, Dn]
  const bf16* states;  // [N*HW, Ds]
  const float* g;      // [N*HW, Ds] (K5)
  float* out;          // [N*HW, Ds] (K4)
  float* attn;         // [N*HW, 9] scratch (K5)
  float* dedges;       // [N*HW, 9] scratch (K5)
  bf16* g_c;           // [N*HW, Ds] scratch (K5): bf16(g)
  bf16* dnode;         // [N*HW, Dn] (K5)
  bf16* dstates;       // [N*HW, Ds] (K5)
  int N, H, W, Dn, Ds;
  int BW;              // a block's band: one image row by BW columns
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// byte offset of the 8-channel group col8 of a slot in a staged chunk
__device__ __forceinline__ unsigned swz(int slot, int col8) {
  return slot * SLOT_BYTES + ((col8 ^ (slot & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// cp.async of BYTES (4, 8 or 16); pred false reads nothing and zeroes them
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool pred) {
  const unsigned s = smem_addr(smem);
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A block's band of one sample and the pixels it stages.
struct Band {
  int H, W, BW, SW, slots;   // SW = BW + 2 staged columns, 3 rows
  int y, c0;                 // the band's image row and first column
  long long base;            // first row of the sample in [N*HW, D]
  // in shared memory, made once a band: the global row of each staged
  // slot (rows y - 1 .., columns c0 - 1 ..) and of each own pixel (row y,
  // columns c0 ..), -1 off the grid
  const int* srow;
  const int* orow;

  __device__ bool in_grid(int yy, int xx) const {
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  }
  __device__ int row_at(int yy, int xx) const {
    return in_grid(yy, xx) ? (int)(base + (long long)yy * W + xx) : -1;
  }
};

// Copies channels k0 .. k0 + 63 of the bf16 rows [D] of every staged
// slot into swizzled slots, zero past D and off the grid; VEC channels a
// copy: 8 (16 bytes) where every width is a multiple of 8, else 2.
template <int VEC>
__device__ __forceinline__ void stage_bf16(char* buf, const bf16* src,
                                           const Band& b, int D, int k0) {
  constexpr int PER = CHUNK / VEC;
  for (int v = threadIdx.x; v < b.slots * PER; v += blockDim.x) {
    const int slot = v / PER, ch = (v % PER) * VEC;
    const long long row = b.srow[slot];
    const bool ok = row >= 0 && k0 + ch < D;
    cp_async<2 * VEC>(buf + swz(slot, ch >> 3) + (ch & 7) * 2,
                      ok ? src + row * D + k0 + ch : src, ok);
  }
}

// Copies channels k0 .. k0 + 63 of the f32 rows [D] of the band's own
// pixels into plain slots of 256 bytes; FV floats a copy (4 or 2).
template <int FV>
__device__ __forceinline__ void stage_own_f32(char* buf, const float* src,
                                              const Band& b, int D, int k0) {
  constexpr int PER = CHUNK / FV;
  for (int v = threadIdx.x; v < b.BW * PER; v += blockDim.x) {
    const int slot = v / PER, ch = (v % PER) * FV;
    const long long row = b.orow[slot];
    const bool ok = row >= 0 && k0 + ch < D;
    cp_async<4 * FV>(buf + slot * 4 * CHUNK + ch * 4,
                     ok ? src + row * D + k0 + ch : src, ok);
  }
}

// One warp's 16 own pixels (slots s0 ..) of the staged f32 chunk rounded
// to bf16, into swizzled slots and into the rows of g_c [N*HW, D] (bf16(g)
// for the second launch), row0 the first pixel's row.
__device__ __forceinline__ void round_tile(char* dst, const char* src,
                                           int s0, bf16* g_c, long long row0,
                                           int npix, int D, int k0) {
  const int lane = threadIdx.x & 31, ch = 2 * lane;
#pragma unroll 4
  for (int i = 0; i < TILE; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(
        src + (s0 + i) * 4 * CHUNK + ch * 4);
    const unsigned packed = pack_bf16(x.x, x.y);
    *reinterpret_cast<unsigned*>(dst + swz(s0 + i, ch >> 3) + (ch & 7) * 2) =
        packed;
    if (i < npix && k0 + ch < D)
      *reinterpret_cast<unsigned*>(g_c + (row0 + i) * D + k0 + ch) = packed;
  }
  __syncwarp();
}

// acc[8 n-tiles] += A [16 x 64 chunk] . B^T, A the 16 rows from slot
// a_slot on (lane & 15), B the 64 candidates (non-transposed: rows of
// channels, one per candidate), b_slot[p] this lane's candidate of pair p.
__device__ __forceinline__ void band_nt(unsigned a_base, int a_slot,
                                        unsigned b_base, const int (&b_slot)[4],
                                        float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    ldsm_x4(a_base + swz(a_slot, 2 * kk + (lane >> 4)), a);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      unsigned bb[4];
      ldsm_x4(b_base + swz(b_slot[p], 2 * kk + ((lane >> 3) & 1)), bb);
      mma_bf16(acc[2 * p], a, bb[0], bb[1]);
      mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[8 n-tiles of channels] = P [16 x 64 candidates] . V [64 x 64 chunk],
// P as A fragments of its four k16 steps, V the staged candidates
// (transposed loads), t_slot[kk] this lane's candidate of step kk.
__device__ __forceinline__ void band_nn(const unsigned (&P)[4][4],
                                        unsigned v_base,
                                        const int (&t_slot)[4],
                                        float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned bb[4];
      ldsm_x4_t(v_base + swz(t_slot[kk], 2 * np + (lane >> 4)), bb);
      mma_bf16(acc[2 * np], P[kk], bb[0], bb[1]);
      mma_bf16(acc[2 * np + 1], P[kk], bb[2], bb[3]);
    }
}

// Writes channels k0 .. k0 + 63 of the 16 pixels' rows (f32 or bf16).
template <class T>
__device__ __forceinline__ void store_rows(T* dst, long long row0, int npix,
                                           int D, int k0,
                                           const float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = (lane >> 2) + 8 * h;
    if (i >= npix) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int ch = k0 + 8 * nt + 2 * (lane & 3);
      if (ch >= D) continue;
      T* p = dst + (row0 + i) * D + ch;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// One block a band (blockIdx.x numbers them, columns fastest), one warp
// a tile.
template <int MODE, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
gnn_band_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;

  Band b;
  b.H = a.H;
  b.W = a.W;
  b.BW = a.BW;
  b.SW = a.BW + 2;
  b.slots = 3 * b.SW;
  {
    const int ncb = (a.W + a.BW - 1) / a.BW;
    const int bid = blockIdx.x / ncb;
    b.c0 = blockIdx.x % ncb * a.BW;
    b.y = bid % a.H;
    b.base = (long long)(bid / a.H) * a.H * a.W;
  }
  // this warp's tile: image row y, columns x0 .. x0 + npix - 1; warps
  // past the band's tiles only stage
  const int T = a.BW / TILE;
  const int y = b.y, x0 = b.c0 + warp * TILE;
  const bool live_tile = warp < T && x0 < a.W;
  const int npix = live_tile ? min(TILE, a.W - x0) : 0;
  const long long row0 = b.base + (long long)y * a.W + x0;

  // the staged slot of this lane's candidates: c = 18 dy + dx is pixel
  // (y + dy - 1, x0 + dx - 1); padding reads slot 0 (weights 0)
  auto cand_slot = [&](int c) {
    return c < LIVE_CANDS
               ? c / CAND_COLS * b.SW + warp * TILE + c % CAND_COLS
               : 0;
  };
  int b_slot[4], t_slot[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    b_slot[p] = cand_slot(16 * p + (lane & 7) + ((lane >> 4) << 3));
    t_slot[p] = cand_slot(16 * p + (lane & 7) + (((lane >> 3) & 1) << 3));
  }
  const int own_slot = b.SW + warp * TILE + 1 + (lane & 15);

  // bit 4 nt + 2 h + e: this lane's accumulator entry (row g8 + 8h,
  // candidate 8 nt + 2 t4 + e) is one of the row pixel's in-grid
  // neighbours
  unsigned live = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = g8 + 8 * h, c = 8 * nt + 2 * t4 + e;
        const int dy = c / CAND_COLS, dx = c % CAND_COLS - i;
        if (i < npix && c < LIVE_CANDS && dx >= 0 && dx < 3 &&
            b.in_grid(y + dy - 1, x0 + i + dx - 1))
          live |= 1u << (4 * nt + 2 * h + e);
      }

  // the ring of STAGES stages: the band's bf16 chunk, and for the edges
  // launch's second pass the own pixels' f32 g beside it; after the ring,
  // the own pixels' g rounded to bf16 (edges) or the band weights
  // (gather, per warp)
  constexpr int FV = VEC == 8 ? 4 : 2;   // f32 values a copy
  const int band_bytes = b.slots * SLOT_BYTES;
  const int own_bytes = MODE == kBwdEdges ? a.BW * 4 * CHUNK : 0;
  const int stage_bytes = band_bytes + own_bytes;
  char* const after = smem + STAGES * stage_bytes;
  const int after_bytes = MODE == kBwdEdges    ? a.BW * SLOT_BYTES
                          : MODE == kBwdGather ? 2 * a.BW * SLOT_BYTES
                                               : 0;
  {
    int* rows = reinterpret_cast<int*>(after + after_bytes);
    for (int s = threadIdx.x; s < b.slots + a.BW; s += blockDim.x)
      rows[s] = s < b.slots
                    ? b.row_at(y - 1 + s / b.SW, b.c0 - 1 + s % b.SW)
                    : b.row_at(y, b.c0 + s - b.slots);
    b.srow = rows;
    b.orow = rows + b.slots;
  }
  __syncthreads();

  // pass A over DA channels, then pass B over DB
  const int DA = MODE == kBwdGather ? a.Ds : a.Dn;
  const int DB = MODE == kBwdGather ? a.Dn : a.Ds;
  const int nA = (DA + CHUNK - 1) / CHUNK;
  const int n = nA + (DB + CHUNK - 1) / CHUNK;
  auto issue = [&](int it) {
    char* buf = smem + (it % STAGES) * stage_bytes;
    if (it < nA) {
      if (MODE == kBwdGather)   // bf16(g), from the edges launch
        stage_bf16<VEC>(buf, a.g_c, b, a.Ds, it * CHUNK);
      else
        stage_bf16<VEC>(buf, a.node, b, a.Dn, it * CHUNK);
    } else if (MODE == kBwdGather) {
      stage_bf16<VEC>(buf, a.node, b, a.Dn, (it - nA) * CHUNK);
    } else {
      stage_bf16<VEC>(buf, a.states, b, a.Ds, (it - nA) * CHUNK);
      if (MODE == kBwdEdges)
        stage_own_f32<FV>(buf + band_bytes, a.g, b, a.Ds, (it - nA) * CHUNK);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }

  float acc[8][4], acc2[8][4];
  unsigned P[4][4], Q[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = acc2[nt][e] = 0.f;

  if (MODE == kBwdGather && warp < T) {
    // this warp's band weights, two [16 x 64] bf16 matrices laid out as
    // staged slots: wa[b][c] = attn[a, 8-j], ws[b][c] = dedges[b, j] +
    // dedges[a, 8-j] for candidate c = 18 dy + i + dx of neighbour a
    char* wm = after + warp * 2 * TILE * SLOT_BYTES;
    uint4* z = reinterpret_cast<uint4*>(wm);
    for (int k = lane; k < 2 * TILE * SLOT_BYTES / 16; k += 32)
      z[k] = make_uint4(0, 0, 0, 0);
    constexpr int PER_LANE = (TILE * 9 + 31) / 32;
    float wa[PER_LANE], ws[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {   // loads first, all in flight
      const int e = lane + 32 * q, i = e / 9, j = e % 9;
      const int ya = y + j / 3 - 1, xa = x0 + i + j % 3 - 1;
      wa[q] = ws[q] = 0.f;
      if (e < TILE * 9 && i < npix && b.in_grid(ya, xa)) {
        const long long pa = b.base + (long long)ya * a.W + xa;
        wa[q] = __ldcg(a.attn + pa * 9 + 8 - j);
        ws[q] = __ldcg(a.dedges + (row0 + i) * 9 + j) +
                __ldcg(a.dedges + pa * 9 + 8 - j);
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int e = lane + 32 * q, i = e / 9, j = e % 9;
      if (e >= TILE * 9 || i >= npix) continue;
      const int c = CAND_COLS * (j / 3) + i + j % 3;
      const unsigned off = swz(i, c >> 3) + (c & 7) * 2;
      *reinterpret_cast<bf16*>(wm + off) = __float2bfloat16(wa[q]);
      *reinterpret_cast<bf16*>(wm + TILE * SLOT_BYTES + off) =
          __float2bfloat16(ws[q]);
    }
    __syncwarp();
    const unsigned wb = smem_addr(wm);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(wb + swz(lane & 15, 2 * kk + (lane >> 4)), P[kk]);
      ldsm_x4(wb + TILE * SLOT_BYTES + swz(lane & 15, 2 * kk + (lane >> 4)),
              Q[kk]);
    }
  }

  for (int it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    char* const buf = smem + (it % STAGES) * stage_bytes;
    // the stage chunk it - 1 used: every thread is past its compute
    if (it + STAGES - 1 < n) issue(it + STAGES - 1);
    cp_async_commit();
    if (!live_tile) continue;
    const unsigned base = smem_addr(buf);
    if constexpr (MODE == kBwdGather) {
      if (it < nA) {   // dstates = wa . bf16(g) band
        band_nn(P, base, t_slot, acc);
        store_rows(a.dstates, row0, npix, a.Ds, it * CHUNK, acc);
      } else {         // dnode = ws . node band
        band_nn(Q, base, t_slot, acc);
        store_rows(a.dnode, row0, npix, a.Dn, (it - nA) * CHUNK, acc);
      }
    } else if (it < nA) {   // edges
      band_nt(base, own_slot, base, b_slot, acc);
      if (it == nA - 1) {
        // f32 softmax over each row's live entries
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (live >> (4 * nt + 2 * h + e) & 1)
                m = fmaxf(m, acc[nt][2 * h + e]);
          m = quad_max(m);
          float total = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = acc[nt][2 * h + e];
              v = (live >> (4 * nt + 2 * h + e) & 1) ? expf(v - m) : 0.f;
              total += v;
            }
          total = quad_sum(total);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = acc[nt][2 * h + e];
              v = total > 0.f ? v / total : 0.f;
            }
        }
        if constexpr (MODE == kFwd) {
          // the accumulators of n-tiles 2kk, 2kk + 1 are the A fragment
          // of k step kk, rounded to bf16
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            P[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
            P[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
            P[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
            P[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
          }
        }
      }
    } else if constexpr (MODE == kFwd) {   // out = bf16(attn) . states
      band_nn(P, base, t_slot, acc2);
      store_rows(a.out, row0, npix, a.Ds, (it - nA) * CHUNK, acc2);
    } else {   // dattn += bf16(g) . states^T, g rounded by this warp
      const int s0 = warp * TILE;
      round_tile(after, buf + band_bytes, s0, a.g_c, row0, npix, a.Ds,
                 (it - nA) * CHUNK);
      band_nt(smem_addr(after), s0 + (lane & 15), base, b_slot, acc2);
    }
  }

  if constexpr (MODE == kBwdEdges) {
    if (!live_tile) return;
    // dedges = attn * (dattn - sum dattn attn); every one of a pixel's
    // nine positions is written, 0 where the neighbour is off the grid
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rs += acc2[nt][2 * h + e] * acc[nt][2 * h + e];
      rs = quad_sum(rs);
      const int i = g8 + 8 * h;
      if (i >= npix) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nt + 2 * t4 + e;
          const int dy = c / CAND_COLS, dx = c % CAND_COLS - i;
          if (c >= LIVE_CANDS || dx < 0 || dx > 2) continue;
          const float w = acc[nt][2 * h + e];
          const long long k = (row0 + i) * 9 + 3 * dy + dx;
          a.attn[k] = w;
          a.dedges[k] = w * (acc2[nt][2 * h + e] - rs);
        }
    }
  }
}

// The band of a launch: one image row by BW columns, the width rounded up
// to 16, at most 64 (two rows a band measured slower at the training
// shape: PERF.md).
Args make_args(int N, int H, int W, int Dn, int Ds) {
  Args a = {};
  a.N = N;
  a.H = H;
  a.W = W;
  a.Dn = Dn;
  a.Ds = Ds;
  const int w16 = (W + TILE - 1) / TILE * TILE;
  a.BW = w16 < 64 ? w16 : 64;
  return a;
}

template <int MODE>
size_t smem_bytes(const Args& a) {
  const size_t slots = 3 * (size_t)(a.BW + 2);
  const size_t stage =
      slots * SLOT_BYTES + (MODE == kBwdEdges ? a.BW * 4 * CHUNK : 0);
  // the own pixels' bf16 g (edges); two 16-row weight matrices a warp
  // (gather)
  const size_t after = MODE == kBwdEdges    ? a.BW * SLOT_BYTES
                       : MODE == kBwdGather ? 2 * a.BW * SLOT_BYTES
                                            : 0;
  return STAGES * stage + after + (slots + a.BW) * sizeof(int);
}

// one warp a tile, and at least four warps to stage
int threads(const Args& a) {
  const int tiles = a.BW / TILE;
  return (tiles > 4 ? tiles : 4) * 32;
}

int bands(const Args& a) {
  return a.N * a.H * ((a.W + a.BW - 1) / a.BW);
}

template <int MODE, int VEC>
cudaError_t launch_mode(const Args& a, cudaStream_t stream) {
  static SmemAttr attr;
  const size_t smem = smem_bytes<MODE>(a);
  cudaError_t err = attr.raise((const void*)gnn_band_kernel<MODE, VEC>,
                               (int)smem);
  if (err != cudaSuccess) return err;
  gnn_band_kernel<MODE, VEC>
      <<<bands(a), threads(a), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // 16-byte copies where every row starts on a 16-byte boundary
  return a.Dn % 8 == 0 && a.Ds % 8 == 0 ? launch_mode<MODE, 8>(a, stream)
                                        : launch_mode<MODE, 2>(a, stream);
}

}  // namespace

extern "C" {

int mv_gnn_dense_fwd(const void* node, const void* states, float* out, int N,
                     int H, int W, int Dn, int Ds, void* stream) {
  // the launches keep a pixel's row as an int
  if ((long long)N * H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Args a = make_args(N, H, W, Dn, Ds);
  a.node = (const bf16*)node;
  a.states = (const bf16*)states;
  a.out = out;
  return (int)launch<kFwd>(a, (cudaStream_t)stream);
}

int mv_gnn_dense_bwd(const void* node, const void* states, const float* g,
                     float* attn, float* dedges, void* g_c, void* dnode,
                     void* dstates,
                     int N, int H, int W, int Dn, int Ds, void* stream) {
  if ((long long)N * H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Args a = make_args(N, H, W, Dn, Ds);
  a.node = (const bf16*)node;
  a.states = (const bf16*)states;
  a.g = g;
  a.attn = attn;
  a.dedges = dedges;
  a.g_c = (bf16*)g_c;
  a.dnode = (bf16*)dnode;
  a.dstates = (bf16*)dstates;
  cudaError_t err = launch<kBwdEdges>(a, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<kBwdGather>(a, (cudaStream_t)stream);
}

}  // extern "C"
