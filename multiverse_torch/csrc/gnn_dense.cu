// Grid graph attention for training on Hopper (sm_90a): the forward
// softmax(node . node^T + mask) . states per sample (K4) and its
// backward (K5), the two halves of one torch.autograd.Function
// (multiverse_torch/ops/fused_gnn.py GnnDense).
//
// Replaces the TPU kernels of multiverse_tpu/ops/pallas_gnn.py:
// _gnn_dense_fwd (body _gnn_kernel) and _gnn_dense_bwd (body
// _gnn_bwd_kernel), with their math and rounding points and another
// block structure. The TPU kernels form the dense [HW, HW] f32 edge tile
// per sample (1.3 MB at 18x32, far beyond a block's 227 KB of shared
// memory). The additive mask is -1e30 outside the 3x3 neighbourhood and
// exp(-1e30 - m) is 0 in f32, so every attention row holds at most nine
// live weights and the banded form here is exact:
//
//   K4  gnn_dense_fwd_kernel    one warp per pixel: nine f32 dot products
//       of bf16 node rows (out-of-grid neighbours are absent, not zero
//       padded), an f32 softmax, the weights rounded to the states' type
//       (bf16), then the weighted sum of the nine neighbours' states in
//       f32. The output is f32: the caller adds it to bf16 h.
//   K5  two launches, no atomics (deterministic):
//       1. gnn_dense_bwd_edges_kernel, one warp per pixel a: recomputes
//          the nine f32 weights attn[a, j], dattn[a, j] = bf16(g[a]) .
//          states[nb_j(a)] in f32, and dedges[a, j] = attn[a, j] *
//          (dattn[a, j] - sum_j dattn[a, j] attn[a, j]); writes attn and
//          dedges as [N*HW, 9] f32 scratch.
//       2. gnn_dense_bwd_gather_kernel, one warp per pixel b, gathers
//          over its neighbours a = nb_j(b), for which b = nb_{8-j}(a):
//          dstates[b] = sum_j bf16(attn[a, 8-j]) * bf16(g[a]) and
//          dnode[b] = sum_j bf16(dedges[b, j] + dedges[a, 8-j]) * node[a]
//          (the dense form's attn^T g and (dedges + dedges^T) node; both
//          are banded because the neighbourhood is symmetric), f32
//          sums written as bf16.
//
// Bound: at the training shape (N = 20 samples, 18x32, node width 320,
// state width 256) the banded products are ~0.1 GFLOP against ~25 MB
// (K4) and ~38 MB (K5) of inputs and outputs: both are bound by device
// memory (7.5 us and 11.4 us at 3.35 TB/s). A warp reads its nine
// neighbours' rows, which the neighbouring pixels' warps read too, so
// most of those reads hit L1/L2; staging a band of image rows in shared
// memory is the next step for speed.
//
// Plain C interface, bound from Python with ctypes; every function
// returns the cudaError_t of its launches.

#include "common.cuh"

namespace {

// The f32 softmax of pixel p's in-grid neighbours (q[j] < 0: absent).
// Every lane ends with the same nine weights.
__device__ __forceinline__ void neighbour_softmax(
    const bf16* __restrict__ node, long long base, int p, const int q[9],
    int Dn, int lane, float attn[9]) {
  float part[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) part[j] = 0.f;
  const bf16* own = node + (base + p) * Dn;
  for (int k = 2 * lane; k < Dn; k += 64) {
    const float2 a = load_bf16x2(own + k);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (q[j] < 0) continue;
      const float2 b = load_bf16x2(node + (base + q[j]) * Dn + k);
      part[j] += a.x * b.x + a.y * b.y;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    attn[j] = warp_sum(part[j]);
    if (q[j] >= 0) m = fmaxf(m, attn[j]);
  }
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    attn[j] = q[j] < 0 ? 0.f : expf(attn[j] - m);
    total += attn[j];
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) attn[j] = attn[j] / total;
}

struct Pixel {
  long long item, base;  // global row, first row of its sample
  int p;                 // pixel within the sample
  int q[9];
};

__device__ __forceinline__ bool locate(int N, int H, int W, Pixel& px) {
  const int HW = H * W;
  px.item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (px.item >= (long long)N * HW) return false;
  const long long n = px.item / HW;
  px.base = n * HW;
  px.p = (int)(px.item - px.base);
  neighbours(px.p / W, px.p % W, H, W, px.q);
  return true;
}

// ----------------------------------------------------------------- K4

__global__ void __launch_bounds__(ROW_THREADS)
gnn_dense_fwd_kernel(const bf16* __restrict__ node,    // [N*HW, Dn]
                     const bf16* __restrict__ states,  // [N*HW, Ds]
                     float* __restrict__ out,          // [N*HW, Ds]
                     int N, int H, int W, int Dn, int Ds) {
  Pixel px;
  if (!locate(N, H, W, px)) return;
  const int lane = threadIdx.x & 31;
  float a[9];
  neighbour_softmax(node, px.base, px.p, px.q, Dn, lane, a);
#pragma unroll
  for (int j = 0; j < 9; ++j) a[j] = round_bf16(a[j]);
  for (int k = 2 * lane; k < Ds; k += 64) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (px.q[j] < 0) continue;
      const float2 v = load_bf16x2(states + (px.base + px.q[j]) * Ds + k);
      ax += a[j] * v.x;
      ay += a[j] * v.y;
    }
    *reinterpret_cast<float2*>(out + px.item * Ds + k) = make_float2(ax, ay);
  }
}

// ------------------------------------------------------------- K5, 1/2

__global__ void __launch_bounds__(ROW_THREADS)
gnn_dense_bwd_edges_kernel(const bf16* __restrict__ node,    // [N*HW, Dn]
                           const bf16* __restrict__ states,  // [N*HW, Ds]
                           const float* __restrict__ g,      // [N*HW, Ds]
                           float* __restrict__ attn_out,     // [N*HW, 9]
                           float* __restrict__ dedges_out,   // [N*HW, 9]
                           int N, int H, int W, int Dn, int Ds) {
  Pixel px;
  if (!locate(N, H, W, px)) return;
  const int lane = threadIdx.x & 31;
  float a[9];
  neighbour_softmax(node, px.base, px.p, px.q, Dn, lane, a);
  float part[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) part[j] = 0.f;
  for (int k = 2 * lane; k < Ds; k += 64) {
    const float2 gv = *reinterpret_cast<const float2*>(g + px.item * Ds + k);
    const float gx = round_bf16(gv.x), gy = round_bf16(gv.y);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (px.q[j] < 0) continue;
      const float2 v = load_bf16x2(states + (px.base + px.q[j]) * Ds + k);
      part[j] += gx * v.x + gy * v.y;
    }
  }
  float rs = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    part[j] = warp_sum(part[j]);  // dattn[a, j]
    rs += part[j] * a[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      attn_out[px.item * 9 + j] = a[j];
      dedges_out[px.item * 9 + j] = a[j] * (part[j] - rs);
    }
  }
}

// ------------------------------------------------------------- K5, 2/2

__global__ void __launch_bounds__(ROW_THREADS)
gnn_dense_bwd_gather_kernel(const bf16* __restrict__ node,     // [N*HW, Dn]
                            const float* __restrict__ g,       // [N*HW, Ds]
                            const float* __restrict__ attn,    // [N*HW, 9]
                            const float* __restrict__ dedges,  // [N*HW, 9]
                            bf16* __restrict__ dnode,          // [N*HW, Dn]
                            bf16* __restrict__ dstates,        // [N*HW, Ds]
                            int N, int H, int W, int Dn, int Ds) {
  Pixel px;
  if (!locate(N, H, W, px)) return;
  const int lane = threadIdx.x & 31;
  // b = px; its neighbour a = q[j] sees b at position 8 - j
  float wa[9], ws[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    wa[j] = ws[j] = 0.f;
    if (px.q[j] < 0) continue;
    const long long a = px.base + px.q[j];
    wa[j] = round_bf16(attn[a * 9 + (8 - j)]);
    ws[j] = round_bf16(dedges[px.item * 9 + j] + dedges[a * 9 + (8 - j)]);
  }
  for (int k = 2 * lane; k < Ds; k += 64) {
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (px.q[j] < 0) continue;
      const float2 gv = *reinterpret_cast<const float2*>(
          g + (px.base + px.q[j]) * Ds + k);
      sx += wa[j] * round_bf16(gv.x);
      sy += wa[j] * round_bf16(gv.y);
    }
    *reinterpret_cast<__nv_bfloat162*>(dstates + px.item * Ds + k) =
        __floats2bfloat162_rn(sx, sy);
  }
  for (int k = 2 * lane; k < Dn; k += 64) {
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (px.q[j] < 0) continue;
      const float2 v = load_bf16x2(node + (px.base + px.q[j]) * Dn + k);
      sx += ws[j] * v.x;
      sy += ws[j] * v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(dnode + px.item * Dn + k) =
        __floats2bfloat162_rn(sx, sy);
  }
}

}  // namespace

extern "C" {

int mv_gnn_dense_fwd(const void* node, const void* states, float* out, int N,
                     int H, int W, int Dn, int Ds, void* stream) {
  gnn_dense_fwd_kernel<<<row_blocks(N, H * W), ROW_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const bf16*)node, (const bf16*)states, out, N, H, W, Dn, Ds);
  return (int)cudaGetLastError();
}

int mv_gnn_dense_bwd(const void* node, const void* states, const float* g,
                     float* attn, float* dedges, void* dnode, void* dstates,
                     int N, int H, int W, int Dn, int Ds, void* stream) {
  const unsigned blocks = row_blocks(N, H * W);
  gnn_dense_bwd_edges_kernel<<<blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)node, (const bf16*)states, g, attn, dedges, N, H, W, Dn,
      Ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gnn_dense_bwd_gather_kernel<<<blocks, ROW_THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const bf16*)node, g, attn, dedges, (bf16*)dnode, (bf16*)dstates, N, H,
      W, Dn, Ds);
  return (int)cudaGetLastError();
}

}  // extern "C"
