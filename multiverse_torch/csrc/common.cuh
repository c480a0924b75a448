// Device and launch helpers shared by the fused decode-step kernels
// (fused_decode.cu: bf16, fused_decode_q8.cu: int8, int8a, int8_dyn) and
// the training attention (gnn_dense.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h + agg (|h + agg| < 2) to the int8 gate input of the q8 tiers:
// clip(rint(x * 127 / 2), -127, 127), rounding half to even as
// jnp.round does.
__device__ __forceinline__ signed char quantize_h2(float x) {
  return (signed char)fminf(fmaxf(rintf(__fmul_rn(x, 63.5f)), -127.f), 127.f);
}

// Sum of squares of node = h_row (+) scene_row, over the warp.
__device__ __forceinline__ float node_sumsq(const bf16* hq, const bf16* sq,
                                            int D, int C, int lane) {
  float s = 0.f;
  for (int k = 2 * lane; k < D; k += 64) {
    float2 v = load_bf16x2(hq + k);
    s += v.x * v.x + v.y * v.y;
  }
  for (int k = 2 * lane; k < C; k += 64) {
    float2 v = load_bf16x2(sq + k);
    s += v.x * v.x + v.y * v.y;
  }
  return warp_sum(s);
}

// The 3x3 neighbourhood of pixel (y, x) in (dy, dx) order; -1 marks a
// position outside the grid.
__device__ __forceinline__ void neighbours(int y, int x, int H, int W,
                                           int q[9]) {
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int yy = y + s / 3 - 1, xx = x + s % 3 - 1;
    q[s] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? yy * W + xx : -1;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Launch shape of the per-pixel kernels: 8 warps, one (row, pixel) each.
constexpr int ROW_THREADS = 256;

inline unsigned row_blocks(int NK, int HW) {
  const long long items = (long long)NK * HW;
  return (unsigned)((items + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32));
}

// ------------------------------------------------------------- host side

constexpr int kMaxDevices = 64;

// The SM count of the current card, read once per card.
inline cudaError_t sm_count(int* sms) {
  static std::atomic<int> counts[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  int n = counts[dev].load();
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    counts[dev].store(n);
  }
  *sms = n;
  return cudaSuccess;
}

// A kernel's dynamic shared-memory limit (one static instance per kernel):
// set on a card at its first launch (above 48 KB only by this attribute),
// and raised only when a launch needs more than was set; the SM's split
// of L1 and shared memory prefers shared memory, so that as many blocks as
// fit are resident at once.
struct SmemAttr {
  std::atomic<int> bytes[kMaxDevices];
  cudaError_t raise(const void* kernel, int need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && bytes[dev].load() >= need) return cudaSuccess;
    if (need > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < kMaxDevices) bytes[dev].store(need);
    return err;
  }
};

// The tile of the staged attention launches: up to 2 image rows by 32
// columns, narrower where the tile and its one-pixel halo (`pixel_bytes`
// a staged pixel, plus `fixed` bytes) would not fit in `max_bytes` of
// shared memory. Returns the shared memory it takes, or 0 if none fits.
inline size_t attn_tile(int H, int W, size_t pixel_bytes, size_t fixed,
                        size_t max_bytes, int* BR, int* BW) {
  int br = H < 2 ? H : 2, bw = W < 32 ? W : 32;
  auto bytes = [&]() {
    return (size_t)(br + 2) * (bw + 2) * pixel_bytes + fixed;
  };
  while (bytes() > max_bytes && (br > 1 || bw > 1)) {
    if (br > 1)
      br = 1;
    else
      bw = (bw + 1) / 2;
  }
  *BR = br;
  *BW = bw;
  return bytes() <= max_bytes ? bytes() : 0;
}

}  // namespace
