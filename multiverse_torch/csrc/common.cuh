// Device helpers shared by the fused decode-step kernels
// (fused_decode.cu: bf16, fused_decode_q8.cu: int8, int8a, int8_dyn).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
