// Tiles of the f32 CUDA-core attention kernels (flash_train.cu, flash_ring.cu).
//
// A block of ATT_THREADS = 256 threads works as a 16 x 16 grid on 64-row
// tiles: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + i (i < 4) of
// a 64 x 64 score tile and columns tx + 16*j (j < 4); of a 64 x D output tile
// it owns the same rows and columns tx + 16*c (c < D / 16). Tiles sit in
// shared memory as f32, rows padded to D + 1 floats so that the reads of the
// products are free of bank conflicts.
#pragma once

#include "common.cuh"

namespace vv {

constexpr int ATT_TILE = 64, ATT_THREADS = 256;

// dst[r * (D + 1) + d] = src[(t0 + r) * rs + d] for the 64 rows of a tile;
// rows at or past n_t are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int t0, int n_t,
                                          int rs) {
  for (int idx = threadIdx.x; idx < ATT_TILE * D; idx += ATT_THREADS) {
    const int r = idx / D, d = idx % D, t = t0 + r;
    dst[r * (D + 1) + d] = t < n_t ? to_f(src[(size_t)t * rs + d]) : 0.f;
  }
}

// Max and sum over the 16 threads that share a row (one half warp).
static __device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vv
