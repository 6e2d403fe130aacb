// Merge of the key splits of kernel B's prefill route (flash_prefill.cu);
// the decode route (flash_decode.cu) merges inside its own launch.
#pragma once

#include "common.cuh"

namespace vv {

constexpr float FA_M_INIT = -1e30f;  // m of a split that has seen no live key

// grid (R, B*KH), block D threads: merge the splits of one folded row.
template <typename QT>
__global__ void flash_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_m,
                                     const float* __restrict__ part_l, QT* __restrict__ out,
                                     int W, int NH, int KH, int D, int n_splits) {
  const int gr = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / KH, kh = bh % KH;
  const int G = NH / KH;
  const int R = W * G;
  const int d = threadIdx.x;
  float M = FA_M_INIT;
  for (int sp = 0; sp < n_splits; ++sp) M = fmaxf(M, part_m[((size_t)bh * n_splits + sp) * R + gr]);
  float L = 0.f, O = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t p = ((size_t)bh * n_splits + sp) * R + gr;
    const float w = expf(part_m[p] - M);
    L += part_l[p] * w;
    O += part_acc[p * D + d] * w;
  }
  const int w = gr / G, g = gr % G;
  out[((size_t)(b * W + w) * NH + kh * G + g) * D + d] = from_f<QT>(O / fmaxf(L, 1e-30f));
}

}  // namespace vv
