// Kernel D's prologue, loader and epilogues, shared by its two routes: the
// weight-streaming core (vocoder_stage.cu over weight_stream.cuh, 1-2 rows
// and dense weights) and the split-K tensor-core core (vocoder_stage_tc.cu
// over splitk_core.cuh, int8 weights from vocoder_fused.TC_MIN_ROWS rows).
#pragma once

#include "weight_stream.cuh"

namespace vv {
namespace {

constexpr int SP_THREADS = 1024;
constexpr int CTX = 6;  // depthwise kernel 7 -> 6 carried frames

// One block per row. x (B, C) running activations; state/new_state (B, 6, C)
// of this block; conv_w (7, C). With DEP (the split-K route's launches, a
// programmatic dependent of the fc2 before it) it waits for that kernel,
// then lets fc1, whose weight tiles need nothing of it, start at once.
template <typename XT, bool DEP = false>
__global__ void stage_prologue_kernel(const XT* __restrict__ x, const XT* __restrict__ state,
                                      XT* __restrict__ new_state, const float* __restrict__ norm_w,
                                      const float* __restrict__ conv_w,
                                      const float* __restrict__ conv_b,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ ffn_norm_w,
                                      float* __restrict__ xmid, float* __restrict__ hn, int C,
                                      float eps) {
  __shared__ float scratch[32];
  if constexpr (DEP) {
    grid_dep_wait();
    grid_dep_launch();
  }
  const int row = blockIdx.x;
  const XT* xr = x + (size_t)row * C;
  const XT* st = state + (size_t)row * CTX * C;
  XT* nst = new_state + (size_t)row * CTX * C;
  float* xm = xmid + (size_t)row * C;

  float ss = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / C + eps);

  float ss2 = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float xv = to_f(xr[i]);
    const float h = xv * inv * norm_w[i];
    float conv = h * conv_w[CTX * C + i];
#pragma unroll
    for (int t = 0; t < CTX; ++t) {
      conv += to_f(st[t * C + i]) * conv_w[t * C + i];
      nst[t * C + i] = t + 1 < CTX ? st[(t + 1) * C + i] : from_f<XT>(h);
    }
    conv += conv_b[i];
    const float v = xv + conv * gamma[i];
    xm[i] = v;
    ss2 += v * v;
  }
  const float inv2 = rsqrtf(block_sum(ss2, scratch) / C + eps);
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    hn[(size_t)row * C + i] = round_to<XT>(xm[i] * inv2 * ffn_norm_w[i]);
}

struct XRow {  // x (R, K) f32, as the previous launch left it
  static constexpr bool kRowSum = false;
  const float* x;
  int K;
  __device__ __forceinline__ float operator()(int r, int k) const { return x[(size_t)r * K + k]; }
  // the split-K core's loader: eight k from k0
  __device__ __forceinline__ void load8(int r, int k0, float, float (&v)[8]) const {
    vv::load8(x + (size_t)r * K + k0, v);
  }
};

template <typename XT>
struct EpiBiasGelu {
  float* g;
  const float* s1;
  const float* b1;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, float sum) const {
    const float u = sum * col_scale(s1, n) + b1[n];
    g[(size_t)r * N + n] = round_to<XT>(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
  }
};

template <typename XT>
struct EpiBiasScaleResidual {
  XT* y;
  const float* xmid;
  const float* s2;
  const float* b2;
  const float* ffn_gamma;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, float sum) const {
    const size_t i = (size_t)r * N + n;
    const float d = sum * col_scale(s2, n) + b2[n];
    y[i] = from_f<XT>(xmid[i] + d * ffn_gamma[n]);
  }
};

struct StageVectors {  // all (NB, ...) f32
  const float* norm_w;
  const float* conv_w;  // (NB, 7, C)
  const float* conv_b;
  const float* gamma;
  const float* ffn_norm_w;
  const float* b1;  // (NB, H)
  const float* b2;
  const float* ffn_gamma;
  const float* s1;  // (NB, H) or null
  const float* s2;  // (NB, C) or null
};

}  // namespace
}  // namespace vv
