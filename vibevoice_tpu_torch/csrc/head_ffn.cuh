// Kernel C's loaders and epilogues, shared by its two routes: the
// weight-streaming core (head_ffn.cu over weight_stream.cuh, 1-2 rows and
// dense weights) and the split-K tensor-core core (head_ffn_tc.cu over
// splitk_core.cuh, int8 weights from head_fused.TC_MIN_ROWS rows).
#pragma once

#include "weight_stream.cuh"

namespace vv {
namespace {

// hmod = round_XT(rmsnorm(y) * norm_w * (1 + scale) + shift), row sums of y^2
template <typename XT>
struct XHeadMod {
  static constexpr bool kRowSum = true;
  const XT* y;
  const XT* mods;  // (R, 3H) of this layer: shift | scale | gate
  const float* norm_w;
  int row_len;  // H
  float eps;
  __device__ __forceinline__ float row_term(int r, int i) const {
    const float v = to_f(y[(size_t)r * row_len + i]);
    return v * v;
  }
  __device__ __forceinline__ float operator()(int r, int k, float ss) const {
    const int H = row_len;
    const float h = to_f(y[(size_t)r * H + k]) * rsqrtf(ss / H + eps) * norm_w[k];
    const XT* m = mods + (size_t)r * 3 * H;
    return round_to<XT>(h * (1.f + to_f(m[H + k])) + to_f(m[k]));
  }
  // the split-K core's loader: eight k from k0 (16-byte vectors), and the
  // sum of squares of y's eight elements from i0 in order
  __device__ __forceinline__ void load8(int r, int k0, float ss, float (&v)[8]) const {
    const int H = row_len;
    const XT* m = mods + (size_t)r * 3 * H;
    float yv[8], nw[8], sc[8], sh[8];
    vv::load8(y + (size_t)r * H + k0, yv);
    vv::load8(norm_w + k0, nw);
    vv::load8(m + H + k0, sc);
    vv::load8(m + k0, sh);
    const float inv = rsqrtf(ss / H + eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = round_to<XT>(yv[j] * inv * nw[j] * (1.f + sc[j]) + sh[j]);
  }
  __device__ __forceinline__ float sq8(int r, int i0) const {
    float a[8];
    vv::load8(y + (size_t)r * row_len + i0, a);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += a[j] * a[j];
    return s;
  }
};

struct EpiStore {  // raw f32 sums
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, float sum) const {
    out[(size_t)r * N + n] = sum;
  }
};

// g = round_XT(silu(u * sg) * (v * su)) from the raw u|v (R, 2F)
template <typename XT>
struct XSwiGLU {
  static constexpr bool kRowSum = false;
  const float* uv;
  const float* s;  // (2F) gate | up scales, or null
  int F;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const float* row = uv + (size_t)r * 2 * F;
    const float u = row[k] * col_scale(s, k);
    const float v = row[F + k] * col_scale(s, F + k);
    return round_to<XT>(u / (1.f + expf(-u)) * v);
  }
  // the split-K core's loader (int8 weights: s is set): eight k from k0
  __device__ __forceinline__ void load8(int r, int k0, float, float (&v)[8]) const {
    const float* row = uv + (size_t)r * 2 * F;
    float u[8], w[8], su[8], sw[8];
    vv::load8(row + k0, u);
    vv::load8(row + F + k0, w);
    vv::load8(s + k0, su);
    vv::load8(s + F + k0, sw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = u[j] * su[j], b = w[j] * sw[j];
      v[j] = round_to<XT>(a / (1.f + expf(-a)) * b);
    }
  }
};

template <typename XT>
struct EpiGatedResidual {
  const XT* yin;  // the layer's input: x for layer 0, else y itself
  XT* y;
  const XT* mods;
  const float* s;  // (H) down scales, or null
  int N;
  __device__ __forceinline__ void operator()(int r, int n, float sum) const {
    const size_t i = (size_t)r * N + n;
    const float gate = to_f(mods[(size_t)r * 3 * N + 2 * N + n]);
    y[i] = from_f<XT>(to_f(yin[i]) + gate * (sum * col_scale(s, n)));
  }
};

}  // namespace
}  // namespace vv
