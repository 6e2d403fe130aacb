// Kernel C: the diffusion head's L AdaLN-FFN layers for one denoise call.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/head_fused.py:144
// fused_head_ffn_stack (body `_kernel`, :89). Per layer:
//   hmod = rmsnorm(y) * norm_w * (1 + scale) + shift
//   g = silu(hmod @ Wg * sg) * (hmod @ Wu * su)
//   y = y + gate * ((g @ Wd) * sd)
// with hmod and g held in the activation dtype, as the TPU kernel's scratch.
//
// What bounds it on an H100: 2B rows (2 at bs1) against 3 x 1536 x 4608
// weights per layer, so the weight stream (int8, or bf16 / f32 dense), read
// 10 times per frame. A GPU block cannot carry the residual across a
// sequential grid as the TPU kernel does (head_fused.py:112-118), so the
// layers run in order from the host, each as two launches of the one-launch
// streaming core (weight_stream.cuh), which reads every weight byte once, 16
// bytes a load, and meets its K splits inside the launch:
//   - gate|up: the gate and up weights lie side by side in one (H, 2F)
//     matrix (ops/head_fused.pack_head_ffns), so one pass streams both. Its
//     loader forms hmod while the first weight loads fly, the row's RMS from
//     the block's pre-pass over y; its epilogue stores the raw u|v sums (f32,
//     2 rows: 74 KB) in the workspace;
//   - down: its loader forms g = silu(u * sg) * (v * su) from them as it
//     stages x; its epilogue adds the gated residual into y.
// Two launches a layer, no prologue, no scratch but the persistent
// workspace: a call is 2L launches and can be captured in a CUDA graph.
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

struct Plan {
  int rt, splits, kps;
};

template <typename XT, typename WT>
cudaError_t run(void* y, const void* x, const void* mods, const float* norm_w, const void* wgu,
                const void* wd, const float* sgu, const float* sd, float* uv, float* part,
                unsigned* counters, int L, int R, int H, int F, float eps, Plan gu, Plan dn,
                cudaStream_t stream) {
  XT* yp = static_cast<XT*>(y);
  const XT* mp = static_cast<const XT*>(mods);
  const WT* wgup = static_cast<const WT*>(wgu);
  const WT* wdp = static_cast<const WT*>(wd);
  for (int l = 0; l < L; ++l) {
    const XT* yin = l == 0 ? static_cast<const XT*>(x) : yp;
    const XT* ml = mp + (size_t)l * R * 3 * H;
    const XHeadMod<XT> x1{yin, ml, norm_w + (size_t)l * H, H, eps};
    cudaError_t err = launch_stream_gemv_rt(gu.rt, x1, wgup + (size_t)l * H * 2 * F, part,
                                            counters, R, H, 2 * F, gu.splits, gu.kps,
                                            EpiStore{uv, 2 * F}, stream);
    if (err != cudaSuccess) return err;
    const XSwiGLU<XT> x2{uv, sgu ? sgu + (size_t)l * 2 * F : nullptr, F};
    const EpiGatedResidual<XT> e2{yin, yp, ml, sd ? sd + (size_t)l * H : nullptr, H};
    err = launch_stream_gemv_rt(dn.rt, x2, wdp + (size_t)l * F * H, part, counters, R, F, H,
                                dn.splits, dn.kps, e2, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vv

// x (R, H) in, y (R, H) out, of one dtype; mods (L, R, 3H); norm_w (L, H)
// f32; wgu (L, H, 2F) and wd (L, F, H) int8, bf16 or f32, 16-byte aligned;
// sgu (L, 2F) and sd (L, H) f32 scales, null for dense weights. H and F
// multiples of 16. uv holds R * 2F floats; part and counters are the split-K
// workspace of both passes (plans (rt, splits, kps) from ops/quant._gemv_plan),
// counters zero and left zero.
extern "C" int vv_fused_head_ffn_stack(void* y, const void* x, int x_dtype, const void* mods,
                                       const void* norm_w, const void* wgu, const void* wd,
                                       int w_dtype, const void* sgu, const void* sd, void* uv,
                                       void* part, void* counters, int L, int R, int H, int F,
                                       float eps, int rt_gu, int split_gu, int kps_gu, int rt_d,
                                       int split_d, int kps_d, void* stream) {
  using namespace vv;
  if (!stream_plan_ok(R, H, 2 * F, rt_gu, split_gu, kps_gu) ||
      !stream_plan_ok(R, F, H, rt_d, split_d, kps_d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan gu{rt_gu, split_gu, kps_gu}, dn{rt_d, split_d, kps_d};
#define VV_HEAD(XT_, WT_)                                                                        \
  return (int)run<XT_, WT_>(y, x, mods, static_cast<const float*>(norm_w), wgu, wd,              \
                            static_cast<const float*>(sgu), static_cast<const float*>(sd),       \
                            static_cast<float*>(uv), static_cast<float*>(part),                  \
                            static_cast<unsigned*>(counters), L, R, H, F, eps, gu, dn, s)
  if (x_dtype == VV_F32 && w_dtype == VV_I8) VV_HEAD(float, int8_t);
  if (x_dtype == VV_F32 && w_dtype == VV_BF16) VV_HEAD(float, bf16);
  if (x_dtype == VV_F32 && w_dtype == VV_F32) VV_HEAD(float, float);
  if (x_dtype == VV_BF16 && w_dtype == VV_I8) VV_HEAD(bf16, int8_t);
  if (x_dtype == VV_BF16 && w_dtype == VV_BF16) VV_HEAD(bf16, bf16);
#undef VV_HEAD
  return (int)cudaErrorInvalidValue;
}
