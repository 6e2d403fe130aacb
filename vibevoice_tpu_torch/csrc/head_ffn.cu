// Kernel C: the diffusion head's L AdaLN-FFN layers for one denoise call.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/head_fused.py:144
// fused_head_ffn_stack (body `_kernel`, :89). Per layer:
//   h = rmsnorm(y) * norm_w;  hmod = h * (1 + scale) + shift      (prologue)
//   g = silu(hmod @ Wg * sg) * (hmod @ Wu * su)                   (gate/up GEMV)
//   y = y + gate * ((g @ Wd) * sd)                                (down GEMV)
// with hmod and g held in the activation dtype, as the TPU kernel's scratch.
//
// What bounds it on an H100: 2B rows (2 at bs1) against 3 x 1536 x 4608
// weights per layer, so the weight stream (int8 or bf16), read 10 times per
// frame. A GPU block cannot carry the residual across a sequential grid as
// the TPU kernel does (head_fused.py:112-118), so the layers run in order
// from the host: one prologue launch, then the gate and up matrices read
// side by side in one split-K GEMV whose epilogue applies SiLU * mul, then
// the down GEMV whose epilogue adds the gated residual. The 4608-wide g goes
// through device memory (f32, 2 rows: 37 KB).
#include "gemv.cuh"

namespace vv {

constexpr int HP_THREADS = 256;

// One block per row: hmod = round_XT(rmsnorm(y) * norm_w * (1 + scale) + shift).
template <typename XT>
__global__ void head_prologue_kernel(const XT* __restrict__ y, const XT* __restrict__ mods,
                                     const float* __restrict__ norm_w, float* __restrict__ hmod,
                                     int H, float eps) {
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const XT* yr = y + (size_t)row * H;
  const XT* mr = mods + (size_t)row * 3 * H;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = to_f(yr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / H + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float h = to_f(yr[i]) * inv * norm_w[i];
    const float shift = to_f(mr[i]), scale = to_f(mr[H + i]);
    hmod[(size_t)row * H + i] = round_to<XT>(h * (1.f + scale) + shift);
  }
}

template <typename XT>
struct EpiSwiGLU {
  float* g;
  const float* s_gate;
  const float* s_up;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, const float* acc) const {
    const float u = acc[0] * col_scale(s_gate, n);
    const float v = acc[1] * col_scale(s_up, n);
    g[(size_t)r * N + n] = round_to<XT>(u / (1.f + expf(-u)) * v);
  }
};

template <typename XT>
struct EpiGatedResidual {
  XT* y;
  const XT* mods;  // (R, 3H) of this layer; gate at [2H, 3H)
  const float* s_down;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, const float* acc) const {
    const size_t i = (size_t)r * N + n;
    const float gate = to_f(mods[(size_t)r * 3 * N + 2 * N + n]);
    y[i] = from_f<XT>(to_f(y[i]) + gate * (acc[0] * col_scale(s_down, n)));
  }
};

template <typename XT, typename WT>
static void run(void* y, const void* mods, const float* norm_w, const void* wg, const void* wu,
                const void* wd, const float* sg, const float* su, const float* sd, float* hmod,
                float* gbuf, float* ws, int L, int R, int H, int F, float eps, int split_gu,
                int kps_gu, int split_d, int kps_d, cudaStream_t stream) {
  XT* yp = static_cast<XT*>(y);
  const XT* mp = static_cast<const XT*>(mods);
  const WT* wgp = static_cast<const WT*>(wg);
  const WT* wup = static_cast<const WT*>(wu);
  const WT* wdp = static_cast<const WT*>(wd);
  for (int l = 0; l < L; ++l) {
    const XT* ml = mp + (size_t)l * R * 3 * H;
    head_prologue_kernel<XT><<<R, HP_THREADS, 0, stream>>>(yp, ml, norm_w + (size_t)l * H, hmod,
                                                            H, eps);
    EpiSwiGLU<XT> e1{gbuf, sg ? sg + (size_t)l * F : nullptr, su ? su + (size_t)l * F : nullptr, F};
    launch_gemv<float, WT, 2, false>(hmod, wgp + (size_t)l * H * F, wup + (size_t)l * H * F, ws,
                                     R, H, F, split_gu, kps_gu, e1, stream);
    EpiGatedResidual<XT> e2{yp, ml, sd ? sd + (size_t)l * H : nullptr, H};
    launch_gemv<float, WT, 1, false>(gbuf, wdp + (size_t)l * F * H, nullptr, ws, R, F, H, split_d,
                                     kps_d, e2, stream);
  }
}

}  // namespace vv

// y (R, H) holds x on entry and the result on exit. Scales are null for
// dense weights. hmod (R, H), gbuf (R, F) and ws (max(2*split_gu*R*F,
// split_d*R*H)) are f32 scratch.
extern "C" int vv_fused_head_ffn_stack(void* y, int x_dtype, const void* mods, const void* norm_w,
                                       const void* wg, const void* wu, const void* wd, int w_dtype,
                                       const void* sg, const void* su, const void* sd, void* hmod,
                                       void* gbuf, void* ws, int L, int R, int H, int F, float eps,
                                       int split_gu, int kps_gu, int split_d, int kps_d,
                                       void* stream) {
  using namespace vv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VV_HEAD(XT_, WT_)                                                                     \
  run<XT_, WT_>(y, mods, static_cast<const float*>(norm_w), wg, wu, wd,                       \
                static_cast<const float*>(sg), static_cast<const float*>(su),                 \
                static_cast<const float*>(sd), static_cast<float*>(hmod),                     \
                static_cast<float*>(gbuf), static_cast<float*>(ws), L, R, H, F, eps, split_gu, \
                kps_gu, split_d, kps_d, s)
  if (x_dtype == VV_F32 && w_dtype == VV_I8)
    VV_HEAD(float, int8_t);
  else if (x_dtype == VV_F32 && w_dtype == VV_BF16)
    VV_HEAD(float, bf16);
  else if (x_dtype == VV_F32 && w_dtype == VV_F32)
    VV_HEAD(float, float);
  else if (x_dtype == VV_BF16 && w_dtype == VV_I8)
    VV_HEAD(bf16, int8_t);
  else if (x_dtype == VV_BF16 && w_dtype == VV_BF16)
    VV_HEAD(bf16, bf16);
  else
    return (int)cudaErrorInvalidValue;
#undef VV_HEAD
  return (int)cudaGetLastError();
}
