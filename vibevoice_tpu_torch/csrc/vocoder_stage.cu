// Kernel D: one T=1 frame through a whole Block1D (ConvNeXt) stack.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/vocoder_fused.py:202
// fused_stage_step (body `_kernel`, :134). Per block:
//   h = rmsnorm(x) * norm_w
//   c = depthwise_conv_k7([state ; h]) + conv_b;  state' = shift-in h
//   xmid = x + c * gamma;  hn = rmsnorm(xmid) * ffn_norm_w     (prologue)
//   g = gelu_erf(hn @ W1 * s1 + b1)                             (fc1 pass)
//   x = xmid + (g @ W2 * s2 + b2) * ffn_gamma                   (fc2 pass)
// with hn and g held in the activation dtype and xmid in f32, as the TPU
// kernel's scratch. The exact-erf GELU uses CUDA's erff (the TPU kernel
// needed a polynomial, vocoder_fused.py:114).
//
// What bounds it on an H100: B rows (1-2) against 2 x 2048 x 8192 FFN
// weights per block, 8 blocks, twice per frame (acoustic decoder stage 0,
// semantic encoder last stage): the weight stream (int8, or bf16 / f32
// dense). The TPU kernel walks the blocks on a sequential grid; here the
// blocks run in order from the host, each as one small prologue launch (two
// row reductions in sequence, which every column of fc1 needs) and two
// launches of the one-launch streaming core (weight_stream.cuh), which reads
// every weight byte once, 16 bytes a load, and meets its K splits inside the
// launch; their epilogues fuse the bias, GELU, layer scale and residual.
// xmid, hn and the 8192-wide g go through the persistent workspace (f32), so
// a call is 3 launches a block, allocates nothing and can be captured in a
// CUDA graph.
#include "weight_stream.cuh"

namespace vv {
namespace {

constexpr int SP_THREADS = 1024;
constexpr int CTX = 6;  // depthwise kernel 7 -> 6 carried frames

// One block per row. x (B, C) running activations; state/new_state (B, 6, C)
// of this block; conv_w (7, C).
template <typename XT>
__global__ void stage_prologue_kernel(const XT* __restrict__ x, const XT* __restrict__ state,
                                      XT* __restrict__ new_state, const float* __restrict__ norm_w,
                                      const float* __restrict__ conv_w,
                                      const float* __restrict__ conv_b,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ ffn_norm_w,
                                      float* __restrict__ xmid, float* __restrict__ hn, int C,
                                      float eps) {
  __shared__ float scratch[32];
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

struct Plan {
  int rt, splits, kps;
};

template <typename XT, typename WT>
cudaError_t run(void* y, const void* x, const void* states, void* new_states,
                const StageVectors& v, const void* w1, const void* w2, float* xmid, float* hn,
                float* gbuf, float* part, unsigned* counters, int NB, int B, int C, int H,
                float eps, Plan p1, Plan p2, cudaStream_t stream) {
  XT* yp = static_cast<XT*>(y);
  const XT* sp = static_cast<const XT*>(states);
  XT* nsp = static_cast<XT*>(new_states);
  const WT* w1p = static_cast<const WT*>(w1);
  const WT* w2p = static_cast<const WT*>(w2);
  for (int blk = 0; blk < NB; ++blk) {
    const size_t so = (size_t)blk * B * CTX * C;
    stage_prologue_kernel<XT><<<B, SP_THREADS, 0, stream>>>(
        blk == 0 ? static_cast<const XT*>(x) : yp, sp + so, nsp + so, v.norm_w + (size_t)blk * C,
        v.conv_w + (size_t)blk * 7 * C, v.conv_b + (size_t)blk * C, v.gamma + (size_t)blk * C,
        v.ffn_norm_w + (size_t)blk * C, xmid, hn, C, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const EpiBiasGelu<XT> e1{gbuf, v.s1 ? v.s1 + (size_t)blk * H : nullptr,
                             v.b1 + (size_t)blk * H, H};
    err = launch_stream_gemv_rt(p1.rt, XRow{hn, C}, w1p + (size_t)blk * C * H, part, counters, B,
                                C, H, p1.splits, p1.kps, e1, stream);
    if (err != cudaSuccess) return err;
    const EpiBiasScaleResidual<XT> e2{yp, xmid, v.s2 ? v.s2 + (size_t)blk * C : nullptr,
                                      v.b2 + (size_t)blk * C, v.ffn_gamma + (size_t)blk * C, C};
    err = launch_stream_gemv_rt(p2.rt, XRow{gbuf, H}, w2p + (size_t)blk * H * C, part, counters,
                                B, H, C, p2.splits, p2.kps, e2, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vv

// x (B, C) in, y (B, C) out (the stack's output), of one dtype; states and
// new_states (NB, B, 6, C). vecs points at 10 f32 pointers in StageVectors
// order (s1/s2 null for dense weights). w1 (NB, C, H) and w2 (NB, H, C)
// 16-byte aligned, C and H multiples of 16. xmid, hn (B, C) and g (B, H) are
// f32 scratch; part and counters the split-K workspace of both passes
// (plans (rt, splits, kps) from ops/quant._gemv_plan), counters zero and
// left zero.
extern "C" int vv_fused_stage_step(void* y, const void* x, int x_dtype, const void* states,
                                   void* new_states, const void* const* vecs, const void* w1,
                                   const void* w2, int w_dtype, void* xmid, void* hn, void* g,
                                   void* part, void* counters, int NB, int B, int C, int H,
                                   float eps, int rt1, int split1, int kps1, int rt2, int split2,
                                   int kps2, void* stream) {
  using namespace vv;
  if (!stream_plan_ok(B, C, H, rt1, split1, kps1) || !stream_plan_ok(B, H, C, rt2, split2, kps2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(vecs);
  const StageVectors v{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
  const Plan p1{rt1, split1, kps1}, p2{rt2, split2, kps2};
#define VV_STAGE(XT_, WT_)                                                                      \
  return (int)run<XT_, WT_>(y, x, states, new_states, v, w1, w2, static_cast<float*>(xmid),     \
                            static_cast<float*>(hn), static_cast<float*>(g),                    \
                            static_cast<float*>(part), static_cast<unsigned*>(counters), NB, B, \
                            C, H, eps, p1, p2, s)
  if (x_dtype == VV_BF16 && w_dtype == VV_I8) VV_STAGE(bf16, int8_t);
  if (x_dtype == VV_BF16 && w_dtype == VV_BF16) VV_STAGE(bf16, bf16);
  if (x_dtype == VV_F32 && w_dtype == VV_I8) VV_STAGE(float, int8_t);
  if (x_dtype == VV_F32 && w_dtype == VV_F32) VV_STAGE(float, float);
#undef VV_STAGE
  return (int)cudaErrorInvalidValue;
}
