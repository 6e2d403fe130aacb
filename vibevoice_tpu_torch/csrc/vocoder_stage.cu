// Kernel D: one T=1 frame through a whole Block1D (ConvNeXt) stack, on the
// weight-streaming core: 1-2 rows (bs1) and dense weights. With int8
// weights from vocoder_fused.TC_MIN_ROWS rows (the engines' batched rows)
// vocoder_stage_tc.cu runs fc1 and fc2 on the split-K tensor-core core,
// with this prologue and these epilogues (vocoder_stage.cuh);
// ops/vocoder_fused.py routes by rows alone.
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
#include "vocoder_stage.cuh"

namespace vv {
namespace {

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
