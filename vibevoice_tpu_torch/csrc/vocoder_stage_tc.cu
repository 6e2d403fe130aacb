// Kernel D on the tensor cores: one T=1 frame through a whole Block1D
// (ConvNeXt) stack with int8 FFN weights, from vocoder_fused.TC_MIN_ROWS to
// TC_MAX_ROWS rows (the serving engine's B rows, 4 at bs4; eight 0.5B
// sessions).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/vocoder_fused.py:202
// fused_stage_step (body `_kernel`, :134) at those rows; vocoder_stage.cu
// runs the same function on the weight-streaming core at fewer rows and for
// dense weights (ops/vocoder_fused.py routes by rows alone). Per block:
//   h = rmsnorm(x) * norm_w
//   c = depthwise_conv_k7([state ; h]) + conv_b;  state' = shift-in h
//   xmid = x + c * gamma;  hn = rmsnorm(xmid) * ffn_norm_w     (prologue)
//   g = gelu_erf(hn @ W1 * s1 + b1)                             (fc1 pass)
//   x = xmid + (g @ W2 * s2 + b2) * ffn_gamma                   (fc2 pass)
// with hn and g held in the activation dtype and xmid in f32, as the TPU
// kernel's scratch.
//
// What bounds it on an H100: the int8 FFN weights, 2 x 2048 x 8192 bytes a
// block, 8 blocks, read once a call, while B rows do 2B operations a byte.
// The streaming core runs every multiply-add on CUDA cores, four FMAs and a
// convert a weight byte at 4 rows, and is bound by those instructions.
// Here fc1 and fc2 are launches of the split-K tensor-core core
// (splitk_core.cuh), which reads the weight once as wgmma's register
// operand; the block forms its K slice of hn (fc1) or g (fc2) from the
// workspace (XRow), and the epilogues keep the bias, exact GELU, layer scale
// and residual. The prologue (vocoder_stage.cuh, two row reductions in
// sequence) stays a launch of its own: every fc1 block needs both. bf16
// activations (every default path) go in as one bf16 term, exact; f32 as
// three (hi + mid + lo). 3 launches a block, no scratch but the persistent
// workspace: a call can be captured in a CUDA graph.
#include "splitk_core.cuh"
#include "vocoder_stage.cuh"

namespace vv {
namespace {

struct TcPlan {
  int bm, splits, kps;
};

template <typename XT>
cudaError_t run_tc(void* y, const void* x, const void* states, void* new_states,
                   const StageVectors& v, const int8_t* w1, const int8_t* w2, float* xmid,
                   float* hn, float* gbuf, float* part, unsigned* counters, int NB, int B, int C,
                   int H, float eps, TcPlan p1, TcPlan p2, cudaStream_t stream) {
  constexpr int TERMS = sizeof(XT) == 4 ? 3 : 1;  // f32 as hi + mid + lo; bf16 as itself
  XT* yp = static_cast<XT*>(y);
  const XT* sp = static_cast<const XT*>(states);
  XT* nsp = static_cast<XT*>(new_states);
  for (int blk = 0; blk < NB; ++blk) {
    const size_t so = (size_t)blk * B * CTX * C;
    cudaError_t err = launch_dependent(
        stage_prologue_kernel<XT, true>, dim3(B), dim3(SP_THREADS), 0, stream,
        blk == 0 ? static_cast<const XT*>(x) : yp, sp + so, nsp + so, v.norm_w + (size_t)blk * C,
        v.conv_w + (size_t)blk * 7 * C, v.conv_b + (size_t)blk * C, v.gamma + (size_t)blk * C,
        v.ffn_norm_w + (size_t)blk * C, xmid, hn, C, eps);
    if (err != cudaSuccess) return err;
    const EpiBiasGelu<XT> e1{gbuf, v.s1 + (size_t)blk * H, v.b1 + (size_t)blk * H, H};
    err = launch_sk_loaded_bm<TERMS>(p1.bm, XRow{hn, C}, B, w1 + (size_t)blk * C * H, e1, part,
                                     counters, C, H, p1.splits, p1.kps, stream);
    if (err != cudaSuccess) return err;
    const EpiBiasScaleResidual<XT> e2{yp, xmid, v.s2 + (size_t)blk * C, v.b2 + (size_t)blk * C,
                                      v.ffn_gamma + (size_t)blk * C, C};
    err = launch_sk_loaded_bm<TERMS>(p2.bm, XRow{gbuf, H}, B, w2 + (size_t)blk * H * C, e2, part,
                                     counters, H, C, p2.splits, p2.kps, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vv

// x (B, C) in, y (B, C) out (the stack's output), of one dtype (f32: three
// terms, B <= 85; bf16: one); states and new_states (NB, B, 6, C). vecs
// points at 10 f32 pointers in StageVectors order, the two scales last. w1
// (NB, C, H) and w2 (NB, H, C) int8, 16-byte aligned, C and H multiples of
// 16. xmid, hn (B, C) and g (B, H) are f32 scratch; part (each pass's splits
// x terms x B x width floats) and counters (its row tiles x column tiles)
// the split-K workspace of both passes (plans (bm, splits, kps) from
// ops/quant._sk_fused_plan), counters zero and left zero.
extern "C" int vv_fused_stage_step_tc(void* y, const void* x, int x_dtype, const void* states,
                                      void* new_states, const void* const* vecs, const void* w1,
                                      const void* w2, void* xmid, void* hn, void* g, void* part,
                                      void* counters, int NB, int B, int C, int H, float eps,
                                      int bm1, int split1, int kps1, int bm2, int split2, int kps2,
                                      void* stream) {
  using namespace vv;
  const float* const* f = reinterpret_cast<const float* const*>(vecs);
  const StageVectors v{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
  if (B <= 0 || C % 16 || H % 16 || !v.s1 || !v.s2) return (int)cudaErrorInvalidValue;
  const TcPlan p1{bm1, split1, kps1}, p2{bm2, split2, kps2};
#define VV_STAGE_TC(XT_)                                                                        \
  return (int)run_tc<XT_>(y, x, states, new_states, v, static_cast<const int8_t*>(w1),          \
                          static_cast<const int8_t*>(w2), static_cast<float*>(xmid),            \
                          static_cast<float*>(hn), static_cast<float*>(g),                      \
                          static_cast<float*>(part), static_cast<unsigned*>(counters), NB, B,   \
                          C, H, eps, p1, p2, static_cast<cudaStream_t>(stream))
  if (x_dtype == VV_BF16) VV_STAGE_TC(bf16);
  if (x_dtype == VV_F32) VV_STAGE_TC(float);
#undef VV_STAGE_TC
  return (int)cudaErrorInvalidValue;
}
