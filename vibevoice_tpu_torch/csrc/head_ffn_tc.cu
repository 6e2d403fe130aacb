// Kernel C on the tensor cores: the diffusion head's L AdaLN-FFN layers for
// one denoise call with int8 FFN weights, from head_fused.TC_MIN_ROWS to
// TC_MAX_ROWS rows (the serving engine's 2B rows: 8 at bs4 with CFG).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/head_fused.py:144
// fused_head_ffn_stack (body `_kernel`, :89) at those rows; head_ffn.cu runs
// the same function on the weight-streaming core at fewer rows and for
// dense weights (ops/head_fused.py routes by rows alone). Per layer:
//   hmod = rmsnorm(y) * norm_w * (1 + scale) + shift
//   g = silu(hmod @ Wg * sg) * (hmod @ Wu * su)
//   y = y + gate * ((g @ Wd) * sd)
// with hmod and g held in the activation dtype, as the TPU kernel's scratch.
//
// What bounds it on an H100: the int8 weights, 3 x H x F bytes a layer (the
// 1.5B: 21 MB; the 7B: 116 MB), read once a call, while 2B rows do 2 x 2B
// operations a byte. The streaming core runs every multiply-add on CUDA
// cores and reads the weight again for each 4-row tile, so at 8 rows it is
// bound by its convert + FMA instructions, not the bytes. Here each layer is
// two launches of the split-K tensor-core core (splitk_core.cuh), which
// reads the weight once as wgmma's register operand:
//   - gate|up (the gate and up weights side by side, one (H, 2F) matrix):
//     the block forms its K slice of hmod with XHeadMod (the row's RMS from
//     its pre-pass over y) while the first weight tiles fly; its epilogue
//     stores the raw u|v sums (f32) in the workspace;
//   - down: XSwiGLU forms g = silu(u * sg) * (v * su) from them; the
//     epilogue adds the gated residual into y.
// f32 activations (the solver's) go in as three bf16 terms each, so the
// sums are the f32 sums of the TPU kernel in another order (1e-4 of the
// plain version); bf16 ones in one. Two launches a layer, no scratch but
// the persistent workspace: a call can be captured in a CUDA graph.
#include "head_ffn.cuh"
#include "splitk_core.cuh"

namespace vv {
namespace {

struct TcPlan {
  int bm, splits, kps;
};

template <typename XT>
cudaError_t run_tc(void* y, const void* x, const void* mods, const float* norm_w, const int8_t* wgu,
                   const int8_t* wd, const float* sgu, const float* sd, float* uv, float* part,
                   unsigned* counters, int L, int R, int H, int F, float eps, TcPlan gu,
                   TcPlan dn, cudaStream_t stream) {
  constexpr int TERMS = sizeof(XT) == 4 ? 3 : 1;  // f32 as hi + mid + lo; bf16 as itself
  XT* yp = static_cast<XT*>(y);
  const XT* mp = static_cast<const XT*>(mods);
  for (int l = 0; l < L; ++l) {
    const XT* yin = l == 0 ? static_cast<const XT*>(x) : yp;
    const XT* ml = mp + (size_t)l * R * 3 * H;
    const XHeadMod<XT> x1{yin, ml, norm_w + (size_t)l * H, H, eps};
    cudaError_t err = launch_sk_loaded_bm<TERMS>(gu.bm, x1, R, wgu + (size_t)l * H * 2 * F,
                                                 EpiStore{uv, 2 * F}, part, counters, H, 2 * F,
                                                 gu.splits, gu.kps, stream);
    if (err != cudaSuccess) return err;
    const XSwiGLU<XT> x2{uv, sgu + (size_t)l * 2 * F, F};
    const EpiGatedResidual<XT> e2{yin, yp, ml, sd + (size_t)l * H, H};
    err = launch_sk_loaded_bm<TERMS>(dn.bm, x2, R, wd + (size_t)l * F * H, e2, part, counters, F,
                                     H, dn.splits, dn.kps, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vv

// x (R, H) in, y (R, H) out, of one dtype (f32: three terms, R <= 85;
// bf16: one); mods (L, R, 3H); norm_w (L, H) f32; wgu (L, H, 2F) and wd (L,
// F, H) int8, 16-byte aligned, with sgu (L, 2F) and sd (L, H) f32 scales. H
// and F multiples of 16. uv holds R * 2F floats; part (each pass's splits x
// terms x R x width floats) and counters (its row tiles x column tiles) the
// split-K workspace of both passes (plans (bm, splits, kps) from
// ops/quant._sk_fused_plan), counters zero and left zero.
extern "C" int vv_fused_head_ffn_stack_tc(void* y, const void* x, int x_dtype, const void* mods,
                                          const void* norm_w, const void* wgu, const void* wd,
                                          const void* sgu, const void* sd, void* uv, void* part,
                                          void* counters, int L, int R, int H, int F, float eps,
                                          int bm_gu, int split_gu, int kps_gu, int bm_d,
                                          int split_d, int kps_d, void* stream) {
  using namespace vv;
  if (R <= 0 || H % 16 || F % 16 || !sgu || !sd) return (int)cudaErrorInvalidValue;
  const TcPlan gu{bm_gu, split_gu, kps_gu}, dn{bm_d, split_d, kps_d};
#define VV_HEAD_TC(XT_)                                                                         \
  return (int)run_tc<XT_>(y, x, mods, static_cast<const float*>(norm_w),                        \
                          static_cast<const int8_t*>(wgu), static_cast<const int8_t*>(wd),      \
                          static_cast<const float*>(sgu), static_cast<const float*>(sd),        \
                          static_cast<float*>(uv), static_cast<float*>(part),                   \
                          static_cast<unsigned*>(counters), L, R, H, F, eps, gu, dn,            \
                          static_cast<cudaStream_t>(stream))
  if (x_dtype == VV_F32) VV_HEAD_TC(float);
  if (x_dtype == VV_BF16) VV_HEAD_TC(bf16);
#undef VV_HEAD_TC
  return (int)cudaErrorInvalidValue;
}
