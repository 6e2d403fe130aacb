// Kernel A at middle rows: y = x @ (w8 * scale) as a split-K tensor-core
// GEMM, the int8 weight-only linear at the rows between bs1 decode and the
// ring prefill of a long prompt: the serving engine's batched decode (8
// rows at bs4), the int8 diffusion head's AdaLN (20 and 80 rows), the int8
// tokenizers over a voice prompt (45-300 rows), a prompt's prefill (a few
// hundred rows), chunked prefills and training (thousands).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:129 int8_matmul
// (body `_kernel`, :111) from above quant.GEMV_MAX_ROWS to below
// quant.GEMM_MIN_ROWS rows (ops/quant.py `_plan` routes by row count alone).
// Semantics kept: x is rounded to bf16, w8 is converted to bf16 (exact), the
// sum is f32 and the per-column f32 scale is applied after the sum; the
// output has x's dtype.
//
// What bounds it, and the design: the split-K tensor-core core
// (splitk_core.cuh), of which this is the instance whose x is a bf16 matrix
// read by TMA (XTma) and whose epilogue applies the per-column scale and
// stores (EpiScaleOut, straight from the accumulators where K is not split).
// A launch may cover column segments (ColSegs, common.cuh: the packed q|k|v
// and gate|up), each split as its own call would be; blocks past a
// segment's splits exit. So a column's sum order depends on the rows, K and
// its segment's width, never on the call's total width.
// f32 x is rounded to bf16 by a cast pass (cast_bf16_kernel) into a scratch
// buffer first. TMA zero-fills the ragged edges of rows, K and N; its row
// strides must be multiples of 16 bytes, so K must be a multiple of 8 and N
// of 16.
#include <limits.h>

#include "splitk_core.cuh"

namespace vv {
namespace {

struct XTma {  // x (M, K) bf16 by a tensor map, a (BM, 64) tile a stage
  static constexpr bool kTma = true;
  CUtensorMap map;
};

struct EpiScaleOut {  // two adjacent outputs, already scaled, in the output dtype
  const float* scale;
  void* out;
  int out_f32;
  __device__ __forceinline__ void store(int r, int c, float a, float b, int N) const {
    const size_t i = (size_t)r * N + c;
    if (out_f32)
      store2(static_cast<float*>(out) + i, a, b);
    else
      store2(static_cast<bf16*>(out) + i, a, b);
  }
};

template <int BM>
cudaError_t launch_sk(const bf16* x, const int8_t* w8, const float* scale, void* out, int out_f32,
                      float* part, unsigned* counters, int M, int K, int N, const ColSegs& segs,
                      cudaStream_t stream) {
  using T = SkTile<BM>;
  XTma xs;
  CUtensorMap wmap;
  if (!make_map(&xs.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (size_t)K * 2, SK_BK, BM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, (size_t)N, SK_BN, SK_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_sk_kernel<BM, XTma, EpiScaleOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, segs.tile0[segs.n], segs.max_splits);
  int8_gemm_sk_kernel<BM, XTma, EpiScaleOut><<<grid, SK_THREADS, T::SMEM, stream>>>(
      xs, wmap, EpiScaleOut{scale, out, out_f32}, part, counters, M, K, N, segs);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vv

// x (M, K) bf16 or f32; w8 (K, N) int8; scale (N,) f32; out (M, N) in x's
// dtype; x, x_bf16 and w8 16-byte aligned, K a multiple of 8 and N of 16.
// For f32 x, x_bf16 is a scratch of M * K bf16 (unused for bf16 x). bm is
// the row tile (8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224 or
// 256). Up to three column segments (t, splits, kps): the first column tile
// (of 128) of each, its K splits and k per split (a multiple of 64, splits =
// ceil(K / kps)); splits 0 ends the list. Where a segment splits, part holds
// its splits * M * width floats (the segments one after another) and
// counters ceil(M / bm) * ceil(N / 128) zeros, left zero again.
extern "C" int vv_int8_gemm_splitk(const void* x, int x_dtype, void* x_bf16, const void* w8,
                                   const void* scale, void* out, void* part, void* counters,
                                   int M, int K, int N, int bm, int t0, int s0, int k0, int t1,
                                   int s1, int k1, int t2, int s2, int k2, void* stream) {
  using namespace vv;
  const int trip[9] = {t0, s0, k0, t1, s1, k1, t2, s2, k2};
  ColSegs segs;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 16 ||
      !col_segs(&segs, trip, M, K, N, SK_BN, SK_BK, INT_MAX))
    return (int)cudaErrorInvalidValue;
  if (segs.max_splits > 1 && (!part || !counters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  if (x_dtype == VV_F32) {
    const size_t n4 = (size_t)M * K / 4;
    const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
    cast_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(x),
                                            static_cast<uint2*>(x_bf16), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xb = static_cast<const bf16*>(x_bf16);
  } else if (x_dtype != VV_BF16) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  unsigned* ct = static_cast<unsigned*>(counters);
  const int f32 = x_dtype == VV_F32;
#define VV_SK(BM_) \
  case BM_: return (int)launch_sk<BM_>(xb, w, sc, out, f32, pt, ct, M, K, N, segs, s)
  switch (bm) {
    VV_SK(8);
    VV_SK(16);
    VV_SK(24);
    VV_SK(32);
    VV_SK(48);
    VV_SK(64);
    VV_SK(80);
    VV_SK(96);
    VV_SK(112);
    VV_SK(128);
    VV_SK(160);
    VV_SK(192);
    VV_SK(224);
    VV_SK(256);
  }
#undef VV_SK
  return (int)cudaErrorInvalidValue;
}
