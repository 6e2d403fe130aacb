// Kernel A: y = x @ (w8 * scale), the int8 weight-only linear of the Qwen2 LM.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:129 int8_matmul
// (body `_kernel`, :111). Semantics kept: x is rounded to bf16, w8 is
// converted in registers, the sum is f32 and the per-column f32 scale is
// applied after the sum. Bound by the int8 weight stream at decode (2 rows);
// the split-K core in gemv.cuh spreads that stream over every SM. Prefill
// rows go through the same kernel, 8 rows per block.
#include "gemv.cuh"

namespace vv {

template <typename OT>
struct EpiScale {
  OT* out;
  const float* scale;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, const float* acc) const {
    out[(size_t)r * N + n] = from_f<OT>(acc[0] * scale[n]);
  }
};

template <typename T>
static void run(const void* x, const void* w8, const void* scale, void* out, void* ws, int rows,
                int K, int N, int splits, int kps, cudaStream_t stream) {
  EpiScale<T> epi{static_cast<T*>(out), static_cast<const float*>(scale), N};
  launch_gemv<T, int8_t, 1, true>(static_cast<const T*>(x), static_cast<const int8_t*>(w8),
                                  nullptr, static_cast<float*>(ws), rows, K, N, splits, kps, epi,
                                  stream);
}

}  // namespace vv

extern "C" int vv_int8_matmul(const void* x, int x_dtype, const void* w8, const void* scale,
                              void* out, void* workspace, int rows, int K, int N, int splits,
                              int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == VV_BF16)
    vv::run<vv::bf16>(x, w8, scale, out, workspace, rows, K, N, splits, kps, s);
  else if (x_dtype == VV_F32)
    vv::run<float>(x, w8, scale, out, workspace, rows, K, N, splits, kps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* vv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
