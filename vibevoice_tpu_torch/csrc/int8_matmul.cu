// Kernel A at a few rows (decode): y = x @ (w8 * scale), the int8
// weight-only linear of the Qwen2 LM.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:129 int8_matmul
// (body `_kernel`, :111) up to quant.GEMV_MAX_ROWS rows; int8_gemm_splitk.cu
// and int8_gemm.cu take the rest. Semantics kept: x is rounded to bf16, w8 is converted in
// registers, the sum is f32 and the per-column f32 scale is applied after
// the sum; the output has x's dtype. Bound by the int8 weight stream; the
// one-launch streaming core of weight_stream.cuh reads it once, 16 bytes a
// load, with the row count (1, 2 or 4 rows a block) a template parameter.
#include "weight_stream.cuh"

namespace vv {
namespace {

template <typename T>
struct XRoundBf16 {  // x.astype(bf16), as f32
  static constexpr bool kRowSum = false;
  const T* x;
  int K;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return round_bf16(to_f(x[(size_t)r * K + k]));
  }
};

template <typename T>
struct EpiScale {
  T* out;
  const float* scale;
  int N;
  __device__ __forceinline__ void operator()(int r, int n, float sum) const {
    out[(size_t)r * N + n] = from_f<T>(sum * scale[n]);
  }
};

template <typename T>
cudaError_t run(const void* x, const void* w8, const void* scale, void* out, void* part,
                void* counters, int rows, int K, int N, int rt, const ColSegs& segs,
                cudaStream_t stream) {
  const XRoundBf16<T> xl{static_cast<const T*>(x), K};
  const EpiScale<T> epi{static_cast<T*>(out), static_cast<const float*>(scale), N};
  return launch_stream_gemv_segs(rt, xl, static_cast<const int8_t*>(w8),
                                 static_cast<float*>(part), static_cast<unsigned*>(counters), rows,
                                 K, N, segs, epi, stream);
}

}  // namespace
}  // namespace vv

// x (rows, K) bf16 or f32; w8 (K, N) int8, 16-byte aligned, N a multiple of
// 16; scale (N,) f32; out (rows, N) of x's dtype. rt in {1, 2, 4} rows a
// block. Up to three column segments (t, splits, kps): the first column
// tile (of 128) of each, its K splits and k per split (a multiple of 16, at
// most 512, splits = ceil(K / kps)); splits 0 ends the list. Where a
// segment splits, part holds its splits * rows * width floats (the segments
// one after another) and counters ceil(rows / rt) * ceil(N / 128) zeros,
// left zero again.
extern "C" int vv_int8_matmul(const void* x, int x_dtype, const void* w8, const void* scale,
                              void* out, void* part, void* counters, int rows, int K, int N,
                              int rt, int t0, int s0, int k0, int t1, int s1, int k1, int t2,
                              int s2, int k2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int trip[9] = {t0, s0, k0, t1, s1, k1, t2, s2, k2};
  vv::ColSegs segs;
  if (!vv::stream_segs_ok(&segs, trip, rows, K, N, rt)) return (int)cudaErrorInvalidValue;
  if (segs.max_splits > 1 && (!part || !counters)) return (int)cudaErrorInvalidValue;
  if (x_dtype == VV_BF16)
    return (int)vv::run<vv::bf16>(x, w8, scale, out, part, counters, rows, K, N, rt, segs, s);
  if (x_dtype == VV_F32)
    return (int)vv::run<float>(x, w8, scale, out, part, counters, rows, K, N, rt, segs, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
