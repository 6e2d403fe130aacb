// Kernel G: a depthwise causal 1-D convolution over channels-last (B, T, C)
// activations, the Block1D mixers of the tokenizers' full-sequence encode
// and decode (a voice prompt's acoustic encode runs 26 of them):
//
//   y[b, t, o] = round(sum_j x[b, t - left + j, o / m] * w[o, j]) (+ bias[o])
//
// with m = C_out / C_in output channels per input channel (1 for a mixer),
// rows outside [0, T_in) read as zero (the causal left pad and any right
// pad, formed by index: nothing is padded in memory), the k taps summed in
// f32 in tap order, rounded once to the activations' dtype, then the bias
// added in that dtype (as ops/conv.py's other routes and the JAX package).
//
// Replaces no TPU kernel: the JAX package leaves the tokenizers'
// convolutions to XLA (vibevoice_tpu/ops/conv.py causal_conv1d). It was
// added because cuDNN, which the port's full-sequence convs went to, sets
// itself up anew for every new input length, and a voice prompt brings a
// new length with almost every request. This kernel keeps no state between
// calls: one launch, whatever the length.
//
// What bounds it on an H100: bytes. The stage-0 mixer of a 10 s voice pair
// reads and writes 2 x 240,000 x 32 bf16 (61 MB): 0.0183 ms at 3.35 TB/s;
// its 14 operations an output are nothing beside that. The design:
//   - a thread owns VEC = 4 neighbouring channels (one 8-byte bf16 or
//     16-byte f32 load a row) and TT = 16 consecutive outputs; the threads
//     of a warp take neighbouring channel groups first, so a row's channels
//     are read by neighbouring lanes;
//   - the thread walks its rows once, keeping the last k rows in registers
//     (a ring whose slots are compile-time constants once the loops are
//     unrolled), so each input row is loaded (TT + k - 1) / TT times, the
//     extra loads from L1 beside the neighbouring tile;
//   - its k x VEC weights sit in registers for all TT outputs;
//   - widths that are not a multiple of 4, or pointers not aligned for the
//     vector load, take the same code at VEC = 1.
#include "common.cuh"

namespace vv {
namespace dwconv {

constexpr int THREADS = 256;
constexpr int TT = 16;
constexpr int KERNEL = 7;  // the tokenizers' depthwise convs: the mixers and the stem

template <int VEC, typename T>
__device__ __forceinline__ void load_row(const T* xb, int r, int t_in, int c_in, int o, int mult,
                                         float (&v)[VEC]) {
  if (r < 0 || r >= t_in) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    return;
  }
  const T* p = xb + (long long)r * c_in;
  if constexpr (VEC == 4) {
    if (mult == 1) {
      load4(p + o, v);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f(p[(o + i) / mult]);
}

static __device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

static __device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int K, int VEC>
__global__ void __launch_bounds__(THREADS)
    depthwise_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ bias, T* __restrict__ y, int t_in, int c_in,
                          int c_out, int mult, int t_out, int left, int tiles, long long items) {
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= items) return;
  const int groups = c_out / VEC;
  const int o = (int)(item % groups) * VEC;
  const long long bt = item / groups;
  const int t0 = (int)(bt % tiles) * TT;
  const long long b = bt / tiles;

  float wk[K][VEC], bv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) wk[j][i] = to_f(w[(long long)(o + i) * K + j]);
    bv[i] = bias ? to_f(bias[o + i]) : 0.f;
  }
  const T* xb = x + b * t_in * c_in;
  T* yb = y + b * t_out * c_out + o;

  float win[K][VEC];  // input row t0 - left + n in slot n % K
#pragma unroll
  for (int j = 0; j < K - 1; ++j) load_row<VEC>(xb, t0 - left + j, t_in, c_in, o, mult, win[j]);
#pragma unroll
  for (int n = 0; n < TT; ++n) {
    load_row<VEC>(xb, t0 - left + n + K - 1, t_in, c_in, o, mult, win[(n + K - 1) % K]);
    if (t0 + n >= t_out) break;
    float out[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(win[(n + j) % K][i], wk[j][i], acc);
      out[i] = round_to<T>(acc);
      if (bias) out[i] = round_to<T>(out[i] + bv[i]);
    }
    T* yr = yb + (long long)(t0 + n) * c_out;
    if constexpr (VEC == 4) {
      store4(yr, out);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) yr[i] = from_f<T>(out[i]);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int batch, int t_in,
                   int c_in, int c_out, int t_out, int left, cudaStream_t s) {
  const int mult = c_out / c_in;
  const bool vec = c_out % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   (mult > 1 || reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int tiles = (t_out + TT - 1) / TT;
  const long long items = (long long)batch * tiles * (vec ? c_out / 4 : c_out);
  const unsigned blocks = (unsigned)((items + THREADS - 1) / THREADS);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* yp = static_cast<T*>(y);
  if (vec)
    depthwise_conv_kernel<T, K, 4><<<blocks, THREADS, 0, s>>>(xp, wp, bp, yp, t_in, c_in, c_out,
                                                              mult, t_out, left, tiles, items);
  else
    depthwise_conv_kernel<T, K, 1><<<blocks, THREADS, 0, s>>>(xp, wp, bp, yp, t_in, c_in, c_out,
                                                              mult, t_out, left, tiles, items);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* bias, void* y, int batch, int t_in,
                int c_in, int c_out, int k, int t_out, int left, cudaStream_t s) {
  if (k != KERNEL) return cudaErrorInvalidValue;
  return launch<T, KERNEL>(x, w, bias, y, batch, t_in, c_in, c_out, t_out, left, s);
}

}  // namespace dwconv
}  // namespace vv

// x (batch, t_in, c_in) and y (batch, t_out, c_out) contiguous, w (c_out, k)
// and bias (c_out, or null) in x's dtype; c_out a multiple of c_in; k 7.
extern "C" int vv_depthwise_conv1d(const void* x, int dtype, const void* w, const void* bias,
                                   void* y, int batch, int t_in, int c_in, int c_out, int k,
                                   int left, int t_out, void* stream) {
  if (batch <= 0 || t_in <= 0 || c_in <= 0 || c_out <= 0 || c_out % c_in || t_out <= 0 ||
      left < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VV_BF16)
    return (int)vv::dwconv::run<vv::bf16>(x, w, bias, y, batch, t_in, c_in, c_out, k, t_out,
                                          left, s);
  if (dtype == VV_F32)
    return (int)vv::dwconv::run<float>(x, w, bias, y, batch, t_in, c_in, c_out, k, t_out, left,
                                       s);
  return (int)cudaErrorInvalidValue;
}
