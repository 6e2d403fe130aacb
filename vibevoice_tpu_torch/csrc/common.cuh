// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel here is built by vibevoice_tpu_torch/ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into one shared library with a plain C interface (loaded with ctypes).
// Dtype codes at the C boundary: 0 = float32, 1 = bfloat16, 2 = int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VV_F32 0
#define VV_BF16 1
#define VV_I8 2

namespace vv {

typedef __nv_bfloat16 bf16;

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

static __device__ __forceinline__ void cvt(float v, float& o) { o = v; }
static __device__ __forceinline__ void cvt(float v, bf16& o) { o = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  T o;
  cvt(v, o);
  return o;
}

// Round a float through T (bf16 rounding where T is bf16, identity for f32):
// the TPU kernels hold some intermediates in the model dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

static __device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements as floats (16-, 8- or 4-byte vector load).
static __device__ __forceinline__ void load4(const int8_t* p, float o[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = c.x;
  o[1] = c.y;
  o[2] = c.z;
  o[3] = c.w;
}

static __device__ __forceinline__ void load4(const bf16* p, float o[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

static __device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}

// Sum over a block of blockDim.x threads (a multiple of 32, at most 1024).
static __device__ __forceinline__ float block_sum(float v, float* scratch /* >= 32 floats */) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += scratch[i];
  return t;
}

}  // namespace vv
