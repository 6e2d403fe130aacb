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

// Eight consecutive elements as floats, p 16-byte aligned (two 16-byte
// loads of f32, one of bf16).
static __device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
  o[4] = b.x;
  o[5] = b.y;
  o[6] = b.z;
  o[7] = b.w;
}

static __device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The column segments of one launch of kernel A: the unpacked projections
// that a packed weight joins (q|k|v, gate|up; ops/quant.py
// _segment_plans), so that each segment's columns sum K as the segment's own
// call would. Segment i starts at column tile tile0[i] (tile0[n] is the
// launch's column tiles), sums K in splits[i] slices of kps[i] and keeps its
// split-K partials at part + part0[i] as (split, row, column - its first
// column). A plain call is one segment.
constexpr int VV_MAX_SEGS = 3;
struct ColSegs {
  int n;
  int tile0[VV_MAX_SEGS + 1];
  int splits[VV_MAX_SEGS];
  int kps[VV_MAX_SEGS];
  long long part0[VV_MAX_SEGS];
  int max_splits, max_kps;

  // Fields are picked by selects, not by a run-time index: indexing a
  // kernel parameter's array at run time makes the compiler copy the whole
  // struct to local memory first.
  template <typename T>
  static __host__ __device__ __forceinline__ T pick(const T (&a)[VV_MAX_SEGS], int s) {
    return s == 0 ? a[0] : s == 1 ? a[1] : a[2];
  }
  __host__ __device__ __forceinline__ int find(int tile) const {
    return (n > 1 && tile >= tile0[1]) + (n > 2 && tile >= tile0[2]);
  }
  // first column and width of segment s, with `cols` columns a tile
  __host__ __device__ __forceinline__ int col0(int s, int cols) const {
    return (s == 0 ? 0 : s == 1 ? tile0[1] : tile0[2]) * cols;
  }
  __host__ __device__ __forceinline__ int width(int s, int cols, int N) const {
    const int end = s + 1 < n ? (s == 0 ? tile0[1] : tile0[2]) * cols : N;
    return end - col0(s, cols);
  }
};

// ColSegs from up to VV_MAX_SEGS (first column tile, splits, k per split)
// triples (a triple of splits 0 ends the list) over a (K, N) weight with
// `cols` columns a tile and R rows: the first segment starts at tile 0, the
// others at increasing tiles inside N; each kps a multiple of kstep in
// [kstep, max_kps] with splits = ceil(K / kps). Partials are laid out for
// the segments that split. False where the triples break a rule.
static inline bool col_segs(ColSegs* sg, const int* trip, int R, int K, int N, int cols,
                            int kstep, int max_kps) {
  const int tiles = (N + cols - 1) / cols;
  sg->n = 0;
  sg->max_splits = sg->max_kps = 0;
  long long part = 0;
  for (int i = 0; i < VV_MAX_SEGS && trip[3 * i + 1] > 0; ++i) {
    const int t0 = trip[3 * i], splits = trip[3 * i + 1], kps = trip[3 * i + 2];
    if ((i == 0 ? t0 != 0 : t0 <= sg->tile0[i - 1]) || t0 >= tiles || kps < kstep ||
        kps % kstep || kps > max_kps || splits != (K + kps - 1) / kps)
      return false;
    sg->tile0[i] = t0;
    sg->splits[i] = splits;
    sg->kps[i] = kps;
    sg->n = i + 1;
    sg->max_splits = splits > sg->max_splits ? splits : sg->max_splits;
    sg->max_kps = kps > sg->max_kps ? kps : sg->max_kps;
  }
  if (sg->n == 0) return false;
  sg->tile0[sg->n] = tiles;
  for (int i = 0; i < sg->n; ++i) {
    sg->part0[i] = part;
    if (sg->splits[i] > 1) part += (long long)sg->splits[i] * R * sg->width(i, cols, N);
  }
  return true;
}

// One segment over the whole call.
static inline ColSegs one_seg(int N, int cols, int splits, int kps) {
  ColSegs sg{};
  sg.n = 1;
  sg.tile0[1] = (N + cols - 1) / cols;
  sg.splits[0] = sg.max_splits = splits;
  sg.kps[0] = sg.max_kps = kps;
  return sg;
}

// Launch `kernel` on `stream` as a programmatic dependent of the kernel
// before it (mma.cuh grid_dep_wait): its blocks may start, and do what
// needs nothing of that kernel, while that kernel finishes.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
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
