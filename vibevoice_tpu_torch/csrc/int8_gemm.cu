// Kernel A at many rows: y = x @ (w8 * scale) as a tensor-core GEMM, the
// int8 weight-only linear of the Qwen2 LM in prefill and fine-tuning.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:129 int8_matmul
// (body `_kernel`, :111) wherever a call has many rows (ops/quant.py `_plan`
// routes by row count; fewer rows keep the split-K GEMV of int8_matmul.cu).
// Semantics kept: x is rounded to bf16, w8 is converted to bf16 (exact), the
// sum is f32 and the per-column f32 scale is applied after the sum; the
// output has x's dtype.
//
// What bounds it on an H100: at the main-path shapes it is a GEMM bound by
// tensor-core work, not bytes. Gate/up of the ring prefill (32,768 rows x
// 1536 -> 8960) is 9.0e11 FLOP, 0.91 ms at the 989 TFLOP/s bf16 peak, while
// its bytes (x once, the int8 weight once, y once: 0.70 GB) take 0.21 ms.
// The int8 -> bf16 conversion has to stay off the tensor cores' path, so the
// kernel computes the transposed product y^T = w^T x^T:
//   - the int8 weight is wgmma's A operand, taken from registers: each
//     consumer warp reads its 16 output columns of the int8 tile with
//     ldmatrix.trans (two int8 columns per 16-bit lane), converts them to
//     bf16 in registers (exact) and issues wgmma m64n256k16; the pairing
//     puts columns 2j and 2j + 1 on rows j and j + 8 of the fragment, a row
//     permutation the epilogue undoes. No dequantized weight ever exists in
//     shared or device memory;
//   - x is the B operand, 256 rows x 64 k per tile, K-major with the
//     128-byte swizzle, read by wgmma from shared memory;
//   - a producer warpgroup (one thread) streams both tiles with TMA through
//     a 5-stage ring of mbarriers; two consumer warpgroups each own 64
//     output columns x 256 rows (f32 accumulators in registers),
//     double-buffer the converted A fragments so that a step's conversion
//     overlaps the previous step's wgmma, and release a stage once its
//     wgmma has completed;
//   - every row's sum runs over K in one fixed order (no split-K), so a
//     row's result does not depend on how many rows the call has;
//   - the epilogue multiplies by the column scale and stores x's dtype, two
//     adjacent columns per store.
// Measured on an H100 at gate/up, 32,768 rows: 1.43-1.58 ms, 58-64% of the
// bound (cuBLAS bf16 on a dequantized copy: 1.21-1.25 ms). ptxas compiles
// the kernel at 168 registers a thread (65,536 / 384; the setmaxnreg
// hand-over does not raise it) and reports the wgmma chain serialized for
// want of registers (C7512); a 192-row tile that compiles without that
// warning ran within 3% of this one, so the remaining gap lies elsewhere.
// f32 x (training) is rounded to bf16 by a cast pass (cast_bf16_kernel)
// into a scratch buffer before the GEMM. TMA zero-fills the ragged edges of
// M, N and K; its row strides must be multiples of 16 bytes, so K must be a
// multiple of 8 and N of 16.
#include "mma.cuh"
#include "tma.cuh"

namespace vv {
namespace {

constexpr int G_BN = 128;  // output columns per block (two consumer warpgroups x 64)
constexpr int G_BM = 256;  // rows of x per block (the wgmma N)
constexpr int G_BK = 64;
constexpr int G_STAGES = 5;
constexpr int G_THREADS = 384;             // producer warpgroup + two consumers
constexpr int G_X_BYTES = G_BM * G_BK * 2;  // one bf16 x tile, 128-byte swizzled rows
constexpr int G_W_BYTES = G_BK * G_BN;      // one int8 w8 tile, 128-byte swizzled rows
constexpr int G_SMEM = G_STAGES * (G_X_BYTES + G_W_BYTES) + 2 * G_STAGES * 8 + 1024;

// The A fragments of one 64-k step for this warp's 16 output columns (the
// 16-byte chunk `chunk` of each 128-byte int8 row): two ldmatrix.x4.trans
// of 32 k rows each. Lane l gives the address of k row 32h + l; matrix m of
// x4 h covers k 32h + 8m .. +7 and hands thread (g, c) the bytes (k 2c, col
// 2g), (2c, 2g+1), (2c+1, 2g), (2c+1, 2g+1): the bf16 pairs (k 2c, 2c+1) of
// columns 2g (fragment row g) and 2g + 1 (row g + 8).
__device__ __forceinline__ void load_a(uint32_t wtile, int chunk, int lane, uint32_t a[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4];
    const int k = 32 * h + lane;
    ldmatrix_x4_trans(r, wtile + k * 128 + ((chunk ^ (k & 7)) << 4));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float f[4];
      i8x4_to_f32(r[m], f);
      const int i = (2 * h + (m >> 1)) * 4 + 2 * (m & 1);
      a[i] = bf16x2_exact(f[0], f[2]);
      a[i + 1] = bf16x2_exact(f[1], f[3]);
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename OT>
__global__ void __launch_bounds__(G_THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                     OT* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t g_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t xs = smem_u32(smem);
  const uint32_t ws = xs + G_STAGES * G_X_BYTES;
  const uint32_t full = ws + G_STAGES * G_W_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + G_STAGES * 8;       // empty[s] at empty + 8 s
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  const int nk = (K + G_BK - 1) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive plus the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec40();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES;
        mbar_wait(empty + 8 * s, ((kt / G_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, G_X_BYTES + G_W_BYTES);
        tma_load_2d(xs + s * G_X_BYTES, &xmap, kt * G_BK, m0, full + 8 * s);
        tma_load_2d(ws + s * G_W_BYTES, &wmap, n0, kt * G_BK, full + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc232();
    const int cw = wg - 1, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
    const int chunk = cw * 4 + warp;  // this warp's 16 output columns
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a0[16], a1[16];

    auto step = [&](int kt, uint32_t a[16]) {
      const int s = kt % G_STAGES;
      mbar_wait(full + 8 * s, (kt / G_STAGES) & 1);
      load_a(ws + s * G_W_BYTES, chunk, lane, a);
      wgmma_fence();
      const uint32_t b = xs + s * G_X_BYTES;
#pragma unroll
      for (int kk = 0; kk < G_BK / 16; ++kk)
        wgmma_rs_m64n256k16(acc, a + 4 * kk, wgmma_desc_sw128(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // step kt - 1 is done: its stage and A registers are free
      if (kt > 0 && wtid == 0) mbar_arrive(empty + 8 * ((kt - 1) % G_STAGES));
    };
    int kt = 0;
    for (; kt + 1 < nk; kt += 2) {
      step(kt, a0);
      step(kt + 1, a1);
    }
    if (kt < nk) step(kt, a0);
    wgmma_wait<0>();

    // fragment rows g and g + 8 of warp w hold columns 2g and 2g + 1 of its chunk
    const int c = n0 + chunk * 16 + 2 * (lane >> 2);
    if (c < N) {  // N % 16 == 0: c + 1 < N as well
      const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = m0 + 8 * i + 2 * (lane & 3);
        if (r < M) store2(out + (size_t)r * N + c, acc[4 * i] * s0, acc[4 * i + 2] * s1);
        if (r + 1 < M)
          store2(out + (size_t)(r + 1) * N + c, acc[4 * i + 1] * s0, acc[4 * i + 3] * s1);
      }
    }
  }
}

// y[i] = bf16(x[i]) for n elements, n a multiple of 4.
__global__ void cast_bf16_kernel(const float4* __restrict__ x, uint2* __restrict__ y, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    y[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

template <typename OT>
cudaError_t run_gemm(const bf16* x, const int8_t* w8, const float* scale, OT* out, int M, int K,
                     int N, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (size_t)K * 2, G_BK, G_BM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, (size_t)N, G_BN, G_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  int8_gemm_kernel<OT><<<grid, G_THREADS, G_SMEM, stream>>>(xmap, wmap, scale, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vv

// x (M, K) bf16 or f32; w8 (K, N) int8; scale (N,) f32; out (M, N) in x's
// dtype; x, x_bf16 and w8 16-byte aligned. For f32 x, x_bf16 is a scratch
// of M * K bf16 (unused for bf16 x).
extern "C" int vv_int8_gemm(const void* x, int x_dtype, void* x_bf16, const void* w8,
                            const void* scale, void* out, int M, int K, int N, void* stream) {
  using namespace vv;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  if (x_dtype == VV_BF16)
    return (int)run_gemm(static_cast<const bf16*>(x), w, sc, static_cast<bf16*>(out), M, K, N, s);
  if (x_dtype != VV_F32) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)M * K / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  cast_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(x), static_cast<uint2*>(x_bf16),
                                          n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)run_gemm(static_cast<const bf16*>(x_bf16), w, sc, static_cast<float*>(out), M, K, N,
                       s);
}
