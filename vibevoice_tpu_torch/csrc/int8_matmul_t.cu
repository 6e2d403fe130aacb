// Kernel E: dx = bf16(g * scale) @ w8^T, the activation gradient of kernel A
// (the backward of every int8 LM linear in QLoRA fine-tuning).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:220 int8_matmul_t
// (body `_kernel_t`, :196). Semantics kept: g is multiplied by the
// per-output-column f32 scale and rounded to bf16 (the TPU kernel's rounding
// point, :207-209), w8 is converted to bf16 (exact), the sum is f32 and the
// output has g's dtype.
//
// At training rows (R = B*T = 4096 or 8192) this is a GEMM, bound by tensor
// core work, not by the int8 weight stream: M = R, N = IN, K = OUT, and both
// operands are K-major (g is (R, OUT), w8 is (IN, OUT), both row-major),
// which is the layout mma.sync wants for A (row) and B (col). Design: a
// 128x128 output tile per block of 8 warps (2 x 4, each warp 64 x 32), K in
// steps of 32 staged through shared memory as bf16 (the scale multiply and
// the int8 -> bf16 conversion happen on the way in), bf16 mma.sync m16n8k16
// with f32 accumulators. Loads are synchronous (no cp.async/TMA pipeline, no
// wgmma yet): right and simple first. Masks handle any R, IN and OUT.
#include "common.cuh"

namespace vv {
namespace {

constexpr int ET_BM = 128, ET_BN = 128, ET_BK = 32, ET_PAD = 8, ET_THREADS = 256;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename GT>
__device__ __forceinline__ void store_out(GT* out, int M, int N, int r, int c, float v) {
  if (r < M && c < N) out[(size_t)r * N + c] = from_f<GT>(v);
}

template <typename GT>
__global__ void __launch_bounds__(ET_THREADS)
    int8_matmul_t_kernel(const GT* __restrict__ g, const int8_t* __restrict__ w8,
                         const float* __restrict__ scale, GT* __restrict__ out, int M, int N,
                         int K) {
  // row stride 40 bf16 = 20 words: the fragment reads below hit 32 distinct banks
  __shared__ __align__(16) bf16 As[ET_BM][ET_BK + ET_PAD];
  __shared__ __align__(16) bf16 Bs[ET_BN][ET_BK + ET_PAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., cols wn*32..
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * ET_BM, n0 = blockIdx.x * ET_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += ET_BK) {
    // A tile (128 rows x 32 k): 8 threads per row, 4 consecutive k each, 4 passes
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = p * 32 + (tid >> 3), c = (tid & 7) * 4;
      const int gm = m0 + r;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + c + e;
        v[e] = (gm < M && kk < K) ? to_f(g[(size_t)gm * K + kk]) * scale[kk] : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(&As[r][c]) = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(&As[r][c + 2]) = __floats2bfloat162_rn(v[2], v[3]);
    }
    // B tile (128 IN-rows x 32 k of w8): 2 threads per row, 16 consecutive k each
    {
      const int r = tid >> 1, c = (tid & 1) * 16;
      const int gn = n0 + r;
      const int8_t* src = w8 + (size_t)gn * K;
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const int kk = k0 + c + e;
        const float a = (gn < N && kk < K) ? (float)src[kk] : 0.f;
        const float b = (gn < N && kk + 1 < K) ? (float)src[kk + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(&Bs[r][c + e]) = __floats2bfloat162_rn(a, b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ET_BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + grp;
        af[i][0] = lds32(&As[r][kk + tig * 2]);
        af[i][1] = lds32(&As[r + 8][kk + tig * 2]);
        af[i][2] = lds32(&As[r][kk + tig * 2 + 8]);
        af[i][3] = lds32(&As[r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + grp;
        bfr[j][0] = lds32(&Bs[n][kk + tig * 2]);
        bfr[j][1] = lds32(&Bs[n][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm * 64 + i * 16 + grp;
      const int c = n0 + wn * 32 + j * 8 + tig * 2;
      store_out(out, M, N, r, c, acc[i][j][0]);
      store_out(out, M, N, r, c + 1, acc[i][j][1]);
      store_out(out, M, N, r + 8, c, acc[i][j][2]);
      store_out(out, M, N, r + 8, c + 1, acc[i][j][3]);
    }
}

template <typename GT>
void launch(const void* g, const void* w8, const void* scale, void* out, int rows, int in_dim,
            int out_dim, cudaStream_t stream) {
  const dim3 grid((in_dim + ET_BN - 1) / ET_BN, (rows + ET_BM - 1) / ET_BM);
  int8_matmul_t_kernel<GT><<<grid, ET_THREADS, 0, stream>>>(
      static_cast<const GT*>(g), static_cast<const int8_t*>(w8), static_cast<const float*>(scale),
      static_cast<GT*>(out), rows, in_dim, out_dim);
}

}  // namespace
}  // namespace vv

// g (rows, out_dim) f32/bf16, w8 (in_dim, out_dim) int8, scale (out_dim,) f32
// -> out (rows, in_dim) in g's dtype.
extern "C" int vv_int8_matmul_t(const void* g, int g_dtype, const void* w8, const void* scale,
                                void* out, int rows, int in_dim, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || in_dim <= 0 || out_dim <= 0) return (int)cudaErrorInvalidValue;
  if (g_dtype == VV_F32)
    vv::launch<float>(g, w8, scale, out, rows, in_dim, out_dim, s);
  else if (g_dtype == VV_BF16)
    vv::launch<vv::bf16>(g, w8, scale, out, rows, in_dim, out_dim, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
