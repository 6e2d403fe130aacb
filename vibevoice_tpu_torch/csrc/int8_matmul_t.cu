// Kernel E: dx = bf16(g * scale) @ w8^T, the activation gradient of kernel A
// (the backward of every int8 LM linear in QLoRA fine-tuning), as a TMA +
// wgmma GEMM.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/quant.py:220 int8_matmul_t
// (body `_kernel_t`, :196). Semantics kept: g is multiplied by the
// per-output-column f32 scale and rounded to bf16 (the TPU kernel's rounding
// point, :207-209), w8 is converted to bf16 (exact), the sum is f32 and the
// output has g's dtype.
//
// What bounds it on an H100: tensor-core work. The gate/up dx of a QLoRA
// step (4,096 rows x 8960 -> 1536) is 1.1e11 FLOP, 0.114 ms at the 989
// TFLOP/s bf16 peak, against 0.2 GB of f32 g, int8 w8 and f32 dx (0.06 ms).
// The design follows int8_gemm.cu (kernel A) in the other direction: it
// computes dx^T (IN x R) = w8 (IN x OUT) gs^T, so that the int8 weight is
// wgmma's register A operand and no dequantized weight exists anywhere.
//   - gs = bf16(g * scale) is formed by one elementwise pass
//     (scale_cast_kernel), which also permutes the columns inside each group
//     of 16 (see kperm below). Forming it in the producer instead would make
//     every one of the IN / 128 column blocks read f32 g (twice the bytes of
//     gs) from L2;
//   - w8's rows are K-major (OUT is contiguous), so a plain ldmatrix of int8
//     pairs (no .trans) hands lane (g, c) bytes 4c..4c+3 of rows g and g + 8
//     of a 16-k chunk; converted to bf16 in registers (exact) they fill the
//     fragment's k positions (2c, 2c+1) and (2c+8, 2c+9). That places k
//     4c + e at position 2c + e and 4c + 2 + e at 2c + 8 + e: the
//     permutation kperm, which the cast pass applies to gs's columns, so
//     that both operands see the same order;
//   - gs is the B operand: 192 rows x 64 k per tile, K-major with the
//     128-byte swizzle, read by wgmma m64n192k16 from shared memory; w8
//     arrives as 128 rows x 64 bytes with the 64-byte swizzle (ldmatrix
//     without bank conflicts);
//   - a producer warpgroup (one thread) streams both tiles with TMA through
//     a 6-stage ring of mbarriers; two consumer warpgroups each own 64 IN
//     rows x 192 g rows (96 f32 accumulators a thread), double-buffer the
//     converted A fragments and release a stage once its wgmma is done;
//   - a 192-row tile gives 264 blocks at 4,096 x 1536 (two full waves of
//     the 132 SMs) where 256 rows would give 192 (1.45 waves);
//   - every row's sum runs over OUT in one fixed order (no split-K), so a
//     row's result does not depend on how many rows the call has;
//   - the epilogue stages each consumer's transposed tile in shared memory
//     (rows padded to 68 floats: the fragment writes hit 32 banks) and
//     stores rows of dx with 16-byte (f32) or 8-byte (bf16) coalesced writes.
// TMA zero-fills the ragged edges of R, IN and OUT. Its row strides must be
// multiples of 16 bytes and the permutation works on groups of 16 columns,
// so OUT must be a multiple of 16; the vector stores need IN a multiple of 4.
#include "mma.cuh"
#include "tma.cuh"

namespace vv {
namespace {

constexpr int E_BN = 128;  // IN rows of w8 per block (two consumer warpgroups x 64)
constexpr int E_BM = 192;  // rows of g per block (the wgmma N)
constexpr int E_BK = 64;
constexpr int E_STAGES = 6;
constexpr int E_THREADS = 384;               // producer warpgroup + two consumers
constexpr int E_G_BYTES = E_BM * E_BK * 2;   // one bf16 gs tile, 128-byte swizzled rows
constexpr int E_W_BYTES = E_BN * E_BK;       // one int8 w8 tile, 64-byte swizzled rows
constexpr int E_SROW = 64 + 4;               // staged output row (floats)
constexpr int E_SMEM = E_STAGES * (E_G_BYTES + E_W_BYTES) + 2 * E_STAGES * 8 + 1024;
static_assert(2 * E_BM * E_SROW * 4 <= E_STAGES * (E_G_BYTES + E_W_BYTES),
              "the staged output must fit in the ring");

// The A fragments of one 64-k step for the 16 w8 rows starting at row16 of
// the tile: two ldmatrix.x4 of two 16-byte chunks each. Matrix m of x4 h
// covers rows 8 (m & 1) .. +7 of chunk 2h + (m >> 1); lane (g, c) receives
// bytes 4c..4c+3 of its row g (see kperm above).
__device__ __forceinline__ void load_a(uint32_t wtile, int row16, int lane, uint32_t a[16]) {
  const int r = row16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int chunk = 2 * h + (lane >> 4);
    uint32_t x[4];
    ldmatrix_x4(x, wtile + r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4));
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // k16 step 2h + j
      float f0[4], f1[4];
      i8x4_to_f32(x[2 * j], f0);      // row g
      i8x4_to_f32(x[2 * j + 1], f1);  // row g + 8
      uint32_t* d = a + 4 * (2 * h + j);
      d[0] = bf16x2_exact(f0[0], f0[1]);
      d[1] = bf16x2_exact(f1[0], f1[1]);
      d[2] = bf16x2_exact(f0[2], f0[3]);
      d[3] = bf16x2_exact(f1[2], f1[3]);
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// out (M, N) = (w8 (N, K) gs^T)^T for gs (M, K) bf16 with kperm'd columns.
template <typename OT>
__global__ void __launch_bounds__(E_THREADS, 1)
    int8_matmul_t_kernel(const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap wmap, OT* __restrict__ out, int M,
                         int N, int K) {
  extern __shared__ uint8_t e_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(e_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t gs_s = smem_u32(smem);
  const uint32_t ws_s = gs_s + E_STAGES * E_G_BYTES;
  const uint32_t full = ws_s + E_STAGES * E_W_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + E_STAGES * 8;         // empty[s] at empty + 8 s
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * E_BN, m0 = blockIdx.y * E_BM;
  const int nk = (K + E_BK - 1) / E_BK;

  if (tid == 0) {
    for (int s = 0; s < E_STAGES; ++s) {
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
        const int s = kt % E_STAGES;
        mbar_wait(empty + 8 * s, ((kt / E_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, E_G_BYTES + E_W_BYTES);
        tma_load_2d(gs_s + s * E_G_BYTES, &gmap, kt * E_BK, m0, full + 8 * s);
        tma_load_2d(ws_s + s * E_W_BYTES, &wmap, kt * E_BK, n0, full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc232();
  const int cw = wg - 1, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int row16 = cw * 64 + warp * 16;  // this warp's 16 IN rows of the tile
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  uint32_t a0[16], a1[16];

  auto step = [&](int kt, uint32_t a[16]) {
    const int s = kt % E_STAGES;
    mbar_wait(full + 8 * s, (kt / E_STAGES) & 1);
    load_a(ws_s + s * E_W_BYTES, row16, lane, a);
    wgmma_fence();
    const uint32_t b = gs_s + s * E_G_BYTES;
#pragma unroll
    for (int kk = 0; kk < E_BK / 16; ++kk)
      wgmma_rs_m64n192k16(acc, a + 4 * kk, wgmma_desc_sw128(b + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1 is done: its stage and A registers are free
    if (kt > 0 && wtid == 0) mbar_arrive(empty + 8 * ((kt - 1) % E_STAGES));
  };
  int kt = 0;
  for (; kt + 1 < nk; kt += 2) {
    step(kt, a0);
    step(kt + 1, a1);
  }
  if (kt < nk) step(kt, a0);
  wgmma_wait<0>();

  // Both consumers are done with the ring (every TMA load has been waited
  // for): stage the transposed tile there. Thread (warp, g, c) holds IN row
  // 16 warp + g (+ 8 for d[4i + 2, 3]) at g rows 8i + 2c + {0, 1}.
  named_sync(1, 256);
  float* stg = reinterpret_cast<float*>(smem) + cw * E_BM * E_SROW;
  {
    const int n = 16 * warp + (lane >> 2), r0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < E_BM / 8; ++i) {
      float* p = stg + (8 * i + r0) * E_SROW + n;
      p[0] = acc[4 * i];
      p[E_SROW] = acc[4 * i + 1];
      p[8] = acc[4 * i + 2];
      p[E_SROW + 8] = acc[4 * i + 3];
    }
  }
  named_sync(2 + cw, 128);
  // rows of dx: 16 threads x 4 consecutive IN columns each
  for (int it = wtid; it < E_BM * 16; it += 128) {
    const int r = it >> 4, ch = it & 15;
    const int gr = m0 + r, gn = n0 + cw * 64 + ch * 4;
    if (gr < M && gn < N)  // N % 4 == 0: gn + 3 < N as well
      store4(out + (size_t)gr * N + gn, *reinterpret_cast<const float4*>(stg + r * E_SROW + ch * 4));
  }
}

__device__ __forceinline__ void load16(const float* p, float v[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) load4(p + 4 * j, v + 4 * j);
}
__device__ __forceinline__ void load16(const bf16* p, float v[16]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[j];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[8 * j + 2 * e] = f.x;
      v[8 * j + 2 * e + 1] = f.y;
    }
  }
}

// gs = bf16(g * scale) over groups of 16 columns (K a multiple of 16), each
// group's columns in kperm order: position p holds column
// 4 ((p & 7) >> 1) + 2 (p >> 3) + (p & 1), so the bf16 pairs of positions
// (0,1) (2,3) .. (14,15) are columns (0,1) (4,5) (8,9) (12,13) (2,3) (6,7)
// (10,11) (14,15).
template <typename GT>
__global__ void scale_cast_kernel(const GT* __restrict__ g, const float* __restrict__ scale,
                                  uint4* __restrict__ gs, int K, size_t groups) {
  const int kg = K / 16;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < groups;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[16], s[16];
    load16(g + i * 16, v);
    load16(scale + (i % kg) * 16, s);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] *= s[j];
    gs[2 * i] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[4], v[5]), pack_bf16(v[8], v[9]),
                           pack_bf16(v[12], v[13]));
    gs[2 * i + 1] = make_uint4(pack_bf16(v[2], v[3]), pack_bf16(v[6], v[7]),
                               pack_bf16(v[10], v[11]), pack_bf16(v[14], v[15]));
  }
}

template <typename GT>
cudaError_t run_cast(const void* g, const void* scale, void* gs, int M, int K, cudaStream_t s) {
  const size_t groups = (size_t)M * K / 16;
  const int blocks = (int)((groups + 255) / 256 < 132 * 16 ? (groups + 255) / 256 : 132 * 16);
  scale_cast_kernel<GT><<<blocks, 256, 0, s>>>(static_cast<const GT*>(g),
                                               static_cast<const float*>(scale),
                                               static_cast<uint4*>(gs), K, groups);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t run_gemm(const void* gs, const void* w8, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  CUtensorMap gmap, wmap;
  if (!make_map(&gmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, gs, K, M, (size_t)K * 2, E_BK, E_BM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, K, N, (size_t)K, E_BK, E_BN,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_t_kernel<OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, E_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + E_BN - 1) / E_BN, (M + E_BM - 1) / E_BM);
  int8_matmul_t_kernel<OT><<<grid, E_THREADS, E_SMEM, stream>>>(gmap, wmap, static_cast<OT*>(out),
                                                                M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vv

// g (rows, out_dim) f32 or bf16 (g_dtype), w8 (in_dim, out_dim) int8, scale
// (out_dim,) f32 -> out (rows, in_dim) in g's dtype; gs is a scratch of
// rows * out_dim bf16. phases: 1 forms gs from g (the cast pass), 2 runs the
// GEMM on gs, 3 both. out_dim must be a multiple of 16 and in_dim of 4; g,
// gs, w8, scale and out 16-byte aligned.
extern "C" int vv_int8_matmul_t(const void* g, int g_dtype, void* gs, const void* w8,
                                const void* scale, void* out, int rows, int in_dim, int out_dim,
                                int phases, void* stream) {
  using namespace vv;
  if (rows <= 0 || in_dim <= 0 || out_dim <= 0 || out_dim % 16 || in_dim % 4 || phases < 1 ||
      phases > 3 || (g_dtype != VV_F32 && g_dtype != VV_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    const cudaError_t err = g_dtype == VV_F32 ? run_cast<float>(g, scale, gs, rows, out_dim, s)
                                              : run_cast<bf16>(g, scale, gs, rows, out_dim, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2)
    return (int)(g_dtype == VV_F32 ? run_gemm<float>(gs, w8, out, rows, in_dim, out_dim, s)
                                   : run_gemm<bf16>(gs, w8, out, rows, in_dim, out_dim, s));
  return 0;
}
