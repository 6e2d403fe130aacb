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
// What bounds it on an H100: the weight's bytes up to ~150 rows (a call
// does 2 x rows operations a weight byte, the card 295 bf16 operations a
// byte of HBM), the tensor cores' operations beyond. So the design streams
// the int8 weight once at HBM's rate and keeps everything else off that
// stream, and at many rows it is a 256-row wgmma GEMM that does not split:
//   - the transposed product y^T = w^T x^T, as in int8_gemm.cu: the int8
//     weight is wgmma's register A operand (ldmatrix.trans and an exact
//     convert in registers, mma.cuh load_w8_frag: no dequantized weight
//     exists anywhere); the call's rows are wgmma's N, a row tile BM sized
//     to the call (a multiple of 8 up to 256, a template parameter), so at 8
//     rows the tensor cores do 8 rows' work and not 256;
//   - wherever the rows fit one row tile the weight is read once a call;
//   - K is split until the grid fills one wave of the SMs (at BM <= 128 two
//     blocks an SM), each split a whole number of 64-k steps, as long as a
//     split's partial tile costs no more to add than its K slice costs to
//     read (ops/quant.py _sk_plan). Two warpgroups of 64 columns each
//     convert and issue the wgmmas, and thread 0 streams the x and w8 tiles
//     of the block's K slice with TMA through a ring of up to 8 stages
//     (mbarriers), refilling a stage as soon as both warpgroups' wgmmas on
//     it are done; row tiles up to 64 keep two wgmma groups in flight
//     behind the one issued (there a step's latency, not the bytes, paces a
//     block). No producer warp: a ninth warp would put three warps on one of
//     the SM's four register quadrants and cap a thread at 168 registers (96
//     at two blocks an SM), which serialized the 80- to 256-row tiles'
//     wgmma chains (ptxas C7512); with eight warps a thread may take 255
//     (128 at two blocks);
//   - the splits meet inside the launch in a fixed order, as in
//     weight_stream.cuh: each split writes its f32 partial tile to the
//     workspace, the last block of its (row tile, column tile) to arrive adds
//     the splits in order 0..S-1 (its own from memory too), applies the scale
//     and stores the result, and resets the tile's counter. No float
//     atomics: the same inputs give the same bits, and a CUDA graph replays
//     right. The workspace and counters are the streaming core's
//     (ops/quant.py _gemv_workspace);
//   - a launch may cover column segments (ColSegs, common.cuh: the packed
//     q|k|v and gate|up), each split as its own call would be; blocks past
//     a segment's splits exit. So a column's sum order depends on the rows,
//     K and its segment's width, never on the call's total width.
// f32 x is rounded to bf16 by a cast pass (cast_bf16_kernel) into a scratch
// buffer first. TMA zero-fills the ragged edges of rows, K and N; its row
// strides must be multiples of 16 bytes, so K must be a multiple of 8 and N
// of 16.
#include <limits.h>

#include "mma.cuh"
#include "tma.cuh"

namespace vv {
namespace {

constexpr int SK_BN = 128;              // output columns a block (two consumer warpgroups x 64)
constexpr int SK_BK = 64;               // k a step: one 128-byte swizzled row of bf16 x
constexpr int SK_THREADS = 256;         // two warpgroups; thread 0 also streams the tiles
constexpr int SK_W_BYTES = SK_BK * SK_BN;  // one int8 w8 tile, 128-byte swizzled rows
constexpr int SK_SMEM_SM = 233472;      // shared memory of an SM
constexpr int SK_SMEM_BLOCK = 232448;   // the most one block may take

template <int BM>
struct SkTile {
  static constexpr int X_BYTES = BM * SK_BK * 2;  // one bf16 x tile, 128-byte swizzled rows
  static constexpr int STAGE = X_BYTES + SK_W_BYTES;
  // blocks an SM: two while BM / 2 accumulators leave room for two blocks'
  // registers (128 a thread); ops/quant.py SK_TWO_BLOCKS_TO plans with it
  static constexpr int BLOCKS = BM <= 128 ? 2 : 1;
  static constexpr int ROOM =
      (BLOCKS == 2 ? SK_SMEM_SM / 2 - 1024 : SK_SMEM_BLOCK) - 1024 - 16 * 8;
  static constexpr int STAGES = ROOM / STAGE < 8 ? ROOM / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;  // + barriers, alignment
  // wgmma groups a warpgroup keeps in flight behind the one it issues: at
  // small row tiles a step's group is short and its latency, not the
  // weight's bytes, sets the pace, so two (a third A-fragment buffer);
  // larger tiles keep one (their registers are the accumulators')
  static constexpr int PEND = BM <= 64 ? 2 : 1;
};

__device__ __forceinline__ void store_pair(void* out, int out_f32, size_t i, float a, float b) {
  if (out_f32)
    store2(static_cast<float*>(out) + i, a, b);
  else
    store2(static_cast<bf16*>(out) + i, a, b);
}

// grid (row tiles, column tiles, the segments' most splits). x (M, K) bf16
// and w8 (K, N) int8 by tensor maps; out (M, N) f32 or bf16; part and
// counters as ColSegs and the caller lay them out, read only where a
// segment splits.
template <int BM>
__global__ void __launch_bounds__(SK_THREADS, SkTile<BM>::BLOCKS)
    int8_gemm_sk_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                        void* __restrict__ out, int out_f32, float* __restrict__ part,
                        unsigned* __restrict__ counters, int M, int K, int N,
                        const ColSegs segs) {
  using T = SkTile<BM>;
  constexpr int ST = T::STAGES;
  const int seg = segs.find(blockIdx.y);
  const int split = blockIdx.z, splits = ColSegs::pick(segs.splits, seg);
  if (split >= splits) return;  // the segment takes fewer splits than the launch's most
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * SK_BN;
  const int steps = ColSegs::pick(segs.kps, seg) / SK_BK, kt0 = split * steps;
  const int nkt = min((K + SK_BK - 1) / SK_BK - kt0, steps);  // >= 1 by the plan

  extern __shared__ uint8_t sk_smem_raw[];
  __shared__ bool last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(sk_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t xs = smem_u32(smem);
  const uint32_t ws = xs + ST * T::X_BYTES;
  const uint32_t full = ws + ST * SK_W_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + ST * 8;        // empty[s] at empty + 8 s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wtid = tid & 127;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);   // thread 0's arrive plus the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrive per warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto load = [&](int i) {  // k step i of the slice into its stage (thread 0)
    const int s = i % ST, k = (kt0 + i) * SK_BK;
    mbar_arrive_expect_tx(full + 8 * s, T::STAGE);
    tma_load_2d(xs + s * T::X_BYTES, &xmap, k, m0, full + 8 * s);
    tma_load_2d(ws + s * SK_W_BYTES, &wmap, n0, k, full + 8 * s);
  };
  if (tid == 0) {
    tma_prefetch_desc(&xmap);
    tma_prefetch_desc(&wmap);
    for (int i = 0; i < min(ST, nkt); ++i) load(i);
  }

  // warp w owns output columns n0 + 16 w .. + 15
  constexpr int PEND = T::PEND;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a[PEND + 1][16];  // step i converts into a[i % (PEND + 1)]

  auto step = [&](int i, uint32_t frag[16]) {
    const int s = i % ST;
    mbar_wait(full + 8 * s, (i / ST) & 1);
    load_w8_frag(ws + s * SK_W_BYTES, warp, lane, frag);
    wgmma_fence();
    const uint32_t b = xs + s * T::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < SK_BK / 16; ++kk)
      wgmma_rs<BM>(acc, frag + 4 * kk, wgmma_desc_sw128(b + kk * 32));
    wgmma_commit();
    wgmma_wait<PEND>();  // step i - PEND is done: its stage and A registers are free
    if (i >= PEND) {
      const int j = i - PEND, sj = j % ST;
      if (wtid == 0) mbar_arrive(empty + 8 * sj);
      if (tid == 0 && j + ST < nkt) {  // both warpgroups are done with step j: refill
        mbar_wait(empty + 8 * sj, (j / ST) & 1);
        load(j + ST);
      }
      __syncwarp();
    }
  };
  for (int i = 0; i < nkt; i += PEND + 1) {
#pragma unroll
    for (int u = 0; u <= PEND; ++u)
      if (i + u < nkt) step(i + u, a[u]);
  }
  wgmma_wait<0>();

  // fragment rows g and g + 8 of warp w hold columns 2g and 2g + 1 of its
  // 16; accumulator 4j + {0, 1} rows 8j + 2 (lane % 4) + {0, 1} of column
  // 2g, 4j + {2, 3} the same rows of column 2g + 1
  const int c = n0 + warp * 16 + 2 * (lane >> 2);
  if (c < N) {  // N % 16 == 0: c + 1 < N as well
    if (splits == 1) {
      const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int r = m0 + 8 * j + 2 * (lane & 3);
        if (r < M)
          store_pair(out, out_f32, (size_t)r * N + c, acc[4 * j] * s0, acc[4 * j + 2] * s1);
        if (r + 1 < M)
          store_pair(out, out_f32, (size_t)(r + 1) * N + c, acc[4 * j + 1] * s0,
                     acc[4 * j + 3] * s1);
      }
    } else {  // this split's partial tile: (split, row, column) of the segment
      const int nseg = segs.width(seg, SK_BN, N);
      float* p = part + ColSegs::pick(segs.part0, seg) + (size_t)split * M * nseg +
                 (c - segs.col0(seg, SK_BN));
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int r = m0 + 8 * j + 2 * (lane & 3);
        if (r < M) store2(p + (size_t)r * nseg, acc[4 * j], acc[4 * j + 2]);
        if (r + 1 < M) store2(p + (size_t)(r + 1) * nseg, acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
  if (splits == 1) return;

  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last split to arrive adds all partials in split order, four columns
  // a thread
  const int nseg = segs.width(seg, SK_BN, N), c0 = segs.col0(seg, SK_BN);
  const size_t plane = (size_t)M * nseg;
  const float* p = part + ColSegs::pick(segs.part0, seg);
  for (int e = tid; e < BM * (SK_BN / 4); e += SK_THREADS) {
    const int r = m0 + e / (SK_BN / 4), c = n0 + 4 * (e % (SK_BN / 4));
    if (r >= M || c >= N) continue;  // N % 16 == 0: c + 3 < N as well
    const float* q = p + (size_t)r * nseg + (c - c0);
    float4 s = __ldcg(reinterpret_cast<const float4*>(q));
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(q + sp * plane));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const size_t o = (size_t)r * N + c;
    store_pair(out, out_f32, o, s.x * scale[c], s.y * scale[c + 1]);
    store_pair(out, out_f32, o + 2, s.z * scale[c + 2], s.w * scale[c + 3]);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch (or graph replay)
}

template <int BM>
cudaError_t launch_sk(const bf16* x, const int8_t* w8, const float* scale, void* out, int out_f32,
                      float* part, unsigned* counters, int M, int K, int N, const ColSegs& segs,
                      cudaStream_t stream) {
  using T = SkTile<BM>;
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (size_t)K * 2, SK_BK, BM) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, (size_t)N, SK_BN, SK_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_sk_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, segs.tile0[segs.n], segs.max_splits);
  int8_gemm_sk_kernel<BM><<<grid, SK_THREADS, T::SMEM, stream>>>(xmap, wmap, scale, out, out_f32,
                                                                  part, counters, M, K, N, segs);
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
