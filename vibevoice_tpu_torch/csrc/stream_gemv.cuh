// One-launch weight-streaming GEMV core: a few rows of x against an int8
// weight matrix that is read from HBM exactly once.
//
//   out[r, n] = epi(r, n, sum_k x(r, k) * w8[k, n])        r < R (a few rows)
//
// What bounds it on an H100: every weight byte is used for R FMAs and by one
// thread only, so the call is bound by the weight stream at 1 or 2 rows and
// more and more by the convert + FMA instructions of the CUDA cores beyond. The
// design keeps the stream wide and deep and everything else out of its way:
//   - a block of 128 threads owns 128 output columns and one K slice; thread
//     (kl, cg) = (tid / 8, tid % 8) reads 16-byte vectors (16 int8 columns)
//     of the k rows kl, kl + 16, ... of the slice, U of them in flight
//     before the first is used and U more started while those are consumed
//     (ld.global.nc; shared memory buys nothing for a byte used once);
//   - the block's x slice (RT rows, rounded by the caller's loader) is staged
//     once as f32 in shared memory while the first loads fly; the k loop has
//     no barrier;
//   - int8 -> f32 is the byte-permute conversion of mma.cuh (plain I2F at
//     this rate would cost about as much as the stream itself);
//   - RT (rows per block) is a template parameter: accumulators, FMAs and
//     the in-block reduction are sized to the call;
//   - split-K sums meet inside the launch: each split writes its f32 partial
//     tile, the last block of a column tile to arrive (one counter per tile,
//     which that block resets, so a CUDA graph replays right) adds the
//     partials in split order and runs the epilogue. No float atomics: two
//     calls on the same inputs give the same bits.
// The plan (row tile, splits, k per split) comes from the shapes alone and is
// computed by the host (ops/quant.py _gemv_plan).
#pragma once

#include "mma.cuh"

namespace vv {

constexpr int SG_THREADS = 128;
constexpr int SG_CG = 8;                      // column groups of 16 int8 per block row
constexpr int SG_KL = SG_THREADS / SG_CG;     // k lanes: interleaved k rows of the slice
constexpr int SG_COLS = SG_CG * 16;           // columns per block
constexpr int SG_WARPS = SG_THREADS / 32;

constexpr int SG_U = 8;                       // 16-byte loads in flight per thread

// k rows of x staged per block: kps rounded up to whole rounds of loads.
__host__ __device__ constexpr int sg_kpad(int kps) {
  constexpr int step = SG_KL * SG_U;
  return (kps + step - 1) / step * step;
}

// grid (ceil(N / 128), splits, ceil(R / RT)). w8 (K, N) row-major with N a
// multiple of 16 and 16-byte aligned; part (splits, R, N) f32 and counters
// (one zero per (row tile, column tile), left zero) are read only when
// splits > 1. xl(row, k) gives x as f32; epi(row, n, sum) stores the result.
// Dynamic shared memory: RT * sg_kpad(kps) floats. RT is 1, 2 or 4: at 8 rows a
// block the 128 accumulators leave two blocks an SM, and two tiles of 4 rows
// that share the weight through L2 are as fast or faster.
template <int RT, class XLoad, class Epi>
__global__ void __launch_bounds__(SG_THREADS)
    stream_gemv_kernel(XLoad xl, const int8_t* __restrict__ w8, float* __restrict__ part,
                       unsigned* __restrict__ counters, int R, int K, int N, int kps, Epi epi) {
  constexpr int U = SG_U;
  extern __shared__ float sg_xs[];                    // [RT][kpad]
  __shared__ float4 red[SG_WARPS][RT][SG_COLS / 4];   // warp sums, then split-lane sums
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & (SG_CG - 1), kl = tid / SG_CG;
  const int nb0 = blockIdx.x * SG_COLS, n0 = nb0 + cg * 16;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = blockIdx.z * RT, nr = min(RT, R - r0);
  const int kb = split * kps, ke = min(K, kb + kps);
  const int kpad = sg_kpad(kps);
  const int nit = (ke - kb + SG_KL * U - 1) / (SG_KL * U);
  const bool col_ok = n0 < N;  // N % 16 == 0: a thread's 16 columns are all in or all out
  const int8_t* wp = w8 + (size_t)kb * N + n0;

  auto load = [&](uint4(&buf)[U], int it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kl + SG_KL * (it * U + u);
      buf[u] = make_uint4(0u, 0u, 0u, 0u);  // converts to 0.f
      if (col_ok && kb + kk < ke) buf[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)kk * N));
    }
  };

  uint4 wcur[U], wnext[U];
  load(wcur, 0);

  for (int i = tid; i < RT * kpad; i += SG_THREADS) {
    const int r = i / kpad, kk = i - r * kpad;
    sg_xs[i] = (r < nr && kb + kk < ke) ? xl(r0 + r, kb + kk) : 0.f;
  }
  __syncthreads();

  float acc[RT][16];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) load(wnext, it + 1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kl + SG_KL * (it * U + u);
      if (kb + SG_KL * (it * U + u) >= ke) break;  // past the slice for every k lane
      float wf[16];
      i8x4_to_f32(wcur[u].x, wf);
      i8x4_to_f32(wcur[u].y, wf + 4);
      i8x4_to_f32(wcur[u].z, wf + 8);
      i8x4_to_f32(wcur[u].w, wf + 12);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = sg_xs[r * kpad + kk];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) wcur[u] = wnext[u];
  }

  // the 16 k lanes meet: 4 inside each warp by shuffles, the 4 warps in
  // shared memory, always in the same order
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  if (lane < SG_CG) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[warp][r][cg * 4 + j] =
            make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2], acc[r][4 * j + 3]);
  }
  __syncthreads();

  // thread c now owns column nb0 + c of every row of the tile
  const int n = nb0 + tid;
  const float* redf = reinterpret_cast<const float*>(red);
  float sum[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SG_WARPS; ++w) s += redf[(w * RT + r) * SG_COLS + tid];
    sum[r] = s;
  }
  if (splits == 1) {
    if (n < N) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) epi(r0 + r, n, sum[r]);
    }
    return;
  }

  if (n < N) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < nr) part[((size_t)split * R + r0 + r) * N + n] = sum[r];
  }
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();  // also: every thread has read red
  if (tid == 0) last = atomicAdd(counters + tile, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last split to arrive adds all partials (its own too, from memory, so
  // the order never depends on which block is last): warp sl takes splits
  // sl, sl + 4, ... for 4 columns a lane, then the 4 warps meet in order
  const int n4 = nb0 + lane * 4;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nr && n4 < N) {
      for (int sp = warp; sp < splits; sp += SG_WARPS) {
        const float4 p =
            __ldcg(reinterpret_cast<const float4*>(part + ((size_t)sp * R + r0 + r) * N + n4));
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
    }
    red[warp][r][lane] = s;
  }
  __syncthreads();
  if (n < N) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= nr) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < SG_WARPS; ++w) s += redf[(w * RT + r) * SG_COLS + tid];
      epi(r0 + r, n, s);
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch (or graph replay)
}

template <int RT, class XLoad, class Epi>
cudaError_t launch_stream_gemv(XLoad xl, const int8_t* w8, float* part, unsigned* counters, int R,
                               int K, int N, int splits, int kps, Epi epi, cudaStream_t stream) {
  const dim3 grid((N + SG_COLS - 1) / SG_COLS, splits, (R + RT - 1) / RT);
  const size_t smem = (size_t)RT * sg_kpad(kps) * sizeof(float);
  stream_gemv_kernel<RT, XLoad, Epi>
      <<<grid, SG_THREADS, smem, stream>>>(xl, w8, part, counters, R, K, N, kps, epi);
  return cudaGetLastError();
}

}  // namespace vv
