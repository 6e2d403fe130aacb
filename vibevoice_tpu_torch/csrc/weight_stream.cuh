// One-launch weight-streaming GEMV core: a few rows of x against a weight
// matrix (int8, bf16 or f32) that is read from HBM exactly once. Kernel A's
// decode route (int8_matmul.cu, up to quant.GEMV_MAX_ROWS rows) and the
// layer passes of kernels C (head_ffn.cu) and D (vocoder_stage.cu) at 1-2
// rows and for dense weights run on it; their batched rows with int8
// weights run on the split-K tensor-core core (splitk_core.cuh), whose
// block-formed x takes this core's loaders.
//
//   out[r, n] = epi(r, n, sum_k x(r, k) * w[k, n])         r < R (a few rows)
//
// What bounds it on an H100: every weight byte is used for R FMAs and by one
// thread only, so the call is bound by the weight stream at 1 or 2 rows and
// more and more by the convert + FMA instructions of the CUDA cores beyond. The
// design keeps the stream wide and deep and everything else out of its way:
//   - a block of 128 threads owns 8 16-byte vectors of columns (128 int8,
//     64 bf16 or 32 f32 columns) and one K slice; thread (kl, cg) =
//     (tid / 8, tid % 8) reads the 16-byte vector cg of the k rows kl,
//     kl + 16, ... of the slice, U of them in flight before the first is
//     used and U more started while those are consumed (ld.global.nc; shared
//     memory buys nothing for a byte used once);
//   - the block's x slice (RT rows, formed by the caller's loader, which may
//     fuse a norm, a modulation or an activation into it) is staged once as
//     f32 in shared memory while the first loads fly; the k loop has no
//     barrier. A loader that needs a sum over its whole row (an RMSNorm) gets
//     it from a pre-pass of the block, also while the first loads fly;
//   - int8 -> f32 is the byte-permute conversion of mma.cuh (plain I2F at
//     this rate would cost about as much as the stream itself); bf16 -> f32 a
//     shift;
//   - RT (rows per block) is a template parameter: accumulators, FMAs and
//     the in-block reduction are sized to the call;
//   - split-K sums meet inside the launch: each split writes its f32 partial
//     tile, the last block of a column tile to arrive (one counter per tile,
//     which that block resets, so a CUDA graph replays right) adds the
//     partials in a fixed order and runs the epilogue. No float atomics: two
//     calls on the same inputs give the same bits;
//   - a launch may cover column segments (ColSegs, common.cuh: kernel A's
//     packed q|k|v and gate|up), each split as its own call would be, so a
//     column's sum never depends on the launch's width. The row tile does
//     not enter that order: each row is summed alone, in the same lanes.
// The plan (row tile, splits, k per split) comes from the shapes alone and is
// computed by the host (ops/quant.py _gemv_plan).
#pragma once

#include "mma.cuh"

namespace vv {

constexpr int SG_THREADS = 128;
constexpr int SG_CG = 8;                      // column groups (a 16-byte vector each) a block
constexpr int SG_KL = SG_THREADS / SG_CG;     // k lanes: interleaved k rows of the slice
constexpr int SG_WARPS = SG_THREADS / 32;

constexpr int SG_U = 8;                       // 16-byte loads in flight per thread

// k rows of x staged per block: kps rounded up to whole rounds of loads.
__host__ __device__ constexpr int sg_kpad(int kps) {
  constexpr int step = SG_KL * SG_U;
  return (kps + step - 1) / step * step;
}

// One 16-byte weight vector: VC columns of WT, converted to f32.
template <typename WT>
struct StreamW;

template <>
struct StreamW<int8_t> {
  static constexpr int VC = 16;
  static __device__ __forceinline__ void cvt(const uint4& v, float (&f)[16]) {
    i8x4_to_f32(v.x, f);
    i8x4_to_f32(v.y, f + 4);
    i8x4_to_f32(v.z, f + 8);
    i8x4_to_f32(v.w, f + 12);
  }
};

template <>
struct StreamW<bf16> {  // element 2i in the low half of word i: bf16 -> f32 is a shift
  static constexpr int VC = 8;
  static __device__ __forceinline__ void cvt(const uint4& v, float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
};

template <>
struct StreamW<float> {
  static constexpr int VC = 4;
  static __device__ __forceinline__ void cvt(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

// Per-column dequant scale; null for dense weights.
static __device__ __forceinline__ float col_scale(const float* s, int n) {
  return s ? s[n] : 1.f;
}

// grid (ceil(N / (8 * VC)), splits, ceil(R / RT)): one K split of kps a
// block; with SEGS, the column segments' most splits, each segment's kps
// its own, and a block past its segment's splits exits (one segment runs
// without SEGS: its block pays nothing for them). w (K, N) row-major with N a
// multiple of 16 and 16-byte aligned; part (each split segment's (splits, R,
// width) f32 at its part0) and counters (one zero per (row tile, column
// tile), left zero) are read only where a segment splits. epi(row, n, sum)
// stores the result. The loader: with XLoad::kRowSum false, xl(row, k)
// gives x as f32; with it true, the block first sums xl.row_term(row, i)
// over i < xl.row_len for each of its rows and xl(row, k, sum) gives x (an
// RMSNorm fused into the loader). Dynamic shared memory: RT *
// sg_kpad(the segments' largest kps) floats. RT is 1, 2 or 4: at 8 rows a
// block the 128 accumulators leave two blocks an SM, and two tiles of 4 rows
// that share the weight through L2 are as fast or faster.
template <int RT, typename WT, class XLoad, class Epi, bool SEGS>
__global__ void __launch_bounds__(SG_THREADS)
    stream_gemv_kernel(XLoad xl, const WT* __restrict__ w, float* __restrict__ part,
                       unsigned* __restrict__ counters, int R, int K, int N, int kps_one,
                       const ColSegs segs, Epi epi) {
  constexpr int U = SG_U, VC = StreamW<WT>::VC, COLS = SG_CG * VC;  // columns a block owns
  extern __shared__ float sg_xs[];                 // [RT][kpad]
  __shared__ float4 red[SG_WARPS][RT][COLS / 4];   // row sums, warp sums, then split sums
  __shared__ bool last;
  float* redf = reinterpret_cast<float*>(red);

  const int split = blockIdx.y;
  int splits = gridDim.y, kps = kps_one, c0 = 0, nseg = N;
  float* spart = part;  // (splits, R, nseg)
  if constexpr (SEGS) {
    const int seg = segs.find(blockIdx.x);
    splits = ColSegs::pick(segs.splits, seg);
    if (split >= splits) return;  // the segment takes fewer splits than the launch's most
    kps = ColSegs::pick(segs.kps, seg);
    c0 = segs.col0(seg, COLS);
    nseg = segs.width(seg, COLS, N);
    spart = part + ColSegs::pick(segs.part0, seg);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & (SG_CG - 1), kl = tid / SG_CG;
  const int nb0 = blockIdx.x * COLS, n0 = nb0 + cg * VC;
  const int r0 = blockIdx.z * RT, nr = min(RT, R - r0);
  const int kb = split * kps, ke = min(K, kb + kps);
  const int kpad = sg_kpad(kps);
  const int nit = (ke - kb + SG_KL * U - 1) / (SG_KL * U);
  const bool col_ok = n0 < N;  // N % 16 == 0: a thread's VC columns are all in or all out
  const WT* wp = w + (size_t)kb * N + n0;

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

  if constexpr (XLoad::kRowSum) {
    // each thread sums the terms i = tid mod 128 of a row in order of i (4
    // loads in flight), the lanes of a warp meet by shuffles, the 4 warps in
    // shared memory, always in the same order
    float s[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      s[r] = 0.f;
      if (r < nr) {
        for (int i0 = tid; i0 < xl.row_len; i0 += 4 * SG_THREADS) {
          float t[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = i0 + j * SG_THREADS;
            t[j] = i < xl.row_len ? xl.row_term(r0 + r, i) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r] += t[j];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) redf[warp * RT + r] = s[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < RT * kpad; i += SG_THREADS) {
    const int r = i / kpad, kk = i - r * kpad;
    float v = 0.f;
    if (r < nr && kb + kk < ke) {
      if constexpr (XLoad::kRowSum) {
        float sum = 0.f;
#pragma unroll
        for (int w_ = 0; w_ < SG_WARPS; ++w_) sum += redf[w_ * RT + r];
        v = xl(r0 + r, kb + kk, sum);
      } else {
        v = xl(r0 + r, kb + kk);
      }
    }
    sg_xs[i] = v;
  }
  __syncthreads();  // also: the row sums are read before red is written below

  float acc[RT][VC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[r][c] = 0.f;

  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) load(wnext, it + 1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kl + SG_KL * (it * U + u);
      if (kb + SG_KL * (it * U + u) >= ke) break;  // past the slice for every k lane
      float wf[VC];
      StreamW<WT>::cvt(wcur[u], wf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = sg_xs[r * kpad + kk];
#pragma unroll
        for (int c = 0; c < VC; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
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
    for (int c = 0; c < VC; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  if (lane < SG_CG) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < VC / 4; ++j)
        red[warp][r][cg * (VC / 4) + j] =
            make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2], acc[r][4 * j + 3]);
  }
  __syncthreads();

  // thread c < COLS now owns column nb0 + c of every row of the tile
  const int n = nb0 + tid;
  const bool own = (COLS >= SG_THREADS || tid < COLS) && n < N;
  float sum[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float s = 0.f;
    if (COLS >= SG_THREADS || tid < COLS) {
#pragma unroll
      for (int w_ = 0; w_ < SG_WARPS; ++w_) s += redf[(w_ * RT + r) * COLS + tid];
    }
    sum[r] = s;
  }
  if (splits == 1) {
    if (own) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < nr) epi(r0 + r, n, sum[r]);
    }
    return;
  }

  if (own) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < nr) spart[((size_t)split * R + r0 + r) * nseg + n - c0] = sum[r];
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
  const bool lane_ok = COLS >= 128 || lane * 4 < COLS;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane_ok && r < nr && n4 < N) {
      for (int sp = warp; sp < splits; sp += SG_WARPS) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            spart + ((size_t)sp * R + r0 + r) * nseg + n4 - c0));
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
    }
    if (lane_ok) red[warp][r][lane] = s;
  }
  __syncthreads();
  if (own) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= nr) continue;
      float s = 0.f;
#pragma unroll
      for (int w_ = 0; w_ < SG_WARPS; ++w_) s += redf[(w_ * RT + r) * COLS + tid];
      epi(r0 + r, n, s);
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch (or graph replay)
}

template <int RT, bool SEGS, typename WT, class XLoad, class Epi>
cudaError_t launch_stream_gemv(XLoad xl, const WT* w, float* part, unsigned* counters, int R,
                               int K, int N, const ColSegs& segs, Epi epi, cudaStream_t stream) {
  const dim3 grid(segs.tile0[segs.n], segs.max_splits, (R + RT - 1) / RT);
  const size_t smem = (size_t)RT * sg_kpad(segs.max_kps) * sizeof(float);
  stream_gemv_kernel<RT, WT, XLoad, Epi, SEGS><<<grid, SG_THREADS, smem, stream>>>(
      xl, w, part, counters, R, K, N, segs.kps[0], segs, epi);
  return cudaGetLastError();
}

// The same, with the row tile rt (1, 2 or 4, from the plan) chosen at run time.
template <bool SEGS, typename WT, class XLoad, class Epi>
cudaError_t launch_stream_gemv_rt(int rt, XLoad xl, const WT* w, float* part, unsigned* counters,
                                  int R, int K, int N, const ColSegs& segs, Epi epi,
                                  cudaStream_t stream) {
  switch (rt) {
    case 1: return launch_stream_gemv<1, SEGS>(xl, w, part, counters, R, K, N, segs, epi, stream);
    case 2: return launch_stream_gemv<2, SEGS>(xl, w, part, counters, R, K, N, segs, epi, stream);
    case 4: return launch_stream_gemv<4, SEGS>(xl, w, part, counters, R, K, N, segs, epi, stream);
  }
  return cudaErrorInvalidValue;
}

// One segment: the whole (K, N) weight in `splits` slices of kps.
template <typename WT, class XLoad, class Epi>
cudaError_t launch_stream_gemv_rt(int rt, XLoad xl, const WT* w, float* part, unsigned* counters,
                                  int R, int K, int N, int splits, int kps, Epi epi,
                                  cudaStream_t stream) {
  return launch_stream_gemv_rt<false>(rt, xl, w, part, counters, R, K, N,
                                      one_seg(N, SG_CG * StreamW<WT>::VC, splits, kps), epi,
                                      stream);
}

// Kernel A's launch: several segments, or one as the plain launch.
template <typename WT, class XLoad, class Epi>
cudaError_t launch_stream_gemv_segs(int rt, XLoad xl, const WT* w, float* part,
                                    unsigned* counters, int R, int K, int N, const ColSegs& segs,
                                    Epi epi, cudaStream_t stream) {
  if (segs.n == 1)
    return launch_stream_gemv_rt<false>(rt, xl, w, part, counters, R, K, N, segs, epi, stream);
  return launch_stream_gemv_rt<true>(rt, xl, w, part, counters, R, K, N, segs, epi, stream);
}

// Whether a (K, N) weight of the plan can be streamed: N a multiple of 16
// (every 16-byte vector whole) and kps a multiple of 16 in [16, 512] that
// cuts K into splits slices.
static inline bool stream_plan_ok(int rows, int K, int N, int rt, int splits, int kps) {
  return rows >= 1 && N % 16 == 0 && kps % 16 == 0 && kps >= 16 && kps <= 512 &&
         splits == (K + kps - 1) / kps && (rt == 1 || rt == 2 || rt == 4);
}

// The same for segments given as (first column tile, splits, kps) triples
// over int8 columns (128 a tile); fills `segs`.
static inline bool stream_segs_ok(ColSegs* segs, const int* trip, int rows, int K, int N,
                                  int rt) {
  return rows >= 1 && N % 16 == 0 && (rt == 1 || rt == 2 || rt == 4) &&
         col_segs(segs, trip, rows, K, N, SG_CG * StreamW<int8_t>::VC, 16, 512);
}

}  // namespace vv
