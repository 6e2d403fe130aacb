// Split-K tensor-core core: a few to a few hundred rows of x against an int8
// weight matrix that is read from HBM once, on the tensor cores. Kernel A's
// middle rows (int8_gemm_splitk.cu) and the int8 layer passes of kernels C
// (head_ffn_tc.cu) and D (vocoder_stage_tc.cu) from their row thresholds up
// run on it; at fewer rows they run on the weight-streaming core
// (weight_stream.cuh).
//
//   out[r, n] = epi(r, n, sum_k x(r, k) * w8[k, n])
//
// What bounds it on an H100: the weight's bytes up to ~150 rows (a call does
// 2 x rows operations a weight byte, the card 295 bf16 operations a byte of
// HBM), the tensor cores' operations beyond. So the core streams the int8
// weight once at HBM's rate and keeps everything else off that stream:
//   - the transposed product out^T = w8^T x^T, as in int8_gemm.cu: the int8
//     weight is wgmma's register A operand (ldmatrix.trans and an exact
//     convert in registers, mma.cuh load_w8_frag: no dequantized weight
//     exists anywhere); the call's rows are wgmma's N, a row tile BM sized
//     to the call (a multiple of 8 up to 256, a template parameter), so at 8
//     rows the tensor cores do 8 rows' work and not 256;
//   - wherever the rows fit one row tile the weight is read once a call;
//   - K is split until the grid fills one wave of the SMs (at BM <= 128 two
//     blocks an SM), each split a whole number of 64-k steps, as long as a
//     split's partial tile costs no more to add than its K slice costs to
//     read (ops/quant.py _sk_plan, _sk_fused_plan). Two warpgroups of 64
//     columns each convert and issue the wgmmas, and thread 0 streams the
//     block's K slice with TMA through a ring of stages (mbarriers),
//     refilling a stage as soon as both warpgroups' wgmmas on it are done;
//     row tiles up to 64 keep two wgmma groups in flight behind the one
//     issued (there a step's latency, not the bytes, paces a block). No
//     producer warp: a ninth warp would put three warps on one of the SM's
//     four register quadrants and cap a thread at 168 registers (96 at two
//     blocks an SM), which serialized the 80- to 256-row tiles' wgmma chains
//     (ptxas C7512); with eight warps a thread may take 255 (128 at two
//     blocks);
//   - the splits meet inside the launch in a fixed order, as in
//     weight_stream.cuh: each split writes its f32 partial tile to the
//     workspace, the last block of its (row tile, column tile) to arrive adds
//     the splits in order 0..S-1 (its own from memory too), runs the
//     epilogue, and resets the tile's counter. No float atomics: the same
//     inputs give the same bits, and a CUDA graph replays right. The
//     workspace and counters are the streaming core's (ops/quant.py
//     _gemv_workspace).
// Two x sources (a template parameter):
//   - by TMA (kernel A, int8_gemm_splitk.cu XTma): x is a bf16 matrix in
//     device memory, a (BM, 64) tile of it rides in each stage beside the
//     weight's; the epilogue scales and stores (EpiScaleOut), straight from
//     the accumulators where K is not split;
//   - formed by the block (kernels C and D, XLoaded): the caller's loader
//     (the x functors of their streaming route, head_ffn.cuh and
//     vocoder_stage.cuh: XHeadMod with its RMSNorm and modulation, XSwiGLU,
//     XRow) gives x(r, k) as f32, and the block writes its whole K slice
//     into shared memory as bf16 in the layout TMA would (128-byte swizzled
//     rows) while the first weight tiles fly; a ring of SK_LOADED_STAGES
//     then carries the weight alone. These launches are programmatic
//     dependents (common.cuh launch_dependent): a block issues its first
//     weight tiles, then waits for the kernel before it on the stream (the
//     producer of x) to finish. Tensor cores take bf16, so an f32 value
//     v goes in as TERMS bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo =
//     bf16(v - hi - mid), stacked as TERMS row blocks of the N axis (8 rows
//     become 24; the weight is still read once). int8 weights are exact in
//     bf16 and a bf16 x int8 product is exact in f32, so the sum is an f32
//     sum taken in another order (TERMS = 3 for f32 activations; bf16 ones
//     are exact in one term). The last block of a tile adds, for each row,
//     each term's splits in order, then hi + (mid + lo), and hands the sum
//     to the caller's epilogue (the gated residual, bias, exact GELU, layer
//     scales, residuals), with the partials of up to 12 / TERMS splits in
//     flight at once (an L2 round trip each, not one a split). With TERMS >
//     1 the call's rows fit one row tile.
#pragma once

#include "mma.cuh"
#include "tma.cuh"

namespace vv {

constexpr int SK_BN = 128;              // output columns a block (two consumer warpgroups x 64)
constexpr int SK_BK = 64;               // k a step: one 128-byte swizzled row of bf16 x
constexpr int SK_THREADS = 256;         // two warpgroups; thread 0 also streams the tiles
constexpr int SK_W_BYTES = SK_BK * SK_BN;  // one int8 w8 tile, 128-byte swizzled rows
constexpr int SK_SMEM_SM = 233472;      // shared memory of an SM
constexpr int SK_SMEM_BLOCK = 232448;   // the most one block may take
constexpr int SK_LOADED_STAGES = 4;     // weight tiles in flight where the block forms x

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
  // the dynamic shared memory a block that forms x may take (its static
  // row sums take 1 KB more); ops/quant.py _sk_x_room plans with it
  static constexpr int LOADED_ROOM =
      (BLOCKS == 2 ? SK_SMEM_SM / 2 - 1024 : SK_SMEM_BLOCK) - 2048;
  // wgmma groups a warpgroup keeps in flight behind the one it issues: at
  // small row tiles a step's group is short and its latency, not the
  // weight's bytes, sets the pace, so two (a third A-fragment buffer);
  // larger tiles keep one (their registers are the accumulators')
  static constexpr int PEND = BM <= 64 ? 2 : 1;
};

// Dynamic shared memory of a block that forms its x slice of kps k: the
// slice, the weight ring, its barriers, alignment.
template <int BM>
__host__ __device__ constexpr int sk_loaded_smem(int kps) {
  return kps / SK_BK * SkTile<BM>::X_BYTES + SK_LOADED_STAGES * (SK_W_BYTES + 16) + 1024;
}

// x formed by the block: the loader over the call's R rows, TERMS bf16
// terms a value. The loader gives x(r, k0 .. k0 + 7) (load8, 16-byte vector
// loads; with kRowSum its row's sum of squares, from sq8 over row_len, the
// RMSNorm of weight_stream.cuh's loaders).
template <class XLoad, int TERMS_>
struct XLoaded {
  static constexpr bool kTma = false;
  static constexpr int TERMS = TERMS_;
  XLoad xl;
  int R;
};

__device__ __forceinline__ void sk_st16(uint8_t* p, uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// The block's x slice, nkt 64-k steps from kb, as [step][BM rows][64 k] bf16
// with 128-byte swizzled rows (chunk c of row r at chunk c ^ (r % 8)): row
// t * nr + i holds term t of the call's row rb + i; the rest of the tile and
// k >= K are zeros. Ends with the writes visible to wgmma.
template <int BM, class XLoad, int TERMS>
__device__ __forceinline__ void sk_form_x(const XLoaded<XLoad, TERMS>& xs, uint8_t* xsm, int m0,
                                          int kb, int nkt, int K) {
  __shared__ float rsum[BM];
  const XLoad& xl = xs.xl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = TERMS == 1 ? m0 : 0;                    // the call's first row in the tile
  const int nr = TERMS == 1 ? min(BM, xs.R - m0) : xs.R;  // and how many
  if constexpr (XLoad::kRowSum) {
    // warp w sums rows w, w + 8, ...: lane l the 8-element chunks l, l + 32,
    // ... in order (each chunk's squares in order; 4 chunks in flight), then
    // an xor-shuffle tree (a fixed order)
    constexpr int U = 4;
    for (int r = warp; r < nr; r += SK_THREADS / 32) {
      float s = 0.f;
      for (int i0 = 8 * lane; i0 < xl.row_len; i0 += 256 * U) {
        float t[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i = i0 + 256 * j;
          t[j] = i < xl.row_len ? xl.sq8(rb + r, i) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < U; ++j) s += t[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) rsum[r] = s;
    }
    __syncthreads();
  }
  // (row, step, 8-k chunk): consecutive threads take consecutive k of a row
  for (int it = tid; it < nr * nkt * 8; it += SK_THREADS) {
    const int ch = it & 7, q = it >> 3, st = q % nkt, r = q / nkt;
    const int k0 = kb + st * SK_BK + ch * 8;
    float v[8];
    if (k0 < K) {  // K % 8 == 0: all eight or none
      xl.load8(rb + r, k0, XLoad::kRowSum ? rsum[r] : 0.f, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    uint8_t* tile = xsm + (size_t)st * SkTile<BM>::X_BYTES;
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      uint32_t u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = round_bf16(v[2 * j]), b = round_bf16(v[2 * j + 1]);
        u[j] = pack_bf16(a, b);  // exact: a and b are bf16 values
        v[2 * j] -= a;           // exact: the rounding error of a
        v[2 * j + 1] -= b;
      }
      const int lr = t * nr + r;
      sk_st16(tile + lr * 128 + ((ch ^ (lr & 7)) << 4), u[0], u[1], u[2], u[3]);
    }
  }
  const int used = TERMS * nr;
  for (int it = tid; it < (BM - used) * nkt * 8; it += SK_THREADS) {
    const int ch = it & 7, q = it >> 3, st = q % nkt, lr = used + q / nkt;
    sk_st16(xsm + (size_t)st * SkTile<BM>::X_BYTES + lr * 128 + ((ch ^ (lr & 7)) << 4), 0u, 0u,
            0u, 0u);
  }
  fence_proxy_async();  // wgmma reads shared memory through the asynchronous proxy
  __syncthreads();
}

// grid (row tiles, column tiles, the segments' most splits). w8 (K, N) int8
// by a tensor map; x by XS (XTma: a map of the bf16 (M, K) x; XLoaded: the
// loader, M = TERMS x R). Partials and counters as ColSegs and the caller
// lay them out; with XTma they are read only where a segment splits, with
// XLoaded always (one segment: (split, M, N)). The epilogue: with XTma,
// epi.scale / epi.out / epi.out_f32 (scale and store); with XLoaded,
// epi(row, n, sum) for the call's rows.
template <int BM, class XS, class Epi>
__global__ void __launch_bounds__(SK_THREADS, SkTile<BM>::BLOCKS)
    int8_gemm_sk_kernel(const __grid_constant__ XS xsrc,
                        const __grid_constant__ CUtensorMap wmap, const Epi epi,
                        float* __restrict__ part, unsigned* __restrict__ counters, int M, int K,
                        int N, const ColSegs segs) {
  using T = SkTile<BM>;
  constexpr bool TMA_X = XS::kTma;
  constexpr int ST = TMA_X ? T::STAGES : SK_LOADED_STAGES;
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
  // the x ring (TMA) or the block's x slice, then the weight ring, barriers
  const uint32_t xs = smem_u32(smem);
  const uint32_t ws = xs + (TMA_X ? ST : steps) * T::X_BYTES;
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
    if constexpr (TMA_X) {
      mbar_arrive_expect_tx(full + 8 * s, T::STAGE);
      tma_load_2d(xs + s * T::X_BYTES, &xsrc.map, k, m0, full + 8 * s);
    } else {
      mbar_arrive_expect_tx(full + 8 * s, SK_W_BYTES);
    }
    tma_load_2d(ws + s * SK_W_BYTES, &wmap, n0, k, full + 8 * s);
  };
  if (tid == 0) {
    if constexpr (TMA_X) tma_prefetch_desc(&xsrc.map);
    tma_prefetch_desc(&wmap);
    for (int i = 0; i < min(ST, nkt); ++i) load(i);
  }
  if constexpr (!TMA_X) {
    // launched as a programmatic dependent (launch_sk_loaded): the weight
    // tiles above fly while the kernel before finishes; x, the partials and
    // the outputs wait for it. The next pass may then start its own.
    grid_dep_wait();
    grid_dep_launch();
    sk_form_x<BM>(xsrc, smem, m0, kt0 * SK_BK, nkt, K);
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
    const uint32_t b = xs + (TMA_X ? s : i) * T::X_BYTES;
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
  if constexpr (TMA_X) {
    if (c < N) {  // N % 16 == 0: c + 1 < N as well
      if (splits == 1) {
        const float s0 = epi.scale[c], s1 = epi.scale[c + 1];
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const int r = m0 + 8 * j + 2 * (lane & 3);
          if (r < M)
            epi.store(r, c, acc[4 * j] * s0, acc[4 * j + 2] * s1, N);
          if (r + 1 < M)
            epi.store(r + 1, c, acc[4 * j + 1] * s0, acc[4 * j + 3] * s1, N);
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
  } else if (c < N) {  // every split's raw partial tile: (split, row, column)
    float* p = part + (size_t)split * M * N + c;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int r = m0 + 8 * j + 2 * (lane & 3);
      if (r < M) store2(p + (size_t)r * N, acc[4 * j], acc[4 * j + 2]);
      if (r + 1 < M) store2(p + (size_t)(r + 1) * N, acc[4 * j + 1], acc[4 * j + 3]);
    }
  }

  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  if constexpr (TMA_X) {
    // the last split to arrive adds all partials in split order, four
    // columns a thread
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
      epi.store(r, c, s.x * epi.scale[c], s.y * epi.scale[c + 1], N);
      epi.store(r, c + 2, s.z * epi.scale[c + 2], s.w * epi.scale[c + 3], N);
    }
  } else {
    // the last split to arrive adds, for each of the call's rows in the
    // tile and four columns a thread, each term's splits in order, then the
    // terms (hi + (mid + lo)), and runs the epilogue
    constexpr int TERMS = XS::TERMS;
    constexpr int CH = 12 / TERMS;  // splits whose partials are in flight at once
    const int rb = TERMS == 1 ? m0 : 0, nr = TERMS == 1 ? min(BM, xsrc.R - m0) : xsrc.R;
    const size_t plane = (size_t)M * N;
    for (int e = tid; e < nr * (SK_BN / 4); e += SK_THREADS) {
      const int r = e / (SK_BN / 4), c = n0 + 4 * (e % (SK_BN / 4));
      if (c >= N) continue;
      float4 s[TERMS];
#pragma unroll
      for (int t = 0; t < TERMS; ++t) s[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp0 = 0; sp0 < splits; sp0 += CH) {
        float4 v[TERMS][CH];
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (sp0 + j < splits)
              v[t][j] = __ldcg(reinterpret_cast<const float4*>(
                  part + (sp0 + j) * plane + (size_t)(m0 + t * nr + r) * N + c));
#pragma unroll
        for (int t = 0; t < TERMS; ++t)
#pragma unroll
          for (int j = 0; j < CH; ++j)
            if (sp0 + j < splits) {
              s[t].x += v[t][j].x;
              s[t].y += v[t][j].y;
              s[t].z += v[t][j].z;
              s[t].w += v[t][j].w;
            }
      }
      if constexpr (TERMS > 1) {
        s[0].x += s[1].x + s[2].x;
        s[0].y += s[1].y + s[2].y;
        s[0].z += s[1].z + s[2].z;
        s[0].w += s[1].w + s[2].w;
      }
      epi(rb + r, c, s[0].x);
      epi(rb + r, c + 1, s[0].y);
      epi(rb + r, c + 2, s[0].z);
      epi(rb + r, c + 3, s[0].w);
    }
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch (or graph replay)
}

// One launch over a block-formed x: R rows of xl against w8 (K, N), K in
// splits slices of kps, M = TERMS x R rows on the N axis in row tiles of BM.
template <int BM, int TERMS, class XLoad, class Epi>
cudaError_t launch_sk_loaded(const XLoad& xl, int R, const int8_t* w8, const Epi& epi,
                             float* part, unsigned* counters, int K, int N, int splits, int kps,
                             cudaStream_t stream) {
  using T = SkTile<BM>;
  using XS = XLoaded<XLoad, TERMS>;
  const int M = TERMS * R;
  const int smem = sk_loaded_smem<BM>(kps);
  if (R <= 0 || (TERMS > 1 && M > BM) || N % 16 || K % 8 || kps % SK_BK || kps <= 0 ||
      splits != (K + kps - 1) / kps || smem > T::LOADED_ROOM)
    return cudaErrorInvalidValue;
  CUtensorMap wmap;
  if (!make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, (size_t)N, SK_BN, SK_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_sk_kernel<BM, XS, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::LOADED_ROOM);
  if (err != cudaSuccess) return err;
  const ColSegs segs = one_seg(N, SK_BN, splits, kps);
  const dim3 grid((M + BM - 1) / BM, (N + SK_BN - 1) / SK_BN, splits);
  return launch_dependent(int8_gemm_sk_kernel<BM, XS, Epi>, grid, dim3(SK_THREADS), smem, stream,
                          XS{xl, R}, wmap, epi, part, counters, M, K, N, segs);
}

// The same with the row tile bm (from the plan) chosen at run time: one
// term (bf16 activations, M = R <= 85) takes the tiles 8 to 96, three (f32)
// the tiles 8 to 256 (ops/quant.py SK_FUSED_TILES).
template <int TERMS, class XLoad, class Epi>
cudaError_t launch_sk_loaded_bm(int bm, const XLoad& xl, int R, const int8_t* w8, const Epi& epi,
                                float* part, unsigned* counters, int K, int N, int splits,
                                int kps, cudaStream_t stream) {
#define VV_SKL(BM_)                                                                        \
  case BM_:                                                                                \
    return launch_sk_loaded<BM_, TERMS>(xl, R, w8, epi, part, counters, K, N, splits, kps, \
                                        stream)
  if constexpr (TERMS == 1) {
    switch (bm) {
      VV_SKL(8);
      VV_SKL(16);
      VV_SKL(24);
      VV_SKL(32);
      VV_SKL(48);
      VV_SKL(64);
      VV_SKL(96);
    }
  } else {
    switch (bm) {
      VV_SKL(8);
      VV_SKL(16);
      VV_SKL(24);
      VV_SKL(32);
      VV_SKL(48);
      VV_SKL(64);
      VV_SKL(96);
      VV_SKL(128);
      VV_SKL(192);
      VV_SKL(256);
    }
  }
#undef VV_SKL
  return cudaErrorInvalidValue;
}

}  // namespace vv
