// Kernel B at decode: causal GQA attention of a W-row query chunk over the
// persistent KV cache, built for bandwidth (flash-decoding in one launch:
// each block folds one key range, the last block of each row tile merges).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/flash_attention.py:71
// flash_cached_attention (body `_kernel_zeroed`, :154) at W = 1 for every
// (q, KV) dtype pair (bf16/bf16, bf16/int8, f32/f32, f32/int8) and for f32 q
// at W > 1; bf16 chunks (W > 1) take flash_prefill.cu. Semantics kept: query
// row i of sample b attends keys j <= base[b] + i (clamped to the cache),
// only the live prefix is read, the softmax is online in f32, and for int8
// rows the per-row K scale multiplies the scores and the V scale the
// probabilities (flash_attention.py:235, :243).
//
// What bounds it on an H100: bytes. At decode the G = 6 query heads of a KV
// head do about 6 operations per byte of K/V read, far below the card's
// ~295, so the design is about streaming the live prefix at HBM's rate with
// as few instructions per key as possible:
//   - one block per (sample, KV head, tile of folded rows w * G + g, key
//     split): the KV head's query heads share every K/V byte read;
//   - K/V tiles of 64 keys stream through a ring of 16-byte cp.async copies,
//     3 stages (5 for the half-size int8 tiles, which land as int8 with
//     their row scales); the Q tile's copy is issued before base is read;
//   - the last split's merge loads 8 splits' partial rows at a time, so the
//     merge waits on few round trips to L2;
//   - bf16 q (the serving path; D 64 or 128), flash_decode_mma_kernel: a
//     tile of 16 rows (6 live for the 1.5B) in registers as mma fragments;
//     each of 4 warps takes 16 keys of every K/V tile, so S = Q K^T and
//     O += P V are 2 x D / 16 bf16 mma.sync m16n8k16 each per warp and tile
//     (P rounded to bf16 from registers, V through ldmatrix.trans); int8
//     K/V are converted exactly to bf16 by the warp that reads them. Each
//     warp keeps its own online-softmax state; the warps merge once, at the
//     end. Padding 6 rows to 16 costs nothing the card lacks: the tensor
//     cores take the products off the instruction stream, which is what
//     limits a CUDA-core decode;
//   - f32 q (the tiny config and tests; D 16-128), flash_decode_f32_kernel:
//     a tile of up to 8 rows in registers, each dot product split over
//     D / 8 lanes and summed by shuffles, 8 warps of 8 keys a tile;
//   - the split count comes from the shapes alone (ops/flash_attention.py
//     `_decode_plan`), and each split's key tiles are its share of the row
//     tile's own horizon min(base + 1 + last w, S), read from base on the
//     card (`_decode_split`): nothing is synchronised with the host and a
//     CUDA graph may replay the launch with other bases. Splits past the
//     live tiles exit at once;
//   - one launch: each split writes its (m, l, acc) to a workspace, and the
//     last split of a row tile to arrive (an atomic counter per row tile,
//     which that block resets to 0) merges the live splits and writes the
//     output. A single live split writes the output directly.
#include "mma.cuh"

namespace vv {
namespace {

constexpr int DC_TK = 64;  // keys per K/V tile
constexpr int DC_STAGES = 3;
constexpr int DC_MAX_SPLITS = 132;   // ops/flash_attention.py DECODE_MAX_SPLITS
constexpr float DC_M_INIT = -1e30f;  // m of a state that has seen no live key
constexpr float DC_LOG2E = 1.4426950408889634f;

// The smem the merge needs after the K/V ring: NW warps' (acc, m, l) for MR
// rows, the cross-split weights and the arrival flag.
template <int D, int NW, int MR>
constexpr int merge_bytes() {
  return NW * MR * (D + 2) * 4 + MR * DC_MAX_SPLITS * 4 + 16;
}

// The block's row tile (decode_tile) and key split (decode_keys, from base):
// which key tiles [jb, je) it folds, of ns live splits.
struct DecodeSplit {
  int b, kh, G, R, row0, nr, bl, ns, jb, je;
  size_t plane;  // first cache row of (b, kh)
};

__device__ __forceinline__ DecodeSplit decode_tile(int W, int NH, int KH, int S, int rows) {
  DecodeSplit t;
  const int bh = blockIdx.z;
  t.b = bh / KH;
  t.kh = bh % KH;
  t.G = NH / KH;
  t.R = W * t.G;
  t.row0 = blockIdx.x * rows;
  t.nr = min(rows, t.R - t.row0);
  t.plane = (size_t)bh * S;
  return t;
}

__device__ __forceinline__ void decode_keys(DecodeSplit& t, const int* base, int S) {
  t.bl = base[t.b];
  const int total = min(t.bl + (t.row0 + t.nr - 1) / t.G + 1, S);  // keys [0, total) live
  const int ntiles = (total + DC_TK - 1) / DC_TK;
  t.ns = min((int)gridDim.y, ntiles);
  const int sp = blockIdx.y;
  t.jb = sp < t.ns ? sp * ntiles / t.ns : 0;
  t.je = sp < t.ns ? (sp + 1) * ntiles / t.ns : 0;
}

// Merge the NW warps' states in red ([NW][MR][D + 2]: acc, m, l; m in log2
// units) into this split's, then either write the output (one live split)
// or publish the split's state (acc [MR][D], then m [MR] and l [MR]) and, in
// the last split to arrive, merge the live splits and write the output.
template <typename QT, int D, int NW, int MR>
__device__ __forceinline__ void finish(float* red, const DecodeSplit& t, QT* __restrict__ out,
                                       float* __restrict__ part, unsigned* __restrict__ counters,
                                       int W, int NH) {
  constexpr int PW = D + 2, C4 = D / 4, BATCH = 8;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  float* wgt = red + NW * MR * PW;  // [MR][DC_MAX_SPLITS]
  unsigned* flag = reinterpret_cast<unsigned*>(wgt + MR * DC_MAX_SPLITS);
  const int tile = blockIdx.z * gridDim.x + blockIdx.x, n_splits = gridDim.y;
  const size_t pstride = (size_t)MR * PW;  // a multiple of 4 floats: acc rows stay 16-byte aligned
  float* mine = part + ((size_t)tile * n_splits + blockIdx.y) * pstride;
  auto dst = [&](int r) {
    const int gr = t.row0 + r;
    return out + ((size_t)(t.b * W + gr / t.G) * NH + t.kh * t.G + gr % t.G) * D;
  };
  for (int i = tid; i < t.nr * D; i += nt) {
    const int r = i / D, d = i % D;
    float M = DC_M_INIT;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, red[(w * MR + r) * PW + D]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* src = red + (w * MR + r) * PW;
      const float x = exp2f(src[D] - M);
      L += src[D + 1] * x;
      O += src[d] * x;
    }
    if (t.ns == 1) {  // key 0 is live for every row: L > 0
      dst(r)[d] = from_f<QT>(O / L);
    } else {
      mine[r * D + d] = O;
      if (d == 0) {
        mine[MR * D + r] = M;
        mine[MR * D + MR + r] = L;
      }
    }
  }
  if (t.ns == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + tile, 1u) == (unsigned)t.ns - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* parts = part + (size_t)tile * n_splits * pstride;
  for (int r = warp; r < t.nr; r += nt / 32) {  // a warp per row: max, weights, 1 / L
    float M = DC_M_INIT;
    for (int s = lane; s < t.ns; s += 32) M = fmaxf(M, __ldcg(parts + s * pstride + MR * D + r));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int s = lane; s < t.ns; s += 32) {
      const float x = exp2f(__ldcg(parts + s * pstride + MR * D + r) - M);
      wgt[r * DC_MAX_SPLITS + s] = x;
      L += __ldcg(parts + s * pstride + MR * D + MR + r) * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) red[r] = 1.f / L;  // the warps' states are consumed
  }
  __syncthreads();
  // a 4-float chunk of a row per thread, BATCH splits' loads in flight
  for (int i = tid; i < t.nr * C4; i += nt) {
    const int r = i / C4, c = (i % C4) * 4;
    const float* src = parts + r * D + c;
    const float* w = wgt + r * DC_MAX_SPLITS;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < t.ns; s0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        v[u] = s0 + u < t.ns ? __ldcg(reinterpret_cast<const float4*>(src + (s0 + u) * pstride))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float x = s0 + u < t.ns ? w[s0 + u] : 0.f;
        o[0] = fmaf(v[u].x, x, o[0]);
        o[1] = fmaf(v[u].y, x, o[1]);
        o[2] = fmaf(v[u].z, x, o[2]);
        o[3] = fmaf(v[u].w, x, o[3]);
      }
    }
    QT* y = dst(r) + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = from_f<QT>(o[e] * red[r]);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next launch (or graph replay)
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores
// ---------------------------------------------------------------------------

constexpr int MM_NW = 4, MM_THREADS = 32 * MM_NW, MM_MR = 16;

template <typename KVT, int D>
struct MmaSmem {
  static constexpr bool QUANT = sizeof(KVT) == 1;
  static constexpr int Q = MM_MR * D * 2;           // the bf16 Q tile
  static constexpr int TILE = DC_TK * D * (int)sizeof(KVT);  // one K or V tile as stored
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * DC_TK * 4 : 0);
  // bf16: 3 stages (two blocks of 100 KB fit on an SM at D 128); int8 tiles
  // are half the size, so 5 stages keep as many bytes in flight
  static constexpr int STAGES = QUANT ? 5 : 3;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int MERGE = merge_bytes<D, MM_NW, MM_MR>();
  static constexpr int BODY = RING > MERGE ? RING : MERGE;  // the ring, then the merge
  static constexpr int WTILE = 16 * D * 2;  // a warp's 16 keys of K or V as bf16 (int8 only)
  static constexpr int BYTES = Q + BODY + (QUANT ? MM_NW * 2 * WTILE : 0);
};

template <typename KVT, int D>
__global__ void __launch_bounds__(MM_THREADS)
    flash_decode_mma_kernel(const bf16* __restrict__ q, const KVT* __restrict__ kc,
                            const KVT* __restrict__ vc, const float* __restrict__ ksc,
                            const float* __restrict__ vsc, const int* __restrict__ base,
                            bf16* __restrict__ out, float* __restrict__ part,
                            unsigned* __restrict__ counters, int W, int NH, int KH, int S,
                            float scale_log2) {
  using SM = MmaSmem<KVT, D>;
  constexpr bool QUANT = SM::QUANT;
  constexpr int NCH = D / 8;  // 16-byte chunks of a bf16 row
  extern __shared__ __align__(128) uint8_t mm_smem[];
  uint8_t* body = mm_smem + SM::Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  DecodeSplit t = decode_tile(W, NH, KH, S, MM_MR);

  // the Q tile (rows past nr zero) goes first: it does not wait for base
  const uint32_t qs = smem_u32(mm_smem);
  for (int i = tid; i < MM_MR * NCH; i += MM_THREADS) {
    const int r = i / NCH, ch = i % NCH, gr = t.row0 + r;
    const bool ok = r < t.nr;
    const bf16* src = q;
    if (ok) src = q + ((size_t)(t.b * W + gr / t.G) * NH + t.kh * t.G + gr % t.G) * D + ch * 8;
    cp_async16(qs + tile_off<D>(r, ch), src, ok ? 16 : 0);
  }
  decode_keys(t, base, S);
  if (blockIdx.y >= t.ns) {  // past the live tiles: nothing to read or write
    cp_async_wait<0>();
    return;
  }

  auto load_tile = [&](int stage, int j) {
    const uint32_t kd = smem_u32(body + stage * SM::STAGE), vd = kd + SM::TILE;
    const int k0 = j * DC_TK;
    if constexpr (!QUANT) {
      for (int i = tid; i < DC_TK * NCH; i += MM_THREADS) {
        const int r = i / NCH, ch = i % NCH, key = k0 + r;
        const bool ok = key < S;
        const size_t off = (t.plane + (ok ? key : 0)) * D + ch * 8;
        cp_async16(kd + tile_off<D>(r, ch), kc + off, ok ? 16 : 0);
        cp_async16(vd + tile_off<D>(r, ch), vc + off, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < DC_TK * D / 16; i += MM_THREADS) {
        const int r = i / (D / 16), c = i % (D / 16), key = k0 + r;
        const bool ok = key < S;
        const size_t off = (t.plane + (ok ? key : 0)) * D + c * 16;
        cp_async16(kd + i * 16, kc + off, ok ? 16 : 0);
        cp_async16(vd + i * 16, vc + off, ok ? 16 : 0);
      }
      {  // 128 threads: the K then the V row scales
        const int r = tid % DC_TK, key = k0 + r;
        const bool ok = key < S;
        const float* src = (tid < DC_TK ? ksc : vsc) + t.plane + (ok ? key : 0);
        cp_async4(vd + SM::TILE + tid * 4, src, ok ? 4 : 0);
      }
    }
  };

  // the first K/V tiles, committed with Q in the first group
#pragma unroll
  for (int s = 0; s < SM::STAGES - 1; ++s) {
    if (t.jb + s < t.je) load_tile(s, t.jb + s);
    cp_async_commit();
  }
  cp_async_wait<SM::STAGES - 2>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + tile_off<D>(lane & 15, 2 * kk + (lane >> 4)));

  // rows a (g) and b (g + 8) of the fragments; rows past nr copy the last
  const int g = lane >> 2;
  const int lim_a = t.bl + (t.row0 + min(g, t.nr - 1)) / t.G;
  const int lim_b = t.bl + (t.row0 + min(g + 8, t.nr - 1)) / t.G;
  float m_a = DC_M_INIT, m_b = DC_M_INIT, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  uint8_t* cvt = body + SM::BODY + warp * 2 * SM::WTILE;  // this warp's bf16 K, V (int8)

  for (int j = t.jb; j < t.je; ++j) {
    cp_async_wait<SM::STAGES - 2>();  // tile j has landed
    __syncthreads();                  // for every thread; tile j - 1's stage is free
    if (j + SM::STAGES - 1 < t.je)
      load_tile((j - t.jb + SM::STAGES - 1) % SM::STAGES, j + SM::STAGES - 1);
    cp_async_commit();
    const uint8_t* st = body + ((j - t.jb) % SM::STAGES) * SM::STAGE;
    uint32_t kt_u, vt_u;
    int krow;  // this warp's first key row in the tile it reads
    const float* kss = reinterpret_cast<const float*>(st + 2 * SM::TILE) + warp * 16;
    if constexpr (QUANT) {  // this warp's 16 keys of K and V to bf16 (exact)
      __syncwarp();
      for (int i = lane; i < 2 * 16 * D / 16; i += 32) {
        const int kv = i / (D), rem = i % D, r = rem / (D / 16), c16 = rem % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(st + kv * SM::TILE + (warp * 16 + r) * D +
                                                        c16 * 16);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f[4];
          i8x4_to_f32(words[e], f);
          h[2 * e] = bf16x2_exact(f[0], f[1]);
          h[2 * e + 1] = bf16x2_exact(f[2], f[3]);
        }
        uint8_t* dst = cvt + kv * SM::WTILE;
        *reinterpret_cast<uint4*>(dst + tile_off<D>(r, 2 * c16)) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dst + tile_off<D>(r, 2 * c16 + 1)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncwarp();
      kt_u = smem_u32(cvt);
      vt_u = kt_u + SM::WTILE;
      krow = 0;
    } else {
      kt_u = smem_u32(st);
      vt_u = kt_u + SM::TILE;
      krow = warp * 16;
    }

    // S = Q K^T: 16 rows x this warp's 16 keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt_u + tile_off<D>(krow + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1)));
      mma_bf16_16816(sc[0], qf[kk], kb[0], kb[1]);
      mma_bf16_16816(sc[1], qf[kk], kb[2], kb[3]);
    }

    // scale (and K row scale), mask, online softmax in log2 units; rows a
    // and b are shared by 4 lanes
    const int k0 = j * DC_TK + warp * 16;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = n * 8 + 2 * (lane & 3) + (v & 1);
        float x = sc[n][v] * scale_log2;
        if (QUANT) x *= kss[c];
        if (k0 + c > (v < 2 ? lim_a : lim_b) || k0 + c >= S) x = -INFINITY;
        sc[n][v] = x;
      }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr_a;
      o[i][1] *= corr_a;
      o[i][2] *= corr_b;
      o[i][3] *= corr_b;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float p = exp2f(sc[n][v] - (v < 2 ? m_a : m_b));  // 0 for a dead key
        if (v < 2)
          l_a += p;
        else
          l_b += p;
        if (QUANT) p *= kss[DC_TK + n * 8 + 2 * (lane & 3) + (v & 1)];
        sc[n][v] = p;
      }

    // O += P V: P (bf16) from registers, V by ldmatrix.trans
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt_u + tile_off<D>(krow + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * dp + (lane >> 4)));
      mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the merge buffer

  float* red = reinterpret_cast<float*>(body);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float ms[2] = {m_a, m_b}, ls[2] = {l_a, l_b};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= t.nr) continue;
    float* dstw = red + (warp * MM_MR + r) * (D + 2);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dstw[8 * i + 2 * (lane & 3)] = o[i][2 * h];
      dstw[8 * i + 2 * (lane & 3) + 1] = o[i][2 * h + 1];
    }
    if ((lane & 3) == 0) {
      dstw[D] = ms[h];
      dstw[D + 1] = ls[h];
    }
  }
  __syncthreads();
  finish<bf16, D, MM_NW, MM_MR>(red, t, out, part, counters, W, NH);
}

// ---------------------------------------------------------------------------
// f32 q: CUDA cores
// ---------------------------------------------------------------------------

constexpr int CC_NW = 8, CC_THREADS = 32 * CC_NW, CC_MR = 8;
constexpr int CC_KW = DC_TK / CC_NW;  // keys of a tile per warp

template <typename KVT, int D>
struct CoreSmem {
  static constexpr int TILE = DC_TK * D * (int)sizeof(KVT);
  static constexpr int STAGE = 2 * TILE + (sizeof(KVT) == 1 ? 2 * DC_TK * 4 : 0);
  static constexpr int RING = DC_STAGES * STAGE;
  static constexpr int MERGE = merge_bytes<D, CC_NW, CC_MR>();
  static constexpr int BYTES = RING > MERGE ? RING : MERGE;
};

// VEC consecutive elements as floats from shared memory.
template <int VEC>
__device__ __forceinline__ void loadv(const int8_t* p, float* f) {
  if constexpr (VEC == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f32(u.x, f);
    i8x4_to_f32(u.y, f + 4);
  } else {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  }
}
template <int VEC>
__device__ __forceinline__ void loadv(const float* p, float* f) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) load4(p + e, f + e);
}

template <typename KVT, int D>
__global__ void __launch_bounds__(CC_THREADS)
    flash_decode_f32_kernel(const float* __restrict__ q, const KVT* __restrict__ kc,
                            const KVT* __restrict__ vc, const float* __restrict__ ksc,
                            const float* __restrict__ vsc, const int* __restrict__ base,
                            float* __restrict__ out, float* __restrict__ part,
                            unsigned* __restrict__ counters, int W, int NH, int KH, int S,
                            float scale_log2) {
  using SM = CoreSmem<KVT, D>;
  constexpr bool QUANT = sizeof(KVT) == 1;
  constexpr int VEC = D / 4 < 8 ? D / 4 : 8;  // elements of a row per lane
  constexpr int LG = D / VEC;                 // lanes per key
  constexpr int KPW = 32 / LG;                // keys per warp per pass
  static_assert(KPW <= CC_KW && CC_KW % KPW == 0, "a tile's keys must split over the warps");
  extern __shared__ __align__(16) uint8_t cc_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / LG, d0 = (lane % LG) * VEC;
  DecodeSplit t = decode_tile(W, NH, KH, S, CC_MR);
  decode_keys(t, base, S);
  if (blockIdx.y >= t.ns) return;  // past the live tiles: nothing to read or write

  auto load_tile = [&](int stage, int j) {
    constexpr int CH = D * (int)sizeof(KVT) / 16;  // 16-byte chunks of a row
    const uint32_t kd = smem_u32(cc_smem + stage * SM::STAGE), vd = kd + SM::TILE;
    const int k0 = j * DC_TK;
    for (int i = tid; i < DC_TK * CH; i += CC_THREADS) {
      const int r = i / CH, c = i % CH, key = k0 + r;
      const bool ok = key < S;
      const size_t off = (t.plane + (ok ? key : 0)) * D + c * (16 / sizeof(KVT));
      cp_async16(kd + i * 16, kc + off, ok ? 16 : 0);
      cp_async16(vd + i * 16, vc + off, ok ? 16 : 0);
    }
    if constexpr (QUANT) {
      if (tid < 2 * DC_TK) {
        const int r = tid % DC_TK, key = k0 + r;
        const bool ok = key < S;
        const float* src = (tid < DC_TK ? ksc : vsc) + t.plane + (ok ? key : 0);
        cp_async4(vd + SM::TILE + tid * 4, src, ok ? 4 : 0);
      }
    }
  };

  // q in registers, pre-scaled into log2 units; row r's last live key
  float qv[CC_MR][VEC];
  int lim[CC_MR];
#pragma unroll
  for (int r = 0; r < CC_MR; ++r) {
    const int gr = t.row0 + min(r, t.nr - 1);
    const float* src = q + ((size_t)(t.b * W + gr / t.G) * NH + t.kh * t.G + gr % t.G) * D + d0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[r][e] = src[e] * scale_log2;
    lim[r] = t.bl + gr / t.G;
  }
#pragma unroll
  for (int s = 0; s < DC_STAGES - 1; ++s) {
    if (t.jb + s < t.je) load_tile(s, t.jb + s);
    cp_async_commit();
  }

  float m[CC_MR], l[CC_MR], acc[CC_MR][VEC];
#pragma unroll
  for (int r = 0; r < CC_MR; ++r) {
    m[r] = DC_M_INIT;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  for (int j = t.jb; j < t.je; ++j) {
    cp_async_wait<DC_STAGES - 2>();  // tile j has landed
    __syncthreads();                 // for every thread; tile j - 1's stage is free
    if (j + DC_STAGES - 1 < t.je)
      load_tile((j - t.jb + DC_STAGES - 1) % DC_STAGES, j + DC_STAGES - 1);
    cp_async_commit();
    const uint8_t* st = cc_smem + ((j - t.jb) % DC_STAGES) * SM::STAGE;
    const KVT* kt = reinterpret_cast<const KVT*>(st);
    const KVT* vt = reinterpret_cast<const KVT*>(st + SM::TILE);
    const float* kss = reinterpret_cast<const float*>(st + 2 * SM::TILE);
#pragma unroll
    for (int p = 0; p < CC_KW / KPW; ++p) {
      const int kk = warp * CC_KW + p * KPW + kg, key = j * DC_TK + kk;
      float kf[VEC], vf[VEC];
      loadv<VEC>(kt + kk * D + d0, kf);
      loadv<VEC>(vt + kk * D + d0, vf);
      const float ks = QUANT ? kss[kk] : 1.f, vs = QUANT ? kss[DC_TK + kk] : 1.f;
#pragma unroll
      for (int r = 0; r < CC_MR; ++r) {
        if (r >= t.nr) continue;  // uniform: the tile's row count
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qv[r][e], kf[e], s);
#pragma unroll
        for (int off = LG / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s = (key <= lim[r] && key < S) ? s * ks : -INFINITY;
        float mx = s;
#pragma unroll
        for (int off = LG; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (mx > m[r]) {  // uniform across the warp: every lane holds the same sums
          const float corr = exp2f(m[r] - mx);
          m[r] = mx;
          l[r] *= corr;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
        }
        const float pr = exp2f(s - m[r]);  // 0 for a dead key
        l[r] += pr;
        const float pv = pr * vs;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the merge buffer

  // each warp's state, summed over its key groups, into red[warp][r]
  float* red = reinterpret_cast<float*>(cc_smem);
#pragma unroll
  for (int r = 0; r < CC_MR; ++r) {
    if (r >= t.nr) continue;
#pragma unroll
    for (int off = LG; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
    float* dstw = red + (warp * CC_MR + r) * (D + 2);
    if (kg == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dstw[d0 + e] = acc[r][e];
    }
    if (lane == 0) {
      dstw[D] = m[r];
      dstw[D + 1] = l[r];
    }
  }
  __syncthreads();
  finish<float, D, CC_NW, CC_MR>(red, t, out, part, counters, W, NH);
}

template <typename QT, typename KVT, int D>
cudaError_t run_decode(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const int* base, void* out, float* part,
                       unsigned* counters, int B, int W, int NH, int KH, int S, int n_splits,
                       float scale, cudaStream_t stream) {
  constexpr bool MMA = sizeof(QT) == 2;
  const int rows = MMA ? MM_MR : CC_MR, threads = MMA ? MM_THREADS : CC_THREADS;
  const int bytes = MMA ? MmaSmem<KVT, D>::BYTES : CoreSmem<KVT, D>::BYTES;
  void (*kernel)(const QT*, const KVT*, const KVT*, const float*, const float*, const int*, QT*,
                 float*, unsigned*, int, int, int, int, float);
  if constexpr (MMA)
    kernel = flash_decode_mma_kernel<KVT, D>;
  else
    kernel = flash_decode_f32_kernel<KVT, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int R = W * (NH / KH);
  const dim3 grid((R + rows - 1) / rows, n_splits, B * KH);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), base, static_cast<QT*>(out),
      part, counters, W, NH, KH, S, scale * DC_LOG2E);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vv

// q (B, W, NH, D) f32 (D 16, 32, 64 or 128) or bf16 (D 64 or 128); K/V (B,
// KH, S, D) of q's dtype, or int8 with row scales (B, KH, 1, S) f32; base
// (B,) int32; out like q. part holds B*KH*row_tiles*n_splits*rows*(D + 2)
// floats (rows = 16 for bf16 q, 8 for f32; row_tiles = ceil(W * NH / KH /
// rows)); counters B*KH*row_tiles zeros, left zero again.
extern "C" int vv_flash_decode(const void* q, int q_dtype, const void* k, const void* v,
                               int kv_dtype, const void* k_scale, const void* v_scale,
                               const void* base, void* out, void* part, void* counters, int B,
                               int W, int NH, int KH, int S, int D, int n_splits, float scale,
                               void* stream) {
  using namespace vv;
  if (NH % KH != 0 || n_splits < 1 || n_splits > DC_MAX_SPLITS || W < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bp = static_cast<const int*>(base);
  float* pp = static_cast<float*>(part);
  unsigned* cp = static_cast<unsigned*>(counters);
#define VV_DC(QT_, KVT_, D_)                                                                 \
  if (D == D_)                                                                               \
  return (int)run_decode<QT_, KVT_, D_>(q, k, v, k_scale, v_scale, bp, out, pp, cp, B, W, NH, \
                                        KH, S, n_splits, scale, s)
  if (q_dtype == VV_BF16 && kv_dtype == VV_BF16) {
    VV_DC(bf16, bf16, 64);
    VV_DC(bf16, bf16, 128);
  }
  if (q_dtype == VV_BF16 && kv_dtype == VV_I8) {
    VV_DC(bf16, int8_t, 64);
    VV_DC(bf16, int8_t, 128);
  }
  if (q_dtype == VV_F32 && kv_dtype == VV_F32) {
    VV_DC(float, float, 16);
    VV_DC(float, float, 32);
    VV_DC(float, float, 64);
    VV_DC(float, float, 128);
  }
  if (q_dtype == VV_F32 && kv_dtype == VV_I8) {
    VV_DC(float, int8_t, 16);
    VV_DC(float, int8_t, 32);
    VV_DC(float, int8_t, 64);
    VV_DC(float, int8_t, 128);
  }
#undef VV_DC
  return (int)cudaErrorInvalidValue;
}
