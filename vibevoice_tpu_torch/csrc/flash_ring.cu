// Kernel F: one hop of ring attention. Folds a visiting K/V block into the
// online-softmax state (m, l, acc) that the caller carries across hops.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/flash_attention.py:311
// flash_ring_block (body `_ring_kernel`, :412), which the sequence-parallel
// prefill runs once per hop and layer (parallel/ring_attention.py:183).
// Semantics kept: query row i of the local shard sits at absolute slot
// q_start + i and attends key j of the block iff k_start + j <= q_start + i
// and k_start + j < k_len[b]; GQA is folded, row r = w * G + g of a KV head
// being query head kh * G + g of position w; the state is f32 and is updated
// in place (the TPU kernel's input_output_aliases, :396). Dropped: the
// 128-lane m/l planes, the q-tile row padding and the K-block pickers, which
// exist for VMEM; ragged edges are masked here.
//
// What bounds it on an H100: one hop of a 16,384-token shard of the 1.5B
// model (B 2, 12 query heads over 2 KV heads, D 128) is about 1.6 TFLOP of
// causal products against 34 MB of K/V and 0.4 GB of state, so it is bound by
// arithmetic, not by memory. Both kernels keep arithmetic to what the masks
// leave: a block owns a tile of folded query rows of one KV head, so one K/V
// tile in shared memory serves all G query heads of its positions (no K/V
// repeat); it reads keys only up to its tile's causal and length horizon; a
// tile wholly before the block (every hop whose k_start lies past its last
// row) returns without reading or writing anything, which is the TPU
// kernel's nblocks = 0 (:432-435).
//
// bf16 at D 128 (the 1.5B model) runs both products on the tensor cores
// (flash_ring_wgmma_kernel): a block is one warpgroup of 64 folded rows, Q
// as register fragments (wgmma's A operand), K/V tiles of 64 keys through a
// two-stage cp.async ring laid out for wgmma's 128-byte swizzle, S = Q K^T
// as wgmma m64n64k16 over K by descriptor and
// acc += P V as wgmma m64n128k16 with P from registers and V as it lies
// (keys x d, an MN-major B operand: no transpose pass), f32 accumulators,
// masks only on tiles that cross a row's horizon, the tiles with the longest
// horizons launched first, three blocks an SM (Q's shared memory is reused
// by the second K/V stage). Every K/V tile is read from shared memory once
// per 64 rows; an mma.sync version, whose every warp read it through
// ldmatrix for its 16 rows, ran 1.6x slower on an H100 (8.3 against 5.0-5.2
// ms a hop of a 16,384-token shard). What differs from a FlashAttention
// forward:
//   - the carried f32 state (m, l, acc) of the block's rows is loaded into
//     the accumulator fragments before the first tile and stored after the
//     last; m stays in the plain version's units (the exponent is one FMA
//     of the raw score: exp2(s * scale * log2e - m * log2e)), and a row
//     with no live key in the block is not stored: it keeps its state bit
//     for bit;
//   - P keeps f32 accuracy through a two-term split: the TPU kernel
//     multiplies f32 p by V (:479-484), and rounding p to bf16 would cost
//     2^-9 a term, so acc += bf16(p) V + bf16(p - bf16(p)) V (2^-17 a
//     term) while l sums the unrounded p. Three products per (row, key, d)
//     triple where the bound counts two: at most two thirds of the bound.
// f32 at D 16 (the tiny config in the multi-card test) keeps the f32
// CUDA-core kernel (attn_tile.cuh).
#include <math.h>

#include "attn_tile.cuh"
#include "mma.cuh"

namespace vv {
namespace {

constexpr float RING_M_INIT = -1e30f;  // m of a row that has seen no live key

template <int D>
constexpr int ring_smem() {
  return (3 * ATT_TILE * (D + 1) + ATT_TILE * (ATT_TILE + 1)) * 4;
}

// grid (ceil(R / 64), KH, B) with R = W * G folded rows.
template <typename T, int D>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_ring_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ k_len, float* __restrict__ m_st,
                      float* __restrict__ l_st, float* __restrict__ acc_st, int n_w, int n_h,
                      int n_kh, int n_s, int q_start, int k_start, float scale) {
  constexpr int LD = D + 1, LP = ATT_TILE + 1, DC = D / 16;
  const int g = n_h / n_kh, n_r = n_w * g;
  const int row0 = blockIdx.x * ATT_TILE, kh = blockIdx.y, b = blockIdx.z;

  // keys of the block this tile can see (block-local, exclusive): up to its
  // last row's slot and below k_len[b]
  const int last_row = min(row0 + ATT_TILE, n_r) - 1;
  const int kend = min(min(n_s, q_start + last_row / g + 1 - k_start), k_len[b] - k_start);
  if (kend <= 0) return;  // the whole tile lies before this block: its state stays

  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + ATT_TILE * LD;
  float* Vs = Ks + ATT_TILE * LD;
  float* Ps = Vs + ATT_TILE * LD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // folded query rows, scaled, in f32: row r = w * g + gi is head kh * g + gi
  const T* qb = q + ((size_t)b * n_w * n_h + (size_t)kh * g) * D;
  for (int idx = tid; idx < ATT_TILE * D; idx += ATT_THREADS) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    Qs[r * LD + d] =
        row < n_r ? to_f(qb[((size_t)(row / g) * n_h + row % g) * D + d]) * scale : 0.f;
  }
  const size_t st = ((size_t)b * n_kh + kh) * n_r;  // state row of folded row 0
  const size_t kv = ((size_t)b * n_kh + kh) * n_s * D;

  int qpos[4];  // block-local slot of each row: keys j <= qpos are causal
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const bool in = row < n_r;
    qpos[i] = q_start + row / g - k_start;
    m[i] = in ? m_st[st + row] : RING_M_INIT;
    l[i] = in ? l_st[st + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = in ? acc_st[(st + row) * D + tx + 16 * c] : 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += ATT_TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + kv, k0, kend, D);
    load_tile<T, D>(Vs, v + kv, k0, kend, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv4[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv4[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (!(kj < kend && kj <= qpos[i])) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // m stays finite (it starts at RING_M_INIT), so a row with no live key
      // here gets alpha 1 and p 0: its state is unchanged
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < ATT_TILE; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = Vs[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n_r) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_st[(st + row) * D + tx + 16 * c] = acc[i][c];
    if (tx == 0) {
      m_st[st + row] = m[i];
      l_st[st + row] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

constexpr int RM_BC = 64;  // keys per K/V tile
constexpr float RM_LOG2E = 1.4426950408889634f;

constexpr int RM_BR = 64;  // folded query rows per block: one warpgroup, 16 rows a warp
constexpr int RM_THREADS = 128;
constexpr int RM_HALF = RM_BC * 128;  // bytes of one 64-wide half of a K or V tile

template <int D>
struct RingSmem {
  static constexpr int Q = RM_BR * D * 2;  // the bf16 Q tile
  static constexpr int TILE = RM_BC * D * 2;  // one bf16 K or V tile
  // two stages of (K, V); Q lies over the second one, which is first written
  // after Q has gone to registers
  static constexpr int BYTES = 4 * TILE;
  static_assert(Q <= 2 * TILE, "the Q tile must fit one (K, V) stage");
};

// grid (ceil(R / 64), KH, B) with R = W * G folded rows. blockIdx.x counts
// the row tiles from the last (longest horizon) down. A K or V tile lies in
// shared memory as two halves of 64 d: rows of 128 bytes, 16-byte chunk c of
// row r at chunk c ^ (r % 8), which is wgmma's 128-byte swizzle both for K
// (K-major: d is the product's inner axis) and for V (MN-major: d is its N).
template <int D>
__global__ void __launch_bounds__(RM_THREADS, 3)
    flash_ring_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ k_len,
                            float* __restrict__ m_st, float* __restrict__ l_st,
                            float* __restrict__ acc_st, int n_w, int n_h, int n_kh, int n_s,
                            int q_start, int k_start, float scale) {
  static_assert(D == 128, "two 64-wide halves a tile");
  using SM = RingSmem<D>;
  constexpr int NCH = D / 8, BR = RM_BR, THREADS = RM_THREADS;
  const int g = n_h / n_kh, n_r = n_w * g;
  const int row0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BR, kh = blockIdx.y, b = blockIdx.z;

  // keys of the block this tile can see (block-local, exclusive): up to its
  // last row's slot and below k_len[b]
  const int klen = k_len[b] - k_start;
  const int last_row = min(row0 + BR, n_r) - 1;
  const int kend = min(min(n_s, q_start + last_row / g + 1 - k_start), klen);
  if (kend <= 0) return;  // the whole tile lies before this block: its state stays
  const int nblk = (kend + RM_BC - 1) / RM_BC;

  extern __shared__ __align__(1024) uint8_t rm_smem[];
  uint8_t* kvs = rm_smem;
  const uint32_t qs_u = smem_u32(rm_smem + 2 * SM::TILE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * n_kh + kh;
  const bf16* kb = k + bh * n_s * D;
  const bf16* vb = v + bh * n_s * D;

  auto load_kv = [&](int s, int j) {
    const uint32_t kd = smem_u32(kvs + 2 * s * SM::TILE), vd = kd + SM::TILE;
    for (int i = tid; i < RM_BC * NCH; i += THREADS) {
      const int r = i / NCH, ch = i % NCH, key = j * RM_BC + r;
      const bool ok = key < kend;  // keys past the horizon are never read: zeros
      const size_t off = (size_t)key * D + ch * 8;
      const uint32_t to = (ch >> 3) * RM_HALF + tile_off<64>(r, ch & 7);
      cp_async16(kd + to, ok ? kb + off : kb, ok ? 16 : 0);
      cp_async16(vd + to, ok ? vb + off : vb, ok ? 16 : 0);
    }
  };

  // Q tile (rows past R are zero), then the first K/V tile
  for (int i = tid; i < BR * NCH; i += THREADS) {
    const int r = i / NCH, ch = i % NCH, gr = row0 + r;
    const bool ok = gr < n_r;
    const bf16* src = q;
    if (ok) src = q + (((size_t)b * n_w + gr / g) * n_h + kh * g + gr % g) * D + ch * 8;
    cp_async16(qs_u + tile_off<D>(r, ch), src, ok ? 16 : 0);
  }
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();

  // the carried state of this thread's two rows, in the accumulator layout:
  // rows ra and rb = ra + 8, columns 8 i + 2 (lane % 4) + {0, 1}
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const bool in_a = ra < n_r, in_b = rb < n_r;
  const size_t st = bh * n_r;  // state row of folded row 0
  float m_a = in_a ? m_st[st + ra] : RING_M_INIT, m_b = in_b ? m_st[st + rb] : RING_M_INIT;
  // l is summed per thread over its own columns and over the quad at the end
  float l_a = (in_a && (lane & 3) == 0) ? l_st[st + ra] : 0.f;
  float l_b = (in_b && (lane & 3) == 0) ? l_st[st + rb] : 0.f;
  float o[D / 8][4];
  {
    const float* pa = acc_st + (st + ra) * D + 2 * (lane & 3);
    const float* pb = acc_st + (st + rb) * D + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 a = in_a ? *reinterpret_cast<const float2*>(pa + 8 * i) : make_float2(0.f, 0.f);
      const float2 c = in_b ? *reinterpret_cast<const float2*>(pb + 8 * i) : make_float2(0.f, 0.f);
      o[i][0] = a.x;
      o[i][1] = a.y;
      o[i][2] = c.x;
      o[i][3] = c.y;
    }
  }

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs_u + tile_off<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  // last live key (block-local) of each row, and the tile's smallest
  const int cap = min(klen, n_s) - 1;
  const int lim_a = min(q_start + ra / g - k_start, cap);
  const int lim_b = min(q_start + rb / g - k_start, cap);
  const int lim_min = min(q_start + row0 / g - k_start, cap);
  const float c2 = scale * RM_LOG2E;

  for (int j = 0; j < nblk; ++j) {
    const int s = j & 1;
    cp_async_wait<0>();  // tile j has landed
    fence_proxy_async();  // wgmma reads shared memory through the asynchronous proxy
    __syncthreads();     // for every thread, and tile j - 1 is no longer read
    if (j + 1 < nblk) load_kv(s ^ 1, j + 1);
    cp_async_commit();
    const uint32_t kt_u = smem_u32(kvs + 2 * s * SM::TILE), vt_u = kt_u + SM::TILE;

    // S = Q K^T: 64 rows x 64 keys, raw (unscaled) scores; K by descriptor
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_m64n64k16(&sc[0][0], qf[kk],
                         wgmma_desc_sw128(kt_u + (kk >> 2) * RM_HALF + (kk & 3) * 32));
    wgmma_commit();
    wgmma_wait<0>();

    // mask where the tile crosses a causal or length horizon
    const int k0 = j * RM_BC;
    if (k0 + RM_BC - 1 > lim_min) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          if (c > (e < 2 ? lim_a : lim_b)) sc[n][e] = -INFINITY;
        }
    }

    // online softmax; m in the units of scale * score. m stays finite (it
    // starts at RING_M_INIT), so a row with no live key here gets alpha 1
    // and p 0: its state is unchanged
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale), mn_b = fmaxf(m_b, mx_b * scale);
    const float corr_a = exp2f((m_a - mn_a) * RM_LOG2E), corr_b = exp2f((m_b - mn_b) * RM_LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr_a;
      o[i][1] *= corr_a;
      o[i][2] *= corr_b;
      o[i][3] *= corr_b;
    }
    const float nm_a = -m_a * RM_LOG2E, nm_b = -m_b * RM_LOG2E;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[n][e], c2, e < 2 ? nm_a : nm_b));  // 0 for a dead key
        if (e < 2)
          l_a += p;
        else
          l_b += p;
        sc[n][e] = p;
      }

    // acc += P V with P = hi + lo, two bf16 terms from registers, against V
    // as it lies (16 keys x 128 d a step)
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float p0 = sc[2 * kk + (t >> 1)][2 * (t & 1)];
        const float p1 = sc[2 * kk + (t >> 1)][2 * (t & 1) + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(h);
        hi[kk][t] = *reinterpret_cast<const uint32_t*>(&h);
        lo[kk][t] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    wgmma_fence();  // the accumulators were rescaled in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = wgmma_desc_sw128_mn(vt_u + kk * 16 * 128, RM_HALF);
      wgmma_rs_m64n128k16_tb(&o[0][0], hi[kk], vd);
      wgmma_rs_m64n128k16_tb(&o[0][0], lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const int rows[2] = {ra, rb};
  const float ls[2] = {l_a, l_b}, ms[2] = {m_a, m_b};
  const int lims[2] = {lim_a, lim_b};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = rows[h];
    // a row with no live key in this block (its horizon lies before key 0)
    // had alpha 1 and p 0 throughout: its state is unchanged and not stored
    if (gr >= n_r || lims[h] < 0) continue;
    float* dst = acc_st + (st + gr) * D + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
    if ((lane & 3) == 0) {
      m_st[st + gr] = ms[h];
      l_st[st + gr] = ls[h];
    }
  }
}

template <int D>
int run_ring_wgmma(const void* q, const void* k, const void* v, const void* k_len, void* m, void* l,
                   void* acc, int n_b, int n_w, int n_h, int n_kh, int n_s, int q_start,
                   int k_start, float scale, cudaStream_t stream) {
  using SM = RingSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_ring_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_r = n_w * (n_h / n_kh);
  const dim3 grid((n_r + RM_BR - 1) / RM_BR, n_kh, n_b);
  flash_ring_wgmma_kernel<D><<<grid, RM_THREADS, SM::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(k_len), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), n_w, n_h, n_kh, n_s, q_start, k_start, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run_ring(const void* q, const void* k, const void* v, const void* k_len, void* m, void* l,
             void* acc, int n_b, int n_w, int n_h, int n_kh, int n_s, int q_start, int k_start,
             float scale, cudaStream_t stream) {
  constexpr int smem = ring_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_ring_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_r = n_w * (n_h / n_kh);
  const dim3 grid((n_r + ATT_TILE - 1) / ATT_TILE, n_kh, n_b);
  flash_ring_kernel<T, D><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(k_len), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), n_w, n_h, n_kh, n_s, q_start, k_start, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vv

// q (B, W, NH, D), k/v (B, KH, S, D) contiguous, f32 or bf16 (one dtype);
// k_len (B,) int32; m, l (B, KH, W*G) and acc (B, KH, W*G, D) f32, updated in
// place. `rows` is the folded query rows per block. Built only for the
// (dtype, D) pairs a caller runs: bf16 at D 128 on the tensor cores (64
// rows; q, k, v 16-byte aligned), the 1.5B serving model's ring prefill;
// f32 at D 16 on the CUDA cores (64 rows), the tiny config's ring prefill in
// the multi-card test. The 0.5B model (D 64) adds its pair when it is ported.
extern "C" int vv_flash_ring_block(const void* q, const void* k, const void* v,
                                   const void* k_len, void* m, void* l, void* acc, int dtype,
                                   int n_b, int n_w, int n_h, int n_kh, int n_s, int d, int rows,
                                   int q_start, int k_start, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_h % n_kh != 0 || n_w < 1 || n_s < 1) return (int)cudaErrorInvalidValue;
#define VV_RING_ARGS \
  q, k, v, k_len, m, l, acc, n_b, n_w, n_h, n_kh, n_s, q_start, k_start, scale, s
  if (dtype == VV_BF16 && d == 128 && rows == vv::RM_BR) return vv::run_ring_wgmma<128>(VV_RING_ARGS);
  if (dtype == VV_F32 && d == 16 && rows == vv::ATT_TILE) return vv::run_ring<float, 16>(VV_RING_ARGS);
#undef VV_RING_ARGS
  return (int)cudaErrorInvalidValue;
}
