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
// causal products against 34 MB of K/V, so it is bound by arithmetic, not by
// memory. The design keeps arithmetic to what the masks leave: a block owns
// 64 folded query rows of one KV head, so one K/V tile in shared memory
// serves all G query heads of its positions (no K/V repeat); it reads keys
// only up to its tile's causal and length horizon; a tile wholly before the
// block (every hop whose k_start lies past its last row) returns without
// reading or writing anything, which is the TPU kernel's nblocks = 0
// (:432-435). Products are f32 on CUDA cores (attn_tile.cuh); tensor cores,
// cp.async and wgmma are later work.
#include <math.h>

#include "attn_tile.cuh"
#include "common.cuh"

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
// place. Built only for the (dtype, D) pairs a caller runs: bf16 at D 128,
// the 1.5B serving model's ring prefill; f32 at D 16, the tiny config's ring
// prefill in the multi-card test. The 0.5B model (D 64) adds its pair when
// it is ported.
extern "C" int vv_flash_ring_block(const void* q, const void* k, const void* v,
                                   const void* k_len, void* m, void* l, void* acc, int dtype,
                                   int n_b, int n_w, int n_h, int n_kh, int n_s, int d,
                                   int q_start, int k_start, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VV_RING(T, D)                                                                     \
  vv::run_ring<T, D>(q, k, v, k_len, m, l, acc, n_b, n_w, n_h, n_kh, n_s, q_start, k_start, \
                     scale, s)
  if (dtype == VV_BF16 && d == 128) return VV_RING(vv::bf16, 128);
  if (dtype == VV_F32 && d == 16) return VV_RING(float, 16);
#undef VV_RING
  return (int)cudaErrorInvalidValue;
}
