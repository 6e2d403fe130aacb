// Training flash attention: the no-cache causal attention of the Qwen2 LM in
// fine-tuning, forward and backward.
//
// Replaces the differentiable Pallas TPU flash attention bundled with JAX
// (jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel and the
// dK/dV and dQ backward kernels) that vibevoice_tpu/models/qwen2.py:284
// _attention_train_flash calls. Semantics kept: causal attention within
// segment ids, key j is live for query i iff j <= i and seg[j] == seg[i]
// (valid = 1, pad = 0, so valid rows see exactly the valid causal prefix),
// scores scaled by sm_scale, softmax in f32; O and the row log-sum-exp
// m + log l in natural units, then dQ, dK, dV. Layout is the model's own
// (B, T, H, D), so no transposes surround the call. GQA is handled by the
// caller (K/V repeated to the query heads).
//
// What bounds it: the (B, H, T, T) f32 score tensor of the masked path is
// 3.2 GB per layer at T = 8192, B = 1, 12 heads, and autograd keeps it for
// each of 28 layers. These kernels never write it: the forward keeps an
// online softmax per query row and stores O and the row LSE; the backward
// (FlashAttention-2 style) recomputes the probabilities tile by tile from
// the LSE. What is left is arithmetic: 4 D H flops per live (query, key)
// pair forward, 10 D H backward as the math counts them.
//
// Two routes, chosen by ops/flash_attention._train_plan from (dtype, D):
//
// Tensor cores, D 64 and 128 (the 1.5B/7B and the 0.5B models), f32 or bf16.
// Every product is bf16 wgmma with f32 accumulators. f32 operands keep f32
// accuracy through a three-term split: x = hi + lo with hi = bf16(x), lo =
// bf16(x - hi) (flash_train_split, one launch over q, k, v and, fused with
// delta = rowsum(dO * O) in flash_train_prep, over dO), and each product is
// hi.hi + hi.lo + lo.hi into one accumulator (lo.lo, 2^-16 relative, is
// dropped); the probabilities P and dS are split the same way in registers.
// bf16 inputs take one term (their own bits; P and dS rounded to bf16).
// TF32 wgmma would take only K-major operands from shared memory (V, dO, Q
// and K are MN-major where they are the B operand of P V, P^T dO, dS^T Q and
// dS K) and runs at half the bf16 rate. Tiles are 64 query rows or keys, one
// warpgroup a block; operand tiles lie in shared memory as halves of 64 d
// (rows of 128 bytes, 16-byte chunk c of row r at c ^ (r % 8): wgmma's
// 128-byte swizzle both K-major and MN-major), loaded by cp.async:
//   flash_train_fwd_tc   per query tile: S = Q K^T (both by descriptor),
//                        online softmax, O += P V (P from registers, V as it
//                        lies); K and V arrive in two cp.async groups so the
//                        next K loads during the softmax and P V, the next V
//                        during the next Q K^T; two blocks an SM;
//   flash_train_dkdv_tc  per key tile, K and V resident: S^T = K Q^T and
//                        dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
//                        (P^T, dS^T from registers, dO and Q as they lie);
//                        Q/dO tiles double-buffered;
//   flash_train_dq_tc    per query tile, Q and dO resident: S = Q K^T,
//                        dP = dO V^T, dQ += dS K (K as it lies); K/V tiles
//                        double-buffered. No atomics: repeated calls give the
//                        same bits.
// The walk skips tiles with no live pair: the forward and dQ read key tiles
// from kfirst (the first tile holding a key of one of the tile's rows'
// segments) to the diagonal, dK/dV query tiles from the diagonal to qlast
// (the last tile holding a query of one of its keys' segments), both
// computed on the card by flash_train_walk; query tiles with the longest
// walks are launched first.
//
// CUDA cores, D 16 and 32 (the tiny test configs): the kernels of the first
// port, 256 threads as a 16 x 16 grid on tiles of 64 rows (attn_tile.cuh),
// f32 arithmetic, inputs widened to f32 in shared memory (rows padded to
// D + 1 floats against bank conflicts):
//   flash_train_fwd   one block per (64-query tile, head, batch), loops over
//                     the key tiles up to the diagonal;
//   flash_train_dkdv  one block per 64-key tile, loops over query tiles from
//                     the diagonal to the end, accumulating dK and dV;
//   flash_train_dq    one block per 64-query tile, loops over key tiles up to
//                     the diagonal, accumulating dQ (no atomics).
#include <climits>
#include <math.h>
#include <type_traits>

#include "attn_tile.cuh"
#include "mma.cuh"

namespace vv {
namespace {

// ---------------------------------------------------------------------------
// CUDA cores (D 16, 32)
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem() {
  return (3 * ATT_TILE * (D + 1) + ATT_TILE * (ATT_TILE + 1) + ATT_TILE) * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return (4 * ATT_TILE * (D + 1) + 2 * ATT_TILE * (ATT_TILE + 1) + 3 * ATT_TILE) * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * ATT_TILE * (D + 1) + ATT_TILE * (ATT_TILE + 1) + ATT_TILE) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_train_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
                    int n_t, int n_h, float scale) {
  constexpr int LD = D + 1, LP = ATT_TILE + 1, DC = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + ATT_TILE * LD;
  float* Vs = Ks + ATT_TILE * LD;
  float* Ps = Vs + ATT_TILE * LD;
  int* segk = reinterpret_cast<int*>(Ps + ATT_TILE * LP);

  const int q0 = blockIdx.x * ATT_TILE, h = blockIdx.y, b = blockIdx.z;
  const int rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Qs, q + base, q0, n_t, rs);
  int sq[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    sq[i] = t < n_t ? seg[(size_t)b * n_t + t] : INT_MIN;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(n_t, q0 + ATT_TILE);
  for (int k0 = 0; k0 < kend; k0 += ATT_TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + base, k0, n_t, rs);
    load_tile<T, D>(Vs, v + base, k0, n_t, rs);
    if (tid < ATT_TILE) segk[tid] = k0 + tid < n_t ? seg[(size_t)b * n_t + k0 + tid] : INT_MIN;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = kj <= qi && kj < n_t && segk[tx + 16 * j] == sq[i];
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
      const float alpha = expf(m[i] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
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
    const int t = q0 + ty * 4 + i;
    if (t >= n_t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[base + (size_t)t * rs + tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[((size_t)b * n_h + h) * n_t + t] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_train_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n_t, int n_h, float scale) {
  constexpr int LD = D + 1, LP = ATT_TILE + 1, DC = D / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + ATT_TILE * LD;
  float* Qs = Vs + ATT_TILE * LD;
  float* dOs = Qs + ATT_TILE * LD;
  float* Ps = dOs + ATT_TILE * LD;
  float* dSs = Ps + ATT_TILE * LP;
  float* lse_s = dSs + ATT_TILE * LP;
  float* del_s = lse_s + ATT_TILE;
  int* segq = reinterpret_cast<int*>(del_s + ATT_TILE);

  const int k0 = blockIdx.x * ATT_TILE, h = blockIdx.y, b = blockIdx.z;
  const int rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const size_t row_base = ((size_t)b * n_h + h) * n_t;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Ks, k + base, k0, n_t, rs);
  load_tile<T, D>(Vs, v + base, k0, n_t, rs);
  int sk[4];
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    sk[i] = t < n_t ? seg[(size_t)b * n_t + t] : INT_MIN;
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  for (int q0 = k0; q0 < n_t; q0 += ATT_TILE) {  // query tiles from the diagonal on
    __syncthreads();
    load_tile<T, D>(Qs, q + base, q0, n_t, rs);
    load_tile<T, D>(dOs, dout + base, q0, n_t, rs);
    if (tid < ATT_TILE) {
      const int t = q0 + tid;
      const bool in = t < n_t;
      segq[tid] = in ? seg[(size_t)b * n_t + t] : INT_MIN + 1;
      lse_s[tid] = in ? lse[row_base + t] : 0.f;
      del_s[tid] = in ? delta[row_base + t] : 0.f;
    }
    __syncthreads();

    // transposed scores S^T[key][query] and dP^T = V dO^T
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * LD + d];
        vv[i] = Vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        dov[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, qi = q0 + col;
        const bool live = kj <= qi && qi < n_t && kj < n_t && segq[col] == sk[i];
        const float p = live ? expf(s[i][j] * scale - lse_s[col]) : 0.f;
        Ps[(ty * 4 + i) * LP + col] = p;
        dSs[(ty * 4 + i) * LP + col] = p * (dp[i][j] - del_s[col]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q (scaled at the end)
#pragma unroll 2
    for (int c = 0; c < ATT_TILE; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * LP + c];
        dsv[i] = dSs[(ty * 4 + i) * LP + c];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float dov = dOs[c * LD + tx + 16 * cc], qv = Qs[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][cc] = fmaf(pv[i], dov, dv_acc[i][cc]);
          dk_acc[i][cc] = fmaf(dsv[i], qv, dk_acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= n_t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t off = base + (size_t)t * rs + tx + 16 * c;
      dk[off] = from_f<T>(dk_acc[i][c] * scale);
      dv[off] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_train_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ seg, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dq, int n_t, int n_h, float scale) {
  constexpr int LD = D + 1, LP = ATT_TILE + 1, DC = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + ATT_TILE * LD;
  float* Ks = dOs + ATT_TILE * LD;
  float* Vs = Ks + ATT_TILE * LD;
  float* dSs = Vs + ATT_TILE * LD;
  int* segk = reinterpret_cast<int*>(dSs + ATT_TILE * LP);

  const int q0 = blockIdx.x * ATT_TILE, h = blockIdx.y, b = blockIdx.z;
  const int rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const size_t row_base = ((size_t)b * n_h + h) * n_t;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Qs, q + base, q0, n_t, rs);
  load_tile<T, D>(dOs, dout + base, q0, n_t, rs);
  int sq[4];
  float lse_r[4], del_r[4], dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    const bool in = t < n_t;
    sq[i] = in ? seg[(size_t)b * n_t + t] : INT_MIN;
    lse_r[i] = in ? lse[row_base + t] : 0.f;
    del_r[i] = in ? delta[row_base + t] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;
  }

  const int kend = min(n_t, q0 + ATT_TILE);
  for (int k0 = 0; k0 < kend; k0 += ATT_TILE) {
    __syncthreads();
    load_tile<T, D>(Ks, k + base, k0, n_t, rs);
    load_tile<T, D>(Vs, v + base, k0, n_t, rs);
    if (tid < ATT_TILE) segk[tid] = k0 + tid < n_t ? seg[(size_t)b * n_t + k0 + tid] : INT_MIN + 1;
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LD + d];
        dov[i] = dOs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j, kj = k0 + col;
        const bool live = kj <= qi && kj < n_t && qi < n_t && segk[col] == sq[i];
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * LP + col] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < ATT_TILE; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float kv = Ks[c * LD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][cc] = fmaf(dsv[i], kv, dq_acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= n_t) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[base + (size_t)t * rs + tx + 16 * c] = from_f<T>(dq_acc[i][c] * scale);
  }
}

// delta = rowsum(dO * O), one warp per row; with SPLIT (f32) it also writes
// dO as hi = bf16(dO) and lo = bf16(dO - hi) for the tensor-core kernels.
template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_train_prep(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                     bf16* __restrict__ dh, bf16* __restrict__ dl, int n_b, int n_t, int n_h) {
  const long row = (long)blockIdx.x * (ATT_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long)n_b * n_t * n_h) return;
  const int h = row % n_h;
  const long bt = row / n_h;
  const int t = bt % n_t, b = bt / n_t;
  const size_t off = (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float g = to_f(dout[off + d]);
    s += to_f(o[off + d]) * g;
    if constexpr (SPLIT) {
      const bf16 hi = __float2bfloat16_rn(g);
      dh[off + d] = hi;
      dl[off + d] = __float2bfloat16_rn(g - __bfloat162float(hi));
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[((size_t)b * n_h + h) * n_t + t] = s;
}

// ---------------------------------------------------------------------------
// Tensor cores (D 64, 128)
// ---------------------------------------------------------------------------

// The split pass: x_i (n f32 each, n a multiple of 4) -> hi_i = bf16(x_i)
// and lo_i = bf16(x_i - hi_i) at ws + 2 i n and ws + (2 i + 1) n;
// blockIdx.y picks i.
struct FtSplitArgs {
  const float4* x[4];
};

__global__ void __launch_bounds__(256)
    flash_train_split(FtSplitArgs args, bf16* __restrict__ ws, int n) {
  const int n4 = n / 4;
  const float4* __restrict__ x = args.x[blockIdx.y];
  uint2* hi = reinterpret_cast<uint2*>(ws + (size_t)2 * blockIdx.y * n);
  uint2* lo = reinterpret_cast<uint2*>(ws + (size_t)(2 * blockIdx.y + 1) * n);
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n4; i += gridDim.x * 256) {
    const float4 v = x[i];
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y), h1 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
    hi[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&h0), *reinterpret_cast<const uint32_t*>(&h1));
    lo[i] = make_uint2(pack_bf16(v.x - f0.x, v.y - f0.y), pack_bf16(v.z - f1.x, v.w - f1.y));
  }
}

// The tile walks (ops/flash_attention._train_walk_plain is the plain
// version): for 64-row tile i of sample b with segment ids S_i,
// kfirst = (the first j with seg[j] in S_i) / 64 and qlast = (the last j
// with seg[j] in S_i) / 64. grid (ceil(T / 64), B), 128 threads; each scan
// stops at the first hit, so a right-padded batch reads little.
__global__ void __launch_bounds__(128)
    flash_train_walk(const int* __restrict__ seg, int* __restrict__ kfirst, int* __restrict__ qlast,
                     int n_t) {
  constexpr int PER = 8, STEP = 128 * PER;  // positions a thread, and a block, checks a round
  __shared__ int vals[64];
  __shared__ int n_vals, first, last;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int* sg = seg + (size_t)b * n_t;
  const int t0 = tile * 64, t1 = min(n_t, t0 + 64);  // the tile's rows [t0, t1)
  if (tid == 0) {  // the tile's distinct ids
    int nv = 0;
    for (int r = t0; r < t1; ++r) {
      bool seen = false;
      for (int i = 0; i < nv && !seen; ++i) seen = vals[i] == sg[r];
      if (!seen) vals[nv++] = sg[r];
    }
    n_vals = nv;
    first = t0;
    last = t1 - 1;
  }
  __syncthreads();
  const int nv = n_vals;
  auto member = [&](int x) {
    bool hit = false;
    for (int i = 0; i < nv; ++i) hit |= vals[i] == x;
    return hit;
  };
  for (int base = 0; base < t0; base += STEP) {  // from the start up to the tile
    int hit = INT_MAX;
    for (int e = PER - 1; e >= 0; --e) {
      const int j = base + tid * PER + e;
      if (j < t0 && member(sg[j])) hit = j;
    }
    if (hit != INT_MAX) atomicMin(&first, hit);
    if (__syncthreads_or(hit != INT_MAX)) break;
  }
  for (int top = n_t - 1; top >= t1; top -= STEP) {  // from the end down to the tile
    int hit = -1;
    for (int e = PER - 1; e >= 0; --e) {
      const int j = top - tid * PER - e;
      if (j >= t1 && member(sg[j])) hit = j;
    }
    if (hit >= 0) atomicMax(&last, hit);
    if (__syncthreads_or(hit >= 0)) break;
  }
  __syncthreads();
  if (tid == 0) {
    kfirst[(size_t)b * gridDim.x + tile] = first / 64;
    qlast[(size_t)b * gridDim.x + tile] = last / 64;
  }
}

constexpr int FT_TILE = 64;             // query rows or keys of a tile (wgmma's M)
constexpr int FT_THREADS = 128;         // one warpgroup
constexpr int FT_HALF = FT_TILE * 128;  // bytes of 64 rows x 64 d of bf16
constexpr float FT_LOG2E = 1.4426950408889634f;
constexpr float FT_M_INIT = -1e30f;  // m of a row that has seen no live key

template <bool SPLIT>
using FtOut = std::conditional_t<SPLIT, float, bf16>;

template <int D, bool SPLIT>
struct FtTile {
  static constexpr int BYTES = FT_TILE * D * 2;       // one bf16 tile
  static constexpr int OP = (SPLIT ? 2 : 1) * BYTES;  // an operand: hi, then lo
};

// Rows t0 .. t0 + 63 of one head of a (B, T, H, D) bf16 array (src at that
// head of the sample, row stride rs) into a swizzled tile; rows at or past
// n_t are zero.
template <int D>
__device__ __forceinline__ void ft_load(uint32_t dst, const bf16* __restrict__ src, int t0, int n_t,
                                        int rs) {
  constexpr int NCH = D / 8;
  for (int i = threadIdx.x; i < FT_TILE * NCH; i += FT_THREADS) {
    const int r = i / NCH, ch = i % NCH;
    const bool ok = t0 + r < n_t;
    cp_async16(dst + (ch >> 3) * FT_HALF + tile_off<64>(r, ch & 7),
               ok ? src + (size_t)(t0 + r) * rs + ch * 8 : src, ok ? 16 : 0);
  }
}

// An operand's hi tile and, with SPLIT, its lo tile right after it.
template <int D, bool SPLIT>
__device__ __forceinline__ void ft_load_op(uint32_t dst, const bf16* hi, const bf16* lo,
                                           size_t base, int t0, int n_t, int rs) {
  ft_load<D>(dst, hi + base, t0, n_t, rs);
  if constexpr (SPLIT) ft_load<D>(dst + FtTile<D, SPLIT>::BYTES, lo + base, t0, n_t, rs);
}

// acc (64 x 64) += A B^T over d, A and B operands at a and b (rows x d,
// d the inner axis: K-major both): hi.hi, and with SPLIT + hi.lo + lo.hi.
template <int D, bool SPLIT>
__device__ __forceinline__ void ft_ss(float acc[32], uint32_t a, uint32_t b) {
  constexpr int LO = FtTile<D, SPLIT>::BYTES;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * FT_HALF + (kk & 3) * 32;
    const uint64_t ah = wgmma_desc_sw128(a + off), bh = wgmma_desc_sw128(b + off);
    wgmma_ss_m64n64k16(acc, ah, bh);
    if constexpr (SPLIT) {
      wgmma_ss_m64n64k16(acc, ah, wgmma_desc_sw128(b + LO + off));
      wgmma_ss_m64n64k16(acc, wgmma_desc_sw128(a + LO + off), bh);
    }
  }
}

template <int D>
__device__ __forceinline__ void ft_mma_mn(float* acc, const uint32_t a[4], uint64_t desc) {
  if constexpr (D == 128)
    wgmma_rs_m64n128k16_tb(acc, a, desc);
  else
    wgmma_rs_m64n64k16_tb(acc, a, desc);
}

// acc (64 x D) += P X: P (64 x 64) as register fragments hi (+ lo), X the
// operand at x taken as it lies (its 64 rows the product's inner axis, d its
// N: MN-major). SPLIT: Phi.Xhi + Phi.Xlo + Plo.Xhi.
template <int D, bool SPLIT>
__device__ __forceinline__ void ft_rs(float* acc, const uint32_t hi[4][4], const uint32_t lo[4][4],
                                      uint32_t x) {
  constexpr int LO = FtTile<D, SPLIT>::BYTES;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = kk * 16 * 128;  // 16 rows a step
    const uint64_t xh = wgmma_desc_sw128_mn(x + off, FT_HALF);
    ft_mma_mn<D>(acc, hi[kk], xh);
    if constexpr (SPLIT) {
      ft_mma_mn<D>(acc, hi[kk], wgmma_desc_sw128_mn(x + LO + off, FT_HALF));
      ft_mma_mn<D>(acc, lo[kk], xh);
    }
  }
}

// A 64 x 64 accumulator as wgmma's A fragments over its columns: hi =
// bf16(p) and, with SPLIT, lo = bf16(p - hi). The accumulator's layout is
// mma.m16n8k16's C per warp, the fragment's its A: s[2kk + t/2][2(t%2) + e].
template <bool SPLIT>
__device__ __forceinline__ void ft_frag(const float s[8][4], uint32_t hi[4][4], uint32_t lo[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float p0 = s[2 * kk + (t >> 1)][2 * (t & 1)];
      const float p1 = s[2 * kk + (t >> 1)][2 * (t & 1) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
      hi[kk][t] = *reinterpret_cast<const uint32_t*>(&h);
      if constexpr (SPLIT) {
        const float2 hf = __bfloat1622float2(h);
        lo[kk][t] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    }
}

static __device__ __forceinline__ void ft_store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
static __device__ __forceinline__ void ft_store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows ra (e < 2) and ra + 8 (e >= 2) of a 64 x D accumulator, times f, to
// out (row stride rs); rows at or past n_t are not stored.
template <int D, typename OT>
__device__ __forceinline__ void ft_store_rows(OT* out, const float acc[D / 8][4], int ra, int n_t,
                                              int rs, float fa, float fb) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int row = ra + 8 * hb;
    if (row >= n_t) continue;
    const float f = hb ? fb : fa;
    OT* dst = out + (size_t)row * rs + c;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) ft_store2(dst + 8 * i, acc[i][2 * hb] * f, acc[i][2 * hb + 1] * f);
  }
}

// grid (ceil(T / 64), H, B); blockIdx.x counts the query tiles from the last
// (the longest walk) down.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(FT_THREADS, 2)
    flash_train_fwd_tc(const bf16* __restrict__ qh, const bf16* __restrict__ ql,
                       const bf16* __restrict__ kh, const bf16* __restrict__ kl,
                       const bf16* __restrict__ vh, const bf16* __restrict__ vl,
                       const int* __restrict__ seg, const int* __restrict__ kfirst,
                       FtOut<SPLIT>* __restrict__ o, float* __restrict__ lse, int n_t, int n_h,
                       float scale) {
  using L = FtTile<D, SPLIT>;
  const int n_qt = gridDim.x, qt = n_qt - 1 - (int)blockIdx.x, q0 = qt * FT_TILE;
  const int h = blockIdx.y, b = blockIdx.z, rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const int* sg = seg + (size_t)b * n_t;
  extern __shared__ __align__(1024) uint8_t ft_smem[];
  const uint32_t qs = smem_u32(ft_smem), ks = qs + L::OP, vs = ks + L::OP;
  int* segk = reinterpret_cast<int*>(ft_smem + 3 * L::OP);  // [2][64], key tile j at (j - kt0) % 2
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt0 = kfirst[(size_t)b * n_qt + qt];

  // three cp.async groups: Q, K of the first tile, V of the first tile
  ft_load_op<D, SPLIT>(qs, qh, ql, base, q0, n_t, rs);
  cp_async_commit();
  ft_load_op<D, SPLIT>(ks, kh, kl, base, kt0 * FT_TILE, n_t, rs);
  cp_async_commit();
  ft_load_op<D, SPLIT>(vs, vh, vl, base, kt0 * FT_TILE, n_t, rs);
  cp_async_commit();
  if (tid < FT_TILE) {
    const int t = kt0 * FT_TILE + tid;
    segk[tid] = t < n_t ? sg[t] : 0;  // keys past T are past every row: dead by causality
  }

  // this thread's rows of the accumulators: ra and rb = ra + 8
  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int sa = ra < n_t ? sg[ra] : INT_MIN, sb = rb < n_t ? sg[rb] : INT_MIN;
  float m_a = FT_M_INIT, m_b = FT_M_INIT, l_a = 0.f, l_b = 0.f;  // l summed over the quad at the end
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float c2 = scale * FT_LOG2E;

  for (int j = kt0; j <= qt; ++j) {
    const int* sk = segk + ((j - kt0) & 1) * FT_TILE;
    cp_async_wait<1>();   // Q and K_j have landed (V_j may still be in flight)
    fence_proxy_async();  // wgmma reads shared memory through the asynchronous proxy
    __syncthreads();
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    wgmma_fence();
    ft_ss<D, SPLIT>(&sc[0][0], qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // every warp's product has read K_j: load K_{j+1} over it
    if (j < qt) {
      ft_load_op<D, SPLIT>(ks, kh, kl, base, (j + 1) * FT_TILE, n_t, rs);
      if (tid < FT_TILE) {
        const int t = (j + 1) * FT_TILE + tid;
        segk[((j + 1 - kt0) & 1) * FT_TILE + tid] = t < n_t ? sg[t] : 0;
      }
    }
    cp_async_commit();

    // mask: key j <= row and the same segment
    const int k0 = j * FT_TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);
        const bool live = k0 + c <= (e < 2 ? ra : rb) && sk[c] == (e < 2 ? sa : sb);
        if (!live) sc[n][e] = -INFINITY;
      }

    // online softmax, m in the units of scale * score; m stays finite (it
    // starts at FT_M_INIT), so a row with no live key yet gets alpha 1, p 0
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
    const float corr_a = exp2f((m_a - mn_a) * FT_LOG2E), corr_b = exp2f((m_b - mn_b) * FT_LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr_a;
      acc[i][1] *= corr_a;
      acc[i][2] *= corr_b;
      acc[i][3] *= corr_b;
    }
    const float nm_a = -m_a * FT_LOG2E, nm_b = -m_b * FT_LOG2E;
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
    uint32_t ph[4][4], pl[4][4];
    ft_frag<SPLIT>(sc, ph, pl);

    cp_async_wait<1>();  // V_j has landed (K_{j+1} may still be in flight)
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();  // the accumulators were rescaled in registers
    ft_rs<D, SPLIT>(&acc[0][0], ph, pl, vs);
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // every warp's product has read V_j
    if (j < qt) ft_load_op<D, SPLIT>(vs, vh, vl, base, (j + 1) * FT_TILE, n_t, rs);
    cp_async_commit();
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // every row below T sees itself, so l > 0 there
  ft_store_rows<D>(o + base, acc, ra, n_t, rs, 1.f / l_a, 1.f / l_b);
  if ((lane & 3) == 0) {
    float* lr = lse + ((size_t)b * n_h + h) * n_t;
    if (ra < n_t) lr[ra] = m_a + logf(l_a);
    if (rb < n_t) lr[rb] = m_b + logf(l_b);
  }
}

// grid (ceil(T / 64), H, B), query tiles from the last down. Q and dO stay
// in shared memory; K/V tiles are double-buffered.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(FT_THREADS, 1)
    flash_train_dq_tc(const bf16* __restrict__ qh, const bf16* __restrict__ ql,
                      const bf16* __restrict__ kh, const bf16* __restrict__ kl,
                      const bf16* __restrict__ vh, const bf16* __restrict__ vl,
                      const bf16* __restrict__ dh, const bf16* __restrict__ dl,
                      const int* __restrict__ seg, const int* __restrict__ kfirst,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      FtOut<SPLIT>* __restrict__ dq, int n_t, int n_h, float scale) {
  using L = FtTile<D, SPLIT>;
  const int n_qt = gridDim.x, qt = n_qt - 1 - (int)blockIdx.x, q0 = qt * FT_TILE;
  const int h = blockIdx.y, b = blockIdx.z, rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const size_t row_base = ((size_t)b * n_h + h) * n_t;
  const int* sg = seg + (size_t)b * n_t;
  extern __shared__ __align__(1024) uint8_t ft_smem[];
  const uint32_t qs = smem_u32(ft_smem), dos = qs + L::OP, kv0 = dos + L::OP;  // stage s at kv0 + 2 s OP
  int* segk = reinterpret_cast<int*>(ft_smem + 6 * L::OP);  // [2][64]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt0 = kfirst[(size_t)b * n_qt + qt];

  auto load_kv = [&](int s, int j) {
    const uint32_t k_s = kv0 + 2 * s * L::OP;
    ft_load_op<D, SPLIT>(k_s, kh, kl, base, j * FT_TILE, n_t, rs);
    ft_load_op<D, SPLIT>(k_s + L::OP, vh, vl, base, j * FT_TILE, n_t, rs);
    if (tid < FT_TILE) {
      const int t = j * FT_TILE + tid;
      segk[s * FT_TILE + tid] = t < n_t ? sg[t] : 0;
    }
  };
  ft_load_op<D, SPLIT>(qs, qh, ql, base, q0, n_t, rs);
  ft_load_op<D, SPLIT>(dos, dh, dl, base, q0, n_t, rs);
  load_kv(0, kt0);
  cp_async_commit();

  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const bool in_a = ra < n_t, in_b = rb < n_t;
  const int sa = in_a ? sg[ra] : INT_MIN, sb = in_b ? sg[rb] : INT_MIN;
  const float nl_a = in_a ? -lse[row_base + ra] * FT_LOG2E : 0.f;
  const float nl_b = in_b ? -lse[row_base + rb] * FT_LOG2E : 0.f;
  const float del_a = in_a ? delta[row_base + ra] : 0.f, del_b = in_b ? delta[row_base + rb] : 0.f;
  const float c2 = scale * FT_LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = kt0; j <= qt; ++j) {
    const int s = (j - kt0) & 1;
    cp_async_wait<0>();  // tile j has landed
    fence_proxy_async();
    __syncthreads();  // for every thread, and stage s ^ 1 is no longer read
    if (j < qt) load_kv(s ^ 1, j + 1);
    cp_async_commit();
    const uint32_t k_s = kv0 + 2 * s * L::OP, v_s = k_s + L::OP;
    const int* sk = segk + s * FT_TILE;

    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    wgmma_fence();
    ft_ss<D, SPLIT>(&sc[0][0], qs, k_s);
    ft_ss<D, SPLIT>(&dp[0][0], dos, v_s);
    wgmma_commit();
    wgmma_wait<0>();

    // P from the LSE, dS = P (dP - delta), over the live pairs
    const int k0 = j * FT_TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);
        const bool live = k0 + c <= (e < 2 ? ra : rb) && sk[c] == (e < 2 ? sa : sb);
        const float p = live ? exp2f(fmaf(sc[n][e], c2, e < 2 ? nl_a : nl_b)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? del_a : del_b));
      }
    uint32_t gh[4][4], gl[4][4];
    ft_frag<SPLIT>(dp, gh, gl);
    wgmma_fence();
    ft_rs<D, SPLIT>(&acc[0][0], gh, gl, k_s);
    wgmma_commit();
    wgmma_wait<0>();
  }
  ft_store_rows<D>(dq + base, acc, ra, n_t, rs, scale, scale);
}

// grid (ceil(T / 64), H, B), key tiles in order (tile 0 has the longest
// walk). K and V stay in shared memory; Q/dO tiles and their rows' segment
// ids, LSE and delta are double-buffered.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(FT_THREADS, 1)
    flash_train_dkdv_tc(const bf16* __restrict__ qh, const bf16* __restrict__ ql,
                        const bf16* __restrict__ kh, const bf16* __restrict__ kl,
                        const bf16* __restrict__ vh, const bf16* __restrict__ vl,
                        const bf16* __restrict__ dh, const bf16* __restrict__ dl,
                        const int* __restrict__ seg, const int* __restrict__ qlast,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        FtOut<SPLIT>* __restrict__ dk, FtOut<SPLIT>* __restrict__ dv, int n_t,
                        int n_h, float scale) {
  using L = FtTile<D, SPLIT>;
  const int n_kt = gridDim.x, kt = blockIdx.x, k0 = kt * FT_TILE;
  const int h = blockIdx.y, b = blockIdx.z, rs = n_h * D;
  const size_t base = (size_t)b * n_t * rs + (size_t)h * D;
  const size_t row_base = ((size_t)b * n_h + h) * n_t;
  const int* sg = seg + (size_t)b * n_t;
  extern __shared__ __align__(1024) uint8_t ft_smem[];
  const uint32_t ks = smem_u32(ft_smem), vs = ks + L::OP, qd0 = vs + L::OP;  // stage s at qd0 + 2 s OP
  // per stage: the 64 query rows' segment ids, LSE and delta
  uint8_t* rows_smem = ft_smem + 6 * L::OP;
  const uint32_t rows_u = smem_u32(rows_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt1 = qlast[(size_t)b * n_kt + kt];

  auto load_q = [&](int s, int j) {
    const uint32_t q_s = qd0 + 2 * s * L::OP;
    ft_load_op<D, SPLIT>(q_s, qh, ql, base, j * FT_TILE, n_t, rs);
    ft_load_op<D, SPLIT>(q_s + L::OP, dh, dl, base, j * FT_TILE, n_t, rs);
    if (tid < FT_TILE) {
      const int t = j * FT_TILE + tid;
      const bool ok = t < n_t;  // rows past T: zeros, and masked below
      const uint32_t r = rows_u + (s * 3 * FT_TILE + tid) * 4;
      cp_async4(r, ok ? sg + t : sg, ok ? 4 : 0);
      cp_async4(r + FT_TILE * 4, ok ? lse + row_base + t : lse, ok ? 4 : 0);
      cp_async4(r + 2 * FT_TILE * 4, ok ? delta + row_base + t : delta, ok ? 4 : 0);
    }
  };
  ft_load_op<D, SPLIT>(ks, kh, kl, base, k0, n_t, rs);
  ft_load_op<D, SPLIT>(vs, vh, vl, base, k0, n_t, rs);
  load_q(0, kt);
  cp_async_commit();

  // this thread's keys (rows of S^T and of dK/dV): ka and kb = ka + 8
  const int ka = k0 + warp * 16 + (lane >> 2), kb = ka + 8;
  const int ska = ka < n_t ? sg[ka] : INT_MIN, skb = kb < n_t ? sg[kb] : INT_MIN;
  const float c2 = scale * FT_LOG2E;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = kt; j <= qt1; ++j) {
    const int s = (j - kt) & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j < qt1) load_q(s ^ 1, j + 1);
    cp_async_commit();
    const uint32_t q_s = qd0 + 2 * s * L::OP, do_s = q_s + L::OP;
    const int* sq = reinterpret_cast<const int*>(rows_smem) + s * 3 * FT_TILE;
    const float* lq = reinterpret_cast<const float*>(sq + FT_TILE);
    const float* dlt = lq + FT_TILE;

    float st[8][4], dpt[8][4];  // S^T and dP^T: keys x queries
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    wgmma_fence();
    ft_ss<D, SPLIT>(&st[0][0], ks, q_s);
    ft_ss<D, SPLIT>(&dpt[0][0], vs, do_s);
    wgmma_commit();
    wgmma_wait<0>();

    const int q0 = j * FT_TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1), qi = q0 + c;
        const bool live = (e < 2 ? ka : kb) <= qi && qi < n_t && sq[c] == (e < 2 ? ska : skb);
        const float p = live ? exp2f(fmaf(st[n][e], c2, -lq[c] * FT_LOG2E)) : 0.f;
        dpt[n][e] = p * (dpt[n][e] - dlt[c]);
        st[n][e] = p;
      }
    uint32_t ph[4][4], pl[4][4], gh[4][4], gl[4][4];
    ft_frag<SPLIT>(st, ph, pl);
    ft_frag<SPLIT>(dpt, gh, gl);
    wgmma_fence();
    ft_rs<D, SPLIT>(&dva[0][0], ph, pl, do_s);
    ft_rs<D, SPLIT>(&dka[0][0], gh, gl, q_s);
    wgmma_commit();
    wgmma_wait<0>();
  }
  ft_store_rows<D>(dk + base, dka, ka, n_t, rs, scale, scale);
  ft_store_rows<D>(dv + base, dva, ka, n_t, rs, 1.f, 1.f);
}

template <int D, bool SPLIT>
int run_fwd_tc(const void* const* ops, const void* seg, const void* kfirst, void* o, void* lse,
               int n_b, int n_t, int n_h, float scale, cudaStream_t stream) {
  constexpr int smem = 3 * FtTile<D, SPLIT>::OP + 2 * FT_TILE * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_train_fwd_tc<D, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_t + FT_TILE - 1) / FT_TILE, n_h, n_b);
  auto op = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  flash_train_fwd_tc<D, SPLIT><<<grid, FT_THREADS, smem, stream>>>(
      op(0), op(1), op(2), op(3), op(4), op(5), static_cast<const int*>(seg),
      static_cast<const int*>(kfirst), static_cast<FtOut<SPLIT>*>(o), static_cast<float*>(lse), n_t,
      n_h, scale);
  return (int)cudaGetLastError();
}

// ops: qh, ql, kh, kl, vh, vl, dh, dl (the lo pointers null for bf16; dh
// is then dout itself, else flash_train_prep writes dh and dl).
template <int D, bool SPLIT>
int run_bwd_tc(const void* const* ops, const void* seg, const void* kfirst, const void* qlast,
               const void* o, const void* dout, const void* lse, void* delta, void* dq, void* dk,
               void* dv, int n_b, int n_t, int n_h, float scale, cudaStream_t stream) {
  using OT = FtOut<SPLIT>;
  auto op = [&](int i) { return static_cast<const bf16*>(ops[i]); };
  const long rows = (long)n_b * n_t * n_h;
  const int rows_per_block = ATT_THREADS / 32;
  flash_train_prep<OT, D, SPLIT><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                                   ATT_THREADS, 0, stream>>>(
      static_cast<const OT*>(o), static_cast<const OT*>(dout), static_cast<float*>(delta),
      const_cast<bf16*>(op(6)), const_cast<bf16*>(op(7)), n_b, n_t, n_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int smem_kv = 6 * FtTile<D, SPLIT>::OP + 2 * 3 * FT_TILE * 4;
  constexpr int smem_q = 6 * FtTile<D, SPLIT>::OP + 2 * FT_TILE * 4;
  const dim3 grid((n_t + FT_TILE - 1) / FT_TILE, n_h, n_b);
  const int* sp = static_cast<const int*>(seg);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);
  err = cudaFuncSetAttribute(flash_train_dkdv_tc<D, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_train_dkdv_tc<D, SPLIT><<<grid, FT_THREADS, smem_kv, stream>>>(
      op(0), op(1), op(2), op(3), op(4), op(5), op(6), op(7), sp, static_cast<const int*>(qlast), lp,
      dp, static_cast<OT*>(dk), static_cast<OT*>(dv), n_t, n_h, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_train_dq_tc<D, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_train_dq_tc<D, SPLIT><<<grid, FT_THREADS, smem_q, stream>>>(
      op(0), op(1), op(2), op(3), op(4), op(5), op(6), op(7), sp, static_cast<const int*>(kfirst),
      lp, dp, static_cast<OT*>(dq), n_t, n_h, scale);
  return (int)cudaGetLastError();
}
template <typename T, int D>
int run_fwd(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
            int n_b, int n_t, int n_h, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_train_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_t + ATT_TILE - 1) / ATT_TILE, n_h, n_b);
  flash_train_fwd<T, D><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<T*>(o), static_cast<float*>(lse), n_t, n_h, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run_bwd(const void* q, const void* k, const void* v, const void* seg, const void* o,
            const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv, int n_b,
            int n_t, int n_h, float scale, cudaStream_t stream) {
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  const int* sp = static_cast<const int*>(seg);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);

  const long rows = (long)n_b * n_t * n_h;
  const int rows_per_block = ATT_THREADS / 32;
  flash_train_prep<T, D, false><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                                  ATT_THREADS, 0, stream>>>(static_cast<const T*>(o), dop, dp,
                                                            nullptr, nullptr, n_b, n_t, n_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((n_t + ATT_TILE - 1) / ATT_TILE, n_h, n_b);
  constexpr int smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_train_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_train_dkdv<T, D><<<grid, ATT_THREADS, smem_kv, stream>>>(
      qp, kp, vp, sp, dop, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), n_t, n_h, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_train_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_train_dq<T, D><<<grid, ATT_THREADS, smem_q, stream>>>(qp, kp, vp, sp, dop, lp, dp,
                                                             static_cast<T*>(dq), n_t, n_h, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vv

// The CUDA-core route: D 16 or 32 (the test configs), f32 or bf16.
#define VV_FT_CASES(CALL)                                          \
  if (dtype == VV_F32 && d == 32) return CALL(float, 32);          \
  if (dtype == VV_F32 && d == 16) return CALL(float, 16);          \
  if (dtype == VV_BF16 && d == 32) return CALL(vv::bf16, 32);      \
  if (dtype == VV_BF16 && d == 16) return CALL(vv::bf16, 16);      \
  return (int)cudaErrorInvalidValue;

// q, k, v, o: (B, T, H, D) contiguous, f32 or bf16 (one dtype); seg (B, T)
// int32; lse (B, H, T) f32.
extern "C" int vv_flash_train_fwd(const void* q, const void* k, const void* v, const void* seg,
                                  void* o, void* lse, int dtype, int n_b, int n_t, int n_h, int d,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VV_FT_FWD(T, D) vv::run_fwd<T, D>(q, k, v, seg, o, lse, n_b, n_t, n_h, scale, s)
  VV_FT_CASES(VV_FT_FWD)
#undef VV_FT_FWD
}

// Gradients dq, dk, dv (B, T, H, D) in the inputs' dtype; delta (B, H, T)
// f32 scratch.
extern "C" int vv_flash_train_bwd(const void* q, const void* k, const void* v, const void* seg,
                                  const void* o, const void* dout, const void* lse, void* delta,
                                  void* dq, void* dk, void* dv, int dtype, int n_b, int n_t,
                                  int n_h, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VV_FT_BWD(T, D) \
  vv::run_bwd<T, D>(q, k, v, seg, o, dout, lse, delta, dq, dk, dv, n_b, n_t, n_h, scale, s)
  VV_FT_CASES(VV_FT_BWD)
#undef VV_FT_BWD
}

// The tensor-core route: D 64 or 128; dtype f32 (three-term split: the lo
// pointers set) or bf16 (one term: the lo pointers null).
#define VV_FT_TC_CASES(CALL)                                       \
  if (dtype == VV_F32 && d == 128) return CALL(128, true);         \
  if (dtype == VV_F32 && d == 64) return CALL(64, true);           \
  if (dtype == VV_BF16 && d == 128) return CALL(128, false);       \
  if (dtype == VV_BF16 && d == 64) return CALL(64, false);         \
  return (int)cudaErrorInvalidValue;

// The split pass of `count` (1-4) f32 arrays x0..x3 of n elements each (n a
// multiple of 4, 16-byte aligned) into ws, (count, 2, n) bf16: hi, lo.
extern "C" int vv_flash_train_split(const void* x0, const void* x1, const void* x2, const void* x3,
                                    void* ws, int count, int n, void* stream) {
  if (n % 4 || count < 1 || count > 4) return (int)cudaErrorInvalidValue;
  const vv::FtSplitArgs args{{static_cast<const float4*>(x0), static_cast<const float4*>(x1),
                              static_cast<const float4*>(x2), static_cast<const float4*>(x3)}};
  const int want = (n / 4 + 255) / 256;
  const dim3 grid(want < 1 ? 1 : want > 132 * 8 ? 132 * 8 : want, count);
  vv::flash_train_split<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<vv::bf16*>(ws), n);
  return (int)cudaGetLastError();
}

// seg (B, T) int32 -> kfirst, qlast (B, ceil(T / 64)) int32.
extern "C" int vv_flash_train_walk(const void* seg, void* kfirst, void* qlast, int n_b, int n_t,
                                   void* stream) {
  const dim3 grid((n_t + 63) / 64, n_b);
  vv::flash_train_walk<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<int*>(kfirst), static_cast<int*>(qlast), n_t);
  return (int)cudaGetLastError();
}

// qh/ql, kh/kl, vh/vl: (B, T, H, D) bf16, 16-byte aligned (for f32 inputs
// the split of each, for bf16 the inputs and nulls); seg (B, T) int32;
// kfirst (B, ceil(T / 64)) int32, the first key tile of each query tile;
// o (B, T, H, D) in dtype; lse (B, H, T) f32.
extern "C" int vv_flash_train_fwd_tc(const void* qh, const void* ql, const void* kh, const void* kl,
                                     const void* vh, const void* vl, const void* seg,
                                     const void* kfirst, void* o, void* lse, int dtype, int n_b,
                                     int n_t, int n_h, int d, float scale, void* stream) {
  const void* ops[6] = {qh, ql, kh, kl, vh, vl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype == VV_F32) != (ql != nullptr && kl != nullptr && vl != nullptr))
    return (int)cudaErrorInvalidValue;
#define VV_FT_FWD_TC(D, SPLIT) \
  vv::run_fwd_tc<D, SPLIT>(ops, seg, kfirst, o, lse, n_b, n_t, n_h, scale, s)
  VV_FT_TC_CASES(VV_FT_FWD_TC)
#undef VV_FT_FWD_TC
}

// As vv_flash_train_fwd_tc, plus qlast (B, ceil(T / 64)) int32, the last
// query tile of each key tile; o and dout (B, T, H, D) in dtype; dh, dl
// (B, T, H, D) bf16 that receive dO's split (f32), or dout and null (bf16);
// delta (B, H, T) f32 scratch; dq, dk, dv in dtype.
extern "C" int vv_flash_train_bwd_tc(const void* qh, const void* ql, const void* kh, const void* kl,
                                     const void* vh, const void* vl, const void* seg,
                                     const void* kfirst, const void* qlast, const void* o,
                                     const void* dout, void* dh, void* dl, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, int dtype, int n_b,
                                     int n_t, int n_h, int d, float scale, void* stream) {
  const void* ops[8] = {qh, ql, kh, kl, vh, vl, dh, dl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype == VV_F32) != (ql != nullptr && kl != nullptr && vl != nullptr && dl != nullptr))
    return (int)cudaErrorInvalidValue;
#define VV_FT_BWD_TC(D, SPLIT)                                                                    \
  vv::run_bwd_tc<D, SPLIT>(ops, seg, kfirst, qlast, o, dout, lse, delta, dq, dk, dv, n_b, n_t, n_h, \
                           scale, s)
  VV_FT_TC_CASES(VV_FT_BWD_TC)
#undef VV_FT_BWD_TC
}
