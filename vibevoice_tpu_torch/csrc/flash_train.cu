// Training flash attention: the no-cache causal attention of the Qwen2 LM in
// fine-tuning, forward and backward.
//
// Replaces the differentiable Pallas TPU flash attention bundled with JAX
// (jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel and the
// dK/dV and dQ backward kernels) that vibevoice_tpu/models/qwen2.py:284
// _attention_train_flash calls. Semantics kept: causal attention within
// segment ids, key j is live for query i iff j <= i and seg[j] == seg[i]
// (valid = 1, pad = 0, so valid rows see exactly the valid causal prefix),
// scores scaled by sm_scale, softmax in f32.
//
// What bounds it: the (B, H, T, T) f32 score tensor of the masked path is
// 3.2 GB per layer at T = 8192, B = 1, 12 heads, and autograd keeps it (or
// the probabilities) for each of 28 layers. These kernels never write it:
// the forward keeps an online softmax per query row and stores O and the row
// log-sum-exp; the backward (FlashAttention-2 style) recomputes the
// probabilities tile by tile from the LSE. Layout is the model's own
// (B, T, H, D), so no transposes surround the call. GQA is handled by the
// caller (K/V repeated to the query heads).
//
// Kernels, each with 256 threads as a 16 x 16 grid, tiles of 64 rows
// (attn_tile.cuh):
//   flash_train_fwd   one block per (64-query tile, head, batch), loops over
//                     the key tiles up to the diagonal;
//   flash_train_delta one warp per row: delta = rowsum(dO * O);
//   flash_train_dkdv  one block per 64-key tile, loops over query tiles from
//                     the diagonal to the end, accumulating dK and dV;
//   flash_train_dq    one block per 64-query tile, loops over key tiles up to
//                     the diagonal, accumulating dQ (no atomics).
// Arithmetic is f32 on CUDA cores (tensor cores are later work); inputs are
// f32 or bf16 and are widened to f32 on the way into shared memory, whose
// rows are padded to D + 1 floats so that the reads below are free of bank
// conflicts. D is 16, 32, 64 or 128; any T (the last tile is masked).
#include <climits>
#include <math.h>

#include "attn_tile.cuh"
#include "common.cuh"

namespace vv {
namespace {

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
    flash_train_delta(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int n_b, int n_t, int n_h) {
  const long row = (long)blockIdx.x * (ATT_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long)n_b * n_t * n_h) return;
  const int h = row % n_h;
  const long bt = row / n_h;
  const int t = bt % n_t, b = bt / n_t;
  const size_t off = (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[off + d]) * to_f(dout[off + d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[((size_t)b * n_h + h) * n_t + t] = s;
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
  flash_train_delta<T, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), ATT_THREADS,
                            0, stream>>>(static_cast<const T*>(o), dop, dp, n_b, n_t, n_h);
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

// One case per (dtype, head dim): D is 16, 32, 64 or 128 (the 1.5B and 7B
// models have 128, the 0.5B 64, the test configs 16).
#define VV_FT_CASES(CALL)                                          \
  if (dtype == VV_F32 && d == 128) return CALL(float, 128);        \
  if (dtype == VV_F32 && d == 64) return CALL(float, 64);          \
  if (dtype == VV_F32 && d == 32) return CALL(float, 32);          \
  if (dtype == VV_F32 && d == 16) return CALL(float, 16);          \
  if (dtype == VV_BF16 && d == 128) return CALL(vv::bf16, 128);    \
  if (dtype == VV_BF16 && d == 64) return CALL(vv::bf16, 64);      \
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
