// Split-K GEMV/GEMM core shared by kernels A (int8_matmul), C (fused head
// FFN stack) and D (fused vocoder stage).
//
//   partial[s, m, r, n] = sum_{k in split s} a[r, k] * W_m[k, n]      (f32)
//   out[r, n]           = epilogue(r, n, sum_s partial[s, :, r, n])
//
// What bounds it on an H100: at decode the rows are 1-8 and every weight
// byte is used for at most 8 FMAs per matrix, so the kernel is bound by the
// weight stream from HBM. The design spreads that stream over all 132 SMs:
// each block owns a 128-column slice (32 lanes x 4 adjacent columns, one
// 4-byte int8 / 8-byte bf16 / 16-byte f32 vector load per lane per k, so a
// warp reads one contiguous 128..512-byte run of a weight row) and a slice of
// K (split-K), chosen by the host so that the grid holds >= 2 waves of
// blocks. The 8 warps of a block take interleaved k rows; their sums meet in
// shared memory, the splits meet in the f32 `partial` buffer, and a second
// small kernel applies the per-column scale (after the sum, as the TPU
// kernel does) and the fused epilogue. Dequantization is a register convert;
// no dequantized matrix is ever written.
#pragma once

#include "common.cuh"

namespace vv {

constexpr int GEMV_THREADS = 256;  // 8 warps
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_COLS = 128;     // columns per block: 32 lanes x 4
constexpr int GEMV_RT = 8;         // rows per block (blockIdx.z tiles the rows)
constexpr int GEMV_KC = 32;        // k rows of `a` staged in shared memory per step

// a: (R, K) row-major; w0/w1: (K, N) row-major; partial: (splits, NMAT, R, N).
// ROUND_A rounds each a element to bf16 first (kernel A's x.astype(bf16)).
template <typename AT, typename WT, int NMAT, bool ROUND_A>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_partial_kernel(const AT* __restrict__ a, const WT* __restrict__ w0,
                    const WT* __restrict__ w1, float* __restrict__ partial, int R,
                    int K, int N, int kps) {
  __shared__ float a_s[GEMV_RT][GEMV_KC];
  __shared__ float red[GEMV_WARPS][GEMV_RT][GEMV_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMV_COLS + lane * 4;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * GEMV_RT;
  const int nr = min(GEMV_RT, R - r0);
  const int kb = split * kps;
  const int ke = min(K, kb + kps);
  const bool col_ok = n0 < N;  // N % 4 == 0, so a lane's 4 columns are all in or all out

  float acc[NMAT][GEMV_RT][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < GEMV_RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GEMV_KC) {
    for (int i = threadIdx.x; i < GEMV_RT * GEMV_KC; i += GEMV_THREADS) {
      const int r = i / GEMV_KC, kk = i % GEMV_KC;
      float v = 0.f;
      if (r < nr && k0 + kk < ke) {
        v = to_f(a[(size_t)(r0 + r) * K + k0 + kk]);
        if (ROUND_A) v = round_bf16(v);
      }
      a_s[r][kk] = v;
    }
    __syncthreads();
    if (col_ok) {
      for (int kk = warp; kk < GEMV_KC; kk += GEMV_WARPS) {
        const int k = k0 + kk;
        if (k >= ke) break;
        float wv[NMAT][4];
        load4(w0 + (size_t)k * N + n0, wv[0]);
        if (NMAT > 1) load4(w1 + (size_t)k * N + n0, wv[NMAT - 1]);
#pragma unroll
        for (int r = 0; r < GEMV_RT; ++r) {
          if (r < nr) {
            const float av = a_s[r][kk];
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[m][r][c] = fmaf(av, wv[m][c], acc[m][r][c]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < NMAT; ++m) {
#pragma unroll
    for (int r = 0; r < GEMV_RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[m][r][c];
    __syncthreads();
    for (int i = threadIdx.x; i < GEMV_RT * GEMV_COLS; i += GEMV_THREADS) {
      const int r = i / GEMV_COLS, c = i % GEMV_COLS;
      const int n = blockIdx.x * GEMV_COLS + c;
      if (r < nr && n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < GEMV_WARPS; ++w) s += red[w][r][c];
        partial[((size_t)(split * NMAT + m) * R + r0 + r) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

template <int NMAT, class Epi>
__global__ void gemv_finalize_kernel(const float* __restrict__ partial, int splits, int R,
                                     int N, Epi epi) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * N) return;
  const int r = (int)(idx / N), n = (int)(idx % N);
  float acc[NMAT];
#pragma unroll
  for (int m = 0; m < NMAT; ++m) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[((size_t)(sp * NMAT + m) * R + r) * N + n];
    acc[m] = s;
  }
  epi(r, n, acc);
}

template <typename AT, typename WT, int NMAT, bool ROUND_A, class Epi>
void launch_gemv(const AT* a, const WT* w0, const WT* w1, float* partial, int R, int K, int N,
                 int splits, int kps, Epi epi, cudaStream_t stream) {
  const dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, splits, (R + GEMV_RT - 1) / GEMV_RT);
  gemv_partial_kernel<AT, WT, NMAT, ROUND_A>
      <<<grid, GEMV_THREADS, 0, stream>>>(a, w0, w1, partial, R, K, N, kps);
  const size_t total = (size_t)R * N;
  const int threads = 256;
  gemv_finalize_kernel<NMAT, Epi>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(partial, splits, R, N,
                                                                            epi);
}

// Per-column dequant scale; null for dense weights.
static __device__ __forceinline__ float col_scale(const float* s, int n) {
  return s ? s[n] : 1.f;
}

}  // namespace vv
