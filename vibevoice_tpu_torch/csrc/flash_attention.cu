// Kernel B: causal GQA attention of a W-row query chunk over the persistent
// KV cache, bf16 or int8 rows (flash-decoding: split keys, then combine).
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/flash_attention.py:71
// flash_cached_attention (body `_kernel_zeroed`, :154). Semantics kept:
// query row i of sample b attends keys j <= base[b] + i (clamped to the
// cache), only the valid prefix is read, softmax is online in f32, and for
// int8 rows the per-row K scale multiplies the scores and the V scale
// multiplies the probabilities (flash_attention.py:235, :243).
//
// What bounds it on an H100: at decode the TPU grid (B, KH, q-tiles) is only
// 2 x 2 = 4 programs at bs1, so one block per (b, kv-head) would leave 128
// SMs idle while it streams the whole prefix. Here the key axis is split
// into `kspl`-key ranges (grid.y), each block folds the G query heads of one
// KV head into 16 rows (one K/V read serves all of them), keeps its own
// (m, l, acc) state, and writes it to an f32 workspace; a combine kernel
// merges the splits. Blocks whose key range starts past the tile's causal
// horizon do no reads. Prefill tiles the W*G rows over grid.x instead.
#include "flash_combine.cuh"

namespace vv {

constexpr int FA_QT = 16;       // folded query rows (w * G + g) per block
constexpr int FA_KB = 32;       // keys per shared-memory chunk
constexpr int FA_THREADS = 128;
constexpr int FA_DMAX = 128;    // head_dim <= 128

template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(FA_THREADS)
flash_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ kc,
                   const KVT* __restrict__ vc, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ base,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int W, int NH, int KH, int S, int D, int kspl,
                   float scale) {
  __shared__ float q_s[FA_QT][FA_DMAX];
  __shared__ float k_s[FA_KB][FA_DMAX + 1];  // +1: score reads across lanes hit distinct banks
  __shared__ float v_s[FA_KB][FA_DMAX];
  __shared__ float p_s[FA_QT][FA_KB];
  __shared__ float m_s[FA_QT], l_s[FA_QT], corr_s[FA_QT];
  __shared__ float kscale_s[FA_KB], vscale_s[FA_KB];

  const int tid = threadIdx.x;
  const int bh = blockIdx.z;  // b * KH + kh
  const int b = bh / KH, kh = bh % KH;
  const int G = NH / KH;
  const int R = W * G;
  const int row0 = blockIdx.x * FA_QT;
  const int sp = blockIdx.y;
  const int n_splits = gridDim.y;
  const int bl = base[b];

  // causal horizon of this tile: its last row attends up to bl + last_w
  const int last_w = (min(row0 + FA_QT, R) - 1) / G;
  const int total = min(bl + last_w + 1, S);
  const int kbeg = sp * kspl;
  const int kend = min(kbeg + kspl, total);

  for (int i = tid; i < FA_QT * FA_DMAX; i += FA_THREADS) {
    const int r = i / FA_DMAX, d = i % FA_DMAX;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < R && d < D) {
      const int w = gr / G, g = gr % G;
      val = to_f(q[((size_t)(b * W + w) * NH + kh * G + g) * D + d]) * scale;
    }
    q_s[r][d] = val;
  }
  if (tid < FA_QT) {
    m_s[tid] = FA_M_INIT;
    l_s[tid] = 0.f;
  }
  float acc[FA_QT];
#pragma unroll
  for (int r = 0; r < FA_QT; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t plane = (size_t)bh * S;  // (b, kh) plane of the cache, in rows
  for (int c0 = kbeg; c0 < kend; c0 += FA_KB) {
    for (int i = tid; i < FA_KB * FA_DMAX; i += FA_THREADS) {
      const int j = i / FA_DMAX, d = i % FA_DMAX;
      const int key = c0 + j;
      float kv = 0.f, vv_ = 0.f;
      if (key < kend && d < D) {
        const size_t off = (plane + key) * D + d;
        kv = to_f(kc[off]);
        vv_ = to_f(vc[off]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv_;
    }
    if (tid < FA_KB) {
      const int key = c0 + tid;
      kscale_s[tid] = (QUANT && key < kend) ? ks[plane + key] : 1.f;
      vscale_s[tid] = (QUANT && key < kend) ? vs[plane + key] : 1.f;
    }
    __syncthreads();

    // scores: lane -> key, warp -> 4 rows
    {
      const int j = tid & 31, rg = tid >> 5;
      const int key = c0 + j;
#pragma unroll
      for (int rr = 0; rr < FA_QT / 4; ++rr) {
        const int r = rg * (FA_QT / 4) + rr;
        const int gr = row0 + r;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[j][d], s);
        if (QUANT) s *= kscale_s[j];
        const bool live = gr < R && key < kend && key <= bl + gr / G;
        p_s[r][j] = live ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < FA_QT) {
      const int r = tid;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int j = 0; j < FA_KB; ++j) mx = fmaxf(mx, p_s[r][j]);
      float sum = 0.f;
      for (int j = 0; j < FA_KB; ++j) {
        const float p = expf(p_s[r][j] - mx);  // exp(-inf) = 0 for dead keys
        sum += p;
        p_s[r][j] = QUANT ? p * vscale_s[j] : p;
      }
      const float corr = expf(m_prev - mx);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = mx;
      corr_s[r] = corr;
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < FA_QT; ++r) {
        float a = acc[r] * corr_s[r];
        for (int j = 0; j < FA_KB; ++j) a = fmaf(p_s[r][j], v_s[j][tid], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  const size_t pbase = ((size_t)bh * n_splits + sp) * R;
#pragma unroll
  for (int r = 0; r < FA_QT; ++r) {
    const int gr = row0 + r;
    if (gr < R && tid < D) part_acc[(pbase + gr) * D + tid] = acc[r];
  }
  if (tid < FA_QT && row0 + tid < R) {
    part_m[pbase + row0 + tid] = m_s[tid];
    part_l[pbase + row0 + tid] = l_s[tid];
  }
}

template <typename QT, typename KVT, bool QUANT>
static void run(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                const int* base, void* out, float* ws, int B, int W, int NH, int KH, int S, int D,
                int n_splits, int kspl, float scale, cudaStream_t stream) {
  const int R = W * (NH / KH);
  const size_t n_part = (size_t)B * KH * n_splits * R;
  float* part_acc = ws;
  float* part_m = ws + n_part * D;
  float* part_l = part_m + n_part;
  const dim3 grid((R + FA_QT - 1) / FA_QT, n_splits, B * KH);
  flash_split_kernel<QT, KVT, QUANT><<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k), static_cast<const KVT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), base, part_acc, part_m, part_l,
      W, NH, KH, S, D, kspl, scale);
  flash_combine_kernel<QT><<<dim3(R, B * KH), D, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<QT*>(out), W, NH, KH, D, n_splits);
}

}  // namespace vv

// ws holds B*KH*n_splits*W*G*(D + 2) floats.
extern "C" int vv_flash_cached_attention(const void* q, int q_dtype, const void* k, const void* v,
                                         int kv_dtype, const void* k_scale, const void* v_scale,
                                         const void* base, void* out, void* ws, int B, int W,
                                         int NH, int KH, int S, int D, int n_splits, int kspl,
                                         float scale, void* stream) {
  using namespace vv;
  if (D > FA_DMAX || NH % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bp = static_cast<const int*>(base);
  float* w = static_cast<float*>(ws);
#define VV_FA(QT_, KVT_, QUANT_) \
  run<QT_, KVT_, QUANT_>(q, k, v, k_scale, v_scale, bp, out, w, B, W, NH, KH, S, D, n_splits, kspl, scale, s)
  if (q_dtype == VV_BF16 && kv_dtype == VV_BF16)
    VV_FA(bf16, bf16, false);
  else if (q_dtype == VV_BF16 && kv_dtype == VV_I8)
    VV_FA(bf16, int8_t, true);
  else if (q_dtype == VV_F32 && kv_dtype == VV_F32)
    VV_FA(float, float, false);
  else if (q_dtype == VV_F32 && kv_dtype == VV_I8)
    VV_FA(float, int8_t, true);
  else
    return (int)cudaErrorInvalidValue;
#undef VV_FA
  return (int)cudaGetLastError();
}
