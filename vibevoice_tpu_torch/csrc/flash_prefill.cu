// Kernel B over prefill chunks (W > 1): causal GQA attention of a W-row
// query chunk over the persistent KV cache on tensor cores, bf16 q with
// bf16 or int8 K/V.
//
// Replaces the Pallas TPU kernel vibevoice_tpu/ops/flash_attention.py:71
// flash_cached_attention (body `_kernel_zeroed`, :154) for chunks; decode
// (W = 1) and f32 q take flash_decode.cu. Semantics kept: query row i of
// sample b attends keys j <= base[b] + i, clamped to the cache (pad rows
// attend like valid rows); the softmax is online in f32; for int8 rows the K
// row scale multiplies the score columns after the product and the V row
// scale multiplies the probabilities before P.V (int8 -> bf16 is exact).
//
// What bounds it on an H100: the two products. W = 512 over a 65,536-slot
// int8 cache with bases (65535, 20000) is 2.7e11 FLOP of causal work, 0.27
// ms at the 989 TFLOP/s bf16 peak, against 34 MB of K/V (0.01 ms). The
// TPU kernel does that work as two MXU matmuls per key block
// (flash_attention.py:231-246); here:
//   - one block per (sample, KV head, tile of 64 folded rows w * G + g,
//     key split): GQA is folded into the rows, so every K/V tile read
//     serves all G query heads; 4 warps of 16 rows each;
//   - the Q tile stays in registers as mma fragments; the softmax scale is
//     applied to the f32 scores (in log2 units for exp2);
//   - K/V tiles of 64 keys stream through a 2-stage cp.async ring (int8
//     tiles land as int8 and are converted to bf16 in shared memory);
//   - S = Q K^T and O += P V are bf16 mma.sync m16n8k16 with f32
//     accumulators, P rounded to bf16 from registers (FlashAttention-2
//     style), V through ldmatrix.trans;
//   - only tiles that cross a row's horizon are masked, and key tiles past
//     the tile's horizon are never read (the causal triangle);
//   - where (sample, KV head, row tile) blocks fill under two waves of the
//     132 SMs, each tile's key range is split evenly and the splits are
//     merged by flash_combine_kernel (flash_combine.cuh).
#include "flash_combine.cuh"
#include "mma.cuh"

namespace vv {
namespace {

constexpr int P_BR = 64;  // folded query rows per block (4 warps x 16)
constexpr int P_BC = 64;  // keys per tile
constexpr int P_THREADS = 128;
constexpr float P_LOG2E = 1.4426950408889634f;

template <int D, bool QUANT>
struct PrefillSmem {
  static constexpr int Q = P_BR * D * 2;           // the bf16 Q tile
  static constexpr int TILE = P_BC * D * 2;        // one bf16 K or V tile
  static constexpr int TILE8 = P_BC * D;           // one int8 K or V tile
  static constexpr int STAGE8 = 2 * TILE8 + 2 * P_BC * 4;  // int8 K, V and their row scales
  // bf16 K/V: two stages of (K, V), or for int8 one converted (K, V) plus
  // two int8 staging stages
  static constexpr int KV = (QUANT ? 2 : 4) * TILE;
  static constexpr int BYTES = Q + KV + (QUANT ? 2 * STAGE8 : 0);
};

template <int D, bool QUANT>
__global__ void __launch_bounds__(P_THREADS)
    flash_prefill_kernel(const bf16* __restrict__ q, const void* __restrict__ kc_,
                         const void* __restrict__ vc_, const float* __restrict__ ksc,
                         const float* __restrict__ vsc, const int* __restrict__ base,
                         bf16* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_m, float* __restrict__ part_l, int W, int NH,
                         int KH, int S, float scale_log2) {
  using SM = PrefillSmem<D, QUANT>;
  constexpr int NCH = D / 8;  // 16-byte chunks of a bf16 row
  extern __shared__ __align__(128) uint8_t p_smem[];
  uint8_t* kv = p_smem + SM::Q;
  uint8_t* stg = kv + SM::KV;
  const uint32_t qs_u = smem_u32(p_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z, b = bh / KH, kh = bh % KH;
  const int G = NH / KH, R = W * G;
  const int row0 = blockIdx.x * P_BR;
  const int sp = blockIdx.y, n_splits = gridDim.y;
  const int bl = base[b];
  const int total = min(bl + (min(row0 + P_BR, R) - 1) / G + 1, S);  // keys [0, total) live
  const int nblk = (total + P_BC - 1) / P_BC;
  const int ns = min(n_splits, nblk);
  const size_t pbase = ((size_t)bh * n_splits + sp) * R;
  if (sp >= ns) {  // the horizon holds fewer key tiles than splits: an empty split
    for (int r = tid; r < P_BR; r += P_THREADS)
      if (row0 + r < R) {
        part_m[pbase + row0 + r] = FA_M_INIT;
        part_l[pbase + row0 + r] = 0.f;
      }
    for (int i = tid; i < P_BR * D; i += P_THREADS)
      if (row0 + i / D < R) part_acc[(pbase + row0) * D + i] = 0.f;
    return;
  }
  const int jb = sp * nblk / ns, je = (sp + 1) * nblk / ns;  // this split's key tiles

  const bf16* kc = static_cast<const bf16*>(kc_);
  const bf16* vc = static_cast<const bf16*>(vc_);
  const int8_t* kc8 = static_cast<const int8_t*>(kc_);
  const int8_t* vc8 = static_cast<const int8_t*>(vc_);
  auto load_kv = [&](int s, int j) {
    const int k0 = j * P_BC;
    if constexpr (!QUANT) {
      const uint32_t kd = smem_u32(kv + 2 * s * SM::TILE), vd = kd + SM::TILE;
      for (int i = tid; i < P_BC * NCH; i += P_THREADS) {
        const int r = i / NCH, ch = i % NCH, key = k0 + r;
        const bool ok = key < S;
        const size_t off = ((size_t)bh * S + key) * D + ch * 8;
        cp_async16(kd + tile_off<D>(r, ch), ok ? kc + off : kc, ok ? 16 : 0);
        cp_async16(vd + tile_off<D>(r, ch), ok ? vc + off : vc, ok ? 16 : 0);
      }
    } else {
      const uint32_t kd = smem_u32(stg + s * SM::STAGE8), vd = kd + SM::TILE8;
      for (int i = tid; i < P_BC * D / 16; i += P_THREADS) {
        const int r = i / (D / 16), ch = i % (D / 16), key = k0 + r;
        const bool ok = key < S;
        const size_t off = ((size_t)bh * S + key) * D + ch * 16;
        cp_async16(kd + r * D + ch * 16, ok ? kc8 + off : kc8, ok ? 16 : 0);
        cp_async16(vd + r * D + ch * 16, ok ? vc8 + off : vc8, ok ? 16 : 0);
      }
      if (tid < P_BC) {
        const int key = k0 + tid;
        const bool ok = key < S;
        const size_t off = (size_t)bh * S + key;
        cp_async4(vd + SM::TILE8 + tid * 4, ok ? ksc + off : ksc, ok ? 4 : 0);
        cp_async4(vd + SM::TILE8 + (P_BC + tid) * 4, ok ? vsc + off : vsc, ok ? 4 : 0);
      }
    }
  };

  // Q tile (rows past R are zero), then the first K/V tile
  for (int i = tid; i < P_BR * NCH; i += P_THREADS) {
    const int r = i / NCH, ch = i % NCH, gr = row0 + r;
    const bool ok = gr < R;
    const bf16* src = q;
    if (ok) src = q + ((size_t)(b * W + gr / G) * NH + kh * G + gr % G) * D + ch * 8;
    cp_async16(qs_u + tile_off<D>(r, ch), src, ok ? 16 : 0);
  }
  cp_async_commit();
  load_kv(0, jb);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs_u + tile_off<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int lim_a = bl + ra / G, lim_b = bl + rb / G;  // last live key of each row
  const int lim_min = bl + row0 / G;                   // the tile's smallest
  float m_a = FA_M_INIT, m_b = FA_M_INIT, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int j = jb; j < je; ++j) {
    const int s = (j - jb) & 1;
    cp_async_wait<0>();  // tile j has landed
    __syncthreads();     // for every thread, and tile j - 1 is no longer read
    if (j + 1 < je) load_kv(s ^ 1, j + 1);
    cp_async_commit();
    const uint8_t* kt = kv + 2 * s * SM::TILE;
    const float* kss = nullptr;
    const float* vss = nullptr;
    if constexpr (QUANT) {
      const uint8_t* st = stg + s * SM::STAGE8;
      for (int i = tid; i < 2 * P_BC * D / 16; i += P_THREADS) {  // K rows, then V rows
        const int t = i / (P_BC * D / 16), rem = i % (P_BC * D / 16);
        const int r = rem / (D / 16), c16 = rem % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(st + t * SM::TILE8 + r * D + c16 * 16);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f[4];
          i8x4_to_f32(words[e], f);
          h[2 * e] = bf16x2_exact(f[0], f[1]);
          h[2 * e + 1] = bf16x2_exact(f[2], f[3]);
        }
        uint8_t* dst = kv + t * SM::TILE;
        *reinterpret_cast<uint4*>(dst + tile_off<D>(r, 2 * c16)) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dst + tile_off<D>(r, 2 * c16 + 1)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      kss = reinterpret_cast<const float*>(st + 2 * SM::TILE8);
      vss = kss + P_BC;
      kt = kv;
      __syncthreads();
    }
    const uint32_t kt_u = smem_u32(kt), vt_u = kt_u + SM::TILE;

    // S = Q K^T: 16 rows x 64 keys per warp
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt_u + tile_off<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                           2 * kk + ((lane >> 3) & 1)));
        mma_bf16_16816(sc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale (and K row scale), mask where the tile crosses a horizon
    const int k0 = j * P_BC;
    const bool masked = k0 + P_BC - 1 > lim_min || k0 + P_BC > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = n * 8 + 2 * (lane & 3) + (v & 1);
        float x = sc[n][v] * scale_log2;
        if (QUANT) x *= kss[c];
        if (masked && (k0 + c > (v < 2 ? lim_a : lim_b) || k0 + c >= S)) x = -INFINITY;
        sc[n][v] = x;
      }

    // online softmax (log2 units); rows a and b are shared by 4 lanes
    float mx_a = m_a, mx_b = m_b;
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float p = exp2f(sc[n][v] - (v < 2 ? m_a : m_b));  // 0 for a dead key
        if (v < 2)
          l_a += p;
        else
          l_b += p;
        if (QUANT) p *= vss[n * 8 + 2 * (lane & 3) + (v & 1)];
        sc[n][v] = p;
      }

    // O += P V: P (bf16) from registers, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt_u + tile_off<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                 2 * dp + (lane >> 4)));
        mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const int rows[2] = {ra, rb};
  const float ls[2] = {l_a, l_b}, ms[2] = {m_a, m_b};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = rows[h];
    if (gr >= R) continue;
    if (n_splits == 1) {
      const float inv = 1.f / ls[h];  // key 0 is live for every row
      bf16* dst = out + ((size_t)(b * W + gr / G) * NH + kh * G + gr % G) * D + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack_bf16(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
    } else {
      float* dst = part_acc + (pbase + gr) * D + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
      if ((lane & 3) == 0) {
        part_m[pbase + gr] = ms[h] / P_LOG2E;  // natural-log units for the merge
        part_l[pbase + gr] = ls[h];
      }
    }
  }
}

template <int D, bool QUANT>
cudaError_t run_prefill(const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, const int* base, void* out, float* ws, int B, int W,
                        int NH, int KH, int S, int n_splits, float scale, cudaStream_t stream) {
  using SM = PrefillSmem<D, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
  if (err != cudaSuccess) return err;
  const int R = W * (NH / KH);
  const size_t n_part = (size_t)B * KH * n_splits * R;
  float* part_acc = ws;
  float* part_m = ws + n_part * D;
  float* part_l = part_m + n_part;
  const dim3 grid((R + P_BR - 1) / P_BR, n_splits, B * KH);
  flash_prefill_kernel<D, QUANT><<<grid, P_THREADS, SM::BYTES, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), base, static_cast<bf16*>(out), part_acc, part_m, part_l, W,
      NH, KH, S, scale * P_LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_combine_kernel<bf16><<<dim3(R, B * KH), D, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<bf16*>(out), W, NH, KH, D, n_splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vv

// q (B, W, NH, D) bf16; K/V (B, KH, S, D) bf16 (kv_dtype 1) or int8 with row
// scales (B, KH, 1, S) f32 (kv_dtype 2); base (B,) int32; out like q. With
// n_splits > 1, ws holds B*KH*n_splits*W*G*(D + 2) floats.
extern "C" int vv_flash_prefill(const void* q, const void* k, const void* v, int kv_dtype,
                                const void* k_scale, const void* v_scale, const void* base,
                                void* out, void* ws, int B, int W, int NH, int KH, int S, int D,
                                int n_splits, float scale, void* stream) {
  using namespace vv;
  if (NH % KH != 0 || n_splits < 1 || W < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bp = static_cast<const int*>(base);
  float* w = static_cast<float*>(ws);
#define VV_FP(D_, QUANT_)                                                                       \
  return (int)run_prefill<D_, QUANT_>(q, k, v, k_scale, v_scale, bp, out, w, B, W, NH, KH, S, \
                                      n_splits, scale, s)
  if (D == 128 && kv_dtype == VV_BF16) VV_FP(128, false);
  if (D == 128 && kv_dtype == VV_I8) VV_FP(128, true);
  if (D == 64 && kv_dtype == VV_BF16) VV_FP(64, false);
  if (D == 64 && kv_dtype == VV_I8) VV_FP(64, true);
#undef VV_FP
  return (int)cudaErrorInvalidValue;
}
