// Kernel H: a dense causal 1-D convolution over channels-last (B, T, C)
// activations as an implicit GEMM: the tokenizers' full-sequence
// down-sampling convs (kernel 2s, stride s), their head, the decoder's first
// conv, and (k 1, the weight in a linear's (C_in, C_out) layout) the Block1D
// FFN linears of a full-sequence encode or decode:
//
//   y[b, t, o] = round(sum_{i, j} x[b, t s - left + j, i] * w[o, i, j]) (+ bias[o])
//
// rows outside [0, T_in) read as zero (the causal left pad and the right
// "extra" pad, formed by index: nothing is padded or copied in memory), the
// C_in k products summed in f32, rounded once to the activations' dtype,
// then the bias added in that dtype (as ops/conv.py's plain versions, the
// port's dense linears and the JAX package).
//
// Replaces no TPU kernel: the JAX package leaves these convolutions and
// linears to XLA (vibevoice_tpu/ops/conv.py causal_conv1d,
// vibevoice_tpu/models/tokenizer.py _block_apply). It was added because the
// library routes set themselves up per shape, and a voice prompt brings new
// shapes with almost every request: on an H100 inside the serving engine
// cuDNN planned each conv in about 3-5 ms of host time, and cuBLAS stalled
// for 110-170 ms at some shapes it had not met (the FFN linears' most of
// all). This kernel keeps nothing between calls: one launch (two with split
// K), whatever the length.
//
// What bounds it on an H100: at a 10 s voice pair's stage-0 shapes bytes
// (the down-sampling conv 2 x 240,000 x 32 -> 2 x 120,000 x 64 reads and
// writes 46 MB: 0.014 ms); at the last stages' operations (1e10 for the
// last down-sampling conv: 0.010 ms at 989 TFLOP/s bf16). The design: the
// GEMM (M = B T_out rows, N = C_out, K = C_in k, K ordered channel by tap
// as w is laid out) in 128 x 64 tiles, 8 warps each holding 32 x 32 f32
// sums of bf16 mma.sync m16n8k16 (bf16 products are exact in f32), K in
// steps of 32 through shared memory, the next step loaded into registers
// while the tensor cores work. The x tile is read as 16-byte rows where it
// is a plain row (k 1) and gathered from the windows by index otherwise (a
// thread takes one K column, so one division a step); the w tile is read
// in 16-byte pieces along K (along N in a linear's layout). f32
// activations take the same tiling on CUDA cores (64 x 64 tiles, 4 x 4
// sums a thread, K steps of 16). A long K is split over the blocks by K
// alone (ops/conv.py _dense_plan), so that an output's bits do not depend
// on the call's rows, and a second launch adds each output's partial sums
// in split order, rounds and adds the bias.
#include <type_traits>

#include "common.cuh"

namespace vv {
namespace dconv {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;  // f32, CUDA cores
constexpr int TBM = 128, TBN = 64, TBK = 32, TPAD = 8;     // bf16, tensor cores

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dense_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ part,
                      int t_in, int c_in, int c_out, int k, int stride, int left, int t_out,
                      long long m_total, int k_per_split, bool w_kn) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;  // row tiles on x: no 65,535 limit
  const int n0 = blockIdx.y * BN;
  const int kdim = c_in * k;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(kdim, kb + k_per_split);

  // this thread's row of the x tile: its sample and first input row
  const int am = tid % BM;
  const long long m = m0 + am;
  const bool m_ok = m < m_total;
  const long long b = m_ok ? m / t_out : 0;
  const int row0 = m_ok ? (int)(m % t_out) * stride - left : 0;
  const T* xb = x + b * t_in * c_in;
  // this thread's slice of the w tile: K index tid % BK of columns n
  const int bk = tid % BK;

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) {
      const int kl = tid / BM + 4 * r;
      const int kk = k0 + kl;
      float v = 0.f;
      if (m_ok && kk < ke) {
        const int i = kk / k, row = row0 + (kk - i * k);
        if (row >= 0 && row < t_in) v = to_f(xb[(long long)row * c_in + i]);
      }
      as[kl][am] = v;
    }
#pragma unroll
    for (int r = 0; r < BN / 16; ++r) {
      const int nl = tid / BK + 16 * r;
      const int n = n0 + nl, kk = k0 + bk;
      bs[bk][nl] = (n < c_out && kk < ke)
                       ? to_f(w[w_kn ? (long long)kk * c_out + n : (long long)n * kdim + kk])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kl = 0; kl < BK; ++kl) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kl][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&bs[kl][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mi = m0 + ty * 4 + i;
    if (mi >= m_total) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= c_out) break;
      if (part) {
        part[((long long)blockIdx.z * m_total + mi) * c_out + n] = acc[i][j];
      } else {
        float o = round_to<T>(acc[i][j]);
        if (bias) o = round_to<T>(o + to_f(bias[n]));
        y[mi * c_out + n] = from_f<T>(o);
      }
    }
  }
}

static __device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
static __device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 route: a block of 256 threads owns a 128 x 64 tile of y, warp w
// rows 32 (w % 4) and columns 32 (w / 4) of it (2 x 4 mma tiles). vec_x: x
// read as 16-byte row pieces (k 1, C_in a multiple of 8, aligned); else
// gathered, a thread taking one K column of the tile and 16 of its rows;
// vec_w: w read as 16-byte pieces (along K, or along N where w_kn). The
// next K step's pieces are loaded into registers while the tensor cores
// work on the step in shared memory.
__global__ void __launch_bounds__(THREADS)
    dense_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ y,
                         float* __restrict__ part, int t_in, int c_in, int c_out, int k, int stride,
                         int left, int t_out, long long m_total, int k_per_split, bool w_kn,
                         bool vec_x, bool vec_w) {
  __shared__ __align__(16) bf16 as[TBM][TBK + TPAD];
  __shared__ __align__(16) bf16 bs[TBN][TBK + TPAD];
  __shared__ long long xoff[TBM];  // a tile row's sample in x, -1 past the last row
  __shared__ int xrow[TBM];        // and its first input row, t s - left
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4, wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  const long long m0 = (long long)blockIdx.x * TBM;
  const int n0 = blockIdx.y * TBN;
  const int kdim = c_in * k;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(kdim, kb + k_per_split);
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (tid < TBM) {
    const long long m = m0 + tid;
    xoff[tid] = m < m_total ? (m / t_out) * t_in * c_in : -1;
    xrow[tid] = m < m_total ? (int)(m % t_out) * stride - left : 0;
  }
  __syncthreads();

  uint4 ra[2], rb;  // the next step's 16-byte pieces of x and w
  bf16 ga[TBK / 2], gb[TBN * TBK / THREADS];  // or its gathered elements
  auto load = [&](int k0) {
    if (vec_x) {  // rows tid / 4 and 64 + tid / 4, piece tid % 4
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = r * (TBM / 2) + tid / 4, kk = k0 + 8 * (tid % 4);
        const int row = xrow[tr];
        ra[r] = make_uint4(0, 0, 0, 0);
        if (xoff[tr] >= 0 && row >= 0 && row < t_in && kk < ke)
          ra[r] = *reinterpret_cast<const uint4*>(x + xoff[tr] + (long long)row * c_in + kk);
      }
    } else {  // K column tid % 32, rows tid / 32 + 8 q
      const int kk = k0 + tid % TBK;
      const int i = kk / k, j = kk - i * k;
#pragma unroll
      for (int q = 0; q < TBK / 2; ++q) {
        const int tr = tid / TBK + 8 * q, row = xrow[tr] + j;
        ga[q] = (kk < ke && xoff[tr] >= 0 && row >= 0 && row < t_in)
                    ? x[xoff[tr] + (long long)row * c_in + i]
                    : zero;
      }
    }
    if (vec_w && !w_kn) {  // 64 rows of w x 4 pieces along K
      const int n = n0 + tid / 4, kk = k0 + 8 * (tid % 4);
      rb = make_uint4(0, 0, 0, 0);
      if (n < c_out && kk < ke) rb = *reinterpret_cast<const uint4*>(w + (long long)n * kdim + kk);
    } else if (vec_w) {  // a linear's (K, N): 32 rows of K x 8 pieces along N
      const int kk = k0 + tid / 8, n = n0 + 8 * (tid % 8);
      rb = make_uint4(0, 0, 0, 0);
      if (kk < ke && n < c_out) rb = *reinterpret_cast<const uint4*>(w + (long long)kk * c_out + n);
    } else {
#pragma unroll
      for (int r = 0; r < TBN * TBK / THREADS; ++r) {
        const int e = tid + THREADS * r, n = n0 + e / TBK, kk = k0 + e % TBK;
        gb[r] = (n < c_out && kk < ke)
                    ? w[w_kn ? (long long)kk * c_out + n : (long long)n * kdim + kk]
                    : zero;
      }
    }
  };
  auto store = [&]() {
    if (vec_x) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint4*>(&as[r * (TBM / 2) + tid / 4][8 * (tid % 4)]) = ra[r];
    } else {
#pragma unroll
      for (int q = 0; q < TBK / 2; ++q) as[tid / TBK + 8 * q][tid % TBK] = ga[q];
    }
    if (vec_w && !w_kn) {
      *reinterpret_cast<uint4*>(&bs[tid / 4][8 * (tid % 4)]) = rb;
    } else if (vec_w) {
      const bf16* e = reinterpret_cast<const bf16*>(&rb);
#pragma unroll
      for (int q = 0; q < 8; ++q) bs[8 * (tid % 8) + q][tid / 8] = e[q];
    } else {
#pragma unroll
      for (int r = 0; r < TBN * TBK / THREADS; ++r) {
        const int e = tid + THREADS * r;
        bs[e / TBK][e % TBK] = gb[r];
      }
    }
  };

  float acc[2][4][4] = {};
  if (kb < ke) load(kb);
  for (int k0 = kb; k0 < ke; k0 += TBK) {
    store();
    __syncthreads();
    if (k0 + TBK < ke) load(k0 + TBK);
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        a[mi][0] = ld_u32(&as[r][ks + 2 * c]);
        a[mi][1] = ld_u32(&as[r + 8][ks + 2 * c]);
        a[mi][2] = ld_u32(&as[r][ks + 2 * c + 8]);
        a[mi][3] = ld_u32(&as[r + 8][ks + 2 * c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + 8 * ni + g;
        const uint32_t b0 = ld_u32(&bs[n][ks + 2 * c]), b1 = ld_u32(&bs[n][ks + 2 * c + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm + 16 * mi + g + 8 * h;
      if (m >= m_total) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + 8 * ni + 2 * c + q;
          if (n >= c_out) continue;
          const float v = acc[mi][ni][2 * h + q];
          if (part) {
            part[((long long)blockIdx.z * m_total + m) * c_out + n] = v;
          } else {
            float o = round_bf16(v);
            if (bias) o = round_bf16(o + __bfloat162float(bias[n]));
            y[m * c_out + n] = __float2bfloat16_rn(o);
          }
        }
    }
}

// The split-K partials (splits, M, N) added in split order, rounded once,
// then the bias.
template <typename T>
__global__ void dense_conv_reduce(const float* __restrict__ part, const T* __restrict__ bias,
                                  T* __restrict__ y, long long mn, int c_out, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float s = part[e];
  for (int z = 1; z < splits; ++z) s += part[z * mn + e];
  float o = round_to<T>(s);
  if (bias) o = round_to<T>(o + to_f(bias[e % c_out]));
  y[e] = from_f<T>(o);
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* bias, void* y, void* part, int batch,
                int t_in, int c_in, int c_out, int k, int stride, int left, int t_out, int splits,
                bool w_kn, cudaStream_t s) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr int tm = tc ? TBM : BM, tn = tc ? TBN : BN, tk = tc ? TBK : BK;
  const long long m_total = (long long)batch * t_out;
  const int kdim = c_in * k;
  const int kps = ((kdim + splits - 1) / splits + tk - 1) / tk * tk;
  if ((long long)(splits - 1) * kps >= kdim) return cudaErrorInvalidValue;  // an empty split
  const long long m_tiles = (m_total + tm - 1) / tm;
  if (m_tiles > 0x7fffffffLL || (c_out + tn - 1) / tn > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)m_tiles, (c_out + tn - 1) / tn, splits);
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  if constexpr (tc) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec_x = k == 1 && c_in % 8 == 0 && aligned(x);
    const bool vec_w = (w_kn ? c_out : kdim) % 8 == 0 && aligned(w);
    dense_conv_tc_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
        static_cast<bf16*>(y), pp, t_in, c_in, c_out, k, stride, left, t_out, m_total, kps, w_kn,
        vec_x, vec_w);
  } else {
    dense_conv_kernel<T><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
        static_cast<T*>(y), pp, t_in, c_in, c_out, k, stride, left, t_out, m_total, kps, w_kn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = m_total * c_out;
  dense_conv_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const T*>(bias), static_cast<T*>(y), mn, c_out,
      splits);
  return cudaGetLastError();
}

}  // namespace dconv
}  // namespace vv

// x (batch, t_in, c_in) and y (batch, t_out, c_out) contiguous, w (c_out,
// c_in, k) contiguous or, where w_kn (k 1 only), a linear's (c_in, c_out),
// bias (c_out, or null), all in x's dtype; part an f32 workspace of splits x
// batch t_out x c_out when splits > 1 (ops/conv.py _dense_plan; a split
// left empty once its K is rounded up to whole K steps is refused).
extern "C" int vv_dense_conv1d(const void* x, int dtype, const void* w, int w_kn,
                               const void* bias, void* y, void* part, int batch, int t_in,
                               int c_in, int c_out, int k, int stride, int left, int t_out,
                               int splits, void* stream) {
  if (batch <= 0 || t_in <= 0 || c_in <= 0 || c_out <= 0 || k < 1 || stride < 1 || left < 0 ||
      t_out <= 0 || splits < 1 || (splits > 1 && !part) || (w_kn && k != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VV_BF16)
    return (int)vv::dconv::run<vv::bf16>(x, w, bias, y, part, batch, t_in, c_in, c_out, k, stride,
                                         left, t_out, splits, w_kn != 0, s);
  if (dtype == VV_F32)
    return (int)vv::dconv::run<float>(x, w, bias, y, part, batch, t_in, c_in, c_out, k, stride,
                                      left, t_out, splits, w_kn != 0, s);
  return (int)cudaErrorInvalidValue;
}
