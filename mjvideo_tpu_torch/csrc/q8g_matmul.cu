// K6 and K7: the grouped w8a8 matmul on Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of mjvideo_tpu/ops/quant.py:
//   K6  _q8g_matmul_pallas_fused (:316, call :376): x (M, K) bf16 is
//       quantized inside the kernel, per (row, group): amax over the g
//       columns of the group, a_s = max(amax / 127, 1e-12), xq = clip(
//       round(x / a_s), -127, 127); out = sum over groups of
//       (float(xq_g . wq_g) * a_s) * w_s[g], written once at bf16 or fp32.
//   K7  _q8g_matmul_pallas (:423, call :472): the same product from a
//       pre-quantized xq (M, K) int8 and a_scale (M, G) fp32, fp32 out.
// wq is (K, N) int8 row-major and w_scale (G, N) fp32, with g = K / G a
// multiple of 32.  Any M and any N: the M and N tails are masked here (the
// LM head's N = 92,553 is odd).
//
// Numerics: IEEE division and round-half-to-even conversion for the
// activation quantization, an exact int32 partial per group, then
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA: every
// rounding step is the one the plain twin (ops/quant.py) takes, in the same
// order (groups in order, from 0), so kernel and twin agree to the bit
// whenever their int32 partials do, which they do exactly.
//
// What bounds it on this card: at the 2B's shapes (decoder w1: 6,144 x
// 2,048 -> 8,192) the int8 products, 1,979 TOP/s at 700 W; at decode (M = 2
// on the LM head) the weight bytes.  The TPU kernel held (512, g) x tiles
// and (g, 2048) weight tiles in VMEM across a sequential group axis; here a
// CTA of 8 warps owns a 64 x 128 output tile and walks the groups itself,
// keeping the fp32 sum in registers.  Per depth chunk of KC = 128, 64 or 32
// columns (KC = g where g is one of those, the `-g128` modes' case) it
// issues all its loads of the x chunk and the weight chunk before it uses
// any, then:
//   - K6 with KC = g: the KC / 8 lanes that loaded a row's chunk reduce its
//     amax by shuffles and quantize their own registers, so x is read once;
//     with g > KC a pass over the group first puts each row's scale in
//     shared memory.
//   - the quantized x chunk (64 x KC int8) and the weight chunk, transposed
//     to (128 x KC) by 4 x 4 byte permutes (one 32-bit store per column and
//     4 depths), go to shared memory; mma.sync m16n8k32.s8 (each warp 32 x
//     32: 2 x 4 fragments, int32 accumulators; two CTAs per SM).
// mma.sync's fragment layout is documented (PTX ISA, "Matrix Fragments for
// mma.m16n8k32"), so the per-group epilogue scales each int32 element at
// known (row, column) coordinates; WMMA's is not.  B must be k-contiguous
// per column, which is why the (K, N) weight is transposed while it is
// staged.  Rows are padded by 16 bytes, which makes the fragment loads
// conflict-free for KC = 32, 64 and 128.
// Later work: wgmma with TMA and a producer warp, cp.async double
// buffering, and a weight layout stored k-major for the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows per CTA
constexpr int kBN = 128;       // columns per CTA
constexpr int kThreads = 256;  // 8 warps, 2 x 4, each 32 x 32
constexpr int kNF = 4;         // m16n8 fragments per warp along N
constexpr int kPad = 16;       // bytes of padding per staged row

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The max over each aligned group of LANES lanes of a warp.
template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float bf16_amax8(const uint4& v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  float m = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) m = fmaxf(m, fabsf(__bfloat162float(e[t])));
  return m;
}

// The row scale of an amax: max(amax / 127, 1e-12), IEEE division.
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

// clip(round_half_even(v / s), -127, 127) with v / s the IEEE quotient,
// from the product by r = 1 / s: |v * r - v / s| is a few ulps of a value
// below 128 in magnitude (under 2e-5), so the two round to the same integer
// unless v * r lies within 1e-4 of a half; there the division is taken.
__device__ __forceinline__ unsigned quantize(float v, float s, float r) {
  float t = v * r;
  if (fabsf(fabsf(t - rintf(t)) - 0.5f) < 1e-4f) t = __fdiv_rn(v, s);
  return unsigned(max(-127, min(127, __float2int_rn(t)))) & 0xffu;
}

// 8 bf16 quantized with scale s into 8 int8 bytes.
__device__ __forceinline__ uint2 quantize8(const uint4& v, float s) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  const float r = 1.f / s;
  unsigned lo = 0u, hi = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lo |= quantize(__bfloat162float(e[t]), s, r) << (8 * t);
    hi |= quantize(__bfloat162float(e[t + 4]), s, r) << (8 * t);
  }
  return make_uint2(lo, hi);
}

// Word w of a uint4 (w a constant once unrolled).
__device__ __forceinline__ unsigned word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// 16 bytes of wq's row k from column n, zeros past N.
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ wq,
                                          int k, int n, int N, bool w_vec) {
  const int8_t* src = wq + size_t(k) * N + n;
  if (w_vec && n + 16 <= N) return *reinterpret_cast<const uint4*>(src);
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (n + t < N) v[t / 4] |= unsigned(uint8_t(src[t])) << (8 * (t % 4));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool FUSED, int KC>
__global__ void __launch_bounds__(kThreads, 2)
    q8g_kernel(const void* __restrict__ x, const float* __restrict__ a_scale,
               const int8_t* __restrict__ wq,
               const float* __restrict__ w_scale, void* __restrict__ out,
               int out_bf16, int M, int N, int K, int G) {
  constexpr int kLd = KC + kPad;
  // x chunk: each of kXLanes lanes loads 16 bytes of a row.
  constexpr int kXLanes = FUSED ? KC / 8 : KC / 16;
  constexpr int kXItems = kBM * kXLanes;
  constexpr int kXIt = (kXItems + kThreads - 1) / kThreads;
  // Weight chunk: an item is 4 depths x 16 columns.
  constexpr int kWItems = (KC / 4) * (kBN / 16);
  constexpr int kWIt = (kWItems + kThreads - 1) / kThreads;
  // K6's amax shuffles: a row's lanes are an aligned group of one warp.
  static_assert(!FUSED || kXItems % kThreads == 0, "x chunk split");

  __shared__ __align__(16) int8_t xs[kBM * kLd];
  __shared__ __align__(16) int8_t ws[kBN * kLd];  // k-contiguous per column
  __shared__ float as[kBM];                       // the group's row scales

  const int g = K / G;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool w_vec = (N % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(wq) % 16 == 0);

  float facc[2][kNF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) facc[i][j][c] = 0.f;

  for (int grp = 0; grp < G; ++grp) {
    const int kg = grp * g;
    // The group's scales of this thread's accumulator columns, early.
    float wsc[kNF][2];
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn + j * 8 + tig * 2 + e;
        wsc[j][e] = col < N ? w_scale[size_t(grp) * N + col] : 0.f;
      }
    }
    // The group's row scales where they are not taken from the chunk
    // itself: K7 reads them; K6 with g > KC reduces each row's amax over
    // the group first (a half-warp per row).
    if (!FUSED) {
      for (int r = tid; r < kBM; r += kThreads) {
        as[r] = m0 + r < M ? a_scale[size_t(m0 + r) * G + grp] : 0.f;
      }
    } else if (g > KC) {
      const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
      const int hl = lane & 15;
#pragma unroll
      for (int i = 0; i < kBM / (kThreads / 16); ++i) {
        const int r = i * (kThreads / 16) + warp * 2 + (lane >> 4);
        float amax = 0.f;
        if (m0 + r < M) {
          const __nv_bfloat16* row = xb + size_t(m0 + r) * K + kg;
          for (int c = hl * 8; c < g; c += 16 * 8) {
            amax = fmaxf(amax,
                         bf16_amax8(*reinterpret_cast<const uint4*>(row + c)));
          }
        }
        amax = group_max<16>(amax);
        if (hl == 0) as[r] = row_scale(amax);
      }
      __syncthreads();
    }

    int acc[2][kNF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

    for (int k0 = kg; k0 < kg + g; k0 += KC) {
      // Every load of the chunk first: x rows past M and weight columns
      // past N as zeros.
      uint4 xv[kXIt];
#pragma unroll
      for (int j = 0; j < kXIt; ++j) {
        const int it = tid + j * kThreads;
        const int r = it / kXLanes, c = it % kXLanes;
        xv[j] = make_uint4(0u, 0u, 0u, 0u);
        if (it < kXItems && m0 + r < M) {
          const size_t o = size_t(m0 + r) * K + k0;
          xv[j] = FUSED ? reinterpret_cast<const uint4*>(
                              static_cast<const __nv_bfloat16*>(x) + o)[c]
                        : reinterpret_cast<const uint4*>(
                              static_cast<const int8_t*>(x) + o)[c];
        }
      }
      uint4 wv[kWIt][4];
#pragma unroll
      for (int j = 0; j < kWIt; ++j) {
        const int it = tid + j * kThreads;
        if (it < kWItems) {
          const int kq = it % (KC / 4), nb = it / (KC / 4);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            wv[j][t] = load_w16(wq, k0 + 4 * kq + t, n0 + nb * 16, N, w_vec);
          }
        }
      }

      // x chunk -> xs as int8.
#pragma unroll
      for (int j = 0; j < kXIt; ++j) {
        const int it = tid + j * kThreads;
        const int r = it / kXLanes, c = it % kXLanes;
        if (FUSED) {
          float s;
          if (g == KC) {
            // The row's kXLanes lanes are an aligned group of this warp.
            s = row_scale(group_max<kXLanes>(bf16_amax8(xv[j])));
            if (c == 0) as[r] = s;
          } else {
            s = as[r];
          }
          *reinterpret_cast<uint2*>(xs + r * kLd + c * 8) = quantize8(xv[j], s);
        } else if (it < kXItems) {
          *reinterpret_cast<uint4*>(xs + r * kLd + c * 16) = xv[j];
        }
      }
      // Weight chunk -> ws[n][k]: per 4 depths, a 4 x 4 byte transpose of
      // each 4-column word; column n then gets one 32-bit store.
#pragma unroll
      for (int j = 0; j < kWIt; ++j) {
        const int it = tid + j * kThreads;
        if (it < kWItems) {
          const int kq = it % (KC / 4), nb = it / (KC / 4);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const unsigned t0 = __byte_perm(word(wv[j][0], w),
                                            word(wv[j][1], w), 0x5140);
            const unsigned t1 = __byte_perm(word(wv[j][0], w),
                                            word(wv[j][1], w), 0x7362);
            const unsigned t2 = __byte_perm(word(wv[j][2], w),
                                            word(wv[j][3], w), 0x5140);
            const unsigned t3 = __byte_perm(word(wv[j][2], w),
                                            word(wv[j][3], w), 0x7362);
            const unsigned col[4] = {__byte_perm(t0, t2, 0x5410),
                                     __byte_perm(t0, t2, 0x7632),
                                     __byte_perm(t1, t3, 0x5410),
                                     __byte_perm(t1, t3, 0x7632)};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              *reinterpret_cast<unsigned*>(
                  ws + (nb * 16 + w * 4 + e) * kLd + 4 * kq) = col[e];
            }
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < KC; kk += 32) {
        unsigned a[2][4], b[kNF][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int8_t* r0 = xs + (wm + i * 16 + gid) * kLd + kk + tig * 4;
          const int8_t* r8 = r0 + 8 * kLd;
          a[i][0] = *reinterpret_cast<const unsigned*>(r0);
          a[i][1] = *reinterpret_cast<const unsigned*>(r8);
          a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
          a[i][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
        }
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
          const int8_t* c0 = ws + (wn + j * 8 + gid) * kLd + kk + tig * 4;
          b[j][0] = *reinterpret_cast<const unsigned*>(c0);
          b[j][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNF; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }

    // Dequantize the group's partial into the fp32 sum:
    // c0, c1 at (gid, 2 tig + {0, 1}), c2, c3 eight rows below.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = wm + i * 16 + gid + (c >= 2 ? 8 : 0);
          const float part = __fmul_rn(__fmul_rn(float(acc[i][j][c]), as[r]),
                                       wsc[j][c & 1]);
          facc[i][j][c] = __fadd_rn(facc[i][j][c], part);
        }
      }
    }
    __syncthreads();  // as[] is rewritten by the next group
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + i * 16 + gid + (c >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + tig * 2 + (c & 1);
        if (row < M && col < N) {
          const size_t o = size_t(row) * N + col;
          if (out_bf16) {
            static_cast<__nv_bfloat16*>(out)[o] =
                __float2bfloat16_rn(facc[i][j][c]);
          } else {
            static_cast<float*>(out)[o] = facc[i][j][c];
          }
        }
      }
    }
  }
}

template <bool FUSED, int KC>
int launch_kc(const void* x, const float* a_scale, const void* wq,
              const void* w_scale, void* out, int out_bf16, int M, int N,
              int K, int G, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  q8g_kernel<FUSED, KC><<<grid, kThreads, 0, stream>>>(
      x, a_scale, static_cast<const int8_t*>(wq),
      static_cast<const float*>(w_scale), out, out_bf16, M, N, K, G);
  return int(cudaGetLastError());
}

template <bool FUSED>
int launch(const void* x, const float* a_scale, const void* wq,
           const void* w_scale, void* out, int out_bf16, int M, int N, int K,
           int G, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0 || K % G) return int(cudaErrorInvalidValue);
  const int g = K / G;
  if (g % 32) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g % 128 == 0) {
    return launch_kc<FUSED, 128>(x, a_scale, wq, w_scale, out, out_bf16, M, N,
                                 K, G, s);
  }
  if (g % 64 == 0) {
    return launch_kc<FUSED, 64>(x, a_scale, wq, w_scale, out, out_bf16, M, N,
                                K, G, s);
  }
  return launch_kc<FUSED, 32>(x, a_scale, wq, w_scale, out, out_bf16, M, N,
                              K, G, s);
}

}  // namespace

// K6: x (M, K) bf16, wq (K, N) int8, w_scale (G, N) fp32 -> out (M, N)
// bf16 (out_bf16 = 1) or fp32.
extern "C" int mjv_q8g_matmul_fused(const void* x, const void* wq,
                                    const void* w_scale, void* out,
                                    int out_bf16, int M, int N, int K, int G,
                                    void* stream) {
  return launch<true>(x, nullptr, wq, w_scale, out, out_bf16, M, N, K, G,
                      stream);
}

// K7: xq (M, K) int8, a_scale (M, G) fp32, wq (K, N) int8, w_scale (G, N)
// fp32 -> out (M, N) fp32.
extern "C" int mjv_q8g_matmul(const void* xq, const void* a_scale,
                              const void* wq, const void* w_scale, void* out,
                              int M, int N, int K, int G, void* stream) {
  return launch<false>(xq, static_cast<const float*>(a_scale), wq, w_scale,
                       out, 0, M, N, K, G, stream);
}
