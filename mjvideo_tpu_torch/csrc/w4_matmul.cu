// K5: the int4 weight-only (w4a16) decode GEMV on Hopper (sm_90a).
//
// Replaces _w4_matmul_pallas (mjvideo_tpu/ops/quant4.py:177, call :227):
// x (M <= 32, K) bf16 times a half-split packed int4 kernel, packed (K/2, N)
// int8 with group scales (G, N) bf16, g = K / G, giving (M, N) fp32.  The
// low nibble of packed[k] holds row k and the high nibble row K/2 + k, both
// biased by 8; row k's group is k / g, so the high nibble's group is
// K/2/g + k/g.  Each weight is dequantized in fp32, (nibble - 8) * scale,
// and rounded to bf16 (x's dtype) before the product, as the TPU kernel
// does; the bf16 x bf16 products are exact in fp32 and summed in fp32.
//
// What bounds it on this card: the weight bytes.  A decode step reads every
// packed kernel once for a handful of rows (K/2 x N bytes, a quarter of the
// bf16 kernel), so the kernel must stream the bytes at the memory rate and
// keep x out of the way.  The TPU kernel held all of x (M, K) and a whole
// (K/2, bn) weight tile in VMEM; x at M = 32, K = 8,192 is 512 KB, more
// than an SM's shared memory.  Design (first, simple version): K is split
// across CTAs (64 packed rows each, or g where g is smaller: one group's
// scales per CTA, read once) and each CTA stages only its two x
// slices, [p0, p0 + 64) and [K/2 + p0, K/2 + p0 + 64), as fp32 in shared
// memory (16 KB at M = 32); 128 threads each own 2 adjacent output columns,
// so a warp's loads of one packed row are 64 contiguous bytes; every thread
// keeps M x 2 fp32 sums (M rounded up to a power of two, a template
// parameter) and adds them into the zeroed output with atomicAdd.  The
// split gives 128-512 CTAs at the 2B's decode shapes (wq 2,048 -> 2,048,
// w2 8,192 -> 2,048), where one CTA per column block would use 8-32 SMs;
// the atomics make the fp32 summation order vary from run to run.
// Later work: 16-byte loads of several packed rows per thread, the scales
// kept in shared memory, and a reduction without atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;                  // output columns per thread
constexpr int kBN = kThreads * kCols;     // columns per CTA
constexpr int kPK = 64;                   // packed rows per CTA, at most

__device__ __forceinline__ float deq(int nibble, float s) {
  // (nibble - 8) * scale in fp32, rounded to bf16 like the TPU kernel.
  return __bfloat162float(__float2bfloat16_rn(float(nibble - 8) * s));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    w4_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ packed,
              const __nv_bfloat16* __restrict__ scale, float* __restrict__ out,
              int M, int N, int K, int G, int pk) {
  __shared__ float xs[2][MT][kPK];
  const int K2 = K / 2;
  const int g = K / G;
  const int p0 = blockIdx.y * pk;  // pk divides g: one group per CTA
  const int rows = pk;
  const int n = blockIdx.x * kBN + threadIdx.x * kCols;

  for (int it = threadIdx.x; it < 2 * MT * kPK; it += kThreads) {
    const int h = it / (MT * kPK), m = (it / kPK) % MT, i = it % kPK;
    float v = 0.f;
    if (m < M && i < rows) {
      v = __bfloat162float(x[size_t(m) * K + h * K2 + p0 + i]);
    }
    xs[h][m][i] = v;
  }
  __syncthreads();
  if (n >= N) return;
  const bool pair = n + 1 < N;

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;

  const int gi = p0 / g;
  const __nv_bfloat16* sl = scale + size_t(gi) * N + n;
  const __nv_bfloat16* sh = scale + size_t(K2 / g + gi) * N + n;
  const float s_lo[kCols] = {__bfloat162float(sl[0]),
                             pair ? __bfloat162float(sl[1]) : 0.f};
  const float s_hi[kCols] = {__bfloat162float(sh[0]),
                             pair ? __bfloat162float(sh[1]) : 0.f};
  const uint8_t* src = packed + size_t(p0) * N + n;
  // Unrolled so that the loads of several rows are in flight at once.
#pragma unroll 8
  for (int i = 0; i < rows; ++i) {
    const int b0 = src[size_t(i) * N];
    const int b1 = pair ? src[size_t(i) * N + 1] : 0x88;  // a zero weight
    const float wl0 = deq(b0 & 0xF, s_lo[0]), wh0 = deq(b0 >> 4, s_hi[0]);
    const float wl1 = deq(b1 & 0xF, s_lo[1]), wh1 = deq(b1 >> 4, s_hi[1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xl = xs[0][m][i], xh = xs[1][m][i];
      acc[m][0] += xl * wl0 + xh * wh0;
      acc[m][1] += xl * wl1 + xh * wh1;
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      atomicAdd(out + size_t(m) * N + n, acc[m][0]);
      if (pair) atomicAdd(out + size_t(m) * N + n + 1, acc[m][1]);
    }
  }
}

template <int MT>
int launch(const void* x, const void* packed, const void* scale, void* out,
           int M, int N, int K, int G, cudaStream_t stream) {
  // Packed rows per CTA: 64, or the group size where it is smaller, so a
  // CTA's rows lie in one group (a g of 64 or more is a multiple of 64).
  const int g = K / G;
  const int pk = g < kPK ? g : kPK;
  const dim3 grid((N + kBN - 1) / kBN, K / 2 / pk);
  w4_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(out), M,
      N, K, G, pk);
  return int(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16, packed (K/2, N) int8, scale (G, N) bf16 -> out (M, N)
// fp32, which the caller zeroes (the CTAs add into it).
extern "C" int mjv_w4_matmul(const void* x, const void* packed,
                             const void* scale, void* out, int M, int N,
                             int K, int G, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || G <= 0 || K % G || (K / 2) % (K / G) ||
      (K / G >= kPK && (K / G) % kPK)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch<1>(x, packed, scale, out, M, N, K, G, s);
  if (M <= 2) return launch<2>(x, packed, scale, out, M, N, K, G, s);
  if (M <= 4) return launch<4>(x, packed, scale, out, M, N, K, G, s);
  if (M <= 8) return launch<8>(x, packed, scale, out, M, N, K, G, s);
  if (M <= 16) return launch<16>(x, packed, scale, out, M, N, K, G, s);
  return launch<32>(x, packed, scale, out, M, N, K, G, s);
}
