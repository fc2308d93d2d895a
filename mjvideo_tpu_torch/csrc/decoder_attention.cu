// K2 and K2 lse: decoder attention on Hopper.  Replaces _fwd_bound_kernel
// (mjvideo_tpu/ops/flash_attention.py:318, reached through _fwd_impl with
// norm_bound, host side :484-511): causal attention with a (B, K) key mask,
// GQA (q head h reads kv head h // G), a per-row q_offset (null = 0), the
// bound shift with kmax the largest masked key norm of each (b, kv head),
// and rows whose sum is 0 giving 0.  Both run the wgmma/TMA template of
// decoder_attention_sm90.cuh (Config D128, ShiftMode::kKeyMax): K2r's
// constant-shift body with one bound per (b, kv head).  What bounds it and
// the design: see that header.
//
// A null lse: serving, the judge's scorer-side decoder.  A non-null lse
// (K2 lse, the training forward and the reward gradient: _fwd_bound_kernel
// with with_lse, flash_attention.py:407-412) also gets the (B, Hq, Q) fp32
// true lse, kDeadLse on dead rows, that the backward kernels read.
//
// kmax comes from the pre-pass key_norm_max below, on the card; the TPU
// path reduced it with one XLA reduce outside the kernel
// (flash_attention.py:484-511).  The same pre-pass serves K1 and K1 lse
// (vit_attention.cu) at D = 64.
//
// K2r (mjv_decoder_attention_rows) is _fwd_bound_kernel(row_bound=True)
// (flash_attention.py:347-358, host side :484-508), the opt-in shift of the
// cached generation paths, on the same Hopper template (ShiftMode::kRows).
// Its bound column is the pre-pass below (mjv_key_norm_cummax): the
// (B, Hkv, K) fp32 running max along K of the masked key norms, which the
// main kernel reads at each row's global position clip(q_offset + i, 0,
// K - 1) for its kv head.  On the TPU this was one XLA reduce outside the
// kernel (flash_attention.py:489-508).
#include "decoder_attention_sm90.cuh"

namespace sm90 = mjv::attention_sm90;
using sm90::bf16;

extern "C" int mjv_decoder_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kmax, const void* q_offset, void* out, void* lse, int B,
    int Q, int K, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, float scale,
    void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kKeyMax>(
      q, k, v, mask, kmax, q_offset, out, lse, B, Q, K, Hq, Hkv, qsb, qss,
      ksb, kss, vsb, vss, scale, stream);
}

// The pre-pass of K1, K1 lse, K2 and K2 lse: kmax (B, Hkv) fp32, the
// largest norm of a live key of each (b, kv head).  The keys are split into
// chunks of kMaxKeys, one CTA of kMaxThreads per (chunk, b) over all kv
// heads, so a long prompt (the 53,722-token clip: 1,679 CTAs) does not
// serialize on B * Hkv CTAs.  D / 8 lanes share one key vector (one
// 16-byte load each), each thread keeps kMaxLoads loads in flight.  The
// squares of bf16 values sum exactly in double, so the norm does not
// depend on the order of the sum and is rounded once, after a double sqrt,
// to float; the twin (ops/flash_attention.py key_norm_max) sums in fp32 in
// torch's order and lies within about an ulp of it.  The vector's leader
// folds it (a masked key gives nothing) into a shared max per kv head by
// atomicMax on the float's bits, and each CTA then folds its maxima into
// out the same way.  The norms are non-negative, so the integer order of
// their bits is their order: the max is exact and the same on every run,
// and since sqrt and the rounding are monotone it is the sqrt of the max
// of the squares, as in the twin.  out is zeroed on the stream first (a
// masked row's bound is 0, as in the twin).  What bounds it: the k read,
// 12.6 MB at the decoder's (2, 3072) and 16.8 MB at the ViT's (8, 1025),
// about 4-5 us over the card at 3.35 TB/s; the eager chain it replaces was
// about five launches and 0.11 ms at the ViT's shape.
constexpr int kMaxThreads = 256;
constexpr int kMaxKeys = 32;  // keys per CTA
constexpr int kMaxLoads = 4;  // loads in flight per thread

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
key_norm_max_kernel(const bf16* __restrict__ k,
                    const int* __restrict__ mask, float* __restrict__ out,
                    int K, int Hkv, long long ksb, long long kss) {
  constexpr int kLanes = D / 8;  // 16-byte pieces of one key vector
  constexpr int kStep = kMaxThreads * kMaxLoads;
  extern __shared__ float head_max[];  // Hkv
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * kMaxKeys;
  const int total = min(kMaxKeys, K - j0) * Hkv * kLanes;
  for (int h = threadIdx.x; h < Hkv; h += kMaxThreads) head_max[h] = 0.f;
  __syncthreads();
  const bf16* kb = k + b * ksb + j0 * kss;
  // The loop bound is uniform over the block, so every lane reaches the
  // shuffles; pieces past the chunk load zeros and are not counted.  A
  // piece's kLanes lanes lie in one warp: i % 32 is the lane.
  for (int i0 = 0; i0 < total; i0 += kStep) {
    uint4 raw[kMaxLoads];
#pragma unroll
    for (int u = 0; u < kMaxLoads; ++u) {
      const int i = i0 + u * kMaxThreads + threadIdx.x;
      const int p = i / kLanes;  // (key, head) pair
      raw[u] = i < total
                   ? *reinterpret_cast<const uint4*>(
                         kb + (p / Hkv) * kss + (p % Hkv) * D +
                         (i % kLanes) * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kMaxLoads; ++u) {
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      double s = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        s += double(f.x) * f.x + double(f.y) * f.y;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const int i = i0 + u * kMaxThreads + threadIdx.x;
      const int p = i / kLanes;
      if (i < total && i % kLanes == 0 &&
          (mask == nullptr || mask[(long long)b * K + j0 + p / Hkv] != 0)) {
        atomicMax(reinterpret_cast<int*>(&head_max[p % Hkv]),
                  __float_as_int(__double2float_rn(sqrt(s))));
      }
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < Hkv; h += kMaxThreads) {
    atomicMax(reinterpret_cast<int*>(&out[(long long)b * Hkv + h]),
              __float_as_int(head_max[h]));
  }
}

extern "C" int mjv_key_norm_max(const void* k, const void* mask, void* out,
                                int B, int K, int Hkv, int D, long long ksb,
                                long long kss, void* stream) {
  if ((D != 64 && D != 128) || B < 1 || K < 1 || Hkv < 1 || Hkv > 4096) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * B * Hkv, s);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((K + kMaxKeys - 1) / kMaxKeys, B);
  const size_t smem = sizeof(float) * Hkv;
  auto kernel = D == 64 ? key_norm_max_kernel<64> : key_norm_max_kernel<128>;
  kernel<<<grid, kMaxThreads, smem, s>>>(
      static_cast<const bf16*>(k), static_cast<const int*>(mask),
      static_cast<float*>(out), K, Hkv, ksb, kss);
  return int(cudaGetLastError());
}

// The pre-pass of K2r: one CTA of 1024 threads per (b, kv head).  First
// the key norms: 16 lanes share a key, one 16-byte load each, so a warp's
// load covers two whole 256-byte key rows; each warp keeps 8 such loads
// (16 keys) in flight before it reduces them, the sum of squares in fp32
// in a fixed order whatever K, and writes sqrt of it, or 0 for a masked
// key, into out.  Then a block scan turns the row into its running max
// (max is exact, so the result equals a sequential cummax).  What bounds
// it: the k read, 0.8 MB per (b, kv head) at the judge's prefill, about
// 4 us over the card at 3.35 TB/s, reached only in part by 16 CTAs; the
// eager chain of about ten PyTorch passes it replaces took some 0.6 ms.
constexpr int kScanThreads = 1024;
constexpr int kNormLoads = 8;  // loads in flight per lane

__global__ void __launch_bounds__(kScanThreads)
key_norm_cummax_kernel(const bf16* __restrict__ k,
                       const int* __restrict__ mask, float* __restrict__ out,
                       int K, int Hkv, long long ksb, long long kss) {
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const bf16* kb = k + b * ksb + hk * 128;
  float* ob = out + (long long)blockIdx.x * K;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kKeysPerWarp = 2 * kNormLoads;
  // The loop bound is uniform over the warp, so every lane reaches the
  // shuffles; keys past K load zeros and are not written.
  for (int k0 = warp * kKeysPerWarp; k0 < K;
       k0 += (kScanThreads / 32) * kKeysPerWarp) {
    uint4 raw[kNormLoads];
#pragma unroll
    for (int u = 0; u < kNormLoads; ++u) {
      const int j = k0 + 2 * u + lane / 16;
      raw[u] = j < K ? *reinterpret_cast<const uint4*>(kb + j * kss +
                                                       (lane % 16) * 8)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kNormLoads; ++u) {
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        s += f.x * f.x + f.y * f.y;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const int j = k0 + 2 * u + lane / 16;
      if (lane % 16 == 0 && j < K) {
        const bool live = mask == nullptr || mask[(long long)b * K + j] != 0;
        ob[j] = live ? sqrtf(s) : 0.f;
      }
    }
  }
  __syncthreads();

  // Each thread owns a contiguous chunk; an inclusive scan of the chunks'
  // maxima gives each chunk the max of all before it.
  __shared__ float warp_max[kScanThreads / 32];
  const int chunk = (K + kScanThreads - 1) / kScanThreads;
  const int j0 = threadIdx.x * chunk;
  const int j1 = min(K, j0 + chunk);
  float local = 0.f;  // norms are >= 0
  for (int j = j0; j < j1; ++j) local = fmaxf(local, ob[j]);
  float incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = fmaxf(incl, y);
  }
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = warp_max[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = fmaxf(w, y);
    }
    warp_max[lane] = w;
  }
  __syncthreads();
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  if (warp > 0) run = fmaxf(run, warp_max[warp - 1]);
  for (int j = j0; j < j1; ++j) {
    run = fmaxf(run, ob[j]);
    ob[j] = run;
  }
}

extern "C" int mjv_key_norm_cummax(const void* k, const void* mask,
                                   void* out, int B, int K, int Hkv, int D,
                                   long long ksb, long long kss,
                                   void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  key_norm_cummax_kernel<<<B * Hkv, kScanThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(k), static_cast<const int*>(mask),
      static_cast<float*>(out), K, Hkv, ksb, kss);
  return int(cudaGetLastError());
}

// kcum: the (B, Hkv, K) fp32 output of mjv_key_norm_cummax.
extern "C" int mjv_decoder_attention_rows(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kcum, const void* q_offset, void* out, int B, int Q, int K,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale, void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kRows>(
      q, k, v, mask, kcum, q_offset, out, nullptr, B, Q, K, Hq, Hkv, qsb, qss,
      ksb, kss, vsb, vss, scale, stream);
}
