// Bound-shift attention forward for Hopper (sm_90a), shared by K1 and K2.
//
// Replaces two Pallas TPU kernels of mjvideo_tpu/ops/flash_attention.py:
//   K1 _fwd_nc_kernel    (ViT: non-causal, maskless, whole kv row per program)
//   K2 _fwd_bound_kernel (decoder: causal, (B, K) key mask, GQA h -> h // G)
// Both shift the softmax by the Cauchy-Schwarz bound
//   m_i = |scale| * |q_i| * kmax[b, kv head] >= s_ij   for every j,
// which is constant along a row.  So there is no running max and no rescale:
// each CTA keeps l_i = sum_j exp(s_ij - m_i) and acc_i = sum_j p_ij v_j over
// its kv tiles and divides once at the end.  kmax (the largest masked key
// norm) is reduced before the launch, as _fwd_impl does outside its kernel.
//
// What bounds it on this card: at the scoring shapes (ViT S = 1025, D = 64;
// decoder T = 2304-3072, D = 128) attention is compute-bound on the two
// products; q/k/v are read once per q tile, mostly from L2.  The TPU kernel
// held a whole kv row in VMEM; an SM has at most 227 KB of shared memory, so
// this design walks the kv row in 64-key tiles and keeps only the 64-row q
// tile, one k tile, one v tile and per-warp score scratch resident (54 KB at
// D = 64 for K1, 95 KB at D = 128 for K2: 4 or 2 CTAs per SM).
//
// Design (first, simple version): one CTA of 4 warps per (b, q head,
// 64-row q tile); each warp owns 16 q rows.  Tiles are staged through shared
// memory with 16-byte loads, rows padded by 16 bytes so that fragment loads
// and the exp pass do not collide on banks.  Both products run on the tensor
// cores through WMMA 16x16x16 bf16 fragments with fp32 accumulation; the exp
// pass reads the fp32 scores row by row, lane j on key j, and p is rounded to
// bf16 before the p @ v product, as the TPU kernel does.  Causal CTAs stop at
// the last kv tile that touches the diagonal.  Tails (S = 1025, ragged T) are
// masked in the kernel: keys past K give p = 0 and are staged as zeros.
// WITH_LSE (K2 on the training path) also writes the true log-sum-exp of
// each row, m_i + log(l_i), or kDeadLse where l_i == 0: shift invariance
// makes it the exact lse whatever the bound, so the backward kernels
// (decoder_attention_bwd.cu) need no bound of their own.
// Later work: wgmma, TMA or cp.async double buffering, a producer warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mjv {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBlockQ = 64;   // q rows per CTA
constexpr int kBlockK = 64;   // keys per kv tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kBlockK + 8;  // bf16 p rows, padded
constexpr float kDeadLse = 1e30f;  // DEAD_LSE of flash_attention.py

template <int D>
struct Smem {
  static constexpr int kLdT = D + 8;  // bf16 q/k/v tile rows, padded
  static constexpr int kLdS = (D > kBlockK ? D : kBlockK) + 4;  // fp32 rows
  static constexpr size_t kQ = size_t(kBlockQ) * kLdT * sizeof(bf16);
  static constexpr size_t kK = size_t(kBlockK) * kLdT * sizeof(bf16);
  static constexpr size_t kS = size_t(kWarps) * 16 * kLdS * sizeof(float);
  static constexpr size_t kP = size_t(kWarps) * 16 * kLdP * sizeof(bf16);
  static constexpr size_t kM = size_t(kWarps) * 16 * sizeof(float);
  static constexpr size_t kBytes = kQ + 2 * kK + kS + kP + kM;
};

// Copy rows [r0, r0 + ROWS) of a (rows_total, D) slab with row stride
// `stride` (elements) into a (ROWS, D) shared tile with row stride LD; rows
// past `rows_total` are zero-filled so that p = 0 never meets a NaN.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int r0,
                                           int rows_total) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_total) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q: (B, Q, Hq, D) with strides (qsb, qss, D, 1); k, v: (B, K, Hkv, D) with
// strides (ksb, kss, D, 1) and (vsb, vss, D, 1); out: dense (B, Q, Hq, D).
// mask: (B, K) int32 or null; kmax: (B, Hkv) fp32; q_offset: (B,) or null.
// FLOOR: K1's rule, l floored at 1e-30.  Otherwise K2's: l == 0 gives 0.
// lse: (B, Hq, Q) fp32, written only when WITH_LSE.
template <int D, bool CAUSAL, bool FLOOR, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads)
bound_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ mask,
                       const float* __restrict__ kmax,
                       const int* __restrict__ q_offset, bf16* __restrict__ out,
                       int Q, int K, int Hq, int Hkv, long long qsb,
                       long long qss, long long ksb, long long kss,
                       long long vsb, long long vss, float scale,
                       float* __restrict__ lse) {
  using S = Smem<D>;
  constexpr int LT = S::kLdT;
  constexpr int LS = S::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::kQ + S::kK);
  float* Ss = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kK);
  bf16* Ps = reinterpret_cast<bf16*>(smem + S::kQ + 2 * S::kK + S::kS);
  float* Ms = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kK + S::kS +
                                       S::kP);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = q_offset ? q_offset[b] : 0;

  const bf16* qb = q + b * qsb + h * D;
  const bf16* kb = k + b * ksb + hk * D;
  const bf16* vb = v + b * vsb + hk * D;
  const bf16* Qw = Qs + warp * 16 * LT;  // this warp's 16 q rows
  float* Sw = Ss + warp * 16 * LS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  float* Mw = Ms + warp * 16;
  const int row0 = off + q0 + warp * 16;  // global position of row 0

  stage_tile<D, kBlockQ, LT>(Qs, qb, qss, q0, Q);
  __syncthreads();

  // The bound of each of the warp's rows: m_r = |q_r| * kmax * |scale|.
  const float kscale = kmax[b * Hkv + hk] * fabsf(scale);
  for (int r = 0; r < 16; ++r) {
    float qn2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float x = __bfloat162float(Qw[r * LT + c]);
      qn2 += x * x;
    }
    qn2 = warp_sum(qn2);
    if (lane == 0) Mw[r] = sqrtf(qn2) * kscale;
  }
  __syncwarp();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(o_frag[n], 0.f);
  float l[16];  // this lane's share of each row's sum, keys lane and lane + 32
#pragma unroll
  for (int r = 0; r < 16; ++r) l[r] = 0.f;

  int n_kv = (K + kBlockK - 1) / kBlockK;
  if (CAUSAL) {
    const int last_key = off + q0 + kBlockQ - 1;  // largest key any row sees
    n_kv = min(n_kv, last_key / kBlockK + 1);
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_tile<D, kBlockK, LT>(Ks, kb, kss, k0, K);
    stage_tile<D, kBlockK, LT>(Vs, vb, vss, k0, K);
    __syncthreads();

    // s = q_w k^T for this warp's 16 rows: (16 x D) x (D x 64), fp32.
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, Qw + kk * 16, LT);
        wmma::load_matrix_sync(bm, Ks + n * 16 * LT + kk * 16, LT);
        wmma::mma_sync(s_frag, a, bm, s_frag);
      }
      wmma::store_matrix_sync(Sw + n * 16, s_frag, LS, wmma::mem_row_major);
    }
    __syncwarp();

    // p = exp(s * scale - m) where the key is visible, else 0.  Lane j
    // serves keys k0 + j and k0 + j + 32 of every row.
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = lane + 32 * h2;
      const int j = k0 + c;
      bool key_ok = j < K;
      if (mask != nullptr) key_ok = key_ok && mask[(long long)b * K + j] != 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        bool ok = key_ok;
        if (CAUSAL) ok = ok && j <= row0 + r;
        const float s = Sw[r * LS + c] * scale;
        const float p = ok ? expf(s - Mw[r]) : 0.f;
        l[r] += p;
        Pw[r * kLdP + c] = __float2bfloat16(p);
      }
    }
    __syncwarp();

    // acc += p_w v: (16 x 64) x (64 x D), fp32.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk * 16, kLdP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Vs + kk * 16 * LT + n * 16, LT);
        wmma::mma_sync(o_frag[n], a, bm, o_frag[n]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(Sw + n * 16, o_frag[n], LS, wmma::mem_row_major);
  }
  __syncwarp();

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float lr = warp_sum(l[r]);
    const int qi = q0 + warp * 16 + r;
    if (qi >= Q) continue;
    if (WITH_LSE && lane == 0) {
      lse[((long long)b * Hq + h) * Q + qi] =
          lr > 0.f ? Mw[r] + logf(fmaxf(lr, 1e-30f)) : kDeadLse;
    }
    bf16* orow = out + (((long long)b * Q + qi) * Hq + h) * D;
    for (int c = lane; c < D; c += 32) {
      const float acc = Sw[r * LS + c];
      float o;
      if (FLOOR) {
        o = acc / fmaxf(lr, 1e-30f);
      } else {
        o = lr > 0.f ? acc / lr : 0.f;
      }
      orow[c] = __float2bfloat16(o);
    }
  }
}

template <int D, bool CAUSAL, bool FLOOR, bool WITH_LSE = false>
int launch_bound_attention(const void* q, const void* k, const void* v,
                           const void* mask, const void* kmax,
                           const void* q_offset, void* out, int B, int Q,
                           int K, int Hq, int Hkv, long long qsb,
                           long long qss, long long ksb, long long kss,
                           long long vsb, long long vss, float scale,
                           void* stream, void* lse = nullptr) {
  auto kernel = bound_attention_kernel<D, CAUSAL, FLOOR, WITH_LSE>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(mask),
      static_cast<const float*>(kmax), static_cast<const int*>(q_offset),
      static_cast<bf16*>(out), Q, K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss,
      scale, static_cast<float*>(lse));
  return int(cudaGetLastError());
}

}  // namespace mjv
