// Attention forward for Hopper (sm_90a): one template for K1, K2, K2r and K3.
//
// Replaces four Pallas TPU kernels of mjvideo_tpu/ops/flash_attention.py:
//   K1  _fwd_nc_kernel    (ViT: non-causal, maskless, whole kv row per program)
//   K2  _fwd_bound_kernel (decoder: causal, (B, K) key mask, GQA h -> h // G)
//   K2r _fwd_bound_kernel(row_bound=True) (the cached paths' per-row bound)
//   K3  _fwd_kernel       (the exact online softmax, causal or not)
// K1, K2 and K2r shift the softmax by the Cauchy-Schwarz bound
//   m_i = |scale| * |q_i| * kmax >= s_ij   for every visible j,
// with kmax the largest masked key norm of the (b, kv head) (K1, K2) or, for
// K2r, the running max of masked key norms over slots <= the row's global
// position (a (B, Hq, Q) column gathered before the launch, as _fwd_impl
// does).  The bound is constant along a row, so there is no running max and
// no rescale: each CTA keeps l_i = sum_j exp(s_ij - m_i) and acc_i = sum_j
// p_ij v_j over its kv tiles and divides once at the end.  K2r's bound is a
// function of the tokens at or before row i only, so a prefix-only prefill
// and a full-prompt prefill compute bit-identical rows for the prefix.
// K3 keeps the exact running row max m_i instead: per kv tile it takes the
// tile's row max, rescales l_i and acc_i by alpha = exp(m_old - m_new) and
// sums exp(s_ij - m_new).  Masked scores are the finite kNegInf (-1e30) as
// in _fwd_kernel, never -inf: a row that has seen no live key yet keeps m =
// kNegInf and its masked keys briefly give p = 1, which the first live key's
// alpha = exp(kNegInf - m) = 0 wipes; a row that never sees one ends with m
// <= kNegInf / 2 and gives 0 (and kDeadLse).
//
// What bounds it on this card: at the scoring and judge shapes (ViT S =
// 1025, D = 64; decoder T = 2304-3072, D = 128) attention is compute-bound
// on the two products; q/k/v are read once per q tile, mostly from L2.  The
// TPU kernel held a whole kv row in VMEM; an SM has at most 227 KB of shared
// memory, so this design walks the kv row in 64-key tiles and keeps only the
// 64-row q tile, one k tile, one v tile and per-warp score scratch resident
// (54 KB at D = 64 for K1, 95 KB at D = 128 for K2/K2r/K3: 4 or 2 CTAs per
// SM).
//
// Design (first, simple version): one CTA of 4 warps per (b, q head,
// 64-row q tile); each warp owns 16 q rows.  Tiles are staged through shared
// memory with 16-byte loads, rows padded by 16 bytes so that fragment loads
// and the exp pass do not collide on banks.  Both products run on the tensor
// cores through WMMA 16x16x16 bf16 fragments with fp32 accumulation; the exp
// pass reads the fp32 scores row by row, lane j on key j, and p is rounded to
// bf16 before the p @ v product, as the TPU kernels do.  Causal CTAs stop at
// the last kv tile that touches the diagonal.  Tails (S = 1025, ragged T) are
// masked in the kernel: keys past K are staged as zeros and never visible.
// K3's rescale never depends on the WMMA accumulator's register layout,
// which is not documented: when some row of the warp has alpha != 1, the
// warp stores its accumulator fragments to its fp32 score scratch (free once
// the exp pass has written p), scales each row there by its alpha and loads
// the fragments back.  Every lane holds every row's m and alpha (the row max
// is a warp reduction), so the test is warp-uniform.
// WITH_LSE (K2 on the training path) also writes the true log-sum-exp of
// each row, m_i + log(l_i), or kDeadLse where the row is dead: shift
// invariance makes it the exact lse whatever the shift, so the backward
// kernels (decoder_attention_bwd.cu) need no bound of their own.
// Later work: wgmma, TMA or cp.async double buffering, a producer warp,
// and K3's accumulator in registers through mma.sync.
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
constexpr float kNegInf = -1e30f;  // NEG_INF of flash_attention.py

// How each row's softmax is shifted.
enum class Shift {
  kGlobalBound,  // K1, K2: |scale| |q_i| kmax[b, kv head]
  kRowBound,     // K2r:    |scale| |q_i| kmax[b, h, i], a per-row column
  kExact,        // K3:     the running row max, with the rescale
};

template <int D>
struct Smem {
  static constexpr int kLdT = D + 8;  // bf16 q/k/v tile rows, padded
  static constexpr int kLdS = (D > kBlockK ? D : kBlockK) + 4;  // fp32 rows
  static constexpr size_t kQ = size_t(kBlockQ) * kLdT * sizeof(bf16);
  static constexpr size_t kK = size_t(kBlockK) * kLdT * sizeof(bf16);
  static constexpr size_t kS = size_t(kWarps) * 16 * kLdS * sizeof(float);
  static constexpr size_t kP = size_t(kWarps) * 16 * kLdP * sizeof(bf16);
  static constexpr size_t kBytes = kQ + 2 * kK + kS + kP;
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

// Butterfly reductions: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// q: (B, Q, Hq, D) with strides (qsb, qss, D, 1); k, v: (B, K, Hkv, D) with
// strides (ksb, kss, D, 1) and (vsb, vss, D, 1); out: dense (B, Q, Hq, D).
// mask: (B, K) int32 or null; q_offset: (B,) or null.  kmax: (B, Hkv) fp32
// for kGlobalBound, the (B, Hq, Q) fp32 per-row column for kRowBound,
// unused for kExact.
// FLOOR: K1's rule, l floored at 1e-30.  Otherwise K2's: l == 0 gives 0
// (K3: a row whose m never left kNegInf gives 0).
// lse: (B, Hq, Q) fp32, written only when WITH_LSE.
template <int D, bool CAUSAL, bool FLOOR, bool WITH_LSE,
          Shift SHIFT = Shift::kGlobalBound>
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
  constexpr bool kExactMax = SHIFT == Shift::kExact;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::kQ + S::kK);
  float* Ss = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kK);
  bf16* Ps = reinterpret_cast<bf16*>(smem + S::kQ + 2 * S::kK + S::kS);

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
  const int row0 = off + q0 + warp * 16;  // global position of row 0

  stage_tile<D, kBlockQ, LT>(Qs, qb, qss, q0, Q);
  __syncthreads();

  // Each row's shift, held by every lane: the bound m_r = |q_r| * kmax *
  // |scale|, fixed for the whole walk, or K3's running max from kNegInf.
  float m[16];
  if (kExactMax) {
#pragma unroll
    for (int r = 0; r < 16; ++r) m[r] = kNegInf;
  } else {
    const float kscale =
        SHIFT == Shift::kGlobalBound ? kmax[b * Hkv + hk] * fabsf(scale) : 0.f;
    for (int r = 0; r < 16; ++r) {
      float qn2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float x = __bfloat162float(Qw[r * LT + c]);
        qn2 += x * x;
      }
      qn2 = warp_sum(qn2);
      if (SHIFT == Shift::kGlobalBound) {
        m[r] = sqrtf(qn2) * kscale;
      } else {
        const int qi = q0 + warp * 16 + r;
        const float kr =
            qi < Q ? kmax[((long long)b * Hq + h) * Q + qi] : 0.f;
        m[r] = sqrtf(qn2) * kr * fabsf(scale);
      }
    }
  }

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

    // p = exp(s * scale - m) where the key is visible.  Lane j serves keys
    // k0 + j and k0 + j + 32 of every row.  The bound shifts give masked
    // keys p = 0; K3 gives them the score kNegInf, as _fwd_kernel does.
    bool key_ok[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = k0 + lane + 32 * h2;
      key_ok[h2] = j < K;
      if (mask != nullptr) {
        key_ok[h2] = key_ok[h2] && mask[(long long)b * K + j] != 0;
      }
    }
    float alpha[16];  // K3: exp(m_old - m_new) per row
    bool rescale = false;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      bool ok[2];
      float s[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        ok[h2] = key_ok[h2];
        if (CAUSAL) ok[h2] = ok[h2] && k0 + c <= row0 + r;
        s[h2] = Sw[r * LS + c] * scale;
        if (kExactMax && !ok[h2]) s[h2] = kNegInf;
      }
      if (kExactMax) {
        const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
        alpha[r] = expf(m[r] - m_new);
        rescale = rescale || alpha[r] != 1.f;
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float p =
            (kExactMax || ok[h2]) ? expf(s[h2] - m[r]) : 0.f;
        l[r] += p;
        Pw[r * kLdP + lane + 32 * h2] = __float2bfloat16(p);
      }
    }
    __syncwarp();

    // K3: acc *= alpha row by row, through the (now free) score scratch.
    if (kExactMax && rescale) {
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::store_matrix_sync(Sw + n * 16, o_frag[n], LS,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        for (int c = lane; c < D; c += 32) Sw[r * LS + c] *= alpha[r];
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::load_matrix_sync(o_frag[n], Sw + n * 16, LS,
                               wmma::mem_row_major);
      }
    }

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

  __syncwarp();
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
    // K3's dead row: m never left kNegInf.  The bound shifts': l == 0.
    const bool dead = kExactMax ? m[r] <= 0.5f * kNegInf : !(lr > 0.f);
    if (WITH_LSE && lane == 0) {
      lse[((long long)b * Hq + h) * Q + qi] =
          dead ? kDeadLse : m[r] + logf(fmaxf(lr, 1e-30f));
    }
    bf16* orow = out + (((long long)b * Q + qi) * Hq + h) * D;
    for (int c = lane; c < D; c += 32) {
      const float acc = Sw[r * LS + c];
      float o;
      if (FLOOR) {
        o = acc / fmaxf(lr, 1e-30f);
      } else if (kExactMax) {
        o = dead ? 0.f : acc / (lr == 0.f ? 1.f : lr);
      } else {
        o = lr > 0.f ? acc / lr : 0.f;
      }
      orow[c] = __float2bfloat16(o);
    }
  }
}

template <int D, bool CAUSAL, bool FLOOR, bool WITH_LSE = false,
          Shift SHIFT = Shift::kGlobalBound>
int launch_bound_attention(const void* q, const void* k, const void* v,
                           const void* mask, const void* kmax,
                           const void* q_offset, void* out, int B, int Q,
                           int K, int Hq, int Hkv, long long qsb,
                           long long qss, long long ksb, long long kss,
                           long long vsb, long long vss, float scale,
                           void* stream, void* lse = nullptr) {
  auto kernel = bound_attention_kernel<D, CAUSAL, FLOOR, WITH_LSE, SHIFT>;
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
