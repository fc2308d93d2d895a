// The decoder attention backward on Hopper (sm_90a): the two templates
// behind K4a/K4b (decoder_attention_bwd.cu: causal GQA, D = 128, and the
// ring's non-causal form).  They replace the two Pallas kernels of
// _bwd_impl (mjvideo_tpu/ops/flash_attention.py:708):
//   bwd_dkdv_kernel <- _bwd_dkdv_kernel (:603, call :769): dK, dV for one kv
//                      block
//   bwd_dq_kernel   <- _bwd_dq_kernel   (:656, call :812): dQ for one q block
// Both recompute p = exp(scale * q k^T - lse) from the true lse that the
// forward wrote (K2 lse or K3 lse), under the
// causal mask and per-row q_offset when CAUSAL, and under the (B, K) key
// mask when one is given, with delta = rowsum(dO * O) reduced before the
// launch, as _bwd_impl does.  Rounding as in the TPU kernels: p is rounded
// to bf16 before dV += p^T dO; dS = p (dO V^T - delta) scale is rounded to
// bf16 before dK += dS^T Q and dQ += dS K; accumulation in fp32.
//
// What bounds it on this card: four products of 64 x 64 x D per tile pair
// (two to recompute s and dO V^T, two to accumulate), compute-bound at the
// training shapes (T = 800-3,072, D = 128); the tiles come from L2.  (The
// ViT's backward, K4 nc, runs on attention_bwd_sm90.cuh.)
//
// Design (first, simple version, on the K1/K2 template of
// bound_attention.cuh: WMMA 16x16x16 bf16 fragments with fp32 accumulation,
// synchronous 16-byte staging into padded shared tiles, rows past Q or K
// staged as zeros and given p = 0):
// * bwd_dkdv_kernel: one CTA of 4 warps per (b, kv head, 64-key tile); each
//   warp owns 16 keys and keeps their dK and dV rows in fp32 fragments for
//   the whole walk.  The TPU kernel wrote fp32 partials per q head and
//   summed the GQA group outside (:832-833); here the CTA loops over the G q
//   heads of its kv head itself, and over the q tiles (from the first one
//   that can see its keys when CAUSAL), so dK and dV are written once, in
//   bf16, with no partial buffers.  A masked key keeps p = dS = 0 and so
//   writes exactly 0.
// * bwd_dq_kernel: one CTA of 4 warps per (b, q head, 64 q rows); each warp
//   owns 16 rows and walks the kv tiles (up to the diagonal when CAUSAL).  A
//   dead row (lse = kDeadLse) gives p = 0 and so dq = 0 exactly.
// Keys past K get p = 0 by the j < K test in both, causal or not: a key
// staged as zeros has s = 0 and would otherwise enter with p = exp(-lse).
// Each warp computes its 16 x 64 block of s and of dO V^T into one fp32
// scratch row (s in columns 0-63, dO V^T in 64-127); the elementwise pass
// reads it lane j on column j and writes p and dS as bf16 A operands.  The
// same rows later hold the warp's D output columns on their way to device
// memory, so a row is max(D, 2 * kBlockK) floats wide (plus padding).
// Later work: wgmma, TMA, keeping s and dS in registers.
#pragma once

#include "bound_attention.cuh"

namespace mjv {

template <int D>
struct BwdSmem {
  static constexpr int kLdT = D + 8;  // bf16 tile rows, padded
  static constexpr int kLdS =
      (D > 2 * kBlockK ? D : 2 * kBlockK) + 4;  // fp32 scratch rows, padded
  static constexpr size_t kTile = size_t(kBlockQ) * kLdT * sizeof(bf16);
  static constexpr size_t kS = size_t(kWarps) * 16 * kLdS * sizeof(float);
  static constexpr size_t kP = size_t(kWarps) * 16 * kLdP * sizeof(bf16);
  static constexpr size_t kRows = size_t(kBlockQ) * sizeof(float);
  // dK/dV: K, V, Q, dO tiles; scratch; p; dS; lse and delta of the q tile.
  static constexpr size_t kDkdv = 4 * kTile + kS + 2 * kP + 2 * kRows;
  // dQ: Q, dO, K, V tiles; scratch; dS; lse and delta of the q rows.
  static constexpr size_t kDq = 4 * kTile + kS + kP + 2 * kRows;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Sw[:, 0:64] = A1 B1^T and Sw[:, 64:128] = A2 B2^T for one warp: A1, A2 its
// 16 rows (16 x D), B1, B2 two 64-row tiles (64 x D), all in shared memory.
template <int D, int LT, int LS>
__device__ __forceinline__ void two_products_t(float* Sw, const bf16* A1,
                                               const bf16* B1, const bf16* A2,
                                               const bf16* B2) {
#pragma unroll
  for (int n = 0; n < kBlockK / 16; ++n) {
    FragC c1, c2;
    wmma::fill_fragment(c1, 0.f);
    wmma::fill_fragment(c2, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBc bm;
      wmma::load_matrix_sync(a, A1 + kk * 16, LT);
      wmma::load_matrix_sync(bm, B1 + n * 16 * LT + kk * 16, LT);
      wmma::mma_sync(c1, a, bm, c1);
      wmma::load_matrix_sync(a, A2 + kk * 16, LT);
      wmma::load_matrix_sync(bm, B2 + n * 16 * LT + kk * 16, LT);
      wmma::mma_sync(c2, a, bm, c2);
    }
    wmma::store_matrix_sync(Sw + n * 16, c1, LS, wmma::mem_row_major);
    wmma::store_matrix_sync(Sw + kBlockK + n * 16, c2, LS,
                            wmma::mem_row_major);
  }
}

// acc[n] += A (16 x 64, bf16 rows of stride kLdP) B (64 x D tile).
template <int D, int LT>
__device__ __forceinline__ void accumulate(FragC (&acc)[D / 16],
                                           const bf16* A, const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr bm;
      wmma::load_matrix_sync(bm, B + kk * 16 * LT + n * 16, LT);
      wmma::mma_sync(acc[n], a, bm, acc[n]);
    }
  }
}

// Write a warp's 16 x D fp32 fragments as bf16 rows row0.. of a dense
// (rows_total, ...) output with row stride `stride`, through Sw.
template <int D, int LS>
__device__ __forceinline__ void write_rows(FragC (&acc)[D / 16], float* Sw,
                                           bf16* dst, long long stride,
                                           int row0, int rows_total,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(Sw + n * 16, acc[n], LS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    if (row0 + r >= rows_total) break;
    bf16* row = dst + (long long)(row0 + r) * stride;
    for (int c = lane; c < D; c += 32) row[c] = __float2bfloat16(Sw[r * LS + c]);
  }
  __syncwarp();
}

// q, dout: (B, Q, Hq, D) with strides (qsb, qss, D, 1), (dsb, dss, D, 1);
// k, v: (B, K, Hkv, D) with (ksb, kss, D, 1), (vsb, vss, D, 1); lse, delta:
// dense (B, Hq, Q) fp32; mask: (B, K) int32 or null; q_offset: (B,) or null
// (read only when CAUSAL).  dk, dv: dense (B, K, Hkv, D).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ mask, const int* __restrict__ q_offset,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Q, int K,
                int Hq, int Hkv, long long qsb, long long qss, long long ksb,
                long long kss, long long vsb, long long vss, long long dsb,
                long long dss, float scale) {
  using S = BwdSmem<D>;
  constexpr int LT = S::kLdT;
  constexpr int LS = S::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::kTile);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * S::kTile);
  bf16* Os = reinterpret_cast<bf16*>(smem + 3 * S::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::kTile);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 4 * S::kTile + S::kS);
  bf16* DSs = reinterpret_cast<bf16*>(smem + 4 * S::kTile + S::kS + S::kP);
  float* Ls = reinterpret_cast<float*>(smem + 4 * S::kTile + S::kS +
                                       2 * S::kP);
  float* Dl = Ls + kBlockQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kBlockK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int off = (CAUSAL && q_offset) ? q_offset[b] : 0;
  const int key0 = k0 + warp * 16;  // this warp's first key

  stage_tile<D, kBlockK, LT>(Ks, k + b * ksb + hk * D, kss, k0, K);
  stage_tile<D, kBlockK, LT>(Vs, v + b * vsb + hk * D, vss, k0, K);
  const bf16* Kw = Ks + warp * 16 * LT;
  const bf16* Vw = Vs + warp * 16 * LT;
  float* Sw = Ss + warp * 16 * LS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  bf16* DSw = DSs + warp * 16 * kLdP;

  unsigned key_ok = 0;  // bit r: key key0 + r exists and is not masked
  for (int r = 0; r < 16; ++r) {
    const int j = key0 + r;
    bool ok = j < K;
    if (ok && mask != nullptr) ok = mask[(long long)b * K + j] != 0;
    key_ok |= unsigned(ok) << r;
  }

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_q = (Q + kBlockQ - 1) / kBlockQ;
  const int first_q = CAUSAL ? max(0, k0 - off) / kBlockQ : 0;  // causal skip
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_h = lse + ((long long)b * Hq + h) * Q;
    const float* delta_h = delta + ((long long)b * Hq + h) * Q;
    for (int qt = first_q; qt < n_q; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // every warp is done with the previous q tile
      stage_tile<D, kBlockQ, LT>(Qs, q + b * qsb + h * D, qss, q0, Q);
      stage_tile<D, kBlockQ, LT>(Os, dout + b * dsb + h * D, dss, q0, Q);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const bool in = q0 + i < Q;
        Ls[i] = in ? lse_h[q0 + i] : kDeadLse;
        Dl[i] = in ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = K_w Q^T and (dO V^T)^T = V_w dO^T: 16 keys x 64 q rows.
      two_products_t<D, LT, LS>(Sw, Kw, Qs, Vw, Os);
      __syncwarp();

      // Lane c serves q rows q0 + c and q0 + c + 32 of every key row r.
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        const int qpos = off + q0 + c;  // global position of the q row
        const bool q_in = q0 + c < Q;
        const float lse_c = Ls[c];
        const float delta_c = Dl[c];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const bool ok = q_in && ((key_ok >> r) & 1u) &&
                          (!CAUSAL || key0 + r <= qpos);
          const float p = ok ? expf(Sw[r * LS + c] * scale - lse_c) : 0.f;
          const float ds = p * (Sw[r * LS + kBlockK + c] - delta_c) * scale;
          Pw[r * kLdP + c] = __float2bfloat16(p);
          DSw[r * kLdP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      accumulate<D, LT>(dv_acc, Pw, Os);   // dV += p^T dO
      accumulate<D, LT>(dk_acc, DSw, Qs);  // dK += dS^T Q
    }
  }

  const long long row_stride = (long long)Hkv * D;
  const long long base = ((long long)b * K * Hkv + hk) * D;
  write_rows<D, LS>(dk_acc, Sw, dk + base, row_stride, key0, K, lane);
  write_rows<D, LS>(dv_acc, Sw, dv + base, row_stride, key0, K, lane);
}

// Same operands as bwd_dkdv_kernel; dq: dense (B, Q, Hq, D).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ mask, const int* __restrict__ q_offset,
              bf16* __restrict__ dq, int Q, int K, int Hq, int Hkv,
              long long qsb, long long qss, long long ksb, long long kss,
              long long vsb, long long vss, long long dsb, long long dss,
              float scale) {
  using S = BwdSmem<D>;
  constexpr int LT = S::kLdT;
  constexpr int LS = S::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = reinterpret_cast<bf16*>(smem + S::kTile);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * S::kTile);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * S::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * S::kTile);
  bf16* DSs = reinterpret_cast<bf16*>(smem + 4 * S::kTile + S::kS);
  float* Ls = reinterpret_cast<float*>(smem + 4 * S::kTile + S::kS + S::kP);
  float* Dl = Ls + kBlockQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = (CAUSAL && q_offset) ? q_offset[b] : 0;

  stage_tile<D, kBlockQ, LT>(Qs, q + b * qsb + h * D, qss, q0, Q);
  stage_tile<D, kBlockQ, LT>(Os, dout + b * dsb + h * D, dss, q0, Q);
  const float* lse_h = lse + ((long long)b * Hq + h) * Q;
  const float* delta_h = delta + ((long long)b * Hq + h) * Q;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const bool in = q0 + i < Q;
    Ls[i] = in ? lse_h[q0 + i] : kDeadLse;
    Dl[i] = in ? delta_h[q0 + i] : 0.f;
  }
  const bf16* Qw = Qs + warp * 16 * LT;
  const bf16* Ow = Os + warp * 16 * LT;
  float* Sw = Ss + warp * 16 * LS;
  bf16* DSw = DSs + warp * 16 * kLdP;
  const int row0 = warp * 16;  // this warp's first row within the q tile

  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  int n_kv = (K + kBlockK - 1) / kBlockK;
  if (CAUSAL) n_kv = min(n_kv, (off + q0 + kBlockQ - 1) / kBlockK + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_tile<D, kBlockK, LT>(Ks, k + b * ksb + hk * D, kss, k0, K);
    stage_tile<D, kBlockK, LT>(Vs, v + b * vsb + hk * D, vss, k0, K);
    __syncthreads();

    // s = Q_w K^T and dO_w V^T: 16 q rows x 64 keys.
    two_products_t<D, LT, LS>(Sw, Qw, Ks, Ow, Vs);
    __syncwarp();

    // Lane c serves keys k0 + c and k0 + c + 32 of every row r.
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = lane + 32 * h2;
      const int j = k0 + c;
      bool key_ok = j < K;
      if (key_ok && mask != nullptr) key_ok = mask[(long long)b * K + j] != 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int i = q0 + row0 + r;
        const bool ok = key_ok && i < Q && (!CAUSAL || j <= off + i);
        const float p =
            ok ? expf(Sw[r * LS + c] * scale - Ls[row0 + r]) : 0.f;
        const float ds =
            p * (Sw[r * LS + kBlockK + c] - Dl[row0 + r]) * scale;
        DSw[r * kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    accumulate<D, LT>(dq_acc, DSw, Ks);  // dQ += dS K
  }

  write_rows<D, LS>(dq_acc, Sw,
                    dq + ((long long)b * Q * Hq + h) * D, (long long)Hq * D,
                    q0 + row0, Q, lane);
}

template <int D, bool CAUSAL>
int launch_bwd_dkdv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* mask, const void* q_offset, void* dk,
                    void* dv, int B, int Q, int K, int Hq, int Hkv,
                    long long qsb, long long qss, long long ksb,
                    long long kss, long long vsb, long long vss,
                    long long dsb, long long dss, float scale, void* stream) {
  auto kernel = bwd_dkdv_kernel<D, CAUSAL>;
  const size_t smem = BwdSmem<D>::kDkdv;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((K + kBlockK - 1) / kBlockK, Hkv, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(mask), static_cast<const int*>(q_offset),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, dsb, dss, scale);
  return int(cudaGetLastError());
}

template <int D, bool CAUSAL>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* mask, const void* q_offset, void* dq, int B,
                  int Q, int K, int Hq, int Hkv, long long qsb,
                  long long qss, long long ksb, long long kss, long long vsb,
                  long long vss, long long dsb, long long dss, float scale,
                  void* stream) {
  auto kernel = bwd_dq_kernel<D, CAUSAL>;
  const size_t smem = BwdSmem<D>::kDq;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Q + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(mask), static_cast<const int*>(q_offset),
      static_cast<bf16*>(dq), Q, K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss,
      dsb, dss, scale);
  return int(cudaGetLastError());
}

}  // namespace mjv
