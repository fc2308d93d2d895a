// B1, B2 and B3: the ViT attention variants of the JAX package's A/B
// harnesses, on Hopper (sm_90a).  Replaces three Pallas TPU kernels:
//   B1  variant_impl        (benchmarks/vit_attn_variants.py:63): whole-row
//       non-causal softmax in mode exp2 (scale * log2(e) folded into q,
//       exp2), bf16s (bf16 logits, max and exp), nomax (no shift) or
//       exp2_nomax (folded q, exp2, no shift);
//   B2  tmajor_impl         (benchmarks/vit_attn_variants.py:150): the exact
//       row max on token-major (B, S, H, D) q/k/v, hp adjacent heads per
//       program, no transpose;
//   B3  nc_bshd_attention   (benchmarks/vit_layout_ab.py:72, kernel
//       _nc_bshd_kernel :36): the exact row max on the untransposed
//       (B, S, H, D) view, the keys at or past kv_valid excluded.
// All three are non-causal and maskless at D = 64 (InternViT-300M heads),
// q/k/v (B, S, H, 64) with dense heads and free row strides (the views the
// ViT makes of its qkv product), the output dense (B, S, H, 64), which is
// B3's (B, S, H * D).  The TPU kernels pad the keys to a multiple of 8 with
// zeros and subtract the pad's mass from l; here the keys at or past
// kv_valid (S for B1 and B2) are zeros or never read and get p = 0, the
// same function.
//
// What bounds it on this card: at (8, 1025, 16, 64) bf16 the two products
// are 34.4 GFLOP against 50.4 MB of q/k/v in and 16.8 MB out, so the work
// is compute-bound (0.0348 ms at 989 TFLOP/s, 0.0201 ms at 3.35 TB/s).
//
// B1 and B2 run the wgmma/TMA forward template of
// decoder_attention_sm90.cuh, K1's (design there), each walking the keys
// once: B2 is K3's online softmax (ShiftMode::kExact) at D = 64 with hp
// heads a CTA (a Config per hp below); B1's modes are the template's
// policies: exp2 = kExact with q folded in shared memory (Variant::kFoldQ),
// exp2_nomax = kZero with the fold, nomax = kZero, bf16s = kExact at the
// twin's bf16 rounding points (Variant::kBf16s).  Under a max each p is
// taken against the running max and rescaled, where the twin takes it
// against the final max: they differ in fp32 rounding, and in bf16s where
// an earlier max rounds d or p to another bf16.  A launch that fails
// returns its error; nothing falls back.
//
// B3 still runs the first template (K1's old one, bound_attention.cuh):
// WMMA 16x16x16 bf16 fragments with fp32 accumulation, 64-key tiles staged
// through shared memory with 16-byte loads, 16 q rows per warp and 64 a
// CTA, the exp pass lane j on keys j and j + 32 of each row, and two walks
// over the keys: a first pass of q k^T takes each row's exact max, a second
// recomputes the scores and accumulates p against it (53 KB of shared
// memory and at most 128 registers a thread: 4 CTAs per SM).
#include <math_constants.h>

#include "bound_attention.cuh"
#include "decoder_attention_sm90.cuh"

namespace {

namespace sm90 = mjv::attention_sm90;
using mjv::bf16;
using sm90::ShiftMode;
using sm90::Variant;
namespace wmma = nvcuda::wmma;

// The Configs (consumer warpgroups, stages, heads a CTA, keys a tile),
// chosen by A/B on the card (tools/vit_attn_variants_torch.py --configs,
// PERF.md).  B1: K1's, the fastest for every mode.  B2: one key tile for
// every hp, so that each row walks the same tiles and every hp gives the
// same bits; hp 4's four warpgroups have registers for 64-key tiles only
// (Regs<4>), so 64 for all, the fastest warpgroups and stages of each hp
// at that tile (hp 1 at 128 keys, K1's grid, measured 5% faster).
using VariantConfig = sm90::D64;
using Hp1 = sm90::Config<64, 3, 3, 1, 64>;
using Hp2 = sm90::Config<64, 4, 4, 2, 64>;
using Hp4 = sm90::Config<64, 4, 3, 4, 64>;

// B1 or B2 over all S keys; scale as the template's (kFoldQ: the fold).
template <class C, ShiftMode SHIFT, Variant VAR = Variant::kPlain>
int launch_sm90(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, long long qsb, long long qss,
                long long ksb, long long kss, long long vsb, long long vss,
                float scale, void* stream) {
  return sm90::launch_attention<C, false, SHIFT, false, VAR>(
      q, k, v, nullptr, nullptr, 1, nullptr, out, nullptr, B, S, S, H, H, qsb,
      qss, ksb, kss, vsb, vss, scale, stream);
}

// B3's first template.
constexpr int kD = 64;
constexpr int kBlockK = 64;
constexpr int kBlockQ = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdT = kD + 8;       // bf16 q/k/v tile rows, padded
constexpr int kLdS = kBlockK + 4;  // fp32 score rows, padded
constexpr int kLdP = kBlockK + 8;  // bf16 p rows, padded
constexpr size_t kSmemQ = size_t(kBlockQ) * kLdT * sizeof(bf16);
constexpr size_t kSmemK = size_t(kBlockK) * kLdT * sizeof(bf16);
constexpr size_t kSmemS = size_t(kWarps) * 16 * kLdS * sizeof(float);
constexpr size_t kSmemP = size_t(kWarps) * 16 * kLdP * sizeof(bf16);
constexpr size_t kSmemBytes = kSmemQ + 2 * kSmemK + kSmemS + kSmemP;

// Copy rows [r0, r0 + ROWS) of one head (row stride `stride` elements)
// into a (ROWS, kD) shared tile.  Neighbouring threads read neighbouring
// 16 bytes of a row.  Rows at or past `rows_total` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int r0,
                                           int rows_total) {
  constexpr int kVec = kD / 8;  // 16-byte vectors per head row
  for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_total) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

// s = q_w k^T for one warp's 16 rows and a 64-key tile, fp32, into Sw.
__device__ __forceinline__ void warp_scores(const bf16* Qw, const bf16* Kt,
                                            float* Sw) {
#pragma unroll
  for (int n = 0; n < kBlockK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
    wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
      wmma::load_matrix_sync(a, Qw + kk * 16, kLdT);
      wmma::load_matrix_sync(bm, Kt + n * 16 * kLdT + kk * 16, kLdT);
      wmma::mma_sync(s_frag, a, bm, s_frag);
    }
    wmma::store_matrix_sync(Sw + n * 16, s_frag, kLdS, wmma::mem_row_major);
  }
}

// B3: one CTA per (64-row q tile, head, b); p = exp(s * scale - max), l
// floored at 1e-30.  Four CTAs an SM (53 KB of shared memory each): at most
// 128 registers a thread.
__global__ void __launch_bounds__(kThreads, 4)
variant_attention_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int S, int H, int kv_valid, long long qsb,
                         long long qss, long long ksb, long long kss,
                         long long vsb, long long vss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + kSmemQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kSmemQ + kSmemK);
  float* Ss = reinterpret_cast<float*>(smem + kSmemQ + 2 * kSmemK);
  bf16* Ps = reinterpret_cast<bf16*>(smem + kSmemQ + 2 * kSmemK + kSmemS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rw = warp * 16;  // this warp's first row in the q tile

  const bf16* Qw = Qs + rw * kLdT;
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  const bf16* kb = k + b * ksb + h * kD;
  const bf16* vb = v + b * vsb + h * kD;

  stage_rows<kBlockQ>(Qs, q + b * qsb + h * kD, qss, q0, S);
  const int n_kv = (kv_valid + kBlockK - 1) / kBlockK;

  // Pass 1: each row's exact max over its live keys, held by every lane.
  // kv_valid >= 1, so every m ends finite.
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = -CUDART_INF_F;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous k tile
    stage_rows<kBlockK>(Ks, kb, kss, k0, kv_valid);
    __syncthreads();
    warp_scores(Qw, Ks, Sw);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float x = -CUDART_INF_F;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        if (k0 + c < kv_valid) x = fmaxf(x, Sw[r * kLdS + c] * scale);
      }
      m[r] = fmaxf(m[r], mjv::warp_max(x));
    }
  }

  // Pass 2: p against the final max, l and p v.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(o_frag[n], 0.f);
  float l[16];  // this lane's share of each row's sum
#pragma unroll
  for (int r = 0; r < 16; ++r) l[r] = 0.f;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_rows<kBlockK>(Ks, kb, kss, k0, kv_valid);
    stage_rows<kBlockK>(Vs, vb, vss, k0, kv_valid);
    __syncthreads();
    warp_scores(Qw, Ks, Sw);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        const float p = k0 + c < kv_valid
                            ? expf(Sw[r * kLdS + c] * scale - m[r])
                            : 0.f;
        l[r] += p;
        Pw[r * kLdP + c] = __float2bfloat16(p);
      }
    }
    __syncwarp();
    // acc += p_w v: (16 x 64) x (64 x kD), fp32.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk * 16, kLdP);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Vs + kk * 16 * kLdT + n * 16, kLdT);
        wmma::mma_sync(o_frag[n], a, bm, o_frag[n]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(Sw + n * 16, o_frag[n], kLdS,
                            wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float lr = fmaxf(mjv::warp_sum(l[r]), 1e-30f);
    const int qi = q0 + rw + r;
    if (qi >= S) continue;
    bf16* orow = out + (((long long)b * S + qi) * H + h) * kD;
    for (int c = lane; c < kD; c += 32) {
      orow[c] = __float2bfloat16(Sw[r * kLdS + c] / lr);
    }
  }
}

}  // namespace

// B1.  mode: 0 exp2, 1 bf16s, 2 nomax, 3 exp2_nomax (kernels.VARIANT_MODES);
// scale: scale * log2(e) for the exp2 modes (the fold), the score scale
// otherwise.
extern "C" int mjv_vit_attention_variant(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int mode, void* stream) {
  if (D != kD) return int(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      return launch_sm90<VariantConfig, ShiftMode::kExact, Variant::kFoldQ>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    case 1:
      return launch_sm90<VariantConfig, ShiftMode::kExact, Variant::kBf16s>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    case 2:
      return launch_sm90<VariantConfig, ShiftMode::kZero>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    case 3:
      return launch_sm90<VariantConfig, ShiftMode::kZero, Variant::kFoldQ>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// B2 with hp in kernels.TMAJOR_HP heads per CTA (hp dividing H).
extern "C" int mjv_vit_attention_tmajor(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int hp, void* stream) {
  if (D != kD || hp < 1 || H % hp) return int(cudaErrorInvalidValue);
  switch (hp) {
    case 1:
      return launch_sm90<Hp1, ShiftMode::kExact>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    case 2:
      return launch_sm90<Hp2, ShiftMode::kExact>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    case 4:
      return launch_sm90<Hp4, ShiftMode::kExact>(
          q, k, v, out, B, S, H, qsb, qss, ksb, kss, vsb, vss, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// B3 over the keys below kv_valid (1 <= kv_valid <= S).
extern "C" int mjv_vit_attention_bshd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int kv_valid, void* stream) {
  if (D != kD || kv_valid < 1 || kv_valid > S) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      variant_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  variant_attention_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, kv_valid,
      qsb, qss, ksb, kss, vsb, vss, scale);
  return int(cudaGetLastError());
}
