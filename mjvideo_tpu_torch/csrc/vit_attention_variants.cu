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
// kv_valid (S for B1 and B2) are staged as zeros and given p = 0, the same
// function.
//
// What bounds it on this card: at (8, 1025, 16, 64) bf16 the two products
// are 34.4 GFLOP against 50.4 MB of q/k/v in and 16.8 MB out, so the work
// is compute-bound (0.0348 ms at 989 TFLOP/s, 0.0201 ms at 3.35 TB/s).
// The TPU kernels take the row max in one step over a whole kv row held in
// VMEM; an SM cannot hold 1025
// keys' fp32 scores for 64 rows cheaply, so the modes with a max (exp2,
// bf16s, B2, B3) walk the keys twice: a first pass of q k^T takes each
// row's exact max, a second recomputes the scores and accumulates p and
// p v.  Every p is then computed against the final max, at the twin's
// rounding points, with no rescale of the accumulator: the kernel differs
// from its twin only in the fp32 order of the sums.  The price is a third
// product (1.5x K1's tensor-core work); the unshifted modes walk once.
//
// Design (first, simple version), K1's (bound_attention.cuh): WMMA 16x16x16
// bf16 fragments with fp32 accumulation, 64-key tiles staged through shared
// memory with 16-byte loads, 16 q rows per warp, the exp pass lane j on
// keys j and j + 32 of each row.  A CTA serves HP adjacent heads of one
// (b, BQ-row q tile): it stages each k/v row of its head group as one
// HP * 128-byte burst, and its HP * BQ / 16 warps each take 16 rows of one
// head.  Shared memory: 53 KB at (HP, BQ) = (1, 64), 106 KB at (2, 64), and
// 142 KB at (4, 32), where the q tile is halved (as the TPU version shrank
// block_q) to keep 8 warps; that gives 4, 2 and 1 CTAs per SM.
// Later work: the online max (one walk), wgmma, TMA and a producer warp.
#include <math_constants.h>

#include "bound_attention.cuh"

namespace {

using mjv::bf16;
namespace wmma = nvcuda::wmma;

enum class Mode : int {
  kExp2 = 0,       // B1 "exp2"
  kBf16s = 1,      // B1 "bf16s"
  kNoMax = 2,      // B1 "nomax"
  kExp2NoMax = 3,  // B1 "exp2_nomax"
  kExact = 4,      // B2, B3: exp(s * scale - max), l floored at 1e-30
};

__host__ __device__ constexpr bool folds_q(Mode m) {
  return m == Mode::kExp2 || m == Mode::kExp2NoMax;
}
__host__ __device__ constexpr bool takes_max(Mode m) {
  return m == Mode::kExp2 || m == Mode::kBf16s || m == Mode::kExact;
}

constexpr int kD = 64;
constexpr int kBlockK = 64;
constexpr int kLdT = kD + 8;       // bf16 q/k/v tile rows, padded
constexpr int kLdS = kBlockK + 4;  // fp32 score rows, padded
constexpr int kLdP = kBlockK + 8;  // bf16 p rows, padded

template <int HP, int BQ>
struct VSmem {
  static constexpr int kWarps = HP * BQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kQ = size_t(HP) * BQ * kLdT * sizeof(bf16);
  static constexpr size_t kK = size_t(HP) * kBlockK * kLdT * sizeof(bf16);
  static constexpr size_t kS = size_t(kWarps) * 16 * kLdS * sizeof(float);
  static constexpr size_t kP = size_t(kWarps) * 16 * kLdP * sizeof(bf16);
  static constexpr size_t kBytes = kQ + 2 * kK + kS + kP;
};

// Copy rows [r0, r0 + ROWS) of HP adjacent heads (src points at head 0 of
// the group; row stride `stride` elements) into HP (ROWS, kD) shared tiles,
// head j at dst + j * ROWS * kLdT.  Neighbouring threads read neighbouring
// 16 bytes of one row's HP * kD contiguous elements.  Rows at or past
// `rows_total` are zero-filled.  FOLD multiplies each element by `fold` in
// fp32 and rounds it back to bf16 (B1's exp2 modes, on the q tile).
template <int ROWS, int HP, int NT, bool FOLD>
__device__ __forceinline__ void stage_heads(bf16* dst, const bf16* src,
                                            long long stride, int r0,
                                            int rows_total, float fold) {
  constexpr int kVec = kD / 8;  // 16-byte vectors per head row
  for (int idx = threadIdx.x; idx < ROWS * HP * kVec; idx += NT) {
    const int r = idx / (HP * kVec);
    const int j = (idx / kVec) % HP;
    const int c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_total) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride +
                                            j * kD + c);
      if (FOLD) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = __float2bfloat16(__bfloat162float(e[i]) * fold);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + (j * ROWS + r) * kLdT + c) = val;
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The logit a mode takes its max of and exponentiates: the raw score for
// the exp2 modes (q carries the scale), bf16(s * scale) for bf16s, s *
// scale otherwise.
template <Mode MODE>
__device__ __forceinline__ float logit(float s, float scale) {
  if (folds_q(MODE)) return s;
  if (MODE == Mode::kBf16s) return round_bf16(s * scale);
  return s * scale;
}

// p of a live key from its logit x and the row's max m.
template <Mode MODE>
__device__ __forceinline__ float prob(float x, float m) {
  switch (MODE) {
    case Mode::kExp2:
      return exp2f(x - m);
    case Mode::kExp2NoMax:
      return exp2f(x);
    case Mode::kBf16s:  // s - m and exp(s - m) each rounded to bf16
      return round_bf16(expf(round_bf16(x - m)));
    case Mode::kNoMax:
      return expf(x);
    default:
      return expf(x - m);
  }
}

// One CTA per (BQ-row q tile, group of HP heads, b).  `scale` is the fold
// factor scale * log2(e) for the exp2 modes and the score scale otherwise.
template <Mode MODE, int HP, int BQ>
__global__ void __launch_bounds__(VSmem<HP, BQ>::kThreads)
variant_attention_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int S, int H, int kv_valid, long long qsb,
                         long long qss, long long ksb, long long kss,
                         long long vsb, long long vss, float scale) {
  using SM = VSmem<HP, BQ>;
  constexpr int NT = SM::kThreads;
  constexpr int W = BQ / 16;  // warps per head
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::kQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::kQ + SM::kK);
  float* Ss = reinterpret_cast<float*>(smem + SM::kQ + 2 * SM::kK);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::kQ + 2 * SM::kK + SM::kS);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = warp / W;  // this warp's head within the group
  const int q0 = blockIdx.x * BQ;
  const int h0 = blockIdx.y * HP;
  const int b = blockIdx.z;
  const int rw = (warp % W) * 16;  // this warp's first row in the q tile

  const bf16* Qw = Qs + (j * BQ + rw) * kLdT;
  const bf16* Kj = Ks + j * kBlockK * kLdT;
  const bf16* Vj = Vs + j * kBlockK * kLdT;
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  const bf16* kb = k + b * ksb + h0 * kD;
  const bf16* vb = v + b * vsb + h0 * kD;

  stage_heads<BQ, HP, NT, folds_q(MODE)>(Qs, q + b * qsb + h0 * kD, qss, q0,
                                         S, scale);
  const int n_kv = (kv_valid + kBlockK - 1) / kBlockK;

  // Pass 1 (the modes with a max): each row's exact max over its live
  // keys, held by every lane.  kv_valid >= 1, so every m ends finite.
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = takes_max(MODE) ? -CUDART_INF_F : 0.f;
  }
  if (takes_max(MODE)) {
    for (int t = 0; t < n_kv; ++t) {
      const int k0 = t * kBlockK;
      __syncthreads();  // every warp is done with the previous k tile
      stage_heads<kBlockK, HP, NT, false>(Ks, kb, kss, k0, kv_valid, 0.f);
      __syncthreads();
      warp_scores(Qw, Kj, Sw);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float x = -CUDART_INF_F;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int c = lane + 32 * h2;
          if (k0 + c < kv_valid) {
            x = fmaxf(x, logit<MODE>(Sw[r * kLdS + c], scale));
          }
        }
        m[r] = fmaxf(m[r], mjv::warp_max(x));
      }
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
    stage_heads<kBlockK, HP, NT, false>(Ks, kb, kss, k0, kv_valid, 0.f);
    stage_heads<kBlockK, HP, NT, false>(Vs, vb, vss, k0, kv_valid, 0.f);
    __syncthreads();
    warp_scores(Qw, Kj, Sw);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = lane + 32 * h2;
        const float p =
            k0 + c < kv_valid
                ? prob<MODE>(logit<MODE>(Sw[r * kLdS + c], scale), m[r])
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
        wmma::load_matrix_sync(bm, Vj + kk * 16 * kLdT + n * 16, kLdT);
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
  const int h = h0 + j;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float lr = mjv::warp_sum(l[r]);
    const int qi = q0 + rw + r;
    if (qi >= S) continue;
    // B1 divides by l as it is (the TPU kernels do); B2 and B3 floor it.
    if (MODE == Mode::kExact) lr = fmaxf(lr, 1e-30f);
    bf16* orow = out + (((long long)b * S + qi) * H + h) * kD;
    for (int c = lane; c < kD; c += 32) {
      orow[c] = __float2bfloat16(Sw[r * kLdS + c] / lr);
    }
  }
}

template <Mode MODE, int HP, int BQ>
int launch_variant(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int kv_valid, long long qsb,
                   long long qss, long long ksb, long long kss, long long vsb,
                   long long vss, float scale, void* stream) {
  using SM = VSmem<HP, BQ>;
  auto kernel = variant_attention_kernel<MODE, HP, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SM::kBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + BQ - 1) / BQ, H / HP, B);
  kernel<<<grid, SM::kThreads, SM::kBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, kv_valid,
      qsb, qss, ksb, kss, vsb, vss, scale);
  return int(cudaGetLastError());
}

}  // namespace

// B1.  mode: 0 exp2, 1 bf16s, 2 nomax, 3 exp2_nomax (kernels.VARIANT_MODES);
// scale: scale * log2(e) for the exp2 modes, the score scale otherwise.
extern "C" int mjv_vit_attention_variant(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int mode, void* stream) {
  if (D != kD) return int(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      return launch_variant<Mode::kExp2, 1, 64>(q, k, v, out, B, S, H, S, qsb,
                                                qss, ksb, kss, vsb, vss,
                                                scale, stream);
    case 1:
      return launch_variant<Mode::kBf16s, 1, 64>(q, k, v, out, B, S, H, S,
                                                 qsb, qss, ksb, kss, vsb, vss,
                                                 scale, stream);
    case 2:
      return launch_variant<Mode::kNoMax, 1, 64>(q, k, v, out, B, S, H, S,
                                                 qsb, qss, ksb, kss, vsb, vss,
                                                 scale, stream);
    case 3:
      return launch_variant<Mode::kExp2NoMax, 1, 64>(q, k, v, out, B, S, H, S,
                                                     qsb, qss, ksb, kss, vsb,
                                                     vss, scale, stream);
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
      return launch_variant<Mode::kExact, 1, 64>(q, k, v, out, B, S, H, S,
                                                 qsb, qss, ksb, kss, vsb, vss,
                                                 scale, stream);
    case 2:
      return launch_variant<Mode::kExact, 2, 64>(q, k, v, out, B, S, H, S,
                                                 qsb, qss, ksb, kss, vsb, vss,
                                                 scale, stream);
    case 4:
      return launch_variant<Mode::kExact, 4, 32>(q, k, v, out, B, S, H, S,
                                                 qsb, qss, ksb, kss, vsb, vss,
                                                 scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// B3 over the keys below kv_valid (1 <= kv_valid <= S).  It shares B2's
// hp = 1 instantiation: what it adds to K1 is the exact max and kv_valid.
extern "C" int mjv_vit_attention_bshd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int kv_valid, void* stream) {
  if (D != kD || kv_valid < 1 || kv_valid > S) {
    return int(cudaErrorInvalidValue);
  }
  return launch_variant<Mode::kExact, 1, 64>(q, k, v, out, B, S, H, kv_valid,
                                             qsb, qss, ksb, kss, vsb, vss,
                                             scale, stream);
}
