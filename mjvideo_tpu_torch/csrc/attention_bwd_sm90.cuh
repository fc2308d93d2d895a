// The attention backward for Hopper (sm_90a): wgmma, TMA and a producer
// warp, on the helpers of the forward template (decoder_attention_sm90.cuh).
// Two kernels replace the two Pallas kernels of _bwd_impl
// (mjvideo_tpu/ops/flash_attention.py:708):
//   dkdv_kernel <- _bwd_dkdv_kernel (:603, call :769): dK and dV
//   dq_kernel   <- _bwd_dq_kernel   (:656, call :812): dQ
// in the two forms the port reaches:
//   K4 nc (vit_attention_bwd.cu, D = 64): the ViT's custom VJP (_vjp_bwd
//     :874), non-causal, no mask, one kv head per q head, Q = K = S;
//   K4a/K4b (decoder_attention_bwd.cu, D = 128): the decoder's, causal
//     with a per-batch q_offset (negative for a later shard's ring chunk,
//     positive for an earlier one and for the all-gather shard's rows
//     against all K keys) or non-causal, a (B, K) int32 key mask or none,
//     GQA (q head h reads kv head h / G, dK and dV summed over each kv
//     head's G q heads), Q != K.
// Both recompute p = exp(scale q k^T - lse) from the true lse that the
// forward wrote (K1 lse, K2 lse, K3 lse) or the ring merged, with delta =
// rowsum(dO * O) reduced before the launch (attention_delta, :254).
// Rounding as in the TPU kernels: p is rounded to bf16 before dV += p^T
// dO; dS = p (dO v^T - delta) scale is rounded to bf16 before dK += dS^T q
// and dQ += dS k; sums in fp32; dq, dk and dv written dense in bf16.
//
// What bounds it on this card: dK/dV does four products of 2 D operations
// per visible (query, key) pair and q head (s, dO v^T, p^T dO, dS^T q) and
// dQ three (s, dO v^T, dS k).  At the ViT's (8, 1025, 16, 64) that is 69
// and 52 GFLOP (0.070 and 0.052 ms at 989 TFLOP/s) on 25-34 MB; at the
// reward gradient's causal (1, 3072, 16/8, 128) with 2,362 live keys 73
// and 55 GFLOP on 26 MB.  All compute-bound, and only wgmma reaches the
// tensor cores' rate.  Beside the products each score costs one exp2 on
// the special-function unit and a few fp32 operations (the exp's
// argument, dS, two bf16 packs); at D = 64 those weigh about as much as
// the products, at D = 128 half as much.  The WMMA templates these
// replaced reached 2-6% of the bound: scores went out to an fp32 shared
// scratch and back as bf16 fragments, and the loads were synchronous.
//
// Design.
// - dK/dV: one CTA per (b, kv head, 64 keys per consumer warpgroup).  A
//   producer warp loads the CTA's k and v rows once by TMA, then streams
//   the (q, dO) tiles of kBlockN rows of each of the kv head's G q heads
//   in turn through a ring of stages (128-byte swizzle, one 64-column box
//   per 64 head columns, TMA's zero fill past Q), with each tile's lse
//   (times log2 e) and delta beside it: the (B, Hq, Q) fp32 rows are not
//   16-byte aligned at Q = 1025 or 799, which TMA cannot take, so the
//   producer's lanes load them with guarded plain loads, kDeadLse and 0
//   past Q.  Each consumer warpgroup computes s^T = k_w q^T and dP^T =
//   v_w dO^T with wgmma.m64nNk16 (both operands K-major from shared
//   memory), forms p^T and dS^T on the accumulator registers (the lse and
//   delta broadcast along the columns from the stage), rounds them to
//   bf16 in registers and feeds them as the register A operand of dV +=
//   p^T dO and dK += dS^T q, with dO and q read MN-major through the
//   transposed descriptor, as the forward's p v reads v.  The G q heads
//   are a loop in the CTA, so dK and dV are summed in registers and
//   written once: no fp32 partials (JAX's :832-833) and no atomics.
// - dQ: one CTA per (b, q head, 64 q rows per consumer warpgroup); q,
//   dO, and each thread's two rows of lse and delta are loaded once; the
//   (k, v) tiles of the q head's kv head stream through the ring, each
//   with its keys' liveness bits (the mask and j < K, ballots of the
//   producer warp, stored by its lane 0 before the stage's arrival).  s =
//   q_w k^T and dP = dO_w v^T, dS to bf16 registers, dQ += dS k with k
//   read MN-major.  No online max and no rescale: the lse is known.
// - s, p, dP and dS never touch shared memory.  Tile t + 1's two score
//   products are issued before tile t's accumulating products, so the
//   elementwise work of t + 1 runs while the tensor cores work; that needs
//   the packed operands of t and the scores of t + 1 live at once, which
//   at D = 128 (64 fp32 outputs a thread for each of dK and dV) fits
//   dK/dV's registers only at 32-row q tiles (Config below).
// - The causal walk.  Row i of batch b sees key j iff j <= q_offset[b] +
//   i.  dK/dV starts each key block at the first q tile holding a row
//   that can see one of its keys (JAX :622) and walks to the last; dQ
//   walks key tiles from 0 to the last one the CTA's last row can see
//   (JAX :673).  Only a tile that straddles the diagonal for a warp's rows
//   (or, in dQ, holds a masked key or one past K) takes the per-score
//   test, chosen once per tile and warp: a test per element would put a
//   select around every exp.  dQ orders its grid heaviest q block first
//   (the grid's slow axis runs backwards), dK/dV's natural order is
//   heaviest first already (key block 0 sees every row).
// - The key mask.  dK/dV holds its keys, so a masked key (or one past K)
//   is one row of the accumulators: its p^T and dS^T rows enter only its
//   own rows of dK and dV, which are stored as 0 (padded keys are not
//   stored).  A CTA whose keys are all masked, or that no row can see,
//   writes its zeros and returns.  dQ masks p per score from the stage's
//   bits: a key staged as zeros (past K) has s = 0 and would otherwise
//   enter with exp(-lse).
// - Exact zeros.  A dead row (lse = kDeadLse) has p = exp2(-huge) = 0
//   exactly, so dq is 0 there and it adds nothing to dK and dV; padded q
//   rows are TMA's zeros with lse = kDeadLse and delta = 0, likewise.  A
//   CTA that walks no tile stores its zero accumulators (the outputs are
//   torch.empty).
// - Two kernels and no atomics: each output row is summed by one thread
//   in a fixed order, so results are bit-identical from launch to launch.
// - The head dim, the consumer warpgroups, the stages and the streamed
//   tile's rows are a Config (below), one per kernel and
//   head dim, chosen by A/B on the card (tools/bwd_config_ab_torch.py,
//   PERF.md).  D = 64: dK/dV holds 128 keys in 2 warpgroups (232
//   registers a consumer thread) and streams 64-row q tiles through 3
//   stages; with 3 warpgroups (160 registers) or 128-row tiles its
//   scores, outputs and packed operands spill.  dQ holds 192 q rows in 3
//   warpgroups and streams 64-key tiles through 4 stages.  D = 128: both
//   hold 128 rows in 2 warpgroups; dK/dV streams 32-row q tiles through 4
//   stages, dQ 64-key tiles through 3.
#pragma once

#include "decoder_attention_sm90.cuh"

namespace mjv {
namespace attention_bwd_sm90 {

using attention_sm90::bf16;
using attention_sm90::encode_map;
using attention_sm90::fast_exp2;
using attention_sm90::fence_regs;
using attention_sm90::kDeadLse;
using attention_sm90::kLog2e;
using attention_sm90::make_desc;
using attention_sm90::mbar_arrive;
using attention_sm90::mbar_expect_tx;
using attention_sm90::mbar_init;
using attention_sm90::mbar_wait;
using attention_sm90::pack_bf16;
using attention_sm90::Regs;
using attention_sm90::smem_u32;
using attention_sm90::tma_load;
using attention_sm90::wgmma_commit;
using attention_sm90::wgmma_fence;
using attention_sm90::wgmma_rs;
using attention_sm90::wgmma_ss;
using attention_sm90::wgmma_wait;

// d (+)= A B for a 64 x 32 x 16 step (32-row streamed tiles), A and B
// from shared memory, both K-major; scale_d = 0 overwrites d.  (The
// forward template has the 64 x 128 x 16 and 64 x 64 x 16 forms.)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D head columns; WG consumer warpgroups of 64 rows each hold the CTA's
// kBlockM rows (keys for dK/dV, q rows for dQ); STAGES stages of the
// streamed tiles, BLOCK_N rows each (q rows for dK/dV, keys for dQ).
template <int D, int WG, int STAGES, int BLOCK_N>
struct Config {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(BLOCK_N == 32 || BLOCK_N == 64 || BLOCK_N == 128,
                "wgmma widths 32, 64 or 128");
  static constexpr int kD = D;
  static constexpr int kBoxes = D / 64;  // 64-column (128-byte) boxes
  static constexpr int kConsumerWarps = 4 * WG;
  static constexpr int kBlockM = 64 * WG;
  static constexpr int kBlockN = BLOCK_N;
  static constexpr int kThreads = (kConsumerWarps + 4) * 32;
  static constexpr int kStages = STAGES;
  static constexpr int kAcc = D / 2;         // output floats a thread
  static constexpr int kScores = BLOCK_N / 2;  // score floats a thread
  static constexpr int kPacked = BLOCK_N / 4;  // their bf16 pairs
  static constexpr int kWords = BLOCK_N / 32;  // liveness words a tile
  static constexpr int kConsumerRegs = Regs<WG>::kConsumer;
  static constexpr int kProducerRegs = Regs<WG>::kProducer;
  static constexpr uint32_t kMBox = kBlockM * 128;  // bytes of one box
  static constexpr uint32_t kNBox = kBlockN * 128;
  static constexpr uint32_t kMBytes = kBoxes * kMBox;  // one held tile
  static constexpr uint32_t kNBytes = kBoxes * kNBox;  // one streamed tile
  static constexpr uint32_t kStageBytes = 2 * kNBytes;
  static constexpr uint32_t kRowsOff = 2 * kMBytes + kStages * kStageBytes;
  static constexpr uint32_t kBitsOff = kRowsOff + kStages * kBlockN * 8;
  static constexpr uint32_t kBarOff = kBitsOff + kStages * 16;
  static constexpr uint32_t kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
};

using DkdvD64 = Config<64, 2, 3, 64>;  // K4 nc dK/dV
using DqD64 = Config<64, 3, 4, 64>;    // K4 nc dQ
// K4a and K4b: 128 keys (dK/dV) or q rows (dQ) held in 2 warpgroups, with
// 64 fp32 outputs a thread for each of dK and dV, or for dQ.  dK/dV
// streams 32-row q tiles (16 score floats a thread for each of s^T and
// dP^T), the only width at which the next-tile overlap fits its registers.
using DkdvD128 = Config<128, 2, 4, 32>;  // K4a dK/dV
using DqD128 = Config<128, 2, 3, 64>;    // K4b dQ

// d = A B^T over the head dim for this warpgroup's 64 held rows (A at
// `a`, boxes C::kMBox apart) and a streamed tile (B at `b`, boxes
// C::kNBox apart), both K-major: the scores s^T, dP^T (dK/dV) or s, dP
// (dQ).
template <class C>
__device__ __forceinline__ void issue_scores(float (&d)[C::kScores],
                                             uint32_t a, uint32_t b) {
  const uint64_t da = make_desc(a, 16, 1024);
  const uint64_t db = make_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < C::kD / 16; ++kk) {
    // 16-column steps: 32 bytes inside a 128-byte row, then the next box.
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(d, da + (((kk / 4) * C::kMBox + col) >> 4),
             db + (((kk / 4) * C::kNBox + col) >> 4), kk > 0);
  }
}

// d += A B with A the bf16 pairs `pa` (the packed score accumulator: rows
// the held rows, the depth the streamed tile's rows) and B the streamed
// tile at `b` read MN-major: 8-row groups 1024 bytes apart, the next 64
// head columns one box further.
template <class C>
__device__ __forceinline__ void issue_acc(float (&d)[C::kAcc],
                                          const uint32_t (&pa)[C::kPacked],
                                          uint32_t b) {
  const uint64_t db = make_desc(b, C::kNBox, 1024);
#pragma unroll
  for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
    wgmma_rs(d, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             db + ((kk * 16 * 128) >> 4));
  }
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// Accumulator layout of wgmma m64nN (per warpgroup): warp w holds rows
// 16 w .. 16 w + 15; lane (g = lane / 4, c = lane % 4) holds, for each
// 8-column block j, d[4 j + e] at row g, column 8 j + 2 c + e and
// d[4 j + 2 + e] at row g + 8 (e = 0, 1).  Fragment i of the next
// product's register A operand is the pair (d[2 i], d[2 i + 1]).

// dK/dV's tile, in place: sc = s^T becomes p^T and dp = dP^T becomes dS^T.
// Columns are q rows: column n's lse (times log2 e) and delta are the
// stage's floats n at `rows` and `rows` + 4 kBlockN bytes.  MASKED (a
// tile that straddles the diagonal for this warp's keys): column 8 j +
// 2 c + e is visible to row r iff 8 j + e >= lim[r].
template <class C, bool MASKED>
__device__ __forceinline__ void dkdv_tile(float (&sc)[C::kScores],
                                          float (&dp)[C::kScores],
                                          uint32_t rows, int c,
                                          const int (&lim)[2], float sl2,
                                          float scale) {
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j) {
    const float2 l2 = ld_shared_f2(rows + (8 * j + 2 * c) * 4);
    const float2 dl = ld_shared_f2(rows + (C::kBlockN + 8 * j + 2 * c) * 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float p = fast_exp2(fmaf(sc[i], sl2, -(e ? l2.y : l2.x)));
        if (MASKED) p = 8 * j + e >= lim[r] ? p : 0.f;
        sc[i] = p;
        dp[i] = p * (dp[i] - (e ? dl.y : dl.x)) * scale;
      }
    }
  }
}

// dQ's tile, in place: dp = dP becomes dS (sc = s is spent).  Rows are q
// rows: this thread's two rows' lse (times log2 e) and delta.  MASKED:
// key 8 j + 2 c + e of the tile (this lane's bit 2 j + e of `live`) is
// visible to row r when its bit is set and, when CAUSAL, 8 j + e <=
// lim[r]; an invisible key gives dS = 0 (a select: p may be inf there).
template <class C, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dq_tile(const float (&sc)[C::kScores],
                                        float (&dp)[C::kScores],
                                        const float (&l2)[2],
                                        const float (&dl)[2], uint32_t live,
                                        const int (&lim)[2], float sl2,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        const float p = fast_exp2(fmaf(sc[i], sl2, -l2[r]));
        const float ds = p * (dp[i] - dl[r]) * scale;
        if (MASKED) {
          bool visible = (live >> (2 * j + e)) & 1u;
          if (CAUSAL) visible = visible && 8 * j + e <= lim[r];
          dp[i] = visible ? ds : 0.f;
        } else {
          dp[i] = ds;
        }
      }
    }
  }
}

// Store this thread's two rows (row0, row0 + 8) of a 64 x D accumulator as
// bf16 into dense (B, rows, heads, D) `out` at head h, rows at or past
// `rows` skipped, zeros where ok[r] is false (a masked key).
template <class C>
__device__ __forceinline__ void store_rows(const float (&acc)[C::kAcc],
                                           bf16* out, int b, int h, int rows,
                                           int heads, int row0, int c,
                                           const bool (&ok)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = row0 + 8 * r;
    if (R >= rows) continue;
    bf16* orow =
        out + (((long long)b * rows + R) * heads + h) * C::kD + 2 * c;
#pragma unroll
    for (int j = 0; j < C::kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          ok[r] ? __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                        acc[4 * j + 2 * r + 1])
                : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// Shared memory, from the first 1024-aligned byte (the swizzle atoms'
// alignment): the two held tiles (k and v, or q and dO), the stages of the
// two streamed tiles (q and dO, or k and v), the stages' lse and delta
// rows (dK/dV), the stages' liveness words (dQ), then the barriers
// full[s], empty[s] and the held tiles'.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

template <class C>
__device__ __forceinline__ uint32_t stage_tile(uint32_t base, int t,
                                               int which) {
  return base + 2 * C::kMBytes + (t % C::kStages) * C::kStageBytes +
         which * C::kNBytes;
}

// Whether key `j` of batch b is live: inside K and not masked.
__device__ __forceinline__ bool key_live(const int* mask, int b, int K,
                                         int j) {
  return j < K && (mask == nullptr || mask[(long long)b * K + j] != 0);
}

// dK/dV.  Grid (B Hkv, ceil(K / kBlockM)).  q, dO: (B, Q, Hq, D); k, v:
// (B, K, Hkv, D); lse, delta: (B, Hq, Q); mask (B, K) int32 or null;
// q_offset (B,) int32 or null, read when CAUSAL.  dk, dv: dense (B, K,
// Hkv, D).
template <class C, bool CAUSAL>
__global__ void __launch_bounds__(C::kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ mask, const int* __restrict__ q_offset,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Q, int K,
            int Hq, int Hkv, float scale) {
  constexpr int kStages = C::kStages;
  constexpr int kBlockN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar = base + C::kBarOff;
  const uint32_t sk = base, sv = base + C::kMBytes;
  const uint32_t kv_bar = bar + 16 * kStages;
  auto full_bar = [&](int t) { return bar + 8 * (t % kStages); };
  auto empty_bar = [&](int t) {
    return bar + 8 * (kStages + t % kStages);
  };
  auto rows_of = [&](int t) {  // the stage's lse and delta rows
    return base + C::kRowsOff + (t % kStages) * kBlockN * 8;
  };

  const int hk = blockIdx.x % Hkv;
  const int b = blockIdx.x / Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.y * C::kBlockM;
  const int off = (CAUSAL && q_offset != nullptr) ? q_offset[b] : 0;
  const int n_q = (Q + kBlockN - 1) / kBlockN;
  // The first q tile holding a row that can see a key of the block: rows
  // i >= k0 - off (JAX :622); none when that is past Q.
  int first = 0;
  if (CAUSAL && k0 - off > 0) first = min(n_q, (k0 - off) / kBlockN);
  const int n_per = n_q - first;  // q tiles walked per q head
  const int n_it = G * n_per;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's lane 0 arrives with the byte count, then every lane
      // of the producer warp after storing its lse and delta.
      mbar_init(full_bar(s), 33);
      mbar_init(empty_bar(s), C::kConsumerWarps);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // A CTA whose keys are all masked (or past K), or that no row sees,
  // walks nothing and writes zeros.
  const bool walk =
      __syncthreads_or(threadIdx.x < C::kBlockM &&
                       key_live(mask, b, K, k0 + threadIdx.x)) &&
      n_it > 0;

  if (warp >= C::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (warp != C::kConsumerWarps || !walk) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::kMBytes);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box) {
        tma_load(&tk, sk + box * C::kMBox, kv_bar, 64 * box, k0, hk, b);
        tma_load(&tv, sv + box * C::kMBox, kv_bar, 64 * box, k0, hk, b);
      }
    }
    constexpr int kPer = kBlockN / 32;  // lse and delta floats a lane
    float* rows = reinterpret_cast<float*>(smem_raw +
                                           (base - smem_u32(smem_raw)) +
                                           C::kRowsOff);
    int h = hk * G, t = first;
    for (int it = 0; it < n_it; ++it) {
      const int n0 = t * kBlockN;
      const long long row = ((long long)b * Hq + h) * Q;
      // The tile's lse (times log2 e) and delta, read before the stage is
      // free: kDeadLse and 0 past Q, nothing read there.
      float l2[kPer], dl[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int n = n0 + 32 * u + lane;
        l2[u] = n < Q ? lse[row + n] * kLog2e : kDeadLse * kLog2e;
        dl[u] = n < Q ? delta[row + n] : 0.f;
      }
      if (it >= kStages) mbar_wait(empty_bar(it), (it / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full_bar(it), C::kStageBytes);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
          tma_load(&tq, stage_tile<C>(base, it, 0) + box * C::kNBox,
                   full_bar(it), 64 * box, n0, h, b);
          tma_load(&tdo, stage_tile<C>(base, it, 1) + box * C::kNBox,
                   full_bar(it), 64 * box, n0, h, b);
        }
      }
      float* stage_rows = rows + (it % kStages) * 2 * kBlockN;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        stage_rows[32 * u + lane] = l2[u];
        stage_rows[kBlockN + 32 * u + lane] = dl[u];
      }
      mbar_arrive(full_bar(it));
      if (++t == n_q) {
        t = first;
        ++h;
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int c = lane % 4;
  const int warp_key = k0 + 64 * wg + 16 * (warp % 4);  // its first key
  const int row0 = warp_key + lane / 4;                 // and row0 + 8
  const float sl2 = scale * kLog2e;
  const uint32_t ak = sk + wg * 64 * 128, av = sv + wg * 64 * 128;

  float dkacc[C::kAcc], dvacc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dkacc[i] = dvacc[i] = 0.f;

  if (walk) {
    float sc[C::kScores], dp[C::kScores];
    uint32_t pp[C::kPacked], pd[C::kPacked];

    auto scores = [&](int it) {
      issue_scores<C>(sc, ak, stage_tile<C>(base, it, 0));
      issue_scores<C>(dp, av, stage_tile<C>(base, it, 1));
      wgmma_commit();
    };
    auto accumulate = [&](int it) {
      issue_acc<C>(dvacc, pp, stage_tile<C>(base, it, 1));
      issue_acc<C>(dkacc, pd, stage_tile<C>(base, it, 0));
      wgmma_commit();
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < C::kPacked; ++i) {
        pp[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        pd[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(it));
    };
    // The tiles' q rows, in walking order: the elementwise pass of tile it
    // reads n0 and advances it.
    int t = first;
    auto elementwise = [&](int it) {
      const int n0 = t * kBlockN;
      if (++t == n_q) t = first;
      // The per-score test only where some key of this warp lies past the
      // tile's first row (off + n0).
      if (CAUSAL && warp_key + 15 > off + n0) {
        const int lim[2] = {row0 - off - n0 - 2 * c,
                            row0 + 8 - off - n0 - 2 * c};
        dkdv_tile<C, true>(sc, dp, rows_of(it), c, lim, sl2, scale);
      } else {
        const int lim[2] = {0, 0};
        dkdv_tile<C, false>(sc, dp, rows_of(it), c, lim, sl2, scale);
      }
    };

    mbar_wait(kv_bar, 0);
    mbar_wait(full_bar(0), 0);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(0);
    pack();
    for (int it = 1; it < n_it; ++it) {
      mbar_wait(full_bar(it), (it / kStages) & 1);
      wgmma_fence();
      scores(it);
      accumulate(it - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      elementwise(it);
      wgmma_wait<0>();
      fence_regs(dkacc);
      fence_regs(dvacc);
      fence_regs(pp);
      fence_regs(pd);
      release(it - 1);
      pack();
    }
    wgmma_fence();
    accumulate(n_it - 1);
    wgmma_wait<0>();
    fence_regs(dkacc);
    fence_regs(dvacc);
    fence_regs(pp);
    fence_regs(pd);
    release(n_it - 1);
  }

  const bool ok[2] = {key_live(mask, b, K, row0),
                      key_live(mask, b, K, row0 + 8)};
  store_rows<C>(dkacc, dk, b, hk, K, Hkv, row0, c, ok);
  store_rows<C>(dvacc, dv, b, hk, K, Hkv, row0, c, ok);
}

// dQ.  Grid (B Hq, ceil(Q / kBlockM)).  Operands as dkdv_kernel's; dq:
// dense (B, Q, Hq, D).
template <class C, bool CAUSAL>
__global__ void __launch_bounds__(C::kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ mask, const int* __restrict__ q_offset,
          bf16* __restrict__ dq, int Q, int K, int Hq, int Hkv,
          float scale) {
  constexpr int kStages = C::kStages;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kWords = C::kWords;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar = base + C::kBarOff;
  const uint32_t sq = base, sdo = base + C::kMBytes;
  const uint32_t q_bar = bar + 16 * kStages;
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      smem_raw + (base - smem_u32(smem_raw)) + C::kBitsOff);
  auto full_bar = [&](int t) { return bar + 8 * (t % kStages); };
  auto empty_bar = [&](int t) {
    return bar + 8 * (kStages + t % kStages);
  };

  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  // Causal: the heaviest q block first (the grid's slow axis backwards).
  const int q0 =
      (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * C::kBlockM;
  const int off = (CAUSAL && q_offset != nullptr) ? q_offset[b] : 0;
  int n_t = (K + kBlockN - 1) / kBlockN;
  if (CAUSAL) {
    // Up to the last key the CTA's last row sees (JAX :673), or none.
    const int last = off + min(q0 + C::kBlockM, Q) - 1;
    n_t = last < 0 ? 0 : min(n_t, last / kBlockN + 1);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), C::kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (warp != C::kConsumerWarps || n_t == 0) return;
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * C::kMBytes);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box) {
        tma_load(&tq, sq + box * C::kMBox, q_bar, 64 * box, q0, h, b);
        tma_load(&tdo, sdo + box * C::kMBox, q_bar, 64 * box, q0, h, b);
      }
    }
    for (int t = 0; t < n_t; ++t) {
      const int k0 = t * kBlockN;
      // The tile's key liveness (mask and j < K), one ballot a word,
      // stored by lane 0 before its arrival releases the stage.
      uint32_t words[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        words[w] = __ballot_sync(0xffffffffu,
                                 key_live(mask, b, K, k0 + 32 * w + lane));
      }
      if (t >= kStages) mbar_wait(empty_bar(t), (t / kStages - 1) & 1);
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          bits[4 * (t % kStages) + w] = words[w];
        }
        mbar_expect_tx(full_bar(t), C::kStageBytes);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
          tma_load(&tk, stage_tile<C>(base, t, 0) + box * C::kNBox,
                   full_bar(t), 64 * box, k0, hk, b);
          tma_load(&tv, stage_tile<C>(base, t, 1) + box * C::kNBox,
                   full_bar(t), 64 * box, k0, hk, b);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int c = lane % 4;
  const int warp_row = q0 + 64 * wg + 16 * (warp % 4);  // its first row
  const int row0 = warp_row + lane / 4;                 // and row0 + 8
  const float sl2 = scale * kLog2e;
  float dqacc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dqacc[i] = 0.f;

  if (n_t > 0) {
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = row0 + 8 * r;
      const long long at = ((long long)b * Hq + h) * Q + R;
      l2[r] = R < Q ? lse[at] * kLog2e : kDeadLse * kLog2e;
      dl[r] = R < Q ? delta[at] : 0.f;
    }
    const uint32_t aq = sq + wg * 64 * 128, ado = sdo + wg * 64 * 128;
    float sc[C::kScores], dp[C::kScores];
    uint32_t pd[C::kPacked];

    auto scores = [&](int t) {
      issue_scores<C>(sc, aq, stage_tile<C>(base, t, 0));
      issue_scores<C>(dp, ado, stage_tile<C>(base, t, 1));
      wgmma_commit();
    };
    auto accumulate = [&](int t) {
      issue_acc<C>(dqacc, pd, stage_tile<C>(base, t, 0));
      wgmma_commit();
    };
    auto elementwise = [&](int t) {
      const int k0 = t * kBlockN;
      const uint32_t* wb = bits + 4 * (t % kStages);
      uint32_t w[kWords], all = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        w[i] = wb[i];
        all &= w[i];
      }
      // The per-score test only where some key is masked or past K, or
      // the tile reaches past this warp's first row.
      if (all != 0xffffffffu ||
          (CAUSAL && k0 + kBlockN - 1 > off + warp_row)) {
        // This lane's keys: 8 j + 2 c + e for j < kBlockN / 8, e < 2.
        uint32_t live = 0;
#pragma unroll
        for (int j = 0; j < kBlockN / 8; ++j) {
          live |= ((w[j / 4] >> (8 * (j % 4) + 2 * c)) & 3u) << (2 * j);
        }
        const int lim[2] = {off + row0 - k0 - 2 * c,
                            off + row0 + 8 - k0 - 2 * c};
        dq_tile<C, CAUSAL, true>(sc, dp, l2, dl, live, lim, sl2, scale);
      } else {
        const int lim[2] = {0, 0};
        dq_tile<C, CAUSAL, false>(sc, dp, l2, dl, 0u, lim, sl2, scale);
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < C::kPacked; ++i) {
        pd[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }
    };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(t));
    };

    mbar_wait(q_bar, 0);
    mbar_wait(full_bar(0), 0);
    wgmma_fence();
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    elementwise(0);
    pack();
    for (int t = 1; t < n_t; ++t) {
      mbar_wait(full_bar(t), (t / kStages) & 1);
      wgmma_fence();
      scores(t);
      accumulate(t - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      elementwise(t);
      wgmma_wait<0>();
      fence_regs(dqacc);
      fence_regs(pd);
      release(t - 1);
      pack();
    }
    wgmma_fence();
    accumulate(n_t - 1);
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(pd);
    release(n_t - 1);
  }

  const bool ok[2] = {true, true};
  store_rows<C>(dqacc, dq, b, h, Q, Hq, row0, c, ok);
}

// The tensor maps of q and dO ((B, Q, Hq, D) views: batch strides qsb,
// dsb and row strides qss, dss elements) and of k and v ((B, K, Hkv, D):
// ksb, kss, vsb, vss), with boxes of kBlockM rows for the CTA's held tiles
// and kBlockN rows for the ring's.  False if cuTensorMapEncodeTiled
// refuses one (a base or stride that is not a multiple of 16 bytes).
template <class C>
inline bool encode_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                        CUtensorMap* tdo, const void* q, const void* k,
                        const void* v, const void* dout, int B, int Q, int K,
                        int Hq, int Hkv, long long qsb, long long qss,
                        long long ksb, long long kss, long long vsb,
                        long long vss, long long dsb, long long dss,
                        bool q_held) {
  const int qb = q_held ? C::kBlockM : C::kBlockN;
  const int kb = q_held ? C::kBlockN : C::kBlockM;
  return encode_map(tq, q, Q, Hq, B, qss, qsb, C::kD, qb) &&
         encode_map(tdo, dout, Q, Hq, B, dss, dsb, C::kD, qb) &&
         encode_map(tk, k, K, Hkv, B, kss, ksb, C::kD, kb) &&
         encode_map(tv, v, K, Hkv, B, vss, vsb, C::kD, kb);
}

// dk, dv: dense (B, K, Hkv, D) bf16 outputs; lse, delta: (B, Hq, Q) fp32;
// mask: (B, K) int32 or null; q_offset: (B,) int32 or null, read when
// CAUSAL.  Returns a cudaError_t.
template <class C, bool CAUSAL>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, const void* mask,
                const void* q_offset, void* dk, void* dv, int B, int Q, int K,
                int Hq, int Hkv, long long qsb, long long qss, long long ksb,
                long long kss, long long vsb, long long vss, long long dsb,
                long long dss, float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      !encode_maps<C>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, Q, K, Hq, Hkv,
                      qsb, qss, ksb, kss, vsb, vss, dsb, dss, false)) {
    return int(cudaErrorInvalidValue);
  }
  auto kernel = dkdv_kernel<C, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(Hkv * B, (K + C::kBlockM - 1) / C::kBlockM);
  kernel<<<grid, C::kThreads, C::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(mask),
      static_cast<const int*>(q_offset), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Q, K, Hq, Hkv, scale);
  return int(cudaGetLastError());
}

// dq: a dense (B, Q, Hq, D) bf16 output; the rest as launch_dkdv.
template <class C, bool CAUSAL>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* mask,
              const void* q_offset, void* dq, int B, int Q, int K, int Hq,
              int Hkv, long long qsb, long long qss, long long ksb,
              long long kss, long long vsb, long long vss, long long dsb,
              long long dss, float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (Hkv <= 0 || Hq % Hkv != 0 ||
      !encode_maps<C>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, Q, K, Hq, Hkv,
                      qsb, qss, ksb, kss, vsb, vss, dsb, dss, true)) {
    return int(cudaErrorInvalidValue);
  }
  auto kernel = dq_kernel<C, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(Hq * B, (Q + C::kBlockM - 1) / C::kBlockM);
  kernel<<<grid, C::kThreads, C::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(mask),
      static_cast<const int*>(q_offset), static_cast<bf16*>(dq), Q, K, Hq,
      Hkv, scale);
  return int(cudaGetLastError());
}

}  // namespace attention_bwd_sm90
}  // namespace mjv
