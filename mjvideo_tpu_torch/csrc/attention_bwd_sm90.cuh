// The attention backward for Hopper (sm_90a): wgmma, TMA and a producer
// warp, on the helpers of the forward template (decoder_attention_sm90.cuh).
// Two kernels replace the two Pallas kernels of _bwd_impl
// (mjvideo_tpu/ops/flash_attention.py:708) as the ViT's custom VJP reaches
// them (_vjp_bwd :874): causal=False, no mask, one kv head per q head
// (K4 nc, vit_attention_bwd.cu):
//   dkdv_kernel <- _bwd_dkdv_kernel (:603, call :769): dK and dV
//   dq_kernel   <- _bwd_dq_kernel   (:656, call :812): dQ
// Both recompute p = exp(scale q k^T - lse) from the true lse that the
// forward wrote (K1 lse), with delta = rowsum(dO * O) reduced before the
// launch (attention_delta, :254).  Rounding as in the TPU kernels: p is
// rounded to bf16 before dV += p^T dO; dS = p (dO v^T - delta) scale is
// rounded to bf16 before dK += dS^T q and dQ += dS k; sums in fp32; dq, dk
// and dv written dense (B, S, H, D) in bf16.
//
// What bounds it on this card: at the ViT's (8, 1025, 16, 64) dK/dV does
// four products of 2 * 64 operations per (query, key) pair and head (s,
// dO v^T, p^T dO, dS^T q: 69 GFLOP, 0.070 ms at 989 TFLOP/s) and dQ three
// (s, dO v^T, dS k: 52 GFLOP, 0.052 ms), on 25-34 MB of operands: both are
// compute-bound, and only wgmma reaches the tensor cores' rate.  Beside the
// products each score costs one exp2 on the special-function unit and a
// few fp32 operations (the exp's argument, dS, two bf16 packs); at D = 64
// those weigh about as much as the products, so the design keeps them off
// the path of the tensor cores.  The WMMA template these replace
// (attention_bwd.cuh) reached 5-6% of the bound: scores went out to an
// fp32 shared scratch and back as bf16 fragments, and the loads were
// synchronous.
//
// Design.
// - dK/dV: one CTA per (b, h, 64 keys per consumer warpgroup).  A producer
//   warp loads the CTA's k and v rows once by TMA, then streams the (q,
//   dO) tiles of kBlockN rows through a ring of stages (128-byte swizzle,
//   one 64-column box per 64 head columns, TMA's zero fill past S), with
//   each tile's lse (times log2 e) and delta beside it: the (B, H, S) fp32
//   rows are 4,100 bytes apart at S = 1025, which TMA cannot take (16-byte
//   strides), so the producer's lanes load them with guarded plain loads,
//   kDeadLse and 0 past S.  Each consumer warpgroup computes s^T = k_w q^T
//   and dP^T = v_w dO^T with wgmma.m64nNk16 (both operands K-major from
//   shared memory), forms p^T and dS^T on the accumulator registers (the
//   lse and delta broadcast along the columns from the stage), rounds them
//   to bf16 in registers and feeds them as the register A operand of dV +=
//   p^T dO and dK += dS^T q, with dO and q read MN-major through the
//   transposed descriptor, as the forward's p v reads v.
// - dQ: one CTA per (b, h, 64 q rows per consumer warpgroup); q, dO, and
//   each thread's two rows of lse and delta are loaded once; the (k, v)
//   tiles stream through the ring.  s = q_w k^T and dP = dO_w v^T, dS to
//   bf16 registers, dQ += dS k with k read MN-major.  No online max and no
//   rescale: the lse is known.
// - s, p, dP and dS never touch shared memory.  Tile t + 1's two score
//   products are issued before tile t's accumulating products, so the
//   elementwise work of t + 1 runs while the tensor cores work.
// - p = exp2(s * scale log2 e - lse log2 e) is one FMA and one ex2, not
//   the forward's split log2 e (decoder_attention_sm90.cuh, softmax_body):
//   there p is summed into the normaliser that every output is divided
//   by, here each p enters only its own products, so an argument a few
//   fp32 ulps from the twin's moves bf16(p) by an ulp in a few elements
//   and nothing accumulates.
// - The ragged tail needs no mask on the dK/dV side: padded q and dO rows
//   are TMA's zeros with lse = kDeadLse, so p = exp2(-huge) = 0 exactly and
//   they add p * 0 to dV and dS * 0 = 0 to dK; padded key rows are not
//   stored.  On the dQ side padded keys (k = v = 0) would enter with p =
//   exp(-lse), finite for any lse K1 writes, but dS * 0 = NaN if p
//   overflowed on a row with a very negative lse; the last key tile (the
//   only one reaching past S, chosen once per tile for the CTA) zeroes
//   them.  Padded q rows are not stored.
// - Two kernels and no atomics: each output row is summed by one thread
//   in a fixed order, so results are bit-identical from launch to launch.
// - The head dim, the consumer warpgroups, the stages and the streamed
//   tile's rows are a Config (below), one per kernel, chosen by A/B on the
//   card (tools/bwd_config_ab_torch.py, PERF.md): dK/dV holds 128 keys in
//   2 warpgroups (232 registers a consumer thread) and streams 64-row q
//   tiles through 3 stages; with 3 warpgroups (160 registers) or 128-row
//   tiles its scores, outputs and packed operands spill.  dQ holds 192 q
//   rows in 3 warpgroups (160 registers) and streams 64-key tiles through
//   4 stages, which measured faster than 2 warpgroups with 128-key tiles
//   and than 2 or 3 stages.  At S = 1025 that is 9 key tiles a (b, h) for
//   dK/dV, the last with one real key, and 6 q tiles for dQ, the last
//   with 65 rows.  Only the non-causal, maskless D = 64 forms are built.
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

// d (+)= A B for a 64 x 64 x 16 step, A and B from shared memory, both
// K-major; scale_d = 0 overwrites d.  (The forward template has the 64 x
// 128 x 16 form.)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D head columns; WG consumer warpgroups of 64 rows each hold the CTA's
// kBlockM rows (keys for dK/dV, q rows for dQ); STAGES stages of the
// streamed tiles, BLOCK_N rows each (q rows for dK/dV, keys for dQ).
template <int D, int WG, int STAGES, int BLOCK_N>
struct Config {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(BLOCK_N == 64 || BLOCK_N == 128, "wgmma widths 64 or 128");
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
  static constexpr int kConsumerRegs = Regs<WG>::kConsumer;
  static constexpr int kProducerRegs = Regs<WG>::kProducer;
  static constexpr uint32_t kMBox = kBlockM * 128;  // bytes of one box
  static constexpr uint32_t kNBox = kBlockN * 128;
  static constexpr uint32_t kMBytes = kBoxes * kMBox;  // one held tile
  static constexpr uint32_t kNBytes = kBoxes * kNBox;  // one streamed tile
  static constexpr uint32_t kStageBytes = 2 * kNBytes;
  static constexpr uint32_t kRowsOff = 2 * kMBytes + kStages * kStageBytes;
  static constexpr uint32_t kBarOff = kRowsOff + kStages * kBlockN * 8;
  static constexpr uint32_t kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
};

using DkdvD64 = Config<64, 2, 3, 64>;  // K4 nc dK/dV
using DqD64 = Config<64, 3, 4, 64>;    // K4 nc dQ

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
// stage's floats n at `rows` and `rows` + 4 kBlockN bytes.
template <class C>
__device__ __forceinline__ void dkdv_tile(float (&sc)[C::kScores],
                                          float (&dp)[C::kScores],
                                          uint32_t rows, int c, float sl2,
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
        const float p = fast_exp2(fmaf(sc[i], sl2, -(e ? l2.y : l2.x)));
        sc[i] = p;
        dp[i] = p * (dp[i] - (e ? dl.y : dl.x)) * scale;
      }
    }
  }
}

// dQ's tile, in place: dp = dP becomes dS (sc = s is spent).  Rows are q
// rows: this thread's two rows' lse (times log2 e) and delta.  MASKED (the
// key tile reaching past S): columns 8 j + 2 c + e >= lim give dS = 0.
template <class C, bool MASKED>
__device__ __forceinline__ void dq_tile(const float (&sc)[C::kScores],
                                        float (&dp)[C::kScores],
                                        const float (&l2)[2],
                                        const float (&dl)[2], int lim,
                                        float sl2, float scale) {
#pragma unroll
  for (int j = 0; j < C::kBlockN / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        const float p = fast_exp2(fmaf(sc[i], sl2, -l2[r]));
        const float ds = p * (dp[i] - dl[r]) * scale;
        dp[i] = MASKED ? (8 * j + e < lim ? ds : 0.f) : ds;
      }
    }
  }
}

// Store this thread's two rows (row0, row0 + 8) of a 64 x D accumulator as
// bf16 into dense (B, S, H, D) `out`, rows at or past S skipped.
template <class C>
__device__ __forceinline__ void store_rows(const float (&acc)[C::kAcc],
                                           bf16* out, int b, int h, int S,
                                           int H, int row0, int c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = row0 + 8 * r;
    if (R >= S) continue;
    bf16* orow = out + (((long long)b * S + R) * H + h) * C::kD + 2 * c;
#pragma unroll
    for (int j = 0; j < C::kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Shared memory, from the first 1024-aligned byte (the swizzle atoms'
// alignment): the two held tiles (k and v, or q and dO), the stages of the
// two streamed tiles (q and dO, or k and v), the stages' lse and delta rows
// (dK/dV only), then the barriers full[s], empty[s] and the held tiles'.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

template <class C>
__device__ __forceinline__ uint32_t stage_tile(uint32_t base, int t,
                                               int which) {
  return base + 2 * C::kMBytes + (t % C::kStages) * C::kStageBytes +
         which * C::kNBytes;
}

// dK/dV.  Grid (B H, ceil(S / kBlockM)).
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
            float scale) {
  constexpr int kStages = C::kStages;
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
    return base + C::kRowsOff + (t % kStages) * C::kBlockN * 8;
  };

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int k0 = blockIdx.y * C::kBlockM;
  const int n_t = (S + C::kBlockN - 1) / C::kBlockN;
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
  __syncthreads();

  if (warp >= C::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (warp != C::kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::kMBytes);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box) {
        tma_load(&tk, sk + box * C::kMBox, kv_bar, 64 * box, k0, h, b);
        tma_load(&tv, sv + box * C::kMBox, kv_bar, 64 * box, k0, h, b);
      }
    }
    const long long row = ((long long)b * H + h) * S;
    constexpr int kPer = C::kBlockN / 32;  // lse and delta floats a lane
    float* rows = reinterpret_cast<float*>(smem_raw +
                                           (base - smem_u32(smem_raw)) +
                                           C::kRowsOff);
    for (int t = 0; t < n_t; ++t) {
      const int n0 = t * C::kBlockN;
      // The tile's lse (times log2 e) and delta, read before the stage is
      // free: kDeadLse and 0 past S, nothing read there.
      float l2[kPer], dl[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int n = n0 + 32 * u + lane;
        l2[u] = n < S ? lse[row + n] * kLog2e : kDeadLse * kLog2e;
        dl[u] = n < S ? delta[row + n] : 0.f;
      }
      if (t >= kStages) mbar_wait(empty_bar(t), (t / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full_bar(t), C::kStageBytes);
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
          tma_load(&tq, stage_tile<C>(base, t, 0) + box * C::kNBox,
                   full_bar(t), 64 * box, n0, h, b);
          tma_load(&tdo, stage_tile<C>(base, t, 1) + box * C::kNBox,
                   full_bar(t), 64 * box, n0, h, b);
        }
      }
      float* stage_rows = rows + (t % kStages) * 2 * C::kBlockN;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        stage_rows[32 * u + lane] = l2[u];
        stage_rows[C::kBlockN + 32 * u + lane] = dl[u];
      }
      mbar_arrive(full_bar(t));
    }
    return;
  }

  // The consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int c = lane % 4;
  const int row0 = k0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const float sl2 = scale * kLog2e;
  const uint32_t ak = sk + wg * 64 * 128, av = sv + wg * 64 * 128;

  float dkacc[C::kAcc], dvacc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dkacc[i] = dvacc[i] = 0.f;
  float sc[C::kScores], dp[C::kScores];
  uint32_t pp[C::kPacked], pd[C::kPacked];

  auto scores = [&](int t) {
    issue_scores<C>(sc, ak, stage_tile<C>(base, t, 0));
    issue_scores<C>(dp, av, stage_tile<C>(base, t, 1));
    wgmma_commit();
  };
  auto accumulate = [&](int t) {
    issue_acc<C>(dvacc, pp, stage_tile<C>(base, t, 1));
    issue_acc<C>(dkacc, pd, stage_tile<C>(base, t, 0));
    wgmma_commit();
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < C::kPacked; ++i) {
      pp[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      pd[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(t));
  };

  mbar_wait(kv_bar, 0);
  mbar_wait(full_bar(0), 0);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  dkdv_tile<C>(sc, dp, rows_of(0), c, sl2, scale);
  pack();
  for (int t = 1; t < n_t; ++t) {
    mbar_wait(full_bar(t), (t / kStages) & 1);
    wgmma_fence();
    scores(t);
    accumulate(t - 1);
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dp);
    dkdv_tile<C>(sc, dp, rows_of(t), c, sl2, scale);
    wgmma_wait<0>();
    fence_regs(dkacc);
    fence_regs(dvacc);
    fence_regs(pp);
    fence_regs(pd);
    release(t - 1);
    pack();
  }
  wgmma_fence();
  accumulate(n_t - 1);
  wgmma_wait<0>();
  fence_regs(dkacc);
  fence_regs(dvacc);
  fence_regs(pp);
  fence_regs(pd);
  release(n_t - 1);

  store_rows<C>(dkacc, dk, b, h, S, H, row0, c);
  store_rows<C>(dvacc, dv, b, h, S, H, row0, c);
}

// dQ.  Grid (B H, ceil(S / kBlockM)).
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int S, int H, float scale) {
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t bar = base + C::kBarOff;
  const uint32_t sq = base, sdo = base + C::kMBytes;
  const uint32_t q_bar = bar + 16 * kStages;
  auto full_bar = [&](int t) { return bar + 8 * (t % kStages); };
  auto empty_bar = [&](int t) {
    return bar + 8 * (kStages + t % kStages);
  };

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = blockIdx.y * C::kBlockM;
  const int n_t = (S + C::kBlockN - 1) / C::kBlockN;
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
    if (warp != C::kConsumerWarps || lane != 0) return;
    mbar_expect_tx(q_bar, 2 * C::kMBytes);
#pragma unroll
    for (int box = 0; box < C::kBoxes; ++box) {
      tma_load(&tq, sq + box * C::kMBox, q_bar, 64 * box, q0, h, b);
      tma_load(&tdo, sdo + box * C::kMBox, q_bar, 64 * box, q0, h, b);
    }
    for (int t = 0; t < n_t; ++t) {
      if (t >= kStages) mbar_wait(empty_bar(t), (t / kStages - 1) & 1);
      mbar_expect_tx(full_bar(t), C::kStageBytes);
#pragma unroll
      for (int box = 0; box < C::kBoxes; ++box) {
        tma_load(&tk, stage_tile<C>(base, t, 0) + box * C::kNBox,
                 full_bar(t), 64 * box, t * C::kBlockN, h, b);
        tma_load(&tv, stage_tile<C>(base, t, 1) + box * C::kNBox,
                 full_bar(t), 64 * box, t * C::kBlockN, h, b);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const float sl2 = scale * kLog2e;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * S + R;
    l2[r] = R < S ? lse[at] * kLog2e : kDeadLse * kLog2e;
    dl[r] = R < S ? delta[at] : 0.f;
  }
  const uint32_t aq = sq + wg * 64 * 128, ado = sdo + wg * 64 * 128;

  float dqacc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) dqacc[i] = 0.f;
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
    const int k0 = t * C::kBlockN;
    if (k0 + C::kBlockN > S) {
      dq_tile<C, true>(sc, dp, l2, dl, S - k0 - 2 * c, sl2, scale);
    } else {
      dq_tile<C, false>(sc, dp, l2, dl, 0, sl2, scale);
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

  store_rows<C>(dqacc, dq, b, h, S, H, row0, c);
}

// The tensor maps of q, k, v (strided views: row strides qss, kss, vss,
// batch strides qsb, ksb, vsb elements) and dO (dss, dsb), with boxes of
// `held` rows for the CTA's own tiles and `streamed` rows for the ring's.
template <class C>
inline bool encode_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                        CUtensorMap* tdo, const void* q, const void* k,
                        const void* v, const void* dout, int B, int S, int H,
                        long long qsb, long long qss, long long ksb,
                        long long kss, long long vsb, long long vss,
                        long long dsb, long long dss, bool q_held) {
  const int qb = q_held ? C::kBlockM : C::kBlockN;
  const int kb = q_held ? C::kBlockN : C::kBlockM;
  return encode_map(tq, q, S, H, B, qss, qsb, C::kD, qb) &&
         encode_map(tdo, dout, S, H, B, dss, dsb, C::kD, qb) &&
         encode_map(tk, k, S, H, B, kss, ksb, C::kD, kb) &&
         encode_map(tv, v, S, H, B, vss, vsb, C::kD, kb);
}

// dk, dv: dense (B, S, H, D) bf16 outputs; lse, delta: (B, H, S) fp32.
// Returns a cudaError_t.
template <class C>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                int B, int S, int H, long long qsb, long long qss,
                long long ksb, long long kss, long long vsb, long long vss,
                long long dsb, long long dss, float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_maps<C>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, S, H, qsb, qss,
                      ksb, kss, vsb, vss, dsb, dss, false)) {
    return int(cudaErrorInvalidValue);
  }
  auto kernel = dkdv_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(H * B, (S + C::kBlockM - 1) / C::kBlockM);
  kernel<<<grid, C::kThreads, C::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, scale);
  return int(cudaGetLastError());
}

// dq: a dense (B, S, H, D) bf16 output; the rest as launch_dkdv.
template <class C>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, long long qsb, long long qss, long long ksb,
              long long kss, long long vsb, long long vss, long long dsb,
              long long dss, float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_maps<C>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, S, H, qsb, qss,
                      ksb, kss, vsb, vss, dsb, dss, true)) {
    return int(cudaErrorInvalidValue);
  }
  auto kernel = dq_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(H * B, (S + C::kBlockM - 1) / C::kBlockM);
  kernel<<<grid, C::kThreads, C::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, H, scale);
  return int(cudaGetLastError());
}

}  // namespace attention_bwd_sm90
}  // namespace mjv
