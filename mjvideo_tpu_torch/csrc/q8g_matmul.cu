// K6 and K7: the grouped w8a8 matmul on Hopper (sm_90a): int8 wgmma, TMA
// and a producer warp.
//
// Replaces two Pallas TPU kernels of mjvideo_tpu/ops/quant.py:
//   K6  _q8g_matmul_pallas_fused (:316, call :376): x (M, K) bf16 is
//       quantized per (row, group): amax over the g columns of the group,
//       a_s = max(amax / 127, 1e-12), xq = clip(round(x / a_s), -127, 127);
//       out = sum over groups of (float(xq_g . wq_g) * a_s) * w_s[g],
//       written once at bf16 or fp32.
//   K7  _q8g_matmul_pallas (:423, call :472): the same product from a
//       pre-quantized xq (M, K) int8 and a_scale (M, G) fp32, fp32 out.
// Here K6 is the pre-pass quantize_rows_kernel (x -> xq, a_s, once per
// (row, group)) followed by K7's GEMM, q8g_gemm_kernel, so K7 is K6 without
// its pre-pass and the two agree to the bit by construction.  wq is the
// (K, N) int8 weight stored k-major, an (N, K) row-major array (the port
// quantizes every int8 weight into that layout once: wgmma reads 8-bit
// operands only K-major), and w_scale (G, N) fp32, with g = K / G a
// multiple of 32.  Any M and any N: TMA's zero fill covers the M and N
// tails, the stores are masked (the LM head's N = 92,553 is odd).
//
// Numerics: IEEE division and round-half-to-even conversion in the
// pre-pass; an exact int32 partial per group from the tensor cores; then
// float(partial) (exact while g <= 1024) and __fmul_rn, __fmul_rn,
// __fadd_rn, groups in order from 0: every rounding step the plain twin
// (ops/quant.py) takes, in its order, so kernel and twin agree to the bit.
//
// What bounds it on this card: at the 2B's shapes (decoder w1: 6,144 x
// 2,048 -> 8,192, g 128) the int8 products, 206 GOP, 0.104 ms at 1,979
// TOP/s; at decode (M = 2 on the LM head) the weight's 190 MB, about
// 57 us.  The first version (mma.sync m16n8k32 in 64 x 128 tiles) staged
// synchronously, transposed each (K, N) weight tile in shared memory and
// quantized x again in every CTA for every 128-column tile.
//
// Design.  One CTA per (128-column, BM-row) output tile, N fastest, with
// Config::kWG consumer warpgroups of 64 rows and one producer warpgroup
// that gives its registers away (setmaxnreg).
// - The producer's first warp loads, per stage, one 128-byte-swizzled box
//   of 128 K-bytes for the CTA's BM xq rows and its 128 weight rows by TMA
//   into a ring of stages with full/empty mbarriers; beside the stage its
//   32 lanes copy, by cp.async with zero fill, the scales of every group
//   the stage's K range touches (up to 4 at g = 32): w_s for the 128
//   columns and a_s for the BM rows.  The full barrier takes 33 arrivals:
//   lane 0's with the byte count, then each lane's cp.async completion.
// - Each consumer warpgroup runs g / 32 wgmma.m64n128k32.s32.s8.s8 per
//   group from shared memory (both operands K-major, 32 bytes a step
//   inside the 128-byte rows) into an int32 accumulator, then promotes it
//   into its fp32 sum in the twin's order (a conversion and three fp32
//   operations per element; cvt runs beside the fp32 pipe, and measured
//   6% faster than a magic-number add and subtract).  m64n128 holds 64
//   int32 and 64 fp32 a thread.  At g = 128 (a group is a stage, its four
//   steps unrolled) a warpgroup holds two int32 accumulators: group t +
//   1's products run on the tensor cores while it promotes group t (20%
//   faster than one), and the other warpgroup's work fills the gaps.
//   Other g take one accumulator and a loop over the steps.
// - A stage is released once the last group that reads it (its products
//   and its scales) is promoted; a group wider than 128 bytes frees its
//   earlier stages when it crosses into the next.
// - K6 launches the GEMM as a programmatic dependent of its pre-pass: its
//   CTAs start as the pre-pass's last CTAs run, and their barrier set-up
//   overlaps that tail; the producer executes griddepcontrol.wait before
//   its first load.  (Issuing the first stages' weight boxes before the
//   wait, which do not depend on the pre-pass, measured slower by A/B:
//   PERF.md.)  K7 launches without the attribute (the wait returns at
//   once).
// The pre-pass: x (M, K) is a flat run of M G groups of g values.  L lanes
// (4 at g <= 128) own a group and hold its g / 8 16-byte pieces in
// registers, R = g / (8 L) each (lane j pieces j, j + L, ...), all loaded
// before any is reduced; the group's amax goes over the L lanes by
// shuffles, each lane takes the scale and quantizes its own pieces into
// 8-byte stores.  No shared memory, no second read of x (but for a g whose
// pieces do not fit kQuantSlots a lane, g = 288 for one, which reads its
// group twice).  A CTA of 256 threads holds 64 groups at g = 128 (4 rows
// of K = 2,048; 512 threads measured 8-10% slower).  What bounds it: x read
// once and xq and a_s written once, 38 MB at (6,144, 2,048), 11.4 us at
// 3.35 TB/s; the IEEE divisions of the twin's rounding, about ten
// instructions a value, run beside the loads (with a product in place of
// the division, a probe, it read 29% faster).
#include "decoder_attention_sm90.cuh"

namespace mjv {
namespace q8g_sm90 {

using attention_sm90::bf16;
using attention_sm90::encode_tiled;
using attention_sm90::EncodeTiled;
using attention_sm90::make_desc;
using attention_sm90::mbar_arrive;
using attention_sm90::mbar_expect_tx;
using attention_sm90::mbar_init;
using attention_sm90::mbar_wait;
using attention_sm90::Regs;
using attention_sm90::smem_u32;
using attention_sm90::wgmma_commit;
using attention_sm90::wgmma_fence;
using attention_sm90::wgmma_wait;

constexpr int kBoxK = 128;  // K bytes per stage: one 128-byte swizzle row
constexpr int kSlots = 4;   // groups one stage can touch (g >= 32)

template <int WG, int STAGES>
struct Config {
  static constexpr int kWG = WG;
  static constexpr int kBlockM = 64 * WG;  // xq rows per CTA
  static constexpr int kBlockN = 128;      // output columns per CTA
  static constexpr int kConsumerWarps = 4 * WG;
  static constexpr int kThreads = (kConsumerWarps + 4) * 32;
  static constexpr int kStages = STAGES;
  static constexpr int kConsumerRegs = Regs<WG>::kConsumer;
  static constexpr int kProducerRegs = Regs<WG>::kProducer;
  static constexpr uint32_t kABytes = kBlockM * kBoxK;
  static constexpr uint32_t kBBytes = kBlockN * kBoxK;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // Per stage and group slot: w_s of the 128 columns, then a_s of the rows.
  static constexpr int kSlotFloats = kBlockN + kBlockM;
  static constexpr uint32_t kScaleOff = kStages * kStageBytes;
  static constexpr uint32_t kBarOff =
      kScaleOff + kStages * kSlots * kSlotFloats * 4;
  static constexpr uint32_t kSmemBytes = kBarOff + 2 * kStages * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
};

using Q8G = Config<2, 4>;  // K6's GEMM and K7

__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map,
                                            uint32_t dst, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 4 bytes from global to shared memory, zeros when !valid (src unread).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

#define MJV_ACC64(d)                                                        \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),      \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),      \
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),      \
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),      \
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),      \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),      \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d (+)= A B for a 64 x 128 x 32 int8 step, both operands K-major in
// shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : MJV_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MJV_ACC64

template <int N>
__device__ __forceinline__ void fence_ints(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_shared_f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// Accumulator layout of wgmma m64n128 (per warpgroup, as in
// decoder_attention_sm90.cuh): warp w holds rows 16 w .. 16 w + 15; lane
// (r = lane / 4, c = lane % 4) holds, for each 8-column block j, d[4 j + e]
// at row r, column 8 j + 2 c + e and d[4 j + 2 + e] at row r + 8.
template <class C, bool OUT_BF16>
__global__ void __launch_bounds__(C::kThreads, 1)
q8g_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const float* __restrict__ a_scale,
                const float* __restrict__ w_scale, void* __restrict__ out,
                int M, int N, int K, int G) {
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t scales = base + C::kScaleOff;
  const uint32_t bar = base + C::kBarOff;
  auto stage_a = [&](int t) {
    return base + (t % kStages) * C::kStageBytes;
  };
  auto stage_scales = [&](int t) {
    return scales + (t % kStages) * kSlots * C::kSlotFloats * 4;
  };
  auto full_bar = [&](int t) { return bar + 8 * (t % kStages); };
  auto empty_bar = [&](int t) { return bar + 8 * (kStages + t % kStages); };

  const int n0 = blockIdx.x * C::kBlockN;
  const int m0 = blockIdx.y * C::kBlockM;
  const int g = K / G;
  const int n_steps = K / 32;  // k32 steps
  const int n_tiles = (n_steps + 3) / 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 33);
      mbar_init(empty_bar(s), C::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (warp != C::kConsumerWarps) return;
    // K6 launches this grid behind its pre-pass: wait for xq and a_s
    // before the first load.  Issuing the first stages' weight boxes
    // before the wait measured 1.5-2.5% slower, K7 too, by A/B on the card.
    // The fence orders the pre-pass's generic-proxy writes of xq before
    // this thread's TMA (async-proxy) reads; it measured free, and runs
    // without it gave the same bits.
    attention_sm90::grid_dependency_wait();
    asm volatile("fence.proxy.async.global;" ::: "memory");
    for (int t = 0; t < n_tiles; ++t) {
      if (t >= kStages) mbar_wait(empty_bar(t), (t / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full_bar(t), C::kStageBytes);
        tma_load_2d(&ta, stage_a(t), full_bar(t), kBoxK * t, m0);
        tma_load_2d(&tb, stage_a(t) + C::kABytes, full_bar(t), kBoxK * t,
                    n0);
      }
      // The groups this stage's K bytes touch, slot j = group g0 + j.
      const int g0 = (kBoxK * t) / g;
      const int g1 = min(G - 1, (kBoxK * t + kBoxK - 1) / g);
      for (int j = 0; j <= g1 - g0; ++j) {
        const uint32_t slot = stage_scales(t) + j * C::kSlotFloats * 4;
        const float* ws = w_scale + (long long)(g0 + j) * N;
#pragma unroll
        for (int u = 0; u < C::kBlockN / 32; ++u) {
          const int col = n0 + 32 * u + lane;
          cp_async_4(slot + (32 * u + lane) * 4, col < N ? ws + col : ws,
                     col < N);
        }
#pragma unroll
        for (int u = 0; u < C::kBlockM / 32; ++u) {
          const int row = m0 + 32 * u + lane;
          const float* as = a_scale + (row < M ? (long long)row * G : 0) +
                            g0 + j;
          cp_async_4(slot + (C::kBlockN + 32 * u + lane) * 4, as, row < M);
        }
      }
      cp_async_arrive(full_bar(t));
    }
    return;
  }

  // The consumers: warpgroup wg owns the CTA's rows 64 wg .. 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int c = lane % 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const int steps = g / 32;  // k32 steps per group

  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;

  // Promote: sum += (float(acc) * a_s) * w_s, the twin's order, from the
  // scales in `slot` (the stage that holds the group's last step).
  auto promote = [&](const int (&acc)[64], uint32_t slot) {
    const float as0 = ld_shared_f(slot + (C::kBlockN + row0) * 4);
    const float as8 = ld_shared_f(slot + (C::kBlockN + row0 + 8) * 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 w = ld_shared_f2(slot + (8 * j + 2 * c) * 4);
      const float ws[2] = {w.x, w.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[4 * j + e] = __fadd_rn(
            sum[4 * j + e],
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), as0),
                      ws[e]));
        sum[4 * j + 2 + e] = __fadd_rn(
            sum[4 * j + 2 + e],
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), as8),
                      ws[e]));
      }
    }
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(t));
  };

  if (g == kBoxK) {
    // g = 128 (the -g128 modes): group t is stage t, four k32 steps
    // unrolled.  Group t + 1's products run on the tensor cores while this
    // warpgroup promotes group t.
    int acc0[64], acc1[64];
    auto issue = [&](int (&acc)[64], int t) {
      mbar_wait(full_bar(t), (t / kStages) & 1);
      const uint64_t da = make_desc(stage_a(t) + wg * 64 * kBoxK, 16, 1024);
      const uint64_t db = make_desc(stage_a(t) + C::kABytes, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk > 0);  // 32 bytes a step
      }
      wgmma_commit();
    };
    issue(acc0, 0);
    for (int t = 0; t < G; t += 2) {
      if (t + 1 < G) {
        issue(acc1, t + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_ints(acc0);
      promote(acc0, stage_scales(t));
      release(t);
      if (t + 1 < G) {
        if (t + 2 < G) {
          issue(acc0, t + 2);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_ints(acc1);
        promote(acc1, stage_scales(t + 1));
        release(t + 1);
      }
    }
  } else {
    // Any g, one accumulator: a group's k32 steps may span stages.
    int acc[64];
    int waited = -1;   // the last stage waited for
    int released = 0;  // stages released so far
    int step = 0;
    for (int grp = 0; grp < G; ++grp) {
      wgmma_fence();
      for (int s = 0; s < steps; ++s, ++step) {
        const int t = step / 4;
        if (t > waited) {
          if (s > 0) {
            // A group wider than the stage: the stages before t hold no
            // scale still to be read, so free them once their products
            // are done (else a group of more than kStages stages never
            // starts).
            wgmma_commit();
            wgmma_wait<0>();
            for (; released < t; ++released) release(released);
          }
          mbar_wait(full_bar(t), (t / kStages) & 1);
          waited = t;
        }
        const uint32_t koff = (step % 4) * 32;
        wgmma_s8(acc,
                 make_desc(stage_a(t) + wg * 64 * kBoxK + koff, 16, 1024),
                 make_desc(stage_a(t) + C::kABytes + koff, 16, 1024), s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_ints(acc);
      const int tl = (step - 1) / 4;
      promote(acc, stage_scales(tl) +
                       (grp - (kBoxK * tl) / g) * C::kSlotFloats * 4);
      // Every stage whose last step is done (all of them after the last
      // group) is free once its scales are read.
      for (; released < n_tiles &&
             (4 * (released + 1) <= step || step == n_steps);
           ++released) {
        release(released);
      }
    }
  }

  // Masked stores; pairs where N is even (aligned), single values else.
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + row0 + 8 * r;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      const float v0 = sum[4 * j + 2 * r], v1 = sum[4 * j + 2 * r + 1];
      const long long o = (long long)row * N + col;
      if (OUT_BF16) {
        bf16* dst = static_cast<bf16*>(out) + o;
        if (pairs && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* dst = static_cast<float*>(out) + o;
        if (pairs && col + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (col < N) dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

// The row scale of an amax: max(amax / 127, 1e-12), IEEE division.
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

// clip(round_half_even(v / s), -127, 127), v / s the IEEE quotient.
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return uint32_t(max(-127, min(127, q))) & 0xffu;
}

// 8 bf16 quantized with scale s into 8 int8 bytes.
__device__ __forceinline__ uint2 quantize8(const uint4& v, float s) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lo |= quantize(__bfloat162float(e[t]), s) << (8 * t);
    hi |= quantize(__bfloat162float(e[t + 4]), s) << (8 * t);
  }
  return make_uint2(lo, hi);
}

constexpr int kQuantThreads = 256;
constexpr int kQuantSlots = 4;  // 16-byte pieces a lane holds at once

// Lanes per group: 4, doubled (up to a warp) while a lane would hold more
// than kQuantSlots pieces and the pieces still split evenly.
inline int quant_lanes(int g) {
  const int P = g / 8;
  int L = 4;
  while (P / L > kQuantSlots && P % (2 * L) == 0 && 2 * L <= 32) L *= 2;
  return L;
}

// The pre-pass: xq (M, K) int8 and a_s (M, G) fp32 from x (M, K) bf16, as
// NG = M G groups of g values, each owned by L lanes (a power of two that
// divides 32, so a group's lanes are an aligned run of one warp).  Lane j
// of a group holds its pieces j + L r, r < R = g / (8 L): at g = 128 the 4
// lanes of a group read 64 neighbouring bytes per load and 8 groups share a
// warp.  x's rows are 16-byte aligned and g a multiple of 32.
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ a_s, long long NG, int g, int L) {
  const int R = g / 8 / L;
  const int j = threadIdx.x % L;
  const long long grp =
      (long long)blockIdx.x * (kQuantThreads / L) + threadIdx.x / L;
  const bool live = grp < NG;
  const uint4* src = reinterpret_cast<const uint4*>(x) + grp * (g / 8) + j;
  uint2* dst = reinterpret_cast<uint2*>(xq) + grp * (g / 8) + j;
  // R > kQuantSlots: the group in slices of kQuantSlots pieces a lane, read
  // once for the amax and again to quantize.
  const bool twice = R > kQuantSlots;
  uint4 piece[kQuantSlots];
  auto load = [&](int r0) {
#pragma unroll
    for (int s = 0; s < kQuantSlots; ++s) {
      piece[s] = live && r0 + s < R ? __ldg(src + L * (r0 + s))
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  float amax = 0.f;
  for (int r0 = 0; r0 < R; r0 += kQuantSlots) {
    load(r0);
    if (r0 == 0) attention_sm90::grid_launch_dependents();
#pragma unroll
    for (int s = 0; s < kQuantSlots; ++s) {
      const bf16* e = reinterpret_cast<const bf16*>(&piece[s]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        amax = fmaxf(amax, fabsf(__bfloat162float(e[t])));
      }
    }
  }
  // L is uniform, so every lane reaches the shuffles.
  for (int o = L / 2; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = row_scale(amax);
  if (live && j == 0) a_s[grp] = scale;
  for (int r0 = 0; r0 < R; r0 += kQuantSlots) {
    if (twice) load(r0);
#pragma unroll
    for (int s = 0; s < kQuantSlots; ++s) {
      if (live && r0 + s < R) dst[L * (r0 + s)] = quantize8(piece[s], scale);
    }
  }
}

// A (rows, inner) int8 array with row stride `row_bytes` in boxes of 128
// bytes x `box_rows` rows, 128-byte swizzle, zero fill past either edge.
inline bool encode_u8(CUtensorMap* map, const void* ptr, int inner, int rows,
                      long long row_bytes, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {cuuint32_t(kBoxK), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid_shape(int M, int N, int K, int G) {
  return M > 0 && N > 0 && G > 0 && K % G == 0 && (K / G) % 32 == 0;
}

// dependent: launch as the programmatic dependent of the pre-pass (K6).
template <bool OUT_BF16>
int launch_gemm_as(CUtensorMap ta, CUtensorMap tb, const float* a_scale,
                   const float* w_scale, void* out, int M, int N, int K,
                   int G, cudaStream_t stream, bool dependent) {
  using C = Q8G;
  auto kernel = q8g_gemm_kernel<C, OUT_BF16>;
  cudaError_t err = attention_sm90::open_smem<q8g_gemm_kernel<C, OUT_BF16>>(
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + C::kBlockN - 1) / C::kBlockN,
                  (M + C::kBlockM - 1) / C::kBlockM);
  if (dependent) {
    void* args[] = {&ta, &tb, &a_scale, &w_scale, &out, &M, &N, &K, &G};
    err = attention_sm90::launch_dependent(
        reinterpret_cast<const void*>(kernel), grid, dim3(C::kThreads),
        C::kSmemBytes, stream, args);
    if (err != cudaSuccess) return int(err);
  } else {
    kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
        ta, tb, a_scale, w_scale, out, M, N, K, G);
  }
  return int(cudaGetLastError());
}

// K7's GEMM: xq (M, K) int8 row-major, a_scale (M, G), wq the k-major
// weight ((N, K) row-major, row stride ldk bytes), w_scale (G, N) -> out
// (M, N) bf16 (out_bf16) or fp32.
int launch_gemm(const void* xq, const void* a_scale, const void* wq,
                const void* w_scale, void* out, int out_bf16, int M, int N,
                int K, int G, long long ldk, cudaStream_t stream,
                bool dependent) {
  CUtensorMap ta, tb;
  if (!encode_u8(&ta, xq, K, M, K, Q8G::kBlockM) ||
      !encode_u8(&tb, wq, K, N, ldk, Q8G::kBlockN)) {
    return int(cudaErrorInvalidValue);
  }
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  return out_bf16 ? launch_gemm_as<true>(ta, tb, as, ws, out, M, N, K, G,
                                         stream, dependent)
                  : launch_gemm_as<false>(ta, tb, as, ws, out, M, N, K, G,
                                          stream, dependent);
}

int launch_quantize(const void* x, void* xq, void* a_s, int M, int K, int G,
                    cudaStream_t stream) {
  const int g = K / G;
  const int L = quant_lanes(g);
  const long long NG = (long long)M * G;
  const int per_cta = kQuantThreads / L;
  quantize_rows_kernel<<<unsigned((NG + per_cta - 1) / per_cta),
                         kQuantThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(a_s), NG, g, L);
  return int(cudaGetLastError());
}

}  // namespace q8g_sm90
}  // namespace mjv

namespace q8g = mjv::q8g_sm90;

// The pre-pass alone: x (M, K) bf16 -> xq (M, K) int8, a_s (M, G) fp32.
extern "C" int mjv_q8g_quantize(const void* x, void* xq, void* a_s, int M,
                                int K, int G, void* stream) {
  if (!q8g::valid_shape(M, 1, K, G)) return int(cudaErrorInvalidValue);
  return q8g::launch_quantize(x, xq, a_s, M, K, G,
                              static_cast<cudaStream_t>(stream));
}

// K6: x (M, K) bf16, wq the k-major (K, N) int8 weight (an (N, K) array
// of row stride ldk bytes), w_scale (G, N) fp32; xq (M, K) int8 and a_s
// (M, G) fp32 scratch -> out (M, N) bf16 (out_bf16 = 1) or fp32.  The
// pre-pass, then the GEMM as its programmatic dependent.
extern "C" int mjv_q8g_matmul_fused(const void* x, const void* wq,
                                    const void* w_scale, void* xq, void* a_s,
                                    void* out, int out_bf16, int M, int N,
                                    int K, int G, long long ldk,
                                    void* stream) {
  if (!q8g::valid_shape(M, N, K, G)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = q8g::launch_quantize(x, xq, a_s, M, K, G, s);
  if (err != 0) return err;
  return q8g::launch_gemm(xq, a_s, wq, w_scale, out, out_bf16, M, N, K, G,
                          ldk, s, true);
}

// K7: xq (M, K) int8, a_scale (M, G) fp32, wq and w_scale as for K6 ->
// out (M, N) fp32.
extern "C" int mjv_q8g_matmul(const void* xq, const void* a_scale,
                              const void* wq, const void* w_scale, void* out,
                              int M, int N, int K, int G, long long ldk,
                              void* stream) {
  if (!q8g::valid_shape(M, N, K, G)) return int(cudaErrorInvalidValue);
  return q8g::launch_gemm(xq, a_scale, wq, w_scale, out, 0, M, N, K, G, ldk,
                          static_cast<cudaStream_t>(stream), false);
}
