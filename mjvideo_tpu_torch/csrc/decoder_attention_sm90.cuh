// Attention forwards for Hopper (sm_90a): wgmma, TMA and a producer warp.
// One template for nine kernels, chosen by the softmax's shift, the head
// dim, the floor, whether an lse pointer is given and, for the ViT A/B
// harnesses' B1 and B2, the heads a CTA and the softmax's Variant:
//   K3  (ShiftMode::kExact) replaces _fwd_kernel
//       (mjvideo_tpu/ops/flash_attention.py:260, call :579), the exact
//       online softmax, causal with a per-row q_offset or non-causal (at
//       D = 112 non-causal only: the EVA2-CLIP-E tower's exact mode of
//       _fwd_nc_kernel, flash_attention.py:99, cogvlm2.py:366-367);
//       K3 lse (kExact with a non-null lse) replaces _fwd_kernel(with_lse=
//       True) (:526-530), the ring's chunk forward: its epilogue writes
//       m ln 2 + log(l), m the row max in log2 units, or kDeadLse where
//       the row saw no live key (m stays -inf and l 0);
//   K2r (kRows) replaces _fwd_bound_kernel(row_bound=True)
//       (flash_attention.py:318, :347-358; host side :484-508), causal
//       under the per-row Cauchy-Schwarz bound
//         m_i = |scale| |q_i| kcum[b, h // G, clip(q_offset + i, 0, K - 1)]
//       with kcum the running max of masked key norms along K (a
//       (B, Hkv, K) fp32 array written by the pre-pass key_norm_cummax of
//       decoder_attention.cu, the XLA reduce of the TPU path: partials and
//       a scan, which K2r's op launches K2r behind);
//   K2  (kKeyMax, D = 128) replaces _fwd_bound_kernel (flash_attention.py
//       :318, host side :484-511): causal, the same constant shift with one
//       bound per (b, kv head), m_i = |scale| |q_i| kmax[b, h // G], kmax
//       the largest masked key norm (the pre-pass key_norm_max);
//   K1  (kKeyMax, D = 64, 72, 80 or 128, FLOOR) replaces _fwd_nc_kernel
//       with norm_bound (flash_attention.py:99, :131-153): non-causal and
//       maskless over one tile's S tokens (InternViT-300M's 64-wide heads,
//       InternViT-6B's 128-wide ones, vit.py:180-183), one temporal slab's
//       h w patches (the Qwen2-VL vision tower's 80-wide heads,
//       qwen2vl.py:369) or one frame's patches (SigLIP's 72-wide heads,
//       videoscore.py:356-384), the same bound with kmax over all S
//       keys, and the denominator floored at 1e-30 as jnp.maximum(l,
//       1e-30) does;
//   K1m (kKeyMax, D = 72, non-causal, a key mask, no floor) replaces
//       _fwd_bound_kernel with causal=False (flash_attention.py:318,
//       reached from _fwd_impl :439-579): SigLIP's variable-aspect tower,
//       images padded bottom/right with a patch mask as the key mask, kmax
//       the largest live key norm, a row whose sum is 0 giving 0;
//   K2 lse and K1 lse (kKeyMax with a non-null lse) replace
//       _fwd_bound_kernel(with_lse=True) (:407-412) and
//       _fwd_nc_kernel(with_lse=True) (:153-156), the differentiable
//       forwards: the same body, and the epilogue also writes each row's
//       true log-sum-exp m + log(l) (B, Hq, Q) fp32 beside the output, or
//       kDeadLse where l is not positive (the row saw no live key, or every
//       p underflowed; the TPU's K1 writes m + log(1e-30) there, and either
//       gives p = 0 in the backward).  m is the bound in nats and l the sum
//       of the unrounded p (not of bf16(p)), so the backward kernels'
//       exp(s - lse) is the normalised p that the twin forms;
//   B2  (kExact, D = 64, HP heads a CTA) replaces tmajor_impl
//       (benchmarks/vit_attn_variants.py:150): K3's walk, non-causal and
//       maskless, over HP adjacent heads of one q tile;
//   B1  replaces variant_impl (benchmarks/vit_attn_variants.py:63), one
//       Variant or ShiftMode per softmax mode: exp2 (kExact, kFoldQ: q
//       times scale log2(e) in fp32, rounded to bf16, before the first
//       product, so the scores are in log2 units), exp2_nomax (kZero,
//       kFoldQ: p = 2^s, no max), nomax (kZero: p = e^(s scale)) and
//       bf16s (kExact, kBf16s: t = bf16(s scale), m the running max of t,
//       p = bf16(e^bf16(t - m)), the rescale in fp32).  B1 and B2 are the
//       A/B harnesses' tools for K1's design, not a main path.
// Operands: q (B, Q, Hq, D), k and v (B, K, Hkv, D) bf16, D = 128, 112, 96,
// 80, 72 or 64,
// with dense heads and 16-byte row strides (the ViT's q/k/v are strided
// views into one (B, S, 3 H D) qkv tensor); GQA (q head h reads kv head
// h // G); a (B, K) int32 key mask or none; a (B,) int32 q_offset or none
// (the global position of q row 0, possibly negative).  p is rounded to
// bf16 before p @ v, as the TPU kernels do.  Without the floor a row that
// sees no live key gives exactly 0: under K3 its max never leaves -inf (the
// shift is then taken as 0, so no inf - inf), under K2 and K2r its sum l is
// 0.  With it (K1) a row whose sum underflowed gives acc / 1e-30, about 0,
// never NaN.
//
// What bounds it on this card: at the judge's (2, 3072, 3072, 16/8, 128)
// the two products are about 72 GFLOP over the live causal pairs (0.073
// ms at 989 TFLOP/s) on 13 MB of operands; at the ViT's (8, 1025, 16, 64)
// 34 GFLOP (0.035 ms) on 67 MB.  Both are compute-bound, and only wgmma
// reaches the tensor cores' full rate.  The first (WMMA) template these
// replaced, now deleted, reached about 2-5% of it: scores and p went
// through shared memory, K3's rescale too, loads were synchronous and the
// key mask was read from global memory per key and tile.  Here, measured
// on an H100, the products alone (no softmax) run at about 60% of the peak
// and the loads are not the limit; the softmax's exp2 on the
// special-function unit (one per score) is the largest remaining cost, and
// at D = 64 it weighs twice as much against the products as at 128.
//
// Design.  One CTA per (b, q head, q tile of 64 rows per consumer
// warpgroup), heaviest tiles first (the q tile index runs backwards along
// the grid's slow axis), with consumer warpgroups and one producer, which
// gives its registers to them (setmaxnreg; at D = 128, 40 against 232 a
// thread: at 168 each ptxas serializes the wgmmas and spills).
// - The producer's first warp loads the q tile once, then each k and v
//   tile (128 keys; 64 in B2's Configs) by TMA (cp.async.bulk.tensor,
//   128-byte swizzle, one 64-column box per 64 head columns) into a ring
//   of stages with full/empty mbarriers; TMA's zero fill covers the ragged
//   tail.  Beside each stage it writes the tile's key-liveness bits (mask
//   and j < K, one ballot per 32 keys).
// - Each consumer warpgroup computes s = q k^T with D / 16
//   wgmma.m64n128k16 from shared memory (both operands K-major), takes the
//   softmax on the accumulator registers (the row max over a quad by two
//   shuffles, exp2 on the special-function unit with scale * log2(e)
//   folded into one multiply; K3 rescales its output accumulator in
//   registers, the bound shifts are constant along the row and need no max
//   and no rescale), rounds p to bf16 in registers and feeds it as the
//   register A operand of 8 wgmma.m64nDk16 against v (the B operand
//   MN-major through the transposed descriptor).  Nothing of s, p or the
//   accumulator goes through shared memory.  Tile t + 1's q k^T is issued
//   together with tile t's p v, so the softmax of t + 1 runs while the
//   tensor cores work; o is rescaled and p repacked after p v is done.
// - The bound shifts take |q_i| from the q tile in shared memory and their
//   key-norm bound from a pre-pass kernel (decoder_attention.cu).  K2r's
//   consumers read its K floats per (b, kv head) at their rows, after
//   griddepcontrol.wait (K2r's op launches it behind the pre-pass's scan as
//   a programmatic dependent: the q tile, the kv stages and |q| need no
//   wait; the kernel alone waits for nothing).  K2's and
//   K1's kmax comes as the pre-pass's partial maxima, (B, nparts, Hkv): the
//   producer warpgroup's second warp, idle otherwise, executes
//   griddepcontrol.wait (the programmatic dependent launch of the fused
//   entries: this grid may start while the pre-pass runs), folds the
//   nparts floats of its (b, kv head) by shuffles (max is exact, so any
//   order gives the same bits) and hands the result to the consumers
//   through shared memory and an mbarrier.  Nothing else waits: the q tile,
//   the first kv stages and the consumers' first q k^T do not depend on the
//   pre-pass, and the consumers wait for the bound only before their first
//   softmax.  The kernel-alone entries pass a folded kmax as nparts = 1 and
//   launch without the attribute, where the wait returns at once.
// - The mask arithmetic runs only on a tile with a masked key (or one
//   past K) or one that reaches past the warp's first row, chosen once
//   per tile for the warp; a CTA stops at the last tile touching its
//   diagonal and writes zeros at once when a negative offset leaves it no
//   key.  q rows past Q (S = 1025 leaves one real row in the last tile)
//   are TMA's zeros and are not written.
// - No split over the keys: each row walks its tiles in a fixed order
//   from key 0, and keys past its position contribute exact zeros, so a
//   row's result does not depend on K (K2r's prefix rows are bit-identical
//   between a prefix-only and a full-prompt prefill).
// - The head dim, the consumer warpgroups, the stages and the register
//   split are a Config: D128 (K3, K2r, K2 and K2 lse: 2 warpgroups, 128 q
//   rows, 3 stages of 64 KB) and D64 (K1 and K1 lse: 3 warpgroups, 192 q
//   rows, 3 stages of 32 KB), the latter chosen by A/B on the card
//   (tools/d64_config_ab_torch.py): at D = 64 the accumulator is half as
//   large, so a third warpgroup fits in the registers (160 a consumer
//   thread) and keeps more softmax work in flight per SM, which measured
//   faster than two (PERF.md).  D96 (K2, K2r, K3 and their lse forms at
//   Phi-3's head dim) is laid out as D128: two 64-column boxes a row, whose
//   second box reads columns 96-127 past the tensor map's D = 96 columns
//   as TMA's zero fill.  q k^T stops after the 6 k-steps of the real columns; p v runs
//   at n128, and the zero columns of v give exact zeros in accumulator
//   columns 96-127, which are not stored; |q| and kmax sum no more than
//   the real columns' squares.  It costs a third more p v work and shared
//   memory than a 64 + 32-column layout under a 64-byte swizzle with
//   m64n96k16 would; D128's stages and register split fit as they are.
//   D80 (K1 at the Qwen2-VL vision tower's head dim) is laid out the same
//   way: two 64-column boxes, columns 80-127 TMA's zero fill (a row is 160
//   bytes, so the tensor map's strides stay 16-byte multiples), q k^T over
//   the 5 k-steps of the real columns, p v at n128 into accumulator
//   columns 80-127 that stay exactly 0, the output stored at an 80-element
//   row stride over 10 column blocks.  D72 (K1 and its masked form at
//   SigLIP-so400m's head dim, the VideoScore and MiniCPM-V towers) too:
//   a row is 144 bytes (9 x 16, so the strides hold), columns 72-127 are
//   the zero fill.  72 is not a multiple of wgmma's k of 16, so q k^T
//   takes 5 k-steps, the fifth reading columns 72-79 as zeros; p v runs at
//   n128 and the output is stored at a 72-element stride over 9 column
//   blocks.  D112 (K3 not causal at the EVA2-CLIP-E tower's head dim, the
//   CogVLM2-Video judge) too: a row is 224 bytes (14 x 16, so the strides
//   hold for dense heads and for views into one qkv product), columns
//   112-127 are the zero fill; 112 = 7 x 16, so q k^T takes exactly the 7
//   k-steps of the real columns (the second box's 3 read its 48 real
//   columns); p v runs at n128 and the output is stored at a 112-element
//   stride over 14 column blocks.
// - Heads a CTA (HP, B2 only, D = 64): the WG / HP warpgroups of each head
//   take 64 of its q rows each; q is one box per head and each stage holds
//   one 64-column k box and one v box per head under its one full/empty
//   pair, so one producer and one ring serve HP heads.  The key tile is
//   128 keys, or 64 where four consumer warpgroups leave 112 registers a
//   thread (Regs<4>): the score tile and p halve.  Every main-path Config
//   is one head a CTA and 128 keys a tile, and a kernel with the defaults
//   (HP 1, 128 keys, Variant::kPlain) is the code it was before them.
// - B1's q fold runs after the q box lands: each consumer warpgroup scales
//   its own 64 rows in shared memory (elementwise, so the 128-byte swizzle
//   does not matter), then fence.proxy.async and the warpgroup's named
//   barrier order the stores before its first wgmma reads them.
// - The lse costs one fp32 store per row (one lane of each quad) after the
//   main loop, behind a branch uniform over the CTA: no instantiation of
//   its own and nothing in the main loop.
// - The exponent budget.  ex2.approx.ftz flushes results below 2^-126, so
//   under a bound shift a key more than 87.3 nats below its row's bound
//   gives p = 0, and a row whose bound overshoots its largest score by
//   that much dies (l = 0: output 0, lse kDeadLse), as the TPU kernels'
//   flush does at about 85 nats; the fp32 twin (torch.exp keeps
//   subnormals) keeps such rows down to about 103 nats.  At training's
//   stepped weights the largest overshoot is 48 nats
//   (tools/k2lse_budget_torch.py, PERF.md).
// The tensor maps are encoded on the host per call with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
// -lcuda at link time).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mjv {
namespace attention_sm90 {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2eLo = 1.925963e-8f;  // log2(e) - kLog2e
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLn2Lo = -1.9046543e-9f;  // ln(2) - kLn2
constexpr float kDeadLse = 1e30f;  // DEAD_LSE of flash_attention.py

// How each row's softmax is shifted.
enum class ShiftMode {
  kExact,   // K3: the running row max, with the rescale
  kRows,    // K2r: |scale| |q_i| kcum[b, kv head, pos_i]
  kKeyMax,  // K2, K1 and their lse forms: |scale| |q_i| kmax[b, kv head]
  kZero,    // B1 nomax and exp2_nomax: no shift, no max, no rescale
};

// How the softmax departs from its ShiftMode's plain arithmetic (B1's
// modes); every main-path kernel and B2 take kPlain.
enum class Variant {
  kPlain,
  kFoldQ,  // q x scale (scale log2(e) from B1's entry) rounded to bf16 in
           // shared memory; the scores are then in log2 units as they are
  kBf16s,  // kExact at bf16s's rounding points (softmax_body)
};

// The registers a thread may hold after setmaxnreg, given the warpgroups:
// the consumers take what the producer gives up, and no more than the CTA
// was given at launch (65,536 per SM, one CTA, in steps of 8 a thread), or
// setmaxnreg.inc waits for ever.
template <int WG>
struct Regs;
template <>
struct Regs<2> {  // 2 x 128 x 232 + 128 x 40 = 64,512
  static constexpr int kConsumer = 232, kProducer = 40;
};
template <>
struct Regs<3> {  // 3 x 128 x 160 + 128 x 32 = 65,536
  static constexpr int kConsumer = 160, kProducer = 32;
};
template <>
struct Regs<4> {  // 4 x 128 x 112 + 128 x 32 = 61,440: 640 threads hold
  static constexpr int kConsumer = 112, kProducer = 32;  // 96 at launch
};

// HP heads a CTA (D = 64 only), each served by WG / HP consumer
// warpgroups; BLOCK_K keys a kv tile.  D = 72, 80, 96 and 112 take two
// boxes, the second partly zero fill (D72, D80, D96 and D112 above).
template <int D, int WG, int STAGES, int HP = 1, int BLOCK_K = 128>
struct Config {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 72 ||
                    D == 112,
                "head dim 64, 72, 80, 96, 112 or 128");
  static_assert(HP == 1 || D == 64, "several heads a CTA at D = 64 only");
  static_assert(WG % HP == 0, "whole warpgroups a head");
  static_assert(BLOCK_K == 64 || BLOCK_K == 128, "64 or 128 keys a tile");
  static constexpr int kD = D;
  static constexpr int kHeads = HP;
  static constexpr int kBlockK = BLOCK_K;  // keys per kv tile
  static constexpr int kBoxes = (D + 63) / 64;  // 64-column (128-byte) boxes
  static constexpr int kConsumerWarps = 4 * WG;
  static constexpr int kHeadWG = WG / HP;  // consumer warpgroups a head
  static constexpr int kBlockQ = 64 * WG / HP;  // q rows per head and CTA
  static constexpr int kThreads = (kConsumerWarps + 4) * 32;
  static constexpr int kStages = STAGES;
  // o floats a thread: m64nN with N the boxes' 64 columns each.
  static constexpr int kAcc = 32 * kBoxes;
  static constexpr int kConsumerRegs = Regs<WG>::kConsumer;
  static constexpr int kProducerRegs = Regs<WG>::kProducer;
  static constexpr uint32_t kQBox = kBlockQ * 128;  // bytes of one q box
  static constexpr uint32_t kKvBox = kBlockK * 128;
  // Head j's boxes follow head j - 1's, in q and in each of k and v.
  static constexpr uint32_t kQBytes = HP * kBoxes * kQBox;
  static constexpr uint32_t kKvBytes = HP * kBoxes * kKvBox;
  static constexpr uint32_t kStageBytes = 2 * kKvBytes;  // k and v
  static constexpr uint32_t kBarOff = kQBytes + kStages * kStageBytes;
  // full[s], empty[s], q's and the folded bound's.
  static constexpr uint32_t kBitsOff = kBarOff + (2 * kStages + 2) * 8;
  static constexpr uint32_t kBoundOff = kBitsOff + kStages * 16;
  static constexpr uint32_t kSmemBytes = kBoundOff + 16 + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
};

using D128 = Config<128, 2, 3>;  // K3, K2r, K2, K2 lse, K1 (InternViT-6B)
using D96 = Config<96, 2, 3>;    // K3, K2r, K2 and their lse forms (Phi-3)
using D80 = Config<80, 2, 3>;    // K1 (the Qwen2-VL vision tower)
using D72 = Config<72, 2, 3>;    // K1 and its masked form (SigLIP-so400m)
using D112 = Config<112, 2, 3>;  // K3 not causal (the EVA2-CLIP-E tower)
using D64 = Config<64, 3, 3>;    // K1, K1 lse

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Programmatic dependent launch.  wait: block until the grids this one
// depends on have completed and their writes are visible (at once when the
// grid was launched without the attribute).  launch_dependents: let the
// next grid, if launched with it, start once every CTA of this one has
// executed it or exited.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile whose
// 1024-byte swizzle atoms are 1024-aligned: start address, leading and
// stride byte offsets (in 16-byte units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it, and from reusing the registers of an
// A operand that a running wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define MJV_ACC64(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define MJV_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define MJV_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define MJV_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a 64 x 128 x 16 step, A and B from shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MJV_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : MJV_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for a 64 x N x 16 step (N = 128 or 64: the head dim's boxes), A
// (bf16 pairs) from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MJV_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : MJV_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MJV_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : MJV_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
// The 64 x 64 x 16 step of q k^T for a 64-key tile.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MJV_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : MJV_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MJV_ACC64
#undef MJV_REGS64
#undef MJV_ACC32
#undef MJV_REGS32

// 2^x by the special-function unit, denormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kBf16s: a pair of fp32 values rounded to bf16 and back, one conversion.
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
}

// One tile's softmax on the score accumulator sc (m64nN layout, below; N
// the tile's keys, 2 N / 4 floats a thread), in place: sc becomes p.  K3:
// the running max m (log2 units) and sum l are updated, alpha = exp2(m_old
// - m_new) is returned for the caller to rescale o with; a row that has
// seen no live key keeps m = -inf and its shift is taken as 0.  The bound
// shifts: m is the row's fixed shift, alpha = 1; K2r's is in log2 units
// (one FMA per score), K2's and K1's in nats with the twin's arithmetic
// (below); kZero has none (B1's unshifted modes).  Under a bound p is e^-13
// or so at the decoder's gaps, and a p that differs from the twin's by 1e-6
// (x log2(e) rounded once) rounds to the other bf16 often enough that the
// 2B scores' bf16 noise moved past the SP bar of chip_smoke.py; at 2^-22
// the kernel rounds p as the twin and the WMMA template did (PERF.md).
// kFoldQ: the scores are already in log2 units (q carries scale log2(e)).
// kBf16s: m is the running max of t = bf16(s scale) in nats, p = bf16(e^d)
// with d = bf16(t - m), alpha = e^(m_old - m_new) in fp32; l sums the bf16
// p.  Its twin takes every p against the row's final max: the two differ
// only where an earlier max rounded d or p to another bf16.
// MASKED: key 8 j + 2 c + e of the tile (this lane's bit 2 j + e of
// `live`) is visible to row r when its bit is set and 8 j + e <= lim[r].
// The two forms are separate code, chosen once per tile: a test per
// element would put a branch around every exp.
template <bool CAUSAL, ShiftMode SHIFT, Variant VAR, bool MASKED, int N>
__device__ __forceinline__ void softmax_body(float (&sc)[N], uint32_t live,
                                             const int (&lim)[2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             float sl2) {
  constexpr int kJ = N / 4;  // 8-key column blocks
  auto visible = [&](int j, int r, int e) {
    const bool bit = (live >> (2 * j + e)) & 1u;
    return CAUSAL ? bit & (8 * j + e <= lim[r]) : bit;
  };
  if (SHIFT != ShiftMode::kExact) {
    alpha[0] = alpha[1] = 1.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = sc[4 * j + 2 * r + e];
          float p;
          if (SHIFT == ShiftMode::kKeyMax) {
            // The twin's exp(s * scale - m), its argument x rounded as the
            // twin rounds it, to ex2.approx's 2^-22: x log2(e) is the
            // rounded product t plus its error tl (an FMA, and the
            // constant's own rounding), and 2^(t + tl) = 2^t (1 + tl ln 2).
            const float x = __fsub_rn(__fmul_rn(s, scale), m[r]);
            const float t = __fmul_rn(x, kLog2e);
            const float tl = fmaf(x, kLog2e, -t) + x * kLog2eLo;
            p = fast_exp2(t);
            p = fmaf(p, tl * kLn2, p);
          } else if (SHIFT == ShiftMode::kZero) {
            p = fast_exp2(VAR == Variant::kFoldQ ? s : s * sl2);
          } else {
            p = fast_exp2(fmaf(s, sl2, -m[r]));
          }
          if (MASKED) p = visible(j, r, e) ? p : 0.f;
          sc[4 * j + 2 * r + e] = p;
          l[r] += p;
        }
      }
    }
    return;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (VAR == Variant::kBf16s) {  // t = bf16(s scale), a pair at once
        float* x = sc + 4 * j + 2 * r;
        x[0] *= scale;
        x[1] *= scale;
        round_bf16x2(x[0], x[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * r + e];
        if (VAR == Variant::kPlain) x *= sl2;  // kFoldQ: log2 units already
        if (MASKED) x = visible(j, r, e) ? x : -INFINITY;
        sc[4 * j + 2 * r + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = VAR == Variant::kBf16s ? fast_exp2((m[r] - m_use) * kLog2e)
                                      : fast_exp2(m[r] - m_use);
    m[r] = m_new;
    mx[r] = m_use;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (VAR == Variant::kBf16s) {  // d = bf16(t - m), p = bf16(e^d)
        float* x = sc + 4 * j + 2 * r;
        x[0] -= mx[r];
        x[1] -= mx[r];
        round_bf16x2(x[0], x[1]);
        x[0] = fast_exp2(x[0] * kLog2e);
        x[1] = fast_exp2(x[1] * kLog2e);
        round_bf16x2(x[0], x[1]);
        l[r] += x[0];
        l[r] += x[1];
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(sc[4 * j + 2 * r + e] - mx[r]);
        sc[4 * j + 2 * r + e] = p;
        l[r] += p;
      }
    }
  }
}

// The tile's softmax from its liveness bits w (key kk of the tile is bit
// kk % 32 of w[kk / 32]): the mask arithmetic only when `need`.
template <bool CAUSAL, ShiftMode SHIFT, Variant VAR, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N],
                                             const uint32_t (&w)[N / 16],
                                             bool need, int k0, int c,
                                             const int (&pos)[2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale,
                                             float sl2) {
  if (!need) {
    const int lim[2] = {0, 0};
    softmax_body<CAUSAL, SHIFT, VAR, false>(sc, 0u, lim, m, l, alpha, scale,
                                            sl2);
    return;
  }
  // This lane's 2 N / 4 keys: 8 j + 2 c + e for j < N / 4, e < 2.
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    live |= ((w[j / 4] >> (8 * (j % 4) + 2 * c)) & 3u) << (2 * j);
  }
  const int lim[2] = {pos[0] - k0 - 2 * c, pos[1] - k0 - 2 * c};
  softmax_body<CAUSAL, SHIFT, VAR, true>(sc, live, lim, m, l, alpha, scale,
                                         sl2);
}

// Accumulator layout of wgmma m64nN (per warpgroup): warp w holds rows
// 16 w .. 16 w + 15; lane (g = lane / 4, c = lane % 4) holds, for each
// 8-column block j, d[4 j + e] at row g, column 8 j + 2 c + e and
// d[4 j + 2 + e] at row g + 8 (e = 0, 1).  The same pairs, packed, are the
// register A fragments of the next product: fragment i = (d[2 i], d[2 i+1]).
// bound: kcum (B, Hkv, K) under kRows, the partial maxima (B, nparts, Hkv)
// of kmax under kKeyMax (nparts = 1: kmax itself).
// lse: (B, Hq, Q) fp32 or null, written under kKeyMax and kExact.
// Heads h .. h + HP - 1 of a CTA read kv heads hk .. hk + HP - 1 (HP > 1
// only where Hq = Hkv).  scale: kFoldQ's fold factor, else the scores'.
template <class C, bool CAUSAL, ShiftMode SHIFT, bool FLOOR,
          Variant VAR = Variant::kPlain>
__global__ void __launch_bounds__(C::kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ mask,
                      const float* __restrict__ bound, int nparts,
                      const int* __restrict__ q_offset,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int Q, int K, int Hq, int Hkv, float scale) {
  static_assert(VAR != Variant::kBf16s || SHIFT == ShiftMode::kExact,
                "bf16s rounds kExact's softmax");
  static_assert(VAR != Variant::kFoldQ || SHIFT == ShiftMode::kExact ||
                    SHIFT == ShiftMode::kZero,
                "a bound shift reads the unfolded |q|");
  constexpr bool kFixed = SHIFT != ShiftMode::kExact;
  constexpr bool kBound =
      SHIFT == ShiftMode::kKeyMax || SHIFT == ShiftMode::kRows;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kWords = kBlockK / 32;  // liveness words a tile
  constexpr int kStages = C::kStages;
  constexpr int kConsumerWarps = C::kConsumerWarps;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + C::kBitsOff);
  const uint32_t sq = base;
  const uint32_t bar = base + C::kBarOff;  // full[s], empty[s], then q's
  const uint32_t q_bar = bar + 16 * kStages;
  const uint32_t bound_bar = q_bar + 8;
  float* kmax_smem =
      reinterpret_cast<float*>(smem_raw + (base - raw) + C::kBoundOff);

  const int h = (blockIdx.x % (Hq / C::kHeads)) * C::kHeads;  // the first
  const int b = blockIdx.x / (Hq / C::kHeads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBlockQ;  // heaviest first
  const int hk = h / (Hq / Hkv);
  const int off = (CAUSAL && q_offset != nullptr) ? q_offset[b] : 0;
  int n_kv = (K + kBlockK - 1) / kBlockK;
  if (CAUSAL) {
    const int last = off + min(q0 + C::kBlockQ, Q) - 1;  // last key seen
    n_kv = last < 0 ? 0 : min(n_kv, last / kBlockK + 1);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (kStages + s), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_init(bound_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // The producer warpgroup gives its registers to the consumers; its
    // first warp loads the q tile, then the kv ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        C::kProducerRegs));
    if (SHIFT == ShiftMode::kKeyMax && warp == kConsumerWarps + 1) {
      // kmax: the fold of the pre-pass's partial maxima, once they exist.
      grid_dependency_wait();
      const float* part = bound + (long long)b * nparts * Hkv + hk;
      float mx = 0.f;  // norms are >= 0
      for (int c = lane; c < nparts; c += 32) {
        mx = fmaxf(mx, part[(long long)c * Hkv]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if (lane == 0) {
        *kmax_smem = mx;
        mbar_arrive(bound_bar);
      }
      return;
    }
    if (warp != kConsumerWarps || n_kv == 0) return;
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int box = 0; box < C::kHeads * C::kBoxes; ++box) {
        tma_load(&tq, sq + box * C::kQBox, q_bar, 64 * (box % C::kBoxes), q0,
                 h + box / C::kBoxes, b);
      }
    }
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % kStages;
      if (t >= kStages) {
        mbar_wait(bar + 8 * (kStages + s), (t / kStages - 1) & 1);
      }
      const int k0 = t * kBlockK;
      uint32_t words[kWords];
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        const int j = k0 + 32 * r + lane;
        const bool live =
            j < K && (mask == nullptr || mask[(long long)b * K + j] != 0);
        words[r] = __ballot_sync(0xffffffffu, live);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kWords; ++r) bits[4 * s + r] = words[r];
        const uint32_t full = bar + 8 * s;
        const uint32_t sk = base + C::kQBytes + s * C::kStageBytes;
        const uint32_t sv = sk + C::kKvBytes;
        mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
        for (int box = 0; box < C::kHeads * C::kBoxes; ++box) {
          const int col = 64 * (box % C::kBoxes), hb = hk + box / C::kBoxes;
          tma_load(&tk, sk + box * C::kKvBox, full, col, k0, hb, b);
          tma_load(&tv, sv + box * C::kKvBox, full, col, k0, hb, b);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns q rows 64 wq .. 64 wq + 63 of head
  // h + head (HP = 1: wq = wg, head 0).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int wg = warp / 4;
  const int head = C::kHeads == 1 ? 0 : wg / C::kHeadWG;
  const int wq = C::kHeads == 1 ? wg : wg % C::kHeadWG;
  const int g = lane / 4;
  const int c = lane % 4;
  const int row0 = 64 * wq + 16 * (warp % 4) + g;  // and row0 + 8
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) pos[r] = off + q0 + row0 + 8 * r;
  const int warp_first = off + q0 + 64 * wq + 16 * (warp % 4);
  const uint32_t sq_head = sq + head * C::kBoxes * C::kQBox;

  float o[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) o[i] = 0.f;
  float l[2] = {0.f, 0.f};
  // K3: the running row max in log2 units; the bound shifts: the fixed one
  // (K2r's in log2 units, K2's and K1's in nats).
  float m[2] = {-INFINITY, -INFINITY};
  const float sl2 = scale * kLog2e;

  // K2 and K1: |q_row|, rounded once; the shift waits for kmax.
  float qn[2] = {0.f, 0.f};
  if (n_kv > 0) {
    mbar_wait(q_bar, 0);
    if (VAR == Variant::kFoldQ) {
      // B1's exp2 modes: this warpgroup's 64 rows of q times scale log2(e)
      // in fp32, rounded to bf16 in place (elementwise: the swizzle only
      // moves 16-byte chunks within a row), then made visible to the async
      // proxy that wgmma reads shared memory through, before this
      // warpgroup's first product.
      const uint32_t rows = sq_head + wq * 64 * 128;
#pragma unroll
      for (int i = 0; i < 4 * C::kBoxes; ++i) {
        const uint32_t addr = rows + (i / 4) * C::kQBox +
                              (threadIdx.x % 128 + 128 * (i % 4)) * 16;
        uint32_t w4[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(w4[0]), "=r"(w4[1]), "=r"(w4[2]), "=r"(w4[3])
                     : "r"(addr));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
          w4[e] = pack_bf16(f.x * scale, f.y * scale);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                     "r"(w4[0]), "r"(w4[1]), "r"(w4[2]), "r"(w4[3])
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    if (kBound) {
      // |q_row| from the swizzled q tile: lane c reads 16-byte chunks c
      // and c + 4 of each box; the quad's four sums make the row's.  K2r
      // sums in fp32 and takes its shift in log2 units.  K2 and K1 sum the
      // squares in double, where the sum of 64 or 128 squares of bf16 values
      // is exact and so independent of its order, and take the twin's
      // m = |q| * (kmax * |scale|) in nats: kmax (the pre-pass's, exact in
      // the same way) and |q| are rounded once, and the twin's fp32 sums
      // lie within about an ulp of them (see softmax_body).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int R = row0 + 8 * r;
        float qn2 = 0.f;
        double qd2 = 0.0;
#pragma unroll
        for (int box = 0; box < C::kBoxes; ++box) {
#pragma unroll
          for (int ch = c; ch < 8; ch += 4) {
            const uint32_t addr =
                sq_head + box * C::kQBox + R * 128 + ((ch ^ (R & 7)) * 16);
            uint32_t w4[4];
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(w4[0]), "=r"(w4[1]), "=r"(w4[2]), "=r"(w4[3])
                         : "r"(addr));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 v2 =
                  *reinterpret_cast<const __nv_bfloat162*>(&w4[e]);
              const float2 f = __bfloat1622float2(v2);
              if (SHIFT == ShiftMode::kKeyMax) {
                qd2 += double(f.x) * f.x + double(f.y) * f.y;
              } else {
                qn2 += f.x * f.x + f.y * f.y;
              }
            }
          }
        }
        if (SHIFT == ShiftMode::kKeyMax) {
          qd2 += __shfl_xor_sync(0xffffffffu, qd2, 1);
          qd2 += __shfl_xor_sync(0xffffffffu, qd2, 2);
          qn[r] = __double2float_rn(sqrt(qd2));
        } else {
          qn2 += __shfl_xor_sync(0xffffffffu, qn2, 1);
          qn2 += __shfl_xor_sync(0xffffffffu, qn2, 2);
          if (r == 0) grid_dependency_wait();  // kcum, from the pre-pass
          const int p = min(max(pos[r], 0), K - 1);
          const float kc = bound[((long long)b * Hkv + hk) * K + p];
          m[r] = sqrtf(qn2) * kc * fabsf(scale) * kLog2e;
        }
      }
    }

    const uint64_t dq =
        make_desc(sq_head + wq * 64 * 128, 16, 1024);  // this warpgroup's rows
    // This warpgroup's head's k box in tile t's stage (its v box is
    // kKvBytes further).
    auto stage_k = [&](int t) {
      return base + C::kQBytes + (t % kStages) * C::kStageBytes +
             head * C::kBoxes * C::kKvBox;
    };
    auto full_bar = [&](int t) { return bar + 8 * (t % kStages); };
    auto empty_bar = [&](int t) { return bar + 8 * (kStages + t % kStages); };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(t));
    };
    float sc[kBlockK / 2];
    uint32_t pa[kBlockK / 4];
    float alpha[2];
    // Tile t's softmax on sc, in place, from the stage's liveness bits.
    auto softmax = [&](int t) {
      const uint32_t* wb = bits + 4 * (t % kStages);
      uint32_t w[kWords];
#pragma unroll
      for (int r = 0; r < kWords; ++r) w[r] = wb[r];
      const int k0 = t * kBlockK;
      uint32_t all = w[0];
#pragma unroll
      for (int r = 1; r < kWords; ++r) all &= w[r];
      // Mask arithmetic only where some key is masked or past K, or the
      // tile reaches past this warp's first row.
      const bool need = all != 0xffffffffu ||
                        (CAUSAL && k0 + kBlockK - 1 > warp_first);
      softmax_tile<CAUSAL, SHIFT, VAR>(sc, w, need, k0, c, pos, m, l, alpha,
                                       scale, sl2);
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < kBlockK / 4; ++i) {
        pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      }
    };
    auto issue_qk = [&](int t) {
      const uint64_t dk = make_desc(stage_k(t), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < (C::kD + 15) / 16; ++kk) {
        // 16-column steps: 32 bytes inside a 128-byte row, then the next
        // 64-column box.  At D = 72 the fifth step reads columns 72-79 as
        // TMA's zero fill.
        const uint32_t col = (kk % 4) * 32;
        const uint32_t qs = (kk / 4) * C::kQBox + col;
        const uint32_t ks = (kk / 4) * C::kKvBox + col;
        wgmma_ss(sc, dq + (qs >> 4), dk + (ks >> 4), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int t) {
      // v as the MN-major B operand: 8-key groups 1024 bytes apart, the
      // next 64 columns (D = 128) one box further.
      const uint64_t dv =
          make_desc(stage_k(t) + C::kKvBytes, C::kKvBox, 1024);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        // 16 keys of v: 16 rows of 128 bytes.
        wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], dv + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
    };

    // s = q k^T of tile t + 1 and o += p v of tile t run together on the
    // tensor cores while this warpgroup takes tile t + 1's softmax; o is
    // rescaled and p repacked once the p v product has read them.  Every
    // warpgroup walks all n_kv tiles; a tile past a warpgroup's rows is all
    // masked and adds exact zeros (K3: alpha = 1).
    mbar_wait(full_bar(0), 0);
    wgmma_fence();
    issue_qk(0);
    if (SHIFT == ShiftMode::kKeyMax) {
      // The pre-pass's kmax, folded by the producer's second warp.
      mbar_wait(bound_bar, 0);
      const float kms = __fmul_rn(*kmax_smem, fabsf(scale));
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = __fmul_rn(qn[r], kms);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);  // o is 0: no rescale
    pack();
    for (int t = 1; t < n_kv; ++t) {
      mbar_wait(full_bar(t), (t / kStages) & 1);
      wgmma_fence();
      issue_qk(t);
      issue_pv(t - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(t - 1);
      if (!kFixed) {
        // The zero columns past D (D72, D80, D96, D112) stay 0 and are
        // not stored: no rescale.
#pragma unroll
        for (int j = 0; j < C::kD / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            o[4 * j + 2 * r] *= alpha[r];
            o[4 * j + 2 * r + 1] *= alpha[r];
          }
        }
      }
      pack();
    }
    wgmma_fence();
    issue_pv(n_kv - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(n_kv - 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int R = q0 + row0 + 8 * r;
    if (R >= Q) continue;  // the q tail: TMA's zero rows
    if (SHIFT != ShiftMode::kRows && SHIFT != ShiftMode::kZero &&
        lse != nullptr && c == 0) {
      // Dead first: a CTA that walked no tile keeps m = -inf and l = 0.
      // kKeyMax: m is the bound in nats.  kExact: m is the row max in log2
      // units, taken to nats with a split ln 2 (one product misses by up to
      // 2e-6 nats at m near 60).
      float v = kDeadLse;
      if (l[r] > 0.f) {
        if (SHIFT == ShiftMode::kKeyMax) {
          v = m[r] + logf(fmaxf(l[r], 1e-30f));
        } else {
          v = fmaf(m[r], kLn2, m[r] * kLn2Lo) + logf(l[r]);
        }
      }
      lse[((long long)b * Hq + h + head) * Q + R] = v;
    }
    float inv;
    if (FLOOR) {
      inv = 1.f / fmaxf(l[r], 1e-30f);
    } else {
      inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    bf16* orow =
        out + (((long long)b * Q + R) * Hq + h + head) * C::kD + 2 * c;
#pragma unroll
    for (int j = 0; j < C::kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime's entry point
// query (the library is not linked against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (B, rows, heads, D) bf16 tensor with dense heads, row stride `rs` and
// batch stride `bs` elements, in boxes of 64 columns x `box_rows` rows,
// 128-byte swizzle, zero fill past `rows` and past D columns (the second
// box of a row at D = 96).  TMA wants a 16-byte aligned
// base and strides that are multiples of 16 bytes: a q, k or v view into
// the ViT's (B, S, 3 H D) qkv tensor has them (row stride 6 KB, k's base
// 2 KB into each row).
inline bool encode_map(CUtensorMap* map, const void* ptr, int rows,
                       int heads, int batch, long long rs, long long bs,
                       int D, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(rs) * 2, cuuint64_t(D) * 2,
                                 cuuint64_t(bs) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

namespace {
// Raise Kernel's dynamic shared memory cap to `bytes` once per device.  The
// flags have internal linkage, so each library loaded into a process (the
// A/B tools load several builds) keeps its own: a static of an inline or
// template function of external linkage is one object shared by all of
// them, and a second library would skip raising the cap of its own kernel.
template <auto Kernel>
cudaError_t open_smem(int bytes) {
  static bool opened[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && opened[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) opened[dev] = true;
  return err;
}
}  // namespace

// Launch with programmatic stream serialization: the grid may start once
// the previous kernel on the stream has executed launch_dependents in every
// CTA (or exited), and waits for it with griddepcontrol.wait.  Only the
// fused entries use it, on a kernel that follows its own pre-pass (or, in
// K2r's pre-pass, on the scan that follows the partial pass); args are
// pointers to the kernel's parameters.
inline cudaError_t launch_dependent(const void* kernel, dim3 grid, dim3 block,
                                    size_t smem, cudaStream_t stream,
                                    void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// bound: kcum (B, Hkv, K) fp32 under kRows, kmax's partial maxima (B,
// nparts, Hkv) fp32 under kKeyMax (nparts = 1: kmax (B, Hkv)), unread under
// kExact; q_offset read only when CAUSAL; lse: a (B, Hq, Q) fp32 output or
// null, taken under kKeyMax and kExact.  dependent: launch with
// programmatic stream serialization, behind the pre-pass that writes
// bound (the ops only, under kKeyMax or kRows).  A Config of HP heads a
// CTA takes Hq = Hkv, a multiple of HP; kZero and the Variants write no
// lse.  Returns a cudaError_t.
template <class C, bool CAUSAL, ShiftMode SHIFT, bool FLOOR = false,
          Variant VAR = Variant::kPlain>
int launch_attention(const void* q, const void* k, const void* v,
                     const void* mask, const void* bound, int nparts,
                     const void* q_offset, void* out, void* lse, int B, int Q,
                     int K, int Hq, int Hkv, long long qsb, long long qss,
                     long long ksb, long long kss, long long vsb,
                     long long vss, float scale, void* stream,
                     bool dependent = false) {
  if (lse != nullptr && SHIFT == ShiftMode::kRows) {
    return int(cudaErrorInvalidValue);
  }
  if ((lse != nullptr &&
       (SHIFT == ShiftMode::kZero || VAR != Variant::kPlain)) ||
      Hq % C::kHeads != 0 || (C::kHeads > 1 && Hq != Hkv)) {
    return int(cudaErrorInvalidValue);
  }
  // Only a bound (kmax's partials, or kcum) comes from a pre-pass to wait
  // for.
  if (nparts < 1 || (dependent && SHIFT != ShiftMode::kKeyMax &&
                     SHIFT != ShiftMode::kRows)) {
    return int(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, Q, Hq, B, qss, qsb, C::kD, C::kBlockQ) ||
      !encode_map(&tk, k, K, Hkv, B, kss, ksb, C::kD, C::kBlockK) ||
      !encode_map(&tv, v, K, Hkv, B, vss, vsb, C::kD, C::kBlockK)) {
    return int(cudaErrorInvalidValue);
  }
  auto kernel = attention_kernel<C, CAUSAL, SHIFT, FLOOR, VAR>;
  cudaError_t err = open_smem<attention_kernel<C, CAUSAL, SHIFT, FLOOR, VAR>>(
      int(C::kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(Hq / C::kHeads * B, (Q + C::kBlockQ - 1) / C::kBlockQ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mask_i = static_cast<const int*>(mask);
  const float* bound_f = static_cast<const float*>(bound);
  const int* off_i = static_cast<const int*>(q_offset);
  bf16* out_b = static_cast<bf16*>(out);
  float* lse_f = static_cast<float*>(lse);
  if (dependent) {
    void* args[] = {&tq,    &tk,    &tv,    &mask_i, &bound_f, &nparts,
                    &off_i, &out_b, &lse_f, &Q,      &K,       &Hq,
                    &Hkv,   &scale};
    err = launch_dependent(reinterpret_cast<const void*>(kernel), grid,
                           dim3(C::kThreads), C::kSmemBytes, s, args);
    if (err != cudaSuccess) return int(err);
  } else {
    kernel<<<grid, C::kThreads, C::kSmemBytes, s>>>(
        tq, tk, tv, mask_i, bound_f, nparts, off_i, out_b, lse_f, Q, K, Hq,
        Hkv, scale);
  }
  return int(cudaGetLastError());
}

}  // namespace attention_sm90
}  // namespace mjv
