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
// kv_valid (S for B1 and B2) are never read and get p = 0, the same
// function.
//
// What bounds it on this card: at (8, 1025, 16, 64) bf16 the two products
// are 34.4 GFLOP against 50.4 MB of q/k/v in and 16.8 MB out, so the work
// is compute-bound (0.0348 ms at 989 TFLOP/s, 0.0201 ms at 3.35 TB/s).
//
// All three run the wgmma/TMA forward template of
// decoder_attention_sm90.cuh, K1's (design there), each walking the keys
// once: B2 is K3's online softmax (ShiftMode::kExact) at D = 64 with hp
// heads a CTA (a Config per hp below); B3 is B2 at hp 1 with K = kv_valid
// keys (its k/v tensor maps end there: TMA zero-fills the last tile, and
// the template's liveness bits, j < K, give those keys p = 0), so on the
// rows below kv_valid it is B2 hp 1 on q, k, v cut at kv_valid, to the bit;
// B1's modes are the template's policies: exp2 = kExact with q folded in
// shared memory (Variant::kFoldQ), exp2_nomax = kZero with the fold, nomax
// = kZero, bf16s = kExact at the twin's bf16 rounding points
// (Variant::kBf16s).  Under a max each p is
// taken against the running max and rescaled, where the twin takes it
// against the final max: they differ in fp32 rounding, and in bf16s where
// an earlier max rounds d or p to another bf16.  A launch that fails
// returns its error; nothing falls back.
#include "decoder_attention_sm90.cuh"

namespace {

namespace sm90 = mjv::attention_sm90;
using sm90::ShiftMode;
using sm90::Variant;

constexpr int kD = 64;  // InternViT-300M's head dim

// The Configs (consumer warpgroups, stages, heads a CTA, keys a tile),
// chosen by A/B on the card (tools/vit_attn_variants_torch.py --configs,
// PERF.md).  B1: K1's, the fastest for every mode.  B2: one key tile for
// every hp, so that each row walks the same tiles and every hp gives the
// same bits; hp 4's four warpgroups have registers for 64-key tiles only
// (Regs<4>), so 64 for all, the fastest warpgroups and stages of each hp
// at that tile (hp 1 at 128 keys, K1's grid, measured 5% faster).  B3:
// B2's hp 1, so that it walks B2's tiles and keeps its bits.
using VariantConfig = sm90::D64;
using Hp1 = sm90::Config<64, 3, 3, 1, 64>;
using Hp2 = sm90::Config<64, 4, 4, 2, 64>;
using Hp4 = sm90::Config<64, 4, 3, 4, 64>;

// S q rows over the first K keys (K = S for B1 and B2, kv_valid for B3);
// scale as the template's (kFoldQ: the fold).
template <class C, ShiftMode SHIFT, Variant VAR = Variant::kPlain>
int launch_sm90(const void* q, const void* k, const void* v, void* out,
                int B, int S, int K, int H, long long qsb, long long qss,
                long long ksb, long long kss, long long vsb, long long vss,
                float scale, void* stream) {
  return sm90::launch_attention<C, false, SHIFT, false, VAR>(
      q, k, v, nullptr, nullptr, 1, nullptr, out, nullptr, B, S, K, H, H, qsb,
      qss, ksb, kss, vsb, vss, scale, stream);
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
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    case 1:
      return launch_sm90<VariantConfig, ShiftMode::kExact, Variant::kBf16s>(
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    case 2:
      return launch_sm90<VariantConfig, ShiftMode::kZero>(
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    case 3:
      return launch_sm90<VariantConfig, ShiftMode::kZero, Variant::kFoldQ>(
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
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
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    case 2:
      return launch_sm90<Hp2, ShiftMode::kExact>(
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    case 4:
      return launch_sm90<Hp4, ShiftMode::kExact>(
          q, k, v, out, B, S, S, H, qsb, qss, ksb, kss, vsb, vss, scale,
          stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// B3 over the keys below kv_valid (1 <= kv_valid <= S): B2's hp 1 with
// K = kv_valid; k and v are never read at or past it.
extern "C" int mjv_vit_attention_bshd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int kv_valid, void* stream) {
  if (D != kD || kv_valid < 1 || kv_valid > S) {
    return int(cudaErrorInvalidValue);
  }
  return launch_sm90<Hp1, ShiftMode::kExact>(q, k, v, out, B, S, kv_valid, H,
                                             qsb, qss, ksb, kss, vsb, vss,
                                             scale, stream);
}
