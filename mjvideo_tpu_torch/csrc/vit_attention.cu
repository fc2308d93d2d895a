// K1 and K1 lse: ViT attention on Hopper.  Replaces _fwd_nc_kernel
// (mjvideo_tpu/ops/flash_attention.py:99) with norm_bound=True: non-causal,
// maskless MHA over one tile's S tokens (S = 1025 on the 448 px path, taken
// as it is; the kernel masks its own tail instead of the TPU's 1032 pre-pad
// and analytic pad-mass subtraction), denominator floored at 1e-30.  K1
// also serves the Qwen2-VL vision tower (mjvideo_tpu/models/qwen2vl.py:369:
// 16 heads of 80 over one temporal slab's h w patches, e.g. (4, 676) for 8
// frames at 364 px) at Config D80, D128's layout with columns 80-127 TMA's
// zero fill; and the SigLIP-so400m towers of VideoScore and MiniCPM-V
// (mjvideo_tpu/models/videoscore.py:356-384: 16 heads of 72 over one
// frame's patches, e.g. (16, 2730) for a 16-frame 1280 x 720 clip) at
// Config D72, the same layout with columns 72-127 the zero fill and q k^T
// over 5 k-steps; and the InternViT-6B tower of the InternVL2-26B judge
// (mjvideo_tpu/models/vit.py:180-183: 25 heads of 128 over one tile's 1025
// tokens, q and k dense 3200-element rows after QK-RMSNorm, v a view into
// qkv with 9600-element rows) at Config D128, K2's Config, not causal and
// floored (two full 64-column boxes, no zero fill); K1 lse stays at D = 64
// (the judges need no gradient).
// Its kmax (B, H), the largest key norm of each (b, head), comes from the
// pre-pass of decoder_attention.cu, where the TPU kernel reduced it inside
// each program (flash_attention.py:131-135).
//
// Both run the wgmma/TMA template of decoder_attention_sm90.cuh at D = 64
// (Config D64, ShiftMode::kKeyMax, FLOOR): q/k/v are strided views into one
// (B, S, 3 H D) qkv tensor, which the tensor maps take as they are.  What
// bounds it and the design: see that header.  At (8, 1025, 16, 64) the two
// products are 34 GFLOP (0.035 ms at 989 TFLOP/s), at the 6B's (8, 1025,
// 25, 128) 108 GFLOP (0.109 ms); the softmax's one exp2
// per score on the special-function unit weighs twice as much against the
// products as at D = 128, so the D = 64 Config (q rows per CTA, stages, the
// register split) was chosen by A/B on the card.
//
// A null lse: serving, the frozen ViT of training, the judge's video
// encode.  A non-null lse (K1 lse, the differentiable path: _fwd_nc_kernel
// with with_lse, flash_attention.py:153-156) also gets the (B, H, S) fp32
// true lse that K4 nc (vit_attention_bwd.cu) reads.  On a row whose sum
// underflowed to 0 it holds kDeadLse (1e30), where the TPU kernel writes
// m + log(1e-30); both give p = 0 in the backward.
//
// mjv_vit_attention_op is the op: the pre-pass's partial pass, then K1
// launched behind it as a programmatic dependent that folds the partials;
// mjv_vit_attention is K1 alone on a folded kmax (the checks).
#include "decoder_attention_sm90.cuh"

namespace sm90 = mjv::attention_sm90;

// decoder_attention.cu: the pre-pass's partial maxima (B, nparts, Hkv).
int launch_key_norm_partials(const void* k, const void* mask, void* part,
                             int B, int K, int Hkv, int D, long long ksb,
                             long long kss, int nparts, cudaStream_t s);

extern "C" int mjv_vit_attention(const void* q, const void* k, const void* v,
                                 const void* kmax, void* out, void* lse,
                                 int B, int S, int H, int D, long long qsb,
                                 long long qss, long long ksb, long long kss,
                                 long long vsb, long long vss, float scale,
                                 void* stream) {
  if (D == 128 && lse == nullptr) {  // InternViT-6B's heads
    return sm90::launch_attention<sm90::D128, false,
                                  sm90::ShiftMode::kKeyMax, true>(
        q, k, v, nullptr, kmax, 1, nullptr, out, nullptr, B, S, S, H, H, qsb,
        qss, ksb, kss, vsb, vss, scale, stream);
  }
  if (D == 72 && lse == nullptr) {  // SigLIP-so400m's heads
    return sm90::launch_attention<sm90::D72, false, sm90::ShiftMode::kKeyMax,
                                  true>(q, k, v, nullptr, kmax, 1, nullptr,
                                        out, nullptr, B, S, S, H, H, qsb, qss,
                                        ksb, kss, vsb, vss, scale, stream);
  }
  if (D == 80 && lse == nullptr) {  // the Qwen2-VL vision tower's heads
    return sm90::launch_attention<sm90::D80, false, sm90::ShiftMode::kKeyMax,
                                  true>(q, k, v, nullptr, kmax, 1, nullptr,
                                        out, nullptr, B, S, S, H, H, qsb, qss,
                                        ksb, kss, vsb, vss, scale, stream);
  }
  if (D != 64) return int(cudaErrorInvalidValue);  // InternViT-300M heads
  return sm90::launch_attention<sm90::D64, false, sm90::ShiftMode::kKeyMax,
                                true>(q, k, v, nullptr, kmax, 1, nullptr, out,
                                      lse, B, S, S, H, H, qsb, qss, ksb, kss,
                                      vsb, vss, scale, stream);
}

// The K1 op (with the lse when lse is not null): part (B, nparts, H) fp32
// scratch for the pre-pass's partials.
extern "C" int mjv_vit_attention_op(const void* q, const void* k,
                                    const void* v, void* part, void* out,
                                    void* lse, int B, int S, int H, int D,
                                    long long qsb, long long qss,
                                    long long ksb, long long kss,
                                    long long vsb, long long vss, int nparts,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && lse == nullptr) {  // InternViT-6B's heads
    const int err = launch_key_norm_partials(k, nullptr, part, B, S, H, D,
                                             ksb, kss, nparts, s);
    if (err != 0) return err;
    return sm90::launch_attention<sm90::D128, false,
                                  sm90::ShiftMode::kKeyMax, true>(
        q, k, v, nullptr, part, nparts, nullptr, out, nullptr, B, S, S, H, H,
        qsb, qss, ksb, kss, vsb, vss, scale, stream, true);
  }
  if (D == 72 && lse == nullptr) {  // SigLIP-so400m's heads
    const int err = launch_key_norm_partials(k, nullptr, part, B, S, H, D,
                                             ksb, kss, nparts, s);
    if (err != 0) return err;
    return sm90::launch_attention<sm90::D72, false, sm90::ShiftMode::kKeyMax,
                                  true>(q, k, v, nullptr, part, nparts,
                                        nullptr, out, nullptr, B, S, S, H, H,
                                        qsb, qss, ksb, kss, vsb, vss, scale,
                                        stream, true);
  }
  // InternViT-300M's heads of 64, or the Qwen2-VL tower's 80 without the lse.
  if (D != 64 && (D != 80 || lse != nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  const int err = launch_key_norm_partials(k, nullptr, part, B, S, H, D, ksb,
                                           kss, nparts, s);
  if (err != 0) return err;
  if (D == 80) {
    return sm90::launch_attention<sm90::D80, false, sm90::ShiftMode::kKeyMax,
                                  true>(q, k, v, nullptr, part, nparts,
                                        nullptr, out, nullptr, B, S, S, H, H,
                                        qsb, qss, ksb, kss, vsb, vss, scale,
                                        stream, true);
  }
  return sm90::launch_attention<sm90::D64, false, sm90::ShiftMode::kKeyMax,
                                true>(q, k, v, nullptr, part, nparts, nullptr,
                                      out, lse, B, S, S, H, H, qsb, qss, ksb,
                                      kss, vsb, vss, scale, stream, true);
}
