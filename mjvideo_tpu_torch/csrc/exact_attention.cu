// K3 and K3 lse: the exact online-softmax attention forward on Hopper.
// Replaces _fwd_kernel (mjvideo_tpu/ops/flash_attention.py:260, reached
// through _fwd_impl without norm_bound, call :579): the running row max m,
// sum l and accumulator, rescaled by alpha = exp(m_old - m_new) whenever a
// kv tile raises a row's max; a (B, K) key mask; GQA (q head h reads kv
// head h // G); causal with a per-row q_offset (the global position of q
// row 0, null = 0; negative when the keys are a later shard's ring chunk)
// or non-causal; a row that sees no live key gives 0.  The judge's cached
// generation runs it for every prompt prefill into an empty cache and,
// with q_offset = the prefix length, for every suffix continuation over
// the whole cache; all-gather sequence parallelism runs it with Q = T / n
// queries over the T gathered keys at q_offset = rank * T / n.
//
// A non-null lse (K3 lse: _fwd_kernel with with_lse,
// flash_attention.py:526-530, via flash_attention_with_lse :945 and
// _vjp_fwd :868) also gets the (B, Hq, Q) fp32 true lse, m ln 2 + log(l)
// (m the row max in log2 units), or kDeadLse on a row that saw no live key
// (a CTA that a negative offset leaves no key walks no tile and writes
// kDeadLse and 0 for every row).  Ring sequence parallelism merges the
// chunks of every ring step by it, and the backward kernels
// (decoder_attention_bwd.cu) read it.  With the lse or without, both run
// the wgmma/TMA template of decoder_attention_sm90.cuh (Config D128,
// ShiftMode::kExact), the lse as its epilogue, so K3 lse's output is
// bit-equal to K3's: design and bounds there.  Both also take Phi-3's
// head dim (Config D96): K3 for the InternVL2-4B judge's prefill, prefix
// and continuation, K3 lse for MJ-VIDEO-4B's ring training and scoring.
// K3 alone, not causal and without the lse, takes the EVA2-CLIP-E tower's
// head dim of 112 (Config D112, the CogVLM2-Video judge): that tower is
// post-norm (cogvlm2.py:346-375), its qkv input the un-normalised residual
// stream, so JAX runs _fwd_nc_kernel in its exact-row-max mode there
// (cogvlm2.py:366-367, flash_attention.py:99), and this is the same
// function: 16 heads of 112 over each frame's 257 tokens.  A causal call
// or one with the lse at 112 returns cudaErrorInvalidValue.
#include "decoder_attention_sm90.cuh"

extern "C" int mjv_exact_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* q_offset, void* out, void* lse, int B, int Q, int K, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale, int causal,
    void* stream) {
  namespace sm90 = mjv::attention_sm90;
  using sm90::D112;
  using sm90::D128;
  using sm90::D96;
  using sm90::ShiftMode;
  if (D == 112) {  // the EVA2-CLIP-E tower's heads: non-causal only
    if (causal || lse != nullptr) return int(cudaErrorInvalidValue);
    return sm90::launch_attention<D112, false, ShiftMode::kExact>(
        q, k, v, mask, nullptr, 1, nullptr, out, nullptr, B, Q, K, Hq, Hkv,
        qsb, qss, ksb, kss, vsb, vss, scale, stream);
  }
  if (D == 96) {  // Phi-3's heads
    return causal ? sm90::launch_attention<D96, true, ShiftMode::kExact>(
                        q, k, v, mask, nullptr, 1, q_offset, out, lse, B, Q,
                        K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale,
                        stream)
                  : sm90::launch_attention<D96, false, ShiftMode::kExact>(
                        q, k, v, mask, nullptr, 1, nullptr, out, lse, B, Q,
                        K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale,
                        stream);
  }
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  return causal ? sm90::launch_attention<D128, true, ShiftMode::kExact>(
                      q, k, v, mask, nullptr, 1, q_offset, out, lse, B, Q, K,
                      Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale, stream)
                : sm90::launch_attention<D128, false, ShiftMode::kExact>(
                      q, k, v, mask, nullptr, 1, nullptr, out, lse, B, Q, K,
                      Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale, stream);
}
