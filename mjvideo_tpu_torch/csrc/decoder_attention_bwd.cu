// K4a and K4b: the decoder attention backward on Hopper.  Replaces the two
// Pallas kernels of _bwd_impl (mjvideo_tpu/ops/flash_attention.py:708) in
// their GQA form at D = 128 (InternLM2-1.8B) and at D = 96 (Phi-3, 32/32
// heads: MJ-VIDEO-4B's reward gradient and training):
//   K4a _bwd_dkdv_kernel (:603, call :769): dK, dV for one kv block
//   K4b _bwd_dq_kernel   (:656, call :812): dQ for one q block
// from the true lse that K2 lse or K3 lse wrote (decoder_attention.cu and
// exact_attention.cu), or that the ring's merge computed, under the (B, K)
// key mask and, when causal, the causal mask at the per-batch q_offset
// (negative for a later shard's ring chunk: K4a then starts each key block
// at the first q tile that can see it, or at none, and K4b walks no kv
// tile for a q block that sees no key; positive for an earlier chunk and
// for the all-gather shard's Q rows against all K keys).  The ring's
// non-causal form passes causal = 0.  q, k and v may be strided views
// (16-byte aligned bases and row and batch strides: TMA's rule; the
// sequence shards of SequenceGroup.split are); dout, lse and delta are
// dense.  Both run on the wgmma/TMA backward template; design and bounds:
// see attention_bwd_sm90.cuh.
#include "attention_bwd_sm90.cuh"

namespace bwd = mjv::attention_bwd_sm90;

extern "C" int mjv_decoder_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask,
    const void* q_offset, void* dk, void* dv, int B, int Q, int K, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long dsb,
    long long dss, float scale, int causal, void* stream) {
  if (D == 96) {  // Phi-3's heads
    return causal ? bwd::launch_dkdv<bwd::DkdvD96, true>(
                        q, k, v, dout, lse, delta, mask, q_offset, dk, dv, B,
                        Q, K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, dsb, dss,
                        scale, stream)
                  : bwd::launch_dkdv<bwd::DkdvD96, false>(
                        q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B,
                        Q, K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, dsb, dss,
                        scale, stream);
  }
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  if (causal) {
    return bwd::launch_dkdv<bwd::DkdvD128, true>(
        q, k, v, dout, lse, delta, mask, q_offset, dk, dv, B, Q, K, Hq, Hkv,
        qsb, qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
  }
  return bwd::launch_dkdv<bwd::DkdvD128, false>(
      q, k, v, dout, lse, delta, mask, nullptr, dk, dv, B, Q, K, Hq, Hkv,
      qsb, qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
}

extern "C" int mjv_decoder_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask,
    const void* q_offset, void* dq, int B, int Q, int K, int Hq, int Hkv,
    int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss, float scale,
    int causal, void* stream) {
  if (D == 96) {  // Phi-3's heads
    return causal ? bwd::launch_dq<bwd::DqD96, true>(
                        q, k, v, dout, lse, delta, mask, q_offset, dq, B, Q,
                        K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, dsb, dss,
                        scale, stream)
                  : bwd::launch_dq<bwd::DqD96, false>(
                        q, k, v, dout, lse, delta, mask, nullptr, dq, B, Q,
                        K, Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, dsb, dss,
                        scale, stream);
  }
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  if (causal) {
    return bwd::launch_dq<bwd::DqD128, true>(
        q, k, v, dout, lse, delta, mask, q_offset, dq, B, Q, K, Hq, Hkv, qsb,
        qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
  }
  return bwd::launch_dq<bwd::DqD128, false>(
      q, k, v, dout, lse, delta, mask, nullptr, dq, B, Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
}
