// K4a and K4b: the decoder attention backward on Hopper.  Replaces the two
// Pallas kernels of _bwd_impl (mjvideo_tpu/ops/flash_attention.py:708) in
// their causal GQA form at D = 128:
//   K4a _bwd_dkdv_kernel (:603, call :769): dK, dV for one kv block
//   K4b _bwd_dq_kernel   (:656, call :812): dQ for one q block
// from the true lse that K2 wrote (decoder_attention.cu, WITH_LSE), under
// the causal mask, the (B, K) key mask and the per-row q_offset.  Design
// and bounds: see attention_bwd.cuh.
#include "attention_bwd.cuh"

extern "C" int mjv_decoder_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask,
    const void* q_offset, void* dk, void* dv, int B, int Q, int K, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, long long dsb,
    long long dss, float scale, void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  return mjv::launch_bwd_dkdv<128, true>(
      q, k, v, dout, lse, delta, mask, q_offset, dk, dv, B, Q, K, Hq, Hkv,
      qsb, qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
}

extern "C" int mjv_decoder_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* mask,
    const void* q_offset, void* dq, int B, int Q, int K, int Hq, int Hkv,
    int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss, float scale,
    void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);
  return mjv::launch_bwd_dq<128, true>(
      q, k, v, dout, lse, delta, mask, q_offset, dq, B, Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
}
