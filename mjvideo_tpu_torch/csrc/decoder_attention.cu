// K2: decoder attention on Hopper.  Replaces _fwd_bound_kernel
// (mjvideo_tpu/ops/flash_attention.py:318, reached through _fwd_impl with
// norm_bound): causal attention with a (B, K) key mask, GQA (q head h reads
// kv head h // G), a per-row q_offset (null = 0), the bound shift with kmax
// the largest masked key norm, and rows whose sum is 0 giving 0.  kv tiles
// above the diagonal are skipped.  Design and bounds: see
// bound_attention.cuh.
//
// A non-null lse selects the instantiation that also writes the (B, Hq, Q)
// fp32 true lse (the training forward, _fwd_bound_kernel with with_lse,
// flash_attention.py:407-412) that the backward kernels read; serving
// passes null and runs the instantiation without it.
//
// K2r (mjv_decoder_attention_rows) is the same body under the per-row bound
// of _fwd_bound_kernel(row_bound=True) (flash_attention.py:347-358, host
// side :492-508), the opt-in shift of the cached generation paths:
// row_kmax is the (B, Hq, Q) fp32 column of the running max of masked key
// norms over slots <= each row's global position q_offset + i (clipped to
// K - 1), gathered before the launch.
#include "bound_attention.cuh"

extern "C" int mjv_decoder_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kmax, const void* q_offset, void* out, void* lse, int B,
    int Q, int K, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, float scale,
    void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  if (lse == nullptr) {
    return mjv::launch_bound_attention<128, true, false>(
        q, k, v, mask, kmax, q_offset, out, B, Q, K, Hq, Hkv, qsb, qss, ksb,
        kss, vsb, vss, scale, stream);
  }
  return mjv::launch_bound_attention<128, true, false, true>(
      q, k, v, mask, kmax, q_offset, out, B, Q, K, Hq, Hkv, qsb, qss, ksb, kss,
      vsb, vss, scale, stream, lse);
}

extern "C" int mjv_decoder_attention_rows(
    const void* q, const void* k, const void* v, const void* mask,
    const void* row_kmax, const void* q_offset, void* out, int B, int Q,
    int K, int Hq, int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale, void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  return mjv::launch_bound_attention<128, true, false, false,
                                     mjv::Shift::kRowBound>(
      q, k, v, mask, row_kmax, q_offset, out, B, Q, K, Hq, Hkv, qsb, qss, ksb,
      kss, vsb, vss, scale, stream);
}
