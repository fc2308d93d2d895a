// K3: the exact online-softmax attention forward on Hopper.  Replaces
// _fwd_kernel (mjvideo_tpu/ops/flash_attention.py:260, reached through
// _fwd_impl without norm_bound, call :579): the running row max m, sum l and
// accumulator, rescaled by alpha = exp(m_old - m_new) whenever a kv tile
// raises a row's max; a (B, K) key mask; GQA (q head h reads kv head
// h // G); causal with a per-row q_offset (the global position of q row 0,
// null = 0) or non-causal; masked scores at the finite -1e30, so a row that
// sees no live key gives 0.  The judge's cached generation runs it for every
// prompt prefill into an empty cache and, with q_offset = the prefix
// length, for every suffix continuation over the whole cache.  Design,
// bounds and the rescale: see bound_attention.cuh (Shift::kExact).
#include "bound_attention.cuh"

extern "C" int mjv_exact_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* q_offset, void* out, int B, int Q, int K, int Hq, int Hkv,
    int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int causal, void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  if (causal) {
    return mjv::launch_bound_attention<128, true, false, false,
                                       mjv::Shift::kExact>(
        q, k, v, mask, nullptr, q_offset, out, B, Q, K, Hq, Hkv, qsb, qss,
        ksb, kss, vsb, vss, scale, stream);
  }
  return mjv::launch_bound_attention<128, false, false, false,
                                     mjv::Shift::kExact>(
      q, k, v, mask, nullptr, nullptr, out, B, Q, K, Hq, Hkv, qsb, qss, ksb,
      kss, vsb, vss, scale, stream);
}
