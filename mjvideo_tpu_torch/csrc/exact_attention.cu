// K3: the exact online-softmax attention forward on Hopper.  Replaces
// _fwd_kernel (mjvideo_tpu/ops/flash_attention.py:260, reached through
// _fwd_impl without norm_bound, call :579): the running row max m, sum l and
// accumulator, rescaled by alpha = exp(m_old - m_new) whenever a kv tile
// raises a row's max; a (B, K) key mask; GQA (q head h reads kv head
// h // G); causal with a per-row q_offset (the global position of q row 0,
// null = 0; negative when the keys are a later shard's ring chunk) or
// non-causal; a row that sees no live key gives 0.  The judge's cached
// generation runs it for every prompt prefill into an empty cache and,
// with q_offset = the prefix length, for every suffix continuation over
// the whole cache; all-gather sequence parallelism runs it with Q = T / n
// queries over the T gathered keys at q_offset = rank * T / n.  A null lse
// (every caller above) runs the wgmma/TMA template of
// decoder_attention_sm90.cuh: design and bounds there.
//
// A non-null lse (K3 lse: _fwd_kernel with with_lse,
// flash_attention.py:526-530) runs the WMMA template of bound_attention.cuh,
// which also writes the (B, Hq, Q) fp32 true lse, m + log(l), or kDeadLse
// on a row that saw no live key.  Ring
// sequence parallelism merges the chunks of every ring step by it, and the
// backward kernels (decoder_attention_bwd.cu) read it.  Masked scores there
// are the finite -1e30, as in _fwd_kernel: with a negative q_offset a q
// tile whose last row still sees no key walks no kv tile (n_kv <= 0) or,
// when its last row's position lies in (-64, 0), one tile in which every
// key is masked; either way every row keeps m = kNegInf and the dead-row
// rule gives 0 and kDeadLse.
#include "bound_attention.cuh"
#include "decoder_attention_sm90.cuh"

namespace {

template <bool CAUSAL>
int launch_exact_lse(const void* q, const void* k, const void* v,
                     const void* mask, const void* q_offset, void* out,
                     void* lse, int B, int Q, int K, int Hq, int Hkv,
                     long long qsb, long long qss, long long ksb,
                     long long kss, long long vsb, long long vss, float scale,
                     void* stream) {
  return mjv::launch_bound_attention<128, CAUSAL>(
      q, k, v, mask, CAUSAL ? q_offset : nullptr, out, lse, B, Q, K, Hq, Hkv,
      qsb, qss, ksb, kss, vsb, vss, scale, stream);
}

}  // namespace

extern "C" int mjv_exact_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* q_offset, void* out, void* lse, int B, int Q, int K, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale, int causal,
    void* stream) {
  if (D != 128) return int(cudaErrorInvalidValue);  // InternLM2-1.8B heads
  if (lse != nullptr) {
    return causal ? launch_exact_lse<true>(q, k, v, mask, q_offset, out, lse,
                                           B, Q, K, Hq, Hkv, qsb, qss, ksb,
                                           kss, vsb, vss, scale, stream)
                  : launch_exact_lse<false>(q, k, v, mask, q_offset, out, lse,
                                            B, Q, K, Hq, Hkv, qsb, qss, ksb,
                                            kss, vsb, vss, scale, stream);
  }
  namespace sm90 = mjv::attention_sm90;
  using sm90::D128;
  using sm90::ShiftMode;
  return causal ? sm90::launch_attention<D128, true, ShiftMode::kExact>(
                      q, k, v, mask, nullptr, q_offset, out, nullptr, B, Q, K,
                      Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale, stream)
                : sm90::launch_attention<D128, false, ShiftMode::kExact>(
                      q, k, v, mask, nullptr, nullptr, out, nullptr, B, Q, K,
                      Hq, Hkv, qsb, qss, ksb, kss, vsb, vss, scale, stream);
}
