// K4 nc: the ViT attention backward on Hopper.  Replaces the two Pallas
// kernels of _bwd_impl (mjvideo_tpu/ops/flash_attention.py:708) as the
// ViT's custom VJP reaches them (_vjp_bwd :874): causal=False, no mask, no
// q_offset, one kv head per q head, D = 64 (InternViT-300M):
//   mjv_vit_attention_bwd_dkdv <- _bwd_dkdv_kernel (:603, call :769)
//   mjv_vit_attention_bwd_dq   <- _bwd_dq_kernel   (:656, call :812)
// from the true lse that K1 wrote (vit_attention.cu with a non-null lse).
// q, k and v are strided views into the ViT's one (B, S, 3 H D) qkv tensor
// (token strides qss = kss = vss = 3 H D); dout, lse and delta are dense;
// dq, dk and dv are written dense (B, S, H, D).  S = 1025 is taken as it
// is.  Design and bounds: see attention_bwd_sm90.cuh.
#include "attention_bwd_sm90.cuh"

namespace bwd = mjv::attention_bwd_sm90;

extern "C" int mjv_vit_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss, float scale,
    void* stream) {
  if (D != 64) return int(cudaErrorInvalidValue);  // InternViT-300M heads
  return bwd::launch_dkdv<bwd::DkdvD64, false>(
      q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, B, S, S, H, H, qsb,
      qss, ksb, kss, vsb, vss, dsb, dss, scale, stream);
}

extern "C" int mjv_vit_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int D,
    long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, long long dsb, long long dss, float scale,
    void* stream) {
  if (D != 64) return int(cudaErrorInvalidValue);
  return bwd::launch_dq<bwd::DqD64, false>(
      q, k, v, dout, lse, delta, nullptr, nullptr, dq, B, S, S, H, H, qsb, qss,
      ksb, kss, vsb, vss, dsb, dss, scale, stream);
}
