// K1: ViT attention on Hopper.  Replaces _fwd_nc_kernel
// (mjvideo_tpu/ops/flash_attention.py:99) with norm_bound=True: non-causal,
// maskless MHA over one tile's S tokens (S = 1025 on the 448 px path, taken
// as it is; the kernel masks its own tail instead of the TPU's 1032 pre-pad
// and analytic pad-mass subtraction), denominator floored at 1e-30.
// Design and bounds: see bound_attention.cuh.
#include "bound_attention.cuh"

extern "C" int mjv_vit_attention(const void* q, const void* k, const void* v,
                                 const void* kmax, void* out, int B, int S,
                                 int H, int D, long long qsb, long long qss,
                                 long long ksb, long long kss, long long vsb,
                                 long long vss, float scale, void* stream) {
  if (D != 64) return int(cudaErrorInvalidValue);  // InternViT-300M heads
  return mjv::launch_bound_attention<64, false, true>(
      q, k, v, nullptr, kmax, nullptr, out, B, S, S, H, H, qsb, qss, ksb, kss,
      vsb, vss, scale, stream);
}
