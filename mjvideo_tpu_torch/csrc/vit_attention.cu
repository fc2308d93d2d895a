// K1: ViT attention on Hopper.  Replaces _fwd_nc_kernel
// (mjvideo_tpu/ops/flash_attention.py:99) with norm_bound=True: non-causal,
// maskless MHA over one tile's S tokens (S = 1025 on the 448 px path, taken
// as it is; the kernel masks its own tail instead of the TPU's 1032 pre-pad
// and analytic pad-mass subtraction), denominator floored at 1e-30.
// Design and bounds: see bound_attention.cuh.
//
// A non-null lse selects the instantiation that also writes the (B, H, S)
// fp32 true lse (the differentiable path, _fwd_nc_kernel with with_lse,
// flash_attention.py:153-156) that K4 nc (vit_attention_bwd.cu) reads.  On
// a row whose sum underflowed to 0 it writes kDeadLse (1e30), where the TPU
// kernel writes m + log(1e-30); both give p = 0 in the backward.  Serving
// and the frozen ViT of training pass null and run the instantiation
// without it.
#include "bound_attention.cuh"

extern "C" int mjv_vit_attention(const void* q, const void* k, const void* v,
                                 const void* kmax, void* out, void* lse,
                                 int B, int S, int H, int D, long long qsb,
                                 long long qss, long long ksb, long long kss,
                                 long long vsb, long long vss, float scale,
                                 void* stream) {
  if (D != 64) return int(cudaErrorInvalidValue);  // InternViT-300M heads
  if (lse == nullptr) {
    return mjv::launch_bound_attention<64, false, true>(
        q, k, v, nullptr, kmax, nullptr, out, B, S, S, H, H, qsb, qss, ksb,
        kss, vsb, vss, scale, stream);
  }
  return mjv::launch_bound_attention<64, false, true, true>(
      q, k, v, nullptr, kmax, nullptr, out, B, S, S, H, H, qsb, qss, ksb, kss,
      vsb, vss, scale, stream, lse);
}
