// Helpers of the first (WMMA) templates for Hopper (sm_90a), kept for the
// one source that still builds on them: the ViT attention A/B variants
// B1-B3 (vit_attention_variants.cu), which stage their own tiles.  Every
// attention forward (K1, K2, K3, K2r and their lse forms) runs on
// decoder_attention_sm90.cuh, every backward (K4 nc, K4a, K4b) on
// attention_bwd_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mjv {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Butterfly reductions: every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

}  // namespace mjv
