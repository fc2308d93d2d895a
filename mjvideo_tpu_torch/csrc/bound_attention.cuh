// Helpers of the first (WMMA) templates for Hopper (sm_90a): the shared
// tile sizes, a synchronous staging loop and warp reductions.  Two sources
// still build on them: the decoder attention backward K4a/K4b
// (attention_bwd.cuh, via decoder_attention_bwd.cu) and the ViT attention
// A/B variants B1-B3 (vit_attention_variants.cu).  Every attention forward
// (K1, K2, K3, K2r and their lse forms) runs on decoder_attention_sm90.cuh.
//
// Each tile is staged through shared memory with 16-byte loads, rows padded
// by 16 bytes (kLdP, and the users' own row pads) so that WMMA fragment
// loads and the exp pass do not collide on banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mjv {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBlockQ = 64;   // q rows per CTA
constexpr int kBlockK = 64;   // keys per kv tile
constexpr int kWarps = 4;     // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kBlockK + 8;  // bf16 p rows, padded
constexpr float kDeadLse = 1e30f;  // DEAD_LSE of flash_attention.py

// Copy rows [r0, r0 + ROWS) of a (rows_total, D) slab with row stride
// `stride` (elements) into a (ROWS, D) shared tile with row stride LD; rows
// past `rows_total` are zero-filled so that p = 0 never meets a NaN.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int r0,
                                           int rows_total) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_total) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

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
