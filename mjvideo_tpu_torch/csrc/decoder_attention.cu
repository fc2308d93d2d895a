// K2 and K2 lse: decoder attention on Hopper.  Replaces _fwd_bound_kernel
// (mjvideo_tpu/ops/flash_attention.py:318, reached through _fwd_impl with
// norm_bound, host side :484-511): causal attention with a (B, K) key mask,
// GQA (q head h reads kv head h // G), a per-row q_offset (null = 0), the
// bound shift with kmax the largest masked key norm of each (b, kv head),
// and rows whose sum is 0 giving 0.  Both run the wgmma/TMA template of
// decoder_attention_sm90.cuh (Config D128, ShiftMode::kKeyMax): K2r's
// constant-shift body with one bound per (b, kv head).  K2 and K2 lse also
// take Phi-3's head dim (Config D96, MJ-VIDEO-4B's decoder), its pre-pass
// too, and so do K2r and its pre-pass's per-key norms (the 4B judge's
// MJV_CACHE_NORM_BOUND=1 path).  What bounds it and the design: see that
// header.
//
// A null lse: serving, the judge's scorer-side decoder.  A non-null lse
// (K2 lse, the training forward and the reward gradient: _fwd_bound_kernel
// with with_lse, flash_attention.py:407-412) also gets the (B, Hq, Q) fp32
// true lse, kDeadLse on dead rows, that the backward kernels read.
//
// kmax comes from the pre-pass below, on the card; the TPU path reduced it
// with one XLA reduce outside the kernel (flash_attention.py:484-511).  The
// same pre-pass serves K1 and K1 lse (vit_attention.cu) at D = 64 and K1
// at D = 80 and 72, and, with SigLIP's patch mask, K1m at D = 72 (below).
// The
// op's entries (mjv_decoder_attention_op here, mjv_vit_attention_op in
// vit_attention.cu) make one C call of the pre-pass's partial pass and the
// attention kernel, launched behind it as a programmatic dependent that
// folds the partials itself; mjv_decoder_attention takes a folded kmax
// (the kernel alone, for the checks).
//
// K2r is _fwd_bound_kernel(row_bound=True) (flash_attention.py:347-358,
// host side :484-508), the opt-in shift of the cached generation paths, on
// the same Hopper template (ShiftMode::kRows).  Its bound column kcum is the
// (B, Hkv, K) fp32 running max along K of the masked key norms, which the
// main kernel reads at each row's global position clip(q_offset + i, 0,
// K - 1) for its kv head; on the TPU it was one XLA reduce outside the
// kernel (flash_attention.py:489-497).  Its pre-pass below is the same
// partial pass, which here also stores every key's norm into kcum, then a
// scan that runs the earlier chunks' max forward through each chunk.  The
// op (mjv_decoder_attention_rows_op) is one C call: the partial pass, the
// scan as its programmatic dependent and K2r as the scan's;
// mjv_key_norm_cummax is the pre-pass alone and mjv_decoder_attention_rows
// the kernel alone on a given kcum (the checks).
#include "decoder_attention_sm90.cuh"

namespace sm90 = mjv::attention_sm90;
using sm90::bf16;

// The pre-pass of K1, K1 lse, K2 and K2 lse: kmax (B, Hkv) fp32, the largest
// norm of a live key of each (b, kv head), as nparts partial maxima (B,
// nparts, Hkv), one per chunk of ceil(K / nparts) keys.  One CTA per (chunk,
// b) writes its Hkv slots with plain stores: no memset and no atomics, so
// two launches write the same bits.  D / 8 lanes share one key vector (one
// 16-byte load each); a pass of the CTA loads kPartLoads pieces a thread,
// all issued before any is reduced, covering kVecs vectors (kVecs / Hkv
// whole keys), so a chunk the size of one pass costs one DRAM round trip;
// the plan (kernels.key_norm_parts) sizes the chunks to about four CTAs per
// SM over the grid, at most 256 partials per (b, kv head) (serving's (2,
// 3072): 256 chunks of 12 keys; the 53,722-token clip: 256 chunks of 210
// keys, 27 passes).  By A/B on the card, 4 loads a thread and 256 threads
// read faster than 8 loads or 128 threads, and the plan's chunk counts than
// half or twice as many.  The squares of bf16 values sum exactly in double,
// so a key's norm does not depend on the order of the sum and is rounded
// once, after a double sqrt, to float; the twin (ops/flash_attention.py
// key_norm_max) sums in fp32 in torch's order and lies within about an ulp
// of it.  Each vector's slot keeps the largest sum over the passes in
// registers (a slot's head is the same in every pass), a masked key giving
// nothing, and takes its sqrt once at the end; the slots then fold per head
// through shared memory.  Max is exact, so every order of the folds gives
// the same bits, and since sqrt and the rounding are monotone the result is
// the sqrt of the max of the squares, as in the twin; a chunk with no live
// key writes 0, the twin's bound of a fully masked row.  What bounds it: the
// k read, 12.6 MB at the decoder's (2, 3072) and 16.8 MB at the ViT's (8,
// 1025), 3.8 and 5.0 us over the card at 3.35 TB/s.  NORMS (K2r's pre-pass,
// D = 128 or 96): each key's norm is also stored into norms (B, Hkv, K), 0
// for a masked key, so that kcum's last column is kmax to the bit.  At
// D = 96 (Phi-3) a vector takes 16 lanes, of which the last 4 add nothing,
// and at D = 80 (the Qwen2-VL vision tower) 16 lanes of which the last 6
// add nothing, at D = 72 (SigLIP-so400m: 9 pieces of 16 bytes) 16 lanes of
// which the last 7 add nothing: the butterfly runs over a power of two of
// lanes, whole vectors a warp, and the exact double sum does not see them.
// At D = 72 the pass also runs with SigLIP's patch mask (the masked
// non-causal form below): a padded patch's key gives nothing.
constexpr int kPartThreads = 256;
constexpr int kPartLoads = 4;  // 16-byte loads in flight per thread

// The lanes of one key vector: its 16-byte pieces, rounded up to a power
// of two (D = 72's 9 pieces, D = 80's 10 and D = 96's 12 take 16 lanes).
__host__ __device__ constexpr int key_norm_lanes(int D) {
  return D / 8 <= 8 ? 8 : 16;
}

template <int D, bool NORMS = false>
__global__ void __launch_bounds__(kPartThreads)
key_norm_partial_kernel(const bf16* __restrict__ k,
                        const int* __restrict__ mask,
                        float* __restrict__ part, float* __restrict__ norms,
                        int K, int Hkv, int chunk, long long ksb,
                        long long kss) {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128 || D == 72,
                "head dim 64, 72, 80, 96 or 128");
  constexpr int kPieces = D / 8;  // 16-byte pieces of one key vector
  constexpr int kLanes = key_norm_lanes(D);  // lanes a vector
  constexpr int kSlotStep = kPartThreads / kLanes;  // vectors per load step
  constexpr int kVecs = kSlotStep * kPartLoads;     // vector slots a pass
  __shared__ float slot_max[kVecs];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * chunk;
  const int keys = max(0, min(chunk, K - j0));
  const int per = kVecs / Hkv;  // whole keys a pass
  const int used = per * Hkv;   // slots a pass
  const int piece = threadIdx.x % kLanes;
  // D = 72, 80 and 96: the lanes past the vector's 9, 10 or 12 pieces load
  // its last piece again (in bounds, the same line) and add nothing to its
  // sum; an address predicated on the piece instead spilled.
  constexpr bool kSpare = kPieces < kLanes;
  const bf16* kb = k + b * ksb + (long long)j0 * kss +
                   (kSpare ? min(piece, kPieces - 1) : piece) * 8;
  const int* mb = mask == nullptr ? nullptr : mask + (long long)b * K + j0;
  // The largest live sum of squares of slot u * kSlotStep + threadIdx.x /
  // kLanes; its sqrt is taken once, after the passes.
  double run[kPartLoads];
#pragma unroll
  for (int u = 0; u < kPartLoads; ++u) run[u] = 0.0;
  // The loop bound is uniform over the block, so every lane reaches the
  // shuffles; slots past the chunk load zeros and are not counted.  A
  // vector's kLanes lanes lie in one warp.
  for (int key0 = 0; key0 < keys; key0 += per) {
    uint4 raw[kPartLoads];
#pragma unroll
    for (int u = 0; u < kPartLoads; ++u) {
      const int slot = u * kSlotStep + threadIdx.x / kLanes;
      const int key = key0 + slot / Hkv;
      raw[u] = slot < used && key < keys
                   ? __ldg(reinterpret_cast<const uint4*>(
                         kb + key * kss + (slot % Hkv) * D))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    if (key0 == 0) sm90::grid_launch_dependents();
#pragma unroll
    for (int u = 0; u < kPartLoads; ++u) {
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      double s = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        s += double(f.x) * f.x + double(f.y) * f.y;
      }
      if (kSpare && piece >= kPieces) s = 0.0;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      const int slot = u * kSlotStep + threadIdx.x / kLanes;
      const int key = key0 + slot / Hkv;
      if (slot < used && key < keys && (mb == nullptr || mb[key] != 0)) {
        run[u] = fmax(run[u], s);
      }
      if (NORMS && piece == 0 && slot < used && key < keys) {
        // K2r: the key's own norm, rounded as the chunk's max is, or 0.
        norms[((long long)b * Hkv + slot % Hkv) * K + j0 + key] =
            mb == nullptr || mb[key] != 0 ? __double2float_rn(sqrt(s)) : 0.f;
      }
    }
  }
  if (keys == 0) sm90::grid_launch_dependents();
  if (piece == 0) {
#pragma unroll
    for (int u = 0; u < kPartLoads; ++u) {
      slot_max[u * kSlotStep + threadIdx.x / kLanes] =
          __double2float_rn(sqrt(run[u]));
    }
  }
  __syncthreads();
  float* out = part + ((long long)b * gridDim.x + blockIdx.x) * Hkv;
  for (int h = threadIdx.x; h < Hkv; h += kPartThreads) {
    float m = 0.f;
    for (int slot = h; slot < used; slot += Hkv) m = fmaxf(m, slot_max[slot]);
    out[h] = m;
  }
}

// kmax (B, Hkv) from the partials (B, nparts, Hkv): one warp per (b, kv
// head), max over its nparts floats.  Only the standalone pre-pass
// (mjv_key_norm_max) launches it; the attention kernels fold for themselves.
constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
key_norm_fold_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int nparts, int Hkv, int BH) {
  const int w = blockIdx.x * (kFoldThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= BH) return;  // whole warps
  const float* p = part + (long long)(w / Hkv) * nparts * Hkv + w % Hkv;
  float m = 0.f;
  for (int c = lane; c < nparts; c += 32) m = fmaxf(m, p[(long long)c * Hkv]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (lane == 0) out[w] = m;
}

// The head dims of the decoders' kernels K2, K2 lse and K2r and of K2r's
// per-key norms: InternLM2-1.8B's 128 and Phi-3's 96.  Non-causal, K2's
// masked path also takes SigLIP-so400m's 72 (the masked form below), and
// only that form.
static bool k2_head_dim(int D) { return D == 128 || D == 96; }
static bool k2_head_dim(int D, bool causal) {
  return causal ? k2_head_dim(D) : D == 72;
}

// The partial pass on `stream`: part (B, nparts, Hkv) fp32, 1 <= nparts <=
// K, D = 64, 72, 80, 96 or 128; with norms (B, Hkv, K) fp32 not null
// (D = 128 or 96, the decoders' head dims), K2r's form.
int launch_partials(const void* k, const void* mask, void* part, void* norms,
                    int B, int K, int Hkv, int D, long long ksb,
                    long long kss, int nparts, cudaStream_t s) {
  if ((D != 72 && (D != 64 && D != 80 && D != 96 && D != 128)) ||
      (norms != nullptr && !k2_head_dim(D))) {
    return int(cudaErrorInvalidValue);
  }
  // One pass must hold a whole key: Hkv vectors of key_norm_lanes(D) lanes.
  const int vecs = kPartThreads / key_norm_lanes(D) * kPartLoads;
  if (B < 1 || B > 65535 || K < 1 || Hkv < 1 || Hkv > vecs || nparts < 1 ||
      nparts > K) {
    return int(cudaErrorInvalidValue);
  }
  const int chunk = (K + nparts - 1) / nparts;
  const dim3 grid(nparts, B);
  auto kernel = norms != nullptr
                    ? (D == 96 ? key_norm_partial_kernel<96, true>
                               : key_norm_partial_kernel<128, true>)
                : D == 64 ? key_norm_partial_kernel<64>
                : D == 72 ? key_norm_partial_kernel<72>
                : D == 80 ? key_norm_partial_kernel<80>
                : D == 96 ? key_norm_partial_kernel<96>
                          : key_norm_partial_kernel<128>;
  kernel<<<grid, kPartThreads, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<const int*>(mask),
      static_cast<float*>(part), static_cast<float*>(norms), K, Hkv, chunk,
      ksb, kss);
  return int(cudaGetLastError());
}

// K1's and K2's partial pass.  Also launched by mjv_vit_attention_op
// (vit_attention.cu).
int launch_key_norm_partials(const void* k, const void* mask, void* part,
                             int B, int K, int Hkv, int D, long long ksb,
                             long long kss, int nparts, cudaStream_t s) {
  return launch_partials(k, mask, part, nullptr, B, K, Hkv, D, ksb, kss,
                         nparts, s);
}

// The pre-pass alone: the partials into part (B, nparts, Hkv) scratch, then
// their fold into out (B, Hkv) fp32.
extern "C" int mjv_key_norm_max(const void* k, const void* mask, void* part,
                                void* out, int B, int K, int Hkv, int D,
                                long long ksb, long long kss, int nparts,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_key_norm_partials(k, mask, part, B, K, Hkv, D, ksb,
                                           kss, nparts, s);
  if (err != 0) return err;
  const int BH = B * Hkv;
  const int warps = kFoldThreads / 32;
  key_norm_fold_kernel<<<(BH + warps - 1) / warps, kFoldThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nparts, Hkv,
      BH);
  return int(cudaGetLastError());
}

// K2 alone on a folded kmax (B, Hkv): the kernel-alone form of the op.
extern "C" int mjv_decoder_attention(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kmax, const void* q_offset, void* out, void* lse, int B,
    int Q, int K, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, float scale,
    void* stream) {
  if (!k2_head_dim(D)) return int(cudaErrorInvalidValue);
  if (D == 96) {
    return sm90::launch_attention<sm90::D96, true, sm90::ShiftMode::kKeyMax>(
        q, k, v, mask, kmax, 1, q_offset, out, lse, B, Q, K, Hq, Hkv, qsb,
        qss, ksb, kss, vsb, vss, scale, stream);
  }
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kKeyMax>(
      q, k, v, mask, kmax, 1, q_offset, out, lse, B, Q, K, Hq, Hkv, qsb, qss,
      ksb, kss, vsb, vss, scale, stream);
}

// The K2 op (with the lse when lse is not null): the partial pass into part
// (B, nparts, Hkv) scratch, then K2 launched as its programmatic dependent,
// folding the partials after griddepcontrol.wait.
extern "C" int mjv_decoder_attention_op(
    const void* q, const void* k, const void* v, const void* mask,
    const void* q_offset, void* part, void* out, void* lse, int B, int Q,
    int K, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, int nparts,
    float scale, void* stream) {
  if (!k2_head_dim(D)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_key_norm_partials(k, mask, part, B, K, Hkv, D, ksb,
                                           kss, nparts, s);
  if (err != 0) return err;
  if (D == 96) {
    return sm90::launch_attention<sm90::D96, true, sm90::ShiftMode::kKeyMax>(
        q, k, v, mask, part, nparts, q_offset, out, lse, B, Q, K, Hq, Hkv,
        qsb, qss, ksb, kss, vsb, vss, scale, stream, true);
  }
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kKeyMax>(
      q, k, v, mask, part, nparts, q_offset, out, lse, B, Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, scale, stream, true);
}

// K1m, the masked non-causal form: K2's path (the template's MASKED tiles,
// ShiftMode::kKeyMax with kmax the largest live key norm, no floor: a row
// whose sum is 0 gives 0) with CAUSAL = false, at SigLIP-so400m's D = 72
// (Config D72) and one kv head a q head.  Replaces _fwd_bound_kernel with
// causal=False (mjvideo_tpu/ops/flash_attention.py:318), which _fwd_impl
// takes for a key-masked non-causal call (:439-579): VideoScore's
// variable-aspect tower (mjvideo_tpu/models/videoscore.py:356-384), its
// images padded bottom/right to a common grid with the patch mask as the
// key mask.  kmax comes from the masked partials of the pre-pass above.
// What bounds it: the two products over every (row, key) pair of each
// image (the mask is not skipped: the kernel walks every key tile), 64 GF
// at (20, 2730, 16, 72), 0.065 ms at 989 TFLOP/s.  mjv_vit_attention_masked
// is the kernel alone on a folded kmax (B, H); mjv_vit_attention_masked_op
// the op: the masked partial pass, then the kernel behind it as its
// programmatic dependent, folding the partials.
extern "C" int mjv_vit_attention_masked(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kmax, void* out, int B, int S, int H, int D, long long qsb,
    long long qss, long long ksb, long long kss, long long vsb, long long vss,
    float scale, void* stream) {
  if (!k2_head_dim(D, false) || mask == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  return sm90::launch_attention<sm90::D72, false, sm90::ShiftMode::kKeyMax>(
      q, k, v, mask, kmax, 1, nullptr, out, nullptr, B, S, S, H, H, qsb, qss,
      ksb, kss, vsb, vss, scale, stream);
}

// The K1m op: the masked partial pass into part (B, nparts, H) scratch,
// then K1m launched as its programmatic dependent.
extern "C" int mjv_vit_attention_masked_op(
    const void* q, const void* k, const void* v, const void* mask, void* part,
    void* out, int B, int S, int H, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, int nparts,
    float scale, void* stream) {
  if (!k2_head_dim(D, false) || mask == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_key_norm_partials(k, mask, part, B, S, H, D, ksb,
                                           kss, nparts, s);
  if (err != 0) return err;
  return sm90::launch_attention<sm90::D72, false, sm90::ShiftMode::kKeyMax>(
      q, k, v, mask, part, nparts, nullptr, out, nullptr, B, S, S, H, H, qsb,
      qss, ksb, kss, vsb, vss, scale, stream, true);
}

// K2r's scan: one CTA per (chunk, b), launched as the partial pass's
// programmatic dependent (it may start while the partials are written, and
// waits for them).  A warp per kv head takes the max of the earlier chunks'
// partials (at most 255 floats at the plan's 256 chunks, 0 for the first
// chunk: norms are >= 0), then runs it forward through its chunk's norms in
// kcum, in place, 32 keys at a time: an inclusive max scan across the warp
// by shuffles, the last lane's value carried to the next 32 (issuing 8
// partials a lane before using any measured no faster through the K2r op,
// PERF.md).  Max is exact, so kcum equals a sequential running max of the
// norms whatever the plan: kcum of a prefix k[:, :P] is kcum[..., :P] to
// the bit, and kcum[..., K - 1] is kmax.  It releases its own dependent
// (K2r) at once: K2r's CTAs start their loads and wait
// (griddepcontrol.wait) only before they read kcum.  What bounds the
// pre-pass: the k read, as for kmax (3.8 us at the judge's (2, 3072)).
constexpr int kScanThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
key_norm_scan_kernel(const float* __restrict__ part, float* __restrict__ kcum,
                     int K, int Hkv, int chunk) {
  sm90::grid_launch_dependents();
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int j0 = c * chunk;
  const int keys = max(0, min(chunk, K - j0));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  sm90::grid_dependency_wait();
  if (keys == 0) return;
  for (int h = warp; h < Hkv; h += kScanThreads / 32) {
    const float* p = part + (long long)b * gridDim.x * Hkv + h;
    float run = 0.f;
    for (int i = lane; i < c; i += 32) run = fmaxf(run, p[(long long)i * Hkv]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      run = fmaxf(run, __shfl_xor_sync(0xffffffffu, run, o));
    }
    float* row = kcum + ((long long)b * Hkv + h) * K + j0;
    for (int s0 = 0; s0 < keys; s0 += 32) {
      const int j = s0 + lane;
      float x = j < keys ? row[j] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = fmaxf(x, y);
      }
      x = fmaxf(x, run);
      if (j < keys) row[j] = x;
      run = __shfl_sync(0xffffffffu, x, 31);
    }
  }
}

// K2r's pre-pass on `stream`: the partial pass with its norms into kcum
// (B, Hkv, K) and part (B, nparts, Hkv) scratch, then the scan as its
// programmatic dependent.  Plain stores throughout: no memset, no atomics.
int launch_key_norm_cummax(const void* k, const void* mask, void* part,
                           void* kcum, int B, int K, int Hkv, int D,
                           long long ksb, long long kss, int nparts,
                           cudaStream_t s) {
  if (!k2_head_dim(D)) return int(cudaErrorInvalidValue);
  const int err =
      launch_partials(k, mask, part, kcum, B, K, Hkv, D, ksb, kss, nparts, s);
  if (err != 0) return err;
  const float* part_f = static_cast<const float*>(part);
  float* kcum_f = static_cast<float*>(kcum);
  int chunk = (K + nparts - 1) / nparts;
  void* args[] = {&part_f, &kcum_f, &K, &Hkv, &chunk};
  return int(sm90::launch_dependent(
      reinterpret_cast<const void*>(key_norm_scan_kernel), dim3(nparts, B),
      dim3(kScanThreads), 0, s, args));
}

// The pre-pass alone: kcum (B, Hkv, K) fp32, with part (B, nparts, Hkv)
// scratch.
extern "C" int mjv_key_norm_cummax(const void* k, const void* mask,
                                   void* part, void* out, int B, int K,
                                   int Hkv, int D, long long ksb,
                                   long long kss, int nparts, void* stream) {
  return launch_key_norm_cummax(k, mask, part, out, B, K, Hkv, D, ksb, kss,
                                nparts, static_cast<cudaStream_t>(stream));
}

// K2r alone on a given kcum, the (B, Hkv, K) fp32 output of
// mjv_key_norm_cummax: the kernel-alone form of the op.
extern "C" int mjv_decoder_attention_rows(
    const void* q, const void* k, const void* v, const void* mask,
    const void* kcum, const void* q_offset, void* out, int B, int Q, int K,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long ksb,
    long long kss, long long vsb, long long vss, float scale, void* stream) {
  if (!k2_head_dim(D)) return int(cudaErrorInvalidValue);
  if (D == 96) {
    return sm90::launch_attention<sm90::D96, true, sm90::ShiftMode::kRows>(
        q, k, v, mask, kcum, 1, q_offset, out, nullptr, B, Q, K, Hq, Hkv, qsb,
        qss, ksb, kss, vsb, vss, scale, stream);
  }
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kRows>(
      q, k, v, mask, kcum, 1, q_offset, out, nullptr, B, Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, scale, stream);
}

// The K2r op: the pre-pass into part (B, nparts, Hkv) scratch and kcum
// (B, Hkv, K), then K2r launched as the scan's programmatic dependent,
// reading kcum after griddepcontrol.wait.
extern "C" int mjv_decoder_attention_rows_op(
    const void* q, const void* k, const void* v, const void* mask,
    const void* q_offset, void* part, void* kcum, void* out, int B, int Q,
    int K, int Hq, int Hkv, int D, long long qsb, long long qss,
    long long ksb, long long kss, long long vsb, long long vss, int nparts,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_key_norm_cummax(k, mask, part, kcum, B, K, Hkv, D,
                                         ksb, kss, nparts, s);
  if (err != 0) return err;
  if (D == 96) {
    return sm90::launch_attention<sm90::D96, true, sm90::ShiftMode::kRows>(
        q, k, v, mask, kcum, 1, q_offset, out, nullptr, B, Q, K, Hq, Hkv, qsb,
        qss, ksb, kss, vsb, vss, scale, stream, true);
  }
  return sm90::launch_attention<sm90::D128, true, sm90::ShiftMode::kRows>(
      q, k, v, mask, kcum, 1, q_offset, out, nullptr, B, Q, K, Hq, Hkv, qsb,
      qss, ksb, kss, vsb, vss, scale, stream, true);
}
