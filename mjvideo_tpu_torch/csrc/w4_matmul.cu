// K5: the int4 weight-only (w4a16) decode GEMV on Hopper (sm_90a):
// tensor-core products on a k-major nibble layout, the split K reduced in
// a fixed order inside a thread-block cluster.
//
// Replaces _w4_matmul_pallas (mjvideo_tpu/ops/quant4.py:177, call :227):
// x (M <= 32, K) bf16 times a half-split packed int4 kernel, packed (K/2, N)
// int8 with group scales (G, N) bf16, g = K / G, giving (M, N) fp32.  The
// low nibble of packed[p] holds row p and the high nibble row K/2 + p, both
// biased by 8; row k's group is k / g.  Each weight is dequantized as
// (nibble - 8) * scale rounded once to bf16 (x's dtype), as the TPU kernel
// does; the bf16 x bf16 products are exact and summed in fp32.
//
// Layout.  The port stores every packed weight k-major: the (K/2, N) tensor
// is a view of an (N, K/2) row-major array (ops/quant4.py), so a column's
// packed bytes are contiguous and one 16-byte load carries 16 consecutive
// packed rows of one column: 32 weights, 16 of the low half and 16 of the
// high, each half inside one group when g is a multiple of 16.
//
// What bounds it on this card: the weight bytes.  A decode step reads each
// packed kernel once for a handful of rows, K/2 x N bytes (8.4 MB for the
// 2B's w1, 94.8 MB for its LM head), so the kernel must keep the memory
// busy and every other cost out of the way: no memset launch, no CUDA-core
// FMA per weight and row, and a sum whose order does not depend on which
// CTA finishes first.
//
// Design.
// - A warp owns 32 columns (two 16-row A tiles of mma.m16n8k16, out^T =
//   W^T x^T: the weight is the A operand, x the B operand, M in tiles of
//   8) and a run of 64-byte k-blocks of them.  Thread (group q, lane t of
//   the quad) loads 16 bytes at packed row 16 t of the block for its 4
//   columns (q, q + 8, q + 16, q + 24 of the warp's 32) with
//   ld.global.nc.L1::no_allocate into a ring of kStages register buffers:
//   the first kStages blocks' loads go out before anything else, and a
//   block's buffer is refilled with the block kStages on as soon as its
//   products are issued.
// - Dequantization in registers, two weights at a time: the nibbles of
//   bytes 0 and 2 (or 1 and 3) of a 32-bit word sit at bits 0-3 and 16-19
//   after a shift; OR 0x4300 makes bf16 128 + nibble, one bf16x2 fma
//   subtracts 136 exactly, one multiplies by the group scale with a single
//   rounding: bf16((nibble - 8) * scale), the twin's value.  The k order
//   inside an mma is free, so a thread's A slots (2t, 2t + 1, 2t + 8,
//   2t + 9) take packed bytes (0, 2, 1, 3) of each word, and x is staged
//   with each run of 4 k permuted the same way: a thread's B registers for
//   a step are one 8-byte shared-memory load.
// - x goes into shared memory once per CTA, bf16, for the CTA's K slice
//   (both halves), staged while the first weight loads are in flight; a
//   group's scale is read once per (column, group, quad).
// - Where the column tiles alone give fewer than kWaves x SMs CTAs, K is
//   split over the CTAs of one thread-block cluster (up to kClusterMax):
//   each CTA writes its warps' partial tiles to shared memory; after a
//   cluster barrier each CTA sums its share of the tile's elements over
//   the ranks in rank order (and over its warps in order), reading the
//   others through distributed shared memory, and writes it to the output
//   once.  No memset, no sum in arrival order: a second launch is
//   bit-identical.
// - Any other (g, K, alignment) takes a slower path in the same launch
//   shape (one thread per column, byte loads, no split), never the twin.
//
// A/B (tools/w4_config_ab_torch.py; NVIDIA H100 80GB HBM3, 700 W; device
// time a launch with the L2 cold, M = 2, at 2048 -> 8192 / on the LM head,
// 2048 -> 92,553; the full tables in PERF.md section 6):
// - W4, BN 64 with 2 warps along K and 2 stages: 9.7-9.8 / 51 us.  BN 128
//   or 256: 13.0-13.4 / 58-59; BN 128 with one warp along K: 11.0 / 61;
//   1 stage: 9.0-9.3 / 50-51 (within the spread of repeated runs); 3 or 4
//   stages: 9.4-9.6 / 53-57; a split of at most 4, or twice the CTAs
//   wanted before the split: 9.7-12.1 / 50-51.
// - W4Wide, BN 128 with 1 stage, for 17-32 rows: 104-106 us on the LM head
//   at M = 32 against BN 64's 144-166 (x is staged for twice the columns).
// - Probes: the launch alone 1.1-1.4 us; the loads alone 7.5 / 39 us, the
//   loads and the dequantization 8.4 / 43: the loads set most of the time.
// - Not kept: one accumulator per nibble half (equal at M <= 8, 1.5x at 32:
//   registers); the loads as one 1-D bulk copy a column from a producer
//   warp into a shared ring (35 / 218 us: small bulk copies throttle the
//   copy engine); cp.async by each warp into its own swizzled 4-stage ring,
//   128 contiguous bytes of a column a request (10.5 / 62 us); the L2
//   prefetch hint at 128 bytes or none (within 1%).
// - The CUDA-core design this replaces (byte loads, x in fp32, a memset
//   and a sum in arrival order): 18.0-18.3 / 86-90 us.
// - PyTorch's torch._weight_int4pack_mm on the same nibbles and scales
//   (its own tiled layout; N a multiple of 8, so not the LM head): 7.6 us
//   at 2048 -> 8192, 1.2-1.4x faster than this at M <= 2 with the L2
//   cold, 1.2x slower at M = 8 and 2.1x at M = 32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

// BN: columns per CTA (32 per column warp); KW: warps along K per column
// warp; STAGES: k-blocks in flight per warp (a ring of register buffers);
// CLUSTER_MAX: the largest K split; WAVES: the CTAs wanted, in multiples
// of the SM count, before K is split.
template <int BN, int KW, int STAGES, int CLUSTER_MAX, int WAVES>
struct Config {
  static constexpr int kBN = BN;
  static constexpr int kColWarps = BN / 32;
  static constexpr int kKW = KW;
  static constexpr int kWarps = kColWarps * KW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = STAGES;
  static constexpr int kClusterMax = CLUSTER_MAX;
  static constexpr int kWaves = WAVES;
  static_assert(BN % 32 == 0 && kWarps >= 1 && kWarps <= 32, "Config");
  static_assert(CLUSTER_MAX >= 1 && CLUSTER_MAX <= 8, "Config");
};

// M <= 16 (one or two 8-row M tiles), and 17 <= M <= 32 (four).
using W4 = Config<64, 2, 2, 8, 1>;
using W4Wide = Config<128, 2, 1, 8, 1>;

constexpr int kBlock = 64;                // packed rows of a k-block
constexpr int kSmemBudget = 113 * 1024;   // x slice + partials, per CTA
constexpr int kSmemMax = 227 * 1024;
constexpr int kGenericThreads = 128;

__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Two biased nibbles at bits 0-3 and 16-19 of v (other bits ignored) ->
// bf16x2 of (nibble - 8) * s, rounded once; s2 holds the scale twice.
__device__ __forceinline__ uint32_t deq2(uint32_t v, uint32_t s2) {
  const uint32_t t = (v & 0x000F000Fu) | 0x43004300u;  // 128 + nibble
  uint32_t d, r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d) : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));  // - 136
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r) : "r"(d), "r"(s2), "r"(0x80008000u));            // * s
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-block's loads for a thread: 16 bytes of each of its 4 columns and
// the group scale of each column for the low and the high half.
struct Chunk {
  uint4 w[4];
  uint32_t s[2][4];  // [half][column] bf16 bits, duplicated
};

struct Plan {
  int fast, cluster, slice, smem;
};

// x staged row by row: [low half: slice][high half: slice][4 pad], each run
// of 4 k stored in the order (0, 2, 1, 3).  The row stride is 8 bytes past
// a multiple of 128 so that a warp's 8-byte B loads meet no bank twice.
__host__ __device__ __forceinline__ int x_row_bytes(int slice) {
  return 4 * slice + 8;
}

template <class C>
__host__ __device__ __forceinline__ int red_bytes(int M) {
  return C::kKW * M * (C::kBN + 4) * 4;
}

template <class C, int NT>
__global__ void __launch_bounds__(C::kThreads)
    w4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ packed,
                  const uint16_t* __restrict__ scale, float* __restrict__ out,
                  int M, int N, int K, int g, int slice) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int K2 = K / 2;
  const int p_begin = rank * slice;
  const int p_end = min(p_begin + slice, K2);
  const int nkb = p_end > p_begin ? (p_end - p_begin + kBlock - 1) / kBlock
                                  : 0;
  const int n0 = blockIdx.y * C::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % C::kColWarps, kw = warp / C::kColWarps;
  const int q = lane / 4, t = lane % 4;

  // This thread's 4 columns (clamped: a column past N computes garbage
  // that is never stored) and their byte offsets.
  const uint8_t* col[4];
  int ncol[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = min(n0 + cw * 32 + c * 8 + q, N - 1);
    ncol[c] = n;
    col[c] = packed + size_t(n) * K2 + 16 * t;
  }
  const int hi_group = K2 / g;

  auto load = [&](Chunk& ch, int kb) {
    const int p = p_begin + kb * kBlock + 16 * t;
    if (kb < nkb && p < p_end) {
      const int gl = p / g;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ch.w[c] = ldg_stream(col[c] + p_begin + kb * kBlock);
        const uint32_t sl = __ldg(scale + size_t(gl) * N + ncol[c]);
        const uint32_t sh = __ldg(scale + size_t(gl + hi_group) * N + ncol[c]);
        ch.s[0][c] = sl | (sl << 16);
        ch.s[1][c] = sh | (sh << 16);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ch.w[c] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u,
                             0x88888888u);  // zero weights
        ch.s[0][c] = ch.s[1][c] = 0;
      }
    }
  };

  // The first STAGES blocks' loads go out before x is staged.
  Chunk ring[C::kStages];
#pragma unroll
  for (int i = 0; i < C::kStages; ++i) load(ring[i], kw + i * C::kKW);

  // Stage x's slice: rows < M, both halves, zero past the slice's end.
  const int rs = x_row_bytes(slice);
  const int quads = slice / 4;
  for (int i = threadIdx.x; i < M * 2 * quads; i += C::kThreads) {
    const int m = i / (2 * quads), h = (i / quads) % 2, j = i % quads;
    const int p = p_begin + 4 * j;
    uint2 v = make_uint2(0u, 0u);
    if (p < p_end) {
      v = *reinterpret_cast<const uint2*>(x + size_t(m) * K + h * K2 + p);
    }
    uint2 o;
    o.x = __byte_perm(v.x, v.y, 0x5410);  // k 0, 2
    o.y = __byte_perm(v.x, v.y, 0x7632);  // k 1, 3
    *reinterpret_cast<uint2*>(smem + m * rs + h * 2 * slice + 8 * j) = o;
  }
  __syncthreads();

  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][r][e] = 0.f;

  // B rows: this thread reads row 8 j + q of x for each M tile j.
  int xrow[NT];
  bool xlive[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xlive[j] = 8 * j + q < M;
    xrow[j] = (xlive[j] ? 8 * j + q : 0) * rs + 32 * t;
  }

  // The products of one k-block, from its loads.
  auto products = [&](const Chunk& ch, int kb) {
    const int off = kb * kBlock * 2;  // bytes into each half
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t v0 = word(ch.w[2 * r], w) >> (4 * h);
          const uint32_t v1 = word(ch.w[2 * r + 1], w) >> (4 * h);
          a[r][0] = deq2(v0, ch.s[h][2 * r]);           // row q, bytes 0, 2
          a[r][1] = deq2(v1, ch.s[h][2 * r + 1]);       // row q + 8
          a[r][2] = deq2(v0 >> 8, ch.s[h][2 * r]);      // row q, bytes 1, 3
          a[r][3] = deq2(v1 >> 8, ch.s[h][2 * r + 1]);  // row q + 8
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint2 b = make_uint2(0u, 0u);
          if (xlive[j]) {
            b = *reinterpret_cast<const uint2*>(smem + xrow[j] +
                                                h * 2 * slice + off + 8 * w);
          }
          mma_bf16(acc[j][0], a[0], b.x, b.y);
          mma_bf16(acc[j][1], a[1], b.x, b.y);
        }
      }
    }
  };

  // The ring: block kb's products, then the loads of the block STAGES
  // steps on into its buffer.
  for (int kb = kw; kb < nkb; kb += C::kStages * C::kKW) {
#pragma unroll
    for (int i = 0; i < C::kStages; ++i) {
      const int b = kb + i * C::kKW;
      if (b < nkb) {
        products(ring[i], b);
        load(ring[i], b + C::kStages * C::kKW);
      }
    }
  }

  // Partials: red[kw][m][column], rows of BN + 4 floats.  The x slice is
  // dead once every warp is past its loop.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int rstride = C::kBN + 4;
  float* mine = red + size_t(kw) * M * rstride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int nl = cw * 32 + r * 16 + q;
      const int m = 8 * j + 2 * t;
      if (m < M) {
        mine[m * rstride + nl] = acc[j][r][0];
        mine[m * rstride + nl + 8] = acc[j][r][2];
      }
      if (m + 1 < M) {
        mine[(m + 1) * rstride + nl] = acc[j][r][1];
        mine[(m + 1) * rstride + nl + 8] = acc[j][r][3];
      }
    }
  }
  cluster.sync();

  // This CTA's share of the tile, 4 columns a thread: every rank's and
  // warp's partial loaded at once, then summed over ranks, then warps, in
  // order.
  constexpr int kQuads = C::kBN / 4;
  const int E = M * kQuads;
  const int share = (E + CL - 1) / CL;
  const int e_end = min(E, (rank + 1) * share);
  for (int e = rank * share + int(threadIdx.x); e < e_end;
       e += C::kThreads) {
    const int m = e / kQuads, nl = 4 * (e % kQuads);
    float4 v[C::kClusterMax][C::kKW];
#pragma unroll
    for (int src = 0; src < C::kClusterMax; ++src) {
      if (src < CL) {
        const float* other = cluster.map_shared_rank(red, src);
#pragma unroll
        for (int w = 0; w < C::kKW; ++w) {
          v[src][w] = *reinterpret_cast<const float4*>(
              other + (size_t(w) * M + m) * rstride + nl);
        }
      }
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int src = 0; src < C::kClusterMax; ++src) {
      if (src < CL) {
#pragma unroll
        for (int w = 0; w < C::kKW; ++w) {
          s.x += v[src][w].x;
          s.y += v[src][w].y;
          s.z += v[src][w].z;
          s.w += v[src][w].w;
        }
      }
    }
    float* o = out + size_t(m) * N + n0 + nl;
    const int left = N - n0 - nl;
    if (left > 0) o[0] = s.x;
    if (left > 1) o[1] = s.y;
    if (left > 2) o[2] = s.z;
    if (left > 3) o[3] = s.w;
  }
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();
}

// Any g and K: one thread per column, the whole K, byte loads.
__global__ void __launch_bounds__(kGenericThreads)
    w4_generic_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const __nv_bfloat16* __restrict__ scale,
                      float* __restrict__ out, int M, int N, int K, int g) {
  const int n = blockIdx.x * kGenericThreads + threadIdx.x;
  if (n >= N) return;
  const int K2 = K / 2;
  float acc[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) acc[m] = 0.f;
  const uint8_t* src = packed + size_t(n) * K2;
  for (int p = 0; p < K2; ++p) {
    const int b = src[p];
    const float sl = __bfloat162float(scale[size_t(p / g) * N + n]);
    const float sh = __bfloat162float(scale[size_t((K2 + p) / g) * N + n]);
    const float wl =
        __bfloat162float(__float2bfloat16_rn(float((b & 15) - 8) * sl));
    const float wh =
        __bfloat162float(__float2bfloat16_rn(float((b >> 4) - 8) * sh));
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      if (m < M) {
        acc[m] += __bfloat162float(x[size_t(m) * K + p]) * wl;
        acc[m] += __bfloat162float(x[size_t(m) * K + K2 + p]) * wh;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    if (m < M) out[size_t(m) * N + n] = acc[m];
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// The path, the K split and the shared memory of a call.
template <class C>
Plan plan(int M, int N, int K, int G, const void* x, const void* packed) {
  Plan pl{0, 1, 0, 0};
  const int K2 = K / 2, g = K / G;
  if (g % 16 || K2 % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16) {
    return pl;
  }
  const int blocks = (K2 + kBlock - 1) / kBlock;
  const int tiles = (N + C::kBN - 1) / C::kBN;
  const int want = C::kWaves * sm_count();
  int cl = 1;
  while (cl < C::kClusterMax && tiles * cl < want && 2 * cl <= blocks) {
    cl *= 2;
  }
  auto bytes = [&](int c) {
    const int slice = (blocks + c - 1) / c * kBlock;
    const int xb = M * x_row_bytes(slice), rb = red_bytes<C>(M);
    return xb > rb ? xb : rb;
  };
  while (cl < C::kClusterMax && 2 * cl <= blocks && bytes(cl) > kSmemBudget) {
    cl *= 2;
  }
  if (bytes(cl) > kSmemMax) return pl;
  pl.fast = 1;
  pl.cluster = cl;
  pl.slice = (blocks + cl - 1) / cl * kBlock;
  pl.smem = bytes(cl);
  return pl;
}

template <class C, int NT>
int launch_mma(const void* x, const void* packed, const void* scale,
               void* out, int M, int N, int K, int G, cudaStream_t stream) {
  const Plan pl = plan<C>(M, N, K, G, x, packed);
  if (!pl.fast) {
    w4_generic_kernel<<<(N + kGenericThreads - 1) / kGenericThreads,
                        kGenericThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint8_t*>(packed),
        static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(out),
        M, N, K, K / G);
    return int(cudaGetLastError());
  }
  auto kernel = w4_mma_kernel<C, NT>;
  static bool opened[64] = {false};  // the shared-memory cap, per device
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (dev < 0 || dev >= 64 || !opened[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return int(err);
    if (dev >= 0 && dev < 64) opened[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, (N + C::kBN - 1) / C::kBN, 1);
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<const uint16_t*>(scale),
                           static_cast<float*>(out), M, N, K, K / G,
                           pl.slice);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

bool valid(int M, int N, int K, int G) {
  return M >= 1 && M <= 32 && N >= 1 && K >= 2 && K % 2 == 0 && G >= 1 &&
         K % G == 0 && (K / 2) % (K / G) == 0;
}

}  // namespace

// x (M, K) bf16, packed (K/2, N) int8 stored k-major (an (N, K/2) row-major
// array), scale (G, N) bf16 -> out (M, N) fp32, every element written once.
// One launch on `stream`.
extern "C" int mjv_w4_matmul(const void* x, const void* packed,
                             const void* scale, void* out, int M, int N,
                             int K, int G, void* stream) {
  if (!valid(M, N, K, G)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_mma<W4, 1>(x, packed, scale, out, M, N, K, G, s);
  if (M <= 16) return launch_mma<W4, 2>(x, packed, scale, out, M, N, K, G, s);
  return launch_mma<W4Wide, 4>(x, packed, scale, out, M, N, K, G, s);
}

// The plan of a call, for the tests and the A/B: info = {fast path (1) or
// the generic one (0), columns per CTA, warps along K, cluster size, packed
// rows per CTA, dynamic shared memory bytes}, for operands aligned to 16
// bytes (a misaligned x or packed takes the generic path).
extern "C" int mjv_w4_plan(int M, int N, int K, int G, int* info) {
  if (!valid(M, N, K, G)) return int(cudaErrorInvalidValue);
  const bool wide = M > 16;
  const Plan pl = wide ? plan<W4Wide>(M, N, K, G, nullptr, nullptr)
                       : plan<W4>(M, N, K, G, nullptr, nullptr);
  info[0] = pl.fast;
  info[1] = wide ? W4Wide::kBN : W4::kBN;
  info[2] = wide ? W4Wide::kKW : W4::kKW;
  info[3] = pl.cluster;
  info[4] = pl.slice;
  info[5] = pl.smem;
  return 0;
}
