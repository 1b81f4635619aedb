// The weight-only quantized linears (int8_linear.cu, nf4_linear.cu): y (M, N)
// = x (M, K) · W (N, K)ᵀ, where W stays quantized in device memory and is
// decoded in registers; f32 sums, one rounding to x's dtype at the end.
// cudaex.weight_only_plan picks one of four routes from the shapes alone:
//
// f32 x, NF4 at M <= 16 — `fma`: linear_f32_kernel. A block owns 16 rows and
// 16 columns and its 8 warps split K; each lane decodes 16 weights from one
// 16-byte load and sums them by FMAs; the warps' sums meet in shared memory.
// At these M the split route below was slower for NF4 (a decode step's six
// shapes 1.81 against 1.74 ms, tools/quant_ab.py --f32, H100 80GB HBM3,
// 700 W): its fixed costs (the pieces' pass, the pipeline's fill, the K
// splits' tail) come to ~10-15 µs a launch, where the NF4 attention
// projections take 10-11 µs on this kernel. int8 is faster on the split
// route at every M.
//
// f32 x, any other M — `split` (operations bound at prefill): split_x_kernel,
// then wgmma_kernel<kNf4, BT, true>. What bounds f32 x on this card: its f32 FMA
// rate is 67 TFLOP/s (the kernel this replaces reached 12 of it at M = 512),
// and tf32 products would drop 13 bits of x. The split design: an f32 value
// is the exact sum of three bf16 pieces, x0 = bf16(x), x1 = bf16(x - x0) and
// x2 = bf16(x - x0 - x1). Each residual is exact in f32 (the rounding error
// of a value with at most 24 significant bits), and each rounding takes the
// next 8 of them, so 3 x 8 >= 24 and x0 + x1 + x2 == x bit for bit wherever
// x's lowest significand bit is at least 2^-133, bf16's least subnormal (every
// |x| >= 2^-110; below it the bits under 2^-133 are lost, < 2^-133 absolute).
// |x1| <= 2^-8 |x| and |x2| <= 2^-16 |x|. A product of two bf16 values has at
// most 16 significant bits, so the bf16 tensor cores (989 TFLOP/s) form each
// exactly and add it into f32 accumulators: the only rounding left is the f32
// summation, in another order than the plain version's. A pass over x writes
// the pieces (3, M, K) bf16 to scratch the wrapper allocates (torch.empty, so
// a CUDA-graph capture holds it); the wgmma route's persistent product below
// takes a k range's three pieces as one TMA box (three x tiles) and issues a
// product a pair of pieces into the same f32 accumulators:
//   int8: a code (-128..127) is exact in bf16, so three products, x0, x1, x2
//     against the one decoded A fragment; the scale once to the f32 sum.
//   NF4: w = code · absmax taken in f32 (the plain version's weight), split in
//     registers into w0 + w1 + w2 like x; the six products x_i · w_j with i + j
//     <= 2. The three dropped ones are each at most 2^-24 |x w|, 2^-23 in all:
//     about the one f32 rounding the plain version makes of each product.
// The tensor cores add a chain of products into their f32 accumulators with
// fewer bits than an f32 add keeps, and toward zero (on an H100, NF4 with
// 4,096 k in one chain failed the card test's 1e-4 of |y|), so each 64-byte
// unit's products (int8 12, NF4 48 a warpgroup) go into fresh registers,
// which join the f32 sums by FADD once they land; the other consumer
// warpgroup's products keep the tensor cores busy meanwhile. So promoted,
// y is within 4.6e-6 of max(1, |y|) of the exact product at K = 8192, its
// mean signed error -8e-7 of |y| for NF4 and -2e-7 for int8 (cuBLAS's f32
// product: 1e-9).
// y leaves in f32 straight from the accumulators (a warp's store writes eight
// consecutive columns, one 32-byte sector, of four rows); rows past M and
// columns past N are not written. int8 takes tiles of 16 tokens at M <= 16
// (m64n16k16: a quarter of the padded products of 64), 64 to M = 64, else
// 128; NF4 64 (its six x tiles a stage and its pair table leave no room for
// 128).
//
// bf16 x, M <= 16, K in whole 128-k chunks — `stream` (decode; bytes bound):
// stream_kernel. The product is swapped, yᵀ = W · xᵀ: the decoded weights
// are the 16-row A operand of mma.sync.m16n8k16 and the tokens its n = 8
// columns (one or two n8 tiles), so no row of the product is wasted at M <=
// 8. A block owns 16 weight rows (its 8 warps split K: warp w takes the ring
// slots s with s % 8 == w) where 64-row blocks would leave an SM without two
// and the 16-row grid is one wave of resident blocks, else 64 rows (warp w:
// a 16-row tile and half of every stage). It covers all of K, or a K split
// where x for it would pass 2,048 k. x for the block's k range arrives in
// one TMA box; the weights stream through a ring of 128-byte-wide stages
// (the block's rows x 128 bytes of K), filled a group of up to 4 stages by
// one TMA box: the producer issues a copy in ~150 ns (H100 80GB HBM3, an
// in-kernel globaltimer trace), so a copy a 2 KB stage spent more time
// issuing than moving. NF4's absmax comes by 4-byte cp.async beside each
// group. Consumers copy a half stage into registers, release it and decode.
//
// bf16 x, other M (the checkers claim up to 512) — `wgmma` (prefill;
// operations bound): wgmma_kernel, persistent (one block an SM walking
// (token tile, 128-row tile, K split) items). yᵀ = W · xᵀ again, so the
// quantized operand goes through registers: wgmma reads B only from shared
// memory, A may come from registers. A producer warp issues TMA copies
// through kStages mbarrier stages: the x tile ([64 or 128 tokens][64 k] bf16,
// K-major, 128-byte swizzle; NF4 takes two, at a unit's high and low k), the
// weight unit (128 rows x 64 bytes) and for NF4 the absmax by cp.async.
// Out-of-range rows and k read as zeros. Two consumer warpgroups of 64
// weight rows decode their A fragments (the m16n8k16 layout of each warp's
// 16 rows) and issue wgmma m64nBTk16 with A from registers; the decode of
// the next k16 slice overlaps the running product (two fragment buffers,
// wgmma_wait<1>). The epilogue scales (int8), rounds to bf16 into a staging
// tile in shared memory, transposed to y's (token, n) order, and the
// warpgroup writes it out in 16-byte rows (rows past M and columns past N
// are not written). The split route is this kernel with three x tiles a k
// range, a product a pair of pieces, and the f32 epilogue above.
//
// K splits (stream, wgmma, split): each block writes its f32 sums to scratch
// (splits, M, N) the wrapper allocates; the last block of a column slice or
// tile to finish — it learns this from a counter of a persistent buffer that
// it resets to zero itself, so a CUDA-graph replay finds it zero — sums the
// splits in split order (a thread keeps up to 16 loads in flight), scales
// (int8) and rounds once (split: stores the f32 sum). One launch, no second
// kernel: the layers this serves take 6-30 µs, where a second launch's gap
// would be a large share; the sum order is fixed, so a rerun is bit-equal.
// The counter buffer is one a device: launches that split must run in stream
// order (they leave it at zero). Measured on the card, the split tail (the partials' stores, a
// fence, the counter's atomic, the last block's loads) costs ~3 µs, so the
// decode route splits only where x will not fit; a cluster of the split
// blocks summing through distributed shared memory was slower still
// (co-scheduling the clusters).
//
// Decoding, per weight:
//   int8: bytes b0..b3 of a 32-bit word w give two bf16 pairs, (b0, b2) and
//     (b1, b3): base = (w & 0x007F007F) | 0x43004300 is bf16 128 + (b & 127)
//     in each half, sub = (w & 0x00800080) | 0x43004300 is 128 or 256 by
//     the sign bit, and base - sub (one fma.rn.bf16x2) is the signed value,
//     exactly. 1.75 instructions a weight (a shift, four LOP3, two HFMA2 for
//     four weights); no type conversion. The stream route takes the pairs in
//     that order and pairs x to match (a PRMT a pair of x); the wgmma route
//     needs each lane's natural k pairs (B comes from x's tile as TMA wrote
//     it): one PRMT a pair first brings bytes 2c, 2c+1 to positions 0 and 2
//     (2.0 a weight).
//   NF4: a 256-entry table in shared memory maps a packed byte to its two
//     codes (code[b >> 4], code[b & 15]) as two f32, in 16 copies (lane l
//     reads copy l % 16, so a half-warp's lookups hit 16 bank pairs and never
//     conflict; 32 KB). A byte costs a PRMT or LOP3 and a LEA (its address),
//     one 8-byte load, two FMULs by the absmax of each nibble's 64-group (the
//     high nibble's k and the low nibble's k + block_k/2 lie in different
//     groups) and one cvt.rn.bf16x2.f32 (split: the f32 products, then three
//     roundings and two subtractions a pair): 3 instructions a weight, against
//     4.5 for the 16-entry table (a lookup, a multiply, half a pack, and
//     the nibble's address) of the kernel this replaces. W is exactly the
//     plain version's round_bf16(code · absmax). The stream route pairs a
//     byte's two nibbles as a fragment's (k, k+1) and x as (x[k], x[k +
//     block_k/2]) to match; the wgmma route takes two bytes' high nibbles
//     for the high slice's pair and their low nibbles for the low slice's.
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace tt {
namespace wol {

using namespace tt::sm90;

// ---------------------------------------------------------------------------
// route fma: linear_f32_kernel (NF4, f32 x, M <= 16)
// ---------------------------------------------------------------------------

// The policy W supplies the format:
//   kChunkK, kGroups       k a warp covers in one chunk; 16-weight groups a
//                          lane decodes from one 16-byte load
//   Raw                    what a lane loads for one weight row and chunk
//   init()                 per-block set-up (shared tables), before a barrier
//   load(raw, n, c, q)     row n (n < 0: none) of chunk c for lane c = q
//   group_k(c, q, g)       the first k of group g (>= K: past the end)
//   decode(raw, g, w[16])  group g's weights in f32
//   epilogue(acc, n)       the f32 sum of column n -> the value stored
//
// A block owns BN = 8·NT output columns and 16 rows, and its WARPS warps
// split K: warp w walks chunks w, w + WARPS, ... of W::kChunkK columns of k.
// Lane 4·g + c reads 16 bytes of weight row n0 + 8·j + g and decodes them
// into W::kGroups groups of 16 weights at consecutive k, summed against x by
// FMAs for all 16 rows; a quad shuffle and shared memory sum the rest.
template <class W, int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    linear_f32_kernel(const float* __restrict__ x, const W w, float* __restrict__ y, int M, int N, int K) {
  constexpr int BN = 8 * NT;
  __shared__ float red[WARPS][16][BN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, q4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 16;
  const int n_chunks = (K + W::kChunkK - 1) / W::kChunkK;
  w.init();
  __syncthreads();

  float facc[16][NT];
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) facc[m][j] = 0.f;

  typename W::Raw cur[NT], nxt[NT];
  auto load_all = [&](typename W::Raw (&r)[NT], int c) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g8;
      w.load(r[j], n < N ? n : -1, c, q4);
    }
  };
  if (warp < n_chunks) load_all(cur, warp);

  for (int c = warp; c < n_chunks; c += WARPS) {
    if (c + WARPS < n_chunks) load_all(nxt, c + WARPS);  // the next chunk's loads in flight
#pragma unroll
    for (int g = 0; g < W::kGroups; ++g) {
      const int k0 = w.group_k(c, q4, g);
      const bool kin = k0 < K;
      float wf[NT][16];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        w.decode(cur[j], g, wf[j]);
        if (!(kin && n0 + 8 * j + g8 < N)) {
#pragma unroll
          for (int i = 0; i < 16; ++i) wf[j][i] = 0.f;
        }
      }
      if (kin) {
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m0 + m < M) {
            const float4* p = reinterpret_cast<const float4*>(x + static_cast<size_t>(m0 + m) * K + k0);
            float xv[16];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float4 f = p[v];
              xv[4 * v] = f.x;
              xv[4 * v + 1] = f.y;
              xv[4 * v + 2] = f.z;
              xv[4 * v + 3] = f.w;
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int i = 0; i < 16; ++i) facc[m][j] = fmaf(xv[i], wf[j][i], facc[m][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) cur[j] = nxt[j];
  }

  // each warp's partial sums into shared memory, then summed over warps
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v = facc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q4 == 0) red[warp][m][8 * j + g8] = v;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * BN; i += WARPS * 32) {
    const int m = i / BN, n = i % BN;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) s += red[v][m][n];
    if (m0 + m < M && n0 + n < N) y[static_cast<size_t>(m0 + m) * N + n0 + n] = w.epilogue(s, n0 + n);
  }
}

template <class W>
int launch_f32(const float* x, const W& w, float* y, int M, int N, int K, cudaStream_t stream) {
  linear_f32_kernel<W, 2, 8><<<dim3((N + 15) / 16, (M + 15) / 16), 256, 0, stream>>>(x, w, y, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// shared pieces of the routes
// ---------------------------------------------------------------------------

enum Route : int { kRouteSplit = 0, kRouteStream = 1, kRouteWgmma = 2, kRouteFma = 3 };

namespace {
__constant__ float kNf4Code[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};
}  // namespace

// The stored weights: int8 codes (N, K) with scale (N,), or NF4 packed
// (N, K/2) in the kernel layout with absmax (N, K/64); hb = block_k / 2.
struct Weights {
  const uint8_t* w;
  const float* s;
  int K, hb;
};

constexpr int kUnitBytes = 64;          // bytes of a weight row a stage holds
constexpr int kTableBytes = 256 * 16 * 8;  // NF4 pair table, 16 copies

template <bool kNf4> struct Fmt {
  static constexpr int kUnitK = kNf4 ? 128 : 64;  // k a unit of a row holds
  static constexpr int kPieces = kNf4 ? 4 : 2;    // 16-byte x pieces a lane takes from a unit (stream)
  static __host__ __device__ int row_bytes(int K) { return kNf4 ? K / 2 : K; }
  // the k of byte b's (high nibble's) weight; the low nibble's is + hb
  static __host__ __device__ int k_of(int b, int hb) { return kNf4 ? (b / hb) * 2 * hb + b % hb : b; }
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) { return __byte_perm(a, b, sel); }

// bytes 0 and 2 of w (two's-complement int8) -> bf16x2, exactly
__device__ __forceinline__ uint32_t i8pair(uint32_t w) {
  const uint32_t base = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (w & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(sub), "r"(0xBF80BF80u), "r"(base));
  return r;
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds64f(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ float lds32f(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts64f(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y));
}
__device__ __forceinline__ void sts16(uint32_t a, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(v));
}

// 4 bytes from global memory into shared memory (src_bytes 0: zeros)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// one arrival on bar once this thread's earlier cp.async copies land (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Builds the NF4 pair table: entry b of copy l at byte (b·16 + l)·8.
__device__ __forceinline__ void build_pair_table(uint32_t table, int tid, int threads) {
  for (int e = tid; e < 256 * 16; e += threads) {
    const int b = e >> 4;
    sts64f(table + 8 * e, kNf4Code[b >> 4], kNf4Code[b & 15]);
  }
}

// The weights of packed byte b (bits 0-7 of v) with the absmaxes of its two
// nibbles, rounded as one bf16x2: low half the high nibble's weight.
__device__ __forceinline__ uint32_t nf4pair(uint32_t table, uint32_t v, float am_hi, float am_lo) {
  const float2 c = lds64f(table + ((v & 0xFFu) << 7));
  const __nv_bfloat162 r = __floats2bfloat162_rn(c.x * am_hi, c.y * am_lo);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The split route's bf16 pieces: 3 of an f32 value (3 x 8 significant bits
// >= 24; 1 for the bf16 routes, the value rounded once). pieces[i] packs
// the pair's i-th pieces (a's low); a = Σ low halves, b = Σ high halves.
constexpr int kSplitPieces = 3;
template <int P>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&pieces)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    pieces[i] = *reinterpret_cast<const uint32_t*>(&v);
    a -= __low2float(v);  // exact: the rounding error of a's remaining bits
    b -= __high2float(v);
  }
}

// x (M, K) f32 -> pieces (3, M, K) bf16 with x0 + x1 + x2 == x (header
// note); n4 = M·K / 4, the float4s of x. Reads 4 bytes and writes 6 an
// element. (A template, so each source that includes this header may define
// it.)
template <int P = kSplitPieces>
__global__ void __launch_bounds__(256) split_x_kernel(const float4* __restrict__ x, uint2* __restrict__ pieces,
                                                      long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += 256ll * gridDim.x) {
    const float4 v = __ldcs(x + i);
    uint32_t lo[P], hi[P];
    split_pair(v.x, v.y, lo);
    split_pair(v.z, v.w, hi);
#pragma unroll
    for (int p = 0; p < P; ++p) pieces[p * n4 + i] = make_uint2(lo[p], hi[p]);
  }
}

// The last block of a split column slice or tile to finish: a counter of
// the persistent buffer, reset to zero by that block. Every thread calls it
// after writing its partials; returns true in the block that sums them.
__device__ __forceinline__ bool last_split(int* counter, int splits, int* flag, int bar_id, int threads,
                                           bool leader) {
  __threadfence();
  named_bar_sync(bar_id, threads);
  if (leader) *flag = atomicAdd(counter, 1) == splits - 1;
  named_bar_sync(bar_id, threads);
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// The last block's sum of the K splits for y's region tokens [m0, m0 + rows)
// x columns [n0, n0 + cols) (cols a multiple of 4; rows past M and columns
// past N skipped): split 0 + split 1 + ... in that order, times scale[n]
// (int8; null for NF4), rounded once to bf16 (OutT float: stored in f32).
// Each thread keeps U 4-column positions x S splits of loads in flight (one
// dependent load after another would cost an L2 round trip each).
template <int U, int S, class OutT>
__device__ __forceinline__ void combine_splits(const float* __restrict__ partial, OutT* __restrict__ y,
                                               const float* __restrict__ scale, int M, int N, int splits, int m0,
                                               int rows, int n0, int cols, int tid, int threads) {
  const size_t stride = static_cast<size_t>(M) * N;  // floats from one split to the next
  if (N & 3) {  // rows of y and of the partials not 16-byte aligned: one column at a time
    for (int e = tid; e < rows * cols; e += threads) {
      const int tok = m0 + e / cols, n = n0 + e % cols;
      if (tok >= M || n >= N) continue;
      float sum = 0.f;
      for (int sp = 0; sp < splits; ++sp) sum += __ldcg(partial + sp * stride + static_cast<size_t>(tok) * N + n);
      const float v = scale ? sum * scale[n] : sum;
      if constexpr (std::is_same_v<OutT, float>) {
        y[static_cast<size_t>(tok) * N + n] = v;
      } else {
        y[static_cast<size_t>(tok) * N + n] = __float2bfloat16(v);
      }
    }
    return;
  }
  const int c4 = cols / 4, total = rows * c4;
  for (int e0 = tid; e0 < total; e0 += U * threads) {
    float4 acc[U];
    size_t off[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * threads, tok = m0 + e / c4, n = n0 + 4 * (e % c4);
      ok[u] = e < total && tok < M && n < N;
      off[u] = ok[u] ? static_cast<size_t>(tok) * N + n : 0;
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int sp = 0; sp < splits; sp += S) {
      float4 v[S][U];
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[q][u] = ok[u] && sp + q < splits ? __ldcg(reinterpret_cast<const float4*>(partial + (sp + q) * stride + off[u]))
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < S; ++q)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (sp + q < splits) {
            acc[u].x += v[q][u].x;
            acc[u].y += v[q][u].y;
            acc[u].z += v[q][u].z;
            acc[u].w += v[q][u].w;
          }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const int n = static_cast<int>(off[u] % N);
      float4 r = acc[u];
      if (scale) r = make_float4(r.x * scale[n], r.y * scale[n + 1], r.z * scale[n + 2], r.w * scale[n + 3]);
      if constexpr (std::is_same_v<OutT, float>) {
        *reinterpret_cast<float4*>(y + off[u]) = r;
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(r.x, r.y), hi = __floats2bfloat162_rn(r.z, r.w);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + off[u]) = pk;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route stream: stream_kernel (bf16 x, M <= 16)
// ---------------------------------------------------------------------------

constexpr int kStreamConsumers = 256;
constexpr int kStreamThreads = kStreamConsumers + 32;  // and the producer warp
constexpr int kStreamUnit = 2 * kUnitBytes;           // bytes of a row a stream stage holds: two halves
constexpr int kStreamMaxStages = 16;
constexpr int kStreamRed = 128 * 16 * 4;              // the warps' sums: (sub, row) x 16 tokens, f32

// A stream block owns 16·RT weight rows (RT 16-row tiles: 4 for layers wide
// enough to give every SM two such blocks, else 1) over `ups` units (128
// bytes of each row) of K: all of K, or a K split where x would not fit.
// Shared memory: x for the block's k range, staged once ([64-k chunk][8·NT
// tokens][64 k] bf16, 128-byte rows, 128-byte swizzle: chunk j of row r at
// j ^ (r % 8)); the ring of stages, each a unit's weights [16·RT rows][128
// bytes] (the same swizzle), filled G stages at a time by one TMA box (the
// producer issues a copy in ~150 ns, so a copy a stage made issuing the
// block's first copies its largest cost); NF4's absmax [stage][half][hi/lo]
// [16·RT rows]; the warps' sums (in the ring once it is consumed); NF4's pair
// table; barriers (a full and an empty one a group of G stages).
__host__ __device__ constexpr int stream_x_chunks(bool nf4, int ups) { return ups * (nf4 ? 4 : 2); }
__host__ __device__ constexpr int stream_ring(int rt, int stages) {
  return stages * 16 * rt * kStreamUnit > kStreamRed ? stages * 16 * rt * kStreamUnit : kStreamRed;
}
__host__ __device__ constexpr int stream_smem(bool nf4, int nt, int rt, int stages, int ups) {
  return stream_x_chunks(nf4, ups) * 8 * nt * 128 + stream_ring(rt, stages) +
         (nf4 ? stages * 4 * 16 * rt * 4 + kTableBytes : 0) + (2 * stages + 1) * 8 + 8 + 1024;
}
// Stages a fill group: half the ring, at most 4 (at least two groups, so one
// fills while another is read, and the first lands before all of a long
// ring); `stages` a multiple of it.
__host__ __device__ constexpr int stream_group(int stages) { return stages < 2 ? 1 : (stages / 2 < 4 ? stages / 2 : 4); }

// NT: n8 token tiles (M <= 8·NT); RT: 16-row tiles a block. Grid
// (ceil(N / (16·RT)), splits). The 8 consumer warps split the block's work:
// with RT = 4, warp w takes rows 16·(w % 4) .. + 15 and 64-byte half w / 4
// of every stage; with RT = 1, warp w takes both halves of the stages in
// ring slots s with s % 8 == w (K split across warps). Their f32 sums meet in
// shared memory, added in warp order. Registers are held to 4 blocks an SM
// (3 with two token tiles).
template <bool kNf4, int NT, int RT>
__global__ void __launch_bounds__(kStreamThreads, NT == 1 ? 4 : 3)
    stream_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                  const Weights wt, __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                  int* __restrict__ counters, int M, int N, int ups, int stages) {
  using F = Fmt<kNf4>;
  constexpr int kRows = 16 * RT, kSubs = 8 / RT;  // rows a block; warps on each row tile
  constexpr int kStage = kRows * kStreamUnit, kXRow = 8 * NT * 128, kAmStage = 4 * kRows * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const int x_bytes = stream_x_chunks(kNf4, ups) * kXRow;
  const int ring_bytes = stream_ring(RT, stages);
  const uint32_t xs = sb, ring = sb + x_bytes, am_base = ring + ring_bytes;
  const uint32_t table_base = am_base + (kNf4 ? stages * kAmStage : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + x_bytes + ring_bytes + (kNf4 ? stages * kAmStage + kTableBytes : 0));
  uint64_t* empty = full + stages;
  uint64_t* xbar = empty + stages;
  int* flag = reinterpret_cast<int*>(xbar + 1);

  const int K = wt.K, units = (F::row_bytes(K) + kStreamUnit - 1) / kStreamUnit;
  const int split = blockIdx.y, splits = gridDim.y;
  const int u0 = split * ups, nu = min(units, u0 + ups) - u0;
  const int k0 = F::k_of(u0 * kStreamUnit, wt.hb);  // x's first k for this block (NF4: splits hold whole slices)
  const int n0 = blockIdx.x * kRows;
  const int G = stream_group(stages), groups = stages / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // group fill i: units [i·G, i·G + G) of the block into ring slots
  // [(i % groups)·G, + G) by one TMA box (W viewed as [128-byte chunk][row]
  // [128 bytes]), and (NF4) each unit's halves' two 64-groups of absmax of
  // each row; full barrier i % groups
  auto fill = [&](int i) {
    const int gi = i % groups, t0 = i * G;
    if constexpr (kNf4) {
      const int G64 = K / 64;
      for (int e = lane; e < G * 4 * kRows; e += 32) {
        const int u = e / (4 * kRows), r = e % (4 * kRows);
        const int n = n0 + (r % kRows), hl = (r / kRows) & 1, half = r / (2 * kRows);
        const int grp = F::k_of((u0 + t0 + u) * kStreamUnit + kUnitBytes * half, wt.hb) / 64 + hl * (wt.hb / 64);
        const bool ok = n < N && t0 + u < nu;
        cp_async4(am_base + (gi * G + u) * kAmStage + 4 * r,
                  wt.s + static_cast<size_t>(ok ? n : 0) * G64 + (ok ? grp : 0), ok ? 4 : 0);
      }
      cp_async_arrive(&full[gi]);
    }
    if (lane == 0) {
      mbar_expect_tx(&full[gi], G * kStage);
      tma_load_3d(smem + x_bytes + gi * G * kStage, &tm_w, &full[gi], 0, n0, u0 + t0);
    }
  };

  // The producer warp sets up the barriers and issues x's box and the first
  // fills before the block's first barrier, so they fly while it starts up.
  if (warp == kStreamConsumers / 32) {
    if (lane == 0) {
      for (int gi = 0; gi < groups; ++gi) {
        mbar_init(&full[gi], kNf4 ? 33 : 1);        // the TMA's expect_tx (+ 32 lanes' absmax copies)
        mbar_init(&empty[gi], G * (8 / kSubs) * 2);  // each stage: RT 4: the 8 warps; RT 1: one warp, once a half
      }
      mbar_init(xbar, 1);
      fence_barrier_init();
      mbar_expect_tx(xbar, x_bytes);
      tma_load_3d(smem, &tm_x, xbar, 0, 0, k0 / 64);
    }
    __syncwarp();
    for (int i = 0; i < groups && i * G < nu; ++i) fill(i);
  } else if constexpr (kNf4) {
    build_pair_table(table_base, threadIdx.x, kStreamConsumers);
  }
  __syncthreads();

  if (warp == kStreamConsumers / 32) {  // the producer's later fills, one a consumed group
    for (int i = groups; i * G < nu; ++i) {
      mbar_wait(&empty[i % groups], (i / groups - 1) & 1);
      fill(i);
    }
    if constexpr (kNf4) cp_async_wait_all();
    return;
  }

  // Lane (g, c)'s fragment rows g and g + 8 are shared-memory rows
  // rho(g) = 4·(g % 2) + g / 2 and 8 + rho(g) of its tile's 16: a
  // quarter-warp's two rows then differ in bit 2, so their 16-byte chunks
  // (swizzled by row % 8) fill all 32 banks.
  const int tid = threadIdx.x, rt = warp % RT, sub = warp / RT, g = lane >> 2, c = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t table = table_base + ((lane & 15) << 3);
  const int rho = 4 * (g & 1) + (g >> 1);
  const int r0 = 16 * rt + rho;  // this lane's rows of the block: r0 and r0 + 8
  mbar_wait(xbar, 0);

  // (stage, half) pairs of this warp: RT 4: every stage, half `sub`; RT 1:
  // both halves of the stages whose ring slot s has s % 8 == sub, so a slot
  // is always read by one warp, never more than one fill ahead of it (an
  // mbarrier's parity wait cannot tell fill f from fill f - 2): stages <= 8
  // or 16
  const int t_first = RT == 4 ? 0 : sub, t_step = RT == 4 ? 1 : (stages < 8 ? stages : 8);
  for (int t = t_first; t < nu && (RT == 4 || sub < stages); t += t_step) {
    const int s = t % stages;
    mbar_wait(&full[s / G], (t / stages) & 1);
    const uint32_t st = ring + s * kStage;
#pragma unroll
    for (int hh = 0; hh < (RT == 4 ? 1 : 2); ++hh) {
      const int half = RT == 4 ? sub : hh;
      const uint32_t wchunk = static_cast<uint32_t>(((4 * half + c) ^ rho) << 4);
      const uint4 wa = lds128(st + r0 * kStreamUnit + wchunk);        // row r0: bytes 64·half + 16c .. + 15
      const uint4 wb = lds128(st + (r0 + 8) * kStreamUnit + wchunk);  // row r0 + 8
      float ah = 0.f, al = 0.f, bh = 0.f, bl = 0.f;
      if constexpr (kNf4) {
        const uint32_t am = am_base + s * kAmStage + half * (2 * kRows * 4);
        ah = lds32f(am + 4 * r0);
        al = lds32f(am + 4 * (kRows + r0));
        bh = lds32f(am + 4 * (r0 + 8));
        bl = lds32f(am + 4 * (kRows + r0 + 8));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s / G]);  // the half is in registers: once all are, the producer refills
      // x of token g (+ 8j): k 16c .. 16c + 15 of the half's 64-k chunk
      // (NF4: and of the chunk hb further), its 16-byte chunks 2c and 2c + 1
      const int ch = (F::k_of((u0 + t) * kStreamUnit + kUnitBytes * half, wt.hb) - k0) / 64;
      uint32_t xh[NT][8], xl[NT][kNf4 ? 8 : 1];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a = xs + ch * kXRow + (8 * j + g) * 128 + (((2 * c + h) ^ g) << 4);
          const uint4 v = lds128(a);
          xh[j][4 * h] = v.x, xh[j][4 * h + 1] = v.y, xh[j][4 * h + 2] = v.z, xh[j][4 * h + 3] = v.w;
          if constexpr (kNf4) {
            const uint4 u = lds128(a + (wt.hb / 64) * kXRow);
            xl[j][4 * h] = u.x, xl[j][4 * h + 1] = u.y, xl[j][4 * h + 2] = u.z, xl[j][4 * h + 3] = u.w;
          }
        }

      const uint32_t* pa = &wa.x;
      const uint32_t* pb = &wb.x;
#pragma unroll
      for (int q = 0; q < 2 * F::kPieces; ++q) {  // m16n8k16 steps
        uint32_t a[4];
        if constexpr (!kNf4) {
          // word q of the rows' 16 bytes (k 16c + 4q .. + 3): logical k (2c, 2c+1)
          // <- bytes (0, 2), (2c+8, 2c+9) <- bytes (1, 3)
          a[0] = i8pair(pa[q]);
          a[1] = i8pair(pb[q]);
          a[2] = i8pair(pa[q] >> 8);
          a[3] = i8pair(pb[q] >> 8);
        } else {
          // bytes 2q (logical k 2c, 2c+1) and 2q + 1 (2c+8, 2c+9), each its
          // (high, low) nibble pair
          const int sh = 16 * (q & 1);
          a[0] = nf4pair(table, pa[q >> 1] >> sh, ah, al);
          a[1] = nf4pair(table, pb[q >> 1] >> sh, bh, bl);
          a[2] = nf4pair(table, pa[q >> 1] >> (sh + 8), ah, al);
          a[3] = nf4pair(table, pb[q >> 1] >> (sh + 8), bh, bl);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          if constexpr (!kNf4) {  // x pairs (k, k+2) and (k+1, k+3), k = 16c + 4q
            b[0] = prmt(xh[j][2 * q], xh[j][2 * q + 1], 0x5410);
            b[1] = prmt(xh[j][2 * q], xh[j][2 * q + 1], 0x7632);
          } else {  // (x[kh], x[kh + hb]) for bytes 2q and 2q + 1
            b[0] = prmt(xh[j][q], xl[j][q], 0x5410);
            b[1] = prmt(xh[j][q], xl[j][q], 0x7632);
          }
          tt::flash::mma16816<__nv_bfloat16>(acc[j], a, b);
        }
      }
    }
  }

  // the warps' sums (in the ring, once every warp is done with it), added in
  // warp order: the block's f32 result for (token, row)
  named_bar_sync(1, kStreamConsumers);
  const uint32_t red = ring;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), tok = 8 * j + 2 * c + (e & 1);
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(red + 4 * ((sub * kRows + row) * 16 + tok)), "f"(acc[j][e]));
    }
  named_bar_sync(1, kStreamConsumers);
  const int T = 8 * NT;
  auto block_sum = [&](int row, int tok) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kSubs; ++w) v += lds32f(red + 4 * ((w * kRows + row) * 16 + tok));
    return v;
  };
  if (splits == 1) {
    for (int e = tid; e < T * kRows; e += kStreamConsumers) {
      const int tok = e / kRows, row = e % kRows, n = n0 + row;
      if (tok < M && n < N) {
        const float v = block_sum(row, tok);
        y[static_cast<size_t>(tok) * N + n] = __float2bfloat16(kNf4 ? v : v * wt.s[n]);
      }
    }
    return;
  }
  for (int e = tid; e < T * kRows; e += kStreamConsumers) {
    const int tok = e / kRows, row = e % kRows, n = n0 + row;
    if (tok < M && n < N) partial[(static_cast<size_t>(split) * M + tok) * N + n] = block_sum(row, tok);
  }
  if (!last_split(&counters[blockIdx.x], splits, flag, 1, kStreamConsumers, tid == 0)) return;
  combine_splits<1, 16>(partial, y, kNf4 ? nullptr : wt.s, M, N, splits, 0, T, n0, kRows, tid, kStreamConsumers);
  if (tid == 0) counters[blockIdx.x] = 0;
}

// ---------------------------------------------------------------------------
// routes wgmma (bf16 x, 16 < M <= 512) and split (f32 x): wgmma_kernel
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;  // weight rows a tile: two consumer warpgroups of 64
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer warpgroup

template <bool kNf4, int BT, bool kSplit> struct WgCfg {
  static constexpr int kXPieces = kSplit ? kSplitPieces : 1;  // x tiles a k range: one TMA box
  static constexpr int kWPieces = kSplit && kNf4 ? kSplitPieces : 1;  // A fragments a slice
  static constexpr int kXBox = BT * 128;                    // [BT tokens][64 k] bf16, 128-byte swizzle
  static constexpr int kXRange = kXPieces * kXBox;          // a k range's pieces
  static constexpr int kXRanges = kNf4 ? 2 : 1;             // k_of(unit) (and + hb)
  static constexpr int kW = kWgRows * kUnitBytes;           // the weight unit: [128 rows][64 bytes]
  static constexpr int kAm = kNf4 ? 2 * kWgRows * 4 : 0;   // absmax [hi/lo][128 rows]
  static constexpr int kStage = (kXRanges * kXRange + kW + kAm + 1023) / 1024 * 1024;
  static constexpr int kStages = kSplit ? (kNf4 ? 3 : (BT == 16 ? 8 : BT == 128 ? 4 : 6))
                                        : (kNf4 ? (BT == 128 ? 3 : 4) : 6);
  static constexpr int kStgPitch = 144;                     // bytes a token row of the y staging tile
  static constexpr int kStg = kSplit ? 0 : BT * kStgPitch;  // a warpgroup's [BT][64] bf16 staging tile
  static constexpr int kTable = kNf4 ? kTableBytes : 0;
  static constexpr int kBars = kStages * 2 * 8 + 16;
  static constexpr int kSmem = kStages * kStage + 2 * kStg + kTable + kBars + 1024;
  static_assert(kSmem <= 232448, "a wgmma block's shared memory");
};

// The products of a k16 slice: (x piece, w piece) pairs. bf16: (0, 0);
// split int8: x0, x1, x2 against the one fragment; split NF4: i + j <= 2.
template <bool kNf4, bool kSplit> struct Pairs {
  static constexpr int kN = kSplit ? (kNf4 ? 6 : 3) : 1;
  // pair q's x piece and w piece: NF4 (0,0) (0,1) (1,0) (0,2) (1,1) (2,0)
  __host__ __device__ static constexpr int x(int q) { return kNf4 ? (q == 2 || q == 4 ? 1 : q == 5 ? 2 : 0) : q; }
  __host__ __device__ static constexpr int w(int q) { return kNf4 ? (q == 1 || q == 4 ? 1 : q == 3 ? 2 : 0) : 0; }
};

template <bool kNf4, int BT, bool kSplit>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, const Weights wt,
                 std::conditional_t<kSplit, float, __nv_bfloat16>* __restrict__ y, float* __restrict__ partial,
                 int* __restrict__ counters, int M, int N, int splits, int ups) {
  using C = WgCfg<kNf4, BT, kSplit>;
  using F = Fmt<kNf4>;
  using P = Pairs<kNf4, kSplit>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const int stg_off = C::kStages * C::kStage, table_off = stg_off + 2 * C::kStg;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + table_off + C::kTable);
  uint64_t* empty = full + C::kStages;
  int* flag = reinterpret_cast<int*>(empty + C::kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], kNf4 ? 33 : 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int K = wt.K, units = (F::row_bytes(K) + kUnitBytes - 1) / kUnitBytes;
  const int n_m = (M + BT - 1) / BT, tiles = n_m * ((N + kWgRows - 1) / kWgRows), items = tiles * splits;

  if (threadIdx.x >= kWgConsumers) {  // the producer warpgroup: its first warp issues every copy
    setmaxnreg_dec<40>();
    const int pl = threadIdx.x - kWgConsumers;
    if (pl < 32) {
      int f = 0;  // stages filled so far: fill f goes to stage f % kStages
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item % tiles, split = item / tiles;
        const int m0 = (tile % n_m) * BT, n0 = (tile / n_m) * kWgRows;
        const int u0 = split * ups, nu = min(units, u0 + ups) - u0;
        for (int i = 0; i < nu; ++i, ++f) {
          const int s = f % C::kStages;
          if (f >= C::kStages) mbar_wait(&empty[s], (f / C::kStages - 1) & 1);
          unsigned char* st = smem + s * C::kStage;
          const int b = (u0 + i) * kUnitBytes, kh = F::k_of(b, wt.hb);
          if constexpr (kNf4) {
            const int ghi = kh / 64, glo = ghi + wt.hb / 64, G = K / 64;
            const uint32_t dst = sb + s * C::kStage + C::kXRanges * C::kXRange + C::kW;
#pragma unroll
            for (int e = pl; e < 2 * kWgRows; e += 32) {
              const int n = n0 + (e % kWgRows);
              const float* src = wt.s + static_cast<size_t>(n < N ? n : 0) * G + (e < kWgRows ? ghi : glo);
              cp_async4(dst + 4 * e, src, n < N ? 4 : 0);
            }
            cp_async_arrive(&full[s]);
          }
          if (pl == 0) {
            mbar_expect_tx(&full[s], C::kXRanges * C::kXRange + C::kW);
            tma_load_3d(st, &tm_x, &full[s], kh, m0, 0);  // the k range's pieces, one tile each
            if constexpr (kNf4) tma_load_3d(st + C::kXRange, &tm_x, &full[s], kh + wt.hb, m0, 0);
            tma_load_3d(st + C::kXRanges * C::kXRange, &tm_w, &full[s], b, n0, 0);
          }
        }
      }
      if constexpr (kNf4) cp_async_wait_all();
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  if constexpr (kNf4) {
    build_pair_table(sb + table_off, threadIdx.x, kWgConsumers);
    named_bar_sync(1, kWgConsumers);
  }
  const uint32_t table = sb + table_off + ((lane & 15) << 3);
  // int8: bytes 2c and 2c+1 of two words to positions 0 and 2 (i8pair's);
  // NF4: to positions 0 and 1
  const uint32_t sel = kNf4 ? ((2 * c) | ((2 * c + 1) << 4)) : ((2 * c) | ((2 * c + 1) << 8));
  const int rl = 64 * wg + 16 * warp + g;  // this lane's rows of the tile: rl and rl + 8
  constexpr int kAcc = BT / 2;
  // A registers a k16 slice: 4 a fragment, [w piece][high / low slice (NF4)][4]
  constexpr int kA = 4 * (kNf4 ? 2 : 1) * C::kWPieces;
  const uint32_t stg = sb + stg_off + wg * C::kStg;

  int f = 0;  // stages consumed so far
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int m0 = (tile % n_m) * BT, n0 = (tile / n_m) * kWgRows;
    const int nu = min(units, split * ups + ups) - split * ups;
    float acc[kAcc];
    // split: a unit's products land in `part` (its first overwrites), then
    // join acc by FADD: the tensor cores' own sums of a long chain of
    // products keep fewer bits than an f32 add (header note)
    float part[kSplit ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kSplit ? kAcc : 1); ++i) part[i] = 0.f;
    uint32_t A[2][kA] = {};
    int pend = -1;  // the stage whose products may still run
    for (int i = 0; i < nu; ++i, ++f) {
      const int s = f % C::kStages;
      mbar_wait(&full[s], (f / C::kStages) & 1);
      const uint32_t st = sb + s * C::kStage;
      const uint32_t wr = st + C::kXRanges * C::kXRange + rl * kUnitBytes;
      float ah = 0.f, al = 0.f, bh = 0.f, bl = 0.f;
      if constexpr (kNf4) {
        const uint32_t am = st + C::kXRanges * C::kXRange + C::kW;
        ah = lds32f(am + 4 * rl);
        al = lds32f(am + 4 * (kWgRows + rl));
        bh = lds32f(am + 4 * (rl + 8));
        bl = lds32f(am + 4 * (kWgRows + rl + 8));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // 16-byte slices of the unit: k16 slice j (NF4: and its low half)
        const uint4 ra = lds128(wr + 16 * j), rb = lds128(wr + 8 * kUnitBytes + 16 * j);
        uint32_t(&a)[kA] = A[j & 1];
        if constexpr (!kNf4) {
          a[0] = i8pair(prmt(ra.x, ra.y, sel));  // row rl, k 2c, 2c+1
          a[1] = i8pair(prmt(rb.x, rb.y, sel));  // row rl + 8
          a[2] = i8pair(prmt(ra.z, ra.w, sel));  // row rl, k 2c+8, 2c+9
          a[3] = i8pair(prmt(rb.z, rb.w, sel));
        } else {
          // bytes 2c, 2c+1 and 2c+8, 2c+9: their high nibbles make the high
          // slice's fragment (a[8p + 0..3]), their low nibbles the low slice's
          // (a[8p + 4..7]), p the w piece
          const uint32_t va = prmt(ra.x, ra.y, sel), vb = prmt(rb.x, rb.y, sel);
          const uint32_t wa = prmt(ra.z, ra.w, sel), wb = prmt(rb.z, rb.w, sel);
          const uint32_t src[4] = {va, vb, wa, wb};
          const float hi[4] = {ah, bh, ah, bh}, lo[4] = {al, bl, al, bl};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 e0 = lds64f(table + ((src[r] & 0xFFu) << 7));
            const float2 e1 = lds64f(table + (((src[r] >> 8) & 0xFFu) << 7));
            uint32_t h[C::kWPieces], l[C::kWPieces];
            // w = code · absmax rounded in f32 (__fmul_rn: never contracted into
            // the pieces' subtractions), as the plain version's weight
            split_pair(__fmul_rn(e0.x, hi[r]), __fmul_rn(e1.x, hi[r]), h);
            split_pair(__fmul_rn(e0.y, lo[r]), __fmul_rn(e1.y, lo[r]), l);
#pragma unroll
            for (int p = 0; p < C::kWPieces; ++p) {
              a[8 * p + r] = h[p];
              a[8 * p + 4 + r] = l[p];
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int half = 0; half < C::kXRanges; ++half)
#pragma unroll
          for (int q = 0; q < P::kN; ++q) {
            const int o = 8 * P::w(q) + 4 * half;  // the fragment of w piece w(q) (NF4: of this half)
            const uint32_t af[4] = {a[o], a[o + 1], a[o + 2], a[o + 3]};
            const uint32_t xt = st + half * C::kXRange + P::x(q) * C::kXBox + 32 * j;
            if constexpr (kSplit) {
              wgmma_rs<0>(part, af, desc_sw128(xt, 16, 1024), j + half + q > 0 ? 1 : 0, __nv_bfloat16{});
            } else {
              wgmma_rs<0>(acc, af, desc_sw128(xt, 16, 1024), __nv_bfloat16{});
            }
          }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done: its fragment buffer is free
#pragma unroll
        for (int i = 0; i < kA; ++i) asm volatile("" : "+r"(A[(j & 1) ^ 1][i])::"memory");
        if (j == 0 && pend >= 0) mbar_arrive(&empty[pend]);
      }
      if constexpr (kSplit) {  // the unit's products into the f32 sums (the other warpgroup's run meanwhile)
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
      }
      pend = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pend >= 0) mbar_arrive(&empty[pend]);

    // element i of acc: row rl + 8·((i >> 1) & 1) of the tile, token 8·(i >> 2) + 2c + (i & 1)
    if (splits == 1) {
      float sc[2] = {1.f, 1.f};
      if constexpr (!kNf4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) sc[h] = n0 + rl + 8 * h < N ? wt.s[n0 + rl + 8 * h] : 0.f;
      }
      if constexpr (kSplit) {  // f32 y from the accumulators: 8 columns (32 bytes) of 4 rows a store
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int h = (i >> 1) & 1, tok = m0 + 8 * (i >> 2) + 2 * c + (i & 1), n = n0 + rl + 8 * h;
          if (tok < M && n < N) y[static_cast<size_t>(tok) * N + n] = acc[i] * sc[h];
        }
      } else {
        named_bar_sync(2 + wg, 128);  // the previous tile's rows have left the staging tile
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int h = (i >> 1) & 1, t = 8 * (i >> 2) + 2 * c + (i & 1);
          const __nv_bfloat16 v = __float2bfloat16(acc[i] * sc[h]);
          sts16(stg + t * C::kStgPitch + 2 * (16 * warp + g + 8 * h), *reinterpret_cast<const uint16_t*>(&v));
        }
        named_bar_sync(2 + wg, 128);
        const int nw = n0 + 64 * wg;  // this warpgroup's 64 columns of y
        for (int e = tid; e < BT * 8; e += 128) {
          const int t = e >> 3, q = e & 7, tok = m0 + t, n = nw + 8 * q;
          if (tok >= M || n >= N) continue;
          const uint4 v = lds128(stg + t * C::kStgPitch + 16 * q);
          __nv_bfloat16* dst = y + static_cast<size_t>(tok) * N + n;
          if ((N & 7) == 0 && n + 8 <= N) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
            for (int i = 0; i < 8 && n + i < N; ++i) dst[i] = h[i];
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int tok = m0 + 8 * (i >> 2) + 2 * c + (i & 1), n = n0 + rl + 8 * ((i >> 1) & 1);
        if (tok < M && n < N) partial[(static_cast<size_t>(split) * M + tok) * N + n] = acc[i];
      }
      if (last_split(&counters[tile], splits, flag, 1, kWgConsumers, threadIdx.x == 0)) {
        combine_splits<4, 4>(partial, y, kNf4 ? nullptr : wt.s, M, N, splits, m0, BT, n0, kWgRows, threadIdx.x,
                             kWgConsumers);
        if (threadIdx.x == 0) counters[tile] = 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// What cudaex.weight_only_plan chose for a call: the route, the weight rows a
// block (stream: 16 or 64; wgmma and split: 128), the tokens a tile (stream: 8
// or 16; wgmma and split: 64 or 128), the K splits and units a split, the
// persistent blocks (wgmma, split), and the stages (checked against the
// kernel's).
struct Plan {
  int route, rows, tile_m, splits, ups, grid, stages;
};

// Raises the kernel's dynamic shared-memory limit to `bytes` once (a static
// for each kernel).
template <auto kKernel> int allow_smem(int bytes) {
  static int allowed = 0;
  if (bytes <= allowed) return 0;
  const int e = static_cast<int>(cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (!e) allowed = bytes;
  return e;
}

// A (rows, row_bytes) row-major tensor of `type` (UINT8 or BFLOAT16) viewed
// as [row_bytes / 128 chunks][rows][128 bytes] and moved in boxes of
// `box_chunks` chunks of `box_rows` rows with the 128-byte swizzle: a box
// lands as box_chunks [box_rows][128 bytes] tiles one after the other (x:
// the block's k range; W: a group of ring stages). Out-of-range rows and
// chunks read as zero. row_bytes must be a multiple of 128.
inline int make_chunks_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int row_bytes, int rows,
                           int box_rows, int box_chunks) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[3] = {128 / size, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(row_bytes / 128)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes), 128};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / size), static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_chunks)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A stream launch: grid (ceil(N / (16·RT)), splits).
template <bool kNf4, int NT, int RT>
int launch_stream(const CUtensorMap& mw, const CUtensorMap& mx, const Weights& wt, __nv_bfloat16* y, float* partial,
                  int* counters, int M, int N, const Plan& p, cudaStream_t stream) {
  const int smem = stream_smem(kNf4, NT, RT, p.stages, p.ups);
  const int e = allow_smem<stream_kernel<kNf4, NT, RT>>(smem);
  if (e) return e;
  stream_kernel<kNf4, NT, RT><<<dim3((N + 16 * RT - 1) / (16 * RT), p.splits), kStreamThreads, smem, stream>>>(
      mw, mx, wt, y, partial, counters, M, N, p.ups, p.stages);
  return static_cast<int>(cudaGetLastError());
}

// A wgmma or split launch: p.grid persistent blocks.
template <bool kNf4, int BT, bool kSplit, class OutT>
int launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw, const Weights& wt, OutT* y, float* partial,
                 int* counters, int M, int N, const Plan& p, cudaStream_t stream) {
  using C = WgCfg<kNf4, BT, kSplit>;
  if (p.stages != C::kStages) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem<wgmma_kernel<kNf4, BT, kSplit>>(C::kSmem);
  if (e) return e;
  wgmma_kernel<kNf4, BT, kSplit><<<p.grid, kWgThreads, C::kSmem, stream>>>(mx, mw, wt, y, partial, counters, M, N,
                                                                           p.splits, p.ups);
  return static_cast<int>(cudaGetLastError());
}

// The plan's K splits cover the row's units, none empty, with scratch where
// there are two or more.
template <bool kNf4>
bool splits_ok(const Weights& wt, const Plan& p, int unit, const float* partial, const int* counters) {
  const int units = (Fmt<kNf4>::row_bytes(wt.K) + unit - 1) / unit;
  return p.splits >= 1 && p.ups >= 1 && static_cast<long long>(p.splits) * p.ups >= units &&
         static_cast<long long>(p.splits - 1) * p.ups < units &&
         (p.splits == 1 || (partial != nullptr && counters != nullptr));
}

template <bool kNf4>
int launch_bf16(const __nv_bfloat16* x, const Weights& wt, __nv_bfloat16* y, float* partial, int* counters, int M,
                int N, const Plan& p, cudaStream_t stream) {
  if (!splits_ok<kNf4>(wt, p, p.route == kRouteStream ? kStreamUnit : kUnitBytes, partial, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mw, mx;
  if (p.route == kRouteStream) {  // tile_m: 8 or 16 tokens; rows: 16 or 64 a block
    const int chunks = stream_x_chunks(kNf4, p.ups);
    if (p.stages < 1 || p.stages > kStreamMaxStages || (p.rows == 16 && p.stages > 8 && p.stages != 16) ||
        p.stages % stream_group(p.stages) || (p.tile_m != 8 && p.tile_m != 16) || M > p.tile_m ||
        (p.rows != 16 && p.rows != 64) || chunks > 256 || Fmt<kNf4>::row_bytes(wt.K) % kStreamUnit ||
        (kNf4 && p.splits > 1 && (p.ups * kStreamUnit) % wt.hb))
      return static_cast<int>(cudaErrorInvalidValue);
    int e = make_chunks_map(&mw, wt.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, Fmt<kNf4>::row_bytes(wt.K), N, p.rows,
                            stream_group(p.stages));
    if (!e) e = make_chunks_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2 * wt.K, M, p.tile_m, chunks);
    if (e) return e;
    if (p.tile_m == 8)
      return p.rows == 16 ? launch_stream<kNf4, 1, 1>(mw, mx, wt, y, partial, counters, M, N, p, stream)
                          : launch_stream<kNf4, 1, 4>(mw, mx, wt, y, partial, counters, M, N, p, stream);
    return p.rows == 16 ? launch_stream<kNf4, 2, 1>(mw, mx, wt, y, partial, counters, M, N, p, stream)
                        : launch_stream<kNf4, 2, 4>(mw, mx, wt, y, partial, counters, M, N, p, stream);
  }
  if (p.route != kRouteWgmma || p.rows != kWgRows || (p.tile_m != 64 && p.tile_m != 128) || p.grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = make_map_rows(&mw, wt.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, Fmt<kNf4>::row_bytes(wt.K), N, kUnitBytes, kWgRows);
  if (!e) e = make_map_3d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wt.K, M, 1, p.tile_m);
  if (e) return e;
  return p.tile_m == 64 ? launch_wgmma<kNf4, 64, false>(mx, mw, wt, y, partial, counters, M, N, p, stream)
                        : launch_wgmma<kNf4, 128, false>(mx, mw, wt, y, partial, counters, M, N, p, stream);
}

// The split route: the pass that writes x's pieces into `pieces` (3, M, K)
// bf16, then the product over them in 64-token tiles (int8: 16, 64 or 128).
template <bool kNf4>
int launch_split(const float* x, __nv_bfloat16* pieces, const Weights& wt, float* y, float* partial, int* counters,
                 int M, int N, const Plan& p, cudaStream_t stream) {
  if (!splits_ok<kNf4>(wt, p, kUnitBytes, partial, counters) || p.route != kRouteSplit || p.rows != kWgRows ||
      (p.tile_m != 64 && (kNf4 || (p.tile_m != 16 && p.tile_m != 128))) || p.grid < 1 || pieces == nullptr ||
      wt.K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(M) * wt.K / 4;
  const long long blocks = (n4 + 255) / 256;
  split_x_kernel<><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint2*>(pieces), n4);
  int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  CUtensorMap mw, mx;
  e = make_map_rows(&mw, wt.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, Fmt<kNf4>::row_bytes(wt.K), N, kUnitBytes, kWgRows);
  // a box: the three pieces' [tile_m tokens][64 k] tiles, one after the other
  if (!e) e = make_map_3d(&mx, pieces, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wt.K, M, kSplitPieces, p.tile_m,
                          kSplitPieces);
  if (e) return e;
  if constexpr (kNf4) {
    return launch_wgmma<true, 64, true>(mx, mw, wt, y, partial, counters, M, N, p, stream);
  } else {
    if (p.tile_m == 16) return launch_wgmma<false, 16, true>(mx, mw, wt, y, partial, counters, M, N, p, stream);
    return p.tile_m == 64 ? launch_wgmma<false, 64, true>(mx, mw, wt, y, partial, counters, M, N, p, stream)
                          : launch_wgmma<false, 128, true>(mx, mw, wt, y, partial, counters, M, N, p, stream);
  }
}

}  // namespace wol
}  // namespace tt
