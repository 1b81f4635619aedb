// Weight-only NF4 linear for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:nf4_linear (:1605, kernel
// _nf4_linear_kernel :1578). Computes y (M, N) = x (M, K) · Wᵀ with W[n, k]
// = NF4_CODE[code] · absmax[n, k / 64] taken in f32 and rounded to x's dtype,
// the product summed in f32 and rounded once to x's dtype.
//
// Weights arrive in the kernel layout (transforms/quantization.py:
// pack_nf4_kernel_layout): packed (N, K/2) uint8 where, within each block_k
// slice of a row (block_k 256 or 512), byte j holds column j in its high
// nibble and column j + block_k/2 in its low nibble; absmax (N, K/64) f32.
//
// What bounds it: bytes, at decode shapes: 0.5625 bytes a weight (codes and
// absmax), a quarter of a bf16 linear's (Llama-3-1B fc_1, 8192 x 2048:
// 9.4 MB, ~2.8 µs). Decoding costs instructions and shared-memory loads —
// a table lookup and a multiply for each weight — so at small M the decode,
// not the product, is the arithmetic to keep cheap; at a 512-row prefill
// bucket the product's operations bound it.
//
// What the design does about that (weight_only_linear.cuh, routes chosen by
// cudaex.weight_only_plan): decode streams each block's code bytes through a
// TMA-fed ring (and their absmax by cp.async), x staged once a block; a
// 256-entry table of code pairs in shared memory, one copy for each of 16
// lanes so lookups never conflict, turns a byte into its two weights with one
// 8-byte load, two multiplies and one bf16x2 rounding (3 instructions a
// weight, against 4.5 for the kernel this replaces). A byte's nibbles (k and
// k + block_k/2, in different 64-groups) are one fragment pair of the swapped
// mma.sync product yᵀ = W · xᵀ, with x paired to match. Prefill runs the
// persistent TMA/wgmma product with the decoded weights as register A
// operands and two x tiles (k and k + block_k/2) as B. The TPU kernel's
// select tree and 0/1 expander product were workarounds for Mosaic's missing
// gather and repeat.
//
// f32 x (quant_train's frozen mlp.proj under autocast, the f32 agreement
// paths) takes the `split` route above M = 16. What bounded it: f32 FMAs (67
// TFLOP/s; the FMA kernel, which keeps M <= 16, reached 12.3 at M = 512),
// since tf32 products would round x to 11 bits. A pass splits x into three
// bf16 pieces (weight_only_linear.cuh's header note); each decoded weight w =
// code · absmax, taken in f32 as the plain version takes it, is split in
// registers into three pieces the same way, and the bf16 tensor cores sum
// the six exact products x_i · w_j with i + j <= 2 in f32. The three dropped
// ones are each at most 2^-24 of |x·w| (2^-23 in all), about the one f32
// rounding the plain version makes of each product. Six x tiles a stage and
// the pair table fit beside three stages at 64-token tiles, not 128.

#include "weight_only_linear.cuh"

namespace {

__shared__ float code_s[16];

// route fma's format policy
struct Nf4Weights {
  static constexpr int kChunkK = 128;  // 4 lanes x 16 bytes x 2 nibbles
  static constexpr int kGroups = 2;
  const uint8_t* packed;
  const float* absmax;
  int K;
  int half_bk;  // block_k / 2: bytes of one slice of a row

  struct Raw {
    uint4 v;
    float am[2];
  };

  __device__ __forceinline__ void init() const {
    if (threadIdx.x < 16) code_s[threadIdx.x] = tt::wol::kNf4Code[threadIdx.x];
  }

  // the first k of group g (0: high nibbles, 1: low nibbles) of lane_k's
  // 16 bytes in chunk c
  __device__ __forceinline__ int group_k(int c, int lane_k, int g) const {
    const int b = c * (kChunkK / 2) + 16 * lane_k;  // byte offset in the row
    return (b / half_bk) * 2 * half_bk + b % half_bk + g * half_bk;
  }

  __device__ __forceinline__ void load(Raw& r, int n, int c, int lane_k) const {
    r.v = make_uint4(0u, 0u, 0u, 0u);
    r.am[0] = r.am[1] = 0.f;
    if (n < 0) return;
    const size_t row = static_cast<size_t>(n);
    const int b = c * (kChunkK / 2) + 16 * lane_k;
    r.v = __ldcs(reinterpret_cast<const uint4*>(packed + row * (K / 2) + b));
    r.am[0] = __ldcs(absmax + row * (K / 64) + group_k(c, lane_k, 0) / 64);
    r.am[1] = __ldcs(absmax + row * (K / 64) + group_k(c, lane_k, 1) / 64);
  }

  __device__ __forceinline__ void decode(const Raw& r, int g, float (&w)[16]) const {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&r.v);
    const int shift = g == 0 ? 4 : 0;
    const float am = r.am[g];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = code_s[(b[i] >> shift) & 0xF] * am;
  }

  __device__ __forceinline__ float epilogue(float acc, int) const { return acc; }
};

}  // namespace

// x (M, K) f32 or bf16, packed (N, K/2) uint8 in the kernel layout of
// slice width block_k (256 or 512, dividing K), absmax (N, K/64) f32, y
// (M, N) like x; all contiguous and 16-byte aligned. route, rows, tile_m,
// splits, units_per_split, grid and stages are cudaex.weight_only_plan's;
// partial (splits, M, N) f32 and counters (one a tile, zero) where the plan
// splits K, else null; pieces (3, M, K) bf16 scratch for the split route (f32
// x; the fma route reads none of the plan but its route). Returns the first
// failing launch's cudaGetLastError().
extern "C" int tt_nf4_linear(const void* x, const void* packed, const void* absmax, void* y, void* partial,
                             void* counters, void* pieces, int M, int N, int K, int block_k, int dtype, int route,
                             int rows, int tile_m, int splits, int units_per_split, int grid, int stages,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k % 256 != 0 || K % block_k != 0) return static_cast<int>(cudaErrorInvalidValue);
  const tt::wol::Weights w{static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax), K, block_k / 2};
  const tt::wol::Plan p{route, rows, tile_m, splits, units_per_split, grid, stages};
  if (dtype == tt::kF32 && route == tt::wol::kRouteFma) {
    const Nf4Weights f{static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax), K, block_k / 2};
    return tt::wol::launch_f32(static_cast<const float*>(x), f, static_cast<float*>(y), M, N, K, s);
  }
  if (dtype == tt::kF32)
    return tt::wol::launch_split<true>(static_cast<const float*>(x), static_cast<__nv_bfloat16*>(pieces), w,
                                       static_cast<float*>(y), static_cast<float*>(partial),
                                       static_cast<int*>(counters), M, N, p, s);
  if (dtype != tt::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return tt::wol::launch_bf16<true>(static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y),
                                    static_cast<float*>(partial), static_cast<int*>(counters), M, N, p, s);
}
