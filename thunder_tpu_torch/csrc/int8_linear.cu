// Weight-only int8 linear for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:int8_linear (:1318, kernel
// _int8_linear_kernel :1303). Computes y (M, N) = (x (M, K) · q (N, K)ᵀ) ·
// scale (N,) — int8 weights widened to x's dtype, the product summed in f32,
// the f32 per-row scale applied to the sum, one rounding to x's dtype (the
// TPU kernel's order; the reference decomposition instead dequantizes to
// bf16 before the product).
//
// What bounds it: bytes at decode shapes, operations at prefill ones. At M =
// 8 a weight byte feeds 2·M = 16 operations, against the ~295 operations a
// byte of device memory that the bf16 tensor cores can do, so the time is the
// weights' N·K bytes over the memory rate (Llama-3-1B fc_1, 8192 x 2048:
// 16.8 MB, ~5 µs); keeping the weights int8 halves a bf16 linear's bytes. At
// a 512-row prefill bucket the same product is bound by operations (17 µs
// at fc_1).
//
// What the design does about that (weight_only_linear.cuh, routes chosen by
// cudaex.weight_only_plan): decode streams every weight byte once through a
// TMA-fed ring in every block (16-row blocks whose warps split K for the
// narrow layers, 64-row blocks for lm_head; K split across blocks only where
// x would not fit, at K = 8192), x staged once a block by one TMA box; the
// weights are widened exactly by integer masks and one bf16x2 FMA into the A
// operand of mma.sync, with the 8 or 16 tokens as the product's n. Prefill
// runs a persistent TMA/wgmma product with the widened weights as register A
// operands and x's tile as B. The scale is applied once to the f32 sum (after
// any K splits are summed in split order). f32 x keeps the FMA kernel.

#include "weight_only_linear.cuh"

namespace {

// route f32's format policy
struct Int8Weights {
  static constexpr int kChunkK = 64;  // 4 lanes x 16 k
  static constexpr int kGroups = 1;
  const int8_t* q;
  const float* scale;
  int K;

  struct Raw {
    uint4 v;
  };

  __device__ __forceinline__ void init() const {}

  __device__ __forceinline__ int group_k(int c, int lane_k, int) const {
    return c * kChunkK + 16 * lane_k;
  }

  __device__ __forceinline__ void load(Raw& r, int n, int c, int lane_k) const {
    const int k = group_k(c, lane_k, 0);
    r.v = make_uint4(0u, 0u, 0u, 0u);
    if (n >= 0 && k < K) r.v = __ldcs(reinterpret_cast<const uint4*>(q + static_cast<size_t>(n) * K + k));
  }

  __device__ __forceinline__ void decode(const Raw& r, int, float (&w)[16]) const {
    const int8_t* b = reinterpret_cast<const int8_t*>(&r.v);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = static_cast<float>(b[i]);
  }

  __device__ __forceinline__ float epilogue(float acc, int n) const { return acc * scale[n]; }
};

}  // namespace

// x (M, K) f32 or bf16, q (N, K) int8, scale (N,) f32, y (M, N) like x; all
// contiguous and 16-byte aligned, K a multiple of 16. route, rows, tile_m,
// splits, units_per_split, grid and stages are cudaex.weight_only_plan's (f32
// x: route 0, the rest unread); partial (splits, M, N) f32 and counters (one
// a tile, zero) where the wgmma route splits K, else null. Returns the
// launch's cudaGetLastError().
extern "C" int tt_int8_linear(const void* x, const void* q, const void* scale, void* y, void* partial,
                              void* counters, int M, int N, int K, int dtype, int route, int rows, int tile_m,
                              int splits, int units_per_split, int grid, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kF32 && route == tt::wol::kRouteF32) {
    const Int8Weights w{static_cast<const int8_t*>(q), static_cast<const float*>(scale), K};
    return tt::wol::launch_f32(static_cast<const float*>(x), w, static_cast<float*>(y), M, N, K, s);
  }
  if (dtype != tt::kBF16 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const tt::wol::Weights w{static_cast<const uint8_t*>(q), static_cast<const float*>(scale), K, 0};
  const tt::wol::Plan p{route, rows, tile_m, splits, units_per_split, grid, stages};
  return tt::wol::launch_bf16<false>(static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y),
                                     static_cast<float*>(partial), static_cast<int*>(counters), M, N, p, s);
}
