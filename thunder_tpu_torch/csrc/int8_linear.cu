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
// any K splits are summed in split order).
//
// f32 x (quant_train's frozen fc_1/fc_2 under autocast, the f32 agreement
// paths) takes the `split` route. What bounded it: f32 FMAs (67 TFLOP/s; the
// FMA kernel this replaces reached 11.6 at M = 512), since tf32 products
// would round x to 11 bits. A code is exact in bf16 and x is the exact sum of
// three bf16 pieces (weight_only_linear.cuh's header note), so the bf16
// tensor cores form the three products x0·q, x1·q and x2·q exactly and sum
// them in f32: one decode of each k16 slice of codes, three wgmmas against
// the pieces' tiles, the scale once to the f32 sum.

#include "weight_only_linear.cuh"

// x (M, K) f32 or bf16, q (N, K) int8, scale (N,) f32, y (M, N) like x; all
// contiguous and 16-byte aligned, K a multiple of 16. route, rows, tile_m,
// splits, units_per_split, grid and stages are cudaex.weight_only_plan's;
// partial (splits, M, N) f32 and counters (one a tile, zero) where the plan
// splits K, else null; pieces (3, M, K) bf16 scratch for the split route (f32
// x), else null. Returns the first failing launch's cudaGetLastError().
extern "C" int tt_int8_linear(const void* x, const void* q, const void* scale, void* y, void* partial,
                              void* counters, void* pieces, int M, int N, int K, int dtype, int route, int rows,
                              int tile_m, int splits, int units_per_split, int grid, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const tt::wol::Weights w{static_cast<const uint8_t*>(q), static_cast<const float*>(scale), K, 0};
  const tt::wol::Plan p{route, rows, tile_m, splits, units_per_split, grid, stages};
  if (dtype == tt::kF32)
    return tt::wol::launch_split<false>(static_cast<const float*>(x), static_cast<__nv_bfloat16*>(pieces), w,
                                        static_cast<float*>(y), static_cast<float*>(partial),
                                        static_cast<int*>(counters), M, N, p, s);
  if (dtype != tt::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  return tt::wol::launch_bf16<false>(static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y),
                                     static_cast<float*>(partial), static_cast<int*>(counters), M, N, p, s);
}
