// Weight-only int8 linear for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:int8_linear (:1318, kernel
// _int8_linear_kernel :1303). Computes y (M, N) = (x (M, K) · q (N, K)ᵀ) ·
// scale (N,) — int8 weights widened to x's dtype, the product summed in f32,
// the f32 per-row scale applied to the sum, one rounding to x's dtype (the
// TPU kernel's order; the reference decomposition instead dequantizes to
// bf16 before the product).
//
// What bounds it: bytes, at decode shapes. At M = 8 a weight byte feeds 2·M
// = 16 operations, against the ~295 operations a byte of device memory
// that the bf16 tensor cores can do, so the time is the weights' N·K bytes
// over the memory rate (Llama-3-1B fc_1, 8192 x 2048: 16.8 MB, ~5 µs). Keeping the
// weights int8 in device memory halves the bytes of a bf16 linear. At a
// 512-row prefill the same product is bound by operations.
//
// What the design does about that (weight_only_linear.cuh): every weight
// byte is read once, by one 16-byte streaming load, and widened in
// registers straight into mma.sync operands (no shared-memory staging);
// the next chunk's weight loads are issued before the current chunk's
// products. A block owns 16 columns and its 8 warps split K, so a 2048-row
// layer still spreads over 128 blocks; x (M rows, at most 512) is read from
// L1/L2. The scale is applied once, in the epilogue. Later work: wgmma with
// TMA-fed tiles, split-K across blocks for narrow layers.

#include "weight_only_linear.cuh"

namespace {

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
// contiguous and 16-byte aligned, K a multiple of 16. Returns the launch's
// cudaGetLastError().
extern "C" int tt_int8_linear(const void* x, const void* q, const void* scale, void* y, int M, int N,
                              int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Int8Weights w{static_cast<const int8_t*>(q), static_cast<const float*>(scale), K};
  switch (dtype) {
    case tt::kF32:
      return tt::wol::launch(static_cast<const float*>(x), w, static_cast<float*>(y), M, N, K, s);
    case tt::kBF16:
      return tt::wol::launch(static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y), M,
                             N, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
