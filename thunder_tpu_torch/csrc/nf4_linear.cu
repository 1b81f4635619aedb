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
// 9.4 MB, ~2.8 µs). Decoding costs instructions — a table lookup and a
// multiply for each weight — so at small M the decode, not the product,
// is the arithmetic to keep cheap.
//
// What the design does about that (weight_only_linear.cuh): each weight
// byte is read once by a 16-byte streaming load that yields two groups of
// 16 weights (the high nibbles at k, the low at k + block_k/2; the 16 k of a
// group share one absmax). The 16-entry codebook sits in shared memory, one
// entry a bank, so a warp's lookups never conflict. The TPU kernel's select
// tree and 0/1 expander product were workarounds for Mosaic's missing
// gather and repeat; here a lookup is one shared load and absmax one
// multiply. Decoded weights go straight into mma.sync operands (bf16) or
// FMAs (f32).

#include "weight_only_linear.cuh"

namespace {

__constant__ float kNf4Code[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

__shared__ float code_s[16];

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
    if (threadIdx.x < 16) code_s[threadIdx.x] = kNf4Code[threadIdx.x];
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
// (M, N) like x; all contiguous and 16-byte aligned. Returns the launch's
// cudaGetLastError().
extern "C" int tt_nf4_linear(const void* x, const void* packed, const void* absmax, void* y, int M,
                             int N, int K, int block_k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_k % 256 != 0 || K % block_k != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Nf4Weights w{static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax), K,
                     block_k / 2};
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
