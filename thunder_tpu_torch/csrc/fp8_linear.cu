// Delayed-scaling fp8 linear for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:fp8_linear_fused (:1447, kernel
// _fp8_matmul_kernel :1399). For x (M, K) and w (N, K), each f32 or bf16,
// and the delayed scales sx, sw (f32 scalars in device memory):
//
//   xq = e4m3(clip(f32(x)·sx, ±fmt_max)),  wq = e4m3(clip(f32(w)·sw, ±fmt_max))
//   y  = (Σ_k f32(xq)·f32(wq)) / (sx·sw), rounded once to x's dtype
//   amax[0] = max|x|, amax[1] = max|w|   (of the unquantized operands)
//
// and, when asked, writes the e4m3 codes xq (M, K) and wq (N, K) (the
// residuals the backward reads). The casts round to nearest even and
// saturate, after the clip, so the codes are those of torch's and jnp's
// astype; the epilogue divides by the product of the scales, as the
// reference does (not a multiply by its reciprocal).
//
// What bounds it: at the training path's shapes (M = 8192 tokens) the
// product is bound by operations at the card's fp8 rate, and the bytes (x
// and an f32 w read once, y and the codes written once) take about as long
// (PERF.md). Two costs sit on top: every block quantizes the x and w tiles
// it reads (ALU work that the tensor cores do not hide), and a block of the
// first tile column (row) also writes its xq (wq) tile.
//
// Design (a first, simple kernel): 128 x 128 output tiles, 8 warps, each
// warp 64 x 32 of them. K advances 32 at a time: the next raw x and w tiles
// are loaded into registers while the tensor cores multiply the current
// e4m3 tiles from shared memory (two stages); then the raw tiles are
// scaled, clipped, converted and stored as the other stage. The products
// are `mma.sync.m16n8k32.row.col.f32.e4m3.e4m3.f32`: both operands are
// K-contiguous, which is the row.col layout, so no transpose. Hopper's fp8
// tensor-core accumulation keeps fewer bits than f32, so every k32 product
// starts from a zero fragment and is added into the f32 accumulators in
// registers (promotion every 32 k). The amaxes are reduced per thread,
// warp and block, then one atomicMax per block on the float's bits
// (non-negative floats order as unsigned ints); the wrapper zeroes them on
// the stream first. Only the first tile column reduces x's amax and writes
// xq, only the first tile row w's, so no code is written twice. Later work:
// wgmma with TMA-fed tiles, and quantizing w once per call instead of once
// per row of tiles.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
// Shared row stride in bytes: 48 puts the eight rows a fragment load
// touches in eight different bank quads.
constexpr int LDS = BK + 16;

__device__ __forceinline__ float clip(float v, float fmt_max) { return fminf(fmaxf(v, -fmt_max), fmt_max); }

__device__ __forceinline__ uint32_t e4m3x4(float a, float b, float c, float d) {
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(c, d), __NV_SATFINITE, __NV_E4M3);
  return lo | (hi << 16);
}

// One operand's BM x BK tile (BM == BN): loaded raw into registers, then
// quantized into a shared stage. Thread i loads 16 bytes of row i / VPR.
template <typename T> struct Tile {
  static constexpr int V = 16 / sizeof(T);   // elements a 16-byte load
  static constexpr int VPR = BK / V;         // loads a row
  static constexpr int RPP = THREADS / VPR;  // rows a pass
  static constexpr int PASSES = BM / RPP;
  uint4 raw[PASSES];

  __device__ __forceinline__ void load(const T* __restrict__ src, int rows, int r0, int K, int k0) {
    const int r = threadIdx.x / VPR, c = threadIdx.x % VPR;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = r0 + p * RPP + r;
      raw[p] = row < rows ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * K + k0 + c * V)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // codes != nullptr: also write this tile's codes to codes (rows, K).
  __device__ __forceinline__ void quantize(uint8_t* stage, uint8_t* codes, int rows, int r0, int K,
                                           int k0, float s, float fmt_max, float& amax) const {
    const int r = threadIdx.x / VPR, c = threadIdx.x % VPR;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const T* e = reinterpret_cast<const T*>(&raw[p]);
      float f[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[i] = tt::to_f32(e[i]);
        amax = fmaxf(amax, fabsf(f[i]));
      }
      uint32_t q[V / 4];
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        q[i] = e4m3x4(clip(f[4 * i] * s, fmt_max), clip(f[4 * i + 1] * s, fmt_max), clip(f[4 * i + 2] * s, fmt_max),
                      clip(f[4 * i + 3] * s, fmt_max));
      const int lr = p * RPP + r;
      const bool emit = codes != nullptr && r0 + lr < rows;
      uint8_t* dst = stage + lr * LDS + c * V;
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
        if (emit)
          *reinterpret_cast<uint2*>(codes + static_cast<size_t>(r0 + lr) * K + k0 + c * V) = make_uint2(q[0], q[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = q[0];
        if (emit) *reinterpret_cast<uint32_t*>(codes + static_cast<size_t>(r0 + lr) * K + k0 + c * V) = q[0];
      }
    }
  }
};

__device__ __forceinline__ void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    fp8_linear_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const float* __restrict__ sx_p,
                      const float* __restrict__ sw_p, TX* __restrict__ y, uint8_t* __restrict__ xq,
                      uint8_t* __restrict__ wq, float* __restrict__ amax, int M, int N, int K, float fmt_max) {
  __shared__ __align__(16) uint8_t xs[2][BM * LDS];
  __shared__ __align__(16) uint8_t ws[2][BN * LDS];
  __shared__ float red[2][THREADS / 32];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool first_col = blockIdx.y == 0, first_row = blockIdx.x == 0;
  uint8_t* xq_out = first_col ? xq : nullptr;
  uint8_t* wq_out = first_row ? wq : nullptr;
  const float sx = *sx_p, sw = *sw_p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows 64·wm, columns 32·wn

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  float ax = 0.f, aw = 0.f;

  Tile<TX> tx;
  Tile<TW> tw;
  const int nk = K / BK;
  tx.load(x, M, m0, K, 0);
  tw.load(w, N, n0, K, 0);
  tx.quantize(xs[0], xq_out, M, m0, K, 0, sx, fmt_max, ax);
  tw.quantize(ws[0], wq_out, N, n0, K, 0, sw, fmt_max, aw);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      tx.load(x, M, m0, K, (kt + 1) * BK);
      tw.load(w, N, n0, K, (kt + 1) * BK);
    }
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* p = ws[cur] + (wn * 32 + j * 8 + g) * LDS + t * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t* p = xs[cur] + (wm * 64 + i * 16 + g) * LDS + t * 4;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(p),
                             *reinterpret_cast<const uint32_t*>(p + 8 * LDS),
                             *reinterpret_cast<const uint32_t*>(p + 16),
                             *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d[4];
        mma_e4m3(d, a, b[j][0], b[j][1]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += d[r];
      }
    }
    if (more) {
      tx.quantize(xs[cur ^ 1], xq_out, M, m0, K, (kt + 1) * BK, sx, fmt_max, ax);
      tw.quantize(ws[cur ^ 1], wq_out, N, n0, K, (kt + 1) * BK, sw, fmt_max, aw);
    }
    __syncthreads();
  }

  if (first_col || first_row) {
    ax = tt::warp_max(ax);
    aw = tt::warp_max(aw);
    if (lane == 0) {
      red[0][warp] = ax;
      red[1][warp] = aw;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float mx = 0.f, mw = 0.f;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) {
        mx = fmaxf(mx, red[0][i]);
        mw = fmaxf(mw, red[1][i]);
      }
      if (first_col) atomicMax(reinterpret_cast<unsigned int*>(amax), __float_as_uint(mx));
      if (first_row) atomicMax(reinterpret_cast<unsigned int*>(amax + 1), __float_as_uint(mw));
    }
  }

  const float s = sx * sw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= N) continue;  // N % 8 == 0: an 8-column slice is all in or all out
      if (row < M) store2(y + static_cast<size_t>(row) * N + col, acc[i][j][0] / s, acc[i][j][1] / s);
      if (row + 8 < M) store2(y + static_cast<size_t>(row + 8) * N + col, acc[i][j][2] / s, acc[i][j][3] / s);
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const void* sx, const void* sw, void* y, void* xq, void* wq,
           void* amax, int M, int N, int K, float fmt_max, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fp8_linear_kernel<TX, TW><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<TX*>(y), static_cast<uint8_t*>(xq), static_cast<uint8_t*>(wq),
      static_cast<float*>(amax), M, N, K, fmt_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) and w (N, K), each f32 or bf16 (dtype codes of common.cuh); sx, sw
// f32 scalars; y (M, N) in x's dtype; xq (M, K) and wq (N, K) e4m3 codes, or
// null; amax two f32, zeroed by the caller. All contiguous and 16-byte
// aligned, K a multiple of 32, N a multiple of 8. Returns the launch's
// cudaGetLastError().
extern "C" int tt_fp8_linear(const void* x, const void* w, const void* sx, const void* sw, void* y, void* xq,
                             void* wq, void* amax, int M, int N, int K, int x_dtype, int w_dtype, float fmt_max,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == tt::kF32 && w_dtype == tt::kF32)
    return launch<float, float>(x, w, sx, sw, y, xq, wq, amax, M, N, K, fmt_max, s);
  if (x_dtype == tt::kF32 && w_dtype == tt::kBF16)
    return launch<float, __nv_bfloat16>(x, w, sx, sw, y, xq, wq, amax, M, N, K, fmt_max, s);
  if (x_dtype == tt::kBF16 && w_dtype == tt::kF32)
    return launch<__nv_bfloat16, float>(x, w, sx, sw, y, xq, wq, amax, M, N, K, fmt_max, s);
  if (x_dtype == tt::kBF16 && w_dtype == tt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, sx, sw, y, xq, wq, amax, M, N, K, fmt_max, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
