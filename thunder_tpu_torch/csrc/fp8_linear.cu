// Delayed-scaling fp8 linear for Hopper (sm_90a): a quantize pass, then a
// warpgroup product (wgmma) of the codes fed by TMA.
//
// Replaces thunder_tpu/executors/pallasex.py:fp8_linear_fused (:1447, kernel
// _fp8_matmul_kernel :1399). For x (M, K) and w (N, K), each f32 or bf16,
// and the delayed scales sx, sw (f32 scalars in device memory):
//
//   xq = e4m3(clip(f32(x)·sx, ±fmt_max)),  wq = e4m3(clip(f32(w)·sw, ±fmt_max))
//   y  = (Σ_k f32(xq)·f32(wq)) / (sx·sw), rounded once to x's dtype
//   amax[0] = max|x|, amax[1] = max|w|   (of the unquantized operands)
//
// and the e4m3 codes xq (M, K) and wq (N, K) (the residuals the backward
// reads, or the caller's scratch). The casts round to nearest even and
// saturate, after the clip, so the codes are those of torch's and jnp's
// astype; the epilogue divides by the product of the scales, as the
// reference does (not a multiply by its reciprocal).
//
// What bounds it: bytes. At the training path's shapes (M = 8192 tokens,
// K = 1024 or 2816) the fp8 operations take 26-47 us at 1,979 TFLOP/s,
// while reading x and an f32 w and writing y and the codes takes 47-49 us
// at 3.35 TB/s (y alone, M·N f32 at the attention's N = 3072, 100 MB).
//
// Design, two kernels on one stream behind one entry point:
//   1. fp8_linear_quantize: one pass over x and w (blocks split between the
//      two), 16 elements a thread a step with 16-byte loads, scaled, clipped
//      and converted by __nv_cvt_float2_to_fp8x2 (satfinite, nearest even)
//      into one 16-byte store of e4m3 codes, and the same codes widened
//      exactly to f16 (every e4m3 value is an f16 value) into scratch. Each
//      operand is quantized once; the kernel this replaces quantized every x
//      tile once per column of output tiles (24x at the attention, 250x at
//      lm_head) and every w tile once per row of them (64x). The amaxes: per
//      thread, warp and block, then one atomicMax per block on the float's
//      bits (non-negative floats order as unsigned ints) into the amax the
//      caller zeroed.
//   2. fp8_linear_core, persistent (one block an SM walking 128 x 128
//      output tiles): a producer warpgroup whose one thread streams 128 x
//      128-byte tiles of both operands' codes by TMA through kStages
//      mbarrier stages (out-of-range rows and k read as zero codes), and two
//      consumer warpgroups of 64 rows each; setmaxnreg moves registers from
//      the producer to the consumers. Every 32 k the tensor-core sum starts
//      from zero (scale-d 0) in a scratch fragment that is then added into
//      the f32 accumulators, in k order: the promotion every 32 k the kernel
//      this replaces made with mma.sync (the fp8 agreement bounds were
//      measured on it). The 128 columns run as two 64-column halves with a
//      scratch fragment each, so one half's FADDs run while the other
//      half's products do (two 128-column scratch fragments do not fit in
//      the 168 registers ptxas gives a 384-thread block: they spilled). The
//      epilogue divides by sx·sw, rounds to x's dtype into a staging tile
//      in shared memory, and one thread stores it by TMA (rows past M and
//      columns past N are not written) while the warpgroup goes on to its
//      next tile, whose stages the producer has already loaded.
//
// The products run as wgmma f16 x f16 on the widened codes (two k16 products
// a promotion group), not as wgmma e4m3 x e4m3 (m64n128k32, sm90.cuh's
// wgmma_e4m3): measured on an H100 80GB HBM3 at 700 W
// (tools/fp8_grouped_ab.py), the e4m3 product keeps so few bits in its
// 32-deep sums that f32 y moved 1.6-2.8e-4 of max(1, |y|) from the exact
// sum, against 3.6-8.0e-7 here and for the mma.sync kernel; f32 y is held to
// 1e-5. The f16 operands double the bytes each tile reads from the L2,
// which now bounds the product (about 0.37 PFLOP/s at the attention's
// shape). The e4m3 product, promoted every 32 or 128 k, and the f16 product
// accumulated in the tensor core throughout stay as timed alternatives
// (tt_fp8_linear_variant).
//
// Every mbarrier wait traps after ~2^26 polls (sm90.cuh), so a fault ends
// the launch with an error instead of hanging the card.

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace tt::sm90;

// ---- stage 1: quantize ----

constexpr int kQThreads = 256;
constexpr int kQElems = 16;          // elements a thread a step: one 16-byte store of codes
constexpr int kQMaxBlocks = 1024;    // blocks an operand, at most (grid-stride beyond)

__device__ __forceinline__ float clip(float v, float fmt_max) { return fminf(fmaxf(v, -fmt_max), fmt_max); }

__device__ __forceinline__ uint32_t e4m3x4(float a, float b, float c, float d) {
  const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, __NV_E4M3);
  const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(c, d), __NV_SATFINITE, __NV_E4M3);
  return lo | (hi << 16);
}

template <typename T> __device__ __forceinline__ void load16(const T* p, float (&f)[kQElems]) {
  constexpr int V = tt::Vec<T>::N;
#pragma unroll
  for (int i = 0; i < kQElems; i += V) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < V; ++j) f[i + j] = tt::to_f32(e[j]);
  }
}

// Codes of `n16` 16-element chunks of src into codes (and, with halves,
// the same codes widened exactly to f16), by blocks [0, blocks) of this
// operand; the largest |src| into *amax.
template <typename T>
__device__ __forceinline__ void quantize_operand(const T* __restrict__ src, uint8_t* __restrict__ codes,
                                                 __half* __restrict__ halves, long long n16, float s,
                                                 float fmt_max, int block, int blocks, float* amax) {
  __shared__ float red[kQThreads / 32];
  float mx = 0.f;
  for (long long i = static_cast<long long>(block) * kQThreads + threadIdx.x; i < n16;
       i += static_cast<long long>(blocks) * kQThreads) {
    float f[kQElems];
    load16(src + i * kQElems, f);
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(f[4 * j + e]));
      q[j] = e4m3x4(clip(f[4 * j] * s, fmt_max), clip(f[4 * j + 1] * s, fmt_max),
                    clip(f[4 * j + 2] * s, fmt_max), clip(f[4 * j + 3] * s, fmt_max));
    }
    *reinterpret_cast<uint4*>(codes + i * kQElems) = make_uint4(q[0], q[1], q[2], q[3]);
    if (halves != nullptr) {
      uint32_t hv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(q[j / 2] >> (16 * (j % 2))), __NV_E4M3);
        hv[j] = static_cast<uint32_t>(r.x) | (static_cast<uint32_t>(r.y) << 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(halves + i * kQElems);
      dst[0] = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      dst[1] = make_uint4(hv[4], hv[5], hv[6], hv[7]);
    }
  }
  mx = tt::warp_max(mx);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kQThreads / 32; ++i) mx = fmaxf(mx, red[i]);
    atomicMax(reinterpret_cast<unsigned int*>(amax), __float_as_uint(mx));
  }
}

// Blocks [0, x_blocks) quantize x, the rest w.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kQThreads)
    fp8_linear_quantize(const TX* __restrict__ x, const TW* __restrict__ w, const float* __restrict__ sx,
                        const float* __restrict__ sw, uint8_t* __restrict__ xq, uint8_t* __restrict__ wq,
                        __half* __restrict__ xh, __half* __restrict__ wh, float* __restrict__ amax,
                        long long x16, long long w16, int x_blocks, float fmt_max) {
  if (static_cast<int>(blockIdx.x) < x_blocks)
    quantize_operand(x, xq, xh, x16, *sx, fmt_max, blockIdx.x, x_blocks, amax);
  else
    quantize_operand(w, wq, wh, w16, *sw, fmt_max, blockIdx.x - x_blocks, gridDim.x - x_blocks, amax + 1);
}

// ---- stage 2: the product ----

constexpr int kBM = 128, kBN = 128;   // output tile: two warpgroups of 64 rows x 128 columns
constexpr int kRow = 128;             // bytes of k a stage: one 128-byte swizzled row
constexpr int kStages = 5;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTileBytes = kBM * kRow;      // one operand's tile (kBM == kBN)
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kOutBytes = 64 * kBN * 4;     // a warpgroup's 64 x 128 y tile (f32 at most)
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kOutBytes + 2 * kStages * 8 + 1024;  // + alignment slack

// Element (row, col) of a warpgroup's y tile staged for the TMA store: boxes
// of 64 rows by 128 bytes of columns one after the other, each 128-byte
// swizzled as the map's boxes are (sm90.cuh); a pair of elements at an even
// col stays in one 16-byte chunk.
template <typename TY> __device__ __forceinline__ uint32_t out_offset(int row, int col) {
  constexpr int kPerRow = 128 / sizeof(TY);
  const int byte = (col % kPerRow) * static_cast<int>(sizeof(TY));
  return (col / kPerRow) * 64 * 128 + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15);
}
__device__ __forceinline__ void store_pair(unsigned char* p, float a, float b, float) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(unsigned char* p, float a, float b, __nv_bfloat16) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32x2(a, b, __nv_bfloat16{});
}

// One 32-byte k slice of both operands: k32 of e4m3 codes, or k16 of the
// codes widened to f16.
__device__ __forceinline__ void product(float (&d)[64], uint64_t a, uint64_t b, int scale_d, uint8_t) {
  wgmma_e4m3(d, a, b, scale_d);
}
__device__ __forceinline__ void product(float (&d)[64], uint64_t a, uint64_t b, int scale_d, __half) {
  wgmma_ss<0, 0>(d, a, b, scale_d, __half{});
}

// OP: the operands' element type in shared memory (uint8_t: e4m3 codes;
// __half: the codes widened to f16). kPromote: 32-byte k slices a tensor-core
// sum spans before it is added into the f32 accumulators, or 0 to
// accumulate in the tensor core throughout.
template <typename TY, typename OP, int kPromote>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_linear_core(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ sx_p,
                    const float* __restrict__ sw_p, int M, int N, int K) {
  static_assert(kPromote != 2 || std::is_same<OP, __half>::value, "the pipelined promotion is f16's");
  constexpr int kBK = kRow / sizeof(OP);  // k elements a stage
  constexpr int kSlices = 4;              // 32-byte k slices a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_m = (M + kBM - 1) / kBM, n_tiles = n_m * ((N + kBN - 1) / kBN);
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      int t = 0;  // stages filled so far: fill t goes to stage t % kStages
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile % n_m) * kBM, n0 = (tile / n_m) * kBN;
        for (int kt = 0; kt < n_k; ++kt, ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);  // fill t − kStages is consumed
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_3d(smem + s * kStageBytes, &tm_x, &full[s], kt * kBK, m0, 0);
          tma_load_3d(smem + s * kStageBytes + kTileBytes, &tm_w, &full[s], kt * kBK, n0, 0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // warpgroup wg owns rows m0 + 64·wg .. + 63; accumulator element i sits at
  // row 16·warp + gq + 8·((i>>1)&1) of them, column 8·(i>>2) + 2c + (i&1)
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, c = lane & 3;
  const float s = *sx_p * *sw_p;
  const uint32_t base = smem_u32(smem);
  int t = 0;  // stages consumed so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile % n_m) * kBM, n0 = (tile / n_m) * kBN;
    // the scratch fragments live within a tile's main loop only, so the
    // epilogue holds just acc
    constexpr int kHalf = kPromote == 2 ? 32 : 1, kPart = kPromote == 2 || !kPromote ? 1 : 64;
    float acc[64], pa[kHalf], pb[kHalf], part[kPart];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) pa[i] = pb[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kPart; ++i) part[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt, ++t) {
      const int st = t % kStages;
      mbar_wait(&full[st], (t / kStages) & 1);
      const uint32_t a_s = base + st * kStageBytes + wg * 64 * kRow;
      const uint32_t b_s = base + st * kStageBytes + kTileBytes;
      if constexpr (kPromote == 2) {
        // four units a stage: (32 k, 64-column half) in k order, each a
        // tensor-core sum started from zero in pa or pb (halves alternate),
        // added into its half of acc while the next unit runs; the stage
        // is released once its last unit is added (after the next stage's
        // first unit is issued, or at the tile's end)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int g = u >> 1, h = u & 1;
          float(&p)[32] = h ? pb : pa;
          wgmma_fence();
#pragma unroll
          for (int kk = 2 * g; kk < 2 * g + 2; ++kk)
            wgmma_ss<0, 0>(p, desc_sw128(a_s + 32 * kk, 16, 1024),
                           desc_sw128(b_s + h * 64 * kRow + 32 * kk, 16, 1024), kk > 2 * g, __half{});
          wgmma_commit();
          wgmma_wait<1>();
          if (u > 0 || kt > 0) {
            float(&q)[32] = h ? pa : pb;  // the previous unit's, of the other half
            fence_regs(q);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[32 * (1 - h) + i] += q[i];
            if (u == 0) mbar_arrive(&empty[(t - 1) % kStages]);
          }
        }
        if (kt + 1 == n_k) {
          wgmma_wait<0>();
          fence_regs(pb);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[32 + i] += pb[i];
          mbar_arrive(&empty[st]);
        }
        continue;
      } else if constexpr (kPromote == 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlices; ++kk)
          product(acc, desc_sw128(a_s + 32 * kk, 16, 1024), desc_sw128(b_s + 32 * kk, 16, 1024), 1, OP{});
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      } else {
#pragma unroll
        for (int kp = 0; kp < kSlices; kp += kPromote) {
          wgmma_fence();
#pragma unroll
          for (int kk = kp; kk < kp + kPromote; ++kk)
            product(part, desc_sw128(a_s + 32 * kk, 16, 1024), desc_sw128(b_s + 32 * kk, 16, 1024), kk > kp,
                    OP{});
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
        }
      }
      mbar_arrive(&empty[st]);  // this thread is done with stage st
    }

    // the epilogue: y into this warpgroup's staging tile, then one thread
    // stores it by TMA (rows past M and columns past N are not written)
    // while the warpgroup goes on to its next tile
    unsigned char* out = smem + kStages * kStageBytes + wg * kOutBytes;
    if (tid == 0) bulk_wait_read<0>();  // the previous tile's store has read the staging tile
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + gq + 8 * r;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        store_pair(out + out_offset<TY>(row, 8 * j + 2 * c), acc[4 * j + 2 * r] / s, acc[4 * j + 2 * r + 1] / s,
                   TY{});
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < kBN * static_cast<int>(sizeof(TY)) / 128; ++b)
        tma_store_3d(&tm_y, out + b * 64 * 128, n0 + b * (128 / static_cast<int>(sizeof(TY))), m0 + 64 * wg, 0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// The product's variants: 0 e4m3, promoted every k32; 1 e4m3, every k128;
// 2 f16, accumulated in the tensor core; 3 f16, promoted every k32, each
// 64-column half's sum added while the other half's runs (tt_fp8_linear's).
struct Call {
  const void *x, *w, *sx, *sw;
  void *y, *xq, *wq, *xh, *wh, *amax;
  int M, N, K;
  float fmt_max;
  cudaStream_t stream;
};

template <typename TX, typename OP, int kPromote>
int core(const Call& a) {
  CUtensorMap mx, mw, my;
  const bool half = std::is_same<OP, __half>::value;
  const CUtensorMapDataType type = half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int e = make_map_3d(&mx, half ? a.xh : a.xq, type, a.K, a.M, 1, kBM);
  if (!e) e = make_map_3d(&mw, half ? a.wh : a.wq, type, a.K, a.N, 1, kBN);
  if (!e)
    e = make_map_3d(&my, a.y,
                    std::is_same<TX, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    a.N, a.M, 1, 64);
  if (e) return e;
  auto kernel = fp8_linear_core<TX, OP, kPromote>;
  e = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  int sms = 0;
  if (!e) e = sm_count(&sms);
  if (e) return e;
  const long long tiles = static_cast<long long>((a.M + kBM - 1) / kBM) * ((a.N + kBN - 1) / kBN);
  kernel<<<static_cast<int>(tiles < sms ? tiles : sms), kThreads, kSmemBytes, a.stream>>>(
      mx, mw, my, static_cast<const float*>(a.sx), static_cast<const float*>(a.sw), a.M, a.N, a.K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch(const Call& a, int variant) {
  const bool half = variant >= 2;
  const long long x16 = static_cast<long long>(a.M) * a.K / kQElems, w16 = static_cast<long long>(a.N) * a.K / kQElems;
  const long long want_x = (x16 + kQThreads - 1) / kQThreads, want_w = (w16 + kQThreads - 1) / kQThreads;
  const int bx = static_cast<int>(want_x < kQMaxBlocks ? want_x : kQMaxBlocks);
  const int bw = static_cast<int>(want_w < kQMaxBlocks ? want_w : kQMaxBlocks);
  fp8_linear_quantize<TX, TW><<<bx + bw, kQThreads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), static_cast<const float*>(a.sx),
      static_cast<const float*>(a.sw), static_cast<uint8_t*>(a.xq), static_cast<uint8_t*>(a.wq),
      half ? static_cast<__half*>(a.xh) : nullptr, half ? static_cast<__half*>(a.wh) : nullptr,
      static_cast<float*>(a.amax), x16, w16, bx, a.fmt_max);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  switch (variant) {
    case 0: return core<TX, uint8_t, 1>(a);
    case 1: return core<TX, uint8_t, 4>(a);
    case 2: return core<TX, __half, 0>(a);
    case 3: return core<TX, __half, 2>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Call& a, int x_dtype, int w_dtype, int variant) {
  if (a.xq == nullptr || a.wq == nullptr || a.K % 32 || a.N % 8 ||
      (variant >= 2 && (a.xh == nullptr || a.wh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == tt::kF32 && w_dtype == tt::kF32) return launch<float, float>(a, variant);
  if (x_dtype == tt::kF32 && w_dtype == tt::kBF16) return launch<float, __nv_bfloat16>(a, variant);
  if (x_dtype == tt::kBF16 && w_dtype == tt::kF32) return launch<__nv_bfloat16, float>(a, variant);
  if (x_dtype == tt::kBF16 && w_dtype == tt::kBF16) return launch<__nv_bfloat16, __nv_bfloat16>(a, variant);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (M, K) and w (N, K), each f32 or bf16 (dtype codes of common.cuh); sx, sw
// f32 scalars; y (M, N) in x's dtype; xq (M, K) and wq (N, K) the e4m3 codes
// (the residuals, or scratch); xh (M, K) and wh (N, K) f16 scratch (the
// codes widened); amax two f32, zeroed by the caller. All contiguous and
// 16-byte aligned, K a multiple of 32, N a multiple of 8. Launches the
// quantize pass and the product on `stream`. Returns the first CUDA error.
extern "C" int tt_fp8_linear(const void* x, const void* w, const void* sx, const void* sw, void* y, void* xq,
                             void* wq, void* xh, void* wh, void* amax, int M, int N, int K, int x_dtype,
                             int w_dtype, float fmt_max, void* stream) {
  const Call a{x, w, sx, sw, y, xq, wq, xh, wh, amax, M, N, K, fmt_max, static_cast<cudaStream_t>(stream)};
  return dispatch(a, x_dtype, w_dtype, 3);
}

// The product's variants (see Call), for tools/fp8_grouped_ab.py: the same
// arguments and a variant.
extern "C" int tt_fp8_linear_variant(const void* x, const void* w, const void* sx, const void* sw, void* y,
                                     void* xq, void* wq, void* xh, void* wh, void* amax, int M, int N, int K,
                                     int x_dtype, int w_dtype, float fmt_max, int variant, void* stream) {
  const Call a{x, w, sx, sw, y, xq, wq, xh, wh, amax, M, N, K, fmt_max, static_cast<cudaStream_t>(stream)};
  return dispatch(a, x_dtype, w_dtype, variant);
}
