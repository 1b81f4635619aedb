// Building blocks of the flash-attention kernels (flash_rope_fwd.cu,
// flash_rope_bwd.cu): tile loads with RoPE applied on the way into shared
// memory (synchronous, or as a cp.async copy of the raw tile followed by a
// RoPE pass in shared memory), and a warp-level tile product.
//
// A block of W warps owns a tile of 16·W rows, each warp 16 of them.
// warp_mma multiplies a warp's 16 rows of A (shared memory, row-major) by B
// (shared memory) into 16 x 8*NT f32 accumulators that each thread holds in
// registers, in the layout of the tensor cores' m16n8k16 accumulator: lane
// = 4*g + c owns rows g and g + 8, columns 8*j + 2*c and 8*j + 2*c + 1 of
// each 8-column slice j. For bf16 and fp16 the product is
// `mma.sync.m16n8k16` with f32 accumulation, its operands loaded with
// `ldmatrix`; for f32 it is the same product by plain f32 FMAs with the same
// ownership (the tensor cores would round f32 operands to tf32), so the code
// around the products is one for every dtype.
#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace tt {
namespace flash {

// Shared-memory stages of a streamed tile: 16-bit types copy tile i + 1 with
// cp.async while tile i is computed; f32 (the agreement dtype) keeps one
// stage, which holds its twice-as-large tiles under a block's 227 KB.
template <typename T> struct Stages { static constexpr int N = sizeof(T) == 4 ? 1 : 2; };
// finite, as the TPU kernels' NEG_INF: a masked score's exp2 is 0, never NaN
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory row padding, in elements: 16 bytes, so rows stay 16-byte
// aligned and neighbouring rows start in other banks.
template <typename T> struct Pad { static constexpr int N = 16 / sizeof(T); };

// Padded head dim the kernels are instantiated for.
inline int padded_head_dim(int D) { return D <= 32 ? 32 : (D <= 64 ? 64 : 128); }

// dst[r][d] (row stride ld) = row r0 + r of a (T, D) slab, for r < ROWS and
// d < DP. With ROPE, x·cos + rotate_half(x)·sin is taken in f32 from cos/sin
// (T, D) f32 and rounded back to T: the partner element of d is d ± D/2,
// read directly. Rows at or past T and columns at or past D are zero. Each
// thread moves 16-byte chunks (the partner chunk too, when D/2 is a whole
// number of chunks; element by element otherwise).
template <typename T, int DP, int ROWS, int THREADS, bool ROPE>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src, int r0,
                                          int T_, int D, const float* __restrict__ cos,
                                          const float* __restrict__ sin) {
  constexpr int V = Vec<T>::N;
  constexpr int CH = DP / V;  // 16-byte chunks of a padded row
  const int h = D / 2;
  if (!ROPE || h % V == 0) {
#pragma unroll
    for (int i0 = 0; i0 < ROWS * CH; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
      const int r = i / CH, d0 = (i % CH) * V, t = r0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (t < T_ && d0 < D) {
        const T* row = src + static_cast<size_t>(t) * D;
        const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
        if (ROPE) {
          const uint4 par = *reinterpret_cast<const uint4*>(row + (d0 < h ? d0 + h : d0 - h));
          const float4* c4 = reinterpret_cast<const float4*>(cos + static_cast<size_t>(t) * D + d0);
          const float4* s4 = reinterpret_cast<const float4*>(sin + static_cast<size_t>(t) * D + d0);
          const T* xe = reinterpret_cast<const T*>(&raw);
          const T* pe = reinterpret_cast<const T*>(&par);
          T* oe = reinterpret_cast<T*>(&out);
          const float sign = d0 < h ? -1.f : 1.f;
#pragma unroll
          for (int j4 = 0; j4 < V / 4; ++j4) {
            const float4 c = c4[j4], s = s4[j4];
            const float cc[4] = {c.x, c.y, c.z, c.w}, ss[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int e = 4 * j4 + j;
              oe[e] = from_f32<T>(to_f32(xe[e]) * cc[j] + sign * to_f32(pe[e]) * ss[j]);
            }
          }
        } else {
          out = raw;
        }
      }
      *reinterpret_cast<uint4*>(dst + r * ld + d0) = out;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, t = r0 + r;
      float x = 0.f;
      if (t < T_ && d < D) {
        const T* row = src + static_cast<size_t>(t) * D;
        const float partner = to_f32(row[d < h ? d + h : d - h]);
        const size_t cs = static_cast<size_t>(t) * D + d;
        x = to_f32(row[d]) * cos[cs] + (d < h ? -partner : partner) * sin[cs];
      }
      dst[r * ld + d] = from_f32<T>(x);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of rows r0 .. r0 + ROWS - 1 of a (T, D) slab into dst (row
// stride ld) in 16-byte chunks; rows past T and columns past D are zero-filled.
// The caller commits the group and waits for it.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile_async(T* dst, int ld, const T* __restrict__ src, int r0,
                                                int T_, int D) {
  constexpr int V = Vec<T>::N;
  constexpr int CH = DP / V;
#pragma unroll
  for (int i0 = 0; i0 < ROWS * CH; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
    const int r = i / CH, d0 = (i % CH) * V, t = r0 + r;
    const bool valid = t < T_ && d0 < D;
    cp_async16(dst + r * ld + d0, valid ? src + static_cast<size_t>(t) * D + d0 : src, valid);
  }
}

// dst = RoPE of the raw tile src (both in shared memory, row stride ld; row r
// is position r0 + r), x·cos + rotate_half(x)·sin in f32, rounded to T. Rows
// past T and padded columns are zero in src and stay zero.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void rope_tile(T* dst, const T* src, int ld, int r0, int T_, int D,
                                          const float* __restrict__ cos,
                                          const float* __restrict__ sin) {
  constexpr int V = Vec<T>::N;
  constexpr int CH = DP / V;
  const int h = D / 2;
  if (h % V == 0) {
#pragma unroll
    for (int i0 = 0; i0 < ROWS * CH; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      if (ROWS * CH % THREADS != 0 && i >= ROWS * CH) break;
      const int r = i / CH, d0 = (i % CH) * V, t = r0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (t < T_ && d0 < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ld + d0);
        const uint4 par = *reinterpret_cast<const uint4*>(src + r * ld + (d0 < h ? d0 + h : d0 - h));
        const float4* c4 = reinterpret_cast<const float4*>(cos + static_cast<size_t>(t) * D + d0);
        const float4* s4 = reinterpret_cast<const float4*>(sin + static_cast<size_t>(t) * D + d0);
        const T* xe = reinterpret_cast<const T*>(&raw);
        const T* pe = reinterpret_cast<const T*>(&par);
        T* oe = reinterpret_cast<T*>(&out);
        const float sign = d0 < h ? -1.f : 1.f;
#pragma unroll
        for (int j4 = 0; j4 < V / 4; ++j4) {
          const float4 c = c4[j4], s = s4[j4];
          const float cc[4] = {c.x, c.y, c.z, c.w}, ss[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = 4 * j4 + j;
            oe[e] = from_f32<T>(to_f32(xe[e]) * cc[j] + sign * to_f32(pe[e]) * ss[j]);
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + r * ld + d0) = out;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, t = r0 + r;
      float x = 0.f;
      if (t < T_ && d < D) {
        const float partner = to_f32(src[r * ld + (d < h ? d + h : d - h)]);
        const size_t cs = static_cast<size_t>(t) * D + d;
        x = to_f32(src[r * ld + d]) * cos[cs] + (d < h ? -partner : partner) * sin[cs];
      }
      dst[r * ld + d] = from_f32<T>(x);
    }
  }
}

// y (rows of 16 f32, row stride ly, columns < D) -> out rows t0.., applying
// the RoPE VJP y·cos + rotate_halfᵀ(y·sin) when ROPE; one warp, its own rows.
template <typename T, bool ROPE>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float* y, int ly, int t0,
                                           int T_, int D, const float* __restrict__ cos,
                                           const float* __restrict__ sin) {
  const int lane = threadIdx.x & 31, h = D / 2;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, d = i % D, t = t0 + r;
    if (t >= T_) continue;
    const float* yr = y + r * ly;
    float x = yr[d];
    if (ROPE) {
      const size_t cs = static_cast<size_t>(t) * D;
      x = x * cos[cs + d] + (d < h ? yr[d + h] * sin[cs + d + h] : -yr[d - h] * sin[cs + d - h]);
    }
    out[static_cast<size_t>(t) * D + d] = from_f32<T>(x);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  uint16_t l, u;
  memcpy(&l, &lo, 2);
  memcpy(&u, &hi, 2);
  return static_cast<uint32_t>(l) | (static_cast<uint32_t>(u) << 16);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc[j] += A (this warp's 16 rows, A[m * lda + k]) · B over k < K, for the
// columns n of slice j. B_NK: B is stored transposed, B(k, n) = B[n * ldb + k]
// (a q/k/v tile as the right operand of q·kᵀ); otherwise B(k, n) = B[k * ldb + n].
// For 16-bit types the fragments come from ldmatrix (.trans for the second
// layout): rows are 16-byte aligned and NT is even.
template <typename T, int NT, int K, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const T* A, int lda, const T* B,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * c;
        const float b0 = B_NK ? B[n * ldb + k] : B[k * ldb + n];
        const float b1 = B_NK ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
        acc[j][0] += a0 * b0;
        acc[j][1] += a0 * b1;
        acc[j][2] += a1 * b0;
        acc[j][3] += a1 * b1;
      }
    }
  } else {
    static_assert(NT % 2 == 0, "slices are loaded in pairs");
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + (lane & 15) * lda + k0 + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        if (B_NK) {
          ldsm_x4(b, B + (8 * j + (lane & 7) + 8 * (lane >> 4)) * ldb + k0 + 8 * ((lane >> 3) & 1));
        } else {
          ldsm_x4_trans(b, B + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + 8 * j +
                               8 * (lane >> 4));
        }
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma16816<T>(acc[j], a, b0);
        mma16816<T>(acc[j + 1], a, b1);
      }
    }
  }
}

// this warp's accumulators (16 x 8*NT) -> dst rows (row stride ld), rounded
// to T; each thread stores its two neighbouring columns at once.
template <typename T, int NT>
__device__ __forceinline__ void store_acc(T* dst, int ld, const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* p = dst + (g + 8 * r) * ld + 8 * j + 2 * c;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = pack2(from_f32<T>(acc[j][2 * r]), from_f32<T>(acc[j][2 * r + 1]));
      }
    }
  }
}

// Accumulator element e of a slice lives at row g + 8 * (e >> 1), column
// 2 * c + (e & 1) of the slice.
__device__ __forceinline__ int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int j, int e) { return 8 * j + 2 * (threadIdx.x & 3) + (e & 1); }

// Max and sum over the 4 lanes that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Raises the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB; returns the CUDA error.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
}  // namespace tt
