// The skeleton of the weight-only quantized linears (int8_linear.cu,
// nf4_linear.cu): y (M, N) = x (M, K) · W (N, K)ᵀ, where W stays quantized
// in device memory and is decoded in registers; f32 accumulation, one
// rounding to x's dtype at the end.
//
// A block owns BN = 8·NT output columns and BM = 16·MT rows, and its WARPS
// warps split K among themselves: warp w walks chunks w, w + WARPS, ... of
// W::kChunkK columns of k, and the warps' partial sums meet in shared
// memory at the end. Within a chunk, lane 4·g + c reads 16 bytes of weight
// row n0 + 8·j + g (one 16-byte load for each 8-column slice j) and decodes
// them into W::kGroups groups of 16 weights at consecutive k. Those 16 k
// take the places of lane c's k pairs in four m16n8k16 steps (step s: k0 +
// 4s + {0,1} as the fragment's columns 2c, 2c+1 and k0 + 4s + {2,3} as
// columns 2c + 8, 2c + 9): a product sums over k in any order, and the A
// fragment — x's rows g and g + 8, loaded as 16 consecutive values from
// the same k0 — takes the same places, so weights go from one 16-byte load
// straight into mma operands with no shared-memory staging or shuffles.
//
// bf16 x: the decoded weights are rounded to bf16 and multiplied by
// `mma.sync.m16n8k16` with f32 accumulation. f32 x: the same chunks by f32
// FMAs (the tensor cores would round f32 operands to tf32), each lane
// summing its 16 k for all 16 rows, then a quad shuffle.
//
// The policy W supplies the format:
//   kChunkK, kGroups       k a warp covers in one chunk; 16-weight groups a
//                          lane decodes from one 16-byte load
//   Raw                    what a lane loads for one weight row and chunk
//   init()                 per-block set-up (shared tables), before a barrier
//   load(raw, n, c, q)     row n (n < 0: none) of chunk c for lane c = q
//   group_k(c, q, g)       the first k of group g (>= K: past the end)
//   decode(raw, g, w[16])  group g's weights in f32
//   epilogue(acc, n)       the f32 sum of column n -> the value stored
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace tt {
namespace wol {

template <typename T> struct IsF32 { static constexpr bool value = std::is_same<T, float>::value; };

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, class W, int MT, int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    linear_kernel(const T* __restrict__ x, const W w, T* __restrict__ y, int M, int N, int K) {
  constexpr int BM = 16 * MT, BN = 8 * NT;
  constexpr bool kF32 = IsF32<T>::value;
  static_assert(!kF32 || MT == 1, "the f32 path owns 16 rows a block");
  __shared__ float red[WARPS][BM][BN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, q4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_chunks = (K + W::kChunkK - 1) / W::kChunkK;
  w.init();
  __syncthreads();

  // mma accumulators (bf16) or per-lane row sums (f32); one of them is used
  float acc[MT][NT][4];
  float facc[kF32 ? 16 : 1][NT];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;
#pragma unroll
  for (int m = 0; m < (kF32 ? 16 : 1); ++m)
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
      if constexpr (!kF32) {
        uint32_t b[NT][8];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float wf[16];
          w.decode(cur[j], g, wf);
          const bool ok = kin && n0 + 8 * j + g8 < N;
#pragma unroll
          for (int i = 0; i < 8; ++i) b[j][i] = ok ? bf16x2(wf[2 * i], wf[2 * i + 1]) : 0u;
        }
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          const int r0 = m0 + 16 * a + g8, r1 = r0 + 8;
          uint4 x0[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
          uint4 x1[2] = {x0[0], x0[1]};
          if (kin && r0 < M) {
            const uint4* p = reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0) * K + k0);
            x0[0] = p[0];
            x0[1] = p[1];
          }
          if (kin && r1 < M) {
            const uint4* p = reinterpret_cast<const uint4*>(x + static_cast<size_t>(r1) * K + k0);
            x1[0] = p[0];
            x1[1] = p[1];
          }
          const uint32_t* xa = reinterpret_cast<const uint32_t*>(x0);
          const uint32_t* xb = reinterpret_cast<const uint32_t*>(x1);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t af[4] = {xa[2 * s], xb[2 * s], xa[2 * s + 1], xb[2 * s + 1]};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint32_t bf[2] = {b[j][2 * s], b[j][2 * s + 1]};
              tt::flash::mma16816<T>(acc[a][j], af, bf);
            }
          }
        }
      } else {
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
              const float4* p = reinterpret_cast<const float4*>(
                  reinterpret_cast<const float*>(x) + static_cast<size_t>(m0 + m) * K + k0);
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
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) cur[j] = nxt[j];
  }

  // each warp's partial sums into shared memory, then summed over warps
  if constexpr (!kF32) {
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[warp][16 * a + g8 + 8 * (e >> 1)][8 * j + 2 * q4 + (e & 1)] = acc[a][j][e];
  } else {
#pragma unroll
    for (int m = 0; m < 16; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v = facc[m][j];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q4 == 0) red[warp][m][8 * j + g8] = v;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += WARPS * 32) {
    const int m = i / BN, n = i % BN;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) s += red[v][m][n];
    if (m0 + m < M && n0 + n < N)
      y[static_cast<size_t>(m0 + m) * N + n0 + n] = from_f32<T>(w.epilogue(s, n0 + n));
  }
}

// A block owns 16 rows and 16 columns with 8 warps splitting K (decode, and
// every f32 call), or 64 rows and 32 columns with 4 warps (bf16, M > 16).
template <typename T, class W>
int launch(const T* x, const W& w, T* y, int M, int N, int K, cudaStream_t stream) {
  if constexpr (IsF32<T>::value) {
    linear_kernel<T, W, 1, 2, 8><<<dim3((N + 15) / 16, (M + 15) / 16), 256, 0, stream>>>(x, w, y, M, N, K);
  } else {
    if (M <= 16)
      linear_kernel<T, W, 1, 2, 8><<<dim3((N + 15) / 16, (M + 15) / 16), 256, 0, stream>>>(x, w, y, M, N, K);
    else
      linear_kernel<T, W, 4, 4, 4><<<dim3((N + 31) / 32, (M + 63) / 64), 128, 0, stream>>>(x, w, y, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wol
}  // namespace tt
