// Fused cross-entropy forward for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:fused_cross_entropy_forward
// (kernel body _xent_kernel): per row of (N, V) logits in f32, bf16 or
// f16, lse = log(sum(exp(logits))) and loss = lse - logits[target], both f32
// (N,). A target outside [0, V) (ignore_index among them) contributes 0 as
// the picked logit, as the TPU kernel's one-hot does; it is never read. The
// wrapper masks ignore_index and takes the mean outside the kernel, as
// pallasex does outside its pallas_call.
//
// What bounds it: bytes. Each logit is read once and costs a handful of
// flops and one exp2; at the LM head's shape (N = 8192, V = 50304, bf16)
// that is 824 MB, 0.246 ms at 3.35 TB/s.
//
// What the design does about that: one pass over the logits. One block of
// 256 threads per row; each thread streams its 16-byte vectors of the row
// (the element-wise path when V is not a whole number of vectors) and keeps
// an online max and sum of exp2 in f32 registers (base 2, log2(e) folded
// into the logit), then the block folds the (max, sum) pairs with warp
// shuffles and once across warps through shared memory. The target's logit
// is one load by index, not a one-hot scan over V.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// (m, s) <- the base-2 (max, sum of exp2) of both partial rows; an empty
// partial (s == 0) contributes nothing, whatever its max.
__device__ __forceinline__ void fold(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = (s == 0.f ? 0.f : s * exp2f(m - mn)) + (s2 == 0.f ? 0.f : s2 * exp2f(m2 - mn));
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_kernel(const T* __restrict__ logits, const long long* __restrict__ targets,
                float* __restrict__ loss, float* __restrict__ lse, int V) {
  constexpr int VEC = tt::Vec<T>::N;
  const size_t row = blockIdx.x;
  const T* x = logits + row * static_cast<size_t>(V);
  float m = -INFINITY, s = 0.f;
  if (V % VEC == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int nv = V / VEC;
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      float y[VEC];
      float vm = -INFINITY;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        y[j] = tt::to_f32(e[j]) * kLog2e;
        vm = fmaxf(vm, y[j]);
      }
      if (vm > m) {
        s *= exp2f(m - vm);
        m = vm;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += exp2f(y[j] - m);
    }
  } else {
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float y = tt::to_f32(x[i]) * kLog2e;
      if (y > m) {
        s *= exp2f(m - y);
        m = y;
      }
      s += exp2f(y - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    fold(m, s, m2, s2);
  }
  __shared__ float wm[kThreads / 32], ws[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? wm[lane] : -INFINITY;
    s = lane < kThreads / 32 ? ws[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      fold(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = (m + log2f(s)) * kLn2;
      const long long t = targets[row];
      const float picked = (t >= 0 && t < V) ? tt::to_f32(x[t]) : 0.f;
      lse[row] = l;
      loss[row] = l - picked;
    }
  }
}

template <typename T>
int launch(const void* logits, const long long* targets, float* loss, float* lse, int N, int V,
           cudaStream_t stream) {
  xent_kernel<T><<<N, kThreads, 0, stream>>>(static_cast<const T*>(logits), targets, loss, lse, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits (N, V) contiguous and 16-byte aligned, targets (N,) int64, loss and
// lse (N,) f32. Returns the launch's CUDA error.
extern "C" int tt_cross_entropy(const void* logits, const void* targets, void* loss, void* lse,
                                int N, int V, int dtype, void* stream) {
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(targets);
  float* l = static_cast<float*>(loss);
  float* e = static_cast<float*>(lse);
  switch (dtype) {
    case tt::kF32: return launch<float>(logits, t, l, e, N, V, s);
    case tt::kBF16: return launch<__nv_bfloat16>(logits, t, l, e, N, V, s);
    case tt::kF16: return launch<__half>(logits, t, l, e, N, V, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
