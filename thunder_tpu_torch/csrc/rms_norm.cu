// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:fused_rms_norm (kernel body
// _rms_kernel). Computes y = x * rsqrt(mean(x^2) + eps) * w per row, all in
// f32, with the cast to x's dtype last: the TPU kernel's order.
//
// What bounds it: bytes. A row is read once and written once and w is read
// once: 2*N*D*itemsize + D*itemsize, against ~4 flops per element — far
// below the ~295 flops per byte where the tensor cores would bound it. At the
// serving path's shapes (decode: <= 8 rows; prefill buckets: 128-1024 rows of
// 2048) the bound is 0.02-2.5 us, so the launch and the DRAM round trips set
// the time.
//
// What the design does about that (executors/cudaex.py:rms_norm_plan picks
// the launch from (N, D, dtype) alone, so a CUDA graph may capture it):
// - A row belongs to a group of warps that leaves each lane two 16-byte
//   vectors (4 warps at D=2048 in bf16, 8 in f32; up to 16 warps and 8
//   vectors for the widest rows): short dependency chains and many warps
//   in flight. On an H100, tools/rms_adamw_ab.py (its sweep of every
//   launch, and its A/B) found one warp a row, 8 vectors a lane, 32-82 %
//   slower at the serving shapes: a lone warp issues a whole row's
//   arithmetic.
// - Each lane's slice of w is loaded into registers before x, and every
//   vector of x before any arithmetic: the two round trips overlap, where
//   the TPU-shaped kernel read w after the reduction.
// - The sum of squares keeps one accumulator a vector, reduces by shuffles
//   in each warp, then through shared memory behind one named barrier a
//   row group (no block-wide barrier: a block holds 1-2 rows).
// - y is stored with the evict-first (streaming) hint: the norm reuses
//   neither x nor y.
// - The launch allows programmatic dependent launch (flag kFlagPdl): a
//   block starts and loads w while the previous kernel drains, then waits
//   (griddepcontrol.wait) before it touches x or y. It saved 0.2-0.6 us a
//   launch on an H100.
//
// tt_empty launches an empty kernel: the launch floor the timings compare
// against.

#include "common.cuh"

namespace {

constexpr int kFlagPdl = 1;

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Barrier `id` over the `threads` threads of one row group.
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Vectors v = k * row_threads + t (k < VPL) of one row into registers, all
// issued before any is used.
template <int VPL>
__device__ __forceinline__ void load_row(uint4 (&buf)[VPL], const uint4* __restrict__ src, int nvec,
                                         int t, int row_threads) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = k * row_threads + t;
    if (v < nvec) buf[k] = src[v];
  }
}

// The lane's sum of squares: one accumulator a vector, so the adds of
// different vectors overlap.
template <typename T, int VPL>
__device__ __forceinline__ float sum_squares(const uint4 (&buf)[VPL], int nvec, int t, int row_threads) {
  constexpr int V = tt::Vec<T>::N;
  float part[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    part[k] = 0.f;
    if (k * row_threads + t < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = tt::to_f32(e[j]);
        part[k] += f * f;
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) ss += part[k];
  return ss;
}

template <typename T, int VPL>
__device__ __forceinline__ void scale_store(const uint4 (&buf)[VPL], const uint4 (&wv)[VPL], float inv,
                                            uint4* __restrict__ dst, int nvec, int t, int row_threads) {
  constexpr int V = tt::Vec<T>::N;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = k * row_threads + t;
    if (v < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
      const T* we = reinterpret_cast<const T*>(&wv[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = tt::from_f32<T>(tt::to_f32(e[j]) * inv * tt::to_f32(we[j]));
      __stcs(dst + v, out);
    }
  }
}

// Rows of D elements; a row group of `wpr` warps owns a row, blockDim.x /
// (32 * wpr) groups a block, each lane VPL vectors of the row. A group of
// one warp reduces by shuffles alone; a wider group adds its warps' sums
// through shared memory behind one named barrier of its own (id 1 + group).
template <typename T, int VPL>
__global__ void __launch_bounds__(512) rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                        T* __restrict__ y, int n_rows, int D, int wpr,
                                                        float eps) {
  const int nvec = D / tt::Vec<T>::N;
  const int row_threads = 32 * wpr;
  const int t = threadIdx.x % row_threads, group = threadIdx.x / row_threads;
  const int row = blockIdx.x * (blockDim.x / row_threads) + group;

  uint4 wv[VPL];
  load_row<VPL>(wv, reinterpret_cast<const uint4*>(w), nvec, t, row_threads);
  grid_dependency_wait();  // returns at once unless launched with kFlagPdl
  if (row >= n_rows) return;  // the whole group: its barrier is its own

  uint4 buf[VPL];
  load_row<VPL>(buf, reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D), nvec, t, row_threads);
  float ss = tt::warp_sum(sum_squares<T, VPL>(buf, nvec, t, row_threads));
  if (wpr > 1) {
    __shared__ float partial[16];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) partial[warp] = ss;
    group_barrier(1 + group, row_threads);
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += partial[group * wpr + i];
  }
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  scale_store<T, VPL>(buf, wv, inv, reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * D), nvec, t,
                      row_threads);
}

__global__ void empty_kernel() {}

template <typename... KArgs, typename... Args>
cudaError_t launch_ex(void (*kernel)(KArgs...), int blocks, int threads, bool pdl, cudaStream_t stream,
                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int n_rows, int d, float eps, int vpl, int wpr,
                   int rows_per_block, int flags, cudaStream_t stream) {
  const int groups = rows_per_block, blocks = (n_rows + groups - 1) / groups;
  const int threads = 32 * wpr * groups;
  const bool pdl = flags & kFlagPdl;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  switch (vpl) {
    case 1: return launch_ex(rms_norm_kernel<T, 1>, blocks, threads, pdl, stream, xt, wt, yt, n_rows, d, wpr, eps);
    case 2: return launch_ex(rms_norm_kernel<T, 2>, blocks, threads, pdl, stream, xt, wt, yt, n_rows, d, wpr, eps);
    case 4: return launch_ex(rms_norm_kernel<T, 4>, blocks, threads, pdl, stream, xt, wt, yt, n_rows, d, wpr, eps);
    case 8: return launch_ex(rms_norm_kernel<T, 8>, blocks, threads, pdl, stream, xt, wt, yt, n_rows, d, wpr, eps);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n_rows, d) and w (d,) of one dtype, contiguous and 16-byte aligned, with
// d a multiple of the 16-byte vector width; y like x. The launch is
// cudaex.rms_norm_plan's: `vpl` vectors a lane (1, 2, 4 or 8), `wpr` warps
// a row (at most 16), `rows_per_block` rows a block (at most 512 threads, 15
// rows of more than one warp), ceil(n_rows / rows_per_block) blocks; `flags`
// bit 0: programmatic dependent launch. A launch that would leave part of a
// row unread is refused. Returns the launch's error, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int tt_rms_norm(const void* x, const void* w, void* y, int n_rows, int d, float eps, int dtype,
                           int vpl, int wpr, int rows_per_block, int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = dtype == tt::kF32 ? 4 : 8;
  if (n_rows <= 0 || d <= 0 || d % V || wpr < 1 || wpr > 16 || rows_per_block < 1 ||
      32 * wpr * rows_per_block > 512 || (wpr > 1 && rows_per_block > 15) ||
      static_cast<long long>(vpl) * 32 * wpr < d / V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case tt::kF32: err = launch<float>(x, w, y, n_rows, d, eps, vpl, wpr, rows_per_block, flags, s); break;
    case tt::kBF16: err = launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, vpl, wpr, rows_per_block, flags, s); break;
    case tt::kF16: err = launch<__half>(x, w, y, n_rows, d, eps, vpl, wpr, rows_per_block, flags, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
