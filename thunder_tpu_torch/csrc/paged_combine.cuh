// The combine of the split paged-attention kernels (csrc/paged_attention.cu:
// the decode; csrc/paged_chunk_attention.cu: chunks and verify): a split
// block writes its rows' unnormalised f32 (o, m, l) partials, (rows,
// n_split, D + 2) with m in log2 units, and this kernel merges each row's
// live splits into o. A row's live length is min(lens[b·Tq + t] + add,
// npm·ps) for row (b, h, t) = (row / (H·Tq), row / Tq % H, row % Tq): the
// decode's seq_lens (Tq = 1, add 0) or a query's position (add 1); its live
// splits are the ceil(length / split) first. A row with at most one live
// split was written by its split block, so the combine skips it.
#pragma once

#include "flash_common.cuh"  // cp.async, kNegInf; includes common.cuh

namespace {

constexpr int kCombineThreads = 128;
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kMaxSplitLanes = 4;  // n_split <= 128: 128-token splits of 16k tokens

// One warp per row: the live splits' partials rescaled to their common max,
// into o. Lane s holds split s's max and weight; each lane owns columns
// lane, lane + 32, ... (D <= 32 · kCombineCols) and loads eight splits'
// values of all of them before it adds any.
template <typename T, int kCombineCols>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ lens, int add,
                         T* __restrict__ out, int rows, int H, int Tq, int D, int ps, int npm,
                         int split, int n_split) {
  using tt::flash::kNegInf;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pr = part + static_cast<size_t>(row) * n_split * (D + 2);
  // every split's m and l are read beside the row's length and the dead ones
  // dropped after it (their values were never written): one dependent read less
  float mj[kMaxSplitLanes], lj[kMaxSplitLanes], w[kMaxSplitLanes];
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    const int s = lane + 32 * j;
    mj[j] = s < n_split ? pr[s * (D + 2) + D] : kNegInf;
    lj[j] = s < n_split ? pr[s * (D + 2) + D + 1] : 0.f;
  }
  const int len = min(lens[row / (H * Tq) * Tq + row % Tq] + add, npm * ps);
  const int n_live = len <= 0 ? 0 : (len + split - 1) / split;
  if (n_live <= 1) return;  // written by the split kernel
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    const int s = lane + 32 * j;
    mj[j] = s < n_live ? mj[j] : kNegInf;
    lj[j] = s < n_live ? lj[j] : 0.f;
    mx = fmaxf(mx, mj[j]);
  }
  mx = tt::warp_max(mx);
  float lsum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    w[j] = exp2f(mj[j] - mx);  // 0 past n_live
    lsum += lj[j] * w[j];
  }
  lsum = tt::warp_sum(lsum);
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  float acc[kCombineCols];
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += 8) {
    float x[8][kCombineCols];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c) {
        const int s = s0 + u, d = lane + 32 * c;
        x[u][c] = s < n_live && d < D ? pr[s * (D + 2) + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + u;
      float ws = w[0];
#pragma unroll
      for (int j = 1; j < kMaxSplitLanes; ++j) ws = (s >> 5) == j ? w[j] : ws;
      ws = __shfl_sync(0xffffffffu, ws, s & 31);
#pragma unroll
      for (int c = 0; c < kCombineCols; ++c) acc[c] = fmaf(x[u][c], ws, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCombineCols; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[static_cast<size_t>(row) * D + d] = tt::from_f32<T>(acc[c] * inv);
  }
}

// Columns a lane holds: as few as D needs (registers, so more warps in flight).
template <typename T>
int launch_combine(const float* part, const int* lens, int add, T* out, int rows, int H, int Tq,
                   int D, int ps, int npm, int split, int n_split, cudaStream_t stream) {
  auto kernel = D <= 64 ? paged_combine_kernel<T, 2>
                        : (D <= 128 ? paged_combine_kernel<T, 4> : paged_combine_kernel<T, 8>);
  kernel<<<(rows + kCombineWarps - 1) / kCombineWarps, kCombineThreads, 0, stream>>>(
      part, lens, add, out, rows, H, Tq, D, ps, npm, split, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
