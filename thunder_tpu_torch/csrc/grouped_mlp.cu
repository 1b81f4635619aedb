// Grouped-expert SwiGLU MLP for Hopper (sm_90a).
//
// Replaces thunder_tpu/executors/pallasex.py:grouped_mlp_fused (:2004,
// kernel _grouped_mlp_kernel :1977). For capacity bins x (E, cap, D), the
// experts' panels Wg, Wu (E, D, H) and Wd (E, H, D), all of one dtype T,
// and group_sizes (E,) int32 on the device, each expert e and bin row
// r < n_e = min(group_sizes[e], cap):
//
//   g = x[e, r]·Wg[e], u = x[e, r]·Wu[e]          (f32 sums)
//   h = T((g · 1/(1 + exp(−g))) · u)              (f32, one rounding to T)
//   y[e, r] = T(h·Wd[e])                          (f32 sum)
//
// and y[e, r] = 0 for n_e <= r < cap (the TPU kernel computes those rows
// from the dispatch scatter's zero fill; here they are zero whatever the
// bins hold). h is rounded to the weights' dtype before the down product,
// as the reference rounds it (:1999).
//
// What bounds it: at decode (cap = 8, a few live rows an expert) every live
// expert's three panels are read for a handful of rows, so the time is the
// panels' bytes over the memory rate (Llama-3-1B widths, E = 8, D = 2048,
// H = 1024, bf16: 100 MB, ~30 µs). At prefill (2,048 live rows) and in
// training (4,096, f32) the three products are bound by operations.
//
// Design (a first, simple kernel): two __global__ stages on one stream,
// behind one entry point. Stage 1 multiplies a 64-row block of one
// expert's bin by 64 columns of Wg and of Wu, takes the SwiGLU of the two
// f32 accumulators in registers and writes h (E, cap, H) in T to a scratch
// the wrapper allocates; stage 2 multiplies h by Wd into y. One stage
// cannot hold a block's f32 h (64 x 1024) and its y accumulator (64 x
// 2048). Both stages are one template: a grid of (column tiles, row
// blocks, experts); each block reads n_e from device memory (no host
// sync, so the launch can sit in a CUDA graph), and a row block that lies
// wholly at or past n_e reads no weights and does no math (stage 2 writes
// its zeros). Tiles stream through shared memory in three cp.async stages
// (zero-filled past the ragged edges: rows at or past n_e, k past K,
// columns past N), so a cap that is not a multiple of 64 (decode's 8) and
// widths that are not multiples of the tile are masked. 4 warps each own
// 16 rows of the block: bf16 by `mma.sync.m16n8k16` with f32
// accumulators (ldmatrix fragments), f32 by FFMA register tiles with the
// same ownership (tf32 would round the operands). Every output row is
// summed over k in one fixed order, with no split-K, so a row's result
// does not depend on the other rows of its block. Later work: wgmma with
// TMA-fed tiles, larger tiles at prefill, and skipping dead experts'
// blocks at launch.

#include "flash_common.cuh"

namespace {

using tt::flash::cp_async16;
using tt::flash::cp_async_commit;
using tt::flash::cp_async_wait;

constexpr int BM = 64, BN = 64, WARPS = 4, THREADS = WARPS * 32, STAGES = 3;

template <typename T> struct Tile {
  static constexpr int V = tt::Vec<T>::N;        // elements a 16-byte copy
  static constexpr int BK = 64 / sizeof(T);      // 64 bytes of k a stage
  static constexpr int LDA = BK + V;             // padded row strides
  static constexpr int LDB = BN + V;
  static constexpr int A = BM * LDA, B = BK * LDB;  // elements a tile
};

template <typename T, bool GATE>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * (Tile<T>::A + (GATE ? 2 : 1) * Tile<T>::B) * sizeof(T);
}

// C[e] = A[e] (cap x K) · B0[e] (K x N), row-major, rows past n_e masked.
// GATE: C = T(silu(A·B0) ⊙ (A·B1)), rows < n_e stored (stage 2 never reads
// the others). Otherwise C = T(A·B0) for rows < n_e and 0 for the rest of
// [0, cap).
template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS)
    grouped_kernel(const T* __restrict__ A, const T* __restrict__ B0, const T* __restrict__ B1,
                   T* __restrict__ C, const int* __restrict__ group_sizes, int cap, int K, int N) {
  using L = Tile<T>;
  constexpr int V = L::V, BK = L::BK, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live = min(max(group_sizes[e], 0), cap);
  C += static_cast<size_t>(e) * cap * N;
  if (m0 >= live) {
    if constexpr (!GATE) {  // a dead block's rows of y are zeros
      for (int i = threadIdx.x; i < BM * (BN / V); i += THREADS) {
        const int r = m0 + i / (BN / V), n = n0 + (i % (BN / V)) * V;
        if (r < cap && n < N)
          *reinterpret_cast<uint4*>(C + static_cast<size_t>(r) * N + n) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  A += static_cast<size_t>(e) * cap * K;
  B0 += static_cast<size_t>(e) * K * N;
  if constexpr (GATE) B1 += static_cast<size_t>(e) * K * N;

  const int warp = threadIdx.x >> 5;
  const int n_k = (K + BK - 1) / BK;
  constexpr int STAGE = L::A + (GATE ? 2 : 1) * L::B;

  auto load = [&](int stage, int kt) {
    T* As = smem + stage * STAGE;
    T* Bs = As + L::A;
    const int k0 = kt * BK;
    constexpr int ACH = BK / V;  // 16-byte chunks of an A row
    for (int i = threadIdx.x; i < BM * ACH; i += THREADS) {
      const int r = i / ACH, k = k0 + (i % ACH) * V;
      const bool ok = m0 + r < live && k < K;
      cp_async16(As + r * L::LDA + (i % ACH) * V, ok ? A + static_cast<size_t>(m0 + r) * K + k : A, ok);
    }
    constexpr int BCH = BN / V;  // 16-byte chunks of a B row
    for (int i = threadIdx.x; i < BK * BCH; i += THREADS) {
      const int r = i / BCH, n = n0 + (i % BCH) * V;
      const bool ok = k0 + r < K && n < N;
      const size_t off = static_cast<size_t>(k0 + r) * N + n;
      cp_async16(Bs + r * L::LDB + (i % BCH) * V, ok ? B0 + off : B0, ok);
      if constexpr (GATE) cp_async16(Bs + L::B + r * L::LDB + (i % BCH) * V, ok ? B1 + off : B1, ok);
    }
  };

  float acc0[NT][4], acc1[GATE ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc0[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < (GATE ? NT : 1); ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  const bool warp_live = m0 + 16 * warp < live;  // rows of this warp below n_e
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + STAGES - 1 < n_k) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    if (warp_live) {
      const T* As = smem + (kt % STAGES) * STAGE + 16 * warp * L::LDA;
      const T* Bs = smem + (kt % STAGES) * STAGE + L::A;
      tt::flash::warp_mma<T, NT, BK, false>(acc0, As, L::LDA, Bs, L::LDB);
      if constexpr (GATE) tt::flash::warp_mma<T, NT, BK, false>(acc1, As, L::LDA, Bs + L::B, L::LDB);
    }
  }
  cp_async_wait<0>();

  const int lane = threadIdx.x & 31;
  const int rows = GATE ? live : cap;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    if (n >= N) continue;  // N is even (a multiple of the vector): n + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * warp + (lane >> 2) + 8 * h;
      if (r >= rows) continue;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float g = acc0[j][2 * h + c];
        if constexpr (GATE) {
          v[c] = g * (1.f / (1.f + expf(-g))) * acc1[j][2 * h + c];
        } else {
          v[c] = r < live ? g : 0.f;
        }
      }
      T* p = C + static_cast<size_t>(r) * N + n;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = tt::flash::pack2(tt::from_f32<T>(v[0]), tt::from_f32<T>(v[1]));
      }
    }
  }
}

template <typename T, bool GATE>
int launch_stage(const T* A, const T* B0, const T* B1, T* C, const int* gs, int E, int cap, int K, int N,
                 cudaStream_t stream) {
  auto kernel = grouped_kernel<T, GATE>;
  const size_t smem = smem_bytes<T, GATE>();
  const cudaError_t err = tt::flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (cap + BM - 1) / BM, E);
  kernel<<<grid, THREADS, smem, stream>>>(A, B0, B1, C, gs, cap, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* bins, const void* wg, const void* wu, const void* wd, const int* gs, void* h, void* y,
        int E, int cap, int D, int H, cudaStream_t s) {
  const int rc = launch_stage<T, true>(static_cast<const T*>(bins), static_cast<const T*>(wg),
                                       static_cast<const T*>(wu), static_cast<T*>(h), gs, E, cap, D, H, s);
  if (rc) return rc;
  return launch_stage<T, false>(static_cast<const T*>(h), static_cast<const T*>(wd), nullptr,
                                static_cast<T*>(y), gs, E, cap, H, D, s);
}

}  // namespace

// bins (E, cap, D), w_gate and w_up (E, D, H), w_down (E, H, D), the scratch
// h (E, cap, H) and y (E, cap, D), all f32 or all bf16; group_sizes (E,) int32;
// all contiguous and 16-byte aligned, D and H multiples of the 16-byte
// vector. Returns the first failing launch's cudaGetLastError().
extern "C" int tt_grouped_mlp(const void* bins, const void* w_gate, const void* w_up, const void* w_down,
                              const void* group_sizes, void* h, void* y, int E, int cap, int D, int H,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  switch (dtype) {
    case tt::kF32:
      return run<float>(bins, w_gate, w_up, w_down, gs, h, y, E, cap, D, H, s);
    case tt::kBF16:
      return run<__nv_bfloat16>(bins, w_gate, w_up, w_down, gs, h, y, E, cap, D, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
