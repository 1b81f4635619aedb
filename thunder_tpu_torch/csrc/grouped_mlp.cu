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
// Two stages on one stream behind one entry point: gate/up (x -> h, a
// scratch (E, cap, H) the wrapper allocates) and down (h -> y). One block
// cannot hold a row block's f32 h (rows x 1024) and its y accumulator (rows
// x 2048). In every route each block reads n_e from device memory (no host
// sync, so the launch can sit in a CUDA graph; the grid comes from E, cap,
// D and H alone), a block wholly at or past n_e reads no weights (the down
// stage writes its zero rows), and each output row is summed over k in one
// fixed order with no split across blocks, so a row's result does not
// depend on the other rows of its block. The route is the caller's
// (executors/cudaex.py: grouped_mlp_plan), by what bounds each shape:
//
//   ffma (f32; training under autocast: cap 512, D 2048, H 1024). Bound by
//     operations: 48 GFLOP at 67 TFLOP/s FFMA (tf32 would round the
//     operands the plain version and the reference keep). Register-blocked
//     tiles: 256 threads, each 8 rows x 8 columns of a 128 x 128 down tile
//     (8 x 4 of g and of u in a 128 x 64 gate tile); 16-deep k tiles, x
//     stored k-major in shared memory so each thread reads its rows and
//     columns as float4; the next k tile's loads in registers while the
//     current one is multiplied (two shared buffers, one barrier a tile).
//     The kernel this replaces gave each thread a 16-row warp strip with
//     little register blocking, so its FFMAs waited on shared memory.
//   wgmma (bf16, cap > 8: prefill). Bound by operations at 989 TFLOP/s
//     (26 GFLOP at a 1,024-token bucket). 128 x 128 output tiles, one a
//     block: a producer warpgroup whose one thread streams the x tile
//     (K-major, TMA over (E, cap, D)) and the panel tiles (MN-major: H, or
//     D, contiguous; two 64-column TMA boxes over (E, K, N)) through
//     mbarrier stages, and two consumer warpgroups of 64 rows, m64n128k16
//     products with f32 accumulators (g and u side by side in the gate
//     stage), one stage's products in flight while the previous stage is
//     released; setmaxnreg moves registers to the consumers. TMA zero-fills
//     past cap, K and N; rows at or past n_e of a partly live block are
//     loaded and multiplied (each output row depends only on its own input
//     row) and never stored. A persistent version (one block an SM walking
//     the live tiles first) measured slower on an H100 80GB HBM3 at 700 W:
//     0.106 against 0.099 ms at the prefill shape (tools/fp8_grouped_ab.py).
//   decode (bf16, cap <= 8). Bound by bytes: the live experts' panels (12.6
//     MB an expert at Llama-3-1B widths) are read for a handful of rows.
//     Each block streams a column slice of one expert's panels over all of
//     K, 8 bytes a thread a k row, the next 4 or 8 k rows' loads in flight
//     while a thread multiplies the current ones, and every k row of the
//     slice is read by exactly one thread: the x rows (up to 8) sit in
//     shared memory as f32, k-major; each thread sums its k rows in order
//     for the first 2, 4 or 8 rows, as many as the expert's n_e needs, then
//     the block adds the k-lanes' partial sums in a fixed order. Gate
//     slices are 32 columns, down slices 64, so every SM streams. An expert
//     with n_e = 0 reads nothing.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace tt::sm90;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu_mul(float g, float u) { return g * (1.f / (1.f + expf(-g))) * u; }

// Zeros into rows [r0, r1) x columns [c0, c1) of a (rows, N) matrix of T,
// 16 bytes at a time (N and c0 multiples of the vector), by threads of the block.
template <typename T>
__device__ __forceinline__ void zero_tile(T* C, int N, int r0, int r1, int c0, int c1) {
  constexpr int V = tt::Vec<T>::N;
  const int per_row = (c1 - c0 + V - 1) / V;
  for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += blockDim.x) {
    const int r = r0 + i / per_row, c = c0 + (i % per_row) * V;
    *reinterpret_cast<uint4*>(C + static_cast<size_t>(r) * N + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// route ffma: f32
// ---------------------------------------------------------------------------

namespace ffma {

constexpr int BM = 128, BK = 16, THREADS = 256;

// C[e] = A[e] (cap x K) · B0[e] (K x N), row-major. GATE: C = silu(A·B0) ⊙
// (A·B1) for rows < n_e (the down stage never reads the others). Otherwise
// C = A·B0 for rows < n_e and 0 for the rest of [0, cap).
template <bool GATE>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_mlp_ffma(const float* __restrict__ A, const float* __restrict__ B0, const float* __restrict__ B1,
                     float* __restrict__ C, const int* __restrict__ group_sizes, int cap, int K, int N) {
  constexpr int BN = GATE ? 64 : 128;
  constexpr int NB = GATE ? 2 : 1;     // panels
  constexpr int NC = GATE ? 4 : 8;     // columns a thread, each panel
  __shared__ __align__(16) float As[2][BK][BM];       // k-major
  __shared__ __align__(16) float Bs[2][NB][BK][BN];

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live = min(max(group_sizes[e], 0), cap);
  C += static_cast<size_t>(e) * cap * N;
  if (m0 >= live) {
    if constexpr (!GATE) zero_tile(C, N, m0, min(m0 + BM, cap), n0, min(n0 + BN, N));
    return;
  }
  A += static_cast<size_t>(e) * cap * K;
  B0 += static_cast<size_t>(e) * K * N;
  if constexpr (GATE) B1 += static_cast<size_t>(e) * K * N;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // this thread's rows m0 + 4·ty + (i & 3) + 64·(i >> 2); columns
  // n0 + 4·tx + (j & 3) (+ 64·(j >> 2) in the down stage)
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[2], rb[2];
  // k tile kt into registers: x rows m0 + (i & 127), k 4·(i >> 7) (a warp
  // reads 32 rows, so its transposed stores hit 32 banks); panel rows k
  // and 16-byte column chunks
  auto load = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + THREADS * j, row = m0 + (i & (BM - 1)), k = k0 + 4 * (i >> 7);
      ra[j] = row < live && k < K ? *reinterpret_cast<const float4*>(A + static_cast<size_t>(row) * K + k) : zero;
    }
    if constexpr (GATE) {
      const int k = k0 + (tid >> 4), n = n0 + 4 * (tid & 15);
      const bool ok = k < K && n < N;
      const size_t off = static_cast<size_t>(k) * N + n;
      rb[0] = ok ? *reinterpret_cast<const float4*>(B0 + off) : zero;
      rb[1] = ok ? *reinterpret_cast<const float4*>(B1 + off) : zero;
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + THREADS * j, k = k0 + (i >> 5), n = n0 + 4 * (i & 31);
        rb[j] = k < K && n < N ? *reinterpret_cast<const float4*>(B0 + static_cast<size_t>(k) * N + n) : zero;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + THREADS * j, row = i & (BM - 1), k = 4 * (i >> 7);
      As[buf][k][row] = ra[j].x;
      As[buf][k + 1][row] = ra[j].y;
      As[buf][k + 2][row] = ra[j].z;
      As[buf][k + 3][row] = ra[j].w;
    }
    if constexpr (GATE) {
      *reinterpret_cast<float4*>(&Bs[buf][0][tid >> 4][4 * (tid & 15)]) = rb[0];
      *reinterpret_cast<float4*>(&Bs[buf][1][tid >> 4][4 * (tid & 15)]) = rb[1];
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = tid + THREADS * j;
        *reinterpret_cast<float4*>(&Bs[buf][0][i >> 5][4 * (i & 31)]) = rb[j];
      }
    }
  };

  float acc0[8][NC], acc1[GATE ? 8 : 1][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc0[i][j] = 0.f;
      if constexpr (GATE) acc1[i][j] = 0.f;
    }

  const int n_k = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load(kt + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + 4 * ty]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][0][k][4 * tx]);
      if constexpr (GATE) {
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][1][k][4 * tx]);
        const float b[4] = {b0.x, b0.y, b0.z, b0.w}, u[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc0[i][j] = fmaf(a[i], b[j], acc0[i][j]);
            acc1[i][j] = fmaf(a[i], u[j], acc1[i][j]);
          }
      } else {
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][0][k][64 + 4 * tx]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc0[i][j] = fmaf(a[i], b[j], acc0[i][j]);
      }
    }
    if (kt + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (r >= (GATE ? live : cap)) continue;
#pragma unroll
    for (int jb = 0; jb < NC / 4; ++jb) {
      const int n = n0 + 4 * tx + 64 * jb;
      if (n >= N) continue;  // N % 4 == 0: a 4-column chunk is all in or all out
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (GATE) {
          v[j] = silu_mul(acc0[i][4 * jb + j], acc1[i][4 * jb + j]);
        } else {
          v[j] = r < live ? acc0[i][4 * jb + j] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(C + static_cast<size_t>(r) * N + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool GATE>
int launch(const float* A, const float* B0, const float* B1, float* C, const int* gs, int E, int cap, int K,
           int N, cudaStream_t s) {
  const int BN = GATE ? 64 : 128;
  const dim3 grid((N + BN - 1) / BN, (cap + BM - 1) / BM, E);
  grouped_mlp_ffma<GATE><<<grid, THREADS, 0, s>>>(A, B0, B1, C, gs, cap, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// route wgmma: bf16 prefill
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;  // BK bf16: one 128-byte swizzled row
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kABytes = BM * 128;              // the x (or h) tile, K-major
constexpr int kBBytes = BK * 128 * (BN / 64);  // a panel tile: two 64-column blocks, MN-major

template <bool GATE> struct Layout {
  static constexpr int kPanels = GATE ? 2 : 1;
  static constexpr int kStage = kABytes + kPanels * kBBytes;  // 48 or 32 KB
  static constexpr int kStages = GATE ? 4 : 6;
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;  // + alignment slack
};

template <bool GATE>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_mlp_wgmma(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b0,
                      const __grid_constant__ CUtensorMap tm_b1, bf16* __restrict__ C,
                      const int* __restrict__ group_sizes, int cap, int K, int N) {
  using L = Layout<GATE>;
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live = min(max(group_sizes[e], 0), cap);
  C += static_cast<size_t>(e) * cap * N;
  if (m0 >= live) {
    if constexpr (!GATE) zero_tile(C, N, m0, min(m0 + BM, cap), n0, min(n0 + BN, N));
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kStages * L::kStage);
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % L::kStages;
        if (kt >= L::kStages) mbar_wait(&empty[s], (kt / L::kStages - 1) & 1);  // tile kt − kStages is consumed
        unsigned char* st = smem + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        tma_load_3d(st, &tm_a, &full[s], kt * BK, m0, e);
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          tma_load_3d(st + kABytes + cb * BK * 128, &tm_b0, &full[s], n0 + 64 * cb, kt * BK, e);
          if constexpr (GATE)
            tma_load_3d(st + kABytes + kBBytes + cb * BK * 128, &tm_b1, &full[s], n0 + 64 * cb, kt * BK, e);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // warpgroup w owns rows m0 + 64·w .. + 63; accumulator element i sits at
  // row 16·warp + gq + 8·((i>>1)&1) of them, column 8·(i>>2) + 2c + (i&1)
  const int w = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, c = lane & 3;
  const uint32_t base = smem_u32(smem);
  float acc0[64], acc1[GATE ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc0[i] = 0.f;
    if constexpr (GATE) acc1[i] = 0.f;
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % L::kStages;
    mbar_wait(&full[s], (kt / L::kStages) & 1);
    const uint32_t a_s = base + s * L::kStage + w * 64 * 128;
    const uint32_t b_s = base + s * L::kStage + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(a_s + 32 * kk, 16, 1024);
      wgmma_ss<0, 1>(acc0, da, desc_sw128(b_s + 2048 * kk, BK * 128, 1024), 1, bf16{});
      if constexpr (GATE)
        wgmma_ss<0, 1>(acc1, da, desc_sw128(b_s + kBBytes + 2048 * kk, BK * 128, 1024), 1, bf16{});
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage kt − 1's products are done: release it, keep stage kt's in flight
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % L::kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  if constexpr (GATE) fence_regs(acc1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 64 * w + 16 * warp + gq + 8 * r;
    if (row >= (GATE ? live : cap)) continue;
    bf16* c_row = C + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      if (col >= N) continue;  // N % 8 == 0: an 8-column slice is all in or all out
      float v0 = acc0[4 * j + 2 * r], v1 = acc0[4 * j + 2 * r + 1];
      if constexpr (GATE) {
        v0 = silu_mul(v0, acc1[4 * j + 2 * r]);
        v1 = silu_mul(v1, acc1[4 * j + 2 * r + 1]);
      } else if (row >= live) {
        v0 = v1 = 0.f;
      }
      *reinterpret_cast<uint32_t*>(c_row + col) = pack_f32x2(v0, v1, bf16{});
    }
  }
}

template <bool GATE>
int launch(const bf16* A, const bf16* B0, const bf16* B1, bf16* C, const int* gs, int E, int cap, int K, int N,
           cudaStream_t s) {
  CUtensorMap ma, mb0, mb1;
  int err = make_map_3d(&ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, cap, E, BM);
  if (!err) err = make_map_3d(&mb0, B0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, E, BK);
  if (!err) err = make_map_3d(&mb1, GATE ? B1 : B0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, K, E, BK);
  if (err) return err;
  auto kernel = grouped_mlp_wgmma<GATE>;
  const cudaError_t ce =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<GATE>::kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((N + BN - 1) / BN, (cap + BM - 1) / BM, E);
  kernel<<<grid, kThreads, Layout<GATE>::kSmem, s>>>(ma, mb0, mb1, C, gs, cap, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// route decode: bf16, cap <= 8
// ---------------------------------------------------------------------------

namespace dec {

constexpr int ROWS = 8, THREADS = 256, WARPS = THREADS / 32;
constexpr int KC = 2048;  // k rows of x staged in shared memory at a time

template <bool GATE> struct Shape {
  static constexpr int COLS = GATE ? 32 : 64;       // columns a block
  static constexpr int LANES = COLS / 4;            // lanes across a k row (8 bytes, 4 columns, each)
  static constexpr int KSTEP = WARPS * 32 / LANES;  // k rows the block reads a step
  static constexpr int UNROLL = GATE ? 4 : 8;       // k rows a thread loads a step, the next step's in flight
};

inline int smem_bytes(int K) { return ROWS * (K < KC ? K : KC) * static_cast<int>(sizeof(float)); }

template <int R> __device__ __forceinline__ void load_x(const float* p, float (&x)[R]) {
  if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 v = reinterpret_cast<const float4*>(p)[g];
      x[4 * g] = v.x, x[4 * g + 1] = v.y, x[4 * g + 2] = v.z, x[4 * g + 3] = v.w;
    }
  }
}

// The block's work for live <= R rows (R = 2, 4 or 8: the products of rows
// past n_e are not computed): red gets each warp's partial sums.
template <bool GATE, int R>
__device__ __forceinline__ void decode_rows(const bf16* __restrict__ A, const bf16* __restrict__ B0,
                                            const bf16* __restrict__ B1, float* xs_raw,
                                            float (*red)[GATE ? 2 : 1][ROWS][Shape<GATE>::COLS], int live, int K,
                                            int N, int n0) {
  using S = Shape<GATE>;
  constexpr int NP = GATE ? 2 : 1, U = S::UNROLL;
  float(*xs)[R] = reinterpret_cast<float(*)[R]>(xs_raw);  // x rows k-major: xs[k][r]
  const int kl = threadIdx.x / S::LANES;                  // this thread's k-lane: k rows kl, kl + KSTEP, ...
  const int n = n0 + 4 * (threadIdx.x % S::LANES);        // its 4 columns
  const bool col_ok = n < N;                              // N % 8 == 0: 4 columns all in or all out
  float acc[NP][R][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][r][j] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    const int kn = min(KC, K - kc);
    // U k rows a step, rows kl + KSTEP·(U·step + u); the next step's loads
    // are issued before this step's products (the first step's before x is
    // staged)
    uint2 cur[U][NP], nxt[U][NP];
    auto load = [&](uint2 (&v)[U][NP], int k0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * S::KSTEP;
        const bool ok = col_ok && k < kn;
        const size_t off = static_cast<size_t>(kc + k) * N + n;
        v[u][0] = ok ? *reinterpret_cast<const uint2*>(B0 + off) : make_uint2(0u, 0u);
        if constexpr (GATE) v[u][1] = ok ? *reinterpret_cast<const uint2*>(B1 + off) : make_uint2(0u, 0u);
      }
    };
    load(cur, kl);
    __syncthreads();  // the previous chunk's xs is consumed
    // x rows < n_e, 8 k a 16-byte load (K % 8 == 0), stored k-major
#pragma unroll 4
    for (int i = threadIdx.x; i < R * (kn / 8); i += THREADS) {
      const int r = i % R, k = 8 * (i / R);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < live) v = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(r) * K + kc + k);
      const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[k + j][r] = __bfloat162float(b[j]);
    }
    __syncthreads();
    for (int k0 = kl; k0 < kn; k0 += U * S::KSTEP) {
      load(nxt, k0 + U * S::KSTEP);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * S::KSTEP;
        if (k >= kn) break;
        float x[R];
        load_x<R>(&xs[k][0], x);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const bf16* wb = reinterpret_cast<const bf16*>(&cur[u][p]);
          float wf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wf[j] = __bfloat162float(wb[j]);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[p][r][j] = fmaf(x[r], wf[j], acc[p][r][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int p = 0; p < NP; ++p) cur[u][p] = nxt[u][p];
    }
  }

  // the warp's k-lanes added by shuffles (the same sum in each of them)
  const int lane = threadIdx.x & 31, lc = 4 * (threadIdx.x % S::LANES);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[p][r][j];
#pragma unroll
        for (int o = S::LANES; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane < S::LANES) red[threadIdx.x >> 5][p][r][lc + j] = v;
      }
}

// The block's column slice [n0, n0 + COLS) of expert blockIdx.y over all of
// K; rows < n_e of x. GATE writes h = silu(x·B0) ⊙ (x·B1) for rows < n_e,
// otherwise C = x·B0 for rows < n_e and 0 for the rest of [0, cap).
template <bool GATE>
__global__ void __launch_bounds__(THREADS)
    grouped_mlp_decode(const bf16* __restrict__ A, const bf16* __restrict__ B0, const bf16* __restrict__ B1,
                       bf16* __restrict__ C, const int* __restrict__ group_sizes, int cap, int K, int N) {
  using S = Shape<GATE>;
  constexpr int NP = GATE ? 2 : 1;
  extern __shared__ __align__(16) float xs_raw[];
  __shared__ float red[WARPS][NP][ROWS][S::COLS];  // one partial sum a warp

  const int e = blockIdx.y, n0 = blockIdx.x * S::COLS;
  const int live = min(max(group_sizes[e], 0), cap);
  C += static_cast<size_t>(e) * cap * N;
  if (live == 0) {
    if constexpr (!GATE) zero_tile(C, N, 0, cap, n0, min(n0 + S::COLS, N));
    return;
  }
  A += static_cast<size_t>(e) * cap * K;
  B0 += static_cast<size_t>(e) * K * N;
  if constexpr (GATE) B1 += static_cast<size_t>(e) * K * N;
  if (live <= 2) {
    decode_rows<GATE, 2>(A, B0, B1, xs_raw, red, live, K, N, n0);
  } else if (live <= 4) {
    decode_rows<GATE, 4>(A, B0, B1, xs_raw, red, live, K, N, n0);
  } else {
    decode_rows<GATE, 8>(A, B0, B1, xs_raw, red, live, K, N, n0);
  }
  __syncthreads();
  // the warps' sums in warp order: one fixed order for every row
  for (int o = threadIdx.x; o < ROWS * S::COLS; o += THREADS) {
    const int r = o / S::COLS, cc = o % S::COLS, col = n0 + cc;
    if (r >= (GATE ? live : cap) || col >= N) continue;
    float v[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      v[p] = 0.f;
      if (r < live) {
#pragma unroll
        for (int l = 0; l < WARPS; ++l) v[p] += red[l][p][r][cc];
      }
    }
    float out;
    if constexpr (GATE) {
      out = silu_mul(v[0], v[1]);
    } else {
      out = r < live ? v[0] : 0.f;
    }
    C[static_cast<size_t>(r) * N + col] = __float2bfloat16(out);
  }
}

template <bool GATE>
int launch(const bf16* A, const bf16* B0, const bf16* B1, bf16* C, const int* gs, int E, int cap, int K, int N,
           cudaStream_t s) {
  auto kernel = grouped_mlp_decode<GATE>;
  const cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(K));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((N + Shape<GATE>::COLS - 1) / Shape<GATE>::COLS, E);
  kernel<<<grid, THREADS, smem_bytes(K), s>>>(A, B0, B1, C, gs, cap, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dec

enum Route : int { kFfma = 0, kWgmma = 1, kDecode = 2 };

}  // namespace

// bins (E, cap, D), w_gate and w_up (E, D, H), w_down (E, H, D), the scratch
// h (E, cap, H) and y (E, cap, D), all f32 or all bf16; group_sizes (E,) int32;
// all contiguous and 16-byte aligned, D and H multiples of the 16-byte
// vector. route (executors/cudaex.py: grouped_mlp_plan): 0 ffma (f32), 1
// wgmma (bf16), 2 decode (bf16, cap <= 8); another pairing is refused.
// Launches the gate/up stage and the down stage on `stream`. Returns the
// first CUDA error.
extern "C" int tt_grouped_mlp(const void* bins, const void* w_gate, const void* w_up, const void* w_down,
                              const void* group_sizes, void* h, void* y, int E, int cap, int D, int H,
                              int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == tt::kF32 && route == kFfma) {
    const int rc = ffma::launch<true>(static_cast<const float*>(bins), static_cast<const float*>(w_gate),
                                      static_cast<const float*>(w_up), static_cast<float*>(h), gs, E, cap, D, H, s);
    if (rc) return rc;
    return ffma::launch<false>(static_cast<const float*>(h), static_cast<const float*>(w_down), nullptr,
                               static_cast<float*>(y), gs, E, cap, H, D, s);
  }
  if (dtype == tt::kBF16 && route == kWgmma) {
    const int rc = wg::launch<true>(static_cast<const bf16*>(bins), static_cast<const bf16*>(w_gate),
                                    static_cast<const bf16*>(w_up), static_cast<bf16*>(h), gs, E, cap, D, H, s);
    if (rc) return rc;
    return wg::launch<false>(static_cast<const bf16*>(h), static_cast<const bf16*>(w_down), nullptr,
                             static_cast<bf16*>(y), gs, E, cap, H, D, s);
  }
  if (dtype == tt::kBF16 && route == kDecode && cap <= dec::ROWS) {
    const int rc = dec::launch<true>(static_cast<const bf16*>(bins), static_cast<const bf16*>(w_gate),
                                     static_cast<const bf16*>(w_up), static_cast<bf16*>(h), gs, E, cap, D, H, s);
    if (rc) return rc;
    return dec::launch<false>(static_cast<const bf16*>(h), static_cast<const bf16*>(w_down), nullptr,
                              static_cast<bf16*>(y), gs, E, cap, H, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
