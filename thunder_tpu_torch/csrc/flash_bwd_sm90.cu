// Flash attention backward, with or without RoPE, for Hopper (sm_90a): one
// pass over the keys with warpgroup products (wgmma) fed by TMA.
//
// tt_flash_rope_bwd replaces thunder_tpu/executors/pallasex.py:
// flash_rope_attention_backward and the single-pass
// _flash_rope_backward_fused it runs by default; tt_flash_bwd replaces
// pallasex.py:flash_attention_backward and _flash_backward_fused. From
// pre-RoPE q, k, v, the forward's o and lse and the cotangent do they return
// dq, dk, dv, with the RoPE VJP dxr·cos + rotate_halfᵀ(dxr·sin) applied to dq
// and dk in f32 before their last rounding.
//
// What bounds it: the products. The backward does 2.5× the forward's flops
// (q·kᵀ and do·vᵀ recomputed, then dv, dk and dq): at llama-350m's shape
// (B=4, H=16, T=2048, D=64, causal, bf16) 85.9 GFLOP, 86.8 us at the bf16
// peak, against 137 MB of q, k, v, o, do, dq, dk, dv (41 us).
//
// The design, for bf16 and fp16 (f32, the agreement dtype, keeps the
// two-pass kernels of flash_rope_bwd.cu: wgmma would round f32 to tf32):
//   1. Prologue, 8 or 16 threads a row, 16 bytes a thread: delta =
//      rowsum(round(do)·o) in f32, as pallasex takes it outside its
//      pallas_call; lse·log2(e); do rounded to q's dtype when it arrives
//      wider (f32 under autocast); with RoPE, q and k roped once into
//      scratch and rounded, as the TPU kernels round them; the f32
//      accumulators zeroed.
//   2. Core, one block of two warpgroups per (128-key tile, q head, batch),
//      the causal-heaviest key tiles first: 256 blocks at llama-1b's GQA
//      shape, where one block per kv head gave 64. Thread 0 loads the
//      block's K and V tiles once by TMA and keeps two stages of q and do
//      tiles (128 queries at D <= 64, 64 at D = 128), with their lse and
//      delta, in flight, each guarded by an mbarrier. Warpgroup w owns keys
//      64w .. 64w + 63 and computes with wgmma: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//      from shared memory; Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) (masked on
//      diagonal and ragged tiles only) and dSᵀ = Pᵀ∘(dPᵀ − delta)·scale in
//      registers; dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ taken from
//      registers, rounded to the input dtype as the TPU kernels round p and
//      ds. dSᵀ then goes to shared memory, and each warpgroup computes a
//      64 x 64 block of dQ_tile = dS·K over all 128 keys (64 of its rows at
//      D <= 64, 64 of its columns at D = 128), stages it in shared memory
//      and adds it into an f32 dq accumulator with two TMA tensor
//      reduce-adds, which the L2 applies: one thread issues them, where an
//      atomic per element or a bulk copy per row cost the warps their time.
//      dK and dV stay in registers over the whole pass. With GQA (g > 1)
//      the group's q heads run in separate blocks, so dK and dV are added
//      into f32 accumulators at the end; without, they are stored, dK after
//      its RoPE VJP at D = 64 or 128 (a thread holds both halves of its
//      rows), else in f32 for the epilogue's VJP.
//   3. Epilogue, 8 or 16 threads a row: the RoPE VJP on the f32
//      accumulators, rounded to the input dtype.
// So one core serves both entry points, and the five products of a tile
// make one pass; nothing of size T² reaches device memory.
//
// Determinism: dq (and dk, dv with GQA) are sums of f32 reduce-adds whose
// order changes from run to run: two runs on the same inputs may differ in
// the last bit of an f32 sum, so by up to one ulp of the output dtype after
// rounding. The f32 route adds nothing atomically and is bit-reproducible.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

// csrc/flash_rope_bwd.cu: the two-pass f32 kernels.
extern "C" int tt_flash_bwd_f32_two_pass(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         const float* cos, const float* sin, float* dq, float* dk,
                                         float* dv, int B, int H, int Hkv, int T, int D,
                                         int causal, float scale, float scale_log2e,
                                         cudaStream_t stream);

namespace {

using namespace tt::sm90;

constexpr int kBC = 128;       // keys per block: 64 per consumer warpgroup
constexpr int kStages = 2;     // q/do tiles in flight
constexpr int kThreads = 256;  // two warpgroups
constexpr int kRowBytes = 128; // one swizzled row: 64 16-bit elements
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqStage = 2 * 64 * kRowBytes;  // a 64 x 64 f32 block of dq: two 32-column boxes

// Queries a streamed tile holds: 128 at DP = 64 (each warpgroup's Sᵀ is
// 64 keys x 128 queries and each takes 64 of dq's rows), 64 at DP = 128
// (each warpgroup takes 64 of dq's columns), so both warpgroups compute a
// 64 x 64 block of dq a tile and the registers suffice.
template <int DP> constexpr int tile_queries() { return DP == 64 ? 128 : 64; }

// Shared-memory layout of the core for a padded head dim DP (64 or 128),
// offsets in bytes from a 1024-byte-aligned base.
template <int DP> struct Smem {
  static constexpr int BR = tile_queries<DP>();
  static constexpr int kBlocks = DP / 64;                     // 64-wide column blocks
  static constexpr int kKvBytes = kBlocks * kBC * kRowBytes;  // the K (or V) tile
  static constexpr int kQBytes = kBlocks * BR * kRowBytes;    // one stage of q (or do)
  static constexpr int kDsBytes = BR / 64 * kBC * kRowBytes;  // dSᵀ: 128 keys x BR queries
  static constexpr int K = 0;
  static constexpr int V = K + kKvBytes;
  static constexpr int Q = V + kKvBytes;
  static constexpr int DO = Q + kStages * kQBytes;
  static constexpr int DS = DO + kStages * kQBytes;           // two buffers
  static constexpr int DQ = DS + 2 * kDsBytes;                 // dq staging, one a warpgroup
  static constexpr int LSE = DQ + 2 * kDqStage;                // kStages x BR f32
  static constexpr int DELTA = LSE + kStages * BR * 4;
  static constexpr int BAR = DELTA + kStages * BR * 4;         // kv, full[kStages], empty[kStages]
  static constexpr int kBytes = BAR + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// N consecutive elements of T (16-byte aligned) as f32, and back.
template <int N, typename T> __device__ __forceinline__ void load_f32(const T* p, float (&x)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i + j] = tt::to_f32(e[j]);
    }
  }
}
template <int N, typename T> __device__ __forceinline__ void store_f32(T* p, const float (&x)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = tt::from_f32<T>(x[i + j]);
      *reinterpret_cast<uint4*>(p + i) = v;
    }
  }
}
template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack_f32x2(a, b, T{});
  }
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return tt::to_f32(tt::from_f32<T>(x));
}

// The half-split partners x[d ± D/2] of elements d0 .. d0 + N - 1 of a row,
// as f32: one vector load when the chunk lies on one side of D/2.
template <int N, typename T>
__device__ __forceinline__ void load_partners(const T* row, int d0, int h, float (&x)[N]) {
  if (h % N == 0) {
    load_f32<N>(row + (d0 < h ? d0 + h : d0 - h), x);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = tt::to_f32(row[d0 + i < h ? d0 + i + h : d0 + i - h]);
  }
}

// The prologue and the epilogue give each row TPR threads (8 or 16), each a
// 16-byte chunk of T at a time.
template <int TPR> __device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, BH·pitch) are q rows (b·H + h, t): delta (and lse·log2e when lse2
// is given) at [row], the rounded do, the roped q and a zeroed dq
// accumulator where their pointers are given; rows at t >= T only zero their
// delta and lse2. Rows past them are k rows (b·Hkv + hk, t < T): the roped k
// and zeroed dk/dv accumulators where given.
template <typename T, typename TD, int TPR>
__global__ void __launch_bounds__(256)
    flash_bwd_prologue(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                       const TD* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ cos, const float* __restrict__ sin,
                       T* __restrict__ qr, T* __restrict__ kr, T* __restrict__ dor,
                       float* __restrict__ delta, float* __restrict__ lse2,
                       float* __restrict__ dq_acc, float* __restrict__ dk_acc,
                       float* __restrict__ dv_acc, int BH, int BHkv, int T_, int pitch, int D) {
  constexpr int V = tt::Vec<T>::N;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / TPR;
  const int lane = threadIdx.x % TPR, h = D / 2;
  const long long q_rows = static_cast<long long>(BH) * pitch;
  const float zero[V] = {};
  float acc = 0.f;
  int t = 0;
  if (row < q_rows) {
    const int bh = static_cast<int>(row / pitch);
    t = static_cast<int>(row % pitch);
    if (t < T_) {
      const size_t off = (static_cast<size_t>(bh) * T_ + t) * D;
      for (int d0 = lane * V; d0 < D; d0 += TPR * V) {
        float g[V], x[V];
        load_f32<V>(dout + off + d0, g);
        load_f32<V>(o + off + d0, x);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          g[i] = round_to<T>(g[i]);
          acc += g[i] * x[i];
        }
        if (dor != nullptr) store_f32<V>(dor + off + d0, g);
        if (qr != nullptr) {
          float p[V], c[V], sn[V];
          load_f32<V>(q + off + d0, x);
          load_partners<V>(q + off, d0, h, p);
          load_f32<V>(cos + static_cast<size_t>(t) * D + d0, c);
          load_f32<V>(sin + static_cast<size_t>(t) * D + d0, sn);
#pragma unroll
          for (int i = 0; i < V; ++i) x[i] = x[i] * c[i] + (d0 + i < h ? -p[i] : p[i]) * sn[i];
          store_f32<V>(qr + off + d0, x);
        }
        if (dq_acc != nullptr) store_f32<V>(dq_acc + off + d0, zero);
      }
    }
  } else if (row - q_rows < static_cast<long long>(BHkv) * T_) {
    const long long kr_row = row - q_rows;
    t = static_cast<int>(kr_row % T_);
    const size_t off = static_cast<size_t>(kr_row) * D;
    for (int d0 = lane * V; d0 < D; d0 += TPR * V) {
      if (kr != nullptr) {
        float x[V], p[V], c[V], sn[V];
        load_f32<V>(k + off + d0, x);
        load_partners<V>(k + off, d0, h, p);
        load_f32<V>(cos + static_cast<size_t>(t) * D + d0, c);
        load_f32<V>(sin + static_cast<size_t>(t) * D + d0, sn);
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = x[i] * c[i] + (d0 + i < h ? -p[i] : p[i]) * sn[i];
        store_f32<V>(kr + off + d0, x);
      }
      if (dk_acc != nullptr) store_f32<V>(dk_acc + off + d0, zero);
      if (dv_acc != nullptr) store_f32<V>(dv_acc + off + d0, zero);
    }
  }
  acc = row_sum<TPR>(acc);  // every thread of the warp, whatever its row
  if (row < q_rows && lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) lse2[row] = t < T_ ? lse[row / pitch * T_ + t] * kLog2e : 0.f;
  }
}

// q rows (BH·T) take dq from dq_acc, then k rows (BHkv·T) take dk from dk_acc
// and dv from dv_acc where those are given; with ROPE the VJP
// y·cos + rotate_halfᵀ(y·sin) is applied to dq and dk.
template <typename T, bool ROPE, int TPR>
__global__ void __launch_bounds__(256)
    flash_bwd_epilogue(const float* __restrict__ dq_acc, const float* __restrict__ dk_acc,
                       const float* __restrict__ dv_acc, const float* __restrict__ cos,
                       const float* __restrict__ sin, T* __restrict__ dq, T* __restrict__ dk,
                       T* __restrict__ dv, int BH, int BHkv, int T_, int D) {
  constexpr int V = tt::Vec<T>::N;
  long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / TPR;
  const int lane = threadIdx.x % TPR, h = D / 2;
  const float *y = dq_acc, *y2 = nullptr;
  T *out = dq, *out2 = nullptr;
  if (row >= static_cast<long long>(BH) * T_) {
    row -= static_cast<long long>(BH) * T_;
    if (row >= static_cast<long long>(BHkv) * T_) return;
    y = dk_acc, out = dk, y2 = dv_acc, out2 = dv;
  }
  const int t = static_cast<int>(row % T_);
  const size_t off = static_cast<size_t>(row) * D;
  for (int d0 = lane * V; d0 < D; d0 += TPR * V) {
    float x[V];
    if (y != nullptr) {
      load_f32<V>(y + off + d0, x);
      if (ROPE) {
        float p[V], c[V], sp[V];
        load_partners<V>(y + off, d0, h, p);
        load_f32<V>(cos + static_cast<size_t>(t) * D + d0, c);
        load_partners<V>(sin + static_cast<size_t>(t) * D, d0, h, sp);
#pragma unroll
        for (int i = 0; i < V; ++i) x[i] = x[i] * c[i] + (d0 + i < h ? p[i] : -p[i]) * sp[i];
      }
      store_f32<V>(out + off + d0, x);
    }
    if (y2 != nullptr) {
      load_f32<V>(y2 + off + d0, x);
      store_f32<V>(out2 + off + d0, x);
    }
  }
}

// Adds (a, b) to p[0], p[1] (8-byte aligned) in one vector atomic.
__device__ __forceinline__ void add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_core(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse2,
                   const float* __restrict__ delta, const float* __restrict__ cos,
                   const float* __restrict__ sin, T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dk_acc, float* __restrict__ dv_acc, int H, int Hkv, int T_,
                   int pitch, int D, int causal, float scale, float scale_log2e) {
  using S = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int g = H / Hkv, hk = h / g;
  const int bh = b * H + h, bhk = b * Hkv + hk;
  const int k0 = kt * kBC;
  constexpr int BR = S::BR;
  const int i0 = causal ? k0 / BR : 0;  // q tiles wholly before this key tile see none of it
  const int n_it = (T_ + BR - 1) / BR - i0;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  // thread 0 issues every copy: q, do, lse2 and delta of tile n into stage n % kStages
  auto issue = [&](int n) {
    const int s = n % kStages, q0 = (i0 + n) * BR;
    mbar_expect_tx(&full[s], 2 * S::kQBytes + 2 * BR * 4);
    for (int a = 0; a < S::kBlocks; ++a) {
      tma_load_3d(smem + S::Q + s * S::kQBytes + a * BR * kRowBytes, &tm_q, &full[s], 64 * a, q0, bh);
      tma_load_3d(smem + S::DO + s * S::kQBytes + a * BR * kRowBytes, &tm_do, &full[s], 64 * a, q0, bh);
    }
    const size_t r0 = static_cast<size_t>(bh) * pitch + q0;
    bulk_load(smem + S::LSE + s * BR * 4, lse2 + r0, BR * 4, &full[s]);
    bulk_load(smem + S::DELTA + s * BR * 4, delta + r0, BR * 4, &full[s]);
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    fence_barrier_init();
    mbar_expect_tx(kv_full, 2 * S::kKvBytes);
    for (int a = 0; a < S::kBlocks; ++a) {
      tma_load_3d(smem + S::K + a * kBC * kRowBytes, &tm_k, kv_full, 64 * a, k0, bhk);
      tma_load_3d(smem + S::V + a * kBC * kRowBytes, &tm_v, kv_full, 64 * a, k0, bhk);
    }
    for (int n = 0; n < kStages && n < n_it; ++n) issue(n);
  }
  __syncthreads();

  // warpgroup wg owns keys k0 + 64·wg .. + 63, and the 64 x 64 block of dq
  // at rows qr0 .., columns 64·cb ..
  constexpr int NO = DP / 2;   // accumulator registers of a 64 x DP tile
  constexpr int NS = BR / 2;   // ... of a 64 x BR tile
  constexpr int NK = BR / 16;  // 16-query slices of a tile
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, c = lane & 3;
  const int qr0 = BR == 128 ? 64 * wg : 0, cb = DP == 128 ? wg : 0;
  const uint32_t sK = smem_u32(smem + S::K), sV = smem_u32(smem + S::V);
  const uint32_t sQ = smem_u32(smem + S::Q), sDO = smem_u32(smem + S::DO);
  const uint32_t sDS = smem_u32(smem + S::DS);
  const int key0 = k0 + 64 * wg + 16 * warp + gq;  // this thread's first key row
  unsigned char* dq_stage = smem + S::DQ + wg * kDqStage;
  const bool dq_issuer = tid == 0;
  float dk_r[NO], dv_r[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_r[i] = dv_r[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int n = 0; n < n_it; ++n) {
    const int s = n % kStages, q0 = (i0 + n) * BR;
    mbar_wait(&full[s], (n / kStages) & 1);
    const uint32_t q_s = sQ + s * S::kQBytes, do_s = sDO + s * S::kQBytes;

    // Sᵀ = K_wg·Qᵀ and dPᵀ = V_wg·dOᵀ (64 keys x BR queries), both operands K-major
    float st[NS], dpt[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kBC * kRowBytes + 64 * wg * kRowBytes + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * BR * kRowBytes + (kk % 4) * 32;
      wgmma_ss<0, 0>(st, desc_sw128(sK + ko, 16, 1024), desc_sw128(q_s + qo, 16, 1024), kk, T{});
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t ko = (kk / 4) * kBC * kRowBytes + 64 * wg * kRowBytes + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * BR * kRowBytes + (kk % 4) * 32;
      wgmma_ss<0, 0>(dpt, desc_sw128(sV + ko, 16, 1024), desc_sw128(do_s + qo, 16, 1024), kk, T{});
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ and dSᵀ; accumulator element i sits at key row key0 + 8·((i>>1)&1),
    // query column 8·(i>>2) + 2c + (i&1)
    const float* l2 = reinterpret_cast<const float*>(smem + S::LSE) + s * BR;
    const float* dl = reinterpret_cast<const float*>(smem + S::DELTA) + s * BR;
    const bool need_mask = q0 + BR > T_ || k0 + kBC > T_ || (causal && k0 + kBC - 1 > q0);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const int col = 8 * j + 2 * c;
      const float2 L = *reinterpret_cast<const float2*>(l2 + col);
      const float2 Dl = *reinterpret_cast<const float2*>(dl + col);
      const float dsx = Dl.x * scale, dsy = Dl.y * scale;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, qi = q0 + col + (e & 1), key = key0 + 8 * (e >> 1);
        float p = fast_exp2(st[i] * scale_log2e - ((e & 1) ? L.y : L.x));
        if (need_mask && (qi >= T_ || key >= T_ || (causal && key > qi))) p = 0.f;
        dpt[i] = p * fmaf(dpt[i], scale, -((e & 1) ? dsy : dsx));  // p·(dp − delta)·scale
        st[i] = p;
      }
    }
    uint32_t pa[NK][4], da[NK][4];  // A fragments of the 16-query slices kk
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_f32x2(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1], T{});
        da[kk][r] = pack_f32x2(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1], T{});
      }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q (B MN-major: 16 query rows a slice)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_rs<1>(dv_r, pa[kk], desc_sw128(do_s + kk * 16 * kRowBytes, BR * kRowBytes, 1024), T{});
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_rs<1>(dk_r, da[kk], desc_sw128(q_s + kk * 16 * kRowBytes, BR * kRowBytes, 1024), T{});
    wgmma_commit();

    // dSᵀ into this iteration's buffer, in 64-query column blocks swizzled as
    // TMA would store them
    unsigned char* ds_buf = smem + S::DS + (n & 1) * S::kDsBytes;
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * wg + 16 * warp + gq + 8 * r;
        *reinterpret_cast<uint32_t*>(ds_buf + (j / 8) * kBC * kRowBytes + row * kRowBytes +
                                     (((j % 8) ^ (row & 7)) << 4) + 4 * c) =
            da[j >> 1][((j & 1) << 1) | r];
      }
    }
    fence_proxy_async();
    named_bar_sync(1, kThreads);

    // dQ[qr0 .., 64·cb ..] = dS·K over all 128 keys (A = dSᵀ and B = K both
    // MN-major, 16 keys a slice)
    float dq_r[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk)
      wgmma_ss<1, 1>(dq_r,
                     desc_sw128(sDS + (n & 1) * S::kDsBytes + (qr0 / 64) * kBC * kRowBytes +
                                    kk * 16 * kRowBytes, kBC * kRowBytes, 1024),
                     desc_sw128(sK + cb * kBC * kRowBytes + kk * 16 * kRowBytes, kBC * kRowBytes, 1024),
                     kk, T{});
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_r);
    fence_regs(dk_r);
    fence_regs(dq_r);
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && n + kStages < n_it) {
      mbar_wait(&empty[s], (n / kStages) & 1);  // both warpgroups are done with stage s
      issue(n + kStages);
    }

    // dq's block through this warpgroup's staging into dq_acc: two
    // 32-column boxes, swizzled as TMA reads them, added in the L2 by one
    // tensor reduce-add each
    if (dq_issuer) bulk_wait_read<0>();  // the previous block's reduces have read the staging
    named_bar_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + gq + 8 * r, chunk = (2 * j + (c >> 1)) & 7;
        *reinterpret_cast<float2*>(dq_stage + (j >> 2) * 64 * kRowBytes + row * kRowBytes +
                                   ((chunk ^ (row & 7)) << 4) + 8 * (c & 1)) =
            make_float2(dq_r[4 * j + 2 * r], dq_r[4 * j + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (dq_issuer) {
      tma_reduce_add_3d(&tm_dq, dq_stage, 64 * cb, q0 + qr0, bh);
      tma_reduce_add_3d(&tm_dq, dq_stage + 64 * kRowBytes, 64 * cb + 32, q0 + qr0, bh);
      bulk_commit();
    }
  }
  if (dq_issuer) bulk_wait<0>();  // the staging stays until the last reduces have read it

  // dK and dV of this warpgroup's 64 keys. With cos given (RoPE, no GQA, D =
  // DP), dk's VJP is taken here: the thread holds both halves of its rows.
  const size_t kv_off = static_cast<size_t>(bhk) * T_ * D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = key0 + 8 * r, col = 8 * j + 2 * c;
      if (t >= T_ || col >= D) continue;
      const size_t at = kv_off + static_cast<size_t>(t) * D + col;
      float k_a = dk_r[4 * j + 2 * r], k_b = dk_r[4 * j + 2 * r + 1];
      const float v_a = dv_r[4 * j + 2 * r], v_b = dv_r[4 * j + 2 * r + 1];
      if (cos != nullptr) {
        constexpr int JH = DP / 16;  // the partner slice, DP/2 columns away
        const int jp = j < JH ? j + JH : j - JH, pcol = 8 * jp + 2 * c;
        const float p_a = dk_r[4 * jp + 2 * r], p_b = dk_r[4 * jp + 2 * r + 1];
        const float2 cs = *reinterpret_cast<const float2*>(cos + static_cast<size_t>(t) * D + col);
        const float2 sp = *reinterpret_cast<const float2*>(sin + static_cast<size_t>(t) * D + pcol);
        const float sign = j < JH ? 1.f : -1.f;
        k_a = k_a * cs.x + sign * p_a * sp.x;
        k_b = k_b * cs.y + sign * p_b * sp.y;
      }
      if (dk_acc == nullptr) {
        store_pair(dk + at, k_a, k_b);
      } else if (g > 1) {
        add2(dk_acc + at, k_a, k_b);
      } else {
        store_pair(dk_acc + at, k_a, k_b);
      }
      if (dv_acc == nullptr) {
        store_pair(dv + at, v_a, v_b);
      } else {
        add2(dv_acc + at, v_a, v_b);
      }
    }
  }
}

// Blocks of 256 threads for `rows` rows of TPR threads.
int rows_grid(long long rows, int tpr) {
  return static_cast<int>((rows * tpr + 255) / 256);
}
// Threads a row of the prologue and the epilogue: 8 when 8 chunks of 16
// bytes hold the row, else 16.
template <typename T> int threads_per_row(int D) { return D <= 8 * tt::Vec<T>::N ? 8 : 16; }

// One backward call's tensors. Scratch the route does not use is null: the
// roped q/k (qr, kr) with RoPE only, the rounded do (dor) when do arrives
// wider, dk_acc with RoPE or GQA, dv_acc with GQA. pitch: the row pitch of
// delta and lse2, from the caller's plan.
struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *cos, *sin;
  void *dq, *dk, *dv;
  float *delta, *lse2, *dq_acc, *dk_acc, *dv_acc;
  void *qr, *kr, *dor;
  int B, H, Hkv, T, D, pitch, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TD>
int prologue(const Args& a) {
  const bool gqa = a.H != a.Hkv;
  const long long rows = static_cast<long long>(a.B) * a.H * a.pitch +
                         (a.kr != nullptr || (gqa && a.dk_acc != nullptr)
                              ? static_cast<long long>(a.B) * a.Hkv * a.T
                              : 0);
  const int tpr = threads_per_row<T>(a.D);
  auto kernel = tpr == 8 ? flash_bwd_prologue<T, TD, 8> : flash_bwd_prologue<T, TD, 16>;
  kernel<<<rows_grid(rows, tpr), 256, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.o),
      static_cast<const TD*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.cos), static_cast<const float*>(a.sin), static_cast<T*>(a.qr),
      static_cast<T*>(a.kr), static_cast<T*>(a.dor), a.delta, a.lse2, a.dq_acc,
      gqa ? a.dk_acc : nullptr, gqa ? a.dv_acc : nullptr, a.B * a.H, a.B * a.Hkv, a.T, a.pitch,
      a.D);
  return static_cast<int>(cudaGetLastError());
}

// dk's RoPE VJP is taken in the core when the caller gives no dk_acc with
// RoPE: without GQA and at D = 64 or 128, a thread holds both halves of its
// rows of dk (backward refuses it elsewhere).
bool vjp_in_core(const Args& a) { return a.cos != nullptr && a.dk_acc == nullptr; }

template <typename T, int DP>
int core(const Args& a) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv, mdo, mdq;
  constexpr int BR = tile_queries<DP>();
  int e = make_map_3d(&mq, a.qr != nullptr ? a.qr : a.q, type, a.D, a.T, a.B * a.H, BR);
  if (!e) e = make_map_3d(&mk, a.kr != nullptr ? a.kr : a.k, type, a.D, a.T, a.B * a.Hkv, kBC);
  if (!e) e = make_map_3d(&mv, a.v, type, a.D, a.T, a.B * a.Hkv, kBC);
  if (!e) e = make_map_3d(&mdo, a.dor != nullptr ? a.dor : a.dout, type, a.D, a.T, a.B * a.H, BR);
  if (!e) e = make_map_3d(&mdq, a.dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.D, a.T, a.B * a.H, 64);
  if (e) return e;
  auto kernel = flash_bwd_core<T, DP>;
  const cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              Smem<DP>::kBytes);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const bool vjp = vjp_in_core(a);
  kernel<<<dim3(a.H, a.B, (a.T + kBC - 1) / kBC), kThreads, Smem<DP>::kBytes, a.stream>>>(
      mq, mk, mv, mdo, mdq, a.lse2, a.delta, vjp ? static_cast<const float*>(a.cos) : nullptr,
      vjp ? static_cast<const float*>(a.sin) : nullptr, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.dk_acc, a.dv_acc, a.H, a.Hkv, a.T, a.pitch, a.D, a.causal, a.scale,
      a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int epilogue(const Args& a, bool rope) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.T +
                         (a.dk_acc != nullptr ? static_cast<long long>(a.B) * a.Hkv * a.T : 0);
  const int tpr = threads_per_row<T>(a.D);
  auto kernel = rope ? (tpr == 8 ? flash_bwd_epilogue<T, true, 8> : flash_bwd_epilogue<T, true, 16>)
                     : (tpr == 8 ? flash_bwd_epilogue<T, false, 8> : flash_bwd_epilogue<T, false, 16>);
  kernel<<<rows_grid(rows, tpr), 256, 0, a.stream>>>(
      a.dq_acc, a.dk_acc, a.dv_acc, static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B * a.H, a.B * a.Hkv, a.T, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_16bit(const Args& a, int do_dtype, bool rope) {
  int e = do_dtype == tt::kF32 ? prologue<T, float>(a) : prologue<T, T>(a);
  if (!e) e = a.D <= 64 ? core<T, 64>(a) : core<T, 128>(a);
  if (!e) e = epilogue<T>(a, rope);
  return e;
}

int backward(const Args& a, int dtype, int do_dtype, bool rope) {
  const int vec = dtype == tt::kF32 ? 4 : 8;
  if (a.D > 128 || a.D % 2 || a.D % vec || a.H % a.Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (do_dtype != dtype && do_dtype != tt::kF32) return static_cast<int>(cudaErrorInvalidValue);
  const bool gqa = a.H != a.Hkv;
  // The caller's plan decides the scratch; what the kernels would read past
  // or cannot do is refused: the core reads delta and lse2 a whole tile of
  // queries at a time, and takes dk's VJP only without GQA at D = 64 or 128.
  const int br = a.D <= 64 ? tile_queries<64>() : tile_queries<128>();
  if (dtype == tt::kF32 ? a.pitch != a.T
                        : (a.pitch < a.T || a.pitch % br ||
                           (gqa && (a.dk_acc == nullptr || a.dv_acc == nullptr)) ||
                           (vjp_in_core(a) && (gqa || (a.D != 64 && a.D != 128)))))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case tt::kF32: {
      const int e = prologue<float, float>(a);
      if (e) return e;
      return tt_flash_bwd_f32_two_pass(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          static_cast<const float*>(a.lse), a.delta, static_cast<const float*>(a.cos),
          static_cast<const float*>(a.sin), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.B, a.H, a.Hkv, a.T, a.D, a.causal, a.scale,
          a.scale * kLog2e, a.stream);
    }
    case tt::kBF16:
      return run_16bit<__nv_bfloat16>(a, do_dtype, rope);
    case tt::kF16:
      return run_16bit<__half>(a, do_dtype, rope);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All tensors contiguous: q, dq (B, H, T, D), k, v, dk, dv (B, Hkv, T, D) and
// o of one dtype; do of that dtype or f32; lse f32 (B, H, T); cos/sin f32
// (T, D); D even, a multiple of the 16-byte vector and at most 128;
// H % Hkv == 0. Scratch, allocated by the caller (executors/cudaex.py:
// flash_backward_plan): delta f32 (B, H, pitch) where pitch is T for f32
// and, for bf16/fp16, at least T and a whole number of the core's query
// tiles (tile_queries; refused otherwise). For bf16/fp16 also lse2 f32
// (B, H, pitch), dq_acc f32 (B, H, T, D), dk_acc f32 (B, Hkv, T, D) with
// GQA, or with RoPE at a D other than 64 and 128 (where it is null with
// RoPE, the core takes dk's VJP), dv_acc f32 (B, Hkv, T, D) with GQA, qr
// and kr (q's and k's shapes) with RoPE, dor (do's shape, q's dtype) when
// do is f32; null otherwise. Launches
// the prologue, the core and the epilogue (f32: the prologue and the
// two-pass kernels) on `stream`. Returns the first CUDA error.
extern "C" int tt_flash_rope_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* cos,
                                 const void* sin, void* dq, void* dk, void* dv, void* delta,
                                 void* lse2, void* dq_acc, void* dk_acc, void* dv_acc, void* qr,
                                 void* kr, void* dor, int B, int H, int Hkv, int T, int D,
                                 int pitch, int causal, float scale, int dtype, int do_dtype,
                                 void* stream) {
  const Args a{q, k, v, o, dout, lse, cos, sin, dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(lse2), static_cast<float*>(dq_acc),
               static_cast<float*>(dk_acc), static_cast<float*>(dv_acc), qr, kr, dor,
               B, H, Hkv, T, D, pitch, causal, scale, static_cast<cudaStream_t>(stream)};
  return backward(a, dtype, do_dtype, true);
}

// The same without RoPE: no cos/sin, no roped scratch.
extern "C" int tt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dq, void* dk, void* dv,
                            void* delta, void* lse2, void* dq_acc, void* dk_acc, void* dv_acc,
                            void* dor, int B, int H, int Hkv, int T, int D, int pitch,
                            int causal, float scale, int dtype, int do_dtype, void* stream) {
  const Args a{q, k, v, o, dout, lse, nullptr, nullptr, dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(lse2), static_cast<float*>(dq_acc),
               static_cast<float*>(dk_acc), static_cast<float*>(dv_acc), nullptr, nullptr, dor,
               B, H, Hkv, T, D, pitch, causal, scale, static_cast<cudaStream_t>(stream)};
  return backward(a, dtype, do_dtype, false);
}
