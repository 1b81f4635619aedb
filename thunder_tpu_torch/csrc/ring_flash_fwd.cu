// One forward step of ring attention (context parallelism) in f32 for
// Hopper (sm_90a): tt_ring_flash_fwd_f32, the f32 route of
// tt_ring_flash_fwd (csrc/flash_fwd_sm90.cu), which replaces
// thunder_tpu/executors/pallasex.py:ring_flash_step (kernel body
// _ring_flash_step_kernel). bf16 and fp16 run the flash forward's wgmma/TMA
// core in ring mode there; f32, the agreement dtype, keeps this mma.sync/FMA
// kernel (wgmma would round f32 to tf32), so f32 rings stay
// bit-reproducible.
//
// The local queries q (B, H, T, D) fold one arriving K/V shard kb/vb (B,
// Hkv, T, D) into the carried f32 accumulators o (B, H, T, D), m and l (B,
// H, T) with the online softmax. m and l are in log2 units (scores scaled
// by scale·log2 e), o is unnormalized. The causal mask compares global
// positions: query q_off + i sees key k_off + j when k_off + j <= q_off +
// i. kv head = q head // (H / Hkv). The accumulators are updated IN PLACE:
// each block reads its rows of o, m, l and writes them back.
//
// The sentinel and the step order belong together, as in the TPU kernel:
// masked scores are the finite -1e30, so a fully masked tile against a
// still-sentinel running max would add exp2(0) = 1 per key. The ring
// folds the diagonal shard (k_off == q_off) first; its first tile gives
// every row a finite max before any fully masked tile comes.
//
// The design: flash_rope_fwd.cu's tile loop (RoPE compiled out) with the
// carried state. One block per (q tile of 64 rows, head, batch) loads its
// rows of o, m, l into the registers of the m16n8k16 accumulator layout,
// walks the 64-key k/v tiles of the shard up to the global causal limit
// (cp.async, FMA products) and stores o, m, l back. A block whose rows all
// precede the shard (a shard wholly in the future) returns before touching
// memory, so the accumulators stay bit-unchanged. q_off and k_off are
// kernel arguments: no host sync, so the launches can be captured in a
// CUDA graph.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;  // keys per k/v tile

// Warps of a block: 4 (a 64-row q tile) in f32.
template <typename T> struct FwdWarps { static constexpr int N = sizeof(T) == 4 ? 4 : 8; };

template <typename T, int DP>
size_t smem_bytes() {
  constexpr int BQ = 16 * FwdWarps<T>::N, LD = DP + Pad<T>::N, ST = Stages<T>::N;
  // q, k and v stages, probabilities
  return sizeof(T) * ((BQ + 2 * ST * kBK) * LD + BQ * (kBK + Pad<T>::N));
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * FwdWarps<T>::N)
    ring_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ o, float* __restrict__ m_io,
                          float* __restrict__ l_io, int H, int Hkv, int T_, int D, int q_off,
                          int k_off, int causal, float scale_log2e) {
  constexpr int W = FwdWarps<T>::N, NT = 32 * W, BQ = 16 * W, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = kBK + Pad<T>::N;
  constexpr int NS = kBK / 8;
  constexpr int NO = DP / 8;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  int n_kt = (T_ + kBK - 1) / kBK;
  if (causal) {
    // keys j of the shard with k_off + j <= q_off + (last row of the tile)
    const int lim = q_off - k_off + q0 + BQ;
    n_kt = lim <= 0 ? 0 : min(n_kt, (lim + kBK - 1) / kBK);
  }
  if (n_kt == 0) return;  // the shard is wholly in this tile's future

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * LD;        // ST stages of k
  T* v_s = k_s + ST * kBK * LD;  // ST stages of v
  T* p_s = v_s + ST * kBK * LD;

  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * slab;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
  const int w0 = q0 + 16 * warp;

  auto fetch = [&](int kt) {
    const int st = kt % ST;
    copy_tile_async<T, DP, kBK, NT>(k_s + st * kBK * LD, LD, kb, kt * kBK, T_, D);
    copy_tile_async<T, DP, kBK, NT>(v_s + st * kBK * LD, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  if (ST == 2) fetch(0);
  load_tile<T, DP, BQ, NT, false>(q_s, LD, qb, q0, T_, D, nullptr, nullptr);
  const T* qw = q_s + 16 * warp * LD;
  T* pw = p_s + 16 * warp * LP;

  // the carried state of this thread's rows (g and g + 8 of its warp)
  float acc[NO][4], m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + acc_row(2 * r);
    m[r] = row < T_ ? m_io[row0 + row] : kNegInf;
    l[r] = row < T_ ? l_io[row0 + row] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = w0 + acc_row(e), col = acc_col(j, e);
      acc[j][e] = (row < T_ && col < D) ? o[(row0 + row) * D + col] : 0.f;
    }
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const T* ks = k_s + (kt % ST) * kBK * LD;
    const T* vs = v_s + (kt % ST) * kBK * LD;
    if (ST == 1) {
      fetch(kt);
      cp_async_wait<0>();
    } else if (kt + 1 < n_kt) {
      fetch(kt + 1);  // overlaps this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_mma<T, NS, DP, true>(s, qw, LD, ks, LD);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_col(j, e), row = w0 + acc_row(e);
        const bool masked = key >= T_ || (causal && k_off + key > q_off + row);
        const float x = masked ? kNegInf : s[j][e] * scale_log2e;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
    store_acc<T, NS>(pw, LP, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    __syncwarp();  // this warp's probabilities are written
    warp_mma<T, NO, kBK, false>(acc, pw, LP, vs, LD);
    __syncthreads();  // every warp is done with this tile's stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + acc_row(2 * r);
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const int col = acc_col(j, e);
        if (col < D) o[(row0 + row) * D + col] = acc[j][e];
      }
    }
    if ((threadIdx.x & 3) == 0) {
      m_io[row0 + row] = m[r];
      l_io[row0 + row] = l[r];
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, float* o, float* m, float* l, int B,
           int H, int Hkv, int T_, int D, int q_off, int k_off, int causal, float scale_log2e,
           cudaStream_t stream) {
  constexpr int W = FwdWarps<T>::N;
  auto kernel = ring_flash_fwd_kernel<T, DP>;
  const size_t smem = smem_bytes<T, DP>();
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((T_ + 16 * W - 1) / (16 * W), H, B), 32 * W, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, m, l, H,
      Hkv, T_, D, q_off, k_off, causal, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous f32; o (B, H, T, D), m and l (B, H, T), updated in
// place; D even, a multiple of 4 and at most 128; H % Hkv == 0; k and v
// hold T rows, as q. Returns the launch's CUDA error.
extern "C" int tt_ring_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                     float* m, float* l, int B, int H, int Hkv, int T, int D,
                                     int q_off, int k_off, int causal, float scale_log2e,
                                     cudaStream_t s) {
  if (D > 128 || D % 4 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  switch (padded_head_dim(D)) {
    case 32:
      return launch<float, 32>(q, k, v, o, m, l, B, H, Hkv, T, D, q_off, k_off, causal,
                               scale_log2e, s);
    case 64:
      return launch<float, 64>(q, k, v, o, m, l, B, H, Hkv, T, D, q_off, k_off, causal,
                               scale_log2e, s);
    default:
      return launch<float, 128>(q, k, v, o, m, l, B, H, Hkv, T, D, q_off, k_off, causal,
                                scale_log2e, s);
  }
}
