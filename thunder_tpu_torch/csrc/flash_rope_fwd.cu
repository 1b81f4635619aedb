// Flash attention forward in f32, with or without RoPE applied in the
// kernel, for Hopper (sm_90a): the f32 route of tt_flash_rope_fwd and
// tt_flash_fwd (csrc/flash_fwd_sm90.cu, whose bf16/fp16 route is a wgmma/TMA
// core). f32 is the agreement dtype: wgmma would round its operands to tf32.
// This file is specialised to float.
//
// It replaces, for f32, thunder_tpu/executors/pallasex.py:
// flash_rope_attention_forward (kernel body _flash_rope_fwd_kernel) and
// flash_attention_forward (kernel body _flash_fwd_kernel, RoPE compiled out:
// no cos/sin read): q, k, v (B, H | Hkv, T, D) pre-RoPE, cos/sin (T, D) f32
// duplicated-half caches -> o (B, H, T, D) and the natural-log lse (B, H, T).
// kv head = q head // (H / Hkv). Causal or full; the causal mask keeps key
// <= query from position 0 of both (T == Tk).
//
// What bounds it: the products, here by plain f32 FMAs (flash_common.cuh's
// warp_mma for f32: the tensor cores would round f32 to tf32).
//
// The design: one block of 4 warps per (q tile of 64 rows, head, batch); q
// is roped once into shared memory; a loop inside the block walks the
// 64-key k/v tiles up to the causal limit (tiles past the diagonal are
// skipped), each k tile roped in shared memory once it has landed. The
// online-softmax state — base-2, log2(e) folded into the scale, as the TPU
// kernel — stays in registers; the probabilities pass through shared
// memory to the p·v product. Nothing of size T² reaches device memory.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

using T = float;
constexpr int kBK = 64;    // keys per k/v tile
constexpr int kWarps = 4;  // a block: a 64-row q tile

template <int DP, bool ROPE>
size_t fwd_smem_bytes() {
  constexpr int BQ = 16 * kWarps, LD = DP + Pad<T>::N, ST = Stages<T>::N;
  // q, raw k and v stages, roped k (with RoPE only), probabilities
  return sizeof(T) * ((BQ + 2 * ST * kBK + (ROPE ? kBK : 0)) * LD + BQ * (kBK + Pad<T>::N));
}

template <int DP, bool ROPE>
__global__ void __launch_bounds__(32 * kWarps)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cos, const float* __restrict__ sin,
                     T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int T_, int D,
                     int causal, float scale_log2e) {
  constexpr int W = kWarps, NT = 32 * W, BQ = 16 * W, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;   // row stride of the q, k, v tiles
  constexpr int LP = kBK + Pad<T>::N;  // row stride of the probability tile
  constexpr int NS = kBK / 8;          // 8-column slices of a score row block
  constexpr int NO = DP / 8;           // 8-column slices of an output row block
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* kraw_s = q_s + BQ * LD;           // ST stages of raw k
  T* v_s = kraw_s + ST * kBK * LD;     // ST stages of v
  T* k_s = v_s + ST * kBK * LD;        // the roped k tile (with RoPE only)
  T* p_s = k_s + (ROPE ? kBK * LD : 0);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * slab;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const int q0 = qt * BQ, w0 = q0 + 16 * warp;

  int n_kt = (T_ + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + kBK - 1) / kBK);  // tiles past the diagonal: none
  auto fetch = [&](int kt) {  // starts the copy of k/v tile kt into its stage
    const int st = kt % ST;
    copy_tile_async<T, DP, kBK, NT>(kraw_s + st * kBK * LD, LD, kb, kt * kBK, T_, D);
    copy_tile_async<T, DP, kBK, NT>(v_s + st * kBK * LD, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  if (ST == 2) fetch(0);
  load_tile<T, DP, BQ, NT, ROPE>(q_s, LD, qb, q0, T_, D, cos, sin);
  const T* qw = q_s + 16 * warp * LD;
  T* pw = p_s + 16 * warp * LP;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const T* kr = kraw_s + (kt % ST) * kBK * LD;
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
    if (ROPE) {
      rope_tile<T, DP, kBK, NT>(k_s, kr, LD, k0, T_, D, cos, sin);
      __syncthreads();
    }
    const T* ks = ROPE ? k_s : kr;

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
        const float x = (key >= T_ || (causal && key > row)) ? kNegInf : s[j][e] * scale_log2e;
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
    __syncthreads();  // every warp is done with this tile's stage and k_s
  }

  const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + acc_row(2 * r);
    if (row >= T_) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const int col = acc_col(j, e);
        if (col < D) o[(row0 + row) * D + col] = tt::from_f32<T>(acc[j][e] / l_safe);
      }
    }
    if ((threadIdx.x & 3) == 0) lse[row0 + row] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <int DP, bool ROPE>
int launch(const T* q, const T* k, const T* v, const float* cos, const float* sin, T* o,
           float* lse, int B, int H, int Hkv, int T_, int D, int causal, float scale_log2e,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DP, ROPE>;
  const size_t smem = fwd_smem_bytes<DP, ROPE>();
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((T_ + 16 * kWarps - 1) / (16 * kWarps), H, B), 32 * kWarps, smem, stream>>>(
      q, k, v, cos, sin, o, lse, H, Hkv, T_, D, causal, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROPE>
int dispatch(const T* q, const T* k, const T* v, const float* cos, const float* sin, T* o,
             float* lse, int B, int H, int Hkv, int T_, int D, int causal, float scale_log2e,
             cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<32, ROPE>(q, k, v, cos, sin, o, lse, B, H, Hkv, T_, D, causal, scale_log2e, s);
    case 64:
      return launch<64, ROPE>(q, k, v, cos, sin, o, lse, B, H, Hkv, T_, D, causal, scale_log2e, s);
    default:
      return launch<128, ROPE>(q, k, v, cos, sin, o, lse, B, H, Hkv, T_, D, causal, scale_log2e,
                               s);
  }
}

}  // namespace

// The f32 forward (tt_flash_rope_fwd and tt_flash_fwd of flash_fwd_sm90.cu
// call it for f32): all tensors contiguous f32; cos/sin (T, D), or null for
// no RoPE; D even, a multiple of 4 and at most 128; H % Hkv == 0. Returns
// the launch's CUDA error.
extern "C" int tt_flash_fwd_f32(const float* q, const float* k, const float* v, const float* cos,
                                const float* sin, float* o, float* lse, int B, int H, int Hkv,
                                int T, int D, int causal, float scale_log2e, cudaStream_t stream) {
  if (D > 128 || D % 4 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (cos != nullptr)
    return dispatch<true>(q, k, v, cos, sin, o, lse, B, H, Hkv, T, D, causal, scale_log2e, stream);
  return dispatch<false>(q, k, v, nullptr, nullptr, o, lse, B, H, Hkv, T, D, causal, scale_log2e,
                         stream);
}
