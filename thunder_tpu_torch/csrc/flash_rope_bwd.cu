// Flash attention backward, with or without RoPE applied in the kernel, for
// Hopper (sm_90a).
//
// tt_flash_rope_bwd replaces thunder_tpu/executors/pallasex.py:
// flash_rope_attention_backward and the single-pass
// _flash_rope_backward_fused it runs by default (kernel bodies
// _flash_rope_bwd_dq_kernel, _flash_rope_bwd_dkv_kernel(_mha),
// _flash_rope_bwd_fused_kernel). tt_flash_bwd replaces
// pallasex.py:flash_attention_backward and _flash_backward_fused (kernel
// bodies _flash_bwd_dq_kernel, _flash_bwd_dkv_kernel(_mha),
// _flash_bwd_fused_kernel): the same two kernels with RoPE compiled out,
// reading no cos/sin. From pre-RoPE q, k, v, the forward's lse,
// delta = rowsum(do·o) (taken in f32 by the wrapper, outside the kernels,
// as pallasex takes it outside its pallas_call) and do, it recomputes the
// probabilities tile by tile and returns dq, dk, dv with the RoPE VJP
// dxr·cos + rotate_halfᵀ(dxr·sin) applied to dq and dk before the store.
//
// What bounds it: the products. The backward does 2.5× the forward's causal
// flops (recomputed q·kᵀ, do·vᵀ, and three products for dq, dk, dv): at
// llama-350m's shape (B=4, H=16, T=2048, D=64, bf16) 85.9 GFLOP, 86.8 us at
// the bf16 peak, against 137 MB of q, k, v, o, do, dq, dk, dv (41 us).
//
// What the design does about that: tensor-core tiles (mma.sync m16n8k16,
// f32 accumulation) from shared memory, nothing of size T² in device
// memory, and no atomics. Blocks run in any order and share no state, so
// the TPU's single pass (dk/dv carried in VMEM scratch across a sequential
// grid axis) becomes two passes:
//   - dq: one block per (q tile of 128 rows — 64 in f32 —, head, batch)
//     loops over the 64-key k tiles up to the causal limit, recomputing p
//     and ds, and accumulates dq in registers.
//   - dk/dv: one block per (k tile of 128 keys — 64 in f32 —, kv head,
//     batch) loops over the g q-heads of its group and over the q tiles at
//     or past the causal start, in the transposed orientation (rows = keys,
//     as the TPU's _dkv_tile), and accumulates dk and dv in registers: the
//     TPU's group-sum of dk/dv is this inner loop.
// In both, the streamed tile i + 1 is copied with cp.async while tile i is
// computed, and roped in shared memory once it has landed.
// p is rounded to do's dtype for dv and ds to q's dtype for dq and dk, as
// the TPU kernels round them. RoPE is a compile-time switch.
//
// Not done yet: the two passes recompute q·kᵀ and do·vᵀ each, and the dk/dv
// pass ropes every q tile again for every k tile; no wgmma or TMA.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;  // keys per streamed k/v tile of the dq pass

// Warps of a block: 8 (a 128-row q tile in the dq pass, 128 keys in the
// dk/dv pass) for 16-bit types, 4 for f32.
template <typename T> struct Warps { static constexpr int N = sizeof(T) == 4 ? 4 : 8; };

// q rows per inner tile of the dk/dv pass: at D = 128 two 16 x D f32
// accumulators per warp leave room for only 32-column score tiles.
template <int DP> struct DkvRows { static constexpr int N = DP <= 64 ? 64 : 32; };

template <typename T, int DP, bool ROPE>
size_t dq_smem_bytes() {
  constexpr int BQ = 16 * Warps<T>::N, LD = DP + Pad<T>::N, ST = Stages<T>::N;
  // q, do, raw k and v stages, roped k (with RoPE only), ds
  return sizeof(T) * ((2 * BQ + 2 * ST * kBK + (ROPE ? kBK : 0)) * LD + BQ * (kBK + Pad<T>::N));
}

template <typename T, int DP, bool ROPE>
size_t dkv_smem_bytes() {
  constexpr int BK = 16 * Warps<T>::N, BQ = DkvRows<DP>::N, LD = DP + Pad<T>::N;
  constexpr int ST = Stages<T>::N;
  // lse2 and delta; k, v, raw q and do stages, roped q (with RoPE only), p / ds
  return sizeof(float) * 2 * BQ +
         sizeof(T) * ((2 * BK + 2 * ST * BQ + (ROPE ? BQ : 0)) * LD + BK * (BQ + Pad<T>::N));
}

template <typename T, int DP, bool ROPE>
__global__ void __launch_bounds__(32 * Warps<T>::N)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dq, int H, int Hkv, int T_,
                        int D, int causal, float scale, float scale_log2e) {
  constexpr int W = Warps<T>::N, NT = 32 * W, BQ = 16 * W, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = kBK + Pad<T>::N;
  constexpr int NS = kBK / 8;
  constexpr int NO = DP / 8;
  static_assert(sizeof(float) * BQ * (DP + 1) <= sizeof(T) * 2 * ST * kBK * LD,
                "the dq staging reuses the k/v stages");
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * LD;
  T* kraw_s = do_s + BQ * LD;        // ST stages of raw k, then ST stages of v
  T* v_s = kraw_s + ST * kBK * LD;
  T* k_s = v_s + ST * kBK * LD;      // the roped k tile (with RoPE only)
  T* ds_s = k_s + (ROPE ? kBK * LD : 0);
  float* dq_s = reinterpret_cast<float*>(kraw_s);  // BQ x (DP + 1), after the loop

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
  const int q0 = qt * BQ, w0 = q0 + 16 * warp;

  int n_kt = (T_ + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + kBK - 1) / kBK);
  auto fetch = [&](int kt) {
    const int st = kt % ST;
    copy_tile_async<T, DP, kBK, NT>(kraw_s + st * kBK * LD, LD, kb, kt * kBK, T_, D);
    copy_tile_async<T, DP, kBK, NT>(v_s + st * kBK * LD, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  if (ST == 2) fetch(0);
  load_tile<T, DP, BQ, NT, ROPE>(q_s, LD, q + qoff, q0, T_, D, cos, sin);
  load_tile<T, DP, BQ, NT, false>(do_s, LD, dout + qoff, q0, T_, D, nullptr, nullptr);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + acc_row(2 * r);
    lse2[r] = row < T_ ? lse[row0 + row] * 1.4426950408889634f : 0.f;  // natural log -> log2
    dl[r] = row < T_ ? delta[row0 + row] : 0.f;
  }
  const T* qw = q_s + 16 * warp * LD;
  const T* dow = do_s + 16 * warp * LD;
  T* dsw = ds_s + 16 * warp * LP;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const T* kr = kraw_s + (kt % ST) * kBK * LD;
    const T* vs = v_s + (kt % ST) * kBK * LD;
    if (ST == 1) {
      fetch(kt);
      cp_async_wait<0>();
    } else if (kt + 1 < n_kt) {
      fetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ROPE) {
      rope_tile<T, DP, kBK, NT>(k_s, kr, LD, k0, T_, D, cos, sin);
      __syncthreads();
    }
    const T* ks = ROPE ? k_s : kr;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    warp_mma<T, NS, DP, true>(s, qw, LD, ks, LD);   // q·kᵀ
    warp_mma<T, NS, DP, true>(dp, dow, LD, vs, LD);  // do·vᵀ
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_col(j, e), row = w0 + acc_row(e), r = e >> 1;
        const float x = (key >= T_ || (causal && key > row)) ? kNegInf : s[j][e] * scale_log2e;
        s[j][e] = exp2f(x - lse2[r]) * (dp[j][e] - dl[r]) * scale;  // ds
      }
    }
    store_acc<T, NS>(dsw, LP, s);
    __syncwarp();
    warp_mma<T, NO, kBK, false>(acc, dsw, LP, ks, LD);  // dq += ds·k
    __syncthreads();
  }

  float* dqw = dq_s + 16 * warp * (DP + 1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqw[acc_row(e) * (DP + 1) + acc_col(j, e)] = acc[j][e];
  }
  __syncwarp();
  store_rows<T, ROPE>(dq + qoff, dqw, DP + 1, w0, T_, D, cos, sin);
}

template <typename T, int DP, bool ROPE>
__global__ void __launch_bounds__(32 * Warps<T>::N)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ cos,
                         const float* __restrict__ sin, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int Hkv, int T_, int D, int causal, float scale, float scale_log2e) {
  constexpr int W = Warps<T>::N, NT = 32 * W, BK = 16 * W;
  constexpr int BQ = DkvRows<DP>::N, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = BQ + Pad<T>::N;
  constexpr int NS = BQ / 8;
  constexpr int NO = DP / 8;
  static_assert(sizeof(float) * BK * (DP + 1) <= sizeof(T) * 2 * BK * LD,
                "the dk staging reuses the k and v tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse2_s = reinterpret_cast<float*>(smem);  // BQ
  float* dl_s = lse2_s + BQ;                       // BQ
  T* k_s = reinterpret_cast<T*>(dl_s + BQ);
  T* v_s = k_s + BK * LD;
  T* qraw_s = v_s + BK * LD;         // ST stages of raw q, then ST stages of do
  T* do_s = qraw_s + ST * BQ * LD;
  T* q_s = do_s + ST * BQ * LD;      // the roped q tile (with RoPE only)
  T* p_s = q_s + (ROPE ? BQ * LD : 0);
  float* dk_s = reinterpret_cast<float*>(k_s);  // BK x (DP + 1), after the loop

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const size_t koff = (static_cast<size_t>(b) * Hkv + hk) * slab;
  const int k0 = kt * BK, w0 = k0 + 16 * warp;

  // the (q head, q tile) pairs this block visits: for each of the g q-heads
  // of its group, the q tiles at or past the causal start
  const int n_qt = (T_ + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;  // q tiles wholly before this k tile see none of it
  const int per_head = n_qt - i0, n_it = g * per_head;
  auto fetch = [&](int n) {
    const int st = n % ST, h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
    copy_tile_async<T, DP, BQ, NT>(qraw_s + st * BQ * LD, LD, q + qoff, qs, T_, D);
    copy_tile_async<T, DP, BQ, NT>(do_s + st * BQ * LD, LD, dout + qoff, qs, T_, D);
    cp_async_commit();
  };
  if (ST == 2 && n_it > 0) fetch(0);
  load_tile<T, DP, BK, NT, ROPE>(k_s, LD, k + koff, k0, T_, D, cos, sin);
  load_tile<T, DP, BK, NT, false>(v_s, LD, v + koff, k0, T_, D, nullptr, nullptr);
  const T* kw = k_s + 16 * warp * LD;
  const T* vw = v_s + 16 * warp * LD;
  T* pw = p_s + 16 * warp * LP;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int n = 0; n < n_it; ++n) {
    const int h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
    const T* qr = qraw_s + (n % ST) * BQ * LD;
    const T* dos = do_s + (n % ST) * BQ * LD;
    if (ST == 1) {
      fetch(n);
      cp_async_wait<0>();
    } else if (n + 1 < n_it) {
      fetch(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int t = qs + i;
      lse2_s[i] = t < T_ ? lse[row0 + t] * 1.4426950408889634f : 0.f;
      dl_s[i] = t < T_ ? delta[row0 + t] : 0.f;
    }
    __syncthreads();
    if (ROPE) {
      rope_tile<T, DP, BQ, NT>(q_s, qr, LD, qs, T_, D, cos, sin);
      __syncthreads();
    }
    const T* qsm = ROPE ? q_s : qr;

    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
    warp_mma<T, NS, DP, true>(st, kw, LD, qsm, LD);   // k·qᵀ
    warp_mma<T, NS, DP, true>(dpt, vw, LD, dos, LD);  // v·doᵀ
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = acc_col(j, e), t = qs + col, key = w0 + acc_row(e);
        const bool masked = t >= T_ || key >= T_ || (causal && key > t);
        const float p = masked ? 0.f : exp2f(st[j][e] * scale_log2e - lse2_s[col]);
        dpt[j][e] = p * (dpt[j][e] - dl_s[col]) * scale;  // ds
        st[j][e] = p;
      }
    }
    store_acc<T, NS>(pw, LP, st);
    __syncwarp();
    warp_mma<T, NO, BQ, false>(dv_acc, pw, LP, dos, LD);  // dv += pᵀ·do
    __syncwarp();
    store_acc<T, NS>(pw, LP, dpt);
    __syncwarp();
    warp_mma<T, NO, BQ, false>(dk_acc, pw, LP, qsm, LD);  // dk += dsᵀ·q
    __syncthreads();  // every warp is done with this stage, q_s and lse2/delta
  }

  float* dkw = dk_s + 16 * warp * (DP + 1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkw[acc_row(e) * (DP + 1) + acc_col(j, e)] = dk_acc[j][e];
      const int key = w0 + acc_row(e), col = acc_col(j, e);
      if (key < T_ && col < D) dv[koff + static_cast<size_t>(key) * D + col] = tt::from_f32<T>(dv_acc[j][e]);
    }
  }
  __syncwarp();
  store_rows<T, ROPE>(dk + koff, dkw, DP + 1, w0, T_, D, cos, sin);
}

template <typename T, int DP, bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const float* cos, const float* sin, void* dq, void* dk, void* dv,
           int B, int H, int Hkv, int T_, int D, int causal, float scale, float scale_log2e,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr int W = Warps<T>::N, BQ = 16 * W;

  auto dq_kernel = flash_bwd_dq_kernel<T, DP, ROPE>;
  const size_t dq_smem = dq_smem_bytes<T, DP, ROPE>();
  cudaError_t e = allow_smem(dq_kernel, dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((T_ + BQ - 1) / BQ, H, B), 2 * BQ, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, cos, sin, static_cast<T*>(dq), H, Hkv, T_, D, causal, scale,
      scale_log2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkv_kernel = flash_bwd_dkv_kernel<T, DP, ROPE>;
  const size_t dkv_smem = dkv_smem_bytes<T, DP, ROPE>();
  e = allow_smem(dkv_kernel, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((T_ + 16 * W - 1) / (16 * W), Hkv, B), 32 * W, dkv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, cos, sin, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv,
      T_, D, causal, scale, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ROPE>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, const float* cos, const float* sin, void* dq, void* dk,
             void* dv, int B, int H, int Hkv, int T_, int D, int causal, float scale,
             float scale_log2e, cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<T, 32, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T_,
                                 D, causal, scale, scale_log2e, s);
    case 64:
      return launch<T, 64, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T_,
                                 D, causal, scale, scale_log2e, s);
    default:
      return launch<T, 128, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv,
                                  T_, D, causal, scale, scale_log2e, s);
  }
}

template <bool ROPE>
int backward(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, const void* cos, const void* sin, void* dq, void* dk, void* dv,
             int B, int H, int Hkv, int T, int D, int causal, float scale, float scale_log2e,
             int dtype, void* stream) {
  if (D > 128 || D % 2 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  switch (dtype) {
    case tt::kF32:
      return dispatch<float, ROPE>(q, k, v, dout, l, dl, c, sn, dq, dk, dv, B, H, Hkv, T, D,
                                   causal, scale, scale_log2e, s);
    case tt::kBF16:
      return dispatch<__nv_bfloat16, ROPE>(q, k, v, dout, l, dl, c, sn, dq, dk, dv, B, H, Hkv, T,
                                           D, causal, scale, scale_log2e, s);
    case tt::kF16:
      return dispatch<__half, ROPE>(q, k, v, dout, l, dl, c, sn, dq, dk, dv, B, H, Hkv, T, D,
                                    causal, scale, scale_log2e, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All tensors contiguous; q, k, v, do, dq, dk, dv of one dtype; lse and
// delta f32 (B, H, T); cos/sin f32 (T, D); D even, a multiple of the
// 16-byte vector and at most 128; H % Hkv == 0. Launches the dq pass, then
// the dk/dv pass, on `stream`. Returns the first CUDA error.
extern "C" int tt_flash_rope_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* cos,
                                 const void* sin, void* dq, void* dk, void* dv, int B, int H,
                                 int Hkv, int T, int D, int causal, float scale,
                                 float scale_log2e, int dtype, void* stream) {
  return backward<true>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T, D, causal,
                        scale, scale_log2e, dtype, stream);
}

// The same without RoPE: the plain flash-attention backward, no cos/sin.
extern "C" int tt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int H, int Hkv, int T, int D, int causal, float scale,
                            float scale_log2e, int dtype, void* stream) {
  return backward<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dq, dk, dv, B, H, Hkv, T, D,
                         causal, scale, scale_log2e, dtype, stream);
}
