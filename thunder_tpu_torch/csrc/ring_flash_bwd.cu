// One backward step of ring attention (context parallelism) for Hopper
// (sm_90a).
//
// tt_ring_flash_bwd replaces thunder_tpu/executors/pallasex.py:
// ring_flash_bwd_step (kernel bodies _ring_flash_bwd_dq_kernel and
// _ring_flash_bwd_dkv_kernel): for the local queries q, their cotangent do
// (B, H, T, D), the global natural-log lse and delta = rowsum(do·o) (B, H,
// T) f32 (the ring loop takes delta in f32 outside the kernels, as
// pallasex does) and one arriving K/V shard kb/vb (B, Hkv, T, D), it writes
// this shard's f32 contributions dq (B, H, T, D), dk and dv (B, Hkv, T, D).
// p is recomputed from the global lse, so the contributions of the ring's
// steps simply add; ds = p·(dp − delta)·scale. The causal mask and the
// skips use global positions (q_off + i, k_off + j), as the forward step.
// The GQA group sum of dk/dv is taken inside the block, so the kernel
// writes (B, Hkv, T, D) where thunder_tpu writes per-q-head partials and
// sums them outside: the same function without 2 × (B, H, T, D) f32 of
// partials.
//
// What bounds it: the products, 2.5× the forward step's (recomputed q·kᵀ
// and do·vᵀ, and dq, dk, dv): 0.347 ms at the cp_train shape (B=1, H=16,
// T=8192, D=64, bf16, the diagonal step) at 989 TFLOP/s.
//
// What the design does about that: flash_rope_bwd.cu's two passes (RoPE
// compiled out) with global offsets and f32 outputs, tensor-core tiles
// (mma.sync m16n8k16, f32 accumulation) from cp.async double-buffered
// shared memory, no atomics:
//   - dq: one block per (q tile of 128 rows — 64 in f32 —, head, batch)
//     loops over the 64-key tiles of the shard up to the global causal
//     limit and writes its rows of dq (zeros when the shard is wholly in
//     its future).
//   - dk/dv: one block per (k tile of 128 keys — 64 in f32 —, kv head,
//     batch) loops over the g q-heads of its group and over the q tiles
//     that can see its keys, in the transposed orientation (rows = keys),
//     and writes its rows of dk and dv.
// p is rounded to do's dtype for dv and ds to q's dtype for dq and dk, as
// the TPU kernels round them. One C entry launches both passes. q_off and
// k_off are kernel arguments: no host sync.
//
// Not done yet: the two passes recompute q·kᵀ and do·vᵀ each; the ring loop
// adds the contributions to its accumulators in separate passes; no wgmma.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;  // keys per streamed k/v tile of the dq pass

template <typename T> struct Warps { static constexpr int N = sizeof(T) == 4 ? 4 : 8; };

// q rows per inner tile of the dk/dv pass (two 16 x D f32 accumulators per
// warp at D = 128 leave room for only 32-column score tiles)
template <int DP> struct DkvRows { static constexpr int N = DP <= 64 ? 64 : 32; };

template <typename T, int DP>
size_t dq_smem_bytes() {
  constexpr int BQ = 16 * Warps<T>::N, LD = DP + Pad<T>::N, ST = Stages<T>::N;
  // q, do, k and v stages, ds
  return sizeof(T) * ((2 * BQ + 2 * ST * kBK) * LD + BQ * (kBK + Pad<T>::N));
}

template <typename T, int DP>
size_t dkv_smem_bytes() {
  constexpr int BK = 16 * Warps<T>::N, BQ = DkvRows<DP>::N, LD = DP + Pad<T>::N;
  constexpr int ST = Stages<T>::N;
  // lse2 and delta; k, v, q and do stages, p / ds
  return sizeof(float) * 2 * BQ + sizeof(T) * ((2 * BK + 2 * ST * BQ) * LD + BK * (BQ + Pad<T>::N));
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * Warps<T>::N)
    ring_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq, int H, int Hkv,
                       int T_, int D, int q_off, int k_off, int causal, float scale,
                       float scale_log2e) {
  constexpr int W = Warps<T>::N, NT = 32 * W, BQ = 16 * W, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = kBK + Pad<T>::N;
  constexpr int NS = kBK / 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * LD;
  T* k_s = do_s + BQ * LD;       // ST stages of k
  T* v_s = k_s + ST * kBK * LD;  // ST stages of v
  T* ds_s = v_s + ST * kBK * LD;

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
  if (causal) {
    const int lim = q_off - k_off + q0 + BQ;
    n_kt = lim <= 0 ? 0 : min(n_kt, (lim + kBK - 1) / kBK);
  }
  auto fetch = [&](int kt) {
    const int st = kt % ST;
    copy_tile_async<T, DP, kBK, NT>(k_s + st * kBK * LD, LD, kb, kt * kBK, T_, D);
    copy_tile_async<T, DP, kBK, NT>(v_s + st * kBK * LD, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n_kt > 0) {
    if (ST == 2) fetch(0);
    load_tile<T, DP, BQ, NT, false>(q_s, LD, q + qoff, q0, T_, D, nullptr, nullptr);
    load_tile<T, DP, BQ, NT, false>(do_s, LD, dout + qoff, q0, T_, D, nullptr, nullptr);
  }
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

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const T* ks = k_s + (kt % ST) * kBK * LD;
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
        const bool masked = key >= T_ || (causal && k_off + key > q_off + row);
        const float x = masked ? kNegInf : s[j][e] * scale_log2e;
        s[j][e] = exp2f(x - lse2[r]) * (dp[j][e] - dl[r]) * scale;  // ds
      }
    }
    store_acc<T, NS>(dsw, LP, s);
    __syncwarp();
    warp_mma<T, NO, kBK, false>(acc, dsw, LP, ks, LD);  // dq += ds·k
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = w0 + acc_row(e), col = acc_col(j, e);
      if (row < T_ && col < D) dq[(row0 + row) * D + col] = acc[j][e];
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * Warps<T>::N)
    ring_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, int H, int Hkv, int T_, int D, int q_off,
                        int k_off, int causal, float scale, float scale_log2e) {
  constexpr int W = Warps<T>::N, NT = 32 * W, BK = 16 * W;
  constexpr int BQ = DkvRows<DP>::N, ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = BQ + Pad<T>::N;
  constexpr int NS = BQ / 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse2_s = reinterpret_cast<float*>(smem);  // BQ
  float* dl_s = lse2_s + BQ;                       // BQ
  T* k_s = reinterpret_cast<T*>(dl_s + BQ);
  T* v_s = k_s + BK * LD;
  T* q_s = v_s + BK * LD;          // ST stages of q, then ST stages of do
  T* do_s = q_s + ST * BQ * LD;
  T* p_s = do_s + ST * BQ * LD;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const size_t koff = (static_cast<size_t>(b) * Hkv + hk) * slab;
  const int k0 = kt * BK, w0 = k0 + 16 * warp;

  // the (q head, q tile) pairs this block visits: for each of the g q-heads
  // of its group, the q tiles whose last position reaches this k tile
  const int n_qt = (T_ + BQ - 1) / BQ;
  int i0 = 0;
  if (causal) {
    const int first = k_off + k0 - q_off;  // the local q row of this tile's first key
    i0 = first <= 0 ? 0 : min(n_qt, first / BQ);
  }
  const int per_head = n_qt - i0, n_it = g * per_head;
  auto fetch = [&](int n) {
    const int st = n % ST, h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
    copy_tile_async<T, DP, BQ, NT>(q_s + st * BQ * LD, LD, q + qoff, qs, T_, D);
    copy_tile_async<T, DP, BQ, NT>(do_s + st * BQ * LD, LD, dout + qoff, qs, T_, D);
    cp_async_commit();
  };
  if (n_it > 0) {
    if (ST == 2) fetch(0);
    load_tile<T, DP, BK, NT, false>(k_s, LD, k + koff, k0, T_, D, nullptr, nullptr);
    load_tile<T, DP, BK, NT, false>(v_s, LD, v + koff, k0, T_, D, nullptr, nullptr);
  }
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
    const T* qsm = q_s + (n % ST) * BQ * LD;
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
        const bool masked = t >= T_ || key >= T_ || (causal && k_off + key > q_off + t);
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
    __syncthreads();  // every warp is done with this stage and lse2/delta
  }

#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = w0 + acc_row(e), col = acc_col(j, e);
      if (key < T_ && col < D) {
        dk[koff + static_cast<size_t>(key) * D + col] = dk_acc[j][e];
        dv[koff + static_cast<size_t>(key) * D + col] = dv_acc[j][e];
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, float* dk, float* dv, int B, int H, int Hkv, int T_,
           int D, int q_off, int k_off, int causal, float scale, float scale_log2e,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr int W = Warps<T>::N, BQ = 16 * W;

  auto dq_kernel = ring_bwd_dq_kernel<T, DP>;
  const size_t dq_smem = dq_smem_bytes<T, DP>();
  cudaError_t e = allow_smem(dq_kernel, dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((T_ + BQ - 1) / BQ, H, B), 32 * W, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, dq, H, Hkv, T_, D, q_off, k_off, causal, scale, scale_log2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkv_kernel = ring_bwd_dkv_kernel<T, DP>;
  const size_t dkv_smem = dkv_smem_bytes<T, DP>();
  e = allow_smem(dkv_kernel, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((T_ + 16 * W - 1) / (16 * W), Hkv, B), 32 * W, dkv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, dk, dv, H, Hkv, T_, D, q_off, k_off, causal, scale,
      scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, float* dq, float* dk, float* dv, int B, int H, int Hkv, int T_,
             int D, int q_off, int k_off, int causal, float scale, float scale_log2e,
             cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off, k_off,
                           causal, scale, scale_log2e, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off, k_off,
                           causal, scale, scale_log2e, s);
    default:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off,
                            k_off, causal, scale, scale_log2e, s);
  }
}

}  // namespace

// All tensors contiguous; q, k, v, do of one dtype; lse and delta (B, H, T)
// f32; dq (B, H, T, D), dk and dv (B, Hkv, T, D) f32, written whole; D even,
// a multiple of the 16-byte vector and at most 128; H % Hkv == 0; k and v
// hold T rows, as q. Launches the dq pass, then the dk/dv pass, on
// `stream`. Returns the first CUDA error.
extern "C" int tt_ring_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk,
                                 void* dv, int B, int H, int Hkv, int T, int D, int q_off,
                                 int k_off, int causal, float scale, float scale_log2e,
                                 int dtype, void* stream) {
  if (D > 128 || D % 2 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  switch (dtype) {
    case tt::kF32:
      return dispatch<float>(q, k, v, dout, l, dl, dqf, dkf, dvf, B, H, Hkv, T, D, q_off, k_off,
                             causal, scale, scale_log2e, s);
    case tt::kBF16:
      return dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dqf, dkf, dvf, B, H, Hkv, T, D, q_off,
                                     k_off, causal, scale, scale_log2e, s);
    case tt::kF16:
      return dispatch<__half>(q, k, v, dout, l, dl, dqf, dkf, dvf, B, H, Hkv, T, D, q_off, k_off,
                              causal, scale, scale_log2e, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
