// One backward step of ring attention (context parallelism) in f32, for
// Hopper (sm_90a): the f32 route of tt_ring_flash_bwd, whose bf16/fp16
// route runs the one-pass wgmma core of csrc/flash_bwd_sm90.cu (wgmma would
// round f32 operands to tf32, so f32, the agreement dtype, stays here).
//
// Replaces, with that entry, thunder_tpu/executors/pallasex.py:
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
// sums them outside.
//
// What bounds it: the products, 2.5x the forward step's (recomputed q·kᵀ
// and do·vᵀ, and dq, dk, dv), at the f32 rate outside the tensor cores.
//
// The design: flash_rope_bwd.cu's two passes (RoPE compiled out) with
// global offsets and f32 outputs, f32 FMA tiles from shared memory, no
// atomics, so two runs give the same bits:
//   - dq: one block per (q tile of 64 rows, head, batch) loops over the
//     64-key tiles of the shard up to the global causal limit and writes
//     its rows of dq (zeros when the shard is wholly in its future).
//   - dk/dv: one block per (k tile of 64 keys, kv head, batch) loops over
//     the g q-heads of its group and over the q tiles that can see its
//     keys, in the transposed orientation (rows = keys), and writes its
//     rows of dk and dv.
// q_off and k_off are kernel arguments: no host sync.
//
// Not done yet: the two passes recompute q·kᵀ and do·vᵀ each.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;  // keys per streamed k/v tile of the dq pass

using T = float;  // the f32 route only
constexpr int kWarps = 4;

// q rows per inner tile of the dk/dv pass (two 16 x D f32 accumulators per
// warp at D = 128 leave room for only 32-column score tiles)
template <int DP> struct DkvRows { static constexpr int N = DP <= 64 ? 64 : 32; };

template <int DP>
size_t dq_smem_bytes() {
  constexpr int BQ = 16 * kWarps, LD = DP + Pad<T>::N;
  // q, do, k, v, ds
  return sizeof(T) * ((2 * BQ + 2 * kBK) * LD + BQ * (kBK + Pad<T>::N));
}

template <int DP>
size_t dkv_smem_bytes() {
  constexpr int BK = 16 * kWarps, BQ = DkvRows<DP>::N, LD = DP + Pad<T>::N;
  // lse2 and delta; k, v, q, do, p / ds
  return sizeof(float) * 2 * BQ + sizeof(T) * ((2 * BK + 2 * BQ) * LD + BK * (BQ + Pad<T>::N));
}

template <int DP>
__global__ void __launch_bounds__(32 * kWarps)
    ring_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq, int H, int Hkv,
                       int T_, int D, int q_off, int k_off, int causal, float scale,
                       float scale_log2e) {
  constexpr int W = kWarps, NT = 32 * W, BQ = 16 * W;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = kBK + Pad<T>::N;
  constexpr int NS = kBK / 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * LD;
  T* k_s = do_s + BQ * LD;
  T* v_s = k_s + kBK * LD;
  T* ds_s = v_s + kBK * LD;

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
    copy_tile_async<T, DP, kBK, NT>(k_s, LD, kb, kt * kBK, T_, D);
    copy_tile_async<T, DP, kBK, NT>(v_s, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n_kt > 0) {
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
    const T* ks = k_s;
    const T* vs = v_s;
    fetch(kt);
    cp_async_wait<0>();
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

template <int DP>
__global__ void __launch_bounds__(32 * kWarps)
    ring_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, int H, int Hkv, int T_, int D, int q_off,
                        int k_off, int causal, float scale, float scale_log2e) {
  constexpr int W = kWarps, NT = 32 * W, BK = 16 * W;
  constexpr int BQ = DkvRows<DP>::N;
  constexpr int LD = DP + Pad<T>::N;
  constexpr int LP = BQ + Pad<T>::N;
  constexpr int NS = BQ / 8;
  constexpr int NO = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse2_s = reinterpret_cast<float*>(smem);  // BQ
  float* dl_s = lse2_s + BQ;                       // BQ
  T* k_s = reinterpret_cast<T*>(dl_s + BQ);
  T* v_s = k_s + BK * LD;
  T* q_s = v_s + BK * LD;
  T* do_s = q_s + BQ * LD;
  T* p_s = do_s + BQ * LD;

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
    const int h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
    copy_tile_async<T, DP, BQ, NT>(q_s, LD, q + qoff, qs, T_, D);
    copy_tile_async<T, DP, BQ, NT>(do_s, LD, dout + qoff, qs, T_, D);
    cp_async_commit();
  };
  if (n_it > 0) {
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
    const T* qsm = q_s;
    const T* dos = do_s;
    fetch(n);
    cp_async_wait<0>();
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

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, float* dk, float* dv, int B, int H, int Hkv, int T_,
           int D, int q_off, int k_off, int causal, float scale, float scale_log2e,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  constexpr int W = kWarps, BQ = 16 * W;

  auto dq_kernel = ring_bwd_dq_kernel<DP>;
  const size_t dq_smem = dq_smem_bytes<DP>();
  cudaError_t e = allow_smem(dq_kernel, dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((T_ + BQ - 1) / BQ, H, B), 32 * W, dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, dq, H, Hkv, T_, D, q_off, k_off, causal, scale, scale_log2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkv_kernel = ring_bwd_dkv_kernel<DP>;
  const size_t dkv_smem = dkv_smem_bytes<DP>();
  e = allow_smem(dkv_kernel, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((T_ + 16 * W - 1) / (16 * W), Hkv, B), 32 * W, dkv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, dk, dv, H, Hkv, T_, D, q_off, k_off, causal, scale,
      scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, float* dq, float* dk, float* dv, int B, int H, int Hkv, int T_,
             int D, int q_off, int k_off, int causal, float scale, float scale_log2e,
             cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off, k_off,
                           causal, scale, scale_log2e, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off, k_off,
                           causal, scale, scale_log2e, s);
    default:
      return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T_, D, q_off,
                            k_off, causal, scale, scale_log2e, s);
  }
}

}  // namespace

// The f32 route of tt_ring_flash_bwd (csrc/flash_bwd_sm90.cu): all tensors
// contiguous f32; q, do (B, H, T, D); k, v (B, Hkv, T, D); lse and delta (B,
// H, T); dq (B, H, T, D), dk and dv (B, Hkv, T, D), written whole; D even
// and at most 128; H % Hkv == 0. Launches the dq pass, then the dk/dv
// pass, on `stream`. Returns the first CUDA error.
extern "C" int tt_ring_flash_bwd_f32_two_pass(const float* q, const float* k, const float* v,
                                              const float* dout, const float* lse,
                                              const float* delta, float* dq, float* dk, float* dv,
                                              int B, int H, int Hkv, int T, int D, int q_off,
                                              int k_off, int causal, float scale,
                                              float scale_log2e, cudaStream_t stream) {
  if (D > 128 || D % 2 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, T, D, q_off, k_off,
                         causal, scale, scale_log2e, stream);
}
