// Flash attention backward in f32, with or without RoPE applied in the
// kernel, for Hopper (sm_90a): the f32 route of tt_flash_rope_bwd and
// tt_flash_bwd (csrc/flash_bwd_sm90.cu, whose bf16/fp16 route is one wgmma
// pass). f32 is the agreement dtype: wgmma would round its operands to tf32.
//
// It replaces, for f32, thunder_tpu/executors/pallasex.py:
// flash_rope_attention_backward and the single-pass
// _flash_rope_backward_fused it runs by default (kernel bodies
// _flash_rope_bwd_dq_kernel, _flash_rope_bwd_dkv_kernel(_mha),
// _flash_rope_bwd_fused_kernel), and pallasex.py:flash_attention_backward and
// _flash_backward_fused (kernel bodies _flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel(_mha), _flash_bwd_fused_kernel): the same two kernels
// with RoPE compiled out, reading no cos/sin. From pre-RoPE q, k, v, the
// forward's lse, delta = rowsum(do·o) (taken in f32 by flash_bwd_sm90.cu's
// prologue, as pallasex takes it outside its pallas_call) and do, it
// recomputes the probabilities tile by tile and returns dq, dk, dv with the
// RoPE VJP dxr·cos + rotate_halfᵀ(dxr·sin) applied to dq and dk before the
// store.
//
// What bounds it: the products, by plain f32 FMAs (flash_common.cuh's
// warp_mma for f32).
//
// What the design does about that: tiles in shared memory, nothing of size T²
// in device memory, and no atomics, so two runs give the same bits. Blocks
// run in any order and share no state, so the TPU's single pass (dk/dv
// carried in VMEM scratch across a sequential grid axis) becomes two passes:
//   - dq: one block per (q tile of 64 rows, head, batch) loops over the
//     64-key k tiles up to the causal limit, recomputing p and ds, and
//     accumulates dq in registers.
//   - dk/dv: one block per (k tile of 64 keys, kv head, batch) loops over the
//     g q-heads of its group and over the q tiles at or past the causal
//     start, in the transposed orientation (rows = keys, as the TPU's
//     _dkv_tile), and accumulates dk and dv in registers: the TPU's group-sum
//     of dk/dv is this inner loop.
// In both, a streamed tile is roped in shared memory once it has landed.
// RoPE is a compile-time switch.

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;              // keys per streamed k/v tile of the dq pass
constexpr int kWarps = 4;            // a block: 64 q rows (dq pass) or 64 keys (dk/dv pass)
constexpr int kPad = Pad<float>::N;  // shared-memory row padding, in elements

// q rows per inner tile of the dk/dv pass: at D = 128 two 16 x D f32
// accumulators per warp leave room for only 32-column score tiles.
template <int DP> struct DkvRows { static constexpr int N = DP <= 64 ? 64 : 32; };

template <int DP, bool ROPE>
size_t dq_smem_bytes() {
  constexpr int BQ = 16 * kWarps, LD = DP + kPad;
  // q, do, raw k and v, roped k (with RoPE only), ds
  return sizeof(float) * ((2 * BQ + 2 * kBK + (ROPE ? kBK : 0)) * LD + BQ * (kBK + kPad));
}

template <int DP, bool ROPE>
size_t dkv_smem_bytes() {
  constexpr int BK = 16 * kWarps, BQ = DkvRows<DP>::N, LD = DP + kPad;
  // lse2 and delta; k, v, raw q and do, roped q (with RoPE only), p / ds
  return sizeof(float) * (2 * BQ + (2 * BK + 2 * BQ + (ROPE ? BQ : 0)) * LD + BK * (BQ + kPad));
}

template <int DP, bool ROPE>
__global__ void __launch_bounds__(32 * kWarps)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ cos, const float* __restrict__ sin,
                        float* __restrict__ dq, int H, int Hkv, int T_, int D, int causal,
                        float scale, float scale_log2e) {
  constexpr int W = kWarps, NT = 32 * W, BQ = 16 * W;
  constexpr int LD = DP + kPad;
  constexpr int LP = kBK + kPad;
  constexpr int NS = kBK / 8;
  constexpr int NO = DP / 8;
  static_assert(BQ * (DP + 1) <= 2 * kBK * LD, "the dq staging reuses the k and v tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + BQ * LD;
  float* kraw_s = do_s + BQ * LD;  // the raw k tile, then the v tile
  float* v_s = kraw_s + kBK * LD;
  float* k_s = v_s + kBK * LD;     // the roped k tile (with RoPE only)
  float* ds_s = k_s + (ROPE ? kBK * LD : 0);
  float* dq_s = reinterpret_cast<float*>(kraw_s);  // BQ x (DP + 1), after the loop

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const size_t slab = static_cast<size_t>(T_) * D;
  const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
  const float* kb = k + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const float* vb = v + (static_cast<size_t>(b) * Hkv + hk) * slab;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
  const int q0 = qt * BQ, w0 = q0 + 16 * warp;

  int n_kt = (T_ + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + kBK - 1) / kBK);
  auto fetch = [&](int kt) {
    copy_tile_async<float, DP, kBK, NT>(kraw_s, LD, kb, kt * kBK, T_, D);
    copy_tile_async<float, DP, kBK, NT>(v_s, LD, vb, kt * kBK, T_, D);
    cp_async_commit();
  };
  load_tile<float, DP, BQ, NT, ROPE>(q_s, LD, q + qoff, q0, T_, D, cos, sin);
  load_tile<float, DP, BQ, NT, false>(do_s, LD, dout + qoff, q0, T_, D, nullptr, nullptr);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + acc_row(2 * r);
    lse2[r] = row < T_ ? lse[row0 + row] * 1.4426950408889634f : 0.f;  // natural log -> log2
    dl[r] = row < T_ ? delta[row0 + row] : 0.f;
  }
  const float* qw = q_s + 16 * warp * LD;
  const float* dow = do_s + 16 * warp * LD;
  float* dsw = ds_s + 16 * warp * LP;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const float* kr = kraw_s;
    const float* vs = v_s;
    fetch(kt);
    cp_async_wait<0>();
    __syncthreads();
    if (ROPE) {
      rope_tile<float, DP, kBK, NT>(k_s, kr, LD, k0, T_, D, cos, sin);
      __syncthreads();
    }
    const float* ks = ROPE ? k_s : kr;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    warp_mma<float, NS, DP, true>(s, qw, LD, ks, LD);   // q·kᵀ
    warp_mma<float, NS, DP, true>(dp, dow, LD, vs, LD);  // do·vᵀ
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_col(j, e), row = w0 + acc_row(e), r = e >> 1;
        const float x = (key >= T_ || (causal && key > row)) ? kNegInf : s[j][e] * scale_log2e;
        s[j][e] = exp2f(x - lse2[r]) * (dp[j][e] - dl[r]) * scale;  // ds
      }
    }
    store_acc<float, NS>(dsw, LP, s);
    __syncwarp();
    warp_mma<float, NO, kBK, false>(acc, dsw, LP, ks, LD);  // dq += ds·k
    __syncthreads();
  }

  float* dqw = dq_s + 16 * warp * (DP + 1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqw[acc_row(e) * (DP + 1) + acc_col(j, e)] = acc[j][e];
  }
  __syncwarp();
  store_rows<float, ROPE>(dq + qoff, dqw, DP + 1, w0, T_, D, cos, sin);
}

template <int DP, bool ROPE>
__global__ void __launch_bounds__(32 * kWarps)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ cos, const float* __restrict__ sin,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int T_,
                         int D, int causal, float scale, float scale_log2e) {
  constexpr int W = kWarps, NT = 32 * W, BK = 16 * W;
  constexpr int BQ = DkvRows<DP>::N;
  constexpr int LD = DP + kPad;
  constexpr int LP = BQ + kPad;
  constexpr int NS = BQ / 8;
  constexpr int NO = DP / 8;
  static_assert(BK * (DP + 1) <= 2 * BK * LD, "the dk staging reuses the k and v tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse2_s = reinterpret_cast<float*>(smem);  // BQ
  float* dl_s = lse2_s + BQ;                       // BQ
  float* k_s = reinterpret_cast<float*>(dl_s + BQ);
  float* v_s = k_s + BK * LD;
  float* qraw_s = v_s + BK * LD;  // the raw q tile, then the do tile
  float* do_s = qraw_s + BQ * LD;
  float* q_s = do_s + BQ * LD;     // the roped q tile (with RoPE only)
  float* p_s = q_s + (ROPE ? BQ * LD : 0);
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
    const int h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t qoff = (static_cast<size_t>(b) * H + h) * slab;
    copy_tile_async<float, DP, BQ, NT>(qraw_s, LD, q + qoff, qs, T_, D);
    copy_tile_async<float, DP, BQ, NT>(do_s, LD, dout + qoff, qs, T_, D);
    cp_async_commit();
  };
  load_tile<float, DP, BK, NT, ROPE>(k_s, LD, k + koff, k0, T_, D, cos, sin);
  load_tile<float, DP, BK, NT, false>(v_s, LD, v + koff, k0, T_, D, nullptr, nullptr);
  const float* kw = k_s + 16 * warp * LD;
  const float* vw = v_s + 16 * warp * LD;
  float* pw = p_s + 16 * warp * LP;

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int n = 0; n < n_it; ++n) {
    const int h = hk * g + n / per_head, qs = (i0 + n % per_head) * BQ;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * T_;
    const float* qr = qraw_s;
    const float* dos = do_s;
    fetch(n);
    cp_async_wait<0>();
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int t = qs + i;
      lse2_s[i] = t < T_ ? lse[row0 + t] * 1.4426950408889634f : 0.f;
      dl_s[i] = t < T_ ? delta[row0 + t] : 0.f;
    }
    __syncthreads();
    if (ROPE) {
      rope_tile<float, DP, BQ, NT>(q_s, qr, LD, qs, T_, D, cos, sin);
      __syncthreads();
    }
    const float* qsm = ROPE ? q_s : qr;

    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
    warp_mma<float, NS, DP, true>(st, kw, LD, qsm, LD);   // k·qᵀ
    warp_mma<float, NS, DP, true>(dpt, vw, LD, dos, LD);  // v·doᵀ
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
    store_acc<float, NS>(pw, LP, st);
    __syncwarp();
    warp_mma<float, NO, BQ, false>(dv_acc, pw, LP, dos, LD);  // dv += pᵀ·do
    __syncwarp();
    store_acc<float, NS>(pw, LP, dpt);
    __syncwarp();
    warp_mma<float, NO, BQ, false>(dk_acc, pw, LP, qsm, LD);  // dk += dsᵀ·q
    __syncthreads();  // every warp is done with this stage, q_s and lse2/delta
  }

  float* dkw = dk_s + 16 * warp * (DP + 1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkw[acc_row(e) * (DP + 1) + acc_col(j, e)] = dk_acc[j][e];
      const int key = w0 + acc_row(e), col = acc_col(j, e);
      if (key < T_ && col < D) dv[koff + static_cast<size_t>(key) * D + col] = dv_acc[j][e];
    }
  }
  __syncwarp();
  store_rows<float, ROPE>(dk + koff, dkw, DP + 1, w0, T_, D, cos, sin);
}

template <int DP, bool ROPE>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
           const float* delta, const float* cos, const float* sin, float* dq, float* dk, float* dv,
           int B, int H, int Hkv, int T_, int D, int causal, float scale, float scale_log2e,
           cudaStream_t stream) {
  constexpr int BQ = 16 * kWarps, BK = 16 * kWarps;  // q rows / keys a block

  auto dq_kernel = flash_bwd_dq_kernel<DP, ROPE>;
  const size_t dq_smem = dq_smem_bytes<DP, ROPE>();
  cudaError_t e = allow_smem(dq_kernel, dq_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<dim3((T_ + BQ - 1) / BQ, H, B), 2 * BQ, dq_smem, stream>>>(
      q, k, v, dout, lse, delta, cos, sin, dq, H, Hkv, T_, D, causal, scale, scale_log2e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto dkv_kernel = flash_bwd_dkv_kernel<DP, ROPE>;
  const size_t dkv_smem = dkv_smem_bytes<DP, ROPE>();
  e = allow_smem(dkv_kernel, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((T_ + BK - 1) / BK, Hkv, B), 32 * kWarps, dkv_smem, stream>>>(
      q, k, v, dout, lse, delta, cos, sin, dk, dv, H, Hkv, T_, D, causal, scale, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROPE>
int dispatch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
             const float* delta, const float* cos, const float* sin, float* dq, float* dk,
             float* dv, int B, int H, int Hkv, int T_, int D, int causal, float scale,
             float scale_log2e, cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<32, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T_, D,
                              causal, scale, scale_log2e, s);
    case 64:
      return launch<64, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T_, D,
                              causal, scale, scale_log2e, s);
    default:
      return launch<128, ROPE>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T_, D,
                               causal, scale, scale_log2e, s);
  }
}

}  // namespace

// The f32 backward (tt_flash_rope_bwd and tt_flash_bwd of flash_bwd_sm90.cu
// call it after their prologue has taken delta): all tensors contiguous f32;
// lse and delta (B, H, T); cos/sin (T, D), or null for no RoPE; D even, a
// multiple of 4 and at most 128; H % Hkv == 0. Launches the dq pass, then
// the dk/dv pass, on `stream`. Returns the first CUDA error.
extern "C" int tt_flash_bwd_f32_two_pass(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         const float* cos, const float* sin, float* dq, float* dk,
                                         float* dv, int B, int H, int Hkv, int T, int D,
                                         int causal, float scale, float scale_log2e,
                                         cudaStream_t stream) {
  if (D > 128 || D % 2 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (cos != nullptr)
    return dispatch<true>(q, k, v, dout, lse, delta, cos, sin, dq, dk, dv, B, H, Hkv, T, D, causal,
                          scale, scale_log2e, stream);
  return dispatch<false>(q, k, v, dout, lse, delta, nullptr, nullptr, dq, dk, dv, B, H, Hkv, T, D,
                         causal, scale, scale_log2e, stream);
}
