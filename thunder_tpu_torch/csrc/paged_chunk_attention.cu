// Paged chunk attention for Hopper (sm_90a): T new queries per sequence
// against the paged KV pool, each query with its own causal bound.
//
// Replaces thunder_tpu/executors/pallasex.py:paged_chunk_decode (kernel body
// _paged_chunk_kernel). Query (b, h, t) attends the key positions
// k_pos <= q_pos[b, t] of sequence b's pages; q head h reads kv head
// h / (H / Hkv).
//   q (B, H, T, D); k_pages, v_pages (P, page_size, Hkv, D); page_table
//   (B, npm) int32, page ids in [0, P); q_pos (B, T) int32; out (B, H, T, D).
// The serving path runs it in two programs: the chunked-prefill chunk (B=1,
// T = the chunk, positions start .. start+T-1) and the speculative verify step
// (B = max_batch, T = spec_k + 1, ragged positions).
//
// What bounds it: at the chunk shape (Llama-3-1B, B=1, H=32, Hkv=8, D=64,
// T=256 at start 1792, bf16) the products — 4·H·T·~1920·D ≈ 4.0 GFLOP, 4.1 us
// at 989 TFLOP/s, against ~6.3 MB of K/V, q and o, 1.9 us at 3.35 TB/s. At the
// verify shape (B=8, T=3, ~1024 live keys each) the bytes of the live K/V,
// ~16.8 MB, 5.0 us: the byte-bound case, like decode.
//
// What the design does about that: one block per (tile of 64 query rows, kv
// head, sequence). A tile holds the g q-heads of its kv head interleaved,
// rows ordered by t (row r is query t = r / g of head j = r % g), so its
// positions are contiguous and the block walks only the keys at or below the
// tile's largest position — the TPU kernel can skip pages only per sequence.
// At the chunk shape that is 16 tiles x 8 kv heads = 128 blocks. A loop inside
// the block walks 64-key tiles: each key row is gathered through the page
// table (key kk is slot kk % ps of page page_table[b, kk / ps], rows strided
// Hkv·D apart in the pool) with cp.async, the next tile copied while this one
// is computed (16-bit types; f32 keeps one stage). Pages past the tile's
// largest position are never read, nor is any table entry past n_pages_max.
// The products are mma.sync m16n8k16 with f32 accumulation from
// flash_common.cuh (f32, the agreement dtype, multiplies with FMAs, as the
// flash kernels do); the online softmax is base 2 with scale·log2(e) folded
// into the scale, and stays in registers. The probabilities are rounded to
// the pool dtype before p·v, as the TPU kernel and the ltorch decomposition
// round them; l sums the unrounded ones. A masked key contributes exactly 0,
// so a row with no live key gives zeros (the l == 0 guard).
//
// Not done yet: no wgmma or TMA; at the verify shape a tile holds g·T = 12
// live rows of its 64, and one block walks a whole sequence's pages (no
// split across blocks).

#include "flash_common.cuh"

namespace {

using namespace tt::flash;

constexpr int kBK = 64;     // keys per k/v tile
constexpr int kRows = 64;   // query rows per block: 4 warps of 16
constexpr int kThreads = 128;

template <typename T, int DP>
size_t chunk_smem_bytes() {
  constexpr int LD = DP + Pad<T>::N, ST = Stages<T>::N;
  // q, k and v stages, probabilities
  return sizeof(T) * ((kRows + 2 * ST * kBK) * LD + kRows * (kBK + Pad<T>::N));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ page_table,
                       const int* __restrict__ q_pos, T* __restrict__ out, int H, int Hkv,
                       int Tq, int D, int ps, int npm, float scale_log2e) {
  constexpr int ST = Stages<T>::N;
  constexpr int LD = DP + Pad<T>::N;   // row stride of the q, k, v tiles
  constexpr int LP = kBK + Pad<T>::N;  // row stride of the probability tile
  constexpr int NS = kBK / 8;          // 8-column slices of a score row block
  constexpr int NO = DP / 8;           // 8-column slices of an output row block
  constexpr int V = tt::Vec<T>::N, CH = DP / V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int max_pos_s;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * LD;           // ST stages of k
  T* v_s = k_s + ST * kBK * LD;        // ST stages of v
  T* p_s = v_s + ST * kBK * LD;

  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv, rows = g * Tq, r0 = tile * kRows;
  const int warp = threadIdx.x >> 5, w0 = 16 * warp;
  const int* qp = q_pos + static_cast<size_t>(b) * Tq;

  // the tile's largest position decides the keys it reads
  if (threadIdx.x == 0) max_pos_s = -1;
  __syncthreads();
  if (threadIdx.x < kRows && r0 + static_cast<int>(threadIdx.x) < rows)
    atomicMax(&max_pos_s, qp[(r0 + threadIdx.x) / g]);
  __syncthreads();
  const int n_keys = min(max_pos_s + 1, npm * ps);
  const int n_kt = (n_keys + kBK - 1) / kBK;

  const size_t slot_stride = static_cast<size_t>(Hkv) * D;
  const int* ptb = page_table + static_cast<size_t>(b) * npm;
  auto fetch = [&](int kt) {  // starts the gather of k/v tile kt into its stage
    T* kd = k_s + (kt % ST) * kBK * LD;
    T* vd = v_s + (kt % ST) * kBK * LD;
    for (int i = threadIdx.x; i < kBK * CH; i += kThreads) {
      const int r = i / CH, d0 = (i % CH) * V, kk = kt * kBK + r;
      const bool valid = kk < n_keys && d0 < D;
      size_t off = 0;
      if (valid) {
        const size_t page = static_cast<size_t>(ptb[kk / ps]);
        off = (page * ps + kk % ps) * slot_stride + static_cast<size_t>(hk) * D + d0;
      }
      cp_async16(kd + r * LD + d0, k_pages + off, valid);
      cp_async16(vd + r * LD + d0, v_pages + off, valid);
    }
    cp_async_commit();
  };
  if (ST == 2 && n_kt > 0) fetch(0);

  // q rows of the tile: row r is query t of head hk * g + j
  for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
    const int r = i / CH, d0 = (i % CH) * V, R = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < rows && d0 < D) {
      const size_t qrow = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * g + R % g) * Tq + R / g;
      val = *reinterpret_cast<const uint4*>(q + qrow * D + d0);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + d0) = val;
  }
  const T* qw = q_s + w0 * LD;
  T* pw = p_s + w0 * LP;

  // the positions of this thread's two rows; -1 (nothing live) past the rows
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = r0 + w0 + acc_row(2 * r);
    pos[r] = R < rows ? qp[R / g] : -1;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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
    __syncthreads();  // tile kt (and, the first time, q) has landed for every thread

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    warp_mma<T, NS, DP, true>(s, qw, LD, ks, LD);

    bool live[NS][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_col(j, e);
        live[j][e] = key < n_keys && key <= pos[e >> 1];
        const float x = live[j][e] ? s[j][e] * scale_log2e : kNegInf;
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
        s[j][e] = live[j][e] ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[j][e];
      }
    }
    store_acc<T, NS>(pw, LP, s);  // rounded to T for p·v
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
    const int R = r0 + w0 + acc_row(2 * r);
    if (R >= rows) continue;
    T* orow = out + ((static_cast<size_t>(b) * H + static_cast<size_t>(hk) * g + R % g) * Tq + R / g) * D;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const int col = acc_col(j, e);
        if (col < D) orow[col] = tt::from_f32<T>(acc[j][e] / l_safe);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* kp, const void* vp, const int* pt, const int* qpos, void* out,
           int B, int H, int Hkv, int Tq, int D, int ps, int npm, float scale_log2e,
           cudaStream_t stream) {
  auto kernel = paged_chunk_kernel<T, DP>;
  const size_t smem = chunk_smem_bytes<T, DP>();
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = (H / Hkv) * Tq;
  kernel<<<dim3((rows + kRows - 1) / kRows, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), pt, qpos,
      static_cast<T*>(out), H, Hkv, Tq, D, ps, npm, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* pt, const int* qpos,
             void* out, int B, int H, int Hkv, int Tq, int D, int ps, int npm, float scale_log2e,
             cudaStream_t s) {
  switch (padded_head_dim(D)) {
    case 32:
      return launch<T, 32>(q, kp, vp, pt, qpos, out, B, H, Hkv, Tq, D, ps, npm, scale_log2e, s);
    case 64:
      return launch<T, 64>(q, kp, vp, pt, qpos, out, B, H, Hkv, Tq, D, ps, npm, scale_log2e, s);
    default:
      return launch<T, 128>(q, kp, vp, pt, qpos, out, B, H, Hkv, Tq, D, ps, npm, scale_log2e, s);
  }
}

}  // namespace

// All tensors contiguous and 16-byte aligned; q, the pools and out of one
// dtype; D a multiple of the 16-byte vector and at most 128; H % Hkv == 0;
// page ids in [0, P). Returns the launch's CUDA error.
extern "C" int tt_paged_chunk_attention(const void* q, const void* k_pages, const void* v_pages,
                                        const void* page_table, const void* q_pos, void* out,
                                        int B, int H, int Hkv, int T, int D, int ps, int npm,
                                        float scale_log2e, int dtype, void* stream) {
  if (D > 128 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* qp = static_cast<const int*>(q_pos);
  switch (dtype) {
    case tt::kF32:
      return dispatch<float>(q, k_pages, v_pages, pt, qp, out, B, H, Hkv, T, D, ps, npm,
                             scale_log2e, s);
    case tt::kBF16:
      return dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, qp, out, B, H, Hkv, T, D, ps, npm,
                                     scale_log2e, s);
    case tt::kF16:
      return dispatch<__half>(q, k_pages, v_pages, pt, qp, out, B, H, Hkv, T, D, ps, npm,
                              scale_log2e, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
