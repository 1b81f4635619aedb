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
// ~16.8 MB, 5.0 us: the byte-bound case, like decode. What held the earlier
// kernel back was a serial walk over every key of a sequence in one block
// per (64 query rows, kv head, sequence): 128 blocks at the chunk shape, 64
// at verify with 12 live rows of 64.
//
// The design: executors/cudaex.py:paged_chunk_plan picks a route from the
// shapes and the table's width alone (no read of q_pos, so the launches are
// safe to capture in a CUDA graph).
//   1. wgmma (chunks in bf16 and fp16, pages of a multiple of 8 slots that
//      divides 128): the flash forward's persistent core in paged mode
//      (csrc/flash_fwd_sm90.cu: tt_paged_chunk_fwd), one item per (128
//      queries, q head, sequence), the K/V tiles gathered by one TMA copy a
//      page, each row masked at its position. No split, no scratch: at the
//      chunk shape a split kernel (route 2) measured slower at every split
//      (tools/ring_chunk_ab.py --sweep).
//   2. Split kernel (verify, where g·T <= 16; f32, the agreement dtype; other
//      page sizes), one block per (key split, row tile, kv head, sequence).
//      A row tile holds the g q-heads of its kv head interleaved, rows
//      ordered by t (row r is query t = r / g of head j = r % g), so its
//      positions are contiguous: verify takes tiles of 16 rows, one warp a
//      block, and the decode's 128-token splits; the others tiles of 64
//      rows, four warps, and the largest split (from the whole table down
//      to 128 tokens) that gives two waves of blocks on 132 SMs. A block
//      walks only its split's keys at or below the tile's largest position,
//      in 64-key tiles: each key row is gathered through the page table (key
//      kk is slot kk % ps of page page_table[b, kk / ps], rows strided Hkv·D
//      apart in the pool; the split's page ids staged in shared memory once)
//      with cp.async, the next tile copied while this one is computed
//      (16-bit types; f32 keeps one stage), one block barrier a tile; a
//      block whose split starts past the tile's largest position exits at
//      once. The products are mma.sync m16n8k16 with f32 accumulation, a
//      warp's probabilities packed from the score accumulators into the A
//      fragments of p·v in registers (f32 multiplies with FMAs from shared
//      memory, flash_common.cuh); the online softmax is base 2 with
//      scale·log2(e) folded in. The probabilities are rounded to the pool
//      dtype before p·v, as the TPU kernel rounds them, but against the
//      split's running max, not the row's (the plain split stage,
//      cudaex.paged_chunk_split_plain, rounds the same way; the whole stays
//      within the bf16 bar of the unsplit plain version); l sums the
//      unrounded ones. A masked key contributes exactly 0, so a split with
//      no live key of a row holds (0, -1e30, 0). A row with one live split
//      (or none) is written, normalised, by split 0's block (zeros when no
//      key is live: the l == 0 guard); the others write their f32 (o, m, l)
//      partials (B, H, T, n_split, D + 2).
//   3. The combine (csrc/paged_combine.cuh, shared with the decode), one
//      warp per (b, h, t) row, launched whenever a split kernel ran more
//      than one split: the row's live splits, ceil(min(q_pos + 1, npm·ps) /
//      split), rescaled to their common max, into o.

#include "paged_combine.cuh"  // the combine; includes flash_common.cuh

// csrc/flash_fwd_sm90.cu: the wgmma route (the flash forward's core in
// paged mode).
extern "C" int tt_paged_chunk_fwd(const void* q, const void* k_pages, const void* v_pages,
                                  const int* page_table, const int* q_pos, void* out, int B, int H,
                                  int Hkv, int T, int D, int P, int ps, int npm, float scale_log2e,
                                  int dtype, cudaStream_t stream);

namespace {

using namespace tt::flash;

constexpr int kBK = 64;  // keys per k/v tile
// k/v tiles in flight: two in 16-bit types (one ahead of the one in use:
// three measured no faster, with fewer blocks an SM), one in f32 (shared
// memory)
template <typename T> struct ChunkStages { static constexpr int N = sizeof(T) == 4 ? 1 : 2; };

// Pages a split of `split` keys can touch: its page ids are staged in
// shared memory once, so no gather waits on a read of the table.
inline int split_pages(int split, int ps) { return (split + ps - 1) / ps + 1; }

// O += P·V with P, this warp's score accumulators, rounded to T and packed
// into A fragments in registers (16-bit types): the accumulator layout of
// two 8-key slices is the A layout of one 16-key slice, so no probability
// goes through shared memory.
template <typename T, int NO, int NS>
__device__ __forceinline__ void pv_regs(float (&acc)[NO][4], const float (&p)[NS][4], const T* V,
                                        int ldv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const uint32_t a[4] = {pack2(tt::from_f32<T>(p[2 * kk][0]), tt::from_f32<T>(p[2 * kk][1])),
                           pack2(tt::from_f32<T>(p[2 * kk][2]), tt::from_f32<T>(p[2 * kk][3])),
                           pack2(tt::from_f32<T>(p[2 * kk + 1][0]), tt::from_f32<T>(p[2 * kk + 1][1])),
                           pack2(tt::from_f32<T>(p[2 * kk + 1][2]), tt::from_f32<T>(p[2 * kk + 1][3]))};
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, V + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldv + 8 * j + 8 * (lane >> 4));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma16816<T>(acc[j], a, b0);
      mma16816<T>(acc[j + 1], a, b1);
    }
  }
}

// Shared memory of a split block of W warps (16·W query rows): q, the k and
// v stages, the probabilities (f32 only), then the split's page ids.
template <typename T, int DP, int W>
size_t chunk_smem_bytes(int split, int ps) {
  constexpr int LD = DP + Pad<T>::N, ST = ChunkStages<T>::N;
  const int probs = sizeof(T) == 4 ? 16 * W * (kBK + Pad<T>::N) : 0;
  return sizeof(T) * ((16 * W + 2 * ST * kBK) * LD + probs) + sizeof(int) * split_pages(split, ps);
}

// Blocks an SM must hold: four of four warps (512 blocks in one wave on 132
// SMs), so at most 128 registers a thread; the one-warp verify blocks are
// bounded by shared memory first.
template <int W> struct MinBlocks { static constexpr int N = W == 1 ? 8 : 4; };

template <typename T, int DP, int W>
__global__ void __launch_bounds__(32 * W, MinBlocks<W>::N)
    paged_chunk_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages, const int* __restrict__ page_table,
                             const int* __restrict__ q_pos, T* __restrict__ out,
                             float* __restrict__ part, int H, int Hkv, int Tq, int D, int ps,
                             int npm, int split, int n_split, float scale_log2e) {
  constexpr int NT = 32 * W, BQ = 16 * W, ST = ChunkStages<T>::N;
  constexpr int LD = DP + Pad<T>::N;   // row stride of the q, k, v tiles
  constexpr int LP = kBK + Pad<T>::N;  // row stride of the probability tile
  constexpr int NS = kBK / 8;          // 8-column slices of a score row block
  constexpr int NO = DP / 8;           // 8-column slices of an output row block
  constexpr int V = tt::Vec<T>::N, CH = DP / V;
  constexpr bool kRegs = sizeof(T) == 2;  // P in registers; f32 multiplies with FMAs from smem
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int max_pos_s;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * LD;              // ST stages of k
  T* v_s = k_s + ST * kBK * LD;        // ST stages of v
  T* p_s = v_s + ST * kBK * LD;        // f32's probabilities
  int* pages_s = reinterpret_cast<int*>(p_s + (kRegs ? 0 : BQ * LP));  // the split's page ids

  // the split slowest: the blocks of split 0, live for every row that sees
  // a key, spread over the SMs before any later split's
  const int tile = blockIdx.x, hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv, s = blockIdx.z;
  const int g = H / Hkv, rows = g * Tq, r0 = tile * BQ;
  const int warp = threadIdx.x >> 5, w0 = 16 * warp;
  const int* qp = q_pos + static_cast<size_t>(b) * Tq;
  const int table = npm * ps;

  // the tile's largest position decides the keys it reads
  if (threadIdx.x == 0) max_pos_s = -1;
  __syncthreads();
  if (threadIdx.x < BQ && r0 + static_cast<int>(threadIdx.x) < rows)
    atomicMax(&max_pos_s, qp[(r0 + threadIdx.x) / g]);
  __syncthreads();
  const int k_begin = s * split;
  const int k_end = min(min(k_begin + split, max_pos_s + 1), table);
  // past the tile's largest position: nothing to add (split 0 still writes
  // its rows' zeros)
  if (k_begin >= k_end && s > 0) return;
  const int n_kt = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // the page ids of the split's live keys, read once
  const int page0 = k_begin / ps;
  const int* ptb = page_table + static_cast<size_t>(b) * npm + page0;
  if (n_kt > 0) {
    for (int i = threadIdx.x; i <= (k_end - 1) / ps - page0; i += NT) pages_s[i] = ptb[i];
  }
  __syncthreads();

  const size_t slot_stride = static_cast<size_t>(Hkv) * D;
  auto fetch = [&](int kt) {  // starts the gather of k/v tile kt into its stage
    T* kd = k_s + (kt % ST) * kBK * LD;
    T* vd = v_s + (kt % ST) * kBK * LD;
#pragma unroll
    for (int j = 0; j < kBK * CH / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i / CH, d0 = (i % CH) * V, kk = k_begin + kt * kBK + r;
      const bool valid = kk < k_end && d0 < D;
      size_t off = 0;
      if (valid) {
        const size_t page = static_cast<size_t>(pages_s[kk / ps - page0]);
        off = (page * ps + kk % ps) * slot_stride + static_cast<size_t>(hk) * D + d0;
      }
      cp_async16(kd + r * LD + d0, k_pages + off, valid);
      cp_async16(vd + r * LD + d0, v_pages + off, valid);
    }
    cp_async_commit();
  };
  if constexpr (ST > 1) {  // tiles 0 .. ST - 2 (an empty group for each past the last)
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_kt) fetch(i);
      else cp_async_commit();
    }
  }

  // q rows of the tile: row r is query t of head hk * g + j
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
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
    const int k0 = k_begin + kt * kBK;
    const T* ks = k_s + (kt % ST) * kBK * LD;
    const T* vs = v_s + (kt % ST) * kBK * LD;
    if constexpr (ST == 1) {
      fetch(kt);
      cp_async_wait<0>();
    } else {
      cp_async_wait<ST - 2>();  // this thread's copies of tile kt have landed
    }
    // tile kt (and, the first time, q) has landed for every thread, and
    // every warp is done with tile kt - 1, whose stage the next copy takes
    __syncthreads();
    if constexpr (ST > 1) {
      if (kt + ST - 1 < n_kt) fetch(kt + ST - 1);  // overlaps the math of tiles kt ..
      else cp_async_commit();
    }

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    warp_mma<T, NS, DP, true>(sc, qw, LD, ks, LD);

    bool live[NS][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + acc_col(j, e);
        live[j][e] = key < k_end && key <= pos[e >> 1];
        const float x = live[j][e] ? sc[j][e] * scale_log2e : kNegInf;
        sc[j][e] = x;
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
        sc[j][e] = live[j][e] ? exp2f(sc[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += sc[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    if constexpr (kRegs) {
      pv_regs<T, NO, NS>(acc, sc, vs, LD);  // p rounded to T for p·v
    } else {
      store_acc<T, NS>(pw, LP, sc);
      __syncwarp();  // this warp's probabilities are written
      warp_mma<T, NO, kBK, false>(acc, pw, LP, vs, LD);
    }
    if constexpr (ST == 1) __syncthreads();  // every warp is done with the one stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = r0 + w0 + acc_row(2 * r);
    if (R >= rows) continue;
    const int len = min(pos[r] + 1, table);
    const int n_live = len <= 0 ? 0 : (len + split - 1) / split;
    const size_t orow = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * g + R % g) * Tq + R / g;
    if (n_live <= 1) {  // this row's only split (or none): o itself, from split 0
      if (s != 0) continue;
      T* o = out + orow * D;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int col = acc_col(j, e);
          if (col < D) o[col] = tt::from_f32<T>(acc[j][e] / l_safe);
        }
      }
    } else if (s < n_live) {  // a partial for the combine
      float* pr = part + (orow * n_split + s) * static_cast<size_t>(D + 2);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int col = acc_col(j, e);
          if (col < D) pr[col] = acc[j][e];
        }
      }
      if ((threadIdx.x & 3) == 0) pr[D] = m[r], pr[D + 1] = l[r];
    }
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int *pt, *qpos;
  void* out;
  float* part;
  int B, H, Hkv, Tq, D, ps, npm, rows_per_block, split;
  float scale_log2e;
  cudaStream_t stream;
};

template <typename T, int DP, int W>
int launch_split(const Args& a, int n_split) {
  auto kernel = paged_chunk_split_kernel<T, DP, W>;
  const size_t smem = chunk_smem_bytes<T, DP, W>(a.split, a.ps);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = (a.H / a.Hkv) * a.Tq;
  kernel<<<dim3((rows + 16 * W - 1) / (16 * W), a.B * a.Hkv, n_split), 32 * W, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp), static_cast<const T*>(a.vp), a.pt,
      a.qpos, static_cast<T*>(a.out), a.part, a.H, a.Hkv, a.Tq, a.D, a.ps, a.npm, a.split, n_split,
      a.scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int dispatch_dim(const Args& a, int n_split) {
  switch (padded_head_dim(a.D)) {
    case 32:
      return launch_split<T, 32, W>(a, n_split);
    case 64:
      return launch_split<T, 64, W>(a, n_split);
    default:
      return launch_split<T, 128, W>(a, n_split);
  }
}

template <typename T>
int run(const Args& a) {
  const int n_split = a.npm * a.ps > a.split ? (a.npm * a.ps + a.split - 1) / a.split : 1;
  int e = a.rows_per_block == 16 ? dispatch_dim<T, 1>(a, n_split) : dispatch_dim<T, 4>(a, n_split);
  if (e || n_split == 1) return e;
  return launch_combine<T>(a.part, a.qpos, 1, static_cast<T*>(a.out), a.B * a.H * a.Tq, a.H, a.Tq,
                           a.D, a.ps, a.npm, a.split, n_split, a.stream);
}

}  // namespace

// All tensors contiguous and 16-byte aligned; q, the pools and out of one
// dtype; D a multiple of the 16-byte vector and at most 128; H % Hkv == 0;
// page ids in [0, P). From the caller's plan (executors/cudaex.py:
// paged_chunk_plan): rows_per_block 128 runs the wgmma route
// (tt_paged_chunk_fwd: bf16/fp16, ps a multiple of 8 dividing 128; no
// split, no partials); 16 (verify) or 64 (chunk) the split kernel with
// split, a positive multiple of 64 keys, n_split = ceil(npm·ps / split) at
// most 128, and partials f32 (B, H, T, n_split, D + 2), null when n_split
// is 1 (refused otherwise), then (n_split > 1) the combine. On `stream`.
// Returns the first CUDA error.
extern "C" int tt_paged_chunk_attention(const void* q, const void* k_pages, const void* v_pages,
                                        const void* page_table, const void* q_pos, void* out,
                                        void* partials, int B, int H, int Hkv, int T, int D, int P,
                                        int ps, int npm, int rows_per_block, int split,
                                        float scale_log2e, int dtype, void* stream) {
  if (rows_per_block == 128)
    return tt_paged_chunk_fwd(q, k_pages, v_pages, static_cast<const int*>(page_table),
                              static_cast<const int*>(q_pos), out, B, H, Hkv, T, D, P, ps, npm,
                              scale_log2e, dtype, static_cast<cudaStream_t>(stream));
  const int vec = dtype == tt::kF32 ? 4 : 8;
  if (D > 128 || D % vec || H % Hkv || (rows_per_block != 16 && rows_per_block != 64) ||
      split < kBK || split % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = npm * ps > split ? (npm * ps + split - 1) / split : 1;
  if (n_split > 32 * kMaxSplitLanes || (n_split > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(q_pos), out, static_cast<float*>(partials),
               B, H, Hkv, T, D, ps, npm, rows_per_block, split, scale_log2e,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case tt::kF32:
      return run<float>(a);
    case tt::kBF16:
      return run<__nv_bfloat16>(a);
    case tt::kF16:
      return run<__half>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
