// Flash attention forward, with or without RoPE, for Hopper (sm_90a): one
// pass over the keys with warpgroup products (wgmma) fed by TMA.
//
// tt_flash_rope_fwd replaces thunder_tpu/executors/pallasex.py:
// flash_rope_attention_forward (kernel body _flash_rope_fwd_kernel); tt_flash_fwd
// replaces pallasex.py:flash_attention_forward (kernel body _flash_fwd_kernel).
// From q (B, H, T, D) and k, v (B, Hkv, T, D) — pre-RoPE, with cos/sin (T, D)
// f32 duplicated-half caches, for the first — they return o (B, H, T, D) and
// the natural-log lse (B, H, T) in f32 that the backward reads. kv head = q
// head // (H / Hkv). Causal (key <= query from position 0 of both) or full.
// As the TPU kernels: q and k roped in f32 and rounded to the input dtype, a
// base-2 online softmax with log2(e) folded into the scale, the
// probabilities rounded to v's dtype before p·v, o divided by l (by 1 where
// l is 0) and lse = (m + log2 l)·ln 2.
//
// What bounds it: the products. Causal attention does 4·B·H·T²·D/2 flops
// against 4·B·H·T·D·2 bytes of q, k, v and o (GQA reads fewer): at
// llama-350m's shape (B=4, H=16, T=2048, D=64, bf16) 34.4 GFLOP, 34.7 us at
// the 989 TFLOP/s bf16 peak, against 69 MB (20.6 us at 3.35 TB/s).
//
// The design, for bf16 and fp16 (f32, the agreement dtype, keeps the
// mma.sync/FMA kernel of flash_rope_fwd.cu: wgmma would round f32 to tf32):
//   1. Prologue (RoPE only), 8 or 16 threads a row, 16 bytes a thread: q and
//      k roped once in f32 into scratch, each product and the sum rounded as
//      the plain version rounds them, then rounded to the input dtype as the
//      TPU kernels round them. The core never ropes a tile: the old kernel
//      roped every k tile in every q-tile block that read it (up to 16 times
//      at llama-350m). q is roped here too, not as its tile lands in the
//      core: roping it in the core (cos/sin read per tile, a warpgroup
//      barrier) measured slower than this pass over q.
//   2. Core, persistent: one block of two consumer warpgroups (64 query rows
//      each) and one producer warp per SM, walking work items (128-query
//      tile, q head, batch) the causal-heaviest first (item_at). The
//      producer's lane 0 loads each item's Q tile by TMA into one of two
//      buffers, so the next item's Q lands while this one finishes, and
//      streams the 128-key K and V tiles through two stages, each guarded by
//      a full and an empty mbarrier. Each warpgroup computes S = Q·Kᵀ by SS
//      wgmma (64 x 128, f32 in registers); the online softmax runs in
//      registers with ex2.approx, the mask only on diagonal and ragged
//      tiles; P is rounded to the input dtype and packed into A fragments,
//      and O += P·V runs by RS wgmma with V as the MN-major B operand: no
//      probability goes to shared memory. O stays in f32 registers over an
//      item; l is summed per thread and reduced across the row's four
//      threads once, at the end.
// Head dims pad as the backward's core pads them: D <= 64 runs at 64, D <=
// 128 at 128, TMA filling columns past D (and rows past T) with zeros.
//
// The core also runs tt_ring_flash_fwd (at the end of this file), one
// forward step of ring attention, in bf16 and fp16: a ring mode (template
// mode kRing) that folds a K/V shard into carried f32 accumulators. The
// causal mask and each item's key walk take the step's shift = q_off −
// k_off (0 for the attention entries): query row i sees key j iff j <= i +
// shift, an item walks key tiles up to its last row's limit, the mask runs
// only on tiles that straddle the shifted diagonal or the ragged edge (a
// past shard runs unmasked), and items whose rows see no key are not
// enumerated; a shard wholly in the future launches nothing. At item start
// a thread loads its rows of the carried unnormalized o into acc, the
// carried m into m (log2 units, as the core keeps it) and the carried l
// into the share of the quad's thread c == 0 only (the four shares are
// summed at the end, so seeding all four would count it four times); the
// epilogue writes o, m and l back in place, unnormalized. Within an item
// tile 0 still comes first, so with the ring's diagonal shard folded first
// every row has a finite max before a fully masked tile can reach it
// (masked scores are the finite -1e30). f32 rings run ring_flash_fwd.cu.
//
// And it runs tt_paged_chunk_fwd, the chunk route of paged chunk attention
// (csrc/paged_chunk_attention.cu), in bf16 and fp16: a paged mode in which
// the K and V tiles come from the paged pools through the page table, one
// TMA copy of ps rows per page (the pool viewed as (P·ps, Hkv, D) with a
// (D, 1, ps) box), by the producer warp's lanes, one page each. An item's
// key tiles run up to its 128 queries' largest position (the producer
// reads the positions and hands the count to the consumers in shared
// memory beside the Q buffer); each row is masked at its own position and
// the table's end; a row with no live key (position < 0) is written as
// zeros. Nothing is split: the item is a whole row of attention.
//
// Measured on the card and not kept (tools/flash_fwd_ab.py), slower or no
// faster: one block per item (slower at D = 64); three K/V stages;
// ping-ponged warpgroups, or each issuing tile n − 1's P·V with tile n's S;
// separate K and V barriers; thread 0 as the producer with three
// warpgroups at D = 64; four-chain row reductions. ptxas allots a
// 288-thread wgmma block 168 registers a thread: the core uses 166 to 168,
// so a second S or P in flight spills at D = 128.
//
// Every mbarrier wait traps after ~2^26 polls (sm90.cuh), so a fault in the
// core ends the launch with an error instead of hanging the card. No atomics:
// two runs give the same bits.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

// csrc/flash_rope_fwd.cu: the f32 kernel.
extern "C" int tt_flash_fwd_f32(const float* q, const float* k, const float* v, const float* cos,
                                const float* sin, float* o, float* lse, int B, int H, int Hkv,
                                int T, int D, int causal, float scale_log2e, cudaStream_t stream);

// csrc/ring_flash_fwd.cu: the ring step's f32 kernel.
extern "C" int tt_ring_flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                                     float* m, float* l, int B, int H, int Hkv, int T, int D,
                                     int q_off, int k_off, int causal, float scale_log2e,
                                     cudaStream_t stream);

namespace {

using namespace tt::sm90;

constexpr int kBQ = 128;                    // queries a block: 64 per consumer warpgroup
constexpr int kBK = 128;                    // keys a streamed K/V tile
constexpr int kStages = 2;                  // K/V tiles in flight
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kRowBytes = 128;              // one swizzled row: 64 16-bit elements
constexpr float kNegInf = -1e30f;           // the TPU kernels' finite NEG_INF
constexpr float kLn2 = 0.6931471805599453f;
// The core's modes: attention (o in T and lse), a ring step (carried f32
// o, m, l), paged chunk attention (K/V through a page table, per-row
// positions)
constexpr int kAttn = 0, kRing = 1, kPaged = 2;

// The paged mode's inputs: page_table (B, npm) int32, q_pos (B, T) int32,
// ps slots a page.
struct Paged {
  const int* page_table;
  const int* q_pos;
  int ps, npm;
};

// Shared-memory layout of the core for a padded head dim DP (64 or 128),
// offsets in bytes from a 1024-byte-aligned base.
template <int DP> struct Smem {
  static constexpr int kBlocks = DP / 64;                     // 64-wide column blocks
  static constexpr int kQBytes = kBlocks * kBQ * kRowBytes;   // the Q tile
  static constexpr int kKvBytes = kBlocks * kBK * kRowBytes;  // one K (or V) tile
  static constexpr int Q = 0;                                 // two Q buffers
  static constexpr int K = Q + 2 * kQBytes;
  static constexpr int V = K + kStages * kKvBytes;
  // full and empty barriers of each Q buffer, then of each K/V stage, then
  // the key tiles of each Q buffer's item (paged mode)
  static constexpr int BAR = V + kStages * kKvBytes;
  static constexpr int NKT = BAR + 8 * (4 + 2 * kStages);
  static constexpr int kBytes = NKT + 8 + 1024;  // + alignment slack
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
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = tt::from_f32<T>(x[i + j]);
    *reinterpret_cast<uint4*>(p + i) = v;
  }
}

// Rows [0, q_rows) are q's rows (b·H + h, t), the rows past them k's (b·Hkv
// + hk, t): each is roped, x·cos + rotate_half(x)·sin in f32, and rounded to
// T into the same row of out (the scratch: q's rows, then k's). TPR threads
// a row, each a 16-byte chunk at a time.
template <typename T, int TPR>
__global__ void __launch_bounds__(256)
    flash_fwd_prologue(const T* __restrict__ q, const T* __restrict__ k,
                       const float* __restrict__ cos, const float* __restrict__ sin,
                       T* __restrict__ out, long long q_rows, long long rows, int T_, int D) {
  constexpr int V = tt::Vec<T>::N;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / TPR;
  if (row >= rows) return;
  const int lane = threadIdx.x % TPR, h = D / 2, t = static_cast<int>(row % T_);
  const T* x_row = row < q_rows ? q + row * D : k + (row - q_rows) * D;
  const float* c_row = cos + static_cast<size_t>(t) * D;
  const float* s_row = sin + static_cast<size_t>(t) * D;
  for (int d0 = lane * V; d0 < D; d0 += TPR * V) {
    float x[V], p[V], c[V], sn[V];
    load_f32<V>(x_row + d0, x);
    if (h % V == 0) {  // the partners x[d ± D/2] lie in one chunk
      load_f32<V>(x_row + (d0 < h ? d0 + h : d0 - h), p);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = tt::to_f32(x_row[d0 + i < h ? d0 + i + h : d0 + i - h]);
    }
    load_f32<V>(c_row + d0, c);
    load_f32<V>(s_row + d0, sn);
#pragma unroll
    for (int i = 0; i < V; ++i)  // each product and the sum rounded, as the plain version's
      x[i] = __fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(d0 + i < h ? -p[i] : p[i], sn[i]));
    store_f32<V>(out + row * D + d0, x);
  }
}

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32x2(a, b, T{});
}

constexpr int NS = kBK / 2;   // S's registers (64 queries x 128 keys)
constexpr int NK = kBK / 16;  // 16-key slices of a tile

// The first q tile whose rows see a key under the causal mask at a shift
// (q_off − k_off of a ring step; 0 for attention): row i sees key 0 iff i +
// shift >= 0. Tiles before it are not work items.
__host__ __device__ __forceinline__ int first_live_q_tile(int causal, int shift) {
  return causal && shift < 0 ? -shift / kBQ : 0;
}

// The core's work items are (128-query tile, q head, batch), item i at q
// tile i / (H·B) (counted from the last under causal masking, whose tiles
// see the most keys), head i % H, batch i / H % B; only the tiles from
// first_live_q_tile on. Block j of G takes items j, 2G − 1 − j, 2G + j,
// 4G − 1 − j, ...: the heaviest first, in a snake that evens out the
// blocks' sums of key tiles. An item walks the key tiles up to its last
// row's causal limit (executors/cudaex.py: ring_forward_plan, the same
// walk in Python).
struct Item {
  int q0, bh, bhk, n_kt;
};
__device__ __forceinline__ bool item_at(int k, int H, int Hkv, int B, int T_, int causal, int shift,
                                        Item& it) {
  const int G = gridDim.x, j = blockIdx.x;
  const int i = k * G + (k % 2 ? G - 1 - j : j);
  const int n_qt = (T_ + kBQ - 1) / kBQ;
  if (i >= (n_qt - first_live_q_tile(causal, shift)) * H * B) return false;
  const int qi = i / (H * B), h = i % H, b = i / H % B;
  const int qt = causal ? n_qt - 1 - qi : qi;
  it.q0 = qt * kBQ;
  it.bh = b * H + h;
  it.bhk = b * Hkv + h / (H / Hkv);
  it.n_kt = (T_ + kBK - 1) / kBK;
  if (causal)  // none past the (shifted) diagonal of the tile's last row
    it.n_kt = min(it.n_kt, (min(it.q0 + kBQ, T_) + shift + kBK - 1) / kBK);
  return true;
}

// kRing: o, m, l are the ring step's carried f32 accumulators (B, H, T,
// D) and (B, H, T), read at item start and written back unnormalized
// (o_out, lse unused); otherwise o_out (B, H, T, D) in T, and (kAttn) the
// natural-log lse. kPaged: tm_k and tm_v map the pools, pg holds the
// table and positions.
template <typename T, int DP, int MODE>
__device__ __forceinline__ void core_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v, T* __restrict__ o_out,
                                          float* __restrict__ lse, float* __restrict__ ring_o,
                                          float* __restrict__ ring_m, float* __restrict__ ring_l, int B,
                                          int H, int Hkv, int T_, int D, int causal, int shift,
                                          float scale_log2e, const Paged& pg) {
  using S = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  int* q_nkt = reinterpret_cast<int*>(smem + S::NKT);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
  Item it;

  if (threadIdx.x >= kConsumers) {  // the producer warp: its lane 0 issues every copy
    if constexpr (MODE == kPaged) {  // but the pages of a K/V tile, one a lane
      const int lane = threadIdx.x - kConsumers, table = pg.npm * pg.ps, ppt = kBK / pg.ps;
      int t = 0;
      for (int k = 0; item_at(k, H, Hkv, B, T_, 1, 0, it); ++k) {
        const int qb = k % 2, b = it.bh / H, hk = it.bhk - b * Hkv;
        int mx = -1;  // the item's largest position
        for (int j = lane; j < kBQ && it.q0 + j < T_; j += 32)
          mx = max(mx, pg.q_pos[static_cast<size_t>(b) * T_ + it.q0 + j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const int n_kt = mx < 0 ? 0 : (min(mx + 1, table) + kBK - 1) / kBK;
        if (lane == 0) {
          if (k >= 2) mbar_wait(&q_empty[qb], (k / 2 - 1) & 1);  // item k − 2 is done with it
          q_nkt[qb] = n_kt;  // seen by the consumers once q_full completes
          mbar_expect_tx(&q_full[qb], S::kQBytes);
          for (int a = 0; a < S::kBlocks; ++a)
            tma_load_3d(smem + S::Q + qb * S::kQBytes + a * kBQ * kRowBytes, &tm_q, &q_full[qb], 64 * a,
                        it.q0, it.bh);
        }
        const int* ptb = pg.page_table + static_cast<size_t>(b) * pg.npm;
        for (int n = 0; n < n_kt; ++n, ++t) {
          const int s = t % kStages;
          if (lane == 0) {
            if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);  // tile t − kStages is done
            mbar_expect_tx(&full[s], 2 * S::kKvBytes);
          }
          __syncwarp();
          if (lane < ppt) {  // page lane of the tile; past the table, the null page (masked)
            const int pi = n * ppt + lane;
            const int row = (pi < pg.npm ? ptb[pi] : 0) * pg.ps;
            for (int a = 0; a < S::kBlocks; ++a) {
              const int off = a * kBK * kRowBytes + lane * pg.ps * kRowBytes;
              tma_load_3d(smem + S::K + s * S::kKvBytes + off, &tm_k, &full[s], 64 * a, hk, row);
              tma_load_3d(smem + S::V + s * S::kKvBytes + off, &tm_v, &full[s], 64 * a, hk, row);
            }
          }
        }
      }
    } else if (threadIdx.x == kConsumers) {
      int t = 0;  // K/V tiles issued so far: tile t goes to stage t % kStages
      for (int k = 0; item_at(k, H, Hkv, B, T_, causal, shift, it); ++k) {
        const int qb = k % 2;
        if (k >= 2) mbar_wait(&q_empty[qb], (k / 2 - 1) & 1);  // item k − 2 is done with it
        mbar_expect_tx(&q_full[qb], S::kQBytes);
        for (int a = 0; a < S::kBlocks; ++a)
          tma_load_3d(smem + S::Q + qb * S::kQBytes + a * kBQ * kRowBytes, &tm_q, &q_full[qb], 64 * a,
                      it.q0, it.bh);
        for (int n = 0; n < it.n_kt; ++n, ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);  // tile t − kStages is done
          mbar_expect_tx(&full[s], 2 * S::kKvBytes);
          for (int a = 0; a < S::kBlocks; ++a) {
            tma_load_3d(smem + S::K + s * S::kKvBytes + a * kBK * kRowBytes, &tm_k, &full[s], 64 * a,
                        n * kBK, it.bhk);
            tma_load_3d(smem + S::V + s * S::kKvBytes + a * kBK * kRowBytes, &tm_v, &full[s], 64 * a,
                        n * kBK, it.bhk);
          }
        }
      }
    }
    return;
  }

  // warpgroup wg owns query rows q0 + 64·wg .. + 63 of an item; accumulator
  // element i of a 64 x N product sits at row 16·warp + gq + 8·((i>>1)&1) of
  // them, column 8·(i>>2) + 2c + (i&1)
  constexpr int NO = DP / 2;  // O's registers (64 x DP)
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, c = lane & 3;
  const uint32_t sQ = smem_u32(smem + S::Q), sK = smem_u32(smem + S::K);
  const uint32_t sV = smem_u32(smem + S::V);
  int t = 0;  // K/V tiles consumed so far
  for (int k = 0; item_at(k, H, Hkv, B, T_, causal, shift, it); ++k) {
    const int qb = k % 2;
    const int row0 = it.q0 + 64 * wg + 16 * warp + gq;  // this thread's first query row
    const uint32_t q_s = sQ + qb * S::kQBytes;
    const size_t base = static_cast<size_t>(it.bh) * T_;
    float acc[NO];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    int pos[2];  // paged: this thread's rows' positions, -1 past T
    if constexpr (MODE == kPaged) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        pos[r] = row < T_ ? pg.q_pos[static_cast<size_t>(it.bh / H) * T_ + row] : -1;
      }
    }
    if constexpr (MODE == kRing) {  // the carried state of this thread's rows; l in one share of the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool in = row < T_;
        if (in) m[r] = ring_m[base + row];
        if (in && c == 0) l[r] = ring_l[base + row];
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * c;
          const float2 x = in && col < D
                               ? *reinterpret_cast<const float2*>(ring_o + (base + row) * D + col)
                               : make_float2(0.f, 0.f);
          acc[4 * j + 2 * r] = x.x, acc[4 * j + 2 * r + 1] = x.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    }
    mbar_wait(&q_full[qb], (k / 2) & 1);
    int n_kt = it.n_kt;
    if constexpr (MODE == kPaged) {
      n_kt = q_nkt[qb];
      if (n_kt == 0) mbar_arrive(&q_empty[qb]);  // no key: done with its Q at once
    }

    for (int n = 0; n < n_kt; ++n, ++t) {
      const int s = t % kStages, k0 = n * kBK;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t k_s = sK + s * S::kKvBytes, v_s = sV + s * S::kKvBytes;

      // S = Q_wg·Kᵀ (64 queries x 128 keys), both operands K-major
      float sc[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qo = (kk / 4) * kBQ * kRowBytes + 64 * wg * kRowBytes + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * kBK * kRowBytes + (kk % 4) * 32;
        wgmma_ss<0, 0>(sc, desc_sw128(q_s + qo, 16, 1024), desc_sw128(k_s + ko, 16, 1024), kk, T{});
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (n == n_kt - 1) mbar_arrive(&q_empty[qb]);  // the item's last read of its Q

      if constexpr (MODE == kPaged) {  // each row at its position, and the table's end
        const int table = pg.npm * pg.ps;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
          if (key >= table || key > pos[(i >> 1) & 1]) sc[i] = kNegInf;
        }
      } else if (k0 + kBK > T_ || (causal && k0 + kBK - 1 > it.q0 + 64 * wg + shift)) {
        // the mask, on tiles that straddle the (shifted) diagonal and the
        // ragged last one only
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
          if (key >= T_ || (causal && key > row + shift)) sc[i] = kNegInf;
        }
      }
      // online softmax in log2 units: the rows' maxima over the four threads
      // that hold them, then p = 2^(s·scale·log2e − m)
      float mx[2] = {kNegInf, kNegInf}, corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2e);
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2e, -m[r]));
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // this thread's share of the row
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t pa[NK][4];  // P rounded to T: the A fragments of the 16-key slices
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_f32x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], T{});
      }

      // O += P·V (B = V, MN-major: 16 keys a slice)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        wgmma_rs<1>(acc, pa[kk], desc_sw128(v_s + kk * 16 * kRowBytes, kBK * kRowBytes, 1024), T{});
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);  // this thread is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= T_) continue;
      if constexpr (MODE == kRing) {  // unnormalized, in place
        float* o_row = ring_o + (base + row) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * c;
          if (col < D)
            *reinterpret_cast<float2*>(o_row + col) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
        if (c == 0) ring_m[base + row] = m[r], ring_l[base + row] = l[r];
        continue;
      }
      // a paged row with no live key: zeros (every score was masked)
      const bool zero = MODE == kPaged && pos[r] < 0;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      T* o_row = o_out + (base + row) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < D)
          store_pair(o_row + col, zero ? 0.f : acc[4 * j + 2 * r] / l_safe,
                     zero ? 0.f : acc[4 * j + 2 * r + 1] / l_safe);
      }
      if (MODE == kAttn && c == 0) lse[base + row] = (m[r] + log2f(l_safe)) * kLn2;
    }
  }
}

// The attention and ring entries' core, and paged chunk attention's (a
// kernel of its own name, so profiles tell the serving path's chunks from
// its prefill's attention).
template <typename T, int DP, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_core(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o_out,
                   float* __restrict__ lse, float* __restrict__ ring_o, float* __restrict__ ring_m,
                   float* __restrict__ ring_l, int B, int H, int Hkv, int T_, int D, int causal,
                   int shift, float scale_log2e) {
  core_body<T, DP, MODE>(tm_q, tm_k, tm_v, o_out, lse, ring_o, ring_m, ring_l, B, H, Hkv, T_, D, causal,
                         shift, scale_log2e, Paged{});
}
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    paged_chunk_core(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int B, int H,
                     int Hkv, int T_, int D, float scale_log2e, const Paged pg) {
  core_body<T, DP, kPaged>(tm_q, tm_k, tm_v, out, nullptr, nullptr, nullptr, nullptr, B, H, Hkv, T_, D, 1,
                           0, scale_log2e, pg);
}

// Threads a row of the prologue: 8 when 8 chunks of 16 bytes hold the row, else 16.
template <typename T> int threads_per_row(int D) { return D <= 8 * tt::Vec<T>::N ? 8 : 16; }

// One forward call's tensors. scratch: the roped q's rows then k's (RoPE
// only), scratch_rows of D elements, from the caller's plan. A ring step
// sets ring_o, ring_m, ring_l (its carried f32 accumulators, in place of o
// and lse) and shift = q_off − k_off.
struct Args {
  const void *q, *k, *v, *cos, *sin;
  void *o, *lse, *scratch;
  int scratch_rows, B, H, Hkv, T, D, causal;
  float scale_log2e;
  cudaStream_t stream;
  float *ring_o = nullptr, *ring_m = nullptr, *ring_l = nullptr;
  int shift = 0;
};

template <typename T>
int prologue(const Args& a) {
  const long long q_rows = static_cast<long long>(a.B) * a.H * a.T;
  const long long rows = q_rows + static_cast<long long>(a.B) * a.Hkv * a.T;
  const int tpr = threads_per_row<T>(a.D);
  auto kernel = tpr == 8 ? flash_fwd_prologue<T, 8> : flash_fwd_prologue<T, 16>;
  kernel<<<static_cast<int>((rows * tpr + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const float*>(a.cos),
      static_cast<const float*>(a.sin), static_cast<T*>(a.scratch), q_rows, rows, a.T, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int MODE = kAttn>
int core(const Args& a, const void* q, const void* k) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  int e = make_map_3d(&mq, q, type, a.D, a.T, a.B * a.H, kBQ);
  if (!e) e = make_map_3d(&mk, k, type, a.D, a.T, a.B * a.Hkv, kBK);
  if (!e) e = make_map_3d(&mv, a.v, type, a.D, a.T, a.B * a.Hkv, kBK);
  if (e) return e;
  auto kernel = flash_fwd_core<T, DP, MODE>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Smem<DP>::kBytes);
  int dev = 0, sms = 0;
  if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int live_qt = (a.T + kBQ - 1) / kBQ - first_live_q_tile(a.causal, a.shift);
  const long long items = live_qt > 0 ? static_cast<long long>(live_qt) * a.H * a.B : 0;
  if (items == 0) return 0;
  kernel<<<static_cast<int>(items < sms ? items : sms), kThreads, Smem<DP>::kBytes, a.stream>>>(
      mq, mk, mv, static_cast<T*>(a.o), static_cast<float*>(a.lse), a.ring_o, a.ring_m, a.ring_l,
      a.B, a.H, a.Hkv, a.T, a.D, a.causal, a.shift, a.scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_16bit(const Args& a) {
  const void *q = a.q, *k = a.k;
  if (a.cos != nullptr) {
    const int e = prologue<T>(a);
    if (e) return e;
    q = a.scratch;
    k = static_cast<const T*>(a.scratch) + static_cast<size_t>(a.B) * a.H * a.T * a.D;
  }
  return a.D <= 64 ? core<T, 64>(a, q, k) : core<T, 128>(a, q, k);
}

int forward(const Args& a, int dtype) {
  const int vec = dtype == tt::kF32 ? 4 : 8;
  if (a.D > 128 || a.D % 2 || a.D % vec || a.H % a.Hkv) return static_cast<int>(cudaErrorInvalidValue);
  // The caller's plan decides the scratch; the prologue would write, and the
  // core read, the roped rows of all of q and k: a shorter scratch is refused.
  if (dtype != tt::kF32 && a.cos != nullptr &&
      (a.scratch == nullptr ||
       a.scratch_rows < static_cast<long long>(a.B) * (a.H + a.Hkv) * a.T))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case tt::kF32:
      return tt_flash_fwd_f32(static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                              static_cast<const float*>(a.v), static_cast<const float*>(a.cos),
                              static_cast<const float*>(a.sin), static_cast<float*>(a.o),
                              static_cast<float*>(a.lse), a.B, a.H, a.Hkv, a.T, a.D, a.causal,
                              a.scale_log2e, a.stream);
    case tt::kBF16:
      return run_16bit<__nv_bfloat16>(a);
    case tt::kF16:
      return run_16bit<__half>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All tensors contiguous: q, o (B, H, T, D), k, v (B, Hkv, T, D) of one
// dtype; lse f32 (B, H, T); cos/sin f32 (T, D); D even, a multiple of the
// 16-byte vector and at most 128; H % Hkv == 0. Scratch, allocated by the
// caller (executors/cudaex.py: flash_forward_plan), for bf16/fp16 only: the
// roped q and k, (B·(H + Hkv), T, D) in q's dtype, scratch_rows rows of D
// (refused when fewer than B·(H + Hkv)·T). Launches the prologue and the core
// (f32: flash_rope_fwd.cu's kernel) on `stream`. Returns the first CUDA error.
extern "C" int tt_flash_rope_fwd(const void* q, const void* k, const void* v, const void* cos,
                                 const void* sin, void* o, void* lse, void* scratch,
                                 int scratch_rows, int B, int H, int Hkv, int T, int D, int causal,
                                 float scale_log2e, int dtype, void* stream) {
  const Args a{q, k, v, cos, sin, o, lse, scratch, scratch_rows, B, H, Hkv, T, D, causal,
               scale_log2e, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype);
}

// The same without RoPE: no cos/sin, no scratch, no prologue.
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                            int H, int Hkv, int T, int D, int causal, float scale_log2e, int dtype,
                            void* stream) {
  const Args a{q, k, v, nullptr, nullptr, o, lse, nullptr, 0, B, H, Hkv, T, D, causal,
               scale_log2e, static_cast<cudaStream_t>(stream)};
  return forward(a, dtype);
}

// One forward step of ring attention (context parallelism): replaces
// thunder_tpu/executors/pallasex.py:ring_flash_step (kernel body
// _ring_flash_step_kernel). The local queries q (B, H, T, D) fold one K/V
// shard k, v (B, Hkv, T, D) into the carried f32 accumulators o (B, H, T,
// D), m and l (B, H, T) IN PLACE with the online softmax: m and l in log2
// units (scores scaled by scale·log2 e), o unnormalized (the ring loop,
// parallel/context_parallel.py, divides by l after the last step). Query
// q_off + i sees key k_off + j iff k_off + j <= q_off + i (causal), every
// key otherwise. The ring must fold the diagonal shard first (see the
// header). bf16/fp16 run the core in ring mode; a shard wholly in the
// future launches nothing, so the accumulators stay bit-unchanged. f32
// runs ring_flash_fwd.cu's kernel. All tensors contiguous, q, k, v of one
// dtype; D even, a multiple of the 16-byte vector and at most 128; H % Hkv
// == 0. What bounds it (cp_train's diagonal step, B=1, H=16, T=8192, D=64,
// bf16): the causal products, 137 GFLOP, 0.139 ms at 989 TFLOP/s, against
// ~120 MB of q, k, v and the f32 o, m, l read and written (0.036 ms at
// 3.35 TB/s). Returns the first CUDA error.
extern "C" int tt_ring_flash_fwd(const void* q, const void* k, const void* v, void* o, void* m,
                                 void* l, int B, int H, int Hkv, int T, int D, int q_off,
                                 int k_off, int causal, float scale_log2e, int dtype,
                                 void* stream) {
  const int vec = dtype == tt::kF32 ? 4 : 8;
  if (D > 128 || D % 2 || D % vec || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *of = static_cast<float*>(o), *mf = static_cast<float*>(m), *lf = static_cast<float*>(l);
  if (dtype == tt::kF32)
    return tt_ring_flash_fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                                 static_cast<const float*>(v), of, mf, lf, B, H, Hkv, T, D, q_off,
                                 k_off, causal, scale_log2e, s);
  if (dtype != tt::kBF16 && dtype != tt::kF16) return static_cast<int>(cudaErrorInvalidValue);
  if (causal && q_off + T - 1 < k_off) return 0;  // wholly in the future: nothing to fold
  Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr, 0, B, H, Hkv, T, D, causal,
         scale_log2e, s};
  a.ring_o = of, a.ring_m = mf, a.ring_l = lf, a.shift = q_off - k_off;
  if (dtype == tt::kBF16)
    return D <= 64 ? core<__nv_bfloat16, 64, kRing>(a, q, k) : core<__nv_bfloat16, 128, kRing>(a, q, k);
  return D <= 64 ? core<__half, 64, kRing>(a, q, k) : core<__half, 128, kRing>(a, q, k);
}

// The chunk route of paged chunk attention (csrc/paged_chunk_attention.cu:
// tt_paged_chunk_attention with 128 rows a block), in bf16 and fp16: q (B,
// H, T, D) against the pools k_pages, v_pages (P, ps, Hkv, D) through
// page_table (B, npm), query (b, ·, t) seeing the key positions <= q_pos[b,
// t] -> out (B, H, T, D); a query with no live key gives zeros. The core in
// paged mode, one item per (128 queries, q head, sequence). D a multiple of
// 8 and at most 128; ps a multiple of 8 dividing 128 (a page's box lands
// on whole 8-row swizzle atoms, a key tile holds whole pages). Returns the
// first CUDA error.
namespace {

template <typename T, int DP>
int paged_core(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out, int blocks,
               int B, int H, int Hkv, int T_, int D, float scale_log2e, const Paged& pg,
               cudaStream_t stream) {
  auto kernel = paged_chunk_core<T, DP>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Smem<DP>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, Smem<DP>::kBytes, stream>>>(mq, mk, mv, static_cast<T*>(out), B, H, Hkv, T_, D,
                                                         scale_log2e, pg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tt_paged_chunk_fwd(const void* q, const void* k_pages, const void* v_pages,
                                  const int* page_table, const int* q_pos, void* out, int B, int H,
                                  int Hkv, int T, int D, int P, int ps, int npm, float scale_log2e,
                                  int dtype, cudaStream_t stream) {
  if (D > 128 || D % 8 || H % Hkv || ps % 8 || kBK % ps || (dtype != tt::kBF16 && dtype != tt::kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType type =
      dtype == tt::kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;  // the pools as (P·ps, Hkv, D): one page of one kv head a box
  int e = make_map_3d(&mq, q, type, D, T, B * H, kBQ);
  if (!e) e = make_map_3d(&mk, k_pages, type, D, Hkv, P * ps, 1, ps);
  if (!e) e = make_map_3d(&mv, v_pages, type, D, Hkv, P * ps, 1, ps);
  if (e) return e;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const long long items = static_cast<long long>((T + kBQ - 1) / kBQ) * H * B;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  const Paged pg{page_table, q_pos, ps, npm};
  if (dtype == tt::kBF16)
    return D <= 64 ? paged_core<__nv_bfloat16, 64>(mq, mk, mv, out, blocks, B, H, Hkv, T, D, scale_log2e, pg, stream)
                   : paged_core<__nv_bfloat16, 128>(mq, mk, mv, out, blocks, B, H, Hkv, T, D, scale_log2e, pg, stream);
  return D <= 64 ? paged_core<__half, 64>(mq, mk, mv, out, blocks, B, H, Hkv, T, D, scale_log2e, pg, stream)
                 : paged_core<__half, 128>(mq, mk, mv, out, blocks, B, H, Hkv, T, D, scale_log2e, pg, stream);
}
