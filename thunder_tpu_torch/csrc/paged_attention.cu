// Paged-attention decode for Hopper (sm_90a), split across each sequence's
// pages (flash-decoding).
//
// Replaces thunder_tpu/executors/pallasex.py:paged_attention_decode (kernel
// body _paged_attn_kernel): one new query per sequence attends its KV pages
// through the page table, with an online softmax over pages and GQA.
//   q (B, H, D); k_pages, v_pages (P, page_size, Hkv, D); page_table (B, npm)
//   int32; seq_lens (B,) int32, counting the current token; out (B, H, D).
//
// What bounds it: the bytes of the live K/V. Each sequence's first seq_len
// slots are read once per kv head, 2 * D values a slot; the q·k and p·v work
// is 4 * g flops a value, about 8 flops a byte in bf16, far below the
// tensor cores' line (~295). At chip_smoke.py's ragged decode set (B=8,
// 5,683 live tokens, Hkv=8, D=64, bf16) that is 11.6 MB, 3.49 us at 3.35
// TB/s. So the design only has to read those bytes at the card's rate: keep
// enough independent loads in flight on every SM.
//
// The design:
//   1. Split kernel, grid (B, Hkv, n_split): block (b, hk, s) owns the
//      sequence's tokens [s·split, (s+1)·split) for kv head hk, where split
//      = pages_per_split · page_size (executors/cudaex.py:
//      paged_attention_plan; 128 tokens where the page allows). n_split =
//      ceil(npm / pages_per_split) comes from the table's width, never from
//      seq_lens, so the launch needs no host read and is safe to capture in
//      a CUDA graph; a block whose range starts at or past seq_len exits at
//      once. 128 tokens a split spreads a 1,024-token sequence over 8
//      blocks a kv head: 512 blocks at B=8 x Hkv=8, about four 128-thread
//      blocks resident on each of the 132 SMs, where one block per
//      (sequence, kv head) gave 64.
//      A token is read by a group of LPT lanes (the power of two at or above
//      D/V), each lane one 16-byte vector of its K row and of its V row: at
//      D=64 bf16 a warp reads 4 tokens, the block 16 (a chunk), with every
//      load 16 bytes and neighbouring lanes on neighbouring addresses. The
//      block reads its split's page ids and the g query rows beside
//      seq_len, so one dependent read stands before the K/V loads; then
//      each thread streams its own vectors through kStages cp.async slots
//      in shared memory, every load of a 128-token split in flight at D=64
//      in 16-bit types, with no block barrier in the loop. The g query rows
//      live in registers (pre-scaled by scale·log2e). A step folds U chunks:
//      their U x g scores are independent dot products over the lane's
//      vector, summed across the group by shuffles, then one max, one
//      correction and U exponentials a row update the group's own online
//      softmax (running max m, sum l, unnormalised o over its lane's
//      columns) in f32, from the finite kNegInf start, so an empty group
//      merges as nothing. The groups merge by shuffles within a warp and
//      through shared memory across warps. The probabilities stay f32 for
//      the p·v product (the TPU kernel rounds them to the pool dtype
//      first). Registers are capped so that four blocks fit an SM: 512
//      live blocks at B=8 x Hkv=8 x 1,024 tokens run in one wave.
//   2. The block writes its unnormalised (o, m, l) in f32 to the partials
//      (B, H, n_split, D + 2); a sequence that fits one split has its o
//      written, normalised, by block 0, and a sequence with seq_len 0 its
//      zeros.
//   3. Combine kernel, one warp per (b, h), launched whenever n_split > 1:
//      it reads only the live splits' partials of sequences longer than one
//      split (every split's m and l read beside seq_len, lane s the weight
//      of split s, eight splits' values loaded before any is added),
//      rescales them to the common max and writes o = Σ o_s·w_s /
//      Σ l_s·w_s in q's dtype, guarding l == 0. With n_split == 1 (a table
//      of at most one split) the split kernel writes every row itself.
//
// What holds it back: latency, not bytes. At chip_smoke.py's sets (H100
// 80GB HBM3, 700 W) the two launches take 0.015-0.017 ms, 9-31 % of the
// bytes bound; with one 2,048-token sequence beside seven of length 1 the
// split kernel's 128 busy blocks read 4.2 MB in ~0.010 ms. Each block waits
// on a chain of dependent reads (seq_len with its page ids and q, then K/V,
// then its partials' write, then the combine's reads). Not done yet: the
// combine is a second launch, which a last-block-done counter could fold
// into the split kernel.

#include "flash_common.cuh"  // cp.async; includes common.cuh

namespace {

// finite, as the TPU kernel's NEG_INF: a masked slot's exp2 is 0, never NaN
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// cp.async slots per thread for each of K and V: at D=64 in 16-bit types a
// 128-token split is 8 chunks, so every load of the block is in flight at
// once
constexpr int kStages = 8;

// Chunks folded a step: 4, or 2 for 8-row query groups (registers); and the
// blocks an SM the registers must allow: four keeps the 512 live blocks of
// B=8 x Hkv=8 x 1,024 tokens in one wave on 132 SMs.
template <int GP> struct Fold {
  static constexpr int U = GP <= 4 ? 4 : 2;
  static constexpr int kMinBlocks = GP <= 4 ? 4 : 2;
};

// Shared memory of one split block, in bytes: kStages slots of 16 bytes per
// thread for K and for V, the per-warp (m, l, o) of GP rows, then the
// split's page ids. executors/cudaex.py:_paged_smem_bytes is the same
// formula, for the checker.
size_t split_smem_bytes(int GP, int D, int pages_per_split) {
  return static_cast<size_t>(kStages) * 2 * kThreads * 16 +
         sizeof(float) * kWarps * static_cast<size_t>(GP) * (D + 2) +
         sizeof(int) * static_cast<size_t>(pages_per_split);
}

// Folds the (m2, l2, o2) of another group into (m, l, o).
template <int V>
__device__ __forceinline__ void merge(float& m, float& l, float (&o)[V], float m2, float l2,
                                      const float (&o2)[V]) {
  const float mx = fmaxf(m, m2);
  const float a = exp2f(m - mx), c = exp2f(m2 - mx);
  l = l * a + l2 * c;
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = o[j] * a + o2[j] * c;
  m = mx;
}

template <typename T, int GP>
__global__ void __launch_bounds__(kThreads, Fold<GP>::kMinBlocks)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       float* __restrict__ part, int Hkv, int g, int D, int ps, int npm,
                       int split, int n_split, float scale_log2e) {
  constexpr int V = tt::Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* k_slot = reinterpret_cast<uint4*>(smem);          // kStages x kThreads
  uint4* v_slot = k_slot + kStages * kThreads;             // kStages x kThreads
  float* red_m = reinterpret_cast<float*>(v_slot + kStages * kThreads);  // kWarps x GP
  float* red_l = red_m + kWarps * GP;                                     // kWarps x GP
  float* red_o = red_l + kWarps * GP;                                     // kWarps x GP x D
  int* pages = reinterpret_cast<int*>(red_o + kWarps * GP * D);           // split / ps

  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * g;
  const int start = s * split;
  const size_t row0 = static_cast<size_t>(b) * H + static_cast<size_t>(hk) * g;
  // lanes per token: the power of two at or above D / V; lanes past D / V idle
  const int nvec = D / V;
  int lpt = 1;
  while (lpt < nvec) lpt <<= 1;
  const int tpw = 32 / lpt, per_chunk = kWarps * tpw;
  const int grp = lane / lpt, sub = lane % lpt;
  const bool active = sub < nvec;

  // the split's page ids and this lane's vector of the g query rows, read
  // beside seq_len, not after it: one dependent read stands before the K/V
  // loads
  const int pps = split / ps, page0 = s * pps;  // pps <= kThreads: split <= 128 tokens
  const bool page_reader = tid < pps && page0 + tid < npm;
  const int my_page = page_reader ? page_table[static_cast<size_t>(b) * npm + page0 + tid] : 0;
  uint4 qraw[GP];
#pragma unroll
  for (int r = 0; r < GP; ++r)
    qraw[r] = r < g && active ? reinterpret_cast<const uint4*>(q + (row0 + r) * D)[sub]
                              : make_uint4(0, 0, 0, 0);
  const int seq_len = min(seq_lens[b], npm * ps);
  if (page_reader) pages[tid] = my_page;
  if (start >= seq_len) {
    if (s == 0) {  // no live slot: zeros (the l == 0 guard)
      for (int i = tid; i < g * D; i += kThreads) out[row0 * D + i] = tt::from_f32<T>(0.f);
    }
    return;
  }
  const int end = min(start + split, seq_len);
  const int n_live = (seq_len + split - 1) / split;

  float qf[GP][V], o[GP][V], m[GP], l[GP];
#pragma unroll
  for (int r = 0; r < GP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    const T* e = reinterpret_cast<const T*>(&qraw[r]);
#pragma unroll
    for (int j = 0; j < V; ++j) qf[r][j] = tt::to_f32(e[j]) * scale_log2e, o[r][j] = 0.f;
  }

  const size_t slot_stride = static_cast<size_t>(Hkv) * D;
  __syncthreads();  // the page ids
  const int n_chunks = (end - start + per_chunk - 1) / per_chunk;
  auto token = [&](int c) { return start + c * per_chunk + warp * tpw + grp; };
  // the K and V vectors of chunk c's token into slot c % kStages; one
  // commit group per chunk, empty past the end
  auto issue = [&](int c) {
    const int t = token(c);
    if (t < end && active) {
      const size_t page = static_cast<size_t>(pages[(t - start) / ps]);
      const size_t off = (page * ps + t % ps) * slot_stride + static_cast<size_t>(hk) * D + sub * V;
      tt::flash::cp_async16(k_slot + (c % kStages) * kThreads + tid, k_pages + off, true);
      tt::flash::cp_async16(v_slot + (c % kStages) * kThreads + tid, v_pages + off, true);
    }
    tt::flash::cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages; ++c) issue(c);

  // U chunks a step: their U scores a row are independent, so their dot
  // products and shuffles overlap, and one max, one correction and U
  // exponentials fold them in
  constexpr int U = Fold<GP>::U;
  for (int c0 = 0; c0 < n_chunks; c0 += U) {
    tt::flash::cp_async_wait<kStages - U>();  // chunks c0 .. c0 + U - 1 have landed
    uint4 kr[U], vr[U];  // as stored: each element is converted once, where it is used
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      valid[u] = token(c0 + u) < end;
      const bool ok = valid[u] && active;
      kr[u] = ok ? k_slot[((c0 + u) % kStages) * kThreads + tid] : make_uint4(0, 0, 0, 0);
      vr[u] = ok ? v_slot[((c0 + u) % kStages) * kThreads + tid] : make_uint4(0, 0, 0, 0);
    }
    float sc[U][GP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* ke = reinterpret_cast<const T*>(&kr[u]);
#pragma unroll
      for (int r = 0; r < GP; ++r) sc[u][r] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float kj = tt::to_f32(ke[j]);
#pragma unroll
        for (int r = 0; r < GP; ++r) sc[u][r] = fmaf(qf[r][j], kj, sc[u][r]);
      }
    }
    for (int off = lpt >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < GP; ++r) sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
      }
    }
    // sc becomes the probabilities; o and l take the correction
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = valid[u] ? fmaxf(mx, sc[u][r]) : mx;
      const float corr = exp2f(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][r] = valid[u] ? exp2f(sc[u][r] - mx) : 0.f;
        psum += sc[u][r];
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int j = 0; j < V; ++j) o[r][j] *= corr;
      m[r] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float vj = tt::to_f32(ve[j]);
#pragma unroll
        for (int r = 0; r < GP; ++r) o[r][j] = fmaf(sc[u][r], vj, o[r][j]);
      }
    }
    // refill the slots just read (their values are consumed above)
    asm volatile("" ::: "memory");
#pragma unroll
    for (int u = 0; u < U; ++u) issue(c0 + kStages + u);
  }
  tt::flash::cp_async_wait<0>();

  // the warp's groups into group 0 (lanes 0 .. lpt-1), then across warps
  for (int off = lpt; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      float o2[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o2[j] = __shfl_xor_sync(0xffffffffu, o[r][j], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      merge<V>(m[r], l[r], o[r], m2, l2, o2);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      if (sub == 0) red_m[warp * GP + r] = m[r], red_l[warp * GP + r] = l[r];
      if (active) {
#pragma unroll
        for (int j = 0; j < V; ++j) red_o[(warp * GP + r) * D + sub * V + j] = o[r][j];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < g * (D + 2); i += kThreads) {
    const int r = i / (D + 2), d = i % (D + 2);
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GP + r]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(red_m[w * GP + r] - mx);
      lsum += red_l[w * GP + r] * c;
      if (d < D) acc += red_o[(w * GP + r) * D + d] * c;
    }
    if (n_live == 1) {
      if (d < D) out[(row0 + r) * D + d] = tt::from_f32<T>(acc / (lsum == 0.f ? 1.f : lsum));
    } else {
      float* pr = part + ((row0 + r) * n_split + s) * static_cast<size_t>(D + 2);
      pr[d] = d < D ? acc : (d == D ? mx : lsum);
    }
  }
}

// One warp per (b, h): the live splits' partials of a sequence longer than
// one split, rescaled to their common max, into o. Lane s holds split s's
// max and weight; each lane owns columns lane, lane + 32, ... (D <= 32 ·
// kCols) and loads eight splits' values of all of them before it adds any.
constexpr int kMaxSplitLanes = 4;  // n_split <= 128: the plan's 128-token splits of 16k tokens
constexpr int kCols = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ seq_lens,
                         T* __restrict__ out, int B, int H, int D, int ps, int npm, int split,
                         int n_split) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * H) return;
  const float* pr = part + static_cast<size_t>(row) * n_split * (D + 2);
  // every split's m and l are read beside seq_len and the dead ones dropped
  // after it (their values were never written): one dependent read less
  float mj[kMaxSplitLanes], lj[kMaxSplitLanes], w[kMaxSplitLanes];
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    const int s = lane + 32 * j;
    mj[j] = s < n_split ? pr[s * (D + 2) + D] : kNegInf;
    lj[j] = s < n_split ? pr[s * (D + 2) + D + 1] : 0.f;
  }
  const int seq_len = min(seq_lens[row / H], npm * ps);
  const int n_live = seq_len <= 0 ? 0 : (seq_len + split - 1) / split;
  if (n_live <= 1) return;  // written by the split kernel
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    const int s = lane + 32 * j;
    mj[j] = s < n_live ? mj[j] : kNegInf;
    lj[j] = s < n_live ? lj[j] : 0.f;
    mx = fmaxf(mx, mj[j]);
  }
  mx = tt::warp_max(mx);
  float lsum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplitLanes; ++j) {
    w[j] = exp2f(mj[j] - mx);  // 0 past n_live
    lsum += lj[j] * w[j];
  }
  lsum = tt::warp_sum(lsum);
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += 8) {
    float x[8][kCols];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int s = s0 + u, d = lane + 32 * c;
        x[u][c] = s < n_live && d < D ? pr[s * (D + 2) + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = s0 + u;
      float ws = w[0];
#pragma unroll
      for (int j = 1; j < kMaxSplitLanes; ++j) ws = (s >> 5) == j ? w[j] : ws;
      ws = __shfl_sync(0xffffffffu, ws, s & 31);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(x[u][c], ws, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[static_cast<size_t>(row) * D + d] = tt::from_f32<T>(acc[c] * inv);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int *pt, *sl;
  void* out;
  float* part;
  int B, Hkv, g, D, ps, npm, pages_per_split;
  float scale_log2e;
  cudaStream_t stream;
};

template <typename T, int GP>
int launch_split(const Args& a, int split, int n_split) {
  const size_t smem = split_smem_bytes(GP, a.D, a.pages_per_split);
  auto kernel = paged_split_kernel<T, GP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(a.B, a.Hkv, n_split), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp), static_cast<const T*>(a.vp), a.pt,
      a.sl, static_cast<T*>(a.out), a.part, a.Hkv, a.g, a.D, a.ps, a.npm, split, n_split,
      a.scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const Args& a) {
  const int split = a.pages_per_split * a.ps;
  const int n_split = (a.npm + a.pages_per_split - 1) / a.pages_per_split;
  if (n_split > 1 && a.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int e;
  if (a.g <= 1) e = launch_split<T, 1>(a, split, n_split);
  else if (a.g <= 2) e = launch_split<T, 2>(a, split, n_split);
  else if (a.g <= 4) e = launch_split<T, 4>(a, split, n_split);
  else e = launch_split<T, 8>(a, split, n_split);
  if (e || n_split == 1) return e;
  const int rows = a.B * a.Hkv * a.g;
  paged_combine_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, a.stream>>>(
      a.part, a.sl, static_cast<T*>(a.out), a.B, a.Hkv * a.g, a.D, a.ps, a.npm, split, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous and 16-byte aligned; q, pools and out of one dtype;
// D a multiple of the 16-byte vector, at most 32 vectors; 1 <= g <= 8; page
// ids in [0, P). partials: f32 (B, H, n_split, D + 2) with n_split =
// ceil(npm / pages_per_split), from the caller's plan
// (executors/cudaex.py:paged_attention_plan); null when n_split is 1
// (refused otherwise). Launches the split kernel, then (n_split > 1) the
// combine, on `stream`. Returns the first CUDA error.
extern "C" int tt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* page_table, const void* seq_lens, void* out,
                                  void* partials, int B, int Hkv, int g, int D, int ps, int npm,
                                  int pages_per_split, float scale_log2e, int dtype,
                                  void* stream) {
  const int vec = dtype == tt::kF32 ? 4 : 8;
  if (g < 1 || g > 8 || D % vec || D / vec > 32 || pages_per_split < 1 ||
      pages_per_split > kThreads ||
      (npm + pages_per_split - 1) / pages_per_split > 32 * kMaxSplitLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(seq_lens), out, static_cast<float*>(partials),
               B, Hkv, g, D, ps, npm, pages_per_split, scale_log2e,
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
