// The AdamW update in one pass over every parameter (sm_90a).
//
// Replaces no TPU kernel: thunder_tpu/optim.py:83 (AdamW.update) runs inside
// the train step's one jax.jit program, where XLA fuses it. The port's
// counterpart, optim.AdamW.update, issued ~12 torch._foreach_* passes over
// the f32 state (executors/cudaex.py:adamw_plain keeps that chain); this
// kernel computes the same function in one.
//
// Per element, in the chain's order and with its roundings (each step one
// IEEE f32 operation; the chain's add-with-alpha and addcmul are fused
// multiply-adds, as torch computes them, and nothing else contracts):
//   m = fma(1-b1, g, m*b1)
//   v = fma((1-b2)*g, g, v*b2)
//   upd = (m / bc1) / (sqrt(v / bc2) + eps)
//   p32 = p32 - p32*(lr*wd)            (when weight decay is on)
//   p32 = fma(-lr, upd, p32)
//   p = p32 cast to p's dtype (round to nearest even)
// g (f32, bf16 or f16) is widened in registers; m and v are f32; p is f32,
// bf16 or f16. NVCC_FLAGS has no fast-math, and the intrinsics fix each
// rounding.
//
// What bounds it: bytes. Each parameter reads p, g, m, v and writes p, m, v:
// 2*p_itemsize + g_itemsize + 16 bytes, against ~15 flops.
//
// The step's bias corrections come from a device int32 (optim.AdamW keeps
// its step on the card and increments it before the launch), so a training
// step captured in a CUDA graph replays with each step's corrections.
//
// What the design does about that: every byte moves once, in one launch. A
// device table (cudaex.adamw_tables: built once per set of tensors and
// cached, since the update works in place) lists each tensor's pointers,
// numel and dtypes, and a chunk table cuts the tensors into 64K-element
// chunks, one block each. A block moves 8 elements a thread a step as 16-byte
// vectors where its chunk's four pointers are 16-byte aligned, and
// element by element otherwise and for the tail.

#include "common.cuh"

namespace {

constexpr int kChunkLog2 = 16;  // cudaex._ADAMW_CHUNK
constexpr int kThreads = 256;

struct Hyper {
  float b1, a1, b2, a2, eps, lr_wd, neg_lr;
  int decay;
};

// The bias corrections of the step being taken, read on the card (so a
// captured CUDA graph replays each step's own), in f32 as thunder_tpu's
// update takes them: 1 - b^t with t the step as an f32.
struct Corrections {
  float bc1, bc2;
};

// One entry of the tensor table: pointers, numel, dtypes (p | g << 4).
struct Entry {
  long long p, g, m, v, numel, dtypes;
};

template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&out)[8]) {
  constexpr int kVecs = 8 * sizeof(T) / 16;
  uint4 raw[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) raw[i] = reinterpret_cast<const uint4*>(src)[i];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = tt::to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&in)[8]) {
  constexpr int kVecs = 8 * sizeof(T) / 16;
  uint4 raw[kVecs];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = tt::from_f32<T>(in[j]);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) reinterpret_cast<uint4*>(dst)[i] = raw[i];
}

// The element's update: p, m and v in place.
__device__ __forceinline__ void step(float& p, float g, float& m, float& v, const Hyper& h,
                                     const Corrections& c) {
  m = __fmaf_rn(h.a1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(__fmul_rn(h.a2, g), g, __fmul_rn(v, h.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), h.eps);
  const float upd = __fdiv_rn(__fdiv_rn(m, c.bc1), den);
  if (h.decay) p = __fsub_rn(p, __fmul_rn(p, h.lr_wd));
  p = __fmaf_rn(h.neg_lr, upd, p);
}

template <typename PT, typename GT>
__device__ __forceinline__ void update_chunk(PT* p, const GT* g, float* m, float* v, int n, const Hyper& h,
                                             const Corrections& c) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int n8 = aligned ? n / 8 : 0;
  for (int i = threadIdx.x; i < n8; i += kThreads) {
    float pf[8], gf[8], mf[8], vf[8];
    load8(g + 8 * i, gf);
    load8(m + 8 * i, mf);
    load8(v + 8 * i, vf);
    load8(p + 8 * i, pf);
#pragma unroll
    for (int j = 0; j < 8; ++j) step(pf[j], gf[j], mf[j], vf[j], h, c);
    store8(m + 8 * i, mf);
    store8(v + 8 * i, vf);
    store8(p + 8 * i, pf);
  }
  for (int i = 8 * n8 + threadIdx.x; i < n; i += kThreads) {
    float pf = tt::to_f32(p[i]), mf = m[i], vf = v[i];
    step(pf, tt::to_f32(g[i]), mf, vf, h, c);
    m[i] = mf;
    v[i] = vf;
    p[i] = tt::from_f32<PT>(pf);
  }
}

template <typename PT>
__device__ __forceinline__ void update_chunk_p(const Entry& e, long long start, int n, int gdt, const Hyper& h,
                                               const Corrections& c) {
  PT* p = reinterpret_cast<PT*>(e.p) + start;
  float* m = reinterpret_cast<float*>(e.m) + start;
  float* v = reinterpret_cast<float*>(e.v) + start;
  switch (gdt) {
    case tt::kF32: update_chunk(p, reinterpret_cast<const float*>(e.g) + start, m, v, n, h, c); break;
    case tt::kBF16: update_chunk(p, reinterpret_cast<const __nv_bfloat16*>(e.g) + start, m, v, n, h, c); break;
    default: update_chunk(p, reinterpret_cast<const __half*>(e.g) + start, m, v, n, h, c); break;
  }
}

// Block b updates chunk chunks[b] = (tensor index << 32) | chunk index.
__global__ void __launch_bounds__(kThreads) adamw_kernel(const Entry* __restrict__ tensors,
                                                         const long long* __restrict__ chunks,
                                                         const int* __restrict__ step_t, Hyper h) {
  const float t = static_cast<float>(*step_t);
  const Corrections corr{__fsub_rn(1.0f, powf(h.b1, t)), __fsub_rn(1.0f, powf(h.b2, t))};
  const long long c = chunks[blockIdx.x];
  const Entry e = tensors[c >> 32];
  const long long start = (c & 0xffffffffLL) << kChunkLog2;
  const long long left = e.numel - start;
  const int n = left < (1LL << kChunkLog2) ? static_cast<int>(left) : (1 << kChunkLog2);
  const int pdt = static_cast<int>(e.dtypes & 15), gdt = static_cast<int>(e.dtypes >> 4);
  switch (pdt) {
    case tt::kF32: update_chunk_p<float>(e, start, n, gdt, h, corr); break;
    case tt::kBF16: update_chunk_p<__nv_bfloat16>(e, start, n, gdt, h, corr); break;
    default: update_chunk_p<__half>(e, start, n, gdt, h, corr); break;
  }
}

}  // namespace

// tensors: device table of n_tensors Entry rows (6 int64 each); chunks:
// device table of n_chunks int64 (tensor index << 32 | 64K-element chunk
// index), both from cudaex.adamw_tables; step: the device int32 of the step
// being taken (1 first), whose bias corrections each block computes. The
// hyper-parameters as the chain takes them: b1, 1-b1, b2, 1-b2, eps, lr*wd
// and -lr, each rounded to f32; decay 0 skips the weight decay. Returns the
// launch's cudaGetLastError().
extern "C" int tt_adamw(const void* tensors, const void* chunks, int n_chunks, const void* step, float b1,
                        float a1, float b2, float a2, float eps, float lr_wd, float neg_lr, int decay,
                        void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, a1, b2, a2, eps, lr_wd, neg_lr, decay};
  adamw_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(tensors), static_cast<const long long*>(chunks), static_cast<const int*>(step),
      h);
  return static_cast<int>(cudaGetLastError());
}
