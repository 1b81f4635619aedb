// Hopper (sm_90a) building blocks for kernels fed by the Tensor Memory
// Accelerator (TMA) and computed with warpgroup products (wgmma): mbarriers,
// TMA and bulk copies, named barriers, register reallocation (setmaxnreg),
// shared-memory matrix descriptors for 128-byte-swizzled tiles, the m64nNk16
// 16-bit products with f32 accumulation the flash kernels use
// (csrc/flash_{fwd,bwd}_sm90.cu) and the m64n128k32 e4m3 product of the fp8
// linear (csrc/fp8_linear.cu).
//
// Tiles live in shared memory as TMA's 128-byte swizzle writes them: rows of
// 64 16-bit elements (128 bytes; 128 8-bit elements), 8-row groups of 1024
// bytes, chunk c of row r stored at chunk c ^ (r % 8). Every tile starts on a
// 1024-byte boundary. A tile wider than 128 bytes is stored as 128-byte-wide
// column blocks one after the other. Such a tile serves a product as:
//   - a K-major operand (K contiguous, as q·kᵀ reads q and k): 8-row groups
//     1024 bytes apart (SBO); the k-th 32-byte slice (16 16-bit elements, 32
//     8-bit ones) starts 32·k bytes into its column block;
//   - an MN-major operand (M or N contiguous, as p·v reads v): 8-row groups
//     along K 1024 bytes apart (SBO), 64-wide column blocks along M or N
//     `block_bytes` apart (LBO); the k-th 16-row slice starts 2048·k bytes in.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrives once and adds `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of parity `parity`. A
// phase that never completes (a fault in the kernel) traps after 2^26 polls
// (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// ---- copies ----

// Box (c0, c1, c2) of a 3-d tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Adds a box of a 3-d f32 tensor map from shared memory into global memory,
// element by element, in the L2 (out-of-range elements are skipped);
// tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Copies a box of a 3-d tensor map from shared memory into global memory
// (out-of-range elements are not written); tracked by this thread's bulk
// groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups are still reading shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are pending.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory stores before later reads by wgmma or
// the bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


// 2^x by the special-function unit (denormal results flush to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- register reallocation between warpgroups ----

// Every thread of the warpgroup runs these together: dec gives registers
// back to the block's pool, inc takes them (a multiple of 8, 24 to 256).
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- warpgroup products ----

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register accesses across an asynchronous product.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`; LBO
// and SBO in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi, __nv_bfloat16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi, __half) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator operands of an m64n16k16 product: d[0..7].
#define TT_WGMMA_D8_REGS "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define TT_WGMMA_D8_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
// The accumulator operands of an m64n64k16 product: d[0..31].
#define TT_WGMMA_D32_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define TT_WGMMA_D32_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// The accumulator operands of an m64n128k16 product: d[0..63].
#define TT_WGMMA_D64_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define TT_WGMMA_D64_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])


// wgmma_ss: d (64 x N, f32; N = 64 or 128) = or += A (64 x 16, shared) ·
// B (16 x N, shared), TA / TB 1 for an MN-major operand; scale_d 0
// overwrites d.
// wgmma_rs: d (64 x N) += A (64 x 16, registers, the m16n8k16 A fragment of
// each warp's 16 rows) · B (16 x N, shared), TB 1 for an MN-major B; with a
// scale_d argument (N = 16, 64 or 128), scale_d 0 overwrites d.
// The element type is picked by the last argument's type.
#define TT_WGMMA_OPS(TYPE, PTX)                                                              \
  template <int TA, int TB>                                                                  \
  __device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,           \
                                           int scale_d, TYPE) {                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "             \
                 TT_WGMMA_D32_REGS ", %32, %33, p, 1, 1, %35, %36;\n}\n"                    \
                 : TT_WGMMA_D32_OUTS                                                         \
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));                          \
  }                                                                                          \
  template <int TA, int TB>                                                                  \
  __device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,           \
                                           int scale_d, TYPE) {                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "            \
                 TT_WGMMA_D64_REGS ", %64, %65, p, 1, 1, %67, %68;\n}\n"                    \
                 : TT_WGMMA_D64_OUTS                                                         \
                 : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));                          \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],           \
                                           uint64_t b, TYPE) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "             \
                 TT_WGMMA_D32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"        \
                 : TT_WGMMA_D32_OUTS                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));      \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],           \
                                           uint64_t b, TYPE) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "            \
                 TT_WGMMA_D64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"        \
                 : TT_WGMMA_D64_OUTS                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));      \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],            \
                                           uint64_t b, int scale_d, TYPE) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." PTX "." PTX " "             \
                 TT_WGMMA_D8_REGS ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"          \
                 : TT_WGMMA_D8_OUTS                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],           \
                                           uint64_t b, int scale_d, TYPE) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "             \
                 TT_WGMMA_D32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"        \
                 : TT_WGMMA_D32_OUTS                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],           \
                                           uint64_t b, int scale_d, TYPE) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "            \
                 TT_WGMMA_D64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"        \
                 : TT_WGMMA_D64_OUTS                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB)); \
  }

TT_WGMMA_OPS(__nv_bfloat16, "bf16")
TT_WGMMA_OPS(__half, "f16")

// d (64 x 128, f32) = or += A (64 x 32 e4m3, shared) · B (32 x 128 e4m3,
// shared), both K-major (the only layout wgmma takes for 8-bit types);
// scale_d 0 overwrites d. Hopper's fp8 products keep fewer bits in their
// sums than f32, so a caller that wants f32 sums issues each k32 with
// scale_d 0 and adds d into its own accumulators.
__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
               TT_WGMMA_D64_REGS ", %64, %65, p, 1, 1;\n}\n"
               : TT_WGMMA_D64_OUTS
               : "l"(a), "l"(b), "r"(scale_d));
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the CUDA runtime
// so this library does not link libcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (n, rows, cols) row-major tensor of `type` (1, 2 or 4 bytes an element:
// UINT8 for e4m3 codes), moved in boxes of `box_rows` rows by 128 bytes of
// columns with the 128-byte swizzle (and box_n of n: a box of one row of
// box_n matrices lands as box_n rows). Out-of-range rows and columns read as
// zero and are not written. Row pitches must be multiples of 16 bytes.
// Returns a CUDA error code (0 on success).
inline int make_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int cols,
                       int rows, int n, int box_rows, int box_n = 1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                          : type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {cols * size, cols * size * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / size), static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_n)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A (rows, cols) row-major tensor of `type` moved in unswizzled boxes of
// box_rows rows by box_cols columns (box_cols · element bytes a multiple of
// 16), as a 3-d map of n = 1 for tma_load_3d: a box lands as box_rows rows
// of box_cols elements, one after the other. Out-of-range rows and columns
// read as zero. Returns a CUDA error code (0 on success).
inline int make_map_rows(CUtensorMap* map, const void* base, CUtensorMapDataType type, int cols, int rows,
                         int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                          : type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {cols * size, cols * size * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace tt
