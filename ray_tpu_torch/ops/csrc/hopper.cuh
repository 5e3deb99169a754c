// Building blocks of the Hopper (sm_90a) flash kernels, shared by
// flash_fwd.cu and flash_bwd.cu: mbarriers, TMA loads, wgmma shared-memory
// descriptors and the wgmma instructions, and the host-side encoding of
// the TMA tensor maps. paged_decode.cu uses the mbarriers and the 1-D bulk
// copy (`bulk_load`).
//
// Every tile these kernels read with wgmma is stored with the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, or the same XOR written by
// hand): rows of 128 bytes (64 bf16), the 16-byte chunk index of a row
// XORed with the row index mod 8, tiles starting on 1024-byte boundaries.
// A [rows, 64k] tile is stored as k panels of [rows, 64], one after the
// other. Read K-major (the reduction dim along the 128-byte row) a
// descriptor's SBO is 1024 (8 rows) and a k16 step is +32 bytes inside a
// panel; read MN-major (the reduction dim along the rows) a k16 step is
// +16 rows (+2048 bytes), SBO is 1024 and LBO the stride between panels.
//
// Included once per translation unit: everything is internal to it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kPanelCols = 64;    // TMA box inner dim: 128 bytes of bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operands written with st.shared).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1..15) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle. Offsets in
// bytes: `lbo` is unused for K-major operands and is the stride between
// 64-column panels for MN-major ones; `sbo` is the stride between groups
// of 8 rows (8 x 128 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The accumulator operand lists of m64n64 (32 floats a thread) and
// m64n128 (64).
#define RT_ACC8(o)                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define RT_ACC32 RT_ACC8(0), RT_ACC8(8), RT_ACC8(16), RT_ACC8(24)
#define RT_ACC64 RT_ACC32, RT_ACC8(32), RT_ACC8(40), RT_ACC8(48), RT_ACC8(56)
#define RT_REGS32                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define RT_REGS64                                                      \
  RT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A and B from shared memory;
// TA / TB 1 reads A / B MN-major (the transpose bits), 0 K-major;
// scale_d 0 overwrites D. N = 64 (32 floats) or 128 (64 floats).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" RT_REGS32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : RT_ACC32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" RT_REGS64 "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : RT_ACC64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x N] += A[64 x 16] * B[16 x N], A from registers (four bf16x2 a
// thread, in the accumulator's layout), B from shared memory MN-major
// (imm-trans-b 1). N = 64 (32 floats) or 128 (64 floats).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" RT_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" RT_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef RT_ACC8
#undef RT_ACC32
#undef RT_ACC64
#undef RT_REGS32
#undef RT_REGS64

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// ---------------------------------------------------------------- host

// Values of one tensor map in a geometry array (ops/flash.py
// TensorMapGeometry): dims (d, heads, seq, batch), byte strides (heads,
// seq, batch), box (d, heads, seq, batch).
constexpr int kMapLen = 11;

// Errors of cuTensorMapEncodeTiled come back as kEncodeError + CUresult.
constexpr int kEncodeError = 1 << 20;
constexpr int kNoEntryPoint = 2 << 20;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle; out-of-bounds boxes fill
// with zeros.
inline int encode_map(CUtensorMap* map, const void* ptr, const int64_t* g) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEntryPoint;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)g[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)g[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)g[7 + i];
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// Whether the map's box is one 64-column panel of `rows` rows of one head
// and batch: the tiles the kernels' descriptors assume.
inline bool panel_box(const int64_t* g, int rows) {
  const int64_t* box = g + 7;
  return box[0] == kPanelCols && box[1] == 1 && box[2] == rows && box[3] == 1;
}

// The message of a launcher's return value: a cudaError_t, or an encode
// failure.
inline const char* error_text(int err) {
  static char buf[96];
  if (err >= kNoEntryPoint) return "cuTensorMapEncodeTiled not found";
  if (err >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed, CUresult %d",
             err - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
