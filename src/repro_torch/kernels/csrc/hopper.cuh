// Hopper (sm_90a) building blocks for the attention kernels: mbarriers,
// TMA tile loads and 1-D bulk copies, named barriers, shared-memory matrix
// descriptors and warpgroup matrix products (wgmma) in inline PTX; on the
// host, the TMA tensor map of a (B, rows, heads, hd) bf16 view
// (`make_map`).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace hopper {

using attn::smem_addr;

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes the phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~10 s of clock cycles traps: a protocol fault then fails the
// launch instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > 20000000000ll) __trap();
  }
}

// ---------------------------------------------------------------- TMA
// Copy the box at element coordinates (c0, c1, c2, c3) of the tensor map
// into shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global memory to shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------- named barriers
// Barrier `id` (1-15; 0 is __syncthreads) of `count` threads: sync waits
// for all of them, arrive counts this thread and goes on.  Both order the
// caller's prior shared-memory writes before the waiters' reads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// 2^x in one MUFU op (ex2.approx.ftz: relative error ~2^-22, 0 for x
// below -126 and for -inf); exp2f's precise form adds a range branch.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a tile written by TMA with 128-byte
// swizzle: rows of 128 bytes (64 bf16), 8-row groups 1024 bytes apart
// (the stride byte offset).  `lbo` is the leading byte offset: unused for
// K-major operands, the distance between 64-column blocks for MN-major
// ones.  Tiles start on 1024-byte boundaries, so the base offset is 0;
// a K step inside a swizzle atom moves the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// A descriptor moved by `elems` bf16 elements (a multiple of 8): the
// start address field counts 16-byte units.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, int elems) {
  return desc + static_cast<uint64_t>(elems / 8);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products (from their launch to their wait).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// The same for register A fragments: keep them live until the products
// that read them have been waited for.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_O8(i)                                                        \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),           \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

// D = A B^T (+ D when scale_d), m64n32k16: A and B K-major in shared
// memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D = A B^T, m64n32k16, D's old value neither read nor kept.
__device__ __forceinline__ void wgmma_ss_n32_zero(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_O8(0), WG_O8(8)
      : "l"(da), "l"(db), "r"(0));
}

// D = A B^T (+ D when scale_d), m64n64k16: A and B K-major in shared
// memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D = A B^T, m64n64k16, D's old value neither read nor kept: the first
// k step of a product, so that the accumulators are not live before it.
__device__ __forceinline__ void wgmma_ss_n64_zero(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_O8(0), WG_O8(8), WG_O8(16), WG_O8(24)
      : "l"(da), "l"(db), "r"(0));
}

// D = A B^T (+ D when scale_d), m64n128k16: A and B K-major in shared
// memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D = A B (+ D when scale_d), m64n64k16: A from registers (4 bf16x2
// per thread, the mma.sync A-fragment layout per warp), B MN-major in
// shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D = A B (+ D when scale_d), m64n128k16: A from registers (4 bf16x2
// per thread, the mma.sync A-fragment layout per warp), B MN-major in
// shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D = A B (+ D when scale_d), m64n192k16: A from registers (4 bf16x2
// per thread, the mma.sync A-fragment layout per warp), B MN-major in
// shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),
        WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D = A B (+ D when scale_d), m64n256k16: A from registers (4 bf16x2
// per thread, the mma.sync A-fragment layout per warp), B MN-major in
// shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),
        WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88),
        WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef WG_D8
#undef WG_O8

// The products by width N (accumulators: N / 2 floats per thread);
// `ss_zero` is the first k step of an SS product (D not read).
template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  __device__ static void ss(float* d, uint64_t a, uint64_t b, int s) {
    wgmma_ss_n32(d, a, b, s);
  }
  __device__ static void ss_zero(float* d, uint64_t a, uint64_t b) {
    wgmma_ss_n32_zero(d, a, b);
  }
};
template <> struct Wgmma<64> {
  __device__ static void ss(float* d, uint64_t a, uint64_t b, int s) {
    wgmma_ss_n64(d, a, b, s);
  }
  __device__ static void ss_zero(float* d, uint64_t a, uint64_t b) {
    wgmma_ss_n64_zero(d, a, b);
  }
  __device__ static void rs(float* d, const uint32_t* a, uint64_t b, int s) {
    wgmma_rs_n64(d, a, b, s);
  }
};
template <> struct Wgmma<128> {
  __device__ static void ss(float* d, uint64_t a, uint64_t b, int s) {
    wgmma_ss_n128(d, a, b, s);
  }
  __device__ static void rs(float* d, const uint32_t* a, uint64_t b, int s) {
    wgmma_rs_n128(d, a, b, s);
  }
};
template <> struct Wgmma<192> {
  __device__ static void rs(float* d, const uint32_t* a, uint64_t b, int s) {
    wgmma_rs_n192(d, a, b, s);
  }
};
template <> struct Wgmma<256> {
  __device__ static void rs(float* d, const uint32_t* a, uint64_t b, int s) {
    wgmma_rs_n256(d, a, b, s);
  }
};

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (no -lcuda at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a (B, rows, heads, hd) bf16 view with element strides
// (sb, srow, sh) and a unit-stride head dimension, as dims (hd, rows,
// heads, B): 64-column boxes of box_rows rows, 128-byte swizzle, zero
// fill out of bounds.  A size-1 dimension's stride is never used; it is
// replaced by 16 bytes when TMA could not take it.
inline bool make_map(CUtensorMap* map, const void* ptr, int hd, int rows,
                     int heads, int B, long long srow, long long sh,
                     long long sb, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long n[3] = {rows, heads, B}, st[3] = {srow, sh, sb};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = st[i] * 2;
    strides[i] = (n[i] == 1 && (bytes <= 0 || bytes % 16))
                     ? 16 : static_cast<cuuint64_t>(bytes);
  }
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
