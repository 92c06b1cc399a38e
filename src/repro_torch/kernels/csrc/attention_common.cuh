// Pieces shared by the attention kernels: the mask value, fp32 widening
// of the input types, the vectorised fp32 tile load, cp.async, and the
// mma.sync / ldmatrix tensor-core pieces.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

// The reference's finite mask value: a row whose keys are all masked
// gets uniform weights (mean(V)), never 0 or NaN.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T widened to fp32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// Copy rows [r0, r0 + ROWS) of a (rows, HD) matrix with row stride `st`
// (elements; rows 16-byte aligned) into shared memory as fp32: element
// (row, d) goes to dst[row * ld + d], or to dst[d * ld + row] when
// TRANSPOSE.  Rows at or past `rend` are written as 0.  A block of
// NTHREADS threads issues up to 8 loads of 16 bytes per thread before it
// stores any, so a tile costs one memory latency per round, not one per
// element.
template <typename T, int HD, int ROWS, int NTHREADS, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(const T* src, long long st, int r0,
                                          int rend, float* dst, int ld) {
  constexpr int N = Vec16<T>::N;
  constexpr int PER_ROW = HD / N;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int ROUND = 8 * NTHREADS;
#pragma unroll
  for (int base = 0; base < TOTAL; base += ROUND) {
    uint4 r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = base + j * NTHREADS + threadIdx.x;
      const int row = r0 + idx / PER_ROW;
      r[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < TOTAL && row < rend)
        r[j] = *reinterpret_cast<const uint4*>(src + row * st +
                                               (idx % PER_ROW) * N);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = base + j * NTHREADS + threadIdx.x;
      if (idx >= TOTAL) continue;
      float f[N];
      Vec16<T>::widen(r[j], f);
      const int row = idx / PER_ROW, d0 = (idx % PER_ROW) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (TRANSPOSE)
          dst[(d0 + i) * ld + row] = f[i];
        else
          dst[row * ld + d0 + i] = f[i];
      }
    }
  }
}

// Tensor-core pieces (sm_80 and later): an m16n8k16 bf16 product with
// fp32 accumulation, and the ldmatrix loads that feed it from shared
// memory.  Fragment layouts are PTX's: in a C fragment thread t holds
// rows t/4 and t/4 + 8, columns 2*(t%4) and 2*(t%4) + 1.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared (sm_80 and later); when
// `full` is false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two fp32 values as one bf16x2 register (the first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace attn
