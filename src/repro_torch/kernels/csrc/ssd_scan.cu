// Mamba2 SSD cross-chunk state scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_ssd_scan_kernel` / `ssd_state_scan` in
// src/repro/kernels/ssd_scan.py.  For every (batch b, head h) it runs the
// first-order recurrence over the c chunks of a sequence,
//
//     prev[b, i, h] = S_{i-1}        (S_{-1} = s0[b, h])
//     S_i           = S_{i-1} * decay[b, i, h] + states[b, i, h]
//
// on fp32 (p, n) state tiles, and writes final[b, h] = S_{c-1}.  The
// product and the sum are rounded separately (__fmul_rn, __fadd_rn, no
// FMA contraction), as the plain PyTorch version computes them, so the
// two agree bit for bit.
//
// Bound: bytes.  Each element of `states` is read once and each element
// of `prev` written once, plus s0 in and final out: 4 * (2 * b*c*h*p*n +
// 2 * b*h*p*n) bytes against 3.35 TB/s of HBM on an H100 SXM; the
// arithmetic (2 FLOPs per element) is negligible.
//
// Design: a stream, not a tile.  The Pallas kernel held a whole (c, p, n)
// tile in VMEM per grid step; here one thread owns a 16-byte slice (4
// consecutive n) of one (b, h) state tile and keeps its carry in
// registers across all c chunks, so the grid is
// (ceil(p*n / (4*NT)), h, b) and nothing but the inputs and outputs
// touches memory.  The loop issues chunk i+1's `states` load before it
// stores chunk i's `prev`, so a load is always in flight.  Every tensor
// is read through its strides (the model's `states` and decay are
// read in place, with no transposes); each (p, n) row must be unit-stride
// along n with n a multiple of 4, and rows 16-byte aligned.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads per block, 4 state elements each

struct Args {
  const float* states; const float* decay; const float* s0;
  float* prev; float* fin;
  int b, c, h, p, n;
  long long ssb, ssc, ssh, ssp;  // states (b, c, h, p)
  long long sdb, sdc, sdh;       // decay (b, c, h)
  long long s0b, s0h, s0p;       // s0 (b, h, p)
  long long spb, spc, sph, spp;  // prev (b, c, h, p)
  long long sfb, sfh, sfp;       // final (b, h, p)
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 advance(float4 s, float d, float4 x) {
  return make_float4(__fadd_rn(__fmul_rn(s.x, d), x.x),
                     __fadd_rn(__fmul_rn(s.y, d), x.y),
                     __fadd_rn(__fmul_rn(s.z, d), x.z),
                     __fadd_rn(__fmul_rn(s.w, d), x.w));
}

__global__ void __launch_bounds__(NT) ssd_scan(Args a) {
  const int nv = a.n / 4;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= a.p * nv) return;
  const int pi = e / nv, ni = 4 * (e % nv);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* st = a.states + b * a.ssb + h * a.ssh + pi * a.ssp + ni;
  const float* dc = a.decay + b * a.sdb + h * a.sdh;
  float* pv = a.prev + b * a.spb + h * a.sph + pi * a.spp + ni;

  float4 carry = load4(a.s0 + b * a.s0b + h * a.s0h + pi * a.s0p + ni);
  if (a.c > 0) {
    float4 x = load4(st);
    float d = __ldg(dc);
    for (int i = 0; i < a.c; ++i) {
      float4 xn = make_float4(0.f, 0.f, 0.f, 0.f);
      float dn = 0.f;
      if (i + 1 < a.c) {
        xn = load4(st + (i + 1) * a.ssc);
        dn = __ldg(dc + (i + 1) * a.sdc);
      }
      store4(pv + i * a.spc, carry);
      carry = advance(carry, d, x);
      x = xn;
      d = dn;
    }
  }
  store4(a.fin + b * a.sfb + h * a.sfh + pi * a.sfp + ni, carry);
}

}  // namespace

// dims: b, c, h, p, n (n a multiple of 4).  strides (elements): states
// (b,c,h,p), decay (b,c,h), s0 (b,h,p), prev (b,c,h,p), final (b,h,p);
// n is unit-stride in states, s0, prev and final, and their rows start
// on 16-byte boundaries.  All tensors are fp32.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* states, const void* decay,
                            const void* s0, void* prev, void* fin,
                            const long long* dims, const long long* strides,
                            void* stream) {
  Args a;
  a.states = static_cast<const float*>(states);
  a.decay = static_cast<const float*>(decay);
  a.s0 = static_cast<const float*>(s0);
  a.prev = static_cast<float*>(prev);
  a.fin = static_cast<float*>(fin);
  a.b = static_cast<int>(dims[0]);
  a.c = static_cast<int>(dims[1]);
  a.h = static_cast<int>(dims[2]);
  a.p = static_cast<int>(dims[3]);
  a.n = static_cast<int>(dims[4]);
  a.ssb = strides[0]; a.ssc = strides[1]; a.ssh = strides[2];
  a.ssp = strides[3];
  a.sdb = strides[4]; a.sdc = strides[5]; a.sdh = strides[6];
  a.s0b = strides[7]; a.s0h = strides[8]; a.s0p = strides[9];
  a.spb = strides[10]; a.spc = strides[11]; a.sph = strides[12];
  a.spp = strides[13];
  a.sfb = strides[14]; a.sfh = strides[15]; a.sfp = strides[16];
  if (a.n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = a.p * (a.n / 4);
  const dim3 grid((vecs + NT - 1) / NT, a.h, a.b);
  ssd_scan<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
