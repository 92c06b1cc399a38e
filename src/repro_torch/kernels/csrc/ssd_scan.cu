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
//
// Backward (kernel `ssd_scan_rev`, C entry point `ssd_scan_bwd`): what
// the JAX package gets from XLA's autodiff of the `lax.scan` in
// src/repro/models/ssm.py.  Given dprev
// (the gradient of prev) and dfinal, the reverse recurrence, with
// G_{c-1} = dfinal:
//
//     dstates_i = G_i
//     ddecay_i  = sum_{p,n} G_i * prev_i
//     G_{i-1}   = dprev_i + decay_i * G_i        ds0 = G_{-1}
//
// dstates and ds0 round the product and the sum separately, as the plain
// version does, and match it bit for bit; ddecay is a sum over p*n
// elements in a fixed order (each thread's elements, then the warp's
// shuffle tree, then the warps in order): the same bits from run to run,
// held to a tolerance against the plain version.  One block per (b, h)
// holds the whole (p, n) tile's carry in registers (VPT float4s a
// thread), so the sum needs no atomics and no second pass.  Bound:
// bytes, 4 * (3 b*c*h*p*n + 2 b*h*p*n + 2 b*c*h): prev and dprev read,
// dstates written, dfinal in and ds0 out, decay in and ddecay out.
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

constexpr int BNT = 256;  // threads of a backward block, one per (b, h)
constexpr int BNW = BNT / 32;

struct BwdArgs {
  const float* decay; const float* prev; const float* dprev;
  const float* dfin;
  float* dstates; float* ddecay; float* ds0;
  int b, c, h, p, n;
  long long sdb, sdc, sdh;        // decay (b, c, h)
  long long spb, spc, sph, spp;   // prev (b, c, h, p)
  long long sqb, sqc, sqh, sqp;   // dprev (b, c, h, p)
  long long sfb, sfh, sfp;        // dfinal (b, h, p)
  long long ssb, ssc, ssh, ssp;   // dstates (b, c, h, p)
  long long sgb, sgc, sgh;        // ddecay (b, c, h)
  long long s0b, s0h, s0p;        // ds0 (b, h, p)
};

// G <- dprev + decay * G, the product and the sum rounded apart.
__device__ __forceinline__ float4 retreat(float4 g, float d, float4 dp) {
  return make_float4(__fadd_rn(dp.x, __fmul_rn(d, g.x)),
                     __fadd_rn(dp.y, __fmul_rn(d, g.y)),
                     __fadd_rn(dp.z, __fmul_rn(d, g.z)),
                     __fadd_rn(dp.w, __fmul_rn(d, g.w)));
}

template <int VPT>
__global__ void __launch_bounds__(BNT) ssd_scan_rev(BwdArgs a) {
  extern __shared__ float part[];  // [c][BNW] the warps' shares of ddecay
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nv = a.n / 4, vecs = a.p * nv;
  // this thread's float4s: element e = tid + BNT k of the (p, n/4) tile
  float4 g[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int e = tid + BNT * k, pi = e / nv, ni = 4 * (e % nv);
    g[k] = e < vecs
               ? load4(a.dfin + b * a.sfb + h * a.sfh + pi * a.sfp + ni)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* dc = a.decay + b * a.sdb + h * a.sdh;
  for (int i = a.c - 1; i >= 0; --i) {
    const float d = __ldg(dc + i * a.sdc);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int e = tid + BNT * k, pi = e / nv, ni = 4 * (e % nv);
      if (e >= vecs) continue;
      const float4 pv = load4(a.prev + b * a.spb + i * a.spc + h * a.sph +
                              pi * a.spp + ni);
      const float4 dp = load4(a.dprev + b * a.sqb + i * a.sqc + h * a.sqh +
                              pi * a.sqp + ni);
      store4(a.dstates + b * a.ssb + i * a.ssc + h * a.ssh + pi * a.ssp + ni,
             g[k]);
      acc += g[k].x * pv.x + g[k].y * pv.y + g[k].z * pv.z + g[k].w * pv.w;
      g[k] = retreat(g[k], d, dp);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) part[i * BNW + warp] = acc;
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int e = tid + BNT * k, pi = e / nv, ni = 4 * (e % nv);
    if (e < vecs)
      store4(a.ds0 + b * a.s0b + h * a.s0h + pi * a.s0p + ni, g[k]);
  }
  __syncthreads();
  for (int i = tid; i < a.c; i += BNT) {
    float sum = 0.f;
    for (int w = 0; w < BNW; ++w) sum += part[i * BNW + w];
    a.ddecay[b * a.sgb + i * a.sgc + h * a.sgh] = sum;
  }
}

template <int VPT>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(a.c) * BNW;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_rev<VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_scan_rev<VPT><<<dim3(a.h, a.b), BNT, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dims: b, c, h, p, n (n a multiple of 4, p*n at most 16 * 4 * 256).
// strides (elements): decay (b,c,h), prev (b,c,h,p), dprev (b,c,h,p),
// dfinal (b,h,p), dstates (b,c,h,p), ddecay (b,c,h), ds0 (b,h,p); n is
// unit-stride in the (p, n) tensors, whose rows start on 16-byte
// boundaries; c * 32 bytes of shared memory must fit a block.  All
// tensors are fp32.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_scan_bwd(const void* decay, const void* prev,
                            const void* dprev, const void* dfin,
                            void* dstates, void* ddecay, void* ds0,
                            const long long* dims, const long long* strides,
                            void* stream) {
  BwdArgs a;
  a.decay = static_cast<const float*>(decay);
  a.prev = static_cast<const float*>(prev);
  a.dprev = static_cast<const float*>(dprev);
  a.dfin = static_cast<const float*>(dfin);
  a.dstates = static_cast<float*>(dstates);
  a.ddecay = static_cast<float*>(ddecay);
  a.ds0 = static_cast<float*>(ds0);
  a.b = static_cast<int>(dims[0]);
  a.c = static_cast<int>(dims[1]);
  a.h = static_cast<int>(dims[2]);
  a.p = static_cast<int>(dims[3]);
  a.n = static_cast<int>(dims[4]);
  const long long* s = strides;
  a.sdb = s[0]; a.sdc = s[1]; a.sdh = s[2];
  a.spb = s[3]; a.spc = s[4]; a.sph = s[5]; a.spp = s[6];
  a.sqb = s[7]; a.sqc = s[8]; a.sqh = s[9]; a.sqp = s[10];
  a.sfb = s[11]; a.sfh = s[12]; a.sfp = s[13];
  a.ssb = s[14]; a.ssc = s[15]; a.ssh = s[16]; a.ssp = s[17];
  a.sgb = s[18]; a.sgc = s[19]; a.sgh = s[20];
  a.s0b = s[21]; a.s0h = s[22]; a.s0p = s[23];
  if (a.n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (a.p * (a.n / 4) + BNT - 1) / BNT;  // float4s a thread
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (per <= 1) err = launch_bwd<1>(a, st);
  else if (per <= 2) err = launch_bwd<2>(a, st);
  else if (per <= 4) err = launch_bwd<4>(a, st);
  else if (per <= 8) err = launch_bwd<8>(a, st);
  else if (per <= 16) err = launch_bwd<16>(a, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

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
