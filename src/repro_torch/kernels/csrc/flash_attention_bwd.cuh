// Prefill flash attention backward for Hopper (sm_90a): the scalar
// kernels, instantiated by flash_attention_bwd_f32.cu, which exports their
// plain C entry point: fp32 inputs take them at every (hd, hd_v) pair
// (fp32 never runs on TF32).  bf16 inputs take the tensor-core kernels of
// flash_attention_bwd_wgmma.cuh (flash_attention_bwd_bf16.cu), which share
// the arguments and mask helpers below.
//
// Replaces what the JAX package gets from XLA's autodiff of its jnp
// attention, `_attend` / `blockwise_attention` in
// src/repro/models/attention.py (the Pallas kernel `_flash_kernel` has no
// backward; training differentiates the jnp version).  The forward is
// K2 (csrc/flash_attention.cu), which also writes each row's natural-log
// log-sum-exp `lse` (B,H,S) fp32 of its scaled, masked scores.  Given
// dO (the gradient of K2's output, (B,H,S,hd_v)), this computes dQ, dK
// and dV:
//
//     P  = exp(scale * Q K^T - lse)        kept pairs; 0 for masked ones
//     dV = P^T dO              dP = dO V^T        D = rowsum(dO o O)
//     dS = P o (dP - D)        dQ = scale dS K     dK = scale dS^T Q
//
// with the mask of the forward (kp >= 0, qp >= 0, kp <= qp when causal,
// qp - kp < window with a window).  The reference masks with jnp.where,
// so a masked score's gradient is 0.  A row that keeps no key (its lse is
// the mask value NEG_INF = -1e30, as K2 writes it) took mean(V) in the
// forward: P = 1/T over all T keys feeds dV, and dS = 0.
//
// Three kernels, one launch sequence, no atomics: the gradients are the
// same bits from run to run.
//   `bwd_dsum`: D = rowsum(dO o O) in fp32, one warp per row.
//   `bwd_dkdv`: one block per (32-key tile, kv head, batch) holds its K
//     and V tiles and its dK, dV accumulators and walks the g query heads
//     of its GQA group and their query tiles, so the group's sum happens
//     inside the block; a query tile with no kept pair against the block's
//     keys (and no row that keeps no key) is skipped.
//   `bwd_dq`: one block per (query tile, head, batch) holds Q, dO and its
//     dQ accumulator and walks the key tiles, skipping tiles with no kept
//     pair.
// Both recompute S = Q K^T and dP = dO V^T per tile.  Everything is fp32
// from shared memory: inputs (bf16 or fp32) are widened on load and every
// product is a scalar fp32 FMA (never TF32); outputs are rounded once, to
// the input type.
//
// Bound.  5 products of 2*(kept pairs) FLOPs times their depth: S, dK and
// dQ hd, dP and dV hd_v (2 * (3 hd + 2 hd_v) * kept pairs in all; 2.5
// times the forward's at hd = hd_v), against 989 TFLOP/s bf16 tensor
// cores (67 TFLOP/s fp32 without them) on an H100 SXM; operations, not
// bytes, at every trained shape.  These kernels run on the fp32 CUDA
// cores and read two shared-memory operands per FMA or so: at
// StarCoder2-7B's trained shape (B 2, S = T = 2048, hd 128) they took
// 21.8 ms against a 0.196 ms bound on an H100 80GB HBM3 at 700 W, which
// is why bf16 runs on the tensor cores instead.
#pragma once

#include "attention_common.cuh"

namespace {

using attn::from_f;
using attn::NEG_INF;

constexpr int BK = 32;   // keys per tile
constexpr int NT = 256;  // threads: 32 row groups x 8 column groups

struct Args {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  const float* lse; float* dsum;
  const int* qpos; const int* kpos;
  void* dq; void* dk; void* dv;
  int B, H, Hkv, S, T, g, hd, hdv;
  long long sqb, sqh, sqs, skb, skh, skt, svb, svh, svt;
  long long sob, soh, sos, sdob, sdoh, sdos;
  long long sdqb, sdqh, sdqs, sdkb, sdkh, sdkt, sdvb, sdvh, sdvt;
  long long sqpb, sqps, skpb, skpt;
  float scale; int causal; int window;
};

__device__ __forceinline__ bool kept(int qp, int kp, int causal,
                                     int window) {
  bool ok = kp >= 0 && qp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

// A row whose lse is the mask value kept no key in the forward.
__device__ __forceinline__ bool no_key(float lse) {
  return lse <= 0.5f * NEG_INF;
}

template <int HD>
constexpr int BQ_OF = HD <= 128 ? 64 : 32;  // query rows per tile

// D[b, h, s] = sum_d dO[b, h, s, d] * O[b, h, s, d], fp32; one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT) bwd_dsum(Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.H * a.S) return;
  const int s = static_cast<int>(row % a.S);
  const int h = static_cast<int>((row / a.S) % a.H);
  const int b = static_cast<int>(row / (static_cast<long long>(a.S) * a.H));
  const T* o = static_cast<const T*>(a.o) + b * a.sob + h * a.soh +
               s * a.sos;
  const T* d = static_cast<const T*>(a.dout) + b * a.sdob + h * a.sdoh +
               s * a.sdos;
  float acc = 0.f;
  for (int i = lane; i < a.hdv; i += 32)
    acc = fmaf(attn::to_f(d[i]), attn::to_f(o[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.dsum[row] = acc;
}

template <int HD, int HDV>
constexpr size_t dkdv_smem() {
  constexpr int BQ = BQ_OF<HD>;
  return sizeof(float) * (BQ * (HD + 1) + BQ * (HDV + 1) +
                          (HD + HDV) * (BK + 1) + 2 * BQ * (BK + 1) +
                          2 * BQ) +
         sizeof(int) * (BQ + BK);
}

template <int HD, int HDV>
constexpr size_t dq_smem() {
  constexpr int BQ = BQ_OF<HD>;
  return sizeof(float) * (BQ * (HD + 1) + BQ * (HDV + 1) +
                          (HD + HDV) * (BK + 1) + BK * HD + BQ * (BK + 1) +
                          2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// acc[i][j] = sum_d A[RPT*rg + i][d] Bt[d][cg + 8 j] over D columns: A
// row-major with row stride D + 1, Bt (D, BK + 1).
template <int D, int RPT, int CPT>
__device__ __forceinline__ void row_products(const float* A, const float* Bt,
                                             int rg, int cg,
                                             float (&acc)[RPT][CPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = A[(RPT * rg + i) * (D + 1) + d];
    const float* br = Bt + d * (BK + 1) + cg;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float y = br[8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

// S = Q K^T (unscaled, over HD) and dP = dO V^T (over HDV) for the RPT
// rows x CPT keys a thread owns: rows RPT*rg + i, keys cg + 8 j.
template <int HD, int HDV, int RPT, int CPT>
__device__ __forceinline__ void tile_products(const float* Qs,
                                              const float* dOs,
                                              const float* Kt,
                                              const float* Vt, int rg,
                                              int cg, float (&s)[RPT][CPT],
                                              float (&dp)[RPT][CPT]) {
  row_products<HD, RPT, CPT>(Qs, Kt, rg, cg, s);
  row_products<HDV, RPT, CPT>(dOs, Vt, rg, cg, dp);
}

// One block per (32-key tile, kv head, batch): dK and dV of its keys,
// summed over the g heads of the group and every query tile.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT) bwd_dkdv(Args a) {
  constexpr int BQ = BQ_OF<HD>;
  constexpr int RPT = BQ / 32;  // rows per thread in the S tile
  constexpr int CPT = BK / 8;   // keys per thread in the S tile
  constexpr int DPT = HD / 8;   // dims per thread in dK
  constexpr int DPTV = HDV / 8;  // ... in dV
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][HD+1]
  float* dOs = Qs + BQ * (HD + 1);    // [BQ][HDV+1]
  float* Kt = dOs + BQ * (HDV + 1);   // [HD][BK+1], K transposed
  float* Vt = Kt + HD * (BK + 1);     // [HDV][BK+1], V transposed
  float* Ps = Vt + HDV * (BK + 1);    // [BQ][BK+1]
  float* dSs = Ps + BQ * (BK + 1);    // [BQ][BK+1]
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* D_s = lse_s + BQ;             // [BQ]
  int* qp_s = reinterpret_cast<int*>(D_s + BQ);  // [BQ]
  int* kp_s = qp_s + BQ;                         // [BK]

  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;
  const int kc = tid / 8, dg = tid % 8;  // the key and dims it accumulates
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  attn::load_rows<T, HD, BK, NT, true>(k, a.skt, k0, a.T, Kt, BK + 1);
  attn::load_rows<T, HDV, BK, NT, true>(v, a.svt, k0, a.T, Vt, BK + 1);
  for (int c = tid; c < BK; c += NT)
    kp_s[c] = k0 + c < a.T ? a.kpos[b * a.skpb + (k0 + c) * a.skpt] : -1;

  float dk[DPT], dv[DPTV];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = 0.f;
#pragma unroll
  for (int j = 0; j < DPTV; ++j) dv[j] = 0.f;
  const float uniform = 1.f / a.T;
  const int nq = (a.S + BQ - 1) / BQ;

  for (int hh = 0; hh < a.g; ++hh) {
    const int h = kvh * a.g + hh;
    const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdob +
                    h * a.sdoh;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      for (int r = tid; r < BQ; r += NT) {
        const int qi = q0 + r;
        const bool ok = qi < a.S;
        qp_s[r] = ok ? a.qpos[b * a.sqpb + qi * a.sqps] : -1;
        lse_s[r] = ok ? a.lse[row0 + qi] : 0.f;
        D_s[r] = ok ? a.dsum[row0 + qi] : 0.f;
      }
      __syncthreads();
      bool live = false;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = RPT * rg + i;
        if (q0 + r >= a.S) continue;
        if (no_key(lse_s[r])) live = true;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cg + 8 * j;
          if (k0 + c < a.T && kept(qp_s[r], kp_s[c], a.causal, a.window))
            live = true;
        }
      }
      if (!__syncthreads_or(live)) continue;
      attn::load_rows<T, HD, BQ, NT, false>(q, a.sqs, q0, a.S, Qs, HD + 1);
      attn::load_rows<T, HDV, BQ, NT, false>(dout, a.sdos, q0, a.S, dOs,
                                             HDV + 1);
      __syncthreads();

      float s[RPT][CPT], dp[RPT][CPT];
      tile_products<HD, HDV, RPT, CPT>(Qs, dOs, Kt, Vt, rg, cg, s, dp);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = RPT * rg + i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cg + 8 * j;
          float p = 0.f, ds = 0.f;
          if (q0 + r < a.S && k0 + c < a.T) {
            if (no_key(lse_s[r])) {
              p = uniform;
            } else if (kept(qp_s[r], kp_s[c], a.causal, a.window)) {
              p = expf(s[i][j] * a.scale - lse_s[r]);
              ds = p * (dp[i][j] - D_s[r]);
            }
          }
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for key kc, dims dg + 8 j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float p = Ps[r * (BK + 1) + kc];
        const float ds = dSs[r * (BK + 1) + kc];
        const float* orow = dOs + r * (HDV + 1) + dg;
        const float* qrow = Qs + r * (HD + 1) + dg;
#pragma unroll
        for (int j = 0; j < DPTV; ++j) dv[j] = fmaf(p, orow[8 * j], dv[j]);
#pragma unroll
        for (int j = 0; j < DPT; ++j) dk[j] = fmaf(ds, qrow[8 * j], dk[j]);
      }
    }
  }

  const int t = k0 + kc;
  if (t < a.T) {
    T* dko = static_cast<T*>(a.dk) + b * a.sdkb + kvh * a.sdkh + t * a.sdkt;
    T* dvo = static_cast<T*>(a.dv) + b * a.sdvb + kvh * a.sdvh + t * a.sdvt;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dko[dg + 8 * j] = from_f<T>(dk[j] * a.scale);
#pragma unroll
    for (int j = 0; j < DPTV; ++j) dvo[dg + 8 * j] = from_f<T>(dv[j]);
  }
}

// One block per (query tile, head, batch): dQ of its rows over every key
// tile.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT) bwd_dq(Args a) {
  constexpr int BQ = BQ_OF<HD>;
  constexpr int RPT = BQ / 32;
  constexpr int CPT = BK / 8;
  constexpr int DPT = HD / 8;   // dims per thread in dQ
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][HD+1]
  float* dOs = Qs + BQ * (HD + 1);    // [BQ][HDV+1]
  float* Kt = dOs + BQ * (HDV + 1);   // [HD][BK+1], K transposed
  float* Vt = Kt + HD * (BK + 1);     // [HDV][BK+1], V transposed
  float* Ks = Vt + HDV * (BK + 1);    // [BK][HD]
  float* dSs = Ks + BK * HD;          // [BQ][BK+1]
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* D_s = lse_s + BQ;             // [BQ]
  int* qp_s = reinterpret_cast<int*>(D_s + BQ);  // [BQ]
  int* kp_s = qp_s + BQ;                         // [BK]

  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdob + h * a.sdoh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.S;

  attn::load_rows<T, HD, BQ, NT, false>(q, a.sqs, q0, a.S, Qs, HD + 1);
  attn::load_rows<T, HDV, BQ, NT, false>(dout, a.sdos, q0, a.S, dOs,
                                         HDV + 1);
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    const bool ok = qi < a.S;
    qp_s[r] = ok ? a.qpos[b * a.sqpb + qi * a.sqps] : -1;
    lse_s[r] = ok ? a.lse[row0 + qi] : NEG_INF;
    D_s[r] = ok ? a.dsum[row0 + qi] : 0.f;
  }

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;

  const int nk = (a.T + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BK; c += NT)
      kp_s[c] = k0 + c < a.T ? a.kpos[b * a.skpb + (k0 + c) * a.skpt] : -1;
    __syncthreads();
    bool live = false;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = RPT * rg + i;
      if (q0 + r >= a.S || no_key(lse_s[r])) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + 8 * j;
        if (k0 + c < a.T && kept(qp_s[r], kp_s[c], a.causal, a.window))
          live = true;
      }
    }
    if (!__syncthreads_or(live)) continue;
    attn::load_rows<T, HD, BK, NT, true>(k, a.skt, k0, a.T, Kt, BK + 1);
    attn::load_rows<T, HDV, BK, NT, true>(v, a.svt, k0, a.T, Vt, BK + 1);
    attn::load_rows<T, HD, BK, NT, false>(k, a.skt, k0, a.T, Ks, HD);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_products<HD, HDV, RPT, CPT>(Qs, dOs, Kt, Vt, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = RPT * rg + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + 8 * j;
        float ds = 0.f;
        if (q0 + r < a.S && k0 + c < a.T && !no_key(lse_s[r]) &&
            kept(qp_s[r], kp_s[c], a.causal, a.window)) {
          const float p = expf(s[i][j] * a.scale - lse_s[r]);
          ds = p * (dp[i][j] - D_s[r]);
        }
        dSs[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K for rows RPT*rg + i, dims cg + 8 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        dsv[i] = dSs[(RPT * rg + i) * (BK + 1) + c];
      const float* kr = Ks + c * HD + cg;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = kr[8 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dq[i][j] = fmaf(dsv[i], kv, dq[i][j]);
      }
    }
  }

  T* dqo = static_cast<T*>(a.dq) + b * a.sdqb + h * a.sdqh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + RPT * rg + i;
    if (qi >= a.S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dqo[qi * a.sdqs + cg + 8 * j] = from_f<T>(dq[i][j] * a.scale);
  }
}

template <typename T, int HD, int HDV>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int BQ = BQ_OF<HD>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.S;
  bwd_dsum<T><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT,
                0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t kv_bytes = dkdv_smem<HD, HDV>();
  err = cudaFuncSetAttribute(bwd_dkdv<T, HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, HD, HDV><<<dim3((a.T + BK - 1) / BK, a.Hkv, a.B), NT,
                         kv_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_bytes = dq_smem<HD, HDV>();
  err = cudaFuncSetAttribute(bwd_dq<T, HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  bwd_dq<T, HD, HDV><<<dim3((a.S + BQ - 1) / BQ, a.H, a.B), NT, q_bytes,
                       st>>>(a);
  return cudaGetLastError();
}

// (hd, hd_v): (hd, hd) at every head dim, and (192, 128).
template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t st) {
  if (a.hdv != a.hd)
    return a.hd == 192 && a.hdv == 128 ? launch<T, 192, 128>(a, st)
                                       : cudaErrorInvalidValue;
  switch (a.hd) {
    case 16: return launch<T, 16, 16>(a, st);
    case 32: return launch<T, 32, 32>(a, st);
    case 64: return launch<T, 64, 64>(a, st);
    case 96: return launch<T, 96, 96>(a, st);
    case 112: return launch<T, 112, 112>(a, st);
    case 128: return launch<T, 128, 128>(a, st);
    case 160: return launch<T, 160, 160>(a, st);
    case 192: return launch<T, 192, 192>(a, st);
    case 256: return launch<T, 256, 256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments of the C entry point (see the .cu files), scratch aside.
inline Args make_args(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* q_pos, const void* k_pos, void* dq,
                      void* dk, void* dv, const long long* dims,
                      const long long* strides, float scale, int causal,
                      int window) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.qpos = static_cast<const int*>(q_pos);
  a.kpos = static_cast<const int*>(k_pos);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.S = static_cast<int>(dims[3]);
  a.T = static_cast<int>(dims[4]);
  a.hd = static_cast<int>(dims[5]);
  a.hdv = static_cast<int>(dims[6]);
  a.g = a.H / a.Hkv;
  const long long* st = strides;
  a.sqb = st[0]; a.sqh = st[1]; a.sqs = st[2];
  a.skb = st[3]; a.skh = st[4]; a.skt = st[5];
  a.svb = st[6]; a.svh = st[7]; a.svt = st[8];
  a.sob = st[9]; a.soh = st[10]; a.sos = st[11];
  a.sdob = st[12]; a.sdoh = st[13]; a.sdos = st[14];
  a.sdqb = st[15]; a.sdqh = st[16]; a.sdqs = st[17];
  a.sdkb = st[18]; a.sdkh = st[19]; a.sdkt = st[20];
  a.sdvb = st[21]; a.sdvh = st[22]; a.sdvt = st[23];
  a.sqpb = st[24]; a.sqps = st[25];
  a.skpb = st[26]; a.skpt = st[27];
  a.scale = scale; a.causal = causal; a.window = window;
  return a;
}

}  // namespace
