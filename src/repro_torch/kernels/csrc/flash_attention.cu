// Prefill flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: q (B,H,S,hd) attends to k
// (B,Hkv,T,hd) and v (B,Hkv,T,hd_v) with per-token positions q_pos (B,S)
// and k_pos (B,T); the output is (B,H,S,hd_v).  hd_v is hd, or 128 at hd
// 192 (MLA: q/k nope 128 + rope 64, V 128).
// A pair is kept when kp >= 0, qp >= 0, kp <= qp (causal) and, with a
// window, qp - kp < window; masked scores take the finite NEG_INF = -1e30,
// so a row whose keys are all masked returns mean(V), as the reference
// does.  Online softmax in fp32.
//
// Two kernels, one function.
//
// bf16: `flash_fwd_wgmma`, built for Hopper (design note above it).  One
// block per (128-row q tile, head, batch), two consumer warpgroups and a
// producer warp; K/V tiles arrive by TMA into a 2-stage ring on
// mbarriers; S = Q K^T and O += P V run on wgmma (fp32 accumulation, P
// rounded to bf16 as FlashAttention does); the softmax runs in base 2;
// each kv tile is classified up front as EMPTY (skipped), FULL (no mask
// evaluated) or MIXED (masked per score); the heaviest causal q tiles
// launch first.  The tensor maps describe the model's transposed
// (B,S,H,hd) views in place: no copies or transposes, but 16-byte
// aligned base addresses and strides, which the wrapper checks.  Head
// dims are padded to a multiple of 64 (16, 32 and 64 to 64, 96, 112 and
// 128 to 128, 160 to 192) by the TMA zero fill; 192 and 256 need none.  V
// and O take their own padded width: at MLA's (192, 128) the P V product
// and O's accumulator are 128 wide.
//
// Both write each row's log-sum-exp, in natural-log units of the scaled
// scores (lse = m + log l), into `lse` (B,H,S) fp32 when it is not null:
// the backward (csrc/flash_attention_bwd.cuh) recomputes P = exp(s - lse).
// A row that keeps no key gets the mask value NEG_INF, which the backward
// reads as "mean(V)".  Serving passes null and writes nothing.
//
// fp32: `flash_fwd`, scalar fp32 FMAs from shared memory (never TF32).
// One 64-row q tile per block walks 32-key tiles with 16-byte loads; a
// tile with no kept pair is skipped once every row of the block has
// seen a kept key; a fully masked row reaches mean(V) through the
// online softmax itself.
//
// Bound.  About 2*B*H*S*T*hd multiply-adds under the causal mask (4 FLOPs
// per kept (q,k,d) triple: QK^T and PV), against 989 TFLOP/s bf16 tensor
// cores on an H100 SXM (67 TFLOP/s fp32 without them): operations, not
// bytes, at every served shape.  What the wgmma kernel leaves on the
// table: the softmax of one warpgroup is not overlapped with the other's
// products (FlashAttention-3's ping-pong), nor with its own next S
// product, and a padded head dim (112 of 128) wastes products.
#include <limits.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using attn::from_f;
using attn::NEG_INF;

// fp32 kernel (scalar FMAs) tiling
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per kv tile
constexpr int NT = 256;  // threads: 32 row groups (2 rows) x 8 column groups

struct Args {
  const void* q; const void* k; const void* v;
  const int* qpos; const int* kpos; void* out; float* lse;
  int B, H, Hkv, S, T, g, hd, hdv;
  long long sqb, sqh, sqs, skb, skh, skt, svb, svh, svt;
  long long sob, soh, sos, sqpb, sqps, skpb, skpt;
  float scale; int causal; int window;
};

__device__ __forceinline__ bool keep(int qp, int kp, int causal,
                                     int window) {
  bool ok = kp >= 0 && qp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + HD * (BK + 1) + BK * HDV +
                          BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

// fp32 inputs: each thread owns 2 query rows x 4 keys of S and the same
// 2 rows x HDV/8 columns of O, all in fp32 from shared memory.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][HD+1]
  float* Kt = Qs + BQ * (HD + 1);          // [HD][BK+1], K transposed
  float* Vs = Kt + HD * (BK + 1);          // [BK][HDV]
  float* Ps = Vs + BK * HDV;               // [BQ][BK+1]
  int* qp_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BQ]
  int* kp_s = qp_s + BQ;                                   // [BK]

  constexpr int CPT = BK / 8;  // columns per thread
  constexpr int DPT = HDV / 8;  // output dims per thread
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;

  attn::load_rows<T, HD, BQ, NT, false>(q, a.sqs, q0, a.S, Qs, HD + 1);
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    qp_s[r] = qi < a.S ? a.qpos[b * a.sqpb + qi * a.sqps] : 0;
  }
  __syncthreads();

  float m[2], l[2], acc[2][DPT];
  int qpr[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * rg + i;
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpr[i] = qp_s[r];
    rvalid[i] = q0 + r < a.S;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (a.T + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BK; c += NT) {
      const int ki = k0 + c;
      kp_s[c] = ki < a.T ? a.kpos[b * a.skpb + ki * a.skpt] : -1;
    }
    __syncthreads();

    // Skip the tile when no kept pair lies in it and every row is alive.
    bool idle = true;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rvalid[i]) continue;
      if (!(m[i] > 0.5f * NEG_INF)) idle = false;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + 8 * j;
        if (k0 + c < a.T && keep(qpr[i], kp_s[c], a.causal, a.window))
          idle = false;
      }
    }
    if (__syncthreads_and(idle)) continue;

    attn::load_rows<T, HD, BK, NT, true>(k, a.skt, k0, a.T, Kt, BK + 1);
    attn::load_rows<T, HDV, BK, NT, false>(v, a.svt, k0, a.T, Vs, HDV);
    __syncthreads();

    float s[2][CPT];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    const float* q0r = Qs + (2 * rg) * (HD + 1);
    const float* q1r = q0r + (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qa = q0r[d], qb = q1r[d];
      const float* kr = Kt + d * (BK + 1) + cg;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kv = kr[8 * j];
        s[0][j] = fmaf(qa, kv, s[0][j]);
        s[1][j] = fmaf(qb, kv, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + 8 * j;
        if (k0 + c < a.T) {
          s[i][j] = keep(qpr[i], kp_s[c], a.causal, a.window)
                        ? s[i][j] * a.scale : NEG_INF;
          mt = fmaxf(mt, s[i][j]);
        } else {
          s[i][j] = -INFINITY;  // past T: not a key at all
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(2 * rg + i) * (BK + 1) + cg + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const float* p0r = Ps + (2 * rg) * (BK + 1);
    const float* p1r = p0r + (BK + 1);
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float pa = p0r[c], pb = p1r[c];
      const float* vr = Vs + c * HDV + cg;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vr[8 * j];
        acc[0][j] = fmaf(pa, vv, acc[0][j]);
        acc[1][j] = fmaf(pb, vv, acc[1][j]);
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int qi = q0 + 2 * rg + i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[qi * a.sos + cg + 8 * j] = from_f<T>(acc[i][j] * inv);
    if (a.lse != nullptr && cg == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.S + qi] =
          m[i] > 0.5f * NEG_INF ? m[i] + logf(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------------
// bf16 inputs: the warp-specialised Hopper kernel.
// One block per (128-row q tile, head, batch): warps 0-7 are two
// consumer warpgroups of 64 query rows each, warp 8 the producer.  The
// producer's lane 0 brings the Q tile in once and K/V tiles of BN keys
// into a STAGES-deep ring by TMA (128-byte swizzle, 64-column boxes; the
// out-of-bounds zero fill pads the head dim to a multiple of 64 and the
// ragged ends of S and T; V at its own padded width HDPV), signalling
// `kfull`/`vfull`; the consumers
// release a stage on `empty` once both of its products are done.  Per
// tile a consumer warpgroup computes S = Q K^T by wgmma (both operands
// in shared memory), masks and runs the online softmax on the fp32
// accumulators in base 2 (scale * log2(e) folded into one multiply),
// and accumulates O += P V by wgmma with P rounded to bf16 in registers
// and V read MN-major from the same swizzled tile.
//
// Mask work is decided per kv tile before the loop, from the range of
// the tile's live key positions against the q tile's live query
// positions: EMPTY (no kept pair: neither loaded nor computed), FULL
// (every pair kept: no mask evaluated) or MIXED (keep() per score).  A
// row that keeps no key anywhere (q_pos < 0, or every key masked) gets
// mean(V) over all T keys, the reference's softmax over uniform NEG_INF
// scores, computed directly at the end; so every EMPTY tile is skipped,
// and a row's scores before its first kept key, which the reference
// weights by exactly 0 after the rescale, are never formed.
namespace wg {

constexpr int BM = 128;                  // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 2;                // K/V ring depth
constexpr uint8_t EMPTY = 0, FULL = 1, MIXED = 2;

// q/k and v head dims padded to a multiple of 64
template <int HDP, int HDPV>
struct Tile {
  static constexpr int BN = HDP <= 128 ? 128 : 64;  // keys per kv tile
  static constexpr int NBOX = HDP / 64;             // TMA boxes per row
  static constexpr int NBOXV = HDPV / 64;           // ... of a V row
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int K_BYTES = BN * HDP * 2;      // one K tile
  static constexpr int V_BYTES = BN * HDPV * 2;     // one V tile
  static constexpr int RING = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // after the ring: barriers (q, then kfull, vfull, empty per stage),
  // q stats, per-warpgroup masked flags, mean(V), then one class byte
  // per kv tile; 1024 bytes of slack align the ring for the swizzle
  static constexpr int TAIL = 8 * (1 + 3 * STAGES) + 16 + 16 + 2 * HDPV * 4;
  static size_t smem_bytes(int ntk) { return 1024 + RING + TAIL + ntk; }
};

__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

template <int HDP, int HDPV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv, Args a) {
  using bf16 = __nv_bfloat16;
  using TL = Tile<HDP, HDPV>;
  constexpr int BN = TL::BN;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* base =
      wg_smem + ((1024 - (attn::smem_addr(wg_smem) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);          // [NBOX][BM][64]
  bf16* Ks = Qs + BM * HDP;                          // [STAGES][NBOX][BN][64]
  bf16* Vs = Ks + STAGES * BN * HDP;                 // [STAGES][NBOXV][BN][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + TL::RING);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;
  int* qstat = reinterpret_cast<int*>(empty + STAGES);  // qmin, qmax, pad
  int* masked = qstat + 4;                              // [2]
  float* meanv = reinterpret_cast<float*>(masked + 4);  // [2][HDPV]
  uint8_t* cls = reinterpret_cast<uint8_t*>(meanv + 2 * HDPV);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.z;
  // causal prefill: the last q tiles keep the most keys, so launch first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvh = h / a.g;
  const int ntk = (a.T + BN - 1) / BN;
  const int* kpos = a.kpos + b * a.skpb;

  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(kfull + s, 1);
      hopper::mbar_init(vfull + s, 1);
      hopper::mbar_init(empty + s, CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
    qstat[0] = INT_MAX;
    qstat[1] = INT_MIN;
    qstat[2] = 0;
    masked[0] = masked[1] = 0;
  }
  __syncthreads();
  if (tid == CONSUMERS) {  // the producer brings Q in during the scan
    hopper::mbar_expect_tx(qbar, TL::Q_BYTES);
    for (int c = 0; c < TL::NBOX; ++c)
      hopper::tma_load_4d(Qs + c * BM * 64, &tmq, qbar, 64 * c, q0, h, b);
  }
  if (tid < BM && q0 + tid < a.S) {
    const int qp = a.qpos[b * a.sqpb + (q0 + tid) * a.sqps];
    if (qp >= 0) {
      atomicMin(qstat, qp);
      atomicMax(qstat + 1, qp);
    } else {
      qstat[2] = 1;
    }
  }
  __syncthreads();
  {
    const int qmin = qstat[0], qmax = qstat[1];
    const bool qpad = qstat[2] != 0;
    for (int j = warp; j < ntk; j += THREADS / 32) {
      int kmin = INT_MAX, kmax = INT_MIN;
      bool hole = false;
      for (int c = lane; c < BN; c += 32) {
        const int t = j * BN + c;
        const int kp = t < a.T ? kpos[t * a.skpt] : -1;
        if (kp >= 0) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
        } else {
          hole = true;
        }
      }
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      kmax = __reduce_max_sync(0xffffffffu, kmax);
      hole = __any_sync(0xffffffffu, hole);
      if (lane == 0) {
        uint8_t c = MIXED;
        if (qmin > qmax || kmin > kmax || (a.causal && kmin > qmax) ||
            (a.window && qmin - kmax >= a.window))
          c = EMPTY;
        else if (!qpad && !hole && (!a.causal || kmax <= qmin) &&
                 (!a.window || qmax - kmin < a.window))
          c = FULL;
        cls[j] = c;
      }
    }
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the K/V ring full
    if (lane == 0) {
      int it = 0;
      for (int j = 0; j < ntk; ++j) {
        if (cls[j] == EMPTY) continue;
        const int s = it % STAGES;
        hopper::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        bf16* kd = Ks + s * BN * HDP;
        bf16* vd = Vs + s * BN * HDPV;
        hopper::mbar_expect_tx(kfull + s, TL::K_BYTES);
        for (int c = 0; c < TL::NBOX; ++c)
          hopper::tma_load_4d(kd + c * BN * 64, &tmk, kfull + s, 64 * c,
                              j * BN, kvh, b);
        hopper::mbar_expect_tx(vfull + s, TL::V_BYTES);
        for (int c = 0; c < TL::NBOXV; ++c)
          hopper::tma_load_4d(vd + c * BN * 64, &tmv, vfull + s, 64 * c,
                              j * BN, kvh, b);
        ++it;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns rows [64 wgi, 64 wgi + 64)
  const int wgi = warp / 4;
  const int r0 = 64 * wgi + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const int c0 = 2 * (lane % 4);
  const float sl2 = a.scale * 1.4426950408889634f;       // scale * log2(e)
  int qpr[2];
  bool rvalid[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    rvalid[i] = qi < a.S;
    qpr[i] = rvalid[i] ? a.qpos[b * a.sqpb + qi * a.sqps] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float o[HDPV / 2], sacc[BN / 2];
#pragma unroll
  for (int i = 0; i < HDPV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
  const bf16* qw = Qs + wgi * 64 * 64;

  hopper::mbar_wait(qbar, 0);
  int it = 0;
  for (int j = 0; j < ntk; ++j) {
    const uint8_t cj = cls[j];
    if (cj == EMPTY) continue;
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    ++it;
    const bf16* ks = Ks + s * BN * HDP;
    const bf16* vs = Vs + s * BN * HDPV;

    // S = Q K^T
    hopper::mbar_wait(kfull + s, parity);
    hopper::fence_regs<BN / 2>(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int box = kk / 4, off = 16 * (kk % 4);
      hopper::Wgmma<BN>::ss(
          sacc, hopper::sw128_desc(qw + box * BM * 64 + off, 16),
          hopper::sw128_desc(ks + box * BN * 64 + off, 16), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs<BN / 2>(sacc);

    // mask (MIXED tiles only) and scale into base 2
    if (cj == FULL) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sacc[i] *= sl2;
    } else {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = j * BN + 8 * nb + c0 + e;
          const int kp = t < a.T ? kpos[t * a.skpt] : -1;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float& x = sacc[4 * nb + 2 * i + e];
            x = t < a.T && keep(qpr[i], kp, a.causal, a.window) ? x * sl2
                                                                : NEG_INF;
          }
        }
    }
    // online softmax per row; rescale O
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
        mt = fmaxf(mt, fmaxf(sacc[4 * nb + 2 * i], sacc[4 * nb + 2 * i + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sacc[4 * nb + 2 * i + e];
          x = exp2f(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int nb = 0; nb < HDPV / 8; ++nb) {
        o[4 * nb + 2 * i] *= alpha;
        o[4 * nb + 2 * i + 1] *= alpha;
      }
    }
    // P as the A operand of O += P V: the accumulator layout of S is the
    // register-fragment layout of A, 16 keys per k step
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = attn::pack_bf16(sacc[8 * kk + 2 * r],
                                    sacc[8 * kk + 2 * r + 1]);

    hopper::mbar_wait(vfull + s, parity);
    hopper::fence_regs<HDPV / 2>(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::Wgmma<HDPV>::rs(o, pa[kk],
                              hopper::sw128_desc(vs + kk * 16 * 64, BN * 128),
                              1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs<HDPV / 2>(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
  }

  // Rows that kept no key: mean(V) over all T keys, once per warpgroup.
  bool none = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) none |= rvalid[i] && !(m[i] > 0.5f * NEG_INF);
  if (__any_sync(0xffffffffu, none) && lane == 0) masked[wgi] = 1;
  bar_sync_wg(1 + wgi);
  float* mv = meanv + wgi * HDPV;
  if (masked[wgi]) {
    const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
    for (int d = tid % 128; d < a.hdv; d += 128) {
      float sum = 0.f;
      for (int t = 0; t < a.T; ++t) sum += __bfloat162float(v[t * a.svt + d]);
      mv[d] = sum / a.T;
    }
    bar_sync_wg(1 + wgi);
  }

  bf16* out = static_cast<bf16*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int qi = q0 + r0 + 8 * i;
    const bool mean = !(m[i] > 0.5f * NEG_INF);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && lane % 4 == 0)   // m, l: base 2, scale folded in
      a.lse[(static_cast<long long>(b) * a.H + h) * a.S + qi] =
          mean ? NEG_INF : (m[i] + log2f(l[i])) * 0.6931471805599453f;
#pragma unroll
    for (int nb = 0; nb < HDPV / 8; ++nb) {
      const int col = 8 * nb + c0;
      if (col >= a.hdv) continue;
      const float x0 = mean ? mv[col] : o[4 * nb + 2 * i] * inv;
      const float x1 = mean ? mv[col + 1] : o[4 * nb + 2 * i + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(out + qi * a.sos + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

}  // namespace wg

template <int HDP, int HDPV>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using TL = wg::Tile<HDP, HDPV>;
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        wg::BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, TL::BN) ||
      !hopper::make_map(&mv, a.v, a.hdv, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, TL::BN))
    return cudaErrorInvalidValue;
  const size_t bytes = TL::smem_bytes((a.T + TL::BN - 1) / TL::BN);
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_fwd_wgmma<HDP, HDPV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, (a.S + wg::BM - 1) / wg::BM, a.B);
  wg::flash_fwd_wgmma<HDP, HDPV><<<grid, wg::THREADS, bytes, stream>>>(
      mq, mk, mv, a);
  return cudaGetLastError();
}

template <typename T, int HD, int HDV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_fwd<T, HD, HDV><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// fp32 inputs take the FMA kernel (no TF32); bf16 inputs the wgmma
// kernel, the head dims padded to a multiple of 64 by the TMA zero fill.
// (hd, hd_v): (hd, hd) at every head dim, and (192, 128).
cudaError_t dispatch(const Args& a, int dtype, cudaStream_t st) {
  if (a.hdv != a.hd) {
    if (a.hd != 192 || a.hdv != 128) return cudaErrorInvalidValue;
    return dtype == 1 ? launch_wgmma<192, 128>(a, st)
                      : launch<float, 192, 128>(a, st);
  }
  if (dtype == 1) {
    switch (a.hd) {
      case 16:
      case 32:
      case 64: return launch_wgmma<64, 64>(a, st);
      case 96:
      case 112: return launch_wgmma<128, 128>(a, st);
      case 128: return launch_wgmma<128, 128>(a, st);
      case 160:
      case 192: return launch_wgmma<192, 192>(a, st);
      case 256: return launch_wgmma<256, 256>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (a.hd) {
    case 16: return launch<float, 16, 16>(a, st);
    case 32: return launch<float, 32, 32>(a, st);
    case 64: return launch<float, 64, 64>(a, st);
    case 96: return launch<float, 96, 96>(a, st);
    case 112: return launch<float, 112, 112>(a, st);
    case 128: return launch<float, 128, 128>(a, st);
    case 160: return launch<float, 160, 160>(a, st);
    case 192: return launch<float, 192, 192>(a, st);
    case 256: return launch<float, 256, 256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, H, Hkv, S, T, hd, hd_v.  strides (elements): q (b,h,s), k
// (b,h,t), v (b,h,t), out (b,h,s), q_pos (b,s), k_pos (b,t); the head
// dimension of q, k, v and out is unit-stride.  lse: null, or a
// contiguous (B,H,S) fp32 output.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* k_pos, void* out, void* lse,
                                   const long long* dims,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.qpos = static_cast<const int*>(q_pos);
  a.kpos = static_cast<const int*>(k_pos);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.S = static_cast<int>(dims[3]);
  a.T = static_cast<int>(dims[4]);
  a.hd = static_cast<int>(dims[5]);
  a.hdv = static_cast<int>(dims[6]);
  a.g = a.H / a.Hkv;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqs = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skt = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svt = strides[8];
  a.sob = strides[9]; a.soh = strides[10]; a.sos = strides[11];
  a.sqpb = strides[12]; a.sqps = strides[13];
  a.skpb = strides[14]; a.skpt = strides[15];
  a.scale = scale; a.causal = causal; a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(a, dtype, st));
}
