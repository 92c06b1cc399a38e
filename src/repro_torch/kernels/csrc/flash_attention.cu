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
// Three kernels, one function.
//
// bf16: two kernels built for Hopper (design notes above each), one
// block per (128-row q tile, head, batch) and two warpgroups of 64 query
// rows; K/V tiles arrive by TMA on mbarriers; S = Q K^T and O += P V run
// on wgmma (fp32 accumulation, P rounded to bf16 as FlashAttention
// does); the softmax runs in base 2; each kv tile is classified up front
// as EMPTY (skipped), FULL (no mask evaluated) or MIXED (masked per
// score); the heaviest causal q tiles launch first.  `flash_fwd_wgmma`
// ("narrow", head dims padded to 64 or 128) adds a producer warp and a
// 2-stage ring of 128-key tiles; `flash_fwd_wide` (padded to 192 or 256,
// and MLA's (192, 128)) has no producer warp, so that its threads may
// hold up to 255 registers, and sizes its tiles to those widths.  The
// tensor maps describe the model's transposed (B,S,H,hd) views in place:
// no copies or transposes, but 16-byte aligned base addresses and
// strides, which the wrapper checks.  Head dims are padded to a multiple
// of 64 (16, 32 and 64 to 64, 96, 112 and 128 to 128, 160 to 192) by the
// TMA zero fill; 192 and 256 need none.  V and O take their own padded
// width: at MLA's (192, 128) the P V product and O's accumulator are 128
// wide.
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
// bytes, at every served shape.  What the narrow kernel leaves on the
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
  static_assert(HDP <= 128, "wider head dims take the wide kernel");
  static constexpr int BN = 128;                    // keys per kv tile
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

// ---------------------------------------------------------------------
// bf16 inputs above a padded 128: the "wide" Hopper kernel, at padded
// (HDP, HDPV) = (192, 192) (hd 160 and 192), (192, 128) (MLA) and (256,
// 256).
// Same function, grid and tile classes as `flash_fwd_wgmma`; laid out
// for the registers and shared memory that those widths need.
//
// Registers.  A consumer thread holds O (HDPV / 2 floats), one tile of
// scores S (BN / 2) and P in bf16 (BN / 4).  At (256, 256) that is 176
// registers before descriptors, addresses and row state, more than the
// 168 that ptxas gives a 288-thread block (the narrow kernel's producer
// warp).  So there is no producer warp: 256 threads,
// `__launch_bounds__(256, 1)`, up to 255 registers a thread.  The K and
// V rings are refilled from inside the loop by whichever consumer warp is
// the last of the eight to be done with a stage (a per-stage count in
// shared memory), with the live tile STAGES on, so neither warpgroup
// waits for the other except through the ring's depth.  Each k step's
// wgmma descriptor is formed where it is issued (`desc_lo`): held across
// the loop, Q's alone took 32 registers.
//
// Overlap (FlashAttention-3's intra-warpgroup pipelining).  A warpgroup
// issues S(t) = Q K(t)^T, then O += P(t-1) V(t-1), waits for S(t) alone
// (`wgmma.wait_group 1`) and runs tile t's softmax in S's registers
// while the P V product is on the tensor cores; only then does it wait
// for that product, round P to bf16 and rescale O.  P kept twice (the
// fragments in flight and the next tile's) ran ptxas short, and it
// serialised every wgmma.  K and V have their own rings, so K(t)'s stage
// is refilled as soon as S(t) is formed, and V's a tile later.
//
// Tiles.  BN keys a tile, 2 stages deep, to fit 227 KB (`Layout`):
// (256, 256) 64 keys, 2 stages (192 KB); (192, 128) 128 keys, 2 stages
// (208 KB); (192, 192) 96 keys, 2 stages (192 KB).  hd 160 runs as 192:
// S over its true 10 k steps of 16 was no faster.  The alternatives
// measured, in PERF.md §6: no overlap, FlashAttention-3's ping-pong
// between the warpgroups, 64 keys x 3 stages at (192, 192), 64 x 3 and
// 96 x 2 at (192, 128), key positions read from global memory.
//
// Order.  Under the causal mask the last q tiles keep the most keys and
// launch first.  Once the K/V of a sequence's heads outgrow L2 (MLA's
// 128 heads: 164 MB at 2000 tokens), heads go in chunks of about one
// block per SM, each chunk's q tiles heaviest first, so that the blocks
// in flight read K/V from L2 rather than device memory.
//
// Masks.  The live (non-EMPTY) tiles are listed once, in order, with
// their classes; a MIXED tile's key positions are staged per warp in
// shared memory (one coalesced read a tile) while the products run.
// The softmax runs in base 2 on `ex2.approx`.
namespace wide {

using bf16 = __nv_bfloat16;
using wg::EMPTY;
using wg::FULL;
using wg::MIXED;

constexpr int BM = 128;             // query rows per block
constexpr int THREADS = 256;        // two warpgroups of 64 rows
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;           // K and V ring depth

// The class of a kv tile for a q tile, from the live query positions
// [qmin, qmax] (qpad: a live row has q_pos < 0) and the tile's live key
// positions [kmin, kmax] (hole: a key is masked or past T).
__device__ __forceinline__ uint8_t tile_class(int qmin, int qmax, bool qpad,
                                              int kmin, int kmax, bool hole,
                                              int causal, int window) {
  if (qmin > qmax || kmin > kmax || (causal && kmin > qmax) ||
      (window && qmin - kmax >= window))
    return EMPTY;
  if (!qpad && !hole && (!causal || kmax <= qmin) &&
      (!window || qmax - kmin < window))
    return FULL;
  return MIXED;
}

// q/k rows at the padded head dim HDP, V and O at the padded HDPV; BN
// keys a tile.
template <int HDP, int HDPV, int BN>
struct Layout {
  static constexpr int NBOX = HDP / 64;    // TMA boxes per q/k row
  static constexpr int NBOXV = HDPV / 64;  // ... of a V row
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int K_BYTES = BN * HDP * 2;
  static constexpr int V_BYTES = BN * HDPV * 2;
  static constexpr int RING = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // after the ring (byte offsets): a row of BN key positions per warp,
  // mean(V) per warpgroup, the barriers (q; K full, V full per stage),
  // the K and V release counts per stage, the block's stats (q min, q
  // max, a padded row, live tiles, masked rows per warpgroup); then one
  // int per kv tile: its class, then the live tiles' list
  static constexpr int POS = RING;
  static constexpr int MEANV = POS + WARPS * BN * 4;
  static constexpr int BARS = MEANV + 2 * HDPV * 4;
  static constexpr int COUNTS = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int STATS = COUNTS + 4 * 2 * STAGES;
  static constexpr int TILES = STATS + 4 * 8;
  static size_t smem_bytes(int ntk) { return 1024 + TILES + 4 * ntk; }
  // a consumer thread's registers across a tile: S, P, O
  static constexpr int REGS = BN / 2 + BN / 4 + HDPV / 2;
  static_assert(BN % 32 == 0 && REGS <= 176,
                "a wide tile must leave registers for addresses and rows");
};

// A swizzled tile's descriptor as its low word (start address and
// leading byte offset; k steps add to the address field, which does not
// carry) and the high word, which is the same for every tile.  The low
// word is made opaque where a product is issued, so that ptxas forms
// each k step's descriptor there instead of holding all of them (Q's are
// loop-invariant) in registers across the loop.
__device__ __forceinline__ uint32_t desc_lo(const void* p, uint32_t lbo) {
  uint32_t lo = static_cast<uint32_t>(hopper::sw128_desc(p, lbo));
  asm volatile("" : "+r"(lo));
  return lo;
}
__device__ __forceinline__ uint64_t desc(uint32_t lo, int elems) {
  constexpr uint64_t HI = static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
  return HI | (lo + elems / 8);
}

// S (64 x BN) = Q K^T over depth HDP, issued by one warpgroup: its 64 Q
// rows and the tile's BN keys K-major in swizzled 64-column boxes.
template <int HDP, int BN>
__device__ __forceinline__ void s_product(float* sacc, const bf16* qw,
                                          const bf16* ks) {
  const uint32_t qa = desc_lo(qw, 16), ka = desc_lo(ks, 16);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int box = kk / 4, off = 16 * (kk % 4);
    const uint64_t da = desc(qa, box * BM * 64 + off);
    const uint64_t db = desc(ka, box * BN * 64 + off);
    if (kk == 0)
      hopper::Wgmma<BN>::ss_zero(sacc, da, db);
    else
      hopper::Wgmma<BN>::ss(sacc, da, db, 1);
  }
  hopper::wgmma_commit();
}

// O (64 x HDPV) += P V: P as register fragments (4 a k step of 16 keys),
// V MN-major from the same swizzled tile.
template <int HDPV, int BN>
__device__ __forceinline__ void pv_product(float* o, const uint32_t* p,
                                           const bf16* vs) {
  const uint32_t va = desc_lo(vs, BN * 128);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    hopper::Wgmma<HDPV>::rs(o, p + 4 * kk, desc(va, kk * 16 * 64), 1);
  hopper::wgmma_commit();
}

// The positions of keys [k0, k0 + BN), -1 at or past T, into this warp's
// shared-memory row w: coalesced reads, then each lane reads its columns.
template <int BN>
__device__ __forceinline__ void stage_pos(const int* kpos, long long st,
                                          int k0, int T, int lane, int* w) {
  __syncwarp();  // the previous tile's readers are done
#pragma unroll
  for (int c = lane; c < BN; c += 32)
    w[c] = k0 + c < T ? kpos[(k0 + c) * st] : -1;
  __syncwarp();
}

// One tile's online softmax in base 2 (scale * log2(e) folded in), in
// place: masks a MIXED tile from its staged key positions w, updates each
// row's max m and sum l, gives O's rescale alpha per row and leaves P in
// the scores' registers.
template <int BN>
__device__ __forceinline__ void softmax_tile(float* sacc, float* m, float* l,
                                             float* alpha, bool mixed,
                                             const int* w, const int* qpr,
                                             int c0, float sl2, int causal,
                                             int window) {
  if (!mixed) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] *= sl2;
  } else {
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = w[8 * nb + c0 + e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = sacc[4 * nb + 2 * i + e];
          x = keep(qpr[i], kp, causal, window) ? x * sl2 : NEG_INF;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mt = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
      mt = fmaxf(mt, fmaxf(sacc[4 * nb + 2 * i], sacc[4 * nb + 2 * i + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[i], mt);
    alpha[i] = hopper::fast_exp2(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sacc[4 * nb + 2 * i + e];
        x = hopper::fast_exp2(x - m_new);
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[i] = l[i] * alpha[i] + rs;
    m[i] = m_new;
  }
}

// P rounded to bf16 as the A fragments of O += P V (S's accumulator
// layout is A's register fragment layout, 16 keys a k step), and O
// rescaled by alpha per row.
template <int BN, int HDPV>
__device__ __forceinline__ void to_operand(const float* sacc, uint32_t* p,
                                           float* o, const float* alpha) {
#pragma unroll
  for (int x = 0; x < BN / 4; ++x)
    p[x] = attn::pack_bf16(sacc[2 * x], sacc[2 * x + 1]);
#pragma unroll
  for (int nb = 0; nb < HDPV / 8; ++nb)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[4 * nb + x] *= alpha[x / 2];
}

template <int HDP, int HDPV, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wide(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, Args a,
                   int hchunk) {
  using L = Layout<HDP, HDPV, BN>;
  extern __shared__ unsigned char wide_smem[];
  unsigned char* base =
      wide_smem + ((1024 - (attn::smem_addr(wide_smem) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [NBOX][BM][64]
  bf16* Ks = Qs + BM * HDP;                  // [STAGES][NBOX][BN][64]
  bf16* Vs = Ks + STAGES * BN * HDP;         // [STAGES][NBOXV][BN][64]
  int* pos_s = reinterpret_cast<int*>(base + L::POS);        // [WARPS][BN]
  float* meanv = reinterpret_cast<float*>(base + L::MEANV);  // [2][HDPV]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  unsigned* kdone = reinterpret_cast<unsigned*>(base + L::COUNTS);
  unsigned* vdone = kdone + STAGES;
  int* stat = reinterpret_cast<int*>(base + L::STATS);
  int* tiles = reinterpret_cast<int*>(base + L::TILES);  // [ntk]
  const CUtensorMap *mk = &tmk, *mv = &tmv;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Block order: per batch, the heads in chunks of hchunk, and within a
  // chunk the q tiles from the last (under the causal mask the heaviest)
  // to the first, head fastest; the blocks in flight then share the K/V
  // of a few heads in L2.
  const int nq = (a.S + BM - 1) / BM;
  const int b = blockIdx.x / (nq * a.H);
  int r = blockIdx.x % (nq * a.H);
  const int chunk = r / (nq * hchunk);
  const int gc = min(hchunk, a.H - chunk * hchunk);
  r -= chunk * nq * hchunk;
  const int h = chunk * hchunk + r % gc;
  const int q0 = (nq - 1 - r / gc) * BM;
  const int kvh = h / a.g;
  const int ntk = (a.T + BN - 1) / BN;
  const int* kpos = a.kpos + b * a.skpb;

  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(kfull + s, 1);
      hopper::mbar_init(vfull + s, 1);
      kdone[s] = vdone[s] = 0;
    }
    hopper::mbar_fence_init();
    stat[0] = INT_MAX;
    stat[1] = INT_MIN;
    stat[2] = 0;
    stat[4] = stat[5] = 0;
    // Q comes in during the scan
    hopper::mbar_expect_tx(qbar, L::Q_BYTES);
    for (int c = 0; c < L::NBOX; ++c)
      hopper::tma_load_4d(Qs + c * BM * 64, &tmq, qbar, 64 * c, q0, h, b);
  }
  __syncthreads();
  if (tid < BM && q0 + tid < a.S) {
    const int qp = a.qpos[b * a.sqpb + (q0 + tid) * a.sqps];
    if (qp >= 0) {
      atomicMin(stat, qp);
      atomicMax(stat + 1, qp);
    } else {
      stat[2] = 1;
    }
  }
  __syncthreads();
  for (int j = warp; j < ntk; j += WARPS) {
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
    if (lane == 0)
      tiles[j] = tile_class(stat[0], stat[1], stat[2] != 0, kmin, kmax,
                            hole, a.causal, a.window);
  }
  __syncthreads();
  if (warp == 0) {
    // the live tiles in order, as 4 * index + class, over the classes
    // (a chunk of 32 is read before any of it is written)
    int n = 0;
    for (int j0 = 0; j0 < ntk; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < ntk ? tiles[j] : EMPTY;
      const unsigned live = __ballot_sync(0xffffffffu, c != EMPTY);
      if (c != EMPTY) tiles[n + __popc(live & ((1u << lane) - 1))] = 4 * j + c;
      n += __popc(live);
    }
    if (lane == 0) stat[3] = n;
  }
  __syncthreads();
  const int nlive = stat[3];

  auto load_k = [&](int t) {
    const int s = t % STAGES, k0 = (tiles[t] >> 2) * BN;
    bf16* kd = Ks + s * BN * HDP;
    hopper::mbar_expect_tx(kfull + s, L::K_BYTES);
    for (int c = 0; c < L::NBOX; ++c)
      hopper::tma_load_4d(kd + c * BN * 64, mk, kfull + s, 64 * c, k0, kvh,
                          b);
  };
  auto load_v = [&](int t) {
    const int s = t % STAGES, k0 = (tiles[t] >> 2) * BN;
    bf16* vd = Vs + s * BN * HDPV;
    hopper::mbar_expect_tx(vfull + s, L::V_BYTES);
    for (int c = 0; c < L::NBOXV; ++c)
      hopper::tma_load_4d(vd + c * BN * 64, mv, vfull + s, 64 * c, k0, kvh,
                          b);
  };
  if (tid == 0)
    for (int t = 0; t < STAGES && t < nlive; ++t) {
      load_k(t);
      load_v(t);
    }
  // This warp is done with live tile t's K (V): the last of the eight
  // warps to be done refills the stage with tile t + STAGES.
  auto done_k = [&](int t) {
    __syncwarp();
    if (lane == 0 && atomicAdd(kdone + t % STAGES, 1u) % WARPS == WARPS - 1 &&
        t + STAGES < nlive)
      load_k(t + STAGES);
    __syncwarp();
  };
  auto done_v = [&](int t) {
    __syncwarp();
    if (lane == 0 && atomicAdd(vdone + t % STAGES, 1u) % WARPS == WARPS - 1 &&
        t + STAGES < nlive)
      load_v(t + STAGES);
    __syncwarp();
  };

  // ---- warpgroup wgi owns rows [64 wgi, 64 wgi + 64)
  const int wgi = warp / 4;
  const int r0 = 64 * wgi + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const int c0 = 2 * (lane % 4);
  const float sl2 = a.scale * 1.4426950408889634f;       // scale * log2(e)
  int qpr[2];
  bool rvalid[2];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    rvalid[i] = qi < a.S;
    qpr[i] = rvalid[i] ? a.qpos[b * a.sqpb + qi * a.sqps] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float o[HDPV / 2], sacc[BN / 2];
  uint32_t pa[BN / 4];  // P of the P V product
#pragma unroll
  for (int i = 0; i < HDPV / 2; ++i) o[i] = 0.f;
  const bf16* qw = Qs + wgi * 64 * 64;
  int* pw = pos_s + warp * BN;
  auto kstage = [&](int t) {
    hopper::mbar_wait(kfull + t % STAGES, (t / STAGES) & 1);
    return Ks + (t % STAGES) * BN * HDP;
  };
  auto vstage = [&](int t) {
    hopper::mbar_wait(vfull + t % STAGES, (t / STAGES) & 1);
    return Vs + (t % STAGES) * BN * HDPV;
  };
  // stage tile t's key positions if it is MIXED; whether it is
  auto mixed = [&](int t) {
    const int tv = tiles[t];
    if ((tv & 3) != MIXED) return false;
    stage_pos<BN>(kpos, a.skpt, (tv >> 2) * BN, a.T, lane, pw);
    return true;
  };

  hopper::mbar_wait(qbar, 0);
  if (nlive > 0) {
    s_product<HDP, BN>(sacc, qw, kstage(0));
    bool mx = mixed(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BN / 2>(sacc);
    done_k(0);
    softmax_tile<BN>(sacc, m, l, alpha, mx, pw, qpr, c0, sl2, a.causal,
                     a.window);
    to_operand<BN, HDPV>(sacc, pa, o, alpha);
    for (int t = 1; t < nlive; ++t) {
      s_product<HDP, BN>(sacc, qw, kstage(t));
      pv_product<HDPV, BN>(o, pa, vstage(t - 1));
      mx = mixed(t);
      hopper::wgmma_wait<1>();  // S(t); P V runs on under the softmax
      hopper::fence_regs<BN / 2>(sacc);
      done_k(t);
      softmax_tile<BN>(sacc, m, l, alpha, mx, pw, qpr, c0, sl2, a.causal,
                       a.window);
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HDPV / 2>(o);
      hopper::fence_regs<BN / 4>(pa);
      done_v(t - 1);
      to_operand<BN, HDPV>(sacc, pa, o, alpha);
    }
    pv_product<HDPV, BN>(o, pa, vstage(nlive - 1));
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HDPV / 2>(o);
    hopper::fence_regs<BN / 4>(pa);
    done_v(nlive - 1);
  }

  // Rows that kept no key: mean(V) over all T keys, once per warpgroup.
  bool none = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) none |= rvalid[i] && !(m[i] > 0.5f * NEG_INF);
  if (__any_sync(0xffffffffu, none) && lane == 0) stat[4 + wgi] = 1;
  hopper::named_sync(1 + wgi, 128);
  float* mvw = meanv + wgi * HDPV;
  if (stat[4 + wgi]) {
    const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
    for (int d = tid % 128; d < a.hdv; d += 128) {
      float sum = 0.f;
      for (int t = 0; t < a.T; ++t) sum += __bfloat162float(v[t * a.svt + d]);
      mvw[d] = sum / a.T;
    }
    hopper::named_sync(1 + wgi, 128);
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
      const float x0 = mean ? mvw[col] : o[4 * nb + 2 * i] * inv;
      const float x1 = mean ? mvw[col + 1] : o[4 * nb + 2 * i + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(out + qi * a.sos + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// Keys a tile at each width, chosen by measurement (PERF.md §6).
template <int HDP, int HDPV> constexpr int TILE_KEYS = 96;  // (192, 192)
template <> constexpr int TILE_KEYS<256, 256> = 64;
template <> constexpr int TILE_KEYS<192, 128> = 128;

}  // namespace wide

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

template <int HDP, int HDPV>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  constexpr int BN = wide::TILE_KEYS<HDP, HDPV>;
  using L = wide::Layout<HDP, HDPV, BN>;
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        wide::BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, BN) ||
      !hopper::make_map(&mv, a.v, a.hdv, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, BN))
    return cudaErrorInvalidValue;
  const size_t bytes = L::smem_bytes((a.T + BN - 1) / BN);
  auto kernel = wide::flash_fwd_wide<HDP, HDPV, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // Heads go in chunks of about one block per SM (whole GQA groups) once
  // the K/V of a sequence's heads outgrow L2 (MLA's 128 heads: 164 MB at
  // 2000 tokens); below that, one chunk.
  int dev = 0, sms = 0, l2 = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  const int nq = (a.S + wide::BM - 1) / wide::BM;
  const long long kv = 2ll * a.Hkv * a.T * (a.hd + a.hdv);
  const int per = (sms + nq - 1) / nq;
  const int hchunk = kv > l2 ? min(a.H, (per + a.g - 1) / a.g * a.g) : a.H;
  kernel<<<nq * a.H * a.B, wide::THREADS, bytes, stream>>>(mq, mk, mv, a,
                                                           hchunk);
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
// kernels, the head dims padded to a multiple of 64 by the TMA zero fill:
// the narrow one up to 128, the wide one above.  (hd, hd_v): (hd, hd) at
// every head dim, and (192, 128).
cudaError_t dispatch(const Args& a, int dtype, cudaStream_t st) {
  if (a.hdv != a.hd) {
    if (a.hd != 192 || a.hdv != 128) return cudaErrorInvalidValue;
    return dtype == 1 ? launch_wide<192, 128>(a, st)
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
      case 192: return launch_wide<192, 192>(a, st);
      case 256: return launch_wide<256, 256>(a, st);
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

// Which kernel takes head dim hd: 0 = the scalar FMA kernel (fp32), 1 =
// the narrow wgmma kernel (bf16 up to a padded 128), 2 = the wide one
// (bf16 above it).
extern "C" int flash_attention_fwd_route(int dtype, int hd) {
  if (dtype != 1) return 0;
  return hd > 128 ? 2 : 1;
}

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
