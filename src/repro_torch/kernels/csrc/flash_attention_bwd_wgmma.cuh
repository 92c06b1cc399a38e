// Prefill flash attention backward on Hopper's tensor cores (sm_90a):
// bf16 inputs at padded head dims 64 and 128 (hd 16, 32, 64, 112, 128; the
// TMA zero fill pads the rest).  Included by flash_attention_bwd_bf16.cu,
// whose entry point routes those head dims here and 160, 192 and 256 to
// the scalar kernels of flash_attention_bwd.cuh (a dispatch by shape, not
// a fallback).
//
// Replaces what the JAX package gets from XLA's autodiff of its jnp
// attention, `_attend` / `blockwise_attention` in
// src/repro/models/attention.py:118-178.  Same function as the scalar
// kernels and as `ref.flash_attention_bwd_ref`: P = exp(scale Q K^T - lse)
// on kept pairs, dV = P^T dO, dP = dO V^T, D = rowsum(dO o O),
// dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q summed over each
// GQA group; a row that kept no key (lse = NEG_INF) puts P = 1/T into dV
// and has dS = 0.
//
// Bound.  5 products of 2 * (kept pairs) * hd FLOPs (S and dP, dV, dK,
// dQ) against 989 TFLOP/s bf16 on an H100 SXM: 0.1955 ms at StarCoder2-
// 7B's trained shape (B 2, H 36, Hkv 4, S = T = 2048, hd 128, causal).
// This design runs 7 (S and dP are formed once for dK/dV and once for
// dQ), 0.2737 ms: the price of writing dQ without atomics, so the bits
// repeat from run to run (FlashAttention-3 accumulates dQ with fp32
// atomics instead).  Operations, not bytes, at every trained shape.
//
// Registers shape the design.  ptxas gives a block of 288 threads (two
// consumer warpgroups and a producer warp) 168 registers a thread, and
// setmaxnreg did not raise what it allocates in the consumers' code (it
// spilled at the same 168, and then serialised every wgmma); a wgmma's
// accumulator and A fragments must sit in contiguous registers.  So no
// thread holds more than one 64 x HDP accumulator (64 registers at hd
// 128) and one 64 x 64 tile of scores (32).
//
// Four launches, no atomics:
//   `bwd_prep`: per row, D = rowsum(dO o O) and lse2 = lse * log2(e) in
//     fp32, into (B, H, spad) buffers padded to 128 rows; a row that kept
//     no key, and every padding row, gets lse2 = +inf, so that
//     P = exp2(s - lse2) is exactly 0 there with no mask evaluated.
//   `bwd_deadsum`: per (b, h), the fp32 sum of dO over the rows that kept
//     no key, rows in a fixed order.  The dK/dV epilogue adds 1/T of it
//     to every key's dV, so the main loops treat those rows as masked and
//     skip query tiles by position ranges alone.
//   `bwd_dkdv_wgmma`: one block per (64-key tile, kv head, batch), which
//     walks its GQA group's g query heads in head order and writes bf16
//     dK (scaled) and dV itself: no fp32 partials, no second pass.  K and
//     V come in once by TMA; 64-row Q and dO tiles of each head, with
//     their lse2 and D, stream through a 2-stage mbarrier ring filled by
//     the producer warp.  Keys are the wgmma M dimension and the two
//     consumer warpgroups split the work by role over the same keys:
//     warpgroup 0 forms S^T = K Q^T, P^T (rounded to bf16 as
//     FlashAttention does, as the A fragment of) dV += P^T dO; warpgroup
//     1 forms dP^T = V dO^T and dS^T = P^T o (dP^T - D), from warpgroup
//     0's fp32 P^T passed through a double-buffered shared-memory slab
//     under named barriers, and dK += dS^T Q.  S^T and dP^T read both
//     operands from shared memory (SS); the dV and dK products read dO
//     and Q MN-major from the same swizzled tiles (RS, 64 columns a
//     product).  lse2 and D are per column here.  Query tiles are
//     classified per key tile, as the forward classifies kv tiles: EMPTY
//     tiles are never loaded, FULL tiles evaluate no mask, MIXED tiles
//     read their positions from a per-warp staged row.  The first key
//     tiles (the most queries under the causal mask) launch first.
//   `bwd_dq_wgmma`: shaped like the forward: one block per (128-row query
//     tile, head, batch), two consumer warpgroups of 64 rows and the
//     producer warp.  Q and dO stay resident; 64-key K and V tiles stream
//     through the ring, classified EMPTY/FULL/MIXED; S = Q K^T and
//     dP = dO V^T (SS) are issued together, P goes to the thread's fp32
//     slab while dP forms, then dS in bf16 and dQ += dS K with K read
//     MN-major (RS).  The last query tiles launch first.
//
// What it leaves on the table: no ping-pong between warpgroups beyond
// what the role split gives, and no overlap of a tile's exponentials
// with the next tile's products; 7 products instead of 5; 64-key dK/dV
// blocks, so every key tile streams its Q and dO tiles from L2 (about
// 1.25 GB at the trained shape); hd 112 padded to 128 in the products;
// a grid of B * Hkv * T / 64 blocks, so a short sequence with few kv
// heads leaves SMs idle (256 blocks at the trained shape).
#pragma once

#include <limits.h>
#include <math.h>

#include "attention_common.cuh"
#include "flash_attention_bwd.cuh"
#include "hopper.cuh"

namespace {
namespace bwg {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 2;                // ring depth
constexpr int KV_BN = 64;   // dK/dV: keys per block
constexpr int KV_BM = 64;   // dK/dV: query rows per streamed tile
constexpr int Q_BM = 128;   // dQ: query rows per block
constexpr int Q_BN = 64;    // dQ: keys per streamed tile
constexpr int ROW_PAD = 128;  // lse2 and D rows: padded to a multiple
constexpr uint8_t EMPTY = 0, FULL = 1, MIXED = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The kernels' arguments: the scalar route's, and the scratch of this
// one (fp32, carved from the buffer the wrapper allocates): lse2 and D
// (B, H, spad), the dead rows' dO sums (B, H, padded hd).
struct WArgs : Args {
  float* lse2;
  float* dpad;
  float* dead;
  int spad;
};

// The scratch, as byte offsets into one buffer.
struct Scratch {
  long long lse2, dpad, dead, bytes;
};

inline long long up256(long long x) { return (x + 255) / 256 * 256; }
inline int padded_hd(int hd) { return hd <= 64 ? 64 : 128; }
inline int padded_rows(int S) { return (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD; }

inline Scratch scratch_layout(int B, int H, int S, int hd) {
  const long long rows = up256(4ll * B * H * padded_rows(S));
  Scratch s;
  s.lse2 = 0;
  s.dpad = rows;
  s.dead = 2 * rows;
  s.bytes = s.dead + up256(4ll * B * H * padded_hd(hd));
  return s;
}

// min and max of the positions >= 0 among pos[i * st], i in
// [i0, min(i0 + n, end)), and whether one of them is < 0; one warp.
__device__ __forceinline__ void warp_range(const int* pos, long long st,
                                           int i0, int n, int end, int lane,
                                           int& lo, int& hi, bool& hole) {
  lo = INT_MAX;
  hi = INT_MIN;
  hole = false;
  for (int c = lane; c < n; c += 32) {
    const int i = i0 + c;
    if (i >= end) continue;
    const int p = pos[i * st];
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      hole = true;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  hole = __any_sync(0xffffffffu, hole);
}

// The positions of a 64-row tile, staged for a warp in its shared-memory
// row w: w[c] = pos[(i0 + c) * st], -1 at or past end.  Two coalesced
// loads a tile, and each lane then reads its columns with one address.
__device__ __forceinline__ void stage_pos(const int* pos, long long st,
                                          int i0, int end, int lane, int* w) {
  __syncwarp();  // the previous tile's readers are done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 32 * h + lane;
    w[32 * h + lane] = i < end ? pos[i * st] : -1;
  }
  __syncwarp();
}

// The class of a (query tile, key tile) pair from the live positions of
// each (q in [qlo, qhi], k in [klo, khi]) and whether the key tile holds a
// masked key.  Query rows with q_pos < 0 need no mask: they kept no key,
// and their lse2 = +inf makes P = 0.  Keys past T need none in dK/dV,
// whose rows past T are not stored; dQ marks them as a hole.
__device__ __forceinline__ uint8_t classify(int qlo, int qhi, int klo,
                                            int khi, bool khole, int causal,
                                            int window) {
  if (qlo > qhi || klo > khi || (causal && klo > qhi) ||
      (window && qlo - khi >= window))
    return EMPTY;
  if (!khole && (!causal || khi <= qlo) && (!window || qhi - klo < window))
    return FULL;
  return MIXED;
}

// ------------------------------------------------------------ prepasses
// Half a warp a row of (B, H, spad), 16 bytes of dO and O a lane:
// D = rowsum(dO o O) and lse2, as above.
__global__ void __launch_bounds__(256) bwd_prep(WArgs a) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.spad;
  const long long row = static_cast<long long>(blockIdx.x) * 16 +
                        threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  float acc = 0.f, l2 = INFINITY;
  const int s = static_cast<int>(row % a.spad);
  const long long bh = row / a.spad;
  if (row < rows && s < a.S) {
    const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
    const bf16* o = static_cast<const bf16*>(a.o) + b * a.sob + h * a.soh +
                    s * a.sos;
    const bf16* d = static_cast<const bf16*>(a.dout) + b * a.sdob +
                    h * a.sdoh + s * a.sdos;
    for (int c = 8 * l; c < a.hd; c += 128) {
      float x[8], y[8];
      attn::Vec16<bf16>::widen(*reinterpret_cast<const uint4*>(d + c), x);
      attn::Vec16<bf16>::widen(*reinterpret_cast<const uint4*>(o + c), y);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
    }
    const float lse = a.lse[bh * a.S + s];
    if (!no_key(lse)) l2 = lse * LOG2E;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && l == 0) {
    a.dpad[row] = acc;
    a.lse2[row] = l2;
  }
}

// One block of 8 warps per (h, b): dead[b, h, :HDP] = the sum of dO over
// the rows that kept no key (0 past hd).  Warp w takes rows 32 w + 256 i
// + lane's 32-row groups and adds their dead rows in row order; the 8
// warps' sums are added in warp order.
template <int HDP>
__global__ void __launch_bounds__(256) bwd_deadsum(WArgs a) {
  __shared__ float part[8][HDP];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdob +
                     h * a.sdoh;
  float acc[HDP / 32];
#pragma unroll
  for (int j = 0; j < HDP / 32; ++j) acc[j] = 0.f;
  for (int s0 = 32 * warp; s0 < a.S; s0 += 256) {
    const int s = s0 + lane;
    unsigned m = __ballot_sync(0xffffffffu,
                               s < a.S && no_key(a.lse[bh * a.S + s]));
    while (m) {
      const int r = s0 + __ffs(m) - 1;
      m &= m - 1;
#pragma unroll
      for (int j = 0; j < HDP / 32; ++j) {
        const int col = lane + 32 * j;
        if (col < a.hd) acc[j] += __bfloat162float(dout[r * a.sdos + col]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < HDP / 32; ++j) part[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < HDP; c += 256) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += part[w][c];
    a.dead[bh * HDP + c] = sum;
  }
}

// ------------------------------------------------------------ dK and dV
template <int HDP>
struct KvTile {
  static constexpr int NBOX = HDP / 64;
  static constexpr int KV_BYTES = KV_BN * HDP * 2;  // K or V
  static constexpr int QT_BYTES = KV_BM * HDP * 2;  // a Q or dO tile
  static constexpr int RING = 2 * KV_BYTES + STAGES * 2 * QT_BYTES;
  static constexpr int STAT_BYTES = 2 * KV_BM * 4;  // a tile's lse2 and D
  static constexpr int P_BYTES = 2 * 128 * 32 * 4;  // P^T, two buffers
  // after the ring: the P^T buffers, lse2 and D per stage, a row of 64
  // query positions per warp of warpgroup 0, the barriers (kv, full and
  // empty per stage), the key tile's stats, then one class byte per
  // query tile; 1024 bytes of slack align the ring for the swizzle
  static constexpr int TAIL = P_BYTES + STAGES * STAT_BYTES + 4 * 64 * 4 +
                              8 * (1 + 2 * STAGES) + 16;
  static size_t smem_bytes(int nqt) { return 1024 + RING + TAIL + nqt; }
};

// Named barriers between the two consumer warpgroups (id 0 is
// __syncthreads): P^T buffer b written (P_FULL + b) and read (P_FREE + b).
constexpr int P_FULL = 1, P_FREE = 3;

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmdo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, WArgs a) {
  using TL = KvTile<HDP>;
  extern __shared__ unsigned char kv_smem[];
  unsigned char* base =
      kv_smem + ((1024 - (attn::smem_addr(kv_smem) & 1023)) & 1023);
  bf16* Ks = reinterpret_cast<bf16*>(base);    // [NBOX][KV_BN][64]
  bf16* Vs = Ks + KV_BN * HDP;                 // [NBOX][KV_BN][64]
  bf16* Qs = Vs + KV_BN * HDP;                 // [STAGES][NBOX][KV_BM][64]
  bf16* dOs = Qs + STAGES * KV_BM * HDP;       // [STAGES][NBOX][KV_BM][64]
  float* P_s = reinterpret_cast<float*>(base + TL::RING);  // [2][32][128]
  float* lse_s = P_s + 2 * 32 * 128;                       // [STAGES][BM]
  float* D_s = lse_s + STAGES * KV_BM;                     // [STAGES][BM]
  int* pos_s = reinterpret_cast<int*>(D_s + STAGES * KV_BM);  // [4][64]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(pos_s + 4 * 64);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  int* kstat = reinterpret_cast<int*>(empty + STAGES);  // lo, hi, hole
  uint8_t* cls = reinterpret_cast<uint8_t*>(kstat + 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * KV_BN;  // the first key tiles launch first
  const int kvh = blockIdx.x, h0 = kvh * a.g;  // the group's heads
  const int nqt = (a.S + KV_BM - 1) / KV_BM;
  const int* kpos = a.kpos + b * a.skpb;
  const int* qpos = a.qpos + b * a.sqpb;

  if (tid == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  if (warp == 0) {
    int lo, hi;
    bool hole;
    warp_range(kpos, a.skpt, k0, KV_BN, a.T, lane, lo, hi, hole);
    if (lane == 0) {
      kstat[0] = lo;
      kstat[1] = hi;
      kstat[2] = hole;
    }
  }
  __syncthreads();
  for (int j = warp; j < nqt; j += THREADS / 32) {
    int lo, hi;
    bool hole;
    warp_range(qpos, a.sqps, j * KV_BM, KV_BM, a.S, lane, lo, hi, hole);
    if (lane == 0)
      cls[j] = classify(lo, hi, kstat[0], kstat[1], kstat[2] != 0, a.causal,
                        a.window);
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer warp: one thread keeps the ring full
    if (lane == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * TL::KV_BYTES);
      for (int c = 0; c < TL::NBOX; ++c) {
        hopper::tma_load_4d(Ks + c * KV_BN * 64, &tmk, kvbar, 64 * c, k0,
                            kvh, b);
        hopper::tma_load_4d(Vs + c * KV_BN * 64, &tmv, kvbar, 64 * c, k0,
                            kvh, b);
      }
      int it = 0;
      for (int h = h0; h < h0 + a.g; ++h) {
        const long long row0 = (static_cast<long long>(b) * a.H + h) * a.spad;
        for (int j = 0; j < nqt; ++j) {
          if (cls[j] == EMPTY) continue;
          const int s = it % STAGES;
          hopper::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          bf16* qd = Qs + s * KV_BM * HDP;
          bf16* dod = dOs + s * KV_BM * HDP;
          hopper::mbar_expect_tx(full + s,
                                 2 * TL::QT_BYTES + TL::STAT_BYTES);
          for (int c = 0; c < TL::NBOX; ++c) {
            hopper::tma_load_4d(qd + c * KV_BM * 64, &tmq, full + s, 64 * c,
                                j * KV_BM, h, b);
            hopper::tma_load_4d(dod + c * KV_BM * 64, &tmdo, full + s,
                                64 * c, j * KV_BM, h, b);
          }
          hopper::bulk_load(lse_s + s * KV_BM, a.lse2 + row0 + j * KV_BM,
                            KV_BM * 4, full + s);
          hopper::bulk_load(D_s + s * KV_BM, a.dpad + row0 + j * KV_BM,
                            KV_BM * 4, full + s);
          ++it;
        }
      }
    }
    return;
  }

  // ---- consumers: both warpgroups hold the block's 64 keys as rows.
  // Warpgroup 0 forms S^T = K Q^T and P^T, and accumulates dV += P^T dO;
  // warpgroup 1 forms dP^T = V dO^T and dS^T = P^T o (dP^T - D) from
  // warpgroup 0's P^T, and accumulates dK += dS^T Q.  Each thread holds
  // one 64 x HDP accumulator and one 64 x 64 tile.
  const int wgi = warp / 4;
  const int wr = 16 * (warp % 4) + lane / 4;  // its key rows wr, wr + 8
  const int c0 = 2 * (lane % 4);              // its query columns
  const float sl2 = a.scale * LOG2E;
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + wr + 8 * i;
    kp[i] = t < a.T ? kpos[t * a.skpt] : -1;
  }
  float acc[HDP / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  // P^T in fp32, elements 4 nb .. 4 nb + 3 of thread t of warpgroup 0 as
  // one float4 at [buffer][nb][t]: the thread of warpgroup 1 with the same
  // place in its warpgroup holds the same (key, query) in its dP^T, and a
  // warp's 16-byte accesses are contiguous
  float4* pt = reinterpret_cast<float4*>(P_s) + tid % 128;
  int* pw = pos_s + (warp % 4) * 64;  // staged query positions (wg 0)
  const bf16* as = wgi == 0 ? Ks : Vs;  // the A operand of S^T or dP^T

  hopper::mbar_wait(kvbar, 0);
  int it = 0;
  for (int hh = 0; hh < a.g; ++hh) {
    for (int j = 0; j < nqt; ++j) {
      const uint8_t cj = cls[j];
      if (cj == EMPTY) continue;
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int pb = it % 2;  // P^T buffer
      float4* pbuf = pt + pb * 8 * 128;
      ++it;
      const bf16* qs = Qs + s * KV_BM * HDP;
      const bf16* dos = dOs + s * KV_BM * HDP;
      const float* ls = lse_s + s * KV_BM;
      const float* ds = D_s + s * KV_BM;

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
      hopper::mbar_wait(full + s, parity);
      float sd[32];  // defined by the first k step
      const uint64_t ad0 = hopper::sw128_desc(as, 16);
      const uint64_t bd0 = hopper::sw128_desc(wgi == 0 ? qs : dos, 16);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int box = kk / 4, off = 16 * (kk % 4);
        const uint64_t ad = hopper::desc_add(ad0, box * KV_BN * 64 + off);
        const uint64_t bd = hopper::desc_add(bd0, box * KV_BM * 64 + off);
        if (kk == 0)
          hopper::wgmma_ss_n64_zero(sd, ad, bd);
        else
          hopper::wgmma_ss_n64(sd, ad, bd, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(sd);

      // the operand of the second product, packed as A fragments: the
      // accumulator layout of a 64 x 64 tile is the register fragment
      // layout of A, 16 queries per k step
      uint32_t fa[16];
      if (wgi == 0) {
        // P^T = exp2(s sl2 - lse2), lse2 per column; the mask only in
        // MIXED tiles.  Buffer pb is free once warpgroup 1 has read the
        // tile two back.
        if (it > 2) hopper::named_sync(P_FREE + pb, CONSUMERS);
        if (cj == MIXED) {
          stage_pos(qpos, a.sqps, j * KV_BM, a.S, lane, pw);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int col = 8 * nb + c0;
            const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qp = pw[col + e];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int x = 4 * nb + 2 * i + e;
                const float p =
                    hopper::fast_exp2(sd[x] * sl2 - (e ? l2.y : l2.x));
                sd[x] = kept(qp, kp[i], a.causal, a.window) ? p : 0.f;
              }
            }
            pbuf[nb * 128] = make_float4(sd[4 * nb], sd[4 * nb + 1],
                                         sd[4 * nb + 2], sd[4 * nb + 3]);
          }
        } else {
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(ls + 8 * nb + c0);
#pragma unroll
            for (int x = 4 * nb; x < 4 * nb + 4; ++x)
              sd[x] = hopper::fast_exp2(sd[x] * sl2 - (x % 2 ? l2.y : l2.x));
            pbuf[nb * 128] = make_float4(sd[4 * nb], sd[4 * nb + 1],
                                         sd[4 * nb + 2], sd[4 * nb + 3]);
          }
        }
        hopper::named_arrive(P_FULL + pb, CONSUMERS);
#pragma unroll
        for (int r = 0; r < 16; ++r)
          fa[r] = attn::pack_bf16(sd[2 * r], sd[2 * r + 1]);
      } else {
        // dS^T = P^T o (dP^T - D), D per column
        hopper::named_sync(P_FULL + pb, CONSUMERS);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 dd =
              *reinterpret_cast<const float2*>(ds + 8 * nb + c0);
          const float4 p = pbuf[nb * 128];
          const int x = 4 * nb;
          fa[2 * nb] = attn::pack_bf16(p.x * (sd[x] - dd.x),
                                       p.y * (sd[x + 1] - dd.y));
          fa[2 * nb + 1] = attn::pack_bf16(p.z * (sd[x + 2] - dd.x),
                                           p.w * (sd[x + 3] - dd.y));
        }
        hopper::named_arrive(P_FREE + pb, CONSUMERS);
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), dO and
      // Q MN-major, in 64-column products
      const uint64_t md = hopper::sw128_desc(wgi == 0 ? dos : qs, KV_BM * 128);
      hopper::fence_regs<HDP / 2>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < TL::NBOX; ++c)
#pragma unroll
        for (int kk = 0; kk < KV_BM / 16; ++kk)
          hopper::wgmma_rs_n64(
              acc + 32 * c, fa + 4 * kk,
              hopper::desc_add(md, c * KV_BM * 64 + kk * 16 * 64), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<HDP / 2>(acc);
      hopper::fence_regs<16>(fa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);
    }
  }
  // warpgroup 1 released the last two buffers: match its arrivals
  if (wgi == 0)
    for (int t = it > 2 ? it - 2 : 0; t < it; ++t)
      hopper::named_sync(P_FREE + t % 2, CONSUMERS);

  // rows that kept no key: P = 1/T over every key into dV
  if (wgi == 0) {
    const float inv_t = 1.f / a.T;
    for (int hh = 0; hh < a.g; ++hh) {
      const float* dead =
          a.dead + (static_cast<long long>(b) * a.H + h0 + hh) * HDP;
#pragma unroll
      for (int nb = 0; nb < HDP / 8; ++nb) {
        const float2 x = *reinterpret_cast<const float2*>(dead + 8 * nb + c0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * nb + 2 * i] += x.x * inv_t;
          acc[4 * nb + 2 * i + 1] += x.y * inv_t;
        }
      }
    }
  }

  // bf16 dV, or dK times scale
  const float mul = wgi == 1 ? a.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + wr + 8 * i;
    if (t >= a.T) continue;
    bf16* out = wgi == 0
        ? static_cast<bf16*>(a.dv) + b * a.sdvb + kvh * a.sdvh + t * a.sdvt
        : static_cast<bf16*>(a.dk) + b * a.sdkb + kvh * a.sdkh + t * a.sdkt;
#pragma unroll
    for (int nb = 0; nb < HDP / 8; ++nb) {
      const int col = 8 * nb + c0;
      if (col >= a.hd) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + col) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * i] * mul,
                                acc[4 * nb + 2 * i + 1] * mul);
    }
  }
}

// ------------------------------------------------------------ dQ
template <int HDP>
struct QTile {
  static constexpr int NBOX = HDP / 64;
  static constexpr int Q_BYTES = Q_BM * HDP * 2;   // Q or dO
  static constexpr int KV_BYTES = Q_BN * HDP * 2;  // a K or V tile
  static constexpr int RING = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int P_BYTES = CONSUMERS * 32 * 4;  // P, 32 a thread
  // after the ring: the P slabs, a row of 64 key positions per consumer
  // warp, the barriers (q, full and empty per stage), the query tile's
  // stats, then one class byte per kv tile
  static constexpr int TAIL = P_BYTES + CONSUMERS / 32 * 64 * 4 +
                              8 * (1 + 2 * STAGES) + 16;
  static size_t smem_bytes(int ntk) { return 1024 + RING + TAIL + ntk; }
};

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmdo,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, WArgs a) {
  using TL = QTile<HDP>;
  extern __shared__ unsigned char q_smem[];
  unsigned char* base =
      q_smem + ((1024 - (attn::smem_addr(q_smem) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [NBOX][Q_BM][64]
  bf16* dOs = Qs + Q_BM * HDP;               // [NBOX][Q_BM][64]
  bf16* Ks = dOs + Q_BM * HDP;               // [STAGES][NBOX][Q_BN][64]
  bf16* Vs = Ks + STAGES * Q_BN * HDP;       // [STAGES][NBOX][Q_BN][64]
  float* P_s = reinterpret_cast<float*>(base + TL::RING);  // [32][256]
  int* pos_s = reinterpret_cast<int*>(P_s + CONSUMERS * 32);  // [8][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(pos_s + CONSUMERS / 32 * 64);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  int* qstat = reinterpret_cast<int*>(empty + STAGES);  // lo, hi
  uint8_t* cls = reinterpret_cast<uint8_t*>(qstat + 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  // under the causal mask the last query tiles keep the most keys
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Q_BM;
  const int kvh = h / a.g;
  const int ntk = (a.T + Q_BN - 1) / Q_BN;
  const int* kpos = a.kpos + b * a.skpb;
  const int* qpos = a.qpos + b * a.sqpb;

  if (tid == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  if (warp == 0) {
    int lo, hi;
    bool hole;
    warp_range(qpos, a.sqps, q0, Q_BM, a.S, lane, lo, hi, hole);
    if (lane == 0) {
      qstat[0] = lo;
      qstat[1] = hi;
    }
  }
  __syncthreads();
  for (int j = warp; j < ntk; j += THREADS / 32) {
    int lo, hi;
    bool hole;
    warp_range(kpos, a.skpt, j * Q_BN, Q_BN, a.T, lane, lo, hi, hole);
    // keys past T are masked here: exp2(-lse2) of their zero scores
    // could overflow, and inf times their zero K rows is not 0
    hole = hole || (j + 1) * Q_BN > a.T;
    if (lane == 0)
      cls[j] = classify(qstat[0], qstat[1], lo, hi, hole, a.causal,
                        a.window);
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer warp: one thread keeps the ring full
    if (lane == 0) {
      hopper::mbar_expect_tx(qbar, 2 * TL::Q_BYTES);
      for (int c = 0; c < TL::NBOX; ++c) {
        hopper::tma_load_4d(Qs + c * Q_BM * 64, &tmq, qbar, 64 * c, q0, h, b);
        hopper::tma_load_4d(dOs + c * Q_BM * 64, &tmdo, qbar, 64 * c, q0, h,
                            b);
      }
      int it = 0;
      for (int j = 0; j < ntk; ++j) {
        if (cls[j] == EMPTY) continue;
        const int s = it % STAGES;
        hopper::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        bf16* kd = Ks + s * Q_BN * HDP;
        bf16* vd = Vs + s * Q_BN * HDP;
        hopper::mbar_expect_tx(full + s, 2 * TL::KV_BYTES);
        for (int c = 0; c < TL::NBOX; ++c) {
          hopper::tma_load_4d(kd + c * Q_BN * 64, &tmk, full + s, 64 * c,
                              j * Q_BN, kvh, b);
          hopper::tma_load_4d(vd + c * Q_BN * 64, &tmv, full + s, 64 * c,
                              j * Q_BN, kvh, b);
        }
        ++it;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wgi owns rows [q0 + 64 wgi, + 64)
  const int wgi = warp / 4;
  const int wr = 16 * (warp % 4) + lane / 4;  // its rows wr, wr + 8
  const int c0 = 2 * (lane % 4);              // its key columns
  const float sl2 = a.scale * LOG2E;
  int qp[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 64 * wgi + wr + 8 * i;
    qp[i] = qi < a.S ? qpos[qi * a.sqps] : -1;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.spad +
                          qi;  // qi < spad: rows are padded to 128
    l2[i] = a.lse2[row];
    dd[i] = a.dpad[row];
  }
  float dq[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
  const bf16* qw = Qs + wgi * 64 * 64;
  const bf16* dow = dOs + wgi * 64 * 64;
  // P, elements 4 nb .. 4 nb + 3 as one float4 at pt[256 nb]
  float4* pt = reinterpret_cast<float4*>(P_s) + tid;
  int* pw = pos_s + warp * 64;  // this warp's staged key positions

  hopper::mbar_wait(qbar, 0);
  int it = 0;
  for (int j = 0; j < ntk; ++j) {
    const uint8_t cj = cls[j];
    if (cj == EMPTY) continue;
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    ++it;
    const bf16* ks = Ks + s * Q_BN * HDP;
    const bf16* vs = Vs + s * Q_BN * HDP;

    // S = Q K^T and dP = dO V^T; P = exp2(s sl2 - lse2) (lse2 per row;
    // the mask in MIXED tiles) into the thread's shared-memory slab while
    // dP is formed
    hopper::mbar_wait(full + s, parity);
    float dpacc[32];  // defined by the first k step
    {
      float sacc[32];  // defined by the first k step
      const uint64_t qd = hopper::sw128_desc(qw, 16);
      const uint64_t kd = hopper::sw128_desc(ks, 16);
      const uint64_t od = hopper::sw128_desc(dow, 16);
      const uint64_t vd = hopper::sw128_desc(vs, 16);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int box = kk / 4, off = 16 * (kk % 4);
        const uint64_t ad = hopper::desc_add(qd, box * Q_BM * 64 + off);
        const uint64_t bd = hopper::desc_add(kd, box * Q_BN * 64 + off);
        if (kk == 0)
          hopper::wgmma_ss_n64_zero(sacc, ad, bd);
        else
          hopper::wgmma_ss_n64(sacc, ad, bd, 1);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int box = kk / 4, off = 16 * (kk % 4);
        const uint64_t ad = hopper::desc_add(od, box * Q_BM * 64 + off);
        const uint64_t bd = hopper::desc_add(vd, box * Q_BN * 64 + off);
        if (kk == 0)
          hopper::wgmma_ss_n64_zero(dpacc, ad, bd);
        else
          hopper::wgmma_ss_n64(dpacc, ad, bd, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs<32>(sacc);
      if (cj == MIXED) {
        stage_pos(kpos, a.skpt, j * Q_BN, a.T, lane, pw);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpe = pw[8 * nb + c0 + e];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * nb + 2 * i + e;
              const float p = hopper::fast_exp2(sacc[x] * sl2 - l2[i]);
              sacc[x] = kept(qp[i], kpe, a.causal, a.window) ? p : 0.f;
            }
          }
          pt[nb * 256] = make_float4(sacc[4 * nb], sacc[4 * nb + 1],
                                     sacc[4 * nb + 2], sacc[4 * nb + 3]);
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
          for (int x = 4 * nb; x < 4 * nb + 4; ++x)  // row (x / 2) % 2
            sacc[x] = hopper::fast_exp2(sacc[x] * sl2 - l2[(x / 2) % 2]);
          pt[nb * 256] = make_float4(sacc[4 * nb], sacc[4 * nb + 1],
                                     sacc[4 * nb + 2], sacc[4 * nb + 3]);
        }
      }
    }

    // dS = P o (dP - D), packed as the A operand
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(dpacc);
    uint32_t da[16];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {  // registers 4 nb, +1: row 0; +2, +3: 1
      const float4 p = pt[nb * 256];
      const int x = 4 * nb;
      da[2 * nb] = attn::pack_bf16(p.x * (dpacc[x] - dd[0]),
                                   p.y * (dpacc[x + 1] - dd[0]));
      da[2 * nb + 1] = attn::pack_bf16(p.z * (dpacc[x + 2] - dd[1]),
                                       p.w * (dpacc[x + 3] - dd[1]));
    }

    // dQ += dS K, K MN-major, in 64-column products
    const uint64_t km = hopper::sw128_desc(ks, Q_BN * 128);
    hopper::fence_regs<HDP / 2>(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < TL::NBOX; ++c)
#pragma unroll
      for (int kk = 0; kk < Q_BN / 16; ++kk)
        hopper::wgmma_rs_n64(
            dq + 32 * c, da + 4 * kk,
            hopper::desc_add(km, c * Q_BN * 64 + kk * 16 * 64), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HDP / 2>(dq);
    hopper::fence_regs<16>(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
  }

  bf16* dqo = static_cast<bf16*>(a.dq) + b * a.sdqb + h * a.sdqh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 64 * wgi + wr + 8 * i;
    if (qi >= a.S) continue;
#pragma unroll
    for (int nb = 0; nb < HDP / 8; ++nb) {
      const int col = 8 * nb + c0;
      if (col >= a.hd) continue;
      *reinterpret_cast<__nv_bfloat162*>(dqo + qi * a.sdqs + col) =
          __floats2bfloat162_rn(dq[4 * nb + 2 * i] * a.scale,
                                dq[4 * nb + 2 * i + 1] * a.scale);
    }
  }
}

// ------------------------------------------------------------ launch
template <int HDP>
cudaError_t launch(const WArgs& a, cudaStream_t st) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.spad;
  bwd_prep<<<static_cast<unsigned>((rows + 15) / 16), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_deadsum<HDP><<<dim3(a.H, a.B), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mdo, mk, mv;
  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        KV_BM) ||
      !hopper::make_map(&mdo, a.dout, a.hd, a.S, a.H, a.B, a.sdos, a.sdoh,
                        a.sdob, KV_BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, KV_BN) ||
      !hopper::make_map(&mv, a.v, a.hd, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, KV_BN))
    return cudaErrorInvalidValue;
  const int nqt = (a.S + KV_BM - 1) / KV_BM;
  const size_t kv_bytes = KvTile<HDP>::smem_bytes(nqt);
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma<HDP><<<dim3(a.Hkv, a.B, (a.T + KV_BN - 1) / KV_BN),
                        THREADS, kv_bytes, st>>>(mq, mdo, mk, mv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        Q_BM) ||
      !hopper::make_map(&mdo, a.dout, a.hd, a.S, a.H, a.B, a.sdos, a.sdoh,
                        a.sdob, Q_BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, Q_BN) ||
      !hopper::make_map(&mv, a.v, a.hd, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, Q_BN))
    return cudaErrorInvalidValue;
  const size_t q_bytes = QTile<HDP>::smem_bytes((a.T + Q_BN - 1) / Q_BN);
  err = cudaFuncSetAttribute(bwd_dq_wgmma<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma<HDP><<<dim3(a.H, a.B, (a.S + Q_BM - 1) / Q_BM), THREADS,
                      q_bytes, st>>>(mq, mdo, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace bwg
}  // namespace
