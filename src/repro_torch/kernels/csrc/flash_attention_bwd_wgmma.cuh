// Prefill flash attention backward on Hopper's tensor cores (sm_90a):
// bf16 inputs at every (hd, hd_v) pair K2 takes.  Included by
// flash_attention_bwd_bf16.cu, whose entry point routes them all here:
// q/k padded to HDP = 64 (hd 16, 32, 64), 128 (96, 112, 128), 192 (160,
// 192) or 256 by the TMA zero fill, V, O and dO to HDPV = HDP, or 128 at
// MLA's (192, 128).  fp32 takes the scalar kernels of
// flash_attention_bwd.cuh.
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
// Bound.  5 products of 2 * (kept pairs) FLOPs times their depth, S, dK
// and dQ over hd, dP and dV over hd_v (2 (3 hd + 2 hd_v) kept), against
// 989 TFLOP/s bf16 on an H100 SXM: 0.1955 ms at StarCoder2-7B's trained
// shape (B 2, H 36, Hkv 4, S = T = 2048, hd 128, causal), 0.4310 ms at
// DeepSeek-V3's MLA (B 1, H 128, S = T = 2000, hd 192, hd_v 128, causal).
// This design runs 7 (S and dP are formed once for dK/dV and once for
// dQ: 2 (4 hd + 3 hd_v) kept), 0.2737 and 0.5967 ms there: the price of
// writing dQ without atomics, so the bits repeat from run to run
// (FlashAttention-3 accumulates dQ with fp32 atomics instead).
// Operations, not bytes, at every trained shape.
//
// Registers shape the design.  A wgmma's accumulator and A fragments must
// sit in contiguous registers, and once a kernel runs short ptxas
// serialises every wgmma in it.  ptxas gives a block of 288 threads (two
// consumer warpgroups and a producer warp) 168 registers a thread, and
// setmaxnreg did not raise what it allocates in the consumers' code.  So
// at HDP 64 and 128 no thread holds more than one 64 x HDP accumulator
// (64 registers at 128) and one 64 x 64 tile of scores (32).  At HDP 192
// and 256 the accumulator alone takes 96 or 128, so those kernels are
// "wide": no producer warp (256 threads, up to 255 registers a thread;
// one consumer thread keeps the ring full from inside the loop), and
// 32-row streamed tiles (query rows in dK/dV, keys in dQ), so that two
// stages of the ring fit the 227 KB of shared memory at hd 256.
//
// Four launches, no atomics:
//   `bwd_prep`: per row, D = rowsum(dO o O) over hd_v and lse2 =
//     lse * log2(e) in fp32, into (B, H, spad) buffers padded to 128 rows;
//     a row that kept no key, and every padding row, gets lse2 = +inf, so
//     that P = exp2(s - lse2) is exactly 0 there with no mask evaluated.
//   `bwd_deadsum`: per (b, h), the fp32 sum of dO over the rows that kept
//     no key, rows in a fixed order.  The dK/dV epilogue adds 1/T of it
//     to every key's dV, so the main loops treat those rows as masked and
//     skip query tiles by position ranges alone.
//   `bwd_dkdv_wgmma`: one block per (64-key tile, kv head, batch), which
//     walks its GQA group's g query heads in head order and writes bf16
//     dK (scaled) and dV itself: no fp32 partials, no second pass.  K and
//     V come in once by TMA; Q and dO tiles (64 or 32 rows) of each head,
//     with their lse2 and D, stream through a 2-stage mbarrier ring.  Keys
//     are the wgmma M dimension and the two consumer warpgroups split the
//     work by role over the same keys: warpgroup 0 forms S^T = K Q^T
//     (depth hd), P^T (rounded to bf16 as FlashAttention does, as the A
//     fragment of) dV += P^T dO (hd_v wide); warpgroup 1 forms dP^T =
//     V dO^T (depth hd_v) and dS^T = P^T o (dP^T - D), from warpgroup 0's
//     fp32 P^T passed through a double-buffered shared-memory slab under
//     named barriers, and dK += dS^T Q (hd wide).  S^T and dP^T read both
//     operands from shared memory (SS); the dV and dK products read dO
//     and Q MN-major from the same swizzled tiles (RS, 64 columns a
//     product).  lse2 and D are per column here.  Query tiles are
//     classified per key tile, as the forward classifies kv tiles: EMPTY
//     tiles are never loaded, FULL tiles evaluate no mask, MIXED tiles
//     read their positions from a per-warp staged row.  The first key
//     tiles (the most queries under the causal mask) launch first.
//   `bwd_dq_wgmma`: shaped like the forward: one block per (128-row query
//     tile, head, batch), two consumer warpgroups of 64 rows.  Q and dO
//     stay resident; K and V tiles (64 or 32 keys) stream through the
//     ring, classified EMPTY/FULL/MIXED; S = Q K^T and dP = dO V^T (SS)
//     are issued together, P goes to the thread's fp32 slab while dP
//     forms, then dS in bf16 and dQ += dS K with K read MN-major (RS).
//     The last query tiles launch first.
//
// What it leaves on the table: no ping-pong between warpgroups beyond
// what the role split gives, and no overlap of a tile's exponentials
// with the next tile's products; 7 products instead of 5; 64-key dK/dV
// blocks, so every key tile streams its Q and dO tiles from L2 (about
// 1.25 GB at StarCoder2-7B's trained shape); hd 112 and 160 padded in
// the products; 32-row tiles in the wide kernels, whose SS products read
// more shared memory per FLOP; a grid of B * Hkv * T / 64 blocks, so a
// short sequence with few kv heads leaves SMs idle.
#pragma once

#include <limits.h>
#include <math.h>

#include "attention_common.cuh"
#include "flash_attention_bwd.cuh"
#include "hopper.cuh"

namespace {
namespace bwg {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int STAGES = 2;       // ring depth
constexpr int KV_BN = 64;       // dK/dV: keys per block
constexpr int Q_BM = 128;       // dQ: query rows per block
constexpr int ROW_PAD = 128;    // lse2 and D rows: padded to a multiple
constexpr uint8_t EMPTY = 0, FULL = 1, MIXED = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The layout at padded q/k head dim HDP: up to 128 a producer warp
// beside the two consumer warpgroups and 64-row streamed tiles; wide
// (above 128) no producer warp and 32-row tiles.
template <int HDP>
struct Layout {
  static constexpr bool WIDE = HDP > 128;
  static constexpr int THREADS = CONSUMERS + (WIDE ? 0 : 32);
  static constexpr int ROWS = WIDE ? 32 : 64;  // rows of a streamed tile
};

// The kernels' arguments: the scalar route's, and the scratch of this
// one (fp32, carved from the buffer the wrapper allocates): lse2 and D
// (B, H, spad), the dead rows' dO sums (B, H, padded hd_v).
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
inline int padded_hd(int hd) { return (hd + 63) / 64 * 64; }
inline int padded_rows(int S) { return (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD; }

inline Scratch scratch_layout(int B, int H, int S, int hdv) {
  const long long rows = up256(4ll * B * H * padded_rows(S));
  Scratch s;
  s.lse2 = 0;
  s.dpad = rows;
  s.dead = 2 * rows;
  s.bytes = s.dead + up256(4ll * B * H * padded_hd(hdv));
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

// The positions of an N-row tile, staged for a warp in its shared-memory
// row w: w[c] = pos[(i0 + c) * st], -1 at or past end.  Coalesced loads,
// and each lane then reads its columns with one address.
template <int N>
__device__ __forceinline__ void stage_pos(const int* pos, long long st,
                                          int i0, int end, int lane, int* w) {
  __syncwarp();  // the previous tile's readers are done
#pragma unroll
  for (int h = 0; h < N / 32; ++h) {
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

// d (64 x N) = A B^T over depth D, issued by one warpgroup: A's 64 rows
// and B's N rows K-major in swizzled 64-column boxes, A's boxes `arows`
// rows apart and B's `brows`.  The first k step does not read d.
template <int D, int N>
__device__ __forceinline__ void ss_product(float* d, const bf16* A, int arows,
                                           const bf16* Bm, int brows) {
  const uint64_t ad0 = hopper::sw128_desc(A, 16);
  const uint64_t bd0 = hopper::sw128_desc(Bm, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = 16 * (kk % 4);
    const uint64_t ad = hopper::desc_add(ad0, box * arows * 64 + off);
    const uint64_t bd = hopper::desc_add(bd0, box * brows * 64 + off);
    if (kk == 0)
      hopper::Wgmma<N>::ss_zero(d, ad, bd);
    else
      hopper::Wgmma<N>::ss(d, ad, bd, 1);
  }
}

// acc (64 x 64 NB) += A B: A (64 x K) as register fragments, 4 a k step
// of 16; B (K x 64 NB) MN-major in NB swizzled boxes of K rows; 64
// columns a product.
template <int NB, int K>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* fa,
                                           const bf16* Bm) {
  const uint64_t md = hopper::sw128_desc(Bm, K * 128);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      hopper::wgmma_rs_n64(acc + 32 * c, fa + 4 * kk,
                           hopper::desc_add(md, c * K * 64 + kk * 16 * 64),
                           1);
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
    for (int c = 8 * l; c < a.hdv; c += 128) {
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

// One block of 8 warps per (h, b): dead[b, h, :HDPV] = the sum of dO over
// the rows that kept no key (0 past hd_v).  Warp w takes rows 32 w + 256 i
// + lane's 32-row groups and adds their dead rows in row order; the 8
// warps' sums are added in warp order.
template <int HDPV>
__global__ void __launch_bounds__(256) bwd_deadsum(WArgs a) {
  __shared__ float part[8][HDPV];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.sdob +
                     h * a.sdoh;
  float acc[HDPV / 32];
#pragma unroll
  for (int j = 0; j < HDPV / 32; ++j) acc[j] = 0.f;
  for (int s0 = 32 * warp; s0 < a.S; s0 += 256) {
    const int s = s0 + lane;
    unsigned m = __ballot_sync(0xffffffffu,
                               s < a.S && no_key(a.lse[bh * a.S + s]));
    while (m) {
      const int r = s0 + __ffs(m) - 1;
      m &= m - 1;
#pragma unroll
      for (int j = 0; j < HDPV / 32; ++j) {
        const int col = lane + 32 * j;
        if (col < a.hdv) acc[j] += __bfloat162float(dout[r * a.sdos + col]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < HDPV / 32; ++j) part[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < HDPV; c += 256) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += part[w][c];
    a.dead[bh * HDPV + c] = sum;
  }
}

// ------------------------------------------------------------ dK and dV
template <int HDP, int HDPV>
struct KvTile : Layout<HDP> {
  static constexpr int BM = Layout<HDP>::ROWS;  // query rows per tile
  static constexpr int NBOX = HDP / 64, NBOXV = HDPV / 64;
  static constexpr int K_BYTES = KV_BN * HDP * 2;
  static constexpr int V_BYTES = KV_BN * HDPV * 2;
  static constexpr int Q_BYTES = BM * HDP * 2;    // a Q tile
  static constexpr int DO_BYTES = BM * HDPV * 2;  // a dO tile
  static constexpr int RING =
      K_BYTES + V_BYTES + STAGES * (Q_BYTES + DO_BYTES);
  static constexpr int STAT_BYTES = 2 * BM * 4;   // a tile's lse2 and D
  static constexpr int P_BYTES = 2 * 128 * (BM / 2) * 4;  // P^T, 2 buffers
  // after the ring: the P^T buffers, lse2 and D per stage, a row of BM
  // query positions per warp of warpgroup 0, the barriers (kv, full and
  // empty per stage), the key tile's stats, then one class byte per
  // query tile; 1024 bytes of slack align the ring for the swizzle
  static constexpr int TAIL = P_BYTES + STAGES * STAT_BYTES + 4 * BM * 4 +
                              8 * (1 + 2 * STAGES) + 16;
  static size_t smem_bytes(int nqt) { return 1024 + RING + TAIL + nqt; }
};

// Named barriers between the two consumer warpgroups (id 0 is
// __syncthreads): P^T buffer b written (P_FULL + b) and read (P_FREE + b).
constexpr int P_FULL = 1, P_FREE = 3;

// A consumer warpgroup's role in the dK/dV loop: 0 (dV) or 1 (dK), or -1
// for both in one instruction stream.
template <int R>
struct Role {
  static constexpr int value = R;
};

template <int HDP, int HDPV>
__global__ void __launch_bounds__(KvTile<HDP, HDPV>::THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmq,
                   const __grid_constant__ CUtensorMap tmdo,
                   const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, WArgs a) {
  using TL = KvTile<HDP, HDPV>;
  constexpr int BM = TL::BM;
  // the wide kernels' producer: the first thread of warpgroup 1, which
  // finishes each tile last
  constexpr int PRODUCER = 128;
  extern __shared__ unsigned char kv_smem[];
  unsigned char* base =
      kv_smem + ((1024 - (attn::smem_addr(kv_smem) & 1023)) & 1023);
  bf16* Ks = reinterpret_cast<bf16*>(base);    // [NBOX][KV_BN][64]
  bf16* Vs = Ks + KV_BN * HDP;                 // [NBOXV][KV_BN][64]
  bf16* Qs = Vs + KV_BN * HDPV;                // [STAGES][NBOX][BM][64]
  bf16* dOs = Qs + STAGES * BM * HDP;          // [STAGES][NBOXV][BM][64]
  float* P_s = reinterpret_cast<float*>(base + TL::RING);  // [2][BM/2][128]
  float* lse_s = P_s + 2 * (BM / 2) * 128;                 // [STAGES][BM]
  float* D_s = lse_s + STAGES * BM;                        // [STAGES][BM]
  int* pos_s = reinterpret_cast<int*>(D_s + STAGES * BM);  // [4][BM]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(pos_s + 4 * BM);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;
  int* kstat = reinterpret_cast<int*>(empty + STAGES);  // lo, hi, hole
  uint8_t* cls = reinterpret_cast<uint8_t*>(kstat + 4);
  const CUtensorMap *mq = &tmq, *mdo = &tmdo, *mk = &tmk, *mv = &tmv;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * KV_BN;  // the first key tiles launch first
  const int kvh = blockIdx.x, h0 = kvh * a.g;  // the group's heads
  const int nqt = (a.S + BM - 1) / BM;
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
  for (int j = warp; j < nqt; j += TL::THREADS / 32) {
    int lo, hi;
    bool hole;
    warp_range(qpos, a.sqps, j * BM, BM, a.S, lane, lo, hi, hole);
    if (lane == 0)
      cls[j] = classify(lo, hi, kstat[0], kstat[1], kstat[2] != 0, a.causal,
                        a.window);
  }
  __syncthreads();

  // The producer's loads: K and V once, then query tile j of head
  // h0 + hh, with its lse2 and D, as the t-th tile of the ring.
  auto load_kv = [&]() {
    hopper::mbar_expect_tx(kvbar, TL::K_BYTES + TL::V_BYTES);
    for (int c = 0; c < TL::NBOX; ++c)
      hopper::tma_load_4d(Ks + c * KV_BN * 64, mk, kvbar, 64 * c, k0, kvh, b);
    for (int c = 0; c < TL::NBOXV; ++c)
      hopper::tma_load_4d(Vs + c * KV_BN * 64, mv, kvbar, 64 * c, k0, kvh, b);
  };
  auto load_tile = [&](int t, int hh, int j) {
    const int s = t % STAGES, h = h0 + hh;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.spad;
    hopper::mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
    bf16* qd = Qs + s * BM * HDP;
    bf16* dod = dOs + s * BM * HDPV;
    hopper::mbar_expect_tx(full + s,
                           TL::Q_BYTES + TL::DO_BYTES + TL::STAT_BYTES);
    for (int c = 0; c < TL::NBOX; ++c)
      hopper::tma_load_4d(qd + c * BM * 64, mq, full + s, 64 * c, j * BM, h,
                          b);
    for (int c = 0; c < TL::NBOXV; ++c)
      hopper::tma_load_4d(dod + c * BM * 64, mdo, full + s, 64 * c, j * BM,
                          h, b);
    hopper::bulk_load(lse_s + s * BM, a.lse2 + row0 + j * BM, BM * 4,
                      full + s);
    hopper::bulk_load(D_s + s * BM, a.dpad + row0 + j * BM, BM * 4,
                      full + s);
  };
  // the wide kernels' cursor: the next live (head, tile) to load, and the
  // number loaded so far; nh == g once every tile is loaded
  int nh = 0, nj = -1, nt = 0;
  auto advance = [&]() {
    do {
      if (++nj == nqt) {
        nj = 0;
        ++nh;
      }
    } while (nh < a.g && cls[nj] == EMPTY);
  };

  if constexpr (!TL::WIDE) {
    if (warp == CONSUMERS / 32) {
      // ---- producer warp: one thread keeps the ring full
      if (lane == 0) {
        load_kv();
        for (int hh = 0; hh < a.g; ++hh)
          for (int j = 0; j < nqt; ++j)
            if (cls[j] != EMPTY) load_tile(nt++, hh, j);
      }
      return;
    }
  } else {
    if (tid == PRODUCER) {
      load_kv();
      for (advance(); nt < STAGES && nh < a.g; advance())
        load_tile(nt++, nh, nj);
    }
    __syncwarp();
  }

  // ---- consumers: both warpgroups hold the block's 64 keys as rows.
  // Warpgroup 0 forms S^T = K Q^T and P^T, and accumulates dV += P^T dO;
  // warpgroup 1 forms dP^T = V dO^T and dS^T = P^T o (dP^T - D) from
  // warpgroup 0's P^T, and accumulates dK += dS^T Q.  Each thread holds
  // one accumulator (64 x HDPV for dV, 64 x HDP for dK) and one 64 x BM
  // tile.  Up to a padded 128 both warpgroups run one instruction stream
  // (role -1): with a branch around the products this kernel took 0.50
  // ms at StarCoder2-7B's trained shape on an H100, against 0.41-0.42
  // without.  The wide kernels give each warpgroup its own copy of the
  // loop (role 0 or 1), which MLA's two depths need: 1.45-1.48 ms at
  // DeepSeek-V3's MLA shape against 1.70-1.76 with branches, and
  // 0.355-0.365 against 0.372-0.380 at StableLM-12B's hd 160.
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
  // P^T in fp32, elements 4 nb .. 4 nb + 3 of thread t of warpgroup 0 as
  // one float4 at [buffer][nb][t]: the thread of warpgroup 1 with the same
  // place in its warpgroup holds the same (key, query) in its dP^T, and a
  // warp's 16-byte accesses are contiguous
  float4* pt = reinterpret_cast<float4*>(P_s) + tid % 128;
  int* pw = pos_s + (warp % 4) * BM;  // staged query positions (wg 0)

  hopper::mbar_wait(kvbar, 0);
  auto consume = [&](auto role) {
    constexpr int R = decltype(role)::value;
    constexpr int ACC = R == 0 ? HDPV : HDP;  // the accumulator's width
    const bool w0 = R < 0 ? wgi == 0 : R == 0;
    float acc[ACC / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < ACC / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int hh = 0; hh < a.g; ++hh) {
      for (int j = 0; j < nqt; ++j) {
        const uint8_t cj = cls[j];
        if (cj == EMPTY) continue;
        const int s = it % STAGES;
        const uint32_t parity = (it / STAGES) & 1;
        const int pb = it % 2;  // P^T buffer
        float4* pbuf = pt + pb * (BM / 8) * 128;
        ++it;
        const bf16* qs = Qs + s * BM * HDP;
        const bf16* dos = dOs + s * BM * HDPV;
        const float* ls = lse_s + s * BM;
        const float* ds = D_s + s * BM;

        // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
        hopper::mbar_wait(full + s, parity);
        float sd[BM / 2];  // defined by the first k step
        hopper::wgmma_fence();
        if constexpr (R < 0)
          ss_product<HDP, BM>(sd, w0 ? Ks : Vs, KV_BN, w0 ? qs : dos, BM);
        else if constexpr (R == 0)
          ss_product<HDP, BM>(sd, Ks, KV_BN, qs, BM);
        else
          ss_product<HDPV, BM>(sd, Vs, KV_BN, dos, BM);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<BM / 2>(sd);

        // the operand of the second product, packed as A fragments: the
        // accumulator layout of a 64 x BM tile is the register fragment
        // layout of A, 16 queries per k step
        uint32_t fa[BM / 4];
        if (w0) {
          // P^T = exp2(s sl2 - lse2), lse2 per column; the mask only in
          // MIXED tiles.  Buffer pb is free once warpgroup 1 has read the
          // tile two back.
          if (it > 2) hopper::named_sync(P_FREE + pb, CONSUMERS);
          if (cj == MIXED) {
            stage_pos<BM>(qpos, a.sqps, j * BM, a.S, lane, pw);
#pragma unroll
            for (int nb = 0; nb < BM / 8; ++nb) {
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
            for (int nb = 0; nb < BM / 8; ++nb) {
              const float2 l2 =
                  *reinterpret_cast<const float2*>(ls + 8 * nb + c0);
#pragma unroll
              for (int x = 4 * nb; x < 4 * nb + 4; ++x)
                sd[x] =
                    hopper::fast_exp2(sd[x] * sl2 - (x % 2 ? l2.y : l2.x));
              pbuf[nb * 128] = make_float4(sd[4 * nb], sd[4 * nb + 1],
                                           sd[4 * nb + 2], sd[4 * nb + 3]);
            }
          }
          hopper::named_arrive(P_FULL + pb, CONSUMERS);
#pragma unroll
          for (int r = 0; r < BM / 4; ++r)
            fa[r] = attn::pack_bf16(sd[2 * r], sd[2 * r + 1]);
        } else {
          // dS^T = P^T o (dP^T - D), D per column
          hopper::named_sync(P_FULL + pb, CONSUMERS);
#pragma unroll
          for (int nb = 0; nb < BM / 8; ++nb) {
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

        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), dO
        // and Q MN-major, in 64-column products
        hopper::fence_regs<ACC / 2>(acc);
        hopper::wgmma_fence();
        if constexpr (R < 0)
          rs_product<TL::NBOX, BM>(acc, fa, w0 ? dos : qs);
        else if constexpr (R == 0)
          rs_product<TL::NBOXV, BM>(acc, fa, dos);
        else
          rs_product<TL::NBOX, BM>(acc, fa, qs);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<ACC / 2>(acc);
        hopper::fence_regs<BM / 4>(fa);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + s);
        if constexpr (TL::WIDE) {
          // the stage is refilled once both warpgroups have released it
          if (tid == PRODUCER && nh < a.g) {
            load_tile(nt++, nh, nj);
            advance();
          }
          __syncwarp();
        }
      }
    }
    // warpgroup 1 released the last two buffers: match its arrivals
    if (w0)
      for (int t = it > 2 ? it - 2 : 0; t < it; ++t)
        hopper::named_sync(P_FREE + t % 2, CONSUMERS);

    // rows that kept no key: P = 1/T over every key into dV
    if (w0) {
      const float inv_t = 1.f / a.T;
      for (int hh = 0; hh < a.g; ++hh) {
        const float* dead =
            a.dead + (static_cast<long long>(b) * a.H + h0 + hh) * HDPV;
#pragma unroll
        for (int nb = 0; nb < HDPV / 8; ++nb) {
          const float2 x =
              *reinterpret_cast<const float2*>(dead + 8 * nb + c0);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[4 * nb + 2 * i] += x.x * inv_t;
            acc[4 * nb + 2 * i + 1] += x.y * inv_t;
          }
        }
      }
    }

    // bf16 dV (hd_v columns), or dK (hd columns) times scale
    const float mul = w0 ? 1.f : a.scale;
    const int cols = w0 ? a.hdv : a.hd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = k0 + wr + 8 * i;
      if (t >= a.T) continue;
      bf16* out = w0
          ? static_cast<bf16*>(a.dv) + b * a.sdvb + kvh * a.sdvh + t * a.sdvt
          : static_cast<bf16*>(a.dk) + b * a.sdkb + kvh * a.sdkh + t * a.sdkt;
#pragma unroll
      for (int nb = 0; nb < ACC / 8; ++nb) {
        const int col = 8 * nb + c0;
        if (col >= cols) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * nb + 2 * i] * mul,
                                  acc[4 * nb + 2 * i + 1] * mul);
      }
    }
  };
  if constexpr (!TL::WIDE)
    consume(Role<-1>{});
  else if (wgi == 0)
    consume(Role<0>{});
  else
    consume(Role<1>{});
}

// ------------------------------------------------------------ dQ
template <int HDP, int HDPV>
struct QTile : Layout<HDP> {
  static constexpr int BN = Layout<HDP>::ROWS;  // keys per tile
  static constexpr int NBOX = HDP / 64, NBOXV = HDPV / 64;
  static constexpr int Q_BYTES = Q_BM * HDP * 2;
  static constexpr int DO_BYTES = Q_BM * HDPV * 2;
  static constexpr int K_BYTES = BN * HDP * 2;   // a K tile
  static constexpr int V_BYTES = BN * HDPV * 2;  // a V tile
  static constexpr int RING =
      Q_BYTES + DO_BYTES + STAGES * (K_BYTES + V_BYTES);
  static constexpr int P_BYTES = CONSUMERS * (BN / 2) * 4;  // P, BN/2 each
  // after the ring: the P slabs, a row of BN key positions per consumer
  // warp, the barriers (q, full and empty per stage), the query tile's
  // stats, then one class byte per kv tile
  static constexpr int TAIL = P_BYTES + CONSUMERS / 32 * BN * 4 +
                              8 * (1 + 2 * STAGES) + 16;
  static size_t smem_bytes(int ntk) { return 1024 + RING + TAIL + ntk; }
};

template <int HDP, int HDPV>
__global__ void __launch_bounds__(QTile<HDP, HDPV>::THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmdo,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, WArgs a) {
  using TL = QTile<HDP, HDPV>;
  constexpr int BN = TL::BN;
  constexpr int PRODUCER = 0;  // the wide kernels' producer thread
  extern __shared__ unsigned char q_smem[];
  unsigned char* base =
      q_smem + ((1024 - (attn::smem_addr(q_smem) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // [NBOX][Q_BM][64]
  bf16* dOs = Qs + Q_BM * HDP;               // [NBOXV][Q_BM][64]
  bf16* Ks = dOs + Q_BM * HDPV;              // [STAGES][NBOX][BN][64]
  bf16* Vs = Ks + STAGES * BN * HDP;         // [STAGES][NBOXV][BN][64]
  float* P_s = reinterpret_cast<float*>(base + TL::RING);  // [BN/2][256]
  // [8][BN]
  int* pos_s = reinterpret_cast<int*>(P_s + CONSUMERS * (BN / 2));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(pos_s + CONSUMERS / 32 * BN);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  int* qstat = reinterpret_cast<int*>(empty + STAGES);  // lo, hi
  uint8_t* cls = reinterpret_cast<uint8_t*>(qstat + 4);
  const CUtensorMap *mq = &tmq, *mdo = &tmdo, *mk = &tmk, *mv = &tmv;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  // under the causal mask the last query tiles keep the most keys
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Q_BM;
  const int kvh = h / a.g;
  const int ntk = (a.T + BN - 1) / BN;
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
  for (int j = warp; j < ntk; j += TL::THREADS / 32) {
    int lo, hi;
    bool hole;
    warp_range(kpos, a.skpt, j * BN, BN, a.T, lane, lo, hi, hole);
    // keys past T are masked here: exp2(-lse2) of their zero scores
    // could overflow, and inf times their zero K rows is not 0
    hole = hole || (j + 1) * BN > a.T;
    if (lane == 0)
      cls[j] = classify(qstat[0], qstat[1], lo, hi, hole, a.causal,
                        a.window);
  }
  __syncthreads();

  // The producer's loads: Q and dO once, then kv tile j as the t-th tile
  // of the ring.
  auto load_q = [&]() {
    hopper::mbar_expect_tx(qbar, TL::Q_BYTES + TL::DO_BYTES);
    for (int c = 0; c < TL::NBOX; ++c)
      hopper::tma_load_4d(Qs + c * Q_BM * 64, mq, qbar, 64 * c, q0, h, b);
    for (int c = 0; c < TL::NBOXV; ++c)
      hopper::tma_load_4d(dOs + c * Q_BM * 64, mdo, qbar, 64 * c, q0, h, b);
  };
  auto load_tile = [&](int t, int j) {
    const int s = t % STAGES;
    hopper::mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
    bf16* kd = Ks + s * BN * HDP;
    bf16* vd = Vs + s * BN * HDPV;
    hopper::mbar_expect_tx(full + s, TL::K_BYTES + TL::V_BYTES);
    for (int c = 0; c < TL::NBOX; ++c)
      hopper::tma_load_4d(kd + c * BN * 64, mk, full + s, 64 * c, j * BN,
                          kvh, b);
    for (int c = 0; c < TL::NBOXV; ++c)
      hopper::tma_load_4d(vd + c * BN * 64, mv, full + s, 64 * c, j * BN,
                          kvh, b);
  };
  // the wide kernels' cursor: the next live kv tile to load (ntk once
  // every tile is loaded) and the number loaded so far
  int nj = -1, nt = 0;
  auto advance = [&]() {
    do ++nj;
    while (nj < ntk && cls[nj] == EMPTY);
  };

  if constexpr (!TL::WIDE) {
    if (warp == CONSUMERS / 32) {
      // ---- producer warp: one thread keeps the ring full
      if (lane == 0) {
        load_q();
        for (int j = 0; j < ntk; ++j)
          if (cls[j] != EMPTY) load_tile(nt++, j);
      }
      return;
    }
  } else {
    if (tid == PRODUCER) {
      load_q();
      for (advance(); nt < STAGES && nj < ntk; advance()) load_tile(nt++, nj);
    }
    __syncwarp();
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
  int* pw = pos_s + warp * BN;  // this warp's staged key positions

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

    // S = Q K^T and dP = dO V^T; P = exp2(s sl2 - lse2) (lse2 per row;
    // the mask in MIXED tiles) into the thread's shared-memory slab while
    // dP is formed
    hopper::mbar_wait(full + s, parity);
    float dpacc[BN / 2];  // defined by the first k step
    {
      float sacc[BN / 2];  // defined by the first k step
      hopper::wgmma_fence();
      ss_product<HDP, BN>(sacc, qw, Q_BM, ks, BN);
      hopper::wgmma_commit();
      ss_product<HDPV, BN>(dpacc, dow, Q_BM, vs, BN);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs<BN / 2>(sacc);
      if (cj == MIXED) {
        stage_pos<BN>(kpos, a.skpt, j * BN, a.T, lane, pw);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
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
        for (int nb = 0; nb < BN / 8; ++nb) {
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
    hopper::fence_regs<BN / 2>(dpacc);
    uint32_t da[BN / 4];
#pragma unroll
    // registers 4 nb, +1: row 0; +2, +3: row 1
    for (int nb = 0; nb < BN / 8; ++nb) {
      const float4 p = pt[nb * 256];
      const int x = 4 * nb;
      da[2 * nb] = attn::pack_bf16(p.x * (dpacc[x] - dd[0]),
                                   p.y * (dpacc[x + 1] - dd[0]));
      da[2 * nb + 1] = attn::pack_bf16(p.z * (dpacc[x + 2] - dd[1]),
                                       p.w * (dpacc[x + 3] - dd[1]));
    }

    // dQ += dS K, K MN-major, in 64-column products
    hopper::fence_regs<HDP / 2>(dq);
    hopper::wgmma_fence();
    rs_product<TL::NBOX, BN>(dq, da, ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<HDP / 2>(dq);
    hopper::fence_regs<BN / 4>(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
    if constexpr (TL::WIDE) {
      if (tid == PRODUCER && nj < ntk) {
        load_tile(nt++, nj);
        advance();
      }
      __syncwarp();
    }
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
template <int HDP, int HDPV>
cudaError_t launch(const WArgs& a, cudaStream_t st) {
  using KT = KvTile<HDP, HDPV>;
  using QT = QTile<HDP, HDPV>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.spad;
  bwd_prep<<<static_cast<unsigned>((rows + 15) / 16), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_deadsum<HDPV><<<dim3(a.H, a.B), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mdo, mk, mv;
  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        KT::BM) ||
      !hopper::make_map(&mdo, a.dout, a.hdv, a.S, a.H, a.B, a.sdos, a.sdoh,
                        a.sdob, KT::BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, KV_BN) ||
      !hopper::make_map(&mv, a.v, a.hdv, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, KV_BN))
    return cudaErrorInvalidValue;
  const int nqt = (a.S + KT::BM - 1) / KT::BM;
  const size_t kv_bytes = KT::smem_bytes(nqt);
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma<HDP, HDPV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma<HDP, HDPV><<<dim3(a.Hkv, a.B, (a.T + KV_BN - 1) / KV_BN),
                              KT::THREADS, kv_bytes, st>>>(mq, mdo, mk, mv,
                                                           a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!hopper::make_map(&mq, a.q, a.hd, a.S, a.H, a.B, a.sqs, a.sqh, a.sqb,
                        Q_BM) ||
      !hopper::make_map(&mdo, a.dout, a.hdv, a.S, a.H, a.B, a.sdos, a.sdoh,
                        a.sdob, Q_BM) ||
      !hopper::make_map(&mk, a.k, a.hd, a.T, a.Hkv, a.B, a.skt, a.skh,
                        a.skb, QT::BN) ||
      !hopper::make_map(&mv, a.v, a.hdv, a.T, a.Hkv, a.B, a.svt, a.svh,
                        a.svb, QT::BN))
    return cudaErrorInvalidValue;
  const size_t q_bytes = QT::smem_bytes((a.T + QT::BN - 1) / QT::BN);
  err = cudaFuncSetAttribute(bwd_dq_wgmma<HDP, HDPV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma<HDP, HDPV><<<dim3(a.H, a.B, (a.S + Q_BM - 1) / Q_BM),
                            QT::THREADS, q_bytes, st>>>(mq, mdo, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace bwg
}  // namespace
