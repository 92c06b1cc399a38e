// Flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py: one query token per sequence,
// q (B,H,hd), attends to a KV cache k/v (B,Hkv,T,hd) whose slots carry
// absolute positions k_pos (B,T).  A slot is kept when
// 0 <= kp <= cur_pos[b] and, with a window, cur - kp < window, so ring
// (sliding-window) caches work unchanged.  Masked scores take the finite
// NEG_INF = -1e30: a sequence with no kept slot returns mean(V), as the
// reference does.  Online softmax in fp32; fp32 inputs stay fp32.
//
// Design: split-KV flash decoding.  The TPU kernel carried (m, l, acc)
// across a sequential grid axis over the cache; here blocks run in
// parallel, so `nsplit` blocks share each (kv head, sequence), each
// handling the whole GQA group of g = H / Hkv query rows and reading
// each K/V tile once for the group.  Each block writes a partial
// (m, l, acc) per row, and the partials are merged in split order with
// weights exp(m_split - max m); with one split the block writes the
// output itself.  Slots that keep nothing are neither loaded nor
// computed: their weight would be exactly 0 whenever the sequence keeps
// a slot anywhere, which skips the empty tail of a preallocated cache.
// When a sequence keeps no slot at all, the output is mean(V) over all
// T slots, as the reference's softmax over uniform NEG_INF scores
// gives.  Any T works (ragged tiles are masked); every tensor is read
// through its strides, so the model passes its (B, W, Hkv, hd) cache as
// a transposed view.  The head dimension must be unit-stride and every
// row 16-byte aligned.
//
// Two kernels: bf16 inputs take `decode_split_mma` (the splits are equal
// pieces of the kept slot range; per-warp cp.async rings of raw bf16
// tiles; mma.sync products; the last block of each (kv head, sequence)
// merges the pieces, so one launch; design note above it).  fp32 inputs
// take `decode_split`, scalar fp32 FMAs from shared memory (never TF32)
// over fixed chunks of the cache, one 64-slot tile at a time, and a
// second launch, `decode_combine`, merges the chunks.
//
// Bound: the bytes of K/V read, 2 * B * T * Hkv * hd * sizeof(dtype) per
// layer (only the tiles holding kept slots), against 3.35 TB/s of HBM on
// an H100 SXM; the products are a few FLOPs per byte, far below the
// tensor cores' rate even with the group padded to 16 rows.
#include <limits.h>

#include "attention_common.cuh"

namespace {

using attn::from_f;
using attn::NEG_INF;
using attn::to_f;

constexpr int DBK = 64;    // cache slots per tile
constexpr int DNT = 128;   // threads per block
constexpr int GMAX = 16;   // largest GQA group (query rows per block)
constexpr int PHASES = DNT / DBK;
constexpr int RPT = GMAX / PHASES;  // score rows per thread

struct Args {
  const void* q; const void* k; const void* v;
  const int* kpos; const int* cur; void* out;
  float* m_part; float* l_part; float* acc_part;
  int* tickets;  // bf16 kernel: one zeroed counter per (batch, kv head)
  int B, H, Hkv, T, hd, g, nsplit, chunk;
  long long sqb, sqh, skb, skh, skt, svb, svh, svt;
  long long sob, soh, skpb, skpt, scb;
  float scale; int window;
};

__device__ __forceinline__ bool keep(int kp, int cur, int window) {
  bool ok = kp >= 0 && kp <= cur;
  if (window) ok = ok && (cur - kp) < window;
  return ok;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (GMAX * HD + DBK * (HD + 1) + DBK * HD +
                          GMAX * DBK + 3 * GMAX) +
         sizeof(int) * DBK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DNT) decode_split(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [GMAX][HD]
  float* Ks = Qs + GMAX * HD;          // [DBK][HD+1]
  float* Vs = Ks + DBK * (HD + 1);     // [DBK][HD]
  float* Ps = Vs + DBK * HD;           // [GMAX][DBK]
  float* m_s = Ps + GMAX * DBK;        // [GMAX]
  float* l_s = m_s + GMAX;             // [GMAX]
  float* alpha_s = l_s + GMAX;         // [GMAX]
  int* kp_s = reinterpret_cast<int*>(alpha_s + GMAX);  // [DBK]

  constexpr int DPT = (HD + DNT - 1) / DNT;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.g;
  const int cur = a.cur[b * a.scb];
  const int* kpos = a.kpos + b * a.skpb;
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + (kvh * g) * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;

  attn::load_rows<T, HD, GMAX, DNT, false>(q, a.sqh, 0, g, Qs, HD);
  if (tid < GMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[GMAX][DPT];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[gi][j] = 0.f;

  const int t0 = split * a.chunk;
  const int t1 = min(a.T, t0 + a.chunk);
  const int c = tid % DBK, ph = tid / DBK;
  for (int k0 = t0; k0 < t1; k0 += DBK) {
    bool kept = false;
    if (tid < DBK) {
      const int t = k0 + tid;
      const int kp = t < t1 ? kpos[t * a.skpt] : -1;
      kp_s[tid] = kp;
      kept = t < t1 && keep(kp, cur, a.window);
    }
    if (!__syncthreads_or(kept)) continue;

    attn::load_rows<T, HD, DBK, DNT, false>(k, a.skt, k0, t1, Ks, HD + 1);
    attn::load_rows<T, HD, DBK, DNT, false>(v, a.svt, k0, t1, Vs, HD);
    __syncthreads();

    float sc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sc[i] = 0.f;
    const float* kr = Ks + c * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int gi = ph + PHASES * i;
        if (gi < g) sc[i] = fmaf(Qs[gi * HD + d], kv, sc[i]);
      }
    }
    const int t = k0 + c;
    const bool in_range = t < t1;
    const bool kc = in_range && keep(kp_s[c], cur, a.window);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int gi = ph + PHASES * i;
      if (gi < g)
        Ps[gi * DBK + c] = !in_range ? -INFINITY
                                     : (kc ? sc[i] * a.scale : NEG_INF);
    }
    __syncthreads();

    // Online-softmax update: warp w owns rows w, w + 4, ...
    const int warp = tid / 32, lane = tid % 32;
    for (int gi = warp; gi < g; gi += DNT / 32) {
      float* pr = Ps + gi * DBK;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[gi] = alpha;
        m_s[gi] = m_new;
        l_s[gi] = l_s[gi] * alpha + rs;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tid + DNT * j;
      if (d >= HD) continue;
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi)
        if (gi < g) acc[gi][j] *= alpha_s[gi];
      for (int r = 0; r < DBK; ++r) {
        const float vv = Vs[r * HD + d];
#pragma unroll
        for (int gi = 0; gi < GMAX; ++gi)
          if (gi < g) acc[gi][j] = fmaf(Ps[gi * DBK + r], vv, acc[gi][j]);
      }
    }
    __syncthreads();
  }

  const long long row0 =
      ((static_cast<long long>(b) * a.Hkv + kvh) * a.nsplit + split) * g;
  if (tid < g) {
    a.m_part[row0 + tid] = m_s[tid];
    a.l_part[row0 + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid + DNT * j;
    if (d >= HD) continue;
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi)
      if (gi < g) a.acc_part[(row0 + gi) * HD + d] = acc[gi][j];
  }
}

// ---------------------------------------------------------------------
// bf16 inputs: the pipelined tensor-core kernel.  One block of 4 warps
// per (piece, kv head, batch) handles the whole GQA group.  The block
// first marks which of the T slots are kept (one bit each, in shared
// memory) and finds the first and last kept slot; the pieces are the
// nsplit equal, 16-slot aligned parts of that kept range, not of the
// whole cache, so no block is left with the empty tail of a
// preallocated cache and every block streams about the same bytes.
// Each warp owns its own 16-slot sub-tiles of the piece (sub-tile j
// goes to warp j % 4) and its own (m, l, o): no block barrier inside the
// loop.  A warp lists its sub-tiles that hold a kept slot, then streams
// them raw, in bf16, through its own STAGES-deep ring of 16-byte
// cp.async copies, so the next STAGES - 1 sub-tiles are in flight while
// one is computed.  The GQA group's g query rows, zero-padded to 16, are
// the M dimension of mma.sync m16n8k16 (fp32 accumulation) for both
// q K^T and P V; the Q fragments stay in registers.  The four warps'
// partials are merged once, in warp order, at the end of the block; the
// last block of each (kv head, sequence) to finish, counted on a
// ticket, merges the pieces, so there is one launch.
// Scores are kept in base 2 (scale * log2(e) folded into one multiply),
// so this kernel's partial maxima are base-2 too.
namespace dm {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 16;          // cache slots per warp step
constexpr int STAGES = 3;        // ring depth per warp
constexpr int PIECE_MAX = 2048;  // longest piece (slots)
constexpr int LIST = PIECE_MAX / (SUB * WARPS);  // sub-tiles per warp
constexpr int SCAN = 32;         // position loads in flight per thread

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;           // no ldmatrix conflicts
  static constexpr int STAGE = 2 * SUB * LD;  // K then V rows (elements)
  static constexpr int RING = WARPS * STAGES * STAGE * 2;   // bytes
  static constexpr int MERGE = WARPS * (16 * HD + 32) * 4;  // o, m, l
  static constexpr int MAIN = RING > MERGE ? RING : MERGE;
  // then mean(V), the warps' lists, the kept range, one bit per slot
  static size_t bytes(int T) {
    return MAIN + HD * 4 + WARPS * LIST * 4 + 16 + (T + 31) / 32 * 4;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS) decode_split_mma(Args a) {
  using bf16 = __nv_bfloat16;
  using SM = Smem<HD>;
  constexpr int LD = SM::LD;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char dm_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dm_smem);
  float* meanv = reinterpret_cast<float*>(dm_smem + SM::MAIN);  // [HD]
  int* list = reinterpret_cast<int*>(meanv + HD);     // [WARPS][LIST]
  int* range = list + WARPS * LIST;                   // first, last kept
  uint32_t* bits = reinterpret_cast<uint32_t*>(range + 4);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // kv heads vary fastest: the blocks in flight together read
  // neighbouring heads of the same slots, contiguous in a (B,W,Hkv,hd)
  // cache, rather than scattered rows of one head
  const int kvh = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int g = a.g;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb +
                  (kvh * g) * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + kvh * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
  const int* kpos = a.kpos + b * a.skpb;
  const int cur = a.cur[b * a.scb];

  // Q rows of the group (zero past g) as m16n8k16 A fragments; their
  // loads overlap the scan below.
  const int c0 = 2 * (lane % 4);
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = lane / 4 + 8 * (r & 1);
      const int col = 16 * kk + c0 + 8 * (r >> 1);
      qa[kk][r] = row < g ? *reinterpret_cast<const uint32_t*>(
                                q + row * a.sqh + col)
                          : 0u;
    }

  // Kept bits of all T slots (word w covers slots 32w .. 32w + 31) and
  // the first and last kept slot.
  if (tid == 0) {
    range[0] = INT_MAX;
    range[1] = -1;
  }
  __syncthreads();
  {
    const int nwords = (a.T + 31) / 32;
    int lo = INT_MAX, hi = -1;
    for (int w0 = warp; w0 < nwords; w0 += WARPS * SCAN) {
      int kp[SCAN];
#pragma unroll
      for (int i = 0; i < SCAN; ++i) {
        const int t = 32 * (w0 + WARPS * i) + lane;
        kp[i] = t < a.T ? kpos[t * a.skpt] : -1;
      }
#pragma unroll
      for (int i = 0; i < SCAN; ++i) {
        const int w = w0 + WARPS * i;
        const uint32_t word =
            __ballot_sync(0xffffffffu, w < nwords && keep(kp[i], cur,
                                                          a.window));
        if (w < nwords && lane == 0) bits[w] = word;
        if (word) {
          lo = min(lo, 32 * w + __ffs(word) - 1);
          hi = max(hi, 32 * w + 31 - __clz(word));
        }
      }
    }
    if (lane == 0) {
      atomicMin(range, lo);
      atomicMax(range + 1, hi);
    }
  }
  __syncthreads();
  const int lo = range[0], hi = range[1];
  int t0 = 0, len = 0;
  if (lo <= hi) {
    const int base = lo & ~(SUB - 1);
    const int piece =
        ((hi + 1 - base + a.nsplit - 1) / a.nsplit + SUB - 1) & ~(SUB - 1);
    t0 = base + split * piece;
    len = max(0, min(hi + 1, t0 + piece) - t0);
  }

  // This warp's sub-tiles j = warp + WARPS * lane that keep a slot.
  int n_sub;
  {
    const int j = warp + WARPS * lane;
    const int t = t0 + SUB * j;  // 16-aligned: half of one word
    const bool kept =
        SUB * j < len && ((bits[t >> 5] >> (t & 31)) & 0xffffu) != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    if (kept) list[warp * LIST + __popc(ballot & ((1u << lane) - 1))] = j;
    n_sub = __popc(ballot);
  }
  __syncwarp();

  bf16* wring = ring + warp * STAGES * SM::STAGE;
  auto fetch = [&](int j, int st) {
    bf16* kd = wring + st * SM::STAGE;
    bf16* vd = kd + SUB * LD;
#pragma unroll
    for (int idx = lane; idx < SUB * CPR; idx += 32) {
      const int r = idx / CPR, c = idx % CPR;
      const int t = t0 + j * SUB + r;
      const bool in = t < a.T;  // past T: zero-filled, never kept
      const long long tt = in ? t : t0;
      attn::cp_async16(kd + r * LD + 8 * c, k + tt * a.skt + 8 * c, in);
      attn::cp_async16(vd + r * LD + 8 * c, v + tt * a.svt + 8 * c, in);
    }
  };

  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int* mine = list + warp * LIST;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_sub) fetch(mine[p], p);
    attn::cp_async_commit();
  }
  for (int i = 0; i < n_sub; ++i) {
    if (i + STAGES - 1 < n_sub)
      fetch(mine[i + STAGES - 1], (i + STAGES - 1) % STAGES);
    attn::cp_async_commit();
    attn::cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int ts = t0 + SUB * mine[i];
    const uint32_t kept16 = (bits[ts >> 5] >> (ts & 31)) & 0xffffu;
    const bf16* ks = wring + (i % STAGES) * SM::STAGE;
    const bf16* vs = ks + SUB * LD;

    // s = q K^T over the sub-tile's 16 slots (two n8 blocks)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kb[4];
      attn::ldmatrix_x4(kb, ks + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                                16 * kk + ((lane >> 3) & 1) * 8);
      attn::mma_bf16(s[0], qa[kk], kb);
      attn::mma_bf16(s[1], qa[kk], kb + 2);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (kept16 >> (8 * nb + c0 + e)) & 1u;
        s[nb][e] = ok ? s[nb][e] * sl2 : NEG_INF;
        s[nb][2 + e] = ok ? s[nb][2 + e] * sl2 : NEG_INF;
      }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      float mt = fmaxf(fmaxf(s[0][2 * i2], s[0][2 * i2 + 1]),
                       fmaxf(s[1][2 * i2], s[1][2 * i2 + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[i2], mt);
      const float alpha = exp2f(m[i2] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * i2 + e];
          x = exp2f(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i2] = l[i2] * alpha + rs;
      m[i2] = m_new;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        o[jd][2 * i2] *= alpha;
        o[jd][2 * i2 + 1] *= alpha;
      }
    }
    // o += P V
    const uint32_t pa[4] = {attn::pack_bf16(s[0][0], s[0][1]),
                            attn::pack_bf16(s[0][2], s[0][3]),
                            attn::pack_bf16(s[1][0], s[1][1]),
                            attn::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jd = 0; jd < HD / 8; jd += 2) {
      uint32_t vb[4];
      attn::ldmatrix_x4_trans(vb, vs + (lane & 15) * LD + 8 * jd +
                                      (lane >> 4) * 8);
      attn::mma_bf16(o[jd], pa, vb);
      attn::mma_bf16(o[jd + 1], pa, vb + 2);
    }
    __syncwarp();
  }

  // Merge the warps' partials in warp order.
  __syncthreads();
  float* mg = reinterpret_cast<float*>(dm_smem);
  {
    float* ow = mg + warp * (16 * HD + 32);
    const int r = lane / 4;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ow[r * HD + 8 * jd + c0 + e] = o[jd][e];
        ow[(r + 8) * HD + 8 * jd + c0 + e] = o[jd][2 + e];
      }
    if (lane % 4 == 0) {
      ow[16 * HD + r] = m[0];
      ow[16 * HD + r + 8] = m[1];
      ow[16 * HD + 16 + r] = l[0];
      ow[16 * HD + 16 + r + 8] = l[1];
    }
  }
  if (a.nsplit == 1 && lo > hi) {
    // no slot kept: mean(V) over all T slots, as the reference's
    // softmax over uniform NEG_INF scores gives
    for (int d = tid; d < HD; d += THREADS) {
      float sum = 0.f;
      for (int t = 0; t < a.T; ++t) sum += __bfloat162float(v[t * a.svt + d]);
      meanv[d] = sum / a.T;
    }
  }
  __syncthreads();

  bf16* out = static_cast<bf16*>(a.out) + b * a.sob + (kvh * g) * a.soh;
  const long long row0 =
      ((static_cast<long long>(b) * a.Hkv + kvh) * a.nsplit + split) * g;
  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int gi = idx / HD, d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      M = fmaxf(M, mg[w * (16 * HD + 32) + 16 * HD + gi]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* ow = mg + w * (16 * HD + 32);
      const float f = exp2f(ow[16 * HD + gi] - M);
      L += ow[16 * HD + 16 + gi] * f;
      O += ow[gi * HD + d] * f;
    }
    if (a.nsplit == 1) {
      out[gi * a.soh + d] =
          __float2bfloat16(lo > hi ? meanv[d] : O / fmaxf(L, 1e-30f));
    } else {
      if (d == 0) {
        a.m_part[row0 + gi] = M;
        a.l_part[row0 + gi] = L;
      }
      a.acc_part[(row0 + gi) * HD + d] = O;
    }
  }
  if (a.nsplit == 1) return;

  // The last of the nsplit blocks of this (kv head, sequence) to finish
  // merges their partials, in piece order; it resets the ticket for the
  // next call.  A partial that kept nothing has m = NEG_INF, l = 0 and
  // o = 0, so its weight is exactly 0.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + b * a.Hkv + kvh;
    const bool last = atomicAdd(ticket, 1) == a.nsplit - 1;
    if (last) *ticket = 0;
    range[2] = last;
  }
  __syncthreads();
  if (!range[2]) return;
  __threadfence();
  if (lo > hi) {
    // no slot kept: mean(V) over all T slots, as the reference's
    // softmax over uniform NEG_INF scores gives
    for (int d = tid; d < HD; d += THREADS) {
      float sum = 0.f;
      for (int t = 0; t < a.T; ++t) sum += __bfloat162float(v[t * a.svt + d]);
      meanv[d] = sum / a.T;
    }
    __syncthreads();
    for (int idx = tid; idx < g * HD; idx += THREADS)
      out[(idx / HD) * a.soh + idx % HD] = __float2bfloat16(meanv[idx % HD]);
    return;
  }
  // the pieces' (m, l) into shared memory (the merge buffer is free),
  // then each row's weights, then each output sums over the pieces
  const long long first = (static_cast<long long>(b) * a.Hkv + kvh) *
                          a.nsplit * g;
  const int np = a.nsplit * g;
  float* pm = mg;          // [nsplit][g]: m, then the weight
  float* pl = mg + np;     // [nsplit][g]
  float* rl = pl + np;     // [g]: 1 / L
  for (int i = tid; i < np; i += THREADS) {
    pm[i] = __ldcg(a.m_part + first + i);
    pl[i] = __ldcg(a.l_part + first + i);
  }
  __syncthreads();
  if (tid < g) {
    float M = NEG_INF, L = 0.f;
    for (int sp = 0; sp < a.nsplit; ++sp) M = fmaxf(M, pm[sp * g + tid]);
    for (int sp = 0; sp < a.nsplit; ++sp) {
      const float f = exp2f(pm[sp * g + tid] - M);
      pm[sp * g + tid] = f;
      L += f * pl[sp * g + tid];
    }
    rl[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int gi = idx / HD, d = idx % HD;
    float O = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < a.nsplit; ++sp)
      O += pm[sp * g + gi] *
           __ldcg(a.acc_part + (first + sp * g + gi) * HD + d);
    out[gi * a.soh + d] = __float2bfloat16(O * rl[gi]);
  }
}

}  // namespace dm

// fp32 inputs: merge the chunks' partial (m, l, acc) of one (head,
// batch) row, in split order.  The chunk weights are computed once into
// shared memory, then each thread sums its head-dim columns over the
// chunks.
__global__ void __launch_bounds__(DNT) decode_combine(Args a) {
  extern __shared__ float wts[];  // [nsplit]
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / a.g, gi = h % a.g;
  const long long row0 =
      (static_cast<long long>(b) * a.Hkv + kvh) * a.nsplit * a.g + gi;
  float M = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s)
    M = fmaxf(M, a.m_part[row0 + static_cast<long long>(s) * a.g]);
  float* out = static_cast<float*>(a.out) + b * a.sob + h * a.soh;
  if (!(M > 0.5f * NEG_INF)) {
    // No chunk kept a slot: every score is NEG_INF, so the reference's
    // softmax is uniform and the output is mean(V) over all T slots.
    const float* v = static_cast<const float*>(a.v) + b * a.svb +
                     kvh * a.svh;
    for (int d = threadIdx.x; d < a.hd; d += DNT) {
      float o = 0.f;
      for (int t = 0; t < a.T; ++t) o += v[t * a.svt + d];
      out[d] = o / a.T;
    }
    return;
  }
  for (int s = threadIdx.x; s < a.nsplit; s += DNT)
    wts[s] = expf(a.m_part[row0 + static_cast<long long>(s) * a.g] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < a.nsplit; ++s)
    L += wts[s] * a.l_part[row0 + static_cast<long long>(s) * a.g];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < a.hd; d += DNT) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.nsplit; ++s) {
      const long long r = row0 + static_cast<long long>(s) * a.g;
      o += wts[s] * a.acc_part[r * a.hd + d];
    }
    out[d] = o * inv;
  }
}

// fp32 inputs: the scalar kernel above (no TF32), then the combine.
template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  decode_split<float, HD>
      <<<dim3(a.nsplit, a.Hkv, a.B), DNT, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<<<dim3(a.H, a.B), DNT, a.nsplit * sizeof(float), stream>>>(
      a);
  return cudaGetLastError();
}

// bf16 inputs: the tensor-core kernel, one launch (the last block of
// each (kv head, sequence) merges its pieces).
template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t bytes = dm::Smem<HD>::bytes(a.T);
  // the pieces (at most a T / nsplit part of the kept range, rounded up
  // to 16 slots) must fit the warps' lists
  // and the last block's merge stages 2 * nsplit * g + g floats in the
  // ring's space
  if ((a.T + a.nsplit - 1) / a.nsplit + dm::SUB - 1 > dm::PIECE_MAX ||
      (2 * a.nsplit + 1) * a.g * 4 > dm::Smem<HD>::MAIN || bytes > 232448)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dm::decode_split_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dm::decode_split_mma<HD>
      <<<dim3(a.Hkv, a.nsplit, a.B), dm::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int dtype, cudaStream_t st) {
  const bool bf = dtype == 1;
  switch (a.hd) {
    case 16: return bf ? launch_bf16<16>(a, st) : launch_f32<16>(a, st);
    case 32: return bf ? launch_bf16<32>(a, st) : launch_f32<32>(a, st);
    case 64: return bf ? launch_bf16<64>(a, st) : launch_f32<64>(a, st);
    case 96: return bf ? launch_bf16<96>(a, st) : launch_f32<96>(a, st);
    case 112: return bf ? launch_bf16<112>(a, st) : launch_f32<112>(a, st);
    case 128: return bf ? launch_bf16<128>(a, st) : launch_f32<128>(a, st);
    case 160: return bf ? launch_bf16<160>(a, st) : launch_f32<160>(a, st);
    case 256: return bf ? launch_bf16<256>(a, st) : launch_f32<256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, H, Hkv, T, hd, nsplit, chunk (chunk a multiple of 64, nsplit
// chunks covering T).  strides (elements): q (b,h), k (b,h,t), v (b,h,t),
// out (b,h), k_pos (b,t), cur_pos (b); the head dimension of q, k, v and
// out is unit-stride.  m_part/l_part hold B*Hkv*nsplit*g floats and
// acc_part that times hd (unused when a bf16 call has nsplit == 1);
// tickets holds B*Hkv int32 zeros (bf16 only; left at zero).  dtype:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* k_pos,
                                    const void* cur_pos, void* out,
                                    void* m_part, void* l_part,
                                    void* acc_part, void* tickets,
                                    const long long* dims,
                                    const long long* strides, float scale,
                                    int window, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.kpos = static_cast<const int*>(k_pos);
  a.cur = static_cast<const int*>(cur_pos);
  a.out = out;
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.tickets = static_cast<int*>(tickets);
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.T = static_cast<int>(dims[3]);
  a.hd = static_cast<int>(dims[4]);
  a.nsplit = static_cast<int>(dims[5]);
  a.chunk = static_cast<int>(dims[6]);
  a.g = a.H / a.Hkv;
  a.sqb = strides[0]; a.sqh = strides[1];
  a.skb = strides[2]; a.skh = strides[3]; a.skt = strides[4];
  a.svb = strides[5]; a.svh = strides[6]; a.svt = strides[7];
  a.sob = strides[8]; a.soh = strides[9];
  a.skpb = strides[10]; a.skpt = strides[11];
  a.scb = strides[12];
  a.scale = scale; a.window = window;
  if (a.g > GMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(a, dtype, st));
}
