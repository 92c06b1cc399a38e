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
// Design: split-KV flash decoding in two passes.  The TPU kernel carried
// (m, l, acc) across a sequential grid axis over the cache; here blocks
// run in parallel, so the cache axis is cut into `nsplit` chunks and
// one block per (chunk, kv head, batch) handles the whole GQA group of
// g = H / Hkv query rows, reading each K/V tile once for the group.  It
// writes a partial (m, l, acc) per row, and `decode_combine` merges the
// chunks with weights exp(m_chunk - max m).  The wrapper picks nsplit so
// that B * Hkv * nsplit makes a few waves on the card.  A tile with no
// kept slot is neither loaded nor computed: its weight would be exactly
// 0 whenever the sequence keeps a slot anywhere, which skips the empty
// tail of a preallocated cache.  When a sequence keeps no slot at all,
// every chunk reports m = NEG_INF with l = 0, and the combine pass
// returns mean(V) over all T slots itself, as the reference's softmax
// over uniform NEG_INF scores does.  K/V tiles arrive as 16-byte
// vector loads, all of a thread's loads for a tile issued before any is
// used.  Any T works (ragged tiles are masked); every tensor is read
// through its strides, so the model passes its (B, W, Hkv, hd) cache as
// a transposed view.  The head dimension must be unit-stride and every
// row 16-byte aligned.
//
// Bound: the bytes of K/V read, 2 * B * T * Hkv * hd * sizeof(dtype) per
// layer (only the tiles holding kept slots), against 3.35 TB/s of HBM on
// an H100 SXM.  The products are scalar fp32 FMAs from shared memory.
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

// Merge the chunks' partial (m, l, acc) of one (head, batch) row.
template <typename T>
__global__ void __launch_bounds__(DNT) decode_combine(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / a.g, gi = h % a.g;
  const long long row0 =
      (static_cast<long long>(b) * a.Hkv + kvh) * a.nsplit * a.g + gi;
  float M = NEG_INF;
  for (int s = 0; s < a.nsplit; ++s)
    M = fmaxf(M, a.m_part[row0 + static_cast<long long>(s) * a.g]);
  float L = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const long long r = row0 + static_cast<long long>(s) * a.g;
    L += expf(a.m_part[r] - M) * a.l_part[r];
  }
  T* out = static_cast<T*>(a.out) + b * a.sob + h * a.soh;
  if (!(M > 0.5f * NEG_INF)) {
    // No chunk kept a slot: every score is NEG_INF, so the reference's
    // softmax is uniform and the output is mean(V) over all T slots.
    const T* v = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
    for (int d = threadIdx.x; d < a.hd; d += DNT) {
      float o = 0.f;
      for (int t = 0; t < a.T; ++t) o += to_f(v[t * a.svt + d]);
      out[d] = from_f<T>(o / a.T);
    }
    return;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < a.hd; d += DNT) {
    float o = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const long long r = row0 + static_cast<long long>(s) * a.g;
      o += expf(a.m_part[r] - M) * a.acc_part[r * a.hd + d];
    }
    out[d] = from_f<T>(o * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  decode_split<T, HD><<<dim3(a.nsplit, a.Hkv, a.B), DNT, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(a.H, a.B), DNT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 112: return launch<T, 112>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 160: return launch<T, 160>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, H, Hkv, T, hd, nsplit, chunk (chunk a multiple of 64, nsplit
// chunks covering T).  strides (elements): q (b,h), k (b,h,t), v (b,h,t),
// out (b,h), k_pos (b,t), cur_pos (b); the head dimension of q, k, v and
// out is unit-stride.  m_part/l_part hold B*Hkv*nsplit*g floats and
// acc_part that times hd.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* k_pos,
                                    const void* cur_pos, void* out,
                                    void* m_part, void* l_part,
                                    void* acc_part, const long long* dims,
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
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, st)
                               : dispatch<float>(a, st);
  return static_cast<int>(err);
}
