// Prefill flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: q (B,H,S,hd) attends to k/v
// (B,Hkv,T,hd) with per-token positions q_pos (B,S) and k_pos (B,T).
// A pair is kept when kp >= 0, qp >= 0, kp <= qp (causal) and, with a
// window, qp - kp < window; masked scores take the finite NEG_INF = -1e30,
// so a row whose keys are all masked returns mean(V), as the reference
// does.  Online softmax in fp32.
//
// Design.  One block per (q tile of 64 rows, head h, batch b) loops over
// kv tiles of head h / g (GQA through the index, no KV replication).  A
// kv tile in which no (row, key) pair is kept is skipped, without
// loading K/V, once every row of the block has seen a kept key: then
// exp(NEG_INF - m) is exactly 0 for it.  Tiles past the causal edge are
// skipped that way; the Pallas grid visits them all.  Rows still
// without a kept key visit every tile (fully masked rows and the early,
// fully masked tiles of a windowed row), and the first kept key washes
// their sum out through alpha = exp(m_prev - m_new).  Ragged S and T
// tails are masked here, so no divisibility is required, and every
// tensor is read through its strides (the model passes transposed views
// of (B,S,H,hd) activations) with a unit-stride head dimension and
// 16-byte aligned rows: Q, K and V tiles arrive as 16-byte vector loads,
// all of a thread's loads for a tile issued before any is used.
//
// Two kernels share that design: bf16 inputs run QK^T and PV on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation, P rounded to bf16
// as FlashAttention does); fp32 inputs run scalar fp32 FMAs from shared
// memory, so they are never computed in TF32.
//
// Bound.  About 2*B*H*S*T*hd multiply-adds under the causal mask (4 FLOPs
// per kept (q,k,d) triple: QK^T and PV), against 989 TFLOP/s bf16 tensor
// cores on an H100 SXM (67 TFLOP/s fp32 without them).  mma.sync reaches
// only part of that rate and nothing here overlaps loads with products;
// wgmma fed by TMA with a producer warp is the next step.
#include "attention_common.cuh"

namespace {

using attn::from_f;
using attn::NEG_INF;

// fp32 kernel (scalar FMAs) tiling
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per kv tile
constexpr int NT = 256;  // threads: 32 row groups (2 rows) x 8 column groups

struct Args {
  const void* q; const void* k; const void* v;
  const int* qpos; const int* kpos; void* out;
  int B, H, Hkv, S, T, g;
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (HD + 1) + HD * (BK + 1) + BK * HD +
                          BQ * (BK + 1)) +
         sizeof(int) * (BQ + BK);
}

// fp32 inputs: each thread owns 2 query rows x 4 keys of S and the same
// 2 rows x HD/8 columns of O, all in fp32 from shared memory.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][HD+1]
  float* Kt = Qs + BQ * (HD + 1);          // [HD][BK+1], K transposed
  float* Vs = Kt + HD * (BK + 1);          // [BK][HD]
  float* Ps = Vs + BK * HD;                // [BQ][BK+1]
  int* qp_s = reinterpret_cast<int*>(Ps + BQ * (BK + 1));  // [BQ]
  int* kp_s = qp_s + BQ;                                   // [BK]

  constexpr int CPT = BK / 8;  // columns per thread
  constexpr int DPT = HD / 8;  // output dims per thread
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
    attn::load_rows<T, HD, BK, NT, false>(v, a.svt, k0, a.T, Vs, HD);
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
      const float* vr = Vs + c * HD + cg;
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
  }
}

// ---------------------------------------------------------------------
// bf16 inputs: the same algorithm on the tensor cores.  One block of 4
// warps per (64-row q tile, head, batch); each warp owns 16 query rows,
// keeps its (16, HD) output in mma accumulators and its softmax state in
// registers, and walks kv tiles of 64 keys: S = Q K^T by m16n8k16 bf16
// products with fp32 accumulation, masking and the online softmax on the
// accumulator fragments, then O += P V with P rounded to bf16 straight
// from those fragments.  Q, K and V sit in shared memory as bf16 with
// rows padded by 8 elements, so every ldmatrix is free of bank conflicts.
constexpr int MBQ = 64;   // query rows per block (16 per warp)
constexpr int MBK = 64;   // keys per kv tile
constexpr int MT = 128;   // threads

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (MBQ + 2 * MBK) * (HD + 8) +
         sizeof(int) * (MBQ + MBK);
}

template <int HD>
__global__ void __launch_bounds__(MT) flash_fwd_mma(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8;
  constexpr int NJ = MBK / 8;    // key column tiles of S
  constexpr int KS = HD / 16;    // k-steps of Q K^T
  constexpr int ND = HD / 8;     // head-dim column tiles of O
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);   // [MBQ][LD]
  bf16* Ks = Qs + MBQ * LD;                        // [MBK][LD]
  bf16* Vs = Ks + MBK * LD;                        // [MBK][LD]
  int* qp_s = reinterpret_cast<int*>(Vs + MBK * LD);  // [MBQ]
  int* kp_s = qp_s + MBQ;                             // [MBK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * MBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.g;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + kvh * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;

  attn::copy_rows<HD, MBQ, MT>(q, a.sqs, q0, a.S, Qs, LD);
  for (int r = tid; r < MBQ; r += MT) {
    const int qi = q0 + r;
    qp_s[r] = qi < a.S ? a.qpos[b * a.sqpb + qi * a.sqps] : 0;
  }
  __syncthreads();

  // This thread's rows of the block: r0 and r0 + 8 (C-fragment rows).
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  int qpr[2];
  bool rvalid[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpr[i] = qp_s[r0 + 8 * i];
    rvalid[i] = q0 + r0 + 8 * i < a.S;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int nk = (a.T + MBK - 1) / MBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * MBK;
    if (tid < MBK)
      kp_s[tid] = k0 + tid < a.T ? a.kpos[b * a.skpb + (k0 + tid) * a.skpt]
                                 : -1;
    __syncthreads();

    // Skip the tile when no kept pair lies in it and every row is alive
    // (this thread checks its own fragment positions; the block's threads
    // together cover every (row, key) pair).
    bool idle = true;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rvalid[i]) continue;
      if (!(m[i] > 0.5f * NEG_INF)) idle = false;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c0 + e;
          if (k0 + c < a.T && keep(qpr[i], kp_s[c], a.causal, a.window))
            idle = false;
        }
    }
    if (__syncthreads_and(idle)) continue;

    attn::copy_rows<HD, MBK, MT>(k, a.skt, k0, a.T, Ks, LD);
    attn::copy_rows<HD, MBK, MT>(v, a.svt, k0, a.T, Vs, LD);
    __syncthreads();

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      attn::ldmatrix_x4(qa, Qs + (16 * warp + (lane & 15)) * LD + 16 * ks +
                                (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t kb[2];
        attn::ldmatrix_x2(kb, Ks + (8 * j + (lane & 7)) * LD + 16 * ks +
                                  ((lane >> 3) & 1) * 8);
        attn::mma_bf16(s[j], qa, kb);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c0 + e;
          float& x = s[j][2 * i + e];
          if (k0 + c < a.T) {
            x = keep(qpr[i], kp_s[c], a.causal, a.window) ? x * a.scale
                                                          : NEG_INF;
            mt = fmaxf(mt, x);
          } else {
            x = -INFINITY;  // past T: not a key at all
          }
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = x == -INFINITY ? 0.f : expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      const uint32_t pa[4] = {
          attn::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          attn::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          attn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          attn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t vb[4];
        attn::ldmatrix_x4_trans(vb, Vs + (16 * kk + (lane & 15)) * LD +
                                        8 * j + (lane >> 4) * 8);
        attn::mma_bf16(o[j], pa, vb);
        attn::mma_bf16(o[j + 1], pa, vb + 2);
      }
    }
    __syncthreads();
  }

  bf16* out = static_cast<bf16*>(a.out) + b * a.sob + h * a.soh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int qi = q0 + r0 + 8 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + qi * a.sos + 8 * j + c0) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + MBQ - 1) / MBQ, a.H, a.B);
  flash_fwd_mma<HD><<<grid, MT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_fwd<T, HD><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// fp32 inputs take the FMA kernel (no TF32), bf16 inputs the
// tensor-core kernel.
cudaError_t dispatch(const Args& a, int dtype, int hd, cudaStream_t st) {
  if (dtype == 1) {
    switch (hd) {
      case 16: return launch_mma<16>(a, st);
      case 32: return launch_mma<32>(a, st);
      case 64: return launch_mma<64>(a, st);
      case 112: return launch_mma<112>(a, st);
      case 128: return launch_mma<128>(a, st);
      case 160: return launch_mma<160>(a, st);
      case 256: return launch_mma<256>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 16: return launch<float, 16>(a, st);
    case 32: return launch<float, 32>(a, st);
    case 64: return launch<float, 64>(a, st);
    case 112: return launch<float, 112>(a, st);
    case 128: return launch<float, 128>(a, st);
    case 160: return launch<float, 160>(a, st);
    case 256: return launch<float, 256>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: B, H, Hkv, S, T, hd.  strides (elements): q (b,h,s), k (b,h,t),
// v (b,h,t), out (b,h,s), q_pos (b,s), k_pos (b,t); the head dimension
// of q, k, v and out is unit-stride.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* k_pos, void* out,
                                   const long long* dims,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.qpos = static_cast<const int*>(q_pos);
  a.kpos = static_cast<const int*>(k_pos);
  a.out = out;
  a.B = static_cast<int>(dims[0]);
  a.H = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.S = static_cast<int>(dims[3]);
  a.T = static_cast<int>(dims[4]);
  const int hd = static_cast<int>(dims[5]);
  a.g = a.H / a.Hkv;
  a.sqb = strides[0]; a.sqh = strides[1]; a.sqs = strides[2];
  a.skb = strides[3]; a.skh = strides[4]; a.skt = strides[5];
  a.svb = strides[6]; a.svh = strides[7]; a.svt = strides[8];
  a.sob = strides[9]; a.soh = strides[10]; a.sos = strides[11];
  a.sqpb = strides[12]; a.sqps = strides[13];
  a.skpb = strides[14]; a.skpt = strides[15];
  a.scale = scale; a.causal = causal; a.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(a, dtype, hd, st));
}
