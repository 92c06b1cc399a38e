// Batched ARMA(p, q) fit by conditional sum of squares (CSS) and Adam,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX program `_fit_arma_batch` in
// src/repro/control/forecast.py: a vmap over rows of `_fit_arma_core`,
// which runs `steps` Adam steps (a `lax.scan`) on the loss mean(e^2) of
// the CSS recursion (another `lax.scan`), its gradient taken by reverse
// mode through that scan.  For each row y (length L) and parameters
// (c, phi_1..p, theta_1..q):
//
//     e_t = y_t - c - sum_i phi_i y_{t-1-i} - sum_j theta_j e_{t-1-j}
//
// with y and e zero before t = 0 (the reference's k = max(p, q, 1)
// leading zeros).  Adam as the reference: m = 0.9 m + 0.1 g, v = 0.999 v
// + 0.001 g^2, bias corrections 1 - beta^t with t = step + 1, update
// p -= lr m^/(sqrt(v^) + 1e-8).
//
// Gradient without a tape: e is linear in its own history, so each
// sensitivity s_k,t = de_t/dparam_k obeys the same recursion,
//
//     s_k,t = u_k,t - sum_j theta_j s_k,t-1-j,
//     u = -1 (c), -y_{t-1-i} (phi_i), -e_{t-1-j} (theta_j),
//
// and g_k = (2/L) sum_t e_t s_k,t.  s_theta_j is s_theta_1 delayed by
// j - 1 points (same recursion, input delayed), so one theta chain
// serves all q.
//
// Design: a time-parallel blocked scan within each row.  One block of
// 256 threads per row; the row sits in shared memory.  Thread i owns the
// chunk [i T, min((i+1) T, L)), T = ceil(L / 256): the layout depends on
// L alone, never on the batch.  Per Adam step:
//   A. every thread runs e, s_c and s_phi over its chunk from a zero
//      state (the input x_t = y_t - c - sum phi_i y_{t-1-i} is computed
//      per point); lanes 0..q-1 of warp 0 then run the homogeneous
//      recursion from a unit state over T points, the columns of M (the
//      state map of one full chunk), and warp 0 squares M into M^2, ...,
//      M^32; one barrier;
//   1. a scan carries the chunks' end states across chunks: within each
//      warp by shuffles (level k adds M^(2^k) times the state of the lane
//      2^k back), the 8 warps' totals through shared memory behind one
//      barrier, each warp's entering state folded from the totals before
//      it, and M^lane times that state added per lane (`scan`);
//   B. every thread runs e, s_c and s_phi again from the state so found,
//      summing e^2 and e s over its points, and s_theta_1 (input
//      -e_{t-1}) from a zero state;
//   2. the same scan carries s_theta_1 (the powers of M are reused);
//   C. every thread runs e (again, the same bits) and s_theta_1 from
//      their entering states and sums e s_theta_j;
//   then each sum is reduced by a fixed tree (warp shuffles, then the 8
//   warps' values in shared memory: no atomics), and threads 1..p+q+1
//   take the Adam step of one parameter each and publish it in shared
//   memory.  Five barriers a step.  Adam's bias corrections come from
//   the host (ref.adam_bias), a double-precision power a step being too
//   long a chain to leave on the step's critical path.
// Registers hold only the chains' q-long states; shared memory holds the
// row beside at most 665 floats, so a row of up to 57,447 points fits.
// Rows never interact, so a row's result is the same bits alone, in any
// batch and in any order (the batch-purity contract of the reference's
// fit cache and dedupe), and repeats are bit-identical.
//
// Arithmetic: every product and sum is rounded on its own in fp32 (no FMA
// contraction), in the order of the plain version (ref.arma_fit_ref),
// which runs the same chunks, scan and tree vectorised over rows and
// chunks: x_t = ((y_t - c) - phi_1 y_{t-1}) - ...; the feedback
// -theta_q h_q - ... - theta_1 h_1 from the oldest lag, then + input; a
// matrix-vector product from its first column up, added to the state
// (in `scan`: a warp's entering state E folded as M^32 E + total, M^lane
// applied by the bits of the lane from the lowest); each chunk's sums in
// t order.  So kernel and plain version agree bit
// for bit, which a fixed tolerance could not promise: near an optimum,
// or on a short row, Adam amplifies a rounding difference in the
// gradient to a different trajectory.  Against the JAX reference, and
// against the sequential recursion, the fit is held to stated
// tolerances.
//
// Bound: operations, and a dependency chain.  The work is steps x L x
// (a few dozen fp32 operations), microseconds at the card's fp32 rate,
// and the bytes are the rows and parameters once.  A sequential walk
// over t cannot go below steps x L dependent operations (~0.85 ms for
// 150 steps over 2,815 points); the blocked scan's chain per step is
// three chunk passes of T points, the powers' five squarings, two scans
// of 5 shuffle levels and a fold over at most 7 warps, the reduction
// and five barriers.
#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int NT = 256;          // threads a block: one chunk of the row each
constexpr int NW = NT / 32;      // warps a block
constexpr int MAX_ORDER = 8;     // p + q
constexpr int LEVELS = 5;        // log2(32): shuffle levels of the scan
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448; // shared memory a block may use

struct Args {
  const float* y; const float* init; const float* bias; float* params;
  float* loss;
  long long rows, len, ldy;
  int steps;
  float lr;
};

// Shared memory, in floats: the powers of M [LEVELS + 1][Q][Q], the
// warps' totals of the two scans [NW][NA * Q] and [NW][Q], the reduction
// [NW][K + 1], the parameters [K], then the row [L].
template <int P, int Q>
struct Layout {
  static constexpr int K = P + 1 + Q;
  static constexpr int NA = P + 2;               // e, s_c, s_phi_1..p
  static constexpr int HEAD = (LEVELS + 1) * Q * Q + NW * NA * Q + NW * Q +
                              NW * (K + 1) + K;
};

// out = pw v, (pw v)_r = pw_r0 v_0 + pw_r1 v_1 + ..., summed from the left
template <int Q>
__device__ __forceinline__ void matvec(const float* pw, const float* v,
                                       float* out) {
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    float acc = __fmul_rn(pw[r * Q], v[0]);
#pragma unroll
    for (int m = 1; m < Q; ++m) acc = __fadd_rn(acc, __fmul_rn(pw[r * Q + m], v[m]));
    out[r] = acc;
  }
}

// -(theta_q h_q) - theta_{q-1} h_{q-1} - ... - theta_1 h_1 (h most recent
// first), each product and sum rounded on its own, in this order.
template <int Q>
__device__ __forceinline__ float ma_sum(const float* th, const float* h) {
  float z = -__fmul_rn(th[Q - 1], h[Q - 1]);
#pragma unroll
  for (int j = Q - 2; j >= 0; --j) z = __fsub_rn(z, __fmul_rn(th[j], h[j]));
  return z;
}

// shift v into a state held most recent first
template <int N>
__device__ __forceinline__ void push(float* h, float v) {
#pragma unroll
  for (int j = N - 1; j > 0; --j) h[j] = h[j - 1];
  h[0] = v;
}

// x_t = ((y_t - c) - phi_1 y_{t-1}) - ... with yl = y_{t-1}, y_{t-2}, ...
template <int P>
__device__ __forceinline__ float ar_input(float yt, float c, const float* phi,
                                          const float* yl) {
  float x = __fsub_rn(yt, c);
#pragma unroll
  for (int i = 0; i < P; ++i) x = __fsub_rn(x, __fmul_rn(phi[i], yl[i]));
  return x;
}

// The carry of N chains across chunks.  On entry b holds this thread's
// chunk's end state from a zero entry; on exit, the state entering its
// chunk.  pw[k] = M^(2^k), k = 0..LEVELS; tot: [NW][N * Q].
//   1. within each warp, a Hillis-Steele scan by shuffles: at level k
//      lane l >= d = 2^k adds M^d times lane l - d's state;
//   2. lane 31 publishes its warp's total; one barrier;
//   3. each thread folds the totals of the warps before its own, E =
//      M^32 E + total, from E = 0: the state entering its warp;
//   4. the state entering its chunk is lane l - 1's state plus M^l E,
//      M^l applied by the bits of l from the lowest (lane 0: E).
template <int N, int Q>
__device__ __forceinline__ void scan(float (&b)[N][Q], float* tot,
                                     const float* pw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < LEVELS; ++k) {
    const int d = 1 << k;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s[Q], add[Q];
#pragma unroll
      for (int m = 0; m < Q; ++m) s[m] = __shfl_up_sync(FULL, b[n][m], d);
      if (lane >= d) {
        matvec<Q>(pw + k * Q * Q, s, add);
#pragma unroll
        for (int r = 0; r < Q; ++r) b[n][r] = __fadd_rn(b[n][r], add[r]);
      }
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < Q; ++r) tot[(warp * N + n) * Q + r] = b[n][r];
  }
  __syncthreads();
  // (3 and 4 run every step on every thread and select: the loads and the
  // chains of the N states interleave)
  float in[N][Q];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < Q; ++r) in[n][r] = 0.f;
#pragma unroll
  for (int w = 0; w < NW - 1; ++w) {
    const bool before = w < warp;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float tmp[Q];
      matvec<Q>(pw + LEVELS * Q * Q, in[n], tmp);
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        const float next = __fadd_rn(tmp[r], tot[(w * N + n) * Q + r]);
        in[n][r] = before ? next : in[n][r];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < LEVELS; ++k) {
    const bool bit = (lane >> k) & 1;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float tmp[Q];
      matvec<Q>(pw + k * Q * Q, in[n], tmp);
#pragma unroll
      for (int r = 0; r < Q; ++r) in[n][r] = bit ? tmp[r] : in[n][r];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const float prev = __shfl_up_sync(FULL, b[n][r], 1);
      b[n][r] = lane == 0 ? in[n][r] : __fadd_rn(prev, in[n][r]);
    }
}

template <int P, int Q>
__global__ void __launch_bounds__(NT) arma_fit_kernel(Args a) {
  using Lay = Layout<P, Q>;
  constexpr int K = Lay::K, NA = Lay::NA;
  constexpr int PL = P > 0 ? P : 1;   // array extents; unused when 0
  constexpr int QL = Q > 0 ? Q : 1;
  extern __shared__ float sm[];
  float* pw = sm;
  float* tot1 = pw + (LEVELS + 1) * Q * Q;
  float* tot2 = tot1 + NW * NA * Q;
  float* red = tot2 + NW * Q;
  float* prm_s = red + NW * (K + 1);
  float* ys = prm_s + K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int L = static_cast<int>(a.len);
  const int span = (L + NT - 1) / NT;
  const int t0 = min(tid * span, L), t1 = min(t0 + span, L);

  const float* yr = a.y + row * a.ldy;
  for (int t = tid; t < L; t += NT) ys[t] = yr[t];
  if (tid < K) prm_s[tid] = a.init[row * K + tid];
  __syncthreads();
  float y0[PL];   // y_{t0-1}, y_{t0-2}, ...: zero before t = 0
#pragma unroll
  for (int i = 0; i < PL; ++i) y0[i] = t0 - 1 - i >= 0 ? ys[t0 - 1 - i] : 0.f;

  float m = 0.f, v = 0.f;   // Adam's moments of parameter tid - 1
  const float fl = static_cast<float>(L);
  const float two_over_l = __fdiv_rn(2.f, fl);
  float loss = 0.f;
  for (int it = 0; it < a.steps; ++it) {
    // Adam's bias corrections of this step, for threads 1..K
    float bc1 = 1.f, bc2 = 1.f;
    if (tid >= 1 && tid <= K) {
      bc1 = a.bias[2 * it];
      bc2 = a.bias[2 * it + 1];
    }
    float prm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) prm[k] = prm_s[k];
    const float c = prm[0];
    const float* phi = prm + 1;
    // per-thread sums: e^2, then e s_c, e s_phi_1..p, e s_theta_1..q
    float part[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) part[k] = 0.f;
    if constexpr (Q == 0) {
      float yl[PL];
#pragma unroll
      for (int i = 0; i < PL; ++i) yl[i] = y0[i];
      for (int t = t0; t < t1; ++t) {
        const float yt = ys[t];
        const float e = ar_input<P>(yt, c, phi, yl);
        part[0] = __fadd_rn(part[0], __fmul_rn(e, e));
        part[1] = __fadd_rn(part[1], __fmul_rn(e, -1.f));
#pragma unroll
        for (int i = 0; i < P; ++i)
          part[2 + i] = __fadd_rn(part[2 + i], __fmul_rn(e, -yl[i]));
        if (P > 0) push<PL>(yl, yt);
      }
    } else {
      const float* th = prm + 1 + P;
      // A: e, s_c, s_phi over the chunk from a zero state
      float st[NA][QL];
#pragma unroll
      for (int n = 0; n < NA; ++n)
#pragma unroll
        for (int r = 0; r < QL; ++r) st[n][r] = 0.f;
      {
        float yl[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i) yl[i] = y0[i];
        for (int t = t0; t < t1; ++t) {
          const float yt = ys[t];
          float u[NA];
          u[0] = ar_input<P>(yt, c, phi, yl);
          u[1] = -1.f;
#pragma unroll
          for (int i = 0; i < P; ++i) u[2 + i] = -yl[i];
#pragma unroll
          for (int n = 0; n < NA; ++n)
            push<Q>(st[n], __fadd_rn(ma_sum<Q>(th, st[n]), u[n]));
          if (P > 0) push<PL>(yl, yt);
        }
      }
      // M: column j is the state after T points from a 1 at lag j + 1;
      // warp 0 squares it into M^2, M^4, ..., M^32
      if (warp == 0) {
        if (lane < Q) {
          float h[QL];
#pragma unroll
          for (int r = 0; r < QL; ++r) h[r] = r == lane ? 1.f : 0.f;
          for (int t = 0; t < span; ++t) push<Q>(h, ma_sum<Q>(th, h));
#pragma unroll
          for (int r = 0; r < Q; ++r) pw[r * Q + lane] = h[r];
        }
        __syncwarp();
        for (int k = 0; k < LEVELS; ++k) {
          const float* pk = pw + k * Q * Q;
          for (int i = lane; i < Q * Q; i += 32) {
            const int r = i / Q, col = i % Q;
            float acc = __fmul_rn(pk[r * Q], pk[col]);
#pragma unroll
            for (int j = 1; j < Q; ++j)
              acc = __fadd_rn(acc, __fmul_rn(pk[r * Q + j], pk[j * Q + col]));
            pw[(k + 1) * Q * Q + i] = acc;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      scan<NA, Q>(st, tot1, pw);
      float es0[Q];   // e's entering state, for pass C
#pragma unroll
      for (int r = 0; r < Q; ++r) es0[r] = st[0][r];
      // B: e, s_c, s_phi from their entering states, with their sums;
      // s_theta_1 from a zero state
      float sq[1][Q];
#pragma unroll
      for (int r = 0; r < Q; ++r) sq[0][r] = 0.f;
      {
        float yl[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i) yl[i] = y0[i];
        for (int t = t0; t < t1; ++t) {
          const float yt = ys[t];
          float u[NA];
          u[0] = ar_input<P>(yt, c, phi, yl);
          u[1] = -1.f;
#pragma unroll
          for (int i = 0; i < P; ++i) u[2 + i] = -yl[i];
          float val[NA];
#pragma unroll
          for (int n = 0; n < NA; ++n)
            val[n] = __fadd_rn(ma_sum<Q>(th, st[n]), u[n]);
          const float vq = __fadd_rn(ma_sum<Q>(th, sq[0]), -st[0][0]);
          part[0] = __fadd_rn(part[0], __fmul_rn(val[0], val[0]));
#pragma unroll
          for (int n = 1; n < NA; ++n)
            part[n] = __fadd_rn(part[n], __fmul_rn(val[0], val[n]));
#pragma unroll
          for (int n = 0; n < NA; ++n) push<Q>(st[n], val[n]);
          push<Q>(sq[0], vq);
          if (P > 0) push<PL>(yl, yt);
        }
      }
      scan<1, Q>(sq, tot2, pw);
      // C: e and s_theta_1 from their entering states; sums e s_theta_j
      {
        float yl[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i) yl[i] = y0[i];
        float(&qs)[Q] = sq[0];
        for (int t = t0; t < t1; ++t) {
          const float yt = ys[t];
          const float e = __fadd_rn(ma_sum<Q>(th, es0),
                                    ar_input<P>(yt, c, phi, yl));
          const float vq = __fadd_rn(ma_sum<Q>(th, qs), -es0[0]);
          part[NA] = __fadd_rn(part[NA], __fmul_rn(e, vq));
#pragma unroll
          for (int j = 1; j < Q; ++j)
            part[NA + j] = __fadd_rn(part[NA + j], __fmul_rn(e, qs[j - 1]));
          push<Q>(es0, e);
          push<Q>(qs, vq);
          if (P > 0) push<PL>(yl, yt);
        }
      }
    }
    // the sums over the row: a fixed tree, within each warp, then across
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      float s = part[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(FULL, s, off));
      if (lane == 0) red[warp * (K + 1) + k] = s;
    }
    __syncthreads();
    // thread k finishes sum k across the warps; thread 0 keeps the loss,
    // thread k >= 1 takes the Adam step of parameter k - 1
    if (tid <= K) {
      float w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = red[i * (K + 1) + tid];
#pragma unroll
      for (int h = NW / 2; h > 0; h >>= 1)
#pragma unroll
        for (int i = 0; i < h; ++i) w[i] = __fadd_rn(w[i], w[i + h]);
      if (tid == 0) {
        loss = __fdiv_rn(w[0], fl);
      } else {
        const float g = __fmul_rn(w[0], two_over_l);
        m = __fadd_rn(__fmul_rn(0.9f, m), __fmul_rn(0.1f, g));
        v = __fadd_rn(__fmul_rn(0.999f, v), __fmul_rn(__fmul_rn(0.001f, g), g));
        const float mh = __fdiv_rn(m, bc1);
        const float vh = __fdiv_rn(v, bc2);
        prm_s[tid - 1] = __fsub_rn(
            prm_s[tid - 1], __fdiv_rn(__fmul_rn(a.lr, mh),
                                      __fadd_rn(__fsqrt_rn(vh), 1e-8f)));
      }
    }
    __syncthreads();
  }
  if (tid < K) a.params[row * K + tid] = prm_s[tid];
  if (tid == 0) a.loss[row] = loss;
}

using Launch = cudaError_t (*)(const Args&, cudaStream_t);

template <int P, int Q>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long smem =
      (Layout<P, Q>::HEAD + a.len) * static_cast<long long>(sizeof(float));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        arma_fit_kernel<P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  arma_fit_kernel<P, Q><<<static_cast<unsigned>(a.rows), NT,
                          static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

// kTable[p * (MAX_ORDER + 1) + q]: the launcher for (p, q), or null
template <int I>
constexpr Launch entry() {
  constexpr int P = I / (MAX_ORDER + 1), Q = I % (MAX_ORDER + 1);
  if constexpr (P + Q <= MAX_ORDER) {
    return &launch<P, Q>;
  } else {
    return nullptr;
  }
}

template <int... I>
constexpr std::array<Launch, sizeof...(I)> make_table(
    std::integer_sequence<int, I...>) {
  return {entry<I>()...};
}

const std::array<Launch, (MAX_ORDER + 1) * (MAX_ORDER + 1)> kTable =
    make_table(std::make_integer_sequence<int, (MAX_ORDER + 1) *
                                                   (MAX_ORDER + 1)>{});

}  // namespace

// y: rows x len fp32, row stride ldy (elements), unit stride along a row;
// init, params: rows x (p+1+q) fp32, contiguous, packed (c, phi, theta);
// bias: steps x 2 fp32, Adam's 1 - 0.9^t and 1 - 0.999^t for t = 1..steps
// (ref.adam_bias); loss: rows fp32.  p, q >= 0 with p + q <= 8; len >= 1 and small enough
// that the row and the scan's buffers fit in 227 KB of shared memory
// (arma_fit.MAX_LEN in the Python wrapper); steps >= 1.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int arma_fit(const void* y, const void* init, const void* bias,
                        void* params, void* loss, long long rows, long long len,
                        long long ldy, int p, int q, int steps, float lr,
                        void* stream) {
  if (p < 0 || q < 0 || p + q > MAX_ORDER || steps < 1 || len < 1 ||
      rows < 1 || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.y = static_cast<const float*>(y);
  a.init = static_cast<const float*>(init);
  a.bias = static_cast<const float*>(bias);
  a.params = static_cast<float*>(params);
  a.loss = static_cast<float*>(loss);
  a.rows = rows;
  a.len = len;
  a.ldy = ldy;
  a.steps = steps;
  a.lr = lr;
  return static_cast<int>(
      kTable[p * (MAX_ORDER + 1) + q](a, static_cast<cudaStream_t>(stream)));
}
