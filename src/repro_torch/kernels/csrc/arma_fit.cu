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
// and runs in the same pass over t as e; g_k = (2/L) sum_t e_t s_k,t.
// The p+q+1 sensitivity chains and their sums live in registers, so one
// Adam step is one pass over the row with no memory traffic but the
// row's reads from shared memory.
//
// Arithmetic: every product and sum is rounded on its own in fp32 (no FMA
// contraction), in the order of the plain version (ref.arma_fit_ref):
// x_t = ((y_t - c) - phi_1 y_{t-1}) - ...; the feedback sums in the
// order of scipy.signal.lfilter's transposed direct form II; the sums
// over t from t = 0 up, one at a time.  So kernel and plain version
// agree bit for bit, which a fixed tolerance could not promise: near an
// optimum, or on a short row, Adam amplifies a rounding difference in
// the gradient to a different trajectory.  Against the JAX reference,
// whose reverse-mode gradient
// rounds in another order, the port is held to stated tolerances.
//
// Bound: operations, and a dependency chain.  The work is steps x L x
// (a few dozen fp32 operations), microseconds at the card's fp32 rate,
// and the bytes are the rows and parameters once.  But every t depends
// on t-1 (for q >= 1 through a multiply and one or two adds of each
// chain: the theta_1 term is added last, so only it waits for e_{t-1}),
// and every step on the one before: the simple design's floor is steps
// x L x one FMA latency, about 0.9 ms for 150 steps over 2,815 points.
// A single thread also issues every instruction of a t itself (about 27
// for p = 2, q = 1), which is the limit in practice.  Splitting the
// chains over the lanes of a warp, or a time-parallel scan of the linear
// recursion within a row, is later work.
//
// Design: one block (one warp) per row.  The warp copies the row into
// shared memory (L floats, up to 227 KB), then lane 0 runs every Adam
// step with the parameters, Adam's m and v and all recursion state in
// registers, specialised at compile time for each (p, q) with p + q <= 8.
// Rows never interact, so a row's result is the same bits alone, in any
// batch and in any order (the batch-purity contract of the reference's
// fit cache and dedupe), and repeats are bit-identical.
#include <cuda_runtime.h>

#include <array>
#include <utility>

namespace {

constexpr int NT = 32;         // one warp a block
constexpr int MAX_ORDER = 8;   // p + q

struct Args {
  const float* y; const float* init; float* params; float* loss;
  long long rows, len, ldy;
  int steps;
  float lr;
};

// -(theta_q h_q) - theta_{q-1} h_{q-1} - ... - theta_1 h_1 (h most recent
// first), each product and sum rounded on its own, in this order: the
// feedback term of scipy.signal.lfilter's transposed direct form II with
// denominator [1, theta_1..theta_q], which the plain version runs.
template <int Q>
__device__ __forceinline__ float ma_sum(const float* th, const float* h) {
  if (Q == 0) return 0.f;
  float z = -__fmul_rn(th[Q > 0 ? Q - 1 : 0], h[Q > 0 ? Q - 1 : 0]);
#pragma unroll
  for (int j = Q - 2; j >= 0; --j) z = __fsub_rn(z, __fmul_rn(th[j], h[j]));
  return z;
}

// beta^t rounded once to fp32 (the double power is exact to ~1e-16)
__device__ __forceinline__ float beta_pow(float beta, int t) {
  return static_cast<float>(pow(static_cast<double>(beta),
                                static_cast<double>(t)));
}

template <int P, int Q>
__global__ void __launch_bounds__(NT) arma_fit_kernel(Args a) {
  constexpr int K = P + 1 + Q;
  constexpr int PL = P > 0 ? P : 1;   // array extents; unused when 0
  constexpr int QL = Q > 0 ? Q : 1;
  extern __shared__ float ys[];
  const long long row = blockIdx.x;
  const int L = static_cast<int>(a.len);
  const float* yr = a.y + row * a.ldy;
  for (int t = threadIdx.x; t < L; t += NT) ys[t] = yr[t];
  __syncthreads();
  if (threadIdx.x != 0) return;

  float prm[K], m[K], v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    prm[k] = a.init[row * K + k];
    m[k] = 0.f;
    v[k] = 0.f;
  }
  const float fl = static_cast<float>(L);
  const float two_over_l = __fdiv_rn(2.f, fl);
  float loss = 0.f;
  for (int it = 0; it < a.steps; ++it) {
    const float c = prm[0];
    const float* th = prm + 1 + P;
    // lags, most recent first, zero before t = 0
    float yl[PL], el[QL], sl[K][QL], acc[K];
#pragma unroll
    for (int i = 0; i < PL; ++i) yl[i] = 0.f;
#pragma unroll
    for (int j = 0; j < QL; ++j) el[j] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < QL; ++j) sl[k][j] = 0.f;
    }
    float sse = 0.f;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const float yt = ys[t];
      float x = __fsub_rn(yt, c);
#pragma unroll
      for (int i = 0; i < P; ++i) x = __fsub_rn(x, __fmul_rn(prm[1 + i], yl[i]));
      const float e = __fadd_rn(ma_sum<Q>(th, el), x);
      sse = __fadd_rn(sse, __fmul_rn(e, e));
      float s[K];
      s[0] = -1.f;
#pragma unroll
      for (int i = 0; i < P; ++i) s[1 + i] = -yl[i];
#pragma unroll
      for (int j = 0; j < Q; ++j) s[1 + P + j] = -el[j];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (Q > 0) s[k] = __fadd_rn(ma_sum<Q>(th, sl[k]), s[k]);
        acc[k] = __fadd_rn(acc[k], __fmul_rn(e, s[k]));
      }
      if (Q > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int j = QL - 1; j > 0; --j) sl[k][j] = sl[k][j - 1];
          sl[k][0] = s[k];
        }
#pragma unroll
        for (int j = QL - 1; j > 0; --j) el[j] = el[j - 1];
        el[0] = e;
      }
      if (P > 0) {
#pragma unroll
        for (int i = PL - 1; i > 0; --i) yl[i] = yl[i - 1];
        yl[0] = yt;
      }
    }
    loss = __fdiv_rn(sse, fl);
    const float bc1 = __fsub_rn(1.f, beta_pow(0.9f, it + 1));
    const float bc2 = __fsub_rn(1.f, beta_pow(0.999f, it + 1));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float g = __fmul_rn(acc[k], two_over_l);
      m[k] = __fadd_rn(__fmul_rn(0.9f, m[k]), __fmul_rn(0.1f, g));
      v[k] = __fadd_rn(__fmul_rn(0.999f, v[k]),
                       __fmul_rn(__fmul_rn(0.001f, g), g));
      const float mh = __fdiv_rn(m[k], bc1);
      const float vh = __fdiv_rn(v[k], bc2);
      prm[k] = __fsub_rn(prm[k], __fdiv_rn(__fmul_rn(a.lr, mh),
                                           __fadd_rn(__fsqrt_rn(vh), 1e-8f)));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a.params[row * K + k] = prm[k];
  a.loss[row] = loss;
}

using Launch = cudaError_t (*)(const Args&, cudaStream_t);

template <int P, int Q>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.len) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        arma_fit_kernel<P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  arma_fit_kernel<P, Q><<<static_cast<unsigned>(a.rows), NT, smem, stream>>>(
      a);
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
// loss: rows fp32.  p, q >= 0 with p + q <= 8; 1 <= len <= 58,112 (the
// row sits in shared memory); steps >= 1.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int arma_fit(const void* y, const void* init, void* params,
                        void* loss, long long rows, long long len,
                        long long ldy, int p, int q, int steps, float lr,
                        void* stream) {
  if (p < 0 || q < 0 || p + q > MAX_ORDER || steps < 1 || len < 1 ||
      len * static_cast<long long>(sizeof(float)) > 232448 || rows < 1 ||
      rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.y = static_cast<const float*>(y);
  a.init = static_cast<const float*>(init);
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
