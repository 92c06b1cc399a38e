// Prefill flash attention backward, bf16 inputs: the C entry point of
// the kernels in flash_attention_bwd.cuh (see there).
#include "flash_attention_bwd.cuh"

// dims: B, H, Hkv, S, T, hd.  strides (elements): q, o, dout, dq (b,h,s);
// k, v, dk, dv (b,h,t); q_pos (b,s); k_pos (b,t), in the order q, k, v,
// o, dout, dq, dk, dv, q_pos, k_pos.  The head dimension of every (.,
// hd) tensor is unit-stride with 16-byte aligned rows.  lse and dsum are
// contiguous (B,H,S) fp32: lse is read (K2's), dsum is scratch.  dtype: 0
// = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, const void* q_pos,
                                   const void* k_pos, void* dq, void* dk,
                                   void* dv, const long long* dims,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, q_pos, k_pos, dq,
                                dk, dv, dims, strides, scale, causal, window,
                                stream);
}
