// Prefill flash attention backward, fp32 inputs: the C entry points of
// the scalar kernels in flash_attention_bwd.cuh (see there), at every
// (hd, hd_v) pair K2 takes.
#include "flash_attention_bwd.cuh"

// dims: B, H, Hkv, S, T, hd, hd_v.  The bytes of scratch
// `flash_attention_bwd` needs: D, (B,H,S) fp32.
extern "C" long long flash_attention_bwd_scratch(int dtype,
                                                 const long long* dims) {
  return 4ll * dims[0] * dims[1] * dims[3];
}

// Which kernels take head dim hd: 0 = the scalar FMA kernels.
extern "C" int flash_attention_bwd_route(int dtype, int hd) { return 0; }

// dims: B, H, Hkv, S, T, hd, hd_v (q, k, dq, dk at hd; v, o, dout, dv at
// hd_v).  strides (elements): q, o, dout, dq (b,h,s); k, v, dk, dv
// (b,h,t); q_pos (b,s); k_pos (b,t), in the order q, k, v, o, dout, dq,
// dk, dv, q_pos, k_pos.  The head dimension of every tensor is
// unit-stride with 16-byte aligned rows.  lse is K2's
// contiguous (B,H,S) fp32; scratch holds flash_attention_bwd_scratch()
// bytes.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* scratch, const void* q_pos,
                                   const void* k_pos, void* dq, void* dk,
                                   void* dv, const long long* dims,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, dims,
                     strides, scale, causal, window);
  a.dsum = static_cast<float*>(scratch);
  return static_cast<int>(
      dispatch<float>(a, static_cast<cudaStream_t>(stream)));
}
