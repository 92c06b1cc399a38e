// Prefill flash attention backward, bf16 inputs: the C entry points.
// Head dims 16, 32 and 64 (padded to 64) and 112 and 128 (padded to 128)
// go to the tensor-core kernels of flash_attention_bwd_wgmma.cuh; 160, 192
// and 256 to the scalar kernels of flash_attention_bwd.cuh.  This is a
// dispatch by shape: nothing is retried on another route.
#include "flash_attention_bwd_wgmma.cuh"

// Which kernels take head dim hd: 1 = the tensor-core (wgmma) kernels,
// 0 = the scalar FMA kernels.
extern "C" int flash_attention_bwd_route(int dtype, int hd) {
  return hd <= 128 ? 1 : 0;
}

// dims: B, H, Hkv, S, T, hd.  The bytes of scratch `flash_attention_bwd`
// needs: on the tensor-core route lse2, D and the dead rows' dO sums
// (`bwg::scratch_layout`); on the scalar route D, (B,H,S) fp32.
extern "C" long long flash_attention_bwd_scratch(int dtype,
                                                 const long long* dims) {
  const int B = static_cast<int>(dims[0]), H = static_cast<int>(dims[1]);
  const int S = static_cast<int>(dims[3]), hd = static_cast<int>(dims[5]);
  if (!flash_attention_bwd_route(dtype, hd)) return 4ll * B * H * S;
  return bwg::scratch_layout(B, H, S, hd).bytes;
}

// Arguments as in flash_attention_bwd_f32.cu.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* scratch, const void* q_pos,
                                   const void* k_pos, void* dq, void* dk,
                                   void* dv, const long long* dims,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, dims,
                     strides, scale, causal, window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* p = static_cast<unsigned char*>(scratch);
  bwg::WArgs w;
  if (flash_attention_bwd_route(dtype, a.hd)) {
    const bwg::Scratch s = bwg::scratch_layout(a.B, a.H, a.S, a.hd);
    static_cast<Args&>(w) = a;
    w.lse2 = reinterpret_cast<float*>(p + s.lse2);
    w.dpad = reinterpret_cast<float*>(p + s.dpad);
    w.dead = reinterpret_cast<float*>(p + s.dead);
    w.spad = bwg::padded_rows(a.S);
  } else {
    a.dsum = reinterpret_cast<float*>(p);
  }
  cudaError_t err;
  switch (a.hd) {
    case 16:
    case 32:
    case 64: err = bwg::launch<64>(w, st); break;
    case 112:
    case 128: err = bwg::launch<128>(w, st); break;
    case 160: err = launch<bf16, 160>(a, st); break;
    case 192: err = launch<bf16, 192>(a, st); break;
    case 256: err = launch<bf16, 256>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
