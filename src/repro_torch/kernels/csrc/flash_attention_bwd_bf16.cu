// Prefill flash attention backward, bf16 inputs: the C entry points of
// the tensor-core kernels of flash_attention_bwd_wgmma.cuh, at every
// (hd, hd_v) pair K2 takes.  The pair picks the instantiation (a dispatch
// by shape); a pair the kernels do not take is refused, never retried on
// another route.
#include "flash_attention_bwd_wgmma.cuh"

// Which kernels take head dim hd: 1 = the tensor-core (wgmma) kernels,
// every bf16 head dim.
extern "C" int flash_attention_bwd_route(int dtype, int hd) { return 1; }

// dims: B, H, Hkv, S, T, hd, hd_v.  The bytes of scratch
// `flash_attention_bwd` needs: lse2, D and the dead rows' dO sums
// (`bwg::scratch_layout`).
extern "C" long long flash_attention_bwd_scratch(int dtype,
                                                 const long long* dims) {
  return bwg::scratch_layout(static_cast<int>(dims[0]),
                             static_cast<int>(dims[1]),
                             static_cast<int>(dims[3]),
                             static_cast<int>(dims[6])).bytes;
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  bwg::WArgs w;
  static_cast<Args&>(w) = make_args(q, k, v, o, dout, lse, q_pos, k_pos, dq,
                                    dk, dv, dims, strides, scale, causal,
                                    window);
  const bwg::Scratch s = bwg::scratch_layout(w.B, w.H, w.S, w.hdv);
  unsigned char* p = static_cast<unsigned char*>(scratch);
  w.lse2 = reinterpret_cast<float*>(p + s.lse2);
  w.dpad = reinterpret_cast<float*>(p + s.dpad);
  w.dead = reinterpret_cast<float*>(p + s.dead);
  w.spad = bwg::padded_rows(w.S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (w.hdv != w.hd) {
    if (w.hd == 192 && w.hdv == 128) err = bwg::launch<192, 128>(w, st);
    return static_cast<int>(err);
  }
  switch (w.hd) {
    case 16:
    case 32:
    case 64: err = bwg::launch<64, 64>(w, st); break;
    case 96:
    case 112:
    case 128: err = bwg::launch<128, 128>(w, st); break;
    case 160:
    case 192: err = bwg::launch<192, 192>(w, st); break;
    case 256: err = bwg::launch<256, 256>(w, st); break;
  }
  return static_cast<int>(err);
}
