// K1b: fused softmax attention backward, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_attention.py:133 `_fused_bwd_vjp` (the
// pallas_call at :140, kernel `_bwd_kernel` :53): the backward of the CLIP
// attention pool, in f32 throughout.  The kernels and their bound and
// design notes are in attention_bwd.cuh, which the decoder block backward
// shares.  The row statistics are recomputed from q and k instead of saved
// by the forward.
#include "attention_bwd.cuh"

// q, k, v, o, dout, dq, dk, dv: [B, L, H*64] bf16, contiguous.
// stats: [3, B*H, L] f32 workspace.  bf16_casts 0 is K1b; 1 runs the
// decoder blocks' cast points (kBwdBf16) on the same interface, for the
// checks that K1b's tolerance would see a lost f32 cast point.
extern "C" int crog_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, void* dq,
                                  void* dk, void* dv, float* stats, int batch,
                                  int heads, int len, float scale, int bf16_casts,
                                  void* stream) {
  using crog::bf16;
  crog::AttnBwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = nullptr;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.stats = stats;
  a.heads = heads;
  a.lq = a.lk = len;
  const long long rs = (long long)heads * crog::kAbDH;
  const long long bs = rs * len;
  a.q_bs = a.k_bs = a.v_bs = a.o_bs = a.do_bs = a.dq_bs = a.dk_bs = a.dv_bs = bs;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = a.do_rs = a.dq_rs = a.dk_rs = a.dv_rs = rs;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_casts ? crog::launch_attention_bwd<crog::kBwdBf16>(a, batch, st)
                          : crog::launch_attention_bwd<crog::kBwdF32>(a, batch, st));
}
