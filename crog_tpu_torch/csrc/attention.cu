// K1: fused softmax attention, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_attention.py:104 `_fused_fwd` (the
// pallas_call at :111, reached through `fused_self_attention` :98 and
// `flash_attention_bhld` :156).  The kernel itself and its bound and design
// notes are in attention.cuh, which the decoder block kernels share.
#include "attention.cuh"

extern "C" int crog_attention_fwd(
    const void* q, const void* k, const void* v, const float* mask, void* o,
    int batch, int heads, int lq, int lk,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    float scale, void* stream) {
  crog::AttnArgs a;
  a.q = static_cast<const crog::bf16*>(q);
  a.k = static_cast<const crog::bf16*>(k);
  a.v = static_cast<const crog::bf16*>(v);
  a.mask = mask;
  a.o = static_cast<crog::bf16*>(o);
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.o_bs = o_bs;
  a.o_rs = o_rs;
  a.scale = scale;
  return (int)crog::launch_attention(a, batch, static_cast<cudaStream_t>(stream));
}
