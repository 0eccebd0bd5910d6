// K1-f32: the attention forward on fp32 operands, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_attention.py:104 `_fused_fwd` (pallas_call
// at :111) where the model computes in fp32.  The kernel, its bound and its
// design notes are in attention_f32.cuh, which the fp32 decoder blocks
// share.  q, k, v, o are [B, L, heads * dh], dh one of 8, 16, 32, 64,
// 128.  lse, if not null, receives each row's logsumexp [B*H, Lq] for
// K1b-f32.
#include "attention_f32.cuh"

extern "C" int crog_attention_f32_fwd(
    const float* q, const float* k, const float* v, const float* mask, float* o, float* lse,
    int batch, int heads, int lq, int lk, int dh,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    float scale, void* stream) {
  crog::AttnF32Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.o = o;
  a.lse = lse;
  a.heads = heads;
  a.lq = lq;
  a.lk = lk;
  a.dh = dh;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.o_bs = o_bs;
  a.o_rs = o_rs;
  a.scale = scale;
  return (int)crog::launch_attention_f32(a, batch, static_cast<cudaStream_t>(stream));
}
