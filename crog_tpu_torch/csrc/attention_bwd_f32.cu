// K1b-f32: the attention backward on fp32 operands, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_attention.py:133 `_fused_bwd_vjp`
// (pallas_call at :140) where the model computes in fp32.  The kernels,
// their bound and their design notes are in attention_bwd_f32.cuh, which
// the fp32 decoder blocks' backward shares.  With the forward's logsumexp
// (lse) this is K1b-f32, delta = rowsum(do * o); without it the decoder
// blocks' attention backward (o unused, the statistics and delta =
// rowsum(dP * P) from the pre-pass).
#include "attention_bwd_f32.cuh"

// q, o, do, dq [B, Lq, H*dh]; k, v, dk, dv [B, Lk, H*dh] (dh one of 8, 16,
// 32, 64, 128, 256, 512); mask [B, Lk] additive f32 or null; lse [B*H, Lq] or null;
// stats [B*H, 3, Lq] and dqpart [ab_f32_parts(Lk), B*H, Lq, dh] (work);
// strides in floats
extern "C" int crog_attention_f32_bwd(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    const float* mask, const float* lse, float* dq, float* dk, float* dv, float* stats,
    float* dqpart,
    int batch, int heads, int lq, int lk, int dh,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, long long o_bs, long long o_rs,
    long long do_bs, long long do_rs, long long dq_bs, long long dq_rs,
    long long dk_bs, long long dk_rs, long long dv_bs, long long dv_rs,
    float scale, void* stream) {
  crog::AttnBwdF32Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.mask = mask;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = stats;
  a.dqpart = dqpart;
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
  a.do_bs = do_bs;
  a.do_rs = do_rs;
  a.dq_bs = dq_bs;
  a.dq_rs = dq_rs;
  a.dk_bs = dk_bs;
  a.dk_rs = dk_rs;
  a.dv_bs = dv_bs;
  a.dv_rs = dv_rs;
  a.scale = scale;
  return (int)crog::launch_attention_bwd_f32(a, batch, static_cast<cudaStream_t>(stream));
}

// the dQ partials crog_attention_f32_bwd writes for lk keys (dqpart's first
// dimension), which ops/attention.py:f32_dq_parts mirrors to size it
extern "C" int crog_attention_f32_dq_parts(int lk) {
  return lk < 1 ? 0 : crog::ab_f32_parts(lk);
}
