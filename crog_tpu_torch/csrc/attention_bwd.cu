// K1b: fused softmax attention backward, C interface for ctypes.
//
// Replaces crog_tpu/ops/pallas_attention.py:133 `_fused_bwd_vjp` (the
// pallas_call at :140, kernel `_bwd_kernel` :53): the backward of the CLIP
// attention pool, in f32 throughout.  Two paths, chosen by the wrapper
// (crog_tpu_torch/ops/attention.py:bwd_path) from the shapes:
//   - heads of at most kHbMaxL = 256 tokens and head dim 64: one CTA per
//     (batch, head), attention_bwd_head.cuh (its bound and design notes are
//     there);
//   - longer heads, of any length, other head dims (8 to 512) and the
//     decoder blocks' cast points: the two kernels of attention_bwd.cuh,
//     which the decoder block backward shares.
// Both recompute the row statistics from q and k instead of taking the
// forward's.
#include "attention_bwd_head.cuh"

namespace {

crog::AttnBwdArgs self_args(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, void* dq, void* dk, void* dv, float* stats,
                            int heads, int len, int dh, float scale) {
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
  a.dh = dh;
  const long long rs = (long long)heads * dh;
  const long long bs = rs * len;
  a.q_bs = a.k_bs = a.v_bs = a.o_bs = a.do_bs = a.dq_bs = a.dk_bs = a.dv_bs = bs;
  a.q_rs = a.k_rs = a.v_rs = a.o_rs = a.do_rs = a.dq_rs = a.dk_rs = a.dv_rs = rs;
  a.scale = scale;
  return a;
}

}  // namespace

// The two-kernel path.  q, o, dout, dq: [B, Lq, H*dh] bf16; k, v, dk, dv:
// [B, Lk, H*dh] bf16, contiguous (dh one of 8, 16, 32, 64, 128, 256, 512); mask: [B, Lk]
// additive f32 or null.
// stats: [3, B*H, Lq] f32 workspace.  bf16_casts 0 is K1b (unmasked self
// attention, Lq = Lk); 1 runs the decoder blocks' cast points (kBwdBf16),
// on which the checks of K2b's and K3b's attention step (and that K1b's
// tolerance would see a lost f32 cast point) run.
extern "C" int crog_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, void* dq,
                                  void* dk, void* dv, float* stats, const float* mask,
                                  int batch, int heads, int lq, int lk, int dh, float scale,
                                  int bf16_casts, void* stream) {
  crog::AttnBwdArgs a = self_args(q, k, v, o, dout, dq, dk, dv, stats, heads, lq, dh, scale);
  if (!bf16_casts && (mask != nullptr || lq != lk)) return (int)cudaErrorInvalidValue;
  a.mask = mask;
  a.lk = lk;
  a.k_bs = a.v_bs = a.dk_bs = a.dv_bs = a.k_rs * lk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_casts ? crog::launch_attention_bwd<crog::kBwdBf16>(a, batch, st)
                          : crog::launch_attention_bwd<crog::kBwdF32>(a, batch, st));
}

// The one-CTA-per-head path, 1 <= len <= 256 and dh 64 (any other dh is
// refused: ops/attention.py:bwd_path sends it to crog_attention_bwd); no
// workspace.
extern "C" int crog_attention_bwd_head(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, void* dq, void* dk,
                                       void* dv, int batch, int heads, int len, int dh,
                                       float scale, void* stream) {
  const crog::AttnBwdArgs a =
      self_args(q, k, v, o, dout, dq, dk, dv, nullptr, heads, len, dh, scale);
  return (int)crog::launch_attention_bwd_head(a, batch, static_cast<cudaStream_t>(stream));
}

// out[3]: registers per thread, shared memory bytes per CTA, spill bytes per
// thread of the one-CTA-per-head kernel that takes len tokens
extern "C" int crog_attention_bwd_head_attrs(int len, int* out) {
  if (len < 1 || len > crog::kHbMaxL) return (int)cudaErrorInvalidValue;
  switch (crog::round_up(len, 64)) {
    case 64: return (int)crog::attn_bwd_head_attrs<64>(out);
    case 128: return (int)crog::attn_bwd_head_attrs<128>(out);
    case 192: return (int)crog::attn_bwd_head_attrs<192>(out);
    default: return (int)crog::attn_bwd_head_attrs<256>(out);
  }
}

// out[6]: registers per thread, shared memory bytes per CTA and spill bytes
// per thread of the two-kernel path's rows kernel, then its cols kernel,
// with the decoder blocks' cast points (bf16_casts 1) or K1b's (0), at head
// dim dh
extern "C" int crog_attention_bwd_attrs(int bf16_casts, int dh, int* out) {
  return (int)(bf16_casts ? crog::attention_bwd_attrs<crog::kBwdBf16>(dh, out)
                          : crog::attention_bwd_attrs<crog::kBwdF32>(dh, out));
}

// 1 if the one-CTA-per-head kernel takes a head of len tokens and head dim
// dh, else 0 (ops/attention.py:bwd_path mirrors it)
extern "C" int crog_attention_bwd_head_takes(int len, int dh) {
  return len >= 1 && len <= crog::kHbMaxL && dh == crog::kHbDH;
}
