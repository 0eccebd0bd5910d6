"""K4: the decoder FFN, Dense -> ReLU -> LayerNorm -> Dense, forward.

Counterpart of crog_tpu/ops/pallas_ffn.py ``fused_ffn`` (176) with dropout
off (eval).  Weights in torch layout: ``w1`` [F, D], ``w2`` [D, F].  On a
CUDA tensor this launches csrc/ffn.cu, which keeps each row tile's
[32, 2048] hidden in shared memory (or raises); on a CPU tensor it runs the
plain twin, which keeps the TPU kernel's cast points: the hidden rounded to
x's dtype after the bias and again after the f32-statistics LayerNorm, one
rounding of the output after the bias.
"""

from __future__ import annotations

import torch

from crog_tpu_torch.ops import cuda_build
from crog_tpu_torch.ops.decoder_blocks import dense, ln_fast

KERNEL_D, KERNEL_F = 512, 2048


def ffn_plain(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5):
    h = torch.relu(dense(x, w1, b1))
    return dense(ln_fast(h, gamma, beta, eps), w2, b2)


def fused_ffn(x, w1, b1, gamma, beta, w2, b2):
    """K4 over x [M, D] tokens."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, gamma, beta, w2, b2)
    m, d = x.shape
    f = w1.shape[0]
    if (d, f) != (KERNEL_D, KERNEL_F):
        raise ValueError(
            f"FFN kernel takes D={KERNEL_D}, F={KERNEL_F}, got D={d}, F={f}"
        )
    cuda_build.require(x, "x", torch.bfloat16, (m, d))
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    cuda_build.require(w1b, "w1", torch.bfloat16, (f, d))
    cuda_build.require(w2b, "w2", torch.bfloat16, (d, f))
    vecs = [t.float().contiguous() for t in (b1, gamma, beta, b2)]
    for t, n, size in zip(vecs, ("b1", "gamma", "beta", "b2"), (f, f, f, d)):
        cuda_build.require(t, n, torch.float32, (size,))
    y = torch.empty_like(x)
    lib = cuda_build.load("ffn")
    rc = lib.crog_ffn_fwd(
        x.data_ptr(), w1b.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        vecs[2].data_ptr(), w2b.data_ptr(), vecs[3].data_ptr(), y.data_ptr(),
        m, d, f, cuda_build.stream_ptr(x.device),
    )
    cuda_build.check_launch(lib, rc, "crog_ffn_fwd")
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0
