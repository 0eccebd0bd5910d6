"""Per-sample dynamic convolution of the CROG projector.

Counterpart of crog_tpu/ops/dynconv.py ``dynamic_group_conv_fused`` (52):
the reference convolves every task map with a language-conditioned 3x3
kernel per sample (a grouped conv with groups=batch, model/layers.py:95-123)
after a 1x1 ``vis_out`` conv.  Both are linear in the channel axis, so they
compose into one small per-sample tensor and one contraction over the
feature map, followed by a shift-accumulate of the k*k tap maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dynamic_group_conv_fused(
    x: torch.Tensor,
    vis_weight: torch.Tensor,
    vis_bias: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_tasks: int,
) -> torch.Tensor:
    """The projector's 1x1 ``vis_out`` conv composed with the dynamic conv.

    Args:
      x: [B, H, W, J] vis_conv2 features.
      vis_weight: [T*C, J, 1, 1] the vis_out conv weight (torch layout;
        output channel t*C + c is task t's channel c).
      vis_bias: [T*C] the vis_out conv bias.
      weight: [B, C, k, k] per-sample text kernels.
      bias: [B] per-sample scalar bias.
    Returns: [B, H, W, T] fp32.
    """
    b = x.shape[0]
    t = num_tasks
    k = weight.shape[-1]
    c = weight.shape[1]
    j = vis_weight.shape[1]
    wk = weight.reshape(b, c, k * k).float()
    wv = vis_weight.reshape(t, c, j).permute(2, 0, 1).float()  # [J, T, C]
    m = torch.einsum("jtc,bck->bjtk", wv, wk)  # [B, J, T, k*k], tiny
    tap_bias = torch.einsum("tc,bck->btk", vis_bias.reshape(t, c).float(), wk)
    # compute-dtype operands, f32 accumulation (preferred_element_type=f32)
    taps = torch.einsum(
        "bhwj,bjtk->btkhw", x.float(), m.to(x.dtype).float()
    )
    taps = taps + tap_bias[:, :, :, None, None]
    return _shift_accumulate(taps, bias, k)


def _shift_accumulate(taps: torch.Tensor, bias: torch.Tensor, k: int):
    """Sum the k*k spatially shifted tap maps [B, T, k*k, H, W] plus the
    per-sample scalar bias.  Returns [B, H, W, T] fp32."""
    b, t, _, h, w = taps.shape
    r = k // 2
    taps = F.pad(taps, (r, r, r, r))
    out = torch.zeros(b, t, h, w, dtype=torch.float32, device=taps.device)
    for ky in range(k):
        for kx in range(k):
            # cross-correlation (torch conv semantics): tap (ky, kx)
            # multiplies x[p + (ky-r, kx-r)] = padded tap map at p + (ky, kx)
            out = out + taps[:, :, ky * k + kx, ky : ky + h, kx : kx + w]
    out = out.permute(0, 2, 3, 1)
    return out + bias.float()[:, None, None, None]
