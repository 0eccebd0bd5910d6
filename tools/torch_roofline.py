"""Batch-1 latency roofline of the port's CROG eval forward (counterpart of
tools/roofline.py): what the card allows, and how far the measured latency
is from it.

    python3 tools/torch_roofline.py [--config config/OCID-VLG/crog_multiple_r50.yaml]
        [--fused-stem] [--device cuda] [--peak-tflops 989] [--hbm-gbps 3350]
        [--iters 500] [--warmup 100] [--cpu-count] [--opts ...]

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops of one
forward, plus the work of the hand-written kernels counted from their
shapes (crog_tpu_torch/ops/work.py, the functions chip_smoke.py's bounds
use): the kernels launch through ctypes, where the counter cannot see
them, and on the CPU their plain twins' aten ops are hidden from it, so the
count is the same whichever implementation runs (``--cpu-count`` counts a
CPU copy of the model too and prints both).  Bytes: the least the card
must move, the parameters and buffers as held, the inputs and the output,
each once.  The per-op input + output bytes of the eager program are
printed beside it, labelled, and not used for the bound.

    bound = max(FLOPs / peak, bytes / memory rate)

with the H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s, the model
computes in bf16) and its 3.35 TB/s, both overridable.  The measured
latency is the mean of ``--iters - --warmup`` chained batch-1 forwards by
CUDA events (tools/torch_latency.py's ``chained_ms``); the share is bound
over measured.  The card's ``nvidia-smi`` name and power limit stand beside
every figure.  ``--device`` defaults to ``cuda`` and raises without a card;
on the CPU the latency is not measured.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from crog_tpu_torch.ops import work  # noqa: E402


class OpBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (views
    move nothing and are skipped)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def inputs(cfg, device):
    """The batch-1 image and word ids tools/torch_latency.py times."""
    rng = np.random.RandomState(0)
    img = torch.from_numpy(
        rng.randn(1, cfg.input_size, cfg.input_size, 3).astype(np.float32)).to(device)
    word = torch.from_numpy(
        rng.randint(0, 4096, (1, cfg.word_len)).astype(np.int64)).to(device)
    return img, word


@torch.no_grad()
def count(model, img, word) -> Dict:
    """One eval forward's work: ``flops`` (aten ops plus the kernels'),
    ``aten_flops``, ``kernels`` {name: [calls, flops]}, ``least_bytes``
    (parameters and buffers, inputs, output), ``param_bytes`` and
    ``op_bytes`` (every aten op's inputs and outputs, the kernels' from
    their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    flop_mode = FlopCounterMode(display=False)
    byte_mode = OpBytes()
    with flop_mode, byte_mode, work.counting() as calls:
        out = model(img, word)
    kernels = {}
    for name, flops, moved in calls:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += flops
    aten = float(flop_mode.get_total_flops())
    params = sum(work.nbytes(t) for t in (*model.parameters(), *model.buffers()))
    return {"flops": aten + sum(f for _, f, _ in calls), "aten_flops": aten,
            "kernels": kernels, "param_bytes": params,
            "least_bytes": params + work.nbytes(img, word, out),
            "op_bytes": byte_mode.total + sum(m for _, _, m in calls)}


def roofline(model, img, word, card: str, peak_flops: float = work.PEAK_BF16_FLOPS,
             peak_bytes: float = work.PEAK_BYTES, iters: int = 500, warmup: int = 100,
             label: str = "") -> Dict:
    """Count, bound, time (on a card) and print the ``[roofline]`` line."""
    from tools.torch_latency import chained_ms

    c = count(model, img, word)
    t_ops = c["flops"] / peak_flops * 1e3
    t_bytes = c["least_bytes"] / peak_bytes * 1e3
    bound_ms, limiter = work.bound(c["flops"], c["least_bytes"], peak_flops, peak_bytes)
    measured = chained_ms(model, img, word, iters, warmup) if img.is_cuda else None
    c.update(t_flops_ms=t_ops, t_bytes_ms=t_bytes, bound_ms=bound_ms, limited_by=limiter,
             measured_ms=measured, share=None if measured is None else bound_ms / measured,
             card=card)
    kern = ", ".join(f"{n} x{k[0]} {k[1] / 1e9:.3f}" for n, k in sorted(c["kernels"].items()))
    timed = ("not measured (no card)" if measured is None else
             f"{measured:.4f} ms ({iters - warmup} chained forwards, CUDA events), share "
             f"{c['share']:.4f} of the bound")
    print(f"[roofline] {label}batch 1: {c['flops'] / 1e9:.3f} GFLOP (aten "
          f"{c['aten_flops'] / 1e9:.3f} + kernels from shapes: {kern} GFLOP); least bytes "
          f"{c['least_bytes'] / 1e6:.3f} MB (parameters and buffers "
          f"{c['param_bytes'] / 1e6:.3f}, inputs, output); t_flops {t_ops:.4f} ms at "
          f"{peak_flops / 1e12:.0f} TFLOP/s, t_bytes {t_bytes:.4f} ms at "
          f"{peak_bytes / 1e9:.0f} GB/s; bound {bound_ms:.4f} ms, limited by {limiter}; "
          f"measured {timed}; eager per-op input+output bytes {c['op_bytes'] / 1e6:.3f} MB "
          f"(not in the bound); {card}", flush=True)
    return c


def main(argv=None):
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.models.crog import build_crog, random_init_
    from crog_tpu_torch.parallel.dist import resolve_device
    from tools.torch_latency import device_name

    p = argparse.ArgumentParser(description="CROG batch-1 latency roofline (PyTorch)")
    p.add_argument("--config", default="config/OCID-VLG/crog_multiple_r50.yaml")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused-stem", action="store_true",
                   help="run the s2d stem's stride-1 convs through K6")
    p.add_argument("--peak-tflops", type=float, default=work.PEAK_BF16_FLOPS / 1e12)
    p.add_argument("--hbm-gbps", type=float, default=work.PEAK_BYTES / 1e9)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--cpu-count", action="store_true",
                   help="also count a CPU copy of the model (plain twins)")
    p.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    cfg = load_cfg_from_cfg_file(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    device = resolve_device(a.device)
    set_exact_fp32_matmul()
    model = build_crog(cfg, None, a.fused_stem)
    random_init_(model, torch.Generator().manual_seed(cfg.manual_seed))
    model = model.to(device).eval()
    img, word = inputs(cfg, device)
    c = roofline(model, img, word, device_name(device), a.peak_tflops * 1e12,
                 a.hbm_gbps * 1e9, a.iters, a.warmup, f"CROG eval forward ({a.config}) ")
    if a.cpu_count:
        cpu = build_crog(cfg, torch.float32, a.fused_stem)
        cpu.load_state_dict(model.state_dict())
        n = c["cpu_flops"] = count(cpu.eval(), *inputs(cfg, "cpu"))["flops"]
        print(f"[roofline] FLOPs on {device.type} {c['flops']:.0f}, on the CPU (plain twins) "
              f"{n:.0f}: {'equal' if n == c['flops'] else 'DIFFERENT'}", flush=True)
    return c


if __name__ == "__main__":
    main()
