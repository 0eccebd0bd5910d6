"""Device-time breakdown of the PyTorch port's CROG eval forward, of its
train step, or of SSG's train step, on one card.

    python3 tools/torch_profile_eval.py [--batch 24] [--steps 3] [--train | --ssg]

Builds full-width CROG (config/OCID-VLG/crog_synthetic_r50.yaml, bf16,
seeded random weights, as chip_smoke.py does), warms up, then traces
``--steps`` forwards (with ``--train``: train steps -- forward, backward,
Adam -- on one prepared synthetic train batch, dropout on; with ``--ssg``:
full-width SSG train steps (config/OCID-Grasp/ssg_r50.yaml, 544^2) on one
prepared synthetic batch, AdamW) with torch.profiler and prints: device time by kernel (top 25), device time by
group (the port's hand-written kernels, cuDNN convolutions, cuBLAS GEMMs,
pooling, casts and copies, reductions, other elementwise), the device busy
share of the traced wall time, and one JSON line with the group totals per
forward or step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = (
    # K1 itself (the attention pool) and the attention step inside K2/K3
    ("attention_kernel (K1 + K2/K3 inner)", ("attention_kernel",)),
    ("attention backward (K1b + K2b/K3b inner)", ("attn_bwd_",)),
    ("K2b/K3b: ln_post_bwd, ln_pre_bwd", ("ln_post_bwd", "ln_pre_bwd")),
    ("K2b/K3b: gemm_nn (dX)", ("gemm_nn_kernel",)),
    ("K2b/K3b: wgrad (dW)", ("wgrad_kernel",)),
    ("K2b/K3b/K4b: reduce_rows", ("reduce_rows_kernel",)),
    ("K4b ffn_bwd", ("ffn_bwd_kernel",)),
    ("K2/K3 block: ln_pos", ("ln_pos_kernel",)),
    ("K2/K3 block: gemm_bias", ("gemm_bias_kernel",)),
    ("K2/K3 block: outproj_ln_residual", ("outproj_ln_residual_kernel",)),
    ("K4 ffn", ("ffn_fwd_kernel",)),
    ("K5/K5b lincomb", ("lincomb_", "sum_splits_kernel")),
    ("host-to-device copies", ("memcpy htod",)),
    ("pooling", ("avg_pool", "max_pool")),
    ("dtype casts and layout copies", ("copy_kernel",)),
    ("reductions", ("reduce_kernel",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit_gemm", "xmma", "sm90_xmma",
                             "nchw", "nhwc", "winograd", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet", "splitk")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "elementwise / other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--train", action="store_true")
    p.add_argument("--ssg", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_eval: no CUDA device", file=sys.stderr)
        return 2
    set_exact_fp32_matmul()
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    if a.ssg:
        run = ssg_train_step(cs, dev, a.batch)
    elif a.train:
        run = train_step(cs, dev, a.batch)
    else:
        cfg, model, batches = cs.build_model_and_data(dev, samples=a.batch, batch=a.batch)
        img = torch.as_tensor(batches[0]["img"]).to(dev)
        word = torch.as_tensor(batches[0]["word"]).to(dev)
        run = torch.no_grad()(lambda: model(img, word))
    unit = "step" if a.train or a.ssg else "fwd"
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = defaultdict(float)
    count = defaultdict(int)
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0:
            per_kernel[ev.name] += ev.device_time / 1e3  # ms
            count[ev.name] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    busy = 0.0
    end = -1.0
    for s, e in sorted(spans):  # union of device intervals, us
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    total = sum(per_kernel.values())
    print(f"[profile] {smi}; batch {a.batch}, {a.steps} {unit}s, wall {wall_ms:.3f} ms,"
          f" device kernel time {total:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / 1e3 / wall_ms:.1f}% of wall)")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / a.steps:9.4f} ms/{unit}  x{count[name] // a.steps:4d}  "
              f"{group_of(name):36s} {name[:90]}")
    groups = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[group_of(name)] += ms / a.steps
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[group] {g:40s} {ms:9.4f} ms/{unit} ({100 * ms * a.steps / total:.1f}%)")
    print(json.dumps({"batch": a.batch, "card": smi, "mode": "ssg-train" if a.ssg else "train" if a.train else "eval",
                      f"{unit}_wall_ms": wall_ms / a.steps,
                      "device_busy_share": busy / 1e3 / wall_ms,
                      f"groups_ms_per_{unit}": groups}))
    return 0


def train_step(cs, dev, batch: int):
    """One prepared synthetic train batch and a train step over it."""
    from crog_tpu_torch.data.loader import ShuffleLoader
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = cs._cfg(batch, batch)
    data = next(iter(ShuffleLoader(build_dataset(cfg, cfg.train_split), batch)))
    model = cs._model(cfg, dev).train()
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, 1000, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(cs.SEED), dev)
    return lambda: step(data)


def ssg_train_step(cs, dev, batch: int):
    """One prepared synthetic SSG train batch and an SSG train step over it."""
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.engine.ssg_engine import make_ssg_train_step
    from crog_tpu_torch.train_ssg import loss_config
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = cs._ssg_cfg()
    data = cs._ssg_batches(cfg, cfg.train_split, batch, batch, True)[0]
    model = cs._ssg_model(cfg, dev).train()
    opt, sched = make_optimizer(model, cfg.base_lr, 1.0, cfg.milestones, cfg.lr_decay,
                                1000, cfg.weight_decay)
    step = make_ssg_train_step(model, opt, sched, model.anchors(), loss_config(cfg),
                               set_random_seed(cs.SEED), cfg.max_norm, dev)
    return lambda: step(data)


if __name__ == "__main__":
    sys.exit(main())
