"""Device-time breakdown of the PyTorch port's CROG eval forward, of its
train step, or of SSG's train step, on one card.

    python3 tools/torch_profile_eval.py [--batch 24] [--steps 3] [--train | --ssg]
        [--wire rawlb|raw|compact|legacy] [--fused-stem] [--objects N]

Builds full-width CROG (config/OCID-VLG/crog_synthetic_r50.yaml, bf16, the
s2d stem, seeded random weights, as chip_smoke.py does; ``--fused-stem``
runs the stem's stride-1 convs through K6/K6b), warms up, then traces
``--steps`` forwards on the unpacked batch (with ``--train``: train steps --
the batch's host-to-device copy and unpack in the ``--wire`` format,
default the config's rawlb, forward, backward, Adam -- on one prepared
synthetic train batch, dropout on; with ``--ssg``: full-width SSG train
steps (config/OCID-Grasp/ssg_r50.yaml, 544^2, AdamW) on one prepared
synthetic batch in the ``--wire`` format, raw (the config's, 480x640
frames unpacked on the card) or legacy, and then the batch's copy and
unpack alone, its share of the step's device time, and the step's peak
device memory; ``--objects N`` draws N objects in every 480x640 frame, in
place of the synthetic's 2-4, so that the raw wire's occupied instance
slots, and the unpack's raster and warp chunks, grow with N) with
torch.profiler and prints: device time by kernel (top
25), device time by group (the port's hand-written kernels, cuDNN
convolutions, cuBLAS GEMMs, pooling, casts and copies, reductions, other
elementwise), the device busy share of the traced wall time, and one JSON
line with the group totals per forward or step.
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
    # first match wins: the s2d kernels before K2b/K3b's "wgrad_kernel"
    ("K6b s2dconv wgrad (cluster kernel)", ("s2dconv_wgrad",)),
    ("K6 s2dconv (forward, dgrad)", ("s2dconv_",)),
    # K1 itself (the attention pool, 169 keys: the one-pass kernel of 3 key
    # tiles), then the attention step inside K2 (676 keys, two passes) and
    # K3 (17 keys, one pass of 1 tile)
    ("K1 attention pool (attn_fwd_kernel<3>)", ("attn_fwd_kernel<3>",)),
    ("attention forward inside K2/K3 (attn_fwd_kernel<0>, <1>)", ("attn_fwd_kernel",)),
    ("K1b attention-pool backward (one CTA per head)", ("attn_bwd_head",)),
    ("attention backward (K2b/K3b inner; K1b past 256 tokens)", ("attn_bwd_",)),
    ("K2b/K3b: ln_post_bwd, ln_pre_bwd", ("ln_post_bwd", "ln_pre_bwd")),
    ("K2b/K3b: gemm_nn (dO, dX)", ("gemm_nn_kernel",)),
    ("K2b/K3b: wgrad (dW)", ("wgrad_kernel",)),
    ("K2b/K3b/K4b/K6b: reduce_rows", ("reduce_rows_kernel",)),
    ("K4b ffn_bwd: cluster kernel (recompute, hn, dh, column sums)", ("ffn_bwd_hidden",)),
    ("K4 y GEMM and K4b dx GEMM (ffn_out_kernel)", ("ffn_out_kernel",)),
    ("K2/K3 block: ln_pos", ("ln_pos_kernel",)),
    ("K2/K3 block: projections (proj_gemm)", ("proj_gemm_kernel",)),
    ("K2/K3 block: out-projection, LN, residual (outproj_ln_cluster)",
     ("outproj_ln_cluster_kernel",)),
    ("K4 ffn: cluster kernel (hidden, hn)", ("ffn_fwd_hidden",)),
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


def profile_run(run, steps: int):
    """Trace ``steps`` calls of ``run`` after 3 warm-up calls: (device ms by
    kernel, launches by kernel, device busy ms, wall ms), all summed over
    the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = defaultdict(float)
    count = defaultdict(int)
    spans = []
    for ev in prof.events():
        # kernels only: a GPU user annotation (Optimizer.step#Adam.step) spans
        # kernels already counted
        if (ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time > 0
                and not getattr(ev, "is_user_annotation", False)):
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
    return per_kernel, count, busy / 1e3, wall_ms


def main() -> int:
    import torch

    import chip_smoke as cs
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.engine.crog_engine import device_batch, set_exact_fp32_matmul
    from crog_tpu_torch.test_crog import build_dataset

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--train", action="store_true")
    p.add_argument("--ssg", action="store_true")
    p.add_argument("--wire", default=None, choices=("rawlb", "raw", "compact", "legacy"),
                   help="default: the config's (CROG rawlb, SSG raw)")
    p.add_argument("--fused-stem", action="store_true")
    p.add_argument("--objects", type=int, default=None,
                   help="with --ssg: objects in every frame (default the synthetic's 2-4)")
    a = p.parse_args()
    wire = a.wire or ("raw" if a.ssg else "rawlb")
    if a.ssg and wire not in ("raw", "legacy"):
        p.error("--ssg takes --wire raw or legacy")
    if a.objects and not a.ssg:
        p.error("--objects needs --ssg")
    if not torch.cuda.is_available():
        print("torch_profile_eval: no CUDA device", file=sys.stderr)
        return 2
    set_exact_fp32_matmul()
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    if a.ssg:
        run, unpack, slots = ssg_train_step(cs, dev, a.batch, wire, a.objects)
    elif a.train:
        run = train_step(cs, dev, a.batch, wire, a.fused_stem)
    else:
        cfg = cs._cfg(a.batch, a.batch, ("wire_format", wire))
        model = cs._model(cfg, dev, fused_stem=a.fused_stem).eval()
        batch = next(iter(DataLoader(build_dataset(cfg, cfg.val_split), a.batch)))
        one = device_batch(batch, dev, cfg.input_size, train=False)
        run = torch.no_grad()(lambda: model(one["img"], one["word"]))
    unit = "step" if a.train or a.ssg else "fwd"
    torch.cuda.reset_peak_memory_stats()
    per_kernel, count, busy, wall_ms = profile_run(run, a.steps)
    peak = torch.cuda.max_memory_allocated()
    total = sum(per_kernel.values())
    print(f"[profile] {smi}; batch {a.batch}, {a.steps} {unit}s, wall {wall_ms:.3f} ms,"
          f" device kernel time {total:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall); peak memory {peak / 2**30:.2f} GiB "
          "allocated")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / a.steps:9.4f} ms/{unit}  x{count[name] // a.steps:4d}  "
              f"{group_of(name):36s} {name[:90]}")
    groups = defaultdict(float)
    for name, ms in per_kernel.items():
        groups[group_of(name)] += ms / a.steps
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[group] {g:40s} {ms:9.4f} ms/{unit} ({100 * ms * a.steps / total:.1f}%)")
    record = {"batch": a.batch, "card": smi,
              "mode": "ssg-train" if a.ssg else "train" if a.train else "eval",
              "wire": wire, "fused_stem": a.fused_stem, "objects": a.objects,
              f"{unit}_wall_ms": wall_ms / a.steps, "device_busy_share": busy / wall_ms,
              "peak_memory_bytes": peak, f"groups_ms_per_{unit}": groups}
    if a.ssg:
        # the batch's copy and unpack alone, as the step runs them
        u_kernel, u_count, u_busy, u_wall = profile_run(unpack, a.steps)
        u_total = sum(u_kernel.values())
        print(f"[unpack] copy and unpack ({wire} wire) alone: device kernel time "
              f"{u_total / a.steps:.4f} ms/step ({100 * u_total / total:.1f}% of the step's), "
              f"wall {u_wall / a.steps:.3f} ms/step, device busy {u_busy / a.steps:.3f} ms/step, "
              f"{sum(u_count.values()) // a.steps} kernel launches/step, {slots} instance "
              "slots")
        for name, ms in sorted(u_kernel.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {ms / a.steps:9.4f} ms/step  x{u_count[name] // a.steps:5d}  "
                  f"{group_of(name):36s} {name[:90]}")
        record["unpack_device_ms_per_step"] = u_total / a.steps
        record["unpack_wall_ms_per_step"] = u_wall / a.steps
        record["instance_slots"] = slots
    print(json.dumps(record))
    return 0


def train_step(cs, dev, batch: int, wire: str, fused_stem: bool):
    """One prepared synthetic train batch in ``wire`` and a train step over
    it."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = cs._cfg(batch, batch, ("wire_format", wire))
    data = next(iter(DataLoader(build_dataset(cfg, cfg.train_split), batch, shuffle=True,
                                   drop_last=True)))
    model = cs._model(cfg, dev, fused_stem=fused_stem).train()
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, 1000, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(cs.SEED), dev)
    return lambda: step(data)


def ssg_train_step(cs, dev, batch: int, wire: str, objects=None):
    """One prepared synthetic SSG train batch in ``wire``, of frames with
    ``objects`` objects each if given: (an SSG train step over it, its copy
    and unpack alone, the batch's instance slots)."""
    import random

    from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGraspFrames
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.engine.ssg_engine import device_batch, make_ssg_train_step
    from crog_tpu_torch.train_ssg import loss_config, ssg_collate
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = cs._ssg_cfg(("wire_format", wire, "batch_size", str(batch)))
    if objects:
        ds = SyntheticOCIDGraspFrames(batch, cfg.train_split, cfg.img_size,
                                      num_classes=cfg.num_classes, raw=wire == "raw",
                                      max_objs=cfg.max_objs, rng=random.Random(cs.SEED),
                                      objects=(objects, objects + 1))
        data = ssg_collate(cfg)([ds[i] for i in range(batch)])
    else:
        data = cs._ssg_data(cfg, cfg.train_split, batch, batch, True)[0][0]
    slots = int(data["obj_valid"].shape[1])
    model = cs._ssg_model(cfg, dev).train()
    opt, sched = make_optimizer(model, cfg.base_lr, 1.0, cfg.milestones, cfg.lr_decay,
                                1000, cfg.weight_decay)
    step = make_ssg_train_step(model, opt, sched, model.anchors(), loss_config(cfg),
                               set_random_seed(cs.SEED), cfg.max_norm, dev,
                               max_objs=cfg.max_objs)
    return (lambda: step(data),
            lambda: device_batch(data, dev, cfg.img_size, max_objs=cfg.max_objs), slots)


if __name__ == "__main__":
    sys.exit(main())
