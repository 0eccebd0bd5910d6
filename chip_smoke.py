#!/usr/bin/env python3
"""Drive the PyTorch port (crog_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is not 0:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels K1-K4 from crog_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, all at once);
  3. hold each kernel against its plain PyTorch twin on the card, in bf16,
     at the shapes of CROG eval at batch 24 and 416^2, and time both (and,
     for K1, PyTorch's scaled_dot_product_attention as a yardstick only);
  4. the main path: full-width CROG (config/OCID-VLG/crog_synthetic_r50.yaml:
     RN50 (3,4,6,3), 416^2, 12-layer text tower, 3 decoder layers, dim_ffn
     2048, bf16) with seeded random weights, through ``validate_with_grasp``
     over 48 synthetic val samples at batch 24, with every kernel's launch
     counter checked against the launches one forward makes;
  5. one sample through the same weights on the card (kernels, bf16) and on
     the CPU (plain PyTorch, fp32): the five logit maps must agree;
  6. forward latency at batch 1 and eval samples/s at batch 24.

Precision: fp32 products on the card run in full fp32 (TF32 off for matmul
and cuDNN) wherever fp32 is compared; the model computes in bf16.

The second-to-last lines are a JSON ``kernels`` record and the nvidia-smi
line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 0
BATCH = 24
SAMPLES = 48
CONFIG = "config/OCID-VLG/crog_synthetic_r50.yaml"
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# launches of each kernel in one CROG forward (1 attention pool, 3 decoder layers)
PER_FORWARD = {"attention": 1, "decoder_self_block": 3, "decoder_cross_block": 3,
               "ffn": 3}
# kernel vs twin, both bf16 on the same inputs: the twin rounds at the same
# points, so they differ where a reordered f32 sum flips a bf16 rounding of
# an intermediate; outputs reach |y| ~ 6, where one bf16 step is 2^-5
TOL = {"attention": 3e-2, "decoder_self_block": 0.125,
       "decoder_cross_block": 0.125, "ffn": 0.125}
# card (bf16, kernels) vs CPU (fp32, plain) on one sample: bound on the
# relative L2 error ||card - cpu|| / ||cpu|| of each logit map.  bf16 keeps
# ~3 significant digits and the error grows through the ~70 layers of a
# random network (``random_init_`` keeps the residual branches small to
# bound that growth); a wrong kernel is off by order 1.
E2E_TOL = 0.15


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """(ms, limiter): the least time for ``flops`` bf16 operations and
    ``nbytes`` of device-memory traffic on an H100."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_inputs(device, b=BATCH, l=676, t=17, d=512, f=2048, lp=169, dp=2048):
    """Seeded inputs at the main path's shapes: B=24 eval at 416^2 gives a
    13x13 attention pool (169 tokens, width 2048, 32 heads) and a 26x26
    decoder (676 tokens, width 512, 8 heads, 17 text tokens, FFN 2048)."""
    import torch

    g = torch.Generator().manual_seed(SEED)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * std).to(device, dtype)

    lengths = torch.randint(4, t + 1, (b,), generator=g)
    pad = torch.arange(t)[None, :] >= lengths[:, None]  # real padded keys
    blk = lambda: dict(
        in_w=rnd(3 * d, d, std=d**-0.5), in_b=rnd(3 * d, std=0.05, dtype=torch.float32),
        out_w=rnd(d, d, std=d**-0.5), out_b=rnd(d, std=0.05, dtype=torch.float32),
        g_pre=1 + rnd(d, std=0.1, dtype=torch.float32),
        b_pre=rnd(d, std=0.05, dtype=torch.float32),
        g_post=1 + rnd(d, std=0.1, dtype=torch.float32),
        b_post=rnd(d, std=0.05, dtype=torch.float32),
    )
    return {
        "attention": dict(q=rnd(b, lp, dp), k=rnd(b, lp, dp), v=rnd(b, lp, dp),
                          heads=dp // 64),
        "decoder_self_block": dict(x=rnd(b, l, d), pos=rnd(l, d, std=0.5), **blk()),
        "decoder_cross_block": dict(
            x=rnd(b, l, d), txt=rnd(b, t, d), pos=rnd(l, d, std=0.5),
            tpos=rnd(t, d, std=0.5), pad=pad.to(device), **blk()),
        "ffn": dict(x=rnd(b * l, d), w1=rnd(f, d, std=d**-0.5),
                    b1=rnd(f, std=0.05, dtype=torch.float32),
                    g=1 + rnd(f, std=0.1, dtype=torch.float32),
                    be=rnd(f, std=0.05, dtype=torch.float32),
                    w2=rnd(d, f, std=f**-0.5),
                    b2=rnd(d, std=0.05, dtype=torch.float32)),
    }


def kernel_cases(inp):
    """name -> (kernel call, plain call, library call or None, flops, bytes)."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    cases = {}
    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    b, l, d = q.shape

    def sdpa():
        split = lambda x: x.view(b, l, h, d // h).transpose(1, 2)
        return F.scaled_dot_product_attention(split(q), split(k), split(v))

    cases["attention"] = (
        lambda: A.fused_attention(q, k, v, h),
        lambda: A.attention_plain(q, k, v, h),
        sdpa,
        4.0 * b * h * l * l * (d // h),
        nbytes(q, k, v) + nbytes(q),
    )
    s = inp["decoder_self_block"]
    sargs = (s["x"], s["pos"], s["in_w"], s["in_b"], s["out_w"], s["out_b"],
             s["g_pre"], s["b_pre"], s["g_post"], s["b_post"], 8)
    b, l, d = s["x"].shape
    m = b * l
    cases["decoder_self_block"] = (
        lambda: DB.decoder_self_block(*sargs),
        lambda: DB.self_block_plain(*sargs),
        None,
        8.0 * m * d * d + 4.0 * b * l * l * d,
        nbytes(*(t for t in sargs[:-1])) + nbytes(s["x"]),
    )
    c = inp["decoder_cross_block"]
    cargs = (c["x"], c["txt"], c["pos"], c["tpos"], c["pad"], c["in_w"], c["in_b"],
             c["out_w"], c["out_b"], c["g_pre"], c["b_pre"], c["g_post"],
             c["b_post"], 8)
    t = c["txt"].shape[1]
    cases["decoder_cross_block"] = (
        lambda: DB.decoder_cross_block(*cargs),
        lambda: DB.cross_block_plain(*cargs),
        None,
        4.0 * m * d * d + 4.0 * b * t * d * d + 4.0 * b * l * t * d,
        nbytes(*(x for x in cargs[:-1] if x is not c["pad"]))
        + b * t * 4 + nbytes(c["x"]),  # key mask as f32
    )
    f = inp["ffn"]
    fargs = (f["x"], f["w1"], f["b1"], f["g"], f["be"], f["w2"], f["b2"])
    mm, dd = f["x"].shape
    ff = f["w1"].shape[0]
    cases["ffn"] = (
        lambda: FF.fused_ffn(*fargs),
        lambda: FF.ffn_plain(*fargs),
        None,
        4.0 * mm * dd * ff,
        nbytes(*fargs) + nbytes(f["x"]),
    )
    return cases


SOURCES = {
    "attention": ("crog_tpu_torch/csrc/attention.cu",
                  "crog_tpu/ops/pallas_attention.py:111"),
    "decoder_self_block": ("crog_tpu_torch/csrc/decoder_blocks.cu",
                           "crog_tpu/ops/pallas_decoder.py:422"),
    "decoder_cross_block": ("crog_tpu_torch/csrc/decoder_blocks.cu",
                            "crog_tpu/ops/pallas_decoder.py:511"),
    "ffn": ("crog_tpu_torch/csrc/ffn.cu", "crog_tpu/ops/pallas_ffn.py:197"),
}


def check_kernels(device, timed: bool = True):
    """Phase 3: every kernel against its twin; returns the records."""
    import torch

    records = {}
    cases = kernel_cases(kernel_inputs(device))
    for name, (kern, plain, lib, flops, nb) in cases.items():
        got = kern()
        ref = plain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        max_err = float(err.max())
        ok = bool(torch.isfinite(got.float()).all()) and max_err <= TOL[name]
        print(f"[kernels] {name}: max_abs_err {max_err:.6g} (tol {TOL[name]}), "
              f"mean_abs_err {float(err.mean()):.3g}, max|ref| "
              f"{float(ref.float().abs().max()):.4g}", flush=True)
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain twin")
        bms, by = bound(flops, nb)
        rec = {"name": name, "route": "cuda", "source": SOURCES[name][0],
               "replaces": SOURCES[name][1], "launches": None,
               "max_abs_err": max_err, "ms": None, "plain_ms": None,
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        if timed:
            rec["ms"] = cuda_ms(kern)
            rec["plain_ms"] = cuda_ms(plain, reps=5)
            rec["library_ms"] = cuda_ms(lib) if lib is not None else None
            print(f"[kernels] {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}"
                  f", library {rec['library_ms']}, bound {bms:.4f} by {by})",
                  flush=True)
        records[name] = rec
    return records


def launch_counts():
    from crog_tpu_torch.ops.attention import fused_attention
    from crog_tpu_torch.ops.decoder_blocks import decoder_cross_block, decoder_self_block
    from crog_tpu_torch.ops.ffn import fused_ffn

    return {"attention": fused_attention, "decoder_self_block": decoder_self_block,
            "decoder_cross_block": decoder_cross_block, "ffn": fused_ffn}


def build_model_and_data(device, samples=SAMPLES, batch=BATCH, opts=()):
    import torch

    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
    from crog_tpu_torch.data.loader import SequentialLoader
    from crog_tpu_torch.models.crog import build_crog, random_init_
    from crog_tpu_torch.test_crog import build_dataset

    cfg = merge_cfg_from_list(load_cfg_from_cfg_file(CONFIG), [
        "wire_format", "legacy", "synthetic_samples", str(samples),
        "batch_size_val", str(batch), *opts,
    ])
    model = build_crog(cfg)
    random_init_(model, torch.Generator().manual_seed(SEED))
    model = model.to(device).eval()
    ds = build_dataset(cfg, cfg.val_split)
    t0 = time.perf_counter()
    batches = list(SequentialLoader(ds, batch, pad_last_batch=True))
    print(f"[data] {samples} synthetic samples prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return cfg, model, batches


def main_path(device, cfg, model, batches):
    """Phase 4: validate_with_grasp through the kernels; returns launches."""
    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp

    eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    result = validate_with_grasp(batches, eval_step)
    launches = {n: w.launches for n, w in wrappers.items()}
    forwards = len(batches)
    print(f"[main] IoU={result['iou']:.6f} J@1={result['j_index@1']:.6f} "
          f"J@5={result['j_index@5']:.6f} over {len(result['iou_list'])} samples; "
          f"launches {launches} for {forwards} forwards", flush=True)
    for key in ("iou", "j_index@1", "j_index@5"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"{key} is not finite: {result[key]}")
    for n, per in PER_FORWARD.items():
        if launches[n] != per * forwards:
            raise AssertionError(
                f"{n}: {launches[n]} launches, expected {per * forwards}")
    return eval_step, launches


def e2e_agreement(model, batch, cfg):
    """Phase 5: one sample, card bf16 kernels vs CPU fp32 plain."""
    import torch

    from crog_tpu_torch.models.crog import build_crog

    img = torch.as_tensor(batch["img"][:1])
    word = torch.as_tensor(batch["word"][:1])
    dev = next(model.parameters()).device
    with torch.no_grad():
        card = model(img.to(dev), word.to(dev)).float().cpu()
        cpu_model = build_crog(cfg, torch.float32)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu = cpu_model.eval()(img, word)
    if card.shape != cpu.shape or not torch.isfinite(card).all():
        raise AssertionError(f"card output {tuple(card.shape)} not finite/shaped")
    worst = 0.0
    for i, name in enumerate(("mask", "qua", "sin", "cos", "wid")):
        d = card[..., i] - cpu[..., i]
        rel = float(d.norm() / cpu[..., i].norm().clamp_min(1e-6))
        worst = max(worst, rel)
        print(f"[e2e] {name}: rel_l2 {rel:.4g}, max|card-cpu| "
              f"{float(d.abs().max()):.5g}, max|cpu| "
              f"{float(cpu[..., i].abs().max()):.5g}", flush=True)
    if worst > E2E_TOL:
        raise AssertionError(f"card vs CPU logits rel_l2 {worst:.4g} > {E2E_TOL}")
    return worst


def timings(model, eval_step, batch, smi: str):
    """Phase 6: batch-1 forward latency and batch-24 eval throughput."""
    import torch

    dev = next(model.parameters()).device
    img1 = torch.as_tensor(batch["img"][:1]).to(dev)
    word1 = torch.as_tensor(batch["word"][:1]).to(dev)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(img1, word1), reps=10)
    torch.cuda.synchronize()
    reps = 5
    eval_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = eval_step(batch)
    out["iou"].cpu()
    dt = (time.perf_counter() - t0) / reps
    n = len(batch["word"])
    print(f"[time] forward batch 1: {fwd_ms:.3f} ms; eval step batch {n}: "
          f"{dt * 1e3:.2f} ms = {n / dt:.2f} samples/s (host arrays in, metrics out) "
          f"on {smi}", flush=True)
    return fwd_ms, n / dt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    set_exact_fp32_matmul()
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"[build] {len(reports)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    records = check_kernels(device)
    cfg, model, batches = build_model_and_data(device)
    eval_step, launches = main_path(device, cfg, model, batches)
    for n, rec in records.items():
        rec["launches"] = launches[n]
    e2e_agreement(model, batches[0], cfg)
    timings(model, eval_step, batches[0], smi)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
