#!/usr/bin/env python3
"""Drive the PyTorch port (crog_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is not 0:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from crog_tpu_torch/csrc (nvcc, sm_90a,
     one process per source, all at once): K1-K4 and the backward kernels
     K1b-K4b;
  3. hold each kernel against its plain PyTorch twin on the card, in bf16,
     at the shapes of CROG at batch 24 and 416^2 -- the forwards in eval,
     the K2-K4 forwards again with dropout on (the twins draw the same
     counter-based mask), and K1b-K4b on every gradient output with dropout
     on -- and time kernel and twin (and, for K1 and K1b, PyTorch's
     scaled_dot_product_attention and its backward as a yardstick only);
     K1b's kernels with the decoder blocks' bf16 cast points must fail
     K1b's tolerance;
  4. the eval main path: full-width CROG (config/OCID-VLG/
     crog_synthetic_r50.yaml: RN50 (3,4,6,3), 416^2, 12-layer text tower,
     3 decoder layers, dim_ffn 2048, bf16) with seeded random weights,
     through ``validate_with_grasp`` over 48 synthetic val samples at batch
     24, with every forward kernel's launch counter checked against the
     launches one forward makes;
  5. the training main path: the same model in train mode through
     ``train_one_epoch`` for 4 steps at batch 24 (2 prepared synthetic train
     batches, reused), with every forward and backward kernel's launch
     counter checked against the launches one step makes; the loss is
     finite, every trainable parameter and BatchNorm statistic moved; then
     train samples/s over 4 more steps;
  6. one sample through the same weights on the card (kernels, bf16) and on
     the CPU (plain PyTorch, fp32): the five logit maps must agree;
  7. one train step's loss and gradients at batch 2, dropout 0, BatchNorm on
     running statistics, on the card (kernels, bf16) and on the CPU (plain
     PyTorch, fp32);
  8. forward latency at batch 1 and eval samples/s at batch 24.

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
TRAIN_STEPS = 4
RATE = 0.1  # the config's decoder dropout
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FWD = ("attention", "decoder_self_block", "decoder_cross_block", "ffn")
BWD = tuple(n + "_bwd" for n in FWD)
# launches of each kernel in one CROG forward, and one train step's forward
# and backward (1 attention pool, 3 decoder layers)
PER_FORWARD = {"attention": 1, "decoder_self_block": 3, "decoder_cross_block": 3,
               "ffn": 3}
PER_STEP = {**PER_FORWARD, **{n + "_bwd": k for n, k in PER_FORWARD.items()}}
# forward kernel vs twin, both bf16 on the same inputs: the twin rounds at
# the same points, so they differ where a reordered f32 sum flips a bf16
# rounding of an intermediate; outputs reach |y| ~ 6, where one bf16 step
# is 2^-5
TOL = {"attention": 3e-2, "decoder_self_block": 0.125,
       "decoder_cross_block": 0.125, "ffn": 0.125}
# backward kernel vs twin, per gradient output, relative to that output's
# largest magnitude: outputs are bf16 (one step is 2^-8 relative at the top
# of a binade) and a reordered f32 sum can flip the bf16 rounding of an
# intermediate (P, dS, dO, dQ, dh) that feeds many outputs; f32 row sums
# (bias and LayerNorm gradients) over 16224 rows see those flips average
# out.  Four bf16 steps; a wrong kernel or mask is off by order 1.
BWD_REL_TOL = 2**-6
# K1b rounds nothing but its outputs (P, dP, dS stay f32), and so does its
# twin: they differ only where a reordered f32 sum lands on a bf16 rounding
# boundary of an output, by one bf16 step of that output (observed on an
# H100: 0.0039 at max |dq| 2, i.e. 2^-9, in 0.24% of the elements).  So each
# output is held to one bf16 step at its largest magnitude, 2^-8 relative,
# and at most 1% of its elements may differ from the twin at all.  The
# share is what sees a lost f32 cast point: rounding P and dS to bf16, as
# the decoder blocks do, moves many outputs by a step while staying within
# 2^-8; ``k1b_cast_check`` shows it on the kernels.
K1B_REL_TOL = 2**-8
K1B_DIFF_SHARE = 0.01
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
    """(ms, limiter): the least time for ``flops`` bf16 tensor-core
    operations and ``nbytes`` of device-memory traffic on an H100."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_inputs(device, b=BATCH, l=676, t=17, d=512, f=2048, lp=169, dp=2048):
    """Seeded inputs at the main path's shapes: B=24 at 416^2 gives a 13x13
    attention pool (169 tokens, width 2048, 32 heads) and a 26x26 decoder
    (676 tokens, width 512, 8 heads, 17 text tokens, FFN 2048); ``dy``
    holds an output gradient for each kernel."""
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
        "dy": {"attention": rnd(b, lp, dp), "decoder_self_block": rnd(b, l, d),
               "decoder_cross_block": rnd(b, l, d), "ffn": rnd(b * l, d)},
    }


def _args(inp):
    s, c, f = inp["decoder_self_block"], inp["decoder_cross_block"], inp["ffn"]
    sargs = (s["x"], s["pos"], s["in_w"], s["in_b"], s["out_w"], s["out_b"],
             s["g_pre"], s["b_pre"], s["g_post"], s["b_post"], 8)
    cargs = (c["x"], c["txt"], c["pos"], c["tpos"], c["pad"], c["in_w"], c["in_b"],
             c["out_w"], c["out_b"], c["g_pre"], c["b_pre"], c["g_post"],
             c["b_post"], 8)
    fargs = (f["x"], f["w1"], f["b1"], f["g"], f["be"], f["w2"], f["b2"])
    return sargs, cargs, fargs


def kernel_cases(inp):
    """name -> (kernel call, plain call, library call or None, flops, bytes)
    for the forward kernels in eval."""
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
    sargs, cargs, fargs = _args(inp)
    x = sargs[0]
    b, l, d = x.shape
    m = b * l
    cases["decoder_self_block"] = (
        lambda: DB.self_block_fwd(*sargs)[0],
        lambda: DB.self_block_plain(*sargs),
        None,
        8.0 * m * d * d + 4.0 * b * l * l * d,
        nbytes(*(t for t in sargs[:-1])) + nbytes(x),
    )
    c = inp["decoder_cross_block"]
    t = c["txt"].shape[1]
    cases["decoder_cross_block"] = (
        lambda: DB.cross_block_fwd(*cargs)[0],
        lambda: DB.cross_block_plain(*cargs),
        None,
        4.0 * m * d * d + 4.0 * b * t * d * d + 4.0 * b * l * t * d,
        nbytes(*(x_ for x_ in cargs[:-1] if x_ is not c["pad"]))
        + b * t * 4 + nbytes(x),  # key mask as f32
    )
    mm, dd = fargs[0].shape
    ff = fargs[1].shape[0]
    cases["ffn"] = (
        lambda: FF.ffn_fwd(*fargs),
        lambda: FF.ffn_plain(*fargs),
        None,
        4.0 * mm * dd * ff,
        nbytes(*fargs) + nbytes(fargs[0]),
    )
    return cases


def dropout_cases(inp):
    """name -> (kernel call, plain call): the K2-K4 forwards in training,
    dropout on with one seed, so kernel and twin draw the same mask."""
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    sargs, cargs, fargs = _args(inp)
    return {
        "decoder_self_block": (lambda: DB.self_block_fwd(*sargs, SEED + 1, RATE)[0],
                               lambda: DB.self_block_plain(*sargs, SEED + 1, RATE)),
        "decoder_cross_block": (lambda: DB.cross_block_fwd(*cargs, SEED + 2, RATE)[0],
                                lambda: DB.cross_block_plain(*cargs, SEED + 2, RATE)),
        "ffn": (lambda: FF.ffn_fwd(*fargs, SEED + 3, RATE),
                lambda: FF.ffn_plain(*fargs, SEED + 3, RATE)),
    }


def backward_cases(inp):
    """name -> (kernel call, plain call, library call or None, flops, bytes,
    output names): K1b-K4b with dropout on (K1 has none), each kernel call on
    what its forward kernel saved.  Every product takes bf16 operands, as in
    the JAX package, so all count at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    cases = {}
    dy = inp["dy"]
    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    b, l, d = q.shape
    do = dy["attention"]
    o = A.fused_attention(q, k, v, h)
    split = lambda x: x.view(b, l, h, d // h).transpose(1, 2).detach().requires_grad_()
    qs, ks, vs = split(q), split(k), split(v)
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
    dos = do.view(b, l, h, d // h).transpose(1, 2)
    cases["attention_bwd"] = (
        lambda: A.attention_bwd(q, k, v, o, do, h),
        lambda: A.attention_bwd_plain(q, k, v, o, do, h),
        lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True),
        10.0 * b * l * l * d, 8 * nbytes(q), ("dq", "dk", "dv"),
    )
    sargs, cargs, fargs = _args(inp)
    x = sargs[0]
    b, l, d = x.shape
    m = b * l
    wbytes = 4 * d * d * 2 + 8 * d * 4  # dW (bf16) and the bias / LN rows
    _, ssaved = DB.self_block_fwd(*sargs, SEED + 1, RATE, save=True)
    dys = dy["decoder_self_block"]
    cases["decoder_self_block_bwd"] = (
        lambda: DB.self_block_bwd(x, ssaved, dys, 8, SEED + 1, RATE),
        lambda: DB.self_block_bwd_plain(*sargs[:-1], dys, 8, SEED + 1, RATE),
        None, 16.0 * m * d * d + 10.0 * b * l * l * d,
        nbytes(x, dys, *ssaved) + nbytes(x) + wbytes,
        ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
         "d_g_post", "d_b_post"),
    )
    t = cargs[1].shape[1]
    _, csaved = DB.cross_block_fwd(*cargs, SEED + 2, RATE, save=True)
    dyc = dy["decoder_cross_block"]
    cases["decoder_cross_block_bwd"] = (
        lambda: DB.cross_block_bwd(cargs[0], csaved, dyc, 8, SEED + 2, RATE),
        lambda: DB.cross_block_bwd_plain(*cargs[:-1], dyc, 8, SEED + 2, RATE),
        None, 8.0 * m * d * d + 8.0 * b * t * d * d + 10.0 * b * l * t * d,
        nbytes(cargs[0], dyc, *csaved) + nbytes(cargs[0]) + b * t * d * 2 + wbytes,
        ("dx", "dtxt", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
         "d_g_post", "d_b_post"),
    )
    xf, w1, b1, g, be, w2, _ = fargs
    mm, dd = xf.shape
    ff = w1.shape[0]
    dyf = dy["ffn"]
    cases["ffn_bwd"] = (
        lambda: FF.ffn_bwd(xf, w1, b1, g, be, w2, dyf, SEED + 3, RATE),
        lambda: FF.ffn_bwd_plain(xf, w1, b1, g, be, w2, dyf, SEED + 3, RATE),
        # recompute, dhn, dx in the kernel; dW1, dW2 outside it
        None, 10.0 * mm * dd * ff,
        nbytes(xf, dyf, w1, w2, b1, g, be) + nbytes(xf) + 2 * dd * ff * 4
        + (3 * ff + dd) * 4,
        ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2"),
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
    "attention_bwd": ("crog_tpu_torch/csrc/attention_bwd.cu",
                      "crog_tpu/ops/pallas_attention.py:140"),
    "decoder_self_block_bwd": ("crog_tpu_torch/csrc/decoder_blocks_bwd.cu",
                               "crog_tpu/ops/pallas_decoder.py:457"),
    "decoder_cross_block_bwd": ("crog_tpu_torch/csrc/decoder_blocks_bwd.cu",
                                "crog_tpu/ops/pallas_decoder.py:550"),
    "ffn_bwd": ("crog_tpu_torch/csrc/ffn_bwd.cu", "crog_tpu/ops/pallas_ffn.py:234"),
}


def _record(name, max_err, bms, by):
    return {"name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": None, "max_abs_err": max_err,
            "ms": None, "plain_ms": None, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def _time(rec, kern, plain, lib):
    rec["ms"] = cuda_ms(kern)
    rec["plain_ms"] = cuda_ms(plain, reps=5)
    rec["library_ms"] = cuda_ms(lib) if lib is not None else None
    print(f"[kernels] {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}"
          f", library {rec['library_ms']}, bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']})", flush=True)


def _compare(name, got, ref, tol, share=1.0):
    """Max-abs error of ``got`` against ``ref``, which must be within
    ``tol``, with at most a ``share`` of the elements differing at all."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max())
    diff = float((err > 0).float().mean())
    ok = bool(torch.isfinite(got.float()).all()) and max_err <= tol and diff <= share
    print(f"[kernels] {name}: max_abs_err {max_err:.6g} (tol {tol:.4g}), "
          f"mean_abs_err {float(err.mean()):.3g}, differing {diff:.4g} (limit "
          f"{share:.4g}), max|ref| {float(ref.float().abs().max()):.4g}", flush=True)
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain twin")
    return max_err


def check_kernels(device, timed: bool = True):
    """Phase 3: every kernel against its twin; returns the records."""
    import torch

    records = {}
    inp = kernel_inputs(device)
    with torch.no_grad():
        for name, (kern, plain, lib, flops, nb) in kernel_cases(inp).items():
            max_err = _compare(name, kern(), plain(), TOL[name])
            records[name] = _record(name, max_err, *bound(flops, nb))
            if timed:
                _time(records[name], kern, plain, lib)
        for name, (kern, plain) in dropout_cases(inp).items():
            _compare(f"{name} (dropout {RATE})", kern(), plain(), TOL[name])
        for name, (kern, plain, lib, flops, nb, outs) in backward_cases(inp).items():
            got, ref = kern(), plain()
            rel, share = ((K1B_REL_TOL, K1B_DIFF_SHARE) if name == "attention_bwd"
                          else (BWD_REL_TOL, 1.0))
            max_err = 0.0
            for o, g, r in zip(outs, got, ref):
                tol = rel * float(r.float().abs().max())
                max_err = max(max_err, _compare(f"{name}.{o}", g, r, tol, share))
            records[name] = _record(name, max_err, *bound(flops, nb))
            if timed:
                _time(records[name], kern, plain, lib)
        k1b_cast_check(inp)
    return records


def k1b_cast_check(inp):
    """K1b's kernels with the decoder blocks' cast points (P and dS rounded
    to bf16) against K1b's twin: every output must differ from it in more
    than K1B_DIFF_SHARE of its elements, or K1b's tolerance could not tell
    a lost f32 cast point."""
    from crog_tpu_torch.ops import attention as A

    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    do = inp["dy"]["attention"]
    o = A.fused_attention(q, k, v, h)
    lost = A.attention_bwd(q, k, v, o, do, h, bf16_casts=True)
    ref = A.attention_bwd_plain(q, k, v, o, do, h)
    shares = [float((g.float() != r.float()).float().mean()) for g, r in zip(lost, ref)]
    print(f"[kernels] attention_bwd with bf16 cast points vs K1b's twin: differing "
          f"{', '.join(f'{x:.4g}' for x in shares)} (K1b's limit {K1B_DIFF_SHARE})",
          flush=True)
    if min(shares) <= K1B_DIFF_SHARE:
        raise AssertionError("K1b's tolerance does not see bf16 cast points")


def launch_counts():
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    return {"attention": A.fused_attention, "decoder_self_block": DB.self_block_fwd,
            "decoder_cross_block": DB.cross_block_fwd, "ffn": FF.ffn_fwd,
            "attention_bwd": A.attention_bwd,
            "decoder_self_block_bwd": DB.self_block_bwd,
            "decoder_cross_block_bwd": DB.cross_block_bwd, "ffn_bwd": FF.ffn_bwd}


def _cfg(samples=SAMPLES, batch=BATCH, opts=()):
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg_from_cfg_file(CONFIG), [
        "wire_format", "legacy", "synthetic_samples", str(samples),
        "batch_size", str(batch), "batch_size_val", str(batch), *opts,
    ])


def _model(cfg, device, dtype=None):
    import torch

    from crog_tpu_torch.models.crog import build_crog, random_init_

    model = build_crog(cfg, dtype)
    random_init_(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def build_model_and_data(device, samples=SAMPLES, batch=BATCH, opts=()):
    from crog_tpu_torch.data.loader import SequentialLoader
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _cfg(samples, batch, opts)
    model = _model(cfg, device).eval()
    ds = build_dataset(cfg, cfg.val_split)
    t0 = time.perf_counter()
    batches = list(SequentialLoader(ds, batch, pad_last_batch=True))
    print(f"[data] {samples} synthetic val samples prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return cfg, model, batches


def _reset(wrappers):
    for w in wrappers.values():
        w.launches = 0


def main_path(device, cfg, model, batches):
    """Phase 4: validate_with_grasp through the kernels; returns launches."""
    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp

    eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
    wrappers = launch_counts()
    _reset(wrappers)
    result = validate_with_grasp(batches, eval_step)
    launches = {n: w.launches for n, w in wrappers.items()}
    forwards = len(batches)
    print(f"[main] IoU={result['iou']:.6f} J@1={result['j_index@1']:.6f} "
          f"J@5={result['j_index@5']:.6f} over {len(result['iou_list'])} samples; "
          f"launches {launches} for {forwards} forwards", flush=True)
    for key in ("iou", "j_index@1", "j_index@5"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"{key} is not finite: {result[key]}")
    for n in launches:
        want = PER_FORWARD.get(n, 0) * forwards
        if launches[n] != want:
            raise AssertionError(f"{n}: {launches[n]} launches, expected {want}")
    return eval_step, launches


def train_path(device, smi: str):
    """Phase 5: train_one_epoch at full width, batch 24, through every
    forward and backward kernel; returns (launches, samples/s, cfg, model,
    a prepared train batch)."""
    import torch

    from crog_tpu_torch.data.loader import ShuffleLoader
    from crog_tpu_torch.engine.crog_engine import make_train_step, train_one_epoch
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = _cfg(2 * BATCH, BATCH, ("print_freq", "2", "epochs", "1"))
    t0 = time.perf_counter()
    loader = ShuffleLoader(build_dataset(cfg, cfg.train_split), BATCH, seed=SEED)
    prepared = list(loader)
    print(f"[train] {2 * BATCH} synthetic train samples prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    batches = [prepared[i % len(prepared)] for i in range(TRAIN_STEPS)]
    model = _model(cfg, device).train()
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, TRAIN_STEPS, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(SEED), device)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    stats0 = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    wrappers = launch_counts()
    _reset(wrappers)
    metrics = train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    loss = float(metrics["loss"])
    print(f"[train] {TRAIN_STEPS} steps at batch {BATCH}: last loss {loss:.6g}, iou "
          f"{float(metrics['iou']):.4g}; launches {launches}", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"train loss is not finite: {loss}")
    for n in launches:
        if launches[n] != PER_STEP[n] * TRAIN_STEPS:
            raise AssertionError(
                f"{n}: {launches[n]} launches, expected {PER_STEP[n] * TRAIN_STEPS}")
    named = dict(model.named_parameters())
    frozen = [n for n, p in params0.items() if torch.equal(p, named[n].detach())]
    buffers = dict(model.named_buffers())
    still = [n for n, b in stats0.items() if torch.equal(b, buffers[n])]
    print(f"[train] {len(params0) - len(frozen)}/{len(params0)} trainable parameters "
          f"and {len(stats0) - len(still)}/{len(stats0)} BatchNorm statistics moved",
          flush=True)
    if frozen or still:
        raise AssertionError(f"did not move: {frozen[:5]} {still[:5]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    print(f"[time] train step batch {BATCH}: {dt * 1e3:.2f} ms = {BATCH / dt:.2f} "
          f"samples/s (prepared host batches in) on {smi}", flush=True)
    return launches, BATCH / dt, prepared[0]


# card (bf16, kernels) vs CPU (fp32, plain) on one train step at batch 2,
# dropout 0, with the BatchNorm layers on their running statistics: bounds
# on the loss's relative error and on the relative L2 error of each group's
# gradients.  Train-mode BatchNorm over 2 samples (the FPN's txt_proj
# normalizes 2 text states) makes these gradients ill-conditioned: on the
# CPU the same plain code in bf16 and in fp32 then differs by order 1, so
# such a comparison could not tell a wrong kernel from rounding
# (tools/torch_grad_conditioning.py measures both settings).  Train-mode
# BatchNorm itself is held against flax by tests/test_torch_train.py, and
# phase 5 runs it on the card.  bf16 keeps ~3 significant digits through
# ~70 layers forward and back; a wrong backward kernel is off by order 1.
TRAIN_LOSS_TOL = 0.05
TRAIN_GRAD_TOL = 0.25
GROUPS = (("vision", "backbone.visual."), ("text", "backbone."), ("neck", "neck."),
          ("decoder", "decoder."), ("projector", "proj."))


def _group(name):
    return next(g for g, prefix in GROUPS if name.startswith(prefix))


def train_step_gap(batch, device, running_bn: bool = True, opts=()):
    """(loss rel error, {group: grad rel-L2}) of one train step at batch 2,
    dropout 0, compute dtype on ``device`` vs fp32 on the CPU; ``opts``
    override further config keys."""
    import torch

    from crog_tpu_torch.models.clip import BatchNorm
    from crog_tpu_torch.models.crog import crog_losses

    cfg = _cfg(opts=("dropout", "0.0", *opts))
    # two samples with different sentences (near-equal text states would
    # leave the 2-sample txt_proj BatchNorm a vanishing variance)
    words = [tuple(w) for w in batch["word"]]
    j = next((i for i in range(1, len(words)) if words[i] != words[0]), 1)
    mini = {k: v[[0, j]] for k, v in batch.items() if k in (
        "img", "word", "mask", "qua", "sin", "cos", "wid")}
    out = []
    for dev, dtype in ((device, None), (torch.device("cpu"), torch.float32)):
        model = _model(cfg, dev, dtype).train()
        for mod in model.modules():
            if running_bn and isinstance(mod, BatchNorm):
                mod.eval()
        put = lambda k: torch.as_tensor(mini[k]).to(dev)
        loss, _ = crog_losses(model(put("img"), put("word")),
                              {k: put(k) for k in ("mask", "qua", "sin", "cos", "wid")})
        loss.backward()
        out.append((loss.item(), {n: p.grad.float().cpu() for n, p in
                                  model.named_parameters() if p.grad is not None}))
    (lc, gc), (lp, gp) = out
    if set(gc) != set(gp):
        raise AssertionError("the two runs give gradients for different parameters")
    groups = {}
    for g, _ in GROUPS:
        names = [n for n in gp if _group(n) == g]
        num = sum(float((gc[n] - gp[n]).pow(2).sum()) for n in names)
        den = sum(float(gp[n].pow(2).sum()) for n in names)
        groups[g] = (num / max(den, 1e-30)) ** 0.5
    print(f"[e2e-train] loss {lc:.6g} vs cpu fp32 {lp:.6g}; grad rel_l2 "
          + ", ".join(f"{g} {r:.4g}" for g, r in groups.items()), flush=True)
    return abs(lc - lp) / abs(lp), groups


def e2e_train_step(batch, device):
    """Phase 7: loss and gradients of one train step, card vs CPU."""
    rel, groups = train_step_gap(batch, device)
    worst = max(groups.values())
    print(f"[e2e-train] loss rel {rel:.4g} (tol {TRAIN_LOSS_TOL}), worst grad rel_l2 "
          f"{worst:.4g} (tol {TRAIN_GRAD_TOL})", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"card vs CPU train step: loss rel {rel:.4g}, grad {worst:.4g}")


def e2e_agreement(model, batch, cfg):
    """Phase 6: one sample, card bf16 kernels vs CPU fp32 plain."""
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
    """Phase 8: batch-1 forward latency and batch-24 eval throughput."""
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
    eval_step, eval_launches = main_path(device, cfg, model, batches)
    e2e_agreement(model, batches[0], cfg)
    fwd_ms, eval_rate = timings(model, eval_step, batches[0], smi)
    del model, eval_step
    torch.cuda.empty_cache()
    launches, train_rate, train_batch = train_path(device, smi)
    for n, rec in records.items():
        rec["launches"] = launches[n]
    e2e_train_step(train_batch, device)
    print(f"[done] {time.perf_counter() - t_start:.1f} s; train {train_rate:.2f} and "
          f"eval {eval_rate:.2f} samples/s at batch {BATCH}", flush=True)

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
