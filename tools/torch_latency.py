"""Batch-1 forward latency, parameter count and peak device memory of the
port's CROG (counterpart of tools/latency.py).

    python3 tools/torch_latency.py --config config/OCID-VLG/crog_multiple_r50.yaml \\
        [--params-dtype float32|bfloat16|both] [--fused-stem] [--device cuda] [--opts ...]

The model is the config's (its compute dtype, its stem; ``--fused-stem``
runs the s2d stem's convs through K6, or K6-f32 at ``compute_dtype:
float32``) with weights seeded by
``manual_seed``, in eval mode.  500 forwards at batch 1 of one seeded image
and word-id row, each input chained on the last output (``img + 0 *
out[0, 0, 0, 0]``), so that the forwards run one after another on the
device; the first 100 are warm-up.  The time of the other 400 comes from
CUDA events (a host clock after a final synchronize on the CPU).
``--params-dtype bfloat16`` serves a copy of the model with every floating
parameter and buffer cast to bf16 (the layers' casts to the compute dtype
then cost nothing); ``both`` times the two and prints the largest logit and
sigmoid difference between them.  Peak memory is
``torch.cuda.max_memory_allocated`` over the timed forwards.  ``--device``
defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ITERS = 500  # chained forwards at batch 1, as tools/latency.py
WARMUP = 100  # the first ones, not timed


def chained_ms(model, img, word, iters: int, warmup: int) -> float:
    """Mean ms per forward over ``iters - warmup`` chained forwards."""
    cuda = img.device.type == "cuda"
    prev = torch.zeros((), dtype=img.dtype, device=img.device)
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    end = torch.cuda.Event(enable_timing=True) if cuda else None
    t0 = None
    with torch.no_grad():
        for i in range(iters):
            if i == warmup:
                if cuda:
                    start.record()
                else:
                    t0 = time.perf_counter()
            prev = model(img + 0.0 * prev, word)[0, 0, 0, 0].to(img.dtype)
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / (iters - warmup)
        float(prev)
        return (time.perf_counter() - t0) * 1e3 / (iters - warmup)


def device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return smi[device.index or 0]


def main(argv=None):
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.models.crog import build_crog, random_init_
    from crog_tpu_torch.parallel.dist import resolve_device

    parser = argparse.ArgumentParser(description="CROG inference latency (PyTorch)")
    parser.add_argument("--config", default="config/OCID-VLG/crog_multiple_r50.yaml")
    parser.add_argument("--params-dtype", default="both",
                        choices=("float32", "bfloat16", "both"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fused-stem", action="store_true",
                        help="run the s2d stem's stride-1 convs through K6 (K6-f32 "
                             "at compute_dtype float32)")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    cfg = load_cfg_from_cfg_file(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    device = resolve_device(a.device)
    set_exact_fp32_matmul()

    model = build_crog(cfg, None, a.fused_stem)
    random_init_(model, torch.Generator().manual_seed(cfg.manual_seed))
    model = model.to(device).eval()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(
        rng.randn(1, cfg.input_size, cfg.input_size, 3).astype(np.float32)).to(device)
    word = torch.from_numpy(rng.randint(0, 4096, (1, cfg.word_len)).astype(np.int64)).to(device)

    modes = ("float32", "bfloat16") if a.params_dtype == "both" else (a.params_dtype,)
    results, outs, peaks = {}, {}, {}
    for mode in modes:
        m = copy.deepcopy(model).to(torch.bfloat16) if mode == "bfloat16" else model
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        results[mode] = chained_ms(m, img, word, ITERS, WARMUP)
        if device.type == "cuda":
            peaks[mode] = torch.cuda.max_memory_allocated(device)
        with torch.no_grad():
            outs[mode] = m(img, word).float().cpu().numpy()
        del m

    params_m = sum(p.numel() for p in model.parameters()) * 1e-6
    print("#########################################")
    print(f"Average Parameters : {params_m:.2f} M")
    for mode, ms in results.items():
        print(f"[params {mode}] Average FPS: {1e3 / ms:.2f}   Average Latency: {ms:.3f} ms "
              f"({ITERS - WARMUP} chained forwards at batch 1 after {WARMUP})")
    if len(outs) == 2:
        d = np.abs(outs["float32"] - outs["bfloat16"])
        sig = {k: torch.sigmoid(torch.from_numpy(v)).numpy() for k, v in outs.items()}
        print(f"bf16-params parity: max |logit delta| {d.max():.4f}, "
              f"max |sigmoid delta| {np.abs(sig['float32'] - sig['bfloat16']).max():.4f}")
    for mode, peak in peaks.items():
        extra = " (the fp32 model resident too)" if mode == "bfloat16" else ""
        print(f"[params {mode}] Peak Device Memory: {peak / 2**30:.3f} GiB{extra}")
    if not peaks:
        print("Peak Device Memory: not measured (no card)")
    print(f"device: {device_name(device)}; config {a.config}; compute "
          f"{cfg.get('compute_dtype', 'float32')}; torch {torch.__version__}")
    print("#########################################")
    return results


if __name__ == "__main__":
    main()
