"""The attention kernels K1, K1b, K2, K2b, K3 and K3b (bf16 and fp32) of one
or more trees on one card, in turns, by CUDA events; and each tree's
registers and spills of its attention kernels from the build.

    python3 tools/torch_head_dims.py [--tree DIR ...] [--dims 64 ...]
                                     [--rounds N] [--reps N]

On chip_smoke.py's phase-20 inputs (B 24, K2's 676 tokens, K3's 17 text
keys with per-sample padding, D 512 over 512 / dh heads, dropout 0.1 in the
backward blocks): K1 and K1b at K2's self-attention step (K1b on K1's
output, at fp32 on K1-f32's logsumexp), K2 and K3 in eval, K2b and K3b on
the intermediates their forwards saved.  Each ``--tree DIR`` (an unpacked
other commit; default this checkout) runs in a process of its own with its
own ``crog_tpu_torch`` (built into its own ``_build``) and this checkout's
``chip_smoke.py`` for the inputs and the timer, the trees in turns over
``--rounds`` (A B B A for two trees and two rounds), so that their readings
come from one card in one call.  A head dim a tree's kernels do not take is
skipped for that tree.  Prints one ``[head-dims]`` line per tree, round,
dtype and head dim, each tree's ``[head-dims] ptxas`` lines (the attention
kernels' registers and spill stores, as chip_smoke.py's ``[build]`` lines
name them), the card's name and power limit, and a JSON summary to
``chiprun_out/head_dims.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("attention", "attention_bwd", "attention_f32", "attention_bwd_f32", "decoder_blocks",
        "decoder_blocks_bwd", "decoder_blocks_f32", "decoder_blocks_bwd_f32")
KERNELS = ("K1", "K1b", "K2", "K2b", "K3", "K3b")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def readings(cs, device, dtype, dh: int, reps: int) -> dict:
    """{kernel: CUDA-event ms} at head dim ``dh``."""
    import torch

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB

    f32 = dtype == torch.float32
    b, l, d, h = cs.BATCH, 676, 512, 512 // dh
    inp = cs.kernel_inputs(device, b=b, l=l, t=17, d=d, dtype=torch.float32 if f32 else None)
    sargs, cargs, _ = cs._args(inp)
    sargs, cargs = sargs[:-1], cargs[:-1]  # without the head count
    x, xc = sargs[0], cargs[0]
    dys, dyc = inp["dy"]["decoder_self_block"], inp["dy"]["decoder_cross_block"]
    g = torch.Generator().manual_seed(cs.SEED + 20)
    q, k, v, do = (torch.randn(b, l, d, generator=g).to(device, dtype) for _ in range(4))
    o, lse = (A.fused_attention(q, k, v, h, with_lse=True) if f32
              else (A.fused_attention(q, k, v, h), None))
    _, ssaved = DB.self_block_fwd(*sargs, h, cs.SEED + 1, cs.RATE, save=True)
    _, csaved = DB.cross_block_fwd(*cargs, h, cs.SEED + 2, cs.RATE, save=True)
    fns = {"K1": lambda: A.fused_attention(q, k, v, h),
           "K1b": lambda: A.attention_bwd(q, k, v, o, do, h, lse=lse),
           "K2": lambda: DB.self_block_fwd(*sargs, h)[0],
           "K2b": lambda: DB.self_block_bwd(x, ssaved, dys, h, cs.SEED + 1, cs.RATE),
           "K3": lambda: DB.cross_block_fwd(*cargs, h)[0],
           "K3b": lambda: DB.cross_block_bwd(xc, csaved, dyc, h, cs.SEED + 2, cs.RATE)}
    with torch.no_grad():
        return {name: cs.cuda_ms(fn, reps) for name, fn in fns.items()}


def one_tree(tree: str, dims, reps: int) -> dict:
    """This process's readings with ``tree``'s crog_tpu_torch:
    {"ptxas": [[entry, registers, spill]], "bf16 dh 64": {kernel: ms}, ...}."""
    sys.path[:0] = [os.path.abspath(tree), ROOT]
    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import cuda_build

    set_exact_fp32_matmul()
    cs = load_chip_smoke()
    reports = cuda_build.build_all(LIBS)
    got = {"ptxas": sorted({(entry, regs, spill) for text in reports.values()
                            for entry, regs, spill in cs.ptxas_entries(text) if "attn" in entry})}
    device = torch.device("cuda", 0)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for dh in dims:
            if A.head_dim(512, 512 // dh) != dh:
                continue  # this tree's kernels do not take dh
            got[f"{tag} dh {dh}"] = readings(cs, device, dtype, dh, reps)
            torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", help="an unpacked tree (default: this checkout)")
    ap.add_argument("--dims", nargs="+", type=int, default=[64], help="head dims (default 64)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20, help="timed calls per kernel")
    ap.add_argument("--one", metavar="DIR", help=argparse.SUPPRESS)  # a child's tree
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one, args.dims, args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_head_dims: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    smi = cs.smi_line()
    trees = args.tree or [ROOT]
    order = [t for r in range(args.rounds) for t in (trees if r % 2 == 0 else trees[::-1])]
    runs = []
    for r, tree in enumerate(order):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree, "--reps", str(args.reps),
             "--dims", *map(str, args.dims)],
            capture_output=True, text=True, check=False)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "run": r, "readings": got})
        for key, vals in got.items():
            if key != "ptxas":
                print(f"[head-dims] {tree} run {r} {key}: "
                      + ", ".join(f"{n} {vals[n]:.4f}" for n in KERNELS) + f" ms on {smi}",
                      flush=True)
    for tree in trees:
        got = next(x["readings"] for x in runs if x["tree"] == tree)
        for entry, regs, spill in got["ptxas"]:
            print(f"[head-dims] {tree} ptxas {entry}: {regs} registers, {spill} bytes spill "
                  f"stores", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "head_dims.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
