"""The fp32 kernels K1-f32..K4-f32, K2b-f32..K4b-f32, K6-f32 and K6b-f32 on
one card, product by product, beside fp32 cuBLAS, SDPA and cuDNN.

    python3 tools/torch_ffn_f32.py [--tree DIR ...] [--rounds N]
                                   [--kernels blocks ffn s2d blocks-bwd]

On chip_smoke.py's phase-18 inputs (the main path's B 24: M = 16224 rows,
D 512, F 2048, 8 heads over 676 tokens, 17 text tokens; the attention pool's
169 tokens of 32 heads; full fp32 values, dropout 0.1) runs
``chip_smoke.f32_block_products`` and ``chip_smoke.f32_ffn_products``:
K1-f32 (csrc/attention_f32.cu), K2-f32 and K3-f32
(csrc/decoder_blocks_f32.cu), K4-f32 (csrc/ffn_f32.cu) and K4b-f32
(csrc/ffn_bwd_f32.cu) by the profiler's device time per call, split by
launch order into their products (K2-f32's [q | k], v and out-projection;
K3-f32's q, k, v and out-projection; the attention steps; K4-f32's hidden
and y; K4b-f32's recompute, dhn, dx, dW1 and dW2), the weights' TF32
planes, the LayerNorm kernels and the fixed-order sums, beside fp32 cuBLAS
(TF32 off) at each product's shape and SDPA's fp32 forward at each
attention step's; and ``chip_smoke.f32_s2d_products``: the s2d stem's
K6-f32 and K6b-f32 (csrc/s2dconv_f32.cu) launch by launch at a train
step's shapes (conv2 and conv3 forward and dgrad, their wgrads; batch 24,
104 x 104 cells), each split into its product, wp's or dy's TF32 planes
and the fixed-order sums, beside cuDNN's fp32 conv of the blocked and of
the unblocked tensor; and ``chip_smoke.f32_block_bwd_products``: K2b-f32
and K3b-f32 (csrc/decoder_blocks_bwd_f32.cu) split into their products
(K2b-f32's dO, dX, dW q|k, dW v and dW out; K3b-f32's dO, dX, d(txt), dWq,
dWk, dWv and dW out), B's TF32 planes, the LayerNorm kernels, the
fixed-order sums and the attention step, each product beside fp32
torch.mm at its shape.  ``--kernels`` picks among the four groups (all by
default).  Each ``--tree DIR`` (an unpacked other commit; default
this checkout) is measured in a process of its own with its own
``crog_tpu_torch`` (built into its own ``_build``) and this checkout's
``chip_smoke.py`` for the inputs, the split and the profiler, the trees in
turns (A B B A for two) over ``--rounds``, so that their readings come from
one card in one call.  Prints chip_smoke's ``[fp32]`` lines and one
``[ffn-f32]`` line per tree and round, and a JSON summary to
``chiprun_out/ffn_f32.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


KERNEL_GROUPS = ("blocks", "ffn", "s2d", "blocks-bwd")


def one_tree(tree: str, kernels=KERNEL_GROUPS) -> dict:
    """This process's readings with ``tree``'s crog_tpu_torch: {"kernel
    product": [device ms, cuBLAS, SDPA or cuDNN device ms]}."""
    sys.path[:0] = [os.path.abspath(tree), ROOT]
    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    set_exact_fp32_matmul()
    cs = load_chip_smoke()
    device = torch.device("cuda", 0)
    got = {}
    with torch.no_grad():
        if {"blocks", "ffn", "blocks-bwd"} & set(kernels):
            inp = cs.kernel_inputs(device, dtype=torch.float32)
            if "blocks" in kernels:
                got.update(cs.f32_block_products(inp, cs.smi_line()))
            if "ffn" in kernels:
                got.update(cs.f32_ffn_products(inp, cs.smi_line()))
            if "blocks-bwd" in kernels:
                got.update(cs.f32_block_bwd_products(inp, cs.smi_line()))
            del inp
        if "s2d" in kernels:
            got.update(cs.f32_s2d_products(cs.s2dconv_cases(device, dtype=torch.float32),
                                           cs.smi_line()))
    return {f"{kid} {p}": list(v) for (kid, p), v in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", nargs="*", default=[ROOT],
                    help="directories whose crog_tpu_torch is measured, in turns")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (two trees: A B B A per round)")
    ap.add_argument("--kernels", nargs="+", choices=KERNEL_GROUPS, default=list(KERNEL_GROUPS),
                    help="the kernel groups measured: K1-f32..K3-f32 (blocks), K4-f32 and "
                         "K4b-f32 (ffn), K6-f32 and K6b-f32 (s2d), K2b-f32 and K3b-f32 "
                         "(blocks-bwd)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one, args.kernels)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_ffn_f32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    smi = cs.smi_line()
    trees = [os.path.abspath(t) for t in args.tree]
    order = []
    for _ in range(args.rounds):
        order += trees + trees[::-1] if len(trees) == 2 else trees
    runs = []
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              "--kernels", *args.kernels],
                             capture_output=True, text=True, timeout=900)
        print(res.stdout.rsplit("\n", 2)[0], flush=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "readings": got})
        shown = lambda t: "not measured" if t is None else f"{t:.4f}"  # noqa: E731
        print(f"[ffn-f32] {tree}: " + "; ".join(
            f"{k} {shown(ms)} ms (library {shown(lib)})" for k, (ms, lib) in got.items())
            + f"; {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ffn_f32.json"), "w") as fh:
        json.dump({"card": smi, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
