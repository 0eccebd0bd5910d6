"""The fp32 attention backward on one card, by device time, beside SDPA's.

    python3 tools/torch_attention_bwd_f32.py [--tree DIR ...] [--rounds N]

Times, on chip_smoke.py's phase-18 inputs (the main path's shapes at batch
24, full fp32 values), K1b-f32 at the CLIP attention pool (169 tokens, 32
heads, on K1-f32's output), K2b-f32 (676 tokens) and K3b-f32 (676 queries
over 17 masked text keys) on what K2-f32 and K3-f32 saved, each by the
profiler's device time per call and split into its attention kernels (the
kernels named ``attn_bwd_f32*``) and the rest; and SDPA's fp32 backward
(TF32 off) at the three attention shapes.  Each ``--tree DIR`` (an unpacked
other commit; default this checkout) is measured in a process of its own
with its own ``crog_tpu_torch`` (built into its own ``_build``) and this
checkout's ``chip_smoke.py`` for the inputs and the profiler, the trees in
turns (A B B A for two) over ``--rounds``, so that their readings come from
one card in one call.  Prints one ``[attn-bwd-f32]`` line per tree and
round, and a JSON summary to ``chiprun_out/attention_bwd_f32.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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


def calls(cs, inp):
    """name -> (the port's call, SDPA's fp32 backward at its attention
    shape): K1b-f32, K2b-f32, K3b-f32 on ``inp``.  A tree whose
    ``fused_attention`` takes no ``with_lse`` runs K1b-f32 without it."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB

    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    do = inp["dy"]["attention"]
    if "with_lse" in inspect.signature(A.fused_attention).parameters:
        o, lse = A.fused_attention(q, k, v, h, with_lse=True)
        k1b = lambda: A.attention_bwd(q, k, v, o, do, h, lse=lse)
    else:
        o = A.fused_attention(q, k, v, h)
        k1b = lambda: A.attention_bwd(q, k, v, o, do, h)
    sargs, cargs, _ = cs._args(inp)
    _, ssaved = DB.self_block_fwd(*sargs, cs.SEED + 1, cs.RATE, save=True)
    _, csaved = DB.cross_block_fwd(*cargs, cs.SEED + 2, cs.RATE, save=True)
    dys, dyc = inp["dy"]["decoder_self_block"], inp["dy"]["decoder_cross_block"]

    def sdpa(b, lq, lk, heads, mask=None):
        g = torch.Generator().manual_seed(cs.SEED + 14)
        rnd = lambda *s: torch.randn(*s, generator=g).to(q.device)
        leaves = [rnd(b, heads, n, 64).requires_grad_() for n in (lq, lk, lk)]
        am = None if mask is None else mask[:, None, None, :]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
        dout = rnd(b, heads, lq, 64)
        return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)

    b, l, _ = sargs[0].shape
    t = cargs[1].shape[1]
    mask = torch.where(cargs[4], A.NEG, 0.0).float()
    return {
        "K1b-f32": (k1b, sdpa(q.shape[0], q.shape[1], q.shape[1], h)),
        "K2b-f32": (lambda: DB.self_block_bwd(sargs[0], ssaved, dys, 8, cs.SEED + 1, cs.RATE),
                    sdpa(b, l, l, 8)),
        "K3b-f32": (lambda: DB.cross_block_bwd(cargs[0], csaved, dyc, 8, cs.SEED + 2, cs.RATE),
                    sdpa(b, l, t, 8, mask)),
    }


def one_tree(tree: str) -> dict:
    """This process's readings with ``tree``'s crog_tpu_torch: {name:
    {"device_ms", "attention_ms", "sdpa_ms"}}."""
    sys.path[:0] = [os.path.abspath(tree), ROOT]
    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    set_exact_fp32_matmul()
    cs = load_chip_smoke()
    inp = cs.kernel_inputs(torch.device("cuda", 0), dtype=torch.float32)
    out = {}
    with torch.no_grad():
        for name, (call, sdpa) in calls(cs, inp).items():
            dev, names, _ = cs.device_ms(call)
            attn = sum(ms for n, ms in names.items() if "attn_bwd_f32" in n)
            out[name] = {"device_ms": dev, "attention_ms": attn,
                         "sdpa_ms": cs.device_ms(sdpa)[0],
                         "kernels": {n: ms for n, ms in names.items() if "attn_bwd_f32" in n}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", nargs="*", default=[ROOT],
                    help="directories whose crog_tpu_torch is measured, in turns")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (two trees: A B B A per round)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_bwd_f32: no CUDA device", file=sys.stderr)
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
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "readings": got})
        print(f"[attn-bwd-f32] {tree}: " + "; ".join(
            f"{n} {r['device_ms']:.4f} ms, attention {r['attention_ms']:.4f} ("
            + ", ".join(f"{k.split('<')[0]} {ms:.4f}" for k, ms in r["kernels"].items())
            + f"), SDPA fp32 backward {r['sdpa_ms']:.4f}" for n, r in got.items())
            + f"; {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "attention_bwd_f32.json"), "w") as fh:
        json.dump({"card": smi, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
