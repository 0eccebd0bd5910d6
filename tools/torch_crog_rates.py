"""CROG's eval and train samples/s on prepared batches, for one tree or two
trees in alternation, on one card.

    python3 tools/torch_crog_rates.py DIR              # one run
    python3 tools/torch_crog_rates.py DIR_A DIR_B      # PAIRS pairs, A B B A ...

One run takes ``crog_tpu_torch`` and ``chip_smoke.py`` from DIR (an
unpacked commit, built into its own ``_build``) and runs that
``chip_smoke.py``'s phases 4, 8 and 5 in its order: the full-width CROG
config, 48 synthetic samples evaluated at batch 24 with the launch counts
checked, the batch-1 forward and the batch-24 eval step timed, then 4 train
steps and 4 timed (``train_path``).  It prints the script's own ``[time]``
lines and, last, one JSON object with the eval and train samples/s, the
forward's ms and the card (nvidia-smi's name and power limit).

With two trees, each run is a process of its own, the order alternating
A B, B A, ... so that drift in the card or the host falls on both trees
alike; the summary gives each tree's mean, least and largest figure, its
median and quartiles, and the pairs in which B read below A.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

PAIRS = 10
METRICS = ("train", "eval", "fwd_ms")


def load_chip_smoke(tree: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def one_run(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)  # the configs are read relative to the checkout
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch_crog_rates: no CUDA device")
    cs = load_chip_smoke(tree)
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    if not os.path.abspath(cuda_build.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"crog_tpu_torch did not come from {tree}")
    device = torch.device("cuda", 0)
    set_exact_fp32_matmul()
    smi = cs.smi_line()
    cuda_build.build_all()
    cfg, model, batches = cs.build_model_and_data(device)
    eval_step, _ = cs.main_path(device, cfg, model, batches)
    fwd_ms, eval_rate = cs.timings(model, eval_step, batches[0], cfg, smi)
    del model, eval_step
    torch.cuda.empty_cache()
    train_rate = cs.train_path(device, smi)[1]
    return {"tree": tree, "train": train_rate, "eval": eval_rate, "fwd_ms": fwd_ms,
            "card": smi}


def alternate(a: str, b: str) -> int:
    runs = {a: [], b: []}
    for i in range(PAIRS):
        for tree in ((a, b) if i % 2 == 0 else (b, a)):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), tree],
                               capture_output=True, text=True)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:], sep="\n", file=sys.stderr)
                return p.returncode
            res = json.loads(p.stdout.strip().splitlines()[-1])
            runs[tree].append(res)
            print(f"[pair {i}] {json.dumps(res)}", flush=True)
    for tree, tag in ((a, "A"), (b, "B")):
        for m in METRICS:
            v = [r[m] for r in runs[tree]]
            print(f"[rates] {tag} {m}: mean {sum(v) / len(v):.2f}, least {min(v):.2f}, "
                  f"largest {max(v):.2f} over {len(v)} runs ({tree}), median "
                  f"{statistics.median(v):.2f}, quartiles "
                  f"{' - '.join(f'{q:.2f}' for q in statistics.quantiles(v, n=4)[::2])}",
                  flush=True)
    for m in METRICS:
        below = sum(rb[m] < ra[m] for ra, rb in zip(runs[a], runs[b]))
        print(f"[rates] {m}: B below A in {below} of {PAIRS} pairs", flush=True)
    return 0


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if len(trees) == 1:
        print(json.dumps(one_run(trees[0])))
        return 0
    if len(trees) == 2:
        return alternate(*trees)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
