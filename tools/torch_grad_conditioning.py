"""How far one CROG train step's gradients move between bf16 and fp32
compute, with train-mode BatchNorm and with BatchNorm on running
statistics, on the CPU (no card needed).

    python3 tools/torch_grad_conditioning.py [--size 128]

Full-width CROG (config/OCID-VLG/crog_synthetic_r50.yaml, seeded random
weights as in chip_smoke.py) at batch 2, dropout 0, input ``--size``: the
same plain PyTorch code in bf16 and in fp32 on the same two synthetic train
samples.  Prints the loss's relative error and each parameter group's
gradient relative L2 for both BatchNorm settings, and one JSON line.  This
is why chip_smoke.py's card-vs-CPU train-step check runs BatchNorm on its
running statistics: at batch 2 train-mode BatchNorm leaves nothing to hold
a kernel to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=128)
    a = p.parse_args()
    size = ("input_size", str(a.size))
    cfg = cs._cfg(4, 2, size)
    batch = next(iter(DataLoader(build_dataset(cfg, cfg.train_split), 4)))
    result = {}
    for running in (False, True):
        label = "running-stat BN" if running else "train-mode BN"
        print(f"[conditioning] {label}, bf16 vs fp32 on the CPU, {a.size}^2, batch 2",
              flush=True)
        rel, groups = cs.train_step_gap(batch, torch.device("cpu"), running, size)
        result[label] = {"loss_rel": rel, "grad_rel_l2": groups}
    print(json.dumps({"size": a.size, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
