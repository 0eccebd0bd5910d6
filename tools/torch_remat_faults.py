"""Phase 17's readings on one card with planted faults.

    python3 tools/torch_remat_faults.py [--faults stats-twice stats-detached no-recompute]

Runs chip_smoke.py's remat comparison (phase 17: one CROG train step of
crog_synthetic_r50.yaml's model at batch 24, dropout 0, seeded, with remat
off and then full and selective from the same weights, on one prepared
rawlb batch; each mode's ms per step and peak memory) once for each fault
and prints each run's readings (``chip_smoke.remat_readings``) and whether
``chip_smoke.check_remat`` fails it, so that REMAT_GRAD_TOL and
REMAT_STAT_TOL can be set between the sound run (phase 17 itself, whose
``off again`` is the card's own spread) and the faults:

- ``stats-twice``: the recompute of a checkpointed bottleneck updates the
  BatchNorm running statistics again (what ``torch.utils.checkpoint``
  around the blocks does on its own);
- ``stats-detached``: inside a checkpointed bottleneck the batch
  statistics are detached, so the gradient misses the terms through the
  mean and the variance;
- ``no-recompute``: ``remat`` is ignored and the blocks run as without it.

The faults are monkeypatches of ``crog_tpu_torch/models/clip.py`` in this
process, undone after each run; no file changes.  JSON to
``chiprun_out/remat_faults.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("stats-twice", "stats-detached", "no-recompute")


def load_chip_smoke():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` monkeypatched into ``models/clip.py`` for the block."""
    from crog_tpu_torch.models import clip

    moments = clip.batch_moments

    def detached(xf, blocks=1):
        m1, m2 = moments(xf, blocks)
        if clip._REMAT.frame is not None:
            return m1.detach(), m2.detach()
        return m1, m2

    name, value = {
        "stats-twice": ("_replaying", lambda: False),
        "stats-detached": ("batch_moments", detached),
        "no-recompute": ("checkpointed", lambda block, x, remat: block(x)),
    }[fault]
    saved = getattr(clip, name)
    setattr(clip, name, value)
    try:
        yield
    finally:
        setattr(clip, name, saved)


def _plain(readings):
    """Readings with the launches dropped (equal or not is printed)."""
    return {label: {k: v for k, v in r.items() if k != "launches"}
            for label, r in readings.items()}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--faults", nargs="+", default=list(FAULTS), choices=FAULTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_remat_faults: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    set_exact_fp32_matmul()
    smi = cs.smi_line()
    cuda_build.build_all()
    device = torch.device("cuda", 0)
    batch = cs.remat_batch()
    out = {"card": smi, "limits": {"REMAT_GRAD_TOL": cs.REMAT_GRAD_TOL,
                                   "REMAT_STAT_TOL": cs.REMAT_STAT_TOL}}
    for fault in args.faults:
        with planted(fault):
            readings = cs.remat_readings(device, batch, modes=("full", "selective"))
        torch.cuda.empty_cache()
        try:
            cs.check_remat(readings)
            verdict = "passes"
        except AssertionError as e:
            verdict = f"fails: {e}"
        off = readings["off"]
        for label in ("full", "selective"):
            r = readings[label]
            print(f"[faults] {fault} / {label}: loss rel {r['loss_rel']:.4g}, grad rel_l2 "
                  + ", ".join(f"{g} {x:.4g}" for g, x in r["grads"].items())
                  + f", running statistics gap {r['stats']:.4g}, num_batches_tracked equal "
                  f"{r['tracked']}, launches equal {r['launches'] == off['launches']}, peak "
                  f"{r['peak'] / 2**30:.2f} GiB (off {off['peak'] / 2**30:.2f}), "
                  f"{r['ms']:.2f} ms (off {off['ms']:.2f}) on {smi}", flush=True)
        print(f"[faults] {fault}: phase 17's check {verdict}", flush=True)
        out[fault] = {"verdict": verdict, "readings": _plain(readings)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "remat_faults.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
