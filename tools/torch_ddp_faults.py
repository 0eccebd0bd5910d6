"""Phase 13a's readings on one card, sound and with planted faults.

    python3 tools/torch_ddp_faults.py [--faults bn-local bn-local-grad ssg-local-count]

Runs chip_smoke.py's two-ranks-against-one-process comparison of data
parallelism (phase 13a: 2 CROG steps at 24 and 2 SSG steps at 32, on two
gloo ranks of half the batch on this card) once on the sound code and
once for each fault, planted in the rank processes only, and prints each
run's readings (``chip_smoke.ddp_readings``: the first step's worst loss
term gap, BatchNorm batch-statistics rel-L2 and per-group gradient
rel-L2, and the running statistics after the last step; and
``ssg_loss_readings``: SSG's loss alone in fp32 on seeded outputs), so
that the phase's limits can be set between the sound run and the faults:

- ``bn-local``: ``models/clip.py:batch_moments`` sums without the
  all-reduce, so each rank normalizes by its own rows' statistics;
- ``bn-local-grad``: the all-reduce of those sums has no backward, so the
  statistics are global and ``dx`` misses the other ranks' terms;
- ``ssg-local-count``: ``models/ssg_loss.py`` divides each rank's losses
  by its own positive count (the per-rank normalization of a plain DDP
  recipe) instead of the global count over ``world``.

The faults are monkeypatches in the rank processes (``--worker``); no
file changes.  One process at world 1 runs the references, as the phase
does.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("bn-local", "bn-local-grad", "ssg-local-count")


def load_chip_smoke():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def plant(fault: str) -> None:
    """Monkeypatch ``fault`` into this process's port."""
    import torch

    from crog_tpu_torch.models import clip, ssg_loss
    from crog_tpu_torch.parallel import dist

    def forward_only(x):
        total = x.detach().clone()
        torch.distributed.all_reduce(total)
        return x + (total - x.detach())

    if fault == "bn-local":
        clip.all_reduce_sum = lambda x: x
    elif fault == "bn-local-grad":
        clip.all_reduce_sum = forward_only
    elif fault == "ssg-local-count":
        # ssg_losses divides by all_reduce_sum(count) / world: the local
        # count once this returns count * world
        proxy = types.SimpleNamespace(**{k: getattr(dist, k) for k in dir(dist)
                                         if not k.startswith("__")})
        proxy.all_reduce_sum = lambda x: x * dist.world()
        ssg_loss.dist = proxy
    elif fault != "sound":
        raise ValueError(fault)


def worker(workdir: str, fault: str) -> int:
    cs = load_chip_smoke()
    plant(fault)
    return cs.ddp_worker(workdir)


def batches(cs):
    """Phase 13a's batches: phase 5's first rawlb batches at BATCH and
    phase 9's first raw SSG batches at SSG_BATCH."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    cfg = cs._cfg(2 * cs.BATCH, cs.BATCH)
    crog = list(DataLoader(build_dataset(cfg, cfg.train_split), cs.BATCH, shuffle=True,
                           drop_last=True, seed=cs.SEED))
    ssg = cs.ssg_raw_batches()
    return ([crog[i % len(crog)] for i in range(cs.DDP_STEPS)],
            [ssg[i % len(ssg)] for i in range(cs.DDP_STEPS)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--faults", nargs="*", default=list(FAULTS), choices=FAULTS)
    ap.add_argument("--fault", default="sound", help="a rank's fault (with --worker)")
    ap.add_argument("--worker", metavar="DIR",
                    help="one rank of a run (started by this script)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.fault)
    import torch

    if not torch.cuda.is_available():
        print("torch_ddp_faults: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    set_exact_fp32_matmul()
    device = torch.device("cuda", 0)
    smi = cs.smi_line()
    cuda_build.build_all()
    crog, ssg = batches(cs)
    out = []
    with tempfile.TemporaryDirectory(prefix="ddp_faults_") as workdir:
        ref = cs.ddp_reference(device, crog, ssg, workdir)
        for fault in ["sound", *args.faults]:
            # each rank runs: python <this> --fault FAULT --worker DIR
            ranks = cs._run_ranks(workdir, [os.path.abspath(__file__), "--fault", fault,
                                            "--worker"])
            for model in ("crog", "ssg"):
                r0, r1 = (r[model] for r in ranks)
                r = cs.ddp_readings(ref[model], r0, cs.DDP_KEYS[model], *cs.DDP_GROUPS[model])
                r.update(fault=fault, model=model, ranks_equal=r0["digest"] == r1["digest"])
                out.append(r)
                print(f"[ddp-faults] {fault} {model}: " + json.dumps(r), flush=True)
            r = cs.ssg_loss_readings(ref["ssg_loss"], [x["ssg_loss"] for x in ranks])
            r.update(fault=fault, model="ssg_loss")
            out.append(r)
            print(f"[ddp-faults] {fault} ssg_loss: " + json.dumps(r), flush=True)
    print(f"[ddp-faults] on {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ddp_faults.json"), "w") as f:
        json.dump({"smi": smi, "runs": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
