"""SSG training supervisor for the port: on a fault, resume with the batch
halved (counterpart of tools/ssg_train_supervisor.py).

SSG trains for 5000 epochs (config/OCID-Grasp/ssg_r50.yaml), so a run must
outlive its faults.  On the card the faults that kill a run are
``torch.OutOfMemoryError`` and CUDA errors that leave the context unusable;
only a new process recovers from either.  So the supervisor sits outside
the trainer: it launches ``python -m crog_tpu_torch.train_ssg`` (or
``--script``) as a child with ``--device``, and when the child exits
nonzero it relaunches it from ``<output_folder>/<exp_name>/last_model``
(``crog_tpu_torch/engine/checkpoint.py:LAST``, written every epoch) with
the batch halved.  The batch never goes below ``--min-batch``; a child that
fails there is retried as it is until ``--max-restarts`` relaunches are
spent, and the run then ends with the child's exit code.

    python3 tools/torch_ssg_train_supervisor.py --config config/OCID-Grasp/ssg_r50.yaml \\
        [--device cuda] [--max-restarts 4] [--min-batch 1] [--script PATH] [--opts k v ...]

Every launch passes ``resume``: the trainer skips it while the checkpoint
does not exist, and after a fault it picks up the last finished epoch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_cmd(config, opts, batch_size, resume, device="cuda", script=None):
    """The child's command line: the caller's opts first, then the
    supervisor's batch_size and resume (later --opts keys win)."""
    head = [sys.executable, script] if script else [
        sys.executable, "-m", "crog_tpu_torch.train_ssg"]
    cmd = head + ["--config", config, "--device", device, "--opts", *opts,
                  "batch_size", str(batch_size)]
    if resume is not None:
        cmd += ["resume", resume]
    return cmd


def supervise(config: str, opts, script: str | None = None, max_restarts: int = 4,
              min_batch: int = 1, batch_size: int | None = None,
              resume_path: str | None = None, device: str = "cuda", log=None) -> int:
    """Run the trainer, halving batch_size and resuming on a nonzero exit.
    Returns the last child's exit code (0: a child ran to its end).  The
    children write to ``log`` (a file) when given, else to this process's
    output."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
    from crog_tpu_torch.engine.checkpoint import LAST

    cfg = load_cfg_from_cfg_file(config)
    if opts:
        cfg = merge_cfg_from_list(cfg, list(opts))
    bs = int(batch_size or cfg.batch_size)
    if resume_path is None:
        resume_path = os.path.join(cfg.output_folder, cfg.exp_name, LAST)
    restarts = 0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    while True:
        cmd = build_cmd(config, opts, bs, resume_path, device, script)
        print(f"[supervisor] launch (batch_size={bs}, restart {restarts}): "
              + " ".join(cmd), flush=True)
        t0 = time.perf_counter()
        rc = subprocess.call(cmd, env=env, stdout=log,
                             stderr=None if log is None else subprocess.STDOUT)
        if rc == 0:
            print("[supervisor] training completed", flush=True)
            return 0
        print(f"[supervisor] child exited rc={rc} after {time.perf_counter() - t0:.0f}s",
              flush=True)
        restarts += 1
        if restarts > max_restarts:
            print("[supervisor] restart budget exhausted", flush=True)
            return rc
        new_bs = max(min_batch, bs // 2)
        if new_bs < bs:
            bs = new_bs
            print(f"[supervisor] degrading batch_size -> {bs}", flush=True)
        else:
            print(f"[supervisor] retrying at min batch {bs} "
                  f"({max_restarts - restarts} restarts left)", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SSG training supervisor (PyTorch)")
    p.add_argument("--config", default="config/OCID-Grasp/ssg_r50.yaml")
    p.add_argument("--device", default="cuda")
    p.add_argument("--script", default=None,
                   help="a trainer script in place of python -m crog_tpu_torch.train_ssg")
    p.add_argument("--max-restarts", type=int, default=4)
    p.add_argument("--min-batch", type=int, default=1)
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    from crog_tpu_torch.parallel.dist import resolve_device

    resolve_device(a.device)  # no card: raise here, not in every child
    return supervise(a.config, a.opts, script=a.script, max_restarts=a.max_restarts,
                     min_batch=a.min_batch, device=a.device)


if __name__ == "__main__":
    sys.exit(main())
