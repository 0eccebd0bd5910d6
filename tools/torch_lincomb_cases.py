"""K5 and K5b (SSG's lincomb loss) by box case on one card.

    python3 tools/torch_lincomb_cases.py [--tree DIR] [--pixels FWD:BWD ...]

Runs chip_smoke.py's lincomb phase alone: each box case of
``lincomb_cases`` (the boxes, GT rows and GT maps that the first SSG step
hands the kernels on the raw wire at batch 32 and on the legacy wire at
batch 8; made-up boxes; every box over the whole map), both
loss kinds, each kernel against its twin twice for equal bits, timed with
its bounds and the share of points inside a box, then the profiler's
device time of each launch by kernel.  ``--tree DIR`` takes the package
``crog_tpu_torch`` from DIR (an unpacked other commit, built into its own
``_build``) and everything else from this checkout, so that two trees are
measured on the same inputs.  ``--pixels`` then times this checkout's
kernels at other region sizes (``ops/lincomb.py:FWD_PIXELS`` and
``BWD_PIXELS``), each held against its twin, by device time per SSG step
in each box case.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sweep(cs, device, settings):
    """Device ms per SSG step of K5 and K5b at each (fwd, bwd) region size."""
    import torch

    from crog_tpu_torch.ops import lincomb as LC

    for case in cs.LINCOMB_CASES:
        inputs = cs.lincomb_cases(device, case)
        refs = {kind: (LC.lincomb_task_sums_plain(*args, t, loss_kind=kind),
                       LC.lincomb_bwd_plain(*args, g, t, loss_kind=kind))
                for kind, (args, t, g) in inputs.items()}
        for fwd_px, bwd_px in settings:
            LC.FWD_PIXELS, LC.BWD_PIXELS = fwd_px, bwd_px
            fwd = bwd = 0.0
            for kind, (args, t, g) in inputs.items():
                ref_sums, ref_grads = refs[kind]
                got = (LC.lincomb_fwd(*args, t, loss_kind=kind),
                       *LC.lincomb_bwd(*args, g, t, loss_kind=kind))
                for o, r in zip(got, (ref_sums, *ref_grads)):
                    cs._compare(f"{kind} {case} at {fwd_px}:{bwd_px}", o, r,
                                cs.LINCOMB_REL_TOL * float(r.abs().max()))
                fwd += cs.device_ms(lambda: LC.lincomb_fwd(*args, t, loss_kind=kind))[0]
                bwd += cs.device_ms(lambda: LC.lincomb_bwd(*args, g, t, loss_kind=kind))[0]
            ph, pw = args[0].shape[1:3]
            fh, fw = LC.region_plan(ph, pw, fwd_px)
            bh, bw = LC.region_plan(ph, pw, bwd_px)
            print(f"[regions] {case}: K5 at {fwd_px} ({fh} x {fw}) {fwd:.4f} ms, K5b at "
                  f"{bwd_px} ({bh} x {bw}) {bwd:.4f} ms per SSG step (device time)",
                  flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="directory whose crog_tpu_torch is measured")
    ap.add_argument("--pixels", nargs="*", default=[],
                    help="region sizes FWD:BWD to time, e.g. 256:224 192:160")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.abspath(args.tree), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("torch_lincomb_cases: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    set_exact_fp32_matmul()
    device = torch.device("cuda", 0)
    print(f"[card] {cs.smi_line()}; crog_tpu_torch from {os.path.dirname(cuda_build.__file__)}",
          flush=True)
    cuda_build.load("lincomb")
    cs.check_lincomb(device)
    cs.print_device_times()
    if args.pixels:
        sweep(cs, device, [tuple(int(v) for v in p.split(":")) for p in args.pixels])
    return 0


if __name__ == "__main__":
    sys.exit(main())
