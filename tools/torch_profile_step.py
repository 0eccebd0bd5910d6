"""Device time of the port's steps by kernel, by category and by region
(counterpart of tools/profile_step.py).

    python3 tools/torch_profile_step.py [--model crog|ssg|ssg_eval|all] [--steps 3]
        [--batch N] [--fused-stem] [--device cuda]

Models, each full width with seeded random weights (chip_smoke.py's
builders): ``crog``, CROG train steps on one prepared synthetic batch of
config/OCID-VLG/crog_synthetic_r50.yaml (batch 24, the config's rawlb wire,
the s2d stem; ``--fused-stem`` runs its convs through K6/K6b); ``ssg``,
SSG train steps of config/OCID-Grasp/ssg_r50.yaml as written (batch 32, the
raw wire); ``ssg_eval``, SSG's eval forward and batched post-processing
(batch 8, the raw wire, into the frames' 480x640).  After one warm-up step
``--steps`` steps are traced with torch.profiler (the host and, on a card,
the card) and the Chrome trace is read back.

Printed per model: device time by kernel (top 25), by category (the groups
of tools/torch_profile_eval.py), then by region.  The regions are the
profiler ranges the port opens: the model's top modules (CROG: backbone,
neck, decoder, proj; SSG: backbone, fpn, proto_net, prediction_layers,
semantic_seg_conv), SSG's loss terms (lmatch, lcls, lbox, lins, lsem,
lgrasp) and ``opt_update``, the names of the JAX package's module scopes
and named scopes, plus ``unpack`` (the batch's copy and unpack on the
device) and this tool's ``post_processing``.  A device kernel goes to the
region of the host op that launched it (the launch's correlation id, then
the innermost region range around the launch on its thread); a kernel
launched in the backward pass goes to the region of its forward op,
found through the trace's ``fwdbwd`` flows (keyed by the autograd
sequence number; a trace without them leaves backward work in
``<other>``).  Every kernel is counted once, so the regions
and ``<other>`` add up to the trace's device time, which is printed beside
the profiler's own event total.  No bytes column: a torch trace carries no
bytes accessed.

``--device`` defaults to ``cuda`` and raises without a card; on ``cpu`` the
rollup counts host ops by self time in place of kernels.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_profile_eval import GROUPS, group_of  # noqa: E402

REGIONS = ("backbone", "neck", "decoder", "proj", "fpn", "proto_net",
           "prediction_layers", "semantic_seg_conv", "lmatch", "lcls", "lbox", "lins",
           "lsem", "lgrasp", "opt_update", "unpack", "post_processing")
OTHER = "<other>"
HOST_SLICES = ("cpu_op", "user_annotation")
LAUNCHES = ("cuda_runtime", "cuda_driver")
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# the groups of the port's hand-written kernels: GROUPS lists them first
HANDWRITTEN = tuple(g for g, _ in GROUPS[:[g for g, _ in GROUPS].index(
    "host-to-device copies")])
DEFAULT_BATCH = {"crog": 24, "ssg": 32, "ssg_eval": 8}


@dataclass
class Rollup:
    """Times in microseconds over the traced steps.  ``kernels[name]`` and
    ``regions[region][name]`` are [us, calls]; ``links`` counts the
    backward ops tied to their forward op ("flows") and the device work
    whose launch the trace lacks ("unlinked")."""
    total: float = 0.0
    device: bool = True  # False: host ops by self time (a trace without device work)
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    regions: Dict[str, Dict[str, List[float]]] = field(default_factory=dict)
    links: Dict[str, int] = field(default_factory=dict)

    def region_us(self) -> Dict[str, float]:
        return {r: sum(v[0] for v in ks.values()) for r, ks in self.regions.items()}


class _Thread:
    """One host thread's slices, sorted by start (longest first on a tie),
    each with the index of the slice around it."""

    def __init__(self, slices):
        self.slices = sorted(slices, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.slices]
        self.parent = []
        stack = []
        for i, (ts, end, *_rest) in enumerate(self.slices):
            while stack and self.slices[stack[-1]][1] <= ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t: float):
        """Indices of the slices around time t, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.slices[i][1] >= t:
                yield i
            i = self.parent[i]


def rollup(trace, regions=REGIONS) -> Rollup:
    """Device time by kernel and by region of a Chrome trace (the dict that
    ``export_chrome_trace`` writes, or its event list).  A trace with no
    device work counts its host ops instead, each by its self time."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    host = defaultdict(list)  # thread -> [(ts, end, name, cat, args)]
    launch = {}  # correlation -> (thread, ts)
    work = []  # (name, us, correlation)
    starts, ends = {}, {}
    for e in events:
        ph, cat = e.get("ph"), e.get("cat", "")
        thread = (e.get("pid"), e.get("tid"))
        if ph == "X":
            args = e.get("args") or {}
            if cat in HOST_SLICES:
                host[thread].append((e["ts"], e["ts"] + e.get("dur", 0.0), e.get("name", ""),
                                     cat, args))
            elif cat in LAUNCHES and "correlation" in args:
                launch[args["correlation"]] = (thread, e["ts"])
            elif cat in DEVICE_WORK:
                work.append((e.get("name", "?"), float(e.get("dur", 0.0)),
                             args.get("correlation")))
        elif cat == "fwdbwd" and ph in ("s", "f"):
            (starts if ph == "s" else ends)[e["id"]] = (thread, e["ts"])
    threads = {k: _Thread(v) for k, v in host.items()}

    # backward op (thread, start) -> its forward op's (thread, start)
    link = {ends[i]: starts[i] for i in ends if i in starts}
    links = {"flows": len(link), "unlinked": 0}
    # the engine's frame around a linked backward op (its gradient buffer
    # adds run there) goes where the op goes
    for thread, th in threads.items():
        for i, p in enumerate(th.parent):
            fwd = link.get((thread, th.slices[i][0]))
            if (fwd is not None and p >= 0
                    and th.slices[p][2].startswith("autograd::engine::evaluate_function")):
                link.setdefault((thread, th.slices[p][0]), fwd)

    memo = {}

    def region_at(thread, t, depth: int = 0) -> str:
        key = (thread, t)
        if key in memo:
            return memo[key]
        found = OTHER
        th = threads.get(thread)
        for i in (th.around(t) if th is not None else ()):
            ts, _, name, cat, _args = th.slices[i]
            if cat == "user_annotation" and name in regions:
                found = name
                break
            fwd = link.get((thread, ts))
            if fwd is not None and depth < 16:
                found = region_at(*fwd, depth + 1)
                break
        memo[key] = found
        return found

    out = Rollup(device=bool(work), links=links)

    def add(region: str, name: str, us: float):
        out.total += us
        k = out.kernels.setdefault(name, [0.0, 0])
        k[0] += us
        k[1] += 1
        r = out.regions.setdefault(region, {}).setdefault(name, [0.0, 0])
        r[0] += us
        r[1] += 1

    if work:
        for name, us, corr in work:
            at = launch.get(corr)
            if at is None:
                links["unlinked"] += 1
                add(OTHER, name, us)
            else:
                add(region_at(*at), name, us)
    else:  # host ops by self time
        for thread, th in threads.items():
            child = [0.0] * len(th.slices)
            for i, p in enumerate(th.parent):
                if p >= 0:
                    child[p] += th.slices[i][1] - th.slices[i][0]
            for i, (ts, end, name, cat, _args) in enumerate(th.slices):
                if cat == "cpu_op":
                    add(region_at(thread, ts), name, max(0.0, end - ts - child[i]))
    return out


def trace_steps(run, steps: int, device, warmup: int = 1):
    """Trace ``steps`` calls of ``run`` after ``warmup`` untraced ones:
    (the Chrome trace as a dict, the profiler events' device time in us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    for _ in range(warmup):
        run()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(steps):
            run()
        sync()
    events_us = sum(e.device_time for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0
                    and not getattr(e, "is_user_annotation", False))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        with open(out) as f:
            trace = json.load(f)
    return trace, events_us


def report(r: Rollup, steps: int, label: str, events_us: Optional[float] = None,
           card: str = "", top: int = 25) -> Dict[str, float]:
    """Print the three tables; returns ms per step by region."""
    per = lambda us: us / 1e3 / steps
    total = r.total or 1.0
    shown = (f", the profiler's events {per(events_us):.3f}" if events_us is not None
             else "")
    what = "device time" if r.device else "host op self time"
    print(f"[profile-step] {label}: {steps} steps, {what} {per(r.total):.3f} "
          f"ms/step{shown}; backward links {r.links}; {card}", flush=True)
    for name, (us, n) in sorted(r.kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {per(us):9.4f} ms/step  x{n // steps:5d}  {group_of(name):36s} "
              f"{name[:90]}")
    groups = defaultdict(float)
    for name, (us, _) in r.kernels.items():
        groups[group_of(name)] += us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[group] {label} {g:40s} {per(us):9.4f} ms/step ({100 * us / total:.1f}%)")
    regions = {reg: per(us) for reg, us in r.region_us().items()}
    for reg, ms in sorted(regions.items(), key=lambda kv: -kv[1]):
        by_group = defaultdict(float)
        for name, (us, _) in r.regions[reg].items():
            by_group[group_of(name)] += per(us)
        top = sorted(by_group.items(), key=lambda kv: -kv[1])[:4]
        hand = sorted({group_of(n) for n in handwritten_in(r, reg)})
        extra = f"; hand-written: {'; '.join(hand)}" if hand else ""
        print(f"[regions] {label} {reg:18s} {ms:9.4f} ms/step "
              f"({100 * ms * steps * 1e3 / total:.1f}%): "
              + ", ".join(f"{g} {v:.2f}" for g, v in top) + extra, flush=True)
    print(f"[regions] {label} sum {sum(regions.values()):.4f} ms/step of {per(r.total):.4f} "
          f"ms/step of {what}{shown}; {card}", flush=True)
    return regions


def handwritten_in(r: Rollup, region: str) -> Dict[str, Tuple[float, int]]:
    """The hand-written kernels in ``region``: name -> (us, calls)."""
    return {n: tuple(v) for n, v in r.regions.get(region, {}).items()
            if group_of(n) in HANDWRITTEN}


def ssg_eval_step(cs, dev, batch: int):
    """SSG's eval forward and batched post-processing over one prepared
    synthetic batch of ``batch`` frames on the config's raw wire."""
    import torch
    from torch.profiler import record_function

    from crog_tpu_torch.engine.ssg_engine import make_ssg_eval_fwd
    from crog_tpu_torch.train_ssg import post_processing

    cfg = cs._ssg_cfg(("batch_size_val", str(batch)))
    data, ori_hw = cs._ssg_data(cfg, cfg.val_split, batch, batch, False)
    model = cs._ssg_model(cfg, dev).eval()
    post = post_processing(cfg, model.anchors(), batch > 1, ori_hw)
    fwd = make_ssg_eval_fwd(model, dev)

    @torch.no_grad()
    def run():
        out, _ = fwd(data[0])
        with record_function("post_processing"):
            return post(out)

    return run


def build(cs, which: str, dev, batch: int, fused_stem: bool):
    from tools import torch_profile_eval as pe

    if which == "crog":
        return pe.train_step(cs, dev, batch, "rawlb", fused_stem)
    if which == "ssg":
        return pe.ssg_train_step(cs, dev, batch, "raw")[0]
    return ssg_eval_step(cs, dev, batch)


def main(argv=None) -> int:
    import chip_smoke as cs
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.parallel.dist import resolve_device
    from tools.torch_latency import device_name

    p = argparse.ArgumentParser(description="device time by kernel, category and region")
    p.add_argument("--model", default="all", choices=("crog", "ssg", "ssg_eval", "all"))
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch", type=int, default=None,
                   help="default 24 (crog), 32 (ssg), 8 (ssg_eval)")
    p.add_argument("--fused-stem", action="store_true",
                   help="CROG's s2d stem convs through K6/K6b")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    set_exact_fp32_matmul()
    card = device_name(dev)
    for which in (("crog", "ssg", "ssg_eval") if a.model == "all" else (a.model,)):
        batch = a.batch or DEFAULT_BATCH[which]
        run = build(cs, which, dev, batch, a.fused_stem)
        trace, events_us = trace_steps(run, a.steps, dev)
        r = rollup(trace)
        label = f"{which} batch {batch}"
        regions = report(r, a.steps, label, events_us if dev.type == "cuda" else None, card)
        print(json.dumps({"model": which, "batch": batch, "card": card, "steps": a.steps,
                          "device_ms_per_step": r.total / 1e3 / a.steps,
                          "regions_ms_per_step": regions, "links": r.links}), flush=True)
        del run
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
