"""Phase 18's kernel and train-step readings on one card, sound and with
planted faults.

    python3 tools/torch_fp32_faults.py

Runs the fp32 kernels K1-f32..K4-f32 (csrc/attention_f32.cu,
decoder_blocks_f32.cu, ffn_f32.cu), K1b-f32..K4b-f32
(csrc/attention_bwd_f32.cu, decoder_blocks_bwd_f32.cu, ffn_bwd_f32.cu) and
the s2d stem's K6-f32 and K6b-f32 (csrc/s2dconv_f32.cu, at each of a train
step's launches) on chip_smoke.py's phase-18 inputs (the main path's shapes
at batch 24, full fp32 values) and prints each one's relative L2 error
against its fp32 twin
(TF32 off; of a backward, its worst gradient output): first as built
(every product 3xTF32), then with one product at a time formed by

- ``1xTF32``: one TF32 pass, each operand rounded to 10 mantissa bits;
- ``bf16-staged``: both operands rounded to bf16 first;

so that chip_smoke.F32_REL_L2 and F32_BWD_REL_L2 can be set between the
sound kernels and the faults.  Each fault is a build of its kernel's
library with ``-DCROG_F32_FAULT_PRODUCT`` and ``-DCROG_F32_FAULT_MODE``
(csrc/tf32.cuh), compiled into ``crog_tpu_torch/_build/faults/`` and
swapped in for the library the wrapper loads while the fault is read; no
file of the repo changes.  Beside each fault it prints phase 18's control:
the twin with the same product formed the same way
(``chip_smoke.fp32_twin_controls``).  Then phase 18's fp32 train step at
batch 2 (``chip_smoke.fp32_train_gap``'s model and batch) against the CPU:
sound, with each backward library's products planted one at a time, and
with the library's TF32 on (cuBLAS and cuDNN), for F32_TRAIN_GRAD_TOL; and
the same step on the fused s2d stem (phase 18 (e)), sound and with K6-f32's
and K6b-f32's products planted (the vision group's stem gradients come
from K6b-f32).
JSON to ``chiprun_out/fp32_faults.json``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel -> (library, {product: csrc/tf32.cuh F32Product}); the products
# are chip_smoke.F32_PRODUCTS' and F32_BWD_PRODUCTS'
_BLOCK = {"projections": 0, "QK^T": 1, "P.V": 2, "out-projection": 3}
_ATTN_BWD = {"QK^T": 6, "dV": 7, "dP": 8, "dQ": 9, "dK": 10}
_BLOCK_BWD = {"dO": 11, **_ATTN_BWD, "dX": 12, "dW": 13}
FAULT_PRODUCTS = {"attention_f32": ("attention_f32", {"QK^T": 1, "P.V": 2}),
                  "decoder_self_block_f32": ("decoder_blocks_f32", _BLOCK),
                  "decoder_cross_block_f32": ("decoder_blocks_f32", _BLOCK),
                  "ffn_f32": ("ffn_f32", {"hidden product": 4, "output product": 5})}
BWD_FAULT_PRODUCTS = {
    "attention_bwd_f32": ("attention_bwd_f32", _ATTN_BWD),
    "decoder_self_block_bwd_f32": ("decoder_blocks_bwd_f32", _BLOCK_BWD),
    "decoder_cross_block_bwd_f32": ("decoder_blocks_bwd_f32", _BLOCK_BWD),
    "ffn_bwd_f32": ("ffn_bwd_f32", {"recompute": 14, "dhn": 15, "dx": 16, "dW1": 19,
                                    "dW2": 20})}
# K6-f32 and K6b-f32, read at each launch of a train step (chip_smoke's
# s2dconv_cases); products chip_smoke.F32_S2D_PRODUCTS'
S2D_FAULT_PRODUCTS = {"s2dconv_f32": ("s2dconv_f32", {"patch product": 17}),
                      "s2dconv_wgrad_f32": ("s2dconv_f32", {"patch^T dy": 18})}
# the fp32 train step is read with every backward library's products
# planted (the forward's are phase 18's eval readings); on the fused stem
# with K6-f32's and K6b-f32's
STEP_FAULTS = dict(BWD_FAULT_PRODUCTS.values())
FUSED_STEP_FAULTS = {"s2dconv_f32": {"patch product": 17, "patch^T dy": 18}}
# fault builds at a time: one per core of the card's machine (48 at once
# could exhaust its memory)
PARALLEL_BUILDS = 8
MODES = {"1xTF32": 1, "bf16-staged": 2}  # csrc/tf32.cuh Products


def load_chip_smoke():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build_faults():
    """{(library, product id, mode id): loaded fault build}, one ``nvcc``
    per build, PARALLEL_BUILDS at a time."""
    from crog_tpu_torch.ops import cuda_build as CB

    out_dir = CB.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = sorted({(lib, pid, mid)
                   for lib, products in (*FAULT_PRODUCTS.values(), *BWD_FAULT_PRODUCTS.values(),
                                         *S2D_FAULT_PRODUCTS.values())
                   for pid in products.values() for mid in MODES.values()})
    t0 = time.perf_counter()
    done = []
    for i in range(0, len(keys), PARALLEL_BUILDS):
        procs = {}
        for lib, pid, mid in keys[i:i + PARALLEL_BUILDS]:
            path = out_dir / f"lib{lib}-p{pid}-m{mid}.so"
            cmd = [CB._nvcc(), *CB.NVCC_FLAGS, f"-DCROG_F32_FAULT_PRODUCT={pid}",
                   f"-DCROG_F32_FAULT_MODE={mid}", "-o", str(path),
                   str(CB.CSRC / f"{lib}.cu")]
            procs[lib, pid, mid] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True), path)
        for key, (proc, path) in procs.items():
            done.append((key, proc.communicate()[0], proc.returncode, path))
    libs, failed = {}, []
    for key, text, rc, path in done:
        if rc != 0:
            failed.append(f"--- nvcc {key}\n{text}")
            continue
        dll = ctypes.CDLL(str(path))
        for fn, argtypes in CB.SIGNATURES[key[0]].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        dll.crog_error_string.argtypes = [ctypes.c_int]
        dll.crog_error_string.restype = ctypes.c_char_p
        libs[key] = dll
    if failed:
        raise RuntimeError("fault build failed:\n" + "\n".join(failed))
    print(f"[fp32-faults] {len(libs)} fault builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return libs


@contextmanager
def planted(lib: str, dll):
    """The wrappers load ``dll`` for library ``lib`` within the block."""
    from crog_tpu_torch.ops import cuda_build as CB

    sound = CB.load(lib)
    CB._LIBS[lib] = dll
    try:
        yield
    finally:
        CB._LIBS[lib] = sound


def _kernel_readings(cs, cases, fault_products, libs, products):
    """(sound, faults, controls) of ``cases`` (name -> (kernel call, twin
    call, ...)) as ``readings`` documents them."""
    refs = {name: c[1]() for name, c in cases.items()}
    sound = {name: cs.worst_rel_l2(c[0](), refs[name]) for name, c in cases.items()}
    faults = {}
    for name, (lib, by_product) in fault_products.items():
        faults[name] = {}
        for product, pid in by_product.items():
            faults[name][product] = {}
            for fault, mid in MODES.items():
                with planted(lib, libs[lib, pid, mid]):
                    got = cases[name][0]()
                faults[name][product][fault] = cs.worst_rel_l2(got, refs[name])
    controls = cs.fp32_twin_controls({n: c[1] for n, c in cases.items()}, refs, products)
    return sound, faults, controls


def _gaps(cs, card, cpu, tag):
    """(loss rel, {group: grad rel-L2}, the stem's conv weights' rel-L2)."""
    rel, groups = cs.grad_gap(card, cpu, tag)
    return rel, groups, cs.stem_grad_gap(card, cpu)


def _planted_steps(cs, model, mini, cpu, libs, step_faults, tag):
    """{library: {product: {fault: _gaps}}} of the train step with each
    product of ``step_faults`` planted in turn."""
    out = {}
    for lib, by_product in step_faults.items():
        out[lib] = {}
        for product, pid in by_product.items():
            out[lib][product] = {}
            for fault, mid in MODES.items():
                with planted(lib, libs[lib, pid, mid]):
                    card = cs.train_grads(model, mini)
                out[lib][product][fault] = _gaps(
                    cs, card, cpu, f"[fp32-faults] {tag}{lib} {product} {fault}:")
    return out


def step_readings(cs, device, libs):
    """{"sound": (loss rel, {group: grad rel-L2}), "faults": {library:
    {product: {fault: the same}}}, "tf32": the same with the library's TF32
    on, "fused_sound" and "fused_faults": the same on the fused s2d stem
    (K6-f32 and K6b-f32 planted)} of phase 18's fp32 train step at batch 2
    against the CPU."""
    import torch

    cfg = cs._cfg(opts=("dropout", "0.0", "compute_dtype", "float32"))
    mini = cs.mini_batch(cs.prepared_train_batches()[0], cfg.input_size)
    cpu = cs.train_grads(cs.grad_model(cfg, torch.device("cpu"), torch.float32,
                                       fused_stem=False), mini)
    fused = cs.grad_model(cfg, device, fused_stem=True)
    out = {"fused_sound": _gaps(cs, cs.train_grads(fused, mini), cpu,
                                "[fp32-faults] fused stem, sound:"),
           "fused_faults": _planted_steps(cs, fused, mini, cpu, libs, FUSED_STEP_FAULTS,
                                          "fused stem, ")}
    del fused
    torch.cuda.empty_cache()
    model = cs.grad_model(cfg, device, fused_stem=False)
    out["sound"] = _gaps(cs, cs.train_grads(model, mini), cpu, "[fp32-faults] sound:")
    out["faults"] = _planted_steps(cs, model, mini, cpu, libs, STEP_FAULTS, "")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        out["tf32"] = _gaps(cs, cs.train_grads(model, mini), cpu,
                            "[fp32-faults] library TF32 on:")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


def readings(cs, device):
    """{"sound": {kernel: rel-L2}, "faults": {kernel: {product: {fault:
    rel-L2}}}, "controls": the same for the twins, "step": step_readings}
    at phase 18's inputs; a backward kernel's rel-L2 is its worst
    output's."""
    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    set_exact_fp32_matmul()
    inp = cs.kernel_inputs(device, dtype=torch.float32)
    libs = build_faults()
    out = {"sound": {}, "faults": {}, "controls": {}}
    with torch.no_grad():
        fwd = {name + "_f32": c for name, c in cs.kernel_cases(inp).items()}
        bwd = {name + "_f32": c for name, c in cs.f32_backward_cases(inp).items()}
        for cases, fault_products, products in ((fwd, FAULT_PRODUCTS, cs.F32_PRODUCTS),
                                                (bwd, BWD_FAULT_PRODUCTS,
                                                 cs.F32_BWD_PRODUCTS)):
            sound, faults, controls = _kernel_readings(cs, cases, fault_products, libs,
                                                       products)
            out["sound"].update(sound)
            out["faults"].update(faults)
            out["controls"].update(controls)
        for name, cases in cs.s2dconv_cases(device, dtype=torch.float32).items():
            n32 = name + "_f32"
            lib, by_product = S2D_FAULT_PRODUCTS[n32]
            at = {f"{n32} ({c[0]})": c[1:3] for c in cases}
            sound, faults, controls = _kernel_readings(
                cs, at, {k: (lib, by_product) for k in at}, libs,
                {k: cs.F32_S2D_PRODUCTS[n32] for k in at})
            out["sound"].update(sound)
            out["faults"].update(faults)
            out["controls"].update(controls)
            del at, cases
    del inp, fwd, bwd
    torch.cuda.empty_cache()
    out["step"] = step_readings(cs, device, libs)
    return out


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fp32_faults: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    smi = cs.smi_line()
    out = readings(cs, torch.device("cuda", 0))
    for name, rel in out["sound"].items():
        print(f"[fp32-faults] {name} as built: rel_l2 {rel:.4g}", flush=True)
        for product, by_fault in out["faults"][name].items():
            control = out["controls"][name][product]
            print(f"[fp32-faults] {name} {product}: "
                  + ", ".join(f"{f} {r:.4g} (twin control {control[f]:.4g})"
                              for f, r in by_fault.items()), flush=True)
    step = out["step"]
    grad_limits = cs.F32_TRAIN_GRAD_TOL
    over = lambda gap: [g for g, r in gap[1].items() if r > grad_limits[g]]  # noqa: E731
    print(f"[fp32-faults] train step (loss rel; groups over their F32_TRAIN_GRAD_TOL "
          f"{grad_limits}): sound {step['sound'][0]:.4g}, {over(step['sound'])}; library TF32 on "
          f"{step['tf32'][0]:.4g}, {over(step['tf32'])}", flush=True)
    for lib, by_product in step["faults"].items():
        print(f"[fp32-faults] train step, {lib} planted (groups over their limits): "
              + "; ".join(f"{p} " + ", ".join(f"{f} {over(g)}" for f, g in fr.items())
                          for p, fr in by_product.items()), flush=True)
    print(f"[fp32-faults] train step on the fused stem: sound {step['fused_sound'][0]:.4g}, "
          f"{over(step['fused_sound'])}, stem convs {step['fused_sound'][2]:.4g} (plain stem "
          f"{step['sound'][2]:.4g}, library TF32 on {step['tf32'][2]:.4g})", flush=True)
    for lib, by_product in step["fused_faults"].items():
        print(f"[fp32-faults] train step on the fused stem, {lib} planted (groups over their "
              "limits; the stem convs' rel_l2): " + "; ".join(
                  f"{p} " + ", ".join(f"{f} {over(g)} {g[2]:.4g}" for f, g in fr.items())
                  for p, fr in by_product.items()), flush=True)
    limits = {"F32_REL_L2": cs.F32_REL_L2, "F32_BWD_REL_L2": cs.F32_BWD_REL_L2,
              "F32_TRAIN_LOSS_TOL": cs.F32_TRAIN_LOSS_TOL,
              "F32_TRAIN_GRAD_TOL": cs.F32_TRAIN_GRAD_TOL}
    print(f"[fp32-faults] limits {limits}; {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fp32_faults.json"), "w") as fh:
        json.dump({**out, "limits": limits, "card": smi}, fh, indent=1)
    limit = lambda name: (cs.F32_REL_L2  # noqa: E731
                          if name in FAULT_PRODUCTS or name.startswith("s2dconv_f32 ")
                          else cs.F32_BWD_REL_L2)
    low = [(n, p, f) for n, bp in out["faults"].items() for p, fr in bp.items()
           for f, r in fr.items() if not r > limit(n)]
    loud = [n for n, r in out["sound"].items() if r > limit(n)]
    return 1 if low or loud else 0


if __name__ == "__main__":
    sys.exit(main())
