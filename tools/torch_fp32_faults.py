"""Phase 18's kernel readings on one card, sound and with planted faults.

    python3 tools/torch_fp32_faults.py

Runs the fp32 kernels K1-f32..K4-f32 (csrc/attention_f32.cu,
decoder_blocks_f32.cu, ffn_f32.cu) on chip_smoke.py's phase-18 inputs (the
main path's shapes at batch 24, full fp32 values) and prints each one's
relative L2 error against its fp32 twin (TF32 off): first as built (every
product 3xTF32), then with one product at a time formed by

- ``1xTF32``: one TF32 pass, each operand rounded to 10 mantissa bits;
- ``bf16-staged``: both operands rounded to bf16 first;

so that chip_smoke.F32_REL_L2 can be set between the sound kernels and
the faults.  Each fault is a build of its kernel's library with
``-DCROG_F32_FAULT_PRODUCT`` and ``-DCROG_F32_FAULT_MODE`` (csrc/tf32.cuh),
compiled into ``crog_tpu_torch/_build/faults/`` and swapped in for the
library the wrapper loads while the fault is read; no file of the repo
changes.  Beside each fault it prints phase 18's control: the twin with
the same product formed the same way (``chip_smoke.fp32_twin_controls``).
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
# are chip_smoke.F32_PRODUCTS'
_BLOCK = {"projections": 0, "QK^T": 1, "P.V": 2, "out-projection": 3}
FAULT_PRODUCTS = {"attention_f32": ("attention_f32", {"QK^T": 1, "P.V": 2}),
                  "decoder_self_block_f32": ("decoder_blocks_f32", _BLOCK),
                  "decoder_cross_block_f32": ("decoder_blocks_f32", _BLOCK),
                  "ffn_f32": ("ffn_f32", {"hidden product": 4, "output product": 5})}
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
    per build, all started together."""
    from crog_tpu_torch.ops import cuda_build as CB

    out_dir = CB.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = sorted({(lib, pid, mid) for lib, products in FAULT_PRODUCTS.values()
                   for pid in products.values() for mid in MODES.values()})
    t0 = time.perf_counter()
    procs = {}
    for lib, pid, mid in keys:
        path = out_dir / f"lib{lib}-p{pid}-m{mid}.so"
        cmd = [CB._nvcc(), *CB.NVCC_FLAGS, f"-DCROG_F32_FAULT_PRODUCT={pid}",
               f"-DCROG_F32_FAULT_MODE={mid}", "-o", str(path), str(CB.CSRC / f"{lib}.cu")]
        procs[lib, pid, mid] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), path)
    libs, failed = {}, []
    for key, (proc, path) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
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


def readings(cs, device):
    """{"sound": {kernel: rel-L2}, "faults": {kernel: {product: {fault:
    rel-L2}}}, "controls": the same for the twins} at phase 18's inputs."""
    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul

    set_exact_fp32_matmul()
    inp = cs.kernel_inputs(device, dtype=torch.float32)
    cases = {name + "_f32": c for name, c in cs.kernel_cases(inp).items()}
    libs = build_faults()
    with torch.no_grad():
        refs = {name: plain() for name, (_, plain, *_) in cases.items()}
        sound = {name: cs.rel_l2(kern(), refs[name]) for name, (kern, *_) in cases.items()}
        faults = {}
        for name, (lib, products) in FAULT_PRODUCTS.items():
            faults[name] = {}
            for product, pid in products.items():
                faults[name][product] = {}
                for fault, mid in MODES.items():
                    with planted(lib, libs[lib, pid, mid]):
                        got = cases[name][0]()
                    faults[name][product][fault] = cs.rel_l2(got, refs[name])
        controls = cs.fp32_twin_controls({n: c[1] for n, c in cases.items()}, refs)
    return {"sound": sound, "faults": faults, "controls": controls}


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
    print(f"[fp32-faults] limit F32_REL_L2 {cs.F32_REL_L2}; {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fp32_faults.json"), "w") as fh:
        json.dump({**out, "limit": cs.F32_REL_L2, "card": smi}, fh, indent=1)
    low = [(n, p, f) for n, bp in out["faults"].items() for p, fr in bp.items()
           for f, r in fr.items() if not r > cs.F32_REL_L2]
    return 1 if low or max(out["sound"].values()) > cs.F32_REL_L2 else 0


if __name__ == "__main__":
    sys.exit(main())
