"""Where K4b's cluster kernel spends its time, phase by phase, on one card.

    python3 tools/torch_ffn_bwd_phases.py

Builds a copy of crog_tpu_torch/csrc/ffn_bwd.cu, with the FFN code it shares
with K4 (csrc/ffn.cuh) inlined, with a clock64() stamp (behind a CTA
barrier) at each phase boundary of ffn_bwd_hidden_kernel,
runs K4b at the main path's shape (M = 24 x 676, chip_smoke.py's seeded
inputs) with dropout 0.1 and 0, and prints the mean SM cycles per CTA of
each phase: the recompute's product, its epilogue, the first cluster
exchange, hn out, dhn's product (with the db2 sums), its epilogue, the
second exchange, dh, and the column sums and dh out.  The stamps add a
barrier per phase, so the total is a little above the kernel's own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# source -> (anchor line, stamp index before it, stamp index after it)
ANCHORS = {
    "ffn.cuh": (
        ("  gemm_mainloop<128, false, kGK>(acc, x, ", 0, 1),
        ("  {  // LN statistics of the whole rows", 2, None),
    ),
    "ffn_bwd.cu": (
        ("  // ---- hn = bf16(LN(h)) out", 3, None),
        ("  gemm_mainloop<128, false, kGK>(acc, dy, ", 4, None),
        ("  if (tid < 64) {", 5, None),
        ("  {  // the row means over the whole rows", 6, None),
        ("  // ---- dh = bf16(relu'", 7, None),
        ("  {  // column partials out", 8, None),
        ("  cluster_wait();  // no CTA leaves", 9, 10),
    ),
}
PHASES = ("recompute product", "recompute epilogue (h, row partials)",
          "cluster exchange 1 (LN statistics)", "hn out",
          "dhn product (+ db2 sums)", "dhn epilogue (m1/m2, dgamma/dbeta partials)",
          "cluster exchange 2 (m1, m2)", "dh (+ db1 partials)", "column sums and dh out",
          "cluster wait")
SLOTS = 2048


def _stamped(text: str, anchors, name: str) -> str:
    lines = text.split("\n")
    missing = [a[0] for a in anchors if not any(l.startswith(a[0]) for l in lines)]
    if missing:
        raise SystemExit(f"{name} no longer has the phase anchors {missing}")
    out, after = [], None
    for line in lines:
        hit = next((a for a in anchors if line.startswith(a[0])), None)
        if hit is not None:
            out.append(f"STAMP({hit[1]});")
            after = hit[2]
        out.append(line)
        if after is not None and line.split("//")[0].rstrip().endswith(";"):  # its end
            out.append(f"STAMP({after});")
            after = None
    return "\n".join(out)


def instrumented_source(csrc: str) -> str:
    read = lambda name: open(os.path.join(csrc, name)).read()
    head = (f'__device__ long long g_stamp[{SLOTS}][12];\n'
            '#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) '
            f'g_stamp[blockIdx.x % {SLOTS}][i] = clock64(); }} while (0)\n')
    include = '#include "ffn.cuh"\n'
    text = read("ffn_bwd.cu")
    if include not in text:
        raise SystemExit("ffn_bwd.cu no longer includes ffn.cuh")
    shared = _stamped(read("ffn.cuh"), ANCHORS["ffn.cuh"], "ffn.cuh")
    text = _stamped(text, ANCHORS["ffn_bwd.cu"], "ffn_bwd.cu")
    text = text.replace(include, head + shared + "\n", 1)
    return text + ('\nextern "C" int phase_stamps(void* out) {\n'
                   '  return (int)cudaMemcpyFromSymbol(out, g_stamp, '
                   f'sizeof(long long) * {SLOTS} * 12);\n}}\n')


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from crog_tpu_torch.ops import cuda_build, ffn as FF
    from crog_tpu_torch.ops.dropout import kernel_args

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "ffn_bwd_phases.cu"
    lib_path = cuda_build.BUILD_DIR / "libffn_bwd_phases.so"
    src.write_text(instrumented_source(str(cuda_build.CSRC)))
    build = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                            f"-I{cuda_build.CSRC}", "-o", str(lib_path), str(src)],
                           capture_output=True, text=True)
    if build.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{build.stdout}{build.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.crog_ffn_bwd.argtypes = cuda_build.SIGNATURES["ffn_bwd"]["crog_ffn_bwd"]
    lib.phase_stamps.argtypes = [ctypes.c_void_p]
    print(f"[phases] {cs.smi_line()}", flush=True)

    dev = torch.device("cuda")
    inp = cs.kernel_inputs(dev)
    f = inp["ffn"]
    x, w1, b1, g, be, w2, dy = (f["x"], f["w1"], f["b1"], f["g"], f["be"], f["w2"],
                                inp["dy"]["ffn"])
    m, d = x.shape
    nf = w1.shape[0]
    tiles = len(FF.bwd_schedule(m)[0])
    dx = torch.empty_like(x)
    dh = torch.empty(m, nf, dtype=torch.bfloat16, device=dev)
    hn = torch.empty_like(dh)
    rows = torch.empty(3, nf, device=dev)
    db2 = torch.empty(d, device=dev)
    parts = torch.empty(tiles, 3 * nf + d, device=dev)
    table = cuda_build.ptr_table(x, w1, b1, g, be, w2, dy, dx, dh, hn, rows, db2, parts,
                                 w1.t().contiguous())
    for rate in (0.1, 0.0):
        seed, thresh, scale = kernel_args(7, rate)
        for _ in range(3):
            rc = lib.crog_ffn_bwd(table, m, d, nf, seed, thresh, scale,
                                  cuda_build.stream_ptr(dev))
            if rc:
                raise RuntimeError(f"crog_ffn_bwd returned {rc}")
        torch.cuda.synchronize()
        st = np.zeros((SLOTS, 12), np.int64)
        lib.phase_stamps(st.ctypes.data)
        st = st[:8 * tiles]
        cycles = np.diff(st[:, :11], axis=1).mean(axis=0)
        print(f"[phases] dropout {rate}: mean SM cycles per CTA over {8 * tiles} CTAs, "
              f"total {float((st[:, 10] - st[:, 0]).mean()):.0f}", flush=True)
        for name, c in zip(PHASES, cycles):
            print(f"[phases]   {name:46s} {c:9.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
