"""Build and load the hand-written CUDA kernels.

Each ``crog_tpu_torch/csrc/<name>.cu`` in ``SIGNATURES`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Libraries go to ``crog_tpu_torch/_build/`` under a name that
carries a digest of every source, so an edited source is never served by a
stale build.  ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU test suite imports every module
of the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_DROP = [_U, _U, _F]  # dropout seed, uint32 threshold (0: off), keep scale

# C signature of every entry point, by library.  The backward entry points
# take a table of device pointers (one host array of void*) as their first
# argument; its order is documented at each C function.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "attention": {
        "crog_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I]
        + [_L] * 8 + [_F, _P],
    },
    "attention_bwd": {
        "crog_attention_bwd": [_P] * 9 + [_I] * 3 + [_F, _I, _P],
    },
    "decoder_blocks": {
        "crog_self_block_fwd": [_P] * 17 + [_I] * 4 + _DROP + [_P],
        "crog_cross_block_fwd": [_P] * 21 + [_I] * 5 + _DROP + [_P],
    },
    "decoder_blocks_bwd": {
        "crog_self_block_bwd": [_P] + [_I] * 5 + _DROP + [_P],
        "crog_cross_block_bwd": [_P] + [_I] * 6 + _DROP + [_P],
    },
    "ffn": {
        "crog_ffn_fwd": [_P] * 8 + [_I] * 3 + _DROP + [_P],
    },
    "ffn_bwd": {
        "crog_ffn_bwd": [_P] + [_I] * 3 + _DROP + [_P],
    },
    "lincomb": {
        "crog_lincomb_fwd": [_P] * 7 + [_I] * 9 + [_P],
        "crog_lincomb_bwd": [_P] * 9 + [_I] * 9 + [_P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:12]


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together.  Returns each library's ptxas report (registers,
    shared memory, spills); raises with the compiler's output on failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = lib_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        log.write_text(text)
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.crog_error_string.argtypes = [ctypes.c_int]
        lib.crog_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.crog_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr_table(*tensors) -> ctypes.c_void_p:
    """A host array of the tensors' device pointers, as the backward entry
    points take it; the array lives as long as the returned pointer."""
    table = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    ptr = ctypes.cast(table, ctypes.c_void_p)
    ptr._keep = table
    return ptr


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` (and ``shape``,
    contiguity, 16-byte alignment) that a kernel can take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
