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

# C signature of every entry point, by library.  The decoder blocks' and
# the FFN's entry points, but the bf16 blocks' forward, take a table of
# device pointers (one host array of void*) as their first argument; its
# order is documented at each C function.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "attention": {
        "crog_attention_fwd": [_P] * 5 + [_I] * 5 + [_L] * 8 + [_F, _P],
        "crog_attention_fwd_attrs": [_I, _I, _P],
    },
    "attention_f32": {
        "crog_attention_f32_fwd": [_P] * 6 + [_I] * 5 + [_L] * 8 + [_F, _P],
    },
    "attention_bwd_f32": {
        "crog_attention_f32_bwd": [_P] * 12 + [_I] * 5 + [_L] * 16 + [_F, _P],
        "crog_attention_f32_dq_parts": [_I],
    },
    "attention_bwd": {
        "crog_attention_bwd": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
        "crog_attention_bwd_head": [_P] * 8 + [_I] * 4 + [_F, _P],
        "crog_attention_bwd_head_attrs": [_I, _P],
        "crog_attention_bwd_attrs": [_I, _I, _P],
        "crog_attention_bwd_head_takes": [_I, _I],
    },
    "decoder_blocks": {
        "crog_self_block_fwd": [_P] * 17 + [_I] * 6 + _DROP + [_P],
        "crog_cross_block_fwd": [_P] * 21 + [_I] * 7 + _DROP + [_P],
        "crog_decoder_fwd_attrs": [_I, _P],
    },
    "decoder_blocks_f32": {
        "crog_self_block_f32_fwd": [_P] + [_I] * 4 + _DROP + [_P],
        "crog_cross_block_f32_fwd": [_P] + [_I] * 5 + _DROP + [_P],
    },
    "decoder_blocks_bwd_f32": {
        "crog_self_block_f32_bwd": [_P] + [_I] * 4 + _DROP + [_P],
        "crog_cross_block_f32_bwd": [_P] + [_I] * 5 + _DROP + [_P],
    },
    "decoder_blocks_bwd": {
        "crog_self_block_bwd": [_P] + [_I] * 5 + _DROP + [_P],
        "crog_cross_block_bwd": [_P] + [_I] * 6 + _DROP + [_P],
        "crog_decoder_bwd_attrs": [_P],
    },
    "ffn": {
        "crog_ffn_fwd": [_P] + [_I] * 4 + _DROP + [_P],
        "crog_ffn_fwd_attrs": [_P],
    },
    "ffn_f32": {
        "crog_ffn_f32_fwd": [_P] + [_I] * 3 + _DROP + [_P],
    },
    "ffn_bwd_f32": {
        "crog_ffn_f32_bwd": [_P] + [_I] * 3 + _DROP + [_P],
    },
    "ffn_bwd": {
        "crog_ffn_bwd": [_P] + [_I] * 3 + _DROP + [_P],
        "crog_ffn_bwd_attrs": [_P],
    },
    "lincomb": {
        "crog_lincomb_fwd": [_P] * 8 + [_I] * 10 + [_P],
        "crog_lincomb_bwd": [_P] * 9 + [_I] * 10 + [_P],
        "crog_lincomb_attrs": [_I] * 5 + [_P],
    },
    "s2dconv": {
        "crog_s2dconv_fwd": [_P] * 3 + [_I] * 7 + [_P],
        "crog_s2dconv_fwd_attrs": [_I, _P],
        "crog_s2dconv_wgrad": [_P] * 4 + [_I] * 7 + [_P],
        "crog_s2dconv_wgrad_attrs": [_I, _I, _P],
    },
    "s2dconv_f32": {
        "crog_s2dconv_f32_fwd": [_P] * 4 + [_I] * 5 + [_P],
        "crog_s2dconv_f32_wgrad": [_P] * 5 + [_I] * 7 + [_P],
        "crog_s2dconv_f32_attrs": [_I, _P],
    },
}

# The library of each forward and backward kernel K1-K4(b) and K6/K6b, by
# the dtype of its operands: (bf16 build, fp32 build, id).
KERNELS = {
    "attention": ("attention", "attention_f32", "K1"),
    "attention_bwd": ("attention_bwd", "attention_bwd_f32", "K1b"),
    "decoder_self_block": ("decoder_blocks", "decoder_blocks_f32", "K2"),
    "decoder_self_block_bwd": ("decoder_blocks_bwd", "decoder_blocks_bwd_f32", "K2b"),
    "decoder_cross_block": ("decoder_blocks", "decoder_blocks_f32", "K3"),
    "decoder_cross_block_bwd": ("decoder_blocks_bwd", "decoder_blocks_bwd_f32", "K3b"),
    "ffn": ("ffn", "ffn_f32", "K4"),
    "ffn_bwd": ("ffn_bwd", "ffn_bwd_f32", "K4b"),
    "s2dconv": ("s2dconv", "s2dconv_f32", "K6"),
    "s2dconv_wgrad": ("s2dconv", "s2dconv_f32", "K6b"),
}


def library_for(kernel: str, dtype: torch.dtype) -> str:
    """The library whose build of ``kernel`` takes operands of ``dtype``:
    the bf16 kernels, or the fp32 ones (``compute_dtype: float32``).
    Raises ValueError for any other dtype."""
    bf16, f32, kid = KERNELS[kernel]
    if dtype == torch.bfloat16:
        return bf16
    if dtype == torch.float32:
        return f32
    raise ValueError(f"{kid} takes bf16 or fp32 operands, got {dtype}")


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
