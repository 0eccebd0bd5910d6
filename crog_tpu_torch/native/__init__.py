"""The port's host ops in C++ (``hostops.cpp``), bound with ctypes: the
readers' cv2-parity affine warp, and the even-odd polygon fill and separable
gaussian blur of the grasp maps.  Counterpart of crog_tpu/native.

``g++`` builds the library at first use into ``crog_tpu_torch/_build/``
under a name that carries a digest of the source, the flags (those of
crog_tpu/native: ``-ffp-contract=off`` and no ``-ffast-math`` keep the
warp's arithmetic cv2's, see the source's header) and the host's CPU,
which ``-march=native`` compiles for.  The compiler writes a
file of its process's own that is renamed into place when complete, so
the test workers and the loader's worker processes that reach the build at
once never load half a library.  A failed build or load raises with the
compiler's output: unlike crog_tpu/native, nothing falls back to numpy on
the readers' path.  The numpy twins (``ops/affine.py:warp_affine_np``,
``ops/filters.py:gaussian_blur_np``, ``ops/rects.py:polygon_indices``) are
the tests' references.

The library is loaded with ``ctypes.CDLL``, which releases the interpreter
lock for each call, so the loader's threads warp beside the thread that
launches the step's kernels.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]
INTERPOLATIONS = {"nearest": 0, "linear": 1, "cubic": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
SIGNATURES = {
    "warp_affine_u8": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "warp_affine_f32": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    "polygon_fill": [_P, _P, _I, _P, _I, _I, _I, _I, _D],
    "gaussian_blur_f64": [_P, _I, _I, _D, _P],
}

_LOCK = threading.Lock()
_LIB = None


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: this host's CPU model and
    flags (the first processor's lines of /proc/cpuinfo), so that a build
    directory shared by hosts of other CPUs never serves one of them a
    library it cannot run."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
    except OSError:
        return platform.processor().encode()
    return b"\n".join(lines[:2])


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path: its name carries a digest of the source, the
    flags and the host's CPU."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu())
    return Path(build_dir) / f"libhostops-{h.hexdigest()[:12]}.so"


def build(cxx: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``hostops.cpp`` with ``cxx`` unless its library is there;
    returns the library's path.  Raises RuntimeError with the command and
    the compiler's output if the build fails."""
    out = lib_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"host ops build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host ops build failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"host ops library {path} does not load: {e}") from e
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            _LIB = lib
    return _LIB


def warp_affine(img: np.ndarray, mat, out_size, interpolation: str = "linear",
                border_value=0.0) -> np.ndarray:
    """``dst(x, y) = src(M^-1 (x, y, 1))`` with cv2.warpAffine's arithmetic
    (``ops/affine.py:warp_affine_np`` is the numpy twin): ``img`` HW or HWC
    uint8 or float32, ``mat`` 2x3, ``out_size`` (width, height),
    ``interpolation`` nearest, linear or cubic, a constant border of
    ``border_value`` (a scalar or one value per channel)."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}; expected one of "
                         f"{tuple(INTERPOLATIONS)}")
    if img.dtype not in (np.uint8, np.float32) or img.ndim not in (2, 3):
        raise ValueError(f"warp_affine takes HW or HWC uint8 or float32, got "
                         f"{img.dtype} {img.shape}")
    lib = load()
    out_w, out_h = (int(s) for s in out_size)
    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[..., None] if squeeze else img)
    h, w, c = src.shape
    border = np.ascontiguousarray(
        np.broadcast_to(np.asarray(border_value, np.float64), (c,)))
    m = np.ascontiguousarray(np.asarray(mat, np.float64).reshape(6))
    out = np.empty((out_h, out_w, c), src.dtype)
    fn = lib.warp_affine_u8 if src.dtype == np.uint8 else lib.warp_affine_f32
    fn(src.ctypes.data, h, w, c, m.ctypes.data, out_h, out_w,
       INTERPOLATIONS[interpolation], border.ctypes.data, out.ctypes.data)
    return out[..., 0] if squeeze else out


def polygon_fill(canvas: np.ndarray, vr, vc, value: float) -> None:
    """Write ``value`` into the float64 ``canvas`` [H, W] in place at the
    pixels inside the polygon of vertices (``vr``, ``vc``) by the even-odd
    rule, indexed ``canvas[cc, rr]`` as the reference rasterizes the grasp
    maps; pixels off the canvas are skipped (``ops/rects.py:
    polygon_indices`` with that clip is the numpy twin)."""
    if canvas.dtype != np.float64 or canvas.ndim != 2 or not canvas.flags.c_contiguous:
        raise ValueError("polygon_fill takes a C-contiguous float64 [H, W] canvas")
    vr = np.ascontiguousarray(vr, np.float64)
    vc = np.ascontiguousarray(vc, np.float64)
    if vr.ndim != 1 or vr.shape != vc.shape or not len(vr):
        raise ValueError(f"polygon_fill takes equal 1-D vertex arrays, got {vr.shape} "
                         f"and {vc.shape}")
    load().polygon_fill(vr.ctypes.data, vc.ctypes.data, len(vr), canvas.ctypes.data,
                        canvas.shape[0], canvas.shape[1], 0, 0, float(value))


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur of a 2-D array in float64 with edge
    ('nearest') padding, truncated at 4 sigma (``ops/filters.py:
    gaussian_blur_np`` is the scipy twin)."""
    src = np.ascontiguousarray(img, np.float64)
    if src.ndim != 2 or not sigma > 0:
        raise ValueError(f"gaussian_blur takes a 2-D array and sigma > 0, got "
                         f"{src.shape} and {sigma}")
    out = np.empty_like(src)
    load().gaussian_blur_f64(src.ctypes.data, src.shape[0], src.shape[1], float(sigma),
                             out.ctypes.data)
    return out
