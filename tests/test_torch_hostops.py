"""The port's native host ops (crog_tpu_torch/native) against the JAX
package's (crog_tpu/native), against the vendored cv2 goldens and against
the port's numpy twins; a failed build raises; the readers' loader on
threads and on one thread gives equal host batches with the native path on.

Tolerances: the two libraries compile the same arithmetic with the same
flags on the same host, so every output is equal bit for bit.  Against cv2,
the tolerances of tests/test_cv2_goldens.py.  Against the numpy twins:
uint8 warps exact (nearest and linear by construction; cubic on these
inputs, the twin's emulated fmaf rounding twice only in vanishing corner
cases), float32 warps within one float32 step at 255 (2**-16, the twin's
f64-emulated fmaf against the true one), the polygon fill exact (the same
even-odd test on integer vertices), the blur within 1e-9 of scipy's (as
tests/test_cv2_goldens.py holds crog_tpu's).
"""

import time

import numpy as np
import pytest

from crog_tpu import native as jax_native
from crog_tpu_torch import native
from crog_tpu_torch.data.loader import DataLoader
from crog_tpu_torch.data.ocid_vlg import OCIDVLGDataset, wire_kwargs
from crog_tpu_torch.ops.affine import letterbox_transform, warp_affine_np
from crog_tpu_torch.ops.filters import gaussian_blur_np
from crog_tpu_torch.ops.rects import box_points, polygon_indices
from tests.ocid_fixture import build_ocid_tree
from tests.test_cv2_goldens import G, WARP_CASES, _check_warp

F32_TOL = 2.0**-16 * 255


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """crog_tpu/native writes its library in place, so a test worker that
    loads it while another worker's g++ still writes it gets none (and
    would fall back to numpy for good): wait for the writer, load again."""
    for _ in range(60):
        if jax_native.get_lib() is not None:
            return
        jax_native._TRIED = False
        time.sleep(1.0)
    pytest.fail("crog_tpu/native's library does not build or load")


def _rotated(h, w, out, angle, scale):
    """A 2x3 matrix rotating about the frame's center by ``angle`` degrees
    and scaling by ``scale`` into an ``out`` square."""
    a = np.deg2rad(angle)
    c, s = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = w / 2.0, h / 2.0
    return np.array([[c, -s, out / 2.0 - c * cx + s * cy],
                     [s, c, out / 2.0 - s * cx - c * cy]], np.float64)


def _src(channels, dtype, seed, h=60, w=80):
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape, dtype=np.float32) * 255).astype(np.float32)


def _mat(kind, h=60, w=80, out=48):
    if kind == "letterbox":
        return letterbox_transform((h, w), (out, out))[0]
    return _rotated(h, w, out, 23.0, 0.7)


WARPS = [(dt, interp, ch, kind)
         for dt in (np.uint8, np.float32)
         for interp in ("nearest", "linear", "cubic")
         for ch in (1, 3, 4)
         for kind in ("letterbox", "rotated")]


@pytest.mark.parametrize("dtype,interp,channels,kind", WARPS,
                         ids=[f"{np.dtype(d).name}-{i}-{c}ch-{k}" for d, i, c, k in WARPS])
def test_warp_equals_jax_native_and_numpy_twin(dtype, interp, channels, kind):
    src = _src(channels, dtype, seed=channels)
    mat = _mat(kind)
    border = (12.5, 200.0, 7.0, 99.0)[:channels] if channels > 1 else 31.0
    got = native.warp_affine(src, mat, (48, 48), interp, border)
    ref = jax_native.warp_affine(src, mat, (48, 48), interp, border)
    assert got.dtype == src.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    twin = warp_affine_np(src, mat, (48, 48), interp, border)
    if dtype == np.uint8:
        np.testing.assert_array_equal(got, twin)
    else:
        np.testing.assert_allclose(got, twin, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("name", WARP_CASES)
def test_native_warp_matches_cv2_goldens(name):
    border = G[f"{name}_border"]
    mode = str(G[f"{name}_mode"])
    ow, oh = G[f"{name}_meta"]
    got = native.warp_affine(G[f"{name}_src"], G[f"{name}_mat"], (int(ow), int(oh)), mode,
                             border if border.size > 1 else float(border[0]))
    _check_warp(got, G[f"{name}_ref"], mode)


def test_readers_letterbox_equals_numpy_twin():
    """The rawlb letterbox of a full 480x640 frame to 416^2 with the CLIP
    mean border, as ``data/ocid_vlg.py:preprocess`` calls it."""
    img = _src(3, np.uint8, seed=9, h=480, w=640)
    mat = letterbox_transform((480, 640), (416, 416))[0]
    border = (122.77, 116.75, 104.09)
    got = native.warp_affine(img, mat, (416, 416), "cubic", border)
    np.testing.assert_array_equal(got, warp_affine_np(img, mat, (416, 416), "cubic", border))
    np.testing.assert_array_equal(
        got, jax_native.warp_affine(img, mat, (416, 416), "cubic", border))


def _boxes(seed, n=6, h=48, w=64):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rect = ((rng.uniform(-5, w + 5), rng.uniform(-5, h + 5)),
                (rng.uniform(2, 30), rng.uniform(2, 20)), rng.uniform(-180, 180))
        yield box_points(rect).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygon_fill_equals_jax_native_and_numpy_twin(seed):
    """Rotated rects, some over the canvas edge, written [cc, rr] with the
    x corners as the first polygon axis, as ``generate_masks`` fills them."""
    h, w = 48, 64
    got = np.zeros((h, w))
    ref = np.zeros((h, w))
    twin = np.zeros((h, w))
    for i, box in enumerate(_boxes(seed)):
        value = 1.0 + i * 0.25
        native.polygon_fill(got, box[:, 0], box[:, 1], value)
        jax_native.polygon_fill(ref, box[:, 0], box[:, 1], value)
        rr, cc = polygon_indices(box[:, 0], box[:, 1])
        keep = (rr < w) & (cc < h)
        twin[cc[keep], rr[keep]] = value
    assert got.any()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("shape,sigma", [((40, 56), 3.0), ((33, 17), 1.5)])
def test_gaussian_blur_equals_jax_native_and_scipy_twin(shape, sigma):
    img = np.random.default_rng(5).random(shape)
    got = native.gaussian_blur(img, sigma)
    np.testing.assert_array_equal(got, jax_native.gaussian_blur(img, sigma))
    np.testing.assert_allclose(got, gaussian_blur_np(img, sigma), rtol=0, atol=1e-9)
    np.testing.assert_allclose(native.gaussian_blur(G["gauss_src"], 3.0), G["gauss_ref"],
                               atol=1e-9)


def test_failed_build_raises_with_the_command(tmp_path):
    with pytest.raises(RuntimeError, match="host ops build failed.*no-such-compiler"):
        native.build(cxx="no-such-compiler", build_dir=tmp_path)
    assert not list(tmp_path.iterdir())


def test_build_names_the_library_by_digest(tmp_path):
    path = native.build(build_dir=tmp_path)
    assert path == native.lib_path(tmp_path) and path.name.startswith("libhostops-")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert native.build(build_dir=tmp_path) == path


@pytest.mark.parametrize("bad", ["dtype", "interp", "canvas", "vertices", "blur"])
def test_wrappers_refuse_what_the_library_does_not_take(bad):
    with pytest.raises(ValueError):
        if bad == "dtype":
            native.warp_affine(np.zeros((4, 4), np.int16), np.eye(2, 3), (4, 4))
        elif bad == "interp":
            native.warp_affine(np.zeros((4, 4), np.uint8), np.eye(2, 3), (4, 4), "area")
        elif bad == "canvas":
            native.polygon_fill(np.zeros((4, 4), np.float32), [0, 2, 2], [0, 0, 2], 1.0)
        elif bad == "vertices":
            native.polygon_fill(np.zeros((4, 4)), [0, 2, 2], [0, 0], 1.0)
        else:
            native.gaussian_blur(np.zeros((2, 3, 4)), 1.0)


def test_threaded_loader_equals_one_thread_on_the_ocid_tree(tmp_path):
    """The rawlb reader on the native ops: 4 loader threads give the host
    batches of one thread, bit for bit."""
    build_ocid_tree(tmp_path, num_scenes=2)
    ds = OCIDVLGDataset(str(tmp_path), "val", input_size=128, **wire_kwargs("rawlb"))
    with DataLoader(ds, 3, pad_last_batch=True, num_workers=1) as one:
        ref = list(one)
    with DataLoader(ds, 3, pad_last_batch=True, num_workers=4) as threads:
        got = list(threads)
    assert len(ref) == len(got) == 3 and ref[0]["lb_img_u8"].shape == (3, 128, 128, 3)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            elif isinstance(v, list):  # grasps, bbox, sentence, ids
                assert len(g[k]) == len(v), k
                for a, b in zip(g[k], v):
                    np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert g[k] == v, k
