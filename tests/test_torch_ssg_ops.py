"""SSG's ops in the port against the JAX package, on the CPU in fp32: box
and anchor utilities, the bilinear GT resize, the gaussian blur, the 4-tap
peak sampling, and the lincomb loss sums (K5/K5b's plain twins behind the
autograd function) with their gradients, against both the JAX Pallas kernel
in interpret mode and the einsum losses.

Tolerances, each stated where it is used: geometry is exact (ints, masks)
or a few f32 ulps; the lincomb sums and gradients 1e-5 of their largest
magnitude (f32 sums over up to 1156 pixels and 40 anchors in another
order), the grasp/mask losses that wrap them 1e-5 relative, as
tests/test_pallas_lincomb.py holds the two JAX paths to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.models import ssg_loss as JL
from crog_tpu.models.ssg_eval import _sample_bilinear_at as j_sample
from crog_tpu.ops import boxes as JB
from crog_tpu.ops.filters import gaussian_blur_jax
from crog_tpu.ops.pallas_lincomb import lincomb_task_sums as j_sums
from crog_tpu.ops.resize import resize_bilinear as j_resize
from crog_tpu_torch.models import ssg_loss as TL
from crog_tpu_torch.models.ssg_eval import _sample_bilinear_at as t_sample
from crog_tpu_torch.ops import boxes as TB
from crog_tpu_torch.ops import lincomb as LC
from crog_tpu_torch.ops.filters import gaussian_blur
from tests.torch_port_helpers import assert_close_scaled

T = torch.from_numpy


def _boxes(rng, *lead, lo=0.6, span=0.2):
    a = rng.rand(*lead, 2) * lo
    b = a + span + rng.rand(*lead, 2) * span
    return np.stack([a[..., 0], a[..., 1], b[..., 0], b[..., 1]], -1).astype(np.float32)


# ----------------------------------------------------------------- boxes
@pytest.mark.parametrize("hw,scale,img", [((4, 4), 24, 128), ((68, 68), 24, 544),
                                          ((5, 5), 384, 544)])
def test_make_anchors_matches_jax(hw, scale, img):
    np.testing.assert_array_equal(TB.make_anchors(*hw, scale, (1, 0.5, 2), img),
                                  JB.make_anchors(*hw, scale, (1, 0.5, 2), img))


def _match_case():
    """Four GTs over the 4x4 x 3-ratio grid: GT 0 and GT 1 share their best
    anchor (1), so the force-match scatter has a duplicate; GT 3 is
    padding."""
    anchors = JB.make_anchors(4, 4, 24, (1, 0.5, 2), 128)
    boxes = np.array([[0.1, 0.1, 0.3, 0.3], [0.1, 0.12, 0.3, 0.32],
                      [0.6, 0.6, 0.9, 0.9], [0, 0, 0, 0]], np.float32)
    valid = np.array([True, True, True, False])
    labels = np.array([3, 5, 2, 0], np.int32)
    return anchors, boxes, valid, labels


def test_match_shared_best_anchor_matches_jax():
    """The anchor two GTs force-match goes to the later GT (class 5), as
    the JAX package's scatter gives it on the CPU."""
    anchors, boxes, valid, labels = _match_case()
    decoded = np.concatenate([anchors[:, :2] - anchors[:, 2:] / 2,
                              anchors[:, :2] + anchors[:, 2:] / 2], 1)
    best = np.asarray(JB.box_iou(jnp.asarray(boxes), jnp.asarray(decoded))).argmax(1)
    assert best[0] == best[1]
    ref = JB.match(*(jnp.asarray(x) for x in (boxes, valid, labels, anchors)))
    got = TB.match(*(T(x) for x in (boxes, valid, labels, anchors)))
    for name, r, g in zip(("offsets", "conf", "anchor_max_gt", "anchor_max_i"), ref, got):
        if name == "offsets":  # log and divisions: a few ulps
            assert_close_scaled(g.numpy(), np.asarray(r), 1e-6, name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(got[3][best[0]]) == 1 and int(got[1][best[0]]) == 5


def test_match_batched_matches_jax_vmap():
    """A [B, M] batch at 128^2's five levels against the JAX match vmapped,
    with the 0.5 / 0.4 thresholds."""
    from crog_tpu.models.ssg import SSG

    anchors = SSG(img_size=128).anchors()
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 3, 6, lo=0.7, span=0.1)
    valid = rng.rand(3, 6) > 0.3
    labels = rng.randint(1, 8, (3, 6)).astype(np.int32)
    ref = jax.vmap(lambda b, v, l: JB.match(b, v, l, jnp.asarray(anchors)))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(labels))
    got = TB.match(T(boxes), T(valid), T(labels), T(anchors))
    assert_close_scaled(got[0].numpy(), np.asarray(ref[0]), 1e-6, "offsets")
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_encode_decode_iou_match_jax():
    rng = np.random.RandomState(0)
    priors = np.concatenate([rng.rand(50, 2), 0.05 + rng.rand(50, 2) * 0.3], 1).astype(np.float32)
    gt = _boxes(rng, 50)
    pred = (rng.randn(50, 4) * 0.5).astype(np.float32)
    assert_close_scaled(TB.encode(T(gt), T(priors)).numpy(),
                        np.asarray(JB.encode(jnp.asarray(gt), jnp.asarray(priors))), 1e-6)
    assert_close_scaled(TB.decode(T(pred), T(priors)).numpy(),
                        np.asarray(JB.decode(jnp.asarray(pred), jnp.asarray(priors))), 1e-6)
    other = _boxes(rng, 20)
    assert_close_scaled(TB.box_iou(T(gt), T(other)).numpy(),
                        np.asarray(JB.box_iou(jnp.asarray(gt), jnp.asarray(other))), 1e-6)
    m1 = (rng.rand(6, 40) > 0.5).astype(np.float32)
    m2 = (rng.rand(4, 40) > 0.5).astype(np.float32)
    assert_close_scaled(TB.mask_iou(T(m1), T(m2)).numpy(),
                        np.asarray(JB.mask_iou(jnp.asarray(m1), jnp.asarray(m2))), 1e-6)


@pytest.mark.parametrize("h,w", [(17, 23), (136, 136)])
def test_box_inside_mask_and_crop_match_jax(h, w):
    """Boxes with edges on pixel boundaries, zero-size and reversed boxes."""
    rng = np.random.RandomState(1)
    boxes = np.concatenate([_boxes(rng, 6), np.array(
        [[0.25, 0.5, 0.25, 0.5], [0.75, 0.75, 0.25, 0.25], [0, 0, 1, 1]], np.float32)])
    got = TB.box_inside_mask(T(boxes), h, w)
    ref = JB.box_inside_mask(jnp.asarray(boxes), h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    masks = rng.rand(h, w, len(boxes)).astype(np.float32)
    np.testing.assert_array_equal(
        TB.crop_masks(T(masks), T(boxes), outside_value=1.0).numpy(),
        np.asarray(JB.crop_masks(jnp.asarray(masks), jnp.asarray(boxes), outside_value=1.0)))


# ------------------------------------------------------- resize / filters
def test_gt_downsample_blur_and_peak_sampling_match_jax():
    """The 544 -> 136 GT resize (a binary mask stack), the eval's sigma-2
    blur and the 4-tap bilinear sampling, to f32 rounding."""
    rng = np.random.RandomState(2)
    masks = (rng.rand(2, 3, 136, 136) > 0.5).astype(np.float32)
    got = TL.downsample_masks(T(masks), (34, 34))
    ref = (j_resize(jnp.asarray(masks)[..., None], (34, 34), False)[..., 0] > 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))
    maps = rng.rand(3, 40, 52).astype(np.float32)
    assert_close_scaled(gaussian_blur(T(maps), 2.0).numpy(),
                        np.asarray(gaussian_blur_jax(jnp.asarray(maps), 2.0)), 1e-6)
    m = rng.randn(3, 17, 19).astype(np.float32)
    pr, pc = rng.randint(0, 64, (3, 5)), rng.randint(0, 64, (3, 5))
    assert_close_scaled(t_sample(T(m), T(pr), T(pc), 64).numpy(),
                        np.asarray(j_sample(jnp.asarray(m), jnp.asarray(pr),
                                            jnp.asarray(pc), 64)), 1e-6)


# --------------------------------------------------------------- lincomb
def _lincomb_case(seed, b, ph, pw, k, t, m, c=32):
    rng = np.random.RandomState(seed)
    protos = (rng.randn(b, ph, pw, c) * 0.3).astype(np.float32)
    coef = (rng.randn(b, k, t, c) * 0.3).astype(np.float32)
    ds = rng.rand(b, t * m, ph * pw).astype(np.float32)
    if t == 1:
        ds = (ds > 0.5).astype(np.float32)
    sel_gt = rng.randint(0, m, (b, k)).astype(np.int32)
    box = _boxes(rng, b, k)
    box[:, 0] = [0.5, 0.5, 0.5, 0.5]  # an empty crop: zero-size box
    cot = rng.randn(b, k, t).astype(np.float32)
    return protos, coef, ds, sel_gt, box, cot


def _jax_sums_and_grads(case, t, kind):
    protos, coef, ds, sel_gt, box, cot = case

    def f(cf, pp):
        s = j_sums(pp, cf, jnp.asarray(ds), jnp.asarray(sel_gt), jnp.asarray(box), t,
                   interpret=True, loss_kind=kind)
        return jnp.sum(s * cot), s

    (_, sums), (dc, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(coef), jnp.asarray(protos))
    return np.asarray(sums), np.asarray(dc), np.asarray(dp)


@pytest.mark.parametrize("kind,t,geom", [
    ("smooth_l1", 4, (2, 16, 16, 8, 4)),   # tests/test_pallas_lincomb.py:14
    ("bce", 1, (2, 16, 16, 8, 4)),
    ("smooth_l1", 4, (1, 34, 34, 5, 3)),   # its production-geometry case
    # T*M = 8 rows (a multiple of 8) and kt = 36 columns (not of 128): the
    # TPU wrapper's padded columns would point at a real GT row
    ("smooth_l1", 4, (2, 12, 10, 9, 2)),
    ("bce", 1, (2, 12, 10, 36, 8)),
])
def test_lincomb_sums_and_grads_match_pallas_interpret(kind, t, geom):
    b, ph, pw, k, m = geom
    case = _lincomb_case(7, b, ph, pw, k, t, m)
    protos, coef, ds, sel_gt, box, cot = case
    ref_sums, ref_dc, ref_dp = _jax_sums_and_grads(case, t, kind)
    pc, pp = T(coef).requires_grad_(), T(protos).requires_grad_()
    sums = LC.lincomb_task_sums(pp, pc, T(ds), T(sel_gt), T(box), t, loss_kind=kind)
    (sums * T(cot)).sum().backward()
    assert_close_scaled(sums.detach().numpy(), ref_sums, 1e-5, "sums")
    assert_close_scaled(pc.grad.numpy(), ref_dc, 1e-5, "dcoef")
    assert_close_scaled(pp.grad.numpy(), ref_dp, 1e-5, "dprotos")
    # the zero-size box crops to its padding: 2x2 pixels at most
    assert (sums.detach().numpy()[0, 0] > 0).all()


def test_lincomb_plain_twins_match_kernel_interface():
    """lincomb_fwd / lincomb_bwd on CPU tensors are the plain twins, over
    the kernels' interface (coef [B, KT, C], GT row per column, sanitized
    boxes)."""
    case = _lincomb_case(8, 2, 12, 10, 9, 4, 2)
    protos, coef, ds, sel_gt, box, cot = case
    args = LC.kernel_args(T(protos), T(coef), T(ds), T(sel_gt), T(box), 4)
    assert args[1].shape == (2, 36, 32) and args[3].dtype == torch.int32
    np.testing.assert_array_equal(args[3][0, :4].numpy(), sel_gt[0, 0] + 2 * np.arange(4))
    sums = LC.lincomb_fwd(*args, 4)
    g = T(cot).reshape(2, 36)
    dcoef, dprotos = LC.lincomb_bwd(*args, g, 4)
    ref_sums, ref_dc, ref_dp = _jax_sums_and_grads(case, 4, "smooth_l1")
    assert_close_scaled(sums.numpy(), ref_sums.reshape(2, 36), 1e-5)
    assert_close_scaled(dcoef.numpy(), ref_dc.reshape(2, 36, 32), 1e-5)
    assert_close_scaled(dprotos.numpy(), ref_dp, 1e-5)
    assert LC.lincomb_fwd.launches == 0 and LC.lincomb_bwd.launches == 0


def _loss_case(seed, b=2, n=48, m=4, ph=16, pw=16, k=8):
    """tests/test_pallas_lincomb.py's inputs, and the priorities that pick
    the positives, drawn by the JAX package's generator."""
    rng = np.random.RandomState(seed)
    protos = (rng.randn(b, ph, pw, 32) * 0.3).astype(np.float32)
    coef = (rng.randn(b, n, 4, 32) * 0.3).astype(np.float32)
    gt = {kk: rng.rand(b, m, 64, 64).astype(np.float32) for kk in TL.GRASP_KEYS}
    masks = (rng.rand(b, m, 64, 64) > 0.5).astype(np.float32)
    a_i = rng.randint(0, m, (b, n)).astype(np.int32)
    a_box = _boxes(rng, b, n)
    pos = rng.rand(b, n) > 0.6
    prio = np.array(jax.random.uniform(jax.random.PRNGKey(3), (b, n)))
    return protos, coef, gt, masks, a_i, a_box, pos, prio, k


@pytest.mark.parametrize("force_pallas", [False, True])
def test_lincomb_losses_match_both_jax_paths(force_pallas):
    """lincomb_grasp_masks_loss and lincomb_mask_loss (values, dcoef,
    dprotos) against the JAX einsum path and its Pallas kernel in interpret
    mode, with the same positives."""
    protos, coef, gt, masks, a_i, a_box, pos, prio, k = _loss_case(0)
    jsel = JL._select_positives(jnp.asarray(pos), jax.random.PRNGKey(3), k)
    tsel = TL._select_positives(T(pos), T(prio), k)
    for r, g in zip(jsel, tsel):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    jargs = (jnp.asarray(pos), jnp.asarray(a_i), jnp.asarray(a_box), *jsel)
    targs = (T(pos), T(a_i).long(), T(a_box), *tsel)

    def jgrasp(cf, pp):
        out = JL.lincomb_grasp_masks_loss(cf, pp, {kk: jnp.asarray(v) for kk, v in gt.items()},
                                          *jargs, force_pallas=force_pallas, interpret=True)
        return sum(out.values()), out

    (_, jout), (jdc, jdp) = jax.value_and_grad(jgrasp, argnums=(0, 1), has_aux=True)(
        jnp.asarray(coef), jnp.asarray(protos))
    pc, pp = T(coef).requires_grad_(), T(protos).requires_grad_()
    tout = TL.lincomb_grasp_masks_loss(pc, pp, {kk: T(v) for kk, v in gt.items()}, *targs)
    sum(tout.values()).backward()
    for kk in ("qua", "sin", "cos", "wid"):
        np.testing.assert_allclose(tout[kk].item(), float(jout[kk]), rtol=1e-5, err_msg=kk)
    assert_close_scaled(pc.grad.numpy(), np.asarray(jdc), 1e-5, "grasp dcoef")
    assert_close_scaled(pp.grad.numpy(), np.asarray(jdp), 1e-5, "grasp dprotos")

    icoef = coef[:, :, 0]
    jv, (jdc, jdp) = jax.value_and_grad(
        lambda cf, pp: JL.lincomb_mask_loss(cf, pp, jnp.asarray(masks), *jargs,
                                            force_pallas=force_pallas, interpret=True),
        argnums=(0, 1))(jnp.asarray(icoef), jnp.asarray(protos))
    pc, pp = T(icoef).requires_grad_(), T(protos).requires_grad_()
    tv = TL.lincomb_mask_loss(pc, pp, T(masks), *targs)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    assert_close_scaled(pc.grad.numpy(), np.asarray(jdc), 1e-5, "mask dcoef")
    assert_close_scaled(pp.grad.numpy(), np.asarray(jdp), 1e-5, "mask dprotos")


def test_lincomb_wrapper_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="tasks"):
        LC.lincomb_task_sums(torch.zeros(1, 4, 4, 32), torch.zeros(1, 2, 4, 32),
                             torch.zeros(1, 4, 16), torch.zeros(1, 2, dtype=torch.int32),
                             torch.zeros(1, 2, 4), num_tasks=1)
    assert LC.region_plan(136, 136) == (4, 28) and LC.region_plan(16, 16) == (7, 16)
    assert LC.region_plan(136, 136, LC.BWD_PIXELS) == (8, 28)


# A model of the lincomb kernels' plan in plain PyTorch: the anchors each
# region's block lists (csrc/lincomb.cu:list_anchors), the regions whose
# partials the second pass adds for each anchor (region_range) and K5's
# decomposition of the sums.  The card tests hold the CUDA plan itself
# against the twins (tests/test_torch_cuda_kernels.py); these hold the
# model against a brute-force box mask at sizes the card tests do not reach.
def _anchor_cells(boxes, ph, pw):
    """Integer pixel rectangles (x1, x2, y1, y2), [B, A] each, of sanitized
    boxes: the pixels p with x1 <= p_x < x2, y1 <= p_y < y2 are those
    ``box_inside_mask`` sets (csrc/lincomb.cu:cell)."""
    x1, x2, y1, y2 = boxes.float().unbind(-1)

    def cell(v, size):
        return torch.ceil(v.clamp(0.0, float(size))).long()

    return cell(x1, pw), cell(x2, pw), cell(y1, ph), cell(y2, ph)


def _region_anchors(boxes, ph, pw, pixels=LC.FWD_PIXELS):
    """For each image and region (row-major), the anchors whose box reaches
    the region, in index order ([B][regions] lists)."""
    rh, rw = LC.region_plan(ph, pw, pixels)
    x1, x2, y1, y2 = _anchor_cells(boxes, ph, pw)
    nonempty = (x1 < x2) & (y1 < y2)
    out = []
    for b in range(boxes.shape[0]):
        rows = []
        for y0 in range(0, ph, rh):
            for x0 in range(0, pw, rw):
                hit = (nonempty[b] & (x1[b] < min(x0 + rw, pw)) & (x2[b] > x0)
                       & (y1[b] < min(y0 + rh, ph)) & (y2[b] > y0))
                rows.append(torch.nonzero(hit).flatten().tolist())
        out.append(rows)
    return out


def _anchor_regions(boxes, ph, pw, pixels=LC.FWD_PIXELS):
    """For each image and anchor, the regions whose partials the second pass
    adds for its columns, in that order: the rectangle of regions its box
    reaches, none for an empty box."""
    rh, rw = LC.region_plan(ph, pw, pixels)
    nrx = -(-pw // rw)
    x1, x2, y1, y2 = (v.tolist() for v in _anchor_cells(boxes, ph, pw))
    return [[[] if a >= c or e >= f else
             [ry * nrx + rx for ry in range(e // rh, (f - 1) // rh + 1)
              for rx in range(a // rw, (c - 1) // rw + 1)]
             for a, c, e, f in zip(*rows)] for rows in zip(x1, x2, y1, y2)]


def _sums_by_regions(protos, coef, ds, idx, boxes, num_tasks, cos_idx=2,
                     loss_kind="smooth_l1"):
    """K5's decomposition: each column's full-row sum of loss(outside_t, gt)
    plus, region by region in the second pass's order, its inside points'
    loss(s, gt) - loss(outside_t, gt), over the regions that list it."""
    b, ph, pw, _ = protos.shape
    kt = coef.shape[1]
    rh, rw = LC.region_plan(ph, pw)
    nrx = -(-pw // rw)
    s, inside, _, gt = LC._points(protos, coef, ds, idx, boxes, num_tasks, cos_idx)
    out = LC._outside(kt, num_tasks, cos_idx, gt.device)[None, :, None].expand_as(gt)
    rows = LC._loss(out, gt, loss_kind).sum(-1)
    diff = torch.where(inside, LC._loss(s, gt, loss_kind) - LC._loss(out, gt, loss_kind), 0.0)
    diff = diff.reshape(b, kt, ph, pw)
    sums = rows.clone()
    for i, lists in enumerate(_region_anchors(boxes, ph, pw)):
        for r, anchors in enumerate(lists):
            y0, x0 = (r // nrx) * rh, (r % nrx) * rw
            for j in anchors:
                cols = slice(j * num_tasks, (j + 1) * num_tasks)
                sums[i, cols] += diff[i, cols, y0:y0 + rh, x0:x0 + rw].sum((-2, -1))
    return sums


def _plan_boxes(rng, b, k, mode):
    """Relative boxes of ``mode``: "some" (two off the map, one of zero size,
    the rest 0.05-0.45 of it), "off-map", "full-map"."""
    box = _boxes(rng, b, k, lo=0.7, span=0.15)
    if mode == "some":
        box[:, 0] = [1.2, 1.2, 1.5, 1.5]
        box[:, 1] = [-0.5, -0.5, -0.2, -0.2]
        box[:, 2] = [0.5, 0.5, 0.5, 0.5]
    elif mode == "off-map":
        box[:] = [-0.6, 1.1, -0.3, 1.4]
    elif mode == "full-map":
        box[:] = [0.0, 0.0, 1.0, 1.0]
    return box


@pytest.mark.parametrize("pixels", [LC.FWD_PIXELS, LC.BWD_PIXELS])
@pytest.mark.parametrize("mode", ["some", "off-map", "full-map"])
@pytest.mark.parametrize("ph,pw,k", [(40, 44, 9), (37, 29, 7), (136, 136, 6)])
def test_lincomb_region_plan_covers_every_inside_point_once(mode, ph, pw, k, pixels):
    """The kernels' plan against a brute-force box mask: every inside point
    lies in exactly one region that lists its anchor; a region that does not
    list an anchor holds none of its inside points, and one that does holds
    some; the second pass adds, for each anchor, exactly the regions that
    list it, in region order."""
    rng = np.random.RandomState(ph + k)
    boxes = torch.stack(TB.sanitize_boxes(T(_plan_boxes(rng, 2, k, mode)), ph, pw), -1)
    rh, rw = LC.region_plan(ph, pw, pixels)
    nrx = -(-pw // rw)
    lists = _region_anchors(boxes, ph, pw, pixels)
    ranges = _anchor_regions(boxes, ph, pw, pixels)
    x1, x2, y1, y2 = (v[..., None, None] for v in boxes.unbind(-1))
    px = torch.arange(pw, dtype=torch.float32)[None, None, None, :]
    py = torch.arange(ph, dtype=torch.float32)[None, None, :, None]
    inside = (px >= x1) & (px < x2) & (py >= y1) & (py < y2)  # [B, k, ph, pw]
    region = ((torch.arange(ph)[:, None] // rh) * nrx + torch.arange(pw)[None, :] // rw)
    for b in range(2):
        assert len(lists[b]) == -(-ph // rh) * nrx
        covered = torch.zeros(k, ph, pw, dtype=torch.int32)
        for r, anchors in enumerate(lists[b]):
            assert anchors == sorted(anchors)
            in_r = region == r
            for j in range(k):
                held = bool((inside[b, j] & in_r).any())
                assert held == (j in anchors), (b, r, j)
                if j in anchors:
                    covered[j] += (inside[b, j] & in_r).int()
        assert torch.equal(covered, inside[b].int())
        for j in range(k):
            assert ranges[b][j] == [r for r, anchors in enumerate(lists[b]) if j in anchors]
    if mode == "off-map":
        assert all(not a for rows in lists for a in rows)
    if mode == "full-map":
        assert all(a == list(range(k)) for rows in lists for a in rows)


@pytest.mark.parametrize("kind,t", [("bce", 1), ("smooth_l1", 4)])
@pytest.mark.parametrize("mode", ["some", "off-map", "full-map"])
def test_lincomb_outside_loss_decomposition_matches_twin(kind, t, mode):
    """K5's sums as the kernel forms them -- each GT row's full-map loss at
    outside_t, plus the inside points' loss(s, gt) - loss(outside_t, gt)
    region by region -- equal the twin's within 1e-5 of their largest
    magnitude."""
    rng = np.random.RandomState(11)
    protos, coef, ds, sel_gt, _, _ = _lincomb_case(11, 2, 40, 44, 9, t, 3)
    box = _plan_boxes(rng, 2, 9, mode)
    args = LC.kernel_args(T(protos), T(coef), T(ds), T(sel_gt), T(box), t)
    ref = LC.lincomb_task_sums_plain(*args, t, loss_kind=kind)
    got = _sums_by_regions(*args, t, loss_kind=kind)
    assert_close_scaled(got.numpy(), ref.numpy(), 1e-5)
