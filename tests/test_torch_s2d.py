"""The port's space-to-depth stem against the JAX package, on the CPU in
fp32: the s2d helpers (crog_tpu_torch/ops/s2d.py), pack_s1/unpack_s1 and the
K6/K6b twins (crog_tpu_torch/ops/s2dconv.py) against ``jax.vjp`` of
``pallas_s2dconv.blocked_conv3x3_s1`` in interpret mode, and the s2d stem of
``ModifiedResNet`` (fused or not) against the JAX package's ``_stem_s2d``
and against the port's own plain stem.

Tolerances: the helpers and the packing move values without arithmetic and
are held bit-exact; ``unpack_s1`` adds the same four blocks in the same
order and is held bit-exact too.  The conv twins and the stems compute the
same tap products in fp32 and sum them in another order: outputs to 1e-5
of their largest magnitude, gradients to 1e-4 (sums over every cell of the
plane).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.models.clip import ModifiedResNet as JaxResNet
from crog_tpu.ops import pallas_s2dconv as psc
from crog_tpu.ops import s2d as js
from crog_tpu_torch.models.clip import ModifiedResNet
from crog_tpu_torch.ops import s2d as ts
from crog_tpu_torch.ops import s2dconv as SC
from tests.torch_port_helpers import assert_close_scaled

T = torch.from_numpy


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def test_s2d_helpers_equal_jax():
    x = _rand(0, 2, 16, 24, 3)
    for k in (2, 4):
        got = ts.space_to_depth(T(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(js.space_to_depth(jnp.asarray(x), k)))
        np.testing.assert_array_equal(ts.depth_to_space(got, k).numpy(), x)
    w2, w1 = _rand(1, 3, 3, 3, 5), _rand(2, 3, 3, 5, 7)
    np.testing.assert_array_equal(ts.block_kernel_s2(T(w2)).numpy(),
                                  np.asarray(js.block_kernel_s2(jnp.asarray(w2))))
    np.testing.assert_array_equal(ts.block_kernel_s1(T(w1)).numpy(),
                                  np.asarray(js.block_kernel_s1(jnp.asarray(w1))))
    xb = _rand(3, 2, 4, 6, 28)
    np.testing.assert_array_equal(ts.block_mean(T(xb), 7).numpy(),
                                  np.asarray(js.block_mean(jnp.asarray(xb), 7)))


@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (3, 5)])
def test_pack_unpack_equal_jax(ci, co):
    w, g = _rand(4, 3, 3, ci, co), _rand(5, 16 * ci, 4 * co)
    np.testing.assert_array_equal(SC.pack_s1(T(w)).numpy(), np.asarray(psc.pack_s1(jnp.asarray(w))))
    np.testing.assert_array_equal(SC.unpack_s1(T(g), ci, co).numpy(),
                                  np.asarray(psc.unpack_s1(jnp.asarray(g), ci, co)))


@pytest.mark.parametrize("b,h,w,ci,co", [(2, 6, 10, 32, 32), (1, 5, 7, 32, 64),
                                         (1, 4, 4, 4, 8)])
def test_blocked_conv_twins_match_pallas_interpret(b, h, w, ci, co):
    """Forward, dx and dw of ``blocked_conv3x3_s1`` (the K6/K6b twins on the
    CPU) against ``jax.vjp`` of the Pallas op in interpret mode, at the
    stem's widths (conv2, conv3) and one narrow case; the planes are not
    multiples of the kernels' 8 x 16 cell tile."""
    x, wt = _rand(6, b, h, w, 4 * ci), _rand(7, 3, 3, ci, co, scale=0.2)
    g = _rand(8, b, h, w, 4 * co)
    fused = functools.partial(psc.blocked_conv3x3_s1, interpret=True)
    y, vjp = jax.vjp(fused, jnp.asarray(x), jnp.asarray(wt))
    dx, dw = vjp(jnp.asarray(g))
    xt, wtt = T(x).requires_grad_(), T(wt).requires_grad_()
    yt = SC.blocked_conv3x3_s1(xt, wtt)
    yt.backward(T(g))
    assert_close_scaled(yt.detach().numpy(), np.asarray(y), 1e-5, "y")
    assert_close_scaled(xt.grad.numpy(), np.asarray(dx), 1e-5, "dx")
    assert_close_scaled(wtt.grad.numpy(), np.asarray(dw), 1e-4, "dw")
    # the packed gradient of the twin is the patch^T dy the TPU kernel sums
    dwp = SC.wgrad_plain(T(x), T(g), ci, co)
    assert_close_scaled(SC.unpack_s1(dwp, ci, co).numpy(), np.asarray(dw), 1e-4, "unpack")


class _JaxStem(JaxResNet):
    import flax.linen as _nn

    @_nn.compact
    def __call__(self, x, train=False):
        return self._stem_s2d(x, train)


_GEO = dict(layers=(1, 1, 1, 1), output_dim=64, heads=4, input_resolution=32, width=64)


def _stem_pair(fused: bool):
    """(JAX stem module, its randomized variables, the port's ModifiedResNet
    holding the same stem weights)."""
    jstem = _JaxStem(stem_s2d=True, **_GEO)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jstem.init(jax.random.PRNGKey(0), x, train=False))
    r = np.random.RandomState(9)
    params, stats = dict(v["params"]), dict(v["batch_stats"])
    port = ModifiedResNet(stem_s2d=True, fused_stem=fused, **_GEO)
    with torch.no_grad():
        for i in (1, 2, 3):
            k = params[f"conv{i}"]["kernel"]
            k = (k + 0.3 * k.std() * r.randn(*k.shape)).astype(np.float32)
            params[f"conv{i}"] = {"kernel": k}
            getattr(port, f"conv{i}").weight.copy_(T(k.transpose(3, 2, 0, 1).copy()))
            c = k.shape[-1]
            bn = {"scale": (1 + 0.1 * r.randn(c)).astype(np.float32),
                  "bias": (0.1 * r.randn(c)).astype(np.float32)}
            st = {"mean": (0.1 * r.randn(c)).astype(np.float32),
                  "var": (0.5 + r.rand(c)).astype(np.float32)}
            params[f"bn{i}"], stats[f"bn{i}"] = bn, st
            mod = getattr(port, f"bn{i}")
            mod.weight.copy_(T(bn["scale"]))
            mod.bias.copy_(T(bn["bias"]))
            mod.running_mean.copy_(T(st["mean"]))
            mod.running_var.copy_(T(st["var"]))
    return jstem, {"params": params, "batch_stats": stats}, port


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_s2d_stem_matches_jax(fused, train):
    """The port's s2d stem (conv2/conv3 through ``blocked_conv3x3_s1`` when
    fused, else F.conv2d with ``block_kernel_s1``) against the JAX package's
    ``_stem_s2d`` through XLA: output, the running statistics of bn1..bn3 in
    train mode, and the gradients of every stem parameter."""
    jstem, v, port = _stem_pair(fused)
    x = _rand(10, 2, 32, 32, 3)
    cot = _rand(11, 2, 8, 8, 64)

    def loss(params):
        y, mut = jstem.apply({"params": params, "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=train, mutable=["batch_stats"])
        return jnp.vdot(y, cot), (y, mut)

    (_, (ref, mut)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    port.train(train)
    y = port._stem_s2d(T(x))
    y.backward(T(cot))
    assert_close_scaled(y.detach().numpy(), np.asarray(ref), 1e-5, "stem output")
    for i in (1, 2, 3):
        conv, bn = getattr(port, f"conv{i}"), getattr(port, f"bn{i}")
        gk = np.asarray(grads[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
        assert_close_scaled(conv.weight.grad.numpy(), gk, 1e-4, f"conv{i}")
        assert_close_scaled(bn.weight.grad.numpy(), np.asarray(grads[f"bn{i}"]["scale"]),
                            1e-4, f"bn{i} scale")
        assert_close_scaled(bn.bias.grad.numpy(), np.asarray(grads[f"bn{i}"]["bias"]),
                            1e-4, f"bn{i} bias")
        new = mut["batch_stats"][f"bn{i}"]
        assert_close_scaled(bn.running_mean.numpy(), np.asarray(new["mean"]), 1e-5)
        assert_close_scaled(bn.running_var.numpy(), np.asarray(new["var"]), 1e-5)
        assert int(bn.num_batches_tracked) == int(train)


@pytest.mark.parametrize("train", [False, True])
def test_s2d_stem_matches_plain_stem(train):
    """The same modules through the s2d stem (fused) and the plain stem:
    outputs, gradients and running statistics agree; an input whose side
    is not a multiple of 4 takes the plain stem."""
    _, _, port = _stem_pair(True)
    x = T(_rand(12, 2, 32, 32, 3))
    cot = T(_rand(13, 2, 8, 8, 64))
    out = []
    for s2d in (True, False):
        m = ModifiedResNet(stem_s2d=s2d, **_GEO)
        m.load_state_dict(port.state_dict())
        m.fused_stem = True
        m.train(train)
        y = m._stem_s2d(x) if s2d else m._stem_plain(x)
        y.backward(cot)
        out.append((y.detach(), {n: p.grad for n, p in m.named_parameters()
                                 if p.grad is not None},
                    {n: b.clone() for n, b in m.named_buffers() if "running" in n}))
    (ys, gs, bs), (yp, gp, bp) = out
    assert_close_scaled(ys.numpy(), yp.numpy(), 1e-5, "output")
    assert set(gs) == set(gp) and len(gs) == 9
    for n in gp:
        assert_close_scaled(gs[n].numpy(), gp[n].numpy(), 1e-4, n)
    for n in bp:
        assert_close_scaled(bs[n].numpy(), bp[n].numpy(), 1e-5, n)
    m = ModifiedResNet(stem_s2d=True, **_GEO).eval()
    with torch.no_grad():
        odd = T(_rand(14, 1, 34, 34, 3))
        ref = ModifiedResNet(stem_s2d=False, **_GEO).eval()
        ref.load_state_dict(m.state_dict())
        for a, b in zip(m(odd), ref(odd)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("b,h,w,ci,co", [(24, 104, 104, 32, 32), (24, 104, 104, 32, 64),
                                         (1, 20, 37, 32, 32), (3, 9, 17, 32, 64),
                                         (2, 16, 24, 64, 32), (1, 5, 7, 64, 64),
                                         (1, 1, 1, 32, 32), (5, 8, 16, 32, 32)])
def test_wgrad_schedule_covers_every_tile_once(b, h, w, ci, co):
    """K6b's schedule gives each of the ragged plane's 8 x 16 cell tiles to
    exactly one cluster's contiguous range, leaves no cluster empty, and
    fits the clusters' CTAs on CLUSTER_SMS SMs."""
    clusters, per = SC.wgrad_schedule(b, h, w, ci, co)
    tr, tw = SC.TILE_CELLS
    tiles = b * -(-h // tr) * -(-w // tw)
    owner = np.full(tiles, -1)
    for g in range(clusters):
        lo, hi = g * per, min(tiles, (g + 1) * per)
        assert lo < hi, f"cluster {g} is empty"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = g
    assert (owner >= 0).all()
    size, groups = SC.wgrad_cluster(ci, co)
    assert size <= SC.MAX_CLUSTER and size * groups == (16 * ci // 128) * (4 * co // 128)
    assert clusters * size * groups <= max(SC.CLUSTER_SMS, size * groups)


def test_wgrad_schedule_depends_on_the_shapes_alone():
    """The schedule, and so the order of K6b's sums, is a function of (B, H,
    W, ci, co): the same in every call, whatever the thread or device
    state, and the main path's conv2 and conv3 take 30 and 15 clusters."""
    shapes = [(24, 104, 104, 32, 32), (24, 104, 104, 32, 64), (3, 9, 17, 32, 64)]
    first = [SC.wgrad_schedule(*s) for s in shapes]
    torch.manual_seed(123)
    with torch.no_grad():
        again = [SC.wgrad_schedule(*s) for s in reversed(shapes)][::-1]
    assert first == again
    assert first[:2] == [(30, 73), (15, 146)]
    assert SC.wgrad_schedule(24, 104, 104, 32, 32) != SC.wgrad_schedule(24, 96, 104, 32, 32)


@pytest.mark.parametrize("b,h,w,ci,co", [(24, 104, 104, 32, 32), (24, 104, 104, 32, 64),
                                         (24, 104, 104, 64, 32), (1, 20, 37, 32, 32),
                                         (3, 9, 17, 32, 64), (2, 16, 24, 64, 32),
                                         (1, 5, 7, 64, 64), (1, 1, 1, 32, 32),
                                         (3, 40, 70, 64, 64)])
def test_fwd_schedule_covers_every_tile_once(b, h, w, ci, co):
    """K6's schedule gives each 8 x 16 cell tile of the ragged plane to
    exactly one contiguous range, leaves no range empty, gives every range
    one CTA per column slice of the output, and launches at most FWD_SMS
    CTAs (one range per slice at least)."""
    ctas, per = SC.fwd_schedule(b, h, w, ci, co)
    nh = 4 * co // SC.fwd_cols(ci)
    assert SC.fwd_cols(ci) * 16 * ci * 2 == 128 * 1024  # the resident 128 KB slice
    assert ctas % nh == 0
    tr, tw = SC.TILE_CELLS
    tiles = b * -(-h // tr) * -(-w // tw)
    owner = np.full((tiles, nh), -1)
    for i in range(ctas):
        g, s = divmod(i, nh)
        lo, hi = g * per, min(tiles, (g + 1) * per)
        assert lo < hi, f"range {g} is empty"
        assert (owner[lo:hi, s] == -1).all()
        owner[lo:hi, s] = i
    assert (owner >= 0).all()
    assert ctas <= max(SC.FWD_SMS, nh)


def test_fwd_schedule_depends_on_the_shapes_alone():
    """K6's schedule is a function of (B, H, W, ci, co): the same in every
    call, whatever the thread or device state; the main path's conv2
    forward and dgrad take 129 CTAs of 17 of its 2184 tiles, conv3's
    forward and dgrad 130 CTAs (65 ranges of 34 tiles, two column slices
    each)."""
    shapes = [(24, 104, 104, 32, 32), (24, 104, 104, 32, 64), (24, 104, 104, 64, 32)]
    first = [SC.fwd_schedule(*s) for s in shapes]
    torch.manual_seed(7)
    with torch.no_grad():
        again = [SC.fwd_schedule(*s) for s in reversed(shapes)][::-1]
    assert first == again
    assert first == [(129, 17), (130, 34), (130, 34)]
    assert SC.fwd_schedule(24, 104, 104, 32, 32) != SC.fwd_schedule(24, 96, 104, 32, 32)


@pytest.mark.parametrize("b,h,w,ci,co", [(24, 104, 104, 32, 32), (24, 104, 104, 32, 64),
                                         (24, 104, 104, 64, 32), (24, 104, 104, 64, 64),
                                         (2, 5, 7, 32, 32), (1, 1, 1, 64, 64)])
def test_wgrad_f32_schedule_covers_every_cell_once(b, h, w, ci, co):
    """K6b-f32's chunks: multiples of 32 cells that cover every cell once,
    none empty, at most WGRAD_F32_CTAS CTAs (one per chunk and [128, 128]
    block of the packed gradient), and a function of the shapes alone."""
    chunks, chunk = SC.wgrad_f32_schedule(b, h, w, ci, co)
    cells = b * h * w
    assert chunk % 32 == 0 and chunk >= 32
    assert (chunks - 1) * chunk < cells <= chunks * chunk
    blocks = (16 * ci // 128) * (4 * co // 128)
    assert chunks * blocks <= max(SC.WGRAD_F32_CTAS, blocks)
    assert SC.wgrad_f32_schedule(b, h, w, ci, co) == (chunks, chunk)


@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (64, 32), (64, 64)])
def test_fwd_f32_slot_rows_skip_only_structural_zeros(ci, co):
    """K6-f32's slot-rows per 128-column tile (fwd_f32_slot_rows, the
    mirror of the kernel's k_range): a slot-row is skipped exactly where its
    blocks of pack_s1's layout are zero in every column of the tile; at co
    64 each tile skips one of the four, at co 32 none."""
    wp = SC.pack_s1(torch.ones(3, 3, ci, co))
    for n0 in range(0, 4 * co, 128):
        lo, hi = SC.fwd_f32_slot_rows(co, n0)
        for t in range(4):
            nonzero = bool(wp[t * 4 * ci:(t + 1) * 4 * ci, n0:n0 + 128].any())
            assert nonzero == (lo <= t < hi), (n0, t)
        assert hi - lo == (3 if co == 64 else 4)


def test_f32_planes_workspaces():
    """K6-f32's and K6b-f32's TF32 planes workspaces, in floats: wp's hi and
    lo planes [4co, 16ci] (1 MB at each of the stem's widths), dy's [4co,
    cells] with the cells rounded up to 4 (266 MB at conv2 of the main path,
    532 MB at conv3)."""
    for ci, co in ((32, 32), (32, 64), (64, 32)):
        assert SC.fwd_f32_planes(ci, co) == 2 * 4 * co * 16 * ci
        assert SC.fwd_f32_planes(ci, co) * 4 <= 2**20
    assert SC.wgrad_f32_planes(24, 104, 104, 32) * 4 == 265_814_016
    assert SC.wgrad_f32_planes(24, 104, 104, 64) * 4 == 531_628_032
    assert SC.wgrad_f32_planes(1, 1, 5, 32) == 2 * 128 * 8
    assert SC.wgrad_f32_planes(1, 2, 2, 64) == 2 * 256 * 4


def test_fp32_s2d_wrappers_run_their_twins_on_the_cpu():
    """On CPU tensors K6's and K6b's wrappers are the plain twins, in fp32
    (the output fp32, the packed gradient f32), and launch nothing at either
    dtype's counter."""
    ci, co = 32, 64
    x = torch.relu(T(_rand(9, 2, 5, 7, 4 * ci)))
    dy = T(_rand(10, 2, 5, 7, 4 * co))
    wp = SC.pack_s1(T(_rand(11, 3, 3, ci, co, scale=0.1)))
    counts = lambda: [getattr(f, a) for f in (SC.s2dconv_fwd, SC.s2dconv_wgrad)  # noqa: E731
                      for a in ("launches", "launches_f32")]
    before = counts()
    y = SC.s2dconv_fwd(x, wp, ci, co)
    assert y.dtype == torch.float32 and torch.equal(y, SC.conv_padded_plain(x, wp, ci, co))
    dwp = SC.s2dconv_wgrad(x, dy, ci, co)
    assert dwp.dtype == torch.float32 and torch.equal(dwp, SC.wgrad_plain(x, dy, ci, co))
    assert counts() == before
