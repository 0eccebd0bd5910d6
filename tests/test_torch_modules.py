"""The port's modules (crog_tpu_torch.models) against their flax
counterparts, on the CPU in fp32, with the same randomized weights carried
across by ``state_dict_from_flax``: CLIPRN50 (three visual levels, word
features, sentence state), FPN, TransformerDecoder, MultiTaskProjector.

Each module gets the SAME inputs on both sides (the JAX model's own
intermediates), so a mismatch points at that module.  Tolerance: 2e-5 of the
largest output magnitude — fp32 sums in another order through a handful of
layers, far below any semantic difference (a wrong layout, mask or
resample is off by order 1 of that scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import assert_close_scaled, inputs, tiny_pair

REL = 2e-5


@pytest.fixture(scope="module")
def pair():
    jm, v, tm = tiny_pair()
    img, word = inputs()
    japply = lambda fn, *a: jm.apply(v, *a, method=fn)
    vis = japply(lambda m, x: m.backbone.encode_image(x, False), jnp.asarray(img))
    word_feat, state = japply(lambda m, w: m.backbone.encode_text(w), jnp.asarray(word))
    fq = japply(lambda m, vis, s: m.neck(vis, s, False), vis, state)
    pad = jnp.asarray(word) == 0
    dec = japply(lambda m, fq, w, p: m.decoder(fq, w, p, False), fq, word_feat, pad)
    proj = japply(lambda m, x, s: m.proj(x, s, False), dec, state)
    ref = dict(vis=[np.asarray(x) for x in vis], word=np.asarray(word_feat),
               state=np.asarray(state), fq=np.asarray(fq), pad=np.asarray(pad),
               dec=np.asarray(dec), proj=np.asarray(proj))
    return tm, img, word, ref


T = torch.from_numpy


def test_clip_visual_levels(pair):
    tm, img, _, ref = pair
    with torch.no_grad():
        got = tm.backbone.encode_image(T(img))
    assert len(got) == 3
    for name, g, r in zip(("x2", "x3", "x4_attnpool"), got, ref["vis"]):
        assert_close_scaled(g.numpy(), r, REL, name)


def test_clip_text_tower(pair):
    tm, _, word, ref = pair
    with torch.no_grad():
        feat, state = tm.backbone.encode_text(T(word).long())
    assert_close_scaled(feat.numpy(), ref["word"], REL, "word features")
    assert_close_scaled(state.numpy(), ref["state"], REL, "sentence state")


def test_fpn(pair):
    tm, _, _, ref = pair
    with torch.no_grad():
        got = tm.neck([T(x) for x in ref["vis"]], T(ref["state"]))
    assert_close_scaled(got.numpy(), ref["fq"], REL)


def test_transformer_decoder(pair):
    tm, _, _, ref = pair
    with torch.no_grad():
        got = tm.decoder(T(ref["fq"]), T(ref["word"]), T(ref["pad"]))
    assert_close_scaled(got.numpy(), ref["dec"], REL)


def test_multitask_projector(pair):
    tm, _, _, ref = pair
    with torch.no_grad():
        got = tm.proj(T(ref["dec"]), T(ref["state"]))
    assert got.shape[-1] == 5
    assert_close_scaled(got.numpy(), ref["proj"], REL)
