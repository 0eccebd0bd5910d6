"""The port's CLIP ViT family (crog_tpu_torch/models/clip.py ``CLIPViT``,
``models/convert.py`` ``infer_clip_config``, ``build_clip``,
``clip_state_dict_from_flax``, ``clip_from_state_dict``) against
crog_tpu's, mirroring tests/test_clip_vit.py on the CPU in fp32.

A seeded ViT state dict in the OpenAI CLIP key schema at res 128 with patch
16 (8x8 patches and the class token: 65 tokens, so the port's attention
takes the ``FusedAttention`` route that K1 / K1b take on the card; a
17-token case would skip it), 2 layers of width 128 (2 heads of 64).  The
JAX package converts it (``convert_clip_state_dict``); the port's new
converter carries the flax variables back.

Tolerance: 1e-4 of each output's largest magnitude (``assert_close_scaled``)
for the image features, the text tokens, the EOT state and the image
gradient: fp32 sums in another order through two blocks, far below a wrong
layout, slice or head split (order 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crog_tpu.models.clip import CLIPRN50 as JaxCLIPRN50
from crog_tpu.models.convert import build_clip as jax_build_clip
from crog_tpu.models.convert import convert_clip_state_dict
from crog_tpu.models.convert import infer_clip_config as jax_infer_clip_config
from crog_tpu_torch.models import convert
from crog_tpu_torch.models.clip import CLIPRN50, CLIPViT
from crog_tpu_torch.ops import attention as attn
from tests.torch_port_helpers import assert_close_scaled, randomize

RES, PATCH, WIDTH, LAYERS, OUT = 128, 16, 128, 2, 96
TW, TLAYERS, VOCAB, CTX = 128, 2, 200, 77
TOKENS = (RES // PATCH) ** 2 + 1
REL = 1e-4


def _vit_sd(seed=0):
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.04

    sd = {
        "visual.conv1.weight": r(WIDTH, 3, PATCH, PATCH),
        "visual.class_embedding": r(WIDTH),
        "visual.positional_embedding": r(TOKENS, WIDTH),
        "visual.ln_pre.weight": 1 + r(WIDTH),
        "visual.ln_pre.bias": r(WIDTH),
        "visual.ln_post.weight": 1 + r(WIDTH),
        "visual.ln_post.bias": r(WIDTH),
        "visual.proj": r(WIDTH, OUT),
        "text_projection": r(TW, OUT),
        "positional_embedding": r(CTX, TW),
        "token_embedding.weight": r(VOCAB, TW),
        "ln_final.weight": 1 + r(TW),
        "ln_final.bias": r(TW),
        "logit_scale": np.asarray(np.log(1 / 0.07), np.float32),
    }
    for tower, n, w in (("visual.transformer", LAYERS, WIDTH), ("transformer", TLAYERS, TW)):
        for i in range(n):
            p = f"{tower}.resblocks.{i}"
            sd[f"{p}.attn.in_proj_weight"] = r(3 * w, w)
            sd[f"{p}.attn.in_proj_bias"] = r(3 * w)
            sd[f"{p}.attn.out_proj.weight"] = r(w, w)
            sd[f"{p}.attn.out_proj.bias"] = r(w)
            sd[f"{p}.ln_1.weight"] = 1 + r(w)
            sd[f"{p}.ln_1.bias"] = r(w)
            sd[f"{p}.ln_2.weight"] = 1 + r(w)
            sd[f"{p}.ln_2.bias"] = r(w)
            sd[f"{p}.mlp.c_fc.weight"] = r(4 * w, w)
            sd[f"{p}.mlp.c_fc.bias"] = r(4 * w)
            sd[f"{p}.mlp.c_proj.weight"] = r(w, 4 * w)
            sd[f"{p}.mlp.c_proj.bias"] = r(w)
    return sd


def _inputs(res=RES, seed=1):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, res, res, 3).astype(np.float32)
    word = np.zeros((2, 17), np.int32)
    word[:, 0] = 5
    word[0, 1:6] = rng.randint(1, 100, 5)
    word[1, 1:9] = rng.randint(1, 100, 8)
    word[0, 6] = word[1, 9] = VOCAB - 1  # EOT = max id
    return img, word


@pytest.fixture(scope="module")
def vit():
    """(reference-key sd, the JAX model, its params, the port's CLIPViT
    holding the weights carried back by the port's converter)."""
    sd = _vit_sd()
    params, stats = convert_clip_state_dict(sd)
    jm = jax_build_clip(jax_infer_clip_config(sd), dtype=jnp.float32)
    port_sd = convert.clip_state_dict_from_flax(params, stats)
    tm = convert.build_clip(convert.infer_clip_config(port_sd))
    convert.load_numpy_state_dict(tm, port_sd)
    return sd, jm, params, tm.eval()


def _resnet_pair():
    """A tiny flax CLIPRN50 with randomized variables, and the port's
    state dict of it through the new converter."""
    jm = JaxCLIPRN50(embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
                     vision_width=16, vocab_size=VOCAB, transformer_width=TW,
                     transformer_heads=2, transformer_layers=1, dtype=jnp.float32)
    img, word = _inputs(64)
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(word), train=False)
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    return jm, v, convert.clip_state_dict_from_flax(v["params"], v["batch_stats"])


def test_converter_round_trips_the_reference_keys(vit):
    sd, _, _, tm = vit
    port_sd = convert.clip_state_dict_from_flax(*convert_clip_state_dict(sd))
    assert set(port_sd) == set(sd) == set(tm.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(port_sd[k], v, err_msg=k)


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_infer_clip_config_and_build_clip_agree_with_jax_package(family, vit):
    sd = vit[0] if family == "vit" else _resnet_pair()[2]
    cfg = convert.infer_clip_config(sd)
    assert cfg == jax_infer_clip_config(sd)
    assert cfg["vision_arch"] == family
    model = convert.build_clip(cfg)
    assert isinstance(model, CLIPViT if family == "vit" else CLIPRN50)
    assert type(jax_build_clip(cfg)).__name__ == ("CLIPViT" if family == "vit"
                                                 else "CLIPRN50")
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert tuple(own[k].shape) == np.shape(v), k


def test_vit_forward_matches_jax_package(vit, monkeypatch):
    sd, jm, params, tm = vit
    img, word = _inputs()
    with jax.default_matmul_precision("highest"):
        j_vis, j_word, j_state = jax.jit(lambda p, i, w: jm.apply(p, i, w, train=False))(
            {"params": params}, jnp.asarray(img), jnp.asarray(word))
    calls = []
    kernel = attn.fused_attention
    monkeypatch.setattr(attn, "fused_attention",
                        lambda q, *a, **k: calls.append(q.shape) or kernel(q, *a, **k))
    with torch.no_grad():
        vis, feat, state = tm(torch.from_numpy(img), torch.from_numpy(word).long())
    assert calls == [(2, TOKENS, WIDTH)] * LAYERS  # the FusedAttention route (K1)
    assert vis.shape == (2, TOKENS - 1, OUT)
    assert_close_scaled(vis.numpy(), np.asarray(j_vis), REL, "image features")
    assert_close_scaled(feat.numpy(), np.asarray(j_word), REL, "text tokens")
    assert_close_scaled(state.numpy(), np.asarray(j_state), REL, "EOT state")


def test_vit_image_gradient_matches_jax_grad(vit, monkeypatch):
    """d/d(image) of <features, G> for a seeded G: the port's autograd
    through FusedAttention's backward (K1b's twin) against jax.grad."""
    _, jm, params, tm = vit
    img, _ = _inputs()
    g = np.random.RandomState(7).randn(2, TOKENS - 1, OUT).astype(np.float32)

    def loss(x):
        feats = jm.apply({"params": params}, x, method=lambda m, x: m.encode_image(x))
        return jnp.sum(feats * g)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(img)))
    calls = []
    bwd = attn.attention_bwd
    monkeypatch.setattr(attn, "attention_bwd",
                        lambda q, *a, **k: calls.append(q.shape) or bwd(q, *a, **k))
    x = torch.from_numpy(img).requires_grad_(True)
    (tm.encode_image(x) * torch.from_numpy(g)).sum().backward()
    assert calls == [(2, TOKENS, WIDTH)] * LAYERS  # K1b's route
    assert_close_scaled(x.grad.numpy(), want, REL, "image gradient")


def test_resnet_family_through_the_converter_matches_jax_package():
    jm, v, port_sd = _resnet_pair()
    img, word = _inputs(64)
    tm = convert.clip_from_state_dict(
        {k: torch.as_tensor(np.asarray(a)) for k, a in port_sd.items()}).eval()
    with jax.default_matmul_precision("highest"):
        (j2, j3, j4), j_word, j_state = jm.apply(v, jnp.asarray(img), jnp.asarray(word),
                                                 train=False)
    with torch.no_grad():
        (x2, x3, x4), feat, state = tm(torch.from_numpy(img), torch.from_numpy(word).long())
    for name, got, want in (("x2", x2, j2), ("x3", x3, j3), ("x4", x4, j4),
                            ("text tokens", feat, j_word), ("EOT state", state, j_state)):
        assert_close_scaled(got.numpy(), np.asarray(want), REL, name)


def test_reference_vit_archive_loads_strictly(vit, tmp_path):
    """A state dict with the OpenAI archive's keys (its weights, logit_scale
    and the three metadata entries its build_model drops) loads through
    ``load_torch_state_dict`` strictly into the CLIPViT it describes; a
    missing key raises."""
    sd, _, _, tm = vit
    path = tmp_path / "ViT-tiny.pt"
    archive = {k: torch.from_numpy(np.asarray(v)).half() for k, v in sd.items()}
    archive.update(input_resolution=torch.tensor(RES), context_length=torch.tensor(CTX),
                   vocab_size=torch.tensor(VOCAB))
    torch.save(archive, path)
    loaded = convert.load_torch_state_dict(str(path))
    model = convert.clip_from_state_dict(loaded)
    assert isinstance(model, CLIPViT) and model.visual.conv1.weight.dtype == torch.float32
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), loaded[k].numpy(), err_msg=k)
    del loaded["visual.ln_post.bias"]
    with pytest.raises(KeyError, match="visual.ln_post.bias"):
        convert.clip_from_state_dict(loaded)


def test_smaller_input_slices_the_positional_embedding(vit):
    """At 64^2 (16 patches) the ViT takes the first 17 rows of its 65-row
    positional embedding, as crog_tpu's does (crog_tpu/models/clip.py:498)."""
    _, jm, params, tm = vit
    img, _ = _inputs(64)
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, jnp.asarray(img),
                        method=lambda m, x: m.encode_image(x))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(img))
    assert got.shape == (2, 16, OUT)
    assert_close_scaled(got.numpy(), np.asarray(want), REL, "image features at 64^2")
