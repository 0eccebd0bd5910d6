"""Shared fixtures for the tests that hold the PyTorch port (crog_tpu_torch)
against the JAX package: a tiny CROG built in flax, its every parameter and
BatchNorm statistic randomized from a numpy seed, and the same weights
carried into the port."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

RES = 128  # -> attention pool grid 4x4, output maps 32x32
VOCAB = 49408  # the real vocabulary: synthetic samples carry real token ids
SOT, EOT = 49406, 49407
TINY = dict(
    word_len=17,
    word_dim=1024,
    vis_dim=512,
    fpn_in=(512, 1024, 1024),
    fpn_out=(256, 512, 1024),
    num_layers=1,
    num_head=8,
    dim_ffn=512,
    dropout=0.1,
)
GEOMETRY = dict(
    input_resolution=RES, clip_resolution=RES, vision_layers=(1, 1, 1, 1),
    transformer_layers=2, vocab_size=VOCAB,
)


def randomize(variables, seed: int = 1):
    """Perturb every flax leaf with numpy noise: BatchNorm variances drawn
    in [0.5, 1.5), every other leaf moved by noise of its own scale (so the
    zero-initialized bn3 scales and biases are nonzero)."""
    r = np.random.RandomState(seed)

    def rnd(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name and "var" in name:
            return (0.5 + r.rand(*x.shape)).astype(np.float32)
        if x.ndim <= 1:
            return (x + 0.1 * r.randn(*x.shape)).astype(np.float32)
        return (x + 0.3 * x.std() * r.randn(*x.shape)
                + 0.01 * r.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, variables)


def inputs(batch: int = 2, seed: int = 42):
    rng = np.random.RandomState(seed)
    img = (rng.randn(batch, RES, RES, 3) * 0.4).astype(np.float32)
    word = np.zeros((batch, TINY["word_len"]), np.int32)
    for i in range(batch):
        n = 4 + 7 * i % 12
        word[i, 0], word[i, 1 : n + 1], word[i, n + 1] = SOT, rng.randint(1, 1000, n), EOT
    return img, word


def tiny_pair(use_grasp_masks: bool = True):
    """(flax CROG, its randomized variables as numpy, the port's CROG in eval
    mode holding the same weights), fp32."""
    from crog_tpu.models.crog import CROG as JaxCROG
    from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax
    from crog_tpu_torch.models.crog import CROG as TorchCROG

    jm = JaxCROG(dtype=jnp.float32, use_grasp_masks=use_grasp_masks, **GEOMETRY, **TINY)
    img, word = inputs()
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(word), train=False
    )
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    tm = TorchCROG(use_grasp_masks=use_grasp_masks, **GEOMETRY, **TINY)
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm.eval()


def assert_close_scaled(got, ref, rel: float, err_msg: str = ""):
    """|got - ref| <= rel * max|ref| elementwise."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale, err_msg=err_msg)
