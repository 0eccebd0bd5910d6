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


def tiny_pair(use_grasp_masks: bool = True, use_contrastive: bool = True):
    """(flax CROG, its randomized variables as numpy, the port's CROG in eval
    mode holding the same weights), fp32."""
    from crog_tpu.models.crog import CROG as JaxCROG
    from crog_tpu_torch.models.convert import load_numpy_state_dict, state_dict_from_flax
    from crog_tpu_torch.models.crog import CROG as TorchCROG

    kinds = dict(use_grasp_masks=use_grasp_masks, use_contrastive=use_contrastive)
    jm = JaxCROG(dtype=jnp.float32, **kinds, **GEOMETRY, **TINY)
    img, word = inputs()
    v = jax.jit(jm.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(word), train=False
    )
    v = randomize(jax.tree_util.tree_map(np.asarray, v))
    tm = TorchCROG(**kinds, **GEOMETRY, **TINY)
    load_numpy_state_dict(tm, state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm.eval()


def assert_close_scaled(got, ref, rel: float, err_msg: str = ""):
    """|got - ref| <= rel * max|ref| elementwise."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale, err_msg=err_msg)


def train_batch(n: int = 2):
    """Synthetic train targets at RES for ``n`` samples; images and
    sentences from ``inputs`` (unlike sentences: near-equal text states
    would make the FPN's txt_proj BatchNorm divide by a vanishing
    variance)."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

    ds = SyntheticOCIDVLG(num_samples=n, split="train", input_size=RES)
    batch = next(iter(DataLoader(ds, n)))
    batch["img"], batch["word"] = inputs(n)
    return batch


def jax_train_grads(jm, v, batch):
    """One train-mode forward and backward of the flax CROG ``jm`` on
    ``batch`` (dropout key 0): (loss, the gradients, the parameters with the
    updated BatchNorm statistics), the last two as the port's state_dicts."""
    from crog_tpu.engine import crog_engine as JE
    from crog_tpu.models import crog as JM
    from crog_tpu_torch.models.convert import state_dict_from_flax

    dense = {k: jnp.asarray(batch[k]) for k in JE._TRAIN_KEYS}
    targets = {k: dense[k] for k in ("mask", "qua", "sin", "cos", "wid")}

    def loss_fn(params):
        preds, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                              dense["img"], dense["word"], train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JM.crog_losses(preds, targets, jm.use_grasp_masks)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    zeros = jax.tree_util.tree_map(np.zeros_like, v["batch_stats"])
    return (float(loss), state_dict_from_flax(as_np(grads), zeros),
            state_dict_from_flax(v["params"], as_np(stats)))


def port_train_step(tm, batch):
    """One step of the port's ``make_train_step`` (Adam) on the CPU: (loss,
    {name: gradient}, {name: buffer after the step})."""
    from crog_tpu_torch.engine import optim as TO
    from crog_tpu_torch.engine.crog_engine import make_train_step

    opt, sched = TO.make_optimizer(tm, 1e-3, 0.1, [5], 0.1, 1)
    metrics = make_train_step(tm, opt, sched, device="cpu")(batch)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.requires_grad}
    return (metrics["loss"].item(), grads,
            {n: b.clone() for n, b in tm.named_buffers()})


def assert_step_matches_jax(got, ref):
    """A ``port_train_step`` against ``jax_train_grads`` with the bounds of
    tests/test_torch_train.py::test_train_step_matches_jax: the loss to 1e-4
    relative; each gradient to 2% relative L2 plus 1e-6 of the global
    gradient norm (train-mode BatchNorm over 2 samples makes the tiny
    network's gradients ill-conditioned); the running statistics to 1e-5
    of their scale, 1e-3 on ``neck.norm_layer`` (it normalizes by the
    2-sample txt_proj BatchNorm's output)."""
    loss, grads, buffers = got
    ref_loss, ref_grads, ref_after = ref
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    gnorm = np.sqrt(sum(float(np.sum(np.square(ref_grads[n]))) for n in grads))
    for name, g in grads.items():
        err = np.linalg.norm(g.numpy() - ref_grads[name])
        assert err <= 2e-2 * np.linalg.norm(ref_grads[name]) + 1e-6 * gnorm, f"grad {name}"
    for name, buf in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            tol = 1e-3 if name.startswith("neck.norm_layer") else 1e-5
            assert_close_scaled(buf.numpy(), ref_after[name], tol, name)
