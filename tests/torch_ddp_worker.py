"""One rank of the two-rank gloo group of tests/test_torch_ddp.py.

Runs as ``python tests/torch_ddp_worker.py DIR`` with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) set: reads
``DIR/inputs.pt`` (numpy inputs and weights the parent made, rank-major
global batches), runs every case of the module on this rank's rows through
``crog_tpu_torch`` on the CPU, and writes ``DIR/rank<R>.pt``.  It imports
no JAX: the parent holds the results against the JAX package.
"""

import hashlib
import os
import sys

# run by path: tests/ is on sys.path, the repo root is not
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from crog_tpu_torch.parallel import dist  # noqa: E402

T = torch.from_numpy


def rows(x, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch (rank-major)."""
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def shard(batch, rank: int, world: int):
    return {k: rows(v, rank, world) for k, v in batch.items()}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal iff bit-equal."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def bn_case(inp, rank, world):
    """Train-mode BatchNorm (or blocked_bn_relu) on this rank's rows: the
    output, dx, this rank's dscale / dbias, the running statistics."""
    from crog_tpu_torch.models.clip import BatchNorm, blocked_bn_relu

    c = inp["scale"].shape[0]
    bn = BatchNorm(c).train()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean0"),
                          ("running_var", "var0")):
            getattr(bn, name).copy_(T(inp[key]))
    x = T(rows(inp["x"], rank, world)).requires_grad_()
    y = blocked_bn_relu(bn, x, c) if inp["blocked"] else bn(x)
    dx, dw, db = torch.autograd.grad(y, (x, bn.weight, bn.bias),
                                     T(rows(inp["cot"], rank, world)))
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "dscale": dw.numpy(),
            "dbias": db.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def _stats(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _tracked(model):
    return {n: int(b) for n, b in model.named_buffers()
            if n.endswith("num_batches_tracked")}


def crog_case(inp, rank, world, remat=False):
    """One DDP train step of the tiny CROG on this rank's rows, with the
    RN50 bottlenecks checkpointed under ``remat``; counts the step's
    ``torch.distributed.all_reduce`` calls (the BatchNorm statistics'
    forward and backward: DDP's gradient buckets go through the reducer)."""
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.models.convert import load_numpy_state_dict
    from crog_tpu_torch.models.crog import CROG

    net = CROG(**inp["geometry"], **inp["cfg"], remat=remat)
    load_numpy_state_dict(net, inp["state_dict"])
    tracked0 = _tracked(net)
    opt, sched = make_optimizer(net, inp["lr"], inp["lr_multi"], [5], 0.1, 1)
    model = dist.wrap_model(net, torch.device("cpu"))
    reduce, calls = torch.distributed.all_reduce, []

    def counted(*args, **kwargs):
        calls.append(1)
        return reduce(*args, **kwargs)

    torch.distributed.all_reduce = counted
    try:
        metrics = make_train_step(model, opt, sched, device="cpu")(
            shard(inp["batch"], rank, world))
    finally:
        torch.distributed.all_reduce = reduce
    metrics = dist.mean_over_ranks(metrics)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "stats": _stats(net),
           "all_reduces": len(calls),
           "tracked": {n: t - tracked0[n] for n, t in _tracked(net).items()},
           "digest": digest([p for p in net.parameters()] + list(net.buffers()))}
    if rank == 0:
        out["grads"] = {n: p.grad.numpy() for n, p in net.named_parameters()
                        if p.grad is not None}
    return out


def ssg_case(inp, rank, world):
    """One DDP train step of the tiny SSG on this rank's rows, its
    priorities drawn for the global batch (the parent's)."""
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.engine.ssg_engine import make_ssg_train_step
    from crog_tpu_torch.models import ssg_loss
    from crog_tpu_torch.models.convert import load_numpy_state_dict
    from crog_tpu_torch.models.ssg import SSG

    net = SSG(**inp["geometry"])
    load_numpy_state_dict(net, inp["state_dict"])
    opt, sched = make_optimizer(net, inp["lr"], 1.0, [100], 0.95, 10,
                                weight_decay=inp["wd"])
    model = dist.wrap_model(net, torch.device("cpu"))
    step = make_ssg_train_step(model, opt, sched, inp["anchors"], inp["loss_cfg"],
                               device="cpu")
    drawn = []

    def draw(shape, generator=None):
        drawn.append(tuple(shape))
        return T(inp["priority"])

    ssg_loss.draw_priority = draw
    metrics = dist.mean_over_ranks(step(shard(inp["batch"], rank, world)))
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "stats": _stats(net),
           "drawn": drawn, "digest": digest([p for p in net.parameters()]
                                            + list(net.buffers()))}
    if rank == 0:
        out["params"] = {n: p.detach().numpy() for n, p in net.named_parameters()}
        out["grads"] = {n: p.grad.numpy() for n, p in net.named_parameters()}
    return out


def validate_case(inp):
    """validate_with_grasp over this rank's shard of the val split."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG
    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
    from crog_tpu_torch.models.convert import load_numpy_state_dict
    from crog_tpu_torch.models.crog import CROG

    net = CROG(**inp["geometry"], **inp["cfg"])
    load_numpy_state_dict(net, inp["state_dict"])
    ds = SyntheticOCIDVLG(num_samples=inp["samples"], split="val",
                          input_size=inp["geometry"]["input_resolution"])
    loader = DataLoader(ds, inp["batch"] // dist.world(), pad_last_batch=True,
                        num_workers=1, num_hosts=dist.world(), host_id=dist.rank())
    batches = list(loader)
    result = validate_with_grasp(batches, make_eval_step(
        net.eval(), input_size=inp["geometry"]["input_resolution"], device="cpu"))
    return {"result": result, "n_valid": [int(b.get("n_valid", len(b["word"])))
                                          for b in batches]}


def ssg_validate_case(inp, rank, world):
    """SSG's validate over this rank's rows of a batch and of made-up
    detections: [j1, j5] with the hits summed over the ranks."""
    from crog_tpu_torch.engine.ssg_engine import validate
    from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing

    out = {k: T(rows(x, rank, world)) for k, x in inp["outputs"].items()}
    post = make_ssg_post_processing(inp["anchors"], batched=True, **inp["post_kw"])
    args = type("Args", (), {"epochs": 1})()
    return validate([shard(inp["batch"], rank, world)], post, lambda _: (out, None), 1, args)


def cli_case(inp):
    """train_crog's main under this group, the tiny CROG in place of
    build_crog's."""
    from crog_tpu_torch import train_crog
    from crog_tpu_torch.models.crog import CROG

    train_crog.build_crog = lambda *_, **__: CROG(**inp["geometry"], **inp["cfg"])
    train_crog.main(inp["argv"])
    return {}


def main(indir: str):
    torch.set_num_threads(1)
    dist.init_from_env("cpu")
    rank, world = dist.rank(), dist.world()
    inp = torch.load(os.path.join(indir, "inputs.pt"), weights_only=False)
    out = {"world": world,
           "gather": dist.gather_metrics(np.arange(3 if rank == 0 else 1) + 10 * rank)}
    for kind in ("bn", "blocked"):
        out[kind] = bn_case(inp[kind], rank, world)
    out["crog"] = crog_case(inp["crog"], rank, world)
    out["crog_remat"] = crog_case(inp["crog"], rank, world, remat=True)
    out["ssg"] = ssg_case(inp["ssg"], rank, world)
    out["val"] = validate_case(inp["val"])
    out["ssg_val"] = ssg_validate_case(inp["ssg_val"], rank, world)
    out["cli"] = cli_case(inp["cli"])
    torch.save(out, os.path.join(indir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
