"""CROG evaluation entry point of the port (counterpart of test_crog.py).

Runs the eval split and reports mask IoU, Pr@50-90, J@1 and J@5:

    python -m crog_tpu_torch.test_crog --config config/OCID-VLG/crog_multiple_r50.yaml \\
        [--device cpu] [--fused-stem] --opts root_path DIR
    torchrun --standalone --nproc_per_node N -m crog_tpu_torch.test_crog \\
        --config config/OCID-VLG/crog_multiple_r50.yaml --opts root_path DIR

The split comes from the OCID-VLG tree at ``root_path`` (or the synthetic
scenes of ``dataset synthetic``) through ``DataLoader``: ``workers_val``
threads (``workers_procs`` processes when set), the tail padded, each
batch copied to the device on the loader's put stage.  The batches come in
the config's ``wire_format`` (rawlb in every OCID-VLG config) and are
unpacked on the device; ``visualize`` writes one PNG per sample under
``<output_folder>/<exp_name>/vis``; ``stem_s2d`` comes from the config
and ``--fused-stem`` runs the s2d stem's stride-1 convs through K6/K6b
(K6-f32 under ``--opts compute_dtype float32``).
``--device`` defaults to ``cuda`` and raises when there is no card.  A
``resume`` file (a reference CROG ``.pth`` or a checkpoint of
``crog_tpu_torch.train_crog``) loads directly; an orbax checkpoint
directory of the JAX package is not supported yet.  Under torchrun each of
the N ranks evaluates every N-th sample of the split at ``batch_size_val //
N`` (``parallel/dist.py``), and the per-sample metrics are gathered before
the summary, so the result is the whole split's, each sample counted once;
rank 0 alone logs.
"""

from __future__ import annotations

import argparse
import os

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import DataLoader, DevicePut
from crog_tpu_torch.data.ocid_vlg import wire_kwargs
from crog_tpu_torch.engine.crog_engine import inference_with_grasp, make_eval_step
from crog_tpu_torch.models.convert import load_checkpoint
from crog_tpu_torch.models.crog import build_crog, random_init_
from crog_tpu_torch.parallel import dist
from crog_tpu_torch.utils.logging import get_logger, setup_logger


def get_parser(argv=None):
    parser = argparse.ArgumentParser(description="CROG evaluation (PyTorch)")
    parser.add_argument(
        "--config", default="config/OCID-VLG/crog_multiple_r50.yaml", type=str
    )
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument(
        "--fused-stem", action="store_true",
        help="run the s2d stem's stride-1 convs through the K6/K6b kernels "
             "(K6-f32/K6b-f32 at compute_dtype float32)",
    )
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_cfg_from_cfg_file(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    return cfg, args.device, args.fused_stem


def build_dataset(args, split: str):
    """The split's dataset (counterpart of train_crog.py:60-115): the
    synthetic scenes, or the OCID-VLG tree at ``root_path``, emitting
    batches in the config's ``wire_format`` (without one: compact, or
    legacy when ``compact_transfer`` is False).  ``cache_samples`` (True:
    a 4 GiB bound, or a byte count) wraps it in a ``SampleCache``."""
    kw = wire_kwargs(args.get(
        "wire_format", "compact" if args.get("compact_transfer", True) else "legacy"))
    if args.dataset == "synthetic":
        from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

        n = {"train": 512, "val": 128}.get(split, 128)
        ds = SyntheticOCIDVLG(
            num_samples=int(args.get("synthetic_samples", n)), split=split,
            input_size=args.input_size, word_length=args.word_len, **kw,
        )
    else:
        from crog_tpu_torch.data.ocid_vlg import OCIDVLGDataset

        ds = OCIDVLGDataset(
            root_dir=args.root_path, split=split, input_size=args.input_size,
            word_length=args.word_len, version=args.get("version", "multiple"), **kw,
        )
    cache = args.get("cache_samples", False)
    if cache:
        from crog_tpu_torch.data.cache import SampleCache

        ds = SampleCache(ds, max_bytes=(4 << 30) if cache is True else int(cache))
    return ds


def eval_loader(args, ds, batch_size: int, device) -> DataLoader:
    """The eval split's loader: in order, the tail padded to a full batch,
    ``workers_val`` threads (``workers_procs`` processes when set), and the
    copy to ``device`` on the put stage (test_crog.py:88-96); under a
    process group the rank's shard (every ``world``-th sample) at
    ``batch_size // world``."""
    return DataLoader(
        ds, max(1, batch_size // dist.world()), shuffle=False, drop_last=False,
        pad_last_batch=True, num_workers=int(args.get("workers_val", 4)),
        num_procs=int(args.get("workers_procs", 0)), device_put_fn=DevicePut(device),
        num_hosts=dist.world(), host_id=dist.rank(),
    )


def load_eval_variables(args, model):
    """Load the ``resume`` checkpoint into ``model`` (reference
    test_crog.py:76-80 loads it strictly); without one, seeded fresh
    weights."""
    logger = get_logger()
    resume = args.get("resume")
    if resume and os.path.exists(resume):
        if os.path.isdir(resume):
            raise NotImplementedError(
                f"{resume!r}: orbax checkpoints of the JAX package are not "
                "supported by the port yet; pass a torch checkpoint file"
            )
        model.load_state_dict(load_checkpoint(resume), strict=True)
        logger.info(f"=> loaded checkpoint '{resume}'")
    else:
        # fresh weights seeded as train_crog seeds them, so that two runs agree
        random_init_(model, torch.Generator().manual_seed(args.manual_seed))
        logger.warning(f"checkpoint {resume!r} not found — evaluating fresh weights "
                       f"(random_init_, seed {args.manual_seed})")
    return model


def main(argv=None):
    args, device_name, fused_stem = get_parser(argv)
    device = dist.init_from_env(device_name)
    setup_logger(os.path.join(args.output_folder, args.exp_name),
                 distributed_rank=dist.rank(), filename="test.log")
    logger = get_logger()
    logger.info(str(args))
    ds = build_dataset(args, args.test_split)
    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    model = build_crog(args, torch.float32 if device.type == "cpu" else None,
                       fused_stem)
    load_eval_variables(args, model)
    model = model.to(device).eval()
    eval_step = make_eval_step(
        model, input_size=args.input_size,
        ori_hw=getattr(ds, "max_ori_size", (480, 640)), device=device,
    )
    with eval_loader(args, ds, int(args.get("batch_size_test",
                                            args.get("batch_size_val", 16))),
                     device) as loader:
        result = inference_with_grasp(
            loader, eval_step, args, visualize=bool(args.get("visualize", False)),
            vis_dir=os.path.join(args.output_folder, args.exp_name, "vis"))
    logger.info(
        f"Final: IoU={100 * result['iou']:.2f} "
        + "  ".join(f"{k}={100 * v:.2f}" for k, v in result["prec"].items())
        + f"  J@1={100 * result['j_index@1']:.2f}"
        + f"  J@5={100 * result['j_index@5']:.2f}"
    )
    return result


if __name__ == "__main__":
    main()
