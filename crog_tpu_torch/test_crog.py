"""CROG evaluation entry point of the port (counterpart of test_crog.py).

Runs the eval split and reports mask IoU, Pr@50-90, J@1 and J@5:

    python -m crog_tpu_torch.test_crog --config config/OCID-VLG/crog_synthetic_r50.yaml \\
        [--device cpu] [--fused-stem] --opts synthetic_samples 48

The batches come in the config's ``wire_format`` (rawlb in every OCID-VLG
config) and are unpacked on the device; ``stem_s2d`` comes from the config
and ``--fused-stem`` runs the s2d stem's stride-1 convs through K6/K6b.
``--device`` defaults to ``cuda`` and raises when there is no card.  A
``resume`` file (a reference CROG ``.pth`` or a checkpoint of
``crog_tpu_torch.train_crog``) loads directly; an orbax checkpoint
directory of the JAX package is not supported yet.
"""

from __future__ import annotations

import argparse
import os

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import SequentialLoader
from crog_tpu_torch.data.ocid_vlg import wire_kwargs
from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
from crog_tpu_torch.models.convert import load_checkpoint
from crog_tpu_torch.models.crog import build_crog
from crog_tpu_torch.utils.logging import get_logger, setup_logger


def get_parser(argv=None):
    parser = argparse.ArgumentParser(description="CROG evaluation (PyTorch)")
    parser.add_argument(
        "--config", default="config/OCID-VLG/crog_multiple_r50.yaml", type=str
    )
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument(
        "--fused-stem", action="store_true",
        help="run the s2d stem's stride-1 convs through the K6/K6b kernels",
    )
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_cfg_from_cfg_file(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    return cfg, args.device, args.fused_stem


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu to "
            "run the plain PyTorch path)"
        )
    return device


def build_dataset(args, split: str):
    """The split's dataset, emitting batches in the config's
    ``wire_format`` (legacy when the config has none)."""
    kw = wire_kwargs(args.get("wire_format", "legacy"))
    if args.dataset != "synthetic":
        raise NotImplementedError(
            "the OCID-VLG reader is not ported yet (ROADMAP queue 1); use "
            "dataset synthetic"
        )
    from crog_tpu_torch.data.synthetic import SyntheticOCIDVLG

    return SyntheticOCIDVLG(
        num_samples=int(args.get("synthetic_samples", 128)),
        split=split,
        input_size=args.input_size,
        word_length=args.word_len,
        **kw,
    )


def load_eval_variables(args, model):
    """Load the ``resume`` checkpoint into ``model`` (reference
    test_crog.py:76-80 loads it strictly)."""
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
        logger.warning(f"checkpoint {resume!r} not found — evaluating fresh weights")
    return model


def main(argv=None):
    args, device_name, fused_stem = get_parser(argv)
    device = resolve_device(device_name)
    setup_logger(os.path.join(args.output_folder, args.exp_name), filename="test.log")
    logger = get_logger()
    logger.info(str(args))
    ds = build_dataset(args, args.test_split)
    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    model = build_crog(args, torch.float32 if device.type == "cpu" else None,
                       fused_stem)
    load_eval_variables(args, model)
    model = model.to(device).eval()
    loader = SequentialLoader(
        ds, int(args.get("batch_size_test", args.get("batch_size_val", 16))),
        pad_last_batch=True,
    )
    eval_step = make_eval_step(
        model, input_size=args.input_size,
        ori_hw=getattr(ds, "max_ori_size", (480, 640)), device=device,
    )
    result = validate_with_grasp(loader, eval_step, with_grasps=args.use_grasp_masks)
    logger.info(
        f"Final: IoU={100 * result['iou']:.2f} "
        + "  ".join(f"{k}={100 * v:.2f}" for k, v in result["prec"].items())
        + f"  J@1={100 * result['j_index@1']:.2f}"
        + f"  J@5={100 * result['j_index@5']:.2f}"
    )
    return result


if __name__ == "__main__":
    main()
