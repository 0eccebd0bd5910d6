"""Per-referring-expression-type evaluation of the port (counterpart of
test_diff_refer_types.py).

    python -m crog_tpu_torch.test_diff_refer_types \\
        --config config/OCID-VLG/crog_multiple_r50.yaml [--device cpu] [--fused-stem] \\
        [--refer-types refer_types.json] --opts root_path DIR
    torchrun --standalone --nproc_per_node N -m crog_tpu_torch.test_diff_refer_types \\
        --config config/OCID-VLG/crog_multiple_r50.yaml --opts root_path DIR

``--refer-types`` maps each expression type (name / loc / attr / rel /
mixed) to indices of the test split; each type's subset (the indices the
split has) is evaluated through ``validate_with_grasp``, in order with the
tail padded, and its IoU, Pr@K, J@1 and J@5 are reported.  The model, the
``resume`` checkpoint, the dataset, the device and the ranks under
torchrun (each evaluates every N-th sample of a subset, the metrics
gathered) are as in ``crog_tpu_torch.test_crog``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import DataLoader, DevicePut, Subset
from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
from crog_tpu_torch.models.crog import build_crog
from crog_tpu_torch.parallel import dist
from crog_tpu_torch.test_crog import build_dataset, load_eval_variables
from crog_tpu_torch.utils.logging import get_logger, setup_logger


def get_parser(argv=None):
    parser = argparse.ArgumentParser(description="CROG per-refer-type evaluation (PyTorch)")
    parser.add_argument("--config", default="config/OCID-VLG/crog_multiple_r50.yaml")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument(
        "--fused-stem", action="store_true",
        help="run the s2d stem's stride-1 convs through the K6/K6b kernels",
    )
    parser.add_argument("--refer-types", default="refer_types.json",
                        help="json mapping refer type -> sample index list")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    cfg = load_cfg_from_cfg_file(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    return cfg, a.device, a.fused_stem, a.refer_types


def evaluate_refer_types(base_ds, refer_types, eval_step, batch_size: int = 16,
                         num_workers: int = 4, with_grasps: bool = True,
                         device_put_fn=None, num_procs: int = 0):
    """Each type's subset of ``base_ds`` through ``validate_with_grasp``:
    {type: result}.  Tails are padded, so every batch has one shape; a
    type with no index in the split is skipped.  Under a process group
    each rank reads every ``world``-th sample of a subset at ``batch_size
    // world``."""
    logger = get_logger()
    results = {}
    for rtype, indices in refer_types.items():
        subset = Subset(base_ds, [i for i in indices if i < len(base_ds)])
        if len(subset) == 0:
            logger.warning(f"refer type {rtype}: no samples in split, skipped")
            continue
        logger.info(f"=== refer type: {rtype} ({len(subset)} samples) ===")
        with DataLoader(subset, max(1, batch_size // dist.world()), num_workers=num_workers,
                        num_procs=num_procs, pad_last_batch=True,
                        device_put_fn=device_put_fn, num_hosts=dist.world(),
                        host_id=dist.rank()) as loader:
            results[rtype] = validate_with_grasp(loader, eval_step, with_grasps=with_grasps)
    return results


def main(argv=None):
    args, device_name, fused_stem, refer_types_path = get_parser(argv)
    device = dist.init_from_env(device_name)
    setup_logger(os.path.join(args.output_folder, args.exp_name),
                 distributed_rank=dist.rank(), filename="test_refer_types.log")
    logger = get_logger()
    with open(refer_types_path) as f:
        refer_types = json.load(f)
    base_ds = build_dataset(args, args.test_split)
    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    model = build_crog(args, torch.float32 if device.type == "cpu" else None, fused_stem)
    load_eval_variables(args, model)
    model = model.to(device).eval()
    eval_step = make_eval_step(model, input_size=args.input_size,
                               ori_hw=getattr(base_ds, "max_ori_size", (480, 640)),
                               device=device)
    results = evaluate_refer_types(
        base_ds, refer_types, eval_step, batch_size=int(args.get("batch_size_test", 16)),
        num_workers=int(args.get("workers_val", 4)), with_grasps=args.use_grasp_masks,
        device_put_fn=DevicePut(device), num_procs=int(args.get("workers_procs", 0)),
    )
    for rtype, r in results.items():
        logger.info(f"{rtype}: IoU={100 * r['iou']:.2f} "
                    + "  ".join(f"{k}={100 * v:.2f}" for k, v in r["prec"].items())
                    + f"  J@1={100 * r['j_index@1']:.2f} J@5={100 * r['j_index@5']:.2f}")
    return results


if __name__ == "__main__":
    main()
