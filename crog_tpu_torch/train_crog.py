"""CROG training entry point of the port (counterpart of train_crog.py).

    python -m crog_tpu_torch.train_crog --config config/OCID-VLG/crog_multiple_r50.yaml \\
        [--device cpu] [--fused-stem] --opts root_path DIR
    torchrun --standalone --nproc_per_node N -m crog_tpu_torch.train_crog \\
        --config config/OCID-VLG/crog_multiple_r50.yaml --opts root_path DIR

The splits come from ``test_crog.build_dataset`` (the OCID-VLG tree at
``root_path``, or the synthetic scenes) through ``DataLoader``: train
shuffled with drop_last on ``workers`` threads, val in order with the tail
padded on ``workers_val`` (``workers_procs`` processes for both when set),
each batch copied to the device on the loader's put stage.  Batches come in
the config's ``wire_format`` (rawlb in every OCID-VLG config), unpacked on
the device; ``--fused-stem`` runs the s2d stem's
stride-1 convs through the K6/K6b kernels, in the model's compute dtype
(K6-f32/K6b-f32 under ``--opts compute_dtype float32``).

Per epoch: ``train_one_epoch`` over shuffled train batches, then (with
``evaluate``) ``validate_with_grasp`` over the val split with the model in
eval mode, then ``last_model`` is saved and copied to ``best_iou_model`` /
``best_jindex_model`` on an improvement; rank 0 also logs the epoch's time,
samples/s and the eval metrics to ``<output_folder>/<exp_name>/metrics.jsonl``
(``utils/tracking.py``).  ``--device`` defaults to ``cuda``
and raises when there is no card; on the CPU the model computes in fp32.
Weights start from ``random_init_`` seeded by ``manual_seed``, the backbone
then from the ``clip_pretrain`` archive when ``use_pretrained_clip`` is set
and the file exists (non-strict: the ``connect`` branch keeps its init); a
``resume``
checkpoint written by this CLI restores the model, the optimizer and the
schedule.

Under torchrun (``parallel/dist.py``) each of the N processes drives one
card (``cuda:LOCAL_RANK``; ``--device cpu`` runs the ranks on the CPU over
gloo), with the semantics of the JAX package's data mesh: the global batch
is ``batch_size`` and each rank loads every N-th sample of the shuffled
order, ``batch_size // N`` per step (``batch_size_val // N`` for val, the
tails padded); BatchNorm statistics are the global batch's; DDP averages
the gradients, which the clipping sees; the logged metrics are means over
the ranks and the eval metrics are gathered over the whole split.  Rank 0
alone logs and writes the checkpoints and ``metrics.jsonl``, with a barrier
after each write; a ``resume`` restores on every rank.  Without torchrun's
environment it runs in one process with no process group.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import DataLoader, DevicePut
from crog_tpu_torch.engine import checkpoint as ckpt
from crog_tpu_torch.engine.crog_engine import (
    make_eval_step,
    make_train_step,
    set_exact_fp32_matmul,
    train_one_epoch,
    validate_with_grasp,
)
from crog_tpu_torch.engine.optim import make_optimizer, set_schedule_step
from crog_tpu_torch.models.convert import load_torch_state_dict, merge_pretrained_clip
from crog_tpu_torch.models.crog import build_crog, random_init_
from crog_tpu_torch.parallel import dist
from crog_tpu_torch.test_crog import build_dataset, eval_loader
from crog_tpu_torch.utils.logging import get_logger, setup_logger
from crog_tpu_torch.utils.seed import set_random_seed
from crog_tpu_torch.utils.tracking import MetricsTracker


def get_parser(argv=None):
    parser = argparse.ArgumentParser(description="CROG training (PyTorch)")
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


def load_pretrained_clip(args, model) -> None:
    """use_pretrained_clip semantics (reference model/crog.py:20-23): the
    ``clip_pretrain`` archive loads into the backbone non-strictly; a
    missing archive keeps the fresh initialization, as the JAX package
    does."""
    logger = get_logger()
    path = args.get("clip_pretrain")
    if not args.get("use_pretrained_clip", True):
        logger.info("Load pretrained CLIP: False")
    elif not path or not os.path.exists(path):
        logger.warning(f"clip_pretrain checkpoint not found at {path!r}; "
                       "backbone keeps fresh initialization")
    else:
        keys = merge_pretrained_clip(model, load_torch_state_dict(path))
        logger.info(f"Load pretrained CLIP: True ({path}, {len(keys)} tensors)")


def main(argv=None):
    args, device_name, fused_stem = get_parser(argv)
    device = dist.init_from_env(device_name)
    lead = dist.is_lead()
    out_dir = os.path.join(args.output_folder, args.exp_name)
    setup_logger(out_dir, distributed_rank=dist.rank(), filename="train.log")
    logger = get_logger()
    generator = set_random_seed(args.manual_seed)
    set_exact_fp32_matmul()
    logger.info(f"Device: {device}; {dist.world()} rank(s)")
    logger.info(str(args))

    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    net = build_crog(args, torch.float32 if device.type == "cpu" else None, fused_stem)
    logger.info("Remat (activation checkpointing of the RN50 bottlenecks): "
                + {False: "off", True: "full"}[net.backbone.visual.remat])
    visual = net.backbone.visual
    logger.info("Stem: " + ("plain" if not visual.stem_s2d else
                            "s2d, conv2 and conv3 through K6/K6b" if visual.fused_stem else
                            "s2d, conv2 and conv3 on the library's conv"))
    random_init_(net, torch.Generator().manual_seed(args.manual_seed))
    load_pretrained_clip(args, net)
    net = net.to(device)
    hosts = dict(num_hosts=dist.world(), host_id=dist.rank())
    train_loader = DataLoader(
        build_dataset(args, args.train_split), dist.per_rank(args.batch_size),
        shuffle=True, drop_last=True, seed=args.manual_seed,
        num_workers=int(args.get("workers", 4)),
        num_procs=int(args.get("workers_procs", 0)), device_put_fn=DevicePut(device), **hosts,
    )
    val_ds = build_dataset(args, args.val_split)
    val_loader = eval_loader(args, val_ds, args.batch_size_val, device)
    steps_per_epoch = len(train_loader)
    optimizer, scheduler = make_optimizer(
        net, base_lr=args.base_lr, lr_multi=args.lr_multi, milestones=args.milestones,
        lr_decay=args.lr_decay, steps_per_epoch=steps_per_epoch,
        weight_decay=args.weight_decay,
    )

    start_epoch = args.start_epoch
    best_iou, best_jindex = 0.0, 0.0
    resume = args.get("resume")
    if resume and os.path.exists(resume):
        payload = ckpt.restore_checkpoint(resume, net, optimizer)
        set_schedule_step(scheduler, payload["step"])
        meta = payload["meta"]
        start_epoch = int(meta.get("epoch", 0))
        best_iou = float(meta.get("best_iou", 0.0))
        best_jindex = float(meta.get("best_jindex", 0.0))
        logger.info(f"=> resumed from '{resume}' (epoch {start_epoch})")

    model = dist.wrap_model(net, device)
    train_step = make_train_step(model, optimizer, scheduler, args.use_grasp_masks,
                                 args.max_norm, generator, device)
    eval_step = make_eval_step(net, input_size=args.input_size,
                               ori_hw=getattr(val_ds, "max_ori_size", (480, 640)),
                               device=device)
    tracker = MetricsTracker(out_dir, project="crog_tpu_torch", name=args.exp_name,
                             config=args) if lead else None

    def save(*names, **kw):
        """``last_model`` (then copied to ``names``) from rank 0, the
        reference key schema (no ``module.`` prefix); every rank waits."""
        if lead:
            ckpt.save_checkpoint(out_dir, net, optimizer, scheduler.last_epoch, **kw)
            for name in names:
                ckpt.copy_best(out_dir, ckpt.LAST, name)
        dist.barrier()

    with train_loader, val_loader:
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            train_one_epoch(train_loader, train_step, epoch + 1, args, steps_per_epoch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            seen = steps_per_epoch * args.batch_size
            logger.info(f"Epoch {epoch + 1}: {dt:.1f}s, {seen / dt:.2f} samples/s")
            if tracker is not None:
                tracker.log({"train/epoch_time_s": dt, "train/samples_per_s": seen / dt},
                            step=epoch + 1)
            if not args.get("evaluate", True):
                save(epoch=epoch + 1, best_iou=best_iou, best_jindex=best_jindex)
                continue
            net.eval()
            result = validate_with_grasp(val_loader, eval_step, epoch + 1, args,
                                         with_grasps=args.use_grasp_masks)
            net.train()
            if tracker is not None:
                tracker.log({"val/iou": result["iou"], "val/j_index@1": result["j_index@1"],
                             "val/j_index@5": result["j_index@5"],
                             **{f"val/{k}": v for k, v in result["prec"].items()}},
                            step=epoch + 1)
            better_iou = result["iou"] > best_iou
            better_j = result["j_index@1"] > best_jindex
            save(*[name for name, better in ((ckpt.BEST_IOU, better_iou),
                                             (ckpt.BEST_J, better_j)) if better],
                 epoch=epoch + 1, best_iou=best_iou, best_jindex=best_jindex,
                 prec=result["prec"])
            if better_iou:
                best_iou = result["iou"]
                logger.info(f"=> new best IoU {100 * best_iou:.2f}")
            if better_j:
                best_jindex = result["j_index@1"]
                logger.info(f"=> new best J@1 {100 * best_jindex:.2f}")
    if tracker is not None:
        tracker.finish()
    logger.info("* Training finished *")


if __name__ == "__main__":
    main()
