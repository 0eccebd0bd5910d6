"""SSG training entry point of the port (counterpart of train_ssg.py).

    python -m crog_tpu_torch.train_ssg --config config/OCID-Grasp/ssg_r50.yaml \\
        [--device cpu] --opts dataset synthetic wire_format legacy synthetic_samples 32

Per epoch: ``train_one_epoch`` over shuffled train batches (AdamW,
MultiStepLR by epoch milestones, BatchNorm statistics), then every
``val_freq`` epochs (with ``evaluate``) ``validate`` (per-object J@1/J@5
through the batched post-processing when ``batch_size_val`` > 1), then
``last_model`` is saved and copied to ``best_jindex_model`` on an
improvement.  ``--device`` defaults to ``cuda`` and raises when there is no
card; on the CPU the model computes in fp32.  Weights start from
``random_init_`` seeded by ``manual_seed``; a ``resume`` checkpoint written
by this CLI restores the model, the optimizer and the schedule.  Only the
legacy wire format is ported: the config's ``wire_format: raw`` raises.
One process, one device: no tracker and no mesh.
"""

from __future__ import annotations

import argparse
import os
import time
from functools import partial

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import SequentialLoader, ShuffleLoader
from crog_tpu_torch.data.ocid_grasp import OCIDGraspDataset, collate_ssg
from crog_tpu_torch.engine import checkpoint as ckpt
from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
from crog_tpu_torch.engine.optim import make_optimizer, set_schedule_step
from crog_tpu_torch.engine.ssg_engine import (
    make_ssg_eval_fwd,
    make_ssg_train_step,
    train_one_epoch,
    validate,
)
from crog_tpu_torch.models.ssg import build_ssg, random_init_
from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing
from crog_tpu_torch.test_crog import resolve_device
from crog_tpu_torch.utils.logging import get_logger, setup_logger
from crog_tpu_torch.utils.seed import set_random_seed


def get_parser(argv=None):
    parser = argparse.ArgumentParser(description="SSG training (PyTorch)")
    parser.add_argument("--config", default="config/OCID-Grasp/ssg_r50.yaml", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_cfg_from_cfg_file(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    return cfg, args.device


def build_ssg_dataset(args, split: str):
    wire = args.get("wire_format", "legacy")
    if wire != "legacy":
        raise NotImplementedError(
            f"wire_format {wire!r} is not ported yet; pass wire_format legacy")
    if args.dataset == "synthetic":
        from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGrasp

        return SyntheticOCIDGrasp(num_samples=int(args.get("synthetic_samples", 128)),
                                  split=split, img_size=args.img_size,
                                  num_classes=args.num_classes)
    return OCIDGraspDataset(args.root_dir, split)


def loss_config(args):
    return dict(pos_iou_thre=args.pos_iou_thre, neg_iou_thre=args.neg_iou_thre,
                masks_to_train=args.masks_to_train, alpha_conf=args.alpha_conf,
                alpha_bbox=args.alpha_bbox, alpha_ins=args.alpha_ins,
                alpha_sem=args.alpha_sem, alpha_grasp=args.alpha_grasp,
                with_grasp_masks=args.with_grasp_masks)


def post_processing(args, anchors, batched: bool):
    return make_ssg_post_processing(
        anchors, num_protos=args.num_protos, nms_score_thre=args.nms_score_thre,
        nms_iou_thre=args.nms_iou_thre, top_k=args.top_k,
        max_detections=args.max_detections,
        ori_hw=(480, 640) if args.dataset != "synthetic" else (args.img_size,) * 2,
        batched=batched)


def main(argv=None):
    args, device_name = get_parser(argv)
    device = resolve_device(device_name)
    out_dir = os.path.join(args.output_folder, args.exp_name)
    setup_logger(out_dir, filename="train.log")
    logger = get_logger()
    generator = set_random_seed(args.manual_seed)
    set_exact_fp32_matmul()
    logger.info(f"Device: {device}")
    logger.info(str(args))

    train_ds = build_ssg_dataset(args, args.train_split)
    val_ds = build_ssg_dataset(args, args.val_split)
    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    model = build_ssg(args, torch.float32 if device.type == "cpu" else None)
    random_init_(model, torch.Generator().manual_seed(args.manual_seed))
    model = model.to(device)
    anchors = model.anchors()
    collate = partial(collate_ssg, max_objs=int(args.get("max_objs", 24)))
    train_loader = ShuffleLoader(train_ds, args.batch_size, seed=args.manual_seed,
                                 collate_fn=collate)
    bval = int(args.get("batch_size_val", 1))
    val_loader = SequentialLoader(val_ds, bval, pad_last_batch=False, collate_fn=collate)
    steps_per_epoch = len(train_loader)
    optimizer, scheduler = make_optimizer(
        model, base_lr=args.base_lr, lr_multi=1.0, milestones=args.milestones,
        lr_decay=args.lr_decay, steps_per_epoch=steps_per_epoch,
        weight_decay=args.weight_decay)

    start_epoch, best_j1 = args.start_epoch, 0.0
    resume = args.get("resume")
    if resume and os.path.exists(resume):
        payload = ckpt.restore_checkpoint(resume, model, optimizer)
        set_schedule_step(scheduler, payload["step"])
        start_epoch = int(payload["meta"].get("epoch", 0))
        best_j1 = float(payload["meta"].get("best_jindex", 0.0))
        logger.info(f"=> resumed from '{resume}' (epoch {start_epoch})")

    train_step = make_ssg_train_step(model, optimizer, scheduler, anchors,
                                     loss_config(args), generator, args.max_norm, device)
    post_fn = post_processing(args, anchors, batched=bval > 1)
    eval_fwd = make_ssg_eval_fwd(model, device)
    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        train_one_epoch(train_loader, train_step, epoch + 1, args, steps_per_epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        logger.info(f"Epoch {epoch + 1}: {dt:.1f}s, "
                    f"{steps_per_epoch * args.batch_size / dt:.2f} samples/s")
        step = scheduler.last_epoch
        if args.get("evaluate", True) and (epoch + 1) % args.val_freq == 0:
            j1, _ = validate(val_loader, post_fn, eval_fwd, epoch + 1, args)
            model.train()
            ckpt.save_checkpoint(out_dir, model, optimizer, step, epoch + 1,
                                 best_jindex=best_j1)
            if j1 > best_j1:
                best_j1 = j1
                ckpt.copy_best(out_dir, ckpt.LAST, ckpt.BEST_J)
                logger.info(f"=> new best J@1 {100 * best_j1:.2f}")
        else:
            ckpt.save_checkpoint(out_dir, model, optimizer, step, epoch + 1,
                                 best_jindex=best_j1)
    logger.info("* SSG training finished *")


if __name__ == "__main__":
    main()
