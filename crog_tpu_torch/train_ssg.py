"""SSG training entry point of the port (counterpart of train_ssg.py).

    python -m crog_tpu_torch.train_ssg --config config/OCID-Grasp/ssg_r50.yaml \\
        [--device cpu] --opts dataset synthetic synthetic_samples 32
    torchrun --standalone --nproc_per_node N -m crog_tpu_torch.train_ssg \\
        --config config/OCID-Grasp/ssg_r50.yaml --opts dataset OCID-Grasp root_dir DIR

Per epoch: ``train_one_epoch`` over shuffled train batches (AdamW,
MultiStepLR by epoch milestones, BatchNorm statistics), then every
``val_freq`` epochs (with ``evaluate``) ``validate`` (per-object J@1/J@5
through the batched post-processing when ``batch_size_val`` > 1), then
``last_model`` is saved and copied to ``best_jindex_model`` on an
improvement; rank 0 also logs the epoch's time, samples/s and J@1/J@5 to
``<output_folder>/<exp_name>/metrics.jsonl``.  ``--device`` defaults to ``cuda`` and raises when there is no
card; on the CPU the model computes in fp32.  Weights start from
``random_init_`` seeded by ``manual_seed``; a ``resume`` checkpoint written
by this CLI restores the model, the optimizer and the schedule.

``wire_format`` picks what the host sends: ``raw`` (the config's) ships the
uint8 frame, bit-packed instance masks, grasp raster parameters and the
drawn augmentation, and the card augments, rasterizes and resizes
(``data/ssg_rawwire.py``); ``legacy`` ships the dense 544^2 targets made on
the host.  ``dataset synthetic`` makes 480 x 640 frames that go through the
reader's host pipeline on the raw wire (``SyntheticOCIDGraspFrames``) and
544^2 scenes on the legacy one (``SyntheticOCIDGrasp``); ``dataset
OCID-Grasp`` reads the tree at ``root_dir``.  The augmentation draws from a
``random.Random`` seeded by ``manual_seed``.  The post-processing maps
predictions into the dataset's frame (``ori_hw``), where its ground-truth
rects are.  With ``visualize``, each validation also writes one figure
under ``<output_folder>/<exp_name>/vis`` (needs matplotlib).

Under torchrun the N ranks split each global batch of ``batch_size`` as
``crog_tpu_torch.train_crog`` does (every N-th sample, ``batch_size // N``
per rank, global BatchNorm statistics, DDP's gradient mean), and
``ssg_losses`` normalizes by the global batch's positive count and draws
the global batch's priorities, so that the step is the one-process step at
the global batch.  One thing differs: each rank's augmentor draws from its
own ``random.Random``, seeded from (``manual_seed``, rank) (one process:
``manual_seed``), so an N-rank run does not replay the one-process run's
augmentation.  Validation reads the same samples at any N
(``ssg_val_loader``: the first 101 batches' worth, each rank every N-th
of them at ``batch_size_val // N``, at least 1), and the per-object hits
are summed over the ranks; rank 0 renders ``visualize`` from the whole
split at ``batch_size_val``, as one process does.  Rank 0 alone logs and
writes the checkpoints and ``metrics.jsonl``, with a barrier after each
write; a ``resume`` restores on every rank.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from functools import partial

import torch

from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list
from crog_tpu_torch.data.loader import DataLoader, Subset
from crog_tpu_torch.data.ocid_grasp import OCIDGraspDataset, collate_ssg
from crog_tpu_torch.data.ssg_rawwire import collate_ssg_raw
from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGrasp, SyntheticOCIDGraspFrames
from crog_tpu_torch.engine import checkpoint as ckpt
from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
from crog_tpu_torch.engine.optim import make_optimizer, set_schedule_step
from crog_tpu_torch.engine.ssg_engine import (
    make_ssg_eval_fwd,
    make_ssg_train_step,
    train_one_epoch,
    validate,
    visualization,
)
from crog_tpu_torch.models.ssg import build_ssg, random_init_
from crog_tpu_torch.models.ssg_eval import make_ssg_post_processing
from crog_tpu_torch.parallel import dist
from crog_tpu_torch.utils.logging import get_logger, setup_logger
from crog_tpu_torch.utils.seed import set_random_seed
from crog_tpu_torch.utils.tracking import MetricsTracker


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


def is_raw_wire(args) -> bool:
    wire = args.get("wire_format", "legacy")
    if wire not in ("raw", "legacy"):
        raise ValueError(f"wire_format {wire!r}: SSG takes raw or legacy")
    return wire == "raw"


def build_ssg_dataset(args, split: str, rng: random.Random):
    """The split's dataset in the config's wire format; ``rng`` feeds its
    augmentor."""
    kw = dict(raw=is_raw_wire(args), max_objs=int(args.get("max_objs", 24)),
              max_rects=int(args.get("max_rects", 16)), rng=rng)
    if args.dataset == "synthetic":
        n = int(args.get("synthetic_samples", 128))
        if kw["raw"]:
            return SyntheticOCIDGraspFrames(num_samples=n, split=split,
                                            img_size=args.img_size,
                                            num_classes=args.num_classes, **kw)
        return SyntheticOCIDGrasp(num_samples=n, split=split, img_size=args.img_size,
                                  num_classes=args.num_classes)
    return OCIDGraspDataset(args.root_dir, split, img_size=args.img_size,
                            depth_factor=args.depth_factor, with_depth=args.with_depth,
                            with_grasp_masks=args.with_grasp_masks, **kw)


def ssg_collate(args):
    if is_raw_wire(args):
        return collate_ssg_raw
    return partial(collate_ssg, max_objs=int(args.get("max_objs", 24)))


def loss_config(args):
    return dict(pos_iou_thre=args.pos_iou_thre, neg_iou_thre=args.neg_iou_thre,
                masks_to_train=args.masks_to_train, alpha_conf=args.alpha_conf,
                alpha_bbox=args.alpha_bbox, alpha_ins=args.alpha_ins,
                alpha_sem=args.alpha_sem, alpha_grasp=args.alpha_grasp,
                with_grasp_masks=args.with_grasp_masks)


def post_processing(args, anchors, batched: bool, ori_hw):
    """Post-processing into the ``ori_hw`` frame of the dataset's
    ground-truth rects."""
    return make_ssg_post_processing(
        anchors, num_protos=args.num_protos, nms_score_thre=args.nms_score_thre,
        nms_iou_thre=args.nms_iou_thre, top_k=args.top_k,
        max_detections=args.max_detections, ori_hw=ori_hw, batched=batched)


# validate's cap in one process (ssg_engine.validate), in batches of batch_size_val
VAL_BATCHES = 101


def ssg_val_loader(val_ds, batch_size_val: int, collate, world: int = 1,
                   rank: int = 0) -> DataLoader:
    """What validation reads: the first ``VAL_BATCHES * batch_size_val``
    samples of the split, as one process reads them; on rank ``rank`` of
    ``world``, every ``world``-th of those at ``batch_size_val // world``
    (at least 1), so that the ranks together read each of them once,
    however many ranks there are."""
    n = min(len(val_ds), VAL_BATCHES * batch_size_val)
    return DataLoader(Subset(val_ds, range(n)), max(1, batch_size_val // world),
                      num_workers=1, collate_fn=collate, num_hosts=world, host_id=rank)


def main(argv=None):
    args, device_name = get_parser(argv)
    device = dist.init_from_env(device_name)
    lead = dist.is_lead()
    out_dir = os.path.join(args.output_folder, args.exp_name)
    setup_logger(out_dir, distributed_rank=dist.rank(), filename="train.log")
    logger = get_logger()
    generator = set_random_seed(args.manual_seed)
    set_exact_fp32_matmul()
    logger.info(f"Device: {device}; {dist.world()} rank(s)")
    logger.info(str(args))

    aug_seed = (args.manual_seed if dist.world() == 1
                else dist.rank_seed(args.manual_seed, dist.rank()))
    train_ds = build_ssg_dataset(args, args.train_split, random.Random(aug_seed))
    val_ds = build_ssg_dataset(args, args.val_split, random.Random(aug_seed))
    # the plain path on the CPU computes in fp32, whatever compute_dtype says
    net = build_ssg(args, torch.float32 if device.type == "cpu" else None)
    random_init_(net, torch.Generator().manual_seed(args.manual_seed))
    net = net.to(device)
    anchors = net.anchors()
    collate = ssg_collate(args)
    # one loading thread: the augmentor draws from one random.Random, so
    # the draws stay in sample order
    train_loader = DataLoader(train_ds, dist.per_rank(args.batch_size),
                              shuffle=True, drop_last=True, seed=args.manual_seed,
                              num_workers=1, collate_fn=collate,
                              num_hosts=dist.world(), host_id=dist.rank())
    bval = int(args.get("batch_size_val", 1))
    val_loader = ssg_val_loader(val_ds, bval, collate, dist.world(), dist.rank())
    vis_loader = (DataLoader(val_ds, bval, num_workers=1, collate_fn=collate)
                  if args.get("visualize", False) and lead else None)
    steps_per_epoch = len(train_loader)
    optimizer, scheduler = make_optimizer(
        net, base_lr=args.base_lr, lr_multi=1.0, milestones=args.milestones,
        lr_decay=args.lr_decay, steps_per_epoch=steps_per_epoch,
        weight_decay=args.weight_decay)

    start_epoch, best_j1 = args.start_epoch, 0.0
    resume = args.get("resume")
    if resume and os.path.exists(resume):
        payload = ckpt.restore_checkpoint(resume, net, optimizer)
        set_schedule_step(scheduler, payload["step"])
        start_epoch = int(payload["meta"].get("epoch", 0))
        best_j1 = float(payload["meta"].get("best_jindex", 0.0))
        logger.info(f"=> resumed from '{resume}' (epoch {start_epoch})")

    model = dist.wrap_model(net, device)
    train_step = make_ssg_train_step(model, optimizer, scheduler, anchors,
                                     loss_config(args), generator, args.max_norm, device,
                                     max_objs=int(args.get("max_objs", 24)))
    post_fn = post_processing(args, anchors, val_loader.batch_size > 1, val_ds.ori_hw)
    vis_rng = random.Random(args.manual_seed)
    eval_fwd = make_ssg_eval_fwd(net, device)
    tracker = MetricsTracker(out_dir, project="crog_tpu_torch_ssg", name=args.exp_name,
                             config=args) if lead else None

    def save(*names, **kw):
        """``last_model`` (then copied to ``names``) from rank 0; every rank
        waits."""
        if lead:
            ckpt.save_checkpoint(out_dir, net, optimizer, scheduler.last_epoch, **kw)
            for name in names:
                ckpt.copy_best(out_dir, ckpt.LAST, name)
        dist.barrier()

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
        if not (args.get("evaluate", True) and (epoch + 1) % args.val_freq == 0):
            save(epoch=epoch + 1, best_jindex=best_j1)
            continue
        j1, j5 = validate(val_loader, post_fn, eval_fwd, epoch + 1, args,
                          max_batches=len(val_loader))
        if tracker is not None:
            tracker.log({"val/j_index@1": j1, "val/j_index@5": j5}, step=epoch + 1)
        if vis_loader is not None:
            # batch-1 post-processing: it keeps the full-resolution maps
            visualization(vis_loader, post_processing(args, anchors, False, val_ds.ori_hw),
                          eval_fwd, epoch + 1, os.path.join(out_dir, "vis"), vis_rng)
        net.train()
        save(*([ckpt.BEST_J] if j1 > best_j1 else []), epoch=epoch + 1, best_jindex=best_j1)
        if j1 > best_j1:
            best_j1 = j1
            logger.info(f"=> new best J@1 {100 * best_j1:.2f}")
    if tracker is not None:
        tracker.finish()
    logger.info("* SSG training finished *")


if __name__ == "__main__":
    main()
