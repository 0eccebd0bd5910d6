#!/usr/bin/env python3
"""Drive the PyTorch port (crog_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --kernels   # phases 1-3 and 16 only, no result line
    python3 chip_smoke.py --tools     # phases 1, 2 and 15 only, no result line
    python3 chip_smoke.py --remat     # phases 1, 2 and 17 only, no result line
    python3 chip_smoke.py --fp32      # phases 1, 2 and 18 only, no result line
    python3 chip_smoke.py --long      # phases 1, 2 and 19 only, no result line
    python3 chip_smoke.py --heads     # phases 1, 2 and 20 only, no result line
    python3 chip_smoke.py --wide      # phases 1, 2 and 21 only, no result line

Phases, in order (phase 17 runs after phase 7, phase 18 after phase 17,
phase 19 after phase 18, phase 20 after phase 19, phase 21 after phase 20);
any failure propagates and the exit code is not 0:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from crog_tpu_torch/csrc (nvcc, sm_90a,
     one process per source, all at once: fifteen libraries): K1-K4 and
     the backward kernels K1b-K4b (and their fp32 builds K1-f32..K4b-f32),
     SSG's lincomb loss kernels K5/K5b, and the
     s2d stem's gathered conv K6 (forward and dgrad) and its wgrad K6b (and
     their fp32 builds K6-f32 and K6b-f32);
     the registers, shared memory and spills of the redesigned kernels (the
     attention forward's one- and two-pass kernels at K1's, K2's and K3's
     key counts, with the path ops/attention.py:fwd_path names, and K2's
     and K3's at head dims 8-512; the bf16 attention backward's rows and
     cols kernels at each head dim, and the C mirror of
     ops/attention.py:bwd_path's head-kernel choice; K4's and
     K4b's cluster kernels and their y / dx GEMM; K2's and K3's projection
     GEMM and out-projection cluster kernel; K2b's and K3b's dX and dW
     GEMMs; K1b's one-CTA-per-head kernel; K6; K6b's cluster kernel;
     K6-f32's and K6b-f32's wgmma GEMM with a gathered A);
     then the readers' host ops from crog_tpu_torch/native/hostops.cpp (g++
     -O3 -march=native -ffp-contract=off), with the build time;
  3. hold each kernel against its plain PyTorch twin on the card, in bf16,
     at the shapes of CROG at batch 24 and 416^2 -- the forwards in eval,
     the K2-K4 forwards again with dropout on (the twins draw the same
     counter-based mask), and K1b-K4b on every gradient output with dropout
     on -- and time kernel and twin (and, for K1 and K1b, PyTorch's
     scaled_dot_product_attention and its backward as a yardstick only);
     K4b again with dropout off, and twice at each rate: dx, dh, hn and its
     four column sums must repeat with equal bits; K4, K2b and K3b twice at
     each rate: every output must repeat with equal bits;
     K1b's kernels with the decoder blocks' bf16 cast points must fail
     K1b's tolerance, and K1b on a head of K1B_LONG tokens (its two-kernel
     path) must meet it; K5 and K5b in f32 at SSG's shapes at batch 8 and
     544^2, for both of a train step's launches (instance masks: one task,
     BCE; grasp maps: four tasks, smooth-L1), with the boxes, GT rows and
     GT maps the main path's first SSG step hands them, with made-up boxes,
     and with every box over the whole map (the dense case), each twice
     for equal bits, timed with the bound of the work the function needs
     beside the dense bound and the share of points inside a box; K6 at the
     stem's conv2 and
     conv3 forward and both dgrads and K6b at conv2 and conv3, bf16, at
     batch 24, 104x104 cells, each timed beside its twin, cuDNN's conv of
     the blocked tensor with the zero-embedded kernel (the function K6
     replaces) and cuDNN's plain 3x3 conv of the unblocked 208^2 tensor;
     the attention kernel at the shapes K2 (676 tokens) and K3 (676
     queries, 17 masked keys) launch it with, against its twin and timed
     beside SDPA there; torch.mm at the shapes of the GEMMs inside K2b, K3b
     and K4, and F.linear at those of K2's and K3's projections, timed as
     yardsticks only; K2 and K3 in train mode (dropout on, intermediates
     saved) twice: the output and every saved intermediate must repeat
     with equal bits;
  4. the eval main path: full-width CROG (config/OCID-VLG/
     crog_synthetic_r50.yaml as written: RN50 (3,4,6,3), 416^2, 12-layer
     text tower, 3 decoder layers, dim_ffn 2048, bf16, the rawlb wire
     unpacked on the card, the s2d stem) built with ``fused_stem`` and
     seeded random weights, through ``validate_with_grasp`` over 48
     synthetic val samples at batch 24, with every kernel's launch counter
     checked against the launches one forward makes;
  5. the training main path: the same model in train mode through
     ``train_one_epoch`` for 4 steps at batch 24 (2 prepared rawlb train
     batches, reused), with every forward and backward kernel's launch
     counter checked against the launches one step makes; the loss is
     finite, every trainable parameter and BatchNorm statistic moved; then
     train samples/s over 4 more steps; then one prepared batch in each of
     the legacy, compact and raw wires through one train step (finite loss;
     host bytes per sample and step time), and the stem's forward and
     backward at batch 24 for the plain stem, the s2d stem on cuDNN and the
     s2d stem on K6/K6b;
  6. one sample through the same weights on the card (kernels, bf16) and on
     the CPU (plain PyTorch, fp32): the five logit maps must agree;
  7. one train step's loss and gradients at batch 2, dropout 0, BatchNorm on
     running statistics, on the card (kernels, bf16) and on the CPU (plain
     PyTorch, fp32);
 17. remat (models/clip.py ``checkpointed``): the same model at dropout 0,
     seeded, on phase 5's first prepared batch at 24, one train step with
     remat off, off again (the card's own spread), full and selective from
     the same weights: each mode's loss and per-group gradient rel-L2
     against off within REMAT_GRAD_TOL, its running statistics within
     REMAT_STAT_TOL and its ``num_batches_tracked`` equal to off's, its
     launches equal to off's (PER_STEP); then each mode's ms per train step
     (CUDA events over REMAT_TIMED_STEPS after a warm-up) and the peak
     memory over those steps, full's and selective's at most
     REMAT_PEAK_SHARE of off's; then
     crog_multiple_r50_wo_contrastive.yaml's model (no decoder), seeded:
     one eval forward and one train step on the same batch, finite, with
     no K2-K4b launch; the ``[remat]`` lines;
 18. compute_dtype float32 (after phase 17): (a) K1-f32..K4-f32 and
     K1b-f32..K4b-f32 (3xTF32, csrc/*_f32.cu) against their fp32 twins
     (TF32 off) at the main path's shapes, in eval and (K2-K4) with dropout
     RATE, within F32_REL_L2 on the relative L2 error, and every gradient
     output of the backward with dropout RATE and 0 within F32_BWD_REL_L2
     (K4b's twin on K4b-f32's ReLU decision, which may differ from the
     twin's own only at pre-activations within F32_RELU_TIE of 0); K2b-f32,
     K3b-f32 and K4b-f32 twice at both rates with equal bits; each twin
     with one of its products formed by one TF32 pass or from bf16-staged
     operands must read above its limit against the sound twin; each timed
     beside its twin, SDPA (K1) or its backward (K1b), F.linear at the
     projections' shapes, SDPA's backward at K2b's and K3b's attention
     shapes and torch.mm at those of K2b's and K3b's products, all fp32;
     each product of K4-f32 and K4b-f32 (dW1 and dW2 included) by device
     time beside fp32 cuBLAS at its shape, and of K2b-f32 and K3b-f32 (dO,
     dX, d(txt), each dW) beside fp32 torch.mm; K6-f32 at the stem's conv2 and
     conv3 forward and both dgrads and K6b-f32 at conv2 and conv3 (batch
     24, 104x104 cells,
     full fp32 values) within F32_REL_L2 and F32_BWD_REL_L2 of their twins,
     twice with equal bits, their twin controls above the limits, each
     timed beside its twin, cuDNN's fp32 conv of the blocked tensor (K6b:
     conv2d_weight of it) and cuDNN's plain 3x3 conv of the unblocked 208^2
     tensor, and by device time split into product, planes and sums beside
     both cuDNN convs' device time; (b) crog_synthetic_r50.yaml with compute_dtype float32 (the
     bf16 model's seeded state_dict), on the plain stem convs and on the
     fused stem: one forward at batch 1 each on the card against the CPU in
     fp32, each logit map within F32_E2E_TOL, launching K1-f32 once,
     K2-f32, K3-f32 and K4-f32 three times each, K6-f32 twice on the fused
     stem and no other kernel; (c) the fused stem's make_eval_step over
     phase 4's first prepared batch at 24 against the CPU: per-sample IoU
     within F32_IOU_TOL, grasp rects equal in validity and position on at
     least F32_RECT_SHARE; (d) the fp32 (plain stem) and the bf16 model's
     batch-1 forward latency, eval samples/s at 24 and peak memory, in
     turns; (e) one fp32 train step at batch 2 (phase 5's first batch),
     dropout 0, BatchNorm on running statistics, the fused stem, card vs
     CPU: the loss within F32_TRAIN_LOSS_TOL and each group's gradient
     within F32_TRAIN_GRAD_TOL, launching K1-f32 and K1b-f32 once,
     K2-K4(b)-f32 three times each, K6-f32 four times, K6b-f32 twice and no
     bf16 kernel; the attention pool's q_proj and k_proj weight gradients
     of the card and of the CPU against float64 at the card's inputs, and
     the CPU's at its own (printed, no limit); (f) the fp32 model on the
     fused stem through ``train_one_epoch`` for 4 steps at 24 on phase 5's
     rawlb batches: the loss finite, every parameter and BatchNorm
     statistic moved, the same launches per step; then train samples/s and peak memory of the fp32
     model on the fused stem, on the plain stem and of the bf16 model, in
     turns; the ``[stem]`` line in fp32 (plain stem, s2d on cuDNN, s2d on
     K6-f32/K6b-f32); (g) ``python -m crog_tpu_torch.train_crog
     --fused-stem --opts compute_dtype float32`` for 3 steps at 8 and one
     eval exits 0; (h) ssg_r50.yaml with compute_dtype float32: one frame
     through the validate path's eval forward, card vs CPU, every output
     within F32_E2E_TOL, and one train step at batch 2 and 256^2 as phase
     11 (K5 and K5b twice each, the loss terms within SSG_LOSS_TOL and
     each group's gradients within SSG_GRAD_TOL); (i) tools/torch_roofline.py
     --fused-stem on crog_multiple_r50.yaml at compute_dtype float32; the
     ``[fp32]`` lines;
 19. CROG at input_size 640 (after phase 18; crog_synthetic_r50.yaml with
     ``input_size 640``: full-width RN50, (640/16)^2 = 1600 decoder tokens,
     401 in the attention pool, seeded weights, the fused stem, the rawlb
     wire): K1 (401 tokens, 32 heads), K2 and K3 (eval), K1b, K2b and K3b
     (dropout RATE) at batch 24 in bf16 and fp32 against their twins under
     phase 3's and phase 18's limits (K2b and K3b twice with equal bits),
     then the attention kernel at K2's and K3's 1600-query steps forward
     and backward (K1b's casts on the rows / cols kernels, K1b-f32 on the
     logsumexp, the blocks' casts), twice with equal bits, each timed
     beside its twin, its bound and SDPA (a yardstick only), and the fp32
     dQ workspace at 676 and 1600 tokens; ``validate_with_grasp`` over 24
     samples at batch 24 with one forward's launches; one sample on the
     card in bf16 (E2E_TOL) and at compute_dtype float32 (F32_E2E_TOL)
     against the CPU in fp32; the bf16 and fp32 eval steps at 24 timed with
     their peak memory, in turns; ``train_one_epoch`` at 24 (bf16) and
     LONG_F32_BATCH (fp32), one step with a step's launches, then
     LONG_TRAIN_STEPS by CUDA events with the peak memory; one fp32 train
     step at batch 2, card vs CPU, under the F32_TRAIN_* limits; K2, K2b,
     K3, K3b and their fp32 builds each launched over the phase's CROG
     runs; the ``[long]`` lines;
 20. other decoder head counts at d_model 512 (after phase 19): K1, K1b,
     K2, K2b, K3 and K3b at head dims 8, 16, 32, 128, 256 and 512 (64, 32,
     16, 4, 2 and 1 heads; K1 and K1b at K2's 676-token step, the blocks at B 24 with 17
     text keys, the backward kernels with dropout RATE) in bf16 and fp32
     against their twins under phase 3's and phase 18's limits (K1, K2b and
     K3b twice with equal bits), each timed beside its twin, its bound and
     SDPA at the same attention shape (a yardstick only; the backend that
     ran at dh 256 and 512 is named); then
     crog_synthetic_r50.yaml with ``num_head`` 16 (head dim 32), 4 (128), 2
     (256) and 1 (512):
     ``validate_with_grasp`` over 48 samples at batch 24 with a forward's
     launches each and the eval rate, ``train_one_epoch`` for
     HEADS_TRAIN_STEPS steps at 24 with a step's launches each, timed by
     CUDA events with the peak memory, one sample card vs CPU in bf16
     (E2E_TOL) and fp32 (F32_E2E_TOL), one train step at batch 2 card vs
     CPU in bf16 (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and fp32 (the F32_TRAIN_*
     limits); K2, K2b, K3, K3b and their fp32 builds each launched over the
     phase's CROG runs; the ``[heads]`` lines;
 21. CROG on the CLIP RN50x64 backbone (after phase 20; RN50X64: vision
     layers (3, 15, 36, 10), width 128, a 1024-wide text tower, so a
     decoder 1024 wide over 8 heads of 128; crog_synthetic_r50.yaml's other
     keys, seeded weights, the s2d stem on cuDNN): K2-K4 and K2b-K4b at
     D 1024 (B 24, 676 tokens) in bf16 and fp32 against their twins under
     phase 3's and phase 18's limits, with the repeats of those phases
     (equal bits), each timed beside its twin, its bound and the library's
     calls at its products' shapes (F.linear, torch.mm, SDPA forward and
     backward; a yardstick only); ``validate_with_grasp`` over 48 samples
     at batch 24 in bf16 and fp32 with a forward's launches (K2, K3, K4
     three times each) and the eval rate and peak memory; one sample card
     vs CPU in bf16 (E2E_TOL) and fp32 (F32_E2E_TOL), one train step at
     batch 2 card vs CPU in bf16 (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and fp32
     (the F32_TRAIN_* limits); ``train_one_epoch`` in both dtypes at the
     first of WIDE_TRAIN_TRIES (batch 24, 16 or 8; remat off, then full)
     that fits, one step with a step's launches, then WIDE_TRAIN_STEPS timed
     with the peak memory; K2-K4b and their fp32 builds each launched over
     the phase's CROG runs; the ``[wide]`` lines;
  8. forward latency at batch 1 and eval samples/s at batch 24;
  9. SSG training at full width (config/OCID-Grasp/ssg_r50.yaml as
     written: RN50 (3,4,6,3), RGB-D, 544^2, 32 classes, 32 prototypes,
     bf16, the raw wire at batch 32) with seeded random weights through
     ``train_one_epoch`` for 4 steps (2 prepared batches of 480x640
     synthetic frames, packed with ``pack_ssg_raw`` and collated with
     ``collate_ssg_raw``, reused: the card augments, rasterizes and resizes
     them), with the launch counters checked (2 K5 and 2 K5b per step,
     nothing else); the loss and its 8 terms are finite and every trainable
     parameter and BatchNorm statistic moved; host bytes per sample and the
     peak device memory; then SSG train samples/s over 4 more steps (a
     batch of 32 that does not fit in memory runs at 16, then 8, said so on
     the ``[ssg-train]`` line); the share of K5/K5b's points inside a box on
     the first raw batch; one more step on a prepared legacy-wire batch of
     8 (finite loss, host bytes per sample, step time);
 10. SSG eval: ``validate`` on the raw wire (batched post-processing into
     the frames' 480x640, J@1/J@5) over 16 synthetic val frames at the
     config's batch_size_val 2, no K5 launch;
 11. one SSG train step at batch 2 and 256^2 (to bound the CPU's time),
     BatchNorm on running statistics, the same positive priorities, on the
     card (kernels, bf16; K5 and K5b launched twice each) and on the CPU
     (plain PyTorch, fp32): the 8 loss terms and each group's gradients
     must agree; then one raw batch of 4
     frames unpacked as the train step does on the card and on the CPU,
     both f32: every plane within ``UNPACK_TOL`` (sin and cos
     ``UNPACK_SIN_COS_TOL``), the binarized maps differing only at 0.5
     ties;
 12. the OCID-VLG configs as written, from disk: an OCID tree of 12 scenes
     (48 referring expressions, tests/ocid_fixture.py:build_ocid_tree,
     imported by path) in a temporary directory, read by
     ``data/ocid_vlg.py:OCIDVLGDataset`` under config/OCID-VLG/
     crog_multiple_r50.yaml as written (RN50 at 416^2, 3 decoder layers,
     d_model 512, the rawlb wire, the s2d stem on K6, batch 24, workers 8,
     workers_val 4) with seeded random weights (the CLIP archive is absent):
     the val split through a one-thread loader without the put stage (the
     reference host batches, and the reader's host time per sample), then
     through the eval CLI's loader (workers_val threads, the put stage)
     over a ``SampleCache``, cold and warm: every host batch equal bit for
     bit to the reference's, the per-sample IoU within READER_IOU_TOL and
     J@1, J@5 and Pr@K equal to the reference run's, the launch counts per
     forward as in phase 4; two refer-type subsets (READER_TYPES of
     refer_types.json) through ``evaluate_refer_types`` with padded tails;
     4 train steps through the train CLI's loader (shuffle, drop_last,
     workers 8, the put stage): finite loss, every parameter and statistic
     moved, the launch counts per step as in phase 5; the readers run on
     the native host ops: the reader's time per sample by part over 12
     frames (the PNG decodes, the rawlb letterbox on the native library, the
     same letterbox in its numpy twin, held against each other on this
     host: within 1 on at most 1e-4 of the pixels); then the rates over
     a larger tree (READER_RATE_SCENES, 12 batches of 24 per epoch): eval
     samples/s cold and warm over two fresh caches, train samples/s with
     the loader on threads and on READER_PROCS processes, one epoch each
     in turn for READER_RATE_ROUNDS rounds, with the loader's wait per
     batch and its share of the pass; the ``[reader]`` line (means with
     the least and the largest run);
 13. data parallelism (crog_tpu_torch/parallel/dist.py): (a) two ranks
     on this one card, in processes of their own over gloo (NCCL refuses
     two ranks on one device), through ``wrap_model`` (DDP) and the train
     steps: 2 CROG steps of crog_multiple_r50.yaml's model (RN50, 416^2,
     3 decoder layers, the s2d stem on K6/K6b, dropout 0, seeded weights) on
     phase 5's first two rawlb batches at 12 per rank, against the same
     steps at 24 in one process: each step's loss terms within
     TRAIN_LOSS_TOL, the first step's per-group gradient rel-L2 within
     TRAIN_GRAD_TOL, the running statistics after both within DDP_STAT_TOL, the
     parameters and buffers of the two ranks equal bit for bit, and each
     kernel's launches over the two steps; the first step's loss terms
     within DDP_TERM_TOL and its BatchNorm batch statistics within
     DDP_BATCH_STAT_TOL; then the same for SSG's config on phase 9's raw
     batches at 16 per rank against 32 (SSG_LOSS_TOL, SSG_GRAD_TOL), and
     SSG's loss alone in fp32 on seeded outputs of its first batch
     (``ssg_loss_case``: the global positive count, DDP_FP32_TOL); every
     limit lies between the sound code and planted faults
     (tools/torch_ddp_faults.py); (b) ``torchrun --nproc_per_node 1`` (NCCL) of
     ``crog_tpu_torch.train_crog`` on the synthetic config (2 steps of 24,
     one eval over 48; at world 1 no DDP and no collective): exit 0 and
     ``metrics.jsonl``; its ``last_model``
     through the one-process ``crog_tpu_torch.test_crog``; (c) the ``[ddp]``
     line: ms per CROG train step at 24 on one NCCL rank through DDP beside
     the model itself (the wrapper's cost on one card, not a scaling
     figure), and the phase's wall time;
 14. the CLIP ViT family (models/clip.py ``CLIPViT``) at the published
     widths of the CLIP paper (Radford et al. 2021, Table 20): ViT-B/16 at
     224^2 (197 tokens x 12 heads, 12 blocks) and ViT-L/14 at 336^2 (577
     tokens x 16 heads, 24 blocks), each with its text tower, seeded
     weights, bf16, batch 16: the forward (K1's launches: one per vision
     block, no K1b) and a backward from the image features (one K1 and one
     K1b per block) checked, every vision gradient finite and nonzero; the
     forward and an AdamW train step timed, the peak memory; K1 (two passes)
     and K1b (one CTA per head at 197, two kernels at 577) at those shapes
     against their twins under K1's and K1b's tolerances, timed beside
     their twins and SDPA's forward and backward (a yardstick only); one
     sample against the CPU in fp32 (VIT_E2E_TOL); the ``[vit]`` lines;
 15. the tools: (b) tools/torch_roofline.py on crog_multiple_r50.yaml's
     eval forward at batch 1 with the s2d stem on K6 (FlopCounterMode over
     the aten ops plus the kernels' work from their shapes, the least bytes,
     the bound, ROOFLINE_ITERS chained forwards by CUDA events): the share
     at most ROOFLINE_SHARE_MAX, and the FLOP count equal to a CPU copy's;
     (a) tools/torch_profile_step.py's region rollup of TOOLS_STEPS CROG
     train steps at batch 24 (the s2d stem on K6/K6b) and TOOLS_STEPS SSG
     train steps at 32 (raw wire): the ``[regions]`` lines, the regions'
     sum within ROLLUP_TOL of the profiler events' device time, fwdbwd
     flows in the trace, K1/K1b and K6/K6b in ``backbone``, K2-K4 and their
     backward kernels in ``decoder``, K5's and K5b's region kernels once per
     step in ``lins`` and in ``lgrasp``, none in ``<other>``, and the launch
     counts per step as in phases 5 and 9; (c) a full-width SSG run through
     tools/torch_ssg_train_supervisor.py (synthetic frames, 2 epochs, no
     validation) whose child (SUPERVISED_TRAINER) faults with an
     out-of-memory error after epoch 1's last_model at any batch above
     SUPERVISED_MAX_OK: two launches, at 8 and 4, the second resumed from
     epoch 1; (d) tools/torch_realdata_drill.py --fixture on the card: the
     metric table of the eval CLI on the 2-scene tree and a seeded
     reference-schema .pth;
 16. the device time per call, from torch.profiler's kernel rows, of K1,
     K1b, K2 and K3 in eval and in train mode (by part: ln_pos, the
     projections, the attention step, the out-projection), K2b and K3b (by
     part: the LN kernels, the dO and dX GEMMs, the attention step, the dW
     GEMMs and the fixed-order sums), K4 (its cluster kernel, its y GEMM,
     the rest), K4b (its own kernels apart from its fixed-order sums and the
     library dW GEMMs), each K5 and K5b launch in each box case (by
     kernel), each K6 and K6b launch and
     their library calls, of the attention kernel and SDPA at K2's and K3's
     shapes, and of the torch.mm and F.linear yardsticks, beside the CUDA-event times of
     phase 3 (last, so that the profiler runs in no timed phase).

Precision: fp32 products on the card run in full fp32 (TF32 off for matmul
and cuDNN) wherever fp32 is compared; the models compute in bf16 but in
phase 18, where they compute in fp32 (the kernels' products 3xTF32).  The
JSON line's fp32 rows count their launches on phase 18's fp32 train path
(f, the fused stem), the bf16 rows theirs on phase 5's.

The second-to-last lines are a JSON ``kernels`` record and the nvidia-smi
line; the last line is ``{"ok": true, "device": {...}}``.  The JSON line's
D 1024 rows (named with ``_d1024``) count their launches on phase 21's
train path of their dtype.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

from crog_tpu_torch.ops import work
from crog_tpu_torch.ops.work import PEAK_F32_TC_FLOPS, bound, lincomb_work, nbytes

SEED = 0
BATCH = 24
SAMPLES = 48
CONFIG = "config/OCID-VLG/crog_synthetic_r50.yaml"
TRAIN_STEPS = 4
RATE = 0.1  # the config's decoder dropout
SSG_CONFIG = "config/OCID-Grasp/ssg_r50.yaml"
SSG_BATCH = 32  # the config's batch_size, on its raw wire
# one legacy-wire SSG step after the main path's, and the batch of K5/K5b's
# ``ssg-batch`` case (the first legacy batch at 8)
SSG_LEGACY_BATCH = 8
SSG_VAL_SAMPLES = 16
SSG_E2E_SIZE = 256
SSG_UNPACK_BATCH = 4
# SSG's raw unpack on the card vs the CPU, both f32 with TF32 off: the same
# arithmetic with the products summed in another order.  Image, depth,
# masks, quality and width are of order 1 and each output sums a few
# products: 1e-5.  sin / cos take the warped degree-unit angle canvas
# (values up to 180, a few roundings of 180 * 2^-24 apart) times 2: 2e-4.
# The binarized ins_ds / sem_ds may differ only where the downsampled mask
# sits within UNPACK_TIE of the 0.5 threshold, on at most UNPACK_FLIP_SHARE
# of the elements.
UNPACK_TOL = 1e-5
UNPACK_SIN_COS_TOL = 2e-4
UNPACK_TIE = 1e-5
UNPACK_FLIP_SHARE = 1e-3
FWD = ("attention", "decoder_self_block", "decoder_cross_block", "ffn")
BWD = tuple(n + "_bwd" for n in FWD)
# launches of each kernel in one CROG forward, and one train step's forward
# and backward (1 attention pool, 3 decoder layers)
# and the s2d stem's conv2 and conv3 (K6; in a step also their dgrads, and
# K6b for their weight gradients)
PER_FORWARD = {"attention": 1, "decoder_self_block": 3, "decoder_cross_block": 3,
               "ffn": 3, "s2dconv": 2}
PER_STEP = {**PER_FORWARD, **{n + "_bwd": k for n, k in PER_FORWARD.items()
                              if n != "s2dconv"}, "s2dconv": 4, "s2dconv_wgrad": 2}
# one SSG train step: the instance-mask and the grasp-map loss, forward and
# backward
SSG_PER_STEP = {"lincomb": 2, "lincomb_bwd": 2}
# K5/K5b vs twin, relative to each output's largest magnitude: both are f32
# with the same products and differ only in the order of the sums over
# 18496 pixels (sums, dcoef) and up to 400 columns (dprotos); a wrong crop,
# GT row or derivative is off by order 1
LINCOMB_REL_TOL = 1e-4
# K6 vs twin, relative to the output's largest magnitude: the same bf16
# operands and products, f32 sums in another order, one bf16 rounding of
# the output, so they differ by at most one bf16 step where a sum lands on
# a rounding boundary (2^-7 at the top binade); a wrong tap or slot is off
# by order 1.  K6b's f32 gradient sums 259584 cells per element in another
# order, held like K5/K5b to 1e-4 of its largest magnitude.
S2D_REL_TOL = 2**-7
S2D_WGRAD_REL_TOL = 1e-4
# the wire formats run once each through a train step beside the main path's
WIRES = ("legacy", "compact", "raw")
# forward kernel vs twin, both bf16 on the same inputs: the twin rounds at
# the same points, so they differ where a reordered f32 sum flips a bf16
# rounding of an intermediate; outputs reach |y| ~ 6, where one bf16 step
# is 2^-5
TOL = {"attention": 3e-2, "decoder_self_block": 0.125,
       "decoder_cross_block": 0.125, "ffn": 0.125}
# backward kernel vs twin, per gradient output, relative to that output's
# largest magnitude: outputs are bf16 (one step is 2^-8 relative at the top
# of a binade) and a reordered f32 sum can flip the bf16 rounding of an
# intermediate (P, dS, dO, dQ, dh) that feeds many outputs; f32 row sums
# (bias and LayerNorm gradients) over 16224 rows see those flips average
# out.  Four bf16 steps; a wrong kernel or mask is off by order 1.
BWD_REL_TOL = 2**-6
# K1b rounds nothing but its outputs (P, dP, dS stay f32), and so does its
# twin: they differ only where a reordered f32 sum lands on a bf16 rounding
# boundary of an output, by one bf16 step of that output (observed on an
# H100: 0.0039 at max |dq| 2, i.e. 2^-9, in 0.24% of the elements).  So each
# output is held to one bf16 step at its largest magnitude, 2^-8 relative,
# and at most 1% of its elements may differ from the twin at all.  The
# share is what sees a lost f32 cast point: rounding P and dS to bf16, as
# the decoder blocks do, moves many outputs by a step while staying within
# 2^-8; ``k1b_cast_check`` shows it on the kernels.
K1B_REL_TOL = 2**-8
K1B_DIFF_SHARE = 0.01
# a head length beyond K1b's one-CTA-per-head kernel (ops/attention.py
# HEAD_MAX_LEN), held to K1b's tolerance on its two-kernel path
K1B_LONG = 300
# card (bf16, kernels) vs CPU (fp32, plain) on one sample: bound on the
# relative L2 error ||card - cpu|| / ||cpu|| of each logit map.  bf16 keeps
# ~3 significant digits and the error grows through the ~70 layers of a
# random network (``random_init_`` keeps the residual branches small to
# bound that growth); a wrong kernel is off by order 1.
E2E_TOL = 0.15


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(device, b=BATCH, l=676, t=17, d=512, f=2048, lp=169, dp=2048,
                  dtype=None):
    """Seeded inputs at the main path's shapes: B=24 at 416^2 gives a 13x13
    attention pool (169 tokens, width 2048, 32 heads) and a 26x26 decoder
    (676 tokens, width 512, 8 heads, 17 text tokens, FFN 2048); ``dy``
    holds an output gradient for each kernel.  Activations and weights in
    ``dtype`` (bf16 unless given; fp32 for phase 18, full fp32 values, so
    that rounding an operand to TF32 or bf16 changes it), vectors f32."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    act = torch.bfloat16 if dtype is None else dtype

    def rnd(*shape, std=1.0, dtype=act):
        return (torch.randn(*shape, generator=g) * std).to(device, dtype)

    lengths = torch.randint(4, t + 1, (b,), generator=g)
    pad = torch.arange(t)[None, :] >= lengths[:, None]  # real padded keys
    blk = lambda: dict(
        in_w=rnd(3 * d, d, std=d**-0.5), in_b=rnd(3 * d, std=0.05, dtype=torch.float32),
        out_w=rnd(d, d, std=d**-0.5), out_b=rnd(d, std=0.05, dtype=torch.float32),
        g_pre=1 + rnd(d, std=0.1, dtype=torch.float32),
        b_pre=rnd(d, std=0.05, dtype=torch.float32),
        g_post=1 + rnd(d, std=0.1, dtype=torch.float32),
        b_post=rnd(d, std=0.05, dtype=torch.float32),
    )
    return {
        "attention": dict(q=rnd(b, lp, dp), k=rnd(b, lp, dp), v=rnd(b, lp, dp),
                          heads=dp // 64),
        "decoder_self_block": dict(x=rnd(b, l, d), pos=rnd(l, d, std=0.5), **blk()),
        "decoder_cross_block": dict(
            x=rnd(b, l, d), txt=rnd(b, t, d), pos=rnd(l, d, std=0.5),
            tpos=rnd(t, d, std=0.5), pad=pad.to(device), **blk()),
        "ffn": dict(x=rnd(b * l, d), w1=rnd(f, d, std=d**-0.5),
                    b1=rnd(f, std=0.05, dtype=torch.float32),
                    g=1 + rnd(f, std=0.1, dtype=torch.float32),
                    be=rnd(f, std=0.05, dtype=torch.float32),
                    w2=rnd(d, f, std=f**-0.5),
                    b2=rnd(d, std=0.05, dtype=torch.float32)),
        "dy": {"attention": rnd(b, lp, dp), "decoder_self_block": rnd(b, l, d),
               "decoder_cross_block": rnd(b, l, d), "ffn": rnd(b * l, d)},
    }


def _args(inp):
    s, c, f = inp["decoder_self_block"], inp["decoder_cross_block"], inp["ffn"]
    sargs = (s["x"], s["pos"], s["in_w"], s["in_b"], s["out_w"], s["out_b"],
             s["g_pre"], s["b_pre"], s["g_post"], s["b_post"], 8)
    cargs = (c["x"], c["txt"], c["pos"], c["tpos"], c["pad"], c["in_w"], c["in_b"],
             c["out_w"], c["out_b"], c["g_pre"], c["b_pre"], c["g_post"],
             c["b_post"], 8)
    fargs = (f["x"], f["w1"], f["b1"], f["g"], f["be"], f["w2"], f["b2"])
    return sargs, cargs, fargs


def kernel_cases(inp):
    """name -> (kernel call, plain call, library call or None, flops, bytes)
    for the forward kernels in eval."""
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    cases = {}
    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    b, l, d = q.shape

    def sdpa(b=b, l=l, d=d):  # the pool's shape, not the blocks' (rebound below)
        split = lambda x: x.view(b, l, h, d // h).transpose(1, 2)
        return F.scaled_dot_product_attention(split(q), split(k), split(v))

    cases["attention"] = (
        lambda: A.fused_attention(q, k, v, h),
        lambda: A.attention_plain(q, k, v, h),
        sdpa,
        work.attention_flops(b, l, l, d),
        nbytes(q, k, v) + nbytes(q),
    )
    sargs, cargs, fargs = _args(inp)
    x = sargs[0]
    b, l, d = x.shape
    cases["decoder_self_block"] = (
        lambda: DB.self_block_fwd(*sargs)[0],
        lambda: DB.self_block_plain(*sargs),
        None,
        work.self_block_flops(b, l, d),
        nbytes(*(t for t in sargs[:-1])) + nbytes(x),
    )
    c = inp["decoder_cross_block"]
    t = c["txt"].shape[1]
    cases["decoder_cross_block"] = (
        lambda: DB.cross_block_fwd(*cargs)[0],
        lambda: DB.cross_block_plain(*cargs),
        None,
        work.cross_block_flops(b, l, t, d),
        nbytes(*(x_ for x_ in cargs[:-1] if x_ is not c["pad"]))
        + b * t * 4 + nbytes(x),  # key mask as f32
    )
    mm, dd = fargs[0].shape
    ff = fargs[1].shape[0]
    cases["ffn"] = (
        lambda: FF.ffn_fwd(*fargs),
        lambda: FF.ffn_plain(*fargs),
        None,
        work.ffn_flops(mm, dd, ff),
        nbytes(*fargs) + nbytes(fargs[0]),
    )
    return cases


def dropout_cases(inp):
    """name -> (kernel call, plain call): the K2-K4 forwards in training,
    dropout on with one seed, so kernel and twin draw the same mask."""
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    sargs, cargs, fargs = _args(inp)
    return {
        "decoder_self_block": (lambda: DB.self_block_fwd(*sargs, SEED + 1, RATE)[0],
                               lambda: DB.self_block_plain(*sargs, SEED + 1, RATE)),
        "decoder_cross_block": (lambda: DB.cross_block_fwd(*cargs, SEED + 2, RATE)[0],
                                lambda: DB.cross_block_plain(*cargs, SEED + 2, RATE)),
        "ffn": (lambda: FF.ffn_fwd(*fargs, SEED + 3, RATE),
                lambda: FF.ffn_plain(*fargs, SEED + 3, RATE)),
    }


def backward_cases(inp):
    """name -> (kernel call, plain call, library call or None, flops, bytes,
    output names): K1b-K4b with dropout on (K1 has none), each kernel call on
    what its forward kernel saved; the bytes in the operands' dtype (bf16,
    or fp32 in phase 18), the weight and bias gradients f32 at fp32."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    cases = {}
    dy = inp["dy"]
    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    b, l, d = q.shape
    do = dy["attention"]
    # at fp32 K1b-f32 reads K1-f32's logsumexp, and its twin the same
    o, lse = (A.fused_attention(q, k, v, h, with_lse=True) if q.dtype == torch.float32
              else (A.fused_attention(q, k, v, h), None))
    split = lambda x: x.view(b, l, h, d // h).transpose(1, 2).detach().requires_grad_()
    qs, ks, vs = split(q), split(k), split(v)
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
    dos = do.view(b, l, h, d // h).transpose(1, 2)
    cases["attention_bwd"] = (
        lambda: A.attention_bwd(q, k, v, o, do, h, lse=lse),
        lambda: A.attention_bwd_plain(q, k, v, o, do, h, lse),
        lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos, retain_graph=True),
        work.attention_bwd_flops(b, l, d), 8 * nbytes(q), ("dq", "dk", "dv"),
    )
    sargs, cargs, fargs = _args(inp)
    x = sargs[0]
    b, l, d = x.shape
    es = x.element_size()
    wbytes = 4 * d * d * es + 8 * d * 4  # dW (in x's dtype) and the bias / LN rows
    _, ssaved = DB.self_block_fwd(*sargs, SEED + 1, RATE, save=True)
    dys = dy["decoder_self_block"]
    cases["decoder_self_block_bwd"] = (
        lambda: DB.self_block_bwd(x, ssaved, dys, 8, SEED + 1, RATE),
        lambda: DB.self_block_bwd_plain(*sargs[:-1], dys, 8, SEED + 1, RATE),
        None, work.self_block_bwd_flops(b, l, d),
        nbytes(x, dys, *ssaved) + nbytes(x) + wbytes,
        ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
         "d_g_post", "d_b_post"),
    )
    t = cargs[1].shape[1]
    _, csaved = DB.cross_block_fwd(*cargs, SEED + 2, RATE, save=True)
    dyc = dy["decoder_cross_block"]
    cases["decoder_cross_block_bwd"] = (
        lambda: DB.cross_block_bwd(cargs[0], csaved, dyc, 8, SEED + 2, RATE),
        lambda: DB.cross_block_bwd_plain(*cargs[:-1], dyc, 8, SEED + 2, RATE),
        None, work.cross_block_bwd_flops(b, l, t, d),
        nbytes(cargs[0], dyc, *csaved) + nbytes(cargs[0]) + b * t * d * es + wbytes,
        ("dx", "dtxt", "d_in_w", "d_in_b", "d_out_w", "d_out_b", "d_g_pre", "d_b_pre",
         "d_g_post", "d_b_post"),
    )
    xf, w1, b1, g, be, w2, _ = fargs
    mm, dd = xf.shape
    ff = w1.shape[0]
    dyf = dy["ffn"]
    cases["ffn_bwd"] = (
        lambda: FF.ffn_bwd(xf, w1, b1, g, be, w2, dyf, SEED + 3, RATE),
        lambda: FF.ffn_bwd_plain(xf, w1, b1, g, be, w2, dyf, SEED + 3, RATE),
        # recompute, dhn, dx, dW1, dW2 (K4b forms dW1 and dW2 as library GEMMs)
        None, work.ffn_bwd_flops(mm, dd, ff),
        nbytes(xf, dyf, w1, w2, b1, g, be) + nbytes(xf) + 2 * dd * ff * 4
        + (3 * ff + dd) * 4,
        ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2"),
    )
    return cases


SOURCES = {
    "attention": ("crog_tpu_torch/csrc/attention.cu",
                  "crog_tpu/ops/pallas_attention.py:111"),
    "decoder_self_block": ("crog_tpu_torch/csrc/decoder_blocks.cu",
                           "crog_tpu/ops/pallas_decoder.py:422"),
    "decoder_cross_block": ("crog_tpu_torch/csrc/decoder_blocks.cu",
                            "crog_tpu/ops/pallas_decoder.py:511"),
    "ffn": ("crog_tpu_torch/csrc/ffn.cu", "crog_tpu/ops/pallas_ffn.py:197"),
    "attention_bwd": ("crog_tpu_torch/csrc/attention_bwd.cu",
                      "crog_tpu/ops/pallas_attention.py:140"),
    "decoder_self_block_bwd": ("crog_tpu_torch/csrc/decoder_blocks_bwd.cu",
                               "crog_tpu/ops/pallas_decoder.py:457"),
    "decoder_cross_block_bwd": ("crog_tpu_torch/csrc/decoder_blocks_bwd.cu",
                                "crog_tpu/ops/pallas_decoder.py:550"),
    "ffn_bwd": ("crog_tpu_torch/csrc/ffn_bwd.cu", "crog_tpu/ops/pallas_ffn.py:234"),
    "lincomb": ("crog_tpu_torch/csrc/lincomb.cu", "crog_tpu/ops/pallas_lincomb.py:225"),
    "lincomb_bwd": ("crog_tpu_torch/csrc/lincomb.cu",
                    "crog_tpu/ops/pallas_lincomb.py:252"),
    "s2dconv": ("crog_tpu_torch/csrc/s2dconv.cu", "crog_tpu/ops/pallas_s2dconv.py:348"),
    "s2dconv_wgrad": ("crog_tpu_torch/csrc/s2dconv.cu",
                      "crog_tpu/ops/pallas_s2dconv.py:373"),
    "attention_f32": ("crog_tpu_torch/csrc/attention_f32.cu",
                      "crog_tpu/ops/pallas_attention.py:111"),
    "decoder_self_block_f32": ("crog_tpu_torch/csrc/decoder_blocks_f32.cu",
                               "crog_tpu/ops/pallas_decoder.py:422"),
    "decoder_cross_block_f32": ("crog_tpu_torch/csrc/decoder_blocks_f32.cu",
                                "crog_tpu/ops/pallas_decoder.py:511"),
    "ffn_f32": ("crog_tpu_torch/csrc/ffn_f32.cu", "crog_tpu/ops/pallas_ffn.py:197"),
    "attention_bwd_f32": ("crog_tpu_torch/csrc/attention_bwd_f32.cu",
                          "crog_tpu/ops/pallas_attention.py:140"),
    "decoder_self_block_bwd_f32": ("crog_tpu_torch/csrc/decoder_blocks_bwd_f32.cu",
                                   "crog_tpu/ops/pallas_decoder.py:457"),
    "decoder_cross_block_bwd_f32": ("crog_tpu_torch/csrc/decoder_blocks_bwd_f32.cu",
                                    "crog_tpu/ops/pallas_decoder.py:550"),
    "ffn_bwd_f32": ("crog_tpu_torch/csrc/ffn_bwd_f32.cu", "crog_tpu/ops/pallas_ffn.py:234"),
    "s2dconv_f32": ("crog_tpu_torch/csrc/s2dconv_f32.cu",
                    "crog_tpu/ops/pallas_s2dconv.py:348"),
    "s2dconv_wgrad_f32": ("crog_tpu_torch/csrc/s2dconv_f32.cu",
                          "crog_tpu/ops/pallas_s2dconv.py:373"),
}


def _record(name, max_err, bms, by):
    source, replaces = SOURCES[name.removesuffix(WIDE_SUFFIX)]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": None, "plain_ms": None, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def device_ms(fn, reps: int = 10):
    """(device ms per call, {kernel name: device ms per call}): the time
    the card spends in the kernels ``fn`` launches, from torch.profiler's
    kernel rows, so that host time in a wrapper cannot pass for kernel time
    in ``cuda_ms``; None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without kernel rows
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0
                and not getattr(e, "is_user_annotation", False)]
        if rows:
            break
    total = sum(e.device_time for e in rows) / 1e3 / reps
    by_name = {}
    for e in rows:
        name = e.name.split("(")[0]
        by_name[name] = by_name.get(name, 0.0) + e.device_time / 1e3 / reps
    return (total if total > 0 else None), by_name, _one_call(rows, reps)


def _one_call(rows, reps: int):
    """[(kernel name, device ms)] of one call in launch order, the mean over
    ``reps`` calls; None unless every call launched the same sequence."""
    rows = sorted(rows, key=lambda e: e.time_range.start)
    if not rows or len(rows) % reps:
        return None
    n = len(rows) // reps
    names = [e.name.split("(")[0] for e in rows[:n]]
    if any(e.name.split("(")[0] != names[i % n] for i, e in enumerate(rows)):
        return None
    return [(name, sum(rows[r * n + i].device_time for r in range(reps)) / 1e3 / reps)
            for i, name in enumerate(names)]


# (label, CUDA-event ms, call, group or None, split or None) of K1, K1b,
# K2, K2b, K3, K3b, K4, K4b, each K5, K5b, K6 and K6b launch, K6's and
# K6b's library calls, the attention kernel at K2's and K3's shapes beside
# SDPA there, and torch.mm at the shapes of the GEMMs inside K2b, K3b and
# K4, whose device time ``print_device_times`` takes after the timed
# phases, so that the profiler runs in none of them; calls of one group are
# also summed (K5 and K5b per SSG step, K6 and cuDNN per CROG step).  A
# split names parts of one call's device time: by kernel-name substrings,
# the rest under its last label, or by a function of the call's kernels in
# launch order.
DEVICE_TIMED = []
# K2's and K3's parts in launch order (LN_pre and the positional add, the
# q/k/v projections, the attention step, the out-projection with LN_post,
# dropout and the residual; the rest is the cross block's key mask); K4's
# cluster kernel and y GEMM; K4b's own kernels, its fixed-order sums and the
# two library dW GEMMs
BLOCK_FWD_SPLIT = ((("ln_pos", ("ln_pos",)),
                    ("projections (proj_gemm)", ("proj_gemm",)),
                    ("attention step", ("attn_fwd",)),
                    ("outproj_ln_cluster", ("outproj",))),
                   "the rest (key mask)")
FFN_FWD_SPLIT = ((("hidden (cluster kernel)", ("ffn_fwd_hidden",)),
                  ("y GEMM", ("ffn_out",))),
                 "the rest (weight casts and transposes)")
FFN_BWD_SPLIT = ((("K4b's kernels", ("ffn_bwd", "ffn_out")),
                  ("reduce_rows", ("reduce_rows",)),
                  ("dW1 and dW2 (library GEMMs)", ("gemm", "nvjet", "cutlass"))),
                 "weight casts and transposes")


def f32_parts(products):
    """The split of an fp32 kernel's launches (K1-f32..K4-f32, K2b-f32..
    K4b-f32) in launch order -> [(part, device ms)]: the attention kernels
    are the attention step; the n-th GEMM launch (gemm_wgmma_f32.cuh's
    kernel, or gemm_f32.cuh's, grad_f32.cuh's gemm_kn or a library GEMM in
    an older tree) is the n-th of ``products``; then the splits of the
    products' B into TF32 planes, the blocks' ln_pos and ln_residual, the
    other LayerNorm kernels (the backward's ln_post_bwd and ln_pre_bwd),
    the fixed-order sums and the rest (the cross block's key mask)."""
    def split(seq):
        parts, n = {}, 0
        for name, t in seq:
            if "attn" in name:
                part = "attention step"
            elif any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
                part = products[n] if n < len(products) else "other GEMMs"
                n += 1
            elif "split_b" in name:
                part = "B's TF32 planes"
            elif "ln_pos_" in name or "ln_residual" in name:
                part = "ln_pos" if "ln_pos_" in name else "ln_residual"
            elif "ln_" in name:
                part = "LayerNorm"
            elif "reduce_parts" in name or "colsum" in name:
                part = "fixed-order sums"
            else:
                part = "the rest"
            parts[part] = parts.get(part, 0.0) + t
        return list(parts.items())

    return split


# K2-f32's and K3-f32's products (csrc/decoder_blocks_f32.cu), each
# (name, its rows: "m"
# the B*L image rows or "mt" the B*T text rows, its output columns over
# D), and K4-f32's and K4b-f32's (csrc/ffn_f32.cu, ffn_bwd_f32.cu), in
# launch order, each on gemm_wgmma_f32.cuh's kernel
F32_BLOCK_PRODUCTS = {"K2-f32": (("q | k", "m", 2), ("v", "m", 1), ("out-projection", "m", 1)),
                      "K3-f32": (("q", "m", 1), ("k", "mt", 1), ("v", "mt", 1),
                                 ("out-projection", "m", 1))}
F32_FFN_PRODUCTS = {"K4-f32": ("hidden", "y"),
                    "K4b-f32": ("recompute", "dhn", "dx", "dW1", "dW2")}


def f32_block_bwd_shapes(m: int, mt: int, d: int = 512):
    """K2b-f32's and K3b-f32's products over ``m`` image and ``mt`` text
    rows in launch order (csrc/decoder_blocks_bwd_f32.cu,
    ops/decoder_blocks.py f32_bwd_products), each on gemm_wgmma_f32.cuh's
    kernel: {kernel: ((name, (rows, depth, cols) of C = A B, whether A is
    read transposed: a dW, A^T B over the batch rows), ...)}."""
    dw = lambda name, rows: (name, (d, rows, d), True)  # noqa: E731
    return {"K2b-f32": (("dO", (m, d, d), False), ("dX", (m, 3 * d, d), False),
                        ("dW q|k", (2 * d, m, d), True), dw("dW v", m), dw("dW out", m)),
            "K3b-f32": (("dO", (m, d, d), False), ("dX", (m, d, d), False),
                        ("d(txt)", (mt, 2 * d, d), False), dw("dWq", m), dw("dWk", mt),
                        dw("dWv", mt), dw("dW out", m))}


F32_PARTS = {"K1-f32": f32_parts(()),
             **{k: f32_parts(tuple(p[0] for p in v)) for k, v in F32_BLOCK_PRODUCTS.items()},
             **{k: f32_parts(v) for k, v in F32_FFN_PRODUCTS.items()},
             **{k: f32_parts(tuple(p[0] for p in v))
                for k, v in f32_block_bwd_shapes(1, 1).items()}}


def block_bwd_parts(seq):
    """K2b's and K3b's kernels in launch order -> [(part, device ms)]: the
    post-LN backward, the dO GEMM (the GEMM before the attention step), the
    attention step, the dX GEMMs (after it), the pre-LN backward, the dW
    GEMMs, and the fixed-order sums of the LN column partials apart from
    those of the dW partials (the sums after a dW GEMM)."""
    parts, after_attn, last = {}, False, ""
    for name, t in seq:
        if "ln_post_bwd" in name or "ln_pre_bwd" in name:
            part = "ln_post_bwd" if "ln_post_bwd" in name else "ln_pre_bwd"
        elif "attn_bwd" in name:
            part, after_attn = "attention", True
        elif "wgrad" in name:
            part = "dW wgrad"
        elif "reduce_rows" in name:
            part = ("dW reduce_rows" if last == "dW wgrad"
                    else "LN column sums reduce_rows")
        elif "gemm" in name:
            part = "dX gemm" if after_attn else "dO gemm"
        else:
            part = "other"
        if part not in ("dW reduce_rows", "LN column sums reduce_rows"):
            last = part
        parts[part] = parts.get(part, 0.0) + t
    return list(parts.items())


def _split_line(names, seq, split) -> str:
    if callable(split):
        if seq is None:
            return "not split (the calls launched different sequences)"
        return ", ".join(f"{label} {t:.4f} ms" for label, t in split(seq))
    parts, rest_label = split
    total = sum(names.values())
    out = []
    for label, keys in parts:
        t = sum(v for n, v in names.items() if any(k in n for k in keys))
        out.append(f"{label} {t:.4f} ms")
        total -= t
    out.append(f"{rest_label} {total:.4f} ms")
    return ", ".join(out)


def print_device_times():
    """Each DEVICE_TIMED call's CUDA-event time beside its kernels' device
    time (and the parts of its split), then each group's sum."""
    sums = {}
    for label, ms, fn, group, split in DEVICE_TIMED:
        dev, names, seq = device_ms(fn)
        shown = "not measured (no device rows)" if dev is None else f"{dev:.4f} ms"
        parts = ", ".join(f"{n[:90]} {t:.4f}" for n, t in sorted(names.items(),
                                                                   key=lambda kv: -kv[1]))
        print(f"[kernels] {label}: device time {shown} per call ({parts}); CUDA events "
              f"{ms:.4f} ms", flush=True)
        if split is not None and dev is not None:
            print(f"[kernels] {label} by part: {_split_line(names, seq, split)}", flush=True)
        if group is not None:
            dev_sum, ms_sum = sums.get(group, (0.0, 0.0))
            sums[group] = (None if dev is None or dev_sum is None else dev_sum + dev,
                           ms_sum + ms)
    for group, (dev, ms) in sums.items():
        shown = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"[kernels] {group}: device time {shown}; CUDA events {ms:.4f} ms",
              flush=True)


def _time(rec, kern, plain, lib):
    rec["ms"] = cuda_ms(kern)
    rec["plain_ms"] = cuda_ms(plain, reps=5)
    rec["library_ms"] = cuda_ms(lib) if lib is not None else None
    print(f"[kernels] {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}"
          f", library {rec['library_ms']}, bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']})", flush=True)
    if rec["name"] in ("attention", "attention_f32"):
        kid = "K1" if rec["name"] == "attention" else "K1-f32"
        DEVICE_TIMED.append((f"{rec['name']} ({kid})", rec["ms"], kern, None,
                             F32_PARTS.get(kid)))
        DEVICE_TIMED.append((f"{rec['name']}'s library call (SDPA forward)",
                             rec["library_ms"], lib, None, None))
    kid = {"decoder_self_block": "K2", "decoder_cross_block": "K3",
           "decoder_self_block_bwd": "K2b", "decoder_cross_block_bwd": "K3b",
           "ffn": "K4", "ffn_bwd": "K4b", "decoder_self_block_f32": "K2-f32",
           "decoder_cross_block_f32": "K3-f32", "ffn_f32": "K4-f32",
           "decoder_self_block_bwd_f32": "K2b-f32", "decoder_cross_block_bwd_f32": "K3b-f32",
           "ffn_bwd_f32": "K4b-f32"}.get(rec["name"])
    if kid is not None:
        split = {"K2": BLOCK_FWD_SPLIT, "K3": BLOCK_FWD_SPLIT, "K2b": block_bwd_parts,
                 "K3b": block_bwd_parts, "K4": FFN_FWD_SPLIT, "K4b": FFN_BWD_SPLIT,
                 "K2-f32": F32_PARTS["K2-f32"], "K3-f32": F32_PARTS["K3-f32"],
                 "K4-f32": F32_PARTS["K4-f32"], "K2b-f32": F32_PARTS["K2b-f32"],
                 "K3b-f32": F32_PARTS["K3b-f32"], "K4b-f32": F32_PARTS["K4b-f32"]}.get(kid)
        DEVICE_TIMED.append((f"{rec['name']} ({kid})", rec["ms"], kern, None, split))
    if rec["name"] in ("attention_bwd", "attention_bwd_f32"):
        kid = "K1b" if rec["name"] == "attention_bwd" else "K1b-f32"
        DEVICE_TIMED.append((f"{rec['name']} ({kid})", rec["ms"], kern, None, None))
        DEVICE_TIMED.append((f"{rec['name']}'s library call (SDPA backward)",
                             rec["library_ms"], lib, None, None))


def attention_yardsticks(device, b=BATCH, l=676, t=17, heads=8, timed: bool = True):
    """The attention kernel at the shapes K2 and K3 launch it with (self
    attention over 676 tokens; 676 queries over 17 text keys with an
    additive key mask, as the cross block's key padding makes it) against
    its twin under K1's tolerance, and the two-kernel attention backward
    that K2b and K3b run there (the decoder blocks' bf16 cast points)
    against its twin under BWD_REL_TOL; each timed beside SDPA's forward or
    backward at the same shapes (the mask as SDPA's ``attn_mask``)."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(SEED + 9)
    d = heads * 64
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    lengths = torch.randint(4, t + 1, (b,), generator=g)
    mask = torch.where(torch.arange(t)[None, :] >= lengths[:, None], A.NEG, 0.0).to(device)
    split = lambda x: x.view(b, x.shape[1], heads, 64).transpose(1, 2)
    x = rnd(b, l, d)
    cases = [("K2's self attention (L 676, 8 heads)", x, rnd(b, l, d), rnd(b, l, d), None)]
    cases.append(("K3's cross attention (676 queries, 17 keys, key mask)", x,
                  rnd(b, t, d), rnd(b, t, d), mask))
    for label, q, k, v, m in cases:
        kern = lambda q=q, k=k, v=v, m=m: A.fused_attention(q, k, v, heads, m)
        o = kern()
        _compare(f"attention at {label}", o, A.attention_plain(q, k, v, heads, m),
                 TOL["attention"])
        do = rnd(*q.shape)
        bwd = lambda q=q, k=k, v=v, o=o, do=do, m=m: A.attention_bwd(
            q, k, v, o, do, heads, bf16_casts=True, mask_add=m)
        for name, g_, r in zip(("dq", "dk", "dv"), bwd(),
                               A.mha_bwd_plain(q, k, v, do, heads, m)):
            _compare(f"attention backward (bf16 cast points) at {label}.{name}", g_, r,
                     BWD_REL_TOL * float(r.float().abs().max()))
        if not timed:
            continue
        am = None if m is None else m[:, None, None, :].to(torch.bfloat16)
        lib = lambda q=q, k=k, v=v, am=am: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=am)
        leaves = [split(t).detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
        lib_bwd = lambda out=out, leaves=leaves, do=do: torch.autograd.grad(
            out, leaves, split(do), retain_graph=True)
        ms, lib_ms, bms, lib_bms = cuda_ms(kern), cuda_ms(lib), cuda_ms(bwd), cuda_ms(lib_bwd)
        print(f"[kernels] attention at {label}: {ms:.4f} ms (SDPA {lib_ms:.4f}); backward "
              f"with bf16 cast points {bms:.4f} ms (SDPA backward {lib_bms:.4f})", flush=True)
        DEVICE_TIMED.append((f"attention at {label}", ms, kern, None, None))
        DEVICE_TIMED.append((f"SDPA at {label}", lib_ms, lib, None, None))
        DEVICE_TIMED.append((f"attention backward (K2b/K3b's step) at {label}", bms, bwd,
                             None, None))
        DEVICE_TIMED.append((f"SDPA backward at {label}", lib_bms, lib_bwd, None, None))


def gemm_yardsticks(device, b=BATCH, l=676, t=17, d=512, f=2048):
    """torch.mm at the shapes of the GEMMs inside K2b, K3b and K4, bf16 in
    and out, timed as a yardstick only (the port computes these products in
    its own kernels): dO and each dX product [B*L, D] x [D, D]; K2b's three
    fused dX products as one [B*L, 3D] x [3D, D] product; dW = A^T B over
    B*L rows and over K3b's B*T text rows; K4's hidden product [B*L, D] x
    [D, F] and its y product [B*L, F] x [F, D]."""
    import torch

    g = torch.Generator().manual_seed(SEED + 10)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    m, mt = b * l, b * t
    cases = (
        (f"[{m}, {d}] x [{d}, {d}] (dO, each dX product)", rnd(m, d), rnd(d, d), False),
        (f"[{m}, {3 * d}] x [{3 * d}, {d}] (K2b's three dX products as one)",
         rnd(m, 3 * d), rnd(3 * d, d), False),
        (f"A^T B over {m} rows, [{d}, {d}] (each dW)", rnd(m, d), rnd(m, d), True),
        (f"A^T B over {m} rows, [{2 * d}, {d}] (K2b's dW[q | k])", rnd(m, 2 * d), rnd(m, d),
         True),
        (f"[{mt}, {2 * d}] x [{2 * d}, {d}] (K3b's d(txt))", rnd(mt, 2 * d), rnd(2 * d, d),
         False),
        (f"A^T B over {mt} rows, [{d}, {d}] (K3b's dW of k and v)", rnd(mt, d), rnd(mt, d),
         True),
        (f"[{m}, {d}] x [{d}, {f}] (K4's hidden product)", rnd(m, d), rnd(d, f), False),
        (f"[{m}, {f}] x [{f}, {d}] (K4's y product)", rnd(m, f), rnd(f, d), False),
    )
    for label, a, w, trans in cases:
        call = ((lambda a=a, w=w: torch.mm(a.t(), w)) if trans
                else (lambda a=a, w=w: torch.mm(a, w)))
        ms = cuda_ms(call)
        print(f"[kernels] torch.mm yardstick {label}: {ms:.4f} ms", flush=True)
        DEVICE_TIMED.append((f"torch.mm yardstick {label}", ms, call, None, None))
    linear_yardsticks(device, b, l, t, d)


def linear_yardsticks(device, b=BATCH, l=676, t=17, d=512):
    """F.linear(x, W, b), bf16 in and out with the bias, at the shapes of
    K2's and K3's projections, timed as a yardstick only (the port computes
    them in its own kernels, as the TPU kernel computes them in its body):
    K2's q, k and v as one [B*L, D] -> 3D product; K3's q and the
    out-projection [B*L, D] -> D; K3's k and v over B*T text rows, [B*T, D]
    -> D.  The fp32 kernels' are ``f32_block_products``' and
    ``f32_ffn_products``'."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(SEED + 11)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    m, mt = b * l, b * t
    cases = [
        (f"[{m}, {d}] -> {3 * d} (K2's q, k and v)", m, d, 3 * d),
        (f"[{m}, {d}] -> {d} (K3's q, the out-projection)", m, d, d),
        (f"[{mt}, {d}] -> {d} (K3's k, v)", mt, d, d),
    ]
    for label, rows, k, n in cases:
        x, w, bias = rnd(rows, k), rnd(n, k), rnd(n)
        call = lambda x=x, w=w, bias=bias: F.linear(x, w, bias)
        ms = cuda_ms(call)
        print(f"[kernels] F.linear yardstick {label}: {ms:.4f} ms", flush=True)
        DEVICE_TIMED.append((f"F.linear yardstick {label}", ms, call, None, None))


def _compare(name, got, ref, tol, share=1.0):
    """Max-abs error of ``got`` against ``ref``, which must be within
    ``tol``, with at most a ``share`` of the elements differing at all."""
    import torch

    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max())
    diff = float((err > 0).float().mean())
    ok = bool(torch.isfinite(got.float()).all()) and max_err <= tol and diff <= share
    print(f"[kernels] {name}: max_abs_err {max_err:.6g} (tol {tol:.4g}), "
          f"mean_abs_err {float(err.mean()):.3g}, differing {diff:.4g} (limit "
          f"{share:.4g}), max|ref| {float(ref.float().abs().max()):.4g}", flush=True)
    if not ok:
        raise AssertionError(f"kernel {name} disagrees with its plain twin")
    return max_err


def check_kernels(device, timed: bool = True):
    """Phase 3: every kernel against its twin; returns the records."""
    import torch

    records = {}
    inp = kernel_inputs(device)
    with torch.no_grad():
        for name, (kern, plain, lib, flops, nb) in kernel_cases(inp).items():
            max_err = _compare(name, kern(), plain(), TOL[name])
            records[name] = _record(name, max_err, *bound(flops, nb))
            if timed:
                _time(records[name], kern, plain, lib)
        for name, (kern, plain) in dropout_cases(inp).items():
            _compare(f"{name} (dropout {RATE})", kern(), plain(), TOL[name])
        for name, (kern, plain, lib, flops, nb, outs) in backward_cases(inp).items():
            got, ref = kern(), plain()
            rel, share = ((K1B_REL_TOL, K1B_DIFF_SHARE) if name == "attention_bwd"
                          else (BWD_REL_TOL, 1.0))
            max_err = 0.0
            for o, g, r in zip(outs, got, ref):
                tol = rel * float(r.float().abs().max())
                max_err = max(max_err, _compare(f"{name}.{o}", g, r, tol, share))
            records[name] = _record(name, max_err, *bound(flops, nb))
            if timed:
                _time(records[name], kern, plain, lib)
        k4b_checks(inp)
        repeat_checks(inp)
        block_fwd_train_checks(inp, timed)
        attention_yardsticks(device, timed=timed)
        if timed:
            gemm_yardsticks(device)
        k1b_cast_check(inp)
        k1b_long_check(device)
        records.update(check_lincomb(device, timed))
        records.update(check_s2dconv(device, timed))
    return records


def k4b_checks(inp, relu_held: bool = False):
    """K4b at the main path's M with dropout off (the backward cases run it
    at RATE) against its twin under BWD_REL_TOL, and at both rates twice:
    dx, dh, hn and the four column sums must come out with equal bits.
    With ``relu_held`` the twin takes K4b's ReLU decision
    (``ffn_f32_relu_decision``: it may differ from the twin's own only at
    pre-activations within F32_RELU_TIE of 0)."""
    import torch

    from crog_tpu_torch.ops import ffn as FF

    f = inp["ffn"]
    args = (f["x"], f["w1"], f["b1"], f["g"], f["be"], f["w2"], inp["dy"]["ffn"])
    names = ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2")
    mask = ffn_f32_relu_decision(args, SEED + 3, 0.0) if relu_held else None
    for o, g, r in zip(names, FF.ffn_bwd(*args, SEED + 3, 0.0),
                       FF.ffn_bwd_plain(*args, SEED + 3, 0.0, relu_mask=mask)):
        _compare(f"ffn_bwd (dropout 0).{o}", g, r, BWD_REL_TOL * float(r.float().abs().max()))
    held = ("dx", "db1", "dgamma", "dbeta", "db2", "dh", "hn")
    for rate in (0.0, RATE):
        a, b = (FF.ffn_bwd(*args, SEED + 3, rate, with_hidden=True) for _ in range(2))
        torch.cuda.synchronize()
        both = dict(zip(names + ("dh", "hn"), zip(a, b)))
        differ = [n for n in held if not torch.equal(*both[n])]
        print(f"[kernels] ffn_bwd (dropout {rate}) twice: {', '.join(held)} "
              f"{'equal bits' if not differ else 'differ: ' + ', '.join(differ)}", flush=True)
        if differ:
            raise AssertionError(f"K4b is not repeatable: {differ}")


def repeat_checks(inp):
    """K4, K2b and K3b at the main path's shapes, each twice at dropout 0 and
    RATE: every output must come out with equal bits (no atomics, sums in a
    fixed order)."""
    import torch

    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    sargs, cargs, fargs = _args(inp)
    x, xc = sargs[0], cargs[0]
    dys, dyc = inp["dy"]["decoder_self_block"], inp["dy"]["decoder_cross_block"]
    for rate in (0.0, RATE):
        _, ssaved = DB.self_block_fwd(*sargs, SEED + 1, rate, save=True)
        _, csaved = DB.cross_block_fwd(*cargs, SEED + 2, rate, save=True)
        calls = {
            "ffn (K4)": lambda: (FF.ffn_fwd(*fargs, SEED + 3, rate),),
            "decoder_self_block_bwd (K2b)":
                lambda: DB.self_block_bwd(x, ssaved, dys, 8, SEED + 1, rate),
            "decoder_cross_block_bwd (K3b)":
                lambda: DB.cross_block_bwd(xc, csaved, dyc, 8, SEED + 2, rate),
        }
        for name, call in calls.items():
            a, b = call(), call()
            torch.cuda.synchronize()
            differ = [i for i, (u, v) in enumerate(zip(a, b)) if not torch.equal(u, v)]
            print(f"[kernels] {name} (dropout {rate}) twice: {len(a)} outputs "
                  f"{'equal bits' if not differ else f'differ at {differ}'}", flush=True)
            if differ:
                raise AssertionError(f"{name} is not repeatable: outputs {differ}")


def block_fwd_train_checks(inp, timed: bool = True):
    """K2 and K3 in train mode at the main path's shapes (dropout RATE, the
    intermediates K2b and K3b read saved), twice: the output and every
    saved intermediate must come out with equal bits; then each timed, its
    device time split by part as in eval."""
    import torch

    from crog_tpu_torch.ops import decoder_blocks as DB

    sargs, cargs, _ = _args(inp)
    calls = {
        "decoder_self_block (K2)":
            lambda: DB.self_block_fwd(*sargs, SEED + 1, RATE, save=True),
        "decoder_cross_block (K3)":
            lambda: DB.cross_block_fwd(*cargs, SEED + 2, RATE, save=True),
    }
    for name, call in calls.items():
        (ya, sa), (yb, sb) = call(), call()
        torch.cuda.synchronize()
        a, b = (ya, *sa), (yb, *sb)
        differ = [i for i, (u, v) in enumerate(zip(a, b)) if not torch.equal(u, v)]
        print(f"[kernels] {name} train mode (dropout {RATE}, saved) twice: y and "
              f"{len(a) - 1} saved tensors {'equal bits' if not differ else f'differ at {differ}'}",
              flush=True)
        if differ:
            raise AssertionError(f"{name} in train mode is not repeatable: outputs {differ}")
        if timed:
            ms = cuda_ms(call)
            label = f"{name} train mode (dropout {RATE}, saved)"
            print(f"[kernels] {label}: {ms:.4f} ms", flush=True)
            DEVICE_TIMED.append((label, ms, call, None, BLOCK_FWD_SPLIT))


def k1b_cast_check(inp):
    """K1b's kernels with the decoder blocks' cast points (P and dS rounded
    to bf16) against K1b's twin: every output must differ from it in more
    than K1B_DIFF_SHARE of its elements, or K1b's tolerance could not tell
    a lost f32 cast point."""
    from crog_tpu_torch.ops import attention as A

    a = inp["attention"]
    q, k, v, h = a["q"], a["k"], a["v"], a["heads"]
    do = inp["dy"]["attention"]
    o = A.fused_attention(q, k, v, h)
    lost = A.attention_bwd(q, k, v, o, do, h, bf16_casts=True)
    ref = A.attention_bwd_plain(q, k, v, o, do, h)
    shares = [float((g.float() != r.float()).float().mean()) for g, r in zip(lost, ref)]
    print(f"[kernels] attention_bwd with bf16 cast points vs K1b's twin: differing "
          f"{', '.join(f'{x:.4g}' for x in shares)} (K1b's limit {K1B_DIFF_SHARE})",
          flush=True)
    if min(shares) <= K1B_DIFF_SHARE:
        raise AssertionError("K1b's tolerance does not see bf16 cast points")


def k1b_long_check(device, b=4, l=K1B_LONG, heads=32):
    """K1b on a head longer than the one-CTA-per-head kernel takes (its two
    kernels, ``bwd_path`` "rows_cols"), against its twin under K1b's
    tolerance."""
    import torch

    from crog_tpu_torch.ops import attention as A

    if A.bwd_path(l) != "rows_cols":
        raise AssertionError(f"a head of {l} tokens should take the two-kernel path")
    g = torch.Generator().manual_seed(SEED + 8)
    q, k, v, do = (torch.randn(b, l, heads * 64, generator=g).to(device, torch.bfloat16)
                   for _ in range(4))
    o = A.fused_attention(q, k, v, heads)
    got = A.attention_bwd(q, k, v, o, do, heads)
    ref = A.attention_bwd_plain(q, k, v, o, do, heads)
    for name, g_, r in zip(("dq", "dk", "dv"), got, ref):
        _compare(f"attention_bwd (L={l}, two-kernel path).{name}", g_, r,
                 K1B_REL_TOL * float(r.float().abs().max()), K1B_DIFF_SHARE)


def ssg_batch_lincomb_args(device, protos, g, batch=None):
    """{T: (protos, coefficients, GT rows, GT index, boxes)} as ``ssg_losses``
    hands them to K5/K5b (T=1 the instance masks, T=4 the grasp maps) on a
    host ``batch`` of SSG's config: by default the first legacy batch of
    ``SSG_LEGACY_BATCH`` synthetic scenes (the ``ssg-batch`` case), or the
    first raw batch of phase 9 (``ssg-raw``, unpacked with ``emit_ds`` as
    the train step does, so the loss takes its ``ins_ds`` / ``sem_ds`` /
    ``grasp_ds``): its scenes, the model's anchors and the step's first
    priority draw, matched, selected and downsampled by the loss's own
    code.  Only the network's outputs are
    random (``protos``; coefficients from ``g``, tanh'd): they decide no
    box, GT row or crop."""
    import torch

    from crog_tpu_torch.engine.ssg_engine import device_batch
    from crog_tpu_torch.models import ssg_loss
    from crog_tpu_torch.models.ssg import build_ssg
    from crog_tpu_torch.train_ssg import loss_config

    cfg = _ssg_cfg(("wire_format", "legacy"))
    if batch is None:
        batch = _ssg_data(cfg, cfg.train_split, 2 * SSG_LEGACY_BATCH, SSG_LEGACY_BATCH,
                          True)[0][0]
    batch = device_batch(batch, device, cfg.img_size, max_objs=cfg.max_objs)
    anchors = torch.as_tensor(build_ssg(cfg).anchors()).to(device)
    b, n, c = protos.shape[0], anchors.shape[0], int(cfg.num_classes)
    # the semantic head's map at the size of a raw batch's sem_ds (a legacy
    # batch's full maps are downsampled to it in the loss)
    sh = batch["sem_ds"].shape[-1] if "sem_ds" in batch else 8
    output = {"protos": protos,
              "cls_logits": torch.randn(b, n, c, generator=g).to(device),
              "box_pred": torch.randn(b, n, 4, generator=g).to(device),
              "seg_pred": torch.randn(b, sh, sh, c, generator=g).to(device),
              "ins_coef_pred": torch.tanh(torch.randn(b, n, 32, generator=g)).to(device),
              "grasp_coef_pred": torch.tanh(torch.randn(b, n, 4, 32, generator=g)).to(device)}
    taken = {}

    def record(protos, sel_coef, ds_flat, sel_gt, sel_box, num_tasks, **_):
        taken[num_tasks] = (protos, sel_coef, ds_flat, sel_gt, sel_box)
        return torch.zeros(sel_coef.shape[:3], device=sel_coef.device)

    real, ssg_loss.lincomb_task_sums = ssg_loss.lincomb_task_sums, record
    try:
        ssg_loss.ssg_losses(output, batch, anchors, torch.Generator().manual_seed(SEED),
                            **loss_config(cfg))
    finally:
        ssg_loss.lincomb_task_sums = real
    return taken


def lincomb_cases(device, case: str = "synthetic", ph=136, k=100, m=24):
    """loss kind -> (kernel arguments, tasks, gradient of the sums): K5/K5b's
    inputs at SSG's shapes (544^2: 136^2 prototypes, masks_to_train 100,
    max_objs 24) for the instance-mask launch (T=1, binary GT, 24 rows)
    and the grasp launch (T=4, 96 rows).  Prototypes are ReLU'd and
    coefficients tanh'd, as the model emits them.  The boxes, GT rows and
    GT maps by ``case`` (``ssg_batch_lincomb_args``): "ssg-raw", those the
    main path's first step hands the kernels (the first raw batch at
    SSG_BATCH); "ssg-batch", those of the first legacy batch at
    SSG_LEGACY_BATCH; at that batch, "synthetic", made-up boxes of 0.05-0.30 of the map, three of them off
    it, with random GT; "full-map", the synthetic case with every box over
    the whole map, the dense worst case of a kernel that skips points
    outside the boxes."""
    import torch

    from crog_tpu_torch.ops import lincomb as LC

    b = SSG_BATCH if case == "ssg-raw" else SSG_LEGACY_BATCH
    g = torch.Generator().manual_seed(SEED + 5)
    protos = torch.relu(torch.randn(b, ph, ph, 32, generator=g))
    lo = torch.rand(b, k, 2, generator=g) * 0.7
    box = torch.cat([lo, lo + 0.05 + 0.25 * torch.rand(b, k, 2, generator=g)], -1)
    box[:, :3] = torch.tensor([-0.5, -0.5, -0.4, -0.4])
    if case == "full-map":
        box[:] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    sel_gt = torch.randint(0, m, (b, k), generator=g)
    taken = {}
    if case == "ssg-raw":
        taken = ssg_batch_lincomb_args(device, protos.to(device), g, ssg_raw_batches()[0])
    elif case == "ssg-batch":
        taken = ssg_batch_lincomb_args(device, protos.to(device), g)
    cases = {}
    for kind, t in (("bce", 1), ("smooth_l1", 4)):
        coef = torch.tanh(torch.randn(b, k, t, 32, generator=g))
        ds = torch.rand(b, t * m, ph * ph, generator=g)
        if t == 1:
            ds = (ds > 0.5).float()
        inputs = taken.get(t, [x.to(device) for x in (protos, coef, ds, sel_gt, box)])
        args = LC.kernel_args(*inputs, t)
        cases[kind] = (args, t, torch.randn(b, k * t, generator=g).to(device))
    return cases


def lincomb_parts(seq):
    """One K5 / K5b call's kernels in launch order -> [(kernel, device ms)],
    each kernel's launches summed."""
    parts = {}
    for name, t in seq:
        parts[name] = parts.get(name, 0.0) + t
    return list(parts.items())


# K5/K5b's box cases (``lincomb_cases``); the first is the main path's and
# fills the records
LINCOMB_CASES = ("ssg-raw", "ssg-batch", "synthetic", "full-map")


def check_lincomb(device, timed: bool = True):
    """K5 and K5b against their twins at the main path's shapes, both loss
    kinds, in each box case, each twice for equal bits.  Per case and SSG
    train step (the mask launch plus the grasp launch): the time, the bound
    of the work the function needs beside the dense bound, and the share of
    points inside a box.  The records carry the ssg-raw case's numbers,
    and the largest error of any case."""
    import torch

    from crog_tpu_torch.ops import lincomb as LC

    records = {n: _record(n, 0.0, 0.0, "operations") for n in ("lincomb", "lincomb_bwd")}
    for case in LINCOMB_CASES:
        inputs = lincomb_cases(device, case)
        needs = {kind: lincomb_work(args, t)
                 for kind, (args, t, _) in inputs.items()}
        for name, rec in records.items():
            kid = "K5b" if name == "lincomb_bwd" else "K5"
            step = {"ms": 0.0, "plain": 0.0, "bound": 0.0, "dense": 0.0, "by": "operations"}
            for kind, (args, t, gsum) in inputs.items():
                flops, dense, fwd_b, bwd_b, share = needs[kind]
                # default arguments bind this kind's inputs: DEVICE_TIMED calls
                # the kernel again after the loop
                if name == "lincomb":
                    kern = lambda args=args, t=t, kind=kind: LC.lincomb_fwd(*args, t, loss_kind=kind)
                    plain = lambda: LC.lincomb_task_sums_plain(*args, t, loss_kind=kind)
                    got, again, ref = [kern()], [kern()], [plain()]
                    outs, mult, nb = ("sums",), 1, fwd_b
                else:
                    kern = lambda args=args, gsum=gsum, t=t, kind=kind: LC.lincomb_bwd(
                        *args, gsum, t, loss_kind=kind)
                    plain = lambda: LC.lincomb_bwd_plain(*args, gsum, t, loss_kind=kind)
                    got, again, ref = kern(), kern(), plain()
                    outs, mult, nb = ("dcoef", "dprotos"), 3, bwd_b
                need = bound(mult * flops, nb, PEAK_F32_TC_FLOPS)
                dense_need = bound(mult * dense, nb, PEAK_F32_TC_FLOPS)
                label = f"{name} ({kind}, T={t}, {case})"
                for o, gt_, r, r2 in zip(outs, got, ref, again):
                    tol = LINCOMB_REL_TOL * float(r.abs().max())
                    err = _compare(f"{label}.{o}", gt_, r, tol)
                    if not torch.equal(gt_, r2):
                        raise AssertionError(f"{label}.{o} differs between two runs")
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                step["bound"] += need[0]
                step["dense"] += dense_need[0]
                if need[1] == "bytes":
                    step["by"] = "bytes"
                if not timed:
                    continue
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain, reps=5)
                step["ms"] += ms
                step["plain"] += plain_ms
                print(f"[kernels] {label}: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                      f"{need[0]:.4f} by {need[1]} over {mult * flops:.4g} flop and {nb:.4g} "
                      f"bytes; dense bound {dense_need[0]:.4f} over {mult * dense:.4g} flop; "
                      f"{100 * share:.2f}% of the points inside a box)", flush=True)
                DEVICE_TIMED.append((f"{name} ({kid}, {kind}, T={t}, {case})", ms, kern,
                                     f"{name} ({kid}) per SSG train step, {case}",
                                     lincomb_parts))
            if case == LINCOMB_CASES[0]:
                rec["bound_ms"], rec["bound_by"] = step["bound"], step["by"]
                if timed:
                    rec["ms"], rec["plain_ms"] = step["ms"], step["plain"]
            if timed:
                print(f"[kernels] {name} per SSG train step, {case}: {step['ms']:.4f} ms "
                      f"(plain {step['plain']:.4f}, library none, bound {step['bound']:.4f} "
                      f"by {step['by']}, dense bound {step['dense']:.4f})", flush=True)
    return records


# the stem's two blocked convs on the main path: (name, ci, co)
STEM_CONVS = (("conv2", 32, 32), ("conv3", 32, 64))


def s2d_launch_widths(label: str):
    """(input, output) channels of an ``s2dconv_cases`` launch: a conv's
    forward and wgrad take (ci, co), its dgrad (co, ci)."""
    name, kind = label.split()
    ci, co = dict((n, (a, b)) for n, a, b in STEM_CONVS)[name]
    return (co, ci) if kind == "dgrad" else (ci, co)


def s2dconv_cases(device, b=BATCH, cells=104, dtype=None):
    """K6/K6b's launches in one train step of the main path (batch 24,
    416^2: the stem's 2x2-blocked tensors have 104x104 cells; conv2 ci = co
    = 32, conv3 ci = 32, co = 64), each as (label, kernel call, plain call,
    blocked cuDNN call, unblocked cuDNN call, flops, bytes, tolerance
    relative to the largest |output|).  Activations are ReLU'd as the stem's
    BN+ReLU emits them; weights He-scaled.  The flops count the real taps,
    2*9*ci*co per original output pixel; the bytes each input once and each
    output once.  Operands in ``dtype``: bf16 unless given (fp32 for phase
    18, full fp32 values; the tolerance is then phase 18's own)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from crog_tpu_torch.ops import s2dconv as SC
    from crog_tpu_torch.ops.s2d import block_kernel_s1, depth_to_space

    g = torch.Generator().manual_seed(SEED + 6)
    bf = torch.bfloat16 if dtype is None else dtype
    nchw = lambda t: t.permute(0, 3, 1, 2)
    k6, k6b = [], []
    for name, ci, co in STEM_CONVS:
        x = torch.relu(torch.randn(b, cells, cells, 4 * ci, generator=g)).to(device, bf)
        dy = torch.randn(b, cells, cells, 4 * co, generator=g).to(device, bf)
        w = (torch.randn(3, 3, ci, co, generator=g) * (2.0 / (9 * ci)) ** 0.5).to(device)
        flops = work.s2dconv_flops(b, cells, cells, ci, co)
        wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)
        for label, inp, kern_w, c_in, c_out in ((f"{name} forward", x, w, ci, co),
                                                (f"{name} dgrad", dy, wt, co, ci)):
            wp = SC.pack_s1(kern_w).to(bf).contiguous()
            blocked = block_kernel_s1(kern_w).permute(3, 2, 0, 1).to(bf).contiguous()
            plain_w = kern_w.permute(3, 2, 0, 1).to(bf).contiguous()
            unblocked = nchw(depth_to_space(inp, 2)).contiguous(memory_format=torch.channels_last)
            k6.append((label,
                       lambda inp=inp, wp=wp, c_in=c_in, c_out=c_out:
                           SC.s2dconv_fwd(inp, wp, c_in, c_out),
                       lambda inp=inp, wp=wp, c_in=c_in, c_out=c_out:
                           SC.conv_padded_plain(inp, wp, c_in, c_out),
                       lambda inp=inp, k=blocked: F.conv2d(nchw(inp), k, padding=1),
                       lambda u=unblocked, k=plain_w: F.conv2d(u, k, padding=1),
                       flops, nbytes(inp, wp) + inp.numel() // c_in * c_out * inp.element_size(),
                       S2D_REL_TOL))
        ub_x = nchw(depth_to_space(x, 2)).contiguous(memory_format=torch.channels_last)
        ub_dy = nchw(depth_to_space(dy, 2)).contiguous(memory_format=torch.channels_last)
        k6b.append((f"{name} wgrad",
                    lambda x=x, dy=dy, ci=ci, co=co: SC.s2dconv_wgrad(x, dy, ci, co),
                    lambda x=x, dy=dy, ci=ci, co=co: SC.wgrad_plain(x, dy, ci, co),
                    lambda x=x, dy=dy, ci=ci, co=co: conv2d_weight(
                        nchw(x), (4 * co, 4 * ci, 3, 3), nchw(dy), padding=1),
                    lambda x=ub_x, dy=ub_dy, ci=ci, co=co: conv2d_weight(
                        x, (co, ci, 3, 3), dy, padding=1),
                    flops, nbytes(x, dy) + 16 * ci * 4 * co * 4, S2D_WGRAD_REL_TOL))
    return {"s2dconv": k6, "s2dconv_wgrad": k6b}


def check_s2dconv(device, timed: bool = True):
    """K6 and K6b against their twins at the main path's shapes; a record's
    times, bound and work are per CROG train step (K6: conv2 and conv3
    forward and dgrad; K6b: conv2 and conv3 wgrad), its library time the
    blocked cuDNN conv (the function K6 replaces); cuDNN's plain conv of the
    unblocked tensor is printed beside it."""
    records = {}
    for name, cases in s2dconv_cases(device).items():
        rec = _record(name, 0.0, 0.0, "bytes")
        if timed:
            rec.update(ms=0.0, plain_ms=0.0, library_ms=0.0)
        unblocked_ms = 0.0
        for label, kern, plain, lib, lib_plain, flops, nb, rel in cases:
            ref = plain()
            err = _compare(f"{name} ({label})", kern(), ref, rel * float(ref.float().abs().max()))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del ref
            bms, by = bound(flops, nb)
            rec["bound_ms"] += bms
            if by == "operations":
                rec["bound_by"] = "operations"
            if timed:
                kid = "K6b" if name == "s2dconv_wgrad" else "K6"
                unblocked_ms += time_s2d(rec, kid, label, kern, plain, lib, lib_plain, bms,
                                         by, "[kernels]", "")
        if timed:
            s2d_step_line(rec, unblocked_ms, "[kernels]", "")
        records[name] = rec
    return records


def time_s2d(rec, kid, label, kern, plain, lib, lib_plain, bms, by, tag, prec):
    """One K6/K6b launch (``kid``, ``label``) timed beside its twin, its
    library call (cuDNN's conv of the blocked tensor, or conv2d_weight of
    it) and cuDNN's plain conv of the unblocked tensor, ``prec`` naming
    their dtype (" fp32", or "" for bf16); the times are added to ``rec``
    (per CROG train step) and the kernel's and the library call's queued
    for ``print_device_times``.  Returns the unblocked conv's ms."""
    name = rec["name"]
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain, reps=5)
    lib_ms, ub_ms = cuda_ms(lib), cuda_ms(lib_plain)
    rec["ms"] += ms
    rec["plain_ms"] += plain_ms
    rec["library_ms"] += lib_ms
    print(f"{tag} {name} ({label}): {ms:.4f} ms (plain {plain_ms:.4f}, cuDNN blocked{prec} "
          f"{lib_ms:.4f}, cuDNN unblocked 208^2{prec} {ub_ms:.4f}, bound {bms:.4f} by {by})",
          flush=True)
    call = ("conv2d_weight" if kid.startswith("K6b") else "cuDNN blocked conv") + prec
    DEVICE_TIMED.append((f"{name} ({kid}, {label})", ms, kern,
                         f"{name} ({kid}) per CROG train step", None))
    DEVICE_TIMED.append((f"{name}'s library call ({call}, {label})", lib_ms, lib,
                         f"{name}'s library call ({call}) per CROG train step", None))
    return ub_ms


def s2d_step_line(rec, unblocked_ms, tag, prec):
    print(f"{tag} {rec['name']} per CROG train step: {rec['ms']:.4f} ms (plain "
          f"{rec['plain_ms']:.4f}, cuDNN blocked{prec} {rec['library_ms']:.4f}, cuDNN "
          f"unblocked{prec} {unblocked_ms:.4f}, bound {rec['bound_ms']:.4f} by "
          f"{rec['bound_by']})", flush=True)


def launch_counts():
    """name -> (wrapper, attribute) of every kernel's launch count: each
    wrapper of K1-K4b and K6/K6b counts its fp32 build's launches apart."""
    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF
    from crog_tpu_torch.ops import lincomb as LC
    from crog_tpu_torch.ops import s2dconv as SC

    wrappers = {"attention": A.fused_attention, "decoder_self_block": DB.self_block_fwd,
                "decoder_cross_block": DB.cross_block_fwd, "ffn": FF.ffn_fwd,
                "attention_bwd": A.attention_bwd,
                "decoder_self_block_bwd": DB.self_block_bwd,
                "decoder_cross_block_bwd": DB.cross_block_bwd, "ffn_bwd": FF.ffn_bwd,
                "lincomb": LC.lincomb_fwd, "lincomb_bwd": LC.lincomb_bwd,
                "s2dconv": SC.s2dconv_fwd, "s2dconv_wgrad": SC.s2dconv_wgrad}
    counts = {n: (w, "launches") for n, w in wrappers.items()}
    for n in FWD + ("s2dconv",):
        counts[n + "_f32"] = (wrappers[n], "launches_f32")
    for n in FWD:
        counts[n + "_bwd_f32"] = (wrappers[n + "_bwd"], "launches_f32")
    counts["s2dconv_wgrad_f32"] = (SC.s2dconv_wgrad, "launches_f32")
    return counts


def _cfg(samples=SAMPLES, batch=BATCH, opts=()):
    """The CROG config as written (rawlb wire, s2d stem), cut to ``samples``
    synthetic samples at ``batch``; ``opts`` override further keys."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg_from_cfg_file(CONFIG), [
        "synthetic_samples", str(samples), "batch_size", str(batch),
        "batch_size_val", str(batch), *opts,
    ])


def _model(cfg, device, dtype=None, fused_stem: bool = True):
    """Full-width CROG with seeded random weights; with ``fused_stem`` the
    s2d stem's convs go through K6/K6b on the card."""
    import torch

    from crog_tpu_torch.models.crog import build_crog, random_init_

    model = build_crog(cfg, dtype, fused_stem=fused_stem)
    random_init_(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def host_bytes(batch) -> int:
    """Bytes per sample that a train step sends to the card."""
    from crog_tpu_torch.engine.crog_engine import step_keys

    return sum(batch[k].nbytes for k in step_keys(batch)) // len(batch["word"])


def val_batches(cfg, batch: int):
    """The synthetic val samples of ``cfg`` in host batches of ``batch``
    (the last one padded)."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    ds = build_dataset(cfg, cfg.val_split)
    t0 = time.perf_counter()
    batches = list(DataLoader(ds, batch, pad_last_batch=True))
    print(f"[data] {len(ds)} synthetic val samples prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return batches


def build_model_and_data(device, samples=SAMPLES, batch=BATCH, opts=()):
    cfg = _cfg(samples, batch, opts)
    model = _model(cfg, device).eval()
    return cfg, model, val_batches(cfg, batch)


def _reset(wrappers):
    for w, attr in wrappers.values():
        setattr(w, attr, 0)


def _read(wrappers):
    return {n: getattr(w, attr) for n, (w, attr) in wrappers.items()}


def main_path(device, cfg, model, batches):
    """Phase 4: validate_with_grasp through the kernels; returns launches."""
    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp

    eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
    wrappers = launch_counts()
    _reset(wrappers)
    result = validate_with_grasp(batches, eval_step)
    launches = _read(wrappers)
    forwards = len(batches)
    print(f"[main] IoU={result['iou']:.6f} J@1={result['j_index@1']:.6f} "
          f"J@5={result['j_index@5']:.6f} over {len(result['iou_list'])} samples; "
          f"launches {launches} for {forwards} forwards", flush=True)
    for key in ("iou", "j_index@1", "j_index@5"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"{key} is not finite: {result[key]}")
    check_launches(launches, PER_FORWARD, forwards)
    return eval_step, launches


def check_launches(launches, per_call, calls: int):
    """Each kernel launched ``per_call`` times per forward or step (0 where
    it is not named) over ``calls`` of them."""
    for n, got in launches.items():
        want = per_call.get(n, 0) * calls
        if got != want:
            raise AssertionError(f"{n}: {got} launches, expected {want}")


def snapshot(model):
    """Copies of the trainable parameters and the BatchNorm statistics."""
    params = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    return params, stats


def check_moved(model, params0, stats0, tag: str):
    """Every trainable parameter and BatchNorm statistic differs from its
    ``snapshot``."""
    import torch

    named = dict(model.named_parameters())
    frozen = [n for n, p in params0.items() if torch.equal(p, named[n].detach())]
    buffers = dict(model.named_buffers())
    still = [n for n, b in stats0.items() if torch.equal(b, buffers[n])]
    print(f"[{tag}] {len(params0) - len(frozen)}/{len(params0)} trainable parameters "
          f"and {len(stats0) - len(still)}/{len(stats0)} BatchNorm statistics moved",
          flush=True)
    if frozen or still:
        raise AssertionError(f"did not move: {frozen[:5]} {still[:5]}")


def prepared_train_batches():
    """Two prepared synthetic train batches at BATCH on the config's wire
    (rawlb), as phases 5 and 18 train on them."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _cfg(2 * BATCH, BATCH)
    return list(DataLoader(build_dataset(cfg, cfg.train_split), BATCH, shuffle=True,
                           drop_last=True, seed=SEED))


def train_path(device, smi: str):
    """Phase 5: train_one_epoch at full width, batch 24, rawlb batches,
    through every forward and backward kernel; returns (launches, samples/s,
    the prepared train batches, cfg, the train step)."""
    import torch

    from crog_tpu_torch.engine.crog_engine import make_train_step, train_one_epoch
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = _cfg(2 * BATCH, BATCH, ("print_freq", "2", "epochs", "1"))
    t0 = time.perf_counter()
    prepared = prepared_train_batches()
    print(f"[train] {2 * BATCH} synthetic train samples ({cfg.wire_format} wire, "
          f"{host_bytes(prepared[0])} host bytes per sample to the card) prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    batches = [prepared[i % len(prepared)] for i in range(TRAIN_STEPS)]
    model = _model(cfg, device).train()
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, TRAIN_STEPS, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(SEED), device)
    params0, stats0 = snapshot(model)
    wrappers = launch_counts()
    _reset(wrappers)
    metrics = train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = _read(wrappers)
    loss = float(metrics["loss"])
    print(f"[train] {TRAIN_STEPS} steps at batch {BATCH}: last loss {loss:.6g}, iou "
          f"{float(metrics['iou']):.4g}; launches {launches}", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"train loss is not finite: {loss}")
    check_launches(launches, PER_STEP, TRAIN_STEPS)
    check_moved(model, params0, stats0, "train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    print(f"[time] train step batch {BATCH}: {dt * 1e3:.2f} ms = {BATCH / dt:.2f} "
          f"samples/s (prepared {cfg.wire_format} host batches in) on {smi}", flush=True)
    return launches, BATCH / dt, prepared, cfg, step


def wire_phase(step, smi: str):
    """One prepared batch of each other wire format through one train step
    of the main path's model: the loss is finite; host bytes per sample and
    the step time (the second of two steps on the batch)."""
    import torch

    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    for wire in WIRES:
        cfg = _cfg(BATCH, BATCH, ("wire_format", wire))
        t0 = time.perf_counter()
        batch = next(iter(DataLoader(build_dataset(cfg, cfg.train_split), BATCH,
                                     shuffle=True, drop_last=True, seed=SEED)))
        prep = time.perf_counter() - t0
        step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss"])
        dt = time.perf_counter() - t0
        print(f"[wire] {wire}: loss {loss:.6g}; {host_bytes(batch)} host bytes per sample; "
              f"train step {dt * 1e3:.2f} ms at batch {BATCH} (host prepared the batch in "
              f"{prep:.1f} s) on {smi}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"{wire} wire: train loss is not finite: {loss}")


def stem_timings(device, smi: str, dtype=None):
    """Forward and forward+backward of the stem alone at batch 24, 416^2,
    train mode, in ``dtype`` (bf16 unless given; phase 18: fp32): the plain
    stem, the s2d stem on cuDNN and the s2d stem on K6/K6b (K6-f32/K6b-f32
    in fp32; the same modules and weights)."""
    import torch

    from crog_tpu_torch.models.clip import ModifiedResNet

    dtype = torch.bfloat16 if dtype is None else dtype
    f32 = dtype == torch.float32
    m = ModifiedResNet((1, 1, 1, 1), 1024, 32, 416, 64).to(device).train()
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn(BATCH, 416, 416, 3, generator=g).to(device, dtype)
    dy = torch.randn(BATCH, 104, 104, 64, generator=g).to(device, dtype)
    out = []
    for label, s2d, fused in (("plain", False, False), ("s2d cuDNN", True, False),
                              ("s2d K6-f32/K6b-f32" if f32 else "s2d K6/K6b", True, True)):
        m.fused_stem = fused
        stem = m._stem_s2d if s2d else m._stem_plain
        with torch.no_grad():
            fwd = cuda_ms(lambda: stem(x))
        both = cuda_ms(lambda: stem(x).backward(dy))
        out.append(f"{label} {fwd:.3f} / {both:.3f}")
    print(f"[stem] forward / forward+backward ms at batch {BATCH}, 416^2, "
          f"{'fp32 (TF32 off)' if f32 else 'bf16'}: " + "; ".join(out) + f" on {smi}",
          flush=True)


# card (bf16, kernels) vs CPU (fp32, plain) on one train step at batch 2,
# dropout 0, with the BatchNorm layers on their running statistics: bounds
# on the loss's relative error and on the relative L2 error of each group's
# gradients.  Train-mode BatchNorm over 2 samples (the FPN's txt_proj
# normalizes 2 text states) makes these gradients ill-conditioned: on the
# CPU the same plain code in bf16 and in fp32 then differs by order 1, so
# such a comparison could not tell a wrong kernel from rounding
# (tools/torch_grad_conditioning.py measures both settings).  Train-mode
# BatchNorm itself is held against flax by tests/test_torch_train.py, and
# phase 5 runs it on the card.  bf16 keeps ~3 significant digits through
# ~70 layers forward and back; a wrong backward kernel is off by order 1.
TRAIN_LOSS_TOL = 0.05
TRAIN_GRAD_TOL = 0.25
GROUPS = (("vision", "backbone.visual."), ("text", "backbone."), ("neck", "neck."),
          ("decoder", "decoder."), ("projector", "proj."))


def _group(name):
    return next(g for g, prefix in GROUPS if name.startswith(prefix))


def mini_batch(batch, input_size: int):
    """Two samples of ``batch`` with different sentences (near-equal text
    states would leave the 2-sample txt_proj BatchNorm a vanishing
    variance), unpacked on the CPU."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch

    words = [tuple(w) for w in batch["word"]]
    j = next((i for i in range(1, len(words)) if words[i] != words[0]), 1)
    return device_batch({k: v[[0, j]] for k, v in batch.items() if isinstance(v, np.ndarray)},
                        torch.device("cpu"), input_size)


def grad_model(cfg, dev, dtype=None, running_bn: bool = True, fused_stem: bool = True):
    """The seeded model of ``cfg`` in train mode on ``dev``, its BatchNorm
    layers on their running statistics when ``running_bn``."""
    from crog_tpu_torch.models.clip import BatchNorm

    model = _model(cfg, dev, dtype, fused_stem=fused_stem).train()
    for mod in model.modules():
        if running_bn and isinstance(mod, BatchNorm):
            mod.eval()
    return model


def train_grads(model, mini):
    """(loss, {name: gradient on the CPU}) of one forward and backward of
    ``model`` on ``mini`` (the gradients are zeroed first)."""
    from crog_tpu_torch.models.crog import crog_losses

    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    put = lambda k: mini[k].to(dev)
    loss, _ = crog_losses(model(put("img"), put("word")),
                          {k: put(k) for k in ("mask", "qua", "sin", "cos", "wid")})
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}


def grad_gap(card, cpu, tag: str = "[e2e-train]"):
    """(loss rel error, {group: grad rel-L2}) of ``train_grads`` results."""
    (lc, gc), (lp, gp) = card, cpu
    if set(gc) != set(gp):
        raise AssertionError("the two runs give gradients for different parameters")
    groups = {}
    for g, _ in GROUPS:
        names = [n for n in gp if _group(n) == g]
        num = sum(float((gc[n] - gp[n]).pow(2).sum()) for n in names)
        den = sum(float(gp[n].pow(2).sum()) for n in names)
        groups[g] = (num / max(den, 1e-30)) ** 0.5
    print(f"{tag} loss {lc:.6g} vs cpu fp32 {lp:.6g}; grad rel_l2 "
          + ", ".join(f"{g} {r:.4g}" for g, r in groups.items()), flush=True)
    return abs(lc - lp) / abs(lp), groups


# the stem's conv weights: K6b-f32 computes conv2's and conv3's gradients
# and K6-f32's dgrads feed conv1's (a small part of the vision group)
STEM_PARAMS = tuple(f"backbone.visual.conv{i}.weight" for i in (1, 2, 3))


def stem_grad_gap(card, cpu) -> float:
    """The rel-L2 of ``train_grads`` results over the stem's conv weights."""
    (_, gc), (_, gp) = card, cpu
    num = sum(float((gc[n] - gp[n]).pow(2).sum()) for n in STEM_PARAMS)
    den = sum(float(gp[n].pow(2).sum()) for n in STEM_PARAMS)
    return (num / max(den, 1e-30)) ** 0.5


def train_step_gap(batch, device, running_bn: bool = True, opts=()):
    """(loss rel error, {group: grad rel-L2}) of one train step at batch 2,
    dropout 0, compute dtype on ``device`` vs fp32 on the CPU; ``opts``
    override further config keys."""
    import torch

    cfg = _cfg(opts=("dropout", "0.0", *opts))
    mini = mini_batch(batch, cfg.input_size)
    card = train_grads(grad_model(cfg, device, None, running_bn), mini)
    cpu = train_grads(grad_model(cfg, torch.device("cpu"), torch.float32, running_bn), mini)
    return grad_gap(card, cpu)


def e2e_train_step(batch, device):
    """Phase 7: loss and gradients of one train step, card vs CPU."""
    rel, groups = train_step_gap(batch, device)
    worst = max(groups.values())
    print(f"[e2e-train] loss rel {rel:.4g} (tol {TRAIN_LOSS_TOL}), worst grad rel_l2 "
          f"{worst:.4g} (tol {TRAIN_GRAD_TOL})", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"card vs CPU train step: loss rel {rel:.4g}, grad {worst:.4g}")


def e2e_agreement(model, batch, cfg):
    """Phase 6: one sample, card bf16 kernels vs CPU fp32 plain."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch
    from crog_tpu_torch.models.crog import build_crog

    one = device_batch({k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)},
                       torch.device("cpu"), cfg.input_size, train=False)
    img, word = one["img"], one["word"]
    dev = next(model.parameters()).device
    with torch.no_grad():
        card = model(img.to(dev), word.to(dev)).float().cpu()
        cpu_model = build_crog(cfg, torch.float32, fused_stem=True)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu = cpu_model.eval()(img, word)
    if card.shape != cpu.shape or not torch.isfinite(card).all():
        raise AssertionError(f"card output {tuple(card.shape)} not finite/shaped")
    worst = 0.0
    for i, name in enumerate(("mask", "qua", "sin", "cos", "wid")):
        d = card[..., i] - cpu[..., i]
        rel = float(d.norm() / cpu[..., i].norm().clamp_min(1e-6))
        worst = max(worst, rel)
        print(f"[e2e] {name}: rel_l2 {rel:.4g}, max|card-cpu| "
              f"{float(d.abs().max()):.5g}, max|cpu| "
              f"{float(cpu[..., i].abs().max()):.5g}", flush=True)
    if worst > E2E_TOL:
        raise AssertionError(f"card vs CPU logits rel_l2 {worst:.4g} > {E2E_TOL}")
    return worst


def timings(model, eval_step, batch, cfg, smi: str):
    """Phase 8: batch-1 forward latency and batch-24 eval throughput."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch

    dev = next(model.parameters()).device
    one = device_batch({k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)},
                       dev, cfg.input_size, train=False)
    img1, word1 = one["img"], one["word"]
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(img1, word1), reps=10)
    torch.cuda.synchronize()
    reps = 5
    eval_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = eval_step(batch)
    out["iou"].cpu()
    dt = (time.perf_counter() - t0) / reps
    n = len(batch["word"])
    print(f"[time] forward batch 1: {fwd_ms:.3f} ms; eval step batch {n}: "
          f"{dt * 1e3:.2f} ms = {n / dt:.2f} samples/s ({cfg.wire_format} host arrays in, "
          f"metrics out) on {smi}", flush=True)
    return fwd_ms, n / dt


# phase 17: remat (models/clip.py ``checkpointed``): the RN50 bottlenecks
# checkpointed, full and selective, against no remat on the same weights
# and prepared batch at batch 24, dropout 0
REMAT_MODES = {"off": False, "full": True, "selective": "selective"}
REMAT_TIMED_STEPS = 3  # after one warm-up step
# remat vs off, both on the card in bf16: bound on the loss's relative gap
# and on each group's gradient rel-L2.  The recompute reruns the forward's
# ops on the same inputs, so the sound reading is the card's own
# run-to-run spread of a step (``off again``; 0 on an H100, bits equal);
# a recompute that drops the gradient through the batch statistics reads
# 0.978 in the vision group (tools/torch_remat_faults.py's
# ``stats-detached``)
REMAT_GRAD_TOL = 0.02
# remat vs off: bound on each running statistic's largest gap over its
# largest magnitude.  The forward is the same code on the same values, so
# the statistics repeat bit for bit (0 on an H100); a recompute that
# updates them again moves them a further momentum (0.1) of the way to the
# batch's (``stats-twice`` reads 0.828)
REMAT_STAT_TOL = 1e-6
# bound on a remat mode's peak memory over off's: a remat that recomputes
# nothing holds what off holds (tools/torch_remat_faults.py's
# ``no-recompute`` read 1.0006, the sound full and selective 0.54 and 0.65)
REMAT_PEAK_SHARE = 0.9
WO_CONTRASTIVE_CONFIG = "config/OCID-VLG/crog_multiple_r50_wo_contrastive.yaml"


def remat_batch():
    """One prepared rawlb train batch at BATCH, as phase 5 prepares them
    (``chip_smoke.py --remat`` runs phase 17 without phase 5)."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _cfg(BATCH, BATCH)
    return next(iter(DataLoader(build_dataset(cfg, cfg.train_split), BATCH, shuffle=True,
                                drop_last=True, seed=SEED)))


def remat_run(model, cfg, batch, device):
    """One train step of ``model`` (its ``remat`` set) on ``batch``: its
    loss, launches, and gradients and buffers copied to the host (so that
    no mode's peak holds another's); then the ms per step over
    REMAT_TIMED_STEPS more after a warm-up step (CUDA events), the peak
    memory over them and the memory held before them."""
    import torch

    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.utils.seed import set_random_seed

    model.zero_grad(set_to_none=True)
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, REMAT_TIMED_STEPS + 2, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(SEED), device)
    wrappers = launch_counts()
    _reset(wrappers)
    loss = float(step(batch)["loss"])
    torch.cuda.synchronize()
    out = {"loss": loss, "launches": _read(wrappers),
           "grads": {n: p.grad.to("cpu", torch.float32, copy=True)
                     for n, p in model.named_parameters() if p.grad is not None},
           "buffers": {n: b.to("cpu", copy=True) for n, b in model.named_buffers()}}
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["held"] = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REMAT_TIMED_STEPS):
        step(batch)
    end.record()
    torch.cuda.synchronize()
    out["ms"] = start.elapsed_time(end) / REMAT_TIMED_STEPS
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def remat_readings(device, batch, modes=("off again", "full", "selective")):
    """Phase 17's readings: the off run, then each of ``modes`` from the
    same weights (``off again`` is no remat a second time, the card's own
    spread) against it: the loss's relative gap, each group's gradient
    rel-L2, the worst running statistic's gap over its largest magnitude,
    whether every ``num_batches_tracked`` equals off's, the launches, ms
    per step and the peak memory."""
    import torch

    cfg = _cfg(opts=("dropout", "0.0"))
    model = _model(cfg, device).train()
    state0 = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    runs = {}
    for label in ("off", *modes):
        model.load_state_dict(state0)
        model.backbone.visual.remat = REMAT_MODES.get(label, False)
        runs[label] = remat_run(model, cfg, batch, device)
    del model, state0
    off = runs["off"]
    readings = {}
    for label, run in runs.items():
        r = {k: run[k] for k in ("loss", "launches", "ms", "peak", "held")}
        if label != "off":
            r["loss_rel"] = abs(run["loss"] - off["loss"]) / abs(off["loss"])
            r["grads"] = {g: _rel_l2(run["grads"], {n: x for n, x in off["grads"].items()
                                                    if _group(n) == g})
                          for g, _ in GROUPS}
            stats = [n for n in off["buffers"] if "running" in n]
            r["stats"] = max(float((run["buffers"][n] - off["buffers"][n]).abs().max()
                                   / off["buffers"][n].abs().max().clamp_min(1e-12))
                             for n in stats)
            r["tracked"] = all(torch.equal(run["buffers"][n], b)
                               for n, b in off["buffers"].items()
                               if n.endswith("num_batches_tracked"))
        readings[label] = r
    return readings


def check_remat(readings):
    """Phase 17's limits on its readings: every remat mode within
    REMAT_GRAD_TOL and REMAT_STAT_TOL of off, ``num_batches_tracked`` and
    the launches equal to off's (PER_STEP), and its peak at most
    REMAT_PEAK_SHARE of off's."""
    off = readings["off"]
    check_launches(off["launches"], PER_STEP, 1)
    for label in ("full", "selective"):
        r = readings[label]
        worst = max(r["grads"].values())
        if not (r["loss_rel"] <= REMAT_GRAD_TOL and worst <= REMAT_GRAD_TOL):
            raise AssertionError(f"remat {label} vs off: loss rel {r['loss_rel']:.4g}, "
                                 f"grad rel_l2 {worst:.4g} > {REMAT_GRAD_TOL}")
        if not (r["stats"] <= REMAT_STAT_TOL and r["tracked"]):
            raise AssertionError(f"remat {label} vs off: running statistics gap "
                                 f"{r['stats']:.4g}, num_batches_tracked equal {r['tracked']}")
        if r["launches"] != off["launches"]:
            raise AssertionError(f"remat {label}: launches {r['launches']} != off's "
                                 f"{off['launches']}")
        if not r["peak"] <= REMAT_PEAK_SHARE * off["peak"]:
            raise AssertionError(f"remat {label}: peak {r['peak']} B is above "
                                 f"{REMAT_PEAK_SHARE} of off's {off['peak']} B")


def counted_run(totals):
    """run(fn) -> (fn(), {kernel: launches}): fn with every launch counter
    from 0, synchronized, its launches added to ``totals``."""
    import torch

    wrappers = launch_counts()

    def run(fn):
        _reset(wrappers)
        out = fn()
        torch.cuda.synchronize()
        launches = _read(wrappers)
        for n, k in launches.items():
            totals[n] += k
        return out, launches

    return run


def _launched(launches):
    return {n: k for n, k in launches.items() if k}


def _wo_contrastive_cfg():
    from crog_tpu_torch.config import load_cfg_from_cfg_file

    return load_cfg_from_cfg_file(WO_CONTRASTIVE_CONFIG)


def wo_contrastive_step(device, batch, smi: str):
    """crog_multiple_r50_wo_contrastive.yaml's model (no decoder), seeded:
    one eval forward and one train step on ``batch``; the output and the
    loss are finite, and no decoder kernel (K2-K4b) launches."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch

    cfg = _wo_contrastive_cfg()
    model = _model(cfg, device)
    dense = device_batch(batch, device, cfg.input_size, train=False)
    wrappers = launch_counts()
    _reset(wrappers)
    with torch.no_grad():
        out = model.eval()(dense["img"], dense["word"])
    torch.cuda.synchronize()
    fwd = _read(wrappers)
    size = cfg.input_size // 4
    if tuple(out.shape) != (BATCH, size, size, 5) or not torch.isfinite(out).all():
        raise AssertionError(f"wo_contrastive output {tuple(out.shape)} not finite/shaped")
    check_launches(fwd, {"attention": 1, "s2dconv": 2}, 1)
    run = remat_run(model.train(), cfg, batch, device)
    if not math.isfinite(run["loss"]):
        raise AssertionError(f"wo_contrastive train loss is not finite: {run['loss']}")
    check_launches(run["launches"], {"attention": 1, "attention_bwd": 1, "s2dconv": 4,
                                     "s2dconv_wgrad": 2}, 1)
    print(f"[remat] wo_contrastive (no decoder): eval forward finite {tuple(out.shape)}, "
          f"launches {_launched(fwd)}; train step loss {run['loss']:.6g}, launches "
          f"{_launched(run['launches'])}, "
          f"{run['ms']:.2f} ms, peak {run['peak'] / 2**30:.2f} GiB at batch {BATCH} on {smi}",
          flush=True)


def remat_phase(device, batch, smi: str):
    """Phase 17: remat off, full and selective, then the wo_contrastive
    model's eval forward and train step."""
    import torch

    t0 = time.perf_counter()
    readings = remat_readings(device, batch)
    torch.cuda.empty_cache()
    for label, r in readings.items():
        if label == "off":
            gap = f"; launches {_launched(r['launches'])}"
        else:
            gap = (f"; vs off: loss rel {r['loss_rel']:.4g}, grad rel_l2 "
                   + ", ".join(f"{g} {x:.4g}" for g, x in r["grads"].items())
                   + f", running statistics gap {r['stats']:.4g}, num_batches_tracked "
                   f"equal {r['tracked']}, launches equal "
                   f"{r['launches'] == readings['off']['launches']}")
        print(f"[remat] {label}: {r['ms']:.2f} ms per train step, peak "
              f"{r['peak'] / 2**30:.2f} GiB (held before the step {r['held'] / 2**30:.2f} "
              f"GiB), loss {r['loss']:.6g}{gap}; batch {BATCH} on {smi}", flush=True)
    check_remat(readings)
    wo_contrastive_step(device, batch, smi)
    torch.cuda.empty_cache()
    print(f"[remat] phase 17 took {time.perf_counter() - t0:.1f} s; limits: "
          f"REMAT_GRAD_TOL {REMAT_GRAD_TOL}, REMAT_STAT_TOL {REMAT_STAT_TOL}, "
          f"REMAT_PEAK_SHARE {REMAT_PEAK_SHARE}", flush=True)
    return readings


# phase 18: the CROG eval and train paths at compute_dtype float32 on the
# card, through the fp32 kernels K1-f32..K4-f32 (csrc/attention_f32.cu,
# decoder_blocks_f32.cu, ffn_f32.cu) and K1b-f32..K4b-f32
# (csrc/attention_bwd_f32.cu, decoder_blocks_bwd_f32.cu, ffn_bwd_f32.cu)
PER_FORWARD_F32 = {"attention_f32": 1, "decoder_self_block_f32": 3,
                   "decoder_cross_block_f32": 3, "ffn_f32": 3}
PER_STEP_F32 = {**PER_FORWARD_F32, **{n.replace("_f32", "_bwd_f32"): k
                                      for n, k in PER_FORWARD_F32.items()}}
# and with the fused s2d stem (``--fused-stem``): K6-f32 for conv2 and conv3
# (in a step also their dgrads) and K6b-f32 for their weight gradients
PER_FORWARD_F32_FUSED = {**PER_FORWARD_F32, "s2dconv_f32": 2}
PER_STEP_F32_FUSED = {**PER_STEP_F32, "s2dconv_f32": 4, "s2dconv_wgrad_f32": 2}
# fp32 kernel vs its fp32 twin on the card (TF32 off), relative L2 error of
# each output.  The kernels form every product as 3xTF32, which keeps f32
# accuracy (the dropped lo*lo term is below 2^-21 of each product), and sum
# in another order than the library's fp32 GEMMs and softmax: ~1e-6.  One
# TF32 pass rounds each operand to 2^-11, bf16 staging to 2^-9, and either
# moves the outputs by ~1e-4..1e-3: the twin with one product so formed
# (``fp32_twin_controls``) must read above the limit against the sound twin.
# tools/torch_fp32_faults.py plants the same faults in the kernels
# themselves; PERF.md has both readings.
F32_REL_L2 = 1e-5
# the products of each fp32 kernel's twin, by the order of the twin's
# torch.matmul calls (``dense`` and ``attention_plain`` form each product
# with one)
_BLOCK_PRODUCTS = {"projections": (0, 1, 2), "QK^T": (3,), "P.V": (4,),
                   "out-projection": (5,)}
F32_PRODUCTS = {"attention_f32": {"QK^T": (0,), "P.V": (1,)},
                "decoder_self_block_f32": _BLOCK_PRODUCTS,
                "decoder_cross_block_f32": _BLOCK_PRODUCTS,
                "ffn_f32": {"hidden product": (0,), "output product": (1,)}}
# fp32 backward kernel vs its fp32 twin on the card (TF32 off), relative L2
# error of each gradient output, every output within it; set between the
# sound kernels and the twins with one product formed by one TF32 pass or
# from bf16-staged operands (the control reads the worst output), as
# F32_REL_L2 is.  tools/torch_fp32_faults.py plants the same faults in the
# kernels; PERF.md has both readings.
F32_BWD_REL_L2 = 1e-5
# the products of each fp32 backward kernel in its twin's torch.matmul
# calls: the block twins first recompute the forward (calls 0-5), which the
# kernels read from the forward's intermediates
_BLOCK_BWD_PRODUCTS = {"dO": (6,), "QK^T": (7,), "dV": (8,), "dP": (9,), "dQ": (10,),
                       "dK": (11,), "dX": (12, 13, 14), "dW": (15, 16, 17, 18)}
F32_BWD_PRODUCTS = {"attention_bwd_f32": {"QK^T": (0,), "dV": (1,), "dP": (2,), "dQ": (3,),
                                          "dK": (4,)},
                    "decoder_self_block_bwd_f32": _BLOCK_BWD_PRODUCTS,
                    "decoder_cross_block_bwd_f32": _BLOCK_BWD_PRODUCTS,
                    "ffn_bwd_f32": {"recompute": (0,), "dhn": (1,), "dx": (2,), "dW1": (3,),
                                    "dW2": (4,)}}
# K6-f32's and K6b-f32's one product each in their twins' torch.matmul
# calls (conv_padded_plain, wgrad_plain): held to F32_REL_L2 and
# F32_BWD_REL_L2 as the other forward and backward kernels are
F32_S2D_PRODUCTS = {"s2dconv_f32": {"patch product": (0,)},
                    "s2dconv_wgrad_f32": {"patch^T dy": (0,)}}
# K4b-f32 against its twin: the ReLU's decision h > 0 is discontinuous, and
# a pre-activation within rounding of 0 may take one sign in the kernel's
# recompute (3xTF32, the forward's own sums) and the other in the twin's
# fp32 GEMM; one such element moves a whole row of dx by order 1 (about
# 2.5e-4 of dx's norm at the main path).  So the twin takes the kernel's
# decision, and every element where the two decisions differ must have a
# pre-activation |x W1^T + b1| (of order 1 here) within F32_RELU_TIE of 0.
F32_RELU_TIE = 1e-5


def round_tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 explicit
    mantissa bits, to nearest, ties away from zero), as f32."""
    import torch

    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return x.bfloat16().float()


# a product's operands as one TF32 pass or bf16 staging forms them
F32_FAULTS = {"1xTF32": round_tf32, "bf16-staged": round_bf16}


class lossy_products:
    """Within the block, torch.matmul rounds the operands of its calls
    number ``calls`` (counted from 0) by ``rnd``: a twin with those products
    formed at lower precision.  ``count`` is the calls made."""

    def __init__(self, calls=(), rnd=round_tf32):
        self.calls, self.rnd, self.count = set(calls), rnd, 0

    def __enter__(self):
        import torch

        self.matmul = torch.matmul

        def matmul(a, b, *args, **kw):
            if self.count in self.calls:
                a, b = self.rnd(a), self.rnd(b)
            self.count += 1
            return self.matmul(a, b, *args, **kw)

        torch.matmul = matmul
        return self

    def __exit__(self, *exc):
        import torch

        torch.matmul = self.matmul


# card (fp32 kernels, cuDNN and cuBLAS with TF32 off) vs CPU (fp32 plain)
# on one sample: relative L2 error of each logit map (and of each SSG
# output).  Both compute the same fp32 function; sums in another order
# grow through the ~70 layers of a random network to ~1e-5; bf16 anywhere
# (E2E_TOL's 0.15) or one TF32 pass is off by more than 1e-3.
F32_E2E_TOL = 1e-3
# the eval step at batch 24, card vs CPU: per-sample IoU (thresholded maps,
# where a pixel at the threshold can flip), and the share of (sample, peak)
# grasp rects with equal validity and position (two peaks whose qualities
# differ by less than the card-CPU gap can swap rank)
F32_IOU_TOL = 2e-3
F32_RECT_SHARE = 0.95
# one fp32 train step at batch 2, dropout 0, BatchNorm on running
# statistics, card (fp32 kernels, cuDNN and cuBLAS with TF32 off) vs CPU
# (fp32 plain): the loss's relative error and each group's gradient
# relative L2 error.  Both compute the same fp32 function and differ in the
# order of their sums, which the attention pool's softmax gradient (dS =
# P (dP - delta), cancelling) amplifies in the vision group to 1.2e-3 (its
# q and k projections); the card repeats itself to 3e-7.  Each group's
# limit lies between its sound reading and the step with the library's
# TF32 on (cuBLAS and cuDNN); the decoder's, whose gradients K2b-K4b-f32
# compute, also below K2b-f32's dO, dX and dW and K4b-f32's recompute, dhn
# and dx planted bf16-staged and K4b-f32's recompute planted as one TF32
# pass.  The attention products and K4b-f32's dW1 and dW2 planted move no
# group over its limit: phase 18 (a) alone holds them
# (tools/torch_fp32_faults.py; PERF.md has the readings).
F32_TRAIN_LOSS_TOL = 3e-5
F32_TRAIN_GRAD_TOL = {"vision": 3e-3, "text": 1e-3, "neck": 1.5e-3, "decoder": 2.5e-4,
                      "projector": 2e-4}


def rel_l2(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def worst_rel_l2(got, ref) -> float:
    """rel_l2 of a tensor, or the largest over the outputs of a tuple (a
    backward's gradients; extra outputs of ``got`` are not compared)."""
    if isinstance(ref, (tuple, list)):
        return max(rel_l2(g, r) for g, r in zip(got, ref))
    return rel_l2(got, ref)


def fp32_twin_controls(twins, refs, products=None):
    """Each fp32 twin (``twins``: name -> plain call) with one product at a
    time formed by one TF32 pass or from bf16-staged operands:
    {kernel: {product: {fault: rel-L2 against the sound twin
    ``refs[kernel]`` (of a backward, its worst output)}}}, over the
    kernels of ``products`` (F32_PRODUCTS, or F32_BWD_PRODUCTS)."""
    out = {}
    for name, by_product in (F32_PRODUCTS if products is None else products).items():
        out[name] = {}
        calls_made = 1 + max(max(c) for c in by_product.values())
        for product, calls in by_product.items():
            out[name][product] = {}
            for fault, rnd in F32_FAULTS.items():
                with lossy_products(calls, rnd) as lossy:
                    got = twins[name]()
                if lossy.count != calls_made:
                    raise AssertionError(f"{name}'s twin made {lossy.count} matmul calls, "
                                         f"expected {calls_made}")
                out[name][product][fault] = worst_rel_l2(got, refs[name])
    return out


def check_controls(controls, limit: float, tag: str = "[fp32]"):
    """Print each twin control; raise unless every one reads above ``limit``."""
    for name, by_product in controls.items():
        print(f"{tag} {name}'s twin, one product lossy (rel_l2 against the sound twin, "
              f"limit {limit}): "
              + "; ".join(f"{p} " + ", ".join(f"{f} {r:.3g}" for f, r in fr.items())
                          for p, fr in by_product.items()), flush=True)
    seen = [(n, p, f) for n, bp in controls.items() for p, fr in bp.items()
            for f, r in fr.items() if not r > limit]
    if seen:
        raise AssertionError(f"limit {limit} does not see these lossy products: {seen}")


def check_f32_grads(label: str, outs, got, ref):
    """Each gradient output of an fp32 backward kernel finite and within
    F32_BWD_REL_L2 of its twin's; returns the largest abs error."""
    import torch

    torch.cuda.synchronize()
    rels = {o: rel_l2(g, r) for o, g, r in zip(outs, got, ref)}
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"[fp32] {label}: rel_l2 " + ", ".join(f"{o} {r:.3g}" for o, r in rels.items())
          + f" (limit {F32_BWD_REL_L2}), max_abs_err {err:.3g}", flush=True)
    bad = [o for o, g in zip(outs, got)
           if not (bool(torch.isfinite(g).all()) and rels[o] <= F32_BWD_REL_L2)]
    if bad:
        raise AssertionError(f"{label} disagrees with its fp32 twin at {bad}")
    return err


def fp32_kernels(device, timed: bool = True):
    """Phase 18 (a): K1-f32..K4-f32 against their fp32 twins at the main
    path's shapes in eval and with train-mode dropout (RATE, the same
    counter-based mask), within F32_REL_L2; each twin with one product
    formed at lower precision above it; timed beside the twin and SDPA
    (K1), and K1-f32..K3-f32 by part beside F.linear and SDPA at each
    product's and attention step's shape (``f32_block_products``), all
    fp32.  Returns the records."""
    import torch

    inp = kernel_inputs(device, dtype=torch.float32)
    records, refs = {}, {}
    with torch.no_grad():
        cases = kernel_cases(inp)
        for name, (kern, plain, lib, flops, nb) in cases.items():
            n32 = name + "_f32"
            got, refs[n32] = kern(), plain()
            torch.cuda.synchronize()
            rel = rel_l2(got, refs[n32])
            err = float((got - refs[n32]).abs().max())
            print(f"[fp32] {n32} (eval): rel_l2 {rel:.3g} (limit {F32_REL_L2}), max_abs_err "
                  f"{err:.3g}, max|ref| {float(refs[n32].abs().max()):.4g}", flush=True)
            if not (bool(torch.isfinite(got).all()) and rel <= F32_REL_L2):
                raise AssertionError(f"{n32} disagrees with its fp32 twin: rel_l2 {rel:.3g}")
            records[n32] = _record(n32, err, *bound(flops, nb, PEAK_F32_TC_FLOPS))
            if timed:
                _time(records[n32], kern, plain, lib if name == "attention" else None)
        for name, (kern, plain) in dropout_cases(inp).items():
            got, ref = kern(), plain()
            rel = rel_l2(got, ref)
            print(f"[fp32] {name}_f32 (dropout {RATE}): rel_l2 {rel:.3g} (limit "
                  f"{F32_REL_L2})", flush=True)
            if not (bool(torch.isfinite(got).all()) and rel <= F32_REL_L2):
                raise AssertionError(f"{name}_f32 in train mode disagrees with its twin")
        check_controls(fp32_twin_controls({n + "_f32": c[1] for n, c in cases.items()},
                                          refs), F32_REL_L2)
        if timed:
            f32_block_products(inp, smi_line())
        records.update(fp32_backward_kernels(inp, timed))
        del inp
        records.update(fp32_s2dconv(device, timed))
    return records


def fp32_s2dconv(device, timed: bool = True):
    """Phase 18 (a), the stem: K6-f32 at the stem's four launches of a train
    step (conv2 and conv3 forward, both dgrads) and K6b-f32 at conv2 and
    conv3, batch 24 on 104 x 104 cells, full fp32 values, against their fp32
    twins within F32_REL_L2 (K6-f32) and F32_BWD_REL_L2 (K6b-f32), each
    twice with equal bits, its twin with the product formed by one TF32 pass
    or from bf16-staged operands above the limit; each timed beside its
    twin, cuDNN's fp32 conv of the blocked tensor with block_kernel_s1 (for
    K6b-f32 conv2d_weight of it; TF32 off) and cuDNN's plain 3x3 conv of
    the unblocked 208^2 tensor.  Records per CROG train step, as
    ``check_s2dconv``'s."""
    import torch

    records = {}
    for name, cases in s2dconv_cases(device, dtype=torch.float32).items():
        n32 = name + "_f32"
        kid = "K6b-f32" if name == "s2dconv_wgrad" else "K6-f32"
        limit = F32_BWD_REL_L2 if name == "s2dconv_wgrad" else F32_REL_L2
        rec = _record(n32, 0.0, 0.0, "bytes")
        if timed:
            rec.update(ms=0.0, plain_ms=0.0, library_ms=0.0)
        unblocked_ms = 0.0
        for label, kern, plain, lib, lib_plain, flops, nb, _ in cases:
            got, again, ref = kern(), kern(), plain()
            torch.cuda.synchronize()
            rel, err = rel_l2(got, ref), float((got - ref).abs().max())
            same = torch.equal(got, again)
            print(f"[fp32] {n32} ({label}): rel_l2 {rel:.3g} (limit {limit}), max_abs_err "
                  f"{err:.3g}, max|ref| {float(ref.abs().max()):.4g}; twice: "
                  f"{'equal bits' if same else 'DIFFERENT bits'}", flush=True)
            if not (bool(torch.isfinite(got).all()) and rel <= limit and same):
                raise AssertionError(f"{n32} ({label}) disagrees with its fp32 twin or is "
                                     f"not repeatable: rel_l2 {rel:.3g}")
            del got, again
            key = f"{n32} ({label})"
            check_controls(fp32_twin_controls({key: plain}, {key: ref},
                                              {key: F32_S2D_PRODUCTS[n32]}), limit)
            del ref
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            bms, by = bound(flops, nb, PEAK_F32_TC_FLOPS)
            rec["bound_ms"] += bms
            if by == "operations":
                rec["bound_by"] = "operations"
            if timed:
                unblocked_ms += time_s2d(rec, kid, label, kern, plain, lib, lib_plain, bms,
                                         by, "[fp32]", " fp32")
        if timed:
            s2d_step_line(rec, unblocked_ms, "[fp32]", " fp32")
            f32_s2d_products({name: cases}, smi_line())
        records[n32] = rec
    return records


def s2d_f32_parts(seq):
    """The kernels of one K6-f32 or K6b-f32 launch in launch order ->
    [(part, device ms)]: the product (gemm_wgmma_f32.cuh's kernel, or an
    older tree's s2dconv_f32 kernel), the split of wp or dy into TF32
    planes, the fixed-order sum of K6b-f32's partials."""
    parts = {}
    for name, t in seq:
        if "split_b" in name:
            part = "planes"
        elif "reduce_parts" in name:
            part = "sums"
        elif "gemm" in name or "s2dconv" in name:
            part = "product"
        else:
            part = "the rest"
        parts[part] = parts.get(part, 0.0) + t
    return list(parts.items())


def s2d_f32_executed(label: str, b=BATCH, cells=104) -> float:
    """The FLOPs K6-f32 or K6b-f32 executes at an ``s2dconv_cases``
    launch: the whole packed [16ci, 4co] weight over every cell, less the
    slot-rows K6-f32 skips in each 128-column tile (ops/s2dconv.py
    fwd_f32_slot_rows); K6b-f32 forms every block."""
    from crog_tpu_torch.ops import s2dconv as SC

    c_in, c_out = s2d_launch_widths(label)
    full = 2.0 * b * cells * cells * 16 * c_in * 4 * c_out
    slot_rows = getattr(SC, "fwd_f32_slot_rows", None)  # an older tree skips none
    if label.endswith("wgrad") or slot_rows is None:
        return full
    rows = [slot_rows(c_out, n0) for n0 in range(0, 4 * c_out, 128)]
    return full * sum(hi - lo for lo, hi in rows) / (4 * len(rows))


def f32_s2d_products(cases, smi: str):
    """Phase 18 (a), the stem: each K6-f32 and K6b-f32 launch of a train
    step (``cases``: ``s2dconv_cases`` at fp32) by the profiler's device
    time, split in launch order (``s2d_f32_parts``) into the product, wp's
    or dy's TF32 planes and the fixed-order sums, with the product's rate
    over the FLOPs it executes (``s2d_f32_executed``) and its bound (the
    real taps), beside cuDNN's fp32 conv of the blocked and of the
    unblocked 208^2 tensor (``conv2d_weight`` for K6b-f32; TF32 off); every
    line names the card.  Returns {(kernel, "label part"): (device ms,
    cuDNN blocked device ms)}, the part "device" for the launch's whole
    device time, None where the profiler saw none."""
    shown = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    out = {}
    for name, launches in cases.items():
        kid = "K6b-f32" if name == "s2dconv_wgrad" else "K6-f32"
        call = "conv2d_weight" if kid == "K6b-f32" else "F.conv2d"
        for label, kern, _, lib, lib_plain, flops, nb, _ in launches:
            dev, _, seq = device_ms(kern)
            lib_ms, ub_ms = device_ms(lib)[0], device_ms(lib_plain)[0]
            parts = dict(s2d_f32_parts(seq)) if seq is not None else {}
            prod = parts.get("product")
            rate = ("" if prod is None else
                    f", {s2d_f32_executed(label) / prod / 1e9:.1f} TFLOP/s executed, "
                    f"{flops / prod / 1e9:.1f} real taps")
            bms, by = bound(flops, nb, PEAK_F32_TC_FLOPS)
            print(f"[fp32] {kid} {label}: device {shown(dev)} (" + ", ".join(
                f"{p} {t:.4f}" for p, t in parts.items()) + f"{rate}; bound {bms:.4f} ms by "
                f"{by}); cuDNN fp32 {call} blocked {shown(lib_ms)}, unblocked 208^2 "
                f"{shown(ub_ms)}; {smi}", flush=True)
            out[kid, f"{label} device"] = (dev, lib_ms)
            for p in ("product", "planes", "sums"):
                if p in parts:
                    out[kid, f"{label} {p}"] = (parts[p], None)
    return out


def ffn_f32_relu_decision(args, seed: int, rate: float):
    """K4b-f32's (or, on bf16 ``args``, K4b's) ReLU decision over ``args``
    (x, w1, b1, gamma, beta, w2, dy) for ffn_bwd_plain's ``relu_mask``: its
    dh != 0 (0 where dropout drops an element, whatever the decision),
    after checking that it differs from the twin's only at pre-activations
    within F32_RELU_TIE."""
    import torch

    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF
    from crog_tpu_torch.ops.dropout import dropout_keep

    active = FF.ffn_bwd(*args, seed, rate, with_hidden=True)[7] != 0
    pre = DB.dense(*args[:3])
    differ = ((pre > 0) & dropout_keep(seed, rate, *pre.shape, pre.device)) != active
    n = int(differ.sum())
    tie = float(pre[differ].abs().max()) if n else 0.0
    f32 = pre.dtype == torch.float32
    kid = "K4b-f32" if f32 else "K4b"
    print(f"{'[fp32]' if f32 else '[kernels]'} {kid}'s ReLU decision at M={pre.shape[0]}, "
          f"D={args[0].shape[1]}, dropout {rate}: differs from the twin's at {n} of "
          f"{active.numel()} hidden elements, largest |pre-activation| there {tie:.3g} (limit "
          f"{F32_RELU_TIE})", flush=True)
    if tie > F32_RELU_TIE:
        raise AssertionError(f"{kid}'s ReLU decision differs from the twin's at "
                             f"|pre-activation| {tie:.3g}")
    return active


def f32_backward_cases(inp):
    """``backward_cases`` for phase 18 (fp32 ``inp``), K4b's twin on K4b-f32's
    ReLU decision (``ffn_f32_relu_decision``); phase 21 holds bf16 K4b at
    D 1024 so too (``wide_kernels``)."""
    from crog_tpu_torch.ops import ffn as FF

    cases = backward_cases(inp)
    fa = (*_args(inp)[2][:6], inp["dy"]["ffn"])
    active = ffn_f32_relu_decision(fa, SEED + 3, RATE)
    kern, _, lib, flops, nb, outs = cases["ffn_bwd"]
    twin = lambda: FF.ffn_bwd_plain(*fa, SEED + 3, RATE, relu_mask=active)
    cases["ffn_bwd"] = (kern, twin, lib, flops, nb, outs)
    return cases


def fp32_backward_kernels(inp, timed: bool = True):
    """Phase 18 (a), the backward: K1b-f32..K4b-f32 at the main path's
    shapes against their fp32 twins, every gradient output within
    F32_BWD_REL_L2, with dropout RATE (K1b has none) and at dropout 0;
    K2b-f32, K3b-f32 and K4b-f32 twice at both rates with equal bits; each
    twin with one product formed at lower precision above the limit; each
    kernel timed beside its twin (K1b-f32 beside SDPA's fp32 backward),
    SDPA's fp32 backward at K2b's and K3b's attention shapes and fp32
    torch.mm at the shapes of K2b's, K3b's and K4b's products.  Returns the
    records."""
    records, refs = {}, {}
    cases = f32_backward_cases(inp)
    for name, (kern, plain, lib, flops, nb, outs) in cases.items():
        n32 = name + "_f32"
        got, refs[n32] = kern(), plain()
        rate = 0.0 if name == "attention_bwd" else RATE
        err = check_f32_grads(f"{n32} (dropout {rate})", outs, got, refs[n32])
        records[n32] = _record(n32, err, *bound(flops, nb, PEAK_F32_TC_FLOPS))
        if timed:
            _time(records[n32], kern, plain, lib if name == "attention_bwd" else None)
    del got
    f32_bwd_rate_checks(inp)
    check_controls(fp32_twin_controls({n + "_f32": c[1] for n, c in cases.items()}, refs,
                                      F32_BWD_PRODUCTS), F32_BWD_REL_L2)
    if timed:
        dev = inp["ffn"]["x"].device
        smi = smi_line()
        f32_attention_bwd_steps(dev, smi)
        f32_grad_yardsticks(dev)
        f32_ffn_products(inp, smi)
        f32_block_bwd_products(inp, smi)
    return records


def f32_attention_bwd_steps(device, smi: str, b=BATCH, l=676, t=17, heads=8):
    """The fp32 attention backward at each shape it runs, beside SDPA's fp32
    backward (TF32 off; the key mask as ``attn_mask``) at the same shape:
    K1b-f32 on K1-f32's logsumexp at the CLIP attention pool (B 24, 169
    tokens, 32 heads) and at the ViTs' 197 (ViT-B/16, 12 heads) and 577
    tokens (ViT-L/14 at 336, 16 heads), batch VIT_BATCH; and the attention
    step of K2b-f32 (676 tokens, 8 heads) and K3b-f32 (676 queries over 17
    masked text keys) on its pre-pass.  Each within F32_BWD_REL_L2 of its
    twin, twice with equal bits, timed by CUDA events (device time in
    ``print_device_times``) beside its bound; every line names the card."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(SEED + 13)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device)
    lengths = torch.randint(4, t + 1, (b,), generator=g)
    mask = torch.where(torch.arange(t)[None, :] >= lengths[:, None], A.NEG, 0.0).to(device)
    cases = ((f"K1b-f32 at the attention pool (B {b}, 169 tokens, 32 heads)", b, 169, 169, 32,
              None, True),
             (f"K1b-f32 at ViT-B/16 (B {VIT_BATCH}, 197 tokens, 12 heads)", VIT_BATCH, 197,
              197, 12, None, True),
             (f"K1b-f32 at ViT-L/14 336 (B {VIT_BATCH}, 577 tokens, 16 heads)", VIT_BATCH,
              577, 577, 16, None, True),
             (f"K2b-f32's attention step (B {b}, {l} tokens, {heads} heads)", b, l, l, heads,
              None, False),
             (f"K3b-f32's attention step (B {b}, {l} queries, {t} keys, key mask)", b, l, t,
              heads, mask, False))
    for label, bb, lq, lk, hh, m, k1b in cases:
        d = hh * 64
        q, do, k, v = rnd(bb, lq, d), rnd(bb, lq, d), rnd(bb, lk, d), rnd(bb, lk, d)
        o, lse = A.fused_attention(q, k, v, hh, m, with_lse=True)
        if k1b:
            kern = lambda q=q, k=k, v=v, o=o, do=do, m=m, lse=lse, hh=hh: A.attention_bwd(
                q, k, v, o, do, hh, mask_add=m, lse=lse)
            ref = A.attention_bwd_plain(q, k, v, o, do, hh, lse, m)
        else:
            kern = lambda q=q, k=k, v=v, o=o, do=do, m=m, hh=hh: A.attention_bwd(
                q, k, v, o, do, hh, bf16_casts=True, mask_add=m)
            ref = A.mha_bwd_plain(q, k, v, do, hh, m)
        got, again = kern(), kern()
        check_f32_grads(label, ("dq", "dk", "dv"), got, ref)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{label} is not repeatable")
        del got, again, ref
        split = lambda x, hh=hh, bb=bb: x.view(bb, x.shape[1], hh, 64).transpose(1, 2)
        leaves = [split(x).detach().requires_grad_() for x in (q, k, v)]
        am = None if m is None else m[:, None, None, :]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
        lib = lambda out=out, leaves=leaves, do=do, split=split: torch.autograd.grad(
            out, leaves, split(do), retain_graph=True)
        bms, by = bound(10.0 * bb * lq * lk * d, nbytes(q, k, v, do, q, k, v)
                        + (nbytes(o, lse) if k1b else 0), PEAK_F32_TC_FLOPS)
        ms, lib_ms = cuda_ms(kern), cuda_ms(lib)
        print(f"[fp32] {label}: {ms:.4f} ms, SDPA fp32 backward {lib_ms:.4f} ms "
              f"({ms / lib_ms:.3f}x), bound {bms:.4f} ms by {by}; {smi}", flush=True)
        DEVICE_TIMED.append((f"{label} (the fp32 attention backward)", ms, kern, None, None))
        DEVICE_TIMED.append((f"SDPA fp32 backward at {label[label.index('('):]}", lib_ms, lib,
                             None, None))
        del out, leaves


def f32_ffn_products(inp, smi: str):
    """Phase 18 (a): each product of K4-f32 and K4b-f32 at the main path's
    shapes (dropout RATE) by the profiler's device time, split in launch
    order (``f32_parts``), with its rate and bound, beside fp32 cuBLAS
    (TF32 off) at its shape: F.linear with the bias for the hidden, its
    recompute and y, torch.mm for dhn, dx, dW1 and dW2; every line names
    the card.  Returns {(kernel, product): (device ms, cuBLAS device ms)}
    and {(kernel, "device"): (the call's device ms, None)}, None where the
    profiler saw no device time."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import ffn as FF

    x, w1, b1, g, be, w2, b2 = _args(inp)[2]
    dy = inp["dy"]["ffn"]
    m, d = x.shape
    f = w1.shape[0]
    gen = torch.Generator().manual_seed(SEED + 15)
    hid = torch.randn(m, f, generator=gen).to(x.device)  # an operand of the hidden's shape
    calls = {"K4-f32": lambda: FF.ffn_fwd(x, w1, b1, g, be, w2, b2, SEED + 3, RATE),
             "K4b-f32": lambda: FF.ffn_bwd(x, w1, b1, g, be, w2, dy, SEED + 3, RATE)}
    shapes = {"hidden": f"[{m}, {d}] x [{f}, {d}]^T", "y": f"[{m}, {f}] x [{d}, {f}]^T",
              "dhn": f"[{m}, {d}] x [{d}, {f}]", "dx": f"[{m}, {f}] x [{f}, {d}]",
              "dW1": f"[{m}, {f}]^T x [{m}, {d}]", "dW2": f"[{m}, {d}]^T x [{m}, {f}]"}
    shapes["recompute"] = shapes["hidden"]
    cublas = {"hidden": ("F.linear", lambda: F.linear(x, w1, b1)),
              "y": ("F.linear", lambda: F.linear(hid, w2, b2)),
              "dhn": ("torch.mm", lambda: torch.mm(dy, w2)),
              "dx": ("torch.mm", lambda: torch.mm(hid, w1)),
              "dW1": ("torch.mm", lambda: torch.mm(hid.t(), x)),
              "dW2": ("torch.mm", lambda: torch.mm(dy.t(), hid))}
    lib_ms = {p: device_ms(call)[0] for p, (_, call) in cublas.items()}
    lib_ms["recompute"] = lib_ms["hidden"]
    cublas["recompute"] = cublas["hidden"]
    flops = 2.0 * m * d * f
    bms, by = bound(flops, 0, PEAK_F32_TC_FLOPS)
    shown = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    out = {}
    for kid, call in calls.items():
        dev, _, seq = device_ms(call)
        out[kid, "device"] = (dev, None)
        parts = dict(F32_PARTS[kid](seq)) if seq is not None else {}
        print(f"[fp32] {kid} at M={m}: device time {shown(dev)} (" + ", ".join(
            f"{p} {t:.4f}" for p, t in parts.items()) + f"); {smi}", flush=True)
        for p in F32_FFN_PRODUCTS[kid]:
            ms, lib = parts.get(p), lib_ms[p]
            rate = "" if ms is None else f", {flops / ms / 1e9:.1f} TFLOP/s"
            ratio = "" if ms is None or lib is None else f", {ms / lib:.3f}x"
            print(f"[fp32] {kid} {p} {shapes[p]}: {shown(ms)}{rate} (bound {bms:.4f} ms by "
                  f"{by}); fp32 cuBLAS {cublas[p][0]} {shown(lib)}{ratio}; {smi}", flush=True)
            out[kid, p] = (ms, lib)
    return out


def f32_block_products(inp, smi: str):
    """Phase 18 (a): K1-f32 at the attention pool, and K2-f32 and K3-f32
    (train mode, dropout RATE) at the main path's shapes, by the profiler's
    device time, split in launch order (``F32_PARTS``): each product beside
    fp32 cuBLAS (``F.linear`` with the bias, TF32 off) at its shape, each
    attention step beside SDPA's fp32 forward at its shape (the key mask as
    ``attn_mask``), with its rate and bound; every line names the card.
    Returns {(kernel, part): (device ms, library device ms)} and {(kernel,
    "device"): (the call's device ms, None)}, as ``f32_ffn_products``."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB

    sargs, cargs, _ = _args(inp)
    a = inp["attention"]
    b, l, d = sargs[0].shape
    t = cargs[1].shape[1]
    rows = {"m": b * l, "mt": b * t}
    mask = DB.key_mask(cargs[4], b, t, sargs[0].device)
    gen = torch.Generator().manual_seed(SEED + 16)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(sargs[0].device)  # noqa: E731
    calls = {"K1-f32": lambda: A.fused_attention(a["q"], a["k"], a["v"], a["heads"]),
             "K2-f32": lambda: DB.self_block_fwd(*sargs, SEED + 1, RATE)[0],
             "K3-f32": lambda: DB.cross_block_fwd(*cargs, SEED + 2, RATE)[0]}
    # (batch, queries, keys, heads, key mask) of each attention step
    steps = {"K1-f32": (b, a["q"].shape[1], a["q"].shape[1], a["heads"], None),
             "K2-f32": (b, l, l, 8, None), "K3-f32": (b, l, t, 8, mask)}
    shown = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
    out = {}
    for kid, call in calls.items():
        dev, _, seq = device_ms(call)
        out[kid, "device"] = (dev, None)
        parts = dict(F32_PARTS[kid](seq)) if seq is not None else {}
        print(f"[fp32] {kid} at B={b}: device time {shown(dev)} (" + ", ".join(
            f"{p} {x:.4f}" for p, x in parts.items()) + f"); {smi}", flush=True)
        for name, rk, cols in F32_BLOCK_PRODUCTS.get(kid, ()):
            m, n = rows[rk], cols * d
            x, w, bias = rnd(m, d), rnd(n, d), rnd(n)
            lib = device_ms(lambda x=x, w=w, bias=bias: F.linear(x, w, bias))[0]
            ms, flops = parts.get(name), 2.0 * m * d * n
            bms, by = bound(flops, 0, PEAK_F32_TC_FLOPS)
            rate = "" if ms is None else f", {flops / ms / 1e9:.1f} TFLOP/s"
            ratio = "" if ms is None or lib is None else f", {ms / lib:.3f}x"
            print(f"[fp32] {kid} {name} [{m}, {d}] -> {n}: {shown(ms)}{rate} (bound "
                  f"{bms:.4f} ms by {by}); fp32 cuBLAS F.linear {shown(lib)}{ratio}; {smi}",
                  flush=True)
            out[kid, name] = (ms, lib)
        bb, lq, lk, hh, am = steps[kid]
        split = lambda x, hh=hh: x.view(bb, x.shape[1], hh, 64).transpose(1, 2)  # noqa: E731
        q, k, v = rnd(bb, lq, hh * 64), rnd(bb, lk, hh * 64), rnd(bb, lk, hh * 64)
        am = None if am is None else am[:, None, None, :]
        lib = device_ms(lambda q=q, k=k, v=v, am=am: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=am))[0]
        ms, flops = parts.get("attention step"), work.attention_flops(bb, lq, lk, hh * 64)
        bms, by = bound(flops, nbytes(q, k, v, q), PEAK_F32_TC_FLOPS)
        rate = "" if ms is None else f", {flops / ms / 1e9:.1f} TFLOP/s"
        ratio = "" if ms is None or lib is None else f", {ms / lib:.3f}x"
        print(f"[fp32] {kid} attention step ({lq} queries, {lk} keys, {hh} heads): "
              f"{shown(ms)}{rate} (bound {bms:.4f} ms by {by}); SDPA fp32 forward "
              f"{shown(lib)}{ratio}; {smi}", flush=True)
        out[kid, "attention step"] = (ms, lib)
        del q, k, v
    return out


def f32_block_bwd_products(inp, smi: str):
    """Phase 18 (a): K2b-f32 and K3b-f32 (dropout RATE) at the main path's
    shapes by the profiler's device time, split in launch order
    (``F32_PARTS``): each product (``f32_block_bwd_shapes``) beside fp32
    torch.mm (TF32 off) at its shape, with its rate and bound, and B's TF32
    planes, the LayerNorm kernels, the fixed-order sums and the attention
    step; every line names the card.  Returns {(kernel, product): (device
    ms, torch.mm device ms)} and {(kernel, "device"): (the call's device
    ms, None)}, as ``f32_ffn_products``."""
    import torch

    from crog_tpu_torch.ops import decoder_blocks as DB

    sargs, cargs, _ = _args(inp)
    x, xc = sargs[0], cargs[0]
    b, l, d = x.shape
    t = cargs[1].shape[1]
    dys, dyc = (inp["dy"][n] for n in ("decoder_self_block", "decoder_cross_block"))
    _, ssaved = DB.self_block_fwd(*sargs, SEED + 1, RATE, save=True)
    _, csaved = DB.cross_block_fwd(*cargs, SEED + 2, RATE, save=True)
    calls = {"K2b-f32": lambda: DB.self_block_bwd(x, ssaved, dys, 8, SEED + 1, RATE),
             "K3b-f32": lambda: DB.cross_block_bwd(xc, csaved, dyc, 8, SEED + 2, RATE)}
    gen = torch.Generator().manual_seed(SEED + 17)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(x.device)  # noqa: E731
    shown = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    lib_ms, out = {}, {}
    for kid, call in calls.items():
        dev, _, seq = device_ms(call)
        out[kid, "device"] = (dev, None)
        parts = dict(F32_PARTS[kid](seq)) if seq is not None else {}
        print(f"[fp32] {kid} at B={b}: device time {shown(dev)} (" + ", ".join(
            f"{p} {v:.4f}" for p, v in parts.items()) + f"); {smi}", flush=True)
        prods = f32_block_bwd_shapes(b * l, b * t, d)[kid]
        for name, (m, k, n), at in prods:
            if (m, k, n, at) not in lib_ms:
                a, w = (rnd(k, m), rnd(k, n)) if at else (rnd(m, k), rnd(k, n))
                lib_ms[m, k, n, at] = device_ms(
                    (lambda a=a, w=w: torch.mm(a.t(), w)) if at
                    else (lambda a=a, w=w: torch.mm(a, w)))[0]
                del a, w
            lib, ms, flops = lib_ms[m, k, n, at], parts.get(name), 2.0 * m * k * n
            bms, by = bound(flops, 0, PEAK_F32_TC_FLOPS)
            rate = "" if ms is None else f", {flops / ms / 1e9:.1f} TFLOP/s"
            ratio = "" if ms is None or lib is None else f", {ms / lib:.3f}x"
            shape = f"[{k}, {m}]^T x [{k}, {n}]" if at else f"[{m}, {k}] x [{k}, {n}]"
            print(f"[fp32] {kid} {name} {shape}: {shown(ms)}{rate} (bound {bms:.4f} ms by "
                  f"{by}); fp32 torch.mm {shown(lib)}{ratio}; {smi}", flush=True)
            out[kid, name] = (ms, lib)
        known = sum(parts.get(p[0], 0.0) for p in prods)
        print(f"[fp32] {kid} products {known:.4f} ms of {shown(dev)}; {smi}", flush=True)
        out[kid, "products"] = (known, None)
    del ssaved, csaved
    return out


def f32_bwd_rate_checks(inp):
    """K2b-f32, K3b-f32 and K4b-f32 at dropout 0 against their twins, and
    at dropout 0 and RATE twice each: every output, and K4b-f32's dh and
    hn, with equal bits."""
    import torch

    from crog_tpu_torch.ops import decoder_blocks as DB
    from crog_tpu_torch.ops import ffn as FF

    sargs, cargs, fargs = _args(inp)
    x, xc = sargs[0], cargs[0]
    dys, dyc, dyf = (inp["dy"][n] for n in ("decoder_self_block", "decoder_cross_block", "ffn"))
    fa = (*fargs[:6], dyf)
    outs = {"decoder_self_block_bwd_f32": ("dx", "d_in_w", "d_in_b", "d_out_w", "d_out_b",
                                           "d_g_pre", "d_b_pre", "d_g_post", "d_b_post"),
            "decoder_cross_block_bwd_f32": ("dx", "dtxt", "d_in_w", "d_in_b", "d_out_w",
                                            "d_out_b", "d_g_pre", "d_b_pre", "d_g_post",
                                            "d_b_post"),
            "ffn_bwd_f32": ("dx", "dw1", "db1", "dgamma", "dbeta", "dw2", "db2")}
    for rate in (0.0, RATE):
        _, ssaved = DB.self_block_fwd(*sargs, SEED + 1, rate, save=True)
        _, csaved = DB.cross_block_fwd(*cargs, SEED + 2, rate, save=True)
        calls = {
            "decoder_self_block_bwd_f32": (
                lambda: DB.self_block_bwd(x, ssaved, dys, 8, SEED + 1, rate),
                lambda: DB.self_block_bwd_plain(*sargs[:-1], dys, 8, SEED + 1, rate)),
            "decoder_cross_block_bwd_f32": (
                lambda: DB.cross_block_bwd(xc, csaved, dyc, 8, SEED + 2, rate),
                lambda: DB.cross_block_bwd_plain(*cargs[:-1], dyc, 8, SEED + 2, rate)),
            "ffn_bwd_f32": (lambda: FF.ffn_bwd(*fa, SEED + 3, rate, with_hidden=True),
                            lambda: FF.ffn_bwd_plain(*fa, SEED + 3, rate, relu_mask=active)),
        }
        if rate == 0.0:
            active = ffn_f32_relu_decision(fa, SEED + 3, rate)
        for name, (kern, plain) in calls.items():
            a, b = kern(), kern()
            torch.cuda.synchronize()
            differ = [i for i, (u, v) in enumerate(zip(a, b)) if not torch.equal(u, v)]
            print(f"[fp32] {name} (dropout {rate}) twice: {len(a)} outputs "
                  f"{'equal bits' if not differ else f'differ at {differ}'}", flush=True)
            if differ:
                raise AssertionError(f"{name} is not repeatable: outputs {differ}")
            if rate == 0.0:
                check_f32_grads(f"{name} (dropout 0)", outs[name], a, plain())
            del a, b
        del ssaved, csaved


def f32_grad_yardsticks(device, b=BATCH, l=676, t=17, d=512):
    """Timed as yardsticks only (the port computes these in its own
    kernels): fp32 torch.mm, TF32 off, at the shapes of the products of
    K2b-f32 (dO and each dX [B*L, D] x [D, D], the three dX as one [B*L, 3D]
    x [3D, D], each dW over B*L rows, dW[q | k] over them) and K3b-f32 (its
    d(txt) [B*T, 2D] x [2D, D], dW over B*T rows).  SDPA's
    fp32 backward at the attention steps' shapes is timed beside them
    (``f32_attention_bwd_steps``), cuBLAS at K4-f32's and K4b-f32's
    products in ``f32_ffn_products``."""
    import torch

    g = torch.Generator().manual_seed(SEED + 12)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device)
    m, mt = b * l, b * t
    cases = (
        (f"[{m}, {d}] x [{d}, {d}] (dO, each dX product)", rnd(m, d), rnd(d, d), False),
        (f"[{m}, {3 * d}] x [{3 * d}, {d}] (K2b's three dX products as one)",
         rnd(m, 3 * d), rnd(3 * d, d), False),
        (f"A^T B over {m} rows, [{d}, {d}] (each dW)", rnd(m, d), rnd(m, d), True),
        (f"A^T B over {mt} rows, [{d}, {d}] (K3b's dW of k and v)", rnd(mt, d), rnd(mt, d),
         True),
    )
    for label, a, w, trans in cases:
        call = ((lambda a=a, w=w: torch.mm(a.t(), w)) if trans
                else (lambda a=a, w=w: torch.mm(a, w)))
        ms = cuda_ms(call)
        print(f"[fp32] torch.mm fp32 yardstick {label}: {ms:.4f} ms", flush=True)
        DEVICE_TIMED.append((f"torch.mm fp32 yardstick {label}", ms, call, None, None))


def fp32_batch():
    """One prepared rawlb val batch at BATCH, as phase 4 prepares them
    (``chip_smoke.py --fp32`` runs phase 18 without phase 4)."""
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.test_crog import build_dataset

    cfg = _cfg(BATCH, BATCH)
    return next(iter(DataLoader(build_dataset(cfg, cfg.val_split), BATCH,
                                pad_last_batch=True)))


def _eval_rate(eval_step, batch, reps: int = 5):
    """(samples/s of ``eval_step`` over ``batch``, peak device bytes)."""
    import torch

    eval_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = eval_step(batch)
    out["iou"].cpu()
    dt = (time.perf_counter() - t0) / reps
    return len(batch["word"]) / dt, torch.cuda.max_memory_allocated()


def fp32_e2e(device, batch, smi: str):
    """Phase 18 (b)-(d): crog_synthetic_r50.yaml with compute_dtype
    float32, the bf16 model's seeded weights, on the plain stem convs (as
    the config runs without ``--fused-stem``) and on the fused stem (K6-f32):
    one forward at batch 1 of each against the CPU in fp32, its launches;
    the fused stem's make_eval_step over ``batch`` against the CPU; the
    fp32 (plain stem) and bf16 models' batch-1 latency, eval samples/s at
    24 and peak memory."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch, make_eval_step
    from crog_tpu_torch.models.crog import build_crog

    cfg32 = _cfg(BATCH, BATCH, ("compute_dtype", "float32"))
    model16 = _model(_cfg(), device, fused_stem=False).eval()
    model32 = build_crog(cfg32).to(device).eval()
    fused32 = build_crog(cfg32, fused_stem=True).to(device).eval()
    cpu32 = build_crog(cfg32).eval()
    state = model16.state_dict()
    model32.load_state_dict(state)
    fused32.load_state_dict(state)
    cpu32.load_state_dict({k: v.cpu() for k, v in state.items()})
    if (model16.dtype, model32.dtype, fused32.dtype, cpu32.dtype) != (
            (torch.bfloat16,) + (torch.float32,) * 3):
        raise AssertionError("build_crog did not read compute_dtype")

    one = device_batch({k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)},
                       torch.device("cpu"), cfg32.input_size, train=False)
    img, word = one["img"], one["word"]
    wrappers = launch_counts()
    with torch.no_grad():
        cpu = cpu32(img, word)
    for stem, model, per_forward in (("plain stem", model32, PER_FORWARD_F32),
                                     ("fused stem", fused32, PER_FORWARD_F32_FUSED)):
        with torch.no_grad():
            _reset(wrappers)
            card = model(img.to(device), word.to(device))
            torch.cuda.synchronize()
            launches = _read(wrappers)
        card = card.float().cpu()
        print(f"[fp32] one fp32 forward ({stem}) launches {_launched(launches)}", flush=True)
        check_launches(launches, per_forward, 1)
        if card.shape != cpu.shape or not torch.isfinite(card).all():
            raise AssertionError(f"fp32 card output {tuple(card.shape)} not finite/shaped")
        worst = 0.0
        for i, name in enumerate(("mask", "qua", "sin", "cos", "wid")):
            rel = rel_l2(card[..., i], cpu[..., i])
            worst = max(worst, rel)
            print(f"[fp32] e2e ({stem}) {name}: rel_l2 {rel:.4g} (limit {F32_E2E_TOL}), "
                  f"max|card-cpu| {float((card[..., i] - cpu[..., i]).abs().max()):.4g}",
                  flush=True)
        if worst > F32_E2E_TOL:
            raise AssertionError(f"fp32 card vs CPU logits ({stem}) rel_l2 {worst:.4g} > "
                                 f"{F32_E2E_TOL}")

    got = make_eval_step(fused32, input_size=cfg32.input_size, device=device)(batch)
    del fused32
    ref = make_eval_step(cpu32, input_size=cfg32.input_size, device="cpu")(batch)
    iou_gap = float((got["iou"].cpu() - ref["iou"]).abs().max())
    gv, rv = got["rects_valid"].cpu(), ref["rects_valid"]
    same = (gv == rv) & ((got["rects"].cpu()[..., :2] == ref["rects"][..., :2]).all(-1) | ~rv)
    share = float(same.float().mean())
    both = gv & rv
    rect_gap = float((got["rects"].cpu()[both] - ref["rects"][both]).abs().max()) \
        if bool(both.any()) else 0.0
    print(f"[fp32] eval step at batch {len(batch['word'])}, fused stem, card vs CPU: "
          f"per-sample IoU gap "
          f"{iou_gap:.3g} (limit {F32_IOU_TOL}); grasp rects with equal validity and "
          f"position {share:.4f} (limit {F32_RECT_SHARE}), largest rect gap where both are "
          f"valid {rect_gap:.4g}; mean IoU {float(got['iou'].mean()):.6f}", flush=True)
    if not (iou_gap <= F32_IOU_TOL and share >= F32_RECT_SHARE):
        raise AssertionError("fp32 eval step on the card disagrees with the CPU")

    step32 = make_eval_step(model32, input_size=cfg32.input_size, device=device)
    step16 = make_eval_step(model16, input_size=cfg32.input_size, device=device)
    img1, word1 = img.to(device), word.to(device)
    readings = {}
    with torch.no_grad():
        for label, model, step in (("fp32", model32, step32), ("bf16", model16, step16),
                                   ("bf16", model16, step16), ("fp32", model32, step32)):
            fwd_ms = cuda_ms(lambda: model(img1, word1), reps=10)
            rate, peak = _eval_rate(step, batch)
            readings.setdefault(label, []).append((fwd_ms, rate, peak))
    for label, runs in readings.items():
        print(f"[fp32] {label} model (plain stem convs): forward batch 1 "
              + ", ".join(f"{r[0]:.3f}" for r in runs) + " ms; eval step batch "
              f"{len(batch['word'])} " + ", ".join(f"{r[1]:.2f}" for r in runs)
              + " samples/s; peak " + ", ".join(f"{r[2] / 2**30:.3f}" for r in runs)
              + f" GiB (two runs, in turns fp32 bf16 bf16 fp32) on {smi}", flush=True)


POOL = "backbone.visual.attnpool."


@contextlib.contextmanager
def pool_taps(model):
    """Inside it, the attention pool of ``model`` records the input tokens
    of its forward (q_proj's input, the positional embedding added) as
    ``tokens`` and the gradient at its attention's output (c_proj's input)
    of the backward as ``da``, both f32 on the CPU."""
    pool, got = model.backbone.visual.attnpool, {}

    def tokens(mod, args):
        got["tokens"] = args[0].detach().float().cpu()

    def out(mod, args):
        if args[0].requires_grad:
            args[0].register_hook(lambda g: got.__setitem__("da", g.detach().float().cpu()))

    hooks = [pool.q_proj.register_forward_pre_hook(tokens),
             pool.c_proj.register_forward_pre_hook(out)]
    try:
        yield got
    finally:
        for h in hooks:
            h.remove()


def pool_qk_grads_f64(tokens, da, wq, bq, wk, bk, wv, bv, heads: int):
    """(dWq, dWk) of the attention pool's q and k projections in float64,
    the backward written out in plain torch ops: tokens [B, N, C] the
    pool's input tokens, da [B, N, C] the gradient at its attention's
    output; q, k, v = tokens W^T + b, per head softmax(q k^T / sqrt(dh)) v;
    dS = P (dP - rowsum(dP P)), dq = dS k / sqrt(dh), dk = dS^T q /
    sqrt(dh); dW = (dq or dk)^T tokens summed over B and N."""
    import torch

    t, g = tokens.double(), da.double()
    b, n, c = t.shape
    dh = c // heads
    scale = dh**-0.5
    split = lambda z: z.reshape(b, n, heads, dh).transpose(1, 2)  # noqa: E731
    q, k, v = (split(t @ w.double().t() + bb.double())
               for w, bb in ((wq, bq), (wk, bk), (wv, bv)))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    dp = split(g) @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq, dk = ds @ k * scale, ds.transpose(-1, -2) @ q * scale
    rows = lambda z: z.transpose(1, 2).reshape(b * n, c)  # noqa: E731
    tt = t.reshape(b * n, c)
    return rows(dq).t() @ tt, rows(dk).t() @ tt


def pool_grad_reference(card, cpu, card_taps, cpu_taps, model):
    """The attention pool's q_proj and k_proj weight gradients of one train
    step on the card and on the CPU in fp32 (``train_grads`` results)
    against float64 (``pool_qk_grads_f64``) at the card's tokens and
    gradient at the attention's output, and the CPU's against float64 at
    its own; ``model`` gives the weights (the same seeded weights on both).
    Returns {(run, reference inputs): rel-L2 over both weights}."""
    pool = model.backbone.visual.attnpool
    w = [getattr(getattr(pool, f"{n}_proj"), a).detach().cpu()
         for n in ("q", "k", "v") for a in ("weight", "bias")]
    refs = {src: pool_qk_grads_f64(taps["tokens"], taps["da"], *w, pool.num_heads)
            for src, taps in (("card", card_taps), ("cpu", cpu_taps))}
    out = {}
    for run, (_, grads) in (("card", card), ("cpu", cpu)):
        for src in ("card", "cpu") if run == "cpu" else ("card",):
            num = den = 0.0
            for name, ref in zip(("q_proj", "k_proj"), refs[src]):
                got = grads[f"{POOL}{name}.weight"].double()
                num += float((got - ref).pow(2).sum())
                den += float(ref.pow(2).sum())
            out[run, src] = (num / max(den, 1e-300)) ** 0.5
    return out


def fp32_train_gap(device, batch, opts=()):
    """Phase 18 (e): one fp32 train step at batch 2 (two samples of
    ``batch``), dropout 0, BatchNorm on running statistics, on the card with
    the fused s2d stem and on the CPU (the plain stem's convs, the same
    function): the loss within F32_TRAIN_LOSS_TOL and each group's gradient
    within its F32_TRAIN_GRAD_TOL; the card's forward and backward launch
    K1-f32..K4b-f32, K6-f32 and K6b-f32 (PER_STEP_F32_FUSED) and no bf16
    kernel.  ``opts`` override further config keys (phase 19: input_size
    640).  Returns the card's launches."""
    import torch

    cfg = _cfg(opts=("dropout", "0.0", "compute_dtype", "float32", *opts))
    mini = mini_batch(batch, cfg.input_size)
    wrappers = launch_counts()
    model = grad_model(cfg, device, fused_stem=True)
    _reset(wrappers)
    with pool_taps(model) as card_taps:
        card = train_grads(model, mini)
    torch.cuda.synchronize()
    launches = _read(wrappers)
    del model
    cpu_model = grad_model(cfg, torch.device("cpu"), torch.float32, fused_stem=False)
    with pool_taps(cpu_model) as cpu_taps:
        cpu = train_grads(cpu_model, mini)
    rel, groups = grad_gap(card, cpu, "[fp32] train step at batch 2 (fused stem), card vs CPU:")
    pool = pool_grad_reference(card, cpu, card_taps, cpu_taps, cpu_model)
    card_rel, cpu_rel = pool["card", "card"], pool["cpu", "card"]
    print(f"[fp32] train step's attention pool q_proj and k_proj weight gradients against "
          f"float64 at the card's tokens and attention-output gradient: card-fp32 "
          f"{card_rel:.4g}, CPU-fp32 {cpu_rel:.4g} (the card is "
          + ("the farther by more than 2x" if card_rel > 2 * cpu_rel else
             "the nearer" if card_rel <= cpu_rel else "the farther, within 2x")
          + f"); CPU-fp32 against float64 at its own inputs {pool['cpu', 'cpu']:.4g} (card / "
          f"CPU at own inputs {card_rel / pool['cpu', 'cpu']:.3g})", flush=True)
    del cpu_model
    stem = stem_grad_gap(card, cpu)
    print(f"[fp32] train step: loss rel {rel:.4g} (limit {F32_TRAIN_LOSS_TOL}), grad rel_l2 "
          f"limits {F32_TRAIN_GRAD_TOL}; the stem's conv weights' gradients rel_l2 {stem:.4g}; "
          f"launches {_launched(launches)}", flush=True)
    check_launches(launches, PER_STEP_F32_FUSED, 1)
    over = {g: r for g, r in groups.items() if not r <= F32_TRAIN_GRAD_TOL[g]}
    if not rel <= F32_TRAIN_LOSS_TOL or over:
        raise AssertionError(f"fp32 train step card vs CPU: loss rel {rel:.4g}, grad {over}")
    return launches


def _train_rate(step, batches, cfg):
    """(samples/s of ``train_one_epoch`` over ``batches``, peak device
    bytes)."""
    import torch

    from crog_tpu_torch.engine.crog_engine import train_one_epoch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_one_epoch(batches, step, 1, cfg, len(batches))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return BATCH * len(batches) / dt, torch.cuda.max_memory_allocated()


def fp32_train_path(device, prepared, smi: str):
    """Phase 18 (f): the fp32 model on the fused s2d stem through
    ``train_one_epoch`` for TRAIN_STEPS steps at BATCH on ``prepared`` rawlb
    batches: the loss is finite, every trainable parameter and BatchNorm
    statistic moved, and the counters read PER_STEP_F32_FUSED per step;
    then, after one untimed step of each other model, train samples/s and
    peak memory of the fp32 model on the fused stem, on the plain stem and
    the bf16 model (fused stem, as phase 5), the same seeded weights, in
    turns fused plain bf16 bf16 plain fused.  Returns the launches of the
    TRAIN_STEPS steps."""
    import torch

    from crog_tpu_torch.engine.crog_engine import make_train_step, train_one_epoch
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.utils.seed import set_random_seed

    batches = [prepared[i % len(prepared)] for i in range(TRAIN_STEPS)]
    steps = {}
    for label, opts, fused in (("fp32 fused stem", ("compute_dtype", "float32"), True),
                               ("fp32 plain stem", ("compute_dtype", "float32"), False),
                               ("bf16 fused stem", (), True)):
        cfg = _cfg(2 * BATCH, BATCH, ("print_freq", "2", "epochs", "1", *opts))
        model = _model(cfg, device, fused_stem=fused).train()
        opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                    cfg.lr_decay, 4 * TRAIN_STEPS, cfg.weight_decay)
        steps[label] = (model, cfg, make_train_step(model, opt, sched, cfg.use_grasp_masks,
                                                    cfg.max_norm, set_random_seed(SEED),
                                                    device))
    model32, cfg32, step32 = steps["fp32 fused stem"]
    if model32.dtype != torch.float32 or not model32.backbone.visual.fused_stem:
        raise AssertionError("build_crog did not read compute_dtype float32 or fused_stem")
    params0, stats0 = snapshot(model32)
    wrappers = launch_counts()
    _reset(wrappers)
    metrics = train_one_epoch(batches, step32, 1, cfg32, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = _read(wrappers)
    loss = float(metrics["loss"])
    print(f"[fp32] {TRAIN_STEPS} fp32 train steps at batch {BATCH} (fused stem): last loss "
          f"{loss:.6g}; launches {_launched(launches)}", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"fp32 train loss is not finite: {loss}")
    check_launches(launches, PER_STEP_F32_FUSED, TRAIN_STEPS)
    check_moved(model32, params0, stats0, "fp32")
    del params0, stats0
    for label in ("fp32 plain stem", "bf16 fused stem"):
        steps[label][2](batches[0])  # its first step (cuDNN's and the allocator's warm-up)
    readings = {}
    order = ("fp32 fused stem", "fp32 plain stem", "bf16 fused stem")
    for label in order + order[::-1]:
        _, cfg, step = steps[label]
        readings.setdefault(label, []).append(_train_rate(step, batches, cfg))
    for label, runs in readings.items():
        print(f"[fp32] {label} train step at batch {BATCH}: "
              + ", ".join(f"{r[0]:.2f}" for r in runs) + " samples/s; peak "
              + ", ".join(f"{r[1] / 2**30:.3f}" for r in runs)
              + f" GiB (two runs of {TRAIN_STEPS} steps, in turns fp32 fused, fp32 plain, "
              f"bf16, bf16, fp32 plain, fp32 fused) on {smi}", flush=True)
    return launches


def fp32_cli(workdir: str):
    """Phase 18 (g): ``python -m crog_tpu_torch.train_crog --fused-stem`` on
    crog_synthetic_r50.yaml with ``--opts compute_dtype float32`` over a
    small synthetic split: 3 steps at 8, one eval; exit 0, the fused stem
    named in the log, a Loss line per step and a last_model."""
    import os

    t0 = time.perf_counter()
    text = _run_cli(["-m", "crog_tpu_torch.train_crog", "--config", CONFIG, "--fused-stem",
                     "--opts",
                     "compute_dtype", "float32", "synthetic_samples", "24", "batch_size", "8",
                     "batch_size_val", "8", "epochs", "1", "print_freq", "1",
                     "output_folder", workdir, "exp_name", "fp32"], workdir, "train_fp32.out")
    losses = [line for line in text.splitlines() if "Loss" in line]
    if ("compute_dtype: float32" not in text or "through K6/K6b" not in text
            or len(losses) < 3
            or not os.path.isfile(os.path.join(workdir, "fp32", "last_model"))):
        print(text[-4000:], flush=True)
        raise AssertionError("train_crog --fused-stem at compute_dtype float32: no fp32 "
                             "config, fused stem, Loss lines or last_model")
    print(f"[fp32] train_crog --fused-stem --opts compute_dtype float32: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, {len(losses)} Loss lines, last: "
          f"{losses[-1].strip()[-90:]}", flush=True)


def fp32_ssg(device):
    """Phase 18 (h): ssg_r50.yaml with compute_dtype float32: one frame
    through the validate path's eval forward on the card and on the CPU,
    both fp32, seeded weights: every output within F32_E2E_TOL; no kernel
    launches (SSG reaches K5/K5b only in training).  Then one fp32 train
    step at batch 2 and 256^2, card vs CPU, as phase 11 (K5 and K5b twice
    each, the 8 loss terms and each group's gradient printed and held to
    SSG_LOSS_TOL / SSG_GRAD_TOL; no fp32 limit is set yet)."""
    import torch

    from crog_tpu_torch.engine.ssg_engine import make_ssg_eval_fwd
    from crog_tpu_torch.models.ssg import build_ssg

    cfg = _ssg_cfg(("compute_dtype", "float32"))
    model = _ssg_model(cfg, device).eval()
    cpu = build_ssg(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    if (model.dtype, cpu.dtype) != (torch.float32, torch.float32):
        raise AssertionError("build_ssg did not read compute_dtype")
    batches, _ = _ssg_data(cfg, cfg.val_split, 1, 1, False)
    wrappers = launch_counts()
    _reset(wrappers)
    got, _ = make_ssg_eval_fwd(model, device)(batches[0])
    torch.cuda.synchronize()
    check_launches(_read(wrappers), {}, 0)
    ref, _ = make_ssg_eval_fwd(cpu, "cpu")(batches[0])
    gaps = {k: rel_l2(got[k].float(), ref[k].float()) for k in sorted(ref)
            if torch.is_tensor(ref[k]) and ref[k].is_floating_point()}
    print("[fp32] SSG validate forward, one frame, card vs CPU (fp32): rel_l2 "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" (limit {F32_E2E_TOL})", flush=True)
    bad = {k: v for k, v in gaps.items() if not v <= F32_E2E_TOL}
    if bad:
        raise AssertionError(f"fp32 SSG card vs CPU: {bad}")
    del model, cpu
    torch.cuda.empty_cache()
    ssg_train_step_gap(device, ("compute_dtype", "float32"), "[fp32] SSG train step,")


def fp32_phase(device, batch, train_batches, smi: str):
    """Phase 18: the fp32 kernels forward and backward (K6-f32/K6b-f32 at
    the stem's shapes too), the fp32 CROG eval path against the CPU on both
    stems, fp32 vs bf16 eval rates, one fp32 train step on the fused stem
    against the CPU, fp32 training at 24 on the fused stem and its train
    rates beside the plain stem's and bf16's, the fp32 stem timing line,
    the fp32 train CLI with ``--fused-stem``, SSG at fp32 (eval forward and
    one train step), the fp32 roofline; returns the fp32 kernels' records
    with their launches over the fp32 train path's TRAIN_STEPS steps."""
    import tempfile

    import torch

    from tools import torch_roofline

    t0 = time.perf_counter()
    records = fp32_kernels(device)
    torch.cuda.empty_cache()
    fp32_e2e(device, batch, smi)
    torch.cuda.empty_cache()
    fp32_train_gap(device, train_batches[0])
    torch.cuda.empty_cache()
    launches = fp32_train_path(device, train_batches, smi)
    torch.cuda.empty_cache()
    stem_timings(device, smi, torch.float32)
    with tempfile.TemporaryDirectory() as workdir:
        fp32_cli(workdir)
    fp32_ssg(device)
    torch.cuda.empty_cache()
    torch_roofline.main(["--device", str(device), "--iters", str(ROOFLINE_ITERS),
                         "--warmup", str(ROOFLINE_WARMUP), "--fused-stem", "--opts",
                         "compute_dtype", "float32"])
    for n, rec in records.items():
        rec["launches"] = launches[n]
    print(f"[fp32] phase 18 took {time.perf_counter() - t0:.1f} s; limits: F32_REL_L2 "
          f"{F32_REL_L2}, F32_BWD_REL_L2 {F32_BWD_REL_L2}, F32_E2E_TOL {F32_E2E_TOL}, "
          f"F32_IOU_TOL {F32_IOU_TOL}, F32_RECT_SHARE {F32_RECT_SHARE}, F32_TRAIN_LOSS_TOL "
          f"{F32_TRAIN_LOSS_TOL}, F32_TRAIN_GRAD_TOL {F32_TRAIN_GRAD_TOL}", flush=True)
    return records


# phase 19: CROG at input_size 640, the size that keeps every pixel of an
# OCID-VLG frame (640 x 480): (640 / 16)^2 = 1600 decoder tokens, past the
# 768 the attention kernels took before, and (640 / 32)^2 + 1 = 401 in the
# attention pool
LONG_SIZE = 640
LONG_TOKENS = (LONG_SIZE // 16) ** 2
LONG_POOL = (LONG_SIZE // 32) ** 2 + 1
LONG_TRAIN_STEPS = 3  # timed, after one that checks the launches
# fp32 training at 640^2: activations grow with the pixels (2.37x 416^2's),
# so batch 24 would need ~69 GiB (29.0 GiB at 416^2, PERF.md); timed at 8
LONG_F32_BATCH = 8
# the decoder blocks' counters read over the phase, each above 0
LONG_COUNTED = ("decoder_self_block", "decoder_self_block_bwd", "decoder_cross_block",
                "decoder_cross_block_bwd")


def _long_time(label, kern, plain, lib, flops, nb, peak, smi: str, tag: str = "[long]"):
    """``label``'s kernel, twin and library call (or None) by CUDA events
    beside the bound of ``flops`` and ``nb`` bytes at ``peak``."""
    bms, by = bound(flops, nb, peak)
    ms, plain_ms = cuda_ms(kern, reps=10), cuda_ms(plain, reps=3, warmup=1)
    lib_ms = None if lib is None else cuda_ms(lib, reps=10)
    shown = "none" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"{tag} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, library {shown}, bound "
          f"{bms:.4f} by {by}) on {smi}", flush=True)
    DEVICE_TIMED.append((f"{tag} {label}", ms, kern, None, None))
    if lib is not None:
        DEVICE_TIMED.append((f"{tag} {label}'s library call", lib_ms, lib, None, None))


def _long_check(label, got, ref, dtype, tol, tag: str = "[long]"):
    """``got`` against its twin ``ref`` (a tensor or a backward's outputs):
    bf16 within ``tol`` (absolute, or (relative, share) of a backward's
    largest magnitude), fp32 within F32_REL_L2 / F32_BWD_REL_L2."""
    import torch

    torch.cuda.synchronize()
    if not isinstance(got, (tuple, list)):
        got, ref = (got,), (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        if dtype == torch.float32:
            limit = F32_BWD_REL_L2 if len(got) > 1 else F32_REL_L2
            rel = rel_l2(g, r)
            ok = bool(torch.isfinite(g).all()) and rel <= limit
            print(f"{tag} {label}[{i}]: rel_l2 {rel:.3g} (limit {limit})", flush=True)
            if not ok:
                raise AssertionError(f"{label}[{i}] disagrees with its fp32 twin")
        elif len(got) > 1:
            rel, share = tol
            _compare(f"{tag} {label}[{i}]", g, r, rel * float(r.float().abs().max()), share)
        else:
            _compare(f"{tag} {label}", g, r, tol)


def long_attention(device, dtype, smi: str, b=BATCH, l=LONG_TOKENS, t=17, heads=8):
    """The attention kernel at the 640^2 decoder's steps, forward and
    backward, against its twins, twice with equal bits, timed beside SDPA
    (a yardstick only): K2's self attention (1600 tokens), K3's (1600
    queries over 17 text keys with per-sample padding), K1b's function at
    1600 tokens (bf16: the rows / cols kernels; fp32: K1b-f32 on K1-f32's
    logsumexp), and K2b's and K3b's steps (the blocks' cast points).  At
    fp32 the dQ workspace bytes at 676 and 1600 tokens."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A

    f32 = dtype == torch.float32
    peak = PEAK_F32_TC_FLOPS if f32 else work.PEAK_BF16_FLOPS
    tag = "-f32" if f32 else ""
    g = torch.Generator().manual_seed(SEED + 19)
    d = heads * 64
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, dtype)
    lengths = torch.randint(4, t + 1, (b,), generator=g)
    mask = torch.where(torch.arange(t)[None, :] >= lengths[:, None], A.NEG, 0.0).to(device)
    split = lambda x: x.view(b, x.shape[1], heads, 64).transpose(1, 2)
    q, do = rnd(b, l, d), rnd(b, l, d)
    for step, kid, lk, m in (("self attention", "K2", l, None),
                             ("cross attention, key mask", "K3", t, mask)):
        k, v = rnd(b, lk, d), rnd(b, lk, d)
        am = None if m is None else m[:, None, None, :].to(dtype)
        fwd = lambda k=k, v=v, m=m: A.fused_attention(q, k, v, heads, m)
        label = f"{kid}{tag}'s {step} (B {b}, {l} queries, {lk} keys, {heads} heads)"
        o = fwd()
        _long_check(label, o, A.attention_plain(q, k, v, heads, m), dtype, TOL["attention"])
        if not torch.equal(o, fwd()):
            raise AssertionError(f"{label} is not repeatable")
        lib = lambda k=k, v=v, am=am: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=am)
        _long_time(label, fwd, lambda k=k, v=v, m=m: A.attention_plain(q, k, v, heads, m),
                   lib, work.attention_flops(b, l, lk, d), nbytes(q, k, v, q), peak, smi)
        leaves = [split(x).detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=am)
        lib_bwd = lambda out=out, leaves=leaves: torch.autograd.grad(
            out, leaves, split(do), retain_graph=True)
        bwds = [(f"{kid}b{tag}'s attention step", True)]
        if m is None:
            bwds.append((f"K1b{tag} (its casts, on the rows / cols kernels)"
                         if not f32 else "K1b-f32 (on K1-f32's logsumexp)", False))
        for name, casts in bwds:
            label = f"{name} (B {b}, {l} queries, {lk} keys, {heads} heads)"
            if casts:
                bwd = lambda k=k, v=v, o=o, m=m: A.attention_bwd(
                    q, k, v, o, do, heads, bf16_casts=True, mask_add=m)
                plain = lambda k=k, v=v, m=m: A.mha_bwd_plain(q, k, v, do, heads, m)
                tol = (BWD_REL_TOL, 1.0)
            elif f32:
                o32, lse = A.fused_attention(q, k, v, heads, with_lse=True)
                bwd = lambda k=k, v=v, o32=o32, lse=lse: A.attention_bwd(
                    q, k, v, o32, do, heads, lse=lse)
                plain = lambda k=k, v=v, o32=o32, lse=lse: A.attention_bwd_plain(
                    q, k, v, o32, do, heads, lse)
                tol = None
            else:
                if A.bwd_path(l) != "rows_cols":
                    raise AssertionError(f"K1b at {l} tokens is not on the rows / cols kernels")
                bwd = lambda k=k, v=v, o=o: A.attention_bwd(q, k, v, o, do, heads)
                plain = lambda k=k, v=v, o=o: A.attention_bwd_plain(q, k, v, o, do, heads)
                tol = (K1B_REL_TOL, K1B_DIFF_SHARE)
            got = bwd()
            _long_check(label, got, plain(), dtype, tol)
            if not all(torch.equal(x, y) for x, y in zip(got, bwd())):
                raise AssertionError(f"{label} is not repeatable")
            del got
            _long_time(label, bwd, plain, lib_bwd, 10.0 * b * l * lk * d,
                       nbytes(q, k, v, do) + nbytes(q, k, v), peak, smi)
        del out, leaves
    if f32:
        for n in (676, l):
            parts = A.f32_dq_parts(n)[1]
            print(f"[long] K2b-f32's dQ workspace at {n} tokens (B {b}, {heads} heads): "
                  f"{parts} partials of [{b * heads}, {n}, 64] f32, "
                  f"{parts * b * heads * n * 64 * 4} bytes "
                  f"(one per 64-key block: {-(-n // 64) * b * heads * n * 64 * 4})", flush=True)


def long_kernels(device, dtype, smi: str):
    """K1 (the attention pool at 401 tokens, 32 heads), K2 and K3 (eval)
    and K1b, K2b and K3b (dropout RATE, on what their forwards saved) at
    the 640^2 path's shapes (B 24, 1600 tokens, 17 text tokens) against
    their twins under the limits phase 3 (bf16) or 18 (fp32) holds them to,
    K2b and K3b twice with equal bits, each timed beside its twin, the
    bound of ops/work.py's work and SDPA (K1, K1b); then the attention
    steps (``long_attention``)."""
    import torch

    f32 = dtype == torch.float32
    peak = PEAK_F32_TC_FLOPS if f32 else work.PEAK_BF16_FLOPS
    tag = "-f32" if f32 else ""
    kid = {"attention": "K1", "decoder_self_block": "K2", "decoder_cross_block": "K3",
           "attention_bwd": "K1b", "decoder_self_block_bwd": "K2b",
           "decoder_cross_block_bwd": "K3b"}
    inp = kernel_inputs(device, b=BATCH, l=LONG_TOKENS, lp=LONG_POOL,
                        dtype=torch.float32 if f32 else None)
    with torch.no_grad():
        for name, (kern, plain, lib, flops, nb) in kernel_cases(inp).items():
            if name in kid:
                label = f"{kid[name]}{tag} ({name}, eval)"
                _long_check(label, kern(), plain(), dtype, TOL[name])
                _long_time(label, kern, plain, lib, flops, nb, peak, smi)
        for name, (kern, plain, lib, flops, nb, outs) in backward_cases(inp).items():
            if name not in kid:
                continue
            label = f"{kid[name]}{tag} ({name}, dropout {0.0 if name == 'attention_bwd' else RATE})"
            got = kern()
            tol = (K1B_REL_TOL, K1B_DIFF_SHARE) if name == "attention_bwd" else (BWD_REL_TOL, 1.0)
            _long_check(label, got, plain(), dtype, tol)
            if name != "attention_bwd" and not all(
                    torch.equal(x, y) for x, y in zip(got, kern())):
                raise AssertionError(f"{label} is not repeatable")
            del got
            _long_time(label, kern, plain, lib, flops, nb, peak, smi)
    del inp
    torch.cuda.empty_cache()
    long_attention(device, dtype, smi, BATCH, LONG_TOKENS)


def long_phase(device, smi: str):
    """Phase 19: CROG at input_size 640 (crog_synthetic_r50.yaml with
    ``--opts input_size 640``: RN50 at full width, 1600 decoder tokens, 401
    in the attention pool, seeded weights, the fused s2d stem, the rawlb
    wire): the attention kernels and K2/K2b/K3/K3b at its shapes in both
    dtypes (``long_kernels``); ``validate_with_grasp`` over 24 synthetic
    samples at batch 24 (bf16) with the launches of one forward each; one
    sample on the card at bf16 (E2E_TOL) and at compute_dtype float32
    (F32_E2E_TOL, launches PER_FORWARD_F32_FUSED) against one CPU-fp32
    forward; the bf16 and fp32 eval steps at batch 24 timed with their peak
    memory; ``train_one_epoch`` at batch 24 (bf16) and LONG_F32_BATCH (fp32):
    one step with the launches of a step, then LONG_TRAIN_STEPS timed by
    CUDA events with the peak memory; one fp32 train step at batch 2
    against the CPU (``fp32_train_gap``, the F32_TRAIN_* limits); the
    counters of K2, K2b, K3, K3b and their fp32 builds over the phase, each
    above 0.  The ``[long]`` lines."""
    import torch

    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.engine.crog_engine import (device_batch, make_eval_step,
                                                   make_train_step, train_one_epoch,
                                                   validate_with_grasp)
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    t_phase = time.perf_counter()
    opts = ("input_size", str(LONG_SIZE))
    totals = dict.fromkeys(launch_counts(), 0)
    run = counted_run(totals)

    for dtype in (torch.bfloat16, torch.float32):
        long_kernels(device, dtype, smi)
        torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t_phase

    cfg, model, batches = build_model_and_data(device, BATCH, BATCH, opts)
    if cfg.input_size != LONG_SIZE:
        raise AssertionError(f"input_size {cfg.input_size}, expected {LONG_SIZE}")
    eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
    result, launches = run(lambda: validate_with_grasp(batches, eval_step))
    print(f"[long] validate_with_grasp at {LONG_SIZE}^2 over {len(result['iou_list'])} samples "
          f"at batch {BATCH}: IoU={result['iou']:.6f} J@1={result['j_index@1']:.6f}; "
          f"launches {_launched(launches)}", flush=True)
    for key in ("iou", "j_index@1", "j_index@5"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"[long] {key} is not finite: {result[key]}")
    check_launches(launches, PER_FORWARD, len(batches))

    one = device_batch({k: v[:1] for k, v in batches[0].items() if isinstance(v, np.ndarray)},
                       torch.device("cpu"), cfg.input_size, train=False)
    img, word = one["img"], one["word"]
    state = model.state_dict()
    cfg32 = _cfg(BATCH, BATCH, ("compute_dtype", "float32", *opts))
    with torch.no_grad():
        cpu_model = _model(cfg32, torch.device("cpu"), fused_stem=True).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in state.items()})
        cpu = cpu_model(img, word)
        del cpu_model
        model32 = _model(cfg32, device, fused_stem=True).eval()
        model32.load_state_dict(state)
        if (model.dtype, model32.dtype) != (torch.bfloat16, torch.float32):
            raise AssertionError("[long] build_crog did not read compute_dtype")
        card16 = model(img.to(device), word.to(device)).float().cpu()
        card32, launches = run(lambda: model32(img.to(device), word.to(device)))
    check_launches(launches, PER_FORWARD_F32_FUSED, 1)
    for label, card, limit in (("bf16", card16, E2E_TOL), ("fp32", card32.float().cpu(),
                                                             F32_E2E_TOL)):
        if card.shape != cpu.shape or not torch.isfinite(card).all():
            raise AssertionError(f"[long] {label} output {tuple(card.shape)} not finite/shaped")
        rels = [rel_l2(card[..., i], cpu[..., i]) for i in range(cpu.shape[-1])]
        print(f"[long] one sample at {LONG_SIZE}^2, card {label} vs CPU fp32: rel_l2 "
              + ", ".join(f"{n} {r:.4g}" for n, r in zip(("mask", "qua", "sin", "cos", "wid"),
                                                          rels))
              + f" (limit {limit}); output {tuple(card.shape)}", flush=True)
        if max(rels) > limit:
            raise AssertionError(f"[long] {label} card vs CPU rel_l2 {max(rels):.4g} > {limit}")
    del card16, card32, cpu

    step32 = make_eval_step(model32, input_size=cfg.input_size, device=device)
    for label, step in (("bf16", eval_step), ("fp32", step32), ("fp32", step32),
                        ("bf16", eval_step)):
        rate, peak = _eval_rate(step, batches[0], reps=3)
        print(f"[long] eval step at {LONG_SIZE}^2, batch {BATCH}, {label}: {rate:.2f} "
              f"samples/s ({BATCH / rate * 1e3:.2f} ms a batch), peak {peak / 2**30:.3f} GiB "
              f"on {smi}", flush=True)
    del model, model32, eval_step, step32, state
    torch.cuda.empty_cache()

    tcfg = _cfg(BATCH, BATCH, ("print_freq", "100", "epochs", "1", *opts))
    ds = build_dataset(tcfg, tcfg.train_split)
    for label, batch, dt_opts in (("bf16", BATCH, ()),
                                  ("fp32", LONG_F32_BATCH, ("compute_dtype", "float32"))):
        prepared = next(iter(DataLoader(ds, batch, shuffle=True, drop_last=True, seed=SEED)))
        cfg_t = _cfg(BATCH, batch, ("print_freq", "100", "epochs", "1", *opts, *dt_opts))
        model = _model(cfg_t, device).train()
        opt, sched = make_optimizer(model, cfg_t.base_lr, cfg_t.lr_multi, cfg_t.milestones,
                                    cfg_t.lr_decay, 1 + LONG_TRAIN_STEPS, cfg_t.weight_decay)
        step = make_train_step(model, opt, sched, cfg_t.use_grasp_masks, cfg_t.max_norm,
                               set_random_seed(SEED), device)
        metrics, launches = run(lambda: train_one_epoch([prepared], step, 1, cfg_t, 1))
        loss = float(metrics["loss"])
        print(f"[long] train step at {LONG_SIZE}^2, batch {batch}, {label}: loss {loss:.6g}; "
              f"launches {_launched(launches)}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"[long] {label} train loss is not finite: {loss}")
        check_launches(launches, PER_STEP if label == "bf16" else PER_STEP_F32_FUSED, 1)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, launches = run(lambda: train_one_epoch([prepared] * LONG_TRAIN_STEPS, step, 1, cfg_t,
                                                  LONG_TRAIN_STEPS))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / LONG_TRAIN_STEPS
        print(f"[long] train step at {LONG_SIZE}^2, batch {batch}, {label}: {ms:.2f} ms "
              f"({batch / ms * 1e3:.2f} samples/s, CUDA events over {LONG_TRAIN_STEPS} steps), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {smi}", flush=True)
        del model, opt, sched, step
        torch.cuda.empty_cache()
    _, launches = run(lambda: fp32_train_gap(device, prepared, opts))
    counted = {f"{n}{s}": totals[f"{n}{s}"] for n in LONG_COUNTED for s in ("", "_f32")}
    print(f"[long] phase 19 launches of K2, K2b, K3, K3b and their fp32 builds (CROG paths "
          f"at {LONG_SIZE}^2, not the kernel checks): {counted}; took "
          f"{time.perf_counter() - t_phase:.1f} s (kernel checks {t_kernels:.1f} s)", flush=True)
    if not all(k > 0 for k in counted.values()):
        raise AssertionError(f"[long] a decoder block kernel did not launch: {counted}")



# phase 20: CROG with other decoder head counts at d_model 512 (num_head is
# a key of every OCID-VLG config): the attention kernels at head dims 8, 16,
# 32, 128, 256 and 512 (64, 32, 16, 4, 2 and 1 heads; the configs' 8 heads
# give 64), and crog_synthetic_r50.yaml with num_head 16 (head dim 32), 4
# (128), 2 (256) and 1 (512) through the entry points
HEAD_DIMS = (8, 16, 32, 128, 256, 512)
HEAD_COUNTS = (16, 4, 2, 1)
HEADS_TRAIN_STEPS = 4


def heads_kernels(device, dtype, smi: str, b=BATCH, l=676, t=17, d=512):
    """K1, K1b, K2, K2b, K3 and K3b at head dims HEAD_DIMS (D 512, B 24, K2's
    676 tokens and K3's 17 text keys with per-sample padding) against their
    twins under phase 3's (bf16) or phase 18's (fp32) limits, K1, K2b and
    K3b twice with equal bits, each timed beside its twin, the bound of
    ops/work.py's work (which does not depend on dh at a fixed D) and SDPA
    at the same attention shape (a yardstick only: forward for K1, K2 and
    K3, backward for K1b, K2b and K3b; at dh 256 and 512 the backend SDPA
    ran, by its kernels' names).  K1 runs at K2's attention step's shape
    (self attention over 676 tokens) and K1b on the rows / cols kernels
    (ops/attention.py:bwd_path: the head kernel takes dh 64 only)."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A
    from crog_tpu_torch.ops import decoder_blocks as DB

    f32 = dtype == torch.float32
    peak = PEAK_F32_TC_FLOPS if f32 else work.PEAK_BF16_FLOPS
    sfx = "-f32" if f32 else ""
    inp = kernel_inputs(device, b=b, l=l, t=t, d=d, dtype=torch.float32 if f32 else None)
    sargs, cargs, _ = _args(inp)
    sargs, cargs = sargs[:-1], cargs[:-1]  # without the head count
    x, xc = sargs[0], cargs[0]
    dys, dyc = inp["dy"]["decoder_self_block"], inp["dy"]["decoder_cross_block"]
    g = torch.Generator().manual_seed(SEED + 20)
    q, k, v, do = (torch.randn(b, l, d, generator=g).to(device, dtype) for _ in range(4))
    kc, vc = (torch.randn(b, t, d, generator=g).to(device, dtype) for _ in range(2))
    kmask = DB.key_mask(cargs[4], b, t, device)
    es = x.element_size()
    wbytes = 4 * d * d * es + 8 * d * 4
    def one_dh(dh):  # a function per head dim: the timed calls keep their own operands
        h = d // dh
        split = lambda y: y.view(b, y.shape[1], h, dh).transpose(1, 2)
        leaves = [split(y).detach().requires_grad_() for y in (q, k, v)]
        cleaves = [split(y).detach().requires_grad_() for y in (q, kc, vc)]
        am = kmask[:, None, None, :].to(dtype)
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(*leaves)
            sdpa_cross = F.scaled_dot_product_attention(*cleaves, attn_mask=am)
        sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))
        sdpa_c = lambda: F.scaled_dot_product_attention(split(q), split(kc), split(vc),
                                                        attn_mask=am)
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, split(do), retain_graph=True)
        sdpa_cbwd = lambda: torch.autograd.grad(sdpa_cross, cleaves, split(dys),
                                                retain_graph=True)
        tag = f"[heads] dh {dh} ({h} heads)"
        if dh >= A.WIDE_MIN_DIM:
            print(f"{tag}: SDPA ran {sdpa_backend(sdpa, *leaves)} forward, "
                  f"{sdpa_backend(sdpa_bwd, *leaves)} backward ({dtype})", flush=True)
        # K1 and K1b
        o, lse = (A.fused_attention(q, k, v, h, with_lse=True) if f32
                  else (A.fused_attention(q, k, v, h), None))
        k1 = lambda: A.fused_attention(q, k, v, h)
        _long_check(f"K1{sfx}", k1(), A.attention_plain(q, k, v, h), dtype, TOL["attention"], tag)
        if not torch.equal(k1(), k1()):
            raise AssertionError(f"{tag} K1{sfx} is not repeatable")
        _long_time(f"K1{sfx} (B {b}, {l} tokens)", k1, lambda: A.attention_plain(q, k, v, h),
                   sdpa, work.attention_flops(b, l, l, d), nbytes(q, k, v, q), peak, smi, tag)
        if A.bwd_path(l, dh=dh) != "rows_cols":
            raise AssertionError(f"{tag}: K1b not on the rows / cols kernels")
        k1b = lambda: A.attention_bwd(q, k, v, o, do, h, lse=lse)
        k1b_plain = lambda: A.attention_bwd_plain(q, k, v, o, do, h, lse)
        _long_check(f"K1b{sfx}", k1b(), k1b_plain(), dtype, (K1B_REL_TOL, K1B_DIFF_SHARE), tag)
        _long_time(f"K1b{sfx} (B {b}, {l} tokens)", k1b, k1b_plain, sdpa_bwd,
                   work.attention_bwd_flops(b, l, d), 8 * nbytes(q), peak, smi, tag)
        # K2, K2b
        k2 = lambda: DB.self_block_fwd(*sargs, h)[0]
        k2_plain = lambda: DB.self_block_plain(*sargs, h)
        _long_check(f"K2{sfx} (eval)", k2(), k2_plain(), dtype, TOL["decoder_self_block"], tag)
        _long_time(f"K2{sfx} (eval, B {b}, {l} tokens)", k2, k2_plain, sdpa,
                   work.self_block_flops(b, l, d), nbytes(*sargs) + nbytes(x), peak, smi, tag)
        _, ssaved = DB.self_block_fwd(*sargs, h, SEED + 1, RATE, save=True)
        k2b = lambda: DB.self_block_bwd(x, ssaved, dys, h, SEED + 1, RATE)
        k2b_plain = lambda: DB.self_block_bwd_plain(*sargs, dys, h, SEED + 1, RATE)
        got = k2b()
        _long_check(f"K2b{sfx} (dropout {RATE})", got, k2b_plain(), dtype, (BWD_REL_TOL, 1.0),
                    tag)
        if not all(torch.equal(y, z) for y, z in zip(got, k2b())):
            raise AssertionError(f"{tag} K2b{sfx} is not repeatable")
        del got
        _long_time(f"K2b{sfx} (dropout {RATE}, B {b}, {l} tokens)", k2b, k2b_plain, sdpa_bwd,
                   work.self_block_bwd_flops(b, l, d),
                   nbytes(x, dys, *(ssaved or ())) + nbytes(x) + wbytes, peak, smi, tag)
        # K3, K3b
        k3 = lambda: DB.cross_block_fwd(*cargs, h)[0]
        k3_plain = lambda: DB.cross_block_plain(*cargs, h)
        _long_check(f"K3{sfx} (eval)", k3(), k3_plain(), dtype, TOL["decoder_cross_block"], tag)
        _long_time(
            f"K3{sfx} (eval, B {b}, {l} queries, {t} keys)", k3, k3_plain, sdpa_c,
            work.cross_block_flops(b, l, t, d),
            nbytes(*(y for y in cargs if y is not cargs[4])) + b * t * 4 + nbytes(xc), peak,
            smi, tag)
        _, csaved = DB.cross_block_fwd(*cargs, h, SEED + 2, RATE, save=True)
        k3b = lambda: DB.cross_block_bwd(xc, csaved, dyc, h, SEED + 2, RATE)
        k3b_plain = lambda: DB.cross_block_bwd_plain(*cargs, dyc, h, SEED + 2, RATE)
        got = k3b()
        _long_check(f"K3b{sfx} (dropout {RATE})", got, k3b_plain(), dtype, (BWD_REL_TOL, 1.0),
                    tag)
        if not all(torch.equal(y, z) for y, z in zip(got, k3b())):
            raise AssertionError(f"{tag} K3b{sfx} is not repeatable")
        del got
        _long_time(
            f"K3b{sfx} (dropout {RATE}, B {b}, {l} queries, {t} keys)", k3b, k3b_plain,
            sdpa_cbwd, work.cross_block_bwd_flops(b, l, t, d),
            nbytes(xc, dyc, *(csaved or ())) + nbytes(xc) + b * t * d * es + wbytes, peak, smi,
            tag)

    for dh in HEAD_DIMS:
        one_dh(dh)
    del inp
    torch.cuda.empty_cache()


def sdpa_backend(fn, q, k, v, attn_mask=None) -> str:
    """Which SDPA backend runs ``fn`` (one SDPA call, or its backward, on q,
    k, v): the one PyTorch's dispatcher picks for these tensors
    (``torch._fused_sdp_choice``; a backward runs its forward's), and a
    kernel the profiler saw in one call, named by its backend ("cudnn",
    "flash", "efficient") where one matches, else the first."""
    import torch
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile

    try:
        choice = SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, False)).name
    except Exception as err:  # a private call: name what failed, measure on
        choice = f"unknown ({type(err).__name__})"
    fn()  # warm: the first call may pick or build its kernels
    torch.cuda.synchronize()
    names = []
    for _ in range(2):  # the profiler now and then loses a call's kernel rows
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if names:
            break
    for kind, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                       ("efficient", ("fmha", "efficient", "mem_eff"))):
        hit = [n for n in names if any(key in n.lower() for key in keys)]
        if hit:
            return f"{choice} (kernel {kind}: {hit[0][:80]})"
    return f"{choice} (kernel {names[0][:80]})" if names else f"{choice} (no kernel row)"


def heads_gaps(device, batch, opts, counted, tag="[heads]", build=None, launches=None):
    """Card vs CPU at ``opts`` (phase 20: a num_head): one sample's forward
    at bf16 (E2E_TOL) and at compute_dtype float32 (F32_E2E_TOL), against
    one CPU fp32 forward; one train step at batch 2 (dropout 0, BatchNorm on
    running statistics) at bf16 (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and at fp32
    (F32_TRAIN_LOSS_TOL, F32_TRAIN_GRAD_TOL), against one CPU fp32 step.
    ``build(cfg, device, dtype, card)`` makes each model (by default
    ``_model``: the fused stem on the card, the plain stem's convs on the
    CPU, as phase 18 (e)); ``launches`` maps "bf16" / "fp32" to the card's
    (forward, step) launch counts (by default the fused stem's
    PER_FORWARD / PER_STEP and PER_FORWARD_F32_FUSED / PER_STEP_F32_FUSED).
    ``counted`` adds each run's launches."""
    import torch

    from crog_tpu_torch.engine.crog_engine import device_batch
    from crog_tpu_torch.models.clip import BatchNorm

    if build is None:
        build = lambda cfg, dev, dtype, card: _model(cfg, dev, dtype, fused_stem=card)  # noqa: E731
    launches = launches or {"bf16": (PER_FORWARD, PER_STEP),
                            "fp32": (PER_FORWARD_F32_FUSED, PER_STEP_F32_FUSED)}
    run = counted_run(counted)

    def running_bn(model):  # train mode, the BatchNorm layers on their running statistics
        model.train()
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.eval()
        return model

    head = " ".join((tag, *opts))  # "[heads] num_head 16", "[wide] RN50x64 CROG"
    cfg16 = _cfg(BATCH, BATCH, ("dropout", "0.0", *opts))
    cfg32 = _cfg(BATCH, BATCH, ("dropout", "0.0", "compute_dtype", "float32", *opts))
    one = device_batch({k: v[:1] for k, v in batch.items() if isinstance(v, np.ndarray)},
                       torch.device("cpu"), cfg16.input_size, train=False)
    mini = mini_batch(batch, cfg16.input_size)
    # each model built once: its eval forward, then its train step
    t0 = time.perf_counter()
    cpu_model = build(cfg32, torch.device("cpu"), torch.float32, False).eval()
    with torch.no_grad():
        cpu_out = cpu_model(one["img"], one["word"])
    cpu = train_grads(running_bn(cpu_model), mini)
    del cpu_model
    print(f"{head}: CPU fp32 references (one forward at batch 1, one train step at "
          f"batch 2) in {time.perf_counter() - t0:.1f} s", flush=True)
    for label, cfg, limit, loss_tol in (("bf16", cfg16, E2E_TOL, TRAIN_LOSS_TOL),
                                        ("fp32", cfg32, F32_E2E_TOL, F32_TRAIN_LOSS_TOL)):
        fwd, step = launches[label]
        model = build(cfg, device, None, True).eval()
        with torch.no_grad():
            card, launched = run(lambda: model(one["img"].to(device), one["word"].to(device)))
        card = card.float().cpu()
        check_launches(launched, fwd, 1)
        if card.shape != cpu_out.shape or not torch.isfinite(card).all():
            raise AssertionError(f"{tag} {label} output {tuple(card.shape)} not finite/shaped")
        rels = [rel_l2(card[..., i], cpu_out[..., i]) for i in range(cpu_out.shape[-1])]
        print(f"{head}: one sample, card {label} vs CPU fp32: rel_l2 "
              + ", ".join(f"{n} {r:.4g}" for n, r in zip(("mask", "qua", "sin", "cos", "wid"),
                                                          rels))
              + f" (limit {limit})", flush=True)
        if max(rels) > limit:
            raise AssertionError(f"{tag} {label} card vs CPU rel_l2 {max(rels):.4g}")
        got, launched = run(lambda: train_grads(running_bn(model), mini))
        del model
        check_launches(launched, step, 1)
        rel, groups = grad_gap(got, cpu, f"{head}: train step at batch 2, "
                                         f"card {label} vs CPU fp32:")
        limits = ({g: TRAIN_GRAD_TOL for g in groups} if label == "bf16"
                  else F32_TRAIN_GRAD_TOL)
        over = {g: r for g, r in groups.items() if not r <= limits[g]}
        print(f"{head}: {label} train step loss rel {rel:.4g} (limit {loss_tol}), grad "
              f"limits {limits}", flush=True)
        if not rel <= loss_tol or over:
            raise AssertionError(f"{tag} {label} train step card vs CPU: loss rel {rel:.4g}, "
                                 f"grad {over}")
        del got
        torch.cuda.empty_cache()


def heads_phase(device, smi: str):
    """Phase 20: the decoder at head dims other than 64.
    crog_synthetic_r50.yaml with ``--opts num_head`` 16, 4, 2 and 1 (RN50 at full
    width, 416^2, 3 decoder layers, the rawlb wire, the fused s2d stem,
    seeded weights): ``validate_with_grasp`` over
    SAMPLES at batch 24 (bf16) with one forward's launches each and the
    eval rate; ``train_one_epoch`` for HEADS_TRAIN_STEPS steps at batch 24
    (bf16) with a step's launches each, timed by CUDA events with the peak
    memory; card vs CPU at batch 1 and 2 in bf16 and fp32 (``heads_gaps``);
    then ``heads_kernels`` at bf16 and fp32; the counters of K2, K2b, K3,
    K3b and their fp32 builds over the CROG runs, each above 0.  The
    ``[heads]`` lines."""
    import torch

    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.engine.crog_engine import (make_eval_step, make_train_step,
                                                   train_one_epoch, validate_with_grasp)
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)
    run = counted_run(totals)

    for heads in HEAD_COUNTS:
        t_heads = time.perf_counter()
        opts = ("num_head", str(heads))
        cfg, model, batches = build_model_and_data(device, SAMPLES, BATCH, opts)
        if cfg.num_head != heads or model.decoder.layers[0].nhead != heads:
            raise AssertionError(f"[heads] num_head {cfg.num_head}, expected {heads}")
        eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
        result, launches = run(lambda: validate_with_grasp(batches, eval_step))
        print(f"[heads] num_head {heads} (head dim {512 // heads}): validate_with_grasp over "
              f"{len(result['iou_list'])} samples at batch {BATCH}: IoU={result['iou']:.6f} "
              f"J@1={result['j_index@1']:.6f}; launches {_launched(launches)}", flush=True)
        for key in ("iou", "j_index@1", "j_index@5"):
            if not math.isfinite(result[key]):
                raise AssertionError(f"[heads] {key} is not finite: {result[key]}")
        check_launches(launches, PER_FORWARD, len(batches))
        rate, peak = _eval_rate(eval_step, batches[0], reps=3)
        print(f"[heads] num_head {heads}: eval step at batch {BATCH}: {rate:.2f} samples/s "
              f"({BATCH / rate * 1e3:.2f} ms a batch), peak {peak / 2**30:.3f} GiB on {smi}",
              flush=True)
        del model, eval_step
        torch.cuda.empty_cache()
        tcfg = _cfg(BATCH, BATCH, ("print_freq", "100", "epochs", "1", *opts))
        prepared = next(iter(DataLoader(build_dataset(tcfg, tcfg.train_split), BATCH,
                                        shuffle=True, drop_last=True, seed=SEED)))
        model = _model(tcfg, device).train()
        opt, sched = make_optimizer(model, tcfg.base_lr, tcfg.lr_multi, tcfg.milestones,
                                    tcfg.lr_decay, 1 + HEADS_TRAIN_STEPS, tcfg.weight_decay)
        step = make_train_step(model, opt, sched, tcfg.use_grasp_masks, tcfg.max_norm,
                               set_random_seed(SEED), device)
        metrics, launches = run(lambda: train_one_epoch([prepared], step, 1, tcfg, 1))
        loss = float(metrics["loss"])
        check_launches(launches, PER_STEP, 1)
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics, launches = run(lambda: train_one_epoch([prepared] * HEADS_TRAIN_STEPS, step,
                                                        1, tcfg, HEADS_TRAIN_STEPS))
        end.record()
        torch.cuda.synchronize()
        check_launches(launches, PER_STEP, HEADS_TRAIN_STEPS)
        ms = start.elapsed_time(end) / HEADS_TRAIN_STEPS
        print(f"[heads] num_head {heads}: train step at batch {BATCH}: first loss {loss:.6g}, "
              f"{ms:.2f} ms ({BATCH / ms * 1e3:.2f} samples/s, CUDA events over "
              f"{HEADS_TRAIN_STEPS} steps), peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
              f" GiB on {smi}", flush=True)
        if not math.isfinite(loss) or not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"[heads] num_head {heads}: train loss is not finite")
        del model, opt, sched, step
        torch.cuda.empty_cache()
        t_gaps = time.perf_counter()
        heads_gaps(device, batches[0], opts, totals)
        del batches
        print(f"[heads] num_head {heads}: took {time.perf_counter() - t_heads:.1f} s (card vs "
              f"CPU {time.perf_counter() - t_gaps:.1f} s)", flush=True)
    # the kernel checks last: their timed calls hold their operands (print_device_times)
    t_kernels = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        heads_kernels(device, dtype, smi)
    t_kernels = time.perf_counter() - t_kernels
    counted = {f"{n}{s}": totals[f"{n}{s}"] for n in LONG_COUNTED for s in ("", "_f32")}
    print(f"[heads] phase 20 launches of K2, K2b, K3, K3b and their fp32 builds (CROG paths at "
          f"num_head {HEAD_COUNTS}, not the kernel checks): {counted}; took "
          f"{time.perf_counter() - t_phase:.1f} s (kernel checks {t_kernels:.1f} s)", flush=True)
    if not all(c > 0 for c in counted.values()):
        raise AssertionError(f"[heads] a decoder block kernel did not launch: {counted}")


# phase 21: CROG on the CLIP RN50x64 backbone.  OpenAI CLIP RN50x64
# (``clip.available_models()``; the geometry ``clip/model.py:build_model``
# infers from its checkpoint): vision layers (3, 15, 36, 10), vision width
# 128, embed dim 1024, a text tower 1024 wide (16 heads, 12 layers),
# resolution 448.  CROG's cross block takes the text tower's tokens as keys
# and values unprojected, so its decoder is as wide (vis_dim 1024): 8 heads
# of 128 at the configs' num_head; the FPN reads (1024, 2048, 1024) and
# writes (512, 1024, 2048).  Seeded weights (no RN50x64 checkpoint is in the
# repository); crog_synthetic_r50.yaml's other keys.
RN50X64 = dict(vision_layers=(3, 15, 36, 10), vision_width=128, transformer_width=1024,
               transformer_layers=12, clip_resolution=448, word_dim=1024, vis_dim=1024,
               fpn_in=(1024, 2048, 1024), fpn_out=(512, 1024, 2048))
WIDE_D = RN50X64["vis_dim"]
WIDE_TRAIN_STEPS = 4  # timed, after one that checks the launches
# (batch, remat) in the order tried: the largest batch that fits, remat off
# before full
WIDE_TRAIN_TRIES = ((24, False), (24, True), (16, False), (16, True), (8, False), (8, True))
# the plain s2d stem's convs run on cuDNN: no K6 / K6b launch
PER_FORWARD_PLAIN = {n: k for n, k in PER_FORWARD.items() if n != "s2dconv"}
PER_STEP_PLAIN = {n: k for n, k in PER_STEP.items() if not n.startswith("s2dconv")}
WIDE_KIDS = {"decoder_self_block": "K2", "decoder_cross_block": "K3", "ffn": "K4",
             "decoder_self_block_bwd": "K2b", "decoder_cross_block_bwd": "K3b",
             "ffn_bwd": "K4b"}
WIDE_SUFFIX = f"_d{WIDE_D}"
_WIDE_STATE = {}


def _wide_state():
    """The seeded weights of CROG at RN50x64's geometry (``random_init_``),
    made once on the CPU and loaded into every model of the phase."""
    import torch

    from crog_tpu_torch.models.crog import random_init_

    if "sd" not in _WIDE_STATE:
        model = _wide_build(_cfg(), torch.device("cpu"), torch.float32)
        random_init_(model, torch.Generator().manual_seed(SEED))
        _WIDE_STATE["sd"] = model.state_dict()
    return _WIDE_STATE["sd"]


def _wide_build(cfg, device, dtype, remat=False):
    """CROG at RN50x64's geometry with ``cfg``'s other keys, built with the
    CROG constructor as ``build_crog`` builds it, with the s2d stem on
    cuDNN (``fused_stem`` False, build_crog's and the CLIs' default: the
    stem's conv3 is 64 -> 128 wide, and K6/K6b take 32 and 64)."""
    import torch

    from crog_tpu_torch.models.crog import CROG

    with torch.device(device):
        model = CROG(word_len=cfg.word_len, num_layers=cfg.num_layers, num_head=cfg.num_head,
                     dim_ffn=cfg.dim_ffn, dropout=cfg.dropout, input_resolution=cfg.input_size,
                     use_contrastive=cfg.use_contrastive, use_grasp_masks=cfg.use_grasp_masks,
                     stem_s2d=bool(cfg.get("stem_s2d", True)), fused_stem=False, remat=remat,
                     dtype=dtype, **RN50X64)
    return model.to(device)


def _wide_model(cfg, device, dtype=None, remat=False):
    """``_wide_build`` in ``cfg``'s compute_dtype unless ``dtype``, holding
    the weights of ``_wide_state``."""
    import torch

    if dtype is None:
        bf16 = cfg.get("compute_dtype", "bfloat16") == "bfloat16"
        dtype = torch.bfloat16 if bf16 else torch.float32
    model = _wide_build(cfg, device, dtype, remat)
    model.load_state_dict(_wide_state())
    return model


def wide_yardsticks(device, dtype, b=BATCH, l=676, t=17, d=WIDE_D, f=2048, heads=8):
    """The library's calls at the shapes of K2-K4b's products and attention
    steps at width ``d`` (F.linear for the projections, torch.mm for the
    products and dW, SDPA forward and backward over 8 heads of 128 at the
    self and the masked cross attention), in ``dtype`` (fp32 with TF32
    off), each timed once: {kernel: the sum of the library times of its
    products, ms} (yardsticks only; the port computes them in its
    kernels)."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(SEED + 21)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, dtype)
    m, mt, dh = b * l, b * t, d // heads
    lengths = torch.randint(4, t + 1, (b,), generator=g)
    am = torch.where(torch.arange(t)[None, :] >= lengths[:, None], A.NEG, 0.0)
    am = am[:, None, None, :].to(device, dtype)
    split = lambda x: x.view(b, x.shape[1], heads, dh).transpose(1, 2)
    x, xt, w, bias = rnd(m, d), rnd(mt, d), rnd(3 * d, d), rnd(3 * d)
    q, k, v, kc, vc, do = (split(rnd(b, n, d)) for n in (l, l, l, t, t, l))
    leaves = [y.detach().requires_grad_() for y in (q, k, v)]
    cleaves = [y.detach().requires_grad_() for y in (q, kc, vc)]
    with torch.enable_grad():
        out, cout = F.scaled_dot_product_attention(*leaves), F.scaled_dot_product_attention(
            *cleaves, attn_mask=am)
    a3, ah, af, t2 = rnd(m, 3 * d), rnd(m, d), rnd(m, f), rnd(mt, 2 * d)
    wdf, wfd, wdd, w3 = rnd(d, f), rnd(f, d), rnd(d, d), rnd(3 * d, d)
    calls = {
        "linear qkv": lambda: F.linear(x, w, bias),
        "linear d": lambda: F.linear(x, w[:d], bias[:d]),
        "linear text": lambda: F.linear(xt, w[:d], bias[:d]),
        "sdpa self": lambda: F.scaled_dot_product_attention(q, k, v),
        "sdpa cross": lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=am),
        "sdpa self bwd": lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        "sdpa cross bwd": lambda: torch.autograd.grad(cout, cleaves, do, retain_graph=True),
        "mm dd": lambda: torch.mm(ah, wdd),
        "mm 3d": lambda: torch.mm(a3, w3),
        "mm text": lambda: torch.mm(t2, w3[:2 * d]),
        "dw": lambda: torch.mm(ah.t(), x),
        "dw qk": lambda: torch.mm(a3[:, :2 * d].t(), x),
        "dw text": lambda: torch.mm(xt.t(), xt),
        "mm hidden": lambda: torch.mm(ah, wdf),
        "mm out": lambda: torch.mm(af, wfd),
        "dw ffn": lambda: torch.mm(af.t(), ah),
    }
    ms = {name: cuda_ms(call, reps=10) for name, call in calls.items()}
    uses = {"decoder_self_block": ("linear qkv", "sdpa self", "linear d"),
            "decoder_cross_block": ("linear d", "linear text", "linear text", "sdpa cross",
                                    "linear d"),
            "ffn": ("mm hidden", "mm out"),
            "decoder_self_block_bwd": ("mm dd", "sdpa self bwd", "mm 3d", "dw qk", "dw", "dw"),
            "decoder_cross_block_bwd": ("mm dd", "sdpa cross bwd", "mm dd", "mm text", "dw",
                                        "dw text", "dw text", "dw"),
            "ffn_bwd": ("mm hidden", "mm hidden", "mm out", "dw ffn", "dw ffn")}
    print(f"[wide] library yardsticks at D {d} ({dtype}): "
          + ", ".join(f"{n} {t_:.4f}" for n, t_ in ms.items()) + " ms", flush=True)
    return {n: sum(ms[u] for u in parts) for n, parts in uses.items()}


def wide_kernels(device, dtype, smi: str):
    """K2-K4 (eval, and with dropout RATE) and K2b-K4b (dropout RATE, on
    what their forwards saved; K4b's twin on the kernel's ReLU decision,
    ``ffn_f32_relu_decision``) at RN50x64's decoder shapes (B 24, 676
    tokens, D 1024, 8 heads of 128, 17 text tokens, F 2048) in ``dtype``
    against their twins under phase 3's (bf16: TOL, BWD_REL_TOL) or phase
    18's (fp32: F32_REL_L2, F32_BWD_REL_L2) limits; K4, K2b, K3b (and K4b's
    dh, hn and column sums) twice at dropout 0 and RATE, and K2 and K3 in
    train mode, with equal bits; each timed beside its twin, the bound of
    ops/work.py's work and the library's calls at its products' shapes
    (``wide_yardsticks``).  Returns the records of the JSON line, named
    with WIDE_SUFFIX."""
    import torch

    f32 = dtype == torch.float32
    peak = PEAK_F32_TC_FLOPS if f32 else work.PEAK_BF16_FLOPS
    sfx = "_f32" if f32 else ""
    tag = "-f32" if f32 else ""
    inp = kernel_inputs(device, d=WIDE_D, dtype=torch.float32 if f32 else None)
    lib = wide_yardsticks(device, dtype)
    records = {}

    def timed(name, kern, plain, err, flops, nb):
        bms, by = bound(flops, nb, peak)
        rec = _record(name + sfx + WIDE_SUFFIX, err, bms, by)
        rec["ms"], rec["plain_ms"] = cuda_ms(kern, reps=10), cuda_ms(plain, reps=3, warmup=1)
        label = f"{WIDE_KIDS[name]}{tag} at D {WIDE_D} ({name})"
        print(f"[wide] {label}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, library "
              f"yardstick {lib[name]:.4f} (its products' calls, summed), bound {bms:.4f} by "
              f"{by}) on {smi}", flush=True)
        DEVICE_TIMED.append((f"[wide] {label}", rec["ms"], kern, None, None))
        records[rec["name"]] = rec

    with torch.no_grad():
        for name, (kern, plain, _, flops, nb) in kernel_cases(inp).items():
            if name not in WIDE_KIDS:
                continue
            got, ref = kern(), plain()
            if f32:
                _long_check(f"{name}{sfx} at D {WIDE_D} (eval)", got, ref, dtype, None, "[wide]")
                err = float((got - ref).abs().max())
            else:
                err = _compare(f"[wide] {name} at D {WIDE_D} (eval)", got, ref, TOL[name])
            timed(name, kern, plain, err, flops, nb)
        for name, (kern, plain) in dropout_cases(inp).items():
            _long_check(f"{name}{sfx} at D {WIDE_D} (dropout {RATE})", kern(), plain(), dtype,
                        TOL[name], "[wide]")
        # K4b's twin on the kernel's ReLU decision in both dtypes: at D 1024
        # a handful of the 33 M pre-activations lie within f32 rounding of
        # 0 (5-6 at B 24 on an H100, |x W1^T + b1| <= 7.2e-7) and take the
        # other sign in the twin's sum over K = 1024, each moving a row of
        # dx by up to 2.3x BWD_REL_TOL; with the kernel's decision the twin
        # meets it (one bf16 step)
        cases = f32_backward_cases(inp)
        for name, (kern, plain, _, flops, nb, outs) in cases.items():
            if name not in WIDE_KIDS:
                continue
            got, ref = kern(), plain()
            label = f"{name}{sfx} at D {WIDE_D} (dropout {RATE})"
            if f32:
                err = check_f32_grads(f"[wide] {label}", outs, got, ref)
            else:
                err = max(_compare(f"[wide] {label}.{o}", g, r,
                                   BWD_REL_TOL * float(r.float().abs().max()))
                          for o, g, r in zip(outs, got, ref))
            del got, ref
            timed(name, kern, plain, err, flops, nb)
        if f32:
            f32_bwd_rate_checks(inp)
        else:
            k4b_checks(inp, relu_held=True)
            repeat_checks(inp)
            block_fwd_train_checks(inp, timed=False)
    del inp
    torch.cuda.empty_cache()
    return records


def wide_train(device, label, dt_opts, run, smi: str):
    """``train_one_epoch`` of RN50x64 CROG at ``label``'s dtype: the first
    of WIDE_TRAIN_TRIES that fits in the card's memory (an out-of-memory
    error moves on to the next), one step with a step's launches, then
    WIDE_TRAIN_STEPS timed by CUDA events with the peak memory.  Returns
    the launches of the checked step."""
    import gc

    import torch

    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.engine.crog_engine import make_train_step, train_one_epoch
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    per_step = PER_STEP_PLAIN if label == "bf16" else PER_STEP_F32
    ds = None
    for batch, remat in WIDE_TRAIN_TRIES:
        cfg = _cfg(BATCH, batch, ("print_freq", "100", "epochs", "1", *dt_opts))
        if ds is None:
            ds = build_dataset(cfg, cfg.train_split)
        prepared = next(iter(DataLoader(ds, batch, shuffle=True, drop_last=True, seed=SEED)))
        model = opt = sched = step = None
        mode = "full" if remat else "off"
        try:
            model = _wide_model(cfg, device, remat=remat).train()
            opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                        cfg.lr_decay, 1 + WIDE_TRAIN_STEPS, cfg.weight_decay)
            step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                                   set_random_seed(SEED), device)
            metrics, launches = run(lambda: train_one_epoch([prepared], step, 1, cfg, 1))
            loss = float(metrics["loss"])
            check_launches(launches, per_step, 1)
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            metrics, more = run(lambda: train_one_epoch([prepared] * WIDE_TRAIN_STEPS, step, 1,
                                                        cfg, WIDE_TRAIN_STEPS))
            end.record()
            torch.cuda.synchronize()
            check_launches(more, per_step, WIDE_TRAIN_STEPS)
            ms = start.elapsed_time(end) / WIDE_TRAIN_STEPS
            print(f"[wide] RN50x64 CROG train_one_epoch, {label}, batch {batch}, remat {mode}: "
                  f"first loss {loss:.6g}, {ms:.2f} ms a step ({batch / ms * 1e3:.2f} samples/s, "
                  f"CUDA events over {WIDE_TRAIN_STEPS} steps), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {smi}; launches "
                  f"{_launched(launches)}", flush=True)
            if not (math.isfinite(loss) and math.isfinite(float(metrics["loss"]))):
                raise AssertionError(f"[wide] {label} train loss is not finite")
            done = True
        except torch.cuda.OutOfMemoryError as err:
            print(f"[wide] RN50x64 CROG train_one_epoch, {label}, batch {batch}, remat {mode}: "
                  f"out of memory ({str(err).splitlines()[0][:160]})", flush=True)
            done = False
        del model, opt, sched, step
        gc.collect()
        torch.cuda.empty_cache()
        if done:
            return launches
    raise AssertionError(f"[wide] {label}: no batch of {WIDE_TRAIN_TRIES} fits")


def wide_phase(device, smi: str):
    """Phase 21: CROG on the CLIP RN50x64 backbone (RN50X64, the rest of
    crog_synthetic_r50.yaml: 416^2, rawlb, 3 decoder layers, 8 heads,
    dim_ffn 2048; seeded weights; the s2d stem on cuDNN): the decoder's
    kernels at D 1024 in both dtypes (``wide_kernels``);
    ``validate_with_grasp`` over SAMPLES at batch 24 in bf16 and fp32, with
    a forward's launches each (K2, K3, K4 three times) and the eval rate
    and peak memory; card vs CPU at batch 1 and 2 (``heads_gaps``);
    ``train_one_epoch`` in both dtypes (``wide_train``); the counters of
    K2-K4b and their fp32 builds over the phase's CROG runs, each above 0.
    The ``[wide]`` lines.  Returns the D 1024 records of the JSON line, each
    with the launches of one train step of its dtype."""
    import torch

    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)
    run = counted_run(totals)

    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        records.update(wide_kernels(device, dtype, smi))
    t_kernels = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    _wide_state()
    print(f"[wide] RN50x64 CROG: {sum(v.numel() for v in _wide_state().values()) / 1e6:.1f} M "
          f"parameters and statistics, seeded on the CPU in {time.perf_counter() - t0:.1f} s",
          flush=True)
    batches = val_batches(_cfg(SAMPLES, BATCH), BATCH)
    for label, dt_opts, fwd in (("bf16", (), PER_FORWARD_PLAIN),
                                ("fp32", ("compute_dtype", "float32"), PER_FORWARD_F32)):
        cfg = _cfg(SAMPLES, BATCH, dt_opts)
        model = _wide_model(cfg, device).eval()
        eval_step = make_eval_step(model, input_size=cfg.input_size, device=device)
        result, launches = run(lambda: validate_with_grasp(batches, eval_step))
        print(f"[wide] RN50x64 CROG {label} validate_with_grasp over {len(result['iou_list'])} "
              f"samples at batch {BATCH}: IoU={result['iou']:.6f} J@1={result['j_index@1']:.6f};"
              f" launches {_launched(launches)}", flush=True)
        for key in ("iou", "j_index@1", "j_index@5"):
            if not math.isfinite(result[key]):
                raise AssertionError(f"[wide] {key} is not finite: {result[key]}")
        check_launches(launches, fwd, len(batches))
        rate, peak = _eval_rate(eval_step, batches[0], reps=3)
        print(f"[wide] RN50x64 CROG {label} eval step at batch {BATCH}: {rate:.2f} samples/s "
              f"({BATCH / rate * 1e3:.2f} ms a batch), peak {peak / 2**30:.3f} GiB on {smi}",
              flush=True)
        del model, eval_step
        torch.cuda.empty_cache()
    t_gaps = time.perf_counter()
    # the plain stem's convs on the card and on the CPU: no K6 / K6b launch
    heads_gaps(device, batches[0], (), totals, "[wide] RN50x64 CROG",
               lambda cfg, dev, dtype, card: _wide_model(cfg, dev, dtype),
               {"bf16": (PER_FORWARD_PLAIN, PER_STEP_PLAIN),
                "fp32": (PER_FORWARD_F32, PER_STEP_F32)})
    t_gaps = time.perf_counter() - t_gaps
    step_launches = {}
    for label, dt_opts in (("bf16", ()), ("fp32", ("compute_dtype", "float32"))):
        step_launches[label] = wide_train(device, label, dt_opts, run, smi)
    for name, rec in records.items():
        base = name[:-len(WIDE_SUFFIX)]
        rec["launches"] = step_launches["fp32" if base.endswith("_f32") else "bf16"][base]
    counted = {f"{n}{s}": totals[f"{n}{s}"] for n in WIDE_KIDS for s in ("", "_f32")}
    print(f"[wide] phase 21 launches of K2-K4b and their fp32 builds at D {WIDE_D} (RN50x64 "
          f"CROG runs, not the kernel checks): {counted}; took "
          f"{time.perf_counter() - t_phase:.1f} s (kernel checks {t_kernels:.1f} s, card vs "
          f"CPU {t_gaps:.1f} s)", flush=True)
    _WIDE_STATE.clear()  # 3.1 GB of host memory the later phases do not read
    if not all(c > 0 for c in counted.values()):
        raise AssertionError(f"[wide] a decoder kernel did not launch: {counted}")
    return records


def _ssg_cfg(opts=()):
    """SSG's config as written (raw wire, batch 32) on the synthetic data;
    ``opts`` override further keys."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg_from_cfg_file(SSG_CONFIG),
                               ["dataset", "synthetic", *opts])


def _ssg_model(cfg, device, dtype=None):
    import torch

    from crog_tpu_torch.models.ssg import build_ssg, random_init_

    model = build_ssg(cfg, dtype)
    random_init_(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def ssg_host_bytes(batch) -> int:
    """Bytes per sample that an SSG train step sends to the card."""
    from crog_tpu_torch.data.ssg_rawwire import SSG_RAW_STEP_KEYS, is_ssg_raw
    from crog_tpu_torch.engine.ssg_engine import DENSE_KEYS

    keys = SSG_RAW_STEP_KEYS if is_ssg_raw(batch) else DENSE_KEYS
    return sum(batch[k].nbytes for k in keys if k in batch) // len(batch["obj_valid"])


def _ssg_data(cfg, split: str, samples: int, batch: int, shuffle: bool):
    """(prepared host batches in the config's wire, the frame its ground
    truth lives in): the synthetic data through the train CLI's own dataset
    and collate, the augmentation seeded by SEED."""
    import random

    from crog_tpu_torch.config import merge_cfg_from_list
    from crog_tpu_torch.data.loader import DataLoader
    from crog_tpu_torch.train_ssg import build_ssg_dataset, ssg_collate

    cfg = merge_cfg_from_list(cfg, ["synthetic_samples", str(samples)])
    ds = build_ssg_dataset(cfg, split, random.Random(SEED))
    t0 = time.perf_counter()
    # one loading thread, as the train CLI: the augmentation draws in order
    batches = list(DataLoader(ds, batch, shuffle=shuffle, drop_last=shuffle, seed=SEED,
                              num_workers=1, collate_fn=ssg_collate(cfg)))
    print(f"[ssg] {samples} synthetic {split} samples ({cfg.wire_format} wire, frame "
          f"{ds.ori_hw[0]}x{ds.ori_hw[1]} -> {cfg.img_size}^2, {ssg_host_bytes(batches[0])} "
          f"host bytes per sample to the card) prepared in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return batches, ds.ori_hw


def ssg_raw_batches():
    """Phase 9's prepared host batches: 2 * SSG_BATCH synthetic frames on the
    config's raw wire, in batches of SSG_BATCH.  The first is also what
    K5/K5b's ``ssg-raw`` case takes its boxes from."""
    cfg = _ssg_cfg(("batch_size", str(SSG_BATCH)))
    return _ssg_data(cfg, cfg.train_split, 2 * SSG_BATCH, SSG_BATCH, True)[0]


def ssg_train_path(device, smi: str):
    """Phase 9: SSG's train_one_epoch at full width on the config's raw
    wire at SSG_BATCH (out of memory fails the phase); returns (launches,
    samples/s, model, cfg, the prepared batches)."""
    import torch

    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.engine.ssg_engine import make_ssg_train_step, train_one_epoch
    from crog_tpu_torch.train_ssg import loss_config
    from crog_tpu_torch.utils.seed import set_random_seed

    batch = SSG_BATCH
    cfg = _ssg_cfg(("batch_size", str(batch), "print_freq", "2", "epochs", "1"))
    prepared = ssg_raw_batches()
    batches = [prepared[i % len(prepared)] for i in range(TRAIN_STEPS)]
    model = _ssg_model(cfg, device).train()
    opt, sched = make_optimizer(model, cfg.base_lr, 1.0, cfg.milestones, cfg.lr_decay,
                                TRAIN_STEPS, cfg.weight_decay)
    step = make_ssg_train_step(model, opt, sched, model.anchors(), loss_config(cfg),
                               set_random_seed(SEED), cfg.max_norm, device,
                               max_objs=cfg.max_objs)
    params0, stats0 = snapshot(model)
    wrappers = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    _reset(wrappers)
    metrics = train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = _read(wrappers)
    peak = torch.cuda.max_memory_allocated()
    terms = {k: float(v) for k, v in metrics.items()}
    print(f"[ssg-train] {TRAIN_STEPS} steps at batch {batch} ({cfg.wire_format} wire, "
          f"{ssg_host_bytes(prepared[0])} host bytes per sample), {cfg.img_size}^2: last "
          + ", ".join(f"{k} {v:.6g}" for k, v in terms.items())
          + f"; launches {launches}; peak memory {peak / 2**30:.2f} GiB allocated",
          flush=True)
    if len(terms) != 9 or not all(math.isfinite(v) for v in terms.values()):
        raise AssertionError(f"SSG loss terms not all finite: {terms}")
    check_launches(launches, SSG_PER_STEP, TRAIN_STEPS)
    check_moved(model, params0, stats0, "ssg-train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(batches, step, 1, cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    print(f"[time] SSG train step batch {batch}: {dt * 1e3:.2f} ms = {batch / dt:.2f} "
          f"samples/s (prepared {cfg.wire_format} host batches in) on {smi}", flush=True)
    ssg_legacy_step(step, smi)
    return launches, batch / dt, model, cfg, prepared


def ssg_legacy_step(step, smi: str):
    """One prepared legacy-wire batch of SSG_LEGACY_BATCH through the main
    path's train step, twice: the loss is finite; host bytes per sample and
    the second step's time."""
    import torch

    cfg = _ssg_cfg(("wire_format", "legacy"))
    t0 = time.perf_counter()
    batch = _ssg_data(cfg, cfg.train_split, SSG_LEGACY_BATCH, SSG_LEGACY_BATCH, True)[0][0]
    prep = time.perf_counter() - t0
    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(batch)["loss"])
    dt = time.perf_counter() - t0
    print(f"[ssg-wire] legacy: loss {loss:.6g}; {ssg_host_bytes(batch)} host bytes per "
          f"sample; train step {dt * 1e3:.2f} ms at batch {SSG_LEGACY_BATCH} (host "
          f"prepared the batch in {prep:.1f} s) on {smi}", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"SSG legacy-wire loss is not finite: {loss}")


def ssg_eval_path(device, model, cfg, smi: str):
    """Phase 10: ``validate`` on the config's wire through the batched
    post-processing, into the frames' own size; returns eval samples/s."""
    import torch

    from crog_tpu_torch.engine.ssg_engine import make_ssg_eval_fwd, validate
    from crog_tpu_torch.train_ssg import post_processing

    bval = int(cfg.batch_size_val)
    batches, ori_hw = _ssg_data(cfg, cfg.val_split, SSG_VAL_SAMPLES, bval, False)
    post = post_processing(cfg, model.anchors(), bval > 1, ori_hw)
    fwd = make_ssg_eval_fwd(model, device)
    validate(batches[:1], post, fwd, 1, cfg)  # warm-up
    wrappers = launch_counts()
    _reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    j1, j5 = validate(batches, post, fwd, 1, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read(wrappers)
    print(f"[ssg-eval] J@1={j1:.6f} J@5={j5:.6f} over {SSG_VAL_SAMPLES} samples at batch "
          f"{bval} ({cfg.wire_format} wire, post-processing into {ori_hw[0]}x{ori_hw[1]}; "
          f"random weights: near 0 expected); launches {launches}", flush=True)
    print(f"[time] SSG eval (validate, batch {bval}): {SSG_VAL_SAMPLES / dt:.2f} samples/s "
          f"(host arrays in, Jacquard check on the host) on {smi}", flush=True)
    if not (math.isfinite(j1) and math.isfinite(j5)):
        raise AssertionError(f"SSG J@1/J@5 not finite: {j1}, {j5}")
    check_launches(launches, {}, 0)
    return SSG_VAL_SAMPLES / dt


def unpack_gap(batch, device, img_size: int, max_objs: int):
    """SSG's raw unpack of one host ``batch`` as the train step calls it
    (pad_objs, emit_ds), on ``device`` and on the CPU, both f32: each
    plane's max abs difference; raises where one exceeds UNPACK_TOL (sin and
    cos: UNPACK_SIN_COS_TOL) or a binarized map differs off a 0.5 tie or
    on more than UNPACK_FLIP_SHARE of its elements."""
    import torch

    from crog_tpu_torch.data.loader import device_put_crog
    from crog_tpu_torch.data.ssg_rawwire import SSG_RAW_STEP_KEYS, unpack_ssg_raw
    from crog_tpu_torch.ops.resize import downsample_masks

    cpu = torch.device("cpu")
    kw = dict(pad_objs=max_objs, emit_ds=True)
    with torch.no_grad():
        got = unpack_ssg_raw(device_put_crog(batch, SSG_RAW_STEP_KEYS, device), img_size,
                             **kw)
        raw = device_put_crog(batch, SSG_RAW_STEP_KEYS, cpu)
        ref = unpack_ssg_raw(raw, img_size, **kw)
        full = unpack_ssg_raw(raw, img_size, pad_objs=max_objs)["ins_masks"]
    errs, bad = {}, []
    for k, r in ref.items():
        g = got[k].cpu()
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"unpack {k}: {g.shape} {g.dtype} vs {r.shape} {r.dtype}")
        if k in ("ins_ds", "sem_ds"):
            diff = g != r
            near = downsample_masks(full, r.shape[-2:], False)
            errs[k] = float(diff.float().mean())
            if errs[k] > UNPACK_FLIP_SHARE or (diff & ((near - 0.5).abs() > UNPACK_TIE)).any():
                bad.append(k)
            continue
        if k == "grasp_ds":  # qua, sin, cos, wid
            for i, name in enumerate(("qua", "sin", "cos", "wid")):
                errs[f"grasp_ds.{name}"] = float((g[:, i] - r[:, i]).abs().max())
                tol = UNPACK_SIN_COS_TOL if name in ("sin", "cos") else UNPACK_TOL
                if errs[f"grasp_ds.{name}"] > tol:
                    bad.append(f"grasp_ds.{name}")
            continue
        errs[k] = float((g.double() - r.double()).abs().max()) if g.numel() else 0.0
        if errs[k] > UNPACK_TOL:
            bad.append(k)
    if bad:
        raise AssertionError(f"SSG raw unpack, card vs CPU: {bad}; {errs}")
    return errs


def ssg_unpack_check(device):
    """The SSG card-vs-CPU phase's unpack check: one raw train batch of
    SSG_UNPACK_BATCH frames at 480x640 -> 544^2 (``unpack_gap``)."""
    cfg = _ssg_cfg()
    batch = _ssg_data(cfg, cfg.train_split, SSG_UNPACK_BATCH, SSG_UNPACK_BATCH, True)[0][0]
    errs = unpack_gap(batch, device, cfg.img_size, cfg.max_objs)
    print("[ssg-e2e] raw unpack card vs cpu, f32, batch "
          f"{SSG_UNPACK_BATCH}: max abs " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()
                                                      if k not in ("ins_ds", "sem_ds"))
          + f"; binarized maps differing: ins_ds {errs['ins_ds']:.3g}, sem_ds "
          f"{errs['sem_ds']:.3g} of the elements (tols {UNPACK_TOL}, sin/cos "
          f"{UNPACK_SIN_COS_TOL}, flips {UNPACK_FLIP_SHARE} at ties within {UNPACK_TIE})",
          flush=True)
    return errs


# SSG card (bf16, kernels) vs CPU (fp32, plain) on one train step at batch
# 2, BatchNorm on running statistics (for the reason given above CROG's
# TRAIN_LOSS_TOL), the same positive priorities: bounds on each loss term's
# error and on each group's gradient relative L2.  bf16 keeps ~3
# significant digits through ~60 layers forward and back, and the OHEM
# ranking may swap a few marginal negatives between bf16 and fp32 logits
# (a swapped negative's cross-entropy is its ranking score, near-equal to
# the one it replaced).  A small smooth-L1 term is a sum of small
# differences pred - GT, whose bf16 error does not shrink with them, so
# each term is held to SSG_LOSS_TOL of itself plus SSG_LOSS_FLOOR of the
# total loss (on the CPU at 128^2, bf16 against fp32, loss_cos 0.152 moved
# by 0.007, 4.6%, while the total moved 0.1%).  A wrong kernel is off by
# order 1.
SSG_LOSS_TOL = 0.05
SSG_LOSS_FLOOR = 1e-3
SSG_GRAD_TOL = 0.25
SSG_GROUPS = ("backbone", "fpn", "proto_net", "prediction_layers", "semantic_seg_conv")


def ssg_train_step_gap(device, opts=(), tag: str = "[ssg-e2e]"):
    """Phase 11: ({term: rel error}, {group: grad rel-L2}) of one SSG train
    step at batch 2 and 256^2, card vs CPU (fp32), the card's step launching
    K5 and K5b twice each (SSG_PER_STEP); ``opts`` override config keys
    (phase 18 (h): ``compute_dtype float32``)."""
    import torch

    from crog_tpu_torch.data.ocid_grasp import collate_ssg
    from crog_tpu_torch.data.synthetic_ssg import SyntheticOCIDGrasp
    from crog_tpu_torch.engine.ssg_engine import DENSE_KEYS
    from crog_tpu_torch.models.clip import BatchNorm
    from crog_tpu_torch.models.ssg_loss import ssg_losses
    from crog_tpu_torch.train_ssg import loss_config

    cfg = _ssg_cfg(("img_size", str(SSG_E2E_SIZE), *opts))
    ds = SyntheticOCIDGrasp(2, cfg.train_split, cfg.img_size, cfg.num_classes)
    batch = collate_ssg([ds[0], ds[1]], cfg.max_objs)
    cpu = torch.device("cpu")
    ref = _ssg_model(cfg, cpu, torch.float32)
    anchors = torch.as_tensor(ref.anchors())
    priority = torch.rand(2, len(anchors), generator=torch.Generator().manual_seed(SEED))
    out = []
    wrappers = launch_counts()
    card = _ssg_model(cfg, device)
    for dev, model in ((device, card), (cpu, ref)):
        model.train()
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.eval()
        dense = {k: torch.as_tensor(batch[k]).to(dev) for k in DENSE_KEYS}
        _reset(wrappers)
        loss, terms = ssg_losses(model(dense["img"]), dense, anchors.to(dev),
                                 priority=priority, **loss_config(cfg))
        loss.backward()
        terms = {k: float(v.detach()) for k, v in {"loss": loss, **terms}.items()}
        if dev == device:
            launches = _read(wrappers)
        out.append((terms, {n: p.grad.float().cpu() for n, p in model.named_parameters()
                            if p.grad is not None}))
    print(f"{tag} card step ({card.dtype}) launches {_launched(launches)}", flush=True)
    check_launches(launches, SSG_PER_STEP, 1)
    (tc, gc), (tp, gp) = out
    if set(gc) != set(gp):
        raise AssertionError("the two runs give gradients for different parameters")
    rel = {k: abs(tc[k] - tp[k]) / max(abs(tp[k]), 1e-12) for k in tp}
    bad = [k for k in tp
           if abs(tc[k] - tp[k]) > SSG_LOSS_TOL * abs(tp[k]) + SSG_LOSS_FLOOR * abs(tp["loss"])]
    groups = {}
    for g in SSG_GROUPS:
        names = [n for n in gp if n.split(".")[0] == g]
        num = sum(float((gc[n] - gp[n]).pow(2).sum()) for n in names)
        den = sum(float(gp[n].pow(2).sum()) for n in names)
        groups[g] = (num / max(den, 1e-30)) ** 0.5
    print(f"{tag} card vs cpu fp32: " + ", ".join(
        f"{k} {tc[k]:.6g}/{tp[k]:.6g} (rel {rel[k]:.3g})" for k in tp), flush=True)
    print(f"{tag} grad rel_l2 " + ", ".join(f"{g} {r:.4g}" for g, r in groups.items())
          + f" (tols: loss terms {SSG_LOSS_TOL} + {SSG_LOSS_FLOOR} of the total, grads "
          f"{SSG_GRAD_TOL})", flush=True)
    if bad or max(groups.values()) > SSG_GRAD_TOL:
        raise AssertionError(f"SSG card vs CPU train step: terms {bad}, grad "
                             f"{max(groups.values()):.4g}")
    return rel, groups


# phase 12: the OCID-VLG configs as written, read from an on-disk tree
READER_CONFIG = "config/OCID-VLG/crog_multiple_r50.yaml"
READER_SCENES = 12  # 4 referring expressions each: 48 samples, 2 batches of 24
# the rates come from a larger tree (288 samples, 12 batches of 24 per
# epoch), so that the pipeline's fill at each epoch's start weighs little
READER_RATE_SCENES = 72
READER_RATE_ROUNDS = 3  # timed train epochs on threads and on processes, alternating
READER_TYPES = ("loc", "attr")  # refer_types.json's types with indices below 48
READER_PROCS = 4
READER_SPLIT_FRAMES = 12  # frames timed by part (decodes, letterbox, numpy twin)
# the loader's eval run vs the one-thread run without the put stage: the
# same host batches and the same forwards, so the per-sample IoU may differ
# only by a reordered sum (none expected); the refer-type sweep batches the
# samples otherwise, so it is held as the CPU tests hold IoU
READER_IOU_TOL = 1e-6
SWEEP_IOU_TOL = 1e-3


def _ocid_fixture():
    """tests/ocid_fixture.py (numpy and PIL only), imported by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "ocid_fixture.py")
    spec = importlib.util.spec_from_file_location("ocid_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader_cfg(root: str):
    """READER_CONFIG as written, its ``root_path`` the tree at ``root``."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg_from_cfg_file(READER_CONFIG), ["root_path", root])


def _same_batch(got, ref, tag: str, device):
    """A loader batch (dense fields on ``device``) equals a host batch bit
    for bit."""
    import torch

    if set(got) != set(ref):
        raise AssertionError(f"{tag}: keys {sorted(got)} vs {sorted(ref)}")
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray):
            if not torch.is_tensor(g) or g.device.type != device.type:
                raise AssertionError(f"{tag}: {k} did not reach {device}")
            if not np.array_equal(g.cpu().numpy(), r):
                raise AssertionError(f"{tag}: {k} differs from the one-thread loader's")
        elif isinstance(r, list):  # grasps, bbox, sentence, ids
            if len(g) != len(r) or not all(np.array_equal(a, b) for a, b in zip(g, r)):
                raise AssertionError(f"{tag}: {k} differs")
        elif g != r:
            raise AssertionError(f"{tag}: {k} differs")


def _same_result(got, ref, tag: str, tol: float = READER_IOU_TOL):
    gap = float(np.abs(np.asarray(got["iou_list"]) - np.asarray(ref["iou_list"])).max())
    if len(got["iou_list"]) != len(ref["iou_list"]) or gap > tol:
        raise AssertionError(f"{tag}: per-sample IoU off by {gap} (tol {tol})")
    for key in ("j_index@1", "j_index@5", "prec"):
        if got[key] != ref[key]:
            raise AssertionError(f"{tag}: {key} {got[key]} vs {ref[key]}")
    return gap


def reader_eval(device, cfg, rate_cfg, smi: str):
    """The val split from the tree: a one-thread loader without the put
    stage gives the reference host batches (and the reader's host time);
    then the CLI's loader (workers_val threads, the put stage) over a
    SampleCache, cold and warm, through ``validate_with_grasp``; then the
    refer-type sweep; then the eval rates on ``rate_cfg``'s larger tree
    (``reader_eval_rates``).  Returns the figures of the ``[reader]``
    line."""
    import json as _json
    import os

    import torch

    from crog_tpu_torch.data.cache import SampleCache
    from crog_tpu_torch.data.loader import DataLoader, DevicePut
    from crog_tpu_torch.engine.crog_engine import make_eval_step, validate_with_grasp
    from crog_tpu_torch.test_crog import build_dataset, eval_loader
    from crog_tpu_torch.test_diff_refer_types import Subset, evaluate_refer_types

    batch = cfg.batch_size_val
    plain = build_dataset(cfg, cfg.val_split)
    t0 = time.perf_counter()
    with DataLoader(plain, batch, pad_last_batch=True, num_workers=1) as one:
        ref_batches = list(one)
    reader_s = (time.perf_counter() - t0) / len(plain)
    model = _model(cfg, device).eval()
    eval_step = make_eval_step(model, input_size=cfg.input_size, ori_hw=plain.max_ori_size,
                               device=device)
    ref = validate_with_grasp(ref_batches, eval_step)

    ds = SampleCache(build_dataset(cfg, cfg.val_split))
    wrappers = launch_counts()
    with eval_loader(cfg, ds, batch, device) as loader:
        for run in ("cold", "warm"):
            seen = []
            _reset(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = validate_with_grasp(loader, eval_step,
                                         on_batch=lambda b, out, n: seen.append(b))
            dt = time.perf_counter() - t0
            launches = _read(wrappers)
            check_launches(launches, PER_FORWARD, len(ref_batches))
            for i, (got, want) in enumerate(zip(seen, ref_batches)):
                _same_batch(got, want, f"{run} batch {i}", device)
            if len(seen) != len(ref_batches):
                raise AssertionError(f"{run}: {len(seen)} batches, expected "
                                     f"{len(ref_batches)}")
            gap = _same_result(result, ref, run)
            print(f"[reader] eval {run} (checks): {len(plain)} samples in {dt:.3f} s "
                  f"(workers_val {cfg.workers_val}, put stage); IoU={result['iou']:.6f} "
                  f"J@1={result['j_index@1']:.6f} J@5={result['j_index@5']:.6f}; batches "
                  f"and results equal to the one-thread loader's (max IoU gap {gap}); "
                  f"launches {launches}", flush=True)
    if ds.cached_count != len(plain):
        raise AssertionError(f"the cache holds {ds.cached_count} of {len(plain)} samples")

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "refer_types.json")) as f:
        all_types = _json.load(f)
    types = {t: all_types[t] for t in READER_TYPES}
    sweep = evaluate_refer_types(ds, types, eval_step, batch_size=batch,
                                 num_workers=cfg.workers_val,
                                 device_put_fn=DevicePut(device))
    for t, idx in types.items():
        idx = [i for i in idx if i < len(plain)]
        if t not in sweep or not idx:
            raise AssertionError(f"refer type {t}: no samples swept")
        want = {"iou_list": [ref["iou_list"][i] for i in idx]}
        got = sweep[t]
        gap = float(np.abs(np.asarray(got["iou_list"]) - np.asarray(want["iou_list"])).max())
        if len(got["iou_list"]) != len(idx) or gap > SWEEP_IOU_TOL:
            raise AssertionError(f"refer type {t}: IoU off the full split's by {gap}")
        print(f"[reader] refer type {t}: {len(idx)} samples ({-len(idx) % batch} padded), "
              f"IoU={got['iou']:.6f} J@1={got['j_index@1']:.6f} "
              f"J@5={got['j_index@5']:.6f}; per-sample IoU within {gap} of the full "
              f"split's", flush=True)
    runs = reader_eval_rates(device, rate_cfg, eval_step, wrappers)
    del model, eval_step
    torch.cuda.empty_cache()
    return reader_s, runs


def reader_eval_rates(device, cfg, eval_step, wrappers):
    """Eval samples/s end to end over the val split of ``cfg``'s tree
    through the CLI's loader, twice over a fresh ``SampleCache``: each time
    cold (the reader), then warm (the cache); the loader's wait per batch
    and its share of the pass.  Launch counts as phase 4."""
    import torch

    from crog_tpu_torch.data.cache import SampleCache
    from crog_tpu_torch.engine.crog_engine import validate_with_grasp
    from crog_tpu_torch.test_crog import build_dataset, eval_loader

    runs = {"cold": [], "warm": []}
    for _ in range(2):
        ds = SampleCache(build_dataset(cfg, cfg.val_split))
        with eval_loader(cfg, ds, cfg.batch_size_val, device) as loader:
            for run in ("cold", "warm"):
                _reset(wrappers)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                validate_with_grasp(loader, eval_step)
                dt = time.perf_counter() - t0
                check_launches(_read(wrappers), PER_FORWARD,
                               loader.batch_count)
                runs[run].append((len(ds) / dt, loader.wait_seconds / loader.batch_count,
                                  loader.wait_seconds / dt))
                print(f"[reader] eval {run}: {len(ds)} samples ({loader.batch_count} "
                      f"batches) in {dt:.3f} s = {runs[run][-1][0]:.2f} samples/s end to "
                      f"end (reader, workers_val {cfg.workers_val}, put stage, eval step, "
                      f"Jacquard); loader wait {runs[run][-1][1] * 1e3:.1f} ms per batch, "
                      f"{runs[run][-1][2] * 100:.1f}% of the pass (host clock)", flush=True)
    return runs


def reader_train(device, cfg, rate_cfg, smi: str):
    """Four train steps through the train CLI's loader (shuffle, drop_last,
    ``workers`` threads, the put stage) on the tree's train split: finite
    loss, every parameter and statistic moved, the launch counts; then
    train samples/s over ``rate_cfg``'s larger tree with the loader on
    threads and on ``READER_PROCS`` processes, one epoch each in turn for
    READER_RATE_ROUNDS rounds (after one untimed epoch that starts the
    processes)."""
    import torch

    from crog_tpu_torch.data.loader import DataLoader, DevicePut
    from crog_tpu_torch.engine.crog_engine import make_train_step, train_one_epoch
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.test_crog import build_dataset
    from crog_tpu_torch.utils.seed import set_random_seed

    ds = build_dataset(cfg, cfg.train_split)
    steps = len(ds) // cfg.batch_size
    model = _model(cfg, device).train()
    opt, sched = make_optimizer(model, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, steps, cfg.weight_decay)
    step = make_train_step(model, opt, sched, cfg.use_grasp_masks, cfg.max_norm,
                           set_random_seed(SEED), device)

    def loader(data, procs: int):
        return DataLoader(data, cfg.batch_size, shuffle=True, drop_last=True, seed=SEED,
                          num_workers=cfg.workers, num_procs=procs,
                          device_put_fn=DevicePut(device))

    params0, stats0 = snapshot(model)
    wrappers = launch_counts()
    with loader(ds, 0) as threads:
        _reset(wrappers)
        for epoch in range(TRAIN_STEPS // steps):
            threads.set_epoch(epoch)
            metrics = train_one_epoch(threads, step, 1, cfg, steps)
        torch.cuda.synchronize()
        launches = _read(wrappers)
        loss = float(metrics["loss"])
        print(f"[reader] train: {TRAIN_STEPS} steps at batch {cfg.batch_size} through the "
              f"loader (workers {cfg.workers}): last loss {loss:.6g}; launches {launches}",
              flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"train loss is not finite: {loss}")
        check_launches(launches, PER_STEP, TRAIN_STEPS)
        check_moved(model, params0, stats0, "reader-train")
    big = build_dataset(rate_cfg, rate_cfg.train_split)
    steps = len(big) // cfg.batch_size
    rates = {"threads": [], "procs": []}
    with loader(big, 0) as threads, loader(big, READER_PROCS) as procs:
        train_one_epoch(procs, step, 1, cfg, steps)  # starts the worker processes
        for r in range(READER_RATE_ROUNDS):
            for kind, ld in (("threads", threads), ("procs", procs)):
                ld.set_epoch(10 + r)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_one_epoch(ld, step, 1, cfg, steps)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rates[kind].append((steps * cfg.batch_size / dt,
                                    ld.wait_seconds / ld.batch_count, ld.wait_seconds / dt))
                print(f"[reader] train round {r}, {kind}: {steps} steps in {dt:.3f} s = "
                      f"{rates[kind][-1][0]:.2f} samples/s; loader wait "
                      f"{rates[kind][-1][1] * 1e3:.1f} ms per batch, "
                      f"{rates[kind][-1][2] * 100:.1f}% of the epoch (host clock)",
                      flush=True)
    del model, step, opt
    torch.cuda.empty_cache()
    return rates


def reader_split(cfg, frames: int = READER_SPLIT_FRAMES):
    """The reader's host time per sample by part over the first ``frames``
    samples of ``cfg``'s val split: the PNG decodes (rgb, instance mask,
    depth), the rawlb letterbox on the native host ops (what the readers
    call), and the same letterbox in its numpy twin
    (``ops/affine.py:warp_affine_np``, which no reader calls), held against
    each other on this host (the library is built with -march=native):
    equal bits, as tests/test_torch_hostops.py holds them on its host.
    Returns ms per sample of each part ("decode", "native", "numpy")."""
    from crog_tpu_torch.data.ocid_vlg import CLIP_MEAN
    from crog_tpu_torch.native import warp_affine
    from crog_tpu_torch.ops.affine import letterbox_transform, warp_affine_np
    from crog_tpu_torch.test_crog import build_dataset

    ds = build_dataset(cfg, cfg.val_split)
    border = tuple((CLIP_MEAN * 255).tolist())
    t = {"decode": 0.0, "native": 0.0, "numpy": 0.0}
    differing = 0
    for it in ds.items[:frames]:
        t0 = time.perf_counter()
        img = ds._rgb(it)
        ds._png(it, "seg_mask_instances_combi")
        ds._png(it, "depth")
        t1 = time.perf_counter()
        mat, _ = letterbox_transform(img.shape[:2], ds.input_size)
        got = warp_affine(img, mat, ds.input_size, "cubic", border)
        t2 = time.perf_counter()
        ref = warp_affine_np(img, mat, ds.input_size, "cubic", border)
        t3 = time.perf_counter()
        t["decode"] += t1 - t0
        t["native"] += t2 - t1
        t["numpy"] += t3 - t2
        diff = np.abs(got.astype(np.int16) - ref)
        differing += int((diff > 0).sum())
        if differing:
            raise AssertionError(f"native letterbox of {it['scene_id']} off the numpy twin "
                                 f"by {diff.max()} on {(diff > 0).mean():.3g} of the pixels")
    ms = {k: v / frames * 1e3 for k, v in t.items()}
    print(f"[reader] the readers warp, fill and blur on the native host ops "
          f"(crog_tpu_torch/native, g++ -march=native of this host); over {frames} frames "
          f"of the val split: PNG decodes (rgb, mask, depth) {ms['decode']:.2f} ms per "
          f"sample, the rawlb letterbox {ms['native']:.2f} ms, its numpy twin "
          f"{ms['numpy']:.2f} ms ({ms['numpy'] / ms['native']:.1f}x); native vs twin: "
          f"{differing} differing pixels", flush=True)
    return ms


def _spread(runs, i: int, scale: float = 1.0, fmt: str = ".2f") -> str:
    """The mean of field ``i`` over ``runs`` with its least and largest."""
    v = [r[i] * scale for r in runs]
    return (f"{sum(v) / len(v):{fmt}} ({min(v):{fmt}}-{max(v):{fmt}} over "
            f"{len(v)})")


def reader_phase(device, smi: str):
    """Phase 12: write the tree, run ``reader_eval`` and ``reader_train``,
    print the ``[reader]`` summary line."""
    import tempfile

    fixture = _ocid_fixture()
    with tempfile.TemporaryDirectory(prefix="ocid_vlg_") as root, \
            tempfile.TemporaryDirectory(prefix="ocid_vlg_rates_") as rate_root:
        t0 = time.perf_counter()
        fixture.build_ocid_tree(root, num_scenes=READER_SCENES)
        fixture.build_ocid_tree(rate_root, num_scenes=READER_RATE_SCENES)
        cfg, rate_cfg = _reader_cfg(root), _reader_cfg(rate_root)
        print(f"[reader] {READER_CONFIG} as written (root_path: OCID-VLG trees of "
              f"{READER_SCENES} scenes for the checks and {READER_RATE_SCENES} for the rates, "
              f"written in {time.perf_counter() - t0:.1f} s; {cfg.wire_format} wire, "
              f"stem_s2d {cfg.stem_s2d}, batch {cfg.batch_size}, workers {cfg.workers}, "
              f"workers_val {cfg.workers_val})", flush=True)
        split = reader_split(cfg)
        reader_s, runs = reader_eval(device, cfg, rate_cfg, smi)
        rates = reader_train(device, cfg, rate_cfg, smi)
    print(f"[reader] mean (least-largest over runs) from the {READER_RATE_SCENES}-scene tree: "
          f"eval {_spread(runs['cold'], 0)} samples/s cold, {_spread(runs['warm'], 0)} warm "
          f"(SampleCache) end to end at batch {cfg.batch_size_val}; reader alone "
          f"{reader_s * 1e3:.2f} ms per sample on one thread (decode, preprocess on the "
          f"native host ops, collate; {READER_SCENES}-scene tree; the letterbox "
          f"{split['native']:.2f} ms of it, its numpy twin {split['numpy']:.2f}); loader wait {_spread(runs['cold'], 1, 1e3, '.1f')} ms "
          f"cold, {_spread(runs['warm'], 1, 1e3, '.1f')} ms warm per eval batch; train "
          f"{_spread(rates['threads'], 0)} samples/s with {cfg.workers} threads (wait "
          f"{_spread(rates['threads'], 1, 1e3, '.1f')} ms per batch), "
          f"{_spread(rates['procs'], 0)} with workers_procs {READER_PROCS} (wait "
          f"{_spread(rates['procs'], 1, 1e3, '.1f')} ms) at batch {cfg.batch_size} on {smi}",
          flush=True)
    return runs, rates


# phase 13: data parallelism (crog_tpu_torch/parallel/dist.py)
DDP_STEPS = 2
DDP_WORLD = 2
# Phase 13a's limits, each between the sound code's reading and those of
# faults planted in the ranks by tools/torch_ddp_faults.py (on an NVIDIA
# H100 80GB HBM3; PERF.md, PR 13).  Two ranks and one process differ only
# in the order of fp32 sums, which bf16 rounding amplifies through
# train-mode BatchNorm.  Sound, CROG / SSG: the first step's loss terms
# 0.38% / 0.57%, its BatchNorm batch statistics 0.71% / 0.23% (rel-L2 of
# the worst buffer), the running statistics after 2 steps 3.5% / 3.4% of a
# buffer's scale, gradients 0.194 / 0.215.  No all-reduce of the
# BatchNorm sums: 22% / 7.9%, 40% / 14%, 20% / 10%, 1.34 / 0.73, and the
# ranks' buffers differ.  The all-reduce without its backward: terms and
# batch statistics as sound, 29% / 11%, 1.09 / 0.52.  The gradients are
# held to TRAIN_GRAD_TOL / SSG_GRAD_TOL (0.25), which lies between.
DDP_TERM_TOL = 0.02
DDP_BATCH_STAT_TOL = 0.03
DDP_STAT_TOL = 0.06
# SSG's loss alone in fp32 on seeded outputs (``ssg_loss_case``): two
# ranks and one process differ in the order of fp32 sums only, while a
# rank that divides by its own positive count scales its rows' gradients
# by the two counts' ratio (176 and 185 positives in the halves of SSG's
# first batch; in the bf16 steps above that fault reads as sound).
DDP_FP32_TOL = 1e-4
DDP_TIMEOUT = 600  # seconds for a rank's run, or a CLI's
DDP_TIMED_STEPS = 6  # of each kind, in turns


def _ddp_cfg():
    """crog_multiple_r50.yaml's model as written, dropout 0."""
    from crog_tpu_torch.config import load_cfg_from_cfg_file, merge_cfg_from_list

    return merge_cfg_from_list(load_cfg_from_cfg_file(READER_CONFIG), ["dropout", "0.0"])


def _rank_rows(batch, rank: int, world: int):
    """A rank's rows of a global host batch (rank-major)."""
    n = len(batch["word"] if "word" in batch else batch["obj_valid"]) // world
    return {k: v[rank * n:(rank + 1) * n] if isinstance(v, (np.ndarray, list)) else v
            for k, v in batch.items()}


def _digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes: equal iff bit-equal."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _running_stats(net):
    """The BatchNorm running statistics, on the host in fp32."""
    return {n: b.float().cpu() for n, b in net.named_buffers() if "running" in n}


def _ddp_steps(net, step, batches, keep: bool):
    """``step`` over ``batches`` with the launch counters read around them:
    per step the terms averaged over the ranks; with ``keep`` (on the host)
    the first step's gradients and its change to the BatchNorm running
    statistics (momentum times the batch's statistic less the start value:
    the first forward's alone, from equal weights), and the statistics
    after the last step; a digest of the model; the launches."""
    import torch

    from crog_tpu_torch.parallel.dist import mean_over_ranks

    wrappers = launch_counts()
    _reset(wrappers)
    out = {"terms": [], "grads": None, "stats": None, "batch_stats": None}
    start = _running_stats(net) if keep else None
    for i, batch in enumerate(batches):
        out["terms"].append({k: float(v) for k, v in mean_over_ranks(step(batch)).items()})
        if i == 0 and keep:
            out["grads"] = {n: p.grad.float().cpu() for n, p in net.named_parameters()
                            if p.grad is not None}
            out["batch_stats"] = {n: b - start[n] for n, b in _running_stats(net).items()}
    torch.cuda.synchronize()
    out["launches"] = _read(wrappers)
    if keep:
        out["stats"] = _running_stats(net)
    out["digest"] = _digest(net)
    return out


def ddp_crog_steps(device, batches, keep: bool = True):
    """DDP_STEPS train steps of ``_ddp_cfg``'s model (seeded weights, the
    s2d stem on K6/K6b) through ``wrap_model`` and ``make_train_step``:
    DDP under a process group of world > 1, the model itself in one
    process."""
    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.parallel.dist import wrap_model
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = _ddp_cfg()
    net = _model(cfg, device).train()
    opt, sched = make_optimizer(net, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                cfg.lr_decay, DDP_STEPS, cfg.weight_decay)
    step = make_train_step(wrap_model(net, device), opt, sched, cfg.use_grasp_masks,
                           cfg.max_norm, set_random_seed(SEED), device)
    return _ddp_steps(net, step, batches, keep)


def ddp_ssg_steps(device, batches, keep: bool = True):
    """As ``ddp_crog_steps`` for SSG's config as written (raw wire)."""
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.engine.ssg_engine import make_ssg_train_step
    from crog_tpu_torch.parallel.dist import wrap_model
    from crog_tpu_torch.train_ssg import loss_config
    from crog_tpu_torch.utils.seed import set_random_seed

    cfg = _ssg_cfg()
    net = _ssg_model(cfg, device).train()
    opt, sched = make_optimizer(net, cfg.base_lr, 1.0, cfg.milestones, cfg.lr_decay,
                                DDP_STEPS, cfg.weight_decay)
    step = make_ssg_train_step(wrap_model(net, device), opt, sched, net.anchors(),
                               loss_config(cfg), set_random_seed(SEED), cfg.max_norm,
                               device, max_objs=cfg.max_objs)
    return _ddp_steps(net, step, batches, keep)


def ddp_worker(workdir: str) -> int:
    """One rank of phase 13's two on one card (``--ddp-worker DIR``, with
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT set): gloo
    over CUDA tensors, as NCCL refuses two ranks on one device.  Its rows
    of DIR/batches.pt through ``ddp_crog_steps`` and ``ddp_ssg_steps``,
    the results to DIR/rank<R>.pt."""
    import os

    import torch

    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.parallel import dist

    set_exact_fp32_matmul()
    device = dist.init_from_env("cuda", "gloo")
    rank, world = dist.rank(), dist.world()
    data = torch.load(os.path.join(workdir, "batches.pt"), weights_only=False)
    out = {"crog": ddp_crog_steps(device, [_rank_rows(b, rank, world) for b in data["crog"]],
                                  keep=rank == 0)}
    torch.cuda.empty_cache()
    out["ssg"] = ddp_ssg_steps(device, [_rank_rows(b, rank, world) for b in data["ssg"]],
                               keep=rank == 0)
    torch.cuda.empty_cache()
    out["ssg_loss"] = ssg_loss_case(device, data["ssg"][0], data["ssg_loss"], rank, world)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(workdir: str, worker=None):
    """Phase 13a's two ranks in processes of their own, each running
    ``python <worker...> DIR`` (by default this script's ``--ddp-worker``);
    their results."""
    import os

    import torch

    port, procs = _free_port(), []
    try:
        for rank in range(DDP_WORLD):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": "0",
                   "WORLD_SIZE": str(DDP_WORLD), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, *(worker or [__file__, "--ddp-worker"]), workdir], env=env,
                stdout=log, stderr=subprocess.STDOUT), log))
        codes = [p.wait(timeout=DDP_TIMEOUT) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if codes != [0] * DDP_WORLD:
        for rank in range(DDP_WORLD):
            with open(os.path.join(workdir, f"rank{rank}.log")) as f:
                print(f"[ddp] rank {rank}:\n{f.read()[-6000:]}", flush=True)
        raise AssertionError(f"phase 13 ranks exited {codes}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(DDP_WORLD)]


def _rel_l2(got, want) -> float:
    num = sum(float((got[n] - want[n]).pow(2).sum()) for n in want)
    den = sum(float(want[n].pow(2).sum()) for n in want)
    return (num / max(den, 1e-30)) ** 0.5


def ddp_readings(ref, got, keys, group_of, groups):
    """Phase 13a's readings of a rank (``got``) against one process
    (``ref``): ``terms1``, the first step's largest relative gap of a loss
    term in ``keys``; ``grads``, the first step's gradient rel-L2 per
    group; ``batch_stats``, the worst rel-L2 over the buffers of the first
    step's change to the running statistics; ``stats``, the worst gap of a
    buffer after the last step over that buffer's largest magnitude."""
    gc, gp = got["grads"], ref["grads"]
    if set(gc) != set(gp):
        raise AssertionError("gradients for different parameters")
    t1, w1 = got["terms"][0], ref["terms"][0]
    return {
        "terms1": max(abs(t1[k] - w1[k]) / abs(w1[k]) for k in keys),
        "grads": {g: _rel_l2(gc, {n: x for n, x in gp.items() if group_of(n) == g})
                  for g in groups},
        "batch_stats": max(_rel_l2(got["batch_stats"], {n: b})
                           for n, b in ref["batch_stats"].items()),
        "stats": max(float((got["stats"][n] - b).abs().max()
                           / b.abs().max().clamp_min(1e-12))
                     for n, b in ref["stats"].items()),
    }


def _ddp_compare(tag, ref, ranks, keys, loss_bad, group_of, groups, grad_tol, per_step):
    """Phase 13a's checks of one model: the ranks bit-equal, the launches,
    each step's terms (``loss_bad(got, ref) -> bad keys``), the first
    step's loss terms (``keys``) within DDP_TERM_TOL, its per-group
    gradient rel-L2 within ``grad_tol`` and its BatchNorm batch statistics
    within DDP_BATCH_STAT_TOL, the running statistics within DDP_STAT_TOL."""
    r0, r1 = ranks
    if r0["digest"] != r1["digest"]:
        raise AssertionError(f"[{tag}] the two ranks' parameters or buffers differ")
    check_launches(r0["launches"], per_step, DDP_STEPS)
    for i, (got, want) in enumerate(zip(r0["terms"], ref["terms"])):
        print(f"[{tag}] step {i + 1}: 2 ranks / 1 process " + ", ".join(
            f"{k} {got[k]:.6g}/{want[k]:.6g}" for k in want), flush=True)
        bad = loss_bad(got, want)
        if bad:
            raise AssertionError(f"[{tag}] step {i + 1}: terms {bad} differ")
    r = ddp_readings(ref, r0, keys, group_of, groups)
    print(f"[{tag}] first step: terms worst {r['terms1']:.4g} (tol {DDP_TERM_TOL}), "
          f"BatchNorm batch statistics worst rel_l2 {r['batch_stats']:.4g} (tol "
          f"{DDP_BATCH_STAT_TOL}), grad rel_l2 " + ", ".join(
              f"{g} {x:.4g}" for g, x in r["grads"].items())
          + f" (tol {grad_tol}); BatchNorm statistics after step {DDP_STEPS} worst "
          f"{r['stats']:.4g} of the buffer's scale (tol {DDP_STAT_TOL}); parameters and "
          f"buffers bit-equal across the ranks; launches {r0['launches']}", flush=True)
    if (r["terms1"] > DDP_TERM_TOL or r["batch_stats"] > DDP_BATCH_STAT_TOL
            or max(r["grads"].values()) > grad_tol or r["stats"] > DDP_STAT_TOL):
        raise AssertionError(f"[{tag}] 2 ranks vs 1 process: {r}")


# per model of phase 13a: its loss terms, and its gradient groups
DDP_KEYS = {"crog": ("loss", "m_ins", "m_qua", "m_sin", "m_cos", "m_wid"),
            "ssg": ("loss", "loss_cls", "loss_box", "loss_ins", "loss_sem", "loss_qua",
                    "loss_sin", "loss_cos", "loss_wid")}
DDP_GROUPS = {"crog": (_group, [g for g, _ in GROUPS]),
              "ssg": (lambda n: n.split(".")[0], SSG_GROUPS)}


def ssg_loss_inputs(device, batch):
    """The shapes of SSG's train-mode outputs on the global ``batch`` (one
    forward of the seeded model) and its anchors: what ``ssg_loss_case``
    needs besides the batch."""
    import torch

    from crog_tpu_torch.engine.ssg_engine import device_batch

    net = _ssg_model(_ssg_cfg(), device).train()
    with torch.no_grad():
        out = net(device_batch(batch, device, net.img_size, net.with_depth,
                               targets=False)["img"])
    return {"shapes": {k: tuple(v.shape) for k, v in out.items()}, "anchors": net.anchors()}


def ssg_loss_case(device, batch, inputs, rank: int = 0, world: int = 1):
    """SSG's loss alone in fp32, no network: seeded normal outputs of the
    global batch (``inputs``' shapes), this rank's rows of them and of
    ``batch``, through ``ssg_losses`` (priorities from a generator seeded
    alike on every rank) and its backward; the terms and the gradients of
    the output rows."""
    import torch

    from crog_tpu_torch.engine.ssg_engine import device_batch
    from crog_tpu_torch.models.ssg_loss import ssg_losses
    from crog_tpu_torch.train_ssg import loss_config

    cfg = _ssg_cfg()
    gen = torch.Generator(device).manual_seed(SEED)
    out = {}
    for k, shape in sorted(inputs["shapes"].items()):
        n = shape[0] // world
        out[k] = torch.randn(shape, generator=gen, device=device)[
            rank * n:(rank + 1) * n].clone().requires_grad_()
    dense = device_batch(_rank_rows(batch, rank, world), device, cfg.img_size,
                         cfg.with_depth, max_objs=cfg.max_objs)
    anchors = torch.as_tensor(inputs["anchors"], dtype=torch.float32, device=device)
    loss, terms = ssg_losses(out, dense, anchors, torch.Generator().manual_seed(SEED),
                             **loss_config(cfg))
    loss.backward()
    return {"terms": {"loss": float(loss.detach()),
                      **{k: float(v.detach()) for k, v in terms.items()}},
            "grads": {k: v.grad.cpu() for k, v in out.items()}}


def ssg_loss_readings(ref, ranks):
    """``ssg_loss_case`` of the ranks against one process: the worst
    relative gap of a term's mean over the ranks, and the worst rel-L2 of
    an output's gradient (each rank's rows over ``world``: DDP's mean)."""
    import torch

    world = len(ranks)
    return {
        "terms": max(abs(sum(r["terms"][k] for r in ranks) / world - v) / abs(v)
                     for k, v in ref["terms"].items() if v),
        "grads": max(_rel_l2({k: torch.cat([r["grads"][k] for r in ranks]) / world},
                             {k: g}) for k, g in ref["grads"].items()),
    }


def ddp_reference(device, crog_batches, ssg_batches, workdir: str):
    """Phase 13a's one-process runs: DDP_STEPS steps of CROG at BATCH and
    of SSG at SSG_BATCH, and ``ssg_loss_case`` on SSG's first batch; the
    batches and that case's inputs saved in ``workdir`` for the ranks."""
    import os

    import torch

    crog_batches, ssg_batches = crog_batches[:DDP_STEPS], ssg_batches[:DDP_STEPS]
    loss_inputs = ssg_loss_inputs(device, ssg_batches[0])
    torch.cuda.empty_cache()
    torch.save({"crog": crog_batches, "ssg": ssg_batches, "ssg_loss": loss_inputs},
               os.path.join(workdir, "batches.pt"))
    ref = {"crog": ddp_crog_steps(device, crog_batches)}
    torch.cuda.empty_cache()
    ref["ssg"] = ddp_ssg_steps(device, ssg_batches)
    torch.cuda.empty_cache()
    ref["ssg_loss"] = ssg_loss_case(device, ssg_batches[0], loss_inputs)
    torch.cuda.empty_cache()
    return ref


def ddp_two_ranks(device, crog_batches, ssg_batches, workdir: str):
    """Phase 13a: the steps of ``ddp_reference`` in one process, then on
    two ranks of half the batch on this card."""
    ref = ddp_reference(device, crog_batches, ssg_batches, workdir)
    ranks = _run_ranks(workdir)
    _ddp_compare(
        "ddp-crog", ref["crog"], [r["crog"] for r in ranks], DDP_KEYS["crog"],
        lambda got, want: [k for k in DDP_KEYS["crog"]
                           if abs(got[k] - want[k]) > TRAIN_LOSS_TOL * abs(want[k])],
        *DDP_GROUPS["crog"], TRAIN_GRAD_TOL, PER_STEP)
    _ddp_compare(
        "ddp-ssg", ref["ssg"], [r["ssg"] for r in ranks], DDP_KEYS["ssg"],
        lambda got, want: [k for k in want if abs(got[k] - want[k])
                           > SSG_LOSS_TOL * abs(want[k]) + SSG_LOSS_FLOOR * abs(want["loss"])],
        *DDP_GROUPS["ssg"], SSG_GRAD_TOL, SSG_PER_STEP)
    r = ssg_loss_readings(ref["ssg_loss"], [x["ssg_loss"] for x in ranks])
    print(f"[ddp-ssg] the loss alone in fp32 on seeded outputs of SSG's first batch, 2 "
          f"ranks / 1 process: terms worst {r['terms']:.4g}, output gradients worst rel_l2 "
          f"{r['grads']:.4g} (tol {DDP_FP32_TOL})", flush=True)
    if max(r.values()) > DDP_FP32_TOL:
        raise AssertionError(f"[ddp-ssg] the loss alone: {r}")


def _run_cli(args, workdir: str, log_name: str) -> str:
    """A CLI in a process of its own; its log (the command fails the phase
    when it exits other than 0)."""
    import os
    import signal

    path = os.path.join(workdir, log_name)
    with open(path, "w") as log:
        # a session of its own, so that a timeout also stops torchrun's workers
        proc = subprocess.Popen([sys.executable, *args], stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DDP_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(path) as f:
        text = f.read()
    if rc != 0:
        print(text[-6000:], flush=True)
        raise AssertionError(f"{' '.join(args[:6])} ...: exit {rc}")
    return text


def ddp_cli(workdir: str):
    """Phase 13b: torchrun of train_crog on one rank over NCCL (the
    synthetic config as written, 2 steps of 24 and one eval over 48), then
    the one-process test_crog on its last_model.  At world 1 ``wrap_model``
    returns the model itself and every collective of ``parallel/dist.py``
    is the identity: this runs torchrun's environment, NCCL's init and the
    CLI's rank-0 writes, no DDP and no collective."""
    import json
    import os

    exp = os.path.join(workdir, "cli")
    opts = ["synthetic_samples", str(2 * BATCH), "epochs", "1", "print_freq", "1",
            "output_folder", workdir, "exp_name", "cli"]
    t0 = time.perf_counter()
    text = _run_cli(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                     "-m", "crog_tpu_torch.train_crog", "--config", CONFIG, "--fused-stem",
                     "--opts", *opts], workdir, "train.out")
    dt = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val = next(r for r in records if "val/iou" in r)
    ckpt = os.path.join(exp, "last_model")
    if "Device: cuda:0; 1 rank(s)" not in text or not os.path.isfile(ckpt):
        raise AssertionError("train_crog under torchrun: no rank line or no last_model")
    t1 = time.perf_counter()
    text = _run_cli(["-m", "crog_tpu_torch.test_crog", "--config", CONFIG, "--fused-stem",
                     "--opts", "synthetic_samples", str(BATCH), "resume", ckpt,
                     "output_folder", workdir, "exp_name", "cli"], workdir, "test.out")
    final = next(line for line in text.splitlines() if "Final:" in line)
    if "=> loaded checkpoint" not in text:
        raise AssertionError("test_crog did not load train_crog's last_model")
    print(f"[ddp-cli] torchrun --nproc_per_node 1 (nccl; world 1: no DDP, no collective) "
          f"train_crog: 2 steps at {BATCH} and "
          f"eval over {2 * BATCH}, exit 0 in {dt:.1f} s, metrics.jsonl val/iou "
          f"{val['val/iou']:.6f} J@1 {val['val/j_index@1']:.6f}; its last_model through "
          f"test_crog in one process, exit 0 in {time.perf_counter() - t1:.1f} s: "
          f"{final.split('|')[-1].strip()}", flush=True)


def ddp_step_times(device, batch):
    """Phase 13c: ms per CROG train step at BATCH, one rank under NCCL,
    through DDP beside the model itself, DDP_TIMED_STEPS of each in turns
    after one of each; (ddp ms, plain ms) lists."""
    import statistics

    import torch
    import torch.distributed as tdist

    from crog_tpu_torch.engine.crog_engine import make_train_step
    from crog_tpu_torch.engine.optim import make_optimizer
    from crog_tpu_torch.parallel.dist import ddp
    from crog_tpu_torch.utils.seed import set_random_seed

    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                             world_size=1, rank=0, device_id=device)
    try:
        cfg = _ddp_cfg()
        steps = {}
        for kind in ("plain", "ddp"):
            net = _model(cfg, device).train()
            opt, sched = make_optimizer(net, cfg.base_lr, cfg.lr_multi, cfg.milestones,
                                        cfg.lr_decay, 100, cfg.weight_decay)
            steps[kind] = make_train_step(ddp(net, device) if kind == "ddp" else net, opt,
                                          sched, cfg.use_grasp_masks, cfg.max_norm,
                                          set_random_seed(SEED), device)
        ms = {"plain": [], "ddp": []}
        for i in range(DDP_TIMED_STEPS + 1):
            for kind in (("plain", "ddp") if i % 2 == 0 else ("ddp", "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[kind](batch)
                torch.cuda.synchronize()
                if i > 0:
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        tdist.destroy_process_group()
    med = {k: statistics.median(v) for k, v in ms.items()}
    return ms, med


def ddp_phase(device, crog_batches, ssg_batches, smi: str):
    """Phase 13: 13a, 13b, 13c; the ``[ddp]`` line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ddp_") as workdir:
        ddp_two_ranks(device, crog_batches, ssg_batches, workdir)
        ddp_cli(workdir)
    ms, med = ddp_step_times(device, crog_batches[0])
    spread = {k: f"{min(v):.2f}-{max(v):.2f}" for k, v in ms.items()}
    print(f"[ddp] one rank under NCCL, CROG train step at batch {BATCH} "
          f"({READER_CONFIG}'s model, dropout 0): DDP {med['ddp']:.2f} ms (median; "
          f"{spread['ddp']} over {DDP_TIMED_STEPS}), the model itself {med['plain']:.2f} ms "
          f"({spread['plain']}): the wrapper's cost on one card "
          f"{med['ddp'] - med['plain']:.2f} ms, not a scaling figure; phase 13 took "
          f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)


# phase 14: the CLIP ViT family (models/clip.py ``CLIPViT``) at the published
# widths of the CLIP paper (Radford et al. 2021, Table 20), seeded weights,
# bf16, batch VIT_BATCH: its unmasked self-attention over 197 and 577 tokens
# runs K1 (two passes past 192 keys) and K1b (one CTA per head up to 256
# tokens, two kernels beyond) at key counts the CROG path never gives them
VIT_CONFIGS = {
    "ViT-B/16": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=16, transformer_width=512,
                     transformer_heads=8, transformer_layers=12),
    "ViT-L/14@336px": dict(embed_dim=768, image_resolution=336, vision_layers=24,
                           vision_width=1024, vision_patch_size=14, transformer_width=768,
                           transformer_heads=12, transformer_layers=12),
}
VIT_BATCH = 16
VIT_TIMED_STEPS = 3
# card (bf16, kernels) vs CPU (fp32, plain) on one sample: bound on the
# relative L2 error of the patch features and of the EOT state.  bf16 keeps
# ~3 significant digits, and the error of each of the 12 or 24 pre-LN
# blocks adds to the residual stream (bf16 against fp32 on the CPU, both
# plain: 0.010 and 0.012 for ViT-B/16 and ViT-L/14); a wrong kernel, head
# split or positional slice is off by order 1
VIT_E2E_TOL = 0.05


def _vit_text(g, b: int, context: int, vocab: int = 49408):
    """[b, context] token ids: SOT, 4..40 random words, EOT (the largest
    id), zero padding."""
    import torch

    text = torch.zeros(b, context, dtype=torch.long)
    for i in range(b):
        n = int(torch.randint(4, 41, (1,), generator=g))
        text[i, 0] = vocab - 2
        text[i, 1:n + 1] = torch.randint(1, vocab - 2, (n,), generator=g)
        text[i, n + 1] = vocab - 1
    return text


def vit_kernel_checks(device, label: str, tokens: int, heads: int, b: int = VIT_BATCH):
    """K1 and K1b at a ViT's attention shape against their twins (K1's and
    K1b's tolerances), each timed beside its twin and SDPA's forward or
    backward (a yardstick only), with its bound; returns the figures."""
    import torch
    import torch.nn.functional as F

    from crog_tpu_torch.ops import attention as A

    g = torch.Generator().manual_seed(SEED + 21)
    d = heads * 64
    q, k, v, do = (torch.randn(b, tokens, d, generator=g).to(device, torch.bfloat16)
                   for _ in range(4))
    shape = f"{label}: L {tokens}, {heads} heads, batch {b}"
    kern = lambda: A.fused_attention(q, k, v, heads)
    plain = lambda: A.attention_plain(q, k, v, heads)
    o = kern()
    fwd_err = _compare(f"attention ({A.fwd_path(tokens)}) at {shape}", o, plain(),
                       TOL["attention"])
    bwd = lambda: A.attention_bwd(q, k, v, o, do, heads)
    bwd_plain = lambda: A.attention_bwd_plain(q, k, v, o, do, heads)
    bwd_err = 0.0
    for name, got, ref in zip(("dq", "dk", "dv"), bwd(), bwd_plain()):
        bwd_err = max(bwd_err, _compare(
            f"attention_bwd ({A.bwd_path(tokens)}) at {shape}.{name}", got, ref,
            K1B_REL_TOL * float(ref.float().abs().max()), K1B_DIFF_SHARE))
    split = lambda x: x.view(b, tokens, heads, 64).transpose(1, 2)
    leaves = [split(t).detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves)
    sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, split(do), retain_graph=True)
    fig = {"k1_path": A.fwd_path(tokens), "k1_err": fwd_err, "k1_ms": cuda_ms(kern),
           "k1_plain_ms": cuda_ms(plain, reps=5), "sdpa_ms": cuda_ms(sdpa),
           "k1_bound": bound(work.attention_flops(b, tokens, tokens, d), 4 * nbytes(q)),
           "k1b_path": A.bwd_path(tokens), "k1b_err": bwd_err, "k1b_ms": cuda_ms(bwd),
           "k1b_plain_ms": cuda_ms(bwd_plain, reps=5), "sdpa_bwd_ms": cuda_ms(sdpa_bwd),
           "k1b_bound": bound(work.attention_bwd_flops(b, tokens, d), 8 * nbytes(q))}
    print(f"[vit] K1 at {shape}: {fig['k1_ms']:.4f} ms (plain {fig['k1_plain_ms']:.4f}, "
          f"SDPA {fig['sdpa_ms']:.4f}, bound {fig['k1_bound'][0]:.4f} by "
          f"{fig['k1_bound'][1]}); K1b {fig['k1b_ms']:.4f} ms (plain "
          f"{fig['k1b_plain_ms']:.4f}, SDPA backward {fig['sdpa_bwd_ms']:.4f}, bound "
          f"{fig['k1b_bound'][0]:.4f} by {fig['k1b_bound'][1]})", flush=True)
    return fig


def vit_e2e(model, cfg, img, text, card_vis, card_state):
    """One sample through the same weights on the CPU in fp32 (plain
    attention) against the card's bf16 output (the kernels): rel-L2 of the
    patch features and of the EOT state, each within VIT_E2E_TOL."""
    import torch

    from crog_tpu_torch.models.clip import CLIPViT

    cpu = CLIPViT(dtype=torch.float32, **cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        vis, _, state = cpu.eval()(img, text)
    rel = {}
    for name, got, want in (("features", card_vis, vis), ("state", card_state, state)):
        d = got.float().cpu() - want
        rel[name] = float(d.norm() / want.norm().clamp_min(1e-6))
    if max(rel.values()) > VIT_E2E_TOL:
        raise AssertionError(f"ViT card vs CPU rel_l2 {rel} > {VIT_E2E_TOL}")
    return rel


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.2f} ms"


def _share(dev, wall) -> str:
    return "not measured" if dev is None else f"{100 * dev / wall:.1f}%"


def vit_phase(device, smi: str):
    """Phase 14: each of VIT_CONFIGS built as ``CLIPViT`` with seeded
    weights in bf16 at VIT_BATCH: the forward (image and text) with K1's
    launches checked (one per vision block, no K1b), one sample of it
    against the CPU in fp32 on the same weights, a backward from the image
    features with K1's and K1b's launches (one each per block), the
    forward and a train step timed (AdamW, which moves the weights: after
    the comparison) by CUDA events, then their kernel time on the card by
    torch.profiler (the card's busy share), K1 and K1b at its attention
    shape against their twins; the ``[vit]`` line."""
    import torch

    from crog_tpu_torch.models.clip import CLIPViT
    from crog_tpu_torch.models.crog import random_init_

    t_phase = time.perf_counter()
    wrappers = launch_counts()
    for label, cfg in VIT_CONFIGS.items():
        layers, res = cfg["vision_layers"], cfg["image_resolution"]
        heads = cfg["vision_width"] // 64
        tokens = (res // cfg["vision_patch_size"]) ** 2 + 1
        model = CLIPViT(dtype=torch.bfloat16, **cfg)
        random_init_(model, torch.Generator().manual_seed(SEED))
        model = model.to(device)
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator().manual_seed(SEED + 20)
        img = torch.randn(VIT_BATCH, res, res, 3, generator=g)
        text = _vit_text(g, VIT_BATCH, model.context_length)
        target = torch.randn(VIT_BATCH, tokens - 1, cfg["embed_dim"], generator=g).to(device)
        img_d, text_d = img.to(device), text.to(device)

        _reset(wrappers)
        with torch.no_grad():
            vis, word, state = model(img_d, text_d)
        torch.cuda.synchronize()
        fwd_launches = _read(wrappers)
        check_launches(fwd_launches, {"attention": layers}, 1)
        if (vis.shape != (VIT_BATCH, tokens - 1, cfg["embed_dim"])
                or not all(bool(torch.isfinite(t.float()).all()) for t in (vis, word, state))):
            raise AssertionError(f"{label}: features {tuple(vis.shape)} not finite/shaped")
        rel = vit_e2e(model, cfg, img[:1], text[:1], vis[:1], state[:1])

        _reset(wrappers)
        (model.encode_image(img_d).float() * target).sum().backward()
        torch.cuda.synchronize()
        bwd_launches = _read(wrappers)
        check_launches(bwd_launches, {"attention": layers, "attention_bwd": layers}, 1)
        grads = [p.grad for p in model.visual.parameters()]
        if any(g_ is None or not bool(torch.isfinite(g_).all()) or not bool(g_.any())
               for g_ in grads):
            raise AssertionError(f"{label}: a vision gradient is missing, zero or not finite")
        model.zero_grad(set_to_none=True)

        def forward():
            with torch.no_grad():
                return model(img_d, text_d)

        opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-5)

        def train_step():
            opt.zero_grad(set_to_none=True)
            v, _, s = model(img_d, text_d)
            ((v.float() * target).mean() + s.float().pow(2).mean()).backward()
            opt.step()

        fwd_ms = cuda_ms(forward, reps=5, warmup=1)
        step_ms = cuda_ms(train_step, reps=VIT_TIMED_STEPS, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the card's kernel time per call (torch.profiler), after the timed calls
        fwd_dev = device_ms(forward, reps=3)[0]
        step_dev = device_ms(train_step, reps=2)[0]
        fig = vit_kernel_checks(device, label, tokens, heads)
        print(f"[vit] {label} ({res}^2, {tokens} tokens x {heads} heads, {layers} blocks of "
              f"width {cfg['vision_width']}, text {cfg['transformer_layers']} x "
              f"{cfg['transformer_width']}; seeded weights, bf16, batch {VIT_BATCH}): forward "
              f"{fwd_ms:.2f} ms = {VIT_BATCH / fwd_ms * 1e3:.1f} samples/s (device "
              f"{_ms(fwd_dev)}, busy {_share(fwd_dev, fwd_ms)}); train step (AdamW) "
              f"{step_ms:.2f} ms = {VIT_BATCH / step_ms * 1e3:.1f} samples/s (device "
              f"{_ms(step_dev)}, busy {_share(step_dev, step_ms)}); peak "
              f"{peak:.2f} GiB; launches forward {fwd_launches['attention']} K1, backward "
              f"{bwd_launches['attention_bwd']} K1b ({fig['k1_path']} / {fig['k1b_path']}); "
              f"K1 {fig['k1_ms']:.4f} ms (SDPA {fig['sdpa_ms']:.4f}), K1b {fig['k1b_ms']:.4f} "
              f"ms (SDPA backward {fig['sdpa_bwd_ms']:.4f}); card vs CPU rel_l2 features "
              f"{rel['features']:.4g}, state {rel['state']:.4g} (tol {VIT_E2E_TOL}) on {smi}",
              flush=True)
        del model, opt, vis, word, state, target
        torch.cuda.empty_cache()
    print(f"[vit] phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)


# phase 15: the tools (tools/torch_roofline.py, torch_profile_step.py,
# torch_ssg_train_supervisor.py, torch_realdata_drill.py) on the card
TOOLS_STEPS = 3  # traced train steps of each model, after one warm-up step
ROLLUP_TOL = 0.01  # the regions' sum against the profiler events' device time
ROOFLINE_ITERS = 200  # chained batch-1 forwards, the first ROOFLINE_WARMUP untimed
ROOFLINE_WARMUP = 50
ROOFLINE_SHARE_MAX = 1.05  # bound over measured: above 1, the bound is wrong
SUPERVISED_BATCH = 8  # the supervised SSG run's first batch
SUPERVISED_MAX_OK = 4  # a child above this batch faults after epoch 1's checkpoint
# crog_tpu_torch.train_ssg with a planted fault, for the supervisor: the run
# logs its batch, and a run above MAX_OK raises torch.OutOfMemoryError as
# soon as epoch 1's last_model is written
SUPERVISED_TRAINER = """
import sys

import torch

from crog_tpu_torch import train_ssg
from crog_tpu_torch.engine import checkpoint as ckpt

MAX_OK = {max_ok}
argv = sys.argv[1:]
opts = argv[argv.index("--opts") + 1:]
batch = int([v for k, v in zip(opts[::2], opts[1::2]) if k == "batch_size"][-1])
print(f"[trainer] batch_size={{batch}}", flush=True)
save = ckpt.save_checkpoint


def save_then_fault(*args, **kw):
    path = save(*args, **kw)
    if batch > MAX_OK and kw.get("epoch") == 1:
        raise torch.OutOfMemoryError("CUDA out of memory (planted after epoch 1's last_model)")
    return path


ckpt.save_checkpoint = save_then_fault
train_ssg.main(argv)
"""


def tools_roofline(device, smi: str, argv=()):
    """(b): the batch-1 roofline of crog_multiple_r50.yaml's eval forward
    with the s2d stem on K6; the share must not pass ROOFLINE_SHARE_MAX and
    the card's FLOP count must equal the CPU's."""
    from tools import torch_roofline

    c = torch_roofline.main(["--fused-stem", "--cpu-count", "--device", str(device),
                             "--iters", str(ROOFLINE_ITERS), "--warmup",
                             str(ROOFLINE_WARMUP), *argv])
    if c["flops"] != c["cpu_flops"]:
        raise AssertionError(f"roofline FLOPs on the card {c['flops']} != on the CPU "
                             f"{c['cpu_flops']}")
    if c["share"] is not None and not c["share"] <= ROOFLINE_SHARE_MAX:
        raise AssertionError(f"roofline share {c['share']} above {ROOFLINE_SHARE_MAX}")
    return c


def _handwritten_home(group: str):
    """The regions where a CROG train step's hand-written kernel belongs:
    K1/K1b (the attention pool) and K6/K6b (the stem) in the backbone, the
    rest (K2-K4 and their backward kernels) in the decoder; the ordered
    sums of gemm.cuh in either (K6b's and K2b/K3b/K4b's)."""
    if "reduce_rows" in group:
        return ("backbone", "decoder")
    return ("backbone",) if group.startswith(("K1 ", "K1b", "K6")) else ("decoder",)


def check_regions(r, steps: int, model: str, events_us: float):
    """The rollup's regions add up to the profiler events' device time
    within ROLLUP_TOL, and every hand-written kernel sits in its region:
    CROG's as ``_handwritten_home`` says, SSG's K5/K5b one region kernel
    each per step in ``lins`` and in ``lgrasp``."""
    from tools.torch_profile_eval import group_of
    from tools.torch_profile_step import handwritten_in

    total = sum(r.region_us().values())
    if events_us and abs(total - events_us) > ROLLUP_TOL * events_us:
        raise AssertionError(f"{model}: regions sum {total:.1f} us, profiler events "
                             f"{events_us:.1f} us")
    if r.links["flows"] == 0:
        raise AssertionError(f"{model}: the trace has no fwdbwd flows")
    found = {}
    for region in r.regions:
        for name in handwritten_in(r, region):
            found.setdefault(region, set()).add(group_of(name))
    if model == "crog":
        for region, groups in found.items():
            wrong = [g for g in groups if region not in _handwritten_home(g)]
            if wrong:
                raise AssertionError(f"crog: hand-written kernels {wrong} in {region!r}")
        want = {"K1 attention pool (attn_fwd_kernel<3>)",
                "K1b attention-pool backward (one CTA per head)",
                "K6 s2dconv (forward, dgrad)", "K6b s2dconv wgrad (cluster kernel)"}
        if not want <= found.get("backbone", set()) or not found.get("decoder"):
            raise AssertionError(f"crog: hand-written kernels by region {found}")
    else:
        if set(found) != {"lins", "lgrasp"}:
            raise AssertionError(f"ssg: hand-written kernels by region {found}")
        for region in ("lins", "lgrasp"):
            kernels = handwritten_in(r, region)
            for kern in ("lincomb_region_fwd_kernel", "lincomb_region_bwd_kernel"):
                calls = sum(c for n, (_, c) in kernels.items() if kern in n)
                if calls != steps:
                    raise AssertionError(f"ssg: {kern} x{calls} in {region!r} over "
                                         f"{steps} steps")


def tools_regions(device, smi: str, crog_batch=BATCH, ssg_batch=SSG_BATCH):
    """(a): the region rollup over TOOLS_STEPS CROG train steps (the s2d stem
    on K6/K6b) and TOOLS_STEPS SSG train steps, each held by
    ``check_regions``; prints the ``[regions]`` lines."""
    import torch

    from tools import torch_profile_eval as pe
    from tools import torch_profile_step as ps

    wrappers = launch_counts()
    for model, run in (("crog", lambda: pe.train_step(sys.modules[__name__], device,
                                                        crog_batch, "rawlb", True)),
                       ("ssg", lambda: pe.ssg_train_step(sys.modules[__name__], device,
                                                         ssg_batch, "raw")[0])):
        step = run()
        _reset(wrappers)
        trace, events_us = ps.trace_steps(step, TOOLS_STEPS, device)
        launches = _read(wrappers)
        r = ps.rollup(trace)
        batch = crog_batch if model == "crog" else ssg_batch
        ps.report(r, TOOLS_STEPS, f"{model} train batch {batch}",
                  events_us if device.type == "cuda" else None, smi, top=10)
        check_regions(r, TOOLS_STEPS, model, events_us)
        check_launches(launches, PER_STEP if model == "crog" else SSG_PER_STEP,
                       TOOLS_STEPS + 1)
        del step, trace
        if device.type == "cuda":
            torch.cuda.empty_cache()


def supervised_run(device: str, workdir: str, opts=()):
    """(c): a full-width SSG run (synthetic frames, 2 epochs, no validation)
    through tools/torch_ssg_train_supervisor.py with SUPERVISED_TRAINER:
    two launches, SUPERVISED_BATCH then half of it, the second resumed
    from epoch 1's last_model; ``opts`` override further config keys.
    Returns the children's log."""
    import os
    import re

    from tools.torch_ssg_train_supervisor import supervise

    script = os.path.join(workdir, "planted_fault_trainer.py")
    with open(script, "w") as f:
        f.write(SUPERVISED_TRAINER.format(max_ok=SUPERVISED_MAX_OK))
    log_path = os.path.join(workdir, "children.log")
    with open(log_path, "w") as log:
        rc = supervise(SSG_CONFIG, ["dataset", "synthetic", "synthetic_samples",
                                    str(SUPERVISED_BATCH), "epochs", "2", "val_freq", "3",
                                    "print_freq", "1", "output_folder", workdir,
                                    "exp_name", "supervised", *opts],
                       script=script, max_restarts=2, batch_size=SUPERVISED_BATCH,
                       device=device, log=log)
    with open(log_path) as f:
        text = f.read()
    batches = [int(b) for b in re.findall(r"\[trainer\] batch_size=(\d+)", text)]
    last = os.path.join(workdir, "supervised", "last_model")
    resumed = re.findall(r"=> resumed from '([^']+)' \(epoch (\d+)\)", text)
    print(f"[tools] supervisor: rc {rc}, launches at batch {batches}, resumed "
          f"{resumed}, planted faults {text.count('OutOfMemoryError: CUDA out of memory')}",
          flush=True)
    if (rc != 0 or batches != [SUPERVISED_BATCH, SUPERVISED_BATCH // 2]
            or resumed != [(last, "1")] or "OutOfMemoryError" not in text):
        raise AssertionError(f"supervised run: rc {rc}, batches {batches}, resumed "
                             f"{resumed}; log tail:\n{text[-3000:]}")
    return text


def tools_phase(device, smi: str):
    """Phase 15: (b) the roofline, (a) the region rollup, (c) the
    supervisor, (d) the real-data drill's fixture."""
    import tempfile

    from tools import torch_realdata_drill

    t_phase = t0 = time.perf_counter()
    took = {}

    def lap(part):
        nonlocal t0
        took[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    tools_roofline(device, smi)  # timed before this phase's profiler runs
    lap("roofline")
    tools_regions(device, smi)
    lap("regions")
    with tempfile.TemporaryDirectory() as tmp:
        supervised_run(str(device), tmp)
    lap("supervisor")
    table = torch_realdata_drill.main(["--fixture", "--device", str(device), "--opts",
                                       "batch_size_val", str(BATCH), "workers_val", "2"])
    lap("drill")
    print(f"[tools] drill fixture table {table}; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s ({took} s) on {smi}", flush=True)


def ptxas_entries(text: str):
    """(kernel, registers, spill-store bytes) for each entry function of an
    ``nvcc -Xptxas -v`` report."""
    import re

    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def redesigned_resources(reports):
    """The build's registers and spills of the redesigned kernels (the
    attention forward's one- and two-pass kernels that K1, K2 and K3 run,
    K4's and K4b's cluster kernels and their y / dx GEMM, K2b's and K3b's
    dX and dW GEMMs, K1b's one-CTA-per-head kernel, the two-kernel
    attention backward that K2b and K3b run, K6's persistent conv, K6b's
    cluster kernel, the wgmma GEMM of K2-f32, K3-f32, K4-f32 and K4b-f32 and,
    with a gathered A, of K6-f32 and K6b-f32, the fp32 attention forward of
    K1-f32, K2-f32 and K3-f32, K5's and K5b's region kernels), and at the main
    path's
    shapes their registers, shared memory per CTA (static + dynamic) and
    spills as the runtime loads them (the attention forward, the GEMMs and
    K5/K5b also their CTAs per SM, the cluster kernels the clusters of
    their launch the card holds at once)."""
    import ctypes

    from crog_tpu_torch.ops import cuda_build

    from crog_tpu_torch.ops import attention as A

    for lib, keys in (("attention", ("attn_fwd_kernel", "attn_fwd_wide_kernel")),
                      ("ffn", ("ffn_fwd_hidden_kernel", "ffn_out_kernel")),
                      ("ffn_bwd", ("ffn_bwd_hidden_kernel", "ffn_out_kernel")),
                      ("decoder_blocks", ("proj_gemm_kernel", "outproj_ln_cluster_kernel",
                                          "ln_pos_kernel")),
                      ("decoder_blocks_bwd", ("gemm_nn_kernel", "wgrad_kernel", "ln_post_bwd",
                                              "ln_pre_bwd")),
                      ("attention_bwd", ("attn_bwd_head_kernel", "attn_bwd_rows_kernel",
                                         "attn_bwd_cols_kernel", "attn_bwd_rows_wide",
                                         "attn_bwd_cols_wide")),
                      ("s2dconv", ("s2dconv_fwd_kernel", "s2dconv_wgrad_kernel")),
                      ("s2dconv_f32", ("gemm_wgmma_f32",)),
                      ("ffn_f32", ("gemm_wgmma_f32",)), ("ffn_bwd_f32", ("gemm_wgmma_f32",)),
                      ("attention_f32", ("attn_fwd_f32",)),
                      ("attention_bwd_f32", ("attn_bwd_f32_stats", "attn_bwd_f32_main")),
                      ("decoder_blocks_f32", ("gemm_wgmma_f32", "attn_fwd_f32", "ln_")),
                      ("decoder_blocks_bwd_f32", ("ln_post_bwd", "ln_pre_bwd")),
                      ("lincomb", ("lincomb_region",))):
        for entry, regs, spill in ptxas_entries(reports[lib]):
            if any(k in entry for k in keys):
                print(f"[build] ptxas {entry}: {regs} registers, {spill} bytes spill stores",
                      flush=True)
    out = (ctypes.c_int * 8)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    lib = cuda_build.load("attention")
    for lk, who, dh in ((169, "K1", 64), (676, "K2", 64), (17, "K3", 64),
                        *((lk, f"{who} at head dim {dh}", dh) for dh in HEAD_DIMS
                          for lk, who in ((676, "K2"), (17, "K3")))):
        cuda_build.check_launch(lib, lib.crog_attention_fwd_attrs(lk, dh, ptr), "attrs")
        path = "one_pass" if out[0] else "two_pass"
        print(f"[build] attention forward at {who}'s {lk} keys: {path} kernel ({out[0]} key "
              f"tiles in registers, head tile {A.head_tile(dh)}), {out[1]} registers, {out[2]} "
              f"bytes shared memory per CTA, {out[3]} bytes local (spill) per thread, {out[4]} "
              f"CTAs per SM", flush=True)
        if path != A.fwd_path(lk, dh):
            raise AssertionError(f"the card takes the {path} kernel at {lk} keys, head dim "
                                 f"{dh}, ops/attention.py:fwd_path says {A.fwd_path(lk, dh)}")
    for lib_name, entry, kid, out_name in (("ffn", "crog_ffn_fwd_attrs", "K4", "y"),
                                           ("ffn_bwd", "crog_ffn_bwd_attrs", "K4b", "dx")):
        lib = cuda_build.load(lib_name)
        cuda_build.check_launch(lib, getattr(lib, entry)(ptr), "attrs")
        print(f"[build] {kid} cluster kernel (8 CTAs of 256 hidden columns, 128 rows): "
              f"{out[0]} registers, {out[1]} bytes shared memory per CTA, {out[2]} bytes "
              f"local (spill) per thread, {out[3]} clusters resident at once", flush=True)
        print(f"[build] {kid} {out_name} kernel (ffn_out_kernel, 128 x 256 tiles): {out[4]} "
              f"registers, {out[5]} bytes shared memory per CTA, {out[6]} bytes local (spill) "
              f"per thread, {out[7]} CTAs per SM", flush=True)
    lib = cuda_build.load("decoder_blocks")
    for d in (512, WIDE_D):
        cuda_build.check_launch(lib, lib.crog_decoder_fwd_attrs(d, ptr), "attrs")
        if d == 512:
            print(f"[build] K2/K3 proj_gemm (q/k/v projections, 128 x 256 tiles, K-major "
                  f"in_proj_weight; any D): {out[0]} registers, {out[1]} bytes shared memory per "
                  f"CTA, {out[2]} bytes local (spill) per thread, {out[3]} CTAs per SM",
                  flush=True)
        print(f"[build] K2/K3 outproj_ln_cluster at D {d} ({d // 256} CTAs of 256 columns, 128 "
              f"rows): {out[4]} registers, {out[5]} bytes shared memory per CTA, {out[6]} bytes "
              f"local (spill) per thread, {out[7]} clusters resident at once", flush=True)
    lib = cuda_build.load("decoder_blocks_bwd")
    cuda_build.check_launch(lib, lib.crog_decoder_bwd_attrs(ptr), "attrs")
    for i, name in enumerate(("gemm_nn (three dX products fused, 128 x 128 tiles)",
                              "wgrad (128 x 256 tiles of a row chunk)")):
        print(f"[build] K2b/K3b {name}: {out[4 * i]} registers, {out[4 * i + 1]} bytes "
              f"shared memory per CTA, {out[4 * i + 2]} bytes local (spill) per thread, "
              f"{out[4 * i + 3]} CTAs per SM", flush=True)
    lib = cuda_build.load("attention_bwd")
    cuda_build.check_launch(lib, lib.crog_attention_bwd_head_attrs(169, ptr), "attrs")
    print(f"[build] K1b one-CTA-per-head kernel at 169 tokens: {out[0]} registers, {out[1]} "
          f"bytes shared memory per CTA, {out[2]} bytes local (spill) per thread", flush=True)
    for dh in (64, *HEAD_DIMS):
        cuda_build.check_launch(lib, lib.crog_attention_bwd_attrs(1, dh, ptr), "attrs")
        for i, name in enumerate(("rows", "cols")):
            print(f"[build] K2b/K3b attention backward at head dim {dh}, {name} kernel (bf16 "
                  f"cast points, head tile {A.head_tile(dh)}): {out[3 * i]} registers, "
                  f"{out[3 * i + 1]} bytes shared memory per CTA, {out[3 * i + 2]} bytes "
                  f"local (spill) per thread", flush=True)
    for dh in (64, *HEAD_DIMS):  # the C mirror of bwd_path's head-kernel choice
        for l in (1, 169, 256, 257):
            takes = bool(lib.crog_attention_bwd_head_takes(l, dh))
            if takes != (A.bwd_path(l, dh=dh) == "head"):
                raise AssertionError(f"crog_attention_bwd_head_takes({l}, {dh}) = {takes}, "
                                     f"ops/attention.py:bwd_path says {A.bwd_path(l, dh=dh)}")
    from crog_tpu_torch.ops import lincomb as LC

    lib = cuda_build.load("lincomb")
    fwd, bwd = LC.region_plan(136, 136, LC.FWD_PIXELS), LC.region_plan(136, 136, LC.BWD_PIXELS)
    cuda_build.check_launch(lib, lib.crog_lincomb_attrs(100, *fwd, *bwd, ptr), "attrs")
    for i, (kid, (rh, rw)) in enumerate((("K5", fwd), ("K5b", bwd))):
        print(f"[build] {kid} region kernel at 136^2 ({rh} x {rw} pixel regions, 100 "
              f"anchors): {out[4 * i]} registers, {out[4 * i + 1]} bytes shared memory per "
              f"CTA, {out[4 * i + 2]} bytes local (spill) per thread, {out[4 * i + 3]} CTAs "
              f"per SM", flush=True)
    lib = cuda_build.load("s2dconv")
    for ci in (32, 64):
        cuda_build.check_launch(lib, lib.crog_s2dconv_fwd_attrs(ci, ptr), "attrs")
        print(f"[build] K6 persistent kernel ci={ci}: {out[0]} registers, {out[1]} bytes "
              f"shared memory per CTA, {out[2]} bytes local (spill) per thread", flush=True)
    for ci, co in ((32, 32), (32, 64)):
        cuda_build.check_launch(lib, lib.crog_s2dconv_wgrad_attrs(ci, co, ptr), "attrs")
        print(f"[build] K6b cluster kernel ci={ci} co={co}: {out[0]} registers, {out[1]} bytes "
              f"shared memory per CTA, {out[2]} bytes local (spill) per thread, {out[3]} "
              f"clusters resident at once", flush=True)
    lib = cuda_build.load("s2dconv_f32")
    for ci in (32, 64):
        cuda_build.check_launch(lib, lib.crog_s2dconv_f32_attrs(ci, ptr), "attrs")
        for i, (kid, policy) in enumerate((("K6-f32", "S2dPatch"), ("K6b-f32", "S2dPatchT"))):
            print(f"[build] {kid} kernel ci={ci} (gemm_wgmma_f32_kernel with the {policy} "
                  f"A policy: the patch gathered by shifted TMA boxes of x, masked in "
                  f"registers): {out[3 * i]} registers, {out[3 * i + 1]} bytes shared memory "
                  f"per CTA, {out[3 * i + 2]} bytes local (spill) per thread", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 and 16 only: build, hold every kernel against its "
                         "twin, time it; no main path and no result line")
    ap.add_argument("--tools", action="store_true",
                    help="phases 1, 2 and 15 only: build, then the tools on the card; "
                         "no result line")
    ap.add_argument("--remat", action="store_true",
                    help="phases 1, 2 and 17 only: build, then remat off / full / selective "
                         "on the card; no result line")
    ap.add_argument("--fp32", action="store_true",
                    help="phases 1, 2 and 18 only: build, then compute_dtype float32 on the "
                         "card; no result line")
    ap.add_argument("--long", action="store_true",
                    help="phases 1, 2 and 19 only: build, then CROG at input_size 640 (1600 "
                         "decoder tokens) on the card; no result line")
    ap.add_argument("--heads", action="store_true",
                    help="phases 1, 2 and 20 only: build, then CROG at num_head 16, 4, 2 and 1 "
                         "(head dims 32, 128, 256, 512) and the attention kernels at head dims "
                         "8-512 "
                         "on the card; no result line")
    ap.add_argument("--wide", action="store_true",
                    help="phases 1, 2 and 21 only: build, then CROG on the CLIP RN50x64 "
                         "backbone (decoder width 1024) and K2-K4b at D 1024 on the card; "
                         "no result line")
    ap.add_argument("--ddp-worker", metavar="DIR",
                    help="run one rank of phase 13 (started by phase 13 itself)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.ddp_worker:
        return ddp_worker(args.ddp_worker)
    from crog_tpu_torch import native
    from crog_tpu_torch.engine.crog_engine import set_exact_fp32_matmul
    from crog_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    set_exact_fp32_matmul()
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    print(f"[build] {len(reports)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    hostops = native.build()
    print(f"[build] host ops {hostops.name} (g++ {' '.join(native.CXX_FLAGS)}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "Performance Loss" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)
    redesigned_resources(reports)

    if args.tools:
        tools_phase(device, smi)
        print(f"[done] tools only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.remat:
        remat_phase(device, remat_batch(), smi)
        print(f"[done] remat only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.fp32:
        fp32_phase(device, fp32_batch(), prepared_train_batches(), smi)
        print_device_times()
        print(f"[done] fp32 only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.long:
        long_phase(device, smi)
        print_device_times()
        print(f"[done] long only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.heads:
        heads_phase(device, smi)
        print_device_times()
        print(f"[done] heads only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.wide:
        wide_phase(device, smi)
        print_device_times()
        print(f"[done] wide only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    records = check_kernels(device)
    if args.kernels:
        print_device_times()
        print(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    cfg, model, batches = build_model_and_data(device)
    eval_step, eval_launches = main_path(device, cfg, model, batches)
    e2e_agreement(model, batches[0], cfg)
    fwd_ms, eval_rate = timings(model, eval_step, batches[0], cfg, smi)
    del model, eval_step
    torch.cuda.empty_cache()
    launches, train_rate, train_batches, train_cfg, step = train_path(device, smi)
    wire_phase(step, smi)
    del step
    torch.cuda.empty_cache()
    stem_timings(device, smi)
    e2e_train_step(train_batches[0], device)
    torch.cuda.empty_cache()
    remat_phase(device, train_batches[0], smi)
    torch.cuda.empty_cache()
    fp32_records = fp32_phase(device, batches[0], train_batches, smi)
    torch.cuda.empty_cache()
    long_phase(device, smi)
    torch.cuda.empty_cache()
    heads_phase(device, smi)
    torch.cuda.empty_cache()
    wide_records = wide_phase(device, smi)
    torch.cuda.empty_cache()
    ssg_launches, ssg_train_rate, ssg_model, ssg_cfg, ssg_batches = ssg_train_path(device,
                                                                                  smi)
    ssg_eval_rate = ssg_eval_path(device, ssg_model, ssg_cfg, smi)
    del ssg_model
    torch.cuda.empty_cache()
    ssg_train_step_gap(device)
    ssg_unpack_check(device)
    reader_runs, reader_rates = reader_phase(device, smi)
    ddp_phase(device, train_batches, ssg_batches, smi)
    vit_phase(device, smi)
    tools_phase(device, smi)
    print_device_times()
    # each kernel's launches on the main path that runs it: CROG training
    # for K1-K4b and K6/K6b, SSG training for K5/K5b
    for n, rec in records.items():
        rec["launches"] = ssg_launches[n] if n in SSG_PER_STEP else launches[n]
    # the fp32 kernels' launches on the fp32 train path (phase 18), the D
    # 1024 rows' on phase 21's train paths
    records.update(fp32_records)
    records.update(wide_records)
    print(f"[done] {time.perf_counter() - t_start:.1f} s; CROG train {train_rate:.2f} "
          f"and eval {eval_rate:.2f} samples/s at batch {BATCH}; SSG train "
          f"{ssg_train_rate:.2f} samples/s at batch {SSG_BATCH}, eval {ssg_eval_rate:.2f} "
          f"samples/s; from the OCID tree: CROG eval {reader_runs['warm'][0][0]:.2f} (warm) "
          f"and train {reader_rates['threads'][0][0]:.2f} samples/s", flush=True)

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
