#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught but an ``sdpa``
backend's refusal of a shape, which its timing records as null):

1. Environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for the f32 comparisons; every CUDA kernel of the
   port built from ``eventpretrain_tpu_torch/csrc`` (one nvcc per source, all
   at once) and, beside them, the C++ host code of
   ``eventpretrain_tpu_torch/native`` (g++, timed), each kernel's registers
   and spills printed, and no GEMM
   instantiation, row kernel (csrc/ln_bwd.cu) or splat kernel (csrc/splat.cu,
   splat_tiled.cu) or K8 (csrc/voxel_scatter.cu) allowed to spill; each
   splat launch plan of the main paths (K3's at 128x128x5 and at the raw
   pretrain path's 224x224x5) with the clusters of it the card holds at
   once (cudaOccupancyMaxActiveClusters), and K8's resident CTAs.
2. Kernel parity on the card, each kernel against its plain PyTorch version
   on the same inputs: the splat (K3) on both routes, each call on the one
   ``splat_route`` names: the cluster route at B=64, E=30000, 128x128x5
   and at B=64, E=30300, 224x224x5 (the raw pretrain path's) and
   224x224x2 (the ECDP count image's 2 polarity weights), the global
   route at B=8 of that shape and at DSEC's 440x640x5 (B=2, 200000
   events), strays past every edge; the tiled splat (K6) at B=2 of
   DSEC's shape, both entry points, with and without bin ranges, and the
   2-bin count image with and without bin ranges, on bucketed events with
   hand-placed strays; the LN
   attention (K1) and LN MLP (K2) sub-blocks in bf16 at (8, 196, 384),
   (8, 196, 768) and the ECDP step's (64, 51, 384), 12 heads; the bare attention layer (K4) at (8, 196, 384)
   and (8, 196, 768), 12 heads, and the bare MLP (K5) at (8, 196, 384) and
   (8, 196, 512); their backward kernels with the same ``dy`` at K1
   (8, 49, 768) H=12, (8, 196, 512) H=16, (8, 196, 384) H=12,
   (8, 196, 768) H=12, (64, 51, 384) H=12, K2 (8, 49, 768),
   (8, 196, 512), (8, 196, 384), (8, 196, 768), (64, 51, 384), K4 C=384,
   768 and K5 C=384, 512; their GEMM alone
   (csrc/ln_gemm.cu) against its plain version ``gemm_reference``: every
   launch of K1/K4 at (64, 196, 384), K2/K5 at (64, 196, 512) and K2 at
   (64, 49, 768), forward and backward, and every layout and epilogue at a
   ragged M or token count, each weight gradient run twice and equal bit
   for bit, and the LayerNorm rows those GEMMs read (``ln_rows``) against
   ``ln_forward``; the row and column reductions of the K1/K2/K4/K5
   backward alone (``ln_backward`` against ``ln_backward_reference`` at
   (12544, 384), (12544, 512), (3136, 768), (3001, 64), (3001, 768),
   (12544, 768), and
   ``colsum`` against the f32 column sum at N = C, 3C, 4C of each; dx and
   the bias sums within one bf16 step + 1e-5 of scale, dgamma and dbeta
   1e-4 of scale, each equal bit for bit on a repeat; ``ln_rows`` again at
   those shapes); the attention core of K1/K4
   alone (``_attention``, ``_attention_bwd``) against the plain attention
   core at (64, 196, H12, D32), (64, 49, H12, D64), (64, 196, H16, D32),
   (16, 196, H12, D64), ragged (4, 100, H16, D8) and (2, 17, H1, D128), and
   the gate's corners at L=256 (forward D=192, both directions D=160), the
   backward run twice and equal bit for bit; K7 (``fused_mha``) forward
   and backward, bf16, at (8, 196, H16, D32), (8, 196, H12, D32),
   (8, 49, H12, D64), (2, 1024, H4, D256), (4, 100, H3, D24),
   (2, 77, H3, D20), the route boundaries (4, 256, H4, D64) and
   (2, 257, H4, D64), the shared-memory corner (2, 256, H4, D192) (its
   forward one-pass, its backward tiled) and contiguous q, k, v at
   (8, 196, H16, D32), each direction on the route ``mha_route`` names,
   the backward through autograd equal bit for bit to ``fused_mha_bwd``;
   K8 (``voxelize_batch_scatter``) at B=8, E=30000,
   128x128x5 with strays, negative fractions, counts 0 and 1 and a hot
   pixel (10% of a sample's events, its sums exact), against its plain
   version and K3's ``voxelize_batch``, through the wrapper and into a
   grid filled with NaN first (the kernel writes every cell).
3. Slice 1, serving: the ViT-S/16 classification hub (2 classes, N-Cars),
   full width, random weights from seed 0, bf16 on the card, fed synthetic
   raw N-Cars-shaped events (sensor 100x120 on a 128x128 canvas, E=30000,
   B=8) through ``make_cls_infer``. Launch counts are read from this one
   run; the logits are held against the unfused plain path and an f32 run.
4. Serving: ``make_server`` on an ephemeral port, POST /predict at batch 1,
   8 and 64 plus GET /healthz, each answer against a direct call.
5. Slice 2, stage-1 rec training: ``pretrain_hub_base`` (ViT-B/16 encoder
   on the 49 kept patches, the C=512 decoder on all 196), full width, bf16
   compute with f32 parameters, random weights from seed 0, B=64 batches of
   ``SyntheticPretrainSource(size=224)`` through ``PretrainPipeline``; 10
   ``make_rec_step`` steps on the kernel path (launch counts read from this
   run) and 10 on the plain path from the same init and the same replayed
   masks, both loss curves and their gap; then ``cli.pretrain.main`` for
   one epoch (4 steps).
5b. Slice 2b, cls finetuning: ``cls_hub_vit_small`` at full width with
   drop-path 0.1, bf16, seed 0; ``SyntheticClsSource`` streams of N-Cars
   shape (30000 events, sensor 100x120) through ``ClsPipeline(train=True)``
   at B=64 with the u32 codec; 10 ``make_cls_train_step`` steps on the
   kernel path (pipeline and steps in one counted run: per step K3 1,
   K1/K2 1+1, K4 11+11, K5 0) and 10 on the plain path with the same
   batches and replayed drop-path masks; one ``make_cls_eval_step`` (K1/K2
   12 each) and one attention-map forward (K5 1, K1/K2 11 each), each
   counted on its own, its logits (and the attention weights) against the
   plain bf16 path and an f32 run;
   ``cli.finetune_cls.main`` for one epoch of ViT-S, and of ViT-B with
   ``--finetune`` from phase 5's rec checkpoint.
5c. Slice 3, dense semantic segmentation at DSEC's shape:
   ``dense_hub_vit_small`` at full width (11 classes, ignore label 255,
   drop-path 0.1, the heads' dropout 0.1), bf16, seed 0;
   ``SyntheticDenseSource`` streams (sensor 440x640, 200000 events, labels
   at 440x640) through ``DensePipeline(train=True)`` at B=16 with the u32
   codec and ``tiled_raster="auto"`` (host tile bucketing, K6); 10
   ``make_semseg_train_step`` steps on the kernel path (pipeline and steps
   in one counted run: per step K6 1, K3 0, K1/K2 1+1, K4 11+11) and 10 on
   the plain path (unfused blocks, K6's plain version on the same wire
   data) with the same replayed drop-path and dropout masks; one
   ``make_semseg_eval_step`` (K6 1, K1/K2 12) and its confusion counts
   against the plain path's; ``cli.finetune_semseg.main`` for one epoch.
5e. Slice 3b, optical flow at MVSEC's shape: ``dense_hub_vit_small``
   with 2 outputs at full width (drop-path 0.1, the heads' dropout 0.1),
   bf16, seed 0; ``SyntheticDenseSource("flow")`` streams (sensor
   260x346, 30000 events, flow and validity at 260x346) through
   ``DensePipeline(train=True)`` at B=16 with the u32 codec and
   ``tiled_raster="auto"`` (the C++ tile bucketer, K6 on 3x3 tiles whose
   last row and column are partial); 4 ``make_flow_train_step`` steps with
   the flow CLI's optimizer (pipeline and steps in one counted run: per
   step K6 1, K3 0, K1/K2 1+1, K4 11+11), finite losses and grad norms;
   K6 on the first batch's wire data against its plain version, over the
   whole grid and over the partial tiles, and the batch rebuilt with K6's
   plain version; the step's ms on a fixed batch; one
   ``make_flow_eval_step`` (K6 1, K1/K2 12) over a nonempty mask;
   ``python -m eventpretrain_tpu_torch.cli.finetune_flow --backbone vit
   --dataset synthetic`` for one epoch.
5f. The host half: the C++ host code loaded (never forced to numpy), and
   the host build ms per batch of the cls (B=64), DSEC semseg (B=16) and
   MVSEC flow (B=16) pipelines with it and with the numpy specifications
   (``native.BACKEND = "numpy-forced"``), the median of 3 batches each;
   recorded, not gated.
5g. Slice 4a, the contrastive stages on precomputed CLIP token
   embeddings: ``pretrain_hub_base`` with its projection heads (width
   4096) at full width, bf16, seed 0, filled from phase 5's rec checkpoint
   as ``--init_from`` fills it; B=64 batches of
   ``SyntheticPretrainSource(size=224)`` with its 197x512 ``clip_emb``
   through ``PretrainPipeline``. A frozen trunk block under enabled
   gradients: K1/K2 forward, no saved tensor. Stage 2: 10 ``adj`` steps
   (the trunk frozen but its norm_layer; per step K1/K2 12+12 forward, 0
   backward), every frozen parameter unchanged bit for bit; stage 3: 10
   ``con`` steps from stage 2's weights, global InfoNCE (K1/K2 12+12 both
   ways); each on the kernel path and the plain path from the same init
   and batches, both loss curves and their gap (2%); 2 ``con`` steps
   against the queue at the CLI's default length 65536 (a 39.5 GB buffer),
   its losses, pointer and peak memory; 4 ``rec+con`` steps with replayed
   masks on both paths (K1/K2 32+32 both ways: 12 at L=49, 8 of the
   decoder, 12 at (196, 768)); ``cli.pretrain.main`` for one epoch of
   ``adj`` from phase 5's checkpoint, then one of ``con`` from adj's.
5h. Slice 4b-ii, stages 2 and 3 with CLIP in the loop on raw events:
   the hub of phase 5g (from phase 5's rec checkpoint), fed by
   ``SyntheticRawPretrainSource`` at N-ImageNet's sensor (480x640, 60000
   events: windows of 30000, the C++ erase-and-add, rescaled to 224)
   through ``RawPretrainPipeline`` at B=64 with the u32 codec (K3 on the
   224x224x5 canvas, its cluster route), wrapped in
   ``ClipEncodingPipeline`` with ``clip_vit_b16`` in bf16 from seed 0.
   Stage 2: 10 ``adj-n`` steps, pipeline and steps in one counted run (per
   step K3 1, K1/K2 12+12 forward, 0 backward), and 10 on the plain path
   on the same batches, both loss curves and their gap (2%); every frozen
   trunk parameter (on both paths) and every CLIP tensor unchanged bit for
   bit. CLIP's (64, 197, 512) output against an f32 tower with the same
   weights on the first batch's images (``CLIP_BF16_REL_TOL``); K3 on the
   first batch's wire data against its plain version (1e-4). Stage 3: 10
   ``con-n`` steps from stage 2's weights the same way (K3 1, K1/K2 12+12
   both ways). ``cli.pretrain.main`` for one epoch of ``adj-n`` from phase
   5's checkpoint, then one of ``con-n`` from adj-n's; no CLIP tensor in
   either checkpoint.
5i. Slice 5a, the ConvViT backbone (conv stages on cuDNN, channels-last,
   under 11 ViT blocks that take the kernels), and slice 4b-i, gradient
   accumulation: ``pretrain_hub_convvit_base`` (depths 2, 2, 11, widths
   256, 384, 768, the base decoder) at full width, bf16, seed 0, B=64 of
   phase 5's rec batches with their replayed masks: 10 rec steps on the
   kernel path (K1/K2 19 + 19 a step: 11 encoder blocks at (64, 49, 768),
   8 decoder blocks at (64, 196, 512)) and 10 on the plain path, the loss
   gap (2%), the step's ms and peak memory on both paths and a profiled
   step's busy share; one rec step of the first batch against four
   microsteps of its B=16 quarters under ``accum_steps`` 4 from the same
   init (no parameter moves in microsteps 1-3, the quarters' mean loss
   within 2% of the whole batch's, the mean gradient within
   ``ACCUM_GRAD_REL``, the update within 2 lr with its sign equal on
   ``ACCUM_SIGN_SHARE`` of the components); ConvViT-S (widths 128, 256,
   384) with drop-path 0.1 (all 11 ViT blocks take K4), 3 steps each of
   cls at B=64 (K3 1, K4 11 + 11 a step), semseg at DSEC's 440x640 and
   flow at MVSEC's 260x346 at B=16 (K6 1, K4 11 + 11), pipeline and steps
   counted, replayed drop-path (28 masks a step, the conv blocks' first)
   and dropout masks, against the plain path on the same batches (2% at
   each step; flow at its first, its later losses finite), their step ms
   on both paths; each task's eval step counted on its own (K3 or K6 1,
   K1/K2 11 each) against the plain path's on the same weights (2%; the
   semseg decode head's logits); then
   ``cli.pretrain.main --backbone convvit`` for ``rec`` and ``con`` from
   its checkpoint (ConvViT-B, 4 steps each), ``cli.finetune_cls.main
   --backbone convvit --accum_iter 2`` (2 microsteps of 64, one update),
   and ``cli.finetune_semseg.main`` and ``cli.finetune_flow.main`` with no
   ``--backbone`` flag (their default, ConvViT-S).
5j. Slice 5b, the sparse Swin-T (widths 96, 192, 384, 768, depths 2, 2,
   6, 2, window 7) on the visible tokens under host plans:
   ``pretrain_hub_swin`` at full width, bf16, seed 0, B=64 of phase 5's
   rec batches (their ViT masks unused: the Swin step draws one mask a
   batch from its schedule, 24 of 49 cells of 32 pixels kept at ratio
   0.5, 1536 of 3136 stage-1 tokens): 4 ``make_swin_rec_step`` steps on
   the kernel path (K1/K2 8 + 8 a step, the Swin decoder's (64, 49, 256)
   H8 blocks) and 4 on the plain path with the same schedule, the loss gap
   (2%); the plan's handoff (one upload a planned step, every index tensor
   a view of one tensor on the card), the host's planning ms, the step's
   ms and peak memory on both paths and a profiled step's busy share and
   host-to-device copies; 4 ``rec+con`` steps on the synthetic 197x512
   CLIP tokens through the conv projection on both paths (K1/K2 8 + 8),
   then 4 ``adj`` (frozen parameters unchanged bit for bit) and 4 ``con``
   steps, no kernel on their path; Swin-T with drop-path 0.1 (22 replayed
   masks a step), 3 steps each of cls at B=64 (K3 1), semseg at DSEC's
   440x640 and flow at MVSEC's 260x346 at B=16 (K6 1; no kernel in the
   step, so one path, timed), and each task's eval step (K3 or K6 1, K5
   6: stage 3's MLPs) against the plain path's; then
   ``cli.pretrain.main --backbone swin`` for ``rec`` (4 steps) and
   ``con-n`` from its checkpoint (4 steps on the synthetic raw source, K3
   1 a step, the CLIP tower in the loop), ``cli.finetune_cls.main
   --backbone swin --finetune`` from the rec checkpoint, and
   ``cli.finetune_semseg.main`` and ``cli.finetune_flow.main`` with
   ``--backbone swin``.
5k. Slice 5c, the ECDP baseline: ViT-S ECDP (two learned tokens, two
   views masked to 49 of 196 patches, 51 tokens a block, the heads 4096
   wide) at B=64, bf16, seed 0 on the synthetic 2-channel grids with
   replayed masks: 4 ``make_ecdp_step`` steps on the kernel path
   (counted: K1/K2 24 + 24 forward and 12 + 12 backward a step, the EMA
   key encoder's 12 blocks forward only), the plain path and the plain
   path in f32; the loss gap of the first 3 (two on the initial weights,
   one after the first real update) held at 2%, every step's loss within
   2% of the f32 path's, step 0's whole gradient no further from the f32
   path's than 1.25 times the plain bf16 path's; before them the query
   backbone alone under a fixed random cotangent (K1/K2 12 + 12 both ways
   at L=51), its gradients within 5e-2 of the plain path's and within
   1.25 times its distance from f32; the key path alone (K1/K2 12 + 12,
   no backward); 4 steps against the two 65536-key queues; 4 on the raw
   path (``EcdpRawPretrainPipeline`` at N-ImageNet's sensor, K3 2 a
   batch on 224x224x2, its cluster route, phase 5h's CLIP tower in the
   loop for the class token); 4 ConvViT-S ECDP steps (K1/K2 22 + 22
   forward, 11 + 11 backward); ViT-ECDP-S semseg at DSEC's 440x640 and
   flow at MVSEC's 260x346, B=16, ``--num_bins 2`` (K6 1 on the tiled
   count image, K1/K2 1 + 1 and K4 11 + 11 a step, 22 replayed drop-path
   masks) for 3 steps each against the plain path, and each eval step
   (K6 1, K1/K2 12) against the plain path's; then
   ``cli.pretrain.main --pr_phase ecdp``
   (4 steps, counted), ``cli.finetune_cls.main --backbone vit_ecdp
   --num_bins 2 --finetune`` from its checkpoint and
   ``cli.finetune_semseg.main --backbone vit_ecdp --num_bins 2``.
5l. Slice 5d, every on-disk reader and the MEM count image: fixture
   trees of the six other cls sources (``data/cls_sources.py``) written
   at their true sensors (N-Caltech101 and UCF101-DVS 180x240, CIFAR10-DVS
   and DVS128 128x128, N-ImageNet 480x640 with a robustness variant root,
   ES-ImageNet's 254x254 files cropped to 224x224 by their label file),
   128 train and 64 val samples of 30000 events in 2 classes (DVS128's
   directories '2' and '10'); ``cli.finetune_cls.main`` (ViT-S, bf16,
   B=64, 2 steps and one eval) on each: N-ImageNet at 5 bins (rescaled,
   K3 on 224x224x5, its variant evaluated and printed), CIFAR10-DVS at 2
   bins (rescaled, 224x224x2) and 5 (128x128x5), N-Caltech101 at 3 (the
   MEM image: K3 on 180x240x2), ES-ImageNet, DVS128 and UCF101-DVS at 5,
   each run counted: K3 one a batch on the route ``splat_route`` names,
   K4 11 + 11 a step, the losses finite. Then 2 semseg steps of the ViT-S
   dense hub (B=16, drop-path and the heads' dropout replayed) over
   ``DensePipeline`` on synthetic streams at DDD17's 200x346 (80000
   events, 6 classes, K6 on 2x3 tiles, the last row and column partial)
   and at DSEC's 440x640 with ``--num_bins 3`` (the MEM image: K6 on the
   2 count planes), each against the plain path rebuilt from the same
   wire data with K6's plain version (the first loss within 2%; K6 1,
   K1/K2 1 + 1, K4 11 + 11 a step); the whole MEM representation with a
   hot pixel through K3 (B=64 on 180x240, ragged sensor boxes) and K6
   (B=2 on 440x640) against the plain path's; K3 at (64, 5, 30300) on
   180x240x5 and (64, 2, 30300) on 180x240x2, and K6 on the two dense
   paths' first wire batches (200x346x5 with bin ranges, 440x640x2
   without), each held against its plain version and timed, one call an
   event pair and from a CUDA graph of 10 calls, beside ``index_put_``
   (these rows join phase 6's K3 and K6 rows).
5d. Slice 3c, the kernels no CLI reaches, each through its entry point:
   ``Attention(512, 16, use_fused_kernel=True)``, bf16, seed 0, forward
   and backward at (64, 196, 512) with ``fused=False`` (K7 1 + 1 on the
   one-pass route, K4 0), output and gradients against the plain product;
   ``voxelize_batch_scatter`` on a DSEC-shape batch (B=16, 200000 events,
   440x640x5, a hot pixel; K8 1) against its plain version and K3, and
   again into a grid of NaN. Then one epoch of
   the cls loop (B=64, 6 batches) and of the semseg loop (B=16, 4 batches)
   through ``train_one_epoch`` and its prefetcher, counted, beside the same
   loop in the training thread: delivered samples/s of both.
6. Timing (CUDA events, median of 20 after warm-up; plain, kernel, kernel,
   plain): each kernel, first held against its plain version at the main
   path's batch (B=64) as in phase 2, then timed beside it with its bound
   (and, for K4, one ``F.multi_head_attention_forward`` call), and under
   each K1/K2/K4/K5 row its GEMM launches at the row's first shape, each
   timed from a CUDA graph of 10 calls beside one ``torch.matmul`` in the
   same layout, with its bound (the ``gemms`` sub-table); the
   attention core of K1/K4 alone, forward and backward, at its four
   main-path shapes, and K7 at the decoder's, ViT-S's and the ViT-B
   encoder's attention shapes at B=64 (10 calls per event pair), each
   beside ``F.scaled_dot_product_attention`` on the same q, k, v by
   default and under each ``sdpa_kernel`` backend that takes the shape,
   with each of their kernels' registers and spills; the served
   function's samples/s at B=64; K8 at DSEC's and N-Cars' shapes
   beside K3's ``voxelize_batch``; K6 also at MVSEC's shape on the first
   flow batch's wire data; K3, K6 and K8 also from CUDA graphs of
   10 calls (the card alone); K1/K2 also at the contrastive stages'
   (64, 196, 768) H12, ConvViT-S rec's encoder (64, 49, 384) H12 and
   decoder (64, 196, 256) H8, Swin-T rec's decoder (64, 49, 256) H8 and
   the ECDP step's (64, 51, 384) H12, forward and backward, beside
   ``sdpa``; K4 also at ConvViT-S's dense (16, 196, 384) H12; K3 also at
   the raw pretrain path's (64, 5, 30300) on 224x224x5 and the ECDP raw
   path's (64, 2, 30300) on 224x224x2; the rec and
   cls train steps' ms, samples/s and peak memory on both paths (and the
   semseg step's at B=16, the adj, con, rec+con, adj-n and con-n steps' at
   B=64, 5 steps a turn; the flow step's from phase 5e; the ConvViT
   steps' and the accumulation check's from phase 5i; the Swin steps'
   from phase 5j; the ECDP steps' from phase 5k), CLIP's device ms
   a batch, the cls, dense and raw pretrain pipelines' host time per
   batch, phase 5f's host builds and phase 5d's delivered
   samples/s; ``ln_backward``, ``colsum`` and ``ln_rows`` at
   each main-path shape (the dense ViT-B's (12544, 768) among them) from
   CUDA graphs beside their plain versions, their
   bounds and ``torch.sum`` / ``F.layer_norm``, their launches on every
   main path checked against those of the sub-blocks that call them; then
   a ``torch.profiler`` window over each kernel path (a con-n step with
   its CLIP encode among them) for its device time by kernel (the GEMM's by layout, the row kernels' with their launches) and
   busy share.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the end-to-end record, the attention core's record, the card's name
and power limit and the per-kernel JSON record.
"""

from __future__ import annotations

import copy
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

NUM_CLASSES = 2
SENSOR_HW = (100, 120)  # N-Cars
CANVAS = (128, 128)
NUM_BINS = 5
EVENTS = 30000
DEPTH = 12
REPS = 20
# slice 2: pretrain_hub_base at the CLI's batch; 12 encoder + 8 decoder
# blocks, each one K1 and one K2 call forward and backward per step
TRAIN_BATCH = 64
TRAIN_INPUT = 224
TRAIN_STEPS = 10
TRAIN_BLOCKS = 12 + 8
# the ECDP step's masked ViT-S: 2 learned tokens before 49 of 196 patches
ECDP_TOKENS = 2 + 49
# slice 3: the dense hub at DSEC's shape (sensor, events per sample, the
# semseg CLI's batch)
DSEC_HW = (440, 640)
DSEC_EVENTS = 200_000
DENSE_BATCH = 16
# the card's published peaks (H100 SXM data sheet, dense): bf16 tensor
# cores and device-memory bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def make_events(rng: np.random.Generator, batch: int, sensor_hw=SENSOR_HW,
                capacity: int = EVENTS, out_of_frame: bool = False):
    """Synthetic raw events: integer xy on the sensor, sorted t in seconds,
    polarity in {0, 1}, ragged counts, rows past the count zero-padded."""
    h, w = sensor_hw
    ev = np.zeros((batch, capacity, 4), np.float32)
    counts = rng.integers(capacity // 2, capacity + 1, batch).astype(np.int32)
    counts[0] = capacity
    lo, hi = (-8, 8) if out_of_frame else (0, 0)
    for b in range(batch):
        n = counts[b]
        ev[b, :n, 0] = rng.integers(lo, w + hi, n)
        ev[b, :n, 1] = rng.integers(lo, h + hi, n)
        ev[b, :n, 2] = np.sort(rng.uniform(0.0, 0.1, n))
        ev[b, :n, 3] = rng.integers(0, 2, n)
    sensor = np.tile(np.asarray(sensor_hw, np.int32), (batch, 1))
    return ev, counts, sensor


def cuda_ms(fn, reps: int = REPS, warmup: int = 3, calls: int = 1) -> float:
    """Median device ms of ``fn`` over ``reps`` event pairs, each around
    ``calls`` calls in a row (divided by ``calls``): with more than one,
    the host enqueues the next call while the card runs the last, so a
    kernel shorter than its wrapper's host work is timed alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, reps: int = REPS) -> float:
    """Median device ms of one call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls: the card's time alone, without the wrapper's host work
    (a GEMM's wrapper takes tens of microseconds of host time, as long as
    the smaller products themselves)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    try:
        return cuda_ms(graph.replay, reps=reps) / calls
    finally:
        del graph


def host_ms(fn, reps: int = REPS, warmup: int = 3) -> list[float]:
    """Host-clock times (ms) of ``reps`` synchronised calls, sorted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------- phase 1


def phase_environment() -> str:
    from eventpretrain_tpu_torch import _build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the C++ host code builds beside the kernels
    from eventpretrain_tpu_torch import native

    host = {}

    def build_host():
        t = time.perf_counter()
        try:
            host["lib"] = native.library()
        except RuntimeError as e:
            host["error"] = e
        host["s"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    host_thread.join()
    if "error" in host:
        raise host["error"]
    log(f"host code: {os.path.basename(host['lib']._name)} built and "
        f"loaded in {host['s']:.1f} s by "
        f"{native._compiler_version().splitlines()[0]}")
    for name, text in sorted(logs.items()):
        PTXAS.update(_build.ptxas_usage(name, text))
        for line in text.splitlines():
            if "error" in line:
                log(f"  [{name}] {line.strip()}")
    for kernel, use in sorted(PTXAS.items()):
        log(f"  ptxas {kernel}: {use['registers']} registers, "
            f"{use['stack_frame']} B stack frame, {use['spill_stores']} B "
            f"spill stores, {use['spill_loads']} B spill loads, "
            f"{use['static_smem']} B static shared memory")
    if "ln_gemm" in logs:
        # the GEMM's dynamic shared memory (its operand ring) is set at
        # launch: csrc/ln_gemm.cu SMEM_BYTES, 6 x 32 KB + 1 KB of alignment
        gemm = {k: u for k, u in PTXAS.items() if k.startswith("ln_gemm:")}
        require(any("gemm_kernel" in k for k in gemm),
                "ptxas reported no GEMM kernel")
        for kernel, use in gemm.items():
            require(use["spill_stores"] == use["spill_loads"] == 0,
                    f"{kernel} spills ({use})")
    if "ln_bwd" in logs:
        # the LayerNorm backward holds a row of d_yln and dy and its
        # column sums in registers, at the 128 a thread of 2 blocks an SM
        rows = {k: u for k, u in PTXAS.items() if k.startswith("ln_bwd:")}
        require(any("ln_bwd_kernel<12>" in k for k in rows),
                "ptxas reported no LayerNorm backward at C=768")
        for kernel, use in rows.items():
            require(use["spill_stores"] == use["spill_loads"] == 0,
                    f"{kernel} spills ({use})")
    for source in ("splat", "splat_tiled"):
        if source in logs:
            # the splats' plane body (csrc/splat_core.cuh) keeps its sums in
            # shared memory; neither source's kernels may spill
            found = {k: u for k, u in PTXAS.items()
                     if k.startswith(source + ":")}
            require(f"{source}:splat_cluster_kernel" in found,
                    f"ptxas reported no plane body in {source}.cu")
            for kernel, use in found.items():
                require(use["spill_stores"] == use["spill_loads"] == 0,
                        f"{kernel} spills ({use})")
    if "voxel_scatter" in logs:
        # K8 keeps an event's terms in registers; it may not spill
        found = {k: u for k, u in PTXAS.items()
                 if k.startswith("voxel_scatter:")}
        require("voxel_scatter:voxel_scatter_kernel" in found,
                "ptxas reported no K8 kernel")
        for kernel, use in found.items():
            require(use["spill_stores"] == use["spill_loads"] == 0,
                    f"{kernel} spills ({use})")
    log_splat_clusters()
    from eventpretrain_tpu_torch.ops.splat import voxel_scatter_device

    l2_bytes, sms, per_sm = voxel_scatter_device(0)
    log(f"  K8: {per_sm} CTAs an SM resident at once ({sms} SMs; the plan "
        f"launches one an SM); L2 {l2_bytes} B")
    require(per_sm >= 1, "no CTA of K8 fits an SM")
    return smi


def log_splat_clusters() -> None:
    """Each splat launch plan of the main paths, with the clusters of it
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    from eventpretrain_tpu_torch.ops.splat import (
        max_active_clusters,
        splat_plan,
    )
    from eventpretrain_tpu_torch.ops.splat_tiled import splat_tiled_plan

    for what, lib, plan in (
            (f"K3 {CANVAS[0]}x{CANVAS[1]}x{NUM_BINS}", "splat",
             splat_plan(*CANVAS, NUM_BINS)),
            (f"K3 {TRAIN_INPUT}x{TRAIN_INPUT}x{NUM_BINS} (raw pretrain)",
             "splat", splat_plan(TRAIN_INPUT, TRAIN_INPUT, NUM_BINS)),
            (f"K6 128x128x{NUM_BINS} tile", "splat_tiled",
             splat_tiled_plan(128, 128, NUM_BINS)),
            ("K6 128x128x2 tile (count image)", "splat_tiled",
             splat_tiled_plan(128, 128, 2))):
        n = max_active_clusters(lib, plan.cluster, plan.smem_bytes, 0)
        log(f"  {what}: {plan.cluster} CTAs of {plan.cp} channels, "
            f"{plan.smem_bytes} B shared memory each; {n} clusters "
            "resident at once")
        require(n >= 1, f"no cluster of the {what} plan fits the card")


PTXAS = {}  # "source:kernel" -> registers and spills (ptxas -v)


# ---------------------------------------------------------------- phase 2


def _subblock_inputs(gen, b, l, c, dev):
    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    return dict(
        x=rnd(b, l, c),
        ln_w=(1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        ln_b=(0.1 * torch.randn(c, generator=gen)).to(dev),
        std=c ** -0.5,
        rnd=rnd,
    )


def k1_args(gen, b, l, c, dev):
    a = _subblock_inputs(gen, b, l, c, dev)
    rnd, std = a["rnd"], a["std"]
    return (a["x"], a["ln_w"], a["ln_b"], rnd(3 * c, c, std=std),
            rnd(3 * c, std=0.1), rnd(c, c, std=std), rnd(c, std=0.1))


def k2_args(gen, b, l, c, dev):
    a = _subblock_inputs(gen, b, l, c, dev)
    rnd, std = a["rnd"], a["std"]
    return (a["x"], a["ln_w"], a["ln_b"], rnd(4 * c, c, std=std),
            rnd(4 * c, std=0.1), rnd(c, 4 * c, std=(4 * c) ** -0.5),
            rnd(c, std=0.1))


def k4_args(gen, b, l, c, dev):
    """K1's inputs without the LayerNorm parameters."""
    a = k1_args(gen, b, l, c, dev)
    return (a[0],) + a[3:]


def k5_args(gen, b, l, c, dev):
    a = k2_args(gen, b, l, c, dev)
    return (a[0],) + a[3:]


def splat_args(rng, batch, dev, grid_hw=CANVAS, capacity=EVENTS,
               ecdp: bool = False):
    """K3's operands from synthetic events with strays past every edge:
    the voxel grid's ``NUM_BINS`` bilinear weights, or with ``ecdp`` the
    count image's 2 polarity weights, zeroed past each count."""
    from eventpretrain_tpu_torch.ops.events import (
        _polarity_weights,
        bilinear_bin_weights,
    )

    ev, counts, _ = make_events(rng, batch, sensor_hw=grid_hw,
                                capacity=capacity, out_of_frame=True)
    ev = torch.from_numpy(ev).to(dev)
    counts = torch.from_numpy(counts).to(dev)
    x = ev[..., 0].to(torch.int32).contiguous()
    y = ev[..., 1].to(torch.int32).contiguous()
    wb = (_polarity_weights(ev, counts) if ecdp
          else bilinear_bin_weights(ev, counts, NUM_BINS).transpose(1, 2))
    return y, x, wb.contiguous()


def dsec_tiled_inputs(rng, batch: int, dev) -> dict:
    """Bucketed events of DSEC's shape as the dense pipeline ships them (the
    numpy bucketer's u32 words, decoded on the card), with strays placed by
    hand: rows 440-511 (inside the last tile row, past H), columns past W,
    negative columns (the codec's sentinel), and in each sample's first
    chunk, which belongs to tile 0, coordinates of another tile. None of
    them may add anything. Also random weights ``w`` for every slot, pads
    included, for the splat entry."""
    from eventpretrain_tpu_torch.data.codec import decode_events_u32
    from eventpretrain_tpu_torch.native import (
        TILE_CHUNK,
        bucket_pack_event_batch_u32,
    )

    h, w = DSEC_HW
    cap = DSEC_EVENTS + DSEC_EVENTS // 100
    ev = np.zeros((batch, cap, 4), np.float32)
    counts = rng.integers(cap // 2, cap + 1, batch).astype(np.int32)
    counts[0] = cap
    for b in range(batch):
        n = counts[b]
        ev[b, :n, 0] = rng.integers(0, w, n)
        ev[b, :n, 1] = rng.integers(0, h, n)
        ev[b, :n, 2] = np.sort(rng.uniform(0.0, 0.05, n))
        ev[b, :n, 3] = rng.integers(0, 2, n)
        k = n // 100
        ev[b, :k, 1] = rng.integers(h, 512, k)
        ev[b, k:2 * k, 0] = rng.integers(w, w + 64, k)
        ev[b, 2 * k:3 * k, 0] = rng.integers(-8, 0, k)
    enc, table, t_range, chunk_tr = bucket_pack_event_batch_u32(
        ev, counts, height=h, width=w)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    events = decode_events_u32(t(enc.view(np.int32)), t(t_range))
    events[:, :TILE_CHUNK, 0] = w - 1
    events[:, :TILE_CHUNK, 1] = h - 1
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    return dict(
        events=events, table=t(table), t_range=t(t_range),
        chunk_trange=t(chunk_tr),
        y=events[..., 1].to(torch.int32).contiguous(),
        x=events[..., 0].to(torch.int32).contiguous(),
        w=torch.randn((batch, NUM_BINS, events.shape[1]),
                      generator=gen).to(dev),
    )


class plain_tiled_splat:
    """Within the block, ``voxelize_batch_tiled`` (and so the dense
    pipeline) calls K6's plain version on card tensors, and counts no
    launch: the plain path of the dense slice."""

    def __enter__(self):
        from eventpretrain_tpu_torch.ops import splat_tiled as st

        self.mod, self.kernel = st, st.splat_tiled
        st.splat_tiled = st.splat_tiled_reference
        return self

    def __exit__(self, *exc):
        self.mod.splat_tiled = self.kernel


class plain_splat:
    """Within the block, ``voxelize_batch`` (and so the cls and raw
    pretrain pipelines) calls K3's plain version on card tensors, and
    counts no launch."""

    def __enter__(self):
        from eventpretrain_tpu_torch.ops import splat as sp

        self.mod, self.kernel = sp, sp.splat
        sp.splat = sp.splat_reference
        return self

    def __exit__(self, *exc):
        self.mod.splat = self.kernel


def k6_cases(inp) -> list:
    """(name, kernel call, plain call) for both entry points of K6, with
    and without bin ranges, on ``dsec_tiled_inputs``."""
    from eventpretrain_tpu_torch.ops.splat_tiled import (
        chunk_bin_range,
        splat_tiled,
        splat_tiled_reference,
        voxelize_batch_tiled,
    )

    from eventpretrain_tpu_torch.ops.events import (
        polarity_weights_coordvalid,
    )

    hw = dict(height=DSEC_HW[0], width=DSEC_HW[1])
    br = chunk_bin_range(inp["t_range"], inp["chunk_trange"], NUM_BINS)
    # the 2-bin count image's polarity weights (one CTA a tile), and
    # random inclusive ranges over its two channels
    count_w = polarity_weights_coordvalid(inp["events"], *DSEC_HW)
    gen = torch.Generator().manual_seed(11)
    br2 = torch.randint(0, 2, br.shape, generator=gen, dtype=torch.int32)
    br2 = br2.sort(-1).values.to(br.device)
    cases = []
    for name, w, bins in (("splat_tiled", inp["w"], None),
                          ("splat_tiled+bins", inp["w"], br),
                          ("splat_tiled count image", count_w, None),
                          ("splat_tiled count image+bins", count_w, br2)):
        args = (inp["y"], inp["x"], w, inp["table"], bins)
        cases.append((name, lambda a=args: splat_tiled(*a, **hw),
                      lambda a=args: splat_tiled_reference(*a, **hw)))
    for name, ctr in (("voxelize_batch_tiled", None),
                      ("voxelize_batch_tiled+bins", inp["chunk_trange"])):
        args = (inp["events"], inp["table"], inp["t_range"], ctr)

        def plain(a=args):
            with plain_tiled_splat():
                return voxelize_batch_tiled(*a, num_bins=NUM_BINS, **hw)

        cases.append((name, lambda a=args: voxelize_batch_tiled(
            *a, num_bins=NUM_BINS, **hw), plain))
    return cases


def phase_k3_parity(dev) -> tuple[float, float]:
    """K3 against its plain version on both routes, each call on the route
    ``splat_route`` names: the cluster route at the served and cls batch
    (B=64, E=30000, the 128x128x5 canvas) and at the raw pretrain path's
    (B=64, E=30300, the 224x224x5 canvas, and the ECDP count image's
    224x224x2: 2 polarity weights zeroed past each count), the global
    route at the served B=8 and at DSEC's 440x640x5 (B=2, 200000 events),
    strays past every edge in all."""
    from eventpretrain_tpu_torch.ops.splat import (
        splat,
        splat_reference,
        splat_route,
    )

    rng = np.random.default_rng(1)
    worst = 0.0
    raw = (TRAIN_BATCH, (TRAIN_INPUT, TRAIN_INPUT), RAW_CAPACITY)
    for batch, grid_hw, capacity, ecdp in ((64, CANVAS, EVENTS, False),
                                           (8, CANVAS, EVENTS, False),
                                           (2, DSEC_HW, DSEC_EVENTS, False),
                                           (*raw, False), (*raw, True)):
        y, x, wb = splat_args(rng, batch, dev, grid_hw, capacity, ecdp)
        hw = dict(height=grid_hw[0], width=grid_hw[1])
        route = splat_route(batch, *grid_hw, wb.shape[1])
        before = dict(splat.launches_by_route)
        got, ref = splat(y, x, wb, **hw), splat_reference(y, x, wb, **hw)
        torch.cuda.synchronize()
        took = {r: n - before[r] for r, n in splat.launches_by_route.items()}
        err = (got - ref).abs().max().item()
        log(f"splat ({batch}, {wb.shape[1]}, {capacity}) -> "
            f"{tuple(got.shape)}"
            f" on the {route} route ({took}): max_abs_err {err:.3g} (tol "
            f"{SPLAT_ATOL}), sum {got.sum().item():.6g} vs "
            f"{ref.sum().item():.6g}")
        require(took[route] == 1 and sum(took.values()) == 1,
                f"splat at {grid_hw} did not take the {route} route")
        require(err <= SPLAT_ATOL,
                f"splat ({route} route) disagrees with splat_reference")
        worst = max(worst, err)
        del y, x, wb, got, ref
    return worst, SPLAT_ATOL


def phase_k6_parity(dev) -> tuple[float, float]:
    """K6 against its plain version at B=2 of DSEC's shape: the 5-bin
    grid and the 2-bin count image, with and without bin ranges."""
    inp = dsec_tiled_inputs(np.random.default_rng(9), 2, dev)
    worst = 0.0
    for name, fn, plain in k6_cases(inp):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"{name} (2, {inp['y'].shape[1]}) -> "
            f"{tuple(got.shape)}: max_abs_err {err:.3g} (tol {SPLAT_ATOL}), "
            f"sum {got.sum().item():.6g} vs {ref.sum().item():.6g}")
        require(err <= SPLAT_ATOL, f"{name} disagrees with its plain version")
        worst = max(worst, err)
    return worst, SPLAT_ATOL


# bf16 sub-blocks: the kernel and the plain version round at the same
# points, but their f32 sums run in other orders, so a bf16 rounding of qkv,
# p, o or h can land one ulp apart and the output (|y| <~ 5, ulp 2^-6..2^-5)
# may differ by a few ulps: bound the error by 2% of the output's scale.
SUBBLOCK_REL_TOL = 2e-2
# Logits of a 12-block bf16 ViT (|logits| < 1, a bf16 ulp <= 2^-8) on the
# kernel path against the plain bf16 path: each path rounds in its own
# places, and each was within 9.8e-3 of the f32 model on the H100 (ViT-S,
# B=8 and B=64), so the two may differ by about their sum, 2e-2; bound it
# at 2.5e-2.
LOGIT_ATOL = 2.5e-2
# Attention weights lie in [0, 1], where a bf16 ulp is at most 2^-8; the
# last block's weights on the two paths differ only through its input:
# bound them at two ulps at the top of the range (read: 4.9e-4).
ATTN_WEIGHT_ATOL = 2.0 ** -7
# f32 splat: atomics add in a run-dependent order; cells hold a few unit
# weights, so f32 reordering error is ~1e-6.
SPLAT_ATOL = 1e-4


def hold(name: str, shape: list, got, want, names=("y",)
         ) -> tuple[float, float, float]:
    """Require each output of a kernel (``got``: a tensor, or a tuple of
    gradients named ``names``) within ``SUBBLOCK_REL_TOL`` of its own
    scale of the plain version's output (``want``). Returns the largest
    absolute error, the largest error over its scale and the largest
    absolute tolerance."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    require(len(got) == len(want) == len(names),
            f"{name}: {len(got)} outputs, expected {len(names)}")
    torch.cuda.synchronize()
    worst_abs = worst_rel = worst_tol = 0.0
    for g, w, gname in zip(got, want, names):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()),
                f"{name} {gname} at {shape} non-finite")
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        rel = err / max(scale, 1e-30)
        require(rel <= SUBBLOCK_REL_TOL,
                f"{name} {gname} at {shape} off by {rel:.3g} of its scale "
                f"(tol {SUBBLOCK_REL_TOL})")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        worst_tol = max(worst_tol, SUBBLOCK_REL_TOL * scale)
    log(f"{name} {shape} bf16: worst error {worst_rel:.3g} of its scale "
        f"(tol {SUBBLOCK_REL_TOL}), max_abs_err {worst_abs:.4g}")
    return worst_abs, worst_rel, worst_tol


def phase_kernel_parity(dev) -> dict:
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_attn_layer,
        fused_attn_layer_reference,
        fused_ln_attn_layer,
        fused_ln_attn_layer_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp,
        fused_ln_mlp_reference,
        fused_mlp,
        fused_mlp_reference,
    )
    errs = {"splat": phase_k3_parity(dev),
            "splat_tiled": phase_k6_parity(dev)}

    gen = torch.Generator().manual_seed(2)
    for c in (384, 768):
        heads, scale = 12, (c // 12) ** -0.5
        cases = (
            ("fused_ln_attn_layer", fused_ln_attn_layer,
             fused_ln_attn_layer_reference, k1_args(gen, 8, 196, c, dev),
             dict(num_heads=heads, scale=scale)),
            ("fused_ln_mlp", fused_ln_mlp, fused_ln_mlp_reference,
             k2_args(gen, 8, 196, c, dev), {}),
        )
        for name, fn, plain, args, kw in cases:
            err, _, tol = hold(name, [8, 196, c], fn(*args, **kw),
                               plain(*args, **kw))
            if c == 384:
                errs[name] = (err, tol)
    # K1/K2 at the ECDP step's masked ViT-S: 2 tokens and 49 of 196
    # patches (L = 51, not a multiple of 16), at its batch
    for name, fn, plain, args, kw in (
            ("fused_ln_attn_layer", fused_ln_attn_layer,
             fused_ln_attn_layer_reference,
             k1_args(gen, TRAIN_BATCH, ECDP_TOKENS, 384, dev),
             dict(num_heads=12, scale=32 ** -0.5)),
            ("fused_ln_mlp", fused_ln_mlp, fused_ln_mlp_reference,
             k2_args(gen, TRAIN_BATCH, ECDP_TOKENS, 384, dev), {})):
        err, _, tol = hold(name, [TRAIN_BATCH, ECDP_TOKENS, 384],
                           fn(*args, **kw), plain(*args, **kw))
        errs[name] = (max(errs[name][0], err), max(errs[name][1], tol))
    # K4 at the cls train step's widths (ViT-S, ViT-B), K5 at ViT-S and the
    # widest C its gate takes
    for name, fn, plain, make, shapes in (
            ("fused_attn_layer", fused_attn_layer, fused_attn_layer_reference,
             k4_args, ((384, 12), (768, 12))),
            ("fused_mlp", fused_mlp, fused_mlp_reference, k5_args,
             ((384, 0), (512, 0)))):
        for c, h in shapes:
            args = make(gen, 8, 196, c, dev)
            kw = dict(num_heads=h, scale=(c // h) ** -0.5) if h else {}
            err, _, tol = hold(name, [8, 196, c], fn(*args, **kw),
                               plain(*args, **kw))
            prev = errs.get(name, (0.0, 0.0))
            errs[name] = (max(prev[0], err), max(prev[1], tol))
    errs.update(phase_backward_parity(dev))
    errs["gemm"] = phase_gemm_parity(dev)
    errs.update(phase_rows_parity(dev))
    errs.update(phase_core_parity(dev))
    errs.update(phase_k7_parity(dev))
    errs["voxelize_batch_scatter"] = phase_k8_parity(dev)
    return errs


GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw_in", "db_in", "dw_out", "db_out")
BARE_GRAD_NAMES = ("dx", "dw_in", "db_in", "dw_out", "db_out")


def phase_backward_parity(dev) -> dict:
    """K1, K2, K4 and K5 backward kernels against their plain backward
    versions, bf16, the same ``dy``. Both round at the same points (do, p,
    ds, dq, dk, dv, dh_pre, dx, and every weight gradient once), but their
    f32 sums run in other orders, so a rounded value may land one bf16 ulp apart;
    the weight gradients, sums of such values over B*L tokens, move by a
    few ulps of their scale. Each gradient is bounded at 2% of its own
    scale, as the forward outputs are."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_attn_layer_bwd,
        fused_attn_layer_bwd_reference,
        fused_ln_attn_layer_bwd,
        fused_ln_attn_layer_bwd_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp_bwd,
        fused_ln_mlp_bwd_reference,
        fused_mlp_bwd,
        fused_mlp_bwd_reference,
    )

    gen = torch.Generator().manual_seed(5)
    errs = {}
    cases = [("fused_ln_attn_layer_bwd", l, c, h, 8)
             for l, c, h in ((49, 768, 12), (196, 512, 16), (196, 384, 12),
                             (196, 768, 12))]
    cases += [("fused_ln_mlp_bwd", l, c, 0, 8)
              for l, c in ((49, 768), (196, 512), (196, 384), (196, 768))]
    # the ECDP query encoder's blocks at its batch (L = 51)
    cases += [("fused_ln_attn_layer_bwd", ECDP_TOKENS, 384, 12, TRAIN_BATCH),
              ("fused_ln_mlp_bwd", ECDP_TOKENS, 384, 0, TRAIN_BATCH)]
    cases += [("fused_attn_layer_bwd", 196, c, 12, 8) for c in (384, 768)]
    cases += [("fused_mlp_bwd", 196, c, 0, 8) for c in (384, 512)]
    for name, l, c, h, b in cases:
        kw = dict(num_heads=h, scale=(c // h) ** -0.5) if h else {}
        make, fn, plain, names, nin = {
            "fused_ln_attn_layer_bwd": (
                k1_args, fused_ln_attn_layer_bwd,
                fused_ln_attn_layer_bwd_reference, GRAD_NAMES, 6),
            "fused_ln_mlp_bwd": (k2_args, fused_ln_mlp_bwd,
                                 fused_ln_mlp_bwd_reference, GRAD_NAMES, 6),
            "fused_attn_layer_bwd": (
                k4_args, fused_attn_layer_bwd,
                fused_attn_layer_bwd_reference, BARE_GRAD_NAMES, 4),
            "fused_mlp_bwd": (k5_args, fused_mlp_bwd,
                              fused_mlp_bwd_reference, BARE_GRAD_NAMES, 4),
        }[name]
        args = make(gen, b, l, c, dev)
        dy = (torch.randn((b, l, c), generator=gen)).to(dev, torch.bfloat16)
        worst_abs, worst, _ = hold(
            name, [b, l, c] + ([h] if h else []), fn(*args, dy, **kw),
            plain(*args[:nin], dy, **kw), names)
        prev = errs.get(name, (0.0, SUBBLOCK_REL_TOL, 0.0))
        errs[name] = (max(prev[0], worst_abs), SUBBLOCK_REL_TOL,
                      max(prev[2], worst))
    return errs


# The GEMM under K1/K2/K4/K5 (csrc/ln_gemm.cu) alone, against its plain
# version (ops/common.py::gemm_reference): each launch of the sub-blocks on
# the main paths at B=64 (ViT-S C=384 for K1/K4, the decoder's C=512 for
# K2/K5, the ViT-B encoder's C=768 at L=49 for K2's weight gradients), and
# every layout and epilogue at a ragged M (forward, dgrad) or a ragged token
# count (wgrad, split and unsplit). bf16 outputs rounded at the same points
# as the plain version, f32 sums in another order: 2% of each output's scale,
# as the sub-blocks are held. Each weight gradient runs twice and must come
# out equal bit for bit.
GEMM_PARITY_BLOCKS = (("K1", 64, 196, 384), ("K4", 64, 196, 384),
                      ("K2", 64, 196, 512), ("K5", 64, 196, 512),
                      ("K2", 64, 49, 768))
GEMM_RAGGED = ((0, 3001, 384, 512), (1, 3001, 384, 512), (2, 384, 256, 3001),
               (2, 2048, 2304, 1000))
LN_ROWS_ATOL = 1e-5


def gemm_launches(kind: str, b: int, l: int, c: int, backward: bool
                  ) -> list:
    """``(name, layout, M, N, K, epilogue, gelu_out)`` of each GEMM launch
    of one sub-block call, in launch order (ops/fused_attn_layer.py,
    ops/fused_mlp.py; a weight gradient's K is its token count)."""
    from eventpretrain_tpu_torch.ops import common as cm

    f, d, w = cm.LAYOUT_FORWARD, cm.LAYOUT_DGRAD, cm.LAYOUT_WGRAD
    m, ln = b * l, kind in ("K1", "K2")
    out_epi = cm.EPI_BIAS_RESIDUAL if ln else cm.EPI_BIAS
    du_epi = cm.EPI_F32 if ln else cm.EPI_BIAS
    if kind in ("K1", "K4"):
        if not backward:
            return [("qkv", f, m, 3 * c, c, cm.EPI_BIAS, False),
                    ("proj", f, m, c, c, out_epi, False)]
        return [("dWo", w, c, c, m, cm.EPI_BIAS, False),
                ("do", d, m, c, c, cm.EPI_BIAS, False),
                ("dWqkv", w, 3 * c, c, m, cm.EPI_BIAS, False),
                ("du", d, m, c, 3 * c, du_epi, False)]
    if not backward:
        return [("fc1", f, m, 4 * c, c, cm.EPI_BIAS_GELU, False),
                ("fc2", f, m, c, 4 * c, out_epi, False)]
    return [("h_pre", f, m, 4 * c, c, cm.EPI_F32, True),
            ("dW2", w, c, 4 * c, m, cm.EPI_BIAS, False),
            ("dh_pre", d, m, 4 * c, c, cm.EPI_DGELU, False),
            ("dW1", w, 4 * c, c, m, cm.EPI_BIAS, False),
            ("du", d, m, c, 4 * c, du_epi, False)]


def gemm_case(gen, dev, layout, m, n, k, epilogue, gelu_out):
    """(kernel, plain version, torch.matmul in the same layout) on random
    operands of one launch."""
    from eventpretrain_tpu_torch.ops import common as cm

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    a = rnd(k, m) if layout == cm.LAYOUT_WGRAD else rnd(m, k)
    w = (rnd(n, k, std=k ** -0.5) if layout == cm.LAYOUT_FORWARD
         else rnd(k, n, std=k ** -0.5))
    kw = dict(bias=None if layout == cm.LAYOUT_WGRAD else rnd(n, std=0.1),
              residual=(rnd(m, n) if epilogue == cm.EPI_BIAS_RESIDUAL
                        else None),
              aux=(rnd(m, n, dtype=torch.float32)
                   if epilogue == cm.EPI_DGELU else None),
              gelu_out=gelu_out)
    chunk = None
    if layout == cm.LAYOUT_WGRAD:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, chunk = cm.plan_wgrad_split(m, n, k, sms)
        chunk = chunk if splits > 1 else None

    def fn():
        return cm._gemm(a, w, m=m, n=n, k=k, layout=layout,
                        epilogue=epilogue, **kw)

    def plain():
        return cm.gemm_reference(a, w, layout=layout, epilogue=epilogue,
                                 chunk=chunk, **kw)

    def matmul():
        if layout == cm.LAYOUT_FORWARD:
            return a @ w.t()
        return a.t() @ w if layout == cm.LAYOUT_WGRAD else a @ w

    return fn, plain, matmul


def gemm_work(layout, m, n, k, epilogue, gelu_out) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: A and B in, bias, residual and aux in
    where the epilogue reads them, out (and the GELU out) written once."""
    from eventpretrain_tpu_torch.ops import common as cm

    nbytes = 2 * (m * k + k * n) + m * n * (
        4 if epilogue == cm.EPI_F32 else 2)
    nbytes += 2 * n if layout != cm.LAYOUT_WGRAD else 0
    nbytes += 2 * m * n if epilogue == cm.EPI_BIAS_RESIDUAL else 0
    nbytes += 4 * m * n if epilogue == cm.EPI_DGELU else 0
    nbytes += 2 * m * n if gelu_out else 0
    return 2.0 * m * n * k, nbytes


def phase_gemm_parity(dev) -> tuple[float, float, float]:
    """The GEMM against its plain version (see above) and the LayerNorm
    rows K1's and K2's GEMMs read (``ln_rows``) against their plain twin
    ``ln_forward``: the same f32 statistics summed in another order, so a
    value may round to the neighbouring bf16 (one step of the rounded
    value), and a value near zero, where x - mean cancels, may move by the
    statistics' last f32 bits (bounded at 1e-5; the rows are O(1)).
    Returns the largest absolute error, the tolerance (of each output's
    scale) and the largest error over its scale."""
    from eventpretrain_tpu_torch.ops import common as cm

    gen = torch.Generator().manual_seed(9)
    cases = {}
    for kind, b, l, c in GEMM_PARITY_BLOCKS:
        for backward in (False, True):
            for _, *key in gemm_launches(kind, b, l, c, backward):
                cases[tuple(key)] = "main path"
    for layout, m, n, k in GEMM_RAGGED:
        epis = ([(cm.EPI_BIAS, False)] if layout == cm.LAYOUT_WGRAD else
                [(e, False) for e in range(5)] + [(cm.EPI_F32, True)] * (
                    layout == cm.LAYOUT_FORWARD))
        for e, go in epis:
            cases[(layout, m, n, k, e, go)] = "ragged"
    worst_abs = worst_rel = 0.0
    for (layout, m, n, k, epi, go), what in cases.items():
        fn, plain, _ = gemm_case(gen, dev, layout, m, n, k, epi, go)
        got = fn()
        shape = [layout, m, n, k, epi] + (["gelu_out"] if go else [])
        err, rel, _ = hold(f"gemm ({what})", shape, got, plain(),
                           ("out", "gelu_out") if go else ("out",))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if layout == cm.LAYOUT_WGRAD:
            require(torch.equal(fn(), got),
                    f"gemm wgrad {shape} differs from itself on a repeat")
    log(f"gemm: {len(cases)} launches held, each weight gradient equal bit "
        f"for bit on a repeat")
    for b, l, c in ((64, 196, 384), (64, 49, 768), (64, 196, 512)):
        a = _subblock_inputs(gen, b, l, c, dev)
        x2 = a["x"].view(b * l, c)
        got = cm.ln_rows(x2, a["ln_w"], a["ln_b"], 1e-6)
        want = cm.ln_forward(x2, a["ln_w"], a["ln_b"], 1e-6)
        # one bf16 step at |want| = m 2^e (0.5 <= m < 1) is 2^(e - 8)
        step = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                           torch.frexp(want.float()).exponent - 8)
        diff = (got.float() - want.float()).abs()
        require(bool((diff <= step + LN_ROWS_ATOL).all()),
                f"ln_rows ({b * l}, {c}) more than one bf16 step from "
                f"ln_forward (max {diff.max().item():.3g})")
        log(f"ln_rows ({b * l}, {c}): {(diff == 0).float().mean().item():.4%}"
            f" equal to ln_forward, the rest within one bf16 step "
            f"(+{LN_ROWS_ATOL})")
    return worst_abs, SUBBLOCK_REL_TOL, worst_rel


# The row and column reductions under the K1/K2/K4/K5 backward
# (csrc/ln_bwd.cu) alone, against their plain versions: ``ln_backward`` at
# the main paths' LayerNorm rows at B=64 (ViT-S and the dense hub's block
# 0, the MAE decoder, the ViT-B encoder's kept tokens), a ragged M and the
# narrowest and widest C its gate admits; ``colsum`` at N = C, 3C and 4C of
# each (dbo and db2, dbqkv, db1). dx and the bias sums are rounded once
# from f32 values computed in another order: each within one bf16 step of
# the plain value, plus 1e-5 of the output's scale near zero, where those
# f32 values cancel; dgamma and dbeta, f32 sums of the same values in
# another order, within 1e-4 of their scale. Each output must come out
# equal bit for bit on a repeat.
ROW_SHAPES = ((12544, 384), (12544, 512), (3136, 768), (3001, 64),
              (3001, 768), (12544, 768))
ROW_SLACK = 1e-5
ROW_SUM_REL_TOL = 1e-4


def bf16_step_err(got, want) -> tuple[float, float]:
    """(largest absolute error, largest error over the allowed one: one
    bf16 step of the plain value plus ``ROW_SLACK`` of its scale)."""
    got, want = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    err = (got - want).abs()
    allowed = step + ROW_SLACK * want.abs().max()
    return err.max().item(), (err / allowed).max().item()


def phase_rows_parity(dev) -> dict:
    """``ln_backward`` and ``colsum`` against ``ln_backward_reference`` and
    the f32 column sum rounded once, and ``ln_rows`` against
    ``ln_forward`` (see above). Returns each kernel's largest absolute
    error and its tolerance's description."""
    from eventpretrain_tpu_torch.ops import common as cm

    gen = torch.Generator().manual_seed(13)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    worst = {"ln_backward": 0.0, "colsum": 0.0, "ln_rows": 0.0}
    for m, c in ROW_SHAPES:
        x, dy, d_yln = rnd(m, c), rnd(m, c), rnd(m, c, dtype=torch.float32)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        # the LayerNorm rows of the same x, as phase_gemm_parity holds them
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        yln, want = cm.ln_rows(x, g, b, 1e-6), cm.ln_forward(x, g, b, 1e-6)
        step = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                           torch.frexp(want.float()).exponent - 8)
        diff = (yln.float() - want.float()).abs()
        require(bool((diff <= step + LN_ROWS_ATOL).all()),
                f"ln_rows ({m}, {c}) more than one bf16 step from "
                f"ln_forward (max {diff.max().item():.3g})")
        worst["ln_rows"] = max(worst["ln_rows"], diff.max().item())
        got = cm.ln_backward(x, g, 1e-6, dy, d_yln)
        again = cm.ln_backward(x, g, 1e-6, dy, d_yln)
        want = cm.ln_backward_reference(x, g, 1e-6, dy, d_yln)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(t).all()) for t in got),
                f"ln_backward ({m}, {c}) non-finite")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"ln_backward ({m}, {c}) differs from itself on a repeat")
        err, over = bf16_step_err(got[0], want[0])
        require(over <= 1.0, f"ln_backward ({m}, {c}) dx more than one bf16 "
                             f"step (+{ROW_SLACK} of scale) from the plain "
                             f"dx (max {err:.3g})")
        rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(got[1:], want[1:]))
        require(rel <= ROW_SUM_REL_TOL,
                f"ln_backward ({m}, {c}) dgamma/dbeta off by {rel:.3g} of "
                f"their scale (tol {ROW_SUM_REL_TOL})")
        worst["ln_backward"] = max(worst["ln_backward"], err, *(
            (a - b).abs().max().item() for a, b in zip(got[1:], want[1:])))
        log(f"ln_backward ({m}, {c}): dx within {over:.3g} of one bf16 step "
            f"(max_abs_err {err:.3g}), dgamma/dbeta {rel:.3g} of scale (tol "
            f"{ROW_SUM_REL_TOL}), equal on a repeat")
        for n in (c, 3 * c, 4 * c):
            t = rnd(m, n)
            got, again = cm.colsum(t), cm.colsum(t)
            want = t.float().sum(0).to(torch.bfloat16)
            require(torch.equal(got, again),
                    f"colsum ({m}, {n}) differs from itself on a repeat")
            err, over = bf16_step_err(got, want)
            require(over <= 1.0, f"colsum ({m}, {n}) more than one bf16 step "
                                 f"(+{ROW_SLACK} of scale) from the plain sum"
                                 f" (max {err:.3g})")
            worst["colsum"] = max(worst["colsum"], err)
            log(f"colsum ({m}, {n}): within {over:.3g} of one bf16 step "
                f"(max_abs_err {err:.3g}), equal on a repeat")
    return {
        "ln_backward": (worst["ln_backward"],
                        f"dx one bf16 step + {ROW_SLACK} of scale; dgamma, "
                        f"dbeta {ROW_SUM_REL_TOL} of scale"),
        "colsum": (worst["colsum"],
                   f"one bf16 step + {ROW_SLACK} of scale"),
        "ln_rows": (worst["ln_rows"], f"one bf16 step + {LN_ROWS_ATOL}"),
    }


# The attention core of K1/K4 alone (csrc/attention.cu, attention_bwd.cu),
# (B, L, H, D): ViT-S at the cls step's batch, the ViT-B encoder's kept
# tokens, the MAE decoder, the dense ViT-B at the semseg batch; ragged L at
# widths the gate admits; the gate's corners at L=256: the largest head_dim
# of the forward's gate (192; the backward's gate is closed there) and of
# the backward's (160)
CORE_MAIN_SHAPES = ((64, 196, 12, 32), (64, 49, 12, 64), (64, 196, 16, 32),
                    (16, 196, 12, 64))
CORE_PARITY_SHAPES = CORE_MAIN_SHAPES + ((4, 100, 16, 8), (2, 17, 1, 128),
                                         (2, 256, 2, 192), (2, 256, 4, 160))
CORE_FWD_ONLY = ((2, 256, 2, 192),)


def core_args(gen, b, l, h, d, dev):
    """Packed (B*L, 3C) bf16 qkv rows, as the qkv GEMM writes them, and the
    head outputs' gradient (B*L, C)."""
    c = h * d
    qkv = torch.randn((b * l, 3 * c), generator=gen).to(dev, torch.bfloat16)
    do = torch.randn((b * l, c), generator=gen).to(dev, torch.bfloat16)
    return qkv, do


def phase_core_parity(dev) -> dict:
    """``_attention`` and ``_attention_bwd`` alone against the plain
    attention core, bf16: o, and dq, dk, dv each within 2% of its scale
    (both round p, o, ds and the gradients at the same points; their f32
    sums run in other orders). Each shape must lie inside the gate (the
    backward's too, but at the forward's corner); the backward runs twice
    and must repeat bit for bit (no atomics)."""
    from eventpretrain_tpu_torch.ops import fused_attn_layer as ka

    gen = torch.Generator().manual_seed(15)
    fwd, bwd = (0.0, 0.0), (0.0, SUBBLOCK_REL_TOL, 0.0)
    for b, l, h, d in CORE_PARITY_SHAPES:
        c, scale = h * d, d ** -0.5
        backward = (b, l, h, d) not in CORE_FWD_ONLY
        require(ka.supports_fused_attn_layer(l, c, h, torch.bfloat16),
                f"attention core {(b, l, h, d)} outside the forward gate")
        require(ka.supports_fused_attn_layer(l, c, h, torch.bfloat16, True)
                == backward, f"attention core {(b, l, h, d)}: backward gate")
        qkv, do = core_args(gen, b, l, h, d, dev)
        shape = [b, l, h, d]
        err, _, tol = hold("attention_core", shape,
                           ka._attention(qkv, b, l, h, scale),
                           ka.attention_core_reference(qkv, b, l, h, scale))
        fwd = (max(fwd[0], err), max(fwd[1], tol))
        if not backward:
            continue
        got = ka._attention_bwd(qkv, do, b, l, h, scale)
        again = ka._attention_bwd(qkv, do, b, l, h, scale)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"attention_core_bwd {shape} does not repeat bit for bit")
        want = ka.attention_core_bwd_reference(qkv, do, b, l, h, scale)
        err, rel, _ = hold("attention_core_bwd", shape, got.split(c, -1),
                           want.split(c, -1), K7_GRAD_NAMES)
        bwd = (max(bwd[0], err), SUBBLOCK_REL_TOL, max(bwd[2], rel))
        log(f"attention_core_bwd {shape}: two runs equal bit for bit")
    return {"attention_core": fwd, "attention_core_bwd": bwd}


# K7 at the MAE decoder's heads (decoder.py:101), ViT-S, the ViT-B
# encoder's kept tokens, the gate's corner, a ragged L with a head_dim that
# is not a multiple of 16, and one whose rows the kernel cannot read 16
# bytes at a time (D % 8 != 0); then the routes' boundaries: the longest L
# of the one-pass route and the shortest of the tiled one, the shared-memory
# corner where the forward is one-pass and the backward tiled, and
# contiguous separate q, k, v: (B, L, H, D, packed)
K7_PARITY_SHAPES = ((8, 196, 16, 32, True), (8, 196, 12, 32, True),
                    (8, 49, 12, 64, True), (2, 1024, 4, 256, True),
                    (4, 100, 3, 24, True), (2, 77, 3, 20, True),
                    (4, 256, 4, 64, True), (2, 257, 4, 64, True),
                    (2, 256, 4, 192, True), (8, 196, 16, 32, False))
K7_GRAD_NAMES = ("dq", "dk", "dv")


def k7_args(gen, b, l, h, d, dev, packed=True):
    """q, k, v as the strided slices of one packed (B, L, 3, H, D) bf16
    tensor, as ``Attention`` hands them over (or, unless ``packed``, three
    contiguous tensors), and a ``dy``."""
    if packed:
        qkv = torch.randn((b, l, 3, h, d), generator=gen).to(dev,
                                                              torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn((b, l, h, d), generator=gen).to(
            dev, torch.bfloat16) for _ in range(3))
    dy = torch.randn((b, l, h, d), generator=gen).to(dev, torch.bfloat16)
    return q, k, v, dy


def phase_k7_parity(dev) -> dict:
    """K7 forward and backward (the same ``dy``) against their plain
    versions in bf16. Both round p, o, ds, dq, dk and dv at the same points;
    their f32 sums run in other orders (and the tiled forward's row sum of
    exp is taken online), so a rounded value may land one bf16 ulp apart:
    each output within 2% of its scale, as K1/K4. The forward and the
    backward each take the route ``mha_route`` names (read from the
    per-route counts); the backward runs through autograd, from the
    forward's saved statistics, and again through ``fused_mha_bwd``, and the
    two must be equal bit for bit."""
    from eventpretrain_tpu_torch.ops.fused_mha import (
        fused_mha,
        fused_mha_bwd,
        fused_mha_bwd_reference,
        fused_mha_reference,
        mha_route,
    )

    gen = torch.Generator().manual_seed(6)
    fwd, bwd = (0.0, 0.0), (0.0, SUBBLOCK_REL_TOL, 0.0)
    for b, l, h, d, packed in K7_PARITY_SHAPES:
        q, k, v, dy = k7_args(gen, b, l, h, d, dev, packed)
        kw = dict(scale=d ** -0.5)
        shape = [b, l, h, d]
        want = (mha_route(l, d, (q, k, v), backward=False),
                mha_route(l, d, (q, k, v, dy), backward=True))
        before = route_counts()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fused_mha(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, dy)
        counted = {k_: n - before[k_] for k_, n in route_counts().items()
                   if n > before[k_]}
        require(counted == {f"fused_mha[{want[0]}]": 1,
                            f"fused_mha_bwd[{want[1]}]": 1},
                f"fused_mha {shape}: routes counted {counted}, mha_route "
                f"names {want}")
        err, _, tol = hold("fused_mha", shape, out.detach(),
                           fused_mha_reference(q, k, v, **kw))
        fwd = (max(fwd[0], err), max(fwd[1], tol))
        again = fused_mha_bwd(q, k, v, dy, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(g, a) for g, a in zip(grads, again)),
                f"fused_mha_bwd {shape} does not repeat bit for bit")
        err, rel, _ = hold("fused_mha_bwd", shape, grads,
                           fused_mha_bwd_reference(q, k, v, dy, **kw),
                           K7_GRAD_NAMES)
        bwd = (max(bwd[0], err), SUBBLOCK_REL_TOL, max(bwd[2], rel))
        log(f"fused_mha {shape} {'packed' if packed else 'contiguous'}: "
            f"routes {want[0]} / {want[1]}, backward repeated bit for bit")
    return {"fused_mha": fwd, "fused_mha_bwd": bwd}


def k8_events(rng, batch: int, capacity: int, sensor_hw, hot: bool = False):
    """Raw events for K8: fractional coordinates from 2 before to 2 past the
    sensor (out-of-frame strays, and negative fractions that truncate into
    row or column 0), sorted t, polarity in {0, 1}, every row filled (rows
    past a count must add nothing); ragged counts, with a 0 and a 1. With
    ``hot``, sample 3 puts 10% of its events on one pixel, to hold the
    contended adds: its times are multiples of 2^-6 from exactly 0 at the
    first event to 1 at the last of its count, so every weight is a
    multiple of 2^-4 and its sums are exact in any order; a lost or
    misplaced add shows as an error of 1/16 or more."""
    h, w = sensor_hw
    ev = np.empty((batch, capacity, 4), np.float32)
    ev[..., 0] = rng.uniform(-2.0, w + 2.0, (batch, capacity))
    ev[..., 1] = rng.uniform(-2.0, h + 2.0, (batch, capacity))
    ev[..., 2] = np.sort(rng.uniform(0.0, 0.1, (batch, capacity)), axis=1)
    ev[..., 3] = rng.integers(0, 2, (batch, capacity))
    counts = rng.integers(capacity // 2, capacity + 1, batch).astype(np.int32)
    counts[0] = capacity
    if batch >= 3:
        counts[1], counts[2] = 0, 1
    if hot and batch >= 4:
        n = counts[3]
        hits = rng.choice(n, n // 10, replace=False)
        ev[3, hits, 0] = w // 2 + 0.5
        ev[3, hits, 1] = h // 2 + 0.25
        t = np.sort(rng.integers(0, 65, capacity)) / 64.0
        t[0], t[n - 1:] = 0.0, 1.0
        ev[3, :, 2] = t
    return ev, counts


def k8_inputs(rng, batch, capacity, grid_hw, dev, hot: bool = False):
    ev, counts = k8_events(rng, batch, capacity, grid_hw, hot)
    return (torch.from_numpy(ev).to(dev), torch.from_numpy(counts).to(dev),
            dict(num_bins=NUM_BINS, height=grid_hw[0], width=grid_hw[1]))


def k8_into_nan(ev, counts, kw) -> torch.Tensor:
    """K8's launch into a grid filled with NaN first (``_voxel_scatter_into``
    takes the output): a cell the kernel fails to write stays NaN."""
    from eventpretrain_tpu_torch.ops.splat import _voxel_scatter_into

    out = torch.full((ev.shape[0], kw["height"], kw["width"],
                      kw["num_bins"]), float("nan"), device=ev.device)
    return _voxel_scatter_into(ev, counts, out, **kw)


def phase_k8_parity(dev) -> tuple[float, float]:
    """K8 against its plain version and against K3's ``voxelize_batch`` (the
    same function through PyTorch bin weights and the splat) at B=8,
    E=30000 on a 128x128x5 grid with a hot pixel, through the wrapper and
    into a grid of NaN."""
    from eventpretrain_tpu_torch.ops.splat import (
        voxelize_batch,
        voxelize_batch_scatter,
        voxelize_batch_scatter_reference,
    )

    ev, counts, kw = k8_inputs(np.random.default_rng(8), 8, EVENTS, CANVAS,
                               dev, hot=True)
    got = voxelize_batch_scatter(ev, counts, **kw)
    nan = k8_into_nan(ev, counts, kw)
    ref = voxelize_batch_scatter_reference(ev, counts, **kw)
    k3 = voxelize_batch(ev, counts, **kw)
    torch.cuda.synchronize()
    err = max((got - ref).abs().max().item(), (nan - ref).abs().max().item())
    err_k3 = (got - k3).abs().max().item()
    err_hot = (nan[3] - ref[3]).abs().max().item()
    log(f"voxelize_batch_scatter (8, {EVENTS}, 4) -> {tuple(got.shape)}: "
        f"max_abs_err {err:.3g} vs its plain version (also into a grid of "
        f"NaN), {err_k3:.3g} vs K3's voxelize_batch (tol {SPLAT_ATOL}); hot "
        f"pixel sample {err_hot:.3g}; sum {got.sum().item():.6g} vs "
        f"{ref.sum().item():.6g}; empty sample {got[1].abs().max().item()}")
    require(err <= SPLAT_ATOL,
            "voxelize_batch_scatter disagrees with its plain version")
    require(err_k3 <= SPLAT_ATOL,
            "voxelize_batch_scatter disagrees with K3's voxelize_batch")
    require(err_hot == 0.0, "the hot pixel's exact sums differ")
    require(got[1].abs().max().item() == 0.0
            and nan[1].abs().max().item() == 0.0,
            "a count of 0 added events")
    return max(err, err_k3), SPLAT_ATOL


# ---------------------------------------------------------------- phase 3


def build_hub(dev, dtype):
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small

    return cls_hub_vit_small(
        NUM_CLASSES, NUM_BINS, dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(0), depth=DEPTH,
    )


def set_fused(hub, fused: bool) -> None:
    """The kernel path (``fused``) or the plain path of every block: K1/K2
    (and K4/K5 when unfused) in ``ViTBlock``, K5 in ``SparseSwinBlock``'s
    MLP."""
    from eventpretrain_tpu_torch.models.layers import ViTBlock
    from eventpretrain_tpu_torch.models.swin import SparseSwinBlock

    for m in hub.modules():
        if isinstance(m, (ViTBlock, SparseSwinBlock)):
            m.use_fused_layer = None if fused else False


COUNTED = {}  # kernel row name -> (wrapper, counter attribute)


def counters() -> dict:
    if not COUNTED:
        from eventpretrain_tpu_torch.ops.fused_attn_layer import (
            fused_attn_layer,
            fused_ln_attn_layer,
        )
        from eventpretrain_tpu_torch.ops.fused_mlp import (
            fused_ln_mlp,
            fused_mlp,
        )
        from eventpretrain_tpu_torch.ops.fused_mha import fused_mha
        from eventpretrain_tpu_torch.ops.splat import (
            splat,
            voxelize_batch_scatter,
        )
        from eventpretrain_tpu_torch.ops.splat_tiled import splat_tiled

        COUNTED.update({
            "splat": (splat, "launches"),
            "splat_tiled": (splat_tiled, "launches"),
            "fused_ln_attn_layer": (fused_ln_attn_layer, "launches"),
            "fused_ln_attn_layer_bwd": (fused_ln_attn_layer, "launches_bwd"),
            "fused_ln_mlp": (fused_ln_mlp, "launches"),
            "fused_ln_mlp_bwd": (fused_ln_mlp, "launches_bwd"),
            "fused_attn_layer": (fused_attn_layer, "launches"),
            "fused_attn_layer_bwd": (fused_attn_layer, "launches_bwd"),
            "fused_mlp": (fused_mlp, "launches"),
            "fused_mlp_bwd": (fused_mlp, "launches_bwd"),
            "fused_mha": (fused_mha, "launches"),
            "fused_mha_bwd": (fused_mha, "launches_bwd"),
            "voxelize_batch_scatter": (voxelize_batch_scatter, "launches"),
        })
    return COUNTED


ROW_COUNTED = {}  # row kernel name -> its wrapper (ops/common.py)


def row_counters() -> dict:
    if not ROW_COUNTED:
        from eventpretrain_tpu_torch.ops import common as cm

        ROW_COUNTED.update(ln_rows=cm.ln_rows, ln_backward=cm.ln_backward,
                           colsum=cm.colsum)
    return ROW_COUNTED


class Counts(dict):
    """The counted wrappers' launches (``counters()``), and in ``rows``
    those of the row kernels under K1/K2/K4/K5 (``row_counters()``): the
    sub-blocks' own launches, kept apart from the sub-blocks' counts that
    each phase checks."""

    def __init__(self, counts: dict, rows: dict):
        super().__init__(counts)
        self.rows = rows


def reset_counts() -> None:
    from eventpretrain_tpu_torch.ops.fused_mha import fused_mha

    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    for fn in row_counters().values():
        fn.launches = 0
    from eventpretrain_tpu_torch.ops.splat import splat

    for by_route in (fused_mha.launches_by_route,
                     fused_mha.launches_bwd_by_route,
                     splat.launches_by_route):
        for route in by_route:
            by_route[route] = 0


def read_counts() -> Counts:
    return Counts({k: getattr(fn, attr)
                   for k, (fn, attr) in counters().items()},
                  {k: fn.launches for k, fn in row_counters().items()})


def row_launches_expected(launches: dict) -> dict:
    """The row kernels' launches a run's sub-block launches imply:
    ``ln_rows`` once in each K1/K2 forward and backward, ``ln_backward``
    once in each K1/K2 backward, ``colsum`` twice in each K1/K2/K4/K5
    backward (ops/fused_attn_layer.py, ops/fused_mlp.py)."""
    fwd = launches["fused_ln_attn_layer"] + launches["fused_ln_mlp"]
    bwd = launches["fused_ln_attn_layer_bwd"] + launches["fused_ln_mlp_bwd"]
    bare = launches["fused_attn_layer_bwd"] + launches["fused_mlp_bwd"]
    return {"ln_rows": fwd + bwd, "ln_backward": bwd,
            "colsum": 2 * (bwd + bare)}


def route_counts() -> dict:
    """K7's launches by the route each took, ``fused_mha[onepass]`` ..."""
    from eventpretrain_tpu_torch.ops.fused_mha import fused_mha

    return {f"{name}[{route}]": n
            for name, by_route in (
                ("fused_mha", fused_mha.launches_by_route),
                ("fused_mha_bwd", fused_mha.launches_bwd_by_route))
            for route, n in by_route.items()}


def phase_main_path(dev, hub, infer, inputs) -> dict:
    from eventpretrain_tpu_torch.cli.serve import make_cls_infer

    reset_counts()
    logits = infer(*inputs)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"main path (serve): logits {logits.shape} {logits.dtype}, finite "
        f"{bool(np.isfinite(logits).all())}, launches {launches}")
    require(logits.shape == (inputs[0].shape[0], NUM_CLASSES), "logit shape")
    require(bool(np.isfinite(logits).all()), "non-finite logits")
    require(launches["splat"] >= 1, "splat not launched by the main path")
    from eventpretrain_tpu_torch.ops.splat import splat, splat_route

    route = splat_route(inputs[0].shape[0], *CANVAS, NUM_BINS)
    require(splat.launches_by_route[route] == launches["splat"],
            f"the served splat left the {route} route "
            f"({splat.launches_by_route})")
    require(launches["fused_ln_attn_layer"] == DEPTH,
            f"fused_ln_attn_layer launched {launches['fused_ln_attn_layer']}"
            f" times, expected {DEPTH}")
    require(launches["fused_ln_mlp"] == DEPTH,
            f"fused_ln_mlp launched {launches['fused_ln_mlp']} times, "
            f"expected {DEPTH}")
    require(launches["fused_ln_attn_layer_bwd"] == 0
            and launches["fused_ln_mlp_bwd"] == 0,
            "a backward kernel ran while serving")
    require(launches["fused_attn_layer"] == launches["fused_mlp"] == 0,
            "an unfused block's kernel ran while serving (every block fuses)")

    # the same weights on the unfused plain path (bf16) and in f32
    set_fused(hub, False)
    plain = infer(*inputs)
    set_fused(hub, True)
    hub32 = build_hub(dev, torch.float32)
    hub32.load_state_dict(hub.state_dict())
    ref32 = make_cls_infer(hub32, num_bins=NUM_BINS, canvas=CANVAS)(*inputs)
    err_plain = float(np.abs(logits - plain).max())
    err_k32 = float(np.abs(logits - ref32).max())
    err_p32 = float(np.abs(plain - ref32).max())
    log(f"main path vs plain bf16 path: max_abs_err {err_plain:.4g} (tol "
        f"{LOGIT_ATOL}); vs f32: "
        f"kernels {err_k32:.4g}, plain bf16 {err_p32:.4g} "
        f"(|logits| max {np.abs(ref32).max():.4g})")
    require(err_plain <= LOGIT_ATOL,
            "kernel path logits disagree with the plain bf16 path")
    # the kernel path must be as close to f32 as bf16 rounding allows: no
    # worse than twice the plain bf16 path's own error, plus 0.01
    require(err_k32 <= 2 * err_p32 + 1e-2,
            "kernel path drifts from the f32 model beyond bf16 rounding")
    del hub32
    return launches


# ---------------------------------------------------------------- phase 4


def _post_npz(url: str, arrays) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


# Served and direct calls run the same code on the same inputs; only the
# order of the splat's atomic adds differs, which may move a bf16 rounding.
SERVE_ATOL = 5e-2


def phase_serving(infer, big_inputs) -> None:
    from eventpretrain_tpu_torch.cli.serve import make_server

    srv = make_server(infer, "chip_smoke", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health.get("ok") is True, f"/healthz answered {health}")
        for n in (1, 8, 64):
            arrays = tuple(a[:n] for a in big_inputs)
            got = _post_npz(url, arrays)
            want = infer(*arrays)
            err = float(np.abs(got - want).max())
            log(f"POST /predict batch {n}: {got.shape} {got.dtype}, "
                f"max_abs_err vs direct {err:.3g} (tol {SERVE_ATOL})")
            require(got.shape == want.shape and err <= SERVE_ATOL,
                    f"served batch {n} disagrees with the direct call")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")


# ---------------------------------------------------------------- phase 5


def build_pretrain_hub(dev):
    from eventpretrain_tpu_torch.models.pretrain_hub import pretrain_hub_base

    return pretrain_hub_base(dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(0),
                             input_size=TRAIN_INPUT)


def rec_batches(dev, steps: int) -> list[dict]:
    """``steps`` B=64 batches of the synthetic source through the pipeline,
    each with an explicit random masking (replayed on both paths)."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        PretrainDataConfig,
        PretrainPipeline,
        SyntheticPretrainSource,
    )
    from eventpretrain_tpu_torch.ops.masking import random_masking

    source = SyntheticPretrainSource(n=TRAIN_BATCH * steps, size=TRAIN_INPUT,
                                     seed=0)
    cfg = PretrainDataConfig(input_size=TRAIN_INPUT,
                             transfer_dtype="bfloat16")
    num_patches = (TRAIN_INPUT // 16) ** 2
    gen = torch.Generator(dev).manual_seed(0)
    batches = []
    for batch in PretrainPipeline(source, cfg, TRAIN_BATCH, seed=0,
                                  device=dev):
        ids_keep, mask, ids_restore = random_masking(
            gen, TRAIN_BATCH, num_patches, 0.75, device=dev)
        batch.update(ids_keep=ids_keep, mask=mask, ids_restore=ids_restore)
        batches.append(batch)
    return batches


def make_trainer(hub, steps_per_epoch: int):
    """The CLI's optimizer and step (cli/pretrain.py) with its defaults:
    lr 1e-3 * 64 / 256, wd 0.05, betas (0.9, 0.95); the warmup is one
    epoch of the 10 steps here, so the steps do move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_rec_step

    schedule = cosine_warmup_schedule(1e-3 * TRAIN_BATCH / 256, 0.0, 1, 400,
                                      steps_per_epoch)
    state = TrainState(hub, build_optimizer(hub, weight_decay=0.05), schedule)
    step = make_rec_step(hub, patch_size=16, num_patches=hub.num_patches)
    return state, step


def run_steps(step, state, batches) -> list[dict]:
    metrics = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    return [{k: float(v) for k, v in m.items()} for m in metrics]


# The kernel and plain paths start from the same weights and see the same
# batches and masks; both compute in bf16 but round in other places (the
# plain path's cuBLAS GEMMs and softmax round their own outputs), so the
# loss, a mean over 64 * 147 * 256 squared errors, differs by ~1e-3 at the
# first step and the gap may grow as the updates compound: bound it at 2%.
LOSS_GAP_REL = 2e-2


def phase_training(dev):
    hub = build_pretrain_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    t0 = time.perf_counter()
    batches = rec_batches(dev, TRAIN_STEPS)
    log(f"rec batches: {len(batches)} x evg {tuple(batches[0]['evg'].shape)}"
        f" {batches[0]['evg'].dtype}, frame "
        f"{tuple(batches[0]['frame'].shape)} in "
        f"{time.perf_counter() - t0:.1f} s")
    state, step = make_trainer(hub, TRAIN_STEPS)
    pstate, pstep = make_trainer(plain_hub, TRAIN_STEPS)

    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts()["fused_ln_attn_layer"]
            == launches["fused_ln_attn_layer"],
            "the plain path launched K1")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log("rec loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log("rec loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log("grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"largest loss gap {gap:.3g} of the plain loss (bound "
        f"{LOSS_GAP_REL}); launches over {TRAIN_STEPS} steps {launches}")
    require(all(np.isfinite([*lk, *lp])), "non-finite rec loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern])),
            "non-finite grad norm")
    require(gap <= LOSS_GAP_REL, "kernel path loss leaves the plain path's")
    for name in ("fused_ln_attn_layer", "fused_ln_attn_layer_bwd",
                 "fused_ln_mlp", "fused_ln_mlp_bwd"):
        per_step = launches[name] / TRAIN_STEPS
        require(per_step == TRAIN_BLOCKS,
                f"{name}: {per_step} launches per step, expected "
                f"{TRAIN_BLOCKS}")
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                pstate=pstate, pstep=pstep, batches=batches,
                launches=launches, loss_gap=gap, losses=lk, plain_losses=lp)


def phase_cli(dev) -> None:
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    out = os.path.join("build", "chip_smoke_pretrain")
    t0 = time.perf_counter()
    state = pretrain_main([
        "--pr_phase", "rec", "--dataset", "synthetic", "--model_size",
        "base", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
        "--output_dir", out, "--print_freq", "1",
        "--input_size", str(TRAIN_INPUT), "--device", str(dev),
    ])
    sd = load_torch_checkpoint(os.path.join(out, "checkpoint.pth"))
    log(f"cli.pretrain: {state.step} steps in "
        f"{time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} tensors")
    require(state.step == 4, f"the CLI ran {state.step} steps, expected 4")
    require(set(sd) == set(state.module.state_dict()),
            "the checkpoint's keys are not the hub's")


# --------------------------------------------------------------- phase 5b
#
# slice 2b: finetune cls_hub_vit_small from raw events, drop-path 0.1 (the
# CLI's default): block 0 (rate 0) fuses into K1/K2; blocks 1-11 train with
# drop-path and take K4 for their attention, the plain MLP beside it.

CLS_STEPS = 10
CLS_DROP_PATH = 0.1
CLS_K4_BLOCKS = DEPTH - 1
# two DropPath calls per block with a rate above 0, in call order
CLS_SITE_RATES = np.repeat(np.linspace(0, CLS_DROP_PATH, DEPTH)[1:], 2)


def build_cls_train_hub(dev, dtype=torch.bfloat16):
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small

    return cls_hub_vit_small(
        NUM_CLASSES, NUM_BINS, dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(0),
        drop_path_rate=CLS_DROP_PATH,
    )


def cls_pipeline(dev, train: bool, batches: int, num_bins: int = NUM_BINS):
    """N-Cars-shaped synthetic streams (sensor 100x120, 30000 events)
    through the cls pipeline at B=64 with the u32 codec."""
    from eventpretrain_tpu_torch.data.cls_pipeline import (
        ClsDataConfig,
        ClsPipeline,
        SyntheticClsSource,
    )

    source = SyntheticClsSource(
        num_classes=NUM_CLASSES,
        samples_per_class=TRAIN_BATCH * batches // NUM_CLASSES,
        num_events=EVENTS, sensor_hw=SENSOR_HW, seed=0 if train else 1000)
    cfg = ClsDataConfig(num_classes=NUM_CLASSES, num_bins=num_bins,
                        transfer_codec="u32")
    return ClsPipeline(source, cfg, TRAIN_BATCH, train=train, seed=0,
                       device=dev)


def make_cls_trainer(hub, dev, steps_per_epoch: int):
    """The finetune CLI's optimizer and step (cli/finetune_cls.py) with its
    defaults: lr 2.5e-4 * 64 / 256, wd 0.05, betas (0.9, 0.999), clip 5,
    smoothing 0.1; the warmup is one epoch of the 10 steps here, so the
    steps do move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_cls_train_step

    schedule = cosine_warmup_schedule(2.5e-4 * TRAIN_BATCH / 256, 1e-6, 1,
                                      100, steps_per_epoch)
    optimizer = build_optimizer(hub, weight_decay=0.05, betas=(0.9, 0.999))
    state = TrainState(hub, optimizer, schedule, clip_grad=5.0)
    step = make_cls_train_step(
        hub, smoothing=0.1, generator=torch.Generator(dev).manual_seed(0))
    return state, step


def phase_cls_training(dev):
    """10 cls train steps on the kernel path, each batch built by the
    pipeline inside the counted run (so K3 counts too), then 10 on the
    plain path from the same init with the same batches and the same
    replayed drop-path masks."""
    hub = build_cls_train_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make_cls_trainer(hub, dev, CLS_STEPS)
    pstate, pstep = make_cls_trainer(plain_hub, dev, CLS_STEPS)
    rng = np.random.default_rng(7)
    keep_prob = (1.0 - CLS_SITE_RATES)[:, None]
    pipe = cls_pipeline(dev, True, CLS_STEPS)

    reset_counts()
    t0 = time.perf_counter()
    batches, kern = [], []
    for batch in pipe:
        batch["drop_path_keep"] = torch.from_numpy(
            rng.random((len(CLS_SITE_RATES), TRAIN_BATCH)) < keep_prob
        ).to(dev)
        batches.append(batch)
        kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    host_ms = pipe.host_seconds / pipe.batches * 1e3
    log(f"cls batches: {len(batches)} x evg {tuple(batches[0]['evg'].shape)}"
        f" {batches[0]['evg'].dtype}; host build {host_ms:.1f} ms per batch "
        f"(windows, erase-and-add, packing, u32 encode); pipeline + "
        f"{CLS_STEPS} kernel-path steps {wall:.1f} s")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log("cls loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log("cls loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log("acc1, kernel path: " + " ".join(f"{m['acc1']:.1f}" for m in kern))
    log("grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"largest cls loss gap {gap:.3g} of the plain loss (bound "
        f"{LOSS_GAP_REL}); launches over {CLS_STEPS} steps {launches}")
    require(all(np.isfinite([*lk, *lp])), "non-finite cls loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern])),
            "non-finite cls grad norm")
    require(gap <= LOSS_GAP_REL, "cls kernel path loss leaves the plain "
                                 "path's")
    per_step = {"fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS,
                "fused_mlp": 0, "fused_mlp_bwd": 0, "splat": 1}
    for name, want in per_step.items():
        require(launches[name] == want * CLS_STEPS,
                f"{name}: {launches[name]} launches over {CLS_STEPS} cls "
                f"steps, expected {want} per step")
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                pstate=pstate, pstep=pstep, batches=batches,
                launches=launches, loss_gap=gap, losses=lk, plain_losses=lp,
                host_ms=host_ms)


def phase_cls_eval(dev, cls) -> dict:
    """One ``make_cls_eval_step`` on a validation batch built by the
    pipeline, then the attention-map forward (``return_attn``) of the
    trained hub on the first train batch; each run counted on its own.
    Returns ``{path: launches}``."""
    from eventpretrain_tpu_torch.train.steps import make_cls_eval_step

    hub = cls["hub"]
    reset_counts()
    val = next(iter(cls_pipeline(dev, False, 1)))
    metrics = {k: float(v) for k, v in make_cls_eval_step(hub)(val).items()}
    torch.cuda.synchronize()
    ev = read_counts()
    log(f"cls eval step B={TRAIN_BATCH}: {metrics}; launches {ev}")
    require(all(np.isfinite(list(metrics.values()))), "non-finite eval")
    require(metrics["_n"] == TRAIN_BATCH, "eval weighed pads")
    for name, want in (("splat", 1), ("fused_ln_attn_layer", DEPTH),
                       ("fused_ln_mlp", DEPTH)):
        require(ev[name] == want, f"eval: {name} launched {ev[name]} times, "
                                  f"expected {want}")
    require(sum(ev.values()) == 1 + 2 * DEPTH, "eval launched another kernel")

    evg = cls["batches"][0]["evg"]
    reset_counts()
    hub.eval()
    with torch.no_grad():
        _, logits, attn = hub(evg, return_attn=True)
    torch.cuda.synchronize()
    am = read_counts()
    log(f"attention-map forward B={TRAIN_BATCH}: logits "
        f"{tuple(logits.shape)}, attn {tuple(attn.shape)} {attn.dtype}; "
        f"launches {am}")
    require(attn.shape == (TRAIN_BATCH, 12, 196, 196), "attention shape")
    for name, want in (("fused_mlp", 1), ("fused_ln_attn_layer", DEPTH - 1),
                       ("fused_ln_mlp", DEPTH - 1)):
        require(am[name] == want, f"attention map: {name} launched "
                                  f"{am[name]} times, expected {want}")
    require(sum(am.values()) == 1 + 2 * (DEPTH - 1),
            "the attention-map forward launched another kernel")
    # the same weights on the plain bf16 path and in f32
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    hub32 = build_cls_train_hub(dev, torch.float32)
    hub32.load_state_dict(hub.state_dict())
    with torch.no_grad():
        _, plain, pattn = plain_hub.eval()(evg, return_attn=True)
        _, ref32, _ = hub32.eval()(evg, return_attn=True)
    err_plain = (logits.float() - plain.float()).abs().max().item()
    err_k32 = (logits.float() - ref32).abs().max().item()
    err_p32 = (plain.float() - ref32).abs().max().item()
    attn_err = (attn.float() - pattn.float()).abs().max().item()
    log(f"attention-map logits vs plain bf16 path: max_abs_err "
        f"{err_plain:.4g} (tol {LOGIT_ATOL}); vs f32: kernels {err_k32:.4g}, "
        f"plain bf16 {err_p32:.4g} (|logits| max "
        f"{ref32.abs().max().item():.4g}); attention weights vs plain bf16: "
        f"max_abs_err {attn_err:.3g} (tol {ATTN_WEIGHT_ATOL})")
    require(err_plain <= LOGIT_ATOL,
            "attention-map logits disagree with the plain bf16 path")
    require(attn_err <= ATTN_WEIGHT_ATOL,
            "attention weights disagree with the plain bf16 path")
    require(err_k32 <= 2 * err_p32 + 1e-2,
            "attention-map logits drift from the f32 model beyond bf16 "
            "rounding")
    del plain_hub, hub32
    return {"cls_eval": ev, "cls_attn_map": am}


def phase_finetune_cli(dev) -> None:
    """``cli.finetune_cls.main`` for one epoch of the synthetic source
    (ViT-S), then ViT-B initialised with ``--finetune`` from the rec
    checkpoint phase 5's ``cli.pretrain`` run wrote (a strict backbone
    load)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_cls import main as finetune

    rec_ckpt = os.path.join("build", "chip_smoke_pretrain", "checkpoint.pth")
    for size, extra in (("small", []), ("base", ["--finetune", rec_ckpt])):
        out = os.path.join("build", f"chip_smoke_finetune_{size}")
        t0 = time.perf_counter()
        reset_counts()
        res = finetune([
            "--dataset", "synthetic", "--model_size", size, "--batch_size",
            str(TRAIN_BATCH), "--epochs", "1", "--output_dir", out,
            "--print_freq", "1", "--device", str(dev), *extra,
        ])
        launches = read_counts()
        state = res["state"]
        log(f"cli.finetune_cls --model_size {size} {' '.join(extra)}: "
            f"{state.step} steps, val {res['val']} in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        require(state.step == 2, f"the CLI ran {state.step} steps, "
                                 "expected 2")
        require(np.isfinite(res["val"]["loss"]), "non-finite val loss")
        require(launches["fused_attn_layer_bwd"] == 2 * CLS_K4_BLOCKS,
                "the CLI's train steps did not take K4")
        sd = load_torch_checkpoint(os.path.join(out, "checkpoint.pth"))
        require(set(sd) == set(state.module.state_dict()),
                "the checkpoint's keys are not the hub's")
        if extra:
            rec = load_torch_checkpoint(rec_ckpt)
            require(set(k for k in rec if k.startswith("backbone."))
                    == set(k for k in sd if k.startswith("backbone.")),
                    "the finetuned backbone's keys are not the rec one's")


# --------------------------------------------------------------- phase 5c
#
# slice 3: semantic segmentation at DSEC's shape. Drop-path 0.1 as in the
# cls finetune (block 0 fuses into K1/K2, blocks 1-11 take K4); the heads'
# dropout 0.1; labels at the sensor's 440x640.

DENSE_CLASSES = 11
DENSE_IGNORE = 255
DENSE_STEPS = 10
DENSE_DROP = 0.1
# the heads' channel dropout: the decode head's 384 channels, the
# auxiliary head's 256, in call order
DENSE_DROPOUT_CHANNELS = (384, 256)
# bf16 logits of the two paths differ by ~1e-2 (the cls phase), so pixels
# whose top two classes lie closer than that may change class
CONFUSION_MOVED_TOL = 5e-2


def build_dense_hub(dev):
    from eventpretrain_tpu_torch.models.dense_hub import dense_hub_vit_small

    return dense_hub_vit_small(
        DENSE_CLASSES, NUM_BINS, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0),
        drop_path_rate=DENSE_DROP, decode_dropout=DENSE_DROP,
    )


def dense_pipeline(dev, train: bool, batches: int,
                   num_bins: int = NUM_BINS, sensor_hw=DSEC_HW,
                   events: int = DSEC_EVENTS):
    """DSEC-shape synthetic streams (sensor 440x640, 200000 events, labels
    at 440x640; or another sensor and count) through the dense pipeline at
    B=16, u32 codec, tiling on "auto" (on: 440 * 640 > 65536)."""
    from eventpretrain_tpu_torch.data.dense_pipeline import (
        DenseDataConfig,
        DensePipeline,
        SyntheticDenseSource,
    )

    source = SyntheticDenseSource(
        "semseg", n=DENSE_BATCH * batches, num_classes=DENSE_CLASSES,
        sensor_hw=sensor_hw, num_events=events, seed=0 if train else 1000)
    cfg = DenseDataConfig(
        task="semseg", num_bins=num_bins, input_size=TRAIN_INPUT,
        fix_events_num=events, val_fix_events_num=events,
        sensor_height=sensor_hw[0], sensor_width=sensor_hw[1],
        label_size=sensor_hw, tiled_raster="auto")
    pipe = DensePipeline(source, cfg, DENSE_BATCH, train=train, seed=0,
                         device=dev)
    require(pipe.tiled, f"the {sensor_hw} pipeline does not tile")
    return pipe


class record_wire:
    """Within the block, every call of a pipeline module's device half
    (``module._device_preprocess``) is recorded (its wire tensors and
    options), so the plain path can rebuild the same batch from the same
    data under ``plain``, the splat's plain version."""

    def __init__(self, module, plain=plain_tiled_splat):
        self.mod, self.plain = module, plain

    def __enter__(self):
        self.fn, self.calls = self.mod._device_preprocess, []

        def recorded(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.fn(*args, **kwargs)

        self.mod._device_preprocess = recorded
        return self

    def __exit__(self, *exc):
        self.mod._device_preprocess = self.fn

    def rebuild_plain(self, i: int):
        """Call ``i`` again with the splat's plain version."""
        args, kwargs = self.calls[i]
        with self.plain():
            return self.fn(*args, **kwargs)


def make_dense_trainer(hub, dev, steps_per_epoch: int,
                       num_classes: int = DENSE_CLASSES):
    """The semseg CLI's optimizer and step (cli/finetune_semseg.py) with its
    defaults: lr 1e-3 * 16 / 256, wd 0.05, betas (0.9, 0.999), no clip,
    loss weights 1 and 0.4, bilinear resizes; the warmup is one epoch of
    the 10 steps here, so the steps do move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_semseg_train_step

    schedule = cosine_warmup_schedule(1e-3 * DENSE_BATCH / 256, 1e-6, 1, 50,
                                      steps_per_epoch)
    optimizer = build_optimizer(hub, weight_decay=0.05, betas=(0.9, 0.999))
    state = TrainState(hub, optimizer, schedule)
    step = make_semseg_train_step(
        hub, num_classes=num_classes, ignore_index=DENSE_IGNORE,
        generator=torch.Generator(dev).manual_seed(0))
    return state, step


def phase_dense_training(dev):
    """10 semseg train steps on the kernel path, each batch built by the
    pipeline inside the counted run (so K6 counts too), then 10 on the
    plain path from the same init: the same wire data through K6's plain
    version, the unfused blocks, the same replayed masks."""
    import eventpretrain_tpu_torch.data.dense_pipeline as dense_data

    hub = build_dense_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make_dense_trainer(hub, dev, DENSE_STEPS)
    pstate, pstep = make_dense_trainer(plain_hub, dev, DENSE_STEPS)
    rng = np.random.default_rng(11)
    sites = np.repeat(np.linspace(0, DENSE_DROP, DEPTH)[1:], 2)
    pipe = dense_pipeline(dev, True, DENSE_STEPS)

    reset_counts()
    t0 = time.perf_counter()
    batches, kern = [], []
    with record_wire(dense_data) as wire:
        for batch in pipe:
            batch["drop_path_keep"] = torch.from_numpy(
                rng.random((len(sites), DENSE_BATCH)) < (1.0 - sites)[:, None]
            ).to(dev)
            batch["dropout_keep"] = [
                torch.from_numpy(rng.random((DENSE_BATCH, c))
                                 < 1.0 - DENSE_DROP).to(dev)
                for c in DENSE_DROPOUT_CHANNELS]
            batches.append(batch)
            kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    pbatches, evg_err = [], 0.0
    for i, batch in enumerate(batches):
        rebuilt = wire.rebuild_plain(i)
        require(torch.equal(rebuilt["label"], batch["label"]),
                "the plain path's labels differ")
        evg_err = max(evg_err,
                      (rebuilt["evg"] - batch["evg"]).abs().max().item())
        pbatches.append({**batch, **rebuilt})
    plain = run_steps(pstep, pstate, pbatches)
    require(read_counts() == launches, "the plain path launched a kernel")
    host_ms = pipe.host_seconds / pipe.batches * 1e3
    log(f"semseg batches: {len(batches)} x evg "
        f"{tuple(batches[0]['evg'].shape)}, label "
        f"{tuple(batches[0]['label'].shape)}; host build {host_ms:.1f} ms "
        f"per batch (erase-and-add, packing, tile bucketing, u32 encode); "
        f"pipeline + {DENSE_STEPS} kernel-path steps {wall:.1f} s; evg of "
        f"K6 vs its plain version: max_abs_err {evg_err:.3g}")
    require(evg_err <= SPLAT_ATOL, "the K6 input differs from the plain one")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log("semseg loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log("semseg loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log("decode CE, kernel path: "
        + " ".join(f"{m['decode_ce']:.4f}" for m in kern))
    log("grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"largest semseg loss gap {gap:.3g} of the plain loss (bound "
        f"{LOSS_GAP_REL}); launches over {DENSE_STEPS} steps {launches}")
    require(all(np.isfinite([*lk, *lp])), "non-finite semseg loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern])),
            "non-finite semseg grad norm")
    require(gap <= LOSS_GAP_REL, "semseg kernel path loss leaves the plain "
                                 "path's")
    per_step = {"splat_tiled": 1, "splat": 0,
                "fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS,
                "fused_mlp": 0, "fused_mlp_bwd": 0}
    for name, want in per_step.items():
        require(launches[name] == want * DENSE_STEPS,
                f"{name}: {launches[name]} launches over {DENSE_STEPS} "
                f"semseg steps, expected {want} per step")
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                pstate=pstate, pstep=pstep, batches=batches,
                wire=wire.calls, launches=launches, loss_gap=gap,
                losses=lk, plain_losses=lp, host_ms=host_ms)


def phase_dense_eval(dev, dense) -> dict:
    """One ``make_semseg_eval_step`` on a validation batch built by the
    pipeline, counted on its own, and its confusion counts against the
    plain path's (the same trained weights unfused, K6's plain version on
    the same wire data)."""
    import eventpretrain_tpu_torch.data.dense_pipeline as dense_data
    from eventpretrain_tpu_torch.eval.metrics import miou_from_confusion
    from eventpretrain_tpu_torch.train.steps import make_semseg_eval_step

    hub = dense["hub"]
    kw = dict(num_classes=DENSE_CLASSES, ignore_label=DENSE_IGNORE)
    reset_counts()
    with record_wire(dense_data) as wire:
        val = next(iter(dense_pipeline(dev, False, 1)))
        conf = make_semseg_eval_step(hub, **kw)(val)
    torch.cuda.synchronize()
    ev = read_counts()
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    pval = {**val, **wire.rebuild_plain(0)}
    pconf = make_semseg_eval_step(plain_hub, **kw)(pval)
    total = int(conf.sum())
    labelled = int((val["label"] != DENSE_IGNORE).sum())
    moved = int((conf - pconf).abs().sum()) / 2 / max(total, 1)
    miou, pmiou = (float(miou_from_confusion(c)) for c in (conf, pconf))
    log(f"semseg eval step B={DENSE_BATCH}: {total} pixels counted, mIoU "
        f"{miou:.3f} (plain path {pmiou:.3f}); pixels whose class moved "
        f"between the paths {moved:.3g} (tol {CONFUSION_MOVED_TOL}); "
        f"launches {ev}")
    require(total == labelled == int(pconf.sum()),
            "the eval step did not count every labelled pixel once")
    require(moved <= CONFUSION_MOVED_TOL,
            "the eval step's confusion leaves the plain path's")
    for name, want in (("splat_tiled", 1), ("fused_ln_attn_layer", DEPTH),
                       ("fused_ln_mlp", DEPTH)):
        require(ev[name] == want, f"semseg eval: {name} launched {ev[name]} "
                                  f"times, expected {want}")
    require(sum(ev.values()) == 1 + 2 * DEPTH,
            "the semseg eval launched another kernel")
    del plain_hub
    return {"semseg_eval": ev}


def phase_semseg_cli(dev) -> None:
    """``cli.finetune_semseg.main`` for one epoch of ``--backbone vit
    --dataset synthetic`` (JAX's smoke source: 5 classes, a 64x64 sensor,
    so the untiled splat K3)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_semseg import main as semseg

    out = os.path.join("build", "chip_smoke_semseg")
    t0 = time.perf_counter()
    reset_counts()
    res = semseg(["--backbone", "vit", "--dataset", "synthetic",
                  "--batch_size", str(DENSE_BATCH), "--epochs", "1",
                  "--output_dir", out, "--print_freq", "1",
                  "--device", str(dev)])
    launches = read_counts()
    state = res["state"]
    log(f"cli.finetune_semseg --backbone vit: {state.step} steps, mIoU "
        f"{res['miou']:.3f} in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    require(state.step == 2, f"the CLI ran {state.step} steps, expected 2")
    require(np.isfinite(res["miou"]), "non-finite mIoU")
    require(launches["fused_attn_layer_bwd"] == 2 * CLS_K4_BLOCKS,
            "the CLI's train steps did not take K4")
    sd = load_torch_checkpoint(os.path.join(out, "checkpoint.pth"))
    require(set(sd) == set(state.module.state_dict()),
            "the checkpoint's keys are not the hub's")


# --------------------------------------------------------------- phase 5d
#
# slice 3c: the two kernels no CLI reaches, each through its one entry
# point, and the training loops' prefetcher on the card.

# the MAE decoder's width and heads at the rec batch (decoder.py:101)
K7_PATH_SHAPE = (64, 196, 512)
K7_PATH_HEADS = 16
K7_PATH_ROUTES = {}  # the K7 path's launches by route (phase 5d)


def phase_k7_path(dev) -> dict:
    """``Attention(512, 16, use_fused_kernel=True)``, bf16, seed 0, called
    with ``fused=False`` (JAX's ``use_fused_layer=False``), forward and
    backward on a (64, 196, 512) input: counted on its own (K7 1 + 1, K4
    0), then its output and every input and parameter gradient held against
    the same module with ``use_fused_kernel=False`` (the plain product)."""
    from eventpretrain_tpu_torch.models.layers import Attention, init_weights

    b, l, c = K7_PATH_SHAPE
    attn = Attention(c, K7_PATH_HEADS, use_fused_kernel=True,
                     dtype=torch.bfloat16, device=dev)
    init_weights(attn, torch.Generator().manual_seed(0))
    plain = copy.deepcopy(attn)
    plain.use_fused_kernel = False
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)

    def run(module):
        xi = x.clone().requires_grad_()
        y, _ = module(xi, fused=False)
        y.backward(dy)
        return (y.detach(), xi.grad,
                *(p.grad for _, p in module.named_parameters()))

    reset_counts()
    got = run(attn)
    torch.cuda.synchronize()
    launches, routes = read_counts(), route_counts()
    want = run(plain)
    require(read_counts() == launches, "the plain product launched a kernel")
    names = ("y", "dx", *(n for n, _ in attn.named_parameters()))
    hold("Attention(use_fused_kernel=True)", [b, l, c, K7_PATH_HEADS], got,
         want, names)
    log(f"K7 path: Attention({c}, {K7_PATH_HEADS}, use_fused_kernel=True) "
        f"forward and backward on {(b, l, c)} bf16; launches {launches}; "
        f"routes {routes}")
    require(launches["fused_mha"] == 1 and launches["fused_mha_bwd"] == 1,
            "the K7 path did not launch K7 once forward and once backward")
    require(sum(launches.values()) == 2,
            "the K7 path launched another kernel (K4 must stay off)")
    require(routes == {"fused_mha[onepass]": 1, "fused_mha[tiled]": 0,
                       "fused_mha_bwd[onepass]": 1,
                       "fused_mha_bwd[tiled]": 0},
            "the K7 path did not take the one-pass route both ways")
    K7_PATH_ROUTES.update(routes)
    return {"k7_attention": launches}


# K8 at DSEC's shape: 200000 events per sample on the 440x640x5 grid
# (1,408,000 cells, a multiple of 128), the semseg batch
K8_PATH_EVENTS = DSEC_EVENTS


def phase_k8_path(dev) -> dict:
    """``voxelize_batch_scatter`` on a DSEC-shape batch (B=16, 200000
    events, 440x640x5, a hot pixel in sample 3), counted on its own (K8 1),
    then held against its plain version and against K3's
    ``voxelize_batch``. The wrapper's grid comes from ``torch.empty``: a
    block of the same size is filled with NaN and freed just before, so
    the caching allocator most likely hands it back; K8 is then held again
    on a grid it is given, filled with NaN (outside the counted run)."""
    from eventpretrain_tpu_torch.ops.splat import (
        voxelize_batch,
        voxelize_batch_scatter,
        voxelize_batch_scatter_reference,
    )

    ev, counts, kw = k8_inputs(np.random.default_rng(12), DENSE_BATCH,
                               K8_PATH_EVENTS, DSEC_HW, dev, hot=True)
    poison = torch.full((DENSE_BATCH, *DSEC_HW, NUM_BINS), float("nan"),
                        device=dev)
    poisoned = poison.data_ptr()
    del poison
    reset_counts()
    got = voxelize_batch_scatter(ev, counts, **kw)
    torch.cuda.synchronize()
    launches = read_counts()
    nan = k8_into_nan(ev, counts, kw)
    ref = voxelize_batch_scatter_reference(ev, counts, **kw)
    err = max((got - ref).abs().max().item(), (nan - ref).abs().max().item())
    err_k3 = (got - voxelize_batch(ev, counts, **kw)).abs().max().item()
    err_hot = (nan[3] - ref[3]).abs().max().item()
    log(f"K8 path: voxelize_batch_scatter {tuple(ev.shape)} -> "
        f"{tuple(got.shape)}: max_abs_err {err:.3g} vs its plain version "
        f"(also into a grid of NaN; the wrapper's grid reused the NaN block: "
        f"{got.data_ptr() == poisoned}), {err_k3:.3g} vs K3's voxelize_batch "
        f"(tol {SPLAT_ATOL}); hot pixel sample {err_hot:.3g}; launches "
        f"{launches}")
    require(bool(torch.isfinite(got).all())
            and bool(torch.isfinite(nan).all()), "non-finite voxel grid")
    require(err <= SPLAT_ATOL and err_k3 <= SPLAT_ATOL,
            "the K8 path's grids disagree with the plain ones")
    require(err_hot == 0.0, "the K8 path's hot pixel's exact sums differ")
    require(got[1].abs().max().item() == 0.0
            and nan[1].abs().max().item() == 0.0,
            "the K8 path's count of 0 added events")
    require(launches["voxelize_batch_scatter"] == 1
            and sum(launches.values()) == 1,
            "the K8 path did not launch K8 alone, once")
    return {"k8_voxelize": launches}


CLS_LOOP_BATCHES = 6
DENSE_LOOP_BATCHES = 4


def phase_prefetch_loops(dev) -> tuple[dict, dict]:
    """One epoch of the cls loop (B=64) and of the semseg loop (B=16), each
    first iterated in the training thread, then through ``train_one_epoch``
    and its prefetcher (counted: the pipeline's K3/K6 launches come from the
    producer thread): delivered samples/s of both, and the host build ms
    per batch. Returns (``{loop: record}``, ``{loop: launches}``)."""
    from eventpretrain_tpu_torch.train.loop import train_one_epoch

    per_step = {"fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS}
    records, launches = {}, {}
    for key, build, trainer, pipeline, batch, n, raster in (
            ("cls_loop", build_cls_train_hub, make_cls_trainer, cls_pipeline,
             TRAIN_BATCH, CLS_LOOP_BATCHES, "splat"),
            ("semseg_loop", build_dense_hub, make_dense_trainer,
             dense_pipeline, DENSE_BATCH, DENSE_LOOP_BATCHES,
             "splat_tiled")):
        hub = build(dev)
        state, step = trainer(hub, dev, n)
        pipe = pipeline(dev, True, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in pipe:
            step(state, b)
        torch.cuda.synchronize()
        serial = time.perf_counter() - t0
        host_ms = pipe.host_seconds / pipe.batches * 1e3
        pipe = pipeline(dev, True, n)
        reset_counts()
        t0 = time.perf_counter()
        _, metrics = train_one_epoch(step, state, pipe, print_freq=n,
                                     header=key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        rec = {"batch": batch, "batches": n,
               "delivered_samples_per_s": n * batch / wall,
               "delivered_samples_per_s_no_prefetch": n * batch / serial,
               "host_batch_ms": host_ms,
               "host_batch_ms_prefetched": (pipe.host_seconds / pipe.batches
                                            * 1e3)}
        log(f"{key}: {n} batches of {batch} through train_one_epoch with the "
            f"prefetcher {rec['delivered_samples_per_s']:.1f} samples/s, "
            f"in the training thread {rec['delivered_samples_per_s_no_prefetch']:.1f}"
            f" samples/s; host build {host_ms:.1f} ms per batch "
            f"({rec['host_batch_ms_prefetched']:.1f} ms beside the steps); "
            f"loss {metrics['loss']:.4f}; launches {counts}")
        require(np.isfinite(metrics["loss"]), f"{key}: non-finite loss")
        for name, want in {**per_step, raster: 1}.items():
            require(counts[name] == want * n,
                    f"{key}: {name} launched {counts[name]} times over {n} "
                    f"steps, expected {want} per step")
        require(sum(counts.values()) == n * (1 + sum(per_step.values())),
                f"{key}: another kernel ran")
        records[key], launches[key] = rec, counts
        del hub, state, step, pipe
    return records, launches


# --------------------------------------------------------------- phase 5e
#
# slice 3b: optical flow at MVSEC's shape. The 260x346 grid is 89960 cells,
# over the untiled splat's 65536, so "auto" tiling sends every batch
# through the C++ tile bucketer and K6 on 3x3 tiles of 128 whose last row
# and column are partial (260 = 2 * 128 + 4, 346 = 2 * 128 + 90).

MVSEC_HW = (260, 346)
MVSEC_EVENTS = 30_000
FLOW_STEPS = 4
FLOW_DROP = 0.1


def build_flow_hub(dev):
    from eventpretrain_tpu_torch.models.dense_hub import dense_hub_vit_small

    return dense_hub_vit_small(
        2, NUM_BINS, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0),
        drop_path_rate=FLOW_DROP, decode_dropout=FLOW_DROP,
    )


def flow_pipeline(dev, train: bool, batches: int, num_bins: int = NUM_BINS):
    """MVSEC-shape synthetic streams (sensor 260x346, 30000 events, flow
    and validity at 260x346) through the dense pipeline at B=16, u32 codec
    (the gt as f16), tiling on "auto"."""
    from eventpretrain_tpu_torch.data.dense_pipeline import (
        DenseDataConfig,
        DensePipeline,
        SyntheticDenseSource,
    )

    source = SyntheticDenseSource(
        "flow", n=DENSE_BATCH * batches, sensor_hw=MVSEC_HW,
        num_events=MVSEC_EVENTS, seed=0 if train else 1000)
    cfg = DenseDataConfig(
        task="flow", num_bins=num_bins, input_size=TRAIN_INPUT,
        fix_events_num=MVSEC_EVENTS, val_fix_events_num=MVSEC_EVENTS,
        sensor_height=MVSEC_HW[0], sensor_width=MVSEC_HW[1],
        label_size=MVSEC_HW, tiled_raster="auto")
    pipe = DensePipeline(source, cfg, DENSE_BATCH, train=train, seed=0,
                         device=dev)
    require(pipe.tiled, "the MVSEC-shape pipeline does not tile")
    return pipe


def make_flow_trainer(hub, dev, steps_per_epoch: int):
    """The flow CLI's optimizer and step (cli/finetune_flow.py) with its
    defaults: lr 1e-3 * 16 / 256 without warmup here, wd 0.05, betas
    (0.9, 0.999), clip 3.0, loss weights 1 and 0.4, max flow 400."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_flow_train_step

    schedule = cosine_warmup_schedule(1e-3 * DENSE_BATCH / 256, 1e-6, 0, 50,
                                      steps_per_epoch)
    optimizer = build_optimizer(hub, weight_decay=0.05, betas=(0.9, 0.999))
    state = TrainState(hub, optimizer, schedule, clip_grad=3.0)
    step = make_flow_train_step(
        hub, generator=torch.Generator(dev).manual_seed(0))
    return state, step


def k6_wire_inputs(args, kw, hw, num_bins: int = NUM_BINS):
    """K6's operands as the dense pipeline's device half builds them from
    a recorded call's wire data: ``(y, x, weights, tile_table, bin
    ranges)``; the count images (``num_bins`` 2 or 3) take the polarity
    weights and no bin ranges."""
    from eventpretrain_tpu_torch.data.codec import decode_events_u32
    from eventpretrain_tpu_torch.ops.events import (
        bilinear_bin_weights_windowed,
        polarity_weights_coordvalid,
    )
    from eventpretrain_tpu_torch.ops.splat_tiled import chunk_bin_range

    t_range = kw["t_range"]
    events = decode_events_u32(args[0], t_range)
    h, w = hw
    x = events[..., 0].to(torch.int32).contiguous()
    y = events[..., 1].to(torch.int32).contiguous()
    if num_bins in (2, 3):
        return (y, x, polarity_weights_coordvalid(events, h, w),
                kw["tile_table"].contiguous(), None)
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    wb = bilinear_bin_weights_windowed(events, valid, t_range[:, 0],
                                       t_range[:, 1], NUM_BINS)
    br = chunk_bin_range(t_range, kw["tile_chunk_trange"], NUM_BINS)
    return (y, x, wb.transpose(1, 2).contiguous(),
            kw["tile_table"].contiguous(), br)


def k6_partial_tile_check(args, kw, hw) -> float:
    """K6 on a recorded batch of the dense pipeline (its own wire data)
    against its plain version, and again restricted to the partial tiles
    of the last tile row and column: the largest difference."""
    from eventpretrain_tpu_torch.ops.splat_tiled import (
        splat_tiled,
        splat_tiled_reference,
    )

    y, x, wb, table, br = k6_wire_inputs(args, kw, hw)
    h, w = hw
    err = 0.0
    for bins in (br, None):
        got = splat_tiled(y, x, wb, table, bins, height=h, width=w)
        ref = splat_tiled_reference(y, x, wb, table, bins, height=h,
                                    width=w)
        torch.cuda.synchronize()
        edge = torch.cat([(got - ref)[:, 256:].flatten(),
                          (got - ref)[:, :, 256:].flatten()])
        require(ref[:, 256:].abs().sum() > 0 and ref[:, :, 256:].abs().sum()
                > 0, "no event fell in the partial tiles")
        err = max(err, (got - ref).abs().max().item(),
                  edge.abs().max().item())
    return err


def phase_flow_training(dev):
    """``FLOW_STEPS`` flow train steps, each batch built by the pipeline
    inside the counted run (so K6 counts too); K6 on the first batch's wire
    data against its plain version, partial tiles included, and the
    pipeline's grid against the same batch rebuilt with K6's plain
    version; then the step's host-clock ms on a fixed batch."""
    import eventpretrain_tpu_torch.data.dense_pipeline as dense_data

    hub = build_flow_hub(dev)
    state, step = make_flow_trainer(hub, dev, FLOW_STEPS)
    pipe = flow_pipeline(dev, True, FLOW_STEPS)
    reset_counts()
    t0 = time.perf_counter()
    batches, metrics = [], []
    with record_wire(dense_data) as wire:
        for batch in pipe:
            batches.append(batch)
            metrics.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    args, kw = wire.calls[0]
    k6_err = k6_partial_tile_check(args, kw, MVSEC_HW)
    rebuilt = wire.rebuild_plain(0)
    evg_err = (rebuilt["evg"] - batches[0]["evg"]).abs().max().item()
    for k in ("flow", "valid", "event_mask"):
        require(torch.equal(rebuilt[k], batches[0][k]),
                f"the flow batch's {k} differs on K6's plain version")
    build_ms = pipe.host_seconds / pipe.batches * 1e3
    b0 = batches[0]
    log(f"flow batches: {len(batches)} x evg {tuple(b0['evg'].shape)}, flow "
        f"{tuple(b0['flow'].shape)}, event pixels "
        f"{float(b0['event_mask'].mean()):.3f} of the grid; host build "
        f"{build_ms:.1f} ms per batch; pipeline + {FLOW_STEPS} steps "
        f"{wall:.1f} s; K6 at {MVSEC_HW[0]}x{MVSEC_HW[1]} vs its plain "
        f"version (partial tiles included): max_abs_err {k6_err:.3g}, the "
        f"pipeline's grid {evg_err:.3g} (tol {SPLAT_ATOL})")
    losses = [m["loss"] for m in metrics]
    log("flow loss: " + " ".join(f"{v:.5f}" for v in losses))
    log("flow decode L1: " + " ".join(f"{m['decode_l1']:.4f}"
                                      for m in metrics))
    log("flow grad norm: " + " ".join(f"{m['grad_norm']:.4g}"
                                      for m in metrics))
    log(f"flow launches over {FLOW_STEPS} steps {launches}")
    require(k6_err <= SPLAT_ATOL and evg_err <= SPLAT_ATOL,
            "K6 at MVSEC's shape disagrees with its plain version")
    require(all(np.isfinite(losses)), "non-finite flow loss")
    require(all(np.isfinite([m["grad_norm"] for m in metrics])),
            "non-finite flow grad norm")
    per_step = {"splat_tiled": 1, "splat": 0,
                "fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS,
                "fused_mlp": 0, "fused_mlp_bwd": 0}
    for name, want in per_step.items():
        require(launches[name] == want * FLOW_STEPS,
                f"{name}: {launches[name]} launches over {FLOW_STEPS} flow "
                f"steps, expected {want} per step")
    q1, med, q3 = statistics.quantiles(
        host_ms(lambda: step(state, b0), reps=REPS // 2, warmup=2), n=4)
    rec = {"model": "dense_hub_vit_small, 2 outputs", "batch": DENSE_BATCH,
           "sensor": list(MVSEC_HW), "events": MVSEC_EVENTS,
           "step_ms": med, "step_ms_q1": q1, "step_ms_q3": q3,
           "samples_per_s": DENSE_BATCH / med * 1e3,
           "host_batch_ms": build_ms, "losses": losses,
           "drop_path_rate": FLOW_DROP, "k6_max_abs_err": k6_err}
    log(f"flow step B={DENSE_BATCH} at {MVSEC_HW[0]}x{MVSEC_HW[1]}: "
        f"{med:.4g} ms (q1 {q1:.4g}, q3 {q3:.4g})")
    return dict(hub=hub, state=state, step=step, batches=batches,
                wire=wire.calls, launches=launches, record=rec,
                k6_err=k6_err)


def phase_flow_eval(dev, flow) -> dict:
    """One ``make_flow_eval_step`` on a validation batch built by the
    pipeline, counted on its own: finite sums over a nonempty mask."""
    from eventpretrain_tpu_torch.train.steps import make_flow_eval_step

    reset_counts()
    val = next(iter(flow_pipeline(dev, False, 1)))
    m = make_flow_eval_step(flow["hub"])(val)
    torch.cuda.synchronize()
    ev = read_counts()
    m = {k: float(v) for k, v in m.items()}
    log(f"flow eval step B={DENSE_BATCH}: {m['count']:.0f} pixels counted, "
        f"AEE {m['epe_sum'] / max(m['count'], 1):.4f}, outliers "
        f"{100 * m['outlier_sum'] / max(m['count'], 1):.2f}%; launches {ev}")
    require(m["count"] > 0, "the flow eval step counted no pixel")
    require(all(np.isfinite(list(m.values()))), "non-finite flow eval sums")
    for name, want in (("splat_tiled", 1), ("fused_ln_attn_layer", DEPTH),
                       ("fused_ln_mlp", DEPTH)):
        require(ev[name] == want, f"flow eval: {name} launched {ev[name]} "
                                  f"times, expected {want}")
    require(sum(ev.values()) == 1 + 2 * DEPTH,
            "the flow eval launched another kernel")
    flow["record"]["eval"] = m
    return {"flow_eval": ev}


def phase_flow_cli(dev) -> None:
    """``python -m eventpretrain_tpu_torch.cli.finetune_flow --dataset
    synthetic --backbone vit`` for one epoch (JAX's smoke source: a 64x64
    sensor, so the untiled splat K3), in its own process."""
    out = os.path.join("build", "chip_smoke_flow")
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "eventpretrain_tpu_torch.cli.finetune_flow",
         "--backbone", "vit", "--dataset", "synthetic", "--batch_size",
         str(DENSE_BATCH), "--epochs", "1", "--output_dir", out,
         "--print_freq", "1", "--device", str(dev)],
        capture_output=True, text=True, timeout=600)
    log(done.stdout.strip())
    if done.returncode != 0:
        log(done.stderr)
    require(done.returncode == 0, "cli.finetune_flow failed")
    with open(os.path.join(out, "log.txt")) as f:
        record = json.loads(f.read().splitlines()[-1])
    log(f"cli.finetune_flow --backbone vit: one epoch in "
        f"{time.perf_counter() - t0:.1f} s, AEE "
        f"{record['synthetic_aee']:.4f}")
    require(np.isfinite(record["synthetic_aee"]), "non-finite CLI AEE")
    require(np.isfinite(record["train_loss"]), "non-finite CLI loss")


# --------------------------------------------------------------- phase 5f
#
# The host half under every pipeline: the C++ host code (packing, the
# fused stream augment, tile bucketing, the u32 encoding) against its numpy
# specifications, on each training pipeline's batch.

HOST_BATCHES = 3


def phase_host(dev) -> dict:
    """The native library built and loaded (not forced to numpy); each
    training pipeline's host build ms per batch with the C++ host code and
    with the numpy specifications (``native.BACKEND = "numpy-forced"``):
    cls (B=64), DSEC semseg (B=16) and MVSEC flow (B=16). Recorded, not
    gated."""
    from eventpretrain_tpu_torch import native

    require(native.BACKEND == "native", "the host code was forced to numpy")
    lib = native.library()
    log(f"host code: native backend, {lib._name}")
    out = {"library": os.path.basename(lib._name)}
    for key, make, batch in (("cls", cls_pipeline, TRAIN_BATCH),
                             ("semseg", dense_pipeline, DENSE_BATCH),
                             ("flow", flow_pipeline, DENSE_BATCH)):
        rec = {"batch": batch}
        for backend in ("native", "numpy-forced"):
            native.BACKEND = backend
            try:
                pipe = make(dev, True, HOST_BATCHES)
                per = []
                for _ in pipe:
                    per.append(pipe.host_seconds * 1e3 - sum(per))
            finally:
                native.BACKEND = "native"
            rec[f"{backend}_ms"] = statistics.median(per)
            rec[f"{backend}_ms_each"] = per
        rec["numpy_over_native"] = rec["numpy-forced_ms"] / rec["native_ms"]
        log(f"host build {key} B={batch}: native {rec['native_ms']:.1f} ms, "
            f"numpy {rec['numpy-forced_ms']:.1f} ms per batch (median of "
            f"{HOST_BATCHES}; {rec['numpy_over_native']:.1f}x)")
        out[key] = rec
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------- phase 5g
#
# slice 4a: stages 2 and 3 of the paper on precomputed CLIP token
# embeddings. pretrain_hub_base with its projection heads (width 4096),
# from phase 5's rec checkpoint: the dense encode runs K1/K2 at ViT-B's
# (64, 196, 768) H12, forward only in stage 2 (the trunk frozen but its
# norm_layer), forward and backward in stage 3; the joint step adds the
# masked encoder (L=49) and the decoder (L=196, C=512).

CON_STEPS = 10
QUEUE_STEPS = 2
QUEUE_LENGTH = 65536  # the CLI's default
JOINT_STEPS = 4
REC_CHECKPOINT = os.path.join("build", "chip_smoke_pretrain",
                              "checkpoint.pth")
# the joint step's blocks: the masked encoder, the decoder, the dense
# encoder
JOINT_BLOCKS = DEPTH + 8 + DEPTH


def build_con_hub(dev, with_decoder: bool):
    """ViT-B/16 with the projection heads (and the decoder), bf16, seed 0,
    filled from phase 5's rec checkpoint as ``--init_from`` fills it."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.pretrain import init_from_checkpoint
    from eventpretrain_tpu_torch.models.pretrain_hub import pretrain_hub_base

    hub = pretrain_hub_base(with_decoder=with_decoder, with_heads=True,
                            dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(0),
                            input_size=TRAIN_INPUT)
    copied = init_from_checkpoint(hub, load_torch_checkpoint(REC_CHECKPOINT))
    require(copied == len(hub.backbone.state_dict()) + (
        len(hub.pretrain_rec_decoder.state_dict()) if with_decoder else 0),
        f"--init_from filled {copied} tensors, not the backbone's (and the "
        "decoder's)")
    return hub


def con_batches(dev, phase: str, steps: int) -> list[dict]:
    """``steps`` B=64 batches of the synthetic source (197x512 CLIP token
    embeddings) through the pipeline for ``phase``; the joint phase's with
    an explicit random masking (replayed on both paths)."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        PretrainDataConfig,
        PretrainPipeline,
        SyntheticPretrainSource,
    )
    from eventpretrain_tpu_torch.ops.masking import random_masking

    source = SyntheticPretrainSource(n=TRAIN_BATCH * steps, size=TRAIN_INPUT,
                                     seed=0)
    cfg = PretrainDataConfig(pr_phase=phase, input_size=TRAIN_INPUT,
                             transfer_dtype="bfloat16")
    gen = torch.Generator(dev).manual_seed(0)
    batches = list(PretrainPipeline(source, cfg, TRAIN_BATCH, seed=0,
                                    device=dev))
    for batch in batches:
        require(tuple(batch["clip_emb"].shape) == (TRAIN_BATCH, 197, 512),
                f"clip_emb {tuple(batch['clip_emb'].shape)}")
        if phase == "rec+con":
            ids_keep, mask, ids_restore = random_masking(
                gen, TRAIN_BATCH, (TRAIN_INPUT // 16) ** 2, 0.75, device=dev)
            batch.update(ids_keep=ids_keep, mask=mask,
                         ids_restore=ids_restore)
    return batches


def make_con_trainer(hub, phase: str, use_queue: bool = False):
    """The CLI's optimizer and the phase's step (cli/pretrain.py) with its
    defaults (lr 1e-3 * 64 / 256, wd 0.05, betas (0.9, 0.95), T 0.07); the
    warmup is one epoch of 10 steps, so the steps move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import (
        make_con_step,
        make_rec_and_con_step,
    )

    schedule = cosine_warmup_schedule(1e-3 * TRAIN_BATCH / 256, 0.0, 1, 400,
                                      CON_STEPS)
    state = TrainState(hub, build_optimizer(hub, weight_decay=0.05), schedule)
    if phase == "rec+con":
        step = make_rec_and_con_step(hub, patch_size=16,
                                     num_patches=hub.num_patches,
                                     use_queue=use_queue)
    else:
        step = make_con_step(hub, use_queue=use_queue)
    return state, step


def require_launches(what: str, launches: dict, steps: int,
                     want: dict) -> None:
    """Each counted wrapper launched ``want[name]`` times a step (0 where
    ``want`` has no entry), and the row kernels as their sub-blocks
    imply."""
    for name, n in launches.items():
        require(n == want.get(name, 0) * steps,
                f"{what}: {name} launched {n} times in {steps} steps, "
                f"expected {want.get(name, 0)} a step")
    rows = row_launches_expected(launches)
    require(launches.rows == rows,
            f"{what}: row kernels {launches.rows}, expected {rows}")


def loss_gap(what: str, kern: list, plain: list, bound: float) -> float:
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"{what} loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log(f"{what} loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log(f"{what} grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"{what}: largest loss gap {gap:.3g} of the plain loss (bound "
        f"{bound})")
    require(all(np.isfinite([*lk, *lp])), f"non-finite {what} loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern + plain])),
            f"non-finite {what} grad norm")
    require(gap <= bound, f"{what}: the kernel path's loss leaves the plain "
                          "path's")
    return gap


def check_frozen_block(dev, hub) -> None:
    """A frozen trunk block under enabled gradients, on an input that needs
    none: K1/K2 launch forward only and autograd keeps no saved tensor.
    Counted on its own, before the main path's counts are reset."""
    saved = []
    x = torch.randn((TRAIN_BATCH, hub.num_patches, hub.embed_dim),
                    generator=torch.Generator().manual_seed(3)).to(
                        dev, hub.compute_dtype)
    reset_counts()
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        y = hub.backbone.vit_block[0](x)
    torch.cuda.synchronize()
    got = read_counts()
    log(f"frozen trunk block under enabled gradients: {len(saved)} saved "
        f"tensors, requires_grad {y.requires_grad}, launches "
        f"K1 {got['fused_ln_attn_layer']} + {got['fused_ln_attn_layer_bwd']}"
        f", K2 {got['fused_ln_mlp']} + {got['fused_ln_mlp_bwd']}")
    require(not saved and not y.requires_grad,
            "the frozen trunk block kept saved tensors")
    require(got["fused_ln_attn_layer"] == got["fused_ln_mlp"] == 1,
            "the frozen trunk block did not run K1/K2")


# The kernel and plain paths start from the same weights and see the same
# batches; both compute in bf16 but round in other places. The InfoNCE
# loss is a mean over 64 * 196 tokens of a log-softmax of cosines / 0.07:
# the rounded q moves each logit by ~1e-2, and the mean by ~1e-3 of itself;
# bound the gap at 2%, as the rec path's.
CON_LOSS_GAP_REL = 2e-2


def phase_con_training(dev) -> dict:
    """Stage 2 (10 adj steps), stage 3 (10 con steps, global InfoNCE, from
    stage 2's weights), each on the kernel path and the plain path from the
    same init and batches; 2 con steps against the queue at the CLI's
    default length; 4 joint rec+con steps with replayed masks on both
    paths. Each kernel-path run is counted on its own."""
    from eventpretrain_tpu_torch.objectives.contrastive import init_queue
    from eventpretrain_tpu_torch.train.optim import freeze_except_norm

    out = {"launches": {}}
    t0 = time.perf_counter()
    # adj and con batches hold the same keys: evg and clip_emb
    batches = con_batches(dev, "con", CON_STEPS)
    joint_batches = con_batches(dev, "rec+con", JOINT_STEPS)
    log(f"contrastive batches: {len(batches)} x evg "
        f"{tuple(batches[0]['evg'].shape)}, clip_emb "
        f"{tuple(batches[0]['clip_emb'].shape)} "
        f"{batches[0]['clip_emb'].dtype}; {len(joint_batches)} joint "
        f"batches in {time.perf_counter() - t0:.1f} s")

    # stage 2: the trunk frozen but its norm_layer
    hub = build_con_hub(dev, with_decoder=False)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    for h in (hub, plain_hub):
        freeze_except_norm(h)
    check_frozen_block(dev, hub)
    frozen = {n: p.detach().clone() for n, p in hub.named_parameters()
              if not p.requires_grad}
    norm0 = hub.backbone.norm_layer.weight.detach().clone()
    state, step = make_con_trainer(hub, "adj")
    pstate, pstep = make_con_trainer(plain_hub, "adj")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    log(f"adj launches over {CON_STEPS} steps {launches}")
    require_launches("adj", launches, CON_STEPS,
                     {"fused_ln_attn_layer": DEPTH, "fused_ln_mlp": DEPTH})
    moved = [n for n, p in hub.named_parameters()
             if n in frozen and not torch.equal(p, frozen[n])]
    require(not moved, f"adj moved frozen parameters: {moved[:4]}")
    require(not torch.equal(hub.backbone.norm_layer.weight, norm0),
            "adj did not train the backbone's norm_layer")
    log(f"adj: {len(frozen)} frozen parameters unchanged bit for bit, "
        f"norm_layer trained")
    gap = loss_gap("adj", kern, plain, CON_LOSS_GAP_REL)
    out["launches"]["adj_train"] = launches
    out["adj"] = dict(step=step, state=state, pstep=pstep, pstate=pstate,
                      batches=batches, loss_gap=gap,
                      losses=[m["loss"] for m in kern])

    # stage 3 from stage 2's weights, the whole model training
    con_hub = copy.deepcopy(hub)
    for p in con_hub.parameters():
        p.requires_grad_(True)
    plain_con = copy.deepcopy(con_hub)
    set_fused(plain_con, False)
    state, step = make_con_trainer(con_hub, "con")
    pstate, pstep = make_con_trainer(plain_con, "con")
    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    log(f"con launches over {CON_STEPS} steps {launches}")
    require_launches("con", launches, CON_STEPS, {
        "fused_ln_attn_layer": DEPTH, "fused_ln_attn_layer_bwd": DEPTH,
        "fused_ln_mlp": DEPTH, "fused_ln_mlp_bwd": DEPTH})
    gap = loss_gap("con", kern, plain, CON_LOSS_GAP_REL)
    out["launches"]["con_train"] = launches
    out["con"] = dict(step=step, state=state, pstep=pstep, pstate=pstate,
                      batches=batches, loss_gap=gap,
                      losses=[m["loss"] for m in kern])

    # the queue at the CLI's default length, on the stage-3 kernel hub
    from eventpretrain_tpu_torch.train.steps import make_con_step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state.queue = init_queue(torch.Generator(dev).manual_seed(1),
                             con_hub.embed_dim, con_hub.num_patches,
                             QUEUE_LENGTH, device=dev)
    qstep = make_con_step(con_hub, use_queue=True)
    reset_counts()
    t0 = time.perf_counter()
    qm = run_steps(qstep, state, batches[:QUEUE_STEPS])
    q_s = (time.perf_counter() - t0) / QUEUE_STEPS
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    buf_gib = state.queue.buffer.numel() * 4 / 2**30
    log(f"con --use_queue --queue_length {QUEUE_LENGTH}: losses "
        + " ".join(f"{m['loss']:.5f}" for m in qm)
        + f" (ln(1 + K) = {np.log(1 + QUEUE_LENGTH):.4f}), ptr "
        f"{state.queue.ptr}, {q_s * 1e3:.1f} ms a step; the buffer "
        f"{buf_gib:.2f} GiB, peak {peak:.2f} GiB allocated ({base / 2**30:.2f}"
        f" GiB before it); launches {launches}")
    require(all(np.isfinite([m["loss"] for m in qm])), "non-finite queue loss")
    require(state.queue.ptr == QUEUE_STEPS * TRAIN_BATCH,
            f"the queue's pointer is {state.queue.ptr}")
    require_launches("con queue", launches, QUEUE_STEPS, {
        "fused_ln_attn_layer": DEPTH, "fused_ln_attn_layer_bwd": DEPTH,
        "fused_ln_mlp": DEPTH, "fused_ln_mlp_bwd": DEPTH})
    out["launches"]["con_queue"] = launches
    out["queue"] = {"queue_length": QUEUE_LENGTH, "steps": QUEUE_STEPS,
                    "losses": [m["loss"] for m in qm], "step_s": q_s,
                    "buffer_gib": buf_gib, "peak_gib": peak,
                    "resident_before_gib": base / 2**30}
    state.queue = None
    del qstep
    torch.cuda.empty_cache()

    # the joint step, masks replayed
    joint = build_con_hub(dev, with_decoder=True)
    plain_joint = copy.deepcopy(joint)
    set_fused(plain_joint, False)
    state, step = make_con_trainer(joint, "rec+con")
    pstate, pstep = make_con_trainer(plain_joint, "rec+con")
    reset_counts()
    kern = run_steps(step, state, joint_batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, joint_batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    log(f"rec+con launches over {JOINT_STEPS} steps {launches}")
    log("rec+con rec / con losses, kernel path: " + " ".join(
        f"{m['rec_loss']:.4f}/{m['con_loss']:.4f}" for m in kern))
    require_launches("rec+con", launches, JOINT_STEPS, {
        "fused_ln_attn_layer": JOINT_BLOCKS,
        "fused_ln_attn_layer_bwd": JOINT_BLOCKS,
        "fused_ln_mlp": JOINT_BLOCKS, "fused_ln_mlp_bwd": JOINT_BLOCKS})
    gap = loss_gap("rec+con", kern, plain, CON_LOSS_GAP_REL)
    out["launches"]["rec_con_train"] = launches
    out["rec_con"] = dict(step=step, state=state, pstep=pstep, pstate=pstate,
                          batches=joint_batches, loss_gap=gap,
                          losses=[m["loss"] for m in kern])
    return out


def phase_con_cli(dev) -> None:
    """``cli.pretrain.main`` (what ``python -m
    eventpretrain_tpu_torch.cli.pretrain`` runs) for one epoch of adj from
    phase 5's rec checkpoint, then one of con from adj's."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    prev = REC_CHECKPOINT
    for phase in ("adj", "con"):
        out = os.path.join("build", f"chip_smoke_{phase}")
        t0 = time.perf_counter()
        state = pretrain_main([
            "--pr_phase", phase, "--dataset", "synthetic", "--model_size",
            "base", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--output_dir", out, "--print_freq", "2", "--init_from", prev,
            "--input_size", str(TRAIN_INPUT), "--device", str(dev),
        ])
        prev = os.path.join(out, "checkpoint.pth")
        sd = load_torch_checkpoint(prev)
        log(f"cli.pretrain --pr_phase {phase}: {state.step} steps in "
            f"{time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} "
            "tensors")
        require(state.step == 4, f"the {phase} CLI ran {state.step} steps")
        require(set(sd) == set(state.module.state_dict()),
                "the checkpoint's keys are not the hub's")
        require("emb_h_proj.1.running_mean" in sd,
                "the checkpoint lacks the projectors' BatchNorm statistics")


# --------------------------------------------------------------- phase 5h
# slice 4b-ii: stages 2 and 3 with CLIP in the loop on raw events. The raw
# pipeline draws N-ImageNet-shaped windows (30000 of 60000 events on the
# 480x640 sensor), rescales them to 224 and rasterises them through K3 on
# the 224x224x5 canvas (its cluster route: 5 CTAs of one channel a
# sample); the frozen CLIP ViT-B/16 encodes each batch's images on the
# card; the hub is phase 5g's, filled from phase 5's rec checkpoint.

RAW_HW = (480, 640)  # N-ImageNet's sensor
RAW_EVENTS = 60000
RAW_FIX_EVENTS = 30000  # the CLI's --fix_events_num
# K3's capacity on this path: the window and 1% of packing headroom
RAW_CAPACITY = RAW_FIX_EVENTS + RAW_FIX_EVENTS // 100
# The bf16 tower against an f32 tower with the same weights on the same
# images, as max |bf16 - f32| over max |f32|: each of the 12 blocks rounds
# its residual stream and products to bf16 (2^-8 relative), and the
# errors add over the blocks. Measured 9.55e-3 at seed 0 (H100 80GB HBM3,
# 700 W); the bound is twice that.
CLIP_BF16_REL_TOL = 2e-2


class keep_images:
    """The inner pipeline's batches, passed on as they are, each batch's
    images kept in ``images`` (``ClipEncodingPipeline`` drops them)."""

    def __init__(self, inner):
        self.inner, self.images = inner, []

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        for batch in self.inner:
            self.images.append(batch["image"])
            yield batch


def raw_pipeline(dev, seed: int):
    """B=64 batches of ``SyntheticRawPretrainSource`` at N-ImageNet's
    sensor through ``RawPretrainPipeline`` at input 224, training (the
    windows, the C++ erase-and-add, the rescale, the view), u32 codec."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        RawPretrainDataConfig,
        RawPretrainPipeline,
        SyntheticRawPretrainSource,
    )

    source = SyntheticRawPretrainSource(n=TRAIN_BATCH * CON_STEPS, hw=RAW_HW,
                                        num_events=RAW_EVENTS, seed=0)
    cfg = RawPretrainDataConfig(input_size=TRAIN_INPUT,
                                fix_events_num=RAW_FIX_EVENTS)
    return RawPretrainPipeline(source, cfg, TRAIN_BATCH, train=True,
                               seed=seed, device=dev)


def clip_stage(dev, what: str, clip, paths, seed: int) -> dict:
    """One epoch of ``CON_STEPS`` batches of the in-loop pipeline through
    the kernel path's step, pipeline and steps in one counted run (K3 in
    the pipeline, K1/K2 in the steps; CLIP launches no counted kernel),
    each batch's wire data recorded; then the plain path's steps on the
    same batches."""
    import eventpretrain_tpu_torch.data.pretrain_pipeline as pretrain_data
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        ClipEncodingPipeline,
    )
    from eventpretrain_tpu_torch.ops.splat import splat

    state, step, pstate, pstep = paths
    pipe = raw_pipeline(dev, seed)
    kept = keep_images(pipe)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batches, kern = [], []
    with record_wire(pretrain_data, plain_splat) as wire:
        for batch in ClipEncodingPipeline(kept, clip):
            batches.append(batch)
            kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    by_route = dict(splat.launches_by_route)
    wall = time.perf_counter() - t0
    # above what was resident before: the epoch's batches, CLIP's and the
    # steps' activations, the optimizer's moments
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    host_ms = pipe.host_seconds / pipe.batches * 1e3
    log(f"{what}: {len(batches)} batches of evg "
        f"{tuple(batches[0]['evg'].shape)}, clip_emb "
        f"{tuple(batches[0]['clip_emb'].shape)} "
        f"{batches[0]['clip_emb'].dtype}; host build {host_ms:.1f} ms a "
        f"batch; pipeline, CLIP and {CON_STEPS} kernel-path steps "
        f"{wall:.1f} s, peak {peak:.2f} GiB above resident; launches "
        f"{launches},"
        f" K3 by route {by_route}")
    require(len(batches) == CON_STEPS, f"{what}: {len(batches)} batches")
    require(by_route == {"cluster": CON_STEPS, "global": 0},
            f"{what}: K3 took the routes {by_route}")
    return dict(step=step, state=state, pstep=pstep, pstate=pstate,
                batches=batches, images=kept.images, wire=wire,
                launches=launches, kern=kern, plain=plain, host_ms=host_ms,
                wall_s=wall, peak_gib=peak)


def phase_clip_training(dev) -> dict:
    """Stage 2 (10 ``adj-n`` steps, the trunk frozen but its norm_layer)
    and stage 3 (10 ``con-n`` steps from stage 2's weights), each fed by
    the in-loop pipeline inside its counted run and replayed on the plain
    path; the bf16 tower against an f32 tower, and K3 on the first
    batch's wire data against its plain version."""
    from eventpretrain_tpu_torch.cli.pretrain import build_clip
    from eventpretrain_tpu_torch.models.clip import encode_images
    from eventpretrain_tpu_torch.ops.splat import (
        max_active_clusters,
        splat_plan,
        splat_route,
    )
    from eventpretrain_tpu_torch.train.optim import freeze_except_norm

    out = {"launches": {}}
    plan = splat_plan(TRAIN_INPUT, TRAIN_INPUT, NUM_BINS)
    route = splat_route(TRAIN_BATCH, TRAIN_INPUT, TRAIN_INPUT, NUM_BINS)
    resident = max_active_clusters("splat", plan.cluster, plan.smem_bytes, 0)
    log(f"raw path: K3 ({TRAIN_BATCH}, {NUM_BINS}, {RAW_CAPACITY}) -> "
        f"{TRAIN_INPUT}x{TRAIN_INPUT}x{NUM_BINS} on the {route} route: "
        f"{plan.cluster} CTAs of {plan.cp} channels, {plan.smem_bytes} B "
        f"shared memory each, {resident} clusters resident at once")
    require(route == "cluster" and resident >= 1,
            "K3's 224x224x5 plan does not run on the cluster route")
    clip = build_clip(torch.bfloat16, dev)
    clip0 = {k: v.clone() for k, v in clip.state_dict().items()}

    # stage 2: the trunk frozen but its norm_layer
    hub = build_con_hub(dev, with_decoder=False)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    for h in (hub, plain_hub):
        freeze_except_norm(h)
    frozen = {n: p.detach().clone() for n, p in hub.named_parameters()
              if not p.requires_grad}
    norm0 = hub.backbone.norm_layer.weight.detach().clone()
    adj = clip_stage(dev, "adj-n", clip,
                     make_con_trainer(hub, "adj")
                     + make_con_trainer(plain_hub, "adj"), seed=0)
    require_launches("adj-n", adj["launches"], CON_STEPS, {
        "splat": 1, "fused_ln_attn_layer": DEPTH, "fused_ln_mlp": DEPTH})
    adj["loss_gap"] = loss_gap("adj-n", adj["kern"], adj["plain"],
                               CON_LOSS_GAP_REL)
    for what, h in (("kernel", hub), ("plain", plain_hub)):
        moved = [n for n, p in h.named_parameters()
                 if n in frozen and not torch.equal(p, frozen[n])]
        require(not moved, f"adj-n ({what} path) moved frozen parameters: "
                           f"{moved[:4]}")
    require(not torch.equal(hub.backbone.norm_layer.weight, norm0),
            "adj-n did not train the backbone's norm_layer")
    moved = [k for k, v in clip.state_dict().items()
             if not torch.equal(v, clip0[k])]
    require(not moved, f"adj-n moved CLIP parameters: {moved[:4]}")
    log(f"adj-n: {len(frozen)} frozen trunk parameters and {len(clip0)} "
        "CLIP tensors unchanged bit for bit, norm_layer trained")

    # CLIP: the bf16 tower against an f32 tower on the first batch's images
    clip32 = build_clip(torch.float32, dev)
    with torch.no_grad():
        want = encode_images(clip32, adj["images"][0])
    got = adj["batches"][0]["clip_emb"].float()
    scale = want.abs().max().item()
    clip_err = (got - want).abs().max().item() / scale
    mean_err = ((got - want).abs().mean() / want.abs().mean()).item()
    log(f"CLIP ViT-B/16 bf16 {tuple(got.shape)} against f32 on the same "
        f"images: max |err| {clip_err:.3g} of the f32 scale {scale:.4g} "
        f"(tol {CLIP_BF16_REL_TOL}), mean |err| {mean_err:.3g} of the mean")
    require(tuple(got.shape) == (TRAIN_BATCH, 197, 512)
            and bool(torch.isfinite(got).all()), "CLIP's output")
    require(clip_err <= CLIP_BF16_REL_TOL,
            "the bf16 CLIP tower leaves the f32 one")
    del clip32
    # K3 on the first batch's wire data against its plain version
    rebuilt = adj["wire"].rebuild_plain(0)
    k3_err = (rebuilt - adj["batches"][0]["evg"]).abs().max().item()
    log(f"raw path: evg of K3 vs its plain version on the first batch's "
        f"wire data: max_abs_err {k3_err:.3g} (tol {SPLAT_ATOL}), sum "
        f"{rebuilt.sum().item():.6g}")
    require(k3_err <= SPLAT_ATOL, "the raw path's K3 grid differs from the "
                                  "plain one")
    out["launches"]["adj_n_train"] = adj["launches"]
    out["adj"] = adj

    # stage 3 from stage 2's weights, the whole model training
    con_hub = copy.deepcopy(hub)
    for p in con_hub.parameters():
        p.requires_grad_(True)
    plain_con = copy.deepcopy(con_hub)
    set_fused(plain_con, False)
    con = clip_stage(dev, "con-n", clip,
                     make_con_trainer(con_hub, "con")
                     + make_con_trainer(plain_con, "con"), seed=1)
    require_launches("con-n", con["launches"], CON_STEPS, {
        "splat": 1, "fused_ln_attn_layer": DEPTH,
        "fused_ln_attn_layer_bwd": DEPTH, "fused_ln_mlp": DEPTH,
        "fused_ln_mlp_bwd": DEPTH})
    con["loss_gap"] = loss_gap("con-n", con["kern"], con["plain"],
                               CON_LOSS_GAP_REL)
    moved = [k for k, v in clip.state_dict().items()
             if not torch.equal(v, clip0[k])]
    require(not moved, f"con-n moved CLIP parameters: {moved[:4]}")
    out["launches"]["con_n_train"] = con["launches"]
    out["con"] = con
    out["clip"] = {"model": clip, "bf16_vs_f32_max_rel": clip_err,
                   "bf16_vs_f32_mean_rel": mean_err,
                   "tol": CLIP_BF16_REL_TOL, "k3_wire_err": k3_err,
                   "k3_plan": {"cluster": plan.cluster, "cp": plan.cp,
                               "smem_bytes": plan.smem_bytes,
                               "resident_clusters": resident}}
    return out


def phase_clip_cli(dev) -> None:
    """``cli.pretrain.main`` for one epoch of ``adj-n`` from phase 5's rec
    checkpoint, then one of ``con-n`` from adj-n's (the synthetic raw
    source: 256 samples, 4 steps); no checkpoint holds a CLIP tensor."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    prev = REC_CHECKPOINT
    for phase in ("adj-n", "con-n"):
        out = os.path.join("build", f"chip_smoke_{phase}")
        t0 = time.perf_counter()
        state = pretrain_main([
            "--pr_phase", phase, "--dataset", "synthetic", "--model_size",
            "base", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--output_dir", out, "--print_freq", "2", "--init_from", prev,
            "--input_size", str(TRAIN_INPUT), "--device", str(dev),
        ])
        prev = os.path.join(out, "checkpoint.pth")
        sd = load_torch_checkpoint(prev)
        log(f"cli.pretrain --pr_phase {phase}: {state.step} steps in "
            f"{time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} "
            "tensors")
        require(state.step == 4, f"the {phase} CLI ran {state.step} steps")
        require(set(sd) == set(state.module.state_dict()),
                "the checkpoint's keys are not the hub's")
        require(not any(k.startswith(("conv1.", "transformer.", "proj"))
                        for k in sd), "the checkpoint holds CLIP tensors")


# --------------------------------------------------------------- phase 5i
#
# slice 5a: the ConvViT backbone (models/convvit.py), the dense CLIs'
# default. Two conv stages (cuDNN's convs, channels-last) under 11 ViT
# blocks that take the kernels: rec pretraining of ConvViT-B (K1/K2 at the
# encoder's (64, 49, 768) and the decoder's (64, 196, 512), both ways),
# and ConvViT-S finetuning with drop-path 0.1 (rates linspace(0, 0.1,
# 15)[4:] > 0, so all 11 ViT blocks take K4 both ways); then slice 4b-i,
# gradient accumulation, against one step of the whole batch.

CONVVIT_DEPTH = 11  # the ViT stage's blocks (models/convvit.py)
CONVVIT_REC_BLOCKS = CONVVIT_DEPTH + 8
CONVVIT_FT_STEPS = 3
CONVVIT_TIMED_REPS = 2  # finetune steps timed a turn, four turns a path
CONVVIT_DROP = 0.1
# two DropPath calls per block with a rate above 0, in call order: the conv
# blocks' (sites 1-3 of the 15; conv_block2 is sized with depths[0]), then
# the ViT blocks' (sites 4-14)
CONVVIT_SITE_RATES = np.repeat(np.linspace(0, CONVVIT_DROP, 15)[1:], 2)
ACCUM_ITER = 4
# bf16 on both sides, the same replayed masks: the whole batch's gradient
# and the mean of its four quarters' sum the same terms in other orders
# and round in other places, so the mean gradient stays within 5e-2 of the
# whole batch's (global norm of the difference over the norm); Adam's first
# update is lr * g / (|g| + eps), so a component whose gradient is rounding
# may take the other sign: parameters within 2 lr of each other, and the
# update's sign equal on 95% of the components at least
ACCUM_GRAD_REL = 5e-2
ACCUM_SIGN_SHARE = 0.95
ACCUM_LR = 1e-4


def build_convvit_rec_hub(dev):
    from eventpretrain_tpu_torch.models.pretrain_hub import (
        pretrain_hub_convvit_base,
    )

    return pretrain_hub_convvit_base(
        dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0), input_size=TRAIN_INPUT)


def phase_convvit_rec(dev) -> dict:
    """10 rec steps of ConvViT-B at B=64 on the kernel path (counted) and
    10 on the plain path from the same init, batches and masks; the loss
    gap, the launches (K1/K2 19 + 19 a step), and the step's ms, peak
    memory and busy share."""
    hub = build_convvit_rec_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    batches = rec_batches(dev, TRAIN_STEPS)
    state, step = make_trainer(hub, TRAIN_STEPS)
    pstate, pstep = make_trainer(plain_hub, TRAIN_STEPS)
    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    gap = loss_gap("convvit rec", kern, plain, LOSS_GAP_REL)
    log(f"convvit rec launches over {TRAIN_STEPS} steps {launches}")
    n = CONVVIT_REC_BLOCKS
    require_launches("convvit rec", launches, TRAIN_STEPS, {
        "fused_ln_attn_layer": n, "fused_ln_attn_layer_bwd": n,
        "fused_ln_mlp": n, "fused_ln_mlp_bwd": n})
    runs, peak = timed_steps({True: (step, state), False: (pstep, pstate)},
                             batches, reps=REPS // 4)
    record = {"model": "pretrain_hub_convvit_base", "batch": TRAIN_BATCH,
              "reps": REPS // 2, "loss_gap": gap, "losses": kern,
              **step_record(runs, peak, TRAIN_BATCH)}
    record["profile"] = device_profile(lambda: step(state, batches[0]), 3)
    log(f"convvit rec step B={TRAIN_BATCH}: kernel {record['step_ms']:.4g} "
        f"ms ({record['peak_step_gib']:.3g} GiB above resident), plain "
        f"{record['plain_step_ms']:.4g} ms")
    log_profile(f"convvit rec step B={TRAIN_BATCH}", record["profile"])
    del plain_hub, pstate, pstep
    return dict(launches=launches, record=record, batches=batches)


def phase_convvit_accum(dev, rec) -> dict:
    """ConvViT-B from seed 0: one rec step of the first B=64 batch, and
    four microsteps of its B=16 quarters under ``accum_steps`` 4, the same
    replayed masks; no parameter moves in microsteps 1-3, the mean of the
    quarters' losses is the whole batch's, the mean gradient is the whole
    batch's within ``ACCUM_GRAD_REL``, and the update agrees."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        global_grad_norm,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_rec_step

    batch = rec["batches"][0]
    runs = {}
    hub0 = build_convvit_rec_hub(dev)
    for k in (1, ACCUM_ITER):
        hub = copy.deepcopy(hub0)
        state = TrainState(hub, build_optimizer(hub, weight_decay=0.05,
                                                accum_steps=k),
                           lambda s: ACCUM_LR)
        step = make_rec_step(hub, patch_size=16, num_patches=hub.num_patches)
        init = [p.detach().clone() for p in hub.parameters()]
        grads = {}
        if k == 1:
            apply = state.apply_gradients

            def capture(apply=apply, hub=hub, grads=grads):
                grads.update((id(p), p.grad.detach().clone())
                             for p in hub.parameters())
                return apply()

            state.apply_gradients = capture
        n = TRAIN_BATCH // k
        losses = []
        for i in range(k):
            micro = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
            losses.append(float(step(state, micro)["loss"]))
            if i < k - 1:
                require(state.step == 0 and all(
                    torch.equal(p, q) for p, q in zip(hub.parameters(),
                                                      init)),
                        f"microstep {i + 1} of {k} moved a parameter")
        require(state.step == 1, f"{k} microsteps made {state.step} updates")
        if k > 1:  # the mean gradient the update saw
            opt_params = [p for g in state.optimizer.param_groups
                          for p in g["params"]]
            grads.update((id(p), g)
                         for p, g in zip(opt_params, state.acc_grads))
        runs[k] = dict(loss=sum(losses) / k, init=init,
                       grads=[grads[id(p)] for p in hub.parameters()],
                       params=[p.detach().clone() for p in hub.parameters()])
        del hub, state, step
    del hub0
    one, acc = runs[1], runs[ACCUM_ITER]
    # early rec gradients reach ~1e20, whose squares overflow f32: the
    # norms are the overflow-safe ones of the clip
    grad_rel = (global_grad_norm([a - o for a, o in zip(acc["grads"],
                                                          one["grads"])])
                / global_grad_norm(one["grads"])).item()
    d1 = torch.cat([(p - q).flatten()
                    for p, q in zip(one["params"], one["init"])])
    da = torch.cat([(p - q).flatten()
                    for p, q in zip(acc["params"], acc["init"])])
    param_gap = (da - d1).abs().max().item()
    moved = d1 != 0
    sign_share = ((torch.sign(da) == torch.sign(d1)) & moved).sum().item() \
        / max(moved.sum().item(), 1)
    loss_rel = abs(acc["loss"] - one["loss"]) / abs(one["loss"])
    log(f"accumulation, ConvViT-B: {ACCUM_ITER} microsteps of "
        f"B={TRAIN_BATCH // ACCUM_ITER} against one step of B={TRAIN_BATCH}: "
        f"mean loss {acc['loss']:.5f} vs {one['loss']:.5f} (rel "
        f"{loss_rel:.3g}), mean gradient's rel err {grad_rel:.3g} (tol "
        f"{ACCUM_GRAD_REL}), parameters' largest gap {param_gap:.3g} (lr "
        f"{ACCUM_LR}), update sign equal on {sign_share:.4f} of "
        f"{int(moved.sum())} moved components (tol {ACCUM_SIGN_SHARE})")
    require(loss_rel <= LOSS_GAP_REL, "the quarters' mean loss is not the "
                                      "whole batch's")
    require(grad_rel <= ACCUM_GRAD_REL, "the accumulated gradient leaves the "
                                        "whole batch's")
    require(param_gap <= 2 * ACCUM_LR * (1 + 1e-3),
            "the accumulated update leaves the whole batch's")
    require(sign_share >= ACCUM_SIGN_SHARE,
            "the accumulated update's signs leave the whole batch's")
    return {"accum_iter": ACCUM_ITER, "micro_batch": TRAIN_BATCH // ACCUM_ITER,
            "loss_rel": loss_rel, "grad_rel_err": grad_rel,
            "param_max_gap": param_gap, "sign_share": sign_share,
            "tol": {"grad_rel": ACCUM_GRAD_REL, "sign": ACCUM_SIGN_SHARE,
                    "param": 2 * ACCUM_LR}}


def convvit_finetune_run(what: str, hub, make, pipe, dropout: bool,
                         held: int = CONVVIT_FT_STEPS,
                         site_rates=CONVVIT_SITE_RATES,
                         compare: bool = True) -> dict:
    """``CONVVIT_FT_STEPS`` steps of ``make(hub)`` on the pipeline's batches
    inside a counted run, each with replayed drop-path masks (one a site of
    ``site_rates``, in call order; with ``dropout`` also the heads'
    dropout), then with ``compare`` the same batches through the plain hub
    from the same init: the loss gap of the first ``held`` steps (2%), the
    others' losses finite, and both paths timed. Without ``compare`` (a
    step that launches no kernel runs the same code on both paths) the
    losses are held finite and the one path is timed; the plain hub is
    kept for the evals."""
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make(hub)
    rng = np.random.default_rng(17)
    keep_prob = (1.0 - site_rates)[:, None]
    reset_counts()
    batches, kern = [], []
    t0 = time.perf_counter()
    for batch in pipe:
        b = batch["evg"].shape[0]
        dev = batch["evg"].device
        batch["drop_path_keep"] = torch.from_numpy(
            rng.random((len(site_rates), b)) < keep_prob).to(dev)
        if dropout:
            batch["dropout_keep"] = [
                torch.from_numpy(rng.random((b, c)) < 1.0 - DENSE_DROP).to(
                    dev) for c in DENSE_DROPOUT_CHANNELS]
        batches.append(batch)
        kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    log(f"{what}: {len(batches)} batches of evg "
        f"{tuple(batches[0]['evg'].shape)}, pipeline + steps {wall:.1f} s; "
        f"launches {launches}")
    paths = {True: (step, state)}
    gap = None
    if compare:
        pstate, pstep = make(plain_hub)
        plain = run_steps(pstep, pstate, batches)
        require(read_counts() == launches, f"{what}: the plain path "
                                           "launched a kernel")
        gap = loss_gap(what, kern[:held], plain[:held], LOSS_GAP_REL)
        rest = [m["loss"] for m in kern[held:] + plain[held:]]
        if rest:
            log(f"{what}: later losses, kernel then plain path: "
                + " ".join(f"{v:.5f}" for v in rest))
        paths[False] = (pstep, pstate)
    else:
        rest = [m["loss"] for m in kern]
        log(f"{what}: losses " + " ".join(f"{v:.5f}" for v in rest))
    require(all(np.isfinite(rest)), f"non-finite {what} loss")
    runs, peak = timed_steps(paths, batches, reps=CONVVIT_TIMED_REPS)
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                batches=batches, launches=launches, loss_gap=gap,
                record={"batch": batch["evg"].shape[0],
                        "reps": len(runs[True]),
                        "loss_gap": gap, "losses": [m["loss"] for m in kern],
                        **step_record(runs, peak, batch["evg"].shape[0])})


def finetune_tasks(dev, label: str, make_hub, site_rates, drop: float,
                   train_want: dict, eval_want: dict,
                   tasks: tuple = ("cls", "semseg", "flow"),
                   num_bins: int = NUM_BINS) -> dict:
    """Each of ``tasks``: cls at B=64 on N-Cars-shaped streams (K3 1 a
    step), semseg at DSEC's 440x640 and flow at MVSEC's 260x346 at B=16
    (K6 1), the pipelines' representation of ``num_bins`` channels, each
    with ``make_hub(task)``'s hub, ``train_want``'s launches a step and
    replayed drop-path masks at ``site_rates``, against the plain path
    where ``train_want`` names a kernel (else the steps run the same code
    on both paths, and one is run and timed); then each task's eval step,
    counted on its own (K3 or K6 1 and ``eval_want``), against the plain
    path's on the same weights."""
    from eventpretrain_tpu_torch.train.steps import (
        make_cls_eval_step,
        make_flow_eval_step,
        make_semseg_eval_step,
    )

    n = CONVVIT_FT_STEPS
    compare = bool(train_want)
    out, launches = {}, {}
    for task in tasks:
        hub = make_hub(task)
        if task == "cls":
            run = convvit_finetune_run(
                f"{label} cls", hub,
                lambda h: make_cls_trainer(h, dev, n),
                cls_pipeline(dev, True, n, num_bins), dropout=False,
                site_rates=site_rates, compare=compare)
            want = {"splat": 1, **train_want}
            val_pipe = cls_pipeline(dev, False, 1, num_bins)
            evals = [make_cls_eval_step(h) for h in (run["hub"],
                                                     run["plain_hub"])]
        else:
            make = make_dense_trainer if task == "semseg" else \
                make_flow_trainer
            pipeline = dense_pipeline if task == "semseg" else flow_pipeline
            # flow's first gradients reach ~1e25 (LayerNorms over empty
            # patches); the clip scales them to 3, and Adam's first update,
            # lr * g / (|g| + eps), gives a component whose clipped
            # gradient is rounding a whole step of either sign on the two
            # paths: from the second step on they are two trajectories
            # (a 2.0% gap at step 3 on an H100), so its first step is
            # held
            run = convvit_finetune_run(
                f"{label} {task}", hub, lambda h, make=make: make(h, dev, n),
                pipeline(dev, True, n, num_bins), dropout=True,
                held=n if task == "semseg" else 1, site_rates=site_rates,
                compare=compare)
            want = {"splat_tiled": 1, **train_want}
            val_pipe = pipeline(dev, False, 1, num_bins)
            if task == "semseg":
                evals = [make_semseg_eval_step(
                    h, num_classes=DENSE_CLASSES, ignore_label=DENSE_IGNORE)
                    for h in (run["hub"], run["plain_hub"])]
            else:
                evals = [make_flow_eval_step(h)
                         for h in (run["hub"], run["plain_hub"])]
        require_launches(f"{label} {task}", run["launches"], n, want)
        launches[f"{label}_{task}_train"] = run["launches"]
        # the eval steps on the same weights: the kernel path's
        run["plain_hub"].load_state_dict(run["hub"].state_dict())
        reset_counts()
        val = next(iter(val_pipe))
        got = evals[0](val)
        torch.cuda.synchronize()
        ev = read_counts()
        ref = evals[1](val)
        require(read_counts() == ev, f"{label} {task} eval: the plain path "
                                     "launched a kernel")
        if task == "semseg":
            # three steps from a random init leave the classes' logits
            # close, so a pixel's argmax flips on rounding: hold the
            # decode head's logits (2% of their scale) and count the pixels
            total = int(got.sum())
            with torch.no_grad():
                logits = [h(val["evg"])[2].float()
                          for h in (run["hub"], run["plain_hub"])]
            rel = ((logits[0] - logits[1]).abs().max()
                   / logits[1].abs().max()).item()
            labelled = int((val["label"] != DENSE_IGNORE).sum())
            summary = {"pixels": total, "logits_rel": rel,
                       "moved": int((got - ref).abs().sum()) / 2
                       / max(total, 1)}
            log(f"{label} semseg eval: {summary}")
            require(total == labelled == int(ref.sum()),
                    f"the {label} semseg eval did not count every labelled "
                    "pixel once")
            require(rel <= LOSS_GAP_REL, f"the {label} semseg eval's logits "
                                         "leave the plain path's")
        else:
            got = {k: float(v) for k, v in got.items()}
            ref = {k: float(v) for k, v in ref.items()}
            key = "loss" if task == "cls" else "epe_sum"
            summary = {"value": got[key], "plain": ref[key],
                       "rel": abs(got[key] - ref[key]) / abs(ref[key])}
            require(all(np.isfinite(list(got.values()))),
                    f"non-finite {label} {task} eval")
            require(summary["rel"] <= LOSS_GAP_REL,
                    f"the {label} {task} eval leaves the plain path's")
        log(f"{label} {task} eval: {summary}; launches {ev}")
        require_launches(f"{label} {task} eval", ev, 1, {
            **eval_want, ("splat" if task == "cls" else "splat_tiled"): 1})
        launches[f"{label}_{task}_eval"] = ev
        run["record"].update(model=f"{task} hub, {label}", eval=summary,
                             drop_path_rate=drop)
        out[task] = run["record"]
        rec = run["record"]
        log(f"{label} {task} step B={rec['batch']}: "
            + (f"kernel {rec['step_ms']:.4g} ms, plain "
               f"{rec['plain_step_ms']:.4g} ms" if compare else
               f"{rec['step_ms']:.4g} ms (no kernel in the step: one path)"))
        del run, evals, hub
    return dict(records=out, launches=launches)


def phase_convvit_finetune(dev) -> dict:
    """ConvViT-S, full width, drop-path 0.1, bf16, seed 0: cls at B=64 (K3
    1, K4 11 + 11 a step), semseg and flow at B=16 (K6 1, K4 11 + 11),
    each against the plain path; each eval step K3 or K6 1, K1/K2 11
    each."""
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_convvit_small
    from eventpretrain_tpu_torch.models.dense_hub import (
        dense_hub_convvit_small,
    )

    kw = dict(dtype=torch.bfloat16, device=dev,
              generator=torch.Generator().manual_seed(0),
              drop_path_rate=CONVVIT_DROP)

    def make_hub(task):
        if task == "cls":
            return cls_hub_convvit_small(NUM_CLASSES, NUM_BINS, **kw)
        classes = DENSE_CLASSES if task == "semseg" else 2
        return dense_hub_convvit_small(classes, NUM_BINS,
                                       decode_dropout=DENSE_DROP, **kw)

    return finetune_tasks(
        dev, "convvit", make_hub, CONVVIT_SITE_RATES, CONVVIT_DROP,
        {"fused_attn_layer": CONVVIT_DEPTH,
         "fused_attn_layer_bwd": CONVVIT_DEPTH},
        {"fused_ln_attn_layer": CONVVIT_DEPTH,
         "fused_ln_mlp": CONVVIT_DEPTH})


def phase_convvit_cli(dev) -> None:
    """The CLIs with ConvViT: ``pretrain --backbone convvit`` for ``rec``
    (ConvViT-B, 4 steps) and ``con`` from its checkpoint (4 steps),
    ``finetune_cls --backbone convvit --accum_iter 2`` (ConvViT-S, 2
    microsteps of 64, 1 update), and ``finetune_semseg`` and
    ``finetune_flow`` with no ``--backbone`` flag (their default,
    ConvViT-S; JAX's smoke sources, 2 steps each)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_cls import main as cls_main
    from eventpretrain_tpu_torch.cli.finetune_flow import main as flow_main
    from eventpretrain_tpu_torch.cli.finetune_semseg import main as seg_main
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    common = ["--device", str(dev), "--print_freq", "1", "--epochs", "1"]
    prev = None
    for phase in ("rec", "con"):
        out = os.path.join("build", f"chip_smoke_convvit_{phase}")
        t0 = time.perf_counter()
        state = pretrain_main(common + [
            "--pr_phase", phase, "--backbone", "convvit", "--model_size",
            "base", "--batch_size", str(TRAIN_BATCH), "--output_dir", out,
            "--input_size", str(TRAIN_INPUT)]
            + (["--init_from", prev] if prev else []))
        prev = os.path.join(out, "checkpoint.pth")
        sd = load_torch_checkpoint(prev)
        log(f"cli.pretrain --backbone convvit --pr_phase {phase}: "
            f"{state.step} steps in {time.perf_counter() - t0:.1f} s")
        require(state.step == 4, f"the convvit {phase} CLI ran {state.step} "
                                 "steps, expected 4")
        require(set(sd) == set(state.module.state_dict()),
                "the checkpoint's keys are not the hub's")
    t0 = time.perf_counter()
    res = cls_main(common + [
        "--backbone", "convvit", "--accum_iter", "2", "--batch_size",
        str(TRAIN_BATCH), "--output_dir",
        os.path.join("build", "chip_smoke_convvit_cls")])
    state = res["state"]
    log(f"cli.finetune_cls --backbone convvit --accum_iter 2: {state.step} "
        f"update, val acc1 {res['val']['acc1']:.1f}, in "
        f"{time.perf_counter() - t0:.1f} s")
    require(state.step == 1 and state.micro_step == 0,
            "two microsteps of --accum_iter 2 did not make one update")
    require(np.isfinite(res["val"]["loss"]), "non-finite cls CLI loss")
    for name, main_fn in (("semseg", seg_main), ("flow", flow_main)):
        t0 = time.perf_counter()
        reset_counts()
        res = main_fn(common + [
            "--dataset", "synthetic", "--batch_size", str(DENSE_BATCH),
            "--output_dir", os.path.join("build", f"chip_smoke_{name}_cv")])
        launches = read_counts()
        state = res["state"]
        backbone = type(state.module.backbone).__name__
        log(f"cli.finetune_{name} (default backbone, {backbone}): "
            f"{state.step} steps in {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        require(backbone == "ConvViT", f"finetune_{name}'s default backbone "
                                       f"is {backbone}")
        require(state.step == 2, f"the {name} CLI ran {state.step} steps")
        require(launches["fused_attn_layer_bwd"] == 2 * CONVVIT_DEPTH,
                f"the {name} CLI's train steps did not take K4")


# --------------------------------------------------------------- phase 5j
# Slice 5b: the sparse Swin-T (widths 96, 192, 384, 768, depths 2, 2, 6,
# 2, window 7) on the visible tokens under host plans. Rec pretraining
# masks 24 of its 49 cells of 32 pixels (ratio 0.5): 1536 of the 3136
# stage-1 tokens, one mask a batch, planned a step ahead on the host and
# uploaded as one buffer; the Swin decoder's 8 blocks at (64, 49, 256), 8
# heads, take K1/K2 both ways. The Swin blocks' windowed attention is plain
# PyTorch, as JAX's is plain jnp; their MLP takes K5 in deterministic calls
# where the gate admits it: stage 3 (C=384, hidden 1536, 196 tokens at
# 224 px), 6 launches an eval forward. Stages 2 and 3 pair the 49 tokens
# with CLIP's 14x14 grid through the 2x2 stride-2 conv and take no kernel
# (training keeps K5 off).

SWIN_STEPS = 4
SWIN_DEC_BLOCKS = 8
SWIN_K5_BLOCKS = 6  # stage 3's blocks
SWIN_DROP = 0.1
# two DropPath calls per block with a rate above 0, in call order: the 12
# blocks' rates linspace(0, 0.1, 12), the first 0
SWIN_SITE_RATES = np.repeat(np.linspace(0, SWIN_DROP, 12)[1:], 2)
SWIN_MASK_RATIO = 0.5
SWIN_PLANNED = 5  # step indices whose planning the host time takes


def build_swin_hub(dev, with_decoder: bool = True, with_heads: bool = False):
    from eventpretrain_tpu_torch.models.pretrain_hub import pretrain_hub_swin

    return pretrain_hub_swin(
        with_decoder=with_decoder, with_heads=with_heads,
        dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0), input_size=TRAIN_INPUT)


def make_swin_trainer(hub, phase: str):
    """The pretrain CLI's optimizer (lr 1e-3 * 64 / 256, wd 0.05, betas
    (0.9, 0.95); the warmup one epoch of ``SWIN_STEPS``) and the phase's
    step with the CLI's Swin schedule (cli/pretrain.py): 7x7 cells of 32
    pixels at ratio 0.5, the patch grid at input_size // 4, window 7,
    seed 0."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import (
        make_con_step,
        make_swin_rec_and_con_step,
        make_swin_rec_step,
    )

    schedule = cosine_warmup_schedule(1e-3 * TRAIN_BATCH / 256, 0.0, 1, 400,
                                      SWIN_STEPS)
    state = TrainState(hub, build_optimizer(hub, weight_decay=0.05), schedule)
    plan = dict(cell_grid=7, mask_ratio=SWIN_MASK_RATIO,
                decoder_patch_size=32, input_resolution=TRAIN_INPUT // 4,
                window_size=7, plan_seed=0)
    if phase == "rec":
        step = make_swin_rec_step(hub, **plan)
    elif phase == "rec+con":
        step = make_swin_rec_and_con_step(hub, **plan)
    else:
        step = make_con_step(hub)
    return state, step


def check_plan_handoff(what: str, step, state, steps: int) -> dict:
    """A step's plans and masking cross to the card as one copy: the
    masker uploaded one buffer a planned step (steps 0 .. ``steps`` - 1
    and the two it prefetched), and every index tensor of a step's plans
    and masking is a view of one tensor on the card. Also the host's
    planning ms a step (the mask, the knapsack and the pack, the median
    of ``SWIN_PLANNED`` steps' indices) and the buffer's bytes."""
    import concurrent.futures

    from eventpretrain_tpu_torch.models.swin import DeviceStagePlan

    masker = step.masker
    concurrent.futures.wait(list(masker._pending.values()))
    uploads = masker.uploads
    require(uploads == steps + 2, f"{what}: the masker uploaded {uploads} "
                                  f"buffers for {steps} steps and 2 ahead")
    plans, ids_keep, _, ids_restore = masker(state, TRAIN_BATCH)
    leaves = [ids_keep, ids_restore]
    for sp in plans:
        for p in (sp.plan_even, sp.plan_odd):
            leaves += list(p)
        leaves += [sp.coords_flat] + ([] if sp.merge_child_idx is None
                                      else [sp.merge_child_idx])
    require(all(isinstance(sp, DeviceStagePlan) for sp in plans),
            f"{what}: the plans are not device plans")
    storages = {t.untyped_storage().data_ptr() for t in leaves}
    require(len(storages) == 1 and all(t.is_cuda for t in leaves),
            f"{what}: a step's {len(leaves)} index tensors lie in "
            f"{len(storages)} tensors, not views of one on the card")
    plan_ms = []
    for s in range(100, 100 + SWIN_PLANNED):
        t0 = time.perf_counter()
        flat, _ = masker._compute_np(s)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"uploads": uploads, "views_of_one_tensor": len(leaves),
           "plan_bytes": int(flat.nbytes),
           "plan_host_ms": statistics.median(plan_ms),
           "kept_tokens": int(plans[0].coords_flat.shape[0])}
    log(f"{what}: one upload a planned step ({uploads} for {steps} steps "
        f"and 2 ahead), {len(leaves)} index tensors views of one tensor of "
        f"{out['plan_bytes']} bytes; host planning "
        f"{out['plan_host_ms']:.3g} ms a step (median of {SWIN_PLANNED}); "
        f"{out['kept_tokens']} stage-1 tokens kept")
    return out


def phase_swin_rec(dev) -> dict:
    """``SWIN_STEPS`` rec steps of Swin-T at B=64 on the kernel path
    (counted) and on the plain path from the same init, batches and
    schedule: the loss gap, the launches (K1/K2 8 + 8 a step), the plan's
    one copy a step, and the step's ms, peak memory, device time and busy
    share."""
    hub = build_swin_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    batches = rec_batches(dev, SWIN_STEPS)
    state, step = make_swin_trainer(hub, "rec")
    pstate, pstep = make_swin_trainer(plain_hub, "rec")
    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    gap = loss_gap("swin rec", kern, plain, LOSS_GAP_REL)
    log(f"swin rec launches over {SWIN_STEPS} steps {launches}")
    n = SWIN_DEC_BLOCKS
    require_launches("swin rec", launches, SWIN_STEPS, {
        "fused_ln_attn_layer": n, "fused_ln_attn_layer_bwd": n,
        "fused_ln_mlp": n, "fused_ln_mlp_bwd": n})
    handoff = check_plan_handoff("swin rec", step, state, SWIN_STEPS)
    runs, peak = timed_steps({True: (step, state), False: (pstep, pstate)},
                             batches, reps=REPS // 4)
    record = {"model": "pretrain_hub_swin", "batch": TRAIN_BATCH,
              "reps": REPS // 2, "mask_ratio": SWIN_MASK_RATIO,
              "loss_gap": gap, "losses": [m["loss"] for m in kern],
              **handoff, **step_record(runs, peak, TRAIN_BATCH)}
    record["profile"] = device_profile(lambda: step(state, batches[0]), 3)
    # the batches are on the card already: the plan's upload is the step's
    # one host-to-device copy (the profile sees the planner thread's too)
    require(record["profile"]["htod_copies"] == 1,
            f"swin rec: {record['profile']['htod_copies']} host-to-device "
            "copies a step, expected the plan's one")
    log(f"swin rec step B={TRAIN_BATCH}: kernel {record['step_ms']:.4g} ms "
        f"({record['peak_step_gib']:.3g} GiB above resident), plain "
        f"{record['plain_step_ms']:.4g} ms; host planning "
        f"{record['plan_host_ms']:.3g} ms a step")
    log_profile(f"swin rec step B={TRAIN_BATCH}", record["profile"])
    del plain_hub, pstate, pstep
    return dict(launches=launches, record=record)


def one_path_record(what: str, step, state, batches) -> dict:
    """The host-clock ms of a path's steps (median of ``REPS // 4`` after
    one warm-up, on its own batches in turn) and the memory a step adds
    above what is resident."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls = [0]

    def one_step():
        calls[0] += 1
        return step(state, batches[calls[0] % len(batches)])

    times = host_ms(one_step, reps=REPS // 4, warmup=1)
    out = {"batch": TRAIN_BATCH, "reps": REPS // 4,
           "step_ms": statistics.median(times),
           "samples_per_s": TRAIN_BATCH / statistics.median(times) * 1e3,
           "peak_step_gib": (torch.cuda.max_memory_allocated() - base)
           / 2**30}
    log(f"{what} step B={TRAIN_BATCH}: {out['step_ms']:.4g} ms "
        f"({out['peak_step_gib']:.3g} GiB above resident)")
    return out


def phase_swin_con(dev) -> dict:
    """The contrastive phases of Swin-T at B=64 on the synthetic 197x512
    CLIP tokens through the conv projection: ``SWIN_STEPS`` rec+con steps
    (global InfoNCE) on the kernel path (counted: K1/K2 8 + 8 a step, the
    decoder) and the plain path from the same init, batches and schedule;
    then from its weights ``SWIN_STEPS`` adj steps (the trunk frozen but
    its norm_layer, every frozen parameter unchanged bit for bit) and con
    steps, counted: no kernel on their path."""
    from eventpretrain_tpu_torch.cli.pretrain import init_from_checkpoint
    from eventpretrain_tpu_torch.train.optim import freeze_except_norm

    out = {"launches": {}, "records": {}}
    joint_batches = con_batches(dev, "rec+con", SWIN_STEPS)
    hub = build_swin_hub(dev, with_heads=True)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make_swin_trainer(hub, "rec+con")
    pstate, pstep = make_swin_trainer(plain_hub, "rec+con")
    reset_counts()
    kern = run_steps(step, state, joint_batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, joint_batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    log(f"swin rec+con launches over {SWIN_STEPS} steps {launches}")
    log("swin rec+con rec / con losses, kernel path: " + " ".join(
        f"{m['rec_loss']:.4f}/{m['con_loss']:.4f}" for m in kern))
    n = SWIN_DEC_BLOCKS
    require_launches("swin rec+con", launches, SWIN_STEPS, {
        "fused_ln_attn_layer": n, "fused_ln_attn_layer_bwd": n,
        "fused_ln_mlp": n, "fused_ln_mlp_bwd": n})
    gap = loss_gap("swin rec+con", kern, plain, CON_LOSS_GAP_REL)
    runs, peak = timed_steps({True: (step, state), False: (pstep, pstate)},
                             joint_batches, reps=REPS // 4)
    out["launches"]["swin_rec_con_train"] = launches
    out["records"]["rec_con_train"] = {
        "model": "pretrain_hub_swin", "batch": TRAIN_BATCH,
        "reps": REPS // 2, "loss_gap": gap,
        "losses": [m["loss"] for m in kern],
        **step_record(runs, peak, TRAIN_BATCH)}
    del plain_hub, pstate, pstep

    batches = con_batches(dev, "con", SWIN_STEPS)
    adj_hub = build_swin_hub(dev, with_decoder=False, with_heads=True)
    copied = init_from_checkpoint(adj_hub, hub.state_dict())
    require(copied == len(adj_hub.state_dict()),
            f"adj took {copied} of {len(adj_hub.state_dict())} tensors from "
            "rec+con's hub")
    del hub, state, step
    freeze_except_norm(adj_hub)
    frozen = {n: p.detach().clone() for n, p in adj_hub.named_parameters()
              if not p.requires_grad}
    for phase in ("adj", "con"):
        if phase == "con":
            for p in adj_hub.parameters():
                p.requires_grad_(True)
        state, step = make_swin_trainer(adj_hub, phase)
        reset_counts()
        metrics = run_steps(step, state, batches)
        launches = read_counts()
        log(f"swin {phase}: losses " + " ".join(
            f"{m['loss']:.5f}" for m in metrics) + f"; launches {launches}")
        require(all(np.isfinite([m["loss"] for m in metrics])),
                f"non-finite swin {phase} loss")
        require_launches(f"swin {phase}", launches, SWIN_STEPS, {})
        if phase == "adj":
            moved = [n for n, p in adj_hub.named_parameters()
                     if n in frozen and not torch.equal(p, frozen[n])]
            require(not moved, f"swin adj moved frozen parameters: "
                               f"{moved[:4]}")
            log(f"swin adj: {len(frozen)} frozen parameters unchanged bit "
                "for bit")
        out["launches"][f"swin_{phase}_train"] = launches
        out["records"][f"{phase}_train"] = {
            "model": "pretrain_hub_swin", "losses": [m["loss"]
                                                     for m in metrics],
            **one_path_record(f"swin {phase}", step, state, batches)}
    return out


def phase_swin_finetune(dev) -> dict:
    """Swin-T, full width, drop-path 0.1, bf16, seed 0: cls at B=64 (K3 1
    a step), semseg and flow at B=16 (K6 1), 22 replayed drop-path masks a
    step; no other kernel in training, so the steps run once, losses held
    finite, and are timed on that one path; each eval step K3 or K6 1 and
    K5 6 (stage 3's MLPs), against the plain path's on the same
    weights."""
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_swin_tiny
    from eventpretrain_tpu_torch.models.dense_hub import dense_hub_swin_tiny

    kw = dict(dtype=torch.bfloat16, device=dev,
              generator=torch.Generator().manual_seed(0),
              drop_path_rate=SWIN_DROP)

    def make_hub(task):
        if task == "cls":
            return cls_hub_swin_tiny(NUM_CLASSES, NUM_BINS, **kw)
        classes = DENSE_CLASSES if task == "semseg" else 2
        return dense_hub_swin_tiny(classes, NUM_BINS,
                                   decode_dropout=DENSE_DROP, **kw)

    return finetune_tasks(dev, "swin", make_hub, SWIN_SITE_RATES, SWIN_DROP,
                          {}, {"fused_mlp": SWIN_K5_BLOCKS})


def phase_swin_cli(dev) -> None:
    """The CLIs with ``--backbone swin``: ``pretrain --pr_phase rec`` (4
    steps at B=64, counted: K1/K2 8 + 8 a step), ``pretrain --pr_phase
    con-n`` from its checkpoint (the raw pipeline's K3 at 224, CLIP
    ViT-B/16 in the loop, its 14x14 tokens through the conv projection to
    the 49 cells; 4 steps, counted: K3 1 a step), then ``finetune_cls
    --finetune`` from the rec checkpoint (the bridge's strict backbone
    load of the Swin keys; 2 steps), ``finetune_semseg`` and
    ``finetune_flow`` (JAX's smoke sources, 2 steps each, their evals on
    K5)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_cls import main as cls_main
    from eventpretrain_tpu_torch.cli.finetune_flow import main as flow_main
    from eventpretrain_tpu_torch.cli.finetune_semseg import main as seg_main
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    common = ["--device", str(dev), "--print_freq", "1", "--epochs", "1",
              "--backbone", "swin"]
    out = os.path.join("build", "chip_smoke_swin_rec")
    t0 = time.perf_counter()
    reset_counts()
    state = pretrain_main(common + [
        "--pr_phase", "rec", "--batch_size", str(TRAIN_BATCH),
        "--mask_ratio", str(SWIN_MASK_RATIO), "--output_dir", out,
        "--input_size", str(TRAIN_INPUT)])
    launches = read_counts()
    ckpt = os.path.join(out, "checkpoint.pth")
    sd = load_torch_checkpoint(ckpt)
    log(f"cli.pretrain --backbone swin --pr_phase rec: {state.step} steps "
        f"in {time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} "
        f"tensors; launches {launches}")
    require(state.step == 4, f"the swin rec CLI ran {state.step} steps, "
                             "expected 4")
    require(set(sd) == set(state.module.state_dict()),
            "the checkpoint's keys are not the hub's")
    require(launches["fused_ln_attn_layer_bwd"] == 4 * SWIN_DEC_BLOCKS,
            "the swin rec CLI's steps did not take K1's backward")
    t0 = time.perf_counter()
    reset_counts()
    con_out = os.path.join("build", "chip_smoke_swin_con_n")
    con_state = pretrain_main(common + [
        "--pr_phase", "con-n", "--dataset", "synthetic", "--batch_size",
        str(TRAIN_BATCH), "--init_from", ckpt, "--output_dir", con_out,
        "--input_size", str(TRAIN_INPUT)])
    launches = read_counts()
    con_sd = load_torch_checkpoint(os.path.join(con_out, "checkpoint.pth"))
    moved = [k for k in con_sd if k.startswith("backbone.swin_block")
             and not torch.equal(con_sd[k], sd[k])]
    log(f"cli.pretrain --backbone swin --pr_phase con-n: {con_state.step} "
        f"steps in {time.perf_counter() - t0:.1f} s, checkpoint of "
        f"{len(con_sd)} tensors, {len(moved)} trunk tensors moved from the "
        f"rec checkpoint; launches {launches}")
    require(con_state.step == 4, f"the swin con-n CLI ran {con_state.step} "
                                 "steps, expected 4")
    require(con_state.module.num_patches == 49,
            "the swin con-n hub does not pair 49 tokens with CLIP's")
    require(set(con_sd) == set(con_state.module.state_dict()),
            "the con-n checkpoint's keys are not the hub's")
    require(not any(k.startswith(("conv1.", "transformer.", "proj"))
                    for k in con_sd), "the con-n checkpoint holds CLIP "
                                      "tensors")
    require(moved, "the swin con-n CLI did not train the trunk")
    require(launches["splat"] == 4, "the swin con-n CLI's pipeline did not "
                                    "take K3 once a step")
    t0 = time.perf_counter()
    res = cls_main(common + [
        "--batch_size", str(TRAIN_BATCH), "--finetune", ckpt,
        "--output_dir", os.path.join("build", "chip_smoke_swin_cls")])
    cls_state = res["state"]
    log(f"cli.finetune_cls --backbone swin --finetune: {cls_state.step} "
        f"steps, val acc1 {res['val']['acc1']:.1f}, in "
        f"{time.perf_counter() - t0:.1f} s")
    # the CLI's synthetic source: 64 streams a class, 2 classes
    require(cls_state.step == 128 // TRAIN_BATCH,
            f"the swin cls CLI ran {cls_state.step} steps")
    require(np.isfinite(res["val"]["loss"]), "non-finite swin cls CLI loss")
    for name, main_fn in (("semseg", seg_main), ("flow", flow_main)):
        t0 = time.perf_counter()
        reset_counts()
        res = main_fn(common + [
            "--dataset", "synthetic", "--batch_size", str(DENSE_BATCH),
            "--output_dir", os.path.join("build", f"chip_smoke_{name}_swin")])
        launches = read_counts()
        backbone = type(res["state"].module.backbone).__name__
        log(f"cli.finetune_{name} --backbone swin ({backbone}): "
            f"{res['state'].step} steps in {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        require(backbone == "SparseSwin", f"finetune_{name} --backbone swin "
                                          f"built {backbone}")
        require(res["state"].step == 2, f"the swin {name} CLI ran "
                                        f"{res['state'].step} steps")
        require(launches["fused_mlp"] >= SWIN_K5_BLOCKS,
                f"the swin {name} CLI's eval did not take K5")


# --------------------------------------------------------------- phase 5k
# Slice 5c: the ECDP baseline. ViT-S ECDP at B=64, bf16: two views masked
# to 49 of 196 patches, the two learned tokens prepended (51 tokens a
# block); the query encoder's 12 blocks take K1/K2 forward and backward,
# the EMA key encoder's 12 forward only, under no_grad. The heads (4096
# wide) and the objectives are plain PyTorch. On the raw path the two
# views' 2-channel count images come from K3 on the 224x224x2 canvas (its
# cluster route: 2 CTAs of one channel a sample), CLIP ViT-B/16's class
# token from phase 5h's tower.

ECDP_STEPS = 4
# The warmup's first update runs at lr 0 (schedule(0) = 0), so losses 0
# and 1 are both taken on the initial weights and loss 2 is the first
# after a real update (lr / 4). At this init the step's gradient is
# ill-conditioned in bf16: the two learned tokens come out of the backbone
# nearly alike for every sample, and the projectors' BatchNorms normalise
# what differs, so the rounding of the common part becomes a large share
# of the normalised signal (on an H100 each bf16 path's step-0 gradient is
# 52-55% of its norm away from the f32 path's, and 60% from the other's).
# Held, so: the loss gap of the first three steps (2%); each step's loss
# within 2% of the same steps' in f32 on the plain path (from the same
# init, batches and masks); the kernel path's step-0 gradient no further
# from the f32 path's than ECDP_WITNESS_RATIO times the plain bf16 path's;
# and, where nothing amplifies rounding, the query backbone alone under a
# fixed random cotangent on its two token embeddings: forward and
# backward through its 12 blocks (K1/K2 at L=51, padded to 64) on the
# first batch and mask, every backbone gradient within ECDP_GRAD_REL of
# the plain path's (global norm of the difference over the plain norm,
# as the accumulation's check) and no further from f32 than the ratio.
ECDP_HELD = 3
ECDP_GRAD_REL = 5e-2
ECDP_WITNESS_RATIO = 1.25
ECDP_QUEUE = 65536  # the CLI's --queue_length
ECDP_DEPTH = 12
CONVVIT_ECDP_DEPTH = 11
# a step: the query's blocks forward and backward, the key's forward
ECDP_WANT = {"fused_ln_attn_layer": 2 * ECDP_DEPTH,
             "fused_ln_mlp": 2 * ECDP_DEPTH,
             "fused_ln_attn_layer_bwd": ECDP_DEPTH,
             "fused_ln_mlp_bwd": ECDP_DEPTH}


def build_ecdp(dev, convvit: bool = False, dtype=torch.bfloat16):
    from eventpretrain_tpu_torch.models.ecdp_hub import (
        ecdp_model_convvit_small,
        ecdp_model_small,
    )

    make = ecdp_model_convvit_small if convvit else ecdp_model_small
    return make(dtype=dtype, device=dev,
                generator=torch.Generator().manual_seed(0),
                input_size=TRAIN_INPUT)


def ecdp_batches(dev, steps: int, seed: int = 0) -> list[dict]:
    """``steps`` B=64 ECDP batches of the synthetic 2-channel source
    through ``EcdpPretrainPipeline``, each with the two views' maskings
    (replayed on both paths)."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        EcdpPretrainPipeline,
        PretrainDataConfig,
        SyntheticPretrainSource,
    )
    from eventpretrain_tpu_torch.ops.masking import random_masking

    source = SyntheticPretrainSource(n=TRAIN_BATCH * steps, size=TRAIN_INPUT,
                                     num_bins=2, clip_tokens=1, seed=seed)
    cfg = PretrainDataConfig(pr_phase="ecdp", num_bins=2,
                             input_size=TRAIN_INPUT)
    gen = torch.Generator(dev).manual_seed(seed)
    batches = []
    for batch in EcdpPretrainPipeline(source, cfg, TRAIN_BATCH, seed=seed,
                                      device=dev):
        for view in ("q", "k"):
            ids_keep, mask, _ = random_masking(
                gen, TRAIN_BATCH, (TRAIN_INPUT // 16) ** 2, 0.75, device=dev)
            batch.update({f"ids_keep_{view}": ids_keep,
                          f"mask_{view}": mask})
        batches.append(batch)
    return batches


def make_ecdp_trainer(model, use_queue: bool = False):
    """The CLI's optimizer, schedule (lr 1e-3 * 64 / 256, one epoch of
    warmup over ``ECDP_STEPS``, so the steps move the weights), key encoder
    (the model's copy, on the model's path) and step, with the CLI's
    defaults; the queues of ``ECDP_QUEUE`` keys with ``use_queue``."""
    from eventpretrain_tpu_torch.models.ecdp_hub import make_key_encoder
    from eventpretrain_tpu_torch.objectives.ecdp import init_sample_queue
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_ecdp_step

    dev = next(model.parameters()).device
    schedule = cosine_warmup_schedule(1e-3 * TRAIN_BATCH / 256, 0.0, 1, 400,
                                      ECDP_STEPS)
    queue = None
    if use_queue:
        queue = tuple(init_sample_queue(torch.Generator(dev).manual_seed(i),
                                        256, ECDP_QUEUE, device=dev)
                      for i in (1, 2))
    state = TrainState(model, build_optimizer(model, weight_decay=0.05,
                                              betas=(0.9, 0.95)),
                       schedule, queue=queue,
                       key_encoder=make_key_encoder(model))
    step = make_ecdp_step(model, num_patches=model.num_patches,
                          use_queue=use_queue,
                          total_epochs=400, steps_per_epoch=ECDP_STEPS,
                          generator=torch.Generator(dev).manual_seed(0))
    return state, step


def ecdp_grad_group(name: str) -> str:
    """The part of an ECDP model a parameter belongs to: the backbone, a
    projector (``encoder.*``), a predictor or ``clip_emb_proj``."""
    parts = name.split(".")
    return ".".join(parts[:2] if parts[0] == "encoder" else parts[:1])


def first_update_gradient(state) -> list:
    """A list that the first update of ``state`` fills with the gradient
    it applies (after the clip, before AdamW): a dict of f32 vectors, each
    part's parameters (``ecdp_grad_group``) in their order, flattened; the
    hook then removes itself."""
    got = []
    named = list(state.module.named_parameters())

    def hook(optimizer, args, kwargs):
        parts = {}
        for name, p in named:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            parts.setdefault(ecdp_grad_group(name), []).append(
                g.float().flatten())
        got.append({k: torch.cat(v) for k, v in parts.items()})
        handle.remove()

    handle = state.optimizer.register_step_pre_hook(hook)
    return got


def rel_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|`` in the global 2-norm."""
    return ((a - b).norm() / b.norm()).item()


def grad_dists(gk, gp, g32) -> dict:
    """The kernel, plain and f32 paths' gradient vectors against each
    other (``rel_dist``) and the share of components whose signs agree."""
    sign = lambda a, b: (a.sign() == b.sign()).float().mean().item()
    return {"kernel_plain": rel_dist(gk, gp),
            "kernel_f32": rel_dist(gk, g32),
            "plain_f32": rel_dist(gp, g32),
            "sign_kernel_plain": sign(gk, gp),
            "sign_kernel_f32": sign(gk, g32),
            "sign_plain_f32": sign(gp, g32),
            "norm_f32": g32.norm().item()}


def ecdp_backbone_backward(models: list, batch: dict) -> dict:
    """The query backbone of each of the kernel, plain and f32 models
    (same weights), forward on ``batch``'s ``img_q`` at its mask and
    backward from one fixed random cotangent on the two token embeddings;
    the gradients are cleared after. Held as ``ECDP_HELD`` says, with the
    tokens' outputs within 2% of their scale; also reports how far the
    tokens differ across the batch, next to their size."""
    dev = batch["img_q"].device
    gen = torch.Generator(dev).manual_seed(5)
    outs, grads = [], []
    cts = None
    for model in models:
        bk = model.encoder.backbone
        bk.train()
        ev, im, _ = bk.encode_masked(batch["img_q"], batch["ids_keep_q"],
                                     batch["mask_q"])
        if cts is None:
            cts = [torch.randn(t.shape, generator=gen, device=dev)
                   for t in (ev, im)]
        ((ev.float() * cts[0]).sum() + (im.float() * cts[1]).sum()
         ).backward()
        outs.append(torch.stack([ev.float(), im.float()]).detach())
        grads.append(torch.cat([p.grad.float().flatten()
                                for p in bk.parameters()]))
        model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    out_rel = ((outs[0] - outs[1]).abs().max()
               / outs[1].abs().max()).item()
    x = outs[2]
    spread = ((x - x.mean(1, keepdim=True)).norm() / x.norm()).item()
    res = {"tokens_rel": out_rel, "tokens_spread_f32": spread,
           **grad_dists(*grads)}
    log("ecdp backbone under a fixed cotangent: " + json.dumps(res))
    require(out_rel <= LOSS_GAP_REL, "ecdp: the backbone's tokens leave the "
                                     "plain path's")
    require(res["kernel_plain"] <= ECDP_GRAD_REL,
            "ecdp: the backbone's gradients leave the plain path's")
    require(res["kernel_f32"] <= ECDP_WITNESS_RATIO * res["plain_f32"],
            "ecdp: the backbone's gradients are further from f32 than the "
            "plain bf16 path's allows")
    return res


def ecdp_witness(kern: list, plain: list, f32: list, grads: list) -> dict:
    """The ECDP steps against the f32 path (see ``ECDP_HELD``): ``grads``
    the step-0 gradients of the kernel, plain and f32 paths, by part;
    ``kern``, ``plain``, ``f32`` their steps' metrics."""
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
    whole = [torch.cat(list(g.values())) for g in grads]
    loss = {k: [m["loss"] for m in ms]
            for k, ms in (("kernel", kern), ("plain", plain), ("f32", f32))}
    out = {
        "grad": grad_dists(*whole),
        "grad_by_part": {k: grad_dists(*(g[k] for g in grads))
                         for k in grads[0]},
        "grad_norms": {k: [m["grad_norm"] for m in ms] for k, ms in (
            ("kernel", kern), ("plain", plain), ("f32", f32))},
        "losses_f32": loss["f32"],
        "loss_gaps_kernel_f32": rel(loss["kernel"], loss["f32"]),
        "loss_gaps_plain_f32": rel(loss["plain"], loss["f32"]),
    }
    del whole
    log("ecdp f32 witness: " + json.dumps(out))
    require(max(out["loss_gaps_kernel_f32"]) <= CON_LOSS_GAP_REL,
            "ecdp: the kernel path's loss leaves the f32 path's")
    g = out["grad"]
    require(g["kernel_f32"] <= ECDP_WITNESS_RATIO * g["plain_f32"],
            "ecdp: the kernel path's step-0 gradient is further from the "
            "f32 path's than the plain bf16 path's allows")
    return out


def ecdp_key_forward_only(key, batch) -> dict:
    """The key path alone, counted: its 12 blocks forward and no backward
    kernel."""
    from eventpretrain_tpu_torch.models.ecdp_hub import forward_key

    reset_counts()
    k = forward_key(key, batch["img_k"], batch["ids_keep_k"],
                    batch["mask_k"])
    torch.cuda.synchronize()
    launches = read_counts()
    require(not k.requires_grad, "the key path carries a gradient")
    require_launches("ecdp key path", launches, 1, {
        "fused_ln_attn_layer": ECDP_DEPTH, "fused_ln_mlp": ECDP_DEPTH})
    return launches


def phase_ecdp_training(dev, clip_tower) -> dict:
    """ViT-S ECDP at B=64: ``ECDP_STEPS`` steps on the kernel path
    (counted: K1/K2 24 + 24 forward, 12 + 12 backward a step) and the
    plain path from the same init, batches and masks, the loss gap of the
    first ``ECDP_HELD``, the backbone under a fixed cotangent
    (``ecdp_backbone_backward``), the steps against the f32 path
    (``ecdp_witness``), and both paths timed; the key path alone (12 + 12
    forward, no backward);
    the same steps against the two 65536-key queues (one path); the raw
    path (``EcdpRawPretrainPipeline`` at N-ImageNet's sensor, K3 2 a
    batch on the 224x224x2 canvas, CLIP's class token in the loop,
    counted with its steps); and ConvViT-S ECDP (K1/K2 22 + 22 forward,
    11 + 11 backward a step; one path)."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        ClipEncodingPipeline,
        EcdpRawPretrainPipeline,
        RawPretrainDataConfig,
        SyntheticRawPretrainSource,
    )
    from eventpretrain_tpu_torch.ops.splat import splat

    out = {"launches": {}, "records": {}}
    t0 = time.perf_counter()
    batches = ecdp_batches(dev, ECDP_STEPS)
    log(f"ecdp batches: {len(batches)} x img_q "
        f"{tuple(batches[0]['img_q'].shape)}, clip_emb "
        f"{tuple(batches[0]['clip_emb'].shape)} in "
        f"{time.perf_counter() - t0:.1f} s")
    model = build_ecdp(dev)
    plain_model = copy.deepcopy(model)
    set_fused(plain_model, False)
    f32_model = build_ecdp(dev, dtype=torch.float32)
    f32_model.load_state_dict(model.state_dict())
    set_fused(f32_model, False)
    state, step = make_ecdp_trainer(model)
    pstate, pstep = make_ecdp_trainer(plain_model)
    fstate, fstep = make_ecdp_trainer(f32_model)
    backbone = ecdp_backbone_backward([model, plain_model, f32_model],
                                      batches[0])
    grads = [first_update_gradient(s) for s in (state, pstate, fstate)]
    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    f32 = run_steps(fstep, fstate, batches)
    require(read_counts() == launches,
            "the plain or the f32 path launched a kernel")
    log(f"ecdp launches over {ECDP_STEPS} steps {launches}")
    for what, ms in (("kernel", kern), ("plain", plain)):
        log(f"ecdp image / event / kl losses, {what} path: " + " ".join(
            f"{m['loss_image']:.4f}/{m['loss_event']:.4f}/"
            f"{m['loss_kl']:.5f}" for m in ms))
    log("ecdp momentum " + " ".join(f"{m['ema_momentum']:.6f}"
                                     for m in kern))
    require_launches("ecdp", launches, ECDP_STEPS, ECDP_WANT)
    gap = loss_gap("ecdp", kern[:ECDP_HELD], plain[:ECDP_HELD],
                   CON_LOSS_GAP_REL)
    later = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(kern[ECDP_HELD:], plain[ECDP_HELD:])]
    log("ecdp later steps' loss gaps " + " ".join(f"{g:.3g}" for g in later))
    require(all(np.isfinite([m["loss"] for m in kern + plain + f32])),
            "non-finite ecdp loss")
    witness = ecdp_witness(kern, plain, f32, [g[0] for g in grads])
    del grads, f32_model, fstate, fstep
    key_launches = ecdp_key_forward_only(state.key_encoder, batches[0])
    runs, peak = timed_steps({True: (step, state), False: (pstep, pstate)},
                             batches, reps=REPS // 4)
    out["launches"]["ecdp_train"] = launches
    out["launches"]["ecdp_key_path"] = key_launches
    rec = {"model": "ecdp_model_small", "batch": TRAIN_BATCH,
           "reps": REPS // 2, "loss_gap": gap, "held_steps": ECDP_HELD,
           "later_loss_gaps": later, "f32_witness": witness,
           "backbone_cotangent": backbone,
           "losses": [m["loss"] for m in kern],
           **step_record(runs, peak, TRAIN_BATCH)}
    rec["profile"] = device_profile(lambda: step(state, batches[0]), 3)
    log(f"ecdp step B={TRAIN_BATCH}: kernel {rec['step_ms']:.4g} ms "
        f"({rec['peak_step_gib']:.3g} GiB above resident), plain "
        f"{rec['plain_step_ms']:.4g} ms; loss gap {gap:.3g}")
    log_profile(f"ecdp step B={TRAIN_BATCH}", rec["profile"])
    out["records"]["ecdp_train"] = rec
    del plain_model, pstate, pstep

    # the queues: the same model on, one path
    qstate, qstep = make_ecdp_trainer(model, use_queue=True)
    reset_counts()
    qm = run_steps(qstep, qstate, batches)
    launches = read_counts()
    ptrs = [q.ptr for q in qstate.queue]
    log(f"ecdp queue ({ECDP_QUEUE} keys): losses " + " ".join(
        f"{m['loss']:.5f}" for m in qm) + f"; pointers {ptrs}; launches "
        f"{launches}")
    require(all(np.isfinite([m["loss"] for m in qm])),
            "non-finite ecdp queue loss")
    require(ptrs == [ECDP_STEPS * TRAIN_BATCH % ECDP_QUEUE] * 2,
            f"the ecdp queues' pointers are {ptrs}")
    require_launches("ecdp queue", launches, ECDP_STEPS, ECDP_WANT)
    out["launches"]["ecdp_queue_train"] = launches
    out["records"]["ecdp_queue_train"] = {
        "model": "ecdp_model_small", "queue_length": ECDP_QUEUE,
        "losses": [m["loss"] for m in qm],
        **one_path_record("ecdp queue", qstep, qstate, batches)}
    del qstate, qstep

    # the raw path: the views' count images through K3, CLIP in the loop
    source = SyntheticRawPretrainSource(n=TRAIN_BATCH * ECDP_STEPS,
                                        hw=RAW_HW, num_events=RAW_EVENTS,
                                        seed=0)
    pipe = EcdpRawPretrainPipeline(
        source, RawPretrainDataConfig(num_bins=2, input_size=TRAIN_INPUT,
                                      fix_events_num=RAW_FIX_EVENTS),
        TRAIN_BATCH, train=True, seed=0, device=dev)
    rstate, rstep = make_ecdp_trainer(model)
    reset_counts()
    t0 = time.perf_counter()
    raw_batches, rm = [], []
    for batch in ClipEncodingPipeline(pipe, clip_tower, cls_only=True):
        raw_batches.append(batch)
        rm.append(rstep(rstate, batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    by_route = dict(splat.launches_by_route)
    rm = [{k: float(v) for k, v in m.items()} for m in rm]
    host_ms = pipe.host_seconds / pipe.batches * 1e3
    log(f"ecdp raw: {len(raw_batches)} batches of img_q "
        f"{tuple(raw_batches[0]['img_q'].shape)}, clip_emb "
        f"{tuple(raw_batches[0]['clip_emb'].shape)}; host build "
        f"{host_ms:.1f} ms a batch; pipeline, CLIP and steps {wall:.1f} s; "
        f"losses " + " ".join(f"{m['loss']:.5f}" for m in rm)
        + f"; launches {launches}, K3 by route {by_route}")
    require(len(raw_batches) == ECDP_STEPS, "ecdp raw: batches")
    require(all(np.isfinite([m["loss"] for m in rm])),
            "non-finite ecdp raw loss")
    require(by_route == {"cluster": 2 * ECDP_STEPS, "global": 0},
            f"ecdp raw: K3 took the routes {by_route}")
    require_launches("ecdp raw", launches, ECDP_STEPS,
                     {**ECDP_WANT, "splat": 2})
    out["launches"]["ecdp_raw_train"] = launches
    out["records"]["ecdp_raw_train"] = {
        "model": "ecdp_model_small", "host_batch_ms": host_ms,
        "epoch_wall_s": wall, "losses": [m["loss"] for m in rm],
        **one_path_record("ecdp raw", rstep, rstate, raw_batches)}
    del rstate, rstep, raw_batches, model, state, step

    # ConvViT-S ECDP: the tokens go in at stage 3
    cmodel = build_ecdp(dev, convvit=True)
    cstate, cstep = make_ecdp_trainer(cmodel)
    reset_counts()
    cm = run_steps(cstep, cstate, batches)
    launches = read_counts()
    log(f"convvit ecdp: losses " + " ".join(f"{m['loss']:.5f}" for m in cm)
        + f"; launches {launches}")
    require(all(np.isfinite([m["loss"] for m in cm])),
            "non-finite convvit ecdp loss")
    n = CONVVIT_ECDP_DEPTH
    require_launches("convvit ecdp", launches, ECDP_STEPS, {
        "fused_ln_attn_layer": 2 * n, "fused_ln_mlp": 2 * n,
        "fused_ln_attn_layer_bwd": n, "fused_ln_mlp_bwd": n})
    out["launches"]["convvit_ecdp_train"] = launches
    out["records"]["convvit_ecdp_train"] = {
        "model": "ecdp_model_convvit_small",
        "losses": [m["loss"] for m in cm],
        **one_path_record("convvit ecdp", cstep, cstate, batches)}
    return out


# ViT-ECDP-S finetuning on the 2-channel count image: the dense hub at
# drop-path 0.1 (rates linspace(0, 0.1, 12), the first 0), so block 0 takes
# K1/K2 and blocks 1-11 K4, at 198 tokens (the two learned tokens and 196
# patches)
ECDP_FT_SITE_RATES = np.repeat(np.linspace(0, CONVVIT_DROP, ECDP_DEPTH)[1:],
                               2)


def phase_ecdp_finetune(dev) -> dict:
    """ViT-ECDP-S, full width, drop-path 0.1, bf16, seed 0, ``--num_bins
    2``: semseg at DSEC's 440x640 and flow at MVSEC's 260x346, B=16, each
    batch's count image through K6 on the tiled layout (1 a step), K1/K2
    1 + 1 and K4 11 + 11 a step, against the plain path; each eval step
    K6 1 and K1/K2 12 each, against the plain path's on the same
    weights."""
    from eventpretrain_tpu_torch.models.dense_hub import (
        dense_hub_vit_ecdp_small,
    )

    def make_hub(task):
        return dense_hub_vit_ecdp_small(
            DENSE_CLASSES if task == "semseg" else 2, 2, dtype=torch.bfloat16,
            device=dev, generator=torch.Generator().manual_seed(0),
            drop_path_rate=CONVVIT_DROP, decode_dropout=DENSE_DROP)

    n = ECDP_DEPTH - 1
    return finetune_tasks(
        dev, "vit_ecdp", make_hub, ECDP_FT_SITE_RATES, CONVVIT_DROP,
        {"fused_ln_attn_layer": 1, "fused_ln_mlp": 1,
         "fused_ln_attn_layer_bwd": 1, "fused_ln_mlp_bwd": 1,
         "fused_attn_layer": n, "fused_attn_layer_bwd": n},
        {"fused_ln_attn_layer": ECDP_DEPTH, "fused_ln_mlp": ECDP_DEPTH},
        tasks=("semseg", "flow"), num_bins=2)


def phase_ecdp_cli(dev) -> None:
    """The CLIs: ``pretrain --pr_phase ecdp`` (ViT-S, the synthetic
    source, 4 steps at B=64, counted: K1/K2 24 + 24 forward, 12 + 12
    backward a step; its checkpoint with the EMA tree), then
    ``finetune_cls --backbone vit_ecdp --num_bins 2 --finetune`` from it
    (K3 on the 2-channel count image; 2 steps) and ``finetune_semseg
    --backbone vit_ecdp --num_bins 2`` (2 steps; its synthetic 64x64 sensor takes the untiled count image,
    K3)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_ecdp_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_cls import main as cls_main
    from eventpretrain_tpu_torch.cli.finetune_semseg import main as seg_main
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    common = ["--device", str(dev), "--print_freq", "1", "--epochs", "1"]
    out = os.path.join("build", "chip_smoke_ecdp")
    t0 = time.perf_counter()
    reset_counts()
    state = pretrain_main(common + [
        "--pr_phase", "ecdp", "--batch_size", str(TRAIN_BATCH),
        "--output_dir", out, "--input_size", str(TRAIN_INPUT)])
    launches = read_counts()
    ckpt = os.path.join(out, "checkpoint.pth")
    sd, ema = load_ecdp_checkpoint(ckpt)
    log(f"cli.pretrain --pr_phase ecdp: {state.step} steps in "
        f"{time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} + "
        f"{len(ema)} (EMA) tensors; launches {launches}")
    require(state.step == 4, f"the ecdp CLI ran {state.step} steps")
    require(set(sd) == set(state.module.state_dict())
            and set(ema) == set(state.key_encoder.state_dict()),
            "the ecdp checkpoint's keys are not the model's and the EMA's")
    require_launches("cli ecdp", launches, 4, ECDP_WANT)
    t0 = time.perf_counter()
    reset_counts()
    res = cls_main(common + [
        "--backbone", "vit_ecdp", "--num_bins", "2", "--batch_size",
        str(TRAIN_BATCH), "--finetune", ckpt,
        "--output_dir", os.path.join("build", "chip_smoke_ecdp_cls")])
    launches = read_counts()
    log(f"cli.finetune_cls --backbone vit_ecdp --num_bins 2 --finetune: "
        f"{res['state'].step} steps, val acc1 {res['val']['acc1']:.1f}, in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    require(res["state"].step == 128 // TRAIN_BATCH,
            f"the vit_ecdp cls CLI ran {res['state'].step} steps")
    require(np.isfinite(res["val"]["loss"]), "non-finite vit_ecdp cls loss")
    require(launches["splat"] >= 3 and launches["fused_attn_layer_bwd"] > 0,
            "the vit_ecdp cls CLI did not take K3 and K4")
    t0 = time.perf_counter()
    reset_counts()
    res = seg_main(common + [
        "--backbone", "vit_ecdp", "--num_bins", "2", "--batch_size",
        str(DENSE_BATCH), "--output_dir",
        os.path.join("build", "chip_smoke_ecdp_semseg")])
    launches = read_counts()
    log(f"cli.finetune_semseg --backbone vit_ecdp --num_bins 2: "
        f"{res['state'].step} steps in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    require(res["state"].step == 2, f"the vit_ecdp semseg CLI ran "
                                    f"{res['state'].step} steps")
    # the CLI's synthetic 64x64 sensor takes the untiled count image
    require(launches["splat"] >= 3,
            "the vit_ecdp semseg CLI did not take K3")


# --------------------------------------------------------------- phase 5l
#
# slice 5d: every on-disk reader and the MEM count image. The six cls
# sources read fixture trees written in their datasets' layouts at their
# true sensors; the DSEC and DDD17 readers need h5py and PIL, which the
# card's machine lacks, so the dense steps read the synthetic source at
# those readers' sensors.

FIXTURE_TRAIN = 128  # samples a class tree holds for training: 2 steps
FIXTURE_VAL = 64  # one eval batch of B=64 (a short one wraps once only)
FIXTURE_EVENTS = 30000  # finetune_cls.py's --fix_events_num
CLS_CAPACITY = FIXTURE_EVENTS + FIXTURE_EVENTS // 100
NCALTECH_HW = (180, 240)  # N-Caltech101's and UCF101-DVS's sensor
DDD17_HW = (200, 346)
DDD17_EVENTS = 80_000  # Ddd17Source's default, the CLI's --fix_events_num
DDD17_CLASSES = 6
READER_STEPS = 2
# each finetune_cls run: (dataset, --num_bins, the canvas K3 rasterises
# on, its planes)
READER_RUNS = (
    ("n_imagenet", 5, (TRAIN_INPUT, TRAIN_INPUT), 5),
    ("cifar10_dvs", 2, (TRAIN_INPUT, TRAIN_INPUT), 2),
    ("cifar10_dvs", 5, (128, 128), 5),
    ("n_caltech101", 3, NCALTECH_HW, 2),
    ("es_imagenet", 5, (224, 224), 5),
    ("dvs128_gesture", 5, (128, 128), 5),
    ("ucf101_dvs", 5, NCALTECH_HW, 5),
)


def write_cls_fixture(root: str, dataset: str, rng, n: int,
                      events: int = FIXTURE_EVENTS) -> None:
    """``n`` samples in 2 classes of ``dataset``'s on-disk layout under
    ``root`` (data/cls_sources.py), each of ``events`` random events at
    the dataset's true sensor; ES-ImageNet's label file beside its
    tree."""
    h, w = {"n_caltech101": NCALTECH_HW, "ucf101_dvs": NCALTECH_HW,
            "n_imagenet": RAW_HW, "es_imagenet": (254, 254)}.get(
                dataset, (128, 128))
    classes = ("2", "10") if dataset == "dvs128_gesture" else ("a", "b")
    labels = []
    for k in range(n):
        cls = classes[k % 2]
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        x = rng.integers(0, w, events).astype(np.int16)
        y = rng.integers(0, h, events).astype(np.int16)
        t = np.sort(rng.uniform(0.0, 0.1, events))
        p = rng.integers(0, 2, events).astype(np.uint8)
        name = os.path.join(d, f"{cls}_{k}")
        if dataset in ("n_caltech101", "cifar10_dvs"):
            np.save(name + ".npy", np.stack([x, y, t, p], -1)
                    .astype(np.float32))
        elif dataset == "n_imagenet":
            arr = np.zeros(events, dtype=[("x", "<u2"), ("y", "<u2"),
                                          ("t", "<i8"), ("p", "?")])
            arr["x"], arr["y"] = x, y
            arr["t"] = (t * 1e6).astype(np.int64)
            arr["p"] = p.astype(bool)
            np.savez(name + ".npz", event_data=arr)
        elif dataset == "dvs128_gesture":
            np.savez(name + ".npz", x=x, y=y, t=t.astype(np.float32), p=p)
        elif dataset == "es_imagenet":
            # (row, col, frame) of each polarity; the crop to 16..240
            # keeps about 78% of them
            frame = rng.integers(1, 9, events).astype(np.int16)
            half = events // 2
            np.savez(name + ".npz",
                     pos=np.stack([y, x, frame], -1)[:half],
                     neg=np.stack([y, x, frame], -1)[half:])
            labels.append(f"{cls}_{k}.npz 254 254 0\n")
        elif dataset == "ucf101_dvs":
            import scipy.io

            scipy.io.savemat(name + ".mat", {
                "x": x[:, None], "y": y[:, None], "ts": t[:, None],
                "pol": p[:, None]})
    if labels:
        with open(root + "_labels.txt", "w") as f:
            f.writelines(labels)


def reader_cli_runs(dev, base: str) -> dict:
    """``cli.finetune_cls.main`` (ViT-S, bf16, B=64, one epoch: 2 steps
    and one eval) on each fixture tree, counted: K3 a batch on the canvas
    and the route ``READER_RUNS`` name, the loss finite, N-ImageNet's
    variant evaluated (its printed line is held by the CPU test)."""
    from eventpretrain_tpu_torch.cli.finetune_cls import main as cls_main
    from eventpretrain_tpu_torch.ops.splat import splat, splat_route

    rng = np.random.default_rng(21)
    t0 = time.perf_counter()
    for dataset in sorted({r[0] for r in READER_RUNS}):
        for split, n in (("train", FIXTURE_TRAIN), ("val", FIXTURE_VAL)):
            write_cls_fixture(os.path.join(base, dataset, split), dataset,
                              rng, n)
    write_cls_fixture(os.path.join(base, "n_imagenet", "val_mode_1"),
                      "n_imagenet", rng, FIXTURE_VAL)
    log(f"fixture trees of {len(READER_RUNS) - 1} datasets, "
        f"{FIXTURE_TRAIN} + {FIXTURE_VAL} samples of {FIXTURE_EVENTS} "
        f"events each, written in {time.perf_counter() - t0:.1f} s")
    launches = {}
    for dataset, bins, canvas, planes in READER_RUNS:
        root = os.path.join(base, dataset)
        # DVS128's label is its directory's name: '10' needs 11 classes
        classes = 11 if dataset == "dvs128_gesture" else 2
        argv = ["--dataset", dataset, "--num_classes", str(classes),
                "--num_bins",
                str(bins), "--batch_size", str(TRAIN_BATCH), "--epochs",
                "1", "--print_freq", "1", "--device", str(dev),
                "--train_root", os.path.join(root, "train"),
                "--val_root", os.path.join(root, "val"), "--output_dir",
                os.path.join("build", f"chip_smoke_{dataset}_{bins}")]
        batches = FIXTURE_TRAIN // TRAIN_BATCH + 1
        if dataset == "n_imagenet":
            argv += ["--val_variant_roots", os.path.join(root, "val_mode_1")]
            batches += 1
        if dataset == "es_imagenet":
            argv += ["--es_train_label", os.path.join(root, "train")
                     + "_labels.txt", "--es_val_label",
                     os.path.join(root, "val") + "_labels.txt"]
        t0 = time.perf_counter()
        reset_counts()
        res = cls_main(argv)
        counts = read_counts()
        route = splat_route(TRAIN_BATCH, *canvas, planes)
        by_route = dict(splat.launches_by_route)
        log(f"cli.finetune_cls --dataset {dataset} --num_bins {bins}: "
            f"{res['state'].step} steps, val {res['val']}, in "
            f"{time.perf_counter() - t0:.1f} s; K3 {counts['splat']} on "
            f"{canvas[0]}x{canvas[1]}x{planes} {by_route}; launches "
            f"{counts}")
        require(res["state"].step == FIXTURE_TRAIN // TRAIN_BATCH,
                f"{dataset}: the CLI ran {res['state'].step} steps")
        require(np.isfinite(res["val"]["loss"]),
                f"{dataset}: non-finite val loss")
        require(counts["splat"] == by_route[route] == batches,
                f"{dataset} at {bins} bins: K3 {counts['splat']} "
                f"({by_route}), expected {batches} on the {route} route")
        require(counts["fused_attn_layer_bwd"]
                == CLS_K4_BLOCKS * FIXTURE_TRAIN // TRAIN_BATCH,
                f"{dataset}: the train steps did not take K4")
        if dataset == "n_imagenet":
            vm = res["variants"].get("val_mode_1", {})
            require(np.isfinite(vm.get("loss", np.nan))
                    and np.isfinite(vm.get("acc1", np.nan)),
                    "the N-ImageNet variant was not evaluated")
        launches[f"cls_cli_{dataset}_{bins}"] = counts
    return launches


def k3_held_row(dev, grid_hw, capacity: int, ecdp: bool, seed: int, smi,
                launches: dict, path: str) -> dict:
    """K3 at (64, planes, capacity) on ``grid_hw``: held against its plain
    version, then ``k3_timing``'s entry."""
    from eventpretrain_tpu_torch.ops.splat import splat, splat_reference

    y, x, wb = splat_args(np.random.default_rng(seed), TRAIN_BATCH, dev,
                          grid_hw, capacity, ecdp)
    hw = dict(height=grid_hw[0], width=grid_hw[1])
    err = (splat(y, x, wb, **hw)
           - splat_reference(y, x, wb, **hw)).abs().max().item()
    require(err <= SPLAT_ATOL, f"splat at {grid_hw}x{wb.shape[1]} disagrees "
                               "with splat_reference")
    del y, x, wb
    entry = k3_timing(dev, TRAIN_BATCH, grid_hw, capacity, smi, ecdp=ecdp)
    entry.update(max_abs_err=err, tol=SPLAT_ATOL,
                 launches_by_path={path: launches[path]["splat"]})
    return entry


def mem_representation_check(dev) -> dict:
    """The whole MEM representation, the hot pixels removed, on the card
    against the plain path's (the splats' plain versions): K3 at B=64 on
    N-Caltech101's 180x240 with ragged sensor boxes, and K6 at B=2 of
    DSEC's 440x640, each with a hot pixel."""
    from eventpretrain_tpu_torch.data.representations import (
        build_representation,
    )

    rng = np.random.default_rng(23)
    ev, counts, _ = make_events(rng, TRAIN_BATCH, NCALTECH_HW, CLS_CAPACITY,
                                out_of_frame=True)
    ev[:, :counts.min() // 20, :2] = (17, 9)  # a hot pixel, 5% of events
    sensor = np.tile(np.asarray(NCALTECH_HW, np.int32), (TRAIN_BATCH, 1))
    sensor[::2] -= (20, 40)
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         (("events", ev), ("counts", counts), ("sensor", sensor))}
    kw = dict(num_bins=3, height=NCALTECH_HW[0], width=NCALTECH_HW[1],
              sensor_hw=t["sensor"])
    got = build_representation(t["events"], t["counts"], **kw)
    with plain_splat():
        ref = build_representation(t["events"], t["counts"], **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    hot = bool((ref[:, 9, 17, 0] == 0).all())
    inp = dsec_tiled_inputs(np.random.default_rng(24), 2, dev)
    inp["events"][:, 1 << 14:1 << 15, :2] = torch.tensor(
        [300.0, 200.0], device=dev)
    tkw = dict(num_bins=3, height=DSEC_HW[0], width=DSEC_HW[1],
               tile_table=inp["table"], t_range=inp["t_range"],
               chunk_trange=inp["chunk_trange"])
    tgot = build_representation(inp["events"], None, **tkw)
    with plain_tiled_splat():
        tref = build_representation(inp["events"], None, **tkw)
    torch.cuda.synchronize()
    terr = (tgot - tref).abs().max().item()
    log(f"MEM representation (64, 3) on 180x240 through K3 against the "
        f"plain path: max_abs_err {err:.3g}, hot pixel zeroed {hot}; tiled "
        f"(2, 3) on 440x640 through K6: max_abs_err {terr:.3g} (tol "
        f"{SPLAT_ATOL}); nonzero cells {int((tref > 0).sum())}")
    require(err <= SPLAT_ATOL and terr <= SPLAT_ATOL,
            "the MEM representation leaves the plain path's")
    require(hot, "the hot pixel of the MEM image was not removed")
    require(int((tref > 0).sum()) > 0, "the tiled MEM image is empty")
    require(float(ref[..., 1].abs().max()) == 0.0,
            "the MEM image's middle channel is not zero")
    return {"max_abs_err": max(err, terr), "tol": SPLAT_ATOL}


def reader_dense_steps(dev, what: str, sensor_hw, events: int,
                       num_classes: int, num_bins: int) -> dict:
    """``READER_STEPS`` semseg steps of the ViT-S dense hub (B=16,
    drop-path and the heads' dropout 0.1, replayed) over ``DensePipeline``
    on the synthetic source at ``sensor_hw`` (tiled, K6), counted, and the
    plain path from the same init on the same wire data; the first step's
    loss within 2%."""
    import eventpretrain_tpu_torch.data.dense_pipeline as dense_data
    from eventpretrain_tpu_torch.models.dense_hub import dense_hub_vit_small

    hub = dense_hub_vit_small(
        num_classes, num_bins, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0),
        drop_path_rate=DENSE_DROP, decode_dropout=DENSE_DROP)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make_dense_trainer(hub, dev, READER_STEPS, num_classes)
    pstate, pstep = make_dense_trainer(plain_hub, dev, READER_STEPS,
                                       num_classes)
    pipe = dense_pipeline(dev, True, READER_STEPS, num_bins=num_bins,
                          sensor_hw=sensor_hw, events=events)
    rng = np.random.default_rng(25)
    sites = np.repeat(np.linspace(0, DENSE_DROP, DEPTH)[1:], 2)
    reset_counts()
    batches, kern = [], []
    with record_wire(dense_data) as wire:
        for batch in pipe:
            batch["drop_path_keep"] = torch.from_numpy(
                rng.random((len(sites), DENSE_BATCH)) < (1.0 - sites)[:, None]
            ).to(dev)
            batch["dropout_keep"] = [
                torch.from_numpy(rng.random((DENSE_BATCH, c))
                                 < 1.0 - DENSE_DROP).to(dev)
                for c in DENSE_DROPOUT_CHANNELS]
            batches.append(batch)
            kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    pbatches, evg_err = [], 0.0
    for i, batch in enumerate(batches):
        rebuilt = wire.rebuild_plain(i)
        evg_err = max(evg_err,
                      (rebuilt["evg"] - batch["evg"]).abs().max().item())
        pbatches.append({**batch, **rebuilt})
    plain = run_steps(pstep, pstate, pbatches)
    require(read_counts() == launches, "the plain path launched a kernel")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = abs(lk[0] - lp[0]) / abs(lp[0])
    log(f"{what}: {READER_STEPS} semseg steps at {sensor_hw}, {events} "
        f"events, {num_bins} bins, {num_classes} classes; loss kernel "
        f"{lk}, plain {lp}, first-step gap {gap:.3g} (bound "
        f"{LOSS_GAP_REL}); evg of K6 vs its plain version {evg_err:.3g}; "
        f"host build {pipe.host_seconds / pipe.batches * 1e3:.1f} ms a "
        f"batch; launches {launches}")
    require(all(np.isfinite([*lk, *lp])), f"{what}: non-finite loss")
    require(evg_err <= SPLAT_ATOL, f"{what}: the K6 input differs")
    require(gap <= LOSS_GAP_REL, f"{what}: the kernel path's first loss "
                                 "leaves the plain path's")
    per_step = {"splat_tiled": 1, "splat": 0,
                "fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS}
    for name, want in per_step.items():
        require(launches[name] == want * READER_STEPS,
                f"{what}: {name} {launches[name]} launches over "
                f"{READER_STEPS} steps, expected {want} a step")
    return {"launches": launches, "wire": wire.calls, "loss_gap": gap,
            "losses": lk, "plain_losses": lp}


def phase_readers(dev, smi) -> dict:
    """Phase 5l: the cls CLI on the six sources' fixture trees; K3 at
    180x240 (5 and 2 planes), the MEM representation and K6 at 200x346x5
    and 440x640x2 against their plain versions, one call and
    graph-timed; the DDD17-shape and the DSEC-shape MEM semseg steps."""
    import tempfile

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as base:
        launches = reader_cli_runs(dev, base)
    ddd17 = reader_dense_steps(dev, "DDD17 shape", DDD17_HW, DDD17_EVENTS,
                               DDD17_CLASSES, NUM_BINS)
    dsec = reader_dense_steps(dev, "DSEC shape, MEM", DSEC_HW, DSEC_EVENTS,
                              DENSE_CLASSES, 3)
    launches["ddd17_semseg_train"] = ddd17["launches"]
    launches["dsec_mem_semseg_train"] = dsec["launches"]
    mem = mem_representation_check(dev)
    k3 = [k3_held_row(dev, NCALTECH_HW, CLS_CAPACITY, ecdp, seed, smi,
                      launches, path)
          for ecdp, seed, path in (
              (False, 26, "cls_cli_ucf101_dvs_5"),
              (True, 27, "cls_cli_n_caltech101_3"))]
    k6 = []
    for what, run, hw, bins, path in (
            ("DDD17", ddd17, DDD17_HW, NUM_BINS, "ddd17_semseg_train"),
            ("DSEC MEM", dsec, DSEC_HW, 3, "dsec_mem_semseg_train")):
        args, kw = run["wire"][0]
        y, x, wb, table, br = k6_wire_inputs(args, kw, hw, bins)
        entry = k6_entry(y, x, wb, table, br, hw, smi)
        entry.update(path=path, launches_per_step=(
            launches[path]["splat_tiled"] / READER_STEPS))
        k6.append(entry)
        del y, x, wb, table, br
    return {"launches": launches, "k3_shapes": k3, "k6_shapes": k6,
            "mem": mem, "records": {
                "ddd17_semseg_train": {k: ddd17[k] for k in (
                    "loss_gap", "losses", "plain_losses")},
                "dsec_mem_semseg_train": {k: dsec[k] for k in (
                    "loss_gap", "losses", "plain_losses")}}}


# ---------------------------------------------------------------- phase 6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of operations
    over the bf16 tensor-core peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")


def k1_work(b, l, c, h, backward=False, ln=True) -> tuple[float, float]:
    """(FLOPs, bytes) of K1 (``ln``) or K4 on these shapes. Forward: qkv,
    per-head q.k and p.v, out projection; x in, y out, weights in.
    Backward: dWo, do, the attention backward (s recomputed, dp, dv, dq,
    dk), dWqkv, du; x, dy, the saved qkv and o in, dx and every gradient
    out."""
    m, d = b * l, c // h
    weights = (4 * c * c + 4 * c) * 2 + (2 * c * 4 if ln else 0)
    if not backward:
        return (2 * m * c * 4 * c + 4 * b * h * l * l * d,
                2 * m * c * 2 + weights)
    return (2 * m * c * 8 * c + 10 * b * h * l * l * d,
            (2 + 4 + 1) * m * c * 2 + 2 * weights)


def k2_work(b, l, c, backward=False, ln=True) -> tuple[float, float]:
    """(FLOPs, bytes) of K2 (``ln``) or K5. Forward: fc1 and fc2.
    Backward: the h_pre recompute, dW2, dh, dW1, du; x, dy in, dx and
    every gradient out."""
    m = b * l
    weights = (8 * c * c + 5 * c) * 2 + (2 * c * 4 if ln else 0)
    if not backward:
        return 2 * m * c * 8 * c, 2 * m * c * 2 + weights
    return 2 * m * c * 20 * c, 3 * m * c * 2 + 2 * weights


def device_profile(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: device time per
    kernel (the 10 largest), device time and host-clock wall time per call,
    and the device's busy share of the wall time (kernels and copies run on
    one stream, so their times add; the profiler's own host cost lengthens
    the wall time, so the share is a lower bound); and the host's self CPU
    time per op (the 8 largest), which says where a host-bound step
    spends its time; and the host-to-device copies per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per: dict[str, float] = {}
    host: dict[str, float] = {}
    htod = 0
    for e in prof.key_averages():
        if e.key.startswith("Memcpy HtoD"):
            htod += e.count
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
        # device work only: user-annotated ranges (Optimizer.step#..., with
        # a '#' where the flag is missing) carry the device time of the
        # kernels inside them, which are counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or "#" in e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per[e.key] = per.get(e.key, 0.0) + us / 1e3
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    # the GEMM's device time by layout (csrc/ln_gemm.cu: gemm_kernel<layout,
    # ...>; the weight gradient's split sum with its GEMMs)
    gemm = {"forward": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    for key, ms in per.items():
        layout = re.search(r"gemm_kernel<(\d)", key)
        if layout:
            gemm[("forward", "dgrad", "wgrad")[int(layout.group(1))]] += ms
        elif "split_sum_kernel" in key:
            gemm["wgrad"] += ms
    # the row kernels of csrc/ln_bwd.cu, each with its launches
    rows = {"ln_rows_kernel": [0.0, 0], "ln_bwd_kernel": [0.0, 0],
            "colsum_kernel": [0.0, 0]}
    for e in prof.key_averages():
        for name, acc in rows.items():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and re.search(rf"::{name}\b", e.key)):
                us = getattr(e, "self_device_time_total", None)
                acc[0] += (us if us is not None
                           else e.self_cuda_time_total) / 1e3
                acc[1] += e.count
    return {"calls": calls, "wall_ms": wall / calls,
            "device_ms": busy / calls,
            "busy_share": busy / wall if busy else None,
            "gemm_ms": {k: v / calls for k, v in gemm.items()},
            "rows_ms": {k: v[0] / calls for k, v in rows.items()},
            "rows_launches": {k: v[1] / calls for k, v in rows.items()},
            "top_ms": [[k[:90], v / calls] for k, v in top],
            "htod_copies": htod / calls,
            "host_ms": sum(host.values()) / calls,
            "top_host_ms": [[k[:90], v / calls] for k, v in top_host]}


def log_profile(what: str, prof: dict) -> None:
    if prof["busy_share"] is None:
        log(f"profile {what}: the profiler recorded no device time")
        return
    log(f"profile {what}: {prof['device_ms']:.4g} ms of device time in "
        f"{prof['wall_ms']:.4g} ms per call (busy {prof['busy_share']:.1%}), "
        f"{prof['htod_copies']:.3g} host-to-device copies per call")
    log("  the GEMM: " + ", ".join(
        f"{layout} {ms:.4g} ms ({ms / prof['device_ms']:.1%})"
        for layout, ms in prof["gemm_ms"].items()))
    log("  the row kernels: " + ", ".join(
        f"{name} {ms:.4g} ms in {prof['rows_launches'][name]:.4g} launches"
        for name, ms in prof["rows_ms"].items()))
    for name, ms in prof["top_ms"]:
        log(f"  {ms:9.4f} ms  {name}")
    log(f"  host: {prof['host_ms']:.4g} ms of self CPU time per call in "
        "the profiled ops; the largest:")
    for name, ms in prof["top_host_ms"]:
        log(f"  {ms:9.4f} ms  {name}")


def time_pair(fn, plain, calls: int = 1) -> tuple[float, float]:
    """plain, kernel, kernel, plain: both see the same clocks."""
    p1, k1, k2, p2 = (cuda_ms(f, calls=calls)
                      for f in (plain, fn, fn, plain))
    return min(k1, k2), min(p1, p2)


def timed_steps(paths: dict, batches: list, reps: int = REPS // 2
                ) -> tuple[dict, dict]:
    """Host-clock ms of ``step(state, batch)`` calls on each path in turns
    (plain, kernel, kernel, plain; a path ``paths`` lacks is left out),
    ``reps`` a turn, each call a real update of its own path's state; and
    the peak device memory a step adds above what is resident, in GiB."""
    runs = {fused: [] for fused in paths}
    peak = {}
    for fused in (False, True, True, False):
        if fused not in paths:
            continue
        step, state = paths[fused]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls = [0]

        def one_step():
            calls[0] += 1
            return step(state, batches[calls[0] % len(batches)])

        runs[fused] += host_ms(one_step, reps=reps, warmup=2)
        peak[fused] = max(peak.get(fused, 0.0),
                          (torch.cuda.max_memory_allocated() - base) / 2**30)
    return runs, peak


def step_record(runs: dict, peak: dict, batch: int) -> dict:
    out = {}
    for fused, key in ((True, ""), (False, "plain_")):
        if fused not in runs:
            continue
        q1, med, q3 = statistics.quantiles(runs[fused], n=4)
        out.update({
            f"{key}step_ms": med, f"{key}step_ms_q1": q1,
            f"{key}step_ms_q3": q3,
            f"{key}samples_per_s": batch / med * 1e3,
            f"{key}peak_step_gib": peak[fused],
        })
    return out


GEMM_TIMED = {}  # (layout, M, N, K, epilogue, gelu_out) -> its row


def gemm_rows(dev, kind, b, l, c, backward, smi) -> list:
    """The GEMM sub-table of a K1/K2/K4/K5 row: each GEMM launch of one
    call at its shape, timed from a CUDA graph of 10 calls (the card's time
    without the wrapper's host work) in turns with one ``torch.matmul`` in
    the same layout (matmul, kernel, kernel, matmul), beside its bound; for
    K1's and K2's forward first the LayerNorm rows' pass (``ln_rows``) and
    its share of the GEMM it feeds. A launch shared by two rows is timed
    once."""
    from eventpretrain_tpu_torch.ops import common as cm

    gen = torch.Generator().manual_seed(17)
    rows = []
    for name, *key in gemm_launches(kind, b, l, c, backward):
        key = tuple(key)
        if key not in GEMM_TIMED:
            layout, m, n, k, epi, go = key
            fn, _, matmul = gemm_case(gen, dev, *key)
            m1, k1, k2, m2 = (graph_ms(f) for f in (matmul, fn, fn, matmul))
            flops, nbytes = gemm_work(*key)
            bms, bby = bound(flops, nbytes)
            row = {"layout": ("forward", "dgrad", "wgrad")[layout],
                   "epilogue": epi, "gelu_out": go, "shape": [m, n, k],
                   "gflop": flops / 1e9, "bytes": nbytes, "bound_ms": bms,
                   "bound_by": bby, "ms": min(k1, k2),
                   "matmul_ms": min(m1, m2)}
            if layout == cm.LAYOUT_WGRAD:
                splits, chunk = cm.plan_wgrad_split(
                    m, n, k, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                row.update(splits=splits, chunk=chunk,
                           scratch_mb=(4 * splits * m * n / 1e6
                                       if splits > 1 else 0.0))
            GEMM_TIMED[key] = row
            del fn, matmul
            ratio = row["ms"] / row["matmul_ms"]
            log(f"time gemm {name} {row['layout']} ({m},{n},{k}) epi {epi}"
                f": kernel {row['ms']:.4g} ms, matmul "
                f"{row['matmul_ms']:.4g} ms ({ratio:.3g}x), bound "
                f"{bms:.4g} ms ({bby}), {flops / row['ms'] / 1e9:.0f} "
                f"TFLOP/s ({smi})")
        rows.append({"name": name, **GEMM_TIMED[key]})
    if kind in ("K1", "K2") and not backward:
        # the LayerNorm rows the first GEMM reads: their own pass, beside
        # the GEMM they feed
        a = _subblock_inputs(gen, b, l, c, dev)
        x2 = a["x"].view(b * l, c)
        ln_ms = graph_ms(lambda: cm.ln_rows(x2, a["ln_w"], a["ln_b"], 1e-6))
        nbytes = 2 * 2 * b * l * c + 2 * 4 * c
        bms, bby = bound(0.0, nbytes)
        share = ln_ms / rows[0]["ms"]
        rows.insert(0, {"name": "ln_rows", "shape": [b * l, c],
                        "bytes": nbytes, "bound_ms": bms, "bound_by": bby,
                        "ms": ln_ms, "share_of_gemm": share})
        log(f"time ln_rows ({b * l}, {c}): {ln_ms:.4g} ms, bound {bms:.4g} "
            f"ms ({bby}), {share:.1%} of the {rows[1]['name']} GEMM it feeds "
            f"({smi})")
    return rows


# The row kernels' shapes on the main paths at B=64, (M, C): the rec
# step's decoder and ViT-B encoder, ViT-S (cls, and the dense hub's block
# 0); a column sum runs at N = C, 3C and 4C of each
ROW_TIMED = ((12544, 512), (3136, 768), (12544, 384), (12544, 768))
PEAK_F32 = 67e12  # the card's f32 rate outside the tensor cores


def row_rows(dev, errs, launches, smi) -> list:
    """The rows of ``ln_backward``, ``colsum`` and ``ln_rows``
    (csrc/ln_bwd.cu): launches on every main path (the ``rows`` of each
    path's counts), each kernel at each main-path shape graph-timed (a CUDA
    graph of 10 calls: the card alone, without the wrapper's host work) in
    turns with its plain version (plain, kernel, kernel, plain), also over
    10 calls an event pair, beside its bound (bytes over the memory rate,
    or f32 operations over the f32 rate) and one PyTorch call of the same
    function where there is one."""
    import torch.nn.functional as F

    from eventpretrain_tpu_torch.ops import common as cm

    gen = torch.Generator().manual_seed(19)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def ln_bwd_case(m, c):
        x, dy, d_yln = rnd(m, c), rnd(m, c), rnd(m, c, dtype=torch.float32)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        return (lambda: cm.ln_backward(x, g, 1e-6, dy, d_yln),
                lambda: cm.ln_backward_reference(x, g, 1e-6, dy, d_yln),
                None, 16 * m * c, 10 * m * c + 12 * c)

    def colsum_case(m, n):
        t = rnd(m, n)
        return (lambda: cm.colsum(t),
                lambda: t.float().sum(0).to(torch.bfloat16),
                lambda: torch.sum(t, 0, dtype=torch.float32), m * n,
                2 * m * n + 2 * n)

    def ln_rows_case(m, c):
        x = rnd(m, c)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        b = (0.1 * torch.randn(c, generator=gen)).to(dev)
        g16, b16 = g.to(torch.bfloat16), b.to(torch.bfloat16)
        return (lambda: cm.ln_rows(x, g, b, 1e-6),
                lambda: cm.ln_forward(x, g, b, 1e-6),
                lambda: F.layer_norm(x, (c,), g16, b16, 1e-6), 8 * m * c,
                4 * m * c + 8 * c)

    csrc = "eventpretrain_tpu_torch/csrc/ln_bwd.cu"
    specs = [
        ("ln_backward", "eventpretrain_tpu/ops/fused_attn_layer.py:348 "
         "(K1 _ln_bwd_kernel's LN tail :348-354; K2 fused_mlp.py:320-326, "
         ":451-456)", ln_bwd_case, list(ROW_TIMED),
         "none: no PyTorch call takes bf16 rows with an f32 gradient of the "
         "normalised rows and adds the residual's gradient "
         "(native_layer_norm_backward takes one dtype and returns no sum "
         "with dy)"),
        ("colsum", "eventpretrain_tpu/ops/fused_attn_layer.py:132 (dbo; "
         "dbqkv :169; K2/K5 fused_mlp.py:134, :144, :285, :312, :437, :445)",
         colsum_case, [(m, k * c) for m, c in ROW_TIMED for k in (1, 3, 4)],
         "torch.sum(x, 0, dtype=torch.float32)"),
        ("ln_rows", "eventpretrain_tpu/ops/fused_attn_layer.py:322 (K1 "
         "_ln_fwd_kernel's LN, pallas_common.py:68; K2 fused_mlp.py:261; "
         "both backwards' recompute :341, :284)", ln_rows_case,
         [(12544, 384), (3136, 768), (12544, 512), (12544, 768)],
         "F.layer_norm (bf16 weight and bias)"),
    ]
    out = []
    for name, replaces, case, shapes, library in specs:
        per_shape = []
        for m, n in shapes:
            fn, plain, lib_fn, flops, nbytes = case(m, n)
            p1, k1, k2, p2 = (graph_ms(f) for f in (plain, fn, fn, plain))
            t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
            entry = {"shape": [m, n], "ms": min(k1, k2),
                     "event_ms": cuda_ms(fn, calls=10),
                     "plain_ms": min(p1, p2),
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": graph_ms(lib_fn) if lib_fn else None,
                     "flops": flops, "bytes": nbytes}
            per_shape.append(entry)
            del fn, plain, lib_fn
            log(f"time {name} ({m}, {n}): kernel {entry['ms'] * 1e3:.4g} us "
                f"(graph; {entry['event_ms'] * 1e3:.4g} us over 10 calls an "
                f"event pair), plain {entry['plain_ms'] * 1e3:.4g} us, bound "
                f"{entry['bound_ms'] * 1e3:.4g} us ({entry['bound_by']}, "
                f"{entry['bound_ms'] / entry['ms']:.1%} of it)"
                + (f", library {entry['library_ms'] * 1e3:.4g} us"
                   if entry["library_ms"] is not None else "")
                + f" ({smi})")
        total = sum(launches[p].rows[name] for p in launches)
        require(total > 0, f"{name}: no main path launched it")
        for p in launches:
            want = row_launches_expected(launches[p])[name]
            require(launches[p].rows[name] == want,
                    f"{p}: {name} launched {launches[p].rows[name]} times, "
                    f"its sub-blocks imply {want}")
        head = per_shape[0]
        err, tol = errs.get(name, (None, None))
        out.append({
            "name": name, "route": "cuda", "source": csrc, "also": [],
            "replaces": replaces, "launches": total,
            "launches_by_path": {p: launches[p].rows[name]
                                 for p in launches},
            "max_abs_err": err, "tol": tol,
            "ms": head["ms"], "timing": "CUDA graph of 10 calls",
            "event_ms": head["event_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": library,
            "shape": head["shape"], "flops": head["flops"],
            "bytes": head["bytes"], "shapes": per_shape[1:],
        })
    return out


def k6_entry(y, x, wb, table, bins, hw, smi) -> dict:
    """K6 on one batch's operands (``bins`` the chunks' bin ranges, or
    None): held against its plain version, then timed beside it (one call
    an event pair, and from a CUDA graph of 10 calls), beside one
    ``index_put_`` of the whole batch, and its bound. The bound counts the
    bytes this data needs: the coordinates of every slot, the weights of
    the channels inside each chunk's bin range, the table and the ranges,
    and the grid written once."""
    from eventpretrain_tpu_torch.native import TILE_CHUNK
    from eventpretrain_tpu_torch.ops.splat_tiled import (
        splat_tiled,
        splat_tiled_reference,
    )

    h, w = hw
    kw = dict(height=h, width=w)
    b, c, e = wb.shape

    def fn():
        return splat_tiled(y, x, wb, table, bins, **kw)

    def plain():
        return splat_tiled_reference(y, x, wb, table, bins, **kw)

    got, ref = fn(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    require(err <= SPLAT_ATOL, f"splat_tiled at B={b} on {h}x{w}x{c} "
                               "disagrees with its plain version")
    del got, ref
    ms, plain_ms = time_pair(fn, plain)
    device_ms = graph_ms(fn)
    if bins is None:
        in_range = b * c * e
    else:
        ch = torch.arange(c, device=bins.device)[None, None]
        in_range = int(((ch >= bins[..., :1]) & (ch <= bins[..., 1:]))
                       .sum()) * TILE_CHUNK
    nbytes = (8 * b * e + 4 * in_range + 4 * table.numel()
              + (0 if bins is None else 4 * bins.numel())
              + 4 * b * h * w * c)
    bms, bby = bound(in_range, nbytes)
    entry = {"shape": [b, c, e], "sensor": [h, w],
             "bin_range": bins is not None, "max_abs_err": err, "ms": ms,
             "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": bby, "flops": in_range, "bytes": nbytes}
    # the library call: index_put_(accumulate=True) of the whole batch, on
    # the cells and weights the plain version selects (the bin ranges skip
    # only zero weights: the same function either way)
    tiles_x = -(-w // 128)
    tile = table.long().repeat_interleave(TILE_CHUNK, dim=1)
    ty0, tx0 = tile // tiles_x * 128, tile % tiles_x * 128
    yl, xl = y.long(), x.long()
    ok = ((yl >= ty0) & (yl < ty0 + 128) & (xl >= tx0) & (xl < tx0 + 128)
          & (yl < h) & (xl < w))
    cell = ((torch.arange(b, device=y.device)[:, None] * h + yl) * w
            + xl)[ok]
    vals = wb.transpose(1, 2)[ok]
    acc = torch.zeros((b * h * w, c), device=y.device)
    entry["library_ms"] = cuda_ms(
        lambda: acc.index_put_((cell,), vals, accumulate=True))
    del tile, ty0, tx0, ok, cell, vals, acc
    log(f"time splat_tiled B={b} {h}x{w}x{c} bin_range={bins is not None}: "
        f"kernel {ms:.4g} ms (graph-timed {device_ms * 1e3:.4g} us), plain "
        f"{plain_ms:.4g} ms, index_put_ {entry['library_ms']:.4g} ms, bound "
        f"{bms:.4g} ms ({bby}) ({smi})")
    return entry


def k6_row(dense, flow, errs, total, launches, smi, more=()) -> dict:
    """K6 on the main paths' own inputs: the first semseg batch's wire data
    (B=16, DSEC's 440x640), with and without bin ranges, and the first flow
    batch's (B=16, MVSEC's 260x346, partial tiles), with them; each entry
    of ``k6_entry``. ``more``: entries measured elsewhere (phase 5l)."""
    row = {"name": "splat_tiled", "route": "cuda",
           "source": "eventpretrain_tpu_torch/csrc/splat_tiled.cu",
           "also": ["eventpretrain_tpu_torch/csrc/splat_core.cuh"],
           "replaces": "eventpretrain_tpu/ops/pallas_voxel.py:403",
           "launches": total["splat_tiled"],
           "launches_by_path": {p: launches[p]["splat_tiled"]
                                for p in launches},
           "max_abs_err": errs["splat_tiled"][0],
           "tol": errs["splat_tiled"][1],
           "library": "index_put_(accumulate=True)", "shapes": []}
    for path, (args, kw), hw, modes in (
            ("semseg_train", dense["wire"][0], DSEC_HW, (True, False)),
            ("flow_train", flow["wire"][0], MVSEC_HW, (True,))):
        y, x, wb, table, br = k6_wire_inputs(args, kw, hw)
        for with_bins in modes:
            entry = k6_entry(y, x, wb, table, br if with_bins else None, hw,
                             smi)
            entry.update(path=path, launches_per_step=(
                launches[path]["splat_tiled"]
                / (DENSE_STEPS if path == "semseg_train" else FLOW_STEPS)))
            row["max_abs_err"] = max(row["max_abs_err"], entry["max_abs_err"])
            if path == "semseg_train" and with_bins:
                row.update({k: entry[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", "sensor", "flops", "bytes")})
            else:
                row["shapes"].append(entry)
    for entry in more:
        row["shapes"].append(entry)
        row["max_abs_err"] = max(row["max_abs_err"], entry["max_abs_err"])
    return row


K7_TIME_SHAPES = ((64, 196, 16, 32), (64, 196, 12, 32), (64, 49, 12, 64))


def k7_work(b, l, h, d, backward=False) -> tuple[float, float]:
    """(FLOPs, bytes) of K7: forward q.k and p.v, q, k, v in and o out;
    backward s recomputed, dp, dv, dq, dk, and q, k, v, o, do in, dq, dk,
    dv out."""
    if backward:
        return 10 * b * h * l * l * d, 14 * b * h * l * d
    return 4 * b * h * l * l * d, 8 * b * h * l * d


# calls per event pair when the attention core and K7 are timed: their
# forwards are shorter than their wrappers' host work at some shapes
CORE_CALLS = 10
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_times(qh, kh, vh, doh, scale, backward) -> dict:
    """``F.scaled_dot_product_attention`` on (B, H, L, D) q, k, v (forward;
    forward-graph backward for ``doh``), ``CORE_CALLS`` calls per event
    pair: the default call's ms and the backend it picks, then each
    backend's ms under ``torch.nn.attention.sdpa_kernel`` (None where the
    backend refuses the shape)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def timed():
        if not backward:
            return cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=scale), calls=CORE_CALLS)
        q_, k_, v_ = (t.detach().requires_grad_() for t in (qh, kh, vh))
        out = F.scaled_dot_product_attention(q_, k_, v_, scale=scale)
        return cuda_ms(lambda: torch.autograd.grad(
            out, (q_, k_, v_), doh, retain_graph=True), calls=CORE_CALLS)

    times = {"default": timed(), "default_backend": None}
    if hasattr(torch, "_fused_sdp_choice"):
        times["default_backend"] = SDPBackend(torch._fused_sdp_choice(
            qh, kh, vh, scale=scale)).name
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                times[name] = timed()
        except RuntimeError as err:  # the backend does not take the shape
            log(f"  sdpa {name} refuses {list(qh.shape)}: "
                f"{str(err).splitlines()[0][:120]}")
            times[name] = None
    return times


def sdpa_text(times: dict) -> str:
    return ", ".join(
        [f"sdpa {times['default']:.4g} ms ({times['default_backend']})"]
        + [f"{n.split('_')[0].lower()} "
           + ("refused" if times[n] is None else f"{times[n]:.4g}")
           for n in SDPA_BACKENDS])


def k7_rows(dev, errs, total, launches, smi) -> list:
    """K7 forward and backward at the MAE decoder's, ViT-S's and the ViT-B
    encoder's attention shapes at B=64: each held against its plain version
    on its inputs, then timed beside it, ``CORE_CALLS`` calls per event pair
    as the attention core, and beside ``F.scaled_dot_product_attention`` on
    the same values in its own (B, H, L, D) layout (forward; forward-graph
    backward) by default and under each backend, with its bound and the
    route each call took. The forward is timed through ``fused_mha``, the
    backward from the forward's saved statistics."""
    from eventpretrain_tpu_torch.ops import fused_mha as km

    gen = torch.Generator().manual_seed(13)
    rows = []
    for name, backward, replaces in (
            ("fused_mha", False,
             "eventpretrain_tpu/ops/pallas_attention.py:91"),
            ("fused_mha_bwd", True,
             "eventpretrain_tpu/ops/pallas_attention.py:104")):
        per_shape = []
        for b, l, h, d in K7_TIME_SHAPES:
            q, k, v, dy = k7_args(gen, b, l, h, d, dev)
            kw = dict(scale=d ** -0.5)
            if backward:
                _, stats, _ = km._forward_cuda(q, k, v, kw["scale"])

                def fn():
                    return km._backward_cuda(q, k, v, dy, kw["scale"],
                                             stats)[0]

                def plain():
                    return km.fused_mha_bwd_reference(q, k, v, dy, **kw)
            else:
                def fn():
                    return km.fused_mha(q, k, v, **kw)

                def plain():
                    return km.fused_mha_reference(q, k, v, **kw)
            shape = [b, l, h, d]
            route = km.mha_route(l, d, (q, k, v, dy) if backward
                                 else (q, k, v), backward)
            err, rel, tol = hold(name, shape, fn(), plain(),
                                 K7_GRAD_NAMES if backward else ("y",))
            prev = errs[name]
            errs[name] = ((max(prev[0], err), SUBBLOCK_REL_TOL,
                           max(prev[2], rel)) if backward
                          else (max(prev[0], err), max(prev[1], tol)))
            ms, plain_ms = time_pair(fn, plain, calls=CORE_CALLS)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = sdpa_times(qh, kh, vh, dy.transpose(1, 2).contiguous(),
                              kw["scale"], backward)
            flops, nbytes = k7_work(b, l, h, d, backward)
            bms, bby = bound(flops, nbytes)
            per_shape.append({
                "shape": shape, "k7_route": route, "max_abs_err": err,
                "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": bby, "flops": flops,
                "bytes": nbytes, "library_ms": sdpa["default"],
                "sdpa": sdpa})
            log(f"time {name} {shape} ({route}): kernel {ms:.4g} ms, plain "
                f"{plain_ms:.4g} ms, {sdpa_text(sdpa)}, bound {bms:.4g} ms "
                f"({bby}) ({smi})")
        err, tol = errs[name][:2]
        head = per_shape[0]
        csrc = "eventpretrain_tpu_torch/csrc/"
        rows.append({
            "name": name, "route": "cuda", "source": csrc + "mha.cu",
            "also": [csrc + "attention_core.cuh", csrc + "mma.cuh"],
            "replaces": replaces, "launches": total[name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "launches_by_k7_route": {
                r: n for r, n in K7_PATH_ROUTES.items()
                if r.startswith(name + "[")},
            "max_abs_err": err, "tol": tol,
            **({"max_rel_err": errs[name][2],
                "tol_is": "max_rel_err, of each gradient's scale"}
               if backward else {}),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape", "flops", "bytes",
                                    "k7_route", "sdpa")},
            "calls_per_event_pair": CORE_CALLS,
            "library": "F.scaled_dot_product_attention"
                       + (" + autograd.grad" if backward else ""),
            "ptxas": {k: v for k, v in PTXAS.items()
                      if k.startswith("mha:")},
            "shapes": per_shape[1:],
        })
    return rows


def core_rows(dev, errs, total, smi) -> list:
    """The attention core of K1/K4 alone, forward and backward, at the main
    paths' four shapes: held against the plain attention core on its
    inputs, then timed beside it and beside ``F.scaled_dot_product_attention``
    on the same q, k, v in its own (B, H, L, D) layout (forward;
    forward-graph backward; by default and under each backend), with K7's
    bound (the same work). Each is timed over ``CORE_CALLS`` calls in a row
    (K7's rows too; the other kernel rows over one call each). Its launches
    are those of the K1 and K4 calls on the main paths (one core launch
    each), and each kernel's registers and spills are ptxas's."""
    from eventpretrain_tpu_torch.ops import fused_attn_layer as ka

    gen = torch.Generator().manual_seed(16)
    rows = []
    for name, backward, source in (
            ("attention_core", False, "attention.cu"),
            ("attention_core_bwd", True, "attention_bwd.cu")):
        per_shape = []
        for b, l, h, d in CORE_MAIN_SHAPES:
            c, scale = h * d, d ** -0.5
            qkv, do = core_args(gen, b, l, h, d, dev)
            if backward:
                def fn():
                    return ka._attention_bwd(qkv, do, b, l, h, scale)

                def plain():
                    return ka.attention_core_bwd_reference(qkv, do, b, l, h,
                                                           scale)
            else:
                def fn():
                    return ka._attention(qkv, b, l, h, scale)

                def plain():
                    return ka.attention_core_reference(qkv, b, l, h, scale)
            shape = [b, l, h, d]
            if backward:
                err, rel, _ = hold(name, shape, fn().split(c, -1),
                                   plain().split(c, -1), K7_GRAD_NAMES)
            else:
                err, rel, _ = hold(name, shape, fn(), plain())
            ms, plain_ms = time_pair(fn, plain, calls=CORE_CALLS)
            qh, kh, vh = (t.contiguous() for t in qkv.view(
                b, l, 3, h, d).permute(2, 0, 3, 1, 4))
            sdpa = sdpa_times(qh, kh, vh, do.view(b, l, h, d).transpose(
                1, 2).contiguous(), scale, backward)
            flops, nbytes = k7_work(b, l, h, d, backward)
            bms, bby = bound(flops, nbytes)
            per_shape.append({
                "shape": shape, "max_abs_err": err, "max_rel_err": rel,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": bby, "flops": flops, "bytes": nbytes,
                "library_ms": sdpa["default"], "sdpa": sdpa})
            log(f"time {name} {shape}: kernel {ms:.4g} ms, plain "
                f"{plain_ms:.4g} ms, {sdpa_text(sdpa)}, bound {bms:.4g} ms "
                f"({bby}) ({smi})")
        layers = (("fused_ln_attn_layer_bwd", "fused_attn_layer_bwd")
                  if backward else ("fused_ln_attn_layer", "fused_attn_layer"))
        head = per_shape[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": "eventpretrain_tpu_torch/csrc/" + source,
            "replaces": ("eventpretrain_tpu/ops/fused_attn_layer.py:142"
                         if backward else
                         "eventpretrain_tpu/ops/fused_attn_layer.py:83"),
            "launches": sum(total[k] for k in layers),
            "max_abs_err": errs[name][0], "tol": errs[name][1],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape", "flops", "bytes",
                                    "sdpa")},
            "calls_per_event_pair": CORE_CALLS,
            "library": "F.scaled_dot_product_attention"
                       + (" + autograd.grad" if backward else ""),
            "ptxas": {k: v for k, v in PTXAS.items()
                      if k.startswith(source.split(".")[0] + ":")},
            "shapes": per_shape[1:],
        })
    return rows


def k8_row(dev, errs, total, launches, smi) -> dict:
    """K8 at DSEC's shape (B=16, 200000 events, 440x640x5) and at N-Cars'
    (B=64, 30000 events, 128x128x5): held against its plain version, then
    timed beside it and beside K3's ``voxelize_batch`` (the same function:
    PyTorch bin weights, then the splat), one call an event pair and from
    a CUDA graph of 10 calls (``device_ms``, the card alone); no single
    PyTorch call computes it. The bound counts the bytes this data needs:
    the events below each count read once (16 bytes), the counts, the grid
    written once. With ptxas's registers and spills, the plan, and the
    CTAs of the kernel the card holds at once."""
    from eventpretrain_tpu_torch.ops.splat import (
        SCATTER_CHUNK,
        voxel_scatter_device,
        voxel_scatter_plan,
        voxelize_batch,
        voxelize_batch_scatter,
        voxelize_batch_scatter_reference,
    )

    l2_bytes, sms, per_sm = voxel_scatter_device(dev.index or 0)
    row = {"name": "voxelize_batch_scatter", "route": "cuda",
           "source": "eventpretrain_tpu_torch/csrc/voxel_scatter.cu",
           "also": [], "replaces": "eventpretrain_tpu/ops/pallas_voxel.py:97",
           "launches": total["voxelize_batch_scatter"],
           "launches_by_path": {p: launches[p]["voxelize_batch_scatter"]
                                for p in launches},
           "max_abs_err": errs["voxelize_batch_scatter"][0],
           "tol": errs["voxelize_batch_scatter"][1],
           "library": None, "resident_ctas": sms * per_sm,
           "l2_bytes": l2_bytes,
           "ptxas": {k: v for k, v in PTXAS.items()
                     if k.startswith("voxel_scatter:")},
           "shapes": []}
    rng = np.random.default_rng(14)
    for batch, events, grid in ((DENSE_BATCH, K8_PATH_EVENTS, DSEC_HW),
                                (TRAIN_BATCH, EVENTS, CANVAS)):
        ev, counts, kw = k8_inputs(rng, batch, events, grid, dev)

        def fn():
            return voxelize_batch_scatter(ev, counts, **kw)

        def plain():
            return voxelize_batch_scatter_reference(ev, counts, **kw)

        err = (fn() - plain()).abs().max().item()
        require(err <= SPLAT_ATOL, f"voxelize_batch_scatter at B={batch} "
                                   "disagrees with its plain version")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ms, plain_ms = time_pair(fn, plain)
        device_ms = min(graph_ms(fn), graph_ms(fn))
        k3_ms = cuda_ms(lambda: voxelize_batch(ev, counts, **kw))
        read = int(counts.clamp(max=events).sum())
        nbytes = 16 * read + 4 * batch + 4 * batch * grid[0] * grid[1] * NUM_BINS
        bms, bby = bound(0, nbytes)
        plan = voxel_scatter_plan(batch, *grid, NUM_BINS, events,
                                  chunk=SCATTER_CHUNK, l2_bytes=l2_bytes,
                                  sms=sms)
        entry = {"shape": [batch, events, grid[0], grid[1], NUM_BINS],
                 "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                 "flops": 0, "bytes": nbytes, "library_ms": None,
                 "k3_voxelize_ms": k3_ms, "plan": plan.__dict__}
        if "ms" not in row:
            row.update({k: entry[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape", "flops", "bytes", "k3_voxelize_ms",
                "plan")})
        else:
            row["shapes"].append(entry)
        log(f"time voxelize_batch_scatter {entry['shape']}: kernel {ms:.4g} "
            f"ms one call, {device_ms * 1e3:.4g} us graph-timed "
            f"({bms / device_ms:.1%} of the bound), plain {plain_ms:.4g} ms, "
            f"K3 voxelize_batch {k3_ms:.4g} ms, bound {bms:.4g} ms ({bby}); "
            f"{plan}, {sms * per_sm} CTAs resident ({smi})")
    return row


def k3_timing(dev, b: int, grid_hw, capacity: int, smi,
              ecdp: bool = False) -> dict:
    """K3 at (b, 5, capacity) on a ``grid_hw`` x 5 canvas, or with ``ecdp``
    at (b, 2, capacity) on the count image's ``grid_hw`` x 2 (synthetic
    events with strays, as phase 2's), one call an event pair beside its
    plain version, from a CUDA graph of 10 calls, and beside the library
    call, ``index_put_(accumulate=True)`` alone on the in-frame cells and
    weights that ``splat_reference`` computes first; the bound from the
    bytes: each coordinate and weight read once, the grid written once."""
    from eventpretrain_tpu_torch.ops.splat import (
        splat,
        splat_reference,
        splat_route,
    )

    y, x, wb = splat_args(np.random.default_rng(3), b, dev, grid_hw,
                          capacity, ecdp)
    h, w = grid_hw
    c = wb.shape[1]
    hw = dict(height=h, width=w)
    ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    cell = ((torch.arange(b, device=dev)[:, None] * h + y.long()) * w
            + x.long())[ok]
    vals = wb.transpose(1, 2)[ok].float()
    acc = torch.zeros((b * h * w, c), device=dev)
    ms, plain_ms = time_pair(lambda: splat(y, x, wb, **hw),
                             lambda: splat_reference(y, x, wb, **hw))
    # the card alone, without the wrapper's host work
    device_ms = graph_ms(lambda: splat(y, x, wb, **hw))
    lib_ms = cuda_ms(lambda: acc.index_put_((cell,), vals, accumulate=True))
    nbytes = (y.numel() + x.numel()) * 4 + wb.numel() * 4 + acc.numel() * 4
    bms, bby = bound(wb.numel(), nbytes)
    log(f"time splat ({b}, {c}, {capacity}) -> {h}x{w}x{c}: "
        f"kernel {ms:.4g} ms (graph-timed {device_ms * 1e3:.4g} us), plain "
        f"{plain_ms:.4g} ms, index_put_ {lib_ms:.4g} ms, bound {bms:.4g} ms "
        f"({bby}) ({smi})")
    return {"kernel_route": splat_route(b, h, w, c), "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bby, "library_ms": lib_ms,
            "shape": [b, c, capacity], "grid": [h, w, c],
            "flops": wb.numel(), "bytes": nbytes}


def phase_timing(dev, hub, infer, big_inputs, errs, launches, train, cls,
                 dense, flow, host, loops, con, clip, convvit, swin, ecdp,
                 readers, smi) -> None:
    import torch.nn.functional as F

    from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
    from eventpretrain_tpu_torch.ops import fused_mlp as km
    from eventpretrain_tpu_torch.ops.splat import splat, splat_reference

    b = big_inputs[0].shape[0]
    gen = torch.Generator().manual_seed(4)

    def k1_case(l, c, h, backward, b):
        a = k1_args(gen, b, l, c, dev)
        kw = dict(num_heads=h, scale=(c // h) ** -0.5)
        if not backward:
            return (lambda: ka.fused_ln_attn_layer(*a, **kw),
                    lambda: ka.fused_ln_attn_layer_reference(*a, **kw))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        x_, g_, be_, wqkv, bqkv, wo, bo = a
        with torch.no_grad():
            _, qkv, o = ka._layer_cuda(x_, wqkv, bqkv, wo, bo, h,
                                       kw["scale"], ln=(g_, be_, 1e-6))
        return (lambda: ka._ln_backward_cuda(x_, g_, be_, wqkv, wo, qkv, o,
                                             dy, h, kw["scale"], 1e-6),
                lambda: ka.fused_ln_attn_layer_bwd_reference(*a[:6], dy,
                                                             **kw))

    def k4_case(l, c, h, backward, b):
        a = k4_args(gen, b, l, c, dev)
        kw = dict(num_heads=h, scale=(c // h) ** -0.5)
        if not backward:
            return (lambda: ka.fused_attn_layer(*a, **kw),
                    lambda: ka.fused_attn_layer_reference(*a, **kw))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        x_, wqkv, bqkv, wo, bo = a
        with torch.no_grad():
            _, qkv, o = ka._layer_cuda(x_, wqkv, bqkv, wo, bo, h,
                                       kw["scale"])
        return (lambda: ka._backward_cuda(x_, wqkv, wo, qkv, o, dy, h,
                                          kw["scale"]),
                lambda: ka.fused_attn_layer_bwd_reference(*a[:4], dy, **kw))

    def k2_case(l, c, backward, b):
        a = k2_args(gen, b, l, c, dev)
        if not backward:
            return (lambda: km.fused_ln_mlp(*a),
                    lambda: km.fused_ln_mlp_reference(*a))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        return (lambda: km._ln_backward_cuda(*a[:6], dy, 1e-6),
                lambda: km.fused_ln_mlp_bwd_reference(*a[:6], dy))

    def k5_case(l, c, backward, b):
        a = k5_args(gen, b, l, c, dev)
        if not backward:
            return (lambda: km.fused_mlp(*a),
                    lambda: km.fused_mlp_reference(*a))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        return (lambda: km._backward_cuda(*a[:4], dy),
                lambda: km.fused_mlp_bwd_reference(*a[:4], dy))

    def sdpa(l, c, h, backward, b):
        q, kk, v = (torch.randn((b, h, l, c // h), generator=gen).to(
            dev, torch.bfloat16) for _ in range(3))
        if not backward:
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v))
        q, kk, v = (t.requires_grad_() for t in (q, kk, v))
        out = F.scaled_dot_product_attention(q, kk, v)
        do = torch.randn_like(out)
        return cuda_ms(lambda: torch.autograd.grad(out, (q, kk, v), do,
                                                   retain_graph=True))

    def mha(l, c, h, backward, b):
        """K4's function as one PyTorch call: multi_head_attention_forward
        (packed in-projection, attention, out-projection) on the same
        bf16 operands, tokens (L, B, C)."""
        xx, wqkv, bqkv, wo, bo = (t.detach().requires_grad_(backward)
                                  for t in k4_args(gen, b, l, c, dev))
        xt = xx.detach().transpose(0, 1).contiguous().requires_grad_(
            backward)

        def call():
            return F.multi_head_attention_forward(
                xt, xt, xt, c, h, wqkv, bqkv, None, None, False, 0.0, wo,
                bo, training=False, need_weights=False)[0]

        if not backward:
            return cuda_ms(call)
        out = call()
        do = torch.randn_like(out)
        leaves = (xt, wqkv, bqkv, wo, bo)
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True))

    # (name, source, also, replaces, shapes, backward, case, work, library):
    # a shape is (L, C, heads) at the main path's batch, or (L, C, heads,
    # batch); the first is the row's, the others follow in "shapes". K1/K2
    # forward keep slice 1's shape (ViT-S, L=196, C=384) and add the rec
    # path's two, the contrastive stages' dense ViT-B (L=196, C=768),
    # ConvViT-S rec's encoder (L=49, C=384) and decoder (L=196, C=256, 8
    # heads) and Swin-T rec's decoder (L=49, C=256, 8 heads); their
    # backward rows are the rec paths' decoder and encoder blocks and the
    # dense ViT-B of stage 3. K4 runs in the cls train step
    # (ViT-S, and ViT-B for the CLI's --finetune run) and in ConvViT-S's
    # dense steps at B=16, K5 in the attention-map forward (ViT-S) and up
    # to the widest C of its gate.
    csrc = "eventpretrain_tpu_torch/csrc/"
    attn = [csrc + "ln_gemm.cu"]
    attn_bwd = [csrc + "ln_gemm.cu", csrc + "ln_bwd.cu", csrc + "attention.cu"]
    rows = [
        ("fused_ln_attn_layer", csrc + "attention.cu",
         attn + [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_attn_layer.py:357",
         [(196, 384, 12), (49, 768, 12), (196, 512, 16), (196, 768, 12),
          (49, 384, 12), (196, 256, 8), (49, 256, 8),
          (ECDP_TOKENS, 384, 12)],
         False, k1_case, k1_work, None),
        ("fused_ln_attn_layer_bwd", csrc + "attention_bwd.cu", attn_bwd,
         "eventpretrain_tpu/ops/fused_attn_layer.py:386",
         [(196, 512, 16), (49, 768, 12), (196, 768, 12), (49, 384, 12),
          (196, 256, 8), (49, 256, 8), (ECDP_TOKENS, 384, 12)], True,
         k1_case, k1_work, None),
        ("fused_ln_mlp", csrc + "ln_gemm.cu", [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_mlp.py:329",
         [(196, 384, 0), (49, 768, 0), (196, 512, 0), (196, 768, 0),
          (49, 384, 0), (196, 256, 0), (49, 256, 0), (ECDP_TOKENS, 384, 0)],
         False, k2_case, k2_work, None),
        ("fused_ln_mlp_bwd", csrc + "ln_gemm.cu", [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_mlp.py:356 (C<=512), :416 (C=768)",
         [(196, 512, 0), (49, 768, 0), (196, 768, 0), (49, 384, 0),
          (196, 256, 0), (49, 256, 0), (ECDP_TOKENS, 384, 0)], True,
         k2_case, k2_work, None),
        ("fused_attn_layer", csrc + "attention.cu", attn,
         "eventpretrain_tpu/ops/fused_attn_layer.py:202",
         [(196, 384, 12), (196, 768, 12), (196, 384, 12, DENSE_BATCH)],
         False, k4_case, k1_work, mha),
        ("fused_attn_layer_bwd", csrc + "attention_bwd.cu", attn_bwd,
         "eventpretrain_tpu/ops/fused_attn_layer.py:220",
         [(196, 384, 12), (196, 768, 12), (196, 384, 12, DENSE_BATCH)],
         True, k4_case, k1_work, mha),
        ("fused_mlp", csrc + "ln_gemm.cu", [],
         "eventpretrain_tpu/ops/fused_mlp.py:152",
         [(196, 384, 0), (196, 512, 0)], False, k5_case, k2_work, None),
        ("fused_mlp_bwd", csrc + "ln_gemm.cu", [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_mlp.py:173",
         [(196, 384, 0), (196, 512, 0)], True, k5_case, k2_work, None),
    ]
    total = {k: sum(launches[p].get(k, 0) for p in launches)
             for k in counters()}
    kernels = []
    k3 = k3_timing(dev, b, CANVAS, EVENTS, smi)
    # the raw pretrain path's canvas, held against the plain version first
    ry, rx, rwb = splat_args(np.random.default_rng(13), TRAIN_BATCH, dev,
                             (TRAIN_INPUT, TRAIN_INPUT), RAW_CAPACITY)
    rhw = dict(height=TRAIN_INPUT, width=TRAIN_INPUT)
    raw_err = (splat(ry, rx, rwb, **rhw)
               - splat_reference(ry, rx, rwb, **rhw)).abs().max().item()
    require(raw_err <= SPLAT_ATOL, "splat at 224x224x5 disagrees with "
                                   "splat_reference")
    del ry, rx, rwb
    k3_raw = k3_timing(dev, TRAIN_BATCH, (TRAIN_INPUT, TRAIN_INPUT),
                       RAW_CAPACITY, smi)
    k3_raw.update(max_abs_err=raw_err, tol=SPLAT_ATOL,
                  launches_by_path={p: launches[p]["splat"]
                                    for p in ("adj_n_train", "con_n_train")})
    # the ECDP raw path's count image, held first at the same shape
    ry, rx, rwb = splat_args(np.random.default_rng(14), TRAIN_BATCH, dev,
                             (TRAIN_INPUT, TRAIN_INPUT), RAW_CAPACITY, True)
    ecdp_err = (splat(ry, rx, rwb, **rhw)
                - splat_reference(ry, rx, rwb, **rhw)).abs().max().item()
    require(ecdp_err <= SPLAT_ATOL, "splat at 224x224x2 disagrees with "
                                    "splat_reference")
    del ry, rx, rwb
    k3_ecdp = k3_timing(dev, TRAIN_BATCH, (TRAIN_INPUT, TRAIN_INPUT),
                        RAW_CAPACITY, smi, ecdp=True)
    k3_ecdp.update(max_abs_err=ecdp_err, tol=SPLAT_ATOL,
                   launches_by_path={"ecdp_raw_train":
                                     launches["ecdp_raw_train"]["splat"]})
    err, tol = errs["splat"]
    k3_shapes = [k3_raw, k3_ecdp, *readers["k3_shapes"]]
    kernels.append({
        "name": "splat", "route": "cuda", "source": csrc + "splat.cu",
        "also": [csrc + "splat_core.cuh"],
        "replaces": "eventpretrain_tpu/ops/pallas_voxel.py:227",
        "launches": total["splat"],
        "launches_by_path": {p: launches[p]["splat"] for p in launches},
        "max_abs_err": max([err] + [e["max_abs_err"] for e in k3_shapes]),
        "tol": tol, **k3,
        "library": "index_put_(accumulate=True)",
        "shapes": k3_shapes,
    })
    kernels.append(k6_row(dense, flow, errs, total, launches, smi,
                          readers["k6_shapes"]))
    for (name, source, also, replaces, shapes, backward, case, work,
         library) in rows:
        ln = name.startswith("fused_ln")
        names = ((GRAD_NAMES if ln else BARE_GRAD_NAMES) if backward
                 else ("y",))
        per_shape = []
        for l, c, h, bb in ((*sh, b)[:4] for sh in shapes):
            fn, plain = (case(l, c, h, backward, bb) if h
                         else case(l, c, backward, bb))
            # held at the path's batch before it is timed
            shape = [bb, l, c] + ([h] if h else [])
            err, rel, tol = hold(name, shape, fn(), plain(), names)
            prev = errs[name]
            errs[name] = ((max(prev[0], err), SUBBLOCK_REL_TOL,
                           max(prev[2], rel)) if backward
                          else (max(prev[0], err), max(prev[1], tol)))
            ms, plain_ms = time_pair(fn, plain)
            flops, nbytes = (work(bb, l, c, h, backward, ln) if h
                             else work(bb, l, c, backward, ln))
            bms, bby = bound(flops, nbytes)
            entry = {"shape": shape, "max_abs_err": err, "max_rel_err": rel,
                     "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                     "flops": flops, "bytes": nbytes,
                     "library_ms": (library(l, c, h, backward, bb)
                                    if library else None)}
            if h:
                entry["sdpa_ms"] = sdpa(l, c, h, backward, bb)
            per_shape.append(entry)
            del fn, plain
            log(f"time {name} {entry['shape']}: kernel {ms:.4g} ms, plain "
                f"{plain_ms:.4g} ms, bound {bms:.4g} ms ({bby})"
                + (f", mha {entry['library_ms']:.4g} ms" if library else "")
                + (f", sdpa {entry['sdpa_ms']:.4g} ms" if h else "")
                + f" ({smi})")
        err, tol = errs[name][:2]
        head = per_shape[0]
        kind = {"fused_ln_attn_layer": "K1", "fused_attn_layer": "K4",
                "fused_ln_mlp": "K2", "fused_mlp": "K5"}[
                    name.removesuffix("_bwd")]
        l, c = shapes[0][:2]
        gemms = gemm_rows(dev, kind, b, l, c, backward, smi)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "also": also,
            "replaces": replaces, "launches": total[name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": err, "tol": tol,
            **({"max_rel_err": errs[name][2],
                "tol_is": "max_rel_err, of each gradient's scale"}
               if backward else {}),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **({"library": "F.multi_head_attention_forward"
                + (" + autograd.grad" if backward else "")}
               if library else {}),
            "shape": head["shape"], "flops": head["flops"],
            "bytes": head["bytes"], "shapes": per_shape[1:],
            "gemms": gemms,
        })

    kernels += k7_rows(dev, errs, total, launches, smi)
    kernels += row_rows(dev, errs, launches, smi)
    kernels.append(k8_row(dev, errs, total, launches, smi))
    core = core_rows(dev, errs, total, smi)

    # served function, raw numpy events -> numpy logits; kernel and plain
    # (unfused bf16) paths in turns: plain, kernel, kernel, plain
    runs = {True: [], False: []}
    for fused in (False, True, True, False):
        set_fused(hub, fused)
        runs[fused] += host_ms(lambda: infer(*big_inputs), reps=REPS // 2)
    set_fused(hub, True)
    e2e = {"serve": {"batch": b, "reps": REPS, "card": smi}}
    for fused, key in ((True, ""), (False, "plain_")):
        q1, med, q3 = statistics.quantiles(runs[fused], n=4)
        e2e["serve"].update({
            f"{key}ms": med, f"{key}ms_q1": q1, f"{key}ms_q3": q3,
            f"{key}samples_per_s": b / med * 1e3,
        })

    # the rec and cls train steps, B=64, host clock around synchronised
    # steps, each on both paths in turns
    for key, run, model, batch in (
            ("rec_train", train, "pretrain_hub_base", TRAIN_BATCH),
            ("cls_train", cls, "cls_hub_vit_small", TRAIN_BATCH),
            ("semseg_train", dense, "dense_hub_vit_small", DENSE_BATCH)):
        paths = {True: (run["step"], run["state"]),
                 False: (run["pstep"], run["pstate"])}
        step_runs, peak = timed_steps(paths, run["batches"])
        e2e[key] = {"model": model, "batch": batch, "reps": REPS,
                    "card": smi, "loss_gap": run["loss_gap"],
                    "resident_gib": torch.cuda.memory_allocated() / 2**30,
                    **step_record(step_runs, peak, batch)}
        log(f"{key} step B={batch}: kernel "
            f"{e2e[key]['step_ms']:.4g} ms, plain "
            f"{e2e[key]['plain_step_ms']:.4g} ms ({smi})")
    # the contrastive stages' steps (phase 5g), fewer steps a turn: 5
    # and phase 5h's, the step alone on replayed batches (their embeddings
    # already encoded)
    for key, run in (("adj_train", con["adj"]), ("con_train", con["con"]),
                     ("rec_con_train", con["rec_con"]),
                     ("adj_n_train", clip["adj"]),
                     ("con_n_train", clip["con"])):
        paths = {True: (run["step"], run["state"]),
                 False: (run["pstep"], run["pstate"])}
        step_runs, peak = timed_steps(paths, run["batches"], reps=REPS // 4)
        e2e[key] = {"model": "pretrain_hub_base", "batch": TRAIN_BATCH,
                    "reps": REPS // 2, "card": smi,
                    "loss_gap": run["loss_gap"],
                    "resident_gib": torch.cuda.memory_allocated() / 2**30,
                    **step_record(step_runs, peak, TRAIN_BATCH)}
        log(f"{key} step B={TRAIN_BATCH}: kernel "
            f"{e2e[key]['step_ms']:.4g} ms ({e2e[key]['peak_step_gib']:.3g} "
            f"GiB above resident), plain {e2e[key]['plain_step_ms']:.4g} ms "
            f"({e2e[key]['plain_peak_step_gib']:.3g} GiB) ({smi})")
    e2e["con_train"]["queue"] = {**con["queue"], "card": smi}
    # CLIP in the loop: the tower's device ms a batch (bf16, B=64, the
    # preprocess included), the raw pipeline's host ms a batch, and the
    # counted epoch's wall time and peak memory (pipeline, CLIP and steps)
    from eventpretrain_tpu_torch.models.clip import encode_images

    tower, images = clip["clip"]["model"], clip["con"]["images"][0]

    def encode():
        with torch.no_grad():
            return encode_images(tower, images)

    clip_ms = cuda_ms(encode, reps=REPS // 2)
    for key, run in (("adj_n_train", clip["adj"]),
                     ("con_n_train", clip["con"])):
        e2e[key].update({
            "clip_ms": clip_ms, "host_batch_ms": run["host_ms"],
            "epoch_wall_s": run["wall_s"], "epoch_peak_gib": run["peak_gib"],
            "clip_bf16_vs_f32": {k: clip["clip"][k] for k in (
                "bf16_vs_f32_max_rel", "bf16_vs_f32_mean_rel", "tol")},
            "k3_plan": clip["clip"]["k3_plan"]})
        log(f"{key}: CLIP ViT-B/16 {clip_ms:.4g} ms a batch of "
            f"{TRAIN_BATCH} on the card, host build {run['host_ms']:.4g} ms "
            f"a batch, the counted epoch {run['wall_s']:.3g} s (peak "
            f"{run['peak_gib']:.3g} GiB) ({smi})")
    e2e["cls_train"]["host_batch_ms"] = cls["host_ms"]
    e2e["cls_train"]["drop_path_rate"] = CLS_DROP_PATH
    e2e["semseg_train"]["host_batch_ms"] = dense["host_ms"]
    e2e["semseg_train"]["drop_path_rate"] = DENSE_DROP
    # one epoch through train_one_epoch with the prefetcher, and the same
    # loop in the training thread (phase 5d)
    for key, loop in (("cls_train", "cls_loop"),
                      ("semseg_train", "semseg_loop")):
        e2e[key]["epoch_loop"] = loops[loop]
        log(f"{key}: step {e2e[key]['step_ms']:.4g} ms, host build "
            f"{e2e[key]['host_batch_ms']:.4g} ms per batch; delivered "
            f"{loops[loop]['delivered_samples_per_s']:.4g} samples/s with "
            f"the prefetcher, "
            f"{loops[loop]['delivered_samples_per_s_no_prefetch']:.4g} "
            f"without ({smi})")

    # slice 3b's flow step (phase 5e) and the host half (phase 5f)
    e2e["flow_train"] = {**flow["record"], "card": smi}
    e2e["host_build"] = {**host, "card": smi}
    # slice 5a's ConvViT steps and slice 4b-i's accumulation (phase 5i),
    # slice 5b's Swin steps (phase 5j)
    for key, rec in convvit.items():
        e2e[f"convvit_{key}"] = {**rec, "card": smi}
    for key, rec in swin.items():
        e2e[f"swin_{key}"] = {**rec, "card": smi}
    # slice 5c's ECDP steps (phase 5k)
    for key, rec in ecdp.items():
        e2e[key] = {**rec, "card": smi}
    # slice 5d's dense steps at the readers' sensors and the MEM check
    # (phase 5l)
    for key, rec in readers["records"].items():
        e2e[key] = {**rec, "card": smi}
    e2e["mem_representation"] = readers["mem"]

    # where the time goes, every main path on the kernel path
    e2e["serve"]["profile"] = device_profile(lambda: infer(*big_inputs), 5)
    log_profile("serve B=64", e2e["serve"]["profile"])
    for key, run, calls in (("rec_train", train, 3), ("cls_train", cls, 5),
                            ("semseg_train", dense, 5),
                            ("flow_train", flow, 5),
                            ("adj_train", con["adj"], 3),
                            ("con_train", con["con"], 3),
                            ("rec_con_train", con["rec_con"], 3)):
        step, state = run["step"], run["state"]
        batch = run["batches"][0]
        e2e[key]["profile"] = device_profile(lambda: step(state, batch),
                                             calls)
        log_profile(f"{key} step B={e2e[key]['batch']}",
                    e2e[key]["profile"])
    # a con-n step with its CLIP encode, on the first batch's images
    run = clip["con"]
    evg = run["batches"][0]["evg"]
    e2e["con_n_train"]["profile"] = device_profile(
        lambda: run["step"](run["state"], {"evg": evg, "clip_emb": encode()}),
        3)
    log_profile(f"con_n_train step with its CLIP encode B={TRAIN_BATCH}",
                e2e["con_n_train"]["profile"])
    log(json.dumps({"e2e": e2e}))
    log(json.dumps({"attention_core": core}))
    log(smi)
    log(json.dumps({"kernels": kernels}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.0f} s] {what} done")

    smi = phase_environment()
    errs = phase_kernel_parity(dev)
    mark("kernel parity")

    from eventpretrain_tpu_torch.cli.serve import make_cls_infer

    hub = build_hub(dev, torch.bfloat16)
    infer = make_cls_infer(hub, num_bins=NUM_BINS, canvas=CANVAS)
    rng = np.random.default_rng(0)
    big_inputs = make_events(rng, 64)
    launches = {"serve": phase_main_path(dev, hub, infer,
                                         tuple(a[:8] for a in big_inputs))}
    phase_serving(infer, big_inputs)
    mark("serving")
    train = phase_training(dev)
    launches["rec_train"] = train["launches"]
    phase_cli(dev)
    mark("rec training")
    cls = phase_cls_training(dev)
    launches["cls_train"] = cls["launches"]
    launches.update(phase_cls_eval(dev, cls))
    phase_finetune_cli(dev)
    mark("cls finetuning")
    dense = phase_dense_training(dev)
    launches["semseg_train"] = dense["launches"]
    launches.update(phase_dense_eval(dev, dense))
    phase_semseg_cli(dev)
    mark("semseg finetuning")
    flow = phase_flow_training(dev)
    launches["flow_train"] = flow["launches"]
    launches.update(phase_flow_eval(dev, flow))
    phase_flow_cli(dev)
    mark("flow finetuning")
    host = phase_host(dev)
    mark("host half")
    con = phase_con_training(dev)
    launches.update(con["launches"])
    phase_con_cli(dev)
    mark("contrastive stages")
    clip = phase_clip_training(dev)
    launches.update(clip["launches"])
    phase_clip_cli(dev)
    mark("CLIP in the loop")
    cv_rec = phase_convvit_rec(dev)
    launches["convvit_rec_train"] = cv_rec["launches"]
    convvit = {"rec_train": cv_rec["record"],
               "accumulation": phase_convvit_accum(dev, cv_rec)}
    del cv_rec
    cv_ft = phase_convvit_finetune(dev)
    launches.update(cv_ft["launches"])
    convvit.update({f"{task}_train": rec
                    for task, rec in cv_ft["records"].items()})
    phase_convvit_cli(dev)
    mark("ConvViT and accumulation")
    sw_rec = phase_swin_rec(dev)
    launches["swin_rec_train"] = sw_rec["launches"]
    swin = {"rec_train": sw_rec["record"]}
    del sw_rec
    sw_con = phase_swin_con(dev)
    launches.update(sw_con["launches"])
    swin.update(sw_con["records"])
    del sw_con
    sw_ft = phase_swin_finetune(dev)
    launches.update(sw_ft["launches"])
    swin.update({f"{task}_train": rec
                 for task, rec in sw_ft["records"].items()})
    del sw_ft
    phase_swin_cli(dev)
    mark("Swin")
    ecdp = phase_ecdp_training(dev, clip["clip"]["model"])
    launches.update(ecdp["launches"])
    ecdp_ft = phase_ecdp_finetune(dev)
    launches.update(ecdp_ft["launches"])
    ecdp["records"].update({f"vit_ecdp_{task}_train": rec
                            for task, rec in ecdp_ft["records"].items()})
    del ecdp_ft
    phase_ecdp_cli(dev)
    mark("ECDP baseline")
    readers = phase_readers(dev, smi)
    launches.update(readers["launches"])
    mark("dataset readers and the MEM image")
    launches.update(phase_k7_path(dev))
    launches.update(phase_k8_path(dev))
    loops, loop_launches = phase_prefetch_loops(dev)
    launches.update(loop_launches)
    mark("K7 and K8 paths, prefetched loops")
    phase_timing(dev, hub, infer, big_inputs, errs, launches, train, cls,
                 dense, flow, host, loops, con, clip, convvit, swin,
                 ecdp["records"], readers, smi)
    mark("timing")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
