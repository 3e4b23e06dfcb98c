#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).  Phases, each
fatal on failure:

1. build: compile the four kernel sources (csrc/norm_conv.cu,
   csrc/flash_attention.cu, csrc/flash_attention_bwd.cu,
   csrc/multibox_nms.cu) for sm_90a, one nvcc each, started together;
2. kernels: at every distinct NormConv geometry of ResNet-50 at batch 8,
   224x224 (22 of them, read off the graph), hold the kernel against its
   plain PyTorch version in float32 and bfloat16, with TF32 off; check the
   statistics epilogue (float32, every geometry), the prologue off and the
   ReLU off, and y bitwise equal over two launches (split-K sums its
   slices in a fixed order); print the tile, the split-K slices and the
   16-byte load flags the kernel took; time the kernel, the plain version
   and cuDNN's conv alone.  Then the same geometries at the training
   batches (RESNET_CHECK_BATCH and RESNET_TRAIN_BATCH, float32, whose
   split-K plans differ from batch 8's) with the statistics epilogue on,
   y and both sums against the plain version and y bitwise over two
   launches; at batch 32 the kernel (with the statistics where the
   training graph has them), the plain version and cuDNN's conv timed;
   then the same at batch 32 in bfloat16 (the AMP step's forward), timed
   beside cuDNN's bfloat16 conv and a bfloat16 bound (bf16 bytes, the
   tensor-core peak);
3. serving: ResNet-50 at full width (1000 classes, 3x224x224, random
   weights from a seed) behind ``ServedModel`` with MXNET_NORM_CONV=1,
   max_batch 8, 24 requests from 4 client threads; every request answered,
   the kernel launched 52 times per forward, and every served row equal
   (within SERVE_TOL) to an unfused ``Predictor`` (cuDNN, TF32 off);
4. resnet50_train: ResNet-50 at full width and depth (1000 classes,
   3x224x224) trained through ``TrainStep``, twice: unfused
   (MXNET_NORM_CONV=0; the NormConv kernel must launch 0 times), then
   through the fused NormConv path (MXNET_NORM_CONV=1; the kernel must
   launch RESNET_NC_PER_STEP times a step, RESNET_NC_STATS_PER_STEP of
   them with the statistics epilogue feeding the next BatchNorm; the stem
   fuse, on by default, takes the 7x7 conv0 in both).  Each run: (a) one
   SGD-momentum step at batch 4 from a seed-0 state, float32 on the card,
   against the same step in float64 on the CPU on the same graph: every
   parameter's gradient (its first momentum) and every moving statistic
   within RESNET_FLOOR_X times its own float32 floor (float32 steps on the
   CPU on the same graph against float64, by largest entry and by norm);
   unfused, the same step in float64 on the card within RESNET_F64_TOL;
   fused (the kernel takes no float64), the fused float64 CPU step within
   RESNET_F64_TOL of the unfused one; (b) the loss lower after 9 steps on
   that batch than after the first; (c) batch 32 through
   ``bench/resnet50_train.py``'s ``setup`` and ``timed_chunks`` (fewer
   rounds than its default): img/s, host ms a step, peak memory, and a
   torch.profiler breakdown of one step (the NormConv kernel, cuDNN's
   convolutions and the FC's GEMM, BatchNorm and the other elementwise
   work, the SGD rule, the casts);
4b. resnet50_train_amp: the same model, unfused then fused, under
   ``Policy("bfloat16")`` (bench.py's policy): (a) one step at batch 4 on
   the card against phase 4's float64 CPU step on the same graph, each
   gradient, moving statistic and parameter update within RESNET_FLOOR_X
   times its bfloat16 floor (RESNET_FLOOR_SAMPLES bf16-policy steps of the
   port on the CPU from the state and from nudges of it by
   RESNET_BF16_NUDGE), and the step's Functions (BatchNorm, BatchNorm+
   ReLU, NormConv with statistics) in bfloat16 on the card against float64
   on the CPU on the same inputs, within RESNET_FLOOR_X times their CPU
   bfloat16 floors; (b) a batch holding an inf leaves parameters,
   momenta and moving statistics bitwise unchanged, halves the scale and
   counts one overflow; one step under torch.cuda.set_sync_debug_mode
   ("warn", each synchronisation printed with its stack, then "error");
   unfused, a ``Policy("float32", loss_scale=2**10)`` step bitwise equal
   to the plain float32 step (cuDNN deterministic); (c) the loss lower
   after 9 steps; (d) batch 32 timed and profiled as in phase 4, beside
   the float32 run of this call; fused, every NormConv launch in
   bfloat16, 52 a step, 32 with statistics;
4c. module_fit: the users' entry point, ``Module.fit`` on gpu(0), cuDNN
   deterministic.  ResNet-50 at full width from a seed-0 state over an
   ``io.NDArrayIter`` of 4 synthetic batches of 32 (77 MB on the host), 2
   epochs of SGD(0.1, momentum 0.9, wd 1e-4): the fused path engages, the
   trained parameters and moving statistics equal a direct ``TrainStep``
   run over the same batches bit for bit (or within MODULE_REPEAT_X times
   two direct runs' distance, MODULE_NONDET_MIN at least), the same fit
   with MXNET_DEVICE_PREFETCH=0
   likewise, 2 batches of the general path (executor + Updater) within
   rtol 5e-3 / atol 1e-5 of the fused steps; the fit's steady host ms a
   batch beside TrainStep's on the same batches on the card, in turns, and
   the general path's; the same module fit again under MXNET_NORM_CONV=1
   (52 NormConv launches a step, 32 with statistics, the cached
   TrainStep kept) and under MXNET_AMP=1 (every launch in bfloat16, the
   loss scale read through ``amp_stats``, float32 masters after the sync
   back); the batch loop of a fit without callbacks under
   ``set_sync_debug_mode``; ``save_checkpoint``, ``Module.load`` and
   ``score`` giving the same accuracy.  Then the LM at GPT-2-small widths
   through ``Module.fit`` with Adam(1e-4), 2 batches of 4 x 1024: 36
   flash launches a step, the parameters against a direct TrainStep run;
4d. lstm_bucketing: the sequences slice at the published widths of the
   bucketed LSTM LM (``bench/lstm_bucketing.py``: 2 LSTM layers of 200,
   embedding 200, 10,000 words plus the invalid label, batch 32, buckets
   10-60), float32 with TF32 off.  (a) The ``RNN`` op at the LM's shapes
   (T=60, N=32, I=200, H=200, 2 layers) as lstm, gru and bidirectional
   lstm: the cuDNN route (one cuDNN call a layer, ``rnn_op.cudnn_calls``)
   and the plain version, both on the card, each output, final state and
   gradient (data, parameters, states) within RESNET_FLOOR_X times its
   float32 floor of the float64 plain version on the host, the two routes
   within twice that of each other; both timed.  (b) The
   ``FusedRNNCell`` LM and its ``LSTMCell`` stack at bucket 60, the
   stack's weights moved by ``unpack_weights`` (``pack_weights`` gives the
   flat vector back exactly): both forwards within the same rule of the
   fused graph's float64 forward on the host.  (c) ``BucketingModule.fit``
   with each cell, 2 epochs of 4 batches a bucket: every bucket bound once,
   five of them with ``shared_module`` onto the default bucket's parameter
   and gradient tensors (``data_ptr``), 2 cuDNN calls a batch with the
   fused cell and none with the stack, the training perplexity lower in
   the second epoch, a checkpoint of the default bucket loaded by
   ``Module.load`` into a new BucketingModule scoring the same; tokens/s,
   host ms a batch by bucket, the device-busy share of a profiled batch of
   each bucket, peak memory;
4e. ssd: the SSD slice (models/ssd.py: 64x64 input, 1,344 anchors) on the
   example's synthetic batch, SSD_CLASSES classes, batch SSD_BATCH.  (a)
   The MultiBox ops at those shapes: MultiBoxPrior on the card equal to the
   CPU's; MultiBoxTarget (the training symbol's settings) on the card in
   float32 against float64 on the CPU, cls_target and loc_mask entry for
   entry, loc_target within SSD_LOC_TOL; MultiBoxDetection's NMS kernels
   (the mask, then the scan) against greedy_nms_ref on the card (ids
   equal), the detections against float64 on the CPU (ids equal, the rest
   within SSD_DET_TOL); the three ops under set_sync_debug_mode ("warn",
   then "error"); the kernels event-timed over raw launches queued behind
   a spin of the card, the wrapper's host us a call, the detection
   forward's ms and the plain loop, beside a bound (the kept rows' chain
   of dependent steps, one a kept row); the kernels at NMS_LARGE (SSD300's
   8,732 anchors, 4 images of random boxes) against the plain loop on the
   card, ids equal, and timed.  (b) One SGD-momentum TrainStep step from a
   seed's
   parameters, float32 on the card (TF32 off) against float64 on the CPU:
   cls_target equal, each first momentum and parameter update within
   RESNET_FLOOR_X times its float32 floor; the step under
   set_sync_debug_mode.  (c) Module.fit through bench/ssd_train.py at the
   example's defaults (3 classes, batch 8, 10 batches, 2 epochs): the
   fused path, LocL1 lower in epoch 2, the detection symbol's (8, 1344, 6)
   with a kept row, two NMS launches a detection forward and none in the
   fits; then a timing fit at SSD_TIMING (20 classes, batch 32); images/s,
   host ms a batch, device-busy share, peak memory;
5. flash: the flash-attention forward kernel against its plain version
   (both outputs, TF32 off) at the LM's shape (4, 12, 1024, 64) made as the
   LM makes it (strided slices of one QKV projection), causal, and at the
   shapes of FLASH_CHECKS, each in float32 and bfloat16: within O_TOL and
   LSE_TOL, finite, o and lse bitwise equal over two launches; the tile
   the kernel took (``fwd_plan``) and whether it read rows in 16-byte
   pieces are printed; the kernel, the plain version and PyTorch's
   scaled_dot_product_attention (the yardstick; the port never calls it)
   are timed beside the bound;
6. lm: the transformer LM at GPT-2-small widths (12 layers, 768 hidden,
   12 heads, T=1024, vocab 50257, random weights from a seed) loaded
   through its JSON into ``Predictor`` at batch 4; 3 batches after one
   warm forward; the kernel launched 12 times per forward, and the
   probabilities equal (within LM_TOL) to a second ``Predictor`` of the
   same weights with ``attn_impl="xla"``, which launches it never; host
   time per forward and a torch.profiler breakdown of one forward;
7. flash_bwd: the flash-attention backward kernels (dQ, dK/dV) against the
   plain backward (TF32 off) at the LM's shape, causal, with q, k, v made
   as the LM makes them and dO a permuted view of a contiguous (B, T, H, D)
   tensor (the gradient of the LM's output transpose), and at the shapes of
   FLASH_CHECKS, in float32 and bfloat16: within BWD_TOL, finite, bitwise
   equal over two runs; the dQ kernel, the dK/dV kernel, the whole backward
   (delta + both), the plain backward and SDPA's backward (the yardstick)
   timed beside each kernel's bound;
8. lm_train: the LM at GPT-2-small widths trained through the port.  (a)
   One batch through ``Executor`` forward(is_train=True) + backward() on
   the kernel graph and on the attn_impl="xla" graph: every parameter's
   gradient within LM_GRAD_TOL (largest entry) and LM_GRAD_NORM_TOL
   (norm) of the xla graph's, beside the same measures between the xla
   graph in float32 and float64; 12 launches of each flash kernel on the
   kernel graph, none on the other.  (b) ``TrainStep``
   with Adam(1e-4) from those weights on one fixed batch: a warm step, 4
   steps through ``__call__`` and ``run_steps(..., 3)``; the loss (from
   the outputs, on the card) lower after the last step than after the
   first, 36 flash launches per step, host ms per step and tokens/s, and a
   torch.profiler breakdown of one step;
8b. lm_train_amp: the LM under ``Policy("bfloat16")``: each parameter's
   gradient within LM_BF16_X times its bfloat16 floor (the xla graph's
   bf16-policy gradient against its float32 one), the three flash kernels
   launched 12 times each in bfloat16; 9 Adam steps with the loss lower,
   36 bfloat16 flash launches a step, host ms, peak memory and a profiled
   step; one gradient step each with remat False, True and "dots", peak
   memory and host ms beside the gradients' distance;
   graph_device: a graph of ``_ones`` plus a data variable, and one of a
   uniform sampler plus a data variable, bound to gpu(0), forward on the
   card with the right values;
9. imperative: the LM's 163,087,441 float32 parameters as NDArrays on the
   card with gradients drawn on the card (``mx.nd.normal`` from the card's
   generator); three ``Updater`` passes with Adam over every parameter, and
   three with SGD-momentum, each held within IMPERATIVE_TOL to TrainStep's
   fused rule (``_FunctionalOptimizer``) on copies of the same tensors; host
   ms per pass, device ms and launches of one profiled pass, and the fused
   rule's ms per pass;
10. rtc: four user kernels written in CUDA C (``rtc_kernels.py``) pushed
   through ``rtc.Rtc`` once each (the path whose launches are counted):
   axpb over 163,087,441 floats, exp5_shared over 10, transpose_tiled of
   the LM's (50257, 768) lm_head weight, sgd_mom in place over one buffer
   holding every LM parameter (the parameters are views of it); each held
   to its plain version (axpb and transpose bitwise, exp5 within EXP5_TOL
   relative, sgd_mom within IMPERATIVE_TOL of the largest |w|); first-push
   seconds (nvcc), ``rtc.builds`` unchanged on a second push, host us per
   push, kernel / plain / ``torch.add`` / bound ms of axpb; axpb pushed on
   views one element off alignment, all three (its float4 branch after a
   head) and x alone (one element at a time), bitwise and timed;
   a source with a syntax error must raise MXNetError carrying nvcc's
   log.

Prints the card's name and power limit, whether ml_dtypes imports,
per-geometry numbers, serving qps and latency, the ResNet-50 training
checks, rates and profiles (unfused and fused, float32 and bfloat16 AMP),
the NormConv launches of serving and of fused training, flash timings, LM
checks and profiles, flash backward timings, LM training checks, rates and
profiles (float32 and AMP), the Module layer's checks and timings, the
sequences slice's and the SSD slice's checks, times and rates, Updater and
Rtc numbers, each phase's seconds,
a JSON line of kernel numbers (rows 1-4 with a "bf16_train" entry: the
bfloat16 kernel at the training shapes and its launches in the AMP steps;
row 6 the NMS kernel, which replaces an XLA loop, not a Pallas kernel),
and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or the package is missing.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
BATCH = 8
IMAGE = 224
CLASSES = 1000
CLIENTS = 4
REQUESTS_PER_CLIENT = 6
# kernel vs plain version, max |y_kernel - y_plain| / max |y_plain|.
# float32: both accumulate in float32, in different orders, over up to
# 4608 products.  bfloat16: the prologue is bit-identical, the outputs are
# each rounded once to bfloat16 (2^-8 relative) from float32 sums taken in
# different orders: allow about two bfloat16 steps of the largest output.
Y_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# float32 statistics epilogue vs the plain version's sums of y, relative to
# the largest |sum| (the kernel adds per-tile partials with atomics)
STATS_TOL = 1e-4
# bfloat16: the kernel sums its float32 accumulator, the plain version the
# bfloat16 y (each term rounded once, 2^-9 relative at most): over the
# >= 25,000 terms of a channel those roundings average out to well under
# 1e-4 of the largest sum; 1e-3 leaves room for a channel whose sum
# cancels
STATS_TOL_BF16 = 1e-3
# served softmax rows vs the unfused reference, relative to the largest
# probability: float32 throughout, so only summation order differs
SERVE_TOL = 1e-4
# flash kernel vs plain version.  o: max |o_kernel - o_plain| / max |o_plain|;
# float32 sums in another order over up to 2048 keys; bfloat16 rounds o once
# (2^-8 relative) from float32 sums: about two bfloat16 steps.  lse is
# float32 in both dtypes (the same upcast inputs): |dlse| / max(1, max|lse|).
O_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_TOL = 1e-4
# LM probabilities, flash graph vs attn_impl="xla" graph, relative to the
# largest probability: float32 throughout, the two attentions differ only in
# summation order (~1e-7 relative per layer, 12 layers)
LM_TOL = 1e-4
# flash backward kernels vs the plain backward, per output max |d_kernel -
# d_plain| / max |d_plain|.  float32: both sum float32 products in other
# orders (up to 2048 keys, then 64-256 head columns), as for the forward's
# O_TOL.  bfloat16: every input is the same bfloat16 value in both and all
# arithmetic is float32; each output is rounded once to bfloat16 (2^-8
# relative): about two bfloat16 steps of the largest output.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# LM parameter gradients, kernel graph vs attn_impl="xla" graph, both
# float32 (TF32 off).  The two attentions differ by rounding (~1e-7
# relative), which the ReLUs of the MLPs turn into O(1) changes: a
# pre-activation within rounding of zero is on one side of the kink in one
# graph and on the other in the second, and the gradient through that unit
# at that token is then kept in one and dropped in the other; every
# parameter upstream of such a flip sees it.  The same happens between the
# xla graph in float32 and in float64, which the run measures beside the
# check (the f32 floor).  So two measures per parameter: max |d| / max |g|
# within LM_GRAD_TOL and ||d|| / ||g|| within LM_GRAD_NORM_TOL.  On an
# H100 80GB HBM3 at 700 W the worst parameter measured 0.0134 and 0.00132,
# against a floor of 0.0107 and 0.00087: the tolerances sit about 4x above
# both.  A fault in a kernel or in its autograd wiring moves both by O(1).
LM_GRAD_TOL = 5e-2
LM_GRAD_NORM_TOL = 5e-3
# the LM under Policy("bfloat16"): each parameter's gradient on the kernel
# graph against the attn_impl="xla" graph's float32 gradient, within
# LM_BF16_X times that parameter's bfloat16 floor, the xla graph's
# bf16-policy gradient against its float32 one (or LM_BF16_FLOOR_MIN);
# both measures as above.  The two bf16 graphs round the same
# activations to bfloat16 and differ in the attention's float32 sums.
LM_BF16_X = 4.0
LM_BF16_FLOOR_MIN = 1e-6
# ResNet-50 training: one SGD-momentum step at full width and depth
# (224x224, 1000 classes), batch RESNET_CHECK_BATCH, float32 on the card
# (TF32 off) against the same step in float64 on the CPU, from one state,
# once on the unfused graph and once on the fused one (MXNET_NORM_CONV=1).
# wd is 0 in the check, so each parameter's first momentum is -lr *
# rescale_grad * its gradient (one float32 rounding of it).  Per gradient
# and moving statistic, the LM phase's two measures: max |d| / max |g| and
# ||d|| / ||g||.  BatchNorm's E[x^2] - mean^2 cancels in float32 and ReLU
# gates flip where the pre-activation sits within rounding of 0 (at batch
# 4 a flip moves a channel's statistics and every gradient below it), so
# each leaf has a float32 floor of its own, small for the moving
# statistics and up to 0.37 by max for stage 4's weights.  The phase
# measures it beside the check: the float32 step on the CPU against
# float64, from the state and from RESNET_FLOOR_SAMPLES - 1 nudges of it
# (each value times 1 + u *
# RESNET_FLOOR_NUDGE, u uniform in [-1, 1]; 2^-18 is about the rounding a
# float32 convolution accumulates over its ~2,000-term sums, so the card's
# own rounding moves a leaf about as far as a nudge does); a leaf's floor
# is the largest of these, per measure.  The floors are sampled on the
# graph under check: the fused graph's float32 steps on the CPU run
# NormConv's plain version (its float32 sums of y where the card adds tile
# partials with atomics) and round elsewhere than the unfused graph's (the
# prologue's scale and shift, the statistics from the conv's output), so
# each graph has floors of its own.  Each leaf is held to
# RESNET_FLOOR_X times its floor, or times RESNET_FLOOR_MIN where the
# floor is smaller.  On an H100 80GB HBM3 at 700 W the card's worst leaf
# stood at 0.95x its floor by max and 0.65x in norm; BatchNorm's
# statistics, dx or dgamma/dbeta cast to bfloat16, or cuDNN's TF32, each
# put some leaf at 22-3600x (mxnet_tpu_torch/bench/resnet_check_faults.py).
# The same step in float64 on the card has no such floor and is held to
# RESNET_F64_TOL (max |d| / max |g|); the fused graph has no float64 card
# step (the kernel takes float32 and bfloat16), so its float64 CPU step is
# held to the unfused one's within RESNET_F64_TOL instead.
RESNET_CHECK_BATCH = 4
# the fused graph at 224x224: 16 units x 3 convolutions and 4 shortcuts
# run as NormConv; each unit's conv1 and conv2 emit the statistics of the
# BatchNorm below them (bn2, bn3).  The 7x7 stem conv0 takes the stem
# peephole instead.
RESNET_NC_PER_STEP = 52
RESNET_NC_STATS_PER_STEP = 32
RESNET_FLOOR_SAMPLES = 4
RESNET_FLOOR_NUDGE = 2.0 ** -18
RESNET_FLOOR_X = 4.0
RESNET_FLOOR_MIN = 1e-6
RESNET_F64_TOL = 1e-9
# the AMP phase's check: one step under Policy("bfloat16") on the card
# against the same float64 CPU step, each leaf within RESNET_FLOOR_X times
# its bfloat16 floor: the largest distance from float64 of
# RESNET_FLOOR_SAMPLES bfloat16-policy steps of the port on the CPU, from
# the state and from nudges of it by RESNET_BF16_NUDGE.  2^-9 is
# bfloat16's rounding (half an ulp at 8 bits of mantissa): the card's and
# the CPU's bfloat16 convolutions round each output once from float32
# sums taken in other orders, so a leaf moves about as far under a nudge
# of one bfloat16 rounding as between the two devices.  Below the FC the
# bfloat16 step's gradients are as far from float64 as they are large
# (ReLU gates flip and BatchNorm's backward cancels at batch 4: on the
# CPU the port's and the JAX package's bfloat16 steps both sit at a
# median 1.1 in norm from float64 over the conv weights, float32 at
# 0.025), so a fault of a few percent in the backward cannot show there;
# the moving statistics (forward only) and the parameter updates (a
# master kept in bfloat16 rounds them) can.  The phase therefore also
# holds the step's Functions in bfloat16 to their float64 versions on the
# same inputs, where nothing is chaotic (``amp_function_rows``): each
# output and gradient within RESNET_FLOOR_X times the distance of the
# same Function's bfloat16 run on the CPU.
RESNET_BF16_NUDGE = 2.0 ** -9
# the AMP check's leaves: besides each gradient (first momentum) and moving
# statistic, each parameter's update (new - old master weight), which a
# master weight kept in bfloat16 would round away
AMP_KINDS = ("grad", "aux", "update")
RESNET_LR = 0.1
# the timed run: resnet50_train.py's function at its batch (32), with
# fewer rounds than its default, so the phase fits the script's limit
RESNET_TRAIN_BATCH = 32
RESNET_TRAIN_CHUNK = 4
RESNET_TRAIN_ROUNDS = 2
LM = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_hidden=768,
          num_heads=12)
LM_LR = 1e-4
LM_BATCH = 4
LM_BATCHES = 3
# module_fit: ResNet-50 trained through Module.fit (the users' entry point)
# over an NDArrayIter of MODULE_FIT_BATCHES synthetic batches of
# MODULE_FIT_BATCH, MODULE_FIT_EPOCHS epochs of SGD(RESNET_LR, momentum 0.9,
# wd 1e-4), cuDNN deterministic.  The fit runs the same TrainStep steps on
# the same batches as a direct TrainStep run from the same state, so the
# two must agree bit for bit; where they do not (ops that sum with atomic
# adds, in an order the card picks: the LM's embedding gradient), the
# distance (max |d| / max |w| per leaf) must stay within MODULE_REPEAT_X
# times that between two direct runs, measured beside it, or within
# MODULE_NONDET_MIN where two direct runs happened to agree.  On an H100
# 80GB HBM3 at 700 W the LM's fit stood 2.4e-10 and 9.7e-10 from its
# direct run (embed_weight; two direct runs 2.4e-10 and 0 apart); a fit on
# another batch or a lost step moves a leaf by about the lr, 1e-4 or more
# of its largest entry.  The general path (executor +
# Updater, MXNET_FUSED_FIT=0) over MODULE_FIT_GENERAL batches against the
# fused step from the same state within the JAX package's test bounds
# (test_fused_fit.py: assert_allclose rtol 5e-3, atol 1e-5): the Updater
# keeps the lr in float64 where the fused rule rounds it to float32.
MODULE_FIT_BATCH = 32
MODULE_FIT_BATCHES = 4
MODULE_FIT_EPOCHS = 2
MODULE_FIT_GENERAL = 2
MODULE_REPEAT_X = 4.0
MODULE_NONDET_MIN = 1e-6
# timed turns of (the fit with the prefetch on, off, the general path,
# TrainStep alone) in the module_fit phase
MODULE_TIME_TURNS = 3
MODULE_GENERAL_RTOL = 5e-3
MODULE_GENERAL_ATOL = 1e-5
# the LM through Module.fit: MODULE_LM_BATCHES batches of LM_BATCH x 1024
MODULE_LM_BATCHES = 2
# lstm_bucketing: the bucketed LSTM LM of bench/lstm_bucketing.py at its
# published widths.  (a) the RNN op at the LM's shapes (T, N, I, H, layers)
# in the modes of RNN_CASES, float32 with TF32 off: the cuDNN route and the
# plain version on the card, each output, final state and gradient (data,
# parameters, states; fixed cotangents) within RESNET_FLOOR_X times its
# float32 floor (the float32 plain version on the host against float64,
# from the inputs and RESNET_FLOOR_SAMPLES - 1 nudges of them by
# RESNET_FLOOR_NUDGE; RESNET_FLOOR_MIN at least) of the float64 plain
# version on the host, and the two routes within twice that of each other;
# (b) the FusedRNNCell LM and its LSTMCell stack (weights moved by
# unpack_weights / pack_weights) at bucket LSTM_CHECK_BUCKET, each
# forward's probabilities within the same rule of the fused graph in
# float64 on the host; (c) BucketingModule.fit, LSTM_EPOCHS epochs of
# LSTM_BATCHES_PER_BUCKET batches a bucket, with each cell.
RNN_SHAPE = dict(T=60, N=32, I=200, H=200, layers=2)
RNN_CASES = (("lstm", False), ("gru", False), ("lstm", True))
LSTM_CHECK_BUCKET = 60
LSTM_EPOCHS = 2
LSTM_BATCHES_PER_BUCKET = 4
# ssd: models/ssd.py at the example's widths (64x64 input, 1,344 anchors),
# SSD_CLASSES classes + background, batch SSD_BATCH, label width 3, on the
# example's synthetic batch.  (a) the MultiBox ops on the card against the
# float64 CPU version: targets and kept ids equal, loc_target within
# SSD_LOC_TOL and detection scores and boxes within SSD_DET_TOL of the
# largest entry (1); the NMS kernel against greedy_nms_ref on the card, ids
# equal, the rest within SSD_DET_TOL; (b) one SGD-momentum TrainStep step,
# float32 on the card against float64 on the CPU, each first momentum and
# parameter update within RESNET_FLOOR_X times its float32 floor (the
# ResNet rule); (c) Module.fit through bench/ssd_train.py at the example's
# defaults, then a timing fit at SSD_TIMING.
SSD_CLASSES = 3
SSD_BATCH = 8
SSD_ANCHORS = 1344
SSD_LOC_TOL = 1e-5
SSD_DET_TOL = 1e-6
SSD_LR = 0.005
SSD_TIMING = dict(num_classes=20, batch_size=32, num_batches=10)
# the NMS kernels' bound: the kept rows are a chain of dependent steps, one
# a kept row, taken at NMS_STEP_CYCLES cycles of the SM clock each at the
# H100 SXM's 1,980 MHz boost clock (data sheet); NMS_IOU_OPS operations a
# pair.  A step is the scan's bit test and conditional OR of the removed
# bits, three dependent instructions in its SASS (LOP3 to a predicate, SEL,
# LOP3); NMS_STEP_CYCLES is what that chain alone takes on the card, each
# row's word in a register (bench/nms_variants.py's walk, mode "step",
# clock64 over 262,144 rows: H100 80GB HBM3, 700.00 W, the SM at 1.99 GHz)
NMS_STEP_CYCLES = 13.219451904296875
NMS_SM_HZ = 1.98e9
NMS_IOU_OPS = 20
# the NMS kernels at SSD300's anchor count on random boxes (host_emu's
# "random" rows: 20 classes, the rows past a random count invalid), held
# to the plain loop on the card: (images, anchors, classes, threshold)
NMS_LARGE = (4, 8732, 20, 0.45)
# rounds of the NMS kernels' event timing, and the spin of the card (s)
# that the rounds are queued behind
NMS_TIMING_ROUNDS = 50
QUEUE_SPIN_S = 0.05
# (B, H, T, D), causal, scale: the shapes checked besides the LM's, each in
# float32 and bfloat16
FLASH_CHECKS = [
    ((4, 12, 1024, 64), False, None),
    ((1, 16, 2048, 128), True, None),
    ((2, 4, 512, 72), True, None),
    ((1, 4, 512, 256), False, None),
    ((2, 2, 384, 64), True, None),          # three 128-blocks
    ((2, 4, 512, 64), True, 0.3),
]
# Updater vs the fused rule on the same tensors (float32), and the Rtc
# sgd_mom kernel vs the registered op: max |d| over the largest |w|.  The
# Updater keeps Adam's step scalars in float64 where the fused rule rounds
# them to float32, as the JAX package's Updater and TrainStep do: a relative
# 1e-7 of each update, orders below this bound.
IMPERATIVE_TOL = 1e-6
IMP_PASSES = 3
# exp5_shared vs torch.exp(5 x), relative: expf and torch's exp are each
# within 2 ulp of exp
EXP5_TOL = 2e-6
# H100 SXM published peaks (dense): float32 on the CUDA cores, bfloat16 on
# the tensor cores, HBM3 bandwidth
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITERS = 20


def fail(msg):
    print("FAIL: %s" % msg, file=sys.stderr)
    sys.exit(1)


def is_kernel(e, device_type):
    """A profile row of work on the card: a CUDA event that is not a
    user annotation (``TrainStep.update`` is recorded on the card's
    timeline too, spanning the kernels it launched)."""
    return (e.device_type == device_type.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key != "TrainStep.update")


def time_ms(torch, fn, iters=ITERS):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, steps, rounds):
    """Device ms of each of ``steps`` (callables that enqueue work on the
    current stream): CUDA events between the steps of ``rounds`` rounds,
    all queued behind a QUEUE_SPIN_S spin of the card, so that the device
    runs them back to back whatever the host's pace; the mean over the
    rounds, a list in the order of ``steps``."""
    for fn in steps:
        fn()
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(steps) + 1)] for _ in range(rounds)]
    torch.cuda._sleep(int(QUEUE_SPIN_S * NMS_SM_HZ))
    for row in events:
        row[0].record()
        for fn, ev in zip(steps, row[1:]):
            fn()
            ev.record()
    torch.cuda.synchronize()
    return [sum(row[k].elapsed_time(row[k + 1]) for row in events) / rounds
            for k in range(len(steps))]


def nms_kernel_ms(torch, contrib, boxes, ids, threshold,
                  rounds=NMS_TIMING_ROUNDS, lib=None):
    """(mask ms, scan ms, both ms) of the NMS kernels on ``boxes`` and
    ``ids``: raw launches of ``contrib.nms_launch`` (every band of
    ``nms_plan``) through ``queued_ms``, the ids restored from ``ids``
    before each round (the copy not counted); once with an event recorded
    after each launch (by the launch check), which times the kernels one by
    one, then all of them between one pair of events (each event pair adds
    a few microseconds of its own); ``lib`` another library of the same
    launchers (default: the committed one)."""
    check = contrib._refused if lib else contrib._kernel.check
    lib = lib or contrib._kernel.get()
    out = ids.clone()
    stream = torch.cuda.current_stream().cuda_stream
    marks = []

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def marked(err, what):
        check(err, what)
        mark()

    def apart():
        mark()
        contrib.nms_launch(lib, boxes, out, threshold, stream=stream,
                           check=marked)

    def both():
        contrib.nms_launch(lib, boxes, out, threshold, stream=stream,
                           check=check)
    ms = queued_ms(torch, [lambda: out.copy_(ids), apart,
                           lambda: out.copy_(ids), both], rounds)
    per = len(marks) // (rounds + 1)      # the warm-up's marks come first
    gaps = [[marks[k + q].elapsed_time(marks[k + q + 1])
             for q in range(per - 1)] for k in range(per, len(marks), per)]
    return (sum(sum(g[0::2]) for g in gaps) / rounds,
            sum(sum(g[1::2]) for g in gaps) / rounds, ms[3])


def resnet50_geometries(mt, batch):
    """({(H, W, Cin, Cout, k, s, p): count} of the convolutions the NormConv
    peephole fuses in ResNet-50 at ``batch`` x 3 x IMAGE x IMAGE, {the same
    key: count of those that emit statistics in training})."""
    from mxnet_tpu_torch.executor import _Lowered
    net = mt.models.resnet.get_symbol(CLASSES, 50, "3,%d,%d" % (IMAGE, IMAGE))
    low = _Lowered(net)
    internals = net.get_internals()
    _, shapes, _ = internals.infer_shape(data=(batch, 3, IMAGE, IMAGE))
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._outputs, shapes)}
    geoms, stats = {}, {}
    for node in low.order:
        if id(node) not in low.nc_conv:
            continue
        src, si = node.inputs[0]
        _, cin, h, w = shape_of[(id(src), si)]
        g = low._nc_conv_attrs(node)
        cout = int(node.op.normalize_attrs(node.params)["num_filter"])
        key = (h, w, cin, cout, g["k"], g["s"], g["p"])
        geoms[key] = geoms.get(key, 0) + 1
        if id(node) in low.nc_stats_for:
            stats[key] = stats.get(key, 0) + 1
    return geoms, stats


def conv_work(n, h, w, cin, cout, k, s, p):
    """(input elements read, multiply-adds) that the convolution needs: only
    the input pixels some tap reaches (a 1x1 stride-2 conv reads a quarter
    of x) and only in-bounds taps (a padded tap multiplies a zero)."""
    def axis(size):
        out = (size + 2 * p - k) // s + 1
        taps = [o * s - p + t for o in range(out) for t in range(k)]
        inside = [i for i in taps if 0 <= i < size]
        return len(set(inside)), len(inside)
    rows, row_taps = axis(h)
    cols, col_taps = axis(w)
    return n * rows * cols * cin, n * row_taps * col_taps * cin * cout


def nc_inputs(torch, gen, batch, key, dt):
    """Random x, HWIO w (He-scaled), scale and shift of one geometry, on
    the card: x and w in ``dt``, scale and shift in float32."""
    h, w, cin, cout, k, _, _ = key
    x = torch.randn(batch, h, w, cin, device="cuda", generator=gen)
    wt = torch.randn(k, k, cin, cout, device="cuda", generator=gen) \
        * (2.0 / (k * k * cin)) ** 0.5
    sc = torch.rand(cin, device="cuda", generator=gen) + 0.5
    sh = torch.randn(cin, device="cuda", generator=gen) * 0.5
    return x.to(dt), wt.to(dt), sc, sh


def nc_library_ms(torch, nc, x, wt, sc, sh, s, p):
    """cuDNN's conv alone on the prologue's output (channels_last)."""
    import torch.nn.functional as F
    xh = nc._apply(x, sc, sh, True).permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    return time_ms(torch, lambda: F.conv2d(xh, w_oihw, stride=s, padding=p))


def nc_bound(batch, key, elem, stats):
    """(bound ms, operations ms, bytes ms) of one NormConv call: bytes are
    x as read, w, scale, shift, y and the float32 statistics; operations 2
    a MAC (the prologue's and the statistics' few an element are under 1%
    and left out)."""
    h, w, cin, cout, k, s, p = key
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x_read, macs = conv_work(batch, h, w, cin, cout, k, s, p)
    nbytes = (x_read + k * k * cin * cout + 2 * cin
              + batch * oh * ow * cout) * elem + (8 * cout if stats else 0)
    ops_ms = 2.0 * macs / PEAK_OPS["float32" if elem == 4 else
                                   "bfloat16"] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def kernel_phase(torch, nc, geoms):
    """Kernel vs plain version at every geometry; returns the float32
    main-path totals (each geometry weighted by its count in a forward)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0}
    for gi, (key, count) in enumerate(sorted(geoms.items())):
        h, w, cin, cout, k, s, p = key
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            x, wt, sc, sh = nc_inputs(torch, gen, BATCH, key, dt)
            variants = [("main", dict(relu=True, prologue=True,
                                      stats=dt == torch.float32))]
            if gi == 0:
                variants.append(("no_prologue", dict(relu=True,
                                                     prologue=False,
                                                     stats=False)))
            if gi == 1:
                variants.append(("no_relu", dict(relu=False, prologue=True,
                                                 stats=False)))
            for vname, kw in variants:
                yk, sk, qk = nc.norm_conv(x, wt, sc, sh, k, s, p, **kw)
                yk2, _, _ = nc.norm_conv(x, wt, sc, sh, k, s, p, **kw)
                yp, spl, qp = nc.norm_conv_ref(x, wt, sc, sh, k, s, p, **kw)
                torch.cuda.synchronize()
                if not torch.equal(yk, yk2):
                    fail("kernel %s %s %s: y differs between two launches"
                         % (key, dname, vname))
                err = (yk.float() - yp.float()).abs().max().item()
                ref = yp.float().abs().max().item()
                if not torch.isfinite(yk).all() or err > Y_TOL[dname] * ref:
                    fail("kernel %s %s %s: max|dy| %.3g > %g * %.3g"
                         % (key, dname, vname, err, Y_TOL[dname], ref))
                if kw["stats"]:
                    for a, b, what in ((sk, spl, "sum"), (qk, qp, "sumsq")):
                        serr = (a - b).abs().max().item()
                        sref = b.abs().max().item()
                        if serr > STATS_TOL * sref:
                            fail("kernel %s stats %s: max err %.3g > %g * "
                                 "%.3g" % (key, what, serr, STATS_TOL, sref))
                if vname == "main":
                    main_err = err
                else:
                    print("check geom=%s dtype=%s variant=%s max_abs_err=%r "
                          "max_abs_ref=%r" % (key, dname, vname, err, ref))
            main = dict(relu=True, prologue=True, stats=False)
            kernel_ms = time_ms(torch, lambda: nc.norm_conv(
                x, wt, sc, sh, k, s, p, **main))
            plain_ms = time_ms(torch, lambda: nc.norm_conv_ref(
                x, wt, sc, sh, k, s, p, **main))
            library_ms = nc_library_ms(torch, nc, x, wt, sc, sh, s, p)
            bound_ms, ops_ms, bytes_ms = nc_bound(BATCH, key,
                                                  x.element_size(), False)
            _, bm, bn, splits, _ = nc.plan(nc._kernel.get(), x.shape,
                                           wt.shape, s, p, device_index=0)
            vec_x, vec_w = nc.vec_flags(x, wt, sc.to(dt), sh.to(dt))
            print("geom H=%d W=%d Cin=%d Cout=%d k=%d s=%d p=%d count=%d "
                  "dtype=%s max_abs_err=%r kernel_ms=%r plain_ms=%r "
                  "library_ms=%r bound_ms=%r bound_by=%s tile=%dx%d "
                  "splits=%d vec16_x=%d vec16_w=%d bitwise_repeat=True"
                  % (h, w, cin, cout, k, s, p, count, dname, main_err,
                     kernel_ms, plain_ms, library_ms, bound_ms,
                     "operations" if ops_ms >= bytes_ms else "bytes",
                     bm, bn, splits, vec_x, vec_w))
            if dt == torch.float32:
                tot["ms"] += count * kernel_ms
                tot["plain_ms"] += count * plain_ms
                tot["library_ms"] += count * library_ms
                tot["bound_ms"] += count * bound_ms
                tot["ops_ms"] += count * ops_ms
                tot["bytes_ms"] += count * bytes_ms
                tot["max_abs_err"] = max(tot["max_abs_err"], main_err)
    return tot


def kernel_train_phase(torch, nc, geoms, stats_geoms, dt=None,
                       batches=(RESNET_CHECK_BATCH, RESNET_TRAIN_BATCH)):
    """The kernel at the training step's geometries in ``dt`` (float32 by
    default), TF32 off: at each of ``batches``, every geometry with the
    statistics epilogue on, y and both sums against the plain version in
    the same dtype and y bitwise over two launches; at RESNET_TRAIN_BATCH
    the kernel (with the statistics where the training graph has them),
    the plain version and cuDNN's conv in the same dtype timed beside the
    bound (``dt``'s bytes and peak).  Returns the totals of one
    batch-RESNET_TRAIN_BATCH training step's forward (RESNET_NC_PER_STEP
    launches)."""
    dt = dt or torch.float32
    dname = str(dt).split(".")[1]
    stats_tol = STATS_TOL if dt == torch.float32 else STATS_TOL_BF16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0}
    for batch in batches:
        for key, count in sorted(geoms.items()):
            h, w, cin, cout, k, s, p = key
            n_stats = stats_geoms.get(key, 0)
            x, wt, sc, sh = nc_inputs(torch, gen, batch, key, dt)
            yk, sk, qk = nc.norm_conv(x, wt, sc, sh, k, s, p, stats=True)
            yk2, _, _ = nc.norm_conv(x, wt, sc, sh, k, s, p, stats=True)
            yp, spl, qp = nc.norm_conv_ref(x, wt, sc, sh, k, s, p,
                                           stats=True)
            torch.cuda.synchronize()
            if not torch.equal(yk, yk2):
                fail("kernel train batch %d %s: y differs between two "
                     "launches" % (batch, key))
            err = (yk.float() - yp.float()).abs().max().item()
            ref = yp.float().abs().max().item()
            if not torch.isfinite(yk).all() or err > Y_TOL[dname] * ref:
                fail("kernel train %s batch %d %s: max|dy| %.3g > %g * %.3g"
                     % (dname, batch, key, err, Y_TOL[dname], ref))
            serr = 0.0
            for a, b, what in ((sk, spl, "sum"), (qk, qp, "sumsq")):
                e = (a - b).abs().max().item() / b.abs().max().item()
                serr = max(serr, e)
                if e > stats_tol:
                    fail("kernel train %s batch %d %s stats %s: relative "
                         "error %.3g > %g" % (dname, batch, key, what, e,
                                              stats_tol))
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            _, bm, bn, splits, _ = nc.plan(nc._kernel.get(), x.shape,
                                           wt.shape, s, p, device_index=0)
            line = ("geom_train dtype=%s batch=%d H=%d W=%d Cin=%d Cout=%d "
                    "k=%d s=%d p=%d count=%d stats_count=%d max_abs_err=%r "
                    "stats_rel_err=%r tile=%dx%d splits=%d"
                    % (dname, batch, h, w, cin, cout, k, s, p, count,
                       n_stats, err, serr, bm, bn, splits))
            if batch != RESNET_TRAIN_BATCH:
                print(line + " bitwise_repeat=True")
                continue
            kernel_ms = 0.0
            for with_stats, m in ((True, n_stats), (False, count - n_stats)):
                if m:
                    kernel_ms += m * time_ms(torch, lambda: nc.norm_conv(
                        x, wt, sc, sh, k, s, p, stats=with_stats))
            kernel_ms /= count
            plain_ms = time_ms(torch, lambda: nc.norm_conv_ref(
                x, wt, sc, sh, k, s, p, stats=n_stats > 0))
            library_ms = nc_library_ms(torch, nc, x, wt, sc, sh, s, p)
            bound_ms, ops_ms, bytes_ms = nc_bound(batch, key,
                                                  x.element_size(),
                                                  n_stats > 0)
            print(line + " kernel_ms=%r plain_ms=%r library_ms=%r "
                  "bound_ms=%r bound_by=%s bitwise_repeat=True"
                  % (kernel_ms, plain_ms, library_ms, bound_ms,
                     "operations" if ops_ms >= bytes_ms else "bytes"))
            for name, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                            ("library_ms", library_ms),
                            ("bound_ms", bound_ms), ("ops_ms", ops_ms),
                            ("bytes_ms", bytes_ms)):
                tot[name] += count * v
    return tot


def resnet50_params(mt, net):
    """Random ResNet-50 weights from SEED: He-scaled convolutions (the last
    1x1 of each residual branch scaled by 0.2 so the stream stays O(1)),
    BatchNorm with positive moving variances."""
    rng = np.random.default_rng(SEED)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1, 3, IMAGE, IMAGE))
    args, aux = {}, {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            gain = 1.0 if name == "fc1_weight" else 2.0
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32((gain / fan_in) ** 0.5)
            if name.endswith("_conv3_weight"):
                v *= np.float32(0.2)
        elif name.endswith("_gamma"):
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif name.endswith("_beta"):
            v = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        else:
            v = np.zeros(shape, np.float32)
        args[name] = v
    for name, shape in zip(net.list_auxiliary_states(), aux_shapes):
        if name.endswith("_moving_var"):
            aux[name] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        else:
            aux[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return mt.convert.params_from_numpy(args, aux, ctx=mt.gpu(0))


def serving_phase(torch, mt, nc, launches_per_forward):
    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    blob = resnet50_params(mt, net)
    rng = np.random.default_rng(SEED + 1)
    n_req = CLIENTS * REQUESTS_PER_CLIENT
    images = rng.uniform(-1, 1, (n_req, 3, IMAGE, IMAGE)).astype(np.float32)

    os.environ["MXNET_NORM_CONV"] = "1"
    model = mt.serving.ServedModel(net, blob, {"data": (3, IMAGE, IMAGE)},
                                   name="resnet50", max_batch=BATCH)
    rows = [None] * n_req
    lat = [None] * n_req
    errors = []
    nc.launches = 0
    t_warm = time.perf_counter()
    model.warm(timeout=600)
    warm_s = time.perf_counter() - t_warm

    def client(c):
        try:
            for j in range(REQUESTS_PER_CLIENT):
                i = c * REQUESTS_PER_CLIENT + j
                t0 = time.perf_counter()
                rows[i] = model.predict({"data": images[i]}, timeout=600)[0]
                lat[i] = time.perf_counter() - t0
        except Exception as exc:   # reported below; the phase then fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    launches = nc.launches
    stats = model.stats()
    model.close()
    if errors or any(t.is_alive() for t in threads) or \
            any(r is None for r in rows):
        fail("serving: not every request was answered: %s" % errors)
    forwards = len(model.buckets) + stats["batches"]
    print("serving requests=%d batches=%d by_bucket=%s warm_forwards=%d "
          "norm_conv_launches=%d forwards=%d warm_s=%r"
          % (stats["requests"], stats["batches"], stats["batches_by_bucket"],
             len(model.buckets), launches, forwards, warm_s))
    if launches != launches_per_forward * forwards:
        fail("norm_conv launches %d != %d x %d forwards"
             % (launches, launches_per_forward, forwards))

    # reference: the unfused graph on cuDNN (TF32 off), same weights
    os.environ["MXNET_NORM_CONV"] = "0"
    ref = mt.Predictor(net, blob, {"data": (BATCH, 3, IMAGE, IMAGE)})
    want = []
    for i in range(0, n_req, BATCH):
        ref.forward(data=images[i:i + BATCH])
        want.append(ref.get_output(0))
    want = np.concatenate(want)
    if nc.launches != launches:
        fail("the unfused reference launched the NormConv kernel")
    got = np.stack(rows)
    if got.shape != (n_req, CLASSES) or not np.isfinite(got).all():
        fail("served rows: shape %s or non-finite values" % (got.shape,))
    if np.abs(got.sum(axis=1) - 1).max() > 1e-4:
        fail("served rows do not sum to 1")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    print("serving check max_abs_diff=%r max_prob=%r tol=%g*max_prob "
          "argmax_agree=%d/%d" % (err, scale, SERVE_TOL, agree, n_req))
    if err > SERVE_TOL * scale or agree != n_req:
        fail("served rows differ from the unfused reference")
    lat_ms = np.array(lat) * 1e3
    print("serving qps=%r p50_ms=%r p99_ms=%r (%d requests, %d clients, "
          "closed loop, after warm)"
          % (n_req / wall, float(np.percentile(lat_ms, 50)),
             float(np.percentile(lat_ms, 99)), n_req, CLIENTS))
    forward_breakdown(torch, mt, net, blob, images[:BATCH])
    return launches


def resnet50_state(mt, net, batch):
    """Seed-SEED parameters (the TrainStep initializer on the host), zero
    momenta, moving statistics and a batch, as float64 numpy."""
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=RESNET_LR,
                                            momentum=0.9), ctx=mt.cpu())
    p, s, a = ts.init({"data": (batch, 3, IMAGE, IMAGE)},
                      {"softmax_label": (batch,)}, seed=SEED)
    rng = np.random.default_rng(SEED + 5)
    aux = {n: v.double().numpy() + rng.uniform(-0.1, 0.1, v.shape)
           for n, v in a.items()}
    data = {"data": rng.uniform(-1, 1, (batch, 3, IMAGE, IMAGE)),
            "softmax_label": rng.integers(0, CLASSES, batch).astype(
                np.float64)}
    return ({n: v.double().numpy() for n, v in p.items()},
            {n: tuple(x.double().numpy() for x in st) for n, st in s.items()},
            aux, data)


def nudged(state, seed, size=RESNET_FLOOR_NUDGE):
    """``state`` with each float value times 1 + u * ``size``, u uniform in
    [-1, 1]."""
    rng = np.random.default_rng(seed)

    def nudge(v):
        return v * (1 + size * rng.uniform(-1, 1, np.shape(v)))
    params, opt_state, aux, data = state
    return ({n: nudge(v) for n, v in params.items()},
            {n: tuple(nudge(x) for x in st) for n, st in opt_state.items()},
            {n: nudge(v) for n, v in aux.items()},
            {"data": nudge(data["data"]),
             "softmax_label": data["softmax_label"]})


def resnet50_trainer(mt, net, state, ctx, dtype, batch, policy=None):
    """A TrainStep with the check's optimizer on ``ctx`` (under ``policy``)
    and its state, parameters and batch at ``dtype``."""
    params, opt_state, aux, data = state
    ts = mt.TrainStep(net, mt.optimizer.SGD(
        learning_rate=RESNET_LR, momentum=0.9, rescale_grad=1.0 / batch),
        ctx=ctx, policy=policy)
    p, s, a = mt.convert.train_state_from_numpy(
        {n: v.astype(dtype) for n, v in params.items()},
        {n: tuple(x.astype(dtype) for x in st)
         for n, st in opt_state.items()},
        {n: v.astype(dtype) for n, v in aux.items()}, ctx=ctx)
    return ts, p, s, a, ts.shard_batch(
        {k: v.astype(dtype) for k, v in data.items()})


def resnet50_step(mt, net, state, ctx, dtype, batch, policy=None):
    """One step of the check's trainer from ``state`` at ``dtype`` on
    ``ctx`` (under ``policy``): ((first momenta, moving statistics, each
    parameter's update) as float64 CPU tensors, (TrainStep, params,
    opt_state, aux, batch, outputs) after it)."""
    ts, p, s, a, data = resnet50_trainer(mt, net, state, ctx, dtype, batch,
                                         policy)
    # a copy: the step updates p in place
    before = {n: v.double().cpu().clone() for n, v in p.items()}
    p, s, a, outs = ts(p, s, a, data)
    return (({n: st[0].double().cpu() for n, st in s.items()},
             {n: v.double().cpu() for n, v in a.items()},
             {n: v.double().cpu() - before[n] for n, v in p.items()}),
            (ts, p, s, a, data, outs))


def resnet50_reference(mt, net, state, batch, tag="resnet50_train"):
    """The check's references on the CPU, on the graph MXNET_NORM_CONV
    selects: (the float64 step, the RESNET_FLOOR_SAMPLES float32 steps that
    give each leaf its floor: from ``state`` and from nudges of it)."""
    t0 = time.perf_counter()
    want = resnet50_step(mt, net, state, mt.cpu(), np.float64, batch)[0]
    floors = [resnet50_step(mt, net, nudged(state, SEED + 100 + i)
                            if i else state, mt.cpu(), np.float32, batch)[0]
              for i in range(RESNET_FLOOR_SAMPLES)]
    print("%s steps=cpu_f64+%d cpu_f32 seconds=%r"
          % (tag, RESNET_FLOOR_SAMPLES, time.perf_counter() - t0))
    return want, floors


def resnet_dist(got, want):
    """(max |d| / max |w|, ||d|| / ||w||)."""
    d = got - want
    return ((d.abs().max() / want.abs().max().clamp_min(1e-300)).item(),
            (d.norm() / want.norm().clamp_min(1e-300)).item())


def resnet50_leaf_rows(torch, got, want, floors, kinds=("grad", "aux")):
    """Per gradient and moving statistic (and, with "update" in ``kinds``,
    each parameter's update) of the step ``got`` against ``want``:
    (max_rel, norm_rel, floor max_rel, floor norm_rel, max_rel and norm_rel
    as multiples of max(floor, RESNET_FLOOR_MIN), kind, name)."""
    rows = []
    for k, kind in enumerate(kinds):
        for n, ref in want[k].items():
            if not torch.isfinite(got[k][n]).all():
                fail("non-finite %s of %s" % (kind, n))
            d = resnet_dist(got[k][n], ref)
            floor = [max(m) for m in zip(*(resnet_dist(f[k][n], ref)
                                           for f in floors))]
            rows.append(d + tuple(floor)
                        + tuple(x / max(f, RESNET_FLOOR_MIN)
                                for x, f in zip(d, floor)) + (kind, n))
    return rows


def resnet50_train_phase(torch, mt, nc, norm_conv, unfused_want=None):
    """ResNet-50 training with MXNET_NORM_CONV=``norm_conv``: (a) one step
    on the card against the float64 step on the CPU, each leaf within a
    multiple of its float32 floor measured on the same graph (unfused: and
    the float64 step on the card; fused: the float64 CPU step against
    ``unfused_want``, the unfused one); (b) the loss over 9 steps on one
    batch; (c) batch 32 timed through bench/resnet50_train.py's functions
    and one step profiled.  The NormConv kernel must launch
    RESNET_NC_PER_STEP times a step (RESNET_NC_STATS_PER_STEP with
    statistics) fused, never unfused.  Returns {"img_s", "launches",
    "stats_launches", "steps", "want"}."""
    from mxnet_tpu_torch.bench import resnet50_train as rt
    os.environ["MXNET_NORM_CONV"] = norm_conv
    fused = norm_conv == "1"
    tag = "resnet50_train_fused" if fused else "resnet50_train"
    per_step = RESNET_NC_PER_STEP if fused else 0
    per_step_stats = RESNET_NC_STATS_PER_STEP if fused else 0
    counted = {"launches": 0, "stats_launches": 0, "steps": 0}

    def counted_run(what, steps, fn):
        """``fn()``, which runs ``steps`` training steps on the card, with
        the NormConv counts set to 0 before it and read after it."""
        nc.launches = nc.stats_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = (nc.launches, nc.stats_launches)
        if got != (per_step * steps, per_step_stats * steps):
            fail("%s %s: NormConv launched %d times (%d with statistics) "
                 "in %d steps, expected %d (%d) a step"
                 % (tag, what, got[0], got[1], steps, per_step,
                    per_step_stats))
        counted["launches"] += got[0]
        counted["stats_launches"] += got[1]
        counted["steps"] += steps
        return out

    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    b = RESNET_CHECK_BATCH
    state = resnet50_state(mt, net, b)
    card = {}
    # the kernel takes float32 and bfloat16 only: the fused graph's float64
    # step runs on the CPU (below), not on the card
    for dt in (np.float32,) if fused else (np.float32, np.float64):
        t0 = time.perf_counter()
        card[dt] = counted_run("check step", 1, lambda: resnet50_step(
            mt, net, state, mt.gpu(0), dt, b))
        print("%s step=card_%s seconds=%r"
              % (tag, np.dtype(dt).name, time.perf_counter() - t0))
    got, trainer = card[np.float32]
    want, floors = resnet50_reference(mt, net, state, b, tag)
    rows = resnet50_leaf_rows(torch, got, want, floors)
    if fused:
        f64_what = "cpu_f64_fused vs cpu_f64_unfused"
        f64 = max(resnet_dist(want[k][n], ref)[0]
                  for k in (0, 1) for n, ref in unfused_want[k].items())
    else:
        f64_what = "card_f64"
        f64 = max(resnet_dist(card[np.float64][0][k][n], ref)[0]
                  for k in (0, 1) for n, ref in want[k].items())
    print("%s %s worst max_rel=%r (tol %g)"
          % (tag, f64_what, f64, RESNET_F64_TOL))
    if f64 > RESNET_F64_TOL:
        fail("%s: the float64 step (%s) differs by %.3g of the largest "
             "entry (tol %g)" % (tag, f64_what, f64, RESNET_F64_TOL))
    resnet50_check_rows(torch, tag, rows, "f32_floor")

    ts, p, s, a, batch, outs = trainer
    lab = batch["softmax_label"].long()
    rows_idx = torch.arange(lab.numel(), device=lab.device)

    def loss(outs):
        return -torch.log(outs[0][rows_idx, lab]).mean().item()

    def more_steps():
        nonlocal p, s, a, outs
        for _ in range(4):
            p, s, a, outs = ts(p, s, a, batch)
            losses.append(loss(outs))
        p, s, a, outs = ts.run_steps(p, s, a, batch, 3)
        losses.append(loss(outs))
    losses = [loss(outs)]
    counted_run("8 steps", 8, more_steps)
    print("%s steps=9 (1 checked + 4 calls + run_steps(3)) "
          "batch=%d losses=%s" % (tag, b, [round(x, 6) for x in losses]))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail("%s: the loss did not fall: %s" % (tag, losses))
    del trainer, card, ts, p, s, a, batch, outs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, p, s, a, batch = rt.setup(batch=RESNET_TRAIN_BATCH, image=IMAGE,
                                  num_layers=50, num_classes=CLASSES,
                                  ctx=mt.gpu(0))
    steps = RESNET_TRAIN_ROUNDS * (RESNET_TRAIN_CHUNK + 1)
    img_s, dt, outs = counted_run(
        "batch-32 timing", steps + RESNET_TRAIN_CHUNK + 1,
        lambda: rt.timed_chunks(ts, p, s, a, batch,
                                chunk=RESNET_TRAIN_CHUNK,
                                rounds=RESNET_TRAIN_ROUNDS))
    if not torch.isfinite(outs[0]).all():
        fail("%s: non-finite outputs at batch %d"
             % (tag, RESNET_TRAIN_BATCH))
    print("%s batch=%d MXNET_NORM_CONV=%s img_per_s=%r host_ms_per_step=%r "
          "(run_steps(%d) x %d after one warm chunk, one scalar fetched; "
          "setup and warm seconds=%r) peak_mem_gb=%r (this run's)"
          % (tag, RESNET_TRAIN_BATCH, norm_conv, img_s, dt / steps * 1e3,
             RESNET_TRAIN_CHUNK, RESNET_TRAIN_ROUNDS,
             time.perf_counter() - t0 - dt,
             torch.cuda.max_memory_allocated() / 2 ** 30))
    counted_run("profiled step", 2, lambda: resnet_train_breakdown(
        torch, ts, p, s, a, batch, tag))
    print("%s MXNET_NORM_CONV=%s norm_conv_launches=%d "
          "stats_launches=%d steps=%d (%d and %d a step)"
          % (tag, norm_conv, counted["launches"], counted["stats_launches"],
             counted["steps"], per_step, per_step_stats))
    return dict(counted, img_s=img_s, want=want)


def amp_policy(mt):
    """The AMP phases' policy: bench.py's bfloat16 policy (dynamic loss
    scale from 2^15)."""
    return mt.amp.Policy("bfloat16")


def resnet50_amp_reference(mt, net, state, batch, tag):
    """The RESNET_FLOOR_SAMPLES bfloat16-policy steps of the port on the
    CPU, on the graph MXNET_NORM_CONV selects, that give each leaf its
    bfloat16 floor: from ``state`` and from nudges of it by
    RESNET_BF16_NUDGE."""
    t0 = time.perf_counter()
    floors = [resnet50_step(mt, net, nudged(state, SEED + 200 + i,
                                            RESNET_BF16_NUDGE)
                            if i else state, mt.cpu(), np.float32, batch,
                            amp_policy(mt))[0]
              for i in range(RESNET_FLOOR_SAMPLES)]
    print("%s steps=%d cpu_bf16_policy seconds=%r"
          % (tag, RESNET_FLOOR_SAMPLES, time.perf_counter() - t0))
    return floors


def amp_function_rows(torch, mt):
    """The AMP step's hand-written Functions at ResNet-50 shapes in
    bfloat16 (parameters cast to bfloat16, scale and shift float32, as the
    AMP graph hands them over), on the card against the same Function in
    float64 on the CPU on the same inputs: BatchNormTrain and
    BatchNormReLUTrain on a (4, 56, 56, 256) channel-last input whose
    channels sit off zero (the residual stream's cancellation), and
    NormConv with its statistics at stage 1's 3x3 conv (4, 56, 56, 64),
    cotangents on y and on both sums.  Each output and input gradient is a
    leaf whose floor is the same Function's bfloat16 run on the CPU.
    Returns leaf rows as ``resnet50_leaf_rows`` gives them, kind "fn"."""
    from mxnet_tpu_torch.ops import nn as pnn
    from mxnet_tpu_torch.ops import norm_conv as pnc
    gen = torch.Generator().manual_seed(SEED + 9)

    def randn(*shape, scale=1.0, shift=0.0, dt=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dt)

    def bn_case(fn):
        x = randn(4, 56, 56, 256, shift=2.0)
        ins = (x, randn(256, scale=0.2, shift=1.0), randn(256, scale=0.1))
        cots = (randn(*x.shape),)
        return ins, cots, lambda x, g, b: fn.apply(x, g, b, 1e-5, 3)

    def nc_case():
        x = randn(4, 56, 56, 64).relu()
        w = randn(64, 64, 3, 3, scale=(2.0 / (9 * 64)) ** 0.5)
        ins = (x, w, randn(64, scale=0.2, shift=1.0, dt=torch.float32),
               randn(64, scale=0.5, dt=torch.float32))
        cots = (randn(4, 56, 56, 64), randn(64, scale=0.1,
                                            dt=torch.float32),
                randn(64, scale=0.1, dt=torch.float32))
        return ins, cots, lambda x, w, sc, sh: pnc.NormConv.apply(
            x, w, sc, sh, 3, 1, 1, True, True, True)

    def run(fn, ins, cots, dev, dt=None):
        leaves = [t.to(dev, dt or t.dtype).requires_grad_(True)
                  for t in ins]
        outs = fn(*leaves)
        grads = torch.autograd.grad(
            [outs[i] for i in range(len(cots))], leaves,
            [c.to(dev, dt or c.dtype) for c in cots])
        return [t.detach().double().cpu() for t in list(outs) + list(grads)]

    rows = []
    for name, (ins, cots, fn) in (
            ("bn", bn_case(pnn.BatchNormTrain)),
            ("bn_relu", bn_case(pnn.BatchNormReLUTrain)),
            ("norm_conv", nc_case())):
        card = run(fn, ins, cots, "cuda")
        floor = run(fn, ins, cots, "cpu")
        want = run(fn, ins, cots, "cpu", torch.float64)
        names = (["out", "mean", "var", "dx", "dgamma", "dbeta"]
                 if name.startswith("bn") else
                 ["y", "sum_y", "sum_y2", "dx", "dw", "dscale", "dshift"])
        for leaf, got, f, ref in zip(names, card, floor, want):
            if not torch.isfinite(got).all():
                fail("AMP Function %s: non-finite %s" % (name, leaf))
            d, fd = resnet_dist(got, ref), resnet_dist(f, ref)
            rows.append(d + fd + tuple(x / max(y, RESNET_FLOOR_MIN)
                                       for x, y in zip(d, fd))
                        + ("fn", "%s.%s" % (name, leaf)))
    return rows


def resnet50_check_rows(torch, tag, rows, floor_name):
    """Print the worst leaves of a floor check and fail on any leaf over
    RESNET_FLOOR_X times its floor."""
    for col, what in ((4, "max_rel"), (5, "norm_rel")):
        for row in sorted(rows, key=lambda r: -r[col])[:4]:
            print("%s worst_by=floor_x_%s %s=%s max_rel=%r norm_rel=%r "
                  "%s max_rel=%r norm_rel=%r floor_x max=%r norm=%r"
                  % ((tag, what, row[6], row[7]) + row[:2] + (floor_name,)
                     + row[2:6]))
    worst = [max(r[i] for r in rows) for i in range(6)]
    print("%s check leaves=%d worst max_rel=%r norm_rel=%r, %s worst "
          "max_rel=%r norm_rel=%r; worst times its leaf's floor max=%r "
          "norm=%r (tol %g x max(floor, %g))"
          % ((tag, len(rows)) + tuple(worst[:2]) + (floor_name,)
             + tuple(worst[2:]) + (RESNET_FLOOR_X, RESNET_FLOOR_MIN)))
    for rel, nrel, frel, fnrel, xr, xn, kind, n in rows:
        if xr > RESNET_FLOOR_X or xn > RESNET_FLOOR_X:
            fail("%s: %s of %s differs from the float64 step by %.3g of "
                 "its largest entry and %.3g in norm, %.3g and %.3g times "
                 "its %s (%.3g, %.3g; tol %g x)"
                 % (tag, kind, n, rel, nrel, xr, xn, floor_name, frel,
                    fnrel, RESNET_FLOOR_X))
    return worst


def sync_free(torch, what, fn):
    """``fn()`` with torch's CUDA sync debug mode at "warn", each
    synchronisation recorded with the stack of this repo's frames, then
    once more at "error": fails on any synchronisation."""
    import traceback
    import warnings
    seen = []
    real = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            here = [fr for fr in traceback.extract_stack()[:-1]
                    if "mxnet_tpu_torch" in fr.filename]
            seen.append((str(message), ["%s:%d %s" % (
                os.path.relpath(fr.filename), fr.lineno, fr.name)
                for fr in here[-6:]]))
        else:
            real(message, category, filename, lineno, file, line)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = real
    for msg, stack in seen:
        print("sync %s: %s at %s" % (what, msg.splitlines()[0], stack))
    if seen:
        fail("%s: %d host synchronisations in the step" % (what, len(seen)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("sync %s: none under set_sync_debug_mode warn, then error" % what)


def resnet50_train_amp_phase(torch, mt, nc, norm_conv, want, f32_img_s):
    """ResNet-50 training under Policy("bfloat16") with MXNET_NORM_CONV=
    ``norm_conv``: (a) one step at batch RESNET_CHECK_BATCH on the card
    against ``want``, the float64 CPU step of the float32 phase on the same
    graph, each leaf within RESNET_FLOOR_X times its bfloat16 floor;
    (b) exact checks: an overflow batch leaves the state bitwise unchanged,
    halves the scale and counts one overflow; one step with no host
    synchronisation; unfused, a float32 policy with a power-of-two scale
    trains bitwise as the plain float32 step (cuDNN deterministic); (c) the
    loss over 9 steps on one batch; (d) batch 32 timed through
    bench/resnet50_train.py's functions and one step profiled.  Fused, the
    NormConv kernel must launch RESNET_NC_PER_STEP times a step
    (RESNET_NC_STATS_PER_STEP with statistics), every launch in bfloat16.
    Returns {"img_s", "launches", "stats_launches", "bf16_launches",
    "steps", "worst"}."""
    from mxnet_tpu_torch.bench import resnet50_train as rt
    os.environ["MXNET_NORM_CONV"] = norm_conv
    fused = norm_conv == "1"
    tag = "resnet50_train_amp_fused" if fused else "resnet50_train_amp"
    per_step = RESNET_NC_PER_STEP if fused else 0
    per_step_stats = RESNET_NC_STATS_PER_STEP if fused else 0
    counted = {"launches": 0, "stats_launches": 0, "bf16_launches": 0,
               "steps": 0}
    policy = amp_policy(mt)
    gpu = mt.gpu(0)

    def counted_run(what, steps, fn):
        """``fn()``, which runs ``steps`` AMP steps on the card, with the
        NormConv counts set to 0 before it and read after it."""
        nc.launches = nc.stats_launches = nc.bf16_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = (nc.launches, nc.stats_launches, nc.bf16_launches)
        if got != (per_step * steps, per_step_stats * steps,
                   per_step * steps):
            fail("%s %s: NormConv launched %d times (%d with statistics, "
                 "%d in bfloat16) in %d steps, expected %d (%d) a step, "
                 "all in bfloat16" % ((tag, what) + got
                                      + (steps, per_step, per_step_stats)))
        for k, v in zip(("launches", "stats_launches", "bf16_launches"),
                        got):
            counted[k] += v
        counted["steps"] += steps
        return out

    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    b = RESNET_CHECK_BATCH
    state = resnet50_state(mt, net, b)
    t0 = time.perf_counter()
    got, trainer = counted_run("check step", 1, lambda: resnet50_step(
        mt, net, state, gpu, np.float32, b, policy))
    print("%s step=card_bf16_policy seconds=%r"
          % (tag, time.perf_counter() - t0))
    floors = resnet50_amp_reference(mt, net, state, b, tag)
    worst = resnet50_check_rows(
        torch, tag, resnet50_leaf_rows(torch, got, want, floors, AMP_KINDS),
        "bf16_floor")
    resnet50_check_rows(torch, tag + " functions", amp_function_rows(
        torch, mt), "cpu_bf16_floor")

    # exact checks: the overflow skip, no host sync, the pow2 f32 policy
    ts, p, s, a, data = resnet50_trainer(mt, net, state, gpu, np.float32,
                                         b, policy)
    bad = dict(data, data=data["data"].clone())
    bad["data"][1, 2, 3, 4] = float("inf")
    before = ({n: v.clone() for n, v in p.items()},
              {n: tuple(x.clone() for x in st) for n, st in s.items()},
              {n: v.clone() for n, v in a.items()})
    counted_run("overflow step", 1, lambda: ts(p, s, a, bad))
    same = (all(torch.equal(before[0][n], p[n]) for n in p)
            and all(torch.equal(x, y) for n in s
                    for x, y in zip(before[1][n], s[n]))
            and all(torch.equal(before[2][n], a[n]) for n in a))
    host = ts.scale_state_host()
    print("%s overflow step: params, momenta and moving statistics "
          "bitwise unchanged=%s scale_state=%s"
          % (tag, same, host))
    if not same or host != {"scale": policy.loss_scale / 2, "good": 0,
                            "overflow": 1}:
        fail("%s: the overflow step changed the state or the scale: %s"
             % (tag, host))
    counted_run("sync-free steps", 2, lambda: sync_free(
        torch, tag, lambda: ts(p, s, a, data)))
    del ts, p, s, a, data, bad, before
    if not fused:
        torch.backends.cudnn.deterministic = True
        try:
            steps = [resnet50_step(mt, net, state, gpu, np.float32, b,
                                   pol)[1]
                     for pol in (None, mt.amp.Policy(
                         "float32", loss_scale=2.0 ** 10))]
        finally:
            torch.backends.cudnn.deterministic = False
        (_, p0, s0, a0, _, o0), (_, p1, s1, a1, _, o1) = steps
        exact = (all(torch.equal(p0[n], p1[n]) for n in p0)
                 and all(torch.equal(x, y) for n in s0
                         for x, y in zip(s0[n], s1[n]))
                 and all(torch.equal(a0[n], a1[n]) for n in a0)
                 and torch.equal(o0[0], o1[0]))
        print("%s float32 policy loss_scale=2^10 vs plain float32 step "
              "(cudnn.deterministic): bitwise_equal=%s" % (tag, exact))
        if not exact:
            fail("%s: the float32 policy step with a power-of-two scale "
                 "differs from the plain step" % tag)
        del steps, p0, s0, a0, o0, p1, s1, a1, o1

    ts, p, s, a, batch, outs = trainer
    lab = batch["softmax_label"].long()
    rows_idx = torch.arange(lab.numel(), device=lab.device)

    def loss(outs):
        return -torch.log(outs[0][rows_idx, lab]).mean().item()

    def more_steps():
        nonlocal p, s, a, outs
        for _ in range(4):
            p, s, a, outs = ts(p, s, a, batch)
            losses.append(loss(outs))
        p, s, a, outs = ts.run_steps(p, s, a, batch, 3)
        losses.append(loss(outs))
    losses = [loss(outs)]
    counted_run("8 steps", 8, more_steps)
    print("%s steps=9 (1 checked + 4 calls + run_steps(3)) batch=%d "
          "losses=%s scale_state=%s" % (tag, b, [round(x, 6) for x in losses],
                                        ts.scale_state_host()))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail("%s: the loss did not fall: %s" % (tag, losses))
    del trainer, ts, p, s, a, batch, outs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts, p, s, a, batch = rt.setup(batch=RESNET_TRAIN_BATCH, image=IMAGE,
                                  num_layers=50, num_classes=CLASSES,
                                  ctx=gpu, policy=policy)
    steps = RESNET_TRAIN_ROUNDS * (RESNET_TRAIN_CHUNK + 1)
    img_s, dt, outs = counted_run(
        "batch-32 timing", steps + RESNET_TRAIN_CHUNK + 1,
        lambda: rt.timed_chunks(ts, p, s, a, batch,
                                chunk=RESNET_TRAIN_CHUNK,
                                rounds=RESNET_TRAIN_ROUNDS))
    if not torch.isfinite(outs[0]).all() or outs[0].dtype != torch.float32:
        fail("%s: outputs at batch %d are %s or not finite"
             % (tag, RESNET_TRAIN_BATCH, outs[0].dtype))
    print("%s batch=%d MXNET_NORM_CONV=%s policy=%s img_per_s=%r "
          "host_ms_per_step=%r (run_steps(%d) x %d after one warm chunk, "
          "one scalar fetched; setup and warm seconds=%r) peak_mem_gb=%r "
          "(this run's); float32 img_per_s=%r in this call, bf16/f32=%r"
          % (tag, RESNET_TRAIN_BATCH, norm_conv, policy.describe(), img_s,
             dt / steps * 1e3, RESNET_TRAIN_CHUNK, RESNET_TRAIN_ROUNDS,
             time.perf_counter() - t0 - dt,
             torch.cuda.max_memory_allocated() / 2 ** 30, f32_img_s,
             img_s / f32_img_s))
    counted_run("profiled step", 2, lambda: resnet_train_breakdown(
        torch, ts, p, s, a, batch, tag))
    print("%s MXNET_NORM_CONV=%s norm_conv_launches=%d stats_launches=%d "
          "bf16_launches=%d steps=%d (%d and %d a step)"
          % (tag, norm_conv, counted["launches"], counted["stats_launches"],
             counted["bf16_launches"], counted["steps"], per_step,
             per_step_stats))
    return dict(counted, img_s=img_s, worst=worst)


def module_host(mod):
    """The module's parameters and aux states as float32 numpy."""
    args, auxs = mod.get_params()
    return ({n: v.asnumpy() for n, v in args.items()},
            {n: v.asnumpy() for n, v in auxs.items()})


def module_worst(got, want):
    """(max over the leaves of max |got - want| / max |want|, its leaf)."""
    worst = (0.0, None)
    for n, w in want.items():
        d = float(np.abs(got[n] - w).max() / max(np.abs(w).max(), 1e-30))
        if d > worst[0]:
            worst = (d, n)
    return worst


def module_env(env, fn):
    """``fn()`` with the MXNET_* variables of ``env`` set (None: unset)."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def module_direct(torch, mt, net, args, aux, batches, opt, snap_after):
    """The fused fit's computation without Module: a TrainStep with
    ``opt`` on gpu(0) from ``args``/``aux``, one ``__call__`` per host
    batch, each moved by ``shard_batch``.  Returns ((params, aux) as numpy
    after every batch, the same after ``snap_after`` batches)."""
    dev = mt.gpu(0).torch_device()
    ts = mt.TrainStep(net, opt, ctx=mt.gpu(0))
    # copies: the step updates them in place
    p = {n: torch.from_numpy(v).to(dev, copy=True) for n, v in args.items()}
    a = {n: torch.from_numpy(v).to(dev, copy=True) for n, v in aux.items()}
    s = ts.fopt.init_state(p)

    def host():
        return ({n: v.to("cpu", copy=True).numpy() for n, v in p.items()},
                {n: v.to("cpu", copy=True).numpy() for n, v in a.items()})
    snap = None
    for i, b in enumerate(batches):
        if i == snap_after:
            snap = host()
        p, s, a, outs = ts(p, s, a, ts.shard_batch(b))
    if not torch.isfinite(outs[0]).all():
        fail("module_fit: non-finite outputs of the direct TrainStep run")
    return host(), snap


def module_same(torch, mt, what, got, want, rerun):
    """Hold a fit's (params, aux) to a direct run's: bitwise, or within
    max(MODULE_REPEAT_X times the distance ``rerun()`` (a second direct
    run) lies from ``want``, MODULE_NONDET_MIN)."""
    worst = max(module_worst(got[k], want[k]) for k in (0, 1))
    if worst[0] == 0.0:
        print("module_fit %s: bitwise equal" % what)
        return
    again = rerun()
    floor = max(module_worst(again[k], want[k]) for k in (0, 1))
    tol = max(MODULE_REPEAT_X * floor[0], MODULE_NONDET_MIN)
    print("module_fit %s: not bitwise: worst max_rel=%r (%s); two direct "
          "runs %r apart (%s); tol %r" % (what, worst[0], worst[1], floor[0],
                                         floor[1], tol))
    if worst[0] > tol:
        fail("module_fit %s: %s differs by %.3g of its largest entry, "
             "two direct runs by %.3g (tol %g)" % (what, worst[1], worst[0],
                                                   floor[0], tol))


def module_fit_phase(torch, mt, nc, fa, bench_img_s):
    """ResNet-50 at full width and the LM at GPT-2-small widths trained
    through ``Module.fit`` on gpu(0) (see MODULE_FIT_*).  Returns the
    kernels' launches counted in the phase's fits: {"norm_conv",
    "norm_conv_stats", "norm_conv_bf16", "flash": (fwd, dq, dkv)}."""
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        counts = module_fit_resnet(torch, mt, nc, bench_img_s)
        counts["flash"] = module_fit_lm(torch, mt, fa)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    return counts


def module_fit_resnet(torch, mt, nc, bench_img_s):
    os.environ["MXNET_NORM_CONV"] = "0"
    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    b, nb = MODULE_FIT_BATCH, MODULE_FIT_BATCHES
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p0, _, a0 = ts0.init({"data": (b, 3, IMAGE, IMAGE)},
                         {"softmax_label": (b,)}, seed=SEED)
    args = {n: v.numpy() for n, v in p0.items()}
    aux = {n: v.numpy() for n, v in a0.items()}
    del ts0, p0, a0
    rng = np.random.default_rng(SEED + 7)
    x = rng.uniform(-1, 1, (nb * b, 3, IMAGE, IMAGE)).astype(np.float32)
    y = rng.integers(0, CLASSES, nb * b).astype(np.float32)
    print("module_fit resnet50 host data %d x %d images = %.1f MB, %d "
          "epochs" % (nb, b, x.nbytes / 1e6, MODULE_FIT_EPOCHS))
    batches = [{"data": x[i * b:(i + 1) * b],
                "softmax_label": y[i * b:(i + 1) * b]} for i in range(nb)]
    opt_params = dict(learning_rate=RESNET_LR, momentum=0.9, wd=1e-4)

    def sgd():
        return mt.optimizer.SGD(rescale_grad=1.0 / b, **opt_params)

    def fit(mod, it, epochs, env=None, callback=None):
        """``mod.fit`` over ``it`` (with ``callback`` at each batch end);
        (seconds, host ms between consecutive batch ends within an epoch,
        averaged)."""
        ends = []

        def at_end(p):
            ends.append((p.nbatch, time.perf_counter()))
            if callback is not None:
                callback(p)
        t0 = time.perf_counter()
        module_env(env or {}, lambda: mod.fit(
            it, num_epoch=epochs, optimizer="sgd",
            optimizer_params=opt_params, arg_params=args, aux_params=aux,
            batch_end_callback=at_end))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gaps = [t1 - t0_ for (n0, t0_), (n1, t1) in zip(ends, ends[1:])
                if n1 == n0 + 1]
        return dt, 1e3 * sum(gaps) / max(1, len(gaps))

    def launches(steps, want, fn, what):
        """``fn()`` with the NormConv counts at 0 before and read after."""
        nc.launches = nc.stats_launches = nc.bf16_launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = (nc.launches, nc.stats_launches, nc.bf16_launches)
        print("module_fit %s norm_conv launches=%d stats=%d bf16=%d in %d "
              "steps" % ((what,) + got + (steps,)))
        if got != tuple(steps * w for w in want):
            fail("module_fit %s: NormConv launched %s in %d steps, expected "
                 "%s a step" % (what, got, steps, want))
        return out, got

    it = mt.io.NDArrayIter(x, y, batch_size=b)
    steps = nb * MODULE_FIT_EPOCHS
    # (a) the fused fit, MXNET_NORM_CONV=0: no NormConv launch
    mod = mt.Module(net, context=mt.gpu(0))
    (fit_s, _), _ = launches(steps, (0, 0, 0),
                                  lambda: fit(mod, it, MODULE_FIT_EPOCHS),
                                  "fused fit MXNET_NORM_CONV=0")
    if mod._fused_ts_cache is None:
        fail("module_fit: the fused path did not engage")
    ts_f32 = mod._fused_ts_cache[1]
    got = module_host(mod)
    # (b) the direct TrainStep run over the same batches in the same order
    order = batches * MODULE_FIT_EPOCHS
    want, snap = module_direct(torch, mt, net, args, aux, order, sgd(),
                               MODULE_FIT_GENERAL)
    module_same(torch, mt, "fit vs direct TrainStep", got, want,
                lambda: module_direct(torch, mt, net, args, aux, order,
                                      sgd(), MODULE_FIT_GENERAL)[0])
    # (c) the same fit with the device prefetch off
    mod_off = mt.Module(net, context=mt.gpu(0))
    fit(mod_off, it, MODULE_FIT_EPOCHS, {"MXNET_DEVICE_PREFETCH": "0"})
    module_same(torch, mt, "prefetch on vs off", module_host(mod_off), got,
                lambda: module_direct(torch, mt, net, args, aux, order,
                                      sgd(), MODULE_FIT_GENERAL)[0])
    del mod_off
    # (d) the general path over the first batches against the fused step,
    # then an epoch of it timed
    mod_g = mt.Module(net, context=mt.gpu(0))
    ng = MODULE_FIT_GENERAL
    fit(mod_g, mt.io.NDArrayIter(x[:ng * b], y[:ng * b], batch_size=b), 1,
        {"MXNET_FUSED_FIT": "0"})
    if mod_g._fused_ts_cache is not None:
        fail("module_fit: MXNET_FUSED_FIT=0 took the fused path")
    general = module_host(mod_g)
    worst = 0.0
    for k in (0, 1):
        for n, w in snap[k].items():
            g = general[k][n]
            excess = np.abs(g - w) - (MODULE_GENERAL_ATOL
                                      + MODULE_GENERAL_RTOL * np.abs(w))
            worst = max(worst, float(np.abs(g - w).max()))
            if (excess > 0).any():
                fail("module_fit: the general path's %s differs from the "
                     "fused step's beyond rtol %g atol %g (max |d| %.3g)"
                     % (n, MODULE_GENERAL_RTOL, MODULE_GENERAL_ATOL,
                        float(np.abs(g - w).max())))
    print("module_fit general path (executor + Updater) %d batches: max "
          "|d| from the fused step=%r (rtol %g atol %g)"
          % (ng, worst, MODULE_GENERAL_RTOL, MODULE_GENERAL_ATOL))
    # timing, in turns (the host's speed drifts within a call): the fused
    # fit's host ms between batch ends with the prefetch on and off, the
    # general path's, and TrainStep steps over the same batches already on
    # the card, ending in a synchronize.  The host runs ahead of the card
    # until the launch queue fills, so in steady state a gap between batch
    # ends is the time a batch.
    dev = mt.gpu(0).torch_device()
    ts_t = mt.TrainStep(net, sgd(), ctx=mt.gpu(0))
    pt = {n: torch.from_numpy(v).to(dev, copy=True) for n, v in args.items()}
    at = {n: torch.from_numpy(v).to(dev, copy=True) for n, v in aux.items()}
    st = ts_t.fopt.init_state(pt)
    staged = [ts_t.shard_batch(bb) for bb in batches]
    fit_runs, off_runs, general_runs, step_runs = [], [], [], []
    for _ in range(MODULE_TIME_TURNS):
        fit_runs.append(fit(mod, it, MODULE_FIT_EPOCHS)[1])
        off_runs.append(fit(mod, it, MODULE_FIT_EPOCHS,
                            {"MXNET_DEVICE_PREFETCH": "0"})[1])
        general_runs.append(fit(mod_g, it, 1, {"MXNET_FUSED_FIT": "0"})[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            pt, st, at, _ = ts_t(pt, st, at, staged[i % nb])
        torch.cuda.synchronize()
        step_runs.append((time.perf_counter() - t0) * 1e3 / steps)
    del ts_t, pt, at, st, staged, mod_g

    def median(v):
        return sorted(v)[len(v) // 2]

    def minus(a, b):
        return [x - y for x, y in zip(a, b)]
    print("module_fit resnet50 batch=%d (%d turns) host_ms_per_batch: "
          "fused fit %r, prefetch off %r, general path (executor + "
          "Updater) %r; TrainStep on device batches ms_per_step %r"
          % (b, MODULE_TIME_TURNS, fit_runs, off_runs, general_runs,
             step_runs))
    print("module_fit resnet50 medians: fit img_per_s=%r TrainStep "
          "img_per_s=%r module_layer_host_ms_per_batch=%r (turns %r) "
          "prefetch_off_minus_on_ms=%r (turns %r) general_minus_fused_ms=%r "
          "(turns %r); first fit with set-up and sync-back: %.3f s for %d "
          "batches, img_per_s=%r; bench resnet50_train img_per_s=%r "
          "(float32 unfused, this call, cudnn.deterministic off)"
          % (1e3 * b / median(fit_runs), 1e3 * b / median(step_runs),
             median(minus(fit_runs, step_runs)), minus(fit_runs, step_runs),
             median(minus(off_runs, fit_runs)), minus(off_runs, fit_runs),
             median(minus(general_runs, fit_runs)),
             minus(general_runs, fit_runs), fit_s, steps, steps * b / fit_s,
             bench_img_s))
    # (e) the same module fit again under MXNET_NORM_CONV=1: the lever is
    # read at every run, so the cached TrainStep serves it
    counted = {"norm_conv": 0, "norm_conv_stats": 0, "norm_conv_bf16": 0}
    _, got_nc = launches(nb, (RESNET_NC_PER_STEP, RESNET_NC_STATS_PER_STEP,
                              0),
                         lambda: fit(mod, it, 1, {"MXNET_NORM_CONV": "1"}),
                         "fused fit MXNET_NORM_CONV=1")
    if mod._fused_ts_cache[1] is not ts_f32:
        fail("module_fit: toggling MXNET_NORM_CONV rebuilt the TrainStep")
    # (f) and under MXNET_AMP=1: a new bfloat16 step, NormConv in bfloat16
    scales = []

    def amp_fit():
        return fit(mod, it, 1, {"MXNET_NORM_CONV": "1", "MXNET_AMP": "1"},
                   lambda p: scales.append(p.locals["fast"].amp_stats()))
    _, got_amp = launches(nb, (RESNET_NC_PER_STEP, RESNET_NC_STATS_PER_STEP,
                               RESNET_NC_PER_STEP), amp_fit,
                          "fused fit MXNET_AMP=1 MXNET_NORM_CONV=1")
    ts_amp = mod._fused_ts_cache[1]
    if ts_amp is ts_f32 or ts_amp.policy is None \
            or ts_amp.policy.compute_dtype != "bfloat16":
        fail("module_fit: MXNET_AMP=1 did not build a bfloat16 TrainStep")
    masters = module_host(mod)
    bad = [n for k in (0, 1) for n, v in masters[k].items()
           if v.dtype != np.float32 or not np.isfinite(v).all()]
    ex = mod._exec_group.execs[0]
    bad += [n for n, v in ex.arg_dict.items() if v.dtype != np.float32]
    if bad or not scales or not all(s is not None and s[0] > 0
                                    for s in scales):
        fail("module_fit AMP: masters %s not finite float32, or no loss "
             "scale (%s)" % (bad[:4], scales))
    print("module_fit AMP loss scale per batch (amp_stats: scale, "
          "overflows)=%s; masters float32 after sync_back" % (scales,))
    for k, v in zip(("norm_conv", "norm_conv_stats"), (0, 1)):
        counted[k] += got_nc[v] + got_amp[v]
    counted["norm_conv_bf16"] += got_amp[2]
    # (g) the batch loop of a fit (no callbacks) without a host sync
    fast = mod._start_fused_fit()
    metric = mt.metric.Accuracy()

    def loop():
        it.reset()
        data_iter = fast.prefetch(iter(it))
        try:
            for batch in data_iter:
                outs, labels = fast.step(batch)
                metric.update(labels, outs)
        finally:
            data_iter.drain()
    sync_free(torch, "module_fit batch loop (prefetch on)", loop)
    fast.sync_back()
    it.reset()
    # (h) save_checkpoint, Module.load and score
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "module_fit")
    os.makedirs(ck_dir, exist_ok=True)
    prefix = os.path.join(ck_dir, "resnet50")
    try:
        mod.save_checkpoint(prefix, MODULE_FIT_EPOCHS)
        acc = mod.score(it, "acc")[0][1]
        back = mt.Module.load(prefix, MODULE_FIT_EPOCHS, context=mt.gpu(0))
        back.bind(it.provide_data, it.provide_label, for_training=False)
        acc_back = back.score(it, "acc")[0][1]
        saved = module_host(mod)
        loaded = module_host(back)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    if acc_back != acc or module_worst(loaded[0], saved[0])[0] != 0.0:
        fail("module_fit: Module.load of the checkpoint scores %r, the "
             "module %r" % (acc_back, acc))
    print("module_fit checkpoint round trip: score accuracy=%r both"
          % acc)
    del mod, back, fast
    torch.cuda.empty_cache()
    return counted


def module_fit_lm(torch, mt, fa):
    """The LM at GPT-2-small widths through Module.fit with Adam(LM_LR):
    MODULE_LM_BATCHES batches, 36 flash launches a step, the parameters
    against a direct TrainStep run.  Returns the flash launches of the
    fit."""
    net = mt.models.transformer.get_symbol(**LM)
    weights = lm_weights(net)
    rng = np.random.default_rng(SEED + 9)
    toks = rng.integers(0, LM["vocab_size"],
                        (MODULE_LM_BATCHES * LM_BATCH, LM["seq_len"] + 1))
    data = toks[:, :-1].astype(np.float32)
    label = toks[:, 1:].astype(np.float32)
    it = mt.io.NDArrayIter(data, label, batch_size=LM_BATCH)
    mod = mt.Module(net, context=mt.gpu(0))
    reset_flash_counts(fa)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": LM_LR}, arg_params=weights,
            aux_params={})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = flash_counts(fa)
    want = (LM["num_layers"] * MODULE_LM_BATCHES,) * 3
    print("module_fit lm %d batches of %dx%d: flash_fwd_launches=%d "
          "flash_dq_launches=%d flash_dkv_launches=%d seconds=%r (with "
          "set-up and sync-back)" % ((MODULE_LM_BATCHES, LM_BATCH,
                                      LM["seq_len"]) + counts + (dt,)))
    if counts != want:
        fail("module_fit lm: flash launches %s in %d steps, want 12 of each "
             "a step" % (counts, MODULE_LM_BATCHES))
    if mod._fused_ts_cache is None:
        fail("module_fit lm: the fused path did not engage")
    got = module_host(mod)
    del mod
    batches = [{"data": data[i * LM_BATCH:(i + 1) * LM_BATCH],
                "softmax_label": label[i * LM_BATCH:(i + 1) * LM_BATCH]}
               for i in range(MODULE_LM_BATCHES)]

    def direct():
        return module_direct(torch, mt, net, weights, {}, batches,
                             mt.optimizer.Adam(learning_rate=LM_LR,
                                               rescale_grad=1.0 / LM_BATCH),
                             MODULE_LM_BATCHES - 1)[0]
    module_same(torch, mt, "lm fit vs direct TrainStep", got, direct(),
                direct)
    torch.cuda.empty_cache()
    return counts


def resnet_train_breakdown(torch, ts, params, state, aux, batch, tag):
    """Device time of one TrainStep call (after one warm call) by group,
    from torch.profiler: the NormConv kernel (``nc_kernel``), cuDNN's
    convolutions (forward, data and weight gradients, with their layout
    transposes) and the FC's GEMM by kernel name, the SGD rule by the
    ``TrainStep.update`` range that holds its launches, the casts (the
    kernels of ``aten::_to_copy`` outside that range: an AMP step's
    compute-dtype copies and their gradients), and the rest (BatchNorm,
    ReLU gates, residual adds, pooling, the loss head)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    conv_keys = ("conv", "cudnn", "implicit", "dgrad", "wgrad", "xmma",
                 "sm90_", "sm80_", "cutlass", "winograd", "fft", "gemm",
                 "nvjet")
    ts(params, state, aux, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts(params, state, aux, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if is_kernel(e, DeviceType)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    nc_us = sum(e.self_device_time_total for e in kernels
                if "nc_kernel" in e.key)
    conv_us = sum(e.self_device_time_total for e in kernels
                  if any(k in e.key.lower() for k in conv_keys)
                  and "nc_kernel" not in e.key)
    sgd_us, sgd_n, sgd_host_us = 0.0, 0, 0.0
    for e in prof.events():
        if e.name == "TrainStep.update" and e.device_type == DeviceType.CPU:
            sgd_host_us += e.cpu_time_total
        if not e.kernels:
            continue
        up = e
        while up is not None and up.name != "TrainStep.update":
            up = up.cpu_parent
        if up is not None:
            sgd_us += sum(k.duration for k in e.kernels)
            sgd_n += len(e.kernels)
    cast_us, cast_n = 0.0, 0
    for e in prof.events():
        if not e.kernels:
            continue
        up, cast = e, False
        while up is not None and up.name != "TrainStep.update":
            cast = cast or up.name == "aten::_to_copy"
            up = up.cpu_parent
        if cast and up is None:
            cast_us += sum(k.duration for k in e.kernels
                           if "nc_kernel" not in k.name and not any(
                               c in k.name.lower() for c in conv_keys))
            cast_n += len(e.kernels)
    rest_us = busy_us - nc_us - conv_us - sgd_us - cast_us
    print("profile %s step: wall_us=%r device_busy_us=%r "
          "device_busy_share=%r kernels=%d launches=%d peak_mem_gb=%r"
          % (tag, wall_us, busy_us, busy_us / wall_us, len(kernels),
             sum(e.count for e in kernels),
             torch.cuda.max_memory_allocated() / 2 ** 30))
    print("profile %s group=casts us=%r launches=%d share=%r (kernels "
          "under aten::_to_copy outside the update: the compute-dtype "
          "copies and their gradients)"
          % (tag, cast_us, cast_n, cast_us / max(busy_us, 1e-9)))
    for group, us in (("norm_conv", nc_us), ("conv_gemm", conv_us),
                      ("bn_elementwise_other", rest_us)):
        print("profile %s group=%s us=%r share=%r"
              % (tag, group, us, us / max(busy_us, 1e-9)))
    print("profile %s group=sgd us=%r launches=%d share=%r "
          "host_us=%r (the TrainStep.update range on the host, profiled)"
          % (tag, sgd_us, sgd_n, sgd_us / max(busy_us, 1e-9), sgd_host_us))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print("profile %s kernel us=%r count=%d share=%r name=%s"
              % (tag, e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9),
                 e.key[:120]))


def forward_breakdown(torch, mt, net, blob, x, reps=5):
    """One batch-8 Predictor forward, unfused and fused: host time per
    forward (input staging included, ending in a synchronize), the device
    time and launches of one profiled forward each, and for the fused one
    the device time by kernel from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for flag, label in (("0", "unfused"), ("1", "fused")):
        os.environ["MXNET_NORM_CONV"] = flag
        pred = mt.Predictor(net, blob, {"data": x.shape})
        pred.forward(data=x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.forward(data=x)
        torch.cuda.synchronize()
        print("forward batch=%d MXNET_NORM_CONV=%s host_ms=%r"
              % (x.shape[0], flag, (time.perf_counter() - t0) / reps * 1e3))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred.forward(data=x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if is_kernel(e, DeviceType)]
        busy_us = sum(e.self_device_time_total for e in kernels)
        print("profile %s forward: wall_us=%r device_busy_us=%r "
              "device_busy_share=%r kernels=%d launches=%d"
              % (label, wall_us, busy_us, busy_us / wall_us, len(kernels),
                 sum(e.count for e in kernels)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print("profile kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9), e.key[:90]))


def lm_qkv(torch, gen, b, h, t, d, dtype):
    """q, k, v as the LM's graph hands them to attention: (B, H, T, D)
    strided views into one (B, T, 3, H, D) projection output."""
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen)
    qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def flash_work(b, h, t, d, causal, elem):
    """(operations, bytes) the attention needs: 4·D per unmasked (q, k) pair
    (q·k and p·v, a multiply and an add each); q, k, v and o once plus the
    float32 lse."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4.0 * b * h * d * pairs, 4.0 * b * h * t * d * elem + 4.0 * b * h * t


def bound(ops, nbytes, dname):
    """(bound ms, what bounds it) at the card's published peaks."""
    ops_ms = ops / PEAK_OPS[dname] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def flash_check(torch, fa, q, k, v, causal, scale, label):
    """Kernel vs plain version on the same inputs, and the kernel against
    itself over two launches; returns (max |do|, max |dlse|)."""
    ok, lk = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    ok2, lk2 = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    op, lp = fa.flash_attention_ref(q, k, v, causal, scale)
    torch.cuda.synchronize()
    if not (torch.equal(ok, ok2) and torch.equal(lk, lk2)):
        fail("flash %s: o or lse differs between two launches" % label)
    dname = str(q.dtype).split(".")[1]
    err = (ok.float() - op.float()).abs().max().item()
    ref = op.float().abs().max().item()
    lerr = (lk - lp).abs().max().item()
    lref = max(1.0, lp.abs().max().item())
    if not (torch.isfinite(ok).all() and torch.isfinite(lk).all()):
        fail("flash %s: non-finite output" % label)
    if ok.dtype != q.dtype or lk.dtype != torch.float32 or \
            ok.shape != q.shape or lk.shape != q.shape[:3] + (1,):
        fail("flash %s: outputs %s %s, %s %s" % (label, ok.dtype,
                                                  tuple(ok.shape), lk.dtype,
                                                  tuple(lk.shape)))
    if err > O_TOL[dname] * ref or lerr > LSE_TOL * lref:
        fail("flash %s: max|do| %.3g > %g * %.3g or max|dlse| %.3g > %g * "
             "%.3g" % (label, err, O_TOL[dname], ref, lerr, LSE_TOL, lref))
    return err, lerr


def sdpa_backend(torch, fn):
    """Names of the CUDA kernels one call of ``fn`` runs (which of SDPA's
    backends ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Memset")})


def flash_phase(torch, fa):
    """Kernel vs plain version, timed beside SDPA and the bound, at the LM's
    shape (q, k, v made as the LM makes them) and at FLASH_CHECKS, in float32
    and bfloat16.  Returns the float32 numbers per launch at the LM's
    shape, and under "bfloat16" the bfloat16 ones."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lm_shape = (LM_BATCH, LM["num_heads"], LM["seq_len"],
                LM["num_hidden"] // LM["num_heads"])
    out = {}
    cases = [(lm_shape, True, None, True)] + [c + (False,)
                                              for c in FLASH_CHECKS]
    # the card's clocks drop in the earlier phases' idle gaps; 0.2 s of the
    # kernel first, so that the phase's first timing is not taken on the
    # way back up
    q, k, v = lm_qkv(torch, torch.Generator(device="cuda").manual_seed(SEED),
                     *lm_shape, torch.float32)
    t_end = time.perf_counter() + 0.2
    while time.perf_counter() < t_end:
        for _ in range(ITERS):
            fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
    for shape, causal, scale, main in cases:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            if main:
                q, k, v = lm_qkv(torch, gen, *shape, dt)
            else:
                q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                           .to(dt) for _ in range(3))
            label = "shape=%s %s scale=%s dtype=%s%s" % (
                shape, "causal" if causal else "full", scale, dname,
                " lm-strided" if main else "")
            err, lerr = flash_check(torch, fa, q, k, v, causal, scale,
                                    label)
            tile, nth, bq, bk, dmax, blocks, bufs = fa.fwd_plan(shape)
            kernel_ms = time_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, scale=scale))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_ref(
                q, k, v, causal, scale))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale)
            library_ms = time_ms(torch, library)
            bound_ms, bound_by = bound(
                *flash_work(*shape, causal, q.element_size()), dname)
            print("flash %s max_abs_err=%r lse_max_abs_err=%r kernel_ms=%r "
                  "plain_ms=%r library_ms=%r bound_ms=%r bound_by=%s "
                  "tile=%d threads=%d bq=%d bk=%d d_bucket=%d "
                  "blocks_per_sm=%d kv_buffers=%d vec16=%d "
                  "bitwise_repeat=True sdpa_kernels=%s"
                  % (label, err, lerr, kernel_ms, plain_ms, library_ms,
                     bound_ms, bound_by, tile, nth, bq, bk, dmax, blocks,
                     bufs, fa.aligned16(q, k, v),
                     sdpa_backend(torch, library)))
            if main:
                nums = {"ms": kernel_ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": err}
                out.update(nums) if dt == torch.float32 \
                    else out.update(bfloat16=nums)
    return out


def lm_weights(net):
    """GPT-2-style random weights from SEED as numpy: N(0, 0.02), the
    residual projections (_proj, _mlp2) scaled by 1/sqrt(2 * layers),
    LayerNorm gamma 1 and beta 0, biases 0."""
    rng = np.random.default_rng(SEED)
    shapes = {"data": (1, LM["seq_len"]), "softmax_label": (1, LM["seq_len"])}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    args = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_weight"):
            v = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(0.02)
            if name.endswith(("_proj_weight", "_mlp2_weight")):
                v *= np.float32((2.0 * LM["num_layers"]) ** -0.5)
        elif name.endswith("_gamma"):
            v = np.ones(shape, np.float32)
        else:
            v = np.zeros(shape, np.float32)
        args[name] = v
    print("lm parameters=%d" % sum(v.size for v in args.values()))
    return args


def lm_phase(torch, mt, fa):
    """The LM served through Predictor from its JSON; returns the kernel's
    launches in the driven batches."""
    net = mt.models.transformer.get_symbol(**LM)
    ref_net = mt.models.transformer.get_symbol(attn_impl="xla", **LM)
    blob = mt.convert.params_from_numpy(lm_weights(net), {}, ctx=mt.gpu(0))
    shapes = {"data": (LM_BATCH, LM["seq_len"]),
              "softmax_label": (LM_BATCH, LM["seq_len"])}
    # both graphs reach Predictor as a checkpoint would: through JSON
    pred = mt.Predictor(net.tojson(), blob, shapes, copy_params=False)
    ref = mt.Predictor(ref_net.tojson(), blob, shapes, copy_params=False)
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, LM["vocab_size"],
                          (LM_BATCH * LM_BATCHES, LM["seq_len"]))
    pred.forward(data=tokens[:LM_BATCH])              # warm
    torch.cuda.synchronize()
    fa.launches = 0
    host_ms, d2h_ms, worst, agree, counted = [], [], 0.0, 0, 0
    for i in range(0, len(tokens), LM_BATCH):
        batch = tokens[i:i + LM_BATCH]
        t0 = time.perf_counter()
        pred.forward(data=batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = pred.get_output(0)
        host_ms.append((t1 - t0) * 1e3)
        d2h_ms.append((time.perf_counter() - t1) * 1e3)
        launched = fa.launches
        ref.forward(data=batch)
        want = ref.get_output(0)
        if fa.launches != launched:
            fail("the attn_impl='xla' graph launched the flash kernel")
        n_rows = LM_BATCH * LM["seq_len"]
        if got.shape != (n_rows, LM["vocab_size"]) or \
                not np.isfinite(got).all():
            fail("lm batch %d: shape %s or non-finite probabilities"
                 % (i // LM_BATCH, got.shape))
        if np.abs(got.sum(axis=1, dtype=np.float64) - 1).max() > 1e-4:
            fail("lm batch %d: rows do not sum to 1" % (i // LM_BATCH))
        err = float(np.abs(got - want).max())
        top = float(want.max())
        worst = max(worst, err / top)
        top2 = np.partition(want, -2, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LM_TOL * top
        same = got.argmax(1) == want.argmax(1)
        agree += int(same[clear].sum())
        counted += int(clear.sum())
        print("lm check batch=%d max_abs_diff=%r max_prob=%r tol=%g*max_prob "
              "argmax_agree=%d/%d (positions with top-2 gap > tol; "
              "%d of %d agree overall)"
              % (i // LM_BATCH, err, top, LM_TOL, int(same[clear].sum()),
                 int(clear.sum()), int(same.sum()), n_rows))
        if err > LM_TOL * top or not same[clear].all():
            fail("lm batch %d differs from the attn_impl='xla' graph"
                 % (i // LM_BATCH))
        del got, want
    launches = fa.launches
    forwards = LM_BATCHES
    print("lm batches=%d sequences=%d flash_launches=%d forwards=%d "
          "host_ms_per_forward=%r d2h_ms_per_batch=%r worst_rel_diff=%r "
          "argmax_agree=%d/%d"
          % (LM_BATCHES, len(tokens), launches, forwards,
             float(np.mean(host_ms)), float(np.mean(d2h_ms)), worst, agree,
             counted))
    if launches != LM["num_layers"] * forwards:
        fail("flash launches %d != %d x %d forwards"
             % (launches, LM["num_layers"], forwards))
    lm_breakdown(torch, pred, tokens[:LM_BATCH])
    return launches


def lm_breakdown(torch, pred, batch):
    """Device time of one LM forward and its output's copy to the host, by
    kernel and by group, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = [("flash", ("flash_fwd_kernel",)),
              ("cublas", ("gemm", "cutlass", "cublas", "xmma")),
              ("softmax", ("softmax",)),
              ("d2h", ("memcpy dtoh",)), ("h2d", ("memcpy htod",)),
              ("copies", ("copy", "memcpy"))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.forward(data=batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.get_output(0)
        t2 = time.perf_counter()
    kernels = [e for e in prof.key_averages()
               if is_kernel(e, DeviceType)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = (t2 - t0) * 1e6
    print("profile lm forward: forward_wall_us=%r d2h_wall_us=%r "
          "device_busy_us=%r device_busy_share=%r kernels=%d"
          % ((t1 - t0) * 1e6, (t2 - t1) * 1e6, busy_us, busy_us / wall_us,
             len(kernels)))
    by_group = {}
    for e in kernels:
        g = next((g for g, keys in groups
                  if any(key in e.key.lower() for key in keys)), "other")
        us, n = by_group.get(g, (0.0, 0))
        by_group[g] = (us + e.self_device_time_total, n + e.count)
    for g, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print("profile lm group=%s us=%r launches=%d share=%r"
              % (g, us, n, us / max(busy_us, 1e-9)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print("profile lm kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9),
                 e.key[:160]))


def bwd_work(b, h, t, d, causal, elem):
    """{kernel: (operations, bytes)} the backward needs: per unmasked (q, k)
    pair the dQ kernel does 3 products of length D (q·k, dO·v, dS·k), a
    multiply and an add each, and the dK/dV kernel 4 (q·k, dO·v, Pᵀ·dO,
    dSᵀ·Q); bytes are the tensors each reads and writes once (dQ: q, k, v,
    dO, lse, delta, dq; dK/dV: q, k, v, dO, lse, delta, dk, dv), lse and
    delta in float32."""
    pairs = t * (t + 1) // 2 if causal else t * t
    act = b * h * t * d * elem
    stats = 2 * 4 * b * h * t
    return {"dq": (6.0 * d * pairs * b * h, 5.0 * act + stats),
            "dkv": (8.0 * d * pairs * b * h, 6.0 * act + stats)}


def lm_grad_out(torch, gen, b, h, t, d, dtype):
    """dO as the LM's backward hands it to attention: the (B, H, T, D)
    permuted view of a contiguous (B, T, H, D) gradient of the output
    transpose."""
    g = torch.randn(b, t, h, d, device="cuda", generator=gen)
    return g.to(dtype).permute(0, 2, 1, 3)


def flash_bwd_phase(torch, fa):
    """Backward kernels vs the plain backward, timed beside SDPA's backward
    and the bounds, at the LM's shape (q, k, v and dO made as the LM makes
    them) and at FLASH_CHECKS, in float32 and bfloat16.  Returns the float32
    numbers per launch at the LM's shape, and under "bfloat16" the
    bfloat16 ones."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lm_shape = (LM_BATCH, LM["num_heads"], LM["seq_len"],
                LM["num_hidden"] // LM["num_heads"])
    out = {}
    cases = [(lm_shape, True, None, True)] + [c + (False,)
                                              for c in FLASH_CHECKS]
    # the card's clocks drop in the earlier phases' idle gaps; 0.2 s of the
    # kernel first, so that the phase's first timing is not taken on the
    # way back up
    q, k, v = lm_qkv(torch, torch.Generator(device="cuda").manual_seed(SEED),
                     *lm_shape, torch.float32)
    t_end = time.perf_counter() + 0.2
    while time.perf_counter() < t_end:
        for _ in range(ITERS):
            fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
    for shape, causal, scale, main in cases:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            if main:
                q, k, v = lm_qkv(torch, gen, *shape, dt)
                do = lm_grad_out(torch, gen, *shape, dt)
            else:
                q, k, v, do = (torch.randn(shape, device="cuda",
                                           generator=gen).to(dt)
                               for _ in range(4))
            label = "shape=%s %s scale=%s dtype=%s%s" % (
                shape, "causal" if causal else "full", scale, dname,
                " lm-strided" if main else "")
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                            scale=scale)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                           scale)
            want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                              scale)
            torch.cuda.synchronize()
            errs = {}
            for name, a, b2, w in zip(("dq", "dk", "dv"), got, again, want):
                if a.dtype != dt or a.shape != q.shape:
                    fail("flash_bwd %s: %s is %s %s" % (label, name, a.dtype,
                                                       tuple(a.shape)))
                if not torch.isfinite(a).all():
                    fail("flash_bwd %s: non-finite %s" % (label, name))
                if not torch.equal(a, b2):
                    fail("flash_bwd %s: %s differs between two runs"
                         % (label, name))
                err = (a.float() - w.float()).abs().max().item()
                ref = w.float().abs().max().item()
                if err > BWD_TOL[dname] * ref:
                    fail("flash_bwd %s: max|d%s| %.3g > %g * %.3g"
                         % (label, name, err, BWD_TOL[dname], ref))
                errs[name] = (err, ref)
            run = fa._BwdLaunch(q, k, v, o, lse, do, causal, scale)
            dq_ms = time_ms(torch, run.dq_kernel)
            dkv_ms = time_ms(torch, run.dkv_kernel)
            whole_ms = time_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal, scale))
            plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal, scale))
            qs, ks, vs = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                scale=scale)
            sdpa_ms = time_ms(torch, lambda: torch.autograd.grad(
                so, (qs, ks, vs), do, retain_graph=True))
            del so, qs, ks, vs
            work = bwd_work(*shape, causal, q.element_size())
            dq_bound, dq_by = bound(*work["dq"], dname)
            dkv_bound, dkv_by = bound(*work["dkv"], dname)
            print("flash_bwd %s max_abs_err dq=%r dk=%r dv=%r max_abs_ref "
                  "dq=%r dk=%r dv=%r tol=%g*max_abs_ref repeat=bitwise"
                  % ((label,) + tuple(errs[n][0] for n in ("dq", "dk", "dv"))
                     + tuple(errs[n][1] for n in ("dq", "dk", "dv"))
                     + (BWD_TOL[dname],)))
            print("flash_bwd %s dq_ms=%r dq_bound_ms=%r dq_bound_by=%s "
                  "dkv_ms=%r dkv_bound_ms=%r dkv_bound_by=%s whole_ms=%r "
                  "plain_ms=%r sdpa_bwd_ms=%r"
                  % (label, dq_ms, dq_bound, dq_by, dkv_ms, dkv_bound,
                     dkv_by, whole_ms, plain_ms, sdpa_ms))
            if main:
                nums = {"dq_ms": dq_ms, "dkv_ms": dkv_ms,
                        "whole_ms": whole_ms, "plain_ms": plain_ms,
                        "library_ms": sdpa_ms, "dq_bound_ms": dq_bound,
                        "dq_bound_by": dq_by, "dkv_bound_ms": dkv_bound,
                        "dkv_bound_by": dkv_by, "dq_err": errs["dq"][0],
                        "dkv_err": max(errs["dk"][0], errs["dv"][0])}
                out.update(nums) if dt == torch.float32 \
                    else out.update(bfloat16=nums)
            del got, again, want, run
    return out


def flash_counts(fa):
    return (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)


def reset_flash_counts(fa):
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def lm_train_phase(torch, mt, fa):
    """(a) the LM's gradients on the kernel graph against the xla graph's;
    (b) TrainStep with Adam on one fixed batch.  Returns the backward
    kernels' launches in the driven TrainStep steps."""
    net = mt.models.transformer.get_symbol(**LM)
    ref_net = mt.models.transformer.get_symbol(attn_impl="xla", **LM)
    weights = lm_weights(net)
    shapes = {"data": (LM_BATCH, LM["seq_len"]),
              "softmax_label": (LM_BATCH, LM["seq_len"])}
    rng = np.random.default_rng(SEED + 4)
    toks = rng.integers(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"] + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    gpu = mt.gpu(0)
    grads = {}
    for name, sym, dt in (("flash", net, np.float32),
                          ("xla", ref_net, np.float32),
                          ("xla_f64", ref_net, np.float64)):
        args = mt.convert.params_from_numpy(
            {n: v.astype(dt) for n, v in dict(weights, **batch).items()}, {},
            ctx=gpu)
        ex = sym.bind(gpu, {k[4:]: v for k, v in args.items()}, args_grad={
            n: mt.nd.zeros(v.shape, ctx=gpu, dtype=dt)
            for n, v in weights.items()}, grad_req="write")
        reset_flash_counts(fa)
        ex.forward(is_train=True)
        ex.backward()
        torch.cuda.synchronize()
        counts = flash_counts(fa)
        print("lm_train grad graph=%s flash_fwd_launches=%d "
              "flash_dq_launches=%d flash_dkv_launches=%d" % ((name,) + counts))
        want = (LM["num_layers"],) * 3 if name == "flash" else (0, 0, 0)
        if counts != want:
            fail("lm_train: the %s graph launched %s flash kernels, want %s"
                 % (name, counts, want))
        grads[name] = {n: g.value.double() for n, g in ex.grad_dict.items()}
        del ex, args

    def dist(a, b):
        return (((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                .item(), ((a - b).norm() / b.norm().clamp_min(1e-300)).item())
    rows = []
    for n, g in grads["xla"].items():
        got = grads["flash"][n]
        if not torch.isfinite(got).all():
            fail("lm_train: non-finite gradient of %s" % n)
        rows.append(dist(got, g) + dist(g, grads["xla_f64"][n]) + (n,))
    rows.sort(reverse=True)
    for row in rows[:8]:
        print("lm_train grad param=%s max_rel=%r norm_rel=%r f32_floor "
              "max_rel=%r norm_rel=%r" % ((row[4],) + row[:4]))
    worst = {"check": [max(r[0] for r in rows), max(r[1] for r in rows)],
             "floor": [max(r[2] for r in rows), max(r[3] for r in rows)]}
    for rel, nrel, _, _, n in rows:
        if rel > LM_GRAD_TOL or nrel > LM_GRAD_NORM_TOL:
            fail("lm_train: gradient of %s differs from the xla graph's by "
                 "%.3g of its largest entry (tol %g), %.3g in norm (tol %g)"
                 % (n, rel, LM_GRAD_TOL, nrel, LM_GRAD_NORM_TOL))
    print("lm_train grad_check parameters=%d worst max_rel=%r norm_rel=%r "
          "(tol %g, %g); xla f32 vs f64 worst max_rel=%r norm_rel=%r"
          % ((len(grads["xla"]),) + tuple(worst["check"])
             + (LM_GRAD_TOL, LM_GRAD_NORM_TOL) + tuple(worst["floor"])))
    del grads

    ts = mt.TrainStep(net, mt.optimizer.Adam(learning_rate=LM_LR))
    zeros = {n: (np.zeros(v.shape, np.float32), np.zeros(v.shape,
                                                         np.float32))
             for n, v in weights.items()}
    params, state, aux = mt.convert.train_state_from_numpy(
        weights, zeros, {}, ctx=gpu)
    del zeros
    dev_batch = ts.shard_batch(batch)
    lab = dev_batch["softmax_label"].reshape(-1).long()
    rows = torch.arange(lab.numel(), device=lab.device)

    def loss(outs):
        # mean -log p(label), reduced on the card
        return -torch.log(outs[0][rows, lab]).mean().item()
    params, state, aux, outs = ts(params, state, aux, dev_batch)   # warm
    losses = [loss(outs)]
    torch.cuda.synchronize()
    reset_flash_counts(fa)
    host_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        params, state, aux, outs = ts(params, state, aux, dev_batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss(outs))
    t0 = time.perf_counter()
    params, state, aux, outs = ts.run_steps(params, state, aux, dev_batch, 3)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3 / 4
    losses.append(loss(outs))
    counts = flash_counts(fa)
    steps = 8
    tokens = LM_BATCH * LM["seq_len"]
    step_ms = float(np.mean(host_ms))
    print("lm_train steps=9 (1 warm + 4 calls + run_steps(3)) losses=%s"
          % [round(x, 6) for x in losses])
    print("lm_train loss_first=%r loss_last=%r num_update=%d"
          % (losses[0], losses[-1], ts.num_update))
    print("lm_train host_ms_per_step calls=%r run_steps=%r (to a "
          "synchronize) tokens_per_s calls=%r run_steps=%r"
          % (step_ms, run_ms, tokens / step_ms * 1e3,
             tokens / run_ms * 1e3))
    print("lm_train launches over %d steps flash_fwd=%d flash_dq=%d "
          "flash_dkv=%d" % ((steps,) + counts))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail("lm_train: the loss did not fall: %s" % losses)
    if counts != (steps * LM["num_layers"],) * 3:
        fail("lm_train: flash launches %s != 3 x %d x %d steps"
             % (counts, LM["num_layers"], steps))
    train_breakdown(torch, ts, params, state, aux, dev_batch)
    return counts[1], counts[2]


def flash_bf16_counts(fa):
    return (fa.bf16_launches, fa.bwd_dq_bf16_launches,
            fa.bwd_dkv_bf16_launches)


def reset_flash_bf16_counts(fa):
    reset_flash_counts(fa)
    fa.bf16_launches = fa.bwd_dq_bf16_launches = \
        fa.bwd_dkv_bf16_launches = 0


def lm_amp_grads(torch, mt, fa, sym, weights, batch, policy, remat=False):
    """The gradients of one step of ``sym`` under ``policy`` on the card
    from ``weights``: TrainStep with SGD(lr 1, momentum 0.9) from a zero
    momentum, whose new momentum is -g.  Returns ({name: float32 gradient
    on the card}, (fwd, dQ, dK/dV launches), their bfloat16 counts, host
    ms of the step to a synchronize, peak GB of the step)."""
    gpu = mt.gpu(0)
    ts = mt.TrainStep(sym, mt.optimizer.SGD(learning_rate=1.0, momentum=0.9),
                      policy=policy, remat=remat)
    zeros = {n: (np.zeros(v.shape, np.float32),) for n, v in weights.items()}
    params, state, aux = mt.convert.train_state_from_numpy(
        weights, zeros, {}, ctx=gpu)
    del zeros
    dev_batch = ts.shard_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_bf16_counts(fa)
    t0 = time.perf_counter()
    ts(params, state, aux, dev_batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {n: -st[0] for n, st in state.items()}
    return grads, flash_counts(fa), flash_bf16_counts(fa), host_ms, peak


def lm_dist(a, b):
    """(max |a - b| / max |b|, ||a - b|| / ||b||) in float64."""
    a, b = a.double(), b.double()
    return (((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item(),
            ((a - b).norm() / b.norm().clamp_min(1e-300)).item())


def lm_train_amp_phase(torch, mt, fa):
    """The LM at GPT-2-small widths under Policy("bfloat16"): (a) each
    parameter's gradient on the kernel graph within LM_BF16_X times its
    bfloat16 floor, the distance of the attn_impl="xla" graph's bf16-policy
    gradient from its float32 one (or LM_BF16_FLOOR_MIN); every flash
    kernel launched 12 times, all in bfloat16; (b) TrainStep with
    Adam(LM_LR): a warm step, 4 calls and run_steps(3), the loss lower,
    36 flash launches a step, all bfloat16, host ms a step, a profiled
    step; (c) one gradient step each with remat False (again, warm), True
    and "dots": gradients within LM_GRAD_TOL / LM_GRAD_NORM_TOL of the
    first plain step's, with peak memory and host ms.  Returns (fwd, dQ, dK/dV launches) of (b)."""
    net = mt.models.transformer.get_symbol(**LM)
    ref_net = mt.models.transformer.get_symbol(attn_impl="xla", **LM)
    weights = lm_weights(net)
    rng = np.random.default_rng(SEED + 4)
    toks = rng.integers(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"] + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    policy = amp_policy(mt)
    layers = LM["num_layers"]
    runs = {}
    for name, sym, pol in (("flash_bf16", net, policy),
                           ("xla_bf16", ref_net, policy),
                           ("xla_f32", ref_net, None)):
        runs[name] = lm_amp_grads(torch, mt, fa, sym, weights, batch, pol)
        _, counts, bf16, host_ms, peak = runs[name]
        print("lm_train_amp grad graph=%s flash_launches=%s bf16=%s "
              "host_ms=%r peak_mem_gb=%r" % (name, counts, bf16, host_ms,
                                              peak))
        want = ((layers,) * 3, (layers,) * 3) if name == "flash_bf16" \
            else ((0,) * 3, (0,) * 3)
        if (counts, bf16) != want:
            fail("lm_train_amp: the %s graph launched %s flash kernels (%s "
                 "in bfloat16), want %s" % (name, counts, bf16, want))
    got, ref, f32 = (runs[n][0] for n in ("flash_bf16", "xla_bf16",
                                          "xla_f32"))
    rows = []
    for n, g in f32.items():
        if not torch.isfinite(got[n]).all():
            fail("lm_train_amp: non-finite gradient of %s" % n)
        d, floor = lm_dist(got[n], g), lm_dist(ref[n], g)
        rows.append(tuple(x / max(f, LM_BF16_FLOOR_MIN)
                          for x, f in zip(d, floor)) + d + floor + (n,))
    rows.sort(key=lambda r: -max(r[:2]))
    for r in rows[:8]:
        print("lm_train_amp grad param=%s max_rel=%r norm_rel=%r bf16_floor "
              "max_rel=%r norm_rel=%r floor_x max=%r norm=%r"
              % ((r[6],) + r[2:6] + r[:2]))
    worst = [max(r[i] for r in rows) for i in range(6)]
    print("lm_train_amp grad_check parameters=%d worst floor_x max=%r "
          "norm=%r (tol %g x max(floor, %g)); worst max_rel=%r norm_rel=%r; "
          "bf16 floor worst max_rel=%r norm_rel=%r"
          % ((len(rows),) + tuple(worst[:2]) + (LM_BF16_X, LM_BF16_FLOOR_MIN)
             + tuple(worst[2:])))
    for r in rows:
        if r[0] > LM_BF16_X or r[1] > LM_BF16_X:
            fail("lm_train_amp: gradient of %s is %.3g (max) and %.3g "
                 "(norm) times its bfloat16 floor (tol %g)"
                 % (r[6], r[0], r[1], LM_BF16_X))
    plain = runs["flash_bf16"]
    del runs, ref, f32, rows

    gpu = mt.gpu(0)
    ts = mt.TrainStep(net, mt.optimizer.Adam(learning_rate=LM_LR),
                      policy=policy)
    zeros = {n: (np.zeros(v.shape, np.float32), np.zeros(v.shape,
                                                         np.float32))
             for n, v in weights.items()}
    params, state, aux = mt.convert.train_state_from_numpy(
        weights, zeros, {}, ctx=gpu)
    del zeros
    dev_batch = ts.shard_batch(batch)
    lab = dev_batch["softmax_label"].reshape(-1).long()
    idx = torch.arange(lab.numel(), device=lab.device)

    def loss(outs):
        return -torch.log(outs[0][idx, lab]).mean().item()
    torch.cuda.reset_peak_memory_stats()
    params, state, aux, outs = ts(params, state, aux, dev_batch)   # warm
    losses = [loss(outs)]
    torch.cuda.synchronize()
    reset_flash_bf16_counts(fa)
    host_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        params, state, aux, outs = ts(params, state, aux, dev_batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss(outs))
    params, state, aux, outs = ts.run_steps(params, state, aux, dev_batch, 3)
    torch.cuda.synchronize()
    losses.append(loss(outs))
    counts, bf16 = flash_counts(fa), flash_bf16_counts(fa)
    steps = 8
    step_ms = float(np.mean(host_ms))
    print("lm_train_amp steps=9 (1 warm + 4 calls + run_steps(3)) "
          "policy=%s losses=%s scale_state=%s"
          % (policy.describe(), [round(x, 6) for x in losses],
             ts.scale_state_host()))
    print("lm_train_amp host_ms_per_step=%r tokens_per_s=%r peak_mem_gb=%r "
          "launches over %d steps flash_fwd=%d flash_dq=%d flash_dkv=%d "
          "bf16 %s" % ((step_ms, LM_BATCH * LM["seq_len"] / step_ms * 1e3,
                        torch.cuda.max_memory_allocated() / 2 ** 30, steps)
                       + counts + (bf16,)))
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail("lm_train_amp: the loss did not fall: %s" % losses)
    if counts != (steps * layers,) * 3 or bf16 != counts:
        fail("lm_train_amp: flash launches %s (%s in bfloat16) != 3 x %d "
             "x %d steps, all bfloat16" % (counts, bf16, layers, steps))
    train_breakdown(torch, ts, params, state, aux, dev_batch)
    del ts, params, state, aux, outs, dev_batch
    torch.cuda.empty_cache()

    for remat in (False, True, "dots"):
        grads, rc, rbf16, r_ms, r_peak = lm_amp_grads(
            torch, mt, fa, net, weights, batch, policy, remat)
        d = [lm_dist(grads[n], g) for n, g in plain[0].items()]
        worst_r = [max(x[i] for x in d) for i in (0, 1)]
        print("lm_train_amp remat=%s host_ms=%r peak_mem_gb=%r "
              "flash_launches=%s bf16=%s grads vs remat=False worst "
              "max_rel=%r norm_rel=%r (tol %g, %g)"
              % ((remat, r_ms, r_peak, rc, rbf16) + tuple(worst_r)
                 + (LM_GRAD_TOL, LM_GRAD_NORM_TOL)))
        if worst_r[0] > LM_GRAD_TOL or worst_r[1] > LM_GRAD_NORM_TOL:
            fail("lm_train_amp: remat=%s gradients differ from the plain "
                 "step's by %s" % (remat, worst_r))
        del grads
    del plain
    return counts


def train_breakdown(torch, ts, params, state, aux, batch):
    """Device time of one TrainStep call by group, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    groups = [("flash fwd", ("flash_fwd_kernel",)),
              ("flash dq", ("flash_bwd_dq_kernel",)),
              ("flash dkv", ("flash_bwd_dkv_kernel",)),
              ("cublas", ("gemm", "cutlass", "cublas", "xmma", "sm90_",
                          "nvjet")),
              ("softmax", ("softmax",)),
              ("embedding backward", ("indexfunc", "index_add", "embedding",
                                      "index_put", "scatter")),
              ("copies", ("copy", "memcpy", "memset"))]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts(params, state, aux, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if is_kernel(e, DeviceType)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print("profile train step: wall_us=%r device_busy_us=%r "
          "device_busy_share=%r kernels=%d"
          % (wall_us, busy_us, busy_us / wall_us, len(kernels)))
    by_group = {}
    for e in kernels:
        g = next((g for g, keys in groups
                  if any(key in e.key.lower() for key in keys)),
                 "elementwise/optimizer")
        us, n = by_group.get(g, (0.0, 0))
        by_group[g] = (us + e.self_device_time_total, n + e.count)
    for g, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print("profile train group=%s us=%r launches=%d share=%r"
              % (g, us, n, us / max(busy_us, 1e-9)))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        print("profile train kernel us=%r count=%d share=%r name=%s"
              % (e.self_device_time_total, e.count,
                 e.self_device_time_total / max(busy_us, 1e-9),
                 e.key[:160]))


def graph_device_phase(torch, mt):
    """Ops with no input inside a graph bound to gpu(0): ``_ones`` plus a
    data variable, and a sampler plus a data variable, forward on the card
    with the right values."""
    gpu = mt.gpu(0)
    data = mt.sym.Variable("data")
    ex = (mt.sym._ones(shape=(4, 8)) + data).bind(gpu, {
        "data": mt.nd.array(np.full((4, 8), 2, np.float32), ctx=gpu)})
    out = ex.forward()[0].value
    if not out.is_cuda or not bool((out == 3).all()):
        fail("graph_device: _ones + data gave %s on %s"
             % (out.flatten()[:4].tolist(), out.device))
    n = 1 << 16
    ex = (mt.sym.uniform(shape=(n,), low=2.0, high=3.0) + data).bind(gpu, {
        "data": mt.nd.zeros((n,), ctx=gpu)})
    u = ex.forward()[0].value
    if not u.is_cuda or not bool(((u >= 2) & (u < 3)).all()) \
            or abs(u.mean().item() - 2.5) > 0.01:
        fail("graph_device: uniform(2, 3) + data gave mean %r on %s"
             % (u.mean().item(), u.device))
    print("graph_device _ones+data device=%s ok; uniform(2,3)+data "
          "device=%s mean=%r" % (out.device, u.device, u.mean().item()))


def device_profile(torch, fn):
    """(device us, launches) of the CUDA kernels one call of ``fn`` runs,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if is_kernel(e, DeviceType)]
    return (sum(e.self_device_time_total for e in kernels),
            sum(e.count for e in kernels))


def imperative_phase(torch, mt, weights):
    """Updater passes over every LM parameter against the fused rule."""
    from mxnet_tpu_torch.train import _FunctionalOptimizer
    gpu = mt.gpu(0)
    names = sorted(weights)
    idx2name = dict(enumerate(names))
    mt.random.seed(SEED + 5)
    grads = [mt.nd.normal(loc=0.0, scale=1e-2, shape=weights[n].shape,
                          ctx=gpu) for n in names]
    common = dict(wd=1e-2, rescale_grad=0.5, clip_gradient=4e-3,
                  param_idx2name=idx2name)
    opts = (("adam", lambda: mt.optimizer.Adam(learning_rate=1e-3,
                                                **common)),
            ("sgd_momentum", lambda: mt.optimizer.SGD(
                learning_rate=0.1, momentum=0.9, **common)))
    for label, make in opts:
        params = [mt.nd.array(weights[n], ctx=gpu) for n in names]
        updater = mt.optimizer.get_updater(make())

        def one_pass():
            for i, (g, w) in enumerate(zip(grads, params)):
                updater(i, g, w)
        host_ms = []
        for _ in range(IMP_PASSES - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_us, n_launch = device_profile(torch, one_pass)

        fopt = _FunctionalOptimizer(make(), names)
        fw = {n: torch.from_numpy(weights[n]).cuda() for n in names}
        state = fopt.init_state(fw)
        fused_ms = []
        for t in range(1, IMP_PASSES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hyper = fopt.hyper(t - 1)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    nw, ns = fopt.update(n, fw[n], g.value, state[n], hyper,
                                         t)
                    fw[n].copy_(nw)
                    for s, v in zip(state[n], ns):
                        s.copy_(v)
            torch.cuda.synchronize()
            fused_ms.append((time.perf_counter() - t0) * 1e3)
        err, scale, serr = 0.0, 0.0, 0.0
        for i, n in enumerate(names):
            w = params[i].value
            if not torch.isfinite(w).all():
                fail("imperative %s: non-finite %s" % (label, n))
            err = max(err, (w - fw[n]).abs().max().item())
            scale = max(scale, fw[n].abs().max().item())
            st = updater.states[i]
            st = st if isinstance(st, tuple) else (st,)
            for a, b in zip(st, state[n]):
                serr = max(serr, ((a.value - b).abs().max()
                                  / b.abs().max().clamp_min(1e-30)).item())
        print("imperative %s parameters=%d arrays=%d passes=%d "
              "max_abs_diff_vs_fused=%r max_abs_w=%r tol=%g*max_abs_w "
              "state_max_rel_diff=%r" % (label, sum(w.size for w in params),
                                          len(params), IMP_PASSES, err, scale,
                                          IMPERATIVE_TOL, serr))
        print("imperative %s host_ms_per_pass=%s (to a synchronize; pass 1 "
              "creates the states) profiled_pass device_ms=%r launches=%d "
              "fused_rule host_ms_per_pass=%s"
              % (label, [round(x, 3) for x in host_ms], dev_us / 1e3,
                 n_launch, [round(x, 3) for x in fused_ms]))
        if err > IMPERATIVE_TOL * scale or serr > IMPERATIVE_TOL:
            fail("imperative %s: the Updater differs from the fused rule"
                 % label)
        del params, updater, fw, state


def rtc_phase(torch, mt, weights):
    """The four user kernels pushed through Rtc; returns the axpb numbers
    and its launches in the counted run."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_kernels as rk
    gpu = mt.gpu(0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    names = sorted(weights)
    n = sum(weights[k].size for k in names)

    def card(t):
        return mt.nd.NDArray(t, ctx=gpu)
    x = card(torch.randn(n, device="cuda", generator=gen))
    y = card(torch.randn(n, device="cuda", generator=gen))
    out = mt.nd.zeros((n,), ctx=gpu)
    x10 = card(torch.rand(10, device="cuda", generator=gen) * 2 - 1)
    y10 = mt.nd.zeros((10,), ctx=gpu)
    head = mt.nd.array(weights["lm_head_weight"], ctx=gpu)
    head_t = mt.nd.zeros(head.shape[::-1], ctx=gpu)
    # one buffer holding every parameter; each parameter is a view of it
    w_all = mt.nd.zeros((n,), ctx=gpu)
    views, spans, at = {}, {}, 0
    for k in names:
        size = weights[k].size
        views[k] = w_all[at:at + size].reshape(weights[k].shape)
        views[k][:] = weights[k]
        spans[k] = (at, at + size)
        at += size
    g_all = card(torch.randn(n, device="cuda", generator=gen) * 1e-2)
    m_all = card(torch.randn(n, device="cuda", generator=gen) * 1e-3)
    sgd = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5,
               clip_gradient=4e-3)
    w_want, m_want = rk.sgd_mom_plain(w_all, g_all, m_all, **sgd)
    kernels = [("axpb", rk.make_axpb(n), [x, y], [out]),
               ("exp5_shared", rk.make_exp5_shared(), [x10], [y10]),
               ("transpose_tiled", rk.make_transpose_tiled(*head.shape),
                [head], [head_t]),
               ("sgd_mom", rk.make_sgd_mom(n, **sgd), [w_all, g_all, m_all],
                [w_all, m_all])]
    torch.cuda.synchronize()
    rtc.launches = 0
    builds0 = rtc.builds
    per_kernel = {}
    for name, (r, launch), ins, outs in kernels:
        before = rtc.launches
        t0 = time.perf_counter()
        r.push(ins, outs, **launch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_kernel[name] = rtc.launches - before
        print("rtc first_push kernel=%s seconds=%r (nvcc build, load, "
              "launch) launch=%s" % (name, secs, launch))
    main_launches = rtc.launches
    builds1 = rtc.builds
    print("rtc counted run launches=%d by_kernel=%s builds=%d"
          % (main_launches, per_kernel, builds1 - builds0))
    if any(v != 1 for v in per_kernel.values()):
        fail("rtc: each user kernel must launch once, got %s" % per_kernel)

    axpb_err = (out.value - rk.axpb_plain(x.value, y.value)).abs().max() \
        .item()
    if axpb_err != 0.0:
        fail("rtc axpb differs from x * 2 + y by %r" % axpb_err)
    want = rk.exp5_plain(x10.value)
    exp_err = ((y10.value - want).abs() / want.abs()).max().item()
    if not exp_err <= EXP5_TOL:
        fail("rtc exp5_shared: max rel err %r > %g" % (exp_err, EXP5_TOL))
    if not torch.equal(head_t.value, rk.transpose_plain(head.value)):
        fail("rtc transpose_tiled differs from x.t()")
    scale = w_want.value.abs().max().item()
    sgd_err = max((w_all.value - w_want.value).abs().max().item(),
                  (m_all.value - m_want.value).abs().max().item())
    a, b = spans["lm_head_weight"]
    view_err = (views["lm_head_weight"].value
                - w_want.value[a:b].reshape(head.shape)).abs().max().item()
    print("rtc check axpb max_abs_err=%r exp5_shared max_rel_err=%r (tol %g) "
          "transpose_tiled=bitwise sgd_mom max_abs_err=%r max_abs_w=%r "
          "(tol %g*max_abs_w) view lm_head_weight max_abs_err=%r"
          % (axpb_err, exp_err, EXP5_TOL, sgd_err, scale, IMPERATIVE_TOL,
             view_err))
    if not torch.isfinite(w_all.value).all() or \
            max(sgd_err, view_err) > IMPERATIVE_TOL * scale:
        fail("rtc sgd_mom differs from sgd_mom_update")

    for name, (r, launch), ins, outs in kernels:
        r.push(ins, outs, **launch)
    torch.cuda.synchronize()
    print("rtc second push builds=%d (unchanged: %s)"
          % (rtc.builds - builds0, rtc.builds == builds1))
    if rtc.builds != builds1:
        fail("rtc: a second push built again")

    r, launch = kernels[1][1]
    reps = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        r.push([x10], [y10], **launch)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    print("rtc exp5_shared host_us_per_push=%r (%d pushes, before a "
          "synchronize)" % (host_us, reps))

    for name, (r, launch), ins, outs in kernels[1:]:
        ms = time_ms(torch, lambda: r.push(ins, outs, **launch))
        print("rtc time kernel=%s ms=%r" % (name, ms))
    r, launch = kernels[0][1]
    # the kernel and torch.add in turns: kernel, add, add, kernel
    turns = [time_ms(torch, lambda: r.push([x, y], [out], **launch)),
             time_ms(torch, lambda: torch.add(y.value, x.value, alpha=2.0)),
             time_ms(torch, lambda: torch.add(y.value, x.value, alpha=2.0)),
             time_ms(torch, lambda: r.push([x, y], [out], **launch))]
    res = {"ms": (turns[0] + turns[3]) / 2,
           "plain_ms": time_ms(torch, lambda: rk.axpb_plain(x.value,
                                                            y.value)),
           "library_ms": (turns[1] + turns[2]) / 2,
           "bound_ms": 12.0 * n / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "max_abs_err": axpb_err, "launches": per_kernel["axpb"]}
    print("rtc axpb n=%d launch=%s kernel_ms=%r plain_ms=%r library_ms=%r "
          "bound_ms=%r bound_by=bytes (turns kernel, add, add, kernel: %r)"
          % (n, launch, res["ms"], res["plain_ms"], res["library_ms"],
             res["bound_ms"], turns))
    # views one element off 16-byte alignment: x, y and out alike (the
    # float4 branch after a head of three), and x alone (one element at a
    # time)
    r1, launch1 = rk.make_axpb(n - 1)
    for offsets in ((1, 1, 1), (1, 0, 0)):
        x1, y1, out1 = (card(t.value[k:k + n - 1])
                        for t, k in zip((x, y, out), offsets))
        r1.push([x1, y1], [out1], **launch1)
        torch.cuda.synchronize()
        if not torch.equal(out1.value, rk.axpb_plain(x1.value, y1.value)):
            fail("rtc axpb on views at element offsets %s differs from "
                 "x * 2 + y" % (offsets,))
        print("rtc axpb unaligned n=%d element offsets (x, y, out)=%s "
              "bitwise=True kernel_ms=%r" % (n - 1, offsets, time_ms(
                  torch, lambda: r1.push([x1, y1], [out1], **launch1))))

    bad = rtc.Rtc("broken", ["x"], ["y"], "  y[0] = x[0] +;")
    try:
        bad.push([x10], [y10], block_dim_x=1)
    except mt.MXNetError as exc:
        msg = str(exc)
        if "nvcc failed" not in msg or "error" not in msg:
            fail("rtc: a syntax error raised without nvcc's log: %s" % msg)
        print("rtc syntax error raised MXNetError with nvcc's log (%d "
              "chars): %s" % (len(msg), msg.strip().splitlines()[-1][:160]))
    else:
        fail("rtc: a source with a syntax error built")
    return res


class KeptBatches(object):
    """One walk of an iterator, kept, for scoring two modules on the same
    batches (``BucketSentenceIter.reset`` reshuffles in place)."""

    def __init__(self, it):
        it.reset()
        self.batches = list(it)

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def rnn_case(rnn_op, mode, bi, seed):
    """The RNN op's inputs at RNN_SHAPE and fixed cotangents of its
    outputs, as float64 numpy."""
    T, N, I, H, L = (RNN_SHAPE[k] for k in ("T", "N", "I", "H", "layers"))
    ndir = 2 if bi else 1
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    vals = {"data": rng.uniform(-1, 1, (T, N, I)),
            "parameters": rng.uniform(-bound, bound, rnn_op.rnn_param_size(
                mode, I, H, L, bi)),
            "state": rng.uniform(-0.5, 0.5, (L * ndir, N, H))}
    heads = [rng.standard_normal((T, N, H * ndir)),
             rng.standard_normal((L * ndir, N, H))]
    if mode == "lstm":
        vals["state_cell"] = rng.uniform(-0.5, 0.5, (L * ndir, N, H))
        heads.append(rng.standard_normal((L * ndir, N, H)))
    return vals, heads


def rnn_leaves(torch, rnn_op, mode, bi, vals, heads, dtype, device, route):
    """{leaf: float64 CPU tensor} of one forward and backward of the RNN op
    by ``route``: the output, the final states and the gradients of every
    input under the cotangents ``heads``."""
    ts = {n: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
          for n, v in vals.items()}
    out, hN, cN = rnn_op.rnn_forward(
        ts["data"], ts["parameters"], ts["state"], ts.get("state_cell"),
        mode, RNN_SHAPE["H"], RNN_SHAPE["layers"], bi, route=route)
    outs = [out, hN] + ([cN] if cN is not None else [])
    grads = torch.autograd.grad(outs, list(ts.values()), [
        torch.tensor(h, dtype=dtype, device=device) for h in heads])
    leaves = dict(zip(("out", "hN", "cN"), outs))
    leaves.update(("d_" + n, g) for n, g in zip(ts, grads))
    return {k: v.detach().double().cpu() for k, v in leaves.items()}


def nudged_values(vals, seed, skip=()):
    """``vals`` with each array times 1 + u * RESNET_FLOOR_NUDGE, u uniform
    in [-1, 1] (the names in ``skip`` unchanged)."""
    rng = np.random.default_rng(seed)
    return {n: v if n in skip else
            v * (1 + RESNET_FLOOR_NUDGE * rng.uniform(-1, 1, np.shape(v)))
            for n, v in vals.items()}


def floor_check(torch, tag, got, want, floors, pair=None):
    """Hold each leaf of ``got`` within RESNET_FLOOR_X times its float32
    floor (the largest distance of ``floors`` from ``want``, by max and by
    norm; RESNET_FLOOR_MIN at least) of ``want``; with ``pair``, hold
    ``got`` within twice that of ``pair``.  Prints one row a leaf; returns
    the worst multiple of the floor."""
    worst = 0.0
    for row in resnet50_leaf_rows(torch, (got,), (want,),
                                  [(f,) for f in floors], kinds=(tag,)):
        k, floor, x = row[7], row[2:4], row[4:6]
        line = ("%s %s max_rel=%.3e norm_rel=%.3e floor=%.3e/%.3e "
                "x_floor=%.3f/%.3f" % ((tag, k) + row[:6]))
        if pair is not None:
            c = resnet_dist(got[k], pair[k])
            line += " vs_pair=%.3e/%.3e" % c
            if any(a > 2 * RESNET_FLOOR_X * max(f, RESNET_FLOOR_MIN)
                   for a, f in zip(c, floor)):
                fail("%s: %s is %r from the other route (floors %r)"
                     % (tag, k, c, floor))
        print(line)
        if max(x) > RESNET_FLOOR_X:
            fail("%s: %s at %r x its float32 floor" % (tag, k, x))
        worst = max(worst, max(x))
    return worst


def rnn_op_check(torch, rnn_op, mode, bi, dev="cuda"):
    """(a) of the lstm_bucketing phase for one mode: both routes on the card
    ``dev`` against the float64 plain version on the host; their times."""
    tag = "lstm_bucketing rnn %s%s" % (mode, " bidirectional" if bi else "")
    vals, heads = rnn_case(rnn_op, mode, bi, SEED + 30)
    t0 = time.perf_counter()
    want = rnn_leaves(torch, rnn_op, mode, bi, vals, heads, torch.float64,
                      "cpu", "plain")
    floors = [rnn_leaves(torch, rnn_op, mode, bi,
                         nudged_values(vals, SEED + 130 + i) if i else vals,
                         heads, torch.float32, "cpu", "plain")
              for i in range(RESNET_FLOOR_SAMPLES)]
    host_s = time.perf_counter() - t0
    rnn_op.cudnn_calls = 0
    cudnn = rnn_leaves(torch, rnn_op, mode, bi, vals, heads, torch.float32,
                       dev, None)
    if rnn_op.cudnn_calls != RNN_SHAPE["layers"]:
        fail("%s: %d cuDNN calls in one forward, want one a layer (%d)"
             % (tag, rnn_op.cudnn_calls, RNN_SHAPE["layers"]))
    plain = rnn_leaves(torch, rnn_op, mode, bi, vals, heads, torch.float32,
                       dev, "plain")
    if rnn_op.cudnn_calls != RNN_SHAPE["layers"]:
        fail("%s: the plain version called cuDNN" % tag)
    worst = floor_check(torch, tag + " route=cudnn", cudnn, want, floors,
                        plain)
    worst_plain = floor_check(torch, tag + " route=plain", plain, want,
                              floors)
    ts = {n: torch.tensor(v, dtype=torch.float32, device=dev,
                          requires_grad=True) for n, v in vals.items()}
    hs = [torch.tensor(h, dtype=torch.float32, device=dev) for h in heads]

    def step(route):
        def fn():
            out, hN, cN = rnn_op.rnn_forward(
                ts["data"], ts["parameters"], ts["state"],
                ts.get("state_cell"), mode, RNN_SHAPE["H"],
                RNN_SHAPE["layers"], bi, route=route)
            outs = [out, hN] + ([cN] if cN is not None else [])
            torch.autograd.grad(outs, list(ts.values()), hs)
        return fn
    ms = {r: time_ms(torch, step(r), iters=10) for r in ("cudnn", "plain")}
    dev = {r: device_profile(torch, step(r)) for r in ("cudnn", "plain")}
    print("%s forward+backward ms cudnn=%r plain=%r device_ms cudnn=%r "
          "plain=%r launches cudnn=%d plain=%d (float32, TF32 off; T=%d "
          "N=%d I=%d H=%d layers=%d) worst_x_floor cudnn=%.3f plain=%.3f "
          "host_reference_seconds=%r"
          % (tag, ms["cudnn"], ms["plain"], dev["cudnn"][0] * 1e-3,
             dev["plain"][0] * 1e-3, dev["cudnn"][1], dev["plain"][1],
             RNN_SHAPE["T"], RNN_SHAPE["N"], RNN_SHAPE["I"], RNN_SHAPE["H"],
             RNN_SHAPE["layers"], worst, worst_plain, host_s))
    return ms


def lstm_fused_unfused(torch, mt, lb, rnn_op):
    """(b): the FusedRNNCell LM and its LSTMCell stack at bucket
    LSTM_CHECK_BUCKET on the card, the stack's weights moved by
    unpack_weights (and pack_weights back, exactly), each forward's
    probabilities against the fused graph's float64 forward on the host."""
    W = lb.WIDTHS
    V, B, T = W["words"] + 1, lb.BATCH, LSTM_CHECK_BUCKET
    cells = {c: lb.make_cell(mt, c, W["num_layers"], W["num_hidden"])
             for c in ("fused", "lstm")}
    syms = {c: lb.make_sym_gen(mt, cell, V, W["num_embed"],
                               W["num_hidden"])(T)[0]
            for c, cell in cells.items()}
    shapes = {"data": (B, T), "softmax_label": (B, T)}
    arg_shapes = dict(zip(syms["fused"].list_arguments(),
                          syms["fused"].infer_shape(**shapes)[0]))
    rng = np.random.default_rng(SEED + 40)
    # float32 values: unpack_weights hands float32 arrays out
    params = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
              .astype(np.float64) for n, s in arg_shapes.items()
              if n not in shapes}
    inputs = {"data": rng.integers(1, V, (B, T)).astype(np.float64),
              "softmax_label": np.zeros((B, T))}

    def forward(sym, args, ctx, dtype):
        ex = sym.bind(ctx, {n: mt.nd.array(v, ctx=ctx, dtype=dtype)
                            for n, v in dict(args, **inputs).items()})
        return {"prob": ex.forward()[0].value.detach().double().cpu()}
    want = forward(syms["fused"], params, mt.cpu(), np.float64)
    floors = [forward(syms["fused"], nudged_values(params, SEED + 140 + i)
                      if i else params, mt.cpu(), np.float32)
              for i in range(RESNET_FLOOR_SAMPLES)]
    fused_cell = cells["fused"]
    fused_cell._input_size_hint = W["num_embed"]
    unpacked = fused_cell.unpack_weights({"lstm_parameters": mt.nd.array(
        params["lstm_parameters"], ctx=mt.cpu())})
    if any(v.context != mt.cpu() for v in unpacked.values()):
        fail("lstm_bucketing: unpack_weights gave arrays off the host")
    back = fused_cell.pack_weights(dict(unpacked))["lstm_parameters"]
    if back.context != mt.cpu() or not np.array_equal(
            back.asnumpy(), params["lstm_parameters"]):
        fail("lstm_bucketing: pack_weights(unpack_weights(p)) != p")
    uparams = {n: v for n, v in params.items() if n != "lstm_parameters"}
    uparams.update((n, v.asnumpy()) for n, v in unpacked.items())
    if sorted(uparams) != sorted(n for n in syms["lstm"].list_arguments()
                                 if n not in shapes):
        fail("lstm_bucketing: unpacked weights %s do not name the stack's"
             % sorted(unpacked))
    gpu = mt.gpu(0)
    rnn_op.cudnn_calls = 0
    fused = forward(syms["fused"], params, gpu, np.float32)
    calls = rnn_op.cudnn_calls
    unfused = forward(syms["lstm"], uparams, gpu, np.float32)
    if calls != W["num_layers"] or rnn_op.cudnn_calls != calls:
        fail("lstm_bucketing: cuDNN calls fused=%d unfused=%d, want %d "
             "and 0" % (calls, rnn_op.cudnn_calls - calls,
                        W["num_layers"]))
    tag = "lstm_bucketing fused_vs_unfused bucket=%d" % T
    worst = floor_check(torch, tag + " graph=fused", fused, want, floors,
                        unfused)
    worst_u = floor_check(torch, tag + " graph=lstm", unfused, want,
                          floors)
    print("%s worst_x_floor fused=%.3f unfused=%.3f (probabilities of "
          "(%d, %d))" % (tag, worst, worst_u, B * T, V))


def lstm_fit(torch, mt, lb, rnn_op, cell, card):
    """(c) for one cell: BucketingModule.fit through the bench's ``run``;
    every bucket bound once onto the default bucket's tensors, cuDNN
    calls, the perplexity falling, a checkpoint of the default bucket
    scoring the same; its numbers."""
    binds = []
    orig = mt.module.Module.bind

    def counting_bind(self, *args, **kwargs):
        binds.append(kwargs.get("shared_module") is not None)
        return orig(self, *args, **kwargs)
    mt.module.Module.bind = counting_bind
    rnn_op.cudnn_calls = 0
    try:
        rec, mod, it, sym_gen = lb.run(cell, LSTM_EPOCHS,
                                       LSTM_BATCHES_PER_BUCKET, mt.gpu(0),
                                       seed=SEED)
    finally:
        mt.module.Module.bind = orig
    tag = "lstm_bucketing fit cell=%s" % cell
    buckets = list(lb.BUCKETS)
    if rec["buckets_bound"] != buckets or len(binds) != len(buckets) or \
            binds.count(True) != len(buckets) - 1:
        fail("%s: binds %r for buckets %r" % (tag, binds,
                                              rec["buckets_bound"]))
    default = mod._buckets[it.default_bucket_key]
    ref = default._exec_group.execs[0]
    for key, m in mod._buckets.items():
        ex = m._exec_group.execs[0]
        for n in default._param_names:
            if ex.arg_dict[n].value.data_ptr() != \
                    ref.arg_dict[n].value.data_ptr() or \
                    ex.grad_dict[n].value.data_ptr() != \
                    ref.grad_dict[n].value.data_ptr():
                fail("%s: bucket %d holds its own %s" % (tag, key, n))
    want_calls = lb.WIDTHS["num_layers"] * rec["batches"] \
        if cell == "fused" else 0
    if rec["cudnn_calls"] != want_calls:
        fail("%s: %d cuDNN calls in %d batches, want %d"
             % (tag, rec["cudnn_calls"], rec["batches"], want_calls))
    ppl = rec["train_perplexity"]
    if not ppl[-1] < ppl[0]:
        fail("%s: training perplexity %r did not fall" % (tag, ppl))
    batches = KeptBatches(it)
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "lstm_bucketing")
    os.makedirs(ck_dir, exist_ok=True)
    prefix = os.path.join(ck_dir, cell)
    try:
        arg, aux = mod.get_params()
        mt.model.save_checkpoint(prefix, LSTM_EPOCHS, default.symbol, arg,
                                 aux)
        loaded = mt.Module.load(prefix, LSTM_EPOCHS, context=mt.gpu(0))
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    if loaded.symbol.tojson() != default.symbol.tojson():
        fail("%s: the checkpoint's symbol is not the default bucket's" % tag)
    fresh = mt.module.BucketingModule(sym_gen, it.default_bucket_key,
                                      context=mt.gpu(0))
    fresh.bind(it.provide_data, it.provide_label, for_training=False)
    fresh.set_params(loaded._arg_params, loaded._aux_params)
    score = mod.score(batches, mt.metric.Perplexity(lb.INVALID_LABEL))
    score_back = fresh.score(batches, mt.metric.Perplexity(lb.INVALID_LABEL))
    if score_back != score:
        fail("%s: the loaded checkpoint scores %r, the module %r"
             % (tag, score_back, score))
    metric_ms = perplexity_cost(torch, mt, lb, mod, batches)
    print("%s tokens_per_s=%r (steady; over the whole fit %r) "
          "fit_seconds=%r batches=%d "
          "host_ms_per_batch=%s train_perplexity=%r cudnn_calls=%d "
          "device_busy_share=%r (one batch of each bucket, profiled, %d "
          "launches; device ms by group %s) peak_mem_gb=%r "
          "buckets_bound=%r (%d with shared_module) checkpoint_score=%r "
          "perplexity_update_ms at bucket %d: picked on the card=%r, the "
          "whole softmax copied to the host=%r [%s]"
          % (tag, rec["value"], rec["fit_tokens_per_s"], rec["fit_seconds"],
             rec["batches"],
             json.dumps(rec["host_ms_per_batch"]), ppl, rec["cudnn_calls"],
             rec["device_busy_share"], rec["profiled_launches"],
             json.dumps(rec["device_ms_by_group"]), rec["peak_mem_gb"],
             rec["buckets_bound"], binds.count(True), score[0][1],
             max(lb.BUCKETS), metric_ms[0], metric_ms[1], card))
    del mod, fresh, batches
    torch.cuda.empty_cache()
    return rec


def perplexity_cost(torch, mt, lb, mod, batches, reps=5):
    """Host ms of one ``Perplexity.update`` on a forward of the largest
    bucket (each row's label probability picked on the card, one value a
    row fetched) beside the yardstick the port does not use: the whole
    (batch x length, vocabulary) softmax copied to the host and picked
    there, as the JAX package's metric does."""
    b = [x for x in batches if x.bucket_key == max(lb.BUCKETS)][0]
    mod.forward(b, is_train=False)
    out, lab = mod.get_outputs()[0], b.label[0]

    def picked_on_card():
        mt.metric.Perplexity(lb.INVALID_LABEL).update([lab], [out])

    def copied():
        probs = out.asnumpy().reshape(-1, out.shape[-1])
        rows = lab.asnumpy().astype("int32").reshape(-1)
        return probs[np.arange(rows.shape[0]), rows]
    res = []
    for fn in (picked_on_card, copied):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        res.append((time.perf_counter() - t0) * 1e3 / reps)
    return res


def lstm_bucketing_phase(torch, mt, card):
    """The sequences slice: (a) the RNN op's routes, (b) fused against
    unfused, (c) the bucketed LM through BucketingModule.fit with each
    cell (see RNN_SHAPE above)."""
    from mxnet_tpu_torch.bench import lstm_bucketing as lb
    from mxnet_tpu_torch.ops import rnn_op
    rnn_ms = {}
    for mode, bi in RNN_CASES:
        rnn_ms[(mode, bi)] = rnn_op_check(torch, rnn_op, mode, bi)
    lstm_fused_unfused(torch, mt, lb, rnn_op)
    fits = {cell: lstm_fit(torch, mt, lb, rnn_op, cell, card)
            for cell in ("fused", "lstm")}
    print("lstm_bucketing tokens_per_s fused=%r lstm=%r (%s)"
          % (fits["fused"]["value"], fits["lstm"]["value"], card))
    return {"rnn_ms": rnn_ms, "fits": fits}


def ssd_anchors(torch, get_op, ssd, dev):
    """The SSD's anchors (1, SSD_ANCHORS, 4) from MultiBoxPrior on ``dev``:
    the three feature maps of a 64x64 input (16, 8 and 4 pixels a side)."""
    prior = get_op("MultiBoxPrior").fn
    parts = [prior(torch.zeros((1, 1, f, f), device=dev), sizes=sizes,
                   ratios=ratios)
             for f, sizes, ratios in zip((16, 8, 4), ssd._SIZES, ssd._RATIOS)]
    return torch.cat(parts, 1)


def ssd_head_outputs():
    """(cls_pred, cls_prob, loc_pred) of the ssd phase's MultiBox checks,
    float32 numpy from SEED: class scores for MultiBoxTarget, class
    probabilities and box offsets for MultiBoxDetection."""
    rng = np.random.default_rng(SEED)
    cls_pred = rng.standard_normal(
        (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS)).astype(np.float32)
    logits = rng.standard_normal((SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS))
    cls_prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(np.float32)
    loc_pred = (rng.standard_normal((SSD_BATCH, SSD_ANCHORS * 4))
                * 0.5).astype(np.float32)
    return cls_pred, cls_prob, loc_pred


def ssd_ops_check(torch, mt, contrib, st, ssd):
    """(a) of the ssd phase: the MultiBox ops at the SSD's shapes on the
    card against the float64 CPU version, the NMS kernel against its plain
    version on the card, the three ops under sync_free, the kernel and the
    plain loop timed.  Returns the kernel's JSON numbers."""
    from mxnet_tpu_torch.ops.registry import get_op
    cuda = mt.gpu(0).torch_device()
    anchors = ssd_anchors(torch, get_op, ssd, cuda)
    want_anchors = ssd_anchors(torch, get_op, ssd, "cpu")
    if tuple(anchors.shape) != (1, SSD_ANCHORS, 4) \
            or not torch.equal(anchors.cpu(), want_anchors):
        fail("ssd: MultiBoxPrior on the card %s differs from the CPU's"
             % (tuple(anchors.shape),))
    _, label = st.synthetic_detection_batch(np.random.RandomState(0),
                                            SSD_BATCH, SSD_CLASSES)
    cls_pred, cls_prob, loc_pred = ssd_head_outputs()
    tkw = dict(overlap_threshold=0.5, ignore_label=-1.0,
               negative_mining_ratio=3.0, minimum_negative_samples=0,
               negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2))
    target = get_op("MultiBoxTarget").fn
    detect = get_op("MultiBoxDetection").fn

    def on(dev, dtype, *arrs):
        return [torch.from_numpy(np.asarray(a, dtype)).to(dev)
                for a in arrs]
    got = target(anchors, *on(cuda, np.float32, label, cls_pred), **tkw)
    want = target(want_anchors.double(),
                  *on("cpu", np.float64, label, cls_pred), **tkw)
    loc_t, loc_m, cls_t = (g.double().cpu() for g in got)
    loc_err = ((loc_t - want[0]).abs().max()
               / want[0].abs().max().clamp_min(1)).item()
    diff = (int((cls_t != want[2]).sum()), int((loc_m != want[1]).sum()),
            int(((loc_t - want[0]).abs() > SSD_LOC_TOL
                 * want[0].abs().max().clamp_min(1)).sum()))
    print("ssd multibox_target B=%d A=%d label_width=3 positives=%d "
          "negatives=%d ignored=%d differing cls_target=%d loc_mask=%d "
          "loc_target=%d loc_target_rel_err=%.3e (card float32 vs CPU "
          "float64)" % ((SSD_BATCH, SSD_ANCHORS, int((want[2] > 0).sum()),
                        int((want[2] == 0).sum()),
                        int((want[2] < 0).sum())) + diff + (loc_err,)))
    if any(diff) or loc_err > SSD_LOC_TOL:
        fail("ssd: MultiBoxTarget on the card differs from float64 on the "
             "CPU (%d, %d, %d entries)" % diff)
    cp, lp = on(cuda, np.float32, cls_prob, loc_pred)
    per_call = 2 * contrib.nms_plan(SSD_BATCH, SSD_ANCHORS)[2]
    n0 = contrib.nms_launches
    out = detect(cp, lp, anchors)
    torch.cuda.synchronize()
    if contrib.nms_launches != n0 + per_call:
        fail("ssd: MultiBoxDetection launched the NMS kernels %d times, "
             "not %d" % (contrib.nms_launches - n0, per_call))
    cid, score, boxes = contrib.detection_rows(cp, lp, anchors)
    ids_ref = contrib.greedy_nms_ref(boxes, cid, 0.5)
    ref = torch.cat([ids_ref[..., None],
                     torch.where(ids_ref >= 0, score, -1.0)[..., None],
                     boxes], -1)
    kernel_err = (out - ref).abs().max().item()
    if not torch.equal(out[..., 0], ref[..., 0]) \
            or kernel_err > SSD_DET_TOL:
        fail("ssd: the NMS kernel's ids differ from greedy_nms_ref's on the "
             "card (%d rows; max error %r)"
             % (int((out[..., 0] != ref[..., 0]).sum()), kernel_err))
    want_det = detect(*on("cpu", np.float64, cls_prob, loc_pred),
                      want_anchors)
    det_err = (out.double().cpu() - want_det).abs().max().item()
    kept = (out[..., 0] >= 0).cpu()
    print("ssd multibox_detection B=%d A=%d kept=%d (per image %s) "
          "kernel_vs_plain ids_equal=True max_abs_err=%r; card float32 vs "
          "CPU float64 differing_ids=%d max_abs_err=%.3e"
          % (SSD_BATCH, SSD_ANCHORS, int(kept.sum()),
             kept.sum(1).tolist(), kernel_err,
             int((out[..., 0].cpu().double() != want_det[..., 0]).sum()),
             det_err))
    if not torch.equal(out[..., 0].cpu().double(), want_det[..., 0]) \
            or det_err > SSD_DET_TOL:
        fail("ssd: MultiBoxDetection on the card differs from float64 on "
             "the CPU (max error %r)" % det_err)

    lab_d, pred_d = on(cuda, np.float32, label, cls_pred)

    def ops():
        a = ssd_anchors(torch, get_op, ssd, cuda)
        target(a, lab_d, pred_d, **tkw)
        detect(cp, lp, a)
    sync_free(torch, "ssd multibox ops", ops)
    mask_ms, scan_ms, ms = nms_kernel_ms(torch, contrib, boxes, cid, 0.5)
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        contrib.greedy_nms(boxes, cid, 0.5)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        detect(cp, lp, anchors)
    torch.cuda.synchronize()
    detect_ms = (time.perf_counter() - t0) / reps * 1e3
    plain_ms = time_ms(torch, lambda: contrib.greedy_nms_ref(boxes, cid,
                                                             0.5), iters=2)
    # the work this run's data needs: each kept row i compares the rows
    # after it; the boxes and ids read once, the ids written once
    rows = [np.nonzero(k)[0] for k in kept.numpy()]
    pairs = sum(int((SSD_ANCHORS - 1 - r).sum()) for r in rows)
    nbytes = SSD_BATCH * SSD_ANCHORS * (4 + 1 + 1) * 4
    chain_ms = max(len(r) for r in rows) * NMS_STEP_CYCLES / NMS_SM_HZ \
        * 1e3
    ops_ms = max(pairs * NMS_IOU_OPS / PEAK_OPS["float32"] * 1e3, chain_ms)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    print("ssd nms kernels_ms=%r (event-timed together; apart: mask %r, "
          "scan %r; %d launches a call) wrapper_host_us_per_call=%r "
          "detect_ms=%r "
          "(MultiBoxDetection forward, host clock) plain_ms=%r bound_ms=%r "
          "(a chain of %d dependent steps, one a kept row, %r ms; %d IoU "
          "pairs %r ms; %d bytes %r ms)"
          % (ms, mask_ms, scan_ms, per_call, host_us, detect_ms, plain_ms,
             max(ops_ms, bytes_ms), max(len(r) for r in rows), chain_ms,
             pairs, pairs * NMS_IOU_OPS / PEAK_OPS["float32"] * 1e3, nbytes,
             bytes_ms))
    nms_large_check(torch, contrib)
    return {"max_abs_err": kernel_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nms_large_check(torch, contrib):
    """The NMS kernels at NMS_LARGE on random boxes: ids equal to the plain
    loop's on the card; the kernels event-timed."""
    from mxnet_tpu_torch.bench import host_emu
    b, n, classes, thr = NMS_LARGE
    boxes, ids = host_emu.nms_inputs(
        (b, n, classes, "random", thr, False, torch.float32),
        torch.Generator().manual_seed(SEED))
    boxes, ids = boxes.cuda(), ids.cuda()
    got = contrib.greedy_nms(boxes, ids, thr)
    t0 = time.perf_counter()
    want = contrib.greedy_nms_ref(boxes, ids, thr)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got, want):
        fail("ssd: the NMS kernels' ids differ from greedy_nms_ref's at "
             "B=%d A=%d (%d rows)" % (b, n, int((got != want).sum())))
    mask_ms, scan_ms, ms = nms_kernel_ms(torch, contrib, boxes, ids, thr)
    kept = (want >= 0).sum(1)
    print("ssd nms_large B=%d A=%d classes=%d threshold=%r valid=%d kept=%d "
          "(fullest image %d) ids_equal=True bands=%d kernels_ms=%r (apart: "
          "mask %r, scan %r) plain_seconds=%r bound_ms=%r (a chain of %d "
          "steps)"
          % (b, n, classes, thr, int((ids >= 0).sum()), int(kept.sum()),
             int(kept.max()), contrib.nms_plan(b, n)[2], ms,
             mask_ms, scan_ms, plain_s,
             int(kept.max()) * NMS_STEP_CYCLES / NMS_SM_HZ * 1e3,
             int(kept.max())))


def ssd_state(mt, net):
    """The step check's state as numpy: parameters from TrainStep.init's
    default initializer at SEED, and the example's first batch."""
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=SSD_LR),
                      data_names=("data",), label_names=("label",),
                      ctx=mt.cpu())
    shapes = ({"data": (SSD_BATCH, 3, 64, 64)}, {"label": (SSD_BATCH, 3, 5)})
    params, _, _ = ts.init(*shapes, seed=SEED)
    return ({n: v.numpy() for n, v in params.items()}, shapes)


def ssd_step(torch, mt, net, params, data, ctx, dtype):
    """One SGD-momentum step from ``params`` on ``data`` at ``dtype`` on
    ``ctx``: ((first momenta, updates) as float64 CPU tensors, outputs,
    (TrainStep, params, opt_state, aux, batch) after it)."""
    ts = mt.TrainStep(net, mt.optimizer.SGD(
        learning_rate=SSD_LR, momentum=0.9, wd=5e-4,
        rescale_grad=1.0 / SSD_BATCH), data_names=("data",),
        label_names=("label",), ctx=ctx)
    p, s, a = mt.convert.train_state_from_numpy(
        {n: v.astype(dtype) for n, v in params.items()},
        {n: (np.zeros_like(v, dtype),) for n, v in params.items()}, {},
        ctx=ctx)
    batch = ts.shard_batch({k: v.astype(dtype) for k, v in data.items()})
    before = {n: v.double().cpu().clone() for n, v in p.items()}
    p, s, a, outs = ts(p, s, a, batch)
    return (({n: st[0].double().cpu() for n, st in s.items()},
             {n: v.double().cpu() - before[n] for n, v in p.items()}),
            outs, (ts, p, s, a, batch))


def ssd_step_check(torch, mt, st, ssd):
    """(b) of the ssd phase: one float32 step on the card against the
    float64 step on the CPU, each leaf within RESNET_FLOOR_X times its
    float32 floor; the step under sync_free."""
    net = ssd.get_symbol_train(num_classes=SSD_CLASSES)
    params, shapes = ssd_state(mt, net)
    d, lab = st.synthetic_detection_batch(np.random.RandomState(0),
                                          SSD_BATCH, SSD_CLASSES)
    data = {"data": d, "label": lab}
    t0 = time.perf_counter()
    want, want_outs, _ = ssd_step(torch, mt, net, params, data, mt.cpu(),
                                  np.float64)
    floors = []
    for i in range(RESNET_FLOOR_SAMPLES):
        p = nudged_values(params, SEED + 100 + i) if i else params
        x = nudged_values(data, SEED + 200 + i, skip=("label",)) if i \
            else data
        floors.append(ssd_step(torch, mt, net, p, x, mt.cpu(),
                               np.float32)[0])
    print("ssd_train steps=cpu_f64+%d cpu_f32 seconds=%r"
          % (RESNET_FLOOR_SAMPLES, time.perf_counter() - t0))
    got, outs, (ts, p, s, a, batch) = ssd_step(
        torch, mt, net, params, data, mt.gpu(0), np.float32)
    cls_t = outs[2].double().cpu()
    if not torch.equal(cls_t, want_outs[2]):
        fail("ssd_train: the card's cls_target differs from the float64 "
             "step's in %d entries" % int((cls_t != want_outs[2]).sum()))
    print("ssd_train cls_target equal to the float64 step's: positives=%d "
          "negatives=%d ignored=%d" % (int((cls_t > 0).sum()),
                                       int((cls_t == 0).sum()),
                                       int((cls_t < 0).sum())))
    resnet50_check_rows(torch, "ssd_train", resnet50_leaf_rows(
        torch, got, want, floors, kinds=("grad", "update")),
        "float32 floor")
    sync_free(torch, "ssd_train step", lambda: ts(p, s, a, batch))


def ssd_phase(torch, mt, card):
    """The SSD slice: (a) the MultiBox ops and the NMS kernel, (b) one
    training step held to float64, (c) Module.fit through
    bench/ssd_train.py and the detection symbol, then a timing fit."""
    from mxnet_tpu_torch.bench import ssd_train as st
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import contrib
    nms = ssd_ops_check(torch, mt, contrib, st, ssd)
    ssd_step_check(torch, mt, st, ssd)
    contrib.nms_launches = 0
    rec, _, out = st.run(SSD_CLASSES, SSD_BATCH, lr=SSD_LR)
    timing, _, _ = st.run(**SSD_TIMING)
    launches = contrib.nms_launches
    # each run: one warm detection forward, then the timed ones
    forwards = 2 + rec["detect_forwards"] + timing["detect_forwards"]
    print("ssd fit %s" % json.dumps(rec))
    print("ssd fit %s" % json.dumps(timing))
    if not rec["fused_path"]:
        fail("ssd: Module.fit took the general path")
    if not rec["loc_l1"][1] < rec["loc_l1"][0]:
        fail("ssd: LocL1 did not fall: %r" % rec["loc_l1"])
    if out.shape != (SSD_BATCH, SSD_ANCHORS, 6) \
            or rec["kept_detections"] < 1 or not np.isfinite(out).all():
        fail("ssd: detections %r with %d kept rows"
             % (out.shape, rec["kept_detections"]))
    per_call = 2 * contrib.nms_plan(SSD_BATCH, SSD_ANCHORS)[2]
    want = per_call * (1 + rec["detect_forwards"]) + 2 * contrib.nms_plan(
        SSD_TIMING["batch_size"], SSD_ANCHORS)[2] \
        * (1 + timing["detect_forwards"])
    if launches != want \
            or rec["nms_launches"] != per_call * rec["detect_forwards"]:
        fail("ssd: %d NMS launches in %d detection forwards (%d expected)"
             % (launches, forwards, want))
    print("ssd nms launches=%d in %d detection forwards (%d a forward: the "
          "mask and the scan), 0 in the fits; detect_ms=%r (batch %d) %r "
          "(batch %d)" % (launches, forwards, per_call, rec["detect_ms"],
                          SSD_BATCH, timing["detect_ms"],
                          SSD_TIMING["batch_size"]))
    print("ssd img_per_s classes=%d batch=%d: %r (host %r ms a batch, "
          "busy %r, peak %r GB); classes=%d batch=%d: %r (host %r ms, busy "
          "%r, peak %r GB) (%s)"
          % (SSD_CLASSES, SSD_BATCH, rec["value"], rec["host_ms_per_batch"],
             rec.get("device_busy_share"), rec.get("peak_mem_gb"),
             SSD_TIMING["num_classes"], SSD_TIMING["batch_size"],
             timing["value"], timing["host_ms_per_batch"],
             timing.get("device_busy_share"), timing.get("peak_mem_gb"),
             card))
    return dict(nms, launches=launches)


def build_all(kernels):
    """Build every kernel library at once (one nvcc each, in threads: the
    compiler runs outside the GIL); fatal on any failure."""
    results = {}

    def one(name, build):
        t0 = time.perf_counter()
        try:
            results[name] = (build(), time.perf_counter() - t0)
        except Exception as exc:   # reported below; the phase then fails
            results[name] = exc
    threads = [threading.Thread(target=one, args=kv) for kv in kernels]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, _ in kernels:
        res = results.get(name)
        if not isinstance(res, tuple):
            fail("build %s: %s" % (name, res))
        log, secs = res
        print("build %s.cu seconds=%r" % (name, secs))
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas %s %s" % (name, line.strip()))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch.ops import contrib
        from mxnet_tpu_torch.ops import flash_attention as fa
        from mxnet_tpu_torch.ops import norm_conv as nc
    except ImportError as exc:
        fail("cannot import mxnet_tpu_torch: %s" % exc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi failed: %s" % smi.stderr
    print(card)
    print("torch %s cuda %s device %s" % (torch.__version__,
                                         torch.version.cuda,
                                         torch.cuda.get_device_name(0)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("settings cudnn.allow_tf32=%s matmul.allow_tf32=%s "
          "float32_matmul_precision=%s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision()))
    bf16_np = mt.base.np_bfloat16()
    print("ml_dtypes %s: a bfloat16 NDArray's dtype is %s"
          % ("imports" if bf16_np is not None else "does not import",
             mt.nd.array(np.zeros(1, np.float32), ctx=mt.cpu(),
                         dtype="bfloat16").dtype))
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print("phase %s seconds=%r" % (name, now - t_phase[0]))
        t_phase[0] = now

    t0 = time.perf_counter()
    build_all([("norm_conv", nc.build), ("flash_attention", fa.build),
               ("flash_attention_bwd", fa.build_bwd),
               ("multibox_nms", contrib.build)])
    print("build all seconds=%r" % (time.perf_counter() - t0))
    phase_done("build")

    geoms, stats_geoms = resnet50_geometries(mt, BATCH)
    per_forward = sum(geoms.values())
    print("resnet50 norm_conv geometries=%d launches_per_forward=%d "
          "with_statistics_in_training=%d"
          % (len(geoms), per_forward, sum(stats_geoms.values())))
    if len(geoms) != 22 or per_forward != RESNET_NC_PER_STEP or \
            sum(stats_geoms.values()) != RESNET_NC_STATS_PER_STEP:
        fail("expected 22 geometries, %d launches per forward and %d with "
             "statistics" % (RESNET_NC_PER_STEP, RESNET_NC_STATS_PER_STEP))
    tot = kernel_phase(torch, nc, geoms)
    print("kernel totals per batch-%d float32 forward (52 launches): "
          "kernel_ms=%r plain_ms=%r library_ms=%r bound_ms=%r"
          % (BATCH, tot["ms"], tot["plain_ms"], tot["library_ms"],
             tot["bound_ms"]))
    ttot = kernel_train_phase(torch, nc, geoms, stats_geoms)
    print("kernel totals per batch-%d float32 training step's forward (%d "
          "launches, %d with statistics): kernel_ms=%r plain_ms=%r "
          "library_ms=%r bound_ms=%r bound_by=%s"
          % (RESNET_TRAIN_BATCH, RESNET_NC_PER_STEP,
             RESNET_NC_STATS_PER_STEP, ttot["ms"], ttot["plain_ms"],
             ttot["library_ms"], ttot["bound_ms"],
             "operations" if ttot["ops_ms"] >= ttot["bytes_ms"]
             else "bytes"))
    btot = kernel_train_phase(torch, nc, geoms, stats_geoms, torch.bfloat16,
                              (RESNET_TRAIN_BATCH,))
    print("kernel totals per batch-%d bfloat16 training step's forward (%d "
          "launches, %d with statistics): kernel_ms=%r plain_ms=%r "
          "library_ms=%r bound_ms=%r bound_by=%s"
          % (RESNET_TRAIN_BATCH, RESNET_NC_PER_STEP,
             RESNET_NC_STATS_PER_STEP, btot["ms"], btot["plain_ms"],
             btot["library_ms"], btot["bound_ms"],
             "operations" if btot["ops_ms"] >= btot["bytes_ms"]
             else "bytes"))
    phase_done("kernels")

    launches = serving_phase(torch, mt, nc, per_forward)
    phase_done("serving")
    unfused = resnet50_train_phase(torch, mt, nc, "0")
    torch.cuda.empty_cache()
    phase_done("resnet50_train")
    fused = resnet50_train_phase(torch, mt, nc, "1", unfused["want"])
    torch.cuda.empty_cache()
    phase_done("resnet50_train_fused")
    amp_unfused = resnet50_train_amp_phase(torch, mt, nc, "0",
                                           unfused["want"],
                                           unfused["img_s"])
    torch.cuda.empty_cache()
    phase_done("resnet50_train_amp")
    amp_fused = resnet50_train_amp_phase(torch, mt, nc, "1", fused["want"],
                                         fused["img_s"])
    phase_done("resnet50_train_amp_fused")
    mf = module_fit_phase(torch, mt, nc, fa, unfused["img_s"])
    phase_done("module_fit")
    lstm_bucketing_phase(torch, mt, card)
    phase_done("lstm_bucketing")
    nms = ssd_phase(torch, mt, card)
    phase_done("ssd")
    print(card)
    print("norm_conv launches serving=%d training=%d (%d with statistics, "
          "%d fused training steps) amp_training=%d (%d with statistics, "
          "%d in bfloat16, %d fused AMP steps)"
          % (launches, fused["launches"], fused["stats_launches"],
             fused["steps"], amp_fused["launches"],
             amp_fused["stats_launches"], amp_fused["bf16_launches"],
             amp_fused["steps"]))
    print("resnet50 img_per_s batch=%d unfused float32=%r bf16_amp=%r "
          "fused float32=%r bf16_amp=%r (this call)"
          % (RESNET_TRAIN_BATCH, unfused["img_s"], amp_unfused["img_s"],
             fused["img_s"], amp_fused["img_s"]))
    del unfused, fused["want"]
    torch.cuda.empty_cache()

    fl = flash_phase(torch, fa)
    phase_done("flash")
    fl_launches = lm_phase(torch, mt, fa)
    phase_done("lm")
    per = LM["num_layers"]     # the launches of one float32 LM forward
    bw = flash_bwd_phase(torch, fa)
    phase_done("flash_bwd")
    dq_launches, dkv_launches = lm_train_phase(torch, mt, fa)
    phase_done("lm_train")
    amp_counts = lm_train_amp_phase(torch, mt, fa)
    torch.cuda.empty_cache()
    phase_done("lm_train_amp")
    graph_device_phase(torch, mt)
    weights = lm_weights(mt.models.transformer.get_symbol(**LM))
    imperative_phase(torch, mt, weights)
    phase_done("graph_device+imperative")
    rt = rtc_phase(torch, mt, weights)
    phase_done("rtc")
    flb, bwb = fl["bfloat16"], bw["bfloat16"]

    print(json.dumps({"kernels": [{
        "name": "norm_conv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_conv.cu",
        "replaces": "mxnet_tpu/ops/pallas_conv.py:120",
        "launches": launches + fused["launches"] + amp_fused["launches"]
        + mf["norm_conv"],
        "max_abs_err": max(tot["max_abs_err"], ttot["max_abs_err"]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"]
        else "bytes",
        "library_ms": tot["library_ms"],
        "bf16_train": {
            "launches": amp_fused["bf16_launches"] + mf["norm_conv_bf16"],
            "max_abs_err": btot["max_abs_err"], "ms": btot["ms"],
            "plain_ms": btot["plain_ms"], "bound_ms": btot["bound_ms"],
            "bound_by": "operations" if btot["ops_ms"] >= btot["bytes_ms"]
            else "bytes", "library_ms": btot["library_ms"]}}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:47",
        "launches": fl_launches + amp_counts[0] + mf["flash"][0],
        "max_abs_err": fl["max_abs_err"],
        "ms": per * fl["ms"], "plain_ms": per * fl["plain_ms"],
        "bound_ms": per * fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": per * fl["library_ms"],
        "bf16_train": {
            "launches": amp_counts[0], "max_abs_err": flb["max_abs_err"],
            "ms": per * flb["ms"], "plain_ms": per * flb["plain_ms"],
            "bound_ms": per * flb["bound_ms"], "bound_by": flb["bound_by"],
            "library_ms": per * flb["library_ms"]}}, {
        "name": "flash_attention_bwd_dq", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:137",
        "launches": dq_launches + amp_counts[1] + mf["flash"][1],
        "max_abs_err": bw["dq_err"],
        "ms": per * bw["dq_ms"], "plain_ms": per * bw["plain_ms"],
        "plain_covers": "dq+dk+dv",
        "bound_ms": per * bw["dq_bound_ms"], "bound_by": bw["dq_bound_by"],
        "library_ms": per * bw["library_ms"],
        "library_covers": "dq+dk+dv",
        "bf16_train": {
            "launches": amp_counts[1], "max_abs_err": bwb["dq_err"],
            "ms": per * bwb["dq_ms"], "plain_ms": per * bwb["plain_ms"],
            "bound_ms": per * bwb["dq_bound_ms"],
            "bound_by": bwb["dq_bound_by"],
            "library_ms": per * bwb["library_ms"]}}, {
        "name": "flash_attention_bwd_dkv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:169",
        "launches": dkv_launches + amp_counts[2] + mf["flash"][2],
        "max_abs_err": bw["dkv_err"],
        "ms": per * bw["dkv_ms"], "plain_ms": per * bw["plain_ms"],
        "plain_covers": "dq+dk+dv",
        "bound_ms": per * bw["dkv_bound_ms"],
        "bound_by": bw["dkv_bound_by"],
        "library_ms": per * bw["library_ms"],
        "library_covers": "dq+dk+dv",
        "bf16_train": {
            "launches": amp_counts[2], "max_abs_err": bwb["dkv_err"],
            "ms": per * bwb["dkv_ms"], "plain_ms": per * bwb["plain_ms"],
            "bound_ms": per * bwb["dkv_bound_ms"],
            "bound_by": bwb["dkv_bound_by"],
            "library_ms": per * bwb["library_ms"]}}, {
        "name": "rtc_axpb", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc_kernels.py",
        "replaces": "mxnet_tpu/rtc.py:55",
        "launches": rt["launches"], "max_abs_err": rt["max_abs_err"],
        "ms": rt["ms"], "plain_ms": rt["plain_ms"],
        "bound_ms": rt["bound_ms"], "bound_by": rt["bound_by"],
        "library_ms": rt["library_ms"]}, {
        "name": "multibox_nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/multibox_nms.cu",
        "replaces": "mxnet_tpu/ops/contrib.py:229 (XLA fori_loop, not "
                    "pl.pallas_call)",
        "launches": nms["launches"], "max_abs_err": nms["max_abs_err"],
        "ms": nms["ms"], "plain_ms": nms["plain_ms"],
        "bound_ms": nms["bound_ms"], "bound_by": nms["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
