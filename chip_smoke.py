#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).  Phases, each
fatal on failure:

1. build: compile the four kernel sources (csrc/norm_conv.cu,
   csrc/flash_attention.cu, csrc/flash_attention_bwd.cu,
   csrc/multibox_nms.cu) for sm_90a, one nvcc each, started together
   with g++ on the C API library (csrc/c_api.cc against this
   interpreter's Python.h and libpython), op.h (cpp-package's generator
   built and run against it) and the cpp-package examples mlp_predict
   and lenet_train;
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
4f. observability (after module_fit): ResNet-50 at full width, batch
   OBS_BATCH, float32, through ``Module.fit``.  (a) ``MXNET_TELEMETRY``
   set: the general path, OBS_BATCHES batches, each batch's data_wait,
   forward, backward, update, metric and step ms and their medians over
   the steady batches (the input copies and the executor's spans inside
   them too); the children cover 0.8-1.0 of every steady step;
   tools/telemetry_report.py, run as a subprocess on the file, names the
   spans.  (b) ``MXNET_TELEMETRY_FUSED=1`` with ``MXNET_NORM_CONV=1``: one
   ``fused_step`` span a batch, ``model_flops`` the graph's count (the
   same with the lever off), ``mfu`` in (0, 1) against ``cost``'s H100
   row, 52 NormConv launches a step.  (c) ``profiler.set_state("run")``
   around OBS_PROFILED fused steps: ``train_step[n]`` in the chrome trace,
   every ``nc_kernel`` of the torch trace launched inside a
   ``train_step`` range (by its launch's correlation id: the kernels'
   card-clock timestamps are not compared with host ranges), the device
   ms under each, the clock skew bound.  (d) ``Monitor(2)``: on the fused path the
   parameter rows within OBS_MONITOR_TOL of |w|/sqrt(size) of the
   parameters before the armed step; on the general path a row for every
   node output, by name, then every argument.  (e) Every knob unset: a
   fit's img/s beside module_fit's, one fused and one general-path step
   under ``set_sync_debug_mode``.  (f) NaiveEngine: the stream idle after
   each imperative op;
4g. operators (after ssd): the operator surface's first part.  (a) The
   20 ops it ports (LeakyReLU, Deconvolution, InstanceNorm,
   L2Normalization, LRN, UpSampling, softmax, log_softmax, topk, sort,
   argsort, the 0-index ops, _broadcast, _onehot_encode,
   IdentityAttachKLSparseReg, the slice assignments, Convolution_v1) at
   small shapes on the card, forward and backward in float32, each output
   and gradient within OPS_TOL of the same op in float64 on the host, the
   indices equal; rrelu's training slopes within their bounds, their mean
   near the midpoint.  (b) AlexNet (models/alexnet.py; train_imagenet.py
   --network alexnet's defaults: 1000 classes, 3x224x224, batch 32, random
   weights from a seed): one SGD-momentum step at batch 4 within
   RESNET_FLOOR_X times its float32 floor of the float64 CPU step, under
   MXNET_CONV_LAYOUT NHWC and NCHW, the Dropout masks injected; Module.fit,
   6 batches fused and 3 general (MXNET_FUSED_FIT=0): img/s, host ms a
   batch; the fused step's busy share and LRN's device ms.  (c) DCGAN
   through bench/dcgan.py at the example's defaults (batch 32, code 64,
   ngf = ndf = 32, Adam 2e-4, beta1 0.5), 10 iterations: finite losses,
   d_loss moving, the samples moved; one iteration from the initial
   parameters within the floor rule of the float64 one on the host;
4h. rcnn (after operators): the spatial ops, Proposal and CTCLoss.  (a)
   The 11 names (Crop, GridGenerator, BilinearSampler, SpatialTransformer,
   ROIPooling, Correlation, Proposal and _contrib_Proposal, CTCLoss,
   _contrib_CTCLoss and ctc_loss) at small shapes on the card in float32,
   each output and gradient within OPS_TOL of float64 on the host;
   Proposal in float64 on the card (its NMS the row-6 kernels) the same
   rows as the host's, its float32 rows counted.  (b) Faster R-CNN's test
   width (VGG-16's conv5_3 of a 600x1000 image, 38x63, 9 anchors; pre-NMS
   6,000, post-NMS 300, threshold 0.7, min size 16): Proposal timed and
   profiled, two NMS launches a call, its NMS ids at 6,000 rows equal to
   the plain loop's, the kernels event-timed beside the chain bound;
   ROIPooling (7x7 at 1/16, 512 channels, Proposal's ROIs, a ReLU'd map)
   against float64, forward and backward ms, peak memory above its inputs
   under ROI_PEAK_BYTES; both ops under sync_free.  (c) Correlation at
   FlowNetC's settings (two (8, 256, 48, 64) maps, max displacement 20,
   stride2 2, pad 20: 441 channels) against float64, forward and backward
   ms.  (d) CTCLoss at the warpctc OCR example's shapes (T 80, batch 32,
   4 digits, 11 classes) against float64 on the host and F.ctc_loss
   (loss and ms).  (e) The toy Faster R-CNN (bench/toy_rcnn.py): one
   SGD-momentum step within RESNET_FLOOR_X times its float32 floor of the
   float64 step, under sync_free; 12 epochs of Module.fit from each of
   RCNN_SEEDS seeds, the fused path, two NMS launches a forward, the
   median accuracy above RCNN_ACC; img/s, host ms a batch, busy share;
4i. imagenet (after rcnn): Inception-v3 at full width
   (models/inception_v3.py through bench/train_imagenet.py: 1000 classes,
   3x299x299, 23,834,568 parameters; 15 of its 94 convolutions fuse into
   NormConv in 9 geometries, 5 of them with statistics, pad 0 among them),
   then VGG-16.  The kernels phase holds and times the kernel at those 9
   geometries ("inception_geom_train" lines: batches INCEPTION_CHECK_BATCH
   and 32, y and both sums against the plain version, y bitwise over two
   launches; at 32 beside cuDNN's conv and the bound).  (a) One
   SGD-momentum step at batch INCEPTION_CHECK_BATCH, float32 on the card
   with MXNET_NORM_CONV 0 and 1, each gradient and moving statistic within
   RESNET_FLOOR_X times its float32 floor of the float64 CPU step; 15
   NormConv launches, 5 with statistics, with the knob on, none off.  (b)
   Module.fit at batch 32 over one synthetic batch repeated, fused (6
   batches) and general (3), knob off and on: img/s, host ms a batch, peak
   memory, the loss lower at the last batch than at the second, the busy
   share of profiled steps, the launches (15 a batch on).  (c) Predictor
   at batch INCEPTION_SERVE_BATCH under the knob: rows within SERVE_TOL of
   the unfused Predictor, 15 launches a forward.  (d) VGG-16
   (train_imagenet.py --network vgg): one step at batch VGG_CHECK_BATCH
   within the floor rule, Dropout masks injected; a fused Module.fit of
   VGG_FIT_BATCHES batches of 32, img/s and peak memory;
4j. custom (after imagenet): the custom-op bridge.  The MLP of MXNet's
   example/numpy-ops/custom_softmax.py (784-128-64-10, batch 100, 6
   synthetic batches) with its Custom softmax head (numpy forward, backward
   p - onehot, need_top_grad=False) through Module.fit, fused and general,
   each parameter within RESNET_FLOOR_X times its float32 floor of the same
   net with SoftmaxOutput; host ms a batch of both heads and the head's
   host reads a batch.  test_custom_op.py's sqr, in mx.nd ops on the card,
   inside a ResNet-style block under the NHWC pass: forward and gradients
   within OPS_TOL of float64 on the CPU, a TrainStep step over it with no
   host synchronisation.  bench/neural_style.py on the card: the loss after
   STYLE_STEPS steps below the first;
4k. image (after custom): the image slice.  IMAGE_RECORDS synthetic
   256x341 images (labels from IMAGE_LABELS of the 1000 classes) packed as
   pass-through records with an .idx in a temporary directory.  (a)
   ``ImageRecordIter`` alone with train_imagenet.py's settings (batch 32,
   3x224x224, shuffle, rand_crop, rand_mirror, resize=-1, IMAGE_THREADS
   decode threads): img/s in float32 (the example's means) and uint8.  (b)
   ResNet-50 v2 (1000 classes) through the fused ``Module.fit`` from those
   records with MXNET_NORM_CONV=1, then 0, and over a synthetic
   ``NDArrayIter`` of as many batches: img/s and host ms a batch (epoch 0),
   the fit loop's ``data_wait`` ms a batch (telemetry in memory,
   MXNET_TELEMETRY_FUSED=1), the busy share of a torch.profiler window over
   epoch 1, peak memory, 52 NormConv launches a step (32 with statistics;
   0 with the knob off), the loss from records finite and falling; the
   knob-on fits from records and synthetic in turns.  (c) At one decode
   thread, MXNET_NORM_CONV=0 and cuDNN deterministic, the fit from records
   equal bit for bit to an ``NDArrayIter`` fit of the batches the iterator
   yielded.
   (d) ``dtype="uint8"`` feeding ResNet-50 on a Cast-to-float32 + affine
   prologue: every batch staged as uint8 on the card, finite losses, 52
   launches a step.  (e) Where PIL imports, the same images as JPEG
   records through the fit at the example's resize (256).  (f) The MLP of
   ``custom`` as a two-stage ``SequentialModule`` and with a
   ``PythonLossModule`` head, each within RESNET_FLOOR_X times its float32
   floor of one ``Module``.  (g) ``test_utils.check_consistency`` over
   [cpu(0), gpu(0)] on a Convolution -> BatchNorm -> Activation block;
4l. capi (after image): the inference extras.  (a) ResNet-50 v2 (1000
   classes, 3x224x224, batch 8, seed-0 weights as ``.params`` bytes)
   through the C predict API (``MXPredCreate``/``SetInput``/``Forward``/
   ``GetOutput``/``Free`` by ctypes on dev_type 2) with MXNET_NORM_CONV=1:
   52 launches a forward, the rows within SERVE_TOL x max_prob of the
   unfused ``Predictor``, every argmax agreeing; the forward through C
   and through ``Predictor`` timed in turns; ``MXPredCreatePartialOut``
   to CAPI_PARTIAL_OUTPUT with the ``MXPredPartialForward`` loop, equal
   bit for bit to ``Predictor(output_names=...)`` (cuDNN deterministic);
   an output copied to ``cpu_pinned()`` is page-locked and equal.  (b)
   Three SGD-momentum steps at batch 32 through the C executor
   (``MXExecutorBindEX``, ``Forward(1)``, ``Backward``,
   ``MXImperativeInvoke("sgd_mom_update")`` a parameter, as the
   cpp-package's ``SGDOptimizer``): 52 launches a step, 32 with
   statistics, every parameter and moving statistic within
   RESNET_FLOOR_X times its float32 floor of the same steps driven from
   Python (the floor: those steps from CAPI_FLOOR_SAMPLES nudges).  (c)
   ResNet-50 behind the HTTP front end (``default_server()``,
   ``start_server(port=0)``): 4 clients post 2 JSON requests each to
   ``/predict/resnet50``, the rows within SERVE_TOL x max_prob of the
   in-process ``ServedModel``'s, ``/healthz`` and ``/models`` 200, qps
   and p50/p99 beside the serving phase's, the JSON cost of one image.
   (d) The cpp-package's mlp_predict and lenet_train run on the box's
   CPU against the library: FEATURES OK with the ``Predictor``'s argmax
   rows, and PASS;
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
11. parallel: the single-process parallel slice.  (a) BASELINE #5, the
   model-parallel LSTM of ``bench/model_parallel_lstm.py`` at the widths
   of MXNet's ``lstm_ptb.py`` (8 LSTM layers of 400, an embedding of 200,
   seq_len 35, batch 20, 10,000 words; a synthetic corpus, no dropout) on
   the reference's ngpu = 1 plan (every group on gpu(0)): no placed walk
   and 0 cross-device copies, one step bitwise equal to the unplaced
   bind's (or, on leaves where two unplaced steps differ, within the
   rule below) and within RESNET_FLOOR_X times its float32 floor of the
   float64 step on the CPU, no host sync in a step
   (``set_sync_debug_mode``), tokens/s, host ms a batch and the
   device-busy share beside the unplaced bind, twice in turns.  (b) The
   ngpu = 2 plan over [gpu(0), cpu()] (embed and layers 0-3 on the card,
   layers 4-7 and decode on the host): ``executor.cross_device_copies``
   of a forward and of a step equal to the count the group boundaries
   imply, one step within the floor rule of the float64 step and within
   twice it of (a)'s, a few batches with the perplexity falling,
   tokens/s.  (c) ``Module.fit`` over two contexts with a store: LeNet
   over [gpu(0), cpu()] with kvstore "local" (accuracy rising over two
   epochs) and ResNet-50 at full width over [gpu(0), gpu(0)] with
   "device", batch 32, img/s beside the one-context general path
   (MXNET_FUSED_FIT=0); one step of each (ResNet-50 at batch 8, two
   slices of 4) within the floor rule of the float64 two-context step
   over [cpu(0), cpu(1)] (gradients summed over the devices, updates,
   each device's moving statistics).
12. dist: the distributed slice's first part.  (a) Two ranks on the one
   card through the port's launcher (``python -m mxnet_tpu_torch.launch
   -n 2``), ``bench/dist_sync_kvstore.py`` on CUDA tensors: the dist_sync
   arithmetic exact (a 2x2 and a 1200x1200 key, the replace semantics),
   ``allreduce_arrays`` over three dtypes, the store's calls; the route
   (``gloo-cuda``: the ranks share the card) printed.  (b) ResNet-50 v2
   at full width from the seed-0 state through ``Module.fit(kvstore=
   "dist_sync")`` on two ranks (``bench/dist_mlp.py``), DIST_BATCH images
   a rank a batch, DIST_BATCHES batches, MXNET_NORM_CONV=1, TF32 off: 52
   NormConv launches a step on each rank, 32 with statistics; the ranks'
   parameters bitwise equal; every parameter and rank 0's moving
   statistics within RESNET_FLOOR_X times their float32 floor of the
   same fit in this process over [gpu(0), gpu(0)] with the ``device``
   store (context k takes rank k's rows; the floor: that fit from the
   state nudged by RESNET_FLOOR_NUDGE); img/s over both ranks, host ms a
   batch and the collectives' ms a batch (in the fit, and one batch's 161
   pushes alone) beside the one-process fit's.  (c) ``dist.
   bucket_allreduce`` at world 1 over NCCL on the card (a float32 bucket
   of ResNet-50's size and a float64 one): output equal to input, timed.
   (d) ResNet-50 fused through ``parallel.elastic.fit_elastic`` at batch
   ELASTIC_BATCH, MXNET_NORM_CONV=1, MXNET_CKPT_EVERY_N_STEPS=
   ELASTIC_EVERY: ELASTIC_BATCHES steps uninterrupted, the same without
   checkpoints, and a run whose data stop after ELASTIC_EVERY steps,
   resumed by a fresh Module from the step checkpoint: the restored state
   (parameters, momenta, moving statistics, update count) bitwise the
   saved one, the resumed run's end within RESNET_FLOOR_X times the float32
   floor of the uninterrupted run's (the floor: the same fit from the
   nudged state); under MXNET_AMP=1 the loss-scale state restored
   bitwise; the checkpoint's bytes, the ms the fit blocks in ``save``, the
   writer thread's ms, a step's ms with and without checkpoints.
13. zero: the mesh and ZeRO part of the distributed slice.  Two ranks
   sharing the card through the launcher run ``bench/zero_ladder.py``:
   ResNet-50 v2 at full width (1000 classes, 3x224x224) from the seed-0
   state, ``TrainStep`` over a dp=2 mesh of the ranks, ZERO_BATCH images
   a rank, float32, TF32 off, MXNET_NORM_CONV=1, SGD with momentum, ZeRO
   levels 0-3 ZERO_STEPS steps each on the same batches.  (a) Levels 1-3's
   logical parameters within RESNET_FLOOR_X times their float32 floor of
   level 0's (the floor: the largest distance of ZERO_FLOOR_SAMPLES runs
   of level 0 from the state nudged by RESNET_FLOOR_NUDGE); the
   replicated leaves bitwise equal across the ranks; by the same rule,
   level 0 with ``remat=True`` (the recompute on autograd's device thread
   takes the global batch's statistics: more ``stats`` collectives a step
   than without) and one process's ``TrainStep`` without a mesh over the
   whole global batch of 2 x ZERO_BATCH rows, which holds the peephole's
   statistics summed across the ranks to the kernel's over the whole
   batch.  (b) For each rank and level the plan's param, grad and
   optimizer bytes (``TrainStep.zero_bytes``) and the bytes the card
   holds (``torch.cuda.memory_allocated``: the placed state, the reduced
   gradients at the update): level 3 about 1/dp of level 0 for each, as
   in MULTICHIP_ZERO_r01.json's ladder.  (c) 52 NormConv launches a step
   on each rank, 32 with statistics.  (d) The collectives a step by kind,
   counts and MB (``dist.collective_calls`` / ``_bytes``): an all-reduce
   at levels 0-1, a reduce-scatter at 2-3, an all-gather at 1-3, and
   BatchNorm's statistics.  (e) ``Policy("bfloat16")`` at level 3, a batch
   with an inf in rank 0's rows: every rank skips (masters, optimizer
   rows, moving statistics bitwise unchanged), the scale halves, one
   overflow counts, a clean step moves the masters.  (f) ``Module.fit``
   under MXNET_ZERO=2 through ``parallel.elastic.fit_elastic``, a step
   checkpoint every 2 steps with its ZeRO rows, stopped after 2 steps and
   resumed: the restored state bitwise the saved one.  Img/s and update ms
   a level.

Prints the card's name and power limit, whether ml_dtypes imports,
per-geometry numbers, serving qps and latency, the ResNet-50 training
checks, rates and profiles (unfused and fused, float32 and bfloat16 AMP),
the NormConv launches of serving and of fused training, flash timings, LM
checks and profiles, flash backward timings, LM training checks, rates and
profiles (float32 and AMP), the Module layer's checks and timings, the
sequences slice's and the SSD slice's checks, times and rates, the
operators phase's checks and rates, the rcnn phase's checks and times,
the observability phase's host split, MFU, profile ranges and checks,
Updater and Rtc numbers, the parallel slice's checks, copies and rates,
the capi phase's build, checks, C and HTTP times, the dist phase's route,
checks, rates and checkpoint times, the zero phase's checks, bytes,
collectives and rates, each phase's seconds, a
JSON
line of kernel numbers (rows 1-4 with a "bf16_train" entry: the
bfloat16 kernel at the training shapes and its launches in the AMP steps;
row 1 with an "inception_v3_train" entry: the kernel at Inception-v3's
geometries, batch 32, and its launches in the imagenet phase, and its
launches in the image, capi, dist and zero phases;
row 6 the NMS kernel, which replaces an XLA loop, not a Pallas kernel,
with a "proposal_frcnn" entry: the kernels at Proposal's 6,000 rows),
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

ROOT = os.path.dirname(os.path.abspath(__file__))

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
# parallel: (a) BASELINE #5 at the widths of MXNet's
# example/model-parallel-lstm/lstm_ptb.py through
# bench/model_parallel_lstm.py (its loop: SGD at MP_LR, rescale 1 / (batch
# x seq_len), its Zipf corpus), one step from SEED's state on the one-card
# plan against the unplaced bind (bitwise) and, with (b) the two-device
# plan over [gpu(0), cpu()], within RESNET_FLOOR_X times each leaf's
# float32 floor (RESNET_FLOOR_SAMPLES float32 CPU steps from the state and
# nudges of it) of the float64 step on the CPU; MP_BATCHES batches timed
# (the first MP_WARMUP untimed), twice in turns with the unplaced bind;
# MP_TWO_BATCHES batches of the two-device plan, the perplexity over
# windows of MP_WINDOW batches.  (c) Module over two contexts with a store:
# LeNet (BASELINE #1, MNIST's shape, synthetic digits) over [gpu(0),
# cpu()] with "local", LENET_EPOCHS epochs of LENET_BATCHES batches of
# LENET_BATCH; ResNet-50 (BASELINE #2) over [gpu(0), gpu(0)] with
# "device", DP_RESNET_BATCHES batches of DP_RESNET_BATCH timed beside the
# one-context general path; one step each (ResNet-50 at
# DP_RESNET_CHECK_BATCH) within the floor rule of the float64 two-context
# step over [cpu(0), cpu(1)].
MP_WIDTHS = dict(num_layers=8, num_hidden=400, num_embed=200, seq_len=35,
                 batch_size=20, vocab_size=10000)
MP_LR = 0.2
MP_BATCHES = 10
MP_WARMUP = 2
MP_TWO_BATCHES = 8
MP_WINDOW = 4
LENET_BATCH = 64
LENET_BATCHES = 8
LENET_EPOCHS = 2
LENET_LR = 0.1
DP_RESNET_BATCH = 32
DP_RESNET_BATCHES = 6
DP_RESNET_CHECK_BATCH = 8
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
# the observability phase: ResNet-50 batch OBS_BATCH through Module.fit;
# the general path's host split over OBS_BATCHES batches, the fused path
# with the MFU gauges over OBS_FUSED_BATCHES, the profiler over
# OBS_PROFILED, Monitor(2) over OBS_MONITOR_BATCHES; the fused Monitor's
# rows within OBS_MONITOR_TOL (relative) of |w|/sqrt(size) in float64 (a
# float32 sum of squares of up to 2.4M terms on the card)
OBS_BATCH = 32
OBS_BATCHES = 6
OBS_FUSED_BATCHES = 4
OBS_PROFILED = 2
OBS_MONITOR_BATCHES = 4
OBS_MONITOR_TOL = 1e-5
OBS_SPANS = ("data_wait", "forward", "backward", "update", "metric", "step")
OBS_INNER = ("exec_group.load_data", "executor.forward", "executor.backward")
# every observability knob the port reads, unset for (e)
OBS_KNOBS = ("MXNET_TELEMETRY", "MXNET_TELEMETRY_FUSED",
             "MXNET_FLIGHT_RECORDER", "MXNET_PROFILER_AUTOSTART",
             "MXNET_ENGINE_TYPE", "MXNET_OPT_STATS", "MXNET_PEAK_FLOPS",
             "MXNET_PEAK_BW")
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
                  rounds=NMS_TIMING_ROUNDS, lib=None, force_suppress=False):
    """(mask ms, scan ms, both ms) of the NMS kernels on ``boxes`` and
    ``ids``: raw launches of ``contrib.nms_launch`` (every band of
    ``nms_plan``) through ``queued_ms``, the ids restored from ``ids``
    before each round (the copy not counted); once with an event recorded
    after each launch (by the launch check), which times the kernels one by
    one, then all of them between one pair of events (each event pair adds
    a few microseconds of its own); ``lib`` another library of the same
    launchers (default: the committed one); ``force_suppress`` as the
    caller's."""
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
        contrib.nms_launch(lib, boxes, out, threshold, force_suppress,
                           stream=stream, check=marked)

    def both():
        contrib.nms_launch(lib, boxes, out, threshold, force_suppress,
                           stream=stream, check=check)
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
    net = mt.models.resnet.get_symbol(CLASSES, 50, "3,%d,%d" % (IMAGE, IMAGE))
    return norm_conv_geometries(net, (batch, 3, IMAGE, IMAGE))


def norm_conv_geometries(net, data_shape):
    """({(H, W, Cin, Cout, k, s, p): count} of the convolutions the NormConv
    peephole fuses in ``net`` at ``data_shape``, {the same key: count of
    those that emit statistics in training})."""
    from mxnet_tpu_torch.executor import _Lowered
    low = _Lowered(net)
    internals = net.get_internals()
    _, shapes, _ = internals.infer_shape(data=data_shape)
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
                       batches=(RESNET_CHECK_BATCH, RESNET_TRAIN_BATCH),
                       label="geom_train"):
    """The kernel at the training step's geometries in ``dt`` (float32 by
    default), TF32 off: at each of ``batches``, every geometry with the
    statistics epilogue on, y and both sums against the plain version in
    the same dtype and y bitwise over two launches; at RESNET_TRAIN_BATCH
    the kernel (with the statistics where the training graph has them),
    the plain version and cuDNN's conv in the same dtype timed beside the
    bound (``dt``'s bytes and peak).  Returns the totals of one
    batch-RESNET_TRAIN_BATCH training step's forward (RESNET_NC_PER_STEP
    launches for ResNet-50's ``geoms``); each line starts with
    ``label``."""
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
            line = ("%s dtype=%s batch=%d H=%d W=%d Cin=%d Cout=%d "
                    "k=%d s=%d p=%d count=%d stats_count=%d max_abs_err=%r "
                    "stats_rel_err=%r tile=%dx%d splits=%d"
                    % (label, dname, batch, h, w, cin, cout, k, s, p, count,
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
    numbers = {"launches": launches, "qps": n_req / wall,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99))}
    print("serving qps=%r p50_ms=%r p99_ms=%r (%d requests, %d clients, "
          "closed loop, after warm)"
          % (numbers["qps"], numbers["p50_ms"], numbers["p99_ms"], n_req,
             CLIENTS))
    forward_breakdown(torch, mt, net, blob, images[:BATCH])
    return numbers


def resnet50_state(mt, net, batch, image=IMAGE):
    """Seed-SEED parameters (the TrainStep initializer on the host), zero
    momenta, moving statistics and a batch (3 x ``image`` x ``image``), as
    float64 numpy."""
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=RESNET_LR,
                                            momentum=0.9), ctx=mt.cpu())
    p, s, a = ts.init({"data": (batch, 3, image, image)},
                      {"softmax_label": (batch,)}, seed=SEED)
    rng = np.random.default_rng(SEED + 5)
    aux = {n: v.double().numpy() + rng.uniform(-0.1, 0.1, v.shape)
           for n, v in a.items()}
    data = {"data": rng.uniform(-1, 1, (batch, 3, image, image)),
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
    counted = {"norm_conv": 0, "norm_conv_stats": 0, "norm_conv_bf16": 0,
               "fit_img_s": 1e3 * b / median(fit_runs)}
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


# ------------------------------------------------ operators (the slice)
# operators: (a) each of the 20 ops of the operator surface's first part
# (OPERATOR_NAMES) at small shapes on the card, forward and backward,
# float32 (TF32 off) against the same op in float64 on the host from the
# same inputs: every output and input gradient within OPS_TOL of its
# largest entry, the indices of topk/argsort and the one-hot rows equal;
# rrelu in training by its slopes' bounds and mean.  (b) AlexNet
# (models/alexnet.py; train_imagenet.py --network alexnet's defaults: 1000
# classes, 3x224x224, batch ALEX_BATCH) through Module.fit, fused then
# general; one SGD-momentum TrainStep step at ALEX_CHECK_BATCH within
# RESNET_FLOOR_X times its float32 floor of the float64 CPU step, under
# MXNET_CONV_LAYOUT NHWC and NCHW, the Dropout masks injected
# (ops.nn.dropout_mask); (c) DCGAN through bench/dcgan.py at the example's
# defaults, and one iteration within the floor rule of the float64 one.
OPERATOR_NAMES = (
    "LeakyReLU", "Deconvolution", "InstanceNorm", "L2Normalization", "LRN",
    "UpSampling", "softmax", "log_softmax", "topk", "sort", "argsort",
    "choose_element_0index", "fill_element_0index", "_broadcast",
    "_onehot_encode", "IdentityAttachKLSparseReg", "_slice_assign",
    "_crop_assign", "_crop_assign_scalar", "Convolution_v1")
OPS_TOL = 1e-4
RRELU_DRAWS = 1 << 20
ALEX_BATCH = 32
ALEX_FUSED_BATCHES = 6
ALEX_GENERAL_BATCHES = 3
ALEX_CHECK_BATCH = 4
ALEX_PROFILED = 3
ALEX_LR = 0.01
GAN_ITERS = 10
GAN_BATCH = 32
GAN_CODE = 64


def operator_cases():
    """(op, attrs, float64 inputs, the inputs to differentiate, is_train)
    for the 20 ops, from a seed: ties on a grid of halves for the ordering
    ops, exact zeros at LeakyReLU's kink, indices in and out of range."""
    rng = np.random.default_rng(SEED + 20)
    r = rng.standard_normal

    def kink(*s):
        x = r(s)
        x.flat[::4] = 0.0
        return x

    def ties(*s):
        return np.round(r(s) * 2) / 2

    idx = rng.integers(-120, 120, 64).astype(np.float64)
    x4 = (8, 16, 12, 12)
    return [
        ("LeakyReLU", {"act_type": "leaky", "slope": 0.2}, [kink(*x4)],
         (0,), False),
        ("LeakyReLU", {"act_type": "elu", "slope": 0.3}, [kink(*x4)], (0,),
         False),
        ("LeakyReLU", {"act_type": "prelu"}, [kink(*x4), r(16)], (0, 1),
         False),
        ("LeakyReLU", {"act_type": "rrelu"}, [kink(*x4)], (0,), False),
        ("Deconvolution", {"kernel": (4, 4), "stride": (2, 2),
                           "pad": (1, 1), "num_filter": 64},
         [r((8, 128, 8, 8)), r((128, 64, 4, 4)) * 0.05], (0, 1), False),
        ("Deconvolution", {"kernel": (3, 3), "stride": (2, 2),
                           "pad": (1, 1), "adj": (2, 2), "num_filter": 8,
                           "no_bias": False},
         [r((4, 16, 7, 7)), r((16, 8, 3, 3)) * 0.1, r(8)], (0, 1, 2), False),
        ("Deconvolution", {"kernel": (3, 3), "stride": (2, 2),
                           "target_shape": (16, 16), "num_filter": 8,
                           "num_group": 2},
         [r((4, 16, 8, 8)), r((16, 4, 3, 3)) * 0.1], (0, 1), False),
        ("InstanceNorm", {}, [r(x4), r(16), r(16)], (0, 1, 2), False),
        ("L2Normalization", {}, [r(x4)], (0,), False),
        ("L2Normalization", {"mode": "channel"}, [r(x4)], (0,), False),
        ("L2Normalization", {"mode": "spatial"}, [r(x4)], (0,), False),
        ("LRN", {"nsize": 5, "alpha": 1e-2}, [r((8, 96, 14, 14))], (0,),
         False),
        ("LRN", {"nsize": 5, "alpha": 1e-2, "layout": "NHWC"},
         [r((8, 14, 14, 96))], (0,), False),
        ("UpSampling", {"scale": 2, "num_args": 1}, [r(x4)], (0,), False),
        ("UpSampling", {"scale": 2, "sample_type": "bilinear",
                        "num_args": 1}, [r(x4)], (0,), False),
        ("UpSampling", {"scale": 2, "num_args": 2},
         [r((4, 8, 12, 12)), r((4, 8, 6, 6))], (0, 1), False),
        ("UpSampling", {"scale": 2, "num_args": 2,
                        "multi_input_mode": "sum"},
         [r((4, 8, 12, 12)), r((4, 8, 6, 6))], (0, 1), False),
        ("softmax", {"axis": 1, "temperature": 2.0}, [r((64, 1000))], (0,),
         False),
        ("softmax", {"temperature": 0.0}, [r((64, 1000))], (0,), False),
        ("log_softmax", {}, [r((64, 1000))], (0,), False),
        ("topk", {"k": 5, "ret_typ": "both"}, [ties(64, 1000)], (0,),
         False),
        ("topk", {"k": 3, "axis": 0, "is_ascend": True}, [ties(50, 20)],
         (0,), False),
        ("sort", {"is_ascend": False}, [ties(64, 1000)], (0,), False),
        ("argsort", {"axis": 0}, [ties(50, 20)], (0,), False),
        ("choose_element_0index", {}, [r((64, 100)), idx], (0,), False),
        ("fill_element_0index", {}, [r((64, 100)), r(64), idx], (0, 1),
         False),
        ("_broadcast", {"axis": 1, "size": 64}, [r((32, 1, 16))], (0,),
         False),
        ("_onehot_encode", {}, [idx, np.zeros((64, 100))], (), False),
        ("IdentityAttachKLSparseReg", {"sparseness_target": 0.1,
                                       "penalty": 0.01},
         [rng.uniform(0.1, 0.9, (64, 128)), rng.uniform(0.2, 0.7, 128)],
         (0,), True),
        ("_slice_assign", {"begin": (2, 3), "end": (10, 40)},
         [r((16, 64)), r((8, 37))], (0, 1), False),
        ("_crop_assign", {"begin": (0, 10), "end": (16, 12)},
         [r((16, 64)), r((16, 2))], (0, 1), False),
        ("_crop_assign_scalar", {"begin": (1, 0), "end": (9, 20),
                                 "scalar": 3.5}, [r((16, 64))], (0,), False),
        ("Convolution_v1", {"kernel": (3, 3), "num_filter": 32,
                            "pad": (1, 1)},
         [r(x4), r((32, 16, 3, 3)) * 0.1, r(32)], (0, 1, 2), False)]


def operator_leaves(torch, mt, case, dev, dtype):
    """{output k / gradient of input i: float64 CPU tensor} of one case at
    ``dtype`` on ``dev``; the cotangents from a seed."""
    name, attrs, arrays, diff, is_train = case
    ins = [torch.tensor(a, dtype=dtype, device=dev, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    outs, op = mt.ops.registry.imperative_invoke(name, ins, attrs,
                                                 is_train=is_train)
    leaves = {"out%d" % i: o.detach() for i, o in enumerate(outs)}
    n_vis = op.num_outputs_for(op.normalize_attrs(attrs))
    heads = [o for o in outs[:n_vis] if o.requires_grad]
    if heads:
        g = np.random.default_rng(SEED + 21)
        cots = [torch.tensor(g.standard_normal(tuple(h.shape)), dtype=dtype,
                             device=dev) for h in heads]
        grads = torch.autograd.grad(heads, [ins[i] for i in diff], cots,
                                    allow_unused=True)
        leaves.update(("d%d" % i, gr.detach())
                      for i, gr in zip(diff, grads) if gr is not None)
    return {k: v.double().cpu() for k, v in leaves.items()}


def operators_ops_check(torch, mt):
    """(a): the 20 ops on the card against float64 on the host; rrelu's
    training draws.  Returns {op: worst relative error}."""
    cases = operator_cases()
    if sorted({c[0] for c in cases}) != sorted(OPERATOR_NAMES):
        fail("operators: the cases cover %s" % sorted({c[0] for c in cases}))
    worst = {}
    for case in cases:
        name, attrs = case[:2]
        got = operator_leaves(torch, mt, case, mt.gpu(0).torch_device(),
                              torch.float32)
        want = operator_leaves(torch, mt, case, "cpu", torch.float64)
        if sorted(got) != sorted(want):
            fail("operators: %s %r gives %s on the card, %s on the host"
                 % (name, attrs, sorted(got), sorted(want)))
        exact = name in ("argsort", "_onehot_encode") or (
            name == "topk" and attrs.get("ret_typ") != "value")
        for k, w in want.items():
            a = got[k]
            if a.shape != w.shape or not torch.equal(a.isnan(), w.isnan()):
                fail("operators: %s %r %s: shape or NaN positions differ"
                     % (name, attrs, k))
            a, w = a.nan_to_num(), w.nan_to_num()
            index_out = exact and (k == "out0" if attrs.get("ret_typ")
                                   != "both" else k == "out1")
            if index_out and not torch.equal(a, w):
                fail("operators: %s %r %s: the indices differ in %d entries"
                     % (name, attrs, k, int((a != w).sum())))
            err = ((a - w).abs().max()
                   / w.abs().max().clamp_min(1e-30)).item() if w.numel() \
                else 0.0
            if err > OPS_TOL:
                fail("operators: %s %r %s at %.3g of its largest entry "
                     "from float64 (tol %g)" % (name, attrs, k, err,
                                                OPS_TOL))
            worst[name] = max(worst.get(name, 0.0), err)
    for name in OPERATOR_NAMES:
        print("operators op %s worst_rel_err=%r" % (name, worst[name]))
    lo, hi = 0.125, 0.334
    x = -torch.ones(RRELU_DRAWS, device=mt.gpu(0).torch_device())
    (y,), _ = mt.ops.registry.imperative_invoke(
        "LeakyReLU", [x], {"act_type": "rrelu", "lower_bound": lo,
                           "upper_bound": hi}, is_train=True)
    s = -y
    sd = (hi - lo) / 12 ** 0.5 / RRELU_DRAWS ** 0.5
    mean = s.mean().item()
    if s.min().item() < lo or s.max().item() >= hi \
            or abs(mean - (lo + hi) / 2) > 5 * sd:
        fail("operators: rrelu slopes in [%r, %r], mean %r (bounds %r, %r)"
             % (s.min().item(), s.max().item(), mean, lo, hi))
    print("operators rrelu training draws=%d slopes in [%r, %r] mean=%r "
          "(midpoint %r, 5 sd %r)" % (RRELU_DRAWS, s.min().item(),
                                      s.max().item(), mean, (lo + hi) / 2,
                                      5 * sd))
    print("operators ops checked=%d cases=%d worst_rel_err=%r (tol %g, "
          "card float32 vs host float64)"
          % (len(worst), len(cases), max(worst.values()), OPS_TOL))
    return worst


def inject_masks(torch, masks):
    """Dropout draws ``masks`` (numpy, in graph order, cyclically) on any
    device; returns the patch's undo."""
    from mxnet_tpu_torch.ops import nn as pnn
    real, turn = pnn.dropout_mask, [0]

    def given(shape, keep, rng, device):
        m = masks[turn[0] % len(masks)]
        turn[0] += 1
        if tuple(m.shape) != tuple(shape):
            fail("operators: a Dropout of %r, the mask is %r"
                 % (tuple(shape), m.shape))
        return torch.from_numpy(m).to(device)
    pnn.dropout_mask = given

    def undo():
        pnn.dropout_mask = real
    return undo


def alexnet_step(torch, mt, net, params, data, masks, ctx, dtype,
                 lr=ALEX_LR, batch=ALEX_CHECK_BATCH):
    """One SGD-momentum TrainStep step (learning rate ``lr``, gradients
    over ``batch``) from ``params`` on ``data`` at ``dtype`` on ``ctx``,
    Dropout taking ``masks``: (first momenta, updates) as float64 CPU
    tensors."""
    undo = inject_masks(torch, masks)
    try:
        ts = mt.TrainStep(net, mt.optimizer.SGD(
            learning_rate=lr, momentum=0.9, wd=5e-4,
            rescale_grad=1.0 / batch), ctx=ctx)
        p, s, a = mt.convert.train_state_from_numpy(
            {n: v.astype(dtype) for n, v in params.items()},
            {n: (np.zeros_like(v, dtype),) for n, v in params.items()}, {},
            ctx=ctx)
        before = {n: v.double().cpu().clone() for n, v in p.items()}
        p, s, a, _ = ts(p, s, a, ts.shard_batch(
            {k: v.astype(dtype) for k, v in data.items()}))
    finally:
        undo()
    return ({n: st[0].double().cpu() for n, st in s.items()},
            {n: v.double().cpu() - before[n] for n, v in p.items()})


def alexnet_step_check(torch, mt, net):
    """(b)'s step: float32 on the card under each layout against float64
    on the host; floors from float32 host steps from the state and nudges."""
    b = ALEX_CHECK_BATCH
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p0, _, _ = ts0.init({"data": (b, 3, IMAGE, IMAGE)},
                        {"softmax_label": (b,)},
                        initializer=mt.initializer.Xavier(magnitude=2.0),
                        seed=SEED)
    params = {n: v.numpy() for n, v in p0.items()}
    rng = np.random.default_rng(SEED + 22)
    data = {"data": rng.uniform(-1, 1, (b, 3, IMAGE, IMAGE)),
            "softmax_label": rng.integers(0, CLASSES, b).astype(np.float64)}
    masks = [rng.random((b, 4096)) < 0.5 for _ in range(2)]
    t0 = time.perf_counter()
    want = alexnet_step(torch, mt, net, params, data, masks, mt.cpu(),
                        np.float64)
    floors = []
    for i in range(RESNET_FLOOR_SAMPLES):
        p = nudged_values(params, SEED + 120 + i) if i else params
        x = nudged_values(data, SEED + 220 + i, skip=("softmax_label",)) \
            if i else data
        floors.append(alexnet_step(torch, mt, net, p, x, masks, mt.cpu(),
                                   np.float32))
    print("alexnet_train steps=cpu_f64+%d cpu_f32 batch=%d seconds=%r"
          % (RESNET_FLOOR_SAMPLES, b, time.perf_counter() - t0))
    for layout in ("NHWC", "NCHW"):
        got = module_env({"MXNET_CONV_LAYOUT": layout}, lambda: alexnet_step(
            torch, mt, net, params, data, masks, mt.gpu(0), np.float32))
        resnet50_check_rows(torch, "alexnet_train %s" % layout,
                            resnet50_leaf_rows(torch, got, want, floors,
                                               kinds=("grad", "update")),
                            "float32 floor")


def alexnet_fit(torch, mt, net, args, x, y, env):
    """Module.fit on gpu(0) for one epoch over (x, y) under ``env``:
    (img/s from the card's end of the first batch to its end of the last,
    host ms a batch (median gap between batch ends), fused path taken).
    The epoch's end (the fused path's copy of the parameters back to the
    host) is outside the rate."""
    b = ALEX_BATCH
    n = len(x) // b
    mod = mt.Module(net, context=mt.gpu(0))
    ends = []

    def batch_end(param):
        if param.nbatch in (0, n - 1):
            torch.cuda.synchronize()
        ends.append(time.perf_counter())
    module_env(env, lambda: mod.fit(
        mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=1,
        optimizer="sgd", arg_params=args,
        optimizer_params=dict(learning_rate=ALEX_LR, momentum=0.9,
                              wd=5e-4), batch_end_callback=batch_end))
    if len(ends) != n:
        fail("alexnet: %d batch ends in a fit of %d batches" % (len(ends), n))
    gaps = [(t1 - t0) * 1e3 for t0, t1 in zip(ends, ends[1:])]
    return ((n - 1) * b / (ends[-1] - ends[0]), obs_median(gaps),
            mod._fused_ts_cache is not None)


def busy_steps(torch, fn, reps):
    """(device ms, wall ms, launches) a call of ``fn`` over ``reps`` calls
    inside one torch.profiler context, the wall clock started and stopped
    inside it (the profiler's start and stop outside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if is_kernel(e, DeviceType)]
    return (sum(e.self_device_time_total for e in kernels) * 1e-3 / reps,
            wall * 1e3 / reps, sum(e.count for e in kernels) // reps)


def lrn_step_ms(torch, mt):
    """Device ms of AlexNet's two LRNs, forward and backward, at the
    batch-ALEX_BATCH step's shapes channel-last (the executor's layout),
    timed alone by CUDA events."""
    op = mt.ops.registry.get_op("LRN")
    call = op.make_callable(op.normalize_attrs(
        {"alpha": 0.0001, "beta": 0.75, "knorm": 2, "nsize": 5,
         "layout": "NHWC"}), True)
    ins = [torch.randn(ALEX_BATCH, h, h, c, device=mt.gpu(0).torch_device(),
                       requires_grad=True) for h, c in ((54, 96), (26, 256))]
    gs = [torch.randn_like(x) for x in ins]

    def both():
        for x, g in zip(ins, gs):
            torch.autograd.backward(call(x), g)
    return time_ms(torch, both, iters=10)


def alexnet_phase(torch, mt, card):
    """(b): AlexNet at train_imagenet.py's defaults."""
    net = mt.models.alexnet.get_symbol(num_classes=CLASSES)
    alexnet_step_check(torch, mt, net)
    b = ALEX_BATCH
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p0, _, _ = ts0.init({"data": (b, 3, IMAGE, IMAGE)},
                        {"softmax_label": (b,)},
                        initializer=mt.initializer.Xavier(magnitude=2.0),
                        seed=SEED)
    args = {n: mt.nd.array(v.numpy(), ctx=mt.cpu()) for n, v in p0.items()}
    n_params = sum(int(v.size) for v in args.values())
    rng = np.random.default_rng(SEED + 23)
    x = rng.uniform(-1, 1, (ALEX_FUSED_BATCHES * b, 3, IMAGE, IMAGE)) \
        .astype(np.float32)
    y = rng.integers(0, CLASSES, ALEX_FUSED_BATCHES * b).astype(np.float32)
    fused = alexnet_fit(torch, mt, net, args, x, y, {})
    nb = ALEX_GENERAL_BATCHES * b
    general = alexnet_fit(torch, mt, net, args, x[:nb], y[:nb],
                          {"MXNET_FUSED_FIT": "0"})
    if not fused[2] or general[2]:
        fail("alexnet: fused path taken %r (fused) %r (general)"
             % (fused[2], general[2]))
    # the fused step (one TrainStep call on a device batch) profiled: the
    # card's busy share of its wall time
    ts = mt.TrainStep(net, mt.optimizer.SGD(learning_rate=ALEX_LR,
                                            momentum=0.9), ctx=mt.gpu(0))
    p, s, a = ts.init({"data": (b, 3, IMAGE, IMAGE)},
                      {"softmax_label": (b,)}, seed=SEED)
    batch = ts.shard_batch({"data": x[:b], "softmax_label": y[:b]})
    for _ in range(2):
        ts(p, s, a, batch)
    dev_ms, wall_ms, launches = busy_steps(
        torch, lambda: ts(p, s, a, batch), ALEX_PROFILED)
    lrn_ms = lrn_step_ms(torch, mt)
    print("alexnet params=%d fit img_per_s batch=%d fused=%r (host %r ms a "
          "batch, %d batches) general=%r (host %r ms a batch, %d batches); "
          "fused step profiled (%d steps): device_ms=%r wall_ms=%r "
          "device_busy_share=%r launches=%d; LRN forward+backward (both "
          "layers, alone, channel-last) device_ms=%r, %r of the step's "
          "device ms (%s)"
          % (n_params, b, fused[0], fused[1], ALEX_FUSED_BATCHES,
             general[0], general[1], ALEX_GENERAL_BATCHES, ALEX_PROFILED,
             dev_ms, wall_ms, dev_ms / wall_ms, launches, lrn_ms,
             lrn_ms / dev_ms, card))
    return {"fused_img_s": fused[0], "general_img_s": general[0]}


def gan_leaves(mods, names):
    """The parameters and moving statistics named ``names`` of both
    networks, read off the executors, as float64 CPU tensors."""
    out = {}
    for m in mods:
        ex = m._exec_group.execs[0]
        for n, v in list(ex.arg_dict.items()) + list(ex.aux_dict.items()):
            if n in names:
                out[n] = v.value.detach().double().cpu()
    return out


def dcgan_phase(torch, mt, card):
    """(c): DCGAN through bench/dcgan.py at the example's defaults."""
    from mxnet_tpu_torch.bench import dcgan
    g0, d0, _ = dcgan.train(epochs=0, batch=GAN_BATCH, steps_per_epoch=0,
                            code_dim=GAN_CODE, ctx=mt.cpu())
    params = {}
    for m in (g0, d0):
        arg, aux = m.get_params()
        params.update({n: v.asnumpy() for n, v in
                       list(arg.items()) + list(aux.items())})

    def one(ctx, p, dtype="float32"):
        g, d, _ = dcgan.train(epochs=1, batch=GAN_BATCH, steps_per_epoch=1,
                              code_dim=GAN_CODE, ctx=ctx, params=p,
                              dtype=dtype)
        return gan_leaves((g, d), params)
    t0 = time.perf_counter()
    want = one(mt.cpu(), params, "float64")
    floors = [one(mt.cpu(), nudged_values(params, SEED + 320 + i, skip=[
        n for n in params if "moving" in n]) if i else params)
        for i in range(RESNET_FLOOR_SAMPLES)]
    print("dcgan_iteration iterations=cpu_f64+%d cpu_f32 seconds=%r"
          % (RESNET_FLOOR_SAMPLES, time.perf_counter() - t0))
    got = one(mt.gpu(0), params)
    worst = floor_check(torch, "dcgan_iteration", got, want, floors)
    rec, mod_g, _, hist = dcgan.run(epochs=1, batch=GAN_BATCH,
                                    steps=GAN_ITERS, code_dim=GAN_CODE)
    d = np.asarray(hist["d_loss"])
    g = np.asarray(hist["g_loss"])
    if not (np.isfinite(d).all() and np.isfinite(g).all()) \
            or np.std(d) <= 1e-4:
        fail("dcgan: d_loss %r g_loss %r" % (d.tolist(), g.tolist()))
    samples = dcgan.sample(mod_g, 16, code_dim=GAN_CODE)
    g_init, _, _ = dcgan.train(epochs=0, batch=GAN_BATCH, steps_per_epoch=0,
                               code_dim=GAN_CODE)
    untrained = dcgan.sample(g_init, 16, code_dim=GAN_CODE)
    moved = float(np.abs(samples - untrained).max())
    if samples.shape != (16, 1, 32, 32) or not np.isfinite(samples).all() \
            or moved <= 1e-3:
        fail("dcgan: samples %r, %r from the untrained generator's"
             % (samples.shape, moved))
    print("dcgan fit %s" % json.dumps(rec))
    print("dcgan iterations=%d iterations_per_s=%r host_ms_per_iteration=%r "
          "d_loss first=%r last=%r g_loss last=%r samples=%r moved=%r "
          "iteration worst_x_floor=%r (%s)"
          % (len(d), rec["value"], rec["host_ms_per_iteration"],
             float(d[0]), float(d[-1]), float(g[-1]), samples.shape, moved,
             worst, card))
    return rec


def operators_phase(torch, mt, card):
    """The operator surface's first part: (a) the 20 ops, (b) AlexNet,
    (c) DCGAN; none launches a kernel of the JSON line."""
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import norm_conv as nc
    counts = (nc.launches, fa.launches, fa.bwd_dq_launches,
              fa.bwd_dkv_launches, contrib.nms_launches)
    t0 = time.perf_counter()
    operators_ops_check(torch, mt)
    print("operators ops seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    alex = alexnet_phase(torch, mt, card)
    torch.cuda.empty_cache()
    print("operators alexnet seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    gan = dcgan_phase(torch, mt, card)
    print("operators dcgan seconds=%r" % (time.perf_counter() - t0))
    after = (nc.launches, fa.launches, fa.bwd_dq_launches,
             fa.bwd_dkv_launches, contrib.nms_launches)
    print("operators kernel launches norm_conv=%d flash_fwd=%d dq=%d dkv=%d "
          "nms=%d (none is on this path)"
          % tuple(b - a for a, b in zip(counts, after)))
    return dict(alex, dcgan_it_s=gan["value"])


# ----------------------------------------------------- rcnn (the slice)
# rcnn: (a) the 11 names of the spatial ops, Proposal and CTCLoss at small
# shapes on the card in float32 (TF32 off) against float64 on the host,
# outputs and gradients within OPS_TOL of their largest entry; Proposal in
# float64 on the card the same rows as on the host (its NMS on the card is
# the row-6 kernels), its float32 rows counted.  (b) Faster R-CNN's test
# width (Ren et al. 2015; py-faster-rcnn's TEST config on VGG-16's conv5_3
# of a 600x1000 image): Proposal timed, its NMS at 6,000 rows against the
# plain loop and the chain bound, ROIPooling (7x7 at 1/16 over 512
# channels) forward and backward timed with its peak memory; both ops
# under sync_free.  (c) Correlation at FlowNetC's settings (Dosovitskiy et
# al. 2015).  (d) CTCLoss at the warpctc OCR example's shapes beside
# F.ctc_loss.  (e) The toy Faster R-CNN through bench/toy_rcnn.py: one
# SGD-momentum step held to float64 by the floor rule; 12 epochs of
# Module.fit from each of RCNN_SEEDS initial parameters, the median
# accuracy above RCNN_ACC (the example's bound lies inside the spread over
# seeds: the JAX example itself scores 0.734-0.922 over its seeds 0-4 on
# the host, so one seed is a draw, not a check).
RCNN_NAMES = ("Crop", "GridGenerator", "BilinearSampler",
              "SpatialTransformer", "ROIPooling", "Correlation",
              "_contrib_Proposal", "Proposal", "_contrib_CTCLoss", "CTCLoss",
              "ctc_loss")
RCNN_F64_TOL = 1e-9
FRCNN = dict(feature=(38, 63), channels=512, im_info=(600.0, 1000.0, 1.0),
             attrs=dict(feature_stride=16, scales=(8.0, 16.0, 32.0),
                        ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=6000,
                        rpn_post_nms_top_n=300, threshold=0.7,
                        rpn_min_size=16),
             pooled=(7, 7), spatial_scale=1.0 / 16)
ROI_PEAK_BYTES = 4e9
FLOWNETC = dict(shape=(8, 256, 48, 64),
                attrs=dict(kernel_size=1, max_displacement=20, stride1=1,
                           stride2=2, pad_size=20))
CTC_OCR = dict(steps=80, batch=32, digits=4, classes=11)
RCNN_EPOCHS = 12
RCNN_ACC = 0.8
RCNN_SEEDS = 5
RCNN_LR = 0.01


def rcnn_cases():
    """(op, attrs, float64 inputs, the inputs to differentiate, False) for
    the 11 names but Proposal, from a seed: ROIPooling on a ReLU'd map
    (ties at 0) with overlapping and empty bins, the sampler past the
    border, Correlation with a 3x3 kernel and |a - b|, CTC labels with
    repeats, an empty label and one that cannot fit."""
    rng = np.random.default_rng(SEED + 30)
    r = rng.standard_normal
    rois = np.array([[0, 0, 0, 63, 47], [1, 8, 4, 40, 30], [1, 50, 40, 90,
                     90], [0, 12, 12, 12, 12], [1, 3, 9, 27, 21]], np.float64)
    labels = np.array([[1, 2, 2, 0], [3, 4, 5, 6], [0, 0, 0, 0],
                       [7, 7, 7, 7]], np.float64)
    ctc = (r((6, 4, 9)), labels)
    return [
        ("Crop", {"h_w": (12, 10), "offset": (3, 2)}, [r((4, 8, 16, 16))],
         (0,)),
        ("Crop", {"h_w": (9, 11), "center_crop": True}, [r((4, 8, 16, 16))],
         (0,)),
        ("Crop", {"num_args": 2}, [r((4, 8, 16, 16)), r((4, 3, 12, 7))],
         (0,)),
        ("GridGenerator", {"transform_type": "affine",
                           "target_shape": (16, 20)}, [r((4, 6))], (0,)),
        ("GridGenerator", {"transform_type": "warp"}, [r((4, 2, 16, 20))],
         (0,)),
        ("BilinearSampler", {}, [r((4, 8, 16, 20)),
                                 rng.uniform(-1.2, 1.2, (4, 2, 12, 12))],
         (0, 1)),
        ("SpatialTransformer", {"target_shape": (12, 12)},
         [r((4, 8, 16, 20)), r((4, 6)) * 0.5], (0, 1)),
        ("ROIPooling", {"pooled_size": (7, 7), "spatial_scale": 0.25},
         [np.maximum(r((2, 16, 12, 16)), 0.0), rois], (0,)),
        ("Correlation", {"max_displacement": 4, "stride2": 2,
                         "pad_size": 4}, [r((2, 16, 12, 16)),
                                          r((2, 16, 12, 16))], (0, 1)),
        ("Correlation", {"max_displacement": 2, "kernel_size": 3,
                         "pad_size": 3, "is_multiply": False},
         [r((2, 16, 12, 16)), r((2, 16, 12, 16))], (0, 1)),
        ("_contrib_CTCLoss", {}, list(ctc), (0,)),
        ("CTCLoss", {}, [r((12, 4, 9)), labels], (0,)),
        ("ctc_loss", {}, [r((3, 4, 9)), labels[:, :3]], (0,))]


def rcnn_proposal_inputs(rng, b, na, fh, fw, info):
    """(cls_prob, bbox_pred, im_info) float64 numpy of an RPN head: each
    anchor's background and foreground probabilities from one logit,
    deltas 0.1 x randn."""
    fg = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, na, fh, fw))))
    return (np.concatenate([1.0 - fg, fg], 1),
            rng.standard_normal((b, 4 * na, fh, fw)) * 0.1,
            np.asarray(info, np.float64))


def rcnn_rel(a, w):
    return ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() \
        if w.numel() else 0.0


def rcnn_ops_check(torch, mt, card):
    """(a): the 11 names on the card against the host."""
    cuda = mt.gpu(0).torch_device()
    worst = {}
    for name, attrs, arrays, diff in rcnn_cases():
        case = (name, attrs, arrays, diff, False)
        got = operator_leaves(torch, mt, case, cuda, torch.float32)
        want = operator_leaves(torch, mt, case, "cpu", torch.float64)
        if sorted(got) != sorted(want):
            fail("rcnn: %s %r gives %s on the card, %s on the host"
                 % (name, attrs, sorted(got), sorted(want)))
        for k, w in want.items():
            if got[k].shape != w.shape or not torch.isfinite(got[k]).all():
                fail("rcnn: %s %r %s: shape %r or not finite"
                     % (name, attrs, k, tuple(got[k].shape)))
            err = rcnn_rel(got[k], w)
            if err > OPS_TOL:
                fail("rcnn: %s %r %s at %.3g of its largest entry from "
                     "float64 (tol %g)" % (name, attrs, k, err, OPS_TOL))
            worst[name] = max(worst.get(name, 0.0), err)
    rng = np.random.default_rng(SEED + 31)
    attrs = dict(feature_stride=16, scales=(2.0, 4.0, 8.0),
                 ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=200,
                 rpn_post_nms_top_n=50, threshold=0.7, rpn_min_size=16,
                 output_score=True)
    arrays = list(rcnn_proposal_inputs(rng, 2, 9, 6, 8,
                                       [[96, 128, 1.0], [80, 120, 1.2]]))
    for name in ("_contrib_Proposal", "Proposal"):
        case = (name, attrs, arrays, (0, 1), False)
        got = operator_leaves(torch, mt, case, cuda, torch.float64)
        want = operator_leaves(torch, mt, case, "cpu", torch.float64)
        rows, ref = got["out0"], want["out0"]
        same = torch.equal(rows[:, 0], ref[:, 0]) and torch.equal(
            rows[:, 1:].any(1), ref[:, 1:].any(1))
        errs = {k: rcnn_rel(got[k], w) for k, w in want.items()}
        if sorted(got) != sorted(want) or not same \
                or max(errs.values()) > RCNN_F64_TOL:
            fail("rcnn: %s in float64 on the card differs from the host: "
                 "same rows %r, errors %r" % (name, same, errs))
        f32 = operator_leaves(torch, mt, case, cuda, torch.float32)["out0"]
        scale = ref.abs().max()
        differ = int(((f32 - ref).abs().amax(1) > OPS_TOL * scale).sum())
        print("rcnn op %s float64 card vs host: same rows (%d kept of %d) "
              "not bitwise %d entries, worst_rel_err=%r; float32 card vs "
              "float64 host: %d of %d rows differ beyond %g of the largest "
              "corner (%s)"
              % (name, int(ref[:, 1:].any(1).sum()), ref.shape[0],
                 int((rows != ref).sum()), max(errs.values()), differ,
                 ref.shape[0], OPS_TOL, card))
        worst[name] = max(errs.values())
    if sorted(worst) != sorted(RCNN_NAMES):
        fail("rcnn: the cases cover %s" % sorted(worst))
    for name in RCNN_NAMES:
        print("rcnn op %s worst_rel_err=%r (%s)" % (name, worst[name],
                                                   "card float64 vs host "
                                                   "float64" if "Proposal"
                                                   in name else
                                                   "card float32 vs host "
                                                   "float64"))
    return worst


def frcnn_check(torch, mt, contrib, card):
    """(b): Proposal, its NMS at 6,000 rows and ROIPooling at Faster
    R-CNN's test width.  Returns the NMS kernels' JSON numbers."""
    from mxnet_tpu_torch.ops.registry import get_op
    cuda = mt.gpu(0).torch_device()
    fh, fw = FRCNN["feature"]
    a = FRCNN["attrs"]
    na = len(a["scales"]) * len(a["ratios"])
    rng = np.random.default_rng(SEED + 32)
    cls_prob, bbox_pred, im_info = (
        torch.tensor(x, dtype=torch.float32, device=cuda)
        for x in rcnn_proposal_inputs(rng, 1, na, fh, fw,
                                      [FRCNN["im_info"]]))
    proposal = get_op("Proposal").fn
    n0 = contrib.nms_launches
    rois = proposal(cls_prob, bbox_pred, im_info, **a)
    torch.cuda.synchronize()
    per_call = 2 * contrib.nms_plan(1, a["rpn_pre_nms_top_n"])[2]
    if contrib.nms_launches - n0 != per_call:
        fail("rcnn: Proposal launched the NMS kernels %d times, not %d"
             % (contrib.nms_launches - n0, per_call))
    sync_free(torch, "rcnn proposal", lambda: proposal(
        cls_prob, bbox_pred, im_info, **a))
    prop_ms = time_ms(torch, lambda: proposal(cls_prob, bbox_pred, im_info,
                                              **a))
    prop_dev_ms, prop_wall_ms, prop_launches = busy_steps(
        torch, lambda: proposal(cls_prob, bbox_pred, im_info, **a), 5)
    boxes, scores = contrib.proposal_rows(
        cls_prob, bbox_pred, im_info, a["rpn_pre_nms_top_n"],
        a["rpn_min_size"], a["scales"], a["ratios"], a["feature_stride"])
    ids = torch.zeros_like(scores)
    got = contrib.greedy_nms(boxes, ids, a["threshold"], True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = contrib.greedy_nms_ref(boxes, ids, a["threshold"], True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got, want):
        fail("rcnn: the NMS kernels' ids differ from the plain loop's at "
             "%d rows (%d rows)" % (ids.shape[1], int((got != want).sum())))
    mask_ms, scan_ms, nms_ms = nms_kernel_ms(torch, contrib, boxes, ids,
                                             a["threshold"],
                                             force_suppress=True)
    kept = int((want >= 0).sum())
    chain_ms = kept * NMS_STEP_CYCLES / NMS_SM_HZ * 1e3
    n = ids.shape[1]
    rows = np.nonzero((want >= 0).cpu().numpy()[0])[0]
    pairs = int((n - 1 - rows).sum())
    ops_ms = max(pairs * NMS_IOU_OPS / PEAK_OPS["float32"] * 1e3, chain_ms)
    bytes_ms = n * (4 + 1 + 1) * 4 / PEAK_BYTES * 1e3
    live = int(torch.isfinite(scores).sum())
    print("rcnn proposal frcnn_test B=1 feature=%dx%d anchors=%d pre_nms=%d "
          "(%d above the minimum size) post_nms=%d kept_by_nms=%d rois=%d "
          "proposal_ms=%r (CUDA events, whole op; profiled: device_ms=%r "
          "wall_ms=%r launches=%d a call) nms kernels_ms=%r "
          "(apart: mask %r, scan %r; %d launches a call) ids_equal_plain=True "
          "plain_seconds=%r bound_ms=%r (a chain of %d dependent steps, one "
          "a kept row, %r ms; %d IoU pairs) (%s)"
          % (fh, fw, fh * fw * na, n, live, a["rpn_post_nms_top_n"], kept,
             int(rois[:, 1:].any(1).sum()), prop_ms, prop_dev_ms,
             prop_wall_ms, prop_launches, nms_ms, mask_ms,
             scan_ms, per_call, plain_s, max(ops_ms, bytes_ms), kept,
             chain_ms, pairs, card))
    roi_ms = frcnn_roi_pooling(torch, mt, rois, card)
    return {"launches": per_call, "ms": nms_ms, "plain_ms": plain_s * 1e3,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": (got - want).abs().max().item(),
            "rows": n, "kept": kept, "proposal_ms": prop_ms,
            "roi_pooling_ms": roi_ms}


def frcnn_roi_pooling(torch, mt, rois, card):
    """ROIPooling at Faster R-CNN's width on Proposal's ROIs over a ReLU'd
    conv5_3 map: float32 against float64 on the card (the ROIs whose bins
    the two dtypes place alike), forward and backward ms, peak memory
    above the inputs, sync_free."""
    from mxnet_tpu_torch.ops import spatial
    from mxnet_tpu_torch.ops.registry import get_op
    cuda = mt.gpu(0).torch_device()
    fh, fw = FRCNN["feature"]
    pool = get_op("ROIPooling").fn
    kw = dict(pooled_size=FRCNN["pooled"],
              spatial_scale=FRCNN["spatial_scale"])
    gen = torch.Generator(device=cuda).manual_seed(SEED + 33)
    data = torch.relu(torch.randn((1, FRCNN["channels"], fh, fw),
                                  generator=gen, device=cuda))
    data.requires_grad_(True)
    g = torch.randn((rois.shape[0], FRCNN["channels"]) + FRCNN["pooled"],
                    generator=gen, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = pool(data, rois, **kw)
    (grad,) = torch.autograd.grad(out, data, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # a bin edge is floor/ceil of a multiple of roi_h / 7, which float32
    # and float64 round apart for some heights: float64 is a reference
    # only for the ROIs whose bins both dtypes place alike
    edges = [spatial.roi_bins(data.detach().to(dt), rois.to(dt),
                              *FRCNN["pooled"], FRCNN["spatial_scale"])[1:]
             for dt in (torch.float32, torch.float64)]
    alike = torch.ones(rois.shape[0], dtype=torch.bool, device=cuda)
    for m32, m64 in zip(*edges):
        alike &= (m32 == m64).flatten(1).all(1)
    sub = torch.nonzero(alike)[:, 0]
    d64 = data.detach().double().requires_grad_(True)
    out64 = pool(d64, rois[sub].double(), **kw)
    (grad64,) = torch.autograd.grad(out64, d64, g[sub].double())
    out32 = pool(data, rois[sub], **kw)
    (grad32,) = torch.autograd.grad(out32, data, g[sub])
    errs = (rcnn_rel(out32.double(), out64.detach()),
            rcnn_rel(grad32.double(), grad64))
    if max(errs) > OPS_TOL or peak > ROI_PEAK_BYTES \
            or sub.numel() < rois.shape[0] // 2:
        fail("rcnn: ROIPooling at Faster R-CNN width: errors %r from "
             "float64 over %d ROIs, peak %d bytes above its inputs (limit "
             "%d)" % (errs, sub.numel(), peak, ROI_PEAK_BYTES))

    def both():
        torch.autograd.grad(pool(data, rois, **kw), data, g)
    sync_free(torch, "rcnn roi_pooling forward+backward", both)
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: pool(data, rois, **kw), iters=10)
    out = pool(data, rois, **kw)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, data, g, retain_graph=True), iters=10)
    ties = int((data == 0).sum())
    print("rcnn roi_pooling frcnn_test rois=%d channels=%d map=%dx%d "
          "pooled=%r scale=1/16 zeros_in_map=%d forward_ms=%r backward_ms=%r "
          "peak_above_inputs_bytes=%d (limit %d) float32 vs float64 over "
          "the %d ROIs whose bins both dtypes place alike: out=%r grad=%r "
          "(%s)"
          % (rois.shape[0], FRCNN["channels"], fh, fw, FRCNN["pooled"], ties,
             fwd_ms, bwd_ms, peak, ROI_PEAK_BYTES, sub.numel(), errs[0],
             errs[1], card))
    return {"forward_ms": fwd_ms, "backward_ms": bwd_ms, "peak": peak}


def flownetc_check(torch, mt, card):
    """(c): Correlation at FlowNetC's settings, float32 against float64 on
    the card; forward and backward ms."""
    from mxnet_tpu_torch.ops.registry import get_op
    cuda = mt.gpu(0).torch_device()
    op = get_op("Correlation")
    corr = op.make_callable(op.normalize_attrs(FLOWNETC["attrs"]), False)
    gen = torch.Generator(device=cuda).manual_seed(SEED + 34)
    a, b = (torch.randn(FLOWNETC["shape"], generator=gen, device=cuda,
                        requires_grad=True) for _ in range(2))
    out = corr(a, b)
    g = torch.randn(out.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad(out, [a, b], g)
    a64, b64 = (x.detach().double().requires_grad_(True) for x in (a, b))
    out64 = corr(a64, b64)
    grads64 = torch.autograd.grad(out64, [a64, b64], g.double())
    errs = [rcnn_rel(out.double(), out64.detach())] + [
        rcnn_rel(x.double(), y) for x, y in zip(grads, grads64)]
    del out64, grads64, a64, b64
    grid = 2 * (FLOWNETC["attrs"]["max_displacement"]
                // FLOWNETC["attrs"]["stride2"]) + 1
    if max(errs) > OPS_TOL or out.shape[1] != grid * grid:
        fail("rcnn: Correlation at FlowNetC's settings: %r channels (%d "
             "expected), errors %r from float64"
             % (out.shape[1], grid * grid, errs))
    with torch.no_grad():
        fwd_ms = time_ms(torch, lambda: corr(a, b), iters=5)
    out = corr(a, b)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, [a, b], g, retain_graph=True), iters=5)
    print("rcnn correlation flownetc data=%r %r out=%r forward_ms=%r "
          "backward_ms=%r float32 vs float64 out=%r grads=%r (%s)"
          % (FLOWNETC["shape"], FLOWNETC["attrs"], tuple(out.shape), fwd_ms,
             bwd_ms, errs[0], errs[1:], card))
    return {"forward_ms": fwd_ms, "backward_ms": bwd_ms}


def ctc_ocr_check(torch, mt, card):
    """(d): CTCLoss at the warpctc OCR example's shapes against float64 on
    the host, beside F.ctc_loss on the same input."""
    from mxnet_tpu_torch.ops.registry import get_op
    import torch.nn.functional as F
    cuda = mt.gpu(0).torch_device()
    t, b, d, c = (CTC_OCR[k] for k in ("steps", "batch", "digits",
                                       "classes"))
    rng = np.random.default_rng(SEED + 35)
    acts = rng.standard_normal((t, b, c))
    labels = rng.integers(1, c, (b, d)).astype(np.float64)
    ctc = get_op("CTCLoss").fn

    def run(dev, dtype):
        x = torch.tensor(acts, dtype=dtype, device=dev, requires_grad=True)
        loss = ctc(x, torch.tensor(labels, dtype=dtype, device=dev))
        (gx,) = torch.autograd.grad(loss.sum(), x)
        return x, loss, gx
    x, loss, gx = run(cuda, torch.float32)
    _, loss64, gx64 = run("cpu", torch.float64)
    errs = (rcnn_rel(loss.double().cpu(), loss64.detach()),
            rcnn_rel(gx.double().cpu(), gx64))
    if max(errs) > OPS_TOL:
        fail("rcnn: CTCLoss at the OCR shapes: errors %r from float64"
             % (errs,))
    lab = torch.tensor(labels, dtype=torch.int64, device=cuda)
    lens_in = torch.full((b,), t, dtype=torch.int64, device=cuda)
    lens_lab = torch.full((b,), d, dtype=torch.int64, device=cuda)

    def lib():
        return F.ctc_loss(torch.log_softmax(x, 2), lab, lens_in, lens_lab,
                          blank=0, reduction="none")
    lib_err = rcnn_rel(lib().detach().double(), loss.detach().double())
    xd = x.detach()
    with torch.no_grad():
        op_ms = time_ms(torch, lambda: ctc(xd, lab.float()), iters=10)
        lib_ms = time_ms(torch, lib, iters=10)
    op_fb = time_ms(torch, lambda: torch.autograd.grad(
        ctc(x, lab.float()).sum(), x), iters=10)
    lib_fb = time_ms(torch, lambda: torch.autograd.grad(lib().sum(), x),
                     iters=10)
    print("rcnn ctc ocr T=%d batch=%d digits=%d classes=%d loss mean=%r "
          "float32 vs float64 loss=%r grad=%r; F.ctc_loss loss rel_diff=%r; "
          "forward ms op=%r F.ctc_loss=%r; forward+backward ms op=%r "
          "F.ctc_loss=%r (%s)"
          % (t, b, d, c, loss.mean().item(), errs[0], errs[1], lib_err,
             op_ms, lib_ms, op_fb, lib_fb, card))
    if lib_err > OPS_TOL:
        fail("rcnn: CTCLoss differs from F.ctc_loss by %r" % lib_err)
    return {"ms": op_fb, "library_ms": lib_fb}


def rcnn_step(torch, mt, tr, net, params, data, ctx, dtype):
    """One SGD-momentum TrainStep step of the toy R-CNN from ``params`` on
    ``data`` at ``dtype`` on ``ctx``: ((first momenta, updates) as float64
    CPU tensors, (TrainStep, params, opt_state, aux, batch) after it)."""
    ts = mt.TrainStep(net, mt.optimizer.SGD(
        learning_rate=RCNN_LR, momentum=0.9, rescale_grad=1.0 / tr.BATCH),
        data_names=("data", "im_info", "rpn_heat"),
        label_names=("softmax_label",), ctx=ctx)
    p, s, a = mt.convert.train_state_from_numpy(
        {n: v.astype(dtype) for n, v in params.items()},
        {n: (np.zeros_like(v, dtype),) for n, v in params.items()}, {},
        ctx=ctx)
    batch = ts.shard_batch({k: v.astype(dtype) for k, v in data.items()})
    before = {n: v.double().cpu().clone() for n, v in p.items()}
    p, s, a, _ = ts(p, s, a, batch)
    return (({n: st[0].double().cpu() for n, st in s.items()},
             {n: v.double().cpu() - before[n] for n, v in p.items()}),
            (ts, p, s, a, batch))


def rcnn_step_check(torch, mt, tr):
    """(e)'s step: float32 on the card against float64 on the host, each
    leaf within RESNET_FLOOR_X times its float32 floor; under sync_free."""
    b = tr.BATCH
    net = tr.build_symbol(b)
    x, y, heat = tr.make_data(b)
    data = {"data": x, "im_info": np.tile([[64.0, 64.0, 1.0]], (b, 1)),
            "rpn_heat": heat, "softmax_label": y}
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(),
                       data_names=("data", "im_info", "rpn_heat"),
                       label_names=("softmax_label",), ctx=mt.cpu())
    p0, _, _ = ts0.init({k: v.shape for k, v in data.items()
                         if k != "softmax_label"}, {"softmax_label": (b,)},
                        initializer=mt.initializer.Xavier(magnitude=2.0),
                        seed=SEED)
    params = {n: v.numpy() for n, v in p0.items()}
    t0 = time.perf_counter()
    want, _ = rcnn_step(torch, mt, tr, net, params, data, mt.cpu(),
                        np.float64)
    floors = []
    for i in range(RESNET_FLOOR_SAMPLES):
        p = nudged_values(params, SEED + 130 + i) if i else params
        d = nudged_values(data, SEED + 230 + i, skip=(
            "softmax_label", "im_info", "rpn_heat")) if i else data
        floors.append(rcnn_step(torch, mt, tr, net, p, d, mt.cpu(),
                                np.float32)[0])
    print("rcnn_train steps=cpu_f64+%d cpu_f32 seconds=%r"
          % (RESNET_FLOOR_SAMPLES, time.perf_counter() - t0))
    got, (ts, p, s, a, batch) = rcnn_step(torch, mt, tr, net, params, data,
                                          mt.gpu(0), np.float32)
    resnet50_check_rows(torch, "rcnn_train", resnet50_leaf_rows(
        torch, got, want, floors, kinds=("grad", "update")),
        "float32 floor")
    sync_free(torch, "rcnn_train step", lambda: ts(p, s, a, batch))


def rcnn_phase(torch, mt, card):
    """The spatial ops, Proposal and CTCLoss: (a) the 11 names, (b) Faster
    R-CNN's test width, (c) FlowNetC's Correlation, (d) the OCR CTC, (e)
    the toy Faster R-CNN.  Returns the NMS kernels' numbers."""
    from mxnet_tpu_torch.bench import toy_rcnn as tr
    from mxnet_tpu_torch.ops import contrib
    t0 = time.perf_counter()
    rcnn_ops_check(torch, mt, card)
    print("rcnn ops seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    frcnn = frcnn_check(torch, mt, contrib, card)
    torch.cuda.empty_cache()
    print("rcnn frcnn seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    flownetc_check(torch, mt, card)
    torch.cuda.empty_cache()
    ctc_ocr_check(torch, mt, card)
    print("rcnn correlation+ctc seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    rcnn_step_check(torch, mt, tr)
    contrib.nms_launches = 0
    recs = [tr.run(RCNN_EPOCHS, seed=k, profile=k == 0)[0]
            for k in range(RCNN_SEEDS)]
    launches = contrib.nms_launches
    batches = tr.IMAGES // tr.BATCH
    for rec in recs:
        print("rcnn fit %s" % json.dumps(rec))
    # one forward a batch: each fit's 12 epochs and score, one profiled
    # epoch
    want = 2 * batches * ((RCNN_EPOCHS + 1) * RCNN_SEEDS + 1)
    accs = [r["accuracy"] for r in recs]
    median = float(np.median(accs))
    if not all(r["fused_path"] for r in recs) or median <= RCNN_ACC \
            or any(r["nms_launches_fit"] != 2 * batches * RCNN_EPOCHS
                   or r["nms_launches_score"] != 2 * batches
                   for r in recs) or launches != want:
        fail("rcnn: toy R-CNN fits: fused %r, accuracies %r (median %r, "
             "bound %r), NMS launches %r in the fits, %r in the scores, %d "
             "in all (%d expected)"
             % ([r["fused_path"] for r in recs], accs, median, RCNN_ACC,
                [r["nms_launches_fit"] for r in recs],
                [r["nms_launches_score"] for r in recs], launches, want))
    rec = recs[0]
    print("rcnn toy accuracy by seed %r median=%r (bound %r) seed 0: "
          "train_accuracy last=%r rpn_loss first=%r last=%r img_per_s=%r "
          "host_ms_per_batch=%r device_busy_share=%r peak %r GB; nms "
          "launches=%d (2 a forward: %d a fit, %d a score) (%s)"
          % (accs, median, RCNN_ACC, rec["train_accuracy"][-1],
             rec["rpn_loss"][0], rec["rpn_loss"][-1], rec["value"],
             rec["host_ms_per_batch"], rec.get("device_busy_share"),
             rec.get("peak_mem_gb"), launches, rec["nms_launches_fit"],
             rec["nms_launches_score"], card))
    print("rcnn toy seconds=%r" % (time.perf_counter() - t0))
    return dict(frcnn, launches=launches + frcnn["launches"])


# ------------------------------------------------- parallel (the slice)
def mp_implied(net, plan, default, grads):
    """(forward, backward) copies one training step of ``net`` bound with
    ``plan`` implies, read off the graph's group boundaries: an op runs on
    its group's device (``default``'s for a variable outside the plan, its
    first input's for an op), a value consumed on another device than its
    producer's is copied there once, and back in the backward when it
    needs a gradient (it descends from an argument in ``grads``, not
    through ``_state_init``, a fill that reads only its input's shape)."""
    from mxnet_tpu_torch.symbol import _topo
    dev, grad = {}, {}
    fwd, bwd = set(), set()
    for n in _topo([o for o, _ in net._outputs]):
        grp = n.attr.get("ctx_group") or n.attr.get("__ctx_group__")
        own = plan[grp].torch_device() if grp in plan else None
        if n.is_var:
            dev[id(n)] = own or default.torch_device()
            grad[id(n)] = n.name in grads
            continue
        dev[id(n)] = own or dev[id(n.inputs[0][0])]
        grad[id(n)] = n.op.name != "_state_init" and any(
            grad[id(c)] for c, _ in n.inputs)
        for c, i in n.inputs:
            if dev[id(c)] != dev[id(n)]:
                fwd.add((id(c), i, dev[id(n)]))
                if grad[id(c)]:
                    bwd.add((id(c), i, dev[id(n)]))
    return len(fwd), len(bwd)


def mp_leaves(torch, tr):
    """A Trainer's step as float64 CPU tensors: every parameter's gradient
    and the softmax output."""
    out = {n: torch.from_numpy(g.asnumpy()).double()
           for n, g in tr.ex.grad_dict.items()
           if n not in ("data", "softmax_label")}
    out["softmax_output"] = torch.from_numpy(
        tr.ex.outputs[0].asnumpy()).double()
    return out


def mp_step(torch, mt, mpl, net, ctx, plan, state, batch, dtype):
    """(leaves, Trainer) of one step of the bench's loop from ``state``."""
    w = MP_WIDTHS
    tr = mpl.Trainer(mt, net, ctx, plan, state, w["batch_size"],
                     w["seq_len"], MP_LR, dtype)
    tr.load(*batch)
    tr.step()
    return mp_leaves(torch, tr), tr


def mp_timed(torch, mt, mpl, net, ctx, plan, state, batches, on_card,
             window=None):
    """The bench's loop over ``batches`` from ``state``: (tokens/s over the
    batches after MP_WARMUP, host ms a batch (median), copies a batch,
    perplexity per window, device-busy share of a profiled step)."""
    w = MP_WIDTHS
    tr = mpl.Trainer(mt, net, ctx, plan, state, w["batch_size"],
                     w["seq_len"], MP_LR)
    ends, ppl, copies = mpl.train(mt, tr, batches, w["batch_size"],
                                  w["seq_len"], w["vocab_size"], SEED,
                                  window or batches)
    gaps = np.diff(ends[MP_WARMUP:]) * 1e3
    busy = mpl.busy_share(tr.step)[0] if on_card else None
    return (w["batch_size"] * w["seq_len"] / (gaps.mean() * 1e-3),
            float(np.median(gaps)), copies[-1], ppl, busy)


def mp_phase(torch, mt, card, gpu, host):
    """(a) and (b) of the parallel phase: BASELINE #5 on the one-card plan
    and on the two-device plan, against the unplaced bind and float64."""
    from mxnet_tpu_torch import executor as exm
    from mxnet_tpu_torch.bench import model_parallel_lstm as mpl
    w = MP_WIDTHS
    net = mpl.model(mt, w["num_layers"], w["seq_len"], w["num_hidden"],
                    w["num_embed"], w["vocab_size"])
    state = mpl.init_state(mt, net, w["batch_size"], w["seq_len"], SEED)
    nparam = sum(v.size for v in state.values())
    batch = mpl.synthetic_batch(np.random.RandomState(SEED),
                                w["batch_size"], w["seq_len"],
                                w["vocab_size"])
    t0 = time.perf_counter()
    want = mp_step(torch, mt, mpl, net, mt.cpu(), None, state, batch,
                   np.float64)[0]
    floors = [mp_step(torch, mt, mpl, net, mt.cpu(), None,
                      nudged_values(state, SEED + 100 + i) if i else state,
                      batch, np.float32)[0]
              for i in range(RESNET_FLOOR_SAMPLES)]
    print("parallel lstm widths=%s parameters=%d cpu_f64+%d cpu_f32 "
          "steps seconds=%r" % (json.dumps(w), nparam, RESNET_FLOOR_SAMPLES,
                                time.perf_counter() - t0))
    # (a) the reference's ngpu = 1: every group on the card
    plan1 = mpl.placement([gpu], w["num_layers"])
    before = exm.cross_device_copies
    one, tr1 = mp_step(torch, mt, mpl, net, gpu, plan1, state, batch,
                       np.float32)
    copies1 = exm.cross_device_copies - before
    if tr1.ex._place is not None or copies1:
        fail("parallel one-card plan: %d copies (placed walk %s)"
             % (copies1, tr1.ex._place is not None))
    plain = [mp_step(torch, mt, mpl, net, gpu, None, state, batch,
                     np.float32)[0] for _ in range(2)]
    differ = [n for n in one if not torch.equal(one[n], plain[0][n])]
    nondet = [n for n in plain[0] if not torch.equal(plain[0][n],
                                                      plain[1][n])]
    if set(differ) - set(nondet):
        fail("parallel one-card plan: %s differ from the unplaced bind's "
             "step, and two unplaced steps agree there"
             % sorted(set(differ) - set(nondet)))
    print("parallel one_card step vs unplaced bind: %s (leaves that differ "
          "%s; between two unplaced steps %s) copies=%d"
          % ("bitwise" if not differ else "within the rule below",
             differ, nondet, copies1))
    floor_check(torch, "parallel one_card", one, want, floors)
    on_card = gpu.device_type == "gpu"
    if on_card:
        tr1.load(*batch)
        sync_free(torch, "parallel one_card step", tr1.step)
    del tr1
    rows = {}
    for turn in range(2):
        for name, plan in (("one_card", plan1), ("unplaced", None)):
            rows.setdefault(name, []).append(mp_timed(
                torch, mt, mpl, net, gpu, plan, state, MP_BATCHES,
                on_card))
    for name, runs in rows.items():
        print("parallel lstm %s tokens_per_s=%r host_ms_per_batch=%r "
              "copies_per_batch=%r device_busy_share=%r perplexity=%r "
              "(%d batches after %d, two turns) [%s]"
              % (name, [r[0] for r in runs], [r[1] for r in runs],
                 [r[2] for r in runs], [r[4] for r in runs],
                 [r[3] for r in runs], MP_BATCHES - MP_WARMUP, MP_WARMUP,
                 card))
        if any(r[2] for r in runs):
            fail("parallel lstm %s: copies %r" % (name, runs))
    # (b) ngpu = 2 over [gpu(0), cpu()]
    plan2 = mpl.placement([gpu, host], w["num_layers"])
    tr2 = mpl.Trainer(mt, net, gpu, plan2, state, w["batch_size"],
                      w["seq_len"], MP_LR)
    fwd, bwd = mp_implied(net, plan2, gpu, tr2.ex.grad_dict)
    tr2.load(*batch)
    before = exm.cross_device_copies
    tr2.ex.forward(is_train=False)
    c_fwd = exm.cross_device_copies - before
    before = exm.cross_device_copies
    tr2.step()
    c_step = exm.cross_device_copies - before
    print("parallel two_device plan=%s copies forward=%d step=%d implied "
          "forward=%d backward=%d outputs on %s"
          % (json.dumps({g: str(c) for g, c in sorted(plan2.items())}),
             c_fwd, c_step, fwd, bwd, tr2.ex.outputs[0].context))
    if on_card and ((c_fwd, c_step) != (fwd, fwd + bwd)
                    or fwd < w["seq_len"]):
        fail("parallel two_device: copies forward %d step %d, the group "
             "boundaries imply %d and %d" % (c_fwd, c_step, fwd, fwd + bwd))
    floor_check(torch, "parallel two_device", mp_leaves(torch, tr2), want,
                floors, pair=one)
    del tr2
    t_ps, t_ms, t_copies, t_ppl, t_busy = mp_timed(
        torch, mt, mpl, net, gpu, plan2, state, MP_TWO_BATCHES, on_card,
        MP_WINDOW)
    print("parallel lstm two_device tokens_per_s=%r host_ms_per_batch=%r "
          "copies_per_batch=%d device_busy_share=%r perplexity per %d "
          "batches=%r [%s]" % (t_ps, t_ms, t_copies, t_busy, MP_WINDOW,
                               t_ppl, card))
    if not t_ppl[-1] < t_ppl[0] or (on_card and t_copies != fwd + bwd):
        fail("parallel two_device training: perplexity %r, copies %d"
             % (t_ppl, t_copies))


def synthetic_digits(n, seed):
    """MNIST-shaped rows (1x28x28, 10 classes): a fixed random template a
    class plus noise; float32 numpy (x, y)."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0, 1, (10, 1, 28, 28))
    y = rng.integers(0, 10, n)
    x = templates[y] + rng.normal(0, 0.5, (n, 1, 28, 28))
    return x.astype(np.float32), y.astype(np.float32)


def dp_module(torch, mt, net, ctxs, kvstore, args, aux, shapes, dtype, lr):
    """A Module over ``ctxs`` bound for ``shapes`` ({name: shape}), with
    ``args``/``aux`` (numpy) and SGD(lr, momentum 0.9) on ``kvstore``; with
    dtype float64 every bound array and the host dicts are widened before
    the store takes its copies."""
    mod = mt.Module(net, context=ctxs)
    mod.bind([(n, s) for n, s in shapes.items() if n == "data"],
             [(n, s) for n, s in shapes.items() if n != "data"])
    mod.init_params(arg_params={n: mt.nd.array(v, ctx=mt.cpu())
                                for n, v in args.items()},
                    aux_params={n: mt.nd.array(v, ctx=mt.cpu())
                                for n, v in aux.items()})
    if dtype == np.float64:
        for ex in mod._exec_group.execs:
            for d in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
                for a in d.values():
                    a._set_value(a.value.double())
        for d in (mod._arg_params, mod._aux_params):
            for a in d.values():
                a._set_value(a.value.double())
    mod.init_optimizer(kvstore=kvstore, optimizer_params={
        "learning_rate": lr, "momentum": 0.9})
    return mod


def dp_step(torch, mt, net, ctxs, kvstore, state, dtype, lr):
    """One forward_backward and update of a ``dp_module`` on ``state``'s
    batch: {kind:name: float64 CPU tensor} of each parameter's gradient
    summed over the devices, its update and each device's moving
    statistics."""
    args, aux, data = state
    mod = dp_module(torch, mt, net, ctxs, kvstore, args, aux,
                    {n: v.shape for n, v in data.items()}, dtype, lr)
    batch = mt.io.DataBatch(
        data=[mt.nd.array(data["data"], ctx=mt.cpu(), dtype=dtype)],
        label=[mt.nd.array(data["softmax_label"], ctx=mt.cpu(),
                           dtype=dtype)])
    grp = mod._exec_group
    before = [torch.from_numpy(p[0].asnumpy()).double()
              for p in grp.param_arrays]
    mod.forward_backward(batch)
    out = {}
    for n, gl in zip(grp.param_names, grp.grad_arrays):
        out["grad:" + n] = sum(torch.from_numpy(g.asnumpy()).double()
                               for g in gl)
    mod.update()
    for n, pl, b in zip(grp.param_names, grp.param_arrays, before):
        out["update:" + n] = torch.from_numpy(pl[0].asnumpy()).double() - b
    for k, ex in enumerate(grp.execs):
        for n, a in ex.aux_dict.items():
            out["aux%d:%s" % (k, n)] = torch.from_numpy(
                a.asnumpy()).double()
    return out


def floor_summary(torch, tag, got, want, floors):
    """``floor_check``'s rule over many leaves, printing the worst three
    by multiple of their floor; returns the worst multiple."""
    rows = resnet50_leaf_rows(torch, (got,), (want,),
                              [(f,) for f in floors], kinds=(tag,))
    rows.sort(key=lambda r: -max(r[4:6]))
    for r in rows[:3]:
        print("%s %s max_rel=%.3e norm_rel=%.3e floor=%.3e/%.3e "
              "x_floor=%.3f/%.3f" % ((tag, r[7]) + r[:6]))
    print("%s leaves=%d worst_x_floor=%.3f (tol %g x)"
          % (tag, len(rows), max(rows[0][4:6]), RESNET_FLOOR_X))
    if max(rows[0][4:6]) > RESNET_FLOOR_X:
        fail("%s: %s at %r x its float32 floor" % (tag, rows[0][7],
                                                   rows[0][4:6]))
    return max(rows[0][4:6])


def dp_check(torch, mt, tag, net, ctxs, cpu_ctxs, kvstore, state, lr):
    """One two-context step on the card (``ctxs``) in float32 within the
    floor rule of the float64 step over ``cpu_ctxs`` on the CPU."""
    t0 = time.perf_counter()
    want = dp_step(torch, mt, net, cpu_ctxs, kvstore, state, np.float64, lr)
    args, aux, data = state
    floors = [dp_step(torch, mt, net, cpu_ctxs, kvstore,
                      (nudged_values(args, SEED + 200 + i),
                       nudged_values(aux, SEED + 300 + i),
                       nudged_values(data, SEED + 400 + i,
                                     skip=("softmax_label",)))
                      if i else state, np.float32, lr)
              for i in range(RESNET_FLOOR_SAMPLES)]
    seconds = time.perf_counter() - t0
    got = dp_step(torch, mt, net, ctxs, kvstore, state, np.float32, lr)
    print("%s contexts=%s kvstore=%s batch=%d references cpu_f64+%d "
          "cpu_f32 seconds=%r" % (tag, ctxs, kvstore,
                                  len(data["softmax_label"]),
                                  RESNET_FLOOR_SAMPLES, seconds))
    return floor_summary(torch, tag, got, want, floors)


def dp_fit_rate(torch, mt, net, ctxs, kvstore, x, y, batch, lr, epochs=1,
                env=None):
    """img/s of ``Module.fit`` over (x, y) (the batch-end gaps after the
    first two of each epoch), each epoch's training accuracy."""
    gaps, accs, last = [], [], [None]
    metric = mt.metric.Accuracy()

    def batch_end(param):
        now = time.perf_counter()
        if param.nbatch >= 2:
            gaps.append(now - last[0])
        last[0] = now

    def epoch_end(epoch, sym, arg, aux):
        accs.append(metric.get()[1])

    def fit():
        it = mt.io.NDArrayIter(x, y, batch_size=batch)
        mod = mt.Module(net, context=ctxs)
        mt.random.seed(SEED)
        mod.fit(it, num_epoch=epochs, kvstore=kvstore, eval_metric=metric,
                optimizer_params={"learning_rate": lr, "momentum": 0.9},
                initializer=mt.init.Xavier(magnitude=2.0),
                batch_end_callback=batch_end, epoch_end_callback=epoch_end)
        return mod
    mod = module_env(env or {}, fit)
    return batch / float(np.mean(gaps)), accs, mod


def dp_phase(torch, mt, card, gpu, host):
    """(c) of the parallel phase: Module.fit over two contexts with a
    store, LeNet and ResNet-50."""
    lenet = mt.models.lenet.get_symbol(num_classes=10)
    x, y = synthetic_digits(LENET_BATCH * LENET_BATCHES, SEED)
    two, one = [gpu, host], [gpu]
    rate2, accs, mod = dp_fit_rate(torch, mt, lenet, two, "local", x, y,
                                   LENET_BATCH, LENET_LR, LENET_EPOCHS)
    if not mod._update_on_kvstore or mod._kvstore.type != "local" or \
            [c.context for c in mod._exec_group.param_arrays[0]] != two:
        fail("parallel lenet: the fit did not update on its local store "
             "over %s" % two)
    if not accs[-1] > accs[0]:
        fail("parallel lenet: training accuracy %r did not rise" % accs)
    rate1 = dp_fit_rate(torch, mt, lenet, one, "local", x, y, LENET_BATCH,
                        LENET_LR, env={"MXNET_FUSED_FIT": "0"})[0]
    print("parallel lenet fit contexts=%s kvstore=local img_per_s=%r "
          "train_accuracy=%r; one context, general path img_per_s=%r "
          "(batch %d) [%s]" % (two, rate2, accs, rate1, LENET_BATCH,
                               card))
    arg_shapes, _, aux_shapes = lenet.infer_shape(
        data=(LENET_BATCH, 1, 28, 28))
    rng = np.random.default_rng(SEED + 7)
    args = {n: rng.uniform(-1, 1, s) * (3.0 / max(1, np.prod(s[1:]))) ** 0.5
            for n, s in zip(lenet.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    xs, ys = synthetic_digits(LENET_BATCH, SEED + 8)
    dp_check(torch, mt, "parallel lenet step", lenet, two,
             [mt.cpu(0), mt.cpu(1)], "local",
             (args, {}, {"data": xs.astype(np.float64),
                         "softmax_label": ys.astype(np.float64)}), LENET_LR)
    # ResNet-50 at full width over [gpu(0), gpu(0)] with "device"
    net = mt.models.resnet.get_symbol(CLASSES, 50, "3,%d,%d"
                                      % (IMAGE, IMAGE))
    rng = np.random.default_rng(SEED + 9)
    n_img = DP_RESNET_BATCH * DP_RESNET_BATCHES
    xr = rng.uniform(-1, 1, (n_img, 3, IMAGE, IMAGE)).astype(np.float32)
    yr = rng.integers(0, CLASSES, n_img).astype(np.float32)
    same = [gpu, gpu]
    rate_dp, _, mod = dp_fit_rate(torch, mt, net, same, "device", xr, yr,
                                  DP_RESNET_BATCH, RESNET_LR)
    execs = mod._exec_group.execs
    if mod._kvstore is None or mod._kvstore.type != "device" or \
            execs[0].arg_dict["fc1_weight"].value.data_ptr() == \
            execs[1].arg_dict["fc1_weight"].value.data_ptr():
        fail("parallel resnet50: two executors on %s did not train apart "
             "through the device store" % same)
    del mod
    rate_one = dp_fit_rate(torch, mt, net, one, "device", xr, yr,
                           DP_RESNET_BATCH, RESNET_LR,
                           env={"MXNET_FUSED_FIT": "0"})[0]
    print("parallel resnet50 fit contexts=%s kvstore=device img_per_s=%r; "
          "one context, general path (MXNET_FUSED_FIT=0) img_per_s=%r "
          "(batch %d, %d batches, the first 2 untimed) [%s]"
          % (same, rate_dp, rate_one, DP_RESNET_BATCH, DP_RESNET_BATCHES,
             card))
    if gpu.device_type == "gpu":
        torch.cuda.empty_cache()
    args, _, aux, data = resnet50_state(mt, net, DP_RESNET_CHECK_BATCH)
    dp_check(torch, mt, "parallel resnet50 step", net, same,
             [mt.cpu(0), mt.cpu(1)], "device", (args, aux, data), RESNET_LR)


def parallel_phase(torch, mt, card, gpu=None, host=None):
    """The single-process parallel slice: (a) and (b) through ``mp_phase``,
    (c) through ``dp_phase``, on ``gpu`` (gpu(0)) and ``host`` (cpu());
    ``card`` names the card in the printed lines."""
    gpu = gpu or mt.gpu(0)
    host = host or mt.cpu()
    mp_phase(torch, mt, card, gpu, host)
    if gpu.device_type == "gpu":
        torch.cuda.empty_cache()
    dp_phase(torch, mt, card, gpu, host)


def obs_events(path):
    """The JSON-lines events of a telemetry file."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def obs_step_spans(events):
    """{nbatch: {span name: ms}} of the fit loop's step spans (epoch 0)."""
    out = {}
    for e in events:
        tags = e.get("tags") or {}
        if e["type"] != "span" or e.get("cat") != "step" \
                or "nbatch" not in tags:
            continue
        row = out.setdefault(tags["nbatch"], {})
        row[e["name"]] = row.get(e["name"], 0.0) + e["dur"] / 1e3
    return out


def obs_median(v):
    v = sorted(v)
    return v[len(v) // 2]


def obs_resnet(mt, b, nb):
    """ResNet-50's symbol, seed-0 parameters and aux states as numpy, and
    ``nb`` synthetic batches of ``b`` (seeded) as host arrays."""
    net = mt.models.resnet.get_symbol(CLASSES, 50,
                                      "3,%d,%d" % (IMAGE, IMAGE))
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p0, _, a0 = ts0.init({"data": (b, 3, IMAGE, IMAGE)},
                         {"softmax_label": (b,)}, seed=SEED)
    args = {n: v.numpy() for n, v in p0.items()}
    aux = {n: v.numpy() for n, v in a0.items()}
    rng = np.random.default_rng(SEED + 11)
    x = rng.uniform(-1, 1, (nb * b, 3, IMAGE, IMAGE)).astype(np.float32)
    y = rng.integers(0, CLASSES, nb * b).astype(np.float32)
    return net, args, aux, x, y


def obs_fit(mt, net, args, aux, x, y, b, env, monitor=None, callback=None):
    """A fresh Module on gpu(0) fit for one epoch over (x, y) in batches of
    ``b`` with the MXNET_* variables of ``env``; the module."""
    mod = mt.Module(net, context=mt.gpu(0))
    module_env(env, lambda: mod.fit(
        mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=1,
        optimizer="sgd", arg_params=args, aux_params=aux,
        optimizer_params=dict(learning_rate=RESNET_LR, momentum=0.9,
                              wd=1e-4),
        monitor=monitor, batch_end_callback=callback))
    return mod


def obs_torch_trace(torch_json, ranges_prefix="train_step["):
    """From a torch.profiler chrome trace: {range name: (device ms of the
    kernels launched inside it, NormConv kernels among them)} over the host
    ranges named ``ranges_prefix``..., the NormConv kernels launched
    outside every such range, the kernels, the card-side range rows, and
    the clock skew bound.

    A kernel belongs to the range its launch (the runtime or driver call of
    the kernel's correlation id) lies in: the launch and the ranges are on
    the host's clock, while a kernel's own timestamps come from the card's
    clock, mapped onto the host's; compared with a host range, they put a
    kernel outside by however far the two clocks disagree.  A kernel with
    no launch event counts as outside.  The skew bound is the least
    (kernel start - its launch's start) over the trace, in us: negative
    only where the mapped card clock runs behind the host's."""
    with open(torch_json) as f:
        evs = json.load(f)["traceEvents"]
    ranges = [e for e in evs if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(ranges_prefix)]
    kernels = [e for e in evs if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in evs
              if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {}
    outside = 0
    skew = None
    for k in kernels:
        la = launch.get(k.get("args", {}).get("correlation"))
        is_nc = "nc_kernel" in k["name"]
        if la is not None:
            d = k["ts"] - la["ts"]
            skew = d if skew is None else min(skew, d)
        host = [] if la is None else [
            r for r in ranges
            if r["ts"] <= la["ts"] <= r["ts"] + r["dur"]]
        if not host:
            outside += int(is_nc)
            continue
        ms, nc = out.get(host[0]["name"], (0.0, 0))
        out[host[0]["name"]] = (ms + k["dur"] / 1e3, nc + int(is_nc))
    gpu_ranges = sum(1 for e in evs if e.get("cat") == "gpu_user_annotation"
                     and str(e.get("name", "")).startswith(ranges_prefix))
    return out, outside, len(kernels), gpu_ranges, skew


def observability_phase(torch, mt, nc, card, fit_img_s):
    """The observability slice's first half on ResNet-50 at full width
    (OBS_BATCH, float32, TF32 off): (a) the general path's host split from
    MXNET_TELEMETRY spans, read back by tools/telemetry_report.py; (b) the
    fused path under MXNET_TELEMETRY_FUSED=1 and MXNET_NORM_CONV=1 with
    the MFU gauges against the card's row of ``cost``; (c) the profiler's
    chrome trace and torch trace around OBS_PROFILED fused batches, the
    NormConv kernel inside the ``train_step`` ranges; (d) Monitor(2) on the
    fused and the general path; (e) with every knob unset, one fused and
    one general-path step without a host sync, and a fit's img/s; (f)
    NaiveEngine: the stream idle after each imperative op.  Returns the
    NormConv launches of the phase."""
    tel, prof, cost = mt.telemetry, mt.profiler, mt.cost
    b = OBS_BATCH
    nb = max(OBS_BATCHES, OBS_FUSED_BATCHES, OBS_MONITOR_BATCHES)
    net, args, aux, x, y = obs_resnet(mt, b, nb)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "observability")
    os.makedirs(work, exist_ok=True)
    knobs_off = {k: None for k in OBS_KNOBS}
    launches = 0
    try:
        # (a) the general path's host split: MXNET_TELEMETRY set, the
        # knob that a user sets, read as at import
        path_a = os.path.join(work, "general.jsonl")

        def general_fit():
            if not tel._autostart():
                fail("observability: MXNET_TELEMETRY=%s did not start "
                     "telemetry" % path_a)
            try:
                return obs_fit(mt, net, args, aux, x[:OBS_BATCHES * b],
                               y[:OBS_BATCHES * b], b,
                               {"MXNET_NORM_CONV": "0"})
            finally:
                tel.stop()
        mod = module_env(dict(knobs_off, MXNET_TELEMETRY=path_a),
                         general_fit)
        if mod._fused_ts_cache is not None:
            fail("observability (a): telemetry kept the fused path")
        steps = obs_step_spans(obs_events(path_a))
        if sorted(steps) != list(range(OBS_BATCHES)):
            fail("observability (a): step spans for batches %s"
                 % sorted(steps))
        shares = []
        for n in sorted(steps):
            row = steps[n]
            kids = sum(row.get(k, 0.0) for k in OBS_SPANS[:-1])
            share = kids / row["step"]
            shares.append(share)
            print("observability general batch=%d %s children_share=%r"
                  % (n, " ".join("%s_ms=%r" % (k, row.get(k))
                                 for k in OBS_SPANS), share))
        steady = sorted(steps)[1:]
        med = {k: obs_median([steps[n][k] for n in steady])
               for k in OBS_SPANS}
        share = obs_median(shares[1:])
        print("observability general host split, median of batches %d-%d "
              "(ResNet-50 batch %d, float32; %s): %s; children cover %r of "
              "step (min %r, max %r)"
              % (steady[0], steady[-1], b, card,
                 " ".join("%s_ms=%r" % (k, med[k]) for k in OBS_SPANS),
                 share, min(shares[1:]), max(shares[1:])))
        # inside forward and backward: the input copies and the executor's
        # own spans, in batch order (they carry no batch tag)
        inner = {}
        for e in obs_events(path_a):
            if e["type"] == "span" and e["name"] in OBS_INNER:
                inner.setdefault(e["name"], []).append(e["dur"] / 1e3)
        print("observability general inner spans, median of batches %d-%d: "
              "%s" % (steady[0], steady[-1], " ".join(
                  "%s_ms=%r" % (k, obs_median(inner[k][1:]))
                  for k in OBS_INNER if len(inner.get(k, ())) > 1)))
        bad = [s for s in shares[1:] if not 0.8 <= s <= 1.0]
        if bad:
            fail("observability (a): the children cover %s of a steady "
                 "step, outside [0.8, 1.0]" % bad)
        rep = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "tools", "telemetry_report.py"), path_a,
             "--steps"], capture_output=True, text=True, timeout=120)
        table = rep.stdout[rep.stdout.find("Step-time breakdown"):]
        table = table[:table.find("Counters")].strip()
        print("observability tools/telemetry_report.py exit=%d\n%s"
              % (rep.returncode, table))
        missing = [k for k in OBS_SPANS[:-1] if k not in table]
        if rep.returncode != 0 or not table or missing:
            fail("observability (a): telemetry_report.py rc=%d, breakdown "
                 "lacks %s: %s" % (rep.returncode, missing,
                                   rep.stderr[-400:]))
        del mod

        # (b) the fused path under MXNET_TELEMETRY_FUSED=1 and NormConv
        peaks = module_env(knobs_off,
                           lambda: cost.resolve_peaks(refresh=True))
        if peaks != cost.DEVICE_PEAKS[0][1:]:
            fail("observability (b): cost resolved %s on %s, not the H100 "
                 "row" % (peaks, torch.cuda.get_device_name(0)))
        shapes = {"data": (b, 3, IMAGE, IMAGE), "softmax_label": (b,)}
        counts = [module_env({"MXNET_NORM_CONV": v},
                             lambda: cost.graph_flops(net, shapes))
                  for v in ("0", "1")]
        path_b = os.path.join(work, "fused.jsonl")
        nc.launches = nc.stats_launches = 0

        def fused_fit():
            tel.start(path_b)
            try:
                return obs_fit(mt, net, args, aux,
                               x[:OBS_FUSED_BATCHES * b],
                               y[:OBS_FUSED_BATCHES * b], b,
                               {"MXNET_NORM_CONV": "1",
                                "MXNET_TELEMETRY_FUSED": "1"})
            finally:
                tel.stop()
        mod = module_env(knobs_off, fused_fit)
        torch.cuda.synchronize()
        got_nc = (nc.launches, nc.stats_launches)
        launches += nc.launches
        evs = obs_events(path_b)
        fused = [e["tags"]["nbatch"] for e in evs
                 if e.get("name") == "fused_step"]
        flops = [e["value"] for e in evs if e.get("name") == "model_flops"]
        mfus = [e["value"] for e in evs if e.get("name") == "mfu"]
        fsteps = obs_step_spans(evs)
        print("observability fused (MXNET_TELEMETRY_FUSED=1, "
              "MXNET_NORM_CONV=1) fused_step_ms=%s step_ms=%s mfu=%s "
              "model_flops=%s graph_flops norm_conv=0:%d norm_conv=1:%d "
              "norm_conv launches=%d stats=%d in %d steps; peaks %s (%s)"
              % ([fsteps[n].get("fused_step") for n in sorted(fsteps)],
                 [fsteps[n].get("step") for n in sorted(fsteps)], mfus,
                 sorted(set(flops)), counts[0], counts[1], got_nc[0],
                 got_nc[1], OBS_FUSED_BATCHES, peaks, card))
        if mod._fused_ts_cache is None or \
                fused != list(range(OBS_FUSED_BATCHES)):
            fail("observability (b): fused_step spans for batches %s"
                 % fused)
        if counts[0] != counts[1] or not flops or \
                set(flops) != {counts[0]} or \
                mod._fused_ts_cache[1].step_flops() != counts[0]:
            fail("observability (b): model_flops %s, graph count %s"
                 % (sorted(set(flops)), counts))
        if len(mfus) != OBS_FUSED_BATCHES or \
                not all(0.0 < v < 1.0 for v in mfus):
            fail("observability (b): mfu %s not in (0, 1) each step" % mfus)
        if got_nc != (OBS_FUSED_BATCHES * RESNET_NC_PER_STEP,
                      OBS_FUSED_BATCHES * RESNET_NC_STATS_PER_STEP):
            fail("observability (b): NormConv launched %s in %d steps"
                 % (got_nc, OBS_FUSED_BATCHES))
        print("observability mfu median=%r (float32 step against the bf16 "
              "tensor-core peak %r FLOP/s, model FLOPs %d a step) on %s"
              % (obs_median(mfus), peaks[0], counts[0], card))

        # (c) the profiler around OBS_PROFILED fused batches
        path_c = os.path.join(work, "profile.json")
        prof.set_config(mode="symbolic", filename=path_c)
        fast = module_env({"MXNET_NORM_CONV": "1"}, mod._start_fused_fit)
        staged = [mt.io.DataBatch(
            [mt.nd.array(x[i * b:(i + 1) * b], ctx=mt.cpu())],
            [mt.nd.array(y[i * b:(i + 1) * b], ctx=mt.cpu())])
            for i in range(OBS_PROFILED)]
        nc.launches = 0

        def profiled():
            prof.set_state("run")
            try:
                for batch in staged:
                    fast.step(batch)
            finally:
                prof.set_state("stop")
        module_env(dict(knobs_off, MXNET_NORM_CONV="1"), profiled)
        fast.sync_back()
        launches += nc.launches
        prof.dump_profile()
        with open(path_c) as f:
            chrome = json.load(f)["traceEvents"]
        ts_names = [e["name"] for e in chrome
                    if e.get("name", "").startswith("train_step[")]
        by_range, outside, n_kernels, gpu_ranges, skew = obs_torch_trace(
            path_c + ".torch.json")
        for name in sorted(by_range):
            print("observability profile range %s device_ms=%r "
                  "nc_kernel=%d" % ((name,) + by_range[name]))
        print("observability profile chrome train_step events=%s; torch "
              "trace kernels=%d, nc_kernel launched outside the ranges=%d, "
              "gpu_user_annotation train_step rows=%d, clock skew bound "
              "(least kernel start - launch) us=%r"
              % (ts_names, n_kernels, outside, gpu_ranges, skew))
        nc_in = sum(v[1] for v in by_range.values())
        if len(ts_names) != OBS_PROFILED or \
                nc_in != OBS_PROFILED * RESNET_NC_PER_STEP or outside:
            fail("observability (c): %d train_step events, %d nc_kernel "
                 "events inside train_step ranges (%d outside), expected "
                 "%d and %d" % (len(ts_names), nc_in, outside, OBS_PROFILED,
                                OBS_PROFILED * RESNET_NC_PER_STEP))
        del mod, fast

        # (d) Monitor(2): on the fused path, parameter rows equal to
        # |w|/sqrt(size) of the parameters before the armed step
        rows = []
        before = {}

        class Capture(mt.Monitor):
            def toc_print(self):
                rows.extend(self.toc())

        def snapshot(p):
            if p.nbatch % 2 == 1:          # before step nbatch + 1
                ff = p.locals["fast"]
                before[p.nbatch + 1] = {
                    n: float(v.double().square().sum().sqrt()) / np.sqrt(
                        v.numel()) for n, v in ff._params.items()}
        before[0] = {n: float(np.sqrt(np.square(v.astype(np.float64)).sum())
                              / np.sqrt(v.size)) for n, v in args.items()}
        mod = module_env(knobs_off, lambda: obs_fit(
            mt, net, args, aux, x[:OBS_MONITOR_BATCHES * b],
            y[:OBS_MONITOR_BATCHES * b], b, {"MXNET_NORM_CONV": "0"},
            monitor=Capture(2), callback=snapshot))
        if mod._fused_ts_cache is None:
            fail("observability (d): the default Monitor left the fused "
                 "path")
        worst = 0.0
        for step, name, shown in rows:
            v = float(str(shown).strip("[] "))
            want = before[step][name]
            worst = max(worst, abs(v - want) / want if want else abs(v))
        armed = sorted({s for s, _, _ in rows})
        print("observability monitor fused rows=%d at steps %s, worst "
              "relative distance from |w|/sqrt(size) on the card=%r"
              % (len(rows), armed, worst))
        if armed != list(range(0, OBS_MONITOR_BATCHES, 2)) or \
                len(rows) != len(armed) * len(args) or \
                worst > OBS_MONITOR_TOL:
            fail("observability (d): fused Monitor rows at %s (%d), worst "
                 "%r (tol %g)" % (armed, len(rows), worst, OBS_MONITOR_TOL))
        del mod
        rows.clear()
        mod = module_env(dict(knobs_off, MXNET_FUSED_FIT="0"), lambda: obs_fit(
            mt, net, args, aux, x[:2 * b], y[:2 * b], b,
            {"MXNET_NORM_CONV": "0"}, monitor=Capture(2)))
        outs = [nm for _, nm, _ in rows if "_output" in nm]
        n_nodes = sum(node.op.num_outputs_for(node.params)
                      for node in net._nodes() if not node.is_var)
        argrows = [nm for _, nm, _ in rows][len(outs):]
        finite = all(np.isfinite(float(str(sh).strip("[] ")))
                     for _, _, sh in rows)
        print("observability monitor general rows=%d (%d node outputs of "
              "%d, sorted by name: %s; %d arguments in list_arguments "
              "order: %s), finite: %s"
              % (len(rows), len(outs), n_nodes, outs == sorted(outs),
                 len(argrows), argrows == net.list_arguments(), finite))
        if mod._fused_ts_cache is not None or len(outs) != n_nodes or \
                outs != sorted(outs) or argrows != net.list_arguments() \
                or not finite:
            fail("observability (d): general-path Monitor rows wrong")
        del mod

        # (e) every knob unset: a fit's img/s, one fused step and one
        # general-path step without a host sync
        ends = []
        mod = module_env(knobs_off, lambda: obs_fit(
            mt, net, args, aux, x[:OBS_FUSED_BATCHES * b],
            y[:OBS_FUSED_BATCHES * b], b, {"MXNET_NORM_CONV": "0"},
            callback=lambda p: ends.append(time.perf_counter())))
        torch.cuda.synchronize()
        gaps = [t1 - t0 for t0, t1 in zip(ends, ends[1:])]
        print("observability knobs off: fit img_per_s=%r (host ms a batch "
              "%s); module_fit phase fit img_per_s=%r (this call, for the "
              "record)" % (b / obs_median(gaps), [1e3 * g for g in gaps],
                           fit_img_s))
        if tel._enabled or prof.is_running() or mt.engine.is_naive():
            fail("observability (e): a knob is still on")
        fast = module_env(knobs_off, mod._start_fused_fit)
        host = staged[0]
        sync_free(torch, "observability fused step, knobs off",
                  lambda: fast.step(fast._stage(host)))
        fast.sync_back()
        dev = mt.gpu(0)
        dev_batch = mt.io.DataBatch(
            [mt.nd.array(x[:b], ctx=dev)], [mt.nd.array(y[:b], ctx=dev)])
        metric = mt.metric.Accuracy()

        def general_step():
            mod.forward_backward(dev_batch)
            mod.update()
            mod.update_metric(metric, dev_batch.label)
        sync_free(torch, "observability general-path step, knobs off",
                  general_step)
        del mod, fast

        # (f) NaiveEngine: the stream is idle after each imperative op
        old = mt.engine.engine_type()
        mt.engine.set_engine_type("NaiveEngine")
        try:
            idle = []
            a = mt.nd.array(np.random.default_rng(SEED).standard_normal(
                (2048, 2048)).astype(np.float32), ctx=dev)
            for what, fn in (("mul", lambda: a * 0.5),
                             ("dot", lambda: mt.nd.dot(a, a)),
                             ("exp", lambda: mt.nd.exp(a / 64.0)),
                             ("sum", lambda: mt.nd.sum(a)),
                             ("transpose", lambda: a.T)):
                fn()
                idle.append((what, torch.cuda.current_stream().query()))
        finally:
            mt.engine.set_engine_type(old)
        big = mt.nd.dot(a, a)
        after_threaded = torch.cuda.current_stream().query()
        del big
        print("observability NaiveEngine stream idle after each op: %s; "
              "after a threaded-engine dot: %s" % (idle, after_threaded))
        if not all(q for _, q in idle):
            fail("observability (f): the stream was busy after an op "
                 "under NaiveEngine: %s" % idle)
    finally:
        if prof.is_running():
            prof.set_state("stop")
        tel.stop()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ imagenet
INCEPTION_IMAGE = 299
INCEPTION_NC_PER_STEP = 15
INCEPTION_NC_STATS_PER_STEP = 5
INCEPTION_GEOMS = 9
INCEPTION_CHECK_BATCH = 2
INCEPTION_FIT_BATCH = 32
INCEPTION_FUSED_BATCHES = 6
INCEPTION_GENERAL_BATCHES = 3
INCEPTION_PROFILED = 2
INCEPTION_LR = 0.1
INCEPTION_SERVE_BATCH = 8
INCEPTION_SERVE_FORWARDS = 3
VGG_CHECK_BATCH = 1
VGG_FIT_BATCH = 32
VGG_FIT_BATCHES = 4
VGG_LR = 0.01


def imagenet_args(ti, network, batch, lr):
    """train_imagenet.py's arguments for ``network`` at its defaults (1000
    classes), batch ``batch``, learning rate ``lr``."""
    size = INCEPTION_IMAGE if network == "inception-v3" else IMAGE
    return ti.parser().parse_args(["--network", network, "--image-shape",
                                   "3,%d,%d" % (size, size), "--batch-size",
                                   str(batch), "--lr", repr(lr)])


def inception_step_check(torch, mt, nc, net):
    """(a): one SGD-momentum step at batch INCEPTION_CHECK_BATCH, float32
    on the card with MXNET_NORM_CONV 0 and 1, against the float64 step on
    the CPU (unfused), each gradient and moving statistic within
    RESNET_FLOOR_X times its float32 floor; the kernel's launches and
    launches with statistics in the step at the graph's counts, none with
    the knob off.  Returns (the seed state, the launches counted)."""
    b = INCEPTION_CHECK_BATCH
    state = resnet50_state(mt, net, b, image=INCEPTION_IMAGE)
    want, floors = module_env({"MXNET_NORM_CONV": "0"},
                              lambda: resnet50_reference(
                                  mt, net, state, b, tag="inception_train"))
    launches = 0
    for knob in ("0", "1"):
        nc.launches = nc.stats_launches = 0
        t0 = time.perf_counter()
        got = module_env({"MXNET_NORM_CONV": knob}, lambda: resnet50_step(
            mt, net, state, mt.gpu(0), np.float32, b)[0])
        torch.cuda.synchronize()
        counts = (nc.launches, nc.stats_launches)
        launches += counts[0]
        expect = (INCEPTION_NC_PER_STEP, INCEPTION_NC_STATS_PER_STEP) \
            if knob == "1" else (0, 0)
        tag = "inception_train MXNET_NORM_CONV=%s" % knob
        print("%s step=card_float32 batch=%d seconds=%r norm_conv_launches=%d "
              "with_statistics=%d" % ((tag, b, time.perf_counter() - t0)
                                      + counts))
        if counts != expect:
            fail("%s: NormConv launches %r, the graph gives %r"
                 % (tag, counts, expect))
        resnet50_check_rows(torch, tag, resnet50_leaf_rows(torch, got, want,
                                                           floors),
                            "float32 floor")
    return state, launches


def imagenet_fit(torch, mt, ti, net, args, x, y, arg_params, aux_params,
                 env):
    """``train_imagenet.fit`` on gpu(0) for one epoch over (x, y) under
    ``env``: {img_s (card's end of the first batch to its end of the
    last), host_ms (median gap between batch ends), fused, peak_gb,
    losses (each batch's cross-entropy before its update), module}."""
    b = args.batch_size
    n = len(x) // b
    ends = []

    def batch_end(param):
        if param.nbatch in (0, n - 1):
            torch.cuda.synchronize()
        ends.append(time.perf_counter())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod, loss = module_env(env, lambda: ti.fit(
        args, net, mt.gpu(0), data=x, label=y,
        arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in arg_params.items()},
        aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in aux_params.items()},
        batch_end_callback=batch_end))
    if len(ends) != n:
        fail("imagenet fit: %d batch ends in a fit of %d" % (len(ends), n))
    gaps = [(t1 - t0) * 1e3 for t0, t1 in zip(ends, ends[1:])]
    return {"img_s": (n - 1) * b / (ends[-1] - ends[0]),
            "host_ms": obs_median(gaps),
            "fused": mod._fused_ts_cache is not None,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": loss.values(), "module": mod}


def inception_fits(torch, mt, nc, ti, net, state, card):
    """(b): Module.fit at batch INCEPTION_FIT_BATCH, fused and general,
    knob off and on, over one synthetic batch repeated (so that the loss
    must fall): img/s, host ms a batch, peak memory, the busy share of
    profiled steps; the NormConv launches of the fits."""
    params = {n: v.astype(np.float32) for n, v in state[0].items()}
    aux = {n: v.astype(np.float32) for n, v in state[2].items()}
    b = INCEPTION_FIT_BATCH
    args = imagenet_args(ti, "inception-v3", b, INCEPTION_LR)
    rng = np.random.default_rng(SEED + 30)
    one = rng.uniform(-1, 1, (b, 3, INCEPTION_IMAGE, INCEPTION_IMAGE)) \
        .astype(np.float32)
    lab = rng.integers(0, CLASSES, b).astype(np.float32)
    out = {}
    for knob in ("0", "1"):
        for path, nb in (("fused", INCEPTION_FUSED_BATCHES),
                         ("general", INCEPTION_GENERAL_BATCHES)):
            env = {"MXNET_NORM_CONV": knob,
                   "MXNET_FUSED_FIT": "1" if path == "fused" else "0"}
            nc.launches = nc.stats_launches = 0
            r = imagenet_fit(torch, mt, ti, net, args,
                             np.concatenate([one] * nb),
                             np.concatenate([lab] * nb), params, aux, env)
            counts = (nc.launches, nc.stats_launches)
            if r["fused"] != (path == "fused"):
                fail("inception fit %s: fused path taken %r"
                     % (path, r["fused"]))
            want = (nb * INCEPTION_NC_PER_STEP,
                    nb * INCEPTION_NC_STATS_PER_STEP) if knob == "1" \
                else (0, 0)
            if counts != want:
                fail("inception fit %s knob %s: NormConv launches %r, want %r"
                     % (path, knob, counts, want))
            losses = r["losses"]
            if len(losses) != nb or not np.isfinite(losses).all() \
                    or not losses[-1] < losses[1]:
                fail("inception fit %s knob %s: the loss %r did not fall "
                     "after the first batch" % (path, knob, losses))
            mod = r.pop("module")
            if path == "fused":
                ts = mt.TrainStep(net, mt.optimizer.SGD(
                    learning_rate=INCEPTION_LR, momentum=0.9,
                    rescale_grad=1.0 / b), ctx=mt.gpu(0))
                p, s, a = mt.convert.train_state_from_numpy(
                    params, {n: (np.zeros_like(v),)
                             for n, v in params.items()}, aux, ctx=mt.gpu(0))
                dev = ts.shard_batch({"data": one, "softmax_label": lab})

                def step():
                    ts(p, s, a, dev)
            else:
                db = mt.io.DataBatch(data=[mt.nd.array(one, ctx=mt.cpu())],
                                     label=[mt.nd.array(lab, ctx=mt.cpu())])

                def step():
                    mod.forward_backward(db)
                    mod.update()

            def profiled():
                step()
                step()
                return busy_steps(torch, step, INCEPTION_PROFILED)
            dev_ms, wall_ms, launches = module_env(env, profiled)
            r.update(device_ms=dev_ms, wall_ms=wall_ms,
                     busy=dev_ms / wall_ms, launches=launches,
                     nc_launches=counts[0], nc_stats=counts[1])
            print("inception fit path=%s MXNET_NORM_CONV=%s batch=%d "
                  "batches=%d img_per_s=%r host_ms_per_batch=%r "
                  "peak_mem_gb=%r loss first=%r after_one=%r last=%r "
                  "norm_conv_launches=%d with_statistics=%d; profiled step "
                  "(%d): device_ms=%r wall_ms=%r device_busy_share=%r "
                  "launches=%d (%s)"
                  % (path, knob, b, nb, r["img_s"], r["host_ms"],
                     r["peak_gb"], losses[0], losses[1], losses[-1],
                     counts[0], counts[1], INCEPTION_PROFILED, dev_ms,
                     wall_ms, dev_ms / wall_ms, launches, card))
            del mod, step
            torch.cuda.empty_cache()
            out[(path, knob)] = r
    return out


def inception_predictor_check(torch, mt, nc, net, state, card):
    """(c): Predictor at batch INCEPTION_SERVE_BATCH with the knob on, its
    rows within SERVE_TOL of the unfused Predictor's (cuDNN, TF32 off),
    INCEPTION_NC_PER_STEP launches a forward, none unfused; host ms a
    forward of each.  Returns the launches counted."""
    blob = mt.convert.params_from_numpy(
        {n: v.astype(np.float32) for n, v in state[0].items()},
        {n: v.astype(np.float32) for n, v in state[2].items()},
        ctx=mt.gpu(0))
    shape = (INCEPTION_SERVE_BATCH, 3, INCEPTION_IMAGE, INCEPTION_IMAGE)
    x = np.random.default_rng(SEED + 31).uniform(-1, 1, shape) \
        .astype(np.float32)
    res = {}
    for knob in ("1", "0"):
        def run():
            pred = mt.Predictor(net, blob, {"data": shape})
            pred.forward(data=x)
            pred.get_output(0)
            nc.launches = 0
            t0 = time.perf_counter()
            for _ in range(INCEPTION_SERVE_FORWARDS):
                pred.forward(data=x)
                rows = pred.get_output(0)
            return rows, (time.perf_counter() - t0) * 1e3 \
                / INCEPTION_SERVE_FORWARDS, nc.launches
        res[knob] = module_env({"MXNET_NORM_CONV": knob}, run)
    got, want = res["1"][0], res["0"][0]
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    print("inception predictor batch=%d forwards=%d norm_conv_launches=%d "
          "(unfused %d) host_ms_per_forward fused=%r unfused=%r "
          "max_abs_diff=%r max_prob=%r tol=%g*max_prob argmax_agree=%d/%d "
          "(%s)" % (INCEPTION_SERVE_BATCH, INCEPTION_SERVE_FORWARDS,
                    res["1"][2], res["0"][2], res["1"][1], res["0"][1], err,
                    scale, SERVE_TOL, agree, INCEPTION_SERVE_BATCH, card))
    if res["1"][2] != INCEPTION_NC_PER_STEP * INCEPTION_SERVE_FORWARDS \
            or res["0"][2] != 0:
        fail("inception predictor: NormConv launches %d fused, %d unfused"
             % (res["1"][2], res["0"][2]))
    if got.shape != (INCEPTION_SERVE_BATCH, CLASSES) or \
            not np.isfinite(got).all() or err > SERVE_TOL * scale:
        fail("inception predictor: rows differ from the unfused Predictor "
             "by %r (tol %g x %r)" % (err, SERVE_TOL, scale))
    return res["1"][2]


def vgg_phase(torch, mt, ti, card):
    """(d): VGG-16 (train_imagenet.py --network vgg: 1000 classes,
    3x224x224): one step at batch VGG_CHECK_BATCH held to its float32
    floor, Dropout masks injected; a short Module.fit at VGG_FIT_BATCH."""
    args = imagenet_args(ti, "vgg", VGG_FIT_BATCH, VGG_LR)
    net = ti.get_symbol(args)
    b = VGG_CHECK_BATCH
    ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
    p0, _, _ = ts0.init({"data": (b, 3, IMAGE, IMAGE)},
                        {"softmax_label": (b,)}, seed=SEED)
    params = {n: v.numpy() for n, v in p0.items()}
    n_params = sum(int(v.size) for v in params.values())
    rng = np.random.default_rng(SEED + 32)
    data = {"data": rng.uniform(-1, 1, (b, 3, IMAGE, IMAGE)),
            "softmax_label": rng.integers(0, CLASSES, b).astype(np.float64)}
    masks = [rng.random((b, 4096)) < 0.5 for _ in range(2)]
    t0 = time.perf_counter()
    want = alexnet_step(torch, mt, net, params, data, masks, mt.cpu(),
                        np.float64, VGG_LR, b)
    floors = []
    for i in range(RESNET_FLOOR_SAMPLES):
        pi = nudged_values(params, SEED + 130 + i) if i else params
        xi = nudged_values(data, SEED + 230 + i, skip=("softmax_label",)) \
            if i else data
        floors.append(alexnet_step(torch, mt, net, pi, xi, masks, mt.cpu(),
                                   np.float32, VGG_LR, b))
    print("vgg16_train params=%d steps=cpu_f64+%d cpu_f32 batch=%d "
          "seconds=%r" % (n_params, RESNET_FLOOR_SAMPLES, b,
                          time.perf_counter() - t0))
    got = alexnet_step(torch, mt, net, params, data, masks, mt.gpu(0),
                       np.float32, VGG_LR, b)
    resnet50_check_rows(torch, "vgg16_train",
                        resnet50_leaf_rows(torch, got, want, floors,
                                           kinds=("grad", "update")),
                        "float32 floor")
    rng = np.random.default_rng(SEED + 33)
    x = rng.uniform(-1, 1, (VGG_FIT_BATCHES * VGG_FIT_BATCH, 3, IMAGE,
                            IMAGE)).astype(np.float32)
    y = rng.integers(0, CLASSES, len(x)).astype(np.float32)
    r = imagenet_fit(torch, mt, ti, net, args, x, y,
                     {n: v.astype(np.float32) for n, v in params.items()},
                     {}, {})
    del r["module"]
    if not r["fused"] or not np.isfinite(r["losses"]).all():
        fail("vgg16 fit: fused %r, losses %r" % (r["fused"], r["losses"]))
    print("vgg16 fit params=%d batch=%d batches=%d img_per_s=%r "
          "host_ms_per_batch=%r peak_mem_gb=%r losses=%r (%s)"
          % (n_params, VGG_FIT_BATCH, VGG_FIT_BATCHES, r["img_s"],
             r["host_ms"], r["peak_gb"], r["losses"], card))
    return r


def imagenet_phase(torch, mt, nc, card):
    """Inception-v3 at full width (1000 classes, 3x299x299, 23,834,568
    parameters), then VGG-16: (a)-(d) of the module docstring.  Returns
    {"launches": the NormConv launches of the phase's counted runs,
    "stats": those with statistics, "fits", "vgg"}."""
    from mxnet_tpu_torch.bench import train_imagenet as ti
    t0 = time.perf_counter()
    args = imagenet_args(ti, "inception-v3", INCEPTION_FIT_BATCH,
                         INCEPTION_LR)
    net = ti.get_symbol(args)
    state, step = inception_step_check(torch, mt, nc, net)
    print("imagenet inception step seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    fits = inception_fits(torch, mt, nc, ti, net, state, card)
    print("imagenet inception fits seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve = inception_predictor_check(torch, mt, nc, net, state, card)
    torch.cuda.empty_cache()
    print("imagenet inception predictor seconds=%r"
          % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    vgg = vgg_phase(torch, mt, ti, card)
    torch.cuda.empty_cache()
    print("imagenet vgg16 seconds=%r" % (time.perf_counter() - t0))
    return {"launches": step + serve + sum(r["nc_launches"]
                                           for r in fits.values()),
            "fits": fits, "vgg": vgg}


# -------------------------------------------------------------------- custom
CUSTOM_FEATURES = 784
CUSTOM_HIDDEN = (128, 64)
CUSTOM_CLASSES = 10
CUSTOM_BATCH = 100
CUSTOM_BATCHES = 6
CUSTOM_LR = 0.1
CUSTOM_BLOCK = (8, 16, 28, 28)
STYLE_STEPS = 60


def custom_register(mt, reads):
    """The Custom ops of the phase: the softmax head of MXNet's
    example/numpy-ops/custom_softmax.py (``chip_softmax``: numpy forward,
    backward p - onehot, need_top_grad=False; ``reads`` counts its host
    reads; its forward's result goes through a host NDArray, its
    backward's through one on the op's context) and test_custom_op.py's
    ``chip_sqr`` in mx.nd ops, which checks that it is handed contiguous
    channel-first tensors of its inferred shape."""
    op = mt.operator

    def host(arr):
        reads[0] += 1
        return arr.asnumpy()

    class Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = host(in_data[0])
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mt.nd.array(y, ctx=mt.cpu()))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = host(in_data[1]).ravel().astype(np.int64)
            y = host(out_data[0])
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mt.nd.array(y))

    @op.register("chip_softmax")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Sqr(op.CustomOp):
        def __init__(self, shape):
            self.shape = shape

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            if x.shape != self.shape or not x.value.is_contiguous():
                fail("custom sqr: handed %r (contiguous %r), inferred %r"
                     % (x.shape, x.value.is_contiguous(), self.shape))
            self.assign(out_data[0], req[0], x * x)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @op.register("chip_sqr")
    class SqrProp(op.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sqr(tuple(in_shapes[0]))


def custom_mlp(mt, head):
    """custom_softmax.py's MLP with the Custom head or SoftmaxOutput."""
    S = mt.sym
    h = S.Variable("data")
    for i, nh in enumerate(CUSTOM_HIDDEN + (CUSTOM_CLASSES,)):
        h = S.FullyConnected(h, name="fc%d" % (i + 1), num_hidden=nh)
        if i < len(CUSTOM_HIDDEN):
            h = S.Activation(h, name="relu%d" % (i + 1), act_type="relu")
    if head == "custom":
        return S.Custom(h, S.Variable("softmax_label"), name="softmax",
                        op_type="chip_softmax")
    return S.SoftmaxOutput(h, name="softmax")


def custom_fit(torch, mt, head, fused, params, x, y):
    """Module.fit on gpu(0), one epoch of SGD-momentum: (parameters as
    numpy, host ms a batch (median gap between batch ends), fused path
    taken)."""
    ends = []

    def batch_end(param):
        ends.append(time.perf_counter())
    mod = mt.Module(custom_mlp(mt, head), context=mt.gpu(0))
    module_env({"MXNET_FUSED_FIT": "1" if fused else "0"}, lambda: mod.fit(
        mt.io.NDArrayIter(x, y, batch_size=CUSTOM_BATCH), num_epoch=1,
        optimizer="sgd", optimizer_params={"learning_rate": CUSTOM_LR,
                                           "momentum": 0.9},
        arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in params.items()}, aux_params={},
        batch_end_callback=batch_end))
    args, _ = mod.get_params()
    gaps = [(t1 - t0) * 1e3 for t0, t1 in zip(ends, ends[1:])]
    return ({k: v.asnumpy() for k, v in args.items()}, obs_median(gaps),
            mod._fused_ts_cache is not None)


def custom_mlp_check(torch, mt, reads, card):
    """The Custom softmax head against SoftmaxOutput through Module.fit,
    fused and general: each parameter after CUSTOM_BATCHES batches within
    RESNET_FLOOR_X times its float32 floor (the SoftmaxOutput fit's
    distance to its fit from parameters nudged by RESNET_FLOOR_NUDGE);
    host ms a batch of both heads and the head's host reads a batch."""
    rng = np.random.default_rng(SEED + 40)
    n = CUSTOM_BATCH * CUSTOM_BATCHES
    x = rng.random((n, CUSTOM_FEATURES)).astype(np.float32)
    y = rng.integers(0, CUSTOM_CLASSES, n).astype(np.float32)
    dims = (CUSTOM_FEATURES,) + CUSTOM_HIDDEN + (CUSTOM_CLASSES,)
    params = {}
    for i, (fin, fout) in enumerate(zip(dims, dims[1:])):
        bound = np.sqrt(3.0 / fin)
        params["fc%d_weight" % (i + 1)] = rng.uniform(
            -bound, bound, (fout, fin)).astype(np.float32)
        params["fc%d_bias" % (i + 1)] = np.zeros(fout, np.float32)
    for fused in (True, False):
        path = "fused" if fused else "general"
        reads[0] = 0
        got, host_custom, took = custom_fit(torch, mt, "custom", fused,
                                            params, x, y)
        n_reads = reads[0]
        want, host_plain, took2 = custom_fit(torch, mt, "softmax_output",
                                             fused, params, x, y)
        nudge, _, _ = custom_fit(
            torch, mt, "softmax_output", fused,
            {k: v.astype(np.float32) for k, v in
             nudged_values(params, SEED + 41).items()}, x, y)
        if took != fused or took2 != fused:
            fail("custom %s: fused path taken %r/%r" % (path, took, took2))
        worst = 0.0
        for k in want:
            d = module_worst({k: got[k]}, {k: want[k]})[0]
            f = max(module_worst({k: nudge[k]}, {k: want[k]})[0],
                    RESNET_FLOOR_MIN)
            worst = max(worst, d / f)
            if d > RESNET_FLOOR_X * f or not np.isfinite(got[k]).all():
                fail("custom %s: %s is %.3g from SoftmaxOutput's fit, %.3g "
                     "x its float32 floor %.3g" % (path, k, d, d / f, f))
        weights = [k for k in params if k.endswith("_weight")]
        moved = module_worst({k: got[k] for k in weights},
                             {k: params[k] for k in weights})[0]
        print("custom mlp path=%s batch=%d batches=%d worst_x_floor=%.3f "
              "moved_max_rel=%.3g host_ms_per_batch custom=%r "
              "softmax_output=%r host_reads custom=%d (%.1f a batch) "
              "softmax_output=0 (%s)"
              % (path, CUSTOM_BATCH, CUSTOM_BATCHES, worst, moved,
                 host_custom, host_plain, n_reads,
                 n_reads / CUSTOM_BATCHES, card))
        if moved < 1e-3:
            fail("custom %s: the parameters did not move" % path)


def custom_block_check(torch, mt, card):
    """``chip_sqr`` (mx.nd ops on the card) inside a ResNet-style block
    under the NHWC pass: forward and every gradient, float32 on the card
    (TF32 off), within OPS_TOL of float64 on the CPU; one TrainStep step
    over the block with no host synchronisation."""
    S = mt.sym
    data = S.Variable("data")
    h = S.Activation(S.BatchNorm(data, fix_gamma=False, name="bn1"),
                     act_type="relu")
    h = S.Convolution(h, num_filter=16, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="conv1")
    h = S.Activation(S.BatchNorm(h, fix_gamma=False, name="bn2"),
                     act_type="relu")
    h = S.Custom(h, op_type="chip_sqr", name="sqr")
    h = S.Convolution(h, num_filter=16, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="conv2")
    body = h + data
    loss = S.MakeLoss(S.sum(body * body) * 1e-3)
    rng = np.random.default_rng(SEED + 42)
    names = loss.list_arguments()
    arg_shapes, _, _ = loss.infer_shape(data=CUSTOM_BLOCK)
    vals = {n: (rng.standard_normal(s) * (0.1 if "conv" in n else 1.0)
                + (1.0 if n.endswith("gamma") else 0.0))
            for n, s in zip(names, arg_shapes)}
    res = {}
    for ctx, dt in ((mt.cpu(), np.float64), (mt.gpu(0), np.float32)):
        ex = loss.simple_bind(ctx, grad_req="write",
                              type_dict={n: dt for n in names},
                              data=CUSTOM_BLOCK)
        for n, v in vals.items():
            ex.arg_dict[n][:] = v.astype(dt)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[dt] = (out, {n: ex.grad_dict[n].asnumpy() for n in names})
    worst = 0.0
    for n in names + ["output"]:
        got = res[np.float32][0] if n == "output" else res[np.float32][1][n]
        want = res[np.float64][0] if n == "output" \
            else res[np.float64][1][n]
        err = float(np.abs(got - want).max() / max(np.abs(want).max(),
                                                   1e-30))
        worst = max(worst, err)
        if err > OPS_TOL or not np.isfinite(got).all():
            fail("custom block: %s off by %.3g of its largest entry"
                 % (n, err))
    ts = mt.TrainStep(loss, mt.optimizer.SGD(learning_rate=0.01,
                                             momentum=0.9), ctx=mt.gpu(0))
    p, s, a = ts.init({"data": CUSTOM_BLOCK}, seed=SEED)
    batch = ts.shard_batch({"data": vals["data"].astype(np.float32)})
    ts(p, s, a, batch)
    sync_free(torch, "custom sqr block step", lambda: ts(p, s, a, batch))
    print("custom block (sqr in mx.nd ops, NHWC pass) %s: worst relative "
          "error against float64 %r over the output and %d gradients (tol "
          "%g; %s)" % (CUSTOM_BLOCK, worst, len(names), OPS_TOL, card))


def custom_phase(torch, mt, card):
    """The custom-op bridge on the card: the Custom softmax head against
    SoftmaxOutput, a device-side Custom op in a conv block, and
    bench/neural_style.py."""
    from mxnet_tpu_torch.bench import neural_style as ns
    reads = [0]
    custom_register(mt, reads)
    t0 = time.perf_counter()
    custom_mlp_check(torch, mt, reads, card)
    custom_block_check(torch, mt, card)
    print("custom ops seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    _, hist = ns.transfer(steps=STYLE_STEPS, ctx=mt.gpu(0))
    secs = time.perf_counter() - t0
    print("custom neural_style steps=%d loss first=%r last=%r seconds=%r "
          "(%s)" % (STYLE_STEPS, hist[0], hist[-1], secs, card))
    if not np.isfinite(hist).all() or not hist[-1] < hist[0]:
        fail("neural_style: the loss did not fall (%r -> %r)"
             % (hist[0], hist[-1]))


# --------------------------------------------------------------------- image
IMAGE_RECORDS = 320
IMAGE_RAW = (256, 341)        # the stored images: a short side of 256
IMAGE_LABELS = 10             # labels drawn from 10 of the 1000 classes
IMAGE_NOISE = 64              # each pixel: its class's colour +- this
IMAGE_BATCH = 32
IMAGE_THREADS = 8
IMAGE_FEED_EPOCHS = 2
IMAGE_LR = 0.1
IMAGE_SCALARS_EVERY = "1000000"   # no metric read inside a timed fit
CONSISTENCY_BLOCK = (8, 16, 28, 28)


def image_pack(mt, path, jpeg):
    """IMAGE_RECORDS synthetic IMAGE_RAW uint8 images from a seed (each its
    class's colour plus uniform noise of +-IMAGE_NOISE, so that a few steps
    can lower the loss), packed to ``path``.rec/.idx as pass-through
    records (or JPEG at quality 90); returns the seconds it took."""
    rio = mt.recordio
    rng = np.random.default_rng(SEED + 50)
    labels = rng.integers(0, IMAGE_LABELS, IMAGE_RECORDS)
    colours = rng.integers(IMAGE_NOISE, 256 - IMAGE_NOISE, (IMAGE_LABELS, 3))
    t0 = time.perf_counter()
    rec = rio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(IMAGE_RECORDS):
        img = (colours[labels[i]] + rng.integers(
            -IMAGE_NOISE, IMAGE_NOISE, IMAGE_RAW + (3,))).astype(np.uint8)
        header = rio.IRHeader(0, float(labels[i]), i, 0)
        rec.write_idx(i, rio.pack(header, mt.image.imencode(img, quality=90))
                      if jpeg else rio.pack_raw_img(header, img))
    rec.close()
    return time.perf_counter() - t0


def image_feed(it):
    """img/s of ``it`` alone over IMAGE_FEED_EPOCHS epochs, after the
    epoch its constructor started (the warm-up), and the batches' dtype."""
    dtype = None
    while True:
        try:
            dtype = it.next().data[0].dtype
        except StopIteration:
            break
    n = 0
    t0 = time.perf_counter()
    for _ in range(IMAGE_FEED_EPOCHS):
        it.reset()
        while True:
            try:
                n += it.next().data[0].shape[0]
            except StopIteration:
                break
    return n / (time.perf_counter() - t0), dtype


def image_fit(torch, mt, ti, args, net, it, params, aux, env, epochs):
    """``train_imagenet.fit`` on gpu(0) over ``it`` for ``epochs`` under
    ``env``, telemetry recording in memory on the fused path:
    {img_s and host_ms (epoch 0, the card's end of its first batch to its
    end of the last; the median gap between batch ends), data_wait_ms
    (the median of the fit loop's data_wait spans, first batch of each
    epoch left out), busy, device_ms, wall_ms (a torch.profiler window
    over epoch 1 after its first batch), peak_gb, losses, fused, batches,
    module}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    b = args.batch_size
    args.num_epochs = epochs
    ends = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def batch_end(param):
        e = ends.setdefault(param.epoch, [])
        last = param.nbatch == IMAGE_RECORDS // b - 1
        if param.nbatch == 0 or last:
            torch.cuda.synchronize()
        e.append(time.perf_counter())
        if param.epoch == epochs - 1 and epochs > 1:
            if param.nbatch == 0:
                prof.start()
                torch.cuda.synchronize()
                window["t0"] = time.perf_counter()
            elif last:
                window["wall"] = time.perf_counter() - window["t0"]
                prof.stop()

    waits = []

    def run():
        mt.telemetry.start()
        try:
            return ti.fit(args, net, mt.gpu(0), it=it,
                          arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                      for k, v in params.items()},
                          aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                                      for k, v in aux.items()},
                          batch_end_callback=batch_end)
        finally:
            waits.extend((e["tags"]["nbatch"], e["dur"] / 1e3)
                         for e in mt.telemetry.events()
                         if e.get("type") == "span"
                         and e["name"] == "data_wait")
            mt.telemetry.stop()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod, loss = module_env(dict(env, MXNET_TELEMETRY_FUSED="1",
                                MXNET_SCALARS_EVERY=IMAGE_SCALARS_EVERY),
                           run)
    e0 = ends[0]
    gaps = [(t1 - t0) * 1e3 for t0, t1 in zip(e0, e0[1:])]
    out = {"img_s": (len(e0) - 1) * b / (e0[-1] - e0[0]),
           "host_ms": obs_median(gaps),
           "data_wait_ms": obs_median([w for n, w in waits if n > 0]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": loss.values(), "module": mod,
           "fused": mod._fused_ts_cache is not None,
           "batches": sum(len(v) for v in ends.values())}
    if "wall" in window:
        kernels = [e for e in prof.key_averages() if is_kernel(e, DeviceType)]
        dev = sum(e.self_device_time_total for e in kernels) * 1e-3
        steps = len(ends[epochs - 1]) - 1
        out.update(device_ms=dev, wall_ms=window["wall"] * 1e3,
                   busy=dev / (window["wall"] * 1e3),
                   busy_unprofiled=dev / steps / (1e3 * b / out["img_s"]))
    if not np.isfinite(out["losses"]).all():
        fail("image fit: non-finite losses %r" % out["losses"])
    return out


def image_line(tag, r, nc_counts, card):
    print("image fit %s batch=%d batches=%d img_per_s=%r host_ms_per_batch=%r "
          "data_wait_ms_per_batch=%r device_busy_share=%r (device_ms=%r "
          "wall_ms=%r over epoch 1 under the profiler; its device ms a batch "
          "over epoch 0's unprofiled ms a batch %r) peak_mem_gb=%r loss "
          "first=%r last=%r fused=%s norm_conv_launches=%d "
          "with_statistics=%d (%s)"
          % (tag, IMAGE_BATCH, r["batches"], r["img_s"], r["host_ms"],
             r["data_wait_ms"], r.get("busy"), r.get("device_ms"),
             r.get("wall_ms"), r.get("busy_unprofiled"), r["peak_gb"],
             r["losses"][0], r["losses"][-1], r["fused"], nc_counts[0],
             nc_counts[1], card))


class _Recorded(object):
    """An iterator that hands on another's batches (and its reset) and
    keeps a host copy of each batch's data and label."""

    def __init__(self, it):
        self.it = it
        self.batch_size = it.batch_size
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label
        self.data, self.label = [], []

    def reset(self):
        self.it.reset()

    def __iter__(self):
        iter(self.it)
        return self

    def __next__(self):
        b = next(self.it)
        self.data.append(b.data[0].asnumpy())
        self.label.append(b.label[0].asnumpy())
        return b


def image_u8_net(mt):
    """ResNet-50 v2 on a Cast-to-float32 + affine prologue, as
    tools/bench_data.py composes it: uint8 pixels in, (x - 127.5) / 127.5
    on the card."""
    S = mt.sym
    prep = (S.Cast(S.Variable("data"), dtype="float32") - 127.5) * \
        (1.0 / 127.5)
    return mt.models.resnet.get_symbol(num_classes=CLASSES, num_layers=50,
                                       image_shape="3,%d,%d" % (IMAGE, IMAGE),
                                       data=prep)


def image_resnet(torch, mt, nc, ti, rec, card):
    """(a)-(e) of the image phase on ResNet-50 v2 at batch IMAGE_BATCH;
    returns the NormConv launches of the counted fits."""
    nb = IMAGE_RECORDS // IMAGE_BATCH
    args = imagenet_args(ti, "resnet50", IMAGE_BATCH, IMAGE_LR)
    args.data_train, args.data_train_idx = rec + ".rec", rec + ".idx"
    net, params, aux, x, y = obs_resnet(mt, IMAGE_BATCH, nb)
    raw = dict(resize=-1)
    u8 = dict(raw, dtype="uint8", mean_r=0.0, mean_g=0.0, mean_b=0.0)
    # (a) the iterator alone
    for tag, kw in (("float32", raw), ("uint8", u8)):
        ips, dt = image_feed(ti.record_iter(args, **kw))
        print("image feed dtype=%s batch=%d threads=%d img_per_s=%r "
              "batch_dtype=%s (pass-through records, %dx%d, resize=-1, "
              "rand_crop, rand_mirror; %s)"
              % (tag, IMAGE_BATCH, IMAGE_THREADS, ips, dt, IMAGE_RAW[0],
                 IMAGE_RAW[1], card))
    # (b) the fits: from records and the synthetic yardstick in turns
    # (records, synthetic, synthetic, records), knob on; records, knob off
    launches = 0
    fits = []
    for tag, knob, epochs in (("records", "1", 2), ("synthetic", "1", 2),
                              ("synthetic", "1", 1), ("records", "1", 1),
                              ("records", "0", 2)):
        it = ti.record_iter(args, **raw) if tag == "records" else \
            mt.io.NDArrayIter(x, y, batch_size=IMAGE_BATCH)
        nc.launches = nc.stats_launches = 0
        r = image_fit(torch, mt, ti, args, net, it, params, aux,
                      {"MXNET_NORM_CONV": knob}, epochs=epochs)
        counts = (nc.launches, nc.stats_launches)
        launches += counts[0]
        want = (RESNET_NC_PER_STEP * r["batches"],
                RESNET_NC_STATS_PER_STEP * r["batches"]) if knob == "1" \
            else (0, 0)
        image_line("%s MXNET_NORM_CONV=%s" % (tag, knob), r, counts, card)
        if counts != want or not r["fused"]:
            fail("image fit %s knob %s: NormConv launches %r (want %r), "
                 "fused %r" % (tag, knob, counts, want, r["fused"]))
        del r["module"]
        losses = r["losses"]
        if tag == "records" and epochs == 2 and \
                not np.mean(losses[-nb:]) < losses[0]:
            fail("image fit %s knob %s: the loss %r did not fall"
                 % (tag, knob, losses))
        fits.append(r)
        torch.cuda.empty_cache()
    for (rec1, syn1) in ((fits[0], fits[1]), (fits[3], fits[2])):
        print("image fit records/synthetic img_per_s=%r host_ms %r/%r "
              "data_wait_ms %r/%r (MXNET_NORM_CONV=1, in turns; %s)"
              % (rec1["img_s"] / syn1["img_s"], rec1["host_ms"],
                 syn1["host_ms"], rec1["data_wait_ms"], syn1["data_wait_ms"],
                 card))
    # (c) one thread: the fit from records against an NDArrayIter fit of
    # the batches the iterator yielded
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        recd = _Recorded(ti.record_iter(args, preprocess_threads=1, **raw))
        # knob off: NormConv's statistics epilogue sums with atomics, so
        # two fits through it differ in the last bits and then diverge
        env = {"MXNET_NORM_CONV": "0"}

        def fit_host(it):
            mod, _ = module_env(env, lambda: ti.fit(
                args, net, mt.gpu(0), it=it,
                batch_end_callback=lambda param: None,
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in params.items()},
                aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in aux.items()}))
            return module_host(mod)
        args.num_epochs = 1
        got = fit_host(recd)
        want = fit_host(mt.io.NDArrayIter(np.concatenate(recd.data),
                                          np.concatenate(recd.label),
                                          batch_size=IMAGE_BATCH))
        worst = max(module_worst(got[k], want[k]) for k in (0, 1))
        print("image one-thread fit from records vs NDArrayIter of its %d "
              "batches (MXNET_NORM_CONV=0, cuDNN deterministic): worst "
              "max_rel=%r (%s)" % (len(recd.data), worst[0], worst[1]))
        if len(recd.data) != nb or worst[0] != 0.0:
            fail("image (c): %d batches, not bitwise equal (%r at %s)"
                 % (len(recd.data), worst[0], worst[1]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    # (d) uint8 batches into a Cast + affine prologue
    ff = mt.module.module._FusedFit
    real_stage = ff._stage
    crossed = []

    def stage(self, batch):
        out = real_stage(self, batch)
        t = out._staged.tensors["data"]
        crossed.append((str(batch.data[0].value.dtype), str(t.dtype),
                        t.device.type, t.numel() * t.element_size()))
        return out
    ff._stage = stage
    try:
        nc.launches = nc.stats_launches = 0
        r = image_fit(torch, mt, ti, args, image_u8_net(mt),
                      ti.record_iter(args, **u8), params, aux,
                      {"MXNET_NORM_CONV": "1"}, epochs=1)
    finally:
        ff._stage = real_stage
    launches += nc.launches
    counts = (nc.launches, nc.stats_launches)
    image_line("uint8 MXNET_NORM_CONV=1", r, counts, card)
    print("image uint8 crossed (host dtype, staged dtype, device, bytes): "
          "%s x %d" % (sorted(set(crossed)), len(crossed)))
    if set(c[:3] for c in crossed) != {("torch.uint8", "torch.uint8",
                                        "cuda")} \
            or len(crossed) != nb or counts[0] != RESNET_NC_PER_STEP * nb:
        fail("image (d): batches crossed as %s, %d launches"
             % (sorted(set(crossed)), counts[0]))
    del r
    # (e) JPEG records at the example's resize, where PIL imports
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    print("image pil=%s" % ("present %s" % pil if pil else "absent"))
    if pil:
        jpeg = os.path.join(os.path.dirname(rec), "jpeg")
        secs = image_pack(mt, jpeg, jpeg=True)
        args.data_train, args.data_train_idx = jpeg + ".rec", jpeg + ".idx"
        ips, _ = image_feed(ti.record_iter(args))
        print("image feed jpeg dtype=float32 batch=%d threads=%d "
              "img_per_s=%r (resize=%d; packed in %r s; %s)"
              % (IMAGE_BATCH, IMAGE_THREADS, ips, IMAGE + 32, secs, card))
        nc.launches = nc.stats_launches = 0
        r = image_fit(torch, mt, ti, args, net, ti.record_iter(args),
                      params, aux, {"MXNET_NORM_CONV": "1"}, epochs=1)
        launches += nc.launches
        image_line("jpeg MXNET_NORM_CONV=1", r,
                   (nc.launches, nc.stats_launches), card)
        if nc.launches != RESNET_NC_PER_STEP * nb:
            fail("image (e): %d NormConv launches" % nc.launches)
    torch.cuda.empty_cache()
    return launches


def image_mlp_check(torch, mt, card):
    """(f): custom_softmax.py's MLP (784-128-64-10, batch 100) three ways
    on gpu(0), one epoch of SGD-momentum on the general path: split in two
    through SequentialModule, with a PythonLossModule head (grad_func
    softmax - onehot on the card), and as one Module; the first two held
    to the third, each parameter within RESNET_FLOOR_X times its float32
    floor (the one-Module fit's distance from its fit from nudged
    parameters)."""
    rng = np.random.default_rng(SEED + 60)
    n = CUSTOM_BATCH * CUSTOM_BATCHES
    x = rng.random((n, CUSTOM_FEATURES)).astype(np.float32)
    y = rng.integers(0, CUSTOM_CLASSES, n).astype(np.float32)
    dims = (CUSTOM_FEATURES,) + CUSTOM_HIDDEN + (CUSTOM_CLASSES,)
    params = {}
    for i, (fin, fout) in enumerate(zip(dims, dims[1:])):
        bound = np.sqrt(3.0 / fin)
        params["fc%d_weight" % (i + 1)] = rng.uniform(
            -bound, bound, (fout, fin)).astype(np.float32)
        params["fc%d_bias" % (i + 1)] = np.zeros(fout, np.float32)
    S = mt.sym

    def layers(h, first, last):
        for i in range(first, last):
            h = S.FullyConnected(h, name="fc%d" % (i + 1),
                                 num_hidden=dims[i + 1])
            if i < len(CUSTOM_HIDDEN):
                h = S.Activation(h, name="relu%d" % (i + 1),
                                 act_type="relu")
        return h
    grads_on = []

    def softmax_grad(scores, labels):
        s, lab = scores.value, labels.value
        grads_on.append((s.device.type, lab.device.type))
        p = torch.softmax(s, dim=1)
        p[torch.arange(p.shape[0], device=p.device), lab.long()] -= 1.0
        return mt.nd.NDArray(p)

    def module(first, last, head=False):
        h = layers(S.Variable("data"), first, last)
        if head:
            return mt.Module(S.SoftmaxOutput(h, name="softmax"),
                             context=mt.gpu(0))
        return mt.Module(h, label_names=None, context=mt.gpu(0))

    def build(kind):
        if kind == "module":
            return module(0, 3, head=True)
        seq = mt.mod.SequentialModule()
        if kind == "sequential":
            seq.add(module(0, 2))
            seq.add(module(2, 3, head=True), take_labels=True,
                    auto_wiring=True)
        else:
            seq.add(module(0, 3))
            seq.add(mt.mod.PythonLossModule(grad_func=softmax_grad),
                    take_labels=True, auto_wiring=True)
        return seq

    def fit(kind, start):
        mod = build(kind)
        t0 = time.perf_counter()
        module_env({"MXNET_FUSED_FIT": "0"}, lambda: mod.fit(
            mt.io.NDArrayIter(x, y, batch_size=CUSTOM_BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": CUSTOM_LR,
                                               "momentum": 0.9},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in start.items()}, aux_params={}))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        args, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in args.items()}, secs
    want, secs_m = fit("module", params)
    nudge, _ = fit("module", {k: v.astype(np.float32) for k, v in
                              nudged_values(params, SEED + 61).items()})
    for kind in ("sequential", "python_loss"):
        got, secs = fit(kind, params)
        worst = 0.0
        for k in want:
            d = module_worst({k: got[k]}, {k: want[k]})[0]
            f = max(module_worst({k: nudge[k]}, {k: want[k]})[0],
                    RESNET_FLOOR_MIN)
            worst = max(worst, d / f)
            if d > RESNET_FLOOR_X * f or not np.isfinite(got[k]).all():
                fail("image %s: %s is %.3g from the one-Module fit, %.3g x "
                     "its float32 floor %.3g" % (kind, k, d, d / f, f))
        print("image mlp %s batch=%d batches=%d worst_x_floor=%r "
              "fit_seconds=%r one_module_seconds=%r (%s)"
              % (kind, CUSTOM_BATCH, CUSTOM_BATCHES, worst, secs, secs_m,
                 card))
    if set(grads_on) != {("cuda", "cuda")} or len(grads_on) != \
            CUSTOM_BATCHES:
        fail("image python_loss: grad_func saw %s" % sorted(set(grads_on)))


def image_consistency_check(torch, mt, card):
    """(g): test_utils.check_consistency over [cpu(0), gpu(0)] on a
    Convolution -> BatchNorm -> Activation block, float32 both."""
    S = mt.sym
    block = S.Activation(S.BatchNorm(S.Convolution(
        S.Variable("data"), num_filter=CONSISTENCY_BLOCK[1], kernel=(3, 3),
        pad=(1, 1), name="conv"), fix_gamma=False, name="bn"),
        act_type="relu")
    gt = mt.test_utils.check_consistency(
        block, [{"ctx": mt.cpu(0), "data": CONSISTENCY_BLOCK},
                {"ctx": mt.gpu(0), "data": CONSISTENCY_BLOCK}])
    print("image test_utils.check_consistency [cpu(0), gpu(0)] conv-bn-relu "
          "%s: outputs and %d gradients within 1e-3 (%s)"
          % (CONSISTENCY_BLOCK, len(gt) - 1, card))


def image_phase(torch, mt, nc, card):
    """The image slice on the card: (a)-(e) ResNet-50 v2 from RecordIO,
    (f) SequentialModule and PythonLossModule, (g) check_consistency.
    The records go to a temporary directory, removed at the end.  Returns
    the NormConv launches of the phase's counted fits."""
    import tempfile
    from mxnet_tpu_torch.bench import train_imagenet as ti
    work = tempfile.mkdtemp(prefix="chip_smoke_image_")
    try:
        t0 = time.perf_counter()
        rec = os.path.join(work, "raw")
        secs = image_pack(mt, rec, jpeg=False)
        print("image pack %d pass-through records of %dx%d in %r s, %d "
              "bytes" % (IMAGE_RECORDS, IMAGE_RAW[0], IMAGE_RAW[1], secs,
                         os.path.getsize(rec + ".rec")))
        launches = image_resnet(torch, mt, nc, ti, rec, card)
        print("image resnet50 seconds=%r" % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        image_mlp_check(torch, mt, card)
        image_consistency_check(torch, mt, card)
        print("image modules seconds=%r" % (time.perf_counter() - t0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


CAPI_DEV_TYPE = 2          # MXNet's device type code of the card
CAPI_TURNS = 3
CAPI_TRAIN_BATCH = 32
CAPI_TRAIN_STEPS = 3
CAPI_FLOOR_SAMPLES = 2
CAPI_PARTIAL_OUTPUT = "stage3_unit1_relu1"
CAPI_HTTP_CLIENTS = 4
CAPI_HTTP_REQUESTS = 2
CAPI_MLP = (3, 32)         # mlp_predict's batch and input width
CAPI_EXAMPLES = ("mlp_predict", "lenet_train")


def capi_build(host):
    """The C API library, op.h and the cpp-package examples the capi phase
    runs, built from the checkout (g++; the generator embeds this
    interpreter); returns the library's compiler output."""
    import sysconfig
    inc = sysconfig.get_paths()["include"]
    print("capi python include=%s Python.h=%s LDLIBRARY=%s "
          "Py_ENABLE_SHARED=%s LIBDIR=%s"
          % (inc, os.path.exists(os.path.join(inc, "Python.h")),
             sysconfig.get_config_var("LDLIBRARY"),
             sysconfig.get_config_var("Py_ENABLE_SHARED"),
             sysconfig.get_config_var("LIBDIR")))
    t0 = time.perf_counter()
    log = host.build()
    print("capi library %s seconds=%r" % (os.path.basename(host.so_path()),
                                          time.perf_counter() - t0))
    t0 = time.perf_counter()
    host.op_h()
    print("capi op.h generated seconds=%r" % (time.perf_counter() - t0))
    for name in CAPI_EXAMPLES:
        t0 = time.perf_counter()
        host.example(name)
        print("capi example %s built seconds=%r"
              % (name, time.perf_counter() - t0))
    return log


def capi_check(lib, rc, what):
    if rc != 0:
        fail("capi %s: %s" % (what, lib.MXGetLastError().decode()))


def capi_pred(lib, sym_json, blob, shape, outputs=None):
    import ctypes
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint * 2)(0, len(shape))
    dims = (ctypes.c_uint * len(shape))(*shape)
    pred = ctypes.c_void_p()
    if outputs is None:
        rc = lib.MXPredCreate(sym_json, blob, len(blob), CAPI_DEV_TYPE, 0, 1,
                              keys, indptr, dims, ctypes.byref(pred))
    else:
        outs = (ctypes.c_char_p * len(outputs))(*[o.encode()
                                                  for o in outputs])
        rc = lib.MXPredCreatePartialOut(
            sym_json, blob, len(blob), CAPI_DEV_TYPE, 0, 1, keys, indptr,
            dims, len(outputs), outs, ctypes.byref(pred))
    capi_check(lib, rc, "MXPredCreate")
    return pred


def capi_pred_run(lib, pred, x, partial=False):
    """SetInput, Forward (or the PartialForward loop), GetOutput 0; returns
    (output, partial steps)."""
    import ctypes
    x = np.ascontiguousarray(x, np.float32)
    capi_check(lib, lib.MXPredSetInput(
        pred, b"data", x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint(x.size)), "MXPredSetInput")
    steps = 0
    if partial:
        left = ctypes.c_int(1)
        while left.value > 0:
            steps += 1
            capi_check(lib, lib.MXPredPartialForward(
                pred, steps, ctypes.byref(left)), "MXPredPartialForward")
    else:
        capi_check(lib, lib.MXPredForward(pred), "MXPredForward")
    sd = ctypes.POINTER(ctypes.c_uint)()
    ndim = ctypes.c_uint()
    capi_check(lib, lib.MXPredGetOutputShape(pred, 0, ctypes.byref(sd),
                                             ctypes.byref(ndim)),
               "MXPredGetOutputShape")
    shape = tuple(sd[i] for i in range(ndim.value))
    out = np.empty(shape, np.float32)
    capi_check(lib, lib.MXPredGetOutput(
        pred, 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint(out.size)), "MXPredGetOutput")
    return out, steps


def capi_predict(torch, mt, nc, lib, net, blob):
    """ResNet-50 through the C predict API on the card under the knob:
    52 launches a forward, the rows against the unfused Predictor, C and
    Python forwards timed in turns, the partial-out loop against
    ``Predictor(output_names=...)``.  Returns the NormConv launches."""
    shape = (BATCH, 3, IMAGE, IMAGE)
    images = np.random.default_rng(SEED + 60).uniform(
        -1, 1, shape).astype(np.float32)
    sym_json = net.tojson().encode()
    raw = mt.nd.serialize_arrays(blob)
    os.environ["MXNET_NORM_CONV"] = "1"
    pred = capi_pred(lib, sym_json, raw, shape)
    capi_pred_run(lib, pred, images)            # warm
    nc.launches = 0
    got, _ = capi_pred_run(lib, pred, images)
    launches = nc.launches
    print("capi MXPredForward batch=%d norm_conv_launches=%d"
          % (BATCH, launches))
    if launches != RESNET_NC_PER_STEP:
        fail("capi: %d NormConv launches in a C forward, want %d"
             % (launches, RESNET_NC_PER_STEP))
    os.environ["MXNET_NORM_CONV"] = "0"
    ref = mt.Predictor(net, blob, {"data": shape})
    ref.forward(data=images)
    want = ref.get_output(0)
    del ref
    if got.shape != (BATCH, CLASSES) or not np.isfinite(got).all():
        fail("capi rows: shape %s or non-finite" % (got.shape,))
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    print("capi MXPredForward check max_abs_diff=%r max_prob=%r "
          "tol=%g*max_prob argmax_agree=%d/%d"
          % (err, scale, SERVE_TOL, agree, BATCH))
    if err > SERVE_TOL * scale or agree != BATCH:
        fail("capi: C forward rows differ from the unfused Predictor")

    # the same forward through C and through Predictor, in turns
    os.environ["MXNET_NORM_CONV"] = "1"
    py = mt.Predictor(net, blob, {"data": shape})
    py.forward(data=images)
    py.get_output(0)
    times = {"c": [], "python": []}

    def once(kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "c":
            capi_pred_run(lib, pred, images)
        else:
            py.forward(data=images)
            py.get_output(0)
        times[kind].append((time.perf_counter() - t0) * 1e3)
    nc.launches = 0
    for _ in range(CAPI_TURNS):
        for kind in ("c", "python", "python", "c"):
            once(kind)
    launches += nc.launches
    print("capi forward_ms batch=%d c=%r python=%r (median of %d each, in "
          "turns; SetInput/set_input, forward and the output's host copy)"
          % (BATCH, float(np.median(times["c"])),
             float(np.median(times["python"])), 2 * CAPI_TURNS))
    capi_check(lib, lib.MXPredFree(pred), "MXPredFree")

    # partial out: one internal output, the PartialForward loop
    torch.backends.cudnn.deterministic = True
    try:
        part = capi_pred(lib, sym_json, raw, shape, [CAPI_PARTIAL_OUTPUT])
        nc.launches = 0
        feat, steps = capi_pred_run(lib, part, images, partial=True)
        part_launches = nc.launches
        pyp = mt.Predictor(net, blob, {"data": shape},
                           output_names=[CAPI_PARTIAL_OUTPUT])
        pyp.set_input("data", images)
        left = pyp.partial_forward(1)
        pyp.partial_forward(left + 1)
        fwant = pyp.get_output(0)
    finally:
        torch.backends.cudnn.deterministic = False
    capi_check(lib, lib.MXPredFree(part), "MXPredFree")
    launches += part_launches
    print("capi MXPredPartialForward output=%s shape=%s steps=%d "
          "norm_conv_launches=%d bitwise_equal=%s max_abs_diff=%r"
          % (CAPI_PARTIAL_OUTPUT, feat.shape, steps, part_launches,
             np.array_equal(feat, fwant), float(np.abs(feat - fwant).max())))
    if steps != left + 1 or steps < 2:
        fail("capi: the partial loop took %d steps, Predictor counts %d"
             % (steps, left + 1))
    if not np.array_equal(feat, fwant):
        fail("capi: partial output differs from Predictor(output_names=)")

    # cpu_pinned: an output copied to page-locked host memory
    out = py._outputs[0]
    pinned = out.copyto(mt.cpu_pinned())
    pageable = out.copyto(mt.cpu())
    print("capi cpu_pinned is_pinned=%s context=%s equal=%s"
          % (pinned.value.is_pinned(), pinned.context,
             np.array_equal(pinned.asnumpy(), pageable.asnumpy())))
    if not pinned.value.is_pinned() or \
            not np.array_equal(pinned.asnumpy(), pageable.asnumpy()):
        fail("capi: the cpu_pinned copy is not pinned or differs")
    del py, pyp
    return launches


def capi_c_steps(lib, net, state, batch):
    """CAPI_TRAIN_STEPS SGD-momentum steps through the C API on the card:
    MXExecutorBindEX, Forward(1), Backward, MXImperativeInvoke
    ("sgd_mom_update") a parameter, as the cpp-package's SGDOptimizer.
    Returns ({parameter or aux name: float64 torch tensor}, launches)."""
    import ctypes
    import torch
    from mxnet_tpu_torch.ops import norm_conv as nc
    H = ctypes.c_void_p
    params, _, aux, data = state
    arg_names = net.list_arguments()
    aux_names = net.list_auxiliary_states()
    arg_shapes, _, aux_shapes = net.infer_shape(
        data=(batch, 3, IMAGE, IMAGE), softmax_label=(batch,))
    sym = H()
    capi_check(lib, lib.MXSymbolCreateFromJSON(net.tojson().encode(),
                                               ctypes.byref(sym)),
               "MXSymbolCreateFromJSON")

    def create(shape, value=None):
        h = H()
        dims = (ctypes.c_uint * len(shape))(*shape)
        capi_check(lib, lib.MXNDArrayCreate(dims, len(shape), CAPI_DEV_TYPE,
                                            0, 0, ctypes.byref(h)),
                   "MXNDArrayCreate")
        v = np.zeros(shape, np.float32) if value is None else \
            np.ascontiguousarray(value, np.float32)
        capi_check(lib, lib.MXNDArraySyncCopyFromCPU(
            h, v.ctypes.data_as(ctypes.c_void_p), v.size),
            "MXNDArraySyncCopyFromCPU")
        return h

    def read(h, shape):
        out = np.empty(shape, np.float32)
        capi_check(lib, lib.MXNDArraySyncCopyToCPU(
            h, out.ctypes.data_as(ctypes.c_void_p), out.size),
            "MXNDArraySyncCopyToCPU")
        return out

    learn = [n for n in arg_names if n in params]
    vals = dict(params, **data)
    args = {n: create(s, vals[n]) for n, s in zip(arg_names, arg_shapes)}
    grads = {n: create(s) for n, s in zip(arg_names, arg_shapes)
             if n in params}
    auxs = {n: create(s, aux[n]) for n, s in zip(aux_names, aux_shapes)}
    moms = {n: create(dict(zip(arg_names, arg_shapes))[n]) for n in learn}
    ex = H()
    n_arg = len(arg_names)
    capi_check(lib, lib.MXExecutorBindEX(
        sym, CAPI_DEV_TYPE, 0, 0, None, None, None, n_arg,
        (H * n_arg)(*[args[n] for n in arg_names]),
        (H * n_arg)(*[grads.get(n) for n in arg_names]),
        (ctypes.c_uint * n_arg)(*[1 if n in grads else 0
                                  for n in arg_names]),
        len(aux_names), (H * len(aux_names))(*[auxs[n] for n in aux_names]),
        None, ctypes.byref(ex)), "MXExecutorBindEX")
    creators = ctypes.POINTER(H)()
    count = ctypes.c_uint()
    capi_check(lib, lib.MXSymbolListAtomicSymbolCreators(
        ctypes.byref(count), ctypes.byref(creators)), "ListCreators")
    name = ctypes.c_char_p()
    sgd = None
    for i in range(count.value):
        capi_check(lib, lib.MXSymbolGetAtomicSymbolName(
            H(creators[i]), ctypes.byref(name)), "GetAtomicSymbolName")
        if name.value == b"sgd_mom_update":
            sgd = H(creators[i])
    if sgd is None:
        fail("capi: no sgd_mom_update creator")
    keys = (ctypes.c_char_p * 4)(b"lr", b"wd", b"momentum", b"rescale_grad")
    cvals = (ctypes.c_char_p * 4)(*[repr(v).encode() for v in (
        RESNET_LR, 0.0, 0.9, 1.0 / batch)])
    nc.launches = nc.stats_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAPI_TRAIN_STEPS):
        capi_check(lib, lib.MXExecutorForward(ex, 1), "MXExecutorForward")
        capi_check(lib, lib.MXExecutorBackward(ex, 0, None),
                   "MXExecutorBackward")
        for n in learn:
            ins = (H * 3)(args[n], grads[n], moms[n])
            io = (H * 2)(args[n], moms[n])
            outs = ctypes.cast(io, ctypes.POINTER(H))
            n_out = ctypes.c_int(2)
            capi_check(lib, lib.MXImperativeInvoke(
                sgd, 3, ins, ctypes.byref(n_out), ctypes.byref(outs), 4,
                keys, cvals), "MXImperativeInvoke(sgd_mom_update)")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = (nc.launches, nc.stats_launches)
    shapes = dict(zip(arg_names, arg_shapes), **dict(zip(aux_names,
                                                         aux_shapes)))
    got = {n: torch.from_numpy(read(args[n], shapes[n]).astype(np.float64))
           for n in learn}
    got.update({n: torch.from_numpy(read(auxs[n], shapes[n])
                                    .astype(np.float64)) for n in aux_names})
    capi_check(lib, lib.MXExecutorFree(ex), "MXExecutorFree")
    for h in list(args.values()) + list(grads.values()) + \
            list(auxs.values()) + list(moms.values()):
        capi_check(lib, lib.MXNDArrayFree(h), "MXNDArrayFree")
    capi_check(lib, lib.MXSymbolFree(sym), "MXSymbolFree")
    return got, counts, secs


def capi_py_steps(mt, net, state, batch):
    """The same steps driven from Python on the card: ``bind``,
    ``forward(is_train=True)``, ``backward()``, ``nd.sgd_mom_update`` a
    parameter; returns {parameter or aux name: float64 torch tensor}."""
    import torch
    params, _, aux, data = state
    ctx = mt.gpu(0)
    vals = dict(params, **data)
    arg_names = net.list_arguments()
    args = {n: mt.nd.array(vals[n].astype(np.float32), ctx=ctx)
            for n in arg_names}
    grads = {n: mt.nd.zeros(args[n].shape, ctx=ctx) for n in params}
    moms = {n: mt.nd.zeros(args[n].shape, ctx=ctx) for n in params}
    auxs = {n: mt.nd.array(v.astype(np.float32), ctx=ctx)
            for n, v in aux.items()}
    ex = net.bind(ctx, args, args_grad=grads,
                  grad_req={n: "write" if n in params else "null"
                            for n in arg_names}, aux_states=auxs)
    learn = [n for n in arg_names if n in params]
    for _ in range(CAPI_TRAIN_STEPS):
        ex.forward(is_train=True)
        ex.backward()
        for n in learn:
            mt.nd.sgd_mom_update(args[n], grads[n], moms[n],
                                 out=[args[n], moms[n]], lr=RESNET_LR,
                                 wd=0.0, momentum=0.9,
                                 rescale_grad=1.0 / batch)
    out = {n: torch.from_numpy(args[n].asnumpy().astype(np.float64))
           for n in learn}
    out.update({n: torch.from_numpy(v.asnumpy().astype(np.float64))
                for n, v in auxs.items()})
    return out


def capi_train(torch, mt, lib, net):
    """Three training steps at CAPI_TRAIN_BATCH through the C executor on
    the card with the knob on, held to the same steps driven from Python
    by the float32 floor rule; 52 launches a step, 32 with statistics.
    Returns the NormConv launches."""
    batch = CAPI_TRAIN_BATCH
    state = resnet50_state(mt, net, batch, IMAGE)
    os.environ["MXNET_NORM_CONV"] = "1"
    got, (launches, stats), secs = capi_c_steps(lib, net, state, batch)
    print("capi executor steps=%d batch=%d norm_conv_launches=%d "
          "with_statistics=%d host_s=%r"
          % (CAPI_TRAIN_STEPS, batch, launches, stats, secs))
    if launches != RESNET_NC_PER_STEP * CAPI_TRAIN_STEPS or \
            stats != RESNET_NC_STATS_PER_STEP * CAPI_TRAIN_STEPS:
        fail("capi: %d launches (%d with statistics) in %d C steps, want "
             "%d (%d) a step" % (launches, stats, CAPI_TRAIN_STEPS,
                                 RESNET_NC_PER_STEP,
                                 RESNET_NC_STATS_PER_STEP))
    torch.cuda.empty_cache()
    want = capi_py_steps(mt, net, state, batch)
    floors = [capi_py_steps(mt, net, nudged(state, SEED + 300 + i), batch)
              for i in range(CAPI_FLOOR_SAMPLES)]
    floor_summary(torch, "capi_executor", got, want, floors)
    moved = max(float((want[n] - torch.from_numpy(
        state[0][n])).abs().max()) for n in state[0])
    print("capi executor largest parameter move=%r" % moved)
    if not moved > 0:
        fail("capi: the steps moved no parameter")
    torch.cuda.empty_cache()
    return launches


def capi_cpp_package(mt, host):
    """mlp_predict and lenet_train (built in the build phase) run against
    the port's library on the box's CPU: mlp_predict's argmax rows are the
    Predictor's and its feature path runs; lenet_train prints PASS."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_capi_")
    try:
        batch, dim = CAPI_MLP
        net = mt.models.get_mlp(num_classes=4)
        arg_shapes, _, _ = net.infer_shape(data=(batch, dim))
        # a seed whose three rows take two different argmaxes, so that
        # the check tells rows apart
        rng = np.random.default_rng(SEED + 72)
        params = {"arg:" + n: (rng.uniform(-1, 1, s) * np.sqrt(
            3.0 / (s[1] if len(s) > 1 else 1))).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
        prefix = os.path.join(work, "mlp")
        with open(prefix + "-symbol.json", "w") as f:
            f.write(net.tojson())
        mt.nd.save(prefix + "-0004.params", params)
        x = (np.arange(batch * dim) % 7 * 0.25 - 0.75).astype(np.float32)
        ref = mt.Predictor.from_checkpoint(prefix, 4, {"data": (batch, dim)},
                                           dev_type="cpu")
        ref.forward(data=x.reshape(batch, dim))
        want = [int(v) for v in ref.get_output(0).argmax(1)]
        n, h = 256, 12
        rs = np.random.RandomState(0)
        y = rs.randint(0, 2, n)
        img = rs.randn(n, 1, h, h).astype(np.float32) * 0.4
        img[y == 1, 0, 3:9, 3:9] += 1.5
        dcsv, lcsv = os.path.join(work, "d.csv"), os.path.join(work, "l.csv")
        np.savetxt(dcsv, img.reshape(n, -1), delimiter=",", fmt="%.5f")
        np.savetxt(lcsv, y.astype(np.float32), delimiter=",", fmt="%g")
        runs = {"mlp_predict": [prefix, "4", str(batch), str(dim)],
                "lenet_train": [dcsv, lcsv, "32", "8"]}
        # both examples at once (each embeds Python and imports the port
        # first: most of its seconds)
        done = {}

        def run(name):
            t0 = time.perf_counter()
            done[name] = (subprocess.run(
                [host.example(name)] + runs[name], capture_output=True,
                text=True, env=host.run_env(), timeout=300),
                time.perf_counter() - t0)
        threads = [threading.Thread(target=run, args=(n,))
                   for n in CAPI_EXAMPLES]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for name in CAPI_EXAMPLES:
            if name not in done:
                fail("capi: %s did not run" % name)
            res, secs = done[name]
            lines = res.stdout.strip().splitlines()
            print("capi cpp-package %s rc=%d seconds=%r last=%r"
                  % (name, res.returncode, secs, lines[-1] if lines else ""))
            if res.returncode != 0:
                fail("capi: %s failed: %s%s" % (name, res.stdout[-2000:],
                                                res.stderr[-2000:]))
            if name == "mlp_predict":
                import re
                rows = [int(m) for m in re.findall(r"row \d+ argmax (\d+)",
                                                   res.stdout)]
                print("capi cpp-package mlp_predict argmax=%s predictor=%s "
                      "features_ok=%s" % (rows, want,
                                          "FEATURES OK" in res.stdout))
                if rows != want or len(set(rows)) < 2 or \
                        "FEATURES OK" not in res.stdout:
                    fail("capi: mlp_predict rows or features wrong")
            elif "PASS" not in res.stdout:
                fail("capi: lenet_train did not print PASS")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def capi_http(torch, mt, nc, net, blob, serving_numbers):
    """ResNet-50 behind the HTTP front end: a ServedModel on
    ``default_server()``, ``start_server(port=0)``, CAPI_HTTP_CLIENTS
    clients posting CAPI_HTTP_REQUESTS JSON requests each; the rows
    against the in-process ServedModel's; /healthz and /models answer 200.
    Returns the NormConv launches."""
    import urllib.request
    shape = (3, IMAGE, IMAGE)
    n_req = CAPI_HTTP_CLIENTS * CAPI_HTTP_REQUESTS
    images = np.random.default_rng(SEED + 80).uniform(
        -1, 1, (n_req,) + shape).astype(np.float32)
    os.environ["MXNET_NORM_CONV"] = "1"
    nc.launches = 0
    model = mt.serving.ServedModel(net, blob, {"data": shape},
                                   name="resnet50", max_batch=BATCH)
    server = mt.serving.default_server()
    server.register("resnet50", model)
    port = mt.serving.start_server(port=0)
    base = "http://127.0.0.1:%d" % port
    rows = [None] * n_req
    lat = [None] * n_req
    errors = []
    try:
        model.warm(timeout=600)
        body = json.dumps({"inputs": {"data": images[0].tolist()}}).encode()
        t0 = time.perf_counter()
        json.dumps({"inputs": {"data": images[0].tolist()}})
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        np.asarray(json.loads(body)["inputs"]["data"], np.float32)
        dec_ms = (time.perf_counter() - t0) * 1e3
        print("capi http request body bytes=%d json_encode_ms=%r "
              "json_decode_ms=%r (one image, host)" % (len(body), enc_ms,
                                                       dec_ms))

        def client(c):
            try:
                for j in range(CAPI_HTTP_REQUESTS):
                    i = c * CAPI_HTTP_REQUESTS + j
                    data = json.dumps(
                        {"inputs": {"data": images[i].tolist()}}).encode()
                    t1 = time.perf_counter()
                    req = urllib.request.Request(
                        base + "/predict/resnet50", data=data,
                        headers={"Content-Type": "application/json"})
                    doc = json.loads(urllib.request.urlopen(
                        req, timeout=600).read())
                    lat[i] = time.perf_counter() - t1
                    rows[i] = np.asarray(doc["outputs"][0], np.float32)
            except Exception as exc:   # reported below; the phase fails
                errors.append(repr(exc))
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CAPI_HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        codes = {}
        for route in ("/healthz", "/models"):
            with urllib.request.urlopen(base + route, timeout=60) as r:
                codes[route] = r.status
        stats = model.stats()
        launches = nc.launches
        if errors or any(r is None for r in rows):
            fail("capi http: not every request was answered: %s" % errors)
        want = np.stack([model.predict({"data": images[i]}, timeout=600)[0]
                         for i in range(n_req)])
    finally:
        mt.serving.stop_server()
        server.unregister("resnet50")
    got = np.stack(rows)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    forwards = len(model.buckets) + stats["batches"]
    print("capi http requests=%d batches=%d by_bucket=%s codes=%s "
          "norm_conv_launches=%d forwards=%d"
          % (stats["requests"], stats["batches"], stats["batches_by_bucket"],
             codes, launches, forwards))
    print("capi http check max_abs_diff=%r max_prob=%r tol=%g*max_prob "
          "argmax_agree=%d/%d" % (err, scale, SERVE_TOL, agree, n_req))
    if any(c != 200 for c in codes.values()):
        fail("capi http: %s" % codes)
    if launches != RESNET_NC_PER_STEP * forwards:
        fail("capi http: %d launches != %d x %d forwards"
             % (launches, RESNET_NC_PER_STEP, forwards))
    if not np.isfinite(got).all() or err > SERVE_TOL * scale or \
            agree != n_req:
        fail("capi http: rows differ from the in-process ServedModel")
    lat_ms = np.array(lat) * 1e3
    print("capi http qps=%r p50_ms=%r p99_ms=%r (%d requests, %d clients, "
          "JSON over HTTP) beside in-process serving qps=%r p50_ms=%r "
          "p99_ms=%r" % (n_req / wall, float(np.percentile(lat_ms, 50)),
                         float(np.percentile(lat_ms, 99)), n_req,
                         CAPI_HTTP_CLIENTS, serving_numbers["qps"],
                         serving_numbers["p50_ms"],
                         serving_numbers["p99_ms"]))
    return launches


def capi_phase(torch, mt, nc, host, serving_numbers):
    """The inference extras: ResNet-50 through the C predict API and the C
    executor, the cpp-package on the box, the HTTP front end, cpu_pinned.
    Returns the NormConv launches of the phase."""
    net = mt.models.resnet.get_symbol(CLASSES, 50, "3,%d,%d" % (IMAGE, IMAGE))
    blob = resnet50_params(mt, net)
    lib = host.get()      # loaded into this process, which it embeds
    t0 = time.perf_counter()
    launches = capi_predict(torch, mt, nc, lib, net, blob)
    print("capi predict seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    launches += capi_train(torch, mt, lib, net)
    print("capi train seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    launches += capi_http(torch, mt, nc, net, blob, serving_numbers)
    print("capi http seconds=%r" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    capi_cpp_package(mt, host)
    print("capi cpp-package seconds=%r" % (time.perf_counter() - t0))
    os.environ["MXNET_NORM_CONV"] = "0"
    return launches

DIST_RANKS = 2
DIST_BATCH = 16            # a rank's batch: 32 a step over both ranks
DIST_BATCHES = 3
DIST_LR = 0.1
DIST_LAUNCH_S = 420        # the limit of one launch of the ranks
DIST_ROUTE = "gloo-cuda"   # two ranks on one card
DIST_NCCL_SIZES = ((25557032, "float32"), (4097, "float32"),
                   (1000, "float64"))
ELASTIC_BATCH = 32
ELASTIC_BATCHES = 4
ELASTIC_EVERY = 2


def dist_launch(label, args, timeout, env=None):
    """Run ``args`` in a session of its own (the launcher and its ranks),
    killing the whole group at ``timeout``; (rc, stdout, stderr)."""
    full = dict(os.environ)
    full.update(env or {})
    full["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in full.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=ROOT, env=full, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        fail("dist: %s timed out after %d s\n%s\n%s"
             % (label, timeout, out[-3000:], err[-3000:]))
    print("dist launch %s seconds=%r rc=%d"
          % (label, time.perf_counter() - t0, proc.returncode))
    return proc.returncode, out, err


def dist_ranks(work, module, *args, env=None):
    """The port's launcher with DIST_RANKS ranks of ``python -m module``;
    each rank's JSON report."""
    rc, out, err = dist_launch(
        module.rsplit(".", 1)[1],
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n",
         str(DIST_RANKS), sys.executable, "-m", module, "--out", work]
        + list(args), DIST_LAUNCH_S, env)
    if rc != 0:
        fail("dist: %s exited %d\n%s\n%s" % (module, rc, out[-4000:],
                                             err[-4000:]))
    rows = []
    for r in range(DIST_RANKS):
        with open(os.path.join(work, "rank%d.json" % r)) as f:
            rows.append(json.load(f))
    return rows


def dist_leaves(mt, path):
    """{name: numpy} of a rank's saved parameters and aux states."""
    raw = mt.nd.load(path, ctx=mt.cpu())
    return {k: v.asnumpy() for k, v in raw.items()}


def dist_worst(got, want, floors):
    """(largest max |got - want| over RESNET_FLOOR_X x the leaf's floor,
    its leaf)."""
    worst = (0.0, None)
    for n, w in want.items():
        r = float(np.abs(got[n] - w).max()) / (RESNET_FLOOR_X * floors[n])
        if r > worst[0]:
            worst = (r, n)
    return worst


def dist_two_contexts(mt, net, args, aux, x, y, ctx, env, nudge=None):
    """The one-process fit the ranks are held to: ``Module`` over [ctx,
    ctx] with the device store, batches of DIST_RANKS x DIST_BATCH whose
    slice k is rank k's batch; returns ({"arg:n"/"aux:n": numpy} with
    context 0's moving statistics, host ms a batch)."""
    n = x.shape[0] // DIST_RANKS
    order = np.concatenate([
        np.arange(r * n + i * DIST_BATCH, r * n + (i + 1) * DIST_BATCH)
        for i in range(DIST_BATCHES) for r in range(DIST_RANKS)])
    if nudge is not None:
        rng = np.random.default_rng(SEED + 21)
        args = {k: (v * (1 + nudge * rng.uniform(-1, 1, v.shape))).astype(
            np.float32) for k, v in args.items()}
    mod = mt.Module(net, context=[ctx] * DIST_RANKS)
    marks = []
    module_env(env, lambda: mod.fit(
        mt.io.NDArrayIter(x[order], y[order],
                          batch_size=DIST_RANKS * DIST_BATCH),
        num_epoch=1, kvstore="device", optimizer="sgd",
        optimizer_params={"learning_rate": DIST_LR, "momentum": 0.9},
        arg_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in
                    args.items()},
        aux_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in aux.items()},
        batch_end_callback=lambda p: marks.append(time.perf_counter())))
    out = {"arg:" + k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    out.update({"aux:" + k: v.asnumpy() for k, v in
                mod._exec_group.execs[0].aux_dict.items()})
    return out, float(np.median(np.diff(marks))) * 1e3


NCCL_WORLD1 = r"""
import json, socket, sys, time, torch
from mxnet_tpu_torch.parallel import dist
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
dist._connect("localhost:%d" % port, 1, 0)
sizes = json.loads(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(0)
ts = [torch.randn(n, generator=g, device="cuda").to(getattr(torch, dt))
      for n, dt in sizes]
outs = dist.bucket_allreduce(ts)
torch.cuda.synchronize()
equal = all(torch.equal(a, b) for a, b in zip(ts, outs))
calls = dist.collective_calls["all_reduce"]    # one a dtype: 2
ms = []
for _ in range(5):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    dist.bucket_allreduce(ts); torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"route": dist.route(), "equal": equal,
                  "calls": calls, "ms": sorted(ms)[2],
                  "bytes": sum(t.numel() * t.element_size() for t in ts)}))
dist.shutdown_process_group()
"""


def elastic_fit(torch, mt, net, args, aux, x, y, prefix, ctx, env,
                stop_after=None):
    """``fit_elastic`` of a fresh Module on ``ctx`` over (x, y) in batches
    of ELASTIC_BATCH from (args, aux); the data stop (an exception from
    the iterator) after ``stop_after`` batches.  Returns (the module's
    {"arg:"/"aux:" name: numpy} or None when stopped, step ms,
    the Checkpointers' save and write seconds).  The step ms is the mean
    gap between batch ends, so the saves' blocking time is spread over
    the steps."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.parallel import elastic

    class Stop(RuntimeError):
        pass

    class Feed(mt.io.NDArrayIter):
        def next(self):
            self._served = getattr(self, "_served", 0) + 1
            if stop_after is not None and self._served > stop_after:
                raise Stop("the data stop after %d batches" % stop_after)
            return super().next()
    saves, writes = [], []
    real_save, real_write = ck.Checkpointer.save, ck.Checkpointer._write

    def save(self, *a, **kw):
        out = real_save(self, *a, **kw)
        saves.append(self.last_save_seconds)
        return out

    def write(self, job):
        real_write(self, job)
        writes.append(self.last_write_seconds)
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod = mt.Module(net, context=ctx)
    marks = []
    ck.Checkpointer.save, ck.Checkpointer._write = save, write
    try:
        module_env(env, lambda: elastic.fit_elastic(
            mod, Feed(x, y, batch_size=ELASTIC_BATCH), prefix, num_epoch=1,
            optimizer="sgd",
            optimizer_params={"learning_rate": RESNET_LR, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in args.items()},
            aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in aux.items()},
            batch_end_callback=lambda p: marks.append(time.perf_counter())))
        out = {"arg:" + k: v.asnumpy()
               for k, v in mod.get_params()[0].items()}
        out.update({"aux:" + k: v.asnumpy()
                    for k, v in mod.get_params()[1].items()})
    except Stop:
        out = None
    finally:
        ck.Checkpointer.save, ck.Checkpointer._write = real_save, real_write
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    # the mean gap between batch ends: a save lands in one gap of two
    step_ms = float(np.mean(np.diff(marks))) * 1e3 if len(marks) > 1 \
        else None
    return out, step_ms, saves, writes


def dist_phase(torch, mt, nc, card):
    """(a)-(d) of the dist phase (see the docstring); ``card`` False runs
    it on the host (a rehearsal at toy sizes).  Returns the NormConv
    launches counted in the phase (the ranks' reports and this process's
    fits)."""
    import tempfile
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.bench import dist_mlp
    from mxnet_tpu_torch.parallel import dist
    ctx = mt.gpu(0) if card else mt.cpu()
    kind = "gpu" if card else "cpu"
    launches = 0
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # (a) the dist_sync arithmetic on the card's tensors
        wa = os.path.join(work, "a")
        os.makedirs(wa)
        rows = dist_ranks(wa, "mxnet_tpu_torch.bench.dist_sync_kvstore",
                          "--ctx", kind)
        for r in rows:
            print("dist kvstore rank=%d world=%d route=%s device=%s "
                  "push_ms=%r allreduce_calls=%d checks=%s"
                  % (r["rank"], r["world"], r["route"], r["device"],
                     r["push_ms"], r["allreduce_calls"],
                     json.dumps(r["checks"], sort_keys=True)))
            if not r["ok"] or r["world"] != DIST_RANKS:
                fail("dist (a): rank %d failed %s" % (r["rank"], r))
            if card and (r["route"] != DIST_ROUTE
                         or not r["device"].startswith("cuda")):
                fail("dist (a): route %s on %s, expected %s on the card"
                     % (r["route"], r["device"], DIST_ROUTE))

        # (b) ResNet-50 through Module.fit(kvstore="dist_sync")
        net = mt.models.resnet.get_symbol(CLASSES, 50,
                                          "3,%d,%d" % (IMAGE, IMAGE))
        ts0 = mt.TrainStep(net, mt.optimizer.SGD(), ctx=mt.cpu())
        p0, _, a0 = ts0.init({"data": (DIST_BATCH, 3, IMAGE, IMAGE)},
                             {"softmax_label": (DIST_BATCH,)}, seed=SEED)
        args = {k: v.numpy() for k, v in p0.items()}
        aux = {k: v.numpy() for k, v in a0.items()}
        nkeys = len(args)              # one push a parameter a step
        del ts0, p0, a0
        init = os.path.join(work, "init.params")
        mt.nd.save(init, dict(
            [("arg:" + k, mt.nd.array(v, ctx=mt.cpu()))
             for k, v in args.items()]
            + [("aux:" + k, mt.nd.array(v, ctx=mt.cpu()))
               for k, v in aux.items()]))
        wb = os.path.join(work, "b")
        os.makedirs(wb)
        if card:
            torch.cuda.empty_cache()
        rows = dist_ranks(wb, "mxnet_tpu_torch.bench.dist_mlp", "--network",
                          "resnet50", "--ctx", kind, "--batch",
                          str(DIST_BATCH), "--batches", str(DIST_BATCHES),
                          "--epochs", "1", "--lr", str(DIST_LR), "--image",
                          str(IMAGE), "--classes", str(CLASSES), "--params",
                          init, env={"MXNET_NORM_CONV": "1"})
        for r in rows:
            print("dist resnet50 rank=%d route=%s steps=%d img_per_s=%r "
                  "host_ms_per_batch=%r update_ms_per_batch=%r "
                  "collective_ms_per_batch=%r "
                  "collective_calls=%d push_alone_ms=%r keys=%d "
                  "norm_conv=%d stats=%d"
                  % (r["rank"], r["route"], r["steps"], r.get("img_per_s"),
                     r.get("host_ms_per_batch"), r["update_ms_per_batch"],
                     r["collective_ms_per_batch"], r["collective_calls"],
                     r["push_alone_ms"], r["keys"], r["nc_launches"],
                     r["nc_stats_launches"]))
            launches += r["nc_launches"]
            if r["steps"] != DIST_BATCHES or not r["ok"]:
                fail("dist (b): rank %d ran %d steps, checks %s"
                     % (r["rank"], r["steps"], r["checks"]))
            if card and (r["nc_launches"] != RESNET_NC_PER_STEP * r["steps"]
                         or r["nc_stats_launches"]
                         != RESNET_NC_STATS_PER_STEP * r["steps"]):
                fail("dist (b): rank %d launched NormConv %d times (%d with "
                     "statistics) in %d steps" % (
                         r["rank"], r["nc_launches"],
                         r["nc_stats_launches"], r["steps"]))
            if r["keys"] != nkeys or \
                    r["collective_calls"] != nkeys * r["steps"]:
                fail("dist (b): rank %d: %d keys, %d collectives, expected "
                     "one a key (%d) a step" % (r["rank"], r["keys"],
                                                r["collective_calls"], nkeys))
        got = [dist_leaves(mt, os.path.join(wb, "rank%d.params" % r))
               for r in range(DIST_RANKS)]
        same = all(np.array_equal(got[0][k], got[1][k])
                   for k in got[0] if k.startswith("arg:"))
        print("dist resnet50 replicas bitwise equal=%s" % same)
        if not same:
            fail("dist (b): the ranks' parameters differ")
        x, y = dist_mlp.images(DIST_BATCH, DIST_BATCHES, DIST_RANKS, IMAGE,
                               CLASSES)
        env = {"MXNET_NORM_CONV": "1"}
        nc.launches = nc.stats_launches = 0
        want, one_ms = dist_two_contexts(mt, net, args, aux, x, y, ctx, env)
        nudged_, _ = dist_two_contexts(mt, net, args, aux, x, y, ctx, env,
                                       nudge=RESNET_FLOOR_NUDGE)
        launches += nc.launches
        floors = {k: max(float(np.abs(nudged_[k] - w).max()),
                         RESNET_FLOOR_MIN) for k, w in want.items()}
        worst = dist_worst(got[0], want, floors)
        one_img_s = DIST_RANKS * DIST_BATCH * 1e3 / one_ms
        print("dist resnet50 against the two-context device-store fit: "
              "worst %r of RESNET_FLOOR_X x floor (%s), leaves=%d; one "
              "process img_per_s=%r host_ms_per_batch=%r; two ranks "
              "img_per_s=%r (%rx)"
              % (worst[0], worst[1], len(want), one_img_s, one_ms,
                 rows[0].get("img_per_s"),
                 (rows[0].get("img_per_s") or 0) / one_img_s))
        if worst[0] > 1.0:
            fail("dist (b): %s beyond RESNET_FLOOR_X x its floor (%r)"
                 % (worst[1], worst[0]))

        # (c) the bucketed collective at world 1 over NCCL
        if card:
            rc, out, err = dist_launch(
                "nccl_world1", [sys.executable, "-c", NCCL_WORLD1,
                 json.dumps(DIST_NCCL_SIZES)], 300)
            res = json.loads(out.strip().splitlines()[-1]) if rc == 0 \
                else None
            print("dist nccl world=1 %s" % json.dumps(res, sort_keys=True))
            if res is None or res["route"] != "nccl" or not res["equal"] \
                    or res["calls"] != 2:
                fail("dist (c): %s\n%s" % (out[-2000:], err[-2000:]))

        # (d) fit_elastic: step checkpoints and the resume, fused
        if card:
            torch.cuda.empty_cache()
        rng = np.random.default_rng(SEED + 31)
        n = ELASTIC_BATCH * ELASTIC_BATCHES
        ex = rng.uniform(-1, 1, (n, 3, IMAGE, IMAGE)).astype(np.float32)
        ey = rng.integers(0, CLASSES, n).astype(np.float32)
        every = {"MXNET_NORM_CONV": "1",
                 "MXNET_CKPT_EVERY_N_STEPS": str(ELASTIC_EVERY)}
        off = {"MXNET_NORM_CONV": "1", "MXNET_CKPT_EVERY_N_STEPS": None}
        nc.launches = 0
        full, ms_on, saves, writes = elastic_fit(
            torch, mt, net, args, aux, ex, ey, os.path.join(work, "e1/m"),
            ctx, every)
        _, ms_off, _, _ = elastic_fit(torch, mt, net, args, aux, ex, ey,
                                      os.path.join(work, "e2/m"), ctx, off)
        nudge_rng = np.random.default_rng(SEED + 41)
        nargs = {k: (v * (1 + RESNET_FLOOR_NUDGE * nudge_rng.uniform(
            -1, 1, v.shape))).astype(np.float32) for k, v in args.items()}
        nudged_e, _, _, _ = elastic_fit(torch, mt, net, nargs, aux, ex, ey,
                                        os.path.join(work, "e3/m"), ctx,
                                        off)
        path = ck.latest_sharded(os.path.join(work, "e1/m"))
        man = ck.verify_checkpoint(path)
        nbytes = sum(m["bytes"] for m in man["shards"].values())
        print("dist elastic checkpoint %s bytes=%d save_ms=%s writer_ms=%s "
              "step_ms with_checkpoints=%r without=%r (%d steps, one every "
              "%d)" % (os.path.basename(path), nbytes,
                       [round(v * 1e3, 3) for v in saves],
                       [round(v * 1e3, 3) for v in writes], ms_on, ms_off,
                       ELASTIC_BATCHES, ELASTIC_EVERY))
        if len(saves) != ELASTIC_BATCHES // ELASTIC_EVERY or \
                man["step"] != ELASTIC_BATCHES:
            fail("dist (d): %d saves, last step %d" % (len(saves),
                                                       man["step"]))
        for label, pol_env in (("float32", {}), ("bf16", {"MXNET_AMP": "1"})):
            prefix = os.path.join(work, "r_%s/m" % label)
            saved, restored = {}, {}
            real_save = mt.module.module._FusedFit.save_checkpoint
            real_resume = mt.module.module._FusedFit._resume

            def snap(ff):
                return {"step": ff._ts.num_update,
                        "scale": ff._ts.scale_state_host(),
                        "params": {k: v.clone() for k, v in
                                   ff._params.items()},
                        "state": {k: tuple(t.clone() for t in st)
                                  for k, st in ff._state.items()},
                        "aux": {k: v.clone() for k, v in ff._aux.items()}}

            def spy_save(self, *a, **kw):
                if not saved:          # the stopped run's save
                    saved.update(snap(self))
                return real_save(self, *a, **kw)

            def spy_resume(self, resume):
                real_resume(self, resume)
                restored.update(snap(self))
            mt.module.module._FusedFit.save_checkpoint = spy_save
            mt.module.module._FusedFit._resume = spy_resume
            try:
                env_r = dict(every, **pol_env)
                stopped, _, _, _ = elastic_fit(
                    torch, mt, net, args, aux, ex, ey, prefix, ctx, env_r,
                    stop_after=ELASTIC_EVERY)
                if stopped is not None or saved.get("step") != \
                        ELASTIC_EVERY:
                    fail("dist (d) %s: the stopped run saved step %s"
                         % (label, saved.get("step")))
                resumed, _, _, _ = elastic_fit(
                    torch, mt, net, args, aux, ex, ey, prefix, ctx, env_r)
            finally:
                mt.module.module._FusedFit.save_checkpoint = real_save
                mt.module.module._FusedFit._resume = real_resume
            bitwise = restored.get("step") == saved["step"] and \
                restored["scale"] == saved["scale"] and all(
                    torch.equal(restored[g][k], saved[g][k])
                    for g in ("params", "aux") for k in saved[g]) and all(
                    torch.equal(a_, b_) for k in saved["state"]
                    for a_, b_ in zip(restored["state"][k],
                                      saved["state"][k]))
            print("dist elastic %s resume: restored step %s scale %s, "
                  "bitwise the saved state=%s"
                  % (label, restored.get("step"), restored.get("scale"),
                     bitwise))
            if not bitwise:
                fail("dist (d) %s: the restored state is not the saved one"
                     % label)
            if label == "float32":
                floors = {k: max(float(np.abs(nudged_e[k] - w).max()),
                                 RESNET_FLOOR_MIN) for k, w in full.items()}
                worst = dist_worst(resumed, full, floors)
                print("dist elastic resumed against uninterrupted: worst %r "
                      "of RESNET_FLOOR_X x floor (%s)" % worst)
                if worst[0] > 1.0:
                    fail("dist (d): the resumed run's %s beyond "
                         "RESNET_FLOOR_X x its floor (%r)"
                         % (worst[1], worst[0]))
        launches += nc.launches
        print("dist norm_conv launches=%d" % launches)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


ZERO_BATCH = 16            # a rank's batch: 32 a step over both ranks
ZERO_STEPS = 3
ZERO_LEVELS = (0, 1, 2, 3)
ZERO_AMP_SCALE = 16.0
ZERO_FLOOR_SAMPLES = 3     # nudged runs of level 0 behind the floor
ZERO_ELASTIC_BATCHES = 4
ZERO_RECORD = "MULTICHIP_ZERO_r01.json"
# level 3's bytes over level 0's, times dp: 1 but for the rows' padding
# and the aux states (replicated); the allocator rounds each tensor up
ZERO_RATIO_SLACK = 0.02
ZERO_RESIDENT_SLACK = 0.05
# the collectives of a step by level, BatchNorm's sums aside
ZERO_KINDS = {0: {"all_reduce"}, 1: {"all_reduce", "all_gather"},
              2: {"reduce_scatter", "all_gather"},
              3: {"reduce_scatter", "all_gather"}}


def zero_phase(torch, mt):
    """(a)-(f) of the zero phase (see the docstring).  Returns the NormConv
    launches the ranks counted."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        torch.cuda.empty_cache()
        rows = dist_ranks(
            work, "mxnet_tpu_torch.bench.zero_ladder", "--ctx", "gpu",
            "--num-layers", "50", "--image", str(IMAGE), "--classes",
            str(CLASSES), "--batch", str(DIST_RANKS * ZERO_BATCH),
            "--dtype", "float32", "--levels",
            ",".join(str(v) for v in ZERO_LEVELS), "--optimizers", "sgd",
            "--steps", str(ZERO_STEPS), "--seed", str(SEED),
            "--floor-nudge", repr(RESNET_FLOOR_NUDGE), "--floor-samples",
            str(ZERO_FLOOR_SAMPLES), "--floor-x",
            repr(RESNET_FLOOR_X), "--floor-min", repr(RESNET_FLOOR_MIN),
            "--amp", "bfloat16", "--amp-scale", repr(ZERO_AMP_SCALE),
            "--elastic", str(ZERO_ELASTIC_BATCHES), "--remat-levels", "0",
            "--single", env={"MXNET_NORM_CONV": "1"})
        with open(os.path.join(ROOT, ZERO_RECORD)) as f:
            ladder = json.load(f)["ladder"]
        rec = {k: ladder[3]["zero_%s_bytes_mb" % k] * ladder[3]["dp"]
               / ladder[0]["zero_%s_bytes_mb" % k]
               for k in ("param", "grad", "opt")}
        launches = 0
        for r in rows:
            launches += r["norm_conv_launches"]
            if r["world"] != DIST_RANKS or r["route"] != DIST_ROUTE \
                    or not r["device"].startswith("cuda"):
                fail("zero: rank %d world %d route %s on %s"
                     % (r["rank"], r["world"], r["route"], r["device"]))
            lv = {x["level"]: x for x in r["levels"]}
            for level in ZERO_LEVELS:
                x = lv[level]
                print("zero level=%d rank=%d img_per_s=%r step_ms=%r "
                      "update_ms=%r plan_bytes=%s resident_bytes=%r "
                      "grad_resident_bytes=%r norm_conv=%r stats=%r "
                      "collectives=%s collective_mb=%s worst=%r "
                      "replicated_bitwise_equal=%s"
                      % (level, r["rank"], x["img_per_s"], x["step_ms"],
                         x["update_ms"], json.dumps(x["plan_bytes"],
                                                    sort_keys=True),
                         x["resident_bytes"], x["grad_resident_bytes"],
                         x["norm_conv_per_step"],
                         x["norm_conv_stats_per_step"],
                         json.dumps(x["collectives_per_step"],
                                    sort_keys=True),
                         json.dumps(x["collective_mb_per_step"],
                                    sort_keys=True),
                         x.get("worst_over_floor"),
                         x["replicated_bitwise_equal"]))
                # (a)
                if not x["replicated_bitwise_equal"]:
                    fail("zero (a): level %d: the ranks' replicated leaves "
                         "differ" % level)
                if level and x["worst_over_floor"][0] > 1.0:
                    fail("zero (a): level %d's %s beyond RESNET_FLOOR_X x "
                         "its floor of level 0's (%r)"
                         % (level, x["worst_over_floor"][1],
                            x["worst_over_floor"][0]))
                # (c)
                if x["norm_conv_per_step"] != RESNET_NC_PER_STEP or \
                        x["norm_conv_stats_per_step"] != \
                        RESNET_NC_STATS_PER_STEP:
                    fail("zero (c): level %d rank %d: %r NormConv launches "
                         "a step (%r with statistics)"
                         % (level, r["rank"], x["norm_conv_per_step"],
                            x["norm_conv_stats_per_step"]))
                # (d)
                kinds = set(x["collectives_per_step"]) - {"stats"}
                if kinds != ZERO_KINDS[level] or any(
                        x["collectives_per_step"][k] != 1 for k in kinds):
                    fail("zero (d): level %d's collectives %s"
                         % (level, x["collectives_per_step"]))
            # (a) remat and one process against level 0
            for x in r["variants"]:
                print("zero variant=%s level=%d rank=%d img_per_s=%r "
                      "step_ms=%r norm_conv=%r collectives=%s worst=%r"
                      % (x["variant"], x["level"], r["rank"],
                         x["img_per_s"], x["step_ms"],
                         x["norm_conv_per_step"],
                         json.dumps(x["collectives_per_step"],
                                    sort_keys=True),
                         x["worst_over_floor"]))
                if x["worst_over_floor"][0] > 1.0:
                    fail("zero (a): the %s run's %s beyond RESNET_FLOOR_X "
                         "x its floor of level 0's (%r)"
                         % (x["variant"], x["worst_over_floor"][1],
                            x["worst_over_floor"][0]))
                if x["norm_conv_per_step"] < RESNET_NC_PER_STEP:
                    fail("zero (c): the %s run launched %r NormConv kernels "
                         "a step" % (x["variant"], x["norm_conv_per_step"]))
            variants = {x["variant"]: x for x in r["variants"]}
            if set(variants) != {"remat", "single"} or \
                    variants["remat"]["collectives_per_step"]["stats"] <= \
                    lv[0]["collectives_per_step"]["stats"] or \
                    variants["single"]["collectives_per_step"]:
                fail("zero (a): the remat recompute or the one-process "
                     "step's collectives: %s"
                     % json.dumps({k: v["collectives_per_step"]
                                   for k, v in variants.items()}))
            print("zero amp rank=%d %s"
                  % (r["rank"], json.dumps(r["amp"], sort_keys=True)))
            print("zero elastic rank=%d %s"
                  % (r["rank"], json.dumps(r["elastic"], sort_keys=True)))
            # (b) level 3 against level 0, times dp
            l0, l3 = lv[0], lv[3]
            ratios = {k: l3["plan_bytes"][k] * DIST_RANKS
                      / l0["plan_bytes"][k] for k in ("param", "grad",
                                                      "opt")}
            resident = (l3["resident_bytes"] * DIST_RANKS
                        / l0["resident_bytes"])
            grads = (l3["grad_resident_bytes"] * DIST_RANKS
                     / l0["grad_resident_bytes"])
            print("zero bytes rank=%d level3_over_level0_times_dp plan=%s "
                  "resident=%r grad_resident=%r record(dp=%d)=%s"
                  % (r["rank"], json.dumps(ratios, sort_keys=True),
                     resident, grads, ladder[3]["dp"],
                     json.dumps(rec, sort_keys=True)))
            if any(abs(ratios[k] - rec[k]) > ZERO_RATIO_SLACK
                   for k in ratios) or \
                    abs(resident - 1.0) > ZERO_RESIDENT_SLACK or \
                    abs(grads - 1.0) > ZERO_RESIDENT_SLACK:
                fail("zero (b): level 3 over level 0 times dp: plan %s, "
                     "resident %r, gradients %r; the record's %s"
                     % (ratios, resident, grads, rec))
            # (e)
            amp = r["amp"]
            if not (amp["skipped"] and amp["every_rank_skipped"]
                    and amp["scale"] == ZERO_AMP_SCALE / 2
                    and amp["overflow"] == 1 and amp["clean_step_moved"]):
                fail("zero (e): %s" % amp)
            # (f)
            el = r["elastic"]
            if not (el["stopped"] and el["restored_bitwise"]
                    and el["zero"] == 2 and el["saved_step"] == 2
                    and "stage0-zero%d.params" % r["rank"] in el["shards"]):
                fail("zero (f): %s" % el)
        print("zero norm_conv launches=%d" % launches)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
        print("build %s seconds=%r"
              % (name if "." in name else name + ".cu", secs))
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas %s %s" % (name, line.strip()))


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch as mt
        from mxnet_tpu_torch.ops import contrib
        from mxnet_tpu_torch.ops import flash_attention as fa
        from mxnet_tpu_torch.ops import norm_conv as nc
        from mxnet_tpu_torch.ops.kernel_build import HostLibrary
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
    host = HostLibrary()
    build_all([("norm_conv", nc.build), ("flash_attention", fa.build),
               ("flash_attention_bwd", fa.build_bwd),
               ("multibox_nms", contrib.build),
               ("c_api.cc+cpp-package", lambda: capi_build(host))])
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
    inception = mt.models.inception_v3.get_symbol(num_classes=CLASSES)
    igeoms, istats = norm_conv_geometries(
        inception, (RESNET_TRAIN_BATCH, 3, INCEPTION_IMAGE, INCEPTION_IMAGE))
    print("inception_v3 norm_conv geometries=%d launches_per_forward=%d "
          "with_statistics_in_training=%d"
          % (len(igeoms), sum(igeoms.values()), sum(istats.values())))
    if len(igeoms) != INCEPTION_GEOMS or \
            sum(igeoms.values()) != INCEPTION_NC_PER_STEP or \
            sum(istats.values()) != INCEPTION_NC_STATS_PER_STEP:
        fail("expected %d Inception-v3 geometries, %d launches per forward "
             "and %d with statistics" % (INCEPTION_GEOMS,
                                         INCEPTION_NC_PER_STEP,
                                         INCEPTION_NC_STATS_PER_STEP))
    itot = kernel_train_phase(torch, nc, igeoms, istats,
                              batches=(INCEPTION_CHECK_BATCH,
                                       RESNET_TRAIN_BATCH),
                              label="inception_geom_train")
    print("kernel totals per batch-%d float32 Inception-v3 training step's "
          "forward (%d launches, %d with statistics): kernel_ms=%r "
          "plain_ms=%r library_ms=%r bound_ms=%r bound_by=%s"
          % (RESNET_TRAIN_BATCH, INCEPTION_NC_PER_STEP,
             INCEPTION_NC_STATS_PER_STEP, itot["ms"], itot["plain_ms"],
             itot["library_ms"], itot["bound_ms"],
             "operations" if itot["ops_ms"] >= itot["bytes_ms"]
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

    serving_numbers = serving_phase(torch, mt, nc, per_forward)
    launches = serving_numbers["launches"]
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
    obs_launches = observability_phase(torch, mt, nc, card, mf["fit_img_s"])
    phase_done("observability")
    lstm_bucketing_phase(torch, mt, card)
    phase_done("lstm_bucketing")
    nms = ssd_phase(torch, mt, card)
    phase_done("ssd")
    operators_phase(torch, mt, card)
    torch.cuda.empty_cache()
    phase_done("operators")
    rc = rcnn_phase(torch, mt, card)
    torch.cuda.empty_cache()
    phase_done("rcnn")
    im = imagenet_phase(torch, mt, nc, card)
    torch.cuda.empty_cache()
    phase_done("imagenet")
    custom_phase(torch, mt, card)
    torch.cuda.empty_cache()
    phase_done("custom")
    img_launches = image_phase(torch, mt, nc, card)
    torch.cuda.empty_cache()
    phase_done("image")
    capi_launches = capi_phase(torch, mt, nc, host, serving_numbers)
    torch.cuda.empty_cache()
    phase_done("capi")
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
    del weights
    torch.cuda.empty_cache()
    parallel_phase(torch, mt, card)
    phase_done("parallel")
    torch.cuda.empty_cache()
    dist_launches = dist_phase(torch, mt, nc, True)
    torch.cuda.empty_cache()
    phase_done("dist")
    zero_launches = zero_phase(torch, mt)
    torch.cuda.empty_cache()
    phase_done("zero")
    flb, bwb = fl["bfloat16"], bw["bfloat16"]
    print("chip_smoke seconds=%r (the whole script, builds included)"
          % (time.perf_counter() - t_start))

    print(json.dumps({"kernels": [{
        "name": "norm_conv", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_conv.cu",
        "replaces": "mxnet_tpu/ops/pallas_conv.py:120",
        "launches": launches + fused["launches"] + amp_fused["launches"]
        + mf["norm_conv"] + obs_launches + im["launches"] + img_launches
        + capi_launches + dist_launches + zero_launches,
        "max_abs_err": max(tot["max_abs_err"], ttot["max_abs_err"]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"]
        else "bytes",
        "library_ms": tot["library_ms"],
        "image_phase_launches": img_launches,
        "capi_phase_launches": capi_launches,
        "dist_phase_launches": dist_launches,
        "zero_phase_launches": zero_launches,
        "inception_v3_train": {
            "launches": im["launches"], "max_abs_err": itot["max_abs_err"],
            "ms": itot["ms"], "plain_ms": itot["plain_ms"],
            "bound_ms": itot["bound_ms"],
            "bound_by": "operations" if itot["ops_ms"] >= itot["bytes_ms"]
            else "bytes", "library_ms": itot["library_ms"]},
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
        "launches": nms["launches"] + rc["launches"],
        "max_abs_err": max(nms["max_abs_err"], rc["max_abs_err"]),
        "ms": nms["ms"], "plain_ms": nms["plain_ms"],
        "bound_ms": nms["bound_ms"], "bound_by": nms["bound_by"],
        "library_ms": None,
        "proposal_frcnn": {
            "rows": rc["rows"], "kept": rc["kept"],
            "launches": rc["launches"], "max_abs_err": rc["max_abs_err"],
            "ms": rc["ms"], "plain_ms": rc["plain_ms"],
            "bound_ms": rc["bound_ms"], "bound_by": rc["bound_by"],
            "library_ms": None}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
