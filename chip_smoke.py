#!/usr/bin/env python3
"""Chip smoke test of cxxnet_tpu_torch on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``); it
imports torch and the port, never JAX or ``cxxnet_tpu``.  Phases, each
printing one JSON line to stdout:

1. ``env`` — torch / CUDA versions, the card's name and power limit;
2. ``build`` — seconds to build every kernel from ``ops/csrc``, then
   ``ptxas`` — registers, spills, stack frames, shared memory and wgmma
   serialization notices of the redesigned libraries (``flash_fwd``,
   ``flash_dq``, ``flash_dkv``, ``fullc_gemm``, ``fullc_gemm_bf16``,
   ``fullc_gemm_nt``, ``fullc_gemm_nt_bf16``, ``fullc_gemm_tn``,
   ``fullc_gemm_tn_bf16``, ``conv_bias_act``,
   ``conv_bias_act_bf16``, ``int8_gemm``, ``paged_decode``,
   ``paged_verify``, ``lrn``, ``lrn_bwd``), from ``-Xptxas -v``;
3. ``kernel_checks`` — each kernel at AlexNet's batch-256 f32 shapes
   (forward kernels at the serving path's, the forward GEMM also at fc6 and
   fc7 of a ``use_pallas=1`` step, backward kernels at the train path's),
   rows 1-7 also at each distinct shape the Inception nets' paths give them
   (``inception_shapes``: GoogLeNet's 32 conv+relu pairs, Inception-BN's 41
   solo identity convs, LRN at c 64 and 192 on 56 x 56, the GEMMs at their
   fullc layers) and the paged attention kernels at the decode path's (16
   slots, 16 heads of 64, 16 pages of 16 positions per slot, a shuffled pool
   of 257 pages, one idle slot, verify at K = 4; f32 and the bf16 builds),
   the int8 GEMM at the quantized decode path's seven shapes (bitwise) and
   the flash-attention forward, dq and dk/dv kernels at the ``seqpar``
   path's shapes (b1 h16 s8192 d64 causal f32, the bf16 builds at b1 h8
   s2048, the bf16 forward, dq and dk/dv also at s32768 beside SDPA's causal
   forward and its autograd backward) against their plain versions on the
   card, with the stated tolerance, and timed beside the plain version, one
   PyTorch library call (SDPA over 20 launches) and the card's bound (the
   fullc weight-gradient GEMM and the f32 flash forward, dq and dk/dv, which
   run 3xTF32 on the tensor cores, against the function's products at the
   dense TF32 rate, with the kernels' three products a term and the FMA
   bound beside it); the redesigned kernels (the paged attention, int8 and
   LRN kernels too) also launched twice on the same inputs, bitwise equal;
   the LRN forward also in its training form (``norm`` written, checked
   too); the paged, int8 and LRN kernels, whose wrappers take longer on the
   host than a launch on the card, also timed as CUDA-graph replays
   (``graph_ms``, the kernels line's ``ms``; the LRN kernels over input sets
   rotated past the 50 MB L2, ``rotating``), beside an empty kernel on the
   decode grid (``empty_launch_ms`` / ``empty_graph_ms``, the launch floor);
   each conv layer's library leg also names the cuDNN kernels it ran (one
   ``torch.profiler`` pass), which tells a direct convolution from an FFT or
   Winograd one; then the bf16 builds of rows 1-5 (``compute_type=
   bfloat16``) at AlexNet's shapes and each distinct Inception shape, once
   each: y, dx and the GEMM output within one bf16 step of the plain
   version, the conv's z and the LRN's norm (f32) within ``TOL``, beside
   their bound (2 bytes a bf16 element, the products at the dense bf16
   tensor-core rate, ``bound_fma_ms`` at the f32 FMA rate) and one PyTorch
   call in bf16 (rows 1 and 4-5 run on the bf16 tensor cores), and the
   bf16 builds of rows 6-7 (the fullc backward GEMMs, on wgmma) at
   AlexNet's and GoogLeNet's fullc shapes,
   within one bf16 step and bitwise on repeat; then the f16 builds of rows
   1-7 (``compute_type=float16``) at the same shapes, the same way (one f16
   step, 2^-10 of the value; the f16 tensor rate is bf16's); then the
   ``threefry`` kernel (JAX's random stream: initial weights and dropout
   masks) against its plain version, bitwise, at a dropout mask's 256 x
   4096 in f32, bf16 and f16 and at fc6's 9216 x 4096 xavier draw, and
   against the
   ``jax.random`` draws of ``tests/fixtures/torch_jax_draws.json``;
4. ``serve`` — full-width AlexNet (``cxxnet_tpu_torch/example/ImageNet.conf``,
   seeded random weights) behind ``Net.serve_start``; 40 requests of
   mixed sizes through ``serve_scores`` from 4 client threads, latency
   and images/s, each forward kernel's launch count on this path (all
   must be > 0), and the scores of one 256-image request against the
   same net on the stock composition (``use_pallas=0 fuse=0``);
5. ``train`` — the same net with the training keys of
   ``cxxnet_tpu_torch/example/ImageNet_train.conf``: 20 ``Net.update``
   steps on seeded synthetic batch-256 images under ``auto`` (step ms,
   images/s, every loss finite, launches per step as the gates give
   them, the two dropout layers' ``threefry`` draws among them, peak
   device memory, a profiler breakdown of the step), 3 steps
   with ``use_pallas=1`` (all six kernels must launch), and one step of
   the stock composition from the same seed and dropout masks, replaying
   the kernel step's relu and max-pool choices, whose weight change the
   kernels' first step must match;
6. ``inception`` — GoogLeNet (``cxxnet_tpu_torch/example/GoogLeNet.conf``,
   batch 128) and Inception-BN (``Inception-BN.conf``, batch 256), full
   width, 224 x 224, f32, seeded random weights and synthetic images:
   10 ``Net.update`` steps under ``auto`` each (step ms p50 and spread,
   images/s, every loss finite, peak device memory, launches per step as
   the gates give them: GoogLeNet 32 conv+relu pairs and norm2's LRN
   forward, its 27 sibling 1x1 convs grouped into nine plain convs;
   Inception-BN none), a profiler breakdown of two steps, one eval
   forward (GoogLeNet 3 forward GEMM launches, Inception-BN 1), then
   GoogLeNet 3 steps under ``use_pallas=1`` (every CNN kernel launches)
   and Inception-BN one ``fuse=1`` step (its 41 convs outside sibling
   groups through the conv kernel as solo identity convs), and each net's
   one-step comparison with the stock composition;
7. ``cli_train`` — ``python -m cxxnet_tpu_torch.main`` on a copy of
   ``example/MNIST/MNIST_CONV.conf`` over synthetic idx files
   (``dev=cuda use_pallas=1``, 2 rounds): exit 0, the per-round eval
   lines, the model files, test-error <= 0.05;
8. ``decode`` — the GPT-2-small-class TransformerLM (vocab 32768,
   d_model 1024, 16 heads, d_ff 4096, 8 stages, seeded random weights,
   f32) behind ``DecodeService`` (16 slots, 257 pages of 16 positions,
   prompts up to 128, up to 128 new tokens, ``flash_decode=auto``): 48
   requests of mixed lengths from 4 client threads, 4 of them sampled;
   tokens/s, per-token and first-token latency, step occupancy, decode
   steps, the pool's low-water mark, peak device memory; the paged
   decode kernel must launch 8 times per decode step; six streams must
   equal offline ``transformer.generate``; then the gather leg
   (``flash_decode=0``) over the first 8 prompts must launch the kernel
   zero times and serve the same streams;
9. ``spec`` — the same target with ``spec_k=4`` and itself as the draft:
   16 greedy requests of 64 tokens, every stream equal to the target
   alone, the verify kernel launched 8 times per spec round;
10. ``quant`` — the same model at ``serve.dtype=int8`` over the decode
   phase's 48 requests (six streams equal to ``generate`` over the
   engine's int8 tree and bf16 config; the bf16 paged decode kernel 8
   times and the int8 GEMM 49 times per decode step and per prefill), at
   ``bf16`` over the first 16 (four twins), int8 with ``spec_k=4`` (8
   greedy requests of 64 tokens equal to the target alone, the bf16
   verify kernel 8 times per round), the three tiers' resident bytes, and
   the int8 / bf16 prefill logits against f32 on 4 prompts (reported);
11. ``prefix`` — prefix sharing, the tiered KV cache and prefill
   workers on the same model and engine shape under chat-style traffic
   (4 seeded system prompts of 96 tokens, each of 40 requests adding its
   own 32-token turn, 8 misses of random length, 4 sampled; up to 32 new
   tokens): an unshared leg, then ``prefix_share=64``; the tiers
   (``prefix_share=8``, a 4 MiB host tier, 64 MiB of disk records in a
   temp dir) under ``FaultPlan(corrupt_kv=1)`` after a prologue that
   pushes a system prompt's pages down-tier (exactly one record
   quarantined, its request re-prefilled); two engines on one
   ``kv_share_dir``, the second adopting the first's records (24
   requests each); ``prefill_workers=2`` (24); ``spec_k=4`` (24);
   ``serve.dtype=int8`` (12; the bf16 paged decode kernel 8 times a step,
   the int8 GEMM 49 times a step and a prefill, hit or miss); the CLI
   with the tier keys and two prefill workers (8 requests).  Every stream
   bitwise its offline ``generate`` (and so the unshared leg's); prefix
   hits, hit pages, prefill rows, time to first token, tokens/s, the
   publish's copy ms, tier counters and record write / read ms; the
   paged kernels launched exactly as the steps count; and the tail
   prefill probe: the port's tail bitwise its full prefill at f32 and
   int8, and whether JAX's unpadded tail, or a smaller bucket, would have
   given the same rows on the card (max abs difference);
12. ``seqpar`` — sequence-parallel attention at the LM's attention width
    (16 heads of 64, causal, f32) over a 1-rank NCCL world and its
    ``('data', 'model')`` mesh: 5 ``ulysses_attention`` forward+backward
    calls at b1 s8192, where the gate (4 GiB of dense scores) engages
    and each call launches exactly one flash forward, dq and dk/dv
    kernel; out and the three gradients against the dense reference's
    autograd; ms per call, tokens/s and peak device memory of the flash
    and the dense leg; at s4096 the gate stays dense (no flash launch);
    ``ring_attention`` at s2048 against the reference; the bf16 builds
    (b1 h8 s2048 causal, ``mode='on'``) within the JAX probe's 0.05 of
    the dense bf16 reference, and out and its gradients within one bf16
    step of the dense f32 reference on the same bf16 values (its
    backward's ``delta`` taken over the flash path's bf16 out, as the
    flash backward takes it), element by element; the bf16 forward, and
    forward + backward, at b1 h8 s32768 (``auto`` engages) timed, out
    and gradients finite;
13. ``lm_train`` — the TransformerLM's training step at ``bench.py
    transformer``'s width (vocab 32768, d_model 1024, 16 heads, d_ff
    4096, 8 blocks, seq 1024, batch 16, causal local attention, one
    microbatch, bf16, seeded as bench.py seeds it): 3 warm-up and 20 timed
    ``make_multi_train_step`` steps (step ms p50 and spread by the host
    clock after a synchronize and by CUDA events, tokens/s, the model
    FLOPs of a step counted from the shapes and their share of the bf16
    peak, the peak device memory, the first and last loss, finite), one
    4-step call and two steps under ``torch.profiler`` (device ms by
    kernel family, idle share); then a 1-rank NCCL world and its ``(pipe, data, seq,
    model)`` mesh: one ``make_train_step`` step against one multi step at
    a small f32 shape (the CPU tests' bounds), ``remat`` against none
    there, and one full-width one-block mesh step with ``remat`` off and
    on (peak memory; the same loss); no kernel of ``ops/`` may launch;
14. ``bf16`` — ``compute_type=bfloat16`` as the reference's confs set
    it: AlexNet (batch 256, 227², 20 steps), GoogLeNet (batch 128) and
    Inception-BN (batch 256), 224², 5 steps each, through ``Net.update``
    under ``auto`` (step ms p50 and spread, images/s, every loss finite,
    peak memory, a profile, launches per step equal to the f32 ``auto``
    counts under the bf16 builds' names), one eval forward each (the f32
    eval's launches under the bf16 names), and one step against the stock
    composition in bf16 and in f32 (``use_pallas=0 fuse=0``, decisions
    replayed): the kernel leg lies no further from the stock bf16 leg than
    1.5x the stock bf16 leg from the stock f32 leg, plus 2^-8 (the three
    distances reported per weight); AlexNet as the reference conf is
    written, dropout on, ``compute_type=bfloat16`` and ``use_pallas=1``:
    3 steps with exact launches per step (conv 5, LRN forward 2 and
    backward 2, the forward, input-gradient and weight-gradient GEMMs 3
    each, all bf16 builds, and 2 ``threefry`` draws), step ms, idle share
    and peak memory, and its step against the stock bf16 and f32
    compositions by the same rule; then AlexNet behind ``serve_start`` at
    bf16 over the serve phase's 40 requests (latency, images/s, launches
    equal to the bucket forwards', the f32 serve's under the bf16 names
    where the batches match, the 256-image scores by the same rule); then
    ``f16``, the same phase at ``compute_type=float16`` in place of the
    confs' ``bfloat16`` (launches under the f16 builds' names, the same
    rule against the stock f16 and f32 legs, in the form the CPU tests
    hold f16 to: the kernel leg no further from the stock f32 leg than 1.5x
    the stock f16 leg) in fewer steps (AlexNet 4, ``use_pallas=1`` 3, the
    Inception nets 3) and no profiles, each
    trained net with its f16 range (no loss scaling, as in JAX): the
    largest |activation| against 65504, and the share of weight-gradient
    elements zero in f16 but not in a stock f32 step that replays the f16
    step's relu and max-pooling choices and dropout masks;
15. ``cli_imgbin`` — the reference ``example/ImageNet/ImageNet.conf``,
    unchanged, trained one round (``num_round=1 max_round=1``) through
    ``python -m cxxnet_tpu_torch.main`` on 640 synthesized 256 x 256
    JPEGs (four classes, a coloured quadrant over noise) packed by
    ``python -m cxxnet_tpu_torch.io.im2bin``, evaluated on 300 more: its
    own chain (``imgbin``, random crop and mirror, the mean image created
    on first use, ``threadbuffer``), ``dev = tpu`` on CUDA 0 at
    ``compute_type = bfloat16``; exit 0, one finite eval line
    (``test-error``, ``rec@1``, ``rec@5``), ``models/0001.model``, a 3 x
    227 x 227 mean image; then with ``nworker = 8`` and
    ``device_normalize = 1`` in its train section (the mean image loaded,
    the ``io-`` pipeline fields on the eval line); ``task=pred`` over the
    test bin (300 lines); the CLI's other tasks on that model and bin
    (``cli_tasks``): ``pred_raw`` (300 rows of 1000 finite scores, their
    argmax ``pred.txt``), ``extract`` of fc7's output node 19 as raw f32
    (300 x 4096, finite) and of ``top[-1]`` as text (the ``pred_raw``
    file byte for byte), ``serve`` on buckets 1, 32 and 256 (``pred.txt``
    byte for byte, 3 programs, a ``[serve]`` line), ``finetune`` into a
    4-class ``fc8_ft`` head for one round (seven ``Copying layer`` lines,
    one finite eval line, ``models_ft/0001.model``), each task's loop
    seconds and images/s, then in process a ``task=finetune`` ``init``
    (the copied weights bitwise the source's) and ``wrapper.Net``'s
    ``extract_stream`` of node 19 (the CLI's file bit for bit, at the
    eval forward's launches a batch: ``bf16_cli_tasks_eval``); the conf's
    train chain in process with
    ``device_normalize = 1`` (uint8 batches) into the ``bf16`` phase's
    AlexNet for 3 steps at the ``bf16_alexnet_auto`` launches per step;
    images/s of each CLI round beside the synthetic-batch step, the host
    chain's images/s serial and at ``nworker = 8``, alone and feeding the
    in-process net's steps (a second pass), decode ms per image,
    and the digest of ``imgbin_fixture_digest`` against the one the CPU
    tests pinned from the JAX package's chain; and the conf at
    ``batch_size=64`` (ten steps a round) through the CLI's ``main`` in
    this process at K=1 and at ``steps_per_dispatch=4 scan_strict=1``:
    the model files byte-equal, the eval lines equal;
16. ``window`` — the K-step window (``steps_per_dispatch``,
    ``nnet/execution.py``) on AlexNet as the reference conf is written
    (bf16, ``use_pallas=1``, dropout 0.5, batch 256, seeded batches):
    two eager runs of 8 steps from one seed at ``update_period = 3``
    bitwise equal (params, momentum, losses, train metrics), then two
    K=4 windows through ``ExecutionPlan.round_stepper`` bitwise equal to
    them, launching 8 x a step's kernels (rows 1-7's bf16 builds and
    ``threefry``); the ops that warn in one step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (this
    leg and ``auto``); step ms at K=1 and K=4 in turns on one net, and a
    profile of each (idle share);
17. ``fold`` — ``serve.fold_bn`` on the full-width Inception-BN (f32,
    batch 256) behind ``Net.serve_start(fold_bn=1)`` with a seeded
    calibration batch: the conf as written (no conv bias, so no pair
    folds, scores bitwise) and with conv biases (69 pairs): the folded
    scores within ``FOLD_RTOL`` / ``FOLD_ATOL`` of the unfolded on the
    calibration batch, images/s of both, one request's launches;
18. ``blockdiag`` — ``fuse_blockdiag=auto`` on the full-width GoogLeNet
    (f32, batch 128): 6 groups, 5 steps of each net under ``auto``
    (step ms, 20 conv+relu pairs a step against 32), first-step losses
    within 1e-5, and one step of both at ``fuse=0`` with the unfused
    choices replayed, per weight within ``STOCK_TOL``;
19. ``native`` — the port's native runtime on this machine
    (``runtime/native.py``): built or not and the compiler's message (no
    ``jpeglib.h`` there: the page reader alone, PIL decodes), the page
    reader's MB/s against ``BinaryPage`` (a warm read), libjpeg (where
    built) against PIL ms per 256 x 256 JPEG, the imgbin chain's
    images/s with the native reader and with the Python one;
20. ``runtime`` — the training runtime on AlexNet as the reference conf
    is written (bf16, ``use_pallas=1``, dropout 0.5, batch 256, seeded
    batches from a replayable list): an uninterrupted 12-step run, then
    12 steps under ``TrainSupervisor`` (``save_every=4``,
    ``keep_last=2``, a 1 s watchdog, the breaker at 1) and the plan
    ``RUNTIME['plan']`` (a failed write, a NaN loss at step 6, step 8's
    checkpoint corrupted, batch 11 stalled 3 s) three times: sync saves,
    ``save_async=1``, and ``save_async=1`` in K=4 windows — each bitwise
    the uninterrupted run (params, momentum, accumulator, counters),
    every event fired, the failure log's restores and quarantine, and
    the kernels launched a step's counts x the steps computed (run and
    replayed); two fault-free supervised runs (sync, async) against the
    unsupervised steps/s; a step dir's bytes, the sync save's ms, the
    async save's stall of the step loop and its commit ms, the restore's
    ms; and the reference ``ImageNet.conf`` from the CLI at
    ``batch_size=160`` (four steps a round): 2 rounds with
    ``exact_ckpt=1``, then ``continue=1`` for 1 more in a second
    process, byte-equal to 3 rounds in one (model file, exact sidecar,
    the round's eval line);
21. ``fleet`` — the serving extensions on the full-width AlexNet
    (``cxxnet_tpu_torch/example/ImageNet.conf``, f32, ``auto``, buckets
    1, 8, 32, 128, 256): **reload** — ``Net.serve_start`` over ``0001.model``
    under closed-loop traffic from 4 clients (1-32 images a request, at
    least 200 requests) while a ``ModelRegistry`` polls the model dir:
    ``0002.model`` (another seed, written by ``publish_model_file``) is
    adopted, ``0003`` published under ``FaultPlan(corrupt_model=1)`` is
    REJECTED (transitions, the failure log, blacklisted) while 0002 keeps
    serving, ``0004`` is adopted; zero drops, every version served,
    ``compile_count`` 5, the reload's verify / load / warm / swap ms,
    the scores after the last swap against a fresh engine on 0004 and,
    at 32 and 128 rows, against the stock composition (``use_pallas=0
    fuse=0``) on 0004 within ``SERVE_RTOL`` / ``SERVE_ATOL``;
    **replicas** — ``ReplicatedPredictEngine(replicas=2, devices=[cuda:0,
    cuda:0])`` (a CUDA stream each) behind one ``DynamicBatcher``: scores
    bitwise the single engine's at every bucket on both replicas and
    within tolerance of the stock composition's there, both
    replicas' rows, three fleet-atomic swaps under traffic with no window
    on mixed versions, every replica bitwise a single engine on the last
    tree, ``devices=None`` raising JAX's "exceeds the 1 available
    devices", images/s at batch 256 single against replicated (2 clients
    each); **models** — ``serve_start(models=..., mem_budget=...)`` over
    three seeded model dirs under 2.5 models' f32 bytes: the third load
    evicts the coldest, a leased model is never evicted, an evicted
    model's ``torch.cuda.memory_allocated`` comes back within 1 MiB,
    each model's ``resident_bytes`` beside its measured allocation, the
    three at ``dtype='int8'`` all fit; one model's f32 and int8 fleet
    scores against the stock composition on its weights; **cli** — ``task=pred`` then
    ``task=serve serve.reload=0.05 serve.models=b=<dir>
    serve.mem_budget=<bytes>`` through the CLI's ``main`` on 64
    synthesized JPEGs: the same pred file, the fleet line, the
    registry's and the fleet's stderr lines; **lm_reload** — the decode
    phase's LM at its width (2 blocks): a ``ModelRegistry(pattern=
    LM_PATTERN, loader=lm_loader)`` swaps ``0002.lm`` in between two
    streams, each bitwise ``generate`` on its version.  Each leg's
    launches are its forwards x one forward's at each bucket (decode:
    the paged kernel once a block a step);
22. ``lowering`` — queue A item 2 on AlexNet as the reference conf is
    written (bf16, ``use_pallas=1``, batch 256) and in f32: each conv
    (conv1-conv5 at batch 256) through each route the legs send it off
    the fused kernel (native ``F.conv2d``, im2col, s2d, split,
    ``micro_batch=4``) in f32 and bf16, y, dx and dw against float64 on
    the same inputs (f32 within ``F64_TOL``, bf16 within one bf16 step),
    a repeat and the split against the unsplit route bit for bit or their
    largest difference, fwd + bwd ms by CUDA events and transient peak
    bytes; three steps at each ``conv_lowering`` (native, im2col, s2d,
    split) in both dtypes with the conv kernel launched 5 / 3 / 4 / 2
    times a step as JAX's pairing predicts and rows 2-7 and ``threefry``
    as the cell launches them; at ``fuse = 0`` (every relu a layer of its
    own) ``micro_batch`` 1 and 4 in both dtypes: bitwise or the largest
    parameter difference after three steps, peak memory (reset before
    each, and above its start), step ms; and one step of native and of
    each lowering, the lowering's weight change against native's under
    native's replayed relu and max-pool choices (f32 within
    ``STOCK_TOL``, bf16 by the 1.5x rule);
    JAX's ``attachtxt`` CLI conf on the card
    (0 train error by round 30) and AlexNet with a 64-wide side vector
    per image attached from a text file over 256 synthesized imgbin
    JPEGs, joined to fc7's output by ``concat`` before fc8: three bf16
    steps with exact launches, finite losses, fc8's side rows moved;
23. ``obs`` — telemetry (``obs/``, ``utils/profiler.py``): the
    reference ``example/ImageNet/ImageNet.conf`` through the CLI's
    ``main`` in this process over the ``cli_imgbin`` dataset (synthesized
    anew), batch 128, 2 rounds (10 steps), with ``obs.port=0 obs.hbm=1
    obs.profile=1 obs.sample_every=0.1 slo.step=...``, a ``profile_dir``
    window over updates 3-4 and ``obs.trace_export``: every route scraped
    mid-run (``/profile`` answering busy inside the window), the
    profiler's kernel events per name equal to the ``ops/launches``
    counts over the window, ``hbm.supported`` 1 and ``bytes_in_use`` <=
    ``peak_bytes`` <= ``limit_bytes`` = ``mem_get_info``'s total,
    ``train-mfu`` in (0, 1) at the table's peak for the card, the ``[N]``
    lines byte-equal to the same run without telemetry, one
    ``train.dispatch`` span a step, the dispatch p50 both ways; the serve
    leg (full-width AlexNet f32 behind ``PredictEngine`` +
    ``DynamicBatcher``, 24 mixed requests from 4 threads: trace ids across
    threads, one ledger row a bucket, no recompile, the requests'
    launches exactly each bucket's forward times its batches, an on-demand
    ``/profile`` window tracing the card); the decode leg (the LM at 2
    blocks, prefix sharing and a host KV tier, ``slo.kv_hit`` OK and a
    token-latency SLO driven to BREACHED by a ``slow_step`` stall, exactly
    one flight dump, streams their ``generate`` twins);
24. ``online`` — train-while-serve (``online/``, ``io/iter_stream.py``):
    the reference ``example/ImageNet/ImageNet.conf`` through the CLI's
    ``main`` in this process with ``task=online`` at batch 128, its data
    section an ``imgbin_stream`` over 1024 seeded JPEGs to which a
    producer thread appends a page of 128 after the first step (each
    pass fenced at 1152), 3 rounds, a serving checkpoint every 6 steps,
    the pred section's rows as traffic, under ``torch.profiler``: the
    eval lines' ``online-*`` keys, the summary (no drop, >= 3 swaps), the
    swaps strictly increasing, the step-named files with their digests,
    the launches exactly the steps', evals', inits' and forwards' units,
    the device-idle share; the batches digested while the file grew
    equal to a static ``imgbin`` pass over its final bytes; then 12 of
    those batches through ``OnlinePipeline`` in this process, twin /
    online / online / twin (the twin the same supervised round without a
    server): every online leg's full state bitwise the twin's, steps/s,
    freshness and request latency by bucket, the ``online.publish``
    span, each served version's first replies bitwise a fresh engine's
    on its published file; and the chaos drill (a retried write, a
    corrupted checkpoint, a NaN streak) bitwise the twin, never serving
    the corrupted step, its other files byte-equal to the online leg's;
25. ``kernels`` — the per-kernel summary line;

then the ``nvidia-smi`` name/power-limit line and, last, the ``ok`` line.
Any failed phase or tolerance exits non-zero without the ``ok`` line.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 256
SEED = 20261016

# (name, x shape NHWC, kh, kw, cin_g, cout, stride, pad, groups)
CONV_SHAPES = [
    ('conv1', (BATCH, 227, 227, 3), 11, 11, 3, 96, 4, 0, 1),
    ('conv2', (BATCH, 27, 27, 96), 5, 5, 48, 256, 1, 2, 2),
    ('conv3', (BATCH, 13, 13, 256), 3, 3, 256, 384, 1, 1, 1),
    ('conv4', (BATCH, 13, 13, 384), 3, 3, 192, 384, 1, 1, 2),
    ('conv5', (BATCH, 13, 13, 384), 3, 3, 192, 256, 1, 1, 2),
]
LRN_SHAPES = [('norm1', (BATCH, 27, 27, 96)), ('norm2', (BATCH, 13, 13, 256))]
# the forward GEMM kernel's shapes: fc8 (the serving path's, under auto)
# and fc6, fc7 (with fc8, a use_pallas=1 step's forward)
GEMM_SHAPES = [('fc8', BATCH, 4096, 1000), ('fc6', BATCH, 9216, 4096),
               ('fc7', BATCH, 4096, 4096)]
# the fullc layers of one train step: (name, batch, nin, nhidden)
FC_SHAPES = [('fc6', BATCH, 9216, 4096), ('fc7', BATCH, 4096, 4096),
             ('fc8', BATCH, 4096, 1000)]
LRN_ARGS = (5, 0.001, 0.75, 1.0)   # local_size, alpha, beta, knorm

# max |kernel - plain| / max |plain| allowed, per kernel: the f32 sums run
# in another order (sequential FMA chains against cuBLAS blocking) over
# contractions up to 9216 deep, so ~sqrt(K) * 2^-24 relative; LRN sums
# five terms and differs in the last bits of its power (a few ulp: two
# MUFU reciprocal square roots at beta 0.75, the MUFU log and exponent
# otherwise; lrn.cuh)
TOL = {'conv_bias_act': 1e-4, 'lrn_forward': 1e-5, 'fullc_gemm': 1e-4,
       'lrn_backward': 1e-5, 'fullc_gemm_nt': 1e-4, 'fullc_gemm_tn': 1e-4,
       # softmax-weighted sums of <= 256 rows, each score a 64-deep dot
       'paged_flash_decode': 1e-5, 'paged_flash_verify': 1e-5,
       # the bf16 builds round the score, the scaled score, each softmax
       # weight and the output to bf16 (8-bit mantissa) as the plain bf16
       # version does, but sum in another order: a score a bf16 ulp apart
       # moves its weight by ~2^-8 relative, so ~1e-2 of the largest value
       'paged_flash_decode_bf16': 1e-2, 'paged_flash_verify_bf16': 1e-2,
       # integer sums: bitwise
       'int8_matmul': 0.0,
       # online-softmax sums over up to 8192 keys (and, for dq / dk / dv,
       # the cancelling dp - delta) in another order than the plain
       # version's dense cuBLAS products: ~sqrt(8192) * 2^-24 relative,
       # pinned at 1e-4 of the largest value
       'flash_fwd': 1e-4, 'flash_dq': 1e-4, 'flash_dkv': 1e-4}
# the flash kernels' bf16 builds and their plain versions both sum in f32
# from the same bf16 inputs and round each output once to bf16, so they
# agree element by element to one bf16 step, which is at most 2^-7 of the
# value; BF16_FLOOR of the mean magnitude covers elements that cancel to
# near zero, where the two f32 sum orders show (~1e-6 of the summands).
# Their lse stays f32 and is held to the f32 kernel's TOL
BF16_STEP, BF16_FLOOR = 2.0 ** -7, 1e-3
#: one step of each 16-bit compute dtype: 2^-7 (bf16's 8-bit significand),
#: 2^-10 (f16's 11-bit); the floor is BF16_FLOOR of the mean magnitude for
#: both; and the builds' suffix on their entries and launch counts
STEP16 = {torch.bfloat16: BF16_STEP, torch.float16: 2.0 ** -10}
SUFFIX16 = {torch.bfloat16: '_bf16', torch.float16: '_f16'}
# the served net's scores against the stock composition (same weights):
# eight layers of differently ordered f32 sums, then softmax
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-6

KERNEL_META = {
    'conv_bias_act': ('cxxnet_tpu_torch/ops/csrc/conv_bias_act.cu',
                      'cxxnet_tpu/ops/pallas_cnn.py:103'),
    'lrn_forward': ('cxxnet_tpu_torch/ops/csrc/lrn.cu',
                    'cxxnet_tpu/ops/pallas_kernels.py:233'),
    'fullc_gemm': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm.cu',
                   'cxxnet_tpu/ops/pallas_kernels.py:383'),
    'lrn_backward': ('cxxnet_tpu_torch/ops/csrc/lrn_bwd.cu',
                     'cxxnet_tpu/ops/pallas_kernels.py:242'),
    'fullc_gemm_nt': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_nt.cu',
                      'cxxnet_tpu/ops/pallas_kernels.py:433'),
    'fullc_gemm_tn': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_tn.cu',
                      'cxxnet_tpu/ops/pallas_kernels.py:449'),
    'paged_flash_decode': ('cxxnet_tpu_torch/ops/csrc/paged_decode.cu',
                           'cxxnet_tpu/ops/pallas_kernels.py:910'),
    'paged_flash_verify': ('cxxnet_tpu_torch/ops/csrc/paged_verify.cu',
                           'cxxnet_tpu/ops/pallas_kernels.py:988'),
    'paged_flash_decode_bf16': ('cxxnet_tpu_torch/ops/csrc/paged_decode.cu',
                                'cxxnet_tpu/ops/pallas_kernels.py:910'),
    'paged_flash_verify_bf16': ('cxxnet_tpu_torch/ops/csrc/paged_verify.cu',
                                'cxxnet_tpu/ops/pallas_kernels.py:988'),
    'int8_matmul': ('cxxnet_tpu_torch/ops/csrc/int8_gemm.cu',
                    'cxxnet_tpu/ops/pallas_kernels.py:1073'),
    'flash_fwd': ('cxxnet_tpu_torch/ops/csrc/flash_fwd.cu',
                  'cxxnet_tpu/ops/pallas_kernels.py:612'),
    'flash_dq': ('cxxnet_tpu_torch/ops/csrc/flash_dq.cu',
                 'cxxnet_tpu/ops/pallas_kernels.py:661'),
    'flash_dkv': ('cxxnet_tpu_torch/ops/csrc/flash_dkv.cu',
                  'cxxnet_tpu/ops/pallas_kernels.py:699'),
    'flash_fwd_bf16': ('cxxnet_tpu_torch/ops/csrc/flash_fwd.cu',
                       'cxxnet_tpu/ops/pallas_kernels.py:612'),
    'flash_dq_bf16': ('cxxnet_tpu_torch/ops/csrc/flash_dq.cu',
                      'cxxnet_tpu/ops/pallas_kernels.py:661'),
    'flash_dkv_bf16': ('cxxnet_tpu_torch/ops/csrc/flash_dkv.cu',
                       'cxxnet_tpu/ops/pallas_kernels.py:699'),
    'conv_bias_act_bf16': ('cxxnet_tpu_torch/ops/csrc/conv_bias_act_bf16.cu',
                           'cxxnet_tpu/ops/pallas_cnn.py:103'),
    'lrn_forward_bf16': ('cxxnet_tpu_torch/ops/csrc/lrn.cu',
                         'cxxnet_tpu/ops/pallas_kernels.py:233'),
    'lrn_backward_bf16': ('cxxnet_tpu_torch/ops/csrc/lrn_bwd.cu',
                          'cxxnet_tpu/ops/pallas_kernels.py:242'),
    'fullc_gemm_bf16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_bf16.cu',
                        'cxxnet_tpu/ops/pallas_kernels.py:383'),
    'fullc_gemm_nt_bf16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_nt_bf16.cu',
                           'cxxnet_tpu/ops/pallas_kernels.py:433'),
    'fullc_gemm_tn_bf16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_tn_bf16.cu',
                           'cxxnet_tpu/ops/pallas_kernels.py:449'),
    # the f16 builds: the same templated bodies as the bf16 builds, an
    # entry of their own in the same libraries
    'conv_bias_act_f16': ('cxxnet_tpu_torch/ops/csrc/conv_bias_act_bf16.cu',
                          'cxxnet_tpu/ops/pallas_cnn.py:103'),
    'lrn_forward_f16': ('cxxnet_tpu_torch/ops/csrc/lrn.cu',
                        'cxxnet_tpu/ops/pallas_kernels.py:233'),
    'lrn_backward_f16': ('cxxnet_tpu_torch/ops/csrc/lrn_bwd.cu',
                         'cxxnet_tpu/ops/pallas_kernels.py:242'),
    'fullc_gemm_f16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_bf16.cu',
                       'cxxnet_tpu/ops/pallas_kernels.py:383'),
    'fullc_gemm_nt_f16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_nt_bf16.cu',
                          'cxxnet_tpu/ops/pallas_kernels.py:433'),
    'fullc_gemm_tn_f16': ('cxxnet_tpu_torch/ops/csrc/fullc_gemm_tn_bf16.cu',
                          'cxxnet_tpu/ops/pallas_kernels.py:449'),
    # no pallas_call: JAX's threefry is XLA; the JAX layer's draw it serves
    'threefry_uniform': ('cxxnet_tpu_torch/ops/csrc/threefry.cu',
                         'cxxnet_tpu/layers/common.py:180'),
}

SERVE_KERNELS = ('conv_bias_act', 'lrn_forward', 'fullc_gemm')
# the redesigned libraries, whose ptxas registers, spills, stack frames
# and serialization notices print on their own line
REDESIGNED_LIBS = ('flash_fwd', 'flash_dq', 'flash_dkv', 'fullc_gemm',
                   'fullc_gemm_bf16', 'fullc_gemm_nt', 'fullc_gemm_nt_bf16',
                   'fullc_gemm_tn', 'fullc_gemm_tn_bf16',
                   'conv_bias_act', 'conv_bias_act_bf16', 'int8_gemm',
                   'paged_decode', 'paged_verify', 'lrn', 'lrn_bwd',
                   'threefry')
TRAIN_STEPS, PALLAS_STEPS = 20, 3
# kernel launches of one AlexNet train step, as the gates route it (the
# JAX package's on one chip): under auto the conv+relu pairs, both LRN
# forwards and norm2's backward (c=256 runs 'full'; norm1's c=96 runs
# 'hybrid', whose backward is plain), and no fullc kernel at train time;
# use_pallas=1 forces every kernel; the two dropout layers draw their
# masks through the threefry kernel either way; the LM and flash-attention
# kernels never launch there
_LM_KERNELS = dict.fromkeys(('paged_flash_decode', 'paged_flash_verify',
                             'paged_flash_decode_bf16',
                             'paged_flash_verify_bf16', 'int8_matmul',
                             'flash_fwd', 'flash_dq', 'flash_dkv',
                             'flash_fwd_bf16', 'flash_dq_bf16',
                             'flash_dkv_bf16'), 0)
# the bf16 and f16 builds of rows 1-7 (compute_type=bfloat16 / float16),
# by dtype and the f32 build's name: they count under their own names
# (the threefry kernel counts its f32, bf16 and f16 draws as one)
BUILDS16 = {dt: {name: name + sfx for name in (
    'conv_bias_act', 'lrn_forward', 'lrn_backward', 'fullc_gemm',
    'fullc_gemm_nt', 'fullc_gemm_tn')} for dt, sfx in SUFFIX16.items()}
BF16_BUILDS = BUILDS16[torch.bfloat16]
_HALF_KERNELS = dict.fromkeys(
    [n for builds in BUILDS16.values() for n in builds.values()], 0)
STEP_LAUNCHES = {
    'auto': {'conv_bias_act': 5, 'lrn_forward': 2, 'lrn_backward': 1,
             'fullc_gemm': 0, 'fullc_gemm_nt': 0, 'fullc_gemm_tn': 0,
             'threefry_uniform': 2, **_HALF_KERNELS, **_LM_KERNELS},
    'on': {'conv_bias_act': 5, 'lrn_forward': 2, 'lrn_backward': 2,
           'fullc_gemm': 3, 'fullc_gemm_nt': 3, 'fullc_gemm_tn': 3,
           'threefry_uniform': 2, **_HALF_KERNELS, **_LM_KERNELS},
}
#: the kernel that draws the same numbers in a kernel leg and its stock
#: composition (the dropout masks); a stock leg may launch it
RANDOM_KERNEL = 'threefry_uniform'


def as16(launches, dtype=torch.bfloat16):
    """A launch-count dict with rows 1-7's counts moved to the names of
    their builds for the 16-bit ``dtype``: what a
    ``compute_type=bfloat16`` (or ``float16``) run of the same path
    launches."""
    out = dict.fromkeys(launches, 0)
    for name, cnt in launches.items():
        out[BUILDS16[dtype].get(name, name)] += cnt
    return out

# one SGD step of the kernels against the stock composition, same
# weights, batch, dropout masks, relu masks and max-pool choices:
# max |dw_kernel - dw_stock| / max |dw_stock| per weight.  Both legs run
# in f32 and differ in the order of their f32 sums (~1e-6 relative in the
# forward); a weight gradient sums ~10^5-10^6 such terms per element,
# with cancellation, so agreement is ~1e-4, not 1e-7.  Without the
# replayed relu and max-pool choices the comparison would measure which
# side of a near-tie each leg's rounding fell on: one flipped relu at fc7
# moves a whole column of its gradient by one sample's term, ~1e-2 of its
# largest value
STOCK_TOL = 1e-3
CLI_MAX_TEST_ERROR = 0.05


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``at_s``, the seconds since
    the script started, so the lines' differences time the phases."""
    if isinstance(obj, dict) and 'phase' in obj:
        obj = {**obj, 'at_s': time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(f32 FLOP/s outside the tensor cores, HBM bytes/s, dense int8
    tensor-core OP/s, dense bf16 tensor-core FLOP/s, dense TF32
    tensor-core FLOP/s) from NVIDIA's data sheets for the card named
    ``name``: H100 PCIe 51 TFLOP/s, 2.0 TB/s, 1513 TOP/s, 756 and 378
    TFLOP/s; H100 SXM (and any other name) 67 TFLOP/s, 3.35 TB/s, 1979
    TOP/s, 989 and 495 TFLOP/s."""
    if 'PCIe' in name:
        return 51e12, 2.0e12, 1513e12, 756e12, 378e12
    return 67e12, 3.35e12, 1979e12, 989e12, 495e12


def bound(flops: float, nbytes: float, peaks, op_rate=None):
    """The larger of the operations over their peak rate (f32 unless
    ``op_rate``) and the bytes over the memory rate, in ms, and which."""
    rate = peaks[0] if op_rate is None else op_rate
    t_ops, t_bytes = flops / rate * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def tf32_bounds(flops: float, nbytes: float, peaks):
    """The extra bounds of a kernel on the TF32 tensor cores with the
    3xTF32 split: its three TF32 products a term, and the function's
    products on the FMA pipes (its ``bound_ms`` counts the function's
    products at the TF32 rate)."""
    return {'bound_split_ms': bound(3.0 * flops, nbytes, peaks, peaks[4])[0],
            'bound_fma_ms': bound(flops, nbytes, peaks)[0],
            'bound_rate': "TF32 (the function's products)"}


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    launches, after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls captured in
    one CUDA graph and replayed ``reps`` times: its kernels back to back
    with no host work between them (the wrapper's own Python time, which
    ``time_ms`` includes when it exceeds the kernel's, drops out)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


#: the H100's L2 cache, bytes
L2_BYTES = 50e6


def rotating(nbytes: float) -> int:
    """How many input / output sets a timing loop cycles through so that
    a set comes round again only after twice the L2 has been moved by
    launches of ``nbytes`` each: every launch then reads its inputs from
    device memory, not from the L2 (``norm2``'s 44 MB input alone fits
    the 50 MB L2)."""
    return max(2, int(-(-2 * L2_BYTES // nbytes)) + 1)


def cycling(calls):
    """One callable that runs ``calls`` in turn, one a call."""
    import itertools
    it = itertools.cycle(calls)
    return lambda: next(it)()


def device_kernels(fn):
    """Device ms of each kernel one call of ``fn`` launches, by name (one
    ``torch.profiler`` pass)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, 'self_device_time_total', 0.0)
                   or getattr(e, 'self_cuda_time_total', 0.0))
        if us > 0:
            out[e.key[:120]] = us / 1e3
    return out


def ptxas_summary(log: str):
    """Registers, spill bytes, stack frame (an array indexed at run time
    lives there, not in registers) and shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log, and ptxas's serialization notices."""
    import re
    out, name, notices = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out.append({'function': name})
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and out:
            out[-1]['stack_frame'] = int(m.group(1))
            out[-1]['spill_stores'] = int(m.group(2))
            out[-1]['spill_loads'] = int(m.group(3))
        m = re.search(r'Used (\d+) registers', line)
        if m and out:
            out[-1]['registers'] = int(m.group(1))
            sm = re.search(r'(\d+) bytes smem', line)
            out[-1]['static_smem'] = int(sm.group(1)) if sm else 0
        # C7520 (a call, a fence in a divergent path: "in the function")
        # and C7512 (register pressure: "for the function"); ptxas may
        # print them before the function's own lines
        m = re.search(r"serialized due to (.*?) (?:in|for) the function "
                      r"'(\w+)'", line)
        if m:
            notices[m.group(2)] = m.group(1)
    for entry in out:
        if entry['function'] in notices:
            entry['serialized'] = notices[entry['function']]
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


def step16_excess(got: torch.Tensor, ref: torch.Tensor,
                  dtype=torch.bfloat16) -> float:
    """max over elements of |got - ref| / (step |ref| + BF16_FLOOR mean
    |ref|), ``step`` one step of the 16-bit ``dtype`` (``STEP16``): at
    most 1 where ``got`` is within one step of ``ref`` everywhere."""
    g, r = got.float(), ref.float()
    lim = STEP16[dtype] * r.abs() + BF16_FLOOR * r.abs().mean()
    return ((g - r).abs() / lim).max().item()


def kernel_checks(dev, peaks, dtype, failures):
    """Rows 1-7 at AlexNet's shapes, then at the distinct shapes the
    Inception nets' paths give them (:func:`inception_shapes`); every row
    names its ``net``.  With ``dtype`` bf16 or f16, rows 1-7's builds for
    that dtype (``compute_type=bfloat16`` / ``float16``, names ending
    ``_bf16`` / ``_f16``) at the same shapes: y, dx and the GEMMs' outputs
    within one step of the dtype of the plain version (``step16_excess``
    <= 1), the f32 outputs (the conv's z, the LRN's norm) within the f32
    build's ``TOL``; a 16-bit tensor counts 2 bytes an element, the
    products count at the dense bf16 / f16 tensor-core rate (the same,
    989 TFLOP/s on an H100 SXM; ``bound_fma_ms`` beside it: at the f32
    FMA rate, the pipes the LRN rows 2-3 run on; rows 1 and 4-7 run on the
    16-bit tensor cores), and the library calls run in that dtype."""
    from cxxnet_tpu_torch.ops.cnn import (_conv_call, conv_bias_act,
                                          conv_bias_act_plain)
    from cxxnet_tpu_torch.ops.kernels import (
        fullc_gemm, fullc_gemm_nt, fullc_gemm_nt_plain, fullc_gemm_plain,
        _lrn_call, fullc_gemm_tn, fullc_gemm_tn_plain, lrn_backward,
        lrn_backward_plain, lrn_forward, lrn_forward_plain)
    half = dtype in STEP16
    es = 2.0 if half else 4.0        # bytes an element of x, w, y, g, dx
    suffix = SUFFIX16.get(dtype, '')
    seed = {torch.bfloat16: SEED + 15, torch.float16: SEED + 26}
    gen = torch.Generator(device=dev).manual_seed(seed.get(dtype, SEED))
    inception = inception_shapes()
    rows = []

    def randn(shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(dtype)

    def check(kernel, shape_name, out, ref, lib_out, ms, plain_ms, lib_ms,
              flops, nbytes, repeat=None, tf32=False, net='alexnet',
              f32_out=None, **extra):
        """One row; ``repeat`` (a second launch's output) must equal
        ``out`` bitwise; ``f32_out`` = (name, got, want) of an f32 output
        held to the f32 build's ``TOL``.  ``tf32``: a kernel on the TF32
        tensor cores with the 3xTF32 split, whose ``bound_ms`` counts the
        function's products at the dense TF32 rate, ``bound_split_ms`` the
        three TF32 products a term it takes and ``bound_fma_ms`` the
        function's products at the f32 FMA rate."""
        err, rel = rel_err(out, ref)
        b_ms, b_by = bound(flops, nbytes, peaks)
        if tf32:
            extra.update(tf32_bounds(flops, nbytes, peaks))
            b_ms, b_by = bound(flops, nbytes, peaks, peaks[4])
        if half:
            extra.update(bound_fma_ms=b_ms, bound_rate=f'{suffix[1:]} dense')
            b_ms, b_by = bound(flops, nbytes, peaks, peaks[3])
        base = kernel[:-len(suffix)] if suffix else kernel
        row = {'kernel': kernel, 'shape': shape_name, 'max_abs_err': err,
               'max_rel_err': rel,
               'library_max_abs_err': rel_err(lib_out, ref)[0]
               if lib_out is not None else None,
               'kernel_ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
               'bound_ms': b_ms, 'bound_by': b_by, 'flops': flops,
               'bytes': nbytes, 'net': net,
               'layers': inception['layers'].get(
                   shape_name.split(' train')[0], 1), **extra}
        if half:
            row['step_excess'] = excess = step16_excess(out, ref, dtype)
            row['tol_step_excess'] = 1.0
            if not excess <= 1.0 or not torch.isfinite(out.float()).all():
                failures.append(f'{kernel}[{shape_name}]: {excess} '
                                f'{suffix[1:]} steps from the plain '
                                'version')
        else:
            row['tol_rel'] = TOL[kernel]
            if not (rel <= TOL[kernel]) or not torch.isfinite(out).all():
                failures.append(f'{kernel}[{shape_name}]: max rel err '
                                f'{rel} > {TOL[kernel]}')
        if f32_out is not None:
            name, got, want = f32_out
            row[f'{name}_max_rel_err'] = r = rel_err(got, want)[1]
            if not r <= TOL[base]:
                failures.append(f'{kernel}[{shape_name}]: {name} max rel '
                                f'err {r} > {TOL[base]}')
            if not torch.isfinite(got).all():
                failures.append(f'{kernel}[{shape_name}]: {name} is not '
                                'finite')
        if repeat is not None:
            row['bitwise_repeat'] = torch.equal(repeat, out)
            if not row['bitwise_repeat']:
                failures.append(f'{kernel}[{shape_name}]: two launches '
                                'differ')
        rows.append(row)

    convs = [('alexnet', *shape, 'relu') for shape in CONV_SHAPES] \
        + inception['conv']
    for (net, name, xs, kh, kw, cin_g, cout, s, p, g, act) in convs:
        x = randn(xs)
        w = randn((kh, kw, cin_g, cout), (kh * kw * cin_g) ** -0.5)
        b = randn((cout,), 0.1)
        strides, pad = (s, s), ((p, p), (p, p))
        with torch.inference_mode():
            out, z = _conv_call(x, w, b, strides, pad, g, act, True)
            torch.cuda.synchronize()
            ref, ref_z = conv_bias_act_plain(x, w, b, strides, pad, g, act)
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)

            def lib():
                y = F.conv2d(x_nchw, w_oihw, b, stride=s, padding=p,
                             groups=g)
                return torch.relu_(y) if act == 'relu' else y
            lib_out = lib().permute(0, 2, 3, 1)
            ms = time_ms(lambda: conv_bias_act(x, w, b, strides, pad, g,
                                               act), 5)
            plain_ms = time_ms(lambda: conv_bias_act_plain(
                x, w, b, strides, pad, g, act), 2)
            lib_ms = time_ms(lib, 5)
            repeat = conv_bias_act(x, w, b, strides, pad, g, act)
            # cuDNN's choice at AlexNet's shapes: an FFT or Winograd
            # kernel does fewer multiplies than the direct convolution
            # the bound counts
            extra = {'library_kernels': device_kernels(lib)} \
                if net == 'alexnet' else {}
        n, oy, ox = out.shape[:3]
        flops = 2.0 * n * oy * ox * cout * kh * kw * cin_g
        nbytes = es * (x.numel() + w.numel() + b.numel() + out.numel())
        check('conv_bias_act' + suffix, name, out, ref, lib_out, ms,
              plain_ms, lib_ms, flops, nbytes, repeat, net=net,
              f32_out=('z', z, ref_z), **extra)
        del x, w, b, out, z, ref, ref_z, lib_out, x_nchw, w_oihw, repeat

    nsize, alpha, beta, knorm = LRN_ARGS
    lrns = [('alexnet', *shape) for shape in LRN_SHAPES] + inception['lrn']
    for net, name, xs in lrns:
        x = randn(xs, 4.0)
        n = x.numel()
        with torch.inference_mode():
            out = lrn_forward(x, nsize, alpha, beta, knorm)
            torch.cuda.synchronize()
            ref, ref_norm = lrn_forward_plain(x, nsize, alpha, beta, knorm)
            # input sets rotated past the L2 (rotating): the kernel and
            # the library call each read x from device memory
            xr = [x] + [x.clone() for _ in range(rotating(2 * es * n) - 1)]

            def lib(v=x):
                return F.local_response_norm(v.permute(0, 3, 1, 2), nsize,
                                             alpha, beta, knorm)
            lib_out = lib().permute(0, 2, 3, 1)
            fwd = cycling([lambda v=v: lrn_forward(v, nsize, alpha, beta,
                                                   knorm) for v in xr])
            ms, g_ms = time_ms(fwd, 20), graph_ms(fwd, 20)
            plain_ms = time_ms(lambda: lrn_forward_plain(
                x, nsize, alpha, beta, knorm), 5)
            lib_ms = time_ms(cycling([lambda v=v: lib(v) for v in xr]), 20)
            repeat = lrn_forward(x, nsize, alpha, beta, knorm)
            # the training form writes the f32 norm too
            y_t, norm_t = _lrn_call(x, nsize, alpha, beta, knorm, True)
            y_t2, norm_t2 = _lrn_call(x, nsize, alpha, beta, knorm, True)
            xr = xr[:1] + [x.clone() for _ in
                           range(rotating((2 * es + 4) * n) - 1)]
            train = cycling([lambda v=v: _lrn_call(v, nsize, alpha, beta,
                                                   knorm, True) for v in xr])
            t_ms, t_g_ms = time_ms(train, 20), graph_ms(train, 20)
        # per element: nsize multiply-adds, scale and add, power, multiply
        flops = n * (2.0 * nsize + 4)
        check('lrn_forward' + suffix, name, out, ref, lib_out, ms, plain_ms,
              lib_ms, flops, 2 * es * n, repeat, graph_ms=g_ms, net=net)
        check('lrn_forward' + suffix, f'{name} train', y_t, ref, None, t_ms,
              plain_ms, None, flops, (2 * es + 4) * n, y_t2,
              graph_ms=t_g_ms, in_summary=False, net=net,
              f32_out=('norm', norm_t, ref_norm))
        if not torch.equal(norm_t, norm_t2):
            failures.append(f'lrn_forward{suffix}[{name} train]: two '
                            'launches differ in norm')
        del x, xr, out, ref, ref_norm, lib_out, repeat, y_t, y_t2, norm_t, \
            norm_t2

    gemms = [('alexnet', *shape) for shape in GEMM_SHAPES] \
        + inception['gemm']
    for net, name, m, k, n in gemms:
        a = randn((m, k))
        b = randn((k, n), k ** -0.5)
        with torch.inference_mode():
            out = fullc_gemm(a, b)
            torch.cuda.synchronize()
            ref = fullc_gemm_plain(a, b)
            lib_out = torch.matmul(a, b)
            ms = time_ms(lambda: fullc_gemm(a, b), 20)
            plain_ms = time_ms(lambda: fullc_gemm_plain(a, b), 20)
            lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
            repeat = fullc_gemm(a, b)
        check('fullc_gemm' + suffix, name, out, ref, lib_out, ms, plain_ms,
              lib_ms, 2.0 * m * n * k, es * (m * k + k * n + m * n),
              repeat, net=net)
        del a, b, out, ref, lib_out, repeat

    # --- the train path's backward kernels -------------------------------
    for net, name, xs in lrns:
        x = randn(xs, 4.0)
        g = randn(xs)
        n = x.numel()
        with torch.no_grad():
            norm = lrn_forward_plain(x, nsize, alpha, beta, knorm)[1]
            out = lrn_backward(x, g, norm, nsize, alpha, beta)
            torch.cuda.synchronize()
            ref = lrn_backward_plain(x, g, norm, nsize, alpha, beta)
            # (x, g, norm) sets rotated past the L2, as for the forward
            sets = [(x, g, norm)] + [
                (x.clone(), g.clone(), norm.clone())
                for _ in range(rotating((3 * es + 4) * n) - 1)]
            bwd = cycling([lambda s=s: lrn_backward(*s, nsize, alpha, beta)
                           for s in sets])
            ms, g_ms = time_ms(bwd, 20), graph_ms(bwd, 20)
            plain_ms = time_ms(lambda: lrn_backward_plain(
                x, g, norm, nsize, alpha, beta), 5)
            repeat = lrn_backward(x, g, norm, nsize, alpha, beta)
        lib_out = lib_ms = None
        if nsize % 2:
            # F.local_response_norm's window is symmetric: the same
            # function only for odd n.  Its backward alone is the time of
            # forward + autograd.grad less the forward's, over the same
            # rotated sets
            leaves = [(s[0].permute(0, 3, 1, 2).detach().requires_grad_(),
                       s[1].permute(0, 3, 1, 2)) for s in sets]

            def lib_fwd(xr):
                return F.local_response_norm(xr, nsize, alpha, beta, knorm)

            def lib_fwd_bwd(xr, g_nchw):
                return torch.autograd.grad(lib_fwd(xr), xr, g_nchw)[0]
            lib_out = lib_fwd_bwd(*leaves[0]).permute(0, 2, 3, 1)
            lib_ms = max(
                time_ms(cycling([lambda a=a: lib_fwd_bwd(*a)
                                 for a in leaves]), 20)
                - time_ms(cycling([lambda a=a: lib_fwd(a[0])
                                   for a in leaves]), 20), 0.0)
            del leaves
        # per element: the power and the two products of t, the window's
        # n adds, then the scale, product and subtraction of dx; x, g and
        # dx in ``dtype``, norm in f32
        flops = n * (nsize + 8.0)
        check('lrn_backward' + suffix, name, out, ref, lib_out, ms,
              plain_ms, lib_ms, flops, (3 * es + 4) * n, repeat,
              graph_ms=g_ms, net=net)
        del x, g, norm, sets, out, ref, lib_out, repeat

    fcs = [('alexnet', *shape) for shape in FC_SHAPES] + inception['fc']
    for net, name, m, nin, nout in fcs:
        a = randn((m, nin))
        w = randn((nin, nout), nin ** -0.5)
        g = randn((m, nout))
        flops = 2.0 * m * nin * nout
        nbytes = es * (m * nin + nin * nout + m * nout)
        with torch.no_grad():
            # input gradient g @ w^T, contracting nhidden
            out = fullc_gemm_nt(g, w)
            torch.cuda.synchronize()
            ref = fullc_gemm_nt_plain(g, w)
            lib_out = torch.matmul(g, w.t())
            ms = time_ms(lambda: fullc_gemm_nt(g, w), 10)
            plain_ms = time_ms(lambda: fullc_gemm_nt_plain(g, w), 5)
            lib_ms = time_ms(lambda: torch.matmul(g, w.t()), 10)
            repeat = fullc_gemm_nt(g, w)
        check('fullc_gemm_nt' + suffix, name, out, ref, lib_out, ms,
              plain_ms, lib_ms, flops, nbytes, repeat, net=net)
        del out, ref, lib_out, repeat
        with torch.no_grad():
            # weight gradient a^T @ g, contracting the batch
            out = fullc_gemm_tn(a, g)
            torch.cuda.synchronize()
            ref = fullc_gemm_tn_plain(a, g)
            lib_out = torch.matmul(a.t(), g)
            ms = time_ms(lambda: fullc_gemm_tn(a, g), 10)
            plain_ms = time_ms(lambda: fullc_gemm_tn_plain(a, g), 5)
            lib_ms = time_ms(lambda: torch.matmul(a.t(), g), 10)
            repeat = fullc_gemm_tn(a, g)
        check('fullc_gemm_tn' + suffix, name, out, ref, lib_out, ms,
              plain_ms, lib_ms, flops, nbytes, repeat, tf32=not half,
              net=net)
        del a, w, g, out, ref, lib_out, repeat
    return rows


# the threefry kernel's draws on the main path: a dropout mask of fc6 /
# fc7 (a train step's two draws) in f32, bf16 and f16, and fc6's xavier
# initial weight (the largest draw of a net's init)
THREEFRY_SHAPES = [('dropout fc6', (BATCH, 4096), torch.float32, 0.5),
                   ('dropout fc6 bf16', (BATCH, 4096), torch.bfloat16, 0.5),
                   ('dropout fc6 f16', (BATCH, 4096), torch.float16, 0.5),
                   ('init fc6', (9216, 4096), torch.float32, None)]
#: integer operations an element: 20 rounds of add, rotate and xor, five
#: key injections of two adds, the conversion and the affine or compare
THREEFRY_OPS = 80.0


def threefry_checks(dev, peaks, failures):
    """The threefry kernel against its plain version on the card, bitwise
    (twice, the second launch bitwise too), timed by CUDA-graph replay
    (``ms``; its wrapper's host time exceeds a launch) and by events,
    beside its bound: the output's bytes against ``THREEFRY_OPS`` integer
    operations an element at the f32 rate the integer pipes do not
    exceed; no PyTorch call draws JAX's numbers (``library_ms`` null).
    Then the ``jax.random`` draws of ``tests/fixtures/torch_jax_draws.json``
    (the card has no JAX): uniforms bitwise, normals within the file's
    ``normal_tol``."""
    from cxxnet_tpu_torch.ops import threefry
    from cxxnet_tpu_torch.utils import prng
    key = prng.fold_in(prng.prng_key(SEED), 1 + 131 * 3)
    rows = []
    for name, shape, dtype, pkeep in THREEFRY_SHAPES:
        n = int(np.prod(shape))
        if pkeep is None:
            a = (3.0 / (shape[0] + shape[1])) ** 0.5
            lo, hi = -a, a
        else:
            lo, hi = 0.0, 1.0

        def draw(shape=shape, dtype=dtype, pkeep=pkeep, lo=lo, hi=hi):
            if pkeep is None:
                return threefry.uniform(key, shape, dtype, dev, lo, hi)
            return threefry.keep_mask(key, shape, dtype, dev, pkeep)

        def plain(n=n, dtype=dtype, pkeep=pkeep, lo=lo, hi=hi):
            return prng.uniform_plain(key, n, dtype, lo, hi, pkeep,
                                      device=dev)
        out = draw()
        torch.cuda.synchronize()
        ref = plain()
        repeat = draw()
        ms, g_ms = time_ms(draw, 20), graph_ms(draw, 20)
        plain_ms = time_ms(plain, 3)
        es = 2.0 if dtype in STEP16 else 4.0
        b_ms, b_by = bound(THREEFRY_OPS * n, es * n, peaks)
        err = (out.view(-1).float() - ref.float()).abs().max().item()
        row = {'kernel': 'threefry_uniform', 'shape': name,
               'dtype': str(dtype).split('.')[-1], 'elements': n,
               'max_abs_err': err, 'max_rel_err': err,
               'bitwise_plain': torch.equal(out.view(-1), ref),
               'bitwise_repeat': torch.equal(out, repeat),
               'kernel_ms': ms, 'graph_ms': g_ms, 'plain_ms': plain_ms,
               'library_ms': None, 'library_max_abs_err': None,
               'bound_ms': b_ms, 'bound_by': b_by,
               'flops': THREEFRY_OPS * n, 'bytes': es * n,
               'net': 'alexnet', 'layers': 2 if pkeep else 1}
        if pkeep is not None:
            row['kept_share'] = out.float().mean().item()
        if not (row['bitwise_plain'] and row['bitwise_repeat']):
            failures.append(f'threefry_uniform[{name}]: not bitwise equal '
                            f'to its plain version / itself ({err})')
        rows.append(row)
        del out, ref, repeat
    with open(os.path.join(ROOT, 'tests', 'fixtures',
                           'torch_jax_draws.json')) as f:
        pinned = json.load(f)
    worst = {'uniform': 0.0, 'normal': 0.0}
    for d in pinned['draws']:
        dt = getattr(torch, d['dtype'])
        k = prng.fold_in(prng.prng_key(d['seed']), d['fold'])
        fn = threefry.uniform if d['kind'] == 'uniform' else threefry.normal
        got = fn(k, (len(d['values']),), dt, dev).float().cpu()
        want = torch.tensor(d['values'], dtype=torch.float32)
        rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        worst[d['kind']] = max(worst[d['kind']], rel)
    if worst['uniform'] != 0.0 or not worst['normal'] <= pinned['normal_tol']:
        failures.append(f'threefry_uniform: jax.random draws missed: '
                        f'{worst} (normal_tol {pinned["normal_tol"]})')
    return {'rows': rows, 'jax_draws': {
        'draws': len(pinned['draws']), 'max_rel_err': worst,
        'normal_tol': pinned['normal_tol']}}


SERVE_BUCKETS = '1,8,64,256'


@functools.lru_cache(maxsize=None)
def _serve_requests():
    """The serve phases' 40 seeded requests of 1-256 images (the first
    four at the buckets' sizes), made once (read only) for both serve
    phases."""
    rng = np.random.RandomState(SEED)
    sizes = [int(v) for v in rng.randint(1, BATCH + 1, size=40)]
    sizes[:4] = [1, 8, 64, BATCH]
    return [rng.randn(n, 3, 227, 227).astype(np.float32) for n in sizes]


def _serve_drive(net, requests):
    """``Net.serve_start`` and 40 requests from 4 client threads through
    ``serve_scores``, the launch counts from 0 just before the start and
    read just after the drive."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    results = [None] * len(requests)
    latency = [0.0] * len(requests)
    errors = []

    def client(idx):
        for i in idx:
            t0 = time.perf_counter()
            try:
                results[i] = net.serve_scores(requests[i], deadline=120.0)
            except Exception as e:  # noqa: BLE001 — reported as a failure
                errors.append(f'request {i}: {e!r}')
            latency[i] = (time.perf_counter() - t0) * 1e3

    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    t0 = time.perf_counter()
    net.serve_start(buckets=SERVE_BUCKETS, max_queue=256, max_wait=0.002,
                    deadline=120.0)
    warm_s = time.perf_counter() - t0
    threads = [threading.Thread(target=client, args=(list(range(j, 40, 4)),))
               for j in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # --------------------------------------------------------------------
    if any(t.is_alive() for t in threads):
        errors.append('client threads did not finish')
    lat = np.asarray(latency)
    return {'results': results, 'errors': errors, 'launches': launches,
            'stats': net.serve_stats(),
            'compile_count': net.engine.compile_count, 'warm_s': warm_s,
            'drive_s': wall, 'loop': 'closed, 4 clients',
            'p50_ms': float(np.quantile(lat, 0.5)),
            'p75_ms': float(np.quantile(lat, 0.75)),
            'p99_ms': float(np.quantile(lat, 0.99))}


def _answered(tag, requests, results, failures):
    """How many requests got finite (n, 1000) score rows summing to 1."""
    answered = 0
    for req, res in zip(requests, results):
        if res is None:
            continue
        if res.shape != (req.shape[0], 1000) or not np.isfinite(res).all() \
                or np.abs(res.sum(axis=1) - 1.0).max() > 1e-4:
            failures.append(f'{tag}: bad scores for a {req.shape[0]}-row '
                            'request')
            continue
        answered += 1
    return answered


def _b256_images_per_s(engine, big, reps=5):
    """images/s at bucket 256 (H2D copy, forward and D2H readback)."""
    engine.predict_scores(big)
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict_scores(big)
    return reps * BATCH / (time.perf_counter() - t0)


def serve_phase(dev_name, failures):
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    conf = _example_conf('ImageNet.conf')
    net = Net(dev='cuda', cfg=conf)
    net.set_param('seed', str(SEED))
    net.init_model()
    requests = _serve_requests()
    drive = _serve_drive(net, requests)
    launches = drive['launches']
    engine = net.engine
    failures.extend(f'serve: {e}' for e in drive['errors'])
    answered = _answered('serve', requests, drive['results'], failures)
    for name, cnt in launches.items():
        if (cnt > 0) != (name in SERVE_KERNELS):
            failures.append(f'serve: kernel {name} launched {cnt} times on '
                            'the serving path')

    big = requests[3]
    img_s = _b256_images_per_s(engine, big)

    # launches of ONE batch-256 forward (outside the main-path window)
    reset_launch_counts()
    served = engine.predict_scores(big)
    per_forward = launch_counts()
    net.serve_stop()

    # the same weights on the stock composition
    ref_net = Net(dev='cuda', cfg=conf)
    for k, v in (('seed', str(SEED)), ('use_pallas', '0'), ('fuse', '0')):
        ref_net.set_param(k, v)
    ref_net.init_model()
    reset_launch_counts()
    ref = ref_net.predict_scores(big)
    stock_launches = sum(launch_counts().values())
    if stock_launches:
        failures.append('serve: the stock leg launched port kernels')
    err = float(np.abs(served - ref).max())
    if not np.allclose(served, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        failures.append(f'serve: scores differ from the stock composition '
                        f'by {err}')
    return {'phase': 'serve', 'device': dev_name,
            'requests': len(requests), 'answered': answered,
            'rows': int(sum(len(r) for r in requests)),
            **{k: drive[k] for k in ('warm_s', 'drive_s', 'loop', 'p50_ms',
                                     'p75_ms', 'p99_ms', 'compile_count')},
            'images_per_s_b256': img_s,
            'launches': launches, 'launches_per_forward_b256': per_forward,
            'stock_max_abs_err': err, 'stock_max_score': float(ref.max()),
            'stock_rtol': SERVE_RTOL, 'stock_atol': SERVE_ATOL,
            'stats': drive['stats']}


def _example_conf(*names) -> str:
    text = ''
    for name in names:
        with open(os.path.join(ROOT, 'cxxnet_tpu_torch', 'example',
                               name)) as f:
            text += f.read() + '\n'
    return text


def _weights(net):
    return {(k, f): v.detach().clone()
            for k, fs in net.trainer.params.items() for f, v in fs.items()}


def _kernel_family(name: str) -> str:
    """The share of a train step a device kernel counts toward, by its
    name: the port's kernels, cuDNN's convolutions, cuBLAS's products
    (the fullc layers and the conv block's transposes; Hopper's cuBLAS
    names some ``nvjet_*``), pooling, copies,
    or the rest (patch copies and col2im adds of the transposes, the
    updater, loss, dropout, relu masks, other elementwise work)."""
    low = name.lower()
    for kernel in ('conv_bias_act_kernel', 'conv_bias_act_bf16_kernel',
                   'lrn_fwd_kernel', 'lrn_bwd_kernel',
                   'fullc_gemm_kernel', 'fullc_gemm_bf16_kernel',
                   'fullc_gemm_nt_kernel', 'fullc_gemm_nt_bf16_kernel',
                   'fullc_gemm_tn_kernel', 'fullc_gemm_tn_bf16_kernel',
                   'threefry_uniform_kernel', 'paged_decode_kernel',
                   'paged_verify_kernel', 'paged_empty_kernel',
                   'int8_gemm_kernel', 'sp_splitk_sum'):
        if kernel in name:
            return 'port:' + kernel
    if any(s in low for s in ('dgrad', 'wgrad', 'cudnn', 'convolve',
                              'implicit', 'conv2d', 'conv_')):
        return 'cudnn_conv'
    if any(s in low for s in ('gemm', 'gemv', 'nvjet')):
        return 'cublas_gemm'
    if 'pool' in low:
        return 'pooling'
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    return 'elementwise_and_reductions'


# profiler ranges of the package whose device time a step reports: the
# conv block's transposes (GEMMs, patch copies and col2im adds)
PROFILE_RANGES = ('conv_transposes',)


def profile_steps(step, steps=2):
    """Device time of ``steps`` train steps, ``step(i)`` each, by kernel
    family (``torch.profiler``), against the host wall time of the
    window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = dict.fromkeys(PROFILE_RANGES, 0.0)
    for e in prof.events():
        # the host-side range: its device time sums the kernels launched
        # inside it (the device-side annotation of the same name is not
        # counted, here or by family)
        if e.name in ranges and \
                str(getattr(e, 'device_type', '')).split('.')[-1] == 'CPU':
            ranges[e.name] += float(e.device_time_total) / 1e3 / steps
    fam, top = {}, []
    for e in prof.key_averages():
        if e.key in ranges or \
                str(getattr(e, 'device_type', '')).split('.')[-1] != 'CUDA':
            continue
        us = float(getattr(e, 'self_device_time_total', 0.0)
                   or getattr(e, 'self_cuda_time_total', 0.0))
        key = _kernel_family(e.key)
        fam[key] = fam.get(key, 0.0) + us / 1e3 / steps
        top.append((us / 1e3 / steps, e.key[:80]))
    busy = sum(fam.values())
    return {'steps': steps, 'wall_ms_per_step': wall_ms / steps,
            'device_ms_per_step': busy,
            'idle_share': 1.0 - busy * steps / wall_ms if wall_ms else None,
            'by_family_ms': dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            # device ms per step of the kernels launched inside each range
            'ranges_ms': ranges,
            'top_kernels_ms': sorted(top, reverse=True)[:12]}


def _step_change(net, batch):
    """One ``Net.update`` on ``batch`` from a fresh optimizer state; the
    weight change, by (layer, field), and the step's loss.  The change is
    read from SGD's momentum slot, which holds ``-lr (g + wd w)`` before
    it is added to the weights: the difference of the f32 weights would
    round it to the weights' last place, a few thousandths of a change
    that an Inception net's small gradients make a few hundred ulps."""
    net.update(*batch)
    dw = {(k, f): v.detach().clone()
          for k, fs in net.trainer.opt_state['m'].items()
          for f, v in fs.items()}
    return dw, float(net.trainer.last_loss)


def stock_comparison(make, batch, failures, kernel=(), tag='train'):
    """One SGD step of the kernels (``auto``, as the main path trains, or
    the net params ``kernel`` on top) against one of the stock
    composition (``use_pallas=0 fuse=0``) from the same seed, batch and
    dropout masks (both legs draw them through the threefry kernel, the
    one port kernel a stock leg launches): per weight, max |dw_kernel -
    dw_stock| / max |dw_stock|.  The stock leg replays the kernel leg's
    relu and max-pooling choices (``layers.Decisions``) and runs with
    cuDNN disabled, on PyTorch's native f32 convolution: it is the
    reference, and cuDNN's f32 weight gradient of the grouped conv2 is
    ~3e-2 of its largest value from float64 (``tests/test_torch_cuda.py``
    holds the kernel leg's conv backward to float64)."""
    from cxxnet_tpu_torch.layers import Decisions
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    decisions = Decisions()
    net = make(*kernel)
    net.trainer.decisions = decisions
    w0 = _weights(net)
    dw_kernel, kernel_loss = _step_change(net, batch)
    del net
    decisions.replay = True
    with torch.backends.cudnn.flags(enabled=False):
        net = make(('use_pallas', '0'), ('fuse', '0'))
        if any(not torch.equal(w, w0[key])
               for key, w in _weights(net).items()):
            failures.append(f'{tag}[stock]: initial weights differ from '
                            'the kernel leg')
        net.trainer.decisions = decisions
        reset_launch_counts()
        dw_stock, stock_loss = _step_change(net, batch)
        if any(v for k, v in launch_counts().items() if k != RANDOM_KERNEL):
            failures.append(f'{tag}[stock]: the stock leg launched port '
                            'kernels')
    del net, decisions
    rel = {'/'.join(key): ((dw_kernel[key] - d).abs().max()
                           / d.abs().max().clamp_min(1e-30)).item()
           for key, d in dw_stock.items()}
    worst = max(rel.values())
    if not worst <= STOCK_TOL:
        failures.append(f'{tag}[stock]: one-step weight change differs by '
                        f'{worst} of its largest value > {STOCK_TOL}')
    if not abs(kernel_loss - stock_loss) <= 1e-5 * abs(stock_loss):
        failures.append(f'{tag}[stock]: first-step loss {kernel_loss} vs '
                        f'stock {stock_loss}')
    return {'kernel_leg': dict(kernel) or 'auto', 'tol': STOCK_TOL,
            'max_rel_dw_err': worst,
            'loss': {'kernel': kernel_loss, 'stock': stock_loss},
            'rel_dw_err': rel}


@functools.lru_cache(maxsize=None)
def _synthetic_batches(batch, hw, n=4):
    """``n`` seeded batches of ``batch`` NCHW f32 images of ``hw`` x
    ``hw`` pixels and labels of 1000 classes, made once per shape (read
    only) for every leg that trains at it."""
    rng = np.random.default_rng(SEED)
    return [(rng.standard_normal((batch, 3, hw, hw), dtype=np.float32),
             rng.integers(0, 1000, batch).astype(np.float32))
            for _ in range(n)]


def _net_maker(conf, *fixed):
    """``make(*pairs)``: a ``Net`` on the card from ``conf`` with the net
    params ``fixed`` and ``pairs``, seeded from ``SEED`` and initialised."""
    from cxxnet_tpu_torch import Net

    def make(*pairs):
        net = Net(dev='cuda', cfg=conf)
        for k, v in (('seed', str(SEED)),) + fixed + pairs:
            net.set_param(k, v)
        net.init_model()
        return net
    return make


def _train_steps(net, batches, n, want, tag, failures):
    """``n`` updates; per step the host ms (ending in the loss readback),
    the loss and the kernel launches, which must equal ``want``."""
    from cxxnet_tpu_torch.ops.kernels import launch_counts
    out = {'step_ms': [], 'loss': [], 'per_step': []}
    for i in range(n):
        before = launch_counts()
        t0 = time.perf_counter()
        net.update(*batches[i % len(batches)])
        loss = float(net.trainer.last_loss)
        out['step_ms'].append((time.perf_counter() - t0) * 1e3)
        out['loss'].append(loss)
        after = launch_counts()
        out['per_step'].append({k: after[k] - before[k] for k in after})
    for i, (loss, per) in enumerate(zip(out['loss'], out['per_step'])):
        if not np.isfinite(loss):
            failures.append(f'{tag}: step {i} loss {loss}')
        if per != want:
            failures.append(f'{tag}: step {i} launched {per}, want {want}')
    return out


def train_phase(failures):
    """Full-width AlexNet training through ``Net.update``: the ``auto``
    leg (the main path), the ``use_pallas=1`` leg and the stock step."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.updater import apply_updates
    batches = _synthetic_batches(BATCH, 227)
    make = _net_maker(_example_conf('ImageNet.conf', 'ImageNet_train.conf'))

    def steps(net, n, mode):
        return _train_steps(net, batches, n, STEP_LAUNCHES[mode],
                            f'train[{mode}]', failures)

    torch.cuda.reset_peak_memory_stats()
    net = make()
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    auto = steps(net, TRAIN_STEPS, 'auto')
    launches_auto = launch_counts()
    # --------------------------------------------------------------------
    peak_bytes = torch.cuda.max_memory_allocated()
    train_line = net.trainer.evaluate(None, 'train')
    breakdown = profile_steps(
        lambda i: net.update(*batches[i % len(batches)]))
    tr = net.trainer
    updater_ms = time_ms(lambda: apply_updates(
        tr.net_cfg.updater_type, tr.hypers, tr.params, tr.grad_acc,
        tr.opt_state, tr.epoch_counter), 5)
    del net, tr
    torch.cuda.empty_cache()

    # ---- use_pallas=1: every kernel, counts from 0 ----------------------
    net = make(('use_pallas', '1'))
    reset_launch_counts()
    forced = steps(net, PALLAS_STEPS, 'on')
    launches_on = launch_counts()
    # --------------------------------------------------------------------
    for name, cnt in launches_on.items():
        if (cnt > 0) != (STEP_LAUNCHES['on'][name] > 0):
            failures.append(f'train[on]: kernel {name} launched {cnt} '
                            'times')
    del net
    torch.cuda.empty_cache()

    # ---- one step of the kernels against the stock composition ----------
    stock = stock_comparison(make, batches[0], failures)
    torch.cuda.empty_cache()

    p50 = float(np.median(auto['step_ms']))
    return {'phase': 'train', 'batch': BATCH, 'steps': TRAIN_STEPS,
            'step_ms': auto['step_ms'], 'step_ms_p50': p50,
            'images_per_s': BATCH / p50 * 1e3, 'loss': auto['loss'],
            'train_metrics': train_line.strip(),
            'launches': launches_auto,
            'launches_per_step': auto['per_step'][-1],
            'max_memory_allocated': peak_bytes,
            'updater_ms': updater_ms, 'profile': breakdown,
            'use_pallas_1': {'steps': PALLAS_STEPS,
                             'step_ms': forced['step_ms'],
                             'loss': forced['loss'],
                             'launches': launches_on,
                             'launches_per_step': forced['per_step'][-1]},
            'stock': stock}


def _write_idx(d, name, n, seed):
    """4 quadrant-blob classes of 28x28 uint8 images, as gzip idx files
    (big-endian header, then the raw bytes)."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 4, n).astype(np.uint8)
    img = np.zeros((n, 28, 28), np.uint8)
    for i, c in enumerate(lab):
        y0, x0 = (c // 2) * 14, (c % 2) * 14
        img[i, y0 + 2:y0 + 12, x0 + 2:x0 + 12] = rng.randint(128, 256,
                                                             (10, 10))
    with gzip.open(os.path.join(d, f'{name}-images-idx3-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>iiii', 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(d, f'{name}-labels-idx1-ubyte.gz'),
                   'wb') as f:
        f.write(struct.pack('>ii', 2049, n) + lab.tobytes())


def cli_phase(failures):
    """``python -m cxxnet_tpu_torch.main`` on the card: MNIST_CONV.conf
    over synthetic idx files, 2 rounds, every kernel forced on."""
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, 'data'))
        _write_idx(os.path.join(d, 'data'), 'train', 2000, 1)
        _write_idx(os.path.join(d, 'data'), 't10k', 500, 2)
        with open(os.path.join(ROOT, 'example', 'MNIST',
                               'MNIST_CONV.conf')) as f:
            conf = f.read()
        with open(os.path.join(d, 'conv.conf'), 'w') as f:
            f.write(conf + 'metric = logloss\n')
        cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', 'conv.conf',
               'dev=cuda', 'use_pallas=1', 'num_round=2', 'max_round=2',
               'save_model=1', 'model_dir=models']
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            p for p in (ROOT, env.get('PYTHONPATH')) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=d, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stderr.splitlines() if ln.startswith('[')]
        models = sorted(os.listdir(os.path.join(d, 'models'))) \
            if os.path.isdir(os.path.join(d, 'models')) else []
    test_error = None
    if lines and '\ttest-error:' in lines[-1]:
        test_error = float(lines[-1].split('\ttest-error:')[1]
                           .split('\t')[0])
    if proc.returncode != 0:
        failures.append(f'cli_train: exit {proc.returncode}: '
                        f'{proc.stderr[-2000:]}')
    if len(lines) != 2:
        failures.append(f'cli_train: {len(lines)} eval lines, want 2')
    if test_error is None or not test_error <= CLI_MAX_TEST_ERROR:
        failures.append(f'cli_train: test-error {test_error} > '
                        f'{CLI_MAX_TEST_ERROR}')
    for name in ('0002.model', '0002.model.crc32'):
        if name not in models:
            failures.append(f'cli_train: no models/{name}')
    return {'phase': 'cli_train', 'cmd': ' '.join(cmd[1:]),
            'rc': proc.returncode, 'seconds': wall, 'eval_lines': lines,
            'test_error': test_error, 'models': models}

# --- the ImageNet confs' data chain ------------------------------------------

#: the fixture chain's pages: 1024 int32 slots (4 KB), four 16 x 16 images
FIXTURE_PAGE_INTS = 1024


def imgbin_fixture_digest(create_iterator, page_cls, workdir):
    """sha256 of the fixture chain's batches: 37 seeded 16 x 16 images in
    four quadrant classes, stored PNG (``compress_level=0``, so the page
    layout does not hang on a compressor's version) in 4 KB pages, through
    two chains over two epochs each: ``imgbin`` with ``shuffle``, random
    crop and mirror to 3 x 12 x 12, a mean image created on first use,
    random contrast and illumination and ``round_batch = 1``; then
    ``imgbinx`` with ``shuffle``, the pooled path (``nworker = 2``) and
    ``device_normalize = 1`` over the saved mean image, with a padded
    tail.  ``create_iterator`` and ``page_cls`` are one package's (the CPU
    tests pass the JAX package's and the port's; the digest they pinned is
    ``tests/fixtures/torch_imgbin_digest.json``).  The page size is set on
    ``page_cls`` for the call and restored."""
    import hashlib
    import io as _io
    from PIL import Image
    rng = np.random.RandomState(20261018)
    lst = os.path.join(workdir, 'fixture.lst')
    binp = os.path.join(workdir, 'fixture.bin')
    mean = os.path.join(workdir, 'fixture_mean.bin')
    saved = page_cls.K_PAGE_SIZE, page_cls.N_BYTES
    page_cls.K_PAGE_SIZE, page_cls.N_BYTES = (FIXTURE_PAGE_INTS,
                                              FIXTURE_PAGE_INTS * 4)
    digest = hashlib.sha256()
    try:
        page = page_cls()
        with open(binp, 'wb') as fb, open(lst, 'w') as fl:
            for i in range(37):
                c = int(rng.randint(0, 4))
                arr = rng.randint(0, 40, (16, 16, 3)).astype(np.uint8)
                arr[(c // 2) * 8:(c // 2) * 8 + 8,
                    (c % 2) * 8:(c % 2) * 8 + 8] += np.uint8(150)
                buf = _io.BytesIO()
                Image.fromarray(arr).save(buf, format='PNG', compress_level=0)
                if not page.push(buf.getvalue()):
                    page.save(fb)
                    page.clear()
                    page.push(buf.getvalue())
                fl.write(f'{i}\t{c}\timg{i}.png\n')
            page.save(fb)
        common = [('image_list', lst), ('image_bin', binp),
                  ('image_mean', mean), ('input_shape', '3,12,12'),
                  ('batch_size', '8'), ('shuffle', '1'), ('rand_crop', '1'),
                  ('rand_mirror', '1'), ('seed_data', '7'), ('silent', '1')]
        chains = (
            [('iter', 'imgbin')] + common + [
                ('max_random_contrast', '0.2'),
                ('max_random_illumination', '8'), ('round_batch', '1'),
                ('iter', 'threadbuffer'), ('iter', 'end')],
            [('iter', 'imgbinx')] + common + [
                ('nworker', '2'), ('device_normalize', '1'),
                ('iter', 'threadbuffer'), ('iter', 'end')])
        for cfg in chains:
            it = create_iterator(cfg)
            it.init()
            try:
                for _ in range(2):
                    for b in it:
                        spec = b.norm_spec
                        for arr in (b.data, b.label, b.inst_index,
                                    np.asarray([b.num_batch_padd,
                                                b.pad_synthetic]),
                                    np.zeros(0, np.float32) if spec is None
                                    else spec.resolved_mean(),
                                    np.float32([0 if spec is None
                                                else spec.scale])):
                            digest.update(str(arr.dtype).encode())
                            digest.update(np.ascontiguousarray(arr)
                                          .tobytes())
            finally:
                close = getattr(it, 'close', None)
                if close is not None:
                    close(5.0)
        with open(mean, 'rb') as f:
            digest.update(f.read())
    finally:
        page_cls.K_PAGE_SIZE, page_cls.N_BYTES = saved
    return digest.hexdigest()


# the reference ImageNet conf's chain at the reference's image size: 640
# training and 300 test images of 256 x 256, four classes, JPEG quality 90
IMGBIN = dict(train=640, test=300, size=256, seed=20261019)
IMGBIN_STEPS = 3
IMGBIN_COLOURS = ((200, 40, 40), (40, 200, 40), (40, 40, 200),
                  (200, 200, 40))


def _synth_images(root, stem, n, seed, colours=IMGBIN_COLOURS):
    """``n`` seeded 256 x 256 RGB images, a quadrant a class (the label)
    lifted by that class's ``colours`` over noise, as JPEG quality 90
    under ``root/img``, and their ``.lst`` (``index \\t label \\t file``)
    as ``root/stem``."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    size, h = IMGBIN['size'], IMGBIN['size'] // 2
    os.makedirs(os.path.join(root, 'img'), exist_ok=True)
    with open(os.path.join(root, stem), 'w') as f:
        for i in range(n):
            c = int(rng.randint(0, 4))
            arr = rng.randint(0, 56, (size, size, 3)).astype(np.uint8)
            y0, x0 = (c // 2) * h, (c % 2) * h
            arr[y0:y0 + h, x0:x0 + h] += np.asarray(colours[c], np.uint8)
            name = f'{stem}_{i}.jpg'
            Image.fromarray(arr).save(os.path.join(root, 'img', name),
                                      format='JPEG', quality=90)
            f.write(f'{i}\t{c}\t{name}\n')


def _stamped_run(cmd, cwd, env, timeout):
    """Run ``cmd``; every output line is stamped with the seconds since
    the start at which it arrived.  Killed at ``timeout``.  Returns
    ``(rc, [(t, stdout line)], [(t, stderr line)], wall seconds)``."""
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, bufsize=1)
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    t0 = time.perf_counter()
    lines = {'out': [], 'err': []}

    def read(stream, key):
        for line in stream:
            lines[key].append((time.perf_counter() - t0, line.rstrip('\n')))
    th = threading.Thread(target=read, args=(proc.stderr, 'err'),
                          daemon=True)
    th.start()
    try:
        read(proc.stdout, 'out')
        rc = proc.wait()
        th.join(60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, lines['out'], lines['err'], time.perf_counter() - t0


def _eval_fields(line):
    return {tok.split(':')[0]: float(tok.split(':')[1])
            for tok in line.split('\t')[1:] if ':' in tok}


def _cli_train_run(tag, conf, cwd, env, failures, extra=(), here=False):
    """One CLI training run of ``conf``; its round's seconds from the
    ``update round 0`` line to the eval line (3 steps over 640 images
    and the 300-image eval), the eval and ``io-`` fields.  ``here`` runs
    the CLI's ``main`` in this process (warm: no process start, no round
    seconds) instead of a child process."""
    cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', conf,
           'num_round=1', 'max_round=1', *extra]
    if here:
        rc, out, err, wall = _cli_in_process(cmd[3:], cwd)
    else:
        rc, out, err, wall = _stamped_run(cmd, cwd, env, 600)
    evals = [(t, ln) for t, ln in err if ln.startswith('[')]
    start = [t for t, ln in out if ln.startswith('update round 0')]
    res = {'cmd': ' '.join(cmd[1:]), 'rc': rc, 'seconds': wall,
           'process': 'this' if here else 'child',
           'eval_lines': [ln for _, ln in evals]}
    if rc != 0:
        failures.append(f'{tag}: exit {rc}: '
                        + '\n'.join(ln for _, ln in err[-40:]))
        return res
    if len(evals) != 1 or not start:
        failures.append(f'{tag}: {len(evals)} eval lines, want 1')
        return res
    fields = _eval_fields(evals[0][1])
    for key in ('test-error', 'test-rec@1', 'test-rec@5'):
        if not np.isfinite(fields.get(key, np.nan)):
            failures.append(f'{tag}: {key} {fields.get(key)}')
    res['round_s'] = evals[0][0] - start[0]
    res['images_per_s'] = IMGBIN['train'] / res['round_s']
    res['eval'] = {k: v for k, v in fields.items()
                   if not k.startswith('io-')}
    res['io'] = {k[3:]: v for k, v in fields.items() if k.startswith('io-')}
    return res


def _section_pairs(conf_path, section, extra=()):
    """One ``section`` (e.g. ``('data', 'train')``) of a conf as
    ``main.py`` reads it: the section's pairs, with ``extra`` right after
    its source line, and the conf's global pairs."""
    from cxxnet_tpu_torch.utils.config import parse_config_file
    sec, cur, defcfg, flag = None, [], [], 0
    for name, val in parse_config_file(conf_path):
        if name in ('data', 'eval', 'pred'):
            flag, cur = (1 if (name, val) == section else 2), []
        elif name == 'iter' and val == 'end' and flag:
            if flag == 1:
                sec = cur
            flag = 0
        elif flag:
            cur.append((name, val))
            if flag == 1 and len(cur) == 1:
                cur.extend(extra)
        else:
            defcfg.append((name, val))
    return sec, defcfg


def _section_chain(conf_path, section, extra):
    """The iterator chain of one ``section`` of a conf, built as
    ``main.py`` builds it (:func:`_section_pairs`), then ``init``."""
    from cxxnet_tpu_torch.io.data import create_iterator
    sec, defcfg = _section_pairs(conf_path, section, extra)
    it = create_iterator(sec)
    for name, val in defcfg:
        it.set_param(name, val)
    it.init()
    return it


def _host_chain_rate(conf, extra):
    """Images/s of one pass of the conf's train chain on the host alone,
    and its batches."""
    it = _section_chain(conf, ('data', 'train'), extra)
    try:
        t0 = time.perf_counter()
        batches = list(it)
        dt = time.perf_counter() - t0
    finally:
        it.close(10.0)
    return IMGBIN['train'] / dt, batches


def _chain_train_rate(net, conf, extra, epochs=2):
    """Images/s of the last of ``epochs`` passes of the conf's train
    chain (``threadbuffer`` overlapping the host's decode and augment
    with the steps) through ``net.update``, each step's loss read back."""
    it = _section_chain(conf, ('data', 'train'), extra)
    try:
        for _ in range(epochs):
            t0 = time.perf_counter()
            for batch in it:
                net.update(batch)
                float(net.trainer.last_loss)
            dt = time.perf_counter() - t0
    finally:
        it.close(10.0)
    return IMGBIN['train'] / dt


def _decode_ms(blob, reps=20):
    from cxxnet_tpu_torch.io.iter_img import decode_image
    decode_image(blob)
    t0 = time.perf_counter()
    for _ in range(reps):
        decode_image(blob)
    return (time.perf_counter() - t0) / reps * 1e3


# the pred leg's tasks: the last node's 1000 scores, the node fc7 writes
# (its output node 19: nodes are named by their numbers in layer[a->b],
# and "fc7" names the layer) and the finetuned head's classes
CLI_TASK_NODE, CLI_TASK_WIDTH, FINETUNE_CLASSES = '19', 4096, 4
# launches of one eval batch of the reference conf as written: its relus
# are out of place (layer[1->2] = relu), and under auto neither package
# pairs a conv with a relu that is not in place (JAX nnet/net.py:566-571),
# so its convs run F.conv2d; the two LRN forwards and fc8's GEMM launch
CLI_TASK_EVAL = {'lrn_forward': 2, 'fullc_gemm': 1}
FINETUNE_COPIED = ('conv1', 'conv2', 'conv3', 'conv4', 'conv5', 'fc6', 'fc7')


def _leg_s(lines, start, end):
    """Seconds between the first stdout lines that start with ``start``
    and ``end``: a CLI task's loop, without its process start-up."""
    t0 = [t for t, ln in lines if ln.startswith(start)]
    t1 = [t for t, ln in lines if ln.startswith(end)]
    return t1[0] - t0[0] if t0 and t1 else None


def _cli_task(tag, work, env, failures, conf, *args):
    """One CLI task through the CLI's ``main`` in this process (warm)."""
    cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', conf, *args]
    rc, so, se, wall = _cli_in_process(cmd[3:], work)
    res = {'cmd': ' '.join(cmd[1:]), 'rc': rc, 'seconds': wall}
    if rc != 0:
        failures.append(f'cli_tasks[{tag}]: exit {rc}: '
                        + '\n'.join(ln for _, ln in se[-20:]))
    return res, so, se


def _section_text(conf_path, section):
    """A ``DataIter`` config that builds the chain of ``section`` as
    ``main.py`` does: its pairs, ``iter = end``, the conf's global
    pairs."""
    sec, defcfg = _section_pairs(conf_path, section)
    return ''.join(f"{k} = '{v}'\n"
                   for k, v in sec + [('iter', 'end')] + defcfg)


def cli_tasks(work, env, conf_text, failures):
    """The CLI's other tasks, each through the CLI's ``main`` in this
    process, on the ``task=pred`` leg's model, test bin and ``pred.txt``:
    ``pred_raw`` (300 rows of 1000 finite scores whose
    argmax is ``pred.txt``), ``extract`` of node 19 (fc7's output) as raw
    f32 (300 x 4096, finite) and of ``top[-1]`` as text (the ``pred_raw``
    file, byte for byte), ``serve`` on buckets 1, 32, 256 (``pred.txt``
    byte for byte, 3 programs, the ``[serve]`` line), ``finetune`` into a
    4-class ``fc8_ft`` head for one round (seven ``Copying layer`` lines,
    one finite eval line, ``models_ft/0001.model``); then in process a
    ``LearnTask`` at ``task=finetune`` through ``init`` (the copied
    weights bitwise the source's, the head 4 x 4096) and a
    ``wrapper.Net`` loaded from the model, whose ``extract_stream`` of
    node 19 over the test bin must be the CLI's file bit for bit, at the
    eval forward's launches a batch (the main path of this leg)."""
    from cxxnet_tpu_torch import wrapper
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet import checkpoint
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.utils.config import parse_config_file
    n = IMGBIN['test']
    out = {}
    path = functools.partial(os.path.join, work)
    with open(path('pred.txt')) as f:
        pred_lines = f.read()
    want_cls = np.array([float(v) for v in pred_lines.split()])
    model = 'model_in=models/0001.model'

    # ---- task=pred_raw ---------------------------------------------------
    res, so, _ = _cli_task('pred_raw', work, env, failures, 'pred.conf',
                           'task=pred_raw', model, 'pred=raw.txt')
    res['loop_s'] = _leg_s(so, 'start predicting', 'finished prediction')
    rows = np.loadtxt(path('raw.txt'), ndmin=2) \
        if os.path.exists(path('raw.txt')) else np.zeros((0, 0))
    res['shape'] = list(rows.shape)
    if rows.shape != (n, 1000) or not np.isfinite(rows).all():
        failures.append(f'cli_tasks[pred_raw]: {rows.shape} rows, finite '
                        f'{bool(np.isfinite(rows).all())}')
    elif not np.array_equal(rows.argmax(1), want_cls):
        failures.append('cli_tasks[pred_raw]: argmax differs from pred.txt '
                        f'on {int((rows.argmax(1) != want_cls).sum())} rows')
    out['pred_raw'] = res

    # ---- task=extract: node 19 in binary, top[-1] in text ------------------
    res, so, _ = _cli_task('extract_bin', work, env, failures, 'pred.conf',
                           'task=extract', model,
                           f'extract_node_name={CLI_TASK_NODE}',
                           'output_format=bin', 'pred=fc7.bin')
    res['loop_s'] = _leg_s(so, 'start extracting', 'finished extract')
    size = os.path.getsize(path('fc7.bin')) \
        if os.path.exists(path('fc7.bin')) else None
    res['bytes'] = size
    fc7 = None
    if size != n * CLI_TASK_WIDTH * 4:
        failures.append(f'cli_tasks[extract_bin]: {size} bytes, want '
                        f'{n * CLI_TASK_WIDTH * 4}')
    else:
        fc7 = np.fromfile(path('fc7.bin'), '<f4')
        if not np.isfinite(fc7).all():
            failures.append('cli_tasks[extract_bin]: non-finite values')
    out['extract_bin'] = res
    res, so, _ = _cli_task('extract_txt', work, env, failures, 'pred.conf',
                           'task=extract', model,
                           'extract_node_name=top[-1]', 'pred=top.txt')
    res['loop_s'] = _leg_s(so, 'start extracting', 'finished extract')
    same = (os.path.exists(path('top.txt')) and os.path.exists(
        path('raw.txt')) and open(path('top.txt'), 'rb').read()
        == open(path('raw.txt'), 'rb').read())
    res['equals_pred_raw'] = same
    if not same:
        failures.append('cli_tasks[extract_txt]: the top[-1] file is not '
                        'the pred_raw file byte for byte')
    out['extract_txt'] = res

    # ---- task=serve --------------------------------------------------------
    res, so, se = _cli_task('serve', work, env, failures, 'pred.conf',
                            'task=serve', model, 'serve.buckets=1,32,256',
                            'pred=serve.txt')
    res['loop_s'] = _leg_s(so, 'start serving', 'finished serving')
    stdout = '\n'.join(ln for _, ln in so)
    serve_line = [ln for _, ln in se if ln.startswith('[serve]')]
    res['serve_line'] = serve_line[-1] if serve_line else None
    if serve_line:
        # one request a batch of the test bin: a handful of samples a
        # bucket, so each bucket's count stands beside its mean
        fields = _eval_fields(serve_line[-1])
        res['latency_ms'] = {
            k.split('[')[1].split(']')[0]: {
                'n': fields[k], 'mean': fields[k[:-2] + '.mean']}
            for k in fields
            if k.startswith('serve-latency_ms[') and k.endswith('.n')}
    if 'compiled 3 programs for 3 buckets' not in stdout:
        failures.append(f'cli_tasks[serve]: stdout {stdout[-400:]!r}')
    if not serve_line or 'serve-requests:' not in serve_line[-1]:
        failures.append('cli_tasks[serve]: no [serve] line with '
                        'serve-requests')
    served = open(path('serve.txt')).read() \
        if os.path.exists(path('serve.txt')) else None
    res['equals_pred'] = served == pred_lines
    if served != pred_lines:
        failures.append('cli_tasks[serve]: the prediction file is not '
                        'pred.txt byte for byte')
    out['serve'] = res
    for key in ('pred_raw', 'extract_bin', 'extract_txt', 'serve'):
        if out[key].get('loop_s'):
            out[key]['images_per_s'] = n / out[key]['loop_s']

    # ---- task=finetune -----------------------------------------------------
    ft_text = conf_text.replace('fullc:fc8\n  nhidden = 1000',
                                f'fullc:fc8_ft\n  nhidden = '
                                f'{FINETUNE_CLASSES}')
    # rec@5 needs five scores a row
    ft_text = ft_text.replace('metric = rec@5\n', '')
    if 'fc8_ft' not in ft_text:
        failures.append('cli_tasks[finetune]: no fullc:fc8 in the conf')
    with open(path('ft.conf'), 'w') as f:
        f.write(ft_text)
    cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', 'ft.conf',
           'task=finetune', model, 'model_dir=models_ft', 'num_round=1',
           'max_round=1', 'start_counter=1']
    rc, so, se, wall = _cli_in_process(cmd[3:], work)
    copies = [ln for _, ln in so if ln.startswith('Copying layer')]
    evals = [ln for _, ln in se if ln.startswith('[')]
    res = {'cmd': ' '.join(cmd[1:]), 'rc': rc, 'seconds': wall,
           'copying': copies, 'eval_lines': evals,
           'round_s': _leg_s(so, 'update round 0', 'updating end')}
    want_copies = [f'Copying layer {name}' for name in FINETUNE_COPIED]
    if rc != 0:
        failures.append(f'cli_tasks[finetune]: exit {rc}: '
                        + '\n'.join(ln for _, ln in se[-20:]))
    elif copies != want_copies:
        failures.append(f'cli_tasks[finetune]: {copies}')
    elif len(evals) != 1 or not all(
            np.isfinite(v) for v in _eval_fields(evals[0]).values()):
        failures.append(f'cli_tasks[finetune]: eval lines {evals}')
    elif not os.path.exists(path('models_ft', '0001.model')):
        failures.append('cli_tasks[finetune]: no models_ft/0001.model')
    out['finetune'] = res

    # ---- in process --------------------------------------------------------
    old_cwd = os.getcwd()
    os.chdir(work)
    try:
        lt = LearnTask()
        for k, v in parse_config_file('ft.conf') + [
                ('task', 'finetune'), ('model_in', 'models/0001.model')]:
            lt.set_param(k, v)
        lt.init()
        for it in lt._iterators():
            it.close(10.0)
        net = wrapper.Net(cfg=conf_text)
        net.load_model('models/0001.model')
        src, tr = net.trainer, lt.net_trainer
        bitwise = {}
        for name in FINETUNE_COPIED:
            i = src.net_cfg.get_layer_index(name)
            j = tr.net_cfg.get_layer_index(name)
            bitwise[name] = sorted(src.params[str(i)]) == sorted(
                tr.params[str(j)]) and all(
                torch.equal(src.params[str(i)][f], tr.params[str(j)][f])
                for f in src.params[str(i)])
        head = tr.net_cfg.get_layer_index('fc8_ft')
        head_shape = list(checkpoint.to_disk_layout(
            tr.net_cfg.layers[head].type, 'wmat',
            tr.params[str(head)]['wmat'].cpu().numpy(), 1).shape)
        out['finetune_init'] = {'bitwise': bitwise, 'head_shape': head_shape,
                                'epoch_counter': tr.epoch_counter}
        if not all(bitwise.values()) or head_shape != [
                FINETUNE_CLASSES, 4096] or tr.epoch_counter != 0:
            failures.append(f'cli_tasks[finetune_init]: '
                            f'{out["finetune_init"]}')
        del lt, tr
        it = wrapper.DataIter(_section_text('pred.conf',
                                            ('pred', 'pred.txt')))
        want = {k: v * -(-n // BATCH)
                for k, v in as16({**_NO_LAUNCH, **CLI_TASK_EVAL}).items()}
        torch.cuda.synchronize()
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        t0 = time.perf_counter()
        feats = np.concatenate(list(net.extract_stream(it, CLI_TASK_NODE)))
        wall = time.perf_counter() - t0
        launches = launch_counts()
        # ------------------------------------------------------------------
        it.close(10.0)
        del net
    finally:
        os.chdir(old_cwd)
    equal = fc7 is not None and feats.shape == (n, CLI_TASK_WIDTH) and \
        feats.astype('<f4').tobytes() == fc7.tobytes()
    out['in_process_extract'] = {
        'node': CLI_TASK_NODE, 'shape': list(feats.shape), 'seconds': wall,
        'images_per_s': n / wall, 'equals_cli_file': equal,
        'launches': launches, 'launches_want': want}
    if not equal:
        failures.append('cli_tasks[in_process]: extract_stream is not the '
                        'CLI file bit for bit')
    if launches != want:
        failures.append(f'cli_tasks[in_process]: launched {launches}, '
                        f'want {want}')
    return out



def cli_imgbin_phase(bf16, failures):
    """The reference ``example/ImageNet/ImageNet.conf`` as written,
    trained from the CLI on a synthesized imgbin: the conf's own chain
    (``imgbin``, random crop and mirror, a mean image created on first
    use, ``threadbuffer``) at 256 x 256, ``dev = tpu`` (CUDA 0),
    ``compute_type = bfloat16``; then with ``nworker = 8`` and
    ``device_normalize = 1``; then ``task=pred`` over the test set; then
    the chain in process, ``device_normalize = 1``, into the ``bf16``
    phase's AlexNet for 3 steps at its exact launches; then the fixture
    digest on this host."""
    import io as _io
    from PIL import Image
    from cxxnet_tpu_torch.io.data import create_iterator
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.utils.io_stream import BinaryPage
    out = {'phase': 'cli_imgbin', 'cpu_count': os.cpu_count(),
           'nvidia_smi': nvidia_smi_line(), 'images': dict(IMGBIN)}
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    with open(os.path.join(ROOT, 'example', 'ImageNet',
                           'ImageNet.conf')) as f:
        conf_text = f.read()
    with tempfile.TemporaryDirectory() as root:
        work, out['dataset_s'] = _imgbin_workdir(root, env, failures,
                                                 'cli_imgbin')
        # decode ms per image (PIL, as the chain decodes)
        jpg = open(os.path.join(root, 'img', 'NameList.train_0.jpg'),
                   'rb').read()
        with Image.open(_io.BytesIO(jpg)) as im:
            buf = _io.BytesIO()
            im.save(buf, format='PNG')
        out['decode_ms'] = {'jpeg_q90': _decode_ms(jpg),
                            'png': _decode_ms(buf.getvalue()),
                            'jpeg_bytes': len(jpg),
                            'png_bytes': len(buf.getvalue())}

        # ---- the conf as written ----------------------------------------
        run = _cli_train_run('cli_imgbin[conf]', 'ImageNet.conf', work, env,
                             failures)
        models = sorted(os.listdir(os.path.join(work, 'models')))
        run['models'] = models
        if '0001.model' not in models:
            failures.append('cli_imgbin[conf]: no models/0001.model')
        mean_path = os.path.join(work, 'models', 'image_net_mean.bin')
        shape = None
        if os.path.exists(mean_path):
            with open(mean_path, 'rb') as f:
                ndim = struct.unpack('<I', f.read(4))[0]
                shape = list(struct.unpack(f'<{ndim}I', f.read(4 * ndim)))
        run['mean_shape'] = shape
        if shape != [3, 227, 227]:
            failures.append(f'cli_imgbin[conf]: mean image {shape}')
        out['conf'] = run

        # ---- nworker = 8, device_normalize = 1 ---------------------------
        pooled_text = conf_text.replace(
            '  rand_mirror=1\n',
            '  rand_mirror=1\n  nworker = 8\n  device_normalize = 1\n', 1)
        if pooled_text == conf_text:
            failures.append('cli_imgbin: no rand_mirror line in the conf')
        with open(os.path.join(work, 'pooled.conf'), 'w') as f:
            f.write(pooled_text)
        mean_mtime = os.path.getmtime(mean_path) \
            if os.path.exists(mean_path) else None
        out['pooled'] = _cli_train_run('cli_imgbin[pooled]', 'pooled.conf',
                                       work, env, failures)
        if mean_mtime is None or os.path.getmtime(mean_path) != mean_mtime:
            failures.append('cli_imgbin[pooled]: the mean image was '
                            'rewritten, not loaded')
        if not out['pooled'].get('io', {}).get('collate_ms.n'):
            failures.append('cli_imgbin[pooled]: no io- stats on the eval '
                            'line')

        # ---- steps_per_dispatch=4 scan_strict=1 against K=1 -------------
        # batch 64 (a CLI override) gives a round of 10 steps: two windows
        # of 4 and a per-step tail of 2 (at the conf's 256, three steps
        # never fill a window); both runs through the CLI's main in this
        # process, warm (the conf and pooled legs time the cold CLI)
        out['window'] = {}
        for leg, extra in (('k1', ()), ('k4', ('steps_per_dispatch=4',
                                               'scan_strict=1'))):
            run = _cli_train_run(
                f'cli_imgbin[{leg}]', 'ImageNet.conf', work, env, failures,
                ('batch_size=64', f'model_dir=models_{leg}', *extra),
                here=True)
            files = {}
            for name in ('0000.model', '0001.model'):
                path = os.path.join(work, f'models_{leg}', name)
                files[name] = open(path, 'rb').read() \
                    if os.path.exists(path) else None
            out['window'][leg] = (run, files)
        (r1, f1), (r4, f4) = out['window']['k1'], out['window']['k4']
        equal = {name: f1[name] is not None and f1[name] == f4[name]
                 for name in f1}
        if not all(equal.values()):
            failures.append(f'cli_imgbin[window]: model files at K=4 vs '
                            f'K=1 equal: {equal}')
        if r1.get('eval_lines') != r4.get('eval_lines'):
            failures.append(f'cli_imgbin[window]: eval lines {r4.get("eval_lines")}'
                            f' vs K=1 {r1.get("eval_lines")}')
        out['window'] = {'batch_size': 64, 'k1': r1, 'k4': r4,
                         'model_files_equal': equal}

        # ---- task=pred over the test set --------------------------------
        with open(os.path.join(work, 'pred.conf'), 'w') as f:
            f.write(conf_text + '\npred = pred.txt\niter = imgbin\n'
                    '  image_list = "../../NameList.test"\n'
                    '  image_bin = "../../TEST.BIN"\n'
                    '  image_mean = "models/image_net_mean.bin"\n'
                    'iter = end\n')
        cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', 'pred.conf',
               'task=pred', 'model_in=models/0001.model']
        rc, _, err, wall = _stamped_run(cmd, work, env, 600)
        n_pred = None
        if os.path.exists(os.path.join(work, 'pred.txt')):
            with open(os.path.join(work, 'pred.txt')) as f:
                n_pred = sum(1 for ln in f if ln.strip())
        out['pred'] = {'cmd': ' '.join(cmd[1:]), 'rc': rc, 'seconds': wall,
                       'lines': n_pred}
        if rc != 0 or n_pred != IMGBIN['test']:
            failures.append(f'cli_imgbin[pred]: exit {rc}, {n_pred} lines, '
                            f'want {IMGBIN["test"]}: '
                            + '\n'.join(ln for _, ln in err[-20:]))
        else:
            t0 = time.perf_counter()
            out['tasks'] = cli_tasks(work, env, conf_text, failures)
            out['tasks']['elapsed_s'] = time.perf_counter() - t0
            torch.cuda.empty_cache()

        # ---- the chain in process into the bf16 phase's net -------------
        old_cwd = os.getcwd()
        os.chdir(work)
        try:
            conf = 'ImageNet.conf'
            rates = {}
            rates['serial'], batches = _host_chain_rate(
                conf, [('device_normalize', '1')])
            rates['nworker_8'], _ = _host_chain_rate(
                conf, [('device_normalize', '1'), ('nworker', '8')])
        finally:
            os.chdir(old_cwd)
        out['host_chain_images_per_s'] = rates
        if not (len(batches) == IMGBIN_STEPS and all(
                b.data.dtype == np.uint8 and b.norm_spec is not None
                and b.data.shape == (BATCH, 3, 227, 227) for b in batches)):
            failures.append('cli_imgbin[in_process]: the chain gave '
                            f'{[(b.data.dtype, b.data.shape) for b in batches]}'
                            ', want 3 uint8 batches with a NormSpec')
        out['batch_h2d_bytes'] = {'uint8': int(batches[0].data.nbytes),
                                  'as_f32': int(batches[0].data.nbytes * 4)}
        make = _net_maker(_example_conf('ImageNet.conf',
                                        'ImageNet_train.conf'),
                          ('batch_size', str(BATCH)))
        want = as16(STEP_LAUNCHES['auto'])
        net = make(*BF16)
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        steps = _train_steps(net, [(b,) for b in batches], IMGBIN_STEPS,
                             want, 'cli_imgbin[in_process]', failures)
        launches = launch_counts()
        # ------------------------------------------------------------------
        # the chain and the steps together, steady state (second pass)
        os.chdir(work)
        try:
            e2e = {key: _chain_train_rate(net, 'ImageNet.conf', ext)
                   for key, ext in (
                       ('serial', [('device_normalize', '1')]),
                       ('nworker_8', [('device_normalize', '1'),
                                      ('nworker', '8')]))}
        finally:
            os.chdir(old_cwd)
        del net, batches
        torch.cuda.empty_cache()
        out['in_process'] = {
            'conf': 'cxxnet_tpu_torch/example/ImageNet.conf + '
                    'ImageNet_train.conf', 'dtype': 'bfloat16',
            'chain': "example/ImageNet/ImageNet.conf's data = train + "
                     'device_normalize = 1',
            'steps': IMGBIN_STEPS, 'step_ms': steps['step_ms'],
            'chain_and_steps_images_per_s': e2e,
            'loss': steps['loss'], 'launches': launches,
            'launches_per_step': steps['per_step'][-1],
            'launches_per_step_want': want}
        if bf16 and 'alexnet' in bf16:
            out['synthetic_bf16_alexnet_images_per_s'] = \
                bf16['alexnet']['images_per_s']
        out['cli_launches'] = ('not reported: the counters live in the '
                               "CLI's own process")

    # ---- the fixture digest on this host ---------------------------------
    with open(os.path.join(ROOT, 'tests', 'fixtures',
                           'torch_imgbin_digest.json')) as f:
        pinned = json.load(f)['sha256']
    with tempfile.TemporaryDirectory() as d:
        got = imgbin_fixture_digest(create_iterator, BinaryPage, d)
    out['fixture_digest'] = {'got': got, 'pinned': pinned}
    if got != pinned:
        failures.append(f'cli_imgbin: fixture digest {got}, pinned {pinned}')
    return out


# --- the Inception nets -------------------------------------------------------

# (conf, batch, key): the confs' own batch sizes, f32, 224 x 224
INCEPTION_NETS = (('GoogLeNet.conf', 128, 'googlenet'),
                  ('Inception-BN.conf', 256, 'inception_bn'))
INCEPTION_STEPS, INCEPTION_PALLAS_STEPS = 10, 3
_NO_LAUNCH = dict.fromkeys(STEP_LAUNCHES['auto'], 0)
# kernel launches of one train step and one eval forward of each net, as
# the gates route it (the JAX package's on one chip).  GoogLeNet: its 59
# convs are 27 sibling 1x1s (nine groups of three, each group one plain
# conv, no kernel, as in JAX) and 32 conv+relu pairs for the conv kernel;
# norm2 (c 192) takes the LRN forward ('hybrid'), norm1 (c 64) the
# composition; at eval the three 1000-way fullc layers (m 128, k 1024)
# take the forward GEMM; use_pallas=1 forces both LRNs 'full' and all
# five fullc layers onto the GEMM kernels.  Inception-BN: every conv
# feeds a batch_norm, so none pairs under auto; at eval fc1 (m 256, k
# 1024) takes the forward GEMM; fuse=1 sends each of the 41 convs outside
# its ten sibling groups (28 convs) through the kernel as a solo identity
# conv (cxxnet_tpu/nnet/net.py:554 leaves grouped convs out).  A train
# step draws each dropout layer's mask through the threefry kernel:
# GoogLeNet's three, Inception-BN has none
INCEPTION_LAUNCHES = {
    'googlenet': {
        'auto': {**_NO_LAUNCH, 'conv_bias_act': 32, 'lrn_forward': 1,
                 RANDOM_KERNEL: 3},
        'eval': {**_NO_LAUNCH, 'conv_bias_act': 32, 'lrn_forward': 1,
                 'fullc_gemm': 3},
        'use_pallas_1': {**_NO_LAUNCH, 'conv_bias_act': 32,
                         'lrn_forward': 2, 'lrn_backward': 2,
                         'fullc_gemm': 5, 'fullc_gemm_nt': 5,
                         'fullc_gemm_tn': 5, RANDOM_KERNEL: 3}},
    'inception_bn': {
        'auto': _NO_LAUNCH,
        'eval': {**_NO_LAUNCH, 'fullc_gemm': 1},
        'fuse_1': {**_NO_LAUNCH, 'conv_bias_act': 41}},
}
# the second leg of each net (its net params and steps), and the net
# params of the step held against the stock composition: Inception-BN's
# auto step runs no kernel, so its fuse=1 step is the one compared
INCEPTION_LEGS = {'googlenet': ('use_pallas_1', (('use_pallas', '1'),),
                                INCEPTION_PALLAS_STEPS, ()),
                  'inception_bn': ('fuse_1', (('fuse', '1'),), 1,
                                   (('fuse', '1'),))}


def _graph(conf_name, *pairs):
    """The port's graph of an example conf (layers and node shapes; no
    weights, no device)."""
    from cxxnet_tpu_torch.nnet.net import Net as Graph
    from cxxnet_tpu_torch.nnet.net_config import NetConfig
    from cxxnet_tpu_torch.utils.config import parse_config_string
    cfg = NetConfig()
    cfg.configure(list(parse_config_string(_example_conf(conf_name)))
                  + list(pairs))
    return Graph(cfg)


def inception_shapes():
    """The distinct shapes the Inception nets' paths give kernel rows
    1-7, read off the port's own graphs: GoogLeNet's 32 conv+relu pairs,
    Inception-BN's 41 solo identity convs under fuse=1, GoogLeNet's two
    LRNs, the forward GEMM at the eval gate's fullc layers of both nets
    and at every GoogLeNet fullc (use_pallas=1), and GoogLeNet's fullc
    layers for the backward GEMMs.  Each entry is ``(net, name, ...)``
    in ``kernel_checks``' order; a shape several layers share is named
    after the first, and ``layers`` maps each name to how many layers of
    one pass run at that shape."""
    from cxxnet_tpu_torch.layers.common import FullConnectLayer
    from cxxnet_tpu_torch.layers.norm import LRNLayer
    from cxxnet_tpu_torch.ops.kernels import fullc_pallas_shape_class
    out = {'conv': {}, 'lrn': {}, 'gemm': {}, 'fc': {}}

    def add(kind, key, net, name, *shape):
        if key in out[kind]:
            out[kind][key][1].append(name)
        else:
            out[kind][key] = (net, [name], *shape)

    for conf_name, batch, net in INCEPTION_NETS:
        g = _graph(conf_name, ('fuse', '1' if net == 'inception_bn'
                               else 'auto'))
        convs = [(i, 'relu') for i in sorted(g._convact_pairs)] \
            + [(i, 'identity') for i in sorted(g._convact_solo)]
        for i, act in convs:
            p, info = g.layers[i].param, g.cfg.layers[i]
            spec = g.node_specs[info.nindex_in[0]]
            shape = ((batch, spec.y, spec.x, spec.c), p.kernel_height,
                     p.kernel_width, spec.c // p.num_group, p.num_channel,
                     p.stride, p.pad_y, p.num_group, act)
            add('conv', (net, shape), net, info.name, *shape)
        norms = 0
        for i, layer in enumerate(g.layers):
            info = g.cfg.layers[i]
            spec = g.node_specs[info.nindex_in[0]] if info.nindex_in \
                else None
            if isinstance(layer, LRNLayer):
                norms += 1
                xs = (batch, spec.y, spec.x, spec.c)
                add('lrn', (net, xs), net, f'norm{norms}', xs)
            if isinstance(layer, FullConnectLayer):
                m, k, n = batch, spec.flat_size, layer.param.num_hidden
                if net == 'googlenet' or fullc_pallas_shape_class(m, k, n):
                    add('gemm', (m, k, n), net, info.name, m, k, n)
                if net == 'googlenet':
                    add('fc', (m, k, n), net, info.name, m, k, n)
    shapes = {kind: [(net, f'{net} {names[0]}', *shape)
                     for net, names, *shape in entries.values()]
              for kind, entries in out.items()}
    shapes['layers'] = {f'{net} {names[0]}': len(names)
                        for entries in out.values()
                        for net, names, *_ in entries.values()}
    return shapes


def _train_and_eval(net, batches, steps, want, want_eval, tag, failures,
                    profile=True):
    """``steps`` updates of ``net`` (the main path: counts from 0, driven,
    read just after), its train metrics and peak memory, a profile of two
    steps (unless not ``profile``) and one eval forward, whose launches and
    scores are checked.  The caller resets the peak memory before building
    ``net``."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    batch = len(batches[0][0])
    reset_launch_counts()
    auto = _train_steps(net, batches, steps, want, f'{tag}[auto]', failures)
    launches_auto = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    train_line = net.trainer.evaluate(None, 'train')
    breakdown = profile_steps(
        lambda i: net.update(*batches[i % len(batches)])) if profile \
        else None
    # ---- one eval forward, counts from 0 --------------------------------
    reset_launch_counts()
    t0 = time.perf_counter()
    scores = net.predict_scores(batches[0][0])
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches_eval = launch_counts()
    # --------------------------------------------------------------------
    if launches_eval != want_eval:
        failures.append(f'{tag}[eval]: launched {launches_eval}, want '
                        f'{want_eval}')
    row_sums = scores.sum(axis=1)
    if scores.shape != (batch, 1000) or not np.isfinite(scores).all() \
            or not np.allclose(row_sums, 1.0, atol=1e-4):
        failures.append(f'{tag}[eval]: scores {scores.shape}, finite '
                        f'{np.isfinite(scores).all()}, row sums '
                        f'{row_sums.min()}..{row_sums.max()}')
    p50 = float(np.median(auto['step_ms']))
    # MFU (obs/programs.py): the ledger's products a step (counted from
    # the shapes at the step's first call) over the p50, against the
    # card's dense bf16 peak from the table
    from cxxnet_tpu_torch.obs import programs
    flops = net.trainer.train_step_flops()
    return {'steps': steps, 'step_ms': auto['step_ms'], 'step_ms_p50': p50,
            'step_ms_spread': [min(auto['step_ms']), max(auto['step_ms'])],
            'flops_per_step': flops,
            'mfu': programs.mfu(flops, 1e3 / p50, 0),
            'images_per_s': batch / p50 * 1e3, 'loss': auto['loss'],
            'losses_finite': bool(np.isfinite(auto['loss']).all()),
            'train_metrics': train_line.strip(),
            'max_memory_allocated': peak_bytes, 'launches': launches_auto,
            'launches_per_step': auto['per_step'][-1],
            'launches_per_step_want': want, 'profile': breakdown,
            'eval': {'ms': eval_ms, 'launches': launches_eval}}


def _inception_net(conf_name, batch, key, failures):
    """One Inception net at full width: the ``auto`` train steps (the main
    path), a profile of two steps, one eval forward, the second leg
    (``INCEPTION_LEGS``) and one step against the stock composition."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    want = INCEPTION_LAUNCHES[key]
    batches = _synthetic_batches(batch, 224)
    make = _net_maker(_example_conf(conf_name), ('batch_size', str(batch)))
    torch.cuda.reset_peak_memory_stats()
    net = make()
    auto = _train_and_eval(net, batches, INCEPTION_STEPS, want['auto'],
                           want['eval'], key, failures)
    del net
    torch.cuda.empty_cache()

    # ---- the second leg, counts from 0 ----------------------------------
    leg, pairs, n, stock_pairs = INCEPTION_LEGS[key]
    net = make(*pairs)
    reset_launch_counts()
    second = _train_steps(net, batches, n, want[leg], f'{key}[{leg}]',
                          failures)
    launches_second = launch_counts()
    # --------------------------------------------------------------------
    del net
    torch.cuda.empty_cache()

    # ---- one step of the kernels against the stock composition ----------
    stock = stock_comparison(make, batches[0], failures, stock_pairs, key)
    torch.cuda.empty_cache()
    return {'conf': f'cxxnet_tpu_torch/example/{conf_name}', 'batch': batch,
            'input': [3, 224, 224], 'dtype': 'float32', **auto,
            leg: {'steps': n, 'step_ms': second['step_ms'],
                  'loss': second['loss'], 'launches': launches_second,
                  'launches_per_step': second['per_step'][-1],
                  'launches_per_step_want': want[leg]},
            'stock': stock}


def inception_phase(failures):
    """Full-width GoogLeNet and Inception-BN training through
    ``Net.update`` on seeded synthetic images (``_inception_net``)."""
    out = {'phase': 'inception'}
    for conf_name, batch, key in INCEPTION_NETS:
        out[key] = _inception_net(conf_name, batch, key, failures)
        torch.cuda.empty_cache()
    return out


# --- mixed precision: compute_type=bfloat16 and float16 ----------------------

BF16 = (('compute_type', 'bfloat16'),)
F16 = (('compute_type', 'float16'),)
#: each 16-bit dtype's net param and short name
HALF = {torch.bfloat16: (BF16, 'bf16'), torch.float16: (F16, 'f16')}
BF16_INCEPTION_STEPS = 5
# the 16-bit legs' rule (the LM's bf16 step's in
# tests/test_torch_lm_train.py): in bf16 the kernel leg lies no further
# from the stock bf16 leg (use_pallas=0 fuse=0, same seed, replayed
# decisions) than 1.5x that stock leg lies from the stock f32 leg, plus
# 2^-8 of the f32 leg's largest value; by weight (the one-step change) or
# over the scores.  In f16, as tests/test_torch_float16.py holds the port
# to JAX, the kernel leg lies no further from the stock f32 leg than 1.5x
# the stock f16 leg does, plus the same floor: f16's rounding noise is
# small enough that a batch_norm net's one-step change (Inception-BN)
# moves about as far from f32 in either f16 composition, in different
# directions, so the two f16 legs lie further apart than either lies from
# f32 (the distance between them is reported beside it)
BF16_RULE, BF16_RULE_FLOOR = 1.5, 2.0 ** -8
#: f16's largest finite value: there is no loss scaling (nor in JAX), so
#: the f16 legs report how close their activations come to it
F16_MAX = 65504.0


def _bf16_rule(tag, kernel, stock16, stock32, failures, name16='bf16'):
    """The three distances of each entry (relative to the stock f32 leg's
    largest value) and the rule on them (``BF16_RULE``: the kernel leg's
    distance from the stock bf16 leg in bf16, from the stock f32 leg in
    f16); ``name16`` names the 16-bit dtype in the keys."""
    from_f32 = name16 == 'f16'
    dist, worst = {}, 0.0
    for key in stock32:
        k, s16, s32 = (torch.as_tensor(d[key]).float()
                       for d in (kernel, stock16, stock32))
        scale = s32.abs().max().item() or 1e-30
        d_ks = (k - s16).abs().max().item() / scale
        d_s = (s16 - s32).abs().max().item() / scale
        d_k32 = (k - s32).abs().max().item() / scale
        name = '/'.join(key) if isinstance(key, tuple) else key
        dist[name] = {f'kernel_vs_stock_{name16}': d_ks,
                      f'stock_{name16}_vs_stock_f32': d_s,
                      'kernel_vs_stock_f32': d_k32}
        worst = max(worst, (d_k32 if from_f32 else d_ks)
                    / (BF16_RULE * d_s + BF16_RULE_FLOOR))
    held = 'kernel_vs_stock_f32' if from_f32 else f'kernel_vs_stock_{name16}'
    if not worst <= 1.0:
        failures.append(f'{tag}: the kernel leg lies {worst} x the rule\'s '
                        f'bound from the stock '
                        f'{"f32" if from_f32 else name16} leg')
    return {'rule': f'{held} <= {BF16_RULE} stock_{name16}_vs_stock_f32 + '
                    f'{BF16_RULE_FLOOR}',
            'worst_over_bound': worst, 'distances': dist}


def _f16_range(net, batches, make):
    """How close an f16 net comes to f16's limits, which JAX's f16 path
    meets alike (no loss scaling in either): the largest |value| of any
    16-bit node over one forward of ``batches[0]`` against 65504, with
    the nodes past half of it; and, over one step's weight gradients
    (``update_period = 2``: the first step accumulates and does not
    update), the share of elements that are zero in the f16 leg but not
    in the stock f32 leg.  The f32 leg replays the f16 leg's relu and
    max-pooling choices (``layers.Decisions``) and takes its dropout masks
    from the f16 draw, so that a zero there is f16's (an underflow), not
    another choice or mask."""
    from cxxnet_tpu_torch.layers import Decisions
    from cxxnet_tpu_torch.ops import threefry
    values = net.trainer.forward_values(net.trainer.params, batches[0][0])
    act = {i: v.abs().max().item() for i, v in enumerate(values)
           if v is not None and v.dtype == torch.float16}
    top = max(act.values())
    del values
    draw = threefry.keep_mask

    def f16_mask(key, shape, dtype, device, pkeep):
        return draw(key, shape, torch.float16, device, pkeep).to(dtype)
    grads = {}
    decisions = Decisions()
    for leg, pairs in (('f16', F16), ('f32', (('use_pallas', '0'),
                                              ('fuse', '0')))):
        gnet = make(*pairs, ('update_period', '2'))
        gnet.trainer.decisions = decisions
        threefry.keep_mask = draw if leg == 'f16' else f16_mask
        try:
            gnet.update(*batches[0])
        finally:
            threefry.keep_mask = draw
        grads[leg] = {(k, f): g.detach().clone()
                      for k, fs in gnet.trainer.grad_acc.items()
                      for f, g in fs.items()}
        decisions.replay = True
        del gnet
        torch.cuda.empty_cache()
    flushed_all = nz32 = total = 0
    by_weight = {}
    for key, g32 in grads['f32'].items():
        flushed = ((grads['f16'][key] == 0) & (g32 != 0)).sum().item()
        by_weight['/'.join(key)] = flushed / g32.numel()
        flushed_all += flushed
        nz32 += (g32 != 0).sum().item()
        total += g32.numel()
    return {'max_abs_activation': top, 'f16_max': F16_MAX,
            'max_abs_activation_over_f16_max': top / F16_MAX,
            'nodes_past_half_f16_max': sorted(
                i for i, v in act.items() if v > F16_MAX / 2),
            'grad_zero_in_f16_not_f32_share': flushed_all / total,
            'grad_zero_in_f16_not_f32_of_nonzero':
                flushed_all / max(nz32, 1),
            'grad_elements': total,
            'grad_zero_in_f16_not_f32_share_by_weight': by_weight}


def bf16_stock_comparison(make, batch, failures, kernel, tag,
                          dtype=torch.bfloat16):
    """One SGD step of the 16-bit kernel leg (``auto``, or the net params
    ``kernel``) against the stock composition in that dtype and in f32
    from the same seed, batch and dropout masks, both replaying the
    kernel leg's relu and max-pooling choices with cuDNN off (as
    :func:`stock_comparison`): the rule on each weight's one-step
    change."""
    from cxxnet_tpu_torch.layers import Decisions
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    pairs16, name16 = HALF[dtype]
    decisions = Decisions()
    net = make(*pairs16, *kernel)
    net.trainer.decisions = decisions
    w0 = _weights(net)
    dw_kernel, kernel_loss = _step_change(net, batch)
    del net
    decisions.replay = True
    legs = {}
    with torch.backends.cudnn.flags(enabled=False):
        for leg, pairs in ((f'stock_{name16}', pairs16), ('stock_f32', ())):
            net = make(*pairs, ('use_pallas', '0'), ('fuse', '0'))
            if any(not torch.equal(w, w0[key])
                   for key, w in _weights(net).items()):
                failures.append(f'{tag}[{leg}]: initial weights differ '
                                'from the kernel leg')
            net.trainer.decisions = decisions
            reset_launch_counts()
            legs[leg] = _step_change(net, batch)
            if any(v for k, v in launch_counts().items()
                   if k != RANDOM_KERNEL):
                failures.append(f'{tag}[{leg}]: the stock leg launched port '
                                'kernels')
            del net
            torch.cuda.empty_cache()
    losses = {'kernel': kernel_loss, **{k: v[1] for k, v in legs.items()}}
    if not all(np.isfinite(v) for v in losses.values()):
        failures.append(f'{tag}[stock]: losses {losses}')
    return {'kernel_leg': dict(kernel) or 'auto', 'loss': losses,
            **_bf16_rule(f'{tag}[stock]', dw_kernel,
                         legs[f'stock_{name16}'][0], legs['stock_f32'][0],
                         failures, name16)}


def _bf16_net(conf, batch, hw, key, steps, want, want_eval, kernel,
              failures, dtype=torch.bfloat16, profile=True):
    """One net in a 16-bit dtype at full width: ``steps`` updates under
    ``auto`` (the main path), a profile of two steps (unless not
    ``profile``), one eval forward, and the one-step comparison with the
    stock composition in that dtype and f32; in f16 also the range
    (:func:`_f16_range`)."""
    pairs16, name16 = HALF[dtype]
    tag = f'{name16}_{key}'
    batches = _synthetic_batches(batch, hw)
    make = _net_maker(conf, ('batch_size', str(batch)))
    torch.cuda.reset_peak_memory_stats()
    net = make(*pairs16)
    auto = _train_and_eval(net, batches, steps, want, want_eval, tag,
                           failures, profile)
    rng = _f16_range(net, batches, make) if dtype == torch.float16 else None
    del net
    torch.cuda.empty_cache()
    out = {'batch': batch, 'input': [3, hw, hw],
           'dtype': str(dtype).split('.')[-1], **auto,
           'stock': bf16_stock_comparison(make, batches[0], failures, kernel,
                                          tag, dtype)}
    if rng is not None:
        out['f16_range'] = rng
    return out


def _bf16_serve(f32_serve, failures, dtype=torch.bfloat16):
    """``PredictEngine`` + ``DynamicBatcher`` at a 16-bit compute type over
    the serve phase's requests.  Launches: each bucket forward (the
    warm-up's one per bucket, then the batcher's, read off its
    ``batches[bN]`` counters) launches what one forward at that bucket
    launches alone; with the f32 serve's batches (``f32_serve``, when
    given) the counts equal its counts under the 16-bit builds' names.
    Scores of the 256-image request held to the rule against the stock
    composition in that dtype and f32."""
    import re
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    pairs16, name16 = HALF[dtype]
    tag = f'{name16}_serve'
    conf = _example_conf('ImageNet.conf')

    def make(*pairs):
        net = Net(dev='cuda', cfg=conf)
        for k, v in (('seed', str(SEED)),) + pairs:
            net.set_param(k, v)
        net.init_model()
        return net

    net = make(*pairs16)
    requests = _serve_requests()
    drive = _serve_drive(net, requests)
    launches = drive['launches']
    engine = net.engine
    failures.extend(f'{tag}: {e}' for e in drive['errors'])
    answered = _answered(tag, requests, drive['results'], failures)
    big = requests[3]
    img_s = _b256_images_per_s(engine, big)
    # one forward at each bucket alone (outside the main-path window)
    per_bucket = {}
    for b in engine.buckets:
        reset_launch_counts()
        engine.predict_scores(np.zeros((b, *big.shape[1:]), np.float32))
        per_bucket[b] = launch_counts()

    def batches(stats):
        return {int(b): int(n) for b, n in
                re.findall(r'batches\[b(\d+)\]:(\d+)', stats)}
    hist = batches(drive['stats'])
    want = dict.fromkeys(launches, 0)
    for b, pf in per_bucket.items():
        for k, v in pf.items():
            want[k] += (1 + hist.get(b, 0)) * v
    if launches != want:
        failures.append(f'{tag}: launched {launches}, want {want} from the '
                        'bucket forwards')
    same = None
    if f32_serve is not None:
        same = hist == batches(f32_serve['stats'])
        if same and launches != as16(f32_serve['launches'], dtype):
            failures.append(f'{tag}: the f32 serve\'s batches but not its '
                            f'launches under the {name16} names')
    if any(cnt and name not in BUILDS16[dtype].values()
           for name, cnt in launches.items()):
        failures.append(f'{tag}: another build launched: {launches}')
    reset_launch_counts()
    served = engine.predict_scores(big)
    per_forward = launch_counts()
    net.serve_stop()
    del net
    legs = {}
    for leg, pairs in ((f'stock_{name16}', pairs16), ('stock_f32', ())):
        ref_net = make(*pairs, ('use_pallas', '0'), ('fuse', '0'))
        legs[leg] = ref_net.predict_scores(big)
        del ref_net
    return {'requests': len(requests), 'answered': answered,
            **{k: drive[k] for k in ('warm_s', 'drive_s', 'loop', 'p50_ms',
                                     'p75_ms', 'p99_ms', 'compile_count')},
            'images_per_s_b256': img_s, 'launches': launches,
            'launches_from_bucket_forwards': want,
            f'f32_serve_launches_as_{name16}':
                as16(f32_serve['launches'], dtype) if f32_serve else None,
            'same_batches_as_f32_serve': same, 'batches': hist,
            'launches_per_forward_b256': per_forward,
            **_bf16_rule(f'{tag}[stock]', {'scores': served},
                         {'scores': legs[f'stock_{name16}']},
                         {'scores': legs['stock_f32']}, failures, name16),
            'stats': drive['stats']}


BF16_PALLAS_STEPS = 3


def _bf16_alexnet_pallas(failures, dtype=torch.bfloat16, steps=None,
                         profile=True):
    """AlexNet as the reference conf is written (dropout on), at the 16-bit
    ``dtype`` (the conf's ``bfloat16``, or ``float16``) and
    ``use_pallas=1``, so every CNN kernel row runs its build for that
    dtype: ``steps`` (``BF16_PALLAS_STEPS``) updates with exact launches
    per step (the main path: counts from 0, driven, read just after), a
    profile of two steps (idle share; unless not ``profile``), peak
    memory, and the step against the stock compositions in that dtype and
    f32 by the rule."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    pairs16, name16 = HALF[dtype]
    steps = steps or BF16_PALLAS_STEPS
    tag = f'{name16}_alexnet_use_pallas_1'
    batches = _synthetic_batches(BATCH, 227)
    make = _net_maker(_example_conf('ImageNet.conf', 'ImageNet_train.conf'),
                      ('batch_size', str(BATCH)))
    pairs = (('use_pallas', '1'),)
    want = as16(STEP_LAUNCHES['on'], dtype)
    torch.cuda.reset_peak_memory_stats()
    net = make(*pairs16, *pairs)
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    run = _train_steps(net, batches, steps, want, tag, failures)
    launches = launch_counts()
    # --------------------------------------------------------------------
    peak_bytes = torch.cuda.max_memory_allocated()
    breakdown = profile_steps(
        lambda i: net.update(*batches[i % len(batches)])) if profile \
        else None
    del net
    torch.cuda.empty_cache()
    p50 = float(np.median(run['step_ms']))
    return {'conf': 'ImageNet.conf + ImageNet_train.conf', 'batch': BATCH,
            'input': [3, 227, 227], 'dtype': str(dtype).split('.')[-1],
            'net_params': dict(pairs), 'steps': steps,
            'step_ms': run['step_ms'], 'step_ms_p50': p50,
            'images_per_s': BATCH / p50 * 1e3, 'loss': run['loss'],
            'losses_finite': bool(np.isfinite(run['loss']).all()),
            'max_memory_allocated': peak_bytes, 'launches': launches,
            'launches_per_step': run['per_step'][-1],
            'launches_per_step_want': want, 'profile': breakdown,
            'stock': bf16_stock_comparison(make, batches[0], failures, pairs,
                                           tag, dtype)}


#: (AlexNet auto steps, use_pallas=1 steps, Inception steps, profiles) of
#: the bf16 and f16 phases: the f16 phase checks the same paths in fewer
#: steps (its budget is a minute and a half)
HALF_PHASE = {torch.bfloat16: (TRAIN_STEPS, BF16_PALLAS_STEPS,
                               BF16_INCEPTION_STEPS, True),
              torch.float16: (4, 3, 3, False)}


def _half_phase(f32_serve, failures, dtype):
    """AlexNet, GoogLeNet and Inception-BN trained and AlexNet served at
    the 16-bit compute ``dtype``: the f32 phases' launch counts under the
    names of the builds for that dtype; AlexNet also under
    ``use_pallas=1`` (:func:`_bf16_alexnet_pallas`)."""
    pairs16, name16 = HALF[dtype]
    steps, pallas_steps, inception_steps, profile = HALF_PHASE[dtype]
    out = {'phase': name16}
    alexnet_eval = {**_NO_LAUNCH, 'conv_bias_act': 5, 'lrn_forward': 2,
                    'fullc_gemm': 1}
    t0 = time.perf_counter()
    out['alexnet'] = _bf16_net(
        _example_conf('ImageNet.conf', 'ImageNet_train.conf'), BATCH, 227,
        'alexnet', steps, as16(STEP_LAUNCHES['auto'], dtype),
        as16(alexnet_eval, dtype), (), failures, dtype, profile)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out['alexnet_use_pallas_1'] = _bf16_alexnet_pallas(
        failures, dtype, pallas_steps, profile)
    torch.cuda.empty_cache()
    out['elapsed_by_leg_s'] = {'alexnet': t1 - t0,
                               'alexnet_use_pallas_1':
                                   time.perf_counter() - t1}
    for conf_name, batch, key in INCEPTION_NETS:
        want = INCEPTION_LAUNCHES[key]
        t0 = time.perf_counter()
        out[key] = _bf16_net(_example_conf(conf_name), batch, 224, key,
                             inception_steps, as16(want['auto'], dtype),
                             as16(want['eval'], dtype),
                             INCEPTION_LEGS[key][3], failures, dtype,
                             profile)
        torch.cuda.empty_cache()
        out['elapsed_by_leg_s'][key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['serve'] = _bf16_serve(f32_serve, failures, dtype)
    out['elapsed_by_leg_s']['serve'] = time.perf_counter() - t0
    return out


def bf16_phase(f32_serve, failures):
    """The 16-bit phase at ``compute_type=bfloat16``, as the reference's
    confs set it (:func:`_half_phase`)."""
    return _half_phase(f32_serve, failures, torch.bfloat16)


def f16_phase(f32_serve, failures):
    """The 16-bit phase at ``compute_type=float16`` in place of the confs'
    ``bfloat16`` (:func:`_half_phase`), each net leg with its f16 range
    (:func:`_f16_range`); ``f32_serve`` may be None (then the serve leg
    does not compare its batches with the f32 serve's)."""
    return _half_phase(f32_serve, failures, torch.float16)


# --- the trainer extensions: steps_per_dispatch, serve.fold_bn, blockdiag ----

# the K-step window (steps_per_dispatch, nnet/execution.py) on AlexNet as
# the reference conf is written (bf16, use_pallas=1, dropout 0.5): 8 steps
# as two windows of 4 against 8 single steps from the same seed, at
# update_period 3 (no window aligns with an update)
WINDOW_K, WINDOW_STEPS, WINDOW_PERIOD = 4, 8, 3
WINDOW_PAIRS = BF16 + (('use_pallas', '1'),)
# the timed blocks: K=1, K=4, K=4, K=1 on one net, this many steps each
WINDOW_TIMED_STEPS = 8


def _window_batches():
    from cxxnet_tpu_torch.io.data import DataBatch
    return [DataBatch(x, y[:, None])
            for x, y in _synthetic_batches(BATCH, 227)]


def _window_drive(tr, batches, k, n):
    """``n`` updates of trainer ``tr`` through ``ExecutionPlan.
    round_stepper`` at K=``k`` under ``scan_strict``, as ``main._round``
    drives a round (``feed`` each batch, ``finish`` the tail); batch i is
    ``batches[i % len(batches)]``.  Returns every step's device loss, in
    order (recorded where each step returns it)."""
    from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
    losses = []
    step = tr._step

    def recording(*args):
        out = step(*args)
        losses.append(out[0])
        return out
    tr._step = recording
    try:
        stepper = ExecutionPlan.resolve(k, strict=True,
                                        silent=True).round_stepper(tr)
        for i in range(n):
            stepper.feed(batches[i % len(batches)])
        stepper.finish()
    finally:
        del tr._step
    return losses


def _state(tr):
    """Parameters and SGD momentum of ``tr``, cloned."""
    return ({(k, f): v.detach().clone() for k, d in tr.params.items()
             for f, v in d.items()},
            {(k, f): v.clone() for k, d in tr.opt_state['m'].items()
             for f, v in d.items()})


def _bitwise_diff(tag, a, b, failures):
    """The keys where two ``_state``s, loss lists or metric lines differ
    (a failure names them)."""
    (pa, ma, la, ta), (pb, mb, lb, tb) = a, b
    bad = [f'param {k}' for k in pa if not torch.equal(pa[k], pb[k])]
    bad += [f'momentum {k}' for k in ma if not torch.equal(ma[k], mb[k])]
    if not torch.equal(torch.stack(la), torch.stack(lb)):
        bad.append('losses')
    if ta != tb:
        bad.append('train metrics')
    if bad:
        failures.append(f'{tag}: not bitwise: {bad[:8]}')
    return bad


def _deterministic_warnings(make, batch, pairs):
    """The ops that warn in one step under ``torch.use_deterministic_
    algorithms(True, warn_only=True)``: each warning's first line, once."""
    import warnings
    net = make(*pairs)
    seen = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            net.update(batch.data, batch.label)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for w in caught:
        line = str(w.message).splitlines()[0][:200]
        if line not in seen:
            seen.append(line)
    del net
    return seen


def window_phase(failures):
    """The K-step window on AlexNet as the reference conf is written: two
    eager 8-step runs from one seed (the card's own determinism first),
    then two K=4 windows against them, bitwise (params, momentum, losses,
    train metrics) at ``update_period`` 3, each window launching K x a
    step's kernels; the ops that warn under deterministic algorithms;
    then, on one net at the conf's own cadence, step ms at K=1 and K=4 in
    turns and a profile of each (idle share)."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    tag = 'window'
    batches = _window_batches()
    make = _net_maker(_example_conf('ImageNet.conf', 'ImageNet_train.conf'),
                      ('batch_size', str(BATCH)))
    per_step = as16(STEP_LAUNCHES['on'])
    want = {k: WINDOW_STEPS * v for k, v in per_step.items()}
    pairs = WINDOW_PAIRS + (('update_period', str(WINDOW_PERIOD)),)
    runs, counts = {}, {}
    for name, k in (('per_step_a', 1), ('per_step_b', 1),
                    ('window', WINDOW_K)):
        net = make(*pairs)
        tr = net.trainer
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        losses = _window_drive(tr, batches, k, WINDOW_STEPS)
        counts[name] = launch_counts()
        # ------------------------------------------------------------------
        runs[name] = (*_state(tr), losses, tr.evaluate(None, 'train'))
        if (tr.sample_counter, tr.epoch_counter) != \
                (WINDOW_STEPS, WINDOW_STEPS // WINDOW_PERIOD):
            failures.append(f'{tag}[{name}]: counters '
                            f'{(tr.sample_counter, tr.epoch_counter)}')
        del net, tr
        torch.cuda.empty_cache()
    for name, got in counts.items():
        if got != want:
            failures.append(f'{tag}[{name}]: launched {got}, want {want}')
    eager = _bitwise_diff(f'{tag}[eager twice]', runs['per_step_a'],
                          runs['per_step_b'], failures)
    window = _bitwise_diff(f'{tag}[window vs per step]', runs['window'],
                           runs['per_step_a'], failures)
    losses = [float(v) for v in runs['window'][2]]
    if not np.isfinite(losses).all():
        failures.append(f'{tag}: losses {losses}')
    metrics = runs['window'][3].strip()
    del runs
    torch.cuda.empty_cache()
    warned = {'use_pallas_1': _deterministic_warnings(
        make, batches[0], WINDOW_PAIRS),
        'auto': _deterministic_warnings(make, batches[0], BF16)}
    torch.cuda.empty_cache()

    # ---- step ms at K=1 and K=4 in turns, one net, the conf's cadence ---
    net = make(*WINDOW_PAIRS)
    tr = net.trainer
    _window_drive(tr, batches, WINDOW_K, WINDOW_K)      # warm-up
    blocks = []
    for k in (1, WINDOW_K, WINDOW_K, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _window_drive(tr, batches, k, WINDOW_TIMED_STEPS)
        torch.cuda.synchronize()
        blocks.append((k, (time.perf_counter() - t0) * 1e3
                       / WINDOW_TIMED_STEPS))
    profiles = {f'k{k}': profile_steps(
        lambda i, k=k: _window_drive(tr, batches, k, WINDOW_K), steps=2)
        for k in (1, WINDOW_K)}
    del net, tr
    torch.cuda.empty_cache()
    ms = {k: [v for kk, v in blocks if kk == k] for k in (1, WINDOW_K)}
    return {'phase': 'window', 'nvidia_smi': nvidia_smi_line(),
            'conf': 'ImageNet.conf + ImageNet_train.conf', 'batch': BATCH,
            'dtype': 'bfloat16', 'net_params': dict(WINDOW_PAIRS),
            'k': WINDOW_K, 'steps': WINDOW_STEPS,
            'update_period': WINDOW_PERIOD,
            'eager_twice_bitwise': not eager,
            'window_bitwise': not window, 'losses': losses,
            'train_metrics': metrics, 'launches': counts['window'],
            'launches_want': want,
            'launches_per_step_eager': counts['per_step_a'],
            'deterministic_warnings': warned,
            'step_ms_blocks': [{'k': k, 'step_ms': v} for k, v in blocks],
            'step_ms': {f'k{k}': float(np.mean(v)) for k, v in ms.items()},
            'images_per_s': {f'k{k}': BATCH / float(np.mean(v)) * 1e3
                             for k, v in ms.items()},
            # a profile's step is one call of K steps: its device ms and
            # wall ms are a window's (K=4) or K single steps' (K=1)
            'profile_per_window_of_4': profiles}


# conv+BN folding at full width: Inception-BN f32 behind serve_start, the
# conf as written (every conv no_bias = 1, so JAX's rule folds nothing)
# and with conv biases (all 69 conv+BN pairs fold), on a seeded
# calibration batch at the conf's batch
FOLD_BATCH, FOLD_REQUESTS = 256, 5


def _served(net, x, n):
    """Scores of ``x`` through ``serve_scores``, the launches of that one
    request (counts from 0), and images/s over ``n`` more requests."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    reset_launch_counts()
    scores = net.serve_scores(x)
    launches = launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        net.serve_scores(x)
    return scores, launches, len(x) * n / (time.perf_counter() - t0)


def fold_phase(failures):
    """``serve.fold_bn`` on the full-width Inception-BN (f32, batch 256):
    the folded engine's scores against the unfolded engine's on the
    calibration batch within ``FOLD_RTOL`` / ``FOLD_ATOL``, images/s of
    both, the launches of one request (the eval gate's fc1 forward
    GEMM)."""
    from cxxnet_tpu_torch.nnet.fold import (FOLD_ATOL, FOLD_RTOL,
                                            plan_conv_bn_pairs)
    tag = 'fold'
    conf = _example_conf('Inception-BN.conf')
    calib = np.random.default_rng(SEED + 5).standard_normal(
        (FOLD_BATCH, 3, 224, 224), dtype=np.float32)
    want = {**_NO_LAUNCH, 'fullc_gemm': 1}
    out = {'phase': 'fold', 'nvidia_smi': nvidia_smi_line(),
           'conf': 'cxxnet_tpu_torch/example/Inception-BN.conf',
           'batch': FOLD_BATCH, 'dtype': 'float32',
           'tol': {'rtol': FOLD_RTOL, 'atol': FOLD_ATOL}}
    for leg, text in (('as_written', conf),
                      ('conv_biases', conf.replace('  no_bias = 1\n', ''))):
        net = _net_maker(text, ('batch_size', str(FOLD_BATCH)))()
        pairs = plan_conv_bn_pairs(net.trainer.net)
        net.serve_start(buckets=str(FOLD_BATCH))
        plain, plain_launches, plain_rate = _served(net, calib,
                                                    FOLD_REQUESTS)
        net.serve_stop()
        t0 = time.perf_counter()
        net.serve_start(buckets=str(FOLD_BATCH), fold_bn=1,
                        fold_batch=calib)
        build_s = time.perf_counter() - t0
        view = net.engine.fold_view()
        folded, fold_launches, fold_rate = _served(net, calib,
                                                   FOLD_REQUESTS)
        net.serve_stop()
        err = float(np.abs(folded - plain).max())
        bound_ = FOLD_ATOL + FOLD_RTOL * float(np.abs(plain).max())
        res = {'pairs': len(pairs),
               'folded_pairs': 0 if view is None else len(view['pairs']),
               'proof_max_abs_err': None if view is None
               else view['max_abs_err'],
               'max_abs_err': err, 'bound': bound_,
               'images_per_s': {'unfolded': plain_rate,
                                'folded': fold_rate},
               'engine_build_s': build_s,
               'launches': {'unfolded': plain_launches,
                            'folded': fold_launches}}
        out[leg] = res
        want_pairs = 0 if leg == 'as_written' else 69
        if res['pairs'] != want_pairs or res['folded_pairs'] != want_pairs:
            failures.append(f'{tag}[{leg}]: {res["pairs"]} pairs, '
                            f'{res["folded_pairs"]} folded, want '
                            f'{want_pairs}')
        if not (np.isfinite(folded).all() and err <= bound_):
            failures.append(f'{tag}[{leg}]: folded scores {err} from the '
                            f'unfolded > {bound_}')
        if leg == 'as_written' and err != 0.0:
            failures.append(f'{tag}[{leg}]: nothing folds, yet the scores '
                            f'moved by {err}')
        for which, got in res['launches'].items():
            if got != want:
                failures.append(f'{tag}[{leg}][{which}]: launched {got}, '
                                f'want {want}')
        del net
        torch.cuda.empty_cache()
    return out


# fuse_blockdiag=auto on the full-width GoogLeNet (f32, batch 128): six
# groups (each module's 5x5 tower and pool projection, <= 96 wide), whose
# twelve members leave the conv kernel (JAX net.py:554) for one plain
# conv a group: 20 conv+relu pairs a step where the unfused net has 32
BLOCKDIAG_BATCH, BLOCKDIAG_GROUPS, BLOCKDIAG_STEPS = 128, 6, 5
BLOCKDIAG_LAUNCHES = {
    **INCEPTION_LAUNCHES['googlenet']['auto'], 'conv_bias_act': 20}


def blockdiag_phase(failures):
    """``fuse_blockdiag=auto`` on GoogLeNet: the group count, step ms and
    launches per step of the fused and the unfused net under ``auto``,
    their first-step losses (the same seed, batch and dropout masks),
    and one step of the two at ``fuse=0`` (every conv a cuDNN conv, every
    relu and max-pool standalone, so the unfused leg's choices replay in
    the fused one and the rewrite is the only difference): per weight,
    the one-step change within ``STOCK_TOL`` of its largest value (f32
    sums in other orders, the fused convs' over a longer zero-padded
    contraction)."""
    from cxxnet_tpu_torch.layers import Decisions
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    tag = 'blockdiag'
    batch = BLOCKDIAG_BATCH
    batches = _synthetic_batches(batch, 224)
    make = _net_maker(_example_conf('GoogLeNet.conf'),
                      ('batch_size', str(batch)))
    out = {'phase': 'blockdiag', 'nvidia_smi': nvidia_smi_line(),
           'conf': 'cxxnet_tpu_torch/example/GoogLeNet.conf',
           'batch': batch, 'dtype': 'float32', 'tol': STOCK_TOL}
    fused_pairs = (('fuse_blockdiag', 'auto'),)
    for leg, pairs, want in (
            ('unfused', (), INCEPTION_LAUNCHES['googlenet']['auto']),
            ('fused', fused_pairs, BLOCKDIAG_LAUNCHES)):
        net = make(*pairs)
        groups = len(net.trainer.net._blockdiag_group_set())
        if groups != (BLOCKDIAG_GROUPS if pairs else 0):
            failures.append(f'{tag}[{leg}]: {groups} groups')
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        run = _train_steps(net, batches, BLOCKDIAG_STEPS, want,
                           f'{tag}[{leg}]', failures)
        launches = launch_counts()
        # ------------------------------------------------------------------
        p50 = float(np.median(run['step_ms']))
        out[leg] = {'groups': groups, 'launches': launches,
                    'step_ms': run['step_ms'],
                    'step_ms_p50': p50, 'images_per_s': batch / p50 * 1e3,
                    'loss': run['loss'],
                    'launches_per_step': run['per_step'][-1],
                    'launches_per_step_want': want}
        del net
        torch.cuda.empty_cache()
    first = (out['fused']['loss'][0], out['unfused']['loss'][0])
    if not abs(first[0] - first[1]) <= 1e-5 * abs(first[1]):
        failures.append(f'{tag}: first-step loss {first[0]} vs {first[1]}')

    # ---- one step at fuse=0, the unfused leg's choices replayed --------
    decisions = Decisions()
    legs = {}
    for leg, pairs in (('unfused', ()), ('fused', fused_pairs)):
        net = make(*pairs, ('fuse', '0'))
        decisions.replay = leg == 'fused'
        net.trainer.decisions = decisions
        legs[leg] = (_weights(net), *_step_change(net, batches[0]))
        del net
        torch.cuda.empty_cache()
    (w_u, dw_u, loss_u), (w_f, dw_f, loss_f) = legs['unfused'], legs['fused']
    del legs, decisions
    if any(not torch.equal(w, w_u[key]) for key, w in w_f.items()):
        failures.append(f'{tag}: initial weights differ between the legs')
    rel = {'/'.join(key): ((dw_f[key] - d).abs().max()
                           / d.abs().max().clamp_min(1e-30)).item()
           for key, d in dw_u.items()}
    worst = max(rel.values())
    out['fuse_0_step'] = {'max_rel_dw_err': worst,
                          'loss': {'fused': loss_f, 'unfused': loss_u},
                          'worst': sorted(rel.items(),
                                          key=lambda kv: -kv[1])[:5]}
    if not worst <= STOCK_TOL:
        failures.append(f'{tag}: one-step weight change differs by {worst} '
                        f'of its largest value > {STOCK_TOL}')
    if not abs(loss_f - loss_u) <= 1e-5 * abs(loss_u):
        failures.append(f'{tag}: fuse=0 first-step loss {loss_f} vs '
                        f'{loss_u}')
    return out


# --- the training runtime: supervision, exact resume, the native reader ------

# the reference AlexNet conf as written (bf16, use_pallas=1, dropout 0.5,
# batch 256) under TrainSupervisor: 12 steps, a save every 4, the newest
# 2 kept, and a plan that fails a write, NaNs a loss, corrupts the step-8
# checkpoint and stalls batch 11 past the watchdog.  The watchdog's
# producer calls the stall hook three batches ahead of the consumer (two
# queued, one in hand): a stall at batch 9 would fire while the NaN pass
# still holds batches 7-8 and pass unseen, so the stall sits at batch 11,
# which the replay after the step-8 save reaches
RUNTIME = dict(steps=12, save_every=4, keep_last=2, deadline=1.0,
               breaker=1, plan='nan_at_step=6;stall_batch=11:3.0;'
                               'raise_on_write=2;corrupt_shard=8')
RUNTIME_FIRED = ('corrupt_shard=8', 'nan_at_step=6', 'raise_on_write=2',
                 'stall_batch=11:3')
# (leg, save_async, steps_per_dispatch)
RUNTIME_LEGS = (('sync', 0, 1), ('async', 1, 1), ('async_k4', 1, 4))
# each leg's failure log: one divergence and one stall, each restored,
# the corrupt step quarantined, the failed write retried
RUNTIME_LOG = {'DivergenceError': 1, 'PipelineStallError': 1,
               'restored': 2, 'ckpt_quarantined': 1, 'io_retry': 1}
# the CLI's cross-process resume: the reference ImageNet.conf at batch
# 160 (four steps a round over the 640 images), 2 rounds then 1 more
# with continue=1 against 3 rounds in one process
RUNTIME_CLI_BATCH, RUNTIME_CLI_ROUNDS = 160, (2, 1)
# the page reader's file: this many 64 MB pages of 1 MB blobs
NATIVE_PAGES = 4


def _full_state(tr):
    """Params, optimizer slots, accumulator (device clones) and counters."""
    from cxxnet_tpu_torch.nnet.sharded_ckpt import flatten_with_keys
    out = {key: t.detach().clone() for part in ('params', 'opt_state',
                                                'grad_acc')
           for key, t in flatten_with_keys(getattr(tr, part), f'[{part!r}]')}
    out['counters'] = (tr.epoch_counter, tr.sample_counter, tr.round)
    return out


def _state_diff(a, b):
    return [k for k in a if (a[k] != b[k] if k == 'counters'
                             else not torch.equal(a[k], b[k]))]


def _runtime_leg(make, batches, root, name, save_async, k, plan_text):
    """One supervised run of ``RUNTIME['steps']`` updates from a fresh
    net: the sample counters of every step computed (a replayed step
    again), the launches of the run (counts from 0), the wall seconds,
    the plan's firings and the failure log's records of the run."""
    from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.runtime import faults
    from cxxnet_tpu_torch.runtime.supervisor import (SupervisorConfig,
                                                     TrainSupervisor)
    net = make(*WINDOW_PAIRS)
    tr = net.trainer
    n_steps = RUNTIME['steps']
    plan = faults.FaultPlan.parse(plan_text) if plan_text else None
    prev = faults.install_plan(plan)
    log = faults.global_failure_log()
    n0 = len(log)
    sup = TrainSupervisor(tr, os.path.join(root, name), SupervisorConfig(
        batch_deadline=RUNTIME['deadline'], max_restarts=4,
        nan_breaker=RUNTIME['breaker'], save_every=RUNTIME['save_every'],
        keep_last=RUNTIME['keep_last'], save_async=save_async))
    ep = ExecutionPlan.resolve(k, strict=True, silent=True)
    computed = []
    step = tr._step

    def counting(*args):
        computed.append(args[4])
        return step(*args)
    tr._step = counting
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        n = sup.run(lambda s: iter([batches[i % len(batches)]
                                    for i in range(s, n_steps)]),
                    make_stepper=lambda: ep.round_stepper(tr, lookahead=0))
        torch.cuda.synchronize()
        launches = launch_counts()
        # ------------------------------------------------------------------
        wall = time.perf_counter() - t0
    finally:
        sup.close()
        faults.install_plan(prev)
        del tr._step
    recs = log.records()[n0:]
    kinds = {}
    for r in recs:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    return net, {'updates': n, 'computed': computed, 'launches': launches,
                 'wall_s': wall, 'fired': plan.fired() if plan else [],
                 'log': kinds, 'records': [(r.kind, r.step, r.detail[:160])
                                           for r in recs],
                 'kept': sorted(os.listdir(os.path.join(root, name)))}


def _save_costs(tr, root):
    """A step dir's bytes and files; the sync save's ms; the async save's
    stall of the step loop (the snapshot and the submit) and its commit
    ms on the writer; the restore's ms."""
    from cxxnet_tpu_torch.nnet import sharded_ckpt
    from cxxnet_tpu_torch.runtime.async_ckpt import AsyncCheckpointer
    d = os.path.join(root, 'costs')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.save_training_state(d, 1)
    sync_ms = (time.perf_counter() - t0) * 1e3
    files = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    ck = AsyncCheckpointer(workers=2)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_sharded_async(d, 2, tr.snapshot_training_state())
        stall_ms = (time.perf_counter() - t0) * 1e3
        ck.wait()
        commit_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ck.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.load_training_state(d, 2, restore_params=True)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    same = all(open(os.path.join(d, 'step_1', f), 'rb').read() ==
               open(os.path.join(d, 'step_2', f), 'rb').read()
               for f in files)
    return {'step_dir_bytes': sum(files.values()), 'files': len(files),
            'largest_file_bytes': max(files.values()),
            'sync_save_ms': sync_ms, 'async_stall_ms': stall_ms,
            'async_commit_ms': commit_ms, 'restore_ms': restore_ms,
            'sync_and_async_files_equal': same,
            'verify': sharded_ckpt.verify_step_dir(
                sharded_ckpt.step_dir(d, 2))}


def _runtime_dataset(root, env):
    """PR 19's imgbin fixture (``IMGBIN``'s images, packed by the port's
    im2bin) made under ``root`` by a child process on the host's other
    cores while the card trains; returns the process."""
    code = ('import json, sys; sys.path.insert(0, sys.argv[1]); '
            'import chip_smoke as cs; '
            'from cxxnet_tpu_torch.io import im2bin; '
            'n = json.loads(sys.argv[2]); cs.IMGBIN.update(n); '
            "cs._synth_images('.', 'NameList.train', n['train'], n['seed']); "
            "cs._synth_images('.', 'NameList.test', n['test'], "
            "n['seed'] + 1); "
            "sys.exit(im2bin.main(['NameList.train', 'img', 'TRAIN.BIN']) "
            "or im2bin.main(['NameList.test', 'img', 'TEST.BIN']))")
    return subprocess.Popen(
        [sys.executable, '-c', code, os.path.dirname(os.path.abspath(
            __file__)), json.dumps(IMGBIN)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class _StampedLines:
    """A text stream that keeps each line it is written with the seconds
    since ``t0`` at which the line ended: ``_stamped_run``'s lines for a
    run in this process."""

    def __init__(self, t0):
        self.t0, self.lines, self._part = t0, [], ''

    def write(self, text):
        parts = (self._part + text).split('\n')
        self._part = parts.pop()
        now = time.perf_counter() - self.t0
        self.lines.extend((now, ln) for ln in parts)
        return len(text)

    def flush(self):
        pass

    def done(self):
        if self._part:
            self.lines.append((time.perf_counter() - self.t0, self._part))
            self._part = ''
        return self.lines


def _cli_in_process(args, cwd):
    """``cxxnet_tpu_torch.main.main(args)`` in this process from ``cwd``,
    its stdout and stderr captured as ``_stamped_run`` gives a child's:
    ``(rc, [(t, stdout line)], [(t, stderr line)], wall seconds)``."""
    import contextlib
    import traceback
    from cxxnet_tpu_torch.main import main as cli_main
    t0 = time.perf_counter()
    out, err = _StampedLines(t0), _StampedLines(t0)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(list(args))
    except Exception:  # noqa: BLE001 — reported as the run's failure
        rc = 1
        err.write(traceback.format_exc())
    finally:
        os.chdir(old)
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rc, out.done(), err.done(), wall


def _runtime_cli(root, env, failures):
    """The CLI's exact resume across processes on the reference
    ImageNet.conf: 2 rounds with ``exact_ckpt=1`` in this process, then
    ``continue=1`` for 1 more in a child process, against 3 rounds in
    one process (this one); the round-3 model files and exact sidecars
    byte for byte, the round-3 eval lines equal."""
    from cxxnet_tpu_torch.nnet import sharded_ckpt
    work = os.path.join(root, 'run', 'ImageNet')
    os.makedirs(os.path.join(work, 'models'))
    with open(os.path.join(ROOT, 'example', 'ImageNet',
                           'ImageNet.conf')) as f:
        conf_text = f.read()
    with open(os.path.join(work, 'ImageNet.conf'), 'w') as f:
        f.write(conf_text)
    first, more = RUNTIME_CLI_ROUNDS
    common = ['ImageNet.conf', f'batch_size={RUNTIME_CLI_BATCH}',
              'exact_ckpt=1']
    legs = (('a', True, [f'num_round={first}', 'model_dir=models_a']),
            ('b', False, [f'num_round={first + more}', 'continue=1',
                          'model_dir=models_a']),
            ('c', True, [f'num_round={first + more}', 'model_dir=models_c']))
    out = {}
    for leg, here, args in legs:
        if here:
            rc, so, se, wall = _cli_in_process(common + args, work)
        else:
            cmd = [sys.executable, '-m', 'cxxnet_tpu_torch.main', *common,
                   *args]
            rc, so, se, wall = _stamped_run(cmd, work, env, 600)
        so, se = [ln for _, ln in so], [ln for _, ln in se]
        out[leg] = {'args': ' '.join(common[1:] + args),
                    'process': 'this' if here else 'child', 'rc': rc,
                    'seconds': wall,
                    'eval_lines': [ln for ln in se if ln.startswith('[')],
                    'exact_restored': any('exact optimizer state restored'
                                          in ln for ln in so)}
        if rc != 0:
            failures.append(f'runtime[cli_{leg}]: exit {rc}: '
                            + '\n'.join(se[-30:]))
            return out
    step = first + more
    last = f'{step:04d}.model'
    a_model = os.path.join(work, 'models_a', last)
    c_model = os.path.join(work, 'models_c', last)
    da = sharded_ckpt.step_dir(os.path.join(work, 'models_a', 'exact_state'),
                               step)
    dc = sharded_ckpt.step_dir(os.path.join(work, 'models_c', 'exact_state'),
                               step)
    model_equal = (os.path.exists(a_model) and os.path.exists(c_model)
                   and open(a_model, 'rb').read() == open(c_model,
                                                          'rb').read())
    names = sorted(os.listdir(da)) if os.path.isdir(da) else []
    exact_equal = bool(names) and os.path.isdir(dc) and \
        names == sorted(os.listdir(dc)) and all(
            open(os.path.join(da, n), 'rb').read() ==
            open(os.path.join(dc, n), 'rb').read() for n in names)
    evals_equal = (out['b']['eval_lines'][-1:] == out['c']['eval_lines'][-1:]
                   and len(out['c']['eval_lines']) == step)
    out.update({'batch_size': RUNTIME_CLI_BATCH, 'rounds': [first, more],
                'steps': [first * 4, more * 4],
                'model_file_equal': model_equal,
                'exact_sidecar_equal': exact_equal,
                'exact_sidecar_files': len(names),
                'round_eval_equal': evals_equal})
    if not (model_equal and exact_equal and evals_equal
            and out['b']['exact_restored']):
        failures.append(f'runtime[cli]: {first}+{more} rounds with '
                        f'continue=1 exact_ckpt=1 not bitwise {step} '
                        f'rounds: model {model_equal}, sidecar {exact_equal}, '
                        f'eval {evals_equal}, restored '
                        f'{out["b"]["exact_restored"]}')
    return out


def native_phase(root, failures):
    """The native runtime on this machine: built or not and the
    compiler's message; the page reader's MB/s against ``BinaryPage`` on
    a file of ``NATIVE_PAGES`` 64 MB pages (written just before, so the
    read is warm); libjpeg against PIL ms per 256 x 256 JPEG (None where
    libjpeg is not built); the imgbin chain's images/s with the native
    reader and decoder and with the Python ones, one pass each over the
    runtime phase's TRAIN.BIN (in the page cache)."""
    from PIL import Image
    import io as _io
    from cxxnet_tpu_torch.io import iter_imbin
    from cxxnet_tpu_torch.io.data import create_iterator
    from cxxnet_tpu_torch.runtime import native
    from cxxnet_tpu_torch.utils.io_stream import BinaryPage
    t0 = time.perf_counter()
    st = native.native_status()
    out = {'phase': 'native', 'nvidia_smi': nvidia_smi_line(),
           'built': st['built'], 'jpeg': st['jpeg'],
           'disabled': st['disabled'], 'message': st['message'][-800:],
           'load_s': time.perf_counter() - t0}
    if not st['built']:
        failures.append(f'native: the page reader did not build: '
                        f'{st["message"][-400:]}')
        return out
    rng = np.random.RandomState(SEED)
    path = os.path.join(root, 'pages.bin')
    blob = rng.bytes(1 << 20)
    with open(path, 'wb') as f:
        for p in range(NATIVE_PAGES):
            page = BinaryPage()
            while page.push(bytes([p]) + blob[1:]):
                pass
            page.save(f)
    size = os.path.getsize(path)

    def read_native():
        r = native.NativePageReader(path)
        try:
            return [len(b) for pg in r.iter_pages() for b in pg]
        finally:
            r.close()

    def read_python():
        got = []
        with open(path, 'rb') as f:
            while True:
                page = BinaryPage()
                if not page.load(f):
                    return got
                got += [len(b) for b in page]

    rates = {}
    for key, fn in (('native', read_native), ('python', read_python)):
        fn()
        t0 = time.perf_counter()
        lens = fn()
        rates[key] = size / (time.perf_counter() - t0) / 1e6
        rates[f'{key}_blobs'] = len(lens)
    if rates['native_blobs'] != rates['python_blobs']:
        failures.append(f'native: page reader gave {rates["native_blobs"]} '
                        f'blobs, Python {rates["python_blobs"]}')
    out['page_reader_MB_per_s'] = rates
    out['page_file_bytes'] = size
    arr = rng.randint(0, 255, (256, 256, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', quality=90)
    jpg = buf.getvalue()

    def per_image(fn, reps=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def pil():
        with Image.open(_io.BytesIO(jpg)) as im:
            return np.asarray(im.convert('RGB'))
    out['decode_ms'] = {
        'libjpeg': per_image(lambda: native.decode_jpeg(jpg))
        if st['jpeg'] else None, 'pil': per_image(pil)}
    if st['jpeg'] and not np.array_equal(native.decode_jpeg(jpg), pil()):
        out['decode_libjpeg_equals_pil'] = False
    # the imgbin chain over TRAIN.BIN, one pass each way after a warm one
    crop = min(227, IMGBIN['size'])
    cfg = [('iter', 'imgbin'), ('image_list', os.path.join(
        root, 'NameList.train')), ('image_bin', os.path.join(
            root, 'TRAIN.BIN')), ('input_shape', f'3,{crop},{crop}'),
        ('rand_crop', '1'), ('rand_mirror', '1'), ('batch_size', str(BATCH)),
        ('divideby', '256'), ('silent', '1'), ('iter', 'end')]
    chain = {}
    # the staticmethod object itself: restoring the function an attribute
    # read returns would make it an instance method
    real = (iter_imbin.ImageBinIterator.__dict__['_native'],
            native.decode_jpeg)
    for key in ('native', 'python'):
        if key == 'python':
            iter_imbin.ImageBinIterator._native = staticmethod(lambda: None)
            native.decode_jpeg = lambda _blob: None
        try:
            it = create_iterator(cfg)
            it.init()
            try:
                t0 = time.perf_counter()
                n = sum(b.batch_size - b.num_batch_padd for b in it)
                chain[key] = n / (time.perf_counter() - t0)
            finally:
                getattr(it, 'close', lambda _t: None)(10.0)
        finally:
            iter_imbin.ImageBinIterator._native, native.decode_jpeg = real
    out['imgbin_chain_images_per_s'] = chain
    out['imgbin_chain_decoder'] = 'libjpeg' if st['jpeg'] else 'PIL'
    return out


def runtime_phase(failures):
    """The training runtime on AlexNet as the reference conf is written
    (bf16, ``use_pallas=1``, dropout 0.5, batch 256, seeded batches from a
    replayable list): an uninterrupted 12-step run, then three
    supervised runs under ``RUNTIME``'s fault plan (sync saves, async
    saves, async saves in K=4 windows), each bitwise the uninterrupted
    run (params, momentum, accumulator, counters) with every event fired,
    the corrupt step quarantined and the kernels launched a step's counts
    x the steps computed (run + replayed); a fault-free supervised run
    (async saves) timed against the unsupervised one; a save's bytes and
    costs; the CLI's ``continue=1 exact_ckpt=1`` resume across processes
    on the reference ImageNet.conf; and the native runtime's line."""
    batches = _window_batches()
    make = _net_maker(_example_conf('ImageNet.conf', 'ImageNet_train.conf'),
                      ('batch_size', str(BATCH)))
    per_step = as16(STEP_LAUNCHES['on'])
    out = {'phase': 'runtime', 'nvidia_smi': nvidia_smi_line(),
           'conf': 'ImageNet.conf + ImageNet_train.conf', 'batch': BATCH,
           'dtype': 'bfloat16', 'net_params': dict(WINDOW_PAIRS),
           **{k: v for k, v in RUNTIME.items()}}
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    with tempfile.TemporaryDirectory() as root:
        # the CLI's dataset, made by a child process while the card trains
        dataset = _runtime_dataset(root, env)
        try:
            _runtime_legs(out, make, batches, per_step, root, env, dataset,
                          failures)
        finally:
            if dataset.poll() is None:
                dataset.kill()
                dataset.wait()
    return out


def _runtime_legs(out, make, batches, per_step, root, env, dataset,
                  failures):
    """The body of :func:`runtime_phase` in its temporary directory;
    fills ``out``."""
    tag = 'runtime'
    n_steps = RUNTIME['steps']
    # ---- the uninterrupted run ----------------------------------------------
    net = make(*WINDOW_PAIRS)
    tr = net.trainer
    for i in range(2):                       # warm-up, then a fresh net
        tr.update(batches[i])
    del net, tr
    net = make(*WINDOW_PAIRS)
    tr = net.trainer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        tr.update(batches[i % len(batches)])
    tr.flush_divergence_check()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ref = _full_state(tr)
    out['unsupervised'] = {'wall_s': plain_s,
                           'steps_per_s': n_steps / plain_s,
                           'loss_last': float(tr.last_loss)}
    out['save_costs'] = _save_costs(tr, root)
    del net, tr
    torch.cuda.empty_cache()

    # ---- the supervised legs under the fault plan -------------------------
    out['legs'] = {}
    for name, save_async, k in RUNTIME_LEGS:
        net, leg = _runtime_leg(make, batches, root, name, save_async, k,
                                RUNTIME['plan'])
        diff = _state_diff(_full_state(net.trainer), ref)
        computed = leg.pop('computed')
        want = {kk: v * len(computed) for kk, v in per_step.items()}
        leg.update({'k': k, 'save_async': save_async,
                    'steps_computed': len(computed),
                    'steps_replayed': len(computed) - n_steps,
                    'bitwise': not diff, 'launches_want': want})
        del net
        torch.cuda.empty_cache()
        t = f'{tag}[{name}]'
        if leg['updates'] != n_steps:
            failures.append(f'{t}: {leg["updates"]} updates')
        if sorted(leg['fired']) != sorted(RUNTIME_FIRED):
            failures.append(f'{t}: fired {leg["fired"]}')
        if any(leg['log'].get(kk, 0) != v for kk, v in RUNTIME_LOG.items()):
            failures.append(f'{t}: failure log {leg["log"]}')
        if 'step_8.corrupt' not in leg['kept']:
            failures.append(f'{t}: kept {leg["kept"]}')
        if diff:
            failures.append(f'{t}: not bitwise the uninterrupted run: '
                            f'{diff[:6]}')
        if sorted(set(computed)) != list(range(n_steps)):
            failures.append(f'{t}: steps computed {computed}')
        if leg['launches'] != want:
            failures.append(f'{t}: launched {leg["launches"]}, want '
                            f'{want}')
        out['legs'][name] = leg

    # ---- a fault-free supervised run, timed --------------------------------
    net, leg = _runtime_leg(make, batches, root, 'clean_async', 1, 1, '')
    diff = _state_diff(_full_state(net.trainer), ref)
    del net
    torch.cuda.empty_cache()
    leg.pop('computed')
    leg.update({'save_async': 1, 'steps_per_s': n_steps / leg['wall_s'],
                'bitwise': not diff})
    if diff or leg['updates'] != n_steps:
        failures.append(f'{tag}[clean_async]: {leg["updates"]} updates, '
                        f'diff {diff[:6]}')
    out['clean_async'] = leg

    # ---- the CLI across processes, then the native line --------------------
    text, _ = dataset.communicate(timeout=600)
    if dataset.returncode != 0:
        failures.append(f'{tag}: the dataset exit {dataset.returncode}: '
                        f'{text[-2000:]}')
        return
    t0 = time.perf_counter()
    out['cli'] = _runtime_cli(root, env, failures)
    out['cli']['elapsed_s'] = time.perf_counter() - t0
    out['native'] = native_phase(root, failures)


# --- the serving extensions: hot reload, replicas, the fleet ------------------

# the fleet phase's bucket ladder (requests of 1-32 images, and 256 for
# the replicas' images/s), clients, the least requests its reload leg
# serves, and a new model's seed offsets
FLEET_BUCKETS = (1, 8, 32, 128, 256)
FLEET_CLIENTS, FLEET_MIN_REQUESTS, FLEET_MAX_ROWS = 4, 200, 32
# the reload leg's least requests computed on each served version
FLEET_PER_VERSION = 20
# the LM reload leg: the decode phase's LM at its width, two blocks deep
FLEET_LM_STAGES, FLEET_LM_NEW = 2, 48
# an evicted model's device memory must come back to within this much
FLEET_FREE_SLACK = 1 << 20


class _ForwardCount:
    """Counts ``PredictEngine._fwd`` calls by batch rows over every engine
    while installed: the forwards a run's launches must be a multiple
    of."""

    def __init__(self):
        from cxxnet_tpu_torch.serve.engine import PredictEngine
        self._cls, self._orig = PredictEngine, PredictEngine._fwd
        self.by_rows = {}
        lock = threading.Lock()
        orig, counts = self._orig, self.by_rows

        def counted(eng, params, data):
            with lock:
                counts[data.shape[0]] = counts.get(data.shape[0], 0) + 1
            return orig(eng, params, data)
        PredictEngine._fwd = counted

    def close(self):
        self._cls._fwd = self._orig


def _per_forward(engine):
    """Each bucket's launches of one forward (outside any main path)."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    c, y, x = engine.trainer.net_cfg.input_shape
    out = {}
    for b in engine.buckets:
        reset_launch_counts()
        engine.predict_scores(np.zeros((b, c, y, x), np.float32))
        out[b] = launch_counts()
    return out


def _check_forward_launches(tag, launches, forwards, per, failures):
    """A run's launches against its forwards x each bucket's launches of
    one forward; every forward kernel of the serving path launched."""
    want = {k: sum(n * per[b][k] for b, n in forwards.items())
            for k in launches}
    _check_launches(tag, launches, want, failures)
    for k in SERVE_KERNELS:
        if launches.get(k, 0) <= 0:
            failures.append(f'{tag}: {k} never launched')
    return want


# a seeded AlexNet's model-file bytes, shared by the fleet legs (one
# serialization takes ~1 s); emptied at the fleet phase's end
_FLEET_BLOBS = {}


def _model_bytes(net, seed):
    """A model file's bytes of ``net`` re-initialized from ``seed``: the
    net-type prefix and the trainer's model (``_FLEET_BLOBS``' copy where
    that seed was serialized before; every fleet leg's net is of one
    conf)."""
    import io
    net.set_param('seed', str(seed))
    net.init_model()
    if seed not in _FLEET_BLOBS:
        buf = io.BytesIO()
        buf.write((0).to_bytes(4, 'little', signed=True))
        net.trainer.save_model(buf)
        _FLEET_BLOBS[seed] = buf.getvalue()
    return _FLEET_BLOBS[seed]


def _publish(path, data):
    """Write ``data`` as a model file through ``publish_model_file``: the
    digest committed before the rename, the ``corrupt_model`` hook on the
    staged file.  Returns the seconds it took."""
    from cxxnet_tpu_torch.nnet import checkpoint
    t0 = time.perf_counter()
    checkpoint.publish_model_file(path, lambda f: f.write(data))
    return time.perf_counter() - t0


def _stock_twin(conf, params):
    """A ``Net`` of ``conf`` on the stock composition (``use_pallas=0
    fuse=0``: cuDNN convs, PyTorch's LRN and products) holding a copy of
    ``params``, a trainer's tree of the same conf."""
    from cxxnet_tpu_torch import Net
    stock = Net(dev='cuda', cfg=conf)
    for k, v in (('seed', str(SEED)), ('use_pallas', '0'), ('fuse', '0')):
        stock.set_param(k, v)
    stock.init_model()
    with torch.no_grad():
        for k, fs in stock.trainer.params.items():
            for f, v in fs.items():
                v.copy_(params[k][f])
    return stock


def _stock_check(tag, ref_fn, pairs, failures):
    """Each ``(input, served scores)`` pair against ``ref_fn(input)``, the
    stock composition's scores, at ``SERVE_RTOL`` / ``SERVE_ATOL``, as the
    serve phase holds its kernels; the stock forwards launch no port
    kernel.  Returns the max abs error by rows."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    reset_launch_counts()
    errs = {}
    for x, got in pairs:
        ref = ref_fn(x)
        err = float(np.abs(got - ref).max())
        errs[len(x)] = max(err, errs.get(len(x), 0.0))
        if not np.allclose(got, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            failures.append(f'{tag}: {len(x)}-row scores differ from the '
                            f'stock composition by {err}')
    if sum(launch_counts().values()):
        failures.append(f'{tag}: the stock leg launched port kernels')
    return errs


def _fleet_pool():
    """Four seeded 32-image batches; request i is ``sizes[i]`` rows of
    batch i % 4."""
    rng = np.random.RandomState(SEED + 31)
    return [rng.randn(FLEET_MAX_ROWS, 3, 227, 227).astype(np.float32)
            for _ in range(4)]


def _wait_until(pred, seconds, what, failures):
    t_end = time.monotonic() + seconds
    while not pred():
        if time.monotonic() > t_end:
            failures.append(f'fleet: timed out waiting for {what}')
            return False
        time.sleep(0.01)
    return True


def _fleet_reload(conf, work, pool, failures):
    """``Net.serve_start`` over ``0001.model`` under closed-loop traffic
    (4 clients, 1-32 images a request) while a ``ModelRegistry`` polls
    the model dir: ``0002.model`` (another seed) is adopted, ``0003`` is
    published under ``FaultPlan(corrupt_model=1)`` and rejected while
    0002 keeps serving, ``0004`` is adopted.  Zero drops, the versions
    each request was computed with, the reload's stage times, the shapes
    run, the launches per forward, and the scores after the last swap
    (a 32-row and a 128-row request) against a fresh engine on 0004 and
    against the stock composition on 0004."""
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.runtime import faults
    from cxxnet_tpu_torch.serve import ModelRegistry, PredictEngine
    mdir = os.path.join(work, 'reload')
    os.makedirs(mdir)
    net = Net(dev='cuda', cfg=conf)
    _publish(os.path.join(mdir, '0001.model'), _model_bytes(net, SEED))
    # the new versions' bytes, drawn before the main path (their init
    # draws are not the serving path's launches)
    donor = Net(dev='cuda', cfg=conf)
    versions = {v: _model_bytes(donor, SEED + v - 1) for v in (2, 3, 4)}
    del donor
    sizes = [int(v) for v in np.random.RandomState(SEED + 32).randint(
        1, FLEET_MAX_ROWS + 1, 100000)]
    served, errors, bad = {}, [], []
    lock = threading.Lock()
    stop = threading.Event()
    nxt, done = [0], [0]

    def client():
        while not stop.is_set():
            with lock:
                i = nxt[0]
                nxt[0] += 1
            x = pool[i % 4][:sizes[i]]
            try:
                s = net.serve_scores(x, deadline=120.0)
            except Exception as e:  # noqa: BLE001 — a drop: reported
                with lock:
                    errors.append(f'request {i}: {e!r}')
                continue
            with lock:
                done[0] += 1
                if s.shape != (len(x), 1000) or not np.isfinite(s).all():
                    bad.append(i)

    def on_serve(version):
        with lock:
            served[version] = served.get(version, 0) + 1

    def count(version):
        """Windows computed with ``version`` (each of 1+ requests)."""
        with lock:
            return served.get(version, 0)

    def requests():
        with lock:
            return done[0]

    log = faults.FailureLog()
    fwd = _ForwardCount()
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    try:
        net.serve_start(buckets=','.join(map(str, FLEET_BUCKETS)),
                        max_queue=256, max_wait=0.002, deadline=120.0)
        net.engine.on_serve = on_serve
        reg = ModelRegistry(net.engine, mdir, poll_interval=0.05, current=1,
                            log=log)
        reg.start()
        threads = [threading.Thread(target=client)
                   for _ in range(FLEET_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        timings, publish_s = {}, {}
        per_version = FLEET_PER_VERSION // FLEET_CLIENTS
        _wait_until(lambda: count(1) >= per_version, 60,
                    'version 1 traffic', failures)
        publish_s[2] = _publish(os.path.join(mdir, '0002.model'),
                                versions[2])
        if _wait_until(lambda: reg.current == 2, 120, 'the swap to 0002',
                       failures):
            timings[2] = dict(reg.last_timings)
        _wait_until(lambda: count(2) >= per_version, 60,
                    'version 2 traffic', failures)
        prev = faults.install_plan(faults.FaultPlan.parse('corrupt_model=1'))
        try:
            publish_s[3] = _publish(os.path.join(mdir, '0003.model'),
                                    versions[3])
            fired = faults.active_plan().fired()
        finally:
            faults.install_plan(prev)
        _wait_until(lambda: reg._attempts.get(3, 0)
                    >= reg.retry.max_attempts, 120,
                    'the blacklisting of 0003', failures)
        current_after_reject = reg.current
        n_before = count(2)
        _wait_until(lambda: count(2) >= n_before + per_version, 60,
                    'version 2 traffic after the rejection', failures)
        publish_s[4] = _publish(os.path.join(mdir, '0004.model'),
                                versions[4])
        if _wait_until(lambda: reg.current == 4, 120, 'the swap to 0004',
                       failures):
            timings[4] = dict(reg.last_timings)
        _wait_until(lambda: count(4) >= per_version and requests()
                    >= FLEET_MIN_REQUESTS, 60, 'version 4 traffic',
                    failures)
        stop.set()
        for t in threads:
            t.join(120)
        wall = time.perf_counter() - t0
        reg.close(10)
        launches = launch_counts()
    finally:
        stop.set()
        fwd.close()
    # --------------------------------------------------------------------
    engine = net.engine
    failures.extend(f'fleet[reload]: {e}' for e in errors[:5])
    if bad:
        failures.append(f'fleet[reload]: {len(bad)} bad score rows')
    states = [s for s, d in reg.transitions if '0003' in d]
    rejects = [r for r in log.records('serve_reload_reject')
               if 'checkpoint 3 ' in r.detail]
    checks = {
        'zero_drops': not errors and not bad,
        'versions_served': sorted(served) == [1, 2, 4],
        'corrupt_rejected': (fired == ['corrupt_model=1']
                             and current_after_reject == 2
                             and 'REJECTED' in states
                             and 'SWAPPED' not in states
                             and len(rejects) == reg.retry.max_attempts),
        'compile_count': engine.compile_count == len(FLEET_BUCKETS)}
    per = _per_forward(engine)
    want = _check_forward_launches('fleet[reload]', launches, fwd.by_rows,
                                   per, failures)
    big, x128 = pool[0], np.concatenate(pool)
    got, got128 = engine.predict_scores(big), engine.predict_scores(x128)
    net.serve_stop()
    fresh = Net(dev='cuda', cfg=conf)
    fresh.load_model(os.path.join(mdir, '0004.model'))
    ref = PredictEngine(fresh.trainer, FLEET_BUCKETS).predict_scores(big)
    err = float(np.abs(got - ref).max())
    checks['post_swap_scores'] = bool(np.allclose(got, ref, rtol=SERVE_RTOL,
                                                  atol=SERVE_ATOL))
    stock = _stock_twin(conf, fresh.trainer.params)
    n_fail = len(failures)
    stock_err = _stock_check('fleet[reload]', stock.predict_scores,
                             ((big, got), (x128, got128)), failures)
    checks['post_swap_stock'] = len(failures) == n_fail
    for name, ok in checks.items():
        if not ok:
            failures.append(f'fleet[reload]: check {name} failed')
    out = {'requests': requests(), 'windows_by_version': served,
           'drive_s': wall, 'checks': checks,
           'transitions': [s for s, _ in reg.transitions],
           'reload_ms': {v: {k[:-2]: t * 1e3 for k, t in ts.items()}
                         for v, ts in timings.items()},
           'publish_ms': {v: t * 1e3 for v, t in publish_s.items()},
           'failure_log': log.summary(), 'fired': fired,
           'compile_count': engine.compile_count,
           'forwards_by_rows': fwd.by_rows, 'launches': launches,
           'launches_want': want, 'post_swap_max_abs_err': err,
           'stock_max_abs_err': stock_err, 'stock_rtol': SERVE_RTOL,
           'stock_atol': SERVE_ATOL}
    del fresh, stock
    return out, net


def _fleet_replicas(conf, net, pool, failures):
    """``ReplicatedPredictEngine(replicas=2, devices=[cuda:0, cuda:0])``
    behind one ``DynamicBatcher``: scores bitwise the single engine's at
    every bucket's shape (each request one window, so both replicas take
    turns) and within tolerance of the stock composition's there, both
    replicas' rows, three fleet-atomic swaps under traffic
    from 3 clients with no window on mixed versions, then every replica
    bitwise a single engine on the last tree; ``replicas=2`` over every
    CUDA device raises JAX's error on a one-card machine; images/s at
    batch 256, single against replicated, 2 clients each."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve import (DynamicBatcher, PredictEngine,
                                        ReplicatedPredictEngine)
    from cxxnet_tpu_torch.utils.metric import StatSet
    tr = net.trainer
    dev = torch.device('cuda', 0)
    base = PredictEngine(tr, FLEET_BUCKETS)
    inputs = [pool[1][:b] for b in FLEET_BUCKETS if b <= FLEET_MAX_ROWS]
    inputs += [np.concatenate(pool), np.concatenate(pool * 2)]  # 128, 256
    want = [base.predict_scores(x) for x in inputs]
    p2 = {k: {f: v * 1.01 for f, v in fs.items()}
          for k, fs in tr.params.items()}
    seen, errs = [], []
    stop = threading.Event()
    fwd = _ForwardCount()
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    try:
        rep = ReplicatedPredictEngine(tr, FLEET_BUCKETS, replicas=2,
                                      devices=[dev, dev], stats=StatSet())
        rep.warm()
        bat = DynamicBatcher(rep, max_queue=256, max_wait=0.002,
                             deadline=120.0, stats=rep.stats)
        bitwise, replies = True, []
        # one window a request, strict round-robin: the extra first
        # request between the passes gives each replica each input
        for x, w in zip(inputs + inputs[:1] + inputs,
                        want + want[:1] + want):
            replies.append((x, bat.submit(x, 120.0)))
            bitwise &= bool(np.array_equal(replies[-1][1], w))
        for e in rep.engines:
            orig = e.predict_scores

            def recorded(data, orig=orig):
                seen.append(tuple(r.version for r in rep.engines))
                return orig(data)
            e.predict_scores = recorded

        def pound():
            while not stop.is_set():
                try:
                    bat.submit(pool[2][:8], 120.0)
                except Exception as e:  # noqa: BLE001 — reported
                    errs.append(repr(e))
                    return

        threads = [threading.Thread(target=pound) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        swap_ms = []
        for v in range(1, 4):
            t0 = time.perf_counter()
            rep.swap_params(p2 if v % 2 else tr.params, version=v)
            swap_ms.append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(120)
        bat.close(60)
        launches = launch_counts()
    finally:
        stop.set()
        fwd.close()
    # --------------------------------------------------------------------
    rows = [int(rep.stats.get(f'replica_rows[r{i}]')) for i in range(2)]
    last = [e.predict_scores(pool[3]) for e in rep.engines]
    single = PredictEngine(tr, FLEET_BUCKETS)
    single.swap_params(p2)                  # version 3 is p2's
    checks = {'bitwise_single': bitwise,
              'both_replicas_rows': all(r > 0 for r in rows),
              'no_mixed_window': bool(seen) and all(len(set(v)) == 1
                                                    for v in seen),
              'swap_no_errors': not errs,
              'last_tree_bitwise': all(np.array_equal(
                  s, single.predict_scores(pool[3])) for s in last)}
    per = _per_forward(rep.engines[0])
    lwant = _check_forward_launches('fleet[replicas]', launches,
                                    fwd.by_rows, per, failures)
    # every bucket's input, as each replica answered it, against the
    # stock composition on the same weights
    stock = _stock_twin(conf, tr.params)
    n_fail = len(failures)
    stock_err = _stock_check('fleet[replicas]', stock.predict_scores,
                             replies, failures)
    checks['stock_scores'] = len(failures) == n_fail
    del stock
    n = torch.cuda.device_count()
    none_error = None
    try:
        ReplicatedPredictEngine(tr, FLEET_BUCKETS, replicas=2).close(10)
        checks['devices_none_error'] = n >= 2
    except ValueError as e:
        checks['devices_none_error'] = (
            n < 2 and str(e) == f'serve.replicas=2 exceeds the {n} '
            'available devices')
        none_error = str(e)
    for name, ok in checks.items():
        if not ok:
            failures.append(f'fleet[replicas]: check {name} failed')
    failures.extend(f'fleet[replicas]: {e}' for e in errs[:3])

    def rate(fn, clients=2, reps=5):
        big = inputs[-1]
        fn(big)
        t0 = time.perf_counter()
        ths = [threading.Thread(target=lambda: [fn(big)
                                                for _ in range(reps)])
               for _ in range(clients)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
        return clients * reps * big.shape[0] / (time.perf_counter() - t0)

    img_s = {}
    for name, fn in (('single', single.predict_scores),
                     ('replicated', rep.predict_scores),
                     ('replicated_again', rep.predict_scores),
                     ('single_again', single.predict_scores)):
        img_s[name] = rate(fn)
    rep.close(30)
    return {'checks': checks, 'replica_rows': rows,
            'windows_seen': len(seen),
            'versions_seen': sorted({v[0] for v in seen}),
            'swap_ms': swap_ms, 'compile_count': rep.compile_count,
            'devices_none_error': none_error,
            'images_per_s_b256': img_s, 'nvidia_smi': nvidia_smi_line(),
            'forwards_by_rows': fwd.by_rows, 'launches': launches,
            'launches_want': lwant, 'stock_max_abs_err': stock_err}


def _allocated():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _fleet_models(conf, work, pool, failures):
    """``Net.serve_start(models=..., mem_budget=...)`` over three
    differently seeded model dirs, f32, under a budget that fits two
    (2.5 models): the third load evicts the coldest, a leased model is
    never the victim, an evicted model's device memory comes back to
    within 1 MiB after ``gc.collect()``; each model's ``resident_bytes``
    beside its measured allocation; then the same three at
    ``dtype='int8'`` all fit under the same budget.  Model z's f32 and
    int8 scores against the stock composition on z's weights (int8: the
    same weight-only tier over the stock net)."""
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.nnet import quantize
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve import PredictEngine
    dirs = {}
    # the serving net: its last init is z's weights, which the stock
    # twin copies
    net = Net(dev='cuda', cfg=conf)
    for i, mid in enumerate('xyz'):
        dirs[mid] = os.path.join(work, 'fleet', mid)
        os.makedirs(dirs[mid])
        _publish(os.path.join(dirs[mid], '0001.model'),
                 _model_bytes(net, SEED + 1 + i))
    stock = _stock_twin(conf, net.trainer.params)
    one = quantize.tree_nbytes(net.trainer.params)
    budget = int(one * 2.5)
    x = pool[3][:8]
    checks, alloc, resident, order = {}, {}, {}, []
    fwd = _ForwardCount()
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    try:
        net.serve_start(buckets=','.join(map(str, FLEET_BUCKETS)),
                        models=dirs, mem_budget=budget)
        fleet = net.fleet
        for mid in 'xyz':
            before = _allocated()
            net.serve_scores(x, model=mid)
            if mid != 'z':               # z's load evicts x: measured below
                alloc[mid] = _allocated() - before
            resident[mid] = fleet.budgeter.resident().get(mid)
            order.append(fleet.loaded())
        checks['third_evicts_coldest'] = order[-1] == ['y', 'z']
        with fleet.lease('y'):
            net.serve_scores(x, model='x')   # y is coldest, but leased
            order.append(fleet.loaded())
        checks['leased_never_evicted'] = order[-1] == ['x', 'y']
        # z alone beside y: its allocation, and what its eviction leaves
        fleet.evict('x')
        before = _allocated()
        z32 = net.serve_scores(x, model='z')
        alloc['z'] = _allocated() - before
        fleet.evict('z')
        freed = _allocated() - before
        checks['eviction_frees'] = abs(freed) <= FLEET_FREE_SLACK
        f32_report = net.serve_stats()
        evictions = fleet.evictions
        net.serve_stop()
        # ---- the same three at int8 under the same budget ----------------
        net.serve_start(buckets=','.join(map(str, FLEET_BUCKETS)),
                        models=dirs, mem_budget=budget, dtype='int8')
        fleet = net.fleet
        alloc8, resident8 = {}, {}
        for mid in 'xyz':
            a0 = _allocated()
            z8 = net.serve_scores(x, model=mid)
            alloc8[mid] = _allocated() - a0
            resident8[mid] = fleet.budgeter.resident().get(mid)
        checks['int8_all_fit'] = (fleet.loaded() == ['x', 'y', 'z']
                                  and fleet.evictions == 0)
        int8_report = net.serve_stats()
        net.serve_stop()
        launches = launch_counts()
    finally:
        fwd.close()
    # --------------------------------------------------------------------
    n_fail = len(failures)
    stock_err = {
        'f32': _stock_check('fleet[models] f32', stock.predict_scores,
                            ((x, z32),), failures),
        'int8': _stock_check('fleet[models] int8', PredictEngine(
            stock.trainer, FLEET_BUCKETS, dtype='int8').predict_scores,
            ((x, z8),), failures)}
    checks['stock_scores'] = len(failures) == n_fail
    del stock
    for name, ok in checks.items():
        if not ok:
            failures.append(f'fleet[models]: check {name} failed')
    net.serve_start(buckets=','.join(map(str, FLEET_BUCKETS)))
    per = _per_forward(net.engine)
    net.serve_stop()
    want = _check_forward_launches('fleet[models]', launches, fwd.by_rows,
                                   per, failures)
    return {'budget_bytes': budget, 'model_bytes_f32': one,
            'checks': checks, 'loaded_after_each': order,
            'evictions': evictions,
            'f32': {'resident_bytes': resident, 'allocated_bytes': alloc},
            'int8': {'resident_bytes': resident8,
                     'allocated_bytes': alloc8},
            'after_eviction_bytes': freed,     # z's, against before it
            'f32_report': f32_report.split('\t'),
            'int8_report': int8_report.split('\t'),
            'stock_max_abs_err': stock_err,
            'forwards_by_rows': fwd.by_rows, 'launches': launches,
            'launches_want': want, 'nvidia_smi': nvidia_smi_line()}


FLEET_CLI_IMAGES, FLEET_CLI_BATCH = 64, 32


def _fleet_cli(conf, work, failures):
    """``python -m cxxnet_tpu_torch.main`` (its ``main`` in this
    process) on the AlexNet conf with a ``pred`` section over 64
    synthesized 256 x 256 JPEGs: ``task=pred`` of ``0001.model``, then
    ``task=serve`` of the same model with ``serve.reload=0.05``,
    ``serve.models=b=<dir>`` and ``serve.mem_budget``: the same pred file,
    the fleet line, the registry's and the fleet's stderr lines."""
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.nnet import quantize
    cli = os.path.join(work, 'cli')
    os.makedirs(os.path.join(cli, 'models'))
    os.makedirs(os.path.join(cli, 'b'))
    _synth_images(cli, 'test.lst', FLEET_CLI_IMAGES, SEED + 41)
    text = (conf + f'batch_size = {FLEET_CLI_BATCH}\n'
            'pred = pred.txt\niter = img\n  image_list = "test.lst"\n'
            '  image_root = "img/"\niter = end\n')
    with open(os.path.join(cli, 'AlexNet.conf'), 'w') as f:
        f.write(text)
    net = Net(dev='cuda', cfg=conf)
    for path, seed in (('models/0001.model', SEED),
                       ('b/0001.model', SEED + 1)):
        _publish(os.path.join(cli, path), _model_bytes(net, seed))
    budget = int(1.5 * quantize.tree_nbytes(net.trainer.params))
    del net
    torch.cuda.empty_cache()
    common = ['AlexNet.conf', 'model_in=models/0001.model', 'silent=0']
    rc1, so1, se1, w1 = _cli_in_process(common + ['task=pred',
                                                  'pred=want.txt'], cli)
    rc2, so2, se2, w2 = _cli_in_process(
        common + ['task=serve', 'serve.reload=0.05', 'serve.models=b=b',
                  f'serve.mem_budget={budget}',
                  f'serve.buckets=1,{FLEET_CLI_BATCH}', 'pred=got.txt'], cli)
    out = {'rc': [rc1, rc2], 'seconds': [w1, w2]}
    if rc1 or rc2:
        failures.append('fleet[cli]: exit ' + str([rc1, rc2]) + ': '
                        + '\n'.join(ln for _, ln in (se1 + se2)[-30:]))
        return out
    want = open(os.path.join(cli, 'want.txt')).read()
    got = open(os.path.join(cli, 'got.txt')).read()
    fleet_line = [ln for _, ln in so2 if ln.startswith('serve: fleet of')]
    err_lines = [ln for _, ln in se2 if ln.startswith('[serve]')]
    checks = {
        'pred_equal': got == want and len(want.splitlines())
        == FLEET_CLI_IMAGES,
        'fleet_line': fleet_line == [f'serve: fleet of 1 models, 1 '
                                     f'resident under {budget} bytes'],
        'registry_line': any(ln.startswith('[serve]\tregistry-')
                             for ln in err_lines),
        'fleet_report': any(ln.startswith('[serve]\tfleet-')
                            for ln in err_lines)}
    for name, ok in checks.items():
        if not ok:
            failures.append(f'fleet[cli]: check {name} failed')
    out.update(checks=checks, fleet_line=fleet_line, stderr=err_lines,
               cmd='python -m cxxnet_tpu_torch.main ' + ' '.join(
                   common + ['task=serve', 'serve.reload=0.05',
                             'serve.models=b=b',
                             f'serve.mem_budget={budget}']))
    return out


def _fleet_lm_reload(work, failures):
    """The decode phase's LM at its width (``FLEET_LM_STAGES`` blocks):
    a ``ModelRegistry(pattern=LM_PATTERN, loader=lm_loader)`` swaps
    ``0002.lm`` in while a stream decodes; the stream finishes bitwise
    ``generate`` on 0001, the next bitwise ``generate`` on 0002; the paged
    decode kernel launches once a block a decode step."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve import (LM_PATTERN, DecodeEngine,
                                        ModelRegistry, lm_loader,
                                        save_lm_params)
    cfg = T.TransformerConfig(**dict(LM, num_stages=FLEET_LM_STAGES))
    lmdir = os.path.join(work, 'lm')
    os.makedirs(lmdir)
    pa = T.init_params(np.random.RandomState(SEED + 61), cfg)
    pb = T.init_params(np.random.RandomState(SEED + 62), cfg)
    t0 = time.perf_counter()
    save_lm_params(os.path.join(lmdir, '0001.lm'), pa)
    save_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.RandomState(SEED + 63)
    p1, p2 = (rng.randint(0, LM['vocab_size'], (1, n)).astype(np.int32)
              for n in (37, 21))
    with torch.inference_mode():
        eng = DecodeEngine(pa, cfg, **dict(DECODE, slots=4),
                           flash_decode='auto', device='cuda')
    reg = ModelRegistry(eng, lmdir, current=1, pattern=LM_PATTERN,
                        loader=lm_loader)
    old = eng.params
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    r1 = eng.submit_direct(p1, max_new=FLEET_LM_NEW)
    save_lm_params(os.path.join(lmdir, '0002.lm'), pb)
    t0 = time.perf_counter()
    swapped = reg.poll_once()
    reload_s = time.perf_counter() - t0
    r2 = eng.submit_direct(p2, max_new=FLEET_LM_NEW)
    for r in (r1, r2):
        r.event.wait(600)
    launches = launch_counts()
    steps = int(eng.stats.get('decode_steps'))
    # --------------------------------------------------------------------
    new = eng.params
    want1 = T.generate(old, p1, FLEET_LM_NEW, cfg, flash=eng.use_flash)[0]
    want2 = T.generate(new, p2, FLEET_LM_NEW, cfg, flash=eng.use_flash)[0]
    eng.close(60)
    checks = {'swapped': swapped and reg.current == 2 and eng.version == 2,
              'stream_1_on_0001': r1.error is None
              and np.array_equal(r1.result, want1[:len(r1.result)]),
              'stream_2_on_0002': r2.error is None
              and np.array_equal(r2.result, want2[:len(r2.result)]),
              'kernel_leg': eng.use_flash}
    for name, ok in checks.items():
        if not ok:
            failures.append(f'fleet[lm_reload]: check {name} failed')
    _check_launches('fleet[lm_reload]', launches,
                    {'paged_flash_decode': cfg.num_stages * steps}, failures)
    return {'stages': FLEET_LM_STAGES, 'checks': checks,
            'transitions': reg.states(), 'reload_s': reload_s,
            'timings_ms': {k[:-2]: v * 1e3
                           for k, v in reg.last_timings.items()},
            'save_lm_ms': save_ms,
            'lm_file_bytes': os.path.getsize(os.path.join(lmdir,
                                                          '0001.lm')),
            'decode_steps': steps, 'launches': launches}


def fleet_phase(failures):
    """The serving extensions on the full-width AlexNet
    (``cxxnet_tpu_torch/example/ImageNet.conf``, f32, ``auto``): the
    reload, replicas, models and cli legs, then the LM reload leg."""
    conf = _example_conf('ImageNet.conf')
    pool = _fleet_pool()
    out = {'phase': 'fleet', 'nvidia_smi': nvidia_smi_line()}
    try:
        _fleet_legs(out, conf, pool, failures)
    finally:
        _FLEET_BLOBS.clear()
    return out


def _fleet_legs(out, conf, pool, failures):
    """The body of :func:`fleet_phase` in its temporary directory; fills
    ``out``."""
    with tempfile.TemporaryDirectory() as work:
        t = time.perf_counter()
        out['reload'], net = _fleet_reload(conf, work, pool, failures)
        out['reload']['leg_s'] = time.perf_counter() - t
        t = time.perf_counter()
        out['replicas'] = _fleet_replicas(conf, net, pool, failures)
        out['replicas']['leg_s'] = time.perf_counter() - t
        del net
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out['models'] = _fleet_models(conf, work, pool, failures)
        out['models']['leg_s'] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out['cli'] = _fleet_cli(conf, work, failures)
        out['cli']['leg_s'] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out['lm_reload'] = _fleet_lm_reload(work, failures)
        out['lm_reload']['leg_s'] = time.perf_counter() - t


# --- the conv lowerings, micro_batch and extra data (queue A item 2) ---------

# the lowering phase's cell: AlexNet as the reference conf is written
# (bf16, use_pallas=1, dropout 0.5, batch 256), seeded synthetic batches;
# every leg also in f32 (use_pallas=1)
LOWERING_STEPS, LOWERING_SPLIT = 3, 4
LOWERING_MODES = ('native', 'im2col', 's2d', 'split')
# row-1 launches a step under each lowering, as JAX's pairing gives them
# (tests/test_torch_conv_lowering.py holds them against it): im2col
# leaves the grouped conv2, conv4, conv5 on the kernel, split the
# ungrouped conv1 and conv3, s2d the stride-1 conv2-conv5; a
# microbatched conv never pairs
LOWERING_PAIRS = {'native': 5, 'im2col': 3, 's2d': 4, 'split': 2}
# the routes a conv takes off the fused kernel in this phase's legs:
# 'native' is F.conv2d under autograd (cuDNN), the micro_batch twin's
LOWERING_ROUTES = {'conv1': ('native', 'im2col', 's2d', 'micro_batch'),
                   'conv2': ('native', 'split', 'micro_batch'),
                   'conv3': ('native', 'im2col', 'micro_batch'),
                   'conv4': ('native', 'split', 'micro_batch'),
                   'conv5': ('native', 'split', 'micro_batch')}
# an f32 route against float64 on the same inputs, max |err| / max |ref|
# for y, dx and dw: f32 sums of up to 186624 terms (conv2's dw),
# tests/test_torch_cuda.py's bound for the fused block's backward
F64_TOL = 1e-5
# the cell's net params a dtype
LOWERING_BASE = {'bf16': WINDOW_PAIRS, 'f32': (('use_pallas', '1'),)}
# the attach leg: a side vector per image, joined to fc7's output
ATTACH = dict(images=256, width=64, steps=3, seed=20261025)


def _conv_route(route, geo):
    """``fn(x, w) -> y`` of one route at a conv's geometry ``(strides,
    pad, groups)``, as the conv layer runs it."""
    from cxxnet_tpu_torch.layers.conv import (
        MICRO_BATCHED, conv_im2col, conv_native, conv_s2d, conv_split)
    from cxxnet_tpu_torch.ops.microbatch import microbatched_conv
    strides, pad, groups = geo
    if route == 'micro_batch':
        return lambda x, w: microbatched_conv(
            x, w, strides, pad, groups, LOWERING_SPLIT,
            *MICRO_BATCHED['native'])
    return {'native': lambda x, w: conv_native(x, w, strides, pad, groups),
            'im2col': lambda x, w: conv_im2col(x, w, strides, pad),
            's2d': lambda x, w: conv_s2d(x, w, strides, pad),
            'split': lambda x, w: conv_split(x, w, strides, pad, groups)
            }[route]


def _conv_grads(fn, x, w, g, need_dx):
    """``(y, dx or None, dw)`` of ``fn`` under autograd, as the step
    computes them (conv1's input takes no gradient)."""
    xt = x.detach().requires_grad_(need_dx)
    wt = w.detach().requires_grad_(True)
    y = fn(xt, wt)
    grads = torch.autograd.grad(y, (xt, wt) if need_dx else (wt,), g)
    return (y.detach(),) + ((grads[0], grads[1]) if need_dx
                            else (None, grads[0]))


def _conv_checks(dev, failures):
    """Each AlexNet conv (batch 256) through each route its lowering legs
    send it, f32 and bf16: y, dx and dw against float64 on the same
    inputs (f32 within ``F64_TOL``, bf16 within one bf16 step), the
    microbatched route against the unsplit one bit for bit, the device
    ms of a forward and backward by CUDA events and the transient peak
    bytes above the inputs."""
    out = {}
    for name, xs, kh, kw, cin_g, cout, stride, pad, groups in CONV_SHAPES:
        geo = ((stride, stride), ((pad, pad), (pad, pad)), groups)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(xs, device=dev, generator=gen)
        if name != 'conv1':
            x = torch.relu(x)
        w = torch.randn((kh, kw, cin_g, cout), device=dev,
                        generator=gen) * 0.05
        oy = (xs[1] + 2 * pad - kh) // stride + 1
        g = torch.randn((xs[0], oy, oy, cout), device=dev, generator=gen)
        need_dx = name != 'conv1'
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = 'f32' if dtype == torch.float32 else 'bf16'
            xd, wd, gd = x.to(dtype), w.to(dtype), g.to(dtype)
            with torch.backends.cudnn.flags(enabled=True):
                ref = _conv_grads(_conv_route('native', geo), xd.double(),
                                  wd.double(), gd.double(), need_dx)
            native = None
            for route in LOWERING_ROUTES[name]:
                fn = _conv_route(route, geo)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = _conv_grads(fn, xd, wd, gd, need_dx)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                r = {'ms': time_ms(lambda: _conv_grads(fn, xd, wd, gd,
                                                       need_dx), 5),
                     'transient_peak_bytes': peak}
                for part, a, b in zip(('y', 'dx', 'dw'), got, ref):
                    if a is None:
                        continue
                    if dtype == torch.float32:
                        err = rel_err(a, b)[1]
                        r[f'{part}_err_vs_f64'] = err
                        if not err <= F64_TOL:
                            failures.append(
                                f'lowering[conv {name} {route} {tag}]: '
                                f'{part} {err} of its largest value from '
                                f'float64 > {F64_TOL}')
                    else:
                        ex = step16_excess(a, b)
                        r[f'{part}_bf16_steps_vs_f64'] = ex
                        if not ex <= 1.0:
                            failures.append(
                                f'lowering[conv {name} {route} {tag}]: '
                                f'{part} {ex} bf16 steps from float64')
                if route in ('native', 'micro_batch'):
                    # the library's own determinism: the same call again
                    again = _conv_grads(fn, xd, wd, gd, need_dx)
                    r['repeat_bitwise'] = all(
                        a is None or torch.equal(a, b)
                        for a, b in zip(again, got))
                    del again
                if route == 'native':
                    native = got
                elif route == 'micro_batch':
                    diffs = [0.0 if a is None else
                             (a.float() - b.float()).abs().max().item()
                             for a, b in zip(got, native)]
                    r['bitwise_vs_native'] = all(
                        a is None or torch.equal(a, b)
                        for a, b in zip(got, native))
                    r['max_abs_diff_vs_native'] = dict(zip(('y', 'dx', 'dw'),
                                                           diffs))
                res[f'{route}_{tag}'] = r
                del got
            del ref, native
            torch.cuda.empty_cache()
        for tag in ('f32', 'bf16'):
            for route in LOWERING_ROUTES[name]:
                res[f'{route}_{tag}']['ms_over_native'] = \
                    res[f'{route}_{tag}']['ms'] / res[f'native_{tag}']['ms']
        out[name] = res
        del x, w, g
        torch.cuda.empty_cache()
    return out


def _lowering_leg(make, batches, pairs, want, tag, failures,
                  decisions=None, steps=LOWERING_STEPS):
    """``steps`` updates of a fresh net (``pairs`` on top of the cell),
    launches exact a step, the first under ``decisions`` (recorded or
    replayed, ``layers.Decisions``); the first step's weight change
    (SGD's momentum slot, as :func:`_step_change` reads it), the weights
    after, the step ms, the losses, the peak bytes (reset before the net
    is built; also above what the earlier legs left allocated) and the
    counts of the main-path run."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    net = make(*pairs)
    net.trainer.decisions = decisions
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    first = _train_steps(net, batches, 1, want, tag, failures)
    change = {(k, f): v.detach().clone()
              for k, fs in net.trainer.opt_state['m'].items()
              for f, v in fs.items()}
    net.trainer.decisions = None
    rest = _train_steps(net, batches[1:], steps - 1, want, tag, failures)
    launches = launch_counts()
    # --------------------------------------------------------------------
    torch.cuda.synchronize()
    step_ms = first['step_ms'] + rest['step_ms']
    out = {'net_params': dict(pairs), 'step_ms': step_ms,
           'step_ms_p50': float(np.median(step_ms)),
           'loss': first['loss'] + rest['loss'],
           'max_memory_allocated': torch.cuda.max_memory_allocated(),
           'peak_bytes_above_start':
               torch.cuda.max_memory_allocated() - start,
           'launches': launches,
           'launches_per_step': (first['per_step'] + rest['per_step'])[-1],
           'launches_per_step_want': want}
    w = _weights(net)
    del net
    torch.cuda.empty_cache()
    return out, change, w


def _change_against(tag, got, ref, failures):
    """Per weight, max |got - ref| / max |ref| of two first-step weight
    changes, which must stay within ``STOCK_TOL``; the worst."""
    rel = {'/'.join(key): ((got[key] - d).abs().max()
                           / d.abs().max().clamp_min(1e-30)).item()
           for key, d in ref.items()}
    worst = max(rel.values())
    if not worst <= STOCK_TOL:
        failures.append(f'{tag}: first-step weight change {worst} of its '
                        f'largest value from native > {STOCK_TOL}')
    return {'worst': worst, 'tol': STOCK_TOL, 'rel_dw_err': rel}


def _attach_alexnet(root, make_conf, failures):
    """The AlexNet-width attach leg: ``ATTACH['images']`` synthesized
    256 x 256 JPEGs packed by ``im2bin``, each with a seeded
    ``1 x 1 x ATTACH['width']`` side vector in a text file, through the
    ``imgbin`` + ``attachtxt`` chain into AlexNet with the side vector
    joined to fc7's output by ``concat`` before fc8 (bf16,
    ``use_pallas=1``), ``ATTACH['steps']`` steps with exact launches."""
    from cxxnet_tpu_torch import Net
    from cxxnet_tpu_torch.io import im2bin
    from cxxnet_tpu_torch.io.data import create_iterator
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    n, width = ATTACH['images'], ATTACH['width']
    t0 = time.perf_counter()
    _synth_images(root, 'attach.lst', n, ATTACH['seed'])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        rc = im2bin.main(['attach.lst', 'img', 'attach.bin'])
    finally:
        os.chdir(cwd)
    if rc != 0:
        failures.append(f'lowering[attach]: im2bin exit {rc}')
    side = np.random.RandomState(ATTACH['seed']).rand(n, width)
    np.savetxt(os.path.join(root, 'side.txt'), side, fmt='%.6f')
    dataset_s = time.perf_counter() - t0
    it = create_iterator([
        ('iter', 'imgbin'), ('image_list', os.path.join(root, 'attach.lst')),
        ('image_bin', os.path.join(root, 'attach.bin')),
        ('image_mean', os.path.join(root, 'mean.bin')),
        ('rand_crop', '1'), ('rand_mirror', '1'),
        ('iter', 'attachtxt'), ('attach_file', os.path.join(root,
                                                            'side.txt')),
        ('iter', 'end')])
    for name, val in (('input_shape', '3,227,227'),
                      ('batch_size', str(BATCH)), ('silent', '1')):
        it.set_param(name, val)
    it.init()
    net = Net(dev='cuda', cfg=make_conf())
    for k, v in (('seed', str(SEED)),) + WINDOW_PAIRS:
        net.set_param(k, v)
    net.init_model()
    tr = net.trainer
    fc8 = str(tr.net_cfg.get_layer_index('fc8'))
    w0 = tr.params[fc8]['wmat'].detach().float().clone()
    want = as16(STEP_LAUNCHES['on'])
    losses, per_step, step_ms = [], [], []
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    while len(losses) < ATTACH['steps']:
        for batch in it:
            before = launch_counts()
            t1 = time.perf_counter()
            net.update(batch)
            losses.append(float(tr.last_loss))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            after = launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            if len(losses) == ATTACH['steps']:
                break
    launches = launch_counts()
    # --------------------------------------------------------------------
    it.close(10.0)
    w = tr.params[fc8]['wmat'].detach().float()
    side_rows = (w[4096:] - w0[4096:]).abs().max().item()
    del net, tr
    torch.cuda.empty_cache()
    if len(losses) != ATTACH['steps'] or not np.isfinite(losses).all():
        failures.append(f'lowering[attach]: losses {losses}')
    for i, per in enumerate(per_step):
        if per != want:
            failures.append(f'lowering[attach]: step {i} launched {per}, '
                            f'want {want}')
    if not side_rows > 0.0:
        failures.append('lowering[attach]: fc8\'s side-vector rows did not '
                        'move')
    return {'images': n, 'width': width, 'dataset_s': dataset_s,
            'dtype': 'bfloat16', 'net_params': dict(WINDOW_PAIRS),
            'steps': len(losses), 'loss': losses, 'step_ms': step_ms,
            'fc8_side_rows_max_change': side_rows, 'launches': launches,
            'launches_per_step': per_step[-1] if per_step else None}


# JAX's attach conf (tests/test_e2e_cli.py:406-456), on the card
ATTACH_CLI_CONF = """
data = train
iter = img
  image_list = a.lst
  image_root = ./
iter = attachtxt
  attach_file = attach.txt
iter = end
eval = trainset
iter = img
  image_list = a.lst
  image_root = ./
iter = attachtxt
  attach_file = attach.txt
iter = end
extra_data_num = 1
extra_data_shape[0] = 1,1,6
netconfig = start
layer[in_1->2] = fullc:fx
  nhidden = 4
layer[2->2] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 5
dev = cuda
eta = 0.5
momentum = 0.9
num_round = 30
metric = error
silent = 1
"""


def _attach_cli(root, failures):
    """JAX's attach conf through the port's CLI (``main`` in this
    process) on the card: 15 noise images whose labels are a function of
    the attached vector only; the last round's train error must be 0."""
    from PIL import Image
    work = os.path.join(root, 'cli')
    os.makedirs(work)
    rng = np.random.RandomState(11)
    lines, rows = [], []
    for i in range(15):
        c = rng.randint(0, 4)
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
            os.path.join(work, f'x{i}.png'))
        vec = rng.rand(6) * 0.1
        vec[c] += 2.0
        rows.append(' '.join(f'{v:.5f}' for v in vec))
        lines.append(f'{i}\t{c}\tx{i}.png')
    for fname, text in (('a.lst', lines), ('attach.txt', rows)):
        with open(os.path.join(work, fname), 'w') as f:
            f.write('\n'.join(text) + '\n')
    with open(os.path.join(work, 'extra.conf'), 'w') as f:
        f.write(ATTACH_CLI_CONF)
    rc, _, err, wall = _cli_in_process(['extra.conf'], work)
    errors = [float(m) for _, ln in err
              for m in re.findall(r'trainset-error:([0-9.eE+-]+)', ln)]
    if rc != 0 or not errors or errors[-1] != 0.0:
        failures.append(f'lowering[attach_cli]: exit {rc}, train errors '
                        f'{errors[-3:]}: '
                        + '\n'.join(ln for _, ln in err[-20:]))
    return {'rc': rc, 'seconds': wall, 'rounds': len(errors),
            'trainset_error_first_last': errors[:1] + errors[-1:]}


def lowering_phase(failures):
    """``conv_lowering``, ``micro_batch`` and ``extra_data_num`` with
    ``attachtxt`` (queue A item 2) at AlexNet's full width: each conv
    through each route against float64 and timed (:func:`_conv_checks`);
    three steps at each lowering in bf16 and f32, launches exact; at
    ``fuse = 0`` (every relu a layer of its own) ``micro_batch`` 1 and
    ``LOWERING_SPLIT`` in both dtypes, bitwise or the largest parameter
    difference, peak bytes and step ms each, and each lowering's first
    step, its weight change against a native step's under that step's
    replayed relu and max-pool choices (f32 within ``STOCK_TOL``, bf16 by
    the rule); the attach legs."""
    tag = 'lowering'
    dev = torch.device('cuda', 0)
    conf = _example_conf('ImageNet.conf', 'ImageNet_train.conf')
    make = _net_maker(conf, ('batch_size', str(BATCH)))
    batches = _synthetic_batches(BATCH, 227)
    out = {'phase': 'lowering', 'nvidia_smi': nvidia_smi_line(),
           'conf': 'ImageNet.conf + ImageNet_train.conf', 'batch': BATCH,
           'steps': LOWERING_STEPS, 'split': LOWERING_SPLIT}
    t = time.perf_counter()
    from cxxnet_tpu_torch.ops.precision import full_f32
    with full_f32():
        out['convs'] = _conv_checks(dev, failures)
    out['convs_s'] = time.perf_counter() - t

    # ---- the lowerings at the cell's fusion: launches exact ------------
    t = time.perf_counter()
    legs = {}
    for dtype, base in LOWERING_BASE.items():
        for mode in LOWERING_MODES:
            want = dict(STEP_LAUNCHES['on'],
                        conv_bias_act=LOWERING_PAIRS[mode])
            if dtype == 'bf16':
                want = as16(want)
            key = f'{dtype}_{mode}'
            legs[key] = _lowering_leg(
                make, batches, base + (('conv_lowering', mode),), want,
                f'{tag}[{key}]', failures)[0]
    out['lowerings'] = {'legs': legs, 'seconds': time.perf_counter() - t}

    # ---- fuse = 0: micro_batch split against unsplit, bit for bit and
    # in peak bytes; each lowering's first step against native's under
    # the native step's replayed relu and max-pool choices (every relu a
    # layer of its own, so a near tie falls alike in all legs; the
    # recorded inputs stay allocated, so no micro_batch leg records) -----
    from cxxnet_tpu_torch.layers import Decisions
    t = time.perf_counter()
    mb, diffs, acc, changes = {}, {}, {}, {}
    for dtype, base in LOWERING_BASE.items():
        want = dict(STEP_LAUNCHES['on'], conv_bias_act=0)
        if dtype == 'bf16':
            want = as16(want)
        base = base + (('fuse', '0'),)
        runs = {}
        for split in (1, LOWERING_SPLIT):
            key = f'{dtype}_{split}'
            mb[key], _, runs[split] = _lowering_leg(
                make, batches, base + (('micro_batch', str(split)),),
                want, f'{tag}[micro_batch {key}]', failures)
        a, b = runs[1], runs[LOWERING_SPLIT]
        diffs[dtype] = {
            'bitwise': all(torch.equal(a[k], b[k]) for k in a),
            'max_abs_diff': max((a[k].float() - b[k].float()).abs().max()
                                .item() for k in a),
            'params_differing': ['/'.join(k) for k in a
                                 if not torch.equal(a[k], b[k])]}
        del runs, a, b
        decisions = Decisions()
        for mode in LOWERING_MODES:
            key = f'{dtype}_{mode}'
            acc[key], changes[key], _ = _lowering_leg(
                make, batches, base + (('conv_lowering', mode),), want,
                f'{tag}[fuse=0 {key}]', failures, decisions, steps=1)
            decisions.replay = True
        del decisions
    checks = {}
    for mode in LOWERING_MODES[1:]:
        checks[f'f32_{mode}'] = _change_against(
            f'{tag}[f32_{mode}]', changes[f'f32_{mode}'],
            changes['f32_native'], failures)
        checks[f'bf16_{mode}'] = _bf16_rule(
            f'{tag}[bf16_{mode}]', changes[f'bf16_{mode}'],
            changes['bf16_native'], changes['f32_native'], failures)
    del changes
    out['micro_batch'] = {'legs': mb, 'split_vs_unsplit': diffs}
    out['first_step'] = {'legs': acc, 'checks': checks}
    out['fuse0_seconds'] = time.perf_counter() - t

    # ---- extra data: the attach legs ------------------------------------
    t = time.perf_counter()

    def attach_conf():
        fc8 = 'layer[15->16] = fullc:fc8'
        if fc8 not in conf:
            raise ValueError(f'the AlexNet conf has no {fc8!r} line')
        text = conf.replace(fc8, 'layer[15,in_1->side] = concat\n'
                                 'layer[side->16] = fullc:fc8')
        return (f'extra_data_num = 1\nextra_data_shape[0] = 1,1,'
                f'{ATTACH["width"]}\n' + text)
    with tempfile.TemporaryDirectory() as root:
        out['attach'] = _attach_alexnet(root, attach_conf, failures)
        out['attach_cli'] = _attach_cli(root, failures)
    out['attach']['leg_s'] = time.perf_counter() - t
    return out


# --- the decode path ----------------------------------------------------------

# the GPT-2-small-class decoder of bench.py's transformer cells, f32
LM = dict(vocab_size=32768, d_model=1024, num_heads=16, d_ff=4096,
          num_stages=8, attn='local')
DECODE = dict(slots=16, pages=257, page_size=16, max_prompt=128,
              max_new_bound=128)
DECODE_REQUESTS, DECODE_CLIENTS, DECODE_SAMPLED = 48, 4, (5, 17, 29, 41)
GATHER_REQUESTS = 8
SPEC_K, SPEC_REQUESTS, SPEC_MAX_NEW = 4, 16, 64
# the quant phase: the bf16 leg's and the int8 spec leg's request counts,
# the prompts of the logit comparison, and int8_matmul launches per stage
# of one block walk (wq wk wv wo w1 w2; the head adds one per walk)
QUANT_BF16_REQUESTS, QUANT_SPEC_REQUESTS, QUANT_LOGIT_PROMPTS = 16, 8, 4
INT8_PER_STAGE = 6


def paged_kernel_checks(dev, peaks, failures):
    """The paged attention kernels at the decode path's shapes: 16 slots,
    16 heads of 64, 16 pages of 16 positions per slot over a shuffled
    pool of 257 pages; per-slot positions over 0-255 (page boundaries
    and the last position among them) and pad widths over 0-7; slot 0
    idle on scratch page 0; verify at K = 4; the f32 builds, then the
    bf16 builds on the same pool rounded to bf16.  The library call is
    the page gather plus ``F.scaled_dot_product_attention`` over the dense
    (S, H, T, hd) cache with the live mask, timed apart."""
    S, H, hd, ps, pp, P = 16, 16, 64, 16, 16, 257
    T = ps * pp
    rng = np.random.RandomState(SEED)
    pool = [torch.from_numpy(rng.randn(P, ps, H, hd).astype(np.float32)
                             ).to(dev) for _ in range(2)]
    table = rng.permutation(np.arange(1, P)).reshape(S, pp).astype(np.int32)
    pos = rng.randint(0, T, S).astype(np.int32)
    pos[1:6] = (15, 16, 31, 32, T - 1)
    w = np.minimum(rng.randint(0, 8, S), pos).astype(np.int32)
    table[0], pos[0], w[0] = 0, 0, 0
    scale = 1.0 / np.sqrt(hd)
    floor = _empty_launch_floor(S, H)
    rows = []
    for dtype, sfx in ((torch.float32, ''), (torch.bfloat16, '_bf16')):
        pools = [t.to(dtype) for t in pool]
        for base, K in (('paged_flash_decode', 1), ('paged_flash_verify', 4)):
            rows.append(_paged_check(
                base + sfx, K, rng, pools, table, pos, w, scale, dev, peaks,
                failures))
            rows[-1].update(floor)
    return rows


def _empty_launch_floor(S, H):
    """An empty kernel on the decode kernel's (H, S) grid of 256 threads,
    launched through the same ctypes binding: back to back by CUDA events
    (``empty_launch_ms``, the host's launch rate) and from a CUDA graph
    (``empty_graph_ms``, the device's), the floor no paged kernel can
    pass."""
    from cxxnet_tpu_torch.ops import build
    fn = build.entry('paged_empty')

    def launch():
        build.check_launch(
            fn(S, H, torch.cuda.current_stream().cuda_stream), 'paged_empty')
    return {'empty_launch_ms': time_ms(launch, 200),
            'empty_graph_ms': graph_ms(launch, 200)}


def _paged_check(name, K, rng, pool, table, pos, w, scale, dev, peaks,
                 failures):
    """One paged kernel (``K`` = 1: decode, else verify) on ``pool``'s
    dtype against its plain version, timed beside the plain version, the
    page gather + SDPA and the bound."""
    from cxxnet_tpu_torch.ops.attention import (
        gather_pages, live_mask, paged_flash_decode,
        paged_flash_decode_plain, paged_flash_verify,
        paged_flash_verify_plain)
    S, pp = table.shape
    P, ps, H, hd = pool[0].shape
    T = ps * pp
    p = np.minimum(pos, T - K).astype(np.int32)
    if K > 1:
        p[0] = 0
    tab_t, pos_t, w_t = (torch.from_numpy(a).to(dev) for a in (table, p, w))
    q = torch.from_numpy(rng.randn(S, K, H, hd).astype(np.float32)).to(
        dev, pool[0].dtype)
    qk = q[:, 0].contiguous() if K == 1 else q
    kern = paged_flash_decode if K == 1 else paged_flash_verify
    plain = paged_flash_decode_plain if K == 1 else paged_flash_verify_plain
    args = (qk, pool[0], pool[1], tab_t, pos_t, w_t, scale)
    with torch.inference_mode():
        out = kern(*args)
        repeat = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        mask = live_mask(T, pos_t.long(), w_t.long(), K)  # (S,1,K,T)

        def gather():
            return (gather_pages(pool[0], tab_t).transpose(1, 2),
                    gather_pages(pool[1], tab_t).transpose(1, 2))
        kd, vd = gather()
        qd = q.transpose(1, 2)                            # (S,H,K,hd)

        def sdpa():
            return F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, scale=scale)
        lib_out = sdpa().transpose(1, 2)
        lib_out = lib_out[:, 0] if K == 1 else lib_out
        ms = time_ms(lambda: kern(*args), 200)
        g_ms = graph_ms(lambda: kern(*args), 200)
        plain_ms = time_ms(lambda: plain(*args), 20)
        gather_ms = time_ms(gather, 50)
        sdpa_ms = time_ms(sdpa, 50)
    live_rows = int((p + K - 1 - w + 1).sum())
    esz = q.element_size()
    nbytes = (esz * (2 * live_rows * H * hd + 2 * q.numel())
              + 4.0 * (table.size + 2 * S))
    # per live row, head and query: the 2 hd flops of the score, the
    # max, exp, sum and divide, and the 2 hd of the weighted sum (f32
    # arithmetic in both builds)
    flops = float(sum((pi + k - wi + 1) for pi, wi in zip(p, w)
                      for k in range(K))) * H * (4.0 * hd + 4)
    err, rel = rel_err(out, ref)
    b_ms, b_by = bound(flops, nbytes, peaks)
    if not (rel <= TOL[name]) or not torch.isfinite(out).all():
        failures.append(f'{name}: max rel err {rel} > {TOL[name]}')
    bitwise_repeat = torch.equal(repeat, out)
    if not bitwise_repeat:
        failures.append(f'{name}: two launches differ')
    return {'kernel': name, 'shape': f'S{S}xK{K}xH{H}xhd{hd}',
            'dtype': str(q.dtype).split('.')[-1],
            'max_abs_err': err, 'max_rel_err': rel, 'tol_rel': TOL[name],
            'bitwise_repeat': bitwise_repeat,
            'library_max_abs_err': rel_err(lib_out, ref)[0],
            'kernel_ms': ms, 'graph_ms': g_ms, 'plain_ms': plain_ms,
            'library_ms': gather_ms + sdpa_ms, 'library_gather_ms': gather_ms,
            'library_sdpa_ms': sdpa_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'flops': flops, 'bytes': nbytes, 'live_rows': live_rows}


# the int8 GEMM's shapes on the quantized decode path: (name, m, k, n) —
# a decode step or verify window (64 padded rows) through wq/wk/wv/wo,
# w1, w2 and the head, and prefill at the largest and smallest prompt
# bucket and the prefill's one-row head
INT8_SHAPES = [('decode_qkvo', 64, 1024, 1024), ('decode_w1', 64, 1024, 4096),
               ('decode_w2', 64, 4096, 1024),
               ('decode_head', 64, 1024, 32768),
               ('prefill128_qkvo', 128, 1024, 1024),
               ('prefill8_w2', 8, 4096, 1024),
               ('prefill_head_m1', 1, 1024, 32768)]
# launches of each decode-step shape per step (8 stages): 4 projections,
# w1 and w2 per stage, the head once
INT8_STEP_USES = {'decode_qkvo': 32, 'decode_w1': 8, 'decode_w2': 8,
                  'decode_head': 1}


def int8_kernel_checks(dev, peaks, failures):
    """``int8_matmul`` at the quantized decode path's shapes against its
    plain version (bitwise), timed beside the plain version,
    ``torch._int_mm`` where its shape rules allow (more than 16 rows, k
    and n multiples of 8) and the bound: the bytes (each operand read
    once, the int32 result written once) over the memory rate against
    2 m n k operations over the int8 tensor-core rate."""
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.kernels import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = []
    for name, m, k, n in INT8_SHAPES:
        a = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), device=dev, generator=gen,
                          dtype=torch.int8)
        lib = m > 16 and k % 8 == 0 and n % 8 == 0
        with torch.inference_mode():
            out = int8_matmul(a, b)
            repeat = int8_matmul(a, b)
            torch.cuda.synchronize()
            ref = int8_matmul_plain(a, b)
            lib_out = torch._int_mm(a, b) if lib else None
            ms = time_ms(lambda: int8_matmul(a, b), 50)
            g_ms = graph_ms(lambda: int8_matmul(a, b), 50)
            plain_ms = time_ms(lambda: int8_matmul_plain(a, b), 10)
            lib_ms = time_ms(lambda: torch._int_mm(a, b), 50) if lib \
                else None
        ops = 2.0 * m * n * k
        nbytes = float(m * k + k * n + 4 * m * n)
        b_ms, b_by = bound(ops, nbytes, peaks, peaks[2])
        equal = torch.equal(out, ref)
        if not equal:
            failures.append(f'int8_matmul[{name}]: differs from its plain '
                            'version')
        bitwise_repeat = torch.equal(repeat, out)
        if not bitwise_repeat:
            failures.append(f'int8_matmul[{name}]: two launches differ')
        rows.append({'kernel': 'int8_matmul', 'shape': f'{name} {m}x{k}x{n}',
                     'max_abs_err': float((out - ref).abs().max().item()),
                     'max_rel_err': 0.0 if equal else float('inf'),
                     'tol_rel': TOL['int8_matmul'], 'bitwise_equal': equal,
                     'bitwise_repeat': bitwise_repeat,
                     'splits': build.entry('int8_gemm_splits')(m, n, k),
                     'library_max_abs_err': float(
                         (lib_out - ref).abs().max().item()) if lib else None,
                     'kernel_ms': ms, 'graph_ms': g_ms, 'plain_ms': plain_ms,
                     'library_ms': lib_ms, 'bound_ms': b_ms,
                     'bound_by': b_by, 'flops': ops, 'bytes': nbytes})
        del a, b, out, repeat, ref, lib_out
    return rows


def _lm_params():
    from cxxnet_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(**LM)
    return T.init_params(np.random.RandomState(SEED), cfg,
                         device='cuda'), cfg


def _divergence(params, cfg, prompt, got, want):
    """Where ``got`` leaves ``want`` and the oracle's top-2 logit margin
    there (from a prefill over the prompt and the agreed prefix), so a
    near-tie can be told apart from a bug."""
    from cxxnet_tpu_torch.models import transformer as T
    n = min(len(got), len(want))
    j = next(i for i in range(n) if got[i] != want[i])
    toks = np.concatenate([prompt[0], want[:j]])[None].astype(np.int32)
    s0b = T._size_class(toks.shape[1], floor=8)
    pad = np.pad(toks, ((0, 0), (s0b - toks.shape[1], 0)))
    with torch.inference_mode():
        logits = T.prefill_kv(params, torch.from_numpy(pad).cuda(),
                              s0b - toks.shape[1], cfg)[2][0]
    top = torch.topk(logits, 2).values
    return {'position': j, 'got': int(got[j]), 'want': int(want[j]),
            'top2_margin': float(top[0] - top[1])}


def _drive(svc, prompts, max_news, temps, seeds, clients, gap_s):
    """Submit every request from ``clients`` threads (request i from
    thread i % clients, ``gap_s`` apart) and wait for all; returns the
    requests, errors and the wall seconds."""
    reqs = [None] * len(prompts)
    errors = []

    def client(idx):
        for i in idx:
            try:
                reqs[i] = svc.submit_async(prompts[i], max_news[i],
                                           temps[i], seeds[i],
                                           deadline=300.0)
            except Exception as e:  # noqa: BLE001 — reported
                errors.append(f'submit {i}: {e!r}')
            time.sleep(gap_s)
        for i in idx:
            if reqs[i] is None:
                continue
            try:
                svc.batcher.wait(reqs[i])
            except Exception as e:  # noqa: BLE001 — reported
                errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=client,
                                args=(list(range(j, len(prompts),
                                                 clients)),))
               for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return reqs, errors, time.perf_counter() - t0


def profile_decode(svc, prompts, max_news):
    """Device time of a greedy drive of ``prompts`` (``torch.profiler``,
    every thread's kernels) by kernel family, against the host wall time
    of the window, per decode step."""
    from torch.profiler import ProfilerActivity, profile
    n = len(prompts)
    before = svc.engine.stats.get('decode_steps')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _drive(svc, prompts, max_news, [0.0] * n, [None] * n, 4, 0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = max(1, svc.engine.stats.get('decode_steps') - before)
    fam, top = {}, []
    for e in prof.key_averages():
        if str(getattr(e, 'device_type', '')).split('.')[-1] != 'CUDA':
            continue
        us = float(getattr(e, 'self_device_time_total', 0.0)
                   or getattr(e, 'self_cuda_time_total', 0.0))
        key = _kernel_family(e.key)
        fam[key] = fam.get(key, 0.0) + us / 1e3
        top.append((us / 1e3 / steps, e.key[:80]))
    busy = sum(fam.values())
    return {'requests': n, 'decode_steps': steps,
            'wall_ms_per_step': wall_ms / steps,
            'device_ms_per_step': busy / steps,
            'idle_share': 1.0 - busy / wall_ms if wall_ms else None,
            'by_family_ms_per_step': dict(sorted(
                ((k, v / steps) for k, v in fam.items()),
                key=lambda kv: -kv[1])),
            'top_kernels_ms_per_step': sorted(top, reverse=True)[:12]}


def _decode_traffic():
    """The decode phases' 48 requests: prompt lengths uniform 1-128,
    ``max_new`` uniform 16-128, the ``DECODE_SAMPLED`` ones at
    temperature 0.8 with int seeds."""
    rng = np.random.RandomState(SEED + 1)
    n = DECODE_REQUESTS
    prompts = [rng.randint(0, LM['vocab_size'], (1, int(s)))
               .astype(np.int32) for s in rng.randint(1, 129, n)]
    max_news = [int(v) for v in rng.randint(16, 129, n)]
    temps = [0.8 if i in DECODE_SAMPLED else 0.0 for i in range(n)]
    seeds = [SEED + i if i in DECODE_SAMPLED else None for i in range(n)]
    return prompts, max_news, temps, seeds


def _serve_tier(params, cfg, failures, tag, dtype, n, n_greedy, n_sampled,
                profile):
    """The first ``n`` requests of the decode traffic through a
    ``DecodeService`` at ``serve.dtype=dtype`` (``flash_decode=auto``):
    the launch counts of the run (from 0, read just after), the end-to-end
    metrics, a profiled window when ``profile``, and ``n_greedy`` greedy
    (the longest prompt among them) and ``n_sampled`` sampled streams
    checked bitwise against offline ``generate`` over the engine's own
    tree and config.  Returns ``(row, requests, engine)``."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve.decode import DecodeService
    prompts, max_news, temps, seeds = (x[:n] for x in _decode_traffic())
    torch.cuda.reset_peak_memory_stats()
    svc = DecodeService(params, cfg, **DECODE, max_queue=64,
                        deadline=300.0, flash_decode='auto', dtype=dtype,
                        device='cuda')
    eng = svc.engine
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    reqs, errors, wall = _drive(svc, prompts, max_news, temps, seeds,
                                DECODE_CLIENTS, 0.01)
    launches = launch_counts()
    # --------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    failures.extend(f'{tag}: {e}' for e in errors)
    steps = int(eng.stats.get('decode_steps'))
    report = svc.report(tag)
    occupancy = eng.stats.snapshot()[1].get('step_occupancy', [0.0])
    free_min = int(eng.stats.get('free_pages_min'))
    served = [r for r in reqs if r is not None and r.error is None
              and r.result is not None]
    tokens = sum(len(r.result) for r in served)
    gaps = [1e3 * (b - a) for r in served
            for a, b in zip(r.token_times, r.token_times[1:])]
    ttft = [1e3 * (r.token_times[0] - r.t_submit) for r in served]
    if len(served) != n:
        failures.append(f'{tag}: served {len(served)} of {n} requests')
    for r, m in zip(reqs, max_news):
        if r is not None and r.result is not None and len(r.result) != m:
            failures.append(f'{tag}: a stream of {len(r.result)} tokens '
                            f'for max_new {m}')
    breakdown = (profile_decode(svc, prompts[:16], max_news[:16])
                 if profile else None)
    resident = eng.resident_bytes()
    svc.close(60)
    # ---- stream twins against offline generate --------------------------
    greedy = [i for i in range(n) if temps[i] == 0]
    longest = max(greedy, key=lambda i: prompts[i].shape[1])
    picked = ([longest] + [i for i in greedy if i != longest][:n_greedy - 1]
              + [i for i in range(n) if temps[i] > 0][:n_sampled])
    twins = []
    for i in picked:
        got = reqs[i].result if reqs[i] is not None else None
        if got is None:
            continue
        want = T.generate(eng.params, prompts[i], max_news[i], eng.cfg,
                          temperature=temps[i], rng=seeds[i],
                          flash=eng.use_flash)[0]
        row = {'request': i, 'prompt': prompts[i].shape[1],
               'tokens': len(got), 'sampled': temps[i] > 0,
               'equal': bool(np.array_equal(got, want))}
        if not row['equal']:
            row.update(_divergence(eng.params, eng.cfg, prompts[i], got,
                                   want))
            failures.append(f'{tag}: stream {i} differs from offline '
                            f'generate: {row}')
        twins.append(row)
    if len(twins) != n_greedy + n_sampled:
        failures.append(f'{tag}: {len(twins)} streams twin-checked, want '
                        f'{n_greedy + n_sampled}')
    row = {'phase': tag, 'model': LM, 'engine': DECODE, 'dtype': dtype,
           'requests': n, 'served': len(served),
           'sampled': sum(t > 0 for t in temps), 'clients': DECODE_CLIENTS,
           'prompt_lens': [p.shape[1] for p in prompts],
           'max_new': max_news, 'tokens': tokens, 'drive_s': wall,
           'tokens_per_s': tokens / wall,
           'token_ms_p50': float(np.quantile(gaps, 0.5)),
           'token_ms_p99': float(np.quantile(gaps, 0.99)),
           'ttft_ms_p50': float(np.quantile(ttft, 0.5)),
           'ttft_ms_p99': float(np.quantile(ttft, 0.99)),
           'step_occupancy_p50': float(np.quantile(occupancy, 0.5)),
           'decode_steps': steps, 'free_pages_min': free_min,
           'max_memory_allocated': peak, 'resident_bytes': resident,
           'attention': 'flash' if eng.use_flash else 'gather',
           'launches': launches, 'profile': breakdown, 'twins': twins,
           'stats': report}
    return row, reqs, eng


def _check_launches(tag, launches, want, failures):
    """Every kernel's launches in a run against ``want`` (absent: 0)."""
    for name, cnt in launches.items():
        if cnt != want.get(name, 0):
            failures.append(f'{tag}: {name} launched {cnt} times, want '
                            f'{want.get(name, 0)}')


def decode_phase(params, cfg, failures):
    """Continuous-batching decode of the GPT-2-small-class LM on the card
    (the kernel leg, ``flash_decode=auto``), its stream twins, then the
    gather leg over the first prompts."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve.decode import DecodeService
    row, reqs, eng = _serve_tier(params, cfg, failures, 'decode', 'f32',
                                 DECODE_REQUESTS, 4, 2, True)
    steps = row['decode_steps']
    if steps <= 0:
        failures.append('decode: no decode step ran')
    _check_launches('decode', row['launches'],
                    {'paged_flash_decode': cfg.num_stages * steps}, failures)
    # ---- the gather leg over the first prompts ---------------------------
    prompts, max_news, temps, seeds = _decode_traffic()
    g = GATHER_REQUESTS
    gsvc = DecodeService(params, cfg, **DECODE, max_queue=64,
                         deadline=300.0, flash_decode='0', device='cuda')
    reset_launch_counts()
    greqs, gerrors, gwall = _drive(gsvc, prompts[:g], max_news[:g],
                                   temps[:g], seeds[:g], DECODE_CLIENTS, 0.01)
    glaunches = launch_counts()
    gsteps = int(gsvc.engine.stats.get('decode_steps'))
    gsvc.close(60)
    failures.extend(f'decode[gather]: {e}' for e in gerrors)
    if glaunches['paged_flash_decode'] != 0:
        failures.append(f'decode[gather]: paged_flash_decode launched '
                        f'{glaunches["paged_flash_decode"]} times')
    gather_equal = []
    for i, r in enumerate(greqs):
        ok = (r is not None and r.result is not None
              and reqs[i] is not None
              and np.array_equal(r.result, reqs[i].result))
        gather_equal.append(bool(ok))
        if not ok and r is not None and r.result is not None:
            want = T.generate(eng.params, prompts[i], max_news[i], cfg,
                              temperature=temps[i], rng=seeds[i],
                              flash=True)[0]
            failures.append(f'decode[gather]: stream {i} differs from the '
                            f'kernel leg: {_divergence(eng.params, cfg, prompts[i], r.result, want)}')
    row['gather_leg'] = {'requests': g, 'drive_s': gwall,
                         'decode_steps': gsteps, 'launches': glaunches,
                         'equal_to_kernel_leg': gather_equal}
    return row


def spec_phase(params, cfg, failures, tag='spec', dtype='f32',
               n=SPEC_REQUESTS):
    """Greedy speculative decoding on the card at ``serve.dtype=dtype``:
    the target verifies the draft's K-1 proposals (the draft is the
    target itself) in one window; every stream must equal the target
    decoding alone, the verify kernel launch once per stage per spec
    round and the decode kernel once per stage per plain step."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve.decode import DecodeService
    rng = np.random.RandomState(SEED + 2)
    prompts = [rng.randint(0, LM['vocab_size'], (1, int(s)))
               .astype(np.int32) for s in rng.randint(1, 129, n)]
    svc = DecodeService(params, cfg, **DECODE, max_queue=64,
                        deadline=300.0, flash_decode='auto', dtype=dtype,
                        spec_k=SPEC_K, draft=(params, cfg), device='cuda')
    eng = svc.engine
    sfx = '' if dtype == 'f32' else '_bf16'
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    reqs, errors, wall = _drive(svc, prompts, [SPEC_MAX_NEW] * n,
                                [0.0] * n, [None] * n, DECODE_CLIENTS, 0.0)
    launches = launch_counts()
    # --------------------------------------------------------------------
    failures.extend(f'{tag}: {e}' for e in errors)
    rounds = int(eng.stats.get('spec_steps'))
    steps = int(eng.stats.get('decode_steps'))
    report = svc.report(tag)
    accept = eng.stats.get('spec_accept_rate')
    svc.close(60)
    for name, want in (('paged_flash_verify' + sfx, cfg.num_stages * rounds),
                       ('paged_flash_decode' + sfx,
                        cfg.num_stages * (steps - rounds))):
        if rounds <= 0 or launches[name] != want:
            failures.append(f'{tag}: {name} launched {launches[name]} times '
                            f'over {rounds} spec rounds of {steps} steps, '
                            f'want {want}')
    equal = []
    for i, r in enumerate(reqs):
        if r is None or r.result is None:
            failures.append(f'{tag}: request {i} not served')
            continue
        want = T.generate(eng.params, prompts[i], SPEC_MAX_NEW, eng.cfg,
                          flash=eng.use_flash)[0]
        ok = bool(np.array_equal(r.result, want))
        equal.append(ok)
        if not ok:
            failures.append(f'{tag}: stream {i} differs from the target '
                            f'alone: {_divergence(eng.params, eng.cfg, prompts[i], r.result, want)}')
    tokens = sum(len(r.result) for r in reqs
                 if r is not None and r.result is not None)
    return {'phase': tag, 'dtype': dtype, 'spec_k': SPEC_K, 'requests': n,
            'max_new': SPEC_MAX_NEW, 'tokens': tokens, 'drive_s': wall,
            'tokens_per_s': tokens / wall, 'spec_rounds': rounds,
            'decode_steps': steps, 'accept_rate': accept,
            'launches': launches, 'equal_to_target': equal,
            'stats': report}


def _prefill_vs_f32(params, cfg, tiers, failures):
    """Prefill logits of each quantized tier's tree against the f32 tree's
    on ``QUANT_LOGIT_PROMPTS`` seeded prompts: the relative error of the
    largest value and the top-1 agreement, reported, not gated (the
    tolerance twins are the CPU tests')."""
    from cxxnet_tpu_torch.models import transformer as T
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, LM['vocab_size'], (1, int(s))).astype(np.int32)
               for s in rng.randint(1, 129, QUANT_LOGIT_PROMPTS)]

    def logits(p, c, prompt):
        s0 = prompt.shape[1]
        w = T._size_class(s0, floor=8) - s0
        toks = torch.from_numpy(np.pad(prompt, ((0, 0), (w, 0)))).cuda()
        with torch.inference_mode():
            return T.prefill_kv(p, toks, w, c)[2][0]

    out = {}
    for name, (tp, tc) in tiers.items():
        rel, top1 = [], []
        for prompt in prompts:
            ref, got = logits(params, cfg, prompt), logits(tp, tc, prompt)
            if not torch.isfinite(got).all():
                failures.append(f'quant: {name} prefill logits not finite')
            rel.append(rel_err(got, ref)[1])
            top1.append(bool(got.argmax() == ref.argmax()))
        out[name] = {'rel_err_of_max': rel, 'top1_equal': top1}
    return out


def quant_phase(params, cfg, f32_resident, failures):
    """The quantized serving tiers of the same model through
    ``DecodeService``: (a) ``serve.dtype=int8`` over the decode phase's 48
    requests, six streams checked against ``generate``, the bf16 paged
    decode kernel 8 times and ``int8_matmul`` 49 times per decode step and
    per prefill; (b) ``bf16`` over the first 16, four twins; (c) int8
    with ``spec_k=4`` and the target as its own draft; (d) the resident
    bytes of the three tiers; (e) prefill logits against f32."""
    from cxxnet_tpu_torch.nnet.quantize import tree_nbytes
    walk = INT8_PER_STAGE * cfg.num_stages + 1    # + the head
    i8, _, e8 = _serve_tier(params, cfg, failures, 'quant[int8]', 'int8',
                            DECODE_REQUESTS, 4, 2, True)
    steps = i8['decode_steps']
    if steps <= 0:
        failures.append('quant[int8]: no decode step ran')
    _check_launches('quant[int8]', i8['launches'],
                    {'paged_flash_decode_bf16': cfg.num_stages * steps,
                     'int8_matmul': walk * (steps + DECODE_REQUESTS)},
                    failures)
    b16, _, e16 = _serve_tier(params, cfg, failures, 'quant[bf16]', 'bf16',
                              QUANT_BF16_REQUESTS, 3, 1, False)
    _check_launches('quant[bf16]', b16['launches'],
                    {'paged_flash_decode_bf16':
                     cfg.num_stages * b16['decode_steps']}, failures)
    spec = spec_phase(params, cfg, failures, 'quant[int8 spec]', 'int8',
                      QUANT_SPEC_REQUESTS)
    resident = {'f32': f32_resident, 'bf16': b16['resident_bytes'],
                'int8': i8['resident_bytes']}
    if f32_resident is None or not (
            resident['bf16'] < 0.55 * f32_resident
            and resident['int8'] < resident['bf16']):
        failures.append(f'quant: resident bytes {resident} out of order')
    params_bytes = {'f32': tree_nbytes(params),
                    'bf16': tree_nbytes(e16.params),
                    'int8': tree_nbytes(e8.params)}
    return {'phase': 'quant', 'int8': i8, 'bf16': b16, 'int8_spec': spec,
            'resident_bytes': resident,
            'resident_ratio': {k: v / f32_resident for k, v in
                               resident.items()} if f32_resident else None,
            'param_bytes': params_bytes,
            'prefill_vs_f32': _prefill_vs_f32(
                params, cfg, {'int8': (e8.params, e8.cfg),
                              'bf16': (e16.params, e16.cfg)}, failures)}


# --- the prefix path ---------------------------------------------------------

# chat-style traffic over the decode LM: PREFIX_SYSTEMS seeded system
# prompts of PREFIX_SYS tokens, each request adding its own PREFIX_TURN-token
# turn (s0 = 128, its own bucket, w = 0), PREFIX_MISSES prompts of random
# length 1-128 that share nothing, PREFIX_SAMPLED of them sampled at 0.8
PREFIX_SYS, PREFIX_TURN, PREFIX_SYSTEMS = 96, 32, 4
PREFIX_CHAT, PREFIX_MISSES, PREFIX_SAMPLED = 40, 8, (3, 14, 27, 44)
PREFIX_MAX_NEW = (16, 33)          # max_new uniform in [16, 32]
# the legs that repeat another's coverage (share, workers, spec, int8)
# take the traffic's first PREFIX_HALF or PREFIX_INT8_REQUESTS requests
PREFIX_HALF, PREFIX_INT8_REQUESTS = 24, 12
# the tier leg: a 8-page index, a 4 MiB host tier (4 records of 1 MiB at
# this width: 8 stages x 16 rows x 16 heads x 64 x 4 B, for K and V) and
# a 64 MiB disk tier
PREFIX_TIER_KW = dict(prefix_share=8, kv_host_mb=4, kv_disk_mb=64)
PREFIX_CLI_REQUESTS, PREFIX_CLI_NEW = 8, 16


def _prefix_traffic():
    """The prefix phase's requests, interleaved (chat request i on system
    prompt i % 4, the misses spread through), and the tier leg's
    prologue: a chat request on system prompt 0, then enough 128-token
    misses to push all its pages out of the index and more pages than the
    host tier holds behind them, so that the first record spilled (the
    one ``corrupt_kv=1`` poisons) is that system prompt's first page,
    which the traffic's first request reads."""
    rng = np.random.RandomState(SEED + 71)
    v = LM['vocab_size']
    systems = [rng.randint(0, v, (1, PREFIX_SYS)).astype(np.int32)
               for _ in range(PREFIX_SYSTEMS)]
    prompts = []
    misses = set(range(5, PREFIX_CHAT + PREFIX_MISSES, 6))
    chat = 0
    for i in range(PREFIX_CHAT + PREFIX_MISSES):
        if i in misses:
            prompts.append(rng.randint(0, v, (1, int(rng.randint(1, 129))))
                           .astype(np.int32))
        else:
            turn = rng.randint(0, v, (1, PREFIX_TURN)).astype(np.int32)
            prompts.append(np.concatenate([systems[chat % PREFIX_SYSTEMS],
                                           turn], axis=1))
            chat += 1
    n = len(prompts)
    max_news = [int(x) for x in rng.randint(*PREFIX_MAX_NEW, n)]
    temps = [0.8 if i in PREFIX_SAMPLED else 0.0 for i in range(n)]
    seeds = [SEED + 300 + i if i in PREFIX_SAMPLED else None
             for i in range(n)]
    record = 2 * LM['num_stages'] * DECODE['page_size'] * LM['d_model'] * 4
    host_records = (PREFIX_TIER_KW['kv_host_mb'] << 20) // record
    pages = DECODE['max_prompt'] // DECODE['page_size']
    prologue = [np.concatenate([systems[0], rng.randint(
        0, v, (1, PREFIX_TURN)).astype(np.int32)], axis=1)] + [
        rng.randint(0, v, (1, DECODE['max_prompt'])).astype(np.int32)
        for _ in range(-(-(host_records + 1) // pages) + 1)]
    return prompts, max_news, temps, seeds, prologue


def _unpadded_tail(params, cfg, pks, pvs, tail, w):
    """The JAX package's tail prefill, row for row: the walk over the tail's
    rows alone (the port runs it at the full prefill's rows).  Measurement
    only: whether the card gives these rows the full prefill's bits."""
    import math
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.nnet.quantize import qdot, qtake
    from cxxnet_tpu_torch.parallel.sequence import _local_attention
    b, tt = tail.shape
    t0 = pks.shape[2]
    H = cfg.num_heads
    hd = cfg.d_model // H
    h = qtake(params['embed'], tail.long())
    gq = t0 + torch.arange(tt, device=h.device)
    ar = torch.arange(t0 + tt, device=h.device)
    mask = ((ar[None, :] <= gq[:, None]) & (ar[None, :] >= w))[None, None]
    ks = []
    for i in range(cfg.num_stages):
        p = T._stage(params, i)
        y = T._layer_norm(h, p['ln1_scale'], p['ln1_bias'])
        q = qdot(y, p['wq']).reshape(b, tt, H, hd)
        k = qdot(y, p['wk']).reshape(b, tt, H, hd)
        v = qdot(y, p['wv']).reshape(b, tt, H, hd)
        attn = _local_attention(q, torch.cat([pks[i], k], 1),
                                torch.cat([pvs[i], v], 1),
                                1.0 / math.sqrt(hd), mask)
        h = h + qdot(attn.reshape(b, tt, cfg.d_model), p['wo'])
        y2 = T._layer_norm(h, p['ln2_scale'], p['ln2_bias'])
        ks.append(k)
        h = h + T._gen_ffn(p, y2)
    return torch.stack(ks), qdot(h[:, -1], params['head']).float()


def _prefix_tail_probe(tiers):
    """On the card, per tier: the port's tail prefill against its full
    prefill (must be bitwise: the twins' contract), and two findings —
    whether the unpadded tail (JAX's row count) and a prompt's rows
    computed in a smaller bucket would have matched (max abs difference;
    0 = bitwise)."""
    from cxxnet_tpu_torch.models import transformer as T
    rng = np.random.RandomState(SEED + 72)
    toks = torch.from_numpy(rng.randint(0, LM['vocab_size'], (1, 128))
                            .astype(np.int64)).cuda()
    out = {}
    with torch.inference_mode():
        for name, (params, cfg) in tiers.items():
            ks, vs, lg = T.prefill_kv(params, toks, 0, cfg)
            row = {}
            for t0 in (96, 112, 127):
                tk, tv, tl = T.prefill_tail_kv(params, toks, t0, 0, cfg)
                uk, ul = _unpadded_tail(params, cfg, ks[:, :, :t0],
                                        vs[:, :, :t0], toks[:, t0:], 0)
                row[f'tail{128 - t0}'] = {
                    'bitwise': bool(torch.equal(tk, ks[:, :, t0:])
                                    and torch.equal(tv, vs[:, :, t0:])
                                    and torch.equal(tl, lg)),
                    'unpadded_k_max_abs_diff': float(
                        (uk.float() - ks[:, :, t0:].float()).abs().max()),
                    'unpadded_logits_max_abs_diff': float(
                        (ul - lg).abs().max())}
            small = T.prefill_kv(params, toks[:, :64], 0, cfg)[0]
            row['bucket64_vs_128_k_max_abs_diff'] = float(
                (small.float() - ks[:, :, :64].float()).abs().max())
            out[name] = row
    return out


def _prefix_leg(tag, params, cfg, traffic, want, failures, prologue=None,
                n=None, svc_kw=None, clients=DECODE_CLIENTS):
    """One leg of the prefix phase: the traffic (its first ``n``) through a
    ``DecodeService`` built with ``svc_kw``, after the ``prologue``
    requests one at a time.  Launch counts from 0 just before, read just
    after; every stream against ``want`` (offline ``generate``) bitwise.
    Returns ``(row, results, service)``; the caller closes the service."""
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve.decode import DecodeService
    prompts, max_news, temps, seeds = (x[:n] for x in traffic[:4])
    with torch.inference_mode():
        svc = DecodeService(params, cfg, **DECODE, max_queue=64,
                            deadline=300.0, flash_decode='auto',
                            device='cuda', **(svc_kw or {}))
    eng = svc.engine
    pro = []
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    for p, m in prologue or ():
        r = svc.submit_async(p, m, deadline=300.0)
        try:
            svc.batcher.wait(r)
        except Exception as e:  # noqa: BLE001 — reported
            failures.append(f'{tag}: prologue request: {e!r}')
        pro.append(r)
    reqs, errors, wall = _drive(svc, prompts, max_news, temps, seeds,
                                clients, 0.005)
    launches = launch_counts()
    # --------------------------------------------------------------------
    failures.extend(f'{tag}: {e}' for e in errors)
    results = [None if r is None else r.result for r in reqs]
    pro_results = [r.result for r in pro]
    mismatch = []
    for i, got in enumerate(pro_results + results):
        j = i - len(pro_results)
        ref = want['prologue'][i] if j < 0 else want['traffic'][j]
        if got is None or not np.array_equal(got, ref):
            p = prologue[i][0] if j < 0 else prompts[j]
            mismatch.append(i)
            detail = ({'tokens': None if got is None else len(got),
                       'want': len(ref)}
                      if got is None or len(got) != len(ref) else
                      _divergence(want['params'], want['cfg'], p, got, ref))
            failures.append(f'{tag}: stream {i} differs from offline '
                            f'generate: {detail}')
    served = [r for r in reqs if r is not None and r.result is not None]
    tokens = sum(len(r.result) for r in served)
    ttft = [1e3 * (r.token_times[0] - r.t_submit) for r in served]
    st = eng.stats
    samples = st.snapshot()[1]

    def p50(name, stats=st):
        vals = stats.snapshot()[1].get(name)
        return float(np.quantile(vals, 0.5)) if vals else None

    row = {'phase': tag, 'requests': len(prompts) + len(pro),
           'served': len(served) + sum(r.result is not None for r in pro),
           'streams_equal_generate': len(pro) + len(prompts) - len(mismatch),
           'tokens': tokens, 'drive_s': wall, 'tokens_per_s': tokens / wall,
           'ttft_ms_p50': float(np.quantile(ttft, 0.5)),
           'ttft_ms_p95': float(np.quantile(ttft, 0.95)),
           'decode_steps': int(st.get('decode_steps')),
           'prefix_hits': int(st.get('prefix_hits')),
           'prefix_hit_pages': int(st.get('prefix_hit_pages')),
           'prefix_published': int(st.get('prefix_published')),
           'prefill_rows': int(st.get('prefill_rows')),
           'tail_rows': int(st.get('tail_rows')),
           'kv_promoted_pages': int(st.get('kv_promoted_pages')),
           'publish_copy_ms_p50': p50('publish_copy_ms'),
           'publish_copies': len(samples.get('publish_copy_ms', ())),
           'admit_ms_p50': p50('admit_ms'),
           'prefill_ms_p50': p50('prefill_ms'),
           'step_occupancy_mean': float(np.mean(
               samples.get('step_occupancy', [0.0]))),
           'launches': launches, 'stats': svc.report(tag)}
    if eng.kv_stats is not None:
        ks = eng.kv_stats
        row['kv'] = {k: int(ks.get(k)) for k in (
            'demote_pages', 'spills', 'promote_pages', 'disk_promote_pages',
            'adopts', 'published', 'corrupt_quarantined', 'hits', 'misses',
            'spill_dropped')}
        row['kv'].update(record_write_ms_p50=p50('spill_ms', ks),
                         record_read_ms_p50=p50('read_ms', ks),
                         prefetch_ms_p50=p50('promote_ms', ks),
                         occupancy=eng.kv_occupancy())
    return row, results, svc


def _same_streams(got, want) -> bool:
    return len(got) == len(want) and all(
        a is not None and b is not None and np.array_equal(a, b)
        for a, b in zip(got, want))


def _prefix_cli(work, cfg_kw, failures):
    """``task=serve serve.mode=decode`` through the CLI's ``main`` in this
    process with the tier leg's keys and ``serve.prefill_workers=2``:
    exit 0, the engine line naming them, the CLI's own twin check, then
    every stream of its pred file against offline ``generate`` (its
    prompts and weights re-made from its seeds), and its launches."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    spec = ';'.join(f'{k}={LM[v]}' for k, v in (
        ('vocab', 'vocab_size'), ('d_model', 'd_model'),
        ('heads', 'num_heads'), ('d_ff', 'd_ff'), ('stages', 'num_stages')))
    conf = '\n'.join([
        'task = serve', 'serve.mode = decode', f'serve.lm = "{spec}"',
        f'serve.slots = {DECODE["slots"]}', f'serve.pages = {DECODE["pages"]}',
        f'serve.page_size = {DECODE["page_size"]}',
        f'serve.max_prompt = {DECODE["max_prompt"]}',
        f'serve.max_new = {PREFIX_CLI_NEW}',
        f'serve.requests = {PREFIX_CLI_REQUESTS}',
        f'serve.prefix_share = {PREFIX_TIER_KW["prefix_share"]}',
        f'serve.kv_host_mb = {PREFIX_TIER_KW["kv_host_mb"]}',
        f'serve.kv_disk_mb = {PREFIX_TIER_KW["kv_disk_mb"]}',
        'serve.kv_dir = kv', 'serve.prefill_workers = 2', 'pred = toks.txt',
        ''])
    with open(os.path.join(work, 'dec.conf'), 'w') as f:
        f.write(conf)
    reset_launch_counts()
    rc, out, err, wall = _cli_in_process(['dec.conf'], work)
    launches = launch_counts()
    text = [ln for _, ln in out]
    checks = {
        'exit_0': rc == 0,
        'engine_line': any('prefix_share=8' in ln and 'prefill_workers=2'
                           in ln and 'attention=flash' in ln for ln in text),
        'twin_line': any('decode twin check: 3 streams' in ln
                         for ln in text)}
    steps = 0
    for _, ln in err:
        for part in ln.split('\t'):
            if part.startswith('decode-decode_steps:'):
                steps = int(float(part.split(':')[1]))
    lines = []
    if os.path.exists(os.path.join(work, 'toks.txt')):
        with open(os.path.join(work, 'toks.txt')) as f:
            lines = [[int(t) for t in ln.split()] for ln in f]
    rng = np.random.RandomState(0)
    top = max(2, DECODE['max_prompt'])
    prompts = [rng.randint(0, cfg_kw['vocab_size'],
                           (1, int(rng.randint(1, top)))).astype(np.int32)
               for _ in range(PREFIX_CLI_REQUESTS)]
    cfg = T.TransformerConfig(**cfg_kw)
    params = T.init_params(np.random.RandomState(0), cfg, device='cuda')
    equal = []
    for p, got in zip(prompts, lines):
        ref = T.generate(params, p, PREFIX_CLI_NEW, cfg, flash=True)[0]
        equal.append(bool(np.array_equal(np.asarray(got, np.int32), ref)))
    del params
    checks['every_stream_equal_generate'] = (
        len(equal) == PREFIX_CLI_REQUESTS and all(equal))
    for name, ok in checks.items():
        if not ok:
            failures.append(f'prefix[cli]: check {name} failed: '
                            f'{[ln for _, ln in err][-5:]}')
    # the CLI's own twin check runs 3 offline generate calls on the kernels
    # (max_new - 1 steps each) inside the counted window
    _check_launches('prefix[cli]', launches,
                    {'paged_flash_decode': LM['num_stages'] * (
                        steps + 3 * (PREFIX_CLI_NEW - 1))}, failures)
    if steps <= 0:
        failures.append('prefix[cli]: no decode step read from its report')
    return {'phase': 'prefix[cli]', 'checks': checks, 'wall_s': wall,
            'decode_steps': steps, 'streams_equal_generate': sum(equal),
            'launches': launches,
            'stats': [ln for _, ln in err if 'decode-' in ln][-1:]}


def prefix_phase(params, cfg, failures):
    """Prefix sharing, the tiered KV cache and prefill workers on the
    decode LM at full width (``DECODE``, ``flash_decode=auto``) under
    chat-style traffic (``_prefix_traffic``): an unshared leg, then (a)
    ``prefix_share=64``, (b) the tiers (``PREFIX_TIER_KW``, records in a
    temp dir) under ``FaultPlan(corrupt_kv=1)`` after a prologue that
    pushes a system prompt's pages down-tier, (c) two engines on one
    share dir, the second adopting the first's records, (d)
    ``prefill_workers=2``, (e) ``spec_k=4`` with the target as its draft,
    (f) ``serve.dtype=int8``, (g) the CLI with (b)'s keys and two prefill
    workers.  Every stream of every leg bitwise its offline ``generate``
    (the tier's own tree and config for (f)), which the unshared leg's
    streams also are; the paged kernels (and the int8 GEMM) launch
    exactly as the steps and prefills count.  Each leg prints its line;
    the tail prefill probe is the phase's own line."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.runtime import faults
    traffic = _prefix_traffic()
    prompts, max_news, temps, seeds, prologue = traffic
    st = cfg.num_stages
    walk = INT8_PER_STAGE * st + 1
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = {'params': params, 'cfg': cfg,
                'traffic': [T.generate(params, p, m, cfg, temperature=t,
                                       rng=s, flash=True)[0]
                            for p, m, t, s in zip(prompts, max_news, temps,
                                                  seeds)],
                'prologue': [T.generate(params, p, 24, cfg, flash=True)[0]
                             for p in prologue]}
    want_s = time.perf_counter() - t0
    pro = [(p, 24) for p in prologue]
    legs = {}

    def leg(tag, expect, twins=want, **kw):
        row, results, svc = _prefix_leg(f'prefix[{tag}]', params, cfg,
                                        traffic, twins, failures, **kw)
        row['spec_rounds'] = int(svc.engine.stats.get('spec_steps'))
        svc.close(60)
        steps = row['decode_steps']
        _check_launches(row['phase'], row['launches'], expect(row), failures)
        if steps <= 0:
            failures.append(f'{row["phase"]}: no decode step ran')
        emit(row)
        legs[tag] = row
        torch.cuda.empty_cache()
        return row, results

    dec = lambda row: {'paged_flash_decode': st * row['decode_steps']}
    unshared, base = leg('unshared', dec, svc_kw={})
    shared, res = leg('shared', dec, svc_kw={'prefix_share': 64})
    if shared['prefix_hits'] <= 0:
        failures.append('prefix[shared]: no prefix hit')
    if not _same_streams(res, base):
        failures.append('prefix[shared]: streams differ from the unshared '
                        'leg')
    with tempfile.TemporaryDirectory() as d:
        plan = faults.FaultPlan(corrupt_kv=(1,))
        prev = faults.install_plan(plan)
        try:
            tiers, res = leg('tiers', dec, prologue=pro, svc_kw=dict(
                PREFIX_TIER_KW, kv_dir=os.path.join(d, 'kv')))
        finally:
            faults.install_plan(prev)
        tiers['fault_plan_fired'] = plan.fired()
        kv = tiers['kv']
        if plan.fired() != ['corrupt_kv=1'] or \
                kv['corrupt_quarantined'] != 1:
            failures.append(f'prefix[tiers]: fired {plan.fired()}, '
                            f'{kv["corrupt_quarantined"]} quarantined, '
                            'want exactly one')
        if not (kv['demote_pages'] > 0 and kv['spills'] > 0
                and tiers['kv_promoted_pages'] > 0):
            failures.append(f'prefix[tiers]: demoted, spilled or promoted '
                            f'nothing: {kv}')
        if not _same_streams(res, base):
            failures.append('prefix[tiers]: streams differ from the '
                            'unshared leg')
        share = os.path.join(d, 'shared')
        half = PREFIX_HALF
        first, _ = leg('share_publish', dec, n=half, svc_kw=dict(
            prefix_share=8, kv_disk_mb=64, kv_dir=os.path.join(d, 'e1'),
            kv_share_dir=share))
        second, res = leg('share_adopt', dec, n=half, svc_kw=dict(
            prefix_share=8, kv_disk_mb=64, kv_dir=os.path.join(d, 'e2'),
            kv_share_dir=share))
        if not (first['kv']['published'] > 0
                and second['kv']['adopts'] > 0):
            failures.append(f'prefix[share]: published '
                            f'{first["kv"]["published"]}, adopted '
                            f'{second["kv"]["adopts"]}')
        if not _same_streams(res, base[:half]):
            failures.append('prefix[share_adopt]: streams differ from '
                            'the unshared leg')
        workers, res = leg('workers', dec, n=half,
                           svc_kw={'prefix_share': 64, 'prefill_workers': 2})
        if not _same_streams(res, base[:half]):
            failures.append('prefix[workers]: streams differ from the '
                            'unshared leg')
        spec, res = leg(
            'spec', lambda row: {
                'paged_flash_verify': st * row['spec_rounds'],
                'paged_flash_decode': st * (row['decode_steps']
                                            - row['spec_rounds'])},
            n=half,
            svc_kw={'prefix_share': 64, 'spec_k': SPEC_K,
                    'draft': (params, cfg)})
        if spec['spec_rounds'] <= 0:
            failures.append('prefix[spec]: no spec round ran')
        if not _same_streams(res, base[:half]):
            failures.append('prefix[spec]: streams differ from the '
                            'unshared leg')
        # (f) the int8 tier: its twins are generate over its own tree
        from cxxnet_tpu_torch.serve.decode import DecodeEngine
        n8 = PREFIX_INT8_REQUESTS
        with torch.inference_mode():
            probe_eng = DecodeEngine(params, cfg, **DECODE, dtype='int8',
                                     device='cuda')
        i8p, i8c = probe_eng.params, probe_eng.cfg
        probe_eng.close(60)
        with torch.inference_mode():
            want8 = {'params': i8p, 'cfg': i8c, 'prologue': [],
                     'traffic': [T.generate(i8p, p, m, i8c, temperature=t,
                                            rng=s, flash=True)[0]
                                 for p, m, t, s in zip(
                                     prompts[:n8], max_news[:n8],
                                     temps[:n8], seeds[:n8])]}
        i8, _ = leg('int8', lambda row: {
            'paged_flash_decode_bf16': st * row['decode_steps'],
            'int8_matmul': walk * (row['decode_steps'] + n8)},
            twins=want8, n=n8, svc_kw={'prefix_share': 64, 'dtype': 'int8'})
        if i8['prefix_hits'] <= 0:
            failures.append('prefix[int8]: no prefix hit')
        del want8
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(d, 'cli'))
        cli = _prefix_cli(os.path.join(d, 'cli'), LM, failures)
        emit(cli)
        legs['cli'] = cli
    probe = _prefix_tail_probe({'f32': (params, cfg), 'int8': (i8p, i8c)})
    for tier, row in probe.items():
        for key, val in row.items():
            if isinstance(val, dict) and not val['bitwise']:
                failures.append(f'prefix[probe]: {tier} {key} tail rows '
                                f'are not the full prefill\'s: {val}')
    del i8p
    torch.cuda.empty_cache()
    return {'phase': 'prefix', 'model': LM, 'engine': DECODE,
            'requests': len(prompts), 'chat': PREFIX_CHAT,
            'misses': PREFIX_MISSES, 'system_tokens': PREFIX_SYS,
            'turn_tokens': PREFIX_TURN, 'twins_s': want_s,
            'tail_probe': probe,
            'summary': {tag: {k: row.get(k) for k in (
                'tokens_per_s', 'ttft_ms_p50', 'ttft_ms_p95',
                'prefix_hits', 'prefix_hit_pages', 'prefill_rows',
                'tail_rows', 'publish_copy_ms_p50',
                'admit_ms_p50', 'prefill_ms_p50', 'step_occupancy_mean',
                'streams_equal_generate', 'kv', 'decode_steps',
                'fault_plan_fired')}
                for tag, row in legs.items()},
            'launches': {tag: row['launches'] for tag, row in legs.items()}}


def lm_phases(failures):
    """The decode, spec, quant and prefix phases over one seeded
    GPT-2-small-class model."""
    from cxxnet_tpu_torch.ops.precision import full_f32
    params, cfg = _lm_params()
    with full_f32():
        decode = run_phase(decode_phase, failures, params, cfg)
        spec = run_phase(spec_phase, failures, params, cfg)
        quant = run_phase(quant_phase, failures, params, cfg,
                          decode['resident_bytes'] if decode else None)
        emit(decode)
        emit(spec)
        emit(quant)
        torch.cuda.empty_cache()
        prefix = run_phase(prefix_phase, failures, params, cfg)
    return decode, spec, quant, prefix


# --- the sequence-parallel path -----------------------------------------------

# the LM's attention width: 16 heads of 64, causal, one sequence of 8192,
# where 4 * b * h * s^2 = 4 GiB of dense f32 scores: the gate engages
SEQ = dict(b=1, s=8192, h=16, d=64)
SEQ_CALLS = 5
SEQ_DENSE_S, SEQ_RING_S = 4096, 2048      # gate off at 4 * 16 * 4096^2 = 1 GiB
# the bf16 builds at the JAX probe's shapes (tools/flash_engage_probe.py):
# checked at b1 h8 s2048, the forward timed at the dense-infeasible s32768
SEQ_BF16 = dict(b=1, s=2048, h=8, d=64)
SEQ_BF16_LONG = 32768
# launches a library yardstick is timed over: SDPA's s2048 kernels are a
# few microseconds each, and over 5 launches read anywhere in 2x
LIB_ITERS = 20
# the probe's limit: max |flash - dense| of the bf16 forward, absolute
BF16_PROBE_ATOL = 0.05
# out and its three gradients against the dense reference's autograd, as
# max |flash - dense| / max |dense|: online against dense softmax over
# 8192 keys, f32 sums in different orders
SEQPAR_TOL = 1e-4


def flash_kernel_checks(dev, peaks, failures):
    """The flash-attention kernels at the ``seqpar`` path's shapes: the
    f32 builds at b1 h16 s8192 d64 causal (one ``ulysses_attention``
    call's local problem), the bf16 builds at b1 h8 s2048, each against
    its plain version on the same inputs.  dq and dk/dv take the plain
    forward's lse and ``delta = sum(do * out)``.  The library call is
    ``F.scaled_dot_product_attention(is_causal=True)`` (forward; its
    autograd backward, fwd+bwd less fwd, for dq and dk/dv together), over
    LIB_ITERS launches, as are the kernels.  The forward, dq and dk/dv
    are each launched once more on the same inputs, bitwise equal.  The
    f32 builds run on the TF32 tensor cores with the 3xTF32 split:
    ``bound_ms`` counts the function's products (4 d flops a live pair
    for the forward, 6 d for dq, 8 d for dk/dv) at the dense TF32 rate
    (``bound_rate``), ``bound_split_ms`` the three TF32 products a term
    that the kernels take, and ``bound_fma_ms`` the function's products
    at the f32 FMA rate, as the bf16 rows count the function and the
    split apart."""
    from cxxnet_tpu_torch.ops.flash import (flash_dkv, flash_dkv_plain,
                                            flash_dq, flash_dq_plain,
                                            flash_fwd, flash_fwd_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    for dtype, sfx, shp, op_rate in (
            (torch.float32, '', SEQ, peaks[0]),
            (torch.bfloat16, '_bf16', SEQ_BF16, peaks[3])):
        b, s, h, d = shp['b'], shp['s'], shp['h'], shp['d']
        bh = b * h
        q, k, v, do = (torch.randn((bh, s, d), device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        with torch.no_grad():
            out, lse = flash_fwd(q, k, v, True)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_fwd_plain(q, k, v, True)
            delta = (do.float() * ref_out.float()).sum(-1)
            dq = flash_dq(q, k, v, do, ref_lse, delta, True)
            dk, dv = flash_dkv(q, k, v, do, ref_lse, delta, True)
            torch.cuda.synchronize()
            ref_dq = flash_dq_plain(q, k, v, do, ref_lse, delta, True)
            ref_dk, ref_dv = flash_dkv_plain(q, k, v, do, ref_lse, delta,
                                             True)
            repeat = {'fwd': all(torch.equal(a, b) for a, b in zip(
                          flash_fwd(q, k, v, True), (out, lse))),
                      'dq': torch.equal(flash_dq(q, k, v, do, ref_lse,
                                                 delta, True), dq),
                      'dkv': all(torch.equal(a, b) for a, b in zip(
                          flash_dkv(q, k, v, do, ref_lse, delta, True),
                          (dk, dv)))}
            n = LIB_ITERS
            ms = {'fwd': time_ms(lambda: flash_fwd(q, k, v, True), n),
                  'dq': time_ms(lambda: flash_dq(q, k, v, do, ref_lse,
                                                 delta, True), n),
                  'dkv': time_ms(lambda: flash_dkv(q, k, v, do, ref_lse,
                                                   delta, True), n)}
            plain = {'fwd': time_ms(lambda: flash_fwd_plain(q, k, v, True),
                                    2),
                     'dq': time_ms(lambda: flash_dq_plain(
                         q, k, v, do, ref_lse, delta, True), 2),
                     'dkv': time_ms(lambda: flash_dkv_plain(
                         q, k, v, do, ref_lse, delta, True), 2)}
        # (b, h, s, d) views for SDPA; timed only, never on the path
        qs, ks, vs, dos = (x.view(b, h, s, d) for x in (q, k, v, do))
        lib_fwd, lib_bwd = _sdpa_ms(qs, ks, vs, dos)
        pairs = bh * s * (s + 1) / 2.0        # live causal (query, key)
        esz, n = q.element_size(), bh * s * d
        work = {'fwd': (4.0 * pairs * d, esz * 4 * n + 4.0 * bh * s,
                        ((out, ref_out), (lse, ref_lse)), lib_fwd),
                'dq': (6.0 * pairs * d, esz * 5 * n + 8.0 * bh * s,
                       ((dq, ref_dq),), lib_bwd),
                'dkv': (8.0 * pairs * d, esz * 6 * n + 8.0 * bh * s,
                        ((dk, ref_dk), (dv, ref_dv)), lib_bwd)}
        for part, (flops, nbytes, pairs_out, lib_ms) in work.items():
            name, tol = f'flash_{part}{sfx}', TOL[f'flash_{part}']
            errs = [rel_err(got, ref) for got, ref in pairs_out]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            # f32 outputs (all of the f32 builds', the bf16 lse) against
            # the largest value, bf16 outputs element by element
            f32_rel = max([0.0] + [e[1] for e, (got, _) in
                                   zip(errs, pairs_out)
                                   if got.dtype == torch.float32])
            excess = max([0.0] + [step16_excess(got, ref)
                                  for got, ref in pairs_out
                                  if got.dtype == torch.bfloat16])
            b_ms, b_by = bound(flops, nbytes, peaks, op_rate)
            extra, rate = {}, 'f32 FMA' if op_rate == peaks[0] else 'bf16'
            if dtype == torch.float32:
                extra = tf32_bounds(flops, nbytes, peaks)
                b_ms, b_by = bound(flops, nbytes, peaks, peaks[4])
                rate = extra.pop('bound_rate')
            same = repeat.get(part, True)
            if not (f32_rel <= tol and excess <= 1.0 and same) or not all(
                    torch.isfinite(got.float()).all() for got, _ in pairs_out):
                failures.append(f'{name}: f32 outputs max rel err {f32_rel} '
                                f'(tol {tol}), bf16 outputs {excess} of '
                                'one bf16 step (tol 1), two launches '
                                f'bitwise equal {same}')
            if part in repeat:
                extra['bitwise_repeat'] = repeat[part]
            rows.append({'kernel': name,
                         'shape': f'b{b}h{h}s{s}d{d} causal',
                         'dtype': str(dtype).split('.')[-1],
                         'max_abs_err': err, 'max_rel_err': rel,
                         'tol_rel': tol, 'bf16_step_excess':
                         excess if dtype == torch.bfloat16 else None,
                         'kernel_ms': ms[part],
                         'plain_ms': plain[part], 'library_ms': lib_ms,
                         'library': ('sdpa forward' if part == 'fwd' else
                                     'sdpa autograd backward (dq, dk, dv '
                                     'together)'),
                         'bound_ms': b_ms, 'bound_by': b_by,
                         'bound_rate': rate, 'flops': flops,
                         'bytes': nbytes, **extra})
        del q, k, v, do, out, lse, ref_out, ref_lse, delta, dq, dk, dv
        del ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
    rows.append(_flash_fwd_long(dev, gen, peaks, failures))
    rows += _flash_bwd_long(dev, gen, peaks, failures)
    return rows


def _sdpa_ms(qs, ks, vs, dos):
    """SDPA's causal forward and its autograd backward (forward +
    backward less forward: dq, dk and dv together) on (b, h, s, d) views,
    mean device ms over LIB_ITERS launches each.  Timed only, never on
    the path."""
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), LIB_ITERS)
    leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, dos)
    return fwd, max(time_ms(fwd_bwd, LIB_ITERS) - fwd, 0.0)


def _flash_fwd_long(dev, gen, peaks, failures):
    """The bf16 forward alone at b1 h8 s32768 d64 causal (the ``seqpar``
    bf16 leg's long shape) beside SDPA's causal forward on the same
    inputs, held to one bf16 step of its plain version (one plain call:
    an (s, s) f32 score matrix per slice, ~13 GB at the peak).  Timed
    only, outside the kernels line's sums (``in_summary``)."""
    from cxxnet_tpu_torch.ops.flash import flash_fwd, flash_fwd_plain
    b, h, d, s = SEQ_BF16['b'], SEQ_BF16['h'], SEQ_BF16['d'], SEQ_BF16_LONG
    q, k, v = (torch.randn((b * h, s, d), device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        out, lse = flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_fwd_plain(q, k, v, True)
        excess = step16_excess(out, ref_out)
        err, rel = rel_err(out, ref_out)
        lse_rel = rel_err(lse, ref_lse)[1]
        del ref_out, ref_lse
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash_fwd(q, k, v, True), 5)
        if not torch.equal(flash_fwd(q, k, v, True)[0], out):
            failures.append(f'flash_fwd_bf16[s{s}]: two launches differ')
        qs, ks, vs = (x.view(b, h, s, d) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), LIB_ITERS)
    if not (excess <= 1.0 and lse_rel <= TOL['flash_fwd']) \
            or not torch.isfinite(out.float()).all():
        failures.append(f'flash_fwd_bf16[s{s}]: out {excess} of one bf16 '
                        f'step (tol 1), lse max rel err {lse_rel} (tol '
                        f'{TOL["flash_fwd"]})')
    flops = 4.0 * b * h * s * (s + 1) / 2.0 * d
    b_ms, b_by = bound(flops, 2.0 * 4 * b * h * s * d + 4.0 * b * h * s,
                       peaks, peaks[3])
    return {'kernel': 'flash_fwd_bf16', 'shape': f'b{b}h{h}s{s}d{d} causal',
            'dtype': 'bfloat16', 'in_summary': False, 'max_abs_err': err,
            'max_rel_err': rel, 'tol_rel': TOL['flash_fwd'],
            'bf16_step_excess': excess, 'lse_max_rel_err': lse_rel,
            'kernel_ms': ms, 'plain_ms': None, 'library_ms': lib_ms,
            'library': 'sdpa forward', 'bound_ms': b_ms, 'bound_by': b_by,
            'flops': flops, 'bytes': 2.0 * 4 * b * h * s * d + 4.0 * b * h * s}


def _flash_bwd_long(dev, gen, peaks, failures):
    """The bf16 dq and dk/dv kernels alone at b1 h8 s32768 d64 causal (the
    ``seqpar`` bf16 leg's long shape), from the forward kernel's lse and
    ``delta = sum(do * out)``, beside SDPA's autograd backward on the same
    inputs.  Each is held element by element to one bf16 step of its plain
    version (one plain call: ~5 (s, s) f32 matrices per slice, ~22 GB at
    the peak) and launched twice, bitwise equal.  Timed only, outside the
    kernels line's sums (``in_summary``).  ``bound_ms`` counts the
    function's products (6 d flops a live pair for dq, 8 d for dk/dv),
    ``bound_split_ms`` also the second bf16 half of p and ds that the
    kernels multiply (8 d, 12 d)."""
    from cxxnet_tpu_torch.ops.flash import (flash_dkv, flash_dkv_plain,
                                            flash_dq, flash_dq_plain,
                                            flash_fwd)
    b, h, d, s = SEQ_BF16['b'], SEQ_BF16['h'], SEQ_BF16['d'], SEQ_BF16_LONG
    bh = b * h
    q, k, v, do = (torch.randn((bh, s, d), device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    rows = []
    with torch.no_grad():
        out, lse = flash_fwd(q, k, v, True)
        delta = (do.float() * out.float()).sum(-1)
        del out
        args = (q, k, v, do, lse, delta, True)
        parts = {'dq': (lambda: (flash_dq(*args),),
                        lambda: (flash_dq_plain(*args),), 6.0, 8.0, 5),
                 'dkv': (lambda: flash_dkv(*args),
                         lambda: flash_dkv_plain(*args), 8.0, 12.0, 6)}
        results = {}
        for part, (kern, plain, fl, fl_split, nio) in parts.items():
            got = kern()
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, c) for a, c in zip(kern(), got))
            ref = plain()
            torch.cuda.synchronize()
            excess = max(step16_excess(g, r) for g, r in zip(got, ref))
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            del got, ref
            torch.cuda.empty_cache()
            results[part] = (excess, max(e[0] for e in errs),
                             max(e[1] for e in errs), repeat, finite,
                             time_ms(kern, 5))
        qs, ks, vs, dos = (x.view(b, h, s, d) for x in (q, k, v, do))
    lib_bwd = _sdpa_ms(qs, ks, vs, dos)[1]
    pairs = bh * s * (s + 1) / 2.0
    for part, (_, _, fl, fl_split, nio) in parts.items():
        excess, err, rel, repeat, finite, ms = results[part]
        name = f'flash_{part}_bf16'
        if not (excess <= 1.0 and repeat and finite):
            failures.append(f'{name}[s{s}]: {excess} of one bf16 step (tol '
                            f'1), two launches bitwise equal {repeat}, '
                            f'finite {finite}')
        nbytes = 2.0 * nio * bh * s * d + 8.0 * bh * s
        b_ms, b_by = bound(fl * pairs * d, nbytes, peaks, peaks[3])
        rows.append({'kernel': name, 'shape': f'b{b}h{h}s{s}d{d} causal',
                     'dtype': 'bfloat16', 'in_summary': False,
                     'max_abs_err': err, 'max_rel_err': rel,
                     'tol_rel': TOL[f'flash_{part}'],
                     'bf16_step_excess': excess, 'bitwise_repeat': repeat,
                     'kernel_ms': ms, 'plain_ms': None,
                     'library_ms': lib_bwd,
                     'library': 'sdpa autograd backward (dq, dk, dv '
                                'together)',
                     'bound_ms': b_ms, 'bound_by': b_by,
                     'bound_split_ms': bound(fl_split * pairs * d, nbytes,
                                             peaks, peaks[3])[0],
                     'flops': fl * pairs * d, 'bytes': nbytes})
    return rows


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _fwd_bwd(fn, inputs, w):
    """``fn`` forward over fresh leaves of ``inputs`` and the backward of
    ``sum(out * w)``: ``(out, [dq, dk, dv])``."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    (out * w).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _rel_errs(got, want):
    """max |got - want| / max |want| of out and each gradient."""
    return {name: rel_err(g, r)[1] for name, g, r in
            zip(('out', 'dq', 'dk', 'dv'), [got[0], *got[1]],
                [want[0], *want[1]])}


def _seq_inputs(shp, dtype, seed, s=None):
    b, h, d = shp['b'], shp['h'], shp['d']
    s = shp['s'] if s is None else s
    gen = torch.Generator(device='cuda').manual_seed(seed)
    qkv = [torch.randn((b, s, h, d), device='cuda', generator=gen)
           .to(dtype) for _ in range(3)]
    # the loss sum(out * cos(arange)) of tests/test_pallas_kernels.py
    w = torch.cos(torch.arange(b * s * h * d, device='cuda',
                               dtype=torch.float32)).reshape(b, s, h, d)
    return qkv, w.to(dtype)


def _bf16_path_reference(qkv, w, out_bf16):
    """The dense f32 autograd of ``sum(out * w)`` on bf16 ``qkv`` (causal),
    as ``[out, dq, dk, dv]``, with the backward's ``delta`` taken over the
    flash path's bf16 ``out_bf16`` as the flash backward takes it (and the
    JAX kernels), not over the reference's f32 out.  Both enter through
    ``ds = p (dp - delta)``, so dq and dk move by ``-scale (p ddelta) k``
    and ``-scale (p ddelta)^T q``; out and dv do not depend on delta."""
    from cxxnet_tpu_torch.parallel import attention_reference
    q, k, v = (x.float() for x in qkv)
    wf = w.float()
    out, (dq, dk, dv) = _fwd_bwd(
        lambda a, b, c: attention_reference(a, b, c, causal=True),
        (q, k, v), wf)
    scale = q.shape[-1] ** -0.5
    ddelta = ((wf * out_bf16.float()).sum(-1) - (wf * out).sum(-1))
    s = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    live = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
    p = torch.softmax(s.masked_fill(~live, -float('inf')), -1)
    p = p * ddelta.permute(0, 2, 1)[..., None]          # row i times ddelta_i
    dq = dq - scale * torch.einsum('bhqk,bkhd->bqhd', p, k)
    dk = dk - scale * torch.einsum('bhqk,bqhd->bkhd', p, q)
    return [out, dq, dk, dv]


def seqpar_phase(failures):
    """Sequence-parallel attention on the card: a 1-rank NCCL world and
    its ``('data', 'model')`` mesh, ``ulysses_attention`` at the LM's
    attention width with the gate engaged (the main path), against the
    dense reference's autograd; the gate off at s4096; the ring at
    s2048; the bf16 builds at the JAX probe's shapes."""
    from cxxnet_tpu_torch.ops.flash import attn_use_flash
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.parallel import (attention_reference, build_mesh,
                                           init_distributed, ring_attention,
                                           ulysses_attention)
    init_distributed(f'127.0.0.1:{_free_port()}', 1, 0)
    try:
        mesh = build_mesh()
        backend = torch.distributed.get_backend()
        b, s, h = SEQ['b'], SEQ['s'], SEQ['h']

        def ulysses(mode='auto'):
            return lambda q, k, v: ulysses_attention(
                q, k, v, mesh, 'data', causal=True, mode=mode)

        def dense(q, k, v):
            return attention_reference(q, k, v, causal=True)

        qkv, w = _seq_inputs(SEQ, torch.float32, SEED + 6)
        engaged = attn_use_flash(s, batch=b, heads=h, device='cuda')
        if not engaged:
            failures.append(f'seqpar: the gate did not engage at s{s}')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_call, call_ms = [], []
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        for _ in range(SEQ_CALLS):
            before = launch_counts()
            t0 = time.perf_counter()
            got = _fwd_bwd(ulysses(), qkv, w)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            after = launch_counts()
            per_call.append({n: after[n] - before[n] for n in after
                             if after[n] != before[n]})
        launches = launch_counts()
        # ----------------------------------------------------------------
        flash_peak = torch.cuda.max_memory_allocated()
        want_call = {'flash_fwd': 1, 'flash_dq': 1, 'flash_dkv': 1}
        for i, per in enumerate(per_call):
            if per != want_call:
                failures.append(f'seqpar: call {i} launched {per}, want '
                                f'{want_call}')

        # the dense leg: the reference's autograd at the same shape
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        dense_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            want = _fwd_bwd(dense, qkv, w)
            torch.cuda.synchronize()
            dense_ms.append((time.perf_counter() - t0) * 1e3)
        dense_peak = torch.cuda.max_memory_allocated()
        if sum(launch_counts().values()):
            failures.append('seqpar: the dense leg launched port kernels')
        errs = _rel_errs(got, want)
        for name, rel in errs.items():
            if not rel <= SEQPAR_TOL:
                failures.append(f'seqpar: {name} differs from the dense '
                                f'reference by {rel} > {SEQPAR_TOL}')
        if not flash_peak < dense_peak:
            failures.append(f'seqpar: flash leg peak {flash_peak} B not '
                            f'below the dense leg\'s {dense_peak} B')
        del got, want
        torch.cuda.empty_cache()

        # s4096: 1 GiB of dense scores, auto stays dense
        short = [x[:, :SEQ_DENSE_S].contiguous() for x in qkv]
        reset_launch_counts()
        out4 = _fwd_bwd(ulysses(), short, w[:, :SEQ_DENSE_S].contiguous())
        torch.cuda.synchronize()
        launches4 = sum(launch_counts().values())
        gate4 = attn_use_flash(SEQ_DENSE_S, batch=b, heads=h, device='cuda')
        if gate4 or launches4:
            failures.append(f'seqpar: s{SEQ_DENSE_S} gate {gate4}, '
                            f'{launches4} kernel launches (want dense)')
        if not all(torch.isfinite(t).all() for t in [out4[0], *out4[1]]):
            failures.append(f'seqpar: s{SEQ_DENSE_S} not finite')
        del out4, short

        # the ring over the same mesh at s2048
        ring_in = [x[:, :SEQ_RING_S].contiguous() for x in qkv]
        w2 = w[:, :SEQ_RING_S].contiguous()
        ring_errs = _rel_errs(
            _fwd_bwd(lambda q, k, v: ring_attention(q, k, v, mesh, 'data',
                                                    causal=True),
                     ring_in, w2),
            _fwd_bwd(dense, ring_in, w2))
        for name, rel in ring_errs.items():
            if not rel <= SEQPAR_TOL:
                failures.append(f'seqpar: ring {name} differs from the '
                                f'reference by {rel} > {SEQPAR_TOL}')
        del qkv, w, ring_in, w2
        torch.cuda.empty_cache()

        # ---- the bf16 builds: counts from 0, driven, read just after ----
        bq, bw = _seq_inputs(SEQ_BF16, torch.bfloat16, SEED + 7)
        lq, lw = _seq_inputs(SEQ_BF16, torch.bfloat16, SEED + 8,
                             s=SEQ_BF16_LONG)
        reset_launch_counts()
        got_b = _fwd_bwd(ulysses('on'), bq, bw)
        with torch.no_grad():
            long_out = ulysses()(*lq)
        torch.cuda.synchronize()
        launches_bf16 = launch_counts()
        # ----------------------------------------------------------------
        want_bf16 = {'flash_fwd_bf16': 2, 'flash_dq_bf16': 1,
                     'flash_dkv_bf16': 1}
        _check_launches('seqpar[bf16]', launches_bf16, want_bf16, failures)
        want_b = _fwd_bwd(dense, bq, bw)
        probe_err = (got_b[0].float() - want_b[0].float()).abs().max().item()
        if not probe_err < BF16_PROBE_ATOL:
            failures.append(f'seqpar[bf16]: forward differs from the dense '
                            f'bf16 reference by {probe_err} >= '
                            f'{BF16_PROBE_ATOL}')
        # the flash path sums in f32 and rounds out and each gradient once
        # to bf16, so each lies within one bf16 step of the dense f32
        # reference's autograd on the same bf16 values, element by element
        want_f = _bf16_path_reference(bq, bw, got_b[0])
        step_excess = {n: step16_excess(g, r) for n, g, r in
                       zip(('out', 'dq', 'dk', 'dv'), [got_b[0], *got_b[1]],
                           want_f)}
        for n, excess in step_excess.items():
            if not excess <= 1.0:
                failures.append(f'seqpar[bf16]: {n} is {excess} bf16 steps '
                                'from the dense f32 reference (tol 1)')
        long_finite = bool(torch.isfinite(long_out.float()).all())
        if not long_finite:
            failures.append(f'seqpar[bf16]: s{SEQ_BF16_LONG} forward not '
                            'finite')
        with torch.no_grad():
            long_ms = time_ms(lambda: ulysses()(*lq), 3)
        # forward + backward at s32768: the bf16 training step's attention
        long_fb_ms = time_ms(lambda: _fwd_bwd(ulysses(), lq, lw), 3)
        long_fb = _fwd_bwd(ulysses(), lq, lw)
        long_grads_finite = all(bool(torch.isfinite(t.float()).all())
                                for t in [long_fb[0], *long_fb[1]])
        if not long_grads_finite:
            failures.append(f'seqpar[bf16]: s{SEQ_BF16_LONG} forward + '
                            'backward not finite')
        bs, bh = SEQ_BF16['b'], SEQ_BF16['h']
        long_gate = attn_use_flash(SEQ_BF16_LONG, batch=bs, heads=bh,
                                   device='cuda')
        del got_b, want_b, want_f, lq, lw, long_out, long_fb
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    p50 = float(np.median(call_ms))
    return {'phase': 'seqpar', 'world': 1, 'mesh': [1, 1],
            'backend': backend, 'shape': dict(SEQ, causal=True,
                                             dtype='float32'),
            'gate_engaged': engaged, 'calls': SEQ_CALLS,
            'launches': launches, 'launches_per_call': per_call,
            'flash': {'ms_per_fwd_bwd': call_ms, 'ms_p50': p50,
                      'tokens_per_s': s / p50 * 1e3,
                      'max_memory_allocated': flash_peak},
            'dense': {'ms_per_fwd_bwd': dense_ms,
                      'tokens_per_s': s / dense_ms[-1] * 1e3,
                      'max_memory_allocated': dense_peak},
            'rel_err_vs_dense': errs, 'tol': SEQPAR_TOL,
            f's{SEQ_DENSE_S}': {'gate': gate4, 'launches': launches4},
            f'ring_s{SEQ_RING_S}': {'rel_err_vs_dense': ring_errs},
            'bf16': {'shape': dict(SEQ_BF16, causal=True), 'mode': 'on',
                     'launches': launches_bf16,
                     'max_abs_err_vs_dense_bf16': probe_err,
                     'probe_atol': BF16_PROBE_ATOL,
                     'bf16_step_excess_vs_dense_f32': step_excess,
                     f's{SEQ_BF16_LONG}': {
                         'gate': long_gate, 'forward_ms': long_ms,
                         'finite': long_finite, 'fwd_bwd_ms': long_fb_ms,
                         'fwd_bwd_finite': long_grads_finite}}}


# --- the LM training path -----------------------------------------------------

# bench.py's transformer cell (bench.py:479-500): the decoder above at seq
# 1024, batch 16, bf16, causal, one microbatch; seeded as bench.py:445-455
LM_TRAIN = dict(LM, seq_len=1024, causal=True, num_microbatches=1)
LM_TRAIN_BATCH, LM_TRAIN_LR, LM_TRAIN_STACKS = 16, 0.01, 4
LM_TRAIN_WARMUP, LM_TRAIN_STEPS, LM_TRAIN_LOOP = 3, 20, 4
# the mesh step against the multi step, and remat against none: the
# config of tests/test_torch_lm_train.py's MULTI case, with its bounds
# (JAX's test_multi_train_step_matches_mesh_step, test_remat_matches_no_remat)
LM_MESH = dict(vocab_size=32, d_model=16, num_heads=2, d_ff=32,
               num_stages=1, seq_len=8, num_microbatches=2)
LM_MESH_LR, LM_MESH_BATCH = 0.05, 4
LM_MESH_LOSS_RTOL, LM_MESH_PARAM_RTOL, LM_MESH_PARAM_ATOL = 1e-5, 2e-5, 2e-6
LM_REMAT_RTOL = 1e-6


def lm_step_flops(cfg, batch: int) -> float:
    """Model FLOPs of one training step, from the shapes: per block the
    four d x d projections and the FFN's two, 2 T (4 d^2 + 2 d f) over T =
    batch x seq tokens, and dense attention counted whole, 4 b h s^2 hd
    (QK^T and PV); the head's 2 T d V; the backward twice the forward."""
    s, d, f = cfg.seq_len, cfg.d_model, cfg.d_ff
    h, v = cfg.num_heads, cfg.vocab_size
    tokens = batch * s
    block = 2 * tokens * (4 * d * d + 2 * d * f) + 4 * batch * h * s * s * (
        d // h)
    return 3.0 * (cfg.num_stages * block + 2 * tokens * d * v)


def _lm_train_inputs(cfg, batch, rng):
    """bench.py's token and label stacks, (nstack, batch, seq) on the card."""
    shape = (LM_TRAIN_STACKS, batch, cfg.seq_len)
    return [torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
            for _ in range(2)]


def _max_rel(a, b):
    """max over leaves of max |a - b| / max |b|."""
    from cxxnet_tpu_torch.models.transformer import _leaves
    return max(rel_err(x, y)[1] for x, y in zip(_leaves(a), _leaves(b)))


def _lm_mesh_checks(failures):
    """In a 1-rank NCCL world and its (1, 1, 1, 1) mesh: the mesh step
    against the multi step at the small shape, remat against none there,
    and the peak memory of one full-width mesh step (one block, the pipe
    axis's one stage) with remat off and on."""
    import dataclasses

    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.parallel import init_distributed
    init_distributed(f'127.0.0.1:{_free_port()}', 1, 0)
    try:
        mesh = T.build_transformer_mesh(1, 1, 1, 1, 1)
        cfg = T.TransformerConfig(**LM_MESH)
        rng = np.random.RandomState(7)
        tok = rng.randint(0, cfg.vocab_size, (LM_MESH_BATCH, cfg.seq_len))
        lab = rng.randint(0, cfg.vocab_size, (LM_MESH_BATCH, cfg.seq_len))

        def fresh(c):
            return T.init_params(np.random.RandomState(0), c, device='cuda')
        a, loss_a, _ = T.make_train_step(cfg, mesh, lr=LM_MESH_LR)(
            fresh(cfg), tok, lab)
        b, loss_b = T.make_multi_train_step(cfg, 1, lr=LM_MESH_LR)(
            fresh(cfg), tok[None], lab[None])
        loss_rel = abs(loss_a.item() - loss_b.item()) / abs(loss_b.item())
        params_ok = all(torch.allclose(x, y, rtol=LM_MESH_PARAM_RTOL,
                                       atol=LM_MESH_PARAM_ATOL)
                        for x, y in zip(T._leaves(a), T._leaves(b)))
        if not (loss_rel <= LM_MESH_LOSS_RTOL and params_ok):
            failures.append(f'lm_train: mesh step differs from the multi '
                            f'step (loss rel {loss_rel}, params within '
                            f'rtol {LM_MESH_PARAM_RTOL}: {params_ok})')
        remat_cfg = dataclasses.replace(cfg, remat=True)
        r, loss_r, _ = T.make_train_step(remat_cfg, mesh, lr=LM_MESH_LR)(
            fresh(cfg), tok, lab)
        remat_rel = abs(loss_r.item() - loss_a.item()) / abs(loss_a.item())
        remat_ok = all(torch.allclose(x, y, rtol=LM_REMAT_RTOL, atol=0)
                       for x, y in zip(T._leaves(r), T._leaves(a)))
        if not (remat_rel <= LM_REMAT_RTOL and remat_ok):
            failures.append(f'lm_train: remat differs from no remat (loss '
                            f'rel {remat_rel}, params equal: {remat_ok})')
        small = {'shape': dict(LM_MESH, batch=LM_MESH_BATCH,
                               dtype='float32'),
                 'loss_mesh': loss_a.item(), 'loss_multi': loss_b.item(),
                 'loss_rel': loss_rel, 'param_max_rel': _max_rel(a, b),
                 'loss_remat': loss_r.item(), 'remat_loss_rel': remat_rel,
                 'remat_param_max_rel': _max_rel(r, a),
                 'tol': {'loss_rtol': LM_MESH_LOSS_RTOL,
                         'param_rtol': LM_MESH_PARAM_RTOL,
                         'param_atol': LM_MESH_PARAM_ATOL,
                         'remat_rtol': LM_REMAT_RTOL}}
        del a, b, r

        # full width, one block: what remat saves
        wide = T.TransformerConfig(dtype=torch.bfloat16,
                                   **dict(LM_TRAIN, num_stages=1))
        toks, labs = _lm_train_inputs(wide, LM_TRAIN_BATCH,
                                      np.random.RandomState(1))
        full = {}
        for remat in (False, True):
            params = T.init_params(np.random.RandomState(0), wide,
                                   device='cuda')
            step = T.make_train_step(dataclasses.replace(wide, remat=remat),
                                     mesh, lr=LM_TRAIN_LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, loss, _ = step(params, toks[0], labs[0])
            torch.cuda.synchronize()
            full[f'remat_{remat}'] = {
                'loss': loss.item(),
                'ms': (time.perf_counter() - t0) * 1e3,
                'max_memory_allocated': torch.cuda.max_memory_allocated()}
            del params
            torch.cuda.empty_cache()
        if full['remat_True']['loss'] != full['remat_False']['loss']:
            failures.append('lm_train: full-width remat changed the '
                            f'forward loss ({full})')
        if not (full['remat_True']['max_memory_allocated']
                < full['remat_False']['max_memory_allocated']):
            failures.append(f'lm_train: remat saved no memory ({full})')
        full['shape'] = dict(LM_TRAIN, num_stages=1, batch=LM_TRAIN_BATCH,
                             dtype='bfloat16')
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    return {'backend': backend, 'mesh': [1, 1, 1, 1],
            'mesh_vs_multi': small, 'full_width_one_block': full}


def lm_train_phase(peaks, failures):
    """The TransformerLM training step at bench.py's width: 3 warm-up and
    20 timed ``make_multi_train_step`` steps of the 8-block bf16 decoder,
    one 4-step call, two profiled steps, then the mesh checks of
    :func:`_lm_mesh_checks`.
    No kernel of ``ops/`` may launch (JAX's step reaches no Pallas
    kernel)."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    cfg = T.TransformerConfig(dtype=torch.bfloat16, **LM_TRAIN)
    rng = np.random.RandomState(0)
    params = T.init_params(rng, cfg, device='cuda')
    toks, labs = _lm_train_inputs(cfg, LM_TRAIN_BATCH, rng)
    one = T.make_multi_train_step(cfg, 1, lr=LM_TRAIN_LR)
    flops = lm_step_flops(cfg, LM_TRAIN_BATCH)
    tokens = LM_TRAIN_BATCH * cfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms, event_ms = [], [], []
    # ---- the main path: counts from 0, driven, read just after ----------
    reset_launch_counts()
    for i in range(LM_TRAIN_WARMUP + LM_TRAIN_STEPS):
        j = slice(i % LM_TRAIN_STACKS, i % LM_TRAIN_STACKS + 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, loss = one(params, toks[j], labs[j])
        end.record()
        torch.cuda.synchronize()
        if i >= LM_TRAIN_WARMUP:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    loop = T.make_multi_train_step(cfg, LM_TRAIN_LOOP, lr=LM_TRAIN_LR)
    t0 = time.perf_counter()
    params, loop_loss = loop(params, toks, labs)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / LM_TRAIN_LOOP
    launches = launch_counts()
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    losses.append(loop_loss.item())
    profile = profile_steps(lambda i: one(params, toks[i:i + 1],
                                          labs[i:i + 1]))
    del params, toks, labs
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        failures.append(f'lm_train: a loss is not finite: {losses}')
    if any(launches.values()):
        failures.append(f'lm_train: the training step launched port '
                        f'kernels: {launches}')
    reset_launch_counts()
    mesh = _lm_mesh_checks(failures)
    mesh_launches = launch_counts()
    if any(mesh_launches.values()):
        failures.append(f'lm_train: the mesh step launched port kernels: '
                        f'{mesh_launches}')
    p50 = float(np.median(host_ms))
    ev50 = float(np.median(event_ms))
    bound_ms = flops / peaks[3] * 1e3
    return {'phase': 'lm_train',
            'shape': dict(LM_TRAIN, batch=LM_TRAIN_BATCH, dtype='bfloat16',
                          lr=LM_TRAIN_LR),
            'entry': 'make_multi_train_step', 'launches': launches,
            'warmup_steps': LM_TRAIN_WARMUP, 'steps': LM_TRAIN_STEPS,
            'step_ms_host': host_ms, 'step_ms_events': event_ms,
            'step_ms_p50': p50, 'step_ms_events_p50': ev50,
            'step_ms_spread': [min(host_ms), max(host_ms)],
            'step_ms_events_spread': [min(event_ms), max(event_ms)],
            f'loop{LM_TRAIN_LOOP}_ms_per_step': loop_ms,
            'tokens_per_step': tokens, 'tokens_per_s': tokens / p50 * 1e3,
            'model_flops_per_step': flops,
            'achieved_tflops': flops / p50 * 1e-9,
            'share_of_bf16_peak': bound_ms / p50,
            'bf16_peak_flops': peaks[3], 'bound_ms': bound_ms,
            'max_memory_allocated': peak,
            'loss_first': losses[0], 'loss_last': losses[-1],
            'losses': losses, 'profile': profile, 'mesh': mesh,
            'mesh_launches': mesh_launches}


# --- the telemetry phase (obs/, utils/profiler.py) ----------------------------

#: the reference conf's telemetry leg: batch 128 over the 640 synthesized
#: training images gives 5 steps a round; 2 rounds, so the second round's
#: sampler reads the first round's train gauges
OBS_BATCH, OBS_ROUNDS = 128, 2
OBS_PROFILE = (3, 5)                   # profile_start_batch, _stop_batch
OBS_TRAIN_KEYS = ('obs.port=0', 'obs.hbm=1', 'obs.profile=1',
                  'obs.sample_every=0.1',
                  'slo.step=train.steps_per_sec>0.01@2')
OBS_ROUTES = ('/metrics', '/statusz', '/healthz', '/slos', '/programs')
#: the serve leg: full-width AlexNet (f32) behind a PredictEngine and a
#: DynamicBatcher, requests of mixed sizes from client threads
OBS_SERVE_BUCKETS, OBS_SERVE_REQUESTS, OBS_SERVE_CLIENTS = \
    (1, 8, 64, 256), 24, 4
#: the decode leg: the decode phase's LM at its width, 2 blocks; 4 system
#: prompts of 32 tokens a turn of 8 each; a slow_step stalls the loop
OBS_DECODE = dict(requests=16, groups=4, system=32, turn=8, max_new=24,
                  slow_step=16, slow_s=1.5, token_slo_ms=1000.0,
                  kv_hit_floor=0.25)

#: the port's kernels by ``__global__`` symbol (longest first, so a bf16
#: symbol is never read as its f32 prefix) -> ``ops/launches`` name
KERNEL_SYMBOLS = (
    ('conv_bias_act_bf16_kernel', 'conv_bias_act'),
    ('fullc_gemm_nt_bf16_kernel', 'fullc_gemm_nt'),
    ('fullc_gemm_tn_bf16_kernel', 'fullc_gemm_tn'),
    ('fullc_gemm_bf16_kernel', 'fullc_gemm'),
    ('conv_bias_act_kernel', 'conv_bias_act'),
    ('fullc_gemm_nt_kernel', 'fullc_gemm_nt'),
    ('fullc_gemm_tn_kernel', 'fullc_gemm_tn'),
    ('fullc_gemm_kernel', 'fullc_gemm'),
    ('lrn_fwd_kernel', 'lrn_forward'), ('lrn_bwd_kernel', 'lrn_backward'),
    ('threefry_uniform_kernel', 'threefry_uniform'),
    ('paged_decode_kernel', 'paged_flash_decode'),
    ('paged_verify_kernel', 'paged_flash_verify'),
    ('int8_gemm_kernel', 'int8_matmul'),
    ('flash_fwd_wgmma_kernel', 'flash_fwd'),
    ('flash_dq_wgmma_kernel', 'flash_dq'),
    ('flash_dkv_wgmma_kernel', 'flash_dkv'),
    ('flash_fwd_kernel', 'flash_fwd'), ('flash_dq_kernel', 'flash_dq'),
    ('flash_dkv_kernel', 'flash_dkv'))


def launch_name(symbol: str):
    """The ``ops/launches`` name a traced kernel symbol counts under, or
    None for a kernel not the port's.  A 16-bit build counts by its
    template's element type: ``__half`` is f16; bf16 is ``unsigned
    short`` (its bits) or ``__nv_bfloat16``, and a ``*_bf16_kernel``
    not on ``__half`` is bf16; the threefry draws of every dtype count
    as one."""
    for sym, name in KERNEL_SYMBOLS:
        if sym in symbol:
            break
    else:
        return None
    if name in ('threefry_uniform', 'int8_matmul'):
        return name
    if '__half' in symbol:
        return name + '_f16'
    if ('unsigned short' in symbol or 'bfloat16' in symbol
            or '_bf16_kernel' in symbol):
        return name + '_bf16'
    return name


def trace_kernel_counts(path, symbols=None, diagnosis=None):
    """Kernel events of a Chrome trace by ``launch_name``, plus the other
    kernels' total; ``symbols`` (a dict) collects each port kernel's
    symbols, cut to 160 characters; ``diagnosis`` (a dict) gets where
    the device events fall in the profiler's window and how far CUPTI's
    clock stands from the host's: the host-side launch events (runtime
    and driver API) and those whose correlation id has no kernel event
    (a launch traced without its kernel was lost on the device side;
    the first and last such launch after the window's start), the
    ``utils/profiler.WARM_KERNELS`` traced, the first kernel's start
    after the window's start and the last kernel's end before the
    window's end (Kineto keeps only device events inside the window, by
    their CUPTI timestamps), and, over the runtime calls
    made inside a host-side operator (linked by ``External id``), how far
    the calls' CUPTI times fall before their operator's start
    (``cupti_lag_us``) or after its end (``cupti_lead_us``): on one
    clock both are 0 or below."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    counts, other, corr = {}, 0, set()
    for e in events:
        if e.get('cat') != 'kernel':
            continue
        corr.add(e.get('args', {}).get('correlation'))
        name = launch_name(e.get('name', ''))
        if name is None:
            other += 1
        else:
            counts[name] = counts.get(name, 0) + 1
            if symbols is not None:
                symbols.setdefault(name, set()).add(e['name'][:160])
    if diagnosis is not None:
        kernels = [e for e in events if e.get('cat') == 'kernel']
        launches = [e for e in events
                    if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                    and 'aunch' in e.get('name', '')]
        marks = {e['name']: e['ts'] for e in events if e.get('ph') == 'i'}
        t0 = marks.get('Iteration Start: PyTorch Profiler')
        t1 = marks.get('Record Window End')
        ops = {e['args']['External id']: e for e in events
               if e.get('cat') == 'cpu_op'
               and 'External id' in e.get('args', {})}
        linked = [(ops[e['args']['External id']], e) for e in events
                  if e.get('cat') == 'cuda_runtime'
                  and e.get('args', {}).get('External id') in ops]
        orphans = [e['ts'] - (t0 or 0) for e in launches
                   if e.get('args', {}).get('correlation') not in corr]
        diagnosis.update({
            'launch_events': len(launches), 'kernel_events': len(kernels),
            'launches_without_kernel': len(orphans),
            'orphans_us_after_start': [round(min(orphans), 1),
                                       round(max(orphans), 1)]
            if orphans and t0 is not None else None,
            'warm_kernels': sum('spin_kernel' in e.get('name', '')
                                for e in kernels),
            'start_to_first_kernel_us': None if t0 is None or not kernels
            else round(min(e['ts'] for e in kernels) - t0, 1),
            'last_kernel_end_to_stop_us': None if t1 is None or not kernels
            else round(t1 - max(e['ts'] + e.get('dur', 0)
                                for e in kernels), 1),
            'linked_runtime_calls': len(linked),
            'cupti_lag_us': round(max(
                (op['ts'] - rt['ts'] for op, rt in linked), default=0), 1),
            'cupti_lead_us': round(max(
                (rt['ts'] + rt.get('dur', 0) - op['ts'] - op.get('dur', 0)
                 for op, rt in linked), default=0), 1)})
    return counts, other


def _imgbin_workdir(root, env, failures, tag):
    """The ``cli_imgbin`` phase's dataset under ``root`` (the seeded
    images, their ``.lst`` files and the packs of the port's im2bin) and
    the run directory ``root/run/ImageNet`` with the reference
    ``ImageNet.conf`` and an empty ``models``: ``(run directory, seconds
    the dataset took)``."""
    t0 = time.perf_counter()
    _synth_images(root, 'NameList.train', IMGBIN['train'], IMGBIN['seed'])
    _synth_images(root, 'NameList.test', IMGBIN['test'], IMGBIN['seed'] + 1)
    packs = [subprocess.Popen(
        [sys.executable, '-m', 'cxxnet_tpu_torch.io.im2bin', lst, 'img',
         bin_], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for lst, bin_ in (('NameList.train', 'TRAIN.BIN'),
                          ('NameList.test', 'TEST.BIN'))]
    for p in packs:
        text, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            failures.append(f'{tag}: im2bin exit {p.returncode}: '
                            f'{text[-2000:]}')
    seconds = time.perf_counter() - t0
    work = os.path.join(root, 'run', 'ImageNet')
    os.makedirs(os.path.join(work, 'models'))
    shutil.copy(os.path.join(ROOT, 'example', 'ImageNet', 'ImageNet.conf'),
                work)
    return work, seconds


def _get(url, timeout=30):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _prom(text):
    """``{series{labels}: value}`` of a Prometheus text body."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith('#'):
            key, _, val = ln.rpartition(' ')
            out[key] = float(val)
    return out


def _fresh_obs():
    """A fresh telemetry hub and program ledger for one leg."""
    from cxxnet_tpu_torch.obs import TelemetryHub, install_hub
    from cxxnet_tpu_torch.obs import programs
    hub = TelemetryHub()
    install_hub(hub)
    programs.install_ledger(programs.ProgramLedger())
    return hub


def _dispatch_gaps_ms(events):
    """Start-to-start ms of consecutive ``train.dispatch`` spans of one
    round (the update index rising by one), and their p50."""
    spans = sorted((e for e in events if e['name'] == 'train.dispatch'),
                   key=lambda e: e['t_start_ns'])
    gaps = [(b['t_start_ns'] - a['t_start_ns']) / 1e6
            for a, b in zip(spans, spans[1:])
            if b['attrs']['update'] == a['attrs']['update'] + 1]
    return {'gaps_ms': gaps,
            'p50_ms': float(np.median(gaps)) if gaps else None}


class _Scraper(threading.Thread):
    """Scrapes every route of the CLI's telemetry endpoint while the run
    is live: once the ledger holds the first step's row, and once more
    during the trace window, where ``/profile`` must answer busy."""

    def __init__(self, port_file, done):
        super().__init__(daemon=True, name='smoke-obs-scraper')
        self.port_file, self.done = port_file, done
        self.live, self.busy, self.errors = None, None, []

    def run(self):
        from cxxnet_tpu_torch.utils import profiler
        try:
            while not os.path.exists(self.port_file):
                if self.done.wait(0.01):
                    return
            base = f'http://127.0.0.1:{int(open(self.port_file).read())}'
            while not self.done.is_set() and (self.live is None
                                              or self.busy is None):
                if self.live is None:
                    progs = json.loads(_get(base + '/programs'))
                    if any(p['name'] == 'train.step'
                           for p in progs['programs']):
                        self.live = {r: _get(base + r).decode()
                                     for r in OBS_ROUTES}
                        self.live['t'] = time.perf_counter()
                if self.busy is None \
                        and profiler.trace_owner() == 'profile_dir':
                    self.busy = json.loads(_get(base + '/profile?ms=100'))
                time.sleep(0.005)
        except Exception:  # noqa: BLE001 — reported as the leg's failure
            import traceback
            self.errors.append(traceback.format_exc())


def _obs_train_leg(work, failures):
    """The reference ``ImageNet.conf`` through the CLI's ``main`` in this
    process, with telemetry and without: the live scrape, the profiler's
    kernel events against the launch counters over its window, the
    ``hbm.*`` gauges, ``train-mfu``, the ``[N]`` lines byte-equal, one
    ``train.dispatch`` span a step, the dispatch p50 both ways."""
    from cxxnet_tpu_torch.obs import programs
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    prof_dir = os.path.join(work, 'prof')
    trace = os.path.join(work, 'obs_trace.json')
    port_file = os.path.join(work, 'obs.port')
    base = ['ImageNet.conf', f'num_round={OBS_ROUNDS}',
            f'max_round={OBS_ROUNDS}', f'batch_size={OBS_BATCH}',
            'save_model=0', 'model_dir=models_obs']
    on = [*OBS_TRAIN_KEYS, f'profile_dir={prof_dir}',
          f'profile_start_batch={OBS_PROFILE[0]}',
          f'profile_stop_batch={OBS_PROFILE[1]}', f'obs.trace_export={trace}']
    steps = OBS_ROUNDS * (IMGBIN['train'] // OBS_BATCH)
    out = {'conf': "example/ImageNet/ImageNet.conf (compute_type=bfloat16)",
           'args': ' '.join(base + on), 'steps': steps,
           'order': 'off (warm-up), on, off'}
    runs = {}
    for leg in ('warm', 'on', 'off'):
        hub = _fresh_obs()
        done = threading.Event()
        scraper = None
        if leg == 'on':
            os.environ['CXXNET_OBS_PORT_FILE'] = port_file
            scraper = _Scraper(port_file, done)
            scraper.start()
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        try:
            rc, so, se, wall = _cli_in_process(base + (on if leg == 'on'
                                                       else []), work)
        finally:
            os.environ.pop('CXXNET_OBS_PORT_FILE', None)
            done.set()
        launches = launch_counts()
        # ------------------------------------------------------------------
        if scraper is not None:
            scraper.join(30)
        runs[leg] = {'rc': rc, 'seconds': wall, 'launches': launches,
                     'stdout': [ln for _, ln in so],
                     'stderr': [ln for _, ln in se],
                     'dispatch': _dispatch_gaps_ms(hub.events()),
                     'scraper': scraper, 'peak': programs.peak_flops(0)}
        if rc != 0:
            failures.append(f'obs[train_{leg}]: exit {rc}: '
                            + '\n'.join(ln for _, ln in se[-30:]))
    on_run, off_run = runs['on'], runs['off']
    evals = {k: [ln for ln in r['stderr'] if ln.startswith('[')]
             for k, r in runs.items()}
    out['eval_lines'] = evals['on']
    if len(evals['on']) != OBS_ROUNDS or not (
            evals['warm'] == evals['on'] == evals['off']):
        failures.append(f'obs[train]: eval lines with telemetry '
                        f'{evals["on"]} vs without {evals["off"]} '
                        f'(warm-up {evals["warm"]})')
    # ---- the MFU line ---------------------------------------------------------
    speed = [_eval_fields('\t' + ln) for ln in on_run['stderr']
             if ln.startswith('train-')]
    out['train_lines'] = speed
    peak = on_run['peak']
    out['peak_flops'] = peak
    if len(speed) != OBS_ROUNDS or peak <= 0:
        failures.append(f'obs[train]: {len(speed)} train- lines, peak '
                        f'{peak}')
    else:
        last = speed[-1]
        mfu = last.get('train-mfu')
        out['mfu'] = mfu
        out['flops_per_step'] = last.get('train-flops_per_step')
        out['steps_per_sec'] = last.get('train-steps_per_sec')
        if mfu is None or not 0.0 < mfu < 1.0:
            failures.append(f'obs[train]: train-mfu {mfu}')
        else:
            want = out['flops_per_step'] * out['steps_per_sec'] / peak
            if abs(mfu - want) > 1e-5 + 1e-3 * want:
                failures.append(f'obs[train]: train-mfu {mfu} vs '
                                f'flops x steps/s / peak {want}')
    # ---- the live scrape --------------------------------------------------------
    sc = on_run['scraper']
    out['scrape_errors'] = sc.errors
    if sc.errors or sc.live is None:
        failures.append(f'obs[train]: no live scrape: {sc.errors}')
    else:
        met = _prom(sc.live['/metrics'])
        st = json.loads(sc.live['/statusz'])
        # the exact values from /statusz (/metrics prints 6 digits)
        got = st['stats'].get('hbm', {})
        hbm = {k: got.get(f'{k}[d0]') for k in (
            'bytes_in_use', 'peak_bytes', 'limit_bytes', 'headroom_frac')}
        hbm['supported'] = got.get('supported')
        total = torch.cuda.mem_get_info(0)[1]
        out['hbm'] = dict(hbm, mem_get_info_total=total,
                          metrics_supported=met.get('cxxnet_hbm_supported'))
        if not (hbm['supported'] == 1
                and met.get('cxxnet_hbm_supported') == 1
                and hbm['bytes_in_use'] is not None
                and 0 < hbm['bytes_in_use'] <= hbm['peak_bytes']
                <= hbm['limit_bytes'] == total):
            failures.append(f'obs[train]: hbm gauges {hbm}, total {total}')
        progs = json.loads(sc.live['/programs'])
        out['live'] = {
            'routes': {r: len(sc.live[r]) for r in OBS_ROUTES},
            'healthz': sc.live['/healthz'].strip(),
            'execution_plan': st['status'].get('execution_plan'),
            'programs': [(p['name'], p['shape_key'], p['flops'],
                          p['argument_bytes'], p['compile_ms'])
                         for p in progs['programs']],
            'metric_series': len(met)}
        if sc.live['/healthz'].strip() != 'ok' \
                or 'step' not in json.loads(sc.live['/slos']):
            failures.append(f'obs[train]: healthz '
                            f'{sc.live["/healthz"]!r}, slos '
                            f'{sc.live["/slos"][:200]}')
    out['profile_busy'] = sc.busy
    if not sc.busy or sc.busy.get('busy') != 'profile_dir':
        failures.append(f'obs[train]: /profile during the trace window '
                        f'answered {sc.busy}')
    # ---- the profiler against the launch counters ---------------------------------
    pid = os.getpid()
    tpath = os.path.join(prof_dir, f'trace_{pid}.json')
    lpath = os.path.join(prof_dir, f'launches_{pid}.json')
    if not (os.path.exists(tpath) and os.path.exists(lpath)):
        failures.append(f'obs[train]: no trace window files in {prof_dir}: '
                        f'{os.listdir(prof_dir) if os.path.isdir(prof_dir) else None}')
    else:
        symbols, diagnosis = {}, {}
        traced, other = trace_kernel_counts(tpath, symbols, diagnosis)
        with open(lpath) as f:
            window = json.load(f)
        counted = window['launches']
        out['profiler'] = {'window': list(OBS_PROFILE), 'traced': traced,
                           'counted': counted, 'other_kernels': other,
                           'trace_bytes': os.path.getsize(tpath),
                           'stop_ms': window.get('stop_ms'),
                           'symbols': {k: sorted(v)
                                       for k, v in symbols.items()},
                           'diagnosis': diagnosis,
                           'equal': traced == counted}
        if traced != counted or not counted:
            failures.append(f'obs[train]: profiler kernel events {traced} '
                            f'vs the launch counters {counted}')
    # ---- the exported spans ---------------------------------------------------------
    if os.path.exists(trace):
        with open(trace) as f:
            ev = json.load(f)['traceEvents']
        n = sum(e['name'] == 'train.dispatch' for e in ev)
        out['dispatch_spans'] = n
        if n != steps:
            failures.append(f'obs[train]: {n} train.dispatch spans, want '
                            f'{steps}')
    else:
        failures.append('obs[train]: no obs.trace_export file')
    slo_lines = [ln for ln in on_run['stdout'] if ln.startswith('obs: slo')]
    out['slo_lines'] = slo_lines
    if not slo_lines or 'step: OK' not in slo_lines[0] \
            or 'NO DATA' in slo_lines[0]:
        failures.append(f'obs[train]: slo exit lines {slo_lines}')
    out['launches'] = on_run['launches']
    if not (runs['warm']['launches'] == on_run['launches']
            == off_run['launches']):
        failures.append(f'obs[train]: launches differ with telemetry: '
                        f'{on_run["launches"]} vs {off_run["launches"]}')
    out['seconds'] = {k: r['seconds'] for k, r in runs.items()}
    out['dispatch_p50_ms'] = {k: r['dispatch']['p50_ms']
                              for k, r in runs.items()}
    out['dispatch_gaps_ms'] = {k: r['dispatch']['gaps_ms']
                               for k, r in runs.items()}
    return out


def _obs_serve_leg(failures):
    """Full-width AlexNet (f32) behind a ``PredictEngine`` and a
    ``DynamicBatcher`` under mixed-size requests from client threads:
    each request's trace id on the client's and the worker's thread,
    the bucket rows of the ledger, no recompile, the batcher's gauges on
    ``/metrics``, one on-demand ``/profile`` window on the card."""
    from cxxnet_tpu_torch.obs import programs
    from cxxnet_tpu_torch.obs.endpoints import ObsServer
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve import DynamicBatcher, PredictEngine
    hub = _fresh_obs()
    prev = programs._PROFILE
    programs._PROFILE = programs.ProfilerSession()
    make = _net_maker(_example_conf('ImageNet.conf'), ('batch_size', '256'))
    net = make()
    eng = PredictEngine(net.trainer, OBS_SERVE_BUCKETS)
    bat = DynamicBatcher(eng, max_queue=64, max_wait=0.002, deadline=120.0)
    bat.register_into(hub)
    rng = np.random.RandomState(SEED + 71)
    sizes = [int(s) for s in rng.choice([1, 3, 8, 17, 64, 200],
                                        OBS_SERVE_REQUESTS)]
    x = rng.randn(max(sizes), 3, 227, 227).astype(np.float32)
    reqs, errors = [], []
    with tempfile.TemporaryDirectory() as d:
        srv = ObsServer(hub, port=0, profile_dir=d)
        try:
            eng.warm()
            prof = json.loads(_get(f'{srv.url}/profile?ms=1500'))

            def client(i):
                for n in sizes[i::OBS_SERVE_CLIENTS]:
                    try:
                        r = bat.submit_async(x[:n])
                        bat.wait(r)
                        reqs.append(r)
                    except Exception as e:  # noqa: BLE001 — reported
                        errors.append(repr(e))

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(OBS_SERVE_CLIENTS)]
            # ---- the main path: counts from 0, driven, read just after --
            reset_launch_counts()
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(600)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = launch_counts()
            # ----------------------------------------------------------------
            metrics = _get(f'{srv.url}/metrics').decode()
            deadline = time.monotonic() + 60
            while programs._PROFILE.status()['active'] \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            pstat = programs._PROFILE.status()
            ptrace = os.path.join(prof.get('path', d), 'trace.json')
            pkernels = trace_kernel_counts(ptrace)[0] \
                if os.path.exists(ptrace) else None
        finally:
            srv.close(timeout=10.0)
            bat.close(timeout=30.0)
            programs._PROFILE = prev
    # the launches the batcher's forwards must make: each bucket's forward
    # once more, outside the main path's counts, times its batches
    batches = {b: int(bat.stats.get(f'batches[b{b}]'))
               for b in OBS_SERVE_BUCKETS}
    want = {}
    for b, n in batches.items():
        reset_launch_counts()
        eng.predict_scores(np.zeros((b,) + x.shape[1:], np.float32))
        for name, cnt in launch_counts().items():
            want[name] = want.get(name, 0) + n * cnt
    _check_launches('obs[serve]', launches, want, failures)
    led = programs.get_ledger()
    rows = [(p['name'], p['shape_key'], p['flops'], p['calls'])
            for p in led.view()['programs'] if p['name'] == 'serve.predict']
    events = hub.events()
    threads_per_req = []
    for r in reqs:
        mine = [e for e in events if e['trace_id'] == r.trace_id]
        names = {e['name'] for e in mine}
        threads_per_req.append(len({e['thread'] for e in mine}))
        if not {'serve.admit', 'serve.queue', 'serve.finish'} <= names:
            errors.append(f'request {r.trace_id}: events {sorted(names)}')
    checks = {'answered': len(reqs) == OBS_SERVE_REQUESTS and not errors,
              'trace_ids_across_threads': bool(threads_per_req)
              and min(threads_per_req) >= 2,
              'bucket_rows': sorted(k for _, k, _, _ in rows)
              == sorted(f'b{b}' for b in OBS_SERVE_BUCKETS),
              'no_recompile': led.recompiles_total == 0
              and eng.compile_count == len(OBS_SERVE_BUCKETS),
              # the allocator's blocks hold at least the tree's elements
              'ledger_bytes': (eng.ledger_bytes() or 0)
              >= eng.resident_bytes() > 0,
              'serve_gauges': 'cxxnet_serve_queue_depth' in metrics,
              'profile': bool(prof.get('started'))
              and pstat['last_error'] is None and bool(pkernels)}
    for name, ok in checks.items():
        if not ok:
            failures.append(f'obs[serve]: check {name} failed '
                            f'({errors[:3]}, {prof}, {pstat})')
    nbytes = {'ledger': eng.ledger_bytes(), 'resident': eng.resident_bytes()}
    del net, eng
    torch.cuda.empty_cache()
    return {'buckets': list(OBS_SERVE_BUCKETS), 'requests': len(reqs),
            'rows': int(sum(sizes)), 'seconds': wall,
            'images_per_s': sum(sizes) / wall, 'checks': checks,
            'ledger_rows': rows, 'profile': {'request': prof, 'status': pstat,
                                              'kernels': pkernels},
            'bytes': nbytes, 'batches': batches, 'launches': launches}


def _obs_decode_leg(failures):
    """The decode phase's LM (2 blocks) behind ``DecodeService`` with
    prefix sharing and a host KV tier, on a hub with a gauge sampler and
    two SLOs: ``kv.hit_rate`` (OK) and ``decode.token_ms.p99``, which a
    ``slow_step`` stall drives to BREACHED — the armed flight recorder
    writes exactly one dump; streams stay their ``generate`` twins; the
    paged decode kernel launches once a block a step.  The sampler ticks
    at set times over the settled gauges after the traffic (a live
    sampler would see the index's first misses, hit rate 0, and breach
    ``kv_hit`` as the traffic starts)."""
    from cxxnet_tpu_torch.models import transformer as T
    from cxxnet_tpu_torch.obs import history, slo
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.runtime import faults
    from cxxnet_tpu_torch.serve.decode import DecodeService
    c = OBS_DECODE
    hub = _fresh_obs()
    cfg = T.TransformerConfig(**dict(LM, num_stages=FLEET_LM_STAGES))
    params = T.init_params(np.random.RandomState(SEED + 81), cfg)
    rng = np.random.RandomState(SEED + 82)
    systems = [rng.randint(0, cfg.vocab_size, c['system'])
               for _ in range(c['groups'])]
    prompts = [np.concatenate([systems[i % c['groups']],
                               rng.randint(0, cfg.vocab_size, c['turn'])])
               .astype(np.int32)[None] for i in range(c['requests'])]
    with tempfile.TemporaryDirectory() as d:
        hub.arm_flight_recorder(d)
        svc = DecodeService(params, cfg, **dict(DECODE, max_new_bound=32),
                            deadline=600.0, prefix_share=32, kv_host_mb=8,
                            flash_decode='auto', device='cuda')
        svc.register_into(hub)
        sampler = history.GaugeSampler(hub.gauge_snapshot, period=0.05)
        eng = slo.SLOEngine(sampler.history)
        eng.add(slo.SLOSpec.parse(
            'kv_hit', f'kv.hit_rate>={c["kv_hit_floor"]}@1'))
        eng.add(slo.SLOSpec.parse(
            'token', f'decode.token_ms.p99<={c["token_slo_ms"]:g}@1'))
        eng.register_into(hub)
        sampler.add_listener(eng.on_tick)
        plan = faults.FaultPlan(slow_step=((c['slow_step'], c['slow_s']),))
        prev = faults.install_plan(plan)
        try:
            # ---- the main path: counts from 0, driven, read just after --
            reset_launch_counts()
            t0 = time.perf_counter()
            reqs = [svc.submit_async(p, c['max_new']) for p in prompts]
            for r in reqs:
                svc.batcher.wait(r)
            wall = time.perf_counter() - t0
            launches = launch_counts()
            steps = int(svc.engine.stats.get('decode_steps'))
            # ----------------------------------------------------------------
            t1 = time.monotonic()
            for i in range(16):      # both windows over the settled gauges
                sampler.tick(t1 + 0.1 * i)
        finally:
            faults.install_plan(prev)
            svc.close(60.0)
        view = eng.status_view()
        eng.close()
        dumps = sorted(os.listdir(d))
        dump = None
        if len(dumps) == 1:
            with open(os.path.join(d, dumps[0])) as f:
                dump = json.load(f)
    twins = 0
    for i in (0, 1, c['groups']):
        want = T.generate(svc.engine.params, prompts[i], c['max_new'],
                          svc.engine.cfg, flash=svc.engine.use_flash)[0]
        twins += int(np.array_equal(reqs[i].result,
                                    want[:len(reqs[i].result)]))
    checks = {'slow_step_fired': plan.fired() == [
                  f'slow_step={c["slow_step"]}:{c["slow_s"]:g}'],
              'token_breached': view['token']['state'] == slo.BREACHED,
              'kv_hit_ok': view['kv_hit']['state'] == slo.OK
              and not view['kv_hit']['no_data'],
              'one_dump': len(dumps) == 1 and 'SLOBreachError' in dumps[0]
              and dump is not None and dump['slos']['token']['state']
              == slo.BREACHED,
              'twins': twins == 3, 'kernel_leg': svc.engine.use_flash}
    for name, ok in checks.items():
        if not ok:
            failures.append(f'obs[decode]: check {name} failed '
                            f'({dumps}, {view.get("token", {}).get("value")},'
                            f' {view.get("kv_hit", {}).get("value")})')
    _check_launches('obs[decode]', launches,
                    {'paged_flash_decode': cfg.num_stages * steps}, failures)
    return {'stages': cfg.num_stages, 'requests': len(reqs),
            'seconds': wall, 'decode_steps': steps, 'checks': checks,
            'fired': plan.fired(), 'dumps': dumps,
            'slos': {k: {f: v[f] for f in ('state', 'value', 'breaches',
                                           'ratio_long', 'ratio_short')}
                     for k, v in view.items()},
            'launches': launches}


def obs_phase(failures):
    """Telemetry on the card: the reference ``ImageNet.conf`` from the
    CLI with the hub, the endpoints, an SLO, the ``hbm.*`` and MFU gauges
    and a ``profile_dir`` window (``_obs_train_leg``), a serve leg and a
    decode leg under an SLO drill."""
    out = {'phase': 'obs', 'nvidia_smi': nvidia_smi_line()}
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    with tempfile.TemporaryDirectory() as root:
        work, out['dataset_s'] = _imgbin_workdir(root, env, failures, 'obs')
        out['train'] = _obs_train_leg(work, failures)
    torch.cuda.empty_cache()
    out['serve'] = _obs_serve_leg(failures)
    torch.cuda.empty_cache()
    out['decode'] = _obs_decode_leg(failures)
    from cxxnet_tpu_torch.obs import TelemetryHub, install_hub, programs
    install_hub(TelemetryHub())
    programs.install_ledger(None)
    return out


# --- train-while-serve: task=online over a growing imgbin_stream ------------

# the online phase: the reference ImageNet.conf at batch 128 over a stream of
# ``initial`` seeded JPEGs (one page) to which a producer appends a page of
# ``appended`` more once the first step ran, every pass fenced at their sum
# (9 batches); the CLI runs ``rounds`` passes with a serving checkpoint every
# ``cli_save_every`` steps under the pred section's 128-row requests at
# ``cli_qps``; the in-process legs run the first ``steps`` batches the CLI
# digested as one round, a checkpoint every ``save_every`` steps, under 1-,
# 8- and 32-row requests at ``qps`` from one closed-loop client
ONLINE = dict(batch=128, initial=1024, appended=128, test=256, rounds=3,
              cli_save_every=6, cli_qps=5.0, cli_buckets='1,8,32,128',
              steps=12, save_every=4, qps=20.0, buckets=(1, 8, 32),
              reload=0.05, seed=20261028, scale='0.00390625')
# the chaos drill in one run: the second storage write fails once (and is
# retried), the second model file (step 4's) is truncated after its commit,
# and the losses of steps 7-9 read NaN, which trips the breaker (3): step
# 8's save is skipped with the streak open, recovery restores step 4's
# state and replays
ONLINE_PLAN = ('raise_on_write=2;corrupt_model=2;nan_at_step=7;'
               'nan_at_step=8;nan_at_step=9')
ONLINE_CORRUPT_STEP = 4
# the CLI leg's least hot swaps, and the replies replayed a served version
ONLINE_MIN_SWAPS, ONLINE_REPLAYS = 3, 2
# the serving keys of the eval line the CLI extends (online/pipeline.py)
ONLINE_EVAL_KEYS = ('online-served', 'online-dropped', 'online-swaps',
                    'online-slo_breaches', 'online-unserved_swaps',
                    'online-last_swap_step')


class _OnlineCounts:
    """Counts ``NetTrainer`` work over every trainer while installed:
    ``_step`` calls (the steps computed, replays included), eval forwards
    (``forward_values``) by batch rows and ``init_model`` calls; the swaps
    of every ``FreshnessTracker`` in order; with ``record``, the batches
    ``stage_batch`` staged.  ``first_step`` is set once a step ran."""

    def __init__(self, record=False):
        from cxxnet_tpu_torch.nnet.trainer import NetTrainer
        from cxxnet_tpu_torch.online import FreshnessTracker
        self._patched = [(NetTrainer, n, getattr(NetTrainer, n)) for n in (
            '_step', 'forward_values', 'init_model', 'stage_batch')]
        self._patched.append((FreshnessTracker, 'record_swap',
                              FreshnessTracker.record_swap))
        orig = {n: f for _, n, f in self._patched}
        self.steps, self.inits, self.evals = 0, 0, {}
        self.swaps, self.batches = [], []
        self.first_step = threading.Event()
        lock = threading.Lock()

        def step(tr, *args, **kw):
            out = orig['_step'](tr, *args, **kw)
            with lock:
                self.steps += 1
            self.first_step.set()
            return out

        def forward_values(tr, params, data, *args, **kw):
            with lock:
                n = int(data.shape[0])
                self.evals[n] = self.evals.get(n, 0) + 1
            return orig['forward_values'](tr, params, data, *args, **kw)

        def init_model(tr):
            with lock:
                self.inits += 1
            return orig['init_model'](tr)

        def stage_batch(tr, batch):
            if record:
                self.batches.append(batch)
            return orig['stage_batch'](tr, batch)

        def record_swap(tracker, step, t=None):
            with lock:
                self.swaps.append(int(step))
            return orig['record_swap'](tracker, step, t)
        wrappers = {'_step': step, 'forward_values': forward_values,
                    'init_model': init_model, 'stage_batch': stage_batch,
                    'record_swap': record_swap}
        for cls, name, _ in self._patched:
            setattr(cls, name, wrappers[name])

    def close(self):
        for cls, name, fn in self._patched:
            setattr(cls, name, fn)


def _online_want(units, counts, forwards):
    """A run's launches from what it computed: inits, steps, eval forwards
    by rows and serving forwards by bucket rows, each times its unit."""
    want = {}
    terms = [(counts.inits, units['init']), (counts.steps, units['step'])]
    terms += [(n, units['eval'][rows]) for rows, n in counts.evals.items()]
    terms += [(n, units['forward'][rows]) for rows, n in forwards.items()]
    for n, unit in terms:
        for k, v in unit.items():
            want[k] = want.get(k, 0) + n * v
    return want


def _online_save_steps(rounds, per_round, every, start=0):
    """The steps a supervised run publishes at: the bootstrap, each round's
    anchor, every ``every`` steps into a round, each round's end."""
    steps, c = {start}, start
    for _ in range(rounds):
        base = c
        for _ in range(per_round):
            c += 1
            if (c - base) % every == 0:
                steps.add(c)
        steps.add(c)
    return sorted(steps)


def _online_conf(root):
    """The reference ``ImageNet.conf`` with its data section reading the
    stream (``imgbin_stream``, fenced at the final count), its eval section
    the test pack and a pred section (the test pack again) for the CLI's
    traffic, all over one mean image; written as ``root/online.conf``."""
    with open(os.path.join(ROOT, 'example', 'ImageNet',
                           'ImageNet.conf')) as f:
        text = f.read()
    total = ONLINE['initial'] + ONLINE['appended']
    src = ('  image_list = "{0}/{1}.lst"\n  image_bin = "{0}/{1}.bin"\n'
           f'  image_mean = "{root}/mean.bin"\n')
    sections = (
        'data = train\niter = imgbin_stream\n' + src.format(root, 'STREAM')
        + '  rand_crop=1\n  rand_mirror=1\n'
        f'  stream_fence = {total}\n  stream_poll = 0.02\n'
        'iter = threadbuffer\niter = end\n\n'
        'eval = test\niter = imgbin\n' + src.format(root, 'TEST')
        + 'iter = end\n\npred = pred.txt\niter = imgbin\n'
        + src.format(root, 'TEST') + 'iter = end\n\n')
    text = text[:text.index('data = train')] + sections \
        + text[text.index('netconfig=start'):]
    path = os.path.join(root, 'online.conf')
    with open(path, 'w') as f:
        f.write(text)
    return path


def _online_args(mdir):
    """The CLI's arguments after the conf for the online leg.  ``scale``
    (read by every data section) brings the pixels to [0, 1): on these
    images the conf's raw pixels diverge by step 10 at batch 128 in every
    composition, the stock one and float32 too
    (``tools/online_loss_probe.py``), which would end the run in the
    supervisor's divergence breaker."""
    return ['task=online', f'batch_size={ONLINE["batch"]}',
            f'scale={ONLINE["scale"]}',
            f'num_round={ONLINE["rounds"]}', f'max_round={ONLINE["rounds"]}',
            f'model_dir={mdir}',
            f'online.save_every={ONLINE["cli_save_every"]}',
            f'online.qps={ONLINE["cli_qps"]}',
            f'online.reload={ONLINE["reload"]}', 'online.freshness_slo=60',
            f'serve.buckets={ONLINE["cli_buckets"]}', 'serve.deadline=60']


def _online_task_cfg(conf, extra):
    """The pairs ``main.py`` reads from ``conf`` with ``extra``, and its
    data section as a static ``imgbin`` chain's pairs with the globals."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.utils.config import (apply_cli_overrides,
                                               parse_config_file)
    task = LearnTask()
    for k, v in apply_cli_overrides(parse_config_file(conf), list(extra)):
        task.set_param(k, v)
    data, defcfg, flag = [], [], 0
    for k, v in task.cfg:
        if k in ('data', 'eval', 'pred'):
            flag = 1 if k == 'data' else 2
        elif k == 'iter' and v == 'end':
            flag = 0
        elif flag == 1 and not k.startswith('stream_') \
                and (k, v) != ('iter', 'threadbuffer'):
            data.append((k, 'imgbin' if v == 'imgbin_stream' else v))
        elif flag == 0:
            defcfg.append((k, v))
    return task.cfg, data, defcfg


def _static_chain(data, defcfg):
    from cxxnet_tpu_torch.io.data import create_iterator
    it = create_iterator(data)
    for k, v in defcfg:
        it.set_param(k, v)
    it.init()
    return it


def _online_records(root, stem, n, seed, colours=IMGBIN_COLOURS):
    """``n`` seeded JPEGs (``_synth_images``) as ``(index, [label], bytes)``
    records."""
    _synth_images(root, stem, n, seed, colours)
    out = []
    with open(os.path.join(root, stem)) as f:
        for line in f:
            i, c, name = line.rstrip('\n').split('\t')
            with open(os.path.join(root, 'img', name), 'rb') as g:
                out.append((int(i), [float(c)], g.read()))
    return out


def _batch_digest(batch):
    import hashlib
    h = hashlib.sha1(np.ascontiguousarray(batch.data).tobytes())
    h.update(np.ascontiguousarray(batch.label).tobytes())
    return h.hexdigest()


def _online_units(cfg, batch, buckets):
    """One init's, one step's and one 128-row eval forward's launches on a
    scratch trainer of the conf, and each bucket's of one serving forward
    (outside any main path)."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.serve import PredictEngine
    reset_launch_counts()
    tr = NetTrainer(cfg)
    tr.init_model()
    torch.cuda.synchronize()
    init = launch_counts()
    tr.update(batch)                      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    tr.update(batch)
    torch.cuda.synchronize()
    step = launch_counts()
    reset_launch_counts()
    tr.forward_values(tr.params, batch.data, batch.norm_spec)
    torch.cuda.synchronize()
    ev = launch_counts()
    serve = NetTrainer(cfg + [('inference_only', '1')])
    serve.init_model()
    fwd = _per_forward(PredictEngine(serve, buckets))
    del tr, serve
    torch.cuda.empty_cache()
    return {'init': init, 'step': step,
            'eval': {int(batch.data.shape[0]): ev}, 'forward': fwd}


def _batch_iter(batches):
    """A replayable iterator chain over kept batches."""
    from cxxnet_tpu_torch.io.data import IIterator

    class Batches(IIterator):
        def __iter__(self):
            return iter(batches)
    return Batches()


class _OnlineClient(threading.Thread):
    """Requests of 1, 8 and 32 rows of ``pool`` in turn through a
    pipeline, one at a time at ``qps``, each reply kept with the version
    whose params computed it (the engine's ``on_serve``)."""

    def __init__(self, pipe, pool, qps):
        super().__init__(daemon=True, name='smoke-online-client')
        self.pipe, self.pool, self.period = pipe, pool, 1.0 / qps
        self.stop = threading.Event()
        self.records, self.errors = [], []
        self._version = None
        served = pipe.engine.on_serve

        def on_serve(version):
            self._version = version
            served(version)
        pipe.engine.on_serve = on_serve

    def run(self):
        sizes = ONLINE['buckets']
        i = 0
        while not self.stop.is_set():
            n = sizes[i % len(sizes)]
            start = (i * 7) % (len(self.pool) - n + 1)
            try:
                out = self.pipe.submit(self.pool[start:start + n],
                                       deadline=60.0)
                self.records.append((int(self._version), start, n, out))
            except Exception as e:  # noqa: BLE001 — a drop: reported
                self.errors.append(repr(e))
            i += 1
            self.stop.wait(self.period)


def _online_leg(cfg, batches, mdir, units, failures, tag, serve,
                plan=None):
    """One supervised round over ``batches`` on a fresh trainer of the
    conf: through an ``OnlinePipeline`` under a recording client
    (``serve``), or the serverless twin (the same ``TrainSupervisor``
    keys, no publish).  Steps/s, launches against their units, swaps,
    the failure log; the trainer's ``_full_state``."""
    import io
    import itertools
    from cxxnet_tpu_torch.nnet.execution import ExecutionPlan
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.online import OnlineConfig, OnlinePipeline
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    from cxxnet_tpu_torch.runtime import faults
    from cxxnet_tpu_torch.runtime.supervisor import (SupervisorConfig,
                                                     TrainSupervisor)
    tr = NetTrainer(cfg)
    tr.init_model()
    log = faults.FailureLog()
    it = _batch_iter(batches)
    pipe = client = sup = None
    if serve:
        pipe = OnlinePipeline(
            tr, it, lambda: NetTrainer(cfg + [('inference_only', '1')]),
            OnlineConfig(model_dir=mdir, save_every=ONLINE['save_every'],
                         reload_poll=ONLINE['reload'],
                         buckets=ONLINE['buckets'], deadline=60.0,
                         freshness_slo=60.0, watchdog_deadline=120.0,
                         silent=True), failure_log=log)
    else:
        oc = OnlineConfig()
        sup = TrainSupervisor(tr, os.path.join(mdir, 'supervised_state'),
                              SupervisorConfig(
                                  batch_deadline=120.0,
                                  max_restarts=oc.max_restarts,
                                  nan_breaker=oc.nan_breaker,
                                  save_every=ONLINE['save_every'],
                                  keep_last=oc.keep_last,
                                  save_async=oc.save_async,
                                  save_workers=oc.save_workers),
                              failure_log=log)
        plan_k1 = ExecutionPlan.resolve(requested_k=1, silent=True)
    hub = _fresh_obs()
    counts, fwd = _OnlineCounts(), _ForwardCount()
    prev = faults.install_plan(faults.FaultPlan.parse(plan) if plan
                               else None)
    out = {}
    try:
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        if serve:
            pipe.start()
            client = _OnlineClient(pipe, batches[0].data, ONLINE['qps'])
            client.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if serve:
            summary = pipe.run(num_rounds=1, out=io.StringIO())
        else:
            tr.start_round(1)
            sup.run(lambda k: itertools.islice(iter(it), k, None),
                    make_stepper=lambda: plan_k1.round_stepper(
                        tr, lookahead=0))
            tr.flush_divergence_check()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if serve:
            # the last publish is written when run() returns: the leg
            # ends once the registry serves it
            t_end = time.monotonic() + 120
            while pipe.registry.current != summary['steps'] \
                    and time.monotonic() < t_end:
                time.sleep(0.01)
            client.stop.set()
            client.join(120)
            pipe.close(timeout=120.0)
        else:
            sup.close()
        torch.cuda.synchronize()
        launches = launch_counts()
        # ------------------------------------------------------------------
        out['fired'] = faults.active_plan().fired() if plan else []
    finally:
        faults.install_plan(prev)
        counts.close()
        fwd.close()
        if client is not None:
            client.stop.set()
        if pipe is not None:
            pipe.close(timeout=120.0)
        if sup is not None:
            sup.close()
    want = _online_want(units, counts, fwd.by_rows)
    out.update({'steps_computed': counts.steps, 'wall_s': wall,
                'steps_per_s': len(batches) / wall,
                'launches': launches, 'launches_want': want,
                'forwards_by_rows': dict(fwd.by_rows),
                'failure_log': log.summary()})
    _check_launches(tag, launches, want, failures)
    if not serve:
        return out, _full_state(tr)
    files = sorted(f for f in os.listdir(mdir) if f.endswith('.model'))
    spans = sorted(e['dur_ns'] / 1e6 for e in hub.events()
                   if e['name'] == 'online.publish'
                   and not e['attrs'].get('sync'))
    stats = pipe.batcher.stats
    out.update({
        'summary': summary, 'swaps': counts.swaps, 'model_files': files,
        'requests': len(client.records), 'client_errors': client.errors,
        'freshness_s': {tag_: pipe.tracker.stats.quantile('freshness_s', q)
                        for tag_, q in (('p50', 0.5), ('p99', 0.99))},
        'latency_ms': {f'b{b}': {tag_: stats.quantile(f'latency_ms[b{b}]',
                                                      q)
                                 for tag_, q in (('p50', 0.5),
                                                 ('p99', 0.99))}
                       for b in ONLINE['buckets']},
        'publish_ms': {'n': len(spans), 'p50': float(np.median(spans))
                       if spans else None}})
    if summary['dropped'] or client.errors:
        failures.append(f'{tag}: dropped {summary["dropped"]}, client '
                        f'errors {client.errors[:3]}')
    if counts.swaps != sorted(set(counts.swaps)) \
            or pipe.registry.current != summary['steps']:
        failures.append(f'{tag}: swaps {counts.swaps}, serving '
                        f'{pipe.registry.current} at step '
                        f'{summary["steps"]}')
    missing = [f for f in files if not os.path.exists(
        os.path.join(mdir, f + '.crc32'))]
    if missing:
        failures.append(f'{tag}: no .crc32 beside {missing}')
    out['_records'] = client.records
    out['_transitions'] = list(pipe.registry.transitions)
    return out, _full_state(tr)


def _online_replay(cfg, mdir, pool, records, failures, tag):
    """The first ``ONLINE_REPLAYS`` replies of each served version against
    a fresh ``PredictEngine`` on that version's published file at the same
    bucket: bitwise, else the largest difference is the failure."""
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve import PredictEngine
    from cxxnet_tpu_torch.serve.registry import load_into_trainer
    by_version = {}
    for v, start, n, reply in records:
        if len(by_version.setdefault(v, [])) < ONLINE_REPLAYS:
            by_version[v].append((start, n, reply))
    out = {}
    for v, reqs in sorted(by_version.items()):
        tr = load_into_trainer(NetTrainer(cfg + [('inference_only', '1')]),
                               os.path.join(mdir, f'{v:04d}.model'))
        eng = PredictEngine(tr, ONLINE['buckets'])
        errs = []
        for start, n, reply in reqs:
            got = eng.predict_scores(pool[start:start + n])
            errs.append(float(np.abs(got - reply).max()))
            if not np.array_equal(got, reply):
                failures.append(f'{tag}: version {v}, {n} rows: a fresh '
                                f'engine differs by {errs[-1]}')
        out[v] = errs
        del eng, tr
    torch.cuda.empty_cache()
    return out


def _online_cli_leg(root, conf, appended, units, failures):
    """``task=online`` through the CLI's ``main`` in this process over the
    growing stream, a producer appending ``appended`` (one page) once the
    first step ran, under ``torch.profiler``: the eval lines' serving
    keys, the summary line, swaps, model files and their digests, the
    launches exactly their units, the device-idle share.  Returns the
    leg's line and the batches the trainer staged, in order."""
    from torch.profiler import ProfilerActivity, profile
    from cxxnet_tpu_torch.io.iter_stream import append_records
    from cxxnet_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)
    tag = 'online[cli]'
    mdir = os.path.join(root, 'models_online')
    args = [os.path.basename(conf)] + _online_args(mdir)
    per_pass = (ONLINE['initial'] + ONLINE['appended']) // ONLINE['batch']
    steps = ONLINE['rounds'] * per_pass
    hub = _fresh_obs()
    counts, fwd = _OnlineCounts(record=True), _ForwardCount()
    grew = {}

    def produce():
        counts.first_step.wait(600)
        grew['after_steps'] = counts.steps
        grew['records'] = append_records(
            os.path.join(root, 'STREAM.bin'),
            os.path.join(root, 'STREAM.lst'), appended)

    producer = threading.Thread(target=produce, daemon=True,
                                name='smoke-online-producer')
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        producer.start()
        # ---- the main path: counts from 0, driven, read just after ------
        reset_launch_counts()
        with prof:
            rc, so, se, wall = _cli_in_process(args, root)
            torch.cuda.synchronize()
        launches = launch_counts()
        # ------------------------------------------------------------------
    finally:
        counts.first_step.set()
        producer.join(120)
        counts.close()
        fwd.close()
    out = {'args': ' '.join(args), 'rc': rc, 'wall_s': wall, 'grew': grew,
           'steps_computed': counts.steps, 'swaps': counts.swaps,
           'forwards_by_rows': dict(fwd.by_rows),
           'evals_by_rows': dict(counts.evals), 'inits': counts.inits,
           'launches': launches}
    if rc != 0:
        failures.append(f'{tag}: exit {rc}: '
                        + '\n'.join(ln for _, ln in se[-40:]))
        return out, counts.batches
    busy_ms = sum(float(getattr(e, 'self_device_time_total', 0.0)
                        or getattr(e, 'self_cuda_time_total', 0.0))
                  for e in prof.key_averages()
                  if str(getattr(e, 'device_type', '')).split('.')[-1]
                  == 'CUDA') / 1e3
    out['profile'] = {'device_ms': busy_ms, 'wall_ms': wall * 1e3,
                      'idle_share': 1.0 - busy_ms / (wall * 1e3)}
    evals = [ln for _, ln in se if re.match(r'\[\d+\]\t', ln)]
    serve = [ln for _, ln in se if ln.startswith('[online]')]
    lines = [ln for _, ln in so if ln.startswith('online summary: ')]
    summary = json.loads(lines[-1][len('online summary: '):]) \
        if lines else {}
    files = sorted(f for f in os.listdir(mdir) if f.endswith('.model'))
    want_files = [f'{s:04d}.model' for s in _online_save_steps(
        ONLINE['rounds'], per_pass, ONLINE['cli_save_every'])]
    fields = [_eval_fields(ln) for ln in evals]
    spans = sorted(e['dur_ns'] / 1e6 for e in hub.events()
                   if e['name'] == 'online.publish'
                   and not e['attrs'].get('sync'))
    out.update({
        'eval_lines': evals, 'summary': summary, 'model_files': files,
        'serve': _eval_fields('\t' + serve[-1].split('\t', 1)[1])
        if serve else None,
        'publish_ms': {'n': len(spans), 'p50': float(np.median(spans))
                       if spans else None}})
    want = _online_want(units, counts, fwd.by_rows)
    out['launches_want'] = want
    _check_launches(tag, launches, want, failures)
    checks = {
        'eval_lines': len(fields) == ONLINE['rounds'] and all(
            np.isfinite(f.get(k, np.nan)) for f in fields
            for k in ('test-error',) + ONLINE_EVAL_KEYS),
        'summary': bool(summary) and summary['steps'] == steps
        and summary['dropped'] == 0 and summary['served'] > 0
        and summary['swaps'] >= ONLINE_MIN_SWAPS
        and summary['save_failures'] == 0 and summary['restarts'] == 0,
        'steps': counts.steps == steps,
        'swaps_increase': len(counts.swaps) >= ONLINE_MIN_SWAPS
        and counts.swaps == sorted(set(counts.swaps)),
        'model_files': files == want_files and all(
            os.path.exists(os.path.join(mdir, f + '.crc32'))
            for f in files),
        'grew_mid_pass': grew.get('records') == ONLINE['appended']
        and grew.get('after_steps', per_pass) < per_pass,
        'path_kernels': all(launches.get(k, 0) > 0 for k, v in
                            units['step'].items() if v)}
    out['checks'] = checks
    for name, ok in checks.items():
        if not ok:
            failures.append(f'{tag}: check {name} failed')
    return out, counts.batches


def online_phase(failures):
    """Train-while-serve on the card: the reference ``ImageNet.conf`` with
    ``task=online`` over a growing ``imgbin_stream`` from the CLI
    (``_online_cli_leg``), the stream against a static ``imgbin`` pass over
    its final bytes, then ``OnlinePipeline`` in this process over the
    batches the CLI digested: twin / online / online / twin (the twin the
    same supervised round with no server: bitwise, steps/s), the replies
    against fresh engines on their versions' files, and the chaos drill."""
    from cxxnet_tpu_torch.io.iter_stream import append_records
    out = {'phase': 'online', 'nvidia_smi': nvidia_smi_line(),
           'config': dict(ONLINE, buckets=list(ONLINE['buckets'])),
           'plan': ONLINE_PLAN}
    per_pass = (ONLINE['initial'] + ONLINE['appended']) // ONLINE['batch']
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        train = _online_records(root, 'online.train', ONLINE['initial']
                                + ONLINE['appended'], ONLINE['seed'])
        test = _online_records(root, 'online.test', ONLINE['test'],
                               ONLINE['seed'] + 1)
        append_records(os.path.join(root, 'STREAM.bin'),
                       os.path.join(root, 'STREAM.lst'),
                       train[:ONLINE['initial']])
        append_records(os.path.join(root, 'TEST.bin'),
                       os.path.join(root, 'TEST.lst'), test)
        conf = _online_conf(root)
        cfg, data, defcfg = _online_task_cfg(
            conf, _online_args(os.path.join(root, 'models_online')))
        # the mean image over the pages on disk at the start (the stream
        # cannot make it: a fenced pass waits for the growth)
        it = _static_chain(data, defcfg)
        first = next(iter(it))
        it.close(10.0)
        out['dataset_s'] = time.perf_counter() - t0
        buckets = sorted(set(ONLINE['buckets']) | {
            int(b) for b in ONLINE['cli_buckets'].split(',')})
        units = _online_units(cfg, first, buckets)
        out['units'] = units
        out['cli'], batches = _online_cli_leg(
            root, conf, train[ONLINE['initial']:], units, failures)
        # ---- the stream is its static twin ----------------------------------
        it = _static_chain(data, defcfg)
        static = [_batch_digest(b) for b in it]
        it.close(10.0)
        grown = [_batch_digest(b) for b in batches[:per_pass]]
        out['stream_twin'] = {'batches': len(grown),
                              'equal': grown == static}
        if grown != static or len(grown) != per_pass:
            failures.append(f'online[stream]: the {len(grown)} batches '
                            'staged while the file grew differ from a '
                            'static imgbin pass over the final bytes')
        batches = batches[:ONLINE['steps']]
        if len(batches) < ONLINE['steps']:
            failures.append(f'online: {len(batches)} batches staged')
            return out
        # ---- twin / online / online / twin, then the chaos drill ------------
        legs, states = {}, {}
        for name, serve, plan in (('twin', False, None),
                                  ('online', True, None),
                                  ('online_2', True, None),
                                  ('twin_2', False, None),
                                  ('chaos', True, ONLINE_PLAN)):
            legs[name], states[name] = _online_leg(
                cfg, batches, os.path.join(root, name), units, failures,
                f'online[{name}]', serve, plan)
            torch.cuda.empty_cache()
        for name in ('online', 'online_2', 'twin_2', 'chaos'):
            diff = _state_diff(states['twin'], states[name])
            legs[name]['bitwise_twin'] = not diff
            if diff:
                failures.append(f'online[{name}]: not bitwise the '
                                f'serverless twin: {diff[:6]}')
        out['steps_per_s'] = {k: leg['steps_per_s']
                              for k, leg in legs.items()}
        # ---- the chaos drill ------------------------------------------------
        chaos = legs['chaos']
        bad = f'{ONLINE_CORRUPT_STEP:04d}.model'
        same = [f for f in chaos['model_files'] if f != bad and (
            open(os.path.join(root, 'chaos', f), 'rb').read()
            != open(os.path.join(root, 'online', f), 'rb').read())]
        states_bad = [s for s, d in legs['chaos']['_transitions']
                      if bad in d]
        chaos['checks'] = checks = {
            'never_served_corrupt': ONLINE_CORRUPT_STEP not in chaos['swaps']
            and 'REJECTED' in states_bad and 'SWAPPED' not in states_bad,
            'recovered': chaos['summary']['restarts'] == 1
            and 'DivergenceError' in chaos['failure_log'],
            'files_equal_clean': not same,
            'steps_replayed': chaos['steps_computed'] > ONLINE['steps'],
            'every_event_fired': sorted(chaos['fired']) == sorted(
                ONLINE_PLAN.split(';'))}
        for name, ok in checks.items():
            if not ok:
                failures.append(f'online[chaos]: check {name} failed '
                                f'({chaos["swaps"]}, {states_bad}, '
                                f'{chaos["failure_log"]}, {same})')
        # ---- replies match their version -------------------------------------
        out['replay_max_abs_err'] = _online_replay(
            cfg, os.path.join(root, 'online'), batches[0].data,
            legs['online'].pop('_records'), failures, 'online[replay]')
        for leg in legs.values():
            leg.pop('_records', None)
            leg.pop('_transitions', None)
        out['legs'] = legs
    torch.cuda.empty_cache()
    return out


def summarize(rows, launches_by_path):
    """One entry per kernel: times and bounds summed over the shapes one
    pass of its paths gives it (each shape once: the forward kernels at an
    AlexNet forward's, the backward kernels at a ``use_pallas=1`` train
    step's, then the Inception nets' distinct shapes; ``by_net`` splits
    the sums by net), errors their maximum; ``launches`` sums the kernel's
    launches over the main-path runs (serve, train auto, train
    use_pallas=1), itemized in ``launches_by_path``.  ``ms`` is the
    device time: CUDA-graph replays (``ms_by`` 'cuda_graph') for the
    paged, int8 and LRN kernels, whose wrapper's host time exceeds a
    launch (the LRN forward in its inference form, as serving runs it),
    else back-to-back launches by CUDA events, which ``events_ms`` gives
    for every kernel."""
    out = []
    for kernel, (source, replaces) in KERNEL_META.items():
        rs = [r for r in rows if r['kernel'] == kernel
              and r.get('in_summary', True)]
        bound_ms = sum(r['bound_ms'] for r in rs)
        by_ops = sum(r['bound_ms'] for r in rs if r['bound_by'] ==
                     'operations')
        lib = [r['library_ms'] for r in rs if r['library_ms'] is not None]
        out.append({
            'name': kernel, 'route': 'cuda', 'source': source,
            'replaces': replaces,
            'launches': sum(p[kernel] for p in launches_by_path.values()),
            'launches_by_path': {path: p[kernel] for path, p in
                                 launches_by_path.items()},
            'max_abs_err': max(r['max_abs_err'] for r in rs),
            'max_rel_err': max(r['max_rel_err'] for r in rs),
            'ms': sum(r.get('graph_ms', r['kernel_ms']) for r in rs),
            'ms_by': 'cuda_graph' if all('graph_ms' in r for r in rs)
            else 'events',
            'events_ms': sum(r['kernel_ms'] for r in rs),
            'plain_ms': sum(r['plain_ms'] for r in rs),
            'bound_ms': bound_ms,
            'bound_by': 'operations' if by_ops * 2 >= bound_ms else 'bytes',
            'library_ms': sum(lib) if lib else None,
            'library_shapes': [r['shape'] for r in rs
                               if r['library_ms'] is not None],
            'shapes': [r['shape'] for r in rs]})
        nets = sorted({r['net'] for r in rs if 'net' in r})
        if len(nets) > 1:
            # per net, over the layers of one pass (a shape counted once
            # per layer that runs at it)
            out[-1]['by_net'] = {net: _pass_sums(
                [r for r in rs if r.get('net') == net]) for net in nets}
        if kernel == 'int8_matmul':
            out[-1]['decode_step'] = _int8_step(rs)
    return out


def _pass_sums(rows):
    """Times and bound of one pass over ``rows``: each row weighted by the
    number of the pass's layers that run at its shape."""
    out = {key: sum(r['layers'] * r[key] for r in rows)
           for key in ('kernel_ms', 'plain_ms', 'bound_ms')}
    out['ms'] = sum(r['layers'] * r.get('graph_ms', r['kernel_ms'])
                    for r in rows)
    lib = [r['layers'] * r['library_ms'] for r in rows
           if r['library_ms'] is not None]
    out['library_ms'] = sum(lib) if lib else None
    out['shapes'], out['layers'] = len(rows), sum(r['layers'] for r in rows)
    return out


def _int8_step(rows):
    """The int8 GEMM's share of one decode step (8 stages x 6 products +
    the head at 64 padded rows), summed from the checks' decode shapes."""
    step = {}
    for key in ('kernel_ms', 'graph_ms', 'plain_ms', 'bound_ms',
                'library_ms'):
        step[key] = sum(INT8_STEP_USES[r['shape'].split()[0]] * r[key]
                        for r in rows if r['shape'].split()[0]
                        in INT8_STEP_USES)
    return step


def run_phase(fn, failures, *args):
    """``fn(*args, failures)``; an exception is recorded as a failure (the
    run goes on to report the other phases, and exits non-zero)."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, failures)
        if isinstance(out, dict) and 'phase' in out:
            out['elapsed_s'] = time.perf_counter() - t0
        return out
    except Exception:  # noqa: BLE001 — reported, never swallowed
        import traceback
        failures.append(f'{fn.__name__}: {traceback.format_exc()}')
        return None


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.precision import full_f32
    failures = []
    smi = nvidia_smi_line()
    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    emit({'phase': 'env', 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'device': name, 'count': torch.cuda.device_count(),
          'capability': list(torch.cuda.get_device_capability(0)),
          'nvidia_smi': smi})

    t0 = time.perf_counter()
    build.build_all()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'nvcc': build.find_nvcc()})
    for lib in build.SOURCES:
        for line in build.build_log(lib).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[ptxas {lib}] {line.strip()}', file=sys.stderr)
    emit({'phase': 'ptxas', 'kernels': {
        lib: ptxas_summary(build.build_log(lib))
        for lib in REDESIGNED_LIBS}})

    peaks = card_peaks(name)
    with full_f32():   # the library and plain versions in f32, no TF32
        rows = run_phase(kernel_checks, failures, dev, peaks,
                         torch.float32) or []
    emit({'phase': 'kernel_checks', 'peaks': {'f32_flops': peaks[0],
                                              'hbm_bytes_s': peaks[1]},
          'rows': rows})
    torch.cuda.empty_cache()

    with full_f32():
        rows += run_phase(paged_kernel_checks, failures, dev, peaks) or []
        rows += run_phase(int8_kernel_checks, failures, dev, peaks) or []
    emit({'phase': 'kernel_checks', 'int8_ops': peaks[2],
          'rows': [r for r in rows if r['kernel'].startswith('paged')
                   or r['kernel'] == 'int8_matmul']})
    torch.cuda.empty_cache()
    with full_f32():
        flash_rows = run_phase(flash_kernel_checks, failures, dev, peaks)
    rows += flash_rows or []
    emit({'phase': 'kernel_checks', 'bf16_flops': peaks[3],
          'tf32_flops': peaks[4], 'rows': flash_rows})
    torch.cuda.empty_cache()
    with full_f32():
        bf16_rows = run_phase(kernel_checks, failures, dev, peaks,
                              torch.bfloat16)
    rows += bf16_rows or []
    emit({'phase': 'kernel_checks', 'builds': 'bf16 (rows 1-7)',
          'rows': bf16_rows})
    torch.cuda.empty_cache()
    with full_f32():
        f16_rows = run_phase(kernel_checks, failures, dev, peaks,
                             torch.float16)
    rows += f16_rows or []
    emit({'phase': 'kernel_checks', 'builds': 'f16 (rows 1-7)',
          'rows': f16_rows})
    torch.cuda.empty_cache()
    tf = run_phase(threefry_checks, failures, dev, peaks)
    rows += tf['rows'] if tf else []
    emit({'phase': 'kernel_checks', 'kernel': 'threefry_uniform', **(tf or {})})
    torch.cuda.empty_cache()

    serve = run_phase(serve_phase, failures, name)
    emit(serve)
    torch.cuda.empty_cache()
    train = run_phase(train_phase, failures)
    emit(train)
    torch.cuda.empty_cache()
    inception = run_phase(inception_phase, failures)
    emit(inception)
    torch.cuda.empty_cache()
    emit(run_phase(cli_phase, failures))
    torch.cuda.empty_cache()
    decode, spec, quant, prefix = lm_phases(failures)
    emit(prefix)
    torch.cuda.empty_cache()
    with full_f32():
        seqpar = run_phase(seqpar_phase, failures)
    emit(seqpar)
    torch.cuda.empty_cache()
    lm_train = run_phase(lm_train_phase, failures, peaks)
    emit(lm_train)
    torch.cuda.empty_cache()
    bf16 = run_phase(bf16_phase, failures, serve) if serve else None
    emit(bf16)
    torch.cuda.empty_cache()
    f16 = run_phase(f16_phase, failures, serve) if serve else None
    emit(f16)
    torch.cuda.empty_cache()
    imgbin = run_phase(cli_imgbin_phase, failures, bf16)
    emit(imgbin)
    torch.cuda.empty_cache()
    window = run_phase(window_phase, failures)
    emit(window)
    torch.cuda.empty_cache()
    with full_f32():
        fold = run_phase(fold_phase, failures)
    emit(fold)
    torch.cuda.empty_cache()
    blockdiag = run_phase(blockdiag_phase, failures)
    emit(blockdiag)
    torch.cuda.empty_cache()
    runtime = run_phase(runtime_phase, failures)
    if runtime and 'native' in runtime:
        emit(runtime.pop('native'))
    emit(runtime)
    torch.cuda.empty_cache()
    fleet = run_phase(fleet_phase, failures)
    emit(fleet)
    torch.cuda.empty_cache()
    lowering = run_phase(lowering_phase, failures)
    emit(lowering)
    torch.cuda.empty_cache()
    obs = run_phase(obs_phase, failures)
    emit(obs)
    torch.cuda.empty_cache()
    online = run_phase(online_phase, failures)
    emit(online)
    if (rows and serve and train and inception and decode and spec and quant
            and prefix and seqpar and lm_train and bf16 and f16 and imgbin
            and 'tasks' in imgbin and window and fold and blockdiag
            and runtime and len(runtime.get('legs', ())) == len(RUNTIME_LEGS)
            and fleet and lowering and obs and online and 'legs' in online):
        g, ibn = inception['googlenet'], inception['inception_bn']
        emit({'kernels': summarize(rows, {
            'serve': serve['launches'], 'train_auto': train['launches'],
            'train_use_pallas_1': train['use_pallas_1']['launches'],
            'googlenet_auto': g['launches'],
            'googlenet_eval': g['eval']['launches'],
            'googlenet_use_pallas_1': g['use_pallas_1']['launches'],
            'inception_bn_auto': ibn['launches'],
            'inception_bn_eval': ibn['eval']['launches'],
            'inception_bn_fuse_1': ibn['fuse_1']['launches'],
            'decode': decode['launches'], 'spec': spec['launches'],
            'quant_int8': quant['int8']['launches'],
            'quant_bf16': quant['bf16']['launches'],
            'quant_int8_spec': quant['int8_spec']['launches'],
            **{f'prefix_{leg}': launches
               for leg, launches in prefix['launches'].items()},
            'seqpar': seqpar['launches'],
            'seqpar_bf16': seqpar['bf16']['launches'],
            'lm_train': lm_train['launches'],
            **{f'bf16_{key}_{leg}': (bf16[key]['launches'] if leg == 'auto'
                                     else bf16[key]['eval']['launches'])
               for key in ('alexnet', 'googlenet', 'inception_bn')
               for leg in ('auto', 'eval')},
            'bf16_alexnet_use_pallas_1':
                bf16['alexnet_use_pallas_1']['launches'],
            'bf16_serve': bf16['serve']['launches'],
            **{f'f16_{key}_{leg}': (f16[key]['launches'] if leg == 'auto'
                                    else f16[key]['eval']['launches'])
               for key in ('alexnet', 'googlenet', 'inception_bn')
               for leg in ('auto', 'eval')},
            'f16_alexnet_use_pallas_1':
                f16['alexnet_use_pallas_1']['launches'],
            'f16_serve': f16['serve']['launches'],
            'bf16_imgbin_auto': imgbin['in_process']['launches'],
            'bf16_cli_tasks_eval':
                imgbin['tasks']['in_process_extract']['launches'],
            'bf16_alexnet_window': window['launches'],
            'inception_bn_biases_fold_serve':
                fold['conv_biases']['launches']['folded'],
            'googlenet_blockdiag_auto': blockdiag['fused']['launches'],
            **{f'bf16_alexnet_runtime_{name}': leg['launches']
               for name, leg in runtime['legs'].items()},
            **{f'fleet_{leg}': fleet[leg]['launches']
               for leg in ('reload', 'replicas', 'models', 'lm_reload')},
            **{f'{"bf16_alexnet" if key.startswith("bf16") else "alexnet"}'
               f'_lowering_{key.split("_", 1)[1]}': leg['launches']
               for key, leg in lowering['lowerings']['legs'].items()},
            **{f'{"bf16_alexnet" if key.startswith("bf16") else "alexnet"}'
               f'_micro_batch_{key.split("_", 1)[1]}': leg['launches']
               for key, leg in lowering['micro_batch']['legs'].items()},
            **{f'{"bf16_alexnet" if key.startswith("bf16") else "alexnet"}'
               f'_fuse0_{key.split("_", 1)[1]}': leg['launches']
               for key, leg in lowering['first_step']['legs'].items()},
            'bf16_alexnet_attach': lowering['attach']['launches'],
            'bf16_alexnet_obs_cli': obs['train']['launches'],
            'obs_serve': obs['serve']['launches'],
            'obs_decode': obs['decode']['launches'],
            'bf16_alexnet_online_cli': online['cli']['launches'],
            'bf16_alexnet_online_pipeline':
                online['legs']['online']['launches'],
            'bf16_alexnet_online_chaos': online['legs']['chaos']['launches']})})
    if failures:
        for f in failures:
            print(f'chip_smoke FAILED: {f}', file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
