"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times   # the flash kernels' times alone
    python3 chip_smoke.py --topk-times    # B7's time alone
    python3 chip_smoke.py --factor-times  # B9's PowerSGD passes alone
    python3 chip_smoke.py --flash-times --topk-times --factor-times
    python3 chip_smoke.py --input-times   # AlexNet from files: loader settings
    python3 chip_smoke.py --update-times  # GoogLeNet, ResNet-50 BSP profiles
    python3 chip_smoke.py --lrn-times     # B2 (and B1) at the four LRN shapes
    python3 chip_smoke.py --islands       # the async island phases alone
    python3 chip_smoke.py --vgg-island-lr # VGG-16 islands at two rates
    python3 chip_smoke.py --launcher      # the launcher phases alone
    python3 chip_smoke.py --wire          # params mode, Ring, buckets alone
    python3 chip_smoke.py --shard         # zero_opt, update_sharding, fsdp
    python3 chip_smoke.py --gan-lm        # GANs, MoE LM, remat, generate
    python3 chip_smoke.py --flash-f32     # the float32 flash kernels (A11)
    python3 chip_smoke.py --pp-stage      # B10–B12 at a pp stage's shape
    python3 chip_smoke.py --ep-rank       # one ep = tp 2 rank's MoE block
    python3 chip_smoke.py --ops           # the operations planes (A10)
    python3 chip_smoke.py --elastic       # the elastic islands, simfleet
    python3 chip_smoke.py --tools         # the port's tools (A13)

1. Fails (exit 2, no result) without CUDA; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Builds every hand-written kernel of ``theanompi_tpu_torch/csrc`` with
   ``nvcc`` into ``build/kernels/`` (one compiler per source, in parallel).
3. LRN (B1/B2): checks with ``cuobjdump -sass`` that every vector
   build of B2 holds the bulk copy (``UBLKCP``) its ring is built on;
   holds each kernel against its plain PyTorch version at AlexNet's
   shapes and at GoogLeNet's ([32, 56, 56, 64] and [32, 56, 56, 192]),
   in float32 (TF32 off) and bfloat16, B2's rerun bit for bit, and times
   the kernel, the plain version, and the one PyTorch call that computes
   the same function (``F.local_response_norm``; timed here only, the
   port never calls it).
4. Compress (B3–B6): on a random float32 vector of VGG-16's padded length
   (planted ±0.0), holds the sign pack, the encode and the residual against
   their plain versions bit for bit, and the weighted decode at 1 worker bit
   for bit and at 4 and 8 stacked workers within its stated bound; times
   each beside its plain version and its byte bound.  No single PyTorch
   call computes any of the four, so their ``library_ms`` is null.
5. Holds full-width AlexNet's logits on the card (kernels) against the same
   weights on the CPU (plain versions), float32, batch 2; the same for
   full-width GoogLeNet (crop 224, dropout off: eval logits, the eval
   cost, and the training cost with both aux heads) and ResNet-50 (eval
   logits from running stats drawn from a seed, then one training
   forward's cost and all 53 BatchNorms' updated running state).
6. Drives the AlexNet main path: ``BSP().init(devices=1, modelfile=
   'theanompi_tpu_torch.models.alex_net', modelclass='AlexNet', ...)`` at
   batch 128, full width, bf16, a few steps, and checks the cost is finite,
   the params sit on the card and which kernels were launched how often.
   Every main path's train step is captured in a CUDA graph (the first
   call runs eagerly and captures; the rest replay), and a kernel's count
   grows by its launches per replay.
7. Profiles a few more AlexNet steps: host wall and host buckets per step,
   device busy time, the device's idle share, the kernels by device time,
   the host → device copies (``Memcpy HtoD``) and their memory kind; of
   the captured step and of the eager one (``capture=False``), as every
   profile below.
8. Native loader: builds ``theanompi_tpu_torch/native/loader.cc`` with g++
   into ``build/native/`` and, on one AlexNet batch (128 bc01 uint8 images
   at 256², a CHW mean made HWC), holds the fused pass against its NumPy
   path bit for bit, with a shared crop window and with per-image windows;
   prints the host ms of each path, the native one at 1–8 threads.
9. AlexNet from files under ``para_load``: writes ImageNet-layout ``.npy``
   batch files (bc01 uint8, 128 images of 256·256·3 each, the label files,
   a smooth CHW ``img_mean.npy``; ``.npy`` because the card's machine has
   no h5py) under ``build/``, and trains BSP AlexNet at batch 128 on them
   with ``data_dir=``, ``para_load=True``, ``para_load_workers=4``: one
   epoch and a validation batch, ending in a checkpoint (``ckpt_dir``).
   Checks the costs, the params' device, the LRN launch counts, and that
   every batch a step took on the card (its checksum, after the compute
   stream waited on the staging copy) equals the same step of a bare
   ``ImageNet_data`` over the same files and seed on the host: a pinned
   buffer rewritten too early would show here.
10. The same with ``aug_wire_u8=True``: the uint8 batches' checksums; then
    the first step's batch through both wires in eval mode: with a scalar
    mean the staged input and the logits are bit-equal, with the mean image
    the input differs by exactly the mean's window deviation and the logits
    stay within ``U8_LOGITS_RTOL``.
11. Resume: a fresh session restores the checkpoint of step 9: params,
    momentum and the loader's cursor bit-equal to the saved ones, the first
    batch of epoch 1 equal to the uninterrupted stream's; then
    ``BSP().init(..., resume=True)`` trains epoch 1 (launches counted,
    every batch checked, costs finite).  Trajectories after a resume are
    held bit for bit on the CPU (tests): cuDNN's backward algorithms are not
    promised deterministic.
12. Profiles AlexNet from files under ``para_load``, float32 and u8 wires,
    as step 7 profiles the synthetic source (the loader's epoch started
    first, so its producer runs ahead).
13. Drives the VGG-16 onebit main path: ``BSP().init(devices=1, modelfile=
   'theanompi_tpu_torch.models.vggnet_16', modelclass='VGGNet_16',
   exch_strategy='onebit', batch_size=32, ...)``, full width and depth,
   8 steps and a validation batch; checks the costs, the params' device,
   the error-feedback state, and that B5, B6 and B4 ran once per step.
14. Profiles VGG-16 onebit steps the same way, with the per-step device time
   of B4+B5+B6 and of the flatten copy, and checks that one exchange reads
   nothing back to the host (CUDA sync debug mode).
15. Topk (B7/B8): at VGG-16's padded shape, c2 [16890, 8192] with k = 82
    (all-zero rows, planted ties, ±0.0, and the radix select's stress rows:
    |c| sharing their top 16 bits, more than k ties at the threshold after
    the larger entries, subnormals, ±inf), holds the encode and the decode
    (1, 4 and 8 workers) against their plain versions bit for bit; times
    each beside its plain version, its byte bound and a library yardstick
    (``torch.topk`` for the selection alone; one accumulating
    ``index_put_`` for the scatter alone); prints B7 beside its first,
    argmax-pass version.
16. Factor pack (B9): both passes of a PowerSGD step over VGG-16's 16
    compressible weights (``Aᵀ q``, then ``A p``, rank 2), each one
    grouped launch as the main path makes it, against the plain version
    within the float32 dot-product bound, pad rows exactly +0, a rerun bit
    for bit the same and each tile bit for bit the one-leaf entry's; times
    each pass beside the sum of its 16 one-leaf launches, its bound, the
    plain group and ``torch.matmul`` over its products (TF32 off).
17. Drives VGG-16 under ``exch_strategy='topk'`` and ``'powersgd'`` the
    way step 13 drives onebit (8 steps, a validation batch, launch counts:
    8 B7 + 8 B8, and 2 × 8 = 16 grouped B9, nothing else), profiles each,
    and runs one exchange of each under CUDA's sync debug mode: the topk
    exchange must make the host wait on nothing; PowerSGD's waits (its
    ``torch.linalg.qr`` might read back) are counted and printed.
18. Flash attention (B10–B12): checks with ``cuobjdump -sass`` that every
    build of B10, B11 and B12 holds wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``); at the LM's shape [16, 8, 512, 64] bf16, causal, on q,
    k, v and dO laid out as the model hands them (views of [B, T, H, hd]),
    holds the forward and both backward kernels against their plain
    versions; times each beside its plain version, its bound and the
    library yardstick (``F.scaled_dot_product_attention(...,
    is_causal=True)`` for B10, its autograd backward, dQ, dK and dV in one,
    for B11 and B12; timed here only, the port never calls it), and the
    host µs of each wrapper call; prints B10–B12 beside their first, WMMA
    versions, and B11 + B12 beside SDPA's backward.
19. The LM at full width (d512, 8 heads, 8 layers, T512, vocab 32768) at
    batch 2 on the card: loss and gradients of ``attn_impl='flash'``
    (kernels, bf16) and ``'reference'`` (torch attention, bf16) from the
    same parameters, each against the same model in float32; flash must
    be as close to float32 as the bf16 reference, within a stated factor.
20. Drives the LM main path: ``BSP().init(devices=1, modelfile=
    'theanompi_tpu_torch.models.transformer_lm', modelclass='TransformerLM',
    attn_impl='flash', batch_size=16, ...)``, Adam, 8 steps and a validation
    batch; checks the costs, the params' device and the launch counts
    (8·(8+1) B10, 8·8 B11, 8·8 B12, nothing else); profiles its steps
    (tokens/s, host buckets, device busy, idle share, the flash kernels'
    device time).
20a. The float32 flash kernels (A11; ``--flash-f32`` runs these alone):
    B10–B12 in float32 at [16, 8, 512, 64] causal as the model hands them,
    [4, 8, 256, 128] non-causal and [2, 4, 320, 32] causal strided, every
    output against the float32 plain versions (TF32 off) within
    ``F32_FLASH_TOL``, a rerun bit for bit, and every build of the three
    holding ``HGMMA`` and ``UTMALDG``; at the LM's shape each kernel's
    device ms, host µs, bound (float32 flops in split TF32, the FFMA bound
    beside it), plain ms and SDPA in float32 (and its backward), B10 f32
    faster than SDPA's forward and B11 + B12 than its backward; the
    float32 flash LM at full width,
    batch 2, its loss and every gradient leaf on the card against the same
    weights on the CPU (the plain versions) within ``LM_F32_LOSS_RTOL`` and,
    leaf by leaf, ``LM_F32_GRAD_RATIO`` times the reference attention's own
    card-vs-CPU distance, which a bf16-rounded control must exceed; then
    its main path (``compute_dtype='float32'``,
    b16, 8 captured Adam steps and a validation batch: 9 · 8 B10 f32, 8 · 8
    B11 and B12 f32, nothing else) and its captured step profiled.
20b. A pipeline stage (``--pp-stage`` runs this alone): B10–B12 bf16
    and float32 at the LM row's b16 over ``pp_microbatches`` 4 at pp 2,
    [4, 8, 512, 64] causal as the model hands them, through the bf16
    flash phase's and the float32 one's checks at that shape (plain
    version, rerun bit for bit, device ms beside SDPA's forward and
    backward, the bound); then one stage's step through the port's
    pipeline (``pipeline_apply`` over L/pp = 4 stacked blocks, group None)
    forward and backward in bf16 and float32, its launches read and held
    to the schedule's, its outputs and gradients against the same blocks
    applied densely (a pp world itself needs a GPU a rank: CPU tests).
20c. An ep = tp 2 rank (``--ep-rank`` runs this alone): B10–B12 bf16 and
    float32 at a tp rank's heads of the LM row, [16, 4, 512, 64] causal as
    the model hands them, through the same checks and times as 20b; then
    the MoE LM row's MoE block (4 experts, top-1, capacity factor 1.25) at
    ep = tp 2, each rank's part built with the model group ``tp.LOCAL``
    (its 4 heads through B10–B12, its 2 experts through the
    expert-parallel path), forward and backward in bf16 and float32, the
    phase adding up what the group's all-reduces add; launches read (one
    B10, B11 and B12 a rank); the output and every gradient (each rank's
    shard of a split leaf) held against the dense block: bf16 whole,
    within LM_GRAD_RATIO of the dense bf16 block's distance from float32;
    float32 as the attention and the MoE each from the same input, within
    LM_F32_GRAD_RATIO of the dense float32 half's distance from float64
    (the float32 whole block only finite: a ~1e-7 reorder can flip a
    routing choice or a ReLU mask); one rank's block step and the dense
    block's, each captured in a CUDA graph, timed (the all-to-all and the
    NCCL model group need a GPU a rank: CPU tests).
21. Drives the zoo's main paths: ``BSP().init(devices=1, modelfile=
    'theanompi_tpu_torch.models.googlenet' | '...resnet50' |
    '...cifar10', ...)``, GoogLeNet and ResNet-50 at batch 32, full width,
    bf16, Cifar10 at batch 128, 8 steps and a validation batch each:
    costs, the params' device, GoogLeNet's launches (2 B1 + 2 B2 a step,
    2 B1 a validation batch), ResNet-50's running state on the card,
    finite, every mean moved; profiles GoogLeNet (LRN, the concat copies;
    its aux heads timed alone with CUDA events) and ResNet-50 (BatchNorm,
    the all-reduces: ``sync_bn``'s and the metrics'), captured and eager.
    The zoo's profiles also group the update's multi-tensor passes
    (``torch._foreach_*``: ``optimizer``).
22. Drives the async rules' main paths through their sessions, world 1,
    bf16, full width, 8 steps and a validation batch, each captured (the
    train step and the exchange, each a CUDA graph): VGG-16 'D' under
    ``EASGD()`` (BASELINE.json config 3: batch 32, lr 0.001, ``alpha``
    0.5, ``sync_freq`` 4), ResNet-50 under ``GOSGD()`` (config 4: batch
    32, lr 0.01, ``exch_prob`` 0.25, ``'perm'``) and AlexNet b128 under
    ``ASGD()`` (``sync_freq`` 1).  Every exchange is held against a
    plain recomputation from the tensors before it (EASGD's elastic
    update, within a few float32 ulps of a float64 one; bit for bit,
    ASGD's center and params equal after it and GoSGD's α exactly 1 and
    params unchanged at world 1); validation under EASGD
    scores the center; the rule state and ResNet-50's local BN state
    sit on the card, finite; AlexNet launches 2 B1 a forward and 2 B2 a
    backward.  Profiles VGG-16 EASGD and ResNet-50 GoSGD captured and
    eager (``foreach``: the update's and the exchange's multi-tensor
    passes), with one exchange timed alone (CUDA events).
23. The rest of the update layer on AlexNet b128: ``grad_clip`` at half
    the first step's gradient norm, the captured step's update against
    ``lr · clip/‖g‖ · g`` recomputed from the step's own dropout stream;
    ``ema_decay`` 0.999 (validation scores the shadow), ``nesterov`` and
    ``rmsprop`` through the session, costs finite.
24. Graph ≡ eager: each full-width main path (AlexNet synthetic, VGG-16
    under onebit, topk and powersgd, the LM with flash attention,
    GoogLeNet, ResNet-50, VGG-16 EASGD, ResNet-50 GoSGD, AlexNet ASGD),
    8 steps eager and 8 captured from the same seed, cuDNN
    deterministic: costs, params, optimizer, BN, wire and rule state bit
    for bit, and the same launch counts.
25. ``steps_per_call = 4`` captured (two windows) against 8 single
    captured steps, AlexNet, the LM, ResNet-50, VGG-16 EASGD at
    ``sync_freq`` 2 and 4 and ResNet-50 GoSGD (the exchange fused into
    the window against the worker's hook after single steps): state and
    window costs bit for bit.  Then ResNet-50 captured for 4 steps, a
    checkpoint, its BN tensors replaced by new ones and the checkpoint
    loaded into them, 4 more steps: the step must capture again and end
    bit for bit where the uninterrupted run ends.
26. AlexNet from the batch files under ``para_load`` at
    ``steps_per_call = 4``, both wires: the producer stages whole
    windows; every window the step took holds the host stream's bits.
27. The async islands around a center (A8b; ``--islands`` runs these
    alone): fails unless the card's compute mode lets several processes
    share it (``Default``); holds one island exchange of full-width
    AlexNet (a center in memory a random step away) against its plain
    recomputation: EASGD's params and center within ``EASGD_TOL`` of a
    float64 one, ASGD's center and params bit for bit.  Then AlexNet
    b128 as two island threads of this process (``EASGD().init(...,
    easgd_mode='async', async_islands=2, device='cuda:0',
    center_serve=True)``), and as two island processes (this script with
    ``--island``) around the port's center in a third
    (``center_server.center_main`` on a free port), under EASGD
    (``sync_freq`` 4) and ASGD (2), and VGG-16 b32 under EASGD as
    BASELINE.json config 3 names it, each with island 1 sleeping after
    every step: island 0 makes at least 3 exchanges and twice the
    straggler's steps; the center's count equals the islands'; the
    center is finite and moved; every island's params sit on the card,
    finite, its step captured, its costs finite, and AlexNet's islands
    launch 2 B1 and 2 B2 a step (each process's own counts; the threads'
    together).  Prints each island's step ms, pace (steps/s, img/s) and
    its exchanges' medians by part (drain, d2h, wire, the center's
    apply, h2d) and bytes.  Beside the islands, on the host, the port's
    lint gate (``python -m theanompi_tpu_torch.tools.lint
    --check-baseline --no-cache``) runs in a process of its own and must
    exit 0: oracle-pair then holds every kernel of this checkout to its
    plain version, its CPU test and its ``kernel_rows()`` row on the
    machine that builds the kernels.  Prints its findings, baselined
    entries and CPU seconds.
28. The launcher (A6; ``--launcher`` runs these alone): ``python -m
    theanompi_tpu_torch.launcher --n-workers 1`` trains AlexNet b128
    (``SmokeAlexNet``, this script as the modelfile) in a rank of its own,
    which must join a world-1 NCCL group over the launcher's TCP
    rendezvous on cuda:0, launch 2 B1 a forward and 2 B2 a backward, and
    end with the params of the same config trained through ``BSP()`` in
    this process, bit for bit; then ``--supervise 2 --backoff 0.1`` over
    2 epochs with a checkpoint each, once left alone and, beside it on
    the card at the same time, once with its worker SIGKILLed as
    ``LATEST`` reads 0: the killed run restarts, resumes from epoch 0 and
    ends with the unkilled run's final checkpoint, bit for bit; and one
    rank more than the visible GPUs is refused before anything is
    spawned.  The killed run takes ``--compile-cache build/smoke_cc``
    (emptied first): its first worker's start-up line shows ``lrn`` as a
    miss with nvcc's seconds, the restarted worker's as a hit, each with
    the start-up by part.  The supervised runs and the refusal run beside
    the world-1 phase.  Prints the seconds from launch to the first step,
    the step ms beside the in-process session's, and the seconds from the
    SIGKILL to the first resumed step.
28a. The elastic islands (A10 items 3 and 4a; ``--elastic`` runs them
    alone): one ``run_elastic`` EASGD run, 2 islands of AlexNet b128
    (``ElasticAlexNet``: full width, bf16, captured, the numerics plane
    on, traced) in processes of their own around a supervised center
    process, the fleet monitor on, under a progress-gated chaos schedule
    (``ELASTIC_FAULTS``): island 1 SIGKILLed, then island 2's first params
    leaf corrupted in place.  The schedule is the one the port's
    ``simfleet.FleetSim`` realizes at the live width (2 islands, one
    center shard, the fleet monitor on, no gossip mesh), exported and
    replayed (``simfleet.fidelity``), and the live per-island membership
    sequence must equal the simulated one.  Beside the run, on the host,
    ``python -m theanompi_tpu_torch.tools.simfleet_run --gate``
    (128-worker determinism, the 512-worker invariant suite under its
    CPU budget) must pass.  Checks exit 0 and both faults landed;
    island 1's ``worker_leave`` and its ``worker_join`` with ``rejoin``,
    its respawn starting from the center's params; in each island process
    that exited (the respawned one included) params on cuda:0, finite, a
    finite cost, a captured step and B1/B2 launched twice a step;
    ``replica_divergence`` on island 2, none before the corruption, and
    ``audit_alerts`` ok; the fleet monitor's exposition (its collector
    restored from its last snapshot) holding, for each island, a line of
    every series an island streams, ``hbm_headroom_bytes`` positive from
    the card; a finite ``center_final.npz``.  Prints the seconds from the kill to the leave,
    to the rejoin, to the respawn's first step and first exchange, from
    the corruption to its application and to the alert, and the islands'
    steps a second before and after the faults; on a line of its own both
    membership sequences, the simulation's CPU seconds and the gate's CPU
    seconds and event-log digests.  While the islands run, a thread takes
    ``tools.fleetz``'s frame (its ``--json --iterations 1`` rows) every
    0.25 s until one holds the live roster (both islands, the center, the
    supervisor, none DOWN); after the run ``tools.telemetry_report`` reads
    the record dir (``--json``, ``--trace``): every stream (the center's
    rank -1 among them), island 1's leave and rejoin, traced rounds, both
    islands ranked, spans in the trace.
29. The exchange wire's remaining forms (A7; ``--wire`` runs these
    alone), world 1 over NCCL, cuDNN deterministic, each run from the
    same seed: AlexNet b128 8 captured steps under ``exch_mode='params'``
    bit for bit the grads-mode run, ``exch_strategy='ring'`` the
    ``allreduce`` run, ``allreduce`` and ``nccl16`` at ``bucket_bytes`` 4
    MiB their monolithic runs, params mode captured its eager run (the
    exchange a graph of its own), 2 B1 and 2 B2 a step; VGG-16 b32 under
    onebit, topk, powersgd and EASGD (config 3) at 4 MiB bit for bit
    their monolithic runs (params, momentum, the strategy's or the
    center's state), ``n_buckets`` the JAX package's plan (132, 2, 1,
    19), B4 and B8 launched ``n_buckets`` times a step; B4 and B8 bucket
    by bucket into ``out=`` slices of one mean, bit for bit their plain
    versions, a bucket timed; profiles of VGG-16 onebit and topk,
    monolithic and at 4 MiB (NCCL's kernels, B4, B8, the copies), and of
    AlexNet in grads and params mode with one params-mode exchange timed
    alone; B8's bucket beside one accumulating ``index_put_`` of it.
30. The operations planes (A10 items 1 and 2; ``--ops`` runs these
    alone), cuDNN deterministic: AlexNet b128 under the BSP session,
    captured, 8 steps and a validation batch, with ``record_dir``,
    telemetry, tracing, the numerics plane (every step, then every 4th),
    ``stall_timeout`` 120 s and the sentry: each step's cost, the params
    and the momentum bit for bit the planes-off drive's, B1/B2 launched as
    without the planes; the stream's events, the numerics reports at the
    JAX cadence's iters, the summary sidecar, a statusz ``health`` reply
    asked from a host thread while it trains, no stall, no anomaly but a
    throughput one; the eager step with the plane on bit for bit the
    planes-off captured run, its sample bit for bit the captured one's,
    and within its float64 recomputation on the CPU from copies of the
    sampled step's gradient and params (norms rtol 1e-5, the digest within
    4e-6 of Σ w·Σ|x|, max|g|, the count and iter exactly);
    ``steps_per_call`` 4 at every 3 (the window ending at 8 samples 6, the
    state bit for bit); VGG-16 onebit b32 with the plane (state and B4–B6
    launches as without it, ``ef_norm`` within rtol 1e-5 of the error
    state's own float64 norm); an AlexNet whose step writes one +inf into
    a gradient (the count > 0, ``grad_overflow``, one flight dump); and
    the captured step's wall and device busy ms and device ops with the
    planes off, at every 4 and at every 1.  The every-1 session also
    takes ``trace_dir`` (``trace_start`` 3, ``trace_iters`` 4): its state
    and launches as above, and ``devprof``'s profile of the window: 4
    train dispatches, one lane, the compute per dispatch within 10% of the
    every-1 profile's device busy ms, the ``device.*`` gauges and one
    ``device_profile`` event in the stream; prints the top ops and the
    comm ops NCCL shows at world 1.
31. Data-parallel state sharding (A9a; ``--shard`` runs these alone),
    world 1 over NCCL, captured, cuDNN deterministic: AlexNet b128 and
    VGG-16 'D' b32 for 8 steps each under plain BSP, ``zero_opt``,
    ``update_sharding`` and ``fsdp``, each from seed 0: costs, params and
    the momentum (the chunks gathered) bit for bit plain BSP's (at world 1
    ``update_sharding`` shards nothing; ZeRO-1's chunk is the whole flat
    vector; FSDP's leaves are views of its gathered buffer at 256-byte
    aligned offsets, so cuDNN and cuBLAS choose as for the plain leaves);
    AlexNet launches 2 B1 and 2 B2 a step under each; then 6 profiled
    steps each: step wall ms, device busy ms, the gather, reduce-scatter,
    all-reduce, copy and optimizer kernels' device ms, the peak of
    allocated device memory, beside plain BSP's; and AlexNet under FSDP
    saved and resumed into a fresh model, its state and two more steps
    bit for bit.  Elastic resume (A10): AlexNet's ``zero_opt`` and
    ``fsdp`` world-1 checkpoints rewritten with this script's own numpy as
    the files of 2 and 4 workers, each loaded into a fresh captured model
    (a refit 2 → 1 and 4 → 1): params, momentum and the chunk bit for bit,
    then two more steps of the three models, costs and state bit for bit,
    B1 and B2 launches counted; the loads' seconds.  Under ``fsdp`` an
    ``async_ckpt`` save whose next step runs before the write is joined:
    every array of the landed file equal to a synchronous save of the same
    count, the file loading bit for bit; its blocking and join seconds.
32. The GANs and the rest of the LM at one rank (A9b, A9c; ``--gan-lm``
    runs these alone, with the flash build), cuDNN deterministic where
    runs are compared: WGAN (RMSprop 5e-5, ``n_critic`` 5, clip 0.01) and
    LSGAN (Adam 2e-4, ``n_critic`` 1 and 4), b64, ``base_width`` 64,
    ``z_dim`` 128, on synthetic Cifar10: one float32 training forward
    card vs CPU twin (same weights, batch and z), then 8 steps eager and
    8 captured, each step's gate checked (off the cadence G's params and
    every gated optimizer leaf bit for bit unchanged, D changed, D within
    ±clip), captured ≡ eager bit for bit, and 6 profiled steps; the MoE LM
    (LM_CFG's widths, 4 experts every 2nd block, top-1, capacity 1.25,
    aux 0.01) through the BSP session (8 steps, a validation batch, B10–B12
    as for the dense LM), 8 steps captured ≡ eager, profiled with its
    dispatch and combine as a group; the dense LM with and without
    ``remat``, 8 captured steps each, bit for bit, B10 2 × n_layer a step
    under remat, peak memory both ways, both profiled; ``generate`` on the
    trained MoE and dense LMs (b16, prompt 64, 256 new tokens, greedy) with
    the KV cache (B10 once a layer: the prefill) and by the full forward,
    tokens/s of each, each KV token against the full forward's greedy
    choice after the same prefix; and the LM trained 8 steps from uint16
    token files the script writes under ``build/smoke_tokens``.
33. The port's tools (A13; ``--tools`` runs these alone, after profiling
    the AlexNet synthetic row), each run in this process through its
    ``main(argv)`` on the card: ``profile_model alexnet 128 5`` (AlexNet
    b128 BSP captured, 5 traced dispatches after the profiler's warm-up;
    its launches, one lane, B1 and B2 twice a dispatch in the trace (their
    places among its op classes printed), and devprof's compute a
    dispatch within 10% of the AlexNet synthetic row's device busy ms a
    step less its HtoD copy);
    ``scaling_sweep`` AlexNet b128 at world 1 under ``allreduce`` and
    ``onebit`` (img/s a row; B1/B2, and the onebit wire's B4–B6, launched
    once a step, B3 not); ``loader_bench --prefetch --u8-wire`` over the
    ``para_load`` phase's batch files (host img/s and GB/s, and the pinned
    staging rate to the card); ``async_vs_sync_easgd --seconds 10``
    (Cifar10 b16: 20 synchronous-cadence steps against 2 island threads
    sharing the card); ``rules_time_to_acc 0.5 --epochs 2`` (the four
    rules at world 1 on synthetic Cifar10, 512 samples, finite validation
    costs).  Prints each tool's numbers and the group's seconds by tool.
34. Prints ``{"kernels": [...]}`` (B1–B12 and B10–B12 in float32; B1/B2
    with GoogLeNet's shapes beside AlexNet's, and the island, launcher and
    sharded paths' counts;
    B4 and B8 with their bucketed launches and per-bucket times; B10–B12
    with their launches on the A9c paths, and under ``pp_stage`` and
    ``tp_rank`` their times at a pp stage's and a tp rank's shapes and
    their launches read from the stage and ep rank paths), then the card,
    then the last
    line ``{"ok": true, "device": {...}}``.

Any failed check raises: the script exits non-zero and prints no result.
TF32 is off for the whole run (float32 comparisons need it off; the main
paths compute in bfloat16 and are unaffected).
"""

import atexit
import concurrent.futures
import contextlib
import ctypes
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings

import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(2)

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import theanompi_tpu_torch as tmpi  # noqa: E402
from theanompi_tpu_torch.ops import _kernel_build  # noqa: E402
from theanompi_tpu_torch.ops import compress as cmp_ops  # noqa: E402
from theanompi_tpu_torch.ops import factor_pack as fp_ops  # noqa: E402
from theanompi_tpu_torch.ops import flash_attention as fa_ops  # noqa: E402
from theanompi_tpu_torch.ops import lrn as lrn_ops  # noqa: E402
from theanompi_tpu_torch.models.alex_net import AlexNet  # noqa: E402
from theanompi_tpu_torch.tools.loader_bench import (  # noqa: E402
    smooth_mean_chw, write_batch_files)
from theanompi_tpu_torch.utils.helper_funcs import (  # noqa: E402
    get_leaf, leaf_paths, tree_leaves, tree_map)

# H100 SXM peaks (NVIDIA data sheet, at its 700 W limit): device memory
# rate, and float32 outside the tensor cores (the kernels' math is f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12        # dense, tensor cores
# float32-accurate products on the tensor cores in split TF32: three TF32
# products (495 TFLOP/s dense) for each float32 one.  The bound of the
# float32 flash rows (B10–B12 f32 run so), beside their FFMA bound at
# F32_FLOPS_PER_S
SPLIT_TF32_FLOPS_PER_S = 495e12 / 3

#: The deliberate bf16 roundings of the phases' references (the lint's
#: dtype-flow reads this).
NONBITEXACT = {
    "pp_stage_path_phase": "the stage output's gradient is made of bf16 "
                           "values, the same on every side of the comparison",
    "attention_bf16_probs": "the reference rounds the probabilities to bf16 "
                            "before P·V, as the flash kernel does",
}

BATCH = 128
STEPS = 8
VAL_BATCHES = 1
PROFILE_STEPS = 6
LRN_N = 5
# main-path LRN inputs of AlexNet at batch 128, NHWC
SHAPES = {"lrn1": (BATCH, 55, 55, 96), "lrn2": (BATCH, 27, 27, 256)}
# and of GoogLeNet at batch 32: after the stem's pool1 and its conv2
ZOO_BATCH = 32
GOOGLENET_LRN = {"lrn1": (ZOO_BATCH, 56, 56, 64),
                 "lrn2": (ZOO_BATCH, 56, 56, 192)}
# the zoo's smoke learning rates.  At their own rates, GoogLeNet (0.01)
# reaches NaN within 8 steps (first costs ~100: He init on mean-subtracted,
# unscaled pixels, as VGG-16), while ResNet-50 (0.1) and Cifar10 (0.05)
# stay finite with rising costs (7.1 → 29.1 and 4.6 → 8.7 over 8 steps,
# H100, 700 W); at these they descend
ZOO_LR = {"GoogLeNet": 0.001, "ResNet50": 0.01, "Cifar10_model": 0.01}
# flops per element counted from the formula in csrc/lrn.cu: the window
# (2 per tap), then d, s and the products
FLOPS_PER_ELEM = {"fwd": 2 * LRN_N + 7, "bwd": 4 * LRN_N + 14}
TOL = {  # (rtol, atol as a fraction of max|plain|)
    # f32: the 5-tap window sums in another order than the band product
    "float32": {"fwd": (2e-6, 2e-6), "bwd": (2e-5, 2e-5)},
    # bf16: one bf16 rounding of f32 results on each side, one ulp = 2^-8
    "bfloat16": {"fwd": (2.0 ** -7, 2.0 ** -12), "bwd": (2.0 ** -7, 2.0 ** -12)},
}

VGG_BATCH = 32
VGG_STEPS = 8
# VGG-16 at its own learning rate (0.01) reaches NaN within 8 steps under
# allreduce and onebit alike (He init on mean-subtracted, unscaled pixels:
# the initial cost is ~90); the smoke trains at 0.001, where it descends
VGG_LR = 0.001
# grad_clip on the card: the captured step's params against sgd's
# arithmetic on the plainly clipped gradient, the largest difference as a
# fraction of the largest step (the two norms sum in other orders: an ulp
# of a parameter, ~1e-5 of a step; an unclipped or wrongly scaled update
# would be off by a whole step)
CLIP_RTOL = 1e-3
# EASGD's exchange against its float64 recomputation: a few float32
# roundings (the delta, the product, the sum) of values no larger than
# the leaf's, so within an ulp or two of each value plus an ulp of the
# leaf's largest (where c + α·d cancels); a missing or wrong pull moves
# values by α·d, orders of magnitude more
EASGD_TOL = (2.0 ** -21, 2.0 ** -22)      # (rtol, atol / max|leaf|)
# decode widths held against the plain version: the main path's (1 rank)
# and stacked buffers of 4 and 8 ranks
DECODE_WORKERS = (1, 4, 8)
# the topk wire of VGG-16: TopK's chunk and k = round(0.01 · chunk)
TOPK_CHUNK, TOPK_K = 8192, 82
POWERSGD_RANK = 2

# the LM of scripts/perf_matrix_r5.sh's transformer_lm-b16-flash row
# (LM_CFG of scripts/_bench_row.sh): d512, 8 heads, 8 layers, T512, vocab
# 32768, batch 16, Adam at the model's lr 3e-3
LM_CFG = dict(attn_impl="flash", d_model=512, n_head=8, n_layer=8,
              seq_len=512, vocab=32768)
LM_BATCH = 16
LM_STEPS = 8
# a pipeline stage of that row: pp 2, its batch in pp_microbatches = 2·pp
# microbatches (parallel/pipeline.py), L/pp = 4 blocks a stage
PP_STAGE = {"pp": 2, "microbatches": 4}
LM_CHECK_BATCH = 2
# the flash kernels against their plain versions: both round their f32
# sums to bf16 once (summed in another order) and round p and dS to bf16
# at the same points: one or two bf16 ulps (2^-8) of the outputs' scale
FLASH_TOL = (2.0 ** -7, 2.0 ** -7)          # (rtol, atol / max|plain|)
# the whole LM in bf16 against the same LM in float32, batch 2: at random
# init every gradient leaf of the bf16 model is ~8% (relative L2) from the
# float32 one whatever the attention (bf16 activations through 8 layers);
# flash must be as close as the bf16 reference attention, within a factor
# (it rounds p and dS to bf16 and takes di from the bf16 o, where the
# reference attends in f32): its gradients no further than LM_GRAD_RATIO
# times the reference's distance, its loss within LM_LOSS_RTOL (on an
# H100 the bf16 losses are 1.1e-5 (flash) and 3.7e-6 (reference) from it)
LM_LOSS_RTOL = 1e-4
LM_GRAD_RATIO = 2.0
# the float32 flash kernels (A11) against their float32 plain versions,
# TF32 off on both sides: float32-accurate products summed in another
# order (split TF32, each product within 3·2^-22 of its float32 value,
# the tensor core's sums folded into float32 registers; B10 rescales its
# sums every 32 keys).  An output sums up to T = 512 products, and
# reordering a float32 sum moves it by at most n·2^-24 of its largest
# partial sum (2^-15 at n = 512); expf/logf differ from torch's by an ulp
# or two: 2^-14 of max|plain| holds both.  A plain TF32 product (10-bit
# mantissa, ~2^-11) would be ~1e-3 away and fail it
F32_FLASH_TOL = (2.0 ** -14, 2.0 ** -14)   # (rtol, atol / max|plain|)
# a tp rank of that row: tp 2 (ep 2 in the MoE LM), n_head/tp = 4 heads a
# rank, the whole b16 batch
TP_RANK = {"tp": 2}
# (name, [B, H, T, hd], causal, laid out as the model hands them): the
# LM's main-path shape, one non-causal at hd 128, one strided at hd 32
# with T a multiple of 64 and not of 128, a pp stage's microbatch of the
# LM's, a tp rank's heads of it (appended last: each shape's inputs are
# seeded by its index); F32_TIMED are timed
F32_FLASH_SHAPES = (
    ("lm", (LM_BATCH, 8, 512, 64), True, True),
    ("noncausal", (4, 8, 256, 128), False, False),
    ("strided", (2, 4, 320, 32), True, True),
    ("pp_stage", (LM_BATCH // PP_STAGE["microbatches"], 8, 512, 64), True,
     True),
    ("tp_rank", (LM_BATCH, 8 // TP_RANK["tp"], 512, 64), True, True))
F32_TIMED = ("lm", "pp_stage", "tp_rank")
# the float32 flash LM at batch 2 on the card (kernels B10–B12 f32, cuBLAS
# f32 with TF32 off) against the same weights and batch on the CPU (the
# plain versions): both sides are float32 end to end, so they differ only
# by the order of float32 sums.  The loss is a well-conditioned mean (its
# two sides 9e-8 apart on an H100): LM_F32_LOSS_RTOL.  The gradients at
# random init are not: many leaves are small sums of large cancelling
# terms, so a leaf's card-vs-CPU distance in relative L2 is set by the
# model more than by the attention (up to 1.6e-3 with the reference
# attention on both sides).  That floor is measured in the same run, leaf
# by leaf, with the reference attention on both sides; the flash model's
# distance of each leaf may be at most LM_F32_GRAD_RATIO times it, as the
# bf16 check's LM_GRAD_RATIO.  The same run holds a control to the same
# limit, which must fail it: the reference attention with its
# probabilities rounded to bfloat16 on the card (and so dP, through the
# cast's backward), what a kernel that is not float32 throughout gives.
# The kernels themselves are held to F32_FLASH_TOL above.
LM_F32_LOSS_RTOL = 1e-5
LM_F32_GRAD_RATIO = 2.0
# B10–B12 before their Hopper redesign (the first, nvcuda::wmma kernels),
# at the flash phase's shape: device ms from this script's flash phase on
# that tree; host µs per wrapper call, for B10 and B11 the least of two
# `chip_smoke.py --flash-times` runs on it (host times of one call spread
# by ±15 µs), for B12 this script's flash phase; all on an NVIDIA H100
# 80GB HBM3 at 700 W
WMMA_FLASH = {"flash_fwd_cuda": {"ms": 0.0978, "host_us": 43.4},
             "flash_bwd_dkv_cuda": {"ms": 0.1372, "host_us": 52.6},
             "flash_bwd_dq_cuda": {"ms": 0.1091, "host_us": 60.9}}
# B7 before its radix select (k block-wide argmax passes a row), at the
# topk phase's shape: device ms from this script's topk phase on that tree,
# on the same card and limit
ARGMAX_TOPK = {"topk_encode_cuda": {"ms": 3.8553}}
# B9 before its grouped redesign (one rowdot or coldot launch per leaf and
# product), per PowerSGD step: device ms from this script's factor pack
# phase on that tree, on the same card and limit
ROWCOL_FACTOR = {"ms": 0.8050}
# instructions the redesigned B10–B12, bf16 and float32, must hold in
# every instantiation: wgmma and TMA loads
FLASH_SASS = {"flash_fwd_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dkv_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dq_kernel": ("HGMMA", "UTMALDG"),
              "flash_fwd_f32_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dkv_f32_kernel": ("HGMMA", "UTMALDG"),
              "flash_bwd_dq_f32_kernel": ("HGMMA", "UTMALDG")}
# the TF32 probe: inputs whose float32 bits go to the tensor core as they
# are, and the largest relative distance from a model's product that still
# reads as that model (float32 sums of 8 products: ~1e-7 on an H100; the
# other models' products lie ~1e-3 away)
TF32_PROBE_TOL = 1e-5
# what each redesigned kernel is now, for the kernels line
DESIGN = {"topk_encode": "radix select on the bits of |c|, lowest offsets on "
                         "the threshold's ties, slots by rank count (k <= "
                         "256) or bitonic sort",
          "flash_fwd": "TMA ring, wgmma, softmax in registers, pipelined",
          "flash_bwd_dkv": "TMA ring, wgmma, p and dS in registers",
          "flash_bwd_dq": "TMA ring, wgmma, dS in registers",
          "flash_fwd_f32": "split-TF32 wgmma, q resident and 32-row k/v "
                           "tiles by TMA, k's hi/lo and a transposed v copy "
                           "made by the consumers, online softmax on the "
                           "score accumulator (rescaled every 32 keys), "
                           "each k-step's and tile's tensor-core sum added "
                           "in float32 registers, 3 CTAs an SM",
          "flash_bwd_dkv_f32": "split-TF32 wgmma (hi and lo rounded to TF32),"
                               " 32-row q/dO tiles by TMA, their hi/lo and "
                               "transposed copies made by the consumers, "
                               "each k-step's and tile's tensor-core sum "
                               "added in float32 registers, p and dS in "
                               "registers, 2 CTAs an SM",
          "flash_bwd_dq_f32": "split-TF32 wgmma, 32-row k/v tiles by TMA, "
                              "their hi/lo and a transposed k copy made by "
                              "the consumers, tensor-core sums added in "
                              "float32 registers, dS in registers, 2 CTAs "
                              "an SM",
          "unpack_signs_wsum": "8 CTAs of 256 threads a 32768-element "
                               "tile (a 4 MiB bucket fills the card), 4 "
                               "bit rows a thread, words read and outputs "
                               "written 16 bytes a thread, sums in "
                               "registers in worker order",
          "matmul_pack": "one launch per factor pass over every leaf; each "
                         "work item a cluster of 8 CTAs splitting its sums, "
                         "added through distributed shared memory in rank "
                         "order; float4 loads, 4 rows in flight",
          "lrn_bwd": "persistent grid (SMs x resident blocks); x and dy "
                     "through a 2-stage ring of bulk copies on mbarriers; "
                     "x, dy and s in registers, only t in shared memory "
                     "(two planes in bf16); no division"}
# the bulk copy (cp.async.bulk) that every vector build of B2
# (lrn_bwd_kernel<T, VEC > 1, HALF, ASYNC = true>) is designed around; the
# VEC = 1 builds copy plainly
LRN_SASS = "UBLKCP"

ALL_KERNELS = ((lrn_ops.lrn_fwd_cuda, lrn_ops.lrn_bwd_cuda) + cmp_ops.KERNELS
               + fp_ops.KERNELS + fa_ops.KERNELS)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` calls in a row,
    divided by ``inner``; the median of ``reps`` such runs, after warm-up.
    Each run first queues a ~5 ms device sleep, so the host has enqueued
    all ``inner`` calls before the card reaches the first: the stream
    never waits on the host between them, and a kernel shorter than its
    launch's host cost is still timed on the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)         # cycles: ~5 ms at 1.98 GHz
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def graph_ms(fn, reps: int = 5, inner: int = 2) -> float:
    """Device time of one call of ``fn`` captured in a CUDA graph (three
    eager calls on a side stream first, as ``parallel/graph.py`` warms a
    step), its replays timed by :func:`time_ms`: a replay is one host
    call, so the device sleep covers the host's enqueue however many
    kernels and autograd nodes ``fn`` runs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    ms = time_ms(graph.replay, reps=reps, inner=inner, warmup=1)
    del graph
    return ms


def check_close(name, got, want, rtol, atol_frac):
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    atol = atol_frac * float(want.abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version, max |diff| {err:.3e} "
                             f"(rtol {rtol}, atol {atol:.3e})")
    return err


def check_bits(name, got, want) -> float:
    """Bit for bit (float tensors compared as their int32 bit patterns),
    except that a NaN may carry another payload where both sides hold a
    NaN (inf − inf in a residual, a sum of ±inf)."""
    g = got.view(torch.int32) if got.is_floating_point() else got
    w = want.view(torch.int32) if want.is_floating_point() else want
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shapes {tuple(g.shape)} and "
                             f"{tuple(w.shape)}")
    same = g == w
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    if not bool(same.all()):
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"in {int((~same).sum())} elements")
    return 0.0


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zero_launches() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in ALL_KERNELS}


def expect(**launches) -> dict:
    """Launch counts of a main path: those named, 0 for every other
    kernel."""
    return dict({k.__name__: 0 for k in ALL_KERNELS}, **launches)


def lrn_phase(shapes=SHAPES):
    """B1/B2 against the plain version and the library call, per shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"fwd": [], "bwd": []}
    for label, shape in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
            dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
            y = lrn_ops.lrn_fwd_cuda(x)
            dx = lrn_ops.lrn_bwd_cuda(x, dy)
            # B2 has no atomics: a rerun is bit-equal
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            check_bits(f"B2 {label} {dn} rerun",
                       lrn_ops.lrn_bwd_cuda(x, dy).view(bits), dx.view(bits))
            xp = x.detach().clone().requires_grad_(True)
            yp = lrn_ops.lrn_plain(xp)
            (dxp,) = torch.autograd.grad(yp, xp, dy)
            torch.cuda.synchronize()
            e_f = check_close(f"B1 {label} {dn}", y, yp, *TOL[dn]["fwd"])
            e_b = check_close(f"B2 {label} {dn}", dx, dxp, *TOL[dn]["bwd"])
            if dtype != torch.bfloat16:       # the main path's type is timed
                out["fwd"].append({"shape": label, "dtype": dn,
                                   "max_abs_err": e_f})
                out["bwd"].append({"shape": label, "dtype": dn,
                                   "max_abs_err": e_b})
                continue
            nchw = x.permute(0, 3, 1, 2)      # the library's channel dim is 1
            xl = nchw.detach().clone().requires_grad_(True)
            dyl = dy.permute(0, 3, 1, 2)

            def lib_fwd():
                return F.local_response_norm(nchw, LRN_N, 1e-4, 0.75, 2.0)

            def lib_fwd_bwd():
                return torch.autograd.grad(
                    F.local_response_norm(xl, LRN_N, 1e-4, 0.75, 2.0), xl,
                    dyl)

            def plain_bwd():
                return torch.autograd.grad(lrn_ops.lrn_plain(xp), xp, dy)

            numel = x.numel()
            isz = x.element_size()
            for kind, kern, plain, lib, nbytes in (
                    ("fwd", lambda: lrn_ops.lrn_fwd_cuda(x),
                     lambda: lrn_ops.lrn_plain(x), lib_fwd, 2 * numel * isz),
                    ("bwd", lambda: lrn_ops.lrn_bwd_cuda(x, dy), plain_bwd,
                     lib_fwd_bwd, 3 * numel * isz)):
                out[kind].append({
                    "shape": label, "dims": list(shape), "dtype": dn,
                    "max_abs_err": e_f if kind == "fwd" else e_b,
                    "ms": time_ms(kern), "plain_ms": time_ms(plain),
                    "library_ms": time_ms(lib),
                    **bound(nbytes, FLOPS_PER_ELEM[kind] * numel)})
            del x, dy, xp, yp, dxp, xl, nchw, dyl
            torch.cuda.empty_cache()
    return out


def lrn_times() -> dict:
    """``python3 chip_smoke.py --lrn-times``: B2's device ms, B1's beside
    it, at the four main-path LRN shapes (AlexNet's two at batch 128,
    GoogLeNet's two at batch 32), bf16, each shape first held against the
    plain version; per model, one step's sums (two LRNs)."""
    _kernel_build.build(["lrn"])
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for model, shapes in (("AlexNet", SHAPES), ("GoogLeNet", GOOGLENET_LRN)):
        for label, shape in shapes.items():
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(
                torch.bfloat16)
            dy = torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16)
            xp = x.detach().clone().requires_grad_(True)
            yp = lrn_ops.lrn_plain(xp)
            (dxp,) = torch.autograd.grad(yp, xp, dy)
            name = f"{model} {label} bfloat16"
            e_f = check_close(f"B1 {name}", lrn_ops.lrn_fwd_cuda(x), yp,
                              *TOL["bfloat16"]["fwd"])
            e_b = check_close(f"B2 {name}", lrn_ops.lrn_bwd_cuda(x, dy), dxp,
                              *TOL["bfloat16"]["bwd"])
            numel, isz = x.numel(), x.element_size()
            rows.append({
                "model": model, "shape": label, "dims": list(shape),
                "b2_ms": time_ms(lambda: lrn_ops.lrn_bwd_cuda(x, dy)),
                "b1_ms": time_ms(lambda: lrn_ops.lrn_fwd_cuda(x)),
                "b2_bound_ms": bound(3 * numel * isz,
                                     FLOPS_PER_ELEM["bwd"] * numel)[
                                         "bound_ms"],
                "b1_bound_ms": bound(2 * numel * isz,
                                     FLOPS_PER_ELEM["fwd"] * numel)[
                                         "bound_ms"],
                "b2_max_abs_err": e_b, "b1_max_abs_err": e_f})
            print(json.dumps(rows[-1]), flush=True)
            del x, dy, xp, yp, dxp
            torch.cuda.empty_cache()
    steps = {}
    for r in rows:
        st = steps.setdefault(r["model"], {})
        for k in ("b2_ms", "b1_ms", "b2_bound_ms", "b1_bound_ms"):
            st[k] = st.get(k, 0.0) + r[k]
    return {"rows": rows, "steps": steps}


def vgg16_sizes():
    """VGG-16's parameter count at 1000 classes and its length padded to
    PACK_ALIGN (what the onebit wire packs), from the layer shapes."""
    from theanompi_tpu_torch.models.vggnet_16 import _VGG16_BLOCKS, _vgg_stack
    n = 0
    for layer in _vgg_stack(_VGG16_BLOCKS, "bfloat16", 1000).layers:
        if hasattr(layer, "kernel"):
            n += layer.in_ch * layer.out_ch * 9 + layer.out_ch
        elif hasattr(layer, "n_in"):
            n += layer.n_in * layer.n_out + layer.n_out
    return n, n + (-n) % cmp_ops.PACK_ALIGN


def compress_phase():
    """B3–B6 at VGG-16's padded length: bit for bit against the plain
    versions (B4 within its bound at W > 1), times, bounds."""
    n_true, n = vgg16_sizes()
    g = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn(n, generator=g, device="cuda")
    state = torch.randn(n, generator=g, device="cuda") * 0.1
    flat[::9973] = 0.0                      # c = +0.0 + +0.0
    state[::9973] = 0.0
    flat[1::10007] = -0.0                   # c = −0.0 + −0.0 = −0.0
    state[1::10007] = -0.0
    flat[n_true:] = 0.0                     # the pad, as the wire has it
    state[n_true:] = 0.0
    zero_launches()
    words = cmp_ops.pack_signs_cuda(flat)
    kp, ka = cmp_ops.pack_signs_encode_cuda(flat, state)
    scale = ka[:n_true].mean() + 1e-12
    kr = cmp_ops.signed_residual_cuda(ka, kp, scale)
    torch.cuda.synchronize()
    checked = launch_counts()
    err = {"pack_signs_cuda": check_bits("B3", words,
                                         cmp_ops.pack_signs_plain(flat))}
    pp, pa = cmp_ops.pack_signs_encode_plain(flat, state)
    check_bits("B5 words", kp, pp)
    err["pack_signs_encode_cuda"] = check_bits("B5 |c|", ka, pa)
    err["signed_residual_cuda"] = check_bits(
        "B6", kr, cmp_ops.signed_residual_plain(pa, pp, scale))
    del pp, pa, words
    m = kp.shape[0]

    decode = []
    for w in DECODE_WORKERS:
        allp = kp[None] if w == 1 else torch.randint(
            -2 ** 31, 2 ** 31, (w, m, cmp_ops.LANES), generator=g,
            device="cuda", dtype=torch.int32)
        scales = (scale / w).reshape(1) if w == 1 else \
            torch.rand(w, generator=g, device="cuda") + 0.1
        got = cmp_ops.unpack_signs_wsum_cuda(allp, scales)
        want = cmp_ops.unpack_signs_weighted_sum_plain(allp, scales)
        torch.cuda.synchronize()
        if w == 1:
            e = check_bits("B4 W=1", got, want)
        else:
            rtol, atol = cmp_ops.decode_tol(w, scales)
            e = check_close(f"B4 W={w}", got, want, rtol,
                            atol / float(want.abs().max()))
        del got, want
        decode.append({
            "workers": w, "max_abs_err": e,
            "ms": time_ms(lambda: cmp_ops.unpack_signs_wsum_cuda(allp,
                                                                 scales)),
            "plain_ms": time_ms(lambda: cmp_ops.unpack_signs_weighted_sum_plain(
                allp, scales), reps=5, inner=2, warmup=1),
            # read W·n/8 bytes of words and W scales, write 4n
            **bound(w * n / 8 + 4 * w + 4 * n, (2 * w + 1) * n)})
        del allp
        torch.cuda.empty_cache()

    # bytes: each input read once, each output written once; flops: the
    # float32 operations per element of csrc/compress.cu
    rows = {
        "pack_signs_cuda": (lambda: cmp_ops.pack_signs_cuda(flat),
                            lambda: cmp_ops.pack_signs_plain(flat),
                            4 * n + n / 8, n),
        "pack_signs_encode_cuda": (
            lambda: cmp_ops.pack_signs_encode_cuda(flat, state),
            lambda: cmp_ops.pack_signs_encode_plain(flat, state),
            8 * n + 4 * n + n / 8, 3 * n),
        "signed_residual_cuda": (
            lambda: cmp_ops.signed_residual_cuda(ka, kp, scale),
            lambda: cmp_ops.signed_residual_plain(ka, kp, scale),
            4 * n + n / 8 + 4 + 4 * n, n),
    }
    out = {"n": n, "n_true": n_true, "checked_launches": checked,
           "decode": decode}
    for name, (kern, plain, nbytes, flops) in rows.items():
        out[name] = {"max_abs_err": err[name], "ms": time_ms(kern),
                     "plain_ms": time_ms(plain, reps=5, inner=2, warmup=1),
                     **bound(nbytes, flops)}
    out["unpack_signs_wsum_cuda"] = dict(decode[0], max_abs_err=max(
        d["max_abs_err"] for d in decode))
    del flat, state, kp, ka, kr
    torch.cuda.empty_cache()
    return out


def topk_inputs(n_true: int) -> torch.Tensor:
    """c2 [16890, 8192] of VGG-16's padded length, random with planted rows
    every 997th row: all-zero rows (+0.0 and −0.0), equal magnitudes, pairs
    of equal |c|, −0.0 inside a row; and the radix select's stress rows:
    |c| sharing their top 16 bits, more than k entries equal to the
    threshold after (at higher offsets than) the strictly larger ones,
    subnormals (with zeros), and ±inf among normal values."""
    rows = -(-n_true // TOPK_CHUNK)
    g = torch.Generator(device="cuda").manual_seed(2)
    c2 = torch.randn(rows, TOPK_CHUNK, generator=g, device="cuda")
    c2.view(-1)[n_true:] = 0.0              # the pad, as the wire has it
    c2[::997] = 0.0                         # all-zero rows (+0.0 and −0.0)
    c2[::997, 1::3] = -0.0
    c2[1::997, ::4] = 0.5                   # planted equal magnitudes
    c2[1::997, 2::8] = -0.5
    c2[2::997, ::2] = -c2[2::997, 1::2]     # pairs of equal |c|
    c2[3::997, 5::7] = -0.0                 # −0.0 inside a row

    def bits(lo, hi, n):                    # random bits with random signs
        b = torch.randint(lo, hi, (n, TOPK_CHUNK), generator=g,
                          device="cuda", dtype=torch.int32)
        neg = torch.rand(n, TOPK_CHUNK, generator=g, device="cuda") < 0.5
        return torch.where(neg, b | torch.iinfo(torch.int32).min,
                           b).view(torch.float32)

    n = c2[4::997].shape[0]
    c2[4::997] = bits(0x3f800000, 0x3f810000, n)    # one top 16 bits
    ties = TOPK_K // 2
    c2[5::997] = torch.randn(n, TOPK_CHUNK, generator=g, device="cuda") * 0.01
    c2[5::997, :ties] = 10.0 + torch.arange(ties, device="cuda")
    c2[5::997, ties::2] = bits(0x40a00000, 0x40a00001, n)[:, ties::2]   # ±5
    c2[6::997] = bits(1, 1 << 23, n)                # subnormals
    c2[6::997, ::9] = 0.0
    c2[7::997, 3::TOPK_CHUNK // 3] = float("inf")
    c2[7::997, 5::TOPK_CHUNK // 4] = float("-inf")
    return c2


def topk_phase(n_true: int):
    """B7/B8 at VGG-16's padded shape [16890, 8192], k = 82, on
    :func:`topk_inputs`: bit for bit against the plain versions (B8 at 1, 4
    and 8 stacked workers, with the /size mean), times, byte bounds,
    library yardsticks."""
    c2 = topk_inputs(n_true)
    rows = c2.shape[0]
    n, k = rows * TOPK_CHUNK, TOPK_K
    zero_launches()
    kv, ki, ks = cmp_ops.topk_encode_cuda(c2, k)
    torch.cuda.synchronize()
    checked = launch_counts()
    pv, pi, ps = cmp_ops.topk_encode_plain(c2, k)
    check_bits("B7 values", kv.view(torch.int16), pv.view(torch.int16))
    check_bits("B7 offsets", ki, pi)
    err7 = check_bits("B7 state", ks, ps)
    del pv, pi, ps
    torch.cuda.empty_cache()

    base = (torch.arange(rows, device="cuda") * TOPK_CHUNK).reshape(rows, 1)
    dense = torch.empty(n, device="cuda")
    decode = []
    for w in DECODE_WORKERS:
        # w ranks' rows (row-rolled copies: a rank's offsets in a row stay
        # distinct), decoded into their mean (÷ w; no division at w = 1)
        av = torch.stack([kv.roll(i, 0) for i in range(w)])
        ai = torch.stack([ki.roll(i, 0) for i in range(w)])
        # against the plain decode on the CPU: on the card its index_add_
        # adds with float atomics, which flush subnormal values to zero
        # (the subnormal stress rows send some); B8 keeps them, as the jnp
        # oracle does
        got = cmp_ops.topk_decode_cuda(av, ai, TOPK_CHUNK, w)
        want = cmp_ops.topk_decode_plain(av.cpu(), ai.cpu(), TOPK_CHUNK, w)
        torch.cuda.synchronize()
        e = check_bits(f"B8 W={w}", got.cpu(), want)
        del got, want
        gidx = (ai.long() + base).reshape(-1)
        fv = av.float().reshape(-1)
        decode.append({
            "workers": w, "max_abs_err": e,
            "ms": time_ms(lambda: cmp_ops.topk_decode_cuda(av, ai, TOPK_CHUNK,
                                                           w)),
            "plain_ms": time_ms(lambda: cmp_ops.topk_decode_plain(
                av, ai, TOPK_CHUNK, w), reps=5, inner=2, warmup=1),
            # the scatter alone: no bf16 cast, no global-index arithmetic,
            # no ÷ w, atomics' order of adds
            "library_ms": time_ms(lambda: dense.zero_().index_put_(
                (gidx,), fv, accumulate=True)),
            # read w·rows·k (bf16 + int16), write 4n; one add per slot and
            # one division per element when w > 1
            **bound(4 * w * rows * k + 4 * n,
                    w * rows * k + (n if w > 1 else 0))})
        del av, ai, gidx, fv
        torch.cuda.empty_cache()
    out = {"rows": rows, "chunk": TOPK_CHUNK, "k": k, "n": n,
           "checked_launches": checked, "decode": decode,
           "topk_decode_cuda": dict(decode[0], max_abs_err=max(
               d["max_abs_err"] for d in decode)),
           "topk_encode_cuda": {
               "max_abs_err": err7, "ms": time_ms(
                   lambda: cmp_ops.topk_encode_cuda(c2, k)),
               "plain_ms": time_ms(lambda: cmp_ops.topk_encode_plain(c2, k),
                                   reps=5, inner=2, warmup=1),
               # the selection alone (an |c| pass, then k largest in
               # torch's tie order): no bf16 values, no int16 offsets, no
               # residual state
               "library_ms": time_ms(lambda: torch.topk(c2.abs(), k, dim=1)),
               # read 4n, write the state 4n and 4 bytes a slot; an abs and
               # a compare per element select the row's k largest
               **bound(8 * n + 4 * rows * k, 2 * n)}}
    del c2, kv, ki, ks, dense, base
    torch.cuda.empty_cache()
    return out


def vgg16_factor_shapes():
    """``A = leaf.reshape(shape[0], -1)`` of each VGG-16 weight PowerSGD
    compresses at rank 2 (min(rows, cols) > 8: all 13 convs and 3 FCs)."""
    from theanompi_tpu_torch.models.vggnet_16 import _VGG16_BLOCKS, _vgg_stack
    out = []
    for layer in _vgg_stack(_VGG16_BLOCKS, "bfloat16", 1000).layers:
        if hasattr(layer, "kernel"):
            kh, kw = layer.kernel
            out.append((layer.out_ch, layer.in_ch * kh * kw))
        elif hasattr(layer, "n_in"):
            out.append((layer.n_out, layer.n_in))
    assert len(out) == 16 and all(min(s) > 4 * POWERSGD_RANK for s in out)
    return out


def factor_inputs():
    """A of each of VGG-16's 16 compressible weights (``* 0.01``, about a
    gradient's scale) and, per pass, the factor it is multiplied with at
    rank 2: q [out_ch, r] for P = Aᵀ q (transpose) and p [in, r] for
    Q' = A p."""
    g = torch.Generator(device="cuda").manual_seed(3)
    r = POWERSGD_RANK
    mats = [torch.randn(co, rest, generator=g, device="cuda") * 0.01
            for co, rest in vgg16_factor_shapes()]
    return mats, {t: [torch.randn(a.shape[0] if t else a.shape[1], r,
                                  generator=g, device="cuda") for a in mats]
                  for t in (True, False)}


def factor_pass_check(mats, qs, t) -> list:
    """One B9 pass against the plain version: each leaf's tile within the
    float32 dot-product bound 2·γ_n·(|m| @ |q|), γ_n = n·u/(1 − n·u),
    u = 2⁻²⁴ (each side's sum of n products in its own order), its pad
    rows exactly +0.  The grouped pass is also run twice, bit for bit the
    same, and each of its tiles is bit for bit the one-leaf entry's (a
    tree from before the grouped kernel has only the one-leaf entry).  Per
    leaf: (max |diff|, max diff/bound)."""
    u = 2.0 ** -24
    group = getattr(fp_ops, "matmul_pack_group_cuda", None)
    ones = [fp_ops.matmul_pack_cuda(a, q, transpose=t)
            for a, q in zip(mats, qs)]
    if group:
        ts = [t] * len(mats)
        got = group(mats, qs, ts)
        check_bits("B9 pass rerun", group(mats, qs, ts), got)
        check_bits("B9 one leaf vs group", torch.cat(ones), got)
    out = []
    for a, q, tile in zip(mats, qs, ones):
        m = a.t() if t else a
        rows, inner = m.shape
        want = fp_ops.matmul_pack_plain(a, q, transpose=t)
        tol = 2 * inner * u / (1 - inner * u) * (m.abs() @ q.abs())
        err = (tile[:rows] - want[:rows]).abs()
        pad = tile[rows:]
        if not bool(torch.isfinite(tile).all()) or \
                bool((err > tol).any()) or bool(pad.any()) or \
                bool(torch.signbit(pad).any()):
            raise AssertionError(
                f"B9 {tuple(a.shape)} transpose={t}: max |diff| "
                f"{float(err.max()):.3e}, max diff/bound "
                f"{float((err / tol).max()):.3f}, pad "
                f"{pad.abs().max() if pad.numel() else 0}")
        out.append((float(err.max()), float((err / tol).max())))
    return out


def factor_pack_phase():
    """B9 over VGG-16's 16 compressible weights, both passes of a PowerSGD
    step at rank 2 (P = Aᵀ q, then Q' = A p) as the main path makes them,
    one grouped launch each, checked by ``factor_pass_check``.  Times each
    grouped pass beside the sum of its 16 one-leaf launches, the plain
    group, the sum of ``torch.matmul`` over its products, and its bound
    (each product reads A and its factor once and writes its tile)."""
    mats, factors = factor_inputs()
    r = POWERSGD_RANK
    passes, products = [], []
    for t in (True, False):
        qs, ts = factors[t], [t] * len(mats)
        checks = factor_pass_check(mats, qs, t)
        rows = []
        for a, q, (err, over) in zip(mats, qs, checks):
            m = a.t() if t else a
            rows_pad = fp_ops.pad_rows(m.shape[0])
            rows.append({
                "shape": list(a.shape), "transpose": t, "rows_pad": rows_pad,
                "max_abs_err": err, "err_over_bound": over,
                "ms": time_ms(lambda: fp_ops.matmul_pack_cuda(
                    a, q, transpose=t)),
                "library_ms": time_ms(lambda: m @ q),
                **bound(4 * (a.numel() + q.numel() + rows_pad * r),
                        2 * r * a.numel())})
        products += rows
        tot = lambda k: sum(p[k] for p in rows)
        passes.append({
            "transpose": t,
            "ctas": len(fp_ops.tile_table(tuple(
                (a.shape[0], a.shape[1], p["rows_pad"], t)
                for a, p in zip(mats, rows)))),
            "ms": time_ms(lambda: fp_ops.matmul_pack_group_cuda(mats, qs, ts)),
            "plain_ms": time_ms(lambda: fp_ops.matmul_pack_group_plain(
                mats, qs, ts)),
            "per_leaf_ms": tot("ms"), "library_ms": tot("library_ms"),
            "bound_ms": tot("bound_ms"), "bytes_ms": tot("bytes_ms"),
            "ops_ms": tot("ops_ms")})
    step = {k: sum(p[k] for p in passes)
            for k in ("ms", "per_leaf_ms", "plain_ms", "library_ms",
                      "bound_ms", "bytes_ms", "ops_ms")}
    step["bound_by"] = "bytes" if step["bytes_ms"] >= step["ops_ms"] \
        else "operations"
    del mats, factors
    torch.cuda.empty_cache()
    return {"rank": r, "per_step": step, "passes": passes,
            "products": products,
            "max_abs_err": max(p["max_abs_err"] for p in products),
            "max_err_over_bound": max(p["err_over_bound"] for p in products)}


def alexnet_reference_phase():
    """Full-width AlexNet, float32, batch 2: logits through the kernels on
    the card against the same weights through the plain versions on the
    CPU.  rtol 1e-4 / atol 1e-4·max|logit|: cuDNN's float32 algorithms and
    oneDNN's round and sum differently across eight layers."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    cfg = {"batch_size": 2, "n_class": 10, "compute_dtype": "float32",
           "synthetic_batches": 1, "synthetic_val_batches": 1}
    gpu = AlexNet(dict(cfg, device="cuda"))
    cpu = AlexNet(dict(cfg, device="cpu"))
    cpu.load_params(gpu.host_params())
    x = torch.from_numpy(
        (np.random.RandomState(0).randn(2, 227, 227, 3) * 50).astype(
            np.float32))
    with torch.no_grad():
        want = cpu.apply_model(cpu.params, x, train=False, gen=None,
                               state=cpu.bn_state)
        got = gpu.apply_model(gpu.params, x.cuda(), train=False, gen=None,
                              state=gpu.bn_state).cpu()
    if got.shape != (2, 10):
        raise AssertionError(f"AlexNet logits shape {tuple(got.shape)}")
    return check_close("AlexNet f32 logits, card vs CPU", got, want, 1e-4,
                       1e-4)


def zero_dropout(layers) -> None:
    """Every dropout rate in a layer tree to 0: the card's and the CPU's
    dropout bits differ."""
    for layer in layers:
        zero_dropout(getattr(layer, "layers", ()))
        if type(layer).__name__ == "Dropout":
            layer.rate = 0.0


def cpu_twin(cls, cfg, gpu):
    """A CPU model of ``cls`` holding ``gpu``'s params and BN state."""
    cpu = cls(dict(cfg, device="cpu"))
    cpu.load_params(gpu.host_params())
    cpu.load_bn_state(gpu.host_bn_state())
    return cpu


REF_CFG = {"batch_size": 2, "compute_dtype": "float32",
           "synthetic_batches": 1, "synthetic_val_batches": 1,
           "verbose": False}


def ref_batch(seed: int, n_class: int = 1000):
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(2, 224, 224, 3) * 50).astype(np.float32))
    y = torch.from_numpy(r.randint(0, n_class, 2).astype(np.int32))
    return x, y


def check_cost(name, got, want, rtol=1e-4) -> float:
    got, want = float(got), float(want)
    if not np.isfinite(got) or abs(got - want) > rtol * abs(want):
        raise AssertionError(f"{name}: card {got}, CPU {want} (rtol {rtol})")
    return abs(got - want)


def googlenet_reference_phase() -> dict:
    """Full-width GoogLeNet, float32, batch 2, crop 224, dropout off: the
    eval logits on the card (LRN through B1/B2) against the same weights
    on the CPU (the plain version), rtol 1e-4 / atol 1e-4·max|logit| as
    AlexNet's; and the training cost with both aux heads (0.3 each), rtol
    1e-4, which must exceed the eval cost (the aux terms are in it)."""
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    gpu = GoogLeNet(dict(REF_CFG, device="cuda"))
    cpu = cpu_twin(GoogLeNet, REF_CFG, gpu)
    for m in (gpu, cpu):
        zero_dropout(m.layers().values())
    x, y = ref_batch(0)
    out = {}
    with torch.no_grad():
        want = cpu.apply_model(cpu.params, x, train=False, gen=None,
                               state=cpu.bn_state)
        got = gpu.apply_model(gpu.params, x.cuda(), train=False, gen=None,
                              state=gpu.bn_state).cpu()
        costs = {}
        for train in (True, False):
            costs[train] = [m.loss_and_metrics(
                m.params, m.bn_state, {"x": x.to(m.device), "y": y.to(
                    m.device)}, None, train)[0] for m in (gpu, cpu)]
    if got.shape != (2, 1000):
        raise AssertionError(f"GoogLeNet logits shape {tuple(got.shape)}")
    out["logits_max_abs_err"] = check_close(
        "GoogLeNet f32 logits, card vs CPU", got, want, 1e-4, 1e-4)
    for train, (cg, cc) in costs.items():
        out[f"cost_{'train' if train else 'eval'}"] = {
            "card": float(cg), "cpu": float(cc),
            "abs_err": check_cost(f"GoogLeNet cost train={train}", cg, cc)}
    if not costs[True][1] > costs[False][1]:
        raise AssertionError(f"GoogLeNet training cost {costs[True][1]} "
                             f"holds no aux terms over {costs[False][1]}")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seeded_bn_state(tree, gen: torch.Generator):
    """Running stats drawn from ``gen``: mean 0.1·N(0, 1), var U(0.5, 2)."""
    if set(tree) == {"mean", "var"}:
        n = tree["mean"].shape
        return {"mean": 0.1 * torch.randn(n, generator=gen),
                "var": 0.5 + 1.5 * torch.rand(n, generator=gen)}
    return {k: seeded_bn_state(v, gen) for k, v in tree.items()}


def resnet_reference_phase() -> dict:
    """Full-width ResNet-50, float32, batch 2, crop 224: the eval logits
    from running stats drawn from a seed, card against CPU (rtol 1e-4 /
    atol 1e-4·max|logit|); then one training forward on both: its cost
    (rtol 1e-4) and all 53 BatchNorms' updated running state, each leaf
    rtol 1e-4 / atol 1e-4·max|leaf| (the CPU tests' bound against JAX)."""
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.utils.helper_funcs import leaf_paths
    gpu = ResNet50(dict(REF_CFG, device="cuda"))
    gpu.load_bn_state(seeded_bn_state(gpu.host_bn_state(),
                                      torch.Generator().manual_seed(5)))
    cpu = cpu_twin(ResNet50, REF_CFG, gpu)
    x, y = ref_batch(1)
    out = {}
    with torch.no_grad():
        want = cpu.apply_model(cpu.params, x, train=False, gen=None,
                               state=cpu.bn_state)
        got = gpu.apply_model(gpu.params, x.cuda(), train=False, gen=None,
                              state=gpu.bn_state).cpu()
        out["logits_max_abs_err"] = check_close(
            "ResNet-50 f32 eval logits, card vs CPU", got, want, 1e-4, 1e-4)
        before = tree_leaves(cpu.host_bn_state())
        cg, cc = (m.loss_and_metrics(m.params, m.bn_state,
                                     {"x": x.to(m.device),
                                      "y": y.to(m.device)}, None, True)[0]
                  for m in (gpu, cpu))
    out["cost_train"] = {"card": float(cg), "cpu": float(cc),
                         "abs_err": check_cost("ResNet-50 training cost",
                                               cg, cc)}
    errs = []
    gs, cs = gpu.host_bn_state(), cpu.host_bn_state()
    for path, b, g, c in zip(leaf_paths(cs), before, tree_leaves(gs),
                             tree_leaves(cs)):
        if np.array_equal(b, c):
            raise AssertionError(f"ResNet-50 BN {path} did not move")
        errs.append(check_close(f"ResNet-50 BN {'/'.join(path)}, card vs "
                                f"CPU", torch.from_numpy(g),
                                torch.from_numpy(c), 1e-4, 1e-4))
    out["bn_state_max_abs_err"] = max(errs)
    out["bn_leaves"] = len(errs)
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flash_bytes_flops(b, h, t, d, elem: int = 2, causal: bool = True,
                      sfx: str = ""):
    """Per kernel (B10, B11, B12; wrapper names ending ``sfx``): the bytes
    it must move (each input read once, each output written once:
    [B, H, T, hd] tensors of ``elem`` bytes, f32 [B, H, T] row stats) and
    the flops of its products over the pairs of each head (t(t+1)/2
    causal, t² not; 2·hd per pair and product: B10 q kᵀ and p v; B11 q kᵀ,
    dO vᵀ, pᵀ dO and dSᵀ q; B12 q kᵀ, dO vᵀ and dS k)."""
    x, stat = elem * b * h * t * d, 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    pair_flops = 2 * d * b * h * pairs
    return {f"flash_fwd{sfx}_cuda": (4 * x + stat, 2 * pair_flops),
            f"flash_bwd_dkv{sfx}_cuda": (6 * x + 2 * stat, 4 * pair_flops),
            f"flash_bwd_dq{sfx}_cuda": (5 * x + 2 * stat, 3 * pair_flops)}


def sass_of(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built library (raises without the tool)."""
    tool = os.path.join(os.path.dirname(_kernel_build.nvcc_path()),
                        "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        raise AssertionError("cuobjdump not found: the SASS check cannot run")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def flash_sass_check(lib_path: str, kernels=("flash_fwd_kernel",
                                              "flash_bwd_dkv_kernel",
                                              "flash_bwd_dq_kernel")) -> dict:
    """``cuobjdump -sass`` of a built flash library: every instantiation
    (head dims 32, 64, 128) of each of ``kernels`` must hold the
    instructions FLASH_SASS names for it, wgmma (``HGMMA``) and TMA load
    (``UTMALDG``).  Raises if the tool is missing or an instruction is
    absent; returns the counts per kernel."""
    sass = sass_of(lib_path)
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for ins in ("HGMMA", "UTMALDG", "UTMASTG"):
                if ins in line:
                    counts[fn][ins] = counts[fn].get(ins, 0) + 1
    out = {}
    for kern in kernels:
        need = FLASH_SASS[kern]
        found = [c for f, c in counts.items() if kern in f]
        if len(found) != len(fa_ops.HEAD_DIMS) or \
                not all(c.get(ins) for c in found for ins in need):
            raise AssertionError(f"{kern}: {len(found)} instantiations, "
                                 f"SASS counts {found}; each needs {need}")
        out[kern] = {ins: [c.get(ins, 0) for c in found]
                     for ins in ("HGMMA", "UTMALDG", "UTMASTG")}
    return out


def lrn_sass_check(lib_path: str) -> dict:
    """``cuobjdump -sass`` of the built LRN library: each of B2's 20
    builds (2 types × VEC of 16 bytes or 1 × n//2 = 0..4) is found, and
    the 10 vector builds (``ASYNC`` true) hold the bulk copy ``UBLKCP``.
    Raises otherwise; returns the instruction's counts by build."""
    pat = re.compile(r"lrn_bwd_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)"
                     r"ELb([01])E")
    builds, cur = {}, None
    for line in sass_of(lib_path).splitlines():
        if "Function :" in line:
            m = pat.search(line)
            cur = m.groups() if m else None
            if cur is not None:
                builds[cur] = 0
        elif cur is not None and LRN_SASS in line:
            builds[cur] += 1
    vec = {k: n for k, n in builds.items() if k[3] == "1"}
    if len(builds) != 20 or len(vec) != 10 or not all(vec.values()) or \
            any(k[1] == "1" for k in vec):
        raise AssertionError(f"lrn_bwd_kernel: {len(builds)} builds, "
                             f"{LRN_SASS} counts {builds}; each of the 10 "
                             f"vector builds needs it")
    return {("bf16" if t.startswith("13") else "f32")
            + f" VEC {v} half {h}" + (" async" if a == "1" else ""): n
            for (t, v, h, a), n in sorted(builds.items())}


def host_us(fn, calls: int = 200, reps: int = 9) -> float:
    """Host µs of one call of ``fn`` (a kernel wrapper: checks, tensor
    maps, launch): ``calls`` calls in a row without a synchronize, the card
    running behind; the least of ``reps`` runs (the host's cores are shared,
    and other work only ever adds time)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(min(times))


def flash_inputs(b: int = LM_BATCH, h: int = LM_CFG["n_head"]):
    """q, k, v and dO at the LM's main-path shape (at batch ``b``, and
    ``h`` heads: a tp rank's), bf16, laid out as the model hands them
    (transposed views of [B, T, H, hd])."""
    t = LM_CFG["seq_len"]
    d = LM_CFG["d_model"] // LM_CFG["n_head"]
    g = torch.Generator(device="cuda").manual_seed(4)

    def mk():
        return torch.randn(b, t, h, d, generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    return mk(), mk(), mk(), mk()


def flash_calls(q, k, v, do, lse, di) -> dict:
    return {"flash_fwd_cuda": lambda: fa_ops.flash_fwd_cuda(q, k, v),
            "flash_bwd_dkv_cuda": lambda: fa_ops.flash_bwd_dkv_cuda(
                q, k, v, do, lse, di),
            "flash_bwd_dq_cuda": lambda: fa_ops.flash_bwd_dq_cuda(
                q, k, v, do, lse, di)}


def times_main(flags) -> int:
    """``python3 chip_smoke.py --flash-times``, ``--topk-times`` and/or
    ``--factor-times``: the flash kernels' device ms and host µs per
    wrapper call at the flash phase's shape; B7's device ms at the topk
    phase's on three kinds of rows, each first checked bit for bit against
    the plain version; B9's device ms for each PowerSGD pass over VGG-16's
    16 leaves as the tree's main path makes it (one grouped launch, or on
    a tree from before the grouped kernel, 16 one-leaf launches), beside
    the sum of the one-leaf launches, after ``factor_pass_check``; with
    ``--update-times`` GoogLeNet's and ResNet-50's captured BSP profiles
    (wall, device busy, idle share, ops a step, the update's multi-tensor
    passes), for a tree's update layer beside another's; with
    ``--lrn-times`` B2's and B1's device ms at the four LRN shapes
    (``lrn_times``); with ``--flash-f32-times`` the float32 B10–B12 and
    float32 SDPA's forward at the LM's shape, B10 checked first; with
    ``--decode-times`` B4 at a bucket and at VGG-16's length
    (``decode_times``); nothing else (for setting two trees side by side
    in one call)."""
    card = card_line()
    out = {"card": card}
    if "--update-times" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["lrn"])
        out["update_times"] = {}
        for cls in ("GoogLeNet", "ResNet50"):
            p = step_profile_phase(
                "theanompi_tpu_torch.models." + cls.lower(), cls, ZOO_BATCH,
                {"update": ("multi_tensor_apply_kernel",)}, PROFILE_STEPS,
                learning_rate=ZOO_LR[cls])
            out["update_times"][cls] = {k: p[k] for k in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "kernel_calls_per_step",
                "update_ms_per_step", "host_ms_per_step")}
    if "--input-times" in flags:
        out["input_times"] = input_times()
    if "--islands" in flags:
        _kernel_build.build(["lrn"])
        out["islands"] = islands_main(card)
    if "--vgg-island-lr" in flags:
        out["vgg_island_lr"] = vgg_island_lr()
    if "--launcher" in flags:
        _kernel_build.build(["lrn"])
        out["launcher"] = launcher_main(card)
    if "--elastic" in flags:
        _kernel_build.build(["lrn"])
        out["elastic"] = elastic_main(card)
    if "--tools" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["lrn", "compress"])
        busy = step_profile_phase(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", BATCH,
            {"lrn": ("lrn_",)}, PROFILE_STEPS)
        out["tools"] = tools_main(card, busy)
    if "--wire" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["lrn", "compress", "factor_pack"])
        out["wire"] = wire_main(card)
    if "--ops" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["lrn", "compress"])
        out["ops"] = ops_main(card)
    if "--shard" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["lrn"])
        out["shard"] = shard_main(card)
    if "--gan-lm" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["flash_attention"])
        out["gan_lm"] = gan_lm_main(card)
    if "--flash-f32" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["flash_attention_f32"])
        out["flash_f32"] = flash_f32_main(card)
    if "--pp-stage" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["flash_attention", "flash_attention_f32"])
        f32 = flash_f32_phase([s for s in F32_FLASH_SHAPES
                               if s[0] == "pp_stage"])
        out["pp_stage"] = pp_stage_main(
            card, flash_phase(batch=LM_BATCH // PP_STAGE["microbatches"]),
            f32["shapes"]["pp_stage"]["times"])
    if "--ep-rank" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _kernel_build.build(["flash_attention", "flash_attention_f32"])
        f32 = flash_f32_phase([s for s in F32_FLASH_SHAPES
                               if s[0] == "tp_rank"])
        out["ep_rank"] = ep_rank_main(
            card, flash_phase(heads=LM_CFG["n_head"] // TP_RANK["tp"]),
            f32["shapes"]["tp_rank"]["times"])
    if "--lrn-times" in flags:
        out["lrn_times"] = lrn_times()
    if "--flash-times" in flags:
        _kernel_build.build(["flash_attention"])
        q, k, v, do = flash_inputs()
        o, lse = fa_ops.flash_fwd_cuda(q, k, v)
        di = fa_ops.attention_di(o, do)
        out["flash_times"] = {
            name: {"ms": time_ms(fn), "host_us": host_us(fn)}
            for name, fn in flash_calls(q, k, v, do, lse, di).items()}
        del q, k, v, do, o, lse, di
    if "--flash-f32-times" in flags:
        torch.backends.cuda.matmul.allow_tf32 = False
        _kernel_build.build(["flash_attention_f32"])
        _, shape, causal, strided = F32_FLASH_SHAPES[0]
        q, k, v, do = f32_flash_inputs(shape, strided, 10)
        o, lse, di, *_ = f32_flash_run(q, k, v, do, causal)
        po, plse = fa_ops.flash_fwd_plain(q, k, v, causal)
        check_close("B10 f32 o", o, po, *F32_FLASH_TOL)
        check_close("B10 f32 lse", lse, plse, *F32_FLASH_TOL)
        calls = {"flash_fwd_f32_cuda": lambda: fa_ops.flash_fwd_f32_cuda(
                     q, k, v),
                 "flash_bwd_dkv_f32_cuda": lambda:
                     fa_ops.flash_bwd_dkv_f32_cuda(q, k, v, do, lse, di),
                 "flash_bwd_dq_f32_cuda": lambda:
                     fa_ops.flash_bwd_dq_f32_cuda(q, k, v, do, lse, di),
                 "sdpa_f32_forward": lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True)}
        out["flash_f32_times"] = {"shape": list(shape), **{
            name: time_ms(fn) for name, fn in calls.items()}}
        del q, k, v, do, o, lse, di, po, plse
    if "--decode-times" in flags:
        _kernel_build.build(["compress"])
        out["decode_times"] = decode_times()
    if "--topk-times" in flags:
        _kernel_build.build(["compress"])
        c2 = topk_inputs(vgg16_sizes()[0])
        # beside the topk phase's rows, two that crowd the select's
        # histogram: all zero (one bin), and |c| sharing their top 16 bits
        top16 = torch.randint(0x3f800000, 0x3f810000, c2.shape,
                              generator=torch.Generator(
                                  device="cuda").manual_seed(3),
                              device="cuda", dtype=torch.int32)
        by_rows = {}
        for kind, x in (("planted", c2), ("zero", torch.zeros_like(c2)),
                        ("top16", top16.view(torch.float32))):
            kv, ki, ks = cmp_ops.topk_encode_cuda(x, TOPK_K)
            pv, pi, ps = cmp_ops.topk_encode_plain(x, TOPK_K)
            check_bits(f"B7 {kind} values", kv.view(torch.int16),
                       pv.view(torch.int16))
            check_bits(f"B7 {kind} offsets", ki, pi)
            check_bits(f"B7 {kind} state", ks, ps)
            del kv, ki, ks, pv, pi, ps
            by_rows[kind] = time_ms(lambda: cmp_ops.topk_encode_cuda(
                x, TOPK_K))
        out["topk_times"] = {"topk_encode_cuda": {
            "ms": by_rows.pop("planted"), "by_rows": by_rows}}
    if "--factor-times" in flags:
        _kernel_build.build(["factor_pack"])
        mats, factors = factor_inputs()
        group = getattr(fp_ops, "matmul_pack_group_cuda", None)
        passes = []
        for t in (True, False):
            qs = factors[t]
            factor_pass_check(mats, qs, t)
            ones = lambda: [fp_ops.matmul_pack_cuda(a, q, transpose=t)
                            for a, q in zip(mats, qs)]
            per_leaf = [time_ms(lambda: fp_ops.matmul_pack_cuda(
                a, q, transpose=t)) for a, q in zip(mats, qs)]
            passes.append({
                "transpose": t, "grouped": group is not None,
                "ms": time_ms((lambda: group(mats, qs, [t] * len(mats)))
                              if group else ones),
                "per_leaf_ms": sum(per_leaf), "per_leaf": per_leaf})
        out["factor_times"] = {"step_ms": sum(p["ms"] for p in passes),
                               "passes": passes}
        del mats, factors
    print(json.dumps(out))
    return 0


def decode_times() -> dict:
    """B4's device ms at a 4 MiB bucket ([W, 256, 128] words into a slice
    of a longer mean) and at VGG-16's whole padded length, W = 1 and 4,
    each first checked against the plain version (bit for bit at W = 1,
    within ``decode_tol`` at 4)."""
    m = vgg16_sizes()[1] // (32 * cmp_ops.LANES)
    rows_b4 = WIRE_BUCKET // 4 // (32 * cmp_ops.LANES)
    g = torch.Generator(device="cuda").manual_seed(6)
    mean = torch.empty(m * 32 * cmp_ops.LANES, device="cuda")
    res = {}
    for w, rows in ((1, rows_b4), (4, rows_b4), (1, m), (4, m)):
        words = torch.randint(-2 ** 31, 2 ** 31, (w, rows, cmp_ops.LANES),
                              generator=g, device="cuda", dtype=torch.int32)
        sc = torch.rand(w, generator=g, device="cuda") + 0.1
        n = rows * 32 * cmp_ops.LANES
        got = cmp_ops.unpack_signs_wsum_cuda(words, sc, out=mean[:n])
        want = cmp_ops.unpack_signs_weighted_sum_plain(words, sc)
        if w == 1:
            check_bits(f"B4 [{w}, {rows}, 128]", got, want)
        else:
            rtol, atol = cmp_ops.decode_tol(w, sc)
            check_close(f"B4 [{w}, {rows}, 128]", got, want, rtol,
                        atol / float(want.abs().max()))
        del got, want
        res[f"w{w}_rows{rows}"] = time_ms(
            lambda: cmp_ops.unpack_signs_wsum_cuda(words, sc, out=mean[:n]))
        del words
    del mean
    torch.cuda.empty_cache()
    return res


def flash_bwd_run(q, k, v, do):
    o, lse = fa_ops.flash_fwd_cuda(q, k, v)
    di = fa_ops.attention_di(o, do)
    dk, dv = fa_ops.flash_bwd_dkv_cuda(q, k, v, do, lse, di)
    return o, lse, di, fa_ops.flash_bwd_dq_cuda(q, k, v, do, lse, di), dk, dv


def flash_phase(lib_path=None, batch: int = LM_BATCH,
                heads: int = LM_CFG["n_head"]):
    """B10–B12 at the LM's main-path shape (or at ``batch``, a pp stage's
    microbatch of it, or at ``heads``, a tp rank's), bf16, causal, on q,
    k, v and dO laid out as the model hands them (transposed views of
    [B, T, H, hd]): given the library, the SASS check of B10 and B11; each
    kernel against its plain version within FLASH_TOL, a rerun bit for
    bit; times, host µs per wrapper call, bounds, and the library
    yardsticks."""
    sass = flash_sass_check(lib_path) if lib_path else None
    q, k, v, do = flash_inputs(batch, heads)
    b, h, t, d = q.shape
    zero_launches()
    o, lse, di, dq, dk, dv = flash_bwd_run(q, k, v, do)
    torch.cuda.synchronize()
    checked = launch_counts()
    for n, a, a2 in zip(("o", "lse", "di", "dq", "dk", "dv"),
                        (o, lse, di, dq, dk, dv), flash_bwd_run(q, k, v, do)):
        # bf16 → float32 is exact, so float32 bits compare bf16's
        check_bits(f"B10–B12 {[b, h, t, d]} rerun {n}", a.float(), a2.float())
    po, plse = fa_ops.flash_fwd_plain(q, k, v)
    pdq, pdk, pdv = fa_ops.flash_bwd_plain(q, k, v, o, lse, do)
    err = {"flash_fwd_cuda": check_close("B10 o", o, po, *FLASH_TOL),
           "flash_bwd_dkv_cuda": max(check_close("B11 dk", dk, pdk, *FLASH_TOL),
                                     check_close("B11 dv", dv, pdv,
                                                 *FLASH_TOL)),
           "flash_bwd_dq_cuda": check_close("B12 dq", dq, pdq, *FLASH_TOL)}
    # lse: f32 on both sides, the row max and sum taken in another order
    lse_err = check_close("B10 lse", lse, plse, 1e-5, 1e-6)
    if o.stride() != q.stride():
        raise AssertionError(f"B10 o strides {o.stride()}, q {q.stride()}")
    del po, plse, pdq, pdk, pdv

    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                   retain_graph=True)

    def plain_bwd():
        return fa_ops.flash_bwd_plain(q, k, v, o, lse, do)

    bwd_plain_ms = time_ms(plain_bwd, reps=5, inner=2, warmup=1)
    lib_bwd_ms = time_ms(lib_bwd)
    sizes = flash_bytes_flops(b, h, t, d)
    plain_lib = {
        "flash_fwd_cuda": (time_ms(lambda: fa_ops.flash_fwd_plain(q, k, v),
                                   reps=5, inner=2, warmup=1),
                           time_ms(lib_fwd)),
        "flash_bwd_dkv_cuda": (bwd_plain_ms, lib_bwd_ms),
        "flash_bwd_dq_cuda": (bwd_plain_ms, lib_bwd_ms),
    }
    out = {"shape": [b, h, t, d], "checked_launches": checked,
           "lse_max_abs_err": lse_err, "sass": sass,
           "di_ms": time_ms(lambda: fa_ops.attention_di(o, do))}
    for name, kern in flash_calls(q, k, v, do, lse, di).items():
        plain_ms, lib_ms = plain_lib[name]
        out[name] = {"max_abs_err": err[name], "ms": time_ms(kern),
                     "host_us": host_us(kern), "plain_ms": plain_ms,
                     "library_ms": lib_ms,
                     **bound(*sizes[name], BF16_FLOPS_PER_S)}
    del q, k, v, do, o, lse, di, dk, dv, dq, ql, kl, vl, lib_out
    torch.cuda.empty_cache()
    return out


def lm_check_phase():
    """The LM at full width, batch 2, on the card: the loss and every
    gradient leaf of ``attn_impl='flash'`` (kernels B10–B12, bf16) and of
    ``'reference'`` (torch attention, bf16), from the same parameters and
    batch, each against the same model in float32 (reference attention,
    TF32 off).  Flash must be within LM_LOSS_RTOL of the float32 loss and,
    leaf by leaf, no further from the float32 gradient than LM_GRAD_RATIO
    times the bf16 reference's own distance."""
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    cfg = dict(LM_CFG, batch_size=LM_CHECK_BATCH, synthetic_train=2,
               synthetic_val=2, seed=0, verbose=False, device="cuda")
    models = {"flash": TransformerLM(cfg),
              "reference": TransformerLM(dict(cfg, attn_impl="reference")),
              "float32": TransformerLM(dict(cfg, attn_impl="reference",
                                            compute_dtype="float32"))}
    src = tree_leaves(models["flash"].params)
    with torch.no_grad():
        for m in models.values():
            for a, c in zip(tree_leaves(m.params), src):
                a.copy_(c)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             models["flash"].data.next_train_batch(1).items()}
    res = {}
    for name, m in models.items():
        cost, _ = m.loss_and_metrics(m.params, m.bn_state, batch, None, True)
        grads = torch.autograd.grad(cost, tree_leaves(m.params))
        res[name] = (float(cost.detach()), [g.float() for g in grads])
    del models, src
    c32, g32 = res["float32"]

    def rel(gs):
        return [float((a - c).norm() / c.norm().clamp_min(1e-30))
                for a, c in zip(gs, g32)]

    (cf, gf), (cr, gr) = res["flash"], res["reference"]
    rf, rr = rel(gf), rel(gr)
    ratio = max(a / max(b, 1e-12) for a, b in zip(rf, rr))
    del res, gf, gr, g32
    gc.collect()
    torch.cuda.empty_cache()
    out = {"loss_flash": cf, "loss_reference": cr, "loss_float32": c32,
           "loss_rel_err": abs(cf - c32) / abs(c32),
           "loss_rel_err_reference": abs(cr - c32) / abs(c32),
           "grad_rel_l2_max": max(rf),
           "grad_rel_l2_median": float(np.median(rf)),
           "grad_rel_l2_max_reference": max(rr), "grad_ratio_max": ratio}
    if not np.isfinite(cf) or out["loss_rel_err"] > LM_LOSS_RTOL or \
            ratio > LM_GRAD_RATIO:
        raise AssertionError(f"LM flash vs float32: {out}")
    return out


def f32_flash_inputs(shape, strided: bool, seed: int):
    """float32 q, k, v and dO of ``shape``: contiguous, or as the model
    hands them (transposed views of [B, T, H, hd])."""
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk():
        if strided:
            return torch.randn(b, t, h, d, generator=g,
                               device="cuda").transpose(1, 2)
        return torch.randn(shape, generator=g, device="cuda")

    return mk(), mk(), mk(), mk()


def f32_flash_run(q, k, v, do, causal):
    o, lse = fa_ops.flash_fwd_f32_cuda(q, k, v, causal)
    di = fa_ops.attention_di(o, do)
    dk, dv = fa_ops.flash_bwd_dkv_f32_cuda(q, k, v, do, lse, di, causal)
    dq = fa_ops.flash_bwd_dq_f32_cuda(q, k, v, do, lse, di, causal)
    return o, lse, di, dq, dk, dv


def flash_f32_phase(shapes=F32_FLASH_SHAPES):
    """The float32 B10–B12 (A11) at each of ``shapes``: every output
    (o, lse, dq, dk, dv) against the float32 plain versions within
    F32_FLASH_TOL (TF32 off), a rerun bit for bit; the SASS check of
    B10–B12; at the F32_TIMED shapes (the LM's at the top level, a pp
    stage's under its tag's ``times``) each kernel's device ms, host µs a
    wrapper call, bound (float32 flops in split TF32 at
    SPLIT_TF32_FLOPS_PER_S, f32 bytes; the FFMA bound at F32_FLOPS_PER_S
    beside it), plain ms and SDPA in float32 (forward; its autograd
    backward, dQ, dK and dV in one, beside B11 + B12)."""
    names = ("flash_fwd_f32_cuda", "flash_bwd_dkv_f32_cuda",
             "flash_bwd_dq_f32_cuda")
    out = {"shapes": {}, "sass": flash_sass_check(
        _kernel_build.library_path("flash_attention_f32"),
        ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel",
         "flash_bwd_dq_f32_kernel"))}
    for tag, shape, causal, strided in shapes:
        i = [s[0] for s in F32_FLASH_SHAPES].index(tag)
        q, k, v, do = f32_flash_inputs(shape, strided, 10 + i)
        zero_launches()
        o, lse, di, dq, dk, dv = f32_flash_run(q, k, v, do, causal)
        torch.cuda.synchronize()
        checked = {n: c for n, c in launch_counts().items() if c}
        again = f32_flash_run(q, k, v, do, causal)
        for n, a, b in zip(("o", "lse", "di", "dq", "dk", "dv"),
                           (o, lse, di, dq, dk, dv), again):
            check_bits(f"f32 {tag} rerun {n}", a, b)
        del again
        po, plse = fa_ops.flash_fwd_plain(q, k, v, causal)
        pdq, pdk, pdv = fa_ops.flash_bwd_plain(q, k, v, o, lse, do, causal)
        err = {"flash_fwd_f32_cuda": max(
                   check_close(f"B10 f32 {tag} o", o, po, *F32_FLASH_TOL),
                   check_close(f"B10 f32 {tag} lse", lse, plse,
                               *F32_FLASH_TOL)),
               "flash_bwd_dkv_f32_cuda": max(
                   check_close(f"B11 f32 {tag} dk", dk, pdk, *F32_FLASH_TOL),
                   check_close(f"B11 f32 {tag} dv", dv, pdv,
                               *F32_FLASH_TOL)),
               "flash_bwd_dq_f32_cuda": check_close(
                   f"B12 f32 {tag} dq", dq, pdq, *F32_FLASH_TOL)}
        if strided and o.stride() != q.stride():
            raise AssertionError(f"B10 f32 o strides {o.stride()}, q "
                                 f"{q.stride()}")
        del po, plse, pdq, pdk, pdv
        out["shapes"][tag] = {"shape": list(shape), "causal": causal,
                              "strided": strided, "max_abs_err": err,
                              "checked_launches": checked}
        if tag not in F32_TIMED:
            del q, k, v, do, o, lse, di, dq, dk, dv
            continue
        b, h, t, d = shape
        ql, kl, vl = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do, retain_graph=True))
        bwd_plain_ms = time_ms(lambda: fa_ops.flash_bwd_plain(
            q, k, v, o, lse, do), reps=5, inner=2, warmup=1)
        plain_lib = {
            "flash_fwd_f32_cuda": (
                time_ms(lambda: fa_ops.flash_fwd_plain(q, k, v), reps=5,
                        inner=2, warmup=1),
                time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True))),
            "flash_bwd_dkv_f32_cuda": (bwd_plain_ms, lib_bwd_ms),
            "flash_bwd_dq_f32_cuda": (bwd_plain_ms, lib_bwd_ms)}
        calls = {"flash_fwd_f32_cuda": lambda: fa_ops.flash_fwd_f32_cuda(
                     q, k, v),
                 "flash_bwd_dkv_f32_cuda": lambda:
                     fa_ops.flash_bwd_dkv_f32_cuda(q, k, v, do, lse, di),
                 "flash_bwd_dq_f32_cuda": lambda:
                     fa_ops.flash_bwd_dq_f32_cuda(q, k, v, do, lse, di)}
        sizes = flash_bytes_flops(b, h, t, d, elem=4, sfx="_f32")
        timed = {name: {"max_abs_err": err[name],
                        "ms": time_ms(calls[name]),
                        "host_us": host_us(calls[name]),
                        "plain_ms": plain_lib[name][0],
                        "library_ms": plain_lib[name][1],
                        "ffma_bound_ms": bound(*sizes[name])["bound_ms"],
                        **bound(*sizes[name], SPLIT_TF32_FLOPS_PER_S)}
                 for name in names}
        if tag == "lm":
            out["shape"] = list(shape)
            out.update(timed)
        else:
            out["shapes"][tag]["times"] = timed
        del q, k, v, do, o, lse, di, dq, dk, dv, ql, kl, vl, lib_out
    for name in names:        # the worst error over every shape
        if name in out:
            out[name]["max_abs_err"] = max(r["max_abs_err"][name]
                                           for r in out["shapes"].values())
    torch.cuda.empty_cache()
    return out


def pp_stage_path_phase() -> dict:
    """One stage of the LM row at pp 2 on the card, through the port's
    pipeline: PP_STAGE's L/pp = 4 blocks at full width, their rows
    stacked as the pp tree holds them (``TransformerLM.stack_rows``), run
    by ``parallel.pipeline.pipeline_apply`` over one stage (group None:
    the M real ticks that each stage of a pp 2 world runs, each chunk
    recomputed in its backward) on the embedded b16 batch cut into M = 4
    microbatches, forward and backward, in bf16 and in float32.  Each
    run's launches are read and must be the schedule's (2·M·L/pp B10 with
    the recompute, M·L/pp each of B11 and B12, nothing else).  The output
    and the gradients of the input and of every stacked row are held
    against the same rows applied to the whole batch at once (the chunk
    function on [B, T, D], autograd's own backward): in bf16 each one's
    relative L2 distance to the float32 model's (reference attention,
    TF32 off) within LM_GRAD_RATIO times the dense bf16 one's, the LM
    check's bound.  In float32 the microbatches only reorder float32 sums
    (a row's gradient over 8192 tokens in four partial sums, matmuls over
    2048 rows against 8192), but at random init the stage amplifies that
    (a small-variance LayerNorm input, cancelling sums): each one's
    distance from the dense float32 one may be at most LM_F32_GRAD_RATIO
    times the floor measured in the same run, the same stage with the
    reference attention (no kernel) through the same pipeline against
    itself applied densely, as the float32 LM check holds its leaves.
    Device ms of the stage's forward and backward beside the dense run's."""
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    from theanompi_tpu_torch.parallel import pipeline as pl
    pp, m = PP_STAGE["pp"], PP_STAGE["microbatches"]
    n, t = LM_CFG["n_layer"] // pp, LM_CFG["seq_len"]
    cfg = dict(LM_CFG, n_layer=n, batch_size=LM_BATCH,
               synthetic_train=LM_BATCH, synthetic_val=LM_BATCH, seed=0,
               verbose=False, device="cuda")
    models = {"bf16": TransformerLM(cfg),
              "f32": TransformerLM(dict(cfg, compute_dtype="float32")),
              "ref32": TransformerLM(dict(cfg, attn_impl="reference",
                                          compute_dtype="float32"))}
    src = tree_leaves(models["bf16"].params)
    with torch.no_grad():
        for mdl in models.values():
            for a, c in zip(tree_leaves(mdl.params), src):
                a.copy_(c)
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randint(0, LM_CFG["vocab"], (LM_BATCH, t), generator=g,
                      device="cuda")
    # the stage output's gradient, bf16 values, the same on every side
    dy = torch.randn(LM_BATCH, t, LM_CFG["d_model"], generator=g,
                     device="cuda").bfloat16().float()

    def inputs(mdl):
        with torch.no_grad():
            rows = mdl.stack_rows(mdl.params, range(n))
            h = mdl._embed(mdl.params, x, mdl._pos_ids(t, x.device))
        return [r.requires_grad_(True) for r in rows], h.requires_grad_(True)

    def step(mdl, piped, rows, h):
        stage = mdl.stage_fn(True)
        if piped:
            y = pl.unmicrobatch(pl.pipeline_apply(stage, rows,
                                                  pl.microbatch(h, m)))
        else:
            y = stage(rows, h)
        torch.autograd.backward(y, dy.to(y.dtype))
        return y.detach()

    def run(mdl, piped):
        rows, h = inputs(mdl)
        y = step(mdl, piped, rows, h)
        return [y, h.grad] + [r.grad for r in rows]

    real = int(pl.build_schedule(pp, 1, m).real[:, 0].sum())
    per_step = {"fwd": 2 * real * n, "bwd_dkv": real * n, "bwd_dq": real * n}
    out = {"shape": [LM_BATCH // m, LM_CFG["n_head"], t,
                     LM_CFG["d_model"] // LM_CFG["n_head"]],
           "pp": pp, "microbatches": m, "blocks": n,
           "launches_from_schedule": per_step, "launches": {}}
    res = {}
    for key, sfx in (("bf16", ""), ("f32", "_f32")):
        zero_launches()
        res[key, "pp"] = run(models[key], True)
        torch.cuda.synchronize()
        got = {k: c for k, c in launch_counts().items() if c}
        want = {f"flash_{k}{sfx}_cuda": c for k, c in per_step.items()}
        if got != want:
            raise AssertionError(f"pp stage {key} launches {got}, the "
                                 f"schedule's {want}")
        out["launches"].update(got)
        res[key, "dense"] = run(models[key], False)
        rows, h = inputs(models[key])
        out[f"stage{sfx}_ms"] = time_ms(
            lambda: step(models[key], True, rows, h), reps=5, inner=2,
            warmup=1)
        out[f"dense{sfx}_ms"] = time_ms(
            lambda: step(models[key], False, rows, h), reps=5, inner=2,
            warmup=1)
        del rows, h
    res["ref32"] = run(models["ref32"], False)
    res["ref32", "pp"] = run(models["ref32"], True)
    names = ["output", "input grad"] + [
        "/".join(map(str, p)) for p in models["bf16"]._blk_paths]
    del models, src

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    r_pp = [rel(a, c) for a, c in zip(res["bf16", "pp"], res["ref32"])]
    r_dense = [rel(a, c) for a, c in zip(res["bf16", "dense"], res["ref32"])]
    ratios = [a / max(b, 1e-12) for a, b in zip(r_pp, r_dense)]
    worst = int(np.argmax(ratios))
    out["bf16"] = {"rel_l2_max": max(r_pp), "dense_rel_l2_max": max(r_dense),
                   "ratio_max": ratios[worst], "worst": names[worst]}
    finite = all(bool(torch.isfinite(a).all()) for a in res["bf16", "pp"])
    if not finite or ratios[worst] > LM_GRAD_RATIO:
        raise AssertionError(f"pp stage bf16 against float32: {out['bf16']}"
                             f", finite {finite}")
    r32 = [rel(a, b) for a, b in zip(res["f32", "pp"], res["f32", "dense"])]
    floor = [rel(a, b) for a, b in zip(res["ref32", "pp"], res["ref32"])]
    ratios = [a / max(b, 1e-30) for a, b in zip(r32, floor)]
    worst = int(np.argmax(ratios))
    out["f32"] = {"rel_l2_max": max(r32), "floor_rel_l2_max": max(floor),
                  "ratio_max": ratios[worst], "worst": names[worst],
                  "max_abs_err": max(float((a - b).abs().max()) for a, b in
                                     zip(res["f32", "pp"],
                                         res["f32", "dense"]))}
    finite = all(bool(torch.isfinite(a).all()) for a in res["f32", "pp"])
    if not finite or ratios[worst] > LM_F32_GRAD_RATIO:
        raise AssertionError(f"pp stage f32 against dense: {out['f32']}, "
                             f"finite {finite}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def stage_candidates(timed: dict) -> list:
    """The flash kernels that a later redesign would take at a shape
    (ROADMAP §B): under half of their bound, B10 behind SDPA's forward,
    B11 + B12 behind SDPA's autograd backward."""
    fwd, dkv, dq = timed
    out = [k for k, r in timed.items() if r["bound_ms"] < 0.5 * r["ms"]]
    if timed[fwd]["ms"] > timed[fwd]["library_ms"]:
        out.append(fwd)
    if timed[dkv]["ms"] + timed[dq]["ms"] > timed[dq]["library_ms"]:
        out.append("B11 + B12")
    return out


def pp_stage_main(card: str, bf16: dict, f32: dict) -> dict:
    """The pp stage phase group (``--pp-stage`` runs it alone): B10–B12 in
    bf16 (``bf16``, :func:`flash_phase` at the stage's microbatch) and in
    float32 (``f32``, the ``pp_stage`` shape of :func:`flash_f32_phase`),
    then one stage's step on the card (:func:`pp_stage_path_phase`)."""
    path = pp_stage_path_phase()
    shape = path["shape"]
    timed = {"bf16": {k: v for k, v in bf16.items()
                      if k.startswith("flash_")}, "f32": f32}
    for tag, ks in timed.items():
        print(f"pp stage flash {tag} {shape} causal, {card}: " + "; ".join(
            f"{k[:-5]} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_ms'] / r['ms']:.0%} of it, SDPA "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.3f}, max |diff| "
            f"{r['max_abs_err']:.3e})" for k, r in ks.items())
            + "; B11 + B12 %.4f ms; candidates %s" % (
                sum(r["ms"] for k, r in ks.items() if "_bwd_" in k),
                stage_candidates(ks)), flush=True)
    print(f"pp stage path: {path['blocks']} blocks, pp {path['pp']}, "
          f"{path['microbatches']} microbatches of {shape[0]}, "
          f"pipeline_apply forward + backward: launches {path['launches']} "
          f"(the schedule's {path['launches_from_schedule']} a dtype); bf16 "
          f"against float32 worst ratio {path['bf16']['ratio_max']:.3f} "
          f"({path['bf16']['worst']}); f32 against dense relative L2 max "
          f"{path['f32']['rel_l2_max']:.2e} (floor {path['f32']['floor_rel_l2_max']:.2e}), "
          f"worst ratio {path['f32']['ratio_max']:.3f} "
          f"({path['f32']['worst']}); stage step {path['stage_ms']:.3f}"
          f" ms (dense {path['dense_ms']:.3f}), f32 "
          f"{path['stage_f32_ms']:.3f} ms (dense {path['dense_f32_ms']:.3f}),"
          f" {card}", flush=True)
    return {"path": path, "bf16": timed["bf16"], "f32": f32,
            "candidates": stage_candidates(timed["bf16"]),
            "candidates_f32": stage_candidates(f32)}


def ep_rank_path_phase(cfg=None, batch: int = LM_BATCH,
                       device: str = "cuda") -> dict:
    """The MoE LM row's MoE block (``cfg``: MOE_CFG's d512, 8 heads, 4
    experts, top-1, capacity factor 1.25, T512) at ep = tp 2 on the card,
    each model rank's part built as that rank builds it (``MoEBlock``
    with the grid coordinate ``Grid(1, 2, 1, r)`` and the model group
    ``tp.LOCAL``, so the group's all-reduces pass their input through):
    rank r's heads 4r … 4r+3 through B10–B12 at [16, 4, 512, 64], its
    experts 2r, 2r+1 through the expert-parallel path (``parallel/moe.py``,
    the others' choices dropped), forward and backward on the b16 batch
    (8192 tokens, C = 2560), in bf16 and in float32.  The phase adds up
    what the model group's all-reduces add: the ranks' partial attention
    projections and their MoE outputs (disjoint token by token under
    top-1) in the forward; in the backward the ranks share the block's
    input and its replicated leaves (the LayerNorms, the router), so
    autograd sums their gradients there, as ``tp.copy_to_model``'s
    backward does; the aux (equal on both ranks, checked bit for bit) is
    back-propagated once, as each rank does.  The launches of the two
    rank parts are read (B10, B11 and B12 once a rank each, nothing
    else).

    Held against the dense block (tp 1, ep 1) on the same params and
    input: the output, the input's gradient, each replicated leaf's
    gradient and each rank's shard of every split leaf's (its heads' rows
    or columns, its experts), in relative L2.  bf16, the whole block:
    each one's distance to the float32 dense block with the reference
    attention within LM_GRAD_RATIO times the dense bf16 block's.  float32,
    the block at its two all-reduces, each half from the same input (the
    attention from the block's input, the MoE from the dense block's
    ``ln2`` output, so both sides route alike): each one's distance to
    the float64 half with the reference attention within
    LM_F32_GRAD_RATIO times the dense float32 half's.  The float32 whole
    block, whose run gives the float32 launch counts, is only checked
    finite: a reorder of ~1e-7 there can flip a routing choice or a ReLU
    mask, which moves an expert's gradient far more than the arithmetic
    does.  Device ms of one rank's block step (its part alone: its heads
    and experts, forward and backward) beside the dense block's, each
    captured in a CUDA graph (:func:`graph_ms`)."""
    from theanompi_tpu_torch.base import Grid
    from theanompi_tpu_torch.models.transformer_lm import MoEBlock
    from theanompi_tpu_torch.parallel import tp as tplib
    cfg = MOE_CFG if cfg is None else cfg
    tp = TP_RANK["tp"]
    d, t = cfg["d_model"], cfg["seq_len"]

    def local_grid(rank):
        """Model rank ``rank``'s coordinate, its model group ``tp.LOCAL``
        (the rank's part alone; the phase sums the parts)."""
        g = Grid(1, tp, 1, rank)
        g.model_group = tplib.LOCAL
        return g

    def block(cd, attn_impl, rank=None):
        return MoEBlock(d, cfg["n_head"], cfg["moe_experts"], cd=cd,
                        capacity_factor=cfg["capacity_factor"],
                        top_k=cfg["moe_topk"], attn_impl=attn_impl,
                        grid=None if rank is None else local_grid(rank))

    p32 = tree_map(lambda a: a.to(device), block(torch.float32, "reference")
                   .init(torch.Generator().manual_seed(22)))
    dims = block(torch.float32, "reference", 0).model_dims()
    paths = leaf_paths(p32)
    split_dims = [get_leaf(dims, q) for q in paths]
    g = torch.Generator(device=device).manual_seed(23)
    x32 = torch.randn(batch, t, d, generator=g, device=device)
    dy32 = torch.randn(batch, t, d, generator=g, device=device)
    aux_ct = torch.tensor(float(cfg["moe_aux"]), device=device)
    sfx = {torch.bfloat16: "", torch.float32: "_f32"}

    def leaves(rank=None):
        """The block's float32 params (the model's master copy) as new
        leaves (a rank's shards of the split ones)."""
        return tree_map(lambda a, dim: (a if rank is None or dim is None
                                        else a.chunk(tp, dim)[rank])
                        .clone().requires_grad_(True), p32, dims)

    def rank_step(blk, p, x, dy):
        """A block forward and backward (a rank's part alone, or dense);
        the output."""
        y, aux = blk.apply(p, x, train=True)
        torch.autograd.backward([y, aux], [dy, aux_ct])
        return y.detach()

    def run(cd, attn_impl, split, part="block"):
        """Forward and backward of the ``part`` (the ``block``; its
        attention alone from its input, ``attn``; its MoE alone from
        ``h2``, ``moe``) in ``cd``, dense or split over the tp ranks (the
        ranks' outputs summed, their replicated leaves and input shared);
        returns [output, input grad] + each replicated leaf's gradient +
        each rank's shard of each split leaf's, and the launches."""
        x = (h2_32 if part == "moe" else x32).to(cd, copy=True) \
            .requires_grad_(True)
        dy = dy32.to(cd)
        blks = [block(cd, attn_impl, r) for r in range(tp)] if split else \
            [block(cd, attn_impl)]
        # one tensor a replicated leaf, shared by the ranks
        ps = [leaves(0 if split else None)]
        ps += [tree_map(lambda a0, a, dim: a0 if dim is None else a,
                        ps[0], leaves(r), dims) for r in range(1, len(blks))]
        b0 = blks[0]
        zero_launches()
        if part != "moe":
            h1 = b0.ln1.apply(ps[0]["ln1"], x)
            a = sum(b.attn.apply(q["attn"], h1, train=True)
                    for b, q in zip(blks, ps))
        outs = []
        if part == "block":
            x2 = x + a
            h2 = b0.ln2.apply(ps[0]["ln2"], x2)
        if part != "attn":
            outs = [b.moe.apply(q["moe"], x if part == "moe" else h2,
                                train=True) for b, q in zip(blks, ps)]
            for _, aux in outs[1:]:
                check_bits("ep rank aux", aux, outs[0][1])
        if part == "attn":
            y = a
        else:
            y = sum(o for o, _ in outs) + (x2 if part == "block" else 0)
        torch.autograd.backward([y] + [o[1] for o in outs[:1]],
                                [dy] + [aux_ct] * min(1, len(outs)))
        if device == "cuda":
            torch.cuda.synchronize()
        launched = {k: c for k, c in launch_counts().items() if c}
        got = [y.detach(), x.grad]
        for path, dim in zip(paths, split_dims):
            if part in ("block", path[0]) or (part == "attn" and
                                              path[0] == "ln1"):
                g = [get_leaf(q, path).grad for q in ps]
                got += g[:1] if dim is None else g if split else list(
                    g[0].chunk(tp, dim))
        return [a.float() for a in got], launched

    def names(part):
        out = ["output", "input grad"]
        for path, dim in zip(paths, split_dims):
            q = "/".join(map(str, path))
            if part in ("block", path[0]) or (part == "attn" and
                                              path[0] == "ln1"):
                out += [q] if dim is None else [f"{q} rank {r}"
                                                for r in range(tp)]
        return out

    with torch.no_grad():
        h2_32 = block(torch.float32, "reference").ln2.apply(p32["ln2"], x32)
    res, out = {}, {"shape": [batch, cfg["n_head"] // tp, t,
                              d // cfg["n_head"]],
                    "tp": tp, "experts_per_rank": cfg["moe_experts"] // tp,
                    "launches": {}}
    for cd in (torch.bfloat16, torch.float32):
        res[cd, "split"], launched = run(cd, "flash", True)
        want = {f"flash_{k}{sfx[cd]}_cuda": tp
                for k in ("fwd", "bwd_dkv", "bwd_dq")}
        if device == "cuda" and launched != want:
            raise AssertionError(f"ep rank {cd} launches {launched}, want "
                                 f"{want} (one B10, B11, B12 a rank)")
        out["launches"].update(launched)
        x, dy = x32.to(cd, copy=True).requires_grad_(True), dy32.to(cd)
        rb, rp = block(cd, "flash", 0), leaves(0)
        db, dp = block(cd, "flash"), leaves()
        out[f"rank_step{sfx[cd]}_ms"] = graph_ms(
            lambda: rank_step(rb, rp, x, dy))
        out[f"dense_step{sfx[cd]}_ms"] = graph_ms(
            lambda: rank_step(db, dp, x, dy))
        del x, dy, rb, rp, db, dp
    res["bf16", "dense"], _ = run(torch.bfloat16, "flash", False)
    res["ref32"], _ = run(torch.float32, "reference", False)
    for part in ("attn", "moe"):
        res[part, "split"], _ = run(torch.float32, "flash", True, part)
        res[part, "dense"], _ = run(torch.float32, "flash", False, part)
        res[part, "ref64"], _ = run(torch.float64, "reference", False, part)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def hold(key, part, got, base, want, limit):
        """Each entry of ``got``'s distance from ``want`` within ``limit``
        times ``base``'s."""
        d_got = [rel(a, b) for a, b in zip(got, want)]
        d_base = [rel(a, b) for a, b in zip(base, want)]
        ratios = [a / max(b, 1e-30) for a, b in zip(d_got, d_base)]
        worst = int(np.argmax(ratios))
        n = names(part)
        out[key] = {"rel_l2_max": max(d_got), "base_rel_l2_max": max(d_base),
                    "ratio_max": ratios[worst], "worst": n[worst],
                    "entries": len(n),
                    "by_entry": {k: [a, b] for k, a, b in
                                 zip(n, d_got, d_base)}}
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        if not finite or ratios[worst] > limit:
            raise AssertionError(f"ep rank {key}: {out[key]}, finite "
                                 f"{finite}")

    # bf16, the whole block: the rank sums and the dense bf16 block, each
    # from the float32 block (reference attention)
    hold("bf16", "block", res[torch.bfloat16, "split"], res["bf16", "dense"],
         res["ref32"], LM_GRAD_RATIO)
    # float32, the block at its two all-reduces (each half's input the
    # same, so the MoE routes alike): the rank sums and the dense float32
    # half, each from the float64 half (reference attention)
    for part in ("attn", "moe"):
        hold(f"f32_{part}", part, res[part, "split"], res[part, "dense"],
             res[part, "ref64"], LM_F32_GRAD_RATIO)
    if not all(bool(torch.isfinite(a).all())
               for a in res[torch.float32, "split"]):
        raise AssertionError("ep rank f32 block: not finite")
    out["f32_max_abs_err"] = max(
        float((a - b).abs().max()) for part in ("attn", "moe")
        for a, b in zip(res[part, "split"], res[part, "dense"]))
    del res
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def ep_rank_main(card: str, bf16: dict, f32: dict) -> dict:
    """The ep rank phase group (``--ep-rank`` runs it alone): B10–B12 in
    bf16 (``bf16``, :func:`flash_phase` at a tp rank's heads) and in
    float32 (``f32``, the ``tp_rank`` shape of :func:`flash_f32_phase`),
    then one ep = tp 2 rank's MoE block on the card
    (:func:`ep_rank_path_phase`)."""
    path = ep_rank_path_phase()
    shape = path["shape"]
    timed = {"bf16": {k: v for k, v in bf16.items()
                      if k.startswith("flash_")}, "f32": f32}
    for tag, ks in timed.items():
        print(f"tp rank flash {tag} {shape} causal, {card}: " + "; ".join(
            f"{k[:-5]} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_ms'] / r['ms']:.0%} of it, SDPA "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.3f}, max |diff| "
            f"{r['max_abs_err']:.3e})" for k, r in ks.items())
            + "; B11 + B12 %.4f ms; candidates %s" % (
                sum(r["ms"] for k, r in ks.items() if "_bwd_" in k),
                stage_candidates(ks)), flush=True)
    print(f"ep rank path: MoE block, tp = ep {path['tp']}, "
          f"{path['experts_per_rank']} experts and {shape[1]} heads a rank, "
          f"the two ranks' parts summed: launches {path['launches']}; "
          + "; ".join(f"{k} worst ratio {path[k]['ratio_max']:.3f} "
                      f"({path[k]['worst']}; relative L2 max "
                      f"{path[k]['rel_l2_max']:.2e}, dense "
                      f"{path[k]['base_rel_l2_max']:.2e})"
                      for k in ("bf16", "f32_attn", "f32_moe"))
          + f"; rank step captured {path['rank_step_ms']:.4f} ms (dense "
          f"block {path['dense_step_ms']:.4f}, "
          f"{path['rank_step_ms'] / path['dense_step_ms']:.3f}×), f32 "
          f"{path['rank_step_f32_ms']:.4f} ms (dense "
          f"{path['dense_step_f32_ms']:.4f}, "
          f"{path['rank_step_f32_ms'] / path['dense_step_f32_ms']:.3f}×), "
          f"{card}", flush=True)
    return {"path": path, "bf16": timed["bf16"], "f32": f32,
            "candidates": stage_candidates(timed["bf16"]),
            "candidates_f32": stage_candidates(f32)}


def tf32_probe_phase() -> dict:
    """How the tensor core reads float32 bit patterns handed to a TF32
    wgmma (``tf32_probe`` of ``csrc/flash_attention_f32.cu``): seeded
    float32 inputs with random low bits, for the register operand (A) and
    the shared-memory operand (B) in turn, the other exact in TF32; the
    card's result against the products of their truncations to TF32, of
    their roundings (to nearest, ties away) and of their full values, each
    distance relative to Σ|a||b|; and both operands exact in TF32 against
    their exact product.  B10–B12 f32 hand the tensor core TF32 values
    (rounded, their low bits zero) and take their products as exact with
    float32 sums, whatever it does with other bits: raises if exact inputs
    come out otherwise, or if the models cannot be told apart."""
    lib = _kernel_build.load("flash_attention_f32")
    lib.tf32_probe.argtypes = [ctypes.c_void_p] * 4
    lib.tf32_probe.restype = ctypes.c_int

    def trunc(x):
        return (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)

    def rounded(x):
        return ((x.view(np.uint32) + np.uint32(0x1000))
                & np.uint32(0xffffe000)).view(np.float32)

    def probe(aa, bb):
        ta, tb = torch.from_numpy(aa).cuda(), torch.from_numpy(bb).cuda()
        d = torch.empty(64, 32, device="cuda")
        rc = lib.tf32_probe(ta.data_ptr(), tb.data_ptr(), d.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc:
            raise AssertionError(f"TF32 probe: CUDA error {rc} at launch")
        got = d.cpu().numpy().astype(np.float64)
        mag = np.abs(aa.astype(np.float64)) @ np.abs(bb.astype(np.float64)).T
        return {name: float(np.max(np.abs(
                    got - f(aa).astype(np.float64) @ f(bb).astype(
                        np.float64).T) / mag))
                for name, f in (("truncated", trunc), ("rounded", rounded),
                                ("full", lambda x: x))}

    r = np.random.RandomState(7)
    a = r.standard_normal((64, 8)).astype(np.float32)
    b = r.standard_normal((32, 8)).astype(np.float32)
    out = {}
    for side in ("A", "B"):
        dist = probe(a if side == "A" else rounded(a),
                     b if side == "B" else rounded(b))
        if min(dist["rounded"], dist["full"]) < 10 * TF32_PROBE_TOL:
            raise AssertionError(f"TF32 probe, operand {side}: the models "
                                 f"are not told apart: {dist}")
        out[side] = dict(dist, reads=min(dist, key=dist.get))
    out["exact"] = probe(rounded(a), rounded(b))["full"]
    if not out["exact"] < TF32_PROBE_TOL:
        raise AssertionError(f"TF32 probe: TF32 inputs come out "
                             f"{out['exact']:.2e} from their exact product")
    return out


def attention_bf16_probs(q, k, v, *, causal=False, scale=None):
    """The reference attention with its probabilities rounded to bfloat16
    (and dP, through the cast's backward): the control of
    :func:`lm_f32_check_phase`."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = s.shape[-1]
        valid = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def lm_f32_check_phase():
    """The float32 flash LM at full width, batch 2: loss and every gradient
    leaf on the card (the float32 B10–B12, each launched once a layer)
    against the same weights and batch on the CPU (the plain versions):
    the loss within LM_F32_LOSS_RTOL, each leaf's relative L2 distance
    within LM_F32_GRAD_RATIO times that leaf's floor, the same comparison
    with the reference attention on both sides (no kernel).  The control
    (:func:`attention_bf16_probs` on the card against the CPU's reference)
    must exceed that limit on some leaf."""
    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.models.transformer_lm import TransformerLM
    cfg = dict(LM_CFG, batch_size=LM_CHECK_BATCH, synthetic_train=2,
               synthetic_val=2, seed=0, verbose=False,
               compute_dtype="float32")
    host = None
    res = {}
    n = LM_CFG["n_layer"]
    plain_attention = L.attention_reference
    runs = (("flash", "cuda"), ("flash", "cpu"), ("reference", "cuda"),
            ("reference", "cpu"), ("control", "cuda"))
    for attn, dev in runs:
        m = TransformerLM(dict(cfg, device=dev, attn_impl="reference"
                               if attn == "control" else attn))
        if host is None:
            host = m.data.next_train_batch(1)
            src = [p.detach().cpu() for p in tree_leaves(m.params)]
            names = ["/".join(map(str, p)) for p in leaf_paths(m.params)]
        with torch.no_grad():
            for a, c in zip(tree_leaves(m.params), src):
                a.copy_(c)
        batch = {k: torch.from_numpy(v).to(m.device)
                 for k, v in host.items()}
        zero_launches()
        L.attention_reference = attention_bf16_probs \
            if attn == "control" else plain_attention
        try:
            cost, _ = m.loss_and_metrics(m.params, m.bn_state, batch, None,
                                         True)
            grads = torch.autograd.grad(cost, tree_leaves(m.params))
        finally:
            L.attention_reference = plain_attention
        if dev == "cuda":
            torch.cuda.synchronize()
            want = expect(**({"flash_fwd_f32_cuda": n,
                              "flash_bwd_dkv_f32_cuda": n,
                              "flash_bwd_dq_f32_cuda": n}
                             if attn == "flash" else {}))
            if launch_counts() != want:
                raise AssertionError(f"f32 LM check ({attn}) launches "
                                     f"{launch_counts()}, expected {want}")
        res[attn, dev] = (float(cost.detach()),
                          [g.detach().cpu() for g in grads])
        del m, cost, grads
    res["control", "cpu"] = res["reference", "cpu"]
    out = {"leaves": len(names)}
    rel = {}
    for attn in ("flash", "reference", "control"):
        (cc, ga), (cp, gb) = res[attn, "cuda"], res[attn, "cpu"]
        rel[attn] = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                     for a, b in zip(ga, gb)]
        worst = sorted(zip(rel[attn], names), reverse=True)[:4]
        out[attn] = {"loss_card": cc, "loss_cpu": cp,
                     "loss_rel_err": abs(cc - cp) / abs(cp),
                     "grad_rel_l2_max": max(rel[attn]),
                     "grad_rel_l2_median": float(np.median(rel[attn])),
                     "worst_leaves": [[n_, r] for r, n_ in worst]}
    for attn in ("flash", "control"):
        ratio = [a / max(b, 1e-30) for a, b in zip(rel[attn],
                                                   rel["reference"])]
        worst = sorted(zip(ratio, names), reverse=True)[:4]
        out[attn].update(grad_ratio_max=max(ratio),
                         grad_ratio_median=float(np.median(ratio)),
                         leaves_over_limit=sum(
                             r > LM_F32_GRAD_RATIO for r in ratio),
                         worst_ratios=[[n_, r] for r, n_ in worst])
    out["per_leaf"] = {"names": names, **rel}
    del res, src
    gc.collect()
    torch.cuda.empty_cache()
    f, c = out["flash"], out["control"]
    if not np.isfinite(f["loss_card"]) or \
            f["loss_rel_err"] > LM_F32_LOSS_RTOL or \
            f["grad_ratio_max"] > LM_F32_GRAD_RATIO:
        raise AssertionError(f"f32 flash LM card vs CPU: {out}")
    if c["grad_ratio_max"] <= LM_F32_GRAD_RATIO:
        raise AssertionError(f"the f32 LM limit passes bf16-rounded "
                             f"attention: {c}")
    return out


def lm_f32_main_path_phase():
    """The LM's main path in float32 with ``attn_impl='flash'``: 8 captured
    Adam steps at b16 and a validation batch through the BSP session, every
    attention through the float32 B10–B12 (n_layer · 9 B10, n_layer · 8
    B11 and B12, nothing else)."""
    n = LM_CFG["n_layer"]
    want = expect(flash_fwd_f32_cuda=n * (LM_STEPS + VAL_BATCHES),
                  flash_bwd_dkv_f32_cuda=n * LM_STEPS,
                  flash_bwd_dq_f32_cuda=n * LM_STEPS)
    model, out = run_main_path(
        "theanompi_tpu_torch.models.transformer_lm", "TransformerLM", want,
        batch_size=LM_BATCH, synthetic_train=LM_BATCH * LM_STEPS,
        synthetic_val=LM_BATCH * VAL_BATCHES, printFreq=LM_STEPS // 2,
        compute_dtype="float32", **LM_CFG)
    out["tokens_per_s"] = out["img_per_s"] * LM_CFG["seq_len"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


LM_F32_GROUPS = {"flash_f32": ("flash_fwd_f32_kernel",
                               "flash_bwd_dkv_f32_kernel",
                               "flash_bwd_dq_f32_kernel")}


def flash_f32_main(card: str) -> dict:
    """The A11 phase group (``--flash-f32`` runs it alone): the float32
    kernels' checks and times, the float32 LM card vs CPU, its main path
    and its captured step's profile."""
    probe = tf32_probe_phase()
    print("TF32 probe (one wgmma, float32 bits as they are): " + "; ".join(
        f"operand {side} reads as {probe[side]['reads']} (distance truncated "
        f"{probe[side]['truncated']:.2e}, rounded {probe[side]['rounded']:.2e},"
        f" full {probe[side]['full']:.2e})" for side in ("A", "B"))
        + f"; TF32 inputs {probe['exact']:.2e} from their exact product "
        f"(B10–B12 f32 hand it TF32 values rounded to nearest)", flush=True)
    kern = flash_f32_phase()
    print("flash f32 SASS (per head dim 32, 64, 128): " + "; ".join(
        f"{k} " + ", ".join(f"{i} {n}" for i, n in c.items())
        for k, c in kern["sass"].items()), flush=True)
    print("flash attention float32 (A11): " + "; ".join(
        f"{tag} {r['shape']} {'causal' if r['causal'] else 'non-causal'}"
        f"{' strided' if r['strided'] else ''} max |diff| " + ", ".join(
            f"{k[:-9]} {e:.3e}" for k, e in r["max_abs_err"].items())
        for tag, r in kern["shapes"].items()) + " (rerun bit for bit)",
        flush=True)
    print("flash f32 %s causal: " % kern["shape"] + ", ".join(
        f"{k[:-9]} {kern[k]['ms']:.4f} ms (split-TF32 bound "
        f"{kern[k]['bound_ms']:.4f} {kern[k]['bound_by']}, FFMA bound "
        f"{kern[k]['ffma_bound_ms']:.4f}, plain {kern[k]['plain_ms']:.3f}, "
        f"SDPA f32 {kern[k]['library_ms']:.4f}), host "
        f"{kern[k]['host_us']:.1f} us"
        for k in ("flash_fwd_f32_cuda", "flash_bwd_dkv_f32_cuda",
                  "flash_bwd_dq_f32_cuda")), flush=True)
    b10 = kern["flash_fwd_f32_cuda"]
    print(f"flash f32 forward: B10 {b10['ms']:.4f} ms against float32 "
          f"SDPA's forward {b10['library_ms']:.4f} ms; split-TF32 bound "
          f"{b10['bound_ms']:.4f} ms ({b10['bound_ms'] / b10['ms']:.0%} of "
          f"it reached)", flush=True)
    if b10["ms"] >= b10["library_ms"]:
        raise AssertionError(f"B10 f32 {b10['ms']:.4f} ms does not beat "
                             f"float32 SDPA's forward "
                             f"{b10['library_ms']:.4f} ms")
    b11, b12 = kern["flash_bwd_dkv_f32_cuda"], kern["flash_bwd_dq_f32_cuda"]
    print(f"flash f32 backward: B11 + B12 {b11['ms'] + b12['ms']:.4f} ms "
          f"against float32 SDPA's autograd backward {b12['library_ms']:.4f} "
          f"ms; split-TF32 bound {b11['bound_ms'] + b12['bound_ms']:.4f} "
          f"ms ({(b11['bound_ms'] + b12['bound_ms']) / (b11['ms'] + b12['ms']):.0%}"
          f" of it reached), FFMA bound "
          f"{b11['ffma_bound_ms'] + b12['ffma_bound_ms']:.4f} ms", flush=True)
    if b11["ms"] + b12["ms"] >= b12["library_ms"]:
        raise AssertionError(f"B11 + B12 f32 {b11['ms'] + b12['ms']:.4f} ms "
                             f"do not beat float32 SDPA's backward "
                             f"{b12['library_ms']:.4f} ms")
    check = lm_f32_check_phase()
    for attn in ("flash", "reference", "control"):
        c = check[attn]
        ratio = "" if attn == "reference" else (
            f"; leaf / floor max {c['grad_ratio_max']:.2f} (median "
            f"{c['grad_ratio_median']:.2f}, {c['leaves_over_limit']} leaves "
            f"over {LM_F32_GRAD_RATIO}; worst {c['worst_ratios']})")
        print(f"LM float32 {attn} card vs CPU, batch {LM_CHECK_BATCH}: loss "
              f"{c['loss_card']:.7f} vs {c['loss_cpu']:.7f} (rel "
              f"{c['loss_rel_err']:.2e}), gradient relative L2 max "
              f"{c['grad_rel_l2_max']:.2e}, median "
              f"{c['grad_rel_l2_median']:.2e} over {check['leaves']} leaves; "
              f"worst {c['worst_leaves']}{ratio}", flush=True)
    main = lm_f32_main_path_phase()
    print(f"main path: TransformerLM BSP flash float32 batch {LM_BATCH}, "
          f"{LM_STEPS} steps, costs {[round(c, 4) for c in main['costs']]}, "
          f"{main['tokens_per_s']:.0f} tokens/s, launches "
          f"{ {k: v for k, v in main['launches'].items() if v} } on {card}",
          flush=True)
    prof = step_profile_phase(
        "theanompi_tpu_torch.models.transformer_lm", "TransformerLM",
        LM_BATCH, LM_F32_GROUPS, PROFILE_STEPS, compute_dtype="float32",
        synthetic_train=LM_BATCH * (2 + 2 * PROFILE_STEPS), **LM_CFG)
    prof["tokens_per_s"] = prof["img_per_s"] * LM_CFG["seq_len"]
    print_profile(prof, card, LM_F32_GROUPS)
    print(f"LM float32 captured step: {prof['tokens_per_s']:.0f} tokens/s",
          flush=True)
    return {"kernels": kern, "tf32_probe": probe, "lm_check": check,
            "main": main, "profile": prof}


def run_main_path(modelfile, modelclass, want_launches, rule="bsp", **cfg):
    """``<RULE>().init(devices=1, ...).wait()`` (``BSP`` unless ``rule``
    names another) with every launch count set to 0 just before and read
    just after; checks the costs, the params' device and the launch counts
    against ``want_launches``."""
    zero_launches()
    rule = getattr(tmpi, rule.upper())()
    rule.init(devices=1, modelfile=modelfile, modelclass=modelclass,
              **dict(dict(epochs=1, synthetic_val_batches=VAL_BATCHES,
                          seed=0), **cfg))
    t0 = time.time()
    rec = rule.wait()
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = launch_counts()
    costs = [r["cost"] for r in rec.train_records]
    if not costs or not all(np.isfinite(costs)):
        raise AssertionError(f"{modelclass} cost not finite: {costs}")
    if not all(np.isfinite(r["val_cost"]) for r in rec.epoch_records):
        raise AssertionError(f"validation cost: {rec.epoch_records}")
    devs = {p.device.type for p in tree_leaves(rule.model.params)}
    if devs != {"cuda"}:
        raise AssertionError(f"params on {devs}")
    if launches != want_launches:
        raise AssertionError(f"{modelclass} launches {launches}, expected "
                             f"{want_launches}")
    return rule.model, {"launches": launches, "costs": costs, "secs": secs,
                        "img_per_s": rec.train_records[-1]["images_per_sec"],
                        "val": rec.epoch_records[-1]}


def alexnet_main_path_phase():
    # two LRNs per forward (train steps + validation batches), per backward
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS)
    _, out = run_main_path("theanompi_tpu_torch.models.alex_net", "AlexNet",
                           want, batch_size=BATCH, synthetic_batches=STEPS,
                           printFreq=STEPS // 2)
    return out


def lm_main_path_phase():
    """The LM under BSP: 8 Adam steps and a validation batch, launches
    counted.  Every layer's attention runs B10 forward (train and
    validation) and B11 + B12 backward."""
    n = LM_CFG["n_layer"]
    want = expect(flash_fwd_cuda=n * (LM_STEPS + VAL_BATCHES),
                  flash_bwd_dkv_cuda=n * LM_STEPS,
                  flash_bwd_dq_cuda=n * LM_STEPS)
    model, out = run_main_path(
        "theanompi_tpu_torch.models.transformer_lm", "TransformerLM", want,
        batch_size=LM_BATCH, synthetic_train=LM_BATCH * LM_STEPS,
        synthetic_val=LM_BATCH * VAL_BATCHES, printFreq=LM_STEPS // 2,
        **LM_CFG)
    out["n_params"] = sum(p.numel() for p in tree_leaves(model.params))
    out["tokens_per_s"] = out["img_per_s"] * LM_CFG["seq_len"]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def googlenet_main_path_phase():
    """GoogLeNet under BSP, batch 32, full width, bf16: 8 steps and a
    validation batch.  Its stem's two LRNs run B1 in every forward (train
    and validation) and B2 in every backward."""
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS)
    model, out = run_main_path(
        "theanompi_tpu_torch.models.googlenet", "GoogLeNet", want,
        batch_size=ZOO_BATCH, synthetic_batches=STEPS, printFreq=STEPS // 2,
        learning_rate=ZOO_LR["GoogLeNet"])
    out["n_params"] = sum(p.numel() for p in tree_leaves(model.params))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resnet_main_path_phase():
    """ResNet-50 under BSP, batch 32, full width, bf16: 8 steps and a
    validation batch, no hand-written kernel.  Its 53 BatchNorms' running
    state must sit on the card, finite, every ``mean`` moved off its zero
    init."""
    from theanompi_tpu_torch.utils.helper_funcs import leaf_paths
    model, out = run_main_path(
        "theanompi_tpu_torch.models.resnet50", "ResNet50", expect(),
        batch_size=ZOO_BATCH, synthetic_batches=STEPS, printFreq=STEPS // 2,
        learning_rate=ZOO_LR["ResNet50"])
    bn = dict(zip(map(tuple, leaf_paths(model.bn_state)),
                  tree_leaves(model.bn_state)))
    means = [t for p, t in bn.items() if p[-1] == "mean"]
    if len(means) != 53 or {t.device.type for t in bn.values()} != \
            {"cuda"} or not all(bool(torch.isfinite(t).all())
                                for t in bn.values()) or \
            not all(bool(t.abs().sum() > 0) for t in means):
        raise AssertionError(f"ResNet-50 BN state: {len(means)} means on "
                             f"{ {t.device.type for t in bn.values()} }")
    out["n_params"] = sum(p.numel() for p in tree_leaves(model.params))
    out["bn_mean_abs_mean"] = float(sum(t.abs().mean() for t in means)
                                    / len(means))
    del model, bn, means
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cifar10_main_path_phase():
    """Cifar10_model under BSP, batch 128, bf16, on its synthetic set: 8
    steps and a validation batch, no hand-written kernel."""
    _, out = run_main_path(
        "theanompi_tpu_torch.models.cifar10", "Cifar10_model", expect(),
        batch_size=BATCH, synthetic_train=BATCH * STEPS,
        synthetic_val=BATCH * VAL_BATCHES, printFreq=STEPS // 2,
        learning_rate=ZOO_LR["Cifar10_model"])
    gc.collect()
    torch.cuda.empty_cache()
    return out


class ExchangeSpy:
    """For the length of a ``with``: every due exchange the worker's hook
    runs is bracketed by a clone of the params and the rule state before it
    and ``check(exchanger, model, params_before, extra_before)`` after it
    (a plain recomputation of the exchange); and every validation records
    whether it scored the tensors ``scored(model)`` names."""

    def __init__(self, check, scored=None):
        self.check, self.scored = check, scored
        self.exchanges, self.val_scored = 0, []

    def __enter__(self):
        from theanompi_tpu_torch.models.model_base import ModelBase
        from theanompi_tpu_torch.parallel.exchanger import Exchanger
        self._orig = (Exchanger.exchange, ModelBase.val_params)
        spy, (exchange, val_params) = self, self._orig

        def spied_exchange(ex, recorder=None, count=0):
            if ex.fused or not ex.due(count):
                return exchange(ex, recorder, count)
            m = ex.model
            before = ([p.detach().clone() for p in tree_leaves(m.params)],
                      [t.clone() for t in tree_leaves(m.extra)])
            exchange(ex, recorder, count)
            spy.check(ex, m, *before)
            spy.exchanges += 1

        def spied_val_params(m):
            out = val_params(m)
            if spy.scored is not None:
                spy.val_scored.append(out[0] is spy.scored(m))
            return out

        Exchanger.exchange = spied_exchange
        ModelBase.val_params = spied_val_params
        return self

    def __exit__(self, *exc):
        from theanompi_tpu_torch.models.model_base import ModelBase
        from theanompi_tpu_torch.parallel.exchanger import Exchanger
        Exchanger.exchange, ModelBase.val_params = self._orig


def easgd_check(ex, m, p0, c0) -> None:
    """The elastic update recomputed leaf by leaf from the pre-exchange
    tensors in float64 (world 1: the sum over the ranks is the rank's own
    delta): ``c + α·d / size`` and ``p − α·d`` with ``d = p − c``, within
    ``EASGD_TOL``."""
    for i, (p, c, P, C) in enumerate(zip(tree_leaves(m.params),
                                         tree_leaves(m.extra["center"]),
                                         p0, c0)):
        P, C = P.double(), C.double()
        d = P - C
        check_close(f"easgd center leaf {i}", c.double(),
                    C + ex.alpha * d / ex.size, *EASGD_TOL)
        check_close(f"easgd params leaf {i}", p.detach().double(),
                    P - ex.alpha * d, *EASGD_TOL)


def asgd_check(ex, m, p0, c0) -> None:
    """Downpour at world 1: the center absorbs ``p − c`` and the params are
    the center, bit for bit."""
    for i, (p, c, P, C) in enumerate(zip(tree_leaves(m.params),
                                         tree_leaves(m.extra["center"]),
                                         p0, c0)):
        check_bits(f"asgd center leaf {i}", c, C + (P - C))
        check_bits(f"asgd params == center leaf {i}", p.detach(), c)


def gosgd_check(ex, m, p0, a0) -> None:
    """Gossip at world 1 (the route is the identity): α stays exactly 1
    (Σα conserved) and the merge ``(α_keep·p + α_send·p) / α`` gives the
    params back bit for bit, whether the gate sent or not."""
    if float(m.extra["alpha"]) != 1.0 or float(a0[0]) != 1.0:
        raise AssertionError(f"gosgd alpha {float(m.extra['alpha'])}")
    for i, (p, P) in enumerate(zip(tree_leaves(m.params), p0)):
        check_bits(f"gosgd params leaf {i}", p.detach(), P)


RULE_CHECKS = {"vgg16_easgd": easgd_check, "resnet50_gosgd": gosgd_check,
               "alexnet_asgd": asgd_check}


def rule_main_path_phase(path: str) -> dict:
    """An async rule's main path through its session (``EASGD()``,
    ``GOSGD()``, ``ASGD()``), 8 steps and a validation batch, captured
    (the step and the exchange, each a CUDA graph): costs, the params' and
    the rule state's device, every exchange against its plain
    recomputation (:data:`RULE_CHECKS`), validation scoring the center
    under EASGD, ResNet-50's BatchNorm state (local, finite, moved), and
    the launches (AlexNet's LRNs: 2 B1 a forward, 2 B2 a backward)."""
    modelfile, modelclass, cfg = GRAPH_PATHS[path]
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS) if modelclass == "AlexNet" \
        else expect()
    scored = (lambda m: m.extra["center"]) if path == "vgg16_easgd" \
        else None
    with ExchangeSpy(RULE_CHECKS[path], scored) as spy:
        model, out = run_main_path(modelfile, modelclass, want,
                                   printFreq=STEPS // 2, **cfg)
    every = cfg.get("sync_freq", 1)
    if spy.exchanges != STEPS // every:
        raise AssertionError(f"{path}: {spy.exchanges} exchanges checked, "
                             f"expected {STEPS // every}")
    if scored is not None and spy.val_scored != [True] * VAL_BATCHES:
        raise AssertionError(f"{path}: validation scored "
                             f"{spy.val_scored}, not the center")
    if not (model.train_fn.graphed and model.exchange_fn.graphed):
        raise AssertionError(f"{path}: not captured")
    extra = tree_leaves(model.extra)
    if {t.device.type for t in extra} != {"cuda"} or \
            not all(bool(torch.isfinite(t).all()) for t in extra):
        raise AssertionError(f"{path}: rule state not finite on the card")
    if path == "resnet50_gosgd":
        bn = tree_leaves(model.bn_state)
        if {t.device.type for t in bn} != {"cuda"} or \
                not all(bool(torch.isfinite(t).all()) for t in bn) or \
                not any(bool(t.abs().sum() > 0) for t in bn):
            raise AssertionError("ResNet-50 GoSGD BN state")
    out.update(exchanges_checked=spy.exchanges,
               n_params=sum(p.numel() for p in tree_leaves(model.params)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def clip_phase() -> dict:
    """``grad_clip`` on the card: AlexNet BSP b128 under ``sgd`` (lr 0.01,
    no decay), the clip set to half of the first step's gradient norm (the
    gradient recomputed with the step's own dropout stream, cuDNN
    deterministic); the captured step's params must be ``p − lr ·
    (clip/‖g‖) · g`` computed plainly, within ``CLIP_RTOL`` of a step."""
    from theanompi_tpu_torch.parallel import steps as steps_lib
    from theanompi_tpu_torch.worker import BSP_Worker
    lr = 0.01
    worker = BSP_Worker({"n_workers": 1, "seed": 0, "verbose": False,
                         "batch_size": BATCH, "synthetic_batches": 2,
                         "optimizer": "sgd", "weight_decay": 0.0,
                         "learning_rate": lr})
    torch.backends.cudnn.deterministic = True
    try:
        model = worker.build_model("theanompi_tpu_torch.models.alex_net",
                                   "AlexNet")
        model.compile_iter_fns(worker.exchanger)
        model.data.shuffle_data(model.seed)
        cursor = model.data.get_cursor()
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in model.data.next_train_batch(1).items()}
        model.data.set_cursor(cursor)
        gen = torch.Generator(device="cuda").manual_seed(
            steps_lib.step_seed(model.step_seed, model.rank, 1))
        leaves = tree_leaves(model.params)

        def first_grads():
            # the autograd graph goes with the cost on return: a graph
            # kept alive would tie the params' accumulate nodes to this
            # stream, and the step's capture on its own stream refuses that
            cost, _ = model.loss_and_metrics(model.params, model.bn_state,
                                             batch, gen, True)
            return torch.autograd.grad(cost, leaves)

        grads = first_grads()
        norm = float(torch.stack([g.double().square().sum()
                                  for g in grads]).sum().sqrt())
        worker.exchanger.clip = norm / 2
        p0 = [p.detach().clone() for p in leaves]
        model.train_iter(1)
        torch.cuda.synchronize()
        # sgd's arithmetic in float32 on the plainly clipped gradient
        norm32 = torch.stack([g.float().square().sum()
                              for g in grads]).sum().sqrt()
        scale = torch.clamp((norm / 2) / torch.clamp(norm32, min=1e-12),
                            max=1.0)
        want = [P - ((P * 0.0) + g * scale) * lr for P, g in zip(p0, grads)]
        err = max(float((p.detach() - w).abs().max())
                  for p, w in zip(leaves, want))
        step = max(float((P - w).abs().max()) for P, w in zip(p0, want))
        rel = err / step
        if not model.train_fn.graphed or not rel < CLIP_RTOL:
            raise AssertionError(f"grad_clip: params off the clipped "
                                 f"update's by {rel:.3e} of its largest "
                                 f"step")
        del model, grads, p0, want
    finally:
        torch.backends.cudnn.deterministic = False
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    return {"grad_norm": norm, "clip": norm / 2, "max_err_over_step": rel}


def optimizer_phase() -> dict:
    """The rest of the update layer through the session, AlexNet BSP b128,
    8 steps and a validation batch each: ``ema_decay`` 0.999 (validation
    scores the shadow, finite, apart from the params), ``nesterov`` and
    ``rmsprop`` (finite costs; rmsprop at 1e-4, an rmsprop rate)."""
    out = {}
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS)
    for name, cfg in (("ema", {"ema_decay": 0.999}),
                      ("nesterov", {"optimizer": "nesterov"}),
                      ("rmsprop", {"optimizer": "rmsprop",
                                   "learning_rate": 1e-4})):
        scored = (lambda m: m.opt_state["ema"]) if name == "ema" else None
        with ExchangeSpy(None, scored) as spy:
            model, r = run_main_path(
                "theanompi_tpu_torch.models.alex_net", "AlexNet", want,
                batch_size=BATCH, synthetic_batches=STEPS,
                printFreq=STEPS // 2, **cfg)
        if name == "ema":
            ema = tree_leaves(model.opt_state["ema"])
            if spy.val_scored != [True] * VAL_BATCHES or \
                    int(model.opt_state["t"]) != STEPS or \
                    not all(bool(torch.isfinite(e).all()) for e in ema) or \
                    all(bool(torch.equal(e, p)) for e, p in
                        zip(ema, tree_leaves(model.params))):
                raise AssertionError(f"ema: validation scored "
                                     f"{spy.val_scored}")
        out[name] = {k: r[k] for k in ("costs", "img_per_s", "val")}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def exchange_ms(model) -> dict:
    """Device ms of one exchange alone (``exchange_fn``, a graph replay
    when captured), CUDA events; the state it moves is the model's own."""
    if model.exchange_fn is None:
        return {}
    count = [0]

    def one():
        count[0] += 1
        model.exchange_fn(count[0])

    return {"exchange_ms": time_ms(one, reps=5, inner=5, warmup=2)}


def aux_heads_ms(model) -> dict:
    """Device ms a step of GoogLeNet's two aux heads alone: forward, their
    0.3-weighted costs and backward (params and taps) on bf16 taps of 4a's
    and 4d's output shapes at the profile's batch, captured in a CUDA graph
    whose replays are timed, so the host's launches of its ~100 kernels
    (slower than the device on some hosts) are not."""
    g = torch.Generator(device="cuda").manual_seed(0)
    taps = [torch.randn(ZOO_BATCH, 14, 14, c, generator=g, device="cuda")
            .to(torch.bfloat16).requires_grad_(True) for c in (512, 528)]
    y = torch.randint(0, 1000, (ZOO_BATCH,), generator=g, device="cuda")
    drop = torch.Generator(device="cuda").manual_seed(1)
    from theanompi_tpu_torch.models import layers as L
    leaves = tree_leaves(model.params["aux1"]) + \
        tree_leaves(model.params["aux2"])

    def run():
        cost = sum(L.softmax_cross_entropy(
            getattr(model, k).apply(model.params[k], t, train=True,
                                    gen=drop), y)
            for k, t in zip(("aux1", "aux2"), taps))
        return torch.autograd.grad(0.3 * cost, leaves + taps)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run()                                    # warm-up, off the graph
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(drop)
    with torch.cuda.graph(graph):
        run()
    return {"ms": time_ms(graph.replay)}


# each VGG-16 main path's kernels, per training step: the onebit exchange
# runs B5, B6, B4; topk B7, B8; PowerSGD B9 once per factor pass, over all
# 16 compressible leaves; no path runs LRN or B3
VGG_PATHS = {
    "onebit": dict(pack_signs_encode_cuda=1, signed_residual_cuda=1,
                   unpack_signs_wsum_cuda=1),
    "topk": dict(topk_encode_cuda=1, topk_decode_cuda=1),
    "powersgd": dict(matmul_pack_group_cuda=2),
}


def state_tensors(state) -> list:
    """A strategy state's tensors (a flat tensor, or a per-leaf list)."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for d in state for t in d.values()]


def vgg_main_path_phase(strategy: str, state_shape):
    """VGG-16 under ``strategy`` for VGG_STEPS steps: launch counts, and
    the strategy's state finite, on the card and nonzero (``state_shape``:
    the flat state's shape, or the number of leaves of a per-leaf one)."""
    want = expect(**{k: n * VGG_STEPS for k, n in VGG_PATHS[strategy].items()})
    model, out = run_main_path(
        "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", want,
        exch_strategy=strategy, batch_size=VGG_BATCH, learning_rate=VGG_LR,
        synthetic_batches=VGG_STEPS, printFreq=VGG_STEPS // 2)
    st = model.extra["strat"]
    ts = state_tensors(st)
    shape = tuple(st.shape) if isinstance(st, torch.Tensor) else len(st)
    if shape != state_shape or {t.device.type for t in ts} != {"cuda"} or \
            not all(bool(torch.isfinite(t).all()) for t in ts) or \
            not any(bool(t.any()) for t in ts):
        raise AssertionError(f"{strategy} state {shape} on "
                             f"{ {t.device.type for t in ts} }, finite "
                             f"{[bool(torch.isfinite(t).all()) for t in ts]}")
    out["state_abs_mean"] = float(sum(t.abs().sum() for t in ts)
                                  / sum(t.numel() for t in ts))
    del model, st, ts
    gc.collect()                 # the model and its exchanger refer to each other
    torch.cuda.empty_cache()
    return out


def exchange_sync_check(model) -> list:
    """One exchange of the model's strategy on a gradient-shaped tree under
    CUDA's sync debug mode: the warnings of every operation that made the
    host wait for the card (an ``.item()``, a copy to the host)."""
    grads = tree_map(torch.randn_like, model.params)
    strat = model.exchanger.strategy
    state = tree_map(torch.clone, model.extra["strat"])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            strat(grads, state, size=1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the warning each synchronizing operation raises in "warn" mode (the
    # mode's own notice that it is a prototype is not one)
    return [str(w.message)[:200] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def step_profile_phase(modelfile, modelclass, batch, groups, steps, warmup=2,
                       after=None, capture=None, **cfg):
    """Where a main-path step's time goes, after warm-up: host wall time per
    step (the step ends in a synchronize) and the recorder's host buckets,
    unprofiled; then the same steps under ``torch.profiler`` for device busy
    time per step, the device's idle share, the kernels by device time, and
    the per-step device time of each group of kernels (``groups``: label →
    name substrings).  ``after(model)`` runs at the end, its result kept.
    ``capture=False`` profiles the eager step (default: the captured one,
    whose kernels the profiler sees as the replays run them)."""
    from theanompi_tpu_torch.worker import WORKERS
    cfg = dict(cfg)
    worker = WORKERS[cfg.pop("rule", "bsp")](dict(
        {"n_workers": 1, "batch_size": batch, "seed": 0, "verbose": False},
        **cfg))
    try:
        model = worker.build_model(modelfile, modelclass)
        model.compile_iter_fns(worker.exchanger, capture=capture)
        if cfg.get("para_load"):
            # the producer starts with the epoch: before it, a
            # PrefetchLoader serves on the step's thread
            model.data.shuffle_data(0)
        # an async rule's exchange hook (none in a tree from before the
        # async rules, where --update-times runs too)
        hook = getattr(worker.exchanger, "exchange", lambda rec, count: None)
        out = profile_model(model, hook, modelclass, batch, groups, steps,
                            warmup, after)
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def profile_model(model, hook, modelclass, batch, groups, steps, warmup=2,
                  after=None, count=0) -> dict:
    """:func:`step_profile_phase`'s measurement of a model already built
    and compiled, its steps counted on from ``count``."""
    from torch.profiler import ProfilerActivity, profile
    from theanompi_tpu_torch.utils.recorder import Recorder
    graphed = model.train_fn.graphed

    def run(n, rec=None):
        nonlocal count
        for _ in range(n):
            count += 1
            model.train_iter(count, rec)
            hook(rec, count)
        torch.cuda.synchronize()

    run(warmup)
    rec = Recorder({"verbose": False})
    t0 = time.time()
    run(steps, rec)
    wall_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    extra = after(model) if after else None
    by_kernel = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same time again
        t = getattr(e, "self_device_time_total", 0)
        if t > 0 and str(e.device_type).endswith("CUDA") and \
                not e.key.startswith("Activity Buffer"):
            by_kernel.append({"name": e.key[:240], "key": e.key,
                              "ms_per_step": t / 1e3 / steps,
                              "calls_per_step": e.count / steps})
    by_kernel.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in by_kernel)
    host = {s: rec.t_sec_total[s] * 1e3 / steps
            for s in ("load", "stage", "train", "comm")}
    out = {"model": modelclass, "batch": batch, "steps": steps,
           "captured": graphed,
           "kernel_calls_per_step": sum(
               r["calls_per_step"] for r in by_kernel
               if not r["key"].startswith("Memcpy")),
           "wall_ms_per_step": wall_ms, "img_per_s": batch * 1e3 / wall_ms,
           "host_ms_per_step": host, "device_busy_ms_per_step": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
           "top_kernels": [{k: v for k, v in r.items() if k != "key"}
                           for r in by_kernel[:15]]}
    # host → device copies, with the memory kind the profiler names
    # ("Memcpy HtoD (Pinned -> Device)" or "(Pageable -> Device)")
    htod = [r for r in by_kernel if r["key"].startswith("Memcpy HtoD")]
    out["htod_ms_per_step"] = sum(r["ms_per_step"] for r in htod)
    out["htod"] = [{"name": r["key"], "ms_per_step": r["ms_per_step"],
                    "calls_per_step": r["calls_per_step"]} for r in htod]
    for label, subs in groups.items():
        # matched on the whole kernel name (a template's tail included)
        out[f"{label}_ms_per_step"] = sum(
            r["ms_per_step"] for r in by_kernel
            if any(s in r["key"] for s in subs))
    if after:
        out["after"] = extra
    return out


def print_profile(p: dict, card: str, groups) -> None:
    print(f"{p['model']} {'captured' if p['captured'] else 'eager'} step: "
          f"{p['wall_ms_per_step']:.2f} ms wall "
          f"({p['img_per_s']:.1f} img/s), host "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in
                      p["host_ms_per_step"].items())
          + f"; device busy {p['device_busy_ms_per_step']:.2f} ms, idle "
          f"share {p['device_idle_share']:.3f}; "
          + ", ".join(f"{g} {p[g + '_ms_per_step']:.3f} ms" for g in groups)
          + f"; {p['kernel_calls_per_step']:.0f} device ops a step"
          + f"; HtoD {p['htod_ms_per_step']:.3f} ms "
          + str(sorted({h["name"] for h in p["htod"]}))
          + f" on {card}", flush=True)


# -- the real-data input path and checkpoints --------------------------------

# the file-based AlexNet cell: one epoch is FILE_STEPS batch files, enough
# for a profile's warm-up, timed and profiled steps after one shuffle
FILE_STEPS = 2 + 2 * PROFILE_STEPS
FILE_WORKERS = 4                      # para_load_workers, the default
DATA_DIR = os.path.join("build", "smoke_imagenet")
CKPT_DIR = os.path.join("build", "smoke_ckpt")
RAW = 256
# the u8 wire against the float32 wire, first step's logits, full mean
# image: the u8 wire subtracts the mean's centre window where the float32
# pass subtracts the crop window's own (the JAX package's documented
# deviation); on this smooth mean the inputs differ by at most 0.4 levels
# against pixels of ~74 RMS (0.5%), and the logits (relative L2) must stay
# within U8_LOGITS_RTOL (0.0033 on the CPU at batch 8)
U8_LOGITS_RTOL = 0.02


_WEIGHTS = {}


def checksum(t):
    """A position-weighted sum of a batch's bits, in int64 (wrapping alike
    on the card and in NumPy): a tensor on the card gives a device scalar,
    an array a Python int.  Any changed, moved or missing byte changes it
    (but for a 2^-64 chance)."""
    n = t.numel() if isinstance(t, torch.Tensor) else t.size
    if isinstance(t, torch.Tensor):
        w = _WEIGHTS.get((n, t.device))
        if w is None:
            w = _WEIGHTS[(n, t.device)] = (
                torch.arange(n, device=t.device, dtype=torch.int64) % 65521
                + 1)
        v = t.reshape(-1)
        v = v.view(torch.int32) if v.dtype == torch.float32 else v
        return (v.to(torch.int64) * w).sum()
    w = np.arange(n, dtype=np.int64) % 65521 + 1
    v = np.ascontiguousarray(t).reshape(-1)
    v = v.view(np.int32) if v.dtype == np.float32 else v
    return int((v.astype(np.int64) * w).sum())


def host_stream(wire_u8: bool, epochs, n_val: int = 1) -> list:
    """Checksums of what a bare ``ImageNet_data`` over the same files and
    seed yields, epoch by epoch as the worker draws it: the train batches
    after ``shuffle_data(epoch + seed)``, then the validation batches."""
    from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
    data = ImageNet_data({"data_dir": DATA_DIR, "seed": 0,
                          "aug_wire_u8": wire_u8}, BATCH, crop=227)
    out = []
    for epoch in range(max(epochs) + 1):
        data.shuffle_data(epoch)
        sums = [checksum(data.next_train_batch(i)["x"])
                for i in range(data.n_batch_train)]
        sums += [checksum(data.next_val_batch(0)["x"]) for _ in range(n_val)]
        if epoch in epochs:
            out += sums
    return out


class ClaimRecorder:
    """Records, on the card, the checksum of every batch a step takes
    (``steps.claim``: after the compute stream has waited on the staging
    copy), without reading anything back until :meth:`values`."""

    def __init__(self):
        from theanompi_tpu_torch.parallel import steps
        self.steps, self.sums, self.orig = steps, [], steps.claim

    def __enter__(self):
        def hooked(batch, device):
            out = self.orig(batch, device)
            self.sums.append(checksum(out["x"]))
            return out
        self.steps.claim = hooked
        return self

    def __exit__(self, *exc):
        self.steps.claim = self.orig

    def values(self) -> list:
        return [int(v) for v in self.sums]


def check_stream(name, got: list, want: list) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} staged batches, the host "
                             f"stream has {len(want)}")
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if bad:
        raise AssertionError(f"{name}: staged batches {bad} differ from the "
                             f"host stream")


def native_loader_phase() -> dict:
    """Builds ``native/loader.cc`` with g++ (a failed build raises) and,
    on one AlexNet batch (128 bc01 uint8 images at 256², a CHW mean made
    HWC), holds the native pass against the NumPy path bit for bit, with a
    shared crop window (its window of the full mean) and with per-image
    windows (the mean's centre window); host ms of each path, the native
    pass at several thread counts."""
    from theanompi_tpu_torch import native
    t0 = time.time()
    so = native.build()
    build_s = time.time() - t0
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (BATCH, 3, RAW, RAW), np.uint8)
    mean = np.ascontiguousarray(smooth_mean_chw().transpose(1, 2, 0))
    c = 227
    out = {"library": so, "build_s": build_s, "default_threads":
           native.DEFAULT_THREADS, "para_load_threads":
           max(1, native.DEFAULT_THREADS // FILE_WORKERS), "draws": {}}
    for kind in ("shared", "per_image"):
        m = 1 if kind == "shared" else BATCH
        oy = rng.integers(0, RAW - c + 1, m).astype(np.int32)
        ox = rng.integers(0, RAW - c + 1, m).astype(np.int32)
        flip = rng.integers(0, 2, m).astype(np.uint8)
        if kind == "shared":
            mw = mean[oy[0]:oy[0] + c, ox[0]:ox[0] + c]
        else:
            cy = (RAW - c) // 2
            mw = mean[cy:cy + c, cy:cy + c]
        mw = np.ascontiguousarray(mw)
        bc = lambda a: np.broadcast_to(a, (BATCH,))
        t0 = time.perf_counter()
        plain = native.augment_numpy(x, bc(oy), bc(ox), bc(flip), c, mw, 0.0)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = native.augment_batch(x, oy, ox, flip, c, mean=mw)
        if not np.array_equal(got.view(np.int32), plain.view(np.int32)):
            raise AssertionError(f"native loader ({kind} draws) differs from "
                                 f"the NumPy path")
        times = {}
        for th in sorted({1, 2, 4, native.DEFAULT_THREADS}):
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                native.augment_batch(x, oy, ox, flip, c, mean=mw,
                                     n_threads=th)
                ts.append((time.perf_counter() - t0) * 1e3)
            times[th] = float(np.median(ts))
        out["draws"][kind] = {"numpy_ms": plain_ms, "native_ms": times}
    return out


def file_cfg(wire_u8: bool, **kw) -> dict:
    return dict(dict(batch_size=BATCH, data_dir=DATA_DIR, para_load=True,
                     para_load_workers=FILE_WORKERS, aug_wire_u8=wire_u8,
                     printFreq=FILE_STEPS // 2), **kw)


def alexnet_files_phase(wire_u8: bool, ckpt_dir=None):
    """AlexNet at batch 128 from the batch files under ``para_load``: one
    epoch of FILE_STEPS steps and a validation batch (a checkpoint at its
    end when ``ckpt_dir``), launches counted; every batch a step took holds
    the host stream's bits."""
    want = expect(lrn_fwd_cuda=2 * (FILE_STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * FILE_STEPS)
    with ClaimRecorder() as claims:
        model, out = run_main_path(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", want,
            **file_cfg(wire_u8, **({"ckpt_dir": ckpt_dir} if ckpt_dir
                                   else {})))
    check_stream(f"AlexNet files (u8 wire {wire_u8})", claims.values(),
                 host_stream(wire_u8, [0]))
    out["batches_checked"] = len(claims.sums)
    if model.data.__class__.__name__ != "PrefetchLoader":
        raise AssertionError("para_load did not wrap the data object")
    saved = None
    if ckpt_dir:
        saved = {"params": tree_map(lambda t: t.detach().cpu().clone(),
                                    model.params),
                 "opt_state": tree_map(lambda t: t.cpu().clone(),
                                       model.opt_state),
                 "cursor": model.data.get_cursor()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, saved


def u8_logits_phase() -> dict:
    """The first step's batch through both wires, AlexNet in eval mode
    (bf16, as trained): with a scalar mean the u8 wire's staged input and
    logits are bit-equal to the float32 wire's; with the full mean image
    the staged input differs by exactly the mean's window deviation (to 2
    float32 ulps at 256) and the logits by at most U8_LOGITS_RTOL
    (relative L2)."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
    scalar_dir = os.path.join("build", "smoke_imagenet_scalar")
    write_batch_files(scalar_dir, 1, 1, BATCH, mean=False)
    model = AlexNet({"batch_size": 2, "synthetic_batches": 1,
                     "synthetic_val_batches": 1, "seed": 0})
    out = {}
    for name, d in (("scalar", scalar_dir), ("image", DATA_DIR)):
        xs = {}
        for u8 in (False, True):
            data = ImageNet_data({"data_dir": d, "seed": 0,
                                  "aug_wire_u8": u8}, BATCH, crop=227)
            data.shuffle_data(0)
            xs[u8] = torch.from_numpy(data.next_train_batch(1)["x"]).cuda()
        model.data = data               # the u8 wire's mean comes from it
        model.__dict__.pop("_u8_mean", None)
        with torch.no_grad():
            staged = model.stage_input(xs[True])
            lf = model.apply_model(model.params, xs[False], train=False,
                                   gen=None, state=model.bn_state).float()
            lu = model.apply_model(model.params, staged, train=False,
                                   gen=None, state=model.bn_state).float()
        rel = float((lu - lf).norm() / lf.norm())
        if name == "scalar":
            check_bits("u8 wire staged input, scalar mean", staged, xs[False])
            check_bits("u8 wire logits, scalar mean", lu, lf)
        else:
            mi = data.img_mean
            cy, c = (RAW - 227) // 2, 227
            # the first step's window: a fresh object's first draw
            oy, ox, _ = ImageNet_data({"data_dir": d, "seed": 0}, BATCH,
                                      crop=c)._draw(BATCH, RAW, RAW, True)
            dev = torch.from_numpy(np.ascontiguousarray(
                mi[oy[0]:oy[0] + c, ox[0]:ox[0] + c]
                - mi[cy:cy + c, cy:cy + c])).cuda()
            err = float((staged - xs[False] - dev).abs().max())
            if err > 2 * 2.0 ** -15:
                raise AssertionError(f"u8 wire input deviates {err:.3e} from "
                                     f"the mean's window deviation")
            if not rel <= U8_LOGITS_RTOL:
                raise AssertionError(f"u8 wire logits rel L2 {rel:.3e}")
            out["input_dev_max"] = float(dev.abs().max())
        out[f"{name}_logits_rel_l2"] = rel
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resume_phase(saved: dict) -> dict:
    """A fresh session restores the checkpoint the f32 files phase wrote:
    params, momentum and the loader's cursor equal the saved ones bit for
    bit, and the first batch it draws for epoch 1 is the host stream's;
    then ``BSP().init(..., resume=True)`` trains epoch 1 (launches counted,
    every batch checked against the host stream, costs finite)."""
    from theanompi_tpu_torch.worker import BSP_Worker
    cfg = dict(file_cfg(False), n_workers=1, seed=0, verbose=False)
    worker = BSP_Worker(cfg)
    try:
        model = worker.build_model("theanompi_tpu_torch.models.alex_net",
                                   "AlexNet")
        model.compile_iter_fns(worker.exchanger)
        if model.load(CKPT_DIR) != 0:
            raise AssertionError("no checkpoint of epoch 0 restored")
        for part in ("params", "opt_state"):
            for a, b in zip(tree_leaves(getattr(model, part)),
                            tree_leaves(saved[part])):
                check_bits(f"restored {part}", a.detach().cpu(), b)
        cur = model.data.get_cursor()
        for k, v in saved["cursor"].items():
            if not np.array_equal(np.asarray(cur[k]), np.asarray(v)):
                raise AssertionError(f"restored cursor {k}: {cur[k]} != {v}")
        with ClaimRecorder() as claims:
            model.data.shuffle_data(1 + model.seed)
            model._take(model.data.next_train_batch(1))
        first = claims.values()
        model.data.close()
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    want_epoch1 = host_stream(False, [1])
    check_stream("first batch after resume", first, want_epoch1[:1])
    want = expect(lrn_fwd_cuda=2 * (FILE_STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * FILE_STEPS)
    with ClaimRecorder() as claims:
        model, out = run_main_path(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", want,
            **file_cfg(False, epochs=2, resume=True, ckpt_dir=CKPT_DIR))
    check_stream("resumed epoch 1", claims.values(), want_epoch1)
    out["batches_checked"] = len(claims.sums)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the one-program step: captured ≡ eager, windows ----------------------------

GRAPH_STEPS = 8
SPC = 4                               # steps_per_call of the window phases
VGG_MODEL = ("theanompi_tpu_torch.models.vggnet_16", "VGGNet_16")
# each full-width main path: model file, class, config
GRAPH_PATHS = {
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet",
                dict(batch_size=BATCH, synthetic_batches=GRAPH_STEPS)),
    **{f"vgg16_{w}": VGG_MODEL + (dict(
        exch_strategy=w, batch_size=VGG_BATCH, learning_rate=VGG_LR,
        synthetic_batches=GRAPH_STEPS),) for w in ("onebit", "topk",
                                                   "powersgd")},
    "lm": ("theanompi_tpu_torch.models.transformer_lm", "TransformerLM",
           dict(LM_CFG, batch_size=LM_BATCH,
                synthetic_train=LM_BATCH * GRAPH_STEPS,
                synthetic_val=LM_BATCH)),
    **{name: (f"theanompi_tpu_torch.models.{name}", cls, dict(
        batch_size=ZOO_BATCH, synthetic_batches=GRAPH_STEPS,
        learning_rate=ZOO_LR[cls]))
       for name, cls in (("googlenet", "GoogLeNet"),
                         ("resnet50", "ResNet50"))},
    # the async rules' paths: BASELINE.json configs 3 (VGG-16 'D' under
    # EASGD) and 4 (ResNet-50 under GoSGD), and AlexNet under ASGD
    "vgg16_easgd": VGG_MODEL + (dict(
        rule="easgd", alpha=0.5, sync_freq=4, batch_size=VGG_BATCH,
        learning_rate=VGG_LR, synthetic_batches=GRAPH_STEPS),),
    "resnet50_gosgd": ("theanompi_tpu_torch.models.resnet50", "ResNet50",
                       dict(rule="gosgd", exch_prob=0.25, gosgd_peers="perm",
                            batch_size=ZOO_BATCH,
                            learning_rate=ZOO_LR["ResNet50"],
                            synthetic_batches=GRAPH_STEPS)),
    "alexnet_asgd": ("theanompi_tpu_torch.models.alex_net", "AlexNet",
                     dict(rule="asgd", sync_freq=1, batch_size=BATCH,
                          synthetic_batches=GRAPH_STEPS)),
}


def host_state(model) -> list:
    """Copies on the host of the whole state a step carries: params,
    optimizer state, BN state and the wire's or the rule's state."""
    return [t.detach().cpu().clone() for t in
            tree_leaves(model.params) + tree_leaves(model.opt_state)
            + tree_leaves(model.bn_state) + tree_leaves(model.extra)]


def drive(path: str, capture: bool, calls: int, spc: int = 1, probe=None,
          **over) -> dict:
    """``calls`` calls of a main path's train step from a fresh model, made
    through the worker as a session makes it (``build_model``,
    ``compile_iter_fns``, the epoch's ``shuffle_data``, ``train_iter`` and
    the rule's ``exchange`` hook), launches counted from 0: each call's
    cost (device scalars, cloned), the whole state after (params,
    optimizer, BN and wire or rule state) on the host, and the launch
    counts.  ``over`` overrides the path's config; ``probe(model)`` runs
    after the compile (its result, a callable, runs again after the last
    call, and what that returns is kept as ``probe``)."""
    from theanompi_tpu_torch.worker import WORKERS
    modelfile, modelclass, cfg = GRAPH_PATHS[path]
    cfg = dict(cfg, **over)
    zero_launches()
    worker = WORKERS[cfg.pop("rule", "bsp")](dict(
        cfg, n_workers=1, seed=0, verbose=False, steps_per_call=spc))
    try:
        model = worker.build_model(modelfile, modelclass)
        model.compile_iter_fns(worker.exchanger, capture=capture)
        finish = probe(model) if probe is not None else None
        model.data.shuffle_data(model.seed)
        t0 = time.time()
        costs = []
        for i in range(calls):
            model.train_iter((i + 1) * spc)
            worker.exchanger.exchange(None, (i + 1) * spc)
            costs.append(model.current_info["cost"].clone())
        torch.cuda.synchronize()
        out = {"costs": costs, "secs": time.time() - t0,
               "probe": finish() if finish is not None else None,
               "graphed": model.train_fn.graphed, "launches": launch_counts(),
               "n_buckets": getattr(worker.exchanger, "n_buckets",
                                    lambda: None)(),
               "state": host_state(model)}
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def same_run(name: str, a: dict, b: dict, costs_a=None) -> int:
    """Two drives bit for bit: costs (``costs_a`` in place of ``a``'s),
    every state tensor (params, optimizer, BN, wire) and the launch
    counts.  Returns the tensors
    compared."""
    for i, (x, y) in enumerate(zip(costs_a or a["costs"], b["costs"])):
        check_bits(f"{name} cost {i}", x, y)
    if len(a["state"]) != len(b["state"]):
        raise AssertionError(f"{name}: {len(a['state'])} and "
                             f"{len(b['state'])} state tensors")
    for i, (x, y) in enumerate(zip(a["state"], b["state"])):
        check_bits(f"{name} state tensor {i}", x, y)
    if a["launches"] != b["launches"]:
        raise AssertionError(f"{name}: launches {a['launches']} and "
                             f"{b['launches']}")
    return len(a["state"])


# the captured GRAPH_STEPS-step drives of graph_eager_phase that the spc,
# re-capture and wire phases take as their reference (the same path,
# config and seed: the same run), kept instead of driven again; those of
# WIRE_REUSED until the wire phases
WIRE_REUSED = ("alexnet", "vgg16_onebit", "vgg16_topk", "vgg16_powersgd",
               "vgg16_easgd")
GRAPH_REUSED = WIRE_REUSED + ("lm", "resnet50", "resnet50_gosgd")
_GRAPH_RUNS = {}


def captured_run(path: str) -> dict:
    """The captured GRAPH_STEPS-step drive of ``path`` with its own
    config: graph_eager_phase's, where it kept one, else a new drive."""
    run = _GRAPH_RUNS.get(path)
    return run if run is not None else drive(path, True, GRAPH_STEPS)


def graph_eager_phase() -> dict:
    """Each full-width main path, GRAPH_STEPS steps eager and captured from
    the same seed (weights, batches, dropout streams), cuDNN deterministic
    in both: costs, params, optimizer state and wire state bit for bit, and
    the same kernel launches (the captured run's counted per replay).  The
    captured runs of GRAPH_REUSED are kept for the spc and re-capture
    phases."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for path in GRAPH_PATHS:
            eager = drive(path, False, GRAPH_STEPS)
            graph = drive(path, True, GRAPH_STEPS)
            if eager["graphed"] or not graph["graphed"]:
                raise AssertionError(f"{path}: graphed {eager['graphed']}, "
                                     f"{graph['graphed']}")
            n = same_run(f"{path} graph vs eager", eager, graph)
            if path in GRAPH_REUSED:
                _GRAPH_RUNS[path] = graph
            out[path] = {"tensors": n, "eager_s": eager["secs"],
                         "graph_s": graph["secs"],
                         "costs": [float(c) for c in graph["costs"]],
                         "launches": {k: v for k, v in
                                      graph["launches"].items() if v}}
            print(f"graph == eager, {path}: {GRAPH_STEPS} steps, {n} state "
                  f"tensors and the costs bit for bit, launches "
                  f"{out[path]['launches']}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def spc_phase() -> dict:
    """``steps_per_call = SPC`` captured (two calls over [SPC, ...]
    windows) against 2·SPC single captured steps, AlexNet, the LM and
    ResNet-50 (its running state updated and synced step by step inside
    the window): the same state bit for bit, each window's mean cost the
    single steps' mean taken the same way on the card, the same
    launches."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, path, over in (
                ("alexnet", "alexnet", {}), ("lm", "lm", {}),
                ("resnet50", "resnet50", {}),
                ("vgg16_easgd_f2", "vgg16_easgd", {"sync_freq": 2}),
                ("vgg16_easgd_f4", "vgg16_easgd", {"sync_freq": 4}),
                ("resnet50_gosgd", "resnet50_gosgd", {})):
            # sync_freq 4 is vgg16_easgd's own: graph_eager_phase's run
            own = all(GRAPH_PATHS[path][2].get(k) == v
                      for k, v in over.items())
            one = captured_run(path) if own else \
                drive(path, True, GRAPH_STEPS, **over)
            many = drive(path, True, GRAPH_STEPS // SPC, spc=SPC, **over)
            means = [torch.stack(one["costs"][i:i + SPC]).mean()
                     for i in range(0, GRAPH_STEPS, SPC)]
            n = same_run(f"{name} spc {SPC} vs single", one, many, means)
            out[name] = {"tensors": n, "single_s": one["secs"],
                         "spc_s": many["secs"]}
            fused = ", the exchange fused into the window" \
                if "rule" in GRAPH_PATHS[path][2] else ""
            print(f"spc {SPC} == {SPC} single steps, {name} (captured"
                  f"{fused}): {n} state tensors and the window costs bit "
                  f"for bit", flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


RESNET_CKPT = os.path.join("build", "smoke_ckpt_resnet")


def recapture_phase() -> dict:
    """ResNet-50 captured, cuDNN deterministic: GRAPH_STEPS/2 steps, a
    checkpoint, the BN running-state tensors replaced by new ones (as a
    load that cannot write in place makes them) and the checkpoint loaded
    into them, then the other GRAPH_STEPS/2 steps.  The step's state
    identity check sees the BN tensors, so it must capture a new graph;
    costs and state must end bit for bit where an uninterrupted captured
    run of GRAPH_STEPS steps ends (a replay of the old graph would have
    updated the old tensors and left the loaded ones behind)."""
    from theanompi_tpu_torch.worker import BSP_Worker
    modelfile, modelclass, cfg = GRAPH_PATHS["resnet50"]
    half = GRAPH_STEPS // 2
    torch.backends.cudnn.deterministic = True
    try:
        ref = captured_run("resnet50")
        shutil.rmtree(RESNET_CKPT, ignore_errors=True)
        zero_launches()
        worker = BSP_Worker(dict(cfg, n_workers=1, seed=0, verbose=False))
        try:
            model = worker.build_model(modelfile, modelclass)
            model.compile_iter_fns(worker.exchanger)
            model.data.shuffle_data(model.seed)
            costs = []
            for c in range(1, GRAPH_STEPS + 1):
                if c == half + 1:
                    model.save(RESNET_CKPT, 0, half)
                    first = model.train_fn._graph
                    model.bn_state = tree_map(torch.empty_like,
                                              model.bn_state)
                    if model.load(RESNET_CKPT) != 0 or \
                            model.train_fn._state_current():
                        raise AssertionError("the step did not see its BN "
                                             "tensors replaced")
                model.train_iter(c)
                costs.append(model.current_info["cost"].clone())
            if model.train_fn._graph is first or \
                    not model.train_fn.graphed:
                raise AssertionError("the step did not capture again after "
                                     "the load")
            torch.cuda.synchronize()
            got = {"costs": costs, "launches": launch_counts(),
                   "state": [t.detach().cpu().clone() for t in
                             tree_leaves(model.params)
                             + tree_leaves(model.opt_state)
                             + tree_leaves(model.bn_state)
                             + tree_leaves(model.extra)]}
            del model
        finally:
            worker.close()
            gc.collect()
            torch.cuda.empty_cache()
        n = same_run("resnet50 save, load, re-capture vs uninterrupted", ref,
                     got)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"ResNet-50 re-capture after a load into new BN tensors: {n} "
          f"state tensors and {GRAPH_STEPS} costs bit for bit the "
          f"uninterrupted run", flush=True)
    return {"tensors": n}


def host_windows(wire_u8: bool, k: int) -> list:
    """Checksums of a bare ``ImageNet_data``'s epoch 0 as ``[k, ...]``
    windows (the last ``n_batch_train % k`` batches dropped), then its
    validation batch."""
    from theanompi_tpu_torch.models.data.imagenet import ImageNet_data
    data = ImageNet_data({"data_dir": DATA_DIR, "seed": 0,
                          "aug_wire_u8": wire_u8}, BATCH, crop=227)
    data.shuffle_data(0)
    sums = [checksum(np.stack([data.next_train_batch(w * k + j + 1)["x"]
                               for j in range(k)]))
            for w in range(data.n_batch_train // k)]
    return sums + [checksum(data.next_val_batch(0)["x"])]


def capture_witness_phase() -> dict:
    """What the card does with each host effect the lint's capture-purity
    names, each captured alone in a ``parallel.graph.StepGraph`` on a side
    stream: a ``.item()`` (a read back: capture must refuse it, with
    ``CaptureError``), a host clock (captured, then frozen: every replay
    gives the capture's stamp), and a draw from a generator not handed to
    the graph (refused, or frozen: two replays draw the same values).
    Fails if the ``.item()`` capture does not raise, or if memory freed
    after the refusals stays reserved."""
    from theanompi_tpu_torch.parallel.graph import CaptureError, StepGraph
    x = torch.arange(1.0, 4097.0, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    out = {}

    def attempt(name, fn):
        g = StepGraph(side)
        t0 = time.time()
        try:
            with torch.cuda.stream(side):
                res = g.capture(fn)
        except CaptureError as e:
            out[name] = {"captured": False, "error": str(e)[:240],
                         "secs": time.time() - t0}
            torch.cuda.synchronize()
            return None, None
        out[name] = {"captured": True, "secs": time.time() - t0}
        return g, res

    # a sync to the host inside the capture
    attempt("item", lambda: x.sum().item())
    if out["item"]["captured"]:
        raise AssertionError("capture witness: .item() was captured; "
                             "StepGraph must refuse a read back")
    # a host clock: captured once, replayed with the capture's stamp
    g, res = attempt("host_clock", lambda: x * (time.time() % 1000.0))
    if g is not None:
        stamps = []
        for _ in range(2):
            time.sleep(0.01)
            with torch.cuda.stream(side):
                g.replay()
            side.synchronize()
            stamps.append(float(res[0]))
        out["host_clock"].update(frozen=stamps[0] == stamps[1],
                                 replay_stamps=stamps)
    # a draw from a generator the graph was not given
    gen = torch.Generator(device="cuda").manual_seed(5)
    g, res = attempt("unregistered_draw", lambda: torch.rand(
        8, generator=gen, device="cuda"))
    if g is not None:
        draws = []
        for _ in range(2):
            with torch.cuda.stream(side):
                g.replay()
            side.synchronize()
            draws.append(res.clone())
        out["unregistered_draw"]["frozen"] = bool(torch.equal(*draws))
    torch.cuda.synchronize()
    # the refused captures gave back what they took: 2 GiB freed after
    # them returns to the card (the allocator routes nothing into a dead
    # graph's pool)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    big = torch.empty(2 ** 31, dtype=torch.uint8, device="cuda")
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["reserved_kept_mib"] = (torch.cuda.memory_reserved() - base) / 2 ** 20
    if out["reserved_kept_mib"] > 256:
        raise AssertionError(f"capture witness: {out['reserved_kept_mib']:.0f}"
                             f" MiB stay reserved after the refused "
                             f"captures: a dead graph's pool holds them")
    return out


def window_files_phase(wire_u8: bool) -> dict:
    """AlexNet from the batch files under ``para_load`` at
    ``steps_per_call = SPC``: the producer stages whole windows, the
    captured step takes each; every window the step took holds the host
    stream's bits, and the LRN kernels ran once per step."""
    n = (FILE_STEPS // SPC) * SPC
    want = expect(lrn_fwd_cuda=2 * (n + VAL_BATCHES), lrn_bwd_cuda=2 * n)
    with ClaimRecorder() as claims:
        model, out = run_main_path(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", want,
            **file_cfg(wire_u8, steps_per_call=SPC))
    if model.data.window != SPC or not model.train_fn.graphed:
        raise AssertionError(f"window {model.data.window}, graphed "
                             f"{model.train_fn.graphed}")
    check_stream(f"AlexNet windows (u8 wire {wire_u8})", claims.values(),
                 host_windows(wire_u8, SPC))
    out["windows_checked"] = len(claims.sums)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the async islands around a center (A8b) ----------------------------------

ALEX_MODEL = ("theanompi_tpu_torch.models.alex_net", "AlexNet")
# every island shares the one card, with the main paths' seed; the
# synthetic set of 8 batches wraps; the islands' budget (run_seconds)
# covers the model's build and capture too: the straggler starts its 4th
# step (its first exchange) only if its start-up took under 24 − 3·3 s;
# at 20 s the fast island made 3 exchanges of its least 3 and the phase
# took no less time
ISLAND_CFG = dict(device="cuda:0", alpha=0.5, synthetic_batches=8, seed=0,
                  verbose=False)
ISLAND_SECONDS = 24
# the two island threads of one process share its start-up and exchange
# with the center in memory (~0.4 s each, 24 in 24 s on an H100): a
# shorter budget still gives the fast island its least exchanges
ISLAND_THREAD_SECONDS = 12
# the straggler sleeps this long after every step
STRAGGLER_S = 3.0
# VGG-16's islands train at a tenth of VGG_LR: at 0.001 islands from the
# model's own seed (42) reached costs in the hundreds within their first
# 4 local steps, before any exchange, and NaN within 12, where BSP from
# seed 0 descends over 40 steps; at 0.0001 they descend
# (``--vgg-island-lr`` runs that comparison)
VGG_ISLAND_LR = 0.0001
# the cross-process phases: (name, rule, model, config, least exchanges
# of the fast island); ASGD at sync_freq 2 (its exchange ships and takes
# back the whole model), VGG-16 under EASGD as BASELINE.json config 3
# names it (b32), whose 1.1 GB exchanges take seconds: a longer budget
ISLAND_PROCS = (
    ("alexnet_easgd", "EASGD", ALEX_MODEL,
     dict(easgd_mode="async", batch_size=BATCH, sync_freq=4), 3),
    ("alexnet_asgd", "ASGD", ALEX_MODEL,
     dict(asgd_mode="async", batch_size=BATCH, sync_freq=2), 3),
    ("vgg16_easgd", "EASGD", VGG_MODEL,
     dict(easgd_mode="async", batch_size=VGG_BATCH, sync_freq=4,
          learning_rate=VGG_ISLAND_LR, run_seconds=30), 2),
)


def compute_mode() -> str:
    """The card's compute mode; two processes on one card need
    ``Default``."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"compute mode: {mode}", flush=True)
    if "Exclusive" in mode or "Prohibited" in mode:
        raise AssertionError(
            f"the card's compute mode is {mode}: the island phases run "
            f"several processes on one card and need the Default mode")
    return mode


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_center(port: int) -> subprocess.Popen:
    """The port's center as a process of its own (``center_main``),
    started; :func:`wait_center` waits for it to accept connections."""
    return subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.parallel.center_server",
         "--port", str(port), "--alpha", str(ISLAND_CFG["alpha"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_center(p: subprocess.Popen, port: int) -> subprocess.Popen:
    """``p`` once the center accepts connections on ``port``."""
    import socket
    deadline = time.time() + 60
    while True:
        if p.poll() is not None:
            raise AssertionError(f"center exited {p.returncode}: "
                                 f"{p.communicate()[1][-2000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return p
        except OSError:
            if time.time() > deadline:
                p.kill()
                raise AssertionError("the center did not start in 60 s")
            time.sleep(0.1)


def stop_center(p: subprocess.Popen) -> str:
    p.terminate()
    try:
        return p.communicate(timeout=30)[1]
    except subprocess.TimeoutExpired:
        p.kill()
        return p.communicate()[1]


def island_main(arg: str) -> int:
    """``chip_smoke.py --island <json>``: one island process through the
    session API, ``<RULE>().init(devices=1, ...).wait()``; prints one line
    ``ISLAND <json>``: the trainer's stats, this process's launch counts,
    its params' devices and finiteness, and whether its step ran as a
    captured graph."""
    cfg = json.loads(arg)
    zero_launches()
    rule = getattr(tmpi, cfg.pop("rule"))()
    modelfile, modelclass = cfg.pop("model")
    rule.init(devices=1, modelfile=modelfile, modelclass=modelclass, **cfg)
    tr = rule.wait()
    torch.cuda.synchronize()
    m = tr.islands[0].model
    params = tree_leaves(m.params)
    print("ISLAND " + json.dumps({
        "stats": tr.stats(), "launches": launch_counts(),
        "devices": sorted({str(p.device) for p in params}),
        "finite": all(bool(torch.isfinite(p).all()) for p in params),
        "graphed": bool(m.train_fn.graphed)}), flush=True)
    return 0


_INIT_LEAVES = {}


def init_center_leaves(model) -> list:
    """The center's leaves at the islands' start: a model's initial params
    (its seed, on the CPU) in the center's layout; cached per model."""
    if model not in _INIT_LEAVES:
        import importlib
        from theanompi_tpu_torch import convert
        cls = getattr(importlib.import_module(model[0]), model[1])
        m = cls({"device": "cpu", "verbose": False, "synthetic_batches": 1,
                 "batch_size": 1})
        _INIT_LEAVES[model] = convert.center_leaves_from_params(
            m.params, frozenset(m.kept_layout_paths()))
        del m
    return _INIT_LEAVES[model]


def check_center(name, leaves, model) -> None:
    """The center is finite and has moved off the islands' start."""
    init = init_center_leaves(model)
    if len(leaves) != len(init) or not all(np.isfinite(x).all()
                                           for x in leaves):
        raise AssertionError(f"{name}: the center is not finite")
    if all(np.array_equal(a, b) for a, b in zip(leaves, init)):
        raise AssertionError(f"{name}: the center never moved")


def check_islands(name, islands, center_updates, by_island=None,
                  least: int = 3) -> dict:
    """The straggler (island 1) did not block island 0: island 0 made at
    least ``least`` exchanges and twice the straggler's steps; the center
    counted every island's exchanges."""
    fast, slow = islands[0], islands[1]
    if fast["exchanges"] < least or fast["steps"] < 2 * slow["steps"]:
        raise AssertionError(f"{name}: the straggler blocked the fast "
                             f"island: {fast} vs {slow}")
    total = sum(i["exchanges"] for i in islands)
    if center_updates != total or (by_island is not None and by_island != {
            str(i["island"]): i["exchanges"] for i in islands
            if i["exchanges"]}):
        raise AssertionError(f"{name}: the center counted {center_updates} "
                             f"updates ({by_island}), the islands {total}")
    return {"fast": fast, "slow": slow}


def check_island_state(name, devices, finite, graphed) -> None:
    """An island's params sit on the card, finite, and its step ran as a
    captured graph."""
    if devices != [ISLAND_CFG["device"]] or not finite or not graphed:
        raise AssertionError(f"{name}: params on {devices}, finite "
                             f"{finite}, captured {graphed}")


def island_lrn_check(name, launches, steps) -> None:
    """AlexNet's two LRNs: 2 B1 a forward and 2 B2 a backward, nothing
    else launched (no validation runs on an island)."""
    want = expect(lrn_fwd_cuda=2 * steps, lrn_bwd_cuda=2 * steps)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")


def island_procs_phase(name, rule, model, cfg, least: int = 3) -> dict:
    """Two island processes (``--island``), one card, around the port's
    center in a third (``center_main`` on a free port); island 1 is the
    straggler.  Checks every island's params (on the card, finite), its
    launches, the straggler not blocking, the center's count and its
    leaves (finite, moved).  The center process starts beside the
    islands' (an island's first call rides the wire's retries until it
    answers)."""
    port = free_port()
    center = start_center(port)
    addr = f"127.0.0.1:{port}"
    try:
        base = dict(ISLAND_CFG, run_seconds=ISLAND_SECONDS)
        base.update(cfg)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--island",
             json.dumps(dict(base, rule=rule, model=list(model),
                             async_islands=1, island_base=i,
                             center_addr=addr,
                             island_throttle=STRAGGLER_S if i else 0.0))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        wait_center(center, port)
        outs = []
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=base["run_seconds"] + 240)
            if p.returncode != 0:
                raise AssertionError(f"{name}: island {i} exited "
                                     f"{p.returncode}:\n{err[-4000:]}")
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("ISLAND ")][0][7:]))
        from theanompi_tpu_torch.parallel.center_server import RemoteCenter
        rc = RemoteCenter(addr, alpha=ISLAND_CFG["alpha"], client_id="smoke")
        st = rc.stats()
        leaves = rc.pull_leaves()
        rc.close()
    finally:
        log = stop_center(center)
    islands = [o["stats"]["islands"][0] for o in outs]
    for i, (o, isl) in enumerate(zip(outs, islands)):
        if not all(np.isfinite(isl.get("costs", [np.nan]))):
            raise AssertionError(f"{name}: island {i} costs {isl}")
        check_island_state(f"{name} island {i}", o["devices"], o["finite"],
                           o["graphed"])
        if model == ALEX_MODEL:
            island_lrn_check(f"{name} island {i}", o["launches"],
                             isl["steps"])
        elif o["launches"] != expect():
            raise AssertionError(f"{name}: launches {o['launches']}")
    check_center(name, leaves, model)
    del leaves
    out = check_islands(name, islands, st["n_updates"], st["by_island"],
                        least)
    out.update(launches=[o["launches"] for o in outs],
               center={k: st[k] for k in ("n_updates", "by_island",
                                          "apply_s", "queue_s", "n_ops")},
               center_log=log.strip().splitlines()[-2:])
    return out


def island_threads_phase() -> dict:
    """Two islands as threads of this process, on the one card, through
    ``EASGD().init(..., easgd_mode='async', async_islands=2, device=
    'cuda:0', center_serve=True)``; island 1 the straggler.  Launch counts
    set to 0 just before and read just after: the process's counts hold
    both islands' steps, 2 B1 and 2 B2 each."""
    torch.cuda.empty_cache()
    zero_launches()
    rule = tmpi.EASGD()
    rule.init(devices=1, modelfile=ALEX_MODEL[0], modelclass=ALEX_MODEL[1],
              **dict(ISLAND_CFG, easgd_mode="async", async_islands=2,
                     center_serve=True, batch_size=BATCH, sync_freq=4,
                     run_seconds=ISLAND_THREAD_SECONDS,
                     island_throttle={1: STRAGGLER_S}))
    tr = rule.wait()
    torch.cuda.synchronize()
    launches = launch_counts()
    st = tr.stats()
    for r in tr.islands:
        params = tree_leaves(r.model.params)
        check_island_state(f"island thread {r.island_id}",
                           sorted({str(p.device) for p in params}),
                           all(bool(torch.isfinite(p).all()) for p in params),
                           r.model.train_fn.graphed)
    island_lrn_check("island threads", launches,
                     sum(i["steps"] for i in st["islands"]))
    check_center("island threads", tr.center.pull_leaves(), ALEX_MODEL)
    out = check_islands("island threads", st["islands"], tr.center.n_updates)
    out["launches"] = launches
    del tr, rule
    gc.collect()
    torch.cuda.empty_cache()
    return out


def island_exchange_check_phase() -> dict:
    """One island exchange of full-width AlexNet on the card against its
    plain recomputation, with a center in memory seeded a random step away
    from the params: EASGD's params and center within ``EASGD_TOL`` of the
    update recomputed in float64 from the tensors before it; ASGD's center
    bit for bit ``a + (p − a)`` in float32, and the params bit for bit the
    center it returned."""
    from theanompi_tpu_torch import convert
    from theanompi_tpu_torch.parallel.async_easgd import (CenterLink,
                                                          ElasticCenter)
    cls = getattr(__import__(ALEX_MODEL[0], fromlist=["x"]), ALEX_MODEL[1])
    m = cls({"device": ISLAND_CFG["device"], "verbose": False,
             "synthetic_batches": 1, "batch_size": 1})
    kept = frozenset(m.kept_layout_paths())
    r = np.random.RandomState(5)
    shift = [r.standard_normal(x.shape).astype(np.float32) * 1e-2
             for x in convert.center_leaves_from_params(m.params, kept)]
    out = {}
    for rule in ("easgd", "asgd"):
        params0 = convert.center_leaves_from_params(m.params, kept)
        center = ElasticCenter([p + s for p, s in zip(params0, shift)],
                               alpha=ISLAND_CFG["alpha"])
        link = CenterLink(m, center, 0)
        c0 = center.pull_leaves()
        if rule == "easgd":
            rec = link.easgd()
            c1 = center.pull_leaves()
            p1 = convert.center_leaves_from_params(m.params, kept)
            a = center.alpha
            for i, (P, C, p, c) in enumerate(zip(params0, c0, p1, c1)):
                P, C = P.astype(np.float64), C.astype(np.float64)
                d = P - C
                check_close(f"island easgd params leaf {i}",
                            torch.from_numpy(p), torch.from_numpy(P - a * d),
                            *EASGD_TOL)
                check_close(f"island easgd center leaf {i}",
                            torch.from_numpy(c), torch.from_numpy(C + a * d),
                            *EASGD_TOL)
        else:
            link.anchor()
            rec = link.asgd()
            c1 = center.pull_leaves()
            p1 = convert.center_leaves_from_params(m.params, kept)
            for i, (P, A, p, c) in enumerate(zip(params0, c0, p1, c1)):
                check_bits(f"island asgd center leaf {i}",
                           torch.from_numpy(c), torch.from_numpy(A + (P - A)))
                check_bits(f"island asgd params == center leaf {i}",
                           torch.from_numpy(p), torch.from_numpy(c))
        out[rule] = {k: 1e3 * v for k, v in rec.items()}
    out["n_params"] = int(link.n)
    del m, link
    gc.collect()
    torch.cuda.empty_cache()
    return out


def print_islands(name, r, card, batch) -> None:
    for role in ("fast", "slow"):
        i = r[role]
        ex = i.get("exchange_ms", {})
        print(f"islands {name} {role} island {i['island']}: {i['steps']} "
              f"steps, {i['exchanges']} exchanges, step "
              f"{i.get('step_ms', float('nan')):.2f} ms ("
              f"{1e3 * batch / i.get('step_ms', float('nan')):.1f} img/s "
              f"between exchanges), overall {i['steps_per_s']:.2f} steps/s "
              f"= {i['steps_per_s'] * batch:.1f} img/s; exchange "
              + ", ".join(f"{k} {v:.1f}" for k, v in ex.items())
              + f" ms, {i.get('bytes_per_exchange', 0) / 1e6:.1f} MB; "
              f"costs {[round(c, 4) for c in i.get('costs', [])][:6]} "
              f"on {card}", flush=True)


def vgg_island_lr() -> dict:
    """``--vgg-island-lr``: why VGG-16's islands train at VGG_ISLAND_LR.
    40 BSP steps of VGG-16 b32 at VGG_LR from seed 0 (their costs, every
    4 steps), then the VGG-16 island phase from the model's own seed (42)
    at VGG_LR and at VGG_ISLAND_LR: each island's costs at its exchanges,
    or the phase's error (reported, not raised)."""
    r = tmpi.BSP()
    r.init(devices=1, modelfile=VGG_MODEL[0], modelclass=VGG_MODEL[1],
           batch_size=VGG_BATCH, learning_rate=VGG_LR, synthetic_batches=8,
           epochs=5, synthetic_val_batches=1, printFreq=4, seed=0,
           verbose=False)
    out = {"bsp_costs": [x["cost"] for x in r.wait().train_records]}
    del r
    gc.collect()
    torch.cuda.empty_cache()
    name, rule, model, cfg, least = ISLAND_PROCS[-1]
    for lr in (VGG_LR, VGG_ISLAND_LR):
        try:
            res = island_procs_phase(name, rule, model,
                                     dict(cfg, learning_rate=lr, seed=42),
                                     least)
            out[str(lr)] = {k: res[k].get("costs") for k in ("fast", "slow")}
        except AssertionError as e:
            out[str(lr)] = {"error": str(e)[:2000]}
        print(f"VGG-16 islands at lr {lr}: {out[str(lr)]}", flush=True)
    return out


def lint_gate(proc) -> dict:
    """The result of the port's lint gate run as ``proc`` (``python -m
    theanompi_tpu_torch.tools.lint --check-baseline --no-cache --format
    json``): its findings, baselined entries and stale entries, and the
    process's own CPU seconds (from its rusage) and wall seconds.  Raises
    unless it exits 0."""
    out = proc.stdout.read()
    _, status, ru = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    if proc.returncode != 0:
        raise AssertionError(f"lint gate exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    rep = json.loads(out)
    from theanompi_tpu_torch.analysis.checkers import CHECK_GROUPS
    secs = rep.get("cpu_seconds", {})
    group_of = {c: g for g, cs in CHECK_GROUPS.items() for c in cs}
    by_group = {"parse+index": secs.get("parse", 0.0) +
                secs.get("index", 0.0)}
    for name, v in secs.items():
        if name not in ("parse", "index"):
            g = group_of.get(name, "other")
            by_group[g] = by_group.get(g, 0.0) + v
    return {"findings": len(rep["findings"]), "baselined": rep["baselined"],
            "stale": len(rep["stale_baseline"]),
            "checks": len(secs) - 2, "cpu_by_group": by_group,
            "cpu_s": ru.ru_utime + ru.ru_stime}


def islands_main(card: str) -> dict:
    """Every island phase: the exchange against its plain recomputation,
    the threads, then each cross-process phase; prints their numbers.
    Beside them, on the host, the port's lint gate (``lint_gate``), which
    holds every kernel of this checkout to its plain version, its CPU test
    and its row here."""
    compute_mode()
    gate = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.tools.lint",
         "--check-baseline", "--no-cache", "--format", "json"], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        res = islands_phases(card)
        res["lint_gate"] = g = lint_gate(gate)
    finally:
        if gate.returncode is None and gate.poll() is None:
            gate.kill()
            gate.communicate()
    print(f"lint gate on the host (python -m theanompi_tpu_torch.tools.lint "
          f"--check-baseline --no-cache): PASS, {g['checks']} checks, "
          f"{g['findings']} findings, {g['baselined']} baselined, "
          f"{g['stale']} stale, {g['cpu_s']:.1f} s CPU (by group: "
          + ", ".join(f"{k} {v:.1f}" for k, v in g["cpu_by_group"].items())
          + ")", flush=True)
    return res


def islands_phases(card: str) -> dict:
    """The island phases of :func:`islands_main`."""
    t0 = time.time()
    res = {"exchange_check": island_exchange_check_phase()}
    res["exchange_check"]["secs"] = time.time() - t0
    print("island exchange vs plain (AlexNet, %d params, center in memory): "
          % res["exchange_check"]["n_params"] + "; ".join(
              f"{k} " + ", ".join(f"{p} {v:.1f}" for p, v in t.items())
              + " ms" for k, t in res["exchange_check"].items()
              if k not in ("n_params", "secs")), flush=True)
    t0 = time.time()
    res["alexnet_threads"] = island_threads_phase()
    res["alexnet_threads"]["secs"] = time.time() - t0
    print_islands("alexnet_threads (EASGD, center_serve)",
                  res["alexnet_threads"], card, BATCH)
    for name, rule, model, cfg, least in ISLAND_PROCS:
        t0 = time.time()
        res[name] = island_procs_phase(name, rule, model, cfg, least)
        res[name]["secs"] = time.time() - t0
        print_islands(name + " (processes)", res[name], card,
                      cfg["batch_size"])
        print(f"islands {name}: center {res[name]['center']}, phase "
              f"{res[name]['secs']:.1f}s", flush=True)
    return res

# -- the launcher (A6): one process per GPU ------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH_DIR = os.path.join(HERE, "build", "smoke_launch")
# the launched AlexNet: full width, b128, bf16, captured, synthetic, the
# main path's steps and validation batches
LAUNCH_CFG = dict(batch_size=BATCH, synthetic_batches=STEPS,
                  synthetic_val_batches=VAL_BATCHES, epochs=1, seed=0,
                  printFreq=STEPS // 2)
# the supervised phase's epochs: long enough that a SIGKILL landing right
# after epoch 0's checkpoint finds epoch 1 still running
SUPERVISE_STEPS = 16
# the killed supervised run's compile cache, emptied at the phase's start
SMOKE_CC = os.path.join(HERE, "build", "smoke_cc")


class SmokeAlexNet(AlexNet):
    """Full-width AlexNet as a launched rank's model (``--modelfile
    chip_smoke --modelclass SmokeAlexNet``) and in this process beside it:
    cuDNN deterministic and TF32 off (the comparisons are bit for bit),
    every launch count set to 0 as it is built.  After its first step it
    prints ``SMOKE_STEP1 <wall clock>`` (the step synchronized); at each
    ``end_val`` one line ``SMOKE <json>``: its launch counts, device,
    process group backend and rendezvous, and the host wall ms a step from
    the third step to the epoch's last (ending in a synchronize); with
    ``smoke_out`` it writes its params there (``.npz``)."""

    def __init__(self, config=None):
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        zero_launches()
        super().__init__(config)
        self._t_steps = []
        self._stepped = False
        self.step_ms = float("nan")

    def train_iter(self, count, recorder=None):
        super().train_iter(count, recorder)
        if not self._stepped:
            torch.cuda.synchronize()
            print(f"SMOKE_STEP1 {time.time()!r}", flush=True)
            self._stepped = True
        self._t_steps.append(time.perf_counter())

    def begin_val(self):
        torch.cuda.synchronize()
        t = self._t_steps
        if len(t) > 2:
            self.step_ms = 1e3 * (time.perf_counter() - t[1]) / (len(t) - 2)
        self._t_steps = []
        super().begin_val()

    def end_val(self):
        import torch.distributed as dist
        super().end_val()
        out = self.config.get("smoke_out")
        if out:
            params = self.host_params()
            np.savez(out, **{"/".join(p): x for p, x in
                             zip(leaf_paths(params), tree_leaves(params))})
        print("SMOKE " + json.dumps({
            "launches": launch_counts(), "device": str(self.device),
            "backend": dist.get_backend(),
            "init_method": str(self.config.get("init_method")),
            "step_ms": self.step_ms}), flush=True)


def launcher_cmd(*args, **cfg) -> list:
    return ([sys.executable, "-m", "theanompi_tpu_torch.launcher", "--rule",
             "bsp", "--modelfile", "chip_smoke", "--modelclass",
             "SmokeAlexNet", *args] + [f"{k}={v}" for k, v in cfg.items()])


def smoke_lines(out: str) -> list:
    return [json.loads(ln[6:]) for ln in out.splitlines()
            if ln.startswith("SMOKE ")]


def first_steps(out: str) -> list:
    return [float(ln.split()[1]) for ln in out.splitlines()
            if ln.startswith("SMOKE_STEP1 ")]


def check_npz_bits(name, a_path, b_path) -> int:
    """Every array of two ``.npz`` files bit for bit; returns how many."""
    with np.load(a_path) as a, np.load(b_path) as b:
        if sorted(a.files) != sorted(b.files) or not a.files:
            raise AssertionError(f"{name}: arrays {sorted(a.files)} vs "
                                 f"{sorted(b.files)}")
        for k in a.files:
            if a[k].dtype != b[k].dtype or not np.array_equal(
                    a[k].view(np.uint8), b[k].view(np.uint8)):
                raise AssertionError(f"{name}: {k} differs")
        return len(a.files)


def launcher_world1_phase() -> dict:
    """``python -m theanompi_tpu_torch.launcher --n-workers 1`` trains
    SmokeAlexNet for the main path's steps and validation batch; its one
    rank joins a world-1 NCCL group over the launcher's TCP rendezvous,
    binds cuda:0 and launches 2 B1 a forward and 2 B2 a backward.  The
    same config through ``BSP().init(devices=1, ...)`` in this process
    must end with the same params bit for bit."""
    os.makedirs(LAUNCH_DIR, exist_ok=True)
    child_npz = os.path.join(LAUNCH_DIR, "child_params.npz")
    here_npz = os.path.join(LAUNCH_DIR, "session_params.npz")
    t0 = time.time()
    r = subprocess.run(launcher_cmd("--n-workers", "1", **LAUNCH_CFG,
                                    smoke_out=child_npz),
                       cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"launcher world 1 exited {r.returncode}:\n"
                             f"{(r.stdout + r.stderr)[-4000:]}")
    rep, step1 = smoke_lines(r.stdout), first_steps(r.stdout)
    if len(rep) != 1 or len(step1) != 1:
        raise AssertionError(f"launcher world 1 reported {rep}, {step1}")
    rep = rep[0]
    want = expect(lrn_fwd_cuda=2 * (STEPS + VAL_BATCHES),
                  lrn_bwd_cuda=2 * STEPS)
    if rep["launches"] != want:
        raise AssertionError(f"launched AlexNet launches {rep['launches']}, "
                             f"expected {want}")
    if rep["backend"] != "nccl" or rep["device"] != "cuda:0" or \
            not rep["init_method"].startswith("tcp://127.0.0.1:"):
        raise AssertionError(f"launched rank: {rep}")
    torch.cuda.empty_cache()
    rule = tmpi.BSP()
    rule.init(devices=1, modelfile=__name__, modelclass="SmokeAlexNet",
              **LAUNCH_CFG, smoke_out=here_npz)
    rec = rule.wait()
    launches = launch_counts()
    if launches != want:
        raise AssertionError(f"session AlexNet launches {launches}")
    if not all(np.isfinite(x["cost"]) for x in rec.train_records):
        raise AssertionError(f"session costs {rec.train_records}")
    n = check_npz_bits("launched vs session params", child_npz, here_npz)
    out = {"launch_to_first_step_s": step1[0] - t0,
           "child_step_ms": rep["step_ms"],
           "session_step_ms": rule.model.step_ms,
           "launches": rep["launches"], "leaves_bit_equal": n,
           "backend": rep["backend"], "device": rep["device"]}
    del rule, rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def children(pid: int) -> list:
    """Pids of ``pid``'s child processes, from /proc."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            if ppid == pid:
                out.append(int(d))
    return out


def read_latest(ckpt: str):
    try:
        with open(os.path.join(ckpt, "LATEST")) as f:
            return f.read().strip()
    except OSError:
        return None


def launcher_supervise_phase() -> dict:
    """``--supervise 2 --backoff 0.1``, 2 epochs of SUPERVISE_STEPS with a
    checkpoint each: a run left alone and, beside it on the card at the
    same time, one whose worker (the launcher's child, not the launcher)
    is SIGKILLed once ``LATEST`` reads 0.  The unkilled run never
    restarts and ends at ``LATEST`` 1; the killed run exits 0 after
    restarting in the backoff and resuming from epoch 0, ends at
    ``LATEST`` 1, and its final checkpoint equals the other's array for
    array, bit for bit (cuDNN deterministic: sharing the card changes no
    bit).  The killed run takes ``--compile-cache`` (SMOKE_CC, emptied
    first): its first worker's ``compile cache`` start-up line names
    ``lrn`` a miss with nvcc's seconds, the restarted worker's a hit, and
    each prints its start-up by part.  Returns the seconds from the
    SIGKILL to the resumed process's first step (synchronized): the time
    to recover, with the unkilled run sharing the card and the host."""
    import signal
    cfg = dict(LAUNCH_CFG, synthetic_batches=SUPERVISE_STEPS, epochs=2,
               printFreq=SUPERVISE_STEPS)
    dirs = {k: os.path.join(LAUNCH_DIR, k) for k in ("whole", "killed")}
    for d in list(dirs.values()) + [SMOKE_CC]:
        shutil.rmtree(d, ignore_errors=True)
    args = ("--n-workers", "1", "--supervise", "2", "--backoff", "0.1")
    whole_path = os.path.join(LAUNCH_DIR, "whole.log")
    log_path = os.path.join(LAUNCH_DIR, "killed.log")
    with open(whole_path, "w") as whole_log, open(log_path, "w") as log:
        whole = subprocess.Popen(
            launcher_cmd(*args, **cfg, ckpt_dir=dirs["whole"]), cwd=HERE,
            stdout=whole_log, stderr=subprocess.STDOUT, text=True)
        sup = subprocess.Popen(
            launcher_cmd(*args, "--compile-cache", SMOKE_CC, **cfg,
                         ckpt_dir=dirs["killed"]), cwd=HERE,
            stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.time() + 300
            while read_latest(dirs["killed"]) != "0":
                if sup.poll() is not None or time.time() > deadline:
                    raise AssertionError("no epoch 0 checkpoint before the "
                                         "kill")
                time.sleep(0.01)
            worker = children(sup.pid)
            if len(worker) != 1:
                raise AssertionError(f"launcher children {worker}")
            t_kill = time.time()
            os.kill(worker[0], signal.SIGKILL)
            rc = sup.wait(timeout=600)
            rc_whole = whole.wait(timeout=600)
        finally:
            for p in (sup, whole):
                if p.poll() is None:
                    p.terminate()       # the launcher stops its ranks
                    try:
                        p.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
    with open(whole_path) as f:
        whole_out = f.read()
    if rc_whole != 0 or "restarting in" in whole_out or \
            read_latest(dirs["whole"]) != "1":
        raise AssertionError(f"unkilled supervised run exited "
                             f"{rc_whole}:\n{whole_out[-4000:]}")
    with open(log_path) as f:
        out = f.read()
    if rc != 0 or "restarting in" not in out or \
            "resumed from epoch 0" not in out or \
            read_latest(dirs["killed"]) != "1":
        raise AssertionError(f"killed supervised run exited {rc}:\n"
                             f"{out[-4000:]}")
    step1 = first_steps(out)
    if len(step1) != 2 or step1[1] < t_kill:
        raise AssertionError(f"first steps {step1}, kill at {t_kill}")
    n = check_npz_bits("killed vs whole final checkpoint",
                       os.path.join(dirs["killed"], "ckpt_epoch1.npz"),
                       os.path.join(dirs["whole"], "ckpt_epoch1.npz"))
    return {"recover_s": step1[1] - t_kill, "arrays_bit_equal": n,
            "restart_line": [ln for ln in out.splitlines()
                             if "restarting in" in ln][0],
            **compile_cache_lines(out)}


def compile_cache_lines(out: str) -> dict:
    """The killed supervised run's two workers' start-up lines: ``lrn`` a
    miss (nvcc's seconds) in the first, a hit in the restarted one, each
    with the start-up by part."""
    cache = [ln for ln in out.splitlines() if ln.startswith("compile cache [")]
    parts = [ln for ln in out.splitlines() if ln.startswith("start-up (")]
    if len(cache) != 2 or len(parts) != 2 or \
            "kernels: miss" not in cache[0] or \
            "{'lrn': 'miss'}" not in cache[0] or \
            "kernels: hit" not in cache[1] or \
            "{'lrn': 'hit'}" not in cache[1]:
        raise AssertionError(f"compile cache lines {cache}, start-up "
                             f"lines {parts}")

    def secs(line):
        return float(line.split("kernels: ")[1].split("(")[1].split("s)")[0])

    def points(line):
        return {k: None if v == "-" else float(v) for k, v in
                (p.rsplit(" ", 1) for p in
                 line.split(": ", 1)[1].split(", "))}

    with open(os.path.join(SMOKE_CC, "manifest.json")) as f:
        (entry,) = json.load(f).values()
    return {"cache_lines": cache, "startup_lines": parts,
            "lrn_miss_s": secs(cache[0]), "lrn_hit_s": secs(cache[1]),
            "nvcc_s": entry["build_secs"], "manifest": entry,
            "startup_miss": points(parts[0]),
            "startup_hit": points(parts[1])}


def launcher_refusal_phase() -> dict:
    """One rank more than the visible GPUs: the launcher exits nonzero
    before spawning anything, naming the count."""
    n = torch.cuda.device_count()
    t0 = time.time()
    r = subprocess.run(launcher_cmd("--n-workers", str(n + 1), **LAUNCH_CFG),
                       cwd=HERE, capture_output=True, text=True, timeout=120)
    named = f"{n} visible GPU{'' if n == 1 else 's'}"
    if r.returncode == 0 or named not in r.stderr or "SMOKE" in r.stdout:
        raise AssertionError(f"--n-workers {n + 1} on {n} GPUs exited "
                             f"{r.returncode}:\n{r.stdout + r.stderr}")
    return {"rc": r.returncode, "secs": time.time() - t0,
            "message": r.stderr.strip().splitlines()[-1]}


def launcher_main(card: str) -> dict:
    """The launcher phases: world 1 over NCCL through the launcher against
    the in-process session, the supervised SIGKILL, the refusal (a launcher
    of its own, run beside the others); prints their numbers.  World 1's
    launch shares the host with the refusal's launcher, and the killed
    supervised run the card with the unkilled one, so their seconds are
    taken under that contention."""
    gc.collect()
    torch.cuda.empty_cache()         # the launched rank shares the card
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refusal = pool.submit(launcher_refusal_phase)
        t_sup = time.time()
        supervise = pool.submit(launcher_supervise_phase)
        t0 = time.time()
        res = {"world1": launcher_world1_phase()}
        w = res["world1"]
        w["secs"] = time.time() - t0
        print(f"launcher world 1 (NCCL over the launcher's TCP rendezvous, "
              f"{w['device']}): AlexNet b{BATCH} {STEPS} steps, launch to "
              f"first step {w['launch_to_first_step_s']:.1f} s (beside the "
              f"refusal's launcher), step {w['child_step_ms']:.2f} ms "
              f"(in-process session {w['session_step_ms']:.2f} ms), launches "
              f"{ {k: v for k, v in w['launches'].items() if v} }, "
              f"{w['leaves_bit_equal']} param leaves bit-equal to the "
              f"session on {card}", flush=True)
        res["supervise"] = s = supervise.result()
        s["secs"] = time.time() - t_sup
        print(f"launcher --supervise: SIGKILL after epoch 0's checkpoint, "
              f"'{s['restart_line']}', first resumed step "
              f"{s['recover_s']:.1f} s after the kill (beside the unkilled "
              f"supervised run and the world-1 phase on the card), final "
              f"checkpoint bit-equal to the unkilled run "
              f"({s['arrays_bit_equal']} arrays) on {card}", flush=True)
        print(f"launcher --supervise --compile-cache: first worker "
              f"{s['cache_lines'][0]!r}; restarted worker "
              f"{s['cache_lines'][1]!r}; nvcc {s['nvcc_s']:.2f} s for lrn "
              f"(manifest); start-up by part, s from process start, miss "
              f"{s['startup_miss']}, hit {s['startup_hit']}; the phase "
              f"{s['secs']:.1f} s on {card}", flush=True)
        res["refusal"] = f = refusal.result()
    print(f"launcher refused --n-workers {torch.cuda.device_count() + 1} "
          f"in {f['secs']:.1f} s (rc {f['rc']}): {f['message']}", flush=True)
    return res



# -- the elastic islands (A10 items 3 and 4a) ----------------------------------

ELASTIC_DIR = os.path.join(HERE, "build", "smoke_elastic")
# each island's step goal (~1 step/s with its exchanges on an H100): island
# 2 outlives both faults and its alert, and the respawned island 1 makes
# several exchanges after its rejoin
ELASTIC_STEPS = 24
# the corrupt fault's scale, added to island 2's first params leaf (the
# JAX package's flatten order: conv1's bias, 96 values), so its ‖p − c‖
# jumps by about ELASTIC_SCALE·√96 ≈ 49 at its next exchange
ELASTIC_SCALE = 5.0
# the fleet series every island streams (step times, steps, the beacon,
# the wire's round trip, the card's headroom)
ELASTIC_SERIES = ("steps", "step_p99", "divergence", "wire_rtt_p50",
                  "hbm_headroom_bytes")
# the faults, progress-gated: seconds after the first lease with a step;
# island 2 exchanges (healthy) before the corruption, which it applies at
# its next round (≤ ~4.3 s) and which is alerted within a streamer
# interval and an evaluation after it
ELASTIC_FAULTS = f"kill@2:1,corrupt@6:2:{ELASTIC_SCALE:g}"
# replica_divergence's threshold on ‖p − c‖: above the healthy drift of
# AlexNet's islands at sync_freq 4, under the corruption's jump
ELASTIC_DIVERGENCE = 20.0
# a respawn on the card takes ~15 s (a process, the model's build and its
# capture): the heartbeat rule must not demote the respawned island
ELASTIC_HEARTBEAT_S = 60.0
ELASTIC_CFG = dict(device="cuda:0", batch_size=BATCH, synthetic_batches=8,
                   seed=0, alpha=0.5, sync_freq=4, numerics=True,
                   numerics_every=4, tracing=True, fleetmon=True,
                   fleetmon_divergence=ELASTIC_DIVERGENCE,
                   fleetmon_heartbeat_s=ELASTIC_HEARTBEAT_S,
                   fleetmon_eval_s=0.5, metrics_interval_s=0.5,
                   telemetry_flush_every=4, center_snapshot_every_s=10.0,
                   verbose=False)


class ElasticAlexNet(AlexNet):
    """Full-width AlexNet as an elastic island's model (``run_elastic``
    with modelfile ``chip_smoke``): every launch count set to 0 as it is
    built; as its process exits it writes
    ``<smoke_out>/island<id>_pid<pid>.json``: its launch counts, its steps,
    the params' devices and finiteness, whether its step ran captured, its
    last cost, the wall clock of its first step, and the float64 sum of
    |params| as built (the seed's) and at its first step (after the
    island's ``center_restore``)."""

    def __init__(self, config=None):
        zero_launches()
        super().__init__(config)
        self._steps = 0
        self._abs = [self._abs_sum(), None]
        self._t_step1 = None
        atexit.register(self._report)

    def _abs_sum(self) -> float:
        with torch.no_grad():
            return float(sum(p.double().abs().sum()
                             for p in tree_leaves(self.params)))

    def train_iter(self, count, recorder=None):
        if self._abs[1] is None:
            self._abs[1] = self._abs_sum()
            self._t_step1 = time.time()
        super().train_iter(count, recorder)
        self._steps += 1

    def _report(self) -> None:
        torch.cuda.synchronize()
        params = tree_leaves(self.params)
        cost = self.current_info.get("cost")
        doc = {"island": int(self.config.get("island", -1)),
               "pid": os.getpid(), "steps": self._steps,
               "launches": launch_counts(),
               "devices": sorted({str(p.device) for p in params}),
               "finite": all(bool(torch.isfinite(p).all()) for p in params),
               "graphed": bool(self.train_fn.graphed),
               "cost": None if cost is None else float(cost),
               "t_step1": self._t_step1, "abs_init": self._abs[0],
               "abs_step1": self._abs[1]}
        with open(os.path.join(self.config["smoke_out"],
                               f"island{doc['island']}_pid{os.getpid()}"
                               f".json"), "w") as f:
            json.dump(doc, f)


@contextlib.contextmanager
def fds_to(path: str):
    """This process's stdout and stderr, and those of every process it
    starts meanwhile, into ``path``."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        for fd in saved:
            os.close(fd)


def run_events(record_dir: str) -> list:
    """Every telemetry event of a run, each process's stream merged."""
    import glob
    events = []
    for path in sorted(glob.glob(os.path.join(record_dir,
                                              "telemetry_rank*.jsonl"))):
        with open(path) as f:
            events += [json.loads(ln) for ln in f if ln.strip()]
    return events


def first_ts(events, **match):
    hits = [e["ts"] for e in events
            if all(e.get(k) == v for k, v in match.items())]
    if not hits:
        raise AssertionError(f"elastic: no event {match}")
    return min(hits)


def elastic_phase(model=("chip_smoke", "ElasticAlexNet"),
                  cfg=ELASTIC_CFG, steps: int = ELASTIC_STEPS) -> dict:
    """One elastic EASGD run on the card (``run_elastic``): 2 islands of
    full-width AlexNet b128 (bf16, captured, the numerics plane on, traced)
    in processes of their own around a supervised center process, the
    fleet monitor on, under a progress-gated chaos schedule: island 1
    SIGKILLed, then island 2's params corrupted in place.  Checks: exit 0
    and both faults landed; island 1's leave and its rejoin, restored from
    the center; in each island process that exited (the respawned one
    included) params on cuda:0, finite, a finite cost, a captured step and
    B1/B2 twice a step; the corrupted island's ``replica_divergence``
    alert, none before the corruption, and ``audit_alerts`` ok; the
    exposition of the collector restored from its last snapshot holding
    each island's streamed series, a positive ``hbm_headroom_bytes`` from
    the card among them; a finite ``center_final.npz``.  Returns the times to
    recover and the islands' steps a second around the faults."""
    from theanompi_tpu_torch.parallel import membership as mb
    from theanompi_tpu_torch.simfleet import fidelity
    from theanompi_tpu_torch.utils import chaos, fleetmon
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    rec = os.path.join(ELASTIC_DIR, "rec")
    out_dir = os.path.join(ELASTIC_DIR, "islands")
    os.makedirs(out_dir)
    os.makedirs(rec)
    # the schedule as the port's FleetSim realizes it at the live width (2
    # islands, one center shard, the fleet monitor on, no gossip mesh),
    # exported and replayed: the live run must reproduce the simulated
    # membership sequence
    t_sim = time.process_time()
    fleet, realized_path = fidelity.simulate(
        os.path.join(ELASTIC_DIR, "sim"), n_workers=2,
        schedule=ELASTIC_FAULTS, steps=steps, sync_freq=cfg["sync_freq"],
        fleetmon=True, min_at=0.0)
    sim_cpu_s = time.process_time() - t_sim
    sim_seq = fidelity.sim_membership_sequence(fleet)
    schedule = chaos.schedule_from_realized(realized_path)
    planned = chaos.parse_schedule(ELASTIC_FAULTS)
    if [(f.kind, f.at, f.target, f.duration) for f in schedule] != \
            [(f.kind, f.at, f.target, f.duration) for f in planned]:
        raise AssertionError(f"elastic: the simulated fleet realized "
                             f"{fleet.realized}, not {planned}")
    log = os.path.join(ELASTIC_DIR, "elastic.log")
    roster, stop = {"frames": 0, "live": None}, threading.Event()
    watcher = threading.Thread(target=fleetz_watch, args=(rec, roster, stop),
                               daemon=True)
    t0 = time.time()
    watcher.start()
    try:
        with fds_to(log):
            rc = mb.run_elastic(
                "easgd", *model, dict(cfg, smoke_out=out_dir), 2,
                record_dir=rec, steps=steps, chaos_schedule=schedule,
                center_proc=True, timeout_s=600,
                supervisor_kw=dict(poll_s=0.2, backoff=mb.Backoff(base=0.3),
                                   lease_timeout=60.0))
    finally:
        stop.set()
        watcher.join(timeout=30)
    run_s = time.time() - t0
    with open(log) as f:
        tail = f.read()[-6000:]
    if rc != 0 or any(f.error is not None or not f.applied
                      for f in schedule):
        raise AssertionError(f"elastic run exited {rc}, faults "
                             f"{[(f, f.error) for f in schedule]}:\n{tail}")
    live_seq = fidelity.live_membership_sequence(rec)
    if live_seq != sim_seq:
        raise AssertionError(f"elastic: the live membership sequence "
                             f"{live_seq} is not the simulated {sim_seq}")
    ev = run_events(rec)
    t_kill = first_ts(ev, ev="fault_injected", kind="kill", worker=1)
    t_corrupt = first_ts(ev, ev="fault_injected", kind="corrupt", worker=2)
    leaves = [e for e in ev if e["ev"] == "worker_leave" and
              e.get("worker") == 1 and e["ts"] >= t_kill and
              e.get("reason") in ("crashed", "wedged", "lease_expired")]
    if not leaves:
        raise AssertionError(f"elastic: island 1 never left after the kill")
    t_leave = leaves[0]["ts"]
    t_rejoin = first_ts(ev, ev="worker_join", worker=1, rejoin=True)
    if t_rejoin < t_leave:
        raise AssertionError("elastic: island 1 rejoined before it left")
    finished = {e["worker"] for e in ev if e["ev"] == "worker_leave"
                and e.get("reason") == "finished"}
    joins2 = [e for e in ev if e["ev"] == "worker_join"
              and e.get("worker") == 2]
    if finished != {1, 2} or len(joins2) != 1:
        raise AssertionError(f"elastic: finished {finished}, island 2 "
                             f"joined {len(joins2)} times")
    # each island process that exited: its own report
    reps = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        reps.setdefault(r["island"], []).append(r)
    if sorted(reps) != [1, 2] or len(reps[1]) != 1 or len(reps[2]) != 1:
        raise AssertionError(f"elastic: island reports {sorted(reps)}: "
                             f"{reps}")
    for w, (r,) in reps.items():
        name = f"elastic island {w} (pid {r['pid']})"
        check_island_state(name, r["devices"], r["finite"], r["graphed"])
        if r["cost"] is None or not np.isfinite(r["cost"]) or \
                r["steps"] < steps:
            raise AssertionError(f"{name}: {r['steps']} steps, cost "
                                 f"{r['cost']}")
        island_lrn_check(name, r["launches"], r["steps"])
    respawn = reps[1][0]
    if respawn["t_step1"] < t_rejoin or \
            respawn["abs_step1"] == respawn["abs_init"]:
        raise AssertionError(f"elastic: the respawned island 1 did not "
                             f"start from the center: {respawn}")
    # its first exchange: the first round span it ended as exchanged
    rounds = sorted((e["t0"] + e["dt"], e["rank"]) for e in ev
                    if e["ev"] == "span" and e.get("name") == "round"
                    and e.get("outcome") == "exchanged")
    t_exch1 = min(t for t, r in rounds if r == 1 and t > t_rejoin)
    # the corruption: applied by island 2 at its next exchange round, and
    # caught by replica_divergence on island 2, never before it
    t_applied = first_ts(ev, ev="corrupt_applied", island=2)
    alerts = [e for e in ev if e["ev"] == fleetmon.ALERT_EVENT]
    div = [a for a in alerts if a["rule"] == "replica_divergence"]
    early = [a for a in div if a["ts"] < t_corrupt]
    if early:
        raise AssertionError(f"elastic: replica_divergence before the "
                             f"corruption: {early}")
    t_alert = first_ts(div, worker=2)
    # the beacon's period: island 2's exchange round, plus one streamer
    # interval; the audit's budget for the symptom
    ends2 = sorted(t for t, r in rounds if r == 2)
    period = float(np.median(np.diff(ends2))) if len(ends2) > 1 else 0.0
    interval = 2.0 * period + cfg["metrics_interval_s"]
    with open(os.path.join(rec, chaos.REALIZED_SCHEDULE)) as f:
        realized = [json.loads(ln) for ln in f if ln.strip()]
    rules = fleetmon.default_rules(heartbeat_s=cfg["fleetmon_heartbeat_s"],
                                   divergence=cfg["fleetmon_divergence"])
    ok, lines = fleetmon.audit_alerts(alerts, realized, rules,
                                      cfg["fleetmon_eval_s"], interval)
    if not ok or not any("corrupt on w2 -> replica_divergence" in ln
                         for ln in lines):
        raise AssertionError("elastic: alert audit failed:\n"
                             + "\n".join(lines))
    # the exposition as it stood while the islands streamed: the
    # collector restored from its last snapshot, their clean departures
    # (``retired``) taken back; a line of each series an island streams,
    # for both islands, and the card's headroom
    with open(os.path.join(rec, "fleetmon_snap", "fleetmon_state.json")) as f:
        snap = json.load(f)["collector"]
    collector = fleetmon.FleetCollector()
    collector.restore(dict(snap, retired=[]))
    expo = collector.expose_text().splitlines()
    missing = [(n, w) for n in ELASTIC_SERIES for w in (1, 2)
               if not any(ln.startswith(f'theanompi_{n}{{rank="{w}",')
                          for ln in expo)]
    hbm = [float(ln.split()[-1]) for ln in expo
           if ln.startswith("theanompi_hbm_headroom_bytes{")]
    if missing or min(hbm, default=0.0) <= 0:
        raise AssertionError(f"elastic exposition: no line of {missing}, "
                             f"hbm_headroom_bytes {hbm}")
    # the beacon's values: the healthy drift before the corruption, and
    # the jump after it (the collector's rings)
    rings = snap["series"]
    beacon = {w: {"healthy_max": max([v for t, v in rings[str(w)].get(
                      "divergence", []) if t < t_corrupt] or [float("nan")]),
                  "after_max": max([v for t, v in rings[str(w)].get(
                      "divergence", []) if t >= t_corrupt] or [float("nan")])}
              for w in (1, 2)}
    with np.load(os.path.join(rec, "center_final.npz")) as z:
        n_leaves = len(z.files)
        if not n_leaves or not all(np.isfinite(z[k]).all()
                                   for k in z.files):
            raise AssertionError("elastic: center_final.npz not finite")
    with open(os.path.join(rec, "center_stats.json")) as f:
        cstats = json.load(f)
    if roster["live"] is None:
        raise AssertionError(f"fleetz: no frame of {roster['frames']} held "
                             f"the live roster (both islands, the center, "
                             f"the supervisor, none DOWN): "
                             f"{roster.get('last')}")
    report = elastic_report(rec)
    # the islands' steps a second around the faults, from their phase
    # events: before the kill (from the first step), and after: island 2
    # from its alert to its end, the respawned island 1 from its first
    # step to its end
    steps = {w: sorted(e["ts"] for e in ev if e["ev"] == "phase"
                       and e.get("sec") == "train" and e["rank"] == w)
             for w in (1, 2)}
    t_first = min(ts[0] for ts in steps.values())

    def rate(w, a, b):
        n = sum(a <= t <= b for t in steps[w])
        return n / (b - a) if b > a else float("nan")
    end = {w: first_ts(ev, ev="train_end", rank=w) for w in (1, 2)}
    rates = {"before_kill": {w: rate(w, t_first, t_kill) for w in (1, 2)},
             "island2_after_alert": rate(2, t_alert, end[2]),
             "island1_respawned": rate(1, respawn["t_step1"], end[1])}
    return {"run_s": run_s, "sim_seq": sim_seq, "live_seq": live_seq,
            "sim_cpu_s": sim_cpu_s, "sim_sha256": fleet.log.sha256(),
            "sim_events": fleet.summary["events"],
            "kill_to_leave_s": t_leave - t_kill,
            "leave_to_rejoin_s": t_rejoin - t_leave,
            "rejoin_to_first_step_s": respawn["t_step1"] - t_rejoin,
            "rejoin_to_first_exchange_s": t_exch1 - t_rejoin,
            "corrupt_to_applied_s": t_applied - t_corrupt,
            "corrupt_to_alert_s": t_alert - t_corrupt,
            "round_s": period, "audit": lines, "divergence": beacon,
            "alerts": [(a["rule"], a["worker"], a["value"]) for a in alerts],
            "steps_per_s": rates,
            "islands": {w: {k: r[0][k] for k in ("pid", "steps", "cost",
                                                 "launches")}
                        for w, r in reps.items()},
            "hbm_headroom_bytes": min(hbm), "center_leaves": n_leaves,
            "fleetz": {"frames": roster["frames"],
                       "live_at_s": roster["live"]["ts"] - t0,
                       "rows": [{k: r.get(k) for k in ("role", "id", "pid",
                                                       "iter", "steps")}
                                for r in roster["live"]["rows"]]},
            "report": report,
            "center": {k: cstats.get(k) for k in ("n_updates", "by_island",
                                                  "center_downs")}}


def fleetz_watch(rec: str, roster: dict, stop: threading.Event) -> None:
    """``tools.fleetz``'s frame (``--json --iterations 1``) taken every
    0.25 s while the elastic run lives, until one holds the live roster:
    both islands, the center and the supervisor, none DOWN (exit 0)."""
    from theanompi_tpu_torch.tools import fleetz
    while not stop.is_set():
        rc, rows = fleetz.frame(rec)
        roster["frames"] += 1
        roles = [(r.get("role"), r.get("id")) for r in rows]
        roster["last"] = (rc, roles)
        if rc == 0 and {("worker", 1), ("worker", 2)} <= set(roles) and \
                {"center", "supervisor"} <= {role for role, _ in roles}:
            roster["live"] = {"rows": rows, "ts": time.time()}
            return
        stop.wait(0.25)


def elastic_report(rec: str) -> dict:
    """``tools.telemetry_report <rec> --json --trace`` over the elastic
    run's record dir: every stream read (the supervisor's rank 0, the
    center's rank -1, both islands), island 1's leave and rejoin among the
    membership transitions, traced exchange rounds, a straggler ranking
    of both islands, spans in the Perfetto trace."""
    from theanompi_tpu_torch.tools import telemetry_report
    rep_path = os.path.join(ELASTIC_DIR, "report.json")
    trace_path = os.path.join(ELASTIC_DIR, "report_trace.json")
    text = run_tool(telemetry_report.main,
                    [rec, "--json", rep_path, "--trace", trace_path])
    with open(os.path.join(ELASTIC_DIR, "report.txt"), "w") as f:
        f.write(text)
    with open(rep_path) as f:
        rep = json.load(f)
    with open(trace_path) as f:
        spans = sum(1 for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X")
    members = [(e["ev"], e.get("worker")) for e in rep["membership_events"]]
    ranked = sorted(r["rank"] for r in rep["straggler_ranking"])
    if not ({-1, 0, 1, 2} <= set(rep["ranks"])
            and ("worker_leave", 1) in members
            and ("worker_join", 1) in members
            and rep["traces"].get("rounds", 0) > 0
            and {1, 2} <= set(ranked) and spans > 0):
        raise AssertionError(f"telemetry_report over {rec}: ranks "
                             f"{rep['ranks']}, membership {members}, "
                             f"rounds {rep['traces'].get('rounds')}, "
                             f"ranking {ranked}, {spans} spans")
    return {"ranks": rep["ranks"], "events": rep["events"],
            "rounds": rep["traces"]["rounds"], "straggler_ranking":
                rep["straggler_ranking"], "trace_spans": spans}


def simfleet_gate(proc) -> dict:
    """The result of ``python -m theanompi_tpu_torch.tools.simfleet_run
    --gate`` run as ``proc``: its CPU seconds, the determinism pair's
    digest and the 512-worker run's event-log digest."""
    out = proc.communicate(timeout=600)[0]
    m = re.search(r"simfleet gate: PASS \(([0-9.]+)s CPU of ([0-9.]+)s",
                  out)
    if proc.returncode != 0 or m is None:
        raise AssertionError(f"simfleet gate exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    return {"cpu_s": float(m.group(1)), "budget_s": float(m.group(2)),
            "pair": re.search(r"identical log \(([0-9a-f]+)", out).group(1),
            "sha256": re.search(r"event-log sha256: ([0-9a-f]+)",
                                out).group(1)}


def elastic_main(card: str) -> dict:
    """The elastic group (``--elastic``): the simfleet gate on the host
    beside one ``run_elastic`` run whose schedule the port's FleetSim
    realized; prints their numbers."""
    compute_mode()
    gc.collect()
    torch.cuda.empty_cache()          # the islands share the card
    t0 = time.time()
    # the width rehearsal (128-worker determinism, the 512-worker
    # invariant suite) in a process of its own, beside the islands
    gate = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.tools.simfleet_run",
         "--gate"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        r = elastic_phase()
        r["simfleet_gate"] = simfleet_gate(gate)
    finally:
        if gate.poll() is None:
            gate.kill()
            gate.communicate()
    r["secs"] = time.time() - t0
    g = r["simfleet_gate"]
    print(f"elastic cross-check: live membership {r['live_seq']} == the "
          f"port's FleetSim's {r['sim_seq']} (sim {r['sim_cpu_s']:.3f} s "
          f"CPU, {r['sim_events']} events, log sha256 "
          f"{r['sim_sha256'][:16]}); simfleet gate on the host: PASS in "
          f"{g['cpu_s']:.1f} s CPU of {g['budget_s']:.0f} s (pair "
          f"{g['pair']}, 512-worker log sha256 {g['sha256']})", flush=True)
    s = r["steps_per_s"]
    print(f"elastic EASGD (2 AlexNet b{BATCH} islands, center process, "
          f"fleet monitor, faults {ELASTIC_FAULTS}): kill -> leave "
          f"{r['kill_to_leave_s']:.2f} s, leave -> rejoin "
          f"{r['leave_to_rejoin_s']:.2f} s, rejoin -> first step "
          f"{r['rejoin_to_first_step_s']:.1f} s, -> first exchange "
          f"{r['rejoin_to_first_exchange_s']:.1f} s; corrupt -> applied "
          f"{r['corrupt_to_applied_s']:.2f} s, -> replica_divergence "
          f"{r['corrupt_to_alert_s']:.2f} s (round {r['round_s']:.2f} s; "
          f"‖p − c‖ before / after the corruption " + ", ".join(
              f"island {w} {d['healthy_max']:.3f} / {d['after_max']:.3f}"
              for w, d in r["divergence"].items()) + "); "
          f"steps/s before the kill {s['before_kill'][1]:.2f} / "
          f"{s['before_kill'][2]:.2f}, island 2 after its alert "
          f"{s['island2_after_alert']:.2f}, respawned island 1 "
          f"{s['island1_respawned']:.2f}; launches "
          f"{ {w: {k: v for k, v in i['launches'].items() if v} for w, i in r['islands'].items()} }; "
          f"hbm headroom {r['hbm_headroom_bytes'] / 2**30:.1f} GiB; alerts "
          f"{r['alerts']}; center {r['center']}; group {r['secs']:.1f} s "
          f"on {card}", flush=True)
    fz, rp = r["fleetz"], r["report"]
    print(f"elastic, the port's tools: a fleetz frame held the live roster "
          f"{[(x['role'], x['id']) for x in fz['rows']]} at "
          f"{fz['live_at_s']:.1f} s ({fz['frames']} frames); "
          f"telemetry_report over the record dir: ranks {rp['ranks']}, "
          f"{rp['events']} events, {rp['rounds']} traced rounds, "
          f"{rp['trace_spans']} spans, straggler ranking "
          f"{[(x['rank'], x['windows_straggled']) for x in rp['straggler_ranking']]}",
          flush=True)
    for ln in r["audit"]:
        print(ln, flush=True)
    return r


# -- the exchange wire's remaining forms (A7): params mode, Ring, buckets ----

WIRE_BUCKET = 4 << 20
# n_buckets at WIRE_BUCKET by the JAX package's plan, computed on the CPU
# (tests/test_torch_buckets.py::test_card_counts_at_4_mib holds them
# against theanompi_tpu.parallel.buckets)
WIRE_N_BUCKETS = {"alexnet": 8, "vgg16_onebit": 132, "vgg16_topk": 2,
                  "vgg16_powersgd": 1, "vgg16_easgd": 19}
WIRE_GROUPS = {
    # NCCL's kernels, if it launches any at world 1
    "wire": ("nccl", "AllGather", "AllReduce"),
    "b4": ("unpack_wsum_kernel",), "b8": ("topk_decode_kernel",),
    # the flatten, the packing of the buckets and the gathered words
    "copies": ("direct_copy_kernel", "CatArrayBatchedCopy", "Memcpy DtoD")}


def same_state(name: str, a: dict, b: dict) -> int:
    """Two drives' costs and whole state bit for bit (not their launches:
    a bucketed wire launches its decode once a bucket)."""
    return same_run(name, a, dict(b, launches=a["launches"]))


def wire_alexnet_phase() -> dict:
    """AlexNet b128, GRAPH_STEPS captured steps, cuDNN deterministic, each
    run from the same seed against another, bit for bit: params mode
    against grads mode (one replica's mean is itself), ``ring`` against
    ``allreduce`` (world 1: the ring is the identity), allreduce and
    nccl16 at WIRE_BUCKET against their monolithic wires, and params mode
    captured (its exchange a CUDA graph of its own) against eager; 2 B1
    and 2 B2 a step in every run."""
    steps = GRAPH_STEPS
    lrn = expect(lrn_fwd_cuda=2 * steps, lrn_bwd_cuda=2 * steps)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        runs = {"grads": captured_run("alexnet"),
                "nccl16": drive("alexnet", True, steps,
                                exch_strategy="nccl16")}
        for name, over, against, capture in (
                ("params", {"exch_mode": "params"}, "grads", True),
                ("ring", {"exch_strategy": "ring"}, "grads", True),
                ("allreduce_4mib", {"bucket_bytes": WIRE_BUCKET}, "grads",
                 True),
                ("nccl16_4mib", {"exch_strategy": "nccl16",
                                 "bucket_bytes": WIRE_BUCKET}, "nccl16",
                 True),
                ("params_eager", {"exch_mode": "params"}, "params", False)):
            runs[name] = r = drive("alexnet", capture, steps, **over)
            n = same_run(f"AlexNet {name} vs {against}", runs[against], r)
            out[name] = {"against": against, "tensors": n,
                         "graphed": r["graphed"], "n_buckets": r["n_buckets"]}
            print(f"wire: AlexNet b{BATCH} {name} == {against}, {steps} "
                  f"steps ({'captured' if capture else 'eager'}), {n} state "
                  f"tensors and the costs bit for bit", flush=True)
        for name, r in runs.items():
            if r["launches"] != lrn:
                raise AssertionError(f"AlexNet {name}: launches "
                                     f"{r['launches']}, want {lrn}")
        if out["allreduce_4mib"]["n_buckets"] != WIRE_N_BUCKETS["alexnet"]:
            raise AssertionError(f"AlexNet n_buckets "
                                 f"{out['allreduce_4mib']['n_buckets']}")
    finally:
        torch.backends.cudnn.deterministic = False
    out["launches"] = {k: v for k, v in lrn.items() if v}
    return out


def wire_vgg_phase() -> dict:
    """VGG-16 b32 under onebit, topk and powersgd, and under EASGD (config
    3), GRAPH_STEPS captured steps monolithic and at WIRE_BUCKET, cuDNN
    deterministic: costs, params, momentum and the strategy's or the
    center's state bit for bit; n_buckets the JAX package's plan; B4 and
    B8 launched n_buckets times a step, every other kernel as often as on
    the monolithic wire."""
    steps = GRAPH_STEPS
    per_step = {"vgg16_onebit": {"pack_signs_encode_cuda": 1,
                                 "signed_residual_cuda": 1,
                                 "unpack_signs_wsum_cuda": "n"},
                "vgg16_topk": {"topk_encode_cuda": 1,
                               "topk_decode_cuda": "n"},
                "vgg16_powersgd": {"matmul_pack_group_cuda": 2},
                "vgg16_easgd": {}}
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for path, want in per_step.items():
            mono = captured_run(path)
            buck = drive(path, True, steps, bucket_bytes=WIRE_BUCKET)
            n = same_state(f"{path} 4 MiB vs monolithic", mono, buck)
            nb = buck["n_buckets"]
            if nb != WIRE_N_BUCKETS[path]:
                raise AssertionError(f"{path}: n_buckets {nb}, the JAX plan "
                                     f"{WIRE_N_BUCKETS[path]}")
            for r, k in ((mono, 1), (buck, nb)):
                exp = expect(**{name: steps * (k if c == "n" else c)
                                for name, c in want.items()})
                if r["launches"] != exp:
                    raise AssertionError(f"{path} (n_buckets {k}): launches "
                                         f"{r['launches']}, want {exp}")
            out[path] = {"tensors": n, "n_buckets": nb,
                         "launches": {k: v for k, v in
                                      buck["launches"].items() if v},
                         "launches_monolithic": {
                             k: v for k, v in mono["launches"].items() if v}}
            print(f"wire: {path} b{VGG_BATCH} at {WIRE_BUCKET >> 20} MiB == "
                  f"monolithic, {steps} captured steps, {n} state tensors "
                  f"and the costs bit for bit; n_buckets {nb} (the JAX "
                  f"plan); launches {out[path]['launches']} (monolithic "
                  f"{out[path]['launches_monolithic']})", flush=True)
            del mono, buck
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def wire_decode_phase() -> dict:
    """B4 and B8 at the bucketed wires' shapes, each bucket decoded into its
    slice of one mean (``out=``), as VGG-16's 4 MiB buckets hand them: B4 a
    [1, 256, 128] bucket of words (the last one shorter), bit for bit
    against its plain version, and one bucket of 4 workers' words within
    ``decode_tol``, timed beside it; B8 a bucket of 12,787 rows [1, 12787, 82]
    and the last of 4,103, against the plain decode on the CPU (see
    ``topk_phase``); times a bucket each beside its plain version and its
    bound."""
    n_true, n = vgg16_sizes()
    g = torch.Generator(device="cuda").manual_seed(5)
    m = n // (32 * cmp_ops.LANES)
    rows_b4 = WIRE_BUCKET // 4 // (32 * cmp_ops.LANES)
    words = torch.randint(-2 ** 31, 2 ** 31, (1, m, cmp_ops.LANES),
                          generator=g, device="cuda", dtype=torch.int32)
    scales = torch.rand(1, generator=g, device="cuda") + 0.1
    whole = cmp_ops.unpack_signs_weighted_sum_plain(words, scales)
    mean = torch.empty(n, device="cuda")
    zero_launches()
    for a in range(0, m, rows_b4):
        b = min(a + rows_b4, m)
        cmp_ops.unpack_signs_wsum_cuda(words[:, a:b], scales,
                                       out=mean[a * 4096:b * 4096])
    torch.cuda.synchronize()
    b4_launches = cmp_ops.unpack_signs_wsum_cuda.launches
    e4 = check_bits("B4 by bucket into out=", mean, whole)
    one = words[:, :rows_b4]
    nb4 = rows_b4 * 32 * cmp_ops.LANES
    b4 = {"launches_checked": b4_launches, "max_abs_err": e4,
          "shape": [1, rows_b4, cmp_ops.LANES],
          "ms": time_ms(lambda: cmp_ops.unpack_signs_wsum_cuda(
              one, scales, out=mean[:nb4])),
          "plain_ms": time_ms(lambda: cmp_ops.unpack_signs_weighted_sum_plain(
              one, scales, out=mean[:nb4]), reps=5, inner=2, warmup=1),
          **bound(nb4 / 8 + 4 + 4 * nb4, 3 * nb4)}
    # a bucket of four workers' words, as a 4-rank world gathers it
    w4 = 4
    sc4 = torch.rand(w4, generator=g, device="cuda") + 0.1
    four = torch.randint(-2 ** 31, 2 ** 31, (w4, rows_b4, cmp_ops.LANES),
                         generator=g, device="cuda", dtype=torch.int32)
    got = cmp_ops.unpack_signs_wsum_cuda(four, sc4, out=mean[:nb4])
    want = cmp_ops.unpack_signs_weighted_sum_plain(four, sc4)
    rtol, atol = cmp_ops.decode_tol(w4, sc4)
    b4["by_workers"] = [
        {"workers": 1, **{k: b4[k] for k in ("max_abs_err", "ms",
                                              "plain_ms", "bound_ms")}},
        {"workers": w4,
         "max_abs_err": check_close(f"B4 W={w4} bucket", got, want, rtol,
                                    atol / float(want.abs().max())),
         "ms": time_ms(lambda: cmp_ops.unpack_signs_wsum_cuda(
             four, sc4, out=mean[:nb4])),
         "plain_ms": time_ms(lambda: cmp_ops.unpack_signs_weighted_sum_plain(
             four, sc4, out=mean[:nb4]), reps=5, inner=2, warmup=1),
         **bound(w4 * nb4 / 8 + 4 * w4 + 4 * nb4, (2 * w4 + 1) * nb4)}]
    del words, whole, four, got, want
    c2 = topk_inputs(n_true)
    rows = c2.shape[0]
    kv, ki, _ = cmp_ops.topk_encode_cuda(c2, TOPK_K)
    del c2
    per = WIRE_BUCKET // (4 * TOPK_K)
    dense = torch.empty(rows * TOPK_CHUNK, device="cuda")
    zero_launches()
    for a in range(0, rows, per):
        b = min(a + per, rows)
        cmp_ops.topk_decode_cuda(kv[None, a:b], ki[None, a:b], TOPK_CHUNK, 1,
                                 out=dense[a * TOPK_CHUNK:b * TOPK_CHUNK])
    torch.cuda.synchronize()
    b8_launches = cmp_ops.topk_decode_cuda.launches
    want = cmp_ops.topk_decode_plain(kv[None].cpu(), ki[None].cpu(),
                                     TOPK_CHUNK, 1)
    e8 = check_bits("B8 by bucket into out=", dense.cpu(), want)
    del want
    sv, si = kv[None, :per], ki[None, :per]
    # the library yardstick of one bucket, as topk_phase times the whole:
    # one accumulating index_put_ of the bucket's values into its slice
    gidx = (si.long() + torch.arange(per, device="cuda")[None, :, None]
            * TOPK_CHUNK).reshape(-1)
    fv = sv.float().reshape(-1)
    b8 = {"launches_checked": b8_launches, "max_abs_err": e8,
          "shape": [1, per, TOPK_K], "last_rows": rows - per * (b8_launches - 1),
          "ms": time_ms(lambda: cmp_ops.topk_decode_cuda(
              sv, si, TOPK_CHUNK, 1, out=dense[:per * TOPK_CHUNK])),
          "plain_ms": time_ms(lambda: cmp_ops.topk_decode_plain(
              sv, si, TOPK_CHUNK, 1, out=dense[:per * TOPK_CHUNK]), reps=5,
              inner=2, warmup=1),
          "library_ms": time_ms(lambda: dense[:per * TOPK_CHUNK].zero_()
                                .index_put_((gidx,), fv, accumulate=True)),
          **bound(4 * per * TOPK_K + 4 * per * TOPK_CHUNK, per * TOPK_K)}
    b4["library_ms"] = None           # no one PyTorch call decodes signs
    del kv, ki, dense, mean, gidx, fv
    torch.cuda.empty_cache()
    return {"unpack_signs_wsum_cuda": b4, "topk_decode_cuda": b8}


def wire_profile_phase(card: str) -> dict:
    """VGG-16 b32 under onebit and topk, monolithic and at WIRE_BUCKET,
    captured: the wire group's device ms a step (NCCL's kernels), B4's and
    B8's summed, the copies; and AlexNet b128 under params mode, captured,
    with one exchange timed alone (CUDA events)."""
    out = {}
    for w in ("onebit", "topk"):
        for label, bb in (("monolithic", 0), ("4mib", WIRE_BUCKET)):
            key = f"vgg16_{w}_{label}"
            out[key] = p = step_profile_phase(
                *VGG_MODEL, VGG_BATCH, WIRE_GROUPS, PROFILE_STEPS,
                exch_strategy=w, learning_rate=VGG_LR, bucket_bytes=bb)
            print(f"wire profile {key}:", end=" ", flush=True)
            print_profile(p, card, WIRE_GROUPS)
    groups = {"lrn": ("lrn_",), "wire": ("AllReduce",)}
    for mode in ("grads", "params"):
        out[f"alexnet_{mode}"] = p = step_profile_phase(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", BATCH, groups,
            PROFILE_STEPS, after=exchange_ms, exch_mode=mode)
        print(f"wire profile AlexNet {mode} mode:", end=" ", flush=True)
        print_profile(p, card, groups)
    print(f"AlexNet params-mode exchange alone (CUDA events): "
          f"{out['alexnet_params']['after']['exchange_ms']:.4f} ms on {card}",
          flush=True)
    return out


def wire_main(card: str) -> dict:
    """The A7 phases (``--wire`` runs them alone)."""
    t0 = time.time()
    res = {"alexnet": wire_alexnet_phase(), "vgg16": wire_vgg_phase(),
           "decode": wire_decode_phase(), "profile": wire_profile_phase(card)}
    d = res["decode"]
    print("wire decode by bucket: " + "; ".join(
        f"{k[:-5]} {v['shape']} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
        f"plain {v['plain_ms']:.3f}"
        + ("" if v["library_ms"] is None else
           f", index_put_ {v['library_ms']:.4f}")
        + f"), {v['launches_checked']} buckets into one mean bit for bit"
        for k, v in d.items()) + "; B4 a bucket by workers: " + ", ".join(
        f"W={r['workers']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})"
        for r in d["unpack_signs_wsum_cuda"]["by_workers"])
        + f" on {card}", flush=True)
    res["secs"] = time.time() - t0
    print(f"wire phases passed in {res['secs']:.1f}s", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_wire.json"), "w") as f:
        json.dump(dict(res, card=card), f, indent=1)
    return res


# -- data-parallel state sharding (A9a) ----------------------------------------

# each key's run beside plain BSP's, world 1 over NCCL, captured
SHARD_KEYS = ("plain", "zero_opt", "update_sharding", "fsdp")
SHARD_PATHS = {
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet",
                dict(batch_size=BATCH)),
    "vgg16": VGG_MODEL + (dict(batch_size=VGG_BATCH,
                               learning_rate=VGG_LR),)}
SHARD_GROUPS = {
    # NCCL's kernels (at world 1 a collective may be a copy instead)
    "gather": ("AllGather",), "reduce_scatter": ("ReduceScatter",),
    "allreduce": ("AllReduce",),
    "copies": ("direct_copy_kernel", "CatArrayBatchedCopy", "Memcpy DtoD"),
    "optimizer": ("multi_tensor_apply_kernel",)}
SHARD_CKPT = os.path.join("build", "smoke_fsdp_ckpt")


def unsharded_state(model) -> list:
    """The live params and the optimizer state in the unsharded layout
    (``unsharded_opt_state``: ZeRO-1's and FSDP's chunks gathered), and
    the BN state, as host tensors."""
    return [t.detach().cpu().clone() for t in
            tree_leaves(model.live_params())
            + tree_leaves(model.unsharded_opt_state())
            + tree_leaves(model.bn_state)]


def fsdp_resume_check(model, worker, modelfile, modelclass, count) -> dict:
    """FSDP on the card: a checkpoint of ``model`` after step ``count``
    loaded into a fresh model (its own exchanger, the same world-1 group):
    params, momentum and the chunk bit for bit; then two more steps of
    each, costs and state bit for bit."""
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    shutil.rmtree(SHARD_CKPT, ignore_errors=True)
    model.save(SHARD_CKPT, 0, count)
    other = worker.build_model(modelfile, modelclass)
    other.compile_iter_fns(BSP_Exchanger(worker.config))
    if other.load(SHARD_CKPT) != 0:
        raise AssertionError("fsdp resume: no checkpoint")
    n = 0
    for x, y in zip(unsharded_state(model), unsharded_state(other)):
        check_bits(f"fsdp resume tensor {n}", y, x)
        n += 1
    check_bits("fsdp resume chunk", other._fsdp.shard, model._fsdp.shard)
    for c in (count + 1, count + 2):
        for m in (model, other):
            m.train_iter(c)
        check_bits(f"fsdp resumed step {c} cost",
                   other.current_info["cost"], model.current_info["cost"])
    for i, (x, y) in enumerate(zip(unsharded_state(model),
                                   unsharded_state(other))):
        check_bits(f"fsdp resumed state tensor {i}", y, x)
    del other
    return {"tensors": n, "steps_after": 2}


REFIT_CKPT = os.path.join("build", "smoke_refit_ckpt")


def rewrite_ckpt(src: str, dst: str, n: int) -> None:
    """A world-1 checkpoint rewritten, with this script's own numpy, as
    the files ``n`` workers of a ZeRO-1 or FSDP run would have written:
    each boxed ``[1, flat]`` leaf's flat vector zero-padded to ``n`` equal
    rows, each boxed counter ``[1]`` repeated, and the ``n_workers`` and
    ``zero``/``fsdp`` meta set to match."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    with open(os.path.join(src, "ckpt_epoch0.json")) as f:
        meta = json.load(f)
    boxed = set(meta["boxed_parts"])
    with np.load(os.path.join(src, "ckpt_epoch0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    for k, a in arrays.items():
        if k.split("__")[0] not in boxed:
            continue
        if a.ndim == 1:
            arrays[k] = np.repeat(a, n)
            continue
        flat = a.reshape(-1)
        c = -(-flat.size // n)
        arrays[k] = np.concatenate(
            [flat, np.zeros(c * n - flat.size, a.dtype)]).reshape(n, c)
        if "fsdp" in meta:
            meta["fsdp"].update(n=n, chunk=c)
    meta["n_workers"] = n
    if "zero" in meta:
        meta["zero"]["n"] = n
    np.savez(os.path.join(dst, "ckpt_epoch0.npz"), **arrays)
    with open(os.path.join(dst, "ckpt_epoch0.json"), "w") as f:
        json.dump(meta, f)


def raw_state(model) -> list:
    """The state parts as the step keeps them (ZeRO-1's and FSDP's
    chunks), host copies."""
    return [t.detach().cpu().clone() for part in
            model._state_parts().values() for t in tree_leaves(part)
            if isinstance(t, torch.Tensor)]


def refit_check(model, worker, modelfile, modelclass, count, key,
                async_save=False) -> dict:
    """Elastic resume on the card: ``model``'s world-1 checkpoint after
    step ``count``, rewritten by :func:`rewrite_ckpt` as the files of 2
    and of 4 workers, each loaded into a fresh captured model, which
    refits 2 → 1 and 4 → 1: the unsharded params and optimizer state and
    the chunk bit for bit; then two more steps of the three models, costs
    and state bit for bit, their B1 and B2 launches counted.  With
    ``async_save``: a synchronous save, then an ``async_ckpt`` save of the
    same count and the next step before ``wait_pending_ckpt``: every array
    of the landed file equal to the synchronous one's, and the file loads
    bit for bit."""
    from theanompi_tpu_torch.parallel.exchanger import BSP_Exchanger
    t_all = time.time()
    base = os.path.join(REFIT_CKPT, key)
    shutil.rmtree(base, ignore_errors=True)
    src = os.path.join(base, "w1")
    model.save(src, 0, count)
    want, want_raw = unsharded_state(model), raw_state(model)
    out, loaded, n_t = {}, {}, 0
    for n in (2, 4):
        d = os.path.join(base, f"w{n}")
        rewrite_ckpt(src, d, n)
        m = worker.build_model(modelfile, modelclass)
        m.compile_iter_fns(BSP_Exchanger(worker.config))
        torch.cuda.synchronize()
        t0 = time.time()
        if m.load(d) != 0:
            raise AssertionError(f"{key} refit {n}->1: no checkpoint")
        torch.cuda.synchronize()
        out[f"load_{n}to1_s"] = time.time() - t0
        for i, (x, y) in enumerate(zip(want, unsharded_state(m))):
            check_bits(f"{key} refit {n}->1 tensor {i}", y, x)
            n_t += 1
        for i, (x, y) in enumerate(zip(want_raw, raw_state(m))):
            check_bits(f"{key} refit {n}->1 chunk {i}", y, x)
        loaded[n] = m
    zero_launches()
    for c in (count + 1, count + 2):
        model.train_iter(c)
        for n, m in loaded.items():
            m.train_iter(c)
            check_bits(f"{key} refit {n}->1 step {c} cost",
                       m.current_info["cost"], model.current_info["cost"])
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != expect(lrn_fwd_cuda=12, lrn_bwd_cuda=12):
        raise AssertionError(f"{key} refit: launches {launches}, want 2 "
                             f"B1 and 2 B2 a step of 3 models x 2 steps")
    now = unsharded_state(model)
    for n, m in loaded.items():
        for i, (x, y) in enumerate(zip(now, unsharded_state(m))):
            check_bits(f"{key} refit {n}->1 stepped tensor {i}", y, x)
    out.update(tensors=n_t, steps_after=2, launches=launches)
    if async_save:
        c = count + 2
        sync_d, async_d = (os.path.join(base, w) for w in ("sync", "async"))
        t0 = time.time()
        model.save(sync_d, 0, c)
        out["sync_save_s"] = time.time() - t0
        want = unsharded_state(model)
        model.config["async_ckpt"] = True
        try:
            t0 = time.time()
            model.save(async_d, 0, c)
            out["async_save_blocking_s"] = time.time() - t0
            model.train_iter(c + 1)        # in place while the write runs
            t0 = time.time()
            model.wait_pending_ckpt()
            out["async_wait_after_step_s"] = time.time() - t0
        finally:
            model.config["async_ckpt"] = False
        with np.load(os.path.join(sync_d, "ckpt_epoch0.npz")) as a, \
                np.load(os.path.join(async_d, "ckpt_epoch0.npz")) as b:
            if sorted(a.files) != sorted(b.files):
                raise AssertionError("async save: other arrays")
            for k in a.files:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"async save: {k} differs from the "
                                         f"synchronous save")
            out["async_arrays"] = len(a.files)
        m = loaded[2]
        if m.load(async_d) != 0:
            raise AssertionError("async save: no checkpoint")
        for i, (x, y) in enumerate(zip(want, unsharded_state(m))):
            check_bits(f"async save load tensor {i}", y, x)
    del loaded, m
    out["secs"] = time.time() - t_all
    return out


def shard_run(path: str, key: str) -> dict:
    """One key on one model: GRAPH_STEPS captured steps from seed 0,
    launches counted from 0, the peak of allocated device memory from
    compile to the last step and what stays allocated (both above what
    was allocated before the model was built), the state after
    (unsharded, on the host); then PROFILE_STEPS profiled steps
    (``profile_model``) and, for AlexNet under FSDP, the save → resume
    check; for AlexNet under ``zero_opt`` and FSDP the refit from 2- and
    4-worker files, and under FSDP the async save (:func:`refit_check`)."""
    from theanompi_tpu_torch.worker import WORKERS
    modelfile, modelclass, cfg = SHARD_PATHS[path]
    cfg = dict(cfg, n_workers=1, seed=0, verbose=False,
               **({} if key == "plain" else {key: True}))
    steps = GRAPH_STEPS
    # the last run's worker and model are garbage only once its frame has
    # returned: collected here, so that this run's memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    zero_launches()
    worker = WORKERS["bsp"](cfg)
    try:
        model = worker.build_model(modelfile, modelclass)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.compile_iter_fns(worker.exchanger)
        model.data.shuffle_data(model.seed)
        costs = []
        for i in range(steps):
            model.train_iter(i + 1)
            costs.append(model.current_info["cost"].clone())
        torch.cuda.synchronize()
        out = {"costs": costs, "launches": launch_counts(),
               "graphed": model.train_fn.graphed,
               "peak_mb": (torch.cuda.max_memory_allocated() - base)
               / 2 ** 20,
               "held_mb": (torch.cuda.memory_allocated() - base) / 2 ** 20,
               "base_mb": base / 2 ** 20,
               "state": unsharded_state(model)}
        if model._fsdp is not None:
            out["fsdp"] = {"chunk": model._fsdp.chunk,
                           "total": model._fsdp.total,
                           "n_total": model._fsdp.n_total}
        out["profile"] = profile_model(
            model, lambda rec, c: None, modelclass, cfg["batch_size"],
            SHARD_GROUPS, PROFILE_STEPS, count=steps)
        count = steps + 2 + 2 * PROFILE_STEPS
        if (path, key) == ("alexnet", "fsdp"):
            out["resume"] = fsdp_resume_check(
                model, worker, modelfile, modelclass, count)
            count += 2
        if path == "alexnet" and key in ("zero_opt", "fsdp"):
            out["refit"] = refit_check(model, worker, modelfile, modelclass,
                                       count, key, async_save=key == "fsdp")
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def shard_main(card: str) -> dict:
    """The A9a phases (``--shard`` runs them alone): AlexNet b128 and
    VGG-16 b32 under plain BSP, ``zero_opt``, ``update_sharding`` and
    ``fsdp``, each captured for GRAPH_STEPS steps, cuDNN deterministic,
    and held against plain BSP bit for bit (costs, params, momentum
    gathered); AlexNet launches 2 B1 and 2 B2 a step under each key; each
    run's step wall ms, device busy ms, the gather, reduce-scatter,
    all-reduce, copy and optimizer kernels' ms and its peak device memory
    printed beside plain BSP's; one FSDP save → resume."""
    t0 = time.time()
    lrn = expect(lrn_fwd_cuda=2 * GRAPH_STEPS, lrn_bwd_cuda=2 * GRAPH_STEPS)
    res = {}
    torch.backends.cudnn.deterministic = True
    try:
        for path in SHARD_PATHS:
            runs = res[path] = {}
            for key in SHARD_KEYS:
                runs[key] = r = shard_run(path, key)
                if path == "alexnet" and r["launches"] != lrn:
                    raise AssertionError(f"AlexNet {key}: launches "
                                         f"{r['launches']}, want {lrn}")
                if not r["graphed"]:
                    raise AssertionError(f"{path} {key}: not captured")
                if key != "plain":
                    # every tensor compared first, then the verdict
                    plain = runs["plain"]
                    diffs = [float((a.double() - b.double()).abs().max())
                             if a.numel() else 0.0
                             for a, b in zip(r["state"], plain["state"])]
                    r["max_abs_diff"] = max(diffs)
                    r["tensors"] = same_run(f"{path} {key} vs plain", plain,
                                            dict(r, launches=plain[
                                                "launches"]))
                p, q = r["profile"], runs["plain"]["profile"]
                print(f"shard: {path} {key}: {GRAPH_STEPS} captured steps "
                      + ("" if key == "plain" else
                         f"bit for bit plain BSP ({r['tensors']} tensors); ")
                      + f"step {p['wall_ms_per_step']:.2f} ms (plain "
                      f"{q['wall_ms_per_step']:.2f}), device busy "
                      f"{p['device_busy_ms_per_step']:.2f} ms (plain "
                      f"{q['device_busy_ms_per_step']:.2f}), "
                      + ", ".join(f"{g} {p[g + '_ms_per_step']:.3f}"
                                  for g in SHARD_GROUPS)
                      + f" ms; peak {r['peak_mb']:.0f} MiB (plain "
                      f"{runs['plain']['peak_mb']:.0f}), held "
                      f"{r['held_mb']:.0f} MiB on {card}", flush=True)
                print_profile(p, card, SHARD_GROUPS)
            for r in runs.values():
                del r["state"]
                r["costs"] = [float(c) for c in r["costs"]]
    finally:
        torch.backends.cudnn.deterministic = False
    rs = res["alexnet"]["fsdp"]["resume"]
    print(f"shard: AlexNet fsdp save -> resume: {rs['tensors']} tensors and "
          f"{rs['steps_after']} more steps bit for bit", flush=True)
    for key in ("zero_opt", "fsdp"):
        rf = res["alexnet"][key]["refit"]
        print(f"shard: AlexNet {key} refit from 2- and 4-worker files: "
              f"{rf['tensors']} tensors and the chunks bit for bit, loads "
              f"2->1 {rf['load_2to1_s']:.2f} s, 4->1 {rf['load_4to1_s']:.2f} "
              f"s; {rf['steps_after']} more steps of 3 models bit for bit, "
              f"B1 {rf['launches']['lrn_fwd_cuda']} B2 "
              f"{rf['launches']['lrn_bwd_cuda']} launches; checks "
              f"{rf['secs']:.1f} s on {card}", flush=True)
    rf = res["alexnet"]["fsdp"]["refit"]
    print(f"shard: AlexNet fsdp async save: {rf['async_arrays']} arrays equal "
          f"to the synchronous save of the same count after the next step "
          f"ran, loads bit for bit; blocking "
          f"{rf['async_save_blocking_s']:.2f} s, joined "
          f"{rf['async_wait_after_step_s']:.2f} s after the step (sync save "
          f"{rf['sync_save_s']:.2f} s) on {card}", flush=True)
    res["refit_secs"] = sum(res["alexnet"][k]["refit"]["secs"]
                            for k in ("zero_opt", "fsdp"))
    print(f"shard: the refit and async-save checks took "
          f"{res['refit_secs']:.1f} s of the group", flush=True)
    res["secs"] = time.time() - t0
    print(f"shard phases passed in {res['secs']:.1f}s", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_shard.json"), "w") as f:
        json.dump(dict(res, card=card), f, indent=1)
    return res


# -- the GANs and the rest of the LM at one rank (A9b, A9c) -----------------

GAN_BATCH = 64
# the JAX package's GAN classes at their full width (base_width 64, z_dim
# 128) on the synthetic Cifar10 set: WGAN (RMSprop 5e-5, n_critic 5, clip
# 0.01) and LSGAN (Adam 2e-4, n_critic 1, and once at 4)
GAN_CFG = dict(batch_size=GAN_BATCH, base_width=64, z_dim=128,
               synthetic_train=GAN_BATCH * GRAPH_STEPS,
               synthetic_val=GAN_BATCH)
GAN_PATHS = {"wgan": ("WGAN", {}), "lsgan": ("LSGAN", {}),
             "lsgan_nc4": ("LSGAN", {"n_critic": 4})}
# the card (float32, TF32 off) against the CPU (float32): one training
# forward of each GAN at full width, batch 64, the same batch and z; the
# cost (D + G loss) and the G loss each within GAN_REF_RTOL·|cpu| +
# GAN_REF_ATOL (WGAN's losses are means of critic scores near 0 at init)
GAN_REF_RTOL, GAN_REF_ATOL = 1e-4, 1e-6
GAN_GROUPS = {"batchnorm": ("batch_norm", "bn_fw", "bn_bw", "BatchNorm",
                            "Welford"),
              "optimizer": ("multi_tensor_apply_kernel",)}
# the MoE LM at LM_CFG's widths: 4 experts in every 2nd block (4 of the 8),
# top-1, capacity factor 1.25, aux 0.01 (the JAX model's defaults)
MOE_CFG = dict(LM_CFG, moe_experts=4, moe_every=2, moe_topk=1,
               capacity_factor=1.25, moe_aux=0.01)
LM_FILE = "theanompi_tpu_torch.models.transformer_lm"
A9_PATHS = {
    "moe_lm": (LM_FILE, "MoETransformerLM", dict(
        MOE_CFG, batch_size=LM_BATCH, synthetic_train=LM_BATCH * GRAPH_STEPS,
        synthetic_val=LM_BATCH)),
    "lm": (LM_FILE, "TransformerLM", dict(
        LM_CFG, batch_size=LM_BATCH, synthetic_train=LM_BATCH * GRAPH_STEPS,
        synthetic_val=LM_BATCH)),
    **{p: ("theanompi_tpu_torch.models.gan", cls, dict(GAN_CFG, **over))
       for p, (cls, over) in GAN_PATHS.items()}}
A9_PATHS["lm_remat"] = A9_PATHS["lm"][:2] + (dict(A9_PATHS["lm"][2],
                                                  remat=True),)
LM_GROUPS = {"flash": ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                       "flash_bwd_dq_kernel")}
# the MoE layer's dispatch and combine: the slot copies (index_copy), the
# combine's gathers (index_select) and their backward (index_add), the
# slots' running count (cumsum); the expert products are batched GEMMs
MOE_GROUPS = dict(LM_GROUPS, moe_dispatch_combine=(
    "index_copy", "indexSelect", "indexFunc", "index_select", "scan"))
GEN_PROMPT, GEN_NEW = 64, 256
# the KV-cache sampler's tokens against the full forward's greedy choice
# after the same prefix: at least these shares (the JAX package's
# tests/test_generate.py shares for the dense and the MoE model)
GEN_SHARE = {"lm": 0.9, "moe_lm": 0.85}
TOKEN_DIR = os.path.join("build", "smoke_tokens")


def a9_run(path: str, capture: bool = True, steps: int = GRAPH_STEPS,
           groups=None, step_check=None, keep: bool = False) -> dict:
    """``steps`` train steps of an A9 path from seed 0 through the worker
    (``build_model``, ``compile_iter_fns``, the epoch's shuffle,
    ``train_iter``), launches counted from 0: each step's cost, the state
    after (params, optimizer, BN) on the host, the launch counts, the peak
    of allocated device memory from compile to the last step (above what
    was allocated before the model was built); ``step_check(model)`` makes
    a check called after each step with its count; ``groups``: then
    PROFILE_STEPS profiled steps (``profile_model``); ``keep``: the model
    under ``"model"``."""
    from theanompi_tpu_torch.worker import WORKERS
    modelfile, modelclass, cfg = A9_PATHS[path]
    cfg = dict(cfg, n_workers=1, seed=0, verbose=False)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    zero_launches()
    worker = WORKERS["bsp"](cfg)
    try:
        model = worker.build_model(modelfile, modelclass)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model.compile_iter_fns(worker.exchanger, capture=capture)
        model.data.shuffle_data(model.seed)
        check = step_check(model) if step_check else None
        costs = []
        t0 = time.time()
        for c in range(1, steps + 1):
            model.train_iter(c)
            costs.append(model.current_info["cost"].clone())
            if check:
                check(c)
        torch.cuda.synchronize()
        out = {"costs": costs, "secs": time.time() - t0,
               "graphed": model.train_fn.graphed, "launches": launch_counts(),
               "peak_mb": (torch.cuda.max_memory_allocated() - base)
               / 2 ** 20,
               "state": [t.detach().cpu().clone() for t in
                         tree_leaves(model.params)
                         + tree_leaves(model.opt_state)
                         + tree_leaves(model.bn_state)]}
        if not all(np.isfinite(float(c)) for c in costs):
            raise AssertionError(f"{path}: costs {costs}")
        if groups is not None:
            out["profile"] = profile_model(
                model, lambda rec, c: None, modelclass, cfg["batch_size"],
                groups, PROFILE_STEPS, count=steps)
        if keep:
            out["model"] = model
        del model
    finally:
        worker.close()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def gan_gate_check(model):
    """After each step: off the cadence (``count % n_critic != 0``) G's
    params and every gated optimizer leaf (G's RMSprop square average, or
    its Adam moments and count) bit for bit what they were, else some G
    param moved; some D param moved on every step; every D weight within
    ±clip (WGAN)."""
    def host():
        g = model._gated_leaves(model.params, model.opt_state)
        return ([t.detach().cpu().clone() for t in g],
                [t.detach().cpu().clone() for t in
                 tree_leaves(model.params["D"])])

    prev = host()
    n, clip = model.n_critic, getattr(model, "clip", None)
    stats = {"gated_steps": 0, "g_steps": 0}

    def check(count):
        nonlocal prev
        g, d = host()
        if n > 1 and count % n:
            for i, (a, b) in enumerate(zip(prev[0], g)):
                check_bits(f"{type(model).__name__} step {count} gated G "
                           f"leaf {i}", b, a)
            stats["gated_steps"] += 1
        elif all(torch.equal(a, b) for a, b in
                 zip(prev[0], g[:len(prev[0])])):
            raise AssertionError(f"step {count}: G did not move")
        else:
            stats["g_steps"] += 1
        if all(torch.equal(a, b) for a, b in zip(prev[1], d)):
            raise AssertionError(f"step {count}: D did not move")
        if clip is not None:
            top = max(float(t.abs().max()) for t in d)
            if top > clip:
                raise AssertionError(f"step {count}: D weight {top} past "
                                     f"the clip {clip}")
        prev = (g, d)

    check.stats = stats
    return check


def gan_reference(path: str) -> dict:
    """One training forward of a GAN at full width, float32, on the card
    (TF32 off) and on its CPU twin (``cpu_twin``): the same weights, batch
    and z (drawn from a numpy seed and handed to both ``draw_z``); the
    cost and the G loss within GAN_REF_RTOL / GAN_REF_ATOL."""
    from theanompi_tpu_torch.models import gan
    name, over = GAN_PATHS[path]
    cls = getattr(gan, name)
    cfg = dict(GAN_CFG, **over, compute_dtype="float32", seed=0,
               synthetic_train=GAN_BATCH, verbose=False)
    card = cls(dict(cfg, device="cuda"))
    cpu = cpu_twin(cls, cfg, card)
    batch = card.data.next_train_batch(1)
    z = torch.from_numpy(np.random.RandomState(7).randn(
        GAN_BATCH, card.z_dim).astype(np.float32))
    res = {}
    for where, m in (("card", card), ("cpu", cpu)):
        m.draw_z = lambda n, gen, device: z.to(device)
        b = {k: torch.from_numpy(v).to(m.device) for k, v in batch.items()}
        with torch.no_grad():
            cost, g_loss = m.loss_and_metrics(m.params, m.bn_state, b, None,
                                              True)
        res[where] = (float(cost), float(g_loss))
    out = {}
    for i, what in enumerate(("cost", "g_loss")):
        a, b = res["card"][i], res["cpu"][i]
        if not np.isfinite(a) or \
                abs(a - b) > GAN_REF_RTOL * abs(b) + GAN_REF_ATOL:
            raise AssertionError(f"{path} {what}: card {a}, CPU {b}")
        out[what] = {"card": a, "cpu": b}
    del card, cpu
    return out


def gan_phase(card: str) -> dict:
    """Each GAN path: the float32 card-vs-CPU forward; GRAPH_STEPS steps
    eager and captured from seed 0, cuDNN deterministic, each step's gate
    and clip checked (``gan_gate_check``), captured ≡ eager bit for bit
    (costs, params, optimizer state, BN state); then PROFILE_STEPS
    profiled steps of the captured run."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for path in GAN_PATHS:
            ref = gan_reference(path)
            runs = {}
            for capture in (False, True):
                checks = []

                def make(model):
                    checks.append(gan_gate_check(model))
                    return checks[-1]

                runs[capture] = a9_run(
                    path, capture, step_check=make,
                    groups=GAN_GROUPS if capture else None)
                runs[capture]["gate"] = checks[0].stats
            eager, graph = runs[False], runs[True]
            if eager["graphed"] or not graph["graphed"]:
                raise AssertionError(f"{path}: graphed {eager['graphed']}, "
                                     f"{graph['graphed']}")
            n = same_run(f"{path} graph vs eager", eager, graph)
            p = graph["profile"]
            out[path] = {"ref": ref, "tensors": n, "gate": graph["gate"],
                         "costs": [float(c) for c in graph["costs"]],
                         "peak_mb": graph["peak_mb"], "profile": p}
            print(f"{path}: f32 card vs CPU cost {ref['cost']['card']:.6g} "
                  f"vs {ref['cost']['cpu']:.6g}, G loss "
                  f"{ref['g_loss']['card']:.6g} vs {ref['g_loss']['cpu']:.6g}"
                  f"; {GRAPH_STEPS} steps captured == eager ({n} state "
                  f"tensors bit for bit), G frozen bit for bit on "
                  f"{graph['gate']['gated_steps']} gated steps, moved on "
                  f"{graph['gate']['g_steps']}; costs "
                  f"{[round(c, 5) for c in out[path]['costs']]}; step "
                  f"{p['wall_ms_per_step']:.3f} ms wall, device busy "
                  f"{p['device_busy_ms_per_step']:.3f} ms, idle share "
                  f"{p['device_idle_share']:.3f}; peak "
                  f"{graph['peak_mb']:.0f} MiB on {card}", flush=True)
            print_profile(p, card, GAN_GROUPS)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def lm_launches(n_layer: int, steps: int, val: int = 0,
                remat: bool = False) -> dict:
    """B10–B12 of the LM's main path: each layer's attention runs B10 in
    each forward (twice a training step under ``remat``: the backward
    recomputes it) and B11 + B12 in each backward."""
    return expect(flash_fwd_cuda=n_layer * ((2 if remat else 1) * steps
                                            + val),
                  flash_bwd_dkv_cuda=n_layer * steps,
                  flash_bwd_dq_cuda=n_layer * steps)


def moe_phase(card: str) -> dict:
    """The MoE LM: the BSP session (LM_STEPS steps and a validation batch,
    B10–B12 launched as for the dense LM, costs finite), then GRAPH_STEPS
    steps eager and captured, bit for bit, and the captured run profiled
    (the dispatch and combine as a group).  Returns the session's model,
    for the sampler."""
    n = MOE_CFG["n_layer"]
    model, out = run_main_path(
        LM_FILE, "MoETransformerLM", lm_launches(n, LM_STEPS, VAL_BATCHES),
        batch_size=LM_BATCH, synthetic_train=LM_BATCH * LM_STEPS,
        synthetic_val=LM_BATCH * VAL_BATCHES, printFreq=LM_STEPS // 2,
        **MOE_CFG)
    out["n_params"] = sum(p.numel() for p in tree_leaves(model.params))
    out["tokens_per_s"] = out["img_per_s"] * MOE_CFG["seq_len"]
    print(f"main path: MoETransformerLM BSP flash batch {LM_BATCH}, "
          f"{LM_STEPS} steps, {out['n_params']} params, costs "
          f"{[round(c, 4) for c in out['costs']]}, "
          f"{out['tokens_per_s']:.0f} tokens/s, launches "
          f"{ {k: v for k, v in out['launches'].items() if v} } on {card}",
          flush=True)
    eager = a9_run("moe_lm", False)
    graph = a9_run("moe_lm", True, groups=MOE_GROUPS)
    if graph["launches"] != lm_launches(n, GRAPH_STEPS):
        raise AssertionError(f"moe_lm launches {graph['launches']}")
    out["tensors"] = same_run("moe_lm graph vs eager", eager, graph)
    out["profile"] = p = graph["profile"]
    out["peak_mb"] = graph["peak_mb"]
    print(f"graph == eager, moe_lm: {GRAPH_STEPS} steps, {out['tensors']} "
          f"state tensors and the costs bit for bit; peak "
          f"{graph['peak_mb']:.0f} MiB", flush=True)
    print_profile(p, card, MOE_GROUPS)
    return model, out


def remat_phase(card: str) -> dict:
    """The dense flash LM GRAPH_STEPS captured steps with and without
    ``remat`` from seed 0: costs and state bit for bit (the recomputed
    forward is the same operations), B10 2 × n_layer a step under remat,
    each run's peak allocated memory, and each profiled.  Returns the
    plain run's model, for the sampler."""
    n = LM_CFG["n_layer"]
    runs = {}
    for remat in (False, True):
        path = "lm_remat" if remat else "lm"
        runs[remat] = r = a9_run(path, True, groups=LM_GROUPS,
                                 keep=not remat)
        want = lm_launches(n, GRAPH_STEPS, remat=remat)
        if r["launches"] != want:
            raise AssertionError(f"{path} launches {r['launches']}, want "
                                 f"{want}")
    n_t = same_run("lm remat vs plain", runs[False],
                   dict(runs[True], launches=runs[False]["launches"]))
    model = runs[False].pop("model")
    out = {}
    for remat, r in runs.items():
        p = r["profile"]
        out["remat" if remat else "plain"] = {
            "peak_mb": r["peak_mb"], "launches": {
                k: v for k, v in r["launches"].items() if v},
            "costs": [float(c) for c in r["costs"]], "profile": p}
        print_profile(p, card, LM_GROUPS)
    out["tensors"] = n_t
    a, b = out["plain"], out["remat"]
    print(f"remat: {GRAPH_STEPS} captured steps bit for bit the plain LM's "
          f"({n_t} state tensors and the costs); B10 "
          f"{b['launches'].get('flash_fwd_cuda', 0)} launches (plain "
          f"{a['launches'].get('flash_fwd_cuda', 0)}); peak "
          f"{b['peak_mb']:.0f} MiB "
          f"(plain {a['peak_mb']:.0f}); step "
          f"{b['profile']['wall_ms_per_step']:.2f} ms (plain "
          f"{a['profile']['wall_ms_per_step']:.2f}), flash "
          f"{b['profile']['flash_ms_per_step']:.3f} ms a step (plain "
          f"{a['profile']['flash_ms_per_step']:.3f}) on {card}", flush=True)
    return model, out


def generate_phase(name: str, model, card: str) -> dict:
    """``generate`` on a trained model: LM_BATCH prompts of GEN_PROMPT
    tokens (the validation batch's first), GEN_NEW new tokens, greedy,
    with the KV cache (B10 n_layer times: its prefill) and by the full
    forward (B10 n_layer times a token), each timed (host clock, ending in
    a synchronize); each KV token against the full forward's greedy
    choice after the same prefix (one forward over the KV tokens), at
    least GEN_SHARE[name]; the two free-running samplers' agreement is
    reported (one flipped near-tie changes every later token of its
    row)."""
    n = model.n_layer
    prompt = model.data.next_val_batch(0)["x"][:LM_BATCH, :GEN_PROMPT]
    res = {}
    for kv in (True, False):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        toks = model.generate(prompt, GEN_NEW, kv_cache=kv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = launch_counts()
        want = expect(flash_fwd_cuda=n if kv else n * GEN_NEW)
        if launches != want:
            raise AssertionError(f"{name} generate kv={kv}: launches "
                                 f"{launches}, want {want}")
        res["kv" if kv else "full"] = {
            "tokens": toks, "secs": secs,
            "tokens_per_s": toks.size / secs,
            "launches": {k: v for k, v in launches.items() if v}}
    kv_t, full_t = res["kv"]["tokens"], res["full"]["tokens"]
    buf = np.zeros((prompt.shape[0], model.seq_len), np.int64)
    buf[:, :GEN_PROMPT] = prompt
    buf[:, GEN_PROMPT:GEN_PROMPT + GEN_NEW] = kv_t
    with torch.no_grad():
        logits = model.apply_model(model.canonical_params(),
                                   torch.from_numpy(buf).to(model.device),
                                   train=False, gen=None, state=None)
    choice = logits[:, GEN_PROMPT - 1:GEN_PROMPT + GEN_NEW - 1].argmax(-1)
    step_share = float((choice.cpu().numpy() == kv_t).mean())
    free_share = float((kv_t == full_t).mean())
    if step_share < GEN_SHARE[name]:
        raise AssertionError(f"{name}: KV tokens agree with the full "
                             f"forward's choice on {step_share:.3f} < "
                             f"{GEN_SHARE[name]}")
    out = {"step_share": step_share, "free_share": free_share,
           "batch": int(prompt.shape[0]), "prompt": GEN_PROMPT,
           "new": GEN_NEW}
    for k in ("kv", "full"):
        out[k] = {kk: v for kk, v in res[k].items() if kk != "tokens"}
    print(f"generate {name}: b{out['batch']}, prompt {GEN_PROMPT}, {GEN_NEW} "
          f"new tokens, greedy: KV {out['kv']['tokens_per_s']:.0f} tokens/s "
          f"({out['kv']['secs']:.2f} s, launches {out['kv']['launches']}), "
          f"full forward {out['full']['tokens_per_s']:.0f} tokens/s "
          f"({out['full']['secs']:.2f} s, launches "
          f"{out['full']['launches']}); KV tokens = the full forward's "
          f"choice on {step_share:.4f}, free-running samplers agree on "
          f"{free_share:.4f} on {card}", flush=True)
    return out


def write_token_files(root: str, vocab: int, seq_len: int, batch: int,
                      steps: int) -> None:
    """``train.bin`` and ``val.bin`` (uint16, nanoGPT's layout) of random
    ids below ``vocab``: ``batch · steps`` training windows of
    ``seq_len + 1`` tokens (stride ``seq_len``) and ``batch`` validation
    windows."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    r = np.random.RandomState(11)
    for split, n in (("train", batch * steps), ("val", batch)):
        r.randint(0, vocab, n * seq_len + 1).astype(np.uint16).tofile(
            os.path.join(root, split + ".bin"))


def token_files_phase(card: str) -> dict:
    """The flash LM from token files: the script writes them under
    TOKEN_DIR, then the BSP session trains LM_STEPS steps and a validation
    batch from them (``data_dir``), B10–B12 counted, costs finite."""
    from theanompi_tpu_torch.models.data.tokens import TokenFileData
    write_token_files(TOKEN_DIR, LM_CFG["vocab"], LM_CFG["seq_len"],
                      LM_BATCH, LM_STEPS)
    n = LM_CFG["n_layer"]
    model, out = run_main_path(
        LM_FILE, "TransformerLM", lm_launches(n, LM_STEPS, VAL_BATCHES),
        batch_size=LM_BATCH, data_dir=TOKEN_DIR, printFreq=LM_STEPS // 2,
        **LM_CFG)
    if not isinstance(model.data, TokenFileData) or \
            model.data.n_batch_train != LM_STEPS:
        raise AssertionError(f"token files: data {type(model.data)}")
    del model
    out["tokens_per_s"] = out["img_per_s"] * LM_CFG["seq_len"]
    print(f"main path: TransformerLM from token files (uint16), batch "
          f"{LM_BATCH}, {LM_STEPS} steps, costs "
          f"{[round(c, 4) for c in out['costs']]}, "
          f"{out['tokens_per_s']:.0f} tokens/s, launches "
          f"{ {k: v for k, v in out['launches'].items() if v} } on {card}",
          flush=True)
    return out


def gan_lm_main(card: str) -> dict:
    """The A9b and A9c phases (``--gan-lm`` runs them alone): the GANs, the
    MoE LM, remat, the sampler on the MoE LM and the dense LM those phases
    trained, and the LM from token files."""
    t0 = time.time()
    res = {"gan": gan_phase(card)}
    moe_model, res["moe_lm"] = moe_phase(card)
    res["generate"] = {"moe_lm": generate_phase("moe_lm", moe_model, card)}
    del moe_model
    lm_model, res["remat"] = remat_phase(card)
    res["generate"]["lm"] = generate_phase("lm", lm_model, card)
    del lm_model
    gc.collect()
    torch.cuda.empty_cache()
    res["token_files"] = token_files_phase(card)
    res["secs"] = time.time() - t0
    print(f"gan/lm phases passed in {res['secs']:.1f}s", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_gan_lm.json"),
              "w") as f:
        json.dump(dict(res, card=card), f, indent=1)
    return res


def flash_launches_by_path(lm, a9) -> dict:
    """B10–B12's launches on each LM path of the run, by wrapper."""
    paths = {"lm": lm, "moe_lm": a9["moe_lm"],
             "lm_remat_graph_steps": a9["remat"]["remat"],
             "lm_graph_steps": a9["remat"]["plain"],
             "lm_token_files": a9["token_files"],
             **{f"generate_{kind}_{m}": a9["generate"][m][kind]
                for m in ("lm", "moe_lm") for kind in ("kv", "full")}}
    return {name: {p: r["launches"].get(name, 0) for p, r in paths.items()}
            for name in ("flash_fwd_cuda", "flash_bwd_dkv_cuda",
                         "flash_bwd_dq_cuda")}


# (para_load_workers, native augment threads per batch) settings timed by
# ``--input-times``; the first is what the port ships on an 8-core host
INPUT_SETTINGS = ((4, 2), (4, 1), (2, 2), (2, 1), (1, 4), (8, 1))
INPUT_STEPS = FILE_STEPS - 2


def htod_phase() -> dict:
    """Device ms of one batch's host → device copy, by CUDA events: the
    float32 wire's 79.1 MB and the u8 wire's 19.8 MB, from pinned memory
    (as the producer's staging copies, on a side stream) and from pageable
    memory (the step-thread path)."""
    out = {}
    side = torch.cuda.Stream()
    for name, dtype in (("f32", torch.float32), ("u8", torch.uint8)):
        shape = (BATCH, 227, 227, 3)
        pinned = torch.zeros(shape, dtype=dtype).pin_memory()
        pageable = torch.zeros(shape, dtype=dtype)
        dst = torch.empty(shape, dtype=dtype, device="cuda")
        with torch.cuda.stream(side):
            out[f"{name}_pinned_ms"] = time_ms(
                lambda: dst.copy_(pinned, non_blocking=True), reps=5,
                inner=4)
        out[f"{name}_pageable_ms"] = time_ms(lambda: dst.copy_(pageable),
                                             reps=5, inner=4)
        out[f"{name}_mb"] = pinned.numel() * pinned.element_size() / 1e6
        del pinned, pageable, dst
    return out


def input_times() -> dict:
    """``python3 chip_smoke.py --input-times``: host wall per AlexNet b128
    step and the recorder's buckets over INPUT_STEPS steps (after 2 of
    warm-up, the loader's epoch started first), from the batch files under
    ``para_load`` at each INPUT_SETTINGS (pool workers, augment threads),
    both wires, and the synthetic source without ``para_load`` beside
    them; two rounds in turn, so the spread between rounds shows."""
    from theanompi_tpu_torch.utils.recorder import Recorder
    from theanompi_tpu_torch.worker import BSP_Worker
    _kernel_build.build(["lrn"])
    write_batch_files(DATA_DIR, FILE_STEPS, VAL_BATCHES, BATCH)
    rows = []

    def one(cfg, threads=None):
        worker = BSP_Worker(dict(cfg, n_workers=1, batch_size=BATCH, seed=0,
                                 verbose=False))
        try:
            model = worker.build_model("theanompi_tpu_torch.models.alex_net",
                                       "AlexNet")
            model.compile_iter_fns(worker.exchanger)
            if threads is not None:
                model.data._data.aug_threads = threads
            model.data.shuffle_data(0)
            for c in (1, 2):
                model.train_iter(c)
            torch.cuda.synchronize()
            rec = Recorder({"verbose": False})
            t0 = time.time()
            for c in range(3, 3 + INPUT_STEPS):
                model.train_iter(c, rec)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3 / INPUT_STEPS
            if hasattr(model.data, "close"):
                model.data.close()
            del model
        finally:
            worker.close()
            gc.collect()
            torch.cuda.empty_cache()
        return {"wall_ms": wall, "img_per_s": BATCH * 1e3 / wall,
                **{f"{s}_ms": rec.t_sec_total[s] * 1e3 / INPUT_STEPS
                   for s in ("load", "stage", "train")}}

    for rnd in range(2):
        rows.append(dict(one({"synthetic_batches": FILE_STEPS}),
                         round=rnd, source="synthetic"))
        for u8 in (False, True):
            for workers, threads in INPUT_SETTINGS:
                r = one(file_cfg(u8, para_load_workers=workers), threads)
                rows.append(dict(r, round=rnd, source="files", u8=u8,
                                 workers=workers, threads=threads))
                print(json.dumps(rows[-1]), flush=True)
    return {"rows": rows, "htod": htod_phase()}


# what each library yardstick computes, and what of the kernel's work it
# leaves out (B3–B6 have none: no single PyTorch call computes them)
LIBRARY = {
    "lrn_fwd": "F.local_response_norm on the NCHW view",
    "lrn_bwd": "autograd of F.local_response_norm (forward included)",
    "topk_encode": "torch.topk(c2.abs(), 82, dim=1): the selection alone, in "
                   "torch's tie order; no bf16 values, int16 offsets or "
                   "residual state",
    "topk_decode": "zero_() + one index_put_(accumulate=True) over all "
                   "workers' global indices: the scatter alone, atomics' "
                   "order; no bf16 cast, no index arithmetic, no / size",
    "matmul_pack": "torch.matmul (TF32 off) of the same operands, the "
                   "transposed one as a view: no zero-padded tile",
    "flash_fwd": "F.scaled_dot_product_attention(q, k, v, is_causal=True) "
                 "on the same views: o only, no lse",
    "flash_bwd_dkv": "autograd of F.scaled_dot_product_attention: dQ, dK and "
                     "dV in one call (di included), to set against B11 + B12",
    "flash_bwd_dq": "the same call as flash_bwd_dkv's: dQ, dK and dV in one",
    "flash_fwd_f32": "F.scaled_dot_product_attention(q, k, v, is_causal=True) "
                     "in float32 (TF32 off) on the same views: o only",
    "flash_bwd_dkv_f32": "autograd of the float32 F.scaled_dot_product_"
                         "attention: dQ, dK and dV in one, to set against "
                         "B11 + B12",
    "flash_bwd_dq_f32": "the same call as flash_bwd_dkv_f32's",
}

FLASH_SRC = "theanompi_tpu_torch/csrc/flash_attention.cu"
FLASH_F32_SRC = "theanompi_tpu_torch/csrc/flash_attention_f32.cu"
FLASH_TPU = "jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0)"


# -- the operations planes (A10 items 1 and 2) --------------------------------

OPS_STALL_S = 120.0           # a generous stall_timeout: no step stalls it
# the numerics sample against its float64 recomputation on the CPU from
# copies of the sampled step's old params, new params and gradient: the
# norms are float32 sums of squares (positive terms: a relative error of a
# few ulps per level of the reduction), rtol OPS_NORM_RTOL; the digest is a
# float32 sum of signed values, held within OPS_DIGEST_ATOL of
# Σ_leaf w·Σ|x|; max|g|, the nonfinite count and iter are exact
OPS_NORM_RTOL = 1e-5
OPS_DIGEST_ATOL = 4e-6


class InfGradAlexNet(AlexNet):
    """Full-width AlexNet whose step puts one +inf into its first gradient
    leaf, inside the captured step (the model's gradient hook): the
    numerics plane must count it, the sentry raise ``grad_overflow``."""

    def reduce_model_grads(self, grads) -> None:
        g = grads[0]
        g[(0,) * g.dim()].fill_(float("inf"))


def ops_session(modelfile, modelclass, steps, poll_statusz=False, **cfg):
    """``BSP().init(devices=1, ...).wait()`` at ``printFreq`` 1 (a record,
    and with the planes a numerics report, every step), launches counted
    from 0: each step's cost, the state after, the launch counts, the last
    sample buffer, the sentry's anomalies and the watchdog's stalls; with
    ``poll_statusz`` a host thread (no CUDA) finds the worker's statusz
    endpoint in ``record_dir`` while it trains and asks it for ``health``."""
    import threading
    from theanompi_tpu_torch.utils import tracing
    zero_launches()
    rule = tmpi.BSP()
    rule.init(devices=1, modelfile=modelfile, modelclass=modelclass,
              **dict(dict(epochs=1, seed=0, verbose=False, printFreq=1,
                          synthetic_batches=steps,
                          synthetic_val_batches=VAL_BATCHES), **cfg))
    health, halt = {}, threading.Event()

    def poll():
        while not halt.is_set():
            docs = tracing.read_statusz_docs(cfg["record_dir"])
            if docs:
                try:
                    health.update(tracing.statusz_query(
                        f"{docs[0]['host']}:{docs[0]['port']}", "health"))
                    return
                except OSError:
                    pass
            halt.wait(0.02)

    th = threading.Thread(target=poll, daemon=True) if poll_statusz else None
    if th is not None:
        th.start()
    t0 = time.time()
    try:
        rec = rule.wait()
    finally:
        halt.set()
        if th is not None:
            th.join(timeout=10)
    torch.cuda.synchronize()
    m, w = rule.model, rule.worker
    fn = m.train_fn
    out = {"costs": [r["cost"] for r in rec.train_records],
           "secs": time.time() - t0, "launches": launch_counts(),
           "state": host_state(m),
           "sample": fn.nx_buf.cpu().clone() if fn._nx is not None else None,
           "anomalies": list(w.sentry.anomalies) if w.sentry else None,
           "stalls": w.watchdog.stall_count, "health": health,
           "profile": w.device_profile}
    rule.model = rule.worker = None
    del m, w, fn, rule
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ops_same(name: str, ref: dict, run: dict, launches=True) -> int:
    """A planes-on run against the planes-off one, bit for bit: each step's
    cost (a session's as the printed float), every state tensor, and the
    launch counts."""
    if len(ref["costs"]) != len(run["costs"]):
        raise AssertionError(f"{name}: {len(run['costs'])} costs against "
                             f"{len(ref['costs'])}")
    for i, (x, y) in enumerate(zip(ref["costs"], run["costs"])):
        if float(x) != float(y):
            raise AssertionError(f"{name}: cost {i} {float(y)!r} against "
                                 f"{float(x)!r} with the planes off")
    if len(ref["state"]) != len(run["state"]):
        raise AssertionError(f"{name}: {len(run['state'])} state tensors "
                             f"against {len(ref['state'])}")
    for i, (x, y) in enumerate(zip(ref["state"], run["state"])):
        check_bits(f"{name} state tensor {i}", y, x)
    if launches and ref["launches"] != run["launches"]:
        raise AssertionError(f"{name}: launches {run['launches']} against "
                             f"{ref['launches']}")
    return len(ref["state"])


def ops_stream(d: str) -> dict:
    """What a planes-on run left in its ``record_dir``: the events of its
    stream by kind, its numerics reports' iters, the summary sidecar."""
    from collections import Counter
    with open(os.path.join(d, "telemetry_rank0.jsonl")) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(d, "telemetry_summary_rank0.json")) as f:
        summary = json.load(f)
    return {"kinds": dict(Counter(e["ev"] for e in evs)),
            "numerics": [e for e in evs if e["ev"] == "numerics"],
            "summary": summary}


def sample_f64(model, stash) -> dict:
    """The numerics sample of the last sampled step recomputed in float64
    on the CPU from copies of its gradient, its params before the update
    and after (the plan's own digest weights), and Σ_leaf w·Σ|x|."""
    from theanompi_tpu_torch.utils import numerics
    g = [x.double().cpu() for x in stash["g"]]
    old = [x.double().cpu() for x in stash["old"]]
    new = [p.detach().double().cpu() for p in tree_leaves(model.params)]
    w = model.train_fn._nx._digest_weights(stash["g"][0]).double().cpu()

    def norm(xs):
        return float(sum(float((x * x).sum()) for x in xs)) ** 0.5

    pn, un = norm(new), norm([a - b for a, b in zip(new, old)])
    vals = {"iter": float(stash["it"]), "grad_norm": norm(g),
            "grad_max_abs": max(float(x.abs().max()) for x in g),
            "nonfinite": float(sum(int((~torch.isfinite(x)).sum())
                                   for x in g)),
            "param_norm": pn, "update_norm": un, "update_ratio": un / pn,
            "digest": float(sum(float(wi) * float(x.sum())
                                for wi, x in zip(w, new))),
            "beacon": 1.0, "dist_center": 0.0, "ef_norm": 0.0}
    assert list(vals) == list(numerics.SAMPLE_KEYS)
    return {"vals": vals, "digest_scale": float(sum(
        float(wi) * float(x.abs().sum()) for wi, x in zip(w, new)))}


def stash_probe(model):
    """``drive``'s probe: the numerics plan's gradient and old-params copies
    of each sampled step kept on the card (the last one's), then
    :func:`sample_f64` and the sample buffer after the last call."""
    plan, stash = model.train_fn._nx, {}
    grad_stats, keep_old = plan.grad_stats, plan.keep_old

    def gs(grads):
        stash["g"] = [g.detach().clone() for g in grads]
        stash["it"] = float(model.train_fn._nx_it)
        return grad_stats(grads)

    def ko(params):
        old = keep_old(params)
        stash["old"] = [t.clone() for t in old]
        return old

    plan.grad_stats, plan.keep_old = gs, ko
    return lambda: dict(sample_f64(model, stash),
                        sample=model.train_fn.nx_buf.cpu().clone())


def check_sample(name, sample, ref: dict) -> dict:
    """The card's sample against its float64 recomputation."""
    from theanompi_tpu_torch.utils import numerics
    got = dict(zip(numerics.SAMPLE_KEYS, sample.reshape(-1).tolist()))
    errs = {}
    for k, want in ref["vals"].items():
        err = abs(got[k] - want)
        lim = OPS_DIGEST_ATOL * ref["digest_scale"] if k == "digest" else (
            OPS_NORM_RTOL * abs(want) if k in ("grad_norm", "param_norm",
                                               "update_norm", "update_ratio")
            else 0.0)
        if not err <= lim:
            raise AssertionError(f"{name}: sample {k} {got[k]!r} against "
                                 f"float64 {want!r} (|diff| {err:.3e}, "
                                 f"limit {lim:.3e})")
        errs[k] = err / lim if lim else 0.0
    return errs


# the traced ops session's trace directory
OPS_TRACE = os.path.join("build", "smoke_ops", "trace")


def ops_trace_check(r: dict, st: dict) -> dict:
    """The traced every-1 session's devprof profile: 4 train dispatches
    (the window, steps 3–6), one lane (the card), compute on it, the
    ``device.*`` gauges in the summary; prints the top ops and the comm
    ops NCCL shows at world 1 (a collective there may be a copy)."""
    from theanompi_tpu_torch.utils import devprof
    prof = r["profile"]
    if prof is None or prof["train_dispatches"] != 4 or \
            prof["lanes"] != 1 or not prof["compute_secs"] > 0:
        raise AssertionError(f"devprof profile of the traced session: "
                             f"{prof and {k: v for k, v in prof.items() if k != 'top_ops'}}")
    want = {g for g, k in zip(devprof.DEVICE_GAUGES,
                              ("compute_secs", "comm_secs",
                               "exposed_comm_secs", "overlap_ratio",
                               "lanes")) if prof[k] is not None}
    gauges = set(st["summary"]["gauges"])
    if not want <= gauges:
        raise AssertionError(f"device gauges {sorted(gauges)}, want "
                             f"{sorted(want)}")
    comm = sorted({o["op"] for o in prof["top_ops"] if o["comm"]})
    print("devprof top ops: " + "; ".join(
        f"{o['op'][:70]} {o['secs'] * 1e3:.3f} ms x{o['count']}"
        for o in prof["top_ops"][:5]) + f"; NCCL comm ops at world 1: "
        f"{comm or 'none'} (comm {prof['comm_secs']:.6f} s); modules "
        f"{ {k: v['compute_secs'] for k, v in prof['modules'].items()} }",
        flush=True)
    return {"train_dispatches": prof["train_dispatches"],
            "lanes": prof["lanes"], "compute_secs": prof["compute_secs"],
            "compute_ms_per_dispatch":
                prof["compute_secs"] * 1e3 / prof["train_dispatches"],
            "comm_secs": prof["comm_secs"], "comm_ops": comm,
            "bubble_fraction": prof["bubble_fraction"],
            "n_op_events": prof["n_op_events"],
            "top_ops": prof["top_ops"][:5], "modules": prof["modules"],
            "trace_secs": prof["trace_secs"],
            "trace_bytes": prof["trace_bytes"], "secs": r["secs"]}


def ops_main(card: str) -> dict:
    """The operations planes on the card (``--ops``): AlexNet b128 under
    BSP, captured, with record_dir, telemetry, tracing, the numerics plane
    (every 1, then every 4), a generous stall_timeout and the sentry,
    against the same steps with every plane off (graph_eager_phase's
    captured drive, or a new one): costs, params and optimizer state bit
    for bit, the same launches; the stream's events, the numerics reports'
    iters on the JAX cadence, the summary sidecar, a statusz health reply;
    the eager step's sample (and state) bit for bit the captured one's and
    within its float64 recomputation; spc 4 at every 3 (iter 6, the state
    bit for bit); VGG-16 onebit with numerics (ef_norm against the error
    state read directly, B4–B6 as before); one injected +inf (nonfinite,
    ``grad_overflow``, one flight dump); and the step's wall and busy ms
    with the planes off, at every 4 and at every 1."""
    from theanompi_tpu_torch.utils import numerics
    t_group = time.time()
    out = {}
    secs = out["phase_s"] = {}
    t_phase = [time.time()]

    def lap(name):
        secs[name] = time.time() - t_phase[0]
        t_phase[0] = time.time()
    alex_file, alex_cls = GRAPH_PATHS["alexnet"][:2]
    root = os.path.join("build", "smoke_ops")
    shutil.rmtree(root, ignore_errors=True)
    planes = dict(telemetry=True, tracing=True, numerics=True,
                  stall_timeout=OPS_STALL_S, sentry=True)
    alex_want = expect(lrn_fwd_cuda=2 * (GRAPH_STEPS + VAL_BATCHES),
                       lrn_bwd_cuda=2 * GRAPH_STEPS)
    torch.backends.cudnn.deterministic = True
    try:
        # the planes-off reference, made with cuDNN deterministic
        ref = captured_run("alexnet")
        lap("reference")
        runs = {}
        for every in (1, 4):
            d = os.path.join(root, f"every{every}")
            # the every-1 session traced (its graph captured at step 1, so
            # the window replays it): devprof's window, read below
            trace = dict(trace_dir=OPS_TRACE, trace_start=3,
                         trace_iters=4) if every == 1 else {}
            r = runs[every] = ops_session(
                alex_file, alex_cls, GRAPH_STEPS, poll_statusz=True,
                batch_size=BATCH, record_dir=d, numerics_every=every,
                **planes, **trace)
            n = ops_same(f"AlexNet planes on (every {every}) vs off", ref, r,
                         launches=False)
            if r["launches"] != alex_want:
                raise AssertionError(f"AlexNet planes on: launches "
                                     f"{r['launches']}, expected {alex_want}")
            st = ops_stream(d)
            want_kinds = {"run_start", "train_begin", "phase", "train_record",
                          "gauges", "numerics", "val_record", "statusz",
                          "train_end"}
            if trace:
                want_kinds.add("device_profile")
                if st["kinds"]["device_profile"] != 1:
                    raise AssertionError(f"stream every {every}: "
                                         f"{st['kinds']}")
                out["traced"] = ops_trace_check(r, st)
            if not want_kinds <= set(st["kinds"]):
                raise AssertionError(f"stream every {every}: {st['kinds']}")
            iters = [e["iter"] for e in st["numerics"]]
            want_iters = [c for c in range(1, GRAPH_STEPS + 1)
                          if c % every == 0]
            if iters != want_iters:
                raise AssertionError(f"numerics iters at every {every}: "
                                     f"{iters}, the JAX cadence {want_iters}")
            if any(e["nonfinite"] or e["divergence"] is not None
                   for e in st["numerics"]):
                raise AssertionError(f"numerics reports: {st['numerics']}")
            hist = st["summary"]["hist"]
            if hist.get("phase.train", {}).get("count") != GRAPH_STEPS:
                raise AssertionError(f"summary: {sorted(hist)}")
            h = r["health"]
            if not (h.get("ok") and h.get("role") == "worker"
                    and "uptime_s" in h):
                raise AssertionError(f"statusz health: {h}")
            bad = [a for a in r["anomalies"] or []
                   if a[0] != "throughput_regression"]
            if bad or r["stalls"]:
                raise AssertionError(f"sentry {r['anomalies']}, "
                                     f"{r['stalls']} stalls")
            out[f"every{every}"] = {
                "tensors": n, "secs": r["secs"], "kinds": st["kinds"],
                "numerics_iters": iters, "health": h,
                "anomalies": r["anomalies"],
                "last_report": st["numerics"][-1]}
            print(f"ops planes, AlexNet b{BATCH} every {every}: {n} state "
                  f"tensors and {GRAPH_STEPS} costs bit for bit the "
                  f"planes-off run, launches as before, numerics at iters "
                  f"{iters}, stream {st['kinds']}, statusz health up "
                  f"{h['uptime_s']} s, sentry {r['anomalies']}", flush=True)
            lap(f"session_every{every}")
        # the eager step: its state the captured planes-off run's, its
        # sample the captured one's, and the float64 recomputation
        eager = drive("alexnet", False, GRAPH_STEPS, probe=stash_probe,
                      numerics=True)
        ops_same("AlexNet eager planes on vs captured off", ref, eager)
        check_bits("AlexNet sample eager vs captured",
                   eager["probe"]["sample"], runs[1]["sample"])
        errs = check_sample("AlexNet sample vs float64",
                            eager["probe"]["sample"], eager["probe"])
        out["eager"] = {"sample": dict(zip(
            numerics.SAMPLE_KEYS, eager["probe"]["sample"][0].tolist())),
            "err_over_limit": errs}
        print(f"ops planes: the eager step's sample bit for bit the captured "
              f"one's, state bit for bit; against float64 (err / limit): "
              + ", ".join(f"{k} {v:.3f}" for k, v in errs.items() if v),
              flush=True)
        lap("eager")
        # spc 4 at every 3: the window ending at 8 samples count 6
        spc4 = drive("alexnet", True, GRAPH_STEPS // SPC, spc=SPC,
                     numerics=True, numerics_every=3,
                     probe=lambda m: lambda: numerics.host_report(
                         numerics.to_host(m.numerics_aux)))
        ops_same("AlexNet spc 4 every 3 vs single steps off",
                 {"costs": [], "state": ref["state"]},
                 dict(spc4, costs=[]), launches=False)
        if spc4["probe"]["iter"] != 6:
            raise AssertionError(f"spc 4 every 3: iter {spc4['probe']}")
        out["spc4_every3_iter"] = spc4["probe"]["iter"]
        print(f"ops planes: spc {SPC} every 3, the state bit for bit, the "
              f"window's sample iter {spc4['probe']['iter']}", flush=True)
        del eager, spc4
        lap("spc4")
        # VGG-16 onebit: ef_norm against the error state read directly
        vref = captured_run("vgg16_onebit")
        lap("vgg16_reference")

        def ef_probe(m):
            return lambda: {
                "ef_norm": numerics.host_report(numerics.to_host(
                    m.numerics_aux))["ef_norm"],
                "direct": float(m.extra["strat"].double().norm())}

        vgg = drive("vgg16_onebit", True, GRAPH_STEPS, probe=ef_probe,
                    numerics=True)
        n = ops_same("VGG-16 onebit numerics on vs off", vref, vgg)
        ef = vgg["probe"]
        if not abs(ef["ef_norm"] - ef["direct"]) <= \
                OPS_NORM_RTOL * ef["direct"] or ef["direct"] <= 0:
            raise AssertionError(f"VGG-16 onebit ef_norm {ef}")
        out["vgg16_onebit"] = dict(ef, tensors=n, launches={
            k: v for k, v in vgg["launches"].items() if v})
        print(f"ops planes, VGG-16 onebit b{VGG_BATCH}: {n} state tensors "
              f"bit for bit, launches {out['vgg16_onebit']['launches']} as "
              f"before, ef_norm {ef['ef_norm']:.6f} against the error "
              f"state's {ef['direct']:.6f}", flush=True)
        del vgg
        lap("vgg16")
        # one +inf in a gradient leaf
        d = os.path.join(root, "inf")
        r = ops_session("chip_smoke", "InfGradAlexNet", 1, batch_size=BATCH,
                        record_dir=d, **planes)
        st = ops_stream(d)
        flights = sorted(f for f in os.listdir(d) if f.startswith("flight"))
        with open(os.path.join(d, flights[0])) as f:
            head = json.loads(f.readline())
        counters = st["summary"]["counters"]
        if not (st["numerics"] and st["numerics"][0]["nonfinite"] > 0
                and r["anomalies"] == [("grad_overflow", 1)]
                and flights == ["flight_rank0.jsonl"]
                and head["reason"].startswith("sentry grad_overflow")
                and counters.get("sentry.anomalies") == 1):
            raise AssertionError(f"injected inf: report {st['numerics']}, "
                                 f"anomalies {r['anomalies']}, flights "
                                 f"{flights} {head}, counters {counters}")
        out["inf"] = {"nonfinite": st["numerics"][0]["nonfinite"],
                      "anomalies": r["anomalies"], "flight": head["reason"]}
        print(f"ops planes: one injected +inf: nonfinite "
              f"{out['inf']['nonfinite']}, sentry {r['anomalies']}, one "
              f"flight dump ({head['reason']})", flush=True)
        lap("inf")
    finally:
        torch.backends.cudnn.deterministic = False
    # the planes' cost: the captured step with them off, at every 4, every
    # 1, and off again (the spread of two runs of one tree)
    cost = {}
    for key, cfg in (("off", {}), ("every4", dict(numerics=True,
                                                  numerics_every=4)),
                     ("every1", dict(numerics=True)), ("off_again", {})):
        p = step_profile_phase(alex_file, alex_cls, BATCH, {"lrn": ("lrn_",)},
                               GRAPH_STEPS, telemetry=bool(cfg), **cfg)
        cost[key] = {k: p[k] for k in ("wall_ms_per_step",
                                       "device_busy_ms_per_step",
                                       "device_idle_share",
                                       "kernel_calls_per_step")}
    extra = cost["every1"]["kernel_calls_per_step"] - \
        cost["off"]["kernel_calls_per_step"]
    out["cost"] = dict(cost, sampled_extra_ops=extra, card=card)
    # devprof's compute per dispatch against the profile's busy ms a step
    # of the same planes setting (every 1, captured)
    tr = out["traced"]
    busy = cost["every1"]["device_busy_ms_per_step"]
    ratio = tr["compute_ms_per_dispatch"] / busy
    tr.update(profile_busy_ms_per_step=busy, ratio=ratio)
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"devprof compute {tr['compute_ms_per_dispatch']}"
                             f" ms a dispatch against the profile's busy "
                             f"{busy} ms a step: ratio {ratio}")
    print(f"devprof, AlexNet b{BATCH} every 1, traced window of "
          f"{tr['train_dispatches']} dispatches: compute "
          f"{tr['compute_ms_per_dispatch']:.4f} ms a dispatch (the union of "
          f"the card's device ops over its streams) against the profile's "
          f"busy {busy:.4f} ms a step (the sum of its device events' "
          f"times: overlapping events counted twice), ratio {ratio:.4f}; "
          f"{tr['lanes']} lane, bubble {tr['bubble_fraction']}; the traced "
          f"session {tr['secs']:.1f} s against the untraced every-4 one's "
          f"{runs[4]['secs']:.1f} s, the window's host seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in tr["trace_secs"].items())
          + f", trace {tr['trace_bytes'] / 1e6:.2f} MB gzipped; on {card}",
          flush=True)
    print("ops planes cost, AlexNet b%d captured step: " % BATCH + "; ".join(
        f"{k} wall {c['wall_ms_per_step']:.3f} ms, busy "
        f"{c['device_busy_ms_per_step']:.3f} ms, "
        f"{c['kernel_calls_per_step']:.0f} device ops"
        for k, c in cost.items())
        + f"; a sampled step adds {extra:.0f} device ops; on {card}",
        flush=True)
    lap("cost")
    out["secs"] = time.time() - t_group
    print(f"ops planes group: {out['secs']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + ")", flush=True)
    return out


# -- the port's tools (A13) -----------------------------------------------------

TOOLS_DIR = os.path.join(HERE, "build", "smoke_tools")
TOOLS_PROFILE_ITERS = 5          # the traced dispatches of profile_model
SWEEP_WARMUP, SWEEP_ITERS = 2, 8
# the ratio of devprof's compute a dispatch to the profiler's busy ms a
# step (the ops group's bound on its traced session)
DEVPROF_RATIO = (0.9, 1.1)


def run_tool(main, argv) -> str:
    """A tool's ``main(argv)`` in this process, its standard output
    captured; raises on a nonzero exit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} exited {rc}:\n"
                             f"{buf.getvalue()[-3000:]}")
    return buf.getvalue()


def tools_profile_phase(busy: dict) -> dict:
    """``tools.profile_model alexnet 128 5 --json``: AlexNet b128 BSP,
    captured, 5 traced dispatches after the profiler's warm-up.  Its
    launches (5 warm-up calls, the warm-up dispatch and the window: B1 and
    B2 twice a call), one lane, B1 and B2 in the trace twice a dispatch
    (their places among its op classes by device time reported),
    and devprof's compute a dispatch within ``DEVPROF_RATIO`` of
    ``busy``'s device busy ms a step less its host → device copies (the
    tool replays one staged batch; ``busy`` is the AlexNet synthetic
    row's profile, whose steps each copy their batch)."""
    from theanompi_tpu_torch.tools import profile_model
    from theanompi_tpu_torch.utils import devprof
    path = os.path.join(TOOLS_DIR, "profile_alexnet.json")
    trace = os.path.join(TOOLS_DIR, "profile_trace")
    shutil.rmtree(trace, ignore_errors=True)
    saved = os.environ.get("PROFILE_DIR")
    os.environ["PROFILE_DIR"] = trace
    zero_launches()
    try:
        text = run_tool(profile_model.main, [
            "alexnet", str(BATCH), str(TOOLS_PROFILE_ITERS), "--json", path])
    finally:
        if saved is None:
            os.environ.pop("PROFILE_DIR")
        else:
            os.environ["PROFILE_DIR"] = saved
    calls = 6 + TOOLS_PROFILE_ITERS
    launches = launch_counts()
    want = expect(lrn_fwd_cuda=2 * calls, lrn_bwd_cuda=2 * calls)
    if launches != want:
        raise AssertionError(f"profile_model launches {launches}, expected "
                             f"{want}")
    with open(path) as f:
        doc = json.load(f)
    if doc["train_dispatches"] != TOOLS_PROFILE_ITERS or doc["lanes"] != 1 \
            or not doc["compute_secs"] > 0 or doc["platform"] != "gpu":
        raise AssertionError(f"profile_model: "
                             f"{ {k: v for k, v in doc.items() if k != 'top_ops'} }")
    events = devprof.load_dir_events(trace)
    lrn = {k: [e for e in events if devprof.is_device_op(e)
               and k in e.get("name", "")]
           for k in ("lrn_fwd_kernel", "lrn_bwd_kernel")}
    for k, evs in lrn.items():
        if len(evs) != 2 * TOOLS_PROFILE_ITERS or \
                not all(e.get("dur", 0) > 0 for e in evs):
            names = sorted({devprof.op_class(e.get("name", ""))
                            for e in events if devprof.is_device_op(e)})
            raise AssertionError(f"profile_model trace: {len(evs)} {k} "
                                 f"events, expected "
                                 f"{2 * TOOLS_PROFILE_ITERS}; device ops "
                                 f"{names[:40]}")
    # B1's and B2's places among the window's op classes by device time
    # (devprof's ``top_ops`` keeps the first 15, the JAX schema's cut)
    totals = {}
    for e in events:
        if devprof.is_device_op(e):
            c = devprof.op_class(e.get("name", ""))
            totals[c] = totals.get(c, 0.0) + float(e.get("dur", 0.0))
    order = sorted(totals, key=lambda c: -totals[c])
    ranks = {k: next(i + 1 for i, c in enumerate(order) if k in c)
             for k in lrn}
    compute_ms = doc["compute_secs"] * 1e3 / doc["train_dispatches"]
    busy_ms = busy["device_busy_ms_per_step"] - busy["htod_ms_per_step"]
    ratio = compute_ms / busy_ms
    if not DEVPROF_RATIO[0] <= ratio <= DEVPROF_RATIO[1]:
        raise AssertionError(f"profile_model compute {compute_ms} ms a "
                             f"dispatch against the profiler's busy "
                             f"{busy_ms} ms a step: ratio {ratio}")
    return {"compute_ms_per_dispatch": compute_ms,
            "profiler_busy_ms_per_step": busy_ms, "ratio": ratio,
            "lrn_op_class_rank": ranks, "op_classes": len(order),
            "lrn_ms_per_dispatch": {k: sum(e["dur"] for e in evs) / 1e3
                                    / TOOLS_PROFILE_ITERS
                                    for k, evs in lrn.items()},
            "top_ops": doc["top_ops"][:6], "launches": {
                k: v for k, v in launches.items() if v},
            "printed": text.splitlines()[0]}


def tools_sweep_phase() -> dict:
    """``tools.scaling_sweep --model alexnet --batch-size 128 --strategies
    allreduce onebit --json`` at world 1: a row a strategy with the card
    named, and the launches of both runs (B1/B2 twice a step each; the
    onebit wire's B4, B5 and B6 once a step, B3 not on the step)."""
    from theanompi_tpu_torch.tools import scaling_sweep
    zero_launches()
    text = run_tool(scaling_sweep.main, [
        "--model", "alexnet", "--batch-size", str(BATCH), "--strategies",
        "allreduce", "onebit", "--iters", str(SWEEP_ITERS), "--warmup",
        str(SWEEP_WARMUP), "--json"])
    launches = launch_counts()
    n = SWEEP_WARMUP + SWEEP_ITERS
    want = expect(lrn_fwd_cuda=2 * 2 * n, lrn_bwd_cuda=2 * 2 * n,
                  pack_signs_encode_cuda=n, signed_residual_cuda=n,
                  unpack_signs_wsum_cuda=n)
    if launches != want:
        raise AssertionError(f"scaling_sweep launches {launches}, expected "
                             f"{want}")
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    if [(r["strategy"], r["workers"]) for r in rows] != \
            [("allreduce", 1), ("onebit", 1)] or \
            not all(r["images_per_sec"] > 0 and r.get("card") for r in rows):
        raise AssertionError(f"scaling_sweep rows {rows}")
    return {"rows": rows,
            "launches": {k: v for k, v in launches.items() if v}}


def tools_loader_phase() -> dict:
    """``tools.loader_bench --prefetch --u8-wire`` over the ``para_load``
    phase's batch files (written again unless there): the host pipeline's
    images and GB a second, and the pinned staging rate to the card."""
    from theanompi_tpu_torch.tools import loader_bench
    loader_bench.ensure_dataset(FILE_STEPS, BATCH, DATA_DIR, VAL_BATCHES)
    text = run_tool(loader_bench.main, [
        "--data-dir", DATA_DIR, "--batches", str(FILE_STEPS),
        "--batch-size", str(BATCH), "--epochs", "2", "--prefetch",
        "--u8-wire"])
    out = json.loads(text.strip().splitlines()[-1])
    if out["images"] != (2 * FILE_STEPS - 1) * BATCH or \
            not out["value"] > 0 or not out["staging_gb_per_sec"] > 0 or \
            not out.get("card"):
        raise AssertionError(f"loader_bench: {out}")
    return out


def tools_async_sync_phase() -> dict:
    """``tools.async_vs_sync_easgd --seconds 10``: Cifar10 b16, 20
    synchronous-cadence EASGD steps at world 1 against 2 island threads
    sharing the card for 10 s; both rates positive, the note saying the
    ratio is a harness check."""
    from theanompi_tpu_torch.tools import async_vs_sync_easgd
    text = run_tool(async_vs_sync_easgd.main, [
        "--seconds", "10", "--steps", "20",
        "--out", os.path.join(TOOLS_DIR, "async_vs_sync_easgd.json")])
    out = json.loads(text.strip().splitlines()[-1])
    if not (out["sync_easgd_samples_per_sec"] > 0
            and out["async_islands_samples_per_sec"] > 0
            and "harness check" in out["note"] and out.get("card")):
        raise AssertionError(f"async_vs_sync_easgd: {out}")
    return out


def tools_rules_phase() -> dict:
    """``tools.rules_time_to_acc 0.5 --epochs 2`` at world 1 on Cifar10
    synthetic (512 training, 128 validation samples, b16): a row a rule,
    two finite validation costs each, the card in ``platform``."""
    from theanompi_tpu_torch.tools import rules_time_to_acc
    path = os.path.join(TOOLS_DIR, "rules_time_to_acc.json")
    run_tool(rules_time_to_acc.main, [
        "0.5", "--epochs", "2", "--synthetic-train", "512",
        "--synthetic-val", "128", "--out", path])
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    if [r["rule"] for r in rows] != ["BSP", "EASGD", "ASGD", "GOSGD"] or \
            not all(len(r["val_cost_by_epoch"]) == 2
                    and all(np.isfinite(r["val_cost_by_epoch"]))
                    and r["platform"].startswith("gpu") for r in rows):
        raise AssertionError(f"rules_time_to_acc rows {rows}")
    return {r["rule"]: {k: r[k] for k in ("acc_by_epoch",
                                          "val_cost_by_epoch",
                                          "wall_secs_total", "platform")}
            for r in rows}


def tools_main(card: str, busy: dict) -> dict:
    """The tools group (``--tools``): the port's tools run in this process
    as a user runs them (``main(argv)``), on the card; ``busy`` is the
    AlexNet synthetic row's profile.  Prints each tool's numbers and the
    group's seconds by phase."""
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    out, secs = {}, {}
    t_group = time.time()
    for name, fn, args in (("profile_model", tools_profile_phase, (busy,)),
                           ("scaling_sweep", tools_sweep_phase, ()),
                           ("loader_bench", tools_loader_phase, ()),
                           ("async_vs_sync_easgd", tools_async_sync_phase,
                            ()),
                           ("rules_time_to_acc", tools_rules_phase, ())):
        t0 = time.time()
        out[name] = fn(*args)
        secs[name] = time.time() - t0
        gc.collect()
        torch.cuda.empty_cache()
    p = out["profile_model"]
    print(f"tools.profile_model AlexNet b{BATCH} BSP captured, "
          f"{TOOLS_PROFILE_ITERS} traced dispatches: devprof compute "
          f"{p['compute_ms_per_dispatch']:.4f} ms a dispatch against the "
          f"profiler's busy {p['profiler_busy_ms_per_step']:.4f} ms a step "
          f"(less its HtoD copy), ratio {p['ratio']:.4f}; B1/B2 "
          + ", ".join(f"{k} {ms:.4f} ms a dispatch (op class "
                      f"#{p['lrn_op_class_rank'][k]} of {p['op_classes']})"
                      for k, ms in p["lrn_ms_per_dispatch"].items())
          + f"; launches {p['launches']} on {card}", flush=True)
    print("tools.scaling_sweep AlexNet b%d world 1: " % BATCH + "; ".join(
        f"{r['strategy']} {r['images_per_sec']:.1f} img/s "
        f"({r['time_per_5120']:.3f} s/5120)"
        for r in out["scaling_sweep"]["rows"])
        + f"; launches {out['scaling_sweep']['launches']} on {card}",
        flush=True)
    lb = out["loader_bench"]
    print(f"tools.loader_bench {lb['metric']}: {lb['value']:.1f} img/s, "
          f"{lb['gb_per_sec_out']:.3f} GB/s out of the host pipeline; "
          f"pinned staging to the card {lb['staging_images_per_sec']:.1f} "
          f"img/s, {lb['staging_gb_per_sec']:.3f} GB/s on {card}",
          flush=True)
    av = out["async_vs_sync_easgd"]
    print(f"tools.async_vs_sync_easgd Cifar10 b{av['batch_per_chip']}: sync "
          f"{av['sync_easgd_samples_per_sec']:.1f} samples/s, "
          f"{av['islands']} islands {av['async_islands_samples_per_sec']:.1f}"
          f", ratio {av['async_over_sync']:.3f} ({av['note']}) on {card}",
          flush=True)
    print("tools.rules_time_to_acc Cifar10 world 1, 2 epochs: " + "; ".join(
        f"{k} acc {r['acc_by_epoch']} val cost "
        f"{[round(c, 4) for c in r['val_cost_by_epoch']]} in "
        f"{r['wall_secs_total']:.1f} s" for k, r in
        out["rules_time_to_acc"].items()) + f" on {card}", flush=True)
    out["phase_s"] = secs
    out["secs"] = time.time() - t_group
    print(f"tools group: {out['secs']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + ")", flush=True)
    return out


def kernel_rows():
    """(label, wrapper, source, TPU kernel it replaces) of B1–B12 (built
    at use: ``--factor-times`` also runs on trees from before
    ``matmul_pack_group_cuda``)."""
    return (
        ("lrn_fwd", lrn_ops.lrn_fwd_cuda, "theanompi_tpu_torch/csrc/lrn.cu",
         "theanompi_tpu/ops/lrn.py:130 _lrn_fwd_pallas"),
        ("lrn_bwd", lrn_ops.lrn_bwd_cuda, "theanompi_tpu_torch/csrc/lrn.cu",
         "theanompi_tpu/ops/lrn.py:152 _lrn_bwd_pallas"),
        ("pack_signs", cmp_ops.pack_signs_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:200 _pack_pallas"),
        ("unpack_signs_wsum", cmp_ops.unpack_signs_wsum_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:234 _unpack_wsum_pallas"),
        ("pack_signs_encode", cmp_ops.pack_signs_encode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:268 _encode_pallas"),
        ("signed_residual", cmp_ops.signed_residual_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:307 _residual_pallas"),
        ("topk_encode", cmp_ops.topk_encode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:362 _topk_encode_pallas"),
        ("topk_decode", cmp_ops.topk_decode_cuda,
         "theanompi_tpu_torch/csrc/compress.cu",
         "theanompi_tpu/ops/compress.py:402 _topk_decode_pallas"),
        ("matmul_pack", fp_ops.matmul_pack_group_cuda,
         "theanompi_tpu_torch/csrc/factor_pack.cu",
         "theanompi_tpu/ops/factor_pack.py:66 _matmul_pack_pallas"),
        # JAX's packaged kernel, which theanompi_tpu/models/layers.py:459-464
        # calls for attn_impl='flash'
        ("flash_fwd", fa_ops.flash_fwd_cuda, FLASH_SRC,
         f"{FLASH_TPU}:589 _flash_attention_impl (pallas_call :758)"),
        ("flash_bwd_dkv", fa_ops.flash_bwd_dkv_cuda, FLASH_SRC,
         f"{FLASH_TPU}:941 _flash_attention_bwd_dkv (pallas_call :1121)"),
        ("flash_bwd_dq", fa_ops.flash_bwd_dq_cuda, FLASH_SRC,
         f"{FLASH_TPU}:1287 _flash_attention_bwd_dq (pallas_call :1456)"),
        # the same three in float32 (A11), as the JAX package hands them q,
        # k and v in compute_dtype (theanompi_tpu/models/layers.py:457-467)
        ("flash_fwd_f32", fa_ops.flash_fwd_f32_cuda, FLASH_F32_SRC,
         f"{FLASH_TPU}:589 _flash_attention_impl (pallas_call :758)"),
        ("flash_bwd_dkv_f32", fa_ops.flash_bwd_dkv_f32_cuda, FLASH_F32_SRC,
         f"{FLASH_TPU}:941 _flash_attention_bwd_dkv (pallas_call :1121)"),
        ("flash_bwd_dq_f32", fa_ops.flash_bwd_dq_f32_cuda, FLASH_F32_SRC,
         f"{FLASH_TPU}:1287 _flash_attention_bwd_dq (pallas_call :1456)"),
    )


TIMED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms")


def lrn_totals(rows) -> dict:
    """One step's B1 or B2 over a model's two LRN shapes (the timed bf16
    rows): ms, plain, bound and library summed, the worst error of every
    row checked."""
    timed = [r for r in rows if "ms" in r]
    tot = {k: sum(r[k] for r in timed)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    tot["bound_by"] = "bytes" if sum(r["bytes_ms"] for r in timed) >= \
        sum(r["ops_ms"] for r in timed) else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return tot


def kernel_entries(lrn, lrn_g, comp, topk, fpack, flash, alex, goog, vggs,
                   lm, f32, stage=None, ep=None) -> list:
    out = []
    for label, fn, source, replaces in kernel_rows():
        name = fn.__name__
        e = {"name": label, "route": "cuda", "source": source,
             "replaces": replaces, "library": LIBRARY.get(label)}
        if label in DESIGN:
            e["design"] = DESIGN[label]
        if label.startswith("lrn_"):
            # one step: lrn1 + lrn2 of AlexNet's main path; GoogLeNet's
            # two shapes beside it
            kind = label[4:]
            e.update(launches=alex["launches"][name],
                     launches_from="AlexNet main path", **lrn_totals(
                         lrn[kind]), shapes=lrn[kind] + lrn_g[kind],
                     googlenet=dict(lrn_totals(lrn_g[kind]),
                                    launches=goog["launches"][name]))
        elif label == "matmul_pack":
            # per PowerSGD step: two grouped passes over the 16 leaves
            e.update(launches=vggs["powersgd"]["launches"][name],
                     launches_from="VGG-16 powersgd main path",
                     max_abs_err=fpack["max_abs_err"],
                     max_err_over_bound=fpack["max_err_over_bound"],
                     per="one step: 2 grouped launches, 32 products",
                     per_leaf_ms=fpack["per_step"]["per_leaf_ms"],
                     **{k: fpack["per_step"][k] for k in TIMED[1:]})
        elif label.endswith("_f32"):
            e.update(launches=f32["main"]["launches"][name],
                     launches_from="float32 LM main path",
                     shape=f32["kernels"]["shape"],
                     host_us=f32["kernels"][name]["host_us"],
                     bound_rate="split TF32, 495/3 TFLOP/s",
                     ffma_bound_ms=f32["kernels"][name]["ffma_bound_ms"],
                     **{k: f32["kernels"][name][k] for k in TIMED})
        elif label.startswith("flash_"):
            e.update(launches=lm["launches"][name],
                     launches_from="LM main path", shape=flash["shape"],
                     host_us=flash[name]["host_us"],
                     **{k: flash[name][k] for k in TIMED})
        elif label.startswith("topk_"):
            e.update(launches=vggs["topk"]["launches"][name],
                     launches_from="VGG-16 topk main path",
                     rows=topk["rows"], chunk=topk["chunk"], k=topk["k"],
                     **{k: topk[name][k] for k in TIMED})
            if label == "topk_decode":
                e["by_workers"] = topk["decode"]
        else:
            r = comp[name]
            if label == "pack_signs":
                # on no training path: the compress phase's check launch
                e.update(launches=comp["checked_launches"][name],
                         launches_from="compress phase")
            else:
                e.update(launches=vggs["onebit"]["launches"][name],
                         launches_from="VGG-16 onebit main path")
            e.update({k: r[k] for k in TIMED[:-1]}, library_ms=None,
                     n=comp["n"])
            if label == "unpack_signs_wsum":
                e["by_workers"] = comp["decode"]
        if label.startswith("flash_") and stage is not None:
            # the same kernel at a pipeline stage's microbatch shape, and
            # its launches in one stage's step of the pp stage path
            r = stage["f32" if label.endswith("_f32") else "bf16"][name]
            e["pp_stage"] = dict(
                shape=stage["path"]["shape"],
                launches=stage["path"]["launches"][name],
                launches_from="pp stage path (pipeline_apply)",
                **{k: r[k] for k in ("ms", "bound_ms", "plain_ms",
                                      "library_ms", "max_abs_err")})
        if label.startswith("flash_") and ep is not None:
            # at a tp rank's heads, and its launches in the two rank
            # parts of the ep rank path
            r = ep["f32" if label.endswith("_f32") else "bf16"][name]
            e["tp_rank"] = dict(
                shape=ep["path"]["shape"],
                launches=ep["path"]["launches"][name],
                launches_from="ep rank path (two rank parts)",
                **{k: r[k] for k in ("ms", "bound_ms", "plain_ms",
                                      "library_ms", "max_abs_err")})
        out.append(e)
    return out


def main() -> int:
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.time()
    laps = {}

    def lap(name):
        """Seconds since the previous lap, for the run's phase table."""
        laps[name] = time.time() - t_all - sum(laps.values())

    phase_s = {}

    def timed(name, fn, *args, **kw):
        """``fn(*args, **kw)``, its seconds kept under ``name`` for the
        run's table of the leading groups' phases."""
        t0 = time.time()
        out = fn(*args, **kw)
        phase_s[name] = time.time() - t0
        return out

    libs = _kernel_build.build()
    build_s = time.time() - t_all
    print(f"built {sorted(libs)} in {build_s:.1f}s", flush=True)

    lrn_sass = lrn_sass_check(libs["lrn"])
    print(f"LRN SASS: every vector build of lrn_bwd_kernel holds {LRN_SASS} "
          f"({lrn_sass})", flush=True)
    lap("build, SASS")
    lrn = lrn_phase()
    lrn_g = lrn_phase(GOOGLENET_LRN)
    for kind in ("fwd", "bwd"):
        print(f"LRN {kind} at GoogLeNet's shapes: " + ", ".join(
            f"{r['shape']} {r['dtype']} max |diff| {r['max_abs_err']:.3e}"
            + (f", {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain "
               f"{r['plain_ms']:.3f}, library {r['library_ms']:.3f})"
               if "ms" in r else "") for r in lrn_g[kind]), flush=True)
    comp = compress_phase()
    print("compress (n=%d): " % comp["n"] + ", ".join(
        f"{k[:-5]} {comp[k]['ms']:.4f} ms (bound {comp[k]['bound_ms']:.4f}, "
        f"plain {comp[k]['plain_ms']:.3f})" for k in
        ("pack_signs_cuda", "pack_signs_encode_cuda", "signed_residual_cuda",
         "unpack_signs_wsum_cuda")) + "; decode by W: " + ", ".join(
        f"{d['workers']}: {d['ms']:.4f} ms" for d in comp["decode"]),
        flush=True)
    topk = topk_phase(comp["n_true"])
    print(f"topk [{topk['rows']}, {topk['chunk']}] k={topk['k']}: encode "
          f"{topk['topk_encode_cuda']['ms']:.4f} ms (bound "
          f"{topk['topk_encode_cuda']['bound_ms']:.4f}, plain "
          f"{topk['topk_encode_cuda']['plain_ms']:.3f}, torch.topk "
          f"{topk['topk_encode_cuda']['library_ms']:.3f}); decode by W: "
          + ", ".join(f"{d['workers']}: {d['ms']:.4f} ms (bound "
                      f"{d['bound_ms']:.4f}, index_put_ "
                      f"{d['library_ms']:.4f})" for d in topk["decode"])
          + "; B7 radix select %.4f ms (the argmax passes, an earlier tree's "
            "run: %.4f ms)" % (
              topk["topk_encode_cuda"]["ms"],
              ARGMAX_TOPK["topk_encode_cuda"]["ms"]), flush=True)
    fpack = factor_pack_phase()
    st = fpack["per_step"]
    print(f"factor pack, one PowerSGD step (2 grouped launches, 32 "
          f"products): {st['ms']:.4f} ms (passes "
          + " + ".join(f"{p['ms']:.4f}" for p in fpack["passes"])
          + f"; 32 one-leaf launches {st['per_leaf_ms']:.4f}; bound "
          f"{st['bound_ms']:.4f}, plain {st['plain_ms']:.4f}, torch.matmul "
          f"{st['library_ms']:.4f}); max diff/bound "
          f"{fpack['max_err_over_bound']:.3f}; the per-leaf rowdot/coldot "
          f"kernels, an earlier tree's run: {ROWCOL_FACTOR['ms']:.4f} ms",
          flush=True)
    lap("kernels")
    ref_err = alexnet_reference_phase()
    print(f"AlexNet f32 logits card vs CPU: max |diff| {ref_err:.3e}",
          flush=True)
    zoo_ref = {"googlenet": googlenet_reference_phase(),
               "resnet50": resnet_reference_phase()}
    for name, r in zoo_ref.items():
        print(f"{name} f32 card vs CPU: logits max |diff| "
              f"{r['logits_max_abs_err']:.3e}, " + ", ".join(
                  f"{k} {v['card']:.6f} vs {v['cpu']:.6f}"
                  for k, v in r.items() if k.startswith("cost_"))
              + (f", {r['bn_leaves']} BN leaves max |diff| "
                 f"{r['bn_state_max_abs_err']:.3e}" if "bn_leaves" in r
                 else ""), flush=True)

    lap("reference logits")
    alex = alexnet_main_path_phase()
    print(f"main path: AlexNet BSP batch {BATCH}, {STEPS} steps, costs "
          f"{[round(c, 4) for c in alex['costs']]}, "
          f"{alex['img_per_s']:.1f} img/s on {card}", flush=True)
    alex_groups = {"lrn": ("lrn_",)}
    profs = {}
    for key, capture in (("alexnet", True), ("alexnet_eager", False)):
        profs[key] = step_profile_phase(
            "theanompi_tpu_torch.models.alex_net", "AlexNet", BATCH,
            alex_groups, PROFILE_STEPS, capture=capture)
        print_profile(profs[key], card, alex_groups)

    loader = native_loader_phase()
    print("native loader (g++ %.1fs): bit-equal to the NumPy path; one AlexNet "
          "batch, host ms: " % loader["build_s"] + "; ".join(
              f"{k} draws NumPy {v['numpy_ms']:.1f}, native "
              + ", ".join(f"{t} threads {ms:.2f}"
                          for t, ms in v["native_ms"].items())
              for k, v in loader["draws"].items())
          + f"; para_load runs {FILE_WORKERS} workers x "
          f"{loader['para_load_threads']} threads", flush=True)
    t0 = time.time()
    write_batch_files(DATA_DIR, FILE_STEPS, VAL_BATCHES, BATCH)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"wrote {FILE_STEPS} + {VAL_BATCHES} .npy batch files in "
          f"{time.time() - t0:.1f}s", flush=True)
    files, saved = alexnet_files_phase(False, ckpt_dir=CKPT_DIR)
    files_u8, _ = alexnet_files_phase(True)
    for name, r in (("float32 wire", files), ("u8 wire", files_u8)):
        print(f"main path: AlexNet BSP from files, para_load, {name}, batch "
              f"{BATCH}, {FILE_STEPS} steps, costs "
              f"{[round(c, 4) for c in r['costs']]}, {r['img_per_s']:.1f} "
              f"img/s, {r['batches_checked']} staged batches equal to the "
              f"host stream, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }",
              flush=True)
    u8 = u8_logits_phase()
    print(f"u8 wire vs float32 wire, first step's logits: scalar mean "
          f"bit-equal; mean image rel L2 {u8['image_logits_rel_l2']:.3e} "
          f"(bound {U8_LOGITS_RTOL}; input deviation up to "
          f"{u8['input_dev_max']:.2f})", flush=True)
    resumed = resume_phase(saved)
    del saved
    print(f"resume: params, momentum and cursor bit-equal to the checkpoint; "
          f"epoch 1 costs {[round(c, 4) for c in resumed['costs']]}, "
          f"{resumed['batches_checked']} staged batches equal to the host "
          f"stream", flush=True)
    for key, u8_wire in (("alexnet_files", False), ("alexnet_files_u8", True)):
        for suffix, capture in (("", True), ("_eager", False)):
            profs[key + suffix] = step_profile_phase(
                "theanompi_tpu_torch.models.alex_net", "AlexNet", BATCH,
                alex_groups, PROFILE_STEPS, capture=capture,
                **file_cfg(u8_wire))
            print_profile(profs[key + suffix], card, alex_groups)
    htod = htod_phase()
    print("HtoD copy of one AlexNet batch (CUDA events): " + "; ".join(
        f"{w} {htod[w + '_mb']:.1f} MB pinned {htod[w + '_pinned_ms']:.3f} "
        f"ms, pageable {htod[w + '_pageable_ms']:.3f} ms"
        for w in ("f32", "u8")), flush=True)

    lap("AlexNet paths")
    tools = tools_main(card, profs["alexnet"])
    lap("tools")
    phase_s.update({f"tools_{k}": v for k, v in tools["phase_s"].items()})
    vggs = {}
    for strategy, shape, groups in (
            ("onebit", (comp["n"],),
             {"onebit_kernels": ("encode_kernel", "residual_kernel",
                                 "unpack_wsum_kernel"),
              "flatten_copy": ("CatArrayBatchedCopy",)}),
            ("topk", (topk["n"],),
             {"topk_kernels": ("topk_encode_kernel", "topk_decode_kernel"),
              # the JAX-order flatten (a copy per leaf) and the wire's
              # small packing copies
              "flatten_copy": ("direct_copy_kernel", "CatArrayBatchedCopy")}),
            ("powersgd", 32,
             {"factor_pack": ("factor_pack_kernel",),
              "qr": ("geqr", "orgqr", "ormqr", "larf", "householder")})):
        vggs[strategy] = vgg = vgg_main_path_phase(strategy, shape)
        print(f"main path: VGG-16 BSP {strategy} batch {VGG_BATCH}, "
              f"{VGG_STEPS} steps, costs "
              f"{[round(c, 4) for c in vgg['costs']]}, "
              f"{vgg['img_per_s']:.1f} img/s, launches "
              f"{ {k: v for k, v in vgg['launches'].items() if v} }",
              flush=True)
        profs[strategy] = prof = step_profile_phase(
            "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", VGG_BATCH,
            groups, PROFILE_STEPS, after=exchange_sync_check,
            exch_strategy=strategy, learning_rate=VGG_LR)
        print_profile(prof, card, groups)
        profs[strategy + "_eager"] = step_profile_phase(
            "theanompi_tpu_torch.models.vggnet_16", "VGGNet_16", VGG_BATCH,
            groups, PROFILE_STEPS, capture=False, exch_strategy=strategy,
            learning_rate=VGG_LR)
        print_profile(profs[strategy + "_eager"], card, groups)
        if strategy == "powersgd":
            # torch.linalg.qr's waits are a finding, printed and kept
            print(f"powersgd exchange: the host waited {len(prof['after'])} "
                  f"times: {prof['after'][:4]}", flush=True)
        elif prof["after"]:
            raise AssertionError(f"the {strategy} exchange made the host "
                                 f"wait: {prof['after']}")

    lap("VGG-16 wires")
    flash = flash_phase(libs["flash_attention"])
    print("flash SASS (per head dim 32, 64, 128): " + "; ".join(
        f"{k} " + ", ".join(f"{i} {n}" for i, n in c.items())
        for k, c in flash["sass"].items()), flush=True)
    print("flash attention %s bf16 causal: " % flash["shape"] + ", ".join(
        f"{k[:-5]} {flash[k]['ms']:.4f} ms (bound {flash[k]['bound_ms']:.4f}, "
        f"plain {flash[k]['plain_ms']:.3f}, SDPA {flash[k]['library_ms']:.4f}, "
        f"max |diff| {flash[k]['max_abs_err']:.3e})" for k in
        ("flash_fwd_cuda", "flash_bwd_dkv_cuda", "flash_bwd_dq_cuda"))
        + f"; di {flash['di_ms']:.4f} ms", flush=True)
    print("flash redesigned vs WMMA (an earlier tree's run): " + ", ".join(
        f"{k[:-5]} {flash[k]['ms']:.4f} ms (WMMA {r['ms']:.4f}), host "
        f"{flash[k]['host_us']:.1f} us a call (WMMA {r['host_us']} us)"
        for k, r in WMMA_FLASH.items())
        + "; B11 + B12 %.4f ms, SDPA backward %.4f ms" % (
            flash["flash_bwd_dkv_cuda"]["ms"] + flash["flash_bwd_dq_cuda"]["ms"],
            flash["flash_bwd_dq_cuda"]["library_ms"]), flush=True)
    lm_check = lm_check_phase()
    print(f"LM bf16 vs float32, batch {LM_CHECK_BATCH}: loss flash "
          f"{lm_check['loss_flash']:.6f}, reference "
          f"{lm_check['loss_reference']:.6f}, float32 "
          f"{lm_check['loss_float32']:.6f}; gradient relative L2 flash max "
          f"{lm_check['grad_rel_l2_max']:.3e}, reference max "
          f"{lm_check['grad_rel_l2_max_reference']:.3e}, worst leaf ratio "
          f"{lm_check['grad_ratio_max']:.3f}", flush=True)
    lm = lm_main_path_phase()
    print(f"main path: TransformerLM BSP flash batch {LM_BATCH}, {LM_STEPS} "
          f"steps, {lm['n_params']} params, costs "
          f"{[round(c, 4) for c in lm['costs']]}, "
          f"{lm['tokens_per_s']:.0f} tokens/s, launches "
          f"{ {k: v for k, v in lm['launches'].items() if v} } on {card}",
          flush=True)
    lm_groups = {"flash": ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                           "flash_bwd_dq_kernel")}
    for key, capture in (("lm", True), ("lm_eager", False)):
        profs[key] = lm_prof = step_profile_phase(
            "theanompi_tpu_torch.models.transformer_lm", "TransformerLM",
            LM_BATCH, lm_groups, PROFILE_STEPS, capture=capture,
            synthetic_train=LM_BATCH * (2 + 2 * PROFILE_STEPS), **LM_CFG)
        lm_prof["tokens_per_s"] = lm_prof["img_per_s"] * LM_CFG["seq_len"]
        print_profile(lm_prof, card, lm_groups)
        print(f"LM {key} step: {lm_prof['tokens_per_s']:.0f} tokens/s",
              flush=True)
    f32 = flash_f32_main(card)
    stage = pp_stage_main(
        card, flash_phase(batch=LM_BATCH // PP_STAGE["microbatches"]),
        f32["kernels"]["shapes"]["pp_stage"]["times"])
    ep = ep_rank_main(
        card, flash_phase(heads=LM_CFG["n_head"] // TP_RANK["tp"]),
        f32["kernels"]["shapes"]["tp_rank"]["times"])

    lap("bf16 flash, LM, f32")
    goog = googlenet_main_path_phase()
    resnet = resnet_main_path_phase()
    cifar = cifar10_main_path_phase()
    for name, r in (("GoogLeNet", goog), ("ResNet-50", resnet),
                    ("Cifar10", cifar)):
        print(f"main path: {name} BSP batch "
              f"{BATCH if name == 'Cifar10' else ZOO_BATCH}, {STEPS} steps, "
              f"costs {[round(c, 4) for c in r['costs']]}, "
              f"{r['img_per_s']:.1f} img/s, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }"
              + (f", {r['n_params']} params" if "n_params" in r else "")
              + (f", BN mean |mean| {r['bn_mean_abs_mean']:.4f}"
                 if "bn_mean_abs_mean" in r else "") + f" on {card}",
              flush=True)
    zoo_groups = {
        # the update's multi-tensor passes (torch._foreach_*)
        "GoogLeNet": {"lrn": ("lrn_",), "concat": ("CatArrayBatchedCopy",),
                      "optimizer": ("multi_tensor_apply_kernel",)},
        # cuDNN's and ATen's batch-norm kernels and the running stats'
        # Welford reductions; NCCL's all-reduces: the sync_bn one and the
        # metrics' one; the update's (and sync_bn's) multi-tensor passes
        "ResNet50": {"batchnorm": ("batch_norm", "bn_fw", "bn_bw",
                                   "BatchNorm", "Welford"),
                     "allreduce": ("AllReduce",),
                     "optimizer": ("multi_tensor_apply_kernel",)}}
    for cls, groups in zoo_groups.items():
        modelfile = "theanompi_tpu_torch.models." + cls.lower()
        for suffix, capture in (("", True), ("_eager", False)):
            key = cls.lower() + suffix
            profs[key] = step_profile_phase(
                modelfile, cls, ZOO_BATCH, groups, PROFILE_STEPS,
                capture=capture, learning_rate=ZOO_LR[cls],
                after=aux_heads_ms if cls == "GoogLeNet" and capture
                else None)
            print_profile(profs[key], card, groups)
            if "after" in profs[key]:
                print(f"GoogLeNet aux heads alone (forward, costs, "
                      f"backward; CUDA events): "
                      f"{profs[key]['after']['ms']:.3f} ms a step",
                      flush=True)

    lap("zoo")
    rules = {}
    for path in ("vgg16_easgd", "resnet50_gosgd", "alexnet_asgd"):
        rules[path] = r = rule_main_path_phase(path)
        print(f"main path: {path} batch {GRAPH_PATHS[path][2]['batch_size']}"
              f", {STEPS} steps, costs {[round(c, 4) for c in r['costs']]}, "
              f"{r['img_per_s']:.1f} img/s, {r['exchanges_checked']} "
              f"exchanges held against their plain recomputation, val cost "
              f"{r['val']['val_cost']:.4f}, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} } on {card}",
              flush=True)
    # the multi-tensor passes: the optimizer's, and under an async rule the
    # exchange's too (timed alone with CUDA events after each profile)
    rule_groups = {"foreach": ("multi_tensor_apply_kernel",),
                   "allreduce": ("AllReduce",)}
    for path in ("vgg16_easgd", "resnet50_gosgd"):
        modelfile, modelclass, cfg = GRAPH_PATHS[path]
        cfg = {k: v for k, v in cfg.items() if k != "synthetic_batches"}
        batch = cfg.pop("batch_size")
        every = cfg.get("sync_freq", 1)
        for suffix, capture in (("", True), ("_eager", False)):
            # the warm-up runs (and captures) an exchange; the timed and
            # profiled windows hold whole exchange periods
            profs[path + suffix] = step_profile_phase(
                modelfile, modelclass, batch, rule_groups,
                -(-PROFILE_STEPS // every) * every, warmup=max(2, every),
                capture=capture, after=exchange_ms, **cfg)
            print_profile(profs[path + suffix], card, rule_groups)
            print(f"{path}{suffix} one exchange alone (CUDA events): "
                  f"{profs[path + suffix]['after']['exchange_ms']:.4f} ms",
                  flush=True)
    lap("rules")
    clip = timed("clip", clip_phase)
    print(f"grad_clip on the card: AlexNet first-step norm "
          f"{clip['grad_norm']:.4f}, clip {clip['clip']:.4f}, params vs the "
          f"plain clipped update: max |diff| {clip['max_err_over_step']:.3e}"
          f" of the largest step", flush=True)
    opts = timed("optimizers", optimizer_phase)
    for name, r in opts.items():
        print(f"main path: AlexNet BSP {name}, costs "
              f"{[round(c, 4) for c in r['costs']]}, {r['img_per_s']:.1f} "
              f"img/s, val cost {r['val']['val_cost']:.4f}", flush=True)

    graph_eager = timed("graph_eager", graph_eager_phase)
    spc = timed("spc", spc_phase)
    recapture = timed("recapture", recapture_phase)
    witness = timed("capture_witness", capture_witness_phase)
    w = witness
    print("capture witness (what capture-purity names, on the card): "
          f".item() refused ({w['item']['error'][-70:]}); host clock "
          + (f"captured, replays frozen at its stamp: "
             f"{w['host_clock']['frozen']}" if w["host_clock"]["captured"]
             else f"refused ({w['host_clock']['error'][:60]})")
          + "; unregistered generator's draw "
          + (f"captured, replays frozen: "
             f"{w['unregistered_draw']['frozen']}"
             if w["unregistered_draw"]["captured"]
             else f"refused ({w['unregistered_draw']['error'][-70:]})")
          + f"; after the refusals {w['reserved_kept_mib']:.0f} MiB of a "
            f"freed 2 GiB stay reserved", flush=True)
    for path in set(_GRAPH_RUNS) - set(WIRE_REUSED):
        del _GRAPH_RUNS[path]
    windows = {}
    for key, u8_wire in (("f32", False), ("u8", True)):
        windows[key] = w = timed(f"windows_{key}", window_files_phase,
                                 u8_wire)
        print(f"main path: AlexNet BSP from files, para_load, spc {SPC} "
              f"window mode, {key} wire, costs "
              f"{[round(c, 4) for c in w['costs']]}, {w['img_per_s']:.1f} "
              f"img/s, {w['windows_checked']} staged windows and batches "
              f"equal to the host stream, launches "
              f"{ {k: v for k, v in w['launches'].items() if v} }",
              flush=True)

    lap("clip, optimizers, graphs, windows")
    islands = islands_main(card)
    lap("islands")
    phase_s.update({f"islands_{k}": v["secs"] for k, v in islands.items()
                    if "secs" in v})
    launcher = launcher_main(card)
    lap("launcher")
    phase_s.update({f"launcher_{k}": v["secs"] for k, v in launcher.items()
                    if "secs" in v})
    elastic = elastic_main(card)
    lap("elastic")
    wire = wire_main(card)
    lap("wire")
    ops = ops_main(card)
    lap("ops planes")
    phase_s.update({f"ops_{k}": v for k, v in ops["phase_s"].items()})
    _GRAPH_RUNS.clear()
    shard = shard_main(card)
    lap("shard")
    a9 = gan_lm_main(card)
    lap("gan, lm")

    kernels = kernel_entries(lrn, lrn_g, comp, topk, fpack, flash, alex,
                             goog, vggs, lm, f32, stage, ep)
    for e in kernels:
        # the bucketed wires' decodes: once a bucket (A7)
        path = {"unpack_signs_wsum": "vgg16_onebit",
                "topk_decode": "vgg16_topk"}.get(e["name"])
        if path:
            name = e["name"] + "_cuda"
            e["bucketed"] = dict(
                bucket_bytes=WIRE_BUCKET,
                n_buckets=wire["vgg16"][path]["n_buckets"],
                launches=wire["vgg16"][path]["launches"][name],
                launches_from=f"VGG-16 {path[6:]} main path at 4 MiB",
                **{k: wire["decode"][name][k] for k in
                   ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "by_workers")
                   if k in wire["decode"][name]})
    by_path = flash_launches_by_path(lm, a9)
    for e in kernels:
        if e["name"].startswith("flash_") and not e["name"].endswith("_f32"):
            # the A9c paths: the MoE LM, remat, the samplers, token files
            e["launches_by_path"] = by_path[e["name"] + "_cuda"]
        if e["name"].startswith("lrn_"):
            name = "lrn_fwd_cuda" if e["name"] == "lrn_fwd" else "lrn_bwd_cuda"
            e["launches_by_path"] = {
                "alexnet_synthetic": alex["launches"][name],
                "alexnet_files_para_load": files["launches"][name],
                "alexnet_files_para_load_u8": files_u8["launches"][name],
                "alexnet_resumed_epoch": resumed["launches"][name],
                "googlenet": goog["launches"][name],
                **{f"alexnet_files_spc{SPC}_{k}": w["launches"][name]
                   for k, w in windows.items()},
                # the async islands: each island process's own count, and
                # the two island threads' together
                **{f"{k}_island{i}": n[name] for k in ("alexnet_easgd",
                                                       "alexnet_asgd")
                   for i, n in enumerate(islands[k]["launches"])},
                "alexnet_island_threads":
                    islands["alexnet_threads"]["launches"][name],
                # the rank the launcher started (its own process's count)
                "alexnet_launched_rank":
                    launcher["world1"]["launches"][name],
                # the tools: profile_model's run, the sweep's two
                "alexnet_profile_model":
                    tools["profile_model"]["launches"][name],
                "alexnet_scaling_sweep":
                    tools["scaling_sweep"]["launches"][name],
                # each elastic island process that exited, the respawned
                # island 1 included: 2 a step
                **{f"alexnet_elastic_island{w}": i["launches"][name]
                   for w, i in elastic["islands"].items()},
                # the A9a layouts (zero_opt, update_sharding, fsdp)
                **{f"alexnet_shard_{k}": r["launches"][name]
                   for k, r in shard["alexnet"].items()},
                # the refit checks: 3 models x 2 steps after the loads
                **{f"alexnet_shard_{k}_refit": r["refit"]["launches"][name]
                   for k, r in shard["alexnet"].items() if "refit" in r}}
    total_s = time.time() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "compress": comp, "topk": topk,
                   "factor_pack": fpack, "flash": flash, "lm_check": lm_check,
                   "flash_f32": f32, "pp_stage": stage, "ep_rank": ep,
                   "main": dict({"alexnet": alex, "lm": lm,
                                 "googlenet": goog, "resnet50": resnet,
                                 "cifar10": cifar,
                                 "alexnet_files": files,
                                 "alexnet_files_u8": files_u8,
                                 "alexnet_resumed": resumed,
                                 "alexnet_files_windows": windows},
                                **{f"vgg16_{k}": v for k, v in vggs.items()}),
                   "rules": rules, "clip": clip, "optimizers": opts,
                   "islands": islands, "launcher": launcher,
                   "elastic": elastic, "wire": wire, "tools": tools,
                   "shard": shard, "gan_lm": a9, "ops": ops,
                   "graph_eager": graph_eager, "spc": spc,
                   "recapture": recapture, "zoo_ref": zoo_ref,
                   "capture_witness": witness,
                   "lrn_googlenet": lrn_g, "lrn_sass": lrn_sass,
                   "native_loader": loader, "u8_logits": u8, "htod": htod,
                   "profile": profs, "card": card, "build_s": build_s,
                   "phase_s": laps, "phases_s": phase_s,
                   "total_s": total_s,
                   "alexnet_ref_err": ref_err}, f, indent=1)
    print("seconds by phase group: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()), flush=True)
    print("seconds of the leading groups' phases: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)
    print(f"all phases passed in {total_s:.1f}s", flush=True)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k not in ("shapes", "by_workers")}
        for e in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--island"]:
        # one island process of the island phases
        sys.exit(island_main(sys.argv[2]))
    _flags = set(sys.argv[1:])
    if not _flags <= {"--flash-times", "--topk-times", "--factor-times",
                      "--flash-f32-times", "--decode-times",
                      "--input-times", "--update-times", "--lrn-times",
                      "--islands", "--vgg-island-lr", "--launcher",
                      "--wire", "--shard", "--gan-lm", "--flash-f32",
                      "--pp-stage", "--ep-rank", "--ops", "--elastic",
                      "--tools"}:
        sys.exit(f"chip_smoke: unknown arguments {sorted(_flags)}")
    sys.exit(times_main(_flags) if _flags else main())
