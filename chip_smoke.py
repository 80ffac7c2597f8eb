#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port (``distributed_model_parallel_tpu_torch``) only; imports
nothing of JAX or the JAX package. Phases, each fatal on failure:

1. device — require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls and convolutions;
2. build — compile every kernel of the port from ``ops/csrc`` (one
   ``nvcc`` per source, all at once) and print ptxas's register, spill
   and warning lines;
3. kernel vs plain — the paged decode kernel (a split pass over page
   ranges, then a merge launch) against its plain PyTorch version at the
   serving slice's shapes: MHA, GQA (G 4 and G 8), sliding windows of 64
   and 100, positions on page and split edges, one row alone at pos 639;
   unreferenced and stale pool slots filled with NaN; each row of a batch
   equals that row run alone, bit for bit;
4. timing — kernel (both launches), plain version, one
   ``scaled_dot_product_attention`` call over pre-gathered K/V (the
   library yardstick, never used by the port) and the HBM bound; the
   longest row alone; CUDA events, L2 flushed before each run;
5. engine — the serving engine at full width (the bench.py LM/decode
   model, random weights from a seed): 8 greedy requests under continuous
   batching; every request completes, the kernel ran n_layers times per
   decode step, a request's tokens solo equal its tokens in the batch,
   and the first decode step's logits through the kernel agree with the
   plain path's;
6. flash kernels vs plain — the forward, dq and dk/dv kernels in bf16
   against their plain versions (each backward kernel fed the kernel's
   own o and lse) and against autograd through the plain
   ``full_attention``, at the training slice's shape (B 2, H 8, T 8192,
   Dh 128, causal) and its edges (ragged T, full, windows of 256 and 100,
   Dh 64, T 77, a window of 300 over T 1000); both backward kernels run
   twice on each case's inputs and must agree with themselves bit for bit
   (no atomics, no order that depends on scheduling);
7. flash timing — each kernel, its plain version, the operation bound
   and the library yardstick (SDPA forward; SDPA's backward for the
   dq + dk/dv pair), then the port's whole backward (delta, dq, dk/dv)
   beside SDPA's backward, CUDA events, L2 flushed before each run;
8. trainer — the LM training slice at full width (bench.py's LM model,
   bf16, RoPE, remat off, LMTrainConfig's SGD): (a) one step's loss and
   gradients through the kernels against the plain attention at T 2048;
   (b) a warm-up step, then 5 steps through ``LMTrainer`` at B 2, T 8192
   — finite losses, parameters changed, each flash kernel launched
   n_layers times per step — with step time, tokens/s, MFU and peak
   memory; (c) one step under ``torch.profiler``;
9. fused SGD vs plain — ``FusedSGD`` on the card over MobileNetV2's 173
   parameter leaves (one bucket, and a cap that gives 12), 5 updates of
   each variant (momentum + weight decay, nesterov, no decay, momentum 0)
   through the kernels against the plain version per leaf; then the
   public wrappers on a cap-sized bucket, a length that is not a multiple
   of 4, views 4 bytes into their buffers (unaligned head) and views of
   differing offsets, every variant; all bit for bit, launches ==
   updates x buckets; the grid the kernel picks at the CNN and cap
   buckets;
10. fused SGD timing — each variant's one-bucket update: kernel, plain
    version, ``torch.optim.SGD(fused=True)`` over the 173 leaves (the
    library yardstick, never used by the port) and the byte bound, one
    call after an L2 flush (host enqueue included where it outlasts the
    flush); then the device time per launch, from CUDA graphs of K
    launches over R bucket sets that together exceed the L2 3x (each
    launch finds its bucket cold), at the CNN bucket and a cap-sized one,
    beside ``torch.optim.SGD(fused=True)`` over the same flat bucket in
    the same graph train; and the host's enqueue per launch of
    ``FusedSGD.step`` and of the public wrapper;
11. CNN trainer — bench.py's CNN workload with the fused optimizer
    (MobileNetV2, batch 512, bf16 over f32, device-resident, 10 steps per
    dispatch, cuDNN autotuner on): (a) two steps through the fused kernel
    against ``torch.optim.SGD`` from the same weights and batches; (b)
    bench.py's timing shape — 2 warm-up dispatches, 50 steps, one sync —
    with samples/s, step time, MFU and peak memory (fused_sgd launches
    == steps x buckets, parameters and BN statistics changed), then 20
    steps with momentum 0 (plain_sgd launches == steps) and 20 with
    ``fused=False``; (c) one step under ``torch.profiler``, and one with
    momentum 0, each printing the fused SGD kernel's device time;
12. data parallelism — the CNN slice through the port's process group,
    one process per rank started by ``mesh.spawn``: (a) at world =
    ``device_count()`` over NCCL (on one card the rank is this process,
    joined to a one-rank group: phase 11's cuDNN autotuner results serve
    it), two gspmd steps at world 1 against
    phase 11's one-device trainer from the same weights and batches,
    cuDNN deterministic, bit for bit; bench.py's timing shape through
    gspmd with samples/s, MFU, peak memory, the grad-allreduce µs a step
    (CUDA events from the first bucket's launch to the end of the
    Reducer's ``finish``) and all-reduce launches a step (== buckets;
    fused_sgd launches counted from 0 over the timed steps); 20 ddp
    steps, bucketed, streaming input; (b) two ranks (both on the one
    card over gloo, or two cards over NCCL): ddp with per-replica, then
    synchronized BN, 5 steps of the global batch of 512 with augment
    off — parameters and momentum bitwise equal across the ranks after
    every step, BN statistics different across ranks under local and
    bitwise equal under sync, and the sync step-0 loss against the
    one-rank gspmd loss on the same rows;
13. pipeline — the CNN slice cut into stages, one ``FusedSGD`` per chunk:
    (a) the runner in one process over ``[cuda:(c % n)]`` for 4 stages
    (all on card 0 on a one-card machine, listed explicitly), cuDNN
    deterministic: two naive (M=1) steps at the reference's cut
    ``0,4,10,16,19`` bit for bit phase 11's one-device trainer, and gpipe
    M=8 == 1f1b M=8 == interleaved V=2 M=8 (8 chunks at the port's
    cost-balanced cut) bit for bit over two steps; then naive M=1, gpipe
    M=4 and M=8, 1f1b M=8 and interleaved V=2 M=8 timed (6 steps after 1,
    each synced: step s, samples/s, host enqueue, peak memory, fused_sgd
    launches == chunks x steps) and one ``PipelineTrainer.fit`` epoch;
    (b) the SPMD engine through ``mesh.spawn`` at 2 stages (two ranks on
    the one card over gloo, or two cards over NCCL), gpipe and 1f1b M=4,
    3 steps of ``Trainer(strategy="spmd_pipeline")``: each rank's
    parameters, momentum and BN statistics bit for bit the runner's at
    S=2 with the same cut and M; hops and bytes, µs a ring shift of the
    boundary activation, step time; (c) ``PipelineTrainer`` over the 4
    stages, gpipe M=4 at the reference's cut, phase 15b's workload
    (MobileNetV2 bf16, fused SGD, augment on, 3,072 / 512 rows at batch
    256, 2 epochs, cuDNN deterministic): ``fit(2)`` against ``fit``
    preempted by a ``step_hook`` at step 5 of epoch 1 and finished by
    ``PipelineTrainer(resume=True)``, bit for bit (parameters, momentum,
    BN statistics, update counts, global step, history), fused_sgd
    launches, the "pipeline" slot's best_acc, the text log's lines, save
    and restore ms and bytes; (d) two SPMD ranks (gloo on one card, NCCL
    on two): the same gate under gpipe and 1f1b M=4 on 1,024 / 256 rows
    (preempted at step 3 of epoch 1),
    then interleaved 1F1B V=2, M=4 at S=2 over 3 steps, each rank's
    chunks bit for bit the runner's interleaved V=2 at S=2 with the same
    cut, its hops and bytes a step beside 1F1B's;
14. ResNet and the remaining data-parallel engines: (a) bench.py's CNN
    workload with ``DMP_BENCH_MODEL=resnet50`` (ResNet-50, CIFAR layout,
    batch 512, bf16 over f32, fused SGD over two buckets, device-resident,
    10 steps per dispatch): the two-step fused vs ``torch.optim.SGD``
    check, bench.py's timing shape (samples/s, MFU, peak memory;
    fused_sgd launches == steps x buckets, counted from 0 over the timed
    steps), 20 momentum-0 steps (plain_sgd == steps x buckets), a
    profiled step with the fused kernel's device time beside its byte
    bound, one ResNet-18 step and ResNet-50's ImageNet layout forward at
    batch 32 on 224 px; (b) two ranks (both on the one card over gloo, or
    two cards over NCCL), ResNet-50 in f32 at batch 128, augment off,
    cuDNN deterministic, 3 steps a case, each step from the reference
    run's state: ddp ``allreduce="ring"`` vs ``"bucketed"`` and ZeRO
    (fused SGD kernel on each rank's slice, then momentum 0) vs gspmd's
    FusedSGD, parameters per leaf within 1e-5 relative and bitwise equal
    across ranks, one kernel launch a step a rank under ZeRO and its
    momentum bytes beside gspmd's; fsdp vs gspmd within
    tests/test_fsdp.py's bounds, each rank's resident bytes; the sparse
    bag-of-words (BowConfig's defaults, 512 rows x 64 tokens, 5 steps)
    against dense SGD on the global batch within 1e-5, tables bitwise
    equal across ranks;
15. the reference's harness: (a) each of the 16 zoo models
    (``models/zoo.py``) at its CIFAR widths, bf16 over f32 parameters,
    FusedSGD (lr 0.4, momentum 0.9, wd 1e-4), batch 128 of synthetic
    32 px data on the card, device-resident, cuDNN's autotuner off: 2
    steps in one dispatch, one sync (the timed ones: 2 one-step warm-ups,
    then 10 steps in one dispatch) — the JAX package's parameter count,
    ``fused_sgd`` launches == steps x buckets on the card, finite losses;
    step s, samples/s and peak memory (over what was allocated before
    the model's Trainer) printed; phase 11a's check on
    EfficientNet-B0 and DenseNet-121, a momentum-0 EfficientNet-B0 run
    (``plain_sgd``); (b) MobileNetV2 bf16, batch 256, cuDNN deterministic:
    ``fit(2)`` against ``fit`` preempted by a ``step_hook`` at step 5 of
    epoch 1 and finished by ``Trainer(resume=True)``, bit for bit
    (parameters, momentum, BN statistics, update count, global step,
    history), per batch and device-resident at 10 steps a dispatch; the
    ``ckpt`` slot's best_acc, a torn newest version skipped and logged,
    the text log's lines, save and restore ms and the checkpoint's
    bytes; (c) on 1,024 / 256 rows (preempted at step 3 of epoch 1), the
    same gate at two ranks for ddp
    and zero (gloo on one card, NCCL on two or more), and zero's
    uninterrupted run against
    gspmd's from the same inputs, parameters, momentum and BN statistics
    per leaf within 1e-5 relative;
16. the data path: (a) the reference's finetune recipe — MobileNetV2 in
    the ImageNet layout, bf16 over f32, FusedSGD lr 0.05, batch 128 of
    32 px rows held on the card and resized to 224 px in every step,
    device-resident, 10 steps a dispatch, bench.py's timing shape:
    samples/s, step s, MFU, peak memory, fused_sgd == steps x buckets, a
    profiled step with the resize's share of device time, the resize on
    the card against its CPU run; (b) one epoch of 15b's workload on the
    per-batch host path with the host and device prefetch stages (depth
    2) bit for bit the epoch without them, the data time a step of each;
    (c) the C++ row gather at batch 512 of CIFAR-shaped rows against
    numpy indexing, bit for bit, µs a batch of each;
17. the rest of the data-parallel CNN trainer: (a) phase 11's CNN cell
    under adam, adamw, lamb, lars and adafactor, the first 3 updates and
    every state tensor on the card against the same chain on the CPU fed
    the same gradients and parameters (1e-5 a leaf), finite losses over
    10 more steps, with step s, samples/s, peak memory, state bytes, the
    optimizer's host ms and CUDA kernels a step; (b) ``accum_steps`` 4 at
    B 128 against B 512 (mobilenetv2_nobn, f32, cuDNN deterministic), 3
    updates each from the big run's state, 1e-5 a leaf, ``fused_sgd``
    and (momentum 0) ``plain_sgd`` launches == updates x buckets, the
    fused update's µs in a profiled boundary step; (c) the weight
    average against a float64 host recurrence (1e-6), then adamw +
    accumulation 2 + EMA 0.99 on 15b's workload preempted mid-
    accumulation and resumed, every checkpoint array bit for bit, save
    and restore ms and bytes; (d) ``FusedSGD`` over MobileNetV2's leaves
    in bf16 (staged into f32 buckets) against the plain version, leaves,
    momentum and delta bit for bit; (e) fsdp on ResNet-50 f32 at two
    ranks: at most one unit's whole weights alive in either pass (the
    live gathered tensors' bytes, and ``memory_allocated`` after the
    forward beside gspmd's), fsdp vs gspmd within 2e-4/2e-5; ddp
    ``allreduce="hierarchical"`` against ``"bucketed"`` at four ranks on a
    ``data=4, dcn_data=2`` mesh (MobileNetV2 f32 B 128, gloo on one card),
    1e-6 a leaf, replicas bitwise;
18. the Transformer LM over a ``(data, model, seq)`` mesh, bench.py's LM
    model at full width (phase 8's B 2, T 8192, bf16, SGD), every run from
    phase 8's weights: (a) on one card, remat off, ``"dots"`` and
    ``"full"``, and the chunked head (1024 tokens a slice) with and
    without ``"dots"``, 3 steps each — step-0 loss within 2e-2 of phase
    8b's, peak ``max_memory_allocated`` ordered off > dots > full and the
    chunked head below the dense one; step s, tokens/s, MFU, peak memory,
    flash launches by kernel; the loss's forward and backward through
    the plain ``lm_loss`` against ``LMPipeline`` at one stage and one
    microbatch (the path of every LM step), alternated and timed, the
    losses within 1e-3; (b) 4 ranks (gloo sharing the card, or NCCL
    with a card each), ``MeshConfig(model=2, seq=2)`` with ring
    attention, ``(data=2, seq=2)`` with Ulysses and ``(data=2,
    model=2)``, 3 steps each: step-0 loss within 2e-2 of the one-card
    trainer's, after every step each replicated leaf bitwise equal on
    every rank and each tensor-parallel slice bitwise equal across its
    data and seq replicas, each rank's flash launches what its hops imply
    (ring: rank i of the seq group i + 1 hops a layer) with no plain
    attention on the card, ring attention on the card against the flash
    kernels over the whole sequence (o per row within 1e-2, dq/dk/dv
    within 2e-2); step s, tokens/s and MFU a card, peak memory a rank,
    the collectives' calls and bytes a step and their µs in one timed
    step; (c) at 2 layers on the ring mesh under ``"dots"``: ``fit``
    preempted by a ``step_hook`` at step 3 of epoch 0 and resumed equals
    the uninterrupted fit bit for bit on every rank (per-step losses, the
    whole parameters and optimizer state, the global step, the history),
    the checkpoint's bytes, save and restore ms, and the checkpoint
    resumed on another split, ``(data 2, model 2)``: the same whole
    parameters and optimizer state bit for bit, at the same global step;
19. the LM's stage and expert axes, bench.py's LM model at full width
    (bf16, phase 8's SGD, remat off, seed 0's weights) and its MoE
    version (8 experts, top-2, capacity 1.5: benchmarks/moe_sweep_r5.json's
    configuration): (a) on one card, the references — dense B 4 T 8192
    under gpipe M 4 and M 1, dense B 8 T 4096 with the 1024-token chunked
    head under 1f1b M 8, MoE B 2 T 8192 M 2 — 3 gated steps and one timed
    step each: finite losses, gpipe M 4's every step within 1e-3 of M 1's,
    flash launches == n_layers x M x steps (the forward twice under
    1f1b), the drop rate in [0, 1]; ``moe_ffn`` on 4,096 tokens against
    its plain per-token version with the routing shared (1e-3 of max|y|,
    below a bf16-vs-f32 control); (b) 4 ranks (gloo sharing the card, or
    NCCL with a card each): ``(stage 4)`` gpipe M 4 and 1f1b V 2 M 4 (one
    layer a chunk), ``(stage 2, model 2)`` gpipe and 1f1b M 8 at T 4096
    with the chunked head, ``(stage 2, expert 2)`` MoE 1f1b V 2 M 2; 3
    gated steps and one timed each: every step's loss within 1e-3 of its
    19a reference (same batches and microbatch partition; the MoE mesh's
    step 2 within LM19_MOE_STEP2_ATOL, its routing decisions that differ
    from the one card's counted), each slice bitwise equal on every rank
    holding it after every step, flash launches what each rank's layers,
    microbatches and schedule imply, no plain attention, 1f1b's peak
    memory a rank below gpipe's, the MoE mesh's gradient of every leaf
    after step 0 against the one-card run's (a gradient taken twice shows
    as a norm ratio of 2); step s, tokens/s
    and MFU a card, peak memory a rank, the table's bubble, stage hops
    and all-to-alls a step and their µs; (c) the MoE mesh at 4 layers:
    ``fit`` preempted at step 2 and resumed equals the uninterrupted fit
    bit for bit on every rank, the restored slices in the interleaved
    storage order, the checkpoint's bytes, save and restore ms, and a
    resume at ``virtual_stages=1`` refused.
20. Decoding: (a) ``models/transformer.generate`` at bench.py's decode
    geometry (the phase-5 model, B 8, prompt 128, 512 greedy tokens):
    flash forward launches == n_layers (the batched prefill), paged_decode
    launches == n_layers x 511, the prefill's and first decode step's
    logits through the kernels within LOGITS_ATOL of the plain path's and
    of a chunked prefill's; the MoE variant (8 experts, top-2) against the
    plain path with the kernel run's routing replayed; tokens/s under
    bench.py's name, per-token latency, bench.py's byte model as the
    bound, peak memory, greedy agreement with the plain path. (b)
    ``generate_sharded`` on (data 2, model 2) at 64 tokens (four gloo
    ranks sharing the card; in the default run 19b's ranks do it): each
    rank's cache holds 4 of 8 kv heads, first-step logits within
    LOGITS_ATOL of 20a's rows, the TP all-reduces a token. (c) the engine
    on a chat trace with the prefix cache and speculative decoding
    (spec_k 4): cache on == off bit for bit, spec on == off in tokens
    except at a near-tie of the spec-off step (printed), exact pages after
    the drain, the paged kernel's window-row entry bit for bit the
    one-token launches (W 2, 4, 5) and against its plain version, timed.
21. The engine's overload controls and planes, at bench.py's
    serving-overload widths (vocab 8192, d 512, 4 layers, bf16; 48
    requests): (a) a closed-loop capacity run, then the same population
    at 2x (bench.py's factor) and 3x capacity with a 0.3x tail through an
    engine with deadlines, priorities, the bounded queue and brownout
    armed — every request not completed shed typed, no failure, the
    arrived backlog within ``max_queue`` every iteration, completed tokens
    == the capacity run's (a prefix where clamped), brownout resolves in
    both and fires at 3x (``OVL_FACTORS``' note), the metering
    gate and the trace joiner clean on the stream, paged_decode launches
    == n_layers x decode rounds with no plain path, warmup loaded and
    launched the kernel first; goodput, capacity, shed fraction, TTFT
    p99 and a profiled device busy share printed (bench.py's 0.8 goodput
    band printed, not gated); (b) spec_k 4 with a journal: a run killed
    half-way and every pending intent of its journal replayed by
    ``ServeFleet.recover`` on one replica — in f32 no request lost, one
    terminal an intent, tokens == the uninterrupted run's; in bf16 the replays that trip the
    re-sampled-token assertion counted with their top-2 gaps (reported);
    (c) drain engine A with requests mid-prefill and mid-decode (prefix
    cache on), enqueue them on B: tokens == the unmigrated run's bit for
    bit, A's pool empty, a hop meter record and an export/import rtrace
    pair a move; (d) during (a), /healthz, /statusz and /metrics of the
    status exporter on 127.0.0.1 answer 200 with the engine's provider.
22. The serving fleet, at bench.py's fleet cell (21's model, trace and
    geometry; 2 replicas, every slot on cuda:0 on a one-card host): (a) a
    clean pass (tokens/s a card, TTFT) and the kill drill — r1 killed at
    round 40 and revived 20 rounds later: the kill fired, no request
    failed, tokens == the clean pass's bit for bit, r1 grew back, the
    post-kill TTFT p99 within max(4 x the reference, 0.5 s); (b) in f32
    the crash drill (``crash_replica("r1")``, the journal re-admitting its
    requests) and ``ServeFleet.recover`` from a journal abandoned
    half-way — none lost, one terminal each, tokens == a clean pass's —
    then the crash drill once in bf16 with the replays that re-sample
    another token counted (reported); (c) 4 replicas in 2 cells on a
    SimClock, ``kill_cell`` then ``partition`` on the last cell, 24
    requests: none lost, the cell back on exactly its slots, nothing routed
    into the partition, tokens == a clean 4-replica pass. Every pass:
    paged_decode launches == n_layers x the decode rounds summed over the
    replicas, no plain path; a profiled device busy share.
23. The trainers' resilience plane, cuDNN deterministic: (a) one rank,
    bench.py's CNN geometry (MobileNetV2, bf16, fused SGD, B 512) on
    4,096 synthetic rows (8 steps an epoch), 2 epochs: a fault plan of
    ``save_fail`` (the good slot's first save: recorded, retried),
    ``tear_save`` (the save after epoch 0, torn) and ``nan_loss`` in
    epoch 1 under ``check_finite_every`` 1, ``max_retries`` 1,
    ``lr_shrink`` 0.5 — the records in order (save failed, save retried,
    non-finite, checkpoint torn, fallback, restored), the run complete,
    finite parameters still the fused buckets' views, fused_sgd launches
    == the steps run; then a ``stall`` past ``stall_budget_s`` with
    ``stall_exit``: a checkpoint-and-exit whose resume ends bit for bit
    where an uninterrupted run does; (b) 4 ranks riding 19b's spawn
    (MobileNetV2 bf16 under ddp, B 128, 512 rows): a ``bitflip`` repaired
    by the consistency sentinel within one cadence, the final parameters
    bit for bit an uninjected run's; the sentinel's
    ``consistency_check_s`` share of step time at cadence 10 (printed); a
    ``preempt`` at world 4 (gspmd, MobileNetV2 without BN) resumed at 4
    (bit for bit the uninterrupted run) and at 2 (ranks 0-1 as a two-rank
    mesh: the exact global step, through the resharded restore);
    ``desync`` at world 2 (no quorum, the good-slot restore, completion);
    ddp's stacked BN statistics restored at another world:
    ``TopologyMismatchError``; (c) the LM at bench.py's width (B 2, T
    8192) at 2 layers: ``nan_params`` caught by ``check_finite``, the
    good slot restored at half the LR, the epoch completed; each flash
    kernel launched n_layers x the steps run.
24. The autotuner (``autotune/``), cuDNN deterministic: (a) the cost
    model's coefficients on the card (``default_coefficients``, the HBM,
    the peak) beside the card line — the card's name must be in the
    profiling table and the HBM must be ``total_memory`` — and the plan
    CLI's ``--dry-run`` top 3 for bench.py's LM at 8 devices; with four
    cards 24e's ranks also time 4-byte and 64 MiB all-reduces over NCCL
    (back to back between CUDA events) and print alpha and the wire rate
    beside the constants; (b)
    ``Trainer(strategy="auto")`` at bench.py's CNN geometry (MobileNetV2,
    bf16, fused SGD, B 512, 10 steps a dispatch, 2 dispatches): the plan
    this process computes, one ``plan`` record (``"startup"``), losses bit
    for bit the gspmd run's, fused_sgd == steps x buckets, predicted
    against measured step s and memory; (c) ``PipelineTrainer(strategy=
    "auto")`` over 4 stages on the card (13a's workload, one fit epoch):
    the cut auto_partition gives over the probe's costs, fused_sgd ==
    chunks x steps; then the analytic top 3 microbatch counts each timed
    for 2 steps through ``measure_plans`` (analytic and measured orders
    printed, not gated); (d) ``LMTrainer(strategy="auto",
    statusz_port=0)`` at bench.py's LM width (B 2, T 8192) at 2 layers, 3
    steps through ``fit``: losses bit for bit ``strategy="spmd"``'s, each
    flash kernel 2 x the steps, ``/statusz`` serving the trainer's
    provider with the plan and the live global step, and ``/healthz``
    200, read by a ``step_hook`` before every step; (e) 4 ranks riding
    19b's spawn (MobileNetV2 bf16 B 128, 2 steps): every rank's decision
    equal and equal to this process's plan for 4 devices, the steps run,
    replicas bitwise under a data-parallel plan.
25. The orchestrator (``orchestrator/``), cuDNN deterministic: (a) an
    ``Orchestrator`` over 3 slots of the one card, quantum 1: a pipeline
    tenant (13a's workload over 2 stages, gpipe M 4, 3 steps) and a CNN
    tenant (bench.py's CNN width: MobileNetV2, bf16, fused SGD, B 512 on
    the host input path, 3 steps an epoch, 2 epochs), then at round 1 an
    LM tenant of priority 5 (bench.py's LM width at 2 layers, B 2, T 8192,
    3 steps) that preempts the CNN tenant (the newest of the lowest
    priority): every tenant completes, the resume lands at the exact
    step, the CNN tenant's parameters are bit for bit a solo ``fit`` of
    its config, the slices replayed from ``fleet.jsonl`` never overlap,
    ``fused_sgd`` == steps x buckets per CNN and pipeline tenant and each
    flash kernel == 2 layers x steps for the LM tenant, every launch
    counted during that tenant's grants (each grant synced); prints each
    tenant's step s and wall, the admissions' seconds, the orchestrator's
    own host seconds a round (the rounds' spans less the tenants' work)
    and the preempt checkpoint's save and restore ms; (b) a dp-2 CNN
    tenant (MobileNetV2 bf16 B 128) run as a rank group (2 gloo ranks on
    the card, or NCCL with a card each), ``shrink(1)`` -> dp 1 on a thread
    -> ``grow()`` -> grow-back to dp 2, each resume at the exact step, the
    replicas bitwise; prints the dp-2 admissions' seconds and a step
    grant's round trip across the process boundary and the part of it no
    rank was working (medians); (c) 4 ranks riding 19b's spawn:
    MobileNetV2 bf16 B 128 on (data 2, model 2) against (data 4) on the
    same global batches (losses within 1e-2, the copies' digests equal on
    every rank) and bench.py's LM width at 2 layers, T 2048, on (data 2,
    dcn_data 2, model 2) against (data 2, model 2) (losses within 1e-3,
    bitwise expected: the same ranks form the same data group; the
    slices of a model index bitwise across the data axis).

Prints the card line, each phase's seconds, a ``{"data_parallel": ...}``
line, a ``{"pipeline": ...}`` line, a ``{"resnet": ...}`` line, a
``{"dp_engines": ...}`` line, a ``{"harness": ...}`` line, a
``{"data_path": ...}`` line, a ``{"optim": ...}`` line, a
``{"lm_mesh": ...}`` line, a ``{"lm_pipe": ...}`` line, a ``{"decode":
...}`` line, a ``{"serve_planes": ...}`` line, a ``{"fleet": ...}`` line,
a ``{"resilience": ...}`` line, an ``{"autotune": ...}`` line, an
``{"orchestrator": ...}`` line, the ``{"kernels": [...]}`` line and,
last,
``{"ok": true, "device": {...}}``. Exits non-zero
without a card, or when run outside a checkout of the repository.
``--sgd-timing-only`` runs phases 1, 2 (the fused SGD kernel) and 10 and
prints their ``{"sgd_timing": ...}`` line: copied into another checkout,
it measures that checkout's kernel the same way. ``--pipeline-only``
runs phases 1, 2 (the fused SGD kernel) and 13 and prints the
``{"pipeline": ...}`` line: on a machine with four cards, it drives the
runner with each stage on its own card and the SPMD engine over NCCL.
``--dp-only`` runs phases 1, 2 (the fused SGD kernel) and 14b at world =
``device_count()`` over NCCL and prints the ``{"dp_engines": ...}`` line;
with more than one card it adds BASELINE.json's pair per engine
(bucketed, ring, ZeRO, fsdp, gspmd): samples/s a card over 10 more steps
and the gradient reduction's µs a step by CUDA events (fsdp's is
17e's). ``--harness-only``
runs phases 1, 2 (the fused SGD kernel) and 15 and prints the
``{"harness": ...}`` line; ``--data-only`` runs phases 1, 2 and 16 and
prints the ``{"data_path": ...}`` line; ``--optim-only`` runs phases 1, 2
and 17 and prints the ``{"optim": ...}`` line. ``--dp-only`` adds 17e at
world = the card count (fsdp) and 4 ranks (hierarchical) over NCCL with
four cards, timed: samples/s a card and the reduction's µs a step (fsdp's:
its reduce-scatters in the backward and the replicated leaves' all-reduce,
each timed by CUDA events and added). ``--lm-only`` runs phases 1, 2 (the
flash kernels), 6, 18 and 19 and prints the ``{"lm_mesh": ...}`` and
``{"lm_pipe": ...}`` lines; with four cards 18b-c and 19b-c run over NCCL
at world 4, one rank a card. ``--serve-only`` runs phases 1, 2 (the
paged-decode and flash forward kernels), 3-5 and 20-22 and prints the
``{"decode": ...}``, ``{"serve_planes": ...}`` and ``{"fleet": ...}``
lines and the paged kernel's rows of the ``{"kernels": ...}`` line; with
four cards 20b runs over NCCL. ``--resilience-only`` runs phases 1, 2 (the
fused SGD and flash kernels) and 23 (23b in a spawn of its own: NCCL
with four cards, gloo on one) and prints the ``{"resilience": ...}`` line.
``--autotune-only`` runs phases 1, 2 (the fused SGD and flash kernels)
and 24 (24e in a spawn of its own: NCCL with four cards, gloo on one)
and prints the ``{"autotune": ...}`` line. ``--orchestrator-only`` runs
phases 1, 2 (the fused SGD and flash kernels) and 25 (25c in a spawn of
its own: NCCL with four cards, gloo on one) and prints the
``{"orchestrator": ...}`` line.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The serving slice: bench.py's LM/decode model and serving geometry.
MODEL = dict(vocab_size=32_000, d_model=1024, n_heads=8, n_layers=8,
             d_ff=4096, max_seq_len=640, pos_embedding="rope")
GEOMETRY = dict(n_slots=8, page_size=16, n_pages=(8 + 1) * 40,
                max_seq_len=640, prefill_chunk=32)
# New tokens a request in phase 5's profiled engine run.
PROFILE_GEN = 8
F32_FLOPS_PER_S = 67e12          # H100 SXM, float32 outside tensor cores
# Kernel vs plain: bf16 output, f32 accumulation in both; the plain
# version runs in f32 and is cast back, so the two differ by the
# rounding of one bf16 output (<= 2^-8 relative on values of order 1)
# plus f32 summation order — 2e-2 leaves a 5x margin.
KERNEL_ATOL = 2e-2
# Engine logits, kernel vs plain attention: every layer's attention
# output is rounded to bf16 in both paths, and a 1-ulp difference there
# propagates through 8 bf16 layers into logits of order 1-5; a wrong
# kernel (a dropped page, a wrong head) moves logits by O(1).
LOGITS_ATOL = 0.25

# Flash kernels vs plain (phase 6), B 2, H 8, bf16 N(0, 1) inputs: the
# slice's shape and its edges (ragged T, full attention, a window, Dh 64).
FLASH_CASES = {
    "causal_t8192": dict(t=8192, dh=128, causal=True, window=None),
    "ragged_t1000": dict(t=1000, dh=128, causal=True, window=None),
    "full_t1024": dict(t=1024, dh=128, causal=False, window=None),
    "window256_t2048": dict(t=2048, dh=128, causal=True, window=256),
    "dh64_t2048": dict(t=2048, dh=64, causal=True, window=None),
    # Edges of the forward's 128 x 128 tiling: a window that is a multiple
    # of neither block, and T shorter than one q block.
    "window100_t2048": dict(t=2048, dh=128, causal=True, window=100),
    "t77": dict(t=77, dh=128, causal=True, window=None),
    # Edges of the backward's tiles (128-row blocks over 64-row tiles):
    # a window that is a multiple of neither, over a T that is not a
    # multiple of 128.
    "window300_t1000": dict(t=1000, dh=128, causal=True, window=300),
    # A ring hop after the first (phase 18): full attention at the shard
    # length of T 8192 over seq 2.
    "full_t4096": dict(t=4096, dh=128, causal=False, window=None),
}
# o, gated per row: max over (b, t, h) of ||o - o_ref|| / ||o_ref|| over
# Dh. Row i of o averages ~i/e values of v, so |o| falls from ~2-4 on the
# first rows to ~0.02 at T 8192, and an absolute limit that fits the
# first rows is as large as the late rows themselves. Per row, the
# kernel's roundings (p to bf16 before p·v, o to bf16; each <= 2^-9
# relative, the plain version rounds only o) give ~2e-3; a wrong V tile
# or mask on any row moves its ratio by O(1).
O_ROW_RTOL = 1e-2
# o, absolute, an extra check: one bf16 ulp on the first rows (|o| ~ 2-4)
# is 1.6e-2.
O_ATOL = 2e-2
# lse: both in f32 from the same bf16 inputs (products exact in f32); they
# differ by summation order and exp2 vs exp, ~1e-6 on values ~10.
LSE_ATOL = 1e-3
# Gradients, max|a - b| / max|b|: the kernels round p and ds to bf16
# before the products (as the Pallas kernels do) and dq/dk/dv to bf16,
# each <= 2^-9 relative. Against the plain backward fed the kernel's own
# o and lse (each kernel alone) also per row, as for o: late rows of dq
# and late keys of dk/dv are small. Against autograd through the plain
# attention only as a whole: autograd takes delta = rowsum(dO·O) from the
# f32 o, the kernels (as the Pallas ones) from the bf16 o they return,
# and on a row whose dq cancels (a softmax peaked on one of the first
# few keys) that difference, not the kernel, sets the row's ratio.
GRAD_RTOL = 2e-2

# The LM training slice: bench.py's LM model (bench.py:243-251) at full
# width and depth, bf16, RoPE; remat off (bench.py turns it on only to fit
# a 16 GB chip; it changes memory, not numbers). bench.py's batch and
# sequence on one chip, and its token count with eval off.
LM_MODEL = dict(vocab_size=32_000, d_model=1024, n_heads=8, n_layers=8,
                d_ff=4096, max_seq_len=8192, pos_embedding="rope")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 5
# Phase 8a runs the plain attention too, which keeps f32 [B, H, T, T]
# tensors of every layer for the backward: T 2048 holds them in a few GB.
CHECK_SEQ = 2048
# Step-0 loss, kernels vs plain attention, on a loss of ~ln(32000) = 10.4:
# every layer's activations are bf16 in both paths and the two attentions
# round differently (the kernel rounds p to bf16 before p·v), a relative
# 2^-8 per layer that the mean over 4096 tokens averages down. A wrong
# kernel (a dropped block, a wrong mask) moves the loss by far more.
TRAIN_LOSS_ATOL = 2e-2
# Gradients of blocks.wqkv, blocks.wo and head, max|a - b| / max|b|: the
# per-kernel error of phase 6 (<= 2e-2) compounded through 8 bf16 layers.
TRAIN_GRAD_RTOL = 5e-2

# The fused SGD kernels (phases 9-10) at the CNN slice's 173 MobileNetV2
# parameter leaves, f32 N(0, 1) values and gradients. Variants: the
# slice's SGD (momentum 0.9, wd 1e-4), nesterov, no weight decay, and
# momentum 0 (the plain_sgd kernel).
SGD_VARIANTS = {
    "momentum_wd": dict(momentum=0.9, weight_decay=1e-4, nesterov=False),
    "nesterov_wd": dict(momentum=0.9, weight_decay=1e-4, nesterov=True),
    "momentum_no_wd": dict(momentum=0.9, weight_decay=0.0, nesterov=False),
    "no_momentum": dict(momentum=0.0, weight_decay=1e-4, nesterov=False),
}
SGD_UPDATES = 5
SGD_SMALL_BUCKET_BYTES = 1 << 20       # ~10 buckets of MobileNetV2
# Kernel vs plain over p and m: the kernel rounds each product and sum on
# its own (__fmul_rn/__fadd_rn), as the plain version's eager ops do, so
# every phase-9 case must agree bit for bit (max_abs_err exactly 0).
# Phase 9's direct wrapper cases, each variant, 2 updates: a cap-sized
# bucket (FUSED_BUCKET_BYTES of f32), a length that is not a multiple of
# 4, a view starting 4 bytes into its buffers (an unaligned head before
# the 16-byte body), and views whose offsets differ (no common alignment:
# all scalar). Offsets in f32 elements for p, m, g.
SGD_WRAPPER_CASES = {
    "cap_bucket": dict(n=16 * 1024 * 1024, offsets=(0, 0, 0)),
    "ragged_n": dict(n=1_000_003, offsets=(0, 0, 0)),
    "unaligned_head": dict(n=2_296_922, offsets=(1, 1, 1)),
    "mixed_offsets": dict(n=100_001, offsets=(1, 2, 3)),
}
# Phase 10's device time per launch: a CUDA graph of K launches rotating
# over R bucket sets (p, m, g) whose total is >= 3x the 50 MB L2, so each
# launch finds its bucket cold; events around graph.replay(), median over
# the replays, / K. Shapes: MobileNetV2's one bucket (the CNN path's) and
# a full FUSED_BUCKET_BYTES bucket (what every bucket of a model over 64
# MiB of f32 parameters fills).
SGD_TIMING_SHAPES = {
    "cnn": dict(n=2_296_922, sets=6, launches=60),
    "cap": dict(n=16 * 1024 * 1024, sets=2, launches=20),
}
SGD_GRAPH_REPLAYS = 15
SGD_HOST_STEPS = 200                   # host enqueue: steps, no sync

# The CNN slice (phase 11): bench.py's CNN workload (bench.py:1343-1361)
# with DMP_BENCH_FUSED_OPT=1 on one device — MobileNetV2 (CIFAR layout),
# bf16 compute over f32 parameters, batch 512, 32 px synthetic data, 4 x
# 512 training images, SGD lr 0.4 / momentum 0.9 / wd 1e-4 / 10 warm-up
# steps / cosine, device-resident, 10 steps per dispatch; bench.py's
# timing shape (bench.py:1562-1586): 2 warm-up dispatches, 50 steps timed.
CNN_BATCH, CNN_SPD, CNN_WARM_DISPATCHES, CNN_TIMED_STEPS = 512, 10, 2, 50
CNN_SIDE_STEPS = 20                    # momentum 0, and fused=False
# 11a, fused kernel vs torch.optim.SGD (fused=False) from the same weights
# and batches, two steps (lr 0 at step 0 under warm-up, 0.04 at step 1):
# the forward of both steps is the same computation on the same values,
# so the losses agree to cuDNN's run-to-run order (bf16, loss ~2.3). The
# step-1 update of every leaf, max|Δa - Δb| / max|Δb|: f32 rounding
# (~1e-6) when the gradients agree bit for bit; a wrong kernel (a dropped
# bucket slot, a missing trace or decay term) moves it by O(1).
CNN_LOSS_ATOL = 1e-2
CNN_UPDATE_RTOL = 5e-2
CNN_STATS_RTOL = 1e-3

# Data parallelism (phase 12): the CNN slice through the port's process
# group. 12a at world = device_count() over NCCL: the gate step, bench.py's
# timing shape (CNN_WARM_DISPATCHES, CNN_TIMED_STEPS) through gspmd, then
# DP_DDP_STEPS ddp steps (bucketed, streaming). 12b: two ranks, DDP with
# per-replica and with synchronized BN, DP_TWO_RANK_STEPS steps of the
# global batch (256 rows a rank), augment off so that the gspmd reference
# at world 1 draws nothing and the two see the same rows.
DP_DDP_STEPS = 20
DP_TWO_RANK_STEPS = 5
# 12b's step-0 loss, two-rank ddp + sync BN vs one-rank gspmd, same weights
# and rows, loss ~2.3: the same function; the two BatchNorms (cuDNN's at
# one rank, the port's f32 E[x²] − E[x]² over the group at two) and the
# convolutions at batch 512 vs 256 round differently, each layer's bf16
# output by up to one ulp (2^-8 relative) on some elements, which the mean
# over 512 rows averages down. A wrong reduction (statistics not divided
# by the world, a rank's rows dropped) moves the loss by O(1); per-rank
# statistics under sync fail the bitwise BN gate instead.
DP_LOSS_ATOL = 2e-2

# The pipeline (phase 13): the CNN cell (MobileNetV2, batch 512, bf16
# over f32, fused SGD lr 0.4 / momentum 0.9 / wd 1e-4) cut at the
# reference's 4-GPU boundaries (scripts/train_model_parallel.py:8-9), one
# FusedSGD per chunk. 13a: the runner in one process, every chunk on the
# one card (listed explicitly); the schedules timed, cuDNN's autotuner off
# (each microbatch size would take its own first pass). 13b: the SPMD
# engine, 2 stages as 2 ranks at the port's cost-balanced 2-stage cut.
PP_STAGES, PP_CUT = 4, (0, 4, 10, 16, 19)
# 13a times PP_TIMED_STEPS steps of each schedule (cut from 20, then 8,
# then 6, so the script stays inside its time) after one warm-up step (the
# gates ran the same schedules before).
PP_WARM_STEPS, PP_TIMED_STEPS = 1, 4
PP_RUNS = {                       # name -> (M, schedule, virtual stages)
    "naive_m1": (1, "gpipe", 1), "gpipe_m4": (4, "gpipe", 1),
    "gpipe_m8": (8, "gpipe", 1), "1f1b_m8": (8, "1f1b", 1),
    "interleaved_v2_m8": (8, "1f1b", 2),
}
PP_SPMD_M, PP_SPMD_STEPS, PP_HOPS = 4, 3, 20

# ResNet (phase 14a): bench.py's CNN workload with DMP_BENCH_MODEL=resnet50
# (bench.py:1320-1387, 1542-1545) — ResNet-50 in the CIFAR layout, the rest
# as phase 11 (batch 512, bf16 over f32, fused SGD, device-resident, 10
# steps per dispatch, bench.py's timing shape). Its 23,520,842 f32
# parameters make two fused SGD buckets at the 64 MiB cap. Beside it one
# ResNet-18 step, and ResNet-50's ImageNet layout (7x7 stride-2 stem, 3x3
# SAME max-pool) forward at batch 32 on 224 px input made at that size.
RN_MODEL, RN_SIDE_MODEL = "resnet50", "resnet18"
RN_IMAGENET_BATCH, RN_IMAGENET_PX = 32, 224
# The DP engines (phase 14b): ResNet-50 in f32 (the gates are the JAX
# package's f32 bounds), global batch 128, augment off, SGD lr 0.01 /
# momentum 0.9 / wd 1e-4 without warm-up (at 0.1 the loss climbs from 2.6
# to 36 in 3 steps), DPE_STEPS steps per case from the same weights and
# batches (2, cut from 3 for the script's time limit: momentum and ZeRO's
# sharded trace act from the second step on). DPE_RTOL: ring vs bucketed
# and ZeRO vs gspmd, per leaf max|a - b| / max|b| after every step — two
# ranks sum two
# values in either order to the same bits, so any gap is a fault of the
# transport or of the slice update, not of rounding. fsdp vs gspmd:
# tests/test_fsdp.py's bounds (losses rel 2e-4; params rtol 2e-4, atol
# 2e-5). The sparse BOW at BowConfig's defaults (vocab 10,000, embed 64,
# 10 classes), 512 rows x 64 tokens, 5 steps at lr 0.1 against dense SGD
# on the global batch: tests/test_sparse_embedding.py's bounds.
DPE_BATCH, DPE_STEPS, DPE_TIMED_STEPS, DPE_LR = 128, 2, 10, 0.01
DPE_RTOL = 1e-5
FSDP_LOSS_RTOL, FSDP_RTOL, FSDP_ATOL = 2e-4, 2e-4, 2e-5
BOW_ROWS, BOW_TOKENS, BOW_STEPS, BOW_LR = 512, 64, 5, 0.1
BOW_RTOL, BOW_ATOL = 1e-5, 1e-6
# The zoo (phase 15a): each of the 16 architectures of
# models/zoo.py at its published CIFAR widths, bf16 over f32 parameters,
# bench.py's SGD recipe (lr 0.4, momentum 0.9, wd 1e-4) through FusedSGD,
# synthetic 32 px data on the card, device-resident: 2 one-step warm-up
# dispatches (cuDNN's autotuner), then 10 steps in one dispatch and one
# sync. Cuts: batch 128, not bench.py's 512, so 16 models fit the phase's
# time; and only the ZOO_TIMED models are timed, with cuDNN's autotuner
# on as train_cnn runs. The other 11 run the same steps and gates with
# the autotuner off and report no time: its first pass over the 16
# models' ~380 distinct convolutions took 125-173 s, which the script
# with phase 19 has no room for. ZOO_TIMED: a plain 3x3 network and a
# depthwise one (cut from five, one of each kind of layer, for the
# script's time limit: each timed model pays its own autotuner pass).
# ZOO_PARAMS: the JAX
# package's parameter count of each (jax.eval_shape of its init on the
# CPU; tests/test_torch_zoo_models.py).
ZOO_BATCH, ZOO_WARM_DISPATCHES, ZOO_TIMED_STEPS = 128, 2, 10
# The untimed models: one dispatch of this many steps, no warm-up (the
# warm-ups serve the timing alone).
ZOO_UNTIMED_STEPS = 2
ZOO_TIMED = ("vgg16", "mobilenetv1")
ZOO_PARAMS = {
    "vgg11": 9228362, "vgg13": 9413066, "vgg16": 14724042,
    "vgg19": 20035018, "preactresnet18": 11171210, "senet18": 11260290,
    "googlenet": 6158346, "densenet121": 6956362,
    "resnext29_2x64d": 9130314, "mobilenetv1": 3217226, "dpn92": 34236634,
    "shufflenetg2": 888158, "shufflenetv2": 1263854,
    "efficientnetb0": 3598598, "regnetx_200mf": 2321946,
    "simpledla": 15142970,
}
# Resume (phase 15b/c): the reference's workload (MobileNetV2,
# bf16, fused SGD, augment on), 3,072 / 512 synthetic rows, batch 256
# (12 steps an epoch; cut from 4,096 / 1,024 for the script's time), 2
# epochs, preempted at step 5 of epoch 1 (the first dispatch boundary
# after it at 10 steps a dispatch, inside the epoch), cuDNN
# deterministic.
RES_TRAIN, RES_EVAL, RES_BATCH, RES_PREEMPT_STEP = 3072, 512, 256, 5
# The pipeline's harness (phase 13c/13d): 15b's workload and gate through
# the pipeline. 13c: PipelineTrainer over PP_STAGES stages at the
# reference's cut, gpipe M=4, RES_TRAIN / RES_EVAL rows. 13d: two SPMD
# ranks, gpipe and 1f1b M=4, on PPS_TRAIN / PPS_EVAL rows (cut from 15b's
# 3,072 / 512, then 1,024 / 256, so that the two-epoch fits over the
# host-staged gloo hops fit the script's time: 768 rows are 3 steps an
# epoch, preempted at step PPS_PREEMPT_STEP of epoch 1, one step before its
# end as 15b's step 5 of 6 was), then interleaved V=2 M=4 for PP_SPMD_STEPS
# steps against the runner, and 1F1B's hops beside it. 15c's two-rank fits
# take the same rows and preemption.
PPR_M = 4
PPS_TRAIN, PPS_EVAL, PPS_PREEMPT_STEP = 768, 256, 2
# The data path (phase 16): (a) the reference's finetune recipe
# (Readme.md:186-202, SURVEY.md:309): MobileNetV2 in the ImageNet layout,
# bf16 over f32, FusedSGD lr 0.05 / momentum 0.9 / wd 1e-4 / 10 warm-up
# steps, batch 128 of CIFAR-shaped 32 px synthetic rows held on the card
# (4 x 128) and resized to 224 px in every step, device-resident, 10
# steps a dispatch, bench.py's timing shape (CNN_WARM_DISPATCHES, then
# CNN_TIMED_STEPS). FT_RESIZE_ATOL / FT_TIE: the resize on the card
# against its CPU run on the same batch, as tests/test_torch_data_path.py
# holds it against jax.image.resize (float values on the 0-255 scale;
# uint8 equal away from .5 ties). (b) one epoch of 15b's workload on the
# host path with both prefetch stages against both off. (c) the native
# row gather at batch 512 of 50,000 CIFAR-shaped rows against numpy
# indexing, FT_GATHER_REPS batches each.
FT_BATCH, FT_PX, FT_LR = 128, 224, 0.05
FT_RESIZE_ATOL, FT_TIE = 1e-3, 1e-3
FT_GATHER_ROWS, FT_GATHER_BATCH, FT_GATHER_REPS = 50_000, 512, 50
# The rest of the data-parallel CNN trainer (phase 17). 17a: the CNN cell
# of phase 11 (MobileNetV2 CIFAR, bf16 over f32, B 512, device-resident,
# 10 steps a dispatch) under each optimizer at OPT_LR, no warm-up: the
# first OPT_GATE_UPDATES updates and every state tensor on the card
# against the same chain on the CPU fed the same gradients and
# parameters, per leaf max|card - cpu| / max|cpu| within OPT_CPU_RTOL (f32
# rounding of the norms' and means' sums, CUDA's rsqrt: ~1e-7); then
# OPT_STEPS timed steps with finite losses. 17b: accum_steps ACC_K at B
# ACC_MICRO against one step at B ACC_K x ACC_MICRO (the JAX package's
# exact-equivalence claim, config.py:78-80), mobilenetv2_nobn in f32,
# augment off, cuDNN deterministic, ACC_UPDATES updates, each leaf within
# ACC_RTOL (the convolutions at two batch sizes round differently:
# ~1e-7). 17c: EMA_STEPS steps of the CNN cell with ema_decay EMA_DECAY
# against the recurrence on the host in float64 (EMA_RTOL: f32 rounding
# of three steps), then 15b's workload under RESUME_OPT preempted at
# global step RES_PREEMPT_STEP of epoch 1 (odd: mid-accumulation). 17e:
# ddp on a data=4, dcn_data=2 mesh at HIER_BATCH, the hierarchical against
# the bucketed all-reduce per leaf within HIER_RTOL (four ranks summed in
# two orders; the fused update's step is lr-scaled, so the gap stays near
# f32 rounding).
OPT_LR = {"adam": 1e-3, "adamw": 1e-3, "lamb": 1e-2, "lars": 1.0,
          "adafactor": 1e-2}
OPT_GATE_UPDATES, OPT_STEPS, OPT_CPU_RTOL = 3, 10, 1e-5
ACC_K, ACC_MICRO, ACC_UPDATES, ACC_RTOL, ACC_LR = 4, 128, 3, 1e-5, 0.01
EMA_DECAY, EMA_STEPS, EMA_RTOL = 0.9, 3, 1e-6
RESUME_OPT = dict(name="adamw", learning_rate=1e-3, warmup_steps=10,
                  accum_steps=2, ema_decay=0.99)
HIER_BATCH, HIER_RTOL = 128, 1e-6


# The LM over a mesh (phase 18): bench.py's LM model at full width at
# phase 8's B 2, T 8192 and SGD, each run from phase 8's initial weights.
# 18a on one card: remat off, "dots", "full", and the chunked head with
# and without "dots"; LM18_STEPS steps each (the first gated on its loss;
# 2, cut from 3 for the script's time limit: a wrong gradient scale or
# head order shows from step 1 on, below).
LM18_STEPS = 2
# 18a also times the loss's forward and backward through the plain
# lm_loss against LMPipeline at one stage and one microbatch, this many
# alternated runs of each.
LM18_AB_REPS = 6
LM18_VARIANTS = {
    "remat_off": {},
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "remat_full": dict(remat=True, remat_policy="full"),
    "chunk1024": dict(loss_chunk=1024),
    "chunk1024_dots": dict(loss_chunk=1024, remat=True, remat_policy="dots"),
}
# 18b: three meshes of 4 ranks (gloo on one card, NCCL on four under
# --lm-only), LM18_STEPS gated steps then one timed step each.
LM18_MESHES = {
    "model2_seq2_ring": (dict(model=2, seq=2),
                         dict(tp_axis="model", sp_axis="seq")),
    "data2_seq2_ulysses": (dict(data=2, seq=2),
                           dict(sp_axis="seq", sp_impl="ulysses")),
    "data2_model2": (dict(data=2, model=2), dict(tp_axis="model")),
}
# Every step's loss against the one-card trainer's (18a remat off) on the
# same weights, batches and learning rates (18a and 18b both schedule
# LM18_STEPS + 1 steps: 18b's last one is timed). A mesh sums its partial
# products (the row-parallel all-reduce, the ring's lse merge) in another
# bf16 order: 0 to 9e-5 at steps 0-1 on the H100. Control: one step's
# learning rate 14% off (a 3-step cosine against a 4-step one) moved the
# step-2 loss by 4.0e-3, so a wrong gradient scale or a wrong head order
# shows from step 1 on; a dropped shard or a wrong offset moves it by O(1).
LM18_LOSS_ATOL = 1e-3
# 18c: the resume gate at 2 layers (the cut: 2 of bench.py's 8, so three
# fits and their checkpoints of the whole model fit the phase),
# LM18_RESUME_STEPS steps, preempted at step 1 of epoch 0 (2 and 1, cut
# from 5 and 3, then 3 and 2, for the script's time limit; the resumed run
# still takes a step after the restore).
LM18_RESUME_LAYERS = 2
LM18_RESUME_STEPS = 2
LM18_PREEMPT_AT = (0, 1)

# Phase 19: the LM's stage and expert axes at full width (bench.py's LM
# model, bf16, phase 8's SGD, remat off, seed 0's weights), and the MoE
# model of benchmarks/moe_sweep_r5.json (8 experts, top-2; capacity 1.5,
# aux 0.05, z 1e-3 are TransformerConfig's defaults).
LM19_MOE = dict(moe_experts=8, moe_top_k=2)
# The (stage 2, model 2) and (stage 2, expert 2) meshes iii and iv, and
# their 19a references, at 4 of the 8 layers, the fewest V 2 x S 2 allows
# (a cut for the script's time limit: over gloo on one card their steps
# took 2.4-7.2 s at 8 layers, each layer's TP all-reduces or expert
# all-to-alls host-staged).
LM19_CUT_LAYERS = 4
LM19_STEPS = 3
# 19a, one card: name -> (model fields, B, T, M, schedule).
LM19_REFS = {
    "dense_b4_gpipe_m4": ({}, 4, 8192, 4, "gpipe"),
    "dense_b4_m1": ({}, 4, 8192, 1, "gpipe"),
    "dense_b8_t4096_1f1b_m8": (dict(loss_chunk=1024,
                                    n_layers=LM19_CUT_LAYERS), 8, 4096, 8,
                               "1f1b"),
    "moe_b2_m2": (dict(LM19_MOE, n_layers=LM19_CUT_LAYERS), 2, 8192, 2,
                  "gpipe"),
}
# 19b, 4 ranks: name -> (mesh, model fields, B, T, M, schedule, V, the
# 19a reference with the same model, batches and microbatch partition).
# iii runs T 4096 so gpipe's 8 live microbatches fit four ranks on one card.
LM19_MESHES = {
    "i_stage4_gpipe": (dict(stage=4), {}, 4, 8192, 4, "gpipe", 1,
                       "dense_b4_gpipe_m4"),
    "ii_stage4_1f1b_v2": (dict(stage=4), {}, 4, 8192, 4, "1f1b", 2,
                          "dense_b4_gpipe_m4"),
    "iii_stage2_model2_gpipe": (dict(stage=2, model=2),
                                dict(tp_axis="model", loss_chunk=1024,
                                     n_layers=LM19_CUT_LAYERS), 8,
                                4096, 8, "gpipe", 1,
                                "dense_b8_t4096_1f1b_m8"),
    "iii_stage2_model2_1f1b": (dict(stage=2, model=2),
                               dict(tp_axis="model", loss_chunk=1024,
                                    n_layers=LM19_CUT_LAYERS), 8,
                               4096, 8, "1f1b", 1, "dense_b8_t4096_1f1b_m8"),
    "iv_stage2_expert2_moe": (dict(stage=2, expert=2),
                              dict(LM19_MOE, ep_axis="expert",
                                   n_layers=LM19_CUT_LAYERS), 2, 8192, 2,
                              "1f1b", 2, "moe_b2_m2"),
}
# Every step's loss against its 19a reference, as phase 18's bound (a
# mesh sums its partial products in another bf16 order; a wrong gradient
# scale moves step 1's loss by ~4e-3, a dropped microbatch by O(1)).
# Readings on an H100 80GB HBM3 at 700 W: every dense mesh within 2.4e-5;
# the MoE mesh 0 and 6.1e-4 at steps 0 and 1.
LM19_LOSS_ATOL = 1e-3
# The MoE mesh's step 2 (steps 0-1 are held at LM19_LOSS_ATOL): after
# step 0 the expert weights differ from the one card's by bf16 ulps (the
# mesh sums each expert gradient over ep·C rows of half cotangents where
# the card sums C rows: rel 1.4e-4 and 1.5e-4 for w_out and w_in, every
# other leaf's gradient bitwise equal), and with bf16 router logits many
# top-k choices are ties, so routing decisions go another way from step
# 1 on. Readings on an H100 80GB HBM3 at 700 W at 8 layers (19b counts
# them against the card's, LM19_ROUTES): 0, 2,773 and 12,742 of 262,144
# token-choices at steps 0, 1 and 2 (1,374 and 5,812 kept bits), the
# loss 0, 6.1e-4 and 1.29e-3 from the card's, the same in every run. The
# bound is over twice
# the reading; a wrong gradient scale, which moves the loss by ~4e-3,
# fails it, and fails the gradient gate below on every leaf at step 0.
LM19_MOE_STEP2_ATOL = 3e-3
# moe_ffn against the plain per-token version, max|a - b| / max|b f32|.
# Readings on an H100 at 700 W: 0 (the same bf16 products in the same
# order); the control, the plain version in bf16 against its f32 experts
# on the same routing, 6.6e-3. The bound sits below the control, so a
# change of rounding of that size fails it; a wrong slot, gate or drop
# moves a token's row by O(1).
LM19_MOE_RTOL = 1e-3
# Mesh iv's gradient of every leaf after step 0 against the one-card
# run's on the same slice: ||g_mesh - g_card|| / ||g_card|| within
# LM19_GRAD_RTOL and the norm ratio within LM19_GRAD_RATIO (2 where a
# gradient were taken ep = 2 times, about 0.7 where one of two
# microbatches' were lost). Readings on an H100 at 700 W: rel 0 and ratio
# 1 for every leaf but w_in (rel 1.5e-4, ratio 0.999997) and w_out (1.4e-4,
# 0.999997); the bounds are over 6x the largest.
LM19_GRAD_RTOL = 1e-3
LM19_GRAD_RATIO = (0.99, 1.01)
# Files the one-card MoE run leaves for 19b in the run directory: every
# leaf's gradient after step 0 (bf16, canonical order) and each MoE
# layer's routing at steps 0 .. LM19_STEPS - 1.
LM19_MOE_GRADS = "lm19a_moe_grads.pt"
LM19_ROUTES = "lm19a_moe_routes.pt"
# 19c: mesh iv at 4 layers and T 2048 (the cuts: 4 of 8 layers, the
# fewest V 2 x S 2 allows, and a quarter of the tokens, so three fits and
# their 2.8 GB checkpoints fit the phase), 2 steps, preempted at step 1 of
# epoch 0 (cut from 5 and 3, then 3 and 2, for the script's time limit;
# the resumed run still takes a step after the restore).
LM19_RESUME_LAYERS = 4
LM19_RESUME_SEQ = 2048
LM19_RESUME_STEPS = 2
LM19_PREEMPT_AT = (0, 1)

# Phase 20 (decoding beyond the engine). 20a: bench.py's decode workload
# (bench.py:369-386: MODEL at bf16, B 8, prompt 128, 512 new tokens,
# greedy; the prompt random from a seed, not bench's zeros, so the rows
# differ); a chunked-prefill run (2 steps: only its first logits are
# gated) and the 8-expert top-2 MoE variant at 64 new tokens. 20b:
# generate_sharded on (data 2, model 2) at 64 new tokens. 20c: phase 5's
# model and geometry under a chat-like trace, spec_k 4.
GEN_B, GEN_PROMPT, GEN_STEPS = 8, 128, 512
GEN_CHUNK = 32
GEN_MOE = dict(moe_experts=8, moe_top_k=2)
GEN_MOE_STEPS = 64
# The plain path's runs beside them: long enough for the agreement count
# (on an H100 the rows agreed 3-105 tokens of 512), not the whole 512
# (cut: each plain step costs a kernel step's time).
GEN_PLAIN_STEPS, GEN_PLAIN_MOE_STEPS = 128, 16
GEN_MESH = dict(data=2, model=2)
GEN_MESH_STEPS = 64
SPEC_K = 4
SPEC_WIDTHS = (2, 4, 5)
# A spec-on token may differ from the spec-off one only at a bf16 near-tie
# of the spec-off decode step: top-2 logit gap below 2^-7 |top logit|
# (the verify step's products run at B·W rows, not B, so cuBLAS may reduce
# them in another order).
SPEC_TIE_RTOL = 2.0 ** -7
# Phase 21 (the engine's overload controls and planes): bench.py's
# serving-overload workload (bench.py:1126-1320) — the trace of
# build_serve_trace at its defaults (bench.py:543-591: 48 requests at 50
# a second, prompts 16-96, generation 16-256 exponential with mean a
# quarter of the range, seeds 0..47), its model (bench.py:571-578: vocab
# 8192, d 512, 8 heads, 4 layers, d_ff 2048, RoPE, bf16; random weights
# from seed 0) and geometry (:1165-1169: 8 slots, page 16, a pool of
# (slots + 1) x pages a sequence, chunk 32); a 0.3x tail, every third
# request batch, the budgets of :1202-1215.
OVL_MODEL = dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4,
                 d_ff=2048, max_seq_len=96 + 256, pos_embedding="rope")
OVL_TRACE = dict(n=48, rate=50.0, prompt=(16, 96), gen=(16, 256), seed=0)
OVL_GEOMETRY = dict(n_slots=8, page_size=16, n_pages=(8 + 1) * 22,
                    max_seq_len=352, prefill_chunk=32)
# bench.py's factor 2.0 rarely loads the port's engine enough for the
# TTFT burn rule: its prefill and decode iterations cost about the same
# (host-bound), and on a virtual clock of equal iterations (SimClock)
# both packages' engines never fire brownout at 2.0 and always at 2.5
# and 3.0 on this trace. Both run; the brownout-fires gate is held at
# OVL_GATED_FACTOR.
OVL_FACTORS, OVL_GATED_FACTOR, OVL_BAND = (2.0, 3.0), 3.0, 0.8
# Iterations of the capacity engine under the profiler (device busy share;
# a cut: the whole run's trace would cost the profiler tens of seconds).
OVL_PROFILE_ITERS = 24
# 21b: the journal drill at 21a's widths with spec_k 4, f32 (the gate)
# and one bf16 pass (reported), on the trace's first 32 requests (a cut
# for the script's time limit); the engine is killed half-way through
# the uninterrupted run's iterations.
JRN_SPEC_K = 4
JRN_REQS = 32
# 21c: drain/import at 21a's model, the prefix cache on: 8 requests, a
# 64-token system prompt before each trace prompt's first 32 tokens,
# 48 new tokens at most.
MIG_REQS, MIG_SYSTEM, MIG_USER, MIG_GEN = 8, 64, 32, 48
# Phase 22: bench.py's fleet cell (bench_serve_fleet, bench.py:895-1072)
# at 21a's model, trace and geometry: 2 replicas, r1 killed (22a) or
# hard-crashed (22b) at fleet round 40 and revived 20 rounds later;
# post-kill TTFT p99 within max(4 x the reference, 0.5 s) (:925-942).
FLEET_REPLICAS, FLEET_KILL_ROUND, FLEET_REVIVE = 2, 40, 20
FLEET_TTFT_FACTOR, FLEET_TTFT_FLOOR = 4.0, 0.5
# 22c: 4 replicas in 2 cells on a SimClock (one round = 0.02 s), the
# trace's first 24 requests; the last cell killed at cell-site poll 10
# and revived 10 rounds later, then partitioned at poll 30 for 10 polls.
FLEET_CELL_REPLICAS, FLEET_CELLS, FLEET_CELL_REQS = 4, 2, 24
FLEET_CELL_KILL, FLEET_CELL_REVIVE = 10, 10
FLEET_CELL_PARTITION, FLEET_CELL_PARTITION_POLLS = 30, 10
# Busy fleet rounds under the profiler (device busy share).
FLEET_PROFILE_ROUNDS = 16

# Where the phases' trainers write their logs and checkpoints: one
# temporary directory of the run, made by main() and removed at exit;
# spawned ranks inherit the variable.
RUN_DIR_ENV = "CHIP_SMOKE_RUN_DIR"


def run_dirs(name: str) -> dict:
    """A TrainConfig's log_dir, log_name and checkpoint_dir under the
    run's temporary directory (never the working directory)."""
    root = os.environ[RUN_DIR_ENV]
    return dict(log_dir=os.path.join(root, "log"), log_name=name,
                checkpoint_dir=os.path.join(root, "ckpt", name))


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_peak(kind: str) -> float:
    """The H100 SXM's rate from ``utils/profiling``'s tables (the data
    sheet's; the card this script's bounds and MFU are taken for):
    ``"flops"`` the dense bf16 FLOP/s, ``"hbm"`` the memory B/s."""
    from distributed_model_parallel_tpu_torch.utils import profiling

    table = (profiling.GPU_PEAK_FLOPS if kind == "flops"
             else profiling.GPU_PEAK_HBM_BYTES)
    return table["NVIDIA H100 80GB HBM3"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sgd_traffic(n: int, momentum: float, weight_decay: float,
                nesterov: bool) -> dict:
    """One fused SGD update over ``n`` f32 parameters: the HBM bytes it
    must move (p, g and, with a trace, m read once; p and m written once),
    its f32 operations, and its bound — the larger of bytes at the card's
    memory rate and operations at its f32 rate — in ms."""
    bytes_moved = (5 if momentum else 3) * n * 4
    flops = (2 * (weight_decay != 0) + 2 * (momentum != 0)
             + 2 * bool(nesterov and momentum) + 2) * n
    bound_ms, bound_by = max(
        (bytes_moved / card_peak('hbm') * 1e3, "bytes"),
        (flops / F32_FLOPS_PER_S * 1e3, "operations"))
    return dict(bytes=bytes_moved, flops=flops, bound_ms=bound_ms,
                bound_by=bound_by)


def graph_train_ms(launch, k: int, replays: int = SGD_GRAPH_REPLAYS) -> float:
    """Device ms per launch of ``launch(i)``, i = 0..k-1, captured as one
    CUDA graph: CUDA events around ``graph.replay()`` (behind a short
    device sleep, so the host's submission of the graph is not in the
    window), median over ``replays``, divided by k. A refused capture
    raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up before capture
        for i in range(k):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(k):
            launch(i)
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)                 # ~50 us of device time
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    del graph
    return statistics.median(times)


def time_ms(fn, *, reps: int = 30, warmup: int = 5, flush=None) -> float:
    """Median device time of one ``fn()`` call in ms, CUDA events around
    each call, ``flush`` (an L2-sized buffer) rewritten before each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_case(b, h, hkv, dh, page, n, n_pool, positions, seed):
    """Pools [P, page, Hkv, Dh] bf16 on the card with every slot no row
    may read (unreferenced pages, positions past a row's length) set to
    NaN, distinct random pages per row, q [B, 1, H, Dh]."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    tables = torch.randperm(n_pool, generator=gen)[:b * n].reshape(b, n)
    used = torch.zeros(n_pool, page, dtype=torch.bool)
    for row, pos in enumerate(positions):
        t = torch.arange(pos + 1)
        used[tables[row, t // page], t % page] = True
    kp = torch.randn(n_pool, page, hkv, dh, generator=gen)
    vp = torch.randn(n_pool, page, hkv, dh, generator=gen)
    kp[~used] = float("nan")
    vp[~used] = float("nan")
    q = torch.randn(b, 1, h, dh, generator=gen)
    dev = torch.device("cuda")
    return (q.to(dev, torch.bfloat16), kp.to(dev, torch.bfloat16),
            vp.to(dev, torch.bfloat16), tables.to(dev, torch.int32),
            torch.tensor(positions, dtype=torch.int32, device=dev))


def lm_kind(key: str) -> str:
    """Device-time kinds of the serving and LM steps: the port's own
    kernels, cuBLAS GEMMs (nvjet, gemm and xmma kernel names), the rest."""
    if "flash::" in key or "paged_decode" in key:
        return "port kernels"
    if any(s in key.lower() for s in ("nvjet", "gemm", "xmma")):
        return "cuBLAS GEMMs"
    return "other"


def print_profile(label: str, run, card, kind=lm_kind) -> list:
    """``run()`` under ``torch.profiler``: device time by kernel and the
    device's busy share of the run's wall time (kernels run on one
    stream, so their times add), then by ``kind(kernel name)``. ``run``
    returns a note for the summary line. Informational: a profile without
    device events prints "not measured". Returns the (kernel name, device
    us, count) rows. CUDA activity only: every row is a kernel, and the
    host's operator events added to the run's wall and cost the profiler
    tens of seconds to gather (24-30 s for phase 5b's engine run on an
    H100 host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        note = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print(f"profile {label} [{card}]: device time not measured "
              f"(no CUDA events)")
        return rows
    print(f"profile {label} [{card}]: wall {wall_us:.0f} us, device busy "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), {note}; "
          f"top kernels:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us:10.0f} us {n:6d} x  {key[:90]}")
    kinds: dict[str, float] = {}
    for key, us, _ in rows:
        kinds[kind(key)] = kinds.get(kind(key), 0.0) + us
    print("  by kind: " + ", ".join(
        f"{k} {us:.0f} us ({100 * us / busy_us:.1f}%)"
        for k, us in kinds.items()))
    return rows


def profile_engine(Engine, params, cfg, serve, prompts, gens, card) -> None:
    """The same engine workload once more under ``torch.profiler``, each
    request cut to PROFILE_GEN new tokens (cut: the profiler took 42 s to
    gather the trace of the whole 59-step run, and 12-19 s at 16 tokens)."""
    eng = Engine(params, cfg, serve)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, min(g, PROFILE_GEN), seed=i)

    def run():
        eng.run()
        return f"{eng.summary()['decode_steps']} decode steps"

    print_profile("engine", run, card)


def per_batch(fn, *xs):
    """``fn`` over one batch row at a time, outputs joined on dim 0: the
    plain attention versions hold f32 [H, T, T] scores, 2.1 GB per row
    at H 8, T 8192."""
    import torch

    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def row_rel_err(got, want, floor: float = 1e-3) -> float:
    """max over rows (every index but the last) of ||got - want|| /
    max(||want||, floor · the largest ||want||), in f32. The floor keeps
    rows that cancel to ~0 in exact arithmetic (row 0 of causal dq:
    ds_00 = dp_00 - delta_0 = 0) from comparing f32 noise with noise;
    for o at T 8192 (row norms ~11 first, ~0.2 last) it never binds."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    scale = want.norm(dim=-1)
    return (diff / scale.clamp_min(floor * scale.max())).max().item()


def flash_inputs(b, t, h, dh, seed):
    """q, k, v, dO [B, T, H, Dh] bf16 on the card, N(0, 1) from a seed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, dh, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]


def check_flash(fa) -> dict:
    """Phase 6: the three flash kernels against their plain versions in
    bf16 at the training slice's shapes and its edges. Returns the largest
    errors per kernel; fails the phase after listing every violation."""
    import torch

    errs = {"flash_fwd": [0.0, 0.0], "flash_bwd_dq": [0.0, 0.0],
            "flash_bwd_dkv": [0.0, 0.0]}          # [max abs, max row rel]
    bad = []
    for i, (label, c) in enumerate(FLASH_CASES.items()):
        causal, window = c["causal"], c["window"]
        q, k, v, do = flash_inputs(2, c["t"], 8, c["dh"], seed=100 + i)
        o, lse = fa.flash_forward_kernel(q, k, v, causal, window)
        delta = fa.bwd_delta(o, do)
        dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal, window)
        dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal,
                                         window)
        # Both backward kernels again on the same inputs: bit for bit.
        dq2 = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal, window)
        dk2, dv2 = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal,
                                           window)
        torch.cuda.synchronize()
        repeat = {n: torch.equal(a, b) for n, a, b in (
            ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
        bad += [f"{label}: {n} differs between two calls on the same inputs"
                for n, same in repeat.items() if not same]
        del dq2, dk2, dv2
        got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        bad += [f"{label}: non-finite {n}" for n, x in got.items()
                if not torch.isfinite(x).all()]
        o_ref, lse_ref = per_batch(
            lambda q, k, v: fa.flash_forward_plain(q, k, v, causal, window),
            q, k, v)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        o_row = row_rel_err(o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        # Each backward kernel alone: the plain versions fed the kernel's
        # own o (through delta) and lse.
        dq_ref = per_batch(lambda *a: fa.flash_bwd_dq_plain(
            *a, causal, window), q, k, v, do, lse, delta)
        dk_ref, dv_ref = per_batch(lambda *a: fa.flash_bwd_dkv_plain(
            *a, causal, window), q, k, v, do, lse, delta)

        # End to end: autograd through the plain full_attention.
        def auto(q, k, v, do):
            q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = fa.full_attention(q, k, v, causal=causal, window=window)
            return torch.autograd.grad(out, (q, k, v), do)

        aq, ak, av = per_batch(auto, q, k, v, do)
        torch.cuda.synchronize()
        rel = {"dq": rel_err(dq, dq_ref), "dk": rel_err(dk, dk_ref),
               "dv": rel_err(dv, dv_ref), "dq_auto": rel_err(dq, aq),
               "dk_auto": rel_err(dk, ak), "dv_auto": rel_err(dv, av)}
        alone = (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
        row = {n: row_rel_err(x, r) for n, x, r in alone}
        absd = {n: (x.float() - r.float()).abs().max().item()
                for n, x, r in alone}
        print(f"flash {label}: o per-row rel err {o_row:.3e} (rtol "
              f"{O_ROW_RTOL}), max_abs_err {o_err:.3e} (atol {O_ATOL}), "
              f"lse {lse_err:.3e} (atol {LSE_ATOL}); grads max|a-b|/max|b| "
              + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
              + "; per row vs the plain backward "
              + ", ".join(f"{n} {e:.3e}" for n, e in row.items())
              + f" (rtol {GRAD_RTOL} each); second call bitwise equal: "
              + ", ".join(f"{n} {same}" for n, same in repeat.items()))
        if not o_row <= O_ROW_RTOL:
            bad.append(f"{label}: o per-row rel err {o_row} > {O_ROW_RTOL}")
        if not o_err <= O_ATOL:
            bad.append(f"{label}: o err {o_err} > {O_ATOL}")
        if not lse_err <= LSE_ATOL:
            bad.append(f"{label}: lse err {lse_err} > {LSE_ATOL}")
        bad += [f"{label}: {n} rel err {e} > {GRAD_RTOL}"
                for n, e in rel.items() if not e <= GRAD_RTOL]
        bad += [f"{label}: {n} per-row rel err {e} > {GRAD_RTOL}"
                for n, e in row.items() if not e <= GRAD_RTOL]
        for name, a, r in (
                ("flash_fwd", o_err, o_row),
                ("flash_bwd_dq", absd["dq"], row["dq"]),
                ("flash_bwd_dkv", max(absd["dk"], absd["dv"]),
                 max(row["dk"], row["dv"]))):
            errs[name] = [max(errs[name][0], a), max(errs[name][1], r)]
        del q, k, v, do, o, lse, delta, dq, dk, dv, o_ref, lse_ref, dq_ref
        del dk_ref, dv_ref, aq, ak, av, got
        torch.cuda.empty_cache()
    if bad:
        fail("6/flash", "; ".join(bad))
    return errs


def attention_pairs(t: int, causal: bool, window) -> int:
    """Attended (q, k) positions per (b, h)."""
    if not causal:
        return t * t
    if window is not None:
        w = min(window, t)
        return t * w - w * (w - 1) // 2
    return t * (t + 1) // 2


def time_flash(fa, card) -> dict:
    """Phase 7: each flash kernel, its plain version and the library
    yardstick at the LM slice's shapes, CUDA events, L2 flushed before
    each run; the bound from this run's shapes."""
    import torch
    import torch.nn.functional as F

    b, t, h, dh = 2, 8192, 8, 128
    q, k, v, do = flash_inputs(b, t, h, dh, seed=7)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    o, lse = fa.flash_forward_kernel(q, k, v)
    delta = fa.bwd_delta(o, do)
    runs = {
        "flash_fwd": (lambda: fa.flash_forward_kernel(q, k, v),
                      lambda: fa.flash_forward_plain(q, k, v), 4,
                      3, 1),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq_kernel(
            q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta), 6,
            4, 1),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), 8,
            4, 2),
    }
    # Library yardsticks, never called by the port: one SDPA forward, and
    # SDPA's backward alone (for dq and dk/dv together).
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), flush=flush)
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True), flush=flush)
    pairs = attention_pairs(t, True, None)
    out = {}
    for name, (kern, plain, products, n_in, n_out) in runs.items():
        ms = time_ms(kern, flush=flush)
        plain_ms = time_ms(plain, reps=20, warmup=2, flush=flush)
        flops = products * b * h * pairs * dh
        elt = b * t * h * dh * 2                             # one bf16 row set
        vec = b * h * t * 4                                  # one f32 vector
        bytes_moved = (n_in + n_out) * elt + (1 if name == "flash_fwd"
                                              else 2) * vec
        ops_ms = flops / card_peak('flops') * 1e3
        bytes_ms = bytes_moved / card_peak('hbm') * 1e3
        bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        print(f"{name} timing [{card}]: kernel {ms} ms, plain {plain_ms} ms, "
              f"bound {bound_ms} ms ({bound_by}: {flops} flop, "
              f"{bytes_moved} B), {bound_ms / ms:.1%} of bound, library "
              f"{library_ms} ms ("
              + ("SDPA forward" if name == "flash_fwd" else
                 "SDPA backward alone, dq and dk/dv together")
              + f"), ms / library_ms {ms / library_ms:.3f}")
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    print(f"flash backward timing [{card}]: dq + dk/dv {pair} ms, / SDPA "
          f"backward {pair / sdpa_bwd_ms:.3f}")

    # What FlashAttention.backward runs: delta, dq, dk/dv (SDPA's backward
    # includes its own delta pass).
    def whole_backward():
        dl = fa.bwd_delta(o, do)
        fa.flash_bwd_dq_kernel(q, k, v, do, lse, dl)
        fa.flash_bwd_dkv_kernel(q, k, v, do, lse, dl)

    bwd_ms = time_ms(whole_backward, flush=flush)
    print(f"flash whole backward timing [{card}]: delta + dq + dk/dv "
          f"{bwd_ms} ms, / SDPA backward {bwd_ms / sdpa_bwd_ms:.3f}")
    del flush, q, k, v, do, o, lse, delta, qh, kh, vh, doh, oh
    torch.cuda.empty_cache()
    return out


def flash_wrappers(fa) -> dict:
    """Kernel name -> wrapper (each carries its ``launches`` count)."""
    return {"flash_fwd": fa.flash_forward_kernel,
            "flash_bwd_dq": fa.flash_bwd_dq_kernel,
            "flash_bwd_dkv": fa.flash_bwd_dkv_kernel}


def check_training(tfm, lm, fa) -> None:
    """Phase 8a: one step's loss and the gradients of blocks.wqkv,
    blocks.wo and head at full width, T 2048, attention through the
    kernels (``attn_impl="auto"``) against the plain ``full_attention``
    (``"xla"``), on the same weights and tokens."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **LM_MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    watched = {"blocks.wqkv": params["blocks"]["wqkv"],
               "blocks.wo": params["blocks"]["wo"], "head": params["head"]}
    for w in watched.values():
        w.requires_grad_(True)
    stream = lm.make_token_stream(cfg.vocab_size,
                                  TRAIN_BATCH * (CHECK_SEQ + 1), seed=0)
    chunk = torch.from_numpy(stream.reshape(TRAIN_BATCH, -1)).to(
        "cuda", torch.long)
    toks, tgts = chunk[:, :-1], chunk[:, 1:]
    wrappers = flash_wrappers(fa)
    runs = {}
    for impl in ("auto", "xla"):
        before = {n: w.launches for n, w in wrappers.items()}
        loss = tfm.lm_loss(params, toks, tgts,
                           dataclasses.replace(cfg, attn_impl=impl))
        grads = torch.autograd.grad(loss, list(watched.values()))
        torch.cuda.synchronize()
        launched = {n: w.launches - before[n] for n, w in wrappers.items()}
        want = cfg.n_layers if impl == "auto" else 0
        if any(x != want for x in launched.values()):
            fail("8/train", f"attn_impl={impl!r}: flash launches {launched},"
                            f" want {want} each")
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads):
            fail("8/train", f"attn_impl={impl!r}: non-finite loss or grads")
        runs[impl] = (loss.item(), dict(zip(watched, grads)))
    loss_err = abs(runs["auto"][0] - runs["xla"][0])
    rel = {n: rel_err(runs["auto"][1][n], runs["xla"][1][n])
           for n in watched}
    print(f"train check T {CHECK_SEQ}: step-0 loss kernels "
          f"{runs['auto'][0]} vs plain {runs['xla'][0]} (|diff| {loss_err},"
          f" atol {TRAIN_LOSS_ATOL}); grad rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
          + f" (rtol {TRAIN_GRAD_RTOL})")
    bad = [f"{n} grad rel err {e} > {TRAIN_GRAD_RTOL}"
           for n, e in rel.items() if not e <= TRAIN_GRAD_RTOL]
    if not loss_err <= TRAIN_LOSS_ATOL:
        bad.append(f"loss |diff| {loss_err} > {TRAIN_LOSS_ATOL}")
    if bad:
        fail("8/train", "; ".join(bad))
    del params, watched, runs, grads, loss
    torch.cuda.empty_cache()


def train_full_width(tfm, lm, fa, lm_model_flops, card) -> tuple:
    """Phase 8b/8c: the trainer at full width, B 2, T 8192 — the slice's
    main path. Returns the flash kernels' launch counts of the timed run
    and its step-0 loss."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **LM_MODEL)
    config = lm.LMTrainConfig(
        model=cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        steps_per_epoch=TRAIN_STEPS, epochs=1,
        n_tokens=4 * TRAIN_BATCH * (TRAIN_SEQ + 1), eval_batches=0,
        device="cuda", **run_dirs("lm8"))
    # Warm-up: one step of a throwaway trainer (kernel libraries loaded,
    # cuBLAS handles and the allocator's pools made).
    warm = lm.LMTrainer(dataclasses.replace(config, steps_per_epoch=1))
    warm.fit()
    del warm
    torch.cuda.empty_cache()

    trainer = lm.LMTrainer(config, params=tfm.init_params(cfg, seed=0,
                                                          device="cuda"))
    watched = {"head": trainer.params["head"],
               "blocks.wqkv": trainer.params["blocks"]["wqkv"]}
    before = {n: w.detach().clone() for n, w in watched.items()}
    wrappers = flash_wrappers(fa)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = trainer.fit()
    launches = {n: w.launches for n, w in wrappers.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    losses = [r["loss"] for r in trainer.step_log]
    want = cfg.n_layers * TRAIN_STEPS
    print(f"trainer: {len(losses)} steps, flash launches {launches} (want "
          f"n_layers x steps = {want} each); losses {losses}")
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        fail("8/train", f"losses {losses}")
    unchanged = [n for n, w in watched.items() if torch.equal(w, before[n])]
    if unchanged:
        fail("8/train", f"parameters unchanged by training: {unchanged}")
    if any(x != want for x in launches.values()):
        fail("8/train", f"flash launches {launches} != {want} each")
    # Rates over the whole window (every step's tokens over every step's
    # time, the epoch record's mean), so a stall in any step counts; the
    # median is a per-step statistic beside them.
    step_times = [r["step_time_s"] for r in trainer.step_log]
    mean_s = history[-1]["time_per_batch"]
    flops = lm_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"trainer [{card}]: B {TRAIN_BATCH}, T {TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps in {sum(step_times)} s: tokens/s "
          f"{history[-1]['tokens_per_s']}, MFU (lm_model_flops {flops} / "
          f"mean step s / {card_peak('flops'):.0f}) "
          f"{flops / mean_s / card_peak('flops')}; mean step {mean_s} s, "
          f"median step {statistics.median(step_times)} s (steps "
          f"{step_times}); torch.cuda.max_memory_allocated {peak} B; "
          f"epoch record {json.dumps(history[-1])}")

    # 8c: one more step under the profiler.
    toks, tgts = trainer.sample_batch(1, 0)
    print_profile("train step", lambda: f"loss {trainer.train_step(toks, tgts)}",
                  card)
    del trainer, watched, before
    torch.cuda.empty_cache()
    return launches, losses[0]


def sgd_leaves(model_params, seed):
    """f32 N(0, 1) tensors on the card with the model parameters' shapes
    and strides (channels-last conv weights stay so)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.empty_like(p, device="cuda").normal_(generator=gen)
            for p in model_params]


def check_sgd_wrapper_cases(fs) -> list:
    """Phase 9, direct wrapper calls: each case of ``SGD_WRAPPER_CASES``
    and each variant, 2 updates through the kernel's public wrapper on
    views at the case's offsets, against the plain version on copies;
    p and m must agree bit for bit, and each call must count one launch.
    Returns the violations."""
    import torch

    bad = []
    gen = torch.Generator(device="cuda").manual_seed(21)
    for label, c in SGD_WRAPPER_CASES.items():
        n, offs = c["n"], c["offsets"]
        errs = []
        for name, v in SGD_VARIANTS.items():
            bufs = [torch.empty(n + 4, device="cuda").normal_(generator=gen)
                    for _ in range(3)]
            p, m, g = (b[o:o + n] for b, o in zip(bufs, offs))
            m = m if v["momentum"] else None
            rp = p.clone()
            rm = None if m is None else m.clone()
            counter = (fs.plain_sgd_kernel if m is None
                       else fs.fused_sgd_kernel)
            before = counter.launches
            for k in range(2):
                lr = 0.1 * (k + 1)
                sgd_launch(fs, p, m, g, lr, v)
                fs.fused_sgd_plain(rp, rm, g, lr, **v)
            torch.cuda.synchronize()
            err = (p - rp).abs().max().item()
            if m is not None:
                err = max(err, (m - rm).abs().max().item())
            same = torch.equal(p, rp) and (m is None or torch.equal(m, rm))
            errs.append(err)
            if not same or counter.launches - before != 2:
                bad.append(f"{label}/{name}: max_abs_err {err}, launches "
                           f"{counter.launches - before} (want 2)")
        print(f"fused_sgd wrapper {label} (n {n}, offsets {offs} f32): "
              f"max_abs_err per variant {errs} (bitwise required)")
    return bad


def check_fused_sgd(fs, optim, tconfig, model_params, card) -> float:
    """Phase 9: ``FusedSGD`` on the card (the kernels, one bucket; and a
    cap that gives several) against the plain version per leaf, 5 updates
    of each variant under a warm-up/cosine schedule, then the direct
    wrapper cases. Every case must agree bit for bit. Prints the grid the
    kernel picks at the CNN and cap buckets. Returns the largest max-abs
    error of p and m (0)."""
    import torch

    cases = [(name, v, optim.FUSED_BUCKET_BYTES)
             for name, v in SGD_VARIANTS.items()]
    cases.append(("momentum_wd_small_buckets", SGD_VARIANTS["momentum_wd"],
                  SGD_SMALL_BUCKET_BYTES))
    max_abs, bad = 0.0, []
    for i, (label, v, cap) in enumerate(cases):
        cfg = tconfig.OptimizerConfig(learning_rate=0.4, warmup_steps=2,
                                      fused=True, **v)
        schedule = optim.make_schedule(cfg, 10, 1)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=i)]
        ref_p = [x.detach().clone() for x in leaves]
        ref_m = [torch.zeros_like(x) if v["momentum"] else None
                 for x in leaves]
        opt = optim.FusedSGD(leaves, cfg, schedule, bucket_bytes=cap)
        counter = (fs.fused_sgd_kernel if v["momentum"]
                   else fs.plain_sgd_kernel)
        before = counter.launches
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        for k in range(SGD_UPDATES):
            for p, rp, rm in zip(opt.params, ref_p, ref_m):
                g = torch.empty_like(rp).normal_(generator=gen)
                p.grad.copy_(g)
                fs.fused_sgd_plain(rp, rm, g, schedule(k), **v)
            opt.step()
        torch.cuda.synchronize()
        launched = counter.launches - before
        want = SGD_UPDATES * len(opt.buckets)
        errs = []
        for j, (p, rp, rm) in enumerate(zip(opt.params, ref_p, ref_m)):
            errs.append((p - rp).abs().max().item())
            if rm is not None:
                errs.append((opt.momentum_buffer(j) - rm).abs().max().item())
        err = max(errs)
        finite = all(torch.isfinite(p).all() for p in opt.params)
        print(f"fused_sgd {label}: {len(opt.buckets)} bucket(s), "
              f"{launched} launches (want {want}), max_abs_err {err} "
              f"(bitwise required; p and m over {len(leaves)} leaves)")
        if launched != want:
            bad.append(f"{label}: {launched} launches != {want}")
        if not finite or err != 0:
            bad.append(f"{label}: max_abs_err {err} != 0 or non-finite")
        max_abs = max(max_abs, err)
    bad += check_sgd_wrapper_cases(fs)
    if bad:
        fail("9/fused sgd", "; ".join(bad))
    for n, shape in ((SGD_TIMING_SHAPES["cnn"]["n"], "CNN bucket"),
                     (SGD_TIMING_SHAPES["cap"]["n"], "cap bucket")):
        for momentum in (True, False):
            grid = fs.kernel_grid(n, momentum)
            print(f"fused_sgd grid [{card}]: {shape} (n {n}), "
                  f"{'fused_sgd' if momentum else 'plain_sgd'}: "
                  f"{grid['blocks']} CTAs x {grid['threads']} threads, "
                  f"{grid['unroll']} float4 per operand in flight a thread")
    return max_abs


def sgd_launch(fs, p, m, g, lr, v):
    """One update through the public wrapper of the variant's kernel."""
    if v["momentum"]:
        fs.fused_sgd_kernel(p, m, g, lr, **v)
    else:
        fs.plain_sgd_kernel(p, g, lr, v["weight_decay"])


def time_sgd_graph_trains(fs, card) -> dict:
    """Phase 10, device time per launch: for each shape of
    ``SGD_TIMING_SHAPES`` and each variant, the kernel and
    ``torch.optim.SGD(fused=True)`` over the same flat bucket as one leaf
    (the library yardstick, never used by the port), each as a graph
    train over R cold bucket sets. A library call that capture refuses is
    timed as a train of eager calls and says that its time holds the
    host. Returns {variant: {shape: row}}."""
    import torch

    out = {name: {} for name in SGD_VARIANTS}
    for shape, s in SGD_TIMING_SHAPES.items():
        n, r, k = s["n"], s["sets"], s["launches"]
        gen = torch.Generator(device="cuda").manual_seed(11)
        sets = [[torch.empty(n, device="cuda").normal_(generator=gen)
                 for _ in range(3)] for _ in range(r)]
        for name, v in SGD_VARIANTS.items():
            lr = 1e-3
            t = sgd_traffic(n, **v)
            ms = graph_train_ms(lambda i: sgd_launch(
                fs, *sets[i % r], lr, v), k)
            params = [torch.nn.Parameter(st[0]) for st in sets]
            for prm, st in zip(params, sets):
                prm.grad = st[2]
            libs = [torch.optim.SGD([prm], lr=lr, fused=True, **v)
                    for prm in params]
            for lib in libs:                       # allocates the traces
                lib.step()
            try:
                lib_ms = graph_train_ms(lambda i: libs[i % r].step(), k)
                lib_kind = "graph"
            except RuntimeError as e:
                print(f"  torch.optim.SGD(fused=True) capture refused "
                      f"({str(e)[:120]}); timed as eager calls, host "
                      f"included")
                torch.cuda.synchronize()
                lib_ms = time_ms(lambda: [lb.step() for lb in libs],
                                 reps=SGD_GRAPH_REPLAYS) / r
                lib_kind = "eager, host included"
            print(f"fused_sgd device time {shape} {name} [{card}]: kernel "
                  f"{ms} ms/launch, {t['bound_ms'] / ms:.1%} of bound "
                  f"{t['bound_ms']} ms ({t['bound_by']}: {t['bytes']} B, "
                  f"n {n}); library {lib_ms} ms/launch (torch.optim.SGD "
                  f"fused=True, one flat leaf, {lib_kind}), kernel / "
                  f"library {ms / lib_ms:.3f}; {r} sets x {k} launches, "
                  f"median of {SGD_GRAPH_REPLAYS} replays")
            out[name][shape] = dict(ms=ms, bound_ms=t["bound_ms"],
                                    library_ms=lib_ms, library_kind=lib_kind)
            del params, libs
        del sets
        torch.cuda.empty_cache()
    return out


def time_sgd_host(fs, optim, tconfig, model_params, card) -> dict:
    """Phase 10, host enqueue: ``FusedSGD.step`` over MobileNetV2's 173
    leaves (the slot check, the launch, the ctypes call) and the public
    wrapper alone, ``SGD_HOST_STEPS`` calls each on the host clock with no
    sync inside; µs per launch (one bucket)."""
    import torch

    out = {}
    for name in ("momentum_wd", "no_momentum"):
        v = SGD_VARIANTS[name]
        cfg = tconfig.OptimizerConfig(learning_rate=0.1, fused=True, **v)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=9)]
        opt = optim.FusedSGD(leaves, cfg, lambda _: 1e-3)
        p, m, g = opt.flat_buckets()[0]
        times = {}
        for what, fn in (("FusedSGD.step", opt.step),
                         ("wrapper", lambda: sgd_launch(fs, p, m, g, 1e-3,
                                                        v))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SGD_HOST_STEPS):
                fn()
            times[what] = (time.perf_counter() - t0) / SGD_HOST_STEPS * 1e6
            torch.cuda.synchronize()
        print(f"fused_sgd host enqueue {name} [{card}]: FusedSGD.step "
              f"{times['FusedSGD.step']} us per launch ({len(leaves)} leaves, "
              f"1 bucket), public wrapper {times['wrapper']} us per launch; "
              f"{SGD_HOST_STEPS} calls, host clock, no sync")
        out[name] = dict(host_us_per_step=times["FusedSGD.step"],
                         host_us_per_wrapper_launch=times["wrapper"])
        del opt, leaves, p, m, g
    return out


def time_fused_sgd(fs, optim, tconfig, model_params, card) -> dict:
    """Phase 10: each variant's one-bucket update at the slice's shapes —
    the kernel, the plain version on the same bucket, the library call
    (``torch.optim.SGD(fused=True)`` over the 173 leaves, never used by
    the port) and the byte bound, CUDA events around one call after an L2
    flush, median of 30 (the table's continuity column, host enqueue
    included where it outlasts the flush); then the device time per
    launch from graph trains at the CNN and cap buckets, and the host
    enqueue. Returns the rows of the slice's two kernels."""
    import torch

    n = sum(p.numel() for p in model_params)
    if (n != SGD_TIMING_SHAPES["cnn"]["n"] or SGD_TIMING_SHAPES["cap"]["n"]
            != optim.FUSED_BUCKET_BYTES // 4):
        fail("10/fused sgd timing", f"SGD_TIMING_SHAPES do not match the "
             f"CNN bucket ({n}) or FUSED_BUCKET_BYTES")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, v in SGD_VARIANTS.items():
        cfg = tconfig.OptimizerConfig(learning_rate=0.1, fused=True, **v)
        leaves = [torch.nn.Parameter(x) for x in sgd_leaves(model_params,
                                                             seed=7)]
        opt = optim.FusedSGD(leaves, cfg, lambda _: 0.1)
        if len(opt.buckets) != 1:
            fail("10/fused sgd timing", f"{len(opt.buckets)} buckets, want 1")
        p, m, g = opt.flat_buckets()[0]
        g.normal_()
        ms = time_ms(lambda: sgd_launch(fs, p, m, g, 0.1, v), flush=flush)
        plain_ms = time_ms(lambda: fs.fused_sgd_plain(p, m, g, 0.1, **v),
                           flush=flush)
        lib_leaves = [torch.nn.Parameter(x) for x in sgd_leaves(
            model_params, seed=8)]
        for x in lib_leaves:
            x.grad = torch.randn_like(x)
        try:
            lib = torch.optim.SGD(lib_leaves, lr=0.1, fused=True, **v)
            lib_kind = "fused=True"
        except (TypeError, RuntimeError):
            lib = torch.optim.SGD(lib_leaves, lr=0.1, foreach=True, **v)
            lib_kind = "foreach=True (fused unavailable)"
        library_ms = time_ms(lib.step, flush=flush)
        t = sgd_traffic(n, **v)
        print(f"fused_sgd timing {name} [{card}]: kernel {ms} ms, plain "
              f"{plain_ms} ms, library {library_ms} ms (torch.optim.SGD "
              f"{lib_kind}, 173 leaves), bound {t['bound_ms']} ms "
              f"({t['bound_by']}: {t['bytes']} B, {t['flops']} flop), "
              f"{t['bound_ms'] / ms:.1%} of bound (one launch after an L2 "
              f"flush, host enqueue included where it outlasts the flush)")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=t["bound_ms"],
                   bound_by=t["bound_by"], library_ms=library_ms)
        if name == "momentum_wd":
            out["fused_sgd"] = row
        elif name == "no_momentum":
            out["plain_sgd"] = row
        del opt, leaves, lib_leaves, lib, p, m, g
    del flush
    torch.cuda.empty_cache()
    graphs = time_sgd_graph_trains(fs, card)
    host = time_sgd_host(fs, optim, tconfig, model_params, card)
    for kernel, name in (("fused_sgd", "momentum_wd"),
                         ("plain_sgd", "no_momentum")):
        for shape, row in graphs[name].items():
            out[kernel].update({
                f"device_ms_{shape}": row["ms"],
                f"bound_ms_{shape}": row["bound_ms"],
                f"library_flat_ms_{shape}": row["library_ms"],
                f"library_flat_kind_{shape}": row["library_kind"]})
        out[kernel].update(host[name])
    return out


def cnn_config(tconfig, model: str = "mobilenetv2", **optimizer):
    """The CNN slice's TrainConfig (bench.py's CNN workload, one card;
    ``model``: DMP_BENCH_MODEL)."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=model, dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=CNN_BATCH,
            eval_batch_size=CNN_BATCH, image_size=32,
            synthetic_native_size=32, synthetic_train_size=4 * CNN_BATCH,
            synthetic_eval_size=CNN_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=0.4, warmup_steps=10, fused=True),
               **optimizer}),
        device_resident_data=True, steps_per_dispatch=CNN_SPD,
        device="cuda", **run_dirs(model))


def cnn_dispatch_indices(n: int, dispatches: int, batch: int = CNN_BATCH):
    """bench.py's per-dispatch batches (bench.py:1374-1380): one
    ``default_rng(0)`` stream of ``integers(0, n, (10, batch))`` draws, on
    the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, n, (CNN_SPD, batch))
                             .astype(np.int64)).cuda()
            for _ in range(dispatches)]


def cnn_kind(key: str) -> str:
    """Device-time kinds of the CNN step (kernel-name heuristics)."""
    low = key.lower()
    if "fused_sgd" in low:
        return "port kernels (fused_sgd)"
    if "batch_norm" in low or "bn_" in low:
        return "BatchNorm"
    if any(s in low for s in ("conv", "xmma", "implicit", "dgrad", "wgrad",
                              "fprop", "cutlass", "nvjet", "gemm", "sm90")):
        return "cuDNN/cuBLAS conv and GEMM"
    return "other (elementwise, copies, reductions)"


def check_cnn_step(trainer_mod, models, staged, tconfig,
                   model: str = "mobilenetv2", phase: str = "11/cnn") -> None:
    """Phase 11a (14a for ResNet-50): two steps of the CNN slice from the
    same weights and batches through the fused kernel and through
    ``torch.optim.SGD`` (``fused=False``): losses, every leaf's step-1
    update and the BN statistics."""
    import numpy as np
    import torch

    params, state = staged.params_to_jax(models.get_model(
        tconfig.ModelConfig(name=model, dtype="bfloat16"), seed=0,
        device="cpu"))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2]
    runs = {}
    for fused in (True, False):
        t = trainer_mod.Trainer(cnn_config(tconfig, model, fused=fused),
                                params=params, state=state)
        t.run_steps(idx[:1])
        p1 = [p.detach().clone() for p in t.model.parameters()]
        m = t.run_steps(idx[1:])
        loss = m["loss"].cpu().numpy()
        p2 = [p.detach().clone() for p in t.model.parameters()]
        stats = [b.detach().clone() for b in t.model.buffers()]
        runs[fused] = (loss, [b - a for a, b in zip(p1, p2)], stats)
        del t
    loss_a, upd_a, st_a = runs[True]
    loss_b, upd_b, st_b = runs[False]
    loss_err = float(np.abs(loss_a - loss_b).max())
    upd = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(upd_a, upd_b))
    st = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
             for a, b in zip(st_a, st_b))
    label = "cnn" if model == "mobilenetv2" else model
    print(f"{label} check: step-1 loss fused {loss_a} vs torch.optim.SGD "
          f"{loss_b} (|diff| {loss_err}, atol {CNN_LOSS_ATOL}); step-1 "
          f"update per leaf max|a-b|/max|b| {upd:.3e} (rtol "
          f"{CNN_UPDATE_RTOL}); BN statistics {st:.3e} (rtol "
          f"{CNN_STATS_RTOL})")
    if not (loss_err <= CNN_LOSS_ATOL and upd <= CNN_UPDATE_RTOL
            and st <= CNN_STATS_RTOL and np.isfinite(loss_a).all()):
        fail(phase, "fused vs plain update outside tolerance")
    torch.cuda.empty_cache()


def cnn_run(trainer, idxs, steps_kind: str, card) -> dict:
    """Dispatch ``idxs`` (one list entry per dispatch) back to back, one
    sync at the end; returns host losses, seconds and rates."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = [trainer.run_steps(ix) for ix in idxs]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    steps = sum(ix.shape[0] for ix in idxs)
    rec = dict(steps=steps, seconds=dt, step_s=dt / steps,
               samples_per_s=CNN_BATCH * steps / dt, losses=losses)
    print(f"cnn {steps_kind} [{card}]: {steps} steps in {dt} s, step "
          f"{dt / steps} s, {CNN_BATCH * steps / dt} samples/s")
    return rec


def sgd_in_step_us(rows, kernel: str, card) -> float | None:
    """The fused SGD kernel's device µs per launch in a profiled CNN step
    (``print_profile``'s rows); None, printed as not measured, when the
    profile has no such kernel."""
    hits = [(us, n) for key, us, n in rows if "fused_sgd" in key]
    if not hits:
        print(f"cnn step {kernel} device time [{card}]: not measured")
        return None
    us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    print(f"cnn step {kernel} device time [{card}]: {us} us in {n} "
          f"launch(es), {us / n} us per launch (torch.profiler)")
    return us / n


def train_cnn(trainer_mod, fs, tconfig, card) -> tuple:
    """Phase 11b/11c: the CNN slice's main path — bench.py's timing shape
    through ``Trainer.run_steps`` with the fused kernel — then 20 steps
    with momentum 0 (plain_sgd), 20 with ``fused=False`` (a data point),
    and a profiled step with and without momentum. Returns the main
    path's launch counts and each kernel's device µs per launch in its
    profiled step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    trainer = trainer_mod.Trainer(cnn_config(tconfig))
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        trainer.run_steps(ix)
    torch.cuda.synchronize()
    params0 = [p.detach().clone() for p in trainer.model.parameters()]
    stats0 = [b.detach().clone() for b in trainer.model.buffers()]
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    rec = cnn_run(trainer, idxs[CNN_WARM_DISPATCHES:], "trainer (fused)",
                  card)
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    buckets = len(trainer.optimizer.buckets)
    changed_p = sum(not torch.equal(a, b) for a, b in
                    zip(params0, trainer.model.parameters()))
    changed_s = sum(not torch.equal(a, b) for a, b in
                    zip(stats0, trainer.model.buffers()))
    want = CNN_TIMED_STEPS * buckets
    print(f"cnn trainer: losses {rec['losses']}; fused_sgd launches "
          f"{launches['fused_sgd']} (want steps x buckets = {want}), "
          f"plain_sgd {launches['plain_sgd']} (want 0); parameters "
          f"changed {changed_p}/{len(params0)}, BN buffers changed "
          f"{changed_s}/{len(stats0)}")
    if not all(math.isfinite(x) for x in rec["losses"]):
        fail("11/cnn", f"non-finite losses {rec['losses']}")
    if launches != {"fused_sgd": want, "plain_sgd": 0}:
        fail("11/cnn", f"launches {launches}, want fused_sgd {want}")
    if changed_p != len(params0) or changed_s != len(stats0):
        fail("11/cnn", "parameters or BN statistics unchanged by training")

    # FLOPs of one step: 3 x the forward's convolution and matmul FLOPs as
    # FlopCounterMode counts them (the backward computes the input and the
    # weight gradient of each; BN, elementwise work and the update are not
    # counted). Its count of a whole train step is printed beside it but
    # not used: its convolution_backward formula ignores `groups`, so it
    # counts each depthwise conv's backward as a dense conv's.
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        trainer.model.apply(torch.zeros(CNN_BATCH, 32, 32, 3,
                                        dtype=torch.bfloat16, device="cuda"),
                            train=False)
    flops = 3 * counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        trainer.run_steps(idxs[-1][:1])
    print(f"cnn trainer: FlopCounterMode forward x 3 = {flops} flop per "
          f"step (its whole-step count, depthwise backward as dense: "
          f"{counter.get_total_flops()})")
    print(f"cnn trainer [{card}]: B {CNN_BATCH}, {CNN_TIMED_STEPS} steps "
          f"(after {CNN_WARM_DISPATCHES} warm-up dispatches of {CNN_SPD}), "
          f"one sync: samples/s/chip {rec['samples_per_s']}, step "
          f"{rec['step_s']} s, MFU ({flops} flop per step "
          f"/ step s / {card_peak('flops'):.0f}) "
          f"{flops / rec['step_s'] / card_peak('flops')}, "
          f"torch.cuda.max_memory_allocated {peak} B; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}, cudnn "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32}")

    # 11c: one step under the profiler.
    rows = print_profile("cnn step", lambda: f"loss "
                         f"{trainer.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    in_step = {"fused_sgd": sgd_in_step_us(rows, "fused_sgd", card)}
    del trainer, params0, stats0

    # Momentum 0: the plain_sgd kernel, once per step.
    side = trainer_mod.Trainer(cnn_config(tconfig, momentum=0.0))
    side.run_steps(idxs[0][:2])                    # warm-up
    fs.plain_sgd_kernel.launches = 0
    r0 = cnn_run(side, [idxs[1], idxs[2]], "trainer (fused, momentum 0)",
                 card)
    launches["plain_sgd"] = fs.plain_sgd_kernel.launches
    if launches["plain_sgd"] != CNN_SIDE_STEPS or not all(
            math.isfinite(x) for x in r0["losses"]):
        fail("11/cnn", f"momentum 0: plain_sgd launches "
                       f"{launches['plain_sgd']} != {CNN_SIDE_STEPS}, or "
                       f"non-finite losses {r0['losses']}")
    rows = print_profile("cnn step (momentum 0)", lambda: f"loss "
                         f"{side.run_steps(idxs[0][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    in_step["plain_sgd"] = sgd_in_step_us(rows, "plain_sgd", card)
    del side
    # fused=False: the port's per-leaf torch.optim.SGD, as a data point.
    side = trainer_mod.Trainer(cnn_config(tconfig, fused=False))
    side.run_steps(idxs[0][:2])
    cnn_run(side, [idxs[1], idxs[2]], "trainer (fused=False, "
            "torch.optim.SGD per leaf)", card)
    del side
    # Trainer.fit, one epoch (4 steps + eval) on each input path: the
    # device-resident dataset and per-batch pinned uploads.
    for resident in (True, False):
        t = trainer_mod.Trainer(cnn_config(tconfig).replace(
            epochs=1, device_resident_data=resident))
        before = fs.fused_sgd_kernel.launches
        hist = t.fit()
        n = fs.fused_sgd_kernel.launches - before
        print(f"cnn fit (device_resident_data={resident}): {hist}, "
              f"fused_sgd launches {n}")
        if n != 4 or not all(math.isfinite(hist[0][k]) for k in
                             ("loss_train", "loss_val")):
            fail("11/cnn", f"fit: launches {n} != 4 or non-finite {hist}")
        del t
    torch.cuda.empty_cache()
    return launches, in_step


def dp_config(tconfig, world: int, **kw):
    """The CNN slice's TrainConfig over ``world`` ranks (global batch
    CNN_BATCH); ``augment=False`` also gives the 12b data (5 batches)."""
    import dataclasses

    augment = kw.pop("augment", True)
    cfg = cnn_config(tconfig).replace(mesh=tconfig.MeshConfig(data=world),
                                      **kw)
    if not augment:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, augment=False,
            synthetic_train_size=DP_TWO_RANK_STEPS * CNN_BATCH))
    return cfg


def dp_gate_step(trainer_mod, tconfig, spec=None) -> tuple:
    """Two gspmd steps of the CNN slice (lr 0, then 0.04 under warm-up)
    from the seed-0 weights on the first bench batches, cuDNN
    deterministic (no autotuner): the losses and every parameter,
    momentum trace and BN buffer after them, as numpy."""
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = trainer_mod.Trainer(dp_config(tconfig, 1), spec=spec)
    loss = t.run_steps(cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2])["loss"]
    params = list(t.model.parameters())
    moms = [t.optimizer.momentum_buffer(i) for i in range(len(params))]
    out = (loss.cpu().numpy(), [x.detach().cpu().numpy() for x in
                                (*params, *moms, *t.model.buffers())])
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    return out


def dp_streaming_losses(trainer, steps: int, check=None) -> list:
    """``steps`` steps of the streaming path over epoch 0's batches (this
    rank's rows of each), ``check(trainer)`` after each; the global
    losses."""
    losses = []
    trainer.train_loader.set_epoch(0)
    for _, (images, labels) in zip(range(steps), trainer.train_loader):
        m = trainer._train_step(trainer._to_device(images),
                                trainer._to_device(labels),
                                trainer._generator())
        trainer.global_step += 1
        if check is not None:
            check(trainer)
        losses.append(float(m["loss"]))
    return losses


def dp_world_rank(spec) -> dict:
    """Phase 12a on one rank of the NCCL group: the gate step, bench.py's
    CNN workload through gspmd (counts set to 0 just before the timed
    steps and read just after), DP_DDP_STEPS ddp steps (bucketed,
    streaming), and the one-rank reference losses of 12b (world 1 only).
    Numbers come back as plain Python and numpy."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = spec.num_data
    out = {"backend": spec.backend,
           "gate": dp_gate_step(trainer_mod, tconfig, spec)
           if world == 1 else None}

    torch.backends.cudnn.benchmark = True
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    t = trainer_mod.Trainer(dp_config(tconfig, world), spec=spec)
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        t.run_steps(ix)
    torch.cuda.synchronize()
    t.reducer.take_times_us()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    collectives.reset_counts()
    t0 = time.perf_counter()
    ms = [t.run_steps(ix) for ix in idxs[CNN_WARM_DISPATCHES:]]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    bench = dict(steps=CNN_TIMED_STEPS, seconds=dt, step_s=dt / CNN_TIMED_STEPS,
                 samples_per_s=CNN_BATCH * CNN_TIMED_STEPS / dt,
                 losses=losses, peak_bytes=torch.cuda.max_memory_allocated(),
                 fused_sgd=fs.fused_sgd_kernel.launches,
                 plain_sgd=fs.plain_sgd_kernel.launches,
                 reducer_calls=collectives.calls["reducer"],
                 calls=dict(collectives.calls),
                 buckets=len(t.reducer.buckets),
                 allreduce_us=t.reducer.take_times_us())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        t.model.apply(torch.zeros(CNN_BATCH // world, 32, 32, 3,
                                  dtype=torch.bfloat16, device=spec.device),
                      train=False)
    bench["flops_per_rank_step"] = 3 * counter.get_total_flops()
    out["bench"] = bench
    del t, ms

    d = trainer_mod.Trainer(dp_config(tconfig, world, strategy="ddp",
                                      ddp_allreduce="bucketed",
                                      device_resident_data=False), spec=spec)
    d.train_epoch(0)                                   # warm-up, 4 steps
    torch.cuda.synchronize()
    d.reducer.take_times_us()
    fs.fused_sgd_kernel.launches = 0
    collectives.reset_counts()
    t0 = time.perf_counter()
    per_epoch = len(d.train_loader)
    rec = [d.train_epoch(e) for e in range(1, 1 + DP_DDP_STEPS // per_epoch)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["ddp"] = dict(steps=DP_DDP_STEPS, seconds=dt,
                      samples_per_s=CNN_BATCH * DP_DDP_STEPS / dt,
                      losses=[r.loss for r in rec],
                      fused_sgd=fs.fused_sgd_kernel.launches,
                      reducer_calls=collectives.calls["reducer"],
                      buckets=len(d.reducer.buckets),
                      allreduce_us=d.reducer.take_times_us())
    del d
    if world == 1:
        torch.backends.cudnn.benchmark = False
        ref = trainer_mod.Trainer(dp_config(tconfig, 1, augment=False,
                                            device_resident_data=False),
                                  spec=spec)
        out["ref_losses"] = dp_streaming_losses(ref, DP_TWO_RANK_STEPS)
    return out


def dp_two_rank(spec) -> dict:
    """Phase 12b on one of two ranks: ddp with per-replica BN, then with
    synchronized BN, DP_TWO_RANK_STEPS steps of the global batch each
    (augment off), parameters and momentum checked bitwise equal across
    the ranks after every step; each run's losses and both ranks' BN
    statistics."""
    import dataclasses

    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.parallel import ddp
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    checks = []
    for bn in ("local", "sync"):
        cfg = dp_config(tconfig, spec.num_data, augment=False,
                        strategy="ddp", ddp_allreduce="bucketed",
                        device_resident_data=False)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    batchnorm=bn))
        t = trainer_mod.Trainer(cfg, spec=spec)

        def check(tr):
            ddp.assert_ddp_replicated(tr.model, tr.optimizer, spec)
            checks.append(bn)

        t0 = time.perf_counter()
        losses = dp_streaming_losses(t, DP_TWO_RANK_STEPS, check)
        dt = time.perf_counter() - t0
        stats = ddp.gather_replica_state(t.model, spec)
        leaves = [leaf for unit in stats for mod in unit.values()
                  for leaf in mod.values()]
        out[bn] = dict(
            losses=losses, seconds=dt, replicated_checks=checks.count(bn),
            stats_bitwise_equal=all(
                (leaf[0] == leaf[r]).all() for leaf in leaves
                for r in range(1, leaf.shape[0])),
            stats_max_rel_diff=max(
                float(abs(leaf[0] - leaf[1]).max()
                      / max(abs(leaf[1]).max(), 1e-30)) for leaf in leaves),
            allreduce_us=t.reducer.take_times_us())
        del t
    return out


class RideAlong:
    """An earlier phase's rank work carried by a later phase's spawn of as
    many ranks over the same backend (every spawn pays each rank's
    process start: interpreter, imports, CUDA context): ``fn(spec,
    *args)`` on the group laid out as ``config`` (None: as the
    carrier's). :meth:`finish`, called once the carrier has run, hands
    the ranks' results to ``gate`` — the earlier phase's own gating,
    which fills that phase's record in place."""

    def __init__(self, fn, config, args: tuple, gate):
        self.fn, self.config, self.args, self.gate = fn, config, args, gate
        self.results = None

    def finish(self):
        return self.gate(self.results)


class RankLaps:
    """Rank 0 of a spawn prints the seconds of each named part of a rank
    job (where a carrier spawn's time goes)."""

    def __init__(self, spec, job: str):
        self.show = spec.rank == 0
        self.job = job
        self.mark = time.perf_counter()

    def done(self, part: str) -> None:
        now = time.perf_counter()
        if self.show:
            print(f"{self.job} rank 0, {part}: {now - self.mark:.2f} s",
                  flush=True)
        self.mark = now


def rank_jobs(spec, fn, args: tuple, rides: list) -> list:
    """A carrier spawn's rank function: its own ``fn(spec, *args)``, then
    each ride's on the group laid out anew as the ride's mesh."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh as mesh_mod

    t0 = time.perf_counter()
    out = [fn(spec, *args)]
    seconds = [(fn.__name__, time.perf_counter() - t0)]
    for ride_fn, config, ride_args in rides:
        # Each job starts from an emptied allocator cache, as in a spawn
        # of its own.
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ride_spec = (spec if config is None
                     else mesh_mod.make_mesh(config, spec.device))
        out.append(ride_fn(ride_spec, *ride_args))
        seconds.append((ride_fn.__name__, time.perf_counter() - t0))
    if spec.rank == 0:
        print("carrier spawn, rank 0's seconds a job: " + ", ".join(
            f"{name} {s:.2f}" for name, s in seconds), flush=True)
    return out


def dp_in_process(mesh, fn, phase: str, *args):
    """``fn(spec, *args)`` on a one-rank NCCL group that this process
    joins and then leaves (``mesh.run_here``): the rank shares this
    process's CUDA context and cuDNN autotuner results, and pays no
    process start. The cuDNN flags are restored after it."""
    import torch

    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    try:
        return mesh.run_here(fn, *args, device="cuda", backend="nccl",
                             store_dir=os.environ[RUN_DIR_ENV])
    except (RuntimeError, ValueError) as e:
        fail(phase, f"{type(e).__name__}: {e}")
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic \
            = flags


def dp_spawn(mesh, fn, nproc: int, phase: str, *args, rides=(), **kw):
    """``mesh.spawn`` of a phase's rank function (and of the ``rides``
    it carries, each :class:`RideAlong`'s ``results`` set); a failed or
    hung rank fails the phase."""
    try:
        if not rides:
            return mesh.spawn(fn, nproc, *args, device="cuda",
                              timeout_s=600, **kw)
        res = mesh.spawn(rank_jobs, nproc, fn, args,
                         [(r.fn, r.config, r.args) for r in rides],
                         device="cuda", timeout_s=600, **kw)
    except (RuntimeError, TimeoutError, ValueError) as e:
        fail(phase, f"{type(e).__name__}: {e}")
    for i, ride in enumerate(rides, 1):
        ride.results = [x[i] for x in res]
    return [x[0] for x in res]


def data_parallel(mesh, trainer_mod, tconfig, card,
                  rides: list | None = None) -> dict:
    """Phase 12: the CNN slice through the port's process group. 12a:
    world = device_count() over NCCL — the world-1 gate against the
    one-device trainer of phase 11, bench.py's workload through gspmd,
    20 ddp steps; 12b: two ranks (sharing the one card over gloo, or two
    cards over NCCL), ddp with per-replica and synchronized BN — in a
    spawn of its own, or, with ``rides``, carried by 14b's (``"two_ranks"``
    is filled when the ride finishes)."""
    import numpy as np
    import torch

    world = torch.cuda.device_count()
    ref = dp_gate_step(trainer_mod, tconfig)
    torch.cuda.empty_cache()
    # One card: the rank is this process (phase 11 ran the same shapes, so
    # cuDNN's autotuner has nothing left to try); more: a spawn.
    a = (dp_in_process(mesh, dp_world_rank, "12a/data parallel")
         if world == 1 else
         dp_spawn(mesh, dp_world_rank, world, "12a/data parallel")[0])
    transport = a["backend"]
    out = {"world": world, "backend": transport, "transport": transport}
    if world == 1:
        (loss, leaves), (ref_loss, ref_leaves) = a["gate"], ref
        same = [np.array_equal(x, y) for x, y in zip(leaves, ref_leaves)]
        gap = max(float(np.abs(x - y).max()) for x, y in
                  zip(leaves, ref_leaves))
        print(f"dp gate [{card}]: two gspmd steps at world 1 over "
              f"{transport} vs "
              f"phase 11's "
              f"one-device trainer, cuDNN deterministic, same weights and "
              f"batches: losses {loss} vs {ref_loss}; parameters, momentum "
              f"and BN buffers bitwise equal {sum(same)}/{len(same)} (max "
              f"|diff| {gap})")
        if not (np.array_equal(loss, ref_loss) and all(same)):
            fail("12a/data parallel", "the world-1 steps are not bitwise "
                 "the one-device steps")
        out["gate_bitwise"] = True
    b = a["bench"]
    us = sorted(b["allreduce_us"])
    med_us = statistics.median(us)
    mfu = b["flops_per_rank_step"] / b["step_s"] / card_peak('flops')
    per_step = b["reducer_calls"] / b["steps"]
    print(f"dp gspmd [{card}]: world {world}, backend {transport}, "
          f"transport {transport}; B {CNN_BATCH} ({CNN_BATCH // world} a "
          f"rank), "
          f"{b['steps']} steps (after {CNN_WARM_DISPATCHES} warm-up "
          f"dispatches of {CNN_SPD}), one sync: samples/s {b['samples_per_s']}"
          f" ({b['samples_per_s'] / world} a card), step {b['step_s']} s, "
          f"MFU ({b['flops_per_rank_step']} flop a rank a step) {mfu}, "
          f"torch.cuda.max_memory_allocated {b['peak_bytes']} B (rank 0); "
          f"grad-allreduce {med_us} us a step (median; min {us[0]}, max "
          f"{us[-1]}; CUDA events, first bucket launch to the end of "
          f"finish), all-reduce launches a step {per_step} (buckets "
          f"{b['buckets']}); fused_sgd launches {b['fused_sgd']}, plain_sgd "
          f"{b['plain_sgd']}; collectives {b['calls']}")
    print(f"dp gspmd losses [{card}]: {b['losses']}")
    if not all(math.isfinite(x) for x in b["losses"]):
        fail("12a/data parallel", "non-finite losses")
    if (b["fused_sgd"] != b["steps"] * b["buckets"] or b["plain_sgd"]
            or per_step != b["buckets"]):
        fail("12a/data parallel", f"launches: fused_sgd {b['fused_sgd']}, "
             f"plain_sgd {b['plain_sgd']}, all-reduces a step {per_step}; "
             f"want {b['steps']} x {b['buckets']}, 0, {b['buckets']}")
    d = a["ddp"]
    dus = statistics.median(d["allreduce_us"])
    print(f"dp ddp [{card}]: world {world}, allreduce bucketed, streaming "
          f"input: {d['steps']} steps in {d['seconds']} s, samples/s "
          f"{d['samples_per_s']}, grad-allreduce {dus} us a step (median), "
          f"all-reduces {d['reducer_calls']} (buckets {d['buckets']}), "
          f"fused_sgd launches {d['fused_sgd']}; epoch losses {d['losses']}")
    if (d["reducer_calls"] != d["steps"] * d["buckets"]
            or d["fused_sgd"] != d["steps"] * d["buckets"]
            or not all(math.isfinite(x) for x in d["losses"])):
        fail("12a/data parallel", "ddp: wrong launch counts or non-finite "
             "losses")
    out.update(gspmd=dict(samples_per_s=b["samples_per_s"],
                          step_s=b["step_s"], mfu=mfu,
                          peak_bytes=b["peak_bytes"],
                          grad_allreduce_us_median=med_us,
                          allreduce_launches_per_step=per_step,
                          buckets=b["buckets"],
                          fused_sgd_launches=b["fused_sgd"],
                          plain_sgd_launches=b["plain_sgd"]),
               ddp=dict(samples_per_s=d["samples_per_s"],
                        grad_allreduce_us_median=dus))

    two_cards = world >= 2
    backend = "nccl" if two_cards else "gloo"
    torch.cuda.empty_cache()
    if rides is not None:
        rides.append(RideAlong(dp_two_rank, None, (),
                               lambda ranks: dp_two_rank_gate(
                                   out, a, ranks[0], world, card)))
        return out
    return dp_two_rank_gate(out, a, dp_spawn(mesh, dp_two_rank, 2,
                                             "12b/two ranks",
                                             backend=backend)[0],
                            world, card)


def dp_two_rank_gate(out: dict, a: dict, r: dict, world: int,
                     card) -> dict:
    """Phase 12b's gates on rank 0's :func:`dp_two_rank` result ``r``
    (``a``: 12a's rank 0, whose one-rank losses the step-0 gate reads);
    fills ``out``."""
    two_cards = world >= 2
    backend = "nccl" if two_cards else "gloo"
    where = "two cards" if two_cards else "both ranks on the one card"
    for bn in ("local", "sync"):
        x = r[bn]
        print(f"dp two ranks [{card}] bn {bn}: backend {backend}, transport "
              f"{backend} ({where}), ddp bucketed, B {CNN_BATCH} "
              f"({CNN_BATCH // 2} a rank), augment off: losses "
              f"{x['losses']} in {x['seconds']} s;"
              f" params and momentum bitwise equal across ranks after "
              f"{x['replicated_checks']}/{DP_TWO_RANK_STEPS} steps; BN "
              f"statistics bitwise equal across ranks "
              f"{x['stats_bitwise_equal']} (max rel diff "
              f"{x['stats_max_rel_diff']}); grad-allreduce "
              f"{statistics.median(x['allreduce_us'])} us a step (median)")
        if x["replicated_checks"] != DP_TWO_RANK_STEPS:
            fail("12b/two ranks", f"{bn}: replication checked "
                 f"{x['replicated_checks']} times")
    if r["local"]["stats_bitwise_equal"] or not r["sync"][
            "stats_bitwise_equal"]:
        fail("12b/two ranks", "BN statistics must differ across ranks "
             "under local and agree bit for bit under sync")
    if world == 1:
        err = abs(r["sync"]["losses"][0] - a["ref_losses"][0])
        print(f"dp two ranks [{card}]: step-0 loss, ddp + sync BN at 2 "
              f"ranks "
              f"{r['sync']['losses'][0]} vs gspmd at 1 rank "
              f"{a['ref_losses'][0]} (|diff| {err}, atol {DP_LOSS_ATOL}); "
              f"1-rank losses {a['ref_losses']}")
        if not err <= DP_LOSS_ATOL:
            fail("12b/two ranks", f"sync loss off the 1-rank loss by {err}")
        out["two_rank_step0_loss_diff"] = err
    out["two_ranks"] = {"backend": backend, "transport": backend,
                        **{bn: dict(losses=r[bn]["losses"],
                                    stats_bitwise_equal=r[bn][
                                        "stats_bitwise_equal"])
                           for bn in ("local", "sync")}}
    return out


def pp_runner(models, pipeline, tconfig, devices, cfg, *, m: int,
              schedule: str = "gpipe", virtual: int = 1, boundaries=None,
              augment: bool = True, steps_per_epoch: int = 4):
    """A PipelineRunner over ``devices`` from the seed-0 MobileNetV2 (the
    weights phase 11's trainer starts from), with ``cfg``'s optimizer and
    its schedule over ``steps_per_epoch`` x ``cfg.epochs`` steps."""
    from distributed_model_parallel_tpu_torch.data.registry import (
        CIFAR10_MEAN,
        CIFAR10_STD,
    )

    model = models.get_model(cfg.model, seed=cfg.seed, device="cpu")
    return pipeline.PipelineRunner(
        model, devices, optimizer=cfg.optimizer,
        steps_per_epoch=steps_per_epoch, epochs=cfg.epochs,
        mean=CIFAR10_MEAN, std=CIFAR10_STD,
        boundaries=PP_CUT if boundaries is None else boundaries,
        num_microbatches=m, augment=augment, schedule=schedule,
        virtual_stages=virtual, dtype=models.DTYPES[cfg.model.dtype])


def pp_state(runner) -> tuple:
    """Every parameter, momentum trace and BN buffer of a runner, in unit
    order, as numpy."""
    moms = [st.optimizer.momentum_buffer(i) for st in runner.stages
            for i in range(len(st.optimizer.params))]
    return [x.detach().cpu().numpy().copy() for x in (
        *runner.model.parameters(), *moms, *runner.model.buffers())]


def pp_bitwise(a: list, b: list) -> tuple[int, float]:
    import numpy as np

    same = sum(np.array_equal(x, y) for x, y in zip(a, b))
    gap = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    return same, gap


def pp_batches(cfg, idx_rows):
    """The training set on the card and each step's gathered rows."""
    import torch

    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )

    train, _ = load_dataset(cfg.data)
    images = torch.from_numpy(train.images).cuda()
    labels = torch.from_numpy(train.labels).cuda()
    return [(images[ix], labels[ix]) for ix in idx_rows]


def pp_gates(models, pipeline, auto_partition, trainer_mod, tconfig,
             devices, card) -> dict:
    """13a's gates, cuDNN deterministic, augment off: (1) two naive (M=1)
    steps over 4 chunks == phase 11's one-device trainer from the same
    weights and batches; (2) gpipe M=8 == 1f1b M=8 == interleaved V=2 M=8
    (8 chunks at the port's cost-balanced cut), two steps. All bit for
    bit: losses, parameters, momentum, BN buffers."""
    import dataclasses

    import numpy as np
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg = cnn_config(tconfig)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, augment=False))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0][:2]
    ref = trainer_mod.Trainer(cfg)
    ref_loss = ref.run_steps(idx)["loss"].cpu().numpy()
    params = list(ref.model.parameters())
    moms = [ref.optimizer.momentum_buffer(i) for i in range(len(params))]
    ref_state = [x.detach().cpu().numpy()
                 for x in (*params, *moms, *ref.model.buffers())]
    del ref
    batches = pp_batches(cfg, idx)
    naive = pp_runner(models, pipeline, tconfig, devices, cfg, m=1,
                      augment=False)
    loss = np.array([float(pipeline.PipelineRunner.finalize_metrics(
        naive.train_step_device(None, *b), CNN_BATCH)["loss"])
        for b in batches], np.float32)
    same, gap = pp_bitwise(pp_state(naive), ref_state)
    print(f"pp gate naive [{card}]: two M=1 steps over {naive.num_chunks} "
          f"chunks {naive.slices} on {[str(d) for d in naive.devices]} vs "
          f"phase 11's one-device trainer, cuDNN deterministic, augment "
          f"off, same weights and batches: losses {loss.tolist()} vs "
          f"{ref_loss.tolist()}; parameters, momentum and BN buffers "
          f"bitwise equal {same}/{len(ref_state)} (max |diff| {gap})")
    if not (np.array_equal(loss, ref_loss) and same == len(ref_state)):
        fail("13a/pipeline", "naive M=1 is not bitwise the one-device "
                             "trainer")
    del naive
    cut8 = auto_partition.auto_boundaries(
        models.get_model(cfg.model, device="cpu"),
        (auto_partition.microbatch_rows(CNN_BATCH, 8), 32, 32, 3),
        2 * PP_STAGES)
    runs = {}
    for name in ("gpipe_m8", "1f1b_m8", "interleaved_v2_m8"):
        m, sched, v = PP_RUNS[name]
        r = pp_runner(models, pipeline, tconfig, devices, cfg, m=m,
                      schedule=sched, virtual=v,
                      boundaries=cut8 if v > 1 else PP_CUT, augment=False)
        losses = [pipeline.PipelineRunner.finalize_metrics(
            r.train_step_device(None, *b), CNN_BATCH)["loss"]
            for b in batches]
        runs[name] = (losses, pp_state(r), r.num_chunks)
        del r
    base = runs["gpipe_m8"]
    ok = True
    for name in ("1f1b_m8", "interleaved_v2_m8"):
        same, gap = pp_bitwise(runs[name][1], base[1])
        print(f"pp gate schedules [{card}]: {name} ({runs[name][2]} chunks"
              f"{', cut ' + str(cut8) if name.startswith('inter') else ''})"
              f" vs gpipe_m8 ({base[2]} chunks, cut {list(PP_CUT)}), two "
              f"steps: losses {runs[name][0]} vs {base[0]}; bitwise equal "
              f"{same}/{len(base[1])} (max |diff| {gap})")
        ok &= runs[name][0] == base[0] and same == len(base[1])
    if not ok:
        fail("13a/pipeline", "the schedules are not bit for bit the same")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    torch.cuda.empty_cache()
    return {"naive_vs_trainer_bitwise": True, "schedules_bitwise": True,
            "interleaved_cut": cut8}


def sync_cards(devices) -> None:
    """Waits for every card of ``devices`` (``torch.cuda.synchronize()``
    waits for the current one only)."""
    import torch

    for d in sorted({str(x) for x in devices}):
        torch.cuda.synchronize(d)


def pp_time(models, pipeline, fs, tconfig, devices, cut8, card) -> dict:
    """13a timing: each schedule of PP_RUNS from the seed-0 weights (the
    interleaved one over the 8-chunk cut ``cut8``), augment on (one set of
    draws per microbatch), batches already on the card; PP_WARM_STEPS
    steps, then PP_TIMED_STEPS steps, each synced on every card: step s
    (median), host enqueue (the call, no sync), peak memory (the most of
    any card, and per card), fused_sgd launches counted
    from 0 over the timed steps; then one step under the profiler (the
    device's busy time in it)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import (
        step_generator,
    )

    torch.backends.cudnn.benchmark = False
    cfg = cnn_config(tconfig)
    n = PP_WARM_STEPS + PP_TIMED_STEPS
    idx = [i for ix in cnn_dispatch_indices(4 * CNN_BATCH, -(-n // CNN_SPD))
           for i in ix][:n]
    batches = pp_batches(cfg, idx)
    cards = sorted(set(devices))
    out = {}
    for name, (m, sched, v) in PP_RUNS.items():
        r = pp_runner(models, pipeline, tconfig, devices, cfg, m=m,
                      schedule=sched, virtual=v,
                      boundaries=cut8 if v > 1 else None)
        step_s, host_s, losses = [], [], []
        for k, b in enumerate(batches):
            if k == PP_WARM_STEPS:
                sync_cards(cards)
                for d in cards:
                    torch.cuda.reset_peak_memory_stats(d)
                fs.fused_sgd_kernel.launches = 0
                fs.plain_sgd_kernel.launches = 0
            t0 = time.perf_counter()
            mm = r.train_step_device(step_generator(1, k, "cuda"), *b)
            t1 = time.perf_counter()
            sync_cards(cards)
            t2 = time.perf_counter()
            if k >= PP_WARM_STEPS:
                step_s.append(t2 - t0)
                host_s.append(t1 - t0)
                losses.append(pipeline.PipelineRunner.finalize_metrics(
                    mm, CNN_BATCH)["loss"])
        launches = fs.fused_sgd_kernel.launches
        plain = fs.plain_sgd_kernel.launches
        buckets = sum(len(st.optimizer.buckets) for st in r.stages)
        def one_step():
            mm = r.train_step_device(step_generator(1, n, "cuda"),
                                     *batches[-1])
            return f"loss {torch.stack([x['loss'] for x in mm]).mean()}"

        rows = print_profile(f"pp step {name}", one_step, card,
                             kind=cnn_kind)
        rec = dict(m=m, schedule=sched, virtual_stages=v,
                   chunks=r.num_chunks, step_s=statistics.median(step_s),
                   samples_per_s=CNN_BATCH / statistics.median(step_s),
                   host_enqueue_s=statistics.median(host_s),
                   peak_bytes=max(torch.cuda.max_memory_allocated(d)
                                  for d in cards),
                   peak_bytes_per_card={d: torch.cuda.max_memory_allocated(
                       d) for d in cards},
                   fused_sgd=launches, plain_sgd=plain,
                   want=buckets * PP_TIMED_STEPS,
                   device_busy_us=sum(row[1] for row in rows) or None,
                   losses=losses)
        out[name] = rec
        print(f"pp runner {name} [{card}]: M {m}, {sched}, V {v}, "
              f"{r.num_chunks} chunks on {len(set(r.devices))} card(s); "
              f"{PP_TIMED_STEPS} steps after {PP_WARM_STEPS}, each synced: "
              f"step {rec['step_s']} s (median; min {min(step_s)}, max "
              f"{max(step_s)}), samples/s {rec['samples_per_s']}, host "
              f"enqueue {rec['host_enqueue_s']} s a step (median), "
              f"torch.cuda.max_memory_allocated {rec['peak_bytes']} B "
              f"(the most of any card; per card "
              f"{rec['peak_bytes_per_card']}), "
              f"fused_sgd launches {launches} (want chunks x buckets x steps"
              f" = {rec['want']}), plain_sgd {plain} (want 0); "
              f"cudnn.benchmark False")
        print(f"pp runner {name} losses: {losses}")
        if launches != rec["want"] or plain or not all(
                math.isfinite(x) for x in losses):
            fail("13a/pipeline", f"{name}: fused_sgd launches {launches} != "
                                 f"{rec['want']}, plain_sgd {plain} != 0 or "
                                 f"non-finite losses")
        del r
        torch.cuda.empty_cache()
    return out


def pp_fit(pipeline_trainer, fs, tconfig, devices, card) -> dict:
    """One PipelineTrainer.fit epoch through the normal entry point: 4
    steps of gpipe M=4 over the 4-chunk cut (augment on), then eval."""
    cfg = cnn_config(tconfig).replace(
        mesh=tconfig.MeshConfig(stage=PP_STAGES), num_microbatches=4,
        stage_boundaries=PP_CUT, device_resident_data=False, epochs=1)
    t = pipeline_trainer.PipelineTrainer(cfg, devices)
    before = fs.fused_sgd_kernel.launches
    hist = t.fit()
    n = fs.fused_sgd_kernel.launches - before
    want = len(t.train_loader) * t.runner.num_chunks
    print(f"pp fit [{card}]: PipelineTrainer, {PP_STAGES} stages on "
          f"{devices}, gpipe M=4: {hist}; fused_sgd launches {n} (want "
          f"{want})")
    if n != want or not all(math.isfinite(hist[0][k])
                            for k in ("loss_train", "loss_val")):
        fail("13a/pipeline", f"fit: launches {n} != {want} or non-finite "
                             f"{hist}")
    return dict(history=hist, fused_sgd=n)


def pp_spmd_config(tconfig, schedule: str, cut):
    import dataclasses

    cfg = cnn_config(tconfig).replace(
        strategy="spmd_pipeline", mesh=tconfig.MeshConfig(stage=2),
        num_microbatches=PP_SPMD_M, pipeline_schedule=schedule,
        stage_boundaries=tuple(cut), device_resident_data=False)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, augment=False,
        synthetic_train_size=PP_SPMD_STEPS * CNN_BATCH))


def pp_spmd_rank(spec, cut) -> dict:
    """Phase 13b on one rank of the 2-stage mesh: per schedule, the
    Trainer (strategy="spmd_pipeline") from the seed-0 weights, 3 steps
    of epoch 0's batches (cuDNN deterministic, augment off), then its
    stage's parameters, momentum and BN buffers, the hops of those steps,
    epoch 1's steps (each synced) and PP_HOPS ring shifts of the boundary
    activation."""
    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out = {"backend": spec.backend}
    for schedule in ("gpipe", "1f1b"):
        t = trainer_mod.Trainer(pp_spmd_config(tconfig, schedule, cut),
                                spec=spec)
        collectives.reset_counts()
        losses = dp_streaming_losses(t, PP_SPMD_STEPS)
        calls, nbytes = dict(collectives.calls), dict(collectives.wire_bytes)
        moms = [t.optimizer.momentum_buffer(i)
                for i in range(len(t.optimizer.params))]
        state = [x.detach().cpu().numpy().copy() for x in (
            *t.model.parameters(), *moms, *t.model.buffers())]
        step_s = []
        t.train_loader.set_epoch(1)
        for images, labels in t.train_loader:
            images, labels = t._to_device(images), t._to_device(labels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._train_step(images, labels, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        shape, dtype = t.stage.specs(CNN_BATCH // PP_SPMD_M)[1]
        buf = torch.zeros(shape, dtype=dtype, device=spec.device)
        hop_s = []
        for _ in range(PP_HOPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collectives.ppermute_shift(buf, 1, spec.stage_group)
            torch.cuda.synchronize()
            hop_s.append(time.perf_counter() - t0)
        out[schedule] = dict(
            lo=t.stage.lo, hi=t.stage.hi, losses=losses, state=state,
            calls=calls, bytes=nbytes, step_s=step_s,
            hop_us=statistics.median(hop_s) * 1e6,
            hop_bytes=buf.numel() * buf.element_size())
        del t
        torch.cuda.empty_cache()
    return out


def pp_spmd(mesh, models, pipeline, auto_partition, tconfig, card,
            rides: list | None = None) -> dict:
    """Phase 13b: the SPMD engine at stage 2 through mesh.spawn (two ranks
    on the one card over gloo, or two cards over NCCL), gpipe and 1f1b
    M=4, each rank's parameters, momentum and BN statistics after 3 steps
    against the runner at S=2, the same cut, M and batches, bit for bit.
    In a spawn of its own, or, with ``rides``, carried by 14b's (the
    record is filled when the ride finishes)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import BatchLoader
    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )

    two_cards = torch.cuda.device_count() >= 2
    backend = "nccl" if two_cards else "gloo"
    cut = auto_partition.auto_boundaries(
        models.get_model(cnn_config(tconfig).model, device="cpu"),
        (auto_partition.microbatch_rows(CNN_BATCH, PP_SPMD_M), 32, 32, 3), 2)
    config = tconfig.MeshConfig(stage=2)
    result: dict = {}

    def gate(ranks):
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        devices = ["cuda:0", "cuda:1" if two_cards else "cuda:0"]
        out = {"backend": backend, "cut": cut,
               "where": ("two cards" if two_cards
                         else "both ranks on the one card")}
        for schedule in ("gpipe", "1f1b"):
            cfg = pp_spmd_config(tconfig, schedule, cut)
            train, _ = load_dataset(cfg.data)
            loader = BatchLoader(train, CNN_BATCH, shuffle=True, seed=0)
            runner = pp_runner(models, pipeline, tconfig, devices, cfg,
                               m=PP_SPMD_M, schedule=schedule, boundaries=cut,
                               augment=False, steps_per_epoch=len(loader))
            loader.set_epoch(0)
            # The ranks' loss: the mean of the microbatch losses in f32.
            losses = [float(torch.stack([m["loss"] for m in (
                runner.train_step_device(
                    None, torch.from_numpy(im).cuda(),
                    torch.from_numpy(lb).cuda()))]).mean())
                for im, lb in loader]
            want = []
            for st in runner.stages:
                moms = [st.optimizer.momentum_buffer(i)
                        for i in range(len(st.optimizer.params))]
                units = [runner.model.units[i] for i in range(st.lo, st.hi)]
                want.append([x.detach().cpu().numpy().copy() for x in (
                    *(p for u in units for p in u.parameters()), *moms,
                    *(b for u in units for b in u.buffers()))])
            rec = {}
            for s, r in enumerate(ranks):
                got = r[schedule]
                same, gap = pp_bitwise(got["state"], want[s])
                rec[s] = dict(same=same, leaves=len(want[s]), gap=gap)
                if (got["lo"], got["hi"]) != (runner.stages[s].lo,
                                              runner.stages[s].hi):
                    fail("13b/spmd pipeline", "a rank holds the wrong units")
            r0 = ranks[0][schedule]
            step_s = [statistics.median(r[schedule]["step_s"]) for r in ranks]
            print(f"pp spmd {schedule} [{card}]: 2 stages as 2 ranks, backend "
                  f"{backend} ({out['where']}), cut {cut}, M {PP_SPMD_M}, "
                  f"{PP_SPMD_STEPS} steps of B {CNN_BATCH}, augment off: rank "
                  f"losses {r0['losses']} vs runner {losses}; parameters, "
                  f"momentum and BN buffers bitwise equal to the runner's at "
                  f"S=2: stage 0 {rec[0]['same']}/{rec[0]['leaves']}, stage 1 "
                  f"{rec[1]['same']}/{rec[1]['leaves']} (max |diff| "
                  f"{max(rec[0]['gap'], rec[1]['gap'])})")
            print(f"pp spmd {schedule} hops [{card}]: stage 0 sent "
                  f"{r0['calls'].get('p2p_send', 0)} hops "
                  f"({r0['bytes'].get('p2p_send', 0)} B), received "
                  f"{r0['calls'].get('p2p_recv', 0)} "
                  f"({r0['bytes'].get('p2p_recv', 0)} B) in {PP_SPMD_STEPS} "
                  f"steps; a ring shift of the boundary activation "
                  f"({r0['hop_bytes']} B) {r0['hop_us']} us (median of "
                  f"{PP_HOPS}, synced, {backend}); step s per rank {step_s} "
                  f"(median of epoch 1's {len(r0['step_s'])} steps, each "
                  f"synced)")
            ok = (all(v["same"] == v["leaves"] for v in rec.values())
                  and r0["losses"] == losses)
            if not ok:
                fail("13b/spmd pipeline", f"{schedule}: the ranks are not "
                                          f"bitwise the runner at S=2")
            out[schedule] = dict(losses=losses, step_s=step_s,
                                 hop_us=r0["hop_us"],
                                 hop_bytes=r0["hop_bytes"],
                                 hops_sent=r0["calls"].get("p2p_send", 0),
                                 bytes_sent=r0["bytes"].get("p2p_send", 0),
                                 bitwise=True)
            del runner
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = bench
        result.update(out)
        return result

    if rides is not None:
        rides.append(RideAlong(pp_spmd_rank, config, (cut,), gate))
        return result
    return gate(dp_spawn(mesh, pp_spmd_rank, 2, "13b/spmd pipeline", cut,
                         backend=backend, config=config))


def ppr_config(tconfig, root: str, name: str, **kw):
    """Phase 13c/13d: 15b's workload (resume_config) through the
    pipeline, gpipe M=PPR_M at the reference's cut unless ``kw`` says
    otherwise."""
    return resume_config(tconfig, root, name).replace(**{
        "mesh": tconfig.MeshConfig(stage=PP_STAGES),
        "stage_boundaries": PP_CUT, "num_microbatches": PPR_M, **kw})


def pp_resume(pipeline_trainer, fs, tconfig, devices, root, card) -> dict:
    """Phase 13c: ``PipelineTrainer`` over ``devices`` (PP_STAGES stages,
    gpipe M=PPR_M at the reference's cut), 15b's workload, cuDNN
    deterministic: ``fit(2)`` against ``fit`` preempted by a
    ``step_hook`` at step RES_PREEMPT_STEP of epoch 1 and finished by
    ``PipelineTrainer(resume=True)`` — bit for bit (parameters, momentum,
    BN statistics, update counts, global step, history); fused_sgd
    launches counted from 0 over the three fits; the "pipeline" slot's
    best_acc, the text log's lines; save and restore ms and the
    checkpoint's bytes (median of 3)."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        PAYLOAD_FILENAME,
    )

    phase = "13c/pipeline resume"
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    a = pipeline_trainer.PipelineTrainer(ppr_config(tconfig, root, "pp_a"),
                                         devices)
    ha = a.fit()
    steps = len(a.train_loader)
    target = steps + RES_PREEMPT_STEP

    def hook(t):
        if t.global_step >= target:
            t.preemption.request()

    cfg = ppr_config(tconfig, root, "pp_b")
    b = pipeline_trainer.PipelineTrainer(cfg, devices)
    b.step_hook = hook
    hb = b.fit()
    stopped_at = (b.global_step, b.train_loader.cursor)
    del b
    r = pipeline_trainer.PipelineTrainer(cfg.replace(resume=True), devices)
    hb = hb + r.fit()
    sync_cards(devices)
    launches = fs.fused_sgd_kernel.launches
    plain = fs.plain_sgd_kernel.launches
    chunks = r.runner.num_chunks
    want = 2 * 2 * steps * chunks * len(r.runner.stages[0].optimizer.buckets)
    sa, sr = resume_state(a), resume_state(r)
    bad = resume_mismatches(sa, sr)
    same_history = history_matches(ha, hb)
    lines = open(os.path.join(root, "log", "pp_b.txt")).read()
    epoch_lines = [x for x in lines.splitlines() if x.startswith("epoch:")]
    preempt_line = (f"preempted: checkpoint saved at epoch 1, global step "
                    f"{stopped_at[0]}") in lines
    resume_line = (f"resume: slot 'pipeline-preempt' -> epoch 1 batch "
                   f"{stopped_at[1]} (global step {stopped_at[0]})") in lines
    best = r.ckpt.restore(r._ckpt_tree(), "pipeline")
    print(f"pp resume [{card}]: PipelineTrainer, {PP_STAGES} stages on "
          f"{devices}, gpipe M={PPR_M}, cut {list(PP_CUT)}, MobileNetV2 "
          f"bf16, B {RES_BATCH}, {steps} steps an epoch, preempted at "
          f"global step {stopped_at[0]} (loader cursor {stopped_at[1]}), "
          f"resumed to {r.global_step}; B vs A: {bad} of {len(sa)} arrays "
          f"differ (parameters, BN statistics, momentum, count, step); "
          f"history equal {same_history}; fused_sgd launches {launches} "
          f"(want fits x epochs x steps x chunks x buckets = {want}), "
          f"plain_sgd {plain} (want 0: momentum 0.9); log: "
          f"{len(epoch_lines)} epoch lines, preemption line "
          f"{preempt_line}, resume line {resume_line}; 'pipeline' slot "
          f"best_acc {float(best['best_acc'])} (the run's {r.best_acc})")
    if bad or not same_history:
        fail(phase, f"the resumed run differs from the uninterrupted one "
                    f"({bad} arrays, history {same_history})")
    if len(epoch_lines) != 2 or not (preempt_line and resume_line):
        fail(phase, f"log lines {lines!r}")
    if launches != want or plain:
        fail(phase, f"fused_sgd launches {launches} != {want} or plain_sgd "
                    f"{plain} != 0")
    if float(best["best_acc"]) != np.float32(r.best_acc):
        fail(phase, "the pipeline slot's best_acc is not the run's")
    tmpl = r._ckpt_tree()
    saves, trees, restores = [], [], []
    for _ in range(3):
        sync_cards(devices)
        t0 = time.perf_counter()
        tree = r._ckpt_tree()
        t1 = time.perf_counter()
        path = r.ckpt.save(tree, "bench")
        t2 = time.perf_counter()
        r._load_tree(r.ckpt.restore(tmpl, "bench"))
        sync_cards(devices)
        t3 = time.perf_counter()
        trees.append((t1 - t0) * 1e3)
        saves.append((t2 - t1) * 1e3)
        restores.append((t3 - t2) * 1e3)
    for st in r.runner.stages:
        st.optimizer._check_views()
    nbytes = os.path.getsize(os.path.join(path, PAYLOAD_FILENAME))
    print(f"pp resume checkpoint [{card}]: {nbytes} B (every chunk's "
          f"parameters, momentum and BN statistics); tree (cards to host) "
          f"{statistics.median(trees)} ms, save {statistics.median(saves)} "
          f"ms, restore + load into the chunks {statistics.median(restores)}"
          f" ms (median of 3); each chunk's FusedSGD views intact")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    del a, r
    torch.cuda.empty_cache()
    return dict(preempted_at=stopped_at[0], cursor=stopped_at[1],
                steps=2 * steps, bitwise=True, history_equal=same_history,
                fused_sgd=launches, plain_sgd=plain, bytes=nbytes,
                tree_ms=trees,
                save_ms=saves, restore_ms=restores,
                best_acc=float(best["best_acc"]))


def pp_resume_rank(spec, configs, train, evals, preempt_at, v2_config,
                   hop_configs) -> dict:
    """Phase 13d on one of two ranks, cuDNN deterministic: the
    preempt/resume gate per config (``workers.preempt_resume``), the
    fused_sgd launches of those runs; then, per ``hop_configs`` entry,
    PP_SPMD_STEPS steps of ``Trainer(strategy="spmd_pipeline")`` with the
    hops and bytes counted, and the interleaved run's stage state."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.parallel import workers
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    runs = workers.preempt_resume(spec, configs, train, evals, preempt_at)
    drop_trees(runs)
    out = {"runs": runs,
           "fused_sgd": fs.fused_sgd_kernel.launches,
           "plain_sgd": fs.plain_sgd_kernel.launches,
           "seconds": time.perf_counter() - t0}
    for name, cfg in hop_configs.items():
        t = trainer_mod.Trainer(cfg, spec=spec)
        collectives.reset_counts()
        losses = dp_streaming_losses(t, PP_SPMD_STEPS)
        rec = dict(losses=losses, calls=dict(collectives.calls),
                   bytes=dict(collectives.wire_bytes), units=t.stage.units)
        if name == "interleaved":
            moms = [t.optimizer.momentum_buffer(i)
                    for i in range(len(t.optimizer.params))]
            rec["state"] = [x.detach().cpu().numpy().copy() for x in (
                *t.model.parameters(), *moms, *t.model.buffers())]
        out[name] = rec
        del t
        torch.cuda.empty_cache()
    return out


def pp_spmd_resume(mesh, models, pipeline, auto_partition, tconfig, root,
                   card, rides: list | None = None) -> dict:
    """Phase 13d: two SPMD ranks (gloo on one card, NCCL on two or more):
    the preempt/resume gate under gpipe and 1f1b M=PPR_M at the 2-stage
    cost-balanced cut, each rank's resumed run == its uninterrupted one
    bit for bit; interleaved V=2 M=PP_SPMD_M at S=2 over the 4-chunk
    cost-balanced cut, PP_SPMD_STEPS steps, each rank's chunks bit for bit
    the runner's interleaved V=2 at S=2 with the same cut; the hops and
    bytes a step of interleaved beside 1f1b. In a spawn of its own, or,
    with ``rides``, carried by 14b's (the record is filled when the ride
    finishes)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.loader import BatchLoader
    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    phase = "13d/spmd resume"
    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    model = models.get_model(cnn_config(tconfig).model, device="cpu")
    cut2 = auto_partition.auto_boundaries(
        model, (auto_partition.microbatch_rows(RES_BATCH, PPR_M), 32, 32,
                3), 2)
    cut4 = auto_partition.auto_boundaries(
        model, (auto_partition.microbatch_rows(CNN_BATCH, PP_SPMD_M), 32,
                32, 3), 4)
    mesh2 = tconfig.MeshConfig(stage=2)
    configs = {s: ppr_config(
        tconfig, root, f"spmd_{s}", strategy="spmd_pipeline", mesh=mesh2,
        stage_boundaries=tuple(cut2), pipeline_schedule=s,
        data=tconfig.DataConfig(
            name="synthetic", batch_size=RES_BATCH,
            eval_batch_size=RES_BATCH, image_size=32,
            synthetic_native_size=32, synthetic_train_size=PPS_TRAIN,
            synthetic_eval_size=PPS_EVAL)) for s in ("gpipe", "1f1b")}
    hops = {"1f1b": pp_spmd_config(tconfig, "1f1b", cut2),
            "interleaved": pp_spmd_config(tconfig, "1f1b", cut4).replace(
                virtual_stages=2)}
    train, evals = load_dataset(configs["gpipe"].data)
    steps = PPS_TRAIN // RES_BATCH
    args = (configs, (train.images, train.labels),
            (evals.images, evals.labels), steps + PPS_PREEMPT_STEP,
            hops["interleaved"], hops)
    result: dict = {}

    def gate(ranks):
        out = {"backend": backend, "cut2": cut2, "cut4": cut4,
               "seconds": [r["seconds"] for r in ranks],
               "fused_sgd": [r["fused_sgd"] for r in ranks],
               "plain_sgd": [r["plain_sgd"] for r in ranks]}
        # Per rank: 2 schedules x (the uninterrupted fit + the preempted one
        # and its resume) x 2 epochs x steps, once per bucket of its stage.
        want = 2 * 2 * 2 * steps
        if any(n == 0 or n % want for n in out["fused_sgd"]) or any(
                out["plain_sgd"]):
            fail(phase, f"launches a rank: fused_sgd {out['fused_sgd']} "
                        f"(want a multiple of {want} above 0), plain_sgd "
                        f"{out['plain_sgd']} (want 0: momentum 0.9)")
        for s in configs:
            leaves = [[tree_flatten((x["runs"][s][run]["params"],
                                     x["runs"][s][run]["momentum"],
                                     x["runs"][s][run]["state"]))[0]
                       for run in "ab"] for x in ranks]
            bad = [resume_mismatches(a, b) for a, b in leaves]
            counts = [(x["runs"][s]["b"]["count"], x["runs"][s]["b"]["step"])
                      for x in ranks]
            same_history = all(history_matches(x["runs"][s]["a"]["history"],
                                               x["runs"][s]["b"]["history"])
                               for x in ranks)
            print(f"pp spmd resume {s}, 2 ranks over {backend} [{card}]: M "
                  f"{PPR_M}, cut {cut2}, B {RES_BATCH}, {steps} steps an "
                  f"epoch, preempted at global step "
                  f"{steps + PPS_PREEMPT_STEP}; arrays "
                  f"differing resumed vs uninterrupted {bad} (of "
                  f"{[len(x[0]) for x in leaves]}) per rank; update count, "
                  f"step "
                  f"{counts} (want {2 * steps}); history equal {same_history}")
            if any(bad) or not same_history or any(
                    c != (2 * steps, 2 * steps) for c in counts):
                fail(phase, f"{s}: the resumed runs differ")
            out[s] = dict(differing=bad, steps=counts[0][1], bitwise=True)
        # Interleaved V=2 at S=2 against the runner, same cut, M, batches.
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        cfg = hops["interleaved"]
        tr, _ = load_dataset(cfg.data)
        loader = BatchLoader(tr, CNN_BATCH, shuffle=True, seed=0)
        devices = ["cuda:0", "cuda:1" if two else "cuda:0"]
        runner = pp_runner(models, pipeline, tconfig, devices, cfg,
                           m=PP_SPMD_M,
                           schedule="1f1b", virtual=2, boundaries=cut4,
                           augment=False, steps_per_epoch=len(loader))
        loader.set_epoch(0)
        losses = [float(torch.stack([m["loss"] for m in (
            runner.train_step_device(None, torch.from_numpy(im).cuda(),
                                     torch.from_numpy(lb).cuda()))]).mean())
            for im, lb in loader]
        rec = {}
        for s, r in enumerate(ranks):
            got = r["interleaved"]
            stages = runner.stages[s::2]
            units = [runner.model.units[i] for st in stages
                     for i in range(st.lo, st.hi)]
            moms = [st.optimizer.momentum_buffer(i) for st in stages
                    for i in range(len(st.optimizer.params))]
            want = [x.detach().cpu().numpy().copy() for x in (
                *(p for u in units for p in u.parameters()), *moms,
                *(b for u in units for b in u.buffers()))]
            same, gap = pp_bitwise(got["state"], want)
            rec[s] = dict(same=same, leaves=len(want), gap=gap,
                          units=got["units"])
        per_step = {name: {k: ranks[0][name]["calls"].get(k, 0) / PP_SPMD_STEPS
                           for k in ("p2p_send", "p2p_recv")} for name in hops}
        byte_step = {name: ranks[0][name]["bytes"].get("p2p_send", 0)
                     / PP_SPMD_STEPS for name in hops}
        print(f"pp spmd interleaved [{card}]: V=2 at S=2 over {backend}, 4 "
              f"chunks at {cut4}, M {PP_SPMD_M}, {PP_SPMD_STEPS} steps of B "
              f"{CNN_BATCH}, augment off: rank losses "
              f"{ranks[0]['interleaved']['losses']} vs runner {losses}; each "
              f"rank's chunks (units {[rec[s]['units'] for s in rec]}) "
              f"bitwise "
              f"equal to the runner's interleaved V=2 at S=2: "
              f"{[(rec[s]['same'], rec[s]['leaves']) for s in rec]} (max "
              f"|diff|"
              f" {max(v['gap'] for v in rec.values())})")
        print(f"pp spmd hops a step [{card}]: stage 0 sends/receives "
              f"{per_step['1f1b']} hops and sends {byte_step['1f1b']} B under "
              f"1f1b M={PP_SPMD_M} (2 chunks), {per_step['interleaved']} hops "
              f"and {byte_step['interleaved']} B interleaved V=2 (4 chunks)")
        if not (all(v["same"] == v["leaves"] for v in rec.values())
                and ranks[0]["interleaved"]["losses"] == losses):
            fail(phase, "interleaved V=2: the ranks are not bitwise the "
                        "runner")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = bench
        del runner
        torch.cuda.empty_cache()
        out["interleaved"] = dict(bitwise=True, losses=losses,
                                  hops_per_step=per_step["interleaved"],
                                  bytes_sent_per_step=byte_step["interleaved"])
        out["1f1b_hops"] = dict(hops_per_step=per_step["1f1b"],
                                bytes_sent_per_step=byte_step["1f1b"])
        result.update(out)
        return result

    if rides is not None:
        rides.append(RideAlong(pp_resume_rank, mesh2, args, gate))
        return result
    return gate(dp_spawn(mesh, pp_resume_rank, 2, phase, *args,
                         backend=backend, config=mesh2))


def pipeline_phase(laps, models, cnn_trainer, fs, tconfig, card,
                   rides: list | None = None) -> dict:
    """Phase 13: the runner over ``[cuda:(c % n)]`` for PP_STAGES stages
    (gates, timing, a fit epoch), the SPMD engine at 2 stages, then the
    harness: preempt/resume on the runner and at two ranks, interleaved
    over ranks (13b and 13d carried by 14b's spawn with ``rides``)."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh
    from distributed_model_parallel_tpu_torch.parallel import (
        auto_partition,
        pipeline,
    )
    from distributed_model_parallel_tpu_torch.train import pipeline_trainer

    n_cards = torch.cuda.device_count()
    pp_devices = [f"cuda:{c % n_cards}" for c in range(PP_STAGES)]
    pp = {"devices": pp_devices,
          "gates": pp_gates(models, pipeline, auto_partition, cnn_trainer,
                            tconfig, pp_devices, card)}
    laps.done("13a/pipeline gates")
    pp["runner"] = pp_time(models, pipeline, fs, tconfig, pp_devices,
                           pp["gates"]["interleaved_cut"], card)
    pp["fit"] = pp_fit(pipeline_trainer, fs, tconfig, pp_devices, card)
    laps.done("13a/pipeline runner")
    pp["spmd"] = pp_spmd(mesh, models, pipeline, auto_partition, tconfig,
                         card, rides)
    laps.done("13b/spmd pipeline")
    import tempfile

    # Under the run's directory (removed at exit): a carried 13d writes
    # there after this phase returns.
    root = tempfile.mkdtemp(prefix="pp_resume_", dir=os.environ[RUN_DIR_ENV])
    pp["resume"] = pp_resume(pipeline_trainer, fs, tconfig, pp_devices,
                             root, card)
    laps.done("13c/pipeline resume")
    pp["spmd_resume"] = pp_spmd_resume(mesh, models, pipeline,
                                       auto_partition, tconfig, root, card,
                                       rides)
    laps.done("13d/spmd resume")
    return pp


def train_resnet(trainer_mod, fs, models, staged, tconfig, card) -> dict:
    """Phase 14a: ResNet-50 through the CNN trainer at bench.py's
    full-width shape — the fused-vs-torch.optim.SGD check, then the main
    path (bench.py's timing shape, counts set to 0 just before and read
    just after: fused_sgd launches == steps x buckets), 20 momentum-0
    steps (plain_sgd == steps x buckets), a profiled step with the fused
    kernel's device time beside its byte bound; then a ResNet-18 step and
    the ImageNet layout's forward at 224 px."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    check_cnn_step(trainer_mod, models, staged, tconfig, model=RN_MODEL,
                   phase="14a/resnet")
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, CNN_WARM_DISPATCHES + n_disp)
    t = trainer_mod.Trainer(cnn_config(tconfig, RN_MODEL))
    dev = t.device
    n_params = sum(p.numel() for p in t.model.parameters())
    buckets = len(t.optimizer.buckets)
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        t.run_steps(ix)
    torch.cuda.synchronize()
    params0 = [p.detach().clone() for p in t.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    rec = cnn_run(t, idxs[CNN_WARM_DISPATCHES:], f"{RN_MODEL} trainer "
                  f"(fused)", card)
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(params0, t.model.parameters()))
    want = CNN_TIMED_STEPS * buckets
    print(f"{RN_MODEL} trainer: {n_params} parameters in {buckets} "
          f"bucket(s); losses {rec['losses']}; fused_sgd launches "
          f"{launches['fused_sgd']} (want steps x buckets = {want}), "
          f"plain_sgd {launches['plain_sgd']} (want 0); parameters changed "
          f"{changed}/{len(params0)}")
    if not all(math.isfinite(x) for x in rec["losses"]):
        fail("14a/resnet", f"non-finite losses {rec['losses']}")
    if launches != {"fused_sgd": want, "plain_sgd": 0}:
        fail("14a/resnet", f"launches {launches}, want fused_sgd {want}")
    if changed != len(params0):
        fail("14a/resnet", "parameters unchanged by training")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        t.model.apply(torch.zeros(CNN_BATCH, 32, 32, 3, dtype=torch.bfloat16,
                                  device=dev), train=False)
    flops = 3 * counter.get_total_flops()
    mfu = flops / rec["step_s"] / card_peak('flops')
    print(f"{RN_MODEL} trainer [{card}]: B {CNN_BATCH}, {CNN_TIMED_STEPS} "
          f"steps (after {CNN_WARM_DISPATCHES} warm-up dispatches of "
          f"{CNN_SPD}), one sync: samples/s/chip {rec['samples_per_s']}, "
          f"step {rec['step_s']} s, MFU ({flops} flop per step = 3 x "
          f"FlopCounterMode's forward / step s / {card_peak('flops'):.0f}) "
          f"{mfu}, torch.cuda.max_memory_allocated {peak} B")
    rows = print_profile(f"{RN_MODEL} step", lambda: f"loss "
                         f"{t.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=cnn_kind)
    hits = [(us, n) for key, us, n in rows if "fused_sgd" in key]
    bound = sgd_traffic(n_params, 0.9, 1e-4, False)
    kernel_us = sum(h[0] for h in hits) if hits else None
    if kernel_us is None:
        print(f"{RN_MODEL} step fused_sgd device time [{card}]: not measured")
    else:
        print(f"{RN_MODEL} step fused_sgd device time [{card}]: {kernel_us} "
              f"us for {sum(h[1] for h in hits)} launch(es) over "
              f"{n_params} parameters; byte bound {bound['bound_ms'] * 1e3} "
              f"us ({bound['bytes']} B at {card_peak('hbm'):.3g} B/s), "
              f"{bound['bound_ms'] * 1e3 / kernel_us:.1%} of it")
    del t, params0

    side = trainer_mod.Trainer(cnn_config(tconfig, RN_MODEL, momentum=0.0))
    side.run_steps(idxs[0][:2])                    # warm-up
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    r0 = cnn_run(side, [idxs[1], idxs[2]], f"{RN_MODEL} trainer (fused, "
                 f"momentum 0)", card)
    m0 = {"fused_sgd": fs.fused_sgd_kernel.launches,
          "plain_sgd": fs.plain_sgd_kernel.launches}
    want0 = CNN_SIDE_STEPS * buckets
    print(f"{RN_MODEL} momentum 0: launches {m0} (want plain_sgd steps x "
          f"buckets = {want0})")
    if m0 != {"fused_sgd": 0, "plain_sgd": want0} or not all(
            math.isfinite(x) for x in r0["losses"]):
        fail("14a/resnet", f"momentum 0: launches {m0}, want plain_sgd "
                           f"{want0}, or non-finite {r0['losses']}")
    del side

    r18 = trainer_mod.Trainer(cnn_config(tconfig, RN_SIDE_MODEL))
    loss18 = r18.run_steps(idxs[0][:1])["loss"].item()
    del r18
    gen = torch.Generator(device=dev).manual_seed(0)
    net = models.get_model(tconfig.ModelConfig(
        name=RN_MODEL, dtype="bfloat16",
        extra={"input_layout": "imagenet"}), seed=0, device=dev)
    x = torch.randn(RN_IMAGENET_BATCH, RN_IMAGENET_PX, RN_IMAGENET_PX, 3,
                    device=dev, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        y_eval, _ = net.apply(x, train=False)
        y_train, _ = net.apply(x, train=True)
    finite = bool(torch.isfinite(y_eval).all() and torch.isfinite(
        y_train).all())
    print(f"{RN_SIDE_MODEL} step: loss {loss18}; {net.name} forward, B "
          f"{RN_IMAGENET_BATCH} at {RN_IMAGENET_PX} px (stem 7x7/2 + 3x3/2 "
          f"SAME max-pool): logits {tuple(y_eval.shape)} finite {finite}")
    if not (math.isfinite(loss18) and finite and tuple(y_eval.shape) == (
            RN_IMAGENET_BATCH, 10)):
        fail("14a/resnet", "ResNet-18 step or ImageNet forward not finite")
    del net, x
    torch.cuda.empty_cache()
    return dict(model=RN_MODEL, parameters=n_params, buckets=buckets,
                samples_per_s=rec["samples_per_s"], step_s=rec["step_s"],
                mfu=mfu, flops_per_step=flops, peak_bytes=peak,
                launches=launches, launches_momentum0=m0,
                fused_sgd_in_step_us=kernel_us,
                fused_sgd_bound_us=bound["bound_ms"] * 1e3,
                resnet18_loss=loss18, imagenet_forward_finite=finite)


def dpe_config(tconfig, world: int, **kw):
    """Phase 14b's TrainConfig: ResNet-50 in f32 at DPE_BATCH over
    ``world`` ranks, augment off, streaming input, no warm-up."""
    optimizer = kw.pop("optimizer", {})
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=RN_MODEL, dtype="float32"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=DPE_BATCH,
            eval_batch_size=DPE_BATCH, image_size=32,
            synthetic_native_size=32, augment=False,
            synthetic_train_size=(DPE_STEPS + DPE_TIMED_STEPS) * DPE_BATCH,
            synthetic_eval_size=DPE_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=DPE_LR, warmup_steps=0), **optimizer}),
        mesh=tconfig.MeshConfig(data=world), device="cuda",
        **{**run_dirs(f"dpe_{RN_MODEL}"), **kw})


def rel_gap(a, b) -> float:
    """max|a - b| / max|b| over one tensor pair."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def dpe_batches(trainer, n: int) -> list:
    """This rank's rows of epoch 0's first ``n`` batches, on the card."""
    trainer.train_loader.set_epoch(0)
    return [(trainer._to_device(im), trainer._to_device(lb))
            for _, (im, lb) in zip(range(n), trainer.train_loader)]


def dpe_steps(trainer, batches, after=None) -> list:
    """One train step per batch; ``after(trainer)`` after each; the
    global losses."""
    out = []
    for im, lb in batches:
        m = trainer._train_step(im, lb, None)
        trainer.global_step += 1
        out.append(float(m["loss"]))
        if after is not None:
            after(trainer)
    return out


def dpe_sync_fsdp(src, dst, spec) -> None:
    """Copy the gspmd trainer ``src``'s parameters and momentum into the
    fsdp trainer ``dst``: each sharded leaf gets this rank's slice."""
    import torch
    from torch.nn.utils import parametrize

    n, r = spec.num_data, spec.data_index
    smods = dict(src.model.named_modules())
    sstate, dstate = src.optimizer.opt.state, dst.optimizer.opt.state
    with torch.no_grad():
        for name, m in dst.model.named_modules():
            if name not in smods:
                continue
            for leaf in ("weight", "bias"):
                if parametrize.is_parametrized(m, leaf):
                    p = m.parametrizations[leaf].original
                    dim = m.parametrizations[leaf][0].dim
                    cut = (lambda t, dim=dim: t.chunk(n, dim)[r])
                else:
                    p = m._parameters.get(leaf)
                    cut = (lambda t: t)
                if p is None:
                    continue
                sp = smods[name]._parameters[leaf]
                p.copy_(cut(sp))
                sm = sstate.get(sp, {}).get("momentum_buffer")
                if sm is not None:
                    dstate[p]["momentum_buffer"].copy_(cut(sm))


def dpe_params(trainer) -> list:
    """Every parameter of the trainer's model, whole (an FSDP model's
    gathered: every rank must call), in the weight carrier's order."""
    import torch

    from distributed_model_parallel_tpu_torch.models.staged import (
        _unit_slots,
        slot_leaves,
    )

    with torch.no_grad():
        return [t.detach().clone() for unit in trainer.model.units
                for t, _ in slot_leaves(_unit_slots(unit)[0])]


def dpe_timed(run, reducer_times, n: int) -> dict:
    """``run()`` n times after the gated steps, one sync at each end:
    samples/s per rank's card and the reduction's µs a step."""
    import torch

    reducer_times()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    us = sorted(reducer_times())
    return dict(steps=n, samples_per_s=DPE_BATCH * n / dt,
                reduction_us_median=statistics.median(us) if us else None)


def dp_engines_rank(spec, timed: bool) -> dict:
    """Phase 14b on one rank: ddp ring vs bucketed, ZeRO (fused, then
    momentum 0) vs gspmd's FusedSGD, fsdp vs gspmd, each DPE_STEPS steps
    from the same weights and batches (this rank's rows), cuDNN
    deterministic; the sparse BOW against dense SGD on the global batch.
    With ``timed``, DPE_TIMED_STEPS more steps of each engine, timed.
    Numbers come back as plain Python and numpy."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.data.loader import normalize
    from distributed_model_parallel_tpu_torch.models import embedding as bow
    from distributed_model_parallel_tpu_torch.ops import collectives
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.parallel import ddp, fsdp, zero
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    world = spec.num_data
    n_all = DPE_STEPS + (DPE_TIMED_STEPS if timed else 0)
    out = {"backend": spec.backend, "world": world}

    def replicated(tr):
        ddp.assert_ddp_replicated(tr.model, tr.optimizer, spec)

    # -- ddp: the ring against the bucketed all-reduce ------------------
    # Each step starts both from the bucketed run's state (parameters and
    # momentum copied into the ring's buckets), so a gap is the step's own.
    ref, ring = (trainer_mod.Trainer(dpe_config(
        tconfig, world, strategy="ddp", ddp_allreduce=allreduce,
        optimizer=dict(fused=True)), spec=spec)
        for allreduce in ("bucketed", "ring"))
    batches = dpe_batches(ref, n_all)
    losses, gaps = {"bucketed": [], "ring": []}, []
    for b in batches[:DPE_STEPS]:
        losses["bucketed"] += dpe_steps(ref, [b], replicated)
        losses["ring"] += dpe_steps(ring, [b], replicated)
        gaps.append(max(rel_gap(x, y) for x, y in zip(
            ring.model.parameters(), ref.model.parameters())))
        with torch.no_grad():
            for src, dst in ((ref.optimizer._p, ring.optimizer._p),
                             (ref.optimizer._m, ring.optimizer._m)):
                for x, y in zip(src, dst):
                    y.copy_(x)
    timed_runs = {}
    if timed:
        for name, tr in (("bucketed", ref), ("ring", ring)):
            it = iter(batches[DPE_STEPS:])
            timed_runs[name] = dpe_timed(
                lambda tr=tr, it=it: dpe_steps(tr, [next(it)]),
                tr.reducer.take_times_us, DPE_TIMED_STEPS)
    out["ring"] = dict(losses=losses, rel_gap=gaps, timed=timed_runs)
    del ref, ring
    torch.cuda.empty_cache()

    # -- ZeRO against gspmd's FusedSGD ----------------------------------
    # Each ZeRO step starts from the gspmd run's state before that step
    # (its parameters, and this rank's slice of its momentum).
    out["zero"] = {}
    for label, momentum in (("fused", 0.9), ("momentum0", 0.0)):
        ref = trainer_mod.Trainer(dpe_config(
            tconfig, world, optimizer=dict(fused=True, momentum=momentum)),
            spec=spec)
        batches = dpe_batches(ref, n_all)
        model = ref.model
        names = [n for n, _ in model.named_parameters()]
        mean = torch.as_tensor(ref.train_ds.mean, dtype=torch.float32,
                               device=spec.device)
        std = torch.as_tensor(ref.train_ds.std, dtype=torch.float32,
                              device=spec.device)

        def loss_fn(params, batch, model=model, mean=mean, std=std):
            images, labels = batch
            x = normalize(images, mean, std, torch.float32)
            logits = functional_call(model, params, (x,), {"train": True})
            return trainer_mod.cross_entropy(logits, labels)

        init_fn, step_fn = zero.make_zero_train_step(
            loss_fn, tconfig.OptimizerConfig(
                learning_rate=DPE_LR, momentum=momentum, weight_decay=1e-4,
                fused=True), spec, schedule=ref.optimizer.schedule)

        def ref_state(ref=ref, names=names):
            """The gspmd run's parameters (clones) and momentum."""
            params = {n: p.detach().clone()
                      for n, p in zip(names, ref.model.parameters())}
            moms = {n: ref.optimizer.momentum_buffer(i)
                    for i, n in enumerate(names)}
            return params, moms

        state = init_fn(ref_state()[0])
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        losses, ref_losses, gaps, launches = [], [], [], {}
        for k, b in enumerate(batches[:DPE_STEPS]):
            params, moms = ref_state()
            if state.momentum is not None:
                flat = collectives.flatten_padded(moms, world)
                size = flat.numel() // world
                state.momentum.copy_(flat[spec.rank * size:
                                          (spec.rank + 1) * size])
            state.count = k
            before = (fs.fused_sgd_kernel.launches,
                      fs.plain_sgd_kernel.launches)
            params, state, loss = step_fn(params, state, b)
            launches = {"fused_sgd": launches.get("fused_sgd", 0)
                        + fs.fused_sgd_kernel.launches - before[0],
                        "plain_sgd": launches.get("plain_sgd", 0)
                        + fs.plain_sgd_kernel.launches - before[1]}
            losses.append(float(loss))
            ref_losses += dpe_steps(ref, [b])
            gaps.append(max(rel_gap(params[n], w) for n, w in zip(
                names, ref.model.parameters())))
        fp = ddp._fingerprint([params[n] for n in names], spec.device)
        every = collectives.all_gather_concat(fp[None], spec.group)
        rec = dict(losses=losses, ref_losses=ref_losses, rel_gap=gaps,
                   launches=launches,
                   bitwise_across_ranks=bool((every == every[0]).all()),
                   momentum_bytes=(0 if state.momentum is None
                                   else state.momentum.numel() * 4),
                   gspmd_momentum_bytes=sum(
                       m.numel() * 4 for m in ref.optimizer._m
                       if m is not None))
        if timed:
            it = iter(batches[DPE_STEPS:])
            box = {"p": params, "s": state}

            def zstep(box=box, it=it):
                box["p"], box["s"], _ = step_fn(box["p"], box["s"],
                                                next(it))

            step_fn.take_times_us()
            rec["timed"] = dpe_timed(zstep, step_fn.take_times_us,
                                     DPE_TIMED_STEPS)
        out["zero"][label] = rec
        del ref, model, params, state
        torch.cuda.empty_cache()

    # -- fsdp against gspmd ---------------------------------------------
    # Each step starts both from the gspmd run's state (its parameters and
    # momentum cut into this rank's slices).
    ref, sharded = (trainer_mod.Trainer(dpe_config(
        tconfig, world, strategy=strategy), spec=spec)
        for strategy in ("gspmd", "fsdp"))
    batches = dpe_batches(ref, n_all)
    losses, ref_losses, close, gaps = [], [], [], []
    for b in batches[:DPE_STEPS]:
        ref_losses += dpe_steps(ref, [b])
        losses += dpe_steps(sharded, [b])
        got, want = dpe_params(sharded), dpe_params(ref)    # gathered
        close.append(all(torch.allclose(x, y, rtol=FSDP_RTOL, atol=FSDP_ATOL)
                         for x, y in zip(got, want)))
        gaps.append(max(rel_gap(x, y) for x, y in zip(got, want)))
        dpe_sync_fsdp(ref, sharded, spec)
    resident = {name: fsdp.resident_bytes(tr.model, tr.optimizer)
                for name, tr in (("gspmd", ref), ("fsdp", sharded))}
    timed_runs = {}
    if timed:
        for name, tr in (("gspmd", ref), ("fsdp", sharded)):
            it = iter(batches[DPE_STEPS:])
            timed_runs[name] = dpe_timed(
                lambda tr=tr, it=it: dpe_steps(tr, [next(it)]),
                tr.reducer.take_times_us, DPE_TIMED_STEPS)
    out["fsdp"] = dict(
        losses=losses, ref_losses=ref_losses,
        loss_rel=max(abs(x - y) / abs(y) for x, y in zip(losses,
                                                        ref_losses)),
        params_close=all(close), rel_gap=gaps, resident=resident["fsdp"],
        gspmd_resident=resident["gspmd"], timed=timed_runs)
    del ref, sharded
    torch.cuda.empty_cache()

    # -- the sparse BOW -------------------------------------------------
    cfg = bow.BowConfig()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        BOW_ROWS, BOW_TOKENS))).to(spec.device)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                           BOW_ROWS)).to(spec.device)
    rows = spec.rows(BOW_ROWS)
    params = bow.init_params(cfg, seed=0, device=spec.device)
    dense = {k: v.clone() for k, v in params.items()}
    step = bow.make_sparse_sgd_step(cfg, BOW_LR, group=spec.group)
    errs, losses = [], []
    t0 = time.perf_counter()
    for _ in range(BOW_STEPS):
        params, loss = step(params, tokens[rows], labels[rows])
        live = {k: v.detach().requires_grad_(True) for k, v in dense.items()}
        dloss = bow.loss_fn(live, tokens, labels)
        grads = torch.autograd.grad(dloss, [live[k] for k in bow.PARAM_NAMES])
        with torch.no_grad():
            dense = {k: live[k] - BOW_LR * g
                     for k, g in zip(bow.PARAM_NAMES, grads)}
        losses.append((float(loss), float(dloss.detach())))
        errs.append(max(float(((params[k] - dense[k]).abs()
                               - BOW_RTOL * dense[k].abs()).max())
                        for k in bow.PARAM_NAMES))
    torch.cuda.synchronize()
    fp = ddp._fingerprint([params[k] for k in bow.PARAM_NAMES], spec.device)
    every = collectives.all_gather_concat(fp[None], spec.group)
    out["bow"] = dict(losses=losses, excess=errs,
                      seconds=time.perf_counter() - t0,
                      bitwise_across_ranks=bool((every == every[0]).all()))
    return out


def dp_engines(mesh, card, world: int, backend: str, rides=()) -> dict:
    """Phase 14b (14c under ``--dp-only``): :func:`dp_engines_rank` on
    ``world`` ranks over ``backend``, carrying ``rides``; the parent
    prints and gates (the rides' gates are their callers')."""
    timed = backend == "nccl" and world > 1
    where = ("each rank on its own card" if backend == "nccl"
             else "both ranks on the one card")
    r = dp_spawn(mesh, dp_engines_rank, world, "14b/dp engines", timed,
                 backend=backend, rides=rides)
    a = r[0]
    tag = f"[{card}] {world} ranks over {backend} ({where})"
    ring = a["ring"]
    print(f"dp engines ring vs bucketed {tag}: {RN_MODEL} f32, B "
          f"{DPE_BATCH}, {DPE_STEPS} steps, fused SGD buckets, each step "
          f"from the bucketed run's state: losses ring "
          f"{ring['losses']['ring']} bucketed {ring['losses']['bucketed']}; "
          f"params per-leaf max rel gap per step {ring['rel_gap']} (gate "
          f"{DPE_RTOL}); replicas bitwise equal after every step")
    losses = [x for v in ring["losses"].values() for x in v] + [
        x for z in a["zero"].values() for x in z["losses"]] + a["fsdp"][
        "losses"] + [x for pair in a["bow"]["losses"] for x in pair]
    if not all(math.isfinite(x) for x in losses):
        fail("14b/dp engines", f"non-finite losses {losses}")
    if not max(ring["rel_gap"]) <= DPE_RTOL:
        fail("14b/dp engines", f"ring vs bucketed {ring['rel_gap']}")
    out = {"world": world, "backend": backend,
           "ring": dict(rel_gap=ring["rel_gap"])}
    for label, z in a["zero"].items():
        kernel = "plain_sgd" if label == "momentum0" else "fused_sgd"
        other = "fused_sgd" if kernel == "plain_sgd" else "plain_sgd"
        print(f"dp engines ZeRO ({label}) vs gspmd FusedSGD {tag}, each "
              f"step from gspmd's state: losses "
              f"{z['losses']} vs {z['ref_losses']}; params per-leaf max rel "
              f"gap per step {z['rel_gap']} (gate {DPE_RTOL}); {kernel} "
              f"launches {z['launches'][kernel]} on rank 0 (want one a step "
              f"a rank: {DPE_STEPS}); params bitwise equal across ranks "
              f"{z['bitwise_across_ranks']}; resident momentum "
              f"{[x['zero'][label]['momentum_bytes'] for x in r]} B a rank "
              f"vs gspmd's {z['gspmd_momentum_bytes']} B")
        bad = [x for x in r if x["zero"][label]["launches"] != {
            kernel: DPE_STEPS, other: 0}]
        if bad or not max(z["rel_gap"]) <= DPE_RTOL or not all(
                x["zero"][label]["bitwise_across_ranks"] for x in r):
            fail("14b/dp engines", f"ZeRO {label}: gaps {z['rel_gap']}, "
                 f"launches {[x['zero'][label]['launches'] for x in r]}")
        out[f"zero_{label}"] = dict(
            rel_gap=z["rel_gap"], launches=[x["zero"][label]["launches"]
                                            for x in r],
            momentum_bytes=z["momentum_bytes"],
            gspmd_momentum_bytes=z["gspmd_momentum_bytes"])
    f = a["fsdp"]
    print(f"dp engines fsdp vs gspmd {tag}, each step from gspmd's state: "
          f"losses {f['losses']} vs "
          f"{f['ref_losses']} (max rel {f['loss_rel']}, gate "
          f"{FSDP_LOSS_RTOL}); gathered params allclose(rtol {FSDP_RTOL}, "
          f"atol {FSDP_ATOL}) after every step {f['params_close']} (per-leaf "
          f"max rel gap per step {f['rel_gap']}); resident bytes a rank "
          f"{[x['fsdp']['resident'] for x in r]} vs gspmd's "
          f"{f['gspmd_resident']}")
    if not (f["loss_rel"] <= FSDP_LOSS_RTOL and all(
            x["fsdp"]["params_close"] for x in r)):
        fail("14b/dp engines", "fsdp vs gspmd outside tolerance")
    out["fsdp"] = dict(loss_rel=f["loss_rel"], rel_gap=f["rel_gap"],
                       resident=[x["fsdp"]["resident"] for x in r],
                       gspmd_resident=f["gspmd_resident"])
    b = a["bow"]
    print(f"dp engines sparse BOW {tag}: vocab 10000 x 64, {BOW_ROWS} rows "
          f"x {BOW_TOKENS} tokens, {BOW_STEPS} steps in {b['seconds']} s: "
          f"losses (sparse, dense) {b['losses']}; max(|sparse - dense| - "
          f"{BOW_RTOL}|dense|) per step {b['excess']} (gate {BOW_ATOL}); "
          f"tables bitwise equal across ranks {b['bitwise_across_ranks']}")
    if not (max(b["excess"]) <= BOW_ATOL and all(
            x["bow"]["bitwise_across_ranks"] for x in r)):
        fail("14b/dp engines", "sparse BOW outside tolerance or ranks "
                               "differ")
    out["bow"] = dict(excess=b["excess"], losses=b["losses"])
    if a["ring"]["timed"]:
        pairs = {"bucketed": a["ring"]["timed"]["bucketed"],
                 "ring": a["ring"]["timed"]["ring"],
                 "zero": a["zero"]["fused"].get("timed"),
                 "fsdp": a["fsdp"]["timed"]["fsdp"],
                 "gspmd": a["fsdp"]["timed"]["gspmd"]}
        for name, p in pairs.items():
            us = p["reduction_us_median"]
            print(f"dp engines BASELINE pair {name} {tag}: samples/s/card "
                  f"{p['samples_per_s'] / world} ({p['steps']} steps, "
                  f"{RN_MODEL} f32, B {DPE_BATCH}); grad reduction "
                  f"{'not measured' if us is None else f'{us} us'} a step "
                  f"(median, CUDA events)")
        out["timed"] = pairs
    return out


# -- phase 15: the reference's harness on the CNN trainer -----------------

def zoo_config(tconfig, model: str, root: str, **optimizer):
    """Phase 15a's TrainConfig: ``model`` at its CIFAR widths, bf16 over
    f32 parameters, bench.py's SGD recipe through FusedSGD, synthetic
    32 px data on the card, ZOO_BATCH rows, device-resident."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name=model, dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=ZOO_BATCH, eval_batch_size=ZOO_BATCH,
            image_size=32, synthetic_native_size=32,
            synthetic_train_size=4 * ZOO_BATCH, synthetic_eval_size=ZOO_BATCH),
        optimizer=tconfig.OptimizerConfig(
            **{**dict(learning_rate=0.4, warmup_steps=10, fused=True),
               **optimizer}),
        device_resident_data=True, steps_per_dispatch=ZOO_TIMED_STEPS,
        device="cuda", log_dir=os.path.join(root, "log"), log_name=model,
        checkpoint_dir=os.path.join(root, "ckpt", model))


def zoo_run(trainer_mod, fs, tconfig, name: str, root: str, card,
            momentum: float = 0.9, timed: bool = True) -> dict:
    """One zoo model through ``Trainer.run_steps``: ZOO_WARM_DISPATCHES
    one-step dispatches, then ZOO_TIMED_STEPS steps in
    one dispatch, one sync at the end. Gates: the JAX package's parameter
    count, the fused update launched on the card (no plain fallback),
    launches == steps x buckets, finite losses. ``timed``: cuDNN's
    autotuner on, as train_cnn runs, and the steps' time and peak memory
    reported; else the autotuner off, no warm-up, ZOO_UNTIMED_STEPS steps
    and no time reported."""
    import torch

    phase = "15a/zoo"
    t_model = time.perf_counter()
    torch.backends.cudnn.benchmark = timed
    # What earlier models and phases still hold, once cycles are freed (a
    # collection inside this model's run would otherwise lower the
    # allocation under the baseline).
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = trainer_mod.Trainer(zoo_config(tconfig, name, root,
                                       momentum=momentum))
    params = list(t.model.parameters())
    n = sum(p.numel() for p in params)
    buckets = len(t.optimizer.buckets)
    if n != ZOO_PARAMS[name]:
        fail(phase, f"{name}: {n} parameters, the JAX package's "
                    f"{ZOO_PARAMS[name]}")
    if getattr(t.optimizer, "_launchers", None) is None:
        fail(phase, f"{name}: FusedSGD runs the plain update on the card")
    warm = ZOO_WARM_DISPATCHES if timed else 0
    steps = ZOO_TIMED_STEPS if timed else ZOO_UNTIMED_STEPS
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 4 * ZOO_BATCH, (warm + steps, ZOO_BATCH),
                        generator=gen).cuda()
    for w in range(warm):
        t.run_steps(idx[w:w + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    t0 = time.perf_counter()
    m = t.run_steps(idx[warm:])
    losses = m["loss"].cpu().tolist()
    dt = time.perf_counter() - t0
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    kernel = "fused_sgd" if momentum else "plain_sgd"
    want = {"fused_sgd": 0, "plain_sgd": 0, kernel: steps * buckets}
    rec = dict(params=n, leaves=len(params), buckets=buckets, steps=steps,
               step_s=dt / steps if timed else None,
               samples_per_s=ZOO_BATCH * steps / dt if timed else None,
               peak_bytes=torch.cuda.max_memory_allocated() - base
               if timed else None,
               launches=launches, losses=losses)
    timing = (f"step {rec['step_s']} s, {rec['samples_per_s']} samples/s, "
              f"peak {rec['peak_bytes']} B over what was allocated before "
              f"its Trainer" if timed else
              "not timed (cuDNN's autotuner off)")
    print(f"zoo {name}{'' if momentum else ' (momentum 0)'} [{card}]: "
          f"{n} parameters, {len(params)} leaves, {buckets} bucket(s); "
          f"{timing}; launches {launches} (want {want}); "
          f"losses {losses[0]} .. {losses[-1]}; "
          f"{time.perf_counter() - t_model:.2f} s in all")
    if not all(math.isfinite(x) for x in losses):
        fail(phase, f"{name}: non-finite losses {losses}")
    if launches != want:
        fail(phase, f"{name}: launches {launches}, want {want}")
    del t, m
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def zoo_phase(trainer_mod, fs, models, staged, tconfig, root, card) -> dict:
    """Phase 15a: the 16 zoo models on the card (ZOO_TIMED timed with
    cuDNN's autotuner on, the rest untimed with it off), phase 11a's
    fused vs ``torch.optim.SGD`` check on EfficientNet-B0 (SE biases
    under BN) and DenseNet-121 (the most leaves), and one momentum-0
    EfficientNet-B0 run through ``plain_sgd`` (untimed)."""
    import torch

    rows = {name: zoo_run(trainer_mod, fs, tconfig, name, root, card,
                          timed=name in ZOO_TIMED)
            for name in ZOO_PARAMS}
    for name in ("efficientnetb0", "densenet121"):
        check_cnn_step(trainer_mod, models, staged, tconfig, model=name,
                       phase="15a/zoo")
    m0 = zoo_run(trainer_mod, fs, tconfig, "efficientnetb0", root, card,
                 momentum=0.0, timed=False)
    torch.backends.cudnn.benchmark = True
    return {"models": rows, "efficientnetb0_momentum0": m0}


def resume_config(tconfig, root: str, name: str,
                  rows: tuple = (RES_TRAIN, RES_EVAL), **kw):
    """Phase 15b/c: the reference's workload (MobileNetV2, bf16, fused
    SGD, augment on) on ``rows`` (train, eval) synthetic 32 px rows,
    batch RES_BATCH, 2 epochs; logs and checkpoints under ``root``."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=RES_BATCH, eval_batch_size=RES_BATCH,
            image_size=32, synthetic_native_size=32,
            synthetic_train_size=rows[0], synthetic_eval_size=rows[1]),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.4,
                                          warmup_steps=10, fused=True),
        epochs=2, log_every_n_steps=1000, device="cuda",
        log_dir=os.path.join(root, "log"), log_name=name,
        checkpoint_dir=os.path.join(root, f"ckpt_{name}"), **kw)


def resume_state(trainer) -> list:
    """A trainer's (or a pipeline trainer's, over every chunk) checkpoint
    tree's parameters, BN statistics and momentum (JAX layout, host
    copies), then its update count and global step."""
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    tree = trainer._ckpt_tree()
    return tree_flatten((tree["params"], tree["batch_stats"],
                         tree["momentum"]))[0] + [int(tree["opt_count"]),
                                                  trainer.global_step]


def resume_mismatches(a: list, b: list) -> int:
    import numpy as np

    return sum(not np.array_equal(x, y) for x, y in zip(a, b, strict=True))


def history_matches(a: list, b: list) -> bool:
    """Epoch 0's record (less the time keys) and epoch 1's eval equal: the
    interrupted epoch's train averages cover only the steps its trainer
    ran, as in the JAX trainer."""
    keys = ("epoch", "loss_train", "acc1_train", "loss_val", "acc1_val")
    return ([h["epoch"] for h in b] == [h["epoch"] for h in a] == [0, 1]
            and all(a[0][k] == b[0][k] for k in keys)
            and all(a[1][k] == b[1][k] for k in ("loss_val", "acc1_val")))


def resume_gate(trainer_mod, tconfig, root, label: str, card, **kw) -> dict:
    """Phase 15b, one input path: run A ``fit(2)``; run B ``fit(2)``
    preempted by a ``step_hook`` at the first step boundary at or after
    step RES_PREEMPT_STEP of epoch 1, then a new ``Trainer(resume=True)``
    finishing it. Gates: B == A bit for bit (parameters, momentum, BN
    statistics, update count, global step, history), the text log."""
    import torch

    phase = "15b/resume"
    a = trainer_mod.Trainer(resume_config(tconfig, root, f"{label}_a", **kw))
    ha = a.fit()
    steps = len(a.train_loader)
    target = steps + RES_PREEMPT_STEP

    def hook(t):
        if t.global_step >= target:
            t.preemption.request()

    cfg = resume_config(tconfig, root, f"{label}_b", **kw)
    b = trainer_mod.Trainer(cfg)
    b.step_hook = hook
    hb = b.fit()
    stopped_at = (b.global_step, b.train_loader.cursor)
    del b
    r = trainer_mod.Trainer(cfg.replace(resume=True))
    hb = hb + r.fit()
    torch.cuda.synchronize()
    bad = resume_mismatches(resume_state(a), resume_state(r))
    same_history = history_matches(ha, hb)
    lines = open(os.path.join(root, "log", f"{label}_b.txt")).read()
    epoch_lines = [x for x in lines.splitlines() if x.startswith("epoch:")]
    preempt_line = (f"preempted: checkpoint saved at epoch 1, global step "
                    f"{stopped_at[0]}") in lines
    print(f"resume {label} [{card}]: MobileNetV2 bf16, B {RES_BATCH}, "
          f"{steps} steps an epoch, preempted at global step "
          f"{stopped_at[0]} (loader cursor {stopped_at[1]}), resumed to "
          f"{r.global_step}; B vs A: {bad} of {len(resume_state(a))} "
          f"arrays differ (parameters, BN statistics, momentum, count, "
          f"step); history equal {same_history}; log: {len(epoch_lines)} "
          f"epoch lines, preemption line {preempt_line}")
    if bad or not same_history:
        fail(phase, f"{label}: the resumed run differs from the "
                    f"uninterrupted one ({bad} arrays, history "
                    f"{same_history})")
    if len(epoch_lines) != 2 or not preempt_line:
        fail(phase, f"{label}: log lines {lines!r}")
    return dict(preempted_at=stopped_at[0], cursor=stopped_at[1],
                steps=r.global_step, best_acc=r.best_acc, trainer=r,
                history_equal=same_history)


def resume_phase(trainer_mod, tconfig, root, card) -> dict:
    """Phase 15b: the resume gate per batch (steps_per_dispatch 1) and
    device-resident at 10 steps a dispatch (a mid-epoch cursor at a
    dispatch boundary), cuDNN deterministic; the best-accuracy slot, the
    torn-version fallback, save and restore times and bytes."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        PAYLOAD_FILENAME,
        fallback_note,
    )

    phase = "15b/resume"
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    per_batch = resume_gate(trainer_mod, tconfig, root, "per_batch", card)
    resident = resume_gate(trainer_mod, tconfig, root, "resident", card,
                           device_resident_data=True, steps_per_dispatch=10)
    r = per_batch.pop("trainer")
    resident.pop("trainer")
    tmpl = r._ckpt_tree()
    best = r.ckpt.restore(tmpl, "ckpt")
    if float(best["best_acc"]) != np.float32(r.best_acc):
        fail(phase, f"the ckpt slot's best_acc {float(best['best_acc'])} "
                    f"!= the run's {r.best_acc}")
    # Timing: the tree (device to host), the write, the read and load.
    saves, trees, restores = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = r._ckpt_tree()
        t1 = time.perf_counter()
        path = r.ckpt.save(tree, "bench")
        t2 = time.perf_counter()
        restored = r.ckpt.restore(tmpl, "bench")
        r._load_tree(restored)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trees.append((t1 - t0) * 1e3)
        saves.append((t2 - t1) * 1e3)
        restores.append((t3 - t2) * 1e3)
    nbytes = os.path.getsize(os.path.join(path, PAYLOAD_FILENAME))
    # The torn newest version: truncated, the one before is restored and
    # the fallback logged.
    older = r.ckpt.save(tmpl, "ckpt")
    newest = r.ckpt.save(tmpl, "ckpt")
    p = os.path.join(newest, PAYLOAD_FILENAME)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    r.ckpt.restore(tmpl, "ckpt", allow_fallback=True,
                   on_fallback=fallback_note(r._log_line))
    log = open(os.path.join(root, "log", "per_batch_b.txt")).read()
    fell_back = (r.ckpt.last_restored_path == older
                 and f"checkpoint fallback: {os.path.basename(newest)} "
                     f"rejected" in log)
    print(f"resume checkpoint [{card}]: {nbytes} B (MobileNetV2 params, "
          f"momentum, BN statistics); tree (device to host) "
          f"{statistics.median(trees)} ms, save {statistics.median(saves)} "
          f"ms, restore + load {statistics.median(restores)} ms (median of "
          f"3); ckpt slot best_acc {float(best['best_acc'])}; torn newest "
          f"{os.path.basename(newest)} -> restored "
          f"{os.path.basename(r.ckpt.last_restored_path)}, logged "
          f"{fell_back}")
    if not fell_back:
        fail(phase, "the torn newest version was not skipped and logged")
    torch.backends.cudnn.deterministic = False
    return dict(per_batch=per_batch, resident=resident, bytes=nbytes,
                tree_ms=trees, save_ms=saves, restore_ms=restores,
                best_acc=float(best["best_acc"]))


def resume_rank(spec, configs, train, evals, preempt_at,
                uninterrupted) -> dict:
    """Phase 15c on one of two ranks: ``workers.preempt_resume`` under
    cuDNN determinism (a spawned rank starts with cuDNN's defaults)."""
    import torch

    from distributed_model_parallel_tpu_torch.parallel import workers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    out = workers.preempt_resume(spec, configs, train, evals, preempt_at,
                                 uninterrupted)
    drop_trees(out)
    out["seconds"] = time.perf_counter() - t0
    return out


def drop_trees(runs: dict) -> None:
    """The whole checkpoint trees ``workers.preempt_resume`` returns per
    run, which no gate here reads: not sent back to the parent."""
    for per_config in runs.values():
        for run in per_config.values():
            run.pop("tree", None)


def resume_ranks(mesh, tconfig, root, card,
                 rides: list | None = None) -> dict:
    """Phase 15c: the preempt/resume gate at two ranks for ddp and zero
    (gloo on one card, NCCL on two or more): each rank's resumed run ==
    its uninterrupted one bit for bit, and the ranks agree. Beside them an
    uninterrupted gspmd run from the same inputs, which zero's must equal
    per leaf within DPE_RTOL (ZeRO is gspmd's SGD with the momentum
    sharded: a wrong slice, scatter order, mean, decay or rate shows
    there and not in a run compared with itself). In a spawn of its own,
    or, with ``rides``, carried by 14b's (the record is filled when the
    ride finishes)."""
    import torch

    from distributed_model_parallel_tpu_torch.data.registry import (
        load_dataset,
    )
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        tree_flatten,
    )

    phase = "15c/resume ranks"
    import numpy as np

    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    configs = {s: resume_config(tconfig, root, f"ranks_{s}", strategy=s,
                                mesh=tconfig.MeshConfig(data=2),
                                rows=(PPS_TRAIN, PPS_EVAL))
               for s in ("ddp", "zero", "gspmd")}
    train, evals = load_dataset(configs["ddp"].data)
    steps = PPS_TRAIN // RES_BATCH
    config = tconfig.MeshConfig(data=2)
    args = (configs, (train.images, train.labels),
            (evals.images, evals.labels), steps + PPS_PREEMPT_STEP,
            ("gspmd",))
    result: dict = {}

    def gate(r):
        out = {"backend": backend, "seconds": [x["seconds"] for x in r]}
        gaps = []
        for x in r:
            za, ga = x["zero"]["a"], x["gspmd"]["a"]
            for key in ("params", "momentum", "state"):
                gaps += [rel_gap(
                    torch.from_numpy(np.asarray(a, np.float32)),
                    torch.from_numpy(np.asarray(b, np.float32)))
                    for a, b in zip(tree_flatten(za[key])[0],
                                    tree_flatten(ga[key])[0], strict=True)]
        counts = [(x["zero"]["a"]["count"], x["gspmd"]["a"]["count"])
                  for x in r]
        print(f"resume zero vs gspmd, 2 ranks over {backend} [{card}]: "
              f"uninterrupted fit(2), max per-leaf max|a - b| / max|b| over "
              f"parameters, momentum and BN statistics {max(gaps)} (bound "
              f"{DPE_RTOL}; {sum(g == 0 for g in gaps)} of {len(gaps)} "
              f"leaves bitwise equal); update count, step {counts}")
        if not max(gaps) <= DPE_RTOL:
            fail(phase, f"zero differs from gspmd: {max(gaps)} > {DPE_RTOL}")
        out["zero_vs_gspmd_max_rel"] = max(gaps)
        for s in ("ddp", "zero"):
            leaves = [[tree_flatten((x[s][run]["params"],
                                     x[s][run]["momentum"],
                                     x[s][run]["state"]))[0] for run in "ab"]
                      for x in r]
            bad = [resume_mismatches(a, b) for a, b in leaves]
            across = resume_mismatches(leaves[0][1], leaves[1][1])
            counts = [(x[s]["b"]["count"], x[s]["b"]["step"]) for x in r]
            same_history = all(history_matches(x[s]["a"]["history"],
                                               x[s]["b"]["history"])
                               for x in r)
            print(f"resume {s}, 2 ranks over {backend} [{card}]: arrays "
                  f"differing resumed vs uninterrupted {bad} (of "
                  f"{len(leaves[0][0])}) per rank; rank 0's resumed arrays "
                  f"vs rank 1's: {across} differ; update count, step "
                  f"{counts} (want {2 * steps}); history equal {same_history}")
            if any(bad) or not same_history or any(
                    c != (2 * steps, 2 * steps) for c in counts):
                fail(phase, f"{s}: the resumed runs differ")
            params = [tree_flatten(x[s]["b"]["params"])[0] for x in r]
            if resume_mismatches(*params):
                fail(phase, f"{s}: the ranks' parameters differ")
            out[s] = dict(differing=bad, rank_params_equal=True,
                          steps=counts[0][1])
        result.update(out)
        return result

    if rides is not None:
        rides.append(RideAlong(resume_rank, config, args, gate))
        return result
    return gate(dp_spawn(mesh, resume_rank, 2, phase, *args,
                         backend=backend, config=config))


def harness_summary(harness: dict) -> dict:
    """Phase 15's numbers for the JSON line (no per-step losses)."""
    zoo = {name: {k: v for k, v in row.items() if k != "losses"}
           for name, row in harness["zoo"]["models"].items()}
    return {"zoo": zoo, "resume": harness["resume"],
            "resume_ranks": harness["resume_ranks"]}


def harness_phase(laps, trainer_mod, fs, models, staged, mesh, tconfig,
                  card, ranks: dict | None = None) -> dict:
    """Phase 15 (15a zoo, 15b resume, 15c resume at two ranks), its
    temporary logs and checkpoints removed after; ``ranks``: 15c's record
    when 15c rode an earlier spawn (:func:`resume_ranks` with rides)."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=HERE) as root:
        zoo = zoo_phase(trainer_mod, fs, models, staged, tconfig, root, card)
        laps.done("15a/zoo")
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        resume = resume_phase(trainer_mod, tconfig, root, card)
        resume["launches"] = {"fused_sgd": fs.fused_sgd_kernel.launches,
                              "plain_sgd": fs.plain_sgd_kernel.launches}
        laps.done("15b/resume")
        if ranks is None:
            ranks = resume_ranks(mesh, tconfig, root, card)
            laps.done("15c/resume ranks")
    return {"zoo": zoo, "resume": resume, "resume_ranks": ranks}


def ft_config(tconfig):
    """Phase 16a: the reference's finetune recipe (FT_*)."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16",
                                  extra={"input_layout": "imagenet"}),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=FT_BATCH, eval_batch_size=FT_BATCH,
            image_size=FT_PX, synthetic_native_size=32,
            synthetic_train_size=4 * FT_BATCH, synthetic_eval_size=FT_BATCH),
        optimizer=tconfig.OptimizerConfig(learning_rate=FT_LR, momentum=0.9,
                                          weight_decay=1e-4, warmup_steps=10,
                                          fused=True),
        device_resident_data=True, steps_per_dispatch=CNN_SPD,
        device="cuda", **run_dirs("finetune"))


def ft_kind(key: str) -> str:
    """cnn_kind, with the resize's kernels (F.interpolate) apart."""
    if "upsample" in key.lower() or "interpolate" in key.lower():
        return "resize (F.interpolate)"
    return cnn_kind(key)


def finetune(trainer_mod, fs, loader_mod, card) -> dict:
    """Phase 16a: the finetune recipe through ``Trainer.run_steps`` at
    bench.py's timing shape, every step resizing its 32 px rows to 224 px
    on the card: samples/s, step s, MFU (3 x FlopCounterMode's forward at
    224 px), peak memory; fused_sgd == steps x buckets, counted from 0
    over the timed steps; one profiled step with the resize's share of
    device time; the resize on the card against its CPU run on the same
    batch."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distributed_model_parallel_tpu_torch import config as tconfig

    phase = "16a/finetune"
    torch.backends.cudnn.benchmark = True
    n_disp = CNN_TIMED_STEPS // CNN_SPD
    idxs = cnn_dispatch_indices(4 * FT_BATCH, CNN_WARM_DISPATCHES + n_disp,
                                FT_BATCH)
    trainer = trainer_mod.Trainer(ft_config(tconfig))
    for ix in idxs[:CNN_WARM_DISPATCHES]:
        trainer.run_steps(ix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    t0 = time.perf_counter()
    ms = [trainer.run_steps(ix) for ix in idxs[CNN_WARM_DISPATCHES:]]
    losses = torch.cat([m["loss"] for m in ms]).cpu().tolist()
    dt = time.perf_counter() - t0
    launches = fs.fused_sgd_kernel.launches
    plain = fs.plain_sgd_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    steps = n_disp * CNN_SPD
    want = steps * len(trainer.optimizer.buckets)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        trainer.model.apply(torch.zeros(FT_BATCH, FT_PX, FT_PX, 3,
                                        dtype=trainer.dtype,
                                        device=trainer.device),
                            train=False)
    flops = 3 * counter.get_total_flops()
    step_s = dt / steps
    rec = dict(steps=steps, step_s=step_s,
               samples_per_s=FT_BATCH * steps / dt,
               mfu=flops / step_s / card_peak('flops'), flop_per_step=flops,
               peak_bytes=peak, fused_sgd=launches, plain_sgd=plain,
               want=want,
               losses=losses)
    print(f"finetune [{card}]: MobileNetV2 ImageNet layout, bf16, B "
          f"{FT_BATCH} of 32 px rows resized to {FT_PX} px on the card, "
          f"FusedSGD lr {FT_LR}, {steps} steps (after "
          f"{CNN_WARM_DISPATCHES} warm-up dispatches of {CNN_SPD}), one "
          f"sync: samples/s {rec['samples_per_s']}, step {step_s} s, MFU "
          f"({flops} flop per step / step s / {card_peak('flops'):.0f}) "
          f"{rec['mfu']}, torch.cuda.max_memory_allocated {peak} B; "
          f"fused_sgd launches {launches} (want steps x buckets = {want}), "
          f"plain_sgd {plain} (want 0); losses {losses[:3]} .. {losses[-3:]}")
    if (launches != want or plain
            or not all(math.isfinite(x) for x in losses)):
        fail(phase, f"fused_sgd launches {launches} != {want}, plain_sgd "
                    f"{plain} != 0 or non-finite losses")
    rows = print_profile("finetune step", lambda: f"loss "
                         f"{trainer.run_steps(idxs[-1][:1])['loss'].item()}",
                         card, kind=ft_kind)
    busy = sum(r[1] for r in rows)
    resize_us = sum(r[1] for r in rows if ft_kind(r[0]).startswith("resize"))
    rec["resize_us_profiled"] = resize_us if rows else None
    rec["device_busy_us_profiled"] = busy if rows else None
    # The resize alone by CUDA events (the profiler's kernel list has
    # missed it in one run of two): one step's batch, median of 30.
    x = trainer.dev_images[:FT_BATCH].view(FT_BATCH, 32, 32, 3)
    rec["resize_ms"] = time_ms(lambda: loader_mod.resize_batch(x, FT_PX))
    rec["resize_share_of_step"] = rec["resize_ms"] / (step_s * 1e3)
    print(f"finetune resize [{card}]: {rec['resize_ms']} ms a step by CUDA "
          f"events (median of 30), {rec['resize_share_of_step']} of the "
          f"step; the profiled step: {resize_us} us of {busy} us device "
          f"time")
    # The resize on the card against its CPU run, the same batch.
    gpu = loader_mod.resize_batch(x, FT_PX).cpu().numpy()
    cpu = loader_mod.resize_batch(x.cpu(), FT_PX).numpy()
    as_float = lambda t: torch.nn.functional.interpolate(
        t.permute(0, 3, 1, 2).float(), size=(FT_PX, FT_PX), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).cpu().numpy()
    fg, fc = as_float(x), as_float(x.cpu())
    err = float(np.abs(fg - fc).max())
    away = np.abs(np.abs(fc - np.floor(fc)) - 0.5) > FT_TIE
    differ = int((gpu != cpu)[away].sum())
    print(f"finetune resize card vs CPU [{card}]: float max_abs_err {err} "
          f"(atol {FT_RESIZE_ATOL}), uint8 differing away from .5 ties "
          f"{differ} of {int(away.sum())} ({int((gpu != cpu).sum())} in "
          f"all)")
    if err > FT_RESIZE_ATOL or differ:
        fail(phase, f"the resize on the card differs from the CPU's: "
                    f"{err}, {differ}")
    rec.update(resize_max_abs_err=err, resize_uint8_differing=differ)
    del trainer
    torch.cuda.empty_cache()
    return rec


def host_path(trainer_mod, tconfig, root, card) -> dict:
    """Phase 16b: one epoch of 15b's workload on the per-batch host path,
    four times in turn — both prefetch stages off, on (depth 2), on, off
    — cuDNN deterministic: every run's parameters, momentum, BN
    statistics and history bit for bit the first's; per run the trainer's
    data time a step (JAX's measure: from one batch's arrival to the
    next, the step's host enqueue in it) and the fetch a step (the time
    inside the input stream's ``next()``, median over the epoch)."""
    import dataclasses

    import torch

    phase = "16b/host path"
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    runs = []
    for k, depth in enumerate((0, 2, 2, 0)):
        cfg = resume_config(tconfig, root, f"host_{k}")
        cfg = cfg.replace(epochs=1, data=dataclasses.replace(
            cfg.data, prefetch=depth, device_prefetch=depth))
        t = trainer_mod.Trainer(cfg)
        fetch: list = []
        stream = t._input_stream

        def timed(loader, stream=stream, fetch=fetch):
            it, times = iter(stream(loader)), []
            fetch.append(times)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                times.append(time.perf_counter() - t0)
                yield batch

        t._input_stream = timed
        hist = t.fit()
        torch.cuda.synchronize()
        runs.append(dict(depth=depth, state=resume_state(t), history=hist,
                         data_s_per_step=hist[0]["time_load_per_batch"],
                         step_s=hist[0]["time_per_batch"],
                         fetch_s_per_step=statistics.median(fetch[0])))
        del t
    keys = ("loss_train", "acc1_train", "loss_val", "acc1_val")
    bad = [resume_mismatches(runs[0]["state"], r["state"]) for r in runs]
    same = all(r["history"][0][k] == runs[0]["history"][0][k]
               for r in runs for k in keys)
    n = len(runs[0]["state"])
    for r in runs:
        del r["state"], r["history"]
    print(f"host path [{card}]: MobileNetV2 bf16, B {RES_BATCH}, one epoch "
          f"per batch, runs prefetch/device_prefetch 0, 2, 2, 0: arrays "
          f"differing from the first run {bad} (of "
          f"{n}), history equal {same}; "
          f"fetch a step (s, median) "
          f"{[r['fetch_s_per_step'] for r in runs]}; the trainer's data "
          f"time a step {[r['data_s_per_step'] for r in runs]}, step "
          f"{[r['step_s'] for r in runs]}")
    if any(bad) or not same:
        fail(phase, "the prefetch stages changed the result")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = bench
    return {"runs": runs, "bitwise": True}


def native_gather(native, card) -> dict:
    """Phase 16c: the C++ row gather (built here by the host compiler)
    against numpy indexing at batch FT_GATHER_BATCH of FT_GATHER_ROWS
    CIFAR-shaped uint8 rows: every batch bit for bit; µs a batch of each
    (median of FT_GATHER_REPS) at 1, 2 (DataConfig's num_workers) and 4
    threads."""
    import numpy as np

    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (FT_GATHER_ROWS, 32, 32, 3), np.uint8)
    idx = rng.integers(0, FT_GATHER_ROWS, (FT_GATHER_REPS, FT_GATHER_BATCH))
    t0 = time.perf_counter()
    try:
        native.load()
    except RuntimeError as e:
        fail("16c/native gather", str(e))
    build_s = time.perf_counter() - t0
    times = {1: [], 2: [], 4: [], "numpy": []}
    differ = 0
    for ix in idx:
        t0 = time.perf_counter()
        want = src[ix]
        times["numpy"].append((time.perf_counter() - t0) * 1e6)
        for n in (1, 2, 4):
            t0 = time.perf_counter()
            got = native.gather_rows(src, ix, n_threads=n)
            times[n].append((time.perf_counter() - t0) * 1e6)
            differ += int(not np.array_equal(got, want))
    us = {str(k): statistics.median(v) for k, v in times.items()}
    print(f"native gather [{card} host]: batch {FT_GATHER_BATCH} of "
          f"{FT_GATHER_ROWS} rows of 32x32x3 uint8, {FT_GATHER_REPS} "
          f"batches: us a batch (median) native at 1/2/4 threads "
          f"{us['1']} / {us['2']} / {us['4']}, numpy {us['numpy']}; "
          f"{differ} batches differ; build/load {build_s} s")
    if differ:
        fail("16c/native gather", f"{differ} batches differ from numpy's")
    return {"us": us, "differing": differ, "build_s": build_s}


def data_path_phase(laps, trainer_mod, fs, tconfig, card) -> dict:
    """Phase 16: the finetune recipe on the card, the host path's
    prefetch stages, the native gather."""
    import tempfile

    from distributed_model_parallel_tpu_torch.data import loader, native

    out = {"finetune": finetune(trainer_mod, fs, loader, card)}
    laps.done("16a/finetune")
    with tempfile.TemporaryDirectory(dir=HERE) as root:
        out["host"] = host_path(trainer_mod, tconfig, root, card)
    laps.done("16b/host path")
    out["gather"] = native_gather(native, card)
    laps.done("16c/native gather")
    return out


# -- phase 17: the rest of the data-parallel CNN trainer ------------------

def opt_state_bytes(opt) -> int:
    """Bytes of an optimizer's state tensors (its leaf_state; SGD's
    momentum buffers)."""
    seen = [t for ts in opt.leaf_state().values() for t in ts
            if t is not None]
    seen += [m for m in getattr(opt, "_m", []) if m is not None]
    return sum(t.numel() * t.element_size() for t in seen)


def cuda_kernels_in(run) -> int:
    """CUDA kernel launches of ``run()`` by ``torch.profiler`` (0 when
    the profiler records no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0)


def optimizers_full_width(trainer_mod, adaptive, tconfig, fs,
                          card) -> dict:
    """Phase 17a: the CNN cell (MobileNetV2 CIFAR, bf16 over f32, B 512,
    synthetic 32 px on the card, device-resident) under each of adam,
    adamw, lamb, lars and adafactor. Gates: the first OPT_GATE_UPDATES
    updates on the card against the same chain on the CPU fed the same
    gradients and parameters (each update and every state tensor per leaf
    within OPT_CPU_RTOL relative); finite losses over OPT_STEPS more
    steps. Records step s, samples/s, peak memory, optimizer-state bytes,
    the optimizer's host ms a step and its kernel launches a step."""
    import torch

    phase = "17a/optimizers"
    idxs = cnn_dispatch_indices(4 * CNN_BATCH, 1 + OPT_STEPS // CNN_SPD)
    out = {"launches": {"fused_sgd": 0, "plain_sgd": 0}}
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    for name, lr in OPT_LR.items():
        t = trainer_mod.Trainer(cnn_config(
            tconfig, name=name, learning_rate=lr, warmup_steps=0,
            fused=False))
        opt = t.optimizer
        cpu_tx = adaptive.make_transform(
            t.config.optimizer, [p.detach().cpu() for p in opt.params],
            opt.layouts)
        card_update = opt.tx.update
        gaps = []

        def gated(grads, params, lr, count, card_update=card_update,
                  cpu_tx=cpu_tx, opt=opt, gaps=gaps):
            g_cpu = [g.detach().cpu() for g in grads]
            p_cpu = [p.detach().cpu() for p in params]
            u = card_update(grads, params, lr, count)
            u_cpu = cpu_tx.update(g_cpu, p_cpu, lr, count)
            worst = max(rel_gap(a.cpu(), b) for a, b in zip(u, u_cpu))
            for state, ts in opt.tx.state.items():
                worst = max([worst] + [
                    rel_gap(a.cpu(), b)
                    for a, b in zip(ts, cpu_tx.state[state])
                    if a is not None])
            gaps.append(worst)
            return u

        opt.tx.update = gated
        m = t.run_steps(idxs[0][:OPT_GATE_UPDATES])
        gate_losses = m["loss"].cpu().tolist()
        opt.tx.update = card_update
        print(f"optimizer {name} card vs CPU [{card}]: MobileNetV2 "
              f"{len(opt.params)} leaves, {OPT_GATE_UPDATES} updates, per "
              f"update max over leaves of max|card - cpu| / max|cpu| "
              f"(updates and {sorted(opt.tx.state)}) {gaps} (gate "
              f"{OPT_CPU_RTOL})")
        if len(gaps) != OPT_GATE_UPDATES or not max(gaps) <= OPT_CPU_RTOL:
            fail(phase, f"{name}: card vs CPU {gaps}")
        # The timed steps: the optimizer's host time per step (its
        # enqueue, no sync) around each step() call.
        host = []
        step = opt.step

        def timed_step(step=step, host=host):
            t0 = time.perf_counter()
            step()
            host.append(time.perf_counter() - t0)

        opt.step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = cnn_run(t, idxs[1:], f"trainer ({name})", card)
        peak = torch.cuda.max_memory_allocated()
        opt.step = step
        out["launches"] = {"fused_sgd": fs.fused_sgd_kernel.launches,
                           "plain_sgd": fs.plain_sgd_kernel.launches}
        losses = gate_losses + rec["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(phase, f"{name}: non-finite losses {losses}")
        launches = cuda_kernels_in(opt.step)
        row = dict(step_s=rec["step_s"],
                   samples_per_s=rec["samples_per_s"], peak_bytes=peak,
                   state_bytes=opt_state_bytes(opt),
                   host_ms=statistics.median(host) * 1e3,
                   kernel_launches=launches, cpu_gap=max(gaps),
                   losses=[losses[0], losses[-1]])
        print(f"optimizer {name} [{card}]: lr {lr}, {OPT_STEPS} steps: step "
              f"{row['step_s']} s, samples/s {row['samples_per_s']}, "
              f"torch.cuda.max_memory_allocated {peak} B, optimizer state "
              f"{row['state_bytes']} B, optimizer.step host "
              f"{row['host_ms']} ms a step (median, no sync), {launches} "
              f"CUDA kernels a step (torch.profiler); loss "
              f"{losses[0]} -> {losses[-1]}")
        out[name] = row
        del t, opt, cpu_tx
        torch.cuda.empty_cache()
    return out


def accum_pairs(trainer_mod, staged, tconfig, fs, card) -> dict:
    """Phase 17b: ``accum_steps=ACC_K`` at B ACC_MICRO against one step at
    B ACC_K x ACC_MICRO a boundary (mobilenetv2_nobn, f32, augment off,
    cuDNN deterministic, FusedSGD), ACC_UPDATES updates on the same rows,
    each from the big-batch run's state: every leaf within ACC_RTOL
    relative after each update; fused_sgd (momentum 0.9) and plain_sgd
    (momentum 0) launches == updates x buckets; the fused update's µs in
    a profiled step."""
    import dataclasses

    import numpy as np
    import torch

    phase = "17b/accumulation"
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    big = ACC_K * ACC_MICRO
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 4 * CNN_BATCH, (
        ACC_UPDATES, big)).astype(np.int64)).cuda()
    params = None
    out = {}
    for momentum, kernel in ((0.9, "fused_sgd"), (0.0, "plain_sgd")):
        def cfg(batch, accum, momentum=momentum):
            c = cnn_config(tconfig, "mobilenetv2_nobn", learning_rate=ACC_LR,
                           warmup_steps=0, momentum=momentum,
                           accum_steps=accum)
            return c.replace(
                model=tconfig.ModelConfig(name="mobilenetv2_nobn",
                                          dtype="float32"),
                data=dataclasses.replace(c.data, batch_size=batch,
                                         eval_batch_size=batch,
                                         augment=False),
                **run_dirs(f"accum_{batch}_{momentum}"))

        a = trainer_mod.Trainer(cfg(big, 1))
        if params is None:
            params, state = staged.params_to_jax(a.model)
        else:
            a = trainer_mod.Trainer(cfg(big, 1), params=params, state=state)
        b = trainer_mod.Trainer(cfg(ACC_MICRO, ACC_K), params=params,
                                state=state)
        gaps = []
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        for u in range(ACC_UPDATES):
            a.run_steps(idx[u:u + 1])
            b.run_steps(idx[u].reshape(ACC_K, ACC_MICRO))
            gaps.append(max(rel_gap(x, y) for x, y in zip(
                b.model.parameters(), a.model.parameters())))
            # The next update starts both from a's state, so each gap is
            # one update's own.
            with torch.no_grad():
                for src, dst in ((a.optimizer._p, b.optimizer._p),
                                 (a.optimizer._m, b.optimizer._m)):
                    for x, y in zip(src, dst):
                        if x is not None:
                            y.copy_(x)
        torch.cuda.synchronize()
        buckets = len(b.optimizer.buckets)
        got = {"fused_sgd": fs.fused_sgd_kernel.launches,
               "plain_sgd": fs.plain_sgd_kernel.launches}
        want = {"fused_sgd": 0, "plain_sgd": 0}
        want[kernel] = 2 * ACC_UPDATES * buckets     # a's and b's updates
        print(f"accumulation (momentum {momentum}) [{card}]: "
              f"mobilenetv2_nobn f32, accum_steps {ACC_K} at B {ACC_MICRO} "
              f"vs B {big}, {ACC_UPDATES} updates: per-leaf max rel gap per "
              f"update {gaps} (gate {ACC_RTOL}); launches {got} over both "
              f"runs (want {want}: updates x buckets each, {buckets} "
              f"bucket(s); {ACC_K * ACC_UPDATES} micro-steps); "
              f"updates {b.optimizer.count}")
        if not max(gaps) <= ACC_RTOL or got != want or \
                b.optimizer.count != ACC_UPDATES:
            fail(phase, f"momentum {momentum}: gaps {gaps}, launches {got}")
        rec = dict(rel_gap=gaps, launches=got[kernel] // 2,
                   buckets=buckets)
        if kernel == "fused_sgd":
            micro = idx[0].reshape(ACC_K, ACC_MICRO)
            rows = print_profile(
                f"accumulation boundary ({ACC_K} micro-steps)",
                lambda: f"loss {b.run_steps(micro)['loss'][-1].item()}",
                card, kind=cnn_kind)
            rec["update_us"] = sgd_in_step_us(rows, "fused_sgd", card)
        out[kernel] = rec
        del a, b
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def ema_and_resume(trainer_mod, tconfig, root, card) -> dict:
    """Phase 17c: the average against a host recurrence in float64
    (EMA_STEPS steps of the CNN cell with ema_decay EMA_DECAY, every
    parameter and BN statistic within EMA_RTOL relative); then a fit with
    adamw, accum_steps 2 and ema_decay 0.99 on 15b's workload, preempted
    mid-accumulation and resumed, against the uninterrupted fit: every
    array of the checkpoint bit for bit; save and restore ms and bytes."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        PAYLOAD_FILENAME,
        flatten_tree,
    )

    phase = "17c/ema"
    t = trainer_mod.Trainer(cnn_config(tconfig, ema_decay=EMA_DECAY))
    idx = cnn_dispatch_indices(4 * CNN_BATCH, 1)[0]
    host = [x.detach().double().cpu() for x in t.ema.live]
    for k in range(EMA_STEPS):
        t.run_steps(idx[k:k + 1])
        host = [(1 - EMA_DECAY) * x.detach().double().cpu() + EMA_DECAY * h
                for x, h in zip(t.ema.live, host)]
    gap = max(rel_gap(a.double().cpu(), h) for a, h in zip(t.ema.avg, host))
    print(f"ema [{card}]: MobileNetV2 bf16 B {CNN_BATCH}, decay {EMA_DECAY}, "
          f"{EMA_STEPS} steps: {len(host)} averaged tensors (parameters and "
          f"BN statistics) vs the host recurrence in float64, max per-tensor "
          f"max|a - b| / max|b| {gap} (gate {EMA_RTOL})")
    if not gap <= EMA_RTOL:
        fail(phase, f"ema vs host recurrence {gap}")
    del t
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    opt = tconfig.OptimizerConfig(**RESUME_OPT)

    def config(name):
        return resume_config(tconfig, root, name).replace(optimizer=opt)

    a = trainer_mod.Trainer(config("acc_a"))
    a.fit()
    steps = len(a.train_loader)
    target = steps + RES_PREEMPT_STEP            # odd: mid-accumulation
    cfg = config("acc_b")
    b = trainer_mod.Trainer(cfg)
    b.step_hook = (lambda tr: tr.preemption.request()
                   if tr.global_step >= target else None)
    b.fit()
    mini = b.optimizer.accum.mini_step
    stopped = b.global_step
    del b
    r = trainer_mod.Trainer(cfg.replace(resume=True))
    r.fit()
    torch.cuda.synchronize()
    ta, tr = flatten_tree(a._ckpt_tree()), flatten_tree(r._ckpt_tree())
    bad = [k for k in ta if not np.array_equal(ta[k], tr[k])]
    print(f"resume adamw + accum 2 + ema 0.99 [{card}]: MobileNetV2 bf16, B "
          f"{RES_BATCH}, preempted at global step {stopped} (mini_step "
          f"{mini}: mid-accumulation), resumed to {r.global_step}: "
          f"{len(bad)} of {len(ta)} checkpoint arrays differ from the "
          f"uninterrupted fit (parameters, BN statistics, mu, nu, the "
          f"accumulated mean, counters, averages)")
    if bad or mini == 0 or set(ta) != set(tr):
        fail(phase, f"resumed run differs in {bad[:8]} (mini_step {mini})")
    tmpl = r._ckpt_tree()
    trees, saves, restores = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = r._ckpt_tree()
        t1 = time.perf_counter()
        path = r.ckpt.save(tree, "bench")
        t2 = time.perf_counter()
        r._load_tree(r.ckpt.restore(tmpl, "bench"))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trees.append((t1 - t0) * 1e3)
        saves.append((t2 - t1) * 1e3)
        restores.append((t3 - t2) * 1e3)
    nbytes = os.path.getsize(os.path.join(path, PAYLOAD_FILENAME))
    print(f"resume checkpoint adamw + accum + ema [{card}]: {nbytes} B; tree "
          f"{statistics.median(trees)} ms, save {statistics.median(saves)} "
          f"ms, restore + load {statistics.median(restores)} ms (median of "
          f"3)")
    torch.backends.cudnn.deterministic = False
    return dict(ema_gap=gap, differing=len(bad), arrays=len(ta),
                preempted_at=stopped, bytes=nbytes, tree_ms=trees,
                save_ms=saves, restore_ms=restores)


def bf16_leaves(optim, tconfig, models, fs, card) -> dict:
    """Phase 17d: FusedSGD over MobileNetV2's leaves in bf16 on the card
    (staged into f32 buckets, the kernel writing the delta) against the
    plain version on the same card, OPT_GATE_UPDATES updates: leaves,
    momentum and delta bit for bit; fused_sgd == updates x buckets."""
    import torch

    phase = "17d/bf16 leaves"
    base = [p.detach().to(torch.bfloat16) for p in models.get_model(
        tconfig.ModelConfig(), device="cuda").parameters()]
    leaves = [torch.nn.Parameter(x.clone()) for x in base]
    cfg = tconfig.OptimizerConfig(learning_rate=0.1, momentum=0.9,
                                  weight_decay=1e-4, fused=True)
    opt = optim.FusedSGD(leaves, cfg, lambda n: 0.1)
    ref = [x.clone() for x in base]
    moms = [torch.zeros_like(m) for m in opt._m]
    dev = base[0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    fs.fused_sgd_kernel.launches = 0
    bad = 0
    for _ in range(OPT_GATE_UPDATES):
        grads = [torch.randn(x.shape, device=dev, generator=gen)
                 .to(torch.bfloat16) for x in base]
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        for b, bucket in enumerate(opt.buckets):
            p32 = torch.cat([ref[i].float().reshape(-1) for i in bucket])
            g32 = torch.cat([grads[i].float().reshape(-1) for i in bucket])
            delta = fs.sgd_delta_plain(p32, moms[b], g32, 0.1, 0.9, 1e-4,
                                       False)
            off = 0
            for i in bucket:
                n = ref[i].numel()
                ref[i].add_(delta[off:off + n].view(ref[i].shape)
                            .to(torch.bfloat16))
                off += n
            bad += int(not torch.equal(delta, opt.last_deltas[b]))
            bad += int(not torch.equal(moms[b], opt._m[b]))
        bad += sum(not torch.equal(p.detach(), x) for p, x in zip(leaves,
                                                                 ref))
    torch.cuda.synchronize()
    launches = fs.fused_sgd_kernel.launches
    want = OPT_GATE_UPDATES * len(opt.buckets)
    print(f"bf16 leaves [{card}]: FusedSGD over {len(leaves)} bf16 leaves "
          f"({len(opt.buckets)} bucket(s)), {OPT_GATE_UPDATES} updates vs "
          f"the plain version: {bad} of leaves, momentum and delta differ "
          f"(bit for bit); fused_sgd launches {launches} (want {want})")
    if bad or launches != want:
        fail(phase, f"{bad} arrays differ, launches {launches} != {want}")
    return dict(differing=bad, launches=launches, buckets=len(opt.buckets))


def optim_ranks_rank(spec, part: str, timed: bool) -> dict:
    """Phase 17e on one rank. ``part="fsdp"``: ResNet-50 f32 at DPE_BATCH
    under fsdp, one step measured for the whole weights it holds (the
    live gathered tensors' count and bytes, and ``memory_allocated``
    after the forward beside gspmd's), then fsdp vs gspmd over DPE_STEPS
    steps from gspmd's state. ``part="hierarchical"``: MobileNetV2 f32 at
    HIER_BATCH on a data=4, dcn_data=2 mesh, ddp ``"hierarchical"`` vs
    ``"bucketed"`` with FusedSGD, each step from the bucketed run's
    state, replicas bitwise. With ``timed``, DPE_TIMED_STEPS more steps
    of each: samples/s and the reduction's µs a step."""
    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.data.loader import normalize
    from distributed_model_parallel_tpu_torch.models.staged import (
        model_leaves,
    )
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.parallel import ddp, fsdp
    from distributed_model_parallel_tpu_torch.train import (
        trainer as trainer_mod,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    world = spec.num_data
    n_all = DPE_STEPS + (DPE_TIMED_STEPS if timed else 0)
    out = {"backend": spec.backend, "world": world}
    if part == "fsdp":
        ref, sharded = (trainer_mod.Trainer(dpe_config(
            tconfig, world, strategy=strategy), spec=spec)
            for strategy in ("gspmd", "fsdp"))
        batches = dpe_batches(ref, n_all)
        leaves = [leaf for leaf in model_leaves(sharded.model)
                  if leaf.shard_dim is not None]
        unit_bytes, unit_count = {}, {}
        for leaf in leaves:
            n = 4
            for s in leaf.full_shape(world):
                n *= s
            unit_bytes[leaf.unit] = unit_bytes.get(leaf.unit, 0) + n
            unit_count[leaf.unit] = unit_count.get(leaf.unit, 0) + 1
        mean = torch.as_tensor(ref.train_ds.mean, device=spec.device)
        std = torch.as_tensor(ref.train_ds.std, device=spec.device)
        held = {}
        for name, tr in (("gspmd", ref), ("fsdp", sharded)):
            # One step's forward and backward by hand, its update dropped.
            im, lb = batches[0]
            x = normalize(im, mean, std, torch.float32)
            tr.optimizer.zero_grad()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            ledger = sharded.model.gather_ledger
            ledger.stats(reset=True)
            logits, _ = tr.model.apply(x, train=True)
            torch.cuda.synchronize()
            held[name] = torch.cuda.memory_allocated() - before
            fwd = ledger.stats(reset=True)
            trainer_mod.cross_entropy(logits, lb).backward()
            torch.cuda.synchronize()
            if name == "fsdp":
                bwd = ledger.stats()
            tr.reducer.finish()
            tr.optimizer.zero_grad()
            del logits
        out["gathered"] = dict(
            fwd_peak=fwd["peak"], fwd_peak_bytes=fwd["peak_bytes"],
            bwd_peak=bwd["peak"], bwd_peak_bytes=bwd["peak_bytes"],
            live_after_forward=fwd["now"], live_after=bwd["now"],
            held_fsdp=held["fsdp"], held_gspmd=held["gspmd"],
            max_unit_bytes=max(unit_bytes.values()),
            max_unit_count=max(unit_count.values()),
            all_units_bytes=sum(unit_bytes.values()),
            slice_bytes=fsdp.resident_bytes(sharded.model)["params"])
        sharded.reducer.take_times_us()
        losses, ref_losses, close, gaps = [], [], [], []
        for b in batches[:DPE_STEPS]:
            ref_losses += dpe_steps(ref, [b])
            losses += dpe_steps(sharded, [b])
            got, want = dpe_params(sharded), dpe_params(ref)
            close.append(all(torch.allclose(x, y, rtol=FSDP_RTOL,
                                            atol=FSDP_ATOL)
                             for x, y in zip(got, want)))
            gaps.append(max(rel_gap(x, y) for x, y in zip(got, want)))
            dpe_sync_fsdp(ref, sharded, spec)
        out["fsdp"] = dict(
            losses=losses, ref_losses=ref_losses,
            loss_rel=max(abs(x - y) / abs(y)
                         for x, y in zip(losses, ref_losses)),
            params_close=all(close), rel_gap=gaps)
        if timed:
            it = iter(batches[DPE_STEPS:])
            sharded.reducer.take_times_us()
            out["fsdp"]["timed"] = dpe_timed(
                lambda: dpe_steps(sharded, [next(it)]),
                sharded.reducer.take_times_us, DPE_TIMED_STEPS)
        return out
    # -- hierarchical vs bucketed --------------------------------------
    def config(allreduce):
        return hier_config(tconfig, world, allreduce)

    ref, hier = (trainer_mod.Trainer(config(a), spec=spec)
                 for a in ("bucketed", "hierarchical"))
    batches = dpe_batches(ref, n_all)
    fs.fused_sgd_kernel.launches = 0
    fs.plain_sgd_kernel.launches = 0
    losses, gaps = {"bucketed": [], "hierarchical": []}, []
    for b in batches[:DPE_STEPS]:
        losses["bucketed"] += dpe_steps(ref, [b])
        losses["hierarchical"] += dpe_steps(hier, [b])
        ddp.assert_ddp_replicated(hier.model, hier.optimizer, spec)
        gaps.append(max(rel_gap(x, y) for x, y in zip(
            hier.model.parameters(), ref.model.parameters())))
        with torch.no_grad():
            for src, dst in ((ref.optimizer._p, hier.optimizer._p),
                             (ref.optimizer._m, hier.optimizer._m)):
                for x, y in zip(src, dst):
                    y.copy_(x)
    torch.cuda.synchronize()
    out["hierarchical"] = dict(
        losses=losses, rel_gap=gaps, buckets=len(hier.optimizer.buckets),
        launches={"fused_sgd": fs.fused_sgd_kernel.launches,
                  "plain_sgd": fs.plain_sgd_kernel.launches},
        groups=[torch.distributed.get_process_group_ranks(g)
                for g in spec.hierarchy])
    if timed:
        out["hierarchical"]["timed"] = {}
        for name, tr in (("bucketed", ref), ("hierarchical", hier)):
            it = iter(batches[DPE_STEPS:])
            out["hierarchical"]["timed"][name] = dpe_timed(
                lambda tr=tr, it=it: dpe_steps(tr, [next(it)]),
                tr.reducer.take_times_us, DPE_TIMED_STEPS)
    return out


def hier_config(tconfig, world: int, allreduce: str):
    """Phase 17e's ddp config: MobileNetV2 f32 at HIER_BATCH over a
    ``data=world, dcn_data=2`` mesh, augment off, FusedSGD lr 0.1."""
    return tconfig.TrainConfig(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="float32"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=HIER_BATCH,
            eval_batch_size=HIER_BATCH, image_size=32,
            synthetic_native_size=32, augment=False,
            synthetic_train_size=(DPE_STEPS + DPE_TIMED_STEPS) * HIER_BATCH,
            synthetic_eval_size=HIER_BATCH),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                                          fused=True),
        mesh=tconfig.MeshConfig(data=world, dcn_data=2), strategy="ddp",
        ddp_allreduce=allreduce, device="cuda",
        **run_dirs(f"hier_{allreduce}"))


def optim_ranks(mesh, tconfig, card, world: int, backend: str,
                rides: list | None = None, fsdp: list | None = None) -> dict:
    """Phase 17e: :func:`optim_ranks_rank`'s fsdp part at 2 ranks (at
    ``world`` ranks, timed, over NCCL) and its hierarchical part at 4
    ranks over ``backend``, each in a spawn of its own, or: ``fsdp``, the
    fsdp part's rank results from an earlier carrier (14b's), and with
    ``rides`` the hierarchical part carried by 19b's spawn
    (``"hierarchical"`` is filled when the ride finishes); the parent
    prints and gates."""
    phase = "17e/ranks"
    timed = backend == "nccl"
    n_fsdp = world if timed else 2
    where = ("each rank on its own card" if backend == "nccl"
             else "the ranks sharing the one card")
    f = fsdp or dp_spawn(mesh, optim_ranks_rank, n_fsdp, phase, "fsdp",
                         timed, backend=backend)
    g = f[0]["gathered"]
    slices = g["slice_bytes"]
    print(f"fsdp whole weights [{card}] {n_fsdp} ranks over {backend} "
          f"({where}): {RN_MODEL} f32, B {DPE_BATCH}, one step: live "
          f"gathered weights at most {g['fwd_peak']} in the forward and "
          f"{g['bwd_peak']} in the backward (the largest unit has "
          f"{g['max_unit_count']}), {g['fwd_peak_bytes']} / "
          f"{g['bwd_peak_bytes']} B (largest unit's whole weights "
          f"{g['max_unit_bytes']} B, all units' {g['all_units_bytes']} B, "
          f"this rank's slices {slices} B); alive after the forward "
          f"{g['live_after_forward']}, after the step {g['live_after']}; "
          f"memory_allocated held after the forward: fsdp {g['held_fsdp']} "
          f"B vs gspmd {g['held_gspmd']} B (difference "
          f"{g['held_fsdp'] - g['held_gspmd']} B)")
    bound = g["max_unit_bytes"] + slices
    if not (max(g["fwd_peak_bytes"], g["bwd_peak_bytes"]) <= bound
            and g["held_fsdp"] - g["held_gspmd"] <= bound
            and g["live_after_forward"] == 0 and g["live_after"] == 0
            and g["bwd_peak"] > 0):
        fail(phase, f"fsdp holds more than one unit's whole weights: {g}")
    fr = f[0]["fsdp"]
    print(f"fsdp vs gspmd [{card}] {n_fsdp} ranks over {backend}, each step "
          f"from gspmd's state: losses {fr['losses']} vs "
          f"{fr['ref_losses']} (max rel {fr['loss_rel']}, gate "
          f"{FSDP_LOSS_RTOL}); gathered params allclose(rtol {FSDP_RTOL}, "
          f"atol {FSDP_ATOL}) {fr['params_close']} (per-leaf max rel gap "
          f"per step {fr['rel_gap']})")
    if not (fr["loss_rel"] <= FSDP_LOSS_RTOL
            and all(x["fsdp"]["params_close"] for x in f)):
        fail(phase, "fsdp vs gspmd outside tolerance")
    out = {"fsdp": dict(gathered=g, loss_rel=fr["loss_rel"],
                        rel_gap=fr["rel_gap"], ranks=n_fsdp)}
    if timed:
        tm = fr["timed"]
        print(f"fsdp timed [{card}] {n_fsdp} ranks over {backend}: "
              f"samples/s/card {tm['samples_per_s'] / n_fsdp}, reduction "
              f"{tm['reduction_us_median']} us a step (median; the "
              f"backward's reduce-scatters and the replicated leaves' "
              f"all-reduce, each timed by CUDA events and added)")
        out["fsdp"]["timed"] = tm
    config = tconfig.MeshConfig(data=4, dcn_data=2)
    if rides is not None:
        rides.append(RideAlong(optim_ranks_rank, config,
                               ("hierarchical", timed),
                               lambda h: hierarchical_gate(out, h, card,
                                                           backend, timed)))
        return out
    return hierarchical_gate(out, dp_spawn(mesh, optim_ranks_rank, 4, phase,
                                           "hierarchical", timed,
                                           backend=backend, config=config),
                             card, backend, timed)


def hierarchical_gate(out: dict, h: list, card, backend: str,
                      timed: bool) -> dict:
    """Phase 17e's hierarchical gates on the 4 ranks' results ``h``;
    fills ``out``."""
    phase = "17e/ranks"
    hr = h[0]["hierarchical"]
    want = DPE_STEPS * hr["buckets"]
    print(f"ddp hierarchical vs bucketed [{card}] 4 ranks over {backend} "
          f"(data=4, dcn_data=2; groups {hr['groups']}): MobileNetV2 f32, "
          f"B {HIER_BATCH}, {DPE_STEPS} steps, FusedSGD, each step from the "
          f"bucketed run's state: losses {hr['losses']}; per-leaf max rel "
          f"gap per step {hr['rel_gap']} (gate {HIER_RTOL}); replicas "
          f"bitwise equal after every step; fused_sgd launches on rank 0 "
          f"{hr['launches']} over both runs (want {2 * want})")
    if not max(hr["rel_gap"]) <= HIER_RTOL or \
            hr["launches"]["fused_sgd"] != 2 * want:
        fail(phase, f"hierarchical vs bucketed: {hr['rel_gap']}, "
                    f"launches {hr['launches']}")
    out["hierarchical"] = dict(rel_gap=hr["rel_gap"],
                               launches=hr["launches"]["fused_sgd"] // 2,
                               groups=hr["groups"])
    if timed:
        for name, p in hr["timed"].items():
            print(f"ddp {name} timed [{card}] 4 ranks over {backend}: "
                  f"samples/s/card {p['samples_per_s'] / 4}, grad reduction "
                  f"{p['reduction_us_median']} us a step (median, CUDA "
                  f"events)")
        out["hierarchical"]["timed"] = hr["timed"]
    return out


def optim_phase(laps, trainer_mod, fs, models, staged, mesh, tconfig,
                card, rides: list | None = None,
                fsdp: list | None = None) -> dict:
    """Phase 17: 17a-17e (the rest of the data-parallel CNN trainer; 17e's
    fsdp part's rank results ``fsdp`` from 14b's spawn, its hierarchical
    part carried by 19b's with ``rides``)."""
    import tempfile

    import torch

    from distributed_model_parallel_tpu_torch.train import adaptive, optim

    torch.backends.cudnn.benchmark = True
    out = {"optimizers": optimizers_full_width(trainer_mod, adaptive,
                                               tconfig, fs, card)}
    laps.done("17a/optimizers")
    out["accumulation"] = accum_pairs(trainer_mod, staged, tconfig, fs, card)
    laps.done("17b/accumulation")
    root = tempfile.mkdtemp(prefix="optim_", dir=os.environ[RUN_DIR_ENV])
    out["ema_resume"] = ema_and_resume(trainer_mod, tconfig, root, card)
    laps.done("17c/ema + resume")
    out["bf16_leaves"] = bf16_leaves(optim, tconfig, models, fs, card)
    laps.done("17d/bf16 leaves")
    two = torch.cuda.device_count() >= 4
    out["ranks"] = optim_ranks(mesh, tconfig, card,
                               torch.cuda.device_count(),
                               "nccl" if two else "gloo", rides, fsdp)
    laps.done("17e/ranks")
    return out


def optim_summary(opt: dict) -> dict:
    """Phase 17's numbers for the JSON line (no per-step losses)."""
    rows = {k: ({x: y for x, y in v.items() if x != "losses"}
                if k != "launches" else v)
            for k, v in opt["optimizers"].items()}
    return {**opt, "optimizers": rows}


# -- phase 18: the LM over a (data, model, seq) mesh -------------------------

def lm18_config(name: str, mesh: dict | None = None, *, steps: int = 1,
                **model_kw):
    """An LMTrainConfig of phase 8's workload (the bench.py LM model at
    full width, bf16, B 2, T 8192, the default SGD) over ``mesh``, with
    the model's ``model_kw`` (depth, remat, the chunked head, the axes)."""
    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                **{**LM_MODEL, **model_kw})
    return lm.LMTrainConfig(
        model=cfg, mesh=tconfig.MeshConfig(**(mesh or {})),
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps_per_epoch=steps,
        epochs=1, n_tokens=4 * TRAIN_BATCH * (TRAIN_SEQ + 1), eval_batches=0,
        device="cuda", **run_dirs(name))


def lm18_steps(trainer, n: int) -> tuple[list, list]:
    """``n`` steps of ``trainer`` on its batches (0, 0) .. (0, n - 1):
    losses and step seconds (host clock, each step ending in a sync)."""
    import torch

    losses, times = [], []
    for s in range(n):
        toks, tgts = trainer.sample_batch(0, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(toks, tgts))
        times.append(time.perf_counter() - t0)
    return losses, times


def lm_single_card(fa, lm_model_flops, card, ref_loss) -> dict:
    """Phase 18a: phase 8's workload on one card with remat off, "dots"
    and "full", and the chunked head (1024 tokens a slice) with and
    without "dots", LM18_STEPS steps each from phase 8's weights. Gates:
    each step-0 loss within LM18_LOSS_ATOL of ``ref_loss`` (phase 8b's;
    remat off's when phase 8 did not run), every step's loss within
    LM18_LOSS_ATOL of remat off's, finite losses, the flash kernels
    launched, and peak memory ordered off > dots > full, the chunked head
    below the dense one."""
    import torch

    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    wrappers = flash_wrappers(fa)
    out = {}
    for name, kw in LM18_VARIANTS.items():
        config = lm18_config(f"lm18a_{name}", steps=LM18_STEPS + 1, **kw)
        trainer = lm.LMTrainer(config, params=tfm.init_params(
            config.model, seed=0, device="cuda"))
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = lm18_steps(trainer, LM18_STEPS)
        peak = torch.cuda.max_memory_allocated()
        launches = {n: w.launches for n, w in wrappers.items()}
        step_s = statistics.median(times[1:])
        flops = lm_model_flops(config.model, TRAIN_BATCH, TRAIN_SEQ)
        out[name] = dict(losses=losses, step_s=step_s, times=times,
                         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                         mfu=flops / step_s / card_peak('flops'),
                         peak_bytes=peak, launches=launches)
        print(f"lm 18a {name} [{card}]: step s {step_s} (median of steps "
              f"1-{LM18_STEPS - 1}; {times}), tokens/s "
              f"{out[name]['tokens_per_s']}, MFU {out[name]['mfu']}, peak "
              f"max_memory_allocated {peak} B, flash launches {launches}, "
              f"losses {losses}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    ref = ref_loss if ref_loss is not None else out["remat_off"]["losses"][0]
    off = out["remat_off"]["losses"]
    bad = []
    for name, r in out.items():
        err = abs(r["losses"][0] - ref)
        r["loss0_err"] = err
        r["loss_err_vs_off"] = [abs(a - b) for a, b in zip(r["losses"], off)]
        if not err <= LM18_LOSS_ATOL:
            bad.append(f"{name}: step-0 loss {r['losses'][0]} vs {ref} "
                       f"(|diff| {err} > {LM18_LOSS_ATOL})")
        if not max(r["loss_err_vs_off"]) <= LM18_LOSS_ATOL:
            bad.append(f"{name}: losses {r['losses']} vs remat off's {off} "
                       f"(|diff| {r['loss_err_vs_off']} > {LM18_LOSS_ATOL})")
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"{name}: losses {r['losses']}")
        if min(r["launches"].values()) < LM_MODEL["n_layers"] * LM18_STEPS:
            bad.append(f"{name}: flash launches {r['launches']}")
    peak = {n: r["peak_bytes"] for n, r in out.items()}
    order = (peak["remat_off"] > peak["remat_dots"] > peak["remat_full"]
             and peak["chunk1024"] < peak["remat_off"]
             and peak["chunk1024_dots"] < peak["remat_dots"])
    print(f"lm 18a: step-0 loss vs {ref}: "
          + ", ".join(f"{n} {r['loss0_err']:.3e}" for n, r in out.items())
          + "; every step vs remat off: "
          + ", ".join(f"{n} {max(r['loss_err_vs_off']):.3e}"
                      for n, r in out.items())
          + f" (atol {LM18_LOSS_ATOL}); peak memory off > dots > full and "
            f"the chunked head below the dense: {order}")
    if not order:
        bad.append(f"peak memory not ordered: {peak}")
    if bad:
        fail("18a/lm one card", "; ".join(bad))
    return out


def lm18_pipeline_vs_plain(card) -> dict:
    """Phase 18a: phase 8's workload on one card (remat off, seed 0's
    weights, batch (0, 0)), the gradient of the loss through the model's
    plain ``lm_loss`` and through ``LMPipeline`` at one stage, one
    microbatch and gpipe — the path every LM step of ``spmd_lm`` takes —
    alternated LM18_AB_REPS times after a warm-up of each: the forward
    and backward's seconds (host clock, each ending in a sync), the
    losses (gated within LM18_LOSS_ATOL) and the gradients' largest
    relative gap, max|a - b| / max|b| over the leaves."""
    import torch

    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    config = lm18_config("lm18a_pipeline_vs_plain")
    trainer = lm.LMTrainer(config, params=tfm.init_params(
        config.model, seed=0, device="cuda"))
    params, cfg, spec = trainer.params, trainer.cfg, trainer.spec
    toks, tgts = (torch.from_numpy(a).to(spec.device, torch.long)
                  for a in trainer.sample_batch(0, 0))
    pipe = spmd_pipeline.LMPipeline(cfg, spec)

    def plain():
        loss = tfm.lm_loss(params, toks, tgts, cfg, spec)
        loss.backward()
        return loss.detach().float()

    def piped():
        nll, _ = pipe.run(params, toks, tgts)
        return nll / toks.numel()

    times = {"plain": [], "pipeline": []}
    losses, grads = {}, {}
    for rep in range(LM18_AB_REPS + 1):
        order = (("plain", plain), ("pipeline", piped))
        for name, fn in order if rep % 2 else order[::-1]:
            for p in trainer.leaves:
                p.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn()
            torch.cuda.synchronize()
            if rep:
                times[name].append(time.perf_counter() - t0)
            losses[name] = loss.item()
            grads[name] = [p.grad.float() for p in trainer.leaves]
    gap = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(grads["pipeline"], grads["plain"]))
    med = {k: statistics.median(v) for k, v in times.items()}
    out = dict(times=times, median_s=med,
               ratio=med["pipeline"] / med["plain"], losses=losses,
               loss_err=abs(losses["pipeline"] - losses["plain"]),
               grad_max_rel=gap)
    print(f"lm 18a pipeline vs plain [{card}]: B {TRAIN_BATCH}, T "
          f"{TRAIN_SEQ}, forward + backward s, median of {LM18_AB_REPS} "
          f"alternated: plain {med['plain']}, LMPipeline(S 1, M 1, gpipe) "
          f"{med['pipeline']} (ratio {out['ratio']}; {times}); losses "
          f"{losses} (|diff| {out['loss_err']}, atol {LM18_LOSS_ATOL}); "
          f"gradients max rel gap {gap}")
    del trainer, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    if not out["loss_err"] <= LM18_LOSS_ATOL:
        fail("18a/lm one card", f"pipeline vs plain loss {losses}")
    return out


def _digests(tree: dict) -> dict:
    """sha256 of each leaf's bytes (a tree of tensors), by path."""
    import hashlib

    import torch

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _digests(v).items()})
        else:
            raw = v.detach().contiguous().view(-1).view(torch.uint8)
            out[k] = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()
    return out


def lm18_ring_check(spec, fa, seed: int = 7) -> dict:
    """Ring attention over the seq group on the card against the flash
    kernels over the whole sequence, at the shard shapes of phase 18b's
    ring mesh (B 2, T 8192, the model rank's 4 heads, Dh 128, bf16): o per
    row within O_ROW_RTOL, dq/dk/dv within GRAD_RTOL of the whole run's
    (max|a-b|/max|b|), on this rank's shard."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import ring_attention as ra

    dev = spec.device
    heads = LM_MODEL["n_heads"] // spec.num_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, heads,
                               LM_MODEL["d_model"] // LM_MODEL["n_heads"],
                               generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    t = TRAIN_SEQ // spec.num_seq
    rows = slice(spec.seq_index * t, (spec.seq_index + 1) * t)
    ql, kl, vl = (x[:, rows].contiguous().requires_grad_(True)
                  for x in (q, k, v))
    o = ra.ring_attention(ql, kl, vl, spec.seq_group, causal=True,
                          impl="auto")
    o.backward(do[:, rows].contiguous())
    qw, kw, vw = (x.clone().requires_grad_(True) for x in (q, k, v))
    ow = fa.flash_attention(qw, kw, vw, causal=True)
    ow.backward(do)
    torch.cuda.synchronize(dev)
    err = {"o_row": row_rel_err(o, ow[:, rows])}
    for n, a, b in (("dq", ql, qw), ("dk", kl, kw), ("dv", vl, vw)):
        err[n] = rel_err(a.grad, b.grad[:, rows])
    return err


def lm_mesh_rank(spec, meshes: dict, resume: bool) -> dict:
    """Phases 18b and 18c on one rank. For each mesh of ``meshes`` (the
    group laid out anew): on the ring mesh, :func:`lm18_ring_check`; a
    trainer from phase 8's weights; LM18_STEPS steps with the flash
    launches and the collectives counted from 0 and any plain attention
    counted (it must not run), each step followed by a digest of every
    slice this rank holds; one step more with the collectives timed.
    Then (``resume``) phase 18c's gate on the ring mesh."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh as mesh_mod
    from distributed_model_parallel_tpu_torch.config import MeshConfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.ops import collectives as C
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.ops import ring_attention as ra
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops,
    )

    plain = {"calls": 0}

    def counted(fn):
        def run(*a, **kw):
            plain["calls"] += 1
            return fn(*a, **kw)
        return run

    for mod, name in ((fa, "flash_forward_plain"), (fa, "flash_bwd_dq_plain"),
                      (fa, "flash_bwd_dkv_plain"), (fa, "full_attention"),
                      (ra, "ring_xla")):
        setattr(mod, name, counted(getattr(mod, name)))
    wrappers = flash_wrappers(fa)
    out = {}
    laps = RankLaps(spec, "18b-c")
    for name, (mesh, kw) in meshes.items():
        spec_m = mesh_mod.make_mesh(MeshConfig(**mesh), spec.device)
        row = {"grid": spec_m.grid}
        if kw.get("sp_axis") and kw.get("sp_impl", "ring") == "ring":
            row["ring_check"] = lm18_ring_check(spec_m, fa)
        config = lm18_config(f"lm18b_{name}", mesh, steps=LM18_STEPS + 1,
                             **kw)
        trainer = lm.LMTrainer(config, params=tfm.init_params(
            config.model, seed=0, device=spec.device), spec=spec_m)
        for w in wrappers.values():
            w.launches = 0
        plain["calls"] = 0
        C.reset_counts()
        torch.cuda.synchronize(spec.device)
        torch.cuda.reset_peak_memory_stats(spec.device)
        losses, times, digests = [], [], []
        for s in range(LM18_STEPS):
            toks, tgts = trainer.sample_batch(0, s)
            torch.cuda.synchronize(spec.device)
            t0 = time.perf_counter()
            losses.append(trainer.train_step(toks, tgts))
            times.append(time.perf_counter() - t0)
            digests.append(_digests(trainer.params))
        row["launches"] = {n: w.launches for n, w in wrappers.items()}
        row["plain_calls"] = plain["calls"]
        row["calls"] = {k: v / LM18_STEPS for k, v in C.calls.items()}
        row["bytes"] = {k: v / LM18_STEPS for k, v in C.wire_bytes.items()}
        row["peak_bytes"] = torch.cuda.max_memory_allocated(spec.device)
        C.reset_counts()
        with C.timed() as secs:
            toks, tgts = trainer.sample_batch(0, LM18_STEPS)
            trainer.train_step(toks, tgts)
        row["us"] = {k: v * 1e6 for k, v in secs.items()}
        laps.done(f"18b {name}")
        step_s = statistics.median(times[1:])
        world = spec_m.config.num_devices
        row.update(losses=losses, times=times, step_s=step_s,
                   digests=digests,
                   tokens_per_s_card=TRAIN_BATCH * TRAIN_SEQ / step_s / world,
                   mfu_card=lm_model_flops(config.model, TRAIN_BATCH,
                                           TRAIN_SEQ) / world / step_s
                   / card_peak('flops'))
        out[name] = row
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    if resume:
        out["resume"] = lm18_resume(spec)
        laps.done("18c")
    return out


def lm18_resume(spec) -> dict:
    """Phase 18c on one rank: the ring mesh at LM18_RESUME_LAYERS layers
    under ``remat="dots"``: ``fit`` against ``fit`` preempted by a
    ``step_hook`` at LM18_PREEMPT_AT and finished by
    ``LMTrainer(resume=True)`` — per-step losses, the whole parameters and
    optimizer state, the global step and the history compared bit for bit
    in this process — the checkpoint's bytes, save and restore ms (rank
    0, the writer), and a resume of the same checkpoint on another split
    (a resharded restore: the same whole parameters and optimizer state,
    bit for bit, at the same global step)."""
    import dataclasses

    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch import mesh as mesh_mod
    from distributed_model_parallel_tpu_torch.config import MeshConfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.train import checkpoint as ck
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    mesh, kw = LM18_MESHES["model2_seq2_ring"]
    spec_m = mesh_mod.make_mesh(MeshConfig(**mesh), spec.device)
    model = dict(kw, n_layers=LM18_RESUME_LAYERS, remat=True,
                 remat_policy="dots")
    configs = {n: lm18_config(f"lm18c_{n}", mesh, steps=LM18_RESUME_STEPS,
                              **model) for n in ("full", "cut")}
    timings = {"save_ms": [], "restore_ms": []}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            timings[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return run

    ck.Checkpointer.save = timed(ck.Checkpointer.save, "save_ms")
    # A resume reads through restore_resharded (the elastic slot ladder).
    ck.Checkpointer.restore_resharded = timed(
        ck.Checkpointer.restore_resharded, "restore_ms")

    def state(tr, history, steps):
        to_np = lambda t: t.detach().float().cpu().numpy()
        whole = tr.whole_params()
        params = {k: (to_np(v) if not isinstance(v, dict) else
                      {kk: to_np(vv) for kk, vv in v.items()})
                  for k, v in whole.items()}
        return dict(history=[{k: h[k] for k in ("epoch", "loss_val")}
                             for h in history], steps=steps,
                    params=ck.flatten_tree(params),
                    opt_state=ck.flatten_tree(tr.opt_state_tree()),
                    global_step=tr.global_step)

    init = lambda cfg: tfm.init_params(cfg.model, seed=0, device=spec.device)
    full = lm.LMTrainer(configs["full"], params=init(configs["full"]),
                        spec=spec_m)
    a = state(full, full.fit(), [r["loss"] for r in full.step_log])
    del full
    cut = lm.LMTrainer(configs["cut"], params=init(configs["cut"]),
                       spec=spec_m)
    cut.step_hook = lambda t: (t.preemption.request()
                               if (t._pos_epoch, t._pos_step)
                               == LM18_PREEMPT_AT else None)
    first = cut.fit()
    steps = [r["loss"] for r in cut.step_log]
    preempted = cut.global_step
    del cut
    resumed = lm.LMTrainer(dataclasses.replace(configs["cut"], resume=True),
                           spec=spec_m)
    b = state(resumed, first + resumed.fit(),
              steps + [r["loss"] for r in resumed.step_log])
    differing = sum(not np.array_equal(a[key][k], b[key][k])
                    for key in ("params", "opt_state") for k in a[key])
    arrays = sum(len(a[key]) for key in ("params", "opt_state"))
    same = (differing == 0 and a["steps"] == b["steps"]
            and a["global_step"] == b["global_step"]
            and a["history"] == b["history"]
            and set(a["params"]) == set(b["params"]))
    path = resumed.ckpt._latest_path("lm-preempt")
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    del resumed
    other_mesh, other_kw = LM18_MESHES["data2_model2"]
    other = mesh_mod.make_mesh(MeshConfig(**other_mesh), spec.device)
    moved = lm.LMTrainer(dataclasses.replace(
        configs["cut"], resume=True, mesh=MeshConfig(**other_mesh),
        model=dataclasses.replace(configs["cut"].model, sp_axis=None)),
        spec=other)
    o = state(moved, [], [])
    other_split = dict(
        global_step=o["global_step"],
        differing=sum(not np.array_equal(b[key][k], o[key][k])
                      for key in ("params", "opt_state") for k in b[key]))
    del moved
    gc.collect()
    torch.cuda.empty_cache()
    return dict(same=same, differing=differing, arrays=arrays,
                steps=a["steps"], preempted_at_step=preempted,
                global_step=b["global_step"], bytes=nbytes, **timings,
                other_split=other_split)


def lm_mesh(mesh_mod, card, ref_losses: list, world: int, backend: str,
            resume: bool, ranks: list | None = None) -> dict:
    """Phase 18b (and 18c with ``resume``): :func:`lm_mesh_rank` on
    ``world`` ranks (gloo sharing one card, or NCCL with a card each), or
    its results ``ranks`` from a spawn that ran it beside other work.
    Gates, per mesh: every step's loss within LM18_LOSS_ATOL of
    ``ref_losses`` (the one-card trainer's, same weights, batches and
    learning rates), losses equal on
    every rank, after every step each replicated leaf bitwise equal on
    every rank and each slice bitwise equal across its data and seq
    replicas, each rank's flash launches what its hops imply (ring: rank
    i of the seq group runs i + 1 hops a layer; otherwise one) and no
    plain attention; the ring check within phase 6's bounds; 18c bit for
    bit and its checkpoint resumed on another split bit for bit."""
    res = ranks or dp_spawn(mesh_mod, lm_mesh_rank, world, "18b/lm mesh",
                            LM18_MESHES, resume, backend=backend)
    bad = []
    layers, steps = LM_MODEL["n_layers"], LM18_STEPS
    summary = {}
    for name, (mesh, kw) in LM18_MESHES.items():
        rows = [r[name] for r in res]
        r0 = rows[0]
        errs = [abs(a - b) for a, b in zip(r0["losses"], ref_losses)]
        if len(errs) != steps or not max(errs) <= LM18_LOSS_ATOL:
            bad.append(f"{name}: losses {r0['losses']} vs one card "
                       f"{ref_losses} (|diff| {errs} > {LM18_LOSS_ATOL})")
        if any(r["losses"] != r0["losses"] for r in rows):
            bad.append(f"{name}: ranks disagree on the losses")
        mismatched = 0
        for s in range(steps):
            by_model: dict = {}
            for r in rows:
                by_model.setdefault(r["grid"][2], []).append(r["digests"][s])
            for group in by_model.values():
                mismatched += sum(g != group[0] for g in group[1:])
            firsts = [g[0] for g in by_model.values()]
            repl = [k for k in firsts[0]
                    if not k.startswith("blocks.") or k in (
                        "blocks.ln1_scale", "blocks.ln1_bias",
                        "blocks.ln2_scale", "blocks.ln2_bias", "blocks.b2")]
            mismatched += sum(f[k] != firsts[0][k] for f in firsts[1:]
                              for k in repl)
        if mismatched:
            bad.append(f"{name}: {mismatched} leaf digests differ between "
                       f"replicas")
        ring = kw.get("sp_axis") and kw.get("sp_impl", "ring") == "ring"
        for r in rows:
            hops = r["grid"][3] + 1 if ring else 1
            want = layers * steps * hops
            if any(v != want for v in r["launches"].values()):
                bad.append(f"{name} rank {r['grid']}: flash launches "
                           f"{r['launches']}, want {want} each")
            if r["plain_calls"]:
                bad.append(f"{name} rank {r['grid']}: {r['plain_calls']} "
                           f"plain attention calls on the card")
            if "ring_check" in r:
                c = r["ring_check"]
                if not c["o_row"] <= O_ROW_RTOL or not all(
                        c[n] <= GRAD_RTOL for n in ("dq", "dk", "dv")):
                    bad.append(f"{name} rank {r['grid']}: ring vs flash "
                               f"{c}")
        peak = max(r["peak_bytes"] for r in rows)
        us = {k: v for k, v in r0["us"].items()}
        summary[name] = dict(
            losses=r0["losses"], step_s=r0["step_s"], times=r0["times"],
            tokens_per_s_card=r0["tokens_per_s_card"],
            mfu_card=r0["mfu_card"], peak_bytes_rank=peak,
            launches={str(r["grid"]): r["launches"] for r in rows},
            calls_per_step=r0["calls"], bytes_per_step=r0["bytes"],
            us_timed_step=us, loss_err=errs,
            ring_check={str(r["grid"]): r["ring_check"] for r in rows
                        if "ring_check" in r}, digests_mismatched=mismatched)
        print(f"lm 18b {name} [{card}] world {world} over {backend}: step s "
              f"{r0['step_s']} ({r0['times']}), tokens/s a card "
              f"{r0['tokens_per_s_card']}, MFU a card {r0['mfu_card']}, peak "
              f"max_memory_allocated a rank {peak} B; losses "
              f"{r0['losses']} vs one card {ref_losses} (|diff| {errs}); "
              f"rank 0 a step: collectives {r0['calls']}, bytes "
              f"{r0['bytes']}; timed step us {us}; flash launches "
              + ", ".join(f"{r['grid']} {r['launches']}" for r in rows)
              + f"; ring check {summary[name]['ring_check']}; replica "
                f"digests differing {mismatched}")
    if resume:
        rs = [r["resume"] for r in res]
        r0 = rs[0]
        ok = all(r["same"] for r in rs)
        moved = all(r["other_split"]["differing"] == 0
                    and r["other_split"]["global_step"] == r["global_step"]
                    for r in rs)
        print(f"lm 18c [{card}]: preempted at step {r0['preempted_at_step']}"
              f" and resumed == uninterrupted bit for bit on every rank: "
              f"{ok} ({[r['differing'] for r in rs]} of {r0['arrays']} "
              f"arrays differing; steps {r0['steps']}); checkpoint "
              f"{r0['bytes']} B, save ms {r0['save_ms']}, restore ms "
              f"{r0['restore_ms']}; resumed on (data 2, model 2) from the "
              f"ring mesh's checkpoint, bit for bit: {moved} "
              f"({r0['other_split']!r})")
        if not ok:
            bad.append(f"18c: resumed run differs: "
                       f"{[r['differing'] for r in rs]}")
        if not moved:
            bad.append(f"18c: resume on another split differs: "
                       f"{[r['other_split'] for r in rs]}")
        summary["resume"] = {k: v for k, v in r0.items()}
    if bad:
        fail("18b/lm mesh", "; ".join(bad))
    return summary


def lm_phase(laps, fa, lm_model_flops, mesh_mod, card, ref_loss,
             rides: list | None = None) -> dict:
    """Phase 18: 18a on one card, then 18b and 18c over 4 ranks (gloo on
    the one card; with four cards, NCCL with a card each) — in a spawn of
    their own, or, with ``rides``, carried by 19b's spawn (``"mesh"`` is
    filled when the ride finishes)."""
    import torch

    single = lm_single_card(fa, lm_model_flops, card, ref_loss)
    pipe = lm18_pipeline_vs_plain(card)
    laps.done("18a/lm one card")
    four = torch.cuda.device_count() >= 4
    backend = "nccl" if four else "gloo"
    meshes: dict = {}

    def gate(ranks):
        meshes.update(lm_mesh(mesh_mod, card, single["remat_off"]["losses"],
                              4, backend, True, ranks=ranks))
        return meshes

    if rides is not None:
        rides.append(RideAlong(lm_mesh_rank, None, (LM18_MESHES, True),
                               gate))
    else:
        gate(None)
        laps.done("18b-c/lm mesh")
    return {"single": single, "pipeline_vs_plain": pipe, "mesh": meshes,
            "backend": backend}


def lm18_summary(lm18: dict) -> dict:
    """Phase 18's JSON line: the numbers without the per-step digests."""
    mesh = {k: {x: y for x, y in v.items() if x != "digests"}
            for k, v in lm18["mesh"].items()}
    return {**lm18, "mesh": mesh}


def lm_launch_rows(lm18: dict) -> dict:
    """Phase 18's flash launches by kernel, for the kernels line: 18a per
    variant, 18b per mesh and rank."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        out[name] = {
            "launches_18a": {v: r["launches"][name]
                             for v, r in lm18["single"].items()},
            "launches_18b_per_rank": {
                m: {g: l[name] for g, l in r["launches"].items()}
                for m, r in lm18["mesh"].items() if m != "resume"}}
    return out


# -- phase 19: the LM's stage and expert axes --------------------------------------

class RouteLog:
    """Each MoE layer's routing in this process while ``active``: per
    step (:meth:`new_step`), per (canonical layer, microbatch) of a
    pipeline chunk's forward, the chosen experts and the kept mask, kept
    on the device until :meth:`host`. ``ops/moe.route`` and
    ``LMPipeline._forward`` are wrapped (the chunk and microbatch read
    from the forward's arguments; 1F1B's recompute in the backward is not
    recorded) until :meth:`close`."""

    def __init__(self):
        import torch

        from distributed_model_parallel_tpu_torch.ops import moe
        from distributed_model_parallel_tpu_torch.parallel import (
            spmd_pipeline,
        )

        self.steps: list = []
        self.active = False
        self._at = None
        self._saved = (moe.route, spmd_pipeline.LMPipeline._forward)
        route, forward = self._saved
        log = self

        def routed(router, x, cfg):
            out = route(router, x, cfg)
            if log.active and log._at is not None:
                pipe, c, m, j = log._at
                log._at = (pipe, c, m, j + 1)
                log.steps[-1][c * pipe.lc + j, m] = (out[0].to(torch.int8),
                                                    out[3].clone())
            return out

        def forwarded(pipe, params, blocks, tok, tgt, c, got, train,
                      recompute, held, m):
            log._at = (pipe, c, m, 0)
            try:
                return forward(pipe, params, blocks, tok, tgt, c, got, train,
                               recompute, held, m)
            finally:
                log._at = None

        moe.route = routed
        spmd_pipeline.LMPipeline._forward = forwarded

    def new_step(self) -> None:
        self.steps.append({})

    def host(self) -> list:
        """The recorded steps with every tensor on the host."""
        return [{k: (e.cpu(), kp.cpu()) for k, (e, kp) in s.items()}
                for s in self.steps]

    def close(self) -> None:
        from distributed_model_parallel_tpu_torch.ops import moe
        from distributed_model_parallel_tpu_torch.parallel import (
            spmd_pipeline,
        )

        moe.route, spmd_pipeline.LMPipeline._forward = self._saved


def route_diffs(mine: list, card: list) -> list:
    """Per step, this rank's routing against the one card's on the same
    layers and microbatches: token-choices whose expert differs, tokens
    with any such choice, choices whose kept bit differs, and the
    choices compared."""
    out = []
    for s_mine, s_card in zip(mine, card):
        d = dict(choices_differing=0, tokens_differing=0, kept_differing=0,
                 choices=0)
        for key, (e, keep) in s_mine.items():
            e_card, keep_card = s_card[key]
            diff = e != e_card
            d["choices_differing"] += int(diff.sum())
            d["tokens_differing"] += int(diff.any(1).sum())
            d["kept_differing"] += int((keep != keep_card).sum())
            d["choices"] += e.numel()
        out.append(d)
    return out


def _grad_tree(tree: dict) -> dict:
    """Each leaf's ``.grad`` on the host, by the tree's paths."""
    return {k: (_grad_tree(v) if isinstance(v, dict)
                else v.grad.detach().cpu()) for k, v in tree.items()}


def lm19_config(name: str, mesh: dict | None = None, *, batch: int,
                seq: int, microbatches: int = 1, schedule: str = "gpipe",
                virtual_stages: int = 1, steps: int = LM19_STEPS + 1,
                **model_kw):
    """An LMTrainConfig of phase 19: bench.py's LM model at full width,
    bf16, the default SGD, over ``mesh`` with the pipeline's schedule and
    the model's ``model_kw`` (MoE, the axes, the chunked head, depth)."""
    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16,
                                **{**LM_MODEL, **model_kw})
    return lm.LMTrainConfig(
        model=cfg, mesh=tconfig.MeshConfig(**(mesh or {})), batch_size=batch,
        seq_len=seq, num_microbatches=microbatches,
        pipeline_schedule=schedule, virtual_stages=virtual_stages,
        steps_per_epoch=steps, epochs=1, n_tokens=4 * batch * (seq + 1),
        eval_batches=0, device="cuda", **run_dirs(name))


def lm19_launches_want(n_layers: int, stages: int, m: int,
                       schedule: str, steps: int) -> dict:
    """The flash launches a rank's layers, microbatches and schedule
    imply: one a layer a microbatch for each kernel, the forward twice
    under 1f1b (the backward recomputes each chunk from its stash)."""
    per = n_layers // stages * m * steps
    return {"flash_fwd": per * (2 if schedule == "1f1b" else 1),
            "flash_bwd_dq": per, "flash_bwd_dkv": per}


def lm19_moe_check(card) -> dict:
    """``ops/moe.moe_ffn`` on the card (4,096 tokens, E 8, k 2, d 1024,
    f 4096, bf16, the bench config's capacity) against the plain
    per-token version with the routing shared, and the control: the
    plain version in bf16 against itself in f32 on the same routing."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import moe

    cfg = moe.MoEConfig(num_experts=8, d_model=1024, d_ff=4096,
                        capacity_factor=1.5, top_k=2)
    gen = torch.Generator(device="cuda").manual_seed(19)
    d, f, E = 1024, 4096, 8
    p32 = {"router": torch.randn(d, E, generator=gen, device="cuda")
           * d ** -0.5,
           "w_in": torch.randn(E, d, f, generator=gen, device="cuda")
           * d ** -0.5,
           "w_out": torch.randn(E, f, d, generator=gen, device="cuda")
           * f ** -0.5}
    x32 = torch.randn(2, 2048, d, generator=gen, device="cuda")
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    x16 = x32.to(torch.bfloat16)
    y, stats = moe.moe_ffn(p16, x16, cfg)
    routing = moe.route(p16["router"], x16.reshape(-1, d), cfg)
    naive16 = moe.naive_moe_ffn(p16, x16, cfg, routing)
    # The control: the same routing (bf16 logits), the experts in f32.
    naive32 = moe.naive_moe_ffn({k: v.float() for k, v in p16.items()},
                                x16.float(), cfg, routing)
    torch.cuda.synchronize()
    scale = naive32.abs().max().item()
    out = dict(err=(y.float() - naive16.float()).abs().max().item() / scale,
               control=(naive16.float() - naive32).abs().max().item()
               / scale, drop=float(stats[2]),
               finite=bool(torch.isfinite(y).all()))
    print(f"lm 19a moe_ffn [{card}] 4,096 tokens, E 8, k 2, d 1024, f 4096, "
          f"bf16: max|moe_ffn - naive| / max|naive f32| {out['err']:.3e} "
          f"(rtol {LM19_MOE_RTOL}); control, naive bf16 vs f32 "
          f"{out['control']:.3e}; drop rate {out['drop']}")
    if not (out["finite"] and out["err"] <= LM19_MOE_RTOL):
        fail("19a/lm pipeline one card", f"moe_ffn vs naive {out}")
    return out


def lm19_run(name: str, kw: dict, b: int, t: int, m: int, schedule: str,
             wrappers: dict, lm_model_flops, card) -> dict:
    """One 19a run on one card from seed 0's weights: LM19_STEPS gated
    steps (flash launches counted from 0) and one timed step. An MoE run
    leaves 19b every leaf's gradient after step 0 (LM19_MOE_GRADS) and
    its routing in the gated steps (LM19_ROUTES)."""
    import torch

    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    config = lm19_config(f"lm19a_{name}", batch=b, seq=t, microbatches=m,
                         schedule=schedule, **kw)
    trainer = lm.LMTrainer(config, params=tfm.init_params(
        config.model, seed=0, device="cuda"))
    moe = bool(config.model.moe_experts)
    routes = RouteLog() if moe else None
    run_dir = os.environ[RUN_DIR_ENV]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, drops = [], [], []
    for s in range(LM19_STEPS + 1):
        toks, tgts = trainer.sample_batch(0, s)
        if routes is not None:
            routes.active = s < LM19_STEPS
            routes.new_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(toks, tgts)
        times.append(time.perf_counter() - t0)
        if s < LM19_STEPS:
            losses.append(loss)
            drops.append(trainer.last_step_metrics.get("moe_drop"))
        if s == 0 and moe:
            torch.save(_grad_tree(trainer.params),
                       os.path.join(run_dir, LM19_MOE_GRADS))
        if s == LM19_STEPS - 1:
            launches = {n: w.launches for n, w in wrappers.items()}
    if routes is not None:
        routes.close()
        torch.save(routes.host()[:LM19_STEPS],
                   os.path.join(run_dir, LM19_ROUTES))
    peak = torch.cuda.max_memory_allocated()
    step_s = times[-1]
    want = lm19_launches_want(config.model.n_layers, 1, m, schedule,
                              LM19_STEPS)
    r = dict(losses=losses, times=times, step_s=step_s,
             tokens_per_s=b * t / step_s,
             mfu=lm_model_flops(config.model, b, t) / step_s
             / card_peak('flops'), peak_bytes=peak, launches=launches,
             launches_want=want, drop=drops)
    print(f"lm 19a {name} [{card}] B {b}, T {t}, M {m}, {schedule}: "
          f"timed step s {step_s} ({times}), tokens/s {r['tokens_per_s']}, "
          f"MFU {r['mfu']}, peak max_memory_allocated {peak} B, drop rate "
          f"{drops}, flash launches {launches} (want {want}), losses "
          f"{losses}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return r


def lm19_reference(fa, lm_model_flops, card) -> dict:
    """Phase 19a: the one-card references (LM19_REFS) by :func:`lm19_run`,
    then :func:`lm19_moe_check`."""
    wrappers = flash_wrappers(fa)
    out, bad = {}, []
    for name, (kw, b, t, m, schedule) in LM19_REFS.items():
        r = out[name] = lm19_run(name, kw, b, t, m, schedule, wrappers,
                                 lm_model_flops, card)
        if not all(math.isfinite(x) for x in r["losses"]):
            bad.append(f"{name}: losses {r['losses']}")
        if r["launches"] != r["launches_want"]:
            bad.append(f"{name}: flash launches {r['launches']}, want "
                       f"{r['launches_want']}")
        if "moe_experts" in kw and not all(0.0 <= x <= 1.0
                                           for x in r["drop"]):
            bad.append(f"{name}: drop rate {r['drop']}")
    m4, m1 = out["dense_b4_gpipe_m4"]["losses"], out["dense_b4_m1"]["losses"]
    gap = [abs(a - b) for a, b in zip(m4, m1)]
    print(f"lm 19a: gpipe M 4 vs M 1 on the same batches, every step's "
          f"|diff| {gap} (atol {LM19_LOSS_ATOL})")
    if not max(gap) <= LM19_LOSS_ATOL:
        bad.append(f"gpipe M 4 vs M 1 losses {m4} vs {m1}")
    if bad:
        fail("19a/lm pipeline one card", "; ".join(bad))
    out["moe_ffn"] = lm19_moe_check(card)
    return out


def lm19_grad_check(trainer) -> dict:
    """Mesh iv after step 0: the gradient of every leaf this rank holds
    against the one-card MoE run's (LM19_MOE_GRADS) on the same slice
    (its blocks interleaved and cut as this rank holds them), by path:
    ``rel`` ||g_mesh - g_card|| / ||g_card|| and ``ratio`` ||g_mesh|| /
    ||g_card|| (2 for a gradient taken ep = 2 times)."""
    import torch

    from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )

    # Mapped, not read: each rank touches only the slices it holds.
    card = torch.load(os.path.join(os.environ[RUN_DIR_ENV], LM19_MOE_GRADS),
                      mmap=True)
    spec, cfg = trainer.spec, trainer.cfg
    cuts = tp.param_cuts(cfg, spec)
    out = {}
    for key, leaf in trainer.params.items():
        pairs = ([(f"blocks.{k}", v, card["blocks"][k], cuts["blocks"][k])
                  for k, v in leaf.items()] if isinstance(leaf, dict)
                 else [(key, leaf, card[key], cuts[key])])
        for path, mine, theirs, cut in pairs:
            if path.startswith("blocks."):
                theirs = spmd_pipeline.interleave_block_rows(
                    {"w": theirs}, cfg.n_layers, spec.num_stages,
                    trainer.config.virtual_stages)["w"]
            want = tp.cut_leaf(theirs, cut, spec).to(spec.device).float()
            got = mine.grad.detach().float()
            n = want.norm()
            out[path] = dict(rel=((got - want).norm() / n).item(),
                             ratio=(got.norm() / n).item())
    return out


def lm19_rank(spec, meshes: dict, resume: bool, decode: bool = False
              ) -> dict:
    """Phases 19b and 19c on one rank: per mesh of ``meshes`` (the group
    laid out anew) a trainer from seed 0's weights, LM19_STEPS gated
    steps with the flash launches and the collectives counted from 0, any
    plain attention counted (it must not run), a digest of every slice
    after each step, peak memory; one step more with the collectives
    timed. Mesh iv also reports every leaf's gradient after step 0 and
    its routing in the gated steps against the one card's. Then
    (``resume``) phase 19c, and (``decode``) phase 20b's rank work on the
    group laid out as GEN_MESH (:func:`gen_sharded_run`; 20b gates it
    after 20a), which so shares this spawn."""
    import torch

    from distributed_model_parallel_tpu_torch import mesh as mesh_mod
    from distributed_model_parallel_tpu_torch.config import MeshConfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.ops import collectives as C
    from distributed_model_parallel_tpu_torch.ops import flash_attention as fa
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops,
    )

    plain = {"calls": 0}

    def counted(fn):
        def run(*a, **kw):
            plain["calls"] += 1
            return fn(*a, **kw)
        return run

    for name in ("flash_forward_plain", "flash_bwd_dq_plain",
                 "flash_bwd_dkv_plain", "full_attention"):
        setattr(fa, name, counted(getattr(fa, name)))
    wrappers = flash_wrappers(fa)
    out = {}
    laps = RankLaps(spec, "19b-c")
    for name, (mesh, kw, b, t, m, schedule, v, _) in meshes.items():
        spec_m = mesh_mod.make_mesh(MeshConfig(**mesh), spec.device)
        config = lm19_config(f"lm19b_{name}", mesh, batch=b, seq=t,
                             microbatches=m, schedule=schedule,
                             virtual_stages=v, **kw)
        trainer = lm.LMTrainer(config, params=tfm.init_params(
            config.model, seed=0, device=spec.device), spec=spec_m)
        moe = bool(config.model.moe_experts)
        routes = RouteLog() if moe else None
        for w in wrappers.values():
            w.launches = 0
        plain["calls"] = 0
        C.reset_counts()
        torch.cuda.synchronize(spec.device)
        torch.cuda.reset_peak_memory_stats(spec.device)
        row = {"grid": spec_m.grid, "losses": [], "times": [],
               "digests": [], "metrics": []}
        for s in range(LM19_STEPS):
            toks, tgts = trainer.sample_batch(0, s)
            if routes is not None:
                routes.active = True
                routes.new_step()
            torch.cuda.synchronize(spec.device)
            t0 = time.perf_counter()
            row["losses"].append(trainer.train_step(toks, tgts))
            row["times"].append(time.perf_counter() - t0)
            row["metrics"].append(dict(trainer.last_step_metrics))
            row["digests"].append(_digests(trainer.params))
            if s == 0 and moe:
                row["grads_vs_card"] = lm19_grad_check(trainer)
        if routes is not None:
            routes.close()
            row["routes_vs_card"] = route_diffs(routes.host(), torch.load(
                os.path.join(os.environ[RUN_DIR_ENV], LM19_ROUTES)))
            del routes
        row["launches"] = {n: w.launches for n, w in wrappers.items()}
        row["plain_calls"] = plain["calls"]
        row["calls"] = {k: c / LM19_STEPS for k, c in C.calls.items()}
        row["bytes"] = {k: c / LM19_STEPS for k, c in C.wire_bytes.items()}
        row["peak_bytes"] = torch.cuda.max_memory_allocated(spec.device)
        C.reset_counts()
        with C.timed() as secs:
            trainer.train_step(*trainer.sample_batch(0, LM19_STEPS))
        row["us"] = {k: x * 1e6 for k, x in secs.items()}
        laps.done(f"19b {name}")
        step_s = statistics.median(row["times"][1:])
        world = spec_m.config.num_devices
        row.update(step_s=step_s, bubble=trainer.pipeline.bubble_share(),
                   tokens_per_s_card=b * t / step_s / world,
                   mfu_card=lm_model_flops(config.model, b, t) / world
                   / step_s / card_peak('flops'))
        out[name] = row
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    if resume:
        out["resume"] = lm19_resume(spec)
        laps.done("19c")
    if decode:
        out["decode"] = gen_sharded_run(mesh_mod.make_mesh(
            MeshConfig(**GEN_MESH), spec.device))
        laps.done("20b")
    return out


def lm19_resume(spec) -> dict:
    """Phase 19c on one rank: mesh iv at LM19_RESUME_LAYERS layers,
    ``fit`` against ``fit`` preempted by a ``step_hook`` at
    LM19_PREEMPT_AT and finished by ``LMTrainer(resume=True)`` —
    per-step losses, digests of this rank's parameter and optimizer-state
    slices, the global step and the history compared in this process; the
    trainer's slices are its rows of the interleaved storage order and
    the resumed trainer's equal the preempted one's; the checkpoint's bytes, save
    and restore ms (rank 0, the writer); a resume at
    ``virtual_stages=1`` (it must raise, naming virtual_stages)."""
    import dataclasses

    import torch

    from distributed_model_parallel_tpu_torch import mesh as mesh_mod
    from distributed_model_parallel_tpu_torch.config import MeshConfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.parallel import spmd_pipeline
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from distributed_model_parallel_tpu_torch.train import checkpoint as ck
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    mesh, kw, b, _, m, schedule, v, _ = LM19_MESHES["iv_stage2_expert2_moe"]
    spec_m = mesh_mod.make_mesh(MeshConfig(**mesh), spec.device)
    configs = {n: lm19_config(f"lm19c_{n}", mesh, batch=b,
                              seq=LM19_RESUME_SEQ, microbatches=m,
                              schedule=schedule,
                              virtual_stages=v, steps=LM19_RESUME_STEPS,
                              **dict(kw, n_layers=LM19_RESUME_LAYERS))
               for n in ("full", "cut")}
    timings = {"save_ms": [], "restore_ms": []}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            timings[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return run

    ck.Checkpointer.save = timed(ck.Checkpointer.save, "save_ms")
    # A resume reads through restore_resharded (the elastic slot ladder).
    ck.Checkpointer.restore_resharded = timed(
        ck.Checkpointer.restore_resharded, "restore_ms")

    def state(tr, history, steps):
        # The epoch's train averages (loss, drop rate) cover the steps its
        # trainer ran, as in the JAX trainer: the per-step losses hold them.
        # Each rank compares the slices it holds (no gather).
        local = lambda t, cuts: t.detach().float().cpu().numpy()
        return dict(history=[{k: h[k] for k in ("epoch", "loss_val")}
                             for h in history], steps=steps,
                    params=_digests(tr.params),
                    opt_state=_digests(_tensor_tree(
                        tr.opt_state_tree(local))),
                    global_step=tr.global_step)

    init = lambda cfg: tfm.init_params(cfg.model, seed=0, device=spec.device)
    full = lm.LMTrainer(configs["full"], params=init(configs["full"]),
                        spec=spec_m)
    a = state(full, full.fit(), [r["loss"] for r in full.step_log])
    del full
    canon = init(configs["cut"])
    cut = lm.LMTrainer(configs["cut"], params=canon, spec=spec_m)
    # The trainer's slices are its rows of the interleaved storage order.
    cfg = configs["cut"].model
    stored = spmd_pipeline.interleave_block_rows(
        canon["blocks"], cfg.n_layers, spec_m.num_stages, v)
    cuts = tp.param_cuts(cfg, spec_m)["blocks"]
    storage_order = all(torch.equal(tp.cut_leaf(stored[k], cuts[k], spec_m),
                                    cut.params["blocks"][k])
                        for k in stored)
    del canon, stored
    cut.step_hook = lambda tr: (tr.preemption.request()
                                if (tr._pos_epoch, tr._pos_step)
                                == LM19_PREEMPT_AT else None)
    first = cut.fit()
    steps = [r["loss"] for r in cut.step_log]
    preempted = cut.global_step
    at_preempt = _digests(cut.params)
    del cut
    resumed = lm.LMTrainer(dataclasses.replace(configs["cut"], resume=True),
                           spec=spec_m)
    # The checkpoint restores each rank's storage-order rows.
    loaded_same = _digests(resumed.params) == at_preempt
    b_state = state(resumed, first + resumed.fit(),
                    steps + [r["loss"] for r in resumed.step_log])
    differing = sum(a[key][k] != b_state[key][k]
                    for key in ("params", "opt_state") for k in a[key])
    arrays = sum(len(a[key]) for key in ("params", "opt_state"))
    same = (differing == 0 and a["steps"] == b_state["steps"]
            and a["global_step"] == b_state["global_step"]
            and a["history"] == b_state["history"]
            and set(a["params"]) == set(b_state["params"]))
    path = resumed.ckpt._latest_path("lm-preempt")
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    try:
        lm.LMTrainer(dataclasses.replace(configs["cut"], resume=True,
                                         virtual_stages=1), spec=spec_m)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(same=same, differing=differing, arrays=arrays,
                loaded_same=loaded_same, storage_order=storage_order,
                steps=a["steps"], preempted_at_step=preempted,
                global_step=b_state["global_step"], bytes=nbytes, **timings,
                other_v=refusal)


def _tensor_tree(tree):
    """A numpy tree (the optimizer state's) as tensors, for digests."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(np.asarray(tree)))


def lm19_mesh(mesh_mod, card, refs: dict, world: int, backend: str,
              resume: bool, decode: bool = False, rides=()) -> dict:
    """Phase 19b (and 19c with ``resume``): :func:`lm19_rank` on ``world``
    ranks. Gates, per mesh: every step's loss within LM19_LOSS_ATOL of
    its 19a reference (same model, batches and microbatch partition);
    the same losses on every rank; after every step each slice bitwise
    equal on every rank that holds it; each rank's flash launches what
    its layers, microbatches and schedule imply, no plain attention; in
    iii 1f1b's peak memory a rank below gpipe's; in iv every leaf's
    gradient after step 0 within LM19_GRAD_RTOL of the one-card run's,
    its norm ratio within LM19_GRAD_RATIO, and step 2's loss within
    LM19_MOE_STEP2_ATOL (the routing decisions that differ from the one
    card's are counted and printed); 19c bit for bit, the blocks in
    storage order, and the virtual_stages=1 resume refused."""
    from distributed_model_parallel_tpu_torch.config import MeshConfig
    from distributed_model_parallel_tpu_torch.models import transformer as tfm
    from distributed_model_parallel_tpu_torch.parallel import (
        tensor_parallel as tp,
    )

    res = dp_spawn(mesh_mod, lm19_rank, world, "19b/lm pipeline mesh",
                   LM19_MESHES, resume, decode, backend=backend,
                   rides=rides)
    bad, summary = [], {}
    axis_index = {"stage": 1, "model": 2, "expert": 4}
    for name, (mesh, kw, b, t, m, schedule, v, ref) in LM19_MESHES.items():
        rows = [r[name] for r in res]
        r0 = rows[0]
        want_l = refs[ref]["losses"]
        errs = [abs(x - y) for x, y in zip(r0["losses"], want_l)]
        atol = [LM19_LOSS_ATOL] * LM19_STEPS
        if "moe_experts" in kw:
            atol[2:] = [LM19_MOE_STEP2_ATOL] * (LM19_STEPS - 2)
        if len(errs) != LM19_STEPS or any(e > a for e, a in zip(errs, atol)):
            bad.append(f"{name}: losses {r0['losses']} vs 19a {ref} "
                       f"{want_l} (|diff| {errs} > {atol})")
        if any(r["losses"] != r0["losses"] for r in rows):
            bad.append(f"{name}: ranks disagree on the losses")
        spec = mesh_mod.MeshSpec(MeshConfig(**mesh))
        cfg = tfm.TransformerConfig(**{**LM_MODEL, **kw})
        cuts = {}
        for k, c in tp.param_cuts(cfg, spec).items():
            if isinstance(c, dict):
                cuts.update({f"{k}.{kk}": cc for kk, cc in c.items()})
            else:
                cuts[k] = c
        mismatched = 0
        for s in range(LM19_STEPS):
            held: dict = {}
            for r in rows:
                for key, digest in r["digests"][s].items():
                    sid = (key,) + tuple(r["grid"][axis_index[a]]
                                         for a, _ in cuts[key])
                    mismatched += sid in held and held[sid] != digest
                    held[sid] = digest
        if mismatched:
            bad.append(f"{name}: {mismatched} slice digests differ between "
                       f"the ranks that hold them")
        want = lm19_launches_want(cfg.n_layers, mesh.get("stage", 1),
                                  m, schedule, LM19_STEPS)
        for r in rows:
            if r["launches"] != want:
                bad.append(f"{name} rank {r['grid']}: flash launches "
                           f"{r['launches']}, want {want}")
            if r["plain_calls"]:
                bad.append(f"{name} rank {r['grid']}: {r['plain_calls']} "
                           f"plain attention calls on the card")
            lo, hi = LM19_GRAD_RATIO
            for k, u in r.get("grads_vs_card", {}).items():
                if not (u["rel"] <= LM19_GRAD_RTOL
                        and lo <= u["ratio"] <= hi):
                    bad.append(f"{name} rank {r['grid']}: {k} gradient vs "
                               f"one card {u}")
        peak = max(r["peak_bytes"] for r in rows)
        hops = {k: r0["calls"].get(k, 0) for k in
                ("pp_send", "pp_recv", "moe", "tp_all_reduce",
                 "bucketed_psum", "pp_loss")}
        hop_bytes = {k: r0["bytes"].get(k, 0) for k in hops}
        summary[name] = dict(
            losses=r0["losses"], loss_err=errs, step_s=r0["step_s"],
            gated_times=r0["times"], tokens_per_s_card=r0["tokens_per_s_card"],
            mfu_card=r0["mfu_card"], peak_bytes_rank=peak,
            bubble=r0["bubble"], calls_per_step=hops,
            bytes_per_step=hop_bytes, us_timed_step=r0["us"],
            metrics=r0["metrics"],
            launches={str(r["grid"]): r["launches"] for r in rows},
            launches_want=want, digests_mismatched=mismatched)
        if "grads_vs_card" in r0:
            grads = {}
            for r in rows:
                for k, u in r["grads_vs_card"].items():
                    g = grads.setdefault(k, dict(rel=0.0, ratio=[]))
                    g["rel"] = max(g["rel"], u["rel"])
                    g["ratio"] = [min(g["ratio"] + [u["ratio"]]),
                                  max(g["ratio"] + [u["ratio"]])]
            # Each stage's layers route on its ranks; expert ranks of a
            # stage route the same tokens, so the ranks at expert 0 hold
            # every layer once.
            routes = [dict(choices_differing=0, tokens_differing=0,
                           kept_differing=0, choices=0)
                      for _ in range(LM19_STEPS)]
            for r in rows:
                if r["grid"][axis_index["expert"]] == 0:
                    for acc, d in zip(routes, r["routes_vs_card"]):
                        for k in acc:
                            acc[k] += d[k]
            summary[name].update(grads_vs_card=grads, routes_vs_card=routes)
        print(f"lm 19b {name} [{card}] world {world} over {backend}, B {b}, "
              f"T {t}, M {m}, {schedule}, V {v}: step s {r0['step_s']} "
              f"(median of steps 1-{LM19_STEPS - 1}: {r0['times']}), "
              f"tokens/s a card "
              f"{r0['tokens_per_s_card']}, MFU a card {r0['mfu_card']}, peak "
              f"max_memory_allocated a rank {peak} B, table bubble "
              f"{r0['bubble']:.4f}; losses {r0['losses']} vs 19a {ref} "
              f"(|diff| {errs}); rank 0 a step: calls {hops}, bytes "
              f"{hop_bytes}; timed step us {r0['us']}; flash launches "
              + ", ".join(f"{r['grid']} {r['launches']}" for r in rows)
              + f" (want {want}); slice digests differing {mismatched}"
              + (f"; after step 0, each leaf's gradient vs one card (max "
                 f"rel, [min, max] norm ratio over the ranks) "
                 f"{summary[name]['grads_vs_card']}; routing vs one card a "
                 f"gated step {summary[name]['routes_vs_card']}"
                 if "grads_vs_card" in summary[name] else "")
              + (f"; router stats {r0['metrics']}" if cfg.moe_experts
                 else ""))
    g, f1 = (summary[f"iii_stage2_model2_{s}"]["peak_bytes_rank"]
             for s in ("gpipe", "1f1b"))
    print(f"lm 19b iii: peak a rank 1f1b {f1} B < gpipe {g} B: {f1 < g}")
    if not f1 < g:
        bad.append(f"iii: 1f1b peak {f1} not below gpipe's {g}")
    if resume:
        rs = [r["resume"] for r in res]
        r0 = rs[0]
        ok = all(r["same"] and r["loaded_same"] and r["storage_order"]
                 for r in rs)
        refused = all(r["other_v"] and "virtual_stages=1" in r["other_v"]
                      for r in rs)
        print(f"lm 19c [{card}]: mesh iv at {LM19_RESUME_LAYERS} layers, "
              f"preempted at step {r0['preempted_at_step']} and resumed == "
              f"uninterrupted bit for bit on every rank, the restored slices"
              f" == the preempted ones, in storage order: {ok} "
              f"({[r['differing'] for r in rs]} of {r0['arrays']} arrays "
              f"differing; steps {r0['steps']}); checkpoint {r0['bytes']} B, "
              f"save ms {r0['save_ms']}, restore ms {r0['restore_ms']}; "
              f"resume at virtual_stages=1 refused: {refused} "
              f"({r0['other_v']!r})")
        if not ok:
            bad.append(f"19c: resumed run differs: "
                       f"{[(r['differing'], r['loaded_same'], r['storage_order']) for r in rs]}")
        if not refused:
            bad.append(f"19c: virtual_stages=1 resume not refused: "
                       f"{[r['other_v'] for r in rs]}")
        summary["resume"] = dict(r0)
    if bad:
        fail("19b/lm pipeline mesh", "; ".join(bad))
    if decode:
        summary["decode_ranks"] = [r["decode"] for r in res]
    return summary


def lm19_phase(laps, fa, lm_model_flops, mesh_mod, card,
               decode: bool = False, rides=()) -> dict:
    """Phase 19: 19a on one card, then 19b and 19c over 4 ranks (gloo on
    the one card; with four cards, NCCL with a card each); with
    ``decode`` the same ranks then run 20b's rank work
    (``mesh["decode_ranks"]``), and after it the ``rides`` of earlier
    phases (18b-c, 17e's hierarchical part), each gated when done."""
    import torch

    refs = lm19_reference(fa, lm_model_flops, card)
    laps.done("19a/lm pipeline one card")
    four = torch.cuda.device_count() >= 4
    backend = "nccl" if four else "gloo"
    mesh = lm19_mesh(mesh_mod, card, refs, 4, backend, True, decode, rides)
    for ride in rides:
        ride.finish()
    laps.done("19b-c/lm pipeline mesh" + (", 20b's ranks" if decode else "")
              + (", the rides of 18b-c and 17e" if rides else ""))
    return {"single": refs, "mesh": mesh, "backend": backend}


def lm19_summary(lm19: dict) -> dict:
    """Phase 19's JSON line: the numbers without the per-step digests."""
    return {**lm19, "mesh": {k: {x: y for x, y in v.items()
                                 if x != "digests"}
                             for k, v in lm19["mesh"].items()}}


def lm19_launch_rows(lm19: dict) -> dict:
    """Phase 19's flash launches by kernel, for the kernels line: 19a per
    reference, 19b per mesh and rank."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        out[name] = {
            "launches_19a": {v: r["launches"][name]
                             for v, r in lm19["single"].items()
                             if "launches" in r},
            "launches_19b_per_rank": {
                m: {g: l[name] for g, l in r["launches"].items()}
                for m, r in lm19["mesh"].items() if m != "resume"}}
    return out


def greedy_agreement(a: list, b: list) -> list:
    """Per row, the tokens of ``a`` that equal ``b``'s before the first
    difference."""
    out = []
    for ra, rb in zip(a, b):
        n = 0
        for x, y in zip(ra, rb):
            if x != y:
                break
            n += 1
        out.append(n)
    return out


def decode_bytes(tfm, cfg, n_params: int, batch: int, t0: int,
                 steps: int) -> int:
    """bench.py's decode byte model (``bench_decode``): every parameter read
    once a step (bf16) plus each step's read of the K and V cache up to
    its ``DECODE_READ_SEG`` boundary, and one whole read for the
    prefill's emit."""
    total = t0 + steps
    seg = tfm.DECODE_READ_SEG
    read_sum = sum(min(total, (p // seg + 1) * seg)
                   for p in range(t0, total - 1)) + total
    kv = cfg.n_layers * batch * read_sum * cfg.kv_heads * cfg.head_dim * 4
    return 2 * n_params * steps + kv


def gen_prompt(vocab: int):
    import numpy as np

    return np.random.default_rng(20).integers(
        0, vocab, (GEN_B, GEN_PROMPT)).astype(np.int64)


def generate_phase(tfm, pa, fa, card) -> dict:
    """Phase 20a: ``generate`` at bench.py's decode geometry, through the
    kernels (the flash forward for the batched prefill, the paged-decode
    kernel for each one-token step) and through the plain path; a chunked
    prefill; the MoE variant."""
    import dataclasses

    import torch

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(gen_prompt(cfg.vocab_size)).cuda()
    tfm.generate(params, cfg, prompt, 4)            # cuBLAS/allocator warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention_kernel.launches = 0
    fa.flash_forward_kernel.launches = 0
    t0 = time.perf_counter()
    toks, logits = tfm.generate(params, cfg, prompt, GEN_STEPS,
                                return_logits=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": pa.paged_attention_kernel.launches,
                "flash_fwd": fa.flash_forward_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    cache_shape = list(tfm.generate.cache_shape)
    want = {"paged_decode": cfg.n_layers * (GEN_STEPS - 1),
            "flash_fwd": cfg.n_layers}
    print(f"generate: launches {launches} (want {want}); cache {cache_shape}")
    if launches != want:
        fail("20a/generate", f"kernel launches {launches} != {want}")
    if toks.shape != (GEN_B, GEN_PROMPT + GEN_STEPS) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("20a/generate", f"tokens of shape {tuple(toks.shape)} or out "
                             f"of the vocabulary")
    ptoks, plogits = tfm.generate(params, cfg, prompt, GEN_PLAIN_STEPS,
                                  impl="plain", return_logits=2)
    ctoks, clogits = tfm.generate(params, cfg, prompt, 2,
                                  prefill_chunk=GEN_CHUNK, return_logits=2)
    torch.cuda.synchronize()
    for name, x in (("kernel", logits), ("plain", plogits),
                    ("chunked", clogits)):
        if not torch.isfinite(x).all():
            fail("20a/generate", f"non-finite {name} logits")
    err = (logits.float() - plogits.float()).abs().amax((0, 2)).tolist()
    cerr = (clogits.float() - logits.float()).abs().amax((0, 2)).tolist()
    agree = greedy_agreement(toks[:, GEN_PROMPT:].tolist(),
                             ptoks[:, GEN_PROMPT:].tolist())
    print(f"generate: prefill and first decode step logits, kernels vs "
          f"plain max_abs_err {err}, chunked ({GEN_CHUNK}) vs batched "
          f"{cerr} (atol {LOGITS_ATOL}; |logits| max "
          f"{plogits.float().abs().max().item()}); greedy tokens equal to "
          f"the plain path's before the first difference, per row: {agree} "
          f"of {GEN_PLAIN_STEPS}")
    if not max(err) <= LOGITS_ATOL:
        fail("20a/generate", f"kernel vs plain logits {err} > {LOGITS_ATOL}")
    if not max(cerr) <= LOGITS_ATOL:
        fail("20a/generate", f"chunked vs batched logits {cerr} > "
                             f"{LOGITS_ATOL}")
    n_params = sum(v.numel() for v in params["blocks"].values()) + sum(
        v.numel() for k, v in params.items() if k != "blocks")
    nbytes = decode_bytes(tfm, cfg, n_params, GEN_B, GEN_PROMPT, GEN_STEPS)
    bound_s = nbytes / card_peak('hbm')
    out = {"lm_decode_bs8_tokens_per_sec_per_chip":
           GEN_B * GEN_STEPS / wall,
           "wall_s": wall, "token_latency_ms": wall / GEN_STEPS * 1e3,
           "bound_s": bound_s, "bound_bytes": nbytes,
           "share_of_bound": bound_s / wall,
           "peak_bytes": peak, "cache_shape": cache_shape,
           "launches": launches, "logits_err": err, "chunked_err": cerr,
           "agree_plain": agree}
    print(f"generate [{card}]: lm_decode_bs8_tokens_per_sec_per_chip "
          f"{out['lm_decode_bs8_tokens_per_sec_per_chip']}, per-token "
          f"latency {out['token_latency_ms']} ms, {wall} s for {GEN_STEPS} "
          f"steps; bench.py's byte model {nbytes} B -> bound {bound_s} s at "
          f"3.35 TB/s ({out['share_of_bound']:.1%} of it); peak "
          f"max_memory_allocated {peak} B")
    out["ref_logits"] = logits[:, 0].float().cpu().numpy()
    out["ref_tokens"] = toks.cpu().numpy()
    del params, toks, ptoks, ctoks
    torch.cuda.empty_cache()

    # MoE: routing is discrete, and a bf16 router tie that the two paths'
    # attention roundings resolve differently moves a token to another
    # expert (and, at a full queue, drops another token). So the kernels
    # are held against the plain path with the kernel run's routing
    # replayed (the same experts, queue slots and drops; the gates from the
    # plain path's own router), and the free-running plain path's flips
    # and logits are printed beside it.
    from distributed_model_parallel_tpu_torch.ops import moe

    mcfg = dataclasses.replace(cfg, **GEN_MOE)
    mparams = tfm.init_params(mcfg, seed=0, device="cuda")
    replay = RouteReplay(moe, count=mcfg.n_layers)       # the prefill's
    try:
        torch.cuda.synchronize()
        replay.mode = "record"
        t0 = time.perf_counter()
        mtoks, mlogits = tfm.generate(mparams, mcfg, prompt, GEN_MOE_STEPS,
                                      return_logits=1)
        torch.cuda.synchronize()
        mwall = time.perf_counter() - t0
        replay.mode = "replay"
        _, rlogits = tfm.generate(mparams, mcfg, prompt, 1, impl="plain",
                                  return_logits=1)
        replay.mode = "compare"
        mp, mplogits = tfm.generate(mparams, mcfg, prompt, GEN_PLAIN_MOE_STEPS,
                                    impl="plain", return_logits=1)
        torch.cuda.synchronize()
    finally:
        replay.close()
    if not all(torch.isfinite(x).all() for x in (mlogits, rlogits,
                                                  mplogits)):
        fail("20a/generate", "non-finite MoE logits")
    merr = (mlogits.float() - rlogits.float()).abs().max().item()
    ferr = (mlogits.float() - mplogits.float()).abs().max().item()
    magree = greedy_agreement(mtoks[:, GEN_PROMPT:].tolist(),
                              mp[:, GEN_PROMPT:].tolist())
    prefill_choices = mcfg.n_layers * GEN_B * GEN_PROMPT * mcfg.moe_top_k
    out["moe"] = {"logits_err_same_routing": merr,
                  "logits_err_free": ferr,
                  "prefill_flips": replay.flips["compare"],
                  "prefill_choices": prefill_choices,
                  "agree_plain": magree,
                  "tokens_per_s": GEN_B * GEN_MOE_STEPS / mwall,
                  "wall_s": mwall}
    print(f"generate MoE ({GEN_MOE}) [{card}]: prefill logits, kernels vs "
          f"plain with the kernel run's routing replayed: max_abs_err "
          f"{merr} (atol {LOGITS_ATOL}); free-running plain path: "
          f"{replay.flips['compare']} of {prefill_choices} prefill routing "
          f"choices differ ({replay.flips['replay']} under replay), logits "
          f"max_abs_err {ferr}, greedy agreement per row {magree} of "
          f"{GEN_PLAIN_MOE_STEPS}; tokens/s {out['moe']['tokens_per_s']}")
    if not merr <= LOGITS_ATOL:
        fail("20a/generate", f"MoE kernel vs plain logits (same routing) "
                             f"{merr} > {LOGITS_ATOL}")
    del mparams
    torch.cuda.empty_cache()
    return out


class RouteReplay:
    """Wraps ``ops/moe.route`` until :meth:`close`. ``mode`` "record" keeps
    each call's routing in order; "replay" returns the recorded choices
    (experts, queue slots, kept mask, capacity, stats) of the next
    recorded call with the gates taken from this call's own router
    probabilities at those experts; "compare" routes freely. Under
    "replay" and "compare" ``flips[mode]`` counts, over the first
    ``count`` calls, the (token, choice) entries whose own top-k differs
    from the recorded call's."""

    def __init__(self, moe, count: int):
        self.moe, self.route, self.count = moe, moe.route, count
        self.mode, self.calls, self.at = None, [], {}
        self.flips = {"replay": 0, "compare": 0}
        moe.route = self._route

    def _route(self, router, x, cfg):
        import torch

        out = self.route(router, x, cfg)
        if self.mode == "record":
            self.calls.append(out)
            return out
        if self.mode not in self.flips:
            return out
        i = self.at.get(self.mode, 0)
        self.at[self.mode] = i + 1
        if i >= len(self.calls):
            return out
        rec = self.calls[i]
        if i < self.count:
            self.flips[self.mode] += int((rec[0] != out[0]).sum())
        if self.mode == "compare":
            return out
        probs = torch.softmax(x @ router, dim=-1)
        gates = torch.gather(probs, 1, rec[0])
        if cfg.top_k > 1 and cfg.normalize_gates:
            gates = gates / gates.sum(-1, keepdim=True)
        return (rec[0], gates, *rec[2:])

    def close(self) -> None:
        self.moe.route = self.route


def gen_sharded_run(spec) -> dict:
    """Phase 20b's work on one rank of the (data 2, model 2) mesh:
    ``generate_sharded`` at full width (the rank cuts its model slice of
    the same seeded weights as 20a) on 20a's prompt, with the TP
    all-reduces counted and each timed with the device drained on both
    sides. Returns its rows' first-step logits and the whole tokens for
    :func:`gen_sharded` to hold against 20a's."""
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import collectives as C
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, tp_axis="model",
                                **MODEL)
    params = tfm.init_params(cfg, seed=0, device=spec.device)
    prompt = gen_prompt(cfg.vocab_size)
    tfm.generate_sharded(params, cfg, prompt, 1, spec)        # warm-up
    torch.cuda.synchronize()
    C.reset_counts()
    pa.paged_attention_kernel.launches = 0
    t0 = time.perf_counter()
    with C.timed():
        toks, logits = tfm.generate_sharded(params, cfg, prompt,
                                            GEN_MESH_STEPS, spec,
                                            return_logits=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rank": spec.rank, "backend": spec.backend,
           "rows": (spec.rows(GEN_B).start, spec.rows(GEN_B).stop),
           "cache_shape": list(tfm.generate.cache_shape),
           "logits": logits[:, 0].float().cpu().numpy(),
           "tokens": toks.cpu().numpy(),
           "tp_calls": C.calls["tp_all_reduce"],
           "tp_bytes": C.wire_bytes["tp_all_reduce"],
           "tp_s": C.seconds["tp_all_reduce"],
           "paged_decode": pa.paged_attention_kernel.launches,
           "wall_s": wall}
    del params
    torch.cuda.empty_cache()
    return out


def gen_sharded(mesh, ref: dict, card, backend: str,
                ranks: list | None = None) -> dict:
    """Phase 20b: :func:`gen_sharded_run` on four ranks over (data 2,
    model 2) — ``ranks`` when 19b's spawn already ran it, else a spawn of
    its own. Gates: each rank's cache holds 4 of the 8 kv heads and half
    the rows, its first-step logits within LOGITS_ATOL of 20a's rows,
    every rank returns the same whole batch, paged_decode launches ==
    n_layers x (steps - 1)."""
    import numpy as np

    from distributed_model_parallel_tpu_torch.config import MeshConfig

    if ranks is None:
        world = GEN_MESH["data"] * GEN_MESH["model"]
        ranks = dp_spawn(mesh, gen_sharded_run, world,
                         "20b/generate_sharded", backend=backend,
                         config=MeshConfig(**GEN_MESH))
    hkv = MODEL["n_heads"] // GEN_MESH["model"]
    page = 16                          # models/transformer.CACHE_PAGE
    want = [MODEL["n_layers"], GEN_B // GEN_MESH["data"],
            -(-(GEN_PROMPT + GEN_MESH_STEPS) // page) * page, hkv,
            MODEL["d_model"] // MODEL["n_heads"]]
    n = GEN_PROMPT + GEN_MESH_STEPS
    errs = []
    for r in ranks:
        lo, hi = r["rows"]
        finite = bool(np.isfinite(r["logits"]).all())
        err = float(np.abs(r["logits"] - ref["ref_logits"][lo:hi]).max())
        errs.append(err)
        if r["cache_shape"] != want:
            fail("20b/generate_sharded", f"rank {r['rank']} cache "
                                         f"{r['cache_shape']} != {want}")
        if not (finite and err <= LOGITS_ATOL):
            fail("20b/generate_sharded",
                 f"rank {r['rank']} first-step logits vs 20a's rows {err} > "
                 f"{LOGITS_ATOL} (finite {finite})")
        if (r["tokens"] != ranks[0]["tokens"]).any():
            fail("20b/generate_sharded", f"rank {r['rank']}'s tokens differ "
                                         f"from rank 0's")
        if r["paged_decode"] != MODEL["n_layers"] * (GEN_MESH_STEPS - 1):
            fail("20b/generate_sharded", f"rank {r['rank']} paged_decode "
                                         f"launches {r['paged_decode']}")
    r0 = ranks[0]
    agree = greedy_agreement(r0["tokens"][:, GEN_PROMPT:].tolist(),
                             ref["ref_tokens"][:, GEN_PROMPT:n].tolist())
    out = {"backend": r0["backend"], "cache_shape": r0["cache_shape"],
           "logits_err": errs, "agree_20a": agree,
           "tp_all_reduce_calls_per_token": r0["tp_calls"] / GEN_MESH_STEPS,
           "tp_all_reduce_bytes_per_token": r0["tp_bytes"] / GEN_MESH_STEPS,
           "tp_all_reduce_us_per_token": r0["tp_s"] / GEN_MESH_STEPS * 1e6,
           "wall_s": [r["wall_s"] for r in ranks]}
    print(f"generate_sharded {GEN_MESH} over {r0['backend']} [{card}]: cache "
          f"a rank {r0['cache_shape']} ({hkv} of {MODEL['n_heads']} kv "
          f"heads); first-step logits vs 20a's rows {errs} (atol "
          f"{LOGITS_ATOL}); greedy tokens equal to 20a's before the first "
          f"difference, per row {agree} of {GEN_MESH_STEPS}; TP all-reduces "
          f"a token (rank 0, the prefill's included): "
          f"{out['tp_all_reduce_calls_per_token']} calls, "
          f"{out['tp_all_reduce_bytes_per_token']} B, "
          f"{out['tp_all_reduce_us_per_token']} us (timed one by one, the "
          f"device drained around each); wall a rank {out['wall_s']} s")
    return out


def chat_trace(vocab: int, first_wave: list | None = None):
    """Phase 20c's requests, in two waves: two 64-token system prompts,
    each opening four requests (a user part of 8-40 tokens), and two
    follow-ups that repeat the first wave's replies after the system
    prompt. ``first_wave``: the first wave's generated tokens (of the
    reference run), which the follow-ups quote. Returns ``(wave1,
    wave2)``, lists of ``(rid, prompt, max_new, seed)``."""
    import numpy as np

    rng = np.random.default_rng(2020)
    system = [rng.integers(0, vocab, 64).tolist() for _ in range(2)]

    def user():
        return rng.integers(0, vocab, int(rng.integers(8, 41))).tolist()

    wave1 = [("a0", system[0] + user(), 48, 0),
             ("b0", system[1] + user(), 48, 1)]
    wave2 = [("a1", system[0] + user(), 40, 2),
             ("a2", system[0] + user(), 40, 3),
             ("b1", system[1] + user(), 40, 4),
             ("b2", system[1] + user(), 40, 5)]
    if first_wave is not None:
        wave2 += [("a3", system[0] + first_wave[0][:32], 40, 6),
                  ("b3", system[1] + first_wave[1][:32], 40, 7)]
    return wave1, wave2


def run_trace(Engine, ServeConfig, params, cfg, trace, **serve_kw):
    """One engine over both waves of ``trace``; returns ``(engine,
    {rid: request}, {rid: slot}, verify dispatches)``."""
    eng = Engine(params, cfg, ServeConfig(**GEOMETRY, **serve_kw))
    slots: dict = {}
    admit = eng.sched.admit

    def admit_and_note(now):
        got = admit(now)
        slots.update({r.rid: r.slot for r in got})
        return got

    eng.sched.admit = admit_and_note
    verified = [0]
    for w, step in list(eng._verify.items()):
        def counted(*a, _step=step, **kw):
            verified[0] += 1
            return _step(*a, **kw)
        eng._verify[w] = counted
    reqs = {}
    for wave in trace:
        for rid, prompt, gen, seed in wave:
            reqs[rid] = eng.submit(prompt, gen, rid=rid, seed=seed)
        eng.run()
    if not all(r.state.value == "completed" for r in reqs.values()):
        states = [(r.rid, r.state.value, r.error) for r in reqs.values()]
        fail("20c/engine", f"requests not completed: {states}")
    return eng, reqs, slots, verified[0]


def spec_divergences(reqs: dict, ref: dict, ref_slots: dict,
                     gaps: dict) -> list:
    """Where a run's tokens first differ from the reference (spec off) run's,
    per request: ``(rid, index, gap, top)``, the spec-off decode step's
    top-2 logit gap and top logit at that position."""
    out = []
    for rid, r in reqs.items():
        a, b = ref[rid].generated, r.generated
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                out.append((rid, min(len(a), len(b)), None, None))
            continue
        if j == 0:
            out.append((rid, 0, None, None))        # the prefill's token
            continue
        pos = len(ref[rid].prompt) + j - 1
        top, gap = gaps.get((ref_slots[rid], pos, a[j - 1]), (None, None))
        out.append((rid, j, gap, top))
    return out


def spec_rows_check(pa, card) -> dict:
    """The window-row entry: each window row bit for bit the one-token
    launch at its position (W 2, 4, 5; MHA and GQA 4; rows at page and
    split edges and at the table's end, where the last rows clamp), and
    against its plain version (gather, f32) within KERNEL_ATOL; then its
    timing at W 5 beside the plain version, SDPA and the bound."""
    import torch

    page, n, n_pool, dh = 16, 40, GEOMETRY["n_pages"], 128
    span = n * page
    base = [0, 63, 64, 127, 255, 383, 630, 639]

    def case(w, hkv, positions, seed):
        """make_case with every slot a window row reads written (the
        window reaches positions + W - 1, clamped to the table)."""
        reach = [min(p + w - 1, span - 1) for p in positions]
        _, kp, vp, tables, _ = make_case(8, 8, hkv, dh, page, n, n_pool,
                                         reach, seed)
        qw = torch.randn((8, w, 8, dh), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(
                             seed)).to(torch.bfloat16)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        return qw, kp, vp, tables, pos

    max_err, bitwise = 0.0, True
    for ci, hkv in enumerate((8, 2)):
        for w in SPEC_WIDTHS:
            qw, kp, vp, tables, pos = case(w, hkv, base, 30 + ci)
            got = pa.paged_attention_rows_kernel(qw, kp, vp, tables, pos)
            rows = (pos[:, None].long() + torch.arange(w, device="cuda")
                    ).clamp(max=span - 1)
            want = pa.paged_attention_gather(
                qw.float(), kp.float(), vp.float(), tables, rows,
                (pos.long() + w).clamp(max=span)).to(torch.bfloat16)
            for i in range(w):
                one = pa.paged_attention_kernel(
                    qw[:, i:i + 1].contiguous(), kp, vp, tables,
                    rows[:, i].to(torch.int32).contiguous())
                bitwise &= torch.equal(one, got[:, i:i + 1])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            print(f"paged_decode_rows hkv {hkv} W {w}: max_abs_err {err} "
                  f"(atol {KERNEL_ATOL}); every window row == the one-token "
                  f"launch at its position: {bitwise}")
    if not bitwise:
        fail("20c/verify kernel", "a window row differs from the one-token "
                                  "launch at its position")
    if not max_err <= KERNEL_ATOL:
        fail("20c/verify kernel", f"max_abs_err {max_err} > {KERNEL_ATOL}")
    w = SPEC_K + 1
    qw, kp, vp, tables, pos = case(w, 8, [0, span - w, 15, 16, 100, 255, 383,
                                          512], 40)
    rows = pos[:, None].long() + torch.arange(w, device="cuda")
    lengths = pos.long() + w
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: pa.paged_attention_rows_kernel(qw, kp, vp, tables,
                                                        pos), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_attention_gather(
        qw, kp, vp, tables, rows, lengths), flush=flush)
    t_all = n * page
    kr = kp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    vr = vp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    kr, vr = kr.contiguous(), vr.contiguous()
    qh = qw.transpose(1, 2).contiguous()                    # [B, H, W, Dh]
    mask = (torch.arange(t_all, device="cuda")[None, None, :]
            <= rows[:, :, None])[:, None]                   # [B,1,W,T]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kr, vr, attn_mask=mask),
                         flush=flush)
    tokens_read = sum(int(p) + w for p in pos.tolist())    # K/V once a row
    pairs = sum(int(p) + i + 1 for p in pos.tolist() for i in range(w))
    elt = 2
    bytes_moved = (2 * tokens_read * 8 * dh * elt + 2 * qw.numel() * elt
                   + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * pairs * 8 * dh
    bound_ms, bound_by = max((bytes_moved / card_peak('hbm') * 1e3, "bytes"),
                             (flops / F32_FLOPS_PER_S * 1e3, "operations"))
    print(f"paged_decode_rows timing W {w} [{card}]: kernel {ms} ms, plain "
          f"{plain_ms} ms, sdpa {library_ms} ms, bound {bound_ms} ms "
          f"({bound_by}: {bytes_moved} B, {flops} flop); {bound_ms / ms:.1%} "
          f"of bound")
    del flush, kr, vr
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def spec_phase(card) -> dict:
    """Phase 20c: the engine with the prefix cache and speculative decoding
    at phase 5's model and geometry on the chat trace. Four runs — (cache,
    spec) off/off, on/off, on/on, off/on — after a recording run of
    off/off that keeps every decode step's top-2 logits. Gates: cache on
    == off bit for bit; spec on == off in tokens, except at a near-tie of
    the spec-off step (SPEC_TIE_RTOL); exact page accounting after the
    drain; the window-row entry (``spec_rows_check``); each kernel's
    launches == n_layers x its dispatches."""
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )
    from distributed_model_parallel_tpu_torch.serve import model as smodel

    rows = spec_rows_check(pa, card)
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    wave1, _ = chat_trace(cfg.vocab_size)
    warm = Engine(params, cfg, ServeConfig(**GEOMETRY, spec_k=SPEC_K))
    warm.submit(wave1[0][1], 8)
    warm.run()
    # The recording run: every decode step's top-2 logits by (slot,
    # position, input token).
    decode_logits = smodel.decode_logits
    gaps: dict = {}

    def recording(params, ck, cv, tokens, positions, tables, active, cfg,
                  **kw):
        logits = decode_logits(params, ck, cv, tokens, positions, tables,
                               active, cfg, **kw)
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        for b in range(len(active)):
            if active[b]:
                gaps[(b, int(positions[b]), int(tokens[b]))] = (
                    float(top[b, 0]), float(top[b, 0] - top[b, 1]))
        return logits

    smodel.decode_logits = recording
    try:
        first, _ = chat_trace(cfg.vocab_size)
        _, reqs, _, _ = run_trace(Engine, ServeConfig, params, cfg, [first])
        trace = chat_trace(cfg.vocab_size,
                           [reqs[r[0]].generated for r in first])
        gaps.clear()
        _, rec, rec_slots, _ = run_trace(Engine, ServeConfig, params, cfg,
                                         trace)
    finally:
        smodel.decode_logits = decode_logits
    runs, out = {}, {"runs": {}}
    launches = {"paged_decode": 0, "paged_decode_rows": 0}
    for name, kw in (("off_off", {}), ("on_off", dict(prefix_cache=True)),
                     ("on_on", dict(prefix_cache=True, spec_k=SPEC_K)),
                     ("off_on", dict(spec_k=SPEC_K))):
        pa.paged_attention_kernel.launches = 0
        pa.paged_attention_rows_kernel.launches = 0
        eng, reqs, slots, verified = run_trace(Engine, ServeConfig, params,
                                               cfg, trace, **kw)
        torch.cuda.synchronize()
        s = eng.summary()
        n_paged = pa.paged_attention_kernel.launches
        n_rows = pa.paged_attention_rows_kernel.launches
        want = (cfg.n_layers * (s["decode_steps"] - verified),
                cfg.n_layers * verified)
        if (n_paged, n_rows) != want:
            fail("20c/engine", f"{name}: launches paged_decode {n_paged}, "
                               f"rows {n_rows} != {want}")
        if kw.get("spec_k"):
            launches["paged_decode"] += n_paged
            launches["paged_decode_rows"] += n_rows
        used = eng.cache.pool.used_pages
        held = len(eng.cache.prefix) if eng.cache.prefix is not None else 0
        if used != held or eng.cache.shared_pages:
            fail("20c/engine", f"{name}: {used} pages held after the drain, "
                               f"the tree holds {held}")
        freed = eng.clear_cache()
        runs[name] = reqs
        out["runs"][name] = {
            "tokens_per_s": s["tokens_per_s"],
            "cache_hit_rate": s["cache_hit_rate"],
            "draft_accept_rate": s["draft_accept_rate"],
            "draft_tokens_proposed": s["draft_tokens_proposed"],
            "decode_rounds": s["decode_steps"], "verify_rounds": verified,
            "tokens": s["tokens_generated"], "tree_pages_freed": freed,
            "launches": {"paged_decode": n_paged, "paged_decode_rows": n_rows}}
        print(f"engine 20c {name} [{card}]: tokens/s {s['tokens_per_s']}, "
              f"cache_hit_rate {s['cache_hit_rate']}, draft_accept_rate "
              f"{s['draft_accept_rate']} ({s['draft_tokens_accepted']} of "
              f"{s['draft_tokens_proposed']}), {s['decode_steps']} decode "
              f"rounds ({verified} verify), launches paged_decode {n_paged}, "
              f"paged_decode_rows {n_rows}; pages after the drain: {used} "
              f"(the tree's {held}), all free after clear_cache")
    for name, reqs in runs.items():
        same_as_rec = all(reqs[r].generated == rec[r].generated
                          for r in reqs)
        if name == "off_off" and not same_as_rec:
            fail("20c/engine", "the recording run decoded other tokens")
    if any(runs["on_off"][r].generated != runs["off_off"][r].generated
           for r in runs["off_off"]):
        fail("20c/engine", "prefix cache on != off")
    print("engine 20c: prefix cache on == off, tokens bit for bit "
          f"({sum(len(r.generated) for r in runs['on_off'].values())} "
          f"tokens)")
    out["divergences"] = {}
    for name in ("on_on", "off_on"):
        div = spec_divergences(runs[name], rec, rec_slots, gaps)
        out["divergences"][name] = div
        for rid, j, gap, top in div:
            ok = gap is not None and gap < SPEC_TIE_RTOL * abs(top)
            print(f"engine 20c {name}: {rid} differs from spec off at token "
                  f"{j}: spec-off top-2 gap {gap}, top logit {top} (near-tie "
                  f"bound {None if top is None else SPEC_TIE_RTOL * abs(top)}"
                  f"): {'a near-tie' if ok else 'NOT a near-tie'}")
            if not ok:
                fail("20c/engine", f"{name}: {rid} diverges at token {j} "
                                   f"without a near-tie (gap {gap})")
        print(f"engine 20c {name}: spec on == off in tokens except "
              f"{len(div)} near-tie divergence(s)")
    if not launches["paged_decode_rows"]:
        fail("20c/engine", "the verify step never ran")
    out["rows_kernel"] = rows
    out["launches"] = launches
    del params
    torch.cuda.empty_cache()
    return out


def gen_phases(laps, mesh, card, backend: str,
               sharded_ranks: list | None = None) -> dict:
    """Phase 20: 20a ``generate``, 20b ``generate_sharded`` (its ranks'
    results ``sharded_ranks`` when 19b's spawn ran them), 20c the engine's
    prefix cache and speculative decoding."""
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        flash_attention as fa,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )

    gen = generate_phase(tfm, pa, fa, card)
    laps.done("20a/generate")
    sharded = gen_sharded(mesh, gen, card, backend, sharded_ranks)
    laps.done("20b/generate_sharded")
    spec = spec_phase(card)
    laps.done("20c/prefix cache, spec")
    gen.pop("ref_logits")
    gen.pop("ref_tokens")
    return {"generate": gen, "generate_sharded": sharded, "engine": spec}


def decode_kernel_rows(paged: dict, dec: dict, planes: dict,
                       fleet: dict) -> list:
    """The ``kernels`` line's rows of row 1 of the kernel table: the
    paged-decode kernel (launches of phase 5's engine; 20a's generate,
    20c's spec-on runs, 21a's capacity and overload runs and phase 22's
    fleet passes beside them) and its window-row entry (launches of 20c's
    spec-on runs)."""
    src = "distributed_model_parallel_tpu_torch/ops/csrc/paged_decode.cu"
    tpu = "distributed_model_parallel_tpu/ops/paged_attention.py:115"
    spec = dec["engine"]
    return [
        {"name": "paged_decode", "route": "cuda", "source": src,
         "replaces": tpu, **paged,
         "launches_20a_generate": dec["generate"]["launches"][
             "paged_decode"],
         "launches_20c_spec": spec["launches"]["paged_decode"],
         "launches_21a_overload": planes["overload"]["launches"],
         "launches_22_fleet": fleet["launches"]},
        {"name": "paged_decode_rows", "route": "cuda", "source": src,
         "replaces": tpu,
         "launches": spec["launches"]["paged_decode_rows"],
         **spec["rows_kernel"]},
    ]


def serve_phases(laps, card) -> dict:
    """Phases 3-5: the paged-decode kernel against its plain version, its
    timing, and the engine at full width. Returns the kernel's numbers
    (the ``kernels`` line's ``paged_decode`` row)."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )
    from distributed_model_parallel_tpu_torch.serve.model import (
        decode_logits,
        prefill_logits,
    )
    from distributed_model_parallel_tpu_torch.serve.paged_kv import (
        PagedKVCache,
    )

    # -- phase 3: kernel vs plain ---------------------------------------------
    page, n, n_pool, dh = 16, 40, GEOMETRY["n_pages"], 128
    spread = [0, 639, 15, 16, 100, 255, 383, 512]
    # On page (16 tokens) and split (4 pages) edges, and the longest row.
    edges = [63, 64, 127, 128, 0, 639, 255, 256]
    cases = {
        "mha": dict(b=8, h=8, hkv=8, window=None, positions=spread),
        "gqa": dict(b=8, h=8, hkv=2, window=None, positions=spread),
        "window64": dict(b=8, h=8, hkv=8, window=64, positions=spread),
        "edges": dict(b=8, h=8, hkv=8, window=None, positions=edges),
        "window64_edges": dict(b=8, h=8, hkv=8, window=64, positions=edges),
        "window100": dict(b=8, h=8, hkv=8, window=100, positions=spread),
        "gqa_g8_edges": dict(b=8, h=8, hkv=1, window=None, positions=edges),
        "long_row_b1": dict(b=1, h=8, hkv=8, window=None, positions=[639]),
    }
    max_err = 0.0
    for i, (label, c) in enumerate(cases.items()):
        q, kp, vp, tables, pos = make_case(c["b"], c["h"], c["hkv"], dh, page,
                                           n, n_pool, c["positions"], seed=i)
        got = pa.paged_attention_kernel(q, kp, vp, tables, pos,
                                        window=c["window"])
        want = pa.paged_attention_gather(
            q.float(), kp.float(), vp.float(), tables, pos[:, None],
            pos + 1, c["window"]).to(torch.bfloat16)
        # A row's output must not depend on the batch: each row alone (B 1)
        # equals its row of the batched call, bit for bit.
        alone = [pa.paged_attention_kernel(q[r:r + 1], kp, vp,
                                           tables[r:r + 1], pos[r:r + 1],
                                           window=c["window"])
                 for r in range(c["b"])]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail("3/kernel", f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        bitwise = all(torch.equal(x, got[r:r + 1])
                      for r, x in enumerate(alone))
        print(f"paged_decode {label}: max_abs_err {err} (atol {KERNEL_ATOL});"
              f" each row alone == its row in the batch: {bitwise}")
        if not err <= KERNEL_ATOL:
            fail("3/kernel", f"{label}: max_abs_err {err} > {KERNEL_ATOL}")
        if not bitwise:
            fail("3/kernel", f"{label}: a row's output depends on the batch")
        max_err = max(max_err, err)

    laps.done("3/kernel")

    # -- phase 4: timing ------------------------------------------------------
    q, kp, vp, tables, pos = make_case(8, 8, 8, dh, page, n, n_pool, spread,
                                       seed=0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: pa.paged_attention_kernel(q, kp, vp, tables, pos),
                 flush=flush)
    r = spread.index(max(spread))                            # pos 639 alone
    ms_b1 = time_ms(lambda: pa.paged_attention_kernel(
        q[r:r + 1], kp, vp, tables[r:r + 1], pos[r:r + 1]), flush=flush)
    plain_ms = time_ms(lambda: pa.paged_attention_gather(
        q, kp, vp, tables, pos[:, None], pos + 1), flush=flush)
    t_all = n * page
    kr = kp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    vr = vp[tables.long()].reshape(8, t_all, 8, dh).transpose(1, 2)
    kr, vr = kr.contiguous(), vr.contiguous()
    qh = q.transpose(1, 2).contiguous()                      # [B, H, 1, Dh]
    mask = (torch.arange(t_all, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]               # [B,1,1,T]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kr, vr, attn_mask=mask), flush=flush)
    tokens_read = sum(p + 1 for p in spread)
    elt = 2                                                  # bf16 bytes
    bytes_moved = (2 * tokens_read * 8 * dh * elt            # K and V read
                   + 2 * q.numel() * elt                     # q in, out
                   + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * tokens_read * 8 * dh                         # q.k and p.v
    bytes_ms = bytes_moved / card_peak('hbm') * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"paged_decode timing [{card}]: kernel {ms} ms (split + merge), "
          f"plain {plain_ms} ms, sdpa {library_ms} ms, bound {bound_ms} ms "
          f"({bound_by}: {bytes_moved} B, {flops} flop); ms / library_ms "
          f"{ms / library_ms:.3f}, {bound_ms / ms:.1%} of bound; the longest "
          f"row alone (B 1, pos {spread[r]}) {ms_b1} ms")
    del flush, kr, vr
    laps.done("4/timing")

    # -- phase 5: engine at full width ----------------------------------------
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    serve = ServeConfig(policy="continuous", **GEOMETRY)
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 97)))
               .tolist() for _ in range(8)]
    gens = [int(g) for g in rng.integers(16, 65, 8)]

    warm = Engine(params, cfg, serve)                 # cuBLAS/allocator warm-up
    warm.submit(prompts[0][:16], 4)
    warm.run()
    del warm

    eng = Engine(params, cfg, serve)
    reqs = [eng.submit(p, g, seed=i) for i, (p, g) in
            enumerate(zip(prompts, gens))]
    pa.paged_attention_kernel.launches = 0
    summary = eng.run()
    launches = pa.paged_attention_kernel.launches
    torch.cuda.synchronize()
    if not all(r.state.value == "completed" for r in reqs):
        fail("5/engine", f"requests not completed: "
                         f"{[(r.rid, r.state.value, r.error) for r in reqs]}")
    if [len(r.generated) for r in reqs] != gens:
        fail("5/engine", "a request generated the wrong number of tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in reqs for t in r.generated):
        fail("5/engine", "a generated token is outside the vocabulary")
    want_launches = cfg.n_layers * summary["decode_steps"]
    print(f"engine: {summary['requests_completed']} requests, "
          f"{summary['decode_steps']} decode steps, paged_decode launches "
          f"{launches} (want n_layers x decode steps = {want_launches})")
    if launches != want_launches:
        fail("5/engine", f"kernel launches {launches} != {want_launches}")

    solo_idx = 3
    solo = Engine(params, cfg, serve)
    sr = solo.submit(prompts[solo_idx], gens[solo_idx], seed=solo_idx)
    solo.run()
    if sr.generated != reqs[solo_idx].generated:
        fail("5/engine", "request tokens depend on batch composition: "
                         f"solo {sr.generated} vs batch "
                         f"{reqs[solo_idx].generated}")
    print(f"engine: request {solo_idx} solo == in batch "
          f"({len(sr.generated)} tokens, bitwise)")

    # First decode step of all 8 requests, kernel vs plain attention.
    cache = PagedKVCache(cfg, n_pages=serve.n_pages,
                         page_size=serve.page_size,
                         max_seq_len=serve.max_seq_len, device="cuda")
    geo = dict(page_size=serve.page_size, n_pages=serve.n_pages,
               device=torch.device("cuda"))
    tables_np = np.zeros((8, cache.pages_per_seq), np.int32)
    first, positions = [], []
    for i, (p, g) in enumerate(zip(prompts, gens)):
        cache.try_admit(i, p, len(p) + g)
        tables_np[i] = cache.table_array(i)
        c = serve.prefill_chunk
        for lo in range(0, len(p), c):
            chunk = np.zeros((1, c), np.int64)
            nv = min(c, len(p) - lo)
            chunk[0, :nv] = p[lo:lo + nv]
            logits = prefill_logits(params, cache.ck, cache.cv, chunk, lo,
                                    nv, tables_np[i], cfg, impl="kernel",
                                    **geo)
        first.append(int(logits.argmax(-1)[0]))
        positions.append(len(p))
    active = np.ones(8, bool)
    ck2, cv2 = cache.ck.clone(), cache.cv.clone()
    lk = decode_logits(params, cache.ck, cache.cv, first, positions,
                       tables_np, active, cfg, impl="kernel", **geo)
    lp = decode_logits(params, ck2, cv2, first, positions, tables_np,
                       active, cfg, impl="plain", **geo)
    torch.cuda.synchronize()
    if [r.generated[0] for r in reqs] != first:
        fail("5/engine", "the engine's first tokens differ from the model "
                         "steps' own prefill")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("5/engine", "non-finite decode logits")
    lerr = (lk.float() - lp.float()).abs().max().item()
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"engine: first decode step logits kernel vs plain max_abs_err "
          f"{lerr} (atol {LOGITS_ATOL}; |logits| max "
          f"{lp.float().abs().max().item()}), argmax agreement {agree}")
    if not lerr <= LOGITS_ATOL:
        fail("5/engine", f"logits max_abs_err {lerr} > {LOGITS_ATOL}")

    print(f"engine [{card}]: tokens/s {summary['tokens_per_s']}, "
          f"TTFT p50 {summary['ttft_s']['p50']} s p99 "
          f"{summary['ttft_s']['p99']} s, per-token latency p50 "
          f"{summary['token_latency_s']['p50']} s, "
          f"{summary['tokens_generated']} tokens in {summary['wall_s']} s")
    laps.done("5a/engine")
    profile_engine(Engine, params, cfg, serve, prompts, gens, card)
    del params, cache, ck2, cv2, lk, lp, eng, solo
    torch.cuda.empty_cache()
    laps.done("5b/engine profile")
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, ms_b1_long_row=ms_b1)


def serve_trace(vocab: int) -> list:
    """bench.py's ``build_serve_trace`` at its defaults (``OVL_TRACE``):
    Poisson arrivals, prompts uniform in the range, generation lengths
    exponential with mean a quarter of the range, clipped; the draws in
    bench.py's order from one seeded generator."""
    import numpy as np

    c = OVL_TRACE
    rng = np.random.default_rng(c["seed"])
    (p_lo, p_hi), (g_lo, g_hi) = c["prompt"], c["gen"]
    t, trace = 0.0, []
    for i in range(c["n"]):
        t += float(rng.exponential(1.0 / c["rate"]))
        prompt = [int(x) for x in
                  rng.integers(0, vocab, rng.integers(p_lo, p_hi + 1))]
        gen = int(min(g_hi, g_lo + rng.exponential((g_hi - g_lo) / 4)))
        trace.append(dict(arrival_s=t, prompt=prompt, max_new_tokens=gen,
                          seed=i))
    return trace


class PlainDecodeCount:
    """Counts, while active, the paged attention's plain version called
    on one-token CUDA queries — the decode kernel's plain path, which the
    engine must never take on the card."""

    def __enter__(self):
        from distributed_model_parallel_tpu_torch.ops import (
            paged_attention as pa,
        )
        from distributed_model_parallel_tpu_torch.serve import (
            model as smodel,
        )

        self.n = 0
        self._mods = (pa, smodel)
        orig = pa.paged_attention_gather
        self._orig = orig

        def counting(q, *args, **kw):
            if q.is_cuda and q.shape[1] == 1:
                self.n += 1
            return orig(q, *args, **kw)

        for m in self._mods:
            m.paged_attention_gather = counting
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.paged_attention_gather = self._orig
        return False


def device_busy(run) -> dict:
    """``run()`` under ``torch.profiler`` (CUDA activity only): the
    kernels' device time over the run's wall (one stream, so kernel times
    add). ``{"busy_share": None}`` when the profile holds no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_time_total > 0
                  and e.device_type.name == "CUDA")
    return {"wall_us": wall_us, "busy_us": busy_us,
            "busy_share": busy_us / wall_us if busy_us else None}


def scrape_statusz(url: str, provider: str) -> dict:
    """One GET of /healthz, /statusz and /metrics on the local exporter:
    status codes, the provider's payload, the metrics text's size."""
    import urllib.request

    out = {}
    for path in ("/healthz", "/statusz", "/metrics"):
        with urllib.request.urlopen(url + path, timeout=10) as resp:
            body = resp.read().decode("utf-8")
            out[path] = resp.status
        if path == "/statusz":
            out["provider"] = json.loads(body)["providers"].get(provider)
        if path == "/metrics":
            out["metrics_lines"] = len(body.splitlines())
            out["ttft_series"] = "serve_ttft_s_count" in body
    return out


def overload_drill(laps, card) -> dict:
    """Phase 21a (and 21d inside it): bench.py's ``bench_serve_overload``
    on the port. A closed-loop capacity run of the trace, then the same
    population open-loop at each of OVL_FACTORS x capacity (a 0.3x tail
    after 3/4 of it) through an engine with every overload control armed.
    Gates (bench.py:1250-1272 and the planes'), each run: typed sheds
    account for every request that did not complete, no failure; the
    arrived backlog within ``max_queue`` at every iteration; completed
    tokens == the capacity run's (a clamped request's: a prefix);
    brownout ends at level 0, and fires at OVL_GATED_FACTOR; the paged
    kernel launched n_layers x decode rounds, never the plain path;
    warmup loaded and launched the kernel first. On the stream of all the
    runs: the metering gate and the trace joiner. 21d scrapes the
    exporter once, mid-way through the first overload run."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        capacity as capacity_mod,
    )
    from distributed_model_parallel_tpu_torch.utils import statusz
    from distributed_model_parallel_tpu_torch.utils import (
        telemetry as tel_mod,
    )

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **OVL_MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    trace = serve_trace(cfg.vocab_size)
    base = dict(OVL_GEOMETRY)
    tel = tel_mod.TelemetryRun(
        os.path.join(os.environ[RUN_DIR_ENV], "serve21.jsonl"),
        run="serve21", meta=dict(trace="overload", n_requests=len(trace),
                                 overload_factors=list(OVL_FACTORS)))
    server = statusz.maybe_serve(0)

    def warm(eng, label):
        from distributed_model_parallel_tpu_torch.ops import _build

        pa.paged_attention_kernel.launches = 0
        eng.warmup()
        torch.cuda.synchronize()
        if "paged_decode" not in _build._libs or \
                pa.paged_attention_kernel.launches != cfg.n_layers:
            fail("21a/overload", f"{label}: warmup did not load and launch "
                                 f"the paged kernel ({sorted(_build._libs)}, "
                                 f"{pa.paged_attention_kernel.launches} "
                                 f"launches)")
        pa.paged_attention_kernel.launches = 0
        pa.paged_attention_rows_kernel.launches = 0

    def gated_run(eng, label):
        with PlainDecodeCount() as plain:
            s = eng.run()
        torch.cuda.synchronize()
        want = cfg.n_layers * s["decode_steps"]
        got = pa.paged_attention_kernel.launches
        if got != want or plain.n or pa.paged_attention_rows_kernel.launches:
            fail("21a/overload", f"{label}: paged_decode launches {got} != "
                                 f"{want} (n_layers x decode rounds), plain "
                                 f"decode calls {plain.n}")
        return s, got

    # -- capacity: closed loop, nothing sheds
    cap_eng = Engine(params, cfg, ServeConfig(**base), telemetry=tel)
    warm(cap_eng, "capacity")
    for i, r in enumerate(trace):
        cap_eng.submit(r["prompt"], r["max_new_tokens"], rid=f"o{i}",
                       seed=r["seed"])
    cap, launches = gated_run(cap_eng, "capacity")
    capacity = cap["tokens_per_s"]
    wall_a = max(cap["wall_s"], 1e-3)
    reference = {q.rid: list(q.generated) for q in cap_eng.results()}
    if cap["requests_completed"] != len(trace):
        fail("21a/overload", f"capacity run completed "
                             f"{cap['requests_completed']} of {len(trace)}")
    print(f"overload 21a capacity [{card}]: {cap['tokens_generated']} tokens "
          f"in {cap['wall_s']} s, {capacity} tokens/s, "
          f"{cap['decode_steps']} decode rounds, TTFT p99 "
          f"{cap['ttft_s'].get('p99')} s")
    n_over = max(1, int(len(trace) * 0.75))
    mean_tokens = sum(len(v) for v in reference.values()) / len(reference)
    serve = ServeConfig(
        **base, queue_budget_s=max(0.15 * wall_a, 0.05),
        deadline_s=max(1.2 * wall_a, 0.4), max_queue=2 * base["n_slots"],
        brownout=True, brownout_ttft_target_s=max(0.08 * wall_a, 0.02),
        brownout_budget=0.25, brownout_window_s=max(0.10 * wall_a, 0.06),
        brownout_max_new=max(8, int(mean_tokens / 2)),
        brownout_hold_iters=4)
    out = {"capacity_tokens_per_s": capacity, "capacity_wall_s": cap["wall_s"],
           "capacity_ttft_p99_s": cap["ttft_s"].get("p99"),
           "queue_budget_s": serve.queue_budget_s,
           "deadline_s": serve.deadline_s, "max_queue": serve.max_queue,
           "ttft_target_s": serve.brownout_ttft_target_s,
           "goodput_band": OVL_BAND, "gated_factor": OVL_GATED_FACTOR}
    scrape: dict = {}
    for factor in OVL_FACTORS:
        # The same population at factor x capacity, then a cool-down.
        rng = np.random.default_rng(OVL_TRACE["seed"] + 1)
        t, arrivals = 0.0, []
        for i in range(len(trace)):
            rate = (factor if i < n_over else 0.3) * capacity / mean_tokens
            t += float(rng.exponential(1.0 / rate))
            arrivals.append(t)
        eng = Engine(params, cfg, serve, telemetry=tel)
        warm(eng, f"{factor}x")
        state = {"bounded": True, "max_backlog": 0}

        def hook(it, eng=eng, state=state):
            # eng._now is the previous iteration's clock, at which that
            # iteration's overflow trim ran: its arrived backlog is
            # within the bound.
            backlog = eng.sched.arrived_backlog(eng._now)
            state["max_backlog"] = max(state["max_backlog"], backlog)
            state["bounded"] &= backlog <= serve.max_queue
            if not scrape and it >= 50:
                scrape.update(scrape_statusz(server.url, eng._provider),
                              keys=set(eng._status()))

        eng.step_hook = hook
        for i, (r, arr) in enumerate(zip(trace, arrivals)):
            eng.submit(r["prompt"], r["max_new_tokens"], rid=f"o{i}",
                       seed=r["seed"], arrival_s=arr,
                       priority="batch" if i % 3 == 2 else "interactive")
        over, n = gated_run(eng, f"{factor}x")
        launches += n
        results = {q.rid: q for q in eng.results()}
        phase1 = [results[f"o{i}"] for i in range(n_over)]
        t_end = max((q.t_done for q in phase1 if q.t_done is not None),
                    default=None)
        completed = [q for q in results.values()
                     if q.state.value == "completed"]
        goodput = (sum(len(q.generated) for q in completed
                       if eng._in_deadline(q) and q.t_done <= t_end) / t_end
                   if t_end else 0.0)
        bo = over["brownout"] or {}
        ttfts = [eng._ttft(q) for q in completed]
        run = {
            "goodput_tokens_per_s": goodput,
            "goodput_fraction": goodput / capacity if capacity else None,
            "goodput_band_met": bool(capacity
                                     and goodput >= OVL_BAND * capacity),
            "shed_fraction": over["requests_shed"] / len(trace),
            "requests_completed": over["requests_completed"],
            "requests_shed": over["requests_shed"],
            "requests_rejected": over["requests_rejected"],
            "requests_failed": over["requests_failed"],
            "shed_by_reason": over["shed_by_reason"],
            "brownout_max_level": bo.get("max_level_seen"),
            "brownout_final_level": bo.get("level"),
            "brownout_transitions": bo.get("transitions"),
            "ttft_p50_s": over["ttft_s"].get("p50"),
            "ttft_p99_s": over["ttft_s"].get("p99"),
            "ttft_over_target": sum(x > serve.brownout_ttft_target_s
                                    for x in ttfts),
            "iteration_s_p50": over["iteration_s"].get("p50"),
            "arrivals_end_s": [arrivals[n_over - 1], arrivals[-1]],
            "max_arrived_backlog": state["max_backlog"],
            "wall_s": over["wall_s"], "decode_rounds": over["decode_steps"],
            "meter_write_s": eng.meter.write_s,   # metering's own host time
        }
        out[f"x{factor:g}"] = run
        print(f"overload 21a {factor:g}x [{card}]: goodput {goodput} "
              f"tokens/s, goodput fraction {run['goodput_fraction']} (band "
              f"{OVL_BAND}: met {run['goodput_band_met']}), shed_fraction "
              f"{run['shed_fraction']}, shed_by_reason "
              f"{over['shed_by_reason']}, brownout max level "
              f"{bo.get('max_level_seen')} over {bo.get('transitions')} "
              f"transitions (final {bo.get('level')}), TTFT p50 / p99 "
              f"{run['ttft_p50_s']} / {run['ttft_p99_s']} s "
              f"({run['ttft_over_target']} of {len(ttfts)} over the "
              f"{serve.brownout_ttft_target_s} s target), iteration p50 "
              f"{run['iteration_s_p50']} s (capacity run "
              f"{cap['iteration_s'].get('p50')}), max arrived backlog "
              f"{state['max_backlog']} of {serve.max_queue}, "
              f"{over['decode_steps']} decode rounds in {over['wall_s']} s")
        shed = {q.rid for q in results.values() if q.shed_reason}
        unaccounted = [q.rid for q in results.values()
                       if q.state.value != "completed" and q.rid not in shed]
        if unaccounted or over["requests_failed"]:
            fail("21a/overload", f"{factor}x: requests without a typed shed "
                                 f"{unaccounted}, failed "
                                 f"{over['requests_failed']}")
        if not state["bounded"]:
            fail("21a/overload", f"{factor}x: arrived backlog "
                                 f"{state['max_backlog']} > max_queue")
        for q in completed:
            ref = reference[q.rid]
            if q.generated != ref[:len(q.generated)] or (
                    q.max_new_requested is None and q.generated != ref):
                fail("21a/overload", f"{factor}x: {q.rid} decoded other "
                                     f"tokens than the capacity run")
        if bo.get("level") or (factor == OVL_GATED_FACTOR
                               and not bo.get("max_level_seen")):
            fail("21a/overload", f"{factor}x: brownout did not fire and "
                                 f"resolve: {bo}")
    tel.finish()
    statusz.shutdown()
    records = tel_mod.read_records(tel.path)
    shed_recs = {r["request"] for r in records if r.get("kind") == "shed"}
    n_shed = sum(out[f"x{f:g}"]["requests_shed"] for f in OVL_FACTORS)
    violations = capacity_mod.check_invariants(records)
    traces = tel_mod.join_request_traces(records)
    orphans = [(tl["request"], tl["orphan_reasons"])
               for tl in traces.values() if tl["orphan"]]
    n_runs = 1 + len(OVL_FACTORS)
    if (violations or orphans or len(traces) != n_runs * len(trace)
            or len([r for r in records if r.get("kind") == "shed"])
            != n_shed):
        fail("21a/overload", f"metering gate {violations[:5]}; "
                             f"{len(traces)} traces for {n_runs} x "
                             f"{len(trace)} requests, orphans {orphans[:5]}; "
                             f"{len(shed_recs)} shed records for {n_shed}")
    print(f"overload 21a: every request completed or shed typed (a shed "
          f"record each), backlogs bounded, tokens == the capacity run's, "
          f"brownout resolved (fired at {OVL_GATED_FACTOR:g}x); metering "
          f"gate and trace joiner clean over {len(records)} records "
          f"({len(traces)} traces); paged_decode launches {launches} == "
          f"n_layers x decode rounds, no plain path")
    if (any(scrape.get(p) != 200 for p in ("/healthz", "/statusz",
                                           "/metrics"))
            or set(scrape.get("provider") or ()) != scrape.get("keys")
            or not scrape.get("ttft_series")):
        fail("21d/statusz", f"scrape during 21a: {scrape}")
    prov = scrape["provider"]
    print(f"statusz 21d: /healthz /statusz /metrics 200 mid-run; provider "
          f"serve-continuous: queue_depth {prov['queue_depth']}, "
          f"page_occupancy {prov['page_occupancy']}, brownout_level "
          f"{prov['brownout_level']}, requests_shed {prov['requests_shed']}; "
          f"{scrape['metrics_lines']} metrics lines")
    # Device busy share: the capacity engine's first OVL_PROFILE_ITERS
    # iterations under the profiler.
    prof_eng = Engine(params, cfg, ServeConfig(**base), slo_metrics=False)
    for i, r in enumerate(trace[:base["n_slots"]]):
        prof_eng.submit(r["prompt"], r["max_new_tokens"], rid=f"p{i}",
                        seed=r["seed"])
    busy = device_busy(lambda: prof_eng.run(
        max_iterations=OVL_PROFILE_ITERS, record_summary=False))
    print(f"overload 21a [{card}]: device busy {busy['busy_share']} of the "
          f"wall over {OVL_PROFILE_ITERS} profiled capacity iterations")
    out.update(launches=launches, records=len(records),
               statusz={p: scrape[p] for p in ("/healthz", "/statusz",
                                               "/metrics")},
               device_busy_share=busy["busy_share"],
               device_busy_iterations=OVL_PROFILE_ITERS)
    del params
    torch.cuda.empty_cache()
    laps.done("21a,d/overload drill, statusz")
    return out


def journal_drill(laps, card) -> dict:
    """Phase 21b: the write-ahead journal on the card. At 21a's widths
    with spec_k JRN_SPEC_K: an uninterrupted run is the reference; a
    journaled run is stopped half-way through the reference's iterations
    and ``kill()``-ed (no drain, no terminal); ``ServeFleet.recover``
    re-admits every pending intent of the journal on a one-replica fleet,
    at its watermark. Gates, in f32: no accepted request lost, one terminal an
    intent, every token == the reference's, the kernels' launches ==
    n_layers x rounds. Then the same in bf16, each replay on an engine of
    its own so that an assertion trip is counted per request with the
    top-2 gap of its re-sampled logits (reported, not gated)."""
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        EngineKilled,
        ServeConfig,
        ServeFleet,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        journal as journal_mod,
    )

    trace = serve_trace(OVL_MODEL["vocab_size"])[:JRN_REQS]
    serve = ServeConfig(**OVL_GEOMETRY, spec_k=JRN_SPEC_K)
    run_dir = os.environ[RUN_DIR_ENV]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype is torch.float32 else "bf16"
        cfg = tfm.TransformerConfig(dtype=dtype, **OVL_MODEL)
        params = tfm.init_params(cfg, seed=0, device="cuda")

        def submit(eng, journal=None):
            reqs = []
            for i, r in enumerate(trace):
                req = eng.submit(r["prompt"], r["max_new_tokens"],
                                 rid=f"j{i}", seed=r["seed"])
                if journal is not None:
                    journal.intent(req)
                reqs.append(req)
            return reqs

        ref_eng = Engine(params, cfg, serve)
        ref_eng.warmup()
        submit(ref_eng)
        pa.paged_attention_kernel.launches = 0
        pa.paged_attention_rows_kernel.launches = 0
        ref = ref_eng.run()
        torch.cuda.synchronize()
        n_launch = (pa.paged_attention_kernel.launches
                    + pa.paged_attention_rows_kernel.launches)
        if n_launch != cfg.n_layers * ref["decode_steps"]:
            fail("21b/journal", f"{tag}: launches {n_launch} != n_layers x "
                                f"{ref['decode_steps']} rounds")
        want = {q.rid: list(q.generated) for q in ref_eng.results()}
        kill_at = ref["iterations"] // 2
        path = os.path.join(run_dir, f"journal21-{tag}.jsonl")
        j = journal_mod.RequestJournal(path)
        killed = Engine(params, cfg, serve, journal=j)
        submit(killed, j)
        killed.run(max_iterations=kill_at)
        killed.kill()
        done_before = {q.rid for q in killed.results() if q.done}
        st = journal_mod.fold(path)
        # The restart: ServeFleet.recover rebuilds a request per pending
        # intent at its journaled watermark, on one replica.
        restart = ServeFleet.recover(
            params, cfg, serve, 1, journal=journal_mod.RequestJournal(path),
            devices=fleet_devices(1))
        lost = restart.results()
        n_replay = sum(q.replay for q in lost)
        if set(st.terminals) != done_before or not n_replay:
            fail("21b/journal", f"{tag}: journal terminals "
                                f"{len(st.terminals)} vs {len(done_before)} "
                                f"done; {n_replay} replays")
        del killed
        if dtype is torch.float32:
            pa.paged_attention_kernel.launches = 0
            pa.paged_attention_rows_kernel.launches = 0
            try:
                restart.run()
            except EngineKilled as e:
                fail("21b/journal", f"f32 replay died: {e.__cause__}")
            torch.cuda.synchronize()
            n_launch = (pa.paged_attention_kernel.launches
                        + pa.paged_attention_rows_kernel.launches)
            rounds = restart.replicas[0].engine._decode_steps
            restart.close()
            restart.journal.close()
            final = journal_mod.fold(path)
            terms = terminal_counts(path)
            got = {q.rid: q.generated for q in lost}
            mism = [rid for rid, toks in got.items() if toks != want[rid]]
            if (final.pending() or set(final.intents) != set(want)
                    or any(n != 1 for n in terms.values())
                    or set(terms) != set(want)):
                fail("21b/journal", f"f32: pending {final.pending()}, "
                                    f"terminals {terms}")
            if mism or final.tokens != want:
                fail("21b/journal", f"f32: replayed tokens differ from the "
                                    f"uninterrupted run for {mism}")
            if n_launch != cfg.n_layers * rounds:
                fail("21b/journal", f"f32 replay: launches {n_launch} != "
                                    f"n_layers x {rounds}")
            out["f32"] = {
                "requests": len(trace), "kill_at_iteration": kill_at,
                "reference_iterations": ref["iterations"],
                "completed_before_kill": len(done_before),
                "replayed": n_replay, "readmitted_cold": len(lost) - n_replay,
                "replayed_tokens": sum(len(q.generated) for q in lost),
                "journal_records": len(journal_mod.read_records(path)),
                "tokens_equal": True,
                "draft_accept_rate": ref["draft_accept_rate"]}
            print(f"journal 21b f32 [{card}]: {len(trace)} requests, killed "
                  f"after iteration {kill_at} of {ref['iterations']} "
                  f"({len(done_before)} done); {n_replay} replayed from "
                  f"their watermarks, {len(lost) - n_replay} re-admitted "
                  f"cold; every intent one terminal, every token == the "
                  f"uninterrupted run's; launches == n_layers x rounds")
        else:
            restart.close()
            restart.journal.close()
            trips = replay_trips(params, cfg, serve,
                                 [q for q in lost if q.replay])
            out["bf16"] = {"replayed": n_replay, "trips": len(trips),
                           "trip_gaps": trips}
            print(f"journal 21b bf16 [{card}]: {n_replay} replays, "
                  f"{len(trips)} trip the re-sampled-token assertion; top-2 "
                  f"gaps {[(t['rid'], t['gap'], t['top']) for t in trips]}")
        del params
        torch.cuda.empty_cache()
    laps.done("21b/journal, kill, replay")
    return out


def migration_drill(laps, card) -> dict:
    """Phase 21c: ``drain()`` engine A ("a") at the first iteration where
    one request is mid-prefill and another mid-decode, ``enqueue`` every
    request on engine B ("b"), the prefix cache on, both engines on one
    stream. Gates: tokens == the unmigrated run's bit for bit; A's pages
    all free after ``drain`` + ``clear_cache``; a ``hop`` meter record for
    each move, an ``export`` and an ``import`` rtrace for each request
    that held pages."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        ServeConfig,
    )
    from distributed_model_parallel_tpu_torch.utils import (
        telemetry as tel_mod,
    )

    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **OVL_MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    trace = serve_trace(cfg.vocab_size)[:MIG_REQS]
    system = np.random.default_rng(2121).integers(
        0, cfg.vocab_size, MIG_SYSTEM).tolist()
    reqs_spec = [(system + r["prompt"][:MIG_USER],
                  min(r["max_new_tokens"], MIG_GEN), r["seed"])
                 for r in trace]
    serve = ServeConfig(**OVL_GEOMETRY, prefix_cache=True)

    def submit(eng):
        return [eng.submit(p, g, rid=f"m{i}", seed=s)
                for i, (p, g, s) in enumerate(reqs_spec)]

    ref_eng = Engine(params, cfg, serve)
    ref_eng.warmup()
    ref_reqs = submit(ref_eng)
    ref_eng.run()
    want = [q.generated for q in ref_reqs]
    tel = tel_mod.TelemetryRun(
        os.path.join(os.environ[RUN_DIR_ENV], "migrate21.jsonl"),
        run="migrate21")
    a = Engine(params, cfg, serve, telemetry=tel, replica="a")
    b = Engine(params, cfg, serve, telemetry=tel, replica="b")
    reqs = submit(a)
    drain_at = None
    t0 = time.monotonic()
    for it in range(64):
        a.step_once(time.monotonic() - t0, t0)
        states = {q.state.value for q in reqs if q.slot is not None}
        mid_prefill = any(q.state.value == "prefill"
                          and q.cached_prompt_tokens < q.prefill_cursor
                          for q in reqs)
        if mid_prefill and "decode" in states:
            drain_at = it + 1
            break
    if drain_at is None:
        fail("21c/migrate", "no iteration had a request mid-prefill and "
                            "another mid-decode")
    n_prefill = sum(q.state.value == "prefill" for q in reqs)
    n_decode = sum(q.state.value == "decode" for q in reqs)
    moved = a.drain()
    resident = [q.rid for q in moved if q.resume is not None]
    freed = a.clear_cache()
    if a.cache.pool.used_pages:
        fail("21c/migrate", f"{a.cache.pool.used_pages} pages held on A")
    for q in moved:
        b.enqueue(q, force=True)
    pa.paged_attention_kernel.launches = 0
    b.run()
    torch.cuda.synchronize()
    tel.finish()
    got = [q.generated for q in reqs]
    if got != want:
        bad = [q.rid for q, w in zip(reqs, want) if q.generated != w]
        fail("21c/migrate", f"migrated tokens differ from the unmigrated "
                            f"run for {bad}")
    records = tel_mod.read_records(tel.path)
    hops = [r["request"] for r in records
            if r.get("kind") == "meter" and r.get("event") == "hop"]
    ev = {}
    for r in records:
        if r.get("kind") == "rtrace" and r["event"] in ("export", "import"):
            ev.setdefault(r["event"], []).append(r["request"])
    if (sorted(hops) != sorted(q.rid for q in moved)
            or sorted(ev.get("export", [])) != sorted(resident)
            or sorted(ev.get("import", [])) != sorted(resident)):
        fail("21c/migrate", f"hop records {hops}, rtraces {ev}, resident "
                            f"{resident}")
    traces = tel_mod.join_request_traces(records)
    linked = sum(len(tl["hops"]) for tl in traces.values())
    if any(tl["orphan"] for tl in traces.values()) or linked != len(resident):
        fail("21c/migrate", f"trace joiner: {linked} hops for "
                            f"{len(resident)} exports")
    out = {"drain_at_iteration": drain_at, "moved": len(moved),
           "with_pages": len(resident), "mid_prefill": n_prefill,
           "mid_decode": n_decode, "tree_pages_freed": freed,
           "tokens": sum(map(len, got)), "tokens_equal": True,
           "b_launches": pa.paged_attention_kernel.launches}
    print(f"migrate 21c [{card}]: drained A after iteration {drain_at} "
          f"({n_prefill} in prefill, {n_decode} in decode, "
          f"{len(resident)} with pages); A's pool empty after clear_cache "
          f"({freed} tree pages freed); {len(hops)} hop meter records, "
          f"{len(resident)} export/import rtrace pairs linked as hops; "
          f"tokens == the unmigrated run's bit for bit ({out['tokens']})")
    del params
    torch.cuda.empty_cache()
    laps.done("21c/drain, import")
    return out


def planes_phase(laps, card) -> dict:
    """Phase 21: the serving engine's overload controls and planes on the
    card — 21a the overload drill (21d the status exporter inside it),
    21b the journal's kill and replay, 21c drain and import between two
    engines."""
    return {"overload": overload_drill(laps, card),
            "journal": journal_drill(laps, card),
            "migrate": migration_drill(laps, card)}


def fleet_devices(n: int) -> list:
    """The pool of a phase-22 fleet: n slots, replica i on card
    i mod the card count (all on cuda:0 on a one-card host)."""
    import torch

    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def fleet_pass(fleet, cfg, trace, *, hook=None, label: str) -> tuple:
    """Run ``fleet`` over ``trace`` (submitted as f0, f1, ...; empty for a
    fleet ``ServeFleet.recover`` filled), the paged kernel's count at 0
    just before; returns ``(summary, paged launches)``. Gates: the
    launches == n_layers x the decode rounds summed over the replicas'
    engines, those a ``hook(fleet, rnd)`` discarded included (the hook
    returns their rounds: a crash), and no plain decode call."""
    import torch

    from distributed_model_parallel_tpu_torch.ops import (
        paged_attention as pa,
    )

    dead = {"rounds": 0}
    if hook is not None:
        fleet.step_hook = lambda rnd: dead.__setitem__(
            "rounds", dead["rounds"] + (hook(fleet, rnd) or 0))
    for i, r in enumerate(trace):
        fleet.submit(r["prompt"], r["max_new_tokens"], rid=f"f{i}",
                     arrival_s=r["arrival_s"], seed=r["seed"])
    pa.paged_attention_kernel.launches = 0
    with PlainDecodeCount() as plain:
        summary = fleet.run()
    torch.cuda.synchronize()
    launches = pa.paged_attention_kernel.launches
    rounds = dead["rounds"] + sum(r.engine._decode_steps
                                  for r in fleet.replicas)
    fleet.close()
    if launches != cfg.n_layers * rounds or plain.n:
        fail("22/fleet", f"{label}: paged_decode launches {launches} != "
                         f"n_layers x {rounds} decode rounds summed over the "
                         f"replicas, plain decode calls {plain.n}")
    return summary, launches


def tokens_of(fleet) -> dict:
    return {q.rid: list(q.generated) for q in fleet.results()}


def terminal_counts(path: str) -> dict:
    from distributed_model_parallel_tpu_torch.serve import journal

    out: dict = {}
    for rec in journal.read_records(path):
        if rec.get("kind") == "terminal":
            out[rec["rid"]] = out.get(rec["rid"], 0) + 1
    return out


def replay_trips(params, cfg, serve, replays) -> list:
    """Each replayed request alone on a fresh engine, through its final
    prefill chunk: the ones whose re-sampled last token differs from the
    journaled one trip the engine's replay assertion; each trip with the
    top-2 gap of that chunk's logits."""
    import torch

    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        EngineKilled,
    )
    from distributed_model_parallel_tpu_torch.serve import model as smodel

    prefill_logits = smodel.prefill_logits
    last = {}

    def recording(*a, **kw):
        logits = prefill_logits(*a, **kw)
        last["top"] = torch.topk(logits.float()[0], 2).values.cpu()
        return logits

    smodel.prefill_logits = recording
    trips = []
    try:
        for q in replays:
            one = Engine(params, cfg, serve, slo_metrics=False, meter=False)
            one.enqueue(q, force=True)
            try:
                one.run(max_iterations=-(-len(q.prefill_tokens)
                                         // serve.prefill_chunk))
            except EngineKilled as e:
                if not isinstance(e.__cause__, AssertionError):
                    raise
                top = last["top"]
                trips.append({"rid": q.rid,
                              "position": len(q.prefill_tokens),
                              "gap": float(top[0] - top[1]),
                              "top": float(top[0])})
    finally:
        smodel.prefill_logits = prefill_logits
    return trips


def fleet_phase(laps, card) -> dict:
    """Phase 22: bench.py's fleet cell (``bench_serve_fleet``,
    bench.py:895-1072) on the port's ``ServeFleet``: 21a's model, trace
    and geometry through FLEET_REPLICAS replicas (one card: every slot on
    cuda:0).

    22a: a clean pass, then the kill drill (``r1`` killed at round
    FLEET_KILL_ROUND, revived FLEET_REVIVE rounds later); bench.py's
    gates: the kill fired, no request failed, every token == the clean
    pass's, ``r1`` grew back, the post-kill TTFT p99 within
    max(FLEET_TTFT_FACTOR x the reference, FLEET_TTFT_FLOOR). 22b, in f32
    (a bf16 replay can flip an exact tie, PERF.md §7): a clean pass, the
    crash drill (``crash_replica("r1")`` at the kill round, the journal
    re-admitting its requests) and ``ServeFleet.recover`` from a journal
    abandoned half-way: no request lost, one terminal each, tokens == the
    clean pass's; then the crash drill once in bf16, with the replays
    that re-sample another token counted (reported, not gated). 22c: 4
    replicas in 2 cells on a SimClock, ``kill_cell`` then ``partition``
    on the last cell, FLEET_CELL_REQS requests: none lost, the cell back
    on exactly its slots, the partition's residents complete, tokens ==
    a clean 4-replica pass. Every pass: paged launches == n_layers x the
    decode rounds summed over the replicas, never the plain path."""
    import torch

    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        Engine,
        EngineKilled,
        ServeConfig,
        ServeFleet,
        SimClock,
    )
    from distributed_model_parallel_tpu_torch.serve import (
        journal as journal_mod,
    )
    from distributed_model_parallel_tpu_torch.serve.scheduler import (
        summarize,
    )
    from distributed_model_parallel_tpu_torch.utils import (
        telemetry as tel_mod,
    )

    run_dir = os.environ[RUN_DIR_ENV]
    trace = serve_trace(OVL_MODEL["vocab_size"])
    serve = ServeConfig(**OVL_GEOMETRY)
    n_cards = len(set(fleet_devices(FLEET_REPLICAS)))
    cfg = tfm.TransformerConfig(dtype=torch.bfloat16, **OVL_MODEL)
    params = tfm.init_params(cfg, seed=0, device="cuda")
    for dev in sorted(set(fleet_devices(FLEET_CELL_REPLICAS)), key=str):
        Engine(params, cfg, serve, device=dev, slo_metrics=False).warmup()
    tel = tel_mod.TelemetryRun(os.path.join(run_dir, "fleet22.jsonl"),
                               run="fleet22", meta=dict(trace="fleet"))
    launches = 0

    def fleet(params, cfg, n=FLEET_REPLICAS, **kw):
        return ServeFleet(params, cfg, serve, n, devices=fleet_devices(n),
                          **kw)

    # -- 22a: clean pass, kill drill ------------------------------------------
    clean_fleet = fleet(params, cfg, telemetry=tel)
    clean, n = fleet_pass(clean_fleet, cfg, trace, label="22a clean")
    launches += n
    want = tokens_of(clean_fleet)

    def kill(fleet, rnd):
        if rnd == FLEET_KILL_ROUND:
            fleet.kill_replica("r1")

    drill_fleet = fleet(params, cfg, telemetry=tel, revive_after=FLEET_REVIVE)
    drill, n = fleet_pass(drill_fleet, cfg, trace, hook=kill,
                          label="22a kill drill")
    launches += n
    if "r1" not in drill_fleet.kill_times:
        fail("22a/fleet", f"the kill never fired: the trace drained in "
                          f"{drill['rounds']} rounds")
    if clean["requests_failed"] or drill["requests_failed"] or len(want) != \
            len(trace) or clean["requests_completed"] != len(trace):
        fail("22a/fleet", f"requests failed: clean "
                          f"{clean['requests_failed']}, drill "
                          f"{drill['requests_failed']}")
    bad = [rid for rid, toks in tokens_of(drill_fleet).items()
           if toks != want[rid]]
    if bad:
        fail("22a/fleet", f"tokens differ from the clean pass after the "
                          f"kill for {bad}")
    if any(rep.state != "live" for rep in drill_fleet.replicas):
        fail("22a/fleet", "the killed replica did not grow back")
    kill_t = drill_fleet.kill_times["r1"]
    done = [q for q in drill_fleet.results()
            if q.t_first_token is not None and q.t_admitted is not None]
    pre = summarize([max(0.0, q.t_first_token - q.arrival_s)
                     for q in done if q.t_admitted < kill_t])
    post = summarize([max(0.0, q.t_first_token - q.arrival_s)
                      for q in done if q.t_admitted >= kill_t])
    ref = max([x for x in (pre.get("p99"), clean["ttft_s"].get("p99"))
               if x is not None], default=None)
    bound = (max(ref * FLEET_TTFT_FACTOR, FLEET_TTFT_FLOOR)
             if ref is not None else None)
    if post.get("p99") is not None and bound is not None \
            and post["p99"] > bound:
        fail("22a/fleet", f"post-kill TTFT p99 {post['p99']} s > {bound} s")
    out = {"replicas": FLEET_REPLICAS, "cards": n_cards,
           "tokens_per_s_per_card": clean["tokens_per_s"] / n_cards,
           "drill_tokens_per_s_per_card": drill["tokens_per_s"] / n_cards,
           "tokens": clean["tokens_generated"],
           "clean_wall_s": clean["wall_s"], "clean_rounds": clean["rounds"],
           "drill_rounds": drill["rounds"],
           "migrations": drill["migrations"],
           "ttft_p50_s": clean["ttft_s"].get("p50"),
           "ttft_p99_s": clean["ttft_s"].get("p99"),
           "pre_kill_ttft_p50_s": pre.get("p50"),
           "pre_kill_ttft_p99_s": pre.get("p99"),
           "post_kill_ttft_p50_s": post.get("p50"),
           "post_kill_ttft_p99_s": post.get("p99"),
           "post_kill_ttft_bound_s": bound,
           "kill_round": FLEET_KILL_ROUND, "revive_rounds": FLEET_REVIVE}
    print(f"fleet 22a [{card}]: {FLEET_REPLICAS} replicas on {n_cards} "
          f"card(s); clean {clean['tokens_generated']} tokens in "
          f"{clean['wall_s']} s, {out['tokens_per_s_per_card']} tokens/s a "
          f"card over {clean['rounds']} rounds, TTFT p50 / p99 "
          f"{out['ttft_p50_s']} / {out['ttft_p99_s']} s; kill drill "
          f"{out['drill_tokens_per_s_per_card']} tokens/s a card, "
          f"{drill['migrations']} migrations, {drill['rounds']} rounds, "
          f"TTFT p50 / p99 before the kill {pre.get('p50')} / "
          f"{pre.get('p99')} s, after {post.get('p50')} / {post.get('p99')} "
          f"s (bound {bound} s); every token == the clean pass's, r1 grew "
          f"back")
    laps.done("22a/fleet, kill drill")

    # -- 22b: crash drill and restart, f32 ------------------------------------
    cfg32 = tfm.TransformerConfig(dtype=torch.float32, **OVL_MODEL)
    params32 = tfm.init_params(cfg32, seed=0, device="cuda")
    clean32_fleet = fleet(params32, cfg32)
    clean32, n = fleet_pass(clean32_fleet, cfg32, trace,
                            label="22b clean f32")
    launches += n
    want32 = tokens_of(clean32_fleet)

    def crash(fleet, rnd, replays=None):
        if rnd != FLEET_KILL_ROUND:
            return 0
        steps = fleet.replicas[1].engine._decode_steps
        fleet.crash_replica("r1")
        if replays is not None:
            # Copies: the fleet goes on to run the re-admitted requests.
            replays.extend(copy.deepcopy(q) for rep in fleet.replicas
                           for q in rep.engine.sched.queue if q.replay)
        return steps

    path = os.path.join(run_dir, "fleet22-crash.jsonl")
    crash_fleet = fleet(params32, cfg32, revive_after=FLEET_REVIVE,
                        journal=journal_mod.RequestJournal(path))
    crashed, n = fleet_pass(crash_fleet, cfg32, trace, hook=crash,
                            label="22b crash drill")
    launches += n
    crash_fleet.journal.close()
    terms = terminal_counts(path)
    got = tokens_of(crash_fleet)
    if (crashed["replica_crashes"] != 1 or crashed["requests_failed"]
            or crashed["requests_completed"] != len(trace)
            or set(terms) != set(want32)
            or any(c != 1 for c in terms.values())):
        fail("22b/crash", f"crashes {crashed['replica_crashes']}, failed "
                          f"{crashed['requests_failed']}, completed "
                          f"{crashed['requests_completed']}, terminals "
                          f"{terms}")
    bad = [rid for rid, toks in got.items() if toks != want32[rid]]
    if bad:
        fail("22b/crash", f"tokens differ from the clean pass for {bad}")
    # The restart: a journaled fleet abandoned half-way (no drain), then
    # ServeFleet.recover from the journal alone.
    rpath = os.path.join(run_dir, "fleet22-recover.jsonl")
    first = fleet(params32, cfg32, journal=journal_mod.RequestJournal(rpath))
    for i, r in enumerate(trace):
        first.submit(r["prompt"], r["max_new_tokens"], rid=f"f{i}",
                     arrival_s=r["arrival_s"], seed=r["seed"])
    first.run(max_rounds=clean32["rounds"] // 2)
    first.close()
    before = {q.rid: list(q.generated) for q in first.results()
              if q.state.value == "completed"}
    del first
    second = ServeFleet.recover(params32, cfg32, serve, FLEET_REPLICAS,
                                journal=journal_mod.RequestJournal(rpath),
                                devices=fleet_devices(FLEET_REPLICAS))
    restarted, n = fleet_pass(second, cfg32, (), label="22b recover")
    second.journal.close()
    launches += n
    after = tokens_of(second)
    terms = terminal_counts(rpath)
    if (restarted["requests_failed"] or set(before) & set(after)
            or {**before, **after} != want32 or set(terms) != set(want32)
            or any(c != 1 for c in terms.values())):
        fail("22b/recover", f"{len(before)} done before the restart, "
                            f"{len(after)} after "
                            f"({sorted(set(before) & set(after))} served "
                            f"twice), failed "
                            f"{restarted['requests_failed']}, terminals "
                            f"{len(terms)}")
    out.update(
        crash={"recovered": crashed["crash_recovered"],
               "recovery_time_s": crashed["recovery_time_s"],
               "rounds": crashed["rounds"], "tokens_equal": True},
        recover={"abandoned_at_round": clean32["rounds"] // 2,
                 "done_before": len(before), "recovered": len(after),
                 "recovery_time_s": restarted["recovery_time_s"],
                 "rounds": restarted["rounds"], "tokens_equal": True})
    print(f"fleet 22b f32 [{card}]: crash drill: r1 hard-crashed at round "
          f"{FLEET_KILL_ROUND}, {crashed['crash_recovered']} requests "
          f"re-admitted from the journal in {crashed['recovery_time_s']} s "
          f"(recovery_time_s); recover: abandoned after round "
          f"{clean32['rounds'] // 2} ({len(before)} done), {len(after)} "
          f"finished by the restarted fleet, recovery_time_s "
          f"{restarted['recovery_time_s']}; no request lost, one terminal "
          f"each, every token == the clean pass's")
    del params32, clean32_fleet, crash_fleet, second
    # The crash drill once in bf16: replays that re-sample another token
    # (an exact bf16 tie) trip the engine's replay assertion.
    replays: list = []
    bpath = os.path.join(run_dir, "fleet22-crash-bf16.jsonl")
    bf = fleet(params, cfg, revive_after=FLEET_REVIVE,
               journal=journal_mod.RequestJournal(bpath))
    bf.step_hook = lambda rnd: crash(bf, rnd, replays)
    for i, r in enumerate(trace):
        bf.submit(r["prompt"], r["max_new_tokens"], rid=f"f{i}",
                  arrival_s=r["arrival_s"], seed=r["seed"])
    try:
        bs = bf.run()
        died = None
    except EngineKilled as e:
        bs, died = None, f"{type(e.__cause__).__name__}: {e.__cause__}"
    bf.close()
    trips = replay_trips(params, cfg, serve, replays)
    bf_bad = (None if bs is None else
              [rid for rid, toks in tokens_of(bf).items()
               if toks != want[rid]])
    out["crash_bf16"] = {"replays": len(replays), "trips": trips,
                         "fleet_died": died, "tokens_differ": bf_bad}
    print(f"fleet 22b bf16 [{card}]: crash drill: {len(replays)} replays, "
          f"{len(trips)} re-sampled another token (rid, gap, top) "
          f"{[(t['rid'], t['gap'], t['top']) for t in trips]}; the fleet "
          + (f"died: {died}" if died else
             f"finished, {len(bf_bad)} requests differ from the clean bf16 "
             f"pass {bf_bad}"))
    laps.done("22b/crash drill, recover")

    # -- 22c: cells ---------------------------------------------------------
    sub = trace[:FLEET_CELL_REQS]
    kw = dict(n=FLEET_CELL_REPLICAS, cells=FLEET_CELLS)
    cell_clean = fleet(params, cfg, clock=SimClock(), **kw)
    cs, n = fleet_pass(cell_clean, cfg, sub, label="22c clean")
    launches += n
    wantc = tokens_of(cell_clean)
    ctel = tel_mod.TelemetryRun(os.path.join(run_dir, "fleet22-cells.jsonl"),
                                run="fleet22-cells")
    faults = (f"kill_cell@{FLEET_CELL_KILL}",
              f"partition@{FLEET_CELL_PARTITION}:{FLEET_CELL_PARTITION_POLLS}")
    cell_fleet = fleet(params, cfg, clock=SimClock(), telemetry=ctel,
                       faults=faults, revive_after=FLEET_CELL_REVIVE, **kw)
    cd, n = fleet_pass(cell_fleet, cfg, sub, label="22c cell drill")
    launches += n
    ctel.finish()
    recs = tel_mod.read_records(ctel.path)
    ev = {r["event"]: r for r in recs if r.get("kind") == "cell"}
    victim = cell_fleet.cells.cells[-1]
    members = list(cell_fleet.cells.members(victim))
    held = cell_fleet.pool.assignments()
    routed_in = ([r["request"] for r in recs if r.get("kind") == "router"
                  and ev["partition"]["round"] <= r["round"]
                  < ev["heal"]["round"] and r["replica"] in members]
                 if {"partition", "heal"} <= set(ev) else None)
    if (cd["requests_failed"] or cd["requests_completed"] != len(sub)
            or cs["requests_completed"] != len(sub)
            or tokens_of(cell_fleet) != wantc):
        fail("22c/cells", f"lost or changed requests: failed "
                          f"{cd['requests_failed']}, completed "
                          f"{cd['requests_completed']} of {len(sub)}")
    if (not {"kill", "grow-back", "partition", "heal"} <= set(ev)
            or any(held.get(f"serve-{r.name}") != r.device_ids
                   or r.state != "live" for r in cell_fleet.replicas)
            or not ev["partition"]["residents"] or routed_in):
        fail("22c/cells", f"cell records {sorted(ev)}, slices {held}, "
                          f"partition {ev.get('partition')}, routed into the "
                          f"partition {routed_in}")
    out["cells"] = {
        "replicas": FLEET_CELL_REPLICAS, "cells": FLEET_CELLS,
        "requests": len(sub), "rounds": cd["rounds"],
        "clean_rounds": cs["rounds"], "migrations": cd["migrations"],
        "failovers": cd["router"]["failovers"],
        "kill_round": ev["kill"]["round"],
        "grow_back_round": ev["grow-back"]["round"],
        "partition_round": ev["partition"]["round"],
        "heal_round": ev["heal"]["round"],
        "partition_residents": ev["partition"]["residents"],
        "drained_at_heal": ev["heal"]["drained"], "tokens_equal": True}
    print(f"fleet 22c [{card}]: {FLEET_CELL_REPLICAS} replicas in "
          f"{FLEET_CELLS} cells on a SimClock, {len(sub)} requests: cell "
          f"{victim} killed at round {ev['kill']['round']} "
          f"({cd['migrations']} migrations), grown back at round "
          f"{ev['grow-back']['round']} onto exactly its slots; partitioned "
          f"at round {ev['partition']['round']} with "
          f"{ev['partition']['residents']} residents, healed at round "
          f"{ev['heal']['round']} ({ev['heal']['drained']} of them done), "
          f"none routed in meanwhile; none lost, tokens == the clean "
          f"4-replica pass's")
    laps.done("22c/cells")

    # Device busy share over FLEET_PROFILE_ROUNDS busy fleet rounds.
    prof = fleet(params, cfg, slo_metrics=False)
    for i, r in enumerate(trace[:2 * OVL_GEOMETRY["n_slots"]]):
        prof.submit(r["prompt"], r["max_new_tokens"], rid=f"p{i}",
                    seed=r["seed"])
    busy = device_busy(lambda: prof.run(max_rounds=FLEET_PROFILE_ROUNDS,
                                        record_summary=False))
    prof.close()
    out.update(launches=launches, device_busy_share=busy["busy_share"],
               device_busy_rounds=FLEET_PROFILE_ROUNDS)
    print(f"fleet 22 [{card}]: device busy {busy['busy_share']} of the wall "
          f"over {FLEET_PROFILE_ROUNDS} profiled rounds; paged_decode "
          f"launches {launches} == n_layers x the decode rounds of every "
          f"pass, no plain path")
    del params, prof
    torch.cuda.empty_cache()
    laps.done("22/profile")
    return out


# -- phase 23: the trainers' resilience plane ----------------------------------

RES23_BATCH, RES23_ROWS = 512, 4096          # 23a: 8 steps an epoch
RES23_PLAN = ("save_fail@0", "tear_save@2", "nan_loss@10")
RES23_STALL = ("stall@2:1.5",)               # 23a: the sync site's 3rd poll
RES23_STALL_BUDGET_S = 0.5
RANKS23_BATCH, RANKS23_ROWS = 128, 512       # 23b: 4 steps an epoch
RANKS23_OVERHEAD_STEPS = 20                  # at cadence 10
# 23b's drills under ddp (BN statistics per replica, one bucketed
# gradient all-reduce a step) and the preemption under gspmd without BN
# (replicated state that reshards): gspmd's cross-replica BN statistics
# cost ~100 collectives a step, each staged through the host over gloo.
RANKS23_DDP = dict(strategy="ddp", ddp_allreduce="bucketed")
RANKS23_PREEMPT_MODEL = "mobilenetv2_nobn"
RANKS23_KILL_AT = 4 + 1                      # step 1 of epoch 1
LM23_LAYERS, LM23_STEPS = 2, 3
LM23_PLAN = ("nan_params@1",)


def res23_config(tconfig, root: str, name: str, *, batch: int = RES23_BATCH,
                 rows: int = RES23_ROWS, **kw):
    """Phase 23's CNN workload: MobileNetV2, bf16, fused SGD, synthetic
    32 px rows, 2 epochs, the host input path; logs and checkpoints under
    ``root``."""
    base = dict(
        model=tconfig.ModelConfig(name="mobilenetv2", dtype="bfloat16"),
        data=tconfig.DataConfig(
            name="synthetic", batch_size=batch, eval_batch_size=batch,
            image_size=32, synthetic_native_size=32,
            synthetic_train_size=rows, synthetic_eval_size=batch),
        optimizer=tconfig.OptimizerConfig(learning_rate=0.4,
                                          warmup_steps=10, fused=True),
        epochs=2, log_every_n_steps=1000, device="cuda",
        log_dir=os.path.join(root, "log"), log_name=name,
        checkpoint_dir=os.path.join(root, f"ckpt_{name}"))
    base.update(kw)
    return tconfig.TrainConfig(**base)


def plane_records(records: list) -> list:
    """The ``[kind, what]`` resilience records of a run's ``.jsonl``
    records, in order."""
    return [[r["kind"], r.get("error") or r.get("action") or r.get("status")]
            for r in records if r["kind"] in ("failure", "recovery",
                                              "consistency")]


def jsonl(trainer) -> list:
    with open(trainer.logger.jsonl_path) as f:
        return [json.loads(line) for line in f]


def resilience_single(trainer_mod, tconfig, fs, root, card) -> dict:
    """Phase 23a (see the module docstring)."""
    import torch

    phase = "23a/resilience one rank"
    steps = [0]

    def count(_t):
        steps[0] += 1

    recovery = tconfig.RecoveryConfig
    cfg = res23_config(tconfig, root, "r23_drills", check_finite_every=1,
                       eval_every=10,
                       recovery=recovery(max_retries=1, lr_shrink=0.5,
                                         faults=RES23_PLAN))
    t = trainer_mod.Trainer(cfg)
    t.step_hook = count
    views = [p.data_ptr() for p in t.model.parameters()]
    buckets = len(t.optimizer.buckets)
    fs.fused_sgd_kernel.launches = fs.plain_sgd_kernel.launches = 0
    t0 = time.perf_counter()
    history = t.fit()
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    launches = {"fused_sgd": fs.fused_sgd_kernel.launches,
                "plain_sgd": fs.plain_sgd_kernel.launches}
    records = plane_records(jsonl(t))
    want = [["failure", "checkpoint-save-failed"],
            ["recovery", "save-retried"], ["failure", "non-finite"],
            ["failure", "checkpoint-torn"],
            ["recovery", "checkpoint-fallback"], ["recovery", "restored"]]
    finite = all(bool(torch.isfinite(p).all()) for p in t.model.parameters())
    kept = views == [p.data_ptr() for p in t.model.parameters()]
    print(f"resilience 23a drills [{card}]: {steps[0]} steps run in "
          f"{drill_s:.2f} s, epochs {[h['epoch'] for h in history]}, "
          f"records {records}, lr {t.config.optimizer.learning_rate}, "
          f"fused_sgd launches {launches['fused_sgd']} ({buckets} bucket), "
          f"finite {finite}, bucket views kept {kept}")
    if records != want:
        fail(phase, f"records {records}, want {want}")
    if [h["epoch"] for h in history] != [0, 1] or not finite or not kept:
        fail(phase, f"history {history}, finite {finite}, views {kept}")
    if (launches["fused_sgd"] != steps[0] * buckets
            or launches["plain_sgd"]):
        fail(phase, f"launches {launches}, want {steps[0] * buckets} "
                    f"fused_sgd")
    del t
    # The stall: checkpoint-and-exit, then the resume == uninterrupted.
    a = trainer_mod.Trainer(res23_config(tconfig, root, "r23_clean",
                                         max_inflight_steps=1))
    a.fit()
    stall = res23_config(tconfig, root, "r23_stall", max_inflight_steps=1,
                         stall_budget_s=RES23_STALL_BUDGET_S,
                         recovery=recovery(max_retries=1, stall_exit=True,
                                           faults=RES23_STALL))
    b = trainer_mod.Trainer(stall)
    stopped = b.fit()
    stopped_at = b.global_step
    stall_records = plane_records(jsonl(b))
    del b
    r = trainer_mod.Trainer(stall.replace(resume=True,
                                          recovery=recovery()))
    r.fit()
    torch.cuda.synchronize()
    bad = resume_mismatches(resume_state(a), resume_state(r))
    print(f"resilience 23a stall [{card}]: stalled {RES23_STALL} past "
          f"{RES23_STALL_BUDGET_S} s, stopped at global step {stopped_at} "
          f"(epochs done {len(stopped)}), records {stall_records}; resumed "
          f"to {r.global_step}: {bad} of {len(resume_state(a))} arrays "
          f"differ from the uninterrupted run")
    if stopped or stall_records != [["failure", "stall"]] or bad:
        fail(phase, f"stall drill: stopped {stopped}, records "
                    f"{stall_records}, {bad} arrays differ")
    return dict(steps=steps[0], records=records, launches=launches,
                drill_s=drill_s, stopped_at=stopped_at,
                stall_resume_bitwise=not bad)


def resilience_rank(spec, root: str) -> dict:
    """Phase 23b on each of 4 ranks (see the module docstring); ranks 0-1
    also form a two-rank mesh (a sub-group) for the world-2 drills while
    ranks 2-3 wait. Returns small host values."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.mesh import MeshSpec
    from distributed_model_parallel_tpu_torch.ops.collectives import (
        mesh_barrier,
    )
    from distributed_model_parallel_tpu_torch.train import chaos
    from distributed_model_parallel_tpu_torch.train.checkpoint import (
        TopologyMismatchError,
    )
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    R, M = tconfig.RecoveryConfig, tconfig.MeshConfig
    mesh4 = M(data=4)

    def cfg(name, **kw):
        return res23_config(tconfig, root, name, **{
            "batch": RANKS23_BATCH, "rows": RANKS23_ROWS, **kw})

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                        b["params"]))

    def slim(run):
        out = {k: v for k, v in run.items() if k not in ("params",
                                                         "records")}
        out["records"] = plane_records(run["records"])
        return out

    out = {}
    laps = RankLaps(spec, "23b")
    kw = dict(mesh=mesh4, consistency_every=1, max_inflight_steps=1,
              **RANKS23_DDP)
    clean, hit = chaos.drill_rank(spec, [
        (cfg("r23_clean", recovery=R(max_retries=1), **kw), True),
        (cfg("r23_bitflip", recovery=R(max_retries=1,
                                       faults=("bitflip@1",)), **kw), True)])
    out["bitflip"] = dict(parity=same(clean, hit), **slim(hit))
    laps.done("bitflip")
    (ov,) = chaos.overhead_rank(spec, [(cfg(
        "r23_overhead", mesh=mesh4, epochs=1,
        rows=RANKS23_BATCH * RANKS23_OVERHEAD_STEPS, max_inflight_steps=1,
        log_every_n_steps=1, **RANKS23_DDP), 10)])
    out["overhead"] = ov
    laps.done("overhead")
    pk = dict(mesh=mesh4, max_inflight_steps=1, emergency_every=2,
              model=tconfig.ModelConfig(name=RANKS23_PREEMPT_MODEL,
                                        dtype="bfloat16"))
    killed = cfg("r23_kill", recovery=R(faults=(
        f"preempt@{RANKS23_KILL_AT}",)), **pk)
    base, kill = chaos.drill_rank(spec, [(cfg("r23_base", **pk), True),
                                         (killed, False)])
    ck = killed.checkpoint_dir
    if spec.rank == 0:
        shutil.copytree(ck, ck + "_half")
    mesh_barrier(spec)
    (r4,) = chaos.drill_rank(spec, [(cfg("r23_resume4", checkpoint_dir=ck,
                                         resume=True, **pk), True)])
    out["preempt"] = dict(kill=slim(kill), resume4=slim(r4),
                          parity4=same(base, r4),
                          base_step=base["global_step"])
    laps.done("preempt at 4")
    sub = dist.new_group([0, 1])
    ddp4 = cfg("r23_ddp", mesh=mesh4, recovery=R(faults=("preempt@1",)),
               **RANKS23_DDP)
    chaos.drill_rank(spec, [(ddp4, False)])
    mesh_barrier(spec)
    if spec.rank < 2:
        spec2 = MeshSpec(M(data=2), spec.rank, spec.device, spec.backend,
                         data_group=sub)
        pk2 = dict(pk, mesh=M(data=2))
        (r2,) = chaos.drill_rank(spec2, [(cfg(
            "r23_resume2", checkpoint_dir=ck + "_half", resume=True,
            **pk2), False)])
        out["preempt"]["resume2"] = slim(r2)
        (ds,) = chaos.drill_rank(spec2, [(cfg(
            "r23_desync", mesh=M(data=2), consistency_every=1,
            max_inflight_steps=1, **RANKS23_DDP,
            recovery=R(max_retries=2, faults=("desync@1",))), False)])
        out["desync"] = slim(ds)
        try:
            Trainer(ddp4.replace(mesh=M(data=2), resume=True,
                                 recovery=R()), spec=spec2)
            out["topology"] = None
        except TopologyMismatchError as e:
            out["topology"] = dict(
                n=len(e.conflicts), first=[e.conflicts[0][0],
                                           list(e.conflicts[0][1]),
                                           list(e.conflicts[0][2])],
                value_error=isinstance(e, ValueError))
    mesh_barrier(spec)
    laps.done("world 2")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    return out


def resilience_ranks_gate(res: list, card: str) -> dict:
    """Phase 23b's gates over the ranks' results; its numbers."""
    phase = "23b/resilience ranks"
    r0 = res[0]
    bf = r0["bitflip"]
    parity = all(r["bitflip"]["parity"] for r in res)
    kept = all(r["bitflip"]["views_kept"] for r in res)
    print(f"resilience 23b bitflip [{card}]: records {bf['records']}, "
          f"repairs {bf['repairs']}, final parameters == the uninjected "
          f"run's on every rank {parity}, bucket views kept {kept}")
    if not (parity and kept) or bf["records"] != [
            ["consistency", "divergence"], ["failure", "replica-divergence"],
            ["consistency", "repaired"], ["recovery", "replica-rebroadcast"]]:
        fail(phase, f"bitflip: {bf}")
    ov = r0["overhead"]
    total = sum(ov["times"])
    share = ov["check_s"] / max(total, 1e-12)
    print(f"resilience 23b sentinel [{card}]: {ov['checks']} checks at "
          f"cadence 10 over {len(ov['times'])} steps, "
          f"{ov['check_s'] / max(ov['checks'], 1) * 1e3:.2f} ms a check, "
          f"{share * 100:.2f}% of the step time "
          f"({total / max(len(ov['times']), 1) * 1e3:.1f} ms a step)")
    pre = r0["preempt"]
    kill, r4, r2 = pre["kill"], pre["resume4"], pre["resume2"]
    parity4 = all(r["preempt"]["parity4"] for r in res)
    print(f"resilience 23b preempt [{card}]: killed at global step "
          f"{kill['global_step']} (loader {kill['loader']}), emergency "
          f"saves {kill['saves']}; resumed at 4 from {r4['position']} to "
          f"{r4['global_step']}, bit for bit {parity4}; at 2 from "
          f"{r2['position']} to {r2['global_step']}")
    if (kill["global_step"] != RANKS23_KILL_AT + 1
            or kill["loader"]["batch_cursor"] == 0
            or r4["position"]["global_step"] != kill["global_step"]
            or not parity4 or r2["position"] != r4["position"]
            or r2["global_step"] != pre["base_step"]):
        fail(phase, f"preempt: {pre}")
    ds = r0["desync"]
    print(f"resilience 23b desync [{card}]: records {ds['records']}, "
          f"epochs {[h['epoch'] for h in ds['history']]}")
    if (["consistency", "no-quorum"] not in ds["records"]
            or ["recovery", "restored"] not in ds["records"]
            or [h["epoch"] for h in ds["history"]] != [0, 1]):
        fail(phase, f"desync: {ds}")
    topo = r0["topology"]
    print(f"resilience 23b topology [{card}]: ddp's world-4 checkpoint at "
          f"world 2: TopologyMismatchError {topo}")
    if (topo is None or topo["value_error"] or topo["first"][1][0] != 4
            or topo["first"][2][0] != 2):
        fail(phase, f"topology: {topo}")
    return dict(bitflip=dict(parity=parity, repairs=bf["repairs"]),
                sentinel=dict(checks=ov["checks"], check_s=ov["check_s"],
                              steps=len(ov["times"]), step_s=total,
                              share=share),
                preempt=dict(killed_at=kill["global_step"],
                             resumed4=r4["global_step"],
                             resumed2=r2["global_step"]),
                desync=ds["records"], topology=topo)


def resilience_lm(fa, tconfig, card) -> dict:
    """Phase 23c (see the module docstring)."""
    import dataclasses

    import torch

    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm

    phase = "23c/resilience lm"
    base = lm18_config("r23_lm", n_layers=LM23_LAYERS, steps=LM23_STEPS)
    cfg = dataclasses.replace(
        base, check_finite_every=1,
        recovery=tconfig.RecoveryConfig(max_retries=1, lr_shrink=0.5,
                                        faults=LM23_PLAN))
    t = lm.LMTrainer(cfg)
    steps = [0]
    t.step_hook = lambda _t: steps.__setitem__(0, steps[0] + 1)
    kernels = flash_wrappers(fa)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    history = t.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    records = plane_records(jsonl(t))
    print(f"resilience 23c [{card}]: LM d {LM_MODEL['d_model']}, "
          f"{LM23_LAYERS} layers, B {TRAIN_BATCH}, T {TRAIN_SEQ}: "
          f"{steps[0]} steps run in {fit_s:.2f} s, records {records}, "
          f"losses {[round(h['loss_train'], 4) for h in history]}, lr "
          f"{t.config.optimizer.learning_rate}, flash launches {launches}")
    want = [["failure", "non-finite"], ["recovery", "restored"]]
    if (records != want or len(history) != 1
            or not math.isfinite(history[0]["loss_train"])):
        fail(phase, f"records {records}, history {history}")
    if any(n != steps[0] * LM23_LAYERS for n in launches.values()):
        fail(phase, f"launches {launches}, want {steps[0] * LM23_LAYERS} "
                    f"each")
    return dict(steps=steps[0], launches=launches, fit_s=fit_s,
                records=records)


def resilience_phase(laps, trainer_mod, fs, fa, tconfig, card,
                     ranks: dict) -> dict:
    """Phase 23: 23a and 23c here beside 23b's record (its ranks rode a
    spawn of four)."""
    import tempfile

    import torch

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="resilience_",
                            dir=os.environ[RUN_DIR_ENV])
    single = resilience_single(trainer_mod, tconfig, fs, root, card)
    laps.done("23a/resilience one rank")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    lm23 = resilience_lm(fa, tconfig, card)
    laps.done("23c/resilience lm")
    return {"single": single, "ranks": ranks, "lm": lm23}


def resilience_ride(card: str):
    """Phase 23b as a :class:`RideAlong` of a spawn of four ranks; its
    gated record lands in ``ride.record``."""
    import tempfile

    root = tempfile.mkdtemp(prefix="resilience_ranks_",
                            dir=os.environ[RUN_DIR_ENV])
    ride = RideAlong(resilience_rank, None, (root,), None)
    ride.record = None

    def gate(results):
        ride.record = resilience_ranks_gate(results, card)
        return ride.record

    ride.gate = gate
    return ride


# -- phase 24: the autotuner ----------------------------------------------------

LM24_LAYERS, LM24_STEPS = 2, 3               # 24d: bench.py's LM width, cut
AUTO24_BATCH, AUTO24_STEPS = 128, 2          # 24e: 23b's geometry, 2 steps
AUTO24_WIRE_BYTES = 64 << 20                 # 24a: the wire-rate all-reduce


def autotune_config(tconfig, root: str, name: str, **kw):
    """Phase 24's CNN workloads: bench.py's CNN geometry (cnn_config:
    MobileNetV2, bf16 over f32, fused SGD) under ``strategy="auto"``,
    logs and checkpoints under ``root``."""
    return cnn_config(tconfig).replace(
        strategy="auto", log_dir=os.path.join(root, "log"), log_name=name,
        checkpoint_dir=os.path.join(root, f"ckpt_{name}"), **kw)


def autotune_coefficients(card) -> dict:
    """24a: the cost model's coefficients on the card, its HBM and peak,
    beside nvidia-smi's name and power limit; the plan CLI's dry-run
    ranking of bench.py's LM at 8 devices (top 3)."""
    import contextlib
    import dataclasses
    import io

    import torch

    from distributed_model_parallel_tpu_torch.autotune import (
        cost_model,
        dmp_plan,
        memory,
    )
    from distributed_model_parallel_tpu_torch.utils import profiling

    phase = "24a/autotune coefficients"
    name = torch.cuda.get_device_name(0)
    peak = profiling.peak_flops_per_chip()
    if peak is None:
        fail(phase, f"no peak FLOP/s for {name!r} in utils/profiling")
    coeffs = cost_model.default_coefficients()
    hbm = memory.device_hbm_bytes()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"autotune 24a [{card}]: default_coefficients() {coeffs}; "
          f"device_hbm_bytes() {hbm} (total_memory {total}); "
          f"peak_flops_per_chip() {peak}; peak_hbm_bytes_per_chip() "
          f"{profiling.peak_hbm_bytes_per_chip()}")
    if hbm != float(total) or coeffs.peak_flops_per_s != peak:
        fail(phase, f"HBM {hbm} != total_memory {total} or the "
                    f"coefficients' peak {coeffs.peak_flops_per_s} != {peak}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dmp_plan.main([
            "--workload", "lm", "--devices", "8", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--d-model",
            str(LM_MODEL["d_model"]), "--heads", str(LM_MODEL["n_heads"]),
            "--layers", str(LM_MODEL["n_layers"]), "--d-ff",
            str(LM_MODEL["d_ff"]), "--vocab", str(LM_MODEL["vocab_size"]),
            "--dry-run", "--top", "3"])
    cli = json.loads(buf.getvalue())
    top = [dict(strategy=r["strategy"], axes=r["axes"],
                num_microbatches=r["num_microbatches"],
                total_s=r["cost"]["total_s"],
                mem_bytes_per_device=r["mem_bytes_per_device"])
           for r in cli["ranked"]]
    print(f"autotune 24a plan CLI [{card}]: bench.py's LM at 8 devices, B "
          f"{TRAIN_BATCH}, T {TRAIN_SEQ}: {cli['n_feasible']} feasible, "
          f"{cli['n_rejected']} rejected; top 3 {top}")
    return dict(coefficients=dataclasses.asdict(coeffs), hbm_bytes=hbm,
                peak_flops_per_s=peak,
                peak_hbm_bytes_per_s=profiling.peak_hbm_bytes_per_chip(),
                cli_top3=top, cli_n_feasible=cli["n_feasible"])


def autotune_cnn(trainer_mod, fs, tconfig, root, card) -> dict:
    """24b: Trainer(strategy="auto") at bench.py's CNN geometry on one
    card against the parent's plan and the same run at gspmd, cuDNN
    deterministic."""
    import torch

    from distributed_model_parallel_tpu_torch.autotune import (
        cost_model,
        memory,
        search,
    )
    from distributed_model_parallel_tpu_torch.autotune.planner import (
        plan_parallelism,
    )

    phase = "24b/autotune cnn"
    cfg = autotune_config(tconfig, root, "auto_cnn")
    # What plan_for_cnn must decide, computed here: fused SGD and
    # device-resident data leave gspmd alone.
    want = plan_parallelism(
        search.cnn_workload(cfg.model, cfg.data), 1,
        coeffs=cost_model.default_coefficients(),
        hbm_bytes=memory.device_hbm_bytes(), strategies=("gspmd",),
        allow_undersubscribe=True)
    idx = torch.cat(cnn_dispatch_indices(4 * CNN_BATCH, 2))
    runs = {}
    for strategy in ("gspmd", "auto"):
        t = trainer_mod.Trainer(cfg.replace(
            strategy=strategy, log_name=f"auto_cnn_{strategy}"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.fused_sgd_kernel.launches = 0
        fs.plain_sgd_kernel.launches = 0
        t0 = time.perf_counter()
        first = t.run_steps(idx[:CNN_SPD])["loss"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        second = t.run_steps(idx[CNN_SPD:])["loss"]
        torch.cuda.synchronize()
        runs[strategy] = dict(
            losses=torch.cat([first, second]).cpu().tolist(),
            step_s=(time.perf_counter() - t1) / CNN_SPD,
            first_dispatch_s=t1 - t0,
            peak_bytes=torch.cuda.max_memory_allocated(),
            fused_sgd=fs.fused_sgd_kernel.launches,
            plain_sgd=fs.plain_sgd_kernel.launches,
            buckets=len(t.optimizer.buckets),
            trainer=t if strategy == "auto" else None)
        del t
    auto = runs["auto"]
    t = auto.pop("trainer")
    runs["gspmd"].pop("trainer")
    d = t.plan_decision
    records = [r for r in jsonl(t) if r["kind"] == "plan"]
    same = auto["losses"] == runs["gspmd"]["losses"]
    steps = 2 * CNN_SPD
    print(f"autotune 24b [{card}]: Trainer(strategy='auto') -> "
          f"{d.describe()}; want {want.chosen.plan.describe()}; plan "
          f"records {[(r['reason'], r['global_step']) for r in records]}; "
          f"losses bitwise the gspmd run's {same} ({auto['losses'][0]} .. "
          f"{auto['losses'][-1]}); predicted {d.chosen.cost.total_s} s a "
          f"step, measured {auto['step_s']} s (10 steps in one dispatch, "
          f"cuDNN deterministic); predicted {d.chosen.memory['total']} B a "
          f"device, max_memory_allocated {auto['peak_bytes']} B; fused_sgd "
          f"launches {auto['fused_sgd']} (want {steps} x {auto['buckets']})")
    if d.telemetry_payload() != want.telemetry_payload():
        fail(phase, "the trainer's plan is not the parent's")
    if [(r["reason"], r["global_step"]) for r in records] != [
            ("startup", 0)]:
        fail(phase, f"plan records {records}")
    if not same:
        fail(phase, "auto's losses are not bitwise gspmd's")
    if (auto["fused_sgd"] != steps * auto["buckets"] or auto["plain_sgd"]
            or not all(math.isfinite(x) for x in auto["losses"])):
        fail(phase, f"launches {auto['fused_sgd']} != {steps} x "
                    f"{auto['buckets']} or non-finite losses")
    del t
    torch.cuda.empty_cache()
    return dict(plan=d.chosen.payload(), predicted_s=d.chosen.cost.total_s,
                measured_step_s=auto["step_s"],
                predicted_bytes=d.chosen.memory["total"],
                peak_bytes=auto["peak_bytes"],
                launches={"fused_sgd": auto["fused_sgd"],
                          "plain_sgd": auto["plain_sgd"]},
                losses_bitwise_gspmd=same)


def autotune_pipeline(models, pipeline, pipeline_trainer, fs, tconfig,
                      root, card) -> dict:
    """24c: PipelineTrainer(strategy="auto") over PP_STAGES stages on the
    card (13a's workload, one fit epoch), then the analytic top 3
    microbatch counts timed for 2 steps each through measure_plans."""
    import torch

    from distributed_model_parallel_tpu_torch.autotune import (
        cost_model,
        measure,
        memory,
        search,
    )
    from distributed_model_parallel_tpu_torch.autotune.planner import (
        plan_parallelism,
    )
    from distributed_model_parallel_tpu_torch.data.loader import (
        step_generator,
    )
    from distributed_model_parallel_tpu_torch.parallel.auto_partition import (
        cost_balanced_boundaries,
    )

    phase = "24c/autotune pipeline"
    devices = ["cuda:0"] * PP_STAGES
    cfg = autotune_config(tconfig, root, "auto_pp",
                          device_resident_data=False, epochs=1)
    w = search.cnn_workload(cfg.model, cfg.data)
    t = pipeline_trainer.PipelineTrainer(cfg, devices)
    d = t.plan_decision
    cut = [lo for lo, _ in t.runner.slices] + [t.runner.slices[-1][1]]
    want_cut = cost_balanced_boundaries(list(w.unit_flop_costs), PP_STAGES)
    fs.fused_sgd_kernel.launches = 0
    hist = t.fit()
    launches = fs.fused_sgd_kernel.launches
    want = len(t.train_loader) * t.runner.num_chunks
    print(f"autotune 24c [{card}]: PipelineTrainer(strategy='auto') on "
          f"{devices} -> {d.describe()}; cut {cut} (the probe's costs "
          f"give {want_cut}); fit {hist}; fused_sgd launches {launches} "
          f"(want chunks x steps = {want})")
    if cut != want_cut:
        fail(phase, f"cut {cut} != auto_partition's {want_cut}")
    if launches != want or not math.isfinite(hist[0]["loss_train"]):
        fail(phase, f"launches {launches} != {want} or non-finite {hist}")
    del t
    torch.cuda.empty_cache()

    batch = pp_batches(cfg, [i for ix in cnn_dispatch_indices(
        4 * CNN_BATCH, 1) for i in ix][:3])

    def build(plan):
        r = pp_runner(models, pipeline, tconfig, devices, cfg,
                      m=plan.num_microbatches, boundaries=want_cut)
        calls = iter(range(3))
        return lambda: r.train_step_device(
            step_generator(1, next(calls), "cuda"), *batch[0])

    def measure_fn(plan):
        row, = measure.measure_plans([plan], build, warmup=1, iters=2,
                                     device="cuda:0")
        if "error" in row:
            raise RuntimeError(row["error"])
        return row["measured_s"]

    v = plan_parallelism(w, PP_STAGES, coeffs=cost_model.default_coefficients(),
                         hbm_bytes=memory.device_hbm_bytes(),
                         candidates=search.enumerate_stage_pipeline_plans(
                             w, PP_STAGES),
                         measure_fn=measure_fn, measure_top=3)
    analytic = [r.plan.num_microbatches for r in v.ranked[:3]]
    timed = [m for m in v.measured if "measured_s" in m]
    measured = [m["num_microbatches"] for m in
                sorted(timed, key=lambda m: (m["measured_s"],
                                             m["predicted_s"]))]
    print(f"autotune 24c validation [{card}]: analytic order (M) "
          f"{analytic}, predicted s {[r.cost.total_s for r in v.ranked[:3]]};"
          f" measured order {measured}, measured s "
          f"{[m.get('measured_s', m.get('error')) for m in v.measured]}; "
          f"measurement_won {v.measurement_won} -> {v.describe()}")
    if len(timed) != 3:
        fail(phase, f"a candidate failed to measure: {v.measured}")
    torch.cuda.empty_cache()
    return dict(plan=d.chosen.payload(), cut=cut, launches=launches,
                analytic_order=analytic, measured_order=measured,
                measured=list(v.measured),
                measurement_won=v.measurement_won,
                chosen_after_measure=v.chosen.plan.payload())


def autotune_lm(fa, card) -> dict:
    """24d: LMTrainer(strategy="auto", statusz_port=0) at bench.py's LM
    width (B 2, T 8192) at LM24_LAYERS layers through ``fit``, against
    strategy="spmd"'s steps on the same batches; a ``step_hook`` reads
    /statusz and /healthz before every step of the fit."""
    import dataclasses
    import urllib.request

    import torch

    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm
    from distributed_model_parallel_tpu_torch.utils import statusz

    phase = "24d/autotune lm"
    base = lm18_config("auto_lm", n_layers=LM24_LAYERS, steps=LM24_STEPS)
    kernels = flash_wrappers(fa)
    runs = {}
    for strategy in ("spmd", "auto"):
        cfg = dataclasses.replace(
            base, strategy=strategy, log_name=f"auto_lm_{strategy}",
            statusz_port=0 if strategy == "auto" else None)
        t = lm.LMTrainer(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        seen = []
        if strategy == "spmd":
            losses, times = lm18_steps(t, LM24_STEPS)
        else:
            url = statusz.active().url

            def hook(tr):
                # Before each step: the exporter's view of the live
                # trainer, beside the step the trainer is at.
                with urllib.request.urlopen(url + "/statusz",
                                            timeout=10) as r:
                    doc = json.loads(r.read())["providers"][cfg.log_name]
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=10) as r:
                    seen.append(dict(doc, healthz=r.status,
                                     hook_step=tr.global_step))

            t.step_hook = hook
            t.fit()
            torch.cuda.synchronize()
            losses = [r["loss"] for r in t.step_log]
            times = [r["step_time_s"] for r in t.step_log]
        runs[strategy] = dict(
            losses=losses, step_s=statistics.median(times[1:]),
            peak_bytes=torch.cuda.max_memory_allocated(),
            launches={n: k.launches for n, k in kernels.items()},
            status=seen, trainer=t if strategy == "auto" else None)
        del t
    statusz.shutdown()
    auto = runs["auto"]
    t = auto.pop("trainer")
    runs["spmd"].pop("trainer")
    d = t.plan_decision
    records = [r for r in jsonl(t) if r["kind"] == "plan"]
    same = auto["losses"] == runs["spmd"]["losses"]
    seen = auto["status"]
    status = seen[0] if seen else None
    print(f"autotune 24d [{card}]: LMTrainer(strategy='auto') -> "
          f"{d.describe()}; plan records "
          f"{[(r['reason'], r['global_step']) for r in records]}; losses "
          f"{auto['losses']} bitwise spmd's {same}; /statusz provider "
          f"before step 0 {status}, global_step before each step "
          f"{[(x['hook_step'], x['global_step']) for x in seen]} (the "
          f"hook's, the provider's); predicted {d.chosen.cost.total_s} s "
          f"a step, measured "
          f"{auto['step_s']} s (median of steps 1-{LM24_STEPS - 1}); "
          f"predicted {d.chosen.memory['total']} B a device, "
          f"max_memory_allocated {auto['peak_bytes']} B; flash launches "
          f"{auto['launches']} (want {LM24_LAYERS} x {LM24_STEPS} each)")
    if [(r["reason"], r["global_step"]) for r in records] != [
            ("startup", 0)]:
        fail(phase, f"plan records {records}")
    if not same:
        fail(phase, "auto's losses are not bitwise spmd's")
    if any(n != LM24_LAYERS * LM24_STEPS for n in auto["launches"].values()):
        fail(phase, f"launches {auto['launches']}")
    if [x["global_step"] for x in seen] != list(range(LM24_STEPS)) or any(
            x["global_step"] != x["hook_step"]
            or x.get("plan") != d.chosen.plan.payload()
            or x.get("healthz") != 200 or x.get("workload") != "lm"
            for x in seen):
        fail(phase, f"/statusz provider during the fit {seen}")
    del t
    torch.cuda.empty_cache()
    return dict(plan=d.chosen.payload(), predicted_s=d.chosen.cost.total_s,
                measured_step_s=auto["step_s"],
                predicted_bytes=d.chosen.memory["total"],
                peak_bytes=auto["peak_bytes"], launches=auto["launches"],
                losses_bitwise_spmd=same, status=status,
                status_global_steps=[(x["hook_step"], x["global_step"])
                                     for x in seen])


def autotune_rank(spec, root: str, measure_wire: bool) -> dict:
    """24e on each of 4 ranks: Trainer(strategy="auto") on MobileNetV2
    bf16 at B AUTO24_BATCH (23b's geometry) planned on the group's world,
    AUTO24_STEPS steps; the decision's payload and a digest of every
    parameter and buffer. With ``measure_wire`` (NCCL, a card a rank):
    alpha from 4-byte all-reduces and the wire rate from 64 MiB ones,
    each timed back to back between CUDA events, through the ring
    estimators."""
    import hashlib

    import torch
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        wire_bytes_estimate,
        wire_ops_estimate,
    )

    t0 = time.perf_counter()
    cfg = res23_config(tconfig, root, "auto_ranks", batch=AUTO24_BATCH,
                       rows=AUTO24_BATCH * AUTO24_STEPS, epochs=1,
                       strategy="auto")
    t = Trainer(cfg)
    res = t.train_epoch(0)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for x in (*t.model.parameters(), *t.model.buffers()):
        h.update(x.detach().float().cpu().numpy().tobytes())
    out = dict(plan=t.plan_decision.telemetry_payload(), loss=res.loss,
               steps=t.global_step, digest=h.hexdigest(),
               strategy=t.config.strategy, seconds=time.perf_counter() - t0)
    if measure_wire:
        n = dist.get_world_size()
        dev = torch.device("cuda", torch.cuda.current_device())

        def timed(numel, reps):
            # Seconds an all-reduce: ``reps`` back to back between two
            # CUDA events on the stream the collectives join, so no host
            # sync is inside the interval (a step never waits on the host
            # between its collectives either).
            x = torch.ones(numel, dtype=torch.float32, device=dev)
            for _ in range(5):
                dist.all_reduce(x)
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                dist.all_reduce(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps

        small = timed(1, 200)
        big = timed(AUTO24_WIRE_BYTES // 4, 20)
        alpha = small / wire_ops_estimate("psum", n)
        wire = wire_bytes_estimate("psum", AUTO24_WIRE_BYTES, n) / (
            big - alpha * wire_ops_estimate("psum", n))
        out["wire"] = dict(n=n, small_s=small, big_s=big, alpha_s=alpha,
                           wire_bytes_per_s=wire)
    return out


def autotune_ranks_gate(res: list, tconfig, root: str, card: str) -> dict:
    """24e's gates on the ranks' records: every rank's payload equal and
    equal to the parent's plan for 4 devices, the steps run, and under a
    data-parallel plan the replicas bitwise equal."""
    from distributed_model_parallel_tpu_torch.autotune import cost_model
    from distributed_model_parallel_tpu_torch.autotune.planner import (
        plan_for_cnn,
    )

    phase = "24e/autotune ranks"
    cfg = res23_config(tconfig, root, "auto_ranks_parent",
                       batch=AUTO24_BATCH, rows=AUTO24_BATCH * AUTO24_STEPS,
                       epochs=1, strategy="auto")
    _, want = plan_for_cnn(cfg, len(res))
    plans = [r["plan"] for r in res]
    digests = {r["digest"] for r in res}
    data_parallel = res[0]["strategy"] in ("gspmd", "ddp", "fsdp")
    wire = res[0].get("wire")
    print(f"autotune 24e [{card}]: {len(res)} ranks, Trainer(strategy="
          f"'auto') -> {res[0]['strategy']} {plans[0]['axes']}; payloads "
          f"equal {all(p == plans[0] for p in plans)}, equal to the parent's "
          f"plan_for_cnn at {len(res)} devices {plans[0] == want.telemetry_payload()}"
          f"; steps {[r['steps'] for r in res]}, losses "
          f"{[r['loss'] for r in res]}; replica digests {len(digests)} "
          f"distinct; rank seconds {[round(r['seconds'], 2) for r in res]}")
    if wire is not None:
        c = cost_model.default_coefficients()
        print(f"autotune 24a NCCL [{card}]: {wire['n']} cards, a 4-byte "
              f"all-reduce {wire['small_s']} s -> alpha_s {wire['alpha_s']} "
              f"(constant {c.alpha_s}); a {AUTO24_WIRE_BYTES} B all-reduce "
              f"{wire['big_s']} s -> wire_bytes_per_s "
              f"{wire['wire_bytes_per_s']} (constant {c.wire_bytes_per_s})")
    if any(p != plans[0] for p in plans) or plans[0] != \
            want.telemetry_payload():
        fail(phase, f"the ranks' plans differ or are not the parent's: "
                    f"{plans} vs {want.telemetry_payload()}")
    if any(r["steps"] != AUTO24_STEPS for r in res):
        fail(phase, f"steps {[r['steps'] for r in res]}")
    if data_parallel and len(digests) != 1:
        fail(phase, "replicas differ after the steps")
    return dict(plan=res[0]["plan"]["axes"], strategy=res[0]["strategy"],
                ranks=len(res), replicas_bitwise=len(digests) == 1,
                losses=[r["loss"] for r in res],
                rank_seconds=[r["seconds"] for r in res], wire=wire)


def autotune_ride(tconfig, card: str, measure_wire: bool):
    """Phase 24e as a :class:`RideAlong` of a spawn of four ranks; its
    gated record lands in ``ride.record``."""
    import tempfile

    root = tempfile.mkdtemp(prefix="autotune_ranks_",
                            dir=os.environ[RUN_DIR_ENV])
    ride = RideAlong(autotune_rank, None, (root, measure_wire), None)
    ride.record = None

    def gate(results):
        ride.record = autotune_ranks_gate(results, tconfig, root, card)
        return ride.record

    ride.gate = gate
    return ride


def autotune_phase(laps, trainer_mod, pipeline_trainer, models, pipeline,
                   fs, fa, tconfig, card, ranks: dict) -> dict:
    """Phase 24: 24a-d here, cuDNN deterministic, beside 24e's record (its
    ranks rode a spawn of four)."""
    import tempfile

    import torch

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="autotune_", dir=os.environ[RUN_DIR_ENV])
    coeffs = autotune_coefficients(card)
    laps.done("24a/autotune coefficients")
    cnn = autotune_cnn(trainer_mod, fs, tconfig, root, card)
    laps.done("24b/autotune cnn")
    pp = autotune_pipeline(models, pipeline, pipeline_trainer, fs, tconfig,
                           root, card)
    laps.done("24c/autotune pipeline")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    lm = autotune_lm(fa, card)
    laps.done("24d/autotune lm")
    return {"coefficients": coeffs, "cnn": cnn, "pipeline": pp, "lm": lm,
            "ranks": ranks}


# -- phase 25: the orchestrator, rank-group tenants, A9 on the card -----------

ORC25_CNN_BATCH, ORC25_CNN_ROWS = 512, 3 * 512   # 25a: 3 steps an epoch
ORC25_PP_BATCH, ORC25_PP_M = 512, 4              # 25a: 13a's workload, S 2
ORC25_LM_LAYERS, ORC25_LM_STEPS = 2, 3           # 25a: bench.py's LM width
RG25_BATCH, RG25_ROWS = 128, 2 * 128             # 25b: 2 steps an epoch
A925_BATCH, A925_STEPS = 128, 2                  # 25c: the CNN copies
A925_LM_SEQ, A925_LM_STEPS = 2048, 2             # 25c: the LM's dcn axis


def orc25_slots(n: int, spread: bool = False) -> list:
    """Phase 25's pool: ``n`` slots on card 0, or (``spread``) one a card
    while cards last."""
    import torch

    if spread and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


class TenantMeter:
    """Phase 25's instrument on ``orchestrator.tenants.Tenant``: each
    outermost grant, drain and boundary wait is timed (the card synced on
    both sides) and the kernels' launch counts during it are attributed to
    the tenant, so the orchestrator's own host time is a round's span
    minus its tenants' share. :meth:`close` restores the class."""

    def __init__(self, tenants_mod, fs, fa):
        import torch

        self.mod, self.torch = tenants_mod, torch
        self.kernels = {"fused_sgd": fs.fused_sgd_kernel,
                        "plain_sgd": fs.plain_sgd_kernel,
                        **flash_wrappers(fa)}
        self.launches: dict = {}
        self.steps: dict = {}
        self.inside = 0.0
        self._depth = 0
        self._orig = {}
        for name in ("grant_steps", "drain", "wait_boundary"):
            orig = getattr(tenants_mod.Tenant, name)
            self._orig[name] = orig
            setattr(tenants_mod.Tenant, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        meter = self

        def timed(tenant, *a, **kw):
            if meter._depth:
                return orig(tenant, *a, **kw)
            meter._depth += 1
            before = {k: w.launches for k, w in meter.kernels.items()}
            meter.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(tenant, *a, **kw)
            finally:
                meter.torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                meter._depth -= 1
                meter.inside += dt
                got = meter.launches.setdefault(
                    tenant.name, dict.fromkeys(meter.kernels, 0))
                for k, w in meter.kernels.items():
                    got[k] += w.launches - before[k]
                if name == "grant_steps":
                    meter.steps.setdefault(tenant.name, []).append(dt)

        return timed

    def close(self):
        for name, orig in self._orig.items():
            setattr(self.mod.Tenant, name, orig)


class CkptMeter:
    """Every ``Checkpointer.save`` / ``restore_resharded`` during phase
    25a, timed (the card synced first): (slot, ms) each."""

    def __init__(self, ckpt_mod):
        import torch

        self.mod, self.saves, self.restores = ckpt_mod, [], []
        self._orig = (ckpt_mod.Checkpointer.save,
                      ckpt_mod.Checkpointer.restore_resharded)
        save, restore = self._orig

        def timed_save(ck, tree, name, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save(ck, tree, name, *a, **kw)
            self.saves.append((name, (time.perf_counter() - t0) * 1e3))
            return out

        def timed_restore(ck, template, name, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore(ck, template, name, *a, **kw)
            torch.cuda.synchronize()
            self.restores.append((name, (time.perf_counter() - t0) * 1e3))
            return out

        ckpt_mod.Checkpointer.save = timed_save
        ckpt_mod.Checkpointer.restore_resharded = timed_restore

    def close(self):
        (self.mod.Checkpointer.save,
         self.mod.Checkpointer.restore_resharded) = self._orig


def orc25_configs(tconfig, root: str) -> dict:
    """25a's tenants: bench.py's CNN width (MobileNetV2, bf16 over f32,
    fused SGD, B 512, the host input path, 3 steps an epoch, 2 epochs),
    13a's workload over 2 stages (gpipe, M 4, one epoch of 3 steps), and
    bench.py's LM width at ORC25_LM_LAYERS layers (B 2, T 8192)."""
    import dataclasses

    cnn = res23_config(tconfig, root, "orc_cnn", batch=ORC25_CNN_BATCH,
                       rows=ORC25_CNN_ROWS, eval_every=100)
    pipe = res23_config(tconfig, root, "orc_pipe", batch=ORC25_PP_BATCH,
                        rows=3 * ORC25_PP_BATCH, epochs=1, eval_every=100,
                        mesh=tconfig.MeshConfig(stage=2),
                        num_microbatches=ORC25_PP_M)
    lm = lm18_config("orc_lm", n_layers=ORC25_LM_LAYERS,
                     steps=ORC25_LM_STEPS)
    lm = dataclasses.replace(lm, log_dir=os.path.join(root, "log"),
                             checkpoint_dir=os.path.join(root, "ckpt_lm"))
    return {"cnn": cnn, "pipe": pipe, "lm": lm}


def round_host_s(fleet_path: str, inside: float) -> tuple:
    """The rounds' span seconds from the fleet stream, and the host seconds
    a round spent outside its tenants' work (``inside``: the meter's)."""
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        read_records,
    )

    rounds = [r["dur_s"] for r in read_records(fleet_path)
              if r["kind"] == "span" and r["name"] == "round"]
    return len(rounds), (sum(rounds) - inside) / max(1, len(rounds))


def replay_slices(fleet_path: str) -> dict:
    """Replay a fleet stream's admissions and releases; raises if a slot
    is ever held by two tenants. Returns what is held at the end."""
    from distributed_model_parallel_tpu_torch.utils.telemetry import (
        read_records,
    )

    held: dict = {}
    for r in read_records(fleet_path):
        if r.get("kind") != "tenant":
            continue
        if r["event"] == "admitted":
            ids = set(r["devices"])
            for other, theirs in held.items():
                if ids & theirs:
                    raise RuntimeError(f"{r['name']} admitted onto "
                                       f"{sorted(ids & theirs)} held by "
                                       f"{other}")
            held[r["name"]] = ids
        elif r["event"] in ("preempted", "completed", "failed", "cancelled"):
            held.pop(r["name"], None)
    return held


def orchestrator_one_card(trainer_mod, fs, fa, tconfig, root, card) -> dict:
    """25a (see the module docstring)."""
    import numpy as np
    import torch

    from distributed_model_parallel_tpu_torch import orchestrator as orc
    from distributed_model_parallel_tpu_torch.models import params_to_jax
    from distributed_model_parallel_tpu_torch.orchestrator import tenants
    from distributed_model_parallel_tpu_torch.train import checkpoint

    phase = "25a/orchestrator one card"
    cfgs = orc25_configs(tconfig, root)
    meter = TenantMeter(tenants, fs, fa)
    ckm = CkptMeter(checkpoint)
    slots = orc25_slots(3)
    t0 = time.perf_counter()
    try:
        o = orc.Orchestrator(slots, workdir=os.path.join(root, "fleet"),
                             quantum=1)
        o.submit(orc.TenantSpec(name="pipe", workload="pipeline",
                                config=cfgs["pipe"]))
        o.submit(orc.TenantSpec(name="cnn", workload="cnn",
                                config=cfgs["cnn"]))

        def on_round(o, r):
            if r == 1 and "lm" not in o.tenants:
                o.submit(orc.TenantSpec(name="lm", workload="lm",
                                        config=cfgs["lm"], priority=5))

        summary = o.run(on_round=on_round, max_rounds=100)
        o.close()
    except Exception as e:
        fail(phase, f"{type(e).__name__}: {e}")
    finally:
        meter.close()
        ckm.close()
    wall = time.perf_counter() - t0
    fleet = os.path.join(root, "fleet", "fleet.jsonl")
    n_rounds, host_s = round_host_s(fleet, meter.inside)
    try:
        held = replay_slices(fleet)
    except RuntimeError as e:
        fail(phase, str(e))
    ten = summary["tenants"]
    cnn_t, pipe_t, lm_t = (o.tenants[n] for n in ("cnn", "pipe", "lm"))
    # The preempted tenant against a solo run of its config.
    solo = trainer_mod.Trainer(cfgs["cnn"].replace(
        log_name="orc_cnn_solo",
        checkpoint_dir=os.path.join(root, "ckpt_cnn_solo")))
    solo.fit()
    with torch.no_grad():
        want = params_to_jax(solo.model)
    bitwise = all(np.array_equal(a, b) for a, b in zip(
        _leaves(cnn_t.weights), _leaves(want), strict=True))
    buckets = {"cnn": len(solo.optimizer.buckets)}
    del solo
    runner = pipe_t.trainer.runner
    buckets["pipe"] = sum(len(st.optimizer.buckets) for st in runner.stages)
    want_sgd = {"cnn": ten["cnn"]["global_step"] * buckets["cnn"],
                "pipe": ten["pipe"]["global_step"] * buckets["pipe"]}
    launches = meter.launches
    flash_want = ORC25_LM_LAYERS * ten["lm"]["global_step"]
    # A tenant's step: the grants but its first (warm-up) and its last
    # (the end of fit: eval and the checkpoint).
    step_s = {n: statistics.median(v[1:-1] or v)
              for n, v in meter.steps.items()}
    saves = [ms for name, ms in ckm.saves if name == "preempt"]
    restores = [ms for name, ms in ckm.restores if name == "preempt"]
    grants = [(a["tenant"], a["devices"]) for a in summary["assignments"]]
    states = [(n, t["state"], t["global_step"], t["preemptions"])
              for n, t in ten.items()]
    admit = [(n, round(t.admit_s or 0, 3)) for n, t in o.tenants.items()]
    print(f"orchestrator 25a [{card}]: 3 slots on cuda:0, quantum 1; "
          f"assignments {grants}; states {states}; "
          f"resumes exact {summary['all_resumes_exact']}; the preempted "
          f"cnn tenant bitwise a solo fit {bitwise}; slots held at the end "
          f"{held}; launches {launches} (want fused_sgd {want_sgd}, flash "
          f"{flash_want} each for lm); step s (median, card synced) "
          f"{step_s}; admission s {admit}; "
          f"{n_rounds} rounds, orchestrator host s a round outside the "
          f"tenants' work {host_s}; preempt save ms {saves}, restore ms "
          f"{restores}; wall {wall:.2f} s")
    if summary["unrecovered"] or any(t["state"] != "completed"
                                     for t in ten.values()):
        fail(phase, f"tenants {ten} unrecovered {summary['unrecovered']}")
    if ten["cnn"]["preemptions"] != 1 or not summary["all_resumes_exact"]:
        fail(phase, "the cnn tenant was not preempted once and resumed at "
                    "the exact step")
    if not bitwise:
        fail(phase, "the preempted tenant is not bitwise its solo run")
    if held:
        fail(phase, f"slots still held at the end: {held}")
    for n in ("cnn", "pipe"):
        got = launches[n]
        if got["fused_sgd"] != want_sgd[n] or got["plain_sgd"]:
            fail(phase, f"{n}: launches {got}, want fused_sgd "
                        f"{want_sgd[n]} and no plain_sgd")
    lm_got = launches["lm"]
    if any(lm_got[k] != flash_want for k in flash_wrappers(fa)) or (
            lm_got["fused_sgd"] or lm_got["plain_sgd"]):
        fail(phase, f"lm: launches {lm_got}, want {flash_want} each flash")
    if len(saves) != 1 or len(restores) != 1:
        fail(phase, f"preempt saves {saves}, restores {restores}")
    del o, cnn_t, pipe_t, lm_t, runner
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        assignments=[(a["tenant"], list(a["devices"]))
                     for a in summary["assignments"]],
        tenants={n: dict(steps=t["global_step"], attempts=t["attempts"],
                         preemptions=t["preemptions"],
                         step_s=step_s.get(n), wall_s=sum(
                             meter.steps.get(n, ())))
                 for n, t in ten.items()},
        launches=launches, buckets=buckets, solo_bitwise=bitwise,
        rounds=n_rounds, host_s_per_round=host_s, save_ms=saves,
        restore_ms=restores, wall_s=wall)


def _leaves(tree):
    """The arrays of a nested tuple/dict tree, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def rank_group_tenant(tconfig, root, card) -> dict:
    """25b (see the module docstring)."""
    import torch

    from distributed_model_parallel_tpu_torch import orchestrator as orc

    phase = "25b/rank-group tenant"
    slots = orc25_slots(2, spread=True)
    four = len(set(slots)) == 2
    cfg = res23_config(tconfig, root, "orc_rg", batch=RG25_BATCH,
                       rows=RG25_ROWS, eval_every=100,
                       mesh=tconfig.MeshConfig(data=2))
    admits, grants, overhead = [], [], []
    t0 = time.perf_counter()
    try:
        o = orc.Orchestrator(slots, workdir=os.path.join(root, "fleet_rg"),
                             quantum=1)
        t = o.submit(orc.TenantSpec(name="rg", workload="cnn", config=cfg))

        def on_round(o, r):
            if t.admit_s is not None and (not admits or admits[-1][0]
                                          != t.attempts):
                admits.append((t.attempts, len(t.devices), t.admit_s))
            if t.grant_s:
                grants.extend(t.grant_s)
                overhead.extend(t.grant_overhead_s)
                t.grant_s, t.grant_overhead_s = [], []
            if r == 1:
                o.shrink(1)
            if r > 1 and len(t.devices) == 1 and o.pool.revoked_ids:
                o.grow()

        summary = o.run(on_round=on_round, max_rounds=100)
        o.close()
    except Exception as e:
        fail(phase, f"{type(e).__name__}: {e}")
    wall = time.perf_counter() - t0
    grants.extend(t.grant_s)
    overhead.extend(t.grant_overhead_s)
    rg = summary["tenants"]["rg"]
    sizes = rg["granted_sizes"]
    spawn_s = [s for _, n, s in admits if n == 2]
    rt_us = statistics.median(grants) * 1e6 if grants else None
    baton_us = statistics.median(overhead) * 1e6 if overhead else None
    print(f"orchestrator 25b [{card}]: a dp-2 MobileNetV2 bf16 B "
          f"{RG25_BATCH} tenant on {slots} ("
          f"{'NCCL' if four else 'gloo'}): slices {sizes}, resumes exact "
          f"{rg['resumed_exact_step']}, grow-backs {rg['grow_backs']}, "
          f"steps {rg['global_step']}, replicas' digests "
          f"{len(set(t.replica_digests))} distinct of "
          f"{len(t.replica_digests)}; admission s (attempt, slots, s) "
          f"{admits}; a step grant's round trip across the process "
          f"boundary {rt_us} us, of which no rank was working {baton_us} us "
          f"(medians of {len(grants)} grants to both ranks); wall "
          f"{wall:.2f} s")
    if rg["state"] != "completed" or sizes != [2, 1, 2]:
        fail(phase, f"tenant {rg}")
    if rg["resumed_exact_step"] != [True, True] or rg["grow_backs"] != 1:
        fail(phase, f"resumes {rg['resumed_exact_step']}, grow-backs "
                    f"{rg['grow_backs']}")
    if len(t.replica_digests) != 2 or len(set(t.replica_digests)) != 1:
        fail(phase, f"the replicas differ: {t.replica_digests}")
    torch.cuda.empty_cache()
    return dict(slots=slots, backend="nccl" if four else "gloo",
                granted_sizes=sizes, resumed_exact=rg["resumed_exact_step"],
                steps=rg["global_step"], replicas_bitwise=True,
                spawn_s=spawn_s, admissions=admits,
                grant_round_trip_us=rt_us, grant_baton_us=baton_us,
                grants=len(grants), wall_s=wall)


def a9_rank(spec, root: str) -> dict:
    """25c on each of 4 ranks: MobileNetV2 bf16 B A925_BATCH under gspmd on
    (data 2, model 2) and on (data 4), A925_STEPS steps each on the same
    global batches, cuDNN deterministic; then bench.py's LM width at 2
    layers, T A925_LM_SEQ, on (data 2, dcn_data 2, model 2) and (data 2,
    model 2), A925_LM_STEPS steps each. Losses and digests."""
    import dataclasses
    import hashlib

    import torch

    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch.train import lm_trainer as lm
    from distributed_model_parallel_tpu_torch.train.trainer import Trainer

    laps = RankLaps(spec, "25c")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def digest(tensors):
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {"grid": spec.grid}
    for name, mesh in (("data2_model2", dict(data=2, model=2)),
                       ("data4", dict(data=4))):
        cfg = res23_config(tconfig, root, f"a9_{name}", batch=A925_BATCH,
                           rows=A925_BATCH * A925_STEPS, epochs=1,
                           log_every_n_steps=1, eval_every=100,
                           mesh=tconfig.MeshConfig(**mesh))
        t = Trainer(cfg)
        coords = t.spec.grid
        t.train_epoch(0)
        torch.cuda.synchronize()
        out[name] = dict(
            losses=[r["loss"] for r in t.step_log], grid=coords,
            digest=digest([*t.model.parameters(), *t.model.buffers()]))
        del t
        laps.done(f"cnn {name}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    for name, mesh in (("data2_dcn2_model2", dict(data=2, dcn_data=2,
                                                   model=2)),
                       ("data2_model2", dict(data=2, model=2))):
        cfg = lm18_config(f"a9_lm_{name}", mesh, steps=A925_LM_STEPS,
                          n_layers=2, tp_axis="model")
        cfg = dataclasses.replace(
            cfg, seq_len=A925_LM_SEQ,
            n_tokens=4 * cfg.batch_size * (A925_LM_SEQ + 1),
            log_dir=os.path.join(root, "log"),
            checkpoint_dir=os.path.join(root, f"ckpt_lm_{name}"))
        t = lm.LMTrainer(cfg)
        losses, _ = lm18_steps(t, A925_LM_STEPS)
        out[f"lm_{name}"] = dict(losses=losses, grid=t.spec.grid,
                                 digest=digest(t.leaves))
        del t
        torch.cuda.empty_cache()
        laps.done(f"lm {name}")
    return out


def a9_ranks_gate(res: list, card: str) -> dict:
    """25c's gates: the (data 2, model 2) copies bitwise on every rank,
    its losses against (data 4)'s on the same global batches (bf16); the
    LM's losses on the two meshes (the dcn factor changes no reduction:
    the same ranks form the same data group), and its slices bitwise
    between the replicas of a model index."""
    phase = "25c/A9 on the card"
    cnn = [r["data2_model2"] for r in res]
    flat = [r["data4"] for r in res]
    gap = max(abs(a - b) for a, b in zip(cnn[0]["losses"],
                                         flat[0]["losses"]))
    lm_a = [r["lm_data2_dcn2_model2"] for r in res]
    lm_b = [r["lm_data2_model2"] for r in res]
    lm_same = all(a["losses"] == b["losses"] for a, b in zip(lm_a, lm_b))
    lm_gap = max(abs(x - y) for a, b in zip(lm_a, lm_b)
                 for x, y in zip(a["losses"], b["losses"]))
    by_model: dict = {}
    for a in lm_a:
        by_model.setdefault(a["grid"][2], set()).add(a["digest"])
    print(f"A9 25c [{card}]: MobileNetV2 bf16 B {A925_BATCH} gspmd on "
          f"(data 2, model 2): losses {cnn[0]['losses']}, every rank's "
          f"digest equal {len({c['digest'] for c in cnn}) == 1}; on (data "
          f"4) {flat[0]['losses']}, max |diff| {gap}; the LM (2 layers, T "
          f"{A925_LM_SEQ}) on (data 2, dcn_data 2, model 2) "
          f"{lm_a[0]['losses']}, on (data 2, model 2) {lm_b[0]['losses']}: "
          f"bitwise {lm_same} (max |diff| {lm_gap}); slices per model index "
          f"{ {m: len(d) for m, d in by_model.items()} } distinct digests")
    if len({c["digest"] for c in cnn}) != 1:
        fail(phase, "the copies along the model axis differ")
    if any(c["losses"] != cnn[0]["losses"] for c in cnn):
        fail(phase, "the ranks' losses differ")
    if gap > 1e-2:
        fail(phase, f"(data 2, model 2) vs (data 4): losses differ by {gap}")
    if lm_gap > 1e-3 or any(len(d) != 1 for d in by_model.values()):
        fail(phase, f"the LM's dcn mesh: loss gap {lm_gap}, slices "
                    f"{by_model}")
    if not all(math.isfinite(x) for a in lm_a for x in a["losses"]):
        fail(phase, "non-finite LM losses")
    return dict(cnn_losses=cnn[0]["losses"], cnn_flat_losses=flat[0]["losses"],
                cnn_gap=gap, copies_bitwise=True, lm_losses=lm_a[0]["losses"],
                lm_bitwise=lm_same, lm_gap=lm_gap)


def a9_ride(card: str):
    """Phase 25c as a :class:`RideAlong` of a spawn of four ranks; its
    gated record lands in ``ride.record``."""
    import tempfile

    root = tempfile.mkdtemp(prefix="a9_ranks_", dir=os.environ[RUN_DIR_ENV])
    ride = RideAlong(a9_rank, None, (root,), None)
    ride.record = None

    def gate(results):
        ride.record = a9_ranks_gate(results, card)
        return ride.record

    ride.gate = gate
    return ride


def orchestrator_phase(laps, trainer_mod, fs, fa, tconfig, card,
                       a9: dict) -> dict:
    """Phase 25: 25a and 25b here, beside 25c's record (its ranks rode a
    spawn of four)."""
    import tempfile

    import torch

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="orchestrator_",
                            dir=os.environ[RUN_DIR_ENV])
    one = orchestrator_one_card(trainer_mod, fs, fa, tconfig, root, card)
    laps.done("25a/orchestrator one card")
    rg = rank_group_tenant(tconfig, root, card)
    laps.done("25b/rank-group tenant")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags
    return {"one_card": one, "rank_group": rg, "a9": a9}


class Laps:
    """Prints each phase's seconds since the previous phase ended."""

    def __init__(self):
        self.mark = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.mark:.2f} s")
        self.mark = now


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sgd-timing-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "10, print their JSON line and stop: the phase-10 "
                         "measure run against another checkout's port "
                         "(copy this script into it)")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "13, print the pipeline's JSON line and stop: with "
                         "four cards, each stage of the runner on its own "
                         "card and the SPMD engine over NCCL")
    ap.add_argument("--harness-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "15 (the zoo, resume, resume at two ranks), print "
                         "the harness's JSON line and stop")
    ap.add_argument("--data-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "16 (the finetune recipe at 224 px, the host "
                         "path's prefetch stages, the native gather), print "
                         "the data path's JSON line and stop")
    ap.add_argument("--dp-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "14b at world = device_count() over NCCL, print "
                         "the DP engines' JSON line and stop: with four "
                         "cards, BASELINE's pair (samples/s a card, the "
                         "gradient reduction's us a step) per engine, and "
                         "17e at four ranks")
    ap.add_argument("--optim-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD kernel only) and "
                         "17 (the other optimizers, accumulation, EMA, "
                         "bf16 leaves, fsdp's re-gather, the two-level data "
                         "axis), print the optimizers' JSON line and stop")
    ap.add_argument("--lm-only", action="store_true",
                    help="run phases 1, 2 (the flash kernels only), 6, 18 "
                         "(the LM over a data x model x seq mesh) and 19 "
                         "(the stage and expert axes), print the LM's JSON "
                         "lines and stop: with four cards, 18b and 19b over "
                         "NCCL with a card a rank")
    ap.add_argument("--serve-only", action="store_true",
                    help="run phases 1, 2 (the paged-decode and flash "
                         "forward kernels only), 3-5 (the paged-decode "
                         "kernel and the engine), 20 (generate, "
                         "generate_sharded, the prefix cache and "
                         "speculative decoding), 21 (the engine's "
                         "overload controls and planes) and 22 (the serving "
                         "fleet), print the decode, serve_planes and fleet "
                         "JSON lines and stop: with four cards, 20b over "
                         "NCCL with a card a rank")
    ap.add_argument("--resilience-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD and flash "
                         "kernels) and 23 (the trainers' resilience plane; "
                         "23b in a spawn of four ranks of its own), print "
                         "the resilience JSON line and stop")
    ap.add_argument("--autotune-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD and flash "
                         "kernels) and 24 (the autotuner; 24e in a spawn of "
                         "four ranks of its own: NCCL with four cards, "
                         "where 24a measures alpha and the wire rate), "
                         "print the autotune JSON line and stop")
    ap.add_argument("--orchestrator-only", action="store_true",
                    help="run phases 1, 2 (the fused SGD and flash "
                         "kernels) and 25 (the orchestrator on one card, a "
                         "rank-group tenant, and A9's meshes in a spawn of "
                         "four ranks of its own: NCCL with four cards), "
                         "print the orchestrator JSON line and stop")
    args = ap.parse_args()
    only = (args.sgd_timing_only or args.pipeline_only or args.dp_only
            or args.harness_only or args.data_only or args.optim_only
            or args.lm_only or args.serve_only or args.resilience_only
            or args.autotune_only or args.orchestrator_only)
    import atexit
    import shutil
    import tempfile

    os.environ[RUN_DIR_ENV] = tempfile.mkdtemp(prefix=".chip_smoke_run_",
                                               dir=HERE)
    atexit.register(shutil.rmtree, os.environ[RUN_DIR_ENV], True)
    # -- phase 1: device ----------------------------------------------------
    laps = Laps()
    import torch

    if not torch.cuda.is_available():
        fail("1/device", "torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    try:
        import distributed_model_parallel_tpu_torch as port
    except ImportError as e:
        fail("1/device", f"the port package is not beside this script "
                         f"({e}); run from a checkout of the repository")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail("1/device", f"the port was imported from {port.__file__}, "
                         f"not from this checkout")
    from distributed_model_parallel_tpu_torch.models import (
        transformer as tfm,
    )
    from distributed_model_parallel_tpu_torch.ops import _build
    from distributed_model_parallel_tpu_torch.ops import (
        flash_attention as fa,
    )
    from distributed_model_parallel_tpu_torch.train import (
        lm_trainer as lm,
    )
    from distributed_model_parallel_tpu_torch.utils.profiling import (
        lm_model_flops,
    )
    from distributed_model_parallel_tpu_torch import config as tconfig
    from distributed_model_parallel_tpu_torch import models
    from distributed_model_parallel_tpu_torch.models import staged
    from distributed_model_parallel_tpu_torch.ops import fused_sgd as fs
    from distributed_model_parallel_tpu_torch.train import optim
    from distributed_model_parallel_tpu_torch.train import (
        trainer as cnn_trainer,
    )

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    laps.done("1/device")

    # -- phase 2: build -----------------------------------------------------
    t = time.perf_counter()
    try:
        paths = _build.build_all(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if args.lm_only
            else ("paged_decode", "flash_fwd") if args.serve_only
            else ("fused_sgd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
            if (args.resilience_only or args.autotune_only
                or args.orchestrator_only)
            else ("fused_sgd",) if only else _build.KERNELS)
    except RuntimeError as e:
        fail("2/build", str(e))
    print(f"built {len(paths)} kernel(s) in {time.perf_counter() - t:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning",
                                       "Performance Loss")):
                print(f"  {name}: {line.strip()}")
    laps.done("2/build")
    if args.sgd_timing_only:
        mnv2 = [p.detach() for p in models.get_model(
            tconfig.ModelConfig(), device="cuda").parameters()]
        print(json.dumps({"sgd_timing": time_fused_sgd(
            fs, optim, tconfig, mnv2, card)}))
        laps.done("10/fused sgd timing")
        return
    if args.pipeline_only:
        torch.backends.cudnn.benchmark = True      # as phase 11 leaves it
        print(json.dumps({"pipeline": pipeline_phase(
            laps, models, cnn_trainer, fs, tconfig, card), "card": card}))
        return
    if args.harness_only:
        from distributed_model_parallel_tpu_torch import mesh

        print(json.dumps({"harness": harness_summary(harness_phase(
            laps, cnn_trainer, fs, models, staged, mesh, tconfig, card)),
            "card": card}))
        return
    if args.data_only:
        print(json.dumps({"data_path": data_path_phase(
            laps, cnn_trainer, fs, tconfig, card), "card": card}))
        return
    if args.dp_only:
        from distributed_model_parallel_tpu_torch import mesh

        world = torch.cuda.device_count()
        engines = dp_engines(mesh, card, world, "nccl")
        laps.done("14b/dp engines")
        ranks = optim_ranks(mesh, tconfig, card, world,
                            "nccl" if world >= 4 else "gloo")
        laps.done("17e/ranks")
        print(json.dumps({"dp_engines": engines, "optim_ranks": ranks,
                          "card": card}))
        return
    if args.lm_only:
        from distributed_model_parallel_tpu_torch import mesh

        check_flash(fa)
        laps.done("6/flash")
        lm18 = lm_phase(laps, fa, lm_model_flops, mesh, card, None)
        print(json.dumps({"lm_mesh": lm18_summary(lm18), "card": card}))
        lm19 = lm19_phase(laps, fa, lm_model_flops, mesh, card)
        print(json.dumps({"lm_pipe": lm19_summary(lm19), "card": card}))
        return
    if args.serve_only:
        from distributed_model_parallel_tpu_torch import mesh

        paged = serve_phases(laps, card)
        four = torch.cuda.device_count() >= 4
        dec = gen_phases(laps, mesh, card, "nccl" if four else "gloo")
        planes = planes_phase(laps, card)
        fleet = fleet_phase(laps, card)
        print(json.dumps({"decode": dec, "card": card}))
        print(json.dumps({"serve_planes": planes, "card": card}))
        print(json.dumps({"fleet": fleet, "card": card}))
        print(json.dumps({"kernels": decode_kernel_rows(paged, dec, planes,
                                                        fleet)}))
        return
    if args.resilience_only:
        import tempfile

        from distributed_model_parallel_tpu_torch import mesh

        four = torch.cuda.device_count() >= 4
        res = dp_spawn(mesh, resilience_rank, 4, "23b/resilience ranks",
                       tempfile.mkdtemp(prefix="resilience_ranks_",
                                        dir=os.environ[RUN_DIR_ENV]),
                       backend="nccl" if four else "gloo")
        ranks23 = resilience_ranks_gate(res, card)
        laps.done("23b/resilience ranks")
        print(json.dumps({"resilience": resilience_phase(
            laps, cnn_trainer, fs, fa, tconfig, card, ranks23),
            "card": card}))
        return
    if args.autotune_only:
        from distributed_model_parallel_tpu_torch import mesh
        from distributed_model_parallel_tpu_torch.parallel import pipeline
        from distributed_model_parallel_tpu_torch.train import (
            pipeline_trainer,
        )

        four = torch.cuda.device_count() >= 4
        ride = autotune_ride(tconfig, card, four)
        ride.results = dp_spawn(mesh, autotune_rank, 4, "24e/autotune ranks",
                                *ride.args,
                                backend="nccl" if four else "gloo")
        ride.finish()
        laps.done("24e/autotune ranks")
        print(json.dumps({"autotune": autotune_phase(
            laps, cnn_trainer, pipeline_trainer, models, pipeline, fs, fa,
            tconfig, card, ride.record), "card": card}))
        return
    if args.orchestrator_only:
        import tempfile

        from distributed_model_parallel_tpu_torch import mesh

        four = torch.cuda.device_count() >= 4
        ride = a9_ride(card)
        ride.results = dp_spawn(mesh, a9_rank, 4, "25c/A9 ranks",
                                *ride.args,
                                backend="nccl" if four else "gloo")
        ride.finish()
        laps.done("25c/A9 ranks")
        print(json.dumps({"orchestrator": orchestrator_phase(
            laps, cnn_trainer, fs, fa, tconfig, card, ride.record),
            "card": card}))
        return
    if args.optim_only:
        from distributed_model_parallel_tpu_torch import mesh

        print(json.dumps({"optim": optim_summary(optim_phase(
            laps, cnn_trainer, fs, models, staged, mesh, tconfig, card)),
            "card": card}))
        return

    # -- phases 3-5: the paged-decode kernel, its timing, the engine ------
    paged = serve_phases(laps, card)

    # -- phase 6: flash kernels vs plain --------------------------------------
    flash_errs = check_flash(fa)
    laps.done("6/flash")

    # -- phase 7: flash timing ------------------------------------------------
    flash_times = time_flash(fa, card)
    laps.done("7/flash timing")

    # -- phase 8: trainer at full width ---------------------------------------
    check_training(tfm, lm, fa)
    laps.done("8a/train check")
    flash_launches, lm8_loss = train_full_width(tfm, lm, fa, lm_model_flops,
                                                card)
    laps.done("8b-c/trainer")

    # -- phases 9-10: fused SGD kernels vs plain, timing ----------------------
    mnv2 = [p.detach() for p in models.get_model(
        tconfig.ModelConfig(), device="cuda").parameters()]
    print(f"MobileNetV2 (CIFAR): {len(mnv2)} leaves, "
          f"{sum(p.numel() for p in mnv2)} parameters")
    sgd_err = check_fused_sgd(fs, optim, tconfig, mnv2, card)
    laps.done("9/fused sgd")
    sgd_times = time_fused_sgd(fs, optim, tconfig, mnv2, card)
    del mnv2
    laps.done("10/fused sgd timing")

    # -- phase 11: CNN trainer at full width ----------------------------------
    torch.backends.cudnn.benchmark = True
    print("set torch.backends.cudnn.benchmark=True")
    check_cnn_step(cnn_trainer, models, staged, tconfig)
    laps.done("11a/cnn check")
    sgd_launches, sgd_in_step = train_cnn(cnn_trainer, fs, tconfig, card)
    laps.done("11b-c/cnn trainer")

    # -- phase 12: data parallelism over the port's process group ------------
    from distributed_model_parallel_tpu_torch import mesh

    # 12b, 13b and 13d (and 15c, 17e's fsdp part) ride 14b's spawn of two
    # ranks, 17e's hierarchical part and 18b-c ride 19b's of four
    # (RideAlong: every spawn pays each rank's process start).
    rides2, rides4 = [], []
    dp = data_parallel(mesh, cnn_trainer, tconfig, card, rides2)
    laps.done("12/data parallel")

    # -- phase 13: the pipeline -----------------------------------------------
    pp = pipeline_phase(laps, models, cnn_trainer, fs, tconfig, card, rides2)
    pp_launches = {k: sum(r[k] for r in pp["runner"].values())
                   for k in ("fused_sgd", "plain_sgd")}

    # -- phase 14: ResNet and the remaining data-parallel engines ------------
    torch.backends.cudnn.benchmark = True
    resnet = train_resnet(cnn_trainer, fs, models, staged, tconfig, card)
    laps.done("14a/resnet")
    import tempfile

    two_cards = torch.cuda.device_count() >= 2
    # 15c and, on one card (both over gloo), 17e's fsdp part ride 14b's
    # spawn too; their gates run at 14b and 17e.
    ranks15 = resume_ranks(mesh, tconfig, tempfile.mkdtemp(
        prefix="resume_ranks_", dir=os.environ[RUN_DIR_ENV]), card, rides2)
    fsdp17 = (None if two_cards else
              RideAlong(optim_ranks_rank, None, ("fsdp", False),
                        lambda f: f))
    if fsdp17 is not None:
        rides2.append(fsdp17)
    dpe = dp_engines(mesh, card, 2, "nccl" if two_cards else "gloo", rides2)
    for ride in rides2:
        ride.finish()
    laps.done("14b/dp engines, the rides of 12b, 13b, 13d, 15c, 17e")

    # -- phase 15: the zoo, checkpoint/resume, preemption, logs ------------
    harness = harness_phase(laps, cnn_trainer, fs, models, staged, mesh,
                            tconfig, card, ranks15)

    # -- phase 16: the data path: the finetune recipe, prefetch, gather -----
    data_path = data_path_phase(laps, cnn_trainer, fs, tconfig, card)

    # -- phase 17: optimizers, accumulation, EMA, fsdp, the dcn axis ---------
    opt17 = optim_phase(laps, cnn_trainer, fs, models, staged, mesh, tconfig,
                        card, rides4,
                        fsdp17.results if fsdp17 is not None else None)

    # -- phase 18: the LM over a (data, model, seq) mesh ----------------------
    lm18 = lm_phase(laps, fa, lm_model_flops, mesh, card, lm8_loss, rides4)

    # -- phase 19: the LM's stage and expert axes ---------------------------
    # 23b's, 24e's and 25c's ranks ride 19b's spawn of four too; their
    # records are gated there.
    res23 = resilience_ride(card)
    auto24 = autotune_ride(tconfig, card, torch.cuda.device_count() >= 4)
    a925 = a9_ride(card)
    rides4 += [res23, auto24, a925]
    lm19 = lm19_phase(laps, fa, lm_model_flops, mesh, card, decode=True,
                      rides=rides4)
    lm18_rows = lm_launch_rows(lm18)
    # 20b's ranks ran in 19b's spawn (the spawn is most of 20b's own time).
    sharded_ranks = lm19["mesh"].pop("decode_ranks")
    lm19_rows = lm19_launch_rows(lm19)

    # -- phase 20: generate, generate_sharded, prefix cache, spec ----------
    dec = gen_phases(laps, mesh, card, "gloo", sharded_ranks)

    # -- phase 21: the engine's overload controls and planes ----------------
    planes = planes_phase(laps, card)

    # -- phase 22: the serving fleet ----------------------------------------
    fleet = fleet_phase(laps, card)

    # -- phase 23: the trainers' resilience plane ---------------------------
    resil = resilience_phase(laps, cnn_trainer, fs, fa, tconfig, card,
                             res23.record)

    # -- phase 24: the autotuner ---------------------------------------------
    from distributed_model_parallel_tpu_torch.parallel import pipeline
    from distributed_model_parallel_tpu_torch.train import pipeline_trainer

    auto = autotune_phase(laps, cnn_trainer, pipeline_trainer, models,
                          pipeline, fs, fa, tconfig, card, auto24.record)

    # -- phase 25: the orchestrator, rank-group tenants, A9 ----------------
    orc = orchestrator_phase(laps, cnn_trainer, fs, fa, tconfig, card,
                             a925.record)
    orc_launches = orc["one_card"]["launches"]

    kernels = decode_kernel_rows(paged, dec, planes, fleet)
    for name, line in (("flash_fwd", 112), ("flash_bwd_dq", 199),
                       ("flash_bwd_dkv", 278)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"distributed_model_parallel_tpu_torch/ops/csrc/"
                      f"{name}.cu",
            "replaces": f"distributed_model_parallel_tpu/ops/"
                        f"pallas_attention.py:{line}",
            "launches": flash_launches[name],
            **({"launches_20a_generate":
                dec["generate"]["launches"]["flash_fwd"]}
               if name == "flash_fwd" else {}),
            **lm18_rows[name],
            **lm19_rows[name],
            "launches_23c_resilience": resil["lm"]["launches"][name],
            "launches_24d_autotune_lm": auto["lm"]["launches"][name],
            "launches_25a_orchestrator_lm": orc_launches["lm"][name],
            "max_abs_err": flash_errs[name][0],
            "max_row_rel_err": flash_errs[name][1],
            **flash_times[name],
        })
    for name, line in (("fused_sgd", 64), ("plain_sgd", 80)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "distributed_model_parallel_tpu_torch/ops/csrc/"
                      "fused_sgd.cu",
            "replaces": f"distributed_model_parallel_tpu/ops/"
                        f"pallas_optim.py:{line}",
            "launches": sgd_launches[name],
            "launches_12a_gspmd": dp["gspmd"][f"{name}_launches"],
            "launches_13a_pipeline": pp_launches[name],
            "launches_14a_resnet50": (
                resnet["launches"]["fused_sgd"] if name == "fused_sgd"
                else resnet["launches_momentum0"]["plain_sgd"]),
            "launches_14b_zero_rank0": dpe[
                "zero_fused" if name == "fused_sgd" else
                "zero_momentum0"]["launches"][0][name],
            "launches_15a_zoo": (
                sum(r["launches"]["fused_sgd"]
                    for r in harness["zoo"]["models"].values())
                if name == "fused_sgd" else harness["zoo"][
                    "efficientnetb0_momentum0"]["launches"]["plain_sgd"]),
            "launches_15b_resume": harness["resume"]["launches"][name],
            "launches_13c_pipeline_resume": pp["resume"][name],
            "launches_13d_spmd_resume_per_rank": pp["spmd_resume"][name],
            "launches_16a_finetune": data_path["finetune"][name],
            "launches_17a_optimizers": opt17["optimizers"]["launches"][name],
            "launches_17b_accumulation": opt17["accumulation"][name][
                "launches"],
            "launches_17e_hierarchical_rank0": (
                opt17["ranks"]["hierarchical"]["launches"]
                if name == "fused_sgd" else 0),
            "launches_23a_resilience": resil["single"]["launches"][name],
            "launches_24b_autotune_cnn": auto["cnn"]["launches"][name],
            "launches_24c_autotune_pipeline": (
                auto["pipeline"]["launches"] if name == "fused_sgd" else 0),
            "launches_25a_orchestrator_cnn": orc_launches["cnn"][name],
            "launches_25a_orchestrator_pipeline": orc_launches["pipe"][name],
            "max_abs_err": sgd_err,
            **sgd_times[name],
            "in_step_us": sgd_in_step[name],
        })
    print(json.dumps({"data_parallel": dp, "card": card}))
    print(json.dumps({"pipeline": pp, "card": card}))
    print(json.dumps({"resnet": resnet, "card": card}))
    print(json.dumps({"dp_engines": dpe, "card": card}))
    print(json.dumps({"harness": harness_summary(harness), "card": card}))
    print(json.dumps({"data_path": data_path, "card": card}))
    print(json.dumps({"optim": optim_summary(opt17), "card": card}))
    print(json.dumps({"lm_mesh": lm18_summary(lm18), "card": card}))
    print(json.dumps({"lm_pipe": lm19_summary(lm19), "card": card}))
    print(json.dumps({"decode": dec, "card": card}))
    print(json.dumps({"serve_planes": planes, "card": card}))
    print(json.dumps({"fleet": fleet, "card": card}))
    print(json.dumps({"resilience": resil, "card": card}))
    print(json.dumps({"autotune": auto, "card": card}))
    print(json.dumps({"orchestrator": orc, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
