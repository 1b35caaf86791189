#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It drives ``deeplearning4j_tpu_torch``
only (it imports nothing of JAX or of the JAX package) and exits non-zero
if any phase fails:

1. builds every kernel of the serving and training paths from
   ``deeplearning4j_tpu_torch/csrc`` into ``build/kernels/``, one ``nvcc``
   per source, all started together;
2. ``kernel_vs_plain``: holds the flash-attention forward kernel against
   its plain PyTorch version on the card at the model's attention shape
   and at ``[16, 512, d]`` for every other head_dim the kernels take
   (128, 192, 256) and a ragged ``[16, 100, 64]``, f32 and bf16, causal
   and full;
3. ``bwd_kernel_vs_plain``: the same for the two backward kernels (dq;
   dk and dv), and a second launch of both on the same inputs, which must
   give the same bits; ``wide_head_dim``: head_dim 320, which the
   reference's kernel takes and the port's do not, runs through
   ``flash_attention`` on the card by its shape rule (``sdpa_reference``,
   no kernel launch) and matches the plain forward;
4. ``serve``: serves a full-width TransformerLM (vocab 8192, seq 512,
   embed 512, 8 layers, 8 heads; random weights from the seed) through the
   port's ``ServingEngine`` for requests of 1, 5 and 16 rows, checks the
   rows against the same model on the reference attention path, and checks
   that every served batch launched the forward kernel once per layer;
5. ``train``: trains the same model (integer next-token targets,
   ``sparse_mcxent``, Adam) through ``MultiLayerNetwork.fit`` for 5 steps
   of batch 16 beside a twin on the reference attention path: step-0
   gradients of every parameter and each step's loss agree with the
   twin's, and each of the three kernels launched 8 times per step;
6. ``serve_time``, ``train_time`` and ``kernel_time``: the served batch-16
   request, the forward alone, the median training step (both attention
   paths) with a ``torch.profiler`` split of the step's device time, and
   each kernel beside its plain version, its bound and a PyTorch
   yardstick (``scaled_dot_product_attention``, forward or backward),
   which the port never calls; the backward rows add the pair (dq +
   dk/dv) beside SDPA's backward, which computes all three;
7. ``bn_kernel_vs_plain``: holds the BatchNorm-apply kernel against its
   plain version at every BN geometry of ResNet50 at batch 64 and
   224x224 and at a wide [64, 32768] (a C the first design refused), f32
   and bf16, relu and identity;
8. ``cnn_train``: trains the zoo ResNet50 at its published widths
   (224x224x3, 1000 classes, the full 50-layer graph; random weights from
   the seed) through ``ComputationGraph.fit`` for 5 Nesterovs steps of
   batch 64, f32 with TF32 off, every BatchNormalization at
   ``helper="pallas"``, beside a twin at ``helper=None`` (the unfused
   path): step-0 loss and gradients, each step's loss (the twin starts
   each step from the fused net's params), the running statistics after
   5 steps, the eval outputs of both, and 53 launches of ``bn_apply`` per
   step;
9. ``cnn_train_time`` and the ``bn_apply`` rows of ``kernel_time``: the
   median step of both nets and images/s, a ``torch.profiler`` split of
   the step (convolutions and matrix products / the BN kernel / the rest
   / idle), and the kernel at each geometry beside its plain version, its
   bound and ``torch.addcmul(shift, x, scale)``, which the port never
   calls, each launch after a read of 64 MB that leaves L2 clean;
10. ``lstm_kernel_vs_plain``: holds the LSTM-recurrence kernel against its
    plain version on ``ys``, ``hT`` and ``cT`` at (t, b, h) = (64, 128,
    256), (256, 32, 256), (1, 16, 256) from a nonzero state, the ragged
    (7, 5, 100), (16, 32, 1024) (the grid tier) and (16, 32, the widest h
    the cluster tier takes on this card), within an error bound derived
    from each run's data; each row names its plan and tier, the main
    shape must run on the cluster tier and h = 1024 on the grid tier, and
    a second launch at the main shape must give the same bits;
11. ``lstm_serve`` and ``lstm_train``: the zoo TextGenerationLSTM at its
    width (26 classes, two LSTM-256 layers; random weights from the seed),
    its LSTMs at ``helper="pallas"``, beside a twin at ``helper=None``
    (the plain recurrence on the card) that shares its params: ``output``
    on batch 128 x 64 steps, a 16-character prefix streamed through
    ``rnn_time_step`` and then 48 greedy single-step calls (each call
    timed, beside the twin's on the same characters), and 5 ``fit``
    steps (one-hot next-character labels, Adam 2e-3, clipping at 10;
    step-0 loss and gradients, each step's loss); 2 kernel launches per
    ``output``, per streaming call and per training step;
12. ``lstm_train_time`` and the ``lstm_fwd`` rows of ``kernel_time``: the
    median step of both nets and tokens/s, a ``torch.profiler`` split of
    the step, the batch-128 ``output`` latency, and the kernel at both
    long shapes and at the streaming call's (1, 16, 256) beside its plain
    version, its bound, its time at batch 1 (the serial chain alone) and
    ``torch.nn.LSTM`` (cuDNN) on the same weights, which the port never
    calls; each row names its plan and tier;
13. ``generate``: the full-width TransformerLM (the serve phase's model
    and seeded weights, f32, TF32 off) generates through
    ``ServingEngine(net, generation=GenerationConfig(max_slots=16,
    max_seq=512, block_size=16))``: 24 requests (prompts of 16-384 tokens
    from the seed, 64 new tokens each; 20 greedy, 4 sampled at
    temperature 0.8, top-k 50, top-p 0.95), 8 of them joining a running
    batch; 6 share a 256-token prefix and one extends a prompt that ends
    inside a block.  Every greedy token must be the argmax of a
    teacher-forced ``net.output`` over its own history, except where the
    oracle's top two are within a margin of twice the largest
    engine-vs-oracle log-prob difference measured on the agreeing
    positions (printed, with the ties counted); each sampled request
    alone on a 16-slot engine must give the same stream; prefix hits and
    copy-on-writes must both happen and every block not held by the
    prefix registry must come back; ``stream()`` yields one event per
    token;
14. ``generate_time``: time to first token, the prefill program at
    suffix buckets 128 and 512, the decode step with 16 active slots
    (median, p99), tokens/s over the run, and the decode step driven
    directly (16 slots at position 300) with its device busy share from
    a ``torch.profiler`` trace of 10 steps beside ``decode_bound_ms``;
15. ``generate_rnn``: an EmbeddingSequenceLayer(64) -> 2 x LSTM(256,
    ``helper="pallas"``) -> RnnOutputLayer(96) stack generates 8 greedy
    requests of 48 tokens on 16 slots beside a ``helper=None`` twin with
    its params (streams equal, ties excepted as in 13); every decode step
    launches ``lstm_fwd`` twice, the masked prefill never;
16. ``random_on_card``: the threefry key stream (``utils/_random``) on the
    card gives the CPU's bits: ``split`` and ``fold_in`` of keys from
    ``--seed``, ``bernoulli`` at the dropout masks' own shapes
    (GoogLeNet's [64, 1024], VGG16's [32, 25088] and [32, 4096], the
    TransformerLM's [16, 512, 512]), each draw timed; ``normal`` within
    its stated tolerance;
17. ``zoo_serve``: each of the eight zoo CNNs (LeNet 28x28x1 / 10,
    SimpleCNN 48x48x3 / 10, AlexNet, VGG16, VGG19 and GoogLeNet 224x224x3
    / 1000, InceptionResNetV1 160x160x3 / 1000 with 5/10/5 blocks,
    FaceNetNN4Small2 96x96x3 / 100; random weights from the seed, f32,
    TF32 off) serves a batch of 8 through ``output``; two rows are held
    against the port's own CPU run on the same params; median latency;
18. ``zoo_train``: GoogLeNet (``ComputationGraph``, DropoutLayer 0.4,
    Adam) at batch 64 and VGG16 (MLN, dense dropout 0.5 twice,
    Nesterovs) at batch 32 take 5 ``fit`` steps on one seeded batch with
    dropout on: step-0 loss and gradients against a float64 twin with the
    same params, batch and key (so the same masks), step 0's masks drawn
    on the card equal to the CPU's for that key, every loss finite and the
    5th below the 1st; the path launches no kernel;
19. ``zoo_train_time``: both nets' median step and images/s, a
    ``torch.profiler`` split of the step (convolutions and matrix
    products / other / idle), and the step's model FLOPs (convolutions
    and dense layers, 3x the forward) as a share of the f32 peak
    (67 TFLOP/s without TF32);
20. ``train_dropout``: the full-width TransformerLM of phase 5 with
    input dropout 0.9 on every block, and the same width as an attention
    LM of 8 MultiHeadAttention layers that also drop their output
    (``attn_dropout`` 0.9; the JAX package's TransformerBlock builds its
    attention without it), each 3 ``fit`` steps beside a
    reference-attention twin on the same keys: step-0 gradients and
    losses within phase 5's tolerances, each flash kernel 8 launches per
    step;
21. ``updaters_on_card``: a Dense 256 -> 256 -> 256 -> softmax 10 MLN
    built with ``NeuralNetConfiguration.builder()``, batch 64, under each
    of the 12 updaters for 5 steps (cycling through the 9 schedules), on
    the card and on the CPU from the same params: params within 1e-5 for
    the same gradients, and within max(1e-5, 4x a CPU twin with its
    input features permuted) for training;
    each of the 21 loss names, value and gradient with a mask and unit
    weights, card vs CPU within 1e-5;
22. ``early_stop_lstm``: the char-LSTM of phases 10-12 built with the
    builder (both LSTMs at ``helper="pallas"`` with DropConnect(0.9),
    MaxNorm(1.0) on the output W, RmsProp(StepSchedule(2e-3, 0.5, 8)))
    trained by ``EarlyStoppingTrainer`` (at most 4 epochs of 8 batches,
    patience 1, ``DataSetLossCalculator`` on 2 held-out batches,
    ``InMemoryModelSaver``; Score/CollectScores/Performance listeners),
    then ``best.evaluate(held_out)``, beside a ``helper=None`` twin:
    scores, best epoch, reason, confusion matrices (ties excepted), the
    column norms after every step, and 2 ``lstm_fwd`` launches per step
    and per held-out or evaluation batch; the ``fit`` step with and
    without listeners;
23. ``fit_on_device_lm``: the TransformerLM of phase 5 under
    AdamW(WarmupSchedule(4, 3e-4), weight decay 0.01), 8 x 16 sequences
    on the card: ``fit_on_device`` for 2 fused epochs, then one epoch on
    the per-epoch path with a listener and a ragged tail of 8, beside a
    reference-attention twin (the same permutations); 8 launches per
    flash kernel per step; the step against ``fit`` over the same
    batches;
24. ``transfer_resnet``: ResNet50 at its published widths, every BN at
    ``helper="pallas"``, through ``TransferLearning.GraphBuilder``
    (frozen through ``s2b5_out``, a new 10-class output on ``avgpool``,
    Nadam(1e-3)), 5 steps at batch 64 beside a ``helper=None`` twin:
    frozen params and running statistics bit-equal before and after,
    losses within 1e-5, ``bn_apply`` once per trained BN per step (the
    frozen BNs run in inference mode and launch none);
25. ``precision_lm``: the TransformerLM of phase 5 under
    ``precision("bfloat16")``, 5 Adam steps beside an f32 twin from the
    same params: step-0 loss within a tolerance derived from the JAX
    package's own bf16-vs-f32 gap, masters and updater slots f32 after
    each step, each flash kernel 8 bf16 launches a step; both step times
    and device busy shares; one batch-16 request served by a bf16 copy
    of the trained net;
26. ``loss_scale_f16``: the same LM under ``PrecisionPolicy(compute_dtype
    ="float16", loss_scale="dynamic", initial_scale=2**40)``: every
    skipped step leaves params, updater slots and counts bit-equal and
    halves the scale, ``overflow_steps`` counts the skips, the first
    finite step and 3 more train (f16 flash launches); a cut CPU twin's
    skip count beside the card's; then the char-LSTM trained by tBPTT
    (4 chunks of 16, batch 128) under ``precision("float16")`` with 1e30
    in chunk 1: one skip, 2 ``lstm_fwd`` launches per chunk;
27. ``remat_memory``: the LM in f32 with and without
    ``cache_mode("remat")``, 3 steps each from the same params: losses
    and params bitwise equal, 16 forward launches per remat step; the
    analytic ``memory_report``'s params plus updater slots against the
    allocator's growth when the net is made; the peak of a step with
    and without remat and under bf16 beside the report's total;
28. ``resnet_bf16``: ``ResNet50(compute_dtype="bfloat16")`` at
    224x224x3, batch 64, every BN at ``helper="pallas"``, 5 steps: 53
    f32 ``bn_apply`` launches a step (BN is in ``keep_f32``), running
    statistics f32, step 0 against the f32 twin; then one step with
    ``keep_f32=()``: 53 bf16 launches, each held against the plain
    version;
29. ``int8_kv``: the generation engine of phase 13 with the int8 paged
    KV pool beside the f32 pool: codes and scales card vs CPU bitwise,
    int8 cache bytes at most half, greedy streams equal outside at most
    one request in each group of three, the 16-slot decode step of both;
30. ``solvers_eval``: LBFGS, CG and line gradient descent on the MLN of
    phase 21, card vs CPU twin (first three scores within 1e-5, the final
    no worse than the CPU's + 1e-4), then ``EvaluationBinary`` and
    ``EvaluationCalibration`` of the trained outputs, counts equal to
    the CPU's;
31. ``checkpoint_resume``: the LM of phase 5 with block dropout 0.9
    trains 6 steps through ``fit`` with a ``CheckpointConfig`` saving
    every 3 steps in the background; a fresh network resumes from the
    step-3 directory (``fit(resume_from=...)``) and runs steps 4-6 only.
    Its params, Adam moments and counts and key are bitwise equal to
    those of the run that went on to step 6, and so are a run's without
    checkpoints (``resume_gate``: checkpointing is an observer); 8
    launches per flash kernel a step in both runs; the checkpoint's bytes, the snapshot's stall of its step, the
    write seconds and MB/s, and the write's encode and deflate spans;
32. ``observability``: the same LM served (two requests), trained 4
    steps and generating 2 x 8 tokens with a fresh registry: the
    Prometheus text parses and the step, example and token counters equal
    the work done; 3 steps each sampled and traced alone by
    ``torch.profiler``: the step profiler's device slice lies between the
    trace's CUDA time and the step's wall, its MFU is ``lm_step_flops`` /
    (slice x the H100 peak) with the FLOPs from a card file, and the
    tracer's span (bridged by ``record_function``) is in the trace; the
    step time with everything on against ``DL4J_TPU_STEPPROF=0`` with
    the registry and recorder off (reported, not gated); a
    ``FaultInjector`` makes a decode step raise and the engine's
    ``decode`` flight dump reads back with its checksum.
33. ``serving_http``: the LM of phase 5 behind ``ServingServer`` with
    16 generation slots, over 127.0.0.1: two one-row ``/predict``
    requests (a full-vocabulary row is ~21 MB of JSON in, ~85 MB out)
    within 1e-5 of ``net.output`` with 8 forward launches per batch, the
    request split into client encode, round trip, client decode, the
    engine's queue wait / batch formation / execute, and the server's
    JSON decode, validation, H2D, forward (CUDA events), D2H and JSON
    encode replayed on the same bytes; the in-process batch-16 predict
    split stage by stage; 16 concurrent ``/generate`` requests (8
    streamed) whose greedy tokens equal an in-process
    ``GenerationEngine``'s, each stream whole, with TTFT and tokens/s; a
    queue-limited engine's 429 with ``Retry-After`` counted in
    ``serving_shed_total``; ``/metrics`` with the ``serving_*``,
    ``generation_*`` and ``http_*`` families; ``/health`` on ``gpu``; and
    ``/reload`` of phase 31's checkpoint directory, after which every
    ``/generate`` reports the new version only;
34. ``hot_swap_lstm``: the char-LSTM of phases 10-12 (``lstm_fwd``)
    served from a checkpoint directory that the engine watches, while 4
    clients post ``/predict`` and ``fit(checkpoint=...)`` of the same
    network commits a checkpoint every 4 of 12 steps: no failed
    request, every response within 1e-5 of the output of the version it
    reports and farther from every other, versions never backwards per
    client, 2 ``lstm_fwd`` launches per fit step and served batch;
35. ``inference_server``: the char-LSTM behind ``InferenceServer`` over
    ``ParallelInference``, BATCHED and INPLACE, 8 concurrent one-row
    requests: rows within 1e-5 of ``net.output``, 2 launches per
    forward;
36. ``fleet``: ``ServingFleet`` of 2 replicas of the LM on the card,
    8 generation slots each: 2 one-row predicts through
    ``FleetRouter.predict`` (8 launches each, rows within 1e-5), a noisy
    tenant shed past its quota while a polite one's requests all equal
    the single-replica greedy oracle, a 10 % canary that promotes with
    versions never backwards, a replica killed once each of 4 sessions
    has relayed 8 tokens (every stream, migrated or not, equal to the
    oracle; the re-prefill time), and one stream through ``FleetServer``;
37. ``knn``: ``NearestNeighborsServer`` over ``BruteForceNN`` with
    100,000 x 128 f32 points on the card: 256 queries of k = 10 over
    HTTP and at once, indices equal to a float64 brute force outside
    ties within the f32 rounding bound (``knn_violations``);
38. ``parallel_lm``: a one-rank NCCL process group on the card (the
    port's ``initialize_distributed``); from the same weights, 5 steps of
    the full-width LM through plain ``fit``, ``ParallelWrapper``,
    ``ParallelWrapper(shard_optimizer_state=True)`` and
    ``ShardedTrainer``: the wrapped runs equal each other and plain
    ``fit`` bitwise (params, updater slots, counts, key; at dp 1 every
    leaf replicates and the world-1 exchange computes plain ``fit``'s
    ops), 8 launches per kernel per step each; ``per_device_param_bytes``
    of the layout plan at dp 1, 2, 4 and 8 (a computation).  At world
    size 1 ``zero3_spec`` replicates every leaf, so ``ShardedTrainer``
    here (and ``launches_sharded_lm`` in the ``kernels`` line) runs the
    replicated layout: no all-gather and no reduce-scatter.  Those run
    over NCCL in ``chip_ranks.py`` on four cards;
39. ``sharded_checkpoint_lm``: ``ShardedTrainer.save_sharded`` at step 3
    (``topology.json`` + ``shards-p00.npz``; bytes, write seconds), a
    fresh net's ``restore_sharded`` continued to step 6 bitwise equal to
    the uninterrupted run, and ``ServingEngine.promote_latest`` of the
    sharded directory serving rows equal to ``net.output`` (8 forward
    launches a batch);
40. ``elastic_lm``: ``ElasticTrainer(save_freq=2)`` over a
    ``ShardedTrainer`` crashes after step 5; a fresh process's trainer
    resumes from step 4 and runs to step 8, bitwise equal to the
    uninterrupted 8 steps (steps lost, restore seconds);
41. ``sparse_embedding_lm``: the LM with ``sparse_grad=True`` on its
    embedding, Zipf-distributed ids: 5 SGD steps within 1e-6 of the dense
    twin, then 5 Adam steps after which untouched rows and their mu/nu
    are bit-identical to step 0 (rows touched per step, step times);
42. ``masters_lm``: ``ParameterAveragingTrainingMaster`` with 2 thread
    replicas on the card, averaging every 2 of 8 batches (the averaged
    params equal the mean of the replicas by hand), then
    ``SharedGradientsTrainingMaster`` with the host threshold/bitmap codec
    (every message plus its residual equals the raw update within one
    rounding; encoded bytes per message against the dense bytes, and
    whether the g++ codec built);
43. ``moe_lm``: the Switch-MoE TransformerLM at full width (the LM of
    phase 5 with every block's MLP 8 top-1 routed experts, capacity
    factor 1.25: 1280 slots an expert for 16 x 512 tokens; ~151 M
    params, f32, TF32 off, Adam 3e-4) trains 5 steps beside its
    reference-attention twin: losses within ``TOL_MOE_LOSS``, 8 launches
    of each flash kernel per step, the aux term in the loss (against an
    aux-weight-0 twin), the tokens routed to another expert than the
    twin's per layer (``routing_flips_per_layer``); then served through
    ``ServingEngine`` in requests of 1, 5 and 16 rows, each row equal to
    ``net.output`` of the padded batch it was served in, 8 forward
    launches a batch.  Printed: step ms, device busy share, peak
    allocated bytes, and the dispatch and combine einsums' time (forward
    and backward, timed alone at the layer's shapes) as a share of the
    step;
44. ``model_axes_solo``: on a one-rank NCCL group, every model-axis
    entry point at one rank against the computation without it: ring
    attention (within ``TOL_SOLO_RING``) and Ulysses (bitwise, also over
    the flash kernel) on a seq axis of one, ``gpipe`` with one stage
    (outputs and gradients), ``moe_ffn`` over a one-rank expert axis,
    and ``ParallelWrapper(param_rule=megatron_dense_rule)`` at tp 1
    against plain ``fit`` for 5 steps of an MLP (its Megatron pair) and
    of the full-width LM (8 launches per kernel per step), bitwise;
45. ``keras_vgg16``: the zoo VGG16 (224x224x3, 1000 classes; random
    weights from the seed) exported by ``export_keras_sequential`` in
    memory (~553 MB; bytes and seconds printed), loaded back through
    ``VGG16().pretrained(path)`` (the HDF5 branch: ``import_keras_model``
    and ``import_pretrained``'s transplant; seconds printed): a batch of 8
    ``TrainedModels.VGG16``-preprocessed images within ``TOL_KERAS_VGG``
    of the source net's outputs, and the same top-5 ImageNet decoding
    (ties within twice the error excepted); the batch-8 forward's time;
46. ``keras_resnet50_finetune``: the zoo ResNet50 at its published
    widths exported by ``export_keras_model`` and imported back by
    ``import_keras_model`` (the importer's ``Sgd(0.01)``); every
    BatchNormalization at ``helper="pallas"`` beside a ``helper=None``
    twin with the imported params: step-0 loss and gradients
    (``bn_twin_grad_check``, phase 8's tolerances) and 3 ``fit`` steps
    of batch 64 (the twin restarted each step from the fused net's
    params), 53 ``bn_apply`` launches per step; ``fold_batch_norms`` of
    the fine-tuned net in eval: its logits and pooled features within
    ``TOL_KERAS_FOLD`` of the unfolded net's, its probabilities within
    half the logits' difference;
47. ``keras_char_lstm``: the char-LSTM of phases 10-12 exported and
    imported back (sigmoid gates), both LSTMs at ``helper="pallas"``:
    ``output`` on batch 128 x 64 against a ``helper=None`` twin (the
    first LSTM's sequence within ``lstm_error_bound``), 2 ``lstm_fwd``
    launches per call; the same net exported with ``hard_sigmoid`` gates
    and imported at ``helper="pallas"``: 0 launches
    (``pallas_lstm.supports`` refuses the cell), equal to its twin;
48. ``activations_on_card``: every activation name and the
    parameterized forms on a [4096, 1024] card tensor holding the kinks
    (0, ±1, ±2.5, 6, 0.5), values and gradients against the CPU within
    ``TOL_ACT_REL``, and the tie gradients of hardtanh, relu6 and
    hardsigmoid (0.5, and 0.5 x 0.2) exactly.
49. ``masters_mp_lm``: the full-width LM under ``MultiprocessMaster`` with
    2 worker processes on the card and the ``TcpMessageBroker`` hub in
    this process.  Averaging (frequency 2, 8 batches): each averaged frame
    the mean of the two up-frames by hand (0.0), the parent's params the
    last frame bit for bit, 8 launches of each flash kernel a step in
    every worker's result; the same with worker 1 killed in round 1
    (``retried_workers == {1}``, within ``TOL_MP_RETRY`` of the fault-free
    run, bitwise printed); shared gradients with the host codec (every
    worker applied exactly what its peer declared, the final tables within
    ``agreement_tol``); ``evaluate`` (accuracy equal to the parent's) and
    ``score`` (within ``TOL_MP_SCORE``) fanned out.  Printed: each
    worker's spawn-to-first-step seconds and peak bytes, round seconds,
    frame and message bytes, hub frames a second;
50. ``tcp_broker_interop``: a port hub here and a port client in another
    process carrying ``RemoteGradientSharing`` messages; every frame
    received equals the one sent, bit for bit, and decodes to it;
51. ``pretrain_rbm_stack``: the DL4J examples' DeepAutoEncoderExample RBM
    stack (784 -> 1000 -> 500 -> 250 -> 100 -> 30, CD-1, binary units,
    Sgd) on MNIST-shaped binary rows of batch 1000: one CD step of layer
    0 on the card against the CPU twin from the same key (Gibbs-sample
    flips counted and printed; the gradients within ``TOL_CD_REL`` of the
    largest plus the differing rows' share), then
    ``pretrain(MultipleEpochsIterator(2, ...))`` with a listener that
    checks that each iteration moves the params of the layer being
    pretrained and of no other, and 3 ``fit`` steps of the mirrored
    decoder to 784 (sigmoid, xent); every loss finite;
52. ``vae_mnist``: the DL4J examples' VariationalAutoEncoderExample VAE
    (784 inputs, encoder and decoder (256, 256), latent 2, leaky ReLU,
    Bernoulli reconstruction, RmsProp(1e-3), l2 1e-4, batch 128): 20
    pretraining steps, each loss within ``TOL_VAE_LOSS`` of the CPU
    twin's from the same key; ``generate_at_mean_given_z`` on a 20 x 20
    latent grid and ``reconstruction_probability`` (16 samples, 1000
    rows) against the CPU from the same params and key;
53. ``tiny_yolo_voc``: Tiny YOLOv2 (tiny-yolo-voc.cfg, 416x416x3, 13x13
    cells, 5 VOC anchors, 20 classes) as a ComputationGraph with every
    BatchNormalization at ``helper="pallas"``: ``bn_apply`` against its
    plain version at the 7 BN shapes; step-0 loss and gradients against
    the ``helper=None`` twin (``bn_twin_grad_check``); 3 Adam steps of
    batch 16 on synthetic boxes (8 ``bn_apply`` launches a step, the
    twin restarted each step from the net's params); step time, images
    a second, the profiler's busy share and ``device_memory_stats`` (peak
    bytes); a served batch of
    8 through ``output``, ``get_predicted_objects`` and
    ``non_max_suppression`` (no launch: inference normalises with the
    running statistics); and ``check_graph_gradients`` in float64 on the
    card on a 2-conv stack with a YOLO head.  Phases 51-53 print their
    seconds together;
54. ``cifar_pipeline_resnet50``: the five CIFAR-10 training batch files
    written from the seed in the published 3073-byte record format
    (50,000 records, 153.65 MB; ``CIFAR_DIR`` for this process), decoded
    by the native ``decode_cifar`` (the library must build; its rate and
    the numpy twin's printed); the zoo ResNet50 at 32x32x3, 10 classes,
    published widths, f32, every BN at ``helper="pallas"``, batch 128
    with a random crop (pad 4) and flip, cuDNN deterministic: 10 ``fit``
    steps fed by the host iterator with the transform composed in this
    process, then 10 from the same params fed by
    ``build_input_pipeline(num_workers=4, depth=2)``.  Every batch on the
    card bitwise equal to the host batch of the same number, losses,
    params and running statistics bitwise equal, 53 ``bn_apply``
    launches a step in both, and while the workers run, no process but
    this one on the card (``nvidia-smi --query-compute-apps`` lists one
    process, the same as before the workers started, and no worker pid)
    and no CUDA library mapped into a worker (``/proc/<pid>/maps``).
    Printed:
    step time (median), images a second, the profiler's busy share,
    ``training_etl_seconds`` per stage and the starved counts, peak
    device memory, for both runs;
55. ``mnist_lenet_records``: MNIST's 60,000 training images and labels
    as IDX files from the seed; ``MnistDataSetIterator`` feeds the zoo
    LeNet through ``build_input_pipeline(num_workers=0, depth=2)`` for
    20 steps, losses and params bitwise equal to the host-fed twin's; a
    ``RecordReaderDataSetIterator`` over a 100,000 x 20 CSV (through
    ``parse_csv``) feeds a 3-layer MLP for 5 steps, losses equal to the
    same MLP fed the arrays; no kernel launches;
56. ``clustering``: ``KMeans(k=100)`` on 100,000 x 128 f32 points (100
    Gaussian blobs from the seed), k-means++ and 20 Lloyd steps on the
    card, steps 0, 1, 10 and 19 each held against the CPU and float64
    from the same input centers (assignments equal to the CPU's outside
    ties by value, the refreshed centers and the cost within
    ``TOL_KM_CENTERS`` of float64; the cost printed);
    ``BaseClusteringAlgorithm`` with an ``OptimisationStrategy`` on the
    same points, its first and last steps held the same way (and the
    per-cluster distances within the f32 expansion's bound), splits
    applied; exact ``Tsne`` on 5,000 x 50, perplexity 30, 300 iterations
    on the card (KL, a step's time), P on 1 row in 9 and the gradient,
    KL and update of steps 0, 260 and 299 against the CPU from the
    card's inputs (``TOL_TSNE_*``); ``BarnesHutTsne`` at n 1,000 for 5
    iterations (kNN and calibration on the card, the SPTree on the
    host).  Phases 54-56 print their seconds together;
57. ``word2vec``: the JAX package's ``word2vec_words_per_sec``
    configuration (its ``utils/benchmarks.py``: 20,000 Zipf(1.3)
    sentences of 20 words over 5,000 words, skip-gram NS, layer 128,
    window 5, negative 5, seed 1, one epoch) through ``Word2Vec`` on the
    card, the bulk path with the native ``index_corpus`` (the library
    must build), the process's TF32 switch on: a cold fit and the median
    of 3 re-fits (words/s, each clock closed by a sync), every re-fit's
    tables bitwise equal to the first; a profiled fit (kernel launches a
    dispatch block, the card's busy share); the first block re-run whole
    on the card (bitwise) and its first ``W2V_TWIN_STEPS`` steps against
    the CPU in f32 and f64 (within ``W2V_FLOOR_K`` times the f32 floor);
    ``_table_add``'s dense and scatter branches timed at this shape; then
    CBOW-NS, skip-gram HS, CBOW HS, PV-DBOW, PV-DM with ``infer_vector``
    and GloVe on a cut of the corpus, each against its CPU twins the same
    way; and a fit of ~71,000 words at layer 300 on the scatter branch
    (distinct words counted first), fitted twice (bitwise) and its first
    block held the same way;
58. ``word2vec_processes``: ``Word2VecProcessMaster`` with 2 worker
    processes on the card against ``train_word2vec_distributed``'s
    threads (``TOL_W2V_WORKERS``), no JAX or JAX-package module in any
    worker; a full model written and read back resumes training to the
    bits of the model it was written from; the text and binary vector
    files read back;
59. ``deepwalk``: DeepWalk (one walk a vertex) and Node2Vec (walks from
    the first ``N2V_START_VERTICES`` start vertices) on a seeded
    synthetic graph of BlogCatalog's size (10,312 vertices, 333,983
    edges), walk length 40, window 10, layer 128: words/s, HS blocks,
    launches a block, busy share.  Phases 57-59 print their seconds
    together;
60. ``ui_train``: the full-width TransformerLM trains 5 Adam steps of
    batch 16 with a ``ui.StatsListener`` (frequency 1) writing to a
    ``FileStatsStorage`` that a ``UIServer`` serves and, through a
    ``RemoteUIStatsStorageRouter``, to a second ``UIServer``'s
    ``/remote``: each flash kernel 8 times a step; every recorded
    statistic of every param and update against a host recomputation
    from a copy of the same params (histograms exact with the
    listener's f32 formula in numpy, scalars within ``TOL_UI_SCALAR`` of
    float64); one device-to-host copy a listened step more than an
    unlistened one (raw kineto events); 5 points from ``/overview`` and
    ``/param/<name>`` on both servers; ``load_model_guess`` on the log
    gives the same records; the device memory keys set; the step with
    and without the listener and the card's busy share;
61. ``kafka_serve``: that LM saved by ``write_model`` and read back by
    ``load_model_guess``; 4 batches of 16 x 512 ids published through
    ``NDArrayKafkaClient`` (v2 record batches) to an in-process
    ``MiniKafkaBroker``, a group consumer runs ``output`` and publishes
    the probabilities to a second topic, whose reader gets them equal
    to ``output`` bitwise; 8 forward launches a batch; CRC-32C on the
    native codec; batches/s and the round trip's share in the CRC and
    the codec;
62. ``lstm_generate``: ``generate_tokens`` on the zoo char-LSTM
    (``helper="pallas"``), batch 32, a 16-character prompt and 128 new
    tokens, greedy and at temperature 0.8, against a ``helper=None``
    twin with its params (streams equal, ties excepted as in 13), 2
    ``lstm_fwd`` launches a step, tokens/s; ``ServeRoute`` over the TCP
    hub serving its ``output`` on batch 128 x 64 (2 launches a batch,
    rows equal to a direct call); 64 greedy tokens after a 448-token
    prompt on the trained LM, no flash launch (generation attends
    through ``sdpa_reference``, as in JAX), equal to its
    reference-attention twin's.  Phases 60-62 print their seconds
    together.
63. ``captured_fit``: the full-width TransformerLM (batch 16, Adam 3e-4,
    f32, TF32 off) trains 20 steps through ``fit``, whose step is one CUDA
    graph (``nn/compile_cache.StepGraphs``: the first step eager on the
    capture stream, the second captured, then replays), beside a copy
    from the same weights whose step the phase calls directly and
    eagerly: losses, params and Adam slots after 20 steps (gap
    ``TOL_CAPTURED``); ``training_compile_total{fn=train_step}`` 1 for
    the 20 steps and exactly 1 more for a ragged final batch of 8; one
    replay traced with ``torch.profiler`` holds 8 ``flash_attn_fwd``, 8
    ``flash_attn_bwd_dq`` and 8 ``flash_attn_bwd_dkv``, equal to the
    launch counters' replay delta; median step, busy share and kernel
    launches a step, captured against eager; the step at
    ``DL4J_TPU_DISPATCH_DEPTH`` 1 and 2; the capture's seconds and each
    copy's peak memory; then the same check over 5 steps of the zoo
    char-LSTM (``helper="pallas"``, batch 128 x 64).

Phases 2, 3 and the ``kernel_time`` rows run f32, bf16 and f16.  Each
phase prints one JSON line (phases 17-20 one per model).  Every number
printed is this run's, beside the card's name and power limit.  Then come the
card's name and power limit, the ``kernels`` record (the line before the
last) and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC_DIR = "deeplearning4j_tpu_torch/csrc"

# The model's width: TransformerLM as the repo benchmarks it
# (utils/benchmarks.py transformer_lm_step_time).
VOCAB, SEQ, EMBED, LAYERS, HEADS = 8192, 512, 512, 8, 8
MAX_BATCH = 16
REQUEST_SIZES = (1, 5, 16)
HEAD_DIM = EMBED // HEADS
# the kernels vs plain beyond the model's shape: every other head_dim the
# kernels take, and a ragged t (not a multiple of any tile)
CHECK_SHAPES = ((16, 512, 128), (16, 512, 192), (16, 512, 256),
                (16, 100, 64))
# a head_dim the reference's Pallas kernel takes and the port's kernels do
# not: flash_attention sends it to sdpa_reference by its shape rule
WIDE_HEAD_DIM_SHAPE = (2, 8, 512, 320)
TRAIN_BATCH = 16
TRAIN_STEPS = 5
TIMED_TRAIN_STEPS = 20

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM rate and the
# operation rate for each kind of work.  Work shaped as matrix products
# (attention, the LSTM's recurrent product) can be done at f32 accuracy
# on the tensor cores in three TF32 passes, 495 / 3 = 165 TFLOP/s: the
# least time the card could take for it in f32.  Elementwise f32 work
# runs on the CUDA cores, 67 TFLOP/s.  bf16 and f16 products: 989
# TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float32_products": 495e12 / 3,
                  "bfloat16": 989e12, "float16": 989e12}

# Kernel vs plain twin, same inputs on the card.  Both widen to f32 and
# keep f32 statistics; only the order of the f32 sums differs (FMA
# chains in the kernel, cuBLAS tiles in the twin), which moves O by a
# few f32 ulps at |O| <= ~4: 1e-4 abs.  In bf16 the two f32 results are
# rounded to bf16 separately, and one bf16 ulp at |O| ~ 2 is 2**-7
# (7.8e-3): 2e-2 abs.  f16 carries three more bits: one f16 ulp at
# |O| < 4 is at most 2**-9 (2e-3): 4e-3 abs, tighter than bf16's.  lse
# stays f32 in every dtype: 1e-4 abs.
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
TOL_LSE = 1e-4
# Backward kernels vs plain twin, as max |kernel - plain| / max |plain|
# per gradient: dk and dv sum over up to 512 queries, so an absolute
# bound would have to follow their magnitude.  f32: the sums differ in
# order only, ~1e-6 of the largest entry: 1e-5.  bf16: the f32 results
# are rounded to bf16 separately, one ulp (2**-8 of the leading power of
# two) apart at most, and the widened bf16 inputs feed both sides
# alike: two ulps of the largest entry, 1.6e-2.  f16: one f16 ulp is at
# most 2**-10 of an entry; two of the largest entry, 2e-3.
TOL_BWD = {"float32": 1e-5, "bfloat16": 1.6e-2, "float16": 2e-3}
# Served rows vs the same model with attn_impl="reference" (f32, TF32
# off): the two differ by f32 summation order only (attention, and the
# matmul shapes of a padded batch).  A probability p moves by about
# p * (logit error); logits of order 10 carry f32 reordering error of
# order 1e-5, and p <= 1: 1e-5 abs.
TOL_SERVE = 1e-5
# Training, flash path vs reference-attention twin, f32 without TF32.
# Step-0 gradients: per parameter, max |flash - reference| within 1e-4
# of that parameter's largest |g| plus 1e-6 of the largest |g| of the
# whole net.  The attention sums run in another order (~1e-6 relative),
# and the mha_bk gradients are 0 in exact arithmetic (the softmax
# ignores a per-row shift): their entries are f32 noise on both sides,
# which only the net-wide term bounds.  Losses: each of the 5 steps
# within 1e-5 relative of the twin's.  The loss is a sum over 8192 tokens
# of ~9 nats, whose f32 reordering is ~1e-7 relative; Adam moves every
# parameter by about lr per step whatever |g| is, so an entry whose
# gradient is noise (mha_bk, which the loss does not see) takes steps of
# either sign on the two sides without moving the loss.
TOL_GRAD_LEAF, TOL_GRAD_NET = 1e-4, 1e-6
TOL_TRAIN_LOSS = 1e-5
# precision_lm: the bf16 LM's step-0 loss against its f32 twin on the
# same params and batch.  Derived on the CPU from the JAX package's own
# bf16-vs-f32 gap (tests/test_torch_precision.py::
# test_chip_bf16_loss_gate_is_derived_from_the_jax_gap): at embed 64, 2
# layers, seq 64, batch 8 it stays under BF16_GAP_SMALL over four seeds
# (measured 1.9e-4).  bf16 rounding errors of independent terms grow about
# as the square root of the terms summed, depth x width: 8/2 layers x
# 512/64 wide is x5.7 at full width; times a margin of 2.5: 3.5e-3.
BF16_GAP_SMALL = 2.5e-4
TOL_BF16_LM_LOSS = BF16_GAP_SMALL * (8 / 2 * 512 / 64) ** 0.5 * 2.5
PROFILED_STEPS = 3

TIMED_RUNS = 30
SERVE_TIMED_RUNS = 10

# ResNet50 as the JAX package's bench.py trains it: published widths,
# batch 64 (cut from bench.py's 256 to leave room for the twin), f32.
CNN_BATCH, CNN_STEPS, CNN_TIMED_STEPS = 64, 5, 20
CNN_EVAL_ROWS = 16
# BN apply, kernel vs plain version on the same inputs.  The kernel
# rounds once (f32 FMA), the plain version twice (x·scale, then + shift):
# apart by at most half an ulp of |x·scale| plus half an ulp of |y|, so
# within 2**-23 of max(|x·scale| + |shift|).  bf16: both round the f32
# result once more, and may land one bf16 ulp (2**-7 of |y|) apart; f16
# one f16 ulp (2**-10 of |y|).
BN_TOL_F32, BN_TOL_BF16 = 2.0 ** -23, 2.0 ** -23 + 2.0 ** -7
BN_TOL_F16 = 2.0 ** -23 + 2.0 ** -10
# beside ResNet50's geometries: a BN over 32,768 channels, which
# ``pallas_bn.supports`` admits (the door takes C up to 131,072 in f32)
BN_WIDE_GEOMETRY = (64, 32768, "relu")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


# GPU clock cycles (~0.5 ms) the card spins ahead of a call timed with
# ``spin``, so that the host has enqueued the call before the start event
# fires.  Without it an idle card records the start event at once and
# the time includes the host's Python and ctypes launch work (10-25 µs a
# call beside an H100), which the port pays on every launch: ``ms`` keeps
# it, and ``ms_device_only`` is the same call timed with the spin.
SPIN_CYCLES = 1_000_000


def median_ms(fn, torch, runs: int = TIMED_RUNS, before=None,
              spin: bool = False) -> float:
    """Median of ``runs`` single calls, each between CUDA events, host
    launch work included.  With ``spin`` the card reaches the start event
    only after a spin, so the host's enqueue of the call is hidden.
    ``before()`` runs ahead of each call, outside the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, rate: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[rate] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(kernel: str, bh: int, t: int, d: int, causal: bool,
                       dtype: str) -> tuple:
    """Least time for one call of ``kernel`` at ``[bh, t, d]``: inputs
    read once, outputs written once; operations per live (query, key)
    pair (causal counts the t(t+1)/2 live pairs):
      fwd    reads q, k, v; writes O, lse;        4·d (two products)
      bwd_dq reads q, k, v, dO, lse, D; writes dq; 6·d (S, dP, dS·K)
      bwd_dkv reads the same; writes dk, dv;      8·d (S, dP, Pᵀ·dO, dSᵀ·Q)
    """
    elem = 4 if dtype == "float32" else 2
    mat = bh * t * d * elem
    row = bh * t * 4
    nbytes, per_pair = {"fwd": (4 * mat + row, 4),
                        "bwd_dq": (5 * mat + 2 * row, 6),
                        "bwd_dkv": (6 * mat + 2 * row, 8)}[kernel]
    pairs = t * (t + 1) // 2 if causal else t * t
    rate = "float32_products" if dtype == "float32" else dtype
    return _bound(nbytes, per_pair * d * bh * pairs, rate)


def bn_bound_ms(m: int, c: int, dtype: str) -> tuple:
    """Least time for one BN-apply call on an [m, c] tensor: x read and y
    written once, scale and shift read once; one multiply-add (2
    operations) per element on the CUDA cores."""
    elem = 4 if dtype == "float32" else 2
    return _bound(2 * m * c * elem + 2 * c * elem, 2 * m * c, "float32")


def bn_geometries(conf, batch: int):
    """``{(rows, channels, activation): count}`` of the BatchNorm layers
    of a graph configuration at ``batch``."""
    from collections import Counter
    geo = Counter()
    for name in conf.topological_order:
        lc = getattr(conf.vertices[name], "layer", None)
        if type(lc).__name__ != "BatchNormalization":
            continue
        shape = conf.vertex_input_types[name][0].shape(batch)
        m = 1
        for d in shape[:-1]:
            m *= d
        geo[(m, shape[-1], lc.resolved("activation", "identity"))] += 1
    return geo


def seeded_params(spec, seed: int):
    """JAX-layout numpy param tree for ``spec`` ({layer: {name: (shape,
    dtype)}}): xavier-normal matrices, small biases, unit LN gains."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tree = {}
    for key, group in spec.items():
        tree[key] = {}
        for name, (shape, _) in sorted(group.items()):
            if len(shape) == 2:
                std = (2.0 / (shape[0] + shape[1])) ** 0.5
                arr = rng.standard_normal(shape) * std
            elif name.startswith("ln") and name.endswith("_g"):
                arr = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                arr = 0.02 * rng.standard_normal(shape)
            tree[key][name] = arr.astype(np.float32)
    return tree


MATMUL_TAGS = ("gemm", "cutlass", "xmma", "sm90_", "nvjet")
# kernel classes of a step's device time: (class, name substrings), the
# first match wins; anything else is "other"
LM_KERNEL_CLASSES = (("flash_attn_fwd", ("flash_fwd_kernel",)),
                     ("flash_attn_bwd_dq", ("flash_bwd_dq_kernel",)),
                     ("flash_attn_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                     ("matmul", MATMUL_TAGS))
CNN_KERNEL_CLASSES = (("bn_apply", ("bn_apply_kernel",)),
                      ("conv_and_matmul", MATMUL_TAGS + (
                          "conv", "cudnn", "implicit", "wgrad", "dgrad",
                          "fprop")))


def profile_steps(torch, net, batches, classes) -> dict:
    """Device time per training step by kernel class, from a
    ``torch.profiler`` trace of ``len(batches)`` ``fit`` steps.  The wall
    time of the profiled steps includes the profiler's own host overhead;
    the caller sets the device time against the unprofiled step time for
    the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_class = {name: 0.0 for name, _ in classes}
    per_class["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        key = ev.key.lower()
        cls = next((name for name, tags in classes
                    if any(t in key for t in tags)), "other")
        per_class[cls] += us / 1e3
    n = len(batches)
    return {"steps": n, "profiled_wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": {k: v / n for k, v in per_class.items()},
            "device_ms_total_per_step": sum(per_class.values()) / n}


def ptxas_report(log: str) -> list:
    """``"<kernel><mangled template arguments>: Used N registers, ..."``
    per compiled kernel instance of an ``nvcc -Xptxas -v`` log."""
    out, entry = [], "?"
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            # the kernel's length-prefixed name, then its template arguments
            for k in re.finditer(r"(?=(\d\d?)([a-z]\w*?_kernel)I(\w+?)EEv)",
                                 entry):
                if int(k.group(1)) == len(k.group(2)):
                    entry = f"{k.group(2)}<{k.group(3)}>"
                    break
        elif "Used" in ln and "registers" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
    return out


def build_all(kernel_build, sources) -> dict:
    """Build every source at once (one nvcc each); returns per-source
    seconds and the ptxas register lines."""
    def one(src):
        t0 = time.perf_counter()
        lib = kernel_build.build(src)
        return src, {"seconds": round(time.perf_counter() - t0, 3),
                     "ptxas": ptxas_report(
                         lib.with_suffix(".log").read_text())}

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources))


# ResNet50 training, fused (helper="pallas") vs unfused twin, f32 with
# TF32 off; the twin starts each step from the fused net's params.
# - Losses (a mean over 64 rows of −log p): the two paths round each BN
#   output differently, ~1 f32 ulp, which moves the loss by ~1e-7
#   relative: 1e-5.
# - Running statistics after 5 steps: EMAs of batch statistics taken at
#   the same params, apart by that rounding (~1e-6 relative): 1e-5 of
#   each stat's largest entry.
# - Eval outputs (probabilities <= 1): 1e-4 abs.
# - Step-0 gradients.  At initialisation this 50-layer BN network
#   amplifies rounding enormously: the unfused path run on the same batch
#   with its rows reversed (the same loss in exact arithmetic, rounded
#   otherwise in every BN and weight-gradient sum) moves the gradient by
#   ~3 % in relative L2.  That reordered run is the noise floor: the fused
#   gradients must differ from the unfused ones by at most 2x its relative
#   L2 over the net, and per parameter by at most 4x its largest
#   difference on that parameter plus 1e-6 of the net's largest |g|.
CNN_GRAD_NOISE_K, CNN_GRAD_LEAF_K, CNN_TOL_GRAD_NET = 2.0, 4.0, 1e-6
CNN_TOL_LOSS = 1e-5
CNN_TOL_STATE = 1e-5
CNN_TOL_EVAL = 1e-4

# The char-LSTM as the repo benchmarks it (utils/benchmarks.py
# char_lstm_step_time): the zoo TextGenerationLSTM, 26 classes, two
# LSTM-256 layers, batch 128 x 64 steps, f32.
LSTM_CLASSES, LSTM_HIDDEN, LSTM_T, LSTM_BATCH = 26, 256, 64, 128
LSTM_STEPS, LSTM_TIMED_STEPS = 5, 20
STREAM_BATCH, STREAM_PREFIX = 16, 16
# kernel vs plain: (t, b, h, f, nonzero initial state)
# (None: the widest h the cluster tier takes on this card, found by the
# planner; h = 1024 takes the grid tier)
LSTM_CHECK_SHAPES = ((64, 128, 256, 256, False), (256, 32, 256, 256, False),
                     (1, 16, 256, 256, True), (7, 5, 100, 26, True),
                     (16, 32, 1024, 64, True), (16, 32, None, 64, True))
LSTM_GRID_H = 1024
LSTM_TIME_SHAPES = ((64, 128, 256), (256, 32, 256), (1, 16, 256))
# Probabilities of the helper net vs its plain twin (f32, TF32 off).  The
# two differ only in the order of the recurrence's 256-term sums: h by
# ~1e-6 (lstm_kernel_vs_plain measures it in the same run).  The output
# layer's 256-term sums, |W| <~ 0.15 (xavier, std 0.084), move a logit by
# at most 256 * 0.15 * 1e-6 ~ 4e-5, and a probability p by at most twice
# that times p <= 1: 1e-4 abs.  The same bound holds between the streamed
# outputs and ``output`` over the same characters, which differ in the
# same way (another plan and projection shape per call).  Where the two
# nets' probabilities differ by at most e everywhere, their greedy
# choices can differ only where the top two are within 2·e: the twin,
# fed the same characters, must pick the same character at every other
# step (e measured in this run; the steps within 2·e are counted).
TOL_LSTM_OUT = 1e-4
# Training, helper net vs twin: the helper's backward differentiates the
# plain recurrence at the same saved inputs, so the two differ only by the
# forward's rounding (~1e-6 relative): step-0 gradients within 1e-4 of
# each leaf's largest |g| plus 1e-6 of the net's; losses (per row a sum
# over 64 steps of ~3.3 nats, averaged over 128 rows) within 1e-5
# relative.
TOL_LSTM_GRAD_LEAF, TOL_LSTM_GRAD_NET = 1e-4, 1e-6
TOL_LSTM_LOSS = 1e-5
LSTM_KERNEL_CLASSES = (("lstm_fwd", ("lstm_fwd_kernel",
                                     "lstm_fwd_cluster_kernel")),
                       ("matmul", MATMUL_TAGS))


def lstm_error_bound(torch, x, W, U, b, h0, c0) -> float:
    """A bound on |kernel - plain| for ``ys``, ``hT`` and ``cT`` from these
    inputs (f32 on both sides; they differ only in the order of the sums).

    Per step, each side computes every z = xz + Σ_k h_k·U[k, j] with H + 1
    roundings, so each is within γ_{H+1}·S of the exact value (Higham's
    bound, γ_n = n·u / (1 - n·u), u = 2⁻²⁴), S = max |xz| + Σ_k |h_k||U_kj|:
    the two within e_z = 2·γ_{H+1}·S.  The gates are Lipschitz (sigmoid
    with 1/4, tanh with 1) and the two sides' expf / tanhf may differ by a
    few ulps of 1 (2⁻²¹ allowed): each gate value within e_g = e_z + 2⁻²¹.
    Then c' = f·c + i·g moves by at most |f||δc| + |c||δf| + |g||δi| +
    |i||δg| <= f·|δc| + (|c| + 2)·e_g (|i|, |g| <= 1), and h = o·tanh(c)
    by at most |δc| + e_g.  So, unit by unit, the c error after step t is
    at most B_t·e_g with B_t = f_t·B_{t-1} + |c_{t-1}| + 2, B_{-1} = 0: it
    grows through c, damped by the forget gate it passes, and the bound
    is (max_t B_t + 1)·e_g.  It leaves out the feedback of δh into the
    next step's z through U; the measured error, orders of magnitude
    below the bound, shows that feedback does not amplify it here.  S, f
    and c are taken from a plain f32 run of the recurrence on these
    inputs."""
    t, h = x.shape[1], U.shape[0]
    u = 2.0 ** -24
    gamma = (h + 1) * u / (1 - (h + 1) * u)
    xz = x @ W + b
    ua = U.abs()
    hh, cc = h0, c0
    s_max, b_max = 0.0, 0.0
    grow = torch.zeros_like(c0)      # B_t, in units of e_g
    for s in range(t):
        s_max = max(s_max, (xz[:, s].abs() + hh.abs() @ ua).max().item())
        zi, zf, zo, zg = (xz[:, s] + hh @ U).chunk(4, dim=-1)
        f = torch.sigmoid(zf)
        grow = f * grow + cc.abs() + 2
        cc = f * cc + torch.sigmoid(zi) * torch.tanh(zg)
        hh = torch.sigmoid(zo) * torch.tanh(cc)
        b_max = max(b_max, grow.max().item())
    e_g = 2 * gamma * s_max + 2.0 ** -21
    return (b_max + 1) * e_g


def lstm_bound_ms(t: int, b: int, h: int) -> tuple:
    """Least time for one ``lstm_fwd`` launch: xz [t, b, 4h], U [h, 4h],
    h0 and c0 read once, ys [t, b, h], hT and cT written once, all f32;
    per step and row, the [h] x [h, 4h] product (8h² operations), the 4h
    adds of xz, the cell's 4h multiply-adds and 5h sigmoids and tanhs,
    all counted at the f32 rate of products (three TF32 passes)."""
    nbytes = 4 * (t * b * 4 * h + 4 * h * h + 2 * b * h + t * b * h
                  + 2 * b * h)
    return _bound(nbytes, t * b * h * (8 * h + 13), "float32_products")


def lstm_phases(args, torch, dev, card):
    """Phases 10-12 (char-LSTM).  Returns ``(the lstm_fwd kernels record,
    None)``, or ``(None, what failed)``."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        _stack_loss)
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl

    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)

    def lstm_inputs(t, b, h, f, nonzero):
        x = torch.randn((b, t, f), generator=gen, device=dev)
        W = torch.randn((f, 4 * h), generator=gen, device=dev) \
            * (2 / (f + 4 * h)) ** 0.5
        U = torch.randn((h, 4 * h), generator=gen, device=dev) \
            * (2 / (5 * h)) ** 0.5
        bias = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
        h0, c0 = ((torch.randn((b, h), generator=gen, device=dev) * 0.5)
                  if nonzero else torch.zeros((b, h), device=dev)
                  for _ in range(2))
        return x, W, U, bias, h0, c0

    # ---- 10. LSTM kernel vs plain ----------------------------------------
    lstm_err, tiers = 0.0, {}
    widest = next(h for h in range(LSTM_GRID_H, 0, -1)
                  if pl.device_plan(32, h, 16, dev).tier == "cluster")
    for t, b, h, f, nonzero in LSTM_CHECK_SHAPES:
        h = widest if h is None else h
        args6 = lstm_inputs(t, b, h, f, nonzero)
        got = pl.lstm_forward(*args6)
        again = pl.lstm_forward(*args6) if (t, b, h) == (LSTM_T, LSTM_BATCH,
                                                         LSTM_HIDDEN) \
            else None
        want = pl.lstm_forward_plain(*args6)
        torch.cuda.synchronize()
        tol = lstm_error_bound(torch, *args6)
        errs = {}
        for name, g, w in zip(("ys", "hT", "cT"), got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                return None, f"lstm_fwd {name} at {(t, b, h)}: shape " \
                             f"{tuple(g.shape)} or not finite"
            errs[name] = (g - w).abs().max().item()
        p = pl.device_plan(b, h, t, dev)
        tiers[f"{t}x{b}x{h}"] = p.tier
        row = {"phase": "lstm_kernel_vs_plain", "t": t, "batch": b,
               "hidden": h, "features": f, "nonzero_state": nonzero,
               "tier": p.tier, "plan": p.__dict__, "max_abs_err": errs,
               "tol": tol}
        if again is not None:
            row["second_launch_bitwise_equal"] = all(
                torch.equal(a, g) for a, g in zip(again, got))
        print(json.dumps(row), flush=True)
        if max(errs.values()) > tol:
            return None, (f"lstm_fwd disagrees with plain at (t, b, h) = "
                          f"{(t, b, h)}: {errs} > {tol}")
        if row.get("second_launch_bitwise_equal") is False:
            return None, (f"lstm_fwd's second launch at {(t, b, h)} differs "
                          "from the first")
        # the main shape and the widest h on clusters, h = 1024 on the grid
        must = "cluster" if again is not None else \
            {LSTM_GRID_H: "grid", widest: "cluster"}.get(h, p.tier)
        if p.tier != must:
            return None, (f"lstm_fwd at {(t, b, h)} planned on the {p.tier} "
                          f"tier, expected {must}")
        lstm_err = max(lstm_err, *errs.values())
        del args6, got, want, again

    # ---- 11a. serve and stream -------------------------------------------
    zoo = TextGenerationLSTM(num_classes=LSTM_CLASSES, timesteps=LSTM_T,
                             hidden=LSTM_HIDDEN, seed=args.seed)

    def build(helper):
        conf = zoo.conf()
        for lc in conf.layers:
            if isinstance(lc, LSTM):
                lc.helper = helper
        return MultiLayerNetwork(conf, device=dev)

    net = build("pallas").init()
    twin = build(None).load_params({
        k: {n: p.detach().cpu().numpy() for n, p in g.items()}
        for k, g in net.params.items()})
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 6)

    def onehot(ids):
        return F.one_hot(ids, LSTM_CLASSES).float()

    def ifog_to_cudnn(a):
        """Gate blocks IFOG (the port's order) -> IFGO (cuDNN's), dim 0."""
        i, f, o, g = a.chunk(4, dim=0)
        return torch.cat((i, f, g, o))

    x_serve = onehot(torch.randint(0, LSTM_CLASSES, (LSTM_BATCH, LSTM_T),
                                   generator=dgen, device=dev))
    torch.cuda.synchronize()
    pl.reset_launches()
    probs = net.output(x_serve)
    torch.cuda.synchronize()
    output_launches = pl.launches["lstm_fwd"]
    want = twin.output(x_serve)
    out_err = (probs - want).abs().max().item()

    prefix = torch.randint(0, LSTM_CLASSES, (STREAM_BATCH, STREAM_PREFIX),
                           generator=dgen, device=dev)
    def timed(fn):
        """fn() and its milliseconds, host clock, closed by a sync."""
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    pl.reset_launches()
    outs = [net.rnn_time_step(onehot(prefix))]
    fed = [prefix]
    nxt = outs[0][:, -1].argmax(-1)
    call_ms = []
    for _ in range(LSTM_T - STREAM_PREFIX):
        fed.append(nxt[:, None])
        step, ms = timed(lambda: net.rnn_time_step(onehot(nxt)))
        call_ms.append(ms)
        outs.append(step[:, None])
        nxt = step.argmax(-1)
    torch.cuda.synchronize()
    stream_launches = pl.launches["lstm_fwd"]
    stream_calls = 1 + LSTM_T - STREAM_PREFIX
    text = torch.cat(fed, dim=1)
    streamed = torch.cat(outs, dim=1)
    # the twin, fed the same characters
    twin.rnn_clear_previous_state()
    touts = [twin.rnn_time_step(onehot(prefix))]
    twin_call_ms = []
    for c in fed[1:]:
        step, ms = timed(lambda: twin.rnn_time_step(onehot(c[:, 0])))
        twin_call_ms.append(ms)
        touts.append(step[:, None])
    tstreamed = torch.cat(touts, dim=1)
    stream_err = (streamed - tstreamed).abs().max().item()
    # greedy choices: from the last prefix output on
    choice = streamed[:, STREAM_PREFIX - 1:].argmax(-1)
    tchoice_p = tstreamed[:, STREAM_PREFIX - 1:]
    top2 = tchoice_p.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * stream_err
    differ = (tchoice_p.argmax(-1) != choice)
    mismatches = int((differ & ~tie).sum().item())
    ties = int(tie.sum().item())
    whole = net.output(onehot(text))
    whole_err = (whole - streamed).abs().max().item()
    print(json.dumps({
        "phase": "lstm_serve", "model": {
            "name": "TextGenerationLSTM", "classes": LSTM_CLASSES,
            "hidden": LSTM_HIDDEN, "layers": "LSTM, LSTM, RnnOutputLayer",
            "dtype": "float32", "helper": "pallas",
            "num_params": net.num_params()},
        "output": {"batch": LSTM_BATCH, "t": LSTM_T,
                   "max_abs_err_vs_twin": out_err,
                   "kernel_launches": output_launches,
                   "expected_launches": 2},
        "stream": {"batch": STREAM_BATCH, "prefix": STREAM_PREFIX,
                   "single_steps": LSTM_T - STREAM_PREFIX,
                   "calls": stream_calls,
                   "max_abs_err_vs_twin": stream_err,
                   "greedy_choices": int(choice.numel()),
                   "choices_differing_from_twin": mismatches,
                   "ties_within_2x_err": ties,
                   "max_abs_err_vs_output_of_the_text": whole_err,
                   "kernel_launches": stream_launches,
                   "expected_launches": 2 * stream_calls,
                   "single_step_call_ms_median":
                       statistics.median(call_ms),
                   "twin_single_step_call_ms_median":
                       statistics.median(twin_call_ms),
                   "card": card},
        "tol": TOL_LSTM_OUT}), flush=True)
    if output_launches != 2 or stream_launches != 2 * stream_calls:
        return None, (f"lstm_fwd launched {output_launches} times for one "
                      f"output and {stream_launches} for {stream_calls} "
                      "streaming calls; expected 2 per call")
    if probs.shape != (LSTM_BATCH, LSTM_T, LSTM_CLASSES) or \
            not bool(torch.isfinite(probs).all()) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-4:
        return None, f"char-LSTM output shape {tuple(probs.shape)} or rows"
    if out_err > TOL_LSTM_OUT or stream_err > TOL_LSTM_OUT or \
            whole_err > TOL_LSTM_OUT:
        return None, (f"char-LSTM outputs differ: output vs twin {out_err}, "
                      f"stream vs twin {stream_err}, stream vs output "
                      f"{whole_err} (tol {TOL_LSTM_OUT})")
    if mismatches:
        return None, (f"{mismatches} greedy characters differ from the "
                      "twin's outside a tie")
    del probs, want, whole, streamed, tstreamed

    # ---- 11b. train ------------------------------------------------------
    seqs = torch.randint(0, LSTM_CLASSES, (LSTM_STEPS, LSTM_BATCH,
                                           LSTM_T + 1),
                         generator=dgen, device=dev)
    batches = [(onehot(s[:, :-1]), onehot(s[:, 1:])) for s in seqs]
    grads, loss0 = [], []
    for m in (net, twin):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss = _stack_loss(m.conf, params, *batches[0], train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss, [params[k][n] for k, n in keys]))))
        loss0.append(loss.item())
    net_max = max(g.abs().max().item() for g in grads[1].values())
    worst_ratio, worst_name = 0.0, ""
    for key, g in grads[0].items():
        w = grads[1][key]
        err = (g - w).abs().max().item()
        tol = TOL_LSTM_GRAD_LEAF * w.abs().max().item() \
            + TOL_LSTM_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return None, (f"step-0 gradient {key} helper vs twin: {err} > "
                          f"{tol}")
        if err / tol >= worst_ratio:
            worst_ratio, worst_name = err / tol, "/".join(key)
    del grads

    snaps = []
    torch.cuda.synchronize()
    pl.reset_launches()
    t0 = time.perf_counter()
    step_losses = []
    for x, y in batches:
        snaps.append([p.detach().clone() for p in net.parameters()])
        net.fit(x, y)
        step_losses.append(net._score)     # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = pl.launches["lstm_fwd"]
    losses = [float(v) for v in step_losses]
    twin_losses = []
    for snap, (x, y) in zip(snaps, batches):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        twin.fit(x, y)
        twin_losses.append(twin.get_score())
    del snaps
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))
    print(json.dumps({
        "phase": "lstm_train", "model": {
            "name": "TextGenerationLSTM", "batch": LSTM_BATCH, "t": LSTM_T,
            "dtype": "float32", "updater": "Adam(learning_rate=2e-3)",
            "gradient_normalization": "clipelementwiseabsolutevalue 10",
            "loss": "mcxent", "helper": "pallas"},
        "steps": LSTM_STEPS, "step0_loss": loss0, "losses": losses,
        "twin_losses": twin_losses, "max_rel_loss_diff": loss_diff,
        "tol_loss": TOL_LSTM_LOSS,
        "step0_grad_worst_err_over_tol": worst_ratio,
        "step0_grad_worst_param": worst_name,
        "tol_grad": [TOL_LSTM_GRAD_LEAF, TOL_LSTM_GRAD_NET],
        "kernel_launches": train_launches,
        "expected_launches": 2 * LSTM_STEPS,
        "seconds": round(train_s, 4)}), flush=True)
    if train_launches != 2 * LSTM_STEPS:
        return None, (f"lstm_fwd launched {train_launches} times in "
                      f"{LSTM_STEPS} steps; expected 2 per step")
    if not all(np.isfinite(losses + twin_losses)) or \
            loss_diff > TOL_LSTM_LOSS:
        return None, (f"char-LSTM losses {losses} vs twin {twin_losses}: "
                      f"{loss_diff} > {TOL_LSTM_LOSS}")

    # ---- 12. times -------------------------------------------------------
    models = {"pallas": net, "plain": twin}
    step_ms = {"pallas": [], "plain": []}
    for m in models.values():
        for x, y in batches[:2]:
            m.fit(x, y)
    torch.cuda.synchronize()
    for name in ("plain", "pallas", "pallas", "plain"):
        for i in range(LSTM_TIMED_STEPS // 2):
            x, y = batches[i % LSTM_STEPS]
            t1 = time.perf_counter()
            models[name].fit(x, y)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t1) * 1e3)
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    splits = {}
    for name, m in models.items():
        split = profile_steps(torch, m, batches[:PROFILED_STEPS],
                              LSTM_KERNEL_CLASSES)
        busy = split["device_ms_total_per_step"] / med[name] \
            if split["device_ms_total_per_step"] else None
        split["device_busy_share"] = busy
        split["device_idle_share"] = None if busy is None else 1 - busy
        splits[name] = split
    out_ms = {name: median_ms(lambda: m.output(x_serve), torch)
              for name, m in models.items()}
    tokens = LSTM_BATCH * LSTM_T
    print(json.dumps({"phase": "lstm_train_time", "batch": LSTM_BATCH,
                      "t": LSTM_T, "steps_per_net": LSTM_TIMED_STEPS,
                      "step_ms_median": med["pallas"],
                      "tokens_per_s": tokens / med["pallas"] * 1e3,
                      "plain_step_ms_median": med["plain"],
                      "plain_tokens_per_s": tokens / med["plain"] * 1e3,
                      "step_ms": step_ms, "profile": splits["pallas"],
                      "plain_profile": splits["plain"],
                      "output_batch128_ms": out_ms["pallas"],
                      "plain_output_batch128_ms": out_ms["plain"],
                      "card": card}), flush=True)
    del net, twin, models, batches, x_serve

    timings = {}
    for t, b, h in LSTM_TIME_SHAPES:
        f = h
        x, W, U, bias, h0, c0 = lstm_inputs(t, b, h, f, False)
        p = pl.device_plan(b, h, t, dev)
        xz = pl.input_projection(x, W, bias)
        ys = torch.empty((t, b, h), device=dev)
        hT, cT = torch.empty((b, h), device=dev), torch.empty((b, h),
                                                                device=dev)
        # straight through the binding: timing launches are not counted
        kern = median_ms(lambda: pl._launch(xz, U, h0, c0, ys, hT, cT, p),
                         torch)
        kern_dev = median_ms(lambda: pl._launch(xz, U, h0, c0, ys, hT, cT,
                                                p), torch, spin=True)
        with_proj = median_ms(lambda: pl._launch(
            pl.input_projection(x, W, bias), U, h0, c0, ys, hT, cT, p),
            torch)
        # the serial chain alone: the same t and h at batch 1
        p1 = pl.device_plan(1, h, t, dev)
        x1, h01, c01 = x[:1], h0[:1], c0[:1]
        xz1 = pl.input_projection(x1, W, bias)
        ys1 = torch.empty((t, 1, h), device=dev)
        hT1, cT1 = torch.empty((1, h), device=dev), torch.empty((1, h),
                                                                 device=dev)
        serial = median_ms(lambda: pl._launch(xz1, U, h01, c01, ys1, hT1,
                                              cT1, p1), torch)
        plain = median_ms(lambda: pl.lstm_forward_plain(x, W, U, bias, h0,
                                                        c0), torch, runs=10)
        # cuDNN on the same weights: gates IFOG -> IFGO, b_hh = 0
        lib = torch.nn.LSTM(f, h, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifog_to_cudnn(W.t()))
            lib.weight_hh_l0.copy_(ifog_to_cudnn(U.t()))
            lib.bias_ih_l0.copy_(ifog_to_cudnn(bias))
            lib.bias_hh_l0.zero_()
            lib_y = lib(x, (h0[None], c0[None]))[0]
            lib_err = (lib_y - ys.transpose(0, 1)).abs().max().item()
            lib_ms = median_ms(lambda: lib(x, (h0[None], c0[None])), torch)
        bound, bound_by = lstm_bound_ms(t, b, h)
        timings[(t, b, h)] = (kern, plain, lib_ms, bound, bound_by,
                              with_proj, kern_dev)
        tiers[f"{t}x{b}x{h}"] = p.tier
        print(json.dumps({"phase": "kernel_time", "kernel": "lstm_fwd",
                          "t": t, "batch": b, "hidden": h, "features": f,
                          "tier": p.tier, "plan": p.__dict__,
                          "batch_1_plan": p1.__dict__, "ms": kern,
                          "ms_device_only": kern_dev,
                          "ms_with_projection": with_proj,
                          "serial_ms_at_batch_1": serial,
                          "plain_ms": plain, "library_ms": lib_ms,
                          "library_call": "torch.nn.LSTM (cuDNN), "
                                          "projection included",
                          "library_max_abs_diff": lib_err,
                          "bound_ms": bound, "bound_by": bound_by,
                          "card": card}), flush=True)
        del x, xz, ys, lib
    kern, plain, lib_ms, bound, bound_by, with_proj, kern_dev = \
        timings[LSTM_TIME_SHAPES[0]]
    return {"name": "lstm_fwd", "route": "cuda",
            "source": f"{SRC_DIR}/{pl.SOURCE}",
            "replaces": "deeplearning4j_tpu/ops/pallas_lstm.py:51",
            "launches": train_launches, "max_abs_err": lstm_err,
            "ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms,
            "ms_device_only": kern_dev, "ms_with_projection": with_proj,
            "launches_by_path": {"output": output_launches,
                                 "stream": stream_launches,
                                 "fit": train_launches},
            "tier_by_shape": tiers,
            "per": "one launch at t 64, batch 128, h 256; plain_ms and "
                   "library_ms include the input projection, as "
                   "ms_with_projection does"}, None


def bn_twin_grad_check(torch, net, twin, x, y):
    """Step-0 loss and gradients of every parameter of a graph with fused
    BN (``net``) against its unfused twin on one batch, within the
    ``CNN_GRAD_*`` tolerances; and the unfused twin once more on the batch
    in reverse row order: the same loss in exact arithmetic (BN statistics
    and the loss are means over rows), rounded otherwise in every BN and
    every weight-gradient sum.  That pair is the f32 noise floor of each
    gradient here.  Returns ``({loss0, worst_ratio, worst_name, rel,
    grad_rel_l2}, None)`` or ``(None, what failed)``."""
    from deeplearning4j_tpu_torch.nn.computation_graph import _graph_loss
    grads, loss0 = [], []
    for m, xb, yb in ((net, x, y), (twin, x, y), (twin, x.flip(0),
                                                  y.flip(0))):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss, _ = _graph_loss(m.conf, params, m.state, [xb], [yb],
                              train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss, [params[k][n] for k, n in keys]))))
        loss0.append(loss.item())
        del loss
    fused_g, twin_g, flip_g = grads
    net_max = max(g.abs().max().item() for g in twin_g.values())
    worst_ratio, worst_name, rel = 0.0, "", []
    sq = {"fused": 0.0, "reordered": 0.0, "norm": 0.0}
    for key, g in fused_g.items():
        want = twin_g[key]
        err = (g - want).abs().max().item()
        noise = (flip_g[key] - want).abs().max().item()
        tol = CNN_GRAD_LEAF_K * noise + CNN_TOL_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return None, (f"step-0 gradient {key} fused vs unfused: {err} > "
                          f"{tol} ({CNN_GRAD_LEAF_K} x the reordered "
                          f"twin's {noise})")
        rel.append((err / noise if noise else float("inf"), "/".join(key)))
        if err / tol >= worst_ratio:
            worst_ratio, worst_name = err / tol, "/".join(key)
        sq["fused"] += ((g - want) ** 2).sum().item()
        sq["reordered"] += ((flip_g[key] - want) ** 2).sum().item()
        sq["norm"] += (want ** 2).sum().item()
    grad_rel_l2 = {k: (sq[k] / sq["norm"]) ** 0.5
                   for k in ("fused", "reordered")}
    del grads, fused_g, twin_g, flip_g
    if grad_rel_l2["fused"] > CNN_GRAD_NOISE_K * grad_rel_l2["reordered"]:
        return None, (f"step-0 gradients fused vs unfused, relative L2 "
                      f"{grad_rel_l2['fused']} > {CNN_GRAD_NOISE_K} x the "
                      f"reordered twin's {grad_rel_l2['reordered']}")
    return {"loss0": loss0, "worst_ratio": worst_ratio,
            "worst_name": worst_name, "rel": rel,
            "grad_rel_l2": grad_rel_l2}, None


def cnn_phases(args, torch, dev, card):
    """Phases 7-9 (ResNet50).  Returns ``(the bn_apply kernels record,
    None)``, or ``(None, what failed)``."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb

    zoo = ResNet50(seed=args.seed)
    geoms = bn_geometries(zoo.conf(), CNN_BATCH)
    if sum(geoms.values()) != 53:
        return None, f"ResNet50 has {sum(geoms.values())} BN layers, not 53"

    # ---- 7. BN apply kernel vs plain at every geometry -------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    bn_err = bn_err_bf16 = 0.0
    for (m, c, act), count in sorted(geoms.items()) + [(BN_WIDE_GEOMETRY,
                                                         0)]:
        for dname, dt, tol_rel in (("float32", torch.float32, BN_TOL_F32),
                                   ("bfloat16", torch.bfloat16,
                                    BN_TOL_BF16),
                                   ("float16", torch.float16, BN_TOL_F16)):
            x = (torch.randn((m, c), generator=gen, device=dev) * 2
                 + 0.5).to(dt)
            scale = torch.randn(c, generator=gen, device=dev).to(dt)
            shift = torch.randn(c, generator=gen, device=dev).to(dt)
            tol = tol_rel * (x.float().abs() * scale.float().abs()
                             + shift.float().abs()).max().item()
            errs = {}
            for relu in (True, False):
                y = pb.bn_apply(x, scale, shift, relu)
                want = pb.bn_apply_plain(x, scale, shift, relu)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(y.float()).all()):
                    return None, f"bn_apply not finite at [{m}, {c}] {dname}"
                errs["relu" if relu else "identity"] = \
                    (y.float() - want.float()).abs().max().item()
            print(json.dumps({"phase": "bn_kernel_vs_plain", "rows": m,
                              "channels": c, "resnet_activation": act,
                              "resnet_layers": count, "dtype": dname,
                              "max_abs_err": errs, "tol": tol}), flush=True)
            if max(errs.values()) > tol:
                return None, (f"bn_apply disagrees with plain at [{m}, {c}] "
                              f"{dname}: {errs} > {tol}")
            if dname == "float32":
                bn_err = max(bn_err, *errs.values())
            elif dname == "bfloat16":
                bn_err_bf16 = max(bn_err_bf16, *errs.values())
            del x, y, want

    # ---- 8. full-width ResNet50 training ---------------------------------
    nets = {}
    for helper in ("pallas", None):
        conf = zoo.conf()
        for v in conf.vertices.values():
            lc = getattr(v, "layer", None)
            if type(lc).__name__ == "BatchNormalization":
                lc.helper = helper
        nets[helper] = ComputationGraph(conf, device=dev)
    net = nets["pallas"].init()
    twin = nets[None].load_params({
        k: {n: p.detach().cpu().numpy() for n, p in g.items()}
        for k, g in net.params.items()})
    h, w, c = zoo.input_shape
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    xs = [torch.randn((CNN_BATCH, h, w, c), generator=dgen, device=dev)
          for _ in range(CNN_STEPS)]
    ys = [F.one_hot(torch.randint(0, zoo.num_classes, (CNN_BATCH,),
                                  generator=dgen, device=dev),
                    zoo.num_classes).float() for _ in range(CNN_STEPS)]

    check, err = bn_twin_grad_check(torch, net, twin, xs[0], ys[0])
    if err:
        return None, err
    loss0, worst_ratio, worst_name, rel, grad_rel_l2 = (
        check[k] for k in ("loss0", "worst_ratio", "worst_name", "rel",
                           "grad_rel_l2"))

    # the main path: 5 fit steps of the fused net, counted
    names = [n for n, _ in net.named_parameters()]
    if names != [n for n, _ in twin.named_parameters()]:
        return None, "the twin's parameters are not the fused net's"
    snaps = []
    torch.cuda.synchronize()
    pb.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    step_losses = []
    for x, y in zip(xs, ys):
        snaps.append([p.detach().clone() for p in net.parameters()])
        net.fit(x, y)
        step_losses.append(net._score)     # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(pb.launches)
    flash_launches = dict(fa.launches)
    losses = [float(v) for v in step_losses]

    # the twin: each step from the fused net's params before that step
    pb.reset_launches()
    twin_losses = []
    for snap, x, y in zip(snaps, xs, ys):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        twin.fit(x, y)
        twin_losses.append(twin.get_score())
    twin_launches = pb.launches["bn_apply"]
    del snaps
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))
    state_diff = max(
        ((net.state[k][n] - t).abs().max()
         / t.abs().max().clamp(min=1e-30)).item()
        for k, g in twin.state.items() for n, t in g.items())
    xe = xs[0][:CNN_EVAL_ROWS]
    pe, te = net.output(xe), twin.output(xe)
    eval_diff = (pe - te).abs().max().item()
    eval_max_prob = pe.max().item()
    expected = 53 * CNN_STEPS
    rel.sort(reverse=True)
    print(json.dumps({
        "phase": "cnn_train", "model": {
            "name": "ResNet50", "input": list(zoo.input_shape),
            "classes": zoo.num_classes, "batch": CNN_BATCH,
            "dtype": "float32", "tf32": False,
            "updater": "Nesterovs(learning_rate=0.1, momentum=0.9)",
            "bn_helper": "pallas", "num_params": net.num_params()},
        "steps": CNN_STEPS, "step0_loss": loss0, "losses": losses,
        "twin_losses": twin_losses, "max_rel_loss_diff": loss_diff,
        "tol_loss": CNN_TOL_LOSS,
        "step0_grad_worst_err_over_tol": worst_ratio,
        "step0_grad_worst_param": worst_name,
        "step0_grad_err_over_reordered_noise_worst": rel[:5],
        "step0_grad_rel_l2": grad_rel_l2,
        "tol_grad": {"rel_l2_times_reordered": CNN_GRAD_NOISE_K,
                     "leaf_times_reordered": CNN_GRAD_LEAF_K,
                     "leaf_of_net_max": CNN_TOL_GRAD_NET},
        "max_rel_running_stat_diff": state_diff,
        "tol_state": CNN_TOL_STATE, "eval_max_abs_diff": eval_diff,
        "tol_eval": CNN_TOL_EVAL, "eval_max_prob": eval_max_prob,
        "kernel_launches": launches,
        "expected_launches": {"bn_apply": expected},
        "flash_launches": flash_launches, "twin_bn_launches": twin_launches,
        "seconds": round(train_s, 4)}), flush=True)
    if launches["bn_apply"] != expected or twin_launches or \
            any(flash_launches.values()):
        return None, (f"bn_apply launched {launches} (twin {twin_launches}"
                      f", flash {flash_launches}); expected {expected}")
    if not all(np.isfinite(losses + twin_losses)) or \
            loss_diff > CNN_TOL_LOSS:
        return None, (f"losses {losses} vs twin {twin_losses}: "
                      f"{loss_diff} > {CNN_TOL_LOSS}")
    if state_diff > CNN_TOL_STATE:
        return None, (f"running stats differ from the twin's by "
                      f"{state_diff} > {CNN_TOL_STATE}")
    if pe.shape != (CNN_EVAL_ROWS, zoo.num_classes) or \
            not bool(torch.isfinite(pe).all()) or \
            (pe.sum(-1) - 1).abs().max().item() > 1e-4 or \
            eval_diff > CNN_TOL_EVAL:
        return None, f"eval outputs differ from the twin's by {eval_diff}"
    del pe, te

    # ---- 9. times -----------------------------------------------------
    step_ms = {"pallas": [], "unfused": []}
    models = {"pallas": net, "unfused": twin}
    for m in models.values():
        for i in range(2):
            m.fit(xs[i], ys[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in ("unfused", "pallas", "pallas", "unfused"):
        for i in range(CNN_TIMED_STEPS // 2):
            x, y = xs[i % CNN_STEPS], ys[i % CNN_STEPS]
            t1 = time.perf_counter()
            models[name].fit(x, y)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t1) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    splits = {}
    for name, m in models.items():
        split = profile_steps(torch, m, list(zip(xs, ys))[:PROFILED_STEPS],
                              CNN_KERNEL_CLASSES)
        busy = split["device_ms_total_per_step"] / med[name] \
            if split["device_ms_total_per_step"] else None
        split["device_busy_share"] = busy
        split["device_idle_share"] = None if busy is None else 1 - busy
        splits[name] = split
    del twin, models
    print(json.dumps({"phase": "cnn_train_time", "batch": CNN_BATCH,
                      "steps_per_net": CNN_TIMED_STEPS,
                      "step_ms_median": med["pallas"],
                      "images_per_s": CNN_BATCH / med["pallas"] * 1e3,
                      "unfused_step_ms_median": med["unfused"],
                      "unfused_images_per_s": CNN_BATCH / med["unfused"]
                      * 1e3, "step_ms": step_ms,
                      "peak_memory_gb": peak_gb, "profile": splits["pallas"],
                      "unfused_profile": splits["unfused"],
                      "card": card}), flush=True)
    del net, xs, ys
    torch.cuda.empty_cache()

    # BN apply at each geometry: kernel, plain version, torch.addcmul.
    # Each timed launch follows a 64 MB read, which evicts the 50 MB L2
    # and leaves it clean (a write flush would leave dirty lines whose
    # writeback the timed launch pays for).
    flush_buf = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    flush_out = torch.empty((), dtype=torch.float32, device=dev)

    def flush():
        torch.sum(flush_buf, dim=0, out=flush_out)

    # f32 (the ResNet50 step's dtype) and bf16 (resnet_bf16's step with
    # keep_f32=(), phase 28)
    sums = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        totals = sums[dname] = {"ms": 0.0, "ms_device_only": 0.0,
                                "plain_ms": 0.0, "library_ms": 0.0,
                                "bound_ms": 0.0}
        bound_by_all = set()
        for (m, c, act), count in sorted(geoms.items()):
            x = torch.randn((m, c), generator=gen, device=dev).to(dt)
            scale = torch.randn(c, generator=gen, device=dev).to(dt)
            shift = torch.randn(c, generator=gen, device=dev).to(dt)
            out = torch.empty_like(x)
            relu = act == "relu"
            p = pb.device_plan(x, scale, shift, out)
            row = {}
            # straight through the binding: timing launches are not
            # counted
            row["ms"] = median_ms(
                lambda: pb._launch(x, scale, shift, out, relu), torch,
                before=flush)
            row["ms_device_only"] = median_ms(
                lambda: pb._launch(x, scale, shift, out, relu), torch,
                before=flush, spin=True)
            row["library_ms"] = median_ms(
                lambda: torch.addcmul(shift, x, scale), torch, before=flush)
            row["plain_ms"] = median_ms(
                lambda: pb.bn_apply_plain(x, scale, shift, relu), torch,
                runs=10, before=flush)
            bound, bound_by = bn_bound_ms(m, c, dname)
            row["bound_ms"] = bound
            bound_by_all.add(bound_by)
            for key in totals:
                totals[key] += count * row[key]
            nbytes = 2 * m * c * x.element_size() + 2 * c * x.element_size()
            print(json.dumps({"phase": "kernel_time", "kernel": "bn_apply",
                              "dtype": dname, "rows": m, "channels": c,
                              "activation": act, "layers_per_step": count,
                              "plan": dataclasses.asdict(p), **row,
                              "gbps": nbytes / row["ms"] / 1e6,
                              "bound_share": bound / row["ms"],
                              "library_call":
                                  "torch.addcmul(shift, x, scale)"
                                  + (" (relu would need a second call)"
                                     if relu else ""),
                              "bound_by": bound_by, "card": card}),
                  flush=True)
            del x, out
        totals["bound_by"] = "/".join(sorted(bound_by_all))
    in_step = splits["pallas"]["device_ms_per_step"]["bn_apply"]
    totals = sums["float32"]
    return {"name": "bn_apply", "route": "cuda",
            "source": f"{SRC_DIR}/{pb.SOURCE}",
            "replaces": "deeplearning4j_tpu/ops/pallas_bn.py:82",
            "launches": launches["bn_apply"], "max_abs_err": bn_err,
            **totals, "bound_share": totals["bound_ms"] / totals["ms"],
            "in_step_profiled_ms": in_step,
            "bfloat16_totals": sums["bfloat16"],
            "bfloat16_max_abs_err": bn_err_bf16,
            "per": "one ResNet50 training step at batch 64, f32: the 53 "
                   "launches at their shapes, summed, each after a clean "
                   "L2 flush"}, None


# ---- 13-15. generation -------------------------------------------------
# The full-width TransformerLM generating through the paged KV engine:
# 24 requests on 16 slots (8 join a running batch), prompts of 16-384
# tokens from the seed, 64 new tokens each; 6 share a 256-token prefix and
# one of those ends inside a block (its tail block is adopted by
# copy-on-write by a later request that extends it); 20 greedy, 4 sampled.
GEN_SLOTS, GEN_MAX_SEQ, GEN_BLOCK = 16, 512, 16
GEN_REQUESTS, GEN_NEW, GEN_PREFIX = 24, 64, 256
GEN_PROMPT_RANGE = (16, 384)
GEN_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
GEN_SAMPLED_AT = (3, 9, 13, 20)        # request indices drawn with knobs
GEN_SHARED_AT = (1, 5, 8, 11, 14)      # first wave; 14 ends inside a block
GEN_COW_AT = 18                        # extends 14; submitted once 14 ends
GEN_PROFILED_STEPS, GEN_DIRECT_POS = 10, 300
PREFILL_TIMED_BUCKETS = (128, 512)
# kernel classes of a decode step's device time (the first match wins):
# matrix products, the gathers of K/V blocks through the tables and the
# pool writes, copies (the gathered blocks' permute into [S, h, V, d])
DECODE_KERNEL_CLASSES = (("matmul", MATMUL_TAGS),
                         ("gather_index", ("index", "gather", "scatter")),
                         ("copy", ("copy", "cat")))
# The recurrent path: EmbeddingSequenceLayer(64) -> 2 x LSTM(256, pallas)
# -> RnnOutputLayer(96), 16 slots, 8 greedy requests of 48 new tokens.
RNN_VOCAB, RNN_EMBED, RNN_HIDDEN = 96, 64, 256
RNN_REQUESTS, RNN_NEW, RNN_MAX_SEQ = 8, 48, 96


def decode_bound_ms(param_bytes: int, kv_tokens: int, layers: int,
                    heads: int, head_dim: int, slots: int,
                    vocab: int) -> float:
    """Least time of one decode step: every parameter read once, the K and
    V of every written position of every slot read once (``kv_tokens``
    summed over the slots, f32, each attention layer), and the ``[S, V]``
    f32 log-probs written once, over the card's memory rate.  (The step's
    operations, ~2 per parameter per slot, take far less at 67 TFLOP/s.)"""
    kv = kv_tokens * layers * 2 * heads * head_dim * 4
    return (param_bytes + kv + slots * vocab * 4) / HBM_BYTES_PER_S * 1e3


def _gen_capture(net, gen, torch, greedy_only=None):
    """Wrap ``net.generation_program`` so that every call records, per
    occupied slot, the log-probs the sampler drew from, keyed ``(request
    id, token index)``, and each decode step's time (host clock, closed by
    a sync) beside its active slots."""
    orig = net.generation_program
    logps, steps = {}, []

    def program(kind):
        fn = orig(kind)

        def run(*a):
            occ = gen.ring.occupants()
            t0 = time.perf_counter()
            tok, logp = fn(*a)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if kind == "paged_decode":
                steps.append((len(occ), ms))
                rows = occ.items()
            else:
                rows = [(a[6], occ[a[6]])]
            for slot, req in rows:
                if greedy_only is None or req.id in greedy_only:
                    lp = logp if logp.ndim == 1 else logp[slot]
                    logps[(req.id, len(req.out_tokens))] = lp
            return tok, logp
        return run

    net.generation_program = program
    return logps, steps


def _tie_check(torch, tokens, mine, ref, teacher_forced):
    """Greedy ``tokens`` (one list per request) against reference
    log-prob rows ``ref`` where ``mine`` are the engine's own rows.  The
    margin is twice the largest |mine - ref| over each position's
    reference top-2 tokens, measured where the two agree; a position
    that disagrees must sit within the margin (a tie).  A teacher-forced
    reference saw the engine's own history at every position; a twin
    engine's stream parts from ours at its first difference, so each
    stream is compared up to there.  Returns (margin, ties, mismatches,
    positions compared)."""
    checked = []
    for toks, m, r in zip(tokens, mine, ref):
        top2 = r.topk(2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        diff = (m.gather(1, top2.indices)
                - r.gather(1, top2.indices)).abs().max(dim=1).values
        agree = top2.indices[:, 0] == torch.as_tensor(toks, device=r.device)
        n = len(toks)
        if not teacher_forced and not bool(agree.all()):
            n = int((~agree).nonzero()[0]) + 1
        checked.append((agree[:n], gap[:n], diff[:n]))
    margin = 2 * max((float(d[a].max()) for a, _, d in checked
                      if bool(a.any())), default=0.0)
    ties = sum(int((~a & (g < margin)).sum()) for a, g, _ in checked)
    mismatches = sum(int((~a & (g >= margin)).sum()) for a, g, _ in checked)
    return margin, ties, mismatches, sum(len(a) for a, _, _ in checked)


def _direct_decode(torch, net, dev):
    """A scratch paged cache with all GEN_SLOTS slots at position
    GEN_DIRECT_POS, and the decode program's arguments for one greedy
    step: ``(kv, tables, program, args)``."""
    from deeplearning4j_tpu_torch.generation.cache import PagedKV
    kv = PagedKV(net.conf, GEN_SLOTS, GEN_MAX_SEQ, block_size=GEN_BLOCK,
                 device=dev)
    for s in range(GEN_SLOTS):
        kv.acquire(f"direct-{s}")
        kv.ensure_blocks(s, f"direct-{s}", GEN_MAX_SEQ)
    tables = torch.as_tensor(kv.tables, device=dev)
    S = GEN_SLOTS
    dargs = (torch.randint(0, VOCAB, (S,), device=dev), kv.caches, tables,
             torch.full((S,), GEN_DIRECT_POS, dtype=torch.int32,
                        device=dev),
             torch.zeros((S, 2), dtype=torch.int64, device=dev),
             torch.zeros(S, device=dev),
             torch.zeros(S, dtype=torch.int32, device=dev),
             torch.ones(S, device=dev))
    return kv, tables, net.generation_program("paged_decode"), dargs


def generation_phases(args, torch, dev, card):
    """Phases 13-15 (generation).  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                     GenerationEngine)
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    # ---- 13. generate ----------------------------------------------------
    t_phase = time.perf_counter()
    net = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                        n_layers=LAYERS, n_heads=HEADS).init(device="cuda")
    params_from_jax(net, seeded_params(net.param_spec(), args.seed))
    cfg = dict(max_slots=GEN_SLOTS, max_seq=GEN_MAX_SEQ,
               block_size=GEN_BLOCK)
    rng = np.random.default_rng(args.seed + 13)
    prefix = rng.integers(0, VOCAB, GEN_PREFIX).tolist()
    prompts, kws = [], []
    for i in range(GEN_REQUESTS):
        if i == GEN_COW_AT:
            p = prompts[GEN_SHARED_AT[-1]] + \
                rng.integers(0, VOCAB, 20).tolist()
        elif i == GEN_SHARED_AT[-1]:
            p = prefix + rng.integers(0, VOCAB, 5).tolist()
        elif i in GEN_SHARED_AT:
            p = prefix + rng.integers(0, VOCAB, int(rng.integers(
                1, GEN_PROMPT_RANGE[1] - GEN_PREFIX + 1))).tolist()
        else:
            p = rng.integers(0, VOCAB, int(rng.integers(
                GEN_PROMPT_RANGE[0], GEN_PROMPT_RANGE[1] + 1))).tolist()
        prompts.append(p)
        kw = dict(max_new_tokens=GEN_NEW, seed=1000 + i)
        if i in GEN_SAMPLED_AT:
            kw.update(GEN_SAMPLED)
        kws.append(kw)
    srv = ServingEngine(net, max_batch_size=MAX_BATCH,
                        generation=GenerationConfig(**cfg))
    gen = srv.generation
    try:
        warmed = srv.warmup()
        greedy_ids = set()
        logps, steps = _gen_capture(net, gen, torch, greedy_only=greedy_ids)
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        handles = {}

        def submit(i):
            handles[i] = gen.submit(prompts[i], **kws[i])
            if "temperature" not in kws[i]:
                greedy_ids.add(handles[i].id)
        for i in range(GEN_REQUESTS):
            if i != GEN_COW_AT:
                submit(i)
        # request 14's tail block registers when it vacates: the request
        # that extends it then adopts it by copy-on-write
        handles[GEN_SHARED_AT[-1]].future.result(timeout=300)
        submit(GEN_COW_AT)
        handles = [handles[i] for i in range(GEN_REQUESTS)]
        results = [h.future.result(timeout=300) for h in handles]
        run_s = time.perf_counter() - t_run
        del net.generation_program
        kv = gen.ring
        kv_stats = kv.stats()
        pool_back = (kv.active_slots == 0 and kv.blocks_free
                     + kv_stats["blocks_registered"] == kv.n_blocks - 1)
        # streaming: one request, its events one at a time
        events = list(gen.stream(prompts[0], max_new_tokens=GEN_NEW,
                                 timeout=300))
        stream_ok = (len(events) == GEN_NEW + 1 and events[-1].get("done")
                     and [e["index"] for e in events[:-1]]
                     == list(range(GEN_NEW))
                     and events[-1]["tokens"]
                     == [e["token"] for e in events[:-1]])
        status = gen.status()
    finally:
        srv.shutdown()
    # greedy tokens against the teacher-forced oracle (net.output)
    oracle, mine, gtoks = [], [], []
    for h, p, res in zip(handles, prompts, results):
        if h.id not in greedy_ids:
            continue
        full = p + res.tokens
        with torch.inference_mode():
            probs = net.output(np.asarray([full[:-1]], np.int64))[0]
        rows = probs[len(p) - 1:]
        oracle.append(torch.log(torch.clamp(rows, min=1e-30)))
        mine.append(torch.stack([logps[(h.id, j)]
                                 for j in range(len(res.tokens))]))
        gtoks.append(res.tokens)
    margin, ties, mismatches, positions = _tie_check(torch, gtoks, mine,
                                                     oracle, True)
    # sampled requests alone, on an engine without prefix sharing (the
    # batch run shared nothing with them either): the same slot count,
    # so the same shapes
    solo = GenerationEngine.for_model(
        net, GenerationConfig(**cfg, prefix_sharing=False))
    try:
        solo_equal = [solo.generate(prompts[i], timeout=300,
                                    **kws[i]).tokens == results[i].tokens
                      for i in GEN_SAMPLED_AT]
    finally:
        solo.shutdown()
    gen_s = time.perf_counter() - t_phase
    finite = all(len(r.tokens) == GEN_NEW and all(0 <= t < VOCAB
                                                  for t in r.tokens)
                 for r in results)
    print(json.dumps({
        "phase": "generate", "model": {
            "name": "TransformerLM", "vocab": VOCAB, "seq": SEQ,
            "embed": EMBED, "layers": LAYERS, "heads": HEADS,
            "num_params": net.num_params(), "dtype": "float32",
            "tf32": False},
        "config": cfg, "requests": GEN_REQUESTS,
        "greedy": len(greedy_ids), "sampled": len(GEN_SAMPLED_AT),
        "sampling": GEN_SAMPLED, "max_new_tokens": GEN_NEW,
        "prompt_lens": [len(p) for p in prompts],
        "shared_prefix": GEN_PREFIX, "warm_calls": warmed,
        "greedy_positions_checked": positions,
        "tie_margin": margin, "ties": ties,
        "greedy_mismatches_outside_ties": mismatches,
        "sampled_solo_equals_batched": solo_equal,
        "kv": kv_stats, "pool_blocks_back": pool_back,
        "stream_events": len(events), "stream_ok": bool(stream_ok),
        "decode_steps": status["decode_steps"],
        "seconds": round(gen_s, 3)}), flush=True)
    if not finite:
        return "generated tokens out of range or short"
    if mismatches:
        return (f"{mismatches} greedy streams leave the oracle's argmax "
                f"outside the tie margin {margin}")
    if not all(solo_equal):
        return f"sampled streams alone differ from batched: {solo_equal}"
    if kv_stats["prefix_hits"] < 1 or kv_stats["cow_copies"] < 1:
        return f"no prefix hit or copy-on-write: {kv_stats}"
    if not pool_back:
        return f"blocks not returned to the pool: {kv_stats}"
    if not stream_ok:
        return "stream() did not yield one event per token"

    # ---- 14. generate_time -----------------------------------------------
    t_phase = time.perf_counter()
    ttft = sorted((h.t_first - h.t_submit) * 1e3 for h in handles)
    full_steps = sorted(ms for n, ms in steps if n == GEN_SLOTS)
    tokens = sum(len(r.tokens) for r in results)
    # the programs driven directly on a scratch cache: 16 slots at
    # position GEN_DIRECT_POS
    kv, tables, dec, dargs = _direct_decode(torch, net, dev)
    one = dict(keys=torch.zeros((1, 2), dtype=torch.int64, device=dev),
               temp=torch.zeros(1, device=dev),
               top_k=torch.zeros(1, dtype=torch.int32, device=dev),
               top_p=torch.ones(1, device=dev))
    pf = net.generation_program("paged_prefill")
    prefill_ms = {}
    for b in PREFILL_TIMED_BUCKETS:
        toks = torch.randint(0, VOCAB, (1, b), device=dev)
        mask = torch.ones((1, b), device=dev)
        prefill_ms[b] = median_ms(lambda: pf(
            net.params, net.state, toks, mask, kv.caches, tables[0], 0, 0,
            b, 0, 0, one["keys"], one["temp"], one["top_k"],
            one["top_p"]), torch, runs=10)
    S = GEN_SLOTS

    def step():
        return dec(net.params, net.state, *dargs)[0].cpu()
    for _ in range(3):
        step()
    direct = []
    for _ in range(20):
        t1 = time.perf_counter()
        step()
        direct.append((time.perf_counter() - t1) * 1e3)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(GEN_PROFILED_STEPS):
            step()
        prof_wall = (time.perf_counter() - t1) * 1e3
    per_class = {name: 0.0 for name, _ in DECODE_KERNEL_CLASSES}
    per_class["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        key = ev.key.lower()
        cls = next((name for name, tags in DECODE_KERNEL_CLASSES
                    if any(t in key for t in tags)), "other")
        per_class[cls] += us / 1e3 / GEN_PROFILED_STEPS
    dev_ms = sum(per_class.values())
    direct_med = statistics.median(direct)
    param_bytes = sum(p.numel() * 4 for p in net.params.parameters())
    bound = decode_bound_ms(param_bytes, S * (GEN_DIRECT_POS + 1), LAYERS,
                            HEADS, HEAD_DIM, S, VOCAB)
    print(json.dumps({
        "phase": "generate_time",
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": ttft[-1],
        "prefill_ms": {str(b): v for b, v in prefill_ms.items()},
        "decode_step_ms_16_active": {
            "steps": len(full_steps),
            "median": statistics.median(full_steps) if full_steps else None,
            "p99": full_steps[min(len(full_steps) - 1,
                                  int(0.99 * len(full_steps)))]
            if full_steps else None},
        "tokens": tokens, "run_s": run_s, "tokens_per_s": tokens / run_s,
        "direct_decode": {"slots": S, "pos": GEN_DIRECT_POS,
                          "step_ms_median": direct_med,
                          "profiled_steps": GEN_PROFILED_STEPS,
                          "profiled_wall_ms_per_step":
                              prof_wall / GEN_PROFILED_STEPS,
                          "device_ms_per_step": dev_ms,
                          "device_ms_per_step_by_class": per_class,
                          # against the unprofiled step: the profiler's
                          # own host work stretches the profiled steps
                          "device_busy_share": dev_ms / direct_med},
        "decode_bound_ms": bound, "bound_by": "bytes",
        "card": card, "seconds": round(time.perf_counter() - t_phase, 3)}),
        flush=True)
    if not full_steps:
        return "no decode step ran with all 16 slots active"
    del kv, dargs, tables
    torch.cuda.empty_cache()

    # ---- 15. generate_rnn ------------------------------------------------
    t_phase = time.perf_counter()

    def rnn_net(helper):
        conf = MultiLayerConfiguration(
            layers=[EmbeddingSequenceLayer(n_out=RNN_EMBED),
                    LSTM(n_out=RNN_HIDDEN, activation="tanh", helper=helper),
                    LSTM(n_out=RNN_HIDDEN, activation="tanh", helper=helper),
                    RnnOutputLayer(n_out=RNN_VOCAB, activation="softmax",
                                   loss="mcxent")],
            input_type=InputType.recurrent(RNN_VOCAB, RNN_MAX_SEQ),
            defaults={"weight_init": "xavier"}, seed=args.seed)
        return MultiLayerNetwork(conf, device=dev)
    rnet = rnn_net("pallas")
    tree = seeded_params(rnet.param_spec(), args.seed + 15)
    params_from_jax(rnet, tree)
    twin = params_from_jax(rnn_net(None), tree)
    rcfg = GenerationConfig(max_slots=GEN_SLOTS, max_seq=RNN_MAX_SEQ,
                            block_size=GEN_BLOCK)
    rprompts = [rng.integers(0, RNN_VOCAB, int(rng.integers(8, 41)))
                .tolist() for _ in range(RNN_REQUESTS)]
    streams, rows = {}, {}
    for name, model in (("kernel", rnet), ("twin", twin)):
        eng = GenerationEngine.for_model(model, rcfg)
        try:
            eng.warmup()
            logps, _ = _gen_capture(model, eng, torch)
            torch.cuda.synchronize()
            pl.reset_launches()
            steps0 = eng.decode_steps
            hs = [eng.submit(p, max_new_tokens=RNN_NEW, seed=i)
                  for i, p in enumerate(rprompts)]
            streams[name] = [h.future.result(timeout=300).tokens
                             for h in hs]
            launches = pl.launches["lstm_fwd"]
            dsteps = eng.decode_steps - steps0
            rows[name] = [torch.stack([logps[(h.id, j)]
                                       for j in range(RNN_NEW)])
                          for h in hs]
            del model.generation_program
        finally:
            eng.shutdown()
        if name == "kernel":
            kernel_launches, kernel_steps = launches, dsteps
        else:
            twin_launches = launches
    margin_r, ties_r, mism_r, pos_r = _tie_check(
        torch, streams["kernel"], rows["kernel"], rows["twin"], False)
    print(json.dumps({
        "phase": "generate_rnn", "model": {
            "layers": f"EmbeddingSequenceLayer({RNN_EMBED}), 2 x LSTM("
                      f"{RNN_HIDDEN}, helper=pallas), RnnOutputLayer("
                      f"{RNN_VOCAB}, softmax)",
            "num_params": rnet.num_params()},
        "slots": GEN_SLOTS, "requests": RNN_REQUESTS,
        "max_new_tokens": RNN_NEW,
        "decode_steps": kernel_steps, "lstm_fwd_launches": kernel_launches,
        "expected_launches": 2 * kernel_steps,
        "twin_lstm_fwd_launches": twin_launches,
        "positions_checked": pos_r, "tie_margin": margin_r, "ties": ties_r,
        "mismatches_outside_ties": mism_r,
        "streams_equal_twin": streams["kernel"] == streams["twin"],
        "seconds": round(time.perf_counter() - t_phase, 3)}), flush=True)
    if kernel_launches != 2 * kernel_steps or kernel_steps == 0 or \
            twin_launches:
        return (f"lstm_fwd launched {kernel_launches} times over "
                f"{kernel_steps} decode steps (twin {twin_launches}); "
                "expected 2 per step")
    if mism_r:
        return (f"{mism_r} recurrent streams leave the twin's argmax "
                f"outside the tie margin {margin_r}")
    return None


# The conv zoo (phases 16-19) and the attention stacks with dropout
# (phase 20).  Every zoo model at its published input; random weights
# from the seed (the port's seeded init); f32 with TF32 off.
ZOO_SERVE = (("LeNet", {}), ("SimpleCNN", {}), ("AlexNet", {}),
             ("VGG16", {}), ("VGG19", {}), ("GoogLeNet", {}),
             ("InceptionResNetV1", {"blocks_a": 5, "blocks_b": 10,
                                    "blocks_c": 5}),
             ("FaceNetNN4Small2", {}))
ZOO_SERVE_BATCH, ZOO_CHECK_ROWS, ZOO_SERVE_RUNS = 8, 2, 10
# Served rows (softmax probabilities <= 1) against the port's own CPU run
# on the same params and rows: cuDNN (TF32 off) and oneDNN sum each conv
# and matmul in another f32 order, ~1e-6 relative per layer over up to
# ~60 layers; a probability moves by p times the logit error, and the
# logits of these random nets are O(10): 1e-4 abs.
TOL_ZOO_ROWS = 1e-4
# The two trained nets: GoogLeNet (ComputationGraph, DropoutLayer 0.4,
# the zoo's Adam 1e-3) at batch 64, VGG16 (MLN, dense dropout 0.5, the
# zoo's Nesterovs 1e-2 / 0.9) at batch 32, 5 fit steps on one seeded
# batch.
ZOO_TRAIN = (("GoogLeNet", 64, {}), ("VGG16", 32, {}))
ZOO_STEPS, ZOO_TIMED_STEPS = 5, 10
# Step 0 against a float64 twin (same params, batch and key, so the same
# masks).  Loss (a mean of -log p over the batch): f32 rounding through
# ~20 layers of sums over up to 25,088 terms, ~1e-6 relative: 1e-5.
# Gradients: f32 arithmetic itself lands far from f64 on these random
# nets.  Measured with this phase's nets and batches on an H100 (80GB
# HBM3, 700 W): the port's f32 step-0 gradients are 2.9e-3 (VGG16) and
# 2.6e-4 (GoogLeNet) from f64 in relative L2 over the net, up to 1.7e-2 of a
# leaf's largest |g| (VGG16's last conv); the same computation with
# cuDNN off (PyTorch's own im2col + GEMM convolution, another f32
# summation) is 1.1e-3 and 1.7e-4 from f64 and 2.8e-3 and 2.4e-4 from
# cuDNN's; rows reversed (wgrad sums reordered, masks reversed with
# them) move the gradients by only ~3e-6, so the error is in how each
# row's f32 values are formed, not in the batch reduction.  The phase
# prints the cuDNN-off distance beside each run's.  A wrong mask, a wrong
# path or TF32 (2^-11 per product, ~1e4 times f32's 2^-24) would move
# the gradients by O(1) of their size.  Per parameter: 5e-2 of the
# leaf's largest |g| plus 1e-5 of the net's; over the net, relative L2
# within 1e-2.
ZOO_TOL_LOSS, ZOO_TOL_GRAD_LEAF, ZOO_TOL_GRAD_NET = 1e-5, 5e-2, 1e-5
ZOO_TOL_GRAD_L2 = 1e-2
# f32 peak on the CUDA cores without TF32 (H100 SXM data sheet, dense):
# the rate model FLOPs are set against
F32_PEAK_FLOPS = 67e12
ZOO_KERNEL_CLASSES = (("conv_and_matmul", MATMUL_TAGS + (
    "conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")),)
# The key stream on the card: the masks' own shapes (GoogLeNet's
# dropout, VGG16's two dense dropouts, the TransformerLM's block input)
RANDOM_MASKS = (("GoogLeNet dropout", (64, 1024), 0.4),
                ("VGG16 dense 1", (32, 25088), 0.5),
                ("VGG16 dense 2", (32, 4096), 0.5),
                ("TransformerLM block", (16, 512, 512), 0.9))
# normal on the card against the CPU: both sqrt(2)·erfinv(u) on the same
# float32 u; the two erfinv implementations are f32 approximations a
# few ulps apart, steeper in the tails: 2e-6 abs plus 1e-5 relative.
TOL_NORMAL_ABS, TOL_NORMAL_REL = 2e-6, 1e-5
DROPOUT_STEPS = 3


def model_flops(conf, batch: int) -> float:
    """Model FLOPs of one training step (forward + backward = 3x the
    forward's multiply-adds x 2) over the convolutions and dense layers
    of a configuration."""
    def layer_flops(lc, itype):
        kind = type(lc).__name__
        if kind == "ConvolutionLayer":
            out = lc.output_type(itype)
            kh, kw = (lc.kernel_size if isinstance(lc.kernel_size,
                                                   (list, tuple))
                      else (lc.kernel_size,) * 2)
            return 2.0 * kh * kw * lc.n_in * lc.n_out * out.height \
                * out.width
        if kind in ("DenseLayer", "OutputLayer", "CenterLossOutputLayer"):
            return 2.0 * lc.n_in * lc.n_out
        return 0.0
    fwd = 0.0
    if hasattr(conf, "vertices"):
        for name in conf.topological_order:
            v = conf.vertices[name]
            if hasattr(v, "layer"):
                fwd += layer_flops(v.layer, v._itype(
                    conf.vertex_input_types[name]))
    else:
        for lc, it in zip(conf.layers, conf.layer_input_types):
            fwd += layer_flops(lc, it)
    return 3.0 * fwd * batch


def random_phase(args, torch, dev, card):
    """Phase 16.  Returns None, or what failed."""
    from deeplearning4j_tpu_torch.utils import _random
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    keys = {d: _random.prng_key(args.seed, device=d) for d in (dev, cpu)}
    same = {}
    split = {d: _random.split(k, 3) for d, k in keys.items()}
    same["split"] = torch.equal(split[dev].cpu(), split[cpu])
    folds = (0, 7, 10_000, 12_345)
    same["fold_in"] = all(torch.equal(
        _random.fold_in(keys[dev], d).cpu(), _random.fold_in(keys[cpu], d))
        for d in folds)
    masks = []
    for i, (what, shape, p) in enumerate(RANDOM_MASKS):
        k = {d: _random.fold_in(split[d][1], i) for d in (dev, cpu)}
        got = _random.bernoulli(k[dev], p, shape)
        want = _random.bernoulli(k[cpu], p, shape)
        eq = torch.equal(got.cpu(), want)
        ms = median_ms(lambda: _random.bernoulli(k[dev], p, shape), torch,
                       runs=10)
        masks.append({"mask": what, "shape": list(shape), "p": p,
                      "equal": eq, "kept_share":
                      got.float().mean().item(), "draw_ms": ms})
        same[what] = eq
    k = {d: _random.fold_in(split[d][2], 1) for d in (dev, cpu)}
    zg = _random.normal(k[dev], (64, 1024)).cpu()
    zc = _random.normal(k[cpu], (64, 1024))
    normal_err = (zg - zc).abs().max().item()
    normal_ok = bool(((zg - zc).abs() <= TOL_NORMAL_ABS
                      + TOL_NORMAL_REL * zc.abs()).all())
    # host cost of the key work of one dropout draw on the card
    key_ms = median_ms(lambda: _random.fold_in(keys[dev], 3), torch,
                       runs=10)
    split_ms = median_ms(lambda: _random.split(keys[dev]), torch, runs=10)
    print(json.dumps({"phase": "random_on_card", "seed": args.seed,
                      "bit_equal": same, "masks": masks,
                      "normal_max_abs_err": normal_err,
                      "tol_normal": [TOL_NORMAL_ABS, TOL_NORMAL_REL],
                      "fold_in_ms": key_ms, "split_ms": split_ms,
                      "card": card, "seconds": round(
                          time.perf_counter() - t_phase, 3)}), flush=True)
    if not all(same.values()):
        return f"draws on the card differ from the CPU's: {same}"
    if not normal_ok:
        return f"normal on the card differs from the CPU's by {normal_err}"
    return None


def _zoo_input(zoo, batch, gen, dev, torch):
    h, w, c = zoo.input_shape
    x = torch.randn((batch, h, w, c), generator=gen, device=dev)
    return x.reshape(batch, -1) if type(zoo).__name__ == "LeNet" else x


def zoo_serve_phase(args, torch, dev, card):
    """Phase 17.  Returns None, or what failed."""
    from deeplearning4j_tpu_torch.models import zoo as tzoo
    gen = torch.Generator(device=dev).manual_seed(args.seed + 16)
    rows = []
    for name, kw in ZOO_SERVE:
        t_model = time.perf_counter()
        zoo = getattr(tzoo, name)(seed=args.seed, **kw)
        net = zoo.init(device=dev)
        cpu_net = type(net)(zoo.conf(), device="cpu").load_params(
            {k: {n: p.detach().cpu().numpy() for n, p in g.items()}
             for k, g in net.params.items()})
        x = _zoo_input(zoo, ZOO_SERVE_BATCH, gen, dev, torch)
        y = net.output(x)
        torch.cuda.synchronize()
        want = cpu_net.output(x[:ZOO_CHECK_ROWS].cpu())
        err = (y[:ZOO_CHECK_ROWS].cpu() - want).abs().max().item()
        finite = bool(torch.isfinite(y).all())
        sums = (y.sum(-1) - 1).abs().max().item()
        ms = median_ms(lambda: net.output(x), torch, runs=ZOO_SERVE_RUNS)
        row = {"model": name, "net": type(net).__name__,
               "input": list(zoo.input_shape), "classes": zoo.num_classes,
               "batch": ZOO_SERVE_BATCH, "num_params": net.num_params(),
               "max_abs_err_vs_cpu": err, "rows_checked": ZOO_CHECK_ROWS,
               "tol": TOL_ZOO_ROWS, "max_prob": y.max().item(),
               "latency_ms_median": ms,
               "images_per_s": ZOO_SERVE_BATCH / ms * 1e3,
               "seconds": round(time.perf_counter() - t_model, 3)}
        rows.append(row)
        print(json.dumps({"phase": "zoo_serve", **row, "card": card}),
              flush=True)
        del net, cpu_net, x, y
        torch.cuda.empty_cache()
        if tuple(want.shape) != (ZOO_CHECK_ROWS, zoo.num_classes) or \
                not finite or sums > 1e-4:
            return f"{name}: served rows not distributions of the shape"
        if err > TOL_ZOO_ROWS:
            return (f"{name}: served rows differ from the CPU run by {err} "
                    f"> {TOL_ZOO_ROWS}")
    return None


def _dropout_masks(net, key, x, torch):
    """``{where: bool mask}`` of every dropout the first fit step on
    ``key`` draws, redrawn from the key stream as the layers draw them."""
    from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
    from deeplearning4j_tpu_torch.utils import _random
    conf, out = net.conf, {}
    if hasattr(conf, "vertices"):
        for vi, name in enumerate(conf.topological_order):
            lc = getattr(conf.vertices[name], "layer", None)
            d = tdrop.resolve(getattr(lc, "dropout", None))
            if d is not None:
                it = conf.vertex_input_types[name][0]
                out[name] = _random.bernoulli(_random.fold_in(key, vi), d.p,
                                              (x.shape[0], it.flat_size()))
    else:
        for i, lc in enumerate(conf.layers):
            d = tdrop.resolve(getattr(lc, "dropout", None))
            if d is not None:
                out[f"layer_{i}"] = _random.bernoulli(
                    _random.fold_in(key, i), d.p,
                    (x.shape[0], conf.layer_input_types[i].flat_size()))
    return out


def _loss_fn(net):
    from deeplearning4j_tpu_torch.nn.computation_graph import _graph_loss
    from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss_state
    if hasattr(net.conf, "vertices"):
        return lambda p, s, x, y, key: _graph_loss(
            net.conf, p, s, [x], [y], train=True, key=key)[0]
    return lambda p, s, x, y, key: _stack_loss_state(
        net.conf, p, s, x, y, train=True, key=key)[0]


def zoo_train_phases(args, torch, dev, card):
    """Phases 18-19.  Returns None, or what failed."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models import zoo as tzoo
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.utils import _random
    gen = torch.Generator(device=dev).manual_seed(args.seed + 18)
    for name, batch, kw in ZOO_TRAIN:
        t_phase = time.perf_counter()
        zoo = getattr(tzoo, name)(seed=args.seed, **kw)
        net = zoo.init(device=dev)
        x = _zoo_input(zoo, batch, gen, dev, torch)
        y = F.one_hot(torch.randint(0, zoo.num_classes, (batch,),
                                    generator=gen, device=dev),
                      zoo.num_classes).float()
        # ---- 18. step 0 against the float64 twin, masks, 5 fit steps --
        key = _random.split(net._rng)[1]          # the first step's key
        cpu_key = key.cpu()
        masks = _dropout_masks(net, key, x, torch)
        cpu_masks = _dropout_masks(net, cpu_key, x.cpu(), torch)
        masks_equal = {k: torch.equal(m.cpu(), cpu_masks[k])
                       for k, m in masks.items()}
        loss_of = _loss_fn(net)
        params = net._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss32 = loss_of(params, net.state, x, y, key)
        g32 = torch.autograd.grad(loss32, [params[k][n] for k, n in keys])
        loss32 = loss32.item()
        p64 = {k: {n: p.detach().double().requires_grad_(True)
                   for n, p in g.items()} for k, g in params.items()}
        loss64 = loss_of(p64, net.state, x.double(), y.double(), key)
        g64 = torch.autograd.grad(loss64, [p64[k][n] for k, n in keys])
        loss64 = loss64.item()
        del p64
        # the same f32 step with cuDNN off: another f32 summation of the
        # convolutions (PyTorch's im2col + GEMM), its distance to f64
        # printed beside the port's
        torch.backends.cudnn.enabled = False
        try:
            g_nat = torch.autograd.grad(
                loss_of(params, net.state, x, y, key),
                [params[k][n] for k, n in keys])
        finally:
            torch.backends.cudnn.enabled = True
        nat_err = nat_ref = 0.0
        for a, b in zip(g_nat, g64):
            d = a.double() - b
            nat_err += float((d * d).sum())
            nat_ref += float((b * b).sum())
        rel_l2_native = (nat_err / nat_ref) ** 0.5
        del g_nat
        net_max = max(g.abs().max().item() for g in g64)
        worst, worst_name, sq_err, sq_ref, leaf_rel = 0.0, "", 0.0, 0.0, []
        for (k, n), a, b in zip(keys, g32, g64):
            d = a.double() - b
            tol = ZOO_TOL_GRAD_LEAF * b.abs().max().item() \
                + ZOO_TOL_GRAD_NET * net_max
            ratio = d.abs().max().item() / tol
            if not bool(torch.isfinite(a).all()) or ratio >= worst:
                worst, worst_name = ratio, f"{k}/{n}"
            sq_err += float((d * d).sum())
            sq_ref += float((b * b).sum())
            leaf_rel.append((d.abs().max().item()
                             / max(b.abs().max().item(), 1e-30),
                             f"{k}/{n}"))
        rel_l2 = (sq_err / sq_ref) ** 0.5
        leaf_rel.sort(reverse=True)
        del g32, g64
        loss_err = abs(loss32 - loss64) / abs(loss64)
        torch.cuda.synchronize()
        fa.reset_launches()
        pb.reset_launches()
        losses = []
        t_fit = time.perf_counter()
        for _ in range(ZOO_STEPS):
            net.fit(x, y)
            losses.append(net._score)            # device scalars
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        launches = {**dict(fa.launches), **dict(pb.launches)}
        losses = [float(v) for v in losses]
        print(json.dumps({
            "phase": "zoo_train", "model": {
                "name": name, "net": type(net).__name__,
                "input": list(zoo.input_shape), "classes": zoo.num_classes,
                "batch": batch, "dtype": "float32", "tf32": False,
                "updater": repr(net._default_updater()),
                "num_params": net.num_params()},
            "dropout_masks": {k: list(m.shape) for k, m in masks.items()},
            "masks_equal_cpu": masks_equal,
            "step0_loss": loss32, "step0_loss_f64": loss64,
            "step0_loss_rel_err": loss_err, "tol_loss": ZOO_TOL_LOSS,
            "step0_grad_worst_err_over_tol": worst,
            "step0_grad_worst_param": worst_name,
            "step0_grad_max_err_over_leaf_max_top5": leaf_rel[:5],
            "step0_grad_rel_l2": rel_l2,
            "step0_grad_rel_l2_cudnn_off": rel_l2_native,
            "tol_grad": [ZOO_TOL_GRAD_LEAF, ZOO_TOL_GRAD_NET],
            "tol_grad_rel_l2": ZOO_TOL_GRAD_L2,
            "steps": ZOO_STEPS, "losses": losses,
            "kernel_launches": launches, "seconds_fit": round(fit_s, 4),
            "seconds": round(time.perf_counter() - t_phase, 3)}),
            flush=True)
        if not masks or not all(masks_equal.values()):
            return f"{name}: dropout masks on the card differ: {masks_equal}"
        if loss_err > ZOO_TOL_LOSS or worst > 1.0 or \
                rel_l2 > ZOO_TOL_GRAD_L2:
            return (f"{name}: step 0 differs from the f64 twin: loss "
                    f"{loss_err}, gradient {worst_name} at {worst} x tol, "
                    f"relative L2 {rel_l2}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            return f"{name}: losses {losses} not finite or not falling"
        if any(launches.values()):
            return f"{name}: the zoo path launched kernels {launches}"

        # ---- 19. times ----------------------------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(ZOO_TIMED_STEPS + 2):
            t1 = time.perf_counter()
            net.fit(x, y)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t1) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_ms = statistics.median(times)
        split = profile_steps(torch, net, [(x, y)] * PROFILED_STEPS,
                              ZOO_KERNEL_CLASSES)
        dev_ms = split["device_ms_total_per_step"]
        busy = dev_ms / step_ms if dev_ms else None
        split["device_busy_share"] = busy
        split["device_idle_share"] = None if busy is None else 1 - busy
        flops = model_flops(net.conf, batch)
        print(json.dumps({
            "phase": "zoo_train_time", "model": name, "batch": batch,
            "steps": ZOO_TIMED_STEPS, "step_ms_median": step_ms,
            "step_ms": times, "images_per_s": batch / step_ms * 1e3,
            "model_flops_per_step": flops,
            "model_flops_share_of_f32_peak":
                flops / (step_ms * 1e-3) / F32_PEAK_FLOPS,
            "f32_peak_flops": F32_PEAK_FLOPS, "peak_memory_gb": peak_gb,
            "profile": split, "card": card}), flush=True)
        del net, x, y
        torch.cuda.empty_cache()
    return None


def dropout_phase(args, torch, dev, card):
    """Phase 20.  Returns ``(launches per kernel over the run, None)`` or
    ``(None, what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadAttention, PositionalEncodingLayer)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                        _stack_loss)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.utils import _random
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    def transformer_lm(impl):
        net = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                            n_layers=LAYERS, n_heads=HEADS, attn_impl=impl,
                            sparse_labels=True, seed=args.seed).init(
                                device=dev)
        for lc in net.conf.layers[2:-1]:
            lc.dropout = 0.9
        return net

    def attention_lm(impl):
        layers = [EmbeddingSequenceLayer(n_out=EMBED),
                  PositionalEncodingLayer()]
        layers += [MultiHeadAttention(n_heads=HEADS, causal=True,
                                      attn_impl=impl, attn_dropout=0.9,
                                      dropout=0.9, activation="identity")
                   for _ in range(LAYERS)]
        layers.append(RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                     loss="sparse_mcxent"))
        for i, lc in enumerate(layers):
            lc.name = f"layer{i}"
        conf = MultiLayerConfiguration(
            layers=layers, input_type=InputType.recurrent(VOCAB, SEQ),
            defaults={"updater": Adam(learning_rate=3e-4),
                      "weight_init": "xavier"}, seed=args.seed)
        return MultiLayerNetwork(conf, device=dev).init()

    trng = np.random.default_rng(args.seed + 20)
    tokens = trng.integers(0, VOCAB, (DROPOUT_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(b[:, :-1], b[:, 1:]) for b in tokens]
    total = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    for what, build in (("transformer_lm_block_dropout", transformer_lm),
                        ("attention_lm_attn_dropout", attention_lm)):
        t_phase = time.perf_counter()
        net = build("auto")
        tree = seeded_params(net.param_spec(), args.seed)
        params_from_jax(net, tree)
        twin = params_from_jax(build("reference"), tree)
        # step 0 on the first fit step's key: the same masks on both
        key = _random.split(net._rng)[1]
        x0, y0 = (torch.as_tensor(a, device=dev) for a in batches[0])
        grads, loss0 = [], []
        for m in (net, twin):
            params = m._param_tree()
            keys = [(k, n) for k in params for n in params[k]]
            loss = _stack_loss(m.conf, params, x0, y0, train=True, key=key)
            grads.append(dict(zip(keys, torch.autograd.grad(
                loss, [params[k][n] for k, n in keys]))))
            loss0.append(loss.item())
        net_max = max(g.abs().max().item() for g in grads[1].values())
        worst, worst_name = 0.0, ""
        for k, g in grads[0].items():
            w = grads[1][k]
            tol = TOL_GRAD_LEAF * w.abs().max().item() \
                + TOL_GRAD_NET * net_max
            ratio = (g - w).abs().max().item() / tol
            if not bool(torch.isfinite(g).all()) or ratio >= worst:
                worst, worst_name = ratio, "/".join(k)
        del grads
        torch.cuda.synchronize()
        fa.reset_launches()
        losses = []
        for x, y in batches:
            net.fit(x, y)
            losses.append(net._score)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        losses = [float(v) for v in losses]
        ref_losses = []
        for x, y in batches:
            twin.fit(x, y)
            ref_losses.append(twin.get_score())
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        expected = {n: LAYERS * DROPOUT_STEPS for n in launches}
        print(json.dumps({
            "phase": "train_dropout", "model": what,
            "width": {"vocab": VOCAB, "seq": SEQ, "embed": EMBED,
                      "layers": LAYERS, "heads": HEADS,
                      "batch": TRAIN_BATCH},
            "dropout": 0.9, "attn_dropout": 0.9 if "attn" in what else None,
            "step0_loss": loss0, "step0_grad_worst_err_over_tol": worst,
            "step0_grad_worst_param": worst_name,
            "tol_grad": [TOL_GRAD_LEAF, TOL_GRAD_NET],
            "losses": losses, "reference_losses": ref_losses,
            "max_rel_loss_diff": diff, "tol_loss": TOL_TRAIN_LOSS,
            "kernel_launches": launches, "expected_launches": expected,
            "card": card, "seconds": round(time.perf_counter() - t_phase,
                                           3)}), flush=True)
        if worst > 1.0 or abs(loss0[0] - loss0[1]) > \
                TOL_TRAIN_LOSS * abs(loss0[1]):
            return None, (f"{what}: step 0 differs from the reference "
                          f"path: {worst_name} at {worst} x tol, losses "
                          f"{loss0}")
        if not all(np.isfinite(losses)) or diff > TOL_TRAIN_LOSS:
            return None, (f"{what}: losses {losses} vs reference "
                          f"{ref_losses}: {diff} > {TOL_TRAIN_LOSS}")
        if launches != expected:
            return None, (f"{what}: launches {launches}, expected "
                          f"{expected} ({LAYERS} per kernel per step)")
        for n in total:
            total[n] += launches[n]
        del net, twin
        torch.cuda.empty_cache()
    return total, None



# ---- 21-24. the rest of training ----------------------------------------
# 21: a small MLN (Dense 256 -> 256 -> 256, softmax 10, batch 64) under
# each of the 12 updaters for 5 steps, cycling through the 9 schedules,
# on the card beside the same port on the CPU from the same params.
# - The updaters' arithmetic: the 12 step the same gradients (drawn on
#   the host) on the card and on the CPU: the same f32 formulas, a
#   division by a scalar taken as a product with its reciprocal on the
#   card: params within 1e-5 of each leaf's largest |p|.
# - Training: the two nets differ by the order of f32 sums in the matrix
#   products (cuBLAS vs the CPU's BLAS, TF32 off).  Sgd-like updaters
#   move a parameter by lr times its gradient and stay ~1e-7 apart; the
#   normalizing ones (Adam and kin, RmsProp) divide by ~|g|, so an entry
#   whose gradient is near 0 (a ReLU unit whose pre-activation rounds to
#   the other side of 0, a cancelling sum) takes a step that depends on
#   that gradient's rounding: on an H100 Adam lands 2.75e-4 from the
#   CPU, and a CPU twin with the input features permuted (the same
#   arithmetic, the forward's sums in another order) 1.4e-4 (PERF.md
#   §6).  So the gate is max(1e-5, 4x that permuted twin's distance,
#   measured in the same run).
# Each of the 21 loss names, value and gradient on a [64, 10] batch with
# a mask and unit weights: the same f32 formulas, reduced in another
# order, within 1e-5 relative (gradients: of their largest entry).
UPD_WIDTH, UPD_CLASSES, UPD_BATCH, UPD_STEPS = 256, 10, 64, 5
UPD_NAMES = ("sgd", "nesterovs", "adam", "adamax", "nadam", "amsgrad",
             "adadelta", "adagrad", "rmsprop", "none", "adamw", "lion")
TOL_UPD_PARAMS = 1e-5
UPD_FLOOR_K = 4.0
TOL_LOSS_CARD = 1e-5
# 22: the char-LSTM of phases 10-12 (26 classes, 2 x LSTM-256 at
# helper="pallas", batch 128 x 64) built with the builder, under
# RmsProp(StepSchedule(2e-3, 0.5, 8)), DropConnect(0.9) on both LSTMs and
# MaxNorm(1.0) on the output W, early-stopped (at most 4 epochs of 8
# batches, patience 1) on 2 held-out batches, beside a helper=None twin
# with the same params and key stream (so the same DropConnect masks).
# Step 0's loss within TOL_LSTM_LOSS (the forward's rounding only); every
# later collected score within 1e-3 relative: each step's update rounds
# differently on the two sides (RmsProp divides by sqrt(nu) ~ |g|, so an
# f32-noise difference in g becomes a relative one in the update), and
# the loss drifts with it.  Confusion matrices of the best models equal
# except on rows whose two top probabilities lie within 1e-5.
ES_TRAIN_BATCHES, ES_HELD_BATCHES, ES_MAX_EPOCHS = 8, 2, 4
TOL_ES_SCORES = 1e-3
TIE_MARGIN = 1e-5
MAX_NORM, TOL_MAX_NORM = 1.0, 1e-6
# 23: the full-width TransformerLM of phase 5 under AdamW(Warmup(4,
# 3e-4), weight decay 0.01); the device holds 8 x 16 sequences (+ 8 for
# the ragged tail of the per-epoch run).  Step 0 within TOL_TRAIN_LOSS,
# later steps within 1e-3 relative (Adam-family updates turn f32 noise
# in a gradient into sign-level differences of lr on entries whose
# gradient is noise, e.g. mha_bk; the loss drifts slowly with them).
FOD_BATCH, FOD_BATCHES, FOD_TAIL = 16, 8, 8
TOL_FOD_LOSS = 1e-3
# 24: ResNet50 at its published widths, every BN at helper="pallas",
# fine-tuned through TransferLearning.GraphBuilder: frozen through
# s2b5_out, a new 10-class output on avgpool, Nadam(1e-3), 5 steps at
# batch 64, beside a helper=None twin restarted from the main net's
# params and state before each step (losses within CNN_TOL_LOSS).
TR_BATCH, TR_STEPS, TR_CLASSES = 64, 5, 10
TR_FEATURE_END = "s2b5_out"


class _Batches:
    """A DataSetIterator over a list of batches (``reset`` + iteration)."""

    def __init__(self, batches):
        self.batches = batches

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.batches)


def _host_tree(net):
    """A host copy of the params (a copy on a CPU net too, where
    ``.cpu().numpy()`` would share the params' memory)."""
    return {k: {n: p.detach().cpu().numpy().copy() for n, p in g.items()}
            for k, g in net.params.items()}


def _loss_data(name, rng, shape):
    """(labels, preout) in a loss's domain (numpy, f32)."""
    import numpy as np
    pre = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    if name == "sparse_mcxent":
        return rng.integers(0, n, shape[:-1]), pre
    if name in ("mcxent", "negativeloglikelihood"):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, shape[:-1])], \
            pre
    if name in ("kld", "kl_divergence"):
        lab = rng.random(shape).astype(np.float32) + 0.05
        return (lab / lab.sum(-1, keepdims=True)).astype(np.float32), pre
    if name in ("xent", "fmeasure", "hinge", "squared_hinge"):
        return (rng.random(shape) > 0.5).astype(np.float32), pre
    if name in ("mape", "mean_absolute_percentage_error"):
        return (rng.random(shape) + 0.5).astype(np.float32), pre
    if name == "poisson":
        return rng.poisson(2.0, shape).astype(np.float32), np.abs(pre) + 0.1
    return rng.standard_normal(shape).astype(np.float32), pre


def updaters_phase(args, torch, dev, card):
    """Phase 21.  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn import _common as tcommon
    from deeplearning4j_tpu_torch.nn import losses
    from deeplearning4j_tpu_torch.nn.conf import schedules as S
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                                OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    scheds = [S.StepSchedule(1e-2, 0.5, 2), S.ExponentialSchedule(1e-2, 0.8),
              S.InverseSchedule(1e-2, 0.5, 2.0),
              S.PolySchedule(1e-2, 2.0, 4), S.SigmoidSchedule(1e-2, 0.5, 2),
              S.MapSchedule({0: 1e-2, 2: 5e-3}),
              S.CycleSchedule(1e-3, 1e-2, 4), S.WarmupSchedule(3, 1e-2),
              S.FixedSchedule(1e-2)]

    def conf(u):
        return (NeuralNetConfiguration.builder().seed(args.seed)
                .activation("relu").updater(u).list()
                .layer(DenseLayer(n_out=UPD_WIDTH))
                .layer(DenseLayer(n_out=UPD_WIDTH))
                .layer(OutputLayer(n_out=UPD_CLASSES, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(UPD_WIDTH)).build())

    rng = np.random.default_rng(args.seed + 21)
    data = [(rng.standard_normal((UPD_BATCH, UPD_WIDTH)).astype(np.float32),
             np.eye(UPD_CLASSES, dtype=np.float32)[
                 rng.integers(0, UPD_CLASSES, UPD_BATCH)])
            for _ in range(UPD_STEPS)]
    perm = rng.permutation(UPD_WIDTH)

    def rel_err(a, b, permute=False):
        """max over leaves of max |a - b| / max |b| (a's first-layer rows
        put back in order where ``permute``)."""
        err = 0.0
        for k, g in b.items():
            for n, p in g.items():
                q = a[k][n].detach().cpu()
                if permute and k == "layer_0" and n == "W":
                    q = q[np.argsort(perm)]
                err = max(err, ((q - p.detach().cpu()).abs().max()
                                / p.detach().abs().max()).item())
        return err

    tree, rows, t0 = None, [], time.perf_counter()
    for i, name in enumerate(UPD_NAMES):
        sched = scheds[i % len(scheds)]
        nets = {where: MultiLayerNetwork(conf(updaters.by_name(name, sched)),
                                         device=d)
                for where, d in (("card", dev), ("cpu", "cpu"),
                                 ("cpu_permuted", "cpu"))}
        if tree is None:
            tree = seeded_params(nets["card"].param_spec(), args.seed + 21)
        permuted = {k: dict(g) for k, g in tree.items()}
        permuted["layer_0"]["W"] = tree["layer_0"]["W"][perm]
        for where, m in nets.items():
            params_from_jax(m, permuted if where == "cpu_permuted" else tree)
        for x, y in data:
            nets["card"].fit(x, y)
            nets["cpu"].fit(x, y)
            nets["cpu_permuted"].fit(x[:, perm].copy(), y)
        err = rel_err(nets["card"].params, nets["cpu"].params)
        floor = rel_err(nets["cpu_permuted"].params, nets["cpu"].params,
                        permute=True)
        tol = max(TOL_UPD_PARAMS, UPD_FLOOR_K * floor)
        # the updater alone: the same gradients on both sides
        groups = {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            ps = {k: {n: torch.tensor(a, device=d) for n, a in g.items()}
                  for k, g in tree.items()}
            tx = tcommon.build_tx(updaters.by_name(name, sched),
                                  {k: None for k in ps}, ps)
            groups[where] = (ps, tx, tx.init(ps))
        for _ in range(UPD_STEPS):
            grads = {k: {n: (rng.standard_normal(a.shape) * 0.1).astype(
                np.float32) for n, a in g.items()} for k, g in tree.items()}
            for where, d in (("card", dev), ("cpu", "cpu")):
                ps, tx, st = groups[where]
                tx.step(ps, {k: {n: torch.tensor(a, device=d)
                                 for n, a in g.items()}
                             for k, g in grads.items()}, st)
        same_g = rel_err(groups["card"][0], groups["cpu"][0])
        moved = not np.allclose(nets["cpu"].params["layer_0"]["W"].detach()
                                .numpy(), tree["layer_0"]["W"])
        rows.append({"updater": type(nets["card"].conf.defaults["updater"])
                     .__name__, "schedule": type(sched).__name__,
                     "max_rel_err_params": err,
                     "cpu_permuted_twin_rel_err": floor, "tol": tol,
                     "same_gradients_rel_err": same_g, "moved": moved})
        if err > tol or same_g > TOL_UPD_PARAMS or \
                (name != "none" and not moved):
            print(json.dumps({"phase": "updaters_on_card", "rows": rows}),
                  flush=True)
            return (f"{rows[-1]['updater']} + {rows[-1]['schedule']}: "
                    f"params on the card vs the CPU {err} (tol {tol}), "
                    f"same gradients {same_g} (tol {TOL_UPD_PARAMS}), "
                    f"moved: {moved}")
    loss_rows = {}
    for name in losses.names():
        lab, pre = _loss_data(name, rng, (UPD_BATCH, UPD_CLASSES))
        mask = (rng.random(UPD_BATCH) > 0.2).astype(np.float32)
        uw = (rng.random(UPD_CLASSES) + 0.5).astype(np.float32)
        vals, grads = [], []
        for d in (dev, torch.device("cpu")):
            p = torch.tensor(pre, device=d, requires_grad=True)
            v = losses.get(name)(torch.as_tensor(lab, device=d), p,
                                 mask=torch.tensor(mask, device=d),
                                 unit_weights=torch.tensor(uw, device=d))
            g, = torch.autograd.grad(v, p)
            vals.append(v.item())
            grads.append(g.cpu())
        v_err = abs(vals[0] - vals[1]) / max(abs(vals[1]), 1e-30)
        g_err = ((grads[0] - grads[1]).abs().max()
                 / grads[1].abs().max().clamp(min=1e-30)).item()
        loss_rows[name] = {"value": vals[1], "rel_err_value": v_err,
                           "rel_err_grad": g_err}
        if v_err > TOL_LOSS_CARD or g_err > TOL_LOSS_CARD:
            return (f"loss {name} on the card vs the CPU: value {v_err}, "
                    f"gradient {g_err} > {TOL_LOSS_CARD}")
    print(json.dumps({"phase": "updaters_on_card", "model": {
        "layers": f"Dense {UPD_WIDTH} -> {UPD_WIDTH} -> {UPD_WIDTH}, "
                  f"softmax {UPD_CLASSES}", "batch": UPD_BATCH,
        "steps": UPD_STEPS}, "rows": rows, "tol_params": TOL_UPD_PARAMS,
        "floor_k": UPD_FLOOR_K,
        "losses": loss_rows, "tol_loss": TOL_LOSS_CARD,
        "seconds": round(time.perf_counter() - t0, 3), "card": card}),
        flush=True)
    return None


def _markov_text(rng, n, t, classes):
    """``n`` one-hot sequences of ``t + 1`` characters from a seeded
    Markov chain with peaked rows (something an LSTM can learn)."""
    import numpy as np
    trans = rng.dirichlet(np.full(classes, 0.2), size=classes)
    seq = np.empty((n, t + 1), np.int64)
    seq[:, 0] = rng.integers(0, classes, n)
    cum = trans.cumsum(-1)
    for s in range(t):
        u = rng.random(n)[:, None]
        seq[:, s + 1] = np.minimum((u > cum[seq[:, s]]).sum(-1),
                                   classes - 1)
    eye = np.eye(classes, dtype=np.float32)
    return eye[seq[:, :-1]], eye[seq[:, 1:]]


def early_stop_phase(args, torch, dev, card):
    """Phase 22.  Returns ``(lstm_fwd launches, None)`` or ``(None, what
    failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.nn.conf.constraints import \
        MaxNormConstraint
    from deeplearning4j_tpu_torch.nn.conf.dropout import DropConnect
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.schedules import StepSchedule
    from deeplearning4j_tpu_torch.nn.conf.updaters import RmsProp
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.train import listeners as L

    def conf(helper):
        return (NeuralNetConfiguration.builder().seed(args.seed)
                .updater(RmsProp(learning_rate=StepSchedule(2e-3, 0.5, 8)))
                .weight_init("xavier")
                .gradient_normalization("clipelementwiseabsolutevalue", 10.0)
                .list()
                .layer(LSTM(n_out=LSTM_HIDDEN, activation="tanh",
                            helper=helper, weight_noise=DropConnect(0.9)))
                .layer(LSTM(n_out=LSTM_HIDDEN, activation="tanh",
                            helper=helper, weight_noise=DropConnect(0.9)))
                .layer(RnnOutputLayer(
                    n_out=LSTM_CLASSES, activation="softmax", loss="mcxent",
                    constraints=[MaxNormConstraint(max_norm=MAX_NORM)]))
                .set_input_type(InputType.recurrent(LSTM_CLASSES, LSTM_T))
                .build())

    net = MultiLayerNetwork(conf("pallas"), device=dev).init()
    twin = MultiLayerNetwork(conf(None), device=dev).load_params(
        _host_tree(net))
    rng = np.random.default_rng(args.seed + 22)
    xs, ys = _markov_text(rng, LSTM_BATCH * (ES_TRAIN_BATCHES
                                             + ES_HELD_BATCHES),
                          LSTM_T, LSTM_CLASSES)
    xs, ys = torch.tensor(xs, device=dev), torch.tensor(ys, device=dev)
    cut = [(xs[i:i + LSTM_BATCH], ys[i:i + LSTM_BATCH])
           for i in range(0, len(xs), LSTM_BATCH)]
    train, held = cut[:ES_TRAIN_BATCHES], cut[ES_TRAIN_BATCHES:]

    class NormWatch(L.TrainingListener):
        """The output W's largest column norm after each step, kept on
        the card (read once at the end)."""

        def __init__(self):
            self.norms = []

        def iteration_done(self, model, iteration, epoch):
            w = model.params["layer_2"]["W"].detach()
            self.norms.append(torch.linalg.vector_norm(w, dim=0).max())

    runs = {}
    for name, m in (("pallas", net), ("plain", twin)):
        collect, watch = L.CollectScoresIterationListener(), NormWatch()
        m.set_listeners(L.ScoreIterationListener(1), collect,
                        L.PerformanceListener(), watch)
        cfg = (es.EarlyStoppingConfiguration.builder()
               .score_calculator(es.DataSetLossCalculator(_Batches(held)))
               .model_saver(es.InMemoryModelSaver())
               .epoch_termination_conditions(
                   es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                   es.ScoreImprovementEpochTerminationCondition(1))
               .build())
        torch.cuda.synchronize()
        pl.reset_launches()
        t0 = time.perf_counter()
        res = es.EarlyStoppingTrainer(cfg, m, _Batches(train)).fit()
        ev = res.best_model.evaluate(_Batches(held))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[name] = dict(res=res, ev=ev, scores=[s for _, s in
                                                  collect.scores],
                          norms=torch.stack(watch.norms).cpu().numpy(),
                          launches=pl.launches["lstm_fwd"],
                          seconds=seconds)
        m.set_listeners()
    a, b = runs["pallas"], runs["plain"]
    steps = len(a["scores"])
    evaluated = len(a["res"].score_vs_epoch)
    expected = 2 * steps + 2 * ES_HELD_BATCHES * evaluated \
        + 2 * ES_HELD_BATCHES
    step0 = abs(a["scores"][0] - b["scores"][0]) / abs(b["scores"][0])
    later = max([abs(p - q) / abs(q) for p, q in
                 zip(a["scores"][1:], b["scores"][1:])] or [0.0])
    # confusion matrices, ties (top two within TIE_MARGIN) excepted
    probs = []
    for m in (a["res"].best_model, b["res"].best_model):
        probs.append(torch.cat([m.output(x) for x, _ in held]).reshape(
            -1, LSTM_CLASSES))
    labels = torch.cat([y for _, y in held]).reshape(-1, LSTM_CLASSES)
    top2 = [p.topk(2, dim=-1).values for p in probs]
    gaps = [t[:, 0] - t[:, 1] for t in top2]
    pred = [p.argmax(-1) for p in probs]
    differ = pred[0] != pred[1]
    ties = differ & ((gaps[0] < TIE_MARGIN) | (gaps[1] < TIE_MARGIN))
    untied_differ = int((differ & ~ties).sum())
    keep = ~ties
    conf_eq = True
    for p, ev in zip(pred, (a["ev"], b["ev"])):
        cm = torch.zeros((LSTM_CLASSES, LSTM_CLASSES), dtype=torch.int64)
        idx = labels.argmax(-1)
        cm.index_put_((idx.cpu(), p.cpu()), torch.ones_like(idx.cpu()),
                      accumulate=True)
        conf_eq &= bool(np.array_equal(cm.numpy(), ev.confusion.matrix))
    cm_a, cm_b = a["ev"].confusion.matrix, b["ev"].confusion.matrix
    tie_rows = int(ties.sum())
    cms_equal = bool(np.array_equal(cm_a, cm_b))
    max_norm = float(max(a["norms"].max(), b["norms"].max()))

    # step time with and without the listeners, in turn
    lis = [L.ScoreIterationListener(1), L.CollectScoresIterationListener(),
           L.PerformanceListener()]
    step_ms = {"listeners": [], "none": []}
    # in turns, three epochs each: the host's pace drifts within a call
    for which in ("none", "listeners", "listeners", "none", "none",
                  "listeners"):
        net.set_listeners(*(lis if which == "listeners" else ()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(_Batches(train))
        torch.cuda.synchronize()
        step_ms[which].append((time.perf_counter() - t1) * 1e3
                              / ES_TRAIN_BATCHES)
    net.set_listeners()
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    print(json.dumps({
        "phase": "early_stop_lstm", "model": {
            "name": "TextGenerationLSTM (builder)", "classes": LSTM_CLASSES,
            "hidden": LSTM_HIDDEN, "batch": LSTM_BATCH, "t": LSTM_T,
            "updater": "RmsProp(StepSchedule(2e-3, 0.5, 8))",
            "weight_noise": "DropConnect(0.9) on both LSTMs",
            "constraint": f"MaxNorm({MAX_NORM}) on the output W",
            "helper": "pallas"},
        "termination": [a["res"].termination_reason,
                        a["res"].termination_details],
        "twin_termination": [b["res"].termination_reason,
                             b["res"].termination_details],
        "best_epoch": [a["res"].best_model_epoch,
                       b["res"].best_model_epoch],
        "score_vs_epoch": a["res"].score_vs_epoch,
        "twin_score_vs_epoch": b["res"].score_vs_epoch,
        "steps": steps, "scores": a["scores"], "twin_scores": b["scores"],
        "step0_rel_diff": step0, "tol_step0": TOL_LSTM_LOSS,
        "later_max_rel_diff": later, "tol_later": TOL_ES_SCORES,
        "confusion_equal": cms_equal, "tie_rows": tie_rows,
        "untied_rows_differing": untied_differ,
        "evaluate_matches_outputs": conf_eq,
        "accuracy": [a["ev"].accuracy(), b["ev"].accuracy()],
        "max_output_col_norm": max_norm, "max_norm": MAX_NORM,
        "kernel_launches": a["launches"], "expected_launches": expected,
        "twin_launches": b["launches"], "seconds": round(a["seconds"], 3),
        "twin_seconds": round(b["seconds"], 3),
        "fit_step_ms_median_listeners": med["listeners"],
        "fit_step_ms_median_no_listeners": med["none"],
        "fit_step_ms": step_ms, "card": card}), flush=True)
    if step0 > TOL_LSTM_LOSS or later > TOL_ES_SCORES:
        return None, (f"early-stopped char-LSTM scores vs twin: step 0 "
                      f"{step0} (tol {TOL_LSTM_LOSS}), later {later} (tol "
                      f"{TOL_ES_SCORES})")
    if a["res"].best_model_epoch != b["res"].best_model_epoch or \
            a["res"].termination_details != b["res"].termination_details:
        return None, "early stopping: best epoch or reason differs from twin"
    if untied_differ or not conf_eq or (not cms_equal and not tie_rows):
        return None, (f"best models' confusion matrices differ outside ties "
                      f"({untied_differ} rows)")
    if max_norm > MAX_NORM + TOL_MAX_NORM:
        return None, f"output W column norm {max_norm} > {MAX_NORM}"
    if a["launches"] != expected or b["launches"]:
        return None, (f"lstm_fwd launched {a['launches']} times (twin "
                      f"{b['launches']}); expected {expected}")
    return a["launches"], None


def fit_on_device_phase(args, torch, dev, card):
    """Phase 23.  Returns ``(flash launches, None)`` or ``(None, what
    failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.schedules import WarmupSchedule
    from deeplearning4j_tpu_torch.nn.conf.updaters import AdamW
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.train import listeners as L
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    def make(impl):
        zoo = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                            n_layers=LAYERS, n_heads=HEADS, attn_impl=impl,
                            sparse_labels=True, seed=args.seed,
                            updater=AdamW(learning_rate=WarmupSchedule(
                                4, 3e-4), weight_decay=0.01))
        return MultiLayerNetwork(zoo.conf(), device=dev)

    net, twin = make("auto"), make("reference")
    tree = seeded_params(net.param_spec(), args.seed + 23)
    params_from_jax(net, tree)
    params_from_jax(twin, tree)
    n = FOD_BATCH * FOD_BATCHES
    rng = np.random.default_rng(args.seed + 23)
    ids = torch.tensor(rng.integers(0, VOCAB, (n + FOD_TAIL, SEQ + 1)),
                       device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    losses, perms, collected = {}, {}, {}
    for name, m in (("flash", net), ("reference", twin)):
        rec = losses[name] = []
        inner = m._device_step

        def step(bx, by, key, _inner=inner, _rec=rec):
            loss = _inner(bx, by, key)
            _rec.append(loss.detach())
            return loss
        m._device_step = step
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    for name, m in (("flash", net), ("reference", twin)):
        if name == "reference":
            main_launches = dict(fa.launches)
            main_s = time.perf_counter() - t0
        # fused: 2 epochs of the 128 sequences, no listener, no tail
        m.fit_on_device(x[:n], y[:n], batch_size=FOD_BATCH, epochs=2,
                        shuffle=True)
        perms[name] = [p.cpu() for p in m.last_permutations]
        # per epoch: a listener and a ragged tail of FOD_TAIL
        coll = L.CollectScoresIterationListener()
        m.set_listeners(coll)
        m.fit_on_device(x, y, batch_size=FOD_BATCH, epochs=1, shuffle=True)
        m.set_listeners()
        perms[name] += [p.cpu() for p in m.last_permutations]
        collected[name] = coll.scores
        torch.cuda.synchronize()
    steps = 2 * FOD_BATCHES + FOD_BATCHES + 1
    expected = {k: LAYERS * steps for k in main_launches}
    la = [float(v) for v in losses["flash"]]
    lb = [float(v) for v in losses["reference"]]
    step0 = abs(la[0] - lb[0]) / abs(lb[0])
    later = max(abs(p - q) / abs(q) for p, q in zip(la[1:], lb[1:]))
    tail_diff = max(abs(p - q) / abs(q) for (_, p), (_, q) in
                    zip(collected["flash"], collected["reference"]))
    perms_equal = len(perms["flash"]) == 3 and all(
        torch.equal(p, q) for p, q in zip(perms["flash"],
                                          perms["reference"]))
    # fit_on_device against fit over the same 8 batches (host arrays in,
    # as a user's loop feeds them), in turn
    del net._device_step, twin      # the recorders go with the twin

    xh, yh = x[:n].cpu().numpy(), y[:n].cpu().numpy()
    step_ms = {"fit_on_device": [], "fit": []}
    for which in ("fit_on_device", "fit", "fit", "fit_on_device"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if which == "fit":
            perm = net.last_permutations[-1].cpu().numpy()
            for s in range(FOD_BATCHES):
                idx = perm[s * FOD_BATCH:(s + 1) * FOD_BATCH]
                net.fit(xh[idx], yh[idx])
        else:
            net.fit_on_device(x[:n], y[:n], batch_size=FOD_BATCH, epochs=1,
                              shuffle=True)
        torch.cuda.synchronize()
        step_ms[which].append((time.perf_counter() - t1) * 1e3
                              / FOD_BATCHES)
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    print(json.dumps({
        "phase": "fit_on_device_lm", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "batch": FOD_BATCH, "sequences_on_device": n,
            "tail": FOD_TAIL, "updater": "AdamW(WarmupSchedule(4, 3e-4), "
                                         "weight_decay=0.01)"},
        "steps": steps, "losses": la, "reference_losses": lb,
        "step0_rel_diff": step0, "tol_step0": TOL_TRAIN_LOSS,
        "later_max_rel_diff": later, "tol_later": TOL_FOD_LOSS,
        "listener_scores": collected["flash"],
        "reference_listener_scores": collected["reference"],
        "listener_max_rel_diff": tail_diff,
        "permutations_equal": perms_equal,
        "kernel_launches": main_launches, "expected_launches": expected,
        "seconds": round(main_s, 3),
        "fit_on_device_step_ms_median": med["fit_on_device"],
        "fit_step_ms_median": med["fit"], "step_ms": step_ms,
        "card": card}), flush=True)
    if not perms_equal:
        return None, "fit_on_device: the twins' permutations differ"
    if not np.isfinite(la).all() or step0 > TOL_TRAIN_LOSS or \
            later > TOL_FOD_LOSS or tail_diff > TOL_FOD_LOSS:
        return None, (f"fit_on_device losses vs the reference twin: step 0 "
                      f"{step0}, later {later}, listener {tail_diff}")
    if main_launches != expected:
        return None, (f"fit_on_device launched {main_launches}; expected "
                      f"{expected} ({LAYERS} per kernel per step)")
    return main_launches, None


def transfer_phase(args, torch, dev, card):
    """Phase 24.  Returns ``(bn_apply launches, None)`` or ``(None, what
    failed)``."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.updaters import Nadam
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
    from deeplearning4j_tpu_torch.nn.transfer_learning import \
        TransferLearning
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb

    zoo = ResNet50(seed=args.seed)

    def source(helper):
        conf = zoo.conf()
        for v in conf.vertices.values():
            lc = getattr(v, "layer", None)
            if type(lc).__name__ == "BatchNormalization":
                lc.helper = helper
        return ComputationGraph(conf, device=dev)

    def edit(src):
        return (TransferLearning.GraphBuilder(src)
                .fine_tune_configuration(updater=Nadam(learning_rate=1e-3))
                .set_feature_extractor(TR_FEATURE_END)
                .remove_vertex_and_connections("out")
                .add_layer("out", OutputLayer(n_out=TR_CLASSES,
                                              activation="softmax",
                                              loss="mcxent"), "avgpool")
                .set_outputs("out").build())

    src = source("pallas").init()
    twin_src = source(None).load_params(_host_tree(src))
    net, twin = edit(src), edit(twin_src)
    del src, twin_src
    twin.load_params(_host_tree(net))
    frozen = sorted(k for k, v in net.conf.vertices.items()
                    if isinstance(getattr(v, "layer", None), FrozenLayer))
    trained_bn = [k for k, v in net.conf.vertices.items()
                  if type(getattr(v, "layer", None)).__name__
                  == "BatchNormalization"]
    before = {k: {n: t.detach().clone() for n, t in net.params[k].items()}
              for k in frozen if k in net.params}
    state0 = {k: {n: t.clone() for n, t in net.state[k].items()}
              for k in frozen if net.state.get(k)}
    h, w, c = zoo.input_shape
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 24)
    xs = [torch.randn((TR_BATCH, h, w, c), generator=dgen, device=dev)
          for _ in range(TR_STEPS)]
    ys = [F.one_hot(torch.randint(0, TR_CLASSES, (TR_BATCH,),
                                  generator=dgen, device=dev),
                    TR_CLASSES).float() for _ in range(TR_STEPS)]
    losses, twin_losses, launches, step_ms = [], [], 0, []
    for x, y in zip(xs, ys):
        with torch.no_grad():
            for k, g in net.params.items():
                for n, p in g.items():
                    twin.params[k][n].copy_(p)
        twin.state = {k: {n: t.clone() for n, t in g.items()}
                      for k, g in net.state.items()}
        torch.cuda.synchronize()
        pb.reset_launches()
        t1 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        launches += pb.launches["bn_apply"]
        twin.fit(x, y)
        losses.append(net.get_score())
        twin_losses.append(twin.get_score())
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, twin_losses))
    moved = [f"{k}/{n}" for k, g in before.items() for n, t in g.items()
             if not torch.equal(net.params[k][n], t)]
    moved += [f"{k}/{n}" for k, g in state0.items() for n, t in g.items()
              if not torch.equal(net.state[k][n], t)]
    expected = len(trained_bn) * TR_STEPS
    print(json.dumps({
        "phase": "transfer_resnet", "model": {
            "source": "ResNet50() 224x224x3, every BN helper=pallas",
            "feature_extractor": TR_FEATURE_END, "new_output":
                f"OutputLayer({TR_CLASSES}, softmax, mcxent) on avgpool",
            "updater": "Nadam(1e-3)", "batch": TR_BATCH,
            "num_params": net.num_params(),
            "frozen_vertices": len(frozen),
            "trained_bn_layers": len(trained_bn)},
        "steps": TR_STEPS, "losses": losses, "twin_losses": twin_losses,
        "max_rel_loss_diff": diff, "tol_loss": CNN_TOL_LOSS,
        "frozen_params_and_stats_moved": moved,
        "kernel_launches": launches, "expected_launches": expected,
        "frozen_bn_launch": False, "step_ms": step_ms,
        "step_ms_median": statistics.median(step_ms),
        "images_per_s": TR_BATCH / statistics.median(step_ms) * 1e3,
        "card": card}), flush=True)
    if moved:
        return None, f"transfer learning moved frozen tensors: {moved[:5]}"
    if diff > CNN_TOL_LOSS:
        return None, (f"transfer ResNet50 losses {losses} vs twin "
                      f"{twin_losses}: {diff} > {CNN_TOL_LOSS}")
    if launches != expected:
        return None, (f"bn_apply launched {launches} times; expected "
                      f"{expected} (the {len(trained_bn)} trained BNs; "
                      "frozen BNs run in inference mode)")
    return launches, None


# ---- 25-30. precision and memory, the int8 KV pool, the solvers --------
# 25: the full-width TransformerLM of phase 5 under precision("bfloat16")
# (bf16 compute, f32 masters, no loss scale), PREC_STEPS Adam steps beside
# an f32 twin from the same params on the same batches.  Step 0's loss
# within TOL_BF16_LM_LOSS of the twin's (its derivation is above, by
# TOL_TRAIN_LOSS); masters and every updater slot f32 after each step;
# each flash kernel launched LAYERS times a step in bf16.  Then the step
# time of both and their device busy share, and one served batch-16
# output from a bf16 copy of the trained net (the layers' dtype
# "bfloat16": the inference path runs the forward kernel in bf16).
PREC_STEPS, PREC_TIMED_STEPS, PREC_PROFILED = 5, 8, 2
# the served bf16 rows against the f32 net's: probabilities of a softmax
# whose logits carry bf16 rounding (2**-9 relative of |logit| ~ 10,
# ~2e-2 abs): 5e-2 abs, rows summing to 1 within 1e-2 (bf16 outputs).
TOL_BF16_SERVE, TOL_BF16_ROWSUM = 5e-2, 1e-2
# 26a: the same LM under PrecisionPolicy(compute_dtype="float16",
# loss_scale="dynamic", initial_scale=2**40): the scaled f16 backward
# overflows, each skipped step halves the scale and leaves params, updater
# slots and counts bit-equal; the first finite step trains, then
# F16_CLEAN_STEPS more, each batch fitted until it trains (a later batch
# may overflow at a scale the first did not: dynamic scaling backs off
# again, and every skip is held to the same checks).  At most
# F16_MAX_SKIPS skips.  Twins at a cut size (the same params' first
# F16_TWIN_LAYERS blocks, one sequence of F16_TWIN_SEQ tokens) count
# their skips on the card and on the CPU (by bisection: a CPU step of
# f16 work takes seconds), printed beside the full-size count.
F16_INITIAL_SCALE, F16_CLEAN_STEPS, F16_MAX_SKIPS = 2.0 ** 40, 3, 60
F16_TWIN_LAYERS, F16_TWIN_SEQ = 1, 32
# 26b: the char-LSTM of phase 11 (helper="pallas") trained by tBPTT in
# chunks of LSTM_T // 4 under precision("float16"), with 1e30 in chunk
# 1's inputs: that chunk overflows and is skipped, the next three train
# from its pre-step carries; lstm_fwd launched twice per chunk.
F16_TBPTT_CHUNKS = 4
# 27: the LM in f32 with and without cache_mode("remat"), REMAT_STEPS
# steps each from the same params: losses and params bitwise equal (the
# flash backward is bitwise deterministic, and the replayed forward is
# the same computation); each remat step launches the forward kernel
# 2 x LAYERS times.  The analytic report's static part (params and
# updater slots, f32) against the growth of torch.cuda.memory_allocated
# when the net and its updater state are made: within the caching
# allocator's rounding, 512 bytes per tensor.  Then each net's step time.
REMAT_STEPS, REMAT_TIMED_STEPS, ALLOC_ROUND = 3, 6, 512
# 28: ResNet50(compute_dtype="bfloat16") at its published widths, batch
# 64 (CNN_BATCH), every BN at helper="pallas", RN_BF16_STEPS Nesterovs
# steps beside an f32 twin on the same params and batches.  BN is in
# keep_f32, so its 53 launches a step take f32 inputs; its running
# statistics stay f32.  Step 0's loss within TOL_BF16_RESNET_LOSS of the
# twin's, derived on the CPU from the JAX package's own gap
# (tests/test_torch_precision_kernels_kv.py::
# test_chip_bf16_resnet_gate_is_derived_from_the_jax_gap): at 64x64,
# batch 8, the JAX ResNet50's bf16 loss at init sits up to RN_GAP_SMALL
# from its f32 loss (measured 4.6e-2: fifty layers of bf16 rounding
# through BNs that renormalise every stage); twice that.  Then one step
# with keep_f32=() from the initial params: every BN runs in bf16, and
# each of its 53 bf16 bn_apply launches is held against the plain
# version on the same inputs (BN_TOL_BF16).
RN_BF16_STEPS, RN_INPUT, RN_CLASSES = 5, (224, 224, 3), 1000
RN_GAP_SMALL = 5e-2
TOL_BF16_RESNET_LOSS = 2 * RN_GAP_SMALL
# 29: the generation engine of phase 13 (GEN_SLOTS slots, GEN_REQUESTS
# greedy requests of INT8_NEW tokens: a stream that leaves the f32
# pool's at one token differs from there on, so streams are kept short)
# with PrecisionPolicy(kv_dtype="int8") beside the f32 pool: quantized codes and scales bitwise equal,
# card against CPU, on the same K/V; int8 cache bytes <= 0.5 x f32; the
# greedy streams equal the f32 pool's in all but at most one request of
# each group of three (the JAX test's gate: int8 moves logits by ~1 %, a
# near-tied argmax may flip).  The decode step with 16 active for both.
INT8_NEW = 16
# 30: LBFGS, CG and line gradient descent on the builder MLN of phase 21
# (Dense 256 x2 -> softmax 10, batch 64), SOLVER_ITERS iterations each,
# card against a CPU twin from the same params: the first three scores
# within 1e-5 relative (f32 sums in another order), the final score no
# worse than the CPU's + 1e-4 (a line search may halve once more on one
# side).  Then EvaluationBinary and EvaluationCalibration of the trained
# nets' outputs: counts equal to the CPU's outside ties (an output within
# TIE_MARGIN of a decision threshold or a bin edge).
SOLVER_ITERS = 20
TOL_SOLVER_SCORES, SOLVER_FINAL_SLACK = 1e-5, 1e-4


def _lm_net(args, dev, tree, **zoo_kw):
    """The full-width TransformerLM (sparse labels, Adam) on ``dev`` with
    the params of ``tree``; ``zoo_kw`` edits the zoo model, and
    ``defaults`` (a dict) the configuration's defaults."""
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax
    defaults = dict(zoo_kw.pop("defaults", {}))
    pol = defaults.get("precision")
    if getattr(pol, "compute_dtype", None):
        # as the builder's precision() does: the knob the memory report
        # reads
        defaults["compute_dtype"] = pol.compute_dtype
    conf = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                         n_layers=LAYERS, n_heads=HEADS, sparse_labels=True,
                         seed=args.seed, **zoo_kw).conf()
    conf.defaults.update(defaults)
    return params_from_jax(MultiLayerNetwork(conf, device=dev), tree)


def _lm_tree(args, dev, offset: int):
    """Seeded params for the full-width TransformerLM (the spec read
    without allocating them)."""
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                         n_layers=LAYERS, n_heads=HEADS,
                         sparse_labels=True).conf()
    return seeded_params(MultiLayerNetwork(conf, device=dev).param_spec(),
                         args.seed + offset)


def _all_f32(net) -> bool:
    import torch
    if any(p.dtype != torch.float32 for p in net.params.parameters()):
        return False
    return all(t.dtype == torch.float32
               for g in net.opt_state["slots"].values()
               for sl in g.values() for t in sl.values())


def _timed_steps(torch, net, batches, n):
    times = []
    for i in range(n + 2):
        x, y = batches[i % len(batches)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times)


def precision_lm_phase(args, torch, dev, card):
    """Phase 25.  Returns ``(bf16 flash launches, None)`` or ``(None,
    what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.precision import named_policy
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 25)
    net = _lm_net(args, dev, tree,
                  defaults={"precision": named_policy("bfloat16")})
    net32 = _lm_net(args, dev, tree)
    rng = np.random.default_rng(args.seed + 25)
    toks = rng.integers(0, VOCAB, (PREC_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(torch.as_tensor(b[:, :-1], device=dev),
                torch.as_tensor(b[:, 1:], device=dev)) for b in toks]
    losses, losses32, f32_kept = [], [], []
    torch.cuda.synchronize()
    fa.reset_launches()
    for x, y in batches:
        net.fit(x, y)
        losses.append(net.get_score())
        f32_kept.append(_all_f32(net))
    launches = dict(fa.launches_by_dtype)
    for x, y in batches:
        net32.fit(x, y)
        losses32.append(net32.get_score())
    step0 = abs(losses[0] - losses32[0]) / abs(losses32[0])
    expected = {(k, "bfloat16"): LAYERS * PREC_STEPS
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
    step_ms = {"bfloat16": _timed_steps(torch, net, batches,
                                        PREC_TIMED_STEPS),
               "float32": _timed_steps(torch, net32, batches,
                                       PREC_TIMED_STEPS)}
    prof = {}
    for name, m in (("bfloat16", net), ("float32", net32)):
        split = profile_steps(torch, m, batches[:PREC_PROFILED],
                              LM_KERNEL_CLASSES)
        split["device_busy_share"] = (
            split["device_ms_total_per_step"] / step_ms[name]
            if split["device_ms_total_per_step"] else None)
        prof[name] = split
    # one served batch-16 request from a bf16 copy of the trained net
    host = _host_tree(net)
    serve = _lm_net(args, dev, host, defaults={"dtype": "bfloat16"})
    x16 = torch.as_tensor(toks[0][:, :-1], device=dev)
    fa.reset_launches()
    with torch.inference_mode():
        out = serve.output(x16)
    torch.cuda.synchronize()
    serve_launches = dict(fa.launches_by_dtype)
    want = _lm_net(args, dev, host).output(x16)
    serve_err = (out.float() - want).abs().max().item()
    rowsum = (out.float().sum(-1) - 1).abs().max().item()
    serve_ms = median_ms(lambda: serve.output(x16), torch, runs=10)
    print(json.dumps({
        "phase": "precision_lm", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "batch": TRAIN_BATCH,
            "policy": "precision('bfloat16')", "updater": "Adam(3e-4)"},
        "steps": PREC_STEPS, "losses": losses, "f32_twin_losses": losses32,
        "step0_rel_diff": step0, "tol_step0": TOL_BF16_LM_LOSS,
        "masters_and_slots_f32_each_step": f32_kept,
        "kernel_launches_by_dtype": {f"{k}/{d}": v
                                     for (k, d), v in launches.items()},
        "expected_launches_bf16": LAYERS * PREC_STEPS,
        "step_ms_median": step_ms["bfloat16"],
        "f32_twin_step_ms_median": step_ms["float32"],
        "tokens_per_s": TRAIN_BATCH * SEQ / step_ms["bfloat16"] * 1e3,
        "device_busy_share": prof["bfloat16"]["device_busy_share"],
        "f32_twin_device_busy_share": prof["float32"]["device_busy_share"],
        "profile": prof["bfloat16"], "f32_twin_profile": prof["float32"],
        "served_bf16": {"batch": TRAIN_BATCH, "shape": list(out.shape),
                        "dtype": str(out.dtype).split(".")[-1],
                        "max_abs_err_vs_f32": serve_err,
                        "tol": TOL_BF16_SERVE, "row_sum_err": rowsum,
                        "kernel_launches_by_dtype": {
                            f"{k}/{d}": v
                            for (k, d), v in serve_launches.items()},
                        "ms_median": serve_ms},
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not all(np.isfinite(losses)) or step0 > TOL_BF16_LM_LOSS:
        return None, (f"bf16 LM step-0 loss {losses[0]} vs f32 "
                      f"{losses32[0]}: {step0} > {TOL_BF16_LM_LOSS}")
    if not all(f32_kept):
        return None, f"bf16 LM masters or slots left f32: {f32_kept}"
    if launches != expected:
        return None, (f"bf16 LM launched {launches}; expected {expected} "
                      f"({LAYERS} bf16 launches per kernel per step)")
    if serve_launches != {("fwd", "bfloat16"): LAYERS} or \
            not bool(torch.isfinite(out.float()).all()) or \
            serve_err > TOL_BF16_SERVE or rowsum > TOL_BF16_ROWSUM:
        return None, (f"bf16 served batch: launches {serve_launches}, "
                      f"error {serve_err}, row sums {rowsum}")
    return {k: v for (k, _), v in launches.items()}, None


def _snapshot(net):
    return ({k: {n: t.detach().clone() for n, t in g.items()}
             for k, g in net.params.items()},
            {k: {n: {s: t.clone() for s, t in sl.items()}
                 for n, sl in g.items()}
             for k, g in net.opt_state["slots"].items()},
            dict(net.opt_state["count"]))


def _unchanged(torch, net, snap) -> bool:
    params, slots, count = snap
    return (net.opt_state["count"] == count and all(
        torch.equal(net.params[k][n], t)
        for k, g in params.items() for n, t in g.items()) and all(
        torch.equal(net.opt_state["slots"][k][n][s], t)
        for k, g in slots.items() for n, sl in g.items()
        for s, t in sl.items()))


def _scaled_steps(torch, net, batches, finite_steps, max_skips):
    """Fit ``batches`` in turn (each until it trains) until
    ``finite_steps`` steps have trained; every skipped step is checked
    against a snapshot.  Returns ``(skips, scales, all_unchanged,
    losses)``: the skips, the scale after each step (the initial scale
    first), whether each skip left params, updater slots and counts
    bit-equal, and the trained steps' losses."""
    from deeplearning4j_tpu_torch.nn.precision import SCALE_STATE_KEY
    scales = [float(net.state[SCALE_STATE_KEY]["scale"])]
    unchanged, losses, skips = [], [], 0
    for x, y in batches:
        while len(losses) < finite_steps and skips <= max_skips:
            snap = _snapshot(net)
            before = int(net.state[SCALE_STATE_KEY]["overflow_steps"])
            net.fit(x, y)
            scales.append(float(net.state[SCALE_STATE_KEY]["scale"]))
            if int(net.state[SCALE_STATE_KEY]["overflow_steps"]) == before:
                losses.append(net.get_score())
                break
            skips += 1
            unchanged.append(_unchanged(torch, net, snap))
            del snap
    return skips, scales, unchanged, losses


def _skip_flags(scales):
    """Per step of a scale sequence: whether the step was skipped (the
    scale moved)."""
    return [b != a for a, b in zip(scales, scales[1:])]


def _first_finite_level(net, tree, x, y, levels):
    """The number of halvings of the policy's initial scale after which
    one step on ``(x, y)`` no longer overflows, found by bisection over
    ``levels`` (a skipped step leaves the params as they were, so the
    sequential count is the first level that trains): each probe reloads
    ``tree`` and sets the scale."""
    from deeplearning4j_tpu_torch.nn.precision import SCALE_STATE_KEY
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax
    init = float(net.state[SCALE_STATE_KEY]["scale"])
    lo, hi = 0, levels            # level lo overflows or is 0; hi trains
    while lo < hi:
        mid = (lo + hi) // 2
        params_from_jax(net, tree)
        ls = net.state[SCALE_STATE_KEY]
        ls["scale"].fill_(init / 2 ** mid)
        ls["overflow_steps"].zero_()
        net.fit(x, y)
        if int(net.state[SCALE_STATE_KEY]["overflow_steps"]):
            lo = mid + 1
        else:
            hi = mid
    return lo


def loss_scale_phase(args, torch, dev, card):
    """Phase 26.  Returns ``({"flash": f16 flash launches, "lstm": lstm_fwd
    launches}, None)`` or ``(None, what failed)``."""
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import (TextGenerationLSTM,
                                                     TransformerLM)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.precision import (SCALE_STATE_KEY,
                                                       PrecisionPolicy,
                                                       named_policy)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    t_phase = time.perf_counter()
    pol = PrecisionPolicy(compute_dtype="float16", loss_scale="dynamic",
                          initial_scale=F16_INITIAL_SCALE)
    tree = _lm_tree(args, dev, 26)
    net = _lm_net(args, dev, tree, defaults={"precision": pol})
    rng = np.random.default_rng(args.seed + 26)
    toks = rng.integers(0, VOCAB, (1 + F16_CLEAN_STEPS, TRAIN_BATCH,
                                   SEQ + 1))
    batches = [(torch.as_tensor(b[:, :-1], device=dev),
                torch.as_tensor(b[:, 1:], device=dev)) for b in toks]
    torch.cuda.synchronize()
    fa.reset_launches()
    skips, scales, unchanged, trained = _scaled_steps(
        torch, net, batches, 1 + F16_CLEAN_STEPS, F16_MAX_SKIPS)
    ls = {k: float(v) for k, v in net.state[SCALE_STATE_KEY].items()}
    launches = dict(fa.launches_by_dtype)
    steps = skips + len(trained)
    expected = {(k, "float16"): LAYERS * steps
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
    # each skip halves the scale; a trained step keeps it (no growth
    # within growth_interval = 200 steps)
    halved = all(b == (a / 2 if skipped else a) for a, b, skipped in zip(
        scales, scales[1:], _skip_flags(scales)))
    first_skips = next(i for i, (a, b) in enumerate(zip(scales, scales[1:]))
                       if b == a)
    # the twins at a cut size: the first blocks of the same params, one
    # sequence of F16_TWIN_SEQ tokens of the first batch; the card counts
    # its skips step by step, the CPU by bisection over the levels
    cut = {k: v for k, v in tree.items()
           if int(k[len("layer_"):]) < 2 + F16_TWIN_LAYERS}
    cut[f"layer_{2 + F16_TWIN_LAYERS}"] = tree[f"layer_{2 + LAYERS}"]
    twin_zoo = TransformerLM(vocab_size=VOCAB, seq_len=F16_TWIN_SEQ,
                             embed=EMBED, n_layers=F16_TWIN_LAYERS,
                             n_heads=HEADS, sparse_labels=True)
    tx = toks[0][:1, :F16_TWIN_SEQ + 1]
    twin_skips = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        conf = twin_zoo.conf()
        conf.defaults["precision"] = pol
        m = params_from_jax(MultiLayerNetwork(conf, device=d), cut)
        bx, by = (torch.as_tensor(a, device=d)
                  for a in (tx[:, :-1], tx[:, 1:]))
        if where == "card":
            twin_skips[where] = _scaled_steps(torch, m, [(bx, by)], 1,
                                              F16_MAX_SKIPS)[0]
        else:
            twin_skips[where] = _first_finite_level(
                m, cut, bx, by, F16_MAX_SKIPS)
        del m
    lm_s = time.perf_counter() - t_phase

    # ---- 26b. the char-LSTM, tBPTT under float16 ------------------------
    zoo = TextGenerationLSTM(num_classes=LSTM_CLASSES, timesteps=LSTM_T,
                             hidden=LSTM_HIDDEN, seed=args.seed)
    conf = zoo.conf()
    for lc in conf.layers:
        if isinstance(lc, LSTM):
            lc.helper = "pallas"
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = \
        LSTM_T // F16_TBPTT_CHUNKS
    conf.defaults["precision"] = named_policy("float16")
    lnet = MultiLayerNetwork(conf, device=dev).init()
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 262)
    ids = torch.randint(0, LSTM_CLASSES, (LSTM_BATCH, LSTM_T + 1),
                        generator=dgen, device=dev)
    xl = F.one_hot(ids[:, :-1], LSTM_CLASSES).float()
    yl = F.one_hot(ids[:, 1:], LSTM_CLASSES).float()
    xl[:, 0, :] = 1e30                  # chunk 1 of 4 overflows in f16
    torch.cuda.synchronize()
    pl.reset_launches()
    lnet.fit(xl, yl)
    torch.cuda.synchronize()
    lstm_launches = pl.launches["lstm_fwd"]
    lls = {k: float(v) for k, v in lnet.state[SCALE_STATE_KEY].items()}
    print(json.dumps({
        "phase": "loss_scale_f16", "lm": {
            "model": {"vocab": VOCAB, "seq": SEQ, "embed": EMBED,
                      "layers": LAYERS, "heads": HEADS, "batch": TRAIN_BATCH,
                      "policy": "PrecisionPolicy(compute_dtype='float16', "
                                "loss_scale='dynamic', initial_scale=2**40)"},
            "skips": skips, "skips_before_the_first_finite_step":
                first_skips, "scales": scales,
            "skipped_steps_unchanged": unchanged,
            "scale_halved_per_skip": halved,
            "trained_losses": trained, "scale_state": ls,
            "cpu_twin": {"layers": F16_TWIN_LAYERS, "batch": 1,
                         "seq": F16_TWIN_SEQ,
                         "skips_card": twin_skips["card"],
                         "skips_cpu": twin_skips["cpu"]},
            "kernel_launches_by_dtype": {f"{k}/{d}": v
                                         for (k, d), v in launches.items()},
            "expected_launches_f16": LAYERS * steps,
            "seconds": round(lm_s, 3)},
        "char_lstm_tbptt": {
            "batch": LSTM_BATCH, "t": LSTM_T, "chunks": F16_TBPTT_CHUNKS,
            "policy": "precision('float16')", "poisoned_chunk": 1,
            "scale_state": lls, "iterations": lnet.iteration,
            "score": lnet.get_score(), "lstm_fwd_launches": lstm_launches,
            "expected_launches": 2 * F16_TBPTT_CHUNKS},
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if skips == 0 or skips > F16_MAX_SKIPS or not all(unchanged) or \
            not halved or int(ls["overflow_steps"]) != skips:
        return None, (f"f16 LM loss scaling: {skips} skips, scales "
                      f"{scales}, unchanged {unchanged}, state {ls}")
    if len(trained) != 1 + F16_CLEAN_STEPS or \
            not np.isfinite(trained).all() or ls["scale"] != scales[-1]:
        return None, f"f16 LM did not train after the skips: {trained}, {ls}"
    if launches != expected:
        return None, (f"f16 LM launched {launches}; expected {expected}")
    if lls["overflow_steps"] != 1 or \
            lstm_launches != 2 * F16_TBPTT_CHUNKS or \
            not np.isfinite(lnet.get_score()):
        return None, (f"f16 char-LSTM tBPTT: state {lls}, {lstm_launches} "
                      f"lstm_fwd launches, score {lnet.get_score()}")
    return {"flash": {k: v for (k, _), v in launches.items()},
            "lstm": lstm_launches}, None


def remat_memory_phase(args, torch, dev, card):
    """Phase 27.  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.conf.memory import (
        MemoryUseMode, device_memory_report, memory_report)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.precision import named_policy
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 27)
    rng = np.random.default_rng(args.seed + 27)
    toks = rng.integers(0, VOCAB, (REMAT_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(torch.as_tensor(b[:, :-1], device=dev),
                torch.as_tensor(b[:, 1:], device=dev)) for b in toks]
    # the analytic report's static part against what making the net and
    # its updater state allocates
    conf = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                         n_layers=LAYERS, n_heads=HEADS, sparse_labels=True,
                         seed=args.seed).conf()
    conf.resolve()
    report = memory_report(conf)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    made = MultiLayerNetwork(conf, device=dev).init()
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - base
    n_tensors = (sum(1 for _ in made.params.parameters())
                 + sum(len(sl) for g in made.opt_state["slots"].values()
                       for sl in g.values()) + 1)
    static = report.static_bytes()
    del made
    runs, peaks = {}, {}
    for name, defaults in (("float32", {}), ("remat", {"cache_mode":
                                                       "remat"}),
                           ("bfloat16", {"precision":
                                         named_policy("bfloat16")})):
        torch.cuda.empty_cache()
        net = _lm_net(args, dev, tree, defaults=defaults)
        losses, launches = [], []
        for i, (x, y) in enumerate(batches):
            fa.reset_launches()
            if i == 1:
                peaks[name] = device_memory_report(net, x, y)
            else:
                net.fit(x, y)
            launches.append(fa.launches["fwd"])
            losses.append(net.get_score())
        rep = memory_report(net.conf)
        peaks[name]["report_total_memory_bytes"] = rep.total_memory_bytes(
            TRAIN_BATCH, MemoryUseMode.TRAINING)
        runs[name] = {"losses": losses, "fwd_launches_per_step": launches,
                      "params": None if name == "bfloat16"
                      else _host_tree(net)}
        # then the step's time (host clock, as train_time's)
        runs[name]["step_ms_median"] = _timed_steps(torch, net, batches,
                                                    REMAT_TIMED_STEPS)
        del net
    same_losses = runs["float32"]["losses"] == runs["remat"]["losses"]
    same_params = all(
        np.array_equal(a, runs["remat"]["params"][k][n])
        for k, g in runs["float32"]["params"].items()
        for n, a in g.items())
    print(json.dumps({
        "phase": "remat_memory", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "batch": TRAIN_BATCH, "updater": "Adam(3e-4)"},
        "steps": REMAT_STEPS,
        "losses": {k: v["losses"] for k, v in runs.items()},
        "losses_bitwise_equal": same_losses,
        "params_bitwise_equal": same_params,
        "fwd_launches_per_step": {k: v["fwd_launches_per_step"]
                                  for k, v in runs.items()},
        "step_ms_median": {k: v["step_ms_median"] for k, v in runs.items()},
        "static": {"report_static_bytes": static,
                   "allocated_growth_bytes": growth,
                   "tensors": n_tensors,
                   "allowance_bytes": ALLOC_ROUND * n_tensors},
        "peak": peaks,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not (same_losses and same_params):
        return (f"remat vs stored activations: losses equal {same_losses}, "
                f"params equal {same_params}")
    if runs["remat"]["fwd_launches_per_step"] != [2 * LAYERS] * REMAT_STEPS \
            or runs["float32"]["fwd_launches_per_step"] != \
            [LAYERS] * REMAT_STEPS:
        per_step = {k: v["fwd_launches_per_step"] for k, v in runs.items()}
        return f"forward launches per step: {per_step}"
    if not 0 <= growth - static <= ALLOC_ROUND * n_tensors:
        return (f"making the net allocated {growth} bytes; the report's "
                f"static part is {static} ({n_tensors} tensors)")
    return None


def resnet_bf16_phase(args, torch, dev, card):
    """Phase 28.  Returns ``(bf16 bn_apply launches of the keep_f32=()
    step, None)`` or ``(None, what failed)``."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb

    t_phase = time.perf_counter()

    def make(compute_dtype):
        conf = ResNet50(seed=args.seed, input_shape=RN_INPUT,
                        num_classes=RN_CLASSES,
                        compute_dtype=compute_dtype).conf()
        for v in conf.vertices.values():
            lc = getattr(v, "layer", None)
            if type(lc).__name__ == "BatchNormalization":
                lc.helper = "pallas"
        return ComputationGraph(conf, device=dev)

    net = make("bfloat16").init()
    tree0 = _host_tree(net)
    twin = make(None).load_params(tree0)
    h, w, c = RN_INPUT
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 28)
    batches = [(torch.randn((CNN_BATCH, h, w, c), generator=dgen,
                            device=dev),
                F.one_hot(torch.randint(0, RN_CLASSES, (CNN_BATCH,),
                                        generator=dgen, device=dev),
                          RN_CLASSES).float())
               for _ in range(RN_BF16_STEPS)]
    losses, twin_losses, launches, f32_stats = [], [], [], []
    for i, (x, y) in enumerate(batches):
        torch.cuda.synchronize()
        pb.reset_launches()
        net.fit(x, y)
        torch.cuda.synchronize()
        launches.append(dict(pb.launches_by_dtype))
        losses.append(net.get_score())
        f32_stats.append(all(t.dtype == torch.float32
                             for k, g in net.state.items()
                             for t in g.values() if t.is_floating_point()))
        if i == 0:
            twin.fit(x, y)
            twin_losses.append(twin.get_score())
    del twin
    step_ms = _timed_steps(torch, net, batches, 4)
    step0 = abs(losses[0] - twin_losses[0]) / abs(twin_losses[0])
    # one step with keep_f32=() from the initial params: every BN in
    # bf16, each launch held against the plain version on its inputs
    del net
    net = make("bfloat16").load_params(tree0)
    net.conf.defaults["precision"] = PrecisionPolicy(
        compute_dtype="bfloat16", keep_f32=())
    worst, checked = 0.0, 0
    inner = pb.bn_apply

    def held(x, scale, shift, relu):
        nonlocal worst, checked
        y = inner(x, scale, shift, relu)
        want = pb.bn_apply_plain(x, scale, shift, relu)
        tol = BN_TOL_BF16 * (x.float().abs() * scale.float().abs()
                             + shift.float().abs()).max()
        err = (y.float() - want.float()).abs().max()
        worst = max(worst, (err / tol).item())
        checked += 1
        return y
    pb.bn_apply = held
    try:
        pb.reset_launches()
        net.fit(*batches[0])
        torch.cuda.synchronize()
    finally:
        pb.bn_apply = inner
    bf16_launches = dict(pb.launches_by_dtype)
    bf16_loss = net.get_score()
    print(json.dumps({
        "phase": "resnet_bf16", "model": {
            "name": "ResNet50(compute_dtype='bfloat16')",
            "input": [h, w, c], "batch": CNN_BATCH,
            "updater": "Nesterovs(0.1, 0.9)", "bn_helper": "pallas"},
        "steps": RN_BF16_STEPS, "losses": losses,
        "f32_twin_step0_loss": twin_losses[0], "step0_rel_diff": step0,
        "tol_step0": TOL_BF16_RESNET_LOSS,
        "bn_launches_by_dtype_per_step": launches,
        "bn_running_stats_f32_each_step": f32_stats,
        "step_ms_median": step_ms,
        "images_per_s": CNN_BATCH / step_ms * 1e3,
        "keep_f32_empty_step": {"loss": bf16_loss,
                                "bn_launches_by_dtype": bf16_launches,
                                "held_against_plain": checked,
                                "worst_err_over_tol": worst},
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    want = [{"float32": 53}] * RN_BF16_STEPS
    if launches != want:
        return None, f"bf16 ResNet50 bn_apply launches {launches}"
    if not all(f32_stats):
        return None, "bf16 ResNet50 left BN running statistics not f32"
    import math
    if not all(math.isfinite(v) for v in losses) or \
            step0 > TOL_BF16_RESNET_LOSS:
        return None, (f"bf16 ResNet50 step-0 loss {losses[0]} vs f32 "
                      f"{twin_losses[0]}: {step0} > {TOL_BF16_RESNET_LOSS}")
    if bf16_launches != {"bfloat16": 53} or checked != 53 or worst > 1.0 \
            or not math.isfinite(bf16_loss):
        return None, (f"keep_f32=() step: launches {bf16_launches}, held "
                      f"{checked}, worst {worst}, loss {bf16_loss}")
    return bf16_launches["bfloat16"], None


def int8_kv_phase(args, torch, dev, card):
    """Phase 29.  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                     GenerationEngine)
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.layers.attention import _kv_quantize
    from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax

    t_phase = time.perf_counter()
    # codes and scales: card against CPU on the same K/V
    kgen = torch.Generator().manual_seed(args.seed + 29)
    kv_in = torch.randn((GEN_SLOTS, HEADS, HEAD_DIM), generator=kgen) * \
        torch.logspace(-3, 2, GEN_SLOTS)[:, None, None]
    qc, sc = _kv_quantize(kv_in)
    qd, sd = _kv_quantize(kv_in.to(dev))
    codes_equal = torch.equal(qc, qd.cpu()) and torch.equal(sc, sd.cpu())
    rng = np.random.default_rng(args.seed + 29)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(
        GEN_PROMPT_RANGE[0], GEN_PROMPT_RANGE[1] + 1))).tolist()
        for _ in range(GEN_REQUESTS)]
    cfg = dict(max_slots=GEN_SLOTS, max_seq=GEN_MAX_SEQ,
               block_size=GEN_BLOCK)
    streams, nbytes, decode_ms, status = {}, {}, {}, {}
    for pool in ("float32", "int8"):
        net = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                            n_layers=LAYERS, n_heads=HEADS).init(device=dev)
        params_from_jax(net, seeded_params(net.param_spec(), args.seed))
        if pool == "int8":
            net.conf.defaults["precision"] = PrecisionPolicy(kv_dtype="int8")
        eng = GenerationEngine.for_model(net, GenerationConfig(**cfg))
        try:
            handles = [eng.submit(p, max_new_tokens=INT8_NEW)
                       for p in prompts]
            streams[pool] = [h.future.result(timeout=300).tokens
                             for h in handles]
            nbytes[pool] = eng.ring.cache_bytes
            status[pool] = eng.status()["kv"]["kv_dtype"]
        finally:
            eng.shutdown()
        # the decode step with 16 active, driven directly
        kv, _, dec, dargs = _direct_decode(torch, net, dev)
        decode_ms[pool] = median_ms(
            lambda: dec(net.params, net.state, *dargs), torch, runs=20)
        del net, kv, dargs
    groups = [sum(int(a != b) for a, b in zip(
        streams["int8"][i:i + 3], streams["float32"][i:i + 3]))
        for i in range(0, GEN_REQUESTS, 3)]
    print(json.dumps({
        "phase": "int8_kv", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS}, "config": cfg, "requests": GEN_REQUESTS,
        "max_new_tokens": INT8_NEW,
        "codes_and_scales_card_equal_cpu": codes_equal,
        "cache_bytes": nbytes, "ratio": nbytes["int8"] / nbytes["float32"],
        "kv_dtype_status": status,
        "differing_streams_per_group_of_3": groups,
        "decode_step_ms_16_active": decode_ms,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not codes_equal:
        return "int8 codes or scales differ between the card and the CPU"
    if nbytes["int8"] > 0.5 * nbytes["float32"] or \
            status != {"float32": "float32", "int8": "int8"}:
        return f"int8 pool bytes {nbytes} or status {status}"
    if max(groups) > 1:
        return (f"int8 greedy streams differ from the f32 pool's in more "
                f"than one request of a group of three: {groups}")
    return None


def solvers_eval_phase(args, torch, dev, card):
    """Phase 30.  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.evaluation import (EvaluationBinary,
                                                     EvaluationCalibration)
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                                OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import solvers

    t_phase = time.perf_counter()
    conf = (NeuralNetConfiguration.builder().seed(args.seed)
            .activation("relu").updater(Sgd(learning_rate=0.1)).list()
            .layer(DenseLayer(n_out=UPD_WIDTH))
            .layer(DenseLayer(n_out=UPD_WIDTH))
            .layer(OutputLayer(n_out=UPD_CLASSES, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(UPD_WIDTH)).build())
    rng = np.random.default_rng(args.seed + 30)
    x = rng.standard_normal((UPD_BATCH, UPD_WIDTH)).astype(np.float32)
    y = np.eye(UPD_CLASSES, dtype=np.float32)[rng.integers(
        0, UPD_CLASSES, UPD_BATCH)]
    tree = None
    rows, outs = [], {}
    for cls in ("LBFGS", "ConjugateGradient", "LineGradientDescent"):
        hist, final, ms = {}, {}, {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            net = MultiLayerNetwork(conf, device=d).init()
            if tree is None:
                tree = _host_tree(net)
            net.load_params(tree)
            opt = getattr(solvers, cls)(max_iterations=SOLVER_ITERS)
            t1 = time.perf_counter()
            final[where] = opt.optimize(net, x, y)
            ms[where] = (time.perf_counter() - t1) * 1e3 / max(
                1, len(opt.score_history) - 1)
            hist[where] = opt.score_history
            outs[(cls, where)] = net.output(x)
        first3 = max(abs(a - b) / abs(b) for a, b in zip(
            hist["card"][:3], hist["cpu"][:3]))
        rows.append({"solver": cls, "iterations": len(hist["card"]) - 1,
                     "scores": hist["card"], "cpu_scores": hist["cpu"],
                     "first3_max_rel_diff": first3,
                     "final": final["card"], "cpu_final": final["cpu"],
                     "iteration_ms": ms["card"],
                     "cpu_iteration_ms": ms["cpu"]})
    # evaluation of the LBFGS nets' outputs, card against CPU
    pc = outs[("LBFGS", "card")]
    pcpu = outs[("LBFGS", "cpu")]
    # the interior edges: an output near 0 or 1 stays in the first or
    # last bin on both sides (the bins are clipped)
    edges = np.unique(np.concatenate([np.arange(1, 10) / 10,
                                      np.arange(1, 50) / 50, [0.5]]))
    near = np.abs(pcpu.numpy()[..., None] - edges).min(-1) < TIE_MARGIN
    ties = int(near.sum())
    evs = {}
    for where, p in (("card", pc), ("cpu", pcpu)):
        evs[where] = (EvaluationBinary().eval(y, p),
                      EvaluationCalibration().eval(y, p))
    diff = sum(int(np.abs(getattr(evs["card"][0], f)
                          - getattr(evs["cpu"][0], f)).sum())
               for f in ("tp", "fp", "tn", "fn"))
    cb, cc = evs["card"][1], evs["cpu"][1]
    diff += sum(int(np.abs(a - b).sum()) for a, b in (
        (cb._count, cc._count), (cb._pos_count, cc._pos_count),
        (cb._prob_counts, cc._prob_counts),
        (cb._residual_counts, cc._residual_counts)))
    print(json.dumps({
        "phase": "solvers_eval", "model": {
            "layers": f"Dense {UPD_WIDTH} x2 (relu) -> softmax "
                      f"{UPD_CLASSES}", "batch": UPD_BATCH},
        "rows": rows, "tol_first3": TOL_SOLVER_SCORES,
        "final_slack": SOLVER_FINAL_SLACK,
        "evaluation": {"binary_tp": evs["card"][0].tp.tolist(),
                       "binary_cpu_tp": evs["cpu"][0].tp.tolist(),
                       "ece": evs["card"][1].expected_calibration_error(),
                       "cpu_ece": evs["cpu"][1].expected_calibration_error(),
                       "count_differences": diff,
                       "outputs_near_an_edge": ties},
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    for r in rows:
        if r["first3_max_rel_diff"] > TOL_SOLVER_SCORES or \
                not r["final"] <= r["cpu_final"] + SOLVER_FINAL_SLACK:
            return (f"{r['solver']} on the card vs the CPU: first scores "
                    f"{r['first3_max_rel_diff']}, final {r['final']} vs "
                    f"{r['cpu_final']}")
    if diff > ties:
        return (f"evaluation counts differ card vs CPU by {diff} "
                f"({ties} outputs near a threshold or bin edge)")
    return None



# 31: the full-width TransformerLM of phase 5 with block dropout 0.9 and
# Adam(3e-4), trained CKPT_STEPS steps of batch 16 through fit over an
# iterable of batches with a checkpoint every CKPT_AT steps (a background
# write each); a fresh network resumes from the step-CKPT_AT directory and
# runs the remaining steps.  Gate (``resume_gate``): the resumed run's
# params, Adam moments and counts and key are bitwise equal to those of
# the checkpointed run, which went on to the last step, and so are those
# of a run without checkpoints (checkpointing is an observer).
CKPT_STEPS, CKPT_AT = 6, 3
# 32: observability on the same LM.  OBS_SERVE_ROWS rows served in two
# requests, OBS_FIT_STEPS fit steps, OBS_GEN requests of OBS_GEN_TOKENS
# generated tokens; OBS_PROFILED steps each sampled and traced alone by
# torch.profiler; OBS_OVERHEAD_STEPS steps per overhead arm, two runs of
# each arm in turns (on, off, off, on); the decode step OBS_CRASH_AT
# raises by a FaultInjector.
OBS_SERVE_ROWS = (1, 4)
OBS_FIT_STEPS = 4
OBS_GEN, OBS_GEN_TOKENS = 2, 8
OBS_PROFILED = 3
OBS_OVERHEAD_STEPS = 24
OBS_CRASH_AT = 2
# the H100 dense bf16 peak, as the step profiler's table names it
OBS_PEAK_FLOPS = 989e12
_SAMPLE_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? \S+$')


def training_state(net) -> dict:
    """``{name: host tensor}`` of a network's params, updater slots and
    step counts and key (the state a resume must restore)."""
    import torch
    out = {f"param/{k}/{n}": p.detach().cpu()
           for k, g in net.params.items() for n, p in g.items()}
    for k, g in net.opt_state["slots"].items():
        for n, sl in g.items():
            for s, t in sl.items():
                out[f"slot/{k}/{n}/{s}"] = t.detach().cpu()
    for lab, c in net.opt_state["count"].items():
        out[f"count/{lab}"] = torch.tensor(c)
    out["key"] = net._rng.detach().cpu()
    return out


def state_max_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over every entry of two ``training_state`` dicts:
    0 only where every entry is bit-equal, inf where the names or shapes
    differ or one side holds a NaN the other does not."""
    import torch
    if set(a) != set(b):
        return float("inf")
    worst = 0.0
    for name, t in a.items():
        u = b[name]
        if t.shape != u.shape or t.dtype != u.dtype:
            return float("inf")
        if t.reshape(-1).view(torch.uint8).equal(
                u.reshape(-1).view(torch.uint8)):
            continue
        gap = (t.double() - u.double()).abs().nan_to_num(nan=float("inf"))
        # bits that differ in the sign of a zero alone still fail
        worst = max(worst, gap.max().item() or math.ulp(0.0))
    return worst


# The cause, outside the port, that keeps two runs of the checkpoint phase
# from being bit-equal, once one is found and written down in PERF.md; None
# while the runs are bitwise (every chip run so far).
RESUME_NONDETERMINISM = None


def resume_gate(diff: float, observer_diff: float,
                noise: float = None) -> bool:
    """The resumed run against the one that went on (``diff``) and the
    checkpointed run against one without checkpoints (``observer_diff``):
    both bitwise.  Only where ``RESUME_NONDETERMINISM`` names a cause does
    ``noise``, the measured difference of two runs without checkpoints in
    the same call, replace 0; no hand-picked tolerance, and never a
    fallback taken on its own."""
    limit = 0.0 if noise is None else noise
    return diff <= limit and observer_diff <= limit


def lm_step_flops(conf, batch: int) -> float:
    """Model FLOPs of one TransformerLM training step: 3x the forward's,
    the forward 2 FLOPs per multiply-add of every dense product (the
    block's QKV and output projections, its two FFN products, the output
    layer) plus the attention's two products over the full ``t x t``
    score matrix (PaLM's 6N + 12·L·T·E per token)."""
    conf.resolve()
    t = conf.input_type.timesteps
    fwd = 0.0
    for lc in conf.layers:
        kind = type(lc).__name__
        if kind == "TransformerBlock":
            e = lc.n_in
            fwd += t * (2.0 * (4 * e * e + 2 * lc.ffn_mult * e * e)
                        + 4.0 * t * e)
        elif kind == "RnnOutputLayer":
            fwd += t * 2.0 * lc.n_in * lc.n_out
    return 3.0 * fwd * batch


def mfu_agrees(record: dict, flops: float, peak: float) -> bool:
    """A sampled step record's MFU is flops / (device slice x peak): its
    achieved FLOP/s is ``flops`` over the slice (which the record keeps
    rounded to 1e-7 s) and its MFU that over ``peak``."""
    ach, mfu = record.get("achieved_flops"), record.get("mfu")
    dev = record["phases"]["device"]
    return (ach is not None and mfu is not None and dev is not None
            and mfu == ach / peak and abs(flops / ach - dev) <= 5e-8)


def device_ms_in(prof) -> float:
    """The CUDA time of every kernel, copy and fill in a ``torch.profiler``
    trace, ms.  A ``record_function`` range also shows on the device as a
    user annotation spanning its kernels; every event the profiler flags
    as a user annotation is left out."""
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        if not hasattr(ev, "is_user_annotation"):
            raise RuntimeError("this torch's profiler events carry no "
                               "is_user_annotation flag")
        if ev.is_user_annotation:
            continue
        total += us / 1e3
    return total


def _dropout_lm(args, dev, tree):
    net = _lm_net(args, dev, tree)
    for lc in net.conf.layers[2:-1]:
        lc.dropout = 0.9
    return net


def checkpoint_resume_phase(args, torch, dev, card):
    """Phase 31.  Returns ``(flash launches of the uninterrupted run and of
    the resumed one, None)`` or ``(None, what failed)``."""
    import shutil
    import numpy as np
    from deeplearning4j_tpu_torch.faulttolerance import CheckpointConfig
    from deeplearning4j_tpu_torch.observability import (
        FlightRecorder, MetricsRegistry, Tracer, set_default_registry,
        set_default_tracer, set_flight_recorder)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    store = REPO / "build" / "checkpoint_resume"
    shutil.rmtree(store, ignore_errors=True)
    tree = _lm_tree(args, dev, 31)
    rng = np.random.default_rng(args.seed + 31)
    toks = rng.integers(0, VOCAB, (CKPT_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(b[:, :-1], b[:, 1:]) for b in toks]
    reg = MetricsRegistry()
    rec = FlightRecorder(registry=reg)
    saved = (set_default_registry(reg), set_flight_recorder(rec),
             set_default_tracer(Tracer(enabled=True, registry=reg)))
    try:
        net_a = _dropout_lm(args, dev, tree)
        torch.cuda.synchronize()
        fa.reset_launches()
        t_a = time.perf_counter()
        net_a.fit(batches, checkpoint=CheckpointConfig(
            directory=str(store), save_every_n_iterations=CKPT_AT,
            background=True, keep_last=CKPT_STEPS))
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t_a
        launches_a = dict(fa.launches)
        steps = {r["iteration"]: r for r in rec.channel("profile").items()
                 if r["type"] == "step" and r["program"] == "train_step"}
        net_b = _dropout_lm(args, dev, _lm_tree(args, dev, 131))
        ckpt = store / f"ckpt-{CKPT_AT:08d}"
        fa.reset_launches()
        t_b = time.perf_counter()
        net_b.fit(batches, resume_from=str(ckpt))
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t_b
        launches_b = dict(fa.launches)
    finally:
        set_default_registry(saved[0])
        set_flight_recorder(saved[1])
        set_default_tracer(saved[2])
    # the same 6 steps without checkpoints: checkpointing is an observer
    twin = _dropout_lm(args, dev, tree)
    twin.fit(batches)
    state_a, state_twin = training_state(net_a), training_state(twin)
    diff = state_max_diff(state_a, training_state(net_b))
    observer_diff = state_max_diff(state_a, state_twin)
    noise = None
    if RESUME_NONDETERMINISM:
        twin2 = _dropout_lm(args, dev, tree)
        twin2.fit(batches)
        noise = state_max_diff(state_twin, training_state(twin2))
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)
    nbytes = sum(v["bytes"] for v in manifest["files"].values())
    spans = reg.get("span_seconds")
    span_s = {name: spans.labels(name).sum for name in
              ("checkpoint.write", "container.encode", "container.deflate")}
    writes = reg.get("checkpoint_write_seconds").labels("async")
    write_s = writes.sum / max(writes.count, 1)
    stall = steps.get(CKPT_AT, {}).get("phases", {}).get("checkpoint")
    walls = [steps[i]["wall_s"] for i in range(2, CKPT_STEPS + 1)
             if i in steps and i % CKPT_AT]
    expected_a = {k: LAYERS * CKPT_STEPS for k in ("fwd", "bwd_dq",
                                                   "bwd_dkv")}
    expected_b = {k: LAYERS * (CKPT_STEPS - CKPT_AT) for k in expected_a}
    losses = [float(net_a.get_score()), float(net_b.get_score())]
    print(json.dumps({
        "phase": "checkpoint_resume", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "batch": TRAIN_BATCH, "dropout": 0.9,
            "updater": "Adam(3e-4)", "num_params": net_a.num_params()},
        "steps": CKPT_STEPS, "checkpoint_every": CKPT_AT,
        "checkpoints": sorted(p.name for p in store.iterdir()
                              if p.name.startswith("ckpt-")),
        "resumed_from": ckpt.name, "resumed_iteration": net_b.iteration,
        "final_losses": losses,
        "max_abs_diff_resumed_vs_uninterrupted": diff,
        "max_abs_diff_checkpointed_vs_without": observer_diff,
        "gate": "bitwise" if noise is None else {
            "cause": RESUME_NONDETERMINISM,
            "max_abs_diff_two_runs_without_checkpoints": noise},
        "kernel_launches_uninterrupted": launches_a,
        "kernel_launches_resumed": launches_b,
        "checkpoint_bytes": nbytes,
        "snapshot_stall_s": stall,
        "median_step_wall_s_without_snapshot":
            statistics.median(walls) if walls else None,
        "write_s_mean": write_s, "writes": writes.count,
        "write_mb_per_s": nbytes / write_s / 1e6 if write_s else None,
        "write_span_s": span_s,
        "uninterrupted_run_s": round(a_s, 3), "resumed_run_s": round(b_s, 3),
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    # the store stays for phase 33, which promotes its newest checkpoint
    # into a serving LM and then removes it
    if not all(np.isfinite(losses)):
        return None, f"checkpointed LM losses not finite: {losses}"
    if net_b.iteration != CKPT_STEPS or \
            net_a.opt_state["count"] != net_b.opt_state["count"]:
        return None, (f"the resumed LM ended at iteration {net_b.iteration}"
                      f", counts {net_b.opt_state['count']}")
    if not resume_gate(diff, observer_diff, noise):
        return None, (f"resumed LM differs from the uninterrupted run by "
                      f"{diff}, the checkpointed run from one without by "
                      f"{observer_diff} (gate {noise or 0.0})")
    if launches_a != expected_a or launches_b != expected_b:
        return None, (f"checkpointed LM launched {launches_a}, resumed "
                      f"{launches_b}; expected {expected_a} and "
                      f"{expected_b} ({LAYERS} per kernel per step)")
    return {"uninterrupted": launches_a, "resumed": launches_b,
            "store": store}, None


def observability_phase(args, torch, dev, card):
    """Phase 32.  Returns None, or what failed."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.faulttolerance import FaultInjector
    from deeplearning4j_tpu_torch.generation.engine import GenerationConfig
    from deeplearning4j_tpu_torch.observability import (
        FlightRecorder, MetricsRegistry, Tracer, load_dump, render_text,
        set_default_registry, set_default_tracer, set_flight_recorder)
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    dump_dir = REPO / "build" / "observability"
    shutil.rmtree(dump_dir, ignore_errors=True)
    cards = tempfile.mkdtemp(dir=str(REPO / "build"))
    tree = _lm_tree(args, dev, 32)
    net = _lm_net(args, dev, tree)
    flops = lm_step_flops(net.conf, TRAIN_BATCH)
    with open(os.path.join(cards, "lm_smoke_step.json"), "w") as f:
        json.dump({"flops": flops}, f)
    rng = np.random.default_rng(args.seed + 32)
    toks = rng.integers(0, VOCAB, (OBS_FIT_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(torch.as_tensor(b[:, :-1], device=dev),
                torch.as_tensor(b[:, 1:], device=dev)) for b in toks]
    eye = np.eye(VOCAB, dtype=np.float32)
    reg = MetricsRegistry()
    rec = FlightRecorder(directory=str(dump_dir), registry=reg)
    tracer = Tracer(enabled=True, registry=reg, bridge_profiler=True)
    saved = (set_default_registry(reg), set_flight_recorder(rec),
             set_default_tracer(tracer))
    env_keys = ("DL4J_TPU_CARDS_DIR", "DL4J_TPU_STEPPROF_PROGRAM",
                "DL4J_TPU_STEPPROF_SAMPLE", "DL4J_TPU_STEPPROF")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    try:
        # -- counters: served rows, fit steps, generated tokens
        engine = ServingEngine(net, device=dev, max_batch_size=MAX_BATCH,
                               generation=GenerationConfig(
                                   max_slots=OBS_GEN, max_seq=64,
                                   block_size=16))
        try:
            for n in OBS_SERVE_ROWS:
                engine.predict(eye[rng.integers(0, VOCAB, (n, SEQ))])
            for x, y in batches:
                net.fit(x, y)
            prompts = [list(rng.integers(0, VOCAB, 16)) for _ in
                       range(OBS_GEN)]
            futs = [engine.generation.submit(
                p, max_new_tokens=OBS_GEN_TOKENS) for p in prompts]
            gen_tokens = [len(f.future.result(timeout=120).tokens)
                          for f in futs]
        finally:
            engine.shutdown()
        text = render_text(reg)
        bad = [ln for ln in text.strip().splitlines()
               if not ln.startswith("#") and not _SAMPLE_LINE.match(ln)]
        counts = {"training_steps_total":
                  reg.get("training_steps_total").value,
                  "training_examples_total":
                  reg.get("training_examples_total").value,
                  "generation_tokens_total":
                  reg.get("generation_tokens_total").value,
                  "serving_batches_total":
                  reg.get("serving_batches_total").value}
        want_counts = {"training_steps_total": OBS_FIT_STEPS,
                       "training_examples_total":
                       OBS_FIT_STEPS * TRAIN_BATCH,
                       "generation_tokens_total": sum(gen_tokens),
                       "serving_batches_total": len(OBS_SERVE_ROWS)}

        # -- sampled steps under torch.profiler, MFU from the card file
        os.environ.update({"DL4J_TPU_CARDS_DIR": cards,
                           "DL4J_TPU_STEPPROF_PROGRAM": "lm_smoke_step",
                           "DL4J_TPU_STEPPROF_SAMPLE": "1"})
        sampled = []
        for i in range(OBS_PROFILED):
            x, y = batches[i % len(batches)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with tracer.span("smoke.train_step", step=i):
                    net.fit(x, y)
                torch.cuda.synchronize()
            step = [r for r in rec.channel("profile").items()
                    if r["type"] == "step"
                    and r["program"] == "lm_smoke_step"][-1]
            keys = {e.key for e in prof.key_averages()}
            dev_s = step["phases"]["device"]
            sampled.append({
                "device_slice_ms": None if dev_s is None else dev_s * 1e3,
                "kernel_ms_profiler": device_ms_in(prof),
                "wall_ms": step["wall_s"] * 1e3, "mfu": step.get("mfu"),
                "achieved_flops": step.get("achieved_flops"),
                "mfu_agrees": mfu_agrees(step, flops, OBS_PEAK_FLOPS),
                "span_in_trace": "smoke.train_step" in keys})
        for k in env_keys[:3]:
            os.environ.pop(k, None)

        # -- overhead: everything on (registry, step profiler sampling
        # every 16th step, flight recorder) against DL4J_TPU_STEPPROF=0
        # with the registry and recorder disabled, in turns
        over = [batches[i % len(batches)] for i in range(OBS_OVERHEAD_STEPS)]
        arms = {"on": [], "off": []}
        for arm in ("on", "off", "off", "on"):
            if arm == "off":
                os.environ["DL4J_TPU_STEPPROF"] = "0"
                reg.disable()
                rec.disable()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net.fit(over)
            torch.cuda.synchronize()
            arms[arm].append((time.perf_counter() - t1) * 1e3
                             / OBS_OVERHEAD_STEPS)
            os.environ.pop("DL4J_TPU_STEPPROF", None)
            reg.enable()
            rec.enable()

        # -- crash dump: the decode step OBS_CRASH_AT raises
        inj = FaultInjector().fail(0, OBS_CRASH_AT)
        engine = ServingEngine(net, device=dev, max_batch_size=MAX_BATCH,
                               generation=GenerationConfig(
                                   max_slots=OBS_GEN, max_seq=64,
                                   block_size=16))
        gen = engine.generation
        decode = gen._decode_step

        def faulty(slot_obj):
            inj.on_batch(0, gen.decode_steps, 0)
            return decode(slot_obj)
        gen._decode_step = faulty
        crash = None
        try:
            gen.generate(prompts[0], max_new_tokens=OBS_GEN_TOKENS)
        except Exception as e:
            crash = f"{type(e).__name__}: {e}"
        finally:
            engine.shutdown()
        dumps = [p for p in rec.dumps if "decode_exception" in p]
        payload = load_dump(dumps[0], verify=True) if dumps else {}
        decode_kinds = [r["type"] for r in
                        payload.get("channels", {}).get("decode", [])]
    finally:
        set_default_registry(saved[0])
        set_flight_recorder(saved[1])
        set_default_tracer(saved[2])
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cards, ignore_errors=True)
    on, off = statistics.median(arms["on"]), statistics.median(arms["off"])
    print(json.dumps({
        "phase": "observability", "counters": counts,
        "expected_counters": want_counts,
        "exposition_lines": len(text.splitlines()),
        "unparsed_lines": bad[:5], "generated_tokens": gen_tokens,
        "lm_step_flops": flops, "peak_flops": OBS_PEAK_FLOPS,
        "sampled_steps": sampled,
        "step_ms_everything_on": arms["on"],
        "step_ms_stepprof_off_registry_off": arms["off"],
        "step_ms_median_on": on, "step_ms_median_off": off,
        "overhead": on / off - 1.0,
        "crash": crash, "crash_dump": dumps[0] if dumps else None,
        "decode_channel": decode_kinds, "injected": inj.events,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    shutil.rmtree(dump_dir, ignore_errors=True)
    if bad:
        return f"render_text gave lines that do not parse: {bad[:3]}"
    if counts != want_counts:
        return f"observability counters {counts}; expected {want_counts}"
    if gen_tokens != [OBS_GEN_TOKENS] * OBS_GEN:
        return f"generation returned {gen_tokens} tokens"
    for s in sampled:
        if s["device_slice_ms"] is None or not \
                s["kernel_ms_profiler"] <= s["device_slice_ms"] <= \
                s["wall_ms"]:
            return (f"sampled step: device slice {s['device_slice_ms']} ms "
                    f"not within [kernel {s['kernel_ms_profiler']}, wall "
                    f"{s['wall_ms']}] ms")
        if not s["mfu_agrees"]:
            return (f"sampled step MFU {s['mfu']} is not flops {flops} / "
                    f"(device slice {s['device_slice_ms']} ms x peak "
                    f"{OBS_PEAK_FLOPS})")
        if not s["span_in_trace"]:
            return "the tracer's span is missing from the torch.profiler trace"
    if crash is None or inj.events != [("fail", 0, OBS_CRASH_AT)] or \
            decode_kinds[-1:] != ["decode_error"]:
        return (f"decode crash: {crash}, injected {inj.events}, decode "
                f"channel {decode_kinds}")
    return None


# 33-37: the serving tier over HTTP (127.0.0.1), on the full-width
# TransformerLM (33, 36), the char-LSTM (34, 35) and a 100,000-point k-NN
# index (37).  A full-vocabulary /predict row is ~4.2 M numbers of JSON,
# ~21 MB in and ~85 MB out: its client waits up to HTTP_TIMEOUT_S.
HTTP_PREDICT_ROWS = 2
HTTP_TIMEOUT_S = 300.0
# 16 concurrent /generate requests on a 16-slot engine, every other one
# streamed; prompts of HTTP_GEN_PROMPTS tokens, HTTP_GEN_NEW greedy tokens
HTTP_GEN, HTTP_GEN_NEW, HTTP_GEN_PROMPTS = 16, 32, (16, 128)
# /generate requests after the LM's /reload (each must report the new
# version only)
HTTP_SWAP_GEN = 4
# 34: SWAP_CLIENTS threads post one-row /predict to the char-LSTM while
# fit(checkpoint=...) takes SWAP_STEPS steps of batch SWAP_BATCH and
# commits a checkpoint every SWAP_EVERY; the engine's watcher polls every
# SWAP_POLL_S.  Each client ends after SWAP_TAIL responses from the last
# version.  SWAP_ALONE steps first time the fit step without the clients.
SWAP_CLIENTS, SWAP_STEPS, SWAP_EVERY, SWAP_BATCH = 4, 6, 2, 32
SWAP_POLL_S, SWAP_TAIL, SWAP_ALONE = 0.1, 3, 3
# a served row against the output of the version it reports: the same
# weights on the same card, another batch composition
TOL_SWAP = 1e-5
# 35: PI_REQUESTS one-row requests from as many threads, per mode
PI_REQUESTS, PI_MAX_BATCH = 8, 8
# 36: two replicas of the full-width LM with FLEET_SLOTS generation slots
# each; FLEET_SESSIONS streams of FLEET_NEW greedy tokens, a replica
# killed once each has relayed FLEET_RELAYED; a canary at
# FLEET_CANARY_FRACTION promotes after FLEET_CANARY_SAMPLES canary-arm
# requests; the noisy tenant's bucket holds 2 requests and refills at
# 0.01/s
FLEET_SLOTS, FLEET_SESSIONS, FLEET_RELAYED, FLEET_NEW = 8, 4, 8, 32
FLEET_CANARY_FRACTION, FLEET_CANARY_SAMPLES = 0.1, 4
FLEET_NOISY, FLEET_POLITE = 5, 3
# 37: BruteForceNN over KNN_POINTS x KNN_DIM f32 points on the card,
# KNN_QUERIES queries of k = KNN_K, each through /knn and all at once
KNN_POINTS, KNN_DIM, KNN_QUERIES, KNN_K = 100_000, 128, 256, 10
F32_EPS = 2.0 ** -24


def versions_monotonic(records) -> bool:
    """True when every client's reported versions never move backwards
    (``records``: one list of ``(version, ...)`` per client)."""
    return all(all(a[0] <= b[0] for a, b in zip(r, r[1:]))
               for r in records)


def hot_swap_violations(records, expected: dict, tol: float) -> list:
    """Responses that do not match the version they report: each ``(v,
    row)`` must lie within ``tol`` of ``expected[v]`` and farther than
    ``tol`` from every other version's output.  Returns ``(client, i,
    version, error to its own, least error to another)`` per violation;
    a version without an expected output is a violation too."""
    out = []
    for c, rows in enumerate(records):
        for i, (v, row) in enumerate(rows):
            own = float("inf") if v not in expected else float(
                max(abs(float(a) - float(b))
                    for a, b in zip(row.ravel(), expected[v].ravel())))
            other = min((float(abs(row - e).max())
                         for w, e in expected.items() if w != v),
                        default=float("inf"))
            if own > tol or other <= tol:
                out.append((c, i, v, own, other))
    return out


def stream_ok(events, tokens) -> bool:
    """A /generate NDJSON stream is whole: one token event per index in
    order, then exactly one ``done`` event, last, whose tokens equal the
    token events' and ``tokens``."""
    if not events or not events[-1].get("done"):
        return False
    body = events[:-1]
    if any("token" not in e or e.get("done") or "error" in e for e in body):
        return False
    streamed = [e["token"] for e in body]
    return ([e["index"] for e in body] == list(range(len(body)))
            and streamed == list(events[-1]["tokens"]) == list(tokens))


def knn_violations(got, queries, points) -> tuple:
    """Neighbour indices ``got`` [Q, k] from the f32 index against a
    float64 brute force.  A rank whose index differs from the float64
    one must be a tie: the float64 squared distances of the two differ by
    at most the f32 rounding bound of the expansion |q|^2 - 2 q.p + |p|^2
    (4 D eps (|q|^2 + max |p|^2)).  Returns ``(mismatched ranks, ranks
    that are not ties)``."""
    import numpy as np
    q = np.asarray(queries, np.float64)
    p = np.asarray(points, np.float64)
    d2 = (q * q).sum(1)[:, None] - 2.0 * q @ p.T + (p * p).sum(1)[None, :]
    k = got.shape[1]
    ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
    bound = 4 * q.shape[1] * F32_EPS * (
        (q * q).sum(1) + (p * p).sum(1).max())
    rows = np.arange(len(q))[:, None]
    gap = np.abs(d2[rows, got] - d2[rows, ref])
    mismatched = got != ref
    return int(mismatched.sum()), int((mismatched
                                       & (gap > bound[:, None])).sum())


def _http_error(fn):
    """``(status, headers)`` of the HTTP error ``fn`` raises, or None."""
    import urllib.error
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, e.headers
    return None


def serving_http_phase(args, torch, dev, card, ckpt_dir):
    """Phase 33.  Returns ``(flash launches of the HTTP predicts, None)``
    or ``(None, what failed)``."""
    import shutil
    import threading
    import numpy as np
    from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                     GenerationEngine)
    from deeplearning4j_tpu_torch.observability import (FlightRecorder,
                                                        MetricsRegistry,
                                                        set_flight_recorder)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import (GenerationClient,
                                                  ServingClient,
                                                  ServingEngine,
                                                  ServingServer)
    from deeplearning4j_tpu_torch.serving.engine import (_pad_rows_np,
                                                         _Request)

    t_phase = time.perf_counter()
    net = _lm_net(args, dev, _lm_tree(args, dev, 33))
    rng = np.random.default_rng(args.seed + 33)
    eye = np.eye(VOCAB, dtype=np.float32)
    cfg = GenerationConfig(max_slots=GEN_SLOTS, max_seq=GEN_MAX_SEQ,
                           block_size=GEN_BLOCK)
    reg = MetricsRegistry()
    rec = FlightRecorder(registry=reg)   # the engine's serve slices
    saved_rec = set_flight_recorder(rec)
    server = shed_server = None
    report = {"phase": "serving_http", "card": card}
    try:
        t0 = time.perf_counter()
        server = ServingServer(net, device=dev, max_batch_size=MAX_BATCH,
                               registry=reg, generation=cfg).start()
        report["server_start_with_warmup_s"] = time.perf_counter() - t0
        engine = server.engine
        url = f"http://127.0.0.1:{server.port}"
        client = ServingClient(url, timeout=HTTP_TIMEOUT_S)

        # -- /predict: one-row requests, each split into its stages
        rows = [eye[rng.integers(0, VOCAB, (1, SEQ))]
                for _ in range(HTTP_PREDICT_ROWS)]
        torch.cuda.synchronize()
        fa.reset_launches()
        batches0 = engine.batches_dispatched
        served, splits = [], []
        for x in rows:
            t0 = time.perf_counter()
            body = json.dumps({"data": x.tolist()}).encode()
            t1 = time.perf_counter()
            raw = client._request("POST", "/predict", body)
            t2 = time.perf_counter()
            resp = json.loads(raw)
            out = np.asarray(resp["output"], dtype=np.float32)
            t3 = time.perf_counter()
            served.append((resp["model_version"], out))
            serve = [r for r in rec.channel("profile").items()
                     if r["type"] == "serve"][-1]
            splits.append({"request_bytes": len(body),
                           "response_bytes": len(raw),
                           "client_encode_ms": (t1 - t0) * 1e3,
                           "round_trip_ms": (t2 - t1) * 1e3,
                           "client_decode_ms": (t3 - t2) * 1e3,
                           "total_ms": (t3 - t0) * 1e3,
                           "engine_queue_wait_ms":
                               serve["queue_wait_s"] * 1e3,
                           "engine_batch_form_ms":
                               serve["batch_form_s"] * 1e3,
                           "engine_execute_ms": serve["execute_s"] * 1e3})
        torch.cuda.synchronize()
        predict_launches = dict(fa.launches)
        batches = engine.batches_dispatched - batches0
        worst = 0.0
        for x, (version, out) in zip(rows, served):
            want = net.output(x).cpu().numpy()
            if out.shape != want.shape or not np.isfinite(out).all():
                return None, f"/predict row {out.shape} or not finite"
            worst = max(worst, float(np.abs(out - want).max()))
        # the last request's server stages replayed on its bytes: JSON
        # decode, validation, H2D, forward (CUDA events), D2H and the
        # response's JSON encode; queue wait, batch formation and execute
        # (H2D + forward + D2H) are the engine's own serve slice of it
        t0 = time.perf_counter()
        xs = np.asarray(json.loads(body)["data"], dtype=np.float32)
        t1 = time.perf_counter()
        engine._validate(xs)
        t2 = time.perf_counter()
        x_dev = torch.as_tensor(xs, device=dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y_dev = net.output(x_dev)
        ev[1].record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        y = y_dev.cpu().numpy()
        t5 = time.perf_counter()
        json.dumps({"output": y.tolist(), "model_version": 1})
        t6 = time.perf_counter()
        splits[-1].update({
            "server_decode_ms": (t1 - t0) * 1e3,
            "validate_ms": (t2 - t1) * 1e3, "h2d_ms": (t3 - t2) * 1e3,
            "forward_ms_cuda_events": ev[0].elapsed_time(ev[1]),
            "forward_ms_host": (t4 - t3) * 1e3, "d2h_ms": (t5 - t4) * 1e3,
            "server_encode_ms": (t6 - t5) * 1e3})
        del body, raw, xs, x_dev, y_dev, y
        report.update({"predict": {
            "rows": HTTP_PREDICT_ROWS, "batches": batches,
            "kernel_launches": predict_launches,
            "expected_launches": LAYERS * batches,
            "versions": [v for v, _ in served],
            "max_abs_err_vs_net_output": worst, "tol": TOL_SERVE,
            "splits": splits}})
        if batches != HTTP_PREDICT_ROWS or \
                predict_launches["fwd"] != LAYERS * batches:
            return None, (f"HTTP /predict launched {predict_launches} over "
                          f"{batches} batches; expected {LAYERS} forward "
                          "launches per batch")
        if worst > TOL_SERVE:
            return None, (f"HTTP /predict rows differ from net.output by "
                          f"{worst} > {TOL_SERVE}")

        # -- the in-process batch-16 predict, stage by stage
        batch16 = eye[rng.integers(0, VOCAB, (MAX_BATCH, SEQ))]
        stages = {k: [] for k in ("whole_predict", "validate", "row_split",
                                  "stack_rows", "pad_rows", "h2d",
                                  "forward_cuda_events", "d2h",
                                  "stack_results")}
        for _ in range(3):
            t0 = time.perf_counter()
            engine.predict(batch16)
            stages["whole_predict"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            xs, _ = engine._validate(batch16)
            t1 = time.perf_counter()
            reqs = [_Request(r) for r in xs]
            t2 = time.perf_counter()
            stacked = np.stack([r.row for r in reqs])
            t3 = time.perf_counter()
            padded = _pad_rows_np(stacked, MAX_BATCH)
            t4 = time.perf_counter()
            x_dev = torch.as_tensor(padded, device=dev)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            y_dev = net.output(x_dev)
            ev[1].record()
            torch.cuda.synchronize()
            t6 = time.perf_counter()
            y = y_dev.cpu().numpy()
            t7 = time.perf_counter()
            np.stack([r for r in y])
            t8 = time.perf_counter()
            for k, v in (("validate", t1 - t0), ("row_split", t2 - t1),
                         ("stack_rows", t3 - t2), ("pad_rows", t4 - t3),
                         ("h2d", t5 - t4), ("d2h", t7 - t6),
                         ("stack_results", t8 - t7)):
                stages[k].append(v)
            stages["forward_cuda_events"].append(
                ev[0].elapsed_time(ev[1]) / 1e3)
            del x_dev, y_dev, y
        report["batch16_predict_ms_median"] = {
            k: statistics.median(v) * 1e3 for k, v in stages.items()}

        # -- /generate: 16 concurrent requests, every other one streamed
        prompts = [rng.integers(0, VOCAB, int(n)).tolist() for n in
                   rng.integers(*HTTP_GEN_PROMPTS, HTTP_GEN)]
        results = [None] * HTTP_GEN
        errors = []

        def call(i):
            gc = GenerationClient(url, timeout=HTTP_TIMEOUT_S)
            t0 = time.perf_counter()
            try:
                if i % 2:
                    events, ttft = [], None
                    for ev_ in gc.stream(prompts[i],
                                         max_new_tokens=HTTP_GEN_NEW):
                        if ttft is None and "token" in ev_:
                            ttft = time.perf_counter() - t0
                        events.append(ev_)
                    results[i] = ("stream", events, ttft)
                else:
                    results[i] = ("plain", gc.generate(
                        prompts[i], max_new_tokens=HTTP_GEN_NEW), None)
            except Exception as e:
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(HTTP_GEN)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        gen_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            return None, f"HTTP /generate failed: {errors}"
        ref_eng = GenerationEngine.for_model(net, cfg)
        try:
            ref_eng.warmup()
            t0 = time.perf_counter()
            handles = [ref_eng.submit(p, max_new_tokens=HTTP_GEN_NEW)
                       for p in prompts]
            ref = [h.future.result(timeout=HTTP_TIMEOUT_S).tokens
                   for h in handles]
            ref_s = time.perf_counter() - t0
        finally:
            ref_eng.shutdown()
        equal, whole, ttfts = [], [], []
        for (kind, res, ttft), want in zip(results, ref):
            if kind == "stream":
                whole.append(stream_ok(res, want))
                toks, vers = res[-1]["tokens"], res[-1]["model_versions"]
                ttfts.append(ttft * 1e3)
            else:
                toks, vers = res["tokens"], res["model_versions"]
            equal.append(toks == want and set(vers) == {1})
        report["generate"] = {
            "requests": HTTP_GEN, "streamed": HTTP_GEN // 2,
            "new_tokens": HTTP_GEN_NEW, "prompt_lengths": [
                len(p) for p in prompts],
            "wall_s": gen_s,
            "tokens_per_s": HTTP_GEN * HTTP_GEN_NEW / gen_s,
            "in_process_wall_s": ref_s,
            "in_process_tokens_per_s": HTTP_GEN * HTTP_GEN_NEW / ref_s,
            "ttft_ms_streamed": ttfts,
            "ttft_ms_median": statistics.median(ttfts),
            "greedy_equal_in_process": equal, "streams_whole": whole}
        if not all(equal):
            return None, (f"HTTP /generate tokens differ from the "
                          f"in-process engine's: {equal}")
        if not all(whole):
            return None, f"a streamed /generate is not whole: {whole}"

        # -- a queue-limited engine sheds; /metrics and /health
        shed_engine = ServingEngine(net, device=dev, max_batch_size=MAX_BATCH,
                                    queue_limit=1, registry=reg)
        shed_server = ServingServer(engine=shed_engine, warmup=False,
                                    registry=reg).start()
        row = "[" + ",".join(["0"] * VOCAB) + "]"
        seq = "[" + ",".join([row] * SEQ) + "]"
        two_rows = ('{"data": [' + seq + "," + seq + "]}").encode()
        shed_client = ServingClient(f"http://127.0.0.1:{shed_server.port}",
                                    timeout=HTTP_TIMEOUT_S)
        got = _http_error(lambda: shed_client._request(
            "POST", "/predict", two_rows))
        shed_count = reg.get("serving_shed_total").labels(
            "queue_full", "-").value if reg.get("serving_shed_total") \
            else 0
        text = client.get_text("/metrics")
        families = sorted({line.split()[2].split("_")[0]
                           for line in text.splitlines()
                           if line.startswith("# TYPE ")})
        health = client.get("/health")
        report["shed"] = {"status": got and got[0],
                          "retry_after": got and got[1]["Retry-After"],
                          "serving_shed_total_queue_full": shed_count}
        report["metrics_families"] = families
        report["health_platform"] = health["platform"]
        if got is None or got[0] != 429 or \
                int(got[1]["Retry-After"]) < 1 or shed_count < 1:
            return None, f"queue-limited engine answered {got}"
        if not {"serving", "generation", "http"} <= set(families):
            return None, f"/metrics families {families}"
        if health["platform"] != "gpu" or not health["ready"]:
            return None, f"/health reports {health['platform']}, ready " \
                         f"{health['ready']}"

        # -- hot swap of the LM: /reload from a checkpoint directory
        t0 = time.perf_counter()
        swap = client.reload(directory=str(ckpt_dir))
        reload_s = time.perf_counter() - t0
        gc = GenerationClient(url, timeout=HTTP_TIMEOUT_S)
        after = [gc.generate(p, max_new_tokens=HTTP_GEN_NEW)
                 for p in prompts[:HTTP_SWAP_GEN]]
        report["hot_swap"] = {
            "reload": swap, "reload_s": reload_s,
            "versions_after": [sorted(set(r["model_versions"]))
                               for r in after],
            "checkpoint_bytes": sum(
                f.stat().st_size for f in (
                    Path(ckpt_dir) / f"ckpt-{swap['step']:08d}").iterdir())
            if swap.get("step") is not None else None}
        if not swap.get("promoted") or swap.get("version") != 2:
            return None, f"/reload of {ckpt_dir} answered {swap}"
        if any(r["model_versions"] != [2] * HTTP_GEN_NEW for r in after):
            return None, (f"/generate after the swap reports versions "
                          f"{report['hot_swap']['versions_after']}")
    finally:
        for s in (server, shed_server):
            if s is not None:
                s.stop()
        set_flight_recorder(saved_rec)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        report["seconds"] = round(time.perf_counter() - t_phase, 3)
        print(json.dumps(report, default=str), flush=True)
    return predict_launches, None


def _char_lstm(args, dev, seed_offset: int):
    """The zoo char-LSTM, both LSTMs at ``helper="pallas"``, with fresh
    seeded params on ``dev``."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = TextGenerationLSTM(num_classes=LSTM_CLASSES, timesteps=LSTM_T,
                              hidden=LSTM_HIDDEN,
                              seed=args.seed + seed_offset).conf()
    for lc in conf.layers:
        if isinstance(lc, LSTM):
            lc.helper = "pallas"
    return MultiLayerNetwork(conf, device=dev).init()


def _char_rows(rng, n):
    import numpy as np
    ids = rng.integers(0, LSTM_CLASSES, (n, LSTM_T + 1))
    eye = np.eye(LSTM_CLASSES, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def hot_swap_lstm_phase(args, torch, dev, card):
    """Phase 34.  Returns ``(lstm_fwd launches, None)`` or ``(None, what
    failed)``."""
    import shutil
    import threading
    import urllib.error
    import numpy as np
    from deeplearning4j_tpu_torch.faulttolerance import (CheckpointConfig,
                                                         CheckpointManager)
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.serving import ServingClient, ServingServer

    t_phase = time.perf_counter()
    store = REPO / "build" / "serve_watch"
    shutil.rmtree(store, ignore_errors=True)
    rng = np.random.default_rng(args.seed + 34)
    net = _char_lstm(args, dev, 34)
    batches = [_char_rows(rng, SWAP_BATCH) for _ in range(SWAP_STEPS)]
    x1 = _char_rows(rng, 1)[0]
    # the fit step alone, before any client exists
    alone = []
    for x, y in batches[:SWAP_ALONE]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    first_step = net.iteration
    last_step = first_step + SWAP_STEPS
    mgr = CheckpointManager(str(store), background=False)
    mgr.save(net, step=first_step)
    reg = MetricsRegistry()
    server = ServingServer(checkpoint_dir=str(store), device=dev,
                           max_batch_size=SWAP_CLIENTS,
                           registry=reg).start()
    engine = server.engine
    swaps = [(engine.model_version, engine.slot.step)]
    hot_swap = engine.hot_swap

    def logged(model, origin="swap", step=None):
        v = hot_swap(model, origin=origin, step=step)
        swaps.append((v, step))
        return v

    engine.hot_swap = logged
    url = f"http://127.0.0.1:{server.port}"
    records = [[] for _ in range(SWAP_CLIENTS)]
    failures = []
    stop = threading.Event()
    progress = threading.Condition()

    def client_loop(mine):
        client = ServingClient(url, timeout=HTTP_TIMEOUT_S)
        while not stop.is_set():
            try:
                out, version = client.predict_versioned(x1)
            except (urllib.error.URLError, OSError) as e:
                failures.append(f"{type(e).__name__}: {e}")
                continue
            with progress:
                mine.append((int(version), np.asarray(out[0], np.float32)))
                progress.notify_all()

    def tail_seen():
        last = engine.model_version
        return all(sum(1 for v, _ in r if v == last) >= SWAP_TAIL
                   for r in records)

    threads = [threading.Thread(target=client_loop, args=(r,))
               for r in records]
    report = {"phase": "hot_swap_lstm", "card": card}
    try:
        torch.cuda.synchronize()
        pl.reset_launches()
        batches0 = engine.batches_dispatched
        for t in threads:
            t.start()
        with progress:
            progress.wait_for(lambda: all(len(r) >= SWAP_TAIL
                                          for r in records), HTTP_TIMEOUT_S)
        engine.watch(interval_s=SWAP_POLL_S)
        t0 = time.perf_counter()
        net.fit(batches, checkpoint=CheckpointConfig(
            directory=str(store), save_every_n_iterations=SWAP_EVERY,
            background=True, keep_last=SWAP_STEPS + 1))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        deadline = time.perf_counter() + HTTP_TIMEOUT_S
        while engine.slot.step != last_step and \
                time.perf_counter() < deadline:
            stop.wait(SWAP_POLL_S)
        with progress:
            progress.wait_for(tail_seen, HTTP_TIMEOUT_S)
        stop.set()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        launches = pl.launches["lstm_fwd"]
        batches_served = engine.batches_dispatched - batches0
    finally:
        stop.set()
        server.stop()
    expected = {}
    for v, step in swaps:
        model, _ = mgr.restore(path=mgr.path_for(step), load_updater=False,
                               device=dev)
        expected[v] = model.output(x1).cpu().numpy()[0]
    violations = hot_swap_violations(records, expected, TOL_SWAP)
    counts = {}
    for r in records:
        for v, _ in r:
            counts[v] = counts.get(v, 0) + 1
    want_launches = 2 * (SWAP_STEPS + batches_served)
    report.update({
        "clients": SWAP_CLIENTS, "fit_steps": SWAP_STEPS,
        "checkpoint_every": SWAP_EVERY, "fit_s": fit_s,
        "fit_step_ms_under_clients": fit_s / SWAP_STEPS * 1e3,
        "fit_step_ms_alone": alone,
        "swaps": swaps, "promotions": len(swaps) - 1,
        "requests": sum(len(r) for r in records),
        "responses_per_version": counts, "failed_requests": failures,
        "violations": violations[:8], "tol": TOL_SWAP,
        "versions_monotonic": versions_monotonic(records),
        "batches_served": batches_served, "lstm_fwd_launches": launches,
        "expected_launches": want_launches,
        "seconds": round(time.perf_counter() - t_phase, 3)})
    print(json.dumps(report, default=str), flush=True)
    shutil.rmtree(store, ignore_errors=True)
    if failures:
        return None, f"{len(failures)} failed requests under hot swap"
    if len(counts) < 2 or engine.model_version < 2:
        return None, f"clients saw versions {sorted(counts)} only"
    if violations:
        return None, (f"{len(violations)} responses do not match the "
                      f"version they report: {violations[:4]}")
    if not versions_monotonic(records):
        return None, "a client saw its versions move backwards"
    if launches != want_launches:
        return None, (f"lstm_fwd launched {launches} times; expected "
                      f"{want_launches} (2 per fit step and per served "
                      "batch)")
    return launches, None


def inference_server_phase(args, torch, dev, card):
    """Phase 35.  Returns ``(lstm_fwd launches per mode, None)`` or
    ``(None, what failed)``."""
    import threading
    import numpy as np
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.parallel import InferenceMode
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer)

    t_phase = time.perf_counter()
    net = _char_lstm(args, dev, 35)
    rows = _char_rows(np.random.default_rng(args.seed + 35), PI_REQUESTS)[0]
    want = net.output(rows).cpu().numpy()
    calls = [0]
    real_output = net.output

    def counted(x, train=False):
        calls[0] += 1
        return real_output(x, train)

    out_launches, report = {}, {"phase": "inference_server", "card": card}
    for mode in (InferenceMode.BATCHED, InferenceMode.INPLACE):
        server = InferenceServer(net, inference_mode=mode, device=dev,
                                 max_batch_size=PI_MAX_BATCH,
                                 registry=MetricsRegistry()).start()
        url = f"http://127.0.0.1:{server.port}"
        got = [None] * PI_REQUESTS
        errors = []

        def call(i):
            try:
                got[i] = InferenceClient(url, timeout=HTTP_TIMEOUT_S
                                         ).predict(rows[i:i + 1])[0]
            except Exception as e:
                errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(PI_REQUESTS)]
        try:
            torch.cuda.synchronize()
            pl.reset_launches()
            calls[0] = 0
            net.output = counted
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=HTTP_TIMEOUT_S)
            wall = time.perf_counter() - t0
            health = InferenceClient(url, timeout=HTTP_TIMEOUT_S).get(
                "/health")
        finally:
            del net.output
            server.stop()
        launches = pl.launches["lstm_fwd"]
        worst = max(float(np.abs(np.asarray(g) - w).max())
                    for g, w in zip(got, want)) if not errors else None
        report[mode] = {"requests": PI_REQUESTS, "forwards": calls[0],
                        "lstm_fwd_launches": launches,
                        "max_abs_err_vs_net_output": worst, "tol": TOL_SWAP,
                        "wall_s": wall, "platform": health["platform"]}
        out_launches[mode] = launches
        if errors:
            return None, f"InferenceServer {mode}: {errors[:3]}"
        if worst > TOL_SWAP:
            return None, (f"InferenceServer {mode} rows differ from "
                          f"net.output by {worst} > {TOL_SWAP}")
        if calls[0] == 0 or launches != 2 * calls[0]:
            return None, (f"InferenceServer {mode}: {launches} lstm_fwd "
                          f"launches over {calls[0]} forwards; expected 2 "
                          "per forward")
        if health["platform"] != "gpu":
            return None, f"InferenceServer reports {health['platform']}"
    report["seconds"] = round(time.perf_counter() - t_phase, 3)
    print(json.dumps(report), flush=True)
    return out_launches, None


def fleet_phase(args, torch, dev, card):
    """Phase 36.  Returns ``(flash launches of the routed predicts,
    None)`` or ``(None, what failed)``."""
    import threading
    import numpy as np
    from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                     GenerationEngine)
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.serving import (CanaryConfig, FleetClient,
                                                  FleetServer, ServingFleet,
                                                  ShedError, TenantAdmission,
                                                  TenantQuota)

    t_phase = time.perf_counter()
    net = _lm_net(args, dev, _lm_tree(args, dev, 36))
    rng = np.random.default_rng(args.seed + 36)
    eye = np.eye(VOCAB, dtype=np.float32)
    cfg = GenerationConfig(max_slots=FLEET_SLOTS, max_seq=GEN_MAX_SEQ,
                           block_size=GEN_BLOCK)
    reg = MetricsRegistry()
    fleet = ServingFleet(
        net, n_replicas=2, device=dev, generation=cfg, registry=reg,
        engine_kw={"max_batch_size": MAX_BATCH},
        tenants=TenantAdmission({"noisy": TenantQuota(rate=0.01, burst=2.0)},
                                registry=reg),
        canary_config=CanaryConfig(min_samples=FLEET_CANARY_SAMPLES))
    report = {"phase": "fleet", "replicas": 2, "slots_each": FLEET_SLOTS,
              "card": card}
    fleet_server = None
    try:
        # as a deployment does before it takes traffic: a cold replica's
        # first requests would read as a slow canary arm
        t0 = time.perf_counter()
        fleet.warmup()
        report["warmup_s"] = time.perf_counter() - t0
        # the single-replica greedy oracle for every prompt below
        prompts = [rng.integers(0, VOCAB, int(n)).tolist() for n in
                   rng.integers(*HTTP_GEN_PROMPTS, FLEET_SESSIONS + 2)]
        solo = GenerationEngine.for_model(net, cfg)
        try:
            handles = [solo.submit(p, max_new_tokens=FLEET_NEW)
                       for p in prompts]
            oracle = [h.future.result(timeout=HTTP_TIMEOUT_S).tokens
                      for h in handles]
        finally:
            solo.shutdown()

        # -- least-loaded predicts through FleetRouter.predict
        rows = [eye[rng.integers(0, VOCAB, (1, SEQ))] for _ in range(2)]
        torch.cuda.synchronize()
        fa.reset_launches()
        outs = [fleet.router.predict(x) for x in rows]
        torch.cuda.synchronize()
        predict_launches = dict(fa.launches)
        worst = max(float(np.abs(o - net.output(x).cpu().numpy()).max())
                    for o, x in zip(outs, rows))
        routed = reg.get("fleet_routed_total")
        report["predict"] = {"rows": len(rows),
                             "kernel_launches": predict_launches,
                             "expected_launches": LAYERS * len(rows),
                             "max_abs_err_vs_net_output": worst,
                             "tol": TOL_SERVE,
                             "routed": {s["labels"]["replica"]: s["value"]
                                        for s in reg.snapshot()[
                                            "fleet_routed_total"]["samples"]
                                        if s["labels"]["route"] ==
                                        "predict"} if routed else {}}
        if predict_launches["fwd"] != LAYERS * len(rows):
            return None, (f"fleet predicts launched {predict_launches}; "
                          f"expected {LAYERS} forward launches per row")
        if worst > TOL_SERVE:
            return None, f"fleet predict rows differ by {worst}"

        # -- tenants: the noisy one sheds, every polite request succeeds
        noisy = []
        for _ in range(FLEET_NOISY):
            try:
                fleet.generate(prompts[0][:8], max_new_tokens=2,
                               tenant="noisy", timeout=HTTP_TIMEOUT_S)
                noisy.append("ok")
            except ShedError as e:
                noisy.append(e.status)
        polite = [fleet.generate(prompts[0], max_new_tokens=FLEET_NEW,
                                 tenant="polite",
                                 timeout=HTTP_TIMEOUT_S).tokens == oracle[0]
                  for _ in range(FLEET_POLITE)]
        report["tenants"] = {"noisy": noisy, "polite_equal": polite}
        if noisy.count(429) < FLEET_NOISY - 2 or not all(polite):
            return None, f"tenant isolation: noisy {noisy}, polite {polite}"

        # -- a 10 % canary promotes; versions never move backwards
        history = [[r.engine.model_version for r in fleet.replicas]]
        fleet.canary(net, fraction=FLEET_CANARY_FRACTION, n_replicas=1)
        history.append([r.engine.model_version for r in fleet.replicas])
        canary_requests = 0
        while fleet._canary is not None and canary_requests < 400:
            fleet.generate(prompts[1][:16], max_new_tokens=2,
                           timeout=HTTP_TIMEOUT_S)
            canary_requests += 1
        history.append([r.engine.model_version for r in fleet.replicas])
        decision = fleet.canary_controller.status()
        report["canary"] = {"fraction": FLEET_CANARY_FRACTION,
                            "requests": canary_requests,
                            "decision": decision, "versions": history}
        if decision["decision"] != "promote" or not all(
                all(a <= b for a, b in zip(h0, h1))
                for h0, h1 in zip(history, history[1:])):
            return None, f"canary: {report['canary']}"

        # -- kill a replica once each live session has relayed tokens
        relayed = [threading.Event() for _ in range(FLEET_SESSIONS)]
        killed = threading.Event()
        streams = [None] * FLEET_SESSIONS

        def consume(i):
            toks, t_resume = [], None
            for ev_ in fleet.stream(prompts[i], max_new_tokens=FLEET_NEW,
                                    timeout=HTTP_TIMEOUT_S):
                if "error" in ev_:
                    streams[i] = ("error", ev_["error"], None)
                    return
                if "token" in ev_:
                    toks.append(ev_["token"])
                    if len(toks) == FLEET_RELAYED:
                        relayed[i].set()
                        killed.wait(HTTP_TIMEOUT_S)
                    elif len(toks) == FLEET_RELAYED + 1:
                        t_resume = time.perf_counter()
            streams[i] = ("ok", toks, t_resume)

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(FLEET_SESSIONS)]
        for t in threads:
            t.start()
        for e in relayed:
            e.wait(HTTP_TIMEOUT_S)
        owners, owner_of = {}, {}
        for sess in list(fleet.router._sessions.values()):
            owners[sess.replica.id] = owners.get(sess.replica.id, 0) + 1
            owner_of[prompts.index(sess.mirror["prompt"])] = sess.replica.id
        victim = max(owners, key=owners.get)
        t_kill = time.perf_counter()
        fleet.kill(victim)
        kill_s = time.perf_counter() - t_kill
        killed.set()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        migrated = reg.get("fleet_migrations_total").labels("killed").value
        # a moved session's next token comes after its re-prefill on the
        # survivor; a session that stayed had its next token queued
        resume_ms = {("moved" if owner_of.get(i) == victim else "stayed"):
                     [] for i in range(FLEET_SESSIONS)}
        for i, s_ in enumerate(streams):
            if s_ and s_[0] == "ok" and s_[2] is not None:
                resume_ms["moved" if owner_of.get(i) == victim
                          else "stayed"].append((s_[2] - t_kill) * 1e3)
        equal = [s is not None and s[0] == "ok" and s[1] == oracle[i]
                 for i, s in enumerate(streams)]
        report["migration"] = {
            "sessions": FLEET_SESSIONS, "relayed_before_kill": FLEET_RELAYED,
            "sessions_per_replica": owners, "victim": victim,
            "migrated": migrated, "kill_call_ms": kill_s * 1e3,
            "next_token_after_kill_ms": resume_ms,
            "streams_equal_single_replica": equal,
            "live_replicas": fleet.health()["live_replicas"]}
        if not all(equal) or migrated < owners[victim]:
            return None, f"migration: {report['migration']}"

        # -- one stream through the FleetServer
        fleet_server = FleetServer(fleet, registry=reg).start()
        events = list(FleetClient(f"http://127.0.0.1:{fleet_server.port}",
                                  timeout=HTTP_TIMEOUT_S).stream(
            prompts[-1], max_new_tokens=FLEET_NEW))
        report["fleet_server_stream_whole"] = stream_ok(events, oracle[-1])
        if not report["fleet_server_stream_whole"]:
            return None, "the FleetServer stream is not the oracle's"
    finally:
        if fleet_server is not None:
            fleet_server.stop()
        else:
            fleet.shutdown()
        report["seconds"] = round(time.perf_counter() - t_phase, 3)
        print(json.dumps(report, default=str), flush=True)
    return predict_launches, None


def knn_phase(args, torch, dev, card):
    """Phase 37.  Returns None, or what failed."""
    import numpy as np
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import (NearestNeighborsClient,
                                                  NearestNeighborsServer)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 37)
    points = rng.standard_normal((KNN_POINTS, KNN_DIM)).astype(np.float32)
    queries = rng.standard_normal((KNN_QUERIES, KNN_DIM)).astype(np.float32)
    server = NearestNeighborsServer(points, device=dev,
                                    registry=MetricsRegistry()).start()
    try:
        client = NearestNeighborsClient(f"http://127.0.0.1:{server.port}",
                                        timeout=HTTP_TIMEOUT_S)
        times, got = [], []
        for q in queries:
            t0 = time.perf_counter()
            res = client.knn(q, k=KNN_K)
            times.append((time.perf_counter() - t0) * 1e3)
            got.append([r["index"] for r in res])
        health = client.get("/health")
        index = server._index
        batch_ms = median_ms(lambda: index.query(queries, KNN_K), torch,
                             runs=10)
        _, all_at_once = index.query(queries, KNN_K)
    finally:
        server.stop()
    got = np.asarray(got)
    mismatched, not_ties = knn_violations(got, queries, points)
    batch_mismatched, batch_not_ties = knn_violations(all_at_once, queries,
                                                      points)
    print(json.dumps({
        "phase": "knn", "points": KNN_POINTS, "dim": KNN_DIM,
        "queries": KNN_QUERIES, "k": KNN_K,
        "points_mb": points.nbytes / 1e6,
        "http_query_ms_median": statistics.median(times),
        "http_query_ms_p99": float(np.percentile(times, 99)),
        "batch_query_ms_cuda_events": batch_ms,
        "mismatched_ranks": mismatched, "not_ties": not_ties,
        "batch_mismatched_ranks": batch_mismatched,
        "batch_not_ties": batch_not_ties,
        "platform": health["platform"],
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not_ties or batch_not_ties:
        return (f"k-NN indices differ from the float64 brute force outside "
                f"ties: {not_ties} by HTTP, {batch_not_ties} at once")
    if health["platform"] != "gpu":
        return f"the k-NN server reports {health['platform']}"
    return None


# ---- 38-42. training across ranks ---------------------------------------
PAR_STEPS = 5
PAR_LAYOUT_DPS = (1, 2, 4, 8)
SHARD_SAVE_AT, SHARD_STEPS = 3, 6
SERVE_SHARDED_ROWS = 2
ELASTIC_SAVE_FREQ, ELASTIC_CRASH_AFTER, ELASTIC_STEPS = 2, 5, 8
SPARSE_STEPS = 5
SPARSE_SGD_LR = 1e-2
# the LM's token ids follow a Zipf law, as text does (a = 1.2): a step
# touches a few thousand of the 8192 rows
SPARSE_ZIPF_A = 1.2
# sparse against dense SGD: the same forward, and the table's gradient
# summed per row by a segment sum instead of the dense backward's
# accumulation (another order of f32 additions): 1e-6 of each leaf's
# largest |value|
TOL_SPARSE_SGD = 1e-6
MASTER_WORKERS, MASTER_FREQ, MASTER_BATCHES = 2, 2, 8
# the shared-gradients codec: Adam's updates are ~lr = 3e-4 an element
MASTER_THRESHOLD = 1e-4


def world_of_one(dev):
    """A one-rank process group for the data-parallel phases (NCCL on the
    card), through the port's bootstrap; a free localhost port."""
    import socket
    from deeplearning4j_tpu_torch.parallel import initialize_distributed
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    if not initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=dev):
        raise RuntimeError("the process group did not start")


def _lm_batches(args, offset: int, steps: int, zipf=None):
    import numpy as np
    rng = np.random.default_rng(args.seed + offset)
    if zipf:
        toks = np.minimum(rng.zipf(zipf, (steps, TRAIN_BATCH, SEQ + 1)),
                          VOCAB) - 1
    else:
        toks = rng.integers(0, VOCAB, (steps, TRAIN_BATCH, SEQ + 1))
    return [(b[:, :-1], b[:, 1:]) for b in toks]


def _fit_timed(torch, trainer, net, batches):
    """Each batch through ``trainer.fit``; returns (losses, step ms)."""
    losses, ms = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(x, y)
        losses.append(float(net.get_score()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return losses, ms


def parallel_lm_phase(args, torch, dev, card):
    """Phase 38.  Returns ``({"wrapper": launches, "sharded": launches},
    None)`` or ``(None, what failed)``."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   ShardedTrainer, make_mesh,
                                                   param_bytes,
                                                   per_device_param_bytes)
    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 38)
    batches = _lm_batches(args, 38, PAR_STEPS)
    mesh = make_mesh(device=dev)
    runs = {}
    for name in ("plain", "wrapper", "zero1", "sharded"):
        net = _lm_net(args, dev, tree)
        trainer = {"plain": lambda: net,
                   "wrapper": lambda: ParallelWrapper(net, mesh),
                   "zero1": lambda: ParallelWrapper(
                       net, mesh, shard_optimizer_state=True),
                   "sharded": lambda: ShardedTrainer(net, mesh)}[name]()
        torch.cuda.synchronize()
        fa.reset_launches()
        losses, ms = _fit_timed(torch, trainer, net, batches)
        runs[name] = {"losses": losses, "launches": dict(fa.launches),
                      "step_ms_median": statistics.median(ms[1:]),
                      "state": training_state(net)}
        del net, trainer
        torch.cuda.empty_cache()
    wrapped = ("wrapper", "zero1", "sharded")
    diffs = {f"{a}_vs_{b}": state_max_diff(runs[a]["state"],
                                           runs[b]["state"])
             for a, b in (("wrapper", "zero1"), ("wrapper", "sharded"),
                          ("wrapper", "plain"))}
    loss_diff = max(abs(a - b) / abs(b) for n in wrapped
                    for a, b in zip(runs[n]["losses"],
                                    runs["plain"]["losses"]))
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    spec = MultiLayerNetwork(TransformerLM(
        vocab_size=VOCAB, seq_len=SEQ, embed=EMBED, n_layers=LAYERS,
        n_heads=HEADS, sparse_labels=True).conf(), device=dev).param_spec()
    layout = {dp: per_device_param_bytes(spec, dp) for dp in PAR_LAYOUT_DPS}
    expected = {k: LAYERS * PAR_STEPS for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "parallel_lm", "world_size": 1, "backend": "nccl",
        "model": {"vocab": VOCAB, "seq": SEQ, "embed": EMBED,
                  "layers": LAYERS, "heads": HEADS, "batch": TRAIN_BATCH,
                  "updater": "Adam(3e-4)", "dtype": "float32"},
        "steps": PAR_STEPS,
        "losses": {n: r["losses"] for n, r in runs.items()},
        "max_rel_loss_diff_vs_plain": loss_diff,
        "max_abs_diff": diffs, "gate": 0.0,
        "step_ms_median": {n: r["step_ms_median"] for n, r in runs.items()},
        "kernel_launches": {n: r["launches"] for n, r in runs.items()},
        "expected_launches": expected,
        "param_bytes": param_bytes(spec),
        "per_device_param_bytes": layout,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not all(math.isfinite(v) for r in runs.values()
               for v in r["losses"]):
        return None, "parallel LM losses not finite"
    # at dp 1 zero3_spec replicates every leaf: the three wrapped runs
    # compute the same ops, and the world-1 exchange (NCCL sums of one
    # rank) leaves plain fit's numbers as they are
    if any(d != 0.0 for d in diffs.values()) or loss_diff != 0.0:
        return None, (f"wrapped LM runs differ: {diffs}, losses "
                      f"{loss_diff} (gate 0.0)")
    for n, r in runs.items():
        if r["launches"] != expected:
            return None, (f"{n} LM launched {r['launches']}; expected "
                          f"{expected}")
    if layout[1] != param_bytes(spec) or not \
            layout[8] < layout[4] < layout[2] < layout[1]:
        return None, f"per-device bytes do not shrink with dp: {layout}"
    return {"wrapper": runs["wrapper"]["launches"],
            "sharded": runs["sharded"]["launches"]}, None


def sharded_checkpoint_phase(args, torch, dev, card):
    """Phase 39.  Returns ``(flash launches of the resumed sharded run,
    None)`` or ``(None, what failed)``."""
    import shutil
    import numpy as np
    from deeplearning4j_tpu_torch.faulttolerance import CheckpointManager
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, make_mesh
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    t_phase = time.perf_counter()
    store = REPO / "build" / "sharded_checkpoint"
    shutil.rmtree(store, ignore_errors=True)
    tree = _lm_tree(args, dev, 39)
    batches = _lm_batches(args, 39, SHARD_STEPS)
    mesh = make_mesh(device=dev)
    net_a = _lm_net(args, dev, tree)
    st_a = ShardedTrainer(net_a, mesh)
    for x, y in batches[:SHARD_SAVE_AT]:
        st_a.fit(x, y)
    mgr = CheckpointManager(str(store), background=False,
                            keep_last=SHARD_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    path = st_a.save_sharded(mgr)
    write_s = time.perf_counter() - t1
    for x, y in batches[SHARD_SAVE_AT:]:
        st_a.fit(x, y)
    state_a = training_state(net_a)
    del net_a, st_a
    files = sorted(os.listdir(path))
    with open(os.path.join(path, "manifest.json")) as f:
        nbytes = sum(v["bytes"] for v in json.load(f)["files"].values())
    net_b = _lm_net(args, dev, _lm_tree(args, dev, 139))
    t1 = time.perf_counter()
    mgr.restore_sharded(path=path, net=net_b, device=dev)
    restore_s = time.perf_counter() - t1
    st_b = ShardedTrainer(net_b, mesh)
    torch.cuda.synchronize()
    fa.reset_launches()
    for x, y in batches[SHARD_SAVE_AT:]:
        st_b.fit(x, y)
    launches_b = dict(fa.launches)
    diff = state_max_diff(state_a, training_state(net_b))
    del net_b, st_b
    torch.cuda.empty_cache()
    # promote the step-3 directory into a serving slot
    ref = _lm_net(args, dev, _lm_tree(args, dev, 239))
    mgr.restore_sharded(path=path, net=ref, device=dev)
    rng = np.random.default_rng(args.seed + 239)
    rows = np.eye(VOCAB, dtype=np.float32)[
        rng.integers(0, VOCAB, (SERVE_SHARDED_ROWS, SEQ))]
    want = ref.output(rows).cpu().numpy()
    engine = ServingEngine(device=dev, max_batch_size=SERVE_SHARDED_ROWS)
    try:
        t1 = time.perf_counter()
        step = engine.promote_latest(str(store))
        promote_s = time.perf_counter() - t1
        fa.reset_launches()
        batches0 = engine.batches_dispatched
        got = engine.predict(rows)
        served = engine.batches_dispatched - batches0
        serve_launches = dict(fa.launches)
    finally:
        engine.shutdown()
    row_diff = float(np.abs(got - want).max())
    expected = {k: LAYERS * (SHARD_STEPS - SHARD_SAVE_AT)
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "sharded_checkpoint_lm", "world_size": 1,
        "saved_at": SHARD_SAVE_AT, "steps": SHARD_STEPS, "files": files,
        "checkpoint_bytes": nbytes, "write_s": round(write_s, 4),
        "write_mb_per_s": nbytes / write_s / 1e6,
        "restore_s": round(restore_s, 4),
        "max_abs_diff_resumed_vs_uninterrupted": diff, "gate": 0.0,
        "kernel_launches_resumed": launches_b,
        "expected_launches": expected,
        "promoted_step": step, "promote_s": round(promote_s, 4),
        "served_rows": SERVE_SHARDED_ROWS, "served_batches": served,
        "serve_launches": serve_launches,
        "max_abs_diff_served_vs_output": row_diff,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    shutil.rmtree(store, ignore_errors=True)
    if "topology.json" not in files or "shards-p00.npz" not in files:
        return None, f"the sharded checkpoint holds {files}"
    if diff != 0.0:
        return None, (f"the resumed sharded LM differs from the "
                      f"uninterrupted run by {diff} (gate 0.0)")
    if launches_b != expected:
        return None, (f"the resumed sharded LM launched {launches_b}; "
                      f"expected {expected}")
    if step != SHARD_SAVE_AT or row_diff != 0.0 or served != 1 or \
            serve_launches["fwd"] != LAYERS * served or \
            serve_launches["bwd_dq"] or serve_launches["bwd_dkv"]:
        return None, (f"promoted step {step}, served rows off by "
                      f"{row_diff}, {served} batches launched "
                      f"{serve_launches}")
    return launches_b, None


class _Crash(RuntimeError):
    """The elastic phase's injected crash."""


def elastic_lm_phase(args, torch, dev, card):
    """Phase 40.  Returns ``(flash launches of the restarted run, None)``
    or ``(None, what failed)``."""
    import shutil
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (ElasticTrainer,
                                                   ShardedTrainer, make_mesh)
    t_phase = time.perf_counter()
    store = REPO / "build" / "elastic_lm"
    shutil.rmtree(store, ignore_errors=True)
    tree = _lm_tree(args, dev, 40)
    batches = _lm_batches(args, 40, ELASTIC_STEPS)
    mesh = make_mesh(device=dev)
    net_r = _lm_net(args, dev, tree)
    st_r = ShardedTrainer(net_r, mesh)
    for x, y in batches:
        st_r.fit(x, y)
    state_r = training_state(net_r)
    del net_r, st_r

    def crashing():
        for i, b in enumerate(batches):
            if i == ELASTIC_CRASH_AFTER:
                raise _Crash(f"crash after step {i}")
            yield b

    net_c = _lm_net(args, dev, tree)
    et = ElasticTrainer(ShardedTrainer(net_c, mesh), str(store),
                        save_freq=ELASTIC_SAVE_FREQ, keep_last=ELASTIC_STEPS)
    try:
        et.fit(crashing)
        return None, "the injected crash did not happen"
    except _Crash:
        pass
    crashed_at = net_c.iteration
    del net_c, et
    torch.cuda.empty_cache()
    net_d = _lm_net(args, dev, _lm_tree(args, dev, 140))
    et = ElasticTrainer(ShardedTrainer(net_d, mesh), str(store),
                        save_freq=ELASTIC_SAVE_FREQ, keep_last=ELASTIC_STEPS)
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    done = et.fit(lambda: iter(batches))
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t1
    launches = dict(fa.launches)
    diff = state_max_diff(state_r, training_state(net_d))
    resumed = et.last_restored_step
    expected = {k: LAYERS * (ELASTIC_STEPS - resumed)
                for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "elastic_lm", "world_size": 1, "save_freq":
        ELASTIC_SAVE_FREQ, "crashed_after_step": crashed_at,
        "resumed_from_step": resumed, "steps": done,
        "steps_lost": crashed_at - resumed,
        "restore_s": round(et.last_restore_s, 4),
        "restart_run_s": round(restart_s, 4),
        "max_abs_diff_vs_uninterrupted": diff, "gate": 0.0,
        "kernel_launches_restarted": launches,
        "expected_launches": expected,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    shutil.rmtree(store, ignore_errors=True)
    if crashed_at != ELASTIC_CRASH_AFTER or resumed != 4 or \
            done != ELASTIC_STEPS:
        return None, (f"crashed at {crashed_at}, resumed from {resumed}, "
                      f"ended at {done}")
    if diff != 0.0:
        return None, (f"the restarted LM differs from the uninterrupted "
                      f"run by {diff} (gate 0.0)")
    if launches != expected:
        return None, f"the restart launched {launches}; expected {expected}"
    return launches, None


def _leaf_rel_diff(a, b) -> float:
    """Largest |a - b| of a leaf over the leaf's largest |b|, over every
    parameter of two networks."""
    worst = 0.0
    for k, g in b.params.items():
        for n, p in g.items():
            scale = p.detach().abs().max().item() or 1.0
            err = (a.params[k][n].detach() - p.detach()).abs().max().item()
            worst = max(worst, err / scale)
    return worst


def sparse_embedding_phase(args, torch, dev, card):
    """Phase 41.  Returns ``(flash launches of the sparse Adam run, None)``
    or ``(None, what failed)``."""
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 41)
    batches = _lm_batches(args, 41, SPARSE_STEPS, zipf=SPARSE_ZIPF_A)
    nets = {}
    for name in ("dense", "sparse"):
        net = _lm_net(args, dev, tree, updater=Sgd(learning_rate=SPARSE_SGD_LR))
        net.conf.layers[0].sparse_grad = name == "sparse"
        torch.cuda.synchronize()
        losses, ms = _fit_timed(torch, net, net, batches)
        nets[name] = (net, losses, statistics.median(ms[1:]))
    sgd_diff = _leaf_rel_diff(nets["sparse"][0], nets["dense"][0])
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip(nets["sparse"][1], nets["dense"][1]))
    sgd_ms = {n: v[2] for n, v in nets.items()}
    del nets
    torch.cuda.empty_cache()
    net = _lm_net(args, dev, tree)
    net.conf.layers[0].sparse_grad = True
    W0 = net.params["layer_0"]["W"].detach().clone()
    touched_steps, seen = [], set()
    torch.cuda.synchronize()
    fa.reset_launches()
    adam_ms = []
    for x, y in batches:
        t1 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        adam_ms.append((time.perf_counter() - t1) * 1e3)
        touched_steps.append(int(net._last_grad_stats[
            "embedding_rows_touched"]))
        seen |= set(x.reshape(-1).tolist())
    launches = dict(fa.launches)
    untouched = torch.tensor(sorted(set(range(VOCAB)) - seen),
                             device=dev, dtype=torch.long)
    W1 = net.params["layer_0"]["W"].detach()
    slots = net.opt_state["slots"]["layer_0"]["W"]
    rows_same = bool(torch.equal(W1[untouched], W0[untouched]))
    slots_same = all(bool((slots[s][untouched] == 0).all())
                     for s in ("mu", "nu"))
    moved = bool((W1[torch.tensor(sorted(seen), device=dev)]
                  != W0[torch.tensor(sorted(seen), device=dev)]).any())
    expected = {k: LAYERS * SPARSE_STEPS for k in ("fwd", "bwd_dq",
                                                   "bwd_dkv")}
    print(json.dumps({
        "phase": "sparse_embedding_lm", "vocab": VOCAB,
        "ids": f"zipf(a={SPARSE_ZIPF_A}) clipped to the vocabulary",
        "steps": SPARSE_STEPS,
        "sgd": {"lr": SPARSE_SGD_LR, "max_leaf_rel_diff_vs_dense": sgd_diff,
                "max_rel_loss_diff": loss_diff, "tol": TOL_SPARSE_SGD,
                "step_ms_median": sgd_ms},
        "adam": {"rows_touched_per_step": touched_steps,
                 "rows_touched_in_all": len(seen),
                 "untouched_rows": int(untouched.numel()),
                 "untouched_rows_bit_identical": rows_same,
                 "untouched_mu_nu_still_zero": slots_same,
                 "step_ms_median": statistics.median(adam_ms[1:])},
        "kernel_launches_adam": launches, "expected_launches": expected,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if sgd_diff > TOL_SPARSE_SGD or loss_diff > TOL_SPARSE_SGD:
        return None, (f"sparse SGD differs from dense by {sgd_diff} (losses "
                      f"{loss_diff}) > {TOL_SPARSE_SGD}")
    if not (rows_same and slots_same and moved) or untouched.numel() == 0:
        return None, (f"lazy Adam: untouched rows same {rows_same}, their "
                      f"mu/nu zero {slots_same}, touched rows moved "
                      f"{moved}, {untouched.numel()} untouched")
    if launches != expected:
        return None, f"the sparse LM launched {launches}; expected {expected}"
    return launches, None


def masters_phase(args, torch, dev, card):
    """Phase 42.  Returns ``(flash launches of both masters' runs, None)``
    or ``(None, what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import accumulation as acc_mod
    from deeplearning4j_tpu_torch.parallel import master as master_mod
    from deeplearning4j_tpu_torch.utils import native
    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 42)
    batches = _lm_batches(args, 42, MASTER_BATCHES)
    # averaging: the trees tree_average is handed, and what it returns
    averaged = []
    real_avg = master_mod.tree_average

    def recording(trees, depth=2):
        out = real_avg(trees, depth)
        if trees and "layer_0" in trees[0]:
            averaged.append(([{k: {n: t.clone() for n, t in g.items()}
                               for k, g in tr.items()} for tr in trees],
                             out))
        return out

    net = _lm_net(args, dev, tree)
    master = master_mod.ParameterAveragingTrainingMaster(
        num_workers=MASTER_WORKERS, averaging_frequency=MASTER_FREQ)
    master_mod.tree_average = recording
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    try:
        master.fit(net, batches)
    finally:
        master_mod.tree_average = real_avg
    torch.cuda.synchronize()
    avg_s = time.perf_counter() - t1
    avg_launches = dict(fa.launches)
    avg_loss = float(net.get_score())
    by_hand = 0.0
    for trees, out in averaged:
        for k, g in trees[0].items():
            for n, t in g.items():
                hand = (t + trees[1][k][n]) / 2
                by_hand = max(by_hand,
                              (out[k][n] - hand).abs().max().item())
    last = averaged[-1][1] if averaged else {}
    installed = max((net.params[k][n].detach() - t).abs().max().item()
                    for k, g in last.items() for n, t in g.items()) \
        if last else float("inf")
    rounds = len(averaged)
    del master
    torch.cuda.empty_cache()
    # shared gradients: each message against the update it encodes
    net_s = _lm_net(args, dev, tree)
    shared = master_mod.SharedGradientsTrainingMaster(
        num_workers=MASTER_WORKERS,
        handler_factory=lambda: acc_mod.EncodingHandler(
            initial_threshold=MASTER_THRESHOLD, backend="host"))
    acc = shared.accumulator
    lost, kinds = [0.0], []
    real_store = acc.store_update

    def checked(worker_id, flat_grad):
        h = acc.handlers[worker_id]
        raw = flat_grad.detach().float().cpu().numpy().reshape(-1)
        if h.residual is not None:
            raw = raw + np.asarray(h.residual, np.float32)
        msg = real_store(worker_id, flat_grad)
        back = acc_mod.decode(msg).numpy() + np.asarray(h.residual)
        # one f32 rounding of (raw - sent) + sent
        tol = 2.0 ** -22 * max(float(np.abs(raw).max()), msg["threshold"])
        lost[0] = max(lost[0], float(np.abs(back - raw).max()) / tol)
        kinds.append(msg["kind"])
        return msg

    acc.store_update = checked
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    shared.fit(net_s, batches)
    torch.cuda.synchronize()
    shared_s = time.perf_counter() - t1
    shared_launches = dict(fa.launches)
    shared_loss = float(net_s.get_score())
    n_params = net_s.num_params()
    finite = all(bool(torch.isfinite(p).all())
                 for p in net_s.params.parameters())
    per_msg = acc.bytes_sent / max(acc.messages_sent, 1)
    expected = {k: LAYERS * MASTER_BATCHES for k in ("fwd", "bwd_dq",
                                                    "bwd_dkv")}
    print(json.dumps({
        "phase": "masters_lm", "workers": MASTER_WORKERS,
        "batches": MASTER_BATCHES,
        "averaging": {"frequency": MASTER_FREQ, "rounds": rounds,
                      "max_abs_diff_vs_mean_by_hand": by_hand,
                      "max_abs_diff_installed": installed,
                      "final_loss": avg_loss, "seconds": round(avg_s, 3),
                      "kernel_launches": avg_launches},
        "shared": {"threshold": MASTER_THRESHOLD, "codec": "host",
                   "gpp_codec_used": native.available(),
                   "messages": acc.messages_sent, "kinds": kinds,
                   "encoded_bytes_per_message": per_msg,
                   "dense_bytes_per_message": 4 * n_params,
                   "compression": 4 * n_params / per_msg if per_msg
                   else None,
                   "worst_loss_over_one_rounding": lost[0],
                   "final_loss": shared_loss, "seconds": round(shared_s, 3),
                   "kernel_launches": shared_launches},
        "expected_launches": expected,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if rounds != MASTER_BATCHES // (MASTER_WORKERS * MASTER_FREQ) or \
            by_hand != 0.0 or installed != 0.0:
        return None, (f"averaging: {rounds} rounds, {by_hand} off the mean "
                      f"by hand, installed params off by {installed}")
    if not (math.isfinite(avg_loss) and math.isfinite(shared_loss)
            and finite):
        return None, f"masters' losses {avg_loss}, {shared_loss} not finite"
    if acc.messages_sent != MASTER_BATCHES or lost[0] > 1.0:
        return None, (f"shared gradients: {acc.messages_sent} messages, "
                      f"sent + residual off the raw update by "
                      f"{lost[0]} roundings")
    if avg_launches != expected or shared_launches != expected:
        return None, (f"masters launched {avg_launches} and "
                      f"{shared_launches}; expected {expected}")
    return {k: avg_launches[k] + shared_launches[k] for k in expected}, None


def training_across_ranks_phases(args, torch, dev, card):
    """Phases 38-42 on a one-rank process group (NCCL on the card), which
    is taken down at the end.  Returns ``(launches by path, None)`` or
    ``(None, what failed)``."""
    import torch.distributed as dist
    world_of_one(dev)
    out = {}
    try:
        for key, phase in (("parallel", parallel_lm_phase),
                           ("sharded", sharded_checkpoint_phase),
                           ("elastic", elastic_lm_phase),
                           ("sparse", sparse_embedding_phase),
                           ("masters", masters_phase)):
            out[key], err = phase(args, torch, dev, card)
            if err:
                return None, err
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out, None




# ---- 43-44. the model axes ----------------------------------------------
# The Switch-MoE LM: the full-width TransformerLM with every block's MLP
# a top-1 routed stack of 8 experts (capacity factor 1.25: 1280 slots an
# expert for 16 x 512 tokens).
MOE_EXPERTS, MOE_CAPACITY_FACTOR = 8, 1.25
MOE_STEPS = 5
MOE_TIMED_STEPS = 6
# MoE LM losses, flash path against its reference-attention twin on the
# same card.  The attention outputs differ by f32 summation order
# (~1e-6); a router near a tie could then send a token to another expert
# on one side (a routing flip, counted and printed), which would move
# that token's output by O(1).  Set from the first card run (PERF.md;
# H100 80GB HBM3 at 700 W): no flip in any of the 8 layers at
# this seed, and the largest relative loss gap of the 5 steps 1.04e-7:
# the dense LM's 1e-5 (TOL_TRAIN_LOSS) holds it 100 times over.
TOL_MOE_LOSS = 1e-5
# the aux term in the loss: the step's loss against a twin with aux
# weight 0 (the same forward and routing) differs by the blocks' aux
# terms, within f32 rounding of the ~9-nat loss
TOL_MOE_AUX = 1e-5


def _moe_routes(fn):
    """Wrap ``expert._dispatch_tensors`` so each call appends the argmax
    expert of every token (a host copy) to ``fn.routes``."""
    def wrapped(probs, capacity):
        wrapped.routes.append(probs.argmax(-1).cpu())
        return fn(probs, capacity)
    wrapped.routes = []
    return wrapped


def einsum_ms(torch, dev, tokens, experts, capacity, embed):
    """Forward + backward time of one MoE layer's dispatch and combine
    einsums (``tec,td->ecd`` and ``tec,ecd->td``) at these shapes, f32,
    timed alone on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    disp = (torch.rand((tokens, experts, capacity), generator=gen,
                       device=dev) < 1.0 / capacity).float()
    x = torch.randn((tokens, embed), generator=gen, device=dev,
                    requires_grad=True)
    out = torch.randn((experts, capacity, embed), generator=gen, device=dev,
                      requires_grad=True)
    comb = disp.clone().requires_grad_(True)
    g_in = torch.randn((experts, capacity, embed), generator=gen, device=dev)
    g_out = torch.randn((tokens, embed), generator=gen, device=dev)

    def step():
        a = torch.einsum("tec,td->ecd", disp, x)
        b = torch.einsum("tec,ecd->td", comb, out)
        torch.autograd.backward((a, b), (g_in, g_out))
    return median_ms(step, torch, runs=10)


def moe_lm_phase(args, torch, dev, card):
    """Phase 43.  Returns ``({"train": launches, "serve": launches},
    None)`` or ``(None, what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.layers.moe import moe_capacity
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import expert
    from deeplearning4j_tpu_torch.serving.engine import (ServingEngine,
                                                         _pad_rows_np)
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        params_from_jax
    t_phase = time.perf_counter()

    def make(impl="auto", aux_weight=None):
        conf = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                             n_layers=LAYERS, n_heads=HEADS,
                             moe_experts=MOE_EXPERTS, attn_impl=impl,
                             sparse_labels=True, seed=args.seed).conf()
        for lc in conf.layers:
            if getattr(lc, "moe_experts", 0):
                lc.moe_capacity_factor = MOE_CAPACITY_FACTOR
                if aux_weight is not None:
                    lc.aux_loss_weight = aux_weight
        return MultiLayerNetwork(conf, device=dev)

    tree = seeded_params(make().param_spec(), args.seed + 43)
    batches = _lm_batches(args, 43, MOE_STEPS)
    net = params_from_jax(make(), tree)
    n_params = net.num_params()
    blocks = [f"layer_{i}" for i, lc in enumerate(net.conf.layers)
              if getattr(lc, "AUX_LOSS", False)]
    # routing of step 0's batch, flash path against reference attention
    orig = expert._dispatch_tensors
    twin = params_from_jax(make("reference"), tree)
    routes = {}
    for name, m in (("flash", net), ("reference", twin)):
        expert._dispatch_tensors = _moe_routes(orig)
        try:
            m.output(batches[0][0])
            routes[name] = expert._dispatch_tensors.routes
        finally:
            expert._dispatch_tensors = orig
    flips = [int((a != b).sum()) for a, b in zip(routes["flash"],
                                                 routes["reference"])]
    tokens = TRAIN_BATCH * SEQ
    capacity = moe_capacity(MOE_CAPACITY_FACTOR, tokens, MOE_EXPERTS)
    # training: the flash net's 5 steps, launches per step, peak bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, launches, aux = [], [], []
    for x, y in batches:
        fa.reset_launches()
        net.fit(x, y)
        losses.append(float(net.get_score()))
        launches.append(dict(fa.launches))
        aux.append(sum(float(net.state[k]["aux_loss"]) for k in blocks))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    twin_losses = []
    for x, y in batches:
        twin.fit(x, y)
        twin_losses.append(float(twin.get_score()))
    del twin
    torch.cuda.empty_cache()
    # the aux term is in the objective: step 0 against an aux-weight-0
    # twin (the same forward and routing)
    no_aux = params_from_jax(make(aux_weight=0.0), tree)
    no_aux.fit(*batches[0])
    aux_gap = abs((losses[0] - float(no_aux.get_score())) - aux[0])
    del no_aux
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, twin_losses))
    # step time, device busy share, the dispatch/combine einsums' share
    step_ms = _timed_steps(torch, net, batches, MOE_TIMED_STEPS)
    split = profile_steps(torch, net, batches[:PROFILED_STEPS],
                          LM_KERNEL_CLASSES)
    busy = split["device_ms_total_per_step"] / step_ms \
        if split["device_ms_total_per_step"] else None
    ein = einsum_ms(torch, dev, tokens, MOE_EXPERTS, capacity, EMBED)
    # serving: 1-, 5- and 16-row requests, each its own batch; each
    # served row equals the model's output on the (padded) batch it was
    # served in
    rng = np.random.default_rng(args.seed + 43)
    eye = np.eye(VOCAB, dtype=np.float32)
    engine = ServingEngine(net, device=dev, max_batch_size=MAX_BATCH)
    serve = []
    try:
        engine.warmup()
        for n in REQUEST_SIZES:
            x = eye[rng.integers(0, VOCAB, (n, SEQ))]
            torch.cuda.synchronize()
            fa.reset_launches()
            b0 = engine.batches_dispatched
            t1 = time.perf_counter()
            y = engine.predict(x)
            ms = (time.perf_counter() - t1) * 1e3
            got = dict(fa.launches)
            n_batches = engine.batches_dispatched - b0
            bucket = next(b for b in engine.buckets if n <= b)
            want = net.output(_pad_rows_np(x, bucket)).cpu().numpy()[:n]
            serve.append({"rows": n, "bucket": bucket, "batches": n_batches,
                          "launches": got, "ms": ms,
                          "max_abs_diff": float(np.abs(y - want).max()),
                          "finite": bool(np.isfinite(y).all())})
    finally:
        engine.shutdown()
    expected = {k: LAYERS for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "moe_lm", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "experts": MOE_EXPERTS,
            "capacity_factor": MOE_CAPACITY_FACTOR, "capacity": capacity,
            "batch": TRAIN_BATCH, "updater": "Adam(3e-4)",
            "dtype": "float32", "num_params": n_params},
        "steps": MOE_STEPS, "losses": losses, "twin_losses": twin_losses,
        "max_rel_loss_diff_vs_twin": rel, "tol": TOL_MOE_LOSS,
        "routing_flips_per_layer": flips, "tokens": tokens,
        "aux_per_step": aux, "aux_gap_step0": aux_gap,
        "tol_aux": TOL_MOE_AUX * abs(losses[0]),
        "kernel_launches_per_step": launches,
        "expected_launches_per_step": expected,
        "step_ms_median": step_ms, "device_busy_share": busy,
        "profile": split, "peak_allocated_bytes": peak,
        "einsum_ms_per_layer": ein,
        "einsum_ms_per_step": ein * LAYERS,
        "einsum_share": ein * LAYERS / step_ms,
        "serve": serve, "tol_serve": TOL_SERVE,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if not all(math.isfinite(v) for v in losses + twin_losses):
        return None, f"MoE LM losses not finite: {losses} {twin_losses}"
    if rel > TOL_MOE_LOSS:
        return None, (f"MoE LM losses {losses} differ from the reference "
                      f"twin's {twin_losses} by {rel} > {TOL_MOE_LOSS}")
    if not all(a > 0 for a in aux) or \
            aux_gap > TOL_MOE_AUX * abs(losses[0]):
        return None, (f"the aux term is not in the MoE LM's loss: aux "
                      f"{aux}, gap {aux_gap}")
    if any(lc != expected for lc in launches):
        return None, (f"MoE LM launched {launches}; expected {expected} "
                      "per step")
    for r in serve:
        if r["batches"] != 1 or r["launches"]["fwd"] != LAYERS or \
                r["launches"]["bwd_dq"] or r["launches"]["bwd_dkv"]:
            return None, f"MoE serving launched {r}"
        if not r["finite"] or r["max_abs_diff"] > TOL_SERVE:
            return None, f"MoE served rows differ from the batch's: {r}"
    return {"train": {k: sum(lc[k] for lc in launches) for k in expected},
            "serve": {k: sum(r["launches"][k] for r in serve)
                      for k in expected}}, None



SOLO_MLP_BATCH = 64
# ring attention at n = 1 against sdpa_reference: one online-softmax
# block against one softmax, f32 on the card, the same products:
# ~1e-6 of |O| <= ~4
TOL_SOLO_RING = 1e-5


def model_axes_solo_phase(args, torch, dev, card):
    """Phase 44, on a one-rank NCCL group: every model-axis entry point
    at one rank against the computation without it.  Returns ``(flash
    launches of the tensor-parallel LM run, None)`` or ``(None, what
    failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                                OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.attention import sdpa_reference
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   make_grid, make_mesh,
                                                   megatron_dense_rule)
    from deeplearning4j_tpu_torch.parallel.expert import (init_moe_params,
                                                          moe_ffn)
    from deeplearning4j_tpu_torch.parallel.pipeline import gpipe
    from deeplearning4j_tpu_torch.parallel.sequence import (
        ring_self_attention, ulysses_attention)
    from deeplearning4j_tpu_torch.utils import _random
    t_phase = time.perf_counter()
    out = {}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 44)
    # ring and Ulysses over a seq axis of one rank, at the LM's shape
    seq = make_grid(("seq",), (1,), device=dev)
    q, k, v = (torch.randn((TRAIN_BATCH, HEADS, SEQ, HEAD_DIM),
                           generator=gen, device=dev) for _ in range(3))
    want = sdpa_reference(q, k, v, causal=True)
    with seq:
        ring = ring_self_attention(q, k, v, axis_name="seq", causal=True)
        uly = ulysses_attention(q, k, v, axis_name="seq", causal=True)
        fa.reset_launches()
        uly_flash = ulysses_attention(q, k, v, axis_name="seq", causal=True,
                                      attn_fn=fa.flash_attention)
        uly_launches = dict(fa.launches)
    flash = fa.flash_attention(q, k, v, causal=True)
    out["ring_max_abs_err"] = (ring - want).abs().max().item()
    out["ulysses_bitwise"] = torch.equal(uly, want)
    out["ulysses_flash_bitwise"] = torch.equal(uly_flash, flash)
    out["ulysses_flash_launches"] = uly_launches
    # gpipe with one stage against the stage
    pipe = make_grid(("pipe",), (1,), device=dev)
    w = torch.randn((1, EMBED, EMBED), generator=gen, device=dev) * 0.05
    b = torch.randn((1, EMBED), generator=gen, device=dev) * 0.05
    xs = torch.randn((4, 8, EMBED), generator=gen, device=dev)

    def stage(p, x):
        return torch.tanh(x @ p["W"] + p["b"])

    local = {"W": w.clone().requires_grad_(True),
             "b": b.clone().requires_grad_(True)}
    with pipe:
        ys = gpipe(stage, local, xs, axis_name="pipe")
        g_pipe = torch.autograd.grad((ys ** 2).sum(), [local["W"],
                                                       local["b"]])
    plain = {"W": w[0].clone().requires_grad_(True),
             "b": b[0].clone().requires_grad_(True)}
    ys_plain = torch.stack([stage(plain, x) for x in xs])
    g_plain = torch.autograd.grad((ys_plain ** 2).sum(),
                                  [plain["W"], plain["b"]])
    out["gpipe_bitwise"] = torch.equal(ys, ys_plain) and all(
        torch.equal(a[0], c) for a, c in zip(g_pipe, g_plain))
    # moe_ffn over an expert axis of one rank against no axis
    ex = make_grid(("expert",), (1,), device=dev)
    mp = init_moe_params(_random.prng_key(args.seed), MOE_EXPERTS, EMBED,
                         4 * EMBED, device=dev)
    xt = torch.randn((TRAIN_BATCH * SEQ, EMBED), generator=gen, device=dev)
    cap = int(MOE_CAPACITY_FACTOR * xt.shape[0] / MOE_EXPERTS)
    with ex:
        y_ep, aux_ep = moe_ffn(mp, xt, cap, expert_axis="expert")
    y_one, aux_one = moe_ffn(mp, xt, cap)
    out["moe_bitwise"] = torch.equal(y_ep, y_one) and \
        torch.equal(aux_ep, aux_one)
    del q, k, v, want, ring, uly, uly_flash, flash, xt, y_ep, y_one
    torch.cuda.empty_cache()
    # ParallelWrapper(param_rule=megatron_dense_rule) at tp 1 against
    # plain fit: the dry run's MLP (a Megatron pair) and the full-width
    # LM (its embedding and output layers split, gathered in the step)
    mesh = make_mesh(tp=1, device=dev)
    mlp_conf = lambda: (NeuralNetConfiguration.builder()  # noqa: E731
                        .seed(args.seed).activation("relu")
                        .weight_init("xavier")
                        .updater(Adam(learning_rate=1e-3)).list()
                        .layer(DenseLayer(n_out=256))
                        .layer(DenseLayer(n_out=256))
                        .layer(OutputLayer(n_out=10, activation="softmax",
                                           loss="mcxent"))
                        .set_input_type(InputType.feed_forward(784))
                        .build())
    rng = np.random.default_rng(args.seed + 44)
    mlp_batches = [(rng.standard_normal((SOLO_MLP_BATCH, 784)).astype(
        np.float32), np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, SOLO_MLP_BATCH)]) for _ in range(PAR_STEPS)]
    lm_tree = _lm_tree(args, dev, 44)
    lm_batches = _lm_batches(args, 44, PAR_STEPS)
    runs = {}
    for model in ("mlp", "lm"):
        for name in ("plain", "tp"):
            net = MultiLayerNetwork(mlp_conf(), device=dev).init() \
                if model == "mlp" else _lm_net(args, dev, lm_tree)
            trainer = net if name == "plain" else ParallelWrapper(
                net, mesh, param_rule=megatron_dense_rule(net.params))
            batches = mlp_batches if model == "mlp" else lm_batches
            torch.cuda.synchronize()
            fa.reset_launches()
            losses, ms = _fit_timed(torch, trainer, net, batches)
            state = training_state(net) if name == "plain" else None
            if name == "tp":
                trainer.release()
                state = training_state(net)
                pairs = sorted(f"{k}/{n}" for k, n in trainer.exchange.local)
            runs[(model, name)] = {
                "losses": losses, "launches": dict(fa.launches),
                "step_ms_median": statistics.median(ms[1:]),
                "state": state}
            if name == "tp":
                runs[(model, name)]["pairs"] = pairs
            del net, trainer
            torch.cuda.empty_cache()
    diffs = {m: state_max_diff(runs[(m, "tp")]["state"],
                               runs[(m, "plain")]["state"])
             for m in ("mlp", "lm")}
    expected = {k: LAYERS * PAR_STEPS for k in ("fwd", "bwd_dq", "bwd_dkv")}
    print(json.dumps({
        "phase": "model_axes_solo", "world_size": 1, "backend": "nccl",
        **out, "tol_ring": TOL_SOLO_RING,
        "tp1_max_abs_diff_vs_plain": diffs, "gate": 0.0,
        "tp1_pairs": {m: runs[(m, "tp")]["pairs"] for m in ("mlp", "lm")},
        "losses": {f"{m}/{n}": r["losses"] for (m, n), r in runs.items()},
        "step_ms_median": {f"{m}/{n}": r["step_ms_median"]
                           for (m, n), r in runs.items()},
        "lm_kernel_launches": {n: runs[("lm", n)]["launches"]
                               for n in ("plain", "tp")},
        "expected_launches": expected,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if out["ring_max_abs_err"] > TOL_SOLO_RING:
        return None, f"ring attention at n = 1: {out['ring_max_abs_err']}"
    for key in ("ulysses_bitwise", "ulysses_flash_bitwise", "gpipe_bitwise",
                "moe_bitwise"):
        if not out[key]:
            return None, f"model axes at one rank: {key} is False"
    if uly_launches != {"fwd": 1, "bwd_dq": 0, "bwd_dkv": 0}:
        return None, f"Ulysses over flash launched {uly_launches}"
    if any(d != 0.0 for d in diffs.values()):
        return None, f"tensor parallelism at tp 1 differs from fit: {diffs}"
    for n in ("plain", "tp"):
        if runs[("lm", n)]["launches"] != expected:
            return None, (f"{n} LM launched {runs[('lm', n)]['launches']}; "
                          f"expected {expected}")
    if runs[("mlp", "tp")]["pairs"] != ["layer_0/W", "layer_0/b",
                                        "layer_1/W"]:
        return None, f"the MLP's Megatron pair: {runs[('mlp', 'tp')]}"
    return runs[("lm", "tp")]["launches"], None


def model_axes_phases(args, torch, dev, card):
    """Phases 43-44; 44 on a one-rank process group (NCCL on the card),
    taken down at the end.  Returns ``(launches by path, None)`` or
    ``(None, what failed)``."""
    import torch.distributed as dist
    out = {}
    out["moe"], err = moe_lm_phase(args, torch, dev, card)
    if err:
        return None, err
    torch.cuda.empty_cache()
    world_of_one(dev)
    try:
        out["tp"], err = model_axes_solo_phase(args, torch, dev, card)
        if err:
            return None, err
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out, None


# ------------------------------------------------- 45-48. Keras import
# The zoo models at their published widths, exported to Keras HDF5 by the
# port and imported back (modelimport/): VGG16 224x224x3 / 1000 (~553 MB
# of f32), ResNet50 224x224x3 / 1000, the char-LSTM of phases 10-12.
KERAS_VGG_KW: dict = {}
KERAS_RESNET_KW: dict = {}
KERAS_VGG_BATCH = 8
KERAS_FT_BATCH, KERAS_FT_STEPS = 64, 3
KERAS_FOLD_ROWS = 16
# Outputs of the imported VGG16 against its source net: the same params
# on the same card through the same kernels; 1e-5 abs at probabilities
# <= 1 leaves room for another convolution algorithm between the two.
TOL_KERAS_VGG = 1e-5
# The folded ResNet50 against the unfolded one in eval.  Three steps at
# the importer's momentum 0.99 leave the running statistics near their
# initial 0/1, so in eval this net (no ReLU after its BNs: what the
# export carries) is un-normalized (pooled features up to ~5e4) and its
# softmax near one-hot: a rounding of its large logits moves a
# probability by up to a quarter of it (the probabilities of folded and
# unfolded nets 1.7e-5 to 3.4e-4 apart in four runs on an H100 80GB HBM3
# at 700 W), and a saturated softmax hides a wrong fold.  So the gate
# holds the net's outputs before the softmax, the logits, within 1e-4 of
# their largest |value| (the fold
# sums W·scale products where the unfolded net scales sums, through 53
# convolutions: relative rounding, ~1e-6, not amplified there), and the
# pooled features the output layer reads likewise; the probabilities
# within what the logits' difference allows, |Δp| <= |Δz|/2 (the
# softmax's Lipschitz bound in the max norm) plus 1e-6 for its own
# rounding.  A wrong fold (a scale or shift off on one layer) moves the
# logits by O(1).
TOL_KERAS_FOLD, TOL_SOFTMAX_ROUND = 1e-4, 1e-6
# Every activation name on a [4096, 1024] card tensor that holds the
# kinks: card vs the CPU, values and gradients (of sum(f(x)·w), w from
# the seed).  libdevice's and the CPU's transcendental functions each
# round within a few ulps, and softmax/logsoftmax sum their rows in
# another order: 8 ulps (2^-20) of each tensor's largest |value|.
ACT_SHAPE = (4096, 1024)
ACT_KINKS = (0.0, 1.0, -1.0, 2.5, -2.5, 6.0, 0.5)
ACT_PARAMETERIZED = ("leakyrelu:0.3", "lrelu:0.2", "elu:0.7",
                     "thresholdedrelu:0.5")
TOL_ACT_REL = 2.0 ** -20
# (name, kink, its gradient): ties of minimum/maximum split 0.5/0.5 as
# JAX's differentiation does; hardsigmoid's is 0.5 x its slope 0.2
ACT_TIES = (("hardtanh", 1.0, 0.5), ("hardtanh", -1.0, 0.5),
            ("relu6", 6.0, 0.5), ("hardsigmoid", 2.5, (0.5, 0.2)),
            ("hardsigmoid", -2.5, (0.5, 0.2)))


def _keras_file(data: bytes, name: str):
    """``data`` written to a fresh temporary directory; returns (the
    directory, the file's path).  The caller removes the directory."""
    import tempfile
    d = Path(tempfile.mkdtemp(prefix="keras_smoke_"))
    path = d / name
    path.write_bytes(data)
    return d, path


def keras_vgg16_phase(args, torch, dev, card):
    """Phase 45.  Returns None, or what failed."""
    import shutil
    import numpy as np
    from deeplearning4j_tpu_torch.modelimport import (TrainedModels,
                                                      export_keras_sequential)
    from deeplearning4j_tpu_torch.models.zoo import VGG16

    src = VGG16(seed=args.seed, **KERAS_VGG_KW).init(device=dev)
    t0 = time.perf_counter()
    data = export_keras_sequential(src)
    export_s = time.perf_counter() - t0
    tmp, path = _keras_file(data, "vgg16.h5")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net = VGG16(seed=args.seed + 1, **KERAS_VGG_KW).pretrained(
            str(path), device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    it = net.conf.input_type
    rng = np.random.default_rng(args.seed + 45)
    images = rng.integers(0, 256, (KERAS_VGG_BATCH, it.height, it.width,
                                   it.channels)).astype(np.uint8)
    helper = TrainedModels.VGG16
    x = torch.as_tensor(helper.preprocess(images), device=dev)
    want, got = src.output(x), net.output(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    fwd_ms = median_ms(lambda: net.output(x), torch, runs=10)
    top_src = helper.predict_and_decode(src, images, top=5)
    top_net = helper.predict_and_decode(net, images, top=5)
    # a class may trade places with another only where the source's
    # probabilities of the two are within twice the measured error
    p = want.cpu().numpy()
    index = {helper.labels.get_label(i): i for i in range(p.shape[1])}
    swaps = sum(
        1 for row, (a, b) in enumerate(zip(top_src, top_net))
        for (la, _), (lb, _) in zip(a, b)
        if la != lb and abs(p[row, index[la]] - p[row, index[lb]]) > 2 * err)
    print(json.dumps({
        "phase": "keras_vgg16", "model": {
            "name": "VGG16", "input": [it.height, it.width, it.channels],
            "classes": int(want.shape[-1]), "dtype": "float32",
            "num_params": net.num_params()},
        "file_bytes": len(data), "export_s": export_s, "import_s": import_s,
        "batch": KERAS_VGG_BATCH, "max_abs_err_vs_source": err,
        "tol": TOL_KERAS_VGG, "forward_ms_median": fwd_ms,
        "top5_equal": top_src == top_net, "top5_swaps_outside_ties": swaps,
        "card": card}), flush=True)
    if not finite or tuple(got.shape) != tuple(want.shape) or \
            err > TOL_KERAS_VGG:
        return (f"imported VGG16 differs from its source by {err} "
                f"(shape {tuple(got.shape)}, finite {finite})")
    if swaps:
        return f"imported VGG16's top-5 differs from its source's ({swaps})"
    return None


def keras_resnet50_phase(args, torch, dev, card):
    """Phase 46.  Returns ``(bn_apply launches per step, None)`` or
    ``(None, what failed)``."""
    import copy
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.modelimport import (export_keras_model,
                                                      import_keras_model)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.fold import fold_batch_norms
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb

    zoo = ResNet50(seed=args.seed, **KERAS_RESNET_KW)
    src = zoo.init(device=dev)
    t0 = time.perf_counter()
    data = export_keras_model(src)
    export_s = time.perf_counter() - t0
    del src
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = import_keras_model(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    bns = [v.layer for v in net.conf.vertices.values()
           if type(getattr(v, "layer", None)).__name__
           == "BatchNormalization"]
    twin_conf = copy.deepcopy(net.conf)
    for lc in bns:
        lc.helper = "pallas"
    twin = ComputationGraph(twin_conf, device=dev)
    twin.load_params({k: {n: p.detach().cpu().numpy() for n, p in g.items()}
                      for k, g in net.params.items()})
    twin.load_state({k: {n: t.cpu().numpy() for n, t in g.items()}
                     for k, g in net.state.items()})
    if [n for n, _ in net.named_parameters()] != \
            [n for n, _ in twin.named_parameters()]:
        return None, "the twin's parameters are not the imported net's"
    updater = type(net.conf.defaults["updater"]).__name__
    h, w, c = zoo.input_shape
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 46)
    xs = [torch.randn((KERAS_FT_BATCH, h, w, c), generator=dgen, device=dev)
          for _ in range(KERAS_FT_STEPS)]
    ys = [F.one_hot(torch.randint(0, zoo.num_classes, (KERAS_FT_BATCH,),
                                  generator=dgen, device=dev),
                    zoo.num_classes).float() for _ in range(KERAS_FT_STEPS)]
    check, err = bn_twin_grad_check(torch, net, twin, xs[0], ys[0])
    if err:
        return None, f"imported ResNet50: {err}"

    snaps, step_losses, step_ms = [], [], []
    torch.cuda.synchronize()
    pb.reset_launches()
    for x, y in zip(xs, ys):
        snaps.append([p.detach().clone() for p in net.parameters()])
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_losses.append(net._score)
    launches = pb.launches["bn_apply"]
    losses = [float(v) for v in step_losses]
    pb.reset_launches()
    twin_losses, twin_ms = [], []
    for snap, x, y in zip(snaps, xs, ys):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        t0 = time.perf_counter()
        twin.fit(x, y)
        torch.cuda.synchronize()
        twin_ms.append((time.perf_counter() - t0) * 1e3)
        twin_losses.append(twin.get_score())
    twin_launches = pb.launches["bn_apply"]
    del snaps
    loss0 = check["loss0"]
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))

    folded = fold_batch_norms(net)
    xe = xs[0][:KERAS_FOLD_ROWS]
    ref, got = net.output(xe), folded.output(xe)
    out = net.conf.network_outputs[0]
    feat = net.conf.vertex_inputs[out][0]

    def logits(m, f):
        """The output layer's pre-activation on its input ``f``."""
        v = m.conf.vertices[out]
        with torch.no_grad():
            return v.layer.pre_output(dict(m.params[out].items()),
                                      v._pre(f, None)[0])

    fa, fb = net.feed_forward(xe)[feat], folded.feed_forward(xe)[feat]
    za, zb = logits(net, fa), logits(folded, fb)
    feat_err = ((fb - fa).abs().max() / fa.abs().max()).item()
    logit_diff = (zb - za).abs().max().item()
    logit_err = logit_diff / za.abs().max().item()
    prob_diff = (got - ref).abs().max().item()
    prob_tol = 0.5 * logit_diff + TOL_SOFTMAX_ROUND
    left = sum(type(getattr(v, "layer", None)).__name__
               == "BatchNormalization" for v in folded.conf.vertices.values())
    # the BN layers whose geometry the kernel door takes at this batch:
    # all 53 at the published width (checked below)
    geoms = bn_geometries(net.conf, KERAS_FT_BATCH)
    kernel_bns = sum(n for (m, ch, a), n in geoms.items()
                     if pb.supports(activation=a, shape=(m, ch)))
    expected = kernel_bns * KERAS_FT_STEPS
    check["rel"].sort(reverse=True)
    print(json.dumps({
        "phase": "keras_resnet50_finetune", "model": {
            "name": "ResNet50 (Keras import)", "input": [h, w, c],
            "classes": zoo.num_classes, "batch": KERAS_FT_BATCH,
            "dtype": "float32", "tf32": False, "updater": updater,
            "bn_layers": len(bns), "bn_layers_on_the_kernel": kernel_bns,
            "bn_helper": "pallas",
            "num_params": net.num_params()},
        "file_bytes": len(data), "export_s": export_s, "import_s": import_s,
        "steps": KERAS_FT_STEPS, "step0_loss": loss0, "losses": losses,
        "twin_losses": twin_losses, "max_rel_loss_diff": loss_diff,
        "tol_loss": CNN_TOL_LOSS,
        "step0_grad_worst_err_over_tol": check["worst_ratio"],
        "step0_grad_worst_param": check["worst_name"],
        "step0_grad_err_over_reordered_noise_worst": check["rel"][:5],
        "step0_grad_rel_l2": check["grad_rel_l2"],
        "step_ms": step_ms, "twin_step_ms": twin_ms,
        "kernel_launches": launches,
        "expected_launches": expected, "twin_bn_launches": twin_launches,
        "fold": {"rows": KERAS_FOLD_ROWS, "logits_max_rel_err": logit_err,
                 "logits_max_abs": za.abs().max().item(),
                 "features": feat, "features_max_rel_err": feat_err,
                 "features_max_abs": fa.abs().max().item(),
                 "tol": TOL_KERAS_FOLD, "probs_max_abs_diff": prob_diff,
                 "probs_tol": prob_tol, "max_prob": ref.max().item(),
                 "bn_left": left},
        "card": card}), flush=True)
    if updater != "Sgd":
        return None, f"the importer set {updater}, not Sgd"
    if (len(bns), kernel_bns) != (53, 53) and not KERAS_RESNET_KW:
        return None, (f"imported ResNet50 has {len(bns)} BN layers, "
                      f"{kernel_bns} of them on the kernel; expected 53")
    if launches != expected or twin_launches:
        return None, (f"bn_apply launched {launches} times in "
                      f"{KERAS_FT_STEPS} steps (expected {expected}) and "
                      f"{twin_launches} in the twin's")
    if not all(math.isfinite(v) for v in losses) or \
            loss_diff > CNN_TOL_LOSS:
        return None, (f"imported ResNet50 losses {losses} differ from the "
                      f"twin's {twin_losses} by {loss_diff}")
    if max(logit_err, feat_err) > TOL_KERAS_FOLD or prob_diff > prob_tol \
            or left:
        return None, (f"folded ResNet50 differs from the unfolded net by "
                      f"{logit_err} of the largest logit and {feat_err} of "
                      f"the largest {feat} feature (tol {TOL_KERAS_FOLD}), "
                      f"probabilities by {prob_diff} (tol {prob_tol}); "
                      f"{left} BN layers left")
    return launches // KERAS_FT_STEPS, None


def keras_char_lstm_phase(args, torch, dev, card):
    """Phase 47.  Returns ``({"sigmoid": launches per output,
    "hard_sigmoid": ...}, None)`` or ``(None, what failed)``."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.modelimport import (
        export_keras_sequential, import_keras_sequential_model)
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl

    zoo = TextGenerationLSTM(num_classes=LSTM_CLASSES, timesteps=LSTM_T,
                             hidden=LSTM_HIDDEN, seed=args.seed)
    src = zoo.init(device=dev)
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 47)
    x = F.one_hot(torch.randint(0, LSTM_CLASSES, (LSTM_BATCH, LSTM_T),
                                generator=dgen, device=dev),
                  LSTM_CLASSES).float()
    out, records = {}, []
    for gate, keras_gate in (("sigmoid", "sigmoid"),
                             ("hardsigmoid", "hard_sigmoid")):
        conf = zoo.conf()
        for lc in conf.layers:
            if isinstance(lc, LSTM):
                lc.gate_activation = gate
        source = MultiLayerNetwork(conf, device=dev).load_params({
            k: {n: p.detach().cpu().numpy() for n, p in g.items()}
            for k, g in src.params.items()})
        t0 = time.perf_counter()
        data = export_keras_sequential(source)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nets = {helper: import_keras_sequential_model(data, device=dev)
                for helper in ("pallas", None)}
        import_s = (time.perf_counter() - t0) / 2
        lstms = [lc for lc in nets["pallas"].conf.layers
                 if isinstance(lc, LSTM)]
        for lc in lstms:
            lc.helper = "pallas"
        gates = sorted({lc.gate_activation for lc in lstms})
        torch.cuda.synchronize()
        pl.reset_launches()
        probs = nets["pallas"].output(x)
        torch.cuda.synchronize()
        launches = pl.launches["lstm_fwd"]
        want = nets[None].output(x)
        err = (probs - want).abs().max().item()
        src_err = (want - source.output(x)).abs().max().item()
        # the first LSTM's sequence against its twin's, within the
        # recurrence's error bound from these inputs
        p0 = {n: t.detach() for n, t in nets[None].params["layer_0"].items()}
        zeros = torch.zeros((LSTM_BATCH, LSTM_HIDDEN), device=dev)
        y0 = nets["pallas"].feed_forward(x)[0]
        y0_twin = nets[None].feed_forward(x)[0]
        y0_err = (y0 - y0_twin).abs().max().item()
        bound = lstm_error_bound(torch, x, p0["W"], p0["U"], p0["b"], zeros,
                                 zeros.clone())
        fwd_ms = median_ms(lambda: nets["pallas"].output(x), torch, runs=10)
        expected = 2 if gate == "sigmoid" else 0
        rec = {"gate": keras_gate, "imported_gate_activation": gates,
               "file_bytes": len(data), "export_s": export_s,
               "import_s": import_s, "kernel_launches": launches,
               "expected_launches": expected,
               "max_abs_err_vs_twin": err, "tol": TOL_LSTM_OUT,
               "layer0_max_abs_err_vs_twin": y0_err,
               "layer0_tol_lstm_error_bound": bound,
               "twin_max_abs_err_vs_source": src_err,
               "output_ms_median": fwd_ms}
        records.append(rec)
        out[keras_gate] = launches
        if gates != [gate]:
            return None, f"imported LSTM gates {gates}, exported {gate}"
        if launches != expected:
            return None, (f"imported {keras_gate} char-LSTM launched "
                          f"lstm_fwd {launches} times for one output; "
                          f"expected {expected}")
        if tuple(probs.shape) != (LSTM_BATCH, LSTM_T, LSTM_CLASSES) or \
                not bool(torch.isfinite(probs).all()):
            return None, f"imported char-LSTM output {tuple(probs.shape)}"
        if err > TOL_LSTM_OUT or y0_err > bound or src_err > TOL_LSTM_OUT:
            return None, (f"imported {keras_gate} char-LSTM: output vs twin "
                          f"{err} (tol {TOL_LSTM_OUT}), first layer {y0_err} "
                          f"(bound {bound}), twin vs source {src_err}")
        del nets, probs, want, source
    print(json.dumps({"phase": "keras_char_lstm", "model": {
        "name": "TextGenerationLSTM (Keras import)",
        "classes": LSTM_CLASSES, "hidden": LSTM_HIDDEN, "batch": LSTM_BATCH,
        "t": LSTM_T, "dtype": "float32", "helper": "pallas"},
        "runs": records, "card": card}), flush=True)
    return out, None


def activations_phase(args, torch, dev, card):
    """Phase 48.  Returns None, or what failed."""
    from deeplearning4j_tpu_torch.nn import activations as act

    gen = torch.Generator().manual_seed(args.seed + 48)
    x = torch.randn(ACT_SHAPE, generator=gen) * 3
    flat = x.view(-1)
    n_kinks = 64       # every kink at 64 places spread over the tensor
    stride = flat.numel() // (len(ACT_KINKS) * n_kinks)
    for i, k in enumerate(ACT_KINKS):
        flat[i * n_kinks * stride:(i + 1) * n_kinks * stride:stride] = k
    w = torch.randn(ACT_SHAPE, generator=gen)
    xd, wd = x.to(dev), w.to(dev)
    worst, rows = {}, []
    t0 = time.perf_counter()
    for name in act.names() + list(ACT_PARAMETERIZED):
        fn = act.get(name)
        res = []
        for xx, ww in ((xd, wd), (x, w)):
            a = xx.clone().requires_grad_(True)
            y = fn(a)
            (y * ww).sum().backward()
            res.append((y.detach(), a.grad))
        torch.cuda.synchronize()
        errs = {}
        for what, g, c in (("value", res[0][0], res[1][0]),
                           ("grad", res[0][1], res[1][1])):
            if not bool(torch.isfinite(g).all()):
                return f"activation {name}: {what} not finite on the card"
            scale = c.abs().max().item()
            errs[what] = (g.cpu() - c).abs().max().item() / max(scale,
                                                                 1e-30)
        worst[name] = errs
        if max(errs.values()) > TOL_ACT_REL:
            rows.append(name)
    ties = []
    for name, x0, g0 in ACT_TIES:
        want = g0 if not isinstance(g0, tuple) else \
            (torch.tensor(g0[1], dtype=torch.float32) * g0[0]).item()
        a = torch.full((4,), x0, device=dev, requires_grad=True)
        act.get(name)(a).sum().backward()
        got = a.grad.cpu().tolist()
        ties.append({"name": name, "x": x0, "grad": got[0], "want": want})
        if any(v != want for v in got):
            rows.append(f"{name} tie at {x0}")
    seconds = time.perf_counter() - t0
    print(json.dumps({"phase": "activations_on_card",
                      "shape": list(ACT_SHAPE), "kinks": list(ACT_KINKS),
                      "names": len(worst), "rel_err": worst,
                      "tol_rel": TOL_ACT_REL, "ties": ties,
                      "seconds": seconds, "card": card}), flush=True)
    if rows:
        return f"activations disagree with the CPU or JAX's ties: {rows}"
    return None


def keras_import_phases(args, torch, dev, card):
    """Phases 45-48.  Returns ``({"bn": bn_apply launches per fine-tune
    step, "lstm": {gate: lstm_fwd launches per output}}, None)`` or
    ``(None, what failed)``."""
    t0 = time.perf_counter()
    err = keras_vgg16_phase(args, torch, dev, card)
    if err:
        return None, err
    print(json.dumps({"phase": "keras_vgg16_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    torch.cuda.empty_cache()
    out = {}
    for key, phase in (("bn", keras_resnet50_phase),
                       ("lstm", keras_char_lstm_phase)):
        t0 = time.perf_counter()
        out[key], err = phase(args, torch, dev, card)
        if err:
            return None, err
        print(json.dumps({"phase": f"{phase.__name__}_seconds",
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    err = activations_phase(args, torch, dev, card)
    if err:
        return None, err
    print(json.dumps({"phase": "activations_on_card_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return out, None


# ---- 49-50. the process masters over the TCP hub -----------------------
# MultiprocessMaster on the full-width LM: 2 worker processes on the one
# card, the hub a TcpMessageBroker in this process.  Averaging at
# frequency 2 over 8 batches (2 rounds a worker; params and Adam slots in
# a 403 MB frame: the respawn restarts from the frame, so a frame without
# the slots would restart Adam), then the same with worker 1 killed in
# round 1 before it publishes (the respawn restarts the round from the
# last averaged frame), then shared gradients with the host codec, then
# evaluate and score fanned out, the two jobs side by side.
MP_WORKERS, MP_FREQ, MP_BATCHES = 2, 2, 8
# evaluate: one-hot labels of 2 rows a batch (the LM's ids would be read
# as [b, t] probability rows); score: id batches of 16
MP_EVAL_BATCHES, MP_EVAL_ROWS, MP_SCORE_BATCHES = 2, 2, 4
# the respawned run against the fault-free one: the replacement redoes
# round 1 from the same averaged frame with the same kernels on the same
# card, so any gap is one of float noise: 1e-6 of each leaf's scale
TOL_MP_RETRY = 1e-6
# score fanned out (per-batch means times rows, summed on the master)
# against one score over the concatenated batches: f32 sums in another
# order
TOL_MP_SCORE = 1e-6
MP_TIMEOUT_S = 300.0
TCP_INTEROP_MESSAGES = 6
TCP_INTEROP_SIZE = 1 << 20


def _mp_frames(master_mp):
    """Record the frames the master decodes (the workers' up-frames) and
    encodes (the averaged frames), with the time each averaged frame
    left; returns ``(records, undo)``."""
    rec = {"up": [], "avg": [], "avg_at": [], "up_bytes": []}
    real_dec, real_enc = master_mp._decode_frame, master_mp._encode_frame

    def dec(data):
        wid, rnd, vec = real_dec(data)
        if wid >= 0:
            rec["up"].append((wid, rnd, vec))
            rec["up_bytes"].append(len(data))
        return wid, rnd, vec

    def enc(wid, rnd, vec):
        if wid < 0:
            rec["avg"].append((rnd, vec))
            rec["avg_at"].append(time.perf_counter())
        return real_enc(wid, rnd, vec)

    master_mp._decode_frame, master_mp._encode_frame = dec, enc

    def undo():
        master_mp._decode_frame, master_mp._encode_frame = real_dec, real_enc
    return rec, undo


def _hub_counter():
    """Count the frames and bytes the hub's topics fan out from this
    process (``LocalMessageBroker.publish``); returns ``(counts, undo)``."""
    from deeplearning4j_tpu_torch.streaming import broker as broker_mod
    counts = {"frames": 0, "bytes": 0}
    real = broker_mod.LocalMessageBroker.publish

    def publish(self, topic, payload):
        counts["frames"] += 1
        counts["bytes"] += len(payload)
        return real(self, topic, payload)

    broker_mod.LocalMessageBroker.publish = publish

    def undo():
        broker_mod.LocalMessageBroker.publish = real
    return counts, undo


def _worker_records(master, steps_key="steps"):
    out = []
    for r in master.last_results:
        w = int(r["wid"])
        first = r.get("first_step_at")
        out.append({"wid": w, "steps": r.get(steps_key),
                    "resumed": r.get("resumed"), "device": r.get("device"),
                    "kernel_launches": r.get("kernel_launches"),
                    "spawn_to_first_step_s": None if first is None else
                    first - master.spawn_times[w],
                    "peak_allocated_bytes": r.get("peak_allocated_bytes")})
    return out


def _launches_per_step_ok(records) -> bool:
    for r in records:
        want = LAYERS * int(r["steps"] or 0)
        if r["steps"] and r["kernel_launches"] != {
                "fwd": want, "bwd_dq": want, "bwd_dkv": want}:
            return False
    return True


def masters_mp_phase(args, torch, dev, card):
    """Phase 49.  Returns ``(flash launches summed over the fault-free
    averaging run's workers, None)`` or ``(None, what failed)``."""
    import shutil
    import tempfile
    import numpy as np
    from deeplearning4j_tpu_torch.parallel import master_mp
    from deeplearning4j_tpu_torch.parallel import remote as remote_mod
    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 49)
    batches = _lm_batches(args, 49, MP_BATCHES)
    workdir = tempfile.mkdtemp(prefix="mp_lm_", dir=str(REPO / "build"))
    out = {}
    try:
        # ---- averaging, fault-free and with worker 1 killed in round 1
        runs = {}
        for name, fault in (("clean", None),
                            ("retry", {"die_before_publish": {"1": 1}})):
            net = _lm_net(args, dev, tree)
            master = master_mp.MultiprocessMaster(
                num_workers=MP_WORKERS, mode="averaging",
                averaging_frequency=MP_FREQ, device=str(dev),
                timeout=MP_TIMEOUT_S, fault_injection=fault,
                workdir=workdir)
            rec, undo = _mp_frames(master_mp)
            hub, undo_hub = _hub_counter()
            t1 = time.perf_counter()
            try:
                master.fit(net, iter(batches))
            finally:
                undo()
                undo_hub()
            seconds = time.perf_counter() - t1
            vec, _ = master_mp._ravel(net, True)
            runs[name] = {"net": net, "master": master, "rec": rec,
                          "seconds": seconds, "hub": dict(hub), "start": t1,
                          "vec": vec,
                          "workers": _worker_records(master)}
        clean = runs["clean"]
        rec = clean["rec"]
        by_hand = 0.0
        rounds = sorted({rnd for _, rnd, _ in rec["up"]})
        for rnd, avg in rec["avg"]:
            ups = [v for _, r, v in sorted(rec["up"], key=lambda u: u[0])
                   if r == rnd]
            hand = (ups[0] + ups[1]) / np.float32(2)
            by_hand = max(by_hand, float(np.abs(avg - hand).max()))
        installed_bitwise = bool(np.array_equal(clean["vec"],
                                                rec["avg"][-1][1]))
        at = rec["avg_at"]
        # the first round's time includes the workers' start
        round_s = [b - a for a, b in zip([clean["start"]] + at[:-1], at)]
        worst_retry, retry_bitwise = 0.0, True
        for k, g in clean["net"].params.items():
            for n, p in g.items():
                a = p.detach()
                b = runs["retry"]["net"].params[k][n].detach()
                retry_bitwise &= bool(torch.equal(a, b))
                worst_retry = max(worst_retry, (a - b).abs().max().item()
                                  / (a.abs().max().item() or 1.0))
        retried = set(runs["retry"]["master"].retried_workers)
        avg_launches = {k: sum(r["kernel_launches"][k]
                               for r in clean["workers"])
                        for k in ("fwd", "bwd_dq", "bwd_dkv")}
        out["averaging"] = {
            "frequency": MP_FREQ, "rounds": len(rec["avg"]),
            "max_abs_diff_avg_vs_mean_by_hand": by_hand,
            "installed_equals_last_frame_bitwise": installed_bitwise,
            "frame_bytes": max(rec["up_bytes"]) if rec["up_bytes"] else 0,
            "round_seconds": round_s, "seconds": clean["seconds"],
            "hub_frames": clean["hub"]["frames"],
            "hub_bytes": clean["hub"]["bytes"],
            "hub_frames_per_s": clean["hub"]["frames"] / clean["seconds"],
            "workers": clean["workers"]}
        out["averaging_retry"] = {
            "fault": {"die_before_publish": {"1": 1}},
            "retried_workers": sorted(retried),
            "max_rel_diff_vs_fault_free": worst_retry,
            "bitwise_equal_fault_free": retry_bitwise,
            "tol": TOL_MP_RETRY, "seconds": runs["retry"]["seconds"],
            "workers": runs["retry"]["workers"]}
        del runs
        torch.cuda.empty_cache()
        # ---- shared gradients, host codec
        net = _lm_net(args, dev, tree)
        master = master_mp.MultiprocessMaster(
            num_workers=MP_WORKERS, mode="shared",
            threshold=MASTER_THRESHOLD, codec="host", device=str(dev),
            timeout=MP_TIMEOUT_S, workdir=workdir)
        msg_bytes = []
        real_decode = remote_mod.decode_message_bytes

        def decode(data):
            msg_bytes.append(len(data))
            return real_decode(data)
        remote_mod.decode_message_bytes = decode
        hub, undo_hub = _hub_counter()
        t1 = time.perf_counter()
        try:
            master.fit(net, iter(batches))
        finally:
            remote_mod.decode_message_bytes = real_decode
            undo_hub()
        seconds = time.perf_counter() - t1
        res = master.last_results
        counts_ok = all(
            r["applied_per_peer"] == {str(p["wid"]): p["messages_sent"]
                                      for p in res if p is not r}
            for r in res)
        shared_workers = _worker_records(master)
        out["shared"] = {
            "threshold": MASTER_THRESHOLD, "codec": "host",
            "messages_sent": [r["messages_sent"] for r in res],
            "messages_applied": [r["messages_applied"] for r in res],
            "applied_equals_declared": counts_ok,
            "table_spread": master.last_table_spread,
            "agreement_tol": master.agreement_tol,
            "message_bytes_mean": statistics.mean(msg_bytes)
            if msg_bytes else None,
            "dense_bytes_per_message": 4 * net.num_params(),
            "seconds": seconds, "hub_frames": hub["frames"],
            "hub_frames_per_s": hub["frames"] / seconds,
            "workers": shared_workers}
        shared_loss_finite = all(math.isfinite(r["score"]) for r in res)
        del net, master
        torch.cuda.empty_cache()
        # ---- evaluate and score fanned out, against the parent's
        net = _lm_net(args, dev, tree)
        rng = np.random.default_rng(args.seed + 490)
        eye = np.eye(VOCAB, dtype=np.float32)
        eval_batches = []
        for _ in range(MP_EVAL_BATCHES):
            toks = rng.integers(0, VOCAB, (MP_EVAL_ROWS, SEQ + 1))
            eval_batches.append((toks[:, :-1], eye[toks[:, 1:]]))
        score_batches = _lm_batches(args, 491, MP_SCORE_BATCHES)
        # an 8192-class Evaluation travels as JSON (its confusion matrix
        # as 67 M numbers a worker): the score job runs beside it
        masters = [master_mp.MultiprocessMaster(
            num_workers=MP_WORKERS, device=str(dev), timeout=MP_TIMEOUT_S,
            workdir=workdir) for _ in range(2)]

        def timed(fn, *a):
            t1 = time.perf_counter()
            return fn(*a), time.perf_counter() - t1
        with ThreadPoolExecutor(2) as pool:
            ev_job = pool.submit(timed, masters[0].evaluate, net,
                                 iter(eval_batches))
            sc_job = pool.submit(timed, masters[1].score, net,
                                 iter(score_batches))
            merged, eval_s = ev_job.result()
            got_score, score_s = sc_job.result()
        local = net.evaluate(iter(eval_batches))
        want_score = net.score(
            x=np.concatenate([b[0] for b in score_batches]),
            y=np.concatenate([b[1] for b in score_batches]))
        rel_score = abs(got_score - want_score) / abs(want_score)
        out["evaluate"] = {"accuracy": merged.accuracy(),
                           "parent_accuracy": local.accuracy(),
                           "examples": merged.confusion.total(),
                           "seconds": eval_s}
        out["score"] = {"score": got_score, "parent_score": want_score,
                        "rel_diff": rel_score, "tol": TOL_MP_SCORE,
                        "seconds": score_s}
        del net, masters
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({
        "phase": "masters_mp_lm", "workers": MP_WORKERS,
        "batches": MP_BATCHES, "device": str(dev),
        "model": {"vocab": VOCAB, "seq": SEQ, "embed": EMBED,
                  "layers": LAYERS, "heads": HEADS, "batch": TRAIN_BATCH,
                  "updater": "Adam(3e-4)", "dtype": "float32"},
        **out, "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    avg = out["averaging"]
    if avg["rounds"] != MP_BATCHES // (MP_WORKERS * MP_FREQ) or \
            avg["max_abs_diff_avg_vs_mean_by_hand"] != 0.0 or \
            not avg["installed_equals_last_frame_bitwise"]:
        return None, (f"process averaging: {avg['rounds']} rounds, "
                      f"{avg['max_abs_diff_avg_vs_mean_by_hand']} off the "
                      "mean by hand, installed params equal the last frame: "
                      f"{avg['installed_equals_last_frame_bitwise']}")
    if not _launches_per_step_ok(avg["workers"]) or \
            sum(r["steps"] for r in avg["workers"]) != MP_BATCHES:
        return None, (f"process averaging workers: {avg['workers']}; "
                      f"expected {LAYERS} launches of each kernel a step")
    retry = out["averaging_retry"]
    if retry["retried_workers"] != [1] or \
            retry["max_rel_diff_vs_fault_free"] > TOL_MP_RETRY:
        return None, f"process averaging with a fault: {retry}"
    sh = out["shared"]
    if not sh["applied_equals_declared"] or sh["table_spread"] is None or \
            sh["table_spread"] > sh["agreement_tol"] or \
            not shared_loss_finite or \
            not _launches_per_step_ok(sh["workers"]):
        return None, f"process shared gradients: {sh}"
    ev, sc = out["evaluate"], out["score"]
    if ev["accuracy"] != ev["parent_accuracy"] or \
            ev["examples"] != MP_EVAL_BATCHES * MP_EVAL_ROWS * SEQ or \
            not math.isfinite(sc["score"]) or sc["rel_diff"] > TOL_MP_SCORE:
        return None, f"process evaluate/score: {ev}, {sc}"
    return avg_launches, None


_TCP_CLIENT = """
import sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.parallel.accumulation import EncodingHandler
from deeplearning4j_tpu_torch.parallel.remote import RemoteGradientSharing
from deeplearning4j_tpu_torch.streaming import TcpMessageBroker
port, n, size, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), \\
    sys.argv[4]
broker = TcpMessageBroker(port=port)
sent = []
real = broker.publish


def publish(topic, payload):
    sent.append(payload)
    real(topic, payload)


broker.publish = publish
sharing = RemoteGradientSharing(broker, 3, topic="g", ack=True,
                                handler=EncodingHandler(1e-3))
rng = np.random.default_rng(int(sys.argv[5]))
for i in range(n):
    scale = 1e-2 if i % 2 else 4e-4
    sharing.publish_update(torch.as_tensor(
        rng.standard_normal(size).astype(np.float32) * scale))
np.savez(out, *[np.frombuffer(s, np.uint8) for s in sent])
broker.shutdown()
"""


def tcp_broker_interop_phase(args, torch, dev, card):
    """Phase 50.  Returns None or what failed."""
    import tempfile
    import numpy as np
    from deeplearning4j_tpu_torch.parallel.accumulation import decode
    from deeplearning4j_tpu_torch.parallel.remote import decode_message_bytes
    from deeplearning4j_tpu_torch.streaming import TcpMessageBroker
    t_phase = time.perf_counter()
    hub = TcpMessageBroker(max_queue=0).serve()
    out_dir = tempfile.mkdtemp(prefix="tcp_", dir=str(REPO / "build"))
    sent_file = os.path.join(out_dir, "sent.npz")
    try:
        sub = hub.subscribe("g", ack=True)
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run(
            [sys.executable, "-c", _TCP_CLIENT, str(hub.port),
             str(TCP_INTEROP_MESSAGES), str(TCP_INTEROP_SIZE), sent_file,
             str(args.seed)], env=env, capture_output=True, text=True,
            timeout=300)
        got = []
        while len(got) < TCP_INTEROP_MESSAGES:
            f = sub.poll(timeout=10)
            if f is None:
                break
            got.append(f)
        if proc.returncode != 0:
            return f"TCP interop client failed: {proc.stderr[-2000:]}"
        with np.load(sent_file) as z:
            sent = [z[f"arr_{i}"].tobytes() for i in range(len(z.files))]
    finally:
        hub.shutdown()
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
    same = len(got) == len(sent) == TCP_INTEROP_MESSAGES and \
        all(a == b for a, b in zip(got, sent))
    kinds, decoded_equal = [], True
    for a, b in zip(got, sent):
        _, _, ma = decode_message_bytes(a)
        _, _, mb = decode_message_bytes(b)
        kinds.append(ma["kind"])
        decoded_equal &= bool(torch.equal(decode(ma), decode(mb)))
    print(json.dumps({"phase": "tcp_broker_interop",
                      "messages": len(got), "sent": len(sent),
                      "elements": TCP_INTEROP_SIZE, "kinds": kinds,
                      "bytes": [len(g) for g in got],
                      "frames_bitwise_equal": same,
                      "decoded_bitwise_equal": decoded_equal,
                      "seconds": round(time.perf_counter() - t_phase, 3),
                      "card": card}), flush=True)
    if not same or not decoded_equal:
        return "TCP interop: the decoded messages differ from those sent"
    return None


# ---- 51-53. pretraining and detection -------------------------------
# Phase 51: the RBM stack of the DL4J examples' DeepAutoEncoderExample
# (784 -> 1000 -> 500 -> 250 -> 100 -> 30, CD-1, binary units) on
# MNIST-shaped binary rows, then its mirrored decoder to 784.
RBM_WIDTHS = (784, 1000, 500, 250, 100, 30)
RBM_BATCH, RBM_BATCHES, RBM_EPOCHS, RBM_FIT_STEPS = 1000, 10, 2, 3
RBM_LR = 0.1
# One CD step on the card against the CPU twin from the same key.  The
# CD gradient is the mean over rows of terms each in [-1, 1] that change
# only where a row's Gibbs sample differs: with d such rows of B, the
# gradients may differ by d/B on top of f32 rounding (sums of <= 1000
# products in another order: 1e-5 of the largest |g|).
TOL_CD_REL = 1e-5
# Phase 52: the VAE of the DL4J examples' VariationalAutoEncoderExample.
VAE_IN, VAE_LATENT, VAE_HIDDEN = 784, 2, (256, 256)
VAE_BATCH, VAE_STEPS, VAE_LR, VAE_L2 = 128, 20, 1e-3, 1e-4
VAE_GRID, VAE_RP_ROWS, VAE_RP_SAMPLES = 20, 1000, 16
TOL_VAE_LOSS = 1e-5
# decoded probabilities and log p(x) estimates from the same params on
# the card and on the CPU: f32 sums of <= 256 products, exp/log/sigmoid
TOL_VAE_GEN, TOL_VAE_LOGP = 1e-5, 1e-5
# Phase 53: Tiny YOLOv2 (darknet tiny-yolo-voc.cfg; YOLO9000, Redmon &
# Farhadi 2016) at 416x416x3, 13x13 cells, 5 VOC anchors, 20 classes.
TINY_YOLO_INPUT, TINY_YOLO_CLASSES = (416, 416, 3), 20
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))
TINY_YOLO_WIDTHS = (16, 32, 64, 128, 256, 512)
TINY_YOLO_BATCH, TINY_YOLO_STEPS, TINY_YOLO_TIMED = 16, 3, 5
TINY_YOLO_SERVE, TINY_YOLO_KEEP, TINY_YOLO_NMS = 8, 0.99, 0.45
TINY_YOLO_LR = 1e-3
# bn_apply against its plain version at the Tiny-YOLO shapes (f32): one
# rounding of x*scale + shift, relative to the largest |x*scale|+|shift|
TOL_TINY_YOLO_BN = 2.0 ** -22
# the f64 gradient check on the card: a 2-conv stack with a YOLO head
GC_SHAPE, GC_BOXES, GC_CLASSES, GC_SUBSET = (2, 13, 13, 8), \
    ((0.2, 0.2), (0.3, 0.25)), 3, 8


def _binary_rows(rng, n, width):
    """MNIST-shaped binary rows: a seeded per-pixel ink probability (a
    mean near MNIST's 0.13), each pixel drawn from it."""
    import numpy as np
    ink = rng.beta(0.4, 2.6, width)
    return (rng.random((n, width)) < ink).astype(np.float32)


class _StackWatch:
    """Listener of phase 51: after each iteration, which layers' params
    moved since the previous one, and the loss."""

    def __init__(self, torch, net):
        self.torch, self.net = torch, net
        self.snap = self._take()
        self.changed, self.losses = [], []

    def _take(self):
        return {k: [p.detach().clone() for p in g.values()]
                for k, g in self.net.params.items()}

    def iteration_done(self, model, iteration, epoch):
        now = self._take()
        self.changed.append(sorted(
            k for k in now if any(not self.torch.equal(a, b)
                                  for a, b in zip(now[k], self.snap[k]))))
        self.snap = now
        self.losses.append(float(model._score))


class _Losses:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, epoch):
        self.losses.append(float(model._score))


def _rbm_stack_conf(seed):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                               OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.pretrain import RBM
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Sgd(learning_rate=RBM_LR)).weight_init("xavier").list())
    for n in RBM_WIDTHS[1:]:
        b = b.layer(RBM(n_out=n, k=1))
    for n in RBM_WIDTHS[-2:0:-1]:
        b = b.layer(DenseLayer(n_out=n, activation="sigmoid"))
    return b.layer(OutputLayer(n_out=RBM_WIDTHS[0], activation="sigmoid",
                               loss="xent")).set_input_type(
        InputType.feed_forward(RBM_WIDTHS[0])).build()


def _host_params(net):
    return {k: {n: p.detach().cpu().numpy().copy() for n, p in g.items()}
            for k, g in net.params.items()}


def pretrain_rbm_phase(args, torch, dev, card):
    """Phase 51.  Returns ``(None, None)`` or ``(None, what failed)``."""
    import copy
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import (
        INDArrayDataSetIterator, MultipleEpochsIterator)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import _random

    rng = np.random.default_rng(args.seed + 51)
    data = _binary_rows(rng, RBM_BATCH * RBM_BATCHES, RBM_WIDTHS[0])
    conf = _rbm_stack_conf(args.seed)
    net = MultiLayerNetwork(conf, device=dev).init()
    cpu = MultiLayerNetwork(copy.deepcopy(conf), device="cpu")
    cpu.load_params(_host_params(net))
    n_rbm = len(RBM_WIDTHS) - 1

    # one CD step of layer 0 from one key, card vs CPU: samples, flips,
    # gradients
    rbm = net.conf.layers[0]
    x0 = data[:RBM_BATCH]
    key = _random.fold_in(_random.prng_key(args.seed), 51)
    out = {}
    for name, m in (("card", net), ("cpu", cpu)):
        p = {n: t.detach().requires_grad_(True)
             for n, t in m.params["layer_0"].items()}
        xx = torch.as_tensor(x0, device=m.device)
        k = key.to(m.device)
        with torch.no_grad():
            h, v2 = rbm.gibbs_step(p, xx, _random.fold_in(k, 0))
        loss = rbm.pretrain_loss(p, xx, key=k)
        g = torch.autograd.grad(loss, list(p.values()))
        out[name] = (h.cpu(), v2.cpu(), loss.item(),
                     {n: t.cpu() for n, t in zip(p, g)})
    (hc, vc, lc, gc), (hh, vh, lh, gh) = out["card"], out["cpu"]
    flips_h = int((hc != hh).sum())
    flips_v = int((vc != vh).sum())
    rows_v = int((vc != vh).any(dim=1).sum())
    cd = {}
    for n in gh:
        err = (gc[n] - gh[n]).abs().max().item()
        tol = TOL_CD_REL * gh[n].abs().max().item() + rows_v / RBM_BATCH
        cd[n] = {"max_abs_err": err, "tol": tol}
    loss_diff = abs(lc - lh) / abs(lh)
    print(json.dumps({"phase": "pretrain_rbm_cd_step", "rows": RBM_BATCH,
                      "widths": RBM_WIDTHS[:2], "flips_hidden": flips_h,
                      "flips_visible": flips_v,
                      "visible_rows_differing": rows_v,
                      "update": f"-{RBM_LR} x gradient (Sgd)",
                      "gradient": cd, "loss_card": lc, "loss_cpu": lh,
                      "rel_loss_diff": loss_diff, "card": card}),
          flush=True)
    if any(v["max_abs_err"] > v["tol"] for v in cd.values()) or \
            loss_diff > TOL_CD_REL + rows_v / RBM_BATCH:
        return None, (f"RBM CD step card vs CPU: {cd}, loss {lc} vs {lh} "
                      f"({flips_h} hidden, {flips_v} visible flips)")
    del cpu, out

    watch = _StackWatch(torch, net)
    net.set_listeners(watch)
    it = INDArrayDataSetIterator(data, data, RBM_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(MultipleEpochsIterator(RBM_EPOCHS, it))
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    per_layer = RBM_BATCHES * RBM_EPOCHS
    expected = [[f"layer_{i}"] for i in range(n_rbm)
                for _ in range(per_layer)]
    net.set_listeners()
    # the pretraining step's time per layer, without the listener's syncs
    step_ms = []
    for i in range(n_rbm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.pretrain_layer(i, it)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / RBM_BATCHES)
    fit_losses = []
    for s in range(RBM_FIT_STEPS):
        xb = torch.as_tensor(data[s * RBM_BATCH:(s + 1) * RBM_BATCH],
                             device=dev)
        net.fit(xb, xb)
        fit_losses.append(net.get_score())
    print(json.dumps({"phase": "pretrain_rbm_stack", "model": {
        "name": "DeepAutoEncoderExample RBM stack", "widths": RBM_WIDTHS,
        "k": 1, "units": "binary", "updater": f"Sgd({RBM_LR})",
        "batch": RBM_BATCH, "batches": RBM_BATCHES, "epochs": RBM_EPOCHS,
        "dtype": "float32", "num_params": net.num_params()},
        "iterations": net.iteration, "pretrain_seconds": pretrain_s,
        "pretrain_losses_first_last": [
            [watch.losses[i * per_layer], watch.losses[(i + 1) * per_layer
                                                        - 1]]
            for i in range(n_rbm)],
        "pretrain_step_ms_per_layer": step_ms,
        "layers_moved_as_expected": watch.changed == expected,
        "fit_losses": fit_losses, "card": card}), flush=True)
    if watch.changed != expected:
        bad = next(i for i, (a, b) in enumerate(zip(watch.changed,
                                                    expected)) if a != b) \
            if len(watch.changed) == len(expected) else len(watch.changed)
        return None, (f"pretraining moved layers {watch.changed[bad:bad + 1]}"
                      f" at iteration {bad + 1}; expected "
                      f"{expected[bad:bad + 1]}")
    if not all(math.isfinite(v) for v in watch.losses + fit_losses):
        return None, "RBM stack: a loss is not finite"
    return None, None


def _vae_conf(seed):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import RmsProp
    from deeplearning4j_tpu_torch.nn.conf.variational import \
        BernoulliReconstructionDistribution
    from deeplearning4j_tpu_torch.nn.layers.pretrain import \
        VariationalAutoencoder
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(RmsProp(learning_rate=VAE_LR)).weight_init("xavier")
            .l2(VAE_L2).list()
            .layer(VariationalAutoencoder(
                n_out=VAE_LATENT, encoder_layer_sizes=list(VAE_HIDDEN),
                decoder_layer_sizes=list(VAE_HIDDEN),
                activation="leakyrelu", pzx_activation="identity",
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution("sigmoid"))))
            .set_input_type(InputType.feed_forward(VAE_IN)).build())


def vae_mnist_phase(args, torch, dev, card):
    """Phase 52.  Returns ``(None, None)`` or ``(None, what failed)``."""
    import copy
    import numpy as np
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import _random

    rng = np.random.default_rng(args.seed + 52)
    data = _binary_rows(rng, VAE_BATCH * VAE_STEPS, VAE_IN)
    batches = [data[i:i + VAE_BATCH] for i in range(0, len(data), VAE_BATCH)]
    conf = _vae_conf(args.seed)
    net = MultiLayerNetwork(conf, device=dev).init()
    cpu = MultiLayerNetwork(copy.deepcopy(conf), device="cpu")
    cpu.load_params(_host_params(net))
    rec = {}
    for name, m in (("card", net), ("cpu", cpu)):
        rec[name] = _Losses()
        m.set_listeners(rec[name])
        m.pretrain(batches)
    losses, cpu_losses = rec["card"].losses, rec["cpu"].losses
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    net.set_listeners()
    # generation and log p(x) from the card's params, card vs CPU
    cpu.load_params(_host_params(net))
    vae, p_card = net.conf.layers[0], dict(net.params["layer_0"].items())
    p_cpu = dict(cpu.params["layer_0"].items())
    g = torch.linspace(-3.0, 3.0, VAE_GRID)
    z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    xr = torch.as_tensor(_binary_rows(rng, VAE_RP_ROWS, VAE_IN))
    key = _random.fold_in(_random.prng_key(args.seed), 52)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = vae.generate_at_mean_given_z(p_card, z.to(dev))
        logp = vae.reconstruction_probability(p_card, xr.to(dev), key.to(dev),
                                              num_samples=VAE_RP_SAMPLES)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_cpu = vae.generate_at_mean_given_z(p_cpu, z)
        logp_cpu = vae.reconstruction_probability(p_cpu, xr, key,
                                                  num_samples=VAE_RP_SAMPLES)
    gen_err = (gen.cpu() - gen_cpu).abs().max().item()
    logp_err = ((logp.cpu() - logp_cpu).abs()
                / logp_cpu.abs().clamp(min=1.0)).max().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.pretrain(batches)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    print(json.dumps({"phase": "vae_mnist", "model": {
        "name": "VariationalAutoEncoderExample VAE", "inputs": VAE_IN,
        "encoder": VAE_HIDDEN, "decoder": VAE_HIDDEN, "latent": VAE_LATENT,
        "activation": "leakyrelu", "reconstruction": "Bernoulli(sigmoid)",
        "updater": f"RmsProp({VAE_LR})", "l2": VAE_L2, "batch": VAE_BATCH,
        "dtype": "float32", "num_params": net.num_params()},
        "steps": VAE_STEPS, "losses": losses, "cpu_losses": cpu_losses,
        "max_rel_loss_diff": loss_diff, "tol_loss": TOL_VAE_LOSS,
        "generate_grid": [VAE_GRID, VAE_GRID], "generate_max_abs_err": gen_err,
        "reconstruction_probability": {
            "rows": VAE_RP_ROWS, "samples": VAE_RP_SAMPLES,
            "mean": logp.mean().item(), "max_rel_err": logp_err},
        "tol_generate": TOL_VAE_GEN, "tol_logp": TOL_VAE_LOGP,
        "generate_and_logp_seconds": gen_s,
        "pretrain_step_ms": step_ms, "card": card}), flush=True)
    if not all(math.isfinite(v) for v in losses) or loss_diff > TOL_VAE_LOSS:
        return None, (f"VAE pretraining losses {losses} differ from the CPU "
                      f"twin's {cpu_losses} by {loss_diff}")
    if tuple(gen.shape) != (VAE_GRID ** 2, VAE_IN) or \
            not bool(((gen >= 0) & (gen <= 1)).all()) or \
            gen_err > TOL_VAE_GEN:
        return None, f"VAE generation: shape {tuple(gen.shape)}, {gen_err}"
    if tuple(logp.shape) != (VAE_RP_ROWS,) or \
            not bool(torch.isfinite(logp).all()) or logp_err > TOL_VAE_LOGP:
        return None, f"VAE reconstruction probability off by {logp_err}"
    return None, None


def tiny_yolo_conf(seed, helper, updater=None):
    """Tiny YOLOv2 as a ComputationGraph (darknet's tiny-yolo-voc.cfg):
    six 3x3 convolutions of 16...512 filters, each followed by batch
    norm, leaky ReLU 0.1 and a 2x2 max pool (stride 2, the last stride 1
    ``same``), two 3x3 convolutions of 1024 with batch norm and leaky
    ReLU, a 1x1 convolution to 5 x (5 + 20) channels and the YOLOv2
    head.  Convolutions ahead of a batch norm have no bias."""
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        ActivationLayer
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        Yolo2OutputLayer
    h, w, c = TINY_YOLO_INPUT
    g = GraphBuilder({"activation": "identity", "weight_init": "relu",
                      "updater": updater or Adam(learning_rate=TINY_YOLO_LR)},
                     seed=seed)
    g.add_inputs("in").set_input_types(InputType.convolutional(h, w, c))
    x = "in"

    def conv_bn(i, n):
        g.add_layer(f"conv{i}", ConvolutionLayer(
            n_out=n, kernel_size=(3, 3), convolution_mode="same",
            has_bias=False), x)
        g.add_layer(f"bn{i}", BatchNormalization(helper=helper), f"conv{i}")
        g.add_layer(f"act{i}", ActivationLayer(activation="leakyrelu:0.1"),
                    f"bn{i}")
        return f"act{i}"

    for i, n in enumerate(TINY_YOLO_WIDTHS, 1):
        x = conv_bn(i, n)
        last = i == len(TINY_YOLO_WIDTHS)
        g.add_layer(f"pool{i}", SubsamplingLayer(
            pooling_type="max", kernel_size=(2, 2),
            stride=(1, 1) if last else (2, 2),
            convolution_mode="same" if last else "truncate"), x)
        x = f"pool{i}"
    for i in (7, 8):
        x = conv_bn(i, 1024)
    g.add_layer("conv9", ConvolutionLayer(
        n_out=len(TINY_YOLO_ANCHORS) * (5 + TINY_YOLO_CLASSES),
        kernel_size=(1, 1)), x)
    g.add_layer("yolo", Yolo2OutputLayer(
        boxes=[list(a) for a in TINY_YOLO_ANCHORS], lambda_coord=5.0,
        lambda_no_obj=0.5), "conv9")
    g.set_outputs("yolo")
    return g.build()


def yolo_labels(rng, batch, grid, classes, max_objects=3):
    """Synthetic VOC-style targets ``[b, grid, grid, 4 + classes]``: 1 to
    ``max_objects`` boxes an image, corners in grid units, 0.5 to 6 cells
    wide and tall, a random class, each in the cell of its centre."""
    import numpy as np
    labels = np.zeros((batch, grid, grid, 4 + classes), np.float32)
    for b in range(batch):
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cx, cy = rng.uniform(0, grid, 2)
            bw, bh = rng.uniform(0.5, 6.0, 2)
            r, c = int(cy), int(cx)
            labels[b, r, c] = 0.0
            labels[b, r, c, :4] = [cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                   cy + bh / 2]
            labels[b, r, c, 4 + int(rng.integers(classes))] = 1.0
    return labels


def _corner_yolo_labels(rng, batch, grid, classes):
    """One object an image, a 0.1-cell square in the top-left corner of
    its cell, which small untrained predictors (centres near the middle
    of their cells) do not overlap: every IoU is 0, the detached IoU
    target and the responsible box are locally constant, and central
    differences see the function autograd differentiates."""
    import numpy as np
    labels = np.zeros((batch, grid, grid, 4 + classes))
    for b in range(batch):
        r, c = rng.integers(0, grid, 2)
        labels[b, r, c, :4] = [c + 0.02, r + 0.02, c + 0.12, r + 0.12]
        labels[b, r, c, 4 + int(rng.integers(classes))] = 1.0
    return labels


def _gradient_check_graph(seed, dev):
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        Yolo2OutputLayer
    _, h, w, c = GC_SHAPE
    g = GraphBuilder({"activation": "identity"}, seed=seed)
    g.add_inputs("in").set_input_types(InputType.convolutional(h, w, c))
    g.add_layer("c1", ConvolutionLayer(
        n_out=16, kernel_size=(3, 3), convolution_mode="same",
        activation="leakyrelu:0.1"), "in")
    g.add_layer("c2", ConvolutionLayer(
        n_out=len(GC_BOXES) * (5 + GC_CLASSES), kernel_size=(1, 1)), "c1")
    g.add_layer("yolo", Yolo2OutputLayer(boxes=[list(b) for b in GC_BOXES]),
                "c2")
    g.set_outputs("yolo")
    return ComputationGraph(g.build(), device=dev).init()


def tiny_yolo_phase(args, torch, dev, card):
    """Phase 53.  Returns ``({"step": bn_apply launches per training
    step, "serve": per served batch}, None)`` or ``(None, what
    failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.computation_graph import (
        ComputationGraph, check_graph_gradients)
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        get_predicted_objects, non_max_suppression)
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.utils.profiling import device_memory_stats

    net = ComputationGraph(tiny_yolo_conf(args.seed, "pallas"),
                           device=dev).init()
    twin = ComputationGraph(tiny_yolo_conf(args.seed, None), device=dev)
    twin.load_params(_host_params(net))
    h, w, c = TINY_YOLO_INPUT
    grid = net.conf.vertex_input_types["yolo"][0].shape(1)[1]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 53)
    rng = np.random.default_rng(args.seed + 53)
    n_batches = TINY_YOLO_STEPS + TINY_YOLO_TIMED
    xs = [torch.rand((TINY_YOLO_BATCH, h, w, c), generator=gen, device=dev)
          for _ in range(n_batches)]
    ys = [torch.as_tensor(yolo_labels(rng, TINY_YOLO_BATCH, grid,
                                      TINY_YOLO_CLASSES), device=dev)
          for _ in range(n_batches)]

    # bn_apply against its plain version at the path's shapes
    geoms = bn_geometries(net.conf, TINY_YOLO_BATCH)
    admitted = sum(n for (m, ch, a), n in geoms.items()
                   if pb.supports(activation=a, shape=(m, ch)))
    bn_shapes = [net.conf.vertex_input_types[v][0].shape(TINY_YOLO_BATCH)
                 for v in net.conf.topological_order if v.startswith("bn")]
    bn_err, bn_tol = 0.0, 0.0
    for shape in dict.fromkeys(tuple(s) for s in bn_shapes):
        x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        scale = torch.randn(shape[-1], generator=gen, device=dev)
        shift = torch.randn(shape[-1], generator=gen, device=dev)
        y = pb.bn_apply(x, scale, shift, False)
        want = pb.bn_apply_plain(x, scale, shift, False)
        err = (y - want).abs().max().item()
        tol = TOL_TINY_YOLO_BN * (x.abs() * scale.abs()
                                  + shift.abs()).max().item()
        print(json.dumps({"phase": "bn_kernel_vs_plain_tiny_yolo",
                          "shape": list(shape), "max_abs_err": err,
                          "tol": tol}), flush=True)
        if not bool(torch.isfinite(y).all()) or err > tol:
            return None, f"bn_apply disagrees with plain at {shape}: {err}"
        bn_err, bn_tol = max(bn_err, err), max(bn_tol, tol)
        del x, y, want

    check, err = bn_twin_grad_check(torch, net, twin, xs[0], ys[0])
    if err:
        return None, f"Tiny YOLOv2: {err}"

    snaps, losses, twin_losses = [], [], []
    torch.cuda.synchronize()
    pb.reset_launches()
    for x, y in zip(xs[:TINY_YOLO_STEPS], ys[:TINY_YOLO_STEPS]):
        snaps.append([p.detach().clone() for p in net.parameters()])
        net.fit(x, y)
        losses.append(net._score)
    torch.cuda.synchronize()
    step_launches = pb.launches["bn_apply"]
    losses = [float(v) for v in losses]
    for snap, x, y in zip(snaps, xs, ys):
        with torch.no_grad():
            for p, q in zip(twin.parameters(), snap):
                p.copy_(q)
        twin.fit(x, y)
        twin_losses.append(twin.get_score())
    del snaps, twin
    loss0 = check["loss0"]
    loss_diff = max(abs(a - b) / abs(b) for a, b in
                    zip([loss0[0]] + losses, [loss0[1]] + twin_losses))

    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for x, y in zip(xs[TINY_YOLO_STEPS:], ys[TINY_YOLO_STEPS:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    mem = device_memory_stats(dev)
    med = statistics.median(step_ms)
    split = profile_steps(torch, net, list(zip(xs, ys))[:PROFILED_STEPS],
                          CNN_KERNEL_CLASSES)
    busy = split["device_ms_total_per_step"] / med \
        if split["device_ms_total_per_step"] else None

    # serve a batch: output, decode, NMS
    xserve = xs[0][:TINY_YOLO_SERVE]
    torch.cuda.synchronize()
    pb.reset_launches()
    t0 = time.perf_counter()
    act = net.output(xserve)
    act = act[0] if isinstance(act, list) else act
    # the threshold that keeps the most confident 1 % of the boxes: an
    # untrained head's confidences sit in a narrow band
    thr = torch.quantile(act[..., 4].flatten().float(),
                         TINY_YOLO_KEEP).item()
    dets = get_predicted_objects(act, threshold=thr)
    kept = [non_max_suppression(d, TINY_YOLO_NMS) for d in dets]
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = pb.launches["bn_apply"]
    want_dets = (act[..., 4] >= thr).sum(dim=(1, 2, 3)).tolist()
    decoded = tuple(act.shape) == (TINY_YOLO_SERVE, grid, grid,
                                   len(TINY_YOLO_ANCHORS),
                                   5 + TINY_YOLO_CLASSES) and \
        bool(torch.isfinite(act).all()) and \
        [len(d) for d in dets] == want_dets and sum(want_dets) > 0 and \
        all(np.isfinite(d).all() and d.shape[1] == 6 for d in dets) and \
        all(len(k) <= len(d) and (np.diff(k[:, 4]) <= 0).all()
            for k, d in zip(kept, dets))

    # the f64 gradient check on the card: a 2-conv stack, YOLO head
    gnet = _gradient_check_graph(args.seed, dev)
    grng = np.random.default_rng(args.seed + 530)
    gx = 0.3 * grng.standard_normal(GC_SHAPE)
    glabels = _corner_yolo_labels(grng, GC_SHAPE[0], GC_SHAPE[1], GC_CLASSES)
    t0 = time.perf_counter()
    gc_ok = check_graph_gradients(gnet, gx, glabels, subset=GC_SUBSET)
    gc_s = time.perf_counter() - t0

    print(json.dumps({
        "phase": "tiny_yolo_voc", "model": {
            "name": "Tiny YOLOv2 (tiny-yolo-voc.cfg)",
            "input": list(TINY_YOLO_INPUT), "grid": grid,
            "anchors": TINY_YOLO_ANCHORS, "classes": TINY_YOLO_CLASSES,
            "batch": TINY_YOLO_BATCH, "dtype": "float32", "tf32": False,
            "updater": f"Adam({TINY_YOLO_LR})", "bn_helper": "pallas",
            "bn_layers": len(bn_shapes), "bn_layers_on_the_kernel": admitted,
            "num_params": net.num_params()},
        "bn_kernel_max_abs_err": bn_err, "bn_kernel_tol": bn_tol,
        "step0_loss": loss0, "losses": losses, "twin_losses": twin_losses,
        "max_rel_loss_diff": loss_diff, "tol_loss": CNN_TOL_LOSS,
        "step0_grad_worst_err_over_tol": check["worst_ratio"],
        "step0_grad_worst_param": check["worst_name"],
        "step0_grad_rel_l2": check["grad_rel_l2"],
        "kernel_launches_train": step_launches,
        "expected_launches_train": admitted * TINY_YOLO_STEPS,
        "step_ms": step_ms, "step_ms_median": med,
        "images_per_s": TINY_YOLO_BATCH / med * 1e3,
        "profile": split, "device_busy_share": busy,
        "memory": mem,
        "serve": {"batch": TINY_YOLO_SERVE, "ms": serve_ms,
                  "bn_apply_launches": serve_launches,
                  "threshold": thr,
                  "detections": [len(d) for d in dets],
                  "after_nms": [len(k) for k in kept], "decoded": decoded},
        "gradient_check_f64": {"passed": gc_ok, "subset": GC_SUBSET,
                               "seconds": gc_s},
        "card": card}), flush=True)
    if (len(bn_shapes), admitted) != (8, 8):
        return None, (f"Tiny YOLOv2 has {len(bn_shapes)} BN layers, "
                      f"{admitted} on the kernel; expected 8")
    if step_launches != admitted * TINY_YOLO_STEPS:
        return None, (f"bn_apply launched {step_launches} times in "
                      f"{TINY_YOLO_STEPS} steps; expected {admitted} a step")
    if not all(math.isfinite(v) for v in losses) or \
            loss_diff > CNN_TOL_LOSS:
        return None, (f"Tiny YOLOv2 losses {losses} differ from the eager "
                      f"twin's {twin_losses} by {loss_diff}")
    if not decoded:
        return None, "Tiny YOLOv2 detections did not decode"
    if not gc_ok:
        return None, "the f64 YOLO gradient check failed on the card"
    return {"step": step_launches // TINY_YOLO_STEPS,
            "serve": serve_launches}, None


def pretrain_detection_phases(args, torch, dev, card):
    """Phases 51-53.  Returns ``(bn_apply launches of phase 53, None)``
    or ``(None, what failed)``."""
    t0 = time.perf_counter()
    for phase in (pretrain_rbm_phase, vae_mnist_phase):
        _, err = phase(args, torch, dev, card)
        if err:
            return None, err
        torch.cuda.empty_cache()
    launches, err = tiny_yolo_phase(args, torch, dev, card)
    if err:
        return None, err
    print(json.dumps({"phase": "pretrain_detection_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return launches, None


# ---- 54-56. the input pipeline, the data readers, clustering ----------
# CIFAR-10's five training batches: 10,000 records of 3073 bytes each
# (label, then 3x32x32 CHW pixels), 153.65 MB, written from the seed
CIFAR_FILES, CIFAR_PER_FILE, CIFAR_RECORD = 5, 10_000, 3073
PIPE_BATCH, PIPE_STEPS, PIPE_WORKERS, PIPE_DEPTH, PIPE_PAD = 128, 10, 4, 2, 4
MNIST_TRAIN, MNIST_BATCH, MNIST_STEPS = 60_000, 64, 20
CSV_ROWS, CSV_COLS, CSV_CLASSES, CSV_BATCH, CSV_STEPS = \
    100_000, 20, 10, 1000, 5
# KMeans on 100 Gaussian blobs in 128-d, half of them twice as wide:
# the blobs sit ~64 apart, a blob's points ~11 (or ~23) from its center
KM_POINTS, KM_DIM, KM_K, KM_ITERS = 100_000, 128, 100, 20
KM_BLOB_SCALE = 4.0
KM_OPT_ITERS, KM_OPT_PERIOD = 6, 3
KM_OPT_AVG = 16.0               # between the narrow and the wide blobs' ~11/~23
# The card's Lloyd steps, each held against the CPU and float64 from the
# same input centers (a free-running twin drifts: a point within rounding
# of two centers goes either way, and the centers carry that on):
# - an assignment may differ from the CPU's only where the point's two
#   distances (f64) are within TOL_KM_TIE: the f32 expansion
#   |x|^2 - 2xc + |c|^2 with |x| ~ 45 rounds d by ~1e-5;
# - the refreshed centers within TOL_KM_CENTERS of the largest |center|
#   from the f64 means over the card's own assignment (f32 sums of ~1000
#   points: ~1e-6), the cost within TOL_KM_CENTERS relative of its f64
#   value, the per-cluster mean and max distances within the f32
#   expansion's own bound (``_distance_tol``: sqrt((2D + 2) ulps of
#   max|x|^2), ~0.25 here, approached where a center is a point).
TOL_KM_CENTERS, TOL_KM_TIE = 1e-5, 1e-4
KM_CHECKED_STEPS = (0, 1, 10, 19)
TSNE_N, TSNE_DIM, TSNE_PERPLEXITY, TSNE_ITERS = 5000, 50, 30.0, 300
# Exact t-SNE on the card, held against the CPU from the card's own
# inputs: the conditional P of TSNE_CHECKED_ROWS rows (the bisection is
# row-wise), and the gradient, KL and update at TSNE_CHECKED_STEPS (one
# step in the exaggerated phase, one after the momentum switch, the
# last).  The same f32 ops summed in another order: P within 1e-5 of
# its largest entry, the gradient within 1e-4 of its largest |g| (a sum
# of 5000 terms of either sign), KL within 1e-5 relative.  The update is
# elementwise, so the CPU's equals the card's where it takes the same
# branch; the gains branch on the sign of grad vs vel, so an element
# whose gradient is within rounding of 0 may take the other one (a gain
# x0.8 instead of +0.2) and move by lr x gain x |grad| with |grad| at
# the rounding level: fed the card's gradient, the update within 1e-6 of
# the embedding's largest |y|.
TSNE_CHECKED_ROWS, TSNE_CHECKED_STEPS = 512, (0, 260, 299)
TOL_TSNE_P, TOL_TSNE_GRAD, TOL_TSNE_KL, TOL_TSNE_Y = 1e-5, 1e-4, 1e-5, 1e-6
# Barnes-Hut at n 1,000: 5 iterations (its SPTree runs on the host, ~3 s
# an iteration; the run checks a finite embedding and KL, and the time
# limit of the whole smoke needs the seconds)
BH_N, BH_ITERS = 1000, 5


class _StepClock:
    """A training listener that stamps the host clock after each step and
    keeps each step's loss (a device scalar: no sync)."""

    def __init__(self):
        self.stamps, self.losses = [], []

    def iteration_done(self, model, iteration, epoch):
        self.stamps.append(time.perf_counter())
        self.losses.append(model._score)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


class _Recorded:
    """An iterator that keeps every batch it yields (the yielded objects
    themselves: device tensors stay on the device)."""

    def __init__(self, underlying, limit):
        self.underlying = underlying
        self.limit = limit
        self.batches = []

    def reset(self):
        self.underlying.reset()

    def __iter__(self):
        it = iter(self.underlying)
        try:
            for _ in range(self.limit):
                ds = next(it, None)
                if ds is None:
                    return
                self.batches.append(ds)
                yield ds
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class _InProcessETL:
    """The in-process composition the multiprocess ETL stage reproduces:
    the source (reset once per epoch) with ``transform`` drawn from
    ``np.random.default_rng((seed, epoch, seq))`` for batch ``seq``.
    (``TransformingDataSetIterator`` draws one stream per epoch, as the
    JAX package's does, so its draws cannot equal the workers'.)"""

    def __init__(self, source, transform, seed):
        self.source, self.transform, self.seed = source, transform, seed
        self.epoch = 0

    def reset(self):
        self.epoch += 1
        self.source.reset()

    def __iter__(self):
        import numpy as np
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        for seq, ds in enumerate(self.source):
            rng = np.random.default_rng((self.seed, self.epoch, seq))
            yield DataSet(np.ascontiguousarray(self.transform(
                np.asarray(ds.features), rng)), ds.labels,
                ds.features_mask, ds.labels_mask)


def write_cifar_batches(directory, seed):
    """The five CIFAR-10 training batch files in the published binary
    format, random labels and pixels from ``seed``; returns their bytes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    total = 0
    for i in range(1, CIFAR_FILES + 1):
        rec = rng.integers(0, 256, (CIFAR_PER_FILE, CIFAR_RECORD),
                           dtype=np.uint8)
        rec[:, 0] %= 10
        (Path(directory) / f"data_batch_{i}.bin").write_bytes(rec.tobytes())
        total += rec.nbytes
    return total


def write_mnist_idx(directory, seed, n):
    """MNIST's training images and labels as IDX files (big-endian
    header: magic 0x0803 / 0x0801, then the dims), from ``seed``."""
    import struct
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    # noise below 64, and a class patch 150 brighter
    images = rng.integers(0, 64, (n, 28, 28), dtype=np.uint8)
    for c in range(10):
        r, col = divmod(c, 4)
        images[labels == c, 4 + r * 6:12 + r * 6, 2 + col * 6:10 + col * 6] \
            += 150
    d = Path(directory)
    (d / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 0x0803, n, 28, 28) + images.tobytes())
    (d / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 0x0801, n) + labels.tobytes())
    return images, labels


def _registry_summary(reg) -> dict:
    """``training_etl_seconds`` (count, seconds) and the starved counts
    per stage, from one registry."""
    out = {"etl": {}, "starved": {}}
    h = reg.get("training_etl_seconds")
    if h is not None:
        for labels, child in h.samples():
            out["etl"][labels[0]] = {"count": child.count,
                                     "seconds": child.sum}
    c = reg.get("training_pipeline_starved_total")
    if c is not None:
        for labels, child in c.samples():
            out["starved"][labels[0]] = child.value
    return out


def _cuda_in(pid: int):
    """The CUDA libraries mapped into process ``pid`` (read from its
    ``/proc/<pid>/maps``; a process with none cannot hold a context)."""
    try:
        maps = Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return None
    return sorted({ln.rsplit("/", 1)[-1] for ln in maps.splitlines()
                   if "libcuda" in ln or "libtorch_cuda" in ln})


def _compute_app_pids():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return sorted(int(t) for t in out.split() if t.strip().isdigit())


def _worker_watch(pipe, seen, stop):
    """While the ETL workers of ``pipe`` live: their pids, the card's
    compute processes (nvidia-smi) and the CUDA libraries mapped into
    each worker, twice.  (In a PID namespace nvidia-smi reports the
    processes under pids of the host's, so the list is compared with the
    one taken before the workers started.)"""
    etl = pipe.underlying
    while not stop.is_set() and not any(
            p.is_alive() for p in getattr(etl, "workers", [])):
        time.sleep(0.01)
    for _ in range(2):
        alive = [p.pid for p in etl.workers if p.is_alive()]
        if not alive:
            break
        seen.append({"worker_pids": alive,
                     "compute_app_pids": _compute_app_pids(),
                     "worker_cuda_libs": {p: _cuda_in(p) for p in alive}})
        time.sleep(0.2)


def _fit_run(torch, net, feed, steps):
    """``fit`` over ``feed`` (at most ``steps`` batches) with a fresh
    registry, a step clock and ``bn_apply`` counted.  Returns the run's
    record, the yielded batches and the step losses."""
    from deeplearning4j_tpu_torch.observability.registry import (
        MetricsRegistry, set_default_registry)
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    rec = _Recorded(feed, steps)
    clock = _StepClock()
    net.set_listeners(clock)
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pb.reset_launches()
    try:
        t0 = time.perf_counter()
        net.fit(rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        set_default_registry(prev)
        net.set_listeners()
    steps_ms = [(b - a) * 1e3 for a, b in zip(clock.stamps, clock.stamps[1:])]
    out = {"steps": len(clock.stamps),
           "bn_apply_launches": pb.launches["bn_apply"],
           "wall_s": wall, "step_ms": steps_ms,
           "step_ms_median": statistics.median(steps_ms)
           if steps_ms else None,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           **_registry_summary(reg)}
    return out, rec.batches, [float(v) for v in clock.losses]


def _busy_split_us(prof):
    """The card's busy time (the union of its kernel and copy intervals)
    on either side of the longest idle gap of a trace that holds two
    runs, in microseconds: the two runs of phase 54, between which the
    card idles while the ETL workers start."""
    # the raw kineto events: building the profiler's FunctionEvents for
    # two runs' kernels takes ~19 s on that host
    spans = sorted((ev.start_ns() / 1e3, ev.end_ns() / 1e3)
                   for ev in prof.profiler.kineto_results.events()
                   if "CUDA" in str(ev.device_type()))
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if len(merged) < 2:
        return None
    cut = max(range(1, len(merged)),
              key=lambda i: merged[i][0] - merged[i - 1][1])
    busy = [sum(b - a for a, b in merged[:cut]),
            sum(b - a for a, b in merged[cut:])]
    return busy, merged[cut][0] - merged[cut - 1][1]


def cifar_pipeline_phase(args, torch, dev, card):
    """Phase 54.  Returns ``(bn_apply launches per step of the pipeline
    run, None)`` or ``(None, what failed)``."""
    import functools
    import tempfile
    import threading
    import numpy as np
    from deeplearning4j_tpu_torch.data.fetchers import CifarDataSetIterator
    from deeplearning4j_tpu_torch.data.pipeline import build_input_pipeline
    from deeplearning4j_tpu_torch.data.transforms import (
        ComposeTransform, RandomCropTransform, RandomFlipTransform)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.utils import native

    t_phase = time.perf_counter()
    spans, t_mark = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        spans[name] = now - t_mark[0]
        t_mark[0] = now

    if not native.available():
        return None, "the native host library did not build: no decode_cifar"
    tmp = tempfile.TemporaryDirectory(prefix="cifar10-")
    old_dir = os.environ.get("CIFAR_DIR")
    os.environ["CIFAR_DIR"] = tmp.name
    try:
        t0 = time.perf_counter()
        nbytes = write_cifar_batches(tmp.name, args.seed + 54)
        write_s = time.perf_counter() - t0
        raw = (Path(tmp.name) / "data_batch_1.bin").read_bytes()
        t0 = time.perf_counter()
        labels_n, images_n = native.decode_cifar(raw)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels_p, images_p = native.decode_cifar(raw, use_native=False)
        numpy_s = time.perf_counter() - t0
        decode_equal = bool(np.array_equal(labels_n, labels_p)
                            and np.array_equal(images_n, images_p))
        del images_n, images_p
        mark("data")

        zoo = ResNet50(input_shape=(32, 32, 3), num_classes=10,
                       seed=args.seed)
        nets = []
        for _ in range(2):
            conf = zoo.conf()
            for v in conf.vertices.values():
                lc = getattr(v, "layer", None)
                if type(lc).__name__ == "BatchNormalization":
                    lc.helper = "pallas"
            nets.append(ComputationGraph(conf, device=dev))
        host_net = nets[0].init()
        pipe_net = nets[1].load_params({
            k: {n: p.detach().cpu().numpy() for n, p in g.items()}
            for k, g in host_net.params.items()})
        transform = ComposeTransform([RandomCropTransform(PIPE_PAD),
                                      RandomFlipTransform()])
        factory = functools.partial(CifarDataSetIterator, PIPE_BATCH,
                                    seed=args.seed)
        mark("nets")
        on_card = torch.device(dev).type == "cuda"
        det = torch.backends.cudnn.deterministic
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        prof = None
        try:
            if on_card:
                # one trace over both runs, of the card only: recording
                # every host op would slow these launch-bound steps
                # severalfold, and each trace costs ~10 s to close
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
            # (a) the host iterator, the transform in this process
            t0 = time.perf_counter()
            host_feed = _InProcessETL(factory(), transform, args.seed)
            host_load_s = time.perf_counter() - t0
            host_rec, host_batches, host_losses = _fit_run(
                torch, host_net, host_feed, PIPE_STEPS)
            mark("host_run")
            # (b) 4 ETL processes, 2-deep prefetch onto the card
            apps_before = _compute_app_pids()
            pipe = build_input_pipeline(
                factory, transform, num_workers=PIPE_WORKERS,
                depth=PIPE_DEPTH, seed=args.seed, device=dev)
            seen, stop = [], threading.Event()
            watch = threading.Thread(target=_worker_watch,
                                     args=(pipe, seen, stop), daemon=True)
            watch.start()
            pipe_rec, pipe_batches, pipe_losses = _fit_run(
                torch, pipe_net, pipe, PIPE_STEPS)
            mark("pipeline_run")
            stop.set()
            watch.join(timeout=30)
            mark("watch_join")
            workers_left = [p.pid for p in pipe.underlying.workers
                            if p.is_alive()]
        finally:
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = bench
            if prof is not None:
                prof.__exit__(None, None, None)
                mark("profiler_close")
        split = _busy_split_us(prof) if prof is not None else None
        mark("profiler_events")
    finally:
        if old_dir is None:
            os.environ.pop("CIFAR_DIR", None)
        else:
            os.environ["CIFAR_DIR"] = old_dir
        tmp.cleanup()
    mark("cleanup")

    # every batch on the card against the host batch of the same number
    batch_equal = len(pipe_batches) == len(host_batches) == PIPE_STEPS
    for hb, pb_ in zip(host_batches, pipe_batches):
        for h, p in ((hb.features, pb_.features), (hb.labels, pb_.labels)):
            on_card &= isinstance(p, torch.Tensor) and p.device.type == "cuda"
            batch_equal &= isinstance(p, torch.Tensor) and np.array_equal(
                p.cpu().numpy(), np.asarray(h)) and \
                p.dtype == torch.from_numpy(np.asarray(h)).dtype
    param_diff = max(
        (a - b).abs().max().item() for a, b in
        zip(host_net.parameters(), pipe_net.parameters()))
    state_diff = max(
        (host_net.state[k][n] - t).abs().max().item()
        for k, g in pipe_net.state.items() for n, t in g.items())
    loss_diff = max((abs(a - b) for a, b in zip(host_losses, pipe_losses)),
                    default=float("inf"))
    own = os.getpid()
    workers_seen = {p for s in seen for p in s["worker_pids"]}
    # a worker on the card would add a compute process to the list (or
    # show under its own pid where nvidia-smi shares our PID namespace)
    foreign = [s["compute_app_pids"] for s in seen
               if s["compute_app_pids"] != apps_before
               or workers_seen & set(s["compute_app_pids"])]
    worker_cuda = {p: libs for s in seen
                   for p, libs in s["worker_cuda_libs"].items() if libs}
    for i, rec in enumerate((host_rec, pipe_rec)):
        rec["images_per_s"] = PIPE_BATCH / rec["step_ms_median"] * 1e3 \
            if rec["step_ms_median"] else None
        if split is not None:
            # the card's busy time over the run's wall, and over the wall
            # less the trainer's waits on the iterator (the workers'
            # start, in the pipeline run)
            busy_s = split[0][i] / 1e6
            fetch_s = rec["etl"].get("fetch", {}).get("seconds", 0.0)
            rec["device_busy_ms"] = busy_s * 1e3
            rec["device_busy_share"] = busy_s / rec["wall_s"]
            rec["device_busy_share_outside_fetch"] = \
                busy_s / (rec["wall_s"] - fetch_s)
    print(json.dumps({
        "phase": "cifar_pipeline_resnet50",
        "data": {"files": CIFAR_FILES, "records": CIFAR_FILES
                 * CIFAR_PER_FILE, "bytes": nbytes, "write_s": write_s,
                 "native_available": native.available(),
                 "decode_MB_per_s": {"native": len(raw) / native_s / 1e6,
                                     "numpy_twin": len(raw) / numpy_s / 1e6},
                 "decode_native_equals_twin": decode_equal,
                 "host_source_load_s": host_load_s},
        "model": {"name": "ResNet50", "input": [32, 32, 3], "classes": 10,
                  "batch": PIPE_BATCH, "dtype": "float32", "tf32": False,
                  "bn_helper": "pallas", "cudnn_deterministic": True,
                  "transform": f"RandomCrop(pad {PIPE_PAD}) + RandomFlip"},
        "host": host_rec, "pipeline": {
            **pipe_rec, "num_workers": PIPE_WORKERS, "depth": PIPE_DEPTH},
        "batches_bitwise_equal": batch_equal, "batches_on_card": on_card,
        "losses": {"host": host_losses, "pipeline": pipe_losses},
        "final_params_max_abs_diff": param_diff,
        "running_stats_max_abs_diff": state_diff,
        "loss_max_abs_diff": loss_diff,
        "phase_spans_s": spans,
        "idle_gap_between_runs_ms": split[1] / 1e3 if split else None,
        "worker_checks": seen, "own_pid": own,
        "compute_app_pids_before_workers": apps_before,
        "compute_app_pids_changed": foreign, "workers_left": workers_left,
        "seconds": time.perf_counter() - t_phase, "card": card}),
        flush=True)
    expected = 53 * PIPE_STEPS
    if not decode_equal:
        return None, "native decode_cifar differs from its numpy twin"
    if host_rec["bn_apply_launches"] != expected or \
            pipe_rec["bn_apply_launches"] != expected:
        return None, (f"bn_apply launched {host_rec['bn_apply_launches']} "
                      f"(host) / {pipe_rec['bn_apply_launches']} (pipeline) "
                      f"times in {PIPE_STEPS} steps; expected 53 a step")
    if not (batch_equal and on_card):
        return None, "a prefetched batch differs from the host batch"
    if len(host_losses) != PIPE_STEPS or \
            not all(map(math.isfinite, host_losses)):
        return None, f"ResNet50 losses {host_losses}: not {PIPE_STEPS} finite"
    if param_diff or state_diff or loss_diff:
        return None, (f"pipeline-fed training differs from host-fed: params "
                      f"{param_diff}, running stats {state_diff}, loss "
                      f"{loss_diff} (cuDNN deterministic: expected 0)")
    if not seen:
        return None, "the ETL workers were never seen alive"
    if foreign or worker_cuda or len(apps_before) != 1:
        return None, (f"an ETL worker touched the card: compute pids "
                      f"{apps_before} before the workers, {foreign} while "
                      f"they ran, CUDA libraries {worker_cuda}")
    if workers_left:
        return None, f"ETL workers {workers_left} outlived the pipeline"
    return pipe_rec["bn_apply_launches"] // PIPE_STEPS, None


def mnist_records_phase(args, torch, dev, card):
    """Phase 55.  Returns ``(None, None)`` or ``(None, what failed)``."""
    import functools
    import tempfile
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import (
        EarlyTerminationDataSetIterator, INDArrayDataSetIterator)
    from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.data.pipeline import build_input_pipeline
    from deeplearning4j_tpu_torch.data.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.updaters import Adam
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        DenseLayer, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.utils import native

    t_phase = time.perf_counter()
    for mod in (fa, pb, pl):
        mod.reset_launches()
    tmp = tempfile.TemporaryDirectory(prefix="mnist-")
    old_dir = os.environ.get("MNIST_DIR")
    os.environ["MNIST_DIR"] = tmp.name
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        images, labels = write_mnist_idx(tmp.name, args.seed + 55,
                                         MNIST_TRAIN)
        idx_write_s = time.perf_counter() - t0
        factory = functools.partial(MnistDataSetIterator, MNIST_BATCH,
                                    seed=args.seed)
        probe = factory()
        read_ok = not probe.synthetic and np.array_equal(
            probe.data.features, images.reshape(MNIST_TRAIN, -1)
            .astype(np.float32) / 255.0) and np.array_equal(
            probe.data.labels.argmax(1), labels)
        zoo = LeNet(num_classes=10, seed=args.seed)
        host_net = zoo.init(device=dev)
        pipe_net = MultiLayerNetwork(zoo.conf(), device=dev).load_params({
            k: {n: p.detach().cpu().numpy() for n, p in g.items()}
            for k, g in host_net.params.items()})
        runs = {}
        for name, net, feed in (
                ("host", host_net, factory()),
                ("pipeline", pipe_net, build_input_pipeline(
                    factory, num_workers=0, depth=2, device=dev))):
            clock = _StepClock()
            net.set_listeners(clock)
            t0 = time.perf_counter()
            net.fit(EarlyTerminationDataSetIterator(feed, MNIST_STEPS))
            torch.cuda.synchronize()
            net.set_listeners()
            runs[name] = {"losses": [float(v) for v in clock.losses],
                          "seconds": time.perf_counter() - t0}
        mnist_diff = max((abs(a - b) for a, b in zip(
            runs["host"]["losses"], runs["pipeline"]["losses"])),
            default=float("inf"))
        mnist_params = max((a - b).abs().max().item() for a, b in zip(
            host_net.parameters(), pipe_net.parameters()))

        # a CSV of 100,000 x 20 through parse_csv and the record reader;
        # multiples of 1/256 in [-8, 8): exact in f32 and in "%.8f"
        rng = np.random.default_rng(args.seed + 550)
        feats = (rng.integers(-2048, 2048, (CSV_ROWS, CSV_COLS - 1))
                 / 256).astype(np.float32)
        cls = rng.integers(0, CSV_CLASSES, CSV_ROWS)
        path = Path(tmp.name) / "records.csv"
        t0 = time.perf_counter()
        np.savetxt(path, np.concatenate([feats, cls[:, None]], axis=1),
                   fmt="%.8f", delimiter=",")
        csv_write_s = time.perf_counter() - t0
        reader = CSVRecordReader(str(path))
        t0 = time.perf_counter()
        parsed = reader._parsed()
        parse_s = time.perf_counter() - t0
        parse_ok = parsed is not None and parsed.shape == (
            CSV_ROWS, CSV_COLS) and np.array_equal(parsed[:, :-1], feats) \
            and np.array_equal(parsed[:, -1], cls.astype(np.float32))

        def mlp():
            conf = (NeuralNetConfiguration.builder().seed(args.seed)
                    .updater(Adam(learning_rate=1e-3)).list()
                    .layer(DenseLayer(n_out=256, activation="relu"))
                    .layer(DenseLayer(n_out=256, activation="relu"))
                    .layer(OutputLayer(n_out=CSV_CLASSES,
                                       activation="softmax",
                                       loss="mcxent"))
                    .set_input_type(InputType.feed_forward(CSV_COLS - 1))
                    .build())
            return MultiLayerNetwork(conf, device=dev).init()

        csv_runs = {}
        for name, feed in (
                ("records", RecordReaderDataSetIterator(
                    reader, CSV_BATCH, label_index=-1,
                    n_classes=CSV_CLASSES)),
                ("arrays", INDArrayDataSetIterator(
                    feats, np.eye(CSV_CLASSES, dtype=np.float32)[cls],
                    CSV_BATCH))):
            net = mlp()
            clock = _StepClock()
            net.set_listeners(clock)
            t0 = time.perf_counter()
            net.fit(EarlyTerminationDataSetIterator(feed, CSV_STEPS))
            torch.cuda.synchronize()
            csv_runs[name] = {"losses": [float(v) for v in clock.losses],
                              "seconds": time.perf_counter() - t0}
        csv_equal = csv_runs["records"]["losses"] == \
            csv_runs["arrays"]["losses"]
    finally:
        torch.backends.cudnn.deterministic = det
        if old_dir is None:
            os.environ.pop("MNIST_DIR", None)
        else:
            os.environ["MNIST_DIR"] = old_dir
        tmp.cleanup()
    launches = {**fa.launches, **pb.launches, **pl.launches}
    print(json.dumps({
        "phase": "mnist_lenet_records",
        "mnist": {"images": MNIST_TRAIN, "idx_write_s": idx_write_s,
                  "read_equals_written": bool(read_ok),
                  "model": "LeNet (28x28x1, 10 classes)",
                  "batch": MNIST_BATCH, **{k: v for k, v in runs.items()},
                  "loss_max_abs_diff": mnist_diff,
                  "params_max_abs_diff": mnist_params},
        "csv": {"rows": CSV_ROWS, "cols": CSV_COLS,
                "write_s": csv_write_s, "parse_csv_s": parse_s,
                "native": native.available(),
                "parse_equals_written": bool(parse_ok),
                "mlp": "Dense 256 relu x2, softmax 10, Adam 1e-3",
                "batch": CSV_BATCH, **csv_runs,
                "losses_equal": csv_equal},
        "kernel_launches": launches,
        "seconds": time.perf_counter() - t_phase, "card": card}),
        flush=True)
    if not read_ok:
        return None, "MnistDataSetIterator did not read the written IDX files"
    if len(runs["host"]["losses"]) != MNIST_STEPS or mnist_diff or \
            mnist_params or not all(map(math.isfinite,
                                        runs["host"]["losses"])):
        return None, (f"LeNet fed by the pipeline differs from host-fed: "
                      f"losses {mnist_diff}, params {mnist_params}")
    if not parse_ok:
        return None, "parse_csv did not return the written records"
    if not csv_equal or len(csv_runs["records"]["losses"]) != CSV_STEPS:
        return None, (f"the record reader's MLP losses "
                      f"{csv_runs['records']['losses']} differ from the "
                      f"array-fed {csv_runs['arrays']['losses']}")
    if any(launches.values()):
        return None, f"phase 55 launched a kernel: {launches}"
    return None, None


def _blobs(seed):
    """KM_POINTS x KM_DIM points around KM_K centers; the second half of
    the blobs twice as wide."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KM_K, KM_DIM)) * KM_BLOB_SCALE
    which = rng.integers(0, KM_K, KM_POINTS)
    width = np.where(which < KM_K // 2, 1.0, 2.0)[:, None]
    return (centers[which] + width * rng.standard_normal(
        (KM_POINTS, KM_DIM))).astype(np.float32)


def _recorded(mod, name, log, keep=None):
    """Replace ``mod.name`` by a wrapper that keeps ``(args, result)`` of
    its calls (those numbered in ``keep``, or all) in the dict ``log`` by
    call number; returns the original."""
    real = getattr(mod, name)
    calls = [0]

    def wrapper(*a):
        out = real(*a)
        if keep is None or calls[0] in keep:
            log[calls[0]] = (a, out)
        calls[0] += 1
        return out

    setattr(mod, name, wrapper)
    return real


def _distance_tol(pts64) -> float:
    """How far an f32 distance from the expansion |x|^2 - 2xc + |c|^2
    can sit from the exact one: the cross term, a sum of D products,
    rounds by up to D ulps of max|x|^2 (the standard bound), the two
    norms by one each, and the square root turns an error e of d^2 near
    0 into sqrt(e) (a center that IS a point, as a split or a reseed
    makes it)."""
    d = pts64.shape[1]
    return math.sqrt((2 * d + 2) * 2.0 ** -24
                     * float((pts64 ** 2).sum(1).max()))


def _lloyd_errors(torch, pts64, pts_cpu, centers, assign, counts,
                  new_centers, avg_d=None, max_d=None):
    """One card Lloyd step against the CPU and float64 from its input
    ``centers``: untied assignments differing from the CPU's, count
    mismatches, the refreshed centers' error against the float64 means
    over the card's own assignment (relative to the largest |center|),
    and the per-cluster mean and max distances' absolute errors against
    float64 over that assignment."""
    import numpy as np
    from deeplearning4j_tpu_torch.clustering.neighbors import \
        pairwise_distance
    c = centers.cpu()
    c64 = c.double().numpy()
    a = assign.cpu()
    want = torch.argmin(pairwise_distance(pts_cpu, c), dim=1)
    diff = torch.nonzero(a != want)[:, 0].numpy()
    a, want = a.numpy(), want.numpy()
    p = pts64[diff]
    gap = np.abs(np.linalg.norm(p - c64[a[diff]], axis=1)
                 - np.linalg.norm(p - c64[want[diff]], axis=1))
    k = len(c64)
    n = np.bincount(a, minlength=k)
    ta = torch.as_tensor(a)
    sums = torch.zeros(c64.shape, dtype=torch.float64).index_add_(
        0, ta, torch.as_tensor(pts64)).numpy()
    live = n > 0
    means = np.where(live[:, None], sums / np.maximum(n, 1)[:, None], c64)
    out = {"differing": len(diff), "untied": int((gap > TOL_KM_TIE).sum()),
           "counts_wrong": int((counts.cpu().numpy() != n).sum()),
           "centers": float(np.abs(new_centers.cpu().double().numpy()
                                   - means).max() / np.abs(c64).max())}
    if avg_d is not None:
        d = np.linalg.norm(pts64 - c64[a], axis=1)
        avg = np.bincount(a, d, minlength=k) / np.maximum(n, 1)
        mx = torch.zeros(k, dtype=torch.float64).scatter_reduce_(
            0, ta, torch.as_tensor(d), "amax").numpy()
        out["avg_distance"] = float(np.abs(avg_d.cpu().numpy() - avg).max())
        out["max_distance"] = float(np.abs(max_d.cpu().numpy() - mx).max())
    return out


def clustering_phase(args, torch, dev, card):
    """Phase 56.  Returns ``(None, None)`` or ``(None, what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.clustering import (
        BarnesHutTsne, BaseClusteringAlgorithm, ClusteringOptimizationType,
        KMeans, OptimisationStrategy, Tsne)
    from deeplearning4j_tpu_torch.clustering import algorithm as alg_mod
    from deeplearning4j_tpu_torch.clustering import kmeans as km_mod
    from deeplearning4j_tpu_torch.clustering import tsne as tsne_mod

    t_phase = time.perf_counter()
    pts = _blobs(args.seed + 56)
    pts64 = pts.astype(np.float64)
    pts_cpu = torch.as_tensor(pts)
    tol_d = _distance_tol(pts64)
    out, errs = {}, []

    def worst(checks, key):
        return max(c[key] for c in checks)

    # KMeans: k-means++, then 20 Lloyd steps (tol 0: all 20 run)
    steps = {}
    real = _recorded(km_mod, "_lloyd_step", steps, set(KM_CHECKED_STEPS))
    try:
        t0 = time.perf_counter()
        cs = KMeans(KM_K, max_iterations=KM_ITERS, tol=0.0, seed=args.seed,
                    device=dev).fit(pts)
        torch.cuda.synchronize()
        km_s = time.perf_counter() - t0
    finally:
        km_mod._lloyd_step = real
    checks = []
    for i in sorted(steps):
        (_, centers, _), (new_c, assign, counts, cost, far) = steps[i]
        e = _lloyd_errors(torch, pts64, pts_cpu, centers, assign, counts,
                          new_c)
        c64 = centers.cpu().double().numpy()
        a = assign.cpu().numpy()
        d_cost = np.linalg.norm(pts64 - c64[a], axis=1).sum()
        e["cost"] = abs(float(cost) - d_cost) / d_cost
        checks.append(e)
    out["kmeans"] = {"points": list(pts.shape), "k": KM_K,
                     "iterations": cs.iterations, "cost": cs.cost,
                     "seconds": km_s, "checked_steps": sorted(steps),
                     "checks": checks}
    if cs.iterations != KM_ITERS:
        errs.append(f"KMeans ran {cs.iterations} iterations, not {KM_ITERS}")
    if worst(checks, "untied") or worst(checks, "counts_wrong") or \
            worst(checks, "centers") > TOL_KM_CENTERS or \
            worst(checks, "cost") > TOL_KM_CENTERS:
        errs.append(f"a KMeans step on the card differs from the CPU / "
                    f"float64: {checks}")

    # the strategy framework: split clusters whose mean distance > 16
    steps = {}
    real = _recorded(alg_mod, "_classify_and_refresh", steps)
    try:
        strat = OptimisationStrategy.setup(KM_K).optimize(
            ClusteringOptimizationType
            .MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE, KM_OPT_AVG)
        strat.optimize_when_iteration_count_multiple_of(KM_OPT_PERIOD)
        strat.end_when_iteration_count_equals(KM_OPT_ITERS)
        algo = BaseClusteringAlgorithm.setup(
            strat, seed=args.seed, max_iterations=KM_OPT_ITERS, device=dev)
        t0 = time.perf_counter()
        oc = algo.apply_to(pts)
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
    finally:
        alg_mod._classify_and_refresh = real
    opt_checks = []
    for (_, centers, _, _), res in (steps[0], steps[max(steps)]):
        new_c, assign, counts, avg_d, max_d = res[:5]
        opt_checks.append(_lloyd_errors(
            torch, pts64, pts_cpu, centers, assign, counts, new_c,
            avg_d=avg_d, max_d=max_d))
    applied = sum(i.strategy_applied for i in algo.history.iterations.values())
    out["optimisation_strategy"] = {
        "target": f"MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE {KM_OPT_AVG}",
        "clusters": [KM_K, len(oc.centers)], "iterations": oc.iterations,
        "strategy_applied": applied, "cost": oc.cost, "seconds": opt_s,
        "checks_first_and_last_step": opt_checks, "tol_distance": tol_d}
    if applied == 0 or worst(opt_checks, "untied") or \
            worst(opt_checks, "counts_wrong") or \
            worst(opt_checks, "centers") > TOL_KM_CENTERS or \
            max(worst(opt_checks, k) for k in
                ("avg_distance", "max_distance")) > tol_d:
        errs.append(f"the OptimisationStrategy run: {opt_checks}, "
                    f"{applied} splits")

    # exact t-SNE: 300 iterations on the card, checked steps on the CPU
    rng = np.random.default_rng(args.seed + 560)
    x = rng.standard_normal((TSNE_N, TSNE_DIM)).astype(np.float32)
    cal, grads, updates = {}, {}, {}
    keep = set(TSNE_CHECKED_STEPS)
    reals = [(name, _recorded(tsne_mod, name, log, k)) for name, log, k in
             (("_calibrate_p", cal, None), ("_tsne_grad_exact", grads, keep),
              ("_gd_update", updates, keep))]
    try:
        ts = Tsne(perplexity=TSNE_PERPLEXITY, max_iter=TSNE_ITERS,
                  seed=args.seed, device=dev)
        t0 = time.perf_counter()
        y_card = ts.fit(x)
        torch.cuda.synchronize()
        tsne_s = time.perf_counter() - t0
    finally:
        for name, real in reals:
            setattr(tsne_mod, name, real)
    (d2, perp), p_card = cal[0]
    rows = np.arange(0, TSNE_N, TSNE_N // TSNE_CHECKED_ROWS)
    p_cpu = tsne_mod._calibrate_p(d2[rows].cpu(), perp)
    p_err = ((p_card[rows].cpu() - p_cpu).abs().max()
             / p_cpu.max()).item()
    t_checks = []
    for i in TSNE_CHECKED_STEPS:
        (y, p_eff), (g_card, kl_card) = grads[i]
        g_cpu, kl_cpu = tsne_mod._tsne_grad_exact(y.cpu(), p_eff.cpu())
        (y_u, g_u, vel, gains, lr, mom), y_next = updates[i]
        u_cpu = tsne_mod._gd_update(y_u.cpu(), g_u.cpu(), vel.cpu(),
                                    gains.cpu(), lr, mom)
        t_checks.append({
            "step": i,
            "grad": ((g_card.cpu() - g_cpu).abs().max()
                     / g_cpu.abs().max()).item(),
            "kl": abs(float(kl_card) - float(kl_cpu)) / abs(float(kl_cpu)),
            "update": max(((a.cpu() - b).abs().max()
                           / b.abs().max().clamp(min=1e-30)).item()
                          for a, b in zip(y_next, u_cpu))})
    del cal, grads, updates, d2, p_card
    yt = torch.as_tensor(y_card, device=dev)
    pt = torch.full((TSNE_N, TSNE_N), 1.0 / TSNE_N ** 2, device=dev)
    vel, gains = torch.zeros_like(yt), torch.ones_like(yt)

    def step():
        g, _ = tsne_mod._tsne_grad_exact(yt, pt)
        tsne_mod._gd_update(yt, g, vel, gains, 100.0, 0.8)
    step_ms = median_ms(step, torch, runs=10)
    del pt
    out["tsne_exact"] = {
        "n": TSNE_N, "dim": TSNE_DIM, "perplexity": TSNE_PERPLEXITY,
        "iterations": TSNE_ITERS, "kl": ts.kl_divergence,
        "seconds": tsne_s, "step_ms": step_ms,
        "p_rows_checked": len(rows), "p_max_rel_err": p_err,
        "checked_steps": t_checks,
        "tol": {"p": TOL_TSNE_P, "grad": TOL_TSNE_GRAD, "kl": TOL_TSNE_KL,
                "update": TOL_TSNE_Y}}
    if not (np.isfinite(y_card).all() and math.isfinite(ts.kl_divergence)):
        errs.append("exact t-SNE gave a non-finite embedding or KL")
    if p_err > TOL_TSNE_P or worst(t_checks, "grad") > TOL_TSNE_GRAD or \
            worst(t_checks, "kl") > TOL_TSNE_KL or \
            worst(t_checks, "update") > TOL_TSNE_Y:
        errs.append(f"exact t-SNE on the card vs the CPU: P {p_err}, "
                    f"steps {t_checks}")

    # Barnes-Hut: kNN and calibration on the card, SPTree on the host
    t0 = time.perf_counter()
    bh = BarnesHutTsne(perplexity=TSNE_PERPLEXITY, max_iter=BH_ITERS,
                       seed=args.seed, device=dev)
    yb = bh.fit(x[:BH_N])
    out["tsne_barnes_hut"] = {"n": BH_N, "iterations": BH_ITERS,
                              "kl": bh.kl_divergence,
                              "seconds": time.perf_counter() - t0}
    if not (np.isfinite(yb).all() and math.isfinite(bh.kl_divergence)):
        errs.append("Barnes-Hut t-SNE gave a non-finite embedding or KL")
    print(json.dumps({"phase": "clustering", **out,
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return None, (errs[0] if errs else None)


def pipeline_data_clustering_phases(args, torch, dev, card):
    """Phases 54-56.  Returns ``(bn_apply launches per step of phase 54's
    pipeline run, None)`` or ``(None, what failed)``."""
    t0 = time.perf_counter()
    launches, err = cifar_pipeline_phase(args, torch, dev, card)
    if err:
        return None, err
    torch.cuda.empty_cache()
    for phase in (mnist_records_phase, clustering_phase):
        _, err = phase(args, torch, dev, card)
        if err:
            return None, err
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "pipeline_data_clustering_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return launches, None


# ---- 57-59: the embedding family (nlp/, graph/) -------------------------
# 57: the repo's own word2vec_words_per_sec configuration (the JAX
# package's utils/benchmarks.py:162): 20,000 Zipf(1.3) sentences of 20
# words over a 5,000-word vocabulary (_zipf_sentences, seed 0), skip-gram
# NS, layer 128, window 5, negative 5, seed 1, one epoch, through the bulk
# path with the native index_corpus.
W2V_VOCAB, W2V_SENTS, W2V_LEN = 5000, 20000, 20
W2V_KW = dict(layer_size=128, window=5, negative=5, epochs=1, seed=1,
              min_word_frequency=1)
W2V_STEADY_RUNS = 3
# The benchmark's corpus gives w0 a quarter of all tokens, so a step of
# 512 rows sums ~400 stale updates into its rows: the first block grows
# unstable after ~100 of its 256 steps in both packages (the JAX package's
# tables reach |x| ~ 4e5 by its end, f32 and f64 runs of the same inputs
# part by 2e-4 at step 96 and by 25 at step 128, measured on the CPU).
# The block is held against its CPU twin over its first W2V_TWIN_STEPS
# steps, where f32 rounding (~6e-6) is what separates the runs, and is
# re-run whole on the card, which must give the fit's bits.
W2V_TWIN_STEPS = 64
# A card fit or block against its CPU twin (f32, the scatter branch: the
# duplicate sums in another order than the card's one-hot product) is
# gated at W2V_FLOOR_K times the f32 rounding floor of the same run, the
# CPU twin's distance from a float64 twin of the same inputs (the f32
# deviations of two f32 runs from the f64 one add up to at most ~2x the
# larger), and never below one f32 ulp of the largest entry.
W2V_FLOOR_K = 4.0
# the smaller fits (CBOW-NS, skip-gram HS, CBOW HS, PV-DBOW, PV-DM with
# infer_vector) on the first sentences of the same corpus, GloVe on fewer
# (its cooccurrence count is a host dict)
W2V_SMALL_SENTS, GLOVE_SENTS = 1000, 300
# one fit whose vocabulary takes _table_add's scatter branch (V > 65,536)
# at the Google News vectors' width: half of the tokens Zipf(1.3) as
# above, half uniform over BIG_UNIFORM words, so that nearly every word
# of the uniform half occurs (~4 times each)
BIG_UNIFORM, BIG_SENTS, BIG_LAYER = 72000, 30000, 300
# 58: two worker processes on the card against the thread version
W2V_MP_SENTS = 4000
# both averages are the mean of the same two shard fits, each run on the
# card by the same deterministic steps (threads in this process, or a
# worker process each): 2e-6, the CPU tests' JAX-vs-port bound, leaves
# room for a different cuBLAS choice in another process
TOL_W2V_WORKERS = 2e-6
# 59: a seeded synthetic graph of BlogCatalog's size (DeepWalk paper
# section 6.1: 10,312 vertices, 333,983 edges), endpoints drawn with
# probability ~ rank^-0.5 (max degree ~3,300; BlogCatalog's is 3,992),
# walk length 40, window 10, layer 128.  DeepWalk takes one walk per
# vertex (the paper: 80); Node2Vec walks from the first N2V_START_VERTICES
# start vertices of its pass (its second-order step is host work).
BLOG_N, BLOG_M, BLOG_EXPONENT = 10312, 333983, 0.5
BLOG_WALK, BLOG_WINDOW, BLOG_LAYER = 40, 10, 128
N2V_START_VERTICES, N2V_P, N2V_Q = 1000, 1.0, 0.5


def _zipf_ids(rng, vocab, n):
    import numpy as np
    return np.clip(rng.zipf(1.3, size=n), 1, vocab) - 1


def zipf_sentences(vocab, n_sent, sent_len):
    """The JAX package's benchmark corpus (``utils/benchmarks.py``
    ``_zipf_sentences``): the same sentences."""
    import numpy as np
    rng = np.random.default_rng(0)
    toks = ["w%d" % i for i in _zipf_ids(rng, vocab, n_sent * sent_len)]
    return [" ".join(toks[i * sent_len:(i + 1) * sent_len])
            for i in range(n_sent)]


def _big_vocab_sentences(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    n = BIG_SENTS * W2V_LEN
    ids = np.where(rng.random(n) < 0.5, _zipf_ids(rng, W2V_VOCAB, n),
                   rng.integers(0, BIG_UNIFORM, n))
    toks = ["w%d" % i for i in ids]
    return [" ".join(toks[i * W2V_LEN:(i + 1) * W2V_LEN])
            for i in range(BIG_SENTS)]


class _BlockTap:
    """Wraps an S-step function of ``nlp/sequence_vectors``: counts its
    calls (the dispatch blocks) and, while ``capture`` is set, keeps host
    copies of the first call's arguments (taken before the call, which
    updates the tables in place) and results."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.real = getattr(mod, name)
        self.calls, self.capture, self.first = 0, False, None
        setattr(mod, name, self)

    def __call__(self, *a, **k):
        keep = self.capture and self.first is None
        if keep:
            args = [x.cpu().clone() if hasattr(x, "cpu") else x for x in a]
        out = self.real(*a, **k)
        if keep:
            self.first = (args, dict(k), [t.cpu().clone() for t in out])
        self.calls += 1
        return out

    def restore(self):
        setattr(self.mod, self.name, self.real)


class _ScatterBranch:
    """``_table_add`` on its scatter branch for the ``with`` body."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.nlp import elements
        self.prev = elements._DENSE_TABLE_MAX_V
        elements._DENSE_TABLE_MAX_V = 0

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch.nlp import elements
        elements._DENSE_TABLE_MAX_V = self.prev


def _tables(model):
    lt = model.lookup_table
    return {n: getattr(lt, n).detach().cpu().clone()
            for n in ("syn0", "syn1", "syn1neg")
            if getattr(lt, n) is not None}


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[n].double() - b[n].double()).abs().max()) for n in a)


def _floor_gate(cpu32: dict, cpu64: dict) -> float:
    floor = _max_diff(cpu32, cpu64)
    top = max(float(t.abs().max()) for t in cpu64.values())
    return max(W2V_FLOOR_K * floor, 2.0 ** -23 * top), floor


def _block_twin(torch, tap, dev):
    """The first captured block: re-run whole on the card (its bits must
    be the fit's), and its first W2V_TWIN_STEPS steps on the card beside
    the CPU, f32 and f64, on the scatter branch."""
    args, kw, out = tap.first
    names = [f"t{i}" for i in range(len(out))]

    def run(device, dtype, steps):
        a = [x.to(device) if hasattr(x, "to") else x for x in args]
        for i in range(len(out)):
            a[i] = a[i].to(dtype).clone()
        if device == "cpu":
            with _ScatterBranch():
                res = tap.real(*a, **dict(kw, active=steps))
        else:
            res = tap.real(*a, **dict(kw, active=steps))
        return dict(zip(names, (r.cpu() for r in res)))
    whole = run(dev, torch.float32, None)
    same = all(torch.equal(whole[n], o) for n, o in zip(names, out))
    card = run(dev, torch.float32, W2V_TWIN_STEPS)
    cpu32 = run("cpu", torch.float32, W2V_TWIN_STEPS)
    cpu64 = run("cpu", torch.float64, W2V_TWIN_STEPS)
    gate, floor = _floor_gate(cpu32, cpu64)
    return {"steps": int(args[3].shape[0]), "rows_per_step":
            int(args[3].shape[1]), "rerun_bitwise_equal": same,
            "twin_steps": W2V_TWIN_STEPS,
            "max_abs_err": _max_diff(card, cpu32), "gate": gate,
            "f32_floor": floor}


def _to_f64(model):
    lt = model.lookup_table
    for n in ("syn0", "syn1", "syn1neg"):
        if getattr(lt, n) is not None:
            setattr(lt, n, getattr(lt, n).double())


def _kernel_spans(prof):
    """(kernel launches, busy microseconds) of a card-only trace: the
    kernels counted, the union of kernel and copy intervals summed."""
    spans, kernels = [], 0
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" not in str(ev.device_type()):
            continue
        spans.append((ev.start_ns() / 1e3, ev.end_ns() / 1e3))
        name = ev.name().lower()
        if "memcpy" not in name and "memset" not in name:
            kernels += 1
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return kernels, busy


def _timed_fit(torch, model):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled_fit(torch, model, tap):
    """One more fit under a card-only ``torch.profiler`` trace: kernel
    launches per dispatch block and the card's busy share of the fit."""
    from torch.profiler import ProfilerActivity, profile
    model.lookup_table.reset_weights()
    torch.cuda.synchronize()
    calls = tap.calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _timed_fit(torch, model)
    blocks = tap.calls - calls
    kernels, busy_us = _kernel_spans(prof)
    return {"blocks": blocks, "launches_per_block": kernels / max(blocks, 1),
            "busy_share": busy_us / 1e6 / wall, "profiled_wall_s": wall}


def _twin_fit(torch, make, dev, words, infer_text=None):
    """A fit on the card (timed) beside its CPU twins: f32 on the scatter
    branch and f64.  ``make(device)`` builds the unfitted model."""
    card = make(dev)
    card.build_vocab()
    wall = _timed_fit(torch, card)
    res = {"words_per_sec": words / wall, "seconds": wall,
           "vocab": card.vocab.num_words()}
    twins = {}
    for dtype in ("float32", "float64"):
        m = make("cpu")
        m.build_vocab()
        if dtype == "float64":
            _to_f64(m)
        with _ScatterBranch():
            m.fit()
        twins[dtype] = m
    t_card = _tables(card)
    t32, t64 = _tables(twins["float32"]), _tables(twins["float64"])
    gate, floor = _floor_gate(t32, t64)
    res.update(max_abs_err=_max_diff(t_card, t32), gate=gate, f32_floor=floor)
    ok = res["max_abs_err"] <= gate
    if infer_text is not None:
        import numpy as np
        v = {k: m.infer_vector(infer_text) for k, m in
             (("card", card), ("cpu32", twins["float32"]),
              ("cpu64", twins["float64"]))}
        err = float(np.abs(v["card"] - v["cpu32"]).max())
        vfloor = float(np.abs(v["cpu32"] - v["cpu64"]).max())
        vgate = max(W2V_FLOOR_K * vfloor,
                    2.0 ** -23 * float(np.abs(v["cpu64"]).max()))
        res["infer_vector"] = {"max_abs_err": err, "gate": vgate,
                               "finite": bool(np.isfinite(v["card"]).all())}
        ok = ok and err <= vgate and res["infer_vector"]["finite"]
    return res, ok


def _glove_twin(torch, sents, dev, seed):
    from deeplearning4j_tpu_torch.nlp import Glove
    out = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu32", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        g = Glove(sentences=sents, layer_size=W2V_KW["layer_size"],
                  window=W2V_KW["window"], epochs=5, seed=seed,
                  dtype=dtype, device=device)
        wall = _timed_fit(torch, g)
        out[name] = ({"syn0": g.lookup_table.syn0.cpu()}, wall)
    gate, floor = _floor_gate(out["cpu32"][0], out["cpu64"][0])
    err = _max_diff(out["card"][0], out["cpu32"][0])
    words = sum(len(s.split()) for s in sents) * 5
    return ({"words_per_sec": words / out["card"][1], "max_abs_err": err,
             "gate": gate, "f32_floor": floor}, err <= gate)


def _table_add_times(torch, dev, vocab, table, rows):
    """``_table_add`` on both branches at the main fit's shape: syn1neg's
    update (B rows x (K + 1) negatives, idx drawn from the unigram table)
    and syn0's (B rows)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp import elements
    rng = np.random.default_rng(57)
    d = W2V_KW["layer_size"]
    tab = torch.zeros((vocab, d), device=dev)
    out = {}
    for what, n in (("syn1neg", rows * (W2V_KW["negative"] + 1)),
                    ("syn0", rows)):
        idx = torch.as_tensor(table[rng.integers(0, len(table), n)],
                              device=dev).long()
        upd = torch.randn((n, d), device=dev) * 1e-3
        dense = median_ms(lambda: elements._table_add(tab, idx, upd), torch)
        with _ScatterBranch():
            scatter = median_ms(lambda: elements._table_add(tab, idx, upd),
                                torch)
        out[what] = {"rows": n, "dense_ms": dense, "scatter_ms": scatter}
    return out


def word2vec_phase(args, torch, dev, card):
    """Phase 57.  Returns ``(None, None)`` or ``(None, what failed)``.
    Runs with the process's TF32 switch ON, as a user's process may set
    it: the one-hot products must keep f32 on their own."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return _word2vec_runs(args, torch, dev, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _word2vec_runs(args, torch, dev, card):
    from deeplearning4j_tpu_torch.nlp import (LabelledDocument,
                                              ParagraphVectors, Word2Vec)
    from deeplearning4j_tpu_torch.nlp import sequence_vectors as sv
    from deeplearning4j_tpu_torch.utils import native

    t_phase = time.perf_counter()
    if not native.available():
        return None, "the native corpus indexer (csrc/host_codec.cpp) " \
                     "did not build"
    sents = zipf_sentences(W2V_VOCAB, W2V_SENTS, W2V_LEN)
    words = W2V_SENTS * W2V_LEN * W2V_KW["epochs"]
    out, errs = {"corpus_words": words}, []
    tap = _BlockTap(sv, "skipgram_steps_ns")
    try:
        model = Word2Vec(sentences=sents, device=dev, **W2V_KW)
        model.build_vocab()
        if model._try_native_index(model.vocab.index_map()) is None:
            return None, "the bulk path did not take the native index"
        tap.capture = True
        cold = _timed_fit(torch, model)
        tap.capture = False
        first = _tables(model)
        same = True
        rates = []
        for _ in range(W2V_STEADY_RUNS):
            model.lookup_table.reset_weights()
            rates.append(words / _timed_fit(torch, model))
            again = _tables(model)
            same = same and all(torch.equal(first[n], again[n])
                                for n in first)
        out.update(cold_words_per_sec=words / cold,
                   steady_words_per_sec=statistics.median(rates),
                   steady_runs=rates, vocab=model.vocab.num_words(),
                   rows_per_step=model._rows_per_step(),
                   refits_bitwise_equal=same)
        out.update(_profiled_fit(torch, model, tap))
        blk = out["first_block"] = _block_twin(torch, tap, dev)
        out["table_add"] = _table_add_times(
            torch, dev, model.vocab.num_words(), model.lookup_table.table,
            model._rows_per_step())
        if not same:
            errs.append("re-fits of the same seed gave different tables")
        if blk["max_abs_err"] > blk["gate"] or not blk["rerun_bitwise_equal"]:
            errs.append(f"first block vs its CPU twin or its re-run: {blk}")
        if not all(torch.isfinite(t).all() for t in first.values()):
            errs.append("word2vec tables are not finite")
    finally:
        tap.restore()

    # the other bulk paths, each beside its CPU twins
    small = sents[:W2V_SMALL_SENTS]
    small_words = len(small) * W2V_LEN
    docs = [LabelledDocument(s, ["DOC_%d" % i]) for i, s in enumerate(small)]
    fits = {
        "cbow_ns": lambda d: Word2Vec(sentences=small, device=d,
                                      elements_algorithm="cbow", **W2V_KW),
        "skipgram_hs": lambda d: Word2Vec(
            sentences=small, device=d, **dict(W2V_KW, negative=0),
            use_hierarchic_softmax=True),
        "cbow_hs": lambda d: Word2Vec(
            sentences=small, device=d, **dict(W2V_KW, negative=0),
            use_hierarchic_softmax=True, elements_algorithm="cbow"),
        "pv_dbow": lambda d: ParagraphVectors(
            documents=docs, device=d, sequence_algorithm="dbow", **W2V_KW),
        "pv_dm": lambda d: ParagraphVectors(
            documents=docs, device=d, sequence_algorithm="dm", **W2V_KW),
    }
    for name, make in fits.items():
        res, ok = _twin_fit(torch, make, dev, small_words,
                            infer_text=small[7] if name == "pv_dm" else None)
        out[name] = res
        if not ok:
            errs.append(f"{name} vs its CPU twin: {res}")
    res, ok = _glove_twin(torch, sents[:GLOVE_SENTS], dev, W2V_KW["seed"])
    out["glove"] = res
    if not ok:
        errs.append(f"glove vs its CPU twin: {res}")

    # the scatter branch at a vocabulary above _DENSE_TABLE_MAX_V
    big = _big_vocab_sentences(args.seed + 57)
    distinct = len({t for s in big for t in s.split()})
    big_kw = dict(W2V_KW, layer_size=BIG_LAYER)
    tap = _BlockTap(sv, "skipgram_steps_ns")
    try:
        m = Word2Vec(sentences=big, device=dev, **big_kw)
        m.build_vocab()
        tap.capture = True
        wall = _timed_fit(torch, m)
        tap.capture = False
        t1 = _tables(m)
        m.lookup_table.reset_weights()
        _timed_fit(torch, m)
        same = all(torch.equal(t1[n], v) for n, v in _tables(m).items())
        blk = _block_twin(torch, tap, dev)
    finally:
        tap.restore()
    from deeplearning4j_tpu_torch.nlp import elements
    out["scatter_fit"] = {
        "distinct_words": distinct, "vocab": m.vocab.num_words(),
        "layer_size": BIG_LAYER, "corpus_words": BIG_SENTS * W2V_LEN,
        "branch": "scatter" if m.vocab.num_words()
        > elements._DENSE_TABLE_MAX_V else "dense",
        "words_per_sec": BIG_SENTS * W2V_LEN / wall, "seconds": wall,
        "refit_bitwise_equal": same, "first_block": blk}
    if out["scatter_fit"]["branch"] != "scatter":
        errs.append(f"the large vocabulary ({distinct} words) did not take "
                    "the scatter branch")
    if not same:
        errs.append("two fits on the scatter branch gave different tables")
    if blk["max_abs_err"] > blk["gate"] or not blk["rerun_bitwise_equal"]:
        errs.append(f"scatter fit's first block vs its CPU twin or its "
                    f"re-run: {blk}")
    print(json.dumps({"phase": "word2vec", **out,
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return None, (errs[0] if errs else None)


def word2vec_processes_phase(args, torch, dev, card):
    """Phase 58.  Returns ``(None, None)`` or ``(None, what failed)``."""
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                              Word2Vec, read_binary,
                                              read_full_model,
                                              read_word_vectors, write_binary,
                                              write_full_model,
                                              write_word_vectors)
    from deeplearning4j_tpu_torch.nlp.distributed_vectors import (
        Word2VecProcessMaster, train_word2vec_distributed)

    t_phase = time.perf_counter()
    sents = zipf_sentences(W2V_VOCAB, W2V_SENTS, W2V_LEN)
    shard, more = sents[:W2V_MP_SENTS], sents[W2V_MP_SENTS:2 * W2V_MP_SENTS]
    out, errs = {}, []
    t0 = time.perf_counter()
    threads = train_word2vec_distributed(shard, num_workers=2, device=dev,
                                         **W2V_KW)
    torch.cuda.synchronize()
    out["threads_seconds"] = time.perf_counter() - t0
    model = Word2Vec(sentences=shard, device=dev, **W2V_KW)
    master = Word2VecProcessMaster(num_workers=2, timeout=600.0)
    with tempfile.TemporaryDirectory() as jobdir:
        t0 = time.perf_counter()
        master.fit(model, jobdir=jobdir)
        out["processes_seconds"] = time.perf_counter() - t0
    diff = _max_diff(_tables(model), _tables(threads))
    results = master.last_results
    foreign = sorted({p for r in results for p in r["packages"]}
                     & {"jax", "jaxlib", "deeplearning4j_tpu"})
    out.update(workers=[{"wid": r["wid"], "device": r["device"],
                         "words_per_sec": r["words_per_sec"]}
                        for r in results],
               max_abs_err_vs_threads=diff, tol=TOL_W2V_WORKERS,
               foreign_packages_in_workers=foreign)
    if diff > TOL_W2V_WORKERS:
        errs.append(f"process workers vs threads {diff}")
    if foreign or not all(r["device"].startswith("cuda") for r in results):
        errs.append(f"a worker ran off the card or loaded {foreign}")

    # the formats: a full model resumes training as the model it was
    # written from; the text and binary vectors read back
    with tempfile.TemporaryDirectory() as d:
        full = os.path.join(d, "w2v.zip")
        write_full_model(threads, full)
        back = read_full_model(full, device=dev)
        for m in (threads, back):
            m.sentence_iterator = CollectionSentenceIterator(more)
            m.fit()
        resumed = _max_diff(_tables(back), _tables(threads))
        write_word_vectors(threads, os.path.join(d, "v.txt"))
        write_binary(threads, os.path.join(d, "v.bin"))
        syn0 = threads.lookup_table.syn0.cpu().numpy()
        txt = read_word_vectors(os.path.join(d, "v.txt"), device=dev)
        binf = read_binary(os.path.join(d, "v.bin"), device=dev)
        txt_err = float(np.abs(txt.lookup_table.syn0.cpu().numpy()
                               - syn0).max())
        bin_same = bool((binf.lookup_table.syn0.cpu().numpy() == syn0).all())
    out.update(full_model_resume_max_abs_err=resumed,
               text_max_abs_err=txt_err, binary_bitwise_equal=bin_same)
    # the text format prints 6 decimals (half a unit of the last) and
    # reads them back into f32 (half an ulp of the entry)
    txt_tol = 5e-7 + 2.0 ** -23 * float(np.abs(syn0).max())
    out["text_tol"] = txt_tol
    if resumed != 0.0 or txt_err > txt_tol or not bin_same:
        errs.append(f"formats: resume {resumed}, text {txt_err}, binary "
                    f"{bin_same}")
    print(json.dumps({"phase": "word2vec_processes", **out,
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return None, (errs[0] if errs else None)


def blog_graph(seed):
    """The synthetic BlogCatalog-sized graph (see BLOG_*)."""
    import numpy as np
    from deeplearning4j_tpu_torch.graph import Graph
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, BLOG_N + 1) ** BLOG_EXPONENT
    w /= w.sum()
    perm = rng.permutation(BLOG_N)
    src = perm[rng.choice(BLOG_N, size=BLOG_M, p=w)]
    dst = perm[rng.choice(BLOG_N, size=BLOG_M, p=w)]
    g = Graph(BLOG_N)
    for a, b in zip(src.tolist(), dst.tolist()):
        g.add_edge(a, b)
    return g


class _FirstWalks:
    """The first ``n`` walks of each pass of a walk iterator."""

    def __init__(self, walks, n):
        self.walks, self.n = walks, n

    def __iter__(self):
        import itertools
        return itertools.islice(iter(self.walks), self.n)


def deepwalk_phase(args, torch, dev, card):
    """Phase 59.  Returns ``(None, None)`` or ``(None, what failed)``."""
    from deeplearning4j_tpu_torch.graph import (DeepWalk, Node2Vec,
                                                Node2VecWalkIterator,
                                                RandomWalkIterator)
    from deeplearning4j_tpu_torch.nlp import sequence_vectors as sv

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = blog_graph(args.seed + 59)
    deg = g.degrees()
    out = {"graph": {"vertices": g.num_vertices(), "edges": BLOG_M,
                     "max_degree": int(deg.max()),
                     "build_seconds": time.perf_counter() - t0},
           "walk_length": BLOG_WALK, "window": BLOG_WINDOW,
           "layer_size": BLOG_LAYER}
    errs = []
    tap = _BlockTap(sv, "skipgram_steps_hs")
    try:
        dw = DeepWalk(vector_size=BLOG_LAYER, window_size=BLOG_WINDOW,
                      seed=args.seed, device=dev)
        dw.initialize(g)
        before = dw.lookup_table.syn0.clone()
        res = _profiled_walk_fit(torch, dw, tap, RandomWalkIterator(
            g, BLOG_WALK, seed=args.seed))
        res.update(walks_per_vertex=1, walks_per_vertex_published=80,
                   words=BLOG_N * (BLOG_WALK + 1),
                   code_length_max=max(vw.code_length
                                       for vw in dw.vocab.vocab_words()))
        res["words_per_sec"] = res["words"] / res["seconds"]
        out["deepwalk"] = res
        moved = float((dw.lookup_table.syn0 - before).abs().max())
        if not (torch.isfinite(dw.lookup_table.syn0).all() and moved > 0):
            errs.append("DeepWalk's vectors are not finite or did not move")
        n2v = Node2Vec(vector_size=BLOG_LAYER, window_size=BLOG_WINDOW,
                       p=N2V_P, q=N2V_Q, seed=args.seed, device=dev)
        n2v.initialize(g)
        res = _profiled_walk_fit(torch, n2v, tap, _FirstWalks(
            Node2VecWalkIterator(g, BLOG_WALK, p=N2V_P, q=N2V_Q,
                                 seed=args.seed), N2V_START_VERTICES))
        res.update(start_vertices=N2V_START_VERTICES, p=N2V_P, q=N2V_Q,
                   words=N2V_START_VERTICES * (BLOG_WALK + 1))
        res["words_per_sec"] = res["words"] / res["seconds"]
        out["node2vec"] = res
        if not torch.isfinite(n2v.lookup_table.syn0).all():
            errs.append("Node2Vec's vectors are not finite")
    finally:
        tap.restore()
    print(json.dumps({"phase": "deepwalk", **out,
                      "seconds": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return None, (errs[0] if errs else None)


def _profiled_walk_fit(torch, model, tap, walks):
    """A graph model's fit on ``walks`` (drawn inside the fit) under a
    card-only trace: seconds, HS blocks, launches per block, the card's
    busy share."""
    from torch.profiler import ProfilerActivity, profile
    calls = tap.calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(walks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    blocks = tap.calls - calls
    kernels, busy_us = _kernel_spans(prof)
    return {"seconds": wall, "hs_blocks": blocks,
            "launches_per_block": kernels / max(blocks, 1),
            "busy_share": busy_us / 1e6 / wall}


def embedding_phases(args, torch, dev, card):
    """Phases 57-59.  Returns ``(None, None)`` or ``(None, what
    failed)``."""
    t0 = time.perf_counter()
    for phase in (word2vec_phase, word2vec_processes_phase, deepwalk_phase):
        _, err = phase(args, torch, dev, card)
        if err:
            return None, err
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "embedding_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return None, None


# ---- 60-62. the last modules: the training UI, the Kafka wire, generation
UI_STEPS = 5                    # listened fit steps, checked record by record
UI_TIMED_STEPS = 8              # steps timed with and without the listener
UI_PROFILED_STEPS = 3           # steps traced with and without it (D2H count)
UI_BINS = 20
# A recorded scalar against float64 numpy on a host copy of the same f32
# tensor: the card reduces up to 4.2 M f32 values (the embedding), a tree
# of ~22 levels, ~1e-6 relative at worst; the mean, which cancels
# towards 0, is held relative to the mean magnitude.  min and max are
# exact, and so is the histogram (the same f32 formula in numpy).
TOL_UI_SCALAR = 1e-5
KAFKA_BATCHES = 4
GEN_LSTM_BATCH, GEN_LSTM_PROMPT, GEN_LSTM_TOKENS = 32, 16, 128
GEN_TEMPERATURE = 0.8
ROUTE_BATCHES = 3
GEN_LM_BATCH, GEN_LM_PROMPT, GEN_LM_TOKENS = 4, 448, 64


def host_stats(x) -> dict:
    """What ``ui.StatsListener`` records for the f32 array ``x``,
    recomputed on the host: the histogram with the listener's own f32
    formula, the scalars in float64."""
    import numpy as np
    x = np.asarray(x, np.float32).reshape(-1)
    lo, hi = x.min(), x.max()
    width = np.maximum(hi - lo, np.float32(1e-12))
    idx = np.clip(((x - lo) / width * np.float32(UI_BINS)).astype(np.int32),
                  0, UI_BINS - 1)
    x64 = x.astype(np.float64)
    return {"mean": x64.mean(), "std": x64.std(), "min": float(lo),
            "max": float(hi), "mean_magnitude": np.abs(x64).mean(),
            "norm2": float(np.sqrt((x64 * x64).sum())),
            "hist": np.bincount(idx, minlength=UI_BINS).tolist()}


def stats_errors(got: dict, want: dict) -> tuple:
    """(largest scalar error relative to ``want``'s scale, histograms
    equal)."""
    scale = max(want["mean_magnitude"], 1e-30)
    err = max(abs(got[k] - want[k]) / max(abs(want[k]), scale)
              for k in ("mean", "std", "min", "max", "mean_magnitude",
                        "norm2"))
    return err, got["hist"] == want["hist"]


def d2h_copies(prof) -> int:
    """Device-to-host copies in a card-only ``torch.profiler`` trace (the
    raw kineto events)."""
    return sum(1 for ev in prof.profiler.kineto_results.events()
               if "CUDA" in str(ev.device_type())
               and "dtoh" in ev.name().lower())


def _get_json(url: str):
    from urllib.request import urlopen
    with urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def ui_train_phase(args, torch, dev, card):
    """Phase 60.  Returns ``((the trained net, its seeded tree, flash
    launches), None)`` or ``(None, what failed)``."""
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                             RemoteUIStatsStorageRouter,
                                             StatsListener, UIServer)
    from deeplearning4j_tpu_torch.utils.model_guesser import load_model_guess

    class Tee:
        """The listener's router: the served log and the remote UI."""

        def __init__(self, *routers):
            self.routers = routers

        def put_record(self, report):
            for r in self.routers:
                r.put_record(report)

    class HostCopies(TrainingListener):
        """After the stats listener: a host copy of every param and the
        score, for the host recomputation (the checked run only)."""

        def __init__(self):
            self.params, self.scores = [], []

        def iteration_done(self, model, iteration, epoch):
            # a copy: the step updates the params in place
            self.params.append({f"{k}/{n}": p.detach().cpu().numpy().copy()
                                for k, g in model.params.items()
                                for n, p in g.items()})
            self.scores.append(model.get_score())

    t_phase = time.perf_counter()
    store = REPO / "build" / "ui_train"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    tree = _lm_tree(args, dev, 60)
    net = _lm_net(args, dev, tree)
    batches = _lm_batches(args, 60, UI_STEPS + UI_PROFILED_STEPS * 2
                          + UI_TIMED_STEPS + 2)
    log = FileStatsStorage(str(store / "stats.bin"))
    ui = UIServer(port=0).start()
    ui.attach(log)
    remote = UIServer(port=0).start()
    router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{remote.port}")
    tee = Tee(log, router)
    try:
        # the checked run: 5 listened steps, every record recomputed
        copies = HostCopies()
        net.set_listeners(StatsListener(tee, session_id="ui_train"), copies)
        torch.cuda.synchronize()
        fa.reset_launches()
        for x, y in batches[:UI_STEPS]:
            net.fit(x, y)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        recs = log.get_records("ui_train")
        if len(recs) != UI_STEPS or [r.iteration for r in recs] != \
                list(range(1, UI_STEPS + 1)):
            return None, f"ui_train: records {[r.iteration for r in recs]}"
        worst, hists, arrays = 0.0, True, 0
        for i, rec in enumerate(recs):
            if rec.score != copies.scores[i]:
                return None, (f"ui_train: score {rec.score} != "
                              f"{copies.scores[i]} at {rec.iteration}")
            now = copies.params[i]
            if set(rec.param_stats) != set(now) or \
                    set(rec.update_stats) != (set(now) if i else set()):
                return None, "ui_train: recorded names differ from params"
            for name, arr in now.items():
                for got, x in ((rec.param_stats[name], arr),) + (
                        ((rec.update_stats[name],
                          arr - copies.params[i - 1][name]),) if i else ()):
                    err, same = stats_errors(got, host_stats(x))
                    worst, hists = max(worst, err), hists and same
                    arrays += 1
        mem = recs[-1].memory
        # the listener's one copy a step, against the same steps unlistened
        counts, busy = {}, {}
        for mode, window in (("listened", batches[UI_STEPS:UI_STEPS + 3]),
                             ("plain", batches[UI_STEPS + 3:UI_STEPS + 6])):
            net.set_listeners(*([StatsListener(tee, session_id="ui_prof")]
                                if mode == "listened" else []))
            net.fit(*window[0])            # outside the trace
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for x, y in window:
                    net.fit(x, y)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            counts[mode] = d2h_copies(prof) / len(window)
            busy[mode] = _kernel_spans(prof)[1] / 1e6 / wall
        timed = batches[UI_STEPS + 6:]
        net.set_listeners(StatsListener(tee, session_id="ui_timed"))
        listened_ms = _timed_steps(torch, net, timed, UI_TIMED_STEPS)
        net.set_listeners()
        plain_ms = _timed_steps(torch, net, timed, UI_TIMED_STEPS)
        # the dashboard over the log, and the remote UI fed by the router
        name = next(iter(recs[0].param_stats))
        views = {}
        for which, srv in (("file", ui), ("remote", remote)):
            base = f"http://127.0.0.1:{srv.port}/train/ui_train"
            views[which] = (len(_get_json(base + "/overview")["scores"]),
                            len(_get_json(f"{base}/param/{name}")
                                ["param_mean_magnitude"]))
        guessed = load_model_guess(str(store / "stats.bin"))
        same_log = [r.to_dict() for r in guessed.get_records("ui_train")] \
            == [r.to_dict() for r in recs]
        guessed.close()
    finally:
        net.set_listeners()
        ui.stop()
        remote.stop()
        log.close()
    row = {"phase": "ui_train", "card": card, "model": {
               "name": "TransformerLM", "vocab": VOCAB, "seq": SEQ,
               "embed": EMBED, "layers": LAYERS, "heads": HEADS,
               "batch": TRAIN_BATCH, "updater": "Adam(3e-4)",
               "num_params": net.num_params()},
           "steps": UI_STEPS, "arrays_checked": arrays,
           "max_scalar_err_vs_f64": worst, "tol": TOL_UI_SCALAR,
           "histograms_exact": hists, "kernel_launches": launches,
           "expected_launches": {k: 8 * UI_STEPS for k in launches},
           "d2h_copies_per_step": counts, "device_busy_share": busy,
           "step_ms_listened": listened_ms, "step_ms_plain": plain_ms,
           "listener_overhead_ms": listened_ms - plain_ms,
           "overview_and_param_points": views,
           "model_guess_log_equal": same_log,
           "memory": {k: v for k, v in mem.items()
                      if k.startswith("device0")},
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    if worst > TOL_UI_SCALAR or not hists:
        return None, (f"ui_train: statistics vs the host: {worst} (tol "
                      f"{TOL_UI_SCALAR}), histograms exact {hists}")
    if any(v != 8 * UI_STEPS for v in launches.values()):
        return None, f"ui_train: flash launches {launches}"
    if counts["listened"] - counts["plain"] != 1:
        return None, f"ui_train: device-to-host copies a step {counts}"
    if any(v != (UI_STEPS, UI_STEPS) for v in views.values()):
        return None, f"ui_train: dashboard points {views}"
    if not same_log:
        return None, "ui_train: load_model_guess read other records"
    if not (mem.get("device0_bytes_in_use", 0) > 0
            and mem.get("device0_bytes_limit", 0) > 0):
        return None, f"ui_train: device memory keys {mem}"
    return (net, tree, launches), None


def kafka_serve_phase(args, torch, dev, card, net):
    """Phase 61.  Returns ``(flash launches, None)`` or ``(None, what
    failed)``."""
    import shutil
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.streaming import codec
    from deeplearning4j_tpu_torch.streaming import kafka_wire as kw
    from deeplearning4j_tpu_torch.utils import native
    from deeplearning4j_tpu_torch.utils.model_guesser import load_model_guess
    from deeplearning4j_tpu_torch.utils.model_serializer import write_model

    t_phase = time.perf_counter()
    if not native.available():
        return None, "kafka_serve: the native codec library did not build"
    store = REPO / "build" / "kafka_serve"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    t1 = time.perf_counter()
    # the served model: params only (the Adam slots would triple the zip)
    write_model(net, str(store / "lm.zip"), save_updater=False)
    served = load_model_guess(str(store / "lm.zip"), device=dev)
    save_load_s = time.perf_counter() - t1
    rng = np.random.default_rng(args.seed + 61)
    batches = [rng.integers(0, VOCAB, (TRAIN_BATCH, SEQ))
               for _ in range(KAFKA_BATCHES)]
    spent = {"crc32c": 0.0, "codec": 0.0}
    lock = threading.Lock()

    def clocked(what, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    spent[what] += time.perf_counter() - t
        return wrapper

    patched = [(kw, "crc32c", "crc32c"),
               (kw, "encode_record_batch", "codec"),
               (kw, "decode_record_batches", "codec"),
               (codec, "serialize_array", "codec"),
               (codec, "deserialize_array", "codec")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    broker = kw.MiniKafkaBroker().start()
    clients = []
    try:
        for mod, attr, what in patched:
            setattr(mod, attr, clocked(what, getattr(mod, attr)))
        pub = kw.NDArrayKafkaClient("127.0.0.1", broker.port, "lm_ids")
        consumer = kw.NDArrayKafkaClient("127.0.0.1", broker.port, "lm_ids",
                                         group_id="lm_servers")
        out_pub = kw.NDArrayKafkaClient("127.0.0.1", broker.port,
                                        "lm_probs")
        reader = kw.NDArrayKafkaClient("127.0.0.1", broker.port, "lm_probs",
                                       group_id="lm_readers")
        clients = [pub, consumer, out_pub, reader]
        fetched, round_ms = [], []
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        for ids in batches:
            t1 = time.perf_counter()
            pub.publish(ids)
            got = consumer.poll(max_items=1)
            out_pub.publish(served.output(got[0]))
            fetched.append(reader.poll(max_items=1))
            round_ms.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t0
        launches = dict(fa.launches)
        versions = (pub._client.produce_version,
                    reader._client.fetch_version)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        for c in clients:
            c.close()
        broker.stop()
    equal = all(len(f) == 1 and np.array_equal(
        f[0], net.output(ids).cpu().numpy()) for f, ids in
        zip(fetched, batches))
    row = {"phase": "kafka_serve", "card": card, "batches": KAFKA_BATCHES,
           "batch_shape": [TRAIN_BATCH, SEQ],
           "prediction_bytes": int(fetched[0][0].nbytes) if fetched[0]
           else 0, "wire_versions": {"produce": versions[0],
                                     "fetch": versions[1]},
           "crc32c_native": native.available(),
           "save_and_guess_load_s": save_load_s,
           "batches_per_s": KAFKA_BATCHES / wall,
           "round_trip_ms": round_ms, "crc32c_s": spent["crc32c"],
           "crc32c_share": spent["crc32c"] / wall,
           "codec_s_with_crc": spent["codec"],
           "codec_share_with_crc": spent["codec"] / wall,
           "predictions_equal_output_bitwise": equal,
           "kernel_launches": launches,
           "expected_fwd_launches": 8 * KAFKA_BATCHES,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    if versions != (3, 4):
        return None, f"kafka_serve: wire versions {versions}, not v2"
    if not equal:
        return None, "kafka_serve: fetched predictions differ from output"
    if launches != {"fwd": 8 * KAFKA_BATCHES, "bwd_dq": 0, "bwd_dkv": 0}:
        return None, f"kafka_serve: flash launches {launches}"
    return launches, None


def _stream_consistent(torch, net, twin, toks, prompt_len, temperature,
                       seed):
    """Where the card's stream ``toks`` parts from its twin's: every
    token must be the one the twin would choose after the same history
    (argmax, or the same uniform draw through its tempered distribution)
    except at ties, where the two nets' choice scores lie within twice
    their largest difference.  Returns (ties, mismatches, margin)."""
    import numpy as np
    import torch.nn.functional as F
    onehot = F.one_hot(torch.as_tensor(toks, device=net.device),
                       net.layer_confs[0].n_in).float()
    pk, pt = (m.output(onehot)[:, prompt_len - 1:-1].cpu().numpy()
              for m in (net, twin))

    def scores(p):
        if temperature <= 0:
            return p
        logits = np.log(np.maximum(p, 1e-9)) / temperature
        q = np.exp(logits - logits.max(-1, keepdims=True))
        return np.cumsum(q / q.sum(-1, keepdims=True), -1)

    sk, st = scores(pk), scores(pt)
    margin = 2 * float(np.abs(sk - st).max())
    chosen = toks[:, prompt_len:]
    ties = mismatches = 0
    rng = np.random.default_rng(seed)
    for s in range(chosen.shape[1]):
        for r in range(chosen.shape[0]):
            c, row = int(chosen[r, s]), st[r, s]
            if temperature <= 0:
                want = int(row.argmax())
                near = row[want] - row[c] <= margin
            else:
                u = rng.random()
                want = int(np.searchsorted(row / row[-1], u, side="right"))
                lo = row[c - 1] / row[-1] if c else 0.0
                near = lo - margin <= u < row[c] / row[-1] + margin
            if want != c:
                ties += bool(near)
                mismatches += not near
    return ties, mismatches, margin


def lstm_generate_phase(args, torch, dev, card, lm_net, lm_tree):
    """Phase 62.  Returns ``(launch counts, None)`` or ``(None, what
    failed)``."""
    import numpy as np
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.models import generate_tokens
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.streaming import (NDArrayPublisher,
                                                    ServeRoute,
                                                    TcpMessageBroker,
                                                    deserialize_array)

    t_phase = time.perf_counter()
    net = _char_lstm(args, dev, 62)
    twin = MultiLayerNetwork(TextGenerationLSTM(
        num_classes=LSTM_CLASSES, timesteps=LSTM_T, hidden=LSTM_HIDDEN,
        seed=args.seed + 62).conf(), device=dev).load_params({
            k: {n: p.detach().cpu().numpy() for n, p in g.items()}
            for k, g in net.params.items()})
    rng = np.random.default_rng(args.seed + 62)
    prompt = rng.integers(0, LSTM_CLASSES, (GEN_LSTM_BATCH, GEN_LSTM_PROMPT))
    runs, launches = {}, {}
    for mode, temperature in (("greedy", 0.0),
                              ("sampled", GEN_TEMPERATURE)):
        torch.cuda.synchronize()
        pl.reset_launches()
        t1 = time.perf_counter()
        toks = generate_tokens(net, prompt, GEN_LSTM_TOKENS,
                               temperature=temperature, seed=args.seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches[mode] = pl.launches["lstm_fwd"]
        t1 = time.perf_counter()
        ref = generate_tokens(twin, prompt, GEN_LSTM_TOKENS,
                              temperature=temperature, seed=args.seed)
        twin_secs = time.perf_counter() - t1
        equal = bool(np.array_equal(toks, ref))
        ties, mismatches, margin = (0, 0, 0.0) if equal else \
            _stream_consistent(torch, net, twin, toks, GEN_LSTM_PROMPT,
                               temperature, args.seed)
        runs[mode] = {"tokens_per_s": GEN_LSTM_BATCH * GEN_LSTM_TOKENS / secs,
                      "twin_tokens_per_s":
                          GEN_LSTM_BATCH * GEN_LSTM_TOKENS / twin_secs,
                      "seconds": secs, "equal_to_twin": equal,
                      "ties": ties, "mismatches": mismatches,
                      "margin": margin,
                      "launches_per_step": launches[mode]
                      / (GEN_LSTM_TOKENS + 1)}
    # ServeRoute over the TCP hub, serving the same net's output
    hub = TcpMessageBroker().serve()
    route = ServeRoute(hub, net, "chars", "char_probs").start()
    out = hub.subscribe("char_probs")
    try:
        time.sleep(0.2)                    # the subscriptions register
        pub = NDArrayPublisher(hub, "chars")
        xs = [F.one_hot(torch.as_tensor(
            rng.integers(0, LSTM_CLASSES, (LSTM_BATCH, LSTM_T))),
            LSTM_CLASSES).float().numpy() for _ in range(ROUTE_BATCHES)]
        torch.cuda.synchronize()
        pl.reset_launches()
        got, route_ms = [], []
        for x in xs:
            t1 = time.perf_counter()
            pub.publish(x)
            payload = out.poll(timeout=60.0)
            route_ms.append((time.perf_counter() - t1) * 1e3)
            got.append(None if payload is None
                       else deserialize_array(payload)[0])
        route_launches = pl.launches["lstm_fwd"]
    finally:
        route.stop()
        out.close()
        hub.shutdown()
    route_equal = all(g is not None and np.array_equal(
        g, net.output(x).cpu().numpy()) for g, x in zip(got, xs))
    # the full-width LM: generation attends through sdpa_reference (the
    # cached path), as in JAX, so no flash launch; its twin is on the
    # reference attention path
    lm_twin = _lm_net(args, dev, lm_tree, attn_impl="reference").load_params(
        {k: {n: p.detach().cpu().numpy() for n, p in g.items()}
         for k, g in lm_net.params.items()})
    lm_prompt = rng.integers(0, VOCAB, (GEN_LM_BATCH, GEN_LM_PROMPT))
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    lm_toks = generate_tokens(lm_net, lm_prompt, GEN_LM_TOKENS,
                              temperature=0.0)
    torch.cuda.synchronize()
    lm_secs = time.perf_counter() - t1
    lm_launches = dict(fa.launches)
    lm_ref = generate_tokens(lm_twin, lm_prompt, GEN_LM_TOKENS,
                             temperature=0.0)
    lm_equal = bool(np.array_equal(lm_toks, lm_ref))
    row = {"phase": "lstm_generate", "card": card, "model": {
               "name": "TextGenerationLSTM", "classes": LSTM_CLASSES,
               "hidden": LSTM_HIDDEN, "helper": "pallas"},
           "batch": GEN_LSTM_BATCH, "prompt": GEN_LSTM_PROMPT,
           "new_tokens": GEN_LSTM_TOKENS, "temperature": GEN_TEMPERATURE,
           "runs": runs, "kernel_launches": launches,
           "expected_launches": 2 * (GEN_LSTM_TOKENS + 1),
           "serve_route_tcp": {"batches": ROUTE_BATCHES,
                               "batch_shape": [LSTM_BATCH, LSTM_T],
                               "launches": route_launches,
                               "expected_launches": 2 * ROUTE_BATCHES,
                               "rows_equal_output_bitwise": route_equal,
                               "round_trip_ms": route_ms},
           "lm_generate": {"batch": GEN_LM_BATCH, "prompt": GEN_LM_PROMPT,
                           "new_tokens": GEN_LM_TOKENS,
                           "tokens_per_s":
                               GEN_LM_BATCH * GEN_LM_TOKENS / lm_secs,
                           "flash_launches": lm_launches,
                           "equal_to_reference_twin": lm_equal},
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(row), flush=True)
    for mode, r in runs.items():
        if launches[mode] != 2 * (GEN_LSTM_TOKENS + 1):
            return None, f"lstm_generate {mode}: lstm_fwd launches " \
                         f"{launches[mode]}"
        if r["mismatches"]:
            return None, f"lstm_generate {mode}: {r['mismatches']} tokens " \
                         "differ from the twin's outside ties"
    if route_launches != 2 * ROUTE_BATCHES or not route_equal:
        return None, f"lstm_generate: ServeRoute launches {route_launches}" \
                     f", rows equal {route_equal}"
    if any(lm_launches.values()) or not lm_equal:
        return None, f"lstm_generate: LM generation launches {lm_launches}" \
                     f", equal to its twin {lm_equal}"
    return {"generate": launches["greedy"], "route": route_launches}, None


def last_modules_phases(args, torch, dev, card):
    """Phases 60-62.  Returns ``(launch counts, None)`` or ``(None, what
    failed)``."""
    t0 = time.perf_counter()
    trained, err = ui_train_phase(args, torch, dev, card)
    if err:
        return None, err
    net, tree, ui_launches = trained
    torch.cuda.empty_cache()
    kafka_launches, err = kafka_serve_phase(args, torch, dev, card, net)
    if err:
        return None, err
    torch.cuda.empty_cache()
    lstm_launches, err = lstm_generate_phase(args, torch, dev, card, net,
                                             tree)
    if err:
        return None, err
    print(json.dumps({"phase": "last_modules_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return {"ui": ui_launches, "kafka": kafka_launches,
            "lstm": lstm_launches}, None


# ---- 63. the captured train step -------------------------------------------
CAP_STEPS = 20                  # fit steps, captured copy and eager copy
CAP_RAGGED = 8                  # rows of the ragged final batch
CAP_TIMED_STEPS = 20            # timed steps of each copy
CAP_LSTM_STEPS = 5
# captured against eager, same weights, same batches, one card: the graph
# replays the kernels the eager step launched, with the same launch
# configurations, in the same order, so the same bits are expected
TOL_CAPTURED = 0.0


def _eager_step(net, x, y):
    """One train step of ``net``, called directly and eagerly: ``fit``'s
    eager route (the captured route's plain version)."""
    loss, net.state, _, _ = net._train_step().fn(
        net._param_tree(), net.state, net.opt_state, x, y, None, None, None,
        None, net._rng)
    net.iteration += 1
    return loss


def _state_gaps(a, b) -> dict:
    """Largest absolute differences of two nets' params and updater slots
    (the Adam moments), and whether their keys and counts agree."""
    def worst(pairs):
        return max((float((u - v).detach().abs().max()) for u, v in pairs),
                   default=0.0)
    params = worst((p, b.params[k][n]) for k, g in a.params.items()
                   for n, p in g.items())
    slots = worst((t, b.opt_state["slots"][k][n][s])
                  for k, g in a.opt_state["slots"].items()
                  for n, sl in g.items() for s, t in sl.items())
    import torch
    return {"params_max_abs": params, "slots_max_abs": slots,
            "key_equal": bool(torch.equal(a._rng, b._rng)),
            "counts_equal": a.opt_state["count"] == b.opt_state["count"]}


def _traced_step(torch, fn) -> dict:
    """One step under ``torch.profiler`` (card only): its kernel launches,
    busy microseconds and the flash kernels by class."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = Counter(ev.name().lower()
                    for ev in prof.profiler.kineto_results.events()
                    if "CUDA" in str(ev.device_type()))
    kernels, busy = _kernel_spans(prof)
    flash = {cls: sum(v for k, v in names.items()
                      if any(t in k for t in tags))
             for cls, tags in LM_KERNEL_CLASSES[:3]}
    return {"kernel_launches": kernels, "busy_us": busy, "flash": flash}


class _StampClock:
    """A listener that stamps the host clock at every step: the spacing of
    the stamps is the step time the dispatch window lets through."""

    def __init__(self):
        self.stamps = []

    def iteration_done(self, model, iteration, epoch):
        self.stamps.append(time.perf_counter())

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _captured_vs_eager(torch, cap, eag, batches, launches) -> tuple:
    """``steps`` of ``cap.fit`` and of ``_eager_step(eag)`` on the same
    batches: (the captured losses, the eager losses, the gaps, the
    ``launches`` counter after the captured steps).  The first eager step
    runs under ``host_sync_check``: a host read on the step's path raises
    there."""
    from contextlib import nullcontext

    from deeplearning4j_tpu_torch.nn.compile_cache import host_sync_check
    cap_losses, eag_losses = [], []
    for x, y in batches:
        cap.fit(x, y)
        cap_losses.append(cap._score)
    cap_launches = dict(launches)
    for i, (x, y) in enumerate(batches):
        with host_sync_check() if i == 0 else nullcontext():
            eag_losses.append(_eager_step(eag, x, y))
    torch.cuda.synchronize()
    cap_l = [float(v) for v in cap_losses]
    eag_l = [float(v) for v in eag_losses]
    gaps = _state_gaps(cap, eag)
    gaps["losses_max_abs"] = max(abs(a - b) for a, b in zip(cap_l, eag_l))
    return cap_l, eag_l, gaps, cap_launches


def _gaps_ok(gaps) -> bool:
    return gaps["key_equal"] and gaps["counts_equal"] and all(
        gaps[k] <= TOL_CAPTURED
        for k in ("losses_max_abs", "params_max_abs", "slots_max_abs"))


def captured_fit_phase(args, torch, dev, card):
    """Phase 63.  Returns ``({"flash": launches of the captured LM's 20
    steps, "lstm_fwd": of the captured char-LSTM's 5}, None)`` or
    ``(None, what failed)``."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.dispatch import ENV_VAR
    from deeplearning4j_tpu_torch.observability.registry import \
        default_registry
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl

    def compiles():
        c = default_registry().get("training_compile_total")
        return 0.0 if c is None else c.labels("train_step").value

    t_phase = time.perf_counter()
    tree = _lm_tree(args, dev, 63)
    rng = np.random.default_rng(args.seed + 63)
    toks = rng.integers(0, VOCAB, (CAP_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(torch.as_tensor(b[:, :-1], device=dev),
                torch.as_tensor(b[:, 1:], device=dev)) for b in toks]
    torch.cuda.empty_cache()
    cap, eag = _lm_net(args, dev, tree), _lm_net(args, dev, tree)
    c0 = compiles()
    torch.cuda.synchronize()
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cap_losses, eag_losses, gaps, launches = _captured_vs_eager(
        torch, cap, eag, batches, fa.launches)
    peak_both = torch.cuda.max_memory_allocated()
    c1 = compiles()
    route = cap.last_route
    graphs = cap._graphs.stats() if cap._graphs is not None else {}
    capture_s = [g["capture_s"] for g in graphs.values()]

    # one replay traced, against the launch counters' delta of that step
    x, y = batches[0]
    counted = dict(fa.launches)
    replay = _traced_step(torch, lambda: cap.fit(x, y))
    delta = {k: fa.launches[k] - counted[k] for k in counted}
    eager = _traced_step(torch, lambda: _eager_step(eag, x, y))

    # the median step of each copy and its busy share
    step_cap = _timed_steps(torch, cap, batches, CAP_TIMED_STEPS)
    times = []
    for i in range(CAP_TIMED_STEPS + 2):
        x, y = batches[i % len(batches)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _eager_step(eag, x, y)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t1) * 1e3)
    step_eag = statistics.median(times)

    # the fit loop's window: a 20-step fit at depth 1 and 2
    depth_ms = {}
    old = os.environ.get(ENV_VAR)
    try:
        for depth in (1, 2):
            os.environ[ENV_VAR] = str(depth)
            clock = _StampClock()
            cap.set_listeners(clock)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cap.fit(iter(batches))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            gaps_ms = [(b - a) * 1e3 for a, b in zip(clock.stamps,
                                                     clock.stamps[1:])]
            depth_ms[depth] = {"step_ms_median": statistics.median(gaps_ms),
                               "wall_ms_per_step": wall / len(batches)}
    finally:
        cap.set_listeners()
        if old is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = old

    # each copy's peak over 3 steps, from the same allocation before it
    peaks = {}
    for name, step in (("captured", lambda x, y: cap.fit(x, y)),
                       ("eager", lambda x, y: _eager_step(eag, x, y))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for x, y in batches[:3]:
            step(x, y)
        torch.cuda.synchronize()
        peaks[name] = {"allocated_before_bytes": base,
                       "step_peak_bytes":
                       torch.cuda.max_memory_allocated() - base,
                       "reserved_bytes": torch.cuda.memory_reserved()}

    # a ragged final batch: one more compile, exactly
    c2 = compiles()
    x, y = batches[0]
    cap.fit(x[:CAP_RAGGED], y[:CAP_RAGGED])
    c3 = compiles()
    del cap, eag
    torch.cuda.empty_cache()

    # the char-LSTM: 5 steps captured against eager
    lcap, leag = _char_lstm(args, dev, 63), _char_lstm(args, dev, 63)
    lrng = np.random.default_rng(args.seed + 630)
    lbatches = [tuple(torch.as_tensor(a, device=dev)
                      for a in _char_rows(lrng, LSTM_BATCH))
                for _ in range(CAP_LSTM_STEPS)]
    torch.cuda.synchronize()
    pl.reset_launches()
    l_cap, l_eag, l_gaps, l_launches = _captured_vs_eager(
        torch, lcap, leag, lbatches, pl.launches)
    lstm = {"route": lcap.last_route, "losses": l_cap,
            "eager_losses": l_eag, "gaps": l_gaps,
            "lstm_fwd_launches": l_launches["lstm_fwd"],
            "expected_lstm_fwd_launches": 2 * CAP_LSTM_STEPS,
            "graphs": lcap._graphs.stats() if lcap._graphs else {}}
    del lcap, leag

    flash_want = {cls: LAYERS for cls, _ in LM_KERNEL_CLASSES[:3]}
    launch_want = {k: LAYERS * CAP_STEPS for k in launches}
    print(json.dumps({
        "phase": "captured_fit", "model": {
            "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
            "heads": HEADS, "batch": TRAIN_BATCH, "dtype": "float32",
            "updater": "Adam(learning_rate=3e-4)"},
        "route": route, "steps": CAP_STEPS, "losses": cap_losses,
        "eager_losses": eag_losses, "gaps": gaps, "tol": TOL_CAPTURED,
        "compiles_20_steps": c1 - c0, "compiles_ragged_batch": c3 - c2,
        "capture_seconds": capture_s, "graphs": graphs,
        "kernel_launches": launches, "expected_launches": launch_want,
        "replay_trace": replay, "replay_counter_delta": delta,
        "eager_trace": eager,
        "step_ms_median": {"captured": step_cap, "eager": step_eag},
        "busy_share": {"captured": replay["busy_us"] / 1e3 / step_cap,
                       "eager": eager["busy_us"] / 1e3 / step_eag},
        "dispatch_depth": depth_ms,
        "peak_memory": {"both_copies_20_steps_bytes": peak_both - before,
                        **peaks},
        "char_lstm": lstm,
        "seconds": round(time.perf_counter() - t_phase, 3),
        "card": card}), flush=True)
    if route != "captured":
        return None, f"the LM's fit step took the route {route!r}"
    if not _gaps_ok(gaps):
        return None, f"captured and eager LM steps differ: {gaps}"
    if c1 - c0 != 1 or c3 - c2 != 1:
        return None, (f"train_step compiles: {c1 - c0} for {CAP_STEPS} "
                      f"steps of one shape (want 1), {c3 - c2} for the "
                      "ragged batch (want 1)")
    if launches != launch_want:
        return None, f"captured fit launched {launches}; want {launch_want}"
    if replay["flash"] != flash_want or \
            list(delta.values()) != list(flash_want.values()):
        return None, (f"one replay's trace holds {replay['flash']} flash "
                      f"kernels and the counters moved {delta}; want "
                      f"{flash_want}")
    if lstm["route"] == "captured" and not _gaps_ok(l_gaps):
        return None, f"captured and eager char-LSTM steps differ: {l_gaps}"
    if l_launches["lstm_fwd"] != 2 * CAP_LSTM_STEPS:
        return None, (f"the char-LSTM's {CAP_LSTM_STEPS} steps launched "
                      f"lstm_fwd {l_launches['lstm_fwd']} times; want "
                      f"{2 * CAP_LSTM_STEPS}")
    return {"flash": launches, "lstm_fwd": l_launches["lstm_fwd"]}, None



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (REPO / "deeplearning4j_tpu_torch" / "csrc").is_dir():
        return fail(f"no deeplearning4j_tpu_torch package beside {__file__}")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke needs "
                    "a CUDA GPU")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.models.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn.multilayer import _stack_loss
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import pallas_bn as pb
    from deeplearning4j_tpu_torch.ops import pallas_lstm as pl
    from deeplearning4j_tpu_torch.serving.engine import ServingEngine
    from deeplearning4j_tpu_torch.utils import kernel_build
    from deeplearning4j_tpu_torch.utils.model_serializer import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    src_dir = SRC_DIR

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build_all(kernel_build, [fa.SOURCE, fa.BWD_SOURCE, pb.SOURCE,
                                     pl.SOURCE])
    print(json.dumps({"phase": "build", "seconds": round(
        time.perf_counter() - t0, 3), "sources": {
            f"{src_dir}/{s}": v for s, v in built.items()}}), flush=True)

    # ---- 2-3. forward and backward kernels vs plain on the card --------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bh = MAX_BATCH * HEADS
    shape = (bh, SEQ, HEAD_DIM)
    scale = HEAD_DIM ** -0.5
    inputs, saved, max_err = {}, {}, {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16),
                      ("float16", torch.float16)):
        for shp in (shape, *CHECK_SHAPES):
            sc = shp[2] ** -0.5
            q, k, v, do = (torch.randn(shp, generator=gen, device=dev).to(dt)
                           for _ in range(4))
            main_shape = shp == shape
            if main_shape:
                inputs[dname] = (q, k, v, do)
            for causal in (True, False):
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                scale=sc)
                po, plse = fa.flash_attention_fwd_plain(q, k, v, causal, sc)
                torch.cuda.synchronize()
                err_o = (o.float() - po.float()).abs().max().item()
                err_l = (lse - plse).abs().max().item()
                finite = bool(torch.isfinite(o.float()).all())
                print(json.dumps({"phase": "kernel_vs_plain", "dtype": dname,
                                  "causal": causal, "shape": list(shp),
                                  "max_abs_err_o": err_o,
                                  "max_abs_err_lse": err_l,
                                  "tol_o": TOL_O[dname], "tol_lse": TOL_LSE}),
                      flush=True)
                if not finite or err_o > TOL_O[dname] or err_l > TOL_LSE:
                    return fail(f"kernel disagrees with plain ({dname}, "
                                f"causal={causal}, {list(shp)}): O {err_o}, "
                                f"lse {err_l}")
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sc)
                again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                               sc)
                want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal, sc)
                torch.cuda.synchronize()
                # one CTA owns each output tile: no atomics, the same bits
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                rel, absolute = {}, {}
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    if not bool(torch.isfinite(g.float()).all()):
                        return fail(f"{name} not finite ({dname}, causal="
                                    f"{causal}, {list(shp)})")
                    diff = (g.float() - w.float()).abs().max().item()
                    absolute[name] = diff
                    rel[name] = diff / w.float().abs().max().item()
                print(json.dumps({"phase": "bwd_kernel_vs_plain",
                                  "dtype": dname, "causal": causal,
                                  "shape": list(shp), "max_abs_err": absolute,
                                  "rel_err": rel,
                                  "tol_rel": TOL_BWD[dname],
                                  "deterministic": same}), flush=True)
                if max(rel.values()) > TOL_BWD[dname]:
                    return fail(f"backward kernels disagree with plain "
                                f"({dname}, causal={causal}, {list(shp)}): "
                                f"{rel}")
                if not same:
                    return fail(f"two backward launches on the same inputs "
                                f"differ ({dname}, causal={causal}, "
                                f"{list(shp)})")
                if main_shape:
                    saved[(dname, causal)] = (o, lse)
                    max_err[("fwd", dname, causal)] = max(err_o, err_l)
                    max_err[("bwd_dq", dname, causal)] = absolute["dq"]
                    max_err[("bwd_dkv", dname, causal)] = max(
                        absolute["dk"], absolute["dv"])
                del o, lse, po, plse, got, again, want
            del q, k, v, do

    # head_dim 320: flash_attention takes sdpa_reference by its shape rule
    # (kernel_supports); no kernel launches, and the plain forward agrees
    b, h, t, d = WIDE_HEAD_DIM_SHAPE
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
               for _ in range(3))
    fa.reset_launches()
    for causal in (True, False):
        out = fa.flash_attention(q, k, v, causal=causal)
        want, _ = fa.flash_attention_fwd_plain(
            *(x.reshape(b * h, t, d) for x in (q, k, v)), causal, d ** -0.5)
        torch.cuda.synchronize()
        err = (out.reshape(b * h, t, d) - want).abs().max().item()
        wide_launches = dict(fa.launches)
        print(json.dumps({"phase": "wide_head_dim", "shape": [b, h, t, d],
                          "causal": causal, "supports": fa.supports(t, t, d),
                          "kernel_supports": fa.kernel_supports(t, t, d),
                          "kernel_launches": wide_launches,
                          "max_abs_err": err, "tol": TOL_O["float32"]}),
              flush=True)
        if any(wide_launches.values()) or not fa.supports(t, t, d) or \
                not bool(torch.isfinite(out).all()) or \
                err > TOL_O["float32"]:
            return fail(f"head_dim {d} through flash_attention: launches "
                        f"{wide_launches}, error {err}")
    del q, k, v, out, want

    # ---- 4. full-width serve ---------------------------------------------
    lm = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                       n_layers=LAYERS, n_heads=HEADS)
    net = lm.init(device="cuda")
    tree = seeded_params(net.param_spec(), args.seed)
    params_from_jax(net, tree)
    ref_lm = TransformerLM(vocab_size=VOCAB, seq_len=SEQ, embed=EMBED,
                           n_layers=LAYERS, n_heads=HEADS,
                           attn_impl="reference")
    ref = params_from_jax(ref_lm.init(device="cuda"), tree)
    rng = np.random.default_rng(args.seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    requests = [eye[rng.integers(0, VOCAB, (n, SEQ))] for n in REQUEST_SIZES]

    engine = ServingEngine(net, max_batch_size=MAX_BATCH)
    try:
        engine.warmup()
        torch.cuda.synchronize()
        fa.reset_launches()
        batches0 = engine.batches_dispatched
        t_serve = time.perf_counter()
        outs = [engine.predict(x) for x in requests]
        serve_s = time.perf_counter() - t_serve
        serve_launches = dict(fa.launches)
        batches = engine.batches_dispatched - batches0
        worst = 0.0
        for x, y in zip(requests, outs):
            want = ref.output(x).cpu().numpy()
            if y.shape != (len(x), SEQ, VOCAB) or not np.isfinite(y).all():
                return fail(f"served output shape {y.shape} or not finite")
            if np.abs(y.sum(-1) - 1.0).max() > 1e-4:
                return fail("served rows are not probability distributions")
            worst = max(worst, float(np.abs(y - want).max()))
        print(json.dumps({"phase": "serve", "requests": list(REQUEST_SIZES),
                          "batches": batches,
                          "kernel_launches": serve_launches,
                          "expected_launches": LAYERS * batches,
                          "max_abs_err_vs_reference": worst,
                          "tol": TOL_SERVE, "seconds": round(serve_s, 4),
                          "num_params": net.num_params(),
                          "stats": engine.stats()}), flush=True)
        if serve_launches["fwd"] != LAYERS * batches or batches == 0:
            return fail(f"forward kernel launched {serve_launches['fwd']} "
                        f"times over {batches} batches; expected {LAYERS} "
                        "per batch")
        if serve_launches["bwd_dq"] or serve_launches["bwd_dkv"]:
            return fail(f"serving launched backward kernels: "
                        f"{serve_launches}")
        if worst > TOL_SERVE:
            return fail(f"served rows differ from the reference path by "
                        f"{worst} > {TOL_SERVE}")

        batch16 = requests[-1]
        serve_ms = []
        for i in range(SERVE_TIMED_RUNS + 3):
            t1 = time.perf_counter()
            engine.predict(batch16)
            torch.cuda.synchronize()
            if i >= 3:
                serve_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        engine.shutdown()
    serve_med = statistics.median(serve_ms)
    # the same batch with input and output left on the card: the share of
    # a served request that is the model's forward
    x16 = torch.as_tensor(batch16, device=dev)
    fwd = median_ms(lambda: net.output(x16), torch)
    fwd_ref = median_ms(lambda: ref.output(x16), torch)
    print(json.dumps({"phase": "serve_time", "batch": MAX_BATCH,
                      "runs": len(serve_ms),
                      "latency_ms_median": serve_med,
                      "latency_ms_max": max(serve_ms),
                      "tokens_per_s": MAX_BATCH * SEQ / serve_med * 1e3,
                      "forward_ms": fwd, "forward_reference_ms": fwd_ref,
                      "card": card}), flush=True)
    del net, ref, engine, x16, outs

    # ---- 5. full-width training ------------------------------------------
    # integer ids in, next-token ids as targets (sparse_mcxent); the
    # network default updater, Adam(learning_rate=3e-4)
    tnet, tref = (params_from_jax(TransformerLM(
        vocab_size=VOCAB, seq_len=SEQ, embed=EMBED, n_layers=LAYERS,
        n_heads=HEADS, attn_impl=impl, sparse_labels=True).init(
            device="cuda"), tree) for impl in ("auto", "reference"))
    trng = np.random.default_rng(args.seed + 1)
    tokens = trng.integers(0, VOCAB, (TRAIN_STEPS, TRAIN_BATCH, SEQ + 1))
    batches = [(b[:, :-1], b[:, 1:]) for b in tokens]

    # step-0 gradients of every parameter, flash path vs reference path
    x0, y0 = (torch.as_tensor(a, device=dev) for a in batches[0])
    grads = []
    for m in (tnet, tref):
        params = m._param_tree()
        keys = [(k, n) for k in params for n in params[k]]
        loss0 = _stack_loss(m.conf, params, x0, y0, train=True)
        grads.append(dict(zip(keys, torch.autograd.grad(
            loss0, [params[k][n] for k, n in keys]))))
    net_max = max(g.abs().max().item() for g in grads[1].values())
    worst_leaf, worst_name = 0.0, ""
    for key, g in grads[0].items():
        w = grads[1][key]
        err = (g - w).abs().max().item()
        tol = TOL_GRAD_LEAF * w.abs().max().item() + TOL_GRAD_NET * net_max
        if not bool(torch.isfinite(g).all()) or err > tol:
            return fail(f"step-0 gradient {key} differs from the reference "
                        f"path by {err} > {tol}")
        ratio = err / tol
        if ratio >= worst_leaf:
            worst_leaf, worst_name = ratio, "/".join(key)
    del grads, loss0

    torch.cuda.synchronize()
    fa.reset_launches()
    t_train = time.perf_counter()
    step_losses = []
    for x, y in batches:
        tnet.fit(x, y)
        step_losses.append(tnet._score)    # a device scalar: no sync here
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    train_launches = dict(fa.launches)
    losses = [float(v) for v in step_losses]
    ref_losses = []
    for x, y in batches:
        tref.fit(x, y)
        ref_losses.append(tref.get_score())
    final_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    expected = {name: LAYERS * TRAIN_STEPS for name in train_launches}
    probs = tnet.output(batches[0][0][:1])
    print(json.dumps({"phase": "train", "model": {
        "vocab": VOCAB, "seq": SEQ, "embed": EMBED, "layers": LAYERS,
        "heads": HEADS, "batch": TRAIN_BATCH, "dtype": "float32",
        "updater": "Adam(learning_rate=3e-4)", "loss": "sparse_mcxent",
        "num_params": tnet.num_params()},
        "steps": TRAIN_STEPS, "losses": losses,
        "reference_losses": ref_losses, "max_rel_loss_diff": final_diff,
        "tol_loss": TOL_TRAIN_LOSS,
        "step0_grad_worst_err_over_tol": worst_leaf,
        "step0_grad_worst_param": worst_name,
        "tol_grad": [TOL_GRAD_LEAF, TOL_GRAD_NET],
        "kernel_launches": train_launches, "expected_launches": expected,
        "seconds": round(train_s, 4)}), flush=True)
    if not all(np.isfinite(losses)) or final_diff > TOL_TRAIN_LOSS:
        return fail(f"training losses {losses} differ from the reference "
                    f"path's {ref_losses} by {final_diff} > {TOL_TRAIN_LOSS}")
    if train_launches != expected:
        return fail(f"training launched {train_launches}; expected "
                    f"{expected} ({LAYERS} per kernel per step)")
    if probs.shape != (1, SEQ, VOCAB) or \
            (probs.sum(-1) - 1).abs().max().item() > 1e-4:
        return fail("the trained net's output rows are not distributions")

    # ---- 6. times --------------------------------------------------------
    step_ms = {}
    for name, m in (("flash", tnet), ("reference", tref)):
        times = []
        for i in range(TIMED_TRAIN_STEPS + 2):
            x, y = batches[i % TRAIN_STEPS]
            t1 = time.perf_counter()
            m.fit(x, y)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t1) * 1e3)
        step_ms[name] = statistics.median(times)
    del tref
    split = profile_steps(torch, tnet, batches[:PROFILED_STEPS],
                          LM_KERNEL_CLASSES)
    # device busy share of an unprofiled step; None when the profiler
    # saw no device time
    split["device_busy_share"] = (
        split["device_ms_total_per_step"] / step_ms["flash"]
        if split["device_ms_total_per_step"] else None)
    print(json.dumps({"phase": "train_time", "batch": TRAIN_BATCH,
                      "steps": TIMED_TRAIN_STEPS,
                      "step_ms_median": step_ms["flash"],
                      "tokens_per_s": TRAIN_BATCH * SEQ
                      / step_ms["flash"] * 1e3,
                      "reference_step_ms_median": step_ms["reference"],
                      "reference_tokens_per_s": TRAIN_BATCH * SEQ
                      / step_ms["reference"] * 1e3,
                      "profile": split, "card": card}), flush=True)

    timings = {}
    for dname, (q, k, v, do) in inputs.items():
        q4, k4, v4, do4 = (x.view(MAX_BATCH, HEADS, SEQ, HEAD_DIM)
                           for x in (q, k, v, do))
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q4, k4, v4))
        for causal in (True, False):
            o, lse = saved[(dname, causal)]
            dd = (do.float() * o.float()).sum(-1)
            o_buf, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
            lse_buf = torch.empty_like(lse)
            dims = (bh, SEQ, SEQ, HEAD_DIM, int(causal), float(scale),
                    fa.KERNEL_DTYPES[q.dtype],
                    torch.cuda.current_stream().cuda_stream)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dd.data_ptr())
            # launched straight through the bindings: timing launches are
            # not counted
            calls = {
                "fwd": lambda: fa._launch(
                    "flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o_buf.data_ptr(), lse_buf.data_ptr(), bh, SEQ,
                    SEQ, HEAD_DIM, int(causal), float(scale),
                    fa.KERNEL_DTYPES[q.dtype],
                    torch.cuda.current_stream().cuda_stream),
                "bwd_dq": lambda: fa._launch(
                    "flash_attn_bwd_dq", *ptrs, dq.data_ptr(), *dims),
                "bwd_dkv": lambda: fa._launch(
                    "flash_attn_bwd_dkv", *ptrs, dk.data_ptr(),
                    dv.data_ptr(), *dims),
            }
            kern = {n: median_ms(f, torch) for n, f in calls.items()}
            kern_dev = {n: median_ms(f, torch, spin=True)
                        for n, f in calls.items()}
            plain_fwd = median_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal, scale), torch, runs=10)
            plain_bwd = median_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale), torch, runs=10)
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale), torch)
            lib_fwd_bwd = median_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                               scale=scale),
                (qg, kg, vg), do4), torch)
            # the plain backward and SDPA's backward each compute dq, dk
            # and dv in one pass: both backward kernels carry that time
            plain = {"fwd": plain_fwd, "bwd_dq": plain_bwd,
                     "bwd_dkv": plain_bwd}
            lib = {"fwd": lib_fwd, "bwd_dq": lib_fwd_bwd - lib_fwd,
                   "bwd_dkv": lib_fwd_bwd - lib_fwd}
            for name in ("fwd", "bwd_dq", "bwd_dkv"):
                bound, bound_by = attention_bound_ms(name, bh, SEQ, HEAD_DIM,
                                                     causal, dname)
                timings[(name, dname, causal)] = (kern[name], plain[name],
                                                  lib[name], bound, bound_by,
                                                  kern_dev[name])
                # the pair computes what SDPA's backward computes
                pair = {} if name == "fwd" else {
                    "pair_ms": kern["bwd_dq"] + kern["bwd_dkv"],
                    "pair_ms_device_only": kern_dev["bwd_dq"]
                    + kern_dev["bwd_dkv"],
                    "library_pair_ms": lib_fwd_bwd - lib_fwd}
                print(json.dumps({"phase": "kernel_time",
                                  "kernel": f"flash_attn_{name}",
                                  "dtype": dname, "causal": causal,
                                  "shape": list(shape), "ms": kern[name],
                                  "ms_device_only": kern_dev[name],
                                  "plain_ms": plain[name],
                                  "library_ms": lib[name],
                                  "bound_ms": bound, "bound_by": bound_by,
                                  **pair, "card": card}), flush=True)

    del tnet, inputs, saved
    torch.cuda.empty_cache()

    # ---- 7-9. ResNet50: BN kernel vs plain, training, times --------------
    bn_record, err = cnn_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 10-12. char-LSTM: kernel vs plain, serve, stream, train, times --
    lstm_record, err = lstm_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 13-15. generation: full-width TransformerLM, LSTM stack -------
    err = generation_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 16-20. the key stream, the conv zoo, dropout ------------------
    for phase in (random_phase, zoo_serve_phase, zoo_train_phases):
        err = phase(args, torch, dev, card)
        if err:
            return fail(err)
        torch.cuda.empty_cache()
    dropout_launches, err = dropout_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 21-24. the rest of training -----------------------------------
    err = updaters_phase(args, torch, dev, card)
    if err:
        return fail(err)
    slice_launches = {}
    for key, phase in (("es", early_stop_phase), ("fod", fit_on_device_phase),
                       ("tr", transfer_phase)):
        slice_launches[key], err = phase(args, torch, dev, card)
        if err:
            return fail(err)
        torch.cuda.empty_cache()

    # ---- 25-30. precision and memory, int8 KV, solvers and evaluation --
    prec_launches, err = precision_lm_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    f16_launches, err = loss_scale_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    err = remat_memory_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    bn_bf16_launches, err = resnet_bf16_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    for phase in (int8_kv_phase, solvers_eval_phase):
        err = phase(args, torch, dev, card)
        if err:
            return fail(err)
        torch.cuda.empty_cache()

    # ---- 31-32. checkpoint and resume, observability -------------------
    ckpt_launches, err = checkpoint_resume_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    err = observability_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 33-37. the serving tier over HTTP -----------------------------
    http_launches, err = serving_http_phase(args, torch, dev, card,
                                            ckpt_launches["store"])
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    swap_launches, err = hot_swap_lstm_phase(args, torch, dev, card)
    if err:
        return fail(err)
    pi_launches, err = inference_server_phase(args, torch, dev, card)
    if err:
        return fail(err)
    fleet_launches, err = fleet_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    err = knn_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 38-42. training across ranks ----------------------------------
    rank_launches, err = training_across_ranks_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 43-44. the model axes: the MoE LM, every axis at one rank -----
    axes_launches, err = model_axes_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 45-48. Keras import and export, the activations ---------------
    keras_launches, err = keras_import_phases(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()

    # ---- 49-50. the process masters over the TCP hub -------------------
    t0 = time.perf_counter()
    mp_launches, err = masters_mp_phase(args, torch, dev, card)
    if err:
        return fail(err)
    torch.cuda.empty_cache()
    err = tcp_broker_interop_phase(args, torch, dev, card)
    if err:
        return fail(err)
    print(json.dumps({"phase": "process_masters_seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    torch.cuda.empty_cache()

    # ---- 51-53. pretraining (RBM stack, VAE), Tiny YOLOv2 ---------------
    yolo_launches, err = pretrain_detection_phases(args, torch, dev, card)
    if err:
        return fail(err)

    # ---- 54-56. the input pipeline, the data readers, clustering -------
    torch.cuda.empty_cache()
    pipe_launches, err = pipeline_data_clustering_phases(args, torch, dev,
                                                         card)
    if err:
        return fail(err)

    # ---- 57-59. the embedding family ----------------------------------
    torch.cuda.empty_cache()
    _, err = embedding_phases(args, torch, dev, card)
    if err:
        return fail(err)

    # ---- 60-62. the training UI, the Kafka wire, generation ------------
    torch.cuda.empty_cache()
    last_launches, err = last_modules_phases(args, torch, dev, card)
    if err:
        return fail(err)

    # ---- 63. the train step captured as a CUDA graph -----------------------
    torch.cuda.empty_cache()
    cap_launches, err = captured_fit_phase(args, torch, dev, card)
    if err:
        return fail(err)

    # the training path runs f32, causal
    sources = {"fwd": fa.SOURCE, "bwd_dq": fa.BWD_SOURCE,
               "bwd_dkv": fa.BWD_SOURCE}
    replaces = {"fwd": "deeplearning4j_tpu/ops/flash_attention.py:77",
                "bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:170",
                "bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:194"}
    records = []
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        kern, plain, lib_ms, bound, bound_by, kern_dev = \
            timings[(name, "float32", True)]
        records.append({
            "name": f"flash_attn_{name}", "route": "cuda",
            "source": f"{src_dir}/{sources[name]}",
            "replaces": replaces[name],
            "launches": train_launches[name],
            "launches_train_dropout": dropout_launches[name],
            "launches_fit_on_device_lm": slice_launches["fod"][name],
            "launches_checkpoint_uninterrupted":
                ckpt_launches["uninterrupted"][name],
            "launches_checkpoint_resumed": ckpt_launches["resumed"][name],
            "launches_serving_http": http_launches[name],
            "launches_fleet_predict": fleet_launches[name],
            "launches_parallel_wrapper_lm":
                rank_launches["parallel"]["wrapper"][name],
            "launches_sharded_lm": rank_launches["parallel"]["sharded"][name],
            "launches_sharded_resumed_lm": rank_launches["sharded"][name],
            "launches_elastic_lm": rank_launches["elastic"][name],
            "launches_sparse_embedding_lm": rank_launches["sparse"][name],
            "launches_masters_lm": rank_launches["masters"][name],
            "launches_moe_lm_train": axes_launches["moe"]["train"][name],
            "launches_moe_lm_serve": axes_launches["moe"]["serve"][name],
            "launches_tensor_parallel_lm_tp1": axes_launches["tp"][name],
            "launches_masters_mp_lm_workers": mp_launches[name],
            "launches_ui_train": last_launches["ui"][name],
            "launches_kafka_serve": last_launches["kafka"][name],
            "launches_captured_fit_lm_20_steps": cap_launches["flash"][name],
            "max_abs_err": max_err[(name, "float32", True)],
            "ms": kern, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms,
            "ms_device_only": kern_dev})
    # the same kernels in bf16 (precision_lm) and f16 (loss_scale_f16),
    # causal at the LM's attention shape
    for dname, tag, path_launches in (("bfloat16", "bf16", prec_launches),
                                      ("float16", "f16",
                                       f16_launches["flash"])):
        for name in ("fwd", "bwd_dq", "bwd_dkv"):
            kern, plain, lib_ms, bound, bound_by, kern_dev = \
                timings[(name, dname, True)]
            records.append({
                "name": f"flash_attn_{name}_{tag}", "route": "cuda",
                "source": f"{src_dir}/{sources[name]}",
                "replaces": replaces[name], "dtype": dname,
                "launches": path_launches[name],
                "max_abs_err": max_err[(name, dname, True)],
                "ms": kern, "plain_ms": plain, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms,
                "ms_device_only": kern_dev})
    bn_record["launches_transfer_resnet"] = slice_launches["tr"]
    bn_record["launches_keras_resnet50_finetune_per_step"] = \
        keras_launches["bn"]
    bn_record["launches_tiny_yolo_step"] = yolo_launches["step"]
    bn_record["launches_tiny_yolo_serve"] = yolo_launches["serve"]
    bn_record["launches_cifar_pipeline_resnet50_per_step"] = pipe_launches
    lstm_record["launches_early_stop_lstm"] = slice_launches["es"]
    lstm_record["launches_loss_scale_f16_tbptt"] = f16_launches["lstm"]
    lstm_record["launches_hot_swap_under_load"] = swap_launches
    lstm_record["launches_inference_server"] = pi_launches
    lstm_record["launches_keras_char_lstm_per_output"] = \
        keras_launches["lstm"]["sigmoid"]
    lstm_record["launches_keras_char_lstm_hard_sigmoid_per_output"] = \
        keras_launches["lstm"]["hard_sigmoid"]
    lstm_record["launches_generate_tokens"] = last_launches["lstm"][
        "generate"]
    lstm_record["launches_serve_route_tcp"] = last_launches["lstm"]["route"]
    lstm_record["launches_captured_fit_char_lstm_5_steps"] = \
        cap_launches["lstm_fwd"]
    bf16_totals = bn_record.pop("bfloat16_totals")
    bf16_err = bn_record.pop("bfloat16_max_abs_err")
    records.append(bn_record)
    records.append({
        **{k: bn_record[k] for k in ("route", "source", "replaces")},
        "name": "bn_apply_bf16", "dtype": "bfloat16",
        "per": "one ResNet50 training step at batch 64 with every BN in "
               "bf16 (keep_f32=()): the 53 launches at their shapes, "
               "summed, each after a clean L2 flush",
        "launches": bn_bf16_launches, "max_abs_err": bf16_err,
        **bf16_totals,
        "bound_share": bf16_totals["bound_ms"] / bf16_totals["ms"]})
    records.append(lstm_record)
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
