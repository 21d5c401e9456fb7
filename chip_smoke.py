#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch``'s paths with random weights from a seed:
GPT serving — ``DecodeEngine`` and ``DecodeBatcher`` — at the repo's
benchmark configuration (GPT-2-small body: 768 wide, 12 layers, 6 heads
of 128, FFN 3072, vocab 8192; window 576, batch buckets (1, 8), prompt
bucket 512), then BERT-base masked-LM pretraining through
``examples.bert_pretrain`` at its defaults (vocab 30522, 768 wide, 12
layers, 12 heads of 64, FFN 3072, batch 16 x 128 tokens, AdamW lr 1e-4,
wd 0.01), then ResNet-50 v1 image serving (1000 classes, NHWC items
224x224x3, buckets 1, 2, 4, 8) through ``ModelRegistry`` →
``InferenceEngine`` → ``Batcher``, then ResNet-50 v1 training through
``examples.image_classification`` at its defaults (batch 64 x 224x224x3,
1000 classes, SGD lr 0.1, momentum 0.9, wd 1e-4), then the fused
training step, each step one captured CUDA graph: ResNet-50 v1 through
``Trainer.fuse_step`` at batch 128 and Gluon BERT-base masked-LM
through ``parallel.FusedTrainStep`` at 8 x 512 tokens (Adam lr 1e-4),
then Gluon BERT-base
serving (``models.bert_gluon.bert_12_768_12``: vocab 30522, 768 wide, 12
layers of 12 heads of 64, FFN 3072, fp32; int32 items of 512 token ids,
buckets 1, 2, 4, 8) through ``ModelRegistry`` → ``Batcher`` →
``InferenceEngine``, then int8 post-training-quantized ResNet-50 v1
(``quantization.quantize_net``, naive calibration, 53 quantized convs
and a quantized dense; 1000 classes, 224x224x3): scoring at batch 64 as
``benchmark/int8_score.py`` runs it, and serving through
``ModelRegistry.load(..., precision="int8")`` → ``Batcher`` →
``InferenceEngine``, then the extension surface (``tvmop`` generated ops,
``rtc.CudaModule`` user kernels compiled by NVRTC, a ``CustomOp``, an
external library) at the largest elementwise operand of those models,
ResNet-50 v1 batch-64 training's stage-1 block output (64, 56, 56, 256)
fp32, then ResNet-50 v2 training (``examples.image_classification``'s
defaults with ``--model resnet50_v2``: its 13 stride-1 3x3 convs on the
standalone conv route, ``ops/pallas_conv.py``) with the Gluon losses
and metrics, then the rest of the model zoo: Inception-v3 (1000 classes,
299x299x3) scoring at ``bench.py``'s inception row (batch 32, a fresh
batch each forward) and serving through ``ModelRegistry`` → ``Batcher``
→ ``InferenceEngine`` at buckets (1, 8), AlexNet, VGG-16 (±BN),
SqueezeNet 1.0 and 1.1, MobileNet v1 and v2 (width 1.0) at 224x224x3 and
LeNet at 28x28x1 forward, and DenseNet-121 training through
``examples.image_classification`` at its defaults (its 58 growth convs on
the standalone conv route), then bf16 serving: ResNet-50 v1 and Gluon
BERT-base through ``ModelRegistry.load(..., precision="bf16")`` →
``Batcher`` → ``InferenceEngine`` on the bf16 instances of the softmax
and ``conv_affine`` kernels (``conv_affine`` on its ``wgmma`` AFFINE
instance), then bf16 training: ResNet-50 v1 at batch 128
and Gluon BERT-base at 8 x 512 through ``parallel.FusedTrainStep(dtype=
"bfloat16")`` on the bf16 instances of ``conv3x3``, ``conv_stats``,
``bn_affine``, ``conv_wgrad`` and the softmax, then fp16 training of
ResNet-50 v1, then Gluon BERT-base training with a row-sparse word
embedding (``Embedding(sparse_grad=True)``, the Trainer's lazy update)
and the transformer attention ops of ``ops/attention.py`` at Gluon
BERT-base and Longformer-base widths, then the input path: ResNet-50 v1
training fed from a ``.rec`` file written in the run, through
``io.ImageRecordIter``'s python tier and ``pipeline="datafeed"``, on the
host decode stage (``csrc_host/dataio.cc``, built with g++).  Phases, one JSON line
each; the run stops with a non-zero exit at the first phase that fails:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the NVRTC library's path and version; TF32 is switched
   off for matmul and cuDNN.
2. ``build``: nvcc builds the kernels of ``mxnet_tpu_torch/csrc``.
3. ``kernels``: each kernel at the shapes the path gives it, against its
   plain PyTorch version on the same inputs (LayerNorm within 1e-5, also
   on its block-a-row path at (64, 8192) and (16, 30522); attention
   within 1e-4: its sums run in another order), with CUDA
   event times of the kernel, the plain version and one PyTorch library
   call computing the same function (timed here, never used by the port).
   Causal attention (3xTF32 on the tensor cores) also gives both bounds
   (fp32 on the CUDA cores; its three TF32 products on the tensor cores,
   the line's ``bound_ms``), its share of the card's ``mma.sync`` TF32
   ceiling, and that two launches on the same inputs are bitwise equal
   (a gate).
4. ``slice``: launch counters set to 0, then ``warmup`` is done, then
   ``generate`` at batch 1 and 8 (48-token prompt) and ``DecodeBatcher``
   serving concurrent requests, each stream equal to ``generate`` for its
   prompt; the counters are read after and must both be > 0.
5. ``reference``: the same weights run by the port on the CPU: prefill
   and decode-step logits within 1e-3, greedy tokens equal.
6. ``profile``: prefill and decode step at batch 1 and 8 under
   ``torch.profiler``: kernels per call, device-busy time, idle share.
7. ``bert_kernels``: the flash-attention forward, dq and dk/dv kernels
   (all three 3xTF32 on the tensor cores) against their plain versions
   at BERT-base's shape (a strided view into the qkv projection) and
   three more (o within 1e-4, lse within 1e-5, dq/dk/dv within 1e-4 of
   the tensor's largest magnitude, fed the plain forward's lse and again
   the kernel's), and for each kernel two launches on the same inputs
   bitwise equal (a gate); timed beside both bounds (the three TF32
   products on the tensor cores, the line's ``bound_ms``, and the fp32
   work on the CUDA cores), their share of the ``mma.sync`` TF32
   ceiling, the plain versions and SDPA (forward; backward for dq and
   dk/dv, with ``pair_vs_library``: their two times over SDPA's
   backward), and the backward kernels' plan (blocks, blocks an SM from
   the occupancy API, waves).
8. ``bert_train``: launch counters set to 0, then 6 steps of
   ``examples.bert_pretrain.main``; the loss must be finite and end
   below step 0's, each attention kernel launched 12 times a step and
   LayerNorm 25 times a step.
9. ``bert_reference``: one step at batch 2 on the card and through the
   port on the CPU from the same weights and batch: loss within 1e-4
   relative, every gradient within 1e-3 of its largest magnitude, the
   weights after one AdamW step within 2 * lr.
10. ``bert_profile``: one train step under ``torch.profiler``.
11. ``image_kernels``: the fused conv3x3 + folded BN (+ add) (+ ReLU)
    kernel (the affine instance of ``conv3x3_tc.cu``'s 3xTF32 loop)
    against its plain version at ResNet-50's four 3x3 stages at batch 8,
    the 7x7x512 stage at batch 1, ResNet-18's residual tail, ReLU off and
    a ragged shape (within 1e-4 of the output's largest magnitude: the
    9*C sums run in another order), and two launches on the same inputs
    bitwise equal (a gate); each case's plan (bn, tiles, chunks, ranges,
    ``cut_tiles``), timed beside both bounds (fp32 on the CUDA cores;
    the three TF32 products on the tensor cores, the line's
    ``bound_ms``), its share of the tensor-core bound and of the card's
    ``mma.sync`` TF32 ceiling, its plain version and ``F.conv2d`` alone
    (``vs_library``); at the five stage shapes also the device µs of the
    main and the cut-tile kernel (``kernels_us``).
12. ``image_serve``: the launch counter set to 0, then
    ``ModelRegistry.load`` of a seeded ResNet-50 ``.params`` (warmup of
    every bucket), 32 closed-loop requests from one client and 64 from
    8 client threads through the ``Batcher``; every response finite,
    and exactly 16 kernel launches per forward run.  Device and eager
    ms per forward at each bucket, peak memory.
13. ``image_reference``: card logits against the port on the CPU from
    the same ``.params`` at batch 2 (within 1e-4 of the largest logit,
    top-1 equal), and every batched response against the unbatched
    forward of its image (same tolerance).
14. ``image_profile``: one bucket-8 and one bucket-1 forward under
    ``torch.profiler``.
15. ``train_kernels``: the four training kernels (``conv3x3``, also as
    dgrad on the rotated weight, ``conv_stats``, ``bn_affine``,
    ``conv_wgrad``) against their plain versions at ResNet-50's four 3x3
    stages at batch 64, a C != Cout dgrad/wgrad case, ``bn_affine`` with
    a residual and with ReLU off, and a ragged shape (z, dx, dW within
    1e-4 of the tensor's largest magnitude; sum(z^2) within 1e-5
    relative and sum(z) within 1e-5 of the channel's sum |z|;
    ``bn_affine`` within 1e-6 of its largest magnitude), timed beside
    their bounds, plain versions and the nearest single library call.
    ``conv3x3``, ``conv_stats`` and ``conv_wgrad`` (3xTF32 on the tensor
    cores) also report, per case, their plan (ranges; wgrad's partial
    slots; ``conv_stats`` also ``conv3x3``'s plan at its shape), both
    bounds (fp32 on the CUDA cores; the three TF32 products on the
    tensor cores, the line's ``bound_ms``), fp32-equivalent TFLOP/s, the
    share of the tensor-core bound, the library call's ms, and that two
    launches on the same inputs give bitwise-equal outputs (a gate;
    ``conv_stats``: z, sum(z) and sum(z^2) each); ``conv_stats``' z must
    equal ``conv3x3(x, w)`` bit for bit wherever the two plans agree (a
    gate); the device µs of each kernel the forward ``conv3x3`` and
    ``conv_stats`` launch (``kernels_us``, torch.profiler); and the TF32
    ``mma.sync`` ceiling of the card (independent products on
    registers, no memory, compiled through ``rtc.CudaModule``) with each
    case's share of it.
16. ``image_train``: the launch counters set to 0, then
    ``examples.image_classification.main`` at its defaults with 2
    warm-up and 8 timed steps; the losses finite, each training kernel
    launched exactly 16 times a step and ``conv_affine`` never.  Step ms
    (CUDA events), images/s, peak memory.
17. ``image_train_reference``: one step at batch 2 on the card and
    through the port on the CPU (and on the CPU in float64, the floor)
    from the same seeded weights (the damped-residual init) and batch:
    loss within 1e-4 relative, every gradient within 1e-2 of the net's
    largest gradient, every parameter after the SGD step within 1e-2 of
    the net's largest update, running statistics within 1e-5 of their
    largest magnitude.
18. ``image_train_profile``: one training step under ``torch.profiler``.
19. ``fused_image_train``: ResNet-50 v1 training through
    ``Trainer.fuse_step`` at ``bench.py`` ``train_mode``'s configuration
    (fp32 NHWC 224x224x3, 1000 classes, hybridized, SGD lr 0.1, momentum
    0.9, wd 1e-4, batch 128): 5 steps of the same step function run
    eagerly from Python (timed), then the first fused call (warm-up,
    capture, replay) and 10 replayed steps, each one
    ``CUDAGraph.replay()`` (CUDA events between step starts), then 3
    replays under ``torch.profiler`` (idle share).  Gates: fused, one
    program, no rebuild or fallback, finite losses, and the launches the
    capture recorded a step: 16 each of ``conv3x3``, ``conv_stats``,
    ``bn_affine``, ``conv_wgrad``, none of ``conv_affine`` (the
    replays launch that many times their count).  Eager and replayed
    step ms, images/s, peak memory.
20. ``fused_bert_train``: Gluon BERT-base masked-LM training through
    ``parallel.FusedTrainStep`` at ``bench.py`` ``bert_mode``'s
    configuration in fp32 (8 x 512 tokens, vocabulary 30522, Adam lr
    1e-4, ``SoftmaxCrossEntropyLoss`` over the (8, 512, 30522) logits),
    driven and gated as ``fused_image_train``: 12 ``softmax_fused`` and
    25 ``layernorm_fused`` launches captured a step.
21. ``fused_parity``: replay against the eager legacy step
    (record/backward/``trainer.step``) on the card from the same seeded
    weights and batches, cuDNN deterministic: ResNet-50 v1 at batch 8
    and Gluon BERT-base at 1 x 128 (3 steps), the 20 optimizer cases on
    a small Dense net, ResNet-50 v2 at batch 8 (the standalone conv
    route captured), LAMB under a ``PolyScheduler``, SGD under
    ``CosineScheduler(warmup_steps=2)``
    (one program while the lr moves), a Dense net with Dropout(0.5)
    (each net its own seeded generator), an Adam run whose states
    ``load_states`` replaces between replays, two captures beside what
    breaks one in torch's default capture mode (a thread that syncs with
    the card throughout; a forward that leaves an earlier CUDAGraph to
    the collector mid-capture), DenseNet-121 at batch 8, 64x64 (3
    steps), and ``cast_after_capture``: two replays, ``Block.cast`` to
    bf16 and back to fp32 (the old storage kept alive), a third step,
    bit for bit against the same on the eager path, with one rebuild.
    Losses and weights bit for bit; where they differ the worst
    parameter is printed and the case is gated at the spread of two
    eager runs.
22. ``text_kernels``: the row-softmax kernels against their plain
    version (within 1e-6 absolute: softmax values lie in [0, 1]; rows sum
    to 1 within 1e-5; two launches bitwise equal) at the Gluon BERT's
    shapes at buckets 8 and 1 (49152 and 6144 rows of 512), also with the
    prologue (the scores divided by sqrt(64) and sqrt(48); at bucket 8
    also with a (B, T) key mask), ragged widths 77 and 1000,
    vocabulary rows on thread-block clusters ((4096, 30522), (1024,
    4096), (1024, 30522) with the prologue), rows holding -1e9 and a row
    of only -1e9 (which must give 1/cols) on the warp, cluster and block
    kernels (256 rows of 131072, above the cluster's reach), and a
    strided view; each with its plan (kernel, cluster CTAs), timed beside
    its bound, its plain version, ``torch.softmax`` and, with a
    prologue, the separate passes the prologue replaces.  Then
    ``ops.nn.softmax`` on bf16 at (4, 768), (2, 3, 512) and (8, 30522),
    last axis and axis 0, on the card
    against the port on the CPU: the two devices' rounded sums within one
    bf16 step (the fp32 sums run in another order on the two devices,
    which may move a rounding of the sum by one step), and each value
    within one bf16 step of the CPU's numerator over the CPU's rounded sum
    or over the card's (a sum's step moves a quotient by up to two of its
    own); over the last axis that is now the kernel's bf16 instance (one
    launch), over axis 0 the closed form (none).
23. ``text_serve``: the launch counters set to 0, then
    ``ModelRegistry.load`` of a seeded BERT-base ``.params`` with
    ``dtype="int32"`` (warmup of every bucket), 32 closed-loop requests
    from one client and 64 from 8 client threads; every response finite
    (its sum and argmax kept, the 62.5 MB of logits dropped), and
    exactly 12 softmax (each with the scale as its prologue) and 25
    LayerNorm launches per forward run.  Device and eager ms per forward
    and ms of the copy of its logits to the host at each bucket, p50/p99
    request ms, sequences/s and tokens/s, batch fill, peak memory.
24. ``text_reference``: card logits against the port on the CPU from
    the same ``.params`` at batch 1 x 512 (within 1e-4 of the largest
    logit, argmax equal at >= 99.9% of positions); the 64 concurrent
    requests served again, each response against the forward of its
    sequence alone on the card (same tolerance), and every
    ``text_serve`` response's argmax and sum against that forward.
25. ``text_profile``: one bucket-8 and one bucket-1 forward under
    ``torch.profiler``, each element-wise kernel listed by name.
26. ``int8_kernels``: the int8 3x3/s1 conv + dequantization (+ add)
    (+ ReLU) kernel against its plain version (im2col + ``_int_mm`` +
    the same epilogue) at ResNet-50's four 3x3 stages at batch 64 and 8,
    the 7x7x512 stage at batch 1, ResNet-18's residual tail, ReLU off, a
    ragged shape (C = 20, odd H and W) and an exact case (scale 1, shift
    0: the output must equal the int32 sum bit for bit); every other
    case within 1e-6 of the output's largest magnitude (its epilogue is
    the plain version's two rounded operations, so it is bitwise in
    practice), and two launches on the same inputs bitwise equal (a
    gate).  Each case's plan (``qconv_splits``: bn, tiles, chunks,
    ranges, ``cut_tiles``), timed beside its bound (bytes over 3.35
    TB/s, int8 operations over 1,979 TOPS) and its share of it
    (``bound_share``), the rate at which its blocks copy operands into
    shared memory (``staged_tb_s``), its share of the card's
    ``mma.sync`` int8 ceiling (m16n8k32 on registers, compiled through
    ``rtc.CudaModule``, measured once a run: ``mma_s8_ceiling``), its
    plain version,
    ``torch._int_mm`` on the pre-built patch matrix and the fp32
    ``conv_affine``; at the nine stage shapes also the device µs of the
    main and the cut-tile kernel (``kernels_us``); and at the four
    batch-64 stages the kernel's time beside that of copies of it with
    the ring's copies or its products taken out (``parts``, built here by
    nvcc), which says which of the two bounds its loop.
27. ``int8_score``: ``int8_score.py`` at its defaults: ResNet-50 v1 from
    the ``image_serve`` ``.params``, batch 64, fp32, bf16
    (``amp.convert_model``) and int8 (two ``RandomState(1)``
    calibration batches, naive) images/s over 4 warm-up and 20 timed
    forwards on fresh inputs (CUDA events), the int8-vs-fp32 and
    bf16-vs-fp32 argmax agreements over 256 ``RandomState(0)`` images;
    the launch counters set to 0 before the bf16 forwards and read
    after: 16 bf16 ``wgmma`` ``conv_affine`` launches a forward and no
    other ``conv_affine`` one;
    then before the int8 forwards: exactly 16 int8-kernel and 0
    ``conv_affine`` launches a forward.
28. ``int8_serve``: the counters set to 0, then ``ModelRegistry.load``
    of that ``.params`` with ``precision="int8"`` (the default
    calibration, warmup of every bucket), 32 closed-loop requests from
    one client and 64 from 8 client threads; every response finite and
    16 int8-kernel, 0 ``conv_affine`` launches per forward run.  p50/p99
    request ms, images/s, batch fill, device and eager ms per forward per
    bucket, peak memory; then ``int8_score.py``'s ``--serve`` leg: the
    int8 engine's QPS against the bf16 engine's at bucket 8 (16 bf16
    ``wgmma`` ``conv_affine`` launches a bf16 forward, no other).
29. ``int8_reference``: card logits against the port on the CPU with the
    same int8 weights and thresholds (``state_from_numpy``) at batch 2
    (within 1e-3 of the largest logit, top-1 equal), and every batched
    response against the unbatched forward of its image (same
    tolerance).  The int32 sums are exact and the epilogues the same
    rounded operations on both devices, so only the average pool's sum
    order can differ; one pooled feature crossing a rounding boundary
    of the dense layer's input moves a logit by one int8 step of that
    product, and 1e-3 admits a few such steps and nothing larger.
30. ``int8_profile``: one bucket-8 and one bucket-1 int8 forward under
    ``torch.profiler``, with device time split into the int8 kernel,
    ``_int_mm``, the quantize passes, copies, pools and elementwise
    epilogues.
31. ``ext_kernels``: the three stock generated kernels (``tvm_vadd``,
    ``tvm_vmul``, ``tvm_sigmoid``: ``csrc/tvmop_elementwise.cuh`` with
    their bodies, compiled by NVRTC) against their plain versions at full
    width, one element, 1,000,003 elements (ragged for the 16-byte path),
    an offset view of that (the 16-byte path refused; for ``tvm_vadd``
    also at full width, timed) and float64 / int32 / int64: ``tvm_vadd``
    and ``tvm_vmul`` bit for bit, ``tvm_sigmoid`` within 1e-6 absolute.
    Timed at full width beside the bound (12 or 8 bytes an element over
    3.35 TB/s), the plain version and ``torch.add`` / ``torch.mul`` /
    ``torch.sigmoid``; each kernel's NVRTC compile, cold and from the
    CUBIN cache.
32. ``rtc``: the JAX package's rtc test kernels as CUDA source
    (``examples/rtc_kernels.cu``) through ``rtc.CudaModule``: axpy and
    ``double_it`` (out dtype float32 and int32, one templated kernel) at
    the tests' sizes and at full width, axpy also at 1,000,003 elements
    (16-byte vectors and a scalar tail) and on an offset view at full
    width (the scalar path), bit for bit against plain torch, the full
    width on the 16-byte path (``vector_path``); the module compiles once
    however often it launches; a launch from a second thread; an NVRTC
    syntax error raises with the log and a dtype mismatch raises
    ``TypeError``.  axpy timed (full width and the offset view) beside
    its bound, plain torch and ``torch.add(y, x, alpha=2)``
    (``vs_library``); the eager µs of one launch against one
    ``torch.add``.
33. ``ext_path``: the launch counters set to 0, then at full width
    ``nd.tvm_vadd`` and ``nd.tvm_vmul`` twice each, ``nd.tvm_sigmoid``
    forward and backward under ``autograd.record()`` (the gradient
    within 1e-6 of the plain closed form), a user ``tvmop.register`` of
    ``tvm_test_relu`` run once and unregistered, ``nd.Custom`` of a
    ``t_sigmoid`` ``CustomOp`` forward and backward (torch ops on the
    card), the example library built by ``library.compile_example`` and
    loaded, ``nd.my_relu6`` and ``nd.my_scale(k=3.0)`` forward and
    backward (the host round trip timed), and a user rtc axpy twice;
    every counter must equal the calls made.
34. ``v2_train``: ``mx.seed(0)``, the launch counters set to 0, then 5
    steps of ResNet-50 v2 at ``examples.image_classification``'s
    defaults (batch 64 x 224x224x3, 1000 classes, SGD lr 0.1, momentum
    0.9, wd 1e-4) under ``mx.lr_scheduler.FactorScheduler(step=2,
    factor=0.5)``: ``autograd.record()`` forward and
    ``SoftmaxCrossEntropyLoss``, ``backward``,
    ``trainer.allreduce_grads()``, ``trainer.update(64)``, then a
    ``CompositeEvalMetric`` of Accuracy, TopKAccuracy(5), CrossEntropy
    and Loss updated with the labels and the softmax of the logits inside
    ``torch.cuda.set_sync_debug_mode("error")`` (a host synchronisation
    in ``update`` raises).  Gates: 26 ``conv3x3`` launches (13 forward,
    13 dgrad) and 13 ``conv_wgrad`` launches a step and no fused-segment
    kernel, finite losses, the lr schedule, the CrossEntropy metric
    within 1e-4 relative of the mean loss and the Loss metric (the mean
    probability) within 1e-5 relative of 1/1000.  Step ms (CUDA events,
    median of the last 4), images/s, peak memory; then one step under
    ``torch.profiler`` (idle share, device time by category) and the
    same 13 convs' forward and backward through cuDNN (``F.conv2d`` and
    autograd) under it, the device time the route replaced.
35. ``v2_train_reference``: one step of ResNet-50 v2 (its widths, one
    bottleneck a stage: ``V2_REF_DEPTH``) at batch 64 on the
    card and through the port on the CPU from the same weights (a
    ``.params`` file) and batch, and on the CPU in float64: per-sample
    losses within 1e-3 of the largest, every parameter and running
    statistic after the step within 1e-3 of the largest magnitude in the
    net, or, for a tensor whose CPU float32 step already lies farther
    than that from the float64 step (the stem conv's weight, whose
    gradient cancels), the card's step no farther from the float64 step
    than twice the CPU's float32 step.
36. ``loss_metric``: each Gluon loss the port added (Huber, Hinge,
    SquaredHinge, Logistic signed and binary, SigmoidBCE on logits and on
    probabilities, KLDiv on log-probabilities and on logits, Triplet,
    CosineEmbedding, PoissonNLL, SDML) at (64, 1000) fp32 on the card
    against the port on the CPU, the value and its input's gradient
    within 1e-5 of the largest magnitude; ``pick`` and
    ``SoftmaxCrossEntropyLoss`` with indices in [-n, 0) and outside
    [-n, n) on the card (NaN, no device assert) against the CPU; each
    metric fed card tensors against the same metric fed CPU tensors
    (counts equal, values within 1e-6 relative).

37. ``zoo_kernels``: ``conv3x3`` (row 7) against its plain version at
    the zoo's shapes: VGG-16's 3→64 stem at (32, 224, 224) (the scalar
    path, ``vec = 0``, K = 27 in one 32-column chunk), DenseNet-121's
    128→32 growth conv at (64, 56, 56) forward and as dgrad (with
    ``conv_wgrad``, row 11, at the same shape), Inception-v3's 64→96 and
    96→96 at (32, 35, 35), 448→384 at (32, 8, 8) and 32→64 at (32, 147,
    147), and SqueezeNet 1.0's 16→64 at (32, 54, 54): within 1e-4 of the
    output's largest magnitude and two launches bitwise equal (gates);
    each timed beside both bounds, its plain version and the cuDNN call
    of the same function (``F.conv2d``, ``conv2d_input``,
    ``conv2d_weight``; ``vs_library``), with its plan; the shapes where
    the kernel is slower than cuDNN are listed (``slower_than_library``).
38. ``zoo_serve``: every launch counter set to 0, then Inception-v3
    from a seeded ``.params`` scored at batch 32 x 299x299x3 (3 warm-up
    and 10 timed forwards, each on a fresh batch: images/s, device and
    eager ms a forward, peak memory, two forwards under
    ``torch.profiler``), then ``ModelRegistry.load(...,
    arch="inceptionv3", item_shape=(299, 299, 3))`` at buckets (1, 8),
    32 closed-loop requests from one client (p50/p99) and 64 from 8
    client threads (and a bucket-1 forward under the profiler); every
    response finite (1, 1000), ``conv3x3``
    launched exactly 10 times a forward and no other kernel, in the
    scored forwards and (the counters set to 0 again before the load)
    in the engine's.
39. ``zoo_reference``: card logits against the port on the CPU from the
    same seeded weights at batch 2 for Inception-v3 (299x299) and each
    forward-only family at its standard input (within 1e-4 of the
    largest logit, top-1 equal), each family's ``conv3x3`` launches in
    that forward exactly its count (Inception 10, VGG-16 13, AlexNet 3,
    SqueezeNet 8, MobileNet and LeNet 0), and every batched
    ``zoo_serve`` response against the unbatched forward of its image
    (same tolerance).
40. ``zoo_train``: every counter set to 0, then 5 steps (2 warm-up and
    3 timed) of ``examples.image_classification.main`` with ``--model
    densenet121`` at its defaults (batch 64 x 224x224x3, 1000 classes,
    SGD lr 0.1, momentum 0.9, wd 1e-4): finite losses, exactly 116
    ``conv3x3`` and 58 ``conv_wgrad`` launches a step and no other
    kernel.  Step ms (CUDA events, median of the last 4), images/s, peak
    memory; one step of a fresh net under ``torch.profiler`` (device
    time by category, idle share against the uninstrumented step).
41. ``zoo_train_reference``: one DenseNet-121 step at batch 2, 64x64 (a
    reduced image size), on the card, on the CPU and on the CPU in
    float64, from the same weights and batch, gated as
    ``v2_train_reference`` with the losses within 1e-5 relative.

42. ``bf16_kernels``: the half-precision instances against their plain
    versions on the card, each launched twice (bitwise equal: a gate).
    Row 1 (``softmax_fused``) in bf16 at the Gluon BERT's bucket-8 call
    ((49152, 512), ÷8, a (B, T) key mask), bucket 1 ((6144, 512) with and
    without ÷8), (4096, 30522), a ragged 77 and rows of 131072 (three
    passes), and in fp16 at (49152, 512) ÷8 with the mask, (6144, 512)
    and (4096, 30522): each value within one step of the plain
    numerator over the plain rounded sum or over that sum moved one step
    (the fp32 sums run in another order).  Row 8 (``conv_affine``) in
    bf16 at ResNet-50's four 3x3 stages at batch 8 and stage 1 at batch
    64, each without and with a residual, stage 1 with the ReLU off, and
    a ragged shape (C = 20): where the ``wgmma`` kernel takes the shape,
    the ``mma.sync`` instance launched directly and then the wrapper,
    which must launch the ``wgmma`` kernel (the loop's AFFINE epilogue),
    timed on the same inputs beside the former (``parent_ms``), with its
    main and reduce kernels' µs and its share of the ``wgmma`` ceiling;
    the ragged shape through the wrapper to the ``mma.sync`` kernel.
    Each value within one bf16 step of its plain version (bf16 widened,
    the conv in fp32, one rounding), or within 1e-5 of the largest
    output near 0.  Each timed beside its bound (bytes at 2 an element
    over 3.35 TB/s; bf16 operations over 989 TFLOP/s dense), its plain
    version and the library call on bf16 (``torch.softmax``;
    ``F.conv2d`` alone), with its plan.
43. ``bf16_serve``: the counters set to 0, then ResNet-50 v1 through
    ``ModelRegistry.load(..., precision="bf16")`` (``amp.convert_model``
    on the card), 32 closed-loop requests and 64 from 8 clients: exactly
    16 ``conv_affine`` launches a forward, all of them its bf16 ``wgmma``
    kernel (none of the ``mma.sync`` or fp32 one); then the
    counters set to 0 again and Gluon BERT-base on 512-token int32 items
    the same way: exactly 12 bf16 softmax launches a forward and no fp32
    one (its LayerNorms are the reference's closed form in bf16).  Every
    response finite; p50/p99, items/s (tokens/s), batch fill, device and
    eager ms a forward per bucket, the idle share of a bucket-8 and a
    bucket-1 forward, the logits' copy to the host, peak memory.  Then
    Inception-v3 cast to bf16, three forwards at batch 2: exactly 10
    bf16 ``conv3x3`` launches a forward (its lone 3x3/s1 convs), all on
    the ``wgmma`` kernel, no other kernel.
44. ``bf16_reference``: the card's bf16 engines against the port's bf16
    on the CPU from the same ``.params``: ResNet-50 at batch 2 (top-1
    equal) and BERT-base at 1 x 512, and each batched response against
    the unbatched forward of its item on the card (ResNet-50's 64
    concurrent responses, four of BERT-base's, whole).  Each distance
    below the CPU's own bf16-vs-fp32 distance on the same items; argmax
    agreement no lower than bf16's against fp32 on the CPU.  ``flops()``
    of each card net equals that of its fp32 copy on the CPU, and taking
    it launches no kernel.
45. ``bf16_train_kernels``: the bf16 kernels of ``conv3x3`` (as the
    dgrad), ``conv_stats``, ``bn_affine`` and ``conv_wgrad`` at
    ResNet-50's four 3x3 stages at batch 128, two edges of the ``wgmma``
    kernels (one 128 x 64 tile; 3x7x9 pixels, C 40, Cout 24) and a
    ragged shape (C = 20, the scalar paths), ``bn_affine`` also with a
    residual and with the ReLU off, each against its plain version (bf16
    widened, fp32 sums, one rounding): bf16 outputs within one bf16 step
    (or 1e-5 of the largest near 0), Σz and Σz² (Σz of the channel's
    Σ|z|) and the fp32 dW within 1e-5; each launched twice, bitwise
    equal (a gate); timed beside its bound (bytes at 2 an element, 4 for
    fp32 dW and statistics, over 3.35 TB/s; bf16 operations over 989
    TFLOP/s), its plain version and the nearest library call on bf16
    (``conv2d_input``, ``F.conv2d``, ``torch.addcmul``,
    ``conv2d_weight``), with its plan.  ``conv3x3``, ``conv_stats`` and
    ``conv_wgrad`` twice: the ``wgmma`` kernels through the wrappers
    (which must launch them) with the ``mma.sync`` instances timed on the
    same inputs (``parent_ms``), their main and reduce (cut, sum) kernels'
    µs, TFLOP/s and share of the card's ``wgmma`` bf16 ceiling (measured:
    m64n128k16 products from shared memory, no copies), and the
    ``mma.sync`` instances launched directly as their own cases;
    ``conv_stats``' z also bit for bit ``conv3x3(x, w)`` where the two
    plans agree (a gate); the host µs of an eager call of each ``wgmma``
    wrapper, warm and cold, with the tensor-map cache's hits and misses;
    ``parts`` (the loop without its copies or products) for the dgrad,
    ``conv_stats`` and the dW.  With ``--parent DIR`` the fp32 instances
    of the conv files (conv3x3, dgrad, conv_stats, bn_affine,
    conv_wgrad, conv_affine at four shapes) must equal the build of the
    checkout at DIR bit for bit, and the bf16 wrappers are timed at the
    stages in both checkouts in turns (parent, change, change,
    parent).
46. ``bf16_train``: ResNet-50 v1 at batch 128 (SGD lr 0.1, momentum 0.9,
    wd 1e-4) and Gluon BERT-base at 8 x 512 (Adam lr 1e-4) through
    ``FusedTrainStep(dtype="bfloat16")``, each driven as the fused phases
    drive theirs on one fixed batch for 21 calls: exactly 16 launches of
    each of the four training kernels captured a ResNet step, all bf16
    (no fp32 launch), ``conv3x3``'s, ``conv_stats``' and ``conv_wgrad``'s
    all on the ``wgmma`` kernels (none on the ``mma.sync`` ones), 12 bf16
    softmaxes a BERT step and no LayerNorm
    kernel; finite losses that fall; replayed and eager step ms, images/s
    or tokens/s, peak memory, idle share, the hand-written kernels' µs a
    replay, beside the fp32 fused step of the same run.
47. ``bf16_train_reference``: two bf16 fused SGD steps of ResNet-18 v1
    (64x64, batch 2, damped residual γ) and of ``bert_small`` on the card
    against the port on the CPU from the same weights and batches: the
    card's losses and weights no farther from the CPU's bf16 step than
    that is from the CPU's fp32 step.
48. ``fp16_train_kernels``: the fp16 kernels of rows 7 (dgrad), 9, 10
    and 11 at ResNet-50's four stages at batch 128, the ``wgmma`` edges
    and the ragged C = 20, and row 8 at the converted forward's shapes
    with fp16 and fp32 statistics, against their plain versions (fp16
    outputs within one fp16 step, inf where the plain version's are; fp32
    sums and dW within 1e-5), bitwise on relaunch, each through the
    kernel its shape takes, timed beside bound, plain version, the fp16
    library call and the ``wgmma`` f16 ceiling; an overflowing and a
    subnormal case; bf16 ``conv_affine`` with fp32 statistics (the frozen
    segment's repair).
49. ``fp16_train``: ResNet-50 v1 at batch 128 through
    ``FusedTrainStep(dtype="float16", grad_scale=1024)`` (21 calls, one
    captured graph a step: 16 fp16 launches of each training kernel, the
    convs on ``wgmma``; finite, falling losses) beside the bf16 step; the
    same step with one ``use_global_stats`` segment in bf16 and fp16;
    the eager ``amp.init("float16")`` Trainer at batch 64 (the loss
    scale's trajectory from 2^16; rows 7 and 11 in fp16); the
    ``amp.convert_model(..., "float16")`` forward at batch 8 (16 fp16
    ``conv_affine`` launches).
50. ``fp16_train_reference``: two fp16 fused SGD steps of ResNet-18 v1
    (64x64, batch 2, damped residual γ, ``grad_scale`` 1024) on the card
    against the port on the CPU: no farther from the CPU's fp16 step
    than that is from the CPU's fp32 step.
51. ``sparse_train``: Gluon BERT-base masked-LM training at
    ``fused_bert_train``'s configuration (8 x 512 tokens, fp32, Adam lr
    1e-4) with the word embedding an ``Embedding(sparse_grad=True)``: 6
    calls of ``Trainer.fuse_step`` (fallback ``sparse_param``, counted),
    then 6 of the plain record / backward / ``trainer.step`` loop, on two
    seeded batches in turns; finite losses, each batch's falling; 12
    ``softmax_fused`` and 25 ``layernorm_fused`` launches a forward;
    after every step the untouched rows of the table and of both Adam
    moments bit for bit, the touched rows bit for bit the dense Adam
    rule on a copy of those rows, their count beside the 3,834 expected.
    The eager step sparse against dense in turns, the lazy update alone
    against the dense update of the 30522 x 768 table (CUDA events, host
    waits included), and two narrow layers, 3 steps, card against CPU
    (weights within 2·lr·steps, the same rows touched, the untouched
    ones bit for bit).
52. ``attention_ops``: ``ops/attention.py``'s seven ops and the masked
    softmax pair, forward and backward, card against CPU within 1e-5 of
    each tensor's largest magnitude: the interleaved ops at Gluon
    BERT-base width (qkv (512, 8, 12·3·64), a valid-length key mask),
    ``causal=True`` also in bf16 and fp16 (one step of the dtype or 1e-5
    of the largest magnitude, fp16's -inf where the CPU's are); the sliding-window ops at Longformer-base
    width (1 x 4096, 12 heads of 64, w 256, symmetric) and dilated,
    one-sided at L 1024; ``sldwin_atten_mask_like`` bit for bit; each
    op's card ms.
53. ``input_train``: the input path.  A ``.rec`` / ``.idx`` pair of 1,408
    JPEGs (22 batches of 64) at 500x375x3, quality 90, written here
    through ``recordio.pack_img`` from seeded smooth fields with edges
    and mild noise (bytes, encode seconds).  The decode held on this
    host: ``imdecode`` of the first 64 twice, bit for bit, and against
    its source (PSNR at least 30 dB where nvJPEG decodes; the native
    loader's 8/8 pixels bit for bit the python tier's where libjpeg
    does), and where OpenCV is installed, ``imresize`` within one level
    of ``cv2.resize`` (linear and cubic).  Images/s of both tiers
    (``ImageRecordIter``'s python tier, the native loader) at
    ``preprocess_threads`` 1, 2, 4 and the host's cores, with the
    loader's stage µs.  ResNet-50 v1 training through
    ``examples.image_classification`` (eager Trainer, batch 64 x 224²,
    2 warm-up and 20 timed steps) on the synthetic feed, from the file
    through the python tier, and through ``pipeline="datafeed"``
    (resize 256, random crop and mirror, ImageNet mean and std): step
    ms against the synthetic step, images/s, ``DataFeed.stats()`` (h2d
    bytes a batch against an fp32 wire's, sync fallbacks,
    backpressure), the launches of ``conv3x3``, ``conv_stats``,
    ``bn_affine`` and ``conv_wgrad`` (16 each a step, a gate), and each
    feed's idle share over 5 profiled steps.  Then ``io.feedcheck``'s
    verdicts, all of which must hold.

Train → checkpoint → serve over HTTP (ResNet-50 v1, 224², fp32):

54. ``ckpt_train``: ``bench.py ckpt_mode`` at the training cell (batch
    64, SGD momentum, ``Trainer.fuse_step``): 2 warm steps, 6 with an
    async ``CheckpointManager(keep=2).save_trainer`` each; pause µs,
    bytes, the commit's d2h / sha256 / write + fsync ms, pending saves
    and the card bytes they hold, restore ms, step ms without and with a
    save in turns.  The step-3 checkpoint (hard-linked as it is
    published) resumed into a fresh net and Trainer and into the live
    fused one (no rebuild), steps 4-6 bit for bit against the run that
    never stopped (cuDNN deterministic for this phase); fp32, bf16 and
    fp16 card leaves in one tree, saved twice, restore bit for bit; a
    ``torn_write`` save falls back.  Rows 7, 9-11: 16 a captured step.
55. ``serve_plane``: two ``python -m mxnet_tpu_torch.serve --model
    r50=resnet50_v1:<step-3 root>`` replicas behind a ``Router``, and an
    in-process ``InferenceServer`` over ``ModelRegistry.load``: healthz
    ``warming`` → ok, router outputs bit for bit the in-process
    ``predict``'s, a 16-client burst against the unbatched forward
    (1e-4 of the largest logit, argmax where the top two are apart),
    ``/metrics`` as Prometheus text, 429 with ``Retry-After``, drain /
    undrain, a ``publish`` of the run's checkpoint under a burst (no
    request lost, the new weights served), row 8 at 16 a forward; JSON
    encode / decode ms, HTTP p50 / p99 at 1 and 8 clients, items/s, the
    in-process p50.
56. ``chaos``: ``resilience_bench()`` at its defaults on the card (zero
    client-visible failures, a breaker cycle, a respawn, ≥ 1.5× at 2
    replicas), then ``serve_bench()`` on ``mlp`` and ResNet-50, 5 s each.

The observed fleet (ResNet-50 v1, 224², 1000 classes, fp32):

57. ``int8_calib``: the seeded ResNet-50 published into a fresh model
    store and loaded by ``get_model(pretrained=True, root=)``, then the
    store emptied and the weights downloaded again from a ``file://``
    ``MXNET_GLUON_REPO`` mirror (sha1 checked both times, a corrupted
    copy refused, the parameters bit for bit the seeded ones).  An eager
    scoring loop of 4 seeded batches of 32 on the card under
    ``observe_activations``: row 8 at 16 a forward, a ``quant.amax.*``
    gauge for each of the 54 quantizable layers, the ``naive``
    thresholds read back from the registry within 1e-6 of the max |x|
    that ``quantize_net``'s own collector takes of the same inputs, every
    ``entropy`` threshold ≤ its amax.  ``quantize_net(thresholds=)`` →
    ``ModelRegistry`` (precision int8, the twins pass through): row 12
    at 16 a forward, none of row 8, argmax agreement with fp32 on 64
    seeded images at least a directly calibrated int8 net's.  Prints the
    observed and plain forward ms, host transfers and ``quant.act``
    observations a batch, int8 images/s at batch 32.
58. ``obs_fleet``: ``obs.check.check`` at full width: a ``--selftest-model
    web`` replica on the card behind a ``Router`` at 15 qps, four decode
    workers (host processes; two feed fewer batches than the step takes,
    and the watchdog fires without a fault) serving
    ``synthetic:64x3x224x224``, a ``FeedClient`` → ``DataFeed``
    (finalized to NHWC fp32 on the card) feeding the example's fused
    ResNet-50 step at batch 64, the recorder at 250 ms with the seeded
    watchdog, ``MXNET_OBS_PEAK_FLOPS`` the card's fp32 peak.  A
    ``client:delay`` fault sized from the measured step makes
    ``input_starved`` fire and, removed, clear; the merged report holds
    serve, feed and trainer rates and finite stall, goodput and MFU.  Rows 7, 9-11 at 16 a captured step.  Prints step ms in the
    fleet and alone, MFU, the stall fraction before, under and after the
    fault, goodput and the recorder's dropped frames.
59. ``trace_check``: ``tracecheck._selfcheck`` on the card: the
    ``--selftest-model trace`` replica behind a ``Router``, and a decode
    worker feeding the fused ResNet-50 step through a ``prefetch=0``
    ``FeedClient``; one trace id across both pids in each leg, every
    child within its parent, each ``serve.execute`` linking its
    requests, the merged file valid Chrome trace JSON.

Then one ``{"kernels": [...]}`` line (35 entries: the bf16 and fp16
instances of rows 7, 8, 9, 10 and 11 and the bf16 one of row 1 their
own, rows 7, 8, 9 and 11 twice a half type: the ``wgmma`` kernels and
the ``mma.sync`` ones; ``launches`` adds
the fused phases' real launches: the first call's warm-up and the
replays times the captured counts), the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this file, it exits non-zero and prints
no result.

    python3 chip_smoke.py --phases env,build,train_kernels

runs only the named phases, in that order, and prints their lines (no
kernels or result line).  Two commits are compared on one card by
running each checkout's own script in turns (parent, change, change,
parent), each on its own package and build.
"""
import atexit
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): device memory, fp32 on CUDA cores,
# dense int8 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12
PEAK_INT8_OPS_S = 1979e12

LN_TOL = 1e-5
ATTN_TOL = 1e-4
LSE_TOL = 1e-5
REF_TOL = 1e-3
BERT_STEPS = 6
BERT_LOSS_RTOL = 1e-4
MAX_NEW = 32
SEED = 0
SLEEP_CYCLES = 40_000_000      # ~20 ms at the H100's boost clock


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, repeats=5, sleep=SLEEP_CYCLES):
    """Device time of one call of ``fn`` in ms: the median over
    ``repeats`` CUDA-event windows of ``iters`` back-to-back calls.  Each
    window starts behind a device-side sleep of ``sleep`` cycles (~20 ms
    by default), so the host has queued every call before the first one
    runs and the window holds device time only, not the host's launch
    overhead: the sleep must outlast the host's time to queue the
    ``iters`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def eager_ms(fn, iters=20):
    """Wall time of one call of ``fn`` in ms when called back to back
    from Python, launch overhead included (what an eager caller sees)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes, flops, peak=PEAK_FP32_FLOP_S):
    """The least time of the work on this card: the larger of its bytes
    over the memory rate and its operations over ``peak``."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / peak * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


# ---------------------------------------------------------------- phases
def phase_env(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from mxnet_tpu_torch import _nvrtc, context
    context.exact_fp32()
    state["card"] = smi
    return {"card": smi, "device": torch.cuda.get_device_name(0),
            "nvrtc": _nvrtc.info(),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}


def phase_build(state):
    from mxnet_tpu_torch import _build, _host_build
    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            t = time.perf_counter()
            _host_build.build(force=True)
            host["seconds"] = time.perf_counter() - t
        except Exception as e:      # noqa: BLE001 — raised below
            host["error"] = e

    th = threading.Thread(target=build_host)
    th.start()
    _build.build(force=True)
    _build.lib()
    th.join()
    if "error" in host:
        raise host["error"]
    host["decoder"] = _host_build.info()
    ptxas, fn = {}, None
    for ln in _build.last_build_log.splitlines():
        m = re.search(r"entry function '\S*?(flash_fwd_tc|layernorm_fwd|"
                      r"flash_dq_tc|flash_dkv_tc|conv_affine_tc_kernel|"
                      r"conv_affine_reduce_kernel|"
                      r"conv3x3_tc_kernel|conv3x3_reduce_kernel|"
                      r"conv_stats_tc_kernel|conv_stats_cut_kernel|"
                      r"conv_wgrad_kernel|wgrad_reduce_kernel|"
                      r"layernorm_row_fwd|bn_affine_kernel|"
                      r"softmax_warp_kernel|softmax_cluster_kernel|"
                      r"softmax_block_kernel|"
                      r"qconv_affine_kernel|qconv_reduce_kernel)"
                      r"I((?:L[ib]\d+E)+)E", ln)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            fn = f"{m.group(1)}<{args}>"
        elif "Compiling entry function" in ln:
            fn = None           # a kernel not listed: its lines are not ours
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            ptxas.setdefault(fn, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn:
            ptxas.setdefault(fn, {})["spill_store_bytes"] = int(m.group(1))
    return {"seconds": time.perf_counter() - t0,
            "host_stage": host,
            "nvcc_seconds": _build.last_build_s,
            "sources": [str(s.relative_to(HERE)) for s in _build.SOURCES],
            "ptxas": ptxas}


def _ln_case(rows, C, gen):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda_kernels import (layernorm_fused,
                                                  layernorm_plain)
    x = torch.randn(rows, C, device="cuda", generator=gen)
    g = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    b = 0.1 * torch.randn(C, device="cuda", generator=gen)
    out = layernorm_fused(x, g, b)
    ref = layernorm_plain(x, g, b)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    nbytes = (2 * rows * C + 2 * C) * 4
    flops = 8 * rows * C
    bms, by = bound(nbytes, flops)
    return {"shape": [rows, C], "max_abs_err": err, "tol": LN_TOL,
            "kernel_ms": cuda_ms(lambda: layernorm_fused(x, g, b)),
            "kernel_eager_ms": eager_ms(lambda: layernorm_fused(x, g, b)),
            "plain_ms": cuda_ms(lambda: layernorm_plain(x, g, b)),
            "library_ms": cuda_ms(
                lambda: F.layer_norm(x, (C,), g, b, 1e-5)),
            "bytes": nbytes, "flop": flops, "bound_ms": bms,
            "bound_by": by}


def _attn_case(B, H, L, hd, gen):
    """q/k/v as the GPT prefill passes them: per-head [q|k|v] views
    into one (B, L, 3*H*hd) projection."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda_attention import (causal_attention,
                                                    causal_attention_plain)
    t5 = torch.randn(B, L, H, 3, hd, device="cuda", generator=gen)
    q, k, v = (t5[:, :, :, i].transpose(1, 2) for i in range(3))
    scale = hd ** -0.5
    out = causal_attention(q, k, v, scale)
    again = causal_attention(q, k, v, scale)
    ref = causal_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    nbytes = 4 * B * H * L * hd * 4
    flops = 4 * B * H * hd * (L * (L + 1) // 2)
    case = {"shape": [B * H, L, hd], "max_abs_err": err, "tol": ATTN_TOL,
            "bitwise_equal_relaunch": bool(torch.equal(out, again)),
            "kernel_ms": cuda_ms(lambda: causal_attention(q, k, v, scale)),
            "kernel_eager_ms": eager_ms(
                lambda: causal_attention(q, k, v, scale)),
            "plain_ms": cuda_ms(
                lambda: causal_attention_plain(q, k, v, scale)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))}
    return _tc_bounds(case, nbytes, flops)


def _tc_bounds(case, nbytes, flops):
    """Both bounds of a 3xTF32 kernel into ``case``: its three TF32
    products on the tensor cores (``bound_ms``) and the fp32 work on the
    CUDA cores beside it, with the kernel's share of the first and its
    time over the library call's."""
    fp32_ms, fp32_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_S)
    case.update(bytes=nbytes, flop=flops, bound_ms=tc_ms, bound_by=tc_by,
                bound_fp32_ms=fp32_ms, bound_fp32_by=fp32_by,
                tf32_flop=3 * flops,
                tensor_core_bound_share=tc_ms / case["kernel_ms"],
                vs_library=case["kernel_ms"] / case["library_ms"])
    return case


def _ceiling_shares(state, cases):
    """Each 3xTF32 case's share of the card's ``mma.sync`` TF32 ceiling,
    measured once a run."""
    if "mma_tf32_ceiling" not in state:
        state["mma_tf32_ceiling"] = _mma_tf32_ceiling()
    tflop_s = state["mma_tf32_ceiling"]["tflop_s"]
    for c in cases:
        c["mma_sync_ceiling_share"] = \
            c["tf32_flop"] / (c["kernel_ms"] * 1e-3) / 1e12 / tflop_s
    return state["mma_tf32_ceiling"]


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ln = [_ln_case(r, 768, gen) for r in (4096, 512, 8, 1)] + \
        [_ln_case(64, 8192, gen), _ln_case(16, 30522, gen)]
    attn = [_attn_case(8, 6, 512, 128, gen), _attn_case(1, 6, 512, 128, gen),
            _attn_case(8, 12, 512, 64, gen), _attn_case(1, 6, 200, 128, gen)]
    bad = [c for c in ln + attn if not c["max_abs_err"] <= c["tol"] or
           not c.get("bitwise_equal_relaunch", True)]
    state["cases"] = {"layernorm_fused": ln, "causal_attention": attn}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, attn)
    return {"cases": state["cases"], "mma_tf32_ceiling": ceiling}


def _mean_us(h0, h1, name):
    a, b = h0.get(name, {}), h1.get(name, {})
    n = b.get("count", 0) - a.get("count", 0)
    return (b.get("sum", 0.0) - a.get("sum", 0.0)) / n if n > 0 else None


def phase_slice(state):
    import numpy as np
    import torch
    from mxnet_tpu_torch import DecodeBatcher, DecodeEngine, telemetry
    from mxnet_tpu_torch.models import gpt
    from mxnet_tpu_torch.ops.cuda_attention import causal_attention
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused

    cfg = gpt.GPTConfig(vocab_size=8192, hidden=768, layers=12, heads=6,
                        intermediate=3072, max_len=1024)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    prompt = rs.randint(1, cfg.vocab_size, size=48).tolist()
    state.update(cfg=cfg, prompt=prompt)

    layernorm_fused.launches = 0
    causal_attention.launches = 0
    telemetry.reset()
    t0 = time.perf_counter()
    eng = DecodeEngine(params, cfg, name="smoke-gpt", window=576,
                       buckets=(1, 8), prompts=(512,)).warmup()
    warmup_s = time.perf_counter() - t0
    state["engine"] = eng

    def leg(nreq):
        eng.generate([prompt] * nreq, max_new=2)
        h0 = telemetry.raw_snapshot()["histograms"]
        t0 = time.perf_counter()
        out = eng.generate([prompt] * nreq, max_new=MAX_NEW)
        dt = time.perf_counter() - t0
        h1 = telemetry.raw_snapshot()["histograms"]
        assert all(len(o) == MAX_NEW for o in out)
        assert all(0 <= t < cfg.vocab_size for o in out for t in o)
        return {"tokens_s": nreq * MAX_NEW / dt,
                "prefill_us": _mean_us(h0, h1, "decode.prefill_us"),
                "decode_step_us": _mean_us(h0, h1, "decode.decode_step_us"),
                "seconds": dt}, out

    b1, out1 = leg(1)
    b8, out8 = leg(8)
    b8["rows_equal_b1"] = all(o == out1[0] for o in out8)

    prompts = [rs.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 48, 64, 100, 9)]
    got, errs = {}, []
    with DecodeBatcher(eng, slots=8, name="smoke") as bat:
        def one(i, p):
            try:
                got[i] = bat.submit(p, max_new=16, timeout=300)
            except Exception as e:
                errs.append(repr(e))

        ts = [threading.Thread(target=one, args=(i, p))
              for i, p in enumerate(prompts)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        bstats = bat.stats()
    if errs or len(got) != len(prompts):
        raise AssertionError(f"batcher requests failed: {errs}")
    singles = [eng.generate([p], max_new=16)[0] for p in prompts]
    launches = {"layernorm_fused": layernorm_fused.launches,
                "causal_attention": causal_attention.launches}
    state["launches"] = launches
    mismatched = [i for i in range(len(prompts)) if got[i] != singles[i]]
    if mismatched:
        raise AssertionError(f"batcher streams {mismatched} differ from "
                             "generate")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {"config": {k: v for k, v in vars(cfg).items() if k != "dtype"},
            "window": 576, "buckets": [1, 8], "prompt_buckets": [512],
            "prompt_len": len(prompt), "max_new": MAX_NEW,
            "init_s": init_s, "warmup_s": warmup_s, "b1": b1, "b8": b8,
            "batcher": {"requests": len(prompts), "max_new": 16,
                        "joins": bstats["joins"],
                        "max_concurrent": bstats["max_concurrent"],
                        "streams_equal_generate": True},
            "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_reference(state):
    """The same weights through the port on the CPU."""
    import torch
    from mxnet_tpu_torch import DecodeEngine
    from mxnet_tpu_torch.models import gpt

    cfg, prompt, eng = state["cfg"], state["prompt"], state["engine"]
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_params = gpt.init_params(cfg, seed=SEED, device="cpu")
    cpu = DecodeEngine(cpu_params, cfg, name="smoke-cpu", window=576,
                       buckets=(1,), prompts=(512,), device="cpu")
    toks = torch.zeros(1, 512, dtype=torch.long)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.no_grad():
        lg = gpt.apply(eng.params, cfg, toks.cuda()).cpu()
        lc = gpt.apply(cpu_params, cfg, toks)
    prefill_err = (lg - lc).abs().max().item()

    # decode steps from the card's prefilled ring, the same on both sides
    ctl = eng.prefill([prompt])
    k, v = ctl["k"].clone(), ctl["v"].clone()
    kc, vc = k.cpu(), v.cpu()
    pos, tok = ctl["pos"].clone(), ctl["tok"].clone()
    step_err = 0.0
    with torch.no_grad():
        for _ in range(3):
            pos += 1
            a, _, _ = gpt.decode_step(eng.params, cfg, tok, pos, k, v)
            b, _, _ = gpt.decode_step(cpu_params, cfg, tok.cpu(), pos.cpu(),
                                      kc, vc)
            step_err = max(step_err, (a.cpu() - b).abs().max().item())
            tok = a.argmax(-1)

    card_toks = eng.generate([prompt], max_new=16)[0]
    cpu_toks = cpu.generate([prompt], max_new=16)[0]
    ok = (torch.allclose(lg, lc, atol=REF_TOL, rtol=REF_TOL) and
          step_err <= REF_TOL and card_toks == cpu_toks)
    res = {"prefill_logits_max_abs_diff": prefill_err,
           "decode_logits_max_abs_diff": step_err, "tol": REF_TOL,
           "greedy_tokens_equal": card_toks == cpu_toks,
           "tokens": card_toks}
    if not ok:
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


# kernel-name patterns of the profile's categories, first match wins
KERNEL_CATEGORIES = (
    ("conv_stats wgmma (ours)", r"conv_stats_wgmma(_cut|_sum)?_kernel"),
    ("conv_affine wgmma (ours)", r"conv_affine_wgmma(_reduce)?_kernel"),
    ("conv_affine (ours)",
     r"conv_affine_(tc|reduce|bf16|bf16_reduce|f16|f16_reduce)_kernel"),
    ("conv3x3 / dgrad (ours)",
     r"conv3x3_(tc|reduce|bf16|bf16_reduce|f16|f16_reduce)_kernel"),
    ("conv3x3 / dgrad wgmma (ours)", r"conv3x3_wgmma(_reduce)?_kernel"),
    ("conv_wgrad wgmma (ours)", r"conv_wgrad_wgmma(_reduce)?_kernel"),
    ("conv_stats (ours)", r"conv_stats_(tc|cut|sum|bf16|f16)_kernel"),
    ("bn_affine (ours)", r"bn_affine(_bf16|_f16)?_kernel"),
    ("conv_wgrad (ours)",
     r"conv_wgrad(_bf16|_f16)?_kernel|wgrad_reduce_kernel"),
    ("batch norm", r"batch_norm|bn_fw"),
    ("layout transform", r"nchwToNhwc|nhwcToNchw"),
    ("cuDNN conv backward", r"dgrad|wgrad|bprop"),
    ("cuDNN conv", r"fprop|convolve|implicit_gemm|cudnn"),
    ("gemm", r"gemm|gemv|splitKreduce"),
    ("attention (ours)", r"flash_(fwd|dq|dkv)_tc"),
    ("layernorm (ours)", r"layernorm_fwd"),
    ("softmax (ours)", r"softmax_(warp|cluster|block)_kernel"),
    ("optimizer foreach", r"multi_tensor_apply"),
    ("softmax", r"softmax"),
    ("pooling", r"pool"),
    ("reduction", r"reduce_kernel"),
    ("embedding / index", r"embedding|index|scatter|gather"),
    ("elementwise", r"elementwise|vectorized"),
)


def _category(name, categories=KERNEL_CATEGORIES):
    for cat, pat in categories:
        if re.search(pat, name, re.I):
            return cat
    return "other"


def _profile(fn, calls, top=6, categories=KERNEL_CATEGORIES, detail=None):
    """Device view of ``calls`` calls of ``fn`` from torch.profiler:
    kernels per call, device-busy µs per call (union of kernel
    intervals), the idle share of the profiled wall time, the kernels
    that took the most device time, device time by category, and every
    kernel of the category ``detail`` by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"wall_us_per_call": wall_us / calls}
    if not kern:
        out["device"] = "not measured: the profiler recorded no kernels"
        return out
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    by_name = {}
    for e in kern:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.end - e.time_range.start
    cats = {}
    for n, (c, t) in by_name.items():
        k = cats.setdefault(_category(n, categories), [0, 0.0])
        k[0] += c
        k[1] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out.update(kernels_per_call=len(kern) / calls,
               by_category={k: {"per_call": c / calls,
                                "us_per_call": t / calls}
                            for k, (c, t) in sorted(
                                cats.items(), key=lambda kv: -kv[1][1])},
               device_busy_us_per_call=busy / calls,
               idle_share=1.0 - busy / wall_us,
               top=[{"kernel": n[:90], "per_call": c / calls,
                     "us_per_call": t / calls} for n, (c, t) in top])
    if detail:
        out[detail] = [{"kernel": n[:160], "per_call": c / calls,
                        "us_per_call": t / calls}
                       for n, (c, t) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][1])
                       if _category(n, categories) == detail]
    return out


def phase_profile(state):
    """Where the time goes on the path: prefill and decode step at
    batch 1 and 8, under torch.profiler (its own cost inflates the wall
    times here; the slice phase's times are the uninstrumented ones)."""
    eng, prompt = state["engine"], state["prompt"]
    res = {}
    for b in (1, 8):
        res[f"prefill_b{b}"] = _profile(lambda: eng.prefill([prompt] * b),
                                        2)
        ctl = eng.prefill([prompt] * b)
        res[f"decode_step_b{b}"] = _profile(lambda: eng.step(ctl), 5)
    return res


# ------------------------------------------------------------ BERT phases
def _bert_qkv(B, H, L, D, strided, gen):
    """q, k, v (B, H, L, D): views into one (B, L, 3*H*D) projection as
    BERT passes them, or contiguous tensors."""
    import torch
    if strided:
        t = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen)
        return [x.view(B, L, H, D).transpose(1, 2)
                for x in t.split(H * D, dim=-1)]
    return [torch.randn(B, H, L, D, device="cuda", generator=gen)
            for _ in range(3)]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _flash_case(B, H, L, D, strided, gen):
    """The three kernels at one shape against their plain versions, fed
    the same lse and delta, and the backward kernels also on the forward
    kernel's lse; each launched twice on the same inputs (the outputs
    must be bitwise equal); times of each beside both bounds (3xTF32
    kernels: their three TF32 products on the tensor cores, and the fp32
    work on the CUDA cores), its plain version and SDPA (``attention_fwd``:
    the forward; ``attention_dq`` and ``attention_dkv``: SDPA's backward,
    which computes dq, dk and dv together, also over the pair's time as
    ``pair_vs_library``); the backward kernels' plan (blocks, blocks an
    SM, waves)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v = _bert_qkv(B, H, L, D, strided, gen)
    g = torch.randn(B, H, L, D, device="cuda", generator=gen)
    sc = D ** -0.5
    o, lse = fa.attention_fwd(q, k, v, sc)
    o2, lse2 = fa.attention_fwd(q, k, v, sc)
    ro, rlse = fa.attention_fwd_plain(q, k, v, sc)
    delta = (g * ro).sum(dim=-1).contiguous()
    dq = fa.attention_dq(q, k, v, g, rlse, delta, sc)
    dq2 = fa.attention_dq(q, k, v, g, rlse, delta, sc)
    rdq = fa.attention_dq_plain(q, k, v, g, rlse, delta, sc)
    dk, dv = fa.attention_dkv(q, k, v, g, rlse, delta, sc)
    dk2, dv2 = fa.attention_dkv(q, k, v, g, rlse, delta, sc)
    rdk, rdv = fa.attention_dkv_plain(q, k, v, g, rlse, delta, sc)
    kdq = fa.attention_dq(q, k, v, g, lse, delta, sc)
    kdk, kdv = fa.attention_dkv(q, k, v, g, lse, delta, sc)
    torch.cuda.synchronize()

    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=sc)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), g, retain_graph=True))
    bh, el = B * H, 4 * B * H * L * D       # one (B, H, L, D) fp32 in bytes
    shape = [bh, L, D]
    common = {"shape": shape, "strided": strided}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd = dict(
        common, max_abs_err=(o - ro).abs().max().item(),
        lse_max_abs_err=(lse - rlse).abs().max().item(),
        tol=ATTN_TOL, lse_tol=LSE_TOL,
        bitwise_equal_relaunch=bool(torch.equal(o, o2) and
                                    torch.equal(lse, lse2)),
        kernel_ms=cuda_ms(lambda: fa.attention_fwd(q, k, v, sc)),
        kernel_eager_ms=eager_ms(lambda: fa.attention_fwd(q, k, v, sc)),
        plain_ms=cuda_ms(lambda: fa.attention_fwd_plain(q, k, v, sc)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=sc)),
        library="F.scaled_dot_product_attention")
    cases = {
        "attention_fwd": _tc_bounds(fwd, 4 * el + 4 * bh * L,
                                    4 * bh * L * L * D),
        "attention_dq": dict(
            common, max_abs_err=(dq - rdq).abs().max().item(),
            rel_err=_rel(dq, rdq), rel_err_kernel_lse=_rel(kdq, rdq),
            tol=ATTN_TOL, bitwise_equal_relaunch=bool(torch.equal(dq, dq2)),
            plan=fa.bwd_plan("dq", B, H, L, L, D, sms)._asdict(),
            kernel_ms=cuda_ms(lambda: fa.attention_dq(
                q, k, v, g, rlse, delta, sc)),
            kernel_eager_ms=eager_ms(lambda: fa.attention_dq(
                q, k, v, g, rlse, delta, sc)),
            plain_ms=cuda_ms(lambda: fa.attention_dq_plain(
                q, k, v, g, rlse, delta, sc)),
            library_ms=lib_bwd_ms, library="SDPA backward (dq, dk, dv)"),
        "attention_dkv": dict(
            common, max_abs_err=max((dk - rdk).abs().max().item(),
                                    (dv - rdv).abs().max().item()),
            rel_err=max(_rel(dk, rdk), _rel(dv, rdv)),
            rel_err_kernel_lse=max(_rel(kdk, rdk), _rel(kdv, rdv)),
            tol=ATTN_TOL,
            bitwise_equal_relaunch=bool(torch.equal(dk, dk2) and
                                        torch.equal(dv, dv2)),
            plan=fa.bwd_plan("dkv", B, H, L, L, D, sms)._asdict(),
            kernel_ms=cuda_ms(lambda: fa.attention_dkv(
                q, k, v, g, rlse, delta, sc)),
            kernel_eager_ms=eager_ms(lambda: fa.attention_dkv(
                q, k, v, g, rlse, delta, sc)),
            plain_ms=cuda_ms(lambda: fa.attention_dkv_plain(
                q, k, v, g, rlse, delta, sc)),
            library_ms=lib_bwd_ms, library="SDPA backward (dq, dk, dv)"),
    }
    _tc_bounds(cases["attention_dq"], 5 * el + 8 * bh * L,
               6 * bh * L * L * D)
    _tc_bounds(cases["attention_dkv"], 6 * el + 8 * bh * L,
               8 * bh * L * L * D)
    pair = (cases["attention_dq"]["kernel_ms"] +
            cases["attention_dkv"]["kernel_ms"]) / lib_bwd_ms
    cases["attention_dq"]["pair_vs_library"] = pair
    cases["attention_dkv"]["pair_vs_library"] = pair
    return cases


def _flash_ok(name, c):
    if name == "attention_fwd":
        return c["max_abs_err"] <= c["tol"] and \
            c["lse_max_abs_err"] <= c["lse_tol"] and \
            c["bitwise_equal_relaunch"]
    return c["rel_err"] <= c["tol"] and \
        c["rel_err_kernel_lse"] <= c["tol"] and c["bitwise_equal_relaunch"]


def phase_bert_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # BERT-base's path shape first (B=16, 12 heads of 64, T=128, views
    # into the qkv projection), then long, ragged, and ragged strided
    shapes = [(16, 12, 128, 64, True), (8, 12, 512, 64, False),
              (1, 6, 200, 128, False), (2, 4, 200, 128, True)]
    per = [_flash_case(*sh, gen) for sh in shapes]
    bad = []
    for name in ("attention_fwd", "attention_dq", "attention_dkv"):
        state["cases"][name] = [c[name] for c in per]
        bad += [(name, c) for c in state["cases"][name]
                if not _flash_ok(name, c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, [c for n in ("attention_fwd",
                                                  "attention_dq",
                                                  "attention_dkv")
                                      for c in state["cases"][n]])
    return {"cases": {n: state["cases"][n] for n in
                      ("attention_fwd", "attention_dq", "attention_dkv")},
            "mma_tf32_ceiling": ceiling}


def phase_bert_train(state):
    """BERT-base pretraining through the example's entry point, on the
    card, with the launch counters read around it."""
    import math
    import torch
    from mxnet_tpu_torch.examples import bert_pretrain
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused
    torch.cuda.reset_peak_memory_stats()
    counted = (layernorm_fused, fa.attention_fwd, fa.attention_dq,
               fa.attention_dkv)
    for fn in counted:
        fn.launches = 0
    argv = ["--steps", str(BERT_STEPS), "--seed", str(SEED)]
    out = bert_pretrain.main(argv)
    launches = {fn.__name__: fn.launches for fn in counted}
    state["bert_launches"] = launches
    losses = out["losses"]
    want = {"layernorm_fused": 25 * BERT_STEPS,
            "attention_fwd": 12 * BERT_STEPS,
            "attention_dq": 12 * BERT_STEPS,
            "attention_dkv": 12 * BERT_STEPS}
    steady = sorted(out["step_s"][1:])
    res = {"args": vars(bert_pretrain.parse_args(argv)),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "losses": losses,
           "step_ms_median_1_5": steady[len(steady) // 2] * 1e3,
           "step_ms": [t * 1e3 for t in out["step_s"]],
           "tokens_s": out["tokens_s"], "launches": launches,
           "launches_expected": want,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    state["bert_step_ms"] = res["step_ms_median_1_5"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {res}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall from step 0: {res}")
    if launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    return res


def phase_bert_reference(state):
    """One step from the same seeded weights and batch, on the card and
    through the port on the CPU."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import bert_pretrain
    torch.set_num_threads(os.cpu_count() or 1)
    args = bert_pretrain.parse_args(["--batch-size", "2"])
    cfg = bert_pretrain.config(args)
    tokens, labels = bert_pretrain.synthetic_batch(
        np.random.RandomState(SEED + 2), 2, args.seq_len, args.vocab)
    sides = {}
    for dev in ("cuda", "cpu"):
        tr = bert_pretrain.Trainer(cfg, SEED, args.lr, dev)
        loss, gs = tr.grads(torch.as_tensor(tokens, device=tr.device),
                            torch.as_tensor(labels, device=tr.device))
        tr.update(gs)
        sides[dev] = (float(loss), [x.cpu() for x in gs],
                      [w.detach().cpu() for w in tr.flat])
        del tr, gs
    (lc, gc, wc), (lp, gp, wp) = sides["cuda"], sides["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    grad_rel = max(_rel(a, b) for a, b in zip(gc, gp))
    w_err = max((a - b).abs().max().item() for a, b in zip(wc, wp))
    res = {"batch": [2, args.seq_len], "loss_card": lc, "loss_cpu": lp,
           "loss_rel": loss_rel, "loss_tol": BERT_LOSS_RTOL,
           "grad_rel_to_max": grad_rel, "grad_tol": REF_TOL,
           "params_after_step_max_abs_diff": w_err,
           "params_tol": 2 * args.lr, "leaves": len(gc)}
    if not (loss_rel <= BERT_LOSS_RTOL and grad_rel <= REF_TOL and
            w_err <= 2 * args.lr):
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


def phase_bert_profile(state):
    """Where one BERT-base train step's time goes, under torch.profiler
    (its own cost inflates the wall time; ``bert_train``'s step time is
    the uninstrumented one)."""
    import numpy as np
    from mxnet_tpu_torch.examples import bert_pretrain
    args = bert_pretrain.parse_args([])
    tr = bert_pretrain.Trainer(bert_pretrain.config(args), SEED, args.lr,
                               "cuda")
    tokens, labels = bert_pretrain.synthetic_batch(
        np.random.RandomState(SEED), args.batch_size, args.seq_len,
        args.vocab)
    float(tr.step(tokens, labels))
    res = _profile(lambda: float(tr.step(tokens, labels)), 1, top=12)
    busy = res.get("device_busy_us_per_call")
    if busy is not None:
        res["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (state["bert_step_ms"] * 1e3)
    return res


# ----------------------------------------------------------- image phases
CONV_TOL = 1e-4
IMG_REF_TOL = 1e-4
RESNET50_SEGMENTS = 16          # 3x3/s1 frozen conv+BN segments a forward


def _conv_case(N, H, W, C, Cout, gen, residual=False, relu=True,
               split=False):
    """``conv_affine`` against ``conv_affine_plain`` at one shape, twice
    on the same inputs (the two outputs must be bitwise equal), with its
    plan, timed beside both bounds (fp32 on the CUDA cores; the three TF32
    products of its 3xTF32 scheme on the tensor cores, the line's
    ``bound_ms``), its plain version and ``F.conv2d`` alone (cuDNN,
    channels-last, TF32 off): the nearest single library call, which
    does less work than the kernel (no BN fold, residual or ReLU).
    ``split``: also the device µs of each kernel it launches (the main
    kernel and the cut-tile reduce)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.conv_block import conv_affine, conv_affine_plain
    x = torch.randn(N, H, W, C, device="cuda", generator=gen)
    w = torch.randn(3, 3, C, Cout, device="cuda", generator=gen) * \
        (2.0 / (9 * C)) ** 0.5
    g = 1 + 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    b = 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    mu = 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    var = 0.5 + torch.rand(Cout, device="cuda", generator=gen)
    res = torch.randn(N, H, W, Cout, device="cuda", generator=gen) \
        if residual else None
    args = (x, w, g, b, mu, var, res)
    out = conv_affine(*args, relu=relu)
    again = conv_affine(*args, relu=relu)
    ref = conv_affine_plain(*args, relu=relu)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    xc = x.permute(0, 3, 1, 2)                      # channels-last view
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    npix = N * H * W
    nbytes = 4 * (npix * C + 9 * C * Cout + npix * Cout * (2 if residual
                                                           else 1)
                  + 4 * Cout)
    flops = 2 * npix * 9 * C * Cout
    kms = cuda_ms(lambda: conv_affine(*args, relu=relu))
    case = {"shape": [N, H, W, C, Cout], "residual": residual, "relu": relu,
            "plan": _conv3x3_plan(npix, C, Cout,
                                  "mxt_conv_affine_tc_blocks_per_sm"),
            "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tol": CONV_TOL,
            "bitwise_equal_relaunch": bool(torch.equal(out, again)),
            "kernel_ms": kms,
            "kernel_eager_ms": eager_ms(lambda: conv_affine(*args,
                                                            relu=relu)),
            "plain_ms": cuda_ms(lambda: conv_affine_plain(*args,
                                                          relu=relu)),
            "library_ms": cuda_ms(lambda: F.conv2d(xc, wc, padding=1)),
            "library": "F.conv2d alone (cuDNN, channels-last; no BN fold, "
                       "residual or ReLU)",
            "tflop_s": flops / (kms * 1e-3) / 1e12}
    if split:
        case["kernels_us"] = _kernel_us(lambda: conv_affine(*args,
                                                            relu=relu))
    return _tc_bounds(case, nbytes, flops)


def phase_image_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # ResNet-50's four 3x3 stages at batch 8 (the path shape first), the
    # batch-1 tail, ResNet-18's residual tail, relu off, and a ragged one
    cases = [_conv_case(8, 56, 56, 64, 64, gen, split=True),
             _conv_case(8, 28, 28, 128, 128, gen, split=True),
             _conv_case(8, 14, 14, 256, 256, gen, split=True),
             _conv_case(8, 7, 7, 512, 512, gen, split=True),
             _conv_case(1, 7, 7, 512, 512, gen, split=True),
             _conv_case(8, 56, 56, 64, 64, gen, residual=True),
             _conv_case(8, 28, 28, 128, 128, gen, relu=False),
             _conv_case(2, 13, 17, 24, 40, gen, residual=True)]
    state["cases"]["conv_affine"] = cases
    bad = [c for c in cases if not (c["rel_err"] <= c["tol"] and
                                    c["bitwise_equal_relaunch"])]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, cases)
    return {"cases": cases, "mma_tf32_ceiling": ceiling}


def _seeded_net(arch, item, device="cpu"):
    """``arch`` (1000 classes; LeNet 10) with the port's seeded
    initializer, its deferred shapes taken from one forward of ``item``,
    and plausible frozen BatchNorm statistics (γ near 1, β and μ small,
    σ² uniform in [0.5, 1.5]), in inference mode on ``device``."""
    import torch
    from mxnet_tpu_torch.models import get_model
    net = get_model(arch, classes=10 if arch == "lenet" else 1000)
    net.initialize(seed=SEED, ctx="cpu")
    with torch.no_grad():
        net(torch.zeros((1,) + item))   # deferred shapes take their values
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, t in net.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))
            elif leaf in ("beta", "running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    net.eval()
    return net.to(device)


def _resnet50_params(path):
    """ResNet-50 v1 (1000 classes) from :func:`_seeded_net`, saved to
    ``path`` as a ``.params``."""
    _seeded_net("resnet50_v1", (32, 32, 3)).save_parameters(path)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def phase_image_serve(state):
    """ResNet-50 v1 at 224x224x3 through ``ModelRegistry.load`` (the
    default ladder 1, 2, 4, 8) and its ``Batcher``: a closed loop of one
    client, then 8 client threads.  The launch counter is set to 0
    before the load and read after the traffic: 16 per forward run."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.serve import ModelRegistry

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "resnet50_v1.params")
    t0 = time.perf_counter()
    _resnet50_params(path)
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    images = rs.rand(64, 224, 224, 3).astype(np.float32)
    state.update(image_params=path, images=images)

    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()      # earlier phases' state
    conv_affine.launches = 0
    telemetry.reset()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.load("resnet50", path, arch="resnet50_v1",
                     item_shape=(224, 224, 3))
    load_s = time.perf_counter() - t0
    state.update(image_registry=reg, image_engine=entry.engine)

    lat, outs = [], []
    for i in range(32):
        t1 = time.perf_counter()
        outs.append(reg.predict("resnet50", images[i])[0])
        lat.append((time.perf_counter() - t1) * 1e3)

    got, errs = {}, []

    def client(c):
        try:
            for j in range(8):
                k = 8 * c + j
                got[k] = reg.predict("resnet50", images[k], timeout=300)[0]
        except Exception as e:
            errs.append(repr(e))

    h0 = telemetry.raw_snapshot()["histograms"].get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    launches = conv_affine.launches
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    forwards = entry.engine.forwards     # warmups, the batcher's, traffic
    state["image_launches"] = {"conv_affine": launches}
    state["image_batched"] = got
    if errs or len(got) != 64:
        raise AssertionError(f"concurrent requests failed: {errs}")
    bad = [o for o in outs + list(got.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if launches != RESNET50_SEGMENTS * forwards:
        raise AssertionError(f"conv_affine launched {launches} times in "
                             f"{forwards} forwards")

    eng = entry.engine
    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(images[:b], device="cuda")
        per_bucket[b] = {
            # two forwards per CUDA-event window: the host queues both
            # inside the device-side sleep, so the window is device time
            "device_ms": cuda_ms(lambda: eng.run(x), iters=2, repeats=5),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=10)}
    hist = snap["histograms"]
    return {"model": "resnet50_v1", "classes": 1000,
            "item_shape": [224, 224, 3], "buckets": list(eng.buckets),
            "init_s": init_s, "load_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "images_s": 64 / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0))},
            "queue_wait_us_mean": _mean_us({}, hist, "serve.queue_wait_us"),
            "device_us_mean": _mean_us({}, hist, "serve.device_us"),
            "per_bucket": per_bucket,
            "launches": {"conv_affine": launches, "forwards": forwards,
                         "per_forward": launches / forwards},
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "param_bytes_per_device")},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "mem_before_bytes": mem_before}


def phase_image_reference(state):
    """The card's engine against the port on the CPU from the same
    ``.params`` at batch 2, and each batched response against the
    unbatched forward of its image (a tolerance, not bitwise: the
    reference's bitwise batching tests are red on the CPU)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, images = state["image_engine"], state["images"]
    x2 = images[:2]
    card = eng.run(x2)[0].cpu().numpy()
    net = get_model("resnet50_v1", classes=1000)
    net.load_parameters(state["image_params"])
    cpu = InferenceEngine(net, (224, 224, 3), buckets=(2,),
                          device="cpu").run(x2)[0].numpy()
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())

    bat_err, bat_scale, bitwise = 0.0, 0.0, 0
    for k, out in state["image_batched"].items():
        one = eng.run(images[k:k + 1])[0].cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_scale = max(bat_scale, float(np.abs(one).max()))
        bitwise += int(np.array_equal(out, one))
    state["image_registry"].close()
    res = {"batch": 2, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": IMG_REF_TOL,
           "top1_equal": top1,
           "batched_vs_unbatched_max_abs_diff": bat_err,
           "batched_max_abs": bat_scale,
           "batched_bitwise_equal": bitwise,
           "batched_responses": len(state["image_batched"])}
    if not (ref_err <= IMG_REF_TOL * ref_scale and top1 and
            bat_err <= IMG_REF_TOL * bat_scale):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_image_profile(state):
    """Where a ResNet-50 forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler."""
    import torch
    eng, images = state["image_engine"], state["images"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(images[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8)
    return res


# -------------------------------------------------------- training phases
TRAIN_TOL = 1e-4            # z, dx, dW: of the tensor's largest magnitude
STATS_RTOL = 1e-5           # sum(z), sum(z^2)
AFFINE_TOL = 1e-6           # bn_affine: of the output's largest magnitude
TRAIN_ITERS = 8
TRAIN_LOSS_RTOL = 1e-4
TRAIN_REF_TOL = 1e-2        # gradients, updates: of the net's largest
TRAIN_STATS_TOL = 1e-5


def _timed(case, fn, plain, library, nbytes, flops, iters=10):
    """Times of ``fn`` (device and eager), its plain version and the
    library call, beside the bound, into ``case``."""
    bms, by = bound(nbytes, flops)
    kms = cuda_ms(fn, iters=iters)
    case.update(kernel_ms=kms, kernel_eager_ms=eager_ms(fn, iters=iters),
                plain_ms=cuda_ms(plain, iters=iters),
                library_ms=cuda_ms(library, iters=iters), bytes=nbytes,
                flop=flops, bound_ms=bms, bound_by=by,
                tflop_s=flops / (kms * 1e-3) / 1e12)
    return case


def _kernel_us(fn, calls=5):
    """Device µs per call of each kernel ``fn`` launches, by name (its
    namespace and template arguments dropped), from torch.profiler."""
    out = {}
    for t in _profile(fn, calls, top=8).get("top", []):
        name = t["kernel"].replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("<")[0].split("(")[0]
        out[name] = out.get(name, 0.0) + t["us_per_call"]
    return out


def _rel_err(out, ref):
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def _train_conv_cases(N, H, W, C, Cout, gen, dgrad_only=False):
    """conv3x3, its dgrad use, conv_stats and conv_wgrad at one shape,
    against their plain versions.  The library yardsticks (cuDNN,
    channels-last, TF32 off) are F.conv2d for the forward and
    torch.nn.grad.conv2d_input / conv2d_weight for dgrad / wgrad; each
    does no more than the kernel (conv_stats' also leaves out the
    sums)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    x = torch.randn(N, H, W, C, device="cuda", generator=gen)
    w = torch.randn(3, 3, C, Cout, device="cuda", generator=gen) * \
        (2.0 / (9 * C)) ** 0.5
    dy = torch.randn(N, H, W, Cout, device="cuda", generator=gen)
    npix = N * H * W
    flops = 2 * npix * 9 * C * Cout
    conv_bytes = 4 * (npix * (C + Cout) + 9 * C * Cout)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dyc = dy.permute(0, 3, 1, 2)
    shape = [N, H, W, C, Cout]
    out = {}

    wr = cb.rotate(w)
    dx = cb.conv3x3_dgrad(w, dy)
    again = cb.conv3x3(dy, wr)
    rdx = cb.conv3x3_plain(dy, wr)
    err, rel = _rel_err(dx, rdx)
    out["conv3x3_dgrad"] = _tc_bounds(_timed(
        {"shape": shape, "use": "dgrad: conv3x3(dy, rotate(w))",
         "plan": _conv3x3_plan(N * H * W, Cout, C),
         "max_abs_err": err, "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(dx, again)),
         "library": "torch.nn.grad.conv2d_input (cuDNN)"},
        lambda: cb.conv3x3(dy, wr), lambda: cb.conv3x3_plain(dy, wr),
        lambda: torch.nn.grad.conv2d_input(xc.shape, wc, dyc, padding=1),
        conv_bytes, flops), conv_bytes, flops)

    out["conv_wgrad"] = _wgrad_case(x, dy, xc, wc, dyc, shape, conv_bytes,
                                    flops)
    if dgrad_only:
        return out

    out["conv3x3"] = _conv3x3_fwd_case(x, w, xc, wc)
    z = cb.conv3x3(x, w)
    out["conv3x3"]["kernels_us"] = _kernel_us(lambda: cb.conv3x3(x, w))

    zs, s1, s2 = cb.conv_stats(x, w)
    again = cb.conv_stats(x, w)
    rz, r1, r2 = cb.conv_stats_plain(x, w)
    err, rel = _rel_err(zs, rz)
    mag = rz.abs().sum(dim=(0, 1, 2))
    s1_rel = ((s1 - r1).abs() / mag).max().item()
    s2_rel = ((s2 - r2).abs() / r2.abs()).max().item()
    plan = _conv3x3_plan(N * H * W, C, Cout,
                         "mxt_conv_stats_tc_blocks_per_sm")
    conv_plan = _conv3x3_plan(N * H * W, C, Cout)
    stats_bytes = conv_bytes + 8 * Cout
    out["conv_stats"] = _tc_bounds(_timed(
        {"shape": shape, "plan": plan, "conv3x3_plan": conv_plan,
         "max_abs_err": err, "rel_err": rel,
         "tol": TRAIN_TOL, "sum_rel_err": s1_rel, "sumsq_rel_err": s2_rel,
         "stats_rtol": STATS_RTOL,
         "bitwise_equal_relaunch": all(
             bool(torch.equal(a, b)) for a, b in zip((zs, s1, s2), again)),
         # None where the plans differ: the ranges cut the sums elsewhere
         "z_equals_conv3x3": bool(torch.equal(zs, z))
         if plan == conv_plan else None,
         "library": "F.conv2d alone (cuDNN; no sums)"},
        lambda: cb.conv_stats(x, w), lambda: cb.conv_stats_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), stats_bytes, flops),
        stats_bytes, flops)
    out["conv_stats"]["kernels_us"] = _kernel_us(lambda: cb.conv_stats(x, w))
    return out


def _conv3x3_fwd_case(x, w, xc, wc):
    """The forward ``conv3x3`` of NHWC ``x`` with HWIO ``w`` against its
    plain version, twice on the same inputs (bitwise equal, a gate),
    timed beside both bounds, the plain version and ``F.conv2d`` on the
    channels-last views ``xc``, ``wc``; with its plan."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    N, H, W, C = x.shape
    Cout = w.shape[-1]
    npix = N * H * W
    flops = 2 * npix * 9 * C * Cout
    conv_bytes = 4 * (npix * (C + Cout) + 9 * C * Cout)
    z = cb.conv3x3(x, w)
    again = cb.conv3x3(x, w)
    rz = cb.conv3x3_plain(x, w)
    err, rel = _rel_err(z, rz)
    return _tc_bounds(_timed(
        {"shape": [N, H, W, C, Cout], "use": "forward",
         "plan": _conv3x3_plan(npix, C, Cout), "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(z, again)),
         "library": "F.conv2d (cuDNN, channels-last)"},
        lambda: cb.conv3x3(x, w), lambda: cb.conv3x3_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), conv_bytes, flops),
        conv_bytes, flops)


def _wgrad_case(x, dy, xc, wc, dyc, shape, nbytes, flops):
    """``conv_wgrad`` against its plain version, twice on the same inputs
    (the two dW must be bitwise equal), timed beside both bounds: fp32
    on the CUDA cores and the three TF32 products of its 3xTF32 scheme on
    the tensor cores (the line's ``bound_ms``)."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    dw = cb.conv_wgrad(x, dy)
    again = cb.conv_wgrad(x, dy)
    rdw = cb.conv_wgrad_plain(x, dy)
    err, rel = _rel_err(dw, rdw)
    N, H, W, C, Cout = shape
    vec = int(C % 4 == 0 and Cout % 4 == 0)
    plan = cb.wgrad_splits(N * H * W, 9 * C, Cout, cb._sm_count(0),
                           cb._per_sm("mxt_conv_wgrad_blocks_per_sm", 0,
                                      cb.wgrad_tile_cols(Cout), vec))
    return _tc_bounds(_timed(
        {"shape": shape, "plan": plan._asdict(), "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(dw, again)),
         "library": "torch.nn.grad.conv2d_weight (cuDNN)"},
        lambda: cb.conv_wgrad(x, dy), lambda: cb.conv_wgrad_plain(x, dy),
        lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dyc, padding=1),
        nbytes, flops), nbytes, flops)


def _conv3x3_plan(M, C, Cout, entry="mxt_conv3x3_tc_blocks_per_sm",
                  wide=4):
    """The plan ``conv3x3`` (or, by its occupancy ``entry``,
    ``conv_stats`` or ``conv_affine``, fp32 or bf16: ``wide`` channels a
    16-byte copy) runs at this shape on card 0."""
    from mxnet_tpu_torch.ops import conv_block as cb
    vec = int(C % wide == 0 and Cout % wide == 0)
    return _plan_dict(cb.conv3x3_splits(
        M, 9 * C, Cout, cb._sm_count(0),
        cb._per_sm(entry, 0, cb.wgrad_tile_cols(Cout), vec)))


def _plan_dict(plan):
    """A stream-K plan's fields and the number of tiles it cuts (finished
    by the cut-tile kernel, not the main one)."""
    from mxnet_tpu_torch.ops import conv_block as cb
    return {**plan._asdict(), "cut_tiles": sum(
        1 for _, k, _ in cb.tile_writers(plan) if k == "cut")}


MMA_TF32_PEAK_SRC = r"""
extern "C" __global__ void mma_tf32_peak(float* out, int iters) {
  const unsigned v = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const unsigned a0 = v, a1 = v ^ 0x2000u, a2 = v, a3 = v ^ 0x4000u;
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a1), "r"(a3));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def _mma_tf32_ceiling():
    """What ``mma.sync.m16n8k8`` TF32 sustains on this card: every warp
    issues independent products on registers (8 accumulators, no memory
    in the loop), 8 warps a block, 2 blocks an SM; compiled by NVRTC
    through ``rtc.CudaModule``.  The ceiling of any ``mma.sync`` TF32
    kernel, beside the 495 TFLOP/s dense peak that ``wgmma`` can reach."""
    import torch
    from mxnet_tpu_torch import rtc
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    kern = rtc.CudaModule(MMA_TF32_PEAK_SRC).get_kernel("mma_tf32_peak")
    run = lambda: kern.launch([iters], grid=(blocks,), block=(256,),  # noqa
                              out_shape=(blocks * 256,))
    ms = cuda_ms(run, iters=3)
    flop = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    return {"blocks": blocks, "ms": ms, "flop": flop,
            "tflop_s": flop / (ms * 1e-3) / 1e12,
            "share_of_dense_peak": flop / (ms * 1e-3) / PEAK_TF32_FLOP_S}


def _affine_case(N, H, W, C, gen, residual=False, relu=True):
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    z = torch.randn(N, H, W, C, device="cuda", generator=gen)
    scale = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    shift = 0.1 * torch.randn(C, device="cuda", generator=gen)
    res = torch.randn(N, H, W, C, device="cuda", generator=gen) \
        if residual else None
    out = cb.bn_affine(z, scale, shift, res, relu)
    ref = cb.bn_affine_plain(z, scale, shift, res, relu)
    err, rel = _rel_err(out, ref)
    n = N * H * W * C
    return _timed(
        {"shape": [N, H, W, C], "residual": residual, "relu": relu,
         "max_abs_err": err, "rel_err": rel, "tol": AFFINE_TOL,
         "library": "torch.addcmul(shift, z, scale) (no residual, ReLU)"},
        lambda: cb.bn_affine(z, scale, shift, res, relu),
        lambda: cb.bn_affine_plain(z, scale, shift, res, relu),
        lambda: torch.addcmul(shift, z, scale),
        4 * (n * (3 if residual else 2) + 2 * C),
        n * (2 + int(residual) + int(relu)))


def _train_ok(name, c):
    if not c["rel_err"] <= c["tol"]:
        return False
    if name in ("conv3x3", "conv_wgrad"):
        return c["bitwise_equal_relaunch"]
    if name == "conv_stats":
        return c["sum_rel_err"] <= c["stats_rtol"] and \
            c["sumsq_rel_err"] <= c["stats_rtol"] and \
            c["bitwise_equal_relaunch"] and \
            c["z_equals_conv3x3"] is not False
    return True


def phase_train_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    # ResNet-50's four 3x3 stages at batch 64 (the path's first), then a
    # C != Cout backward, and a ragged shape
    per = [_train_conv_cases(64, 56, 56, 64, 64, gen),
           _train_conv_cases(64, 28, 28, 128, 128, gen),
           _train_conv_cases(64, 14, 14, 256, 256, gen),
           _train_conv_cases(64, 7, 7, 512, 512, gen),
           _train_conv_cases(8, 28, 28, 64, 128, gen, dgrad_only=True),
           _train_conv_cases(2, 13, 17, 24, 40, gen)]
    cases = {"conv3x3": [c[k] for c in per for k in ("conv3x3_dgrad",
                                                    "conv3x3") if k in c],
             "conv_stats": [c["conv_stats"] for c in per
                            if "conv_stats" in c],
             "conv_wgrad": [c["conv_wgrad"] for c in per],
             "bn_affine": [_affine_case(64, 56, 56, 64, gen),
                           _affine_case(64, 28, 28, 128, gen),
                           _affine_case(64, 14, 14, 256, gen),
                           _affine_case(64, 7, 7, 512, gen),
                           _affine_case(64, 56, 56, 64, gen, residual=True),
                           _affine_case(64, 28, 28, 128, gen, relu=False),
                           _affine_case(2, 13, 17, 40, gen, residual=True,
                                        relu=False)]}
    state["cases"].update(cases)
    bad = [(n, c) for n, cs in cases.items() for c in cs
           if not _train_ok(n, c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, cases["conv3x3"] + cases["conv_stats"] +
                              cases["conv_wgrad"])
    return {"cases": cases, "mma_tf32_ceiling": ceiling}


TRAIN_KERNELS = ("conv3x3", "conv_stats", "bn_affine", "conv_wgrad")


def _train_counters():
    from mxnet_tpu_torch.ops import conv_block as cb
    return [getattr(cb, n) for n in TRAIN_KERNELS + ("conv_affine",)]


def phase_image_train(state):
    """ResNet-50 v1 training through the example's entry point at its
    defaults, with the launch counters read around it."""
    import math
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    torch.cuda.reset_peak_memory_stats()
    from mxnet_tpu_torch.ops import conv_block as cb
    counted = _train_counters()
    for fn in counted:
        fn.launches = 0
    cb._FusedBlock.dout_copies = 0
    argv = ["--iters", str(TRAIN_ITERS), "--seed", str(SEED)]
    out = ic.main(argv)
    launches = {fn.__name__: fn.launches for fn in counted}
    copies = cb._FusedBlock.dout_copies
    state["train_launches"] = launches
    steps = out["steps"]
    want = dict({n: RESNET50_SEGMENTS * steps for n in TRAIN_KERNELS},
                conv_affine=0)
    timed = sorted(out["step_ms"][ic.WARMUP:])
    med = timed[len(timed) // 2]
    args = ic.parse_args(argv)
    res = {"args": vars(args), "losses": out["losses"],
           "step_ms": out["step_ms"], "step_ms_median": med,
           "images_s": out["img_s"],
           "images_s_from_median_step": args.batch_size / med * 1e3,
           "launches": launches, "launches_expected": want,
           "dout_copies_per_step": copies / steps,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    state["train_step_ms"] = med
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss: {res}")
    if launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    return res


def _train_side(args, dev, x, y, dtype="float32", damp=0.1):
    """One step on ``dev`` from the example's seeded weights, with each
    bottleneck's last BatchNorm γ scaled by ``damp`` (0.1: the
    damped-residual init; see ``phase_image_train_reference``): (loss,
    {name: gradient},
    {name: value after the step}, {name: value before}) on the CPU in
    float64.  The weights take their shapes in an inference forward
    first, which leaves the running statistics as they are."""
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    device = torch.device(dev)
    net, trainer, loss_fn = ic.build(args, device)
    net.eval()
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3, device=device))
        for k, t in net.collect_params().items():
            if k.endswith(".body.7.gamma"):
                t.mul_(damp)
    net.to(getattr(torch, dtype)).train()
    before = {k: t.detach().double().cpu().clone()
              for k, t in net.collect_params().items()}
    xt = torch.as_tensor(x, device=device).to(getattr(torch, dtype))
    loss = ic.forward_backward(net, loss_fn, xt,
                               torch.as_tensor(y, device=device))
    params = net.collect_params()
    grads = {k: t.grad.detach().double().cpu() for k, t in params.items()
             if isinstance(t, torch.nn.Parameter) and t.grad is not None}
    trainer.step(args.batch_size)
    after = {k: t.detach().double().cpu() for k, t in params.items()}
    return loss.double().cpu(), grads, after, before


def _step_diff(a, b):
    """How far apart two sides' steps are: the loss (relative), the
    gradients (of the largest gradient in the net), the parameters after
    the step (of the largest update in the net) and the running
    statistics (each of its largest magnitude)."""
    (la, ga, aa, _), (lb, gb, ab, b0) = a, b
    gmax = max(g.abs().max().item() for g in gb.values())
    params = [k for k in ab if "running_" not in k]
    umax = max((ab[k] - b0[k]).abs().max().item() for k in params)
    grad = {k: (ga[k] - gb[k]).abs().max().item() / gmax for k in gb}
    upd = {k: (aa[k] - ab[k]).abs().max().item() / umax for k in params}
    stats = {k: _rel(aa[k], ab[k]) for k in ab if "running_" in k}
    return {"loss_rel": ((la - lb).abs().max() / lb.abs().max()).item(),
            "grad_rel_to_net_max": max(grad.values()),
            "grad_worst": max(grad, key=grad.get),
            "params_after_step_rel_to_max_update": max(upd.values()),
            "params_worst": max(upd, key=upd.get),
            "running_stats_rel_to_max": max(stats.values()),
            "largest_gradient": gmax, "largest_update": umax,
            "gradients": len(gb), "same_gradients": sorted(ga) == sorted(gb)}


def phase_image_train_reference(state):
    """One ResNet-50 training step at batch 2 on the card and through the
    port on the CPU, from the same seeded weights and batch; the CPU
    step in float64 too, as the floor any fp32 run sits on.

    The weights are the example's, with each bottleneck's last BN γ
    scaled by 0.1 (the damped-residual init of large-batch ResNet
    training).  With γ = 1 at batch 2 the step is badly conditioned: the
    port's own fp32 and fp64 CPU steps differ by a few percent of the
    largest gradient (``cpu_fp32_vs_fp64_gamma1``, printed, not gated),
    so no fp32 pair could be held tighter.  The
    gradients and the updates are read against the net's largest
    gradient and largest update, since a gradient that is small by the
    BatchNorm's cancellation carries rounding of the net's scale."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    torch.set_num_threads(os.cpu_count() or 1)
    args = ic.parse_args(["--batch-size", "2", "--seed", str(SEED)])
    x, y = ic.synthetic_batch(np.random.RandomState(SEED + 4), 2,
                              args.image_size, args.classes)
    card = _train_side(args, "cuda", x, y)
    cpu = _train_side(args, "cpu", x, y)
    cpu64 = _train_side(args, "cpu", x, y, "float64")
    diff = _step_diff(card, cpu)
    # the same floor from the example's own weights (γ = 1), not gated
    floor_gamma1 = _step_diff(_train_side(args, "cpu", x, y, damp=1.0),
                              _train_side(args, "cpu", x, y, "float64",
                                          damp=1.0))
    res = {"batch": [2, args.image_size, args.image_size, 3],
           "loss_card": card[0].tolist(), "loss_cpu": cpu[0].tolist(),
           "card_vs_cpu": diff,
           "cpu_fp32_vs_fp64": _step_diff(cpu, cpu64),
           "cpu_fp32_vs_fp64_gamma1": floor_gamma1,
           "tol": {"loss_rel": TRAIN_LOSS_RTOL,
                   "grad_rel_to_net_max": TRAIN_REF_TOL,
                   "params_after_step_rel_to_max_update": TRAIN_REF_TOL,
                   "running_stats_rel_to_max": TRAIN_STATS_TOL}}
    if not (diff["same_gradients"] and all(
            diff[k] <= t for k, t in res["tol"].items())):
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


def phase_image_train_profile(state):
    """Where one ResNet-50 training step's time goes, under torch.profiler
    (its own cost inflates the wall time; ``image_train``'s step time is
    the uninstrumented one)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(["--seed", str(SEED)])
    device = torch.device("cuda")
    net, trainer, loss_fn = ic.build(args, device)
    x, y = ic.synthetic_batch(np.random.RandomState(SEED), args.batch_size,
                              args.image_size, args.classes)
    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y,
                                                             device=device)

    def step():
        ic.forward_backward(net, loss_fn, x, y)
        trainer.step(args.batch_size)

    from mxnet_tpu_torch.gluon import nn as gnn
    shapes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(i[0].shape)))
        for m in net.modules() if isinstance(m, gnn.BatchNorm)]
    step()
    for h in hooks:
        h.remove()
    res = _profile(step, 1, top=12)
    busy = res.get("device_busy_us_per_call")
    if busy is not None:
        res["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (state["train_step_ms"] * 1e3)
    res["unfused_batch_norm"] = _bn_cost(shapes)
    return res


def _bn_cost(shapes):
    """The step's unfused BatchNorms (the layers the fused segments leave
    to ``ops.nn.batch_norm``), forward and backward in training mode on
    inputs of the shapes the step gave them: their device ms a step and
    kernels a step, so the profile's elementwise and reduction time can
    be split between them and the rest."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    args = []
    for sh in shapes:
        x = torch.randn(sh, device="cuda", generator=gen).requires_grad_()
        c = sh[-1]
        g, b = (torch.ones(c, device="cuda").requires_grad_(),
                torch.zeros(c, device="cuda").requires_grad_())
        args.append((x, g, b, torch.zeros(c, device="cuda"),
                     torch.ones(c, device="cuda"),
                     torch.randn(sh, device="cuda", generator=gen)))

    def run():
        for x, g, b, rm, rv, gy in args:
            out, _, _ = tnn.batch_norm(x, g, b, rm, rv, training=True)
            torch.autograd.grad(out, (x, g, b), gy)

    prof = _profile(run, 1)
    return {"layers": len(shapes),
            "device_ms_per_step": cuda_ms(run, iters=2, repeats=3),
            "kernels_per_step": prof.get("kernels_per_call"),
            "by_category": prof.get("by_category")}


# ------------------------------------------------------------ text phases
SOFTMAX_TOL = 1e-6          # absolute: every softmax value lies in [0, 1]
SOFTMAX_SUM_TOL = 1e-5      # a row's sum from 1
TEXT_REF_TOL = 1e-4         # logits: of the largest logit
TEXT_ARGMAX_AGREE = 0.999   # share of positions whose argmax agrees
TEXT_T = 512                # tokens an item
BERT_SOFTMAXES = 12         # attention softmaxes a BERT-base forward
BERT_LAYERNORMS = 25        # LayerNorms a BERT-base forward


def _softmax_plan(cols, wide=4):
    """The card's plan for contiguous rows of ``cols`` (``csrc/softmax.cu``
    ``plan_for``): the values a load moves (``wide``: 4 floats, 8
    halves), the kernel, the CTAs of its cluster and the columns a CTA
    holds."""
    import ctypes
    from mxnet_tpu_torch import _build
    vec = wide if cols % wide == 0 else 1
    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().mxt_softmax_plan(cols, vec, out),
                 "mxt_softmax_plan")
    return {"vec": vec, "kernel": ("warp", "cluster", "block")[out[0]],
            "cluster": out[1], "cols_a_cta": out[2]}


def _softmax_case(rows, cols, gen, masked=False, strided=False, div=None,
                  keep_rows=None):
    """``softmax_fused`` against its plain version at one shape, launched
    twice (the two outputs must be bitwise equal), timed beside its
    bound, its plain version and ``torch.softmax`` (the one PyTorch call
    computing the same function; where the case has a prologue it neither
    divides nor masks, ‡, and is given the prologue's result, made before
    its window).  ``masked`` puts the model's finite mask value -1e9 in
    every third column and across the whole first row (which must come
    out 1/cols); ``strided`` passes a non-contiguous view, which the
    wrapper copies first.  ``div`` and ``keep_rows`` give the kernel its
    prologue: the divisor and a random keep mask of ``keep_rows`` rows
    (its first row masked everywhere, so row 0 of the output must come out
    1/cols).  The plain version divides by ``div`` as a device tensor (an
    IEEE division, as the kernel's); a prologue case is also timed as the
    separate passes it replaces (``unfused_ms``: ``x / div``, the
    ``where``, then the kernel), and counts the elements where ATen's
    division by the Python float (a multiply by its reciprocal on the
    card) differs from the CPU's IEEE division."""
    import torch
    from mxnet_tpu_torch.ops.cuda_kernels import (softmax_fused,
                                                  softmax_plain,
                                                  softmax_prologue_plain)
    if strided:
        x = (torch.randn(rows, cols + 64, device="cuda", generator=gen)
             * 4)[:, :cols]
    else:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
    if div is not None:
        x *= div
    if masked:
        x[:, ::3] = -1e9
        x[0] = -1e9
    keep = None
    if keep_rows:
        keep = torch.rand(keep_rows, cols, device="cuda",
                          generator=gen) > 0.25
        keep[0] = False

    def fused():
        return softmax_fused(x, div=div, keep=keep)

    divt = None if div is None else torch.tensor(div, device="cuda")

    def plain():
        return softmax_plain(softmax_prologue_plain(x, divt, keep))

    out, again, ref = fused(), fused(), plain()
    # the library call's input: the prologue's result, made before any
    # window (torch.softmax neither divides nor masks)
    xl = softmax_prologue_plain(x, divt, keep)
    torch.cuda.synchronize()
    case = {"shape": [rows, cols], "masked": masked, "strided": strided,
            "div": div, "keep_rows": keep_rows,
            "plan": _softmax_plan(cols),
            "max_abs_err": (out - ref).abs().max().item(), "tol": SOFTMAX_TOL,
            "finite": bool(torch.isfinite(out).all()),
            "row_sum_err": (out.sum(-1) - 1).abs().max().item(),
            "bitwise_equal_relaunch": torch.equal(out, again)}
    if masked or keep_rows:
        case["masked_row_err"] = (out[0] - 1.0 / cols).abs().max().item()
    nbytes = 2 * rows * cols * 4 + (keep.numel() if keep_rows else 0)
    flops = (5 + (div is not None)) * rows * cols
    _timed(case, fused, plain, lambda: torch.softmax(xl, -1), nbytes, flops)
    case["gb_s"] = case["bytes"] / (case["kernel_ms"] * 1e-3) / 1e9
    case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
    case["vs_library"] = case["kernel_ms"] / case["library_ms"]
    if div is not None or keep_rows:
        case["library_does_less"] = True
        case["unfused_ms"] = cuda_ms(
            lambda: softmax_fused(softmax_prologue_plain(x, div, keep)),
            iters=10)
    if div is not None:
        case["scalar_div_differs_from_cpu"] = int(
            ((x / div).cpu() != x.cpu() / div).sum())
    return case


SOFTMAX_BF16_STEPS = 1  # bf16 steps between card and CPU: sums, quotients


def _bf16_steps(a, b):
    """Distance of two non-negative bf16 tensors in steps of their own
    size: the difference of their bit patterns."""
    import torch
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _softmax_bf16_parts(x, axis):
    """The bf16 closed form of ``ops.nn.softmax`` taken apart, on x's
    device: ``exp(x - max)`` in fp32 rounded to bf16 (the numerator), and
    its fp32 sum rounded to bf16 (the denominator)."""
    import torch
    e = torch.exp((x - x.amax(dim=axis, keepdim=True)).float())
    return e.to(x.dtype), e.sum(dim=axis, keepdim=True).to(x.dtype)


def _softmax_bf16_steps(got, x_cpu, axis, card_sum):
    """Steps of the card's bf16 softmax ``got`` from the CPU's closed form
    on the same values: the CPU's numerator over the CPU's rounded sum,
    or over the card's, whichever is nearer.  The fp32 sums run in
    another order on the two devices, which may move the rounding of a
    sum by one step; a quotient over it then moves by up to two steps of
    its own (1 / s for s just above 1: one step of s is 2^-7 of it, one
    step of a quotient just below 1 is 2^-8), so each value is held to
    one step of the quotient its own device's sum gives."""
    import torch
    num, s = _softmax_bf16_parts(x_cpu, axis)
    return torch.minimum(_bf16_steps(got, num / s),
                         _bf16_steps(got, num / card_sum))


def _softmax_bf16_case(shape, axis, gen):
    """``ops.nn.softmax`` on a bf16 tensor on the card (over the last axis
    the kernel's bf16 instance, one launch; over another axis the
    reference's closed form in plain torch, no launch) against the port
    on the CPU on the same values (see :func:`_softmax_bf16_steps`), with
    the two devices' rounded sums within one step of each other, and the
    closed form taken apart equal to the CPU's ``ops.nn.softmax`` bit for
    bit."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.cuda_kernels import softmax_fused
    x = (torch.randn(*shape, device="cuda", generator=gen) * 4).bfloat16()
    before = softmax_fused.launches_by_dtype[torch.bfloat16]
    out = tnn.softmax(x, axis=axis)
    torch.cuda.synchronize()
    launched = softmax_fused.launches_by_dtype[torch.bfloat16] - before
    xc = x.cpu()
    ref = tnn.softmax(xc, axis=axis)
    got = out.cpu()
    card_sum = _softmax_bf16_parts(x, axis)[1].cpu()
    num, cpu_sum = _softmax_bf16_parts(xc, axis)
    steps = _softmax_bf16_steps(got, xc, axis, card_sum)
    raw = _bf16_steps(got, ref)
    return {"shape": list(shape), "axis": axis, "dtype": str(out.dtype),
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "max_bf16_steps": steps.max().item(),
            "max_bf16_steps_from_cpu": raw.max().item(),
            "sum_bf16_steps": _bf16_steps(card_sum, cpu_sum).max().item(),
            "sums_rounded_apart": int((card_sum != cpu_sum).sum()),
            "closed_form_is_cpu_softmax": torch.equal(num / cpu_sum, ref),
            "tol_bf16_steps": SOFTMAX_BF16_STEPS,
            "all_nonnegative": bool((got >= 0).all() and (ref >= 0).all()),
            "values_differing": int((raw > 0).sum()),
            "values": steps.numel(),
            "finite": bool(torch.isfinite(out).all()),
            "kernel_launches": launched}


def phase_text_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    heads = 12
    rows8 = 8 * heads * TEXT_T
    # the path's call first (bucket 8: the scores' scale by sqrt(64) as
    # the prologue), the same rows without it, the prologue at sqrt(48)
    # (not a power of two) and with a (B, T) key mask; then bucket 1
    # without and with the prologue, ragged widths, the cluster kernel
    # (vocabulary rows over 4 CTAs, one CTA at 4096, scalars at 4099, a
    # prologue), -1e9 rows on the warp, cluster and block kernels (above
    # the cluster's 65536 columns) and a strided view
    cases = [_softmax_case(rows8, TEXT_T, gen, div=8.0),
             _softmax_case(rows8, TEXT_T, gen),
             _softmax_case(rows8, TEXT_T, gen, div=math.sqrt(48)),
             _softmax_case(rows8, TEXT_T, gen, div=8.0, keep_rows=8),
             _softmax_case(rows8, TEXT_T, gen, div=math.sqrt(48),
                           keep_rows=8),
             _softmax_case(heads * TEXT_T, TEXT_T, gen),
             _softmax_case(heads * TEXT_T, TEXT_T, gen, div=8.0),
             _softmax_case(heads * TEXT_T, TEXT_T, gen, div=math.sqrt(48)),
             _softmax_case(4096, 77, gen),
             _softmax_case(4096, 1000, gen),
             _softmax_case(4096, 30522, gen),
             _softmax_case(1024, 4096, gen),
             _softmax_case(1024, 30522, gen, div=math.sqrt(48), keep_rows=4),
             _softmax_case(heads * TEXT_T, TEXT_T, gen, masked=True),
             _softmax_case(1024, 4099, gen, masked=True),
             _softmax_case(256, 131072, gen, masked=True),
             _softmax_case(2048, 512, gen, strided=True)]
    state["cases"]["softmax_fused"] = cases
    bad = [c for c in cases
           if not (c["max_abs_err"] <= c["tol"] and c["finite"] and
                   c["row_sum_err"] <= SOFTMAX_SUM_TOL and
                   c["bitwise_equal_relaunch"] and
                   c.get("masked_row_err", 0.0) <= c["tol"])]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    half = [_softmax_bf16_case(shape, axis, gen)
            for shape in ((4, 768), (2, 3, 512), (8, 30522))
            for axis in (-1, 0)]
    bad = [c for c in half
           if not (c["max_bf16_steps"] <= c["tol_bf16_steps"] and
                   c["sum_bf16_steps"] <= c["tol_bf16_steps"] and
                   c["closed_form_is_cpu_softmax"] and
                   c["all_nonnegative"] and c["finite"] and
                   c["dtype"] == "torch.bfloat16" and
                   c["kernel_launches"] == (1 if c["axis"] == -1 else 0))]
    if bad:
        raise AssertionError(f"bf16 softmax on the card disagrees with the "
                             f"CPU: {bad}")
    return {"cases": cases, "bf16_vs_cpu": half}


def _bert_base_params(path):
    """BERT-base (``bert_12_768_12``) with weights from
    ``numpy.random.RandomState(SEED)``: embeddings N(0, 1), dense weights
    N(0, 1/fan_in) (attention scores of unit scale, so the softmax is far
    from uniform), LayerNorm γ near 1, small β and biases; saved to
    ``path`` as a ``.params``.  Returns the parameter count."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon
    net = bert_gluon.bert_12_768_12()
    net.initialize(seed=SEED, ctx="cpu")
    net(torch.zeros(1, 8, dtype=torch.int32))   # deferred shapes resolve
    rs = np.random.RandomState(SEED)
    with torch.no_grad():
        for name, t in net.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(t.shape)
            if "embed" in name:
                a = rs.randn(*shape)
            elif leaf == "weight":
                a = rs.randn(*shape) / np.sqrt(shape[1])
            elif leaf == "gamma":
                a = 1 + 0.1 * rs.randn(*shape)
            else:                               # beta, bias
                a = 0.1 * rs.randn(*shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    net.save_parameters(path)
    return sum(t.numel() for t in net.collect_params().values())


def _digest(out):
    """What ``text_serve`` keeps of one (1, T, vocab) response: its sum
    (float64; finite iff every logit is) and the argmax at each
    position.  The response itself, 62.5 MB, is dropped."""
    import numpy as np
    return float(out.sum(dtype=np.float64)), out[0].argmax(-1)


def _to_host_ms(out, repeats=5):
    """Host-clock ms of the batcher's copy of one bucket's logits to the
    host (``.cpu().numpy()`` of a finished forward, bf16 widened to fp32
    there), median of ``repeats``."""
    import torch
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        host = out.cpu()        # bf16 widened on the host, as the batcher
        (host.float() if host.dtype == torch.bfloat16 else host).numpy()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[len(runs) // 2]


def phase_text_serve(state):
    """Gluon BERT-base on 512-token int32 items through
    ``ModelRegistry.load(..., net=bert_12_768_12(), dtype="int32")`` (the
    default ladder 1, 2, 4, 8) and its ``Batcher``: a closed loop of one
    client, then 8 client threads.  The launch counters are set to 0
    before the load and read after the traffic: 12 softmax and 25
    LayerNorm launches per forward run."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused, softmax_fused
    from mxnet_tpu_torch.serve import ModelRegistry

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "bert_12_768_12.params")
    t0 = time.perf_counter()
    n_params = _bert_base_params(path)
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    seqs = rs.randint(0, 30522, (96, TEXT_T)).astype(np.int32)
    state.update(text_params=path, text_seqs=seqs)

    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()      # earlier phases' state
    softmax_fused.launches = 0
    layernorm_fused.launches = 0
    telemetry.reset()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.load("bert", path, net=bert_gluon.bert_12_768_12(),
                     item_shape=(TEXT_T,), dtype="int32")
    load_s = time.perf_counter() - t0
    eng = entry.engine
    state.update(text_registry=reg, text_engine=eng)

    def spans(h0, h1):
        """Mean µs per request of the batcher's queue wait and end to end,
        and per batch of its forward + copy to the host, between two
        histogram snapshots."""
        return {n: _mean_us(h0, h1, f"serve.{n}")
                for n in ("queue_wait_us", "device_us", "e2e_us")}

    hc0 = telemetry.raw_snapshot()["histograms"]
    digests, lat = {}, []
    for k in range(32):
        t1 = time.perf_counter()
        out = reg.predict("bert", seqs[k])[0]
        lat.append((time.perf_counter() - t1) * 1e3)
        if out.shape != (1, TEXT_T, 30522):
            raise AssertionError(f"response shape {out.shape}")
        digests[k] = _digest(out)
        del out

    errs = []

    def client(c):
        try:
            for j in range(8):
                k = 32 + 8 * c + j
                out = reg.predict("bert", seqs[k], timeout=300)[0]
                if out.shape != (1, TEXT_T, 30522):
                    raise AssertionError(f"response shape {out.shape}")
                digests[k] = _digest(out)
                del out
        except Exception as e:
            errs.append(repr(e))

    hc1 = telemetry.raw_snapshot()["histograms"]
    h0 = hc1.get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    launches = {"softmax_fused": softmax_fused.launches,
                "layernorm_fused": layernorm_fused.launches}
    forwards = eng.forwards      # warmups, the batcher's, traffic
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    state["text_launches"] = launches
    state["text_digests"] = digests
    if errs or len(digests) != 96:
        raise AssertionError(f"requests failed: {errs}")
    bad = [k for k, (s, _) in digests.items() if not np.isfinite(s)]
    if bad:
        raise AssertionError(f"responses {bad} not finite")
    if (launches["softmax_fused"] != BERT_SOFTMAXES * forwards or
            launches["layernorm_fused"] != BERT_LAYERNORMS * forwards):
        raise AssertionError(f"launches {launches} in {forwards} forwards")

    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(seqs[:b], device="cuda")
        per_bucket[b] = {
            # two forwards per CUDA-event window: the host queues both
            # inside the device-side sleep, so the window is device time
            "device_ms": cuda_ms(lambda: eng.run(x), iters=2, repeats=5),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=5),
            "to_host_ms": _to_host_ms(eng.run(x)[0])}
    return {"model": "bert_12_768_12", "params": n_params,
            "vocab": 30522, "item_shape": [TEXT_T], "dtype": "int32",
            "buckets": list(eng.buckets), "init_s": init_s,
            "load_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat),
                            "sequences_s": 1e3 * len(lat) / sum(lat),
                            "batcher_us": spans(hc0, hc1)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "sequences_s": 64 / conc_s,
                           "tokens_s": 64 * TEXT_T / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0)),
                           "batcher_us": spans(hc1, snap["histograms"])},
            "per_bucket": per_bucket,
            "launches": {**launches, "forwards": forwards,
                         "softmax_per_forward":
                         launches["softmax_fused"] / forwards,
                         "layernorm_per_forward":
                         launches["layernorm_fused"] / forwards},
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "dtype", "param_bytes_per_device")},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "mem_before_bytes": mem_before}


def phase_text_reference(state):
    """Card logits against the port on the CPU from the same ``.params``
    at batch 1 x 512 (within 1e-4 of the largest logit, argmax equal at
    >= 99.9% of positions).  Then batched against unbatched: the 64
    concurrent requests are served again through the ``Batcher`` by 8
    clients, and each response is held, element by element, against the
    forward of its sequence alone on the card (same tolerance); and the
    digest ``text_serve`` kept of each of its 96 responses is held
    against that forward (argmax agreement, and the sum within what the
    tolerance allows)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, reg, seqs = (state["text_engine"], state["text_registry"],
                      state["text_seqs"])
    x1 = seqs[:1]
    card = eng.run(x1)[0].cpu().numpy()
    net = bert_gluon.bert_12_768_12()
    net.load_parameters(state["text_params"])
    cpu = InferenceEngine(net, (TEXT_T,), dtype="int32", buckets=(1,),
                          device="cpu").run(x1)[0].numpy()
    del net
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    ref_agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    del card, cpu

    def alone(k):
        return eng.run(seqs[k:k + 1])[0][0]        # on the card

    rows, errs = [], []

    def client(c):
        try:
            for j in range(8):
                k = 32 + 8 * c + j
                one = alone(k)
                out = torch.from_numpy(reg.predict("bert", seqs[k],
                                                   timeout=300)[0][0])
                rows.append(((out.cuda() - one).abs().max().item(),
                             one.abs().max().item()))
                del out, one
        except Exception as e:
            errs.append(repr(e))

    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    reg.close()
    if errs or len(rows) != 64:
        raise AssertionError(f"requests failed: {errs}")
    bat_err = max(e / s for e, s in rows)

    dig_agree, dig_sum = 1.0, 0.0
    for k, (s, am) in state["text_digests"].items():
        one = alone(k)
        dig_agree = min(dig_agree,
                        float((one.argmax(-1).cpu().numpy() == am).mean()))
        dig_sum = max(dig_sum, abs(s - one.double().sum().item()) /
                      (one.abs().max().item() * one.numel()))
    res = {"batch": 1, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": TEXT_REF_TOL,
           "argmax_agree": ref_agree, "argmax_agree_min": TEXT_ARGMAX_AGREE,
           "batched_vs_unbatched_max_rel_diff": bat_err,
           "batched_responses": len(rows),
           "served_digests": len(state["text_digests"]),
           "served_argmax_agree_min": dig_agree,
           "served_sum_diff_per_logit_rel": dig_sum}
    if not (ref_err <= TEXT_REF_TOL * ref_scale and
            ref_agree >= TEXT_ARGMAX_AGREE and bat_err <= TEXT_REF_TOL and
            dig_agree >= TEXT_ARGMAX_AGREE and dig_sum <= TEXT_REF_TOL):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_text_profile(state):
    """Where a Gluon BERT-base forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler, with every element-wise kernel
    of the forward by name (the scale and mask of the scores are the
    softmax kernel's prologue, not passes of their own)."""
    import torch
    eng, seqs = state["text_engine"], state["text_seqs"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(seqs[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8,
                                        detail="elementwise")
    return res


# ------------------------------------------------------------ int8 phases
QCONV_TOL = 1e-6            # of the output's largest magnitude
INT8_REF_TOL = 1e-3         # logits, card vs CPU: of the largest logit
INT8_BATCH = 64             # int8_score.py's defaults
INT8_WARMUP = 4
INT8_ITERS = 20
INT8_AGREE_N = 256
INT8_SERVE_ITERS = 20

INT8_CATEGORIES = (
    ("qconv3x3_affine (ours)", r"qconv_(affine|reduce)_kernel"),
    ("conv_affine (ours)",
     r"conv_affine_(tc|reduce|bf16|bf16_reduce)_kernel"),
    ("int8 gemm (_int_mm)", r"i8i8|s8|imma|int8|igemm|i8"),
    ("quantize: round / clamp", r"round|clamp"),
    ("im2col, pad, slice copies", r"CatArrayBatchedCopy|pad|copy"),
    ("pooling", r"pool|reduce_kernel"),
    ("elementwise (epilogues, casts)", r"elementwise|vectorized"),
)


def _qconv_case(N, H, W, C, Cout, gen, residual=False, relu=True,
                exact=False, split=False):
    """``qconv3x3_affine`` against ``qconv3x3_plain`` at one shape on
    random int8 data, twice on the same inputs (the two outputs must be
    bitwise equal), with its plan, timed beside its bound, its plain
    version,
    ``torch._int_mm`` on the pre-built (N*H*W, 9C) patch matrix (no
    im2col, no epilogue) and the fp32 ``conv_affine`` at the same shape.
    ``exact``: scale 1, shift 0, no ReLU or residual, so the output is
    the int32 sum itself.  ``split``: also the device µs of each kernel
    it launches (the main kernel and the cut-tile reduce)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.ops import cuda_int8 as ci
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    dev = "cuda"
    qx = torch.randint(-127, 128, (N, H, W, C), device=dev, generator=gen,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (3, 3, C, Cout), device=dev,
                       generator=gen, dtype=torch.int8)
    wt = ci.pack_weight(qw)
    if exact:
        scale = torch.ones(Cout, device=dev)
        shift = torch.zeros(Cout, device=dev)
    else:
        scale = torch.rand(Cout, device=dev, generator=gen) * 1e-3 + 1e-4
        shift = 0.1 * torch.randn(Cout, device=dev, generator=gen)
    res = torch.randn(N, H, W, Cout, device=dev, generator=gen) \
        if residual else None
    args = (qx, qw, scale, shift, res, relu)
    out = ci.qconv3x3_affine(*args, qw_packed=wt)
    again = ci.qconv3x3_affine(*args, qw_packed=wt)
    ref = ci.qconv3x3_plain(*args, qw_packed=wt)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale_ref = ref.abs().max().item()
    vec = int(C % 16 == 0 and Cout % 4 == 0)
    sms = cb._sm_count(0)
    plan = ci.qconv_splits(
        N * H * W, 9 * C, Cout, sms,
        cb._per_sm("mxt_qconv_affine_blocks_per_sm", 0,
                   ci.qconv_tile_cols(N * H * W, Cout, sms), vec))
    case = {"shape": [N, H, W, C, Cout], "residual": residual,
            "relu": relu, "exact": exact, "plan": _plan_dict(plan),
            "vec": bool(vec), "max_abs_err": err,
            "rel_err": err / max(scale_ref, 1e-30), "tol": QCONV_TOL,
            "bitwise_equal": bool(torch.equal(out, ref)),
            "bitwise_equal_relaunch": bool(torch.equal(out, again))}
    K = 9 * C
    patches = ci.im2col(qx, (3, 3), pad=(1, 1)).reshape(-1, K)
    if exact:
        acc = ci.int8_matmul(patches, wt).reshape(N, H, W, Cout)
        case["acc_max_abs"] = acc.abs().max().item()
        case["equals_int32_sum"] = bool(
            case["acc_max_abs"] < 2 ** 24 and
            torch.equal(out.to(torch.int64), acc.to(torch.int64)))
    Kp = -(-K // 8) * 8
    pa = F.pad(patches, (0, Kp - K)).contiguous()
    wb = F.pad(wt, (0, Kp - K)).contiguous().t()
    x32 = qx.float()
    w32 = qw.float()
    ones, zeros = torch.ones(Cout, device=dev), torch.zeros(Cout, device=dev)
    npix = N * H * W
    nbytes = npix * C + 9 * C * Cout + 8 * Cout + 4 * npix * Cout * (
        2 if residual else 1)
    ops = 2 * npix * 9 * C * Cout
    bms, by = bound(nbytes, ops, peak=PEAK_INT8_OPS_S)
    staged = plan.tiles * plan.chunks * (ci.QCONV_ROWS + plan.bn) * \
        ci.QCONV_CHUNK
    it = 10 if N >= 64 else 20
    kms = cuda_ms(lambda: ci.qconv3x3_affine(*args, qw_packed=wt), iters=it)
    case.update(
        kernel_ms=kms,
        kernel_eager_ms=eager_ms(
            lambda: ci.qconv3x3_affine(*args, qw_packed=wt), iters=it),
        plain_ms=cuda_ms(lambda: ci.qconv3x3_plain(*args, qw_packed=wt),
                         iters=it),
        library_ms=cuda_ms(lambda: torch._int_mm(pa, wb), iters=it),
        library="torch._int_mm on the pre-built (N*H*W, 9C) patch matrix "
                "(cuBLASLt; no im2col, no epilogue)",
        fp32_conv_affine_ms=cuda_ms(
            lambda: conv_affine(x32, w32, ones, zeros, zeros, ones,
                                res, relu=relu), iters=it),
        bytes=nbytes, ops=ops, bound_ms=bms, bound_by=by,
        bound_share=bms / kms, tops=ops / (kms * 1e-3) / 1e12,
        # the operand bytes the blocks copy into shared memory (every
        # chunk's 128 pixel rows and bn weight rows of 64 bytes, zero
        # fill included) and their rate
        staged_bytes=staged, staged_tb_s=staged / (kms * 1e-3) / 1e12)
    if split:
        case["kernels_us"] = _kernel_us(
            lambda: ci.qconv3x3_affine(*args, qw_packed=wt))
    return case


def _qconv_ok(c):
    if not c["bitwise_equal_relaunch"]:
        return False
    if c["exact"]:
        return c["bitwise_equal"] and c["equals_int32_sum"]
    return c["bitwise_equal"] or c["rel_err"] <= c["tol"]


MMA_S8_PEAK_SRC = r"""
extern "C" __global__ void mma_s8_peak(int* out, int iters) {
  const unsigned v = 0x01010101u * (threadIdx.x & 0x3f);
  const unsigned a0 = v, a1 = v ^ 0x02020202u, a2 = v ^ 0x04040404u,
                 a3 = v ^ 0x08080808u;
  int acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
            "+r"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a1), "r"(a3));
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def _mma_s8_ceiling():
    """What ``mma.sync.m16n8k32`` int8 sustains on this card: every warp
    issues independent products on registers (8 accumulators, no memory
    in the loop), 8 warps a block, 2 blocks an SM; compiled by NVRTC
    through ``rtc.CudaModule``.  The ceiling of any ``mma.sync`` int8
    kernel, beside the 1,979 TOPS dense peak that ``wgmma`` can reach."""
    import torch
    from mxnet_tpu_torch import rtc
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    kern = rtc.CudaModule(MMA_S8_PEAK_SRC).get_kernel("mma_s8_peak")
    run = lambda: kern.launch([iters], grid=(blocks,), block=(256,),  # noqa
                              out_shape=(blocks * 256,))
    ms = cuda_ms(run, iters=3)
    ops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 32
    return {"blocks": blocks, "ms": ms, "ops": ops,
            "tops": ops / (ms * 1e-3) / 1e12,
            "share_of_dense_peak": ops / (ms * 1e-3) / PEAK_INT8_OPS_S}


def phase_int8_kernels(state):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    # int8_score's batch-64 stages first (the path's shape), the same at
    # batch 8 (serving), the batch-1 tail, ResNet-18's residual tail,
    # ReLU off, a ragged shape and the exact case
    stages = ((56, 64), (28, 128), (14, 256), (7, 512))
    cases = [_qconv_case(64, h, h, c, c, gen, split=True) for h, c in stages]
    cases += [_qconv_case(8, h, h, c, c, gen, split=True) for h, c in stages]
    cases += [_qconv_case(1, 7, 7, 512, 512, gen, split=True),
              _qconv_case(8, 56, 56, 64, 64, gen, residual=True),
              _qconv_case(8, 28, 28, 128, 128, gen, relu=False),
              _qconv_case(2, 13, 17, 20, 40, gen, residual=True),
              _qconv_case(8, 56, 56, 64, 64, gen, relu=False, exact=True)]
    state["cases"]["qconv3x3_affine"] = cases
    bad = [c for c in cases if not _qconv_ok(c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _mma_s8_ceiling()
    for c in cases:
        c["mma_sync_ceiling_share"] = \
            c["ops"] / (c["kernel_ms"] * 1e-3) / 1e12 / ceiling["tops"]
    return {"cases": cases, "mma_s8_ceiling": ceiling,
            "parts": _qconv_parts([(64, h, c) for h, c in stages])}


def _build_variants(what, source, cuts, entries):
    """The kernels of ``csrc/<source>`` as the library built them
    (``"kernel"``: ``_build.lib()``) and copies with parts cut out:
    ``cuts`` maps a name to the (text, replacement) pairs made in a copy
    of the source, each copy built by its own nvcc (all started together,
    the library's code flags) into ``build/chip_smoke/<what>``, with
    ``entries`` bound.  → ({name: library}, {name: why it was not built}):
    a cut whose text is no longer in the source, or that nvcc refuses, is
    reported there, and fails nothing."""
    import ctypes
    from mxnet_tpu_torch import _build
    src = open(os.path.join(_build.CSRC, source)).read()
    work = os.path.join(HERE, "build", "chip_smoke", what)
    os.makedirs(work, exist_ok=True)
    procs, missing = {}, {}
    for name, pairs in cuts.items():
        if not all(a and a in src for a, _ in pairs):
            missing[name] = "its text is no longer in " + source
            continue
        text = src
        for a, b in pairs:
            text = text.replace(a, b)
        path = os.path.join(work, name)
        with open(path + ".cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-I", str(_build.CSRC),
             "-shared", "-Xcompiler", "-fPIC", "-o", path + ".so",
             path + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"kernel": _build.lib()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            missing[name] = "nvcc failed: " + log[-2000:]
            continue
        lib = ctypes.CDLL(os.path.join(work, name + ".so"))
        for e in entries:
            getattr(lib, e).argtypes = _build._SIGNATURES[e]
        libs[name] = lib
    return libs, missing


def _qconv_parts(shapes):
    """Where the int8 kernel's loop spends its time: the kernel as built,
    and with one part taken out (``no_copies``: the ring is never
    filled; ``no_products``: each ``mma.sync`` a register add), built by
    :func:`_build_variants` and timed (device ms) at ``shapes`` (batch,
    H = W, C = Cout) on the plan the wrapper runs.  The outputs of the cut
    kernels are garbage; only their times are kept."""
    import torch
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.ops import cuda_int8 as ci
    src = open(os.path.join(_build.CSRC, "qconv_affine.cu")).read()
    mma = src.find('asm("mma.sync')
    tail = '"r"(b[0]), "r"(b[1]));'
    end = src.find(tail, mma)
    product = src[mma:end + len(tail)] if min(mma, end) >= 0 else None
    libs, missing = _build_variants(
        "qconv_parts", "qconv_affine.cu",
        {"no_copies": [("if (pre < nk) ld.load(s, pre % STAGES);", ";"),
                       ("if (st < nk) ld.load(s, st);", ";")],
         "no_products": [(product, "c[0] += (int)(a[0] + b[0]);")]},
        ["mxt_qconv_affine_s8"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = []
    for N, H, C in shapes:
        qx = torch.randint(-127, 128, (N, H, H, C), device="cuda",
                           generator=gen, dtype=torch.int8)
        wt = torch.randint(-127, 128, (C, 9 * C), device="cuda",
                           generator=gen, dtype=torch.int8)
        sc, sh = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
        y = torch.empty(N, H, H, C, device="cuda")
        sms = cb._sm_count(0)
        plan = ci.qconv_splits(
            N * H * H, 9 * C, C, sms,
            cb._per_sm("mxt_qconv_affine_blocks_per_sm", 0,
                       ci.qconv_tile_cols(N * H * H, C, sms), 1))
        part = torch.empty(2 * plan.ranges, ci.QCONV_ROWS, plan.bn,
                           device="cuda", dtype=torch.int32)
        row = {"shape": [N, H, H, C, C], "plan": plan._asdict()}
        for name, lib in libs.items():
            def run(lib=lib):
                _build.check(lib.mxt_qconv_affine_s8(
                    qx.data_ptr(), wt.data_ptr(), sc.data_ptr(),
                    sh.data_ptr(), None, part.data_ptr(), y.data_ptr(), N,
                    H, H, C, C, 1, plan.bn, plan.ranges, plan.grain, 1,
                    torch.cuda.current_stream().cuda_stream), name)
            row[name + "_ms"] = cuda_ms(run, iters=10)
        out.append(row)
    return {"shapes": out, "not_built": missing}


def _int8_counters():
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.ops.cuda_int8 import qconv3x3_affine
    return qconv3x3_affine, conv_affine


def _load_resnet50(path, device):
    from mxnet_tpu_torch.models import get_model
    net = get_model("resnet50_v1", classes=1000)
    net.load_parameters(path)
    net.eval()
    return net.to(device)


def phase_int8_score(state):
    """``benchmark/int8_score.py`` at its defaults on the card: ResNet-50
    v1, 1000 classes, batch 64 of 224x224x3, fp32, bf16
    (``amp.convert_model``, bf16 inputs) and int8 (two
    ``RandomState(1)`` [0, 1) calibration batches, naive) scoring with
    4 warm-up and 20 timed forwards on fresh inputs, and the int8-vs-fp32
    and bf16-vs-fp32 argmax agreements over 256 ``RandomState(0)``
    images.  The launch counters are set to 0 before the bf16 forwards
    and read after: 16 bf16 ``conv_affine`` launches a forward and no fp32
    one; then before the int8 forwards: 16 ``qconv3x3_affine`` and 0
    ``conv_affine`` launches a forward."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import quantization as q
    path = state["image_params"]
    B, S = INT8_BATCH, 224
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    xs = [torch.rand(B, S, S, 3, device="cuda", generator=gen)
          for _ in range(INT8_WARMUP + INT8_ITERS)]

    def score(net, dtype=torch.float32):
        """ms a batch by CUDA events, and the host's ms to queue a batch's
        forward (near the former: the scoring is host-bound)."""
        ins = [x.to(dtype) for x in xs]         # made before the window
        with torch.inference_mode():
            for x in ins[:INT8_WARMUP]:
                net(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for x in ins[INT8_WARMUP:]:
                net(x)
            end.record()
            host = (time.perf_counter() - t0) * 1e3 / INT8_ITERS
            end.synchronize()
        ms = start.elapsed_time(end) / INT8_ITERS
        return {"ms_per_batch": ms, "images_s": B / (ms * 1e-3),
                "host_ms_per_batch": host}

    fp32_net = _load_resnet50(path, "cuda")
    fp32 = score(fp32_net)
    bf16_net = amp.convert_model(_load_resnet50(path, "cuda"), "bfloat16")
    _zero_half_counts()
    bf16 = score(bf16_net, torch.bfloat16)
    bf16_counts = _half_counts()
    int8_net = _load_resnet50(path, "cuda")
    rs = np.random.RandomState(1)
    calib = [rs.rand(B, S, S, 3).astype(np.float32) for _ in range(2)]
    t0 = time.perf_counter()
    q.quantize_net(int8_net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qk, ca = _int8_counters()
    qk.launches = ca.launches = 0
    int8 = score(int8_net)
    forwards = INT8_WARMUP + INT8_ITERS
    launches = {"qconv3x3_affine": qk.launches,
                "conv_affine": ca.launches, "forwards": forwards}
    state["int8_launches"] = {"qconv3x3_affine": qk.launches}

    rs = np.random.RandomState(0)
    agree = agree16 = total = 0
    with torch.inference_mode():
        for _ in range(INT8_AGREE_N // B):
            x = torch.as_tensor(rs.rand(B, S, S, 3).astype(np.float32),
                                device="cuda")
            a = fp32_net(x).argmax(-1)
            b = int8_net(x)
            c = bf16_net(x.bfloat16())
            if not (torch.isfinite(b).all() and torch.isfinite(c).all()):
                raise AssertionError("int8 or bf16 logits not finite")
            agree += int((a == b.argmax(-1)).sum())
            agree16 += int((a == c.argmax(-1)).sum())
            total += B
    bf16_counts["forwards"] = INT8_WARMUP + INT8_ITERS
    # the scoring's and the agreement's bf16 forwards (the int8 ones
    # launch no conv_affine)
    _add_bf16_launches(state, _half_counts())
    twins = sum(isinstance(b, q._Twin) for b in int8_net.modules())
    state["int8_score_agreement"] = agree / total
    del fp32_net, int8_net, bf16_net, xs
    torch.cuda.empty_cache()
    res = {"model": "resnet50_v1", "classes": 1000, "batch": B,
           "image": S, "warmup": INT8_WARMUP, "iters": INT8_ITERS,
           "fp32": fp32, "bf16": bf16, "int8": int8,
           "int8_vs_fp32": int8["images_s"] / fp32["images_s"],
           "int8_vs_bf16": int8["images_s"] / bf16["images_s"],
           "bf16_vs_fp32": bf16["images_s"] / fp32["images_s"],
           "int8_argmax_agreement_vs_fp32": agree / total,
           "bf16_argmax_agreement_vs_fp32": agree16 / total,
           "agreement_images": total, "quantize_s": quant_s,
           "twins": twins, "launches": launches,
           "bf16_launches": bf16_counts}
    if launches["qconv3x3_affine"] != RESNET50_SEGMENTS * forwards or \
            launches["conv_affine"] != 0 or twins != 54:
        raise AssertionError(f"int8 forward launches: {res}")
    if not _affine_path_ok(bf16_counts, forwards):
        raise AssertionError(f"bf16 forward launches: {res}")
    return res


def phase_int8_serve(state):
    """int8 ResNet-50 v1 through ``ModelRegistry.load(...,
    precision="int8")`` (default calibration, buckets 1, 2, 4, 8, warmup
    of every bucket) and its ``Batcher``: 32 closed-loop requests from
    one client, then 64 from 8 client threads; then int8_score.py's
    ``--serve`` leg, the int8 engine's QPS against the bf16 engine's at
    bucket 8 (each response fetched to the host; the bf16 engine's
    conv_affine launches counted: 16 bf16 ones a forward)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import InferenceEngine, ModelRegistry

    path, images = state["image_params"], state["images"]
    qk, ca = _int8_counters()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    qk.launches = ca.launches = 0
    telemetry.reset()
    reg = ModelRegistry(precision="int8")
    t0 = time.perf_counter()
    entry = reg.load("resnet50_int8", path, arch="resnet50_v1",
                     item_shape=(224, 224, 3))
    load_s = time.perf_counter() - t0
    state.update(int8_registry=reg, int8_engine=entry.engine)

    lat, outs = [], []
    for i in range(32):
        t1 = time.perf_counter()
        outs.append(reg.predict("resnet50_int8", images[i])[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    got, errs = {}, []

    def client(c):
        try:
            for j in range(8):
                k = 8 * c + j
                got[k] = reg.predict("resnet50_int8", images[k],
                                     timeout=300)[0]
        except Exception as e:
            errs.append(repr(e))

    h0 = telemetry.raw_snapshot()["histograms"].get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    eng = entry.engine
    forwards = eng.forwards
    launches = {"qconv3x3_affine": qk.launches, "conv_affine": ca.launches,
                "forwards": forwards}
    prev = state["int8_launches"]["qconv3x3_affine"]
    state["int8_launches"] = {"qconv3x3_affine": prev + qk.launches}
    state["int8_batched"] = got
    if errs or len(got) != 64:
        raise AssertionError(f"concurrent requests failed: {errs}")
    bad = [o for o in outs + list(got.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if launches["qconv3x3_affine"] != RESNET50_SEGMENTS * forwards or \
            launches["conv_affine"] != 0:
        raise AssertionError(f"int8 serving launches: {launches}")
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    hist = snap["histograms"]

    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(images[:b], device="cuda")
        per_bucket[b] = {
            # one forward per window behind a ~80 ms sleep: the host
            # takes ~15-20 ms to queue an int8 forward's ~600 launches
            "device_ms": cuda_ms(lambda: eng.run(x), iters=1, repeats=5,
                                 sleep=4 * SLEEP_CYCLES),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=10)}
    peak = torch.cuda.max_memory_allocated()

    # int8_score.py --serve: one engine a precision at bucket 8, the
    # response fetched to the host after every run
    serve_leg = {"bucket": 8, "iters": INT8_SERVE_ITERS}
    xs = [images[8 * i:8 * i + 8] for i in range(4)]
    for prec in ("bf16", "int8"):
        net = _load_resnet50(path, "cpu")
        _zero_half_counts()
        e = InferenceEngine(net, (224, 224, 3), buckets=(8,),
                            name=f"int8row-{prec}", precision=prec)
        e.warmup()
        t2 = time.perf_counter()
        for i in range(INT8_SERVE_ITERS):
            for o in e.run(xs[i % len(xs)]):
                o.cpu()
        dt = time.perf_counter() - t2
        serve_leg[f"{prec}_qps"] = 8 * INT8_SERVE_ITERS / dt
        if prec == "bf16":
            counts = _half_counts()
            serve_leg["bf16_launches"] = {**counts, "forwards": e.forwards}
            _add_bf16_launches(state, counts)
            if not _affine_path_ok(counts, e.forwards):
                raise AssertionError(f"bf16 serve leg launches: {counts}")
        del e, net
    serve_leg["int8_vs_bf16"] = serve_leg["int8_qps"] / \
        serve_leg["bf16_qps"]
    torch.cuda.empty_cache()
    return {"model": "resnet50_v1", "precision": "int8", "classes": 1000,
            "item_shape": [224, 224, 3], "buckets": list(eng.buckets),
            "load_quantize_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "images_s": 64 / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0))},
            "queue_wait_us_mean": _mean_us({}, hist, "serve.queue_wait_us"),
            "device_us_mean": _mean_us({}, hist, "serve.device_us"),
            "per_bucket": per_bucket, "launches": launches,
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "param_bytes_per_device")},
            "peak_mem_bytes": peak, "mem_before_bytes": mem_before,
            "serve_leg": serve_leg}


def phase_int8_reference(state):
    """The card's int8 engine against the port on the CPU from the same
    ``.params`` and the same int8 weights and thresholds (carried with
    ``quantization.state_from_numpy``) at batch 2; and each batched
    response against the unbatched forward of its image on the card."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import quantization as q
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, images = state["int8_engine"], state["images"]
    card_state = {p: {"qw": b._qw.cpu().numpy(),
                      "w_scale": b._w_scale.cpu().numpy(),
                      "bias": None if b._bias is None
                      else b._bias.cpu().numpy(), "in_t": b._in_t}
                  for _, b, p in q._walk(eng.net)
                  if isinstance(b, q._Twin)}
    x2 = images[:2]
    card = eng.run(x2)[0].cpu().numpy()
    net = _load_resnet50(state["image_params"], "cpu")
    q.quantize_net(net, thresholds={p: s["in_t"]
                                    for p, s in card_state.items()})
    q.state_from_numpy(net, card_state)
    cpu = InferenceEngine(net, (224, 224, 3), buckets=(2,),
                          precision="int8", device="cpu").run(x2)[0].numpy()
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())

    bat_err, bat_scale, bitwise = 0.0, 0.0, 0
    for k, out in state["int8_batched"].items():
        one = eng.run(images[k:k + 1])[0].cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_scale = max(bat_scale, float(np.abs(one).max()))
        bitwise += int(np.array_equal(out, one))
    state["int8_registry"].close()
    res = {"batch": 2, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": INT8_REF_TOL,
           "logits_bitwise_equal": bool(np.array_equal(card, cpu)),
           "top1_equal": top1,
           "batched_vs_unbatched_max_abs_diff": bat_err,
           "batched_max_abs": bat_scale,
           "batched_bitwise_equal": bitwise,
           "batched_responses": len(state["int8_batched"])}
    if not (ref_err <= INT8_REF_TOL * ref_scale and top1 and
            bat_err <= INT8_REF_TOL * bat_scale):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_int8_profile(state):
    """Where an int8 ResNet-50 forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler."""
    import torch
    eng, images = state["int8_engine"], state["images"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(images[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8,
                                        categories=INT8_CATEGORIES)
    return res


# ------------------------------------------------------- extension phases
# the largest elementwise operand of a model the port runs: ResNet-50 v1
# batch-64 training's stage-1 block output, 205.5 MB in fp32 (4x the L2)
EXT_SHAPE = (64, 56, 56, 256)
EXT_RAGGED = 1_000_003          # ragged for the 16-byte path
SIGMOID_TOL = 1e-6              # absolute: sigmoid values lie in [0, 1]
STOCK_OPS = ("tvm_vadd", "tvm_vmul", "tvm_sigmoid")
# ops an element (for the bound; the bytes bound them all)
STOCK_FLOPS = {"tvm_vadd": 1, "tvm_vmul": 1, "tvm_sigmoid": 4}
EXT_CALLS = {"tvm_vadd": 2, "tvm_vmul": 2, "tvm_sigmoid": 1,
             "tvm_test_relu": 1, "rtc_axpy": 2}


def _ext_inputs(op, n, dtype, gen, offset=False):
    import torch
    out = []
    for _ in range(op.num_inputs):
        m = n + (1 if offset else 0)
        if dtype.is_floating_point:
            t = 3 * torch.randn(m, device="cuda", dtype=dtype, generator=gen)
        else:
            t = torch.randint(-2 ** 15, 2 ** 15, (m,), device="cuda",
                              dtype=dtype, generator=gen)
        out.append(t[1:] if offset else t)
    return out


def _ext_case(name, n, gen, dtype=None, offset=False, shape=None,
              timed=False):
    """A stock generated op's kernel against its plain version on the
    same inputs: ``tvm_vadd`` / ``tvm_vmul`` bit for bit, ``tvm_sigmoid``
    within 1e-6; timed beside its bound, its plain version and the one
    torch call computing the same function."""
    import torch
    from mxnet_tpu_torch import tvmop
    op = tvmop.get(name)
    dtype = dtype or torch.float32
    xs = _ext_inputs(op, n, dtype, gen, offset)
    if shape is not None:
        xs = [x.view(shape) for x in xs]
    out = op.forward(*xs)
    ref = op.plain(*xs)
    torch.cuda.synchronize()
    exact = name != "tvm_sigmoid"
    err = (out.double() - ref.double()).abs().max().item()
    vec = int(all(t.data_ptr() % 16 == 0 for t in xs + [out]) and
              n >= 16 // out.element_size())
    case = {"shape": list(shape or (n,)), "dtype": str(dtype)[6:],
            "offset_view": offset, "vector_path": bool(vec),
            "max_abs_err": err, "bitwise_equal": bool(torch.equal(out, ref)),
            "tol": 0.0 if exact else SIGMOID_TOL,
            "finite": bool(torch.isfinite(out.double()).all())}
    case["ok"] = (case["bitwise_equal"] if exact else
                  err <= SIGMOID_TOL and case["finite"])
    if timed:
        library = {"tvm_vadd": torch.add, "tvm_vmul": torch.mul,
                   "tvm_sigmoid": torch.sigmoid}[name]
        nbytes = (op.num_inputs + 1) * n * out.element_size()
        bms, by = bound(nbytes, STOCK_FLOPS[name] * n)
        kms = cuda_ms(lambda: op.forward(*xs))
        case.update(kernel_ms=kms,
                    kernel_eager_ms=eager_ms(lambda: op.forward(*xs)),
                    plain_ms=cuda_ms(lambda: op.plain(*xs)),
                    library_ms=cuda_ms(lambda: library(*xs)),
                    library=f"torch.{library.__name__}", bytes=nbytes,
                    bound_ms=bms, bound_by=by,
                    gb_s=nbytes / (kms * 1e-3) / 1e9,
                    bound_share=bms / kms)
    return case


def _compile_ms(src, exports=()):
    """NVRTC compile of ``src``, cold (the cache bypassed) and from the
    CUBIN cache the cold compile wrote."""
    from mxnet_tpu_torch import _nvrtc
    cold = _nvrtc.compile_program(src, (), exports, use_cache=False)
    cached = _nvrtc.compile_program(src, (), exports)
    if not cached.cached or cached.image != cold.image:
        raise AssertionError("the CUBIN cache did not return the compile")
    return {"cold_ms": cold.seconds * 1e3, "cached_ms": cached.seconds * 1e3,
            "cubin_bytes": len(cold.image), "log": cold.log[:400]}


def phase_ext_kernels(state):
    """The three stock generated kernels against their plain versions:
    full width (timed), one element, a ragged length, an offset view
    (the 16-byte path refused; at full width it is timed too) and the
    other element types."""
    import torch
    from mxnet_tpu_torch import tvmop
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    full = 1
    for d in EXT_SHAPE:
        full *= d
    res = {"compile": {}}
    for name in STOCK_OPS:
        res["compile"][name] = _compile_ms(
            tvmop.get(name).source(torch.float32))
        cases = [_ext_case(name, full, gen, shape=EXT_SHAPE, timed=True),
                 _ext_case(name, 1, gen), _ext_case(name, EXT_RAGGED, gen),
                 _ext_case(name, EXT_RAGGED, gen, offset=True)]
        if name == "tvm_vadd":
            cases.append(_ext_case(name, full, gen, offset=True, timed=True))
        dtypes = (torch.float64,) if name == "tvm_sigmoid" else \
            (torch.float64, torch.int32, torch.int64)
        cases += [_ext_case(name, EXT_RAGGED, gen, dtype=dt)
                  for dt in dtypes]
        state["cases"][name] = cases
        res[name] = cases
    bad = [(n, c) for n in STOCK_OPS for c in res[n] if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    if any(res[n][0]["vector_path"] is False or res[n][3]["vector_path"]
           for n in STOCK_OPS):
        raise AssertionError("full width must take the 16-byte path and the "
                             "offset view must not")
    return res


RTC_BAD_SOURCE = 'extern "C" __global__ void bad(float *o) { o[0] = ; }'


def phase_rtc(state):
    """The JAX package's rtc test kernels as CUDA source through
    ``CudaModule``: axpy and the out-dtype-templated ``double_it`` at the
    tests' own sizes and at full width, axpy also at a ragged length (the
    16-byte path and a scalar tail) and on an offset view (the scalar
    path), bit for bit against plain torch; the full width on the 16-byte
    path; one compile for the module however often it launches; a launch
    from a second thread; an NVRTC syntax error and a dtype mismatch
    raise."""
    import torch
    from mxnet_tpu_torch import _nvrtc, rtc
    from mxnet_tpu_torch.examples import rtc_example as rx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    res = {"compile": _compile_ms(rx.SOURCE.read_text(), rx.EXPORTS)}
    mod = rx.module()
    axpy, dbl = mod.get_kernel("axpy"), mod.get_kernel("double_it")
    checks = {}
    # the tests' own sizes: axpy over 8, double over 16 with grid 2 x 8
    x8 = torch.arange(8, dtype=torch.float32, device="cuda")
    y8 = torch.ones(8, device="cuda")
    o8 = rx.axpy(axpy, x8, y8)
    checks["axpy_8"] = bool(torch.equal(o8, 2 * x8 + 1))
    checks["compiles_after_first_launch"] = mod.compiles
    rx.axpy(axpy, x8, y8)
    x16 = torch.arange(16, dtype=torch.float32, device="cuda")
    for dt in (torch.float32, torch.int32):
        o16 = dbl.launch([x16, 16], grid=(2,), block=(8,), out_dtype=dt)
        checks[f"double_16_{str(dt)[6:]}"] = bool(
            o16.dtype == dt and torch.equal(o16, rx.double_plain(x16, dt)))
    checks["compiles_after_relaunch"] = mod.compiles
    # full width
    x = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    y = torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    out = rx.axpy(axpy, x, y)
    ref = rx.axpy_plain(x, y)
    checks["axpy_full"] = bool(torch.equal(out, ref))
    checks["axpy_full_vector_path"] = rx.vector_path(x, y, out)
    # a ragged length: 16-byte vectors and a scalar tail of n % 4
    xr = 3 * torch.randn(EXT_RAGGED, device="cuda", generator=gen)
    yr = torch.randn(EXT_RAGGED, device="cuda", generator=gen)
    outr = rx.axpy(axpy, xr, yr)
    checks["axpy_ragged"] = bool(torch.equal(outr, rx.axpy_plain(xr, yr)))
    # an offset view at full width: 4 bytes past an aligned start, scalar
    xo, yo = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
              for t in (x, y))
    outo = rx.axpy(axpy, xo, yo)
    refo = rx.axpy_plain(xo, yo)
    checks["axpy_offset"] = bool(torch.equal(outo, refo))
    checks["axpy_offset_scalar_path"] = not rx.vector_path(xo, yo, outo)
    for dt in (torch.float32, torch.int32):
        o = rx.double(dbl, x, dt)
        checks[f"double_full_{str(dt)[6:]}"] = bool(
            torch.equal(o, rx.double_plain(x, dt)))
    # a launch from a thread that has no current context
    got, errs = {}, []

    def worker():
        try:
            xt = torch.randn(EXT_RAGGED, device="cuda")
            yt = torch.randn(EXT_RAGGED, device="cuda")
            got["ok"] = bool(torch.equal(rx.axpy(axpy, xt, yt),
                                         rx.axpy_plain(xt, yt)))
        except Exception as e:
            errs.append(repr(e))

    t = threading.Thread(target=worker)
    t.start()
    t.join(120)
    checks["thread"] = got.get("ok", False) and not errs
    checks["compiles_at_end"] = mod.compiles
    # refusals
    try:
        rtc.CudaModule(RTC_BAD_SOURCE).get_kernel("bad").launch(
            [], out_shape=(1,))
        checks["syntax_error_raises"] = False
    except _nvrtc.NvrtcError as e:
        checks["syntax_error_raises"] = "error" in str(e)
        res["syntax_error_log"] = str(e)[:600]
    try:
        axpy.launch([x.double(), y.double(), x.numel()])
        checks["dtype_mismatch_raises"] = False
    except TypeError as e:
        checks["dtype_mismatch_raises"] = True
        res["dtype_mismatch"] = str(e)
    n = x.numel()
    nbytes = 3 * n * 4
    bms, by = bound(nbytes, 2 * n)
    kms = cuda_ms(lambda: rx.axpy(axpy, x, y))
    lms = cuda_ms(lambda: torch.add(y, x, alpha=2.0))
    case = {"shape": list(EXT_SHAPE), "max_abs_err":
            (out - ref).abs().max().item(), "bitwise_equal":
            checks["axpy_full"], "vector_path":
            checks["axpy_full_vector_path"], "grid": rx.grid_axpy(n, True)[0],
            "kernel_ms": kms,
            "kernel_eager_ms": eager_ms(lambda: rx.axpy(axpy, x, y)),
            "plain_ms": cuda_ms(lambda: rx.axpy_plain(x, y)),
            "library_ms": lms, "library": "torch.add(y, x, alpha=2)",
            "vs_library": kms / lms, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by,
            "gb_s": nbytes / (kms * 1e-3) / 1e9, "bound_share": bms / kms}
    okms = cuda_ms(lambda: rx.axpy(axpy, xo, yo))
    offset = {"shape": list(EXT_SHAPE), "offset_view": True,
              "max_abs_err": (outo - refo).abs().max().item(),
              "bitwise_equal": checks["axpy_offset"], "vector_path": False,
              "kernel_ms": okms, "bound_ms": bms, "bound_by": by,
              "bound_share": bms / okms,
              "library_ms": cuda_ms(lambda: torch.add(yo, xo, alpha=2.0))}
    ragged = {"shape": [EXT_RAGGED], "bitwise_equal": checks["axpy_ragged"],
              "max_abs_err": (outr - rx.axpy_plain(xr, yr)).abs().max()
              .item()}
    state["cases"]["rtc_axpy"] = [case, offset, ragged]
    # the eager cost of one launch at the tests' size, against torch.add
    res["eager_launch_us"] = {
        "rtc_axpy_8": 1e3 * eager_ms(lambda: rx.axpy(axpy, x8, y8),
                                     iters=200),
        "torch_add_8": 1e3 * eager_ms(lambda: torch.add(x8, y8), iters=200)}
    res.update(checks=checks, axpy=case, axpy_offset=offset,
               axpy_ragged=ragged)
    ok = all(v is True for k, v in checks.items()
             if not k.startswith("compiles")) and \
        checks["compiles_after_first_launch"] == 1 and \
        checks["compiles_at_end"] == 1
    if not ok:
        raise AssertionError(f"rtc checks failed: {checks}")
    return res


def phase_ext_path(state):
    """The slice's path at full width, with the launch counters set to 0
    first: ``nd.tvm_vadd`` / ``nd.tvm_vmul``; ``nd.tvm_sigmoid`` forward
    and backward under ``autograd.record()``; a user ``tvmop.register``
    of ``tvm_test_relu``, run and unregistered; ``nd.Custom`` of a
    ``t_sigmoid`` CustomOp forward and backward; the example library
    built by ``compile_example`` and loaded, ``nd.my_relu6`` and
    ``nd.my_scale(k=3.0)`` forward and backward; a user rtc kernel
    (axpy).  Every counter must equal the calls made."""
    import tempfile

    import torch
    from mxnet_tpu_torch import autograd, library, nd, operator, rtc, tvmop
    from mxnet_tpu_torch.examples import rtc_example as rx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    a = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    b = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    ops = {n: tvmop.get(n) for n in STOCK_OPS}
    axpy = rx.module().get_kernel("axpy")
    rx.axpy(axpy, a[:1], b[:1])      # compiled before the counted run
    torch.cuda.synchronize()
    res, checks = {}, {}

    @tvmop.register("tvm_test_relu", body="o = x0 < T(0) ? T(0) : x0;")
    def relu(x):
        return torch.clamp_min(x, 0)

    @operator.register("t_sigmoid")
    class _SigmoidProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return _SigmoidOp()

    class _SigmoidOp(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + torch.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    for op in ops.values():
        op.launches = 0
    relu.launches = 0
    rtc.Kernel.launches = 0
    t_path = time.perf_counter()
    try:
        for _ in range(EXT_CALLS["tvm_vadd"]):
            s = nd.tvm_vadd(a, b)
        for _ in range(EXT_CALLS["tvm_vmul"]):
            p = nd.tvm_vmul(a, b)
        checks["vadd"] = bool(torch.equal(s, a + b))
        checks["vmul"] = bool(torch.equal(p, a * b))
        del s, p
        # sigmoid forward and backward
        x = a.clone().requires_grad_()
        with autograd.record():
            y = nd.tvm_sigmoid(x)
        autograd.backward(y.sum())
        sp = ops["tvm_sigmoid"].plain(a)
        res["sigmoid_fwd_max_abs_err"] = (y.detach() - sp).abs().max().item()
        res["sigmoid_grad_max_abs_err"] = \
            (x.grad - sp * (1 - sp)).abs().max().item()
        checks["sigmoid"] = res["sigmoid_fwd_max_abs_err"] <= SIGMOID_TOL \
            and res["sigmoid_grad_max_abs_err"] <= SIGMOID_TOL
        del x, y
        # a user-registered generated op
        r = nd.tvm_test_relu(a)
        checks["user_relu"] = bool(torch.equal(r, relu.plain(a)))
        checks["user_relu_compiles"] = relu.compiles == 1
        del r
        # a Python custom op, its body torch ops on the card
        x = a.clone().requires_grad_()
        t0 = time.perf_counter()
        with autograd.record():
            y = nd.Custom(x, op_type="t_sigmoid")
        autograd.backward(y.sum())
        torch.cuda.synchronize()
        res["custom_fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        res["custom_max_abs_err"] = max(
            (y.detach() - sp).abs().max().item(),
            (x.grad - sp * (1 - sp)).abs().max().item())
        checks["custom"] = res["custom_max_abs_err"] <= SIGMOID_TOL and \
            y.device == a.device
        del x, y, sp
        # the example library: host code, a round trip each call
        build = os.path.join(HERE, "build", "mxnet_tpu_torch")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as d:
            so = library.compile_example(d)
            library.load(so, verbose=False)
            x = a.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                y6 = nd.my_relu6(x)
            torch.cuda.synchronize()
            res["relu6_fwd_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            autograd.backward(y6.sum())
            torch.cuda.synchronize()
            res["relu6_bwd_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
            checks["relu6"] = bool(
                y6.device == a.device and
                torch.equal(y6, a.clamp(0, 6)) and
                torch.equal(x.grad, ((a > 0) & (a < 6)).float()))
            del y6
            x.grad = None
            with autograd.record():
                y3 = nd.my_scale(x, k=3.0)
            autograd.backward(y3.sum())
            checks["scale"] = bool(torch.equal(y3, a * 3.0) and
                                   torch.equal(x.grad, torch.full_like(a, 3)))
            del x, y3
        res["round_trip_bytes"] = 2 * a.numel() * 4
        # a user's rtc kernel
        for _ in range(EXT_CALLS["rtc_axpy"]):
            o = rx.axpy(axpy, a, b)
        checks["rtc_axpy"] = bool(torch.equal(o, rx.axpy_plain(a, b)))
        del o
        torch.cuda.synchronize()
        res["path_s"] = time.perf_counter() - t_path
    finally:
        tvmop._REGISTRY.pop("tvm_test_relu", None)
        if hasattr(nd, "tvm_test_relu"):
            delattr(nd, "tvm_test_relu")
    launches = {n: op.launches for n, op in ops.items()}
    launches.update(tvm_test_relu=relu.launches,
                    rtc_axpy=rtc.Kernel.launches)
    state["ext_launches"] = {k: v for k, v in launches.items()
                             if k != "tvm_test_relu"}
    checks["unregistered"] = "tvm_test_relu" not in tvmop.list_ops()
    res.update(shape=list(EXT_SHAPE), launches=launches, calls=EXT_CALLS,
               checks=checks)
    if launches != EXT_CALLS or not all(checks.values()):
        raise AssertionError(f"extension path: {res}")
    return res


# --------------------------------------------------------- fused steps
FUSED_IMAGE_BATCH = 128     # bench.py train_mode's batch
FUSED_STEPS = 10            # replayed steps after the first call
FUSED_EAGER_STEPS = 5       # the same step function run op by op
FUSED_BERT = dict(batch=8, seq=512, lr=1e-4)    # bench.py bert_mode
FUSED_PROFILE_STEPS = 3
# the captured launches of one ResNet-50 training step (the want of
# image_train) and of one Gluon BERT-base step
FUSED_IMAGE_WANT = {n: RESNET50_SEGMENTS for n in TRAIN_KERNELS}
FUSED_BERT_WANT = {"softmax_fused": BERT_SOFTMAXES,
                   "layernorm_fused": BERT_LAYERNORMS}


def _fused_counts():
    """The wrappers' launch counts as a fused step's capture records them
    (a bf16 instance's also under ``<name>_bf16``)."""
    from mxnet_tpu_torch.parallel import train as pt
    return pt._counts()


def _fused_zero():
    from mxnet_tpu_torch.parallel import train as pt
    for fn in pt.kernel_wrappers().values():
        fn.launches = 0
        for by in ("launches_by_dtype", "launches_by_instance"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


def _eager_body(ex, x, y):
    """One step of ``ex``'s step function run op by op from Python (no
    graph), as the CPU leg runs it: the optimizer's count advances and
    its control is filled as for a replay."""
    import torch
    s = ex._step
    if hasattr(ex, "_trainer"):
        s.opt.rescale_grad = ex._trainer._scale / x.shape[0]
    s.opt.num_update += 1
    out = torch.zeros((), device=s.device)
    s._body(x, y, s.opt.control(s.device, s.opt.num_update), out)
    return out


def _step_marks(fn, n):
    """``n`` calls of ``fn``, a CUDA event before each and one after:
    → (results, ms between consecutive marks)."""
    import torch
    marks, outs = [], []
    for _ in range(n):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        outs.append(fn())
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)
    torch.cuda.synchronize()
    return outs, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def _fused_run(state, key, ex, batches, want, batch,
               launches_key="fused_launches"):
    """Drive ``ex`` (a fused executor, not called yet) over ``batches``.
    First the same step function run eagerly from Python for
    ``FUSED_EAGER_STEPS`` steps (deferred shapes resolved first), timed
    by CUDA events, and the cache emptied; then the fused calls: the
    first (warm-up, capture, first replay) timed alone, the replayed
    steps by CUDA events; then the replays under torch.profiler.  Gates
    the path (fused, one program, no rebuild or fallback, finite losses,
    the captured launches); records the real launches (the first call's
    warm-up and the replays) in ``state[launches_key]`` (None: the caller
    records them)."""
    import math
    import torch
    from mxnet_tpu_torch import telemetry
    x, y = batches[0]
    ex._prepare(x)
    if ex._step is None:
        raise AssertionError(f"no fused step: {ex.fallback_reason}")
    torch.cuda.reset_peak_memory_stats()
    _, eager = _step_marks(lambda: _eager_body(ex, x, y), FUSED_EAGER_STEPS)
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c0 = telemetry.raw_snapshot()["counters"]
    _fused_zero()
    t0 = time.perf_counter()
    first = ex(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, ms = [], []
    for x, y in batches[1:]:
        out, step_ms = _step_marks(lambda: ex(x, y), 1)
        losses += out
        ms += step_ms
    counted = _fused_counts()
    captured = ex.launches_per_step
    replays = ex.replays
    real = {n: counted[n] - captured.get(n, 0) + replays * captured.get(n, 0)
            for n in counted if counted[n]}
    c1 = telemetry.raw_snapshot()["counters"]
    delta = {k: v - c0.get(k, 0) for k, v in c1.items()
             if k.startswith("fused.") and v != c0.get(k, 0)}
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(lambda: ex(x, y), FUSED_PROFILE_STEPS, top=8)
    med = sorted(ms)[len(ms) // 2]
    eager_med = sorted(eager)[len(eager) // 2]
    losses = [float(v) for v in [first] + losses]
    res = {"batch": batch, "first_call_s": first_s,
           "replayed_step_ms": ms, "replayed_step_ms_median": med,
           "eager_step_ms": eager, "eager_step_ms_median": eager_med,
           "eager_over_replayed": eager_med / med,
           "items_s_replayed": batch / med * 1e3,
           "items_s_eager": batch / eager_med * 1e3,
           "losses": losses, "replays": replays,
           "launches_per_step": captured, "launches_per_step_want": want,
           "launches_replayed": ex.replayed_launches(),
           "launches_real": real, "telemetry": delta,
           "programs": ex.programs,
           "fallback_reason": getattr(ex, "fallback_reason", None),
           "profile_replays": prof, "peak_mem_bytes": peak,
           "eager_peak_mem_bytes": eager_peak}
    if launches_key is not None:
        prev = state.setdefault(launches_key, {})
        for n, k in real.items():
            prev[n] = prev.get(n, 0) + k
    state[key] = res
    problems = []
    if res["fallback_reason"] is not None or delta.get("fused.fallbacks"):
        problems.append("a fallback")
    if ex.programs != 1 or delta.get("fused.rebuilds"):
        problems.append("not one program")
    if replays != len(batches) or replays < 10:
        problems.append(f"{replays} replays")
    if not all(math.isfinite(v) for v in losses):
        problems.append("a non-finite loss")
    if {n: captured.get(n, 0) for n in want} != want or any(
            k for n, k in captured.items() if n not in want):
        problems.append("captured launches differ from the path's")
    if problems:
        raise AssertionError(f"{problems}: {res}")
    return res


def phase_fused_image_train(state):
    """ResNet-50 v1 training through ``Trainer.fuse_step`` at
    ``bench.py`` ``train_mode``'s configuration: fp32 NHWC 224x224x3,
    1000 classes, hybridized, SGD lr 0.1, momentum 0.9, wd 1e-4,
    ``SoftmaxCrossEntropyLoss``, batch 128; each step one CUDA-graph
    replay."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(["--batch-size", str(FUSED_IMAGE_BATCH),
                          "--seed", str(SEED)])
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, trainer, loss_fn = ic.build(args, dev)
    step = trainer.fuse_step(loss_fn)
    rng = np.random.RandomState(SEED)
    batches = []
    for _ in range(1 + FUSED_STEPS):
        x, y = ic.synthetic_batch(rng, args.batch_size, args.image_size,
                                  args.classes)
        batches.append((torch.as_tensor(x, device=dev),
                        torch.as_tensor(y, device=dev)))
    res = _fused_run(state, "fused_image", step, batches, FUSED_IMAGE_WANT,
                     args.batch_size)
    res.update(model="resnet50_v1", optimizer="sgd", lr=args.lr,
               momentum=0.9, wd=1e-4, image=args.image_size,
               classes=args.classes)
    return res


def phase_fused_bert_train(state):
    """Gluon BERT-base masked-LM training through ``FusedTrainStep`` at
    ``bench.py`` ``bert_mode``'s configuration in fp32 (bf16 waits for
    amp): ``bert_12_768_12``, vocabulary 30522, 8 x 512 tokens, Adam lr
    1e-4, ``SoftmaxCrossEntropyLoss`` over the (8, 512, 30522) logits;
    weights from the package's initializers seeded with ``SEED``."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.parallel import FusedTrainStep
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = bert_gluon.bert_12_768_12()
    net.initialize(ctx=dev, seed=SEED)
    net.hybridize()
    net.train()
    cfg = FUSED_BERT
    opt = opt_mod.create("adam", learning_rate=cfg["lr"])
    step = FusedTrainStep(net, SoftmaxCrossEntropyLoss(), opt)
    rng = np.random.RandomState(SEED)
    batches = [tuple(torch.as_tensor(rng.randint(0, 30522, (
        cfg["batch"], cfg["seq"])).astype(np.int32), device=dev)
        for _ in range(2)) for _ in range(1 + FUSED_STEPS)]
    res = _fused_run(state, "fused_bert", step, batches, FUSED_BERT_WANT,
                     cfg["batch"])
    res.update(model="bert_12_768_12", optimizer="adam", vocab=30522,
               tokens_s_replayed=res["items_s_replayed"] * cfg["seq"],
               tokens_s_eager=res["items_s_eager"] * cfg["seq"], **cfg)
    return res


def _max_diff(a, b):
    """{name: largest |a − b|} over the tensors of two name → tensor
    dicts that differ."""
    out = {}
    for k, t in a.items():
        d = (t.double() - b[k].double()).abs().max().item()
        if d:
            out[k] = d
    return out


def _snapshot(net):
    return {k: t.detach().clone() for k, t in net.collect_params().items()}


def _parity_case(make, batches, legacy):
    """Three nets from ``make()`` (the same seeded weights): one trained
    by its fused executor (replays), two by ``legacy(net, trainer, x,
    y)`` (the eager steps).  → the replay's losses and weights against
    the first eager run, and the two eager runs against each other (the
    spread the replay is gated at where it is not bitwise)."""
    import torch
    runs = []
    for i in range(3):
        net, trainer, loss_fn = make()
        if i == 0:
            ex = trainer.fuse_step(loss_fn)
            losses = [ex(x, y) for x, y in batches]
        else:
            losses = [legacy(net, trainer, loss_fn, x, y)
                      for x, y in batches]
        torch.cuda.synchronize()
        runs.append((torch.stack([v.reshape(()) for v in losses]),
                     _snapshot(net), ex if i == 0 else None))
    (lr_, wr, ex), (le, we, _), (le2, we2, _) = runs
    diff = _max_diff(wr, we)
    spread = _max_diff(we, we2)
    loss_d = (lr_.double() - le.double()).abs().max().item()
    loss_spread = (le.double() - le2.double()).abs().max().item()
    worst = max(diff.items(), key=lambda kv: kv[1]) if diff else None
    ok = loss_d <= loss_spread and all(
        d <= spread.get(k, 0.0) for k, d in diff.items())
    return {"bitwise": not diff and loss_d == 0.0,
            "loss_replay_vs_eager": loss_d, "loss_eager_spread": loss_spread,
            "params_differing": len(diff), "worst": worst,
            "eager_spread_params": len(spread),
            "fused": ex.fused, "programs": ex.programs,
            "replays": ex.replays, "ok": ok}


def _legacy_step(net, trainer, loss_fn, x, y):
    import torch
    from mxnet_tpu_torch import autograd
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))
    # BERT's token-type embedding takes no gradient without token types:
    # the legacy step skips it, the fused step gives it a zero gradient,
    # which leaves the weight as it is under Adam without wd
    trainer.step(int(x.shape[0]), ignore_stale_grad=True)
    return loss.detach().mean()


PARITY_OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2}),
    ("adamax", {}), ("nadam", {"learning_rate": 1e-2}),
    ("adagrad", {"wd": 1e-3}), ("adadelta", {}),
    ("adabelief", {"learning_rate": 1e-2}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_gradient": 0.5}),
    ("ftrl", {}), ("ftml", {}), ("lamb", {"wd": 1e-2}),
    ("lars", {"wd": 1e-3}), ("lans", {}), ("signum", {"wd_lh": 1e-3}),
    ("sgld", {"learning_rate": 1e-3}), ("dcasgd", {"momentum": 0.9}),
]


def _poly_lamb():
    """LAMB under a PolyScheduler: its lr moves on every replay."""
    from mxnet_tpu_torch import lr_scheduler as sched
    return {"lr_scheduler": sched.PolyScheduler(max_update=10, base_lr=0.02),
            "wd": 1e-2}


def phase_fused_parity(state):
    """Replay against the eager step on the card, from the same seeded
    weights and batches, cuDNN deterministic on both legs: ResNet-50 v1
    at batch 8 and Gluon BERT-base at 1 x 128 (full width, 3 steps),
    each of the 20 optimizer cases on a small Dense net (3 steps),
    ResNet-50 v2 at batch 8 (the standalone conv route), LAMB
    under a ``PolyScheduler``, SGD under
    ``CosineScheduler(warmup_steps=2)`` (the lr moves on every replay,
    one program), a Dense net with Dropout(0.5), an Adam run
    whose states ``load_states`` replaces between replays, two captures
    beside what breaks one in torch's default capture mode (a thread
    that synchronizes, a CUDAGraph collected mid-capture), and
    DenseNet-121 at batch 8, 64x64 (its 58 growth convs on the route).  Losses and
    weights are compared bit for bit; where they differ, the worst
    parameter is printed and the case is gated at the spread of two
    eager runs."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import lr_scheduler as sched
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon
    dev = torch.device("cuda")
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cases = {}
        rng = np.random.RandomState(SEED + 7)
        args = ic.parse_args(["--batch-size", "8", "--seed", str(SEED)])
        img = [tuple(torch.as_tensor(a, device=dev) for a in
                     ic.synthetic_batch(rng, 8, 224, 1000))
               for _ in range(3)]
        cases["resnet50_b8"] = _parity_case(lambda: ic.build(args, dev), img,
                                            _legacy_step)
        args_v2 = ic.parse_args(["--model", "resnet50_v2", "--batch-size",
                                 "8", "--seed", str(SEED)])
        cases["resnet50_v2_b8"] = _parity_case(
            lambda: ic.build(args_v2, dev), img, _legacy_step)

        def bert():
            net = bert_gluon.bert_12_768_12()
            net.initialize(ctx=dev, seed=SEED)
            net.hybridize()
            return (net, Trainer(net.collect_params(), "adam",
                                 {"learning_rate": 1e-4}),
                    SoftmaxCrossEntropyLoss())
        toks = [tuple(torch.as_tensor(rng.randint(0, 30522, (1, 128)),
                                      device=dev) for _ in range(2))
                for _ in range(3)]
        cases["bert_base_1x128"] = _parity_case(bert, toks, _legacy_step)

        small = [(torch.as_tensor(rng.randn(16, 32).astype(np.float32),
                                  device=dev),
                  torch.as_tensor(rng.randint(0, 10, (16,)), device=dev))
                 for _ in range(3)]

        def dense(opt, kw, dropout=0.0):
            def make():
                net = nn.HybridSequential()
                net.add(nn.Dense(64, activation="relu", in_units=32))
                if dropout:     # each net its own stream, seeded alike
                    net.add(nn.Dropout(dropout, generator=torch.Generator(
                        device=dev).manual_seed(SEED)))
                net.add(nn.Dense(10, in_units=64))
                net.initialize(ctx=dev, seed=SEED)
                net.hybridize()
                net.train()
                return (net, Trainer(net.collect_params(), opt, dict(kw)),
                        SoftmaxCrossEntropyLoss())
            return make
        for i, (opt, kw) in enumerate(PARITY_OPTIMIZERS):
            cases[f"dense_{i}_{opt}"] = _parity_case(dense(opt, kw), small,
                                                     _legacy_step)
        cases["lamb_poly"] = _parity_case(dense("lamb", _poly_lamb()),
                                          small, _legacy_step)
        cos = {"lr_scheduler": sched.CosineScheduler(
            max_update=6, base_lr=0.1, warmup_steps=2), "momentum": 0.9}
        r0 = _counter("fused.rebuilds")
        c = _parity_case(dense("sgd", cos), small * 2, _legacy_step)
        c["rebuilds"] = _counter("fused.rebuilds") - r0
        c["ok"] = c["ok"] and c["rebuilds"] == 0 and c["programs"] == 1
        cases["cosine_warmup2"] = c
        cases["dropout_0.5"] = _parity_case(dense("sgd", {}, 0.5), small,
                                            _legacy_step)
        cases["load_states"] = _resync_case(dense("adam", {}), small)
        cases["capture_beside_syncing_thread"] = _syncing_thread_case(
            dense, small)
        cases["capture_beside_dead_graph"] = _dead_graph_case(dense, small)
        cases["cast_after_capture"] = _cast_case(
            dense("sgd", {"momentum": 0.9}), small)
        args_dn = ic.parse_args(["--model", "densenet121", "--batch-size",
                                 "8", "--image-size", "64", "--seed",
                                 str(SEED)])
        rng_dn = np.random.RandomState(SEED + 16)
        dn = [tuple(torch.as_tensor(a, device=dev) for a in
                    ic.synthetic_batch(rng_dn, 8, 64, 1000))
              for _ in range(3)]
        cases["densenet121_b8"] = _parity_case(
            lambda: ic.build(args_dn, dev), dn, _legacy_step)
    finally:
        torch.backends.cudnn.deterministic = prev_det
    res = {"cases": cases,
           "bitwise": sorted(k for k, c in cases.items() if c["bitwise"]),
           "not_bitwise": sorted(k for k, c in cases.items()
                                 if not c["bitwise"]),
           "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                               "register_generator_state")}
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"replay disagrees with eager in {bad}: {res}")
    return res


def _counter(name):
    from mxnet_tpu_torch import telemetry
    return telemetry.raw_snapshot()["counters"].get(name, 0)


def _syncing_thread_case(dense, batches):
    """A capture beside a thread that synchronizes with the card
    throughout (in torch's default capture mode, any such call breaks
    the capture): SGD with momentum on the small Dense net, its replays
    bit for bit as its eager runs (``_parity_case``)."""
    import threading
    import torch
    stop, syncs = threading.Event(), [0]

    def sync_loop():
        z = torch.ones(4, device="cuda")
        while not stop.is_set():
            z.cpu()
            syncs[0] += 1
    t = threading.Thread(target=sync_loop, daemon=True)
    t.start()
    try:
        c = _parity_case(dense("sgd", {"momentum": 0.9}), batches,
                         _legacy_step)
    finally:
        stop.set()
        t.join(60)
    c["thread_syncs"] = syncs[0]
    c["ok"] = c["ok"] and syncs[0] > 0
    return c


def _dead_graph_case(dense, batches):
    """A capture whose forward leaves an earlier executor's CUDAGraph in
    a dead reference cycle and allocates past the collector's threshold
    (a CUDAGraph the collector frees during a capture breaks it): as
    :func:`_syncing_thread_case`, and the earlier graph taken."""
    import gc
    import torch
    from mxnet_tpu_torch.gluon import nn

    class LeavesDeadGraph(nn.HybridBlock):
        def __init__(self, victim):
            super().__init__()
            self.victim = victim

        def forward(self, x):
            if self.victim and torch.cuda.is_current_stream_capturing():
                cycle = [self.victim.pop()]
                cycle.append(cycle)
                del cycle
                _ = [[] for _ in range(4 * gc.get_threshold()[0])]
            return x

    net, trainer, loss_fn = dense("sgd", {})()
    ex = trainer.fuse_step(loss_fn)
    ex(*batches[0])
    victim = [ex]
    del ex, net, trainer, loss_fn

    def make():
        net, trainer, loss_fn = dense("sgd", {"momentum": 0.9})()
        net.add(LeavesDeadGraph(victim))
        return net, trainer, loss_fn
    c = _parity_case(make, batches, _legacy_step)
    c["victim_taken"] = not victim
    c["ok"] = c["ok"] and not victim
    return c


def _resync_case(make, batches):
    """Adam: two replays, ``save_states``, a third replay, then
    ``load_states`` (new state tensors, copied into the captured ones)
    and the weights of step 2 put back: the next replay must land where
    the third first did, bit for bit."""
    import torch
    from mxnet_tpu_torch.gluon import load_numpy
    net, trainer, loss_fn = make()
    ex = trainer.fuse_step(loss_fn)
    ex(*batches[0])
    ex(*batches[1])
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "fused_resync.states")
    trainer.save_states(path)
    w2 = {k: t.detach().cpu().numpy()
          for k, t in net.collect_params().items()}
    l3 = ex(*batches[2])
    w3 = _snapshot(net)
    trainer.load_states(path)
    load_numpy(net, w2)
    l3b = ex(*batches[2])
    torch.cuda.synchronize()
    diff = _max_diff(w3, _snapshot(net))
    return {"bitwise": not diff and bool(torch.equal(l3, l3b)),
            "params_differing": len(diff), "programs": ex.programs,
            "replays": ex.replays, "fused": ex.fused,
            "ok": not diff and bool(torch.equal(l3, l3b)) and
            ex.programs == 1}


# ------------------------------------------------------ ResNet v2 phases
V2_STEPS = 5
V2_CONVS = 13       # stride-1 3x3 convs of ResNet-50 v2: 3, 3, 5, 2 a stage
V2_WANT = {"conv3x3": 2 * V2_CONVS, "conv_wgrad": V2_CONVS, "conv_stats": 0,
           "bn_affine": 0, "conv_affine": 0}
V2_REF_TOL = 1e-3       # losses, parameters: of the largest magnitude
V2_REF_DEPTH = (1, 1, 1, 1)     # v2_train_reference's bottlenecks a stage
LOSS_CARD_TOL = 1e-5    # loss_metric: of the largest magnitude
METRIC_CARD_REL = 1e-6


def _v2_args(*extra):
    from mxnet_tpu_torch.examples import image_classification as ic
    return ic.parse_args(["--model", "resnet50_v2", "--seed", str(SEED)]
                         + list(extra))


def _v2_batches(args, dev, n):
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    rng = np.random.RandomState(SEED)
    return [tuple(torch.as_tensor(a, device=dev) for a in
                  ic.synthetic_batch(rng, args.batch_size, args.image_size,
                                     args.classes))
            for _ in range(n)]


def _eligible_conv_shapes(net, x):
    """(x shape, w shape) of every conv the standalone route takes in one
    inference forward of ``net`` on ``x``."""
    import torch
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.ops import pallas_conv
    shapes = []

    def hook(m, i, o):
        if pallas_conv.eligible(i[0].shape, m.weight.shape, m._strides,
                                m._padding, m._dilation, m._groups,
                                i[0].dtype):
            shapes.append((tuple(i[0].shape), tuple(m.weight.shape)))
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, gnn.Conv2D)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def _cudnn_convs(shapes, dev):
    """A function running the convs of ``shapes`` forward and backward
    (dx and dW) through cuDNN, as the route's kernels run them."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ops = []
    for xs, ws in shapes:
        x = torch.randn(xs, device=dev, generator=gen).permute(0, 3, 1, 2)
        w = torch.randn(ws, device=dev, generator=gen).permute(3, 2, 0, 1)
        x.requires_grad_()
        w.requires_grad_()
        g = torch.randn((xs[0], ws[3], xs[1], xs[2]), device=dev,
                        generator=gen).contiguous(
            memory_format=torch.channels_last)
        ops.append((x, w, g))

    def run():
        for x, w, g in ops:
            y = F.conv2d(x, w, padding=1)
            torch.autograd.grad(y, (x, w), g)
    return run


def phase_v2_train(state):
    """ResNet-50 v2 training on the Gluon surface (see the docstring's
    item 34)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.gluon import metric
    from mxnet_tpu_torch.parallel import train as pt
    dev = torch.device("cuda")
    mx.context.exact_fp32()
    mx.seed(SEED)
    args = _v2_args()
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                            base_lr=args.lr)
    net, trainer, loss_fn = ic.build(args, dev, lr_scheduler=sched)
    batches = _v2_batches(args, dev, V2_STEPS)
    comp = metric.CompositeEvalMetric([metric.Accuracy(),
                                       metric.TopKAccuracy(5),
                                       metric.CrossEntropy(),
                                       metric.Loss()])
    counted = pt.kernel_wrappers()
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs, marks = [], [], []
    for x, y in batches:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        loss, out = ic.train_step(net, trainer, loss_fn, x, y)
        probs = torch.softmax(out, dim=-1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            comp.update([y], [probs])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(loss)
        lrs.append(trainer.learning_rate)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches for n, fn in counted.items()
                if fn.launches or n in V2_WANT}
    state["v2_launches"] = launches
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    loss_means = [float(v.mean()) for v in losses]
    names, values = comp.get()
    got = dict(zip(names, values))
    mean_loss = sum(float(v.sum()) for v in losses) / \
        sum(v.numel() for v in losses)
    want = {n: c * V2_STEPS for n, c in V2_WANT.items()}
    want_lrs = [sched(i + 1) for i in range(V2_STEPS)]
    res = {"args": vars(args), "steps": V2_STEPS, "losses": loss_means,
           "lrs": lrs, "lrs_expected": want_lrs, "step_ms": step_ms,
           "step_ms_median_last4": med,
           "images_s": args.batch_size / med * 1e3,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "launches_expected": want,
           "metrics": got, "metric_sync_debug_mode": "error",
           "mean_loss": mean_loss,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    if not all(math.isfinite(v) for v in loss_means):
        raise AssertionError(f"non-finite loss: {res}")
    if {n: launches.get(n, 0) for n in want} != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    if lrs != want_lrs:
        raise AssertionError(f"the lr schedule was not followed: {res}")
    ce = got["cross-entropy"]
    if abs(ce - mean_loss) > 1e-4 * abs(mean_loss):
        raise AssertionError(f"CrossEntropy metric != mean loss: {res}")
    if abs(got["loss"] - 1e-3) > 1e-5 * 1e-3:
        raise AssertionError(f"Loss metric != mean probability: {res}")
    # where the time goes: one more step under the profiler, then the
    # same convs through cuDNN (the device time the route replaced)
    x, y = batches[0]
    res["profile"] = _profile(
        lambda: ic.train_step(net, trainer, loss_fn, x, y), 1, top=10)
    busy = res["profile"].get("device_busy_us_per_call")
    if busy is not None:
        res["profile"]["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (med * 1e3)
    shapes = _eligible_conv_shapes(net, x)
    cats = res["profile"].get("by_category", {})
    ours = {k: cats[k]["us_per_call"] for k in
            ("conv3x3 / dgrad (ours)", "conv_wgrad (ours)") if k in cats}
    cudnn = _profile(_cudnn_convs(shapes, dev), 1, top=4)
    res["route_vs_cudnn"] = {
        "convs": len(shapes), "shapes": shapes, "ours_us": ours,
        "ours_us_total": sum(ours.values()),
        "cudnn_busy_us": cudnn.get("device_busy_us_per_call"),
        "cudnn_by_category": cudnn.get("by_category")}
    if len(shapes) != V2_CONVS:
        raise AssertionError(f"{len(shapes)} convs on the route: {res}")
    return res


def _v2_side(args, dev, params_path, x, y, dtype=None):
    """One step of ResNet-50 v2 on ``dev`` (in ``dtype`` if given) from
    the ``.params`` file: (per-sample loss, {name: value after}) on the
    CPU in float64."""
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    device = torch.device(dev)
    net, trainer, loss_fn = ic.build(args, device)
    net.load_parameters(params_path, ctx=device)
    if dtype is not None:
        net.to(dtype)
        x = x.to(dtype)
    loss, _ = ic.train_step(net, trainer, loss_fn, x.to(device),
                            y.to(device))
    return (loss.double().cpu(),
            {k: t.detach().double().cpu()
             for k, t in net.collect_params().items()})


def _v2_errs(a, b):
    """(largest |loss a − loss b| over the largest |loss b|, {name:
    largest |a − b|} over the parameters and running statistics)."""
    (la, pa), (lb, pb) = a, b
    return (((la - lb).abs().max() / lb.abs().max()).item(),
            {k: (pa[k] - pb[k]).abs().max().item() for k in pb})


@contextlib.contextmanager
def _resnet50_depth(layers):
    """ResNet-50's stage widths at ``layers`` bottlenecks a stage for the
    nets built inside (the model zoo's own spec table, put back after).
    Keep the context to the build and use of those nets: a net built
    inside keeps the cut depth, so none may escape it, and nothing else
    may build or read ResNet-50's spec while it is open."""
    from mxnet_tpu_torch.models import resnet
    kind, full, widths = resnet._SPECS[50]
    resnet._SPECS[50] = (kind, list(layers), widths)
    try:
        yield
    finally:
        resnet._SPECS[50] = (kind, full, widths)


def phase_v2_train_reference(state):
    """One ResNet-50 v2 step at batch 64 on the card and on the CPU from
    the same weights and batch, and on the CPU in float64 (the
    docstring's item 35), at ResNet-50 v2's widths and ``V2_REF_DEPTH``
    bottlenecks a stage (the CPU's float64 step at full depth took 95 s
    of the script).  Gates: the per-sample losses within 1e-3 of
    the largest; each parameter and running statistic within 1e-3 of the
    largest magnitude in the net, or, where the CPU's own float32 step
    lies farther than that from the float64 step, the card's step no
    farther from the float64 step than twice the CPU's float32 step."""
    import torch
    args = _v2_args()
    (x, y), = _v2_batches(args, torch.device("cuda"), 1)
    with _resnet50_depth(V2_REF_DEPTH):
        res = _step_reference(args, x, y, V2_REF_TOL, "resnet50_v2.params")
    res["bottlenecks_a_stage"] = list(V2_REF_DEPTH)
    return res


def _step_reference(args, x, y, loss_tol, fname):
    """One training step of ``args.model`` (``ic.build``'s seeded weights,
    saved to ``fname`` and loaded by each side) on the card, on the CPU
    and on the CPU in float64, from the batch ``x``, ``y``; gated as
    ``phase_v2_train_reference`` says, the losses within ``loss_tol``."""
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda")
    net, _, _ = ic.build(args, dev)
    net.eval()
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3, device=dev))
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, fname)
    net.save_parameters(path)
    before = {k: t.detach().double().cpu()
              for k, t in net.collect_params().items()}
    t0 = time.perf_counter()
    card = _v2_side(args, "cuda", path, x, y)
    cpu = _v2_side(args, "cpu", path, x.cpu(), y.cpu())
    cpu64 = _v2_side(args, "cpu", path, x.cpu(), y.cpu(), torch.float64)
    secs = time.perf_counter() - t0
    big = max(t.abs().max().item() for t in cpu64[1].values())
    upd = max((cpu64[1][k] - before[k]).abs().max().item()
              for k in before if "running_" not in k)
    loss_cc, e_cc = _v2_errs(card, cpu)
    loss_c64, e_c64 = _v2_errs(card, cpu64)
    loss_h64, e_h64 = _v2_errs(cpu, cpu64)
    tol = V2_REF_TOL * big
    floor = {k: {"card_vs_cpu": e_cc[k] / big,
                 "card_vs_cpu64": e_c64[k] / big,
                 "cpu_vs_cpu64": e_h64[k] / big}
             for k in e_h64 if e_h64[k] > tol}
    bad = [k for k in e_cc
           if e_cc[k] > tol and not (k in floor
                                     and e_c64[k] <= 2 * e_h64[k])]

    def worst(e):
        k = max(e, key=e.get)
        return {"param": k, "rel_to_max": e[k] / big,
                "rel_to_max_update": e[k] / upd}
    res = {"model": args.model,
           "batch": list(x.shape),
           "loss_card_mean": card[0].mean().item(),
           "loss_cpu_mean": cpu[0].mean().item(),
           "loss_rel_to_max": {"card_vs_cpu": loss_cc,
                               "card_vs_cpu64": loss_c64,
                               "cpu_vs_cpu64": loss_h64},
           "card_vs_cpu": worst(e_cc), "card_vs_cpu64": worst(e_c64),
           "cpu_vs_cpu64": worst(e_h64), "largest_param": big,
           "largest_update": upd, "above_tol_in_cpu_fp32": floor,
           "params": len(e_cc), "same_params": sorted(card[1]) ==
           sorted(cpu[1]), "three_sides_s": secs, "tol": V2_REF_TOL,
           "loss_tol": loss_tol, "failing": bad}
    if bad or not res["same_params"] or loss_cc > loss_tol:
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


LOSS_CASES = [
    ("HuberLoss", {"rho": 0.7}, "regression"),
    ("HingeLoss", {}, "signed"), ("SquaredHingeLoss", {}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("SigmoidBCELoss", {}, "soft"),
    ("SigmoidBCELoss", {"from_sigmoid": True}, "prob"),
    ("KLDivLoss", {}, "logp"), ("KLDivLoss", {"from_logits": False}, "soft"),
    ("TripletLoss", {"margin": 0.5}, "triplet"),
    ("CosineEmbeddingLoss", {}, "cosine"),
    ("PoissonNLLLoss", {}, "counts"),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "rates"),
    ("SDMLLoss", {}, "regression"),
]


def _loss_inputs(kind, gen, shape):
    """The loss's inputs on the CPU: the differentiable first, then the
    others."""
    import torch
    p = torch.randn(shape, generator=gen)
    q = torch.randn(shape, generator=gen)
    u = torch.rand(shape, generator=gen)
    sign = torch.where(u < 0.5, -1.0, 1.0)
    return {"regression": [p, q], "signed": [p, sign],
            "binary": [p, (sign > 0).float()], "soft": [p, u],
            "prob": [u * 0.9 + 0.05, torch.rand(shape, generator=gen)],
            "logp": [torch.log_softmax(p, -1), torch.softmax(q, -1)],
            "triplet": [p, q, torch.randn(shape, generator=gen)],
            "cosine": [p, q, sign[:, 0]],
            "counts": [p, torch.floor(u * 6)],
            "rates": [u * 3.5 + 0.5, torch.floor(
                torch.rand(shape, generator=gen) * 6)]}[kind]


def _card_vs_cpu(fn, args):
    """``fn`` on the CPU and on the card from the same inputs: → (largest
    |card − CPU| of the value and of the first input's gradient, each
    over its largest magnitude)."""
    import torch
    outs = []
    for dev in ("cpu", "cuda"):
        xs = [a.to(dev) for a in args]
        first = xs[0].clone().requires_grad_()
        out = fn(first, *xs[1:])
        g = torch.linspace(-1, 1, out.numel(), device=dev).reshape(
            out.shape)
        out.backward(g)
        outs.append((out.detach().cpu(), first.grad.cpu()))
    (oc, gc), (ok, gk) = outs
    return (_rel(ok, oc), _rel(gk, gc))


def phase_loss_metric(state):
    """The Gluon losses, ``pick`` and the metrics on the card against the
    CPU (the docstring's item 36)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import metric
    from mxnet_tpu_torch.ops import nn as onn
    gen = torch.Generator().manual_seed(SEED)
    shape = (64, 1000)
    losses = {}
    for name, kw, kind in LOSS_CASES:
        key = name + "".join(f"-{k}={v}" for k, v in kw.items())
        val, grad = _card_vs_cpu(getattr(gloss, name)(**kw),
                                 _loss_inputs(kind, gen, shape))
        losses[key] = {"value_rel": val, "grad_rel": grad}
    x = torch.arange(28, dtype=torch.float32).reshape(4, 7)
    idx = torch.tensor([0, 6, 7, -1], dtype=torch.int32)
    pick_card = onn.pick(x.cuda(), idx.cuda())
    ce_card = gloss.SoftmaxCrossEntropyLoss()(
        (x / 10).cuda(), torch.tensor([0, 6, 3, -1], device="cuda"))
    far = onn.pick(x.cuda(), torch.tensor([100, -100, 3, -7],
                                          device="cuda"))
    torch.cuda.synchronize()        # a device assert would surface here
    pick = {"pick": pick_card.cpu().tolist(),
            "pick_far": far.cpu().tolist(),
            "softmax_ce": ce_card.cpu().tolist(),
            "pick_equal_cpu": torch.equal(
                pick_card.cpu().nan_to_num(-1.0),
                onn.pick(x, idx).nan_to_num(-1.0)),
            "softmax_ce_cpu": gloss.SoftmaxCrossEntropyLoss()(
                x / 10, torch.tensor([0, 6, 3, -1])).tolist()}
    rng = np.random.RandomState(SEED + 9)
    p = rng.rand(64, 1000).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    lab = rng.randint(0, 1000, (64,))
    reg = (rng.randn(64, 8).astype(np.float32),
           rng.randn(64, 8).astype(np.float32))
    binary = (rng.randint(0, 2, (64,)), rng.rand(64, 2).astype(np.float32))
    feeds = {"class": (lab, p), "regression": reg, "binary": binary,
             "loss": (None, rng.rand(64).astype(np.float32)),
             "score": (binary[0], rng.rand(64).astype(np.float32))}
    cases = [("Accuracy", "class"), ("TopKAccuracy", "class"),
             ("CrossEntropy", "class"), ("Perplexity", "class"),
             ("NegativeLogLikelihood", "class"), ("MAE", "regression"),
             ("MSE", "regression"), ("RMSE", "regression"),
             ("MeanPairwiseDistance", "regression"),
             ("MeanCosineSimilarity", "regression"),
             ("PearsonCorrelation", "regression"), ("F1", "binary"),
             ("Fbeta", "binary"), ("MCC", "binary"), ("Loss", "loss"),
             ("BinaryAccuracy", "score")]
    metrics = {}
    for name, kind in cases:
        l, pr = feeds[kind]
        kw = {"top_k": 5} if name == "TopKAccuracy" else {}
        ms = []
        for dev in ("cpu", "cuda"):
            m = getattr(metric, name)(**kw)
            for _ in range(2):
                m.update(None if l is None else
                         torch.as_tensor(l, device=dev),
                         torch.as_tensor(pr, device=dev))
            ms.append(m)
        (nh, vh), (nc, vc) = ms[0].get(), ms[1].get()
        metrics[name] = {"cpu": vh, "card": vc,
                         "num_inst_equal": ms[0].num_inst == ms[1].num_inst,
                         "ok": nh == nc and ms[0].num_inst == ms[1].num_inst
                         and abs(vc - vh) <= METRIC_CARD_REL * abs(vh)}
        if hasattr(ms[0], "confusion"):
            metrics[name]["ok"] &= ms[0].confusion() == ms[1].confusion()
    res = {"shape": list(shape), "losses": losses, "pick": pick,
           "metrics": metrics, "tol": {"loss": LOSS_CARD_TOL,
                                       "metric_rel": METRIC_CARD_REL}}
    bad = [k for k, v in losses.items()
           if not (v["value_rel"] <= LOSS_CARD_TOL
                   and v["grad_rel"] <= LOSS_CARD_TOL)]
    bad += [k for k, v in metrics.items() if not v["ok"]]
    if not (pick["pick_equal_cpu"] and math.isnan(pick["pick"][2])
            and pick["pick"][3] == 27.0 and all(
                math.isnan(v) for v in pick["pick_far"][:2])
            and np.allclose(pick["softmax_ce"], pick["softmax_ce_cpu"],
                            rtol=1e-6)):
        bad.append("pick")
    if bad:
        raise AssertionError(f"card disagrees with the CPU in {bad}: {res}")
    return res


# ------------------------------------------------------- model-zoo phases
# (input item, row-7 launches a forward): the 3x3/s1/p1 fp32 convs each
# net sends to the standalone conv route (``ops/pallas_conv.py``)
ZOO_FORWARD = {
    "inceptionv3": ((299, 299, 3), 10),
    "alexnet": ((224, 224, 3), 3),
    "vgg16": ((224, 224, 3), 13),
    "vgg16_bn": ((224, 224, 3), 13),
    "squeezenet1.0": ((224, 224, 3), 8),
    "squeezenet1.1": ((224, 224, 3), 8),
    "mobilenet1.0": ((224, 224, 3), 0),
    "mobilenetv2_1.0": ((224, 224, 3), 0),
    "lenet": ((28, 28, 1), 0),
}
ZOO_BATCH = 32              # bench.py's inception row: batch 32 at 299²
ZOO_SCORE_WARMUP = 3
ZOO_SCORE_ITERS = 10
ZOO_REF_TOL = 1e-4          # logits, card vs CPU: of the largest logit
DENSENET_CONVS = 58         # DenseNet-121's 3x3 growth convs
ZOO_TRAIN_ITERS = 3         # + image_classification's 2 warm-up steps
ZOO_TRAIN_IMAGE = 64        # zoo_train_reference's reduced image size
ZOO_TRAIN_LOSS_RTOL = 1e-5


def _zoo_counters():
    """Every kernel wrapper's launch count, set to 0."""
    from mxnet_tpu_torch.parallel import train as pt
    counted = pt.kernel_wrappers()
    for fn in counted.values():
        fn.launches = 0
    return counted


def _moved(counted):
    return {n: fn.launches for n, fn in counted.items() if fn.launches}


def phase_zoo_kernels(state):
    """Row 7 (``conv3x3``) at the zoo's shapes, and row 11
    (``conv_wgrad``) at DenseNet's (the docstring's item 37)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def fwd(N, H, W, C, Cout, net):
        x = torch.randn(N, H, W, C, device="cuda", generator=gen)
        w = torch.randn(3, 3, C, Cout, device="cuda", generator=gen) * \
            (2.0 / (9 * C)) ** 0.5
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return dict(_conv3x3_fwd_case(x, w, x.permute(0, 3, 1, 2), wc),
                    net=net)
    fwd_cases = [fwd(32, 224, 224, 3, 64, "vgg16 stem (vec = 0)"),
                 fwd(64, 56, 56, 128, 32, "densenet121 growth conv"),
                 fwd(32, 35, 35, 64, 96, "inceptionv3 A/B"),
                 fwd(32, 35, 35, 96, 96, "inceptionv3 A"),
                 fwd(32, 8, 8, 448, 384, "inceptionv3 E"),
                 fwd(32, 147, 147, 32, 64, "inceptionv3 stem"),
                 fwd(32, 54, 54, 16, 64, "squeezenet1.0 fire e3")]
    dn = _train_conv_cases(64, 56, 56, 128, 32, gen, dgrad_only=True)
    for c in dn.values():
        c["net"] = "densenet121 growth conv"
    cases = {"conv3x3": fwd_cases + [dn["conv3x3_dgrad"]],
             "conv_wgrad": [dn["conv_wgrad"]]}
    for n, cs in cases.items():
        state["cases"].setdefault(n, []).extend(cs)
    bad = [(n, c) for n, cs in cases.items() for c in cs
           if not _train_ok(n, c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, cases["conv3x3"] + cases["conv_wgrad"])
    slower = [{"shape": c["shape"], "use": c["use"], "net": c["net"],
               "kernel_ms": c["kernel_ms"], "library_ms": c["library_ms"],
               "vs_library": c["vs_library"]}
              for cs in cases.values() for c in cs if c["vs_library"] > 1]
    return {"cases": cases, "mma_tf32_ceiling": ceiling,
            "slower_than_library": slower}


def phase_zoo_serve(state):
    """Inception-v3 scoring at batch 32 × 299², then serving through
    ``ModelRegistry`` at buckets (1, 8) (the docstring's item 38)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.serve import ModelRegistry
    mx.context.exact_fp32()
    item, per_fwd = ZOO_FORWARD["inceptionv3"]
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "inceptionv3.params")
    t0 = time.perf_counter()
    _seeded_net("inceptionv3", (75, 75, 3)).save_parameters(path)
    init_s = time.perf_counter() - t0

    counted = _zoo_counters()
    torch.cuda.reset_peak_memory_stats()
    net = get_model("inceptionv3", classes=1000)
    net.load_parameters(path, ctx="cuda")
    net.hybridize()
    net.eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    xs = [torch.rand((ZOO_BATCH,) + item, device="cuda", generator=gen)
          for _ in range(ZOO_SCORE_WARMUP + ZOO_SCORE_ITERS)]
    with torch.inference_mode():
        for x in xs[:ZOO_SCORE_WARMUP]:
            out = net(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in xs[ZOO_SCORE_WARMUP:]:
            out = net(x)
        end.record()
        end.synchronize()
        finite = bool(torch.isfinite(out).all())
        ms = start.elapsed_time(end) / ZOO_SCORE_ITERS
        score_fwds = ZOO_SCORE_WARMUP + ZOO_SCORE_ITERS
        score_launches = _moved(counted)
        x = xs[0]
        device_ms = cuda_ms(lambda: net(x), iters=2, repeats=5)
        eager = eager_ms(lambda: net(x), iters=5)
        profile = _profile(lambda: net(x), 2, top=8)
    score = {"batch": ZOO_BATCH, "image": list(item),
             "warmup": ZOO_SCORE_WARMUP, "iters": ZOO_SCORE_ITERS,
             "ms_per_batch": ms, "images_s": ZOO_BATCH / (ms * 1e-3),
             "device_ms_per_forward": device_ms,
             "eager_ms_per_forward": eager,
             "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "launches": score_launches, "forwards": score_fwds,
             "profile": profile}
    del xs, net
    torch.cuda.empty_cache()

    rs = np.random.RandomState(SEED + 13)
    images = rs.rand(64, *item).astype(np.float32)
    counted = _zoo_counters()
    telemetry.reset()
    torch.cuda.reset_peak_memory_stats()
    reg = ModelRegistry(buckets=(1, 8))
    t0 = time.perf_counter()
    entry = reg.load("inceptionv3", path, arch="inceptionv3",
                     item_shape=item)
    load_s = time.perf_counter() - t0
    lat, outs = [], []
    for i in range(32):
        t1 = time.perf_counter()
        outs.append(reg.predict("inceptionv3", images[i])[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    got, errs = {}, []

    def client(c):
        try:
            for j in range(8):
                k = 8 * c + j
                got[k] = reg.predict("inceptionv3", images[k],
                                     timeout=300)[0]
        except Exception as e:
            errs.append(repr(e))
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    eng = entry.engine
    forwards = eng.forwards
    launches = _moved(counted)
    state.update(zoo_params=path, zoo_images=images, zoo_engine=eng,
                 zoo_registry=reg, zoo_batched=got)
    state["zoo_launches"] = {n: score_launches.get(n, 0) + launches.get(n, 0)
                             for n in set(score_launches) | set(launches)}
    per_bucket = {}
    for b in eng.buckets:
        xb = torch.as_tensor(images[:b], device="cuda")
        per_bucket[b] = {
            "device_ms": cuda_ms(lambda: eng.run(xb), iters=2, repeats=5),
            "eager_ms": eager_ms(lambda: eng.run(xb), iters=5)}
    x1 = torch.as_tensor(images[:1], device="cuda")
    profile1 = _profile(lambda: eng.run(x1), 2, top=6)
    h = snap["histograms"].get("serve.batch_fill", {})
    res = {"model": "inceptionv3", "classes": 1000, "init_s": init_s,
           "score": score, "buckets": list(eng.buckets),
           "load_and_warmup_s": load_s,
           "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                           "p99_ms": _pct(lat, 99),
                           "mean_ms": sum(lat) / len(lat),
                           "first_ms": lat[0], "max_ms": max(lat)},
           "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                          "images_s": 64 / conc_s,
                          "p50_ms_not_measured": "per-request latency is "
                          "timed in the closed loop only",
                          "batches": snap["counters"].get("serve.batches",
                                                          0),
                          "mean_batch_fill": h.get("sum", 0) /
                          max(1, h.get("count", 0))},
           "per_bucket": per_bucket, "bucket1_profile": profile1,
           "launches": {"serving": launches, "engine_forwards": forwards,
                        "conv3x3_per_forward": launches.get("conv3x3", 0) /
                        forwards},
           "peak_mem_bytes_serving": torch.cuda.max_memory_allocated()}
    want_score = {"conv3x3": per_fwd * score_fwds}
    want = {"conv3x3": per_fwd * forwards}
    if errs or len(got) != 64:
        raise AssertionError(f"concurrent requests failed: {errs}")
    bad = [o for o in outs + list(got.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad or not finite:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if score_launches != want_score or launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    return res


def phase_zoo_reference(state):
    """Card logits against the port on the CPU for Inception-v3 and each
    forward-only family, each family's row-7 launches a forward, and the
    batched Inception responses against their unbatched forwards (the
    docstring's item 39)."""
    import copy
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    mx.context.exact_fp32()
    torch.set_num_threads(os.cpu_count() or 1)
    rs = np.random.RandomState(SEED + 14)
    fams = {}
    for arch, (item, per_fwd) in ZOO_FORWARD.items():
        cpu_net = _seeded_net(arch, item)
        card_net = copy.deepcopy(cpu_net).to("cuda")
        x = rs.rand(2, *item).astype(np.float32)
        counted = _zoo_counters()
        with torch.inference_mode():
            card = card_net(torch.as_tensor(x, device="cuda")).cpu().numpy()
            moved = _moved(counted)
            cpu = cpu_net(torch.from_numpy(x)).numpy()
        err = float(np.abs(card - cpu).max())
        scale = float(np.abs(cpu).max())
        fams[arch] = {"input": [2, *item], "max_abs_diff": err,
                      "max_abs": scale, "rel": err / scale,
                      "top1_equal": bool((card.argmax(-1) ==
                                          cpu.argmax(-1)).all()),
                      "finite": bool(np.isfinite(card).all()),
                      "launches": moved,
                      "launches_expected": {"conv3x3": per_fwd}
                      if per_fwd else {}}
        del card_net, cpu_net
    torch.cuda.empty_cache()
    eng, images = state["zoo_engine"], state["zoo_images"]
    bat_err, bat_scale, bitwise = 0.0, 0.0, 0
    for k, out in state["zoo_batched"].items():
        one = eng.run(images[k:k + 1])[0].cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_scale = max(bat_scale, float(np.abs(one).max()))
        bitwise += int(np.array_equal(out, one))
    state["zoo_registry"].close()
    res = {"families": fams, "tol": ZOO_REF_TOL,
           "batched_vs_unbatched_max_abs_diff": bat_err,
           "batched_max_abs": bat_scale,
           "batched_bitwise_equal": bitwise,
           "batched_responses": len(state["zoo_batched"])}
    bad = [a for a, f in fams.items()
           if not (f["rel"] <= ZOO_REF_TOL and f["top1_equal"] and
                   f["finite"] and f["launches"] == f["launches_expected"])]
    if bad or bat_err > ZOO_REF_TOL * bat_scale:
        raise AssertionError(f"card disagrees in {bad}: {res}")
    return res


def phase_zoo_train(state):
    """DenseNet-121 training through ``examples.image_classification``
    at its defaults (the docstring's item 40)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    argv = ["--model", "densenet121", "--iters", str(ZOO_TRAIN_ITERS),
            "--seed", str(SEED)]
    counted = _zoo_counters()
    torch.cuda.reset_peak_memory_stats()
    out = ic.main(argv)
    launches = _moved(counted)
    peak = torch.cuda.max_memory_allocated()
    steps = out["steps"]
    state["zoo_launches"] = {n: state.get("zoo_launches", {}).get(n, 0)
                             + launches.get(n, 0)
                             for n in set(launches) |
                             set(state.get("zoo_launches", {}))}
    args = ic.parse_args(argv)
    last = sorted(out["step_ms"][1:])
    med = last[len(last) // 2]
    want = {"conv3x3": 2 * DENSENET_CONVS * steps,
            "conv_wgrad": DENSENET_CONVS * steps}
    res = {"args": vars(args), "steps": steps, "losses": out["losses"],
           "step_ms": out["step_ms"], "step_ms_median_last4": med,
           "images_s": args.batch_size / med * 1e3,
           "images_s_example": out["img_s"], "peak_mem_bytes": peak,
           "launches": launches, "launches_expected": want,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    if not all(math.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"non-finite loss: {res}")
    if launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    # where a step's time goes: the same step on a fresh net under the
    # profiler
    dev = torch.device("cuda")
    net, trainer, loss_fn = ic.build(args, dev)
    x, y = (torch.as_tensor(a, device=dev) for a in ic.synthetic_batch(
        np.random.RandomState(SEED), args.batch_size, args.image_size,
        args.classes))
    ic.train_step(net, trainer, loss_fn, x, y)
    res["profile"] = _profile(
        lambda: ic.train_step(net, trainer, loss_fn, x, y), 1, top=10)
    busy = res["profile"].get("device_busy_us_per_call")
    if busy is not None:
        res["profile"]["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (med * 1e3)
    del net, trainer
    torch.cuda.empty_cache()
    return res


def phase_zoo_train_reference(state):
    """One DenseNet-121 step at batch 2, 64x64, on the card, on the CPU
    and on the CPU in float64 (the docstring's item 41)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(["--model", "densenet121", "--batch-size", "2",
                          "--image-size", str(ZOO_TRAIN_IMAGE), "--seed",
                          str(SEED)])
    rng = np.random.RandomState(SEED + 15)
    x, y = (torch.as_tensor(a) for a in ic.synthetic_batch(
        rng, 2, ZOO_TRAIN_IMAGE, args.classes))
    return _step_reference(args, x.cuda(), y.cuda(), ZOO_TRAIN_LOSS_RTOL,
                           "densenet121.params")


# ------------------------------------------------------------------ main
# ----------------------------------------------------- bf16 serving phases
PEAK_BF16_FLOP_S = 989e12       # H100 SXM dense bf16 on the tensor cores
HALF_STEPS = 1                  # a kernel's value from its plain version's
BF16_NEAR_ZERO = 1e-5           # conv_affine bf16: of the largest output
BERT_SOFTMAX_HALF = 12          # half softmax launches a BERT-base forward


def _steps(a, b):
    """Distance of two non-negative half tensors (bf16 or fp16) in steps
    of their own size: the difference of their bit patterns."""
    import torch
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _nudged(s, k):
    """The positive half tensor ``s`` moved ``k`` steps."""
    import torch
    return (s.view(torch.int16) + k).view(s.dtype)


def _half_softmax_case(rows, cols, dtype, gen, div=None, keep_rows=None):
    """``softmax_fused``'s bf16 or fp16 instance against its plain version
    on the card (the reference's roundings, ``cuda_kernels
    .softmax_plain``), launched twice (the outputs must be bitwise equal),
    timed beside its bound (2 bytes an element each way, plus the mask's),
    its plain version and ``torch.softmax`` on the prologue's result in
    the dtype (‡: it neither divides nor masks, and rounds once).  Each
    value must lie within one step of the plain numerator over the plain
    rounded sum, or over that sum moved one step either way: the two sum
    in fp32 in another order, which may move the rounding of a sum by one
    step.  ``div`` and ``keep_rows`` give the kernel its prologue: the
    divisor (rounded to the dtype) and a random keep mask of
    ``keep_rows`` rows."""
    import torch
    from mxnet_tpu_torch.ops.cuda_kernels import (softmax_fused,
                                                  softmax_plain,
                                                  softmax_prologue_plain)
    x = (torch.randn(rows, cols, device="cuda", generator=gen) * 4 *
         (div or 1.0)).to(dtype)
    keep = None
    if keep_rows:
        keep = torch.rand(keep_rows, cols, device="cuda",
                          generator=gen) > 0.25

    def fused():
        return softmax_fused(x, div=div, keep=keep)

    def plain():
        return softmax_plain(softmax_prologue_plain(x, div, keep))

    out, again, ref = fused(), fused(), plain()
    p = softmax_prologue_plain(x, div, keep)
    d = p - p.amax(-1, keepdim=True)
    if dtype == torch.bfloat16:
        e = torch.exp(d.float())
        num, s = e.to(dtype), e.sum(-1, keepdim=True).to(dtype)
    else:
        e = torch.exp(d)
        num, s = e, e.sum(-1, keepdim=True)
    steps = torch.stack([_steps(out, num / _nudged(s, k))
                         for k in (-1, 0, 1)]).amin(0)
    torch.cuda.synchronize()
    case = {"shape": [rows, cols], "dtype": str(dtype).rpartition(".")[2],
            "div": div, "keep_rows": keep_rows,
            "plan": _softmax_plan(cols, 8),
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "max_steps": steps.max().item(), "tol_steps": HALF_STEPS,
            "values_differing": int((out != ref).sum()),
            "values": out.numel(),
            "finite": bool(torch.isfinite(out).all()),
            "bitwise_equal_relaunch": torch.equal(out, again)}
    nbytes = 2 * 2 * rows * cols + (keep.numel() if keep_rows else 0)
    flops = (5 + (div is not None)) * rows * cols
    _timed(case, fused, plain, lambda: torch.softmax(p, -1), nbytes, flops)
    case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
    case["vs_library"] = case["kernel_ms"] / case["library_ms"]
    if div is not None or keep_rows:
        case["library_does_less"] = True
    return case


def _conv_bf16_cases(N, H, W, C, Cout, gen, residual=False, relu=True,
                     dtype=None, stats_fp32=False):
    """``conv_affine``'s bf16 kernels against their plain version (bf16
    widened to fp32, the conv in fp32 with TF32 off, the same fold, one
    rounding) at one shape, each launched twice on the same inputs
    (bitwise equal), with its plan, timed beside its bound (bf16
    operations over 989 TFLOP/s dense, or its bytes at 2 an element), its
    plain version and ``F.conv2d`` on the bf16 tensors alone (cuDNN,
    channels-last: no fold, residual or ReLU).  Where ``wgmma_takes`` the
    shape: the ``mma.sync`` instance launched directly, then the wrapper,
    which must launch the ``wgmma`` kernel, timed on the same inputs
    beside the former (``parent_ms``) with its main and reduce kernels'
    µs; elsewhere the wrapper, which must launch the ``mma.sync`` one.
    Each value within one bf16 step of the plain version's, or within
    1e-5 of the largest output where both lie near 0: the two sum the
    same exact products in fp32 in another order, so a value may round to
    the neighbouring bf16 value, and near 0 the sums' own rounding is all
    there is.  ``dtype`` fp16: the fp16 kernels, fp16's step;
    ``stats_fp32``: μ and σ² fp32 beside half γ and β, as a half training
    step's frozen segment passes them (the kernels read each vector in
    its own dtype)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    bf = dtype or torch.bfloat16
    h, e, dn = cb.HALF_NAMES[bf], cb._ENTRY[bf], str(bf)[6:]
    sd = torch.float32 if stats_fp32 else bf
    x = torch.randn(N, H, W, C, device="cuda", generator=gen).to(bf)
    w = (torch.randn(3, 3, C, Cout, device="cuda", generator=gen) *
         (2.0 / (9 * C)) ** 0.5).to(bf)
    g = (1 + 0.1 * torch.randn(Cout, device="cuda", generator=gen)).to(bf)
    b = (0.1 * torch.randn(Cout, device="cuda", generator=gen)).to(bf)
    mu = (0.1 * torch.randn(Cout, device="cuda", generator=gen)).to(sd)
    var = (0.5 + torch.rand(Cout, device="cuda", generator=gen)).to(sd)
    res = torch.randn(N, H, W, Cout, device="cuda",
                      generator=gen).to(bf) if residual else None
    args = (x, w, g, b, mu, var, res)
    ref = cb.conv_affine_plain(*args, relu=relu)
    xc = x.permute(0, 3, 1, 2)                      # channels-last view
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    npix = N * H * W
    nbytes = 2 * (npix * C + 9 * C * Cout + npix * Cout * (2 if residual
                                                           else 1)
                  + (6 if stats_fp32 else 4) * Cout)
    flops = 2 * npix * 9 * C * Cout
    shape = [N, H, W, C, Cout]
    library = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
    plain = lambda: cb.conv_affine_plain(*args, relu=relu)  # noqa: E731
    about = {"shape": shape, "dtype": dn, "residual": residual,
             "relu": relu, "stats": str(sd)[6:],
             "library": f"F.conv2d alone on {dn} (cuDNN, channels-last; no "
                        f"BN fold, residual or ReLU)"}
    wrapper = lambda: cb.conv_affine(*args, relu=relu)  # noqa: E731
    takes = cb.wgmma_takes(C, Cout, x, w, *([res] if residual else []))
    if takes:
        sync = lambda: cb._conv_affine_tc(  # noqa: E731
            x, w, (g, b, mu, var), res, 1e-5, relu,
            torch.empty(N, H, W, Cout, device="cuda", dtype=bf))
        out, via = sync(), {"launched": "directly"}
    else:
        sync = wrapper
        out, took = _instance_launches(cb.conv_affine, sync, h + "_mma_sync")
        via = {"launched": "by the wrapper", "instance_launched": took}
    cases = {f"conv_affine_{h}_mma_sync": _bf16_timed(
        {**about, "use": "the mma.sync instance", **via,
         "plan": _conv3x3_plan(npix, C, Cout,
                               f"mxt_conv_affine_{e}_blocks_per_sm", 8),
         **_bf16_within(out, ref),
         "bitwise_equal_relaunch": bool(torch.equal(out, sync()))},
        sync, plain, library, nbytes, flops)}
    if takes:
        out, took = _instance_launches(cb.conv_affine, wrapper, h + "_wgmma")
        case = _bf16_timed(
            {**about, "plan": _wgmma_plan(npix, C, Cout, op="conv_affine",
                                          dtype=bf),
             **_bf16_within(out, ref), "instance_launched": took,
             "bitwise_equal_relaunch": bool(torch.equal(out, wrapper()))},
            wrapper, plain, library, nbytes, flops)
        case.update(parent_ms=cuda_ms(sync, iters=10),
                    kernels_us=_kernel_us(wrapper))
        case["parent_over_kernel"] = case["parent_ms"] / case["kernel_ms"]
        cases[f"conv_affine_{h}_wgmma"] = case
    return cases


# the wgmma kernels' edges: one 128 x 64 tile; M, C and Cout off their
# tiles (189 pixels, a 40-channel slab, a 24-channel box); 64 < Cout < 128
# off a multiple of 64 (BN = 128, the second 64-column box partly past the
# channels: dW's and the conv's Cout = 96, the dgrad's output C = 72)
BF16_WGMMA_EDGES = [(1, 8, 16, 64, 64), (3, 7, 9, 40, 24),
                    (2, 11, 13, 72, 96)]
# row 8's bf16 cases: ResNet-50's four 3x3 stages at batch 8 (the path
# shape first), stage 1 at batch 64 and the wgmma kernels' edges, each
# without and with a residual; stage 1 with the ReLU off; a ragged shape
# (C = 20) that the wgmma kernel does not take
BF16_AFFINE_SHAPES = [(8, 56, 56, 64, 64), (8, 28, 28, 128, 128),
                      (8, 14, 14, 256, 256), (8, 7, 7, 512, 512),
                      (64, 56, 56, 64, 64)] + BF16_WGMMA_EDGES
BF16_AFFINE_CASES = ([(s, {}) for s in BF16_AFFINE_SHAPES] +
                     [(s, {"residual": True}) for s in BF16_AFFINE_SHAPES] +
                     [(BF16_AFFINE_SHAPES[0], {"relu": False}),
                      ((2, 9, 11, 20, 12), {"residual": True})])


def phase_bf16_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    bf, f16 = torch.bfloat16, torch.float16
    rows8 = 8 * 12 * TEXT_T
    # row 1's half instances: the path's call first (bucket 8 of the Gluon
    # BERT-base: the scores divided by sqrt(64), a (B, T) key mask), bucket
    # 1, the vocabulary rows (cluster kernel), a ragged width (the scalar
    # path) and rows past the cluster's reach (three passes); fp16 at the
    # three path shapes
    soft = [_half_softmax_case(rows8, TEXT_T, bf, gen, div=8.0,
                               keep_rows=8),
            _half_softmax_case(12 * TEXT_T, TEXT_T, bf, gen, div=8.0),
            _half_softmax_case(12 * TEXT_T, TEXT_T, bf, gen),
            _half_softmax_case(4096, 30522, bf, gen),
            _half_softmax_case(4096, 77, bf, gen),
            _half_softmax_case(256, 131072, bf, gen),
            _half_softmax_case(rows8, TEXT_T, f16, gen, div=8.0,
                               keep_rows=8),
            _half_softmax_case(12 * TEXT_T, TEXT_T, f16, gen),
            _half_softmax_case(4096, 30522, f16, gen)]
    conv = {"conv_affine_bf16_wgmma": [], "conv_affine_bf16_mma_sync": []}
    for shape, kw in BF16_AFFINE_CASES:
        for k, c in _conv_bf16_cases(*shape, gen, **kw).items():
            conv[k].append(c)
    ceiling = _wgmma_ceiling(state)
    for c in conv["conv_affine_bf16_wgmma"]:
        c["wgmma_ceiling_share"] = c["tflop_s"] / ceiling["tflop_s"]
    state["cases"]["softmax_fused_bf16"] = soft
    state["cases"].update(conv)
    bad = [c for c in soft if not (c["max_steps"] <= c["tol_steps"] and
                                   c["finite"] and
                                   c["bitwise_equal_relaunch"])]
    bad += [c for cs in conv.values() for c in cs if not _bf16_case_ok(c)]
    if len(conv["conv_affine_bf16_wgmma"]) != len(BF16_AFFINE_CASES) - 1 \
            or [c["launched"] for c in conv["conv_affine_bf16_mma_sync"]
                ].count("by the wrapper") != 1:
        bad.append("a shape did not reach the kernel its wrapper should "
                   "launch")
    if bad:
        raise AssertionError(f"half-precision kernel disagrees with its "
                             f"plain version: {bad}")
    stages = [{"shape": c["shape"], "residual": c["residual"],
               "relu": c["relu"], "ms": [c["parent_ms"], c["kernel_ms"]],
               "kernels_us": c["kernels_us"], "vs_library": c["vs_library"]}
              for c in conv["conv_affine_bf16_wgmma"]]
    return {"softmax": soft, "conv_affine": conv, "wgmma_ceiling": ceiling,
            "affine_parent_to_wgmma": stages}


def _zero_half_counts():
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused, softmax_fused
    conv_affine.launches = softmax_fused.launches = 0
    conv_affine.launches_by_instance = dict.fromkeys(
        conv_affine.launches_by_instance, 0)
    softmax_fused.launches_by_dtype = dict.fromkeys(
        softmax_fused.launches_by_dtype, 0)
    layernorm_fused.launches = 0


def _half_counts():
    """The serving kernels' launches: ``conv_affine`` by kernel
    (``conv_affine_bf16`` the sum of its two bf16 kernels), the softmax
    by dtype, LayerNorm."""
    import torch
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused, softmax_fused
    conv, soft = conv_affine.launches_by_instance, \
        softmax_fused.launches_by_dtype
    return {"conv_affine_bf16": conv["bf16_wgmma"] + conv["bf16_mma_sync"],
            "conv_affine_bf16_wgmma": conv["bf16_wgmma"],
            "conv_affine_bf16_mma_sync": conv["bf16_mma_sync"],
            "conv_affine_fp32": conv["fp32"],
            "softmax_fused_bf16": soft[torch.bfloat16],
            "softmax_fused_fp32": soft[torch.float32],
            "layernorm_fused": layernorm_fused.launches}


def _affine_path_ok(counts, forwards):
    """Exactly 16 ``conv_affine`` launches a bf16 ResNet-50 forward, all
    of them the ``wgmma`` kernel (none of the ``mma.sync`` or fp32 one)."""
    return counts["conv_affine_bf16_wgmma"] == RESNET50_SEGMENTS * forwards \
        and counts["conv_affine_bf16_mma_sync"] == 0 and \
        counts["conv_affine_fp32"] == 0


def _add_bf16_launches(state, counts):
    """Add a main-path run's bf16 launches to the ``kernels`` line's."""
    tot = state.setdefault("bf16_launches", {})
    for k in ("conv_affine_bf16_wgmma", "conv_affine_bf16_mma_sync",
              "softmax_fused_bf16"):
        tot[k] = tot.get(k, 0) + counts[k]


def _serve_traffic(reg, name, items, keep, offset):
    """32 closed-loop requests from one client (items 0-31), then 64 from
    8 client threads (items ``offset`` to ``offset + 63``, as the fp32
    serving phases send them); ``keep(k, out)`` gives what is kept of the
    response to item k.  → (closed-loop responses by item, concurrent
    responses by item, closed-loop stats, concurrent stats)."""
    from mxnet_tpu_torch import telemetry
    closed_kept, kept, lat, errs = {}, {}, [], []
    for k in range(32):
        t1 = time.perf_counter()
        closed_kept[k] = keep(k, reg.predict(name, items[k])[0])
        lat.append((time.perf_counter() - t1) * 1e3)

    def client(c):
        try:
            for j in range(8):
                k = offset + 8 * c + j
                kept[k] = keep(k, reg.predict(name, items[k],
                                              timeout=300)[0])
        except Exception as e:
            errs.append(repr(e))

    snap0 = telemetry.raw_snapshot()
    h0 = snap0["histograms"].get("serve.batch_fill", {})
    b0 = snap0["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    h1 = snap["histograms"].get("serve.batch_fill", {})
    if errs or len(kept) != 64:
        raise AssertionError(f"requests to {name} failed: {errs}")
    closed = {"requests": 32, "p50_ms": _pct(lat, 50),
              "p99_ms": _pct(lat, 99), "mean_ms": sum(lat) / len(lat),
              "first_ms": lat[0], "max_ms": max(lat),
              "items_s": 1e3 * len(lat) / sum(lat)}
    conc = {"clients": 8, "requests": 64, "seconds": conc_s,
            "items_s": 64 / conc_s,
            "batches": snap["counters"].get("serve.batches", 0) - b0,
            "mean_batch_fill": (h1.get("sum", 0) - h0.get("sum", 0)) /
            max(1, h1.get("count", 0) - h0.get("count", 0))}
    return closed_kept, kept, closed, conc


def _per_bucket(eng, items, eager_iters=10):
    """Device and eager ms of one forward at each bucket, and the idle
    share and device-busy µs of one bucket-8 and one bucket-1 forward
    from torch.profiler."""
    import torch
    out = {}
    for b in eng.buckets:
        x = torch.as_tensor(items[:b], device="cuda")
        out[b] = {
            # two forwards per CUDA-event window: the host queues both
            # inside the device-side sleep, so the window is device time
            "device_ms": cuda_ms(lambda: eng.run(x), iters=2, repeats=5,
                                 sleep=2 * SLEEP_CYCLES),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=eager_iters)}
        if b in (1, 8):
            prof = _profile(lambda: eng.run(x), 1, top=6)
            out[b].update({k: prof[k] for k in (
                "idle_share", "device_busy_us_per_call",
                "kernels_per_call", "wall_us_per_call") if k in prof})
    return out


def _affine_instances_host_ms(eng, images, rounds=8, per=5):
    """Wall ms of one eager bucket-8 bf16 ResNet-50 forward (host-bound:
    the host's time to queue it) with row 8 on each of its bf16 kernels,
    in turns: ``wgmma``, the kernel the wrapper picks, and ``mma_sync``,
    PR 18's, which the wrapper takes while ``wgmma_takes`` is made false
    for the window; ``rounds`` windows of ``per`` forwards each, the
    order alternating, Python's collector off; → the medians, their
    ratio and each window's launches by kernel.  Its launches come after
    the main path's counts are read."""
    import gc
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    x = torch.as_tensor(images[:8], device="cuda")
    takes, fn = cb.wgmma_takes, cb.conv_affine
    ms = {"wgmma": [], "mma_sync": []}
    launched = {"wgmma": dict.fromkeys(cb.INSTANCES, 0),
                "mma_sync": dict.fromkeys(cb.INSTANCES, 0)}

    def window(tag):
        cb.wgmma_takes = takes if tag == "wgmma" else (lambda *a: False)
        before = dict(fn.launches_by_instance)
        try:
            eng.run(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per):
                eng.run(x)
            torch.cuda.synchronize()
            ms[tag].append((time.perf_counter() - t0) * 1e3 / per)
        finally:
            cb.wgmma_takes = takes
        for k, v in fn.launches_by_instance.items():
            launched[tag][k] += v - before[k]

    gc.collect()
    gc.disable()
    try:
        for k in range(rounds):
            for tag in ("wgmma", "mma_sync")[::1 if k % 2 == 0 else -1]:
                window(tag)
    finally:
        gc.enable()
    med = {k: sorted(v)[rounds // 2] for k, v in ms.items()}
    return {**med, "mma_sync_over_wgmma": med["mma_sync"] / med["wgmma"],
            "windows_ms": ms, "launches": launched}


def _bf16_params(state):
    """The ResNet-50 and BERT-base ``.params`` of the fp32 serving phases
    (made here when those phases did not run), and their items."""
    import numpy as np
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    if "image_params" not in state:
        path = os.path.join(work, "resnet50_v1.params")
        _resnet50_params(path)
        images = np.random.RandomState(SEED).rand(64, 224, 224, 3) \
            .astype(np.float32)
        state.update(image_params=path, images=images)
    if "text_params" not in state:
        path = os.path.join(work, "bert_12_768_12.params")
        _bert_base_params(path)
        seqs = np.random.RandomState(SEED).randint(
            0, 30522, (96, TEXT_T)).astype(np.int32)
        state.update(text_params=path, text_seqs=seqs)


def phase_bf16_serve(state):
    """ResNet-50 v1 (224x224x3 float items) and Gluon BERT-base (512-token
    int32 items) through ``ModelRegistry.load(..., precision="bf16")``
    (``amp.convert_model`` on the card; the default ladder 1, 2, 4, 8)
    and its ``Batcher``, at the fp32 phases' loads: 32 closed-loop
    requests from one client, then 64 from 8 client threads.  The launch
    counters are set to 0 before each load and read after its traffic:
    exactly 16 bf16 ``conv_affine`` launches a ResNet-50 forward run and
    no fp32 one; exactly 12 bf16 softmax launches a BERT-base forward and
    no fp32 one (its LayerNorms take the reference's closed form in
    bf16: no LayerNorm launch).  Every response finite; p50/p99, items/s,
    batch fill, device and eager ms a forward per bucket, the idle share
    of a bucket-8 and a bucket-1 forward, peak memory; and the host's ms
    a bucket-8 ResNet-50 forward with row 8 on each of its bf16 kernels
    in turns (:func:`_affine_instances_host_ms`)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.serve import ModelRegistry
    _bf16_params(state)
    res = {}

    # ResNet-50 v1
    images = state["images"]
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    _zero_half_counts()
    telemetry.reset()
    reg = ModelRegistry(precision="bf16")
    t0 = time.perf_counter()
    entry = reg.load("resnet50_bf16", state["image_params"],
                     arch="resnet50_v1", item_shape=(224, 224, 3))
    load_s = time.perf_counter() - t0
    first, kept, closed, conc = _serve_traffic(
        reg, "resnet50_bf16", images, lambda k, o: o, 0)
    counts, eng = _half_counts(), entry.engine
    forwards = eng.forwards
    _add_bf16_launches(state, counts)
    bad = [o for o in list(first.values()) + list(kept.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if not _affine_path_ok(counts, forwards):
        raise AssertionError(f"bf16 ResNet-50 launches {counts} in "
                             f"{forwards} forwards")
    state.update(bf16_image_registry=reg, bf16_image_engine=eng,
                 bf16_image_batched=kept)
    res["resnet50_v1"] = {
        "item_shape": [224, 224, 3], "buckets": list(eng.buckets),
        "load_cast_and_warmup_s": load_s, "closed_loop": closed,
        "concurrent": conc, "per_bucket": _per_bucket(eng, images),
        "launches": {**counts, "forwards": forwards,
                     "conv_affine_bf16_per_forward":
                     counts["conv_affine_bf16"] / forwards},
        "engine": {k: v for k, v in eng.stats().items()
                   if k in ("retraces", "programs", "precision", "dtype",
                            "param_bytes_per_device")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "mem_before_bytes": mem_before}
    ab = res["resnet50_v1"]["affine_instances_host_ms"] = \
        _affine_instances_host_ms(eng, images)
    if ab["launches"]["wgmma"]["bf16_mma_sync"] or \
            ab["launches"]["mma_sync"]["bf16_wgmma"] or \
            not ab["launches"]["mma_sync"]["bf16_mma_sync"]:
        raise AssertionError(f"row 8's instances in turns launched "
                             f"{ab['launches']}")

    # Gluon BERT-base: responses digested (their sum and argmax), four of
    # the concurrent ones kept whole for bf16_reference
    seqs = state["text_seqs"]
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    _zero_half_counts()
    telemetry.reset()
    treg = ModelRegistry(precision="bf16")
    t0 = time.perf_counter()
    tentry = treg.load("bert_bf16", state["text_params"],
                       net=bert_gluon.bert_12_768_12(),
                       item_shape=(TEXT_T,), dtype="int32")
    load_s = time.perf_counter() - t0
    whole = {}

    def keep(k, out):
        if out.shape != (1, TEXT_T, 30522):
            raise AssertionError(f"response shape {out.shape}")
        if k in (32, 33, 34, 35):
            whole[k] = out
        return _digest(out)

    first, digests, closed, conc = _serve_traffic(treg, "bert_bf16", seqs,
                                                  keep, 32)
    digests.update(first)
    counts, teng = _half_counts(), tentry.engine
    forwards = teng.forwards
    _add_bf16_launches(state, counts)
    bad = [k for k, (s, _) in digests.items() if not np.isfinite(s)]
    if bad:
        raise AssertionError(f"responses {bad} not finite")
    if counts["softmax_fused_bf16"] != BERT_SOFTMAX_HALF * forwards or \
            counts["softmax_fused_fp32"] != 0:
        raise AssertionError(f"bf16 BERT-base launches {counts} in "
                             f"{forwards} forwards")
    state.update(bf16_text_registry=treg, bf16_text_engine=teng,
                 bf16_text_whole=whole)
    closed["tokens_s"] = closed["items_s"] * TEXT_T
    conc["tokens_s"] = conc["items_s"] * TEXT_T
    per_bucket = _per_bucket(teng, seqs, eager_iters=5)
    for b in teng.buckets:
        x = torch.as_tensor(seqs[:b], device="cuda")
        per_bucket[b]["to_host_ms"] = _to_host_ms(teng.run(x)[0])
    res["bert_12_768_12"] = {
        "item_shape": [TEXT_T], "dtype": "int32",
        "buckets": list(teng.buckets), "load_cast_and_warmup_s": load_s,
        "closed_loop": closed, "concurrent": conc, "per_bucket": per_bucket,
        "launches": {**counts, "forwards": forwards,
                     "softmax_bf16_per_forward":
                     counts["softmax_fused_bf16"] / forwards},
        "engine": {k: v for k, v in teng.stats().items()
                   if k in ("retraces", "programs", "precision", "dtype",
                            "param_bytes_per_device")},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "mem_before_bytes": mem_before}
    res["inceptionv3"] = _inception_bf16(state)
    return res


def _inception_bf16(state):
    """Inception-v3 (seeded, cast to bf16 by ``amp.convert_model``) at
    batch 2 x 299x299x3: its 10 lone 3x3/s1 convs take ``conv3x3``'s bf16
    ``wgmma`` kernel (every one has C and Cout multiples of 8), so exactly
    10 bf16 ``wgmma`` and no fp32 or ``mma.sync`` ``conv3x3`` launch a
    forward, no other kernel, and finite logits."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.parallel import train as pt
    net = _seeded_net("inceptionv3", (299, 299, 3), device="cuda")
    amp.convert_model(net, "bfloat16")
    x = torch.randn(2, 299, 299, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 19)).bfloat16()
    forwards = 3
    _fused_zero()
    with torch.inference_mode():
        for _ in range(forwards):
            out = net(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in pt._counts().items() if v}
    res = {"batch": 2, "forwards": forwards, "launches": counts,
           "dtype": str(out.dtype), "finite":
           bool(torch.isfinite(out.float()).all()),
           "conv3x3_bf16_per_forward":
           counts.get("conv3x3_bf16", 0) / forwards}
    tot = state.setdefault("bf16_launches", {})
    tot["conv3x3_bf16_wgmma"] = tot.get("conv3x3_bf16_wgmma", 0) + \
        counts.get("conv3x3_bf16_wgmma", 0)
    if counts != {"conv3x3": 10 * forwards, "conv3x3_bf16": 10 * forwards,
                  "conv3x3_bf16_wgmma": 10 * forwards} \
            or not res["finite"] or out.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 Inception-v3 forward: {res}")
    return res


def _flops_card_cpu(card_net, cpu_net, x):
    """``Block.flops`` of the card's bf16 net on card inputs ``x`` and of
    the same net in fp32 on the CPU: equal counts, and no kernel launched
    for the card's (it runs on fake tensors)."""
    import torch
    before = _half_counts()
    t0 = time.perf_counter()
    card = card_net.flops(x)
    seconds = time.perf_counter() - t0
    cpu = cpu_net.flops(x.cpu().to(torch.int32 if not x.is_floating_point()
                                   else torch.float32))
    launched = _half_counts() != before
    return {"card": card, "cpu": cpu, "card_s": seconds,
            "launched": launched, "equal": card == cpu and not launched}


def _cpu_engine(net, item_shape, precision, dtype="float32", b=2):
    from mxnet_tpu_torch.serve import InferenceEngine
    return InferenceEngine(net, item_shape, dtype=dtype, buckets=(b,),
                           precision=precision, device="cpu")


def phase_bf16_reference(state):
    """The card's bf16 engines against the port's bf16 on the CPU from the
    same ``.params``: ResNet-50 at batch 2 (top-1 equal) and BERT-base at
    1 x 512; then each batched response against the unbatched forward of
    its item on the card (ResNet-50: the 64 concurrent responses; BERT:
    four of them, whole).  The card and the CPU round at the same places
    but sum in fp32 in other orders (cuDNN, cuBLAS, the kernels), so a few
    values round to a neighbouring bf16 value and the flips compound
    through the layers: each distance is gated below the distance of the
    CPU's own bf16 from its fp32 on the same items (the error bf16
    itself brings), with the same top-1 (ResNet-50) or an argmax agreement
    no lower than that of bf16 against fp32 on the CPU (BERT-base).
    ``Block.flops`` of each card net equals its fp32 CPU copy's and
    launches nothing."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon, get_model
    torch.set_num_threads(os.cpu_count() or 1)
    res = {}

    eng, images = state["bf16_image_engine"], state["images"]
    x2 = images[:2]
    card = eng.run(x2)[0].float().cpu().numpy()
    sides, nets = {}, {}
    for prec in ("bf16", "fp32"):
        nets[prec] = net = get_model("resnet50_v1", classes=1000)
        net.load_parameters(state["image_params"])
        sides[prec] = _cpu_engine(net, (224, 224, 3), prec).run(x2)[0] \
            .float().numpy()
    flops = _flops_card_cpu(eng.net, nets["fp32"],
                            torch.zeros(2, 224, 224, 3, dtype=torch.bfloat16,
                                        device="cuda"))
    own = float(np.abs(sides["bf16"] - sides["fp32"]).max())
    err = float(np.abs(card - sides["bf16"]).max())
    top1 = bool((card.argmax(-1) == sides["bf16"].argmax(-1)).all())
    bat_err, bat_top1, bitwise = 0.0, True, 0
    for k, out in state["bf16_image_batched"].items():
        one = eng.run(images[k:k + 1])[0].float().cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_top1 &= bool(out.argmax() == one.argmax())
        bitwise += int(np.array_equal(out, one))
    state["bf16_image_registry"].close()
    res["resnet50_v1"] = {
        "batch": 2, "logits_max_abs_diff": err,
        "logits_max_abs": float(np.abs(sides["bf16"]).max()),
        "cpu_bf16_vs_fp32_max_abs_diff": own, "top1_equal": top1,
        "cpu_bf16_top1_equals_fp32": bool(
            (sides["bf16"].argmax(-1) == sides["fp32"].argmax(-1)).all()),
        "batched_vs_unbatched_max_abs_diff": bat_err,
        "batched_top1_equal": bat_top1, "batched_bitwise_equal": bitwise,
        "batched_responses": len(state["bf16_image_batched"]),
        "flops": flops}

    teng, seqs = state["bf16_text_engine"], state["text_seqs"]
    x1 = seqs[:1]
    card = teng.run(x1)[0].float().cpu().numpy()
    sides, nets = {}, {}
    for prec in ("bf16", "fp32"):
        nets[prec] = net = bert_gluon.bert_12_768_12()
        net.load_parameters(state["text_params"])
        sides[prec] = _cpu_engine(net, (TEXT_T,), prec, "int32", 1) \
            .run(x1)[0].float().numpy()
    flops = _flops_card_cpu(teng.net, nets["fp32"],
                            torch.zeros(1, TEXT_T, dtype=torch.int32,
                                        device="cuda"))
    own = float(np.abs(sides["bf16"] - sides["fp32"]).max())
    own_agree = float((sides["bf16"].argmax(-1) ==
                       sides["fp32"].argmax(-1)).mean())
    err = float(np.abs(card - sides["bf16"]).max())
    agree = float((card.argmax(-1) == sides["bf16"].argmax(-1)).mean())
    bat_err, bat_agree = 0.0, 1.0
    for k, out in state["bf16_text_whole"].items():
        one = teng.run(seqs[k:k + 1])[0].float().cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_agree = min(bat_agree,
                        float((out.argmax(-1) == one.argmax(-1)).mean()))
    state["bf16_text_registry"].close()
    res["bert_12_768_12"] = {
        "batch": 1, "tokens": TEXT_T, "logits_max_abs_diff": err,
        "logits_max_abs": float(np.abs(sides["bf16"]).max()),
        "cpu_bf16_vs_fp32_max_abs_diff": own,
        "argmax_agreement": agree,
        "cpu_bf16_vs_fp32_argmax_agreement": own_agree,
        "batched_vs_unbatched_max_abs_diff": bat_err,
        "batched_argmax_agreement": bat_agree,
        "batched_responses": len(state["bf16_text_whole"]),
        "flops": flops}
    r, t = res["resnet50_v1"], res["bert_12_768_12"]
    if not (r["logits_max_abs_diff"] < r["cpu_bf16_vs_fp32_max_abs_diff"]
            and r["top1_equal"] and r["batched_top1_equal"] and
            r["batched_vs_unbatched_max_abs_diff"] <
            r["cpu_bf16_vs_fp32_max_abs_diff"] and
            t["logits_max_abs_diff"] < t["cpu_bf16_vs_fp32_max_abs_diff"]
            and t["argmax_agreement"] >=
            t["cpu_bf16_vs_fp32_argmax_agreement"] and
            t["batched_vs_unbatched_max_abs_diff"] <
            t["cpu_bf16_vs_fp32_max_abs_diff"] and
            t["batched_argmax_agreement"] >=
            t["cpu_bf16_vs_fp32_argmax_agreement"] and
            r["flops"]["equal"] and t["flops"]["equal"]):
        raise AssertionError(f"card disagrees: {res}")
    return res


# ------------------------------------------------- bf16 training phases
# ResNet-50's four 3x3/s1 stages at bench.py train_mode's batch of 128
BF16_TRAIN_STAGES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                     (128, 14, 14, 256, 256), (128, 7, 7, 512, 512)]
BF16_SUM_TOL = 1e-5     # bf16 instances' fp32 results: sums, dW
# Inception-v3's lone 3x3/s1 convs at bf16_serve's batch of 2: the forward
# of conv3x3 on the wgmma kernel (Cout = 96, 384: BN = 128 off its tiles)
BF16_INCEPTION_CONVS = [(2, 147, 147, 32, 64), (2, 35, 35, 64, 96),
                        (2, 35, 35, 96, 96), (2, 8, 8, 448, 384)]
# the ragged shape: C, Cout not multiples of 8, PR 19's mma.sync kernels
BF16_RAGGED = (2, 9, 11, 20, 12)
BF16_TRAIN_STEPS = 20   # replays on one fixed batch; the loss must fall
BF16_TRAIN_KERNELS = ("conv3x3", "conv_stats", "bn_affine", "conv_wgrad")
# a captured bf16 ResNet-50 step: 16 launches of each training kernel, all
# of them its bf16 instance; a bf16 BERT-base step: 12 bf16 softmaxes, no
# LayerNorm kernel (bf16 LayerNorm is the reference's closed form)
BF16_IMAGE_WANT = {**{n: RESNET50_SEGMENTS for n in BF16_TRAIN_KERNELS},
                   **{n + "_bf16": RESNET50_SEGMENTS
                      for n in BF16_TRAIN_KERNELS},
                   **{n + "_bf16_wgmma": RESNET50_SEGMENTS
                      for n in ("conv3x3", "conv_stats", "conv_wgrad")}}
BF16_BERT_WANT = {"softmax_fused": BERT_SOFTMAXES,
                  "softmax_fused_bf16": BERT_SOFTMAXES}


def _bf16_within(out, ref):
    """A half kernel's output (bf16 or fp16) against its plain version's:
    each finite value within one step of ref's dtype (bf16: 8 significant
    bits; fp16: 11, its subnormals below 2^-14 a fixed step of 2^-24), or
    within ``BF16_NEAR_ZERO`` of the largest where both lie near 0 (the
    two sum the same exact products in fp32 in another order); an
    infinite value (fp16 past 65504) exactly where and as the plain
    version has it (``infinite`` counts them; ``finite`` is False
    then)."""
    import torch
    o, r = out.float(), ref.float()
    fin = torch.isfinite(r)
    inf_same = bool(torch.equal(o[~fin], r[~fin])) and \
        bool(torch.isfinite(o[fin]).all())
    o, r = torch.where(fin, o, 0.0), torch.where(fin, r, 0.0)
    err = (o - r).abs()
    scale = r.abs().max().item()
    e = torch.floor(torch.log2(r.abs()))
    if ref.dtype == torch.float16:
        e = e.clamp(min=-14)
    step = torch.exp2(e - (10 if ref.dtype == torch.float16 else 7))
    allowed = torch.clamp(HALF_STEPS * step, min=BF16_NEAR_ZERO * scale)
    return {"max_abs_err": err.max().item(),
            "rel_err": err.max().item() / max(scale, 1e-30),
            "within_steps": bool((err <= allowed).all()) and inf_same,
            "tol_steps": HALF_STEPS, "near_zero_tol": BF16_NEAR_ZERO,
            "values_differing": int((out != ref).sum()),
            "values": out.numel(), "infinite": int((~fin).sum()),
            "finite": bool(torch.isfinite(out.float()).all())}


def _bf16_timed(case, fn, plain, library, nbytes, flops):
    """Device, eager, plain and library ms of a bf16 case beside its bound
    (bytes over 3.35 TB/s, bf16 operations over 989 TFLOP/s dense)."""
    bms, by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
    kms = cuda_ms(fn, iters=10)
    lms = cuda_ms(library, iters=10)
    case.update(kernel_ms=kms, kernel_eager_ms=eager_ms(fn, iters=10),
                plain_ms=cuda_ms(plain, iters=10), library_ms=lms,
                bytes=nbytes, flop=flops, bound_ms=bms, bound_by=by,
                bound_share=bms / kms, vs_library=kms / lms,
                tflop_s=flops / (kms * 1e-3) / 1e12)
    return case


def _wgmma_plan(M, C, Cout, wgrad=False, op="conv3x3", dtype=None):
    """The plan the ``wgmma`` kernel of ``op`` (``conv3x3``,
    ``conv_stats``, ``conv_affine``; or ``conv_wgrad``) on half ``dtype``
    (default bf16) runs for ``M`` pixels, ``C`` input and ``Cout`` output
    channels on card 0 (chunks of one tap's 64-channel slab, or of 64
    pixels)."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    dtype = dtype or torch.bfloat16
    bn = cb.wgrad_tile_cols(Cout)
    K = 9 * cb.WGMMA_SLAB * cb._slabs(C)
    if wgrad:
        return cb.wgrad_splits(M, K, Cout, cb._sm_count(0), cb._wgmma_per_sm(
            "conv_wgrad", 0, bn, dtype), chunk=cb.WGMMA_SLAB)._asdict()
    return _plan_dict(cb._wgmma_conv_plan(op, 0, M, C, Cout, dtype))


def _instance_launches(fn, run, instance):
    """``run()``'s result and whether it launched ``fn``'s ``instance``
    kernel and no other (``launches_by_instance``)."""
    before = dict(fn.launches_by_instance)
    out = run()
    moved = {k: v - before[k] for k, v in fn.launches_by_instance.items()
             if v != before[k]}
    return out, set(moved) == {instance}


def _bf16_train_conv_cases(N, H, W, C, Cout, gen, dtype=None):
    """The half kernels (bf16, or ``dtype``: fp16) of ``conv3x3`` (in its
    training use, the dgrad:
    dy with the rotated weight), ``conv_stats`` and ``conv_wgrad`` at one
    shape, each launched twice on the same inputs (bitwise equal: a gate)
    and held against its plain version (bf16 widened to fp32, the conv in
    fp32 with TF32 off, one rounding): bf16 outputs within one step, the
    fp32 sums and dW within ``BF16_SUM_TOL`` (Σz of the channel's Σ|z|,
    Σz² and dW of their largest).  Each twice where ``wgmma_takes`` the
    shape: the ``mma.sync`` instances launched directly
    (``conv_block._conv3x3_tc``, ``_conv_stats_tc``, ``_wgrad_tc``; the
    statistics by :func:`_bf16_stats_cases`), and the wrappers, which
    must launch the ``wgmma`` kernels
    (``launches_by_instance``), timed on the same inputs beside the former
    (``parent_ms``), with their main and reduce kernels' µs.  Elsewhere
    once, through the wrappers, which must launch the ``mma.sync``
    kernels.  Library yardsticks on the same bf16 tensors (cuDNN,
    channels-last): ``conv2d_input``, ``F.conv2d`` alone (no sums),
    ``conv2d_weight`` (bf16 out).  On fp16 the same with fp16's step."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    bf = dtype or torch.bfloat16
    h, e, dn = cb.HALF_NAMES[bf], cb._ENTRY[bf], str(bf)[6:]
    x = torch.randn(N, H, W, C, device="cuda", generator=gen).to(bf)
    w = (torch.randn(3, 3, C, Cout, device="cuda", generator=gen) *
         (2.0 / (9 * C)) ** 0.5).to(bf)
    dy = torch.randn(N, H, W, Cout, device="cuda", generator=gen).to(bf)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    npix = N * H * W
    flops = 2 * npix * 9 * C * Cout
    nbytes = 2 * (npix * (C + Cout) + 9 * C * Cout)
    shape = [N, H, W, C, Cout]
    out = {}

    wr = cb.rotate(w)
    ref = cb.conv3x3_plain(dy, wr)
    library = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
        xc.shape, wc, dyc, padding=1)
    takes = cb.wgmma_takes(Cout, C, dy, wr, x)
    if takes:
        sync = lambda: cb._conv3x3_tc(dy, wr, torch.empty_like(x))  # noqa
        dx, via = sync(), {"launched": "directly"}
    else:
        sync = lambda: cb.conv3x3(dy, wr)  # noqa: E731
        dx, took = _instance_launches(cb.conv3x3, sync, h + "_mma_sync")
        via = {"launched": "by the wrapper", "instance_launched": took}
    again = sync()
    out[f"conv3x3_{h}_mma_sync"] = _bf16_timed(
        {"shape": shape, "dtype": dn,
         "use": "dgrad: conv3x3(dy, rotate(w)), the mma.sync instance",
         **via,
         "plan": _conv3x3_plan(npix, Cout, C,
                               f"mxt_conv3x3_{e}_blocks_per_sm", 8),
         **_bf16_within(dx, ref),
         "bitwise_equal_relaunch": bool(torch.equal(dx, again)),
         "library": f"torch.nn.grad.conv2d_input on {dn} (cuDNN)"},
        sync, lambda: cb.conv3x3_plain(dy, wr), library, nbytes, flops)
    if takes:
        dx, took = _instance_launches(cb.conv3x3,
                                      lambda: cb.conv3x3(dy, wr),
                                      h + "_wgmma")
        again = cb.conv3x3(dy, wr)
        case = _bf16_timed(
            {"shape": shape, "dtype": dn,
             "use": "dgrad: conv3x3(dy, rotate(w))",
             "plan": _wgmma_plan(npix, Cout, C, dtype=bf),
             **_bf16_within(dx, ref), "instance_launched": took,
             "bitwise_equal_relaunch": bool(torch.equal(dx, again)),
             "library": f"torch.nn.grad.conv2d_input on {dn} (cuDNN)"},
            lambda: cb.conv3x3(dy, wr), lambda: cb.conv3x3_plain(dy, wr),
            library, nbytes, flops)
        case.update(parent_ms=cuda_ms(sync, iters=10),
                    kernels_us=_kernel_us(lambda: cb.conv3x3(dy, wr)))
        case["parent_over_kernel"] = case["parent_ms"] / case["kernel_ms"]
        out[f"conv3x3_{h}_wgmma"] = case

    out.update(_bf16_stats_cases(x, w, shape, nbytes + 8 * Cout, flops,
                                 lambda: F.conv2d(xc, wc, padding=1)))

    wref = cb.conv_wgrad_plain(x, dy)
    library = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
        xc, wc.shape, dyc, padding=1)
    wbytes = 2 * npix * (C + Cout) + 4 * 9 * C * Cout
    takes = cb.wgmma_takes(C, Cout, x, dy)
    if takes:
        sync = lambda: cb._wgrad_tc(  # noqa: E731
            x, dy, torch.empty((3, 3, C, Cout), device="cuda"))
        dw, via = sync(), {"launched": "directly"}
    else:
        sync = lambda: cb.conv_wgrad(x, dy)  # noqa: E731
        dw, took = _instance_launches(cb.conv_wgrad, sync, h + "_mma_sync")
        via = {"launched": "by the wrapper", "instance_launched": took}
    again = sync()
    err, rel = _rel_err(dw, wref)
    vec = int(C % 8 == 0 and Cout % 8 == 0)
    plan = cb.wgrad_splits(npix, 9 * C, Cout, cb._sm_count(0),
                           cb._per_sm(f"mxt_conv_wgrad_{e}_blocks_per_sm",
                                      0, cb.wgrad_tile_cols(Cout), vec))
    out[f"conv_wgrad_{h}_mma_sync"] = _bf16_timed(
        {"shape": shape, "dtype": f"{dn} x and dy, fp32 dW",
         "use": "the mma.sync instance", **via,
         "plan": plan._asdict(), "max_abs_err": err, "rel_err": rel,
         "tol": BF16_SUM_TOL, "finite": bool(torch.isfinite(dw).all()),
         "bitwise_equal_relaunch": bool(torch.equal(dw, again)),
         "library": f"torch.nn.grad.conv2d_weight on {dn} (cuDNN; {dn} "
                    f"dW)"},
        sync, lambda: cb.conv_wgrad_plain(x, dy), library, wbytes, flops)
    if takes:
        dw, took = _instance_launches(cb.conv_wgrad,
                                      lambda: cb.conv_wgrad(x, dy),
                                      h + "_wgmma")
        again = cb.conv_wgrad(x, dy)
        err, rel = _rel_err(dw, wref)
        case = _bf16_timed(
            {"shape": shape, "dtype": f"{dn} x and dy, fp32 dW",
             "plan": _wgmma_plan(npix, C, Cout, wgrad=True, dtype=bf),
             "max_abs_err": err, "rel_err": rel, "tol": BF16_SUM_TOL,
             "finite": bool(torch.isfinite(dw).all()),
             "instance_launched": took,
             "bitwise_equal_relaunch": bool(torch.equal(dw, again)),
             "library": f"torch.nn.grad.conv2d_weight on {dn} (cuDNN; "
                        f"{dn} dW)"},
            lambda: cb.conv_wgrad(x, dy), lambda: cb.conv_wgrad_plain(x, dy),
            library, wbytes, flops)
        case.update(parent_ms=cuda_ms(sync, iters=10),
                    kernels_us=_kernel_us(lambda: cb.conv_wgrad(x, dy)))
        case["parent_over_kernel"] = case["parent_ms"] / case["kernel_ms"]
        out[f"conv_wgrad_{h}_wgmma"] = case
    return out


def _bf16_stats_cases(x, w, shape, nbytes, flops, library):
    """``conv_stats``' bf16 kernels at one shape: where ``wgmma_takes`` it,
    the ``mma.sync`` instance launched directly, then the wrapper, which
    must launch the ``wgmma`` kernel, timed on the same inputs beside the
    former (``parent_ms``) with its main, cut and sum kernels' µs; z also
    against ``conv3x3(x, w)``, bit for bit where the two plans agree
    (``plans_agree``: a gate).  Elsewhere the wrapper, which must launch
    the ``mma.sync`` kernel.  Each: z within one bf16 step of
    ``conv_stats_plain``, Σz (of the channel's Σ|z|) and Σz² within
    ``BF16_SUM_TOL``, two launches bitwise equal.  On fp16 x the same
    with the fp16 kernels and fp16's step."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    N, H, W, C, Cout = shape
    npix = N * H * W
    h, e, dn = cb.HALF_NAMES[x.dtype], cb._ENTRY[x.dtype], str(x.dtype)[6:]
    rz, r1, r2 = cb.conv_stats_plain(x, w)
    mag = rz.float().abs().sum(dim=(0, 1, 2))

    def check(got, again):
        return {**_bf16_within(got[0], rz),
                "sum_rel_err": ((got[1] - r1).abs() / mag).max().item(),
                "sumsq_rel_err": ((got[2] - r2).abs() / r2.abs()).max()
                .item(), "stats_tol": BF16_SUM_TOL,
                "bitwise_equal_relaunch": all(
                    bool(torch.equal(a, b)) for a, b in zip(got, again))}

    def direct():
        z = torch.empty(N, H, W, Cout, device="cuda", dtype=x.dtype)
        tstats = torch.empty(-(-npix // cb.CONV_ROWS), 2, Cout,
                             device="cuda")
        stats = torch.empty(2, Cout, device="cuda")
        cb._conv_stats_tc(x, w, z, tstats, stats)
        return z, stats[0], stats[1]

    takes = cb.wgmma_takes(C, Cout, x, w)
    if takes:
        sync, via = direct, {"launched": "directly"}
        got = sync()
    else:
        sync = lambda: cb.conv_stats(x, w)  # noqa: E731
        got, took = _instance_launches(cb.conv_stats, sync, h + "_mma_sync")
        via = {"launched": "by the wrapper", "instance_launched": took}
    out = {f"conv_stats_{h}_mma_sync": _bf16_timed(
        {"shape": shape, "dtype": dn, "use": "the mma.sync "
         "instance", **via,
         "plan": _conv3x3_plan(npix, C, Cout,
                               f"mxt_conv_stats_{e}_blocks_per_sm", 8),
         **check(got, sync()),
         "library": f"F.conv2d alone on {dn} (cuDNN; no sums)"},
        sync, lambda: cb.conv_stats_plain(x, w), library, nbytes, flops)}
    if takes:
        run = lambda: cb.conv_stats(x, w)  # noqa: E731
        got, took = _instance_launches(cb.conv_stats, run, h + "_wgmma")
        plan = _wgmma_plan(npix, C, Cout, op="conv_stats", dtype=x.dtype)
        agree = plan == _wgmma_plan(npix, C, Cout, dtype=x.dtype)
        case = _bf16_timed(
            {"shape": shape, "dtype": dn, "plan": plan,
             "instance_launched": took, **check(got, run()),
             "plans_agree": agree,
             "z_equals_conv3x3": bool(torch.equal(got[0], cb.conv3x3(x, w))),
             "library": f"F.conv2d alone on {dn} (cuDNN; no sums)"},
            run, lambda: cb.conv_stats_plain(x, w), library, nbytes, flops)
        case.update(parent_ms=cuda_ms(sync, iters=10),
                    kernels_us=_kernel_us(run))
        case["parent_over_kernel"] = case["parent_ms"] / case["kernel_ms"]
        out[f"conv_stats_{h}_wgmma"] = case
    return out


def _bf16_forward_case(N, H, W, C, Cout, gen):
    """``conv3x3``'s bf16 forward as a bf16 Inception-v3 runs it (its lone
    3x3/s1 convs): the wrapper, which must launch the ``wgmma`` kernel,
    twice (bitwise equal), against ``conv3x3_plain`` to one bf16 step;
    timed beside PR 19's ``mma.sync`` instance launched directly on the
    same inputs (``parent_ms``) and ``F.conv2d`` on bf16 (cuDNN,
    channels-last)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    bf = torch.bfloat16
    x = torch.randn(N, H, W, C, device="cuda", generator=gen).to(bf)
    w = (torch.randn(3, 3, C, Cout, device="cuda", generator=gen) *
         (2.0 / (9 * C)) ** 0.5).to(bf)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    npix = N * H * W
    run = lambda: cb.conv3x3(x, w)  # noqa: E731
    y, took = _instance_launches(cb.conv3x3, run, "bf16_wgmma")
    again = run()
    case = _bf16_timed(
        {"shape": [N, H, W, C, Cout], "dtype": "bfloat16",
         "use": "forward: conv3x3(x, w), a lone 3x3/s1 conv of Inception-v3",
         "plan": _wgmma_plan(npix, C, Cout),
         **_bf16_within(y, cb.conv3x3_plain(x, w)),
         "instance_launched": took,
         "bitwise_equal_relaunch": bool(torch.equal(y, again)),
         "library": "F.conv2d on bf16 (cuDNN, channels-last)"},
        run, lambda: cb.conv3x3_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1),
        2 * (npix * (C + Cout) + 9 * C * Cout), 2 * npix * 9 * C * Cout)
    case["parent_ms"] = cuda_ms(lambda: cb._conv3x3_tc(
        x, w, torch.empty_like(y)), iters=10)
    case["parent_over_kernel"] = case["parent_ms"] / case["kernel_ms"]
    return case


def _bf16_affine_case(N, H, W, C, gen, residual=False, relu=True,
                      dtype=None):
    """``bn_affine``'s bf16 instance (or ``dtype``'s: fp16; half z and
    residual, fp32 scale and shift) against its plain version, twice
    (bitwise equal), beside its bytes bound and ``torch.addcmul`` on the
    half type (no residual or ReLU)."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    bf = dtype or torch.bfloat16
    dn = str(bf)[6:]
    z = torch.randn(N, H, W, C, device="cuda", generator=gen).to(bf)
    scale = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    shift = 0.1 * torch.randn(C, device="cuda", generator=gen)
    res = torch.randn(N, H, W, C, device="cuda",
                      generator=gen).to(bf) if residual else None
    sc16, sh16 = scale.to(bf), shift.to(bf)
    out = cb.bn_affine(z, scale, shift, res, relu)
    again = cb.bn_affine(z, scale, shift, res, relu)
    n = N * H * W * C
    return _bf16_timed(
        {"shape": [N, H, W, C], "dtype": dn, "residual": residual,
         "relu": relu,
         **_bf16_within(out, cb.bn_affine_plain(z, scale, shift, res,
                                                relu)),
         "bitwise_equal_relaunch": bool(torch.equal(out, again)),
         "library": f"torch.addcmul(shift, z, scale) on {dn} (no residual "
                    f"or ReLU)"},
        lambda: cb.bn_affine(z, scale, shift, res, relu),
        lambda: cb.bn_affine_plain(z, scale, shift, res, relu),
        lambda: torch.addcmul(sh16, z, sc16),
        2 * n * (3 if residual else 2) + 8 * C,
        n * (2 + int(residual) + int(relu)))


def _bf16_case_ok(c):
    ok = c["finite"] and c["bitwise_equal_relaunch"] and \
        c.get("instance_launched", True)
    if "within_steps" in c:
        ok = ok and c["within_steps"]
    else:
        ok = ok and c["rel_err"] <= c["tol"]
    if "sum_rel_err" in c:
        ok = ok and c["sum_rel_err"] <= c["stats_tol"] and \
            c["sumsq_rel_err"] <= c["stats_tol"]
    if c.get("plans_agree"):
        ok = ok and c["z_equals_conv3x3"]
    return ok


FP32_DUMP = r"""
import math, sys
sys.path.insert(0, ".")
import torch
from mxnet_tpu_torch import context
from mxnet_tpu_torch.ops import conv_block as cb
context.exact_fp32()
gen = torch.Generator(device="cuda").manual_seed(7)
outs = {}
for N, H, W, C, Co in ((64, 56, 56, 64, 64), (8, 28, 28, 128, 128),
                       (64, 7, 7, 512, 512), (2, 9, 11, 20, 12)):
    x = torch.randn(N, H, W, C, device="cuda", generator=gen)
    w = torch.randn(3, 3, C, Co, device="cuda", generator=gen) / math.sqrt(9 * C)
    dy = torch.randn(N, H, W, Co, device="cuda", generator=gen)
    r = torch.randn(N, H, W, Co, device="cuda", generator=gen)
    v = [1 + 0.1 * torch.randn(Co, device="cuda", generator=gen)
         for _ in range(3)] + [0.5 + torch.rand(Co, device="cuda", generator=gen)]
    key = f"{N}x{H}x{W}x{C}x{Co}"
    outs["conv3x3 " + key] = cb.conv3x3(x, w).cpu()
    outs["dgrad " + key] = cb.conv3x3_dgrad(w, dy).cpu()
    for i, t in enumerate(cb.conv_stats(x, w)):
        outs[f"conv_stats{i} " + key] = t.cpu()
    outs["bn_affine " + key] = cb.bn_affine(dy, v[0], v[1], r).cpu()
    outs["conv_wgrad " + key] = cb.conv_wgrad(x, dy).cpu()
    outs["conv_affine " + key] = cb.conv_affine(x, w, *v, r).cpu()
    # the bf16 instances with bf16 BatchNorm vectors (the parent's only
    # bf16 conv_affine)
    b = torch.bfloat16
    xb, wb, dyb, rb = x.to(b), w.to(b), dy.to(b), r.to(b)
    vb = [t.to(b) for t in v]
    outs["bf16 conv3x3 " + key] = cb.conv3x3(xb, wb).cpu()
    outs["bf16 dgrad " + key] = cb.conv3x3_dgrad(wb, dyb).cpu()
    for i, t in enumerate(cb.conv_stats(xb, wb)):
        outs[f"bf16 conv_stats{i} " + key] = t.cpu()
    outs["bf16 bn_affine " + key] = cb.bn_affine(dyb, v[0], v[1], rb).cpu()
    outs["bf16 conv_wgrad " + key] = cb.conv_wgrad(xb, dyb).cpu()
    outs["bf16 conv_affine " + key] = cb.conv_affine(xb, wb, *vb, rb).cpu()
torch.save(outs, sys.argv[1])
"""


def _fp32_against_parent(parent):
    """The fp32 and bf16 instances of the conv kernels (conv3x3 and its
    dgrad, conv_stats, bn_affine, conv_wgrad, conv_affine; bf16 with bf16
    BatchNorm vectors, on the wgmma kernels at three shapes and the
    mma.sync ones at C = 20) on seeded inputs at four shapes, run by this
    checkout and by the checkout at ``parent`` (each its own package and
    build, in its own process): → {output: bitwise equal} (the bf16 ones
    named ``bf16 ...``)."""
    import torch
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    outs = []
    for root, tag in ((os.path.abspath(parent), "parent"), (HERE, "change")):
        path = os.path.join(work, f"fp32_{tag}.pt")
        run = subprocess.run([sys.executable, "-c", FP32_DUMP, path],
                             cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"fp32 dump of the {tag} failed: "
                               f"{run.stderr[-3000:]}")
        outs.append(torch.load(path))
    a, b = outs
    return {k: bool(torch.equal(a[k], b[k])) for k in a}


def _wgmma_bf16_src(ty="bf16"):
    """A register-and-shared-memory kernel for the card's ``wgmma`` bf16
    (or ``ty`` "f16") rate: each of two warpgroups a block issues
    m64n128k16 products from one K-major A and one MN-major B tile
    (128-byte swizzled, zeros) into its own accumulators, four a group,
    one group kept in flight."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return r"""
extern "C" __global__ void __launch_bounds__(256, 1)
wgmma_TY_peak(float* out, int iters) {
  __shared__ __align__(1024) unsigned short a[64 * 64];
  __shared__ __align__(1024) unsigned short b[2 * 64 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += 256) a[i] = b[i] = b[i + 4096] = 0;
  __syncthreads();
  const unsigned sa = (unsigned)__cvta_generic_to_shared(a);
  const unsigned sb = (unsigned)__cvta_generic_to_shared(b);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned long long da = (unsigned long long)(((sa + 32 * k) & 0x3FFFF) >> 4) |
          (1ull << 16) | (64ull << 32) | (1ull << 62);
      const unsigned long long db = (unsigned long long)(((sb + 2048 * k) & 0x3FFFF) >> 4) |
          (512ull << 16) | (64ull << 32) | (1ull << 62);
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.TY.TY "
          "{REGS}, %64, %65, p, 1, 1, 0, 1;\n}\n"
          : OUTS
          : "l"(da), "l"(db));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
""".replace("REGS", regs).replace("OUTS", outs).replace("TY", ty)


def _wgmma_ceiling(state, ty="bf16"):
    """:func:`_wgmma_bf16_ceiling` of ``ty`` (bf16, f16), measured once a
    run."""
    key = "wgmma_ceiling" if ty == "bf16" else f"wgmma_{ty}_ceiling"
    if key not in state:
        state[key] = _wgmma_bf16_ceiling(ty)
    return state[key]


def _wgmma_bf16_ceiling(ty="bf16"):
    """What ``wgmma.m64n128k16`` bf16 (or ``ty`` "f16") sustains on this
    card (the product shape of the wgmma conv kernels at BN = 128): one
    block of two warpgroups an SM issuing products from shared memory
    with no copies (:func:`_wgmma_bf16_src`), compiled by NVRTC through
    ``rtc.CudaModule``; beside the 989 TFLOP/s dense peak (bf16 and fp16
    alike)."""
    import torch
    from mxnet_tpu_torch import rtc
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    kern = rtc.CudaModule(_wgmma_bf16_src(ty)).get_kernel(
        f"wgmma_{ty}_peak")
    run = lambda: kern.launch([iters], grid=(blocks,), block=(256,),  # noqa
                              out_shape=(blocks * 256,))
    ms = cuda_ms(run, iters=3)
    flop = blocks * 2 * iters * 4 * 2 * 64 * 128 * 16
    return {"blocks": blocks, "ms": ms, "flop": flop,
            "tflop_s": flop / (ms * 1e-3) / 1e12,
            "share_of_dense_peak": flop / (ms * 1e-3) / PEAK_BF16_FLOP_S}


def _wgmma_parts(shapes):
    """Where the bf16 ``wgmma`` kernels' loop spends its time: the kernels
    as built and with one part taken out (``no_copies``: the producer
    arrives on the ring without loading it; ``no_products``: no
    ``wgmma``; ``one_run``: the run accumulator flushed with IEEE adds
    only at a segment's end, up to a whole range's products in one
    tensor-core sum), built by :func:`_build_variants` and timed (device
    ms: the dgrad use, ``conv_stats`` and the dW) at ``shapes`` (N, H, W,
    C, Cout) on the plans the wrappers run.  ``conv_stats`` beside the
    dgrad says whether its epilogue moved what binds the loop.  The cut
    kernels' outputs are garbage but ``one_run``'s, whose dW error
    against the plain version (of its largest) is kept beside the
    kernel's."""
    import torch
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import conv_block as cb
    libs, missing = _build_variants(
        "wgmma_parts", "conv_bf16_wgmma.cu",
        {"no_copies": [("load_unit<OP, BN>(g, ta, tb, sm.st[st], "
                        "&sm.full[st], u);", "bar_arrive(&sm.full[st]);")],
         "no_products": [("mma_chunk<H, OP, BN>(sm.st[st], wg, in_run == 0, "
                          "run);", ";")],
         "one_run": [("constexpr int kRun = 8;",
                      "constexpr int kRun = 1 << 30;")]},
        ["mxt_conv3x3_wgmma_bf16", "mxt_conv_stats_wgmma_bf16",
         "mxt_conv_wgrad_wgmma_bf16"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = []
    for N, H, W, C, Cout in shapes:
        bf = torch.bfloat16
        x = torch.randn(N, H, W, C, device="cuda", generator=gen).to(bf)
        dy = torch.randn(N, H, W, Cout, device="cuda", generator=gen).to(bf)
        wr = cb.rotate((torch.randn(3, 3, C, Cout, device="cuda",
                                    generator=gen) * 0.05).to(bf))
        M = N * H * W
        dx = torch.empty(N, H, W, C, device="cuda", dtype=bf)
        dw = torch.empty(3, 3, C, Cout, device="cuda")
        cp = cb.conv3x3_splits(M, 9 * cb.WGMMA_SLAB * cb._slabs(Cout), C,
                               cb._sm_count(0),
                               cb._per_sm("mxt_conv3x3_wgmma_blocks_per_sm",
                                          0, cb.wgrad_tile_cols(C), 1),
                               chunk=cb.WGMMA_SLAB)
        wp = cb.wgrad_splits(M, 9 * cb.WGMMA_SLAB * cb._slabs(C), Cout,
                             cb._sm_count(0),
                             cb._per_sm("mxt_conv_wgrad_wgmma_blocks_per_sm",
                                        0, cb.wgrad_tile_cols(Cout), 1),
                             chunk=cb.WGMMA_SLAB)
        cpart = torch.empty(2 * cp.ranges, cb.CONV_ROWS, cp.bn,
                            device="cuda")
        sp = cb._wgmma_conv_plan("conv_stats", 0, M, C, Cout)
        spart = torch.empty(2 * sp.ranges, cb.CONV_ROWS, sp.bn,
                            device="cuda")
        wst = (torch.randn(3, 3, C, Cout, device="cuda", generator=gen) *
               0.05).to(bf)
        z = torch.empty(N, H, W, Cout, device="cuda", dtype=bf)
        tstats = torch.empty(-(-M // cb.CONV_ROWS), 2, Cout, device="cuda")
        stats = torch.empty(2, Cout, device="cuda")
        wpart = torch.empty(wp.tiles, wp.jmax, cb.WGRAD_ROWS, wp.bn,
                            device="cuda")
        row = {"shape": [N, H, W, C, Cout]}
        for name, lib in libs.items():
            def dgrad(lib=lib, name=name):
                _build.check(lib.mxt_conv3x3_wgmma_bf16(
                    dy.data_ptr(), wr.data_ptr(), cpart.data_ptr(),
                    dx.data_ptr(), N, H, W, Cout, C, cp.bn, cp.ranges,
                    stream()), name)

            def conv_stats(lib=lib, name=name):
                _build.check(lib.mxt_conv_stats_wgmma_bf16(
                    x.data_ptr(), wst.data_ptr(), spart.data_ptr(),
                    z.data_ptr(), tstats.data_ptr(), stats.data_ptr(), N, H,
                    W, C, Cout, sp.bn, sp.ranges, stream()), name)

            def wgrad(lib=lib, name=name):
                _build.check(lib.mxt_conv_wgrad_wgmma_bf16(
                    x.data_ptr(), dy.data_ptr(), wpart.data_ptr(),
                    dw.data_ptr(), N, H, W, C, Cout, wp.bn, wp.ranges,
                    wp.jmax, stream()), name)
            row[name + "_dgrad_ms"] = cuda_ms(dgrad, iters=10)
            row[name + "_stats_ms"] = cuda_ms(conv_stats, iters=10)
            row[name + "_wgrad_ms"] = cuda_ms(wgrad, iters=10)
            if name in ("kernel", "one_run"):
                wgrad()
                row[name + "_wgrad_rel_err"] = _rel_err(
                    dw, cb.conv_wgrad_plain(x, dy))[1]
        out.append(row)
    return {"shapes": out, "not_built": missing}


def _host_us(fns, calls=800, windows=16):
    """Host µs per call of each of ``fns`` (name → fn(i), i the call's
    index) at a shape whose kernels take far less: the wrapper's checks,
    plan, allocation, encoding and launch.  The functions take turns, a
    window of ``calls / windows`` calls each, each round starting one
    function later, so a slow spell of the shared host falls on all of
    them; each window runs behind a
    device-side sleep (the device's queue does not hold the host back),
    Python's collector off (its passes over the run's objects are not the
    wrapper's); → {name: the median over the windows}."""
    import gc
    import torch
    for fn in fns.values():
        fn(0)
    torch.cuda.synchronize()
    per, us = calls // windows, {name: [] for name in fns}
    gc.collect()
    gc.disable()
    try:
        names = list(fns)
        for k in range(windows):
            for name in names[k % len(names):] + names[:k % len(names)]:
                fn = fns[name]
                torch.cuda._sleep(SLEEP_CYCLES // 4)
                t0 = time.perf_counter()
                for i in range(k * per, (k + 1) * per):
                    fn(i)
                us[name].append((time.perf_counter() - t0) / per * 1e6)
                torch.cuda.synchronize()
    finally:
        gc.enable()
    return {name: sorted(v)[windows // 2] for name, v in us.items()}


def _wgmma_host_us(calls=800):
    """Host µs per eager call at (1, 8, 16, 64→64) of the four bf16 conv
    wrappers, each launching its ``wgmma`` kernel: ``warm``, every call on
    the same tensors (the encoded tensor maps come from the cache), and
    ``cold``, a fresh x on every call (x's map encoded each time: more
    tensors than the cache holds); and of the launch helpers of both
    instances, called directly on the same tensors (``wgmma``,
    ``mma_sync``: no checks).  All of them in turns (:func:`_host_us`),
    with the cache's hits and misses over 20 more calls of each."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    bf = torch.bfloat16
    shape = (1, 8, 16, 64)
    xs = [torch.randn(*shape, device="cuda").to(bf)
          for _ in range(4 * calls + 1)]
    x = xs[0]
    w = torch.randn(3, 3, 64, 64, device="cuda").to(bf)
    v = (torch.rand(64, device="cuda") + 0.5).to(bf)
    bn = (v, v, v, v)
    o, z = torch.empty_like(x), torch.empty_like(x)
    ts = torch.empty(1, 2, 64, device="cuda")
    st = torch.empty(2, 64, device="cuda")
    dw = torch.empty(3, 3, 64, 64, device="cuda")
    wrappers = {"conv3x3": lambda x: cb.conv3x3(x, w),
                "conv_stats": lambda x: cb.conv_stats(x, w),
                "conv_affine": lambda x: cb.conv_affine(x, w, *bn),
                "conv_wgrad": lambda x: cb.conv_wgrad(x, xs[0])}
    fns = {}
    for j, (name, fn) in enumerate(wrappers.items()):
        fns[f"{name}_wgmma_warm"] = lambda i, fn=fn: fn(x)
        fns[f"{name}_wgmma_cold"] = \
            lambda i, fn=fn, j=j: fn(xs[1 + j * calls + i])
    for tag, conv3x3, stats, tst, affine, wgrad in (
            ("wgmma", cb._conv3x3_wgmma, cb._conv_stats_wgmma, (st,),
             cb._conv_affine_wgmma, cb._wgrad_wgmma),
            ("mma_sync", cb._conv3x3_tc, cb._conv_stats_tc, (ts, st),
             cb._conv_affine_tc, cb._wgrad_tc)):
        fns.update({
            f"conv3x3_{tag}": lambda i, f=conv3x3: f(x, w, o),
            f"conv_stats_{tag}": lambda i, f=stats, t=tst: f(x, w, z, *t),
            f"conv_affine_{tag}": lambda i, f=affine: f(
                x, w, bn, None, 1e-5, True, o),
            f"conv_wgrad_{tag}": lambda i, f=wgrad: f(x, x, dw)})
    out = {"shape": [*shape, 64], "calls": calls,
           "us": _host_us(fns, calls), "map_cache_over_20_calls": {}}
    for name, fn in fns.items():
        c0 = cb.map_cache_stats()
        for i in range(20):
            fn(calls - 20 + i)
        c1 = cb.map_cache_stats()
        out["map_cache_over_20_calls"][name] = {
            k: c1[k] - c0[k] for k in ("hits", "misses")}
    torch.cuda.synchronize()
    out["map_cache"] = cb.map_cache_stats()
    return out


def phase_bf16_train_kernels(state):
    """The bf16 instances of rows 7 (``conv3x3``, in its dgrad use), 9
    (``conv_stats``), 10 (``bn_affine``) and 11 (``conv_wgrad``) at
    ResNet-50's four 3x3 stages at batch 128 (``bn_affine`` also with a
    residual, and with the ReLU off, at stage 1; the ``wgmma`` kernels'
    edges; and a ragged shape on the scalar paths, C = 20, through the
    wrappers to the ``mma.sync`` kernels), and row 7's bf16 forward at
    Inception-v3's lone 3x3/s1 convs, against their plain versions,
    bitwise on relaunch, each wrapper launching the kernel its shape
    takes; timed beside their bounds, plain versions and the nearest
    library call on bf16.  With ``--parent DIR``, also the fp32 instances
    of the same file against the checkout at DIR, bit for bit."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    cases = {k: [] for k in ("conv3x3_bf16_wgmma", "conv3x3_bf16_mma_sync",
                             "conv_stats_bf16_wgmma",
                             "conv_stats_bf16_mma_sync", "bn_affine_bf16",
                             "conv_wgrad_bf16_wgmma",
                             "conv_wgrad_bf16_mma_sync")}
    for shape in BF16_TRAIN_STAGES + BF16_WGMMA_EDGES + [BF16_RAGGED]:
        for k, c in _bf16_train_conv_cases(*shape, gen).items():
            cases[k].append(c)
    cases["conv3x3_bf16_wgmma"] += [_bf16_forward_case(*shape, gen)
                                    for shape in BF16_INCEPTION_CONVS]
    for N, H, W, _, C in BF16_TRAIN_STAGES:
        cases["bn_affine_bf16"].append(_bf16_affine_case(N, H, W, C, gen))
    cases["bn_affine_bf16"] += [
        _bf16_affine_case(128, 56, 56, 64, gen, residual=True),
        _bf16_affine_case(128, 56, 56, 64, gen, relu=False),
        _bf16_affine_case(2, 9, 11, 12, gen, residual=True)]
    state["cases"].update(cases)
    ceiling = _wgmma_ceiling(state)
    for k in ("conv3x3_bf16_wgmma", "conv_stats_bf16_wgmma",
              "conv_wgrad_bf16_wgmma"):
        for c in cases[k]:
            c["wgmma_ceiling_share"] = c["tflop_s"] / ceiling["tflop_s"]
    stages = [{"shape": a["shape"],
               "dgrad_ms": [a["parent_ms"], a["kernel_ms"]],
               "dgrad_vs_library": a["vs_library"],
               "stats_ms": [c["parent_ms"], c["kernel_ms"]],
               "stats_vs_library": c["vs_library"],
               "stats_kernels_us": c["kernels_us"],
               "wgrad_ms": [b["parent_ms"], b["kernel_ms"]],
               "wgrad_vs_library": b["vs_library"]}
              for a, c, b in zip(cases["conv3x3_bf16_wgmma"],
                                 cases["conv_stats_bf16_wgmma"],
                                 cases["conv_wgrad_bf16_wgmma"])][:4]
    res = {"cases": cases, "wgmma_ceiling": ceiling,
           "host_us_per_eager_call": _wgmma_host_us(),
           "stages_parent_to_wgmma": stages,
           "parts": _wgmma_parts(BF16_TRAIN_STAGES)}
    bad = [c for cs in cases.values() for c in cs if not _bf16_case_ok(c)]
    taken = len(BF16_TRAIN_STAGES) + len(BF16_WGMMA_EDGES)
    if len(cases["conv3x3_bf16_wgmma"]) != taken + \
            len(BF16_INCEPTION_CONVS) or \
            len(cases["conv_stats_bf16_wgmma"]) != taken or \
            len(cases["conv_wgrad_bf16_wgmma"]) != taken:
        bad.append("a shape the wgmma kernels should take was not taken")
    if [c["launched"] for c in cases["conv3x3_bf16_mma_sync"] +
            cases["conv_stats_bf16_mma_sync"] +
            cases["conv_wgrad_bf16_mma_sync"]].count("by the wrapper") != 3:
        bad.append("the ragged shape did not go through the wrappers")
    if state.get("parent"):
        res["fp32_equal_to_parent"] = eq = _fp32_against_parent(
            state["parent"])
        res["fp32_bitwise_as_parent"] = all(
            v for k, v in eq.items() if not k.startswith("bf16"))
        res["bf16_bitwise_as_parent"] = all(
            v for k, v in eq.items() if k.startswith("bf16"))
        if not all(eq.values()):
            bad.append({"fp32 or bf16 differs from the parent":
                        [k for k, v in eq.items() if not v]})
    if bad:
        raise AssertionError(f"bf16 training kernel disagrees: {bad}")
    return res


def _bf16_fused(state, key, step, batch_xy, want, batch, fp32_key,
                half="bf16"):
    """``step`` (a ``FusedTrainStep(dtype="bfloat16")``, or of ``half``
    "fp16") driven as the fused phases drive theirs (:func:`_fused_run`),
    on one fixed batch for ``1 + BF16_TRAIN_STEPS`` calls: gates its
    captured launches (the half instances only) and a loss that falls;
    records the half instances' real launches (``<half>_train_launches``);
    sets the fp32 fused step of the same run beside it."""
    res = _fused_run(state, key, step, [batch_xy] * (1 + BF16_TRAIN_STEPS),
                     want, batch, launches_key=None)
    tot = state.setdefault(f"{half}_train_launches", {})
    for n, k in res["launches_real"].items():
        if f"_{half}" in n:
            tot[n] = tot.get(n, 0) + k
    losses = res["losses"]
    res["loss_falls"] = losses[-1] < losses[0]
    f32 = state[fp32_key]
    res["fp32"] = {k: f32[k] for k in (
        "replayed_step_ms_median", "eager_step_ms_median",
        "items_s_replayed", "peak_mem_bytes")}
    res["fp32"]["idle_share"] = f32["profile_replays"].get("idle_share")
    res["idle_share"] = res["profile_replays"].get("idle_share")
    res["fp32_over_bf16_step"] = (f32["replayed_step_ms_median"] /
                                  res["replayed_step_ms_median"])
    cats = res["profile_replays"].get("by_category", {})
    res["ours_us_per_replay"] = {k: v["us_per_call"] for k, v in cats.items()
                                 if k.endswith("(ours)")}
    if not res["loss_falls"]:
        raise AssertionError(f"{key}: the loss does not fall: {losses}")
    return res


def phase_bf16_train(state):
    """bf16 training through ``FusedTrainStep(dtype="bfloat16")`` (fp32
    masters and optimizer states, the step in bf16, one captured CUDA
    graph a step): ResNet-50 v1 at ``bench.py`` ``train_mode``'s
    configuration (batch 128 x 224x224x3, 1000 classes, SGD lr 0.1,
    momentum 0.9, wd 1e-4) and Gluon BERT-base at ``bert_mode``'s (8 x
    512 tokens, Adam lr 1e-4), each on one fixed batch for 21 calls.
    Gates: exactly 16 launches of each of the four training kernels a
    ResNet step, all of them the bf16 instance; 12 bf16 softmaxes a BERT
    step; finite losses that fall.  Replayed and eager step ms, items/s,
    tokens/s, peak memory, idle share, beside the fp32 fused step of the
    same run (``fused_image_train``, ``fused_bert_train``; run here when
    they were not)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.parallel import FusedTrainStep
    if "fused_image" not in state:
        phase_fused_image_train(state)
    if "fused_bert" not in state:
        phase_fused_bert_train(state)
    dev = torch.device("cuda")
    res = {}
    torch.cuda.empty_cache()
    args = ic.parse_args(["--batch-size", str(FUSED_IMAGE_BATCH),
                          "--seed", str(SEED)])
    net, _, loss_fn = ic.build(args, dev)
    opt = opt_mod.create("sgd", learning_rate=args.lr, momentum=0.9,
                         wd=1e-4)
    step = FusedTrainStep(net, loss_fn, opt, dtype="bfloat16")
    rng = np.random.RandomState(SEED + 20)
    x, y = ic.synthetic_batch(rng, args.batch_size, args.image_size,
                              args.classes)
    res["resnet50_v1"] = _bf16_fused(
        state, "bf16_image", step, (torch.as_tensor(x, device=dev),
                                    torch.as_tensor(y, device=dev)),
        BF16_IMAGE_WANT, args.batch_size, "fused_image")
    res["resnet50_v1"].update(optimizer="sgd", lr=args.lr, momentum=0.9,
                              wd=1e-4, image=args.image_size,
                              classes=args.classes, dtype="bfloat16")
    del net, step, opt
    torch.cuda.empty_cache()
    cfg = FUSED_BERT
    net = bert_gluon.bert_12_768_12()
    net.initialize(ctx=dev, seed=SEED)
    net.hybridize()
    net.train()
    step = FusedTrainStep(net, SoftmaxCrossEntropyLoss(),
                          opt_mod.create("adam", learning_rate=cfg["lr"]),
                          dtype="bfloat16")
    rng = np.random.RandomState(SEED + 21)
    toks = tuple(torch.as_tensor(rng.randint(0, 30522, (
        cfg["batch"], cfg["seq"])).astype(np.int32), device=dev)
        for _ in range(2))
    r = _bf16_fused(state, "bf16_bert", step, toks, BF16_BERT_WANT,
                    cfg["batch"], "fused_bert")
    r.update(optimizer="adam", vocab=30522, dtype="bfloat16",
             tokens_s_replayed=r["items_s_replayed"] * cfg["seq"],
             tokens_s_eager=r["items_s_eager"] * cfg["seq"], **cfg)
    res["bert_12_768_12"] = r
    return res


def _bf16_side(kind, dev, arrays, batches, dtype, grad_scale=None):
    """Two ``FusedTrainStep`` SGD steps of ResNet-18 v1 (10 classes) or
    ``bert_small`` on ``dev`` from ``arrays`` (the loss scaled by
    ``grad_scale``): → (losses, {name: array after})."""
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.gluon import load_numpy
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon, get_model
    from mxnet_tpu_torch.parallel import FusedTrainStep
    net = bert_gluon.bert_small() if kind == "bert_small" else \
        get_model("resnet18_v1", classes=10)
    load_numpy(net, arrays)
    net = net.to(dev)
    net.hybridize()
    net.train()
    kw = {"learning_rate": 0.05, "momentum": 0.9} if kind == "bert_small" \
        else {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    step = FusedTrainStep(net, SoftmaxCrossEntropyLoss(),
                          opt_mod.create("sgd", **kw), dtype=dtype,
                          grad_scale=grad_scale)
    losses = [float(step(torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev)))
              for x, y in batches]
    return losses, {k: t.detach().float().cpu().numpy()
                    for k, t in net.collect_params().items()}


def _bf16_dist(a, b):
    import numpy as np
    return (max(abs(x - y) for x, y in zip(a[0], b[0])),
            max(float(np.abs(a[1][k] - b[1][k]).max()) for k in a[1]))


def phase_bf16_train_reference(state):
    """Two bf16 ``FusedTrainStep`` SGD steps on the card (captured graphs)
    and through the port on the CPU (the step function run directly) from
    the same weights and batches, and the same on the CPU in fp32:
    ResNet-18 v1 (10 classes, 64x64x3, batch 2, each residual branch's
    last BatchNorm γ damped by 0.1, lr 0.01, momentum 0.9, wd 1e-4) and
    ``bert_small`` on (2, 16) tokens (lr 0.05, momentum 0.9).  The card's
    bf16 step no farther from the CPU's bf16 step than that is from the
    CPU's fp32 step: the losses of both steps and every master weight and
    running statistic after them.  (``fused_parity``'s
    ``cast_after_capture`` case holds ``Block.cast`` after a capture.)"""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon, get_model
    res = {}
    rs = np.random.RandomState(SEED + 22)
    img = [(rs.rand(2, 64, 64, 3).astype(np.float32),
            rs.randint(0, 10, (2,))) for _ in range(2)]
    net = get_model("resnet18_v1", classes=10)
    net.initialize(ctx="cpu", seed=SEED)
    with torch.no_grad():
        net(torch.zeros(1, 64, 64, 3))
    arrays = {k: t.detach().numpy().copy()
              for k, t in net.collect_params().items()}
    for k in arrays:
        if k.endswith(".body.4.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
    toks = [(rs.randint(0, 1000, (2, 16)).astype(np.int32),
             rs.randint(0, 1000, (2, 16)).astype(np.int32))
            for _ in range(2)]
    bnet = bert_gluon.bert_small()
    bnet.initialize(ctx="cpu", seed=SEED)
    with torch.no_grad():
        bnet(torch.as_tensor(toks[0][0]))
    barrays = {k: t.detach().numpy().copy()
               for k, t in bnet.collect_params().items()}
    bad = []
    for kind, a, batches in (("resnet18_v1", arrays, img),
                             ("bert_small", barrays, toks)):
        card = _bf16_side(kind, torch.device("cuda"), a, batches,
                          "bfloat16")
        cpu16 = _bf16_side(kind, torch.device("cpu"), a, batches,
                           "bfloat16")
        cpu32 = _bf16_side(kind, torch.device("cpu"), a, batches, None)
        d, floor = _bf16_dist(card, cpu16), _bf16_dist(cpu16, cpu32)
        finite = all(np.isfinite(v) for v in card[0]) and all(
            np.isfinite(t).all() for t in card[1].values())
        res[kind] = {"losses_card": card[0], "losses_cpu": cpu16[0],
                     "losses_cpu_fp32": cpu32[0],
                     "card_vs_cpu": {"loss": d[0], "weights": d[1]},
                     "cpu_bf16_vs_fp32": {"loss": floor[0],
                                          "weights": floor[1]},
                     "finite": finite}
        if not (finite and d[0] <= floor[0] and d[1] <= floor[1]):
            bad.append(kind)
    if bad:
        raise AssertionError(f"card bf16 step off the CPU's in {bad}: {res}")
    return res


def _cast_case(make, batches):
    """``Block.cast`` after a capture: two fused steps, the net cast to
    bf16 and back to fp32 (its old storage kept alive, so the new tensors
    cannot land on it), a third step; against the same on the eager
    legacy path, bit for bit.  The executor must capture anew on the new
    storage (one program, a rebuild): a graph left on the old storage
    would update tensors the net no longer holds."""
    import torch
    runs = []
    for fused in (True, False):
        net, trainer, loss_fn = make()
        ex = trainer.fuse_step(loss_fn) if fused else None

        def step(x, y):
            if fused:
                return ex(x, y)
            return _legacy_step(net, trainer, loss_fn, x, y)
        r0 = _counter("fused.rebuilds")
        losses = [step(*batches[0]), step(*batches[1])]
        kept = [t.data for t in net.collect_params().values()]
        net.cast("bfloat16")
        net.cast("float32")
        losses.append(step(*batches[2]))
        torch.cuda.synchronize()
        runs.append((torch.stack([v.reshape(()) for v in losses]),
                     _snapshot(net), ex, _counter("fused.rebuilds") - r0))
        del kept
    (lf, wf, ex, rebuilds), (le, we, _, _) = runs
    diff = _max_diff(wf, we)
    bitwise = not diff and bool(torch.equal(lf, le))
    return {"bitwise": bitwise, "params_differing": len(diff),
            "loss_replay_vs_eager": (lf.double() - le.double()).abs()
            .max().item(), "programs": ex.programs, "replays": ex.replays,
            "rebuilds": rebuilds, "fused": ex.fused,
            "ok": bitwise and ex.programs == 1 and rebuilds == 1}


# ------------------------------------------------- fp16 training phases
# the static loss scale of the fp16 step: the reference's FusedTrainStep
# has no dynamic scaler, and a user of it on ResNet-50 sets one scale that
# lifts the step's smallest gradients out of fp16's subnormals (below
# 6.1e-5) without overflowing its largest (65504): 1024 = 2^10
FP16_GRAD_SCALE = 1024.0
# the training kernels' shapes: ResNet-50's four stages at batch 128, the
# wgmma kernels' first two edges, the ragged C = 20 on mma.sync
FP16_TRAIN_SHAPES = BF16_TRAIN_STAGES + BF16_WGMMA_EDGES[:2] + [BF16_RAGGED]
# row 8's fp16 cases: the converted ResNet-50 forward's four stages at
# batch 8 (the path shape first) and stage 1 at batch 64, each with fp16
# vectors and with fp32 statistics (a half step's frozen segment); edges
# and the ragged shape with a residual
FP16_AFFINE_CASES = (
    [(s, {}) for s in BF16_AFFINE_SHAPES[:5]] +
    [(s, {"stats_fp32": True}) for s in BF16_AFFINE_SHAPES[:5]] +
    [(BF16_WGMMA_EDGES[0], {"residual": True}),
     (BF16_WGMMA_EDGES[1], {"residual": True, "stats_fp32": True}),
     ((2, 9, 11, 20, 12), {"residual": True}),
     ((2, 9, 11, 20, 12), {"stats_fp32": True})])
# a captured fp16 ResNet-50 step: 16 launches of each training kernel, all
# of them its fp16 instance, the three convs on the wgmma kernels
FP16_IMAGE_WANT = {**{n: RESNET50_SEGMENTS for n in BF16_TRAIN_KERNELS},
                   **{n + "_fp16": RESNET50_SEGMENTS
                      for n in BF16_TRAIN_KERNELS},
                   **{n + "_fp16_wgmma": RESNET50_SEGMENTS
                      for n in ("conv3x3", "conv_stats", "conv_wgrad")}}
FP16_AMP_STEPS = 12     # eager amp.init("float16") Trainer steps
FP16_AMP_BATCH = 64     # example/gluon/image_classification.py's batch
FP16_SERVE_BATCH = 8    # the converted forward's batch


def _fp16_range_cases(gen):
    """fp16's range on the kernels: a large-magnitude case whose z
    overflows past 65504 at the interior pixels (9 taps) and not at the
    edges (4 or 6), through ``conv_stats`` (z inf exactly where the plain
    version's is, Σz and Σz² of the fp32 values before the rounding,
    finite) and the dgrad use of ``conv3x3``; and a small one whose
    outputs are fp16 subnormals (below 6.1e-5), through ``conv3x3``,
    ``conv_stats`` and ``bn_affine`` (each within one fp16 step, 2^-24
    there)."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    f16 = torch.float16
    big = {"what": "z past 65504: 40 * 4 * 576 at the interior pixels"}
    x = (40 * (1 + 0.01 * torch.randn(2, 8, 16, 64, device="cuda",
                                      generator=gen))).to(f16)
    w = (4 * (1 + 0.01 * torch.randn(3, 3, 64, 64, device="cuda",
                                     generator=gen))).to(f16)
    z, s1, s2 = cb.conv_stats(x, w)
    rz, r1, r2 = cb.conv_stats_plain(x, w)
    big.update(_bf16_within(z, rz), sums_finite=bool(
        torch.isfinite(s1).all() and torch.isfinite(s2).all()),
        sum_rel_err=((s1 - r1).abs() / r1.abs()).max().item(),
        sumsq_rel_err=((s2 - r2).abs() / r2.abs()).max().item(),
        dgrad=_bf16_within(cb.conv3x3_dgrad(w, x),
                           cb.conv3x3_plain(x, cb.rotate(w))))
    small = {"what": "outputs in fp16's subnormals"}
    x = (1e-3 * torch.randn(2, 8, 16, 64, device="cuda",
                            generator=gen)).to(f16)
    w = (1e-3 * torch.randn(3, 3, 64, 64, device="cuda",
                            generator=gen)).to(f16)
    ref = cb.conv3x3_plain(x, w)
    z = cb.conv_stats(x, w)[0]
    sc = torch.full((64,), 0.5, device="cuda")
    sh = torch.zeros(64, device="cuda")
    small.update(_bf16_within(cb.conv3x3(x, w), ref),
                 subnormal_outputs=int(((ref.abs() < 2.0 ** -14) &
                                        (ref != 0)).sum()),
                 conv_stats=_bf16_within(z, ref),
                 bn_affine=_bf16_within(cb.bn_affine(ref, sc, sh, None, False),
                                        cb.bn_affine_plain(ref, sc, sh, None,
                                                           False)))
    ok = (big["within_steps"] and big["infinite"] > 0 and
          big["sums_finite"] and big["sum_rel_err"] <= BF16_SUM_TOL and
          big["sumsq_rel_err"] <= BF16_SUM_TOL and
          big["dgrad"]["within_steps"] and small["within_steps"] and
          small["subnormal_outputs"] > 0 and
          small["conv_stats"]["within_steps"] and
          small["bn_affine"]["within_steps"])
    return {"overflow": big, "subnormal": small, "ok": ok}


def _checkout_package(root, name):
    """The ``mxnet_tpu_torch`` package of the checkout at ``root``
    imported under ``name`` beside this one: its own modules, build
    directory and kernel library (relative imports keep it inside)."""
    import importlib
    import importlib.util
    if name not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "mxnet_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(name)


def _affine_host_us_against_parent(parent):
    """Warm host µs of one bf16 ``conv_affine`` call on the ``wgmma``
    kernel ((1, 8, 16, 64→64), bf16 vectors, the same tensors each call)
    of this checkout and of the checkout at ``parent``, both packages in
    this process (the parent's under another name, on its own build), in
    turns in windows (:func:`_host_us`); → the µs of each and the
    change's over the parent's."""
    import importlib
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    _checkout_package(parent, "parent_mxnet_tpu_torch")
    pcb = importlib.import_module("parent_mxnet_tpu_torch.ops.conv_block")
    b = torch.bfloat16
    x = torch.randn(1, 8, 16, 64, device="cuda").to(b)
    w = torch.randn(3, 3, 64, 64, device="cuda").to(b)
    v = (torch.rand(64, device="cuda") + 0.5).to(b)
    same = bool(torch.equal(pcb.conv_affine(x, w, v, v, v, v),
                            cb.conv_affine(x, w, v, v, v, v)))
    us = _host_us({"parent": lambda i: pcb.conv_affine(x, w, v, v, v, v),
                   "change": lambda i: cb.conv_affine(x, w, v, v, v, v)})
    return {"shape": [1, 8, 16, 64, 64], "us": us, "outputs_equal": same,
            "parent_library": str(pcb._build.LIB_PATH),
            "change_over_parent": us["change"] / us["parent"]}


def phase_fp16_train_kernels(state):
    """The fp16 instances of rows 7 (``conv3x3``, in its dgrad use), 9
    (``conv_stats``), 10 (``bn_affine``) and 11 (``conv_wgrad``) at
    ResNet-50's four 3x3 stages at batch 128, the ``wgmma`` kernels'
    edges and the ragged C = 20 (through the wrappers to the ``mma.sync``
    kernels), and row 8 (``conv_affine``) at the converted forward's
    shapes with fp16 and with fp32 statistics, against their plain
    versions: fp16 outputs within one fp16 step (inf where the plain
    version's are), fp32 sums and dW within ``BF16_SUM_TOL``, bitwise on
    relaunch, each wrapper launching the kernel its shape takes; timed
    beside their bounds (2 bytes an element, 4 for fp32 dW and sums, fp16
    over 989 TFLOP/s dense), plain versions, the nearest fp16 library call
    and the ``wgmma`` f16 ceiling; fp16's overflow and subnormals
    (:func:`_fp16_range_cases`); the repair of a frozen segment in a half
    step, bf16 ``conv_affine`` with fp32 statistics on both of its
    kernels (``mixed_bf16``).  With ``--parent DIR``, the warm host µs of
    the bf16 ``wgmma`` ``conv_affine`` against the checkout at DIR's, in
    turns in one process."""
    import torch
    f16 = torch.float16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    names = [f"{k}_fp16_{i}" for k in ("conv3x3", "conv_stats",
                                       "conv_affine", "conv_wgrad")
             for i in ("wgmma", "mma_sync")] + ["bn_affine_fp16"]
    cases = {k: [] for k in names}
    for shape in FP16_TRAIN_SHAPES:
        for k, c in _bf16_train_conv_cases(*shape, gen, dtype=f16).items():
            cases[k].append(c)
    for N, H, W, _, C in BF16_TRAIN_STAGES:
        cases["bn_affine_fp16"].append(_bf16_affine_case(N, H, W, C, gen,
                                                         dtype=f16))
    cases["bn_affine_fp16"] += [
        _bf16_affine_case(128, 56, 56, 64, gen, residual=True, dtype=f16),
        _bf16_affine_case(128, 56, 56, 64, gen, relu=False, dtype=f16),
        _bf16_affine_case(2, 9, 11, 12, gen, residual=True, dtype=f16)]
    for shape, kw in FP16_AFFINE_CASES:
        for k, c in _conv_bf16_cases(*shape, gen, dtype=f16, **kw).items():
            cases[k].append(c)
    mixed = [c for shape in (BF16_AFFINE_SHAPES[0], (2, 9, 11, 20, 12))
             for c in _conv_bf16_cases(*shape, gen,
                                       stats_fp32=True).values()]
    state["cases"].update(cases)
    ceiling = _wgmma_ceiling(state, "f16")
    for k in ("conv3x3_fp16_wgmma", "conv_stats_fp16_wgmma",
              "conv_wgrad_fp16_wgmma", "conv_affine_fp16_wgmma"):
        for c in cases[k]:
            c["wgmma_ceiling_share"] = c["tflop_s"] / ceiling["tflop_s"]
    ranges = _fp16_range_cases(gen)
    stages = [{"shape": a["shape"], "dgrad_ms": a["kernel_ms"],
               "stats_ms": c["kernel_ms"], "wgrad_ms": b["kernel_ms"],
               "mma_sync_ms": [a["parent_ms"], c["parent_ms"],
                               b["parent_ms"]],
               "vs_library": [a["vs_library"], c["vs_library"],
                              b["vs_library"]]}
              for a, c, b in zip(cases["conv3x3_fp16_wgmma"],
                                 cases["conv_stats_fp16_wgmma"],
                                 cases["conv_wgrad_fp16_wgmma"])][:4]
    res = {"cases": cases, "mixed_bf16": mixed, "range": ranges,
           "wgmma_f16_ceiling": ceiling, "stages": stages}
    bad = [c for cs in list(cases.values()) + [mixed] for c in cs
           if not _bf16_case_ok(c)]
    taken = len(BF16_TRAIN_STAGES) + 2
    if len(cases["conv3x3_fp16_wgmma"]) != taken or \
            len(cases["conv_stats_fp16_wgmma"]) != taken or \
            len(cases["conv_wgrad_fp16_wgmma"]) != taken or \
            len(cases["conv_affine_fp16_wgmma"]) != len(FP16_AFFINE_CASES) - 2:
        bad.append("a shape the wgmma kernels should take was not taken")
    by_wrapper = [c["launched"] for k in names if k.endswith("_mma_sync")
                  for c in cases[k]].count("by the wrapper")
    if by_wrapper != 5 or [c.get("launched") for c in mixed].count(
            "by the wrapper") != 1:
        bad.append("the ragged shape did not go through the wrappers")
    if not ranges["ok"]:
        bad.append({"fp16 range": ranges})
    if state.get("parent"):
        res["affine_host_us_against_parent"] = \
            _affine_host_us_against_parent(state["parent"])
    if bad:
        raise AssertionError(f"fp16 training kernel disagrees: {bad}")
    return res


def _freeze_first_segment(net, x):
    """Set the BatchNorm of the first residual block's fused 3x3/s1
    segment (``body[4]`` of its bottleneck or basic block) to
    ``use_global_stats``, as a user fine-tuning with frozen statistics
    does, its running statistics first set to the batch statistics of
    ``x`` (one training forward with that BatchNorm's momentum 0: frozen
    at their initial 0 and 1 they would not normalize); → its name."""
    from mxnet_tpu_torch import autograd
    for name, m in net.named_modules():
        if type(m).__name__ in ("BottleneckV1", "BasicBlockV1"):
            bn = m.body[4]
            momentum, bn._momentum = bn._momentum, 0.0
            with autograd.record():
                net(x)
            bn._momentum = momentum
            bn._use_global_stats = True
            return f"{name}.body.4"
    raise AssertionError("no residual block")


def _frozen_half_step(dtype, grad_scale, batch_xy, calls=4):
    """ResNet-50 v1 at ``train_mode``'s configuration through
    ``FusedTrainStep(dtype=dtype)`` with one frozen segment
    (:func:`_freeze_first_segment`): ``calls`` calls on one fixed batch
    (capture, then replays); the captured launches, the losses, and the
    running statistics of the frozen BatchNorm (untouched)."""
    import math
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.parallel import FusedTrainStep
    from mxnet_tpu_torch.ops import conv_block as cb
    dev = torch.device("cuda")
    args = ic.parse_args(["--batch-size", str(FUSED_IMAGE_BATCH),
                          "--seed", str(SEED)])
    net, _, loss_fn = ic.build(args, dev)
    x, y = batch_xy
    frozen = _freeze_first_segment(net, x)
    step = FusedTrainStep(net, loss_fn, opt_mod.create(
        "sgd", learning_rate=args.lr, momentum=0.9, wd=1e-4), dtype=dtype,
        grad_scale=grad_scale)
    step._prepare(x)
    bn = dict(net.named_modules())[frozen]
    before = bn.running_mean.detach().clone()
    _fused_zero()
    losses = [float(step(x, y)) for _ in range(calls)]
    torch.cuda.synchronize()
    h = cb.HALF_NAMES[{"bfloat16": torch.bfloat16,
                       "float16": torch.float16}[dtype]]
    captured = step.launches_per_step
    want = {"conv_affine": 1, f"conv_affine_{h}": 1,
            f"conv_affine_{h}_wgmma": 1,
            "conv_stats": RESNET50_SEGMENTS - 1,
            "bn_affine": RESNET50_SEGMENTS - 1,
            "conv3x3": RESNET50_SEGMENTS + 1,
            "conv_wgrad": RESNET50_SEGMENTS}
    res = {"dtype": dtype, "frozen": frozen,
           "grad_scale": grad_scale, "losses": losses,
           "launches_per_step": captured, "want": want,
           "replays": step.replays,
           "frozen_stats_untouched": bool(torch.equal(
               before, bn.running_mean.detach())),
           "stats_dtype": str(bn.running_mean.dtype)[6:]}
    res["ok"] = (all(math.isfinite(v) for v in losses) and
                 all(captured.get(k, 0) == v for k, v in want.items()) and
                 res["frozen_stats_untouched"] and
                 step.programs == 1)
    del net, step
    torch.cuda.empty_cache()
    return res


def _amp_fp16_leg(state):
    """The reference's dynamic-loss-scaled fp16 training on ResNet-50 v1
    at the example's batch 64: ``amp.init("float16")`` (the matrix ops
    patched: the 3x3/s1 convs of the residual blocks take the reference's
    layer route into ``Conv3x3Fn``, rows 7 and 11 in fp16),
    ``gluon.Trainer`` (SGD) with ``amp.init_trainer`` (the scale from
    2^16), each step ``amp.scale_loss`` and ``trainer.step``; the scale's
    trajectory (the scale each step used, skipped, the scale after), the
    losses, the fp16 launches, and after ``amp.deinit()`` nothing
    patched."""
    import math
    import numpy as np
    import torch
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.ops import nn as tnn
    dev = torch.device("cuda")
    amp.init("float16")
    try:
        args = ic.parse_args(["--batch-size", str(FP16_AMP_BATCH),
                              "--seed", str(SEED)])
        net, trainer, loss_fn = ic.build(args, dev)
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        rng = np.random.RandomState(SEED + 23)
        batches = [tuple(torch.as_tensor(a, device=dev) for a in
                         ic.synthetic_batch(rng, args.batch_size,
                                            args.image_size, args.classes))
                   for _ in range(FP16_AMP_STEPS)]
        _fused_zero()
        traj, losses, ms = [], [], []
        for x, y in batches:
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(x), y)
            used = scaler.loss_scale
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward(torch.ones_like(scaled))
            trainer.step(args.batch_size)
            losses.append(float(loss.mean()))
            ms.append((time.perf_counter() - t0) * 1e3)
            traj.append({"scale": used, "skipped": scaler.loss_scale < used,
                         "scale_after": scaler.loss_scale})
        counts = {k: v for k, v in _fused_counts().items() if v}
    finally:
        amp.deinit()
    patched = [n for n in dir(tnn) if hasattr(getattr(tnn, n), "__wrapped__")]
    steps = FP16_AMP_STEPS
    want = {"conv3x3_fp16_wgmma": 2 * RESNET50_SEGMENTS * steps,
            "conv_wgrad_fp16_wgmma": RESNET50_SEGMENTS * steps}
    res = {"batch": args.batch_size, "steps": steps, "trajectory": traj,
           "skipped": sum(t["skipped"] for t in traj),
           "losses": losses, "step_ms": ms, "launches": counts,
           "want": want, "patched_after_deinit": patched,
           "first_scale": traj[0]["scale"]}
    res["ok"] = (traj[0]["scale"] == 2.0 ** 16 and not patched and
                 all(math.isfinite(v) for v in losses) and
                 all(counts.get(k, 0) == v for k, v in want.items()) and
                 not counts.get("conv_stats") and
                 not counts.get("conv_affine"))
    tot = state.setdefault("fp16_train_launches", {})
    for k, v in counts.items():
        if "_fp16" in k:
            tot[k] = tot.get(k, 0) + v
    del net, trainer
    torch.cuda.empty_cache()
    return res


def _fp16_convert_forward(state):
    """``amp.convert_model(resnet50_v1, "float16")``: the net's
    parameters and running statistics cast to fp16, its inference forward
    at batch 8 (16 ``conv_affine`` launches on the fp16 ``wgmma`` kernel,
    none other), beside the fp32 forward of the same weights on the same
    items: logits finite, top-1 agreement."""
    import math
    import numpy as np
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models import get_model
    dev = torch.device("cuda")
    net = get_model("resnet50_v1", classes=1000)
    net.initialize(ctx=dev, seed=SEED)
    net.hybridize()
    rng = np.random.RandomState(SEED + 24)
    x = torch.as_tensor(rng.rand(FP16_SERVE_BATCH, 224, 224, 3).astype(
        np.float32), device=dev)
    with torch.inference_mode():
        ref = net(x).float()
        amp.convert_model(net, "float16")
        _fused_zero()
        out = net(x.half())
        torch.cuda.synchronize()
    counts = {k: v for k, v in _fused_counts().items() if v}
    agree = (out.float().argmax(-1) == ref.argmax(-1)).float().mean().item()
    res = {"batch": FP16_SERVE_BATCH, "launches": counts,
           "top1_agreement_with_fp32": agree,
           "finite": bool(torch.isfinite(out).all()),
           "max_abs_logit_diff": (out.float() - ref).abs().max().item(),
           "logit_scale": ref.abs().max().item()}
    res["ok"] = (res["finite"] and
                 counts.get("conv_affine_fp16_wgmma") == RESNET50_SEGMENTS
                 and counts.get("conv_affine") == RESNET50_SEGMENTS and
                 math.isfinite(res["max_abs_logit_diff"]))
    tot = state.setdefault("fp16_train_launches", {})
    for k, v in counts.items():
        if "_fp16" in k:
            tot[k] = tot.get(k, 0) + v
    del net
    torch.cuda.empty_cache()
    return res


def phase_fp16_train(state):
    """fp16 training on the card: ResNet-50 v1 at ``bench.py``
    ``train_mode``'s configuration (batch 128 x 224x224x3, 1000 classes,
    SGD lr 0.1, momentum 0.9, wd 1e-4) through
    ``FusedTrainStep(dtype="float16", grad_scale=FP16_GRAD_SCALE)`` on one
    fixed batch for 21 calls (each one captured CUDA graph), beside the
    same run's bf16 step (``bf16_train``, run here when it was not);
    gates: exactly 16 launches of each of the four training kernels a
    step, all of them the fp16 instance (``wgmma`` for the three convs),
    finite losses that fall, one program, no fallback.  The same step
    with one frozen (``use_global_stats``) segment in bf16 and in fp16
    (the repair: fp32 running statistics into the half ``conv_affine``).
    The eager ``amp.init("float16")`` Trainer leg
    (:func:`_amp_fp16_leg`) and the ``amp.convert_model`` fp16 forward
    (:func:`_fp16_convert_forward`)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.parallel import FusedTrainStep
    if "bf16_image" not in state:
        phase_bf16_train(state)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    args = ic.parse_args(["--batch-size", str(FUSED_IMAGE_BATCH),
                          "--seed", str(SEED)])
    net, _, loss_fn = ic.build(args, dev)
    opt = opt_mod.create("sgd", learning_rate=args.lr, momentum=0.9,
                         wd=1e-4)
    step = FusedTrainStep(net, loss_fn, opt, dtype="float16",
                          grad_scale=FP16_GRAD_SCALE)
    rng = np.random.RandomState(SEED + 20)
    x, y = ic.synthetic_batch(rng, args.batch_size, args.image_size,
                              args.classes)
    xy = (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    r = _bf16_fused(state, "fp16_image", step, xy, FP16_IMAGE_WANT,
                    args.batch_size, "fused_image", half="fp16")
    b16 = state["bf16_image"]
    r.update(optimizer="sgd", lr=args.lr, momentum=0.9, wd=1e-4,
             image=args.image_size, classes=args.classes, dtype="float16",
             grad_scale=FP16_GRAD_SCALE,
             bf16={k: b16[k] for k in (
                 "replayed_step_ms_median", "eager_step_ms_median",
                 "items_s_replayed", "peak_mem_bytes")},
             bf16_over_fp16_step=(b16["replayed_step_ms_median"] /
                                  r["replayed_step_ms_median"]))
    r["bf16"]["idle_share"] = b16["profile_replays"].get("idle_share")
    res = {"resnet50_v1": r}
    del net, step, opt
    torch.cuda.empty_cache()
    res["frozen_segment"] = {
        "bfloat16": _frozen_half_step("bfloat16", None, xy),
        "float16": _frozen_half_step("float16", FP16_GRAD_SCALE, xy)}
    res["amp_trainer"] = _amp_fp16_leg(state)
    res["convert_model_forward"] = _fp16_convert_forward(state)
    bad = [k for k, v in res["frozen_segment"].items() if not v["ok"]]
    bad += [k for k in ("amp_trainer", "convert_model_forward")
            if not res[k]["ok"]]
    if bad:
        raise AssertionError(f"fp16 training path fails in {bad}: {res}")
    return res


def phase_fp16_train_reference(state):
    """Two fp16 ``FusedTrainStep`` SGD steps (``grad_scale``
    ``FP16_GRAD_SCALE``) on the card (captured graphs) and through the
    port on the CPU (the step function run directly) from the same
    weights and batches, and the same on the CPU in fp32: ResNet-18 v1 (10
    classes, 64x64x3, batch 2, each residual branch's last BatchNorm γ
    damped by 0.1, lr 0.01, momentum 0.9, wd 1e-4).  The card's fp16 step
    no farther from the CPU's fp16 step than that is from the CPU's fp32
    step: the losses of both steps and every master weight and running
    statistic after them."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import get_model
    rs = np.random.RandomState(SEED + 25)
    img = [(rs.rand(2, 64, 64, 3).astype(np.float32),
            rs.randint(0, 10, (2,))) for _ in range(2)]
    net = get_model("resnet18_v1", classes=10)
    net.initialize(ctx="cpu", seed=SEED)
    with torch.no_grad():
        net(torch.zeros(1, 64, 64, 3))
    arrays = {k: t.detach().numpy().copy()
              for k, t in net.collect_params().items()}
    for k in arrays:
        if k.endswith(".body.4.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
    kind = "resnet18_v1"
    card = _bf16_side(kind, torch.device("cuda"), arrays, img, "float16",
                      FP16_GRAD_SCALE)
    cpu16 = _bf16_side(kind, torch.device("cpu"), arrays, img, "float16",
                       FP16_GRAD_SCALE)
    cpu32 = _bf16_side(kind, torch.device("cpu"), arrays, img, None)
    d, floor = _bf16_dist(card, cpu16), _bf16_dist(cpu16, cpu32)
    finite = all(np.isfinite(v) for v in card[0]) and all(
        np.isfinite(t).all() for t in card[1].values())
    res = {kind: {"losses_card": card[0], "losses_cpu": cpu16[0],
                  "losses_cpu_fp32": cpu32[0], "grad_scale": FP16_GRAD_SCALE,
                  "card_vs_cpu": {"loss": d[0], "weights": d[1]},
                  "cpu_fp16_vs_fp32": {"loss": floor[0],
                                       "weights": floor[1]},
                  "finite": finite}}
    if not (finite and d[0] <= floor[0] and d[1] <= floor[1]):
        raise AssertionError(f"card fp16 step off the CPU's: {res}")
    return res


# ------------------------------------------------- Gluon BERT leftovers
SPARSE_BERT = dict(batch=8, seq=512, lr=1e-4, vocab=30522)  # FUSED_BERT's
SPARSE_STEPS = 6            # calls each way: fuse_step, then the plain loop
SPARSE_TIMED = 4            # eager steps timed each way, in turns
SPARSE_UPDATE_ITERS = 20
SPARSE_WORD_EMBED = "encoder.word_embed.weight"
# the card-vs-CPU check: two narrow layers, the full vocabulary
SPARSE_REF = dict(units=128, heads=2, layers=2, ffn=512, batch=2, seq=64,
                  steps=3)


def _sparse_word_embed(net):
    """Rebuild ``net``'s word embedding as ``Embedding(sparse_grad=True)``
    holding the same table (``bert_gluon`` builds a dense one; the
    reference's ``Embedding(sparse_grad=True)`` marks its weight
    ``row_sparse``): → the new weight."""
    import torch
    from mxnet_tpu_torch.gluon import nn
    old = net.encoder.word_embed.weight
    emb = nn.Embedding(*old.shape, sparse_grad=True)
    emb.initialize(ctx=old.device)
    with torch.no_grad():
        emb.weight.copy_(old)
    net.encoder.word_embed = emb
    return emb.weight


def _log_sparse_updates(opt):
    """Wrap ``opt.update`` so each row-sparse update it takes is recorded
    as (rows, their gradient, the key's count): → the list it fills."""
    calls = []
    update = opt.update

    def logged(index, weight, grad, state):
        t = opt._index_update_count.get(str(index),
                                        opt.begin_num_update) + 1
        calls.append((grad.indices.clone(), grad.data.clone(), t))
        return update(index, weight, grad, state)
    opt.update = logged
    return calls


def _sparse_check(opt, weight, state, before, call, tokens):
    """One step of the lazy Adam update against its definition: the rows
    it did not touch, in the table and in both moments, bit for bit as
    ``before``; the touched rows bit for bit the port's dense Adam rule
    run on a copy of just those rows (and their moments) at the key's
    count; the touched rows a subset of the batch's ids."""
    import torch
    rows, g, t = call
    w0, m0, v0 = before
    untouched = torch.ones(weight.shape[0], dtype=torch.bool,
                           device=weight.device)
    untouched[rows] = False
    after = (weight.detach(), state["mean"], state["var"])
    same = all(torch.equal(a[untouched], b[untouched])
               for a, b in zip(after, before))
    wr = w0.index_select(0, rows)
    sr = {"mean": m0.index_select(0, rows), "var": v0.index_select(0, rows)}
    opt.rule([wr], [g], [sr], opt.control(weight.device, t))
    rule = all(torch.equal(a.index_select(0, rows), b) for a, b in
               zip(after, (wr, sr["mean"], sr["var"])))
    ids = torch.unique(tokens)
    return {"touched_rows": int(rows.numel()),
            "batch_ids": int(ids.numel()), "key_count": t,
            "rows_in_batch": bool(torch.isin(rows, ids).all()),
            "untouched_bitwise": same, "touched_equal_dense_rule": rule}


def _lazy_update_times(opt_name, lr, rescale, weight, grad):
    """The lazy Adam update of the table alone (mask, ``nonzero``'s wait,
    gathers, rule, scatter) against the dense Adam update of the whole
    table, on copies, by a fresh optimizer: ms each, and their bounds
    (bytes: the dense rule reads w, g, m, v and writes w, m, v; the lazy
    one reads g once for its mask and reads and writes the touched rows of
    w, m and v)."""
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.sparse import RowSparseNDArray
    opt = opt_mod.create(opt_name, learning_rate=lr, rescale_grad=rescale)
    w = weight.detach().clone()
    st = opt.create_state("w", w)
    rs = RowSparseNDArray.from_dense(grad)
    n, (V, E) = int(rs.indices.numel()), weight.shape
    it = SPARSE_UPDATE_ITERS

    def marked_ms(fn):
        """Median CUDA-event ms a call, host waits included (a call that
        waits for the card leaves it idle while the host queues more)."""
        ms = sorted(_step_marks(fn, it)[1])
        return ms[len(ms) // 2]

    out = {
        "lazy_ms": marked_ms(lambda: opt.update(
            "w", w, RowSparseNDArray.from_dense(grad), st)),
        "mask_rows_ms": marked_ms(lambda: RowSparseNDArray.from_dense(grad)),
        "gather_rule_scatter_ms": cuda_ms(lambda: opt.update("w", w, rs, st),
                                          iters=it),
        "dense_ms": cuda_ms(lambda: opt.update("w", w, grad, st), iters=it),
        "lazy_eager_ms": eager_ms(lambda: opt.update(
            "w", w, RowSparseNDArray.from_dense(grad), st), iters=it),
        "dense_eager_ms": eager_ms(lambda: opt.update("w", w, grad, st),
                                   iters=it),
        "rows": n, "table": [V, E]}
    out["dense_bound_ms"] = bound(7 * V * E * 4, 0)[0]
    out["lazy_bound_ms"] = bound(V * E * 4 + 6 * n * E * 4, 0)[0]
    out["lazy_over_dense"] = out["lazy_ms"] / out["dense_ms"]
    return out


def _sparse_side(dev, arrays=None):
    """``SPARSE_REF``'s narrow two-layer Gluon BERT with the sparse word
    embedding, trained ``steps`` Adam steps on ``dev`` by the plain loop
    from seeded weights (or ``arrays``): → (weights before, after, the
    losses, each step's touched rows on the CPU)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, load_numpy
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon
    c = SPARSE_REF
    net = bert_gluon.BERTModel(units=c["units"], heads=c["heads"],
                               layers=c["layers"], ffn_units=c["ffn"],
                               vocab_size=SPARSE_BERT["vocab"])
    net.initialize(ctx=dev, seed=SEED)
    _sparse_word_embed(net)
    rng = np.random.RandomState(SEED + 24)
    xs = [torch.as_tensor(rng.randint(0, SPARSE_BERT["vocab"], (
        c["batch"], c["seq"])).astype(np.int32), device=dev)
        for _ in range(c["steps"])]
    with torch.no_grad():
        net(xs[0])
    if arrays is not None:
        load_numpy(net, arrays)
    before = {k: t.detach().cpu().clone()
              for k, t in net.collect_params().items()}
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": SPARSE_BERT["lr"]})
    calls = _log_sparse_updates(trainer.optimizer)
    loss_fn = SoftmaxCrossEntropyLoss()
    losses = []
    for x in xs:
        with autograd.record():
            loss = loss_fn(net(x), x)
        loss.backward(torch.ones_like(loss))
        trainer.step(c["batch"], ignore_stale_grad=True)
        losses.append(float(loss.detach().mean()))
    after = {k: t.detach().cpu() for k, t in net.collect_params().items()}
    return before, after, losses, [r.cpu() for r, _, _ in calls]


def _sparse_reference():
    """The narrow model's ``steps`` sparse Adam steps on the card against
    the port on the CPU from the same weights and batches: losses within
    1e-4 relative, every weight within 2·lr·steps (an Adam step moves an
    element by up to lr whatever its gradient's size, so a gradient near
    0 that the two devices round to opposite signs moves it 2·lr apart),
    the same rows touched each step, and the rows no step touched bit for
    bit as they started on both."""
    import torch
    b_cpu, a_cpu, l_cpu, r_cpu = _sparse_side("cpu")
    b_card, a_card, l_card, r_card = _sparse_side(
        "cuda", {k: t.numpy() for k, t in b_cpu.items()})
    tol = 2 * SPARSE_BERT["lr"] * SPARSE_REF["steps"]
    diffs = {k: (a_card[k].double() - a_cpu[k].double()).abs().max().item()
             for k in a_cpu}
    touched = torch.unique(torch.cat(r_cpu))
    untouched = torch.ones(a_cpu[SPARSE_WORD_EMBED].shape[0],
                           dtype=torch.bool)
    untouched[touched] = False
    res = {"config": SPARSE_REF, "lr": SPARSE_BERT["lr"],
           "losses_card": l_card, "losses_cpu": l_cpu,
           "loss_rel": max(abs(a - b) / abs(b)
                           for a, b in zip(l_card, l_cpu)),
           "weights_max_abs_diff": max(diffs.values()),
           "worst_weight": max(diffs, key=diffs.get),
           "weights_tol": tol,
           "rows_touched_cpu": [int(r.numel()) for r in r_cpu],
           "same_rows": len(r_cpu) == len(r_card) and all(
               torch.equal(a, b) for a, b in zip(r_cpu, r_card)),
           "untouched_rows_bitwise": all(
               torch.equal(side[SPARSE_WORD_EMBED][untouched],
                           b_cpu[SPARSE_WORD_EMBED][untouched])
               for side in (a_cpu, a_card))}
    res["ok"] = (res["loss_rel"] <= 1e-4 and res["weights_max_abs_diff"]
                 <= tol and res["same_rows"]
                 and res["untouched_rows_bitwise"])
    return res


def phase_sparse_train(state):
    """Gluon BERT-base masked-LM training with a row-sparse word
    embedding: ``FUSED_BERT``'s configuration (``bert_12_768_12``,
    vocabulary 30522, 8 x 512 tokens, fp32, Adam lr 1e-4,
    ``SoftmaxCrossEntropyLoss`` over the (8, 512, 30522) logits, each
    token its own label), the word embedding rebuilt as
    ``Embedding(sparse_grad=True)``.  From one seeded initialization,
    ``SPARSE_STEPS`` calls of ``Trainer.fuse_step(loss, net=net)`` (which
    must fall back as ``sparse_param`` and count it) then as many of the
    plain ``autograd.record`` / ``backward`` / ``trainer.step`` loop, on
    two seeded batches in turns (so rows one batch touched and the next
    did not carry moments the lazy rule must leave alone), each with
    ``ignore_stale_grad`` (without token types the token-type embedding
    takes no gradient, and the legacy step would refuse it).  Gates: the
    fallback and its counter, finite losses, each batch's last loss below
    its first, exactly 12 ``softmax_fused`` and 25 ``layernorm_fused``
    launches a forward (fp32), and after every step
    (:func:`_sparse_check`) the untouched rows of the table and of both
    moments bit for bit, the touched rows bit for bit the dense Adam rule
    on a copy of those rows.  Then, timed with CUDA events in one call:
    the eager step with the sparse embedding against the same step dense
    (in turns), and the lazy update alone against the dense Adam update
    of the table (:func:`_lazy_update_times`); and the narrow card-vs-CPU
    check (:func:`_sparse_reference`)."""
    import math
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, telemetry
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.ops.cuda_kernels import (layernorm_fused,
                                                  softmax_fused)
    cfg = SPARSE_BERT
    B, T, V = cfg["batch"], cfg["seq"], cfg["vocab"]
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = bert_gluon.bert_12_768_12(vocab_size=V)
    net.initialize(ctx=dev, seed=SEED)
    weight = _sparse_word_embed(net)
    net.hybridize()
    net.train()
    rng = np.random.RandomState(SEED + 23)
    batches = [torch.as_tensor(rng.randint(0, V, (B, T)).astype(np.int32),
                               device=dev) for _ in range(2)]
    with torch.no_grad():
        net(batches[0])                 # the deferred shapes
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": cfg["lr"]})
    opt = trainer.optimizer
    calls = _log_sparse_updates(opt)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = trainer.fuse_step(loss_fn, net=net)

    def plain_step(x):
        with autograd.record():
            loss = loss_fn(net(x), x)
        loss.backward(torch.ones_like(loss))
        trainer.step(B, ignore_stale_grad=True)
        return loss.detach().mean()

    c0 = telemetry.raw_snapshot()["counters"]
    for fn in (softmax_fused, layernorm_fused):
        fn.launches = 0
    softmax_fused.launches_by_dtype = dict.fromkeys(
        softmax_fused.launches_by_dtype, 0)
    losses, checks = [], []
    for i in range(2 * SPARSE_STEPS):
        x = batches[i % 2]
        st = trainer._states.get(SPARSE_WORD_EMBED)
        before = (weight.detach().clone(),) + (
            (st["mean"].clone(), st["var"].clone()) if st else
            (torch.zeros_like(weight), torch.zeros_like(weight)))
        loss = step(x, x, ignore_stale_grad=True) if i < SPARSE_STEPS \
            else plain_step(x)
        losses.append(float(loss))
        checks.append(_sparse_check(opt, weight,
                                    trainer._states[SPARSE_WORD_EMBED],
                                    before, calls[-1], x))
        del before
    launches = {"softmax_fused": softmax_fused.launches,
                "layernorm_fused": layernorm_fused.launches}
    fp32_softmax = softmax_fused.launches_by_dtype[torch.float32]
    c1 = telemetry.raw_snapshot()["counters"]
    delta = {k: v - c0.get(k, 0) for k, v in c1.items()
             if k.startswith("fused.") and v != c0.get(k, 0)}
    forwards = 2 * SPARSE_STEPS
    want = {"softmax_fused": BERT_SOFTMAXES * forwards,
            "layernorm_fused": BERT_LAYERNORMS * forwards}
    state["sparse_launches"] = launches
    peak = torch.cuda.max_memory_allocated()

    # the eager step sparse against dense, in turns
    def timed_step(sparse):
        if sparse:
            weight.grad_stype = "row_sparse"
        else:
            del weight.grad_stype
        t0 = time.perf_counter()
        ms = _step_marks(lambda: plain_step(batches[0]), 1)[1][0]
        wall = (time.perf_counter() - t0) * 1e3
        weight.grad_stype = "row_sparse"
        return ms, wall

    times = {"sparse": [], "dense": []}
    walls = {"sparse": [], "dense": []}
    for k in range(SPARSE_TIMED):
        for sparse in ((True, False) if k % 2 == 0 else (False, True)):
            ms, wall = timed_step(sparse)
            times["sparse" if sparse else "dense"].append(ms)
            walls["sparse" if sparse else "dense"].append(wall)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    # one dense gradient of the table, for the update alone
    with autograd.record():
        loss = loss_fn(net(batches[1]), batches[1])
    loss.backward(torch.ones_like(loss))
    grad = weight.grad.detach().clone()
    for p in net.collect_params().values():
        p.grad = None
    update = _lazy_update_times("adam", cfg["lr"], 1.0 / B, weight, grad)
    del grad
    torch.cuda.empty_cache()
    expected_rows = V * (1 - math.exp(-B * T / V))
    res = {"model": "bert_12_768_12", "optimizer": "adam", **cfg,
           "sparse_param": SPARSE_WORD_EMBED,
           "fallback_reason": step.fallback_reason, "telemetry": delta,
           "losses": losses, "steps": checks,
           "touched_rows": [c["touched_rows"] for c in checks],
           "touched_rows_expected": expected_rows,
           "touched_share": [c["touched_rows"] / V for c in checks],
           "launches": launches, "launches_expected": want,
           "softmax_fp32_launches": fp32_softmax,
           "eager_step_ms": times, "eager_step_ms_median": med,
           "eager_step_wall_ms": walls,
           "sparse_over_dense_step": med["sparse"] / med["dense"],
           "update": update, "peak_mem_bytes": peak}
    res["reference"] = _sparse_reference()
    problems = []
    if step.fallback_reason != "sparse_param" or \
            delta.get("fused.fallback.sparse_param") != SPARSE_STEPS:
        problems.append("no sparse_param fallback counted")
    if not all(math.isfinite(v) for v in losses):
        problems.append("a non-finite loss")
    if not (losses[-2] < losses[0] and losses[-1] < losses[1]):
        problems.append("a batch's loss did not fall")
    if launches != want or fp32_softmax != want["softmax_fused"]:
        problems.append("launches differ from 12 / 25 a forward")
    bad = [i for i, c in enumerate(checks) if not (
        c["untouched_bitwise"] and c["touched_equal_dense_rule"]
        and c["rows_in_batch"])]
    if bad:
        problems.append(f"lazy update off its definition at steps {bad}")
    if not res["reference"]["ok"]:
        problems.append("card off the CPU")
    if problems:
        raise AssertionError(f"{problems}: {res}")
    return res


ATT_TOL = 1e-5      # fp32 card vs CPU: of the tensor's largest magnitude
ATT_BERT = dict(L=512, B=8, H=12, D=64)              # Gluon BERT-base
ATT_LONG = dict(B=1, L=4096, H=12, D=64, w=256)      # Longformer-base
ATT_DILATED = dict(B=1, L=1024, H=12, D=64, w=128,
                   dilation=(1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4))


def _att_inputs(dev, arrays, diff, dtype=None):
    """numpy ``arrays`` as tensors on ``dev`` (floating ones in ``dtype``
    when given), those at the positions ``diff`` requiring grad."""
    import numpy as np
    import torch
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(np.asarray(a)).to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t.requires_grad_(i in diff))
    return out


def _att_case(fn, arrays, diff, seed, cpu_fn=None, iters=10):
    """``fn`` on the card and (``cpu_fn`` or ``fn``) on the port on the
    CPU from the same numpy ``arrays`` (``diff``: the positions to
    differentiate), one random cotangent: the largest |card − CPU| of
    the value and of each gradient over its largest magnitude, and the
    card's forward and forward + backward ms."""
    import numpy as np
    import torch
    card = _att_inputs("cuda", arrays, diff)
    out = fn(*card)
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(cot).cuda())
    got = [out.detach().cpu()] + [card[i].grad.cpu() for i in diff]
    if cpu_fn is not None:
        want = cpu_fn(arrays, cot)
    else:
        cpu = _att_inputs("cpu", arrays, diff)
        o = fn(*cpu)
        o.backward(torch.from_numpy(cot))
        want = [o.detach()] + [cpu[i].grad for i in diff]
    errs = [_rel(g, w) for g, w in zip(got, want)]
    del out, got, want
    plain = _att_inputs("cuda", arrays, ())
    g = torch.from_numpy(cot).cuda()

    def fwd_bwd():
        for i in diff:
            card[i].grad = None
        fn(*card).backward(g)
    with torch.no_grad():
        fwd = cuda_ms(lambda: fn(*plain), iters=iters, repeats=3)
    both = cuda_ms(fwd_bwd, iters=iters, repeats=3)
    return {"value_rel": errs[0], "grad_rel": errs[1:],
            "shape": list(cot.shape), "forward_ms": fwd,
            "forward_backward_ms": both,
            "ok": max(errs) <= ATT_TOL}


def _half_case(fn, arrays, dtype):
    """``fn`` in a half dtype on the card against the port on the CPU:
    every finite value within one step of the dtype at the larger of the
    two, or within ``ATT_TOL`` of the largest magnitude (both sides sum in
    fp32, in another order: near 0 that error exceeds a step); the
    infinite ones at the same positions with the same sign."""
    import torch
    xs = _att_inputs("cuda", arrays, (), dtype)
    card = fn(*xs).float().cpu()
    cpu = fn(*_att_inputs("cpu", arrays, (), dtype)).float()
    inf = torch.isinf(cpu)
    same_inf = torch.equal(torch.isinf(card), inf) and torch.equal(
        card[inf], cpu[inf])
    # one step of the dtype at the larger magnitude: 2^(e - p) for a
    # value m·2^e (m in [0.5, 1)) with p significand bits, at least the
    # smallest subnormal
    bits, tiny = {torch.bfloat16: (8, 2.0 ** -133),
                  torch.float16: (11, 2.0 ** -24)}[dtype]
    m = torch.maximum(card[~inf].abs(), cpu[~inf].abs())
    step = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - bits) \
        .clamp(min=tiny)
    diff = (card[~inf] - cpu[~inf]).abs()
    off = diff > torch.clamp(step, min=ATT_TOL * m.max().item())
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*xs), iters=10, repeats=3)
    return {"dtype": str(dtype).replace("torch.", ""),
            "infinite": int(inf.sum()), "same_infinite": same_inf,
            "beyond_one_step": int((diff > step).sum()),
            "beyond_tolerance": int(off.sum()),
            "max_abs_diff": diff.max().item(), "forward_ms": ms,
            "ok": same_inf and not off.any()}


def _sldwin_cpu(op, dilation, w, symmetric):
    """``op`` on the port on the CPU one head at a time (the heads are
    independent), so the (B, H, L, w_len, D) gather of a full-width
    window never lives on the host at once: → value and both gradients,
    heads concatenated."""
    def run(arrays, cot):
        import torch
        outs = [[], [], []]
        for h in range(arrays[0].shape[2]):
            ts = [torch.from_numpy(a[:, :, h:h + 1].copy())
                  .requires_grad_() for a in arrays]
            o = op(*ts, dilation[h:h + 1], w, symmetric)
            o.backward(torch.from_numpy(cot[:, :, h:h + 1].copy()))
            for k, t in enumerate((o.detach(), ts[0].grad, ts[1].grad)):
                outs[k].append(t)
        return [torch.cat(x, dim=2) for x in outs]
    return run


def phase_attention_ops(state):
    """``ops/attention.py``'s seven ops and ``ops/nn.py``'s masked pair on
    the card against the port on the CPU from the same numpy inputs,
    forward and backward (fp32 within ``ATT_TOL`` of each tensor's largest
    magnitude: sums in another order), each op's card ms (forward;
    forward + backward) beside the card's name and power limit.  The
    interleaved ops at Gluon BERT-base width (qkv (512, 8, 12·3·64);
    encoder-decoder q (512, 8, 768), kv (512, 8, 12·2·64)), the scores
    through ``masked_softmax`` and ``masked_log_softmax`` under a
    valid-length key mask; ``causal=True`` in fp32, bf16 and fp16 (one
    step of the dtype; fp16's -inf at the CPU's positions).  The
    sliding-window ops at Longformer-base width (B 1, L 4096, 12 heads
    of 64, w 256, symmetric, dilation 1; the CPU leg a head at a time)
    and dilated, one-sided at L 1024 (w 128, dilations 1-4);
    ``sldwin_atten_mask_like`` bit for bit at both."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import nn as onn
    rs = np.random.RandomState(SEED + 52)
    L, B, H, D = (ATT_BERT[k] for k in ("L", "B", "H", "D"))
    qkv = rs.randn(L, B, H * 3 * D).astype(np.float32)
    q = rs.randn(L, B, H * D).astype(np.float32)
    kv = rs.randn(L, B, H * 2 * D).astype(np.float32)
    valid = rs.randint(L // 4, L + 1, B)
    keep = np.repeat(np.arange(L)[None, :] < valid[:, None], H,
                     axis=0)[:, None, :]             # (B·H, 1, L)
    probs = rs.rand(B * H, L, L).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    scores = (rs.randn(B * H, L, L) * 3).astype(np.float32)
    cases = {}
    cases["selfatt_qk"] = _att_case(
        lambda x: att.interleaved_matmul_selfatt_qk(x, H), [qkv], (0,), 1)
    cases["selfatt_qk_causal"] = _att_case(
        lambda x: att.interleaved_matmul_selfatt_qk(x, H, causal=True),
        [qkv], (0,), 2)
    cases["selfatt_valatt"] = _att_case(
        lambda x, a: att.interleaved_matmul_selfatt_valatt(x, a, H),
        [qkv, probs], (0, 1), 3)
    cases["encdec_qk"] = _att_case(
        lambda a, b: att.interleaved_matmul_encdec_qk(a, b, H), [q, kv],
        (0, 1), 4)
    cases["encdec_valatt"] = _att_case(
        lambda b, a: att.interleaved_matmul_encdec_valatt(b, a, H),
        [kv, probs], (0, 1), 5)
    cases["masked_softmax"] = _att_case(
        lambda s, m: onn.masked_softmax(s, m), [scores, keep], (0,), 6)
    cases["masked_log_softmax"] = _att_case(
        lambda s, m: onn.masked_log_softmax(s, m), [scores, keep], (0,), 7)
    # the whole chain: scores, masked softmax, context
    cases["selfatt_chain"] = _att_case(
        lambda x, m: att.interleaved_matmul_selfatt_valatt(
            x, onn.masked_softmax(att.interleaved_matmul_selfatt_qk(x, H),
                                  m), H), [qkv, keep], (0,), 8)
    half = [_half_case(lambda x: att.interleaved_matmul_selfatt_qk(
                x, H, causal=True), [qkv], dt)
            for dt in (torch.bfloat16, torch.float16)]
    cases["selfatt_qk_causal_half"] = {"cases": half,
                                       "ok": all(c["ok"] for c in half)}
    fp16 = half[1]
    if fp16["infinite"] != B * H * L * (L - 1) // 2:
        fp16["ok"] = cases["selfatt_qk_causal_half"]["ok"] = False
    del probs, scores
    for name, c in (("long", ATT_LONG), ("dilated", ATT_DILATED)):
        Bq, Lq, Hq, Dq, w = (c[k] for k in ("B", "L", "H", "D", "w"))
        dil = np.array(c.get("dilation", (1,) * Hq), np.int64)
        sym = name == "long"
        w_len = 2 * w + 1 if sym else w + 1
        qq, kk, vv = (rs.randn(Bq, Lq, Hq, Dq).astype(np.float32)
                      for _ in range(3))
        ss = rs.randn(Bq, Lq, Hq, w_len).astype(np.float32)
        cases[f"sldwin_score_{name}"] = _att_case(
            lambda a, b: att.sldwin_atten_score(a, b, dil, w, sym),
            [qq, kk], (0, 1), 9,
            cpu_fn=_sldwin_cpu(att.sldwin_atten_score, dil, w, sym),
            iters=3)
        cases[f"sldwin_context_{name}"] = _att_case(
            lambda a, b: att.sldwin_atten_context(a, b, dil, w, sym),
            [ss, vv], (0, 1), 10,
            cpu_fn=_sldwin_cpu(att.sldwin_atten_context, dil, w, sym),
            iters=3)
        vl = np.array([Lq * 3 // 4] * Bq, np.int64)
        card = att.sldwin_atten_mask_like(torch.from_numpy(ss).cuda(), dil,
                                          vl, w, sym).cpu()
        cpu = att.sldwin_atten_mask_like(torch.from_numpy(ss), dil, vl, w,
                                         sym)
        cases[f"sldwin_mask_like_{name}"] = {
            "bitwise": torch.equal(card, cpu), "ones": int(cpu.sum()),
            "valid_length": vl.tolist(), "ok": torch.equal(card, cpu)}
        torch.cuda.empty_cache()
    res = {"card": state["card"], "bert": ATT_BERT, "long": ATT_LONG,
           "dilated": ATT_DILATED,
           "tol": ATT_TOL, "cases": cases,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"card off the CPU in {bad}: {res}")
    return res


INPUT_IMAGES = 1408         # 22 batches of 64
INPUT_HW = (375, 500)       # ImageNet's common size, height x width
INPUT_QUALITY = 90
INPUT_BATCH = 64
INPUT_ITERS = 20            # timed steps a feed, after 2 warm-up ones
INPUT_PSNR_MIN = 30.0       # nvJPEG's pixels against the source, dB
INPUT_CHECKED = 64          # images whose decode is checked
INPUT_PROFILED = 5          # steps a feed under torch.profiler


def _input_image(rs, noise):
    """A smooth field with edges and mild noise at 375 x 500: a
    low-frequency sinusoid a channel (sin(u + v) as outer products of
    its row and column terms), the right part inverted and the lower
    part's green halved (two hard edges), and a window at a random
    offset of ``noise`` (sigma 3)."""
    import numpy as np
    h, w = INPUT_HW
    x = np.arange(w, dtype=np.float32) / w
    y = np.arange(h, dtype=np.float32) / h
    f = rs.uniform(0.5, 2.0, 6)
    ph = rs.uniform(0, 2 * np.pi, 3)
    chans = []
    for c, sy in enumerate((1.0, -1.0, 1.0)):
        u = 2 * np.pi * f[2 * c] * x
        v = 2 * np.pi * sy * f[2 * c + 1] * y + ph[c]
        chans.append(128 + 90 * (np.outer(np.cos(v), np.sin(u)) +
                                 np.outer(np.sin(v), np.cos(u))))
    img = np.stack(chans, axis=-1)
    x0, y0 = rs.randint(w // 4, 3 * w // 4), rs.randint(h // 4, 3 * h // 4)
    img[:, x0:] = 255.0 - img[:, x0:]
    img[y0:, :, 1] *= 0.5
    dy = rs.randint(0, noise.shape[0] - h + 1)
    dx = rs.randint(0, noise.shape[1] - w + 1)
    img += noise[dy:dy + h, dx:dx + w]
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_input_rec(path, rs):
    """The phase's ``.rec`` / ``.idx`` pair through ``pack_img``; → (the
    first images for the decode checks, encode seconds, total seconds)."""
    from mxnet_tpu_torch import recordio
    t0 = time.perf_counter()
    enc = 0.0
    kept = []
    ih, iw = INPUT_HW
    noise = (rs.standard_normal((ih + 64, iw + 64, 3)) * 3.0).astype(
        "float32")
    w = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "w")
    for i in range(INPUT_IMAGES):
        img = _input_image(rs, noise)
        if i < INPUT_CHECKED:
            kept.append(img)
        t = time.perf_counter()
        rec = recordio.pack_img(recordio.IRHeader(0, float(i % 1000), i, 0),
                                img[:, :, ::-1], quality=INPUT_QUALITY)
        enc += time.perf_counter() - t
        w.write_idx(i, rec)
    w.close()
    return kept, enc, time.perf_counter() - t0


def _decode_checks(path, sources, lib):
    """imdecode of the first records against their sources (PSNR) and
    against a second decode of the same bytes; the native loader's 8/8
    pixels against the python tier's (bit for bit under libjpeg); under
    an OpenCV on this host, ``imresize`` against ``cv2.resize``."""
    import numpy as np
    from mxnet_tpu_torch import image, recordio
    from mxnet_tpu_torch import io as mio
    r = recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                   path, "r")
    payloads = [recordio.unpack(r.read_idx(i))[1]
                for i in range(len(sources))]
    r.close()
    psnr, twice, decoded = [], True, []
    for src, p in zip(sources, payloads):
        a, b = image.imdecode(p), image.imdecode(p)
        twice = twice and np.array_equal(a, b)
        mse = float(((a.astype(np.float64) - src) ** 2).mean())
        psnr.append(10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
        decoded.append(a)
    h, w = INPUT_HW
    s = 224
    it = mio.NativeImageRecordIter(path, (3, s, s), len(sources),
                                   preprocess_threads=2, dtype="uint8")
    nat = it.next_raw()[0]
    it.close()
    y0, x0 = (h - s) // 2, (w - s) // 2
    py = np.stack([d[y0:y0 + s, x0:x0 + s].transpose(2, 0, 1)
                   for d in decoded])
    tiers = int(np.abs(nat.astype(np.int16) - py).max())
    out = {"psnr_db_min": min(psnr), "psnr_db_mean": sum(psnr) / len(psnr),
           "decode_twice_bitwise_equal": twice,
           "native_vs_python_max_diff": tiers, "images": len(sources)}
    ok = twice and (tiers == 0 if lib == "libjpeg"
                    else min(psnr) >= INPUT_PSNR_MIN)
    try:
        import cv2
    except ImportError:
        out["opencv"] = "not on this host: imresize not held against it"
        return out, ok
    src = sources[0]
    cvres = {}
    for interp, name in ((1, "linear"), (2, "cubic")):
        for (ww, hh) in ((341, 256), (224, 224), (700, 525)):
            ours = image.imresize(src, ww, hh, interp)
            ref = cv2.resize(src, (ww, hh), interpolation=interp)
            d = np.abs(ours.astype(np.int16) - ref)
            cvres[f"{name}_{ww}x{hh}"] = {"max": int(d.max()),
                                          "share_off": float((d > 0).mean())}
    cvd = cv2.imdecode(np.frombuffer(payloads[0], np.uint8), 1)[:, :, ::-1]
    d = np.abs(cvd.astype(np.int16) - decoded[0])
    out["opencv"] = {"version": cv2.__version__, "imresize": cvres,
                     "imdecode_vs_cv2": {"max": int(d.max()),
                                         "mean": float(d.mean())}}
    ok = ok and all(v["max"] <= 1 for v in cvres.values())
    return out, ok


def _decode_rates(path):
    """Images/s of one epoch (after one warm batch) of both tiers at
    ``preprocess_threads`` 1, 2, 4 and the host's cores, no resize,
    center crop to 224: the python tier (``ImageRecordIter``: decode,
    crop, float32) and the native loader (uint8), with its stage µs."""
    from mxnet_tpu_torch import io as mio
    counts = sorted({1, 2, 4, os.cpu_count() or 1})
    out = {"python": {}, "native": {}}
    for n in counts:
        for tier in ("python", "native"):
            if tier == "python":
                it = mio.ImageRecordIter(path, (3, 224, 224), INPUT_BATCH,
                                         preprocess_threads=n)
                nxt = it.next
            else:
                it = mio.NativeImageRecordIter(path, (3, 224, 224),
                                               INPUT_BATCH,
                                               preprocess_threads=n,
                                               dtype="uint8")
                nxt = it.next_raw
            nxt()
            if tier == "native":
                it.stats_reset()
            t0 = time.perf_counter()
            k = 0
            while True:
                try:
                    nxt()
                except StopIteration:
                    break
                k += 1
            dt = time.perf_counter() - t0
            row = {"images_s": k * INPUT_BATCH / dt, "batches": k}
            if tier == "native":
                st = it.stats()
                row["stage_us_per_image"] = {
                    s: st[f"{s}_us"] / max(st["samples"], 1)
                    for s in ("read", "decode", "augment", "batchify")}
                row["decode_backend"] = st["decode_backend"]
                row["consumer_waits"] = st["consumer_waits"]
            it.close()
            out[tier][str(n)] = row
    return out


def _fed_profile(argv, dev):
    """Idle share and busy µs of ``INPUT_PROFILED`` steps of the example
    fed as ``argv`` says (a fresh net; 2 warm steps first)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(argv)
    net, trainer, loss_fn = ic.build(args, dev)
    if args.rec:
        import random
        random.seed(args.seed)
        it = ic.record_iter(args, dev)
        feed = ic.record_batches(it, dev)
    else:
        x, y = ic.synthetic_batch(np.random.RandomState(SEED),
                                  args.batch_size, args.image_size,
                                  args.classes)
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        it = None
        feed = iter(lambda: (x, y), None)

    def step():
        ic.train_step(net, trainer, loss_fn, *next(feed))

    for _ in range(ic.WARMUP):
        step()
    res = _profile(step, INPUT_PROFILED, top=3)
    if it is not None:
        it.close()
    return res


def phase_input_train(state):
    """The input path at the example's full width: a ``.rec`` written
    here, the decode held on this host, decode rates by worker count,
    ResNet-50 v1 training fed from the file (the python tier, then
    ``DataFeed``) against the synthetic feed, and ``feedcheck``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.examples import image_classification as ic
    from mxnet_tpu_torch.io import feedcheck
    info = image.decoder_info()
    work = tempfile.mkdtemp(prefix="chip_smoke_input_")
    try:
        path = os.path.join(work, "train.rec")
        kept, enc_s, write_s = _write_input_rec(
            path, np.random.RandomState(SEED))
        res = {"decoder": info,
               "rec": {"images": INPUT_IMAGES, "hw": list(INPUT_HW),
                       "quality": INPUT_QUALITY,
                       "rec_bytes": os.path.getsize(path),
                       "encode_s": enc_s, "write_s": write_s}}
        checks, ok = _decode_checks(path, kept, info["jpeg"])
        res["decode_checks"] = checks
        if not ok:
            raise AssertionError(f"decode checks failed: {checks}")
        res["decode_rates"] = _decode_rates(path)

        counted = _train_counters()
        dev = torch.device("cuda")
        base = ["--iters", str(INPUT_ITERS), "--seed", str(SEED)]
        feeds = {"synthetic": base,
                 "python_tier": base + ["--rec", path],
                 "datafeed": base + ["--rec", path, "--pipeline",
                                     "datafeed", "--resize", "256",
                                     "--rand-crop", "--rand-mirror",
                                     "--normalize"]}
        runs, launches_all = {}, {}
        for name, argv in feeds.items():
            for fn in counted:
                fn.launches = 0
            out = ic.main(argv)
            launches = {fn.__name__: fn.launches for fn in counted}
            want = dict({n: RESNET50_SEGMENTS * out["steps"]
                         for n in TRAIN_KERNELS}, conv_affine=0)
            timed = sorted(out["step_ms"][ic.WARMUP:])
            med = timed[len(timed) // 2]
            run = {"argv": argv, "steps": out["steps"],
                   "losses": out["losses"], "step_ms_median": med,
                   "images_s": out["img_s"], "launches": launches,
                   "launches_expected": want}
            if out["feed_stats"] is not None:
                st = out["feed_stats"]
                b = INPUT_BATCH
                run["feed_stats"] = st
                run["h2d_bytes_per_batch"] = \
                    st["h2d_bytes"] / max(st["staged_batches"], 1)
                run["fp32_wire_bytes_per_batch"] = b * 3 * 224 * 224 * 4 + \
                    b * 4
            if not all(math.isfinite(v) for v in out["losses"]):
                raise AssertionError(f"{name}: non-finite loss: {run}")
            if launches != want:
                raise AssertionError(f"{name}: launch counts differ from "
                                     f"the path's: {run}")
            for k, v in launches.items():
                launches_all[k] = launches_all.get(k, 0) + v
            runs[name] = run
        state["input_launches"] = launches_all
        syn = runs["synthetic"]["step_ms_median"]
        for name in ("python_tier", "datafeed"):
            runs[name]["step_ms_over_synthetic"] = \
                runs[name]["step_ms_median"] / syn
        res["train"] = runs
        res["profile"] = {name: _fed_profile(argv, dev)
                          for name, argv in feeds.items()}
        os.makedirs(os.path.join(work, "feedcheck"))
        fc = feedcheck.summary(os.path.join(work, "feedcheck"))
        res["feedcheck"] = fc
        if not fc["ok"]:
            raise AssertionError(f"feedcheck failed: {fc['checks']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# ------------------------------------------- train → checkpoint → serve
CKPT_MODEL = "resnet50_v1"  # example/gluon/image_classification.py's
CKPT_IMAGE = 224
CKPT_BATCH = 64
CKPT_WARM = 2               # fused steps before the saving ones
CKPT_STEPS = 6              # steps with a save after each
CKPT_RESUME_AT = 3          # the checkpoint the resumed runs start from
CKPT_TURNS = 4              # (no save, save) step pairs, in turns
SERVE_ITEM = (CKPT_IMAGE, CKPT_IMAGE, 3)     # the zoo's nets are NHWC
SERVE_SEQ = 16              # sequential single-item requests a leg
SERVE_CLIENTS = 8
SERVE_BURST = 16
SERVE_TOL = 1e-4            # batched vs unbatched: of the largest |logit|
SERVE_READY_S = 180.0       # a replica's import, CUDA, load and warm-up
SERVE_PROM_LINE = r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$"


def _ckpt_trainer(dev, batch=CKPT_BATCH):
    """(net, trainer, fused step): the example's ResNet-50 v1 SGD trainer
    at its defaults, seeded, through ``Trainer.fuse_step``."""
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(["--model", CKPT_MODEL, "--image-size",
                          str(CKPT_IMAGE), "--batch-size", str(batch),
                          "--seed", str(SEED)])
    net, trainer, loss_fn = ic.build(args, dev)
    return net, trainer, trainer.fuse_step(loss_fn)


def _hold_published(root, step, dst):
    """A thread that hard-links ``root``'s ``ckpt-<step>`` into the root
    ``dst`` as soon as the writer publishes it (before keep-K retention
    removes it).  → (thread, stop event, box with "ok")."""
    import shutil
    src = os.path.join(root, f"ckpt-{step:08d}")
    stop, box = threading.Event(), {"ok": False}

    def run():
        while not stop.is_set():
            if os.path.isdir(src):
                try:
                    shutil.copytree(src, os.path.join(dst, f"ckpt-{step:08d}"),
                                    copy_function=os.link)
                    box["ok"] = True
                except OSError as e:
                    box["error"] = repr(e)
                return
            time.sleep(0.002)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, stop, box


def _params_equal(a, b):
    """Names of the tensors of two name → tensor dicts that differ."""
    import torch
    return [k for k, t in a.items()
            if t.shape != b[k].shape or not torch.equal(t, b[k])]


def _median(v):
    s = sorted(v)
    return s[len(s) // 2] if s else None


CKPT_MIXED = (("w", (1 << 22,), "float32"), ("e", (512, 1024), "bfloat16"),
              ("h", (1000, 64), "float16"), ("b", (64,), "float32"))


def _mixed_card_saves(root, dev):
    """Two async saves of one tree of fp32, bf16 and fp16 card leaves
    (three snapshot buffers through the writer's one pinned buffer, the
    second save reusing it), each leaf changed in place after its save;
    both steps restored.  → {"leaves", "steps", "differ": [(step, key)
    whose restored dtype or bits are not the saved ones]}."""
    import torch
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mgr = CheckpointManager(root, keep=2, async_write=True)
    want = {}
    for s in (1, 2):
        tree = {k: torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dt)) for k, shape, dt in CKPT_MIXED}
        want[s] = {k: v.cpu() for k, v in tree.items()}
        mgr.save(tree, step=s)
        for v in tree.values():     # the snapshot, not the live tensor
            v.add_(1)
    err = mgr.wait()
    mgr.close()
    if err is not None:
        raise err
    differ = []
    for s, leaves in want.items():
        got, _, step = CheckpointManager(root).restore(step=s)
        for k, w in leaves.items():
            g = torch.as_tensor(got[k])
            if step != s or g.dtype != w.dtype or not torch.equal(g, w):
                differ.append((s, k))
    return {"leaves": [list(c) for c in CKPT_MIXED], "steps": [1, 2],
            "differ": differ}


def phase_ckpt_train(state):
    """``bench.py ckpt_mode`` at the fused ResNet-50 v1 training cell: 2
    warm steps, then 6 with ``save_trainer`` after each (keep 2, async);
    pauses, bytes, the commit's parts, the pending snapshots, restore ms,
    step ms with and without a save in turns; the step-3 checkpoint
    resumed into a fresh net and Trainer and into the live fused one
    (no rebuild), each bit for bit against the run that never stopped;
    a tree of fp32, bf16 and fp16 card leaves saved twice and restored
    bit for bit; one torn save falls back."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.examples import image_classification as ic
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, work, True)  # serve_plane may not run
    root, held = os.path.join(work, "run"), os.path.join(work, "step3")
    os.makedirs(held)
    try:
        rng = np.random.RandomState(SEED)
        batches = []
        for _ in range(CKPT_WARM + CKPT_STEPS + 2 * CKPT_TURNS):
            x, y = ic.synthetic_batch(rng, CKPT_BATCH, CKPT_IMAGE, 1000)
            batches.append((torch.as_tensor(x, device=dev),
                            torch.as_tensor(y, device=dev)))
        _fused_zero()
        c0 = telemetry.raw_snapshot()["counters"]
        net, tr, step = _ckpt_trainer(dev)
        warm = [float(step(*batches[i])) for i in range(CKPT_WARM)]
        mgr = CheckpointManager(root, keep=2, async_write=True)
        th, stop, box = _hold_published(root, CKPT_RESUME_AT, held)
        losses, pauses, pending = {}, [], []
        for i in range(1, CKPT_STEPS + 1):
            losses[i] = step(*batches[CKPT_WARM + i - 1])
            t0 = time.perf_counter()
            mgr.save_trainer(tr, step=i)
            pauses.append((time.perf_counter() - t0) * 1e6)
            pending.append(mgr.stats()["pending"])
        losses = {i: float(v) for i, v in losses.items()}
        final = _snapshot(net)
        t0 = time.perf_counter()
        err = mgr.wait()
        drain_s = time.perf_counter() - t0
        th.join(30.0)
        stop.set()
        if err is not None or not box["ok"]:
            raise AssertionError(f"saves: {err!r}; step-{CKPT_RESUME_AT} "
                                 f"checkpoint held: {box}")
        st = mgr.stats()
        saves = st["saves"]
        res = {"batch": CKPT_BATCH, "warm_losses": warm, "losses": losses,
               "pause_us": pauses, "pause_us_median": _median(pauses),
               "pause_us_max": max(pauses),
               "manager_pause_us_max": st["pause_us_max"],
               "bytes_per_save": st["bytes_written"] / saves,
               "commit_ms_per_save": {
                   "d2h": st["d2h_us_total"] / saves / 1e3,
                   "sha256": st["sha256_us_total"] / saves / 1e3,
                   "write_fsync": st["write_us_total"] / saves / 1e3},
               "pending_after_each_save": pending,
               "pending_max": max(pending),
               "pending_card_bytes_max": st["pending_bytes_max"],
               "writer_drain_s_after_loop": drain_s,
               "steps_kept": mgr.steps()}
        # restore ms (validate every shard, read the leaves)
        t0 = time.perf_counter()
        tree, meta, got = CheckpointManager(held).restore()
        res["restore_ms"] = (time.perf_counter() - t0) * 1e3
        res["restored_step"] = got
        # step ms without and with a save, in turns (into a root of
        # their own: the run's keeps its steps 5 and 6)
        mgr.close()
        mgr = CheckpointManager(os.path.join(work, "turns"), keep=2,
                                async_write=True)
        plain_ms, saving_ms = [], []
        for k in range(CKPT_TURNS):
            for saving, out in ((False, plain_ms), (True, saving_ms)):
                x, y = batches[CKPT_WARM + CKPT_STEPS + 2 * k + saving]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(x, y)
                if saving:
                    mgr.save_trainer(tr, step=100 + k)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
        res["step_ms_in_turns"] = {
            "without_save": plain_ms, "with_save": saving_ms,
            "without_save_median": _median(plain_ms),
            "with_save_median": _median(saving_ms),
            "pending_after": mgr.stats()["pending"],
            "pending_card_bytes_max": mgr.stats()["pending_bytes_max"]}
        mgr.wait()
        # resume 1: a fresh net and Trainer from the step-3 checkpoint
        resumes = {}
        net2, tr2, step2 = _ckpt_trainer(dev)
        s, meta = CheckpointManager(held).restore_trainer(tr2)
        l2 = {i: float(step2(*batches[CKPT_WARM + i - 1]))
              for i in range(s + 1, CKPT_STEPS + 1)}
        resumes["fresh"] = {"step": s, "meta": meta, "losses": l2,
                            "params_differ": _params_equal(
                                _snapshot(net2), final)}
        # resume 2: the same checkpoint into the live fused trainer
        r0 = telemetry.raw_snapshot()["counters"].get("fused.rebuilds", 0)
        s, meta = CheckpointManager(held).restore_trainer(tr)
        l1 = {i: float(step(*batches[CKPT_WARM + i - 1]))
              for i in range(s + 1, CKPT_STEPS + 1)}
        r1 = telemetry.raw_snapshot()["counters"].get("fused.rebuilds", 0)
        resumes["live"] = {"step": s, "losses": l1,
                           "params_differ": _params_equal(_snapshot(net),
                                                          final),
                           "rebuilds": r1 - r0, "programs": step.programs}
        res["resume"] = resumes
        # launches: the first call's warm-up and capture, and the replays
        counted = _fused_counts()
        real = {}
        for ex in (step, step2):
            cap = ex.launches_per_step
            for n in TRAIN_KERNELS:
                real[n] = real.get(n, 0) + ex.replays * cap.get(n, 0)
        for n in TRAIN_KERNELS:
            real[n] += counted[n] - step.launches_per_step.get(n, 0) \
                - step2.launches_per_step.get(n, 0)
        state["ckpt_launches"] = real
        res["launches"] = real
        res["launches_per_step"] = step.launches_per_step
        # card leaves of three dtypes, saved twice and restored bit for bit
        res["mixed_dtype_saves"] = _mixed_card_saves(
            os.path.join(work, "mixed"), dev)
        # one torn save falls back to the newest intact step
        os.environ["MXNET_CKPT_FAULT"] = "torn_write"
        try:
            mgr.save_trainer(tr, step=200, blocking=True)
        finally:
            os.environ.pop("MXNET_CKPT_FAULT", None)
        _, _, fell = mgr.restore()
        res["torn_write"] = {"saved": 200, "restored": fell,
                             "steps": mgr.steps()}
        mgr.close()
        c1 = telemetry.raw_snapshot()["counters"]
        res["telemetry"] = {k: v - c0.get(k, 0) for k, v in c1.items()
                            if k.startswith(("checkpoint.", "fused."))
                            and v != c0.get(k, 0)}
        # serve_plane serves the step-3 copy, then publishes the run's
        state["ckpt_roots"] = {"step3": held, "run": root, "work": work,
                               "final": final}
        problems = []
        for name, r in resumes.items():
            want = {i: losses[i] for i in r["losses"]}
            if r["step"] != CKPT_RESUME_AT or r["losses"] != want or \
                    r["params_differ"]:
                problems.append(f"resume into the {name} trainer")
        if resumes["live"]["rebuilds"] or resumes["live"]["programs"] != 1:
            problems.append("restoring into the live step rebuilt it")
        if fell != 103 or 200 not in mgr.steps():
            problems.append("the torn save did not fall back")
        if res["mixed_dtype_saves"]["differ"]:
            problems.append("a mixed-dtype card save restored other bits")
        if step.launches_per_step != {n: RESNET50_SEGMENTS
                                      for n in TRAIN_KERNELS}:
            problems.append("captured launches differ from the path's")
        if not all(math.isfinite(v) for v in losses.values()):
            problems.append("a non-finite loss")
        if problems:
            raise AssertionError(f"{problems}: {res}")
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    finally:
        torch.backends.cudnn.deterministic = det
    return res


def _http(port, method, path, body=None, timeout=120.0):
    """(status, headers, payload) of one request to 127.0.0.1:port."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _predict_body(x, model="r50"):
    return json.dumps({"model": model, "inputs": x.tolist()}).encode()


def _outputs(payload):
    """The first output's row of a one-item ``/v1/predict`` reply."""
    import numpy as np
    return np.asarray(json.loads(payload)["outputs"][0],
                      dtype=np.float32)[0]


def _spawn_replicas(root, ports, logdir):
    """One ``python -m mxnet_tpu_torch.serve`` process a port, serving
    the checkpoint root as ``r50`` on the card; output to ``logdir``."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MXNET_SERVE_FAULT", None)
    procs = []
    for p in ports:
        log = open(os.path.join(logdir, f"replica_{p}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.serve", "--model",
             f"r50={CKPT_MODEL}:{root}", "--item-shape",
             ",".join(map(str, SERVE_ITEM)), "--host", "127.0.0.1",
             "--port", str(p)], cwd=HERE, env=env, stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return procs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _lat_ms(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _pcts(v):
    s = sorted(v)
    return {"p50": s[len(s) // 2], "p99": s[min(len(s) - 1,
                                                int(0.99 * len(s)))]}


def _clients(n, fn):
    """``fn(i)`` on ``n`` threads released together: → (results, errors,
    wall s)."""
    res, errs = [None] * n, [None] * n
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait()
            res[i] = fn(i)
        except Exception as e:      # noqa: BLE001 — reported by the gate
            errs[i] = repr(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    return res, errs, time.perf_counter() - t0


def phase_serve_plane(state):
    """``ckpt_train``'s checkpoint served over HTTP: two replica
    processes on the card behind an in-process ``Router``, and an
    in-process ``InferenceServer`` over ``ModelRegistry.load(root)``;
    readiness, exactness through the router, a burst, ``/metrics``, 429,
    drain, a warm ``publish`` of the run's newest checkpoint under load,
    row 8's launches; HTTP and in-process latencies."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.parameter import load_numpy
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.serve import (InferenceServer, ModelRegistry,
                                       Router)
    from mxnet_tpu_torch.serve.chaos import _free_port, _wait_ready
    roots = state.get("ckpt_roots")
    if roots is None:
        phase_ckpt_train(state)
        roots = state["ckpt_roots"]
    logdir = tempfile.mkdtemp(prefix="chip_smoke_replicas_")
    ports = [_free_port(), _free_port()]
    procs = _spawn_replicas(roots["step3"], ports, logdir)
    servers, router, res = [], None, {"item_shape": list(SERVE_ITEM)}
    try:
        telemetry.reset()
        _fused_zero()
        forwards0 = cb.conv_affine.launches
        reg = ModelRegistry(device="cuda")
        entry = reg.load("r50", roots["step3"], arch=CKPT_MODEL,
                         item_shape=SERVE_ITEM, warmup=False)
        srv = InferenceServer(reg, port=0).start()
        servers.append(srv)
        health = [_http(srv.port, "GET", "/healthz")[:1]]
        health[0] += (json.loads(_http(srv.port, "GET",
                                       "/healthz")[2])["status"],)
        entry.engine.warmup()
        st, _, raw = _http(srv.port, "GET", "/healthz")
        health.append((st, json.loads(raw)["status"]))
        res["healthz"] = health
        t0 = time.perf_counter()
        ready = [_wait_ready(p, SERVE_READY_S) for p in ports]
        res["replicas_ready_s"] = time.perf_counter() - t0
        if not all(ready):
            raise AssertionError(f"replicas not ready: {ready}")
        router = Router([f"127.0.0.1:{p}" for p in ports], port=0,
                        probe_interval_ms=250, timeout_ms=60000).start()
        rs = np.random.RandomState(SEED)
        xs = [rs.rand(*SERVE_ITEM).astype(np.float32)
              for _ in range(SERVE_BURST)]
        # encoded once: a client's 3 MB JSON encode holds the GIL that
        # the in-process server and router need
        bodies = [_predict_body(x) for x in xs]
        # sequential single items through the router against the
        # in-process registry at the same bucket (1)
        seq, seq_err = [], 0.0
        for x, body in zip(xs[:SERVE_SEQ], bodies):
            st, _, payload = router.forward(body)
            mine = reg.predict("r50", x)[0][0]
            got = _outputs(payload) if st == 200 else np.full_like(
                mine, np.nan)
            seq.append(bool(np.array_equal(got, mine)))
            seq_err = max(seq_err, float(np.abs(got - mine).max()))
        res["router_sequential_bitwise"] = seq
        res["router_sequential_max_abs_err"] = seq_err
        # the wire's host cost at one item
        body = bodies[0]
        enc = _lat_ms(lambda: _predict_body(xs[0]), 10)
        dec = _lat_ms(lambda: np.asarray(json.loads(body)["inputs"],
                                         dtype=np.float32), 10)
        res["json_body_bytes"] = len(body)
        res["json_encode_ms_median"] = _median(enc)
        res["json_decode_ms_median"] = _median(dec)
        # latency at 1 and at SERVE_CLIENTS clients through the router
        lat1 = _lat_ms(lambda: router.forward(body), SERVE_SEQ)
        res["http_1_client_ms"] = _pcts(lat1)
        per = SERVE_SEQ // 2

        def client(i):
            return _lat_ms(lambda: router.forward(body), per)

        got, errs, wall = _clients(SERVE_CLIENTS, client)
        lat8 = [v for g in got if g for v in g]
        res["http_8_clients_ms"] = _pcts(lat8)
        res["http_8_clients_items_s"] = SERVE_CLIENTS * per / wall
        res["http_8_clients_errors"] = [e for e in errs if e]
        inproc = _lat_ms(lambda: reg.predict("r50", xs[0]), SERVE_SEQ)
        res["in_process_predict_ms"] = _pcts(inproc)
        res["http_over_in_process_p50"] = \
            res["http_1_client_ms"]["p50"] / res["in_process_predict_ms"]["p50"]
        # a burst of single items through the router against the
        # unbatched forward
        got, errs, _ = _clients(SERVE_BURST, lambda i: router.forward(
            bodies[i]))
        burst = {"errors": [e for e in errs if e], "max_rel_err": 0.0,
                 "argmax_agree": 0, "argmax_checked": 0}
        for i, r in enumerate(got):
            if r is None or r[0] != 200:
                burst["errors"].append(f"{i}: {r and r[0]}")
                continue
            out = _outputs(r[2])
            ref = entry.engine.run(xs[i][None])[0].float().cpu().numpy()[0]
            scale = float(np.abs(ref).max())
            burst["max_rel_err"] = max(burst["max_rel_err"], float(
                np.abs(out - ref).max()) / scale)
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > SERVE_TOL * scale:
                burst["argmax_checked"] += 1
                burst["argmax_agree"] += int(out.argmax() == ref.argmax())
        res["burst"] = burst
        st, _, prom = _http(router.port, "GET", "/metrics")
        st2, _, prom2 = _http(srv.port, "GET", "/metrics")
        bad = [ln for text in (prom, prom2)
               for ln in text.decode().splitlines()
               if ln and not ln.startswith("#")
               and not re.match(SERVE_PROM_LINE, ln)]
        res["metrics"] = {"router_lines": len(prom.splitlines()),
                          "server_lines": len(prom2.splitlines()),
                          "malformed": bad[:5]}
        # drain / undrain of the in-process server
        drain = [_http(srv.port, "POST", "/admin/drain")[0]]
        st, _, raw = _http(srv.port, "GET", "/healthz")
        drain.append((st, json.loads(raw)["status"]))
        st, h, _ = _http(srv.port, "POST", "/v1/predict", body)
        drain.append((st, float(h.get("Retry-After", 0)) > 0))
        drain.append(_http(srv.port, "POST", "/admin/undrain")[0])
        drain.append(_http(srv.port, "GET", "/healthz")[0])
        drain.append(_http(srv.port, "POST", "/v1/predict", body)[0])
        res["drain"] = drain
        # publish the run's newest intact checkpoint during a burst
        before = reg.predict("r50", xs[0])[0]
        pub = {}

        def publisher():
            time.sleep(0.2)
            t0 = time.perf_counter()
            reg.publish("r50", roots["run"], arch=CKPT_MODEL,
                        item_shape=SERVE_ITEM)
            pub["s"] = time.perf_counter() - t0

        pth = threading.Thread(target=publisher)
        pth.start()
        got, errs, _ = _clients(SERVE_BURST, lambda i: [
            _http(srv.port, "POST", "/v1/predict", bodies[i])[0]
            for _ in range(4)])
        pth.join(300.0)
        after = reg.predict("r50", xs[0])[0]
        launches = cb.conv_affine.launches - forwards0
        fwd = entry.engine.forwards + reg.get("r50").engine.forwards
        state["serve_plane_launches"] = {"conv_affine": launches}
        res["conv_affine"] = {"launches": launches, "forwards": fwd,
                              "per_forward": launches / max(fwd, 1)}
        ref_net = get_model(CKPT_MODEL)
        load_numpy(ref_net, {k: v.cpu() for k, v in roots["final"].items()})
        check = ModelRegistry(device="cuda")
        check.register("r50", ref_net, SERVE_ITEM)
        want = check.predict("r50", xs[0])[0]
        check.close()
        statuses = [s for g in got if g for s in g]
        res["publish"] = {
            "publish_s": pub.get("s"), "requests": len(statuses),
            "non_200": [s for s in statuses if s != 200] +
                       [e for e in errs if e],
            "changed": not np.array_equal(before, after),
            "serves_the_new_weights": bool(np.array_equal(after, want)),
            "swaps": telemetry.raw_snapshot()["counters"].get(
                "serve.swaps", 0)}
        # a bounded queue sheds with 429 + Retry-After
        res["shed"] = _shed_429()
        res["router"] = router.stats()
        problems = []
        if [h[0] for h in health] != [503, 200] or \
                health[0][1] != "warming":
            problems.append("healthz did not go warming → ok")
        if not all(seq):
            problems.append("router outputs differ from in-process predict")
        if burst["errors"] or burst["max_rel_err"] > SERVE_TOL or \
                burst["argmax_agree"] != burst["argmax_checked"]:
            problems.append("the burst disagrees with the unbatched forward")
        if res["http_8_clients_errors"]:
            problems.append("errors at 8 clients")
        if bad:
            problems.append("/metrics is not Prometheus text")
        if drain != [200, (503, "draining"), (503, True), 200, 200, 200]:
            problems.append("drain / undrain")
        p = res["publish"]
        if p["non_200"] or not p["changed"] or \
                not p["serves_the_new_weights"] or p["swaps"] != 1:
            problems.append("publish lost requests or weights")
        if launches != RESNET50_SEGMENTS * fwd:
            problems.append("conv_affine launches differ from 16 a forward")
        if not res["shed"]["ok"]:
            problems.append("no 429 with Retry-After")
        if problems:
            raise AssertionError(f"{problems}: {res}")
        reg.close()
    except BaseException:
        for p in ports:
            path = os.path.join(logdir, f"replica_{p}.log")
            if os.path.exists(path):
                with open(path) as f:
                    print(f"--- replica {p}:\n{f.read()[-3000:]}",
                          file=sys.stderr)
        raise
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        _stop(procs)
        shutil.rmtree(logdir, ignore_errors=True)
        shutil.rmtree(roots["work"], ignore_errors=True)
    return res


def _shed_429():
    """A model behind a queue of 2 items whose batches take 300 ms (the
    batcher's delay fault): 6 concurrent requests, some shed with 429
    and a Retry-After."""
    import numpy as np
    from mxnet_tpu_torch.serve import InferenceServer, ModelRegistry
    from mxnet_tpu_torch.serve.bench import _build_model
    import mxnet_tpu_torch as mx
    mx.seed(SEED)
    net, item = _build_model("mlp")
    net.initialize(ctx="cuda")
    reg = ModelRegistry(queue_depth=2, max_wait_ms=1, device="cuda")
    reg.register("mlp", net, item, buckets=(1,))
    srv = InferenceServer(reg, port=0).start()
    os.environ["MXNET_SERVE_FAULT"] = "batcher:delay:1.0:300"
    try:
        body = _predict_body(np.zeros(item, np.float32), "mlp")
        got, _, _ = _clients(6, lambda i: _http(srv.port, "POST",
                                                "/v1/predict", body))
    finally:
        os.environ.pop("MXNET_SERVE_FAULT", None)
        srv.stop(close_registry=True)
    codes = [g[0] for g in got if g]
    shed = [g for g in got if g and g[0] == 429]
    return {"codes": codes, "ok": bool(shed) and all(
        float(g[1].get("Retry-After", 0)) > 0 for g in shed) and
        set(codes) <= {200, 429}}


def phase_chaos(state):
    """``resilience_bench()`` at the reference's defaults with its
    replicas on the card (the seeded mlp, a SIGKILL mid-load, a respawn),
    then ``serve_bench()`` on ``mlp`` and on ResNet-50 v1, 5 s each."""
    from mxnet_tpu_torch.serve import bench, chaos
    res = {"resilience": chaos.resilience_bench(verbose=False)}
    rows = {}
    for model in ("mlp", "resnet50_v1"):
        os.environ["BENCH_SERVE_MODEL"] = model
        os.environ["BENCH_SERVE_S"] = "5"
        try:
            rows[model] = bench.serve_bench()
        finally:
            os.environ.pop("BENCH_SERVE_MODEL", None)
            os.environ.pop("BENCH_SERVE_S", None)
    res["serve_bench"] = rows
    r = res["resilience"]
    if "error" in r or not r.get("ok"):
        raise AssertionError(f"resilience gate: {r}")
    for model, row in rows.items():
        if not row["completed"] or row["completed"] != row["submitted"]:
            raise AssertionError(f"serve_bench {model}: {row}")
    return res


CALIB_BATCH = 32            # the observed scoring's batch
CALIB_IMAGE = 224
CALIB_BATCHES = 4
CALIB_AGREE_N = 64          # seeded images of the int8-vs-fp32 agreement
CALIB_WARMUP = 3
CALIB_ITERS = 10
CALIB_LAYERS = 54           # ResNet-50 v1's quantizable layers (53 + dense)
CALIB_TOL = 1e-6            # naive threshold: the amax gauge's resolution
OBS_BATCH = 64              # the training cell's batch
OBS_IMAGE = 224
OBS_RECORDS = 4096          # 64 shards an epoch: a pipeline restart in 8 s
OBS_WORKERS = 4             # two: ~7.4 batches/s, an H100 step 8.3/s
OBS_ALONE_STEPS = 10


def _store_roundtrip(work, params):
    """The seeded weights through the model store: published and loaded,
    then the store emptied and the weights downloaded from a ``file://``
    mirror; a corrupted store copy refused.  → (net from the mirror, the
    record)."""
    import numpy as np
    from mxnet_tpu_torch.models import get_model, model_store
    store = os.path.join(work, "store")
    mirror = os.path.join(work, "mirror")
    with np.load(params) as z:
        want = {k: z[k] for k in z.files}

    def same(net):
        got = {k: t.detach().cpu().numpy()
               for k, t in net.collect_params().items()}
        return set(got) == set(want) and all(
            np.array_equal(got[k], want[k]) for k in want)

    rec = {"published": model_store.publish_model_file(
        "resnet50_v1", params, root=store)}
    rec["sha1"] = model_store._model_sha1["resnet50_v1"]
    rec["local_equal"] = same(get_model("resnet50_v1", pretrained=True,
                                        root=store))
    model_store.publish_model_file("resnet50_v1", params, root=mirror)
    model_store.purge(root=store)
    os.environ["MXNET_GLUON_REPO"] = "file://" + mirror
    try:
        net = get_model("resnet50_v1", pretrained=True, root=store)
        path = model_store.get_model_file("resnet50_v1", root=store)
        rec["downloaded"] = os.path.dirname(path) == \
            os.path.join(store, "models")
        rec["mirror_equal"] = same(net)
        with open(path, "r+b") as f:        # one flipped bit
            f.seek(4096)
            b = f.read(1)
            f.seek(4096)
            f.write(bytes([b[0] ^ 1]))
        try:
            model_store.get_model_file("resnet50_v1", root=store)
            rec["corrupt_refused"] = None
        except OSError as e:
            rec["corrupt_refused"] = str(e)[:200]
    finally:
        os.environ.pop("MXNET_GLUON_REPO", None)
    return net, rec


def _agreement(ref, fn, images):
    """Share of the images (batches) whose argmax under ``fn`` is
    ``ref``'s (the fp32 argmaxes, one tensor a batch)."""
    import torch
    agree = total = 0
    with torch.inference_mode():
        for a, x in zip(ref, images):
            b = torch.as_tensor(fn(x)).to(a.device)
            if not torch.isfinite(b).all():
                raise AssertionError("int8 logits not finite")
            agree += int((a == b.argmax(-1)).sum())
            total += a.numel()
    return agree / total


def phase_int8_calib(state):
    """Store → observed scoring → thresholds from telemetry → int8 (see
    the module docstring, phase 57)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch import quantization as q
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import ModelRegistry
    qk, ca = _int8_counters()
    work = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        params = os.path.join(work, "resnet50_v1.params")
        _resnet50_params(params)
        net, store = _store_roundtrip(work, params)
        net = net.to("cuda").eval()
        telemetry.set_enabled(True)
        rs = np.random.RandomState(SEED + 26)
        batches = [torch.as_tensor(
            rs.rand(CALIB_BATCH, CALIB_IMAGE, CALIB_IMAGE, 3).astype(np.float32),
            device="cuda") for _ in range(CALIB_BATCHES)]
        images = [torch.as_tensor(
            rs.rand(CALIB_BATCH, CALIB_IMAGE, CALIB_IMAGE, 3).astype(np.float32),
            device="cuda") for _ in range(CALIB_AGREE_N // CALIB_BATCH)]
        sites = [p for _, c, p in q._walk(net)
                 if isinstance(c, q._QUANTIZABLE)]

        def scoring():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                for x in batches:
                    net(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / len(batches)

        scoring()                                       # warm
        plain_ms = scoring()
        h0 = telemetry.raw_snapshot()["histograms"]
        ca.launches = 0
        handle = q.observe_activations(net)
        try:
            observed_ms = scoring()
            forward_launches = ca.launches
            syncs = handle.syncs
            h1 = telemetry.raw_snapshot()["histograms"]
            # the same inputs again, quantize_net's own collector beside
            # the hooks (the kernels relaunch bit for bit, so the running
            # maxima do not move)
            direct = q._Collector("naive")
            one = q._observe_one

            def both(h, path, x, sample):
                direct.add(path, x)
                one(h, path, x, sample)
            q._observe_one = both
            try:
                with torch.inference_mode():
                    for x in batches:
                        net(x)
            finally:
                q._observe_one = one
        finally:
            handle.remove()
        acts = sum(h1[k]["count"] - h0.get(k, {}).get("count", 0)
                   for k in h1 if k.startswith("quant.act."))
        gauges = telemetry.raw_snapshot()["gauges"]
        th = q.thresholds_from_telemetry(layers=set(sites))
        the = q.thresholds_from_telemetry(layers=set(sites),
                                          mode="entropy")
        naive_err = {p: abs(th[p] - float(direct.amax[p])) for p in sites
                     if p in th and p in direct.amax}
        res = {"store": store, "layers": len(sites),
               "gauged": sum(f"quant.amax.{p}" in gauges for p in sites),
               "observed_ms": observed_ms, "plain_ms": plain_ms,
               "hook_host_ms": observed_ms - plain_ms,
               "host_syncs_per_batch": syncs / len(batches),
               "act_observations_per_batch": acts / len(batches),
               "conv_affine_per_forward": forward_launches / len(batches),
               "naive_max_err": max(naive_err.values()) if naive_err
               else None,
               "entropy_over_amax_max": max(the[p] / th[p] for p in sites),
               "entropy_over_amax_min": min(the[p] / th[p] for p in sites)}
        launches = {"conv_affine": forward_launches}

        # int8: the telemetry thresholds, and int8_score's direct naive
        # calibration on the same batches, each against fp32
        with torch.inference_mode():
            ref = [net(x).argmax(-1) for x in images]
        tel = q.quantize_net(_load_resnet50(params, "cuda"),
                             thresholds=th)
        reg = ModelRegistry(device="cuda", precision="int8")
        entry = reg.register("r50_int8", tel, (CALIB_IMAGE, CALIB_IMAGE, 3),
                             buckets=(CALIB_BATCH,))
        qk.launches = ca.launches = 0
        try:
            agree_tel = _agreement(
                ref, lambda x: reg.predict("r50_int8", x.cpu().numpy())[0],
                images)
        finally:
            reg.close()
        x = batches[0]
        with torch.inference_mode():
            for _ in range(CALIB_WARMUP):
                tel(x)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALIB_ITERS):
                tel(x)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / CALIB_ITERS
        int8_forwards = len(images) + CALIB_WARMUP + CALIB_ITERS
        launches["qconv3x3_affine"] = qk.launches
        int8_affine = ca.launches
        direct_net = q.quantize_net(
            _load_resnet50(params, "cuda"), calib_data=batches,
            calib_mode="naive")
        agree_direct = _agreement(ref, direct_net, images)
        res.update({
            "int8": {"ms_per_batch": ms,
                     "images_s": CALIB_BATCH / (ms * 1e-3),
                     "argmax_agreement_vs_fp32": agree_tel,
                     "direct_calibration_agreement": agree_direct,
                     "int8_score_agreement": state.get(
                         "int8_score_agreement"),
                     "agreement_images": CALIB_AGREE_N,
                     "qconv_per_forward":
                         launches["qconv3x3_affine"] / int8_forwards,
                     "conv_affine_launches": int8_affine,
                     "twins": sum(isinstance(b, q._Twin)
                                  for b in tel.modules()),
                     "served_precision": entry.engine.precision},
            "launches": launches})
        state["int8_calib_launches"] = launches
        problems = []
        if not (store["local_equal"] and store["mirror_equal"] and
                store["downloaded"] and store["corrupt_refused"] and
                "sha1 does not match" in store["corrupt_refused"]):
            problems.append("model store")
        if forward_launches != RESNET50_SEGMENTS * len(batches):
            problems.append("row 8 launches of the observed forward")
        if len(sites) != CALIB_LAYERS or res["gauged"] != CALIB_LAYERS:
            problems.append("layers without a quant.amax gauge")
        if len(naive_err) != CALIB_LAYERS or \
                res["naive_max_err"] > CALIB_TOL:
            problems.append("naive thresholds against the direct max |x|")
        if res["entropy_over_amax_max"] > 1.0:
            problems.append("an entropy threshold above its amax")
        if launches["qconv3x3_affine"] != \
                RESNET50_SEGMENTS * int8_forwards or int8_affine or \
                res["int8"]["twins"] != CALIB_LAYERS:
            problems.append("int8 forward launches")
        if agree_tel < agree_direct:
            problems.append("agreement below the direct calibration's")
        if problems:
            raise AssertionError(f"{problems}: {res}")
        del tel, direct_net, net, batches, images, ref
        torch.cuda.empty_cache()
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _fed_launches(step):
    """The real launches of a fused executor's kernels since the counters
    were zeroed: the first call's warm-up and the replays times the
    captured counts."""
    counted = _fused_counts()
    cap = step.launches_per_step
    return {n: counted[n] - cap.get(n, 0) + step.replays * cap.get(n, 0)
            for n in TRAIN_KERNELS}


def _fed_ok(step, launches, replays):
    """16 launches of each training kernel a captured step, and the
    real count: the first call's warm-up and ``replays`` replays."""
    return step.launches_per_step == {n: RESNET50_SEGMENTS
                                      for n in TRAIN_KERNELS} and \
        all(launches[n] == RESNET50_SEGMENTS * (replays + 1)
            for n in TRAIN_KERNELS)


def _fault_window(out):
    """The recorder's windows from 2 s before the baseline to 2 s after
    the rule cleared (all of them when the check stopped early), their
    times from the baseline's start."""
    tl, marks = out.get("timeline") or [], out.get("marks")
    if not marks:
        return tl
    t0 = marks["base"]
    return [[round(w[0] - t0, 3)] + w[1:] for w in tl
            if t0 - 2.0 <= w[0] <= marks["cleared"] + 2.0]


def phase_obs_fleet(state):
    """``obs.check.check`` at full width (see the module docstring, phase
    58)."""
    import torch
    from mxnet_tpu_torch.obs import check as oc
    os.environ["MXNET_OBS_PEAK_FLOPS"] = repr(PEAK_FP32_FLOP_S)
    dev = torch.device("cuda")
    net, _trainer, step = _ckpt_trainer(dev, batch=OBS_BATCH)
    _fused_zero()
    try:
        out = oc.check(verbose=True, device="cuda",
                       spec=f"synthetic:{OBS_BATCH}x3x{OBS_IMAGE}x{OBS_IMAGE}:1000:"
                            f"{OBS_RECORDS}",
                       workers=OBS_WORKERS, trainer=(net, step),
                       layout="NHWC")
    finally:
        os.environ.pop("MXNET_OBS_PEAK_FLOPS", None)
    launches = _fed_launches(step)
    replays = step.replays
    state["obs_fleet_launches"] = launches
    # the same step alone: no fleet, one batch on the card
    gen = torch.Generator(device="cuda").manual_seed(SEED + 58)
    x = torch.rand(OBS_BATCH, OBS_IMAGE, OBS_IMAGE, 3, device="cuda", generator=gen)
    y = torch.randint(0, 1000, (OBS_BATCH,), device="cuda", generator=gen)
    _, alone = _step_marks(lambda: step(x, y), OBS_ALONE_STEPS)
    rep = out.get("report", {})
    res = {"checks": out["checks"], "failures": out["failures"],
           "fault_ms": out["fault_ms"], "stall": out["stall"],
           "step_ms_in_fleet": out.get("step_ms"),
           "step_p50_ms_in_fleet": out.get("step_p50_ms"),
           "step_ms_alone": _median(alone), "mfu": out.get("mfu"),
           "mfu_report": rep.get("signals", {}).get("mfu"),
           "peak_flops": PEAK_FP32_FLOP_S,
           "goodput": out.get("goodput"), "signals": out.get("signals"),
           "frames": out.get("frames"),
           "dropped_frames": out.get("dropped_frames"),
           "train_steps": out.get("train_steps"),
           "events": [(e["rule"], e["event"], e.get("value"))
                      for e in out.get("events", [])],
           "roles": {r: v.get("nonzero_rates")
                     for r, v in rep.get("roles", {}).items()},
           "breakdown": rep.get("breakdown"),
           "feed": {k: v for k, v in out.get("feed_stats", {}).items()
                    if k != "workers"},
           "seconds": out.get("seconds"), "marks": out.get("marks"),
           "timeline": _fault_window(out),
           "replays": replays, "launches": launches,
           "launches_per_step": step.launches_per_step}
    state["obs_trainer"] = (net, step)
    if out["failures"] or not _fed_ok(step, launches, replays):
        raise AssertionError(f"obs fleet: {res}")
    return res


def phase_trace_check(state):
    """``tracecheck._selfcheck`` on the card (see the module docstring,
    phase 59)."""
    import torch
    from mxnet_tpu_torch import tracecheck
    trainer = state.get("obs_trainer")
    if trainer is None:
        net, _trainer, step = _ckpt_trainer(torch.device("cuda"),
                                            batch=OBS_BATCH)
        trainer = (net, step)
    step = trainer[1]
    _fused_zero()
    replays0 = step.replays
    out = {}
    rc = tracecheck._selfcheck(
        verbose=True, device="cuda", trainer=trainer,
        spec=f"synthetic:{OBS_BATCH}x3x{OBS_IMAGE}x{OBS_IMAGE}:1000:"
             f"{OBS_BATCH * tracecheck.FED_STEPS}",
        layout="NHWC", result=out)
    counted = _fused_counts()
    cap = step.launches_per_step
    fresh = replays0 == 0           # this phase made the capture
    launches = {n: counted[n] - (cap.get(n, 0) if fresh else 0) +
                (step.replays - replays0) * cap.get(n, 0)
                for n in TRAIN_KERNELS}
    state["trace_check_launches"] = launches
    state.pop("obs_trainer", None)
    res = {"rc": rc, "checks": out.get("checks"),
           "routed_traces": out.get("routed_traces"),
           "fed_traces": out.get("fed_traces"),
           "execute_spans": out.get("execute_spans"),
           "merged_spans": out.get("merged_spans"),
           "nesting_violations": out.get("nesting_violations"),
           "feed_leg": out.get("feed_leg"), "launches": launches,
           "replays": step.replays - replays0}
    steps = step.replays - replays0
    want = RESNET50_SEGMENTS * (steps + (1 if fresh else 0))
    if rc != 0 or steps != tracecheck.FED_STEPS or \
            any(launches[n] != want for n in TRAIN_KERNELS):
        raise AssertionError(f"trace check: {res}")
    return res


KERNELS = [
    ("layernorm_fused", "mxnet_tpu_torch/csrc/layernorm.cu",
     "mxnet_tpu/ops/pallas_kernels.py:104"),
    ("causal_attention", "mxnet_tpu_torch/csrc/causal_attention.cu",
     "mxnet_tpu/ops/pallas_attention.py:203"),
    ("attention_fwd", "mxnet_tpu_torch/csrc/flash_fwd_tc.cu",
     "mxnet_tpu/ops/pallas_kernels.py:167"),
    ("attention_dq", "mxnet_tpu_torch/csrc/flash_bwd_tc.cu",
     "mxnet_tpu/ops/pallas_kernels.py:283"),
    ("attention_dkv", "mxnet_tpu_torch/csrc/flash_bwd_tc.cu",
     "mxnet_tpu/ops/pallas_kernels.py:309"),
    ("conv_affine", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv3x3", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_stats", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("bn_affine", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:367"),
    ("conv_wgrad", "mxnet_tpu_torch/csrc/conv_wgrad.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("softmax_fused", "mxnet_tpu_torch/csrc/softmax.cu",
     "mxnet_tpu/ops/pallas_kernels.py:61"),
    ("qconv3x3_affine", "mxnet_tpu_torch/csrc/qconv_affine.cu",
     "mxnet_tpu/ops/pallas_int8.py:197"),
    ("tvm_vadd", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("tvm_vmul", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("tvm_sigmoid", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("rtc_axpy", "mxnet_tpu_torch/examples/rtc_kernels.cu",
     "mxnet_tpu/rtc.py:35"),
    ("softmax_fused_bf16", "mxnet_tpu_torch/csrc/softmax.cu",
     "mxnet_tpu/ops/pallas_kernels.py:61"),
    ("conv_affine_bf16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv3x3_bf16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_stats_bf16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("bn_affine_bf16", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:367"),
    ("conv_wgrad_bf16_mma_sync", "mxnet_tpu_torch/csrc/conv_wgrad.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("conv3x3_bf16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_wgrad_bf16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("conv_stats_bf16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("conv_affine_bf16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv3x3_fp16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv3x3_fp16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_stats_fp16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("conv_stats_fp16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("conv_affine_fp16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv_affine_fp16_mma_sync", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv_wgrad_fp16_wgmma", "mxnet_tpu_torch/csrc/conv_bf16_wgmma.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("conv_wgrad_fp16_mma_sync", "mxnet_tpu_torch/csrc/conv_wgrad.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("bn_affine_fp16", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:367"),
]
# what else an entry names: the header holding the body two attention
# entries share, the kernels of a stream-K entry (main, then the one that
# finishes the cut tiles), the registered Pallas body a generated kernel
# replaces, the module that compiles and launches the rtc route
KERNEL_NOTES = {
    "conv_affine": {"kernels": ["conv_affine_tc_kernel",
                                "conv_affine_reduce_kernel"],
                    "loop": "conv_ranges, shared with conv3x3 and "
                            "conv_stats"},
    "qconv3x3_affine": {"kernels": ["qconv_affine_kernel",
                                    "qconv_reduce_kernel"]},
    "causal_attention": {"kernel_body": "mxnet_tpu_torch/csrc/"
                                        "flash_fwd_tc.cuh"},
    "attention_fwd": {"kernel_body": "mxnet_tpu_torch/csrc/"
                                     "flash_fwd_tc.cuh"},
    "attention_dq": {"kernels": ["flash_dq_tc"],
                     "arithmetic": "3xTF32 on the tensor cores"},
    "attention_dkv": {"kernels": ["flash_dkv_tc"],
                      "arithmetic": "3xTF32 on the tensor cores"},
    "softmax_fused": {"kernels": ["softmax_warp_kernel",
                                  "softmax_cluster_kernel",
                                  "softmax_block_kernel"],
                      "prologue": "x / sqrt(64) folded into the load",
                      "library": "torch.softmax on the prologue's result "
                                 "(it neither divides nor masks)"},
    "tvm_vadd": {"body": "mxnet_tpu/tvmop.py:119", "compiler": "nvrtc"},
    "tvm_vmul": {"body": "mxnet_tpu/tvmop.py:124", "compiler": "nvrtc"},
    "tvm_sigmoid": {"body": "mxnet_tpu/tvmop.py:138", "compiler": "nvrtc"},
    "rtc_axpy": {"body": "tests/test_pallas_rtc.py:85",
                 "launcher": "mxnet_tpu_torch/rtc.py", "compiler": "nvrtc"},
    "softmax_fused_bf16": {"instance": "bf16 (cases: bf16, then fp16)",
                           "kernels": ["softmax_warp_kernel",
                                       "softmax_cluster_kernel",
                                       "softmax_block_kernel"],
                           "prologue": "x / sqrt(64) and the key mask, "
                                       "rounded to bf16 in the load",
                           "library": "torch.softmax on bf16 on the "
                                      "prologue's result"},
    "conv_affine_bf16_mma_sync": {
        "instance": "bf16 shapes the wgmma kernel does not take (C or "
                    "Cout not a multiple of 8, unaligned); timed at the "
                    "path shapes by a direct launch",
        "kernels": ["conv_affine_bf16_kernel",
                    "conv_affine_bf16_reduce_kernel"],
        "arithmetic": "mma.sync m16n8k16 bf16, fp32 sums",
        "loop": "conv_ranges, shared with the fp32 instances"},
    "conv3x3_bf16_mma_sync": {
        "instance": "bf16 shapes the wgmma kernel does not take (C or "
                    "Cout not a multiple of 8, unaligned); timed at the "
                    "stage shapes by a direct launch",
        "kernels": ["conv3x3_bf16_kernel", "conv3x3_bf16_reduce_kernel"],
        "arithmetic": "mma.sync m16n8k16 bf16, fp32 sums",
        "loop": "conv_ranges, shared with the fp32 instances"},
    "conv3x3_bf16_wgmma": {
        "instance": "bf16, C and Cout multiples of 8, aligned (the path)",
        "kernels": ["conv3x3_wgmma_kernel", "conv3x3_wgmma_reduce_kernel"],
        "arithmetic": "wgmma m64nNk16 bf16 from a TMA ring (x by im2col "
                      "loads), fp32 runs of 512 k flushed with IEEE adds",
        "loop": "wgmma_ranges, shared with conv_wgrad_bf16_wgmma"},
    "conv_wgrad_bf16_wgmma": {
        "instance": "bf16 x and dy, fp32 dW; C and Cout multiples of 8",
        "kernels": ["conv_wgrad_wgmma_kernel",
                    "conv_wgrad_wgmma_reduce_kernel"],
        "arithmetic": "wgmma m64nNk16 bf16, both operands MN-major from a "
                      "TMA ring, fp32 runs of 512 pixels flushed with IEEE "
                      "adds",
        "loop": "wgmma_ranges, shared with conv3x3_bf16_wgmma"},
    "conv_stats_bf16_mma_sync": {
        "instance": "bf16 shapes the wgmma kernel does not take; timed at "
                    "the path shapes by a direct launch",
        "kernels": ["conv_stats_bf16_kernel", "conv_stats_cut_kernel",
                    "conv_stats_sum_kernel"],
        "arithmetic": "mma.sync m16n8k16 bf16, fp32 sums taken before z is "
                      "rounded",
        "loop": "conv_ranges, shared with the fp32 instances"},
    "conv_stats_bf16_wgmma": {
        "instance": "bf16, C and Cout multiples of 8, aligned (the path)",
        "kernels": ["conv_stats_wgmma_kernel", "conv_stats_wgmma_cut_kernel",
                    "conv_stats_wgmma_sum_kernel"],
        "arithmetic": "wgmma m64nNk16 bf16 from a TMA ring, fp32 runs of "
                      "512 k; sums of the fp32 values before z is rounded, "
                      "in a fixed order (lanes, shuffles, 8 warps through "
                      "shared memory at a named barrier)",
        "loop": "wgmma_ranges, shared with conv3x3_bf16_wgmma"},
    "conv_affine_bf16_wgmma": {
        "instance": "bf16, C and Cout multiples of 8, aligned (the path)",
        "kernels": ["conv_affine_wgmma_kernel",
                    "conv_affine_wgmma_reduce_kernel"],
        "arithmetic": "wgmma m64nNk16 bf16 from a TMA ring, fp32 runs of "
                      "512 k; BN folded per column pair, residual and ReLU "
                      "in fp32, one rounding",
        "loop": "wgmma_ranges, shared with conv3x3_bf16_wgmma"},
    "bn_affine_bf16": {"instance": "bf16 z, residual and out; fp32 scale "
                                   "and shift",
                       "kernels": ["bn_affine_bf16_kernel"]},
    "conv_wgrad_bf16_mma_sync": {
                        "instance": "bf16 x and dy, fp32 dW, shapes the "
                                    "wgmma kernel does not take; timed at "
                                    "the stage shapes by a direct launch",
                        "kernels": ["conv_wgrad_bf16_kernel",
                                    "wgrad_reduce_kernel"],
                        "arithmetic": "mma.sync m16n8k16 bf16 on "
                                      "ldmatrix.trans fragments, fp32 "
                                      "sums"},
}
# the fp16 instances: the bf16 ones' kernels and loops on fp16 (the wgmma
# kernels' F16 traits: `.f16.f16` products, FLOAT16 tensor maps; the
# mma.sync ones' `__half` instances), outputs rounded to nearest even
# (+-inf past 65504, subnormals kept)
for _n in ("conv3x3", "conv_stats", "conv_affine", "conv_wgrad"):
    for _i in ("wgmma", "mma_sync"):
        _b = KERNEL_NOTES[f"{_n}_bf16_{_i}"]
        KERNEL_NOTES[f"{_n}_fp16_{_i}"] = {
            "instance": _b["instance"].replace("bf16", "fp16"),
            "kernels": [k.replace("bf16", "f16") for k in _b["kernels"]],
            "arithmetic": _b["arithmetic"].replace("bf16", "f16"),
            **({"loop": _b["loop"].replace("bf16", "fp16")}
               if "loop" in _b else {})}
KERNEL_NOTES["conv_affine_fp16_wgmma"]["vectors"] = \
    "fp16 or fp32 (a half step's running statistics), a bit each"
KERNEL_NOTES["conv_affine_fp16_mma_sync"]["vectors"] = \
    "fp16 or fp32, a bit each"
KERNEL_NOTES["bn_affine_fp16"] = {
    "instance": "fp16 z, residual and out; fp32 scale and shift",
    "kernels": ["bn_affine_f16_kernel"]}
PATH_LAUNCHES = ("launches", "bert_launches", "image_launches",
                 "train_launches", "text_launches", "int8_launches",
                 "ext_launches", "fused_launches", "v2_launches",
                 "zoo_launches", "bf16_launches", "bf16_train_launches",
                 "fp16_train_launches", "sparse_launches",
                 "input_launches", "ckpt_launches", "serve_plane_launches",
                 "int8_calib_launches", "obs_fleet_launches",
                 "trace_check_launches")


def kernels_line(state):
    """One entry per kernel.  ``launches`` sums the main-path runs that
    launch it (GPT serving in ``slice``, BERT training in
    ``bert_train``, ResNet-50 serving in ``image_serve``, ResNet-50
    training in ``image_train``, Gluon BERT serving in ``text_serve``,
    int8 ResNet-50 scoring and serving in ``int8_score`` and
    ``int8_serve``, the extension surface in ``ext_path``, ResNet-50 v2
    training in ``v2_train``, Inception-v3 scoring and serving in
    ``zoo_serve``, DenseNet-121 training in ``zoo_train``, and the bf16
    instances in bf16 ResNet-50 scoring and serving (``int8_score``,
    ``int8_serve``, ``bf16_serve``), Gluon BERT-base serving
    (``bf16_serve``), Inception-v3's bf16 forward (``bf16_serve``) and
    bf16 ResNet-50 and BERT-base training (``bf16_train``), and the fp16
    instances in fp16 ResNet-50 training, fused and under ``amp``, and
    the fp16-converted forward (``fp16_train``), Gluon BERT-base
    training with a row-sparse word embedding (``sparse_train``), the
    checkpointed ResNet-50 training (``ckpt_train``), the served
    checkpoint (``serve_plane``), the observed scoring and the
    telemetry-calibrated int8 net (``int8_calib``) and the fed fused
    steps of the observed fleet and the trace check (``obs_fleet``,
    ``trace_check``));
    the times are at the first case, the
    path's own shape (``conv3x3``: its dgrad use, which is how training
    launches it)."""
    out = []
    for name, source, replaces in KERNELS:
        cases = state["cases"][name]
        main = cases[0]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(state[k].get(name, 0)
                                    for k in PATH_LAUNCHES),
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                    "eager_ms": main["kernel_eager_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    "shape": main["shape"], "card": state["card"],
                    **{k: main[k] for k in ("bound_fp32_ms",) if k in main},
                    **KERNEL_NOTES.get(name, {})})
    return {"kernels": out}


# what an A/B run (``--against-parent``) keeps of each phase's line: the
# paths of keys to its numbers
AB_PICKS = {
    "bf16_serve": [("resnet50_v1", "per_bucket", b, k) for b in ("8", "1")
                   for k in ("device_ms", "eager_ms", "idle_share")] +
                  [("resnet50_v1", "closed_loop", "p50_ms"),
                   ("resnet50_v1", "concurrent", "items_s")] +
                  [("resnet50_v1", "affine_instances_host_ms", k)
                   for k in ("wgmma", "mma_sync")],
    "int8_score": [(p, k) for p in ("fp32", "bf16", "int8")
                   for k in ("ms_per_batch", "images_s",
                             "host_ms_per_batch")],
    "bf16_train": [("resnet50_v1", k) for k in (
        "replayed_step_ms_median", "eager_step_ms_median", "idle_share")],
    # the wgmma dgrad and dW at ResNet-50's four stages
    "bf16_train_kernels": [("cases", k, i, "kernel_ms")
                           for k in ("conv3x3_bf16_wgmma",
                                     "conv_wgrad_bf16_wgmma")
                           for i in range(4)],
}


def against_parent(parent, phases):
    """``phases`` of the checkout at ``parent`` and of this one in turns
    (parent, change, change, parent), each a ``chip_smoke.py --phases
    env,<phases>`` process of its own checkout, package and build: → the
    order, and for each number of :data:`AB_PICKS` its four values (null
    where a checkout's line has no such number) and the mean of the
    parent's over the mean of the change's."""
    order = ("parent", "change", "change", "parent")
    runs = []
    for tag in order:
        root = os.path.abspath(parent) if tag == "parent" else HERE
        run = subprocess.run(
            [sys.executable, "chip_smoke.py", "--phases",
             ",".join(("env",) + tuple(phases))], cwd=root,
            capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"{','.join(phases)} of the {tag} failed: "
                               f"{run.stderr[-3000:]}")
        lines = {}
        for ln in run.stdout.splitlines():
            try:
                d = json.loads(ln)
            except ValueError:
                continue
            if isinstance(d, dict) and "phase" in d:
                lines[d["phase"]] = d
        runs.append(lines)
    values = {}
    for phase in phases:
        for path in AB_PICKS.get(phase, ()):
            got = []
            for lines in runs:
                v = lines.get(phase)
                for k in path:
                    if isinstance(v, dict):
                        v = v.get(k)
                    elif isinstance(v, list) and isinstance(k, int):
                        v = v[k] if k < len(v) else None
                    else:
                        v = None
                got.append(v)
            values[f"{phase}:{'.'.join(map(str, path))}"] = got
    return {"order": list(order), "values": values,
            "parent_over_change": {k: (v[0] + v[3]) / (v[1] + v[2])
                                   for k, v in values.items()
                                   if None not in v}}


PHASES = ("env", "build", "kernels", "slice", "reference", "profile",
          "bert_kernels", "bert_train", "bert_reference", "bert_profile",
          "image_kernels", "image_serve", "image_reference", "image_profile",
          "train_kernels", "image_train", "image_train_reference",
          "image_train_profile", "fused_image_train", "fused_bert_train",
          "fused_parity", "text_kernels", "text_serve",
          "text_reference", "text_profile", "int8_kernels", "int8_score",
          "int8_serve", "int8_reference", "int8_profile", "ext_kernels",
          "rtc", "ext_path", "v2_train", "v2_train_reference",
          "loss_metric", "zoo_kernels", "zoo_serve", "zoo_reference",
          "zoo_train", "zoo_train_reference", "bf16_kernels", "bf16_serve",
          "bf16_reference", "bf16_train_kernels", "bf16_train",
          "bf16_train_reference", "fp16_train_kernels", "fp16_train",
          "fp16_train_reference", "sparse_train", "attention_ops",
          "input_train", "ckpt_train", "serve_plane", "chaos",
          "int8_calib", "obs_fleet", "trace_check")


def _args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "card (see the module docstring).")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone, in order")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: "
                         "bf16_train_kernels also holds the fp32 conv "
                         "kernels bit for bit against its build")
    ap.add_argument("--against-parent", default=None, metavar="PHASES",
                    help="with --parent: run these comma-separated phases "
                         "of the parent's checkout and of this one in "
                         "turns (parent, change, change, parent) and print "
                         "the numbers of AB_PICKS as one JSON line")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    names = args.phases.split(",") if args.phases else PHASES
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"chip_smoke: no phases {unknown}", file=sys.stderr)
        return 2

    state = {"card": None, "cases": {}, "parent": args.parent}
    if args.against_parent:
        if not args.parent:
            print("chip_smoke: --against-parent needs --parent",
                  file=sys.stderr)
            return 2
        ab = args.against_parent.split(",")
        if [n for n in ab if n not in PHASES]:
            print(f"chip_smoke: no phases {ab}", file=sys.stderr)
            return 2
        phase_env(state)
        emit({"against_parent": ab, "card": state["card"],
              **against_parent(args.parent, ab)})
        return 0
    for name in names:
        t0 = time.perf_counter()
        try:
            res = globals()["phase_" + name](state)
        except Exception as e:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "card": state["card"],
                  "error": f"{type(e).__name__}: {e}"[:4000]})
            return 1
        emit({"phase": name, "ok": True, "card": state["card"],
              "phase_s": time.perf_counter() - t0, **res})
    if args.phases:
        return 0
    emit(kernels_line(state))
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
