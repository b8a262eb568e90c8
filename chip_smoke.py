#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure exits non-zero and prints no result line):

1. Card: print the card's name and power limit (nvidia-smi) and build
   the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc, one
   compiler per source, side by side, and beside them the native host
   library from ``horovod_tpu_torch/native/*.cc`` with g++ (into
   ``build/horovod_tpu_torch/native/``), printing its seconds.
1b. K1 (the pre/postscale kernel) against its plain version on the card,
   bitwise: fp32->fp32, bf16->bf16, fp16->fp16 and fp32->bf16, at GPT-2
   medium's ``tok_emb`` gradient (51,463,168 elements), a 1,024-element
   bias and ragged sizes (1, 4095, 4097, 9001), each also as a view one
   element past a 16-byte boundary (the kernel's scalar path), scales
   1/3, 0.7 and 2.5 each rounded to the input's dtype; ``_apply_scale``
   equal to the plain version with the rounded scale. Times on
   ``tok_emb`` and the bias in fp32: CUDA graph replay, eager, the plain
   version and the library call ``torch.mul(x, s)`` in turns, beside the
   memory bound (the bias with 64 launches a replay).
2. K2/K4 (int8 codec) against their plain PyTorch versions, on the card,
   at the shapes of the serve path: one K/V leaf of GPT-2 medium,
   (max_len=1024, 16 heads, 64) bf16, plus ragged sizes, one leaf a
   launch; then grouped (``quantize_int8_group``/``dequantize_int8_into``):
   the 48 handoff leaves, two fp32 leaves, the ragged sizes 1, 4095,
   4097, 5000 and (37, 16, 64) in both dtypes, a bf16 and an fp32 view one
   element past a 16-byte boundary (the scalar path) and an all-zero
   block, 62 leaves in one launch a side, and the same plus 8 leaves in
   two; and K4 into slot 3 of an (8, 1024, 16, 64) bf16 slab whose other
   slots must keep a NaN sentinel to the bit. Codes and dequantized
   outputs must match bitwise, scales to 1e-6. Times, in turns: CUDA
   graph replay of 48 single-leaf launches over 48 distinct leaves
   (device time per launch), one handoff as one grouped launch and as
   48 single launches (device time per handoff), each also eager
   (synchronized) and as host time alone, the plain version per leaf,
   and the memory bounds at 3.35 TB/s per leaf and per handoff.
3. K5/K6/K7 (flash attention forward, dq, dk/dv) against their plain
   versions on the card: the training shape (8, 512, 16, 64) causal in
   bf16 and fp32, fp32 with a key mask, D = 128, a ragged S and a
   nonzero lse cotangent; in bf16 (where K5, K6 and K7 are the
   wgmma/TMA kernels) also a ragged S with a key mask and dlse, the
   training shape with q, k, v as ``split`` views of one fused QKV
   tensor, D = 128 causal, BERT-large's (8, 512, 16, 64) non-causal
   under a padded batch's key mask and ViT-B/16's (64, 197, 12, 64)
   non-causal (a ragged last tile), both fused, and the striped ring's
   strict block at (2, 512, 16, 64): K/V rolled one position, key 0
   masked, causal — query row 0 fully masked — with a nonzero lse
   cotangent; bounds fp32 2e-4
   (forward) and 5e-3 (gradients), bf16 2e-2. K6 and K7 are held there
   both as two calls and as the training paths' one backward call
   (``flash_bwd``). Each record names its route by dtype. Times at each
   path's shape in bf16 (GPT training causal, BERT with its key mask,
   ViT): CUDA graph replay over 8 distinct input sets, eager, the plain
   version, and the library call ``scaled_dot_product_attention`` with
   the path's ``is_causal`` or the same key mask as a boolean
   ``attn_mask`` (its forward against K5, its backward — a graph of
   forward and backward less the forward's — against K6 + K7, beside
   which the one-call backward is timed too), beside the bound
   max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s).
4. K3/K8/K9 (the int8 gradient wire's stochastic quantizer, the Adasum
   dot/norms and combine) against their plain versions on the card: a
   64 MiB fp32 gradient bucket, GPT-2 medium's ``tok_emb`` (50257 x
   1024), bf16 inputs, ragged sizes (1, 4095, 4097, 9001) and zero
   operands. K3 codes and scales bitwise given the same thresholds; K8
   within 1e-5 of the fp64 sums (each relative to its own scale) and
   symmetric in (a, b) to the bit; K9 bitwise given the same scalars,
   symmetric, and a plain sum where a side is zero. Times at the path
   shapes (K3 on the bucket, K8/K9 on ``tok_emb``, fp32) as for K2/K4,
   beside the memory bound.
5. Serving: disaggregated serving (one prefill and one decode replica)
   of GPT-2 medium at full width — 24 layers, hidden 1024, 16 heads, MLP
   4096, vocab 50257, bf16 compute over fp32 weights from a seeded
   generator — with a 1024-line cache, 8 slots and prompts up to 256
   tokens, over a seeded Poisson trace of 16 requests. The launch
   counters are zeroed just before this run and read just after it: K2
   and K4 must each have launched exactly once per handoff, coding 48
   leaves each time. Every request must complete with its full
   token count, with zero drops and at least one handoff. A reference
   check holds the bf16 cache-path logits against the same weights in
   fp32 on a short prompt.
6. Training: GPT-2 medium at full width (same geometry, seeded weights)
   on one fixed seeded batch of 8 x 513 tokens (S = 512) through
   ``hvd.init()`` (NCCL, world size 1), ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW(lr=1e-4, weight_decay=1e-4))``: 2
   warm-up steps, then 5 timed steps with the launch counters zeroed
   just before them and read just after. Each of K5, K6 and K7 must
   launch exactly 24 x 5 times, at least one bucket allreduce must be
   issued per step, every loss must be finite and the last below the
   first. A reference check first runs one forward and backward on the
   same weights and batch with the flash kernels and with the plain
   attention, in bf16 compute (loss within 1e-3 relative, every gradient
   within 2e-2 relative Frobenius error) and on an fp32 copy of the
   weights (1e-5 and 1e-3).
6a. Integrity: GPT-2 medium at full width (seeded weights, bf16 over
   fp32) through ``hvd.init()`` (NCCL, world size 1),
   ``DistributedOptimizer(AdamW, accum_steps=4, remat_policy=...,
   nonfinite_policy=...)``, ``optimizer.accumulate``, pinned host batches
   of 32 x 513 tokens fed by ``DeviceInfeed(depth=2)`` on its copy
   stream, and the ``BroadcastVariablesCallback`` and
   ``LearningRateWarmupCallback`` around the steps. First, on one model
   without optimizer hooks, ``accumulate_gradients`` under remat ``full``
   against ``none`` (loss within 1e-3 relative, every gradient within
   2e-2 relative Frobenius error; bitwise equality reported) and 4
   microbatches of 2 rows against the 8 rows fused (the same limits).
   Then four runs, remat ``none``/``full`` x ``scale_backoff``/no guard,
   each 2 warm-up and 5 timed steps (median step ms, tokens/s = 32 x 512
   / step, peak GiB, infeed wait ms a batch; the guard's cost is the
   step time with it less the step time without): in the timed steps K1
   (the unscale) must launch buckets x 5 times with the guard and never
   without, K5 24 x 4 x 5 times (twice that under ``full``, the
   recompute), K6 and K7 24 x 4 x 5 times, one bucket round and one
   guard agreement a step. The ``none``/``scale_backoff`` run first takes
   the guard drill: at effective step 3 a hook puts +Inf into the first
   element of the first parameter's gradient; every weight and AdamW
   state tensor must stay bitwise unchanged, the loss scale go 2^15 ->
   2^14, with 1 non-finite and 0 good steps, and the next step apply.
   Last, GPT-2 medium's widths at 4 layers through ``CheckpointManager(
   max_to_keep=2)`` in a temporary directory (deleted after): saves at
   steps 2 and 4 (model, AdamW and guard state), two more steps; step 4
   restored into a fresh model and optimizer must repeat them bitwise;
   after ``_corrupt_step(4, "bitflip")`` ``restore()`` must walk back to
   step 2, counting one corruption. Printed: the caller-blocked save ms,
   the background write s, the bytes, the verify counts.
6b. BERT-large MLM pretraining (24 layers, hidden 1024, 16 heads, MLP
   4096, vocab 30522; seeded weights, bf16 over fp32) at B = 8, S = 512
   with a padded batch's key mask (per-sample lengths in [S/2, S]) and
   the loss over 15% of the unpadded positions (labels = tokens), through
   ``DistributedOptimizer(AdamW(lr=1e-4, weight_decay=1e-4))`` over NCCL
   at world size 1: a flash-vs-plain reference step (loss 1e-3, grads
   2e-2), 2 warm-up and 5 timed steps; K5, K6 and K7 must each launch
   exactly 24 x 5 times, the loss must fall.
6c. ViT-B/16 classification training on 224x224 images, B = 64 (S =
   197), the same reference check, 2 warm-up and 3 timed steps; K5/K6/K7
   exactly 12 x 3 times each.
6d. ResNet-50 with the space-to-depth stem, channels_last, B = 256,
   224x224: its bf16 forward against the fp32 forward of the same weights
   on 32 images (5e-2 of the largest logit), then 2 warm-up and 3 timed
   steps. Then one checked training step (finite loss and gradients)
   each of VGG-16 (B = 32, 224), Inception V3 (B = 32, 299), MLP and
   ConvNet (B = 64, 28x28).
7. Multi-rank gradient reduction: the script relaunches itself as n
   rank workers (``--rank-worker``) sharing the one card, each with
   ``HVD_TPU_COORDINATOR``/``NUM_PROC``/``PROC_ID`` and its own time
   limit, running ``init(backend="gloo")`` (gloo stages the CUDA tensors
   through host memory; NCCL refuses two ranks on one GPU). They load
   the kernels the parent built. Two configurations: n = 2 with GPT-2
   medium at full width, B = 8, S = 512 per rank; n = 4 with
   ``gpt_tiny(hidden=128, num_heads=2)``, B = 8, S = 128 (two Adasum
   levels, 4-way quantized chunks). Each rank has its own seeded batch;
   each runs both modes from the same seeded weights after
   ``broadcast_parameters``, 1 checked step and 3 timed steps:
   ``compression="int8_ef"`` (at the first step one int8 bucket's reduced
   gradient must lie within ``(sum of s_rank + s_reduced) / n`` of the
   exact fp32 average of the ranks' buffers, the residual must be finite
   and nonzero, and K3 must launch exactly 2 x int8 buckets x 3 times)
   and ``op=hvd.Adasum`` (at the first step one parameter's reduced delta
   must agree with ``adasum_allreduce_reference`` over the gathered
   deltas in fp64 to 1e-5 of its largest value, and K8 and K9 must
   launch exactly parameters x log2(n) x 3 times). Every loss must be
   finite and, after every step, every rank's per-tensor parameter
   digests must equal rank 0's. At n = 4 one direct ``adasum_allreduce(
   wire="int8", key=...)`` must launch K3 once and K4 twice per level.
   The step times are of gloo over loopback with n processes on one
   card, not of NCCL or NVLink. At n = 2 each rank also runs
   ``SyncBatchNorm`` over its own (32, 64, 28, 28) batch on the card:
   its output, input gradient and running statistics must match a
   ``BatchNorm2d`` over the gathered batch to 1e-5 of the largest value,
   and one step's gradient tree through ``DistributedGradFn(
   compression="int8_ef")``: its reduced gradients bitwise those of a
   fresh ``DistributedOptimizer(compression="int8_ef")`` given the same
   gradients (the same bucket plan and rounding keys), K3's launches
   equal. At n = 4 each rank also runs two drills: ``compression="int8_ef",
   nonfinite_policy="skip_step"`` for 3 steps with a NaN in rank 1's
   first gradient element at step 2 (one guard agreement a step, every
   rank skips, weights, int8_ef residuals and rounding step bitwise
   unchanged across the skip, replicas bitwise equal after every step);
   and ``DivergenceDetector(every_steps=2, policy="resync")`` after one
   weight of rank 2 is perturbed (every rank names rank 2,
   ``broadcast_parameters`` heals it, replicas bitwise equal again).
7b. Mesh routing over a simulated 2x2 mesh: the script relaunches itself
   as 4 gloo rank workers (``--rank-worker n4_mesh``) sharing the one
   card, each with ``HVD_TPU_MESH_SHAPE=2x2`` (local axis {0, 1} and
   {2, 3}, cross axis {0, 2} and {1, 3}) and
   ``init(hierarchical_allreduce=True, hierarchical_allgather=True)``.
   GPT-2 medium's widths at 8 of its 24 layers (the role-aware elastic
   slice's named cut: with 7c's and 9 (b)'s it keeps phases 12 and 13
   inside the time limit), B = 4, S = 512 per rank, each
   rank its own seeded batch after ``broadcast_parameters``, 1 checked
   and 3 timed steps in each of two modes: (a) ``compression="int8_ef",
   route="staged_int8"`` (local:none, cross:int8): at the checked step
   one int8 bucket's reduced gradient must lie within ``(sum over hosts
   of s_host + s_reduced) / 4`` of the exact fp32 average (s the block
   scales of each host's local sum), the residual must be finite and
   nonzero, and in the timed steps K3 must launch exactly 2 (the cross
   hop's reduce-scatter and all-gather) x int8 buckets x 3 times and K2
   and K4 never; (b) ``op=hvd.Adasum, route="staged"``: one parameter's
   reduced delta must equal ``adasum_allreduce_reference`` over the two
   local groups' average deltas in fp64 to 1e-5 of its largest value,
   and K8 and K9 must launch exactly parameters x log2(2) x 3 times.
   Every loss finite, every rank's parameter digests equal to rank 0's
   after every step. Then (a2) ``ZeroOptimizer(zero_stage=3,
   route="local:none,cross:int8", compression="int8_ef")`` (AdamW, the
   same geometry, 1 checked and 3 timed steps): at the checked step one
   bucket's quantized reduce-scatter (K3 on the cross hop only) must lie
   within ``sum over hosts of s_host / 4`` of the exact fp32 average and
   the residuals summed over the ranks must equal the exact sum less 4
   times the result (fp32 roundoff); K3 must launch exactly buckets x 3
   times in the timed steps and K1, K2, K4 never; every rank's gathered
   parameters bitwise rank 0's after every step. Then (c) eager calls on CUDA tensors of
   ``tok_emb``'s shape: the hierarchical ``allreduce(op=Sum,
   prescale_factor=1/3, postscale_factor=1.5)`` bitwise equal on every
   rank, within 1e-6 of sum |x| of the fp64 result and with exactly 2
   K1 launches; one ``quantized_hierarchical_allreduce`` with exactly 2
   K2 and 2 K4 launches, within its bound of the exact sum; the
   hierarchical allgather bitwise the flat one. (d) Process sets [0, 2]
   and [1, 3]: allreduce, allgather, broadcast from a global root and
   alltoall over each, bitwise against the same reductions by hand; a
   non-member's call raising ``ValueError``; ``gpt_tiny(hidden=128,
   num_heads=2)`` trained 2 steps per set through
   ``DistributedOptimizer(process_set=)``, replicas bitwise equal within
   a set and apart between sets. (e) The chunked ``alltoall(splits=,
   chunked=True)`` of (rows, 1024) bf16 tokens on a skewed table on the
   none/bf16/int8 wires (none and bf16 bitwise; int8 within half a block
   scale, with n - 1 = 3 K2 and 3 K4 launches: K4 dequantizes each
   hop), and ``wired_ppermute(wire="int8")`` over the local
   axis on (4096, 1024) fp32 activations, forward and backward (the
   cotangent on the inverse shift), each within half a block scale,
   with 2 K2 and 2 K4 launches. Every
   section's launch counts are zeroed just before it and read just
   after; their sum is the mesh path's count. Printed: the median step
   ms of each mode and the bytes each rank puts on each axis
   (``mesh_wire_cost`` of the padded lengths) beside a flat fp32 ring;
   these are gloo-over-loopback times of 4 processes on one card, not
   NCCL or NVLink.
7c. ZeRO: the script relaunches itself as 4 gloo rank workers
   (``--rank-worker n4_zero``, a flat world) sharing the card: GPT-2
   medium's widths at 2 of its 24 layers (the cut that, with 9 (b)'s,
   makes room for phases 12 and 13), B = 4, S = 512 per rank (phase
   7b's batch),
   each rank its own seeded batch after ``broadcast_parameters``,
   ``AdamW(lr=1e-4, weight_decay=1e-4)``, 1 checked and 3 timed steps of
   each case in turn, memory released between them: (a) the replicated
   ``DistributedOptimizer``; (b) ``zero_stage=1``; (c) ``zero_stage=1,
   compression="int8_ef"``; (d) ``zero_stage=2, accum_steps=2``; (e)
   ``zero_stage=3, nonfinite_policy="scale_backoff"`` with the +Inf drill
   (rank 0's first gradient element at the second step: every shard and
   AdamW tensor bitwise unchanged, the loss scale halved). Each step's
   loss within 1e-3 relative of (a)'s; every rank's gathered parameters
   bitwise rank 0's after every step; (c)'s first quantized
   reduce-scatter within ``sum of s_rank / 4`` of the exact average and
   its residuals summing to the exact sum less 4 times the result; in
   the timed steps K3 exactly buckets x 3 in (c), K1 exactly buckets x 3
   in (e), K5/K6/K7 2 x 3 each (x 2 in (d)) and nothing else. Printed
   for each case: the median step ms, peak GiB a rank over the timed
   steps (``max_memory_allocated``), GiB at rest after a step
   (``memory_allocated``), and the bytes of the two ZeRO metrics'
   counter by kind/wire/axis; gloo over loopback, 4 processes on one
   card, not NCCL or NVLink.
7e. Eager engine: the script relaunches itself as 2 gloo rank workers
   (``--rank-worker n2_eager``): GPT-2 medium at full width, B = 8,
   S = 512 per rank, each rank its own seeded batch, ``AdamW`` after
   ``broadcast_parameters``, trained in Horovod's PyTorch loop — after
   each backward every gradient goes through ``hvd.allreduce_async(
   p.grad, name="grad." + pname, op=hvd.Sum, prescale_factor=1/3,
   postscale_factor=1.5)``, then every handle is synchronized and
   ``step()`` runs — for 1 checked and 3 timed steps. At the checked step
   one parameter's reduced gradient must be bitwise the plain
   ``plain(plain(g0, 1/3) + plain(g1, 1/3), 1.5)`` of the gathered
   gradients; K1 must launch exactly 2 x 291 x 4 times (counts zeroed
   just before step 1, read after step 4), the controller must make 291
   negotiation rounds at step 1 and none after, replicas must be bitwise
   equal after every step, and a timeline around step 3 must hold one
   begin/end pair per gradient. The negotiation runs on the native
   runtime: rank 0's table and each engine's LRU are the C++ ones, the
   loop's requests and responses ride the native codec (frames counted
   by form: native above 0, JSON none), and the timeline is written by
   the native writer with no event dropped. Then MoE-shaped exchanges of (4096, 1024)
   tokens per rank (``alltoall`` on the none/bf16/int8 wires — int8 must
   launch K2 and K4 — with uneven splits, an Average ``reducescatter``,
   a ragged ``allgatherv``), held against plain results from every rank's
   input; ``broadcast_object`` of the optimizer's hyperparameters; and a
   mismatch (rank 1 submits ``"probe"`` with another shape: both ranks
   raise ``MismatchError`` naming rank 1 within the controller timeout,
   and the next collective succeeds); then ``grouped_allreduce_`` (Sum
   and Average), ``allreduce_``, ``broadcast_async_`` -> ``synchronize``,
   ``alltoall_async`` and ``sparse_allreduce_async`` (Sum and Average of
   a (50257, 1024) embedding gradient's 4096 rows per rank) on CUDA
   tensors, each bitwise against the same reduction done by hand. A
   second configuration (``n2_join``) runs ``init(join_mode=True)``: rank 1 trains 2 steps and
   joins, rank 0 trains 3 and joins; rank 0's third-step gradients must
   be bitwise ``plain(plain(g0, 1/3) + 0, 1.5)`` and ``join()`` must
   return 0 on both. Step times are gloo with 2 processes on one card.
7d. Overlap (D2) and the Adasum optimizer's guard and accumulation:
   the script relaunches itself as 2 gloo rank workers (``--rank-worker
   n2_overlap``; GPT-2 medium's widths at 8 of its 24 layers — the
   role-aware elastic slice's named cut, with 7b's — B = 8,
   S = 512 a rank) and as 4 on a 2x2 mesh (``n4_overlap``; B = 4,
   S = 512, phase 7b's geometry). Each pair of arms runs ``overlap=False`` then
   ``overlap=True`` in the same processes from the same seeded weights,
   1 checked and 3 timed steps of AdamW: the parameters' digests (ZeRO:
   the shards') must be bitwise equal after every step and the launches
   of the timed steps equal and exact in both arms: (a) n = 2 int8_ef,
   K3 2 x int8 buckets x 3; (b) the routed ``local:none,cross:int8``
   int8_ef, K3 2 x int8 buckets x 3; (c) ``ZeroOptimizer(zero_stage=3)`` through
   ``accumulate`` with the stage-3 prefetch on and off (peak and at-rest
   GiB of each). K5/K6/K7 ``OVERLAP_LAYERS`` (8) x 3 a timed arm. At n = 2 also (d) ``DistributedOptimizer(op=Adasum,
   nonfinite_policy="scale_backoff")`` for 3 steps with a +Inf in rank
   0's first gradient element at step 2: every weight and AdamW tensor
   bitwise unchanged across it, the loss scale 2^15 -> 2^14, K1 one a
   parameter a step, K8 and K9 one a parameter a good step; and (e)
   Adasum over SGD with ``accum_steps=2`` (2 x 4 rows) against one
   batch of 8 rows, with the model's bf16 compute and again in fp32:
   loss within 1e-3, every local delta and all reduced deltas together
   within 2e-2 relative Frobenius error, and in fp32 every single
   reduced delta within 2e-2 (under bf16 the worst one is reported with
   its weights' fp32 spacing). Printed for each arm: the median step ms, forward +
   backward, ``step()`` and the collectives' host ms (``overlap=True``:
   the worker thread's busy time), peak and at-rest GiB; gloo, n
   processes on one card.
8. Elastic training through the port's launcher: ``python -m
   horovod_tpu_torch.runner.launch --elastic -np 2 --min-np 2 --max-np 2
   -H hostA:1,hostB:1`` with ``HVD_TPU_ELASTIC_FORCE_LOCAL=1`` (both
   named hosts on this machine, one world of 2 gloo processes on the
   card) and a 3 s blacklist TTL runs this script as
   ``--elastic-worker``: GPT-2 medium's widths at 2 of its 24 layers
   (the depth cut that makes room for phase 9), B = 4, S = 512 a
   rank, int8_ef AdamW, ``hvd.elastic.TorchState(model, optimizer,
   step)`` under ``hvd.elastic.run``, each step's batch seeded from
   (step, rank), a commit every step and ``checkpoint.save_state`` (each
   rank its own directory and int8_ef residual) every 3 steps and at a
   preemption, 9 steps. One uninterrupted run (it persists nothing:
   persistence changes no value), then one under the plan (global steps): a rendezvous 5xx on hostA's second
   poll, a collective fault on hostB at step 4, a hard crash of hostB's
   worker at step 6, a SIGTERM preemption of rank 0 at step 8. Checks:
   exit 0, step 9, those four sites injected, every restore bitwise the
   commit it was persisted from (digests), the persisted state the last
   commit, and the final parameters and AdamW state bitwise those of the
   uninterrupted run (one such run: two of them have always ended
   bitwise equal). Printed per fault: seconds from the
   injection to the first step completed after it; commit ms, persist s
   and bytes, restore s.
9. Telemetry and control. (a) What telemetry costs a step: this script
   as ``--telemetry-worker``, the train phase's geometry (GPT-2 medium,
   B = 8 x 512, n = 1, 2 + 5 AdamW steps under ``hvd.StepTimer``
   phases) in two processes, telemetry off (``HVD_TPU_METRICS=0``, no
   flight recorder, no stall check) then on (``/metrics`` on an
   ephemeral port scraped once a second by this process, the JSON-lines
   dump, the stall watchdog, the flight recorder): losses bitwise equal;
   each arm's step ms. (b) The control run: ``python -m
   horovod_tpu_torch.runner.launch --elastic -np 3 --min-np 2 --max-np 3
   -H hostA:1,hostB:1,hostC:1 --metrics-port 0 --pod-metrics-port 0
   --autoscale-policy JSON --autoscale-log FILE --host-discovery-script
   SCRIPT`` with ``HVD_TPU_ELASTIC_FORCE_LOCAL=1`` (one world of 3 gloo
   processes on the card) over ``--elastic-worker``: GPT-2 medium's
   widths at 2 of its 24 layers (the cut that makes room for phases 12
   and 13),
   B = 4 x 512 a rank, 50 steps, int8_ef AdamW, a commit
   a step, the per-step eager loss allreduce, the committed state
   persisted at each driver-managed exit; the hosts from a discovery
   script whose list this process edits (hostC leaves it at its
   eviction and returns after a step at n = 2; a 10 s exile); a
   straggler on hostC (1.2 s a commit, its first process only) and a 9 s
   ``collective_stall`` on hostB's third loss allreduce (between the
   6 s stall check time and the 120 s fatal bound). Once
   the world is back at 3, this process sends SIGUSR2 to each worker.
   Checks: exit 0 and the final step; the first decision evicts hostC
   for ``straggler`` and a grow follows; the world goes 3 -> 2 -> 3;
   every restore bitwise its commit; ``/pod/metrics.json`` (scraped
   every 0.5 s) names hostC's rank slowest of 3 with a positive skew
   before the eviction and sees 2 ranks after it; hostB's ``/metrics``
   counts a stall warning; every worker's samples carry ``rank``,
   ``size`` and ``host``; each signaled worker writes a ``sigusr2``
   black box and steps on, and ``tools/flight_diff.py --json`` (a
   subprocess) accepts the three boxes. Printed: seconds from the
   eviction decision to the first step at n = 2 and from the grow to
   the first at n = 3, commit ms, peak GiB a rank, scrape ms.
10. Autotune over ssh: ``python -m horovod_tpu_torch.runner.launch -np
   2 --autotune --autotune-log-file FILE --metrics-port 0`` over
   ``--autotune-worker`` with no ``-H``: the hosts come from an LSF
   allocation (``LSB_JOBID``, ``LSB_MCPU_HOSTS="127.0.0.2 1 127.0.0.3
   1"``, two names of this machine), the workers start through an
   ``ssh`` this script writes into its output directory (it logs its
   argv and runs the command here; on ``PATH`` for the launcher alone),
   and ``HVD_TPU_NIC_DISCOVERY=1`` starts a task server on each host
   first. Each worker (a gloo rank on the card) trains GPT-2 medium at
   full width and depth, B = 4 x 512 a rank, int8_ef AdamW, under
   ``hvd.AutotunedStepper`` over the context's tuner (the nine default
   thresholds, 1-256 MiB; one warmup and two scored steps a sample):
   ``build(threshold)`` re-plans the live optimizer. 30 calls, or until
   ``:done``. Checks: exit 0; the ssh log shows two task servers and two
   workers on LSF's hosts; both ranks made the same build calls; every
   threshold has a CSV row; ``rebuilds`` is the number of moves; rank
   0's leaf-wise int8_ef residual bitwise the same across every
   re-plan; finite losses; each worker's ``/metrics`` shows the adopted
   threshold and ``hvd_tpu_autotune_rebuilds_total`` = ``rebuilds``;
   rank 0's last search scored EI with the C++ GP core
   (``native/gp_core.cc``), within rtol 1e-5, atol 1e-7 of the numpy EI
   of the same fit.
   Printed: step ms and buckets at each threshold, the chosen threshold
   and whether the tuner converged, ms a re-plan, the coordinator and
   whether discovery picked it, peak GiB a rank.
11. Parallel roles: the script relaunches itself as 4 gloo rank
   workers (``--rank-worker n4_parallel``) sharing the card. GPT-2
   medium at full width and depth (seeded fp32 weights, bf16 compute,
   the same on every arm), one seeded global batch of 4 x 1024 tokens,
   ``DistributedOptimizer(AdamW(lr=1e-4, weight_decay=1e-4),
   parallel=spec)``, 1 checked and 2 timed steps an arm, each arm in a
   world made with its spec (``init(parallel=)``): ``dense``
   (``dp=4``, the oracle), ``tp`` (``dp=2,tp=2``: 8 heads and 2,048 MLP
   columns a rank), ``ring`` (``dp=2,sp=2``, the striped ring, 512
   tokens a rank), ``ulysses`` and ``ring_int8`` (the ring's K/V hops on
   the int8 wire). Checks: each arm's global loss at the first step and
   after the last within a bf16 bound of dense's (2e-3; ring_int8 2e-2);
   every rank's parameters bitwise rank 0's after every step; the
   launches of the three steps exactly K5 = K6 = K7 = 24 a step (48 on
   the rings: two blocks a layer) and, on ring_int8, K2 = K4 = 96 a step
   (one hop of K and of V a layer, forward and backward); and, in the
   ring's world, the striped ring with the kernels against the same
   ring with plain blocks (``use_flash=False``) at (2, 512, 16, 64)
   bf16 over the sp axis, output and gradients within 2e-2. Printed for
   each arm: the median step ms, tokens/s, the launches a step, the
   bytes a rank a step (the sequence exchange, the tp allreduces, the
   slice-gradient combine and the dp reduction), peak GiB a rank and
   each rank's role label; gloo, 4 processes on one card, not NCCL or
   NVLink.
12. Pipeline and MoE: the script relaunches itself as 4 gloo rank
   workers (``--rank-worker n4_pipeline``), then as 2 (``n2_moe_ref``),
   sharing the card. bf16 compute over seeded fp32 weights (one seed: the
   whole model is made, split with ``stack_stage_params`` and each rank
   keeps its stage), AdamW(lr=1e-4, weight_decay=1e-4), 1 warm-up and 2
   timed steps an arm, each arm in a world made with its spec. GPT-2
   medium at 24 layers, one global batch of 8 x 1024: ``dense``
   (``dp=4``, ``opt.accumulate`` over 2 microbatches of 1 x 1024, the
   oracle), ``pp`` (``dp=2,pp=2``, 12 layers a stage, the 1F1B
   ``pipeline_accumulate_gradients`` over 4 microbatches of 1 x 1024
   under ``DistributedOptimizer(parallel=)``), ``pp_int8``
   (``init(pp_wire="int8")``: every stage-boundary send on K2/K4) and
   ``pp_zero3`` (``ZeroOptimizer(zero_stage=3, parallel=)``: each stage
   sharded over its dp pair). GPT-2 medium-MoE (8 experts, capacity
   factor 1.25, top-2, no router noise; 12 of 24 layers: the replicated
   expert bank), 4 x 1024 global, dp = 1, 4 microbatches: ``moe_ref``
   (``dp=1,pp=2``, 2 ranks, the experts local: the oracle), ``moe_ep``
   (``dp=1,pp=2,ep=2``) and ``moe_ep_int8`` (``moe_wire="int8"``).
   Checks: the global loss at the first step and after the last (a
   GPipe ``pipeline_apply`` forward) within ``PIPE_LOSS_RTOL`` of the
   oracle's (pp 1e-4, pp_int8 5e-4, moe_ep 2e-3, moe_ep_int8 1e-2;
   pp_zero3 1e-3 of pp's); the masters bitwise on the ranks that
   hold the same parameters after every step (dp pairs; the ep pairs'
   non-expert parameters; ZeRO-3 gathered after the run); the launches
   of the three steps exactly (K5 twice and K6/K7 once a layer a
   microbatch on a pp stage: the backward recomputes; K2/K4 once a
   stage-boundary send or receive, and on each MoE exchange of the
   forward slot, the recompute and the backward); the stage boundary's
   bytes exactly its sends, the counter's likewise, the ep exchanges'
   and the dp reduction's counters exactly the shapes' (ZeRO-3: its
   reduce-scatter's), no gradient-reduction byte off dp. Printed for
   each arm: the median step ms, tokens/s, launches a step, bytes a
   rank a step by kind, peak GiB a rank, the MoE drop fraction and
   load; and each ep owner's expert-bank gradient over moe_ref's at the
   first step (the JAX ep combine: every ep rank routes the same rows).
13. The elastic hybrid world: ``python -m
   horovod_tpu_torch.runner.launch --elastic -np 4 --min-np 2 --max-np 4
   -H hostA:1,hostB:1,hostC:1,hostD:1 --pod-metrics-port 0
   --autoscale-policy JSON --autoscale-log FILE --host-discovery-script
   SCRIPT`` with ``HVD_TPU_ELASTIC_FORCE_LOCAL=1`` and
   ``HVD_TPU_PARALLEL=dp=2,pp=2`` (4 gloo processes on the card) over
   ``--hybrid-elastic-worker``: GPT-2 medium's widths at 2 of its 24
   layers, one a stage (the role-aware elastic slice's named cut), a
   global batch of 4 x 512 (1F1B ``pipeline_accumulate_gradients`` over
   k = 4 / dp microbatches of one row, so the global batch stays when dp
   halves), ``ZeroOptimizer(zero_stage=1, compression="int8_ef",
   route="dp:int8", parallel=)`` AdamW(lr=1e-4), 8 steps,
   ``save_sharded`` of the stage state under its global leaf names
   before each commit and ``restore_sharded`` at start; a straggler on
   hostC (role dp1/pp0, 6 s a commit, its first process only; a 12 s
   tick, patience 1). The first world first runs an uninterrupted
   dp=2,pp=2 reference of the same steps and data in its own model and
   optimizer (no commit, no save); beside the run, a ``--min-np 3``
   launch must fail before any worker starts, naming the roles.
   Checks: exit 0; the decision log exactly ``evict
   hostC`` (role dp1/pp0, straggler) then ``respec dp=1,pp=2``
   (shed_dp), nothing naming hostD; before the eviction ``/pod/metrics``
   shows ``hvd_tpu_pod_replica_stalled{replica="1"} 1`` and
   ``{replica="0"} 0`` and every per-rank step-time series carries its
   dp/pp labels; the driver's ``/pod/driver`` shows
   ``hvd_tpu_respec_total{from="dp=2,pp=2",to="dp=1,pp=2"} 1``; the
   worlds 4 then 2, the second seeing dp=1,pp=2 and taking at least 3
   steps; each restore at the newest step every rank saved, piecewise,
   its restored stage state (AdamW moments, the int8_ef residual sum)
   bitwise the saved pieces assembled whole (by digest); the final loss
   within ``0.02 |ref| + 1e-3`` of the uninterrupted run's; the launches
   of every step of every rank (the reference's too) exactly K5 = 2k,
   K6 = K7 = k and K3 once
   an int8 bucket (in both worlds: the quantized reduce-scatter of the
   int8 dp hop quantizes on an axis of one too, as the JAX one does),
   nothing else. Printed: step ms in each world and the reference's,
   save s, seconds from the eviction decision to the first step at
   n = 2, restore s and bytes, peak GiB a rank in each world, the
   phase's seconds; gloo, 4 then 2 processes on one card.
   Phase 11's tp world also takes one checked step of
   ``DistributedOptimizer(op=Adasum, parallel="dp=2,tp=2")``: K8 and K9
   once a parameter, the masters bitwise equal on all four ranks.
14. Serve levers, right after phase 5 on its GPT-2 medium weights (8
   slots, 1,024 lines, prompts up to 256 tokens, seeded Poisson traces
   at 20 rps, outputs of 16 or 32 tokens). Each "lever on / lever off"
   identity pair runs in fp32 compute (TF32 off) at 8 requests: its
   greedy streams must be identical or first differ at a near-tie, a
   position where the lever-off stream's top-2 logit gap, recomputed by
   one full fp32 forward over the prompt and that stream, is at most
   1e-4 x max|logit|; each near-tie is reported (rid, position, gap).
   (a) Shared-prefix forks: traces with a 128-token system prompt and
   tails of 16, 64 or 128 tokens; the identity pair is a colocated
   cluster with a ``PrefixCache`` against one without; then a bf16
   disaggregated pair at 8 requests, timed. Checks: ``prefill_tokens``
   drops by exactly the cache's ``tokens_saved``, hits >= 1, and in the
   cached disaggregated run K2 and K4 each launch exactly once a handoff
   with 48 leaves (the forks are exact slot copies and launch nothing).
   (b) Speculative decoding on colocated clusters (a migrated slot's
   draft ring would be cold): the fp32 self-draft pair at k = 4, whose
   acceptance must be (k - 1) / k less the rounds whose rejection is a
   reported near-tie (found from the tracer's ``spec`` spans); then, at
   8 requests in bf16, a plain run, a self-draft run (the acceptance
   ceiling) and a GPT-2 small draft run (12 layers, 768, 12 heads,
   seeded weights: it shares GPT-2's vocab and accepts almost nothing),
   each with its acceptance, rounds, tokens/s and TPOT. (c) Overload:
   ``SLOPolicy(overload=True)`` with the JAX bench's overload fields on
   bf16 self-draft engines, one replica, a class-mixed trace rated to
   reach the brownout ladder's ``spec_off`` rung: the rung enters and
   exits, only fallback rounds run while it holds (``spec_fallback_rounds``
   > 0), and every request ends completed, shed or rejected (none lost);
   the rungs taken and the speculative rounds after the exit are
   printed. (d) tp-sharded decode: the
   script relaunches itself as 2 gloo rank workers (``--rank-worker
   n2_serve_tp``, ``init(parallel="tp=2")``) on ``GPT(tp_axis="tp")``
   with 8 of 16 heads a rank, the weights regenerated from phase 5's
   seed (checked by digest): the fp32 engine-level identity pair (the tp
   engine against the unsharded engine's stream, which this process
   computes and passes in), then a bf16 disaggregated tp cluster at 8
   requests: every request completes with zero drops, both ranks' event
   logs and token streams are identical, and on each rank K2 and K4
   launch exactly once a handoff, coding 48 leaves of 524,288 elements
   (half of phase 5's). Printed: one summary line an arm, the decode
   round ms and tokens/s of (d) as "gloo, 2 processes on one card";
   records in ``chip_smoke_serve_levers.json``.
15. Cluster layer, 2 processes on the card each, gloo. (a)
   ``TorchEstimator`` (``horovod_tpu_torch.spark.torch``) fits ViT-B/16
   (224x224, 1,000 classes, bf16 compute over seeded fp32 weights, as in
   phase 6c) over an ``Executor`` pool of 2: 16 seeded images in the
   pickle format in a ``LocalStore`` under ``--out``, 4 a rank a step,
   SGD, 1 epoch (2 steps a rank); then ``TrainedTorchModel.load`` and
   ``transform`` of 8 images on the card. The oracle runs here from the
   same starting weights: 2 SGD steps, each on the 8 images of the two
   ranks' s-th batches (``rank_shard`` is strided). Checks: each rank's
   step losses within 2e-2 relative of the oracle's; rank 0's final
   weights within 2e-2 of the largest update (the largest |dw| over it);
   ``transform``'s logits within 2e-2 of the oracle model's largest;
   K5, K6 and K7 exactly 12 a step on every rank and K1 never
   (``Average`` divides); ``transform`` 12 K5 launches and no backward.
   (b) ``Estimator`` fits the MLP (64 -> 128 -> 10) on the same pool
   (``fit(executor=)``): softmax cross-entropy, 2 epochs, its per-epoch
   history and final weights within 1e-5 of an in-process oracle (the
   strided shards, the shared seeded permutation, the two gradients
   averaged). (c) ``spark.run`` over ``FakeSparkContext`` and (d)
   ``RayExecutor`` over ``fake_ray``, each 2 processes running
   :func:`cluster_allreduce_task`: ``init(backend="gloo")`` on the card,
   a seeded bf16 ``allreduce(op=Sum, prescale_factor=1/3,
   postscale_factor=1.5)``; the results in rank order, bitwise the hand
   value (digest), K1 exactly twice a rank. Both run in one fork of the
   zygote, whose fakes fork (``start_method="fork"``) their tasks and
   actors with torch imported. Printed: the pool's start-up s, the fit's
   s and each rank's step ms, the Spark and Ray worlds' s; records in
   ``chip_smoke_cluster.json``;
   the run's store (ViT-B/16's checkpoint) is deleted.
16. Fleet twin and framework shims, right after phase 14 on phase 5's
   GPT-2 medium. (a) ``common/fleetsim.run_scenario`` of the banked
   scenarios ``preempt_storm_4k`` (4,096 simulated hosts, host only),
   ``diurnal_serve`` and ``overload_storm`` (a seeded ``gpt_tiny`` on
   the card): each record must equal ``results/fleetsim/<name>.json``
   exactly; K4 must launch once a migrated sequence and K2 at least
   that. (b) ``run_serve_world`` at full width: diurnal_serve's policy
   and world (6 hosts, 2 replicas, ``drain_mode="migrate"``), a seeded
   diurnal trace of 48 requests at 2 -> 24 rps with phase 5's prompt
   (64-256) and output (16, 32) lengths, 4 slots of 320 fp32 KV lines
   a replica, one ``replica_kill`` from a seeded plan; run twice, then
   once with ``drain_mode="local"``. Every request must complete once
   with its full token count, none dropped, at least one sequence
   migrate (K4 once for each, K2 at least that), and the two migrate
   runs give byte-identical decision logs and events; printed: how many
   migrated streams equal the local drain's (where one parts, the top-2
   logit gap at the first differing token), tokens/s and ms a round.
   (c) the MXNet shim on numpy arrays in a one-rank NCCL world:
   ``allreduce``/``allreduce_`` with pre- and postscale (fp32, fp16;
   2^20 elements), ``broadcast_``, ``allgather`` and
   ``DistributedOptimizer``, each bitwise its hand value, K1 exactly
   twice a scaled call. Records in ``chip_smoke_fleet.json``.
17. Result lines: the per-kernel JSON record (K1-K9, each with
   ``launches_by_path``, every path above 0, and ``launches`` their
   sum: K5/K6/K7 for the GPT training, BERT, ViT and the two guarded
   integrity runs and the ZeRO phase; K1 for the eager loop, the
   integrity unscale, the mesh phase and the ZeRO phase's (e); K2/K4 for
   serving and the mesh phase; K3 for the n = 2 multi-rank run, the mesh
   phase and the ZeRO phase's (c); K8 and K9 for the n = 2 multi-rank run
   and the mesh phase; phase 7d for K1, K3, K5-K9; phase 8's clean run,
   phase 9 (b)'s rank 0 first process and phase 10's rank 0 for K3 and
   K5-K7; phase 11 for K5-K7 and, on ring_int8, K2 and K4; phase 12's
   ``pipeline`` and ``moe`` paths for K5-K7 and, on its int8 arms, K2
   and K4; phase 13's ``elastic_hybrid`` path, its dp0/pp0 rank in both
   worlds, for K3 and K5-K7; phase 14's ``serve_prefix`` (the cached
   disaggregated run) and ``serve_tp`` (rank 0's tp cluster) paths for
   K2 and K4; phase 15's ``cluster`` path (rank 0 of the ViT-B/16 fit)
   for K5-K7 and its ``spark`` and ``ray`` paths (rank 0 of each world)
   for K1; phase 16's ``fleet`` path for K2 and K4 (the serve cache
   path attends in plain PyTorch: K5 is counted there and launches
   none) and its ``mxnet`` path for K1), the card line, and
   last ``{"ok": true,
   "device": {...}}``.

``--profile`` also traces the serve run and two extra training steps of
GPT-2 medium, each integrity run, BERT-large, ViT-B/16 and ResNet-50
with torch.profiler
(after the timed steps, so the timed numbers stay unprofiled) and prints
the device busy share and the top device ops.

Processes: a zygote (``--zygote``) imports torch once, touches no card,
and forks the multi-rank phases' rank workers. The workers a launcher
starts (phases 8, 9, 10 and 13), and those launchers (``--module``),
run as ``--via-zygote`` processes, which have the zygote fork the
worker on their own environment and streams, pass signals on and end
with its exit code; without a zygote they run the worker themselves.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12              # non-tensor-core fp32 peak
BF16_OPS_PER_S = 989e12             # dense bf16 tensor-core peak
HANDOFF_LEAVES = 48                 # gpt_medium: 24 layers x (k, v)
LEAF = (1024, 16, 64)               # (max_len, heads, head_dim)
RAGGED = ((37, 16, 64), (5000,), (1,))
RAGGED_GROUP = ((1,), (4095,), (4097,), (5000,), (37, 16, 64))
REF_LOGIT_RTOL = 5e-2               # bf16 vs fp32 logits, of max |logit|


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


#: What the bytecode warm-up imports: each worker process imports these.
PYCACHE_WARM = ("torch", "torch._dynamo", "torch.distributed",
                "horovod_tpu_torch", "horovod_tpu_torch.models.gpt",
                "horovod_tpu_torch.optim", "horovod_tpu_torch.zero",
                "horovod_tpu_torch.elastic", "horovod_tpu_torch.checkpoint",
                "horovod_tpu_torch.runner.launch",
                "horovod_tpu_torch.runner.elastic_driver",
                "horovod_tpu_torch.executor",
                "horovod_tpu_torch.torch_estimator",
                "horovod_tpu_torch.models.vit", "horovod_tpu_torch.spark",
                "horovod_tpu_torch.ray",
                "horovod_tpu_torch.testing.fake_spark",
                "horovod_tpu_torch.testing.fake_ray")


def bytecode_cache() -> subprocess.Popen:
    """Give every process this script starts a bytecode cache in the
    checkout's ``build/pycache`` and start filling it. A machine that sets
    ``PYTHONDONTWRITEBYTECODE`` and keeps no ``.pyc`` beside torch's
    sources makes each new process compile torch from source: 17.5-18.7 s
    for ``import torch, torch._dynamo`` on the H100's host (the first
    ``torch.optim`` call imports ``torch._dynamo``), in each of the ≈ 80
    processes the multi-rank phases start. Returns the warm-up process,
    which imports ``PYCACHE_WARM`` once."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(root, "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return subprocess.Popen(
        [sys.executable, "-c", "import " + ", ".join(PYCACHE_WARM)],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, inputs, reps: int = 20) -> float:
    """Device ms per call: ``fn`` over every input captured in one CUDA
    graph, replayed ``reps`` times (median of replays / len(inputs))."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(times)


def eager_ms(torch, fn, inputs, reps: int = 5) -> float:
    """ms per call launched eagerly from Python (host overhead included)."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3 / len(inputs))
    return statistics.median(times)


def codec_group(torch, gen) -> list:
    """The grouped codec case: the 48 handoff leaves (bf16), two fp32
    leaves of the same shape, every RAGGED_GROUP size in bf16 and fp32, a
    bf16 and an fp32 view one element past a 16-byte boundary (the
    kernels' scalar path), and an all-zero first block in leaf 0: 62
    leaves, one launch a side."""
    xs = [torch.randn(LEAF, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(HANDOFF_LEAVES)]
    xs += [torch.randn(LEAF, generator=gen, device="cuda") for _ in range(2)]
    for dtype in (torch.bfloat16, torch.float32):
        xs += [torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in RAGGED_GROUP]
        xs.append(torch.randn(9001, generator=gen, device="cuda")
                  .to(dtype)[1:])
    xs[0].view(-1)[:4096] = 0
    return xs


def check_codec_group(torch, K, xs, launches: int) -> tuple:
    """quantize_int8_group, then dequantize_int8_into (a misaligned input
    into a misaligned output), against the plain versions leaf by leaf:
    codes and outputs bitwise, scales to 1e-6; each side ``launches``
    launches coding ``len(xs)`` leaves. Returns the largest code/scale
    and output differences."""
    K.reset_launch_counts()
    got = K.quantize_int8_group(xs)
    outs = [torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:]
            .view(x.shape) if x.data_ptr() % 16 else torch.empty_like(x)
            for x in xs]
    K.dequantize_int8_into(got, outs)
    torch.cuda.synchronize()
    counts, leaves = dict(K.LAUNCHES), dict(K.CODEC_LEAVES)
    K.reset_launch_counts()
    what = f"grouped codec ({len(xs)} leaves)"
    for side in ("quantize_int8", "dequantize_int8"):
        check(counts[side] == launches and leaves[side] == len(xs),
              f"{what}: {side} made {counts[side]} launches over "
              f"{leaves[side]} leaves, expected {launches} over {len(xs)}")
    q_err = deq_err = 0.0
    for i, (x, (q, s, n), out) in enumerate(zip(xs, got, outs)):
        q0, s0, n0 = K._quantize_plain(x)
        out0 = K._dequantize_plain(q0, s0, n0, x.shape, x.dtype)
        check(n == n0 and q.shape == q0.shape and torch.equal(q, q0),
              f"{what}: leaf {i} {tuple(x.shape)} {x.dtype}: codes differ "
              "from plain")
        rel = ((s - s0).abs() / s0.abs()).max().item()
        check(rel <= 1e-6, f"{what}: leaf {i}: scale rel err {rel} > 1e-6")
        check(torch.equal(out, out0), f"{what}: leaf {i}: output differs "
                                      "from plain")
        q_err = max(q_err, (s - s0).abs().max().item())
        deq_err = max(deq_err, (out.float() - out0.float()).abs()
                      .max().item())
    return q_err, deq_err


def check_slot_sentinel(torch, K, gen) -> None:
    """K4 into slot 3 of an (8, 1024, 16, 64) bf16 slab filled with a NaN
    sentinel: the slot bitwise the plain version's, the other seven
    slots the sentinel to the bit."""
    slab = torch.empty((8,) + LEAF, dtype=torch.bfloat16, device="cuda")
    slab.view(torch.int16).fill_(0x7FA5)
    x = torch.randn(LEAF, generator=gen, device="cuda").to(torch.bfloat16)
    q, s, n = K.quantize_int8(x)
    K.dequantize_int8_into([(q, s, n)], [slab[3]])
    want = K._dequantize_plain(q, s, n, LEAF, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(slab[3], want), "dequantize_int8_into: the cache "
                                      "slot differs from plain")
    others = torch.cat([slab[:3], slab[4:]]).view(torch.int16)
    check(bool((others == 0x7FA5).all()), "dequantize_int8_into: wrote "
                                          "outside its cache slot")


def host_ms(torch, fn, inputs, reps: int = 20) -> float:
    """Host ms per call: the time ``fn`` takes to return (argument
    checks, allocation, launch), the device's work left out."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for x in inputs:
            fn(x)
        times.append((time.perf_counter() - start) * 1e3 / len(inputs))
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_kernels(torch, K) -> dict:
    """Hold K2/K4 against their plain versions on the card, per leaf and
    grouped; time one leaf a launch and one handoff a launch."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [(LEAF, torch.bfloat16), (LEAF, torch.float32)] + \
        [(s, torch.bfloat16) for s in RAGGED] + \
        [(s, torch.float32) for s in RAGGED]
    q_err = deq_err = 0.0
    for shape, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if x.numel() >= 2 * K.BLOCK:
            x.view(-1)[:K.BLOCK] = 0                   # an all-zero block
            x.view(-1)[K.BLOCK:K.BLOCK + 4] = torch.tensor(
                [127.0, 2.5, -3.5, 0.5], device="cuda").to(dtype)
        q, s, n = K.quantize_int8(x)
        q0, s0, n0 = K._quantize_plain(x)
        out = K.dequantize_int8(q, s, n, shape, dtype)
        out0 = K._dequantize_plain(q0, s0, n0, shape, dtype)
        torch.cuda.synchronize()
        check(n == n0 and q.shape == q0.shape and s.shape == s0.shape,
              f"quantize_int8 {shape} {dtype}: shapes differ")
        check(torch.equal(q, q0),
              f"quantize_int8 {shape} {dtype}: codes differ from plain")
        rel = ((s - s0).abs() / s0.abs()).max().item()
        check(rel <= 1e-6, f"quantize_int8 {shape} {dtype}: scale rel "
                           f"err {rel} > 1e-6")
        check(torch.equal(out, out0), f"dequantize_int8 {shape} {dtype}: "
                                      "output differs from plain")
        q_err = max(q_err, (q.int() - q0.int()).abs().max().item(),
                    (s - s0).abs().max().item())
        deq_err = max(deq_err, (out.float() - out0.float()).abs()
                      .max().item())
    group = codec_group(torch, gen)
    errs = [check_codec_group(torch, K, group, 1)]
    extra = [torch.randn(4096 * (1 + i % 3) - i, generator=gen,
                         device="cuda") for i in range(8)]
    errs.append(check_codec_group(torch, K, group + extra, 2))
    check_slot_sentinel(torch, K, gen)
    q_err = max([q_err] + [e[0] for e in errs])
    deq_err = max([deq_err] + [e[1] for e in errs])
    print(f"kernels: K2/K4 bitwise equal to plain on {len(cases)} shapes, "
          f"grouped on {len(group)} leaves (one launch a side) and "
          f"{len(group) + len(extra)} (two), and into a cache slot with "
          "the other slots untouched", flush=True)
    del group, extra

    leaves = [torch.randn(LEAF, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(HANDOFF_LEAVES)]
    blobs = [K.quantize_int8(x) for x in leaves]
    outs = [torch.empty_like(x) for x in leaves]
    torch.cuda.synchronize()

    def quant(x):
        return K.quantize_int8(x)

    def quant_plain(x):
        return K._quantize_plain(x)

    def quant_group(xs):
        return K.quantize_int8_group(xs)

    def quant_singles(xs):
        return [K.quantize_int8(x) for x in xs]

    def deq(b):
        return K.dequantize_int8(b[0], b[1], b[2], LEAF, torch.bfloat16)

    def deq_plain(b):
        return K._dequantize_plain(b[0], b[1], b[2], LEAF, torch.bfloat16)

    def deq_group(bs):
        K.dequantize_int8_into(bs, outs)

    def deq_singles(bs):
        for b, o in zip(bs, outs):
            K.dequantize_int8_into([b], [o])

    n = leaves[0].numel()
    nblocks = -(-n // K.BLOCK)
    q_bytes = n * 2 + nblocks * K.BLOCK + nblocks * 4
    d_bytes = nblocks * K.BLOCK + nblocks * 4 + n * 2
    records = {}
    for name, fn, plain, grouped, singles, inputs, nbytes, ops, err, \
            line in (
            ("quantize_int8", quant, quant_plain, quant_group,
             quant_singles, leaves, q_bytes, 6 * n, q_err, 225),
            ("dequantize_int8", deq, deq_plain, deq_group, deq_singles,
             blobs, d_bytes, 2 * n, deq_err, 233)):
        # Turns: plain, one leaf a launch, a handoff as 48 launches, a
        # handoff as one launch, then back in reverse (one card, one call).
        p1 = graph_ms(torch, plain, inputs)
        k1 = graph_ms(torch, fn, inputs)
        c1 = graph_ms(torch, singles, [inputs])
        g1 = graph_ms(torch, grouped, [inputs])
        g2 = graph_ms(torch, grouped, [inputs])
        c2 = graph_ms(torch, singles, [inputs])
        k2 = graph_ms(torch, fn, inputs)
        p2 = graph_ms(torch, plain, inputs)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / FP32_OPS_PER_S * 1e3
        records[name] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/int8_codec.cu",
            "replaces": f"horovod_tpu/ops/pallas_kernels.py:{line}",
            "launches": 0,
            "max_abs_err": err,
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": None,
            "eager_ms": eager_ms(torch, fn, inputs),
            "plain_eager_ms": eager_ms(torch, plain, inputs),
            "handoff_ms": min(g1, g2),
            "handoff_bound_ms": HANDOFF_LEAVES * nbytes / HBM_BYTES_PER_S
            * 1e3,
            "handoff_single_ms": min(c1, c2),
            "handoff_eager_ms": eager_ms(torch, grouped, [inputs], reps=20),
            "handoff_single_eager_ms": eager_ms(torch, singles, [inputs],
                                                reps=20),
            "handoff_host_ms": host_ms(torch, grouped, [inputs]),
            "handoff_single_host_ms": host_ms(torch, singles, [inputs]),
            "handoff_leaves": HANDOFF_LEAVES,
            "shape": list(LEAF), "dtype": "bfloat16",
        }
        r = records[name]
        print(f"kernel {name}: {r['ms'] * 1e3:.2f} us/launch (graph) vs "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); "
              f"plain {r['plain_ms'] * 1e3:.2f} us; eager "
              f"{r['eager_ms'] * 1e3:.2f} us; handoff of "
              f"{HANDOFF_LEAVES} leaves: one launch "
              f"{r['handoff_ms'] * 1e3:.2f} us (graph), "
              f"{r['handoff_eager_ms'] * 1e3:.2f} us (eager), "
              f"{HANDOFF_LEAVES} launches "
              f"{r['handoff_single_ms'] * 1e3:.2f} us (graph), "
              f"{r['handoff_single_eager_ms'] * 1e3:.2f} us (eager), "
              f"bound {r['handoff_bound_ms'] * 1e3:.2f} us; host "
              f"{r['handoff_host_ms'] * 1e3:.1f} vs "
              f"{r['handoff_single_host_ms'] * 1e3:.1f} us", flush=True)
    return records


# (B, S, H, D), dtype name, causal, key mask ("random": 70% of keys,
# "lengths": a padded batch's per-sample lengths in [S/2, S]), nonzero
# dlse, and whether q, k, v are ``split`` views of one (B, S, 3 H D)
# tensor, as the models' fused QKV projection makes them (row stride
# 3 H D: the TMA strides)
FLASH_PATH = (8, 512, 16, 64)       # the GPT training path's shape
BERT_PATH = (8, 512, 16, 64)        # BERT-large, non-causal, key mask
VIT_PATH = (64, 197, 12, 64)        # ViT-B/16 at 224: 196 patches + CLS
SP_BLOCK = (2, 512, 16, 64)         # a striped-ring block of phase 11
FLASH_CASES = (
    (FLASH_PATH, "bfloat16", True, None, False, False),
    (FLASH_PATH, "float32", True, None, False, False),
    ((2, 256, 4, 64), "float32", False, "random", False, False),
    ((2, 256, 4, 128), "float32", True, None, True, False),
    ((2, 200, 4, 64), "float32", True, "random", True, False),
    ((2, 200, 4, 128), "bfloat16", False, None, True, False),
    ((2, 200, 4, 64), "bfloat16", True, "random", True, False),
    (FLASH_PATH, "bfloat16", True, None, False, True),
    ((2, 256, 4, 128), "bfloat16", True, None, False, False),
    (BERT_PATH, "bfloat16", False, "lengths", False, True),
    (VIT_PATH, "bfloat16", False, None, False, True),
    # The striped ring's strict block: K/V rolled one position, key 0
    # masked, causal: query row 0 fully masked (lse -1e30), and a live
    # lse cotangent.
    (SP_BLOCK, "bfloat16", True, "strict", True, False),
)
FLASH_TOL = {"float32": (2e-4, 5e-3), "bfloat16": (2e-2, 2e-2)}
FLASH_TIMING_SETS = 8               # distinct inputs per graph replay
# The timed paths: (shape, causal, key mask) of each model's attention.
FLASH_TIMED = {"gpt_train": (FLASH_PATH, True, None),
               "bert": (BERT_PATH, False, "lengths"),
               "vit": (VIT_PATH, False, None)}


def close_err(torch, got, want, tol: float, what: str) -> float:
    """Max |got - want|; fails where it exceeds tol + tol * |want|, and
    on any non-finite value on either side (a NaN compares false, so it
    must not reach the comparison)."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool(torch.isfinite(want).all()),
          f"{what}: non-finite plain version")
    diff = (got - want).abs()
    bad = diff > tol + tol * want.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements off "
                               f"the plain version by more than {tol} "
                               f"(max abs err {diff.max().item():.3g})")
    return diff.max().item()


def length_mask(torch, b: int, s: int, gen):
    """A padded batch's key mask: sample i attends to its first
    ``lengths[i]`` keys, lengths drawn in [S/2, S] from ``gen``."""
    lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                            device=gen.device)
    return (torch.arange(s, device=gen.device)[None, :]
            < lengths[:, None]).float()


def flash_inputs(torch, shape, dtype, mask_kind, dlse_on, gen,
                 fused=False):
    b, s, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    if fused:
        qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, -1))
    mask = None
    if mask_kind == "random":
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                ).float()
        mask[:, 0] = 1.0
    elif mask_kind == "lengths":
        mask = length_mask(torch, b, s, gen)
    elif mask_kind == "strict":
        k, v = torch.roll(k, 1, dims=1), torch.roll(v, 1, dims=1)
        mask = torch.ones((b, s), device="cuda")
        mask[:, 0] = 0.0
    dlse = torch.randn((b, h, s), generator=gen, device="cuda") \
        if dlse_on else None
    return q, k, v, do, mask, dlse


def flash_work(shape, causal: bool, mask) -> dict:
    """Bytes each kernel must move (inputs read once, outputs written
    once) and FLOPs the work needs, at bf16 q/k/v/do/o/dq/dk/dv, fp32
    lse/delta and an fp32 key mask, without dlse. Causal work is the
    (query, key) pairs at or below the diagonal; a key mask does not
    shrink it (the kernels visit every tile and mask inside it)."""
    b, s, h, d = shape
    x = b * s * h * d * 2                  # one bf16 (B, S, H, D) tensor
    row = b * h * s * 4                    # one fp32 (B, H, S) vector
    m = 0 if mask is None else b * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return {"flash_fwd": (4 * x + row + m, 4 * pairs * d),
            "flash_bwd_dq": (5 * x + 2 * row + m, 6 * pairs * d),
            "flash_bwd_dkv": (6 * x + 2 * row + m, 8 * pairs * d)}


def time_flash(torch, K, shape, causal: bool, mask_kind, gen) -> dict:
    """K5/K6/K7 at one path's shape in bf16: CUDA graph replay over
    distinct input sets (in turns with the plain version: plain, kernel,
    kernel, plain), eager, the bound, and the library call
    ``scaled_dot_product_attention`` (``is_causal`` or the same key mask
    as a boolean ``attn_mask``): its forward against K5, its backward (a
    graph of forward + backward less the forward's) against K6 + K7."""
    sets = []
    for _ in range(FLASH_TIMING_SETS):
        q, k, v, do, mask, _ = flash_inputs(torch, shape, torch.bfloat16,
                                            mask_kind, False, gen)
        o, lse = K._flash_fwd_plain(q, k, v, mask, causal)
        sets.append((q, k, v, do, o, lse, K.flash_delta(o, do), mask))
    torch.cuda.synchronize()
    fns = {
        "flash_fwd": (
            lambda x: K.flash_fwd(x[0], x[1], x[2], x[7], causal),
            lambda x: K._flash_fwd_plain(x[0], x[1], x[2], x[7], causal)),
        "flash_bwd_dq": (
            lambda x: K.flash_bwd_dq(x[0], x[1], x[2], x[7], causal, x[3],
                                     x[5], x[6]),
            lambda x: K._flash_bwd_dq_plain(x[0], x[1], x[2], x[7], causal,
                                            x[3], x[5], x[6])),
        "flash_bwd_dkv": (
            lambda x: K.flash_bwd_dkv(x[0], x[1], x[2], x[7], causal, x[3],
                                      x[5], x[6]),
            lambda x: K._flash_bwd_dkv_plain(x[0], x[1], x[2], x[7], causal,
                                             x[3], x[5], x[6])),
    }
    # The yardstick: one PyTorch call of the same function on the same
    # (B, S, H, D) tensors, viewed as (B, H, S, D). Timed only; the port
    # never calls it.
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_kw(x):
        if causal:
            return {"is_causal": True}
        if x[7] is None:
            return {}
        return {"attn_mask": (x[7] > 0)[:, None, None, :]}

    def lib_fwd(x):
        return sdpa(*(t.transpose(1, 2) for t in x[:3]), **lib_kw(x))

    def lib_fwd_bwd(x):
        q, k, v = (t.transpose(1, 2).detach().requires_grad_()
                   for t in x[:3])
        o = sdpa(q, k, v, **lib_kw(x))
        return torch.autograd.grad(o, (q, k, v), x[3].transpose(1, 2))

    fwd_ms = graph_ms(torch, lib_fwd, sets)
    bwd_ms = graph_ms(torch, lib_fwd_bwd, sets) - fwd_ms
    library = {"flash_fwd": fwd_ms, "flash_bwd_dq": bwd_ms,
               "flash_bwd_dkv": bwd_ms}
    # The training paths' backward: K6 then K7 in one call.
    bwd_one = min(graph_ms(torch, lambda x: K.flash_bwd(
        x[0], x[1], x[2], x[7], causal, x[4], x[5], x[3]), sets)
        for _ in range(2))
    out = {}
    for name, (nbytes, flops) in flash_work(shape, causal,
                                            mask_kind).items():
        fn, plain = fns[name]
        p1 = graph_ms(torch, plain, sets)
        k1 = graph_ms(torch, fn, sets)
        k2 = graph_ms(torch, fn, sets)
        p2 = graph_ms(torch, plain, sets)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_OPS_PER_S * 1e3
        out[name] = {
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_bytes_ms": bound_bytes, "bound_ops_ms": bound_ops,
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": library[name],
            "eager_ms": eager_ms(torch, fn, sets),
            "plain_eager_ms": eager_ms(torch, plain, sets),
            "bytes": nbytes, "flops": flops, "shape": list(shape),
            "dtype": "bfloat16", "causal": causal, "key_mask": mask_kind,
        }
        if name != "flash_fwd":
            # delta = rowsum(do * o) included, as in SDPA's backward
            out[name]["bwd_one_call_ms"] = bwd_one
    del sets
    torch.cuda.empty_cache()
    return out


def phase_flash(torch, K) -> dict:
    """Hold K5/K6/K7 against their plain versions on the card; time them
    at the attention shapes of the GPT training, BERT and ViT paths."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape, dname, causal, mask_kind, dlse_on, fused in FLASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v, do, mask, dlse = flash_inputs(torch, shape, dtype,
                                               mask_kind, dlse_on, gen,
                                               fused)
        fwd_tol, grad_tol = FLASH_TOL[dname]
        what = (f"{shape} {dname} causal={causal} mask={mask_kind} "
                f"dlse={dlse_on} fused={fused}")
        o, lse = K.flash_fwd(q, k, v, mask, causal)
        o0, lse0 = K._flash_fwd_plain(q, k, v, mask, causal)
        delta = K.flash_delta(o0, do)
        dq = K.flash_bwd_dq(q, k, v, mask, causal, do, lse0, delta, dlse)
        dk, dv = K.flash_bwd_dkv(q, k, v, mask, causal, do, lse0, delta,
                                 dlse)
        dq0 = K._flash_bwd_dq_plain(q, k, v, mask, causal, do, lse0, delta,
                                    dlse)
        dk0, dv0 = K._flash_bwd_dkv_plain(q, k, v, mask, causal, do, lse0,
                                          delta, dlse)
        bwd = K.flash_bwd(q, k, v, mask, causal, o0, lse0, do, dlse)
        torch.cuda.synchronize()
        check(o.dtype == dtype and lse.dtype == torch.float32
              and dq.dtype == dk.dtype == dv.dtype == dtype,
              f"flash {what}: output dtypes")
        for got, want, label, key in zip(
                bwd, (dq0, dk0, dv0), ("dq", "dk", "dv"),
                ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv")):
            errs[key] = max(errs[key], close_err(
                torch, got, want, grad_tol, f"flash_bwd {label} {what}"))
        errs["flash_fwd"] = max(
            errs["flash_fwd"],
            close_err(torch, o, o0, fwd_tol, f"flash_fwd o {what}"),
            close_err(torch, lse, lse0, fwd_tol, f"flash_fwd lse {what}"))
        errs["flash_bwd_dq"] = max(
            errs["flash_bwd_dq"],
            close_err(torch, dq, dq0, grad_tol, f"flash_bwd_dq {what}"))
        errs["flash_bwd_dkv"] = max(
            errs["flash_bwd_dkv"],
            close_err(torch, dk, dk0, grad_tol, f"flash_bwd_dkv dk {what}"),
            close_err(torch, dv, dv0, grad_tol, f"flash_bwd_dkv dv {what}"))
        del q, k, v, do, o, lse, o0, lse0, delta, dq, dk, dv, dq0, dk0, dv0
        del bwd
    torch.cuda.empty_cache()
    print(f"kernels: K5/K6/K7 agree with plain on {len(FLASH_CASES)} cases; "
          f"max abs err {json.dumps(errs)}", flush=True)

    timed = {path: time_flash(torch, K, *spec, gen)
             for path, spec in FLASH_TIMED.items()}
    lines = {"flash_fwd": 74, "flash_bwd_dq": 122, "flash_bwd_dkv": 172}
    # Each kernel's route by dtype inside the one C entry point.
    sm90 = "bf16: wgmma m64n64k16 on TMA-fed 128B-swizzled tiles ({})"
    cores = "fp32: CUDA-core FMAs ({})"
    designs = {
        "flash_fwd": sm90.format("flash_fwd_sm90") + "; "
        + cores.format("flash_fwd_kernel"),
        "flash_bwd_dq": sm90.format("flash_bwd_dq_sm90") + "; "
        + cores.format("flash_bwd_dq_kernel"),
        "flash_bwd_dkv": sm90.format("flash_bwd_dkv_sm90") + "; "
        + cores.format("flash_bwd_dkv_kernel"),
    }
    records = {}
    for name in lines:
        # The top-level numbers are the GPT training path's, as before;
        # every path's are under "paths".
        main = timed["gpt_train"][name]
        records[name] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{lines[name]}",
            "launches": 0,
            "design": designs[name],
            "max_abs_err": errs[name],
            **main,
            "library_call": "scaled_dot_product_attention "
                            + ("forward" if name == "flash_fwd" else
                               "backward (dq, dk, dv: K6 + K7 together)")
                            + " with the path's is_causal or attn_mask",
            "paths": {path: t[name] for path, t in timed.items()},
        }
        for path, t in timed.items():
            r = t[name]
            print(f"kernel {name} [{path} {tuple(r['shape'])} "
                  f"causal={r['causal']} mask={r['key_mask']}]: "
                  f"{r['ms'] * 1e3:.1f} us/launch (graph) vs bound "
                  f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); plain "
                  f"{r['plain_ms'] * 1e3:.1f} us; library "
                  f"{r['library_ms'] * 1e3:.1f} us; eager "
                  f"{r['eager_ms'] * 1e3:.1f} us", flush=True)
    for path, t in timed.items():
        print(f"kernel flash_bwd [{path}] (K6 + K7, one call, delta "
              f"included): {t['flash_bwd_dq']['bwd_one_call_ms'] * 1e3:.1f} "
              f"us (graph) vs SDPA backward "
              f"{t['flash_bwd_dq']['library_ms'] * 1e3:.1f} us", flush=True)
    return records


REDUCE_BUCKET = 16_777_216          # one 64 MiB fp32 fusion bucket
TOK_EMB = (50257, 1024)             # gpt_medium's largest gradient
REDUCE_RAGGED = (1, 4095, 4097, 9001)
ADASUM_RTOL = 1e-5                  # K8 vs fp64, of each sum's own scale
REDUCE_TIMING_SETS = 2              # distinct inputs per graph replay


def reduce_work(n: int) -> dict:
    """Bytes each kernel must move (inputs read once, outputs written
    once) and fp32 operations it does, for n fp32 elements."""
    rows = -(-n // 4096) * 32
    nblocks = rows // 32
    return {"quantize_int8_stochastic": (n * 4 + rows * 128 * 4 + rows * 128
                                         + nblocks * 4, 8 * n),
            "adasum_dot_norms": (2 * n * 4, 6 * n),
            "adasum_combine": (3 * n * 4, 3 * n)}


def phase_reduce_kernels(torch, K) -> dict:
    """Hold K3/K8/K9 against their plain versions on the card at the
    multi-rank path's shapes; time them."""
    gen = torch.Generator(device="cuda").manual_seed(2024)
    emb = TOK_EMB[0] * TOK_EMB[1]
    errs = {"quantize_int8_stochastic": 0.0, "adasum_dot_norms": 0.0,
            "adasum_combine": 0.0}
    k8_rel = 0.0            # K8's worst error relative to its sum's scale
    k3_cases = [(REDUCE_BUCKET, "float32"), (emb, "float32"),
                (REDUCE_BUCKET, "bfloat16")] + \
        [(n, d) for n in REDUCE_RAGGED for d in ("float32", "bfloat16")]
    for n, dname in k3_cases:
        x = (torch.randn(n, generator=gen, device="cuda") * 3).to(
            getattr(torch, dname))
        u = torch.rand((K.stochastic_rows(n), 128), generator=gen,
                       device="cuda")
        q, s, _ = K.quantize_int8_stochastic(x, u)
        q0, s0, _ = K._quantize_stochastic_plain(x, u)
        torch.cuda.synchronize()
        check(torch.equal(q, q0), f"K3 {n} {dname}: codes differ from plain")
        check(torch.equal(s, s0), f"K3 {n} {dname}: scales differ from plain")
    del x, u, q, s, q0, s0
    # (elements, dtype, which operands are zero)
    k89_cases = [(emb, "float32", ""), (emb, "bfloat16", ""),
                 (REDUCE_BUCKET, "float32", ""), (70_000, "float32", "b"),
                 (4097, "bfloat16", "ab")] + \
        [(n, d, "") for n in REDUCE_RAGGED for d in ("float32", "bfloat16")]
    for n, dname, zero in k89_cases:
        what = f"{n} {dname} zero={zero or '-'}"
        a = torch.randn(n, generator=gen, device="cuda")
        b = 0.6 * a + torch.randn(n, generator=gen, device="cuda")
        if "a" in zero:
            a.zero_()
        if "b" in zero:
            b.zero_()
        a, b = a.to(getattr(torch, dname)), b.to(getattr(torch, dname))
        dn = K.adasum_dot_norms(a, b)
        dn_swap = K.adasum_dot_norms(b, a)
        a64, b64 = a.double(), b.double()
        exact = torch.stack([a64 @ b64, a64 @ a64, b64 @ b64])
        scale = torch.stack([(exact[1] * exact[2]).sqrt(), exact[1],
                             exact[2]])
        off = (dn.double() - exact).abs()
        check(bool((off <= ADASUM_RTOL * scale).all()),
              f"K8 {what}: {dn.tolist()} off fp64 {exact.tolist()} by more "
              f"than {ADASUM_RTOL} of each sum's scale")
        check(torch.equal(dn[[0, 2, 1]], dn_swap),
              f"K8 {what}: not symmetric in (a, b)")
        out = K.adasum_combine(a, b, dn)
        out0 = K._adasum_combine_plain(a, b, dn)
        torch.cuda.synchronize()
        check(torch.equal(out, out0), f"K9 {what}: differs from plain")
        check(torch.equal(K.adasum_combine(b, a, dn_swap), out),
              f"K9 {what}: not symmetric in (a, b)")
        if zero:
            check(torch.equal(out, (a.float() + b.float()).to(a.dtype)),
                  f"K9 {what}: zero-norm coefficient is not 1")
        errs["adasum_dot_norms"] = max(errs["adasum_dot_norms"],
                                       off.max().item())
        k8_rel = max(k8_rel, (off / scale.clamp_min(1e-300)).max().item())
    del a, b, a64, b64, out, out0
    torch.cuda.empty_cache()
    print(f"kernels: K3 bitwise equal to plain on {len(k3_cases)} cases; "
          f"K8 within {ADASUM_RTOL} of fp64 and K9 bitwise equal to plain "
          f"on {len(k89_cases)} cases, both symmetric in (a, b)",
          flush=True)

    buckets = []
    for _ in range(REDUCE_TIMING_SETS):
        buckets.append((torch.randn(REDUCE_BUCKET, generator=gen,
                                    device="cuda"),
                        torch.rand((K.stochastic_rows(REDUCE_BUCKET), 128),
                                   generator=gen, device="cuda")))
    pairs = []
    for _ in range(REDUCE_TIMING_SETS):
        a = torch.randn(emb, generator=gen, device="cuda")
        b = 0.6 * a + torch.randn(emb, generator=gen, device="cuda")
        pairs.append((a, b, K.adasum_dot_norms(a, b)))
    torch.cuda.synchronize()
    fns = {
        "quantize_int8_stochastic": (
            lambda x: K.quantize_int8_stochastic(x[0], x[1]),
            lambda x: K._quantize_stochastic_plain(x[0], x[1]), buckets,
            REDUCE_BUCKET, 275, "int8_codec.cu"),
        "adasum_dot_norms": (
            lambda x: K.adasum_dot_norms(x[0], x[1]),
            lambda x: K._adasum_dot_norms_plain(x[0], x[1]), pairs, emb,
            125, "adasum.cu"),
        "adasum_combine": (
            lambda x: K.adasum_combine(x[0], x[1], x[2]),
            lambda x: K._adasum_combine_plain(x[0], x[1], x[2]), pairs, emb,
            175, "adasum.cu"),
    }
    records = {}
    for name, (fn, plain, inputs, n, line, src) in fns.items():
        nbytes, ops = reduce_work(n)[name]
        # Turns: plain, kernel, kernel, plain (one card, one call).
        p1 = graph_ms(torch, plain, inputs)
        k1 = graph_ms(torch, fn, inputs)
        k2 = graph_ms(torch, fn, inputs)
        p2 = graph_ms(torch, plain, inputs)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / FP32_OPS_PER_S * 1e3
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{src}",
            "replaces": f"horovod_tpu/ops/pallas_kernels.py:{line}",
            "launches": 0,
            "max_abs_err": errs[name],
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": None,
            "eager_ms": eager_ms(torch, fn, inputs),
            "plain_eager_ms": eager_ms(torch, plain, inputs),
            "bytes": nbytes, "ops": ops,
            "max_rel_err": k8_rel if name == "adasum_dot_norms" else 0.0,
            "shape": [n] if name == "quantize_int8_stochastic"
            else list(TOK_EMB), "dtype": "float32",
        }
        r = records[name]
        print(f"kernel {name}: {r['ms'] * 1e3:.1f} us/launch (graph) vs "
              f"bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}); plain "
              f"{r['plain_ms'] * 1e3:.1f} us; eager "
              f"{r['eager_ms'] * 1e3:.1f} us", flush=True)
    del buckets, pairs
    torch.cuda.empty_cache()
    return records


SCALE_BIAS = 1024                   # a LayerNorm bias of gpt_medium
SCALE_SIZES = (TOK_EMB[0] * TOK_EMB[1], SCALE_BIAS) + REDUCE_RAGGED
SCALE_FACTORS = (1 / 3, 0.7, 2.5)
# (input dtype, output dtype)
SCALE_CASES = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float16", "float16"), ("float32", "bfloat16"))


def phase_scale_kernel(torch, K, C) -> dict:
    """Hold K1 against its plain version on the card, bitwise, at the
    eager path's sizes (GPT-2 medium's ``tok_emb`` gradient and a
    1,024-element bias) and ragged ones, for every dtype pair the path
    and the API take, with each scale rounded to the input's dtype as
    ``_apply_scale`` rounds it; and hold ``_apply_scale`` itself to the
    plain version with the rounded scale. Time it on ``tok_emb`` and on
    the bias in fp32 beside the bound and ``torch.mul``."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    checked = 0
    for n in SCALE_SIZES:
        full = torch.randn(n + 1, generator=gen, device="cuda") * 3
        for din, dout in SCALE_CASES:
            tin, tout = getattr(torch, din), getattr(torch, dout)
            # aligned, and one element past a 16-byte boundary
            for x, at in ((full[:n].to(tin), "aligned"),
                          (full.to(tin)[1:], "offset 1")):
                for s in SCALE_FACTORS:
                    rounded = torch.tensor(s, dtype=tin).item()
                    got = K.scale_buffer(x, rounded, tout)
                    want = K.scale_buffer_plain(x, rounded, tout)
                    check(torch.equal(got.view(-1), want.view(-1)),
                          f"K1 {n} {at} {din}->{dout} scale {s}: differs "
                          "from plain")
                    if din == dout:
                        check(torch.equal(C._apply_scale(x, s).view(-1),
                                          want.view(-1)),
                              f"_apply_scale {n} {at} {din} {s}: differs "
                              "from the plain K1 with the rounded scale")
                    checked += 1
        del full, x, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"kernels: K1 bitwise equal to plain in {checked} cases "
          f"({len(SCALE_SIZES)} sizes x 2 alignments x {len(SCALE_CASES)} "
          f"dtype pairs x {len(SCALE_FACTORS)} scales), _apply_scale with "
          "it", flush=True)

    s = torch.tensor(1 / 3, dtype=torch.float32).item()
    timing = {}
    # The bias is launch-bound: 64 launches a replay, so that the
    # replay's own fixed cost is spread thin.
    for label, n, sets in (("tok_emb", SCALE_SIZES[0], REDUCE_TIMING_SETS),
                           ("bias", SCALE_BIAS, 64)):
        inputs = [torch.randn(n, generator=gen, device="cuda")
                  for _ in range(sets)]

        def kern(x):
            return K.scale_buffer(x, s)

        def plain(x):
            return K.scale_buffer_plain(x, s)

        def lib(x):
            return torch.mul(x, s)

        # Turns: plain, kernel, library, library, kernel, plain (one
        # card, one call).
        p1 = graph_ms(torch, plain, inputs)
        k1 = graph_ms(torch, kern, inputs)
        l1 = graph_ms(torch, lib, inputs)
        l2 = graph_ms(torch, lib, inputs)
        k2 = graph_ms(torch, kern, inputs)
        p2 = graph_ms(torch, plain, inputs)
        timing[label] = {
            "elements": n, "launches_per_replay": sets,
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": min(l1, l2),
            "eager_ms": eager_ms(torch, kern, inputs),
            "plain_eager_ms": eager_ms(torch, plain, inputs),
            "bytes": 8 * n, "ops": n,
            "bound_bytes_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
            "bound_ops_ms": n / FP32_OPS_PER_S * 1e3}
        t = timing[label]
        print(f"kernel scale_buffer ({label}, {n} fp32): {t['ms'] * 1e3:.2f} "
              f"us/launch (graph) vs bound "
              f"{max(t['bound_bytes_ms'], t['bound_ops_ms']) * 1e3:.3f} us; "
              f"plain {t['plain_ms'] * 1e3:.2f} us; torch.mul "
              f"{t['library_ms'] * 1e3:.2f} us; eager "
              f"{t['eager_ms'] * 1e3:.2f} us", flush=True)
        del inputs
    torch.cuda.empty_cache()
    t = timing["tok_emb"]
    return {"scale_buffer": {
        "name": "scale_buffer", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/scale_buffer.cu",
        "replaces": "horovod_tpu/ops/pallas_kernels.py:87",
        "launches": 0, "max_abs_err": 0.0,
        "design": "streaming: one chunk of 2 x 256 16-byte vectors a "
                  "block, both ld.global.nc loads in flight before the "
                  "multiplies, st.global.cs stores",
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": max(t["bound_bytes_ms"], t["bound_ops_ms"]),
        "bound_by": "bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"]
        else "operations",
        "library_ms": t["library_ms"], "library_call": "torch.mul(x, s)",
        "eager_ms": t["eager_ms"], "plain_eager_ms": t["plain_eager_ms"],
        "bytes": t["bytes"], "ops": t["ops"], "shape": [t["elements"]],
        "dtype": "float32", "bias": timing["bias"],
        "cases_checked": checked}}


@contextlib.contextmanager
def attribution(torch, out_dir: str, phases: dict, enabled: bool):
    """With ``--profile``: time each batcher role's rounds and the
    handoff pump on the host clock (each closed by a device
    synchronize, so device work lands in the phase that queued it), and
    trace the run with torch.profiler. Writes the kernel table and the
    device busy share under ``out_dir``. Off: no instrumentation."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.serve.batcher import ContinuousBatcher
    from horovod_tpu_torch.serve.controller import ServeCluster

    def timed(cls, attr, key_of):
        orig = getattr(cls, attr)

        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return orig(self, *a, **k)
            finally:
                torch.cuda.synchronize()
                key = key_of(self)
                phases[key] = phases.get(key, 0.0) + \
                    time.perf_counter() - t0
        setattr(cls, attr, wrapper)
        return orig

    saved = [(ContinuousBatcher, "run_step",
              timed(ContinuousBatcher, "run_step",
                    lambda b: f"{b.role}_rounds")),
             (ServeCluster, "_pump_handoffs",
              timed(ServeCluster, "_pump_handoffs",
                    lambda _c: "handoff_import"))]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            wall = time.perf_counter() - t0
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    phases["profiled_wall_s"] = wall
    phases["device_busy_s"] = device_us / 1e6
    phases["device_busy_share"] = device_us / 1e6 / wall
    for side, kernel in (("quantize", "quantize_group_kernel"),
                         ("dequantize", "dequantize_group_kernel")):
        rows = [e for e in ka if kernel in e.key and (
            side == "dequantize" or "dequantize" not in e.key)]
        phases[f"codec_{side}_device_s"] = sum(
            e.self_device_time_total for e in rows) / 1e6
        phases[f"codec_{side}_kernels"] = sum(e.count for e in rows)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=25))
    print(f"profile: device busy {device_us / 1e6:.3f} s of "
          f"{wall:.3f} s wall ({100 * device_us / 1e6 / wall:.1f}%); "
          f"phases {json.dumps(phases)}", flush=True)


def reference_check(torch, model, gpt_mod) -> float:
    """bf16 cache-path logits against the same weights in fp32, on one
    32-token prompt prefilled then decoded token by token."""
    with torch.device("cuda"):
        ref = gpt_mod.gpt_medium(dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    gen = torch.Generator(device="cpu").manual_seed(7)
    toks = torch.randint(1, model.vocab_size, (1, 32), generator=gen)
    toks = toks.to("cuda")
    worst = 0.0
    outs = {}
    for label, m in (("bf16", model), ("fp32", ref)):
        cache = gpt_mod.init_kv_cache(m, 1, 64, device="cuda")
        lp, cache = m(toks[:, :24], cache=cache)
        steps = [lp]
        for t in range(24, 32):
            lg, cache = m(toks[:, t:t + 1], cache=cache)
            steps.append(lg)
        outs[label] = torch.cat(steps, dim=1)
    b, f = outs["bf16"], outs["fp32"]
    check(bool(torch.isfinite(b).all()), "reference: non-finite logits")
    check(b.shape == (1, 32, model.vocab_size), "reference: bad shape")
    worst = ((b - f).abs().max() / f.abs().max()).item()
    check(worst <= REF_LOGIT_RTOL,
          f"reference: bf16 logits off fp32 by {worst} of max|logit| "
          f"> {REF_LOGIT_RTOL}")
    del ref
    torch.cuda.empty_cache()
    return worst


def phase_serve(torch, K, out_dir: str, profile: bool = False,
                keep=None) -> dict:
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.serve import tracing
    from horovod_tpu_torch.serve.controller import ServeCluster, SLOPolicy
    from horovod_tpu_torch.serve.engine import make_engine_factory
    from horovod_tpu_torch.serve.traffic import poisson_trace

    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = gpt_mod.gpt_medium()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    check(model.num_layers == 24 and model.hidden == 1024
          and model.num_heads == 16 and model.mlp_dim == 4096
          and model.vocab_size == 50257, "gpt_medium geometry")
    ref_err = reference_check(torch, model, gpt_mod)
    print(f"reference: bf16 vs fp32 logits max err {ref_err:.4g} of "
          f"max|logit| (limit {REF_LOGIT_RTOL})", flush=True)
    factory = make_engine_factory(model, device="cuda", slots=8,
                                  max_len=1024, max_prompt_len=256,
                                  kv_kind="fp32")
    setup_s = time.perf_counter() - t0

    def trace(n):
        return poisson_trace(seed=0, n_requests=n, rate_rps=20.0,
                             prompt_lens=(64, 128, 256),
                             output_lens=(16, 32), vocab_size=50257)

    def cluster():
        tracing.reset()
        return ServeCluster(factory, policy=SLOPolicy(),
                            roles={"prefill": 1, "decode": 1},
                            step_s=0.05, log_path="")

    cluster().run(trace(2))                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    c = cluster()
    round_t = []

    def hook(_cluster, _idx):
        round_t.append(time.perf_counter())

    tr = trace(16)
    phases = {}
    with attribution(torch, out_dir, phases, enabled=profile):
        K.reset_launch_counts()
        rep = c.run(tr, round_hook=hook)
        torch.cuda.synchronize()
        round_t.append(time.perf_counter())
        launches = dict(K.LAUNCHES)
        codec_leaves = dict(K.CODEC_LEAVES)

    for side in ("quantize", "dequantize"):
        if f"codec_{side}_kernels" in phases:
            phases[f"codec_{side}_us_per_handoff"] = \
                phases[f"codec_{side}_device_s"] * 1e6 / rep["handoffs"]
            print(f"profile: {side} codec {phases[f'codec_{side}_kernels']} "
                  f"kernels, "
                  f"{phases[f'codec_{side}_us_per_handoff']:.2f} us of "
                  "device time per handoff", flush=True)
    check(rep["dropped"] == 0, f"dropped {rep['dropped']}")
    check(rep["completed"] == rep["submitted"] == 16,
          f"completed {rep['completed']} of {rep['submitted']}")
    check(rep["handoffs"] >= 1, "no prefill -> decode handoff")
    check(rep["pending_handoffs"] == 0, "handoffs left pending")
    by_rid = {r.rid: r for r in c.completed}
    for req in tr.requests:
        done = by_rid[req.rid]
        check(len(done.tokens) == req.max_new_tokens,
              f"rid {req.rid}: {len(done.tokens)} tokens, expected "
              f"{req.max_new_tokens}")
        check(all(0 <= t < 50257 for t in done.tokens),
              f"rid {req.rid}: token out of vocab")
    leaves = 2 * model.num_layers
    for name in ("quantize_int8", "dequantize_int8"):
        check(launches[name] > 0, f"{name}: no kernel launch on the serve "
                                  "path")
        check(launches[name] == rep["handoffs"],
              f"{name}: {launches[name]} launches != one grouped launch "
              f"for each of {rep['handoffs']} handoffs")
        check(codec_leaves[name] == leaves * rep["handoffs"],
              f"{name}: {codec_leaves[name]} leaves coded != {leaves} x "
              f"{rep['handoffs']} handoffs")

    ttft, tpot, wall_s = wall_view(c, round_t)
    result = {
        "model": "gpt_medium", "layers": 24, "hidden": 1024,
        "heads": 16, "mlp": 4096, "vocab": 50257, "dtype": "bfloat16",
        "roles": {"prefill": 1, "decode": 1}, "kv_kind": "fp32",
        "slots": 8, "max_len": 1024, "max_prompt_len": 256,
        "requests": 16, "handoffs": rep["handoffs"],
        "rounds": rep["rounds"],
        "generated_tokens": rep["generated_tokens"],
        "prefill_tokens": rep["prefill_tokens"],
        "wall_s": wall_s,
        "tokens_per_wall_s": rep["generated_tokens"] / wall_s,
        "wall_ms_per_round": wall_s * 1e3 / rep["rounds"],
        "ttft_wall_p50_s": statistics.median(ttft),
        "tpot_wall_p50_s": statistics.median(tpot) if tpot else None,
        "ttft_virtual_p50_s": rep["ttft_p50_s"],
        "tpot_virtual_p50_s": rep["tpot_p50_s"],
        "launches": launches,
        "codec_leaves": codec_leaves,
        "ref_logit_err": ref_err,
        "setup_s": setup_s,
        "profiled": profile,
        "phase_wall_s": phases,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    with open(os.path.join(out_dir, "chip_smoke_serve.json"), "w") as f:
        json.dump({"result": result, "events": rep["events"]}, f)
    print(f"serve: gpt_medium disaggregated, {rep['generated_tokens']} "
          f"tokens in {wall_s:.3f} s = "
          f"{result['tokens_per_wall_s']:.1f} tok/s (wall); TTFT p50 "
          f"{result['ttft_wall_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{(result['tpot_wall_p50_s'] or 0) * 1e3:.1f} ms (wall); "
          f"{rep['handoffs']} handoffs; launches {launches}", flush=True)
    if keep is not None:
        keep["model"] = model
    return result


def wall_view(c, round_t):
    """Wall-clock view of a virtual-time cluster run whose round hook
    stamped ``round_t`` (one stamp a round, one after the run): a
    round's wall span is hook(r) .. hook(r + 1). Returns each completed
    request's TTFT, each multi-token request's TPOT, and the run's wall
    seconds."""
    step = c.step_s
    route_round = {e[2]: e[0] for e in c.events if e[1] == "route"}

    def wall_end(r):
        return round_t[min(int(r) + 1, len(round_t) - 1)]

    ttft, tpot = [], []
    for r in c.completed:
        rf = round(r.first_token_t / step)
        rfin = round(r.finish_t / step)
        ttft.append(wall_end(rf) - round_t[route_round[r.rid]])
        if len(r.tokens) > 1:
            tpot.append((wall_end(rfin) - wall_end(rf))
                        / (len(r.tokens) - 1))
    return ttft, tpot, round_t[-1] - round_t[0]


# -- phase 14: the serve levers ----------------------------------------------

LEVER_GEOMETRY = dict(slots=8, max_len=1024, max_prompt_len=256,
                      kv_kind="fp32")
LEVER_IDENTITY_REQUESTS = 8         # each fp32 lever on / off pair
# Each bf16 timed run: 8, half the 16 first run, so the smoke stays
# inside its time limit on a slow host (the one cut of this phase).
LEVER_TIMED_REQUESTS = 8
LEVER_SHARED_PREFIX = 128           # the system prompt's tokens
LEVER_TAILS = (16, 64, 128)         # each request's own tokens after it
LEVER_SPEC_K = 4
NEAR_TIE_RTOL = 1e-4                # top-2 gap, of max |logit|
# The JAX bench's overload arm's policy fields (bench.py), one replica.
LEVER_OVERLOAD_POLICY = dict(
    tick_interval_s=0.1, window=8, min_replicas=1, max_replicas=1,
    overload=True, latency_deadline_s=3.0, throughput_deadline_s=5.0,
    admission_safety=1.2, brownout_enter_depth=10, brownout_exit_depth=2,
    brownout_enter_ticks=2, brownout_exit_ticks=2, brownout_clamp_tokens=4)
LEVER_OVERLOAD_MIX = [("latency", 0.5), ("throughput", 0.3),
                      ("batch", 0.2)]
# A class-mixed load past one replica's speculative rate: the queue
# crosses the ladder's entry depth with a margin (spec_off enters; the
# slower plain rounds then take the ladder further) and drains before
# the trace ends (every rung exits).
LEVER_OVERLOAD_TRACE = dict(n=40, seed=3, rate_rps=50.0)
SERVE_TP_CONFIG = "n2_serve_tp"
SERVE_TP_SPEC = "tp=2"
SERVE_TP_TIMEOUT = 600
LEVERS_TP_IN = "chip_smoke_serve_tp_in.json"


def lever_trace(n: int, seed: int = 14, shared: bool = False, **kw):
    """The phase's seeded Poisson trace at phase 5's rate and lengths;
    ``shared`` puts the 128-token system prompt before every prompt."""
    from horovod_tpu_torch.serve.traffic import poisson_trace

    if shared:
        kw.update(shared_prefix_len=LEVER_SHARED_PREFIX,
                  prompt_lens=LEVER_TAILS)
    else:
        kw.setdefault("prompt_lens", (64, 128, 256))
    kw.setdefault("rate_rps", 20.0)
    return poisson_trace(seed=seed, n_requests=n, output_lens=(16, 32),
                         vocab_size=50257, **kw)


def param_digest(model) -> float:
    """A float64 sum over every parameter: equal weights give equal
    bits (the same values summed in the same order)."""
    return float(sum(p.detach().double().sum() for p in
                     model.parameters()).item())


def near_ties(torch, m32, trace, on: dict, off: dict, what: str) -> list:
    """The identity rule: streams ``on`` and ``off`` (rid -> tokens)
    are identical or first differ at a near-tie of the lever-off stream
    (its top-2 logit gap, recomputed by one full fp32 forward over the
    prompt and that stream, at most NEAR_TIE_RTOL x max |logit|). Returns
    the near-ties; any other difference fails."""
    ties = []
    prompts = {r.rid: list(r.prompt)[-LEVER_GEOMETRY["max_prompt_len"]:]
               for r in trace.requests}
    check(set(on) == set(off) == set(prompts),
          f"{what}: the runs completed different requests")
    for rid in sorted(off):
        a, b = list(on[rid]), list(off[rid])
        if a == b:
            continue
        check(len(a) == len(b), f"{what}: rid {rid} {len(a)} vs {len(b)} "
                                "tokens")
        i = next(j for j in range(len(b)) if a[j] != b[j])
        ties.append(dict(tie_gap(torch, m32, prompts[rid] + b[:i]),
                         rid=rid, position=i, on=a[i], off=b[i]))
        t = ties[-1]
        check(t["rel_gap"] <= NEAR_TIE_RTOL,
              f"{what}: rid {rid} parts at token {i} ({a[i]} vs {b[i]}) "
              f"where the top-2 gap is {t['gap']:.3g} = {t['rel_gap']:.3g}"
              f" of max|logit| > {NEAR_TIE_RTOL}: not a near-tie")
    return ties


def tie_gap(torch, m32, tokens) -> dict:
    """The next-token top-2 logit gap after ``tokens`` (one full fp32
    forward), absolute and of max |logit|."""
    with torch.no_grad():
        row = m32(torch.tensor([tokens], device="cuda"))[0, -1]
    top = torch.topk(row, 2)
    gap = float(top.values[0] - top.values[1])
    return {"gap": gap, "rel_gap": gap / float(row.abs().max()),
            "top": [int(i) for i in top.indices]}


def spec_rejections(tracer, c, k: int) -> list:
    """Each speculative round that rejected a draft token, from the
    tracer's ``spec`` spans: (rid, index in the stream of the target's
    correction token, tokens accepted). Needs a run without fallback
    rounds (those leave no span), which the stream lengths confirm."""
    out = []
    for r in c.completed:
        n = 1                             # the prefill's token
        for span in tracer.trace(r.rid):
            if span["phase"] != "spec":
                continue
            m, _ = (int(x) for x in span["detail"].split("/"))
            if m < k - 1:
                out.append((r.rid, n + m, m))
            n = min(n + m + 1, len(r.tokens))
        check(n == len(r.tokens),
              f"spec: rid {r.rid}'s rounds commit {n} of "
              f"{len(r.tokens)} tokens")
    return out


def _lever_cluster(factory, roles=None, policy=None):
    from horovod_tpu_torch.serve import tracing
    from horovod_tpu_torch.serve.controller import ServeCluster, SLOPolicy

    tracing.reset()
    if policy is None:
        policy = SLOPolicy() if roles else SLOPolicy(min_replicas=1,
                                                     max_replicas=1)
    return ServeCluster(factory, policy=policy, replicas=1, roles=roles,
                        step_s=0.05, log_path="")


def _lever_run(torch, K, c, trace, hook=None):
    """Run ``c`` over ``trace`` with the launch counts zeroed just
    before and read just after; returns the report, the round stamps,
    the launches and the coded leaves."""
    round_t = []

    def stamp(cluster, idx):
        round_t.append(time.perf_counter())
        if hook is not None:
            hook(cluster, idx)

    torch.cuda.synchronize()
    K.reset_launch_counts()
    rep = c.run(trace, round_hook=stamp)
    torch.cuda.synchronize()
    round_t.append(time.perf_counter())
    check(rep["dropped"] == 0, f"dropped {rep['dropped']}")
    return rep, round_t, dict(K.LAUNCHES), dict(K.CODEC_LEAVES)


def _tokens(c) -> dict:
    return {r.rid: list(r.tokens) for r in c.completed}


def _timed(c, rep, round_t) -> dict:
    ttft, tpot, wall_s = wall_view(c, round_t)
    return {"requests": rep["submitted"], "completed": rep["completed"],
            "rounds": rep["rounds"], "handoffs": rep.get("handoffs", 0),
            "prefill_tokens": rep["prefill_tokens"],
            "generated_tokens": rep["generated_tokens"], "wall_s": wall_s,
            "tokens_per_wall_s": rep["generated_tokens"] / wall_s,
            "wall_ms_per_round": wall_s * 1e3 / rep["rounds"],
            "ttft_wall_p50_s": statistics.median(ttft),
            "tpot_wall_p50_s": statistics.median(tpot) if tpot else None}


def _check_codec(launches, leaves, handoffs: int, what: str) -> None:
    for name in ("quantize_int8", "dequantize_int8"):
        check(launches[name] == handoffs and handoffs >= 1,
              f"{what}: {name} launched {launches[name]} times for "
              f"{handoffs} handoffs (one grouped launch a handoff side)")
        check(leaves[name] == HANDOFF_LEAVES * handoffs,
              f"{what}: {name} coded {leaves[name]} leaves != "
              f"{HANDOFF_LEAVES} x {handoffs} handoffs")


def levers_prefix(torch, K, model, m32) -> dict:
    """(a): the fp32 identity pair (colocated), then the bf16
    disaggregated pair, timed."""
    from horovod_tpu_torch.serve.engine import make_engine_factory
    from horovod_tpu_torch.serve.prefix import PrefixCache

    out = {}
    for label, m, n, roles in (
            ("fp32", m32, LEVER_IDENTITY_REQUESTS, None),
            ("bf16_disagg", model, LEVER_TIMED_REQUESTS,
             {"prefill": 1, "decode": 1})):
        trace = lever_trace(n, shared=True)
        runs = {}
        for arm in ("cached", "uncached"):
            pc = PrefixCache() if arm == "cached" else None
            c = _lever_cluster(make_engine_factory(
                m, device="cuda", prefix_cache=pc, **LEVER_GEOMETRY), roles)
            rep, round_t, launches, leaves = _lever_run(
                torch, K, c, lever_trace(n, shared=True))
            check(rep["completed"] == rep["submitted"] == n,
                  f"prefix {label} {arm}: completed {rep['completed']}")
            runs[arm] = dict(_timed(c, rep, round_t), tokens=_tokens(c),
                             launches=launches, codec_leaves=leaves,
                             prefix=pc.stats() if pc else None)
        st = runs["cached"]["prefix"]
        saved = runs["uncached"]["prefill_tokens"] \
            - runs["cached"]["prefill_tokens"]
        check(st["hits"] >= 1, f"prefix {label}: no fork ({st})")
        check(saved == st["tokens_saved"],
              f"prefix {label}: prefill dropped by {saved} tokens, the "
              f"cache saved {st['tokens_saved']}")
        rec = {"requests": n, "stats": st, "prefill_tokens_saved": saved,
               "runs": runs}
        if label == "fp32":
            rec["near_ties"] = near_ties(
                torch, m32, trace, runs["cached"]["tokens"],
                runs["uncached"]["tokens"], f"prefix {label}")
        else:
            for arm in ("cached", "uncached"):
                r = runs[arm]
                _check_codec(r["launches"], r["codec_leaves"],
                             r["handoffs"], f"prefix {label} {arm}")
        out[label] = rec
    return out


def levers_spec(torch, K, model, m32, draft) -> dict:
    """(b): the fp32 self-draft pair at k = 4 on colocated clusters, then
    plain, self-draft and GPT-2 small draft runs in bf16, timed."""
    from horovod_tpu_torch.serve import tracing
    from horovod_tpu_torch.serve.engine import make_engine_factory

    k = LEVER_SPEC_K
    out = {}
    trace = lever_trace(LEVER_IDENTITY_REQUESTS, seed=15)
    runs = {}
    for arm in ("spec", "plain"):
        kw = dict(draft_model=m32, spec_k=k) if arm == "spec" else {}
        c = _lever_cluster(make_engine_factory(m32, device="cuda", **kw,
                                               **LEVER_GEOMETRY))
        rep, round_t, _, _ = _lever_run(
            torch, K, c, lever_trace(LEVER_IDENTITY_REQUESTS, seed=15))
        runs[arm] = dict(_timed(c, rep, round_t), tokens=_tokens(c),
                         proposed=rep["spec_proposed"],
                         accepted=rep["spec_accepted"])
        if arm == "spec":
            eng = next(iter(c.batchers.values())).engine
            check(eng.spec_fallback_rounds == 0 and eng.spec_rounds > 0,
                  f"spec fp32: {eng.spec_rounds} speculative and "
                  f"{eng.spec_fallback_rounds} fallback rounds")
            rejected = spec_rejections(tracing.tracer(), c, k)
            streams = _tokens(c)
            prompts = {r.rid: list(r.prompt) for r in trace.requests}
            rej = []
            for rid, i, m in rejected:
                if i > len(streams[rid]):
                    # Past the stream's end: its context was never
                    # committed, so there is no gap to recompute.
                    rej.append({"rid": rid, "position": i, "accepted": m,
                                "gap": None})
                    continue
                t = dict(tie_gap(torch, m32, prompts[rid]
                                 + streams[rid][:i]), rid=rid, position=i,
                         accepted=m)
                check(t["rel_gap"] <= NEAR_TIE_RTOL,
                      f"spec fp32: self-draft rejected a token at rid "
                      f"{rid} position {i}, top-2 gap {t['rel_gap']:.3g} "
                      f"of max|logit| > {NEAR_TIE_RTOL}: not a near-tie")
                rej.append(t)
            runs[arm]["rejections"] = rej
    spec = runs["spec"]
    ceiling = spec["proposed"] * (k - 1) // k
    check(spec["proposed"] % k == 0 and spec["accepted"] <= ceiling,
          f"spec fp32: accepted {spec['accepted']} of {spec['proposed']}")
    short = sum(k - 1 - r["accepted"] for r in spec["rejections"])
    check(ceiling - spec["accepted"] == short,
          f"spec fp32: {ceiling - spec['accepted']} tokens short of the "
          f"ceiling, the rejections found account for {short}")
    out["fp32_self"] = {
        "k": k, "requests": LEVER_IDENTITY_REQUESTS, "runs": runs,
        "acceptance": spec["accepted"] / spec["proposed"],
        "ceiling": (k - 1) / k,
        "near_ties": near_ties(torch, m32, trace, spec["tokens"],
                               runs["plain"]["tokens"], "spec fp32")}
    timed = {}
    for arm, dm in (("plain", None), ("self", model), ("gpt2_small", draft)):
        kw = dict(draft_model=dm, spec_k=k) if dm is not None else {}
        c = _lever_cluster(make_engine_factory(model, device="cuda", **kw,
                                               **LEVER_GEOMETRY))
        rep, round_t, _, _ = _lever_run(
            torch, K, c, lever_trace(LEVER_TIMED_REQUESTS, seed=15))
        check(rep["completed"] == rep["submitted"] == LEVER_TIMED_REQUESTS,
              f"spec bf16 {arm}: completed {rep['completed']}")
        eng = next(iter(c.batchers.values())).engine
        timed[arm] = dict(_timed(c, rep, round_t),
                          acceptance=rep["spec_acceptance_rate"],
                          spec_rounds=getattr(eng, "spec_rounds", 0),
                          fallback_rounds=getattr(
                              eng, "spec_fallback_rounds", 0))
    out["bf16"] = timed
    return out


def levers_overload(torch, K, model) -> dict:
    """(c): the overload controls on bf16 self-draft engines over a
    class-mixed trace that reaches the spec_off rung."""
    from horovod_tpu_torch.serve.controller import SLOPolicy
    from horovod_tpu_torch.serve.engine import make_engine_factory

    pol = LEVER_OVERLOAD_POLICY
    trace_kw = dict(class_mix=LEVER_OVERLOAD_MIX, class_deadlines={
        "latency": pol["latency_deadline_s"],
        "throughput": pol["throughput_deadline_s"]}, **LEVER_OVERLOAD_TRACE)
    samples = []

    def hook(c, _idx):
        engines = [b.engine for b in c.batchers.values()]
        samples.append((c.controller.brownout.active("spec_off"),
                        sum(e.spec_rounds for e in engines),
                        sum(e.spec_fallback_rounds for e in engines)))

    c = _lever_cluster(make_engine_factory(
        model, device="cuda", draft_model=model, spec_k=LEVER_SPEC_K,
        **LEVER_GEOMETRY), policy=SLOPolicy(**pol))
    rep, round_t, _, _ = _lever_run(torch, K, c, lever_trace(**trace_kw),
                                    hook)
    n = trace_kw["n"]
    check(rep["submitted"] == n and rep["completed"] + rep["shed"]
          + rep["rejected"] == n,
          f"overload: {rep['completed']} completed + {rep['shed']} shed + "
          f"{rep['rejected']} rejected != {n}")
    ends = {r.rid for r in c.completed + c.shed + c.rejected}
    check(len(ends) == n, f"overload: {len(ends)} requests ended of {n}")
    rungs = [json.loads(d)["reason"] for d in rep["decisions"]
             if json.loads(d)["action"] == "brownout"]
    check(any(r.startswith("spec_off:enter") for r in rungs)
          and any(r.startswith("spec_off:exit") for r in rungs),
          f"overload: spec_off did not enter and exit: {rungs}")
    # Round i ran with the flag the tick of round i set: sample i + 1's.
    during = [(samples[i + 1][1] - samples[i][1],
               samples[i + 1][2] - samples[i][2])
              for i in range(len(samples) - 1) if samples[i + 1][0]]
    held = [i for i, smp in enumerate(samples) if smp[0]]
    after = samples[held[-1] + 1:] if held else []
    check(bool(during) and all(d[0] == 0 for d in during)
          and sum(d[1] for d in during) > 0,
          "overload: speculative rounds ran while spec_off held, or no "
          "fallback round did")
    return dict(_timed(c, rep, round_t), rungs=rungs,
                shed=rep["shed"], rejected=rep["rejected"],
                rounds_held=len(during),
                fallback_rounds_held=sum(d[1] for d in during),
                spec_rounds_after=(after[-1][1] - after[0][1]
                                   if after else 0),
                acceptance=rep["spec_acceptance_rate"])


def serve_tp_worker(config: str, rank: int, out_path: str,
                    dev: str = "cuda") -> None:
    """One rank of phase 14 (d) (``--rank-worker n2_serve_tp``): the fp32
    tp engine over the parent's requests, then a bf16 disaggregated tp
    cluster; both ranks run the same requests in the same order."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.serve.controller import ServeCluster, SLOPolicy
    from horovod_tpu_torch.serve.engine import (DecodeEngine,
                                                make_engine_factory)
    from horovod_tpu_torch.serve.queue import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = hvd.init(backend="gloo", parallel=SERVE_TP_SPEC) if dev == "cuda" \
        else hvd.init(device="cpu", parallel=SERVE_TP_SPEC)
    with open(os.path.join(os.path.dirname(out_path), LEVERS_TP_IN)) as f:
        inp = json.load(f)
    with torch.device(dev):
        m32 = gpt_mod.GPT(**inp["widths"], dtype=torch.float32,
                          tp_axis="tp")
    m32.init_weights(torch.Generator(device=dev).manual_seed(inp["seed"]))
    check(param_digest(m32) == inp["digest"],
          f"serve tp rank {rank}: the weights differ from the parent's")
    geo = dict(inp["geometry"])
    eng = DecodeEngine(m32, device=dev, parallel=SERVE_TP_SPEC, **geo)
    reqs = [Request(**r) for r in inp["requests"]]
    for r in reqs:
        eng.admit(r)
    t0 = time.perf_counter()
    while eng.active_count():
        eng.step(0.0)
    _sync(torch, dev)
    fp32 = {"tokens": {str(r.rid): list(r.tokens) for r in reqs},
            "cache_shape": list(eng.cache["layers"][0]["k"].shape),
            "rounds": eng.decode_steps,
            "wall_ms_per_round": (time.perf_counter() - t0) * 1e3
            / max(1, eng.decode_steps)}
    del eng
    with torch.device(dev):
        m16 = gpt_mod.GPT(**inp["widths"], tp_axis="tp")
    m16.load_state_dict(m32.state_dict())
    del m32
    coded = []
    group = K.quantize_int8_group

    def counting(xs):
        xs = list(xs)
        coded.extend(x.numel() for x in xs)
        return group(xs)

    K.quantize_int8_group = counting
    try:
        factory = make_engine_factory(m16, device=dev,
                                      parallel=SERVE_TP_SPEC, **geo)
        c = ServeCluster(factory, policy=SLOPolicy(),
                         roles={"prefill": 1, "decode": 1}, step_s=0.05,
                         log_path="")
        round_t = []
        trace = lever_trace(inp["cluster_requests"], seed=16)
        _sync(torch, dev)
        K.reset_launch_counts()
        rep = c.run(trace, round_hook=lambda *_: round_t.append(
            time.perf_counter()))
        _sync(torch, dev)
        round_t.append(time.perf_counter())
        launches, leaves = dict(K.LAUNCHES), dict(K.CODEC_LEAVES)
    finally:
        K.quantize_int8_group = group
    shapes = {list(b.engine.cache["layers"][0]["k"].shape)[2]
              for b in c.batchers.values()}
    wall = round_t[-1] - round_t[0]
    out = {"config": config, "rank": rank, "backend": ctx.backend,
           "fp32": fp32, "tokens": {str(r.rid): list(r.tokens)
                                    for r in c.completed},
           "events": rep["events"], "decisions": rep["decisions"],
           "report": {k: rep[k] for k in (
               "submitted", "completed", "dropped", "handoffs",
               "pending_handoffs", "rounds", "generated_tokens")},
           "launches": launches, "codec_leaves": leaves,
           "coded_elements": sorted(set(coded)), "n_coded": len(coded),
           "heads_a_rank": sorted(shapes), "wall_s": wall,
           "wall_ms_per_round": wall * 1e3 / rep["rounds"],
           "tokens_per_wall_s": rep["generated_tokens"] / wall,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if dev == "cuda" else 0.0)}
    print(f"rank {rank} serve tp: fp32 engine {fp32['rounds']} rounds, "
          f"{fp32['wall_ms_per_round']:.1f} ms a round; bf16 cluster "
          f"{rep['handoffs']} handoffs, {out['wall_ms_per_round']:.1f} ms "
          f"a round, launches {launches}", flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f)
    hvd.shutdown()


def levers_tp(torch, m32, out_dir: str) -> dict:
    """(d): the unsharded fp32 engine's stream here, then the two tp rank
    workers on the card."""
    from horovod_tpu_torch.serve.engine import DecodeEngine
    from horovod_tpu_torch.serve.queue import Request

    trace = lever_trace(LEVER_IDENTITY_REQUESTS, seed=17)
    reqs = [{k: getattr(r, k) for k in ("rid", "prompt", "max_new_tokens")}
            for r in trace.requests]
    eng = DecodeEngine(m32, device="cuda", **LEVER_GEOMETRY)
    done = [Request(**r) for r in reqs]
    for r in done:
        eng.admit(r)
    while eng.active_count():
        eng.step(0.0)
    plain = {str(r.rid): list(r.tokens) for r in done}
    del eng
    widths = {k: getattr(m32, k) for k in ("vocab_size", "num_layers",
                                           "hidden", "num_heads",
                                           "mlp_dim")}
    with open(os.path.join(out_dir, LEVERS_TP_IN), "w") as f:
        json.dump({"widths": widths, "seed": 0, "digest":
                   param_digest(m32), "geometry": LEVER_GEOMETRY,
                   "requests": [dict(r, prompt=list(r["prompt"]))
                                for r in reqs],
                   "cluster_requests": LEVER_IDENTITY_REQUESTS}, f)
    parent = _free_parent(torch)
    ranks, wall = run_workers(SERVE_TP_CONFIG, 2, SERVE_TP_TIMEOUT, out_dir)
    a, b = ranks
    for key in ("tokens", "events", "decisions", "report", "launches",
                "codec_leaves"):
        check(a[key] == b[key], f"serve tp: ranks differ in {key}")
    check(a["fp32"]["tokens"] == b["fp32"]["tokens"],
          "serve tp: the ranks' fp32 streams differ")
    rep = a["report"]
    n = LEVER_IDENTITY_REQUESTS
    check(rep["dropped"] == 0 and rep["completed"] == rep["submitted"] == n
          and rep["pending_handoffs"] == 0,
          f"serve tp: {rep}")
    half = LEVER_GEOMETRY["max_len"] * (m32.hidden // 2)
    for r in ranks:
        check(r["fp32"]["cache_shape"][2] == m32.num_heads // 2
              and r["heads_a_rank"] == [m32.num_heads // 2],
              f"serve tp rank {r['rank']}: heads a rank "
              f"{r['heads_a_rank']}")
        _check_codec(r["launches"], r["codec_leaves"],
                     r["report"]["handoffs"], f"serve tp rank {r['rank']}")
        check(r["coded_elements"] == [half]
              and r["n_coded"] == HANDOFF_LEAVES * rep["handoffs"],
              f"serve tp rank {r['rank']}: coded {r['n_coded']} leaves of "
              f"{r['coded_elements']} elements, expected "
              f"{HANDOFF_LEAVES} x {rep['handoffs']} of {half}")
    ties = near_ties(torch, m32, trace,
                     {int(k): v for k, v in a["fp32"]["tokens"].items()},
                     {int(k): v for k, v in plain.items()}, "serve tp fp32")
    return {"label": "gloo, 2 processes on one card (not NCCL or NVLink)",
            "spec": SERVE_TP_SPEC, "parent_gib": parent, "wall_s": wall,
            "near_ties": ties, "fp32_rounds": a["fp32"]["rounds"],
            "fp32_wall_ms_per_round": a["fp32"]["wall_ms_per_round"],
            "handoffs": rep["handoffs"], "rounds": rep["rounds"],
            "wall_ms_per_round": a["wall_ms_per_round"],
            "tokens_per_wall_s": a["tokens_per_wall_s"],
            "launches": a["launches"], "codec_leaves": a["codec_leaves"],
            "elements_a_leaf": half,
            "peak_mem_gib": max(r["peak_mem_gib"] for r in ranks)}


def phase_serve_levers(torch, K, out_dir: str, model) -> dict:
    """Phase 14 on phase 5's GPT-2 medium ``model`` (bf16 compute): its
    fp32 twin (the same weights) for the identity pairs, a seeded GPT-2
    small draft, then arms (a)-(d). Returns the phase's record with
    ``launches``: K2/K4 on the cached disaggregated prefix run and on tp
    rank 0's cluster."""
    from horovod_tpu_torch.models import gpt as gpt_mod

    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "serve levers: TF32 must be off for the fp32 identity pairs")
    with torch.device("cuda"):
        m32 = gpt_mod.gpt_medium(dtype=torch.float32)
        draft = gpt_mod.gpt_small()
    m32.load_state_dict(model.state_dict())
    m32.eval()
    draft.init_weights(torch.Generator(device="cuda").manual_seed(1))
    check(draft.vocab_size == model.vocab_size and draft.num_layers == 12
          and draft.hidden == 768 and draft.num_heads == 12,
          "gpt_small geometry")
    res = {"model": "gpt_medium", "draft": "gpt_small",
           "geometry": LEVER_GEOMETRY}
    marks = {}
    res["prefix"] = levers_prefix(torch, K, model, m32)
    marks["prefix"] = time.perf_counter() - t0
    res["spec"] = levers_spec(torch, K, model, m32, draft)
    marks["spec"] = time.perf_counter() - t0 - sum(marks.values())
    res["overload"] = levers_overload(torch, K, model)
    marks["overload"] = time.perf_counter() - t0 - sum(marks.values())
    del draft
    res["tp"] = levers_tp(torch, m32, out_dir)
    marks["tp"] = time.perf_counter() - t0 - sum(marks.values())
    del m32
    torch.cuda.empty_cache()
    res["arm_s"] = marks
    res["phase_s"] = time.perf_counter() - t0
    cached = res["prefix"]["bf16_disagg"]["runs"]["cached"]
    res["launches"] = {"serve_prefix": cached["launches"],
                       "serve_tp": res["tp"]["launches"]}
    with open(os.path.join(out_dir, "chip_smoke_serve_levers.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    p, sp, ov, tp = res["prefix"], res["spec"], res["overload"], res["tp"]
    pb = p["bf16_disagg"]["runs"]
    print(f"serve levers (a) prefix: fp32 pair near-ties "
          f"{p['fp32']['near_ties']}; bf16 disaggregated "
          f"{LEVER_TIMED_REQUESTS} requests: "
          f"{p['bf16_disagg']['stats']['hits']} forks saved "
          f"{p['bf16_disagg']['prefill_tokens_saved']} prefill tokens; "
          f"cached {pb['cached']['tokens_per_wall_s']:.1f} tok/s, TTFT p50 "
          f"{pb['cached']['ttft_wall_p50_s'] * 1e3:.1f} ms vs uncached "
          f"{pb['uncached']['tokens_per_wall_s']:.1f} tok/s, "
          f"{pb['uncached']['ttft_wall_p50_s'] * 1e3:.1f} ms; K2/K4 "
          f"{cached['launches']['quantize_int8']}/"
          f"{cached['launches']['dequantize_int8']} for "
          f"{cached['handoffs']} handoffs", flush=True)
    sb = sp["bf16"]
    print(f"serve levers (b) spec k={LEVER_SPEC_K}: fp32 self-draft "
          f"acceptance {sp['fp32_self']['acceptance']:.4f} (ceiling "
          f"{sp['fp32_self']['ceiling']:.4f}; rejections "
          f"{sp['fp32_self']['runs']['spec']['rejections']}), near-ties "
          f"{sp['fp32_self']['near_ties']}; bf16 {LEVER_TIMED_REQUESTS} "
          "requests: " + "; ".join(
              f"{arm} {r['rounds']} rounds, acceptance "
              f"{r['acceptance']:.4f}, {r['tokens_per_wall_s']:.1f} tok/s, "
              f"TPOT p50 {(r['tpot_wall_p50_s'] or 0) * 1e3:.1f} ms"
              for arm, r in sb.items()), flush=True)
    print(f"serve levers (c) overload: rungs {ov['rungs']}; spec_off held "
          f"{ov['rounds_held']} rounds ({ov['fallback_rounds_held']} "
          f"fallback rounds), {ov['spec_rounds_after']} speculative rounds "
          f"after; {ov['completed']} completed, {ov['shed']} shed, "
          f"{ov['rejected']} rejected", flush=True)
    print(f"serve levers (d) tp ({tp['label']}): fp32 near-ties "
          f"{tp['near_ties']}; bf16 disaggregated {tp['handoffs']} "
          f"handoffs, {tp['wall_ms_per_round']:.1f} ms a round, "
          f"{tp['tokens_per_wall_s']:.1f} tok/s; K2/K4 "
          f"{tp['launches']['quantize_int8']}/"
          f"{tp['launches']['dequantize_int8']} a rank of "
          f"{tp['elements_a_leaf']} elements a leaf; phase "
          f"{res['phase_s']:.1f} s ({json.dumps(marks)})", flush=True)
    return res


TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# Flash vs plain attention, one forward and backward, by compute dtype:
# (loss relative error, per-parameter relative Frobenius gradient error).
REF_RTOL = {"bfloat16": (1e-3, 2e-2), "float32": (1e-5, 1e-3)}


def reference_step(torch, model, loss_fn, plain_attend) -> dict:
    """One forward and backward of ``loss_fn()`` on the same weights and
    batch, with the flash kernels (``model.attend_fn = None``) and with
    ``plain_attend``; returns the loss gap and the worst per-parameter
    relative Frobenius gradient error."""
    out = {}
    for label, attend in (("flash", None), ("plain", plain_attend)):
        model.attend_fn = attend
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        out[label] = (loss.item(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()})
    model.attend_fn = None
    model.zero_grad(set_to_none=True)
    (lf, gf), (lp, gp) = out["flash"], out["plain"]
    check(math.isfinite(lf) and math.isfinite(lp),
          f"reference: non-finite loss {lf} / {lp}")
    loss_rel = abs(lf - lp) / abs(lp)
    worst_name, worst = "", 0.0
    for name, g in gp.items():
        rel = ((gf[name] - g).norm() / g.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst_name, worst = name, rel
    del out, gf, gp
    torch.cuda.empty_cache()
    return {"loss_flash": lf, "loss_plain": lp, "loss_rel_err": loss_rel,
            "grad_rel_err_max": worst, "grad_rel_err_param": worst_name}


def check_reference(r: dict, dname: str, what: str) -> None:
    loss_tol, grad_tol = REF_RTOL[dname]
    print(f"reference ({what}, {dname}): flash vs plain attention loss rel "
          f"err {r['loss_rel_err']:.3g} (limit {loss_tol}); worst grad "
          f"rel err {r['grad_rel_err_max']:.3g} on "
          f"{r['grad_rel_err_param']} (limit {grad_tol})", flush=True)
    check(r["loss_rel_err"] <= loss_tol,
          f"reference ({what}, {dname}): loss rel err {r['loss_rel_err']} "
          f"> {loss_tol}")
    check(r["grad_rel_err_max"] <= grad_tol,
          f"reference ({what}, {dname}): {r['grad_rel_err_param']} "
          f"gradient rel err {r['grad_rel_err_max']} > {grad_tol}")


def profile_steps(torch, step, n: int, out_path: str) -> dict:
    """Trace ``n`` training steps with torch.profiler: the device busy
    share of the wall time and the top device ops, written to
    ``out_path``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    with open(out_path, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    return {"profiled_steps": n, "profiled_wall_s": wall,
            "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall,
            "top_device_ops_ms_per_step": {
                e.key[:80]: e.self_device_time_total / 1e3 / n
                for e in top},
            "flash_kernels_ms_per_step": {
                e.key[:80]: e.self_device_time_total / 1e3 / n
                for e in dev if "flash_" in e.key}}


def phase_train(torch, K, out_dir: str, profile: bool = False) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    ctx = hvd.init()
    check(hvd.size() == 1 and ctx.backend == "nccl",
          f"init: world {hvd.size()} over {ctx.backend}")
    with torch.device("cuda"):
        model = gpt_mod.gpt_medium()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    check(model.num_layers == 24 and model.hidden == 1024
          and model.num_heads == 16 and model.mlp_dim == 4096
          and model.vocab_size == 50257, "gpt_medium geometry")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.randint(0, model.vocab_size,
                           (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=torch.Generator().manual_seed(11)
                           ).to("cuda")
    # The same check on an fp32 copy of the weights separates the
    # kernels' own error from bf16 rounding downstream of attention.
    with torch.device("cuda"):
        fp32_model = gpt_mod.gpt_medium(dtype=torch.float32)
    fp32_model.load_state_dict(model.state_dict())
    def plain_attend(q, k, v, mask=None):
        return fa.reference_attention(q, k, v, mask, causal=True)

    ref = {}
    for dname, m in (("bfloat16", model), ("float32", fp32_model)):
        ref[dname] = reference_step(
            torch, m, lambda: gpt_mod.next_token_loss(m(tokens[:, :-1]),
                                                      tokens[:, 1:]),
            plain_attend)
        check_reference(ref[dname], dname, "gpt_medium")
    del fp32_model, m
    torch.cuda.empty_cache()

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    buckets = len(opt._dist_plan.buckets)

    def step():
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    losses = [step().item() for _ in range(TRAIN_WARMUP)]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    issued0 = opt.bucket_allreduces
    K.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        s0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
        losses.append(loss.item())
    launches = dict(K.LAUNCHES)
    issued = opt.bucket_allreduces - issued0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    check(all(map(math.isfinite, losses)),
          f"train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    per_step = model.num_layers * TRAIN_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == per_step,
              f"train: {name} launched {launches[name]} times, expected "
              f"{model.num_layers} x {TRAIN_STEPS} = {per_step}")
    check(issued >= TRAIN_STEPS and issued == buckets * TRAIN_STEPS,
          f"train: {issued} bucket allreduces in {TRAIN_STEPS} steps "
          f"({buckets} buckets)")
    step_s = statistics.median(times)
    result = {
        "model": "gpt_medium", "layers": 24, "hidden": 1024, "heads": 16,
        "mlp": 4096, "vocab": 50257, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "world_size": 1,
        "backend": ctx.backend, "optimizer": "AdamW(lr=1e-4, wd=1e-4)",
        "fusion_buckets": buckets, "bucket_allreduces": issued,
        "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
        "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
        "peak_mem_gib": peak, "losses": losses,
        "launches": launches, "reference": ref, "setup_s": setup_s,
    }
    if profile:
        result["profile"] = profile_steps(
            torch, step, 2, os.path.join(out_dir,
                                         "chip_smoke_train_profile.txt"))
        print(f"profile (train): {json.dumps(result['profile'])}",
              flush=True)
    with open(os.path.join(out_dir, "chip_smoke_train.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"train: gpt_medium B={TRAIN_BATCH} S={TRAIN_SEQ}, step "
          f"{step_s * 1e3:.1f} ms (median of {TRAIN_STEPS}) = "
          f"{result['tokens_per_s']:.0f} tok/s; peak {peak:.2f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {issued} bucket "
          f"allreduces; launches {launches}", flush=True)
    del opt, model
    hvd.shutdown()
    torch.cuda.empty_cache()
    return result


# -- integrity: the guard, accumulation with remat, the infeed, checkpoints --

INTEG_MICRO, INTEG_ACCUM = 8, 4     # microbatch rows, microbatches a step
INTEG_WARMUP, INTEG_STEPS = 2, 5
INTEG_POISON_STEP = 3               # the effective step the guard drill hits
LOSS_SCALE0 = 2.0 ** 15             # ScaleConfig's initial loss scale
CKPT_LAYERS = 4                     # GPT-2 medium widths, cut in depth
CKPT_SAVES, CKPT_STEPS = (2, 4), 6
INTEG_CONFIGS = (("none", "scale_backoff"), ("none", None),
                 ("full", "scale_backoff"), ("full", None))


def _sync(torch, dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def integrity_model(torch, gpt_mod, dev: str, layers: int = 24,
                    seed: int = 0, **kw):
    """GPT-2 medium's widths (``layers`` deep) with seeded weights on
    ``dev``."""
    with torch.device(dev):
        model = gpt_mod.GPT(num_layers=layers, hidden=1024, num_heads=16,
                            mlp_dim=4096, vocab_size=50257, **kw)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))


def integrity_batches(torch, vocab: int, n: int, rows: int, seed: int,
                      dev: str) -> list:
    """``n`` host batches of ``rows`` x (S + 1) tokens, pinned for the
    copy stream on the card."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        t = torch.randint(0, vocab, (rows, TRAIN_SEQ + 1), generator=gen)
        out.append(t.pin_memory() if dev == "cuda" else t)
    return out


def poison_first_grad(torch, model, value: float):
    """A tensor hook putting ``value`` into the first element of the first
    parameter's gradient (the lane the JAX package's ``chaos_poison``
    picks). Returns the hook's handle."""
    first = next(model.parameters())

    def hook(g):
        g = g.clone()
        g.view(-1)[0] = value
        return g
    return first.register_hook(hook)


def grads_of(torch, model, run) -> tuple:
    model.zero_grad(set_to_none=True)
    loss = float(run())
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


def compare_grads(torch, a: tuple, b: tuple, what: str) -> dict:
    """Loss relative error and the worst per-parameter relative Frobenius
    gradient error of ``a`` against ``b`` (the train phase's bf16
    limits), and whether the two are bitwise equal."""
    (la, ga), (lb, gb) = a, b
    loss_tol, grad_tol = REF_RTOL["bfloat16"]
    worst_name, worst = "", 0.0
    bitwise = la == lb
    for name, g in gb.items():
        bitwise = bitwise and torch.equal(ga[name], g)
        rel = ((ga[name] - g).norm() / g.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst_name, worst = name, rel
    loss_rel = abs(la - lb) / abs(lb)
    check(math.isfinite(la) and loss_rel <= loss_tol,
          f"{what}: loss {la} vs {lb}, rel err {loss_rel} > {loss_tol}")
    check(worst <= grad_tol, f"{what}: {worst_name} gradient rel err "
                             f"{worst} > {grad_tol}")
    return {"loss_a": la, "loss_b": lb, "loss_rel_err": loss_rel,
            "grad_rel_err_max": worst, "grad_rel_err_param": worst_name,
            "bitwise_equal": bool(bitwise)}


def state_snapshot(model, opt) -> list:
    """Every weight and every optimizer state tensor, cloned."""
    out = [p.detach().clone() for p in model.parameters()]
    for st in opt.state.values():
        out += [v.clone() for v in st.values() if hasattr(v, "clone")]
    return out


def release(torch, opt, dev: str) -> None:
    """Drop a DistributedOptimizer's backward hooks (they hold it and its
    model alive) and give the freed memory back, so that the next run's
    peak is its own."""
    import gc

    for h in opt._dist_hooks:
        h.remove()
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def integrity_run(torch, K, hvd, gpt_mod, cb, remat: str, policy,
                  dev: str, layers: int, drill: bool, out_dir: str,
                  profile: bool = False) -> dict:
    """GPT-2 medium trained through ``DistributedOptimizer(accum_steps=4,
    remat_policy=remat, nonfinite_policy=policy)`` on 32 x 512 tokens a
    step fed by ``DeviceInfeed(depth=2)``, with the broadcast and warmup
    callbacks: ``INTEG_WARMUP`` steps, with ``drill`` the guard drill
    (a +Inf gradient lane at effective step ``INTEG_POISON_STEP``, then a
    step that applies), then ``INTEG_STEPS`` timed steps with the launch
    counters zeroed just before them; with ``profile`` two more steps
    under torch.profiler."""
    model = integrity_model(torch, gpt_mod, dev, layers)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        accum_steps=INTEG_ACCUM, remat_policy=remat,
        nonfinite_policy=policy)
    buckets = len(opt._dist_plan.buckets)
    drill_steps = 2 if drill else 0
    total = INTEG_WARMUP + drill_steps + INTEG_STEPS
    trainer = cb.Trainer(model, opt)
    cbs = cb.CallbackList([
        cb.BroadcastVariablesCallback(root_rank=0),
        cb.LearningRateWarmupCallback(initial_lr=1e-4, warmup_epochs=1,
                                      steps_per_epoch=total)], trainer)
    fn = opt.accumulate(lambda t: gpt_mod.next_token_loss(
        model(t[:, :-1]), t[:, 1:]) * hvd.current_loss_scale(opt))
    batches = integrity_batches(torch, model.vocab_size, total,
                                INTEG_MICRO * INTEG_ACCUM, 21, dev)
    cbs.on_train_begin()
    cbs.on_epoch_begin(0)
    losses, times, waits, rec = [], [], [], {}
    timed0 = INTEG_WARMUP + drill_steps
    with hvd.DeviceInfeed(iter(batches), depth=2) as feed:
        check(feed.device.type == dev, f"infeed on {feed.device}, not {dev}")
        for i in range(total):
            if i == timed0:
                _sync(torch, dev)
                if dev == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
                issued0, agreed0 = opt.bucket_allreduces, \
                    opt.guard_agreements
            t0 = time.perf_counter()
            batch = next(feed)
            t1 = time.perf_counter()
            check(batch.device.type == dev, f"batch on {batch.device}")
            cbs.on_batch_begin(i)
            poisoned = drill and i + 1 == INTEG_POISON_STEP
            if poisoned:
                before = state_snapshot(model, opt)
                guard0 = hvd.observe_guard(opt, name="integrity")
                handle = poison_first_grad(torch, model, float("inf"))
            scale = hvd.current_loss_scale(opt)
            opt.zero_grad()
            loss = fn(batch)
            opt.step()
            _sync(torch, dev)
            if i >= timed0:
                times.append(time.perf_counter() - t1)
                waits.append(t1 - t0)
            losses.append(float(loss) / scale)
            cbs.on_batch_end(i)
            if poisoned:
                handle.remove()
                after = state_snapshot(model, opt)
                unchanged = len(before) == len(after) and all(
                    torch.equal(a, b) for a, b in zip(before, after))
                snap = hvd.observe_guard(opt, name="integrity")
                rec["guard_drill"] = {"step": i + 1, "before": guard0,
                                      "after": snap,
                                      "state_tensors": len(before),
                                      "state_bitwise_unchanged": unchanged}
                check(unchanged, "guard: the skipped step changed a weight "
                                 "or an AdamW state tensor")
                check(guard0["loss_scale"] == LOSS_SCALE0
                      and snap["loss_scale"] == LOSS_SCALE0 / 2
                      and snap["nonfinite_steps"] == 1
                      and snap["good_steps"] == 0 and not snap["last_ok"],
                      f"guard: snapshot {guard0} -> {snap}")
                first_before = before[0]
                del before, after
            elif drill and i == INTEG_POISON_STEP:
                applied = not torch.equal(
                    next(model.parameters()).detach(), first_before)
                rec["guard_drill"]["next_step_applied"] = applied
                check(applied, "guard: the step after the skip applied no "
                               "update")
                del first_before
    cbs.on_epoch_end(0)
    cbs.on_train_end()
    launches = dict(K.LAUNCHES)
    issued = opt.bucket_allreduces - issued0
    agreed = opt.guard_agreements - agreed0
    check(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    per = model.num_layers * INTEG_ACCUM * INTEG_STEPS
    want = {k: 0 for k in launches}
    want.update(flash_fwd=per * (2 if remat == "full" else 1),
                flash_bwd_dq=per, flash_bwd_dkv=per,
                scale_buffer=buckets * INTEG_STEPS
                if policy == "scale_backoff" else 0)
    if dev == "cuda":
        check(launches == want, f"integrity ({remat}, {policy}): launches "
                                f"{launches}, expected {want}")
    check(issued == buckets * INTEG_STEPS,
          f"integrity: {issued} bucket allreduces in {INTEG_STEPS} steps "
          f"({buckets} buckets): more than one round a step")
    check(agreed == (INTEG_STEPS if policy else 0),
          f"integrity: {agreed} guard agreements in {INTEG_STEPS} steps")
    step_s = statistics.median(times)
    rec.update({
        "remat_policy": remat, "nonfinite_policy": policy,
        "layers": model.num_layers, "accum_steps": INTEG_ACCUM,
        "microbatch": INTEG_MICRO, "seq_len": TRAIN_SEQ,
        "fusion_buckets": buckets, "bucket_allreduces": issued,
        "guard_agreements": agreed, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3,
        "tokens_per_s": INTEG_MICRO * INTEG_ACCUM * TRAIN_SEQ / step_s,
        "infeed_wait_ms_per_batch": statistics.mean(waits) * 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30
        if dev == "cuda" else None,
        "losses": losses, "launches": launches,
        "guard": hvd.observe_guard(opt, name="integrity-end")})
    if profile:
        tokens = batches[-1].to(dev)

        def step():
            opt.zero_grad()
            loss = fn(tokens)
            opt.step()
            return loss

        rec["profile"] = profile_steps(torch, step, 2, os.path.join(
            out_dir, f"chip_smoke_integrity_{remat}_{policy}_profile.txt"))
        print(f"profile (integrity {remat}/{policy}): "
              f"{json.dumps(rec['profile'])}", flush=True)
    release(torch, opt, dev)
    return rec


def _verify_counts(hvd) -> dict:
    fam = hvd.metrics().get("hvd_tpu_checkpoint_verify_total", {})
    return {s["labels"]["result"]: s["value"]
            for s in fam.get("samples", [])}


def checkpoint_drill(torch, hvd, gpt_mod, dev: str, layers: int) -> dict:
    """GPT-2 medium's widths at ``layers`` deep, AdamW and the
    scale_backoff guard through ``CheckpointManager(max_to_keep=2)`` in a
    temporary directory: saves at steps 2 and 4, two more steps; step 4
    restored into a fresh model and optimizer must repeat those two steps
    bitwise; then step 4 bit-flipped, and ``restore()`` must walk back to
    step 2, counting one corruption."""
    import shutil
    import tempfile

    def make(seed):
        model = integrity_model(torch, gpt_mod, dev, layers, seed=seed)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            accum_steps=INTEG_ACCUM, nonfinite_policy="scale_backoff")
        fn = opt.accumulate(lambda t: gpt_mod.next_token_loss(
            model(t[:, :-1]), t[:, 1:]) * hvd.current_loss_scale(opt))
        return model, opt, fn

    batches = [b.to(dev) for b in integrity_batches(
        torch, 50257, CKPT_STEPS, INTEG_MICRO * INTEG_ACCUM, 41, dev)]

    def step(opt, fn, s):
        opt.zero_grad()
        fn(batches[s - 1])
        opt.step()

    directory = tempfile.mkdtemp(prefix="hvd_tpu_torch_ckpt_")
    try:
        model, opt, fn = make(0)
        mgr = hvd.CheckpointManager(directory, max_to_keep=2)
        save_ms = {}
        for s in range(1, CKPT_STEPS + 1):
            step(opt, fn, s)
            if s in CKPT_SAVES:
                _sync(torch, dev)
                t0 = time.perf_counter()
                mgr.save(s, {"model": model.state_dict(),
                             "optimizer": opt.state_dict()})
                save_ms[s] = (time.perf_counter() - t0) * 1e3
        _sync(torch, dev)
        final = [p.detach().clone() for p in model.parameters()]
        t0 = time.perf_counter()
        mgr.wait()
        drain_s = time.perf_counter() - t0
        check(mgr.all_steps() == list(CKPT_SAVES),
              f"checkpoint: steps on disk {mgr.all_steps()}")
        release(torch, opt, dev)
        del model, opt, fn
        counts0 = _verify_counts(hvd)
        model, opt, fn = make(1)
        t0 = time.perf_counter()
        tree = mgr.restore()
        restore_s = time.perf_counter() - t0
        check(mgr.last_restored_step == CKPT_SAVES[-1],
              f"checkpoint: restored step {mgr.last_restored_step}")
        model.load_state_dict(tree["model"])
        opt.load_state_dict(tree["optimizer"])
        del tree
        for s in range(CKPT_SAVES[-1] + 1, CKPT_STEPS + 1):
            step(opt, fn, s)
        _sync(torch, dev)
        equal = all(torch.equal(a, p.detach())
                    for a, p in zip(final, model.parameters()))
        check(equal, "checkpoint: the restored run's weights differ from "
                     "the uninterrupted run's")
        release(torch, opt, dev)
        counts1 = _verify_counts(hvd)
        corrupt0 = hvd.recovery_stats()["checkpoint_corruptions"]
        mgr._corrupt_step(CKPT_SAVES[-1], "bitflip")
        mgr.restore()
        walked = mgr.last_restored_step
        counts2 = _verify_counts(hvd)
        delta = {k: counts2.get(k, 0) - counts1.get(k, 0) for k in counts2}
        corrupted = hvd.recovery_stats()["checkpoint_corruptions"] - corrupt0
        check(walked == CKPT_SAVES[0] and delta.get("corrupt") == 1
              and delta.get("ok") == 1 and corrupted == 1,
              f"checkpoint: walk-back landed on {walked}, verify counts "
              f"{delta}, corruptions {corrupted}")
        rec = {"layers": layers, "saves": list(CKPT_SAVES),
               "steps": CKPT_STEPS, "max_to_keep": 2,
               "save_caller_ms": save_ms,
               "write_s": dict(mgr.write_seconds),
               "bytes": dict(mgr.payload_bytes), "drain_s": drain_s,
               "restore_s": restore_s, "resumed_bitwise": equal,
               "verify_counts_restore": {
                   k: counts1.get(k, 0) - counts0.get(k, 0)
                   for k in counts1},
               "walk_back_to": walked, "verify_counts_walk_back": delta,
               "corruptions_counted": corrupted}
        mgr.close()
        del model, opt, fn, final
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return rec


def phase_integrity(torch, K, out_dir: str, profile: bool = False,
                    dev: str = "cuda", layers: int = 24,
                    ckpt_layers: int = CKPT_LAYERS) -> dict:
    """The guard, accumulation with remat, the infeed and verified
    checkpoints on GPT-2 medium at full width, world size 1 (NCCL)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch.models import gpt as gpt_mod

    t0 = time.perf_counter()
    ctx = hvd.init(device=None if dev == "cuda" else dev)
    check(hvd.size() == 1 and (dev != "cuda" or ctx.backend == "nccl"),
          f"init: world {hvd.size()} over {ctx.backend}")
    result = {"model": "gpt_medium", "layers": layers, "hidden": 1024,
              "heads": 16, "mlp": 4096, "vocab": 50257,
              "dtype": "bfloat16", "accum_steps": INTEG_ACCUM,
              "microbatch": INTEG_MICRO, "seq_len": TRAIN_SEQ,
              "world_size": 1, "backend": ctx.backend,
              "optimizer": "AdamW(lr=1e-4, wd=1e-4)"}
    # (a) remat full against none, (b) 4 x 2 rows against 8 fused, on one
    # model with no optimizer hooks.
    model = integrity_model(torch, gpt_mod, dev, layers)
    batch = integrity_batches(torch, model.vocab_size, 1,
                              INTEG_MICRO * INTEG_ACCUM, 31, dev)[0].to(dev)

    def loss(t):
        return gpt_mod.next_token_loss(model(t[:, :-1]), t[:, 1:])

    def fused(t):
        value = loss(t)
        value.backward()
        return value.detach()

    none = grads_of(torch, model, lambda: hvd.accumulate_gradients(
        loss, INTEG_ACCUM, "none")(batch))
    full = grads_of(torch, model, lambda: hvd.accumulate_gradients(
        loss, INTEG_ACCUM, "full")(batch))
    result["remat_full_vs_none"] = compare_grads(torch, full, none,
                                                 "remat full vs none")
    del none, full
    rows = batch[:INTEG_ACCUM * 2]
    accum = grads_of(torch, model, lambda: hvd.accumulate_gradients(
        loss, INTEG_ACCUM)(rows))
    one = grads_of(torch, model, lambda: fused(rows))
    result["accum_vs_fused"] = compare_grads(torch, accum, one,
                                             "4 x 2 rows vs 8 fused")
    del accum, one, model, batch, rows
    import gc

    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    runs = {}
    for remat, policy in INTEG_CONFIGS:
        runs[f"{remat}/{policy}"] = integrity_run(
            torch, K, hvd, gpt_mod, cb, remat, policy, dev, layers,
            drill=(remat, policy) == INTEG_CONFIGS[0], out_dir=out_dir,
            profile=profile and dev == "cuda")
    result["runs"] = runs
    result["guard_cost_ms"] = {
        remat: runs[f"{remat}/scale_backoff"]["step_ms_median"]
        - runs[f"{remat}/None"]["step_ms_median"]
        for remat in ("none", "full")}
    result["checkpoint"] = checkpoint_drill(torch, hvd, gpt_mod, dev,
                                            ckpt_layers)
    result["setup_and_run_s"] = time.perf_counter() - t0
    hvd.shutdown()
    if dev == "cuda":
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "chip_smoke_integrity.json"), "w") as f:
        json.dump(result, f, indent=1)
    for what in ("remat_full_vs_none", "accum_vs_fused"):
        r = result[what]
        print(f"integrity {what}: loss rel err {r['loss_rel_err']:.3g}, "
              f"worst grad rel err {r['grad_rel_err_max']:.3g} on "
              f"{r['grad_rel_err_param']} (limits 1e-3, 2e-2); bitwise "
              f"equal: {r['bitwise_equal']}", flush=True)
    for key, r in runs.items():
        print(f"integrity {key}: gpt_medium {INTEG_ACCUM} x {INTEG_MICRO} "
              f"x {TRAIN_SEQ} a step, step {r['step_ms_median']:.1f} ms "
              f"(median of {INTEG_STEPS}) = {r['tokens_per_s']:.0f} tok/s; "
              f"peak {r['peak_mem_gib']} GiB; infeed wait "
              f"{r['infeed_wait_ms_per_batch']:.3f} ms/batch; loss "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
              f"{r['bucket_allreduces']} bucket allreduces, "
              f"{r['guard_agreements']} agreements; launches "
              f"{json.dumps(r['launches'])}", flush=True)
    drill = runs[f"{INTEG_CONFIGS[0][0]}/{INTEG_CONFIGS[0][1]}"][
        "guard_drill"]
    print(f"integrity guard drill: +Inf at step {drill['step']}: "
          f"{drill['state_tensors']} weight and AdamW tensors bitwise "
          f"unchanged: {drill['state_bitwise_unchanged']}; guard "
          f"{json.dumps(drill['before'])} -> {json.dumps(drill['after'])}; "
          f"next step applied: {drill['next_step_applied']}; guard cost "
          f"(scale_backoff - off) {json.dumps(result['guard_cost_ms'])} ms",
          flush=True)
    c = result["checkpoint"]
    print(f"integrity checkpoint ({c['layers']} layers): save blocks the "
          f"caller {json.dumps(c['save_caller_ms'])} ms, background write "
          f"{json.dumps(c['write_s'])} s, {json.dumps(c['bytes'])} bytes; "
          f"restore {c['restore_s']:.2f} s, resumed bitwise "
          f"{c['resumed_bitwise']}; bit flip -> walked back to step "
          f"{c['walk_back_to']}, verify counts "
          f"{json.dumps(c['verify_counts_walk_back'])}", flush=True)
    return result


# -- the multi-rank drills of the n = 4 rank workers -------------------------

GUARD_DRILL_STEPS, GUARD_BAD = 3, (2, 1)   # steps; (bad step, bad rank)


def guard_drill(torch, hvd, gpt_mod, C, model, tokens, rank: int) -> dict:
    """``compression="int8_ef", nonfinite_policy="skip_step"`` over the
    ranks, a NaN lane in rank 1's gradient at step 2: one agreement a
    step; every rank skips; the int8_ef residuals and rounding step and
    every weight bitwise unchanged across the skip; replicas bitwise equal
    after every step."""
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), compression="int8_ef",
        nonfinite_policy="skip_step")
    int8 = opt._dist_plan.wire_dtypes.count("int8")
    check(int8 > 0, "guard drill: no int8 bucket")
    rec = {"steps": [], "int8_buckets": int8}
    for step in range(1, GUARD_DRILL_STEPS + 1):
        res0 = {b: r.clone() for b, r in opt._ef_residual.items()}
        ef0 = opt._ef_step
        w0 = [p.detach().clone() for p in params]
        opt.zero_grad()
        bad = (step, rank) == GUARD_BAD
        handle = poison_first_grad(torch, model, float("nan")) if bad \
            else None
        gpt_mod.next_token_loss(model(tokens[:, :-1]),
                                tokens[:, 1:]).backward()
        if handle is not None:
            handle.remove()
        opt.step()
        snap = hvd.observe_guard(opt, name="guard-drill")
        every = C.all_gather_stack(digest(params))
        equal = bool((every == every[0]).all())
        same_w = all(torch.equal(a, p.detach()) for a, p in zip(w0, params))
        same_res = len(res0) == len(opt._ef_residual) and all(
            torch.equal(res0[b], r) for b, r in opt._ef_residual.items())
        skipped = step == GUARD_BAD[0]
        check(equal, f"guard drill: replicas differ after step {step}")
        if skipped:
            check(same_w and same_res and opt._ef_step == ef0
                  and snap["nonfinite_steps"] == 1 and not snap["last_ok"],
                  f"guard drill: rank {rank} did not skip step {step} "
                  f"cleanly (weights {same_w}, residual {same_res}, ef step "
                  f"{ef0} -> {opt._ef_step}, guard {snap})")
        else:
            check(not same_w and opt._ef_step == ef0 + 1 and snap["last_ok"],
                  f"guard drill: step {step} did not apply on rank {rank}")
        rec["steps"].append({"step": step, "skipped": skipped,
                             "replicas_equal": equal,
                             "weights_unchanged": same_w,
                             "residual_unchanged": same_res,
                             "ef_step": opt._ef_step, "guard": snap})
    check(opt.guard_agreements == GUARD_DRILL_STEPS,
          f"guard drill: {opt.guard_agreements} agreements in "
          f"{GUARD_DRILL_STEPS} steps")
    rec["guard_agreements"] = opt.guard_agreements
    for h in opt._dist_hooks:
        h.remove()
    return rec


DIVERGE_RANK = 2


def divergence_drill(torch, hvd, model, rank: int) -> dict:
    """``DivergenceDetector(every_steps=2, policy="resync")`` after one
    weight of rank 2 is perturbed: every rank's detector names rank 2,
    ``broadcast_parameters`` heals it, and the replicas are bitwise equal
    again."""
    from horovod_tpu_torch.ops import collectives as C

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    det = hvd.DivergenceDetector(every_steps=2, policy="resync")
    check(det.check(model, step=1) is None, "divergence: off-cadence check")
    clean = det.check(model, step=2)
    if rank == DIVERGE_RANK:
        with torch.no_grad():
            params[0].view(-1)[0] += 1e-3
    report = det.check(model, step=4)
    check(not report["ok"] and report["ranks"] == (DIVERGE_RANK,)
          and report["needs_resync"],
          f"divergence: rank {rank} reported {report}")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    every = C.all_gather_stack(digest(params))
    healed = bool((every == every[0]).all())
    diverged, dev = hvd.integrity.check_divergence(model)
    after = det.check(model, step=6)
    check(clean["ok"] and healed and not diverged and dev == 0.0
          and after["ok"], f"divergence: not healed on rank {rank} "
                           f"(digests {healed}, spread {dev}, {after})")
    return {"clean": clean["ok"], "named": list(report["ranks"]),
            "needs_resync": report["needs_resync"], "healed": healed,
            "spread_after": dev, "checks": det.checks}


# -- the model zoo: BERT-large, ViT-B/16, ResNet-50 and one step of the rest

BERT_BATCH, BERT_SEQ, BERT_MLM = 8, 512, 0.15
VIT_BATCH, VIT_IMAGE = 64, 224
RESNET_BATCH, RESNET_IMAGE = 256, 224
ZOO_WARMUP, BERT_STEPS, IMAGE_STEPS = 2, 5, 3
RESNET_REF_BATCH = 32               # images in the bf16 vs fp32 check
RESNET_REF_RTOL = 5e-2              # bf16 vs fp32 logits, of max |logit|
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def timed_steps(torch, K, step, warmup: int, steps: int) -> dict:
    """``warmup`` steps, then ``steps`` timed ones (host clock around a
    synchronized step) with the launch counters zeroed just before them
    and read just after, and the peak memory of the timed steps."""
    losses = [step().item() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times = []
    for _ in range(steps):
        s0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
        losses.append(loss.item())
    launches = dict(K.LAUNCHES)
    check(all(map(math.isfinite, losses)), f"non-finite loss in {losses}")
    return {"warmup_steps": warmup, "timed_steps": steps,
            "step_ms": [t * 1e3 for t in times],
            "step_ms_median": statistics.median(times) * 1e3,
            "losses": losses, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def check_flash_launches(run: dict, layers: int, what: str) -> None:
    want = layers * run["timed_steps"]
    for name in FLASH_NAMES:
        check(run["launches"][name] == want,
              f"{what}: {name} launched {run['launches'][name]} times, "
              f"expected {layers} x {run['timed_steps']} = {want}")


def seeded(torch, make, **kw):
    """A model built on the card with seeded random weights."""
    with torch.device("cuda"):
        model = make(**kw)
    return model.init_weights(torch.Generator(device="cuda").manual_seed(0))


def distributed_adamw(torch, hvd, model):
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    return hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())


def phase_bert(torch, K, out_dir: str, profile: bool = False) -> dict:
    """BERT-large MLM pretraining steps: B = 8, S = 512, a padded batch's
    key mask (per-sample lengths in [S/2, S]) so that the key-mask path of
    K5/K6/K7 runs, the loss over 15% of the unpadded positions with the
    labels equal to the tokens."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert as bert_mod
    from horovod_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    ctx = hvd.init()
    check(hvd.size() == 1 and ctx.backend == "nccl",
          f"init: world {hvd.size()} over {ctx.backend}")
    model = seeded(torch, bert_mod.bert_large, max_len=BERT_SEQ)
    check(model.num_layers == 24 and model.hidden_size == 1024
          and model.num_heads == 16 and model.mlp_dim == 4096
          and model.vocab_size == 30522, "bert_large geometry")
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, model.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device="cuda")
    mask = length_mask(torch, BERT_BATCH, BERT_SEQ, gen)
    weights = (torch.rand((BERT_BATCH, BERT_SEQ), generator=gen,
                          device="cuda") < BERT_MLM).float() * mask

    def loss_fn():
        return bert_mod.mlm_loss(model(tokens, mask), tokens, weights)

    def plain_attend(q, k, v, m=None):
        return fa.reference_attention(q, k, v, m)

    ref = reference_step(torch, model, loss_fn, plain_attend)
    check_reference(ref, "bfloat16", "bert_large")
    opt = distributed_adamw(torch, hvd, model)

    def step():
        loss = loss_fn()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss

    run = timed_steps(torch, K, step, ZOO_WARMUP, BERT_STEPS)
    check_flash_launches(run, model.num_layers, "bert")
    check(run["losses"][-1] < run["losses"][0],
          f"bert: loss did not fall: {run['losses']}")
    step_s = run["step_ms_median"] / 1e3
    result = {
        "model": "bert_large", "layers": 24, "hidden": 1024, "heads": 16,
        "mlp": 4096, "vocab": 30522, "dtype": "bfloat16",
        "batch": BERT_BATCH, "seq_len": BERT_SEQ, "world_size": 1,
        "backend": ctx.backend, "optimizer": "AdamW(lr=1e-4, wd=1e-4)",
        "mlm_fraction": BERT_MLM, "key_mask": "per-sample lengths in "
        "[S/2, S]", "attended_keys": int(mask.sum().item()),
        "mlm_positions": int(weights.sum().item()),
        **run, "samples_per_s": BERT_BATCH / step_s,
        "tokens_per_s": BERT_BATCH * BERT_SEQ / step_s,
        "reference": ref, "setup_s": time.perf_counter() - t0}
    if profile:
        result["profile"] = profile_steps(
            torch, step, 2, os.path.join(out_dir,
                                         "chip_smoke_bert_profile.txt"))
        print(f"profile (bert): {json.dumps(result['profile'])}",
              flush=True)
    with open(os.path.join(out_dir, "chip_smoke_bert.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"bert: bert_large B={BERT_BATCH} S={BERT_SEQ} with a key mask "
          f"({result['attended_keys']} of {BERT_BATCH * BERT_SEQ} keys), "
          f"step {run['step_ms_median']:.1f} ms (median of {BERT_STEPS}) = "
          f"{result['samples_per_s']:.1f} samples/s; peak "
          f"{run['peak_mem_gib']:.2f} GiB; loss {run['losses'][0]:.4f} -> "
          f"{run['losses'][-1]:.4f}; launches {run['launches']}", flush=True)
    del opt, model
    hvd.shutdown()
    torch.cuda.empty_cache()
    return result


def classify_step(torch, model, opt, images, labels):
    def step():
        loss = torch.nn.functional.cross_entropy(model(images), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss
    return step


def image_batch(torch, b: int, size: int, classes: int, seed: int,
                channels: int = 3):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn((b, channels, size, size), generator=gen,
                         device="cuda")
    return images, torch.randint(0, classes, (b,), generator=gen,
                                 device="cuda")


def phase_vit(torch, K, out_dir: str, profile: bool = False) -> dict:
    """ViT-B/16 classification training on 224x224 images (S = 197
    tokens, a ragged last tile of 5), with the flash-vs-plain check."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import vit as vit_mod
    from horovod_tpu_torch.ops import flash_attention as fa

    ctx = hvd.init()
    model = seeded(torch, vit_mod.vit_base, image_size=VIT_IMAGE)
    check(model.num_layers == 12 and model.hidden == 768
          and model.pos_embed.shape[1] == VIT_PATH[1], "vit_base geometry")
    images, labels = image_batch(torch, VIT_BATCH, VIT_IMAGE, 1000, 13)

    def loss_fn():
        return torch.nn.functional.cross_entropy(model(images), labels)

    def plain_attend(q, k, v, m=None):
        return fa.reference_attention(q, k, v, m)

    ref = reference_step(torch, model, loss_fn, plain_attend)
    check_reference(ref, "bfloat16", "vit_base")
    opt = distributed_adamw(torch, hvd, model)
    step = classify_step(torch, model, opt, images, labels)
    run = timed_steps(torch, K, step, ZOO_WARMUP, IMAGE_STEPS)
    check_flash_launches(run, model.num_layers, "vit")
    result = {"model": "vit_base", "patch": 16, "layers": 12, "hidden": 768,
              "heads": 12, "tokens": VIT_PATH[1], "dtype": "bfloat16",
              "batch": VIT_BATCH, "image": VIT_IMAGE, "world_size": 1,
              "backend": ctx.backend, **run,
              "images_per_s": VIT_BATCH / (run["step_ms_median"] / 1e3),
              "reference": ref}
    if profile:
        result["profile"] = profile_steps(
            torch, step, 2, os.path.join(out_dir,
                                         "chip_smoke_vit_profile.txt"))
        print(f"profile (vit): {json.dumps(result['profile'])}",
              flush=True)
    with open(os.path.join(out_dir, "chip_smoke_vit.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"vit: vit_base B={VIT_BATCH} {VIT_IMAGE}x{VIT_IMAGE} (S = "
          f"{VIT_PATH[1]}), step {run['step_ms_median']:.1f} ms (median of "
          f"{IMAGE_STEPS}) = {result['images_per_s']:.1f} img/s; peak "
          f"{run['peak_mem_gib']:.2f} GiB; loss {run['losses'][0]:.4f} -> "
          f"{run['losses'][-1]:.4f}; launches {run['launches']}", flush=True)
    del opt, model
    hvd.shutdown()
    torch.cuda.empty_cache()
    return result


def phase_resnet(torch, K, out_dir: str, profile: bool = False) -> dict:
    """ResNet-50 with the space-to-depth stem, classification training at
    B = 256 on 224x224 images (channels_last), after a check of its bf16
    forward against the fp32 forward of the same weights."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as resnet_mod

    ctx = hvd.init()
    model = seeded(torch, resnet_mod.ResNet50, space_to_depth=True)
    model = model.to(memory_format=torch.channels_last)
    images, labels = image_batch(torch, RESNET_BATCH, RESNET_IMAGE, 1000, 14)
    images = images.contiguous(memory_format=torch.channels_last)
    # bf16 vs fp32 forward (training mode: batch statistics) on copies,
    # so the trained model's running statistics stay its own.
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.device("cuda"):
            copy = resnet_mod.ResNet50(space_to_depth=True, dtype=dtype)
        copy.load_state_dict(model.state_dict())
        with torch.no_grad():
            outs[dtype] = copy(images[:RESNET_REF_BATCH])
        del copy
    b16, f32 = outs[torch.bfloat16], outs[torch.float32]
    check(bool(torch.isfinite(b16).all()), "resnet: non-finite logits")
    ref_err = ((b16 - f32).abs().max() / f32.abs().max()).item()
    check(ref_err <= RESNET_REF_RTOL,
          f"resnet: bf16 logits off fp32 by {ref_err} of max|logit| > "
          f"{RESNET_REF_RTOL}")
    print(f"reference (resnet50): bf16 vs fp32 forward, {RESNET_REF_BATCH} "
          f"images, max err {ref_err:.3g} of max|logit| (limit "
          f"{RESNET_REF_RTOL})", flush=True)
    opt = distributed_adamw(torch, hvd, model)
    step = classify_step(torch, model, opt, images, labels)
    run = timed_steps(torch, K, step, ZOO_WARMUP, IMAGE_STEPS)
    n_params = sum(p.numel() for p in model.parameters())
    result = {"model": "resnet50", "space_to_depth": True,
              "memory_format": "channels_last", "params": n_params,
              "dtype": "bfloat16", "batch": RESNET_BATCH,
              "image": RESNET_IMAGE, "world_size": 1,
              "backend": ctx.backend, **run,
              "images_per_s": RESNET_BATCH / (run["step_ms_median"] / 1e3),
              "reference": {"batch": RESNET_REF_BATCH, "rel_err": ref_err,
                            "limit": RESNET_REF_RTOL}}
    if profile:
        result["profile"] = profile_steps(
            torch, step, 2, os.path.join(out_dir,
                                         "chip_smoke_resnet_profile.txt"))
        print(f"profile (resnet): {json.dumps(result['profile'])}",
              flush=True)
    with open(os.path.join(out_dir, "chip_smoke_resnet.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"resnet: resnet50 (s2d stem, {n_params} params) B={RESNET_BATCH} "
          f"{RESNET_IMAGE}x{RESNET_IMAGE}, step {run['step_ms_median']:.1f} "
          f"ms (median of {IMAGE_STEPS}) = {result['images_per_s']:.1f} "
          f"img/s; peak {run['peak_mem_gib']:.2f} GiB; loss "
          f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}", flush=True)
    del opt, model, outs, b16, f32
    hvd.shutdown()
    torch.cuda.empty_cache()
    return result


# name: (constructor in horovod_tpu_torch.models, batch, image size,
# channels); the MNIST models take 10 classes, the others 1000
ZOO_ONE_STEP = {
    "vgg16": ("VGG16", 32, 224, 3),
    "inception_v3": ("InceptionV3", 32, 299, 3),
    "mlp": ("MLP", 64, 28, 1),
    "convnet": ("ConvNet", 64, 28, 1),
}


def phase_zoo(torch) -> dict:
    """One checked training step (forward and backward, AdamW) of each
    other model: a finite loss and finite gradients."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models

    hvd.init()
    out = {}
    for name, (ctor, b, size, c) in ZOO_ONE_STEP.items():
        model = seeded(torch, getattr(models, ctor))
        images, labels = image_batch(torch, b, size, 10 if c == 1 else 1000,
                                     15, channels=c)
        opt = distributed_adamw(torch, hvd, model)
        s0 = time.perf_counter()
        loss = classify_step(torch, model, opt, images, labels)()
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in model.parameters())
        check(math.isfinite(loss.item()) and finite,
              f"{name}: loss {loss.item()}, gradients finite: {finite}")
        out[name] = {"batch": b, "image": size, "loss": loss.item(),
                     "first_step_s": wall, "dtype": str(model.dtype),
                     "params": sum(p.numel() for p in model.parameters())}
        print(f"zoo: {name} B={b} {size}x{size}: one step, loss "
              f"{loss.item():.4f}, {out[name]['params']} params, "
              f"{wall:.2f} s (first step)", flush=True)
        del opt, model, images, labels
        torch.cuda.empty_cache()
    hvd.shutdown()
    return out


# -- multi-rank phase: n processes on the one card, collectives over gloo --

MULTI_WARMUP, MULTI_STEPS = 1, 3
MULTI_CONFIGS = {
    # n, model, per-rank batch, sequence length, worker timeout (s)
    "n2_gpt_medium": (2, "gpt_medium", 8, 512, 600),
    "n4_gpt_tiny": (4, "gpt_tiny", 8, 128, 300),
}
ADASUM_REF_RTOL = 1e-5              # reduced delta vs the fp64 reference


def _make_model(torch, gpt_mod, name, dev: str = "cuda", **kw):
    with torch.device(dev):
        model = gpt_mod.gpt_medium(**kw) if name == "gpt_medium" else \
            gpt_mod.gpt_tiny(hidden=128, num_heads=2, **kw)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return model


class _Digest:
    """Per-tensor fingerprints of the parameters, on the card: the int32
    bit patterns of each tensor summed plain and weighted by a fixed
    pseudo-random int64 sequence (integer sums: exact in any order).
    Equal parameters give equal digests; a one-bit difference changes
    them."""

    def __init__(self, torch, params):
        n = max(p.numel() for p in params)
        idx = torch.arange(n, device=params[0].device, dtype=torch.int64)
        self.weights = (idx * 2654435761) % 2147483647 + 1
        self.torch = torch

    def __call__(self, params):
        rows = []
        for p in params:
            bits = p.detach().reshape(-1).view(self.torch.int32).to(
                self.torch.int64)
            rows.append(self.torch.stack(
                [bits.sum(), (bits * self.weights[:bits.numel()]).sum()]))
        return self.torch.stack(rows)


def wire_bytes(plan, n: int, adasum_numels=None) -> dict:
    """Bytes one rank sends per step, counted as a ring moves them: an
    int8 bucket 2(n-1)/n of its padded codes and scales (the all_to_all
    and the all_gather), a bf16/native bucket 2(n-1)/n of its payload
    (all_reduce); an Adasum step each tensor once per level. Beside it
    the fp32 ring allreduce of the same gradients."""
    ring = 2 * (n - 1) / n
    if adasum_numels is not None:
        total = sum(adasum_numels)
        return {"wire": (n.bit_length() - 1) * 4 * total,
                "fp32_ring": ring * 4 * total}
    wire = fp32 = 0.0
    for b, w in zip(plan.buckets, plan.wire_dtypes):
        fp32 += ring * 4 * b.total_elems
        if w == "int8":
            padded = -(-b.total_elems // (n * 4096)) * n * 4096
            wire += ring * (padded + padded // 4096 * 4)
        else:
            wire += ring * b.total_elems * (2 if w == "bf16" else 4)
    return {"wire": wire, "fp32_ring": fp32}


def _ef_bound_check(torch, fusion, opt, bi, exact, s_ranks, n) -> dict:
    """The bucket's reduced gradient against the exact fp32 average of
    the same buffers, within (sum of s_rank + s_reduced) / n per 4096
    block (stochastic rounding, r = 1; s_reduced bounded by the exact
    block absmax plus the first hop's error)."""
    bucket = opt._dist_plan.buckets[bi]
    params = opt._dist_params
    y = fusion.fuse_bucket({i: params[i].grad for i in bucket.leaf_indices},
                           bucket).double()
    size = y.numel()
    pad = (-size) % 4096

    def block_max(v):
        return torch.nn.functional.pad(v.abs(), (0, pad)).reshape(
            -1, 4096).amax(1)

    s_red = (block_max(exact * n) + s_ranks) / 127
    bound = ((s_ranks + s_red) / n).repeat_interleave(4096)[:size]
    err = (y - exact).abs()
    check(bool((err <= bound + 1e-7).all()),
          f"int8_ef: bucket {bi} off the exact average by more than the "
          f"bound at {int((err > bound + 1e-7).sum())} elements")
    return {"bucket": bi, "elements": size, "max_err": err.max().item(),
            "max_bound": bound.max().item(),
            "worst_err_over_bound": (err / bound.clamp_min(1e-30)).max()
            .item()}


def _adasum_probe(torch, adasum_mod, target: int):
    """Records the input and output of the ``target``-th per-tensor
    ``adasum_allreduce`` call of one step (the optimizer calls it through
    the module, in parameter order). Returns (record, restore)."""
    orig = adasum_mod.adasum_allreduce
    seen = {"calls": 0}

    def probe(x, *a, **k):
        y = orig(x, *a, **k)
        if seen["calls"] == target:
            seen["delta"], seen["reduced"] = x.clone(), y.clone()
        seen["calls"] += 1
        return y

    adasum_mod.adasum_allreduce = probe

    def restore():
        adasum_mod.adasum_allreduce = orig
    return seen, restore


@contextlib.contextmanager
def wire_clock(torch, C, seconds: list):
    """Adds to ``seconds[0]`` the host time spent in the collectives a
    reduction runs (``all_to_all``, ``all_gather_stack``,
    ``pair_exchange``; gloo returns from each after its copies back to
    the card), each timed from a synchronize of the card's queue."""
    names = ("all_to_all", "all_gather_stack", "pair_exchange")
    saved = {name: getattr(C, name) for name in names}

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[0] += time.perf_counter() - t0
        return call

    for name, fn in saved.items():
        setattr(C, name, timed(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(C, name, fn)


def rank_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of the multi-rank phase (``--rank-worker``): both
    reduction modes on the config's model, the first step checked
    against its reference, the timed steps counted and digested."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import fusion
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import adasum as adasum_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, model_name, batch, seq, _ = MULTI_CONFIGS[config]
    ctx = hvd.init(backend="gloo")
    check(ctx.backend == "gloo" and ctx.device.type == "cuda"
          and hvd.size() == n and hvd.rank() == rank,
          f"init: rank {hvd.rank()} of {hvd.size()} over {ctx.backend} on "
          f"{ctx.device}")
    out = {"config": config, "n": n, "rank": rank, "model": model_name,
           "batch": batch, "seq_len": seq, "backend": ctx.backend,
           "modes": {}}
    for mode in ("int8_ef", "adasum"):
        model = _make_model(torch, gpt_mod, model_name)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        digest = _Digest(torch, params)
        tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                               generator=torch.Generator().manual_seed(
                                   11 + rank)).to("cuda")
        kw = {"compression": "int8_ef"} if mode == "int8_ef" \
            else {"op": hvd.Adasum}
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(), **kw)
        rec = {"params": len(params)}

        def forward_backward():
            loss = gpt_mod.next_token_loss(model(tokens[:, :-1]),
                                           tokens[:, 1:])
            opt.zero_grad()
            loss.backward()
            return loss

        # First step: the reference check.
        loss = forward_backward()
        if mode == "int8_ef":
            plan = opt._dist_plan
            bi = plan.wire_dtypes.index("int8")
            bucket = plan.buckets[bi]
            local = fusion.fuse_bucket(
                {i: opt._dist_params[i].grad for i in bucket.leaf_indices},
                bucket).float()
            every = C.all_gather_stack(local).double()
            pad = (-local.numel()) % 4096
            s_ranks = torch.nn.functional.pad(every.abs(), (0, pad)).reshape(
                n, -1, 4096).amax(2).sum(0) / 127
            exact = every.mean(0)
            del every
            opt.step()
            rec["bound_check"] = _ef_bound_check(torch, fusion, opt, bi,
                                                 exact, s_ranks, n)
            del exact, s_ranks, local
            rec["int8_buckets"] = plan.wire_dtypes.count("int8")
            rec["buckets"] = len(plan.buckets)
            rec["wire_dtypes"] = list(plan.wire_dtypes)
            rec["bytes"] = wire_bytes(plan, n)
        else:
            target = max(range(len(params)),
                         key=lambda i: (params[i].numel() <= 4_194_304,
                                        params[i].numel()))
            seen, restore = _adasum_probe(torch, adasum_mod, target)
            try:
                opt.step()
            finally:
                restore()
            deltas = C.all_gather_stack(seen["delta"]).double().cpu().numpy()
            ref = adasum_mod.adasum_allreduce_reference(list(deltas))
            got = seen["reduced"].double().cpu().numpy()
            err = float(abs(got - ref).max())
            scale = float(abs(ref).max())
            check(err <= ADASUM_REF_RTOL * scale,
                  f"adasum: parameter {target} reduced delta off the fp64 "
                  f"reference by {err} > {ADASUM_REF_RTOL} x {scale}")
            rec["reference_check"] = {"param": target,
                                      "elements": int(got.size),
                                      "max_err": err, "max_abs_ref": scale,
                                      "rel": err / scale}
            rec["bytes"] = wire_bytes(None, n, [p.numel() for p in params])
        losses = [loss.item()]
        d = digest(params)
        every = C.all_gather_stack(d)
        check(bool((every == every[0]).all()),
              f"{mode}: replicas differ after the first step")
        for _ in range(MULTI_WARMUP - 1):
            losses.append(forward_backward().item())
            opt.step()
        # The timed steps: counts zeroed just before, read just after.
        torch.cuda.synchronize()
        hvd.barrier()
        K.reset_launch_counts()
        # Each step's host time, split at a synchronize after backward:
        # forward + backward, then step() (the reduction and the update),
        # and within step() the time in the reduction's collectives.
        times, split, equal = [], [], []
        for _ in range(MULTI_STEPS):
            t0 = time.perf_counter()
            loss = forward_backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wire_s = [0.0]
            with wire_clock(torch, C, wire_s):
                opt.step()
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            split.append((t1 - t0, time.perf_counter() - t1, wire_s[0]))
            losses.append(loss.item())
            every = C.all_gather_stack(digest(params))
            equal.append(bool((every == every[0]).all()))
        launches = dict(K.LAUNCHES)
        check(all(map(math.isfinite, losses)),
              f"{mode}: non-finite loss in {losses}")
        check(all(equal), f"{mode}: replicas differ after step(s) "
                          f"{[i for i, e in enumerate(equal) if not e]}")
        levels = n.bit_length() - 1
        flash = model.num_layers * MULTI_STEPS
        want = {k: 0 for k in launches}
        want.update(flash_fwd=flash, flash_bwd_dq=flash, flash_bwd_dkv=flash)
        if mode == "int8_ef":
            want["quantize_int8_stochastic"] = \
                2 * rec["int8_buckets"] * MULTI_STEPS
            res = [r for r in opt._ef_residual.values()]
            check(all(bool(torch.isfinite(r).all()) for r in res),
                  "int8_ef: non-finite residual")
            rec["residual_norm"] = hvd.observe_ef_residual(opt)
            check(rec["residual_norm"] > 0, "int8_ef: residual is zero")
        else:
            want["adasum_dot_norms"] = len(params) * levels * MULTI_STEPS
            want["adasum_combine"] = len(params) * levels * MULTI_STEPS
        check(launches == want, f"{mode}: launches {launches}, expected "
                                f"{want}")
        step_s = statistics.median(times)
        rec.update({
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "step_ms_median": step_s * 1e3,
            "fwd_bwd_ms_median": statistics.median(t[0] for t in split)
            * 1e3,
            "step_call_ms_median": statistics.median(t[1] for t in split)
            * 1e3,
            "wire_ms_median": statistics.median(t[2] for t in split) * 1e3,
            "tokens_per_s": n * batch * seq / step_s,
            "launches": launches, "replicas_equal": equal,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        if mode == "int8_ef":
            rec["gradfn"] = _gradfn_check(torch, hvd, gpt_mod, K, model,
                                          opt, tokens)
        out["modes"][mode] = rec
        del opt, model, params, digest
        torch.cuda.empty_cache()
    if n == 4:
        # Adasum's quantized wire with a stochastic key: per level one K3
        # (this rank's side) and two K4 (both sides dequantized).
        x = torch.randn(300_000, generator=torch.Generator(
            device="cuda").manual_seed(rank), device="cuda")
        K.reset_launch_counts()
        y = hvd.adasum_allreduce(x, wire="int8", key=(0x5EED, 99))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        levels = n.bit_length() - 1
        want = {k: 0 for k in launches}
        want.update(quantize_int8_stochastic=levels,
                    dequantize_int8=2 * levels, adasum_dot_norms=levels,
                    adasum_combine=levels)
        check(launches == want, f"adasum int8 wire: launches {launches}, "
                                f"expected {want}")
        every = C.all_gather_stack(y)
        check(bool((every == every[0]).all()),
              "adasum int8 wire: ranks differ")
        check(bool(torch.isfinite(y).all()), "adasum int8 wire: non-finite")
        out["adasum_int8_wire"] = {"elements": x.numel(),
                                   "launches": launches}
    if n == 4:
        tokens = torch.randint(0, 128, (batch, seq + 1),
                               generator=torch.Generator().manual_seed(
                                   11 + rank)).to("cuda")
        out["guard_drill"] = guard_drill(
            torch, hvd, gpt_mod, C, _make_model(torch, gpt_mod, model_name),
            tokens, rank)
        out["divergence_drill"] = divergence_drill(
            torch, hvd, _make_model(torch, gpt_mod, model_name), rank)
    if n == 2:
        out["sync_batch_norm"] = sync_bn_check(torch, hvd, rank)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


SBN_SHAPE = (32, 64, 28, 28)        # one rank's batch (N, C, H, W)
SBN_RTOL = 1e-5                     # of the largest |value| of BatchNorm's


def _gradfn_check(torch, hvd, gpt_mod, K, model, opt, tokens) -> dict:
    """One step's gradient tree through ``DistributedGradFn`` with int8_ef
    against a fresh ``DistributedOptimizer(compression="int8_ef")`` on the
    same gradients (one backward, no hooks live) and the same bucket plan:
    the reduced gradients bitwise equal and K3's launches equal."""
    for h in opt._dist_hooks:
        h.remove()
    params = list(model.parameters())
    model.zero_grad()
    gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:]).backward()
    grads = [p.grad.clone() for p in params]
    ref = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.0),
        named_parameters=model.named_parameters(), compression="int8_ef")
    for h in ref._dist_hooks:
        h.remove()
    _sync(torch, tokens.device.type)
    K.reset_launch_counts()
    for p, g in zip(params, grads):
        p.grad = g.clone()
    ref._dist_dirty = True
    ref.synchronize()
    _sync(torch, tokens.device.type)
    k3_opt = K.LAUNCHES["quantize_int8_stochastic"]
    reduced_opt = [p.grad for p in params]
    K.reset_launch_counts()
    gfn = hvd.DistributedGradFn(lambda: grads, compression="int8_ef")
    reduced, ef = gfn()
    _sync(torch, tokens.device.type)
    k3_fn = K.LAUNCHES["quantize_int8_stochastic"]
    equal = all(bits_equal(torch, a, b)
                for a, b in zip(reduced, reduced_opt))
    check(equal and k3_fn == k3_opt > 0 and ef.step == 1,
          f"DistributedGradFn: reduced bitwise {equal}, K3 {k3_fn} vs the "
          f"optimizer's {k3_opt}, EF step {ef.step}")
    model.zero_grad()
    del grads, reduced, reduced_opt, ref, gfn
    return {"bitwise_equal": equal, "quantize_int8_stochastic": k3_fn,
            "int8_buckets": len(ef.residual)}


def sync_bn_check(torch, hvd, rank: int) -> dict:
    """``SyncBatchNorm`` over the ranks' own batches on the card against
    a ``BatchNorm2d`` over the concatenated batch (gathered): this rank's
    output and input gradient, and the running statistics."""
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    x = torch.randn(SBN_SHAPE, generator=gen, device="cuda") * 2 + 0.5
    cot = torch.randn(SBN_SHAPE, generator=gen, device="cuda")
    x.requires_grad_(True)
    sbn = hvd.SyncBatchNorm(SBN_SHAPE[1]).to(x.device)
    y = sbn(x)
    (y * cot).sum().backward()
    every_x = hvd.allgather(x.detach(), name="sbn.x")
    every_cot = hvd.allgather(cot, name="sbn.cot")
    ref_x = every_x.clone().requires_grad_(True)
    bn = torch.nn.BatchNorm2d(SBN_SHAPE[1]).to(x.device)
    ref_y = bn(ref_x)
    (ref_y * every_cot).sum().backward()
    rows = slice(rank * SBN_SHAPE[0], (rank + 1) * SBN_SHAPE[0])
    errs = {}
    for what, got, want in (
            ("y", y, ref_y[rows]), ("dx", x.grad, ref_x.grad[rows]),
            ("running_mean", sbn.running_mean, bn.running_mean),
            ("running_var", sbn.running_var, bn.running_var)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        check(err <= SBN_RTOL, f"SyncBatchNorm {what}: off BatchNorm of "
                               f"the whole batch by {err} > {SBN_RTOL}")
        errs[what] = err
    return {"shape_per_rank": list(SBN_SHAPE), "rel_err": errs,
            "limit": SBN_RTOL}


#: What a zygote imports before it forks: torch and ``torch._dynamo``
#: (the first ``torch.optim`` call imports it), ≈ 12 s of every rank
#: worker's start on the H100's host even from the bytecode cache. No
#: module of the port: those read their environment at import, and each
#: world sets its own.
ZYGOTE_PRELOAD = ("torch", "torch._dynamo")
#: The environment variable that tells a ``--via-zygote`` process where
#: this run's zygote listens (an abstract socket name, ``@`` for NUL).
ZYGOTE_ENV = "CHIP_SMOKE_ZYGOTE"
#: The signals a ``--via-zygote`` process passes on to its worker.
FORWARDED_SIGNALS = ("SIGTERM", "SIGINT", "SIGHUP", "SIGQUIT", "SIGUSR1",
                     "SIGUSR2")


def _zygote_child(run, req: dict, fds=(None, None, None)) -> None:
    """In a fresh fork of the zygote: take the request's environment,
    directory and standard streams (``fds``, else ``/dev/null`` in and
    ``req["log"]`` out), run ``run(argv)`` and never return. With a
    ``log``, the exit code goes to ``log + ".rc"``."""
    import atexit
    import random
    import signal
    import traceback

    rc = 1
    try:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        random.seed()
        os.chdir(req["cwd"])
        os.environ.clear()
        os.environ.update(req["env"])
        for entry in reversed(req["env"].get("PYTHONPATH", "").split(
                os.pathsep)):
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)
        sys.argv = [os.path.abspath(__file__), *req["argv"]]
        if fds[0] is None:
            fds = (os.open(os.devnull, os.O_RDONLY),
                   *[os.open(req["log"], os.O_WRONLY | os.O_CREAT
                             | os.O_TRUNC)] * 2)
        for target, fd in enumerate(fds):
            os.dup2(fd, target)
        for fd in set(fds):
            if fd > 2:
                os.close(fd)
        for stream in (sys.stdout, sys.stderr):
            stream.reconfigure(line_buffering=True)
        try:
            rc = run(req["argv"]) or 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except BaseException:
            traceback.print_exc()
        atexit._run_exitfuncs()
    finally:
        # Whatever happens, the child never returns into the zygote.
        try:
            sys.stdout.flush()
            sys.stderr.flush()
            if req.get("log"):
                with open(req["log"] + ".rc.tmp", "w") as f:
                    f.write(str(rc))
                os.replace(req["log"] + ".rc.tmp", req["log"] + ".rc")
        finally:
            os._exit(rc)


def _zygote_exec(run, conn, listener) -> None:
    """Serve one ``--via-zygote`` process on ``conn``: fork a monitor,
    which forks the worker on the process's own streams, sends back its
    pid, then its wait status when it ends — or kills it when the
    process is gone (the launcher killed it)."""
    import select
    import signal
    import struct

    head, fds, _, _ = socket.recv_fds(conn, 4, 3)
    (size,) = struct.unpack(">I", head)
    payload = b""
    while len(payload) < size:
        chunk = conn.recv(size - len(payload))
        if not chunk:
            break
        payload += chunk
    if len(fds) != 3 or len(payload) != size:
        for fd in fds:
            os.close(fd)
        conn.close()
        return
    if os.fork():
        conn.close()
        for fd in fds:
            os.close(fd)
        return
    try:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        listener.close()
        req = json.loads(payload)
        worker = os.fork()
        if not worker:
            conn.close()
            _zygote_child(run, req, tuple(fds))
        for fd in fds:
            os.close(fd)
        conn.sendall(json.dumps({"pid": worker}).encode() + b"\n")
        while True:
            done, status = os.waitpid(worker, os.WNOHANG)
            if done:
                conn.sendall(json.dumps({"status": status}).encode()
                             + b"\n")
                break
            if select.select([conn], [], [], 0.05)[0] and not conn.recv(64):
                os.kill(worker, signal.SIGKILL)
                os.waitpid(worker, 0)
                break
    finally:
        os._exit(0)


def zygote_main(run, address=None) -> None:
    """``--zygote [ADDRESS]``: import ``ZYGOTE_PRELOAD``, print ``ready``,
    then fork one child per JSON request line on stdin (``argv``,
    ``env``, ``cwd``, ``log``) and print its pid; the child runs
    ``run(argv)`` with its output in ``log`` and its exit code in
    ``log + ".rc"``. On the abstract unix socket ``ADDRESS`` it serves
    ``--via-zygote`` processes (:func:`via_zygote`). Children of stdin
    requests are reaped by the kernel (SIGCHLD ignored); the zygote never
    touches the card, so each child makes its own CUDA context."""
    import importlib
    import selectors
    import signal

    for name in ZYGOTE_PRELOAD:
        importlib.import_module(name)
    torch = sys.modules["torch"]
    check(not torch.cuda.is_initialized(), "zygote: CUDA initialized")
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    sel = selectors.DefaultSelector()
    sel.register(0, selectors.EVENT_READ, "stdin")
    listener = None
    if address:
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        listener.bind(address.replace("@", "\0", 1))
        listener.listen(64)
        sel.register(listener, selectors.EVENT_READ, "exec")
    print("ready", flush=True)
    pending = b""
    while True:
        for key, _ in sel.select():
            if key.data == "exec":
                conn, _ = listener.accept()
                try:
                    _zygote_exec(run, conn, listener)
                except OSError:
                    conn.close()
                continue
            chunk = os.read(0, 1 << 16)
            if not chunk:
                return
            pending += chunk
            while b"\n" in pending:
                line, pending = pending.split(b"\n", 1)
                req = json.loads(line)
                sys.stdout.flush()
                sys.stderr.flush()
                pid = os.fork()
                if not pid:
                    if listener is not None:
                        listener.close()
                    _zygote_child(run, req)
                print(json.dumps({"pid": pid}), flush=True)


def via_zygote(argv) -> int:
    """``--via-zygote ARGV``: run this script's ``main(ARGV)`` as a fork of
    the zygote named in ``ZYGOTE_ENV`` (torch already imported), on this
    process's environment, directory and standard streams; pass the
    signals of ``FORWARDED_SIGNALS`` on, end with the worker's exit
    code or signal, and take the worker down when killed. Without a
    zygote, run ``main(ARGV)`` here. A launcher runs its workers through
    this, so they start in ≈ 1 s instead of re-importing torch."""
    import signal
    import struct

    child, queued = [], []

    def forward(signum, frame):
        if child:
            with contextlib.suppress(ProcessLookupError):
                os.kill(child[0], signum)
        else:
            queued.append(signum)

    signums = [getattr(signal, name) for name in FORWARDED_SIGNALS]
    previous = {s: signal.signal(s, forward) for s in signums}
    address = os.environ.get(ZYGOTE_ENV)
    reply = None
    if address:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(address.replace("@", "\0", 1))
            payload = json.dumps({"argv": list(argv), "cwd": os.getcwd(),
                                  "env": dict(os.environ)}).encode()
            socket.send_fds(sock, [struct.pack(">I", len(payload))],
                            [0, 1, 2])
            sock.sendall(payload)
            reply = sock.makefile("rb")
            child.append(json.loads(reply.readline())["pid"])
        except (OSError, ValueError):
            reply = None
    if reply is None:
        for s in signums:
            signal.signal(s, previous[s])
        for s in queued:
            os.kill(os.getpid(), s)
        return main(list(argv))
    for s in queued:
        forward(s, None)
    line = reply.readline()
    if not line:
        return 1
    status = json.loads(line)["status"]
    if os.WIFSIGNALED(status):
        sig = os.WTERMSIG(status)
        if sig in signums:
            signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)
    return os.waitstatus_to_exitcode(status)


def worker_argv(*args) -> list:
    """The command line of one of this script's workers that a launcher
    (or a plain ``Popen``) starts: through :func:`via_zygote`."""
    return [sys.executable, os.path.abspath(__file__), "--via-zygote",
            *args]


def launcher_argv(*args) -> list:
    """``python -m horovod_tpu_torch.runner.launch ARGS`` through
    :func:`via_zygote` (``--module``): the launcher imports torch too."""
    return worker_argv("--module", "horovod_tpu_torch.runner.launch", *args)


class Zygote:
    """A ``--zygote`` process of this script: ``spawn`` forks a child
    that runs this script's ``main(argv)`` with torch already imported,
    so a rank worker starts without re-importing it. Its socket's name is
    exported in ``ZYGOTE_ENV`` for the ``--via-zygote`` processes of the
    launchers this script starts."""

    def __init__(self):
        import secrets

        self.address = (f"@chip-smoke-zygote-{os.getpid()}-"
                        f"{secrets.token_hex(4)}")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zygote",
             self.address],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.ready = False

    def wait_ready(self) -> None:
        """Block until the zygote has imported ``ZYGOTE_PRELOAD``."""
        if not self.ready:
            line = self.proc.stdout.readline().strip()
            if line != "ready":
                self.close()
                raise SmokeError(f"zygote did not start (said {line!r})")
            self.ready = True
            os.environ[ZYGOTE_ENV] = self.address

    def spawn(self, argv, env: dict, log: str) -> int:
        """Fork a child running ``main(argv)`` under ``env`` with its
        output in ``log``; returns its pid (its exit code lands in
        ``log + ".rc"``)."""
        self.wait_ready()
        for path in (log, log + ".rc"):
            if os.path.exists(path):
                os.remove(path)
        self.proc.stdin.write(json.dumps(
            {"argv": list(argv), "env": env, "cwd": os.getcwd(),
             "log": os.path.abspath(log)}) + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())["pid"]

    def close(self) -> None:
        if os.environ.get(ZYGOTE_ENV) == self.address:
            del os.environ[ZYGOTE_ENV]
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


_ZYGOTE = []


def zygote() -> Zygote:
    """This process's zygote, started at the first call."""
    if not _ZYGOTE or _ZYGOTE[0].proc.poll() is not None:
        _ZYGOTE[:] = [Zygote()]
    return _ZYGOTE[0]


def close_zygote() -> None:
    while _ZYGOTE:
        _ZYGOTE.pop().close()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _await_forked(pids, logs, t0: float, timeout: float, what: str):
    """Wait for the zygote's children ``pids`` (output in ``logs``) until
    each has written its exit code or is gone, killing them all past
    ``timeout`` s from ``t0``; returns each one's output and exit code
    (None without one) and removes the logs."""
    try:
        # A child is done once its exit code is written or it is gone.
        while any(_alive(pid) and not os.path.exists(log + ".rc")
                  for pid, log in zip(pids, logs)):
            if time.perf_counter() - t0 > timeout:
                raise SmokeError(f"{what}: a worker passed its {timeout} s "
                                 f"limit")
            time.sleep(0.1)
    finally:
        for pid in pids:
            if _alive(pid):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, 9)
        while any(_alive(pid) for pid in pids):
            time.sleep(0.05)
    texts, rcs = [], []
    for log in logs:
        with open(log, errors="replace") as f:
            texts.append(f.read())
        rc = None
        if os.path.exists(log + ".rc"):
            with open(log + ".rc") as f:
                rc = int(f.read())
            os.remove(log + ".rc")
        os.remove(log)
        rcs.append(rc)
    return texts, rcs


def run_workers(config: str, n: int, timeout: float, out_dir: str,
                env_extra=None):
    """Run this script's ``--rank-worker`` ``config`` as n rank processes
    on the one card, forked by the zygote, each with
    HVD_TPU_COORDINATOR/NUM_PROC/PROC_ID (and ``env_extra``); any
    worker's failure or overrun fails the phase. Returns each rank's JSON
    record and the wall seconds; the logs go to
    ``multirank_<config>.log``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC=str(n), **(env_extra or {}))
    paths = [os.path.join(out_dir, f"multirank_{config}_rank{r}.json")
             for r in range(n)]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    rank_logs = [os.path.join(out_dir, f"multirank_{config}_rank{r}.out")
                 for r in range(n)]
    t0 = time.perf_counter()
    zy = zygote()
    pids = [zy.spawn(["--rank-worker", config, str(r), paths[r]],
                     dict(env, HVD_TPU_PROC_ID=str(r)), rank_logs[r])
            for r in range(n)]
    logs, rcs = _await_forked(pids, rank_logs, t0, timeout,
                              f"multi-rank {config}")
    with open(os.path.join(out_dir, f"multirank_{config}.log"), "w") as f:
        f.write("\n".join(f"--- rank {r}\n{log}"
                          for r, log in enumerate(logs)))
    for r, rc in enumerate(rcs):
        check(rc == 0,
              f"multi-rank {config}: rank {r} exited "
              f"{'without an exit code' if rc is None else rc}:\n"
              f"{logs[r][-3000:]}")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def run_forked(argv, name: str, timeout: float, out_dir: str) -> dict:
    """Run this script's ``main(argv + [OUT])`` in one fork of the zygote
    (torch imported, no CUDA context), its output in ``<name>.log``;
    returns the JSON it wrote to OUT (``<name>.json``) with its wall
    seconds as ``wall_s``. Its failure or overrun fails the phase."""
    path = os.path.join(out_dir, f"{name}.json")
    log = os.path.join(out_dir, f"{name}.out")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    pid = zygote().spawn([*argv, path], dict(os.environ), log)
    (text,), (rc,) = _await_forked([pid], [log], t0, timeout, name)
    with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
        f.write(text)
    check(rc == 0, f"{name}: exited "
                   f"{'without an exit code' if rc is None else rc}:\n"
                   f"{text[-3000:]}")
    with open(path) as f:
        rec = json.load(f)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def phase_multirank(torch, out_dir: str) -> dict:
    """Run the n rank workers of each multi-rank reduction config on the
    one card."""
    results = {}
    for config, (n, model_name, batch, seq, timeout) in MULTI_CONFIGS.items():
        ranks, wall = run_workers(config, n, timeout, out_dir)
        res = {"n": n, "model": model_name, "batch_per_rank": batch,
               "seq_len": seq, "backend": ranks[0]["backend"],
               "wall_s": wall, "modes": {}}
        for mode in ("int8_ef", "adasum"):
            recs = [rk["modes"][mode] for rk in ranks]
            check(all(rc["launches"] == recs[0]["launches"] for rc in recs),
                  f"{config} {mode}: ranks counted different launches")
            step_ms = statistics.median(
                statistics.median(rc["step_ms"]) for rc in recs)
            res["modes"][mode] = {
                "step_ms_median": step_ms,
                "fwd_bwd_ms_median": recs[0]["fwd_bwd_ms_median"],
                "step_call_ms_median": recs[0]["step_call_ms_median"],
                "wire_ms_median": recs[0]["wire_ms_median"],
                "tokens_per_s": n * batch * seq / (step_ms / 1e3),
                "losses_rank0": recs[0]["losses"],
                "launches": recs[0]["launches"],
                "bytes_per_step_per_rank": recs[0]["bytes"],
                "peak_mem_gib_rank0": recs[0]["peak_mem_gib"],
                "check": recs[0].get("bound_check")
                or recs[0].get("reference_check"),
                "ranks": recs,
            }
            m = res["modes"][mode]
            print(f"multi-rank {config} {mode} ({res['backend']}, {n} "
                  f"processes on one card): step {step_ms:.1f} ms "
                  f"= {m['tokens_per_s']:.0f} tok/s (rank 0: forward + "
                  f"backward {m['fwd_bwd_ms_median']:.1f} ms, step() "
                  f"{m['step_call_ms_median']:.1f} ms of which collectives "
                  f"{m['wire_ms_median']:.1f} ms); wire "
                  f"{m['bytes_per_step_per_rank']['wire'] / 1e6:.1f} MB/step "
                  f"per rank (fp32 ring "
                  f"{m['bytes_per_step_per_rank']['fp32_ring'] / 1e6:.1f}); "
                  f"check {json.dumps(m['check'])}; launches "
                  f"{json.dumps(m['launches'])}", flush=True)
        if "adasum_int8_wire" in ranks[0]:
            res["adasum_int8_wire"] = ranks[0]["adasum_int8_wire"]
        if "guard_drill" in ranks[0]:
            res["guard_drill"] = [rk["guard_drill"] for rk in ranks]
            res["divergence_drill"] = [rk["divergence_drill"]
                                       for rk in ranks]
            print(f"multi-rank {config} guard drill (int8_ef, skip_step, NaN "
                  f"on rank {GUARD_BAD[1]} at step {GUARD_BAD[0]}): "
                  f"{json.dumps([rk['guard_drill']['steps'] for rk in ranks][0])}"
                  f"; agreements "
                  f"{[rk['guard_drill']['guard_agreements'] for rk in ranks]}",
                  flush=True)
            print(f"multi-rank {config} divergence drill (rank "
                  f"{DIVERGE_RANK} perturbed, resync): "
                  f"{json.dumps(res['divergence_drill'])}", flush=True)
        if "sync_batch_norm" in ranks[0]:
            res["sync_batch_norm"] = [rk["sync_batch_norm"] for rk in ranks]
            print(f"multi-rank {config} SyncBatchNorm ({n} ranks, "
                  f"{SBN_SHAPE} each) vs BatchNorm2d of the whole batch: "
                  f"rel err {json.dumps(res['sync_batch_norm'])}", flush=True)
        results[config] = res
    with open(os.path.join(out_dir, "chip_smoke_multirank.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


# -- phase 7b: mesh routing over a simulated 2x2 mesh ------------------------

MESH_CONFIG = "n4_mesh"
# n, model, per-rank batch, sequence length, worker timeout (s)
MESH_RUN = (4, "gpt_medium", 4, 512, 900)
# The routed training runs' depth: GPT-2 medium's widths at 8 of its 24
# layers (with 7c's and 9 (b)'s, the cut that keeps phases 12 and 13
# under the smoke's time limit: 24 layers here and in 7d would add about
# 86 s; the role-aware elastic slice names this cut and keeps it, since
# K8/K9 run at 24 layers in phase 7a and K5-K7 in phases 11 and 12;
# PERF.md §4). The eager, process-set and exchange sections keep their
# shapes.
MESH_LAYERS = 8
MESH_SHAPE = "2x2"                  # cross x local: local {0,1},{2,3}
MESH_TIMED = 3                      # timed steps after the checked one
MESH_SETS = ((0, 2), (1, 3))
MESH_ZERO_ROUTE = "local:none,cross:int8"  # K3 on the cross hop only
MESH_TOK_EMB_RTOL = 1e-6            # eager hierarchical vs fp64, of sum |x|
TINY_STEPS = 2


def _mesh_bytes(C, plan, ns, items, n) -> dict:
    """Bytes one rank puts on each axis a step, from ``mesh_wire_cost``
    over the padded length each routed reduction sends, beside a flat
    fp32 ring allreduce of the same elements. ``items``: (elements,
    plan, op, itemsize, grid) per reduction."""
    axes = {p.axis: 0.0 for p in plan.phases}
    ring = 0.0
    for elems, p, op, itemsize, grid in items:
        padded = -(-elems // grid) * grid
        cost = C.mesh_wire_cost(p, padded, ns, op, itemsize)
        for a in axes:
            axes[a] += cost[a]["bytes"]
        ring += 2 * (n - 1) / n * 4 * elems
    return {"per_axis": axes, "flat_fp32_ring": ring}


def _mesh_opt_bytes(C, opt, plan, ns, n) -> dict:
    """Per-axis bytes of one routed int8_ef step: int8 buckets take the
    plan (4096-element blocks a rank), small float buckets ride it in
    bf16 with wires none, others native."""
    items = []
    for b, w in zip(opt._dist_plan.buckets, opt._dist_plan.wire_dtypes):
        if w == "int8":
            items.append((b.total_elems, plan, C.Sum, 4, n * 4096))
        else:
            items.append((b.total_elems, plan.with_wires("none"), C.Sum,
                          2 if w == "bf16" else 4, n))
    return _mesh_bytes(C, plan, ns, items, n)


def _mesh_probe(C, target: int):
    """Records the input and output of the ``target``-th
    ``mesh_allreduce`` call of one step (the Adasum optimizer calls it
    once a parameter, in order). Returns (record, restore)."""
    orig = C.mesh_allreduce
    seen = {"calls": 0}

    def probe(x, *a, **k):
        y = orig(x, *a, **k)
        if seen["calls"] == target:
            seen["delta"], seen["reduced"] = x.clone(), y.clone()
        seen["calls"] += 1
        return y

    C.mesh_allreduce = probe

    def restore():
        C.mesh_allreduce = orig
    return seen, restore


def _block_scales(torch, v, pad):
    """Per-4096-block absmax / 127 of a flat tensor zero-padded by
    ``pad``."""
    return torch.nn.functional.pad(v.abs(), (0, pad)).reshape(
        -1, 4096).amax(1) / 127


def _mesh_train(torch, hvd, gpt_mod, C, K, fusion, mode, rank, n):
    """One routed training mode of GPT-2 medium: the checked step and the
    timed steps, with the launch counts zeroed just before the timed
    steps and read just after."""
    _, model_name, batch, seq, _ = MESH_RUN
    plan = C.WirePlan.resolve("staged_int8" if mode == "int8_ef"
                              else "staged")
    ns = [C._axis(p.axis).size for p in plan.phases]
    model = integrity_model(torch, gpt_mod, "cuda", layers=MESH_LAYERS) \
        if model_name == "gpt_medium" else \
        _make_model(torch, gpt_mod, model_name)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               21 + rank)).to("cuda")
    kw = {"compression": "int8_ef", "route": "staged_int8"} \
        if mode == "int8_ef" else {"op": hvd.Adasum, "route": "staged"}
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), **kw)
    check(opt._route == plan, f"mesh {mode}: route {opt._route}")
    rec = {"plan": plan.describe(), "params": len(params)}

    def forward_backward():
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        return loss

    torch.cuda.reset_peak_memory_stats()
    loss = forward_backward()
    if mode == "int8_ef":
        dplan = opt._dist_plan
        bi = dplan.wire_dtypes.index("int8")
        bucket = dplan.buckets[bi]
        local = fusion.fuse_bucket(
            {i: opt._dist_params[i].grad for i in bucket.leaf_indices},
            bucket).float()
        every = C.all_gather_stack(local).double()
        pad = (-local.numel()) % 4096
        # The cross hop quantizes each host's local sum: its block
        # scales bound the contributions' rounding.
        s_cross = sum(_block_scales(torch, every[c * 2] + every[c * 2 + 1],
                                    pad) for c in range(2))
        exact = every.mean(0)
        del every
        opt.step()
        rec["bound_check"] = _ef_bound_check(torch, fusion, opt, bi, exact,
                                             s_cross, n)
        del exact, s_cross, local
        rec["int8_buckets"] = dplan.wire_dtypes.count("int8")
        rec["buckets"] = len(dplan.buckets)
        rec["bytes"] = _mesh_opt_bytes(C, opt, plan, ns, n)
        rec["int8_hops_per_bucket"] = 2   # the cross hop's RS and AG
    else:
        target = max(range(len(params)),
                     key=lambda i: (params[i].numel() <= 4_194_304,
                                    params[i].numel()))
        seen, restore = _mesh_probe(C, target)
        try:
            opt.step()
        finally:
            restore()
        deltas = C.all_gather_stack(seen["delta"]).double().cpu().numpy()
        from horovod_tpu_torch.ops import adasum as adasum_mod

        ref = adasum_mod.adasum_allreduce_reference(
            [deltas[0:2].mean(0), deltas[2:4].mean(0)])
        got = seen["reduced"].double().cpu().numpy()
        err, scale = float(abs(got - ref).max()), float(abs(ref).max())
        check(err <= ADASUM_REF_RTOL * scale,
              f"mesh adasum: parameter {target} reduced delta off the fp64 "
              f"reference over the local averages by {err} > "
              f"{ADASUM_REF_RTOL} x {scale}")
        rec["reference_check"] = {"param": target, "elements": int(got.size),
                                  "max_err": err, "max_abs_ref": scale,
                                  "rel": err / scale}
        rec["bytes"] = _mesh_bytes(C, plan, ns, [
            (p.numel(), plan, C.Adasum, 4, n) for p in params], n)
    losses = [loss.item()]
    every = C.all_gather_stack(digest(params))
    check(bool((every == every[0]).all()),
          f"mesh {mode}: replicas differ after the checked step")
    torch.cuda.synchronize()
    hvd.barrier()
    K.reset_launch_counts()
    times, equal = [], []
    for _ in range(MESH_TIMED):
        t0 = time.perf_counter()
        loss = forward_backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        every = C.all_gather_stack(digest(params))
        equal.append(bool((every == every[0]).all()))
    launches = dict(K.LAUNCHES)
    check(all(map(math.isfinite, losses)),
          f"mesh {mode}: non-finite loss in {losses}")
    check(all(equal), f"mesh {mode}: replicas differ after timed step(s) "
                      f"{[i for i, e in enumerate(equal) if not e]}")
    flash = model.num_layers * MESH_TIMED
    want = {k: 0 for k in launches}
    want.update(flash_fwd=flash, flash_bwd_dq=flash, flash_bwd_dkv=flash)
    if mode == "int8_ef":
        want["quantize_int8_stochastic"] = \
            rec["int8_hops_per_bucket"] * rec["int8_buckets"] * MESH_TIMED
        res = list(opt._ef_residual.values())
        check(all(bool(torch.isfinite(r).all()) for r in res),
              "mesh int8_ef: non-finite residual")
        rec["residual_norm"] = hvd.observe_ef_residual(opt)
        check(rec["residual_norm"] > 0, "mesh int8_ef: residual is zero")
    else:
        levels = ns[-1].bit_length() - 1
        want["adasum_dot_norms"] = len(params) * levels * MESH_TIMED
        want["adasum_combine"] = len(params) * levels * MESH_TIMED
    check(launches == want, f"mesh {mode}: launches {launches}, expected "
                            f"{want}")
    rec.update({"losses": losses, "step_ms": [t * 1e3 for t in times],
                "step_ms_median": statistics.median(times) * 1e3,
                "launches": launches, "replicas_equal": equal,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if hasattr(opt, "_dist_hooks"):
        release(torch, opt, "cuda")
    del opt, model, params, digest
    torch.cuda.empty_cache()
    return rec


def _counted(torch, K, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after; returns (its result, the counts)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(K.LAUNCHES)


def _expect(launches, what, **want):
    full = {k: 0 for k in launches}
    full.update(want)
    check(launches == full, f"{what}: launches {launches}, expected {full}")


def _mesh_eager(torch, hvd, C, K, rank, n) -> dict:
    """(c): ``init(hierarchical_allreduce=True)``'s allreduce with pre- and
    postscale on ``tok_emb``'s shape, a direct
    ``quantized_hierarchical_allreduce`` and the hierarchical
    allgather."""
    def emb(r):
        return torch.randn(TOK_EMB, generator=torch.Generator(
            device="cuda").manual_seed(700 + r), device="cuda")

    rec, x = {}, emb(rank)
    y, rec["allreduce_launches"] = _counted(torch, K, lambda: hvd.allreduce(
        x, op=hvd.Sum, name="mesh.tok_emb", prescale_factor=1 / 3,
        postscale_factor=1.5))
    _expect(rec["allreduce_launches"], "hierarchical allreduce",
            scale_buffer=2)
    digests = C.all_gather_stack(_Digest(torch, [y])([y]))
    check(bool((digests == digests[0]).all()),
          "hierarchical allreduce: ranks differ")
    pre = torch.tensor(1 / 3, dtype=torch.float32).item()
    post = torch.tensor(1.5, dtype=torch.float32).item()
    plain = torch.zeros(TOK_EMB, dtype=torch.float64, device="cuda")
    mag = torch.zeros_like(plain)
    for r in range(n):
        xr = emb(r).double()
        plain += xr * pre
        mag += xr.abs()
    plain *= post
    err = (y.double() - plain).abs().max().item()
    limit = MESH_TOK_EMB_RTOL * mag.max().item()
    check(err <= limit, f"hierarchical allreduce: off the plain result by "
                        f"{err} > {limit}")
    rec["allreduce_max_err"], rec["allreduce_limit"] = err, limit
    del plain, mag, y
    # dim 0 must divide by the local size: tok_emb's 50257 rows flat.
    q, rec["qhar_launches"] = _counted(
        torch, K, lambda: C.quantized_hierarchical_allreduce(
            x.reshape(-1), C.Sum).reshape(TOK_EMB))
    _expect(rec["qhar_launches"], "quantized_hierarchical_allreduce",
            quantize_int8=2, dequantize_int8=2)
    local = [emb(2 * c) + emb(2 * c + 1) for c in range(2)]
    exact = local[0] + local[1]
    # Round to nearest: half a scale of each host's chunk and of the
    # reduced chunk, bounded by the global absmaxes.
    bound = (sum(v.abs().max() for v in local) + exact.abs().max()).item() \
        / 127
    err = (q - exact).abs().max().item()
    check(err <= bound, f"quantized_hierarchical_allreduce: error {err} "
                        f"> {bound}")
    rec["qhar_max_err"], rec["qhar_bound"] = err, bound
    del q, local, exact
    g = hvd.allgather(x[:4096], name="mesh.ag")
    check(bits_equal(torch, g, C.allgather(x[:4096])),
          "hierarchical allgather: differs from the flat one")
    return rec


def _mesh_sets(torch, hvd, gpt_mod, C, rank) -> dict:
    """(d): process sets evens and odds; set-scoped calls against the
    same reductions by hand (inputs regenerated from their seeds), a
    non-member's call, and gpt_tiny trained per set."""
    sets = [hvd.add_process_set(list(s)) for s in MESH_SETS]
    mine = sets[rank % 2]
    other = sets[1 - rank % 2]
    members = list(mine.ranks)
    width = MOE_TOKENS[1]

    def vec(r):
        return torch.randn((64, width), generator=torch.Generator(
            device="cuda").manual_seed(800 + r), device="cuda")

    xs = {r: vec(r) for r in range(4)}
    got = hvd.allreduce(xs[rank], op=hvd.Sum, name="ps.ar", process_set=mine)
    check(bits_equal(torch, got, xs[members[0]] + xs[members[1]]),
          "process set allreduce: differs")
    got = hvd.allgather(xs[rank], name="ps.ag", process_set=mine)
    check(bits_equal(torch, got, torch.cat([xs[m] for m in members])),
          "process set allgather: differs")
    got = hvd.broadcast(xs[rank], root_rank=members[1], name="ps.bc",
                        process_set=mine)
    check(bits_equal(torch, got, xs[members[1]]),
          "process set broadcast (global root): differs")
    pos = members.index(rank)
    got = hvd.alltoall(xs[rank], name="ps.a2a", process_set=mine)
    check(bits_equal(torch, got, torch.cat(
        [xs[m][pos * 32:(pos + 1) * 32] for m in members])),
        "process set alltoall: differs")
    try:
        hvd.allreduce(xs[rank], name="ps.bad", process_set=other)
        raise SmokeError("process set: a non-member's call did not raise")
    except ValueError:
        pass
    model = _make_model(torch, gpt_mod, "gpt_tiny")
    tokens = torch.randint(0, 128, (8, 129), generator=torch.Generator()
                           .manual_seed(31 + rank)).to("cuda")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters(), process_set=mine)
    params = list(model.parameters())
    losses = []
    for _ in range(TINY_STEPS):
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    check(all(map(math.isfinite, losses)), f"process set: losses {losses}")
    every = C.all_gather_stack(_Digest(torch, params)(params))
    for s in MESH_SETS:
        check(bool((every[s[0]] == every[s[1]]).all()),
              f"process set {list(s)}: replicas differ")
    check(not bool((every[0] == every[1]).all()),
          "process sets: the two sets trained to the same weights")
    release(torch, opt, "cuda")
    return {"sets": [list(s) for s in MESH_SETS], "tiny_losses": losses,
            "bitwise": True}


def _mesh_exchanges(torch, hvd, C, K, rank, n) -> dict:
    """(e): the chunked uneven alltoall of MoE-shaped tokens on each wire
    against the plain exchange, and ``wired_ppermute`` over the local
    axis on the int8 wire, forward and backward."""
    rows, width = MOE_TOKENS
    splits = torch.randint(64, 512, (n, n), generator=torch.Generator()
                           .manual_seed(19)).tolist()
    splits[0][1] = rows - sum(splits[0]) + splits[0][1]   # skewed: one
    rec = {"splits": splits}                            # row sums to 4096

    def tokens(r):
        return torch.randn((sum(splits[r]), width), generator=torch.Generator(
            device="cuda").manual_seed(900 + r), device="cuda").to(
                torch.bfloat16)

    xs = [tokens(r) for r in range(n)]
    segs = [xs[s][sum(splits[s][:rank]):sum(splits[s][:rank + 1])]
            for s in range(n)]
    want = torch.cat(segs)
    for wire in ("none", "bf16", "int8"):
        got, launches = _counted(torch, K, lambda: hvd.alltoall(
            xs[rank], name=f"mesh.a2a.{wire}", splits=splits[rank],
            chunked=True, wire=None if wire == "none" else wire))
        if wire == "int8":
            _expect(launches, "chunked alltoall int8", quantize_int8=n - 1,
                    dequantize_int8=n - 1)
            rec["int8_launches"] = launches
            # Half a block scale of each hop's chunk, then the bf16
            # rounding of the output.
            lim = torch.cat([torch.full((s.shape[0], 1), s.float().abs().max()
                                        .item() / 254, device="cuda")
                             for s in segs])
            err = (got.float() - want.float()).abs()
            check(bool((err <= lim + want.float().abs() * 2 ** -8).all()),
                  "chunked alltoall int8: off the exchange by more than "
                  "half a block scale")
            rec["int8_max_abs_err"] = err.max().item()
        else:
            _expect(launches, f"chunked alltoall {wire}")
            check(bits_equal(torch, got, want),
                  f"chunked alltoall {wire}: differs")
    local = C._axis("local")
    shift = [(i, (i + 1) % local.size) for i in range(local.size)]
    src_pos = (local.index - 1) % local.size
    dst_pos = (local.index + 1) % local.size

    def act(r, seed):
        return torch.randn(MOE_TOKENS, generator=torch.Generator(
            device="cuda").manual_seed(seed + r), device="cuda")

    x = act(rank, 1000).requires_grad_(True)
    cot = act(rank, 1100)

    def run():
        y = C.wired_ppermute(x, "local", shift, "int8")
        (y * cot).sum().backward()
        return y.detach()

    y, launches = _counted(torch, K, run)
    _expect(launches, "wired_ppermute int8", quantize_int8=2,
            dequantize_int8=2)
    rec["ppermute_launches"] = launches
    want_y = act(local.ranks[src_pos], 1000)
    want_g = act(local.ranks[dst_pos], 1100)
    for what, got, exact in (("forward", y, want_y),
                             ("backward", x.grad, want_g)):
        err = (got - exact).abs().max().item()
        lim = exact.abs().max().item() / 254
        check(err <= lim, f"wired_ppermute int8 {what}: error {err} > half "
                          f"a block scale {lim}")
        rec[f"ppermute_{what}_max_err"] = err
    return rec


def mesh_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of phase 7b (``--rank-worker n4_mesh``), launched with
    ``HVD_TPU_MESH_SHAPE=2x2``: the two routed training modes, the eager
    hierarchical calls, process sets and the wired exchanges; every
    section's launch counts zeroed just before it and read just after."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import fusion
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, model_name, batch, seq, _ = MESH_RUN
    ctx = hvd.init(backend="gloo", hierarchical_allreduce=True,
                   hierarchical_allgather=True)
    axes = {a.name: (a.size, list(a.ranks)) for a in ctx.axes.values()}
    check(hvd.size() == n and hvd.rank() == rank and ctx.hier_axes()
          and axes["local"][0] == 2 and axes["cross"][0] == 2
          and axes["local"][1] == [2 * (rank // 2), 2 * (rank // 2) + 1],
          f"mesh: rank {rank} axes {axes}")
    out = {"config": config, "rank": rank, "model": model_name,
           "batch": batch, "seq_len": seq, "backend": ctx.backend,
           "axes": axes, "modes": {}}
    for mode in ("int8_ef", "adasum"):
        out["modes"][mode] = rec = _mesh_train(torch, hvd, gpt_mod, C, K,
                                               fusion, mode, rank, n)
        print(f"rank {rank} {mode}: step ms {rec['step_ms']}, launches "
              f"{rec['launches']}", flush=True)
    from horovod_tpu_torch.common import metrics

    out["zero"] = rec = _zero_train(
        torch, hvd, gpt_mod, C, K, metrics, "mesh_z3", 3,
        {"compression": "int8_ef"}, rank, n, "cuda", route=MESH_ZERO_ROUTE,
        layers=MESH_LAYERS if MESH_RUN[1] == "gpt_medium" else None)
    print(f"rank {rank} zero stage 3 ({MESH_ZERO_ROUTE}, int8_ef): step ms "
          f"{rec['step_ms']}, launches {rec['launches']}", flush=True)
    out["eager"] = _mesh_eager(torch, hvd, C, K, rank, n)
    print(f"rank {rank} eager: {out['eager']}", flush=True)
    out["process_sets"] = _mesh_sets(torch, hvd, gpt_mod, C, rank)
    out["exchanges"] = _mesh_exchanges(torch, hvd, C, K, rank, n)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_mesh(torch, out_dir: str) -> dict:
    """Phase 7b: the four rank workers of the 2x2 mesh on the one card.
    Returns the phase's record with ``launches``, the mesh path's counts
    summed over its counted sections."""
    n, model_name, batch, seq, timeout = MESH_RUN
    os.makedirs(out_dir, exist_ok=True)
    ranks, wall = run_workers(MESH_CONFIG, n, timeout, out_dir,
                              {"HVD_TPU_MESH_SHAPE": MESH_SHAPE})
    r0 = ranks[0]
    res = {"n": n, "mesh_shape": MESH_SHAPE, "model": model_name,
           "batch_per_rank": batch, "seq_len": seq, "wall_s": wall,
           "label": "gloo, 4 processes on one card (not NCCL or NVLink)",
           "modes": {}}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for mode in ("int8_ef", "adasum"):
        recs = [rk["modes"][mode] for rk in ranks]
        check(all(rc["launches"] == recs[0]["launches"] for rc in recs),
              f"mesh {mode}: ranks counted different launches")
        step_ms = statistics.median(
            statistics.median(rc["step_ms"]) for rc in recs)
        m = res["modes"][mode] = {
            "plan": recs[0]["plan"], "step_ms_median": step_ms,
            "step_ms_rank0": recs[0]["step_ms"],
            "tokens_per_s": n * batch * seq / (step_ms / 1e3),
            "losses_rank0": recs[0]["losses"],
            "launches": recs[0]["launches"],
            "bytes_per_step_per_rank": recs[0]["bytes"],
            "peak_mem_gib": max(rc["peak_mem_gib"] for rc in recs),
            "check": recs[0].get("bound_check")
            or recs[0].get("reference_check")}
        add(m["launches"])
        b = m["bytes_per_step_per_rank"]
        print(f"mesh 2x2 {mode} ({m['plan']}; gloo, 4 processes on one "
              f"card): gpt_medium B={batch} S={seq} per rank, step "
              f"{step_ms:.1f} ms = {m['tokens_per_s']:.0f} tok/s; bytes a "
              f"rank a step: "
              + ", ".join(f"{a} {v / 1e6:.1f} MB" for a, v in
                          b["per_axis"].items())
              + f" (flat fp32 ring {b['flat_fp32_ring'] / 1e6:.1f} MB); "
              f"peak {m['peak_mem_gib']:.2f} GiB; check "
              f"{json.dumps(m['check'])}; launches "
              f"{json.dumps(m['launches'])}", flush=True)
    zrecs = [rk["zero"] for rk in ranks]
    check(all(rc["launches"] == zrecs[0]["launches"] for rc in zrecs),
          "mesh zero: ranks counted different launches")
    z = res["zero"] = {k: zrecs[0][k] for k in (
        "route", "losses", "step_ms", "step_ms_median", "launches",
        "buckets", "int8_check", "zero_bytes", "rest_mem_gib")}
    z["peak_mem_gib"] = max(rc["peak_mem_gib"] for rc in zrecs)
    add(z["launches"])
    print(f"mesh 2x2 ZeroOptimizer(zero_stage=3, route={MESH_ZERO_ROUTE}, "
          f"int8_ef) (gloo, 4 processes on one card): step "
          f"{z['step_ms_median']:.1f} ms, peak {z['peak_mem_gib']:.2f} GiB, "
          f"at rest {z['rest_mem_gib']:.2f} GiB; check "
          f"{json.dumps(z['int8_check'])}; launches "
          f"{json.dumps(z['launches'])}", flush=True)
    res["eager"] = r0["eager"]
    add(r0["eager"]["allreduce_launches"])
    add(r0["eager"]["qhar_launches"])
    res["process_sets"] = r0["process_sets"]
    res["exchanges"] = {k: v for k, v in r0["exchanges"].items()
                        if k != "splits"}
    ex = r0["exchanges"]
    add(ex["int8_launches"])
    add(ex["ppermute_launches"])
    res["launches"] = launches
    print(f"mesh 2x2 eager: hierarchical allreduce of {TOK_EMB} max err "
          f"{res['eager']['allreduce_max_err']:.3g} (limit "
          f"{res['eager']['allreduce_limit']:.3g}), launches "
          f"{json.dumps(res['eager']['allreduce_launches'])}; quantized "
          f"hierarchical max err {res['eager']['qhar_max_err']:.3g} (bound "
          f"{res['eager']['qhar_bound']:.3g}); process sets "
          f"{res['process_sets']['sets']} bitwise, tiny losses "
          f"{res['process_sets']['tiny_losses']}; chunked alltoall int8 max "
          f"err {ex['int8_max_abs_err']:.3g}; wired_ppermute int8 err "
          f"{ex['ppermute_forward_max_err']:.3g} / "
          f"{ex['ppermute_backward_max_err']:.3g}; mesh path launches "
          f"{json.dumps(launches)}", flush=True)
    with open(os.path.join(out_dir, "chip_smoke_mesh.json"), "w") as f:
        json.dump(dict(res, ranks=ranks), f, indent=1)
    return res


# -- phase 7c: ZeRO stages 0-3 over 4 gloo ranks on the card ----------------

ZERO_CONFIG = "n4_zero"
# n, model, per-rank batch, sequence length, worker timeout (s)
ZERO_RUN = (4, "gpt_medium", 4, 512, 900)
# Phase 7c's depth: GPT-2 medium's widths at 2 of its 24 layers (with
# phase 9 (b)'s: 4 made room for phase 12, 2 for phase 13, the role-aware
# elastic slice's named cut). Every check counts from the model and its
# bucket plan.
ZERO_LAYERS = 2
ZERO_TIMED = 3                      # timed steps after the checked one
ZERO_LOSS_RTOL = 1e-3               # each step's loss vs (a)'s: bf16 bound
# label, zero_stage, extra keywords: (a) the replicated baseline, (b)
# stage 1, (c) stage 1 int8_ef, (d) stage 2 accumulating 2 microbatches,
# (e) stage 3 with the loss-scaling guard (and the +Inf drill).
ZERO_CASES = (("a", 0, {}), ("b", 1, {}),
              ("c", 1, {"compression": "int8_ef"}),
              ("d", 2, {"accum_steps": 2}),
              ("e", 3, {"nonfinite_policy": "scale_backoff"}))


def _mem(torch, dev: str) -> tuple:
    """(peak, now) allocated GiB on the card; zeros elsewhere."""
    if dev != "cuda":
        return 0.0, 0.0
    return (torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.memory_allocated() / 2 ** 30)


def _zero_bytes(metrics, name: str = "hvd_tpu_zero_gather_bytes_total",
                labels=("kind", "wire", "axis")) -> dict:
    """A ZeRO metric's samples by their labels joined with ``/``."""
    fam = metrics.registry().snapshot().get(name, {"samples": []})
    return {"/".join(s["labels"][k] for k in labels): s["value"]
            for s in fam["samples"]}


def _reduce_probe(st, target: int):
    """Records bucket ``target``'s local flat, reduced shard and new
    residual the next time ``st.reduce`` takes it. Returns (record,
    restore)."""
    seen = {}
    orig = st.reduce

    def probe(bi, flat, exact=False):
        out = orig(bi, flat, exact)
        if bi == target and not exact and "flat" not in seen:
            seen["flat"] = flat.float().clone()
            seen["shard"], seen["residual"] = out[0].clone(), out[1].clone()
        return out

    st.reduce = probe

    def restore():
        del st.reduce
    return seen, restore


def _int8_rs_check(torch, C, st, seen, groups) -> dict:
    """The quantized reduce-scatter of one bucket at the first step (zero
    residual) against the exact fp32 average of the ranks' flats: within
    ``sum of s / n`` a block (stochastic rounding, r = 1; ``s`` the block
    scales of each quantized addend — a rank's flat, or under a route a
    host's local sum, ``groups`` the ranks a host adds); and the
    residuals summed over the ranks are the exact sum less ``n`` times
    the result (the error-feedback invariant), to fp32 roundoff."""
    n, flat, shard = st.n, seen["flat"], seen["shard"].double()
    size, chunk = flat.numel(), shard.numel()
    start = st.index * chunk
    every = C.all_gather_stack(flat).double()
    want = torch.nn.functional.pad(every.sum(0), (0, n * chunk - size))[
        start:start + chunk] / n
    s = sum(_block_scales(torch, every[g].sum(0), (-size) % 4096)
            for g in groups)
    del every
    bound = torch.nn.functional.pad(s.repeat_interleave(4096) / n,
                                    (0, n * chunk))[start:start + chunk]
    err = (shard - want).abs()
    over = err > bound * (1 + 1e-5) + 1e-7
    check(not bool(over.any()),
          f"zero int8_ef: bucket off the exact average by more than the "
          f"bound at {int(over.sum())} elements")
    rsum = C.all_gather_stack(seen["residual"]).double().sum(0)
    closed = (rsum[start:start + chunk] / n - (want - shard)).abs().max()
    lim = 1e-5 * want.abs().max().item()
    check(closed.item() <= lim, f"zero int8_ef: residual-sum invariant "
                                f"off by {closed.item()} > {lim}")
    return {"elements": size, "shard": chunk, "max_err": err.max().item(),
            "max_bound": bound.max().item(),
            "worst_err_over_bound": (err / bound.clamp_min(1e-30)).max()
            .item(), "residual_invariant_max_err": closed.item()}


def _zero_train(torch, hvd, gpt_mod, C, K, metrics, label, stage, kw,
                rank, n, dev, route=None, layers=None):
    """One ZeRO case of GPT-2 medium (``ZERO_RUN``): the checked step,
    the +Inf drill under ``scale_backoff``, the timed steps with the
    launch counts zeroed just before them and read just after, the
    replicas' digests after every gather, peak and at-rest memory, and
    the ZeRO metrics' bytes of the timed steps."""
    _, model_name, batch, seq, _ = ZERO_RUN
    model = (integrity_model(torch, gpt_mod, dev, layers=layers) if layers
             else _make_model(torch, gpt_mod, model_name, dev))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               31 + rank)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), zero_stage=stage,
        route=route, **kw)
    guard = kw.get("nonfinite_policy") == "scale_backoff"
    rec = {"case": label, "zero_stage": stage, **{k: str(v) for k, v in
                                                  kw.items()},
           "route": route}

    def loss_of(t):
        return gpt_mod.next_token_loss(model(t[:, :-1]), t[:, 1:])

    fn = opt.accumulate(loss_of) if stage == 2 else None

    def step(poison: bool = False) -> float:
        if stage == 3:
            opt.gather_params()
        if fn is not None:
            loss = fn(tokens)
        else:
            opt.zero_grad()
            loss = loss_of(tokens)
            h = poison_first_grad(torch, model, float("inf")) \
                if poison else None
            (loss * hvd.current_loss_scale(opt) if guard else loss
             ).backward()
            if h is not None:
                h.remove()
        opt.step()
        return loss.item()

    def replicas_equal() -> bool:
        """Every rank's full parameters, gathered, bitwise rank 0's."""
        if stage == 3:
            opt.gather_params()
        every = C.all_gather_stack(digest(params))
        if stage == 3:
            opt.shard_params()
        return bool((every == every[0]).all())

    seen = None
    if "compression" in kw or (route is not None and "int8" in route):
        st = opt.shard_state
        target = max(range(len(st.plan.buckets)),
                     key=lambda i: st.plan.buckets[i].total_elems)
        seen, restore = _reduce_probe(st, target)
    losses = [step()]
    if seen is not None:
        restore()
        groups = [[r] for r in range(n)] if route is None else \
            [[0, 1], [2, 3]]
        rec["int8_check"] = _int8_rs_check(torch, C, opt.shard_state,
                                           seen, groups)
        del seen
    equal = [replicas_equal()]
    if guard:
        def snap():
            """Every shard and every AdamW state tensor, cloned."""
            return [s.clone() for s in opt.shard_state.shards] + [
                v.clone() for s in opt.shard_state.inner.state.values()
                for v in s.values() if torch.is_tensor(v)]

        before, scale = snap(), hvd.current_loss_scale(opt)
        drill_loss = step(poison=rank == 0)
        after = snap()
        check(opt.skipped and all(torch.equal(a, b)
                                  for a, b in zip(before, after)),
              f"zero {label}: the +Inf step moved state")
        check(hvd.current_loss_scale(opt) == scale / 2,
              f"zero {label}: loss scale {hvd.current_loss_scale(opt)} "
              f"after {scale}")
        rec["drill"] = {"loss": drill_loss, "scale_before": scale,
                        "scale_after": hvd.current_loss_scale(opt),
                        "state_tensors_unchanged": len(before),
                        "guard": hvd.observe_guard(opt, name=f"zero_{label}")}
        del before, after
    _sync(torch, dev)
    hvd.barrier()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times, peak, moved = [], 0.0, {}
    for _ in range(ZERO_TIMED):
        bytes0 = _zero_bytes(metrics)
        t0 = time.perf_counter()
        losses.append(step())
        _sync(torch, dev)
        times.append(time.perf_counter() - t0)
        for k, v in _zero_bytes(metrics).items():
            if v != bytes0.get(k, 0.0):
                moved[k] = moved.get(k, 0.0) + v - bytes0.get(k, 0.0)
        opt.zero_grad()
        peak_now, rest = _mem(torch, dev)
        peak = max(peak, peak_now)
        equal.append(replicas_equal())
    launches = dict(K.LAUNCHES)
    check(all(map(math.isfinite, losses)),
          f"zero {label}: non-finite loss in {losses}")
    check(all(equal), f"zero {label}: replicas differ after step(s) "
                      f"{[i for i, e in enumerate(equal) if not e]}")
    flash = model.num_layers * ZERO_TIMED * (2 if stage == 2 else 1)
    want = dict(flash_fwd=flash, flash_bwd_dq=flash, flash_bwd_dkv=flash)
    buckets = len(opt.shard_state.plan.buckets) if stage else 0
    if "compression" in kw:
        want["quantize_int8_stochastic"] = buckets * ZERO_TIMED
    if route is not None and "compression" in kw:
        rec["int8_hops_per_bucket"] = 1     # the cross hop's reduce-scatter
    if guard:
        want["scale_buffer"] = buckets * ZERO_TIMED
    _expect(launches, f"zero {label}", **want)
    if stage:
        rec["buckets"] = buckets
        rec["shard_bytes"] = sum(s.numel() * s.element_size()
                                 for s in opt.shard_state.shards)
    if "compression" in kw:
        res = opt.shard_state.ef_state.residual
        check(all(bool(torch.isfinite(r).all()) for r in res),
              f"zero {label}: non-finite residual")
        rec["residual_norm"] = math.sqrt(sum(
            float(r.double().pow(2).sum()) for r in res))
        check(rec["residual_norm"] > 0, f"zero {label}: residual is zero")
    rec.update({"losses": losses, "step_ms": [t * 1e3 for t in times],
                "step_ms_median": statistics.median(times) * 1e3,
                "launches": launches, "replicas_equal": equal,
                "peak_mem_gib": peak, "rest_mem_gib": rest,
                "zero_bytes": moved,
                "resident_bytes": _zero_bytes(
                    metrics, "hvd_tpu_zero_param_bytes_resident",
                    ("stage",)).get(str(stage))})
    if stage == 0:
        release(torch, opt, dev)
    if stage == 3:
        opt.gather_params()
    del opt, model, params, digest
    import gc

    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return rec


def zero_worker(config: str, rank: int, out_path: str,
                dev: str = "cuda") -> None:
    """One rank of phase 7c (``--rank-worker n4_zero``): the ZeRO cases
    (a)-(e) in turn on a flat world of 4."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = ZERO_RUN[0]
    ctx = hvd.init(backend="gloo") if dev == "cuda" \
        else hvd.init(device="cpu")
    check(hvd.size() == n and hvd.rank() == rank,
          f"zero: rank {hvd.rank()} of {hvd.size()}")
    out = {"config": config, "rank": rank, "backend": ctx.backend,
           "cases": {}}
    for label, stage, kw in ZERO_CASES:
        out["cases"][label] = rec = _zero_train(
            torch, hvd, gpt_mod, C, K, metrics, label, stage, kw, rank, n,
            dev, layers=ZERO_LAYERS if ZERO_RUN[1] == "gpt_medium"
            else None)
        print(f"rank {rank} zero ({label}): step ms {rec['step_ms']}, peak "
              f"{rec['peak_mem_gib']:.2f} GiB, rest "
              f"{rec['rest_mem_gib']:.2f} GiB, launches {rec['launches']}",
              flush=True)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_zero(torch, out_dir: str) -> dict:
    """Phase 7c: the four rank workers of the ZeRO cases on the one card.
    Returns the phase's record with ``launches``, the ZeRO path's counts
    summed over the cases."""
    n, model_name, batch, seq, timeout = ZERO_RUN
    os.makedirs(out_dir, exist_ok=True)
    ranks, wall = run_workers(ZERO_CONFIG, n, timeout, out_dir)
    res = {"n": n, "model": model_name, "batch_per_rank": batch,
           "seq_len": seq, "wall_s": wall,
           "label": "gloo, 4 processes on one card (not NCCL or NVLink)",
           "cases": {}}
    base = ranks[0]["cases"]["a"]["losses"]
    launches = {}
    for label, stage, kw in ZERO_CASES:
        recs = [rk["cases"][label] for rk in ranks]
        check(all(rc["launches"] == recs[0]["launches"] for rc in recs),
              f"zero {label}: ranks counted different launches")
        for k, v in recs[0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        losses = recs[0]["losses"]
        drill = recs[0].get("drill")
        pairs = list(zip(losses, base)) + (
            [(drill["loss"], base[1])] if drill else [])
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        check(rel <= ZERO_LOSS_RTOL,
              f"zero {label}: losses {losses} off (a)'s {base} by {rel}")
        step_ms = statistics.median(
            statistics.median(rc["step_ms"]) for rc in recs)
        m = res["cases"][label] = {
            "zero_stage": stage, **{k: str(v) for k, v in kw.items()},
            "step_ms_median": step_ms, "step_ms_rank0": recs[0]["step_ms"],
            "tokens_per_s": n * batch * seq / (step_ms / 1e3),
            "losses_rank0": losses, "loss_rel_to_a": rel,
            "launches": recs[0]["launches"],
            "peak_mem_gib": max(rc["peak_mem_gib"] for rc in recs),
            "rest_mem_gib": max(rc["rest_mem_gib"] for rc in recs),
            "zero_bytes_rank0": recs[0]["zero_bytes"],
            "resident_bytes_rank0": recs[0]["resident_bytes"],
            "buckets": recs[0].get("buckets"),
            "check": recs[0].get("int8_check"), "drill": drill}
        print(f"zero ({label}) stage {stage} {kw or ''} (gloo, 4 processes "
              f"on one card): gpt_medium B={batch} S={seq} per rank, step "
              f"{step_ms:.1f} ms = {m['tokens_per_s']:.0f} tok/s; peak "
              f"{m['peak_mem_gib']:.2f} GiB, at rest "
              f"{m['rest_mem_gib']:.2f} GiB a rank; loss vs (a) {rel:.2e}; "
              f"gathered bytes a rank (3 steps) "
              f"{json.dumps(m['zero_bytes_rank0'])}, resident parameter "
              f"bytes {m['resident_bytes_rank0']}; check "
              f"{json.dumps(m['check'])}; drill {json.dumps(m['drill'])}; "
              f"launches {json.dumps(m['launches'])}", flush=True)
    res["launches"] = launches
    with open(os.path.join(out_dir, "chip_smoke_zero.json"), "w") as f:
        json.dump(dict(res, ranks=ranks), f, indent=1)
    return res


# -- eager phase: Horovod's PyTorch loop through the eager engine -----------

EAGER_CONFIGS = {
    # n, model, per-rank batch, sequence length, worker timeout (s)
    "n2_eager": (2, "gpt_medium", 8, 512, 900),
    "n2_join": (2, "gpt_medium", 8, 512, 600),
}
EAGER_PRE, EAGER_POST = 1 / 3, 1.5  # predivide 3 at n = 2, split as the
                                    # JAX torch shim's _launch splits it
EAGER_STEPS = 4                     # 1 checked + 3 timed
JOIN_STEPS = (3, 2)                 # rank 0, rank 1, before join()
MOE_TOKENS = (4096, 1024)           # tokens per rank x model width


def bits_equal(torch, a, b) -> bool:
    """Same shape, dtype and bit patterns (-0.0 differs from 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _eager_setup(torch, hvd, gpt_mod, config, rank, **init_kw):
    n, model_name, batch, seq, _ = EAGER_CONFIGS[config]
    ctx = hvd.init(backend="gloo", **init_kw)
    check(ctx.backend == "gloo" and ctx.device.type == "cuda"
          and hvd.size() == n and hvd.rank() == rank,
          f"init: rank {hvd.rank()} of {hvd.size()} over {ctx.backend} on "
          f"{ctx.device}")
    model = _make_model(torch, gpt_mod, model_name)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               11 + rank)).to("cuda")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)

    def fwd_bwd():
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        return loss
    return ctx, model, opt, list(model.named_parameters()), fwd_bwd


def eager_reduce(hvd, named) -> None:
    """Horovod's PyTorch loop: one named asynchronous allreduce per
    gradient (SUM, predivide 3 as prescale 1/3 and postscale 1.5), then
    every handle synchronized into its gradient."""
    handles = [(p, hvd.allreduce_async(
        p.grad, op=hvd.Sum, name="grad." + name,
        prescale_factor=EAGER_PRE, postscale_factor=EAGER_POST))
        for name, p in named]
    for p, h in handles:
        p.grad = hvd.synchronize(h)


def _moe_exchanges(torch, hvd, K, n: int, rank: int) -> dict:
    """MoE-shaped exchanges at the model's width, each held against a
    plain result from every rank's input (regenerated from its seed on
    every rank): bitwise for the none/bf16 wires, the uneven exchange,
    the gathers and the reduce-scatter; bitwise against the plain K2/K4
    of the same chunks for the int8 wire, which must launch K2 and K4."""
    rows, width = MOE_TOKENS

    def tokens(seed, nrows, dtype=torch.bfloat16):
        return torch.randn((nrows, width), generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda").to(dtype)

    rec = {}
    t0 = time.perf_counter()
    xs = [tokens(100 + r, rows) for r in range(n)]
    check(torch.equal(hvd.allgather(xs[rank][None], name="moe.gather"),
                      torch.stack(xs)), "allgather: differs from the inputs")
    half = rows // n
    want = torch.cat([xs[src][rank * half:(rank + 1) * half]
                      for src in range(n)])
    for wire in ("none", "bf16"):
        y = hvd.alltoall(xs[rank], name=f"moe.{wire}", wire=wire)
        check(bits_equal(torch, y, want), f"alltoall wire={wire}: differs")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    y = hvd.alltoall(xs[rank], name="moe.int8", wire="int8")
    torch.cuda.synchronize()
    rec["int8_launches"] = dict(K.LAUNCHES)
    check(rec["int8_launches"]["quantize_int8"] == 1
          and rec["int8_launches"]["dequantize_int8"] == 1,
          f"alltoall wire=int8: launches {rec['int8_launches']}, expected "
          "one K2 and one K4")
    c = half * width
    padded = c + (-c % K.BLOCK)
    parts = []
    for src in range(n):
        flat = torch.nn.functional.pad(
            xs[src].reshape(n, c).float(), (0, padded - c)).reshape(-1)
        q, scales, _ = K._quantize_plain(flat)
        qrows, nblocks = padded // 128, padded // K.BLOCK
        parts.append(K._dequantize_plain(
            q[rank * qrows:(rank + 1) * qrows],
            scales[rank * nblocks:(rank + 1) * nblocks], padded,
            (padded,), torch.bfloat16)[:c].reshape(half, width))
    check(bits_equal(torch, y, torch.cat(parts)),
          "alltoall wire=int8: differs from the plain K2/K4 of the chunks")
    rec["int8_max_abs_err_vs_exact"] = (y.float() - want.float()).abs() \
        .max().item()
    splits = torch.randint(256, 3840, (n, n), generator=torch.Generator()
                           .manual_seed(9)).tolist()
    xv = [tokens(200 + r, sum(splits[r])) for r in range(n)]
    y = hvd.alltoall(xv[rank], name="moe.uneven", splits=splits[rank])
    want = torch.cat([xv[src][sum(splits[src][:rank]):
                              sum(splits[src][:rank + 1])]
                      for src in range(n)])
    check(bits_equal(torch, y, want), "alltoall with splits: differs")
    xr = [tokens(300 + r, rows, torch.float32) for r in range(n)]
    y = hvd.reducescatter(xr[rank], op=hvd.Average, name="moe.rs")
    acc = xr[0][rank * half:(rank + 1) * half].clone()
    for src in range(1, n):
        acc += xr[src][rank * half:(rank + 1) * half]
    want = acc / torch.full((1,), n, dtype=acc.dtype, device="cuda")
    check(bits_equal(torch, y, want), "reducescatter Average: differs")
    xg = [tokens(400 + r, rows - 1024 * r) for r in range(n)]
    y = hvd.allgatherv(xg[rank], name="moe.ragged")
    check(bits_equal(torch, y, torch.cat(xg)), "ragged allgather: differs")
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["uneven_splits"] = splits
    return rec


SURFACE_SHAPES = ((1000,), (37, 5), (4096, 16))
SPARSE_SHAPE, SPARSE_NNZ = (50257, 1024), 4096   # an embedding gradient


def _surface_calls(torch, hvd, n: int, rank: int) -> dict:
    """Horovod's in-place and sparse calls on the card (``allreduce_``,
    ``grouped_allreduce_`` Sum and Average, ``broadcast_async_`` ->
    ``synchronize``, ``alltoall_async``, ``sparse_allreduce_async`` Sum
    and Average), each held bitwise against the same reduction done by
    hand from every rank's input (regenerated from its seed on every
    rank)."""
    def vec(seed, shape):
        return torch.randn(shape, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")

    def total(tensors):
        acc = tensors[0].clone()
        for t in tensors[1:]:
            acc += t
        return acc

    def size_tensor(dtype):
        return torch.full((1,), n, dtype=dtype, device="cuda")

    t0 = time.perf_counter()
    xs = [[vec(500 + 10 * r + i, s) for i, s in enumerate(SURFACE_SHAPES)]
          for r in range(n)]
    for op, label in ((hvd.Sum, "sum"), (hvd.Average, "average")):
        ts = [x.clone() for x in xs[rank]]
        ret = hvd.grouped_allreduce_(ts, op=op, name=f"surface.grp.{label}")
        check(all(a is b for a, b in zip(ret, ts)),
              "grouped_allreduce_: did not return its tensors")
        for i, t in enumerate(ts):
            want = total([xs[r][i] for r in range(n)])
            if op == hvd.Average:
                want = want / size_tensor(want.dtype)
            check(bits_equal(torch, t, want),
                  f"grouped_allreduce_ {label}: tensor {i} differs")
    t = xs[rank][2].clone()
    check(hvd.allreduce_(t, op=hvd.Sum, name="surface.ar_") is t
          and bits_equal(torch, t, total([xs[r][2] for r in range(n)])),
          "allreduce_: differs")
    t = xs[rank][1].clone()
    h = hvd.broadcast_async_(t, root_rank=n - 1, name="surface.bcast_")
    check(hvd.synchronize(h) is t and bits_equal(torch, t, xs[n - 1][1]),
          "broadcast_async_ -> synchronize: not the root's tensor in place")
    h = hvd.alltoall_async(xs[rank][2], name="surface.a2a")
    rows = SURFACE_SHAPES[2][0] // n
    want = torch.cat([xs[src][2][rank * rows:(rank + 1) * rows]
                      for src in range(n)])
    check(bits_equal(torch, hvd.synchronize(h), want),
          "alltoall_async: differs")

    def sparse(r):
        gen = torch.Generator(device="cuda").manual_seed(600 + r)
        rows = torch.randint(0, SPARSE_SHAPE[0], (SPARSE_NNZ,),
                             generator=gen, device="cuda")
        values = torch.randn((SPARSE_NNZ, SPARSE_SHAPE[1]), generator=gen,
                             device="cuda")
        return torch.sparse_coo_tensor(rows[None], values, SPARSE_SHAPE)

    dense = total([sparse(r).coalesce().to_dense() for r in range(n)])
    for op, label in ((hvd.Sum, "sum"), (hvd.Average, "average")):
        got = hvd.sparse_allreduce_async(sparse(rank), name=f"surface.sp."
                                         f"{label}", op=op)()
        check(got.is_sparse and got.device.type == "cuda",
              f"sparse_allreduce_async {label}: not a sparse CUDA tensor")
        want = dense if op == hvd.Sum else \
            (dense.to(torch.float64) / n).to(dense.dtype)
        check(bits_equal(torch, got.to_dense(), want),
              f"sparse_allreduce_async {label}: differs")
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "shapes": [list(sh) for sh in SURFACE_SHAPES],
            "sparse": {"shape": list(SPARSE_SHAPE), "rows_per_rank":
                       SPARSE_NNZ}, "bitwise": True}


def eager_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of the eager phase (``--rank-worker n2_eager``): GPT-2
    medium trained 1 checked + 3 timed steps in Horovod's PyTorch loop,
    then the timeline, the MoE-shaped exchanges, an object broadcast and a
    mismatch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import controller as ctl_mod
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, model_name, batch, seq, _ = EAGER_CONFIGS[config]
    ctx, model, opt, named, fwd_bwd = _eager_setup(torch, hvd, gpt_mod,
                                                   config, rank)
    ctl = ctx.controller
    # The native runtime: the controller's table (rank 0) and the
    # engine's LRU are the C++ ones, and its frames are counted.
    check((ctl._table is None or ctl._table._h is not None)
          and ctx.engine._lru._h is not None,
          "eager: the native negotiation table / LRU is not in use")
    frames0 = dict(ctl_mod.FRAMES)
    params = [p for _, p in named]
    digest = _Digest(torch, params)
    target = max(range(len(params)),
                 key=lambda i: (params[i].numel() <= 4_194_304,
                                params[i].numel()))
    timeline = os.path.join(os.path.dirname(out_path),
                            f"eager_timeline_rank{rank}.json")
    out = {"config": config, "n": n, "rank": rank, "model": model_name,
           "batch": batch, "seq_len": seq, "backend": ctx.backend,
           "params": len(params)}
    times, split, rounds, equal, losses = [], [], [], [], []
    torch.cuda.synchronize()
    hvd.barrier()
    torch.cuda.reset_peak_memory_stats()
    # The main path: launch counts zeroed just before it, read just after.
    K.reset_launch_counts()
    for step in range(EAGER_STEPS):
        t0 = time.perf_counter()
        loss = fwd_bwd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if step == 0:
            g = params[target].grad.clone()
        if step == 2:
            hvd.start_timeline(timeline)
            check(ctx.timeline.native,
                  "eager: the timeline is not on the native writer")
        r0 = ctl.negotiation_rounds
        eager_reduce(hvd, named)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rounds.append(ctl.negotiation_rounds - r0)
        if step == 2:
            hvd.stop_timeline()
        if step == 0:
            every = hvd.allgather(g[None], name="check")
            acc = K.scale_buffer_plain(every[0], EAGER_PRE)
            for r in range(1, n):
                acc = acc + K.scale_buffer_plain(every[r], EAGER_PRE)
            want = K.scale_buffer_plain(acc, EAGER_POST)
            check(bits_equal(torch, params[target].grad, want),
                  f"eager: parameter {named[target][0]}'s reduced gradient "
                  "differs from plain(plain(g0, 1/3) + plain(g1, 1/3), 1.5)")
            out["check"] = {"param": named[target][0],
                            "elements": g.numel(), "bitwise": True}
            del every, acc, want, g
        t3 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        losses.append(loss.item())
        every = C.all_gather_stack(digest(params))
        equal.append(bool((every == every[0]).all()))
        times.append((t2 - t0) + (t4 - t3))
        split.append((t1 - t0, t2 - t1, t4 - t3))
    launches = dict(K.LAUNCHES)
    frames = {k: ctl_mod.FRAMES[k] - frames0[k] for k in frames0}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(frames["native"] > 0 and frames["json"] == 0,
          f"eager: controller frames {frames}: every request and response "
          "of the loop must ride the native codec (JSON only for "
          "wire_dtype/process_set)")
    dropped = ctx.timeline.dropped()
    check(dropped == 0, f"eager: the native timeline dropped {dropped} "
                        "events")
    check(all(math.isfinite(v) for v in losses),
          f"eager: non-finite loss in {losses}")
    check(all(equal), f"eager: replicas differ after step(s) "
                      f"{[i for i, e in enumerate(equal) if not e]}")
    check(rounds == [len(params)] + [0] * (EAGER_STEPS - 1),
          f"eager: negotiation rounds per step {rounds}, expected "
          f"{len(params)} then 0")
    flash = model.num_layers * EAGER_STEPS
    want_launches = {k: 0 for k in launches}
    want_launches.update(scale_buffer=2 * len(params) * EAGER_STEPS,
                         flash_fwd=flash, flash_bwd_dq=flash,
                         flash_bwd_dkv=flash)
    check(launches == want_launches, f"eager: launches {launches}, "
                                     f"expected {want_launches}")
    with open(timeline) as f:
        events = json.load(f)["traceEvents"]
    phases = {}
    for e in events:
        if e.get("ph") in ("B", "E"):
            phases.setdefault(e["tid"], []).append(e["ph"])
    names = {"allreduce.grad." + name for name, _ in named}
    check(set(phases) == names and all(v == ["B", "E"]
                                       for v in phases.values()),
          f"timeline: {len(phases)} tensors traced, expected one begin/end "
          f"pair for each of {len(names)} gradients")
    out["moe"] = _moe_exchanges(torch, hvd, K, n, rank)
    out["surface"] = _surface_calls(torch, hvd, n, rank)
    hp = {k: v for k, v in opt.param_groups[0].items() if k != "params"}
    got = hvd.broadcast_object(dict(hp, lr=hp["lr"] * (rank + 1)),
                               root_rank=0, name="hyperparameters")
    check(got == hp, f"broadcast_object: {got} != rank 0's {hp}")
    t0 = time.perf_counter()
    try:
        hvd.allreduce(torch.ones(4 + rank, device="cuda"), name="probe")
        raise SmokeError("mismatch: no MismatchError raised")
    except hvd.MismatchError as e:
        out["mismatch"] = {"ranks": list(e.ranks),
                           "seconds": time.perf_counter() - t0,
                           "timeout_s": ctl.timeout_s}
    check(out["mismatch"]["ranks"] == [1]
          and out["mismatch"]["seconds"] < ctl.timeout_s,
          f"mismatch: {out['mismatch']}")
    after = hvd.allreduce(torch.ones(3, device="cuda"), op=hvd.Sum,
                          name="after")
    check(bool((after == n).all()), "mismatch: the next collective failed")
    numel = sum(p.numel() for p in params)
    out.update({
        "losses": losses, "step_ms": [t * 1e3 for t in times[1:]],
        "first_step_ms": times[0] * 1e3,
        "first_sync_loop_ms": split[0][1] * 1e3,
        "step_ms_median": statistics.median(times[1:]) * 1e3,
        "fwd_bwd_ms_median": statistics.median(t[0] for t in split[1:])
        * 1e3,
        "sync_loop_ms_median": statistics.median(t[1] for t in split[1:])
        * 1e3,
        "opt_step_ms_median": statistics.median(t[2] for t in split[1:])
        * 1e3,
        "negotiation_rounds": rounds, "launches": launches,
        "replicas_equal": equal, "peak_mem_gib": peak,
        "wire_bytes_per_step": 2 * (n - 1) / n * 4 * numel,
        "raw_bytes_per_step": 4 * numel,
        "timeline_tensors": len(phases), "timeline_dropped": dropped,
        "controller_frames": frames, "hyperparameters": repr(hp)})
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def join_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of the join check (``--rank-worker n2_join``): with
    ``init(join_mode=True)`` rank 1 trains 2 steps and joins, rank 0
    trains 3 and joins; rank 0's third-step gradients must be the plain
    arithmetic with zeros from rank 1."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx, model, opt, named, fwd_bwd = _eager_setup(
        torch, hvd, gpt_mod, config, rank, join_mode=True)
    steps = JOIN_STEPS[rank]
    out = {"config": config, "rank": rank, "steps": steps,
           "join_mode": ctx.config.join_mode, "step_ms": []}
    K.reset_launch_counts()
    for step in range(steps):
        t0 = time.perf_counter()
        loss = fwd_bwd()
        local = [p.grad.clone() for _, p in named] if step == 2 else None
        eager_reduce(hvd, named)
        if local is not None:
            bad = [name for (name, p), g in zip(named, local)
                   if not bits_equal(torch, p.grad, K.scale_buffer_plain(
                       K.scale_buffer_plain(g, EAGER_PRE)
                       + torch.zeros_like(g), EAGER_POST))]
            check(not bad, f"join: {len(bad)} gradients of rank 0's third "
                           f"step differ, e.g. {bad[:3]}")
            out["checked_gradients"] = len(local)
            del local
        opt.step()
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        check(math.isfinite(loss.item()), "join: non-finite loss")
    t0 = time.perf_counter()
    out["last"] = hvd.join()
    out["join_s"] = time.perf_counter() - t0
    out["launches"] = dict(K.LAUNCHES)
    check(out["last"] == 0, f"join: returned {out['last']}, expected 0")
    check(out["launches"]["scale_buffer"] == 2 * len(named) * steps,
          f"join: K1 launched {out['launches']['scale_buffer']} times, "
          f"expected {2 * len(named) * steps}")
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_eager(torch, out_dir: str) -> dict:
    """The eager phase: both worker configs; any check failing in a
    worker fails it."""
    n, model_name, batch, seq, timeout = EAGER_CONFIGS["n2_eager"]
    ranks, wall = run_workers("n2_eager", n, timeout, out_dir)
    check(all(rk["launches"] == ranks[0]["launches"] for rk in ranks),
          "eager: ranks counted different launches")
    step_ms = statistics.median(rk["step_ms_median"] for rk in ranks)
    r0 = ranks[0]
    res = {"n": n, "model": model_name, "batch_per_rank": batch,
           "seq_len": seq, "backend": r0["backend"], "wall_s": wall,
           "label": "gloo, 2 processes on one card",
           "step_ms_median": step_ms,
           "tokens_per_s": n * batch * seq / (step_ms / 1e3),
           "fwd_bwd_ms_median": r0["fwd_bwd_ms_median"],
           "sync_loop_ms_median": r0["sync_loop_ms_median"],
           "opt_step_ms_median": r0["opt_step_ms_median"],
           "first_step_ms": r0["first_step_ms"],
           "first_sync_loop_ms": r0["first_sync_loop_ms"],
           "negotiation_rounds": r0["negotiation_rounds"],
           "launches": r0["launches"], "check": r0["check"],
           "wire_bytes_per_step_per_rank": r0["wire_bytes_per_step"],
           "peak_mem_gib_rank0": r0["peak_mem_gib"],
           "losses_rank0": r0["losses"], "moe": r0["moe"],
           "surface": r0["surface"],
           "mismatch": r0["mismatch"],
           "controller_frames": [rk["controller_frames"] for rk in ranks],
           "ranks": ranks}
    print(f"eager (gloo, 2 processes on one card): gpt_medium B={batch} "
          f"S={seq} per rank, step {step_ms:.1f} ms = "
          f"{res['tokens_per_s']:.0f} tok/s (rank 0: forward + backward "
          f"{res['fwd_bwd_ms_median']:.1f} ms, allreduce_async + "
          f"synchronize loop {res['sync_loop_ms_median']:.1f} ms, step() "
          f"{res['opt_step_ms_median']:.1f} ms; step 1 "
          f"{res['first_step_ms']:.1f} ms, its loop with "
          f"{res['negotiation_rounds'][0]} negotiation rounds "
          f"{res['first_sync_loop_ms']:.1f} ms); "
          f"{res['wire_bytes_per_step_per_rank'] / 1e9:.3f} GB/step per "
          f"rank (ring); peak {res['peak_mem_gib_rank0']:.2f} GiB; "
          f"negotiation rounds per step {res['negotiation_rounds']}; "
          f"controller frames (native codec) "
          f"{json.dumps(res['controller_frames'])}, timeline on the native "
          f"writer, 0 dropped; "
          f"check {json.dumps(res['check'])}; mismatch "
          f"{json.dumps(res['mismatch'])}; moe exchanges "
          f"{res['moe']['seconds']:.2f} s; in-place and sparse calls "
          f"bitwise in {res['surface']['seconds']:.2f} s; launches "
          f"{json.dumps(res['launches'])}", flush=True)
    n, _, _, _, timeout = EAGER_CONFIGS["n2_join"]
    jranks, jwall = run_workers("n2_join", n, timeout, out_dir)
    res["join"] = {"wall_s": jwall, "ranks": jranks}
    print(f"join (gloo, 2 processes on one card): rank 1 joined after "
          f"{jranks[1]['steps']} steps, rank 0 after {jranks[0]['steps']}; "
          f"join() returned {[rk['last'] for rk in jranks]}; rank 0 step "
          f"ms {[round(t, 1) for t in jranks[0]['step_ms']]}; "
          f"{jranks[0]['checked_gradients']} third-step gradients bitwise",
          flush=True)
    with open(os.path.join(out_dir, "chip_smoke_eager.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


# -- phase 7d: overlap (D2) and the Adasum optimizer's guard and accumulation -

OVERLAP_N2 = "n2_overlap"
OVERLAP_N4 = "n4_overlap"
# n, model, per-rank batch, sequence length, worker timeout (s)
OVERLAP_RUNS = {OVERLAP_N2: (2, "gpt_medium", 8, 512, 600),
                OVERLAP_N4: (4, "gpt_medium", 4, 512, 600)}
OVERLAP_TIMED = 3                   # timed steps after the checked one
ADASUM_ACCUM = 2                    # microbatches of the accumulated arm
# Phase 7d's depth: GPT-2 medium's widths at 8 of its 24 layers (the
# role-aware elastic slice's named cut, with 7b's; see MESH_LAYERS); the
# launch counts follow the model and its plan.
OVERLAP_LAYERS = 8
ACCUM_LOSS_RTOL = 1e-3              # accumulated vs fused: the bf16 bounds
ACCUM_DELTA_RTOL = 2e-2


def _overlap_arm(torch, hvd, gpt_mod, C, K, rank, batch, seq, on, kw,
                 zero: bool = False) -> dict:
    """One arm of phase 7d: GPT-2 medium from the seeded weights, AdamW,
    1 checked and ``OVERLAP_TIMED`` timed steps with ``overlap=on``;
    the parameters' (or, under ZeRO stage 3, the shards') digest after
    every step, each timed step's forward + backward, ``step()`` and
    collective split, the launches of the timed steps, and memory."""
    model = integrity_model(torch, gpt_mod, "cuda", layers=OVERLAP_LAYERS)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               41 + rank)).to("cuda")
    inner = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    if zero:
        opt = hvd.ZeroOptimizer(inner, zero_stage=3, overlap=on)
    else:
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(), overlap=on,
            **kw)

    def state_digest():
        if zero:
            return torch.cat([s.reshape(-1) for s in opt.shard_state.shards]
                             ).view(torch.int32).to(torch.int64).sum().item()
        return digest(params).cpu().tolist()

    def loss_of(t):
        return gpt_mod.next_token_loss(model(t[:, :-1]), t[:, 1:])

    # Stage 3 steps through accumulate (one microbatch), which gathers
    # under the forward when overlap is on.
    fn = opt.accumulate(loss_of) if zero else None

    def forward_backward():
        if zero:
            return fn(tokens)
        loss = loss_of(tokens)
        opt.zero_grad()
        loss.backward()
        return loss

    losses = [forward_backward().item()]
    opt.step()
    digests = [state_digest()]
    torch.cuda.synchronize()
    hvd.barrier()
    torch.cuda.reset_peak_memory_stats()
    worker0 = opt._worker.busy_s if on and opt._worker else 0.0
    K.reset_launch_counts()
    split = []
    for _ in range(OVERLAP_TIMED):
        busy0 = opt._worker.busy_s if on and opt._worker else 0.0
        t0 = time.perf_counter()
        loss = forward_backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wire_s = [0.0]
        clock = contextlib.nullcontext() if on else \
            wire_clock(torch, C, wire_s)
        with clock:
            opt.step()
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        if on and opt._worker is not None:
            # The chains' host time over the whole step: under the
            # backward (or the forward's gathers) and in step().
            wire_s[0] = opt._worker.busy_s - busy0
        split.append((t2 - t0, t1 - t0, t2 - t1, wire_s[0]))
        losses.append(loss.item())
        digests.append(state_digest())
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rest = torch.cuda.memory_allocated() / 2 ** 30
    check(all(map(math.isfinite, losses)), f"overlap arm {kw}: non-finite "
                                           f"loss in {losses}")
    rec = {"overlap": on, "losses": losses, "digests": digests,
           "launches": launches, "peak_mem_gib": peak, "rest_mem_gib": rest,
           "step_ms": [t[0] * 1e3 for t in split],
           "step_ms_median": statistics.median(t[0] for t in split) * 1e3,
           "fwd_bwd_ms_median": statistics.median(t[1] for t in split)
           * 1e3,
           "step_call_ms_median": statistics.median(t[2] for t in split)
           * 1e3,
           "wire_ms_median": statistics.median(t[3] for t in split) * 1e3,
           "worker_chains": opt._worker.chains if on and opt._worker
           else 0, "worker_busy_s_checked_step": worker0}
    if not zero and getattr(opt, "_ef", False):
        rec["int8_buckets"] = opt._dist_plan.wire_dtypes.count("int8")
        rec["buckets"] = len(opt._dist_plan.buckets)
    if zero:
        rec["buckets"] = len(opt.shard_state.plan.buckets)
    else:
        release(torch, opt, "cuda")
    del opt, model, params, digest, inner
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _pair(torch, hvd, gpt_mod, C, K, rank, batch, seq, kw, what,
          zero=False, **want) -> dict:
    """Both arms, ``overlap=False`` then ``True``: bitwise after every
    step, the same launches, each as ``want``."""
    off = _overlap_arm(torch, hvd, gpt_mod, C, K, rank, batch, seq, False,
                       kw, zero)
    on = _overlap_arm(torch, hvd, gpt_mod, C, K, rank, batch, seq, True,
                      kw, zero)
    check(off["digests"] == on["digests"],
          f"{what}: overlap=True differs from overlap=False after step(s) "
          f"{[i for i, (a, b) in enumerate(zip(off['digests'], on['digests'])) if a != b]}")
    check(off["losses"] == on["losses"], f"{what}: losses differ")
    for arm in (off, on):
        w = dict(want)
        if w.get("quantize_int8_stochastic") == "int8_buckets":
            # Two K3 hops (the reduce-scatter and the all-gather) an int8
            # bucket a timed step.
            w["quantize_int8_stochastic"] = \
                2 * arm["int8_buckets"] * OVERLAP_TIMED
        _expect(arm["launches"], f"{what} overlap={arm['overlap']}", **w)
    return {"off": off, "on": on, "bitwise_steps": len(off["digests"])}


def _adasum_guard_drill(torch, hvd, gpt_mod, K, rank, batch, seq) -> dict:
    """Adasum + ``scale_backoff``: steps 1 and 3 apply, step 2 carries a
    +Inf in rank 0's first gradient element: every weight and AdamW
    tensor bitwise unchanged across it, the loss scale 2^15 -> 2^14.
    Launches over the three steps: K1 one a parameter a step (the
    unscale), K8 and K9 one a parameter a good step."""
    model = integrity_model(torch, gpt_mod, "cuda", layers=OVERLAP_LAYERS)
    params = list(model.parameters())
    tokens = torch.randint(0, model.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               51 + rank)).to("cuda")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        op=hvd.Adasum, nonfinite_policy="scale_backoff")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    scales, losses, times = [], [], []
    for s in range(3):
        t0 = time.perf_counter()
        scale = hvd.current_loss_scale(opt)
        scales.append(scale)
        opt.zero_grad()
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        h = poison_first_grad(torch, model, float("inf")) \
            if s == 1 and rank == 0 else None
        (loss * scale).backward()
        if h is not None:
            h.remove()
        if s == 1:
            before = [p.detach().clone() for p in params] + [
                v.clone() for st in opt.state.values() for v in st.values()
                if torch.is_tensor(v)]
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if s == 1:
            after = [p.detach() for p in params] + [
                v for st in opt.state.values() for v in st.values()
                if torch.is_tensor(v)]
            check(len(after) == len(before) and all(
                torch.equal(a, b) for a, b in zip(before, after)),
                "adasum drill: the +Inf step moved a weight or an AdamW "
                "tensor")
            unchanged = len(before)
            del before, after
    scales.append(hvd.current_loss_scale(opt))
    launches = dict(K.LAUNCHES)
    check(scales[1] == 2.0 ** 15 and scales[2] == 2.0 ** 14,
          f"adasum drill: loss scales {scales}")
    n_p = len(params)
    flash = model.num_layers * 3
    _expect(launches, "adasum drill", scale_buffer=3 * n_p,
            adasum_dot_norms=2 * n_p, adasum_combine=2 * n_p,
            flash_fwd=flash, flash_bwd_dq=flash, flash_bwd_dkv=flash)
    rec = {"losses": losses, "scales": scales, "launches": launches,
           "state_tensors_unchanged": unchanged,
           "guard": hvd.observe_guard(opt, name="adasum_drill"),
           "step_ms": [t * 1e3 for t in times],
           "guard_agreements": opt.guard_agreements}
    del opt, model, params
    torch.cuda.empty_cache()
    return rec


def _adasum_accum_arms(torch, hvd, gpt_mod, K, tokens, compute) -> dict:
    """The accumulated and the fused arm of :func:`_adasum_accum` with the
    model computing in ``compute`` (``"bf16"``, the model's default, or
    ``"fp32"``); their readings side by side."""
    kw = {} if compute == "bf16" else {"dtype": torch.float32}
    out, deltas, local = {}, {}, {}
    for arm, k in (("accum", ADASUM_ACCUM), ("fused", 1)):
        model = integrity_model(torch, gpt_mod, "cuda",
                                layers=OVERLAP_LAYERS, **kw)
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=1e-2),
                                       op=hvd.Adasum, accum_steps=k)
        before = [p.detach().clone() for p in params]
        names = [n_ for n_, _ in model.named_parameters()]
        # The fp32 spacing of each weight (both arms start from the same
        # seeded weights): a delta is a difference of two fp32 weights.
        ulp = [float((torch.nextafter(b, torch.full_like(b, math.inf))
                      - b).norm()) for b in before]

        def loss_of(t):
            return gpt_mod.next_token_loss(model(t[:, :-1]), t[:, 1:])

        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        opt.zero_grad()
        if k > 1:
            loss = opt.accumulate(loss_of)(tokens)
        else:
            loss = loss_of(tokens)
            loss.backward()
        local[arm] = [-1e-2 * p.grad.detach().float() for p in params]
        opt.step()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        n_p = len(params)
        flash = model.num_layers * k
        _expect(launches, f"adasum {compute} {arm}", adasum_dot_norms=n_p,
                adasum_combine=n_p, flash_fwd=flash, flash_bwd_dq=flash,
                flash_bwd_dkv=flash)
        deltas[arm] = [p.detach() - b for p, b in zip(params, before)]
        out[arm] = {"loss": loss.item(), "launches": launches,
                    "step_ms": (time.perf_counter() - t0) * 1e3,
                    "reductions": opt.adasum_reductions}
        del opt, model, params, before
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    local_rel = [rel(a, b) for a, b in zip(local["accum"], local["fused"])]
    reduced_rel = [rel(a, b) for a, b in zip(deltas["accum"],
                                             deltas["fused"])]
    worst = max(range(len(names)), key=reduced_rel.__getitem__)
    out.update(
        loss_rel=abs(out["accum"]["loss"] - out["fused"]["loss"])
        / abs(out["fused"]["loss"]),
        local_delta_rel_max=max(local_rel),
        reduced_delta_rel=rel(
            torch.cat([d.reshape(-1) for d in deltas["accum"]]),
            torch.cat([d.reshape(-1) for d in deltas["fused"]])),
        reduced_delta_rel_worst_param=[names[worst], reduced_rel[worst]],
        # The worst parameter: its local delta's error, and the norm of
        # its weights' fp32 spacing over its reduced delta's norm — the
        # rounding that taking a delta as a difference of weights (and
        # adding the reduced one back) puts on it.
        worst_param_local_rel=local_rel[worst],
        worst_param_ulp_over_delta=ulp[worst] / float(
            deltas["fused"][worst].norm().clamp_min(1e-30)))
    del deltas, local
    torch.cuda.empty_cache()
    return out


def _adasum_accum(torch, hvd, gpt_mod, K, rank, batch, seq) -> dict:
    """Adasum with ``accum_steps=2`` (2 x batch/2 rows) against one fused
    batch, over SGD (so a delta is ``-lr`` times a gradient; AdamW's
    first update is about ``lr * sign(g)``, which a gradient's bf16
    noise flips wherever it is near 0), once with the model's bf16
    compute and once in fp32. In both: the loss within 1e-3, every
    parameter's local delta (what accumulation computes: ``-lr`` times
    the mean gradient) within 2e-2 relative Frobenius error, and the
    reduced deltas of all parameters together within 2e-2 (the bf16
    bounds of a gradient). In fp32 also every single parameter's reduced
    delta within 2e-2. Under bf16 the worst single reduced delta is
    reported beside its weights' fp32 spacing over its delta
    (``worst_param_ulp_over_delta``): a delta is the difference of two
    fp32 weights, and where the weights are near 1 (a LayerNorm gain)
    and the step small, their rounding is a large part of it. One K8/K9
    launch a parameter in each arm."""
    tokens = torch.randint(0, TOK_EMB[0], (batch, seq + 1),
                           generator=torch.Generator().manual_seed(
                               61 + rank)).to("cuda")
    out = {}
    for compute in ("bf16", "fp32"):
        r = out[compute] = _adasum_accum_arms(torch, hvd, gpt_mod, K,
                                              tokens, compute)
        check(r["loss_rel"] <= ACCUM_LOSS_RTOL,
              f"adasum accum {compute}: loss {r['accum']['loss']} vs "
              f"fused {r['fused']['loss']} ({r['loss_rel']})")
        check(r["local_delta_rel_max"] <= ACCUM_DELTA_RTOL,
              f"adasum accum {compute}: a local delta off the fused one "
              f"by {r['local_delta_rel_max']}")
        check(r["reduced_delta_rel"] <= ACCUM_DELTA_RTOL,
              f"adasum accum {compute}: the reduced deltas off the fused "
              f"ones by {r['reduced_delta_rel']}")
    worst = out["fp32"]["reduced_delta_rel_worst_param"]
    check(worst[1] <= ACCUM_DELTA_RTOL,
          f"adasum accum fp32: the reduced delta of {worst[0]} off the "
          f"fused one by {worst[1]}")
    return out


def overlap_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of phase 7d (``--rank-worker n2_overlap|n4_overlap``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, _, batch, seq, _ = OVERLAP_RUNS[config]
    if n == 4:
        hvd.init(backend="gloo", mesh_shape=MESH_SHAPE)
    else:
        hvd.init(backend="gloo")
    check(hvd.size() == n and hvd.rank() == rank,
          f"overlap: rank {hvd.rank()} of {hvd.size()}")
    flash = OVERLAP_LAYERS * OVERLAP_TIMED
    out = {"config": config, "rank": rank}
    def done(name):
        print(f"rank {rank} {config} {name}: "
              f"{json.dumps(out[name], default=str)[:600]}", flush=True)

    if n == 2:
        out["int8_ef"] = _pair(
            torch, hvd, gpt_mod, C, K, rank, batch, seq,
            {"compression": "int8_ef"}, "int8_ef n=2", flash_fwd=flash,
            flash_bwd_dq=flash, flash_bwd_dkv=flash,
            quantize_int8_stochastic="int8_buckets")
        done("int8_ef")
        out["adasum_drill"] = _adasum_guard_drill(torch, hvd, gpt_mod, K,
                                                  rank, batch, seq)
        done("adasum_drill")
        out["adasum_accum"] = _adasum_accum(torch, hvd, gpt_mod, K, rank,
                                            batch, seq)
        done("adasum_accum")
    else:
        out["routed"] = _pair(
            torch, hvd, gpt_mod, C, K, rank, batch, seq,
            {"compression": "int8_ef", "route": MESH_ZERO_ROUTE},
            f"routed int8_ef {MESH_ZERO_ROUTE}", flash_fwd=flash,
            flash_bwd_dq=flash, flash_bwd_dkv=flash,
            quantize_int8_stochastic="int8_buckets")
        done("routed")
        out["zero3"] = _pair(torch, hvd, gpt_mod, C, K, rank, batch, seq,
                             {}, "ZeRO stage 3", zero=True,
                             flash_fwd=flash, flash_bwd_dq=flash,
                             flash_bwd_dkv=flash)
        done("zero3")
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _free_parent(torch) -> dict:
    """Give this process's cached card memory back before its workers
    start; returns what it still holds (GiB)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated": torch.cuda.memory_allocated() / 2 ** 30,
            "reserved": torch.cuda.memory_reserved() / 2 ** 30}
    print(f"parent holds {held['allocated']:.2f} GiB allocated, "
          f"{held['reserved']:.2f} GiB reserved on the card", flush=True)
    return held


def phase_overlap(torch, out_dir: str) -> dict:
    """Phase 7d: the rank workers of both configurations on the one card.
    Returns the phase's record with ``launches``, every section's counts
    summed (rank 0's)."""
    res = {"label": "gloo, n processes on one card (not NCCL or NVLink)",
           "parent_gib": _free_parent(torch)}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for config in (OVERLAP_N2, OVERLAP_N4):
        n, model_name, batch, seq, timeout = OVERLAP_RUNS[config]
        # Four ranks of GPT-2 medium with int8 buffers share the card with
        # this process: let their allocators grow segments in place
        # rather than hold reserved fragments (no value changes).
        ranks, wall = run_workers(
            config, n, timeout, out_dir,
            {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        res[config] = {"n": n, "model": model_name, "batch_per_rank": batch,
                       "seq_len": seq, "wall_s": wall}
        r0 = ranks[0]
        for name in ("int8_ef", "routed", "zero3"):
            if name not in r0:
                continue
            arms = {}
            for arm in ("off", "on"):
                recs = [rk[name][arm] for rk in ranks]
                check(all(rc["launches"] == recs[0]["launches"]
                          for rc in recs),
                      f"overlap {name}: ranks counted different launches")
                add(recs[0]["launches"])
                arms[arm] = m = {
                    k: recs[0][k] for k in (
                        "step_ms_median", "fwd_bwd_ms_median",
                        "step_call_ms_median", "wire_ms_median",
                        "launches", "worker_chains", "losses")}
                m["step_ms_median"] = statistics.median(
                    rc["step_ms_median"] for rc in recs)
                m["tokens_per_s"] = n * batch * seq / (
                    m["step_ms_median"] / 1e3)
                m["peak_mem_gib"] = max(rc["peak_mem_gib"] for rc in recs)
                m["rest_mem_gib"] = max(rc["rest_mem_gib"] for rc in recs)
                print(f"overlap {config} {name} overlap={arm == 'on'} "
                      f"(gloo, {n} processes on one card): step "
                      f"{m['step_ms_median']:.1f} ms = "
                      f"{m['tokens_per_s']:.0f} tok/s (rank 0: forward + "
                      f"backward {m['fwd_bwd_ms_median']:.1f} ms, step() "
                      f"{m['step_call_ms_median']:.1f} ms, collectives "
                      f"{m['wire_ms_median']:.1f} ms); peak "
                      f"{m['peak_mem_gib']:.2f} GiB, at rest "
                      f"{m['rest_mem_gib']:.2f} GiB; launches "
                      f"{json.dumps(m['launches'])}", flush=True)
            res[config][name] = dict(
                arms, bitwise_steps=r0[name]["bitwise_steps"])
            print(f"overlap {config} {name}: overlap=True bitwise "
                  f"overlap=False after all {r0[name]['bitwise_steps']} "
                  f"steps on every rank", flush=True)
        if "adasum_drill" in r0:
            drill = r0["adasum_drill"]
            add(drill["launches"])
            acc = r0["adasum_accum"]
            for compute in ("bf16", "fp32"):
                for arm in ("accum", "fused"):
                    add(acc[compute][arm]["launches"])
            res[config]["adasum_drill"] = {
                k: drill[k] for k in ("losses", "scales", "launches",
                                      "state_tensors_unchanged", "step_ms",
                                      "guard_agreements")}
            res[config]["adasum_accum"] = acc
            print(f"overlap {config} Adasum + scale_backoff drill (+Inf on "
                  f"rank 0 at step 2; gloo, 2 processes on one card): "
                  f"scales {drill['scales']}, {drill['state_tensors_unchanged']}"
                  f" tensors bitwise unchanged, step ms {drill['step_ms']}, "
                  f"launches {json.dumps(drill['launches'])}", flush=True)
            for compute in ("bf16", "fp32"):
                a = acc[compute]
                print(f"overlap {config} Adasum accum_steps={ADASUM_ACCUM} "
                      f"vs one batch, {compute} compute: loss rel "
                      f"{a['loss_rel']:.2e}, local deltas rel <= "
                      f"{a['local_delta_rel_max']:.2e}, reduced deltas rel "
                      f"{a['reduced_delta_rel']:.2e} (worst parameter "
                      f"{a['reduced_delta_rel_worst_param']}, its local "
                      f"rel {a['worst_param_local_rel']:.2e}, weight "
                      f"spacing / delta {a['worst_param_ulp_over_delta']:.3e});"
                      f" step ms accum {a['accum']['step_ms']:.1f}, fused "
                      f"{a['fused']['step_ms']:.1f}", flush=True)
    res["launches"] = launches
    with open(os.path.join(out_dir, "chip_smoke_overlap.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


# -- phase 8: elastic training through the port's launcher --------------------

ELASTIC_HOSTS = "hostA:1,hostB:1"
# model, per-rank batch, sequence length, steps, persist every, int8_ef's
# smallest quantized bucket (None: the default)
ELASTIC_RUN = ("gpt_medium", 4, 512, 9, 3, None)
# GPT-2 medium's widths at 2 of its 24 layers: the depth cut that keeps
# the smoke inside its time with phase 9 after it (a persist of the
# full depth, 5.66 GB a rank, took 18.6-20.0 s of each recovery).
ELASTIC_LAYERS = 2
# The fault plan in GLOBAL training steps: a rendezvous 5xx on hostA's
# second poll, a collective fault on hostB at step 4, a hard crash of
# hostB's worker at step 6 (a real gloo peer death) and a SIGTERM
# preemption of rank 0 at step 8.
ELASTIC_PLAN = {"seed": 7, "faults": [
    {"site": "rendezvous", "step": 2, "mode": "5xx", "host": "hostA"},
    {"site": "collective", "step": 4, "host": "hostB"},
    {"site": "crash", "step": 6, "host": "hostB"},
    {"site": "preempt", "step": 8, "rank": 0}]}
ELASTIC_SITES = ("collective", "crash", "preempt", "rendezvous")
ELASTIC_TIMEOUT = 600               # seconds a launcher run may take
ELASTIC_ENV = {"HVD_TPU_ELASTIC_FORCE_LOCAL": "1",
               "HVD_TPU_BLACKLIST_TTL_S": "3",
               "HVD_TPU_ELASTIC_GRACE_SECS": "20",
               "HVD_TPU_ELASTIC_RESET_BACKOFF_MAX_S": "0.5"}
_NEVER = 1 << 40                    # a spec step no run reaches
ELASTIC_KEEP = 2                    # persisted steps kept (the walk-back)


def _state_digest(torch, model, opt) -> str:
    """sha256 of the parameters and the whole optimizer state dict (AdamW
    moments and steps, this rank's int8_ef residuals and rounding step),
    each float tensor's bits summed plain and weighted on its device."""
    import hashlib

    sd = opt.state_dict()
    tensors = [p.detach() for p in model.parameters()]
    for i in sorted(sd["state"]):
        for k in sorted(sd["state"][i]):
            v = sd["state"][i][k]
            tensors.append(torch.as_tensor(v))
    ef = sd.get("ef_state")
    if ef is not None:
        tensors += [ef["residual"][b] for b in sorted(ef["residual"])]
    h = hashlib.sha256(json.dumps(ef["step"] if ef else None).encode())
    for t in tensors:
        flat = t.reshape(-1)
        if flat.dtype == torch.float32:
            bits = flat.view(torch.int32).to(torch.int64)
        else:
            bits = flat.to(torch.float64).view(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device,
                         dtype=torch.int64) % 1000003 + 1
        h.update(torch.stack([bits.sum(), (bits * w).sum()]).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def _shifted_plan(faults, raw: str, log_path: str, start: int):
    """This worker's part of a plan whose ``step`` s are GLOBAL training
    steps: the specs that fired in an earlier worker (the fault log)
    are dropped, the rest shifted by the step this worker resumes at
    (collective, crash and preempt are hit once a step)."""
    plan = faults.FaultPlan.from_json(raw)
    fired = set()
    if os.path.exists(log_path):
        with open(log_path) as f:
            fired = {json.loads(line)["spec"] for line in f if line.strip()}
    for i, spec in enumerate(plan.faults):
        # Spec indices stay those of the plan (the log names them): a
        # spec that fired, or whose step is behind, never fires again.
        done = i in fired or spec.step is None or spec.step <= start
        spec.step = _NEVER if done else spec.step - start
    return plan


def elastic_worker(cfg_path: str) -> None:
    """One worker of phase 8 (``--elastic-worker CFG``), started by the
    port's launcher: restore the persisted state, train ``steps`` steps
    of int8_ef AdamW under ``hvd.elastic.run`` (commit every step,
    persist every ``persist_every`` and at a preemption), log every
    event with its time, and at the end check the persisted state
    against the last commit."""
    import time as time_mod

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import faults
    from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
    from horovod_tpu_torch.models import gpt as gpt_mod

    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = hvd.init(device="cpu") if dev == "cpu" else \
        hvd.init(backend="gloo")
    rank, n = hvd.rank(), hvd.size()
    host = os.environ.get("HVD_TPU_HOSTNAME", "")
    work = cfg["workdir"]
    events_path = os.path.join(work, f"events.rank{rank}.jsonl")

    def log(event, **kw):
        with open(events_path, "a") as f:
            f.write(json.dumps({"event": event, "t": time_mod.time(),
                                "pid": os.getpid(), "host": host, "n": n,
                                "metrics_port": ctx.metrics_port, **kw})
                    + "\n")

    def build():
        model = (integrity_model(torch, gpt_mod, dev, layers=cfg["layers"])
                 if cfg.get("layers") else
                 _make_model(torch, gpt_mod, cfg["model"], dev))
        kw = {} if cfg["qmin"] is None else \
            {"quantize_min_bucket_bytes": cfg["qmin"]}
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            compression="int8_ef", **kw)
        return model, opt, elastic.TorchState(model, opt, step=0)

    model, opt, state = build()
    ckdir = os.path.join(work, "ckpt")
    digests_path = os.path.join(work, f"digests.rank{rank}.json")
    t0 = time_mod.perf_counter()
    try:
        start = ckpt.restore_state(state, ckdir)
    except FileNotFoundError:
        start = 0
    if start:
        with open(digests_path) as f:
            want = json.load(f)[str(start)]
        got = _state_digest(torch, model, opt)
        log("restore", step=start, seconds=time_mod.perf_counter() - t0,
            digest_ok=got == want)
    else:
        log("start", step=0)
    raw = os.environ.get("HVD_TPU_FAULT_PLAN")
    if raw and cfg.get("shift_plan", True):
        faults.install(_shifted_plan(faults, raw,
                                     os.environ["HVD_TPU_FAULT_LOG"], start))

    def persist(st):
        t = time_mod.perf_counter()
        ckpt.save_state(st, ckdir, st.step, max_to_keep=ELASTIC_KEEP)
        secs = time_mod.perf_counter() - t
        step_dir = os.path.join(ckdir, f"rank{rank}" if n > 1 else "",
                                str(st.step))
        nbytes = sum(os.path.getsize(os.path.join(d, name))
                     for d, _, names in os.walk(step_dir) for name in names)
        digests = {}
        if os.path.exists(digests_path):
            with open(digests_path) as f:
                digests = json.load(f)
        # The committed snapshot is what save_state wrote.
        live = _state_digest(torch, model, opt)
        digests[str(st.step)] = live
        with open(digests_path + ".tmp", "w") as f:
            json.dump(digests, f)
        os.replace(digests_path + ".tmp", digests_path)
        log("persist", step=st.step, seconds=secs, bytes=nbytes)

    elastic.on_preemption(persist)
    batch, seq = cfg["batch"], cfg["seq"]

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2 ** 30
                if dev == "cuda" else 0.0)

    @elastic.run
    def train(st):
        while st.step < cfg["steps"]:
            s = st.step
            tokens = torch.randint(
                0, model.vocab_size, (batch, seq + 1),
                generator=torch.Generator().manual_seed(1000 * s + rank)
            ).to(dev)
            loss = gpt_mod.next_token_loss(model(tokens[:, :-1]),
                                           tokens[:, 1:])
            opt.zero_grad()
            loss.backward()
            opt.step()
            mean_loss = None
            if cfg.get("loss_allreduce"):
                # The metric average users run each step: one eager
                # allreduce (phase 9's collective_stall site).
                mean_loss = hvd.allreduce(loss.detach(),
                                          name="loss").item()
            st.step = s + 1
            t = time_mod.perf_counter()
            try:
                st.commit()
            except HostsUpdatedInterrupt:
                # The commit saved the step before it saw the new host
                # set: the step is done, in this world.
                log("step", step=st.step, loss=loss.item(),
                    mean_loss=mean_loss, interrupted=True,
                    commit_ms=(time_mod.perf_counter() - t) * 1e3,
                    peak_gib=peak_gib())
                raise
            log("step", step=st.step, loss=loss.item(), mean_loss=mean_loss,
                commit_ms=(time_mod.perf_counter() - t) * 1e3,
                peak_gib=peak_gib())
            if cfg["persist_every"] and st.step % cfg["persist_every"] == 0:
                persist(st)

    try:
        train(state)
    except SystemExit as e:
        # A driver-managed exit (79: a peer failed, 80: the host set
        # changed) leaves the live state at its last commit:
        # persist_at_exit makes that the step the next epoch resumes.
        if cfg.get("persist_at_exit") and e.code in (
                elastic.PEER_FAILURE_EXIT_CODE,
                elastic.HOSTS_UPDATED_EXIT_CODE):
            persist(state)
        from horovod_tpu_torch.ops import kernels as K

        log("exit", step=int(state.step), code=e.code,
            launches=dict(K.LAUNCHES), peak_gib=peak_gib())
        raise
    except BaseException as e:
        import traceback

        log("error", step=int(state.step), error=f"{type(e).__name__}: "
            f"{e}", traceback=traceback.format_exc()[-3000:])
        raise
    final = _state_digest(torch, model, opt)
    from horovod_tpu_torch.ops import kernels as K

    if not cfg["final_check"]:
        log("final", step=int(state.step), digest=final,
            launches=dict(K.LAUNCHES), peak_gib=peak_gib())
        hvd.shutdown()
        return
    # The persisted state against the last commit: restored into a fresh
    # model and optimizer.
    state.restore()
    committed = _state_digest(torch, model, opt)
    model2, opt2, state2 = build()
    step2 = ckpt.restore_state(state2, ckdir)
    persisted = _state_digest(torch, model2, opt2)
    log("final", step=int(state.step), digest=final,
        persisted_step=step2, persisted_equal=persisted == committed,
        committed_equal=committed == final, launches=dict(K.LAUNCHES))
    hvd.shutdown()


def run_elastic_job(work: str, cfg: dict, plan, env_extra=None,
                    timeout: float = ELASTIC_TIMEOUT, output=None,
                    hosts: str = ELASTIC_HOSTS, nps=(2, 2, 2),
                    launcher_args=(), watch=None,
                    worker: str = "--elastic-worker"):
    """One launcher run of this script's elastic workers (``worker``,
    default ``--elastic-worker``):
    ``hvdtpurun-torch --elastic -np NP --min-np MIN --max-np MAX -H
    HOSTS`` (``nps``; phase 8: 2, 2, 2 over hostA:1,hostB:1) plus
    ``launcher_args``, its output streamed to ``output`` (default
    ``<work>/launcher.log``). ``watch(stop)``, when given, runs on a
    thread beside the launcher until it exits and ``stop`` (an Event) is
    set. Returns (exit code, wall s, the events by rank, the fault log's
    records, the launcher's output)."""
    import glob
    import threading

    os.makedirs(work, exist_ok=True)
    cfg = dict(cfg, workdir=os.path.abspath(work))
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    log_path = os.path.join(work, "faults.jsonl")
    env = {**os.environ, **ELASTIC_ENV, **(env_extra or {}),
           "HVD_TPU_FAULT_LOG": log_path}
    env.pop("HVD_TPU_FAULT_PLAN", None)
    argv = launcher_argv("--elastic", "-np", str(nps[0]), "--min-np",
                         str(nps[1]), "--max-np", str(nps[2]), "-H", hosts,
                         *launcher_args)
    if plan is not None:
        argv += ["--fault-plan", json.dumps(plan)]
    argv += ["--", *worker_argv(worker, cfg_path)]
    t0 = time.perf_counter()
    log_file = output or os.path.join(work, "launcher.log")
    stop = threading.Event()
    watcher = None
    with open(log_file, "w") as out:
        proc = subprocess.Popen(
            argv, env=env, stdout=out, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if watch is not None:
            watcher = threading.Thread(target=watch, args=(stop,),
                                       daemon=True)
            watcher.start()
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        finally:
            stop.set()
            if watcher is not None:
                watcher.join(timeout=30)
    wall = time.perf_counter() - t0
    with open(log_file) as f:
        text = f.read()
    if rc is None:
        raise SmokeError(f"elastic run in {work} passed its {timeout} s "
                         f"limit:\n{text[-3000:]}")
    events = {}
    for path in sorted(glob.glob(os.path.join(work, "events.rank*.jsonl"))):
        r = int(os.path.basename(path)[len("events.rank"):-len(".jsonl")])
        with open(path) as f:
            events[r] = [json.loads(line) for line in f if line.strip()]
    injections = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            injections = [json.loads(line) for line in f if line.strip()]
    return rc, wall, events, injections, text


def elastic_report(events: dict, injections: list) -> dict:
    """Per fault: seconds from its injection to the first step completed
    after it — by the injected process itself when the fault was
    absorbed (it goes on stepping), else by the first process started
    after the injection; commit ms, persist s and bytes, restore s and
    the restore digest checks."""
    every = [e for evs in events.values() for e in evs]
    first_t = {}
    for e in sorted(every, key=lambda e: e["t"]):
        first_t.setdefault(e["pid"], e["t"])
    faults_out = []
    for inj in injections:
        before = [e for e in every if e["host"] == inj["host"]
                  and e["t"] <= inj["t"]]
        pid = max(before, key=lambda e: e["t"])["pid"] if before else None
        steps = sorted((e["t"], e["step"]) for e in every
                       if e["event"] == "step" and e["t"] > inj["t"])
        own = [x for x in steps if any(
            e["pid"] == pid and e["t"] == x[0] for e in every)]
        after = own or [(t, st) for t, st in steps if any(
            e["t"] == t and first_t[e["pid"]] > inj["t"] for e in every)]
        faults_out.append({
            "site": inj["site"], "host": inj["host"], "rank": inj["rank"],
            "absorbed": bool(own),
            "recover_s": (after[0][0] - inj["t"]) if after else None,
            "next_step": after[0][1] if after else None})
    commits = [e["commit_ms"] for e in every if e["event"] == "step"]
    persists = [e for e in every if e["event"] == "persist"]
    restores = [e for e in every if e["event"] == "restore"]
    return {
        "faults": faults_out,
        "commit_ms_median": statistics.median(commits) if commits else None,
        "persist_s_median": statistics.median(
            [e["seconds"] for e in persists]) if persists else None,
        "persist_bytes": max((e["bytes"] for e in persists), default=0),
        "restore_s": [e["seconds"] for e in restores],
        "restores": [(e["step"], e["digest_ok"]) for e in restores],
        "finals": {r: next((e for e in evs if e["event"] == "final"), None)
                   for r, evs in events.items()},
        "losses_rank0": [(e["step"], e["loss"]) for e in events.get(0, [])
                         if e["event"] == "step"],
    }


def phase_elastic(torch, out_dir: str) -> dict:
    """Phase 8: an uninterrupted launcher run of ``ELASTIC_RUN``, then the
    run under ``ELASTIC_PLAN``: exit 0, the final step, the four sites,
    every restore bitwise its commit, the persisted state the last
    commit, and the final state bitwise the clean run's. Returns the
    phase's record with ``launches``, the clean run's rank 0 counts."""
    import shutil
    import tempfile

    model_name, batch, seq, steps, every, qmin = ELASTIC_RUN
    cfg = {"model": model_name, "device": "cuda", "batch": batch,
           "seq": seq, "steps": steps, "persist_every": every, "qmin": qmin,
           "layers": ELASTIC_LAYERS}
    _free_parent(torch)

    # The checkpoints stay out of the output directory; the logs are
    # copied there.
    root = tempfile.mkdtemp(prefix="hvd_elastic_")
    try:
        return _phase_elastic(torch, out_dir, root, cfg, steps,
                              model_name, batch, seq, every)
    finally:
        for name in ("clean1", "chaos"):
            src = os.path.join(root, name)
            dst = os.path.join(out_dir, f"elastic_{name}")
            os.makedirs(dst, exist_ok=True)
            for f in ("faults.jsonl", "events.rank0.jsonl",
                      "events.rank1.jsonl"):
                if os.path.exists(os.path.join(src, f)):
                    with open(os.path.join(src, f), "rb") as fi, \
                            open(os.path.join(dst, f), "wb") as fo:
                        data = fi.read()
                        fo.write(data[-400_000:])
        shutil.rmtree(root, ignore_errors=True)


def _phase_elastic(torch, out_dir, root, cfg, steps, model_name, batch,
                   seq, every) -> dict:

    # The clean run persists nothing (persistence changes no value) and
    # runs before the chaos run: four such ranks at once, each with its
    # commit snapshot on the card, would crowd its 80 GB.
    clean_cfg = dict(cfg, persist_every=0, final_check=False)
    clean = [run_elastic_job(
        os.path.join(root, "clean1"), clean_cfg, None,
        output=os.path.join(out_dir, "elastic_clean1.log"))]
    rc, _, _, inj, log = clean[0]
    check(rc == 0, f"elastic clean run: exit {rc}:\n{log[-3000:]}")
    check(not inj, f"elastic clean run: injections {inj}")
    reps = [elastic_report(c[2], c[3]) for c in clean]
    rc, wall, events, inj, log = run_elastic_job(
        os.path.join(root, "chaos"), dict(cfg, final_check=True),
        ELASTIC_PLAN, output=os.path.join(out_dir, "elastic_chaos.log"))
    check(rc == 0, f"elastic chaos run: exit {rc}:\n{log[-3000:]}")
    rep = elastic_report(events, inj)
    sites = sorted({i["site"] for i in inj})
    check(sites == sorted(ELASTIC_SITES), f"elastic: injected sites {sites}")
    check(rep["restores"] and all(ok for _, ok in rep["restores"]),
          f"elastic: a restore differs from its commit: {rep['restores']}")
    for r in (0, 1):
        fin = rep["finals"].get(r)
        check(fin is not None and fin["step"] == steps
              and fin["persisted_step"] == steps and fin["persisted_equal"]
              and fin["committed_equal"],
              f"elastic: rank {r} final {fin}")
    check(all(f["recover_s"] is not None for f in rep["faults"]),
          f"elastic: a fault was not recovered from: {rep['faults']}")
    for r in (0, 1):
        check(rep["finals"][r]["digest"] == reps[0]["finals"][r]["digest"],
              f"elastic: rank {r}'s final state differs from the "
              "uninterrupted run's")
    compared = "bitwise"
    launches = reps[0]["finals"][0].get("launches", {})
    res = {"label": "gloo, 2 processes on one card (not NCCL or NVLink)",
           "model": model_name, "layers": ELASTIC_LAYERS,
           "batch_per_rank": batch, "seq_len": seq,
           "steps": steps, "persist_every": every,
           "clean_wall_s": [c[1] for c in clean], "chaos_wall_s": wall,
           "final_vs_uninterrupted": compared, "sites": sites,
           "faults": rep["faults"], "commit_ms_median":
           rep["commit_ms_median"], "persist_s_median":
           rep["persist_s_median"], "persist_bytes": rep["persist_bytes"],
           "restore_s": rep["restore_s"], "restores": rep["restores"],
           "clean_step_s": _step_seconds(clean[0][2]),
           "launches": launches}
    for f in rep["faults"]:
        print(f"elastic (gloo, 2 processes on one card): {f['site']} on "
              f"{f['host']} -> recovered in {f['recover_s']:.2f} s (next "
              f"step {f['next_step']}{', absorbed' if f['absorbed'] else ''})",
              flush=True)
    print(f"elastic: commit {rep['commit_ms_median']:.2f} ms (median), "
          f"persist {rep['persist_s_median']:.2f} s and "
          f"{rep['persist_bytes'] / 1e9:.3f} GB a rank, restore "
          f"{json.dumps([round(x, 2) for x in rep['restore_s']])} s; wall: "
          f"clean {[round(c[1], 1) for c in clean]} s, chaos {wall:.1f} s; "
          f"final state vs uninterrupted: {compared}; launches of a clean "
          f"rank 0 {json.dumps(launches)}", flush=True)
    with open(os.path.join(out_dir, "chip_smoke_elastic.json"), "w") as f:
        json.dump(dict(res, losses_chaos=rep["losses_rank0"],
                       losses_clean=reps[0]["losses_rank0"]), f, indent=1)
    return res


# -- phase 9: telemetry and control --------------------------------------------

TELEMETRY_HOSTS = "hostA:1,hostB:1,hostC:1"
# model, per-rank batch, sequence length, steps
TELEMETRY_RUN = ("gpt_medium", 4, 512, 50)
# The control run's depth: GPT-2 medium's widths at 2 of its 24 layers
# (4 made room for phase 12, 2 for phase 13: the role-aware elastic
# slice's named cut). A step is then shorter, so the run takes more of
# them: the world at 2 must not reach the last step before hostC is back.
TELEMETRY_LAYERS = 2
# hostC's extra seconds a commit (at full depth about one clean step of
# the world of 3, 1.0-1.1 s on the H100; several at 4 layers), for its
# first process's first commits only: a regrown hostC never fires it
# again (the worker drops specs the fault log shows fired).
TELEMETRY_STRAGGLE = {"site": "straggler", "step": 1, "times": 30,
                      "host": "hostC", "delay_s": 1.2}
# hostB's third per-step loss allreduce held past the stall check time
# and well inside the fatal bound: a warning, nothing worse.
TELEMETRY_STALL = {"site": "collective_stall", "step": 3, "host": "hostB",
                   "delay_s": 9.0}
TELEMETRY_PLAN = {"seed": 13, "faults": [TELEMETRY_STRAGGLE,
                                         TELEMETRY_STALL]}
# The policy. A tick must span a step period of the world (every rank
# then reports in each tick: the ranks commit in lockstep, hostC's
# publish a delay later). hostC's exile is short; what brings it back
# is discovery: the hosts come from a discovery script whose list this
# process edits — hostC leaves it at the eviction and returns once the
# world has stepped at n = 2 — so the return cannot race the eviction's
# epoch change (notice at a commit, the exit persist of 3 x 5.66 GB), as
# a TTL alone does: expiring before the next assignment gives 3 -> 3,
# after the run's end no grow at all.
TELEMETRY_POLICY = {"tick_interval_s": 3.0, "publish_interval_s": 0.0,
                    "window": 8, "straggler_ratio": 1.5,
                    "straggler_patience": 2, "min_ranks": 3,
                    "evict_ttl_s": 10.0, "evict_cooldown_s": 0.0,
                    "grow_cooldown_s": 0.0, "grow_min_comm_fraction": 0.0}
TELEMETRY_ENV = {"HVD_TPU_STALL_CHECK_TIME_SECONDS": "6",
                 "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS": "120",
                 "HVD_TPU_POD_METRICS_INTERVAL_S": "1",
                 "HVD_TPU_ELASTIC_GRACE_SECS": "90"}
TELEMETRY_TIMEOUT = 420             # seconds the control run may take
# (a): the train phase's geometry, one process, telemetry off then on.
OVERHEAD_ENV = {"off": {"HVD_TPU_METRICS": "0", "HVD_TPU_FLIGHTREC": "0",
                        "HVD_TPU_STALL_CHECK_DISABLE": "1"},
                "on": {"HVD_TPU_METRICS_PORT": "0",
                       "HVD_TPU_METRICS_INTERVAL_S": "1"}}


def telemetry_worker(cfg_path: str) -> None:
    """One process of phase 9 (a) (``--telemetry-worker CFG``): GPT-2
    medium trained as the train phase does (n = 1, AdamW), each step's
    gradient and apply under ``hvd.StepTimer`` phases; writes its
    ``/metrics`` port as soon as it has one, then the losses (as hex, to
    compare bitwise), the step times and the peak GiB."""
    import time as time_mod

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod

    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = hvd.init(device="cpu") if dev == "cpu" else hvd.init()
    with open(cfg["port_file"] + ".tmp", "w") as f:
        json.dump({"metrics_port": ctx.metrics_port, "pid": os.getpid()}, f)
    os.replace(cfg["port_file"] + ".tmp", cfg["port_file"])
    model = _make_model(torch, gpt_mod, cfg["model"], dev)
    tokens = torch.randint(0, model.vocab_size,
                           (cfg["batch"], cfg["seq"] + 1),
                           generator=torch.Generator().manual_seed(11)
                           ).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    st = hvd.StepTimer()

    def grad():
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        return loss

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    losses, times = [], []
    for i in range(cfg["warmup"] + cfg["steps"]):
        if i == cfg["warmup"] and dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time_mod.perf_counter()
        loss = st.timed("grad", grad)
        with st.phase("apply"):
            opt.step()
            sync()
        times.append((time_mod.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" \
        else 0.0
    phases = {s["labels"]["phase"]: s["value"]["count"]
              for s in hvd.metrics().get("hvd_tpu_step_phase_seconds",
                                         {}).get("samples", ())}
    with open(cfg["out"], "w") as f:
        json.dump({"losses_hex": [float(x).hex() for x in losses],
                   "losses": losses, "step_ms": times[cfg["warmup"]:],
                   "peak_gib": peak, "phase_counts": phases,
                   "metrics_port": ctx.metrics_port}, f)
    hvd.shutdown()


def _http_get(url: str, timeout: float = 2.0):
    """``(body, seconds)`` of one GET, or ``(None, seconds)``."""
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read().decode()
    except OSError:
        body = None
    return body, time.perf_counter() - t0


def _labeled(text: str, family: str):
    """``(value, labels)`` of each sample of ``family`` in Prometheus
    text."""
    import re

    out = []
    for line in text.splitlines():
        m = re.match(rf"^{family}(\{{[^}}]*\}})? (\S+)$", line)
        if m:
            labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
            out.append((float(m.group(2)), labels))
    return out


def _overhead_arm(work: str, arm: str, cfg: dict, out_dir: str) -> dict:
    """One (a) process: telemetry ``arm`` off or on; while the on arm
    runs, this process scrapes its ``/metrics`` once a second."""
    import threading

    os.makedirs(work, exist_ok=True)
    cfg = dict(cfg, port_file=os.path.join(work, "port.json"),
               out=os.path.join(work, "out.json"))
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = {**os.environ, **OVERHEAD_ENV[arm]}
    if arm == "on":
        env["HVD_TPU_METRICS_FILE"] = os.path.join(work, "metrics.jsonl")
    scrapes, stop = [], threading.Event()

    def scrape():
        port = None
        while not stop.wait(1.0):
            if port is None and os.path.exists(cfg["port_file"]):
                with open(cfg["port_file"]) as f:
                    port = json.load(f)["metrics_port"]
            if port is not None:
                body, secs = _http_get(f"http://127.0.0.1:{port}/metrics")
                if body is not None:
                    scrapes.append(secs)

    log = os.path.join(out_dir, f"telemetry_overhead_{arm}.log")
    t = threading.Thread(target=scrape, daemon=True)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            worker_argv("--telemetry-worker", cfg_path), env=env, stdout=out,
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if arm == "on":
            t.start()
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        finally:
            stop.set()
            if arm == "on":
                t.join(timeout=10)
    with open(log) as f:
        text = f.read()
    check(rc == 0, f"telemetry overhead ({arm}): exit {rc}:\n{text[-3000:]}")
    with open(cfg["out"]) as f:
        res = json.load(f)
    res["scrapes"] = len(scrapes)
    res["scrape_ms"] = [x * 1e3 for x in scrapes]
    if arm == "on":
        path = env["HVD_TPU_METRICS_FILE"]
        res["dump_lines"] = sum(1 for _ in open(path)) \
            if os.path.exists(path) else 0
    return res


def telemetry_overhead(root: str, out_dir: str, dev: str = "cuda",
                       model: str = "gpt_medium") -> dict:
    """Phase 9 (a): the train phase's geometry (B = 8 x 512, n = 1, 2 + 5
    steps) with telemetry off (``HVD_TPU_METRICS=0``, no flight
    recorder, no stall check) and on (``/metrics`` on an ephemeral port
    scraped once a second, the file dump, the stall watchdog, the flight
    recorder): losses bitwise equal; each arm's step ms."""
    cfg = {"model": model, "device": dev, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS}
    arms = {arm: _overhead_arm(os.path.join(root, f"overhead_{arm}"), arm,
                               cfg, out_dir) for arm in ("off", "on")}
    off, on = arms["off"], arms["on"]
    check(off["losses_hex"] == on["losses_hex"],
          f"telemetry: losses differ with telemetry on: {off['losses']} "
          f"vs {on['losses']}")
    check(on["scrapes"] > 0 and on["metrics_port"] is not None,
          f"telemetry: /metrics never scraped ({on['scrapes']} scrapes)")
    check(on.get("dump_lines", 0) > 0, "telemetry: no metrics file lines")
    check(on["phase_counts"].get("comm", 0) >= TRAIN_STEPS
          and on["phase_counts"].get("grad", 0) >= TRAIN_STEPS,
          f"telemetry: StepTimer phases {on['phase_counts']}")
    check(not off["phase_counts"] and off["metrics_port"] is None,
          f"telemetry off: registry live ({off['phase_counts']})")
    return {"step_ms_off": off["step_ms"], "step_ms_on": on["step_ms"],
            "step_ms_median_off": statistics.median(off["step_ms"]),
            "step_ms_median_on": statistics.median(on["step_ms"]),
            "peak_gib_off": off["peak_gib"], "peak_gib_on": on["peak_gib"],
            "losses": off["losses"], "losses_bitwise_equal": True,
            "scrapes": on["scrapes"],
            "scrape_ms_median": statistics.median(on["scrape_ms"]),
            "dump_lines": on["dump_lines"],
            "phase_counts": on["phase_counts"]}


class ControlWatch:
    """What phase 9 (b)'s parent sees while the launcher runs, polled
    every ``poll_s``: the pod monitor's ``/pod/metrics.json`` (its port
    from the launcher's output), the decision log's lines with the time
    each was first seen, every live worker's ``/metrics`` (its port and
    pid from the events), and, once the world has grown back to 3 and
    each of its workers completed a step, one SIGUSR2 to each, whose
    black boxes are copied to ``box_copy`` a few seconds later. It keeps
    the discovery script's host list (``hosts_file``): the first evicted
    host leaves it at the eviction and returns after a step at n = 2."""

    def __init__(self, work: str, launcher_log: str, decision_log: str,
                 box_dir: str, box_copy: str, hosts_file: str,
                 poll_s: float = 0.5):
        self.work, self.launcher_log = work, launcher_log
        self.decision_log, self.box_dir = decision_log, box_dir
        self.box_copy, self.poll_s = box_copy, poll_s
        self.hosts_file = hosts_file
        self.hidden = None         # (t hidden, t listed again)
        self.pod_port = None
        self.pod = []              # (t, merged view, GET seconds)
        self.decisions = []        # (t first seen, line)
        self.workers = {}          # pid -> what its events say
        self.worker_scrapes = {}   # pid -> {"warnings": max, "labels": ok}
        self.signaled = None       # {"t": ..., "pids": {pid: step}}
        self.boxes = []            # the copied boxes' (path, trigger, pid)

    def _events(self):
        import glob

        for path in glob.glob(os.path.join(self.work, "events.rank*.jsonl")):
            with open(path) as f:
                for line in f:
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue      # a line being written
                    w = self.workers.setdefault(e["pid"], {
                        "host": e["host"], "n": e.get("n"), "steps": 0,
                        "t0": e["t"], "last_step": None, "done": False,
                        "metrics_port": e.get("metrics_port"),
                        "rank": int(os.path.basename(path)[11:-6])})
                    w["t0"] = min(w["t0"], e["t"])
                    if e["event"] == "step":
                        w["last_step"] = max(w["last_step"] or 0, e["step"])
                        w["last_step_t"] = e["t"]
                    if e["event"] in ("exit", "final", "error"):
                        w["done"] = True
        for w in self.workers.values():
            w["steps"] = w["last_step"] or 0

    def _poll(self):
        import re
        import shutil
        import signal as signal_mod

        # The decision log and the host list first: no scrape may delay
        # hiding the evicted host past its (short) exile.
        if os.path.exists(self.decision_log):
            with open(self.decision_log) as f:
                lines = [x.strip() for x in f if x.strip()]
            for line in lines[len(self.decisions):]:
                self.decisions.append((time.time(), line))
        self.workers.clear()
        self._events()
        if self.decisions:
            evicted = json.loads(self.decisions[0][1])["target"]
            if self.hidden is None:
                self._list_hosts(exclude=evicted)
                self.hidden = (time.time(), None)
            elif self.hidden[1] is None and any(
                    w["n"] == 2 and w["steps"] for w in
                    self.workers.values()):
                self._list_hosts()
                self.hidden = (self.hidden[0], time.time())
        if self.pod_port is None and os.path.exists(self.launcher_log):
            with open(self.launcher_log) as f:
                m = re.search(r"/pod/metrics on port (\d+)", f.read())
            if m:
                self.pod_port = int(m.group(1))
        if self.pod_port is not None:
            body, secs = _http_get(
                f"http://127.0.0.1:{self.pod_port}/pod/metrics.json")
            if body is not None:
                self.pod.append((time.time(), json.loads(body), secs))
        for pid, w in self.workers.items():
            if w["done"] or not w["metrics_port"]:
                continue
            body, _ = _http_get(f"http://127.0.0.1:{w['metrics_port']}"
                                "/metrics")
            if body is None:
                continue
            rec = self.worker_scrapes.setdefault(
                pid, {"host": w["host"], "warnings": 0.0, "labels": False})
            for v, labels in _labeled(body, "hvd_tpu_stall_warnings_total"):
                rec["warnings"] = max(rec["warnings"], v)
                rec["labels"] = rec["labels"] or (
                    {"rank", "size", "host"} <= set(labels)
                    and labels["host"] == w["host"])
        grows = [t for t, line in self.decisions
                 if json.loads(line)["action"] == "grow"]
        if self.signaled is None and grows:
            live = [pid for pid, w in self.workers.items()
                    if not w["done"] and w["n"] == 3 and w["t0"] > grows[0]
                    and w["steps"] and w.get("last_step_t", 0) > w["t0"]]
            if len(live) == 3:
                self.signaled = {"t": time.time(), "pids": {
                    pid: self.workers[pid]["last_step"] for pid in live}}
                for pid in live:
                    os.kill(pid, signal_mod.SIGUSR2)
        if self.signaled is not None and not self.boxes \
                and time.time() > self.signaled["t"] + 5:
            os.makedirs(self.box_copy, exist_ok=True)
            for name in sorted(os.listdir(self.box_dir)):
                if name.startswith("blackbox.rank") and \
                        name.endswith(".json"):
                    dst = os.path.join(self.box_copy, name)
                    shutil.copy(os.path.join(self.box_dir, name), dst)
                    with open(dst) as f:
                        box = json.load(f)
                    self.boxes.append((dst, box["trigger"], box["pid"]))

    def _list_hosts(self, exclude=None) -> None:
        hosts = [h for h in TELEMETRY_HOSTS.split(",")
                 if h.split(":")[0] != exclude]
        with open(self.hosts_file + ".tmp", "w") as f:
            f.write("\n".join(hosts) + "\n")
        os.replace(self.hosts_file + ".tmp", self.hosts_file)

    def run(self, stop) -> None:
        while not stop.wait(self.poll_s):
            try:
                self._poll()
            except (OSError, ValueError, KeyError) as e:
                print(f"telemetry watch: {type(e).__name__}: {e}",
                      flush=True)
        self.workers.clear()
        self._events()


def _first_step_after(events: dict, t: float, n: int):
    """Time of the first step event after ``t`` by a world of ``n``."""
    ts = [e["t"] for evs in events.values() for e in evs
          if e["event"] == "step" and e["n"] == n and e["t"] > t]
    return min(ts) if ts else None


def _world_sequence(events: dict) -> list:
    """The world sizes of the run's steps in time order, repeats
    collapsed (one entry an epoch)."""
    steps = sorted((e["t"], e["n"]) for evs in events.values() for e in evs
                   if e["event"] == "step")
    out = []
    for _, n in steps:
        if not out or out[-1] != n:
            out.append(n)
    return out


def telemetry_control(root: str, out_dir: str, dev: str = "cuda",
                      run=TELEMETRY_RUN, plan=None, policy=None,
                      env_extra=None, timeout: float = TELEMETRY_TIMEOUT
                      ) -> dict:
    """Phase 9 (b): ``hvdtpurun-torch --elastic -np 3 --min-np 2
    --max-np 3 -H hostA:1,hostB:1,hostC:1 --metrics-port 0
    --pod-metrics-port 0 --autoscale-policy JSON --autoscale-log FILE``
    over ``--elastic-worker`` (int8_ef AdamW, a commit a step, the
    per-step eager loss allreduce, the committed state persisted at
    each driver-managed exit) under ``TELEMETRY_PLAN``, watched by a
    :class:`ControlWatch`. Checks and returns the record."""
    model_name, batch, seq, steps = run
    plan = TELEMETRY_PLAN if plan is None else plan
    policy = TELEMETRY_POLICY if policy is None else policy
    work = os.path.join(root, "control")
    os.makedirs(work, exist_ok=True)
    decision_log = os.path.join(work, "decisions.jsonl")
    box_dir = os.path.join(work, "flightrec")
    launcher_log = os.path.join(out_dir, "telemetry_control.log")
    hosts_file = os.path.join(work, "hosts.txt")
    discover = os.path.join(work, "discover.sh")
    with open(discover, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(discover, 0o755)
    watch = ControlWatch(work, launcher_log, decision_log, box_dir,
                         os.path.join(out_dir, "telemetry_sigusr2_boxes"),
                         hosts_file)
    watch._list_hosts()
    cfg = {"model": model_name, "device": dev, "batch": batch, "seq": seq,
           "steps": steps, "persist_every": 0, "qmin": None,
           "final_check": False, "loss_allreduce": True,
           "persist_at_exit": True}
    if model_name == "gpt_medium":
        cfg["layers"] = TELEMETRY_LAYERS
    t_run = time.time()
    rc, wall, events, inj, log = run_elastic_job(
        work, cfg, plan,
        env_extra={**TELEMETRY_ENV, "HVD_TPU_FLIGHTREC_DIR": box_dir,
                   **(env_extra or {})},
        timeout=timeout, output=launcher_log, hosts=TELEMETRY_HOSTS,
        nps=(3, 2, 3),
        launcher_args=["--metrics-port", "0", "--pod-metrics-port", "0",
                       "--autoscale-policy", json.dumps(policy),
                       "--autoscale-log", decision_log,
                       "--host-discovery-script", discover],
        watch=watch.run)
    check(rc == 0, f"telemetry control run: exit {rc}:\n{log[-3000:]}")
    decisions = [json.loads(line) for _, line in watch.decisions]
    check(decisions and decisions[0]["action"] == "evict"
          and decisions[0]["target"] == "hostC"
          and decisions[0]["reason"] == "straggler",
          f"telemetry: first decision {decisions}")
    check(any(d["action"] == "grow" for d in decisions[1:]),
          f"telemetry: no grow after the eviction: {decisions}")
    finals = [e for evs in events.values() for e in evs
              if e["event"] == "final"]
    check(len(finals) == 3 and all(e["step"] == steps for e in finals),
          f"telemetry: final events {finals}")
    worlds = _world_sequence(events)
    check(worlds == [3, 2, 3], f"telemetry: world sizes {worlds}")
    restores = [(e["step"], e["digest_ok"]) for evs in events.values()
                for e in evs if e["event"] == "restore"]
    check(restores and all(ok for _, ok in restores),
          f"telemetry: a restore differs from its commit: {restores}")
    t_evict = watch.decisions[0][0]
    t_grow = next(t for t, line in watch.decisions
                  if json.loads(line)["action"] == "grow")
    host_rank = {w["host"]: w["rank"] for w in watch.workers.values()
                 if w["n"] == 3}
    before = [v for t, v, _ in watch.pod if t < t_evict]
    check(any(v["ranks"] == [0, 1, 2] and v["slowest_rank"] ==
              host_rank["hostC"] and v["step_skew_seconds"] > 0
              for v in before),
          f"telemetry: the pod view never named hostC (rank "
          f"{host_rank.get('hostC')}) slowest of 3 before the eviction: "
          f"{[(v['ranks'], v['slowest_rank']) for v in before][-5:]}")
    check(any(len(v["ranks"]) == 2 for t, v, _ in watch.pod
              if t_evict < t < t_grow),
          "telemetry: the pod view never saw 2 ranks after the eviction")
    b_warn = max((r["warnings"] for r in watch.worker_scrapes.values()
                  if r["host"] == "hostB"), default=0)
    check(b_warn >= 1, f"telemetry: hostB's stall warnings {b_warn}")
    check(watch.worker_scrapes and all(
        r["labels"] for r in watch.worker_scrapes.values()),
          f"telemetry: unlabeled /metrics: {watch.worker_scrapes}")
    # Every SIGUSR2 box: written by the signaled process, which went on
    # stepping, and accepted by flight_diff's validator.
    check(watch.signaled is not None and len(watch.boxes) == 3,
          f"telemetry: SIGUSR2 boxes {watch.boxes} (signaled "
          f"{watch.signaled})")
    sig_pids = set(watch.signaled["pids"])
    check(all(trig == "sigusr2" and pid in sig_pids
              for _, trig, pid in watch.boxes),
          f"telemetry: SIGUSR2 boxes {watch.boxes}")
    after = {e["pid"] for evs in events.values() for e in evs
             if e["event"] == "step" and e["t"] > watch.signaled["t"]}
    check(sig_pids <= after,
          f"telemetry: a signaled worker stopped stepping: {sig_pids - after}")
    fd = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "flight_diff.py"),
         "--json", watch.box_copy], capture_output=True, text=True,
        timeout=60)
    check(fd.returncode == 0 and "skipping" not in fd.stderr,
          f"telemetry: flight_diff rc {fd.returncode}: {fd.stderr[-2000:]}")
    report = json.loads(fd.stdout)
    check(report["ranks"] == [0, 1, 2], f"flight_diff ranks {report}")
    commits = [e["commit_ms"] for evs in events.values() for e in evs
               if e["event"] == "step"]
    evict_n2 = _first_step_after(events, t_evict, 2)
    grow_n3 = _first_step_after(events, t_grow, 3)
    launches = next((e["launches"] for e in sorted(
        events.get(0, []), key=lambda e: e["t"])
        if e["event"] in ("exit", "final")), {})
    pod_before = [v for v in before if v["ranks"] == [0, 1, 2]]
    return {
        "label": "gloo, 3 processes on one card (not NCCL or NVLink)",
        "model": model_name, "layers": cfg.get("layers"),
        "batch_per_rank": batch, "seq_len": seq,
        "steps": steps, "wall_s": wall, "decisions": decisions,
        "decision_seen_s": [t - t_run for t, _ in watch.decisions],
        "worlds": worlds, "restores": restores,
        "evict_to_first_n2_step_s": evict_n2 - t_evict,
        "grow_to_first_n3_step_s": grow_n3 - t_grow,
        "commit_ms_median": statistics.median(commits),
        "peak_gib_max": max(e.get("peak_gib", 0) for evs in events.values()
                            for e in evs),
        "scrape_ms_median": statistics.median(
            [secs * 1e3 for _, _, secs in watch.pod]),
        "scrape_ms_max": max(secs * 1e3 for _, _, secs in watch.pod),
        "pod_scrapes": len(watch.pod),
        "pod_slowest_rank_before_evict": pod_before[-1]["slowest_rank"],
        "pod_skew_s_before_evict": pod_before[-1]["step_skew_seconds"],
        "pod_step_time_s_before_evict":
            pod_before[-1]["step_time_seconds"],
        "hostB_stall_warnings": b_warn,
        "sigusr2_boxes": [(os.path.basename(p), t, pid)
                          for p, t, pid in watch.boxes],
        "flight_diff_ranks": report["ranks"],
        "injections": inj, "launches": launches}


def phase_telemetry(torch, out_dir: str) -> dict:
    """Phase 9: (a) what telemetry costs a training step, (b) the control
    run. Returns the record with ``launches``: (b)'s rank 0 first
    process's counts."""
    import shutil
    import tempfile

    parent = _free_parent(torch)
    root = tempfile.mkdtemp(prefix="hvd_telemetry_")
    t0 = time.perf_counter()
    try:
        over = telemetry_overhead(root, out_dir)
        t1 = time.perf_counter()
        ctl = telemetry_control(root, out_dir)
    finally:
        for name in ("faults.jsonl", "decisions.jsonl", "events.rank0.jsonl",
                     "events.rank1.jsonl", "events.rank2.jsonl"):
            src = os.path.join(root, "control", name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, f"telemetry_{name}"))
        shutil.rmtree(root, ignore_errors=True)
    res = {"label": ctl["label"], "parent_gib": parent, "overhead": over,
           "control": ctl, "launches": ctl["launches"],
           "overhead_s": t1 - t0, "control_s": time.perf_counter() - t1}
    with open(os.path.join(out_dir, "chip_smoke_telemetry.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"telemetry (a) (1 process): step {over['step_ms_median_off']:.1f}"
          f" ms off, {over['step_ms_median_on']:.1f} ms on (median of "
          f"{TRAIN_STEPS}); losses bitwise equal; {over['scrapes']} "
          f"scrapes, {over['scrape_ms_median']:.2f} ms median", flush=True)
    print(f"telemetry (b) (gloo, 3 processes on one card): decisions "
          f"{[(d['action'], d['target'], d['reason']) for d in ctl['decisions']]}"
          f", worlds {ctl['worlds']}; eviction -> first n=2 step "
          f"{ctl['evict_to_first_n2_step_s']:.1f} s, grow -> first n=3 step "
          f"{ctl['grow_to_first_n3_step_s']:.1f} s; commit "
          f"{ctl['commit_ms_median']:.2f} ms; peak "
          f"{ctl['peak_gib_max']:.2f} GiB a rank; /pod/metrics.json "
          f"{ctl['scrape_ms_median']:.2f} ms median; hostB stall warnings "
          f"{ctl['hostB_stall_warnings']:.0f}; wall {ctl['wall_s']:.1f} s",
          flush=True)
    return res


# -- phase 10: autotune over ssh ------------------------------------------------

# An LSF allocation of two hosts that are this machine (Linux routes all
# of 127/8 to loopback; neither name is one the launcher takes for this
# machine, so it fans out over ssh).
AUTOTUNE_LSF = "127.0.0.2 1 127.0.0.3 1"
# model, per-rank batch, sequence length, stepper calls (at most)
AUTOTUNE_RUN = ("gpt_medium", 4, 512, 30)
AUTOTUNE_ENV = {"LSB_JOBID": "smoke", "LSB_MCPU_HOSTS": AUTOTUNE_LSF,
                "HVD_TPU_NIC_DISCOVERY": "1",
                "HVD_TPU_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE": "2"}
AUTOTUNE_TIMEOUT = 420              # seconds the launcher run may take
# The ssh of phase 10: logs its argv, drops the options, runs the
# remote command on this machine (exec: signals reach the worker).
FAKE_SSH = """#!/bin/bash
printf '%s\\n' "$*" >> {log}
args=()
while [[ $# -gt 0 ]]; do
  case $1 in
    -o|-p) shift 2;;
    *) args+=("$1"); shift;;
  esac
done
exec bash -c "${{args[*]:1}}"
"""


def autotune_worker(cfg_path: str) -> None:
    """One rank of phase 10 (``--autotune-worker CFG``), started over ssh
    by the launcher: int8_ef AdamW under ``hvd.AutotunedStepper`` over
    the context's tuner, each move a ``replan`` of the live optimizer
    (the leaf-wise residual compared across it); writes the build calls,
    each call's threshold, buckets, ms and loss, the re-plan ms, its
    ``/metrics`` readings, the peak GiB and the kernel launches."""
    import time as time_mod
    import urllib.request

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import kernels as K

    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = hvd.init(device="cpu") if dev == "cpu" else \
        hvd.init(backend="gloo")
    rank = hvd.rank()
    model = _make_model(torch, gpt_mod, cfg["model"], dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), compression="int8_ef")
    first_threshold = opt.fusion_threshold
    rec = {"builds": [], "replan_ms": [], "leaf_checks": 0,
           "leaf_equal": True, "calls": []}

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def step(tokens):
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]),
                                       tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    def build(threshold):
        rec["builds"].append(threshold)
        if len(rec["builds"]) > 1:
            before = opt._ef_by_leaf()      # views of the old buffers
            sync()
            t = time_mod.perf_counter()
            opt.replan(threshold)
            sync()
            rec["replan_ms"].append((time_mod.perf_counter() - t) * 1e3)
            after = opt._ef_by_leaf()
            rec["leaf_checks"] += len(before)
            rec["leaf_equal"] &= all(torch.equal(after[i], r)
                                     for i, r in before.items())
        return step

    stepper = hvd.AutotunedStepper(
        build, grad_bytes=sum(p.numel() * 4 for p in model.parameters()))
    for i in range(cfg["calls"]):
        tokens = torch.randint(
            0, model.vocab_size, (cfg["batch"], cfg["seq"] + 1),
            generator=torch.Generator().manual_seed(1000 * i + rank)).to(dev)
        threshold = stepper.fusion_threshold
        buckets = len(opt._dist_plan.buckets)
        replans = len(rec["replan_ms"])
        t0 = time_mod.perf_counter()
        loss = stepper(tokens)
        ms = (time_mod.perf_counter() - t0) * 1e3 - sum(
            rec["replan_ms"][replans:])
        rec["calls"].append({"threshold": threshold, "buckets": buckets,
                             "ms": ms, "loss": loss.item()})
        if stepper._tuner_done:
            break
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" \
        else 0.0
    # The deciding rank's last search scored EI with the C++ GP core
    # (native/gp_core.cc): hold it against the numpy EI of the same fit.
    search = ctx.autotuner.last_search
    check(rank != 0 or search is not None,
          "autotune: rank 0's tuner made no search")
    if search is not None:
        from horovod_tpu_torch.common.autotune import numpy_ei

        xs, ys, grid, ei, used_native = search
        ref = numpy_ei(xs, ys, grid)
        check(used_native, "autotune: the EI did not come from gp_core")
        check(bool(np.allclose(ei, ref, rtol=1e-5, atol=1e-7)),
              f"autotune: gp_core EI off the numpy EI by "
              f"{float(np.abs(np.asarray(ei) - ref).max())}")
        rec["gp_core_ei"] = {"candidates": len(ref), "samples": len(ys),
                             "max_abs_diff": float(np.abs(
                                 np.asarray(ei) - ref).max())}
    with urllib.request.urlopen(
            f"http://127.0.0.1:{ctx.metrics_port}/metrics", timeout=10) as r:
        text = r.read().decode()
    metrics = {fam: [v for v, _ in _labeled(text, fam)] for fam in (
        "hvd_tpu_autotune_threshold_bytes",
        "hvd_tpu_autotune_rebuilds_total",
        "hvd_tpu_autotune_converged")}
    rec.update(rank=rank, first_threshold=first_threshold,
               threshold=stepper.fusion_threshold,
               rebuilds=stepper.rebuilds, done=stepper._tuner_done,
               peak_gib=peak, metrics=metrics, launches=dict(K.LAUNCHES),
               coordinator=os.environ.get("HVD_TPU_COORDINATOR"),
               host=os.environ.get("HVD_TPU_HOSTNAME"))
    with open(os.path.join(cfg["workdir"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    hvd.shutdown()


def autotune_run(out_dir: str, dev: str = "cuda", run=AUTOTUNE_RUN,
                 env_extra=None) -> dict:
    """Phase 10's launcher run and its checks (see the docstring); the
    record with ``launches``, rank 0's kernel launches."""
    import glob
    import re

    model, batch, seq, calls = run
    work = os.path.abspath(os.path.join(out_dir, "autotune"))
    os.makedirs(work, exist_ok=True)
    for old in glob.glob(os.path.join(work, "*")):
        os.remove(old)
    ssh_log = os.path.join(work, "ssh.log")
    with open(os.path.join(work, "ssh"), "w") as f:
        f.write(FAKE_SSH.format(log=ssh_log))
    os.chmod(os.path.join(work, "ssh"), 0o755)
    csv_path = os.path.join(work, "autotune.csv")
    cfg_path = os.path.join(work, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"device": dev, "model": model, "batch": batch,
                   "seq": seq, "calls": calls, "workdir": work}, f)
    env = {**os.environ, **AUTOTUNE_ENV, **(env_extra or {}),
           "PATH": f"{work}:{os.environ['PATH']}"}
    for var in ("LSB_DJOB_HOSTFILE", "LSB_HOSTS", "HVD_TPU_FAULT_PLAN"):
        env.pop(var, None)
    argv = launcher_argv("-np", "2", "--autotune", "--autotune-log-file",
                         csv_path, "--metrics-port", "0", "--",
                         *worker_argv("--autotune-worker", cfg_path))
    log_path = os.path.join(work, "launcher.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(argv, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)))
        try:
            rc = proc.wait(timeout=AUTOTUNE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    check(rc == 0, f"autotune run: exit {rc}:\n{text[-3000:]}")
    ranks = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    # The launch: LSF's hosts, a task server and a worker on each.
    with open(ssh_log) as f:
        lines = f.read().splitlines()
    servers = [ln for ln in lines if "driver_service --serve" in ln]
    workers = [ln for ln in lines if "--autotune-worker" in ln]
    check(len(servers) == 2 and len(workers) == 2,
          f"autotune: ssh log {len(servers)} task servers, {len(workers)} "
          f"workers:\n" + "\n".join(lines)[-2000:])
    check(all(any(ln.split()[2] == h for ln in workers)
              for h in ("127.0.0.2", "127.0.0.3")),
          "autotune: the workers did not start on LSF's hosts")
    check([r["host"] for r in ranks] == ["127.0.0.2", "127.0.0.3"],
          f"autotune: ranks on {[r['host'] for r in ranks]}")
    m = re.search(r"coordinator (\S+) \((NIC discovery|first host)\)",
                  text)
    check(m is not None, "autotune: the launcher named no coordinator")
    coordinator, discovered = m.group(1), m.group(2) == "NIC discovery"
    check(all(r["coordinator"] == coordinator for r in ranks),
          "autotune: a worker met another coordinator")
    # The search and its adoption.
    r0, r1 = ranks
    check(r0["builds"] == r1["builds"],
          f"autotune: build calls differ: {r0['builds']} / {r1['builds']}")
    moves = sum(a != b for a, b in zip(r0["builds"], r0["builds"][1:]))
    check(r0["rebuilds"] == r1["rebuilds"] == moves == len(r0["builds"]) - 1,
          f"autotune: rebuilds {r0['rebuilds']}, {r1['rebuilds']} for "
          f"{moves} moves")
    with open(csv_path) as f:
        rows = f.read().splitlines()
    from horovod_tpu_torch.common.autotune import DEFAULT_CANDIDATES

    tried = {int(row.split(",")[1]) for row in rows[1:]}
    check(rows[0] == "unix_time,threshold_bytes,score_bytes_per_sec,steps"
          and tried == set(DEFAULT_CANDIDATES),
          f"autotune: CSV rows for {sorted(tried)}")
    check(r0["leaf_equal"] and r0["leaf_checks"] > 0,
          f"autotune: leaf-wise residual moved ({r0['leaf_checks']} "
          "leaves checked)")
    losses = [c["loss"] for r in ranks for c in r["calls"]]
    check(all(math.isfinite(x) for x in losses), "autotune: a loss is "
          "not finite")
    for r in ranks:
        mt = r["metrics"]
        check(mt["hvd_tpu_autotune_threshold_bytes"] == [r["threshold"]]
              and mt["hvd_tpu_autotune_rebuilds_total"] == [r["rebuilds"]],
              f"autotune: rank {r['rank']} /metrics {mt} for threshold "
              f"{r['threshold']}, {r['rebuilds']} rebuilds")
    if dev == "cuda":
        on_path = ("quantize_int8_stochastic",) + FLASH_NAMES
        check(all((n > 0) == (k in on_path)
                  for k, n in r0["launches"].items()),
              f"autotune rank 0: launches {r0['launches']}, expected K3 "
              "and K5-K7 only")
    # Step ms at each threshold: the sample's scored calls (after its
    # warmup call); buckets.
    period = 1 + 2
    per = {}
    for i, c in enumerate(r0["calls"]):
        entry = per.setdefault(c["threshold"], {"buckets": c["buckets"],
                                                "ms": []})
        if i % period:
            entry["ms"].append(c["ms"])
    res = {"label": "gloo, 2 processes on one card (ssh fan-out)",
           "model": model, "batch": batch, "seq": seq,
           "calls": len(r0["calls"]), "builds": r0["builds"],
           "thresholds": {str(t): v for t, v in sorted(per.items())},
           "chosen": r0["threshold"], "converged": r0["done"],
           "gp_core_ei": r0.get("gp_core_ei"),
           "replan_ms": r0["replan_ms"],
           "replan_ms_median": statistics.median(r0["replan_ms"])
           if r0["replan_ms"] else None,
           "leaf_checks": r0["leaf_checks"], "coordinator": coordinator,
           "discovered": discovered, "csv_rows": len(rows) - 1,
           "peak_gib": [r["peak_gib"] for r in ranks],
           "launches": r0["launches"], "wall_s": wall}
    return res


def phase_autotune(torch, out_dir: str) -> dict:
    """Phase 10 (see the docstring)."""
    parent = _free_parent(torch)
    t0 = time.perf_counter()
    res = autotune_run(out_dir)
    res["parent_gib"] = parent
    res["phase_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "chip_smoke_autotune.json"), "w") as f:
        json.dump(res, f, indent=1)
    steps = ", ".join(
        f"{int(t) >> 20} MiB {statistics.median(v['ms']):.1f} ms "
        f"({v['buckets']} buckets)" for t, v in res["thresholds"].items()
        if v["ms"])
    print(f"autotune ({res['label']}): {steps}; chosen "
          f"{res['chosen'] >> 20} MiB, converged {res['converged']}; "
          f"EI from gp_core {json.dumps(res['gp_core_ei'])}; "
          f"re-plan {res['replan_ms_median']:.1f} ms median; coordinator "
          f"{res['coordinator']} "
          f"({'discovery' if res['discovered'] else 'first host'}); peak "
          f"{max(res['peak_gib']):.2f} GiB a rank; {res['phase_s']:.1f} s",
          flush=True)
    return res


# -- phase 11: parallel roles (tensor and sequence parallelism) -------------

PARALLEL_CONFIG = "n4_parallel"
# n, model, global batch (rows), sequence length, worker time limit (s)
PARALLEL_RUN = (4, "gpt_medium", 4, 1024, 900)
# label, ParallelSpec, GPT options: the same seeded weights and global
# batch on every arm; "dense" is the oracle.
PARALLEL_ARMS = (
    ("dense", "dp=4", {}),
    ("tp", "dp=2,tp=2", {"tp_axis": "tp"}),
    ("ring", "dp=2,sp=2", {"seq_parallel": "sp", "seq_impl": "ring",
                           "seq_wire": "none"}),
    ("ulysses", "dp=2,sp=2", {"seq_parallel": "sp",
                              "seq_impl": "ulysses", "seq_wire": "none"}),
    ("ring_int8", "dp=2,sp=2", {"seq_parallel": "sp", "seq_impl": "ring",
                                "seq_wire": "int8"}),
)
PARALLEL_STEPS = 3                  # 1 checked + 2 timed AdamW steps
# Each arm's global loss against dense's, relative: bf16 compute whose
# matmuls and attention split differently (the ZeRO phase's 1e-3, doubled
# for the changed reduction shapes); the int8 K/V wire re-quantizes every
# hop (the JAX tests hold its attention output within 0.15 of the exact
# one), so its bound is ten times wider.
PARALLEL_LOSS_RTOL = {"tp": 2e-3, "ring": 2e-3, "ulysses": 2e-3,
                      "ring_int8": 2e-2}
RING_CHECK_SHAPE = SP_BLOCK         # (2, 512, 16, 64): one striped block


def _parallel_tokens(torch, rows: int, seq: int, vocab: int, dev: str):
    """The one seeded global batch every arm trains on (rows, seq + 1)."""
    return torch.randint(0, vocab, (rows, seq + 1), generator=torch
                         .Generator().manual_seed(1515)).to(dev)


def _parallel_shard(ring, spec, rank: int, tokens, kw):
    """This rank's inputs and targets (``parallel.mesh.local_batch``):
    rows by the dp coordinate, the sequence by the sp coordinate, in
    stripe order for the ring."""
    from horovod_tpu_torch.parallel.mesh import local_batch

    x, y = tokens[:, :-1], tokens[:, 1:]
    if kw.get("seq_impl") == "ring":
        n = spec.size_of("sp")
        x, y = ring.stripe_layout(x, n), ring.stripe_layout(y, n)
    return (local_batch(x, spec, rank).contiguous(),
            local_batch(y, spec, rank).contiguous())


def _parallel_arm(torch, hvd, gpt_mod, C, K, ring, label, spec_str, kw,
                  rank, dev) -> dict:
    """One arm: 1 checked and 2 timed AdamW steps of GPT-2 medium under
    ``DistributedOptimizer(parallel=)``; the launch counts zeroed just
    before the steps and read just after; every rank's parameters
    bitwise rank 0's after every step; the global loss each step and
    after the last."""
    _, model_name, rows, seq, _ = PARALLEL_RUN
    spec = hvd.parallel_spec()
    model = _make_model(torch, gpt_mod, model_name, dev, **kw)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    tokens = _parallel_tokens(torch, rows, seq, model.vocab_size, dev)
    x, y = _parallel_shard(ring, spec, rank, tokens, kw)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), parallel=spec_str)

    def global_loss(loss) -> float:
        return C.allreduce(loss.detach().reshape(1).float(),
                           hvd.Average).item()

    def replicas_equal() -> bool:
        every = C.all_gather_stack(digest(params))
        return bool((every == every[0]).all())

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(torch, dev)
    hvd.barrier()
    K.reset_launch_counts()
    b0 = dict(C.PARALLEL_BYTES)
    losses, times, equal = [], [], []
    for _ in range(PARALLEL_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = gpt_mod.next_token_loss(model(x), y)
        loss.backward()
        opt.step()
        _sync(torch, dev)
        times.append(time.perf_counter() - t0)
        losses.append(global_loss(loss))
        equal.append(replicas_equal())
    launches = dict(K.LAUNCHES)
    moved = {k: (C.PARALLEL_BYTES[k] - b0[k]) / PARALLEL_STEPS
             for k in b0}
    with torch.no_grad():
        final = global_loss(gpt_mod.next_token_loss(model(x), y))
    peak, _ = _mem(torch, dev)
    check(all(map(math.isfinite, losses + [final])),
          f"parallel {label}: non-finite loss in {losses + [final]}")
    check(all(equal), f"parallel {label}: the replicated masters differ "
                      f"across ranks after step(s) "
                      f"{[i for i, e in enumerate(equal) if not e]}")
    blocks = spec.size_of("sp") if kw.get("seq_impl") == "ring" else 1
    flash = model.num_layers * blocks * PARALLEL_STEPS
    want = dict(flash_fwd=flash, flash_bwd_dq=flash, flash_bwd_dkv=flash)
    if kw.get("seq_wire") == "int8":
        # n - 1 = 1 hop each of K and V a layer, forward and backward.
        hops = 2 * 2 * (spec.size_of("sp") - 1) * model.num_layers
        want.update(quantize_int8=hops * PARALLEL_STEPS,
                    dequantize_int8=hops * PARALLEL_STEPS)
    _expect(launches, f"parallel {label}", **want)
    grads = sum(p.numel() * 4 for p in params)
    combine = sum(2 * (spec.size_of(r) - 1) / spec.size_of(r) * grads
                  for r in ("tp", "sp") if spec.size_of(r) > 1)
    ndp = spec.size_of("dp")
    rec = {"arm": label, "spec": spec_str,
           **{k: str(v) for k, v in kw.items()},
           "rows_per_rank": x.shape[0], "seq_per_rank": x.shape[1],
           "losses": losses, "final_loss": final,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_median": statistics.median(times[1:]) * 1e3,
           "launches": launches,
           "launches_per_step": {k: v / PARALLEL_STEPS
                                 for k, v in launches.items() if v},
           "seq_bytes_per_step": moved["seq"],
           "tp_bytes_per_step": moved["tp"],
           "combine_bytes_per_step": combine,
           "dp_bytes_per_step": 2 * (ndp - 1) / ndp * grads,
           "replicas_equal": equal, "peak_mem_gib": peak}
    release(torch, opt, dev)
    del model, opt, params, digest
    return rec


def _parallel_adasum(torch, hvd, gpt_mod, C, K, ring, spec_str, kw, rank,
                     dev) -> dict:
    """The tp arm's world again: one checked AdamW step under
    ``DistributedOptimizer(op=Adasum, parallel=dp=2,tp=2)`` (each
    gradient combined over tp, each delta's Adasum over dp through the
    router): K8 and K9 once a parameter (one Adasum level over the dp
    pair), and the masters bitwise equal on all four ranks."""
    _, model_name, rows, seq, _ = PARALLEL_RUN
    spec = hvd.parallel_spec()
    model = _make_model(torch, gpt_mod, model_name, dev, **kw)
    params = list(model.parameters())
    digest = _Digest(torch, params)
    tokens = _parallel_tokens(torch, rows, seq, model.vocab_size, dev)
    x, y = _parallel_shard(ring, spec, rank, tokens, kw)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), op=hvd.Adasum,
        parallel=spec_str)
    loss = gpt_mod.next_token_loss(model(x), y)
    loss.backward()
    _sync(torch, dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    opt.step()
    _sync(torch, dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    every = C.all_gather_stack(digest(params))
    equal = bool((every == every[0]).all())
    loss = C.allreduce(loss.detach().reshape(1).float(), hvd.Average).item()
    check(equal and math.isfinite(loss),
          f"parallel adasum: masters equal {equal}, loss {loss}")
    _expect(launches, "parallel adasum", adasum_dot_norms=len(params),
            adasum_combine=len(params))
    del model, opt, params, digest, every
    import gc

    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"spec": spec_str, "loss": loss, "masters_equal": equal,
            "step_call_ms": step_ms,
            "launches": {k: v for k, v in launches.items() if v}}


def _ring_check(torch, hvd, C, ring, rank, dev) -> dict:
    """The striped ring over the sp axis with the kernels against the
    same ring with plain blocks (``use_flash=False``) on the same bf16
    inputs at one striped block's shape: output and q/k/v gradients
    within the bf16 flash bound. Launches here compare; they are not
    counted on the path."""
    gen = torch.Generator(device=dev).manual_seed(700 + rank)
    shape = RING_CHECK_SHAPE
    base = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(4)]
    outs = {}
    for flash in (True, False):
        q, k, v = (t.clone().requires_grad_(True) for t in base[:3])
        o = ring.striped_attention(q, k, v, "sp", use_flash=flash,
                                   wire="none")
        (o.float() * base[3].float()).sum().backward()
        outs[flash] = [o.detach(), q.grad, k.grad, v.grad]
    tol = FLASH_TOL["bfloat16"][1]
    errs = {}
    for name, got, want in zip(("o", "dq", "dk", "dv"), outs[True],
                               outs[False]):
        errs[name] = close_err(torch, got, want, tol,
                               f"parallel ring kernels vs plain {name}")
    return {"shape": list(shape), "max_abs_err": errs, "tol": tol}


def parallel_worker(config: str, rank: int, out_path: str,
                    dev: str = "cuda") -> None:
    """One rank of phase 11 (``--rank-worker n4_parallel``): every arm in
    turn, each in a world made with its spec (``init(parallel=)``), the
    memory released between them."""
    import importlib

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    ring = importlib.import_module(
        "horovod_tpu_torch.parallel.ring_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = PARALLEL_RUN[0]
    out = {"config": config, "rank": rank, "arms": {}}
    for label, spec, kw in PARALLEL_ARMS:
        ctx = hvd.init(backend="gloo", parallel=spec) if dev == "cuda" \
            else hvd.init(device="cpu", parallel=spec)
        check(hvd.size() == n and hvd.rank() == rank
              and hvd.parallel_spec().describe() == spec,
              f"parallel {label}: rank {hvd.rank()} of {hvd.size()}, "
              f"spec {hvd.parallel_spec()}")
        rec = _parallel_arm(torch, hvd, gpt_mod, C, K, ring, label, spec,
                            kw, rank, dev)
        rec["backend"] = ctx.backend
        rec["role"] = ctx.flightrec.role if ctx.flightrec else ""
        if label == "ring":
            rec["kernels_vs_plain"] = _ring_check(torch, hvd, C, ring, rank,
                                                  dev)
        if label == "tp":
            rec["adasum"] = _parallel_adasum(torch, hvd, gpt_mod, C, K, ring,
                                             spec, kw, rank, dev)
        out["arms"][label] = rec
        print(f"rank {rank} parallel {label} ({spec}): losses "
              f"{rec['losses']} final {rec['final_loss']}, step ms "
              f"{rec['step_ms']}, launches {rec['launches']}", flush=True)
        hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_parallel(torch, out_dir: str) -> dict:
    """Phase 11: the four rank workers of the parallel-roles arms on the
    one card. Returns the phase's record with ``launches``, the path's
    counts summed over the arms."""
    n, model_name, rows, seq, timeout = PARALLEL_RUN
    os.makedirs(out_dir, exist_ok=True)
    parent = _free_parent(torch)
    ranks, wall = run_workers(PARALLEL_CONFIG, n, timeout, out_dir)
    res = {"n": n, "model": model_name, "global_batch": [rows, seq],
           "wall_s": wall, "parent_gib": parent,
           "label": "gloo, 4 processes on one card (not NCCL or NVLink)",
           "arms": {}}
    dense = ranks[0]["arms"]["dense"]
    launches = {}
    for label, spec, kw in PARALLEL_ARMS:
        recs = [rk["arms"][label] for rk in ranks]
        check(all(rc["launches"] == recs[0]["launches"] for rc in recs),
              f"parallel {label}: ranks counted different launches")
        check(all(rc["losses"] == recs[0]["losses"] for rc in recs),
              f"parallel {label}: ranks saw different global losses")
        for k, v in recs[0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        first = abs(recs[0]["losses"][0] - dense["losses"][0]) \
            / abs(dense["losses"][0])
        last = abs(recs[0]["final_loss"] - dense["final_loss"]) \
            / abs(dense["final_loss"])
        if label != "dense":
            bound = PARALLEL_LOSS_RTOL[label]
            check(first <= bound and last <= bound,
                  f"parallel {label}: loss off dense's by {first:.2e} "
                  f"(first step) and {last:.2e} (after the last) > {bound}")
        step_ms = statistics.median(rc["step_ms_median"] for rc in recs)
        m = res["arms"][label] = {
            "spec": spec, **{k: str(v) for k, v in kw.items()},
            "step_ms_median": step_ms, "step_ms_rank0": recs[0]["step_ms"],
            "tokens_per_s": rows * seq / (step_ms / 1e3),
            "losses": recs[0]["losses"], "final_loss": recs[0]["final_loss"],
            "first_loss_rel_to_dense": first,
            "final_loss_rel_to_dense": last,
            "launches": recs[0]["launches"],
            "launches_per_step": recs[0]["launches_per_step"],
            "seq_bytes_per_step": recs[0]["seq_bytes_per_step"],
            "tp_bytes_per_step": recs[0]["tp_bytes_per_step"],
            "combine_bytes_per_step": recs[0]["combine_bytes_per_step"],
            "dp_bytes_per_step": recs[0]["dp_bytes_per_step"],
            "peak_mem_gib": max(rc["peak_mem_gib"] for rc in recs),
            "roles": [rc["role"] for rc in recs],
            "kernels_vs_plain": recs[0].get("kernels_vs_plain")}
        print(f"parallel {label} ({spec}; gloo, 4 processes on one card): "
              f"gpt_medium {rows} x {seq} global, {recs[0]['rows_per_rank']}"
              f" x {recs[0]['seq_per_rank']} a rank; step {step_ms:.1f} ms "
              f"= {m['tokens_per_s']:.0f} tok/s; loss {m['losses']} final "
              f"{m['final_loss']:.6f} (vs dense {first:.2e}, {last:.2e}); "
              f"launches a step {json.dumps(m['launches_per_step'])}; bytes "
              f"a step: seq {m['seq_bytes_per_step']:.0f}, tp "
              f"{m['tp_bytes_per_step']:.0f}, combine "
              f"{m['combine_bytes_per_step']:.0f}, dp "
              f"{m['dp_bytes_per_step']:.0f}; peak {m['peak_mem_gib']:.2f} "
              f"GiB a rank; roles {m['roles']}", flush=True)
        if m["kernels_vs_plain"]:
            print(f"parallel ring kernels vs plain at "
                  f"{tuple(RING_CHECK_SHAPE)} bf16 over sp: max abs err "
                  f"{json.dumps(m['kernels_vs_plain']['max_abs_err'])}",
                  flush=True)
    res["launches"] = launches
    with open(os.path.join(out_dir, "chip_smoke_parallel.json"), "w") as f:
        json.dump(dict(res, ranks=ranks), f, indent=1)
    return res


# -- phase 12: pipeline and MoE ------------------------------------------------

PIPE_CONFIG = "n4_pipeline"
MOE_REF_CONFIG = "n2_moe_ref"
PIPE_TIMEOUT = 900                  # seconds a worker launch may take
# GPT-2 medium's widths; each family's depth, global batch (rows x seq),
# microbatches a dp replica and token seed. MoE: 8 experts at capacity
# factor 1.25, top-2, router noise 0 (the repo's documented --moe
# 8,1.25), 12 of 24 layers: the expert bank is replicated on every rank,
# so a pp=2 stage at full depth would hold ~908 M parameters a rank.
PIPE_WIDTHS = dict(hidden=1024, num_heads=16, mlp_dim=4096, vocab_size=50257)
PIPE_FAMILIES = {
    "pipe": {"layers": 24, "rows": 8, "seq": 1024, "accum": 4,
             "seed": 1616, "moe": {}},
    "moe": {"layers": 12, "rows": 4, "seq": 1024, "accum": 4,
            "seed": 1717, "moe": {"moe_experts": 8,
                                  "moe_capacity_factor": 1.25}},
}
# label, family, ParallelSpec, init() settings, GPT options, optimizer.
PIPE_ARMS = (
    ("dense", "pipe", "dp=4", {}, {}, "dist"),
    ("pp", "pipe", "dp=2,pp=2", {}, {}, "dist"),
    ("pp_int8", "pipe", "dp=2,pp=2", {"pp_wire": "int8"}, {}, "dist"),
    ("pp_zero3", "pipe", "dp=2,pp=2", {}, {}, "zero3"),
    ("moe_ep", "moe", "dp=1,pp=2,ep=2", {}, {"moe_axis": "ep"}, "dist"),
    ("moe_ep_int8", "moe", "dp=1,pp=2,ep=2", {},
     {"moe_axis": "ep", "moe_wire": "int8"}, "dist"),
)
MOE_REF_ARMS = (("moe_ref", "moe", "dp=1,pp=2", {}, {}, "dist"),)
PIPE_STEPS = 3                      # 1 warm-up + 2 timed AdamW steps
# Each arm's global loss (first step, after the last) against its
# oracle's, relative. The H100 readings (the same in every run so far):
# pp 0 / 2.78e-6, pp_int8 1.82e-5 / 1.20e-5, pp_zero3 0 / 0, moe_ep
# 0 / 6.43e-4, moe_ep_int8 2.01e-4 / 2.09e-3. The bounds keep about 5x
# to 40x headroom over them: pp 1e-4 (bf16 compute split by stage),
# pp_int8 5e-4 (int8 on every stage-boundary send), ZeRO-3 against the
# replicated pp arm (the ZeRO phase's 1e-3), moe_ep 2e-3 and moe_ep_int8
# 1e-2 (the experts' bf16 FFN on other ranks, int8 dispatch).
PIPE_LOSS_RTOL = {"pp": ("dense", 1e-4), "pp_int8": ("dense", 5e-4),
                  "pp_zero3": ("pp", 1e-3), "moe_ep": ("moe_ref", 2e-3),
                  "moe_ep_int8": ("moe_ref", 1e-2)}


def _pipe_launches(fam: dict, spec, kw: dict, init_kw: dict) -> dict:
    """The launches a rank a step: each layer of this rank's stage runs
    K5 once in the forward slot and once in the backward's recompute, K6
    and K7 once, for each microbatch (dense: K5-K7 once a layer a
    microbatch); an int8 stage boundary quantizes each of the rank's
    ``accum`` sends with K2 and dequantizes each of its ``accum``
    receives with K4; an int8 ep exchange runs K2 and K4 on each of the
    two exchanges (dispatch, combine) of a MoE layer's three passes
    (forward slot, recompute, backward)."""
    npp = spec.size_of("pp")
    lps = fam["layers"] // npp
    micro = fam["rows"] // spec.size_of("dp")
    passes = micro * lps
    if npp == 1:
        want = dict(flash_fwd=passes, flash_bwd_dq=passes,
                    flash_bwd_dkv=passes)
    else:
        want = dict(flash_fwd=2 * passes, flash_bwd_dq=passes,
                    flash_bwd_dkv=passes)
    codec = 0
    if init_kw.get("pp_wire") == "int8":
        codec += micro
    if kw.get("moe_wire") == "int8":
        codec += 3 * 2 * passes
    if codec:
        want.update(quantize_int8=codec, dequantize_int8=codec)
    return want


def _metric_by_axis(metrics, name: str, **match) -> dict:
    """A counter family's values by its ``axis`` label (the samples whose
    other labels match)."""
    fam = metrics.registry().snapshot().get(name, {"samples": []})
    out = {}
    for smp in fam["samples"]:
        lab = smp["labels"]
        if all(lab.get(k) == v for k, v in match.items()):
            out[lab["axis"]] = out.get(lab["axis"], 0.0) + smp["value"]
    return out


def _delta_by_axis(before: dict, after: dict) -> dict:
    return {a: v - before.get(a, 0.0) for a, v in after.items()
            if v - before.get(a, 0.0) != 0.0}


def _pipe_bytes_predicted(C, fam, spec, kw, init_kw, model, opt,
                          optim_kind) -> dict:
    """The bytes a rank a step by kind, from the shapes: the stage
    boundary's sends (``accum`` payloads of 1 x seq x hidden a rank, in
    bf16 or int8 with its fp32 block scales), the ep exchanges the
    counter sees (the two forward exchanges of each MoE layer call, its
    forward slot and recompute: (n-1)/n of E x C x hidden), the same
    exchanges in the backward (on the wire, not counted), the pp sum of
    the shared gradients (fp32, ring-accounted), and the dp reduction
    (each bucket padded to the mesh and ring-accounted, as
    ``hvd_tpu_allreduce_bytes_total`` counts it)."""
    npp, ndp = spec.size_of("pp"), spec.size_of("dp")
    micro = fam["rows"] // ndp
    hidden = PIPE_WIDTHS["hidden"]
    pay = fam["seq"] * hidden
    wire = init_kw.get("pp_wire") or "none"
    out = {"pp_sends": micro * pay * C._wire_elem_bytes(wire, 2)
           if npp > 1 else 0.0}
    nep = spec.size_of("ep")
    ep_counted = 0.0
    if nep > 1 and fam["moe"]:
        e = fam["moe"]["moe_experts"]
        cap = int(fam["moe"]["moe_capacity_factor"] * fam["seq"] * 2 / e) or 1
        elem = C._wire_elem_bytes(kw.get("moe_wire") or "none", 2)
        per = (nep - 1) / nep * e * cap * hidden * elem
        ep_counted = per * 2 * 2 * micro * (fam["layers"] // npp)
    out["ep_alltoall_counted"] = ep_counted
    out["ep_alltoall_backward"] = ep_counted / 2
    shared = sum(p.numel() for n, p in model.named_parameters()
                 if not n.startswith("layers."))
    out["pp_combine"] = 2 * (npp - 1) / npp * shared * 4 if npp > 1 else 0.0
    dp = 0.0
    if optim_kind == "dist":
        for b in opt._dist_plan.buckets:
            padded = -(-b.total_elems // ndp) * ndp
            dp += 2 * (ndp - 1) / ndp * padded * 4
    else:
        # ZeRO's reduce-scatter, counted on each bucket's own length.
        for b in opt.shard_state.plan.buckets:
            dp += (ndp - 1) / ndp * b.total_elems * 4
    out["dp_reduce"] = dp
    return out


def _pipe_tokens(torch, fam: dict, dev: str):
    return torch.randint(0, PIPE_WIDTHS["vocab_size"],
                         (fam["rows"], fam["seq"] + 1),
                         generator=torch.Generator().manual_seed(
                             fam["seed"])).to(dev)


def _pipe_model(torch, gpt_mod, fam: dict, spec, rank: int, kw: dict,
                dev: str):
    """This rank's stage of the family's seeded model: the whole model is
    made from one seed (the same weights on every arm), split with
    ``stack_stage_params`` and dropped; the stage model holds only its
    layers and the shared embedding and final LayerNorm."""
    npp = spec.size_of("pp")
    s = spec.coords(rank).get("pp", 0)
    with torch.device(dev):
        full = gpt_mod.GPT(num_layers=fam["layers"], **PIPE_WIDTHS,
                           **fam["moe"], **(kw if npp == 1 else {}))
    full.init_weights(torch.Generator(device=dev).manual_seed(0))
    if npp == 1:
        return full, 0
    stages, shared = gpt_mod.stack_stage_params(full.state_dict(), npp)
    state = {**stages[s], **shared}
    del full, stages, shared
    with torch.device(dev):
        model = gpt_mod.GPT(num_layers=fam["layers"] // npp, **PIPE_WIDTHS,
                            **fam["moe"], **kw)
    model.load_state_dict(state)
    del state
    if dev == "cuda":
        torch.cuda.empty_cache()
    return model, s


def _pipe_arm(torch, hvd, gpt_mod, C, K, pl, moe_mod, metrics, label,
              fam_name, spec_str, init_kw, kw, optim_kind, rank,
              dev) -> dict:
    """One arm: 1 warm-up and 2 timed AdamW steps; the launch counts and
    byte counters zeroed (or read) just before the steps and read just
    after; replicas' masters compared bitwise after every step; the
    global loss each step and after the last (a GPipe ``pipeline_apply``
    forward under no_grad on pp arms)."""
    from horovod_tpu_torch.parallel.mesh import local_batch

    fam = PIPE_FAMILIES[fam_name]
    spec = hvd.parallel_spec()
    npp, ndp = spec.size_of("pp"), spec.size_of("dp")
    micro = fam["rows"] // ndp
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, stage = _pipe_model(torch, gpt_mod, fam, spec, rank, kw, dev)
    params = list(model.parameters())
    tokens = _pipe_tokens(torch, fam, dev)
    x = local_batch(tokens[:, :-1], spec, rank).contiguous()
    y = local_batch(tokens[:, 1:], spec, rank).contiguous()
    base = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    if optim_kind == "zero3":
        opt = hvd.ZeroOptimizer(base, zero_stage=3, parallel=spec_str)
    else:
        opt = hvd.DistributedOptimizer(
            base, named_parameters=model.named_parameters(),
            parallel=spec_str, accum_steps=micro if npp == 1 else None)
    sf, pf, lf = gpt_mod.pipeline_fns(model)
    tree = {"stages": gpt_mod.stage_params(model),
            "shared": gpt_mod.shared_params(model)}
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=micro,
                                          axis_name="pp", pre_fn=pf)
    # The replicas: every dp rank of a stage holds all its parameters
    # (under ZeRO-3 only as shards: compared once gathered, after the
    # run); the ep ranks of a stage hold the same non-expert parameters
    # (each keeps the whole expert bank but updates only its own experts).
    if ndp > 1:
        rep_axis, rep = "dp", params
    elif spec.size_of("ep") > 1:
        rep_axis = "ep"
        rep = [p for n, p in model.named_parameters() if ".moe." not in n
               or n.endswith(".moe.gate")]
    else:
        rep_axis, rep = None, []
    digest = _Digest(torch, rep) if rep else None

    def replicas_equal(gathered=False):
        if digest is None or (optim_kind == "zero3" and not gathered):
            return None
        every = C.all_gather_stack(digest(rep), axis=rep_axis)
        return bool((every == every[0]).all())

    def global_loss(loss) -> float:
        return C.allreduce(loss.detach().reshape(1).float(), hvd.Average,
                           axis="dp").item()

    def dense_loss(*mb):
        return gpt_mod.next_token_loss(model(mb[0]), mb[1])

    predicted = _pipe_bytes_predicted(C, fam, spec, kw, init_kw, model, opt,
                                      optim_kind)
    _sync(torch, dev)
    hvd.barrier()
    K.reset_launch_counts()
    act0 = pl.ACTIVATION_BYTES.get("pp", 0.0)
    m_act0 = _metric_by_axis(metrics,
                             "hvd_tpu_pipeline_activation_bytes_total")
    m_a2a0 = _metric_by_axis(metrics, "hvd_tpu_alltoall_bytes_total")
    m_red0 = _metric_by_axis(metrics, "hvd_tpu_allreduce_bytes_total")
    m_zero0 = _metric_by_axis(metrics, "hvd_tpu_zero_gather_bytes_total",
                              kind="grad")
    losses, times, equal, expert_norms = [], [], [], None
    for i in range(PIPE_STEPS):
        t0 = time.perf_counter()
        if optim_kind == "zero3":
            opt.gather_params()
        else:
            opt.zero_grad()
        if npp == 1:
            loss = opt.accumulate(dense_loss)(x, y)
        else:
            loss, _ = vg(tree, x, y)
        if i == 0 and fam["moe"] and stage == 0:
            # One step's expert-bank gradient (the first layer, before the
            # reduction: dp = 1): each expert's norm, for the ep ratio.
            g = model.layers[0].moe.w_in.grad
            expert_norms = g.float().norm(dim=(1, 2)).tolist()
        opt.step()
        _sync(torch, dev)
        times.append(time.perf_counter() - t0)
        losses.append(global_loss(loss))
        equal.append(replicas_equal())
    launches = dict(K.LAUNCHES)
    measured = {
        "pp_sends": (pl.ACTIVATION_BYTES.get("pp", 0.0) - act0) / PIPE_STEPS,
        "pp_sends_counter": _delta_by_axis(m_act0, _metric_by_axis(
            metrics, "hvd_tpu_pipeline_activation_bytes_total")).get(
                "pp", 0.0) / PIPE_STEPS,
        "ep_alltoall_counted": _delta_by_axis(m_a2a0, _metric_by_axis(
            metrics, "hvd_tpu_alltoall_bytes_total")).get("ep", 0.0)
        / PIPE_STEPS}
    red = _delta_by_axis(m_red0, _metric_by_axis(
        metrics, "hvd_tpu_allreduce_bytes_total"))
    zero = _delta_by_axis(m_zero0, _metric_by_axis(
        metrics, "hvd_tpu_zero_gather_bytes_total", kind="grad"))
    measured["reduce_axes"] = sorted(red)
    measured["dp_reduce"] = (red.get("dp", 0.0) if optim_kind == "dist"
                             else zero.get("dp", 0.0)) / PIPE_STEPS
    stats = None
    if fam["moe"]:
        per_layer = [moe_mod.record_moe_stats(st)
                     for st in model.moe_stats()]
        stats = {"layer0": per_layer[0],
                 "dropped_frac_mean": statistics.mean(
                     st["dropped_frac"] for st in per_layer)}
    with torch.no_grad():
        if optim_kind == "zero3":
            opt.gather_params()
            equal.append(replicas_equal(gathered=True))
        if npp == 1:
            final = global_loss(dense_loss(x, y))
        else:
            xm = x.reshape((micro, -1) + tuple(x.shape[1:]))
            ym = y.reshape((micro, -1) + tuple(y.shape[1:]))
            outs = pl.pipeline_apply(sf, tree["stages"],
                                     pf(tree["shared"], xm.flatten(0, 1))
                                     .reshape(micro, xm.shape[1],
                                              xm.shape[2], -1), "pp")
            per = torch.stack([lf(tree["shared"], outs[j], ym[j])
                               for j in range(micro)]).mean()
            final = global_loss(pl.select_last_stage(per, "pp"))
    peak, _ = _mem(torch, dev)
    check(all(map(math.isfinite, losses + [final])),
          f"pipeline {label}: non-finite loss in {losses + [final]}")
    check(all(e is not False for e in equal),
          f"pipeline {label}: the replicas' masters differ after step(s) "
          f"{[i for i, e in enumerate(equal) if e is False]}")
    want = {k: v * PIPE_STEPS for k, v in _pipe_launches(
        fam, spec, kw, init_kw).items()}
    _expect(launches, f"pipeline {label}", **want)
    check(measured["pp_sends"] == predicted["pp_sends"],
          f"pipeline {label}: pp_sends {measured['pp_sends']} B a step, "
          f"predicted {predicted['pp_sends']}")
    if metrics.enabled():
        for kind in ("ep_alltoall_counted", "dp_reduce"):
            check(measured[kind] == predicted[kind],
                  f"pipeline {label}: {kind} {measured[kind]} B a step, "
                  f"predicted {predicted[kind]}")
        check(measured["pp_sends_counter"] == measured["pp_sends"],
              f"pipeline {label}: activation counter "
              f"{measured['pp_sends_counter']} != sends "
              f"{measured['pp_sends']}")
        check(set(measured["reduce_axes"]) <= {"dp"},
              f"pipeline {label}: gradient-reduction bytes off dp: "
              f"{measured['reduce_axes']}")
    rec = {"arm": label, "family": fam_name, "spec": spec_str,
           "init": init_kw, **{k: str(v) for k, v in kw.items()},
           "optimizer": optim_kind, "stage": stage,
           "layers_per_rank": model.num_layers,
           "params_per_rank": sum(p.numel() for p in params),
           "rows_per_replica": fam["rows"] // ndp, "microbatches": micro,
           "losses": losses, "final_loss": final,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_median": statistics.median(times[1:]) * 1e3,
           "launches": launches,
           "launches_per_step": {k: v / PIPE_STEPS
                                 for k, v in launches.items() if v},
           "bytes_per_step": measured, "bytes_predicted": predicted,
           "replicas_equal": equal, "replica_axis": rep_axis,
           "peak_mem_gib": peak, "moe_stats": stats,
           "expert_grad_norms": expert_norms}
    if optim_kind == "dist":
        release(torch, opt, dev)
    del model, opt, params, digest, tree, vg, sf, pf, lf
    if dev == "cuda":
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    return rec


def pipeline_worker(config: str, rank: int, out_path: str,
                    dev: str = "cuda") -> None:
    """One rank of phase 12 (``--rank-worker n4_pipeline`` or
    ``n2_moe_ref``): every arm in turn, each in a world made with its
    spec (``init(parallel=)``)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel import moe as moe_mod
    from horovod_tpu_torch.parallel import pipeline as pl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arms = PIPE_ARMS if config == PIPE_CONFIG else MOE_REF_ARMS
    out = {"config": config, "rank": rank, "arms": {}}
    for label, fam, spec, init_kw, kw, optim_kind in arms:
        t0 = time.perf_counter()
        ctx = hvd.init(backend="gloo", parallel=spec, **init_kw) \
            if dev == "cuda" else hvd.init(device="cpu", parallel=spec,
                                           **init_kw)
        check(hvd.parallel_spec().describe() == spec,
              f"pipeline {label}: spec {hvd.parallel_spec()}")
        rec = _pipe_arm(torch, hvd, gpt_mod, C, K, pl, moe_mod, metrics,
                        label, fam, spec, init_kw, kw, optim_kind, rank,
                        dev)
        rec["role"] = ctx.flightrec.role if ctx.flightrec else ""
        rec["arm_s"] = time.perf_counter() - t0
        out["arms"][label] = rec
        print(f"rank {rank} pipeline {label} ({spec}): losses "
              f"{rec['losses']} final {rec['final_loss']}, step ms "
              f"{rec['step_ms']}, launches {rec['launches']}, "
              f"{rec['arm_s']:.1f} s", flush=True)
        hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_pipeline(torch, out_dir: str) -> dict:
    """Phase 12: the 4 rank workers of the pipeline and MoE arms, then
    the 2 of the MoE oracle, on the one card. Returns the phase's record
    with ``launches`` by path (``pipeline``, ``moe``), summed over each
    family's arms."""
    os.makedirs(out_dir, exist_ok=True)
    parent = _free_parent(torch)
    ranks, wall = run_workers(PIPE_CONFIG, 4, PIPE_TIMEOUT, out_dir)
    ref_ranks, ref_wall = run_workers(MOE_REF_CONFIG, 2, PIPE_TIMEOUT,
                                      out_dir)
    res = {"wall_s": wall + ref_wall, "wall_n4_s": wall,
           "wall_n2_s": ref_wall, "parent_gib": parent,
           "label": "gloo, 4 processes on one card (the MoE oracle: 2); "
                    "not NCCL or NVLink",
           "families": {k: {kk: vv for kk, vv in v.items()}
                        for k, v in PIPE_FAMILIES.items()},
           "arms": {}}
    by_arm = {label: [rk["arms"][label] for rk in ranks]
              for label, *_ in PIPE_ARMS}
    by_arm["moe_ref"] = [rk["arms"]["moe_ref"] for rk in ref_ranks]
    launches = {"pipeline": {}, "moe": {}}
    for label, fam, spec, init_kw, kw, optim_kind in PIPE_ARMS + \
            MOE_REF_ARMS:
        recs = by_arm[label]
        check(all(rc["launches"] == recs[0]["launches"] for rc in recs),
              f"pipeline {label}: ranks counted different launches")
        check(all(rc["losses"] == recs[0]["losses"] for rc in recs),
              f"pipeline {label}: ranks saw different global losses")
        path = launches["pipeline" if fam == "pipe" else "moe"]
        for k, v in recs[0]["launches"].items():
            path[k] = path.get(k, 0) + v
        first = last = None
        if label in PIPE_LOSS_RTOL:
            oracle, bound = PIPE_LOSS_RTOL[label]
            ref = by_arm[oracle][0]
            first = abs(recs[0]["losses"][0] - ref["losses"][0]) \
                / abs(ref["losses"][0])
            last = abs(recs[0]["final_loss"] - ref["final_loss"]) \
                / abs(ref["final_loss"])
            check(first <= bound and last <= bound,
                  f"pipeline {label}: loss off {oracle}'s by {first:.2e} "
                  f"(first step) and {last:.2e} (after the last) > {bound}")
        step_ms = statistics.median(rc["step_ms_median"] for rc in recs)
        rows, seq = PIPE_FAMILIES[fam]["rows"], PIPE_FAMILIES[fam]["seq"]
        bytes_by_stage = {rc["stage"]: rc["bytes_per_step"] for rc in recs}
        m = res["arms"][label] = {
            "spec": spec, "family": fam, "init": init_kw,
            **{k: str(v) for k, v in kw.items()}, "optimizer": optim_kind,
            "step_ms_median": step_ms, "step_ms_rank0": recs[0]["step_ms"],
            "tokens_per_s": rows * seq / (step_ms / 1e3),
            "losses": recs[0]["losses"], "final_loss": recs[0]["final_loss"],
            "first_loss_rel_to_oracle": first,
            "final_loss_rel_to_oracle": last,
            "launches_per_step": recs[0]["launches_per_step"],
            "bytes_per_step_by_stage": bytes_by_stage,
            "bytes_predicted_rank0": recs[0]["bytes_predicted"],
            "peak_mem_gib": max(rc["peak_mem_gib"] for rc in recs),
            "params_per_rank": [rc["params_per_rank"] for rc in recs],
            "roles": [rc["role"] for rc in recs],
            "arm_s_max": max(rc["arm_s"] for rc in recs),
            "moe_stats": recs[0]["moe_stats"]}
        print(f"pipeline {label} ({spec}; {res['label']}): GPT-2 medium"
              f"{'-MoE' if fam == 'moe' else ''} at "
              f"{PIPE_FAMILIES[fam]['layers']} layers, {rows} x {seq} "
              f"global; step {step_ms:.1f} ms = {m['tokens_per_s']:.0f} "
              f"tok/s; losses {m['losses']} final {m['final_loss']:.6f}"
              + (f" (vs {PIPE_LOSS_RTOL[label][0]} {first:.2e}, "
                 f"{last:.2e})" if first is not None else "")
              + f"; launches a step {json.dumps(m['launches_per_step'])}; "
              f"bytes a rank a step {json.dumps(bytes_by_stage)}; peak "
              f"{m['peak_mem_gib']:.2f} GiB a rank; arm "
              f"{m['arm_s_max']:.1f} s", flush=True)
        if m["moe_stats"]:
            print(f"pipeline {label} MoE stats (rank 0's layer 0): drop "
                  f"{m['moe_stats']['layer0']['dropped_frac']:.4f}, load "
                  f"{m['moe_stats']['layer0']['expert_load']}; mean drop "
                  f"over its layers "
                  f"{m['moe_stats']['dropped_frac_mean']:.4f}", flush=True)
    # How the ep world combines expert gradients: the owner of each
    # expert against the ep=1 oracle's gradient of the same step.
    ref0 = next(rc for rc in by_arm["moe_ref"] if rc["stage"] == 0)
    ratios = {}
    for rc in by_arm["moe_ep"]:
        if rc["stage"] != 0:
            continue
        for e, g in enumerate(rc["expert_grad_norms"]):
            if g > 0:
                ratios[e] = g / ref0["expert_grad_norms"][e]
    check(len(ratios) == PIPE_FAMILIES["moe"]["moe"]["moe_experts"],
          f"pipeline moe_ep: expert gradients owned {sorted(ratios)}")
    res["expert_grad_ratio_ep_over_ref"] = ratios
    print(f"pipeline moe_ep expert-bank gradient / moe_ref's, by expert "
          f"(layer 0, first step): "
          f"{json.dumps({e: round(r, 6) for e, r in ratios.items()})}",
          flush=True)
    res["launches"] = launches
    with open(os.path.join(out_dir, "chip_smoke_pipeline.json"), "w") as f:
        json.dump(dict(res, ranks=ranks, ref_ranks=ref_ranks), f, indent=1)
    return res


# -- phase 13: the elastic hybrid world ----------------------------------------

HYBRID_HOSTS = "hostA:1,hostB:1,hostC:1,hostD:1"
HYBRID_SPEC = "dp=2,pp=2"
# GPT-2 medium's widths at 2 of its 24 layers, one a pipeline stage: the
# depth cut that fits the phase into its 150 s (this slice's named cut).
HYBRID_LAYERS = 2
# Global rows of SEQ tokens a step (one row a microbatch): k = rows / dp
# microbatches a replica, so the global batch stays 4 x 512 when dp
# halves (the dp = 1 world runs twice the microbatches).
HYBRID_RUN = {"rows": 4, "seq": 512, "steps": 8, "lr": 1e-4}
HYBRID_ROUTE = "dp:int8"            # K3 on the dp reduce-scatter
HYBRID_KEEP = 3                     # sharded steps kept a rank (walk-back)
# hostC (role dp1/pp0) sleeps this long at each commit of its first
# process: replica dp1's median busy time is then well over 1.5 x
# replica dp0's, and hostC strictly its slowest rank (hostD waits on it
# in the pipeline exchanges, which are waits, not busy time). A tick
# spans a step period of the world of 4 (the straggled step and its
# save, ≈ 10 s on the H100), so every rank reports in each scoring tick;
# one flagged tick convicts (patience 1), so the eviction lands by the
# third or fourth step and the world of 2 takes the rest.
HYBRID_STRAGGLE = {"site": "straggler", "step": 1, "times": 50,
                   "host": "hostC", "delay_s": 6.0}
HYBRID_POLICY = {"tick_interval_s": 12.0, "publish_interval_s": 0.0,
                 "window": 4, "straggler_ratio": 1.5,
                 "straggler_patience": 1, "min_ranks": 4,
                 "evict_ttl_s": 3600.0, "evict_cooldown_s": 0.0,
                 "grow_cooldown_s": 0.0, "grow_min_comm_fraction": 0.0}
HYBRID_ENV = {"HVD_TPU_PARALLEL": HYBRID_SPEC,
              "HVD_TPU_STALL_CHECK_TIME_SECONDS": "60",
              "HVD_TPU_POD_METRICS_INTERVAL_S": "1",
              "HVD_TPU_ELASTIC_GRACE_SECS": "30"}
HYBRID_TIMEOUT = 420                # seconds a launcher run may take


def _bits_digest(torch, named) -> str:
    """sha256 over ``(name, bits sum, position-weighted bits sum)`` of
    each tensor, the sums taken on the tensor's device."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(named):
        flat = named[name].detach().reshape(-1)
        bits = flat.view(torch.int32).to(torch.int64) \
            if flat.dtype == torch.float32 else \
            flat.to(torch.float64).view(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device,
                         dtype=torch.int64) % 1000003 + 1
        h.update(name.encode())
        h.update(torch.stack([bits.sum(), (bits * w).sum()]).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _gathered_leaves(torch, fusion, opt, names) -> dict:
    """``{name/key: tensor}`` of a ZeroOptimizer's state gathered over its
    grid (``gather_state``), cut by leaf: the vector state and the EF
    residual's sum."""
    out = {}
    full = opt.gather_state()
    plan = opt.shard_state.plan
    for bi, entry in full["state"].items():
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim():
                for i, view in fusion.unfuse_bucket(v,
                                                    plan.buckets[int(bi)]):
                    out[f"{names[i]}/{k}"] = view
    for r, b in zip(full["ef_state"]["residual"], plan.buckets):
        for i, view in fusion.unfuse_bucket(r, b):
            out[f"{names[i]}/residual"] = view
    return out


def hybrid_elastic_worker(cfg_path: str) -> None:
    """One worker of phase 13 (``--hybrid-elastic-worker CFG``), started
    by the port's launcher under ``HVD_TPU_PARALLEL``: this rank's stage
    of the seeded GPT (GPT-2 medium's widths, or ``gpt_tiny`` on the
    CPU), 1F1B ``pipeline_accumulate_gradients`` over ``rows / dp``
    microbatches, ``ZeroOptimizer(zero_stage=1, compression="int8_ef",
    parallel=)`` AdamW; with ``reference`` the first world first runs
    the same steps uninterrupted in its own model and optimizer (no
    commit, no save; ``ref_step`` events); ``restore_sharded`` at start
    (the restored state checked by digest against the saved pieces
    assembled whole), and ``save_sharded`` of the state under its global
    leaf names before each commit. Logs every event with its time and
    each step's launches."""
    import time as time_mod

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common import faults
    from horovod_tpu_torch.common import fusion
    from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel import pipeline as pl
    from horovod_tpu_torch.parallel.mesh import local_batch

    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = hvd.init(device="cpu") if dev == "cpu" else \
        hvd.init(backend="gloo")
    rank, n = hvd.rank(), hvd.size()
    spec = hvd.parallel_spec()
    check(spec is not None and spec.total == n,
          f"hybrid worker: spec {spec} for a world of {n}")
    dp, npp = spec.size_of("dp"), spec.size_of("pp")
    s = spec.coords(rank)["pp"]
    host = os.environ.get("HVD_TPU_HOSTNAME", "")
    work = cfg["workdir"]
    events_path = os.path.join(work, f"events.rank{rank}.jsonl")

    def log(event, **kw):
        with open(events_path, "a") as f:
            f.write(json.dumps({"event": event, "t": time_mod.time(),
                                "pid": os.getpid(), "host": host, "n": n,
                                "spec": spec.describe(),
                                "role": spec.role_label(rank),
                                "metrics_port": ctx.metrics_port, **kw})
                    + "\n")

    widths = cfg["widths"]
    k = cfg["rows"] // dp

    def build():
        """This rank's stage of the seeded GPT, its global leaf names, the
        optimizer and the 1F1B step's closure."""
        with torch.device(dev):
            full = gpt_mod.GPT(num_layers=cfg["layers"], **widths)
        full.init_weights(torch.Generator(device=dev).manual_seed(0))
        stages, shared = gpt_mod.stack_stage_params(full.state_dict(), npp)
        state = {**stages[s], **shared}
        del full, stages, shared
        with torch.device(dev):
            model = gpt_mod.GPT(num_layers=cfg["layers"] // npp, **widths)
        model.load_state_dict(state)
        opt = hvd.ZeroOptimizer(
            torch.optim.AdamW(model.parameters(), lr=cfg["lr"],
                              weight_decay=1e-4),
            zero_stage=1, compression="int8_ef", route=cfg["route"],
            parallel=spec.describe())
        sf, pf, lf = gpt_mod.pipeline_fns(model)
        vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=k,
                                              axis_name="pp", pre_fn=pf)
        tree = {"stages": gpt_mod.stage_params(model),
                "shared": gpt_mod.shared_params(model)}
        return (model, gpt_mod.global_param_names(model, s, npp), opt,
                lambda x, y: vg(tree, x, y))

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def train_step(opt, vg, step):
        """One optimizer step on the step's seeded global batch (this
        rank's dp rows): the global loss, the ms and the launches."""
        toks = torch.randint(
            0, widths["vocab_size"], (cfg["rows"], cfg["seq"] + 1),
            generator=torch.Generator().manual_seed(1000 + step)).to(dev)
        x = local_batch(toks[:, :-1], spec, rank)
        y = local_batch(toks[:, 1:], spec, rank)
        before = dict(K.LAUNCHES)
        sync()
        t = time_mod.perf_counter()
        opt.zero_grad()
        loss, _ = vg(x, y)
        opt.step()
        sync()
        step_ms = (time_mod.perf_counter() - t) * 1e3
        launches = {name: K.LAUNCHES[name] - before.get(name, 0)
                    for name in K.LAUNCHES}
        gloss = float(C.allreduce(loss.detach().reshape(1).float(),
                                  C.Average, axis="dp"))
        return dict(step=step, loss=gloss, step_ms=step_ms, micro=k,
                    launches=launches,
                    buckets=len(opt.shard_state.plan.buckets))

    ckdir = os.path.join(work, "ckpt")
    if cfg.get("reference") and not os.path.isdir(
            os.path.join(ckdir, "rank0")):
        # The uninterrupted reference, in the first world's processes
        # before the elastic run: the same steps and data, no commit (so
        # no fault fires and nothing is published), no save.
        ref_model, _, ref_opt, ref_vg = build()
        for step in range(1, cfg["steps"] + 1):
            log("ref_step", **train_step(ref_opt, ref_vg, step))
        del ref_model, ref_opt, ref_vg
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    model, names, opt, vg = build()

    start = 0
    if os.path.isdir(os.path.join(ckdir, "rank0")):
        t0 = time_mod.perf_counter()
        restored, start = ckpt.restore_sharded(opt.restore_template(names),
                                               ckdir)
        opt.load_sharded_tree(restored, names)
        sync()
        secs = time_mod.perf_counter() - t0
        del restored
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for r in os.listdir(ckdir)
                     for d, _, fs in os.walk(os.path.join(
                         ckdir, r, str(start))) for f in fs)
        # The restored stage state against the saved pieces assembled
        # whole, each leaf by digest.
        whole, _ = ckpt.restore_sharded(opt.sharded_tree(names, whole=True),
                                        ckdir)
        saved = {f"{nm}/{key}": v for nm, rec in whole["leaves"].items()
                 for key, v in rec.items()
                 if torch.is_tensor(v) and v.dim()}
        saved.update({f"{nm}/residual": v for nm, v in
                      whole["ef_state"]["residual"].items()})
        del whole
        live = _gathered_leaves(torch, fusion, opt, names)
        log("restore", step=start, seconds=secs, bytes=nbytes,
            by=opt.last_restore, leaves=len(saved),
            digest_ok=_bits_digest(torch, live) ==
            _bits_digest(torch, saved))
        del saved, live
    else:
        log("start", step=0)
    raw = os.environ.get("HVD_TPU_FAULT_PLAN")
    if raw:
        faults.install(_shifted_plan(faults, raw,
                                     os.environ["HVD_TPU_FAULT_LOG"], start))

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2 ** 30
                if dev == "cuda" else 0.0)

    st = elastic.ObjectState(step=start)

    @elastic.run
    def train(st):
        while st.step < cfg["steps"]:
            step = st.step + 1
            rec = train_step(opt, vg, step)
            t = time_mod.perf_counter()
            ckpt.save_sharded(opt.sharded_tree(names), ckdir, step,
                              max_to_keep=HYBRID_KEEP)
            st.step = step
            rec.update(save_s=time_mod.perf_counter() - t,
                       peak_gib=peak_gib())
            try:
                st.commit()
            except HostsUpdatedInterrupt:
                log("step", interrupted=True, **rec)
                raise
            log("step", **rec)

    try:
        train(st)
    except SystemExit as e:
        log("exit", step=int(st.step), code=e.code, peak_gib=peak_gib())
        raise
    except BaseException as e:
        import traceback

        log("error", step=int(st.step), error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-3000:])
        raise
    log("final", step=int(st.step), peak_gib=peak_gib())
    hvd.shutdown()


class HybridWatch:
    """What phase 13's parent sees while the launcher runs, polled every
    ``poll_s``: the decision log's lines with the time each was first
    seen, the pod monitor's ``/pod/metrics`` text (its port from the
    launcher's output) and the driver's own registry (``/pod/driver``)."""

    def __init__(self, launcher_log: str, decision_log: str,
                 poll_s: float = 0.5):
        self.launcher_log, self.decision_log = launcher_log, decision_log
        self.poll_s = poll_s
        self.pod_port = None
        self.pod = []              # (t, /pod/metrics text)
        self.driver = []           # (t, /pod/driver text)
        self.decisions = []        # (t first seen, line)

    def _poll(self):
        import re

        if os.path.exists(self.decision_log):
            with open(self.decision_log) as f:
                lines = [x.strip() for x in f if x.strip()]
            for line in lines[len(self.decisions):]:
                self.decisions.append((time.time(), line))
        if self.pod_port is None and os.path.exists(self.launcher_log):
            with open(self.launcher_log) as f:
                m = re.search(r"/pod/metrics on port (\d+)", f.read())
            if m:
                self.pod_port = int(m.group(1))
        if self.pod_port is not None:
            for path, into in (("/pod/metrics", self.pod),
                               ("/pod/driver", self.driver)):
                body, _ = _http_get(
                    f"http://127.0.0.1:{self.pod_port}{path}")
                if body is not None:
                    into.append((time.time(), body))

    def run(self, stop) -> None:
        while not stop.wait(self.poll_s):
            try:
                self._poll()
            except (OSError, ValueError) as e:
                print(f"hybrid watch: {type(e).__name__}: {e}", flush=True)


def _hybrid_launch(work: str, cfg: dict, env_extra: dict, nps, args,
                   output: str, timeout: float = HYBRID_TIMEOUT,
                   watch=None, plan=None):
    """One launcher run of the hybrid worker (``run_elastic_job``'s
    machinery with ``--hybrid-elastic-worker``)."""
    return run_elastic_job(work, cfg, plan, env_extra=env_extra,
                           timeout=timeout, output=output,
                           hosts=HYBRID_HOSTS, nps=nps,
                           launcher_args=args, watch=watch,
                           worker="--hybrid-elastic-worker")


def _hybrid_steps(events: dict, n: int) -> list:
    """Every step event of a world of ``n``, in time order."""
    return sorted((e for evs in events.values() for e in evs
                   if e["event"] == "step" and e["n"] == n),
                  key=lambda e: e["t"])


def elastic_hybrid(root: str, out_dir: str, dev: str = "cuda",
                   widths=None, layers: int = HYBRID_LAYERS, run=None,
                   straggle=None, policy=None, env_extra=None,
                   timeout: float = HYBRID_TIMEOUT,
                   expect_launches: bool = True) -> dict:
    """Phase 13 (the CPU journey with ``dev="cpu"`` and ``gpt_tiny``'s
    widths): the respec run (``-np 4 --min-np 2 --max-np 4 -H hostA..D
    --pod-metrics-port 0 --autoscale-policy JSON --autoscale-log FILE
    --host-discovery-script SCRIPT`` under ``HVD_TPU_PARALLEL=dp=2,pp=2``,
    a straggler on hostC's first process; its first world runs the
    uninterrupted dp=2,pp=2 reference first), watched by a
    :class:`HybridWatch`, and beside it a ``--min-np 3`` launch that must
    fail naming the roles. Checks and returns the record."""
    run = dict(HYBRID_RUN, **(run or {}))
    widths = widths or dict(PIPE_WIDTHS)
    straggle = dict(HYBRID_STRAGGLE, **(straggle or {}))
    policy = dict(HYBRID_POLICY, **(policy or {}))
    env = dict(HYBRID_ENV, **(env_extra or {}))
    cfg = {"device": dev, "widths": widths, "layers": layers,
           "route": HYBRID_ROUTE, **run}
    hosts_file = os.path.join(root, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write("\n".join(HYBRID_HOSTS.split(",")) + "\n")
    discover = os.path.join(root, "discover.sh")
    with open(discover, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(discover, 0o755)
    t_phase = time.perf_counter()
    rec = {"label": "gloo, 4 then 2 processes on one card (not NCCL or "
                    "NVLink)" if dev == "cuda" else "gloo on the CPU",
           "spec": HYBRID_SPEC, "layers": layers,
           "global_batch": [run["rows"], run["seq"]], "steps": run["steps"]}

    # The respec run (its first world also runs the uninterrupted
    # reference before the elastic steps) and, beside it, a launch whose
    # floor splits a replica: it must fail before any worker starts,
    # naming the roles.
    from concurrent.futures import ThreadPoolExecutor

    work = os.path.join(root, "respec")
    os.makedirs(work, exist_ok=True)
    decision_log = os.path.join(work, "decisions.jsonl")
    launcher_log = os.path.join(out_dir, "elastic_hybrid.log")
    watch = HybridWatch(launcher_log, decision_log)
    plan = {"seed": 17, "faults": [straggle]}
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        bad = pool.submit(
            _hybrid_launch, os.path.join(root, "bad"), cfg, env, (4, 3, 4),
            ["--autoscale-policy", json.dumps(policy)],
            os.path.join(out_dir, "elastic_hybrid_min_np3.log"), 120)
        rc, wall, events, inj, log = _hybrid_launch(
            work, dict(cfg, reference=True), env, (4, 2, 4),
            ["--pod-metrics-port", "0", "--autoscale-policy",
             json.dumps(policy), "--autoscale-log", decision_log,
             "--host-discovery-script", discover], launcher_log,
            timeout=timeout, watch=watch.run, plan=plan)
        bad_rc, _, bad_events, _, bad_log = bad.result()
    rec["respec_wall_s"] = time.perf_counter() - t
    check(bad_rc not in (0, None) and not bad_events
          and "model-replica size 2" in bad_log and "pp=2" in bad_log,
          f"hybrid: --min-np 3 launch: exit {bad_rc}, events "
          f"{list(bad_events)}:\n{bad_log[-2000:]}")
    rec["min_np3"] = {"rc": bad_rc, "message": next(
        (line for line in bad_log.splitlines() if "model-replica" in line),
        "")}
    check(rc == 0, f"hybrid respec run: exit {rc}:\n{log[-3000:]}")
    ref_steps = sorted((e for evs in events.values() for e in evs
                        if e["event"] == "ref_step"), key=lambda e: e["t"])
    check(len(ref_steps) == 4 * run["steps"],
          f"hybrid reference: steps {[e['step'] for e in ref_steps]}")
    ref_loss = [e["loss"] for e in ref_steps if e["step"] == run["steps"]][0]
    decisions = [json.loads(line) for _, line in watch.decisions]
    got = [(d["action"], d["target"], d.get("role"), d["reason"])
           for d in decisions]
    check(got == [("evict", "hostC", "dp1/pp0", "straggler"),
                  ("respec", "dp=1,pp=2", None, "shed_dp")],
          f"hybrid: decisions {got}")
    t_evict = watch.decisions[0][0]
    # The pod view while the straggler ran: replica 1 stalled, 0 not, and
    # every per-rank series labelled with its role coordinates.
    def gauge(text):
        return {lb.get("replica"): v for v, lb in
                _labeled(text, "hvd_tpu_pod_replica_stalled")}

    stalled = [text for tt, text in watch.pod
               if tt < t_evict and gauge(text) == {"0": 0.0, "1": 1.0}]
    check(stalled, "hybrid: /pod/metrics never showed replica 1 stalled "
                   f"and 0 not before the eviction (last: "
                   f"{[gauge(x) for _, x in watch.pod][-3:]})")
    per_rank = _labeled(stalled[-1], "hvd_tpu_pod_step_time_seconds")
    check(len(per_rank) == 4 and all(
        {"dp", "pp"} <= set(lb) for _, lb in per_rank),
          f"hybrid: per-rank series without role labels: {per_rank}")
    respec_total = [v for _, text in watch.driver for v, lb in _labeled(
        text, "hvd_tpu_respec_total")
        if lb.get("from") == HYBRID_SPEC and lb.get("to") == "dp=1,pp=2"]
    check(respec_total and respec_total[-1] == 1.0,
          f"hybrid: driver hvd_tpu_respec_total {respec_total}")
    worlds = _world_sequence(events)
    check(worlds == [4, 2], f"hybrid: world sizes {worlds}")
    n2 = _hybrid_steps(events, 2)
    check(n2 and all(e["spec"] == "dp=1,pp=2" for e in n2)
          and {e["pid"] for e in n2} and len({e["pid"] for e in n2}) == 2,
          f"hybrid: the relaunched world {[(e['pid'], e['spec']) for e in n2]}")
    check(len({e["step"] for e in n2}) >= 3,
          f"hybrid: {len({e['step'] for e in n2})} steps after the respec")
    restores = [e for evs in events.values() for e in evs
                if e["event"] == "restore"]
    n4 = _hybrid_steps(events, 4)
    newest_everywhere = max(st for st in {e["step"] for e in n4} if sum(
        1 for e in n4 if e["step"] == st) == 4)
    check(len(restores) == 2 and all(
        e["digest_ok"] and e["step"] == newest_everywhere
        and e["by"] == "piecewise" for e in restores),
          f"hybrid: restores {restores} (newest step saved by every rank "
          f"{newest_everywhere})")
    final_loss = [e["loss"] for e in n2 if e["step"] == run["steps"]]
    check(final_loss, "hybrid: the respec run never reached its last step")
    bound = 0.02 * abs(ref_loss) + 1e-3
    check(abs(final_loss[0] - ref_loss) <= bound,
          f"hybrid: final loss {final_loss[0]} vs uninterrupted {ref_loss} "
          f"(bound {bound})")
    # Exact launches a rank a step: K5 twice (the forward slot and the
    # recompute) and K6/K7 once a layer a microbatch; K3 once a bucket of
    # the int8 dp reduce-scatter, on an axis of one as well (the
    # quantized reduce-scatter quantizes whatever the axis size, as the
    # JAX one does); nothing else. The reference's steps as well.
    lps = layers // 2
    for e in ref_steps + n4 + n2:
        want = {"flash_fwd": 2 * lps * e["micro"],
                "flash_bwd_dq": lps * e["micro"],
                "flash_bwd_dkv": lps * e["micro"],
                "quantize_int8_stochastic": e["buckets"]}
        if expect_launches:
            got = {name: v for name, v in e["launches"].items() if v}
            check(got == want, f"hybrid: rank {e['role']} step "
                               f"{e['step']} launches {got} vs {want}")
    t_n2 = min(e["t"] for e in n2)
    rec.update({
        "decisions": decisions, "worlds": worlds,
        "ref_loss": ref_loss, "final_loss": final_loss[0],
        "loss_bound": bound,
        "step_ms_n4": statistics.median(e["step_ms"] for e in n4),
        "step_ms_n2": statistics.median(e["step_ms"] for e in n2),
        "ref_step_ms": statistics.median(e["step_ms"] for e in ref_steps),
        "save_s_n4": statistics.median(e["save_s"] for e in n4),
        "save_s_n2": statistics.median(e["save_s"] for e in n2),
        "evict_to_first_n2_step_s": t_n2 - t_evict,
        "restore_s": [e["seconds"] for e in restores],
        "restore_bytes": [e["bytes"] for e in restores],
        "restored_step": newest_everywhere,
        "peak_gib_n4": max(e["peak_gib"] for e in n4),
        "peak_gib_n2": max(e["peak_gib"] for e in n2),
        "launches_n4": n4[0]["launches"], "launches_n2": n2[0]["launches"],
        "micro_n4": n4[0]["micro"], "micro_n2": n2[0]["micro"],
        "launches": _role_launches(n4 + n2, "dp0/pp0"),
        "injections": inj, "phase_s": time.perf_counter() - t_phase})
    return rec


def _role_launches(steps: list, role: str) -> dict:
    """The launches of the rank with ``role`` (in every world), summed
    over its steps."""
    out = {}
    for e in steps:
        if e["role"] == role:
            for name, v in e["launches"].items():
                out[name] = out.get(name, 0) + v
    return out


def phase_elastic_hybrid(torch, out_dir: str) -> dict:
    """Phase 13: :func:`elastic_hybrid` on the card at GPT-2 medium's
    widths; returns the record with ``launches`` (the dp0/pp0 rank of
    both worlds over every step)."""
    import shutil
    import tempfile

    parent = _free_parent(torch)
    root = tempfile.mkdtemp(prefix="hvd_hybrid_")
    try:
        rec = elastic_hybrid(root, out_dir)
    finally:
        for name in ("faults.jsonl", "decisions.jsonl") + tuple(
                f"events.rank{r}.jsonl" for r in range(4)):
            src = os.path.join(root, "respec", name)
            if os.path.exists(src):
                with open(src, "rb") as fi, open(os.path.join(
                        out_dir, f"elastic_hybrid_{name}"), "wb") as fo:
                    fo.write(fi.read()[-400_000:])
        shutil.rmtree(root, ignore_errors=True)
    rec["parent_gib"] = parent
    with open(os.path.join(out_dir, "chip_smoke_elastic_hybrid.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(f"elastic hybrid ({rec['label']}): decisions "
          f"{[(d['action'], d['target'], d.get('role'), d['reason']) for d in rec['decisions']]}"
          f", worlds {rec['worlds']}; step {rec['step_ms_n4']:.1f} ms at "
          f"dp=2,pp=2 (k={rec['micro_n4']}) -> {rec['step_ms_n2']:.1f} ms at "
          f"dp=1,pp=2 (k={rec['micro_n2']}), reference "
          f"{rec['ref_step_ms']:.1f} ms; save {rec['save_s_n4']:.2f} -> "
          f"{rec['save_s_n2']:.2f} s; eviction -> first n=2 step "
          f"{rec['evict_to_first_n2_step_s']:.1f} s; restore "
          f"{[round(x, 2) for x in rec['restore_s']]} s, "
          f"{[round(b / 1e9, 3) for b in rec['restore_bytes']]} GB (step "
          f"{rec['restored_step']}); peak {rec['peak_gib_n4']:.2f} / "
          f"{rec['peak_gib_n2']:.2f} GiB a rank; final loss "
          f"{rec['final_loss']:.6f} vs {rec['ref_loss']:.6f} (bound "
          f"{rec['loss_bound']:.2e}); launches a step n4 "
          f"{json.dumps(rec['launches_n4'])}, n2 "
          f"{json.dumps(rec['launches_n2'])}; phase {rec['phase_s']:.1f} s",
          flush=True)
    return rec


def _step_seconds(events: dict) -> list:
    """Rank 0's seconds between consecutive completed steps of one
    process (a clean run's step time, commits included)."""
    t = [e["t"] for e in events.get(0, []) if e["event"] == "step"]
    return [b - a for a, b in zip(t, t[1:])]


# -- phase 15: the cluster layer ----------------------------------------------

CLUSTER_IMAGES = 32                 # (a): 2 ranks x 2 steps x 8 images
CLUSTER_BATCH = 8                   # images a rank a step
CLUSTER_LR = 1e-2                   # (a)'s SGD
CLUSTER_LOSS_RTOL = 2e-2            # a rank's step loss vs the oracle's (bf16)
# Rank 0's final weights vs the oracle's: the largest |dw| over the
# largest update. Both average the same two bf16-computed gradients,
# only in another order, so the bound is the bf16 one of phases 11-12.
CLUSTER_WEIGHT_RTOL = 2e-2
CLUSTER_LOGIT_RTOL = 2e-2           # transform's logits, of max |logit|
CLUSTER_TRANSFORM = 8               # images transform() takes on the card
# (b): the port's MLP on seeded rows, softmax cross-entropy, 2 epochs.
CLUSTER_MLP = dict(in_features=64, features=(128,), num_classes=10)
CLUSTER_MLP_RUN = {"rows": 64, "batch": 8, "epochs": 2, "lr": 0.05,
                   "seed": 0}
CLUSTER_MLP_RTOL = 1e-5             # fp32 history and weights, of max |value|
CLUSTER_ELEMS = 1 << 20             # (c)/(d): one bf16 tensor a rank
CLUSTER_PRE, CLUSTER_POST = 1 / 3, 1.5
CLUSTER_WORLDS_TIMEOUT = 300        # s: (c) and (d) together


def _cluster_input(torch, rank: int):
    gen = torch.Generator(device="cuda").manual_seed(1500 + rank)
    return torch.randn(CLUSTER_ELEMS, generator=gen,
                       device="cuda").to(torch.bfloat16)


def _digest(torch, t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()


def cluster_allreduce_task() -> dict:
    """(c) and (d)'s function, run in every Spark task and Ray actor:
    ``init(backend="gloo")`` on the card, one bf16 ``allreduce(op=Sum)``
    with a pre- and a postscale, K1's launches counted from zero around
    it."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    ctx = hvd.init(backend="gloo")
    init_s = time.perf_counter() - t0
    try:
        x = _cluster_input(torch, hvd.rank())
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = hvd.allreduce(x, op=hvd.Sum, name="cluster.scaled",
                            prescale_factor=CLUSTER_PRE,
                            postscale_factor=CLUSTER_POST)
        torch.cuda.synchronize()
        return {"rank": hvd.rank(), "size": hvd.size(),
                "device": str(out.device), "backend": ctx.backend,
                "digest": _digest(torch, out), "init_s": init_s,
                "scale_buffer": K.LAUNCHES["scale_buffer"],
                "launches": dict(K.LAUNCHES)}
    finally:
        hvd.shutdown()


def cluster_worlds(out_path: str) -> None:
    """``--cluster-worlds OUT``: phase 15 (c) and (d) in a fork of the
    zygote, which holds no CUDA context, so the fakes fork their tasks
    and actors from it with torch imported (spawned, each re-imports
    torch): ``spark.run`` over ``FakeSparkContext`` and ``RayExecutor``
    over ``fake_ray``, 2 processes each, run
    :func:`cluster_allreduce_task`. Their results and seconds go to OUT
    as JSON."""
    import importlib

    from horovod_tpu_torch import spark as spark_mod
    from horovod_tpu_torch.testing import fake_ray
    from horovod_tpu_torch.testing.fake_spark import FakeSparkContext

    # The function the tasks and actors run, by its module's name (this
    # file is __main__ here, which a pickle cannot name).
    task = importlib.import_module("chip_smoke").cluster_allreduce_task
    rec = {}
    t0 = time.perf_counter()
    rec["spark"] = spark_mod.run(
        task, num_proc=2, spark_context=FakeSparkContext(
            2, start_method="fork"), start_timeout=CLUSTER_WORLDS_TIMEOUT)
    rec["spark_run_s"] = time.perf_counter() - t0
    sys.modules.setdefault("ray", fake_ray)
    from horovod_tpu_torch.ray import RayExecutor

    fake_ray.init(start_method="fork")
    try:
        t0 = time.perf_counter()
        ex = RayExecutor(RayExecutor.create_settings(CLUSTER_WORLDS_TIMEOUT),
                         num_workers=2)
        ex.start()
        rec["ray_start_s"] = time.perf_counter() - t0
        try:
            rec["ray"] = ex.run(task)
        finally:
            ex.shutdown()
        rec["ray_run_s"] = time.perf_counter() - t0
    finally:
        fake_ray.shutdown()
    with open(out_path, "w") as f:
        json.dump(rec, f)


def _check_world(torch, res: list, what: str) -> None:
    pre = torch.tensor(CLUSTER_PRE, dtype=torch.bfloat16, device="cuda")
    post = torch.tensor(CLUSTER_POST, dtype=torch.bfloat16, device="cuda")
    want = _digest(torch, (_cluster_input(torch, 0) * pre
                           + _cluster_input(torch, 1) * pre) * post)
    check([(r["rank"], r["size"]) for r in res] == [(0, 2), (1, 2)],
          f"{what}: results not in rank order of a world of 2: "
          f"{[(r['rank'], r['size']) for r in res]}")
    for r in res:
        check(r["device"].startswith("cuda") and r["backend"] == "gloo",
              f"{what}: rank {r['rank']} on {r['device']} / {r['backend']}")
        check(r["digest"] == want, f"{what}: rank {r['rank']}'s allreduce "
                                   f"differs from the hand value")
        check(r["scale_buffer"] == 2 and sum(r["launches"].values()) == 2,
              f"{what}: rank {r['rank']} launched {r['launches']}, "
              f"expected K1 exactly twice (pre and post)")


def _vit_oracle(torch, model, images, labels) -> dict:
    """(a)'s oracle in this process: the same 2 SGD steps, each on the
    images of the two ranks' s-th batches (``rank_shard`` is strided),
    each rank's loss over its own; returns the per-rank step losses."""
    import torch.nn.functional as F

    opt = torch.optim.SGD(model.parameters(), lr=CLUSTER_LR)
    shard = [(images[r::2][:CLUSTER_IMAGES // 2],
              labels[r::2][:CLUSTER_IMAGES // 2]) for r in range(2)]
    losses = [[], []]
    for s in range(CLUSTER_IMAGES // 2 // CLUSTER_BATCH):
        opt.zero_grad()
        for r, (x, y) in enumerate(shard):
            b = slice(s * CLUSTER_BATCH, (s + 1) * CLUSTER_BATCH)
            loss = F.cross_entropy(model(x[b]), y[b])
            (loss / 2).backward()
            losses[r].append(loss.item())
        opt.step()
    del opt
    return losses


def _mlp_oracle(torch, model, X, y) -> dict:
    """(b)'s oracle: the estimator's loop for 2 ranks in this process
    (strided shards, the shared seeded permutation, the two ranks'
    gradients averaged), rank 0's per-epoch history."""
    import numpy as np

    from horovod_tpu_torch.estimator import _softmax_cross_entropy

    run = CLUSTER_MLP_RUN
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=run["lr"])
    shards = [(X[r::2][:len(X) // 2], y[r::2][:len(X) // 2])
              for r in range(2)]
    rows, bs = len(X) // 2, run["batch"]
    rng = np.random.default_rng(run["seed"])
    history = []
    for _ in range(run["epochs"]):
        order = torch.from_numpy(rng.permutation(rows)).cuda()
        total = 0.0
        for s in range(rows // bs):
            idx = order[s * bs:(s + 1) * bs]
            grads = []
            for r, (xs, ys) in enumerate(shards):
                loss = _softmax_cross_entropy(model(xs[idx]), ys[idx])
                grads.append(torch.autograd.grad(loss, params))
                if r == 0:
                    total += loss.item()
            for p, g0, g1 in zip(params, *grads):
                p.grad = (g0 + g1) / 2
            opt.step()
        history.append(total / (rows // bs))
    return history


def phase_cluster(torch, K, out_dir: str) -> dict:
    """Phase 15: the cluster layer on the card. (a) ``TorchEstimator``
    (``spark.torch``) fits ViT-B/16 over an ``Executor`` pool of 2 gloo
    ranks, then ``transform``; (b) ``Estimator`` fits the MLP on the same
    pool; (c) ``spark.run`` over ``FakeSparkContext`` and (d)
    ``RayExecutor`` over ``fake_ray``, 2 processes each, run
    :func:`cluster_allreduce_task` in a fork of the zygote
    (:func:`cluster_worlds`). Returns the record with the paths'
    launches (``cluster``: (a)'s rank 0; ``spark``, ``ray``: rank 0)."""
    import copy
    import functools
    import shutil

    import numpy as np

    from horovod_tpu_torch import estimator as est_mod
    from horovod_tpu_torch.executor import Executor
    from horovod_tpu_torch.models import mlp as mlp_mod
    from horovod_tpu_torch.models import vit as vit_mod
    from horovod_tpu_torch.spark.torch import TorchEstimator
    from horovod_tpu_torch.store import LocalStore

    t_phase = time.perf_counter()
    rec = {"world": "gloo, 2 processes on one card"}
    store_dir = os.path.join(out_dir, "cluster_store")
    shutil.rmtree(store_dir, ignore_errors=True)
    store = LocalStore(store_dir)
    _free_parent(torch)
    model = seeded(torch, vit_mod.vit_base, image_size=VIT_IMAGE)
    images, labels = image_batch(torch, CLUSTER_IMAGES, VIT_IMAGE, 1000, 15)
    X, Y = images.cpu().numpy(), labels.cpu().numpy()
    est_model = copy.deepcopy(model).cpu()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        t0 = time.perf_counter()
        with Executor(np=2) as pool:
            rec["pool_start_s"] = time.perf_counter() - t0
            # (a) ViT-B/16 through the TorchEstimator.
            t0 = time.perf_counter()
            trained = TorchEstimator(
                model=est_model, optimizer=functools.partial(
                    torch.optim.SGD, lr=CLUSTER_LR), loss="cross_entropy",
                store=store, num_proc=2, epochs=1, batch_size=CLUSTER_BATCH,
                run_id="cluster_vit", device="cuda", backend="gloo").fit(
                    X, Y, executor=pool)
            rec["fit_s"] = time.perf_counter() - t0
            workers = trained.worker_results
            # (b) the MLP through the Estimator, on the same pool.
            g = np.random.default_rng(16)
            run = CLUSTER_MLP_RUN
            mx = g.standard_normal((run["rows"], CLUSTER_MLP["in_features"])
                                   ).astype(np.float32)
            my = g.integers(0, CLUSTER_MLP["num_classes"], run["rows"])
            mlp = mlp_mod.MLP(**CLUSTER_MLP).init_weights(
                torch.Generator().manual_seed(5))
            t0 = time.perf_counter()
            mlp_trained = est_mod.Estimator(
                model=mlp, optimizer=functools.partial(torch.optim.SGD,
                                                       lr=run["lr"]),
                loss="softmax_cross_entropy", store=store, num_proc=2,
                epochs=run["epochs"], batch_size=run["batch"],
                run_id="cluster_mlp", seed=run["seed"], device="cuda",
                backend="gloo").fit(mx, my, executor=pool)
            rec["mlp_fit_s"] = time.perf_counter() - t0
        # (a)'s checks: every rank's launches, losses against the oracle.
        steps = CLUSTER_IMAGES // 2 // CLUSTER_BATCH
        for w in workers:
            for name in FLASH_NAMES:
                check(w["launches"][name] == model.num_layers * steps,
                      f"cluster (a): rank {w['rank']} {name} launched "
                      f"{w['launches'][name]} times, expected "
                      f"{model.num_layers} x {steps}")
            check(w["launches"]["scale_buffer"] == 0,
                  f"cluster (a): rank {w['rank']} launched K1 "
                  f"{w['launches']['scale_buffer']} times (Average must not)")
        oracle_losses = _vit_oracle(torch, model, images, labels)
        loss_err = max(abs(a - b) / abs(b) for w in workers
                       for a, b in zip(w["losses"],
                                       oracle_losses[w["rank"]]))
        check(loss_err <= CLUSTER_LOSS_RTOL,
              f"cluster (a): step losses {[w['losses'] for w in workers]} "
              f"vs the oracle's {oracle_losses}: {loss_err} > "
              f"{CLUSTER_LOSS_RTOL}")
        final = store.read_obj(store.path_join(
            store.get_checkpoint_path("cluster_vit"), "torch_final.pkl"))
        want = model.state_dict()
        dw = max((torch.from_numpy(final[k]).cuda() - want[k]).abs().max()
                 .item() for k in want)
        update = max((want[k] - init[k]).abs().max().item() for k in want)
        check(update > 0 and dw <= CLUSTER_WEIGHT_RTOL * update,
              f"cluster (a): rank 0's weights off the oracle's by {dw}, "
              f"the largest update {update}")
        x8 = X[:CLUSTER_TRANSFORM]
        logits, t_launch = _counted(torch, K, lambda: trained.transform(x8))
        check(t_launch["flash_fwd"] == model.num_layers
              and t_launch["flash_bwd_dq"] == t_launch["flash_bwd_dkv"] == 0,
              f"cluster (a): transform launched {t_launch}")
        model.eval()
        with torch.no_grad():
            ref = model(images[:CLUSTER_TRANSFORM]).float().cpu().numpy()
        logit_err = float(np.abs(logits - ref).max())
        check(logits.shape == (CLUSTER_TRANSFORM, 1000)
              and np.isfinite(logits).all()
              and logit_err <= CLUSTER_LOGIT_RTOL * np.abs(ref).max(),
              f"cluster (a): transform's logits off the oracle's by "
              f"{logit_err}")
        rec["vit"] = {
            "model": "vit_base", "image": VIT_IMAGE, "tokens": VIT_PATH[1],
            "images": CLUSTER_IMAGES, "batch_a_rank": CLUSTER_BATCH,
            "steps": steps, "lr": CLUSTER_LR,
            "losses": {w["rank"]: w["losses"] for w in workers},
            "oracle_losses": oracle_losses, "loss_rel_err": loss_err,
            "step_ms": {w["rank"]: w["step_ms"] for w in workers},
            "launches": {w["rank"]: w["launches"] for w in workers},
            "weight_dw": dw, "largest_update": update,
            "weight_ratio": dw / update,
            "weight_bound": CLUSTER_WEIGHT_RTOL,
            "transform_launches": t_launch, "logit_err": logit_err,
            "logit_bound": CLUSTER_LOGIT_RTOL * float(np.abs(ref).max())}
        del model, want, init, trained
        # (b)'s checks against its oracle on the card.
        mlp_ref = mlp_mod.MLP(**CLUSTER_MLP).init_weights(
            torch.Generator().manual_seed(5)).cuda()
        history = _mlp_oracle(torch, mlp_ref, torch.from_numpy(mx).cuda(),
                              torch.from_numpy(my).cuda())
        h_err = max(abs(a - b) for a, b in zip(mlp_trained.history, history))
        w_err = max((torch.from_numpy(np.asarray(mlp_trained.params[k]))
                     .cuda() - v).abs().max().item()
                    for k, v in mlp_ref.state_dict().items())
        w_max = max(v.abs().max().item()
                    for v in mlp_ref.state_dict().values())
        check(len(mlp_trained.history) == run["epochs"]
              and h_err <= CLUSTER_MLP_RTOL * max(map(abs, history))
              and w_err <= CLUSTER_MLP_RTOL * w_max,
              f"cluster (b): history {mlp_trained.history} vs {history}, "
              f"weights off by {w_err} (largest {w_max})")
        rec["mlp"] = {"history": mlp_trained.history,
                      "oracle_history": history, "history_err": h_err,
                      "weight_err": w_err, "largest_weight": w_max,
                      "step_ms": {r["rank"]: r["step_ms"]
                                  for r in mlp_trained.worker_results}}
        # (c) and (d) in a fork of the zygote (no CUDA context), whose
        # fakes fork their tasks and actors with torch imported.
        worlds = run_forked(["--cluster-worlds"], "cluster_worlds",
                            CLUSTER_WORLDS_TIMEOUT, out_dir)
        spark_res, ray_res = worlds.pop("spark"), worlds.pop("ray")
        rec["worlds_s"] = worlds.pop("wall_s")
        rec.update(worlds)
        _check_world(torch, spark_res, "cluster (c) spark.run")
        _check_world(torch, ray_res, "cluster (d) RayExecutor")
        rec["spark"] = spark_res
        rec["ray"] = ray_res
    finally:
        # The checkpoint (ViT-B/16's fp32 weights) is too large to keep.
        shutil.rmtree(store_dir, ignore_errors=True)
    rec["launches"] = {"cluster": workers[0]["launches"],
                       "spark": spark_res[0]["launches"],
                       "ray": ray_res[0]["launches"]}
    rec["phase_s"] = time.perf_counter() - t_phase
    with open(os.path.join(out_dir, "chip_smoke_cluster.json"), "w") as f:
        json.dump(rec, f, indent=1)
    step_ms = {r: [round(t, 1) for t in v]
               for r, v in rec["vit"]["step_ms"].items()}
    print(f"cluster: pool of 2 up in {rec['pool_start_s']:.1f} s; vit_base "
          f"fit {rec['fit_s']:.1f} s, step ms {json.dumps(step_ms)}, loss "
          f"rel err {loss_err:.2e}, weights "
          f"{rec['vit']['weight_ratio']:.2e} of the largest update, logits "
          f"off {logit_err:.3e}; mlp fit {rec['mlp_fit_s']:.1f} s (history "
          f"err {h_err:.1e}); spark.run {rec['spark_run_s']:.1f} s, "
          f"RayExecutor up {rec['ray_start_s']:.1f} s, run "
          f"{rec['ray_run_s']:.1f} s ((c) and (d) {rec['worlds_s']:.1f} s "
          f"in a fork of the zygote); phase {rec['phase_s']:.1f} s "
          f"(gloo, 2 processes on one card)", flush=True)
    return rec


# -- phase 16: the fleet twin and the framework shims -------------------------

#: (a): the banked records the port replays on the card, by kind.
FLEET_SCENARIOS = ("preempt_storm_4k", "diurnal_serve", "overload_storm")
#: (b): the fleet serving world at full width — diurnal_serve's policy,
#: hosts and replicas, a diurnal trace at phase 5's prompt and output
#: lengths, 4 slots a replica (diurnal_serve's) with lines for the longest
#: prompt and output, fp32 KV, and one replica_kill from a seeded plan.
#: The seed is one whose last drain (r5, on the way down) finds a sequence
#: in flight, so that it migrates (the decisions do not depend on the
#: weights: the CPU run of a tiny GPT gives this log too).
FLEET_WORLD = {"requests": 48, "base_rps": 2.0, "peak_rps": 24.0,
               "period_s": 8.0, "seed": 20, "hosts": 6, "replicas": 2,
               "slots": 4, "max_len": 320, "max_prompt_len": 256,
               "prompt_lens": (64, 128, 256), "output_lens": (16, 32),
               "kill": {"seed": 20, "faults": [
                   {"site": "replica_kill", "step": 30, "target": "r0"}]}}
#: (c): the MXNet shim's arrays (GPT-2 medium's bias width x 1,024).
MX_ELEMENTS = 1 << 20
MX_PRE, MX_POST = 0.5, 3.0


def _fleet_record_diff(got: dict, want: dict) -> str:
    """The first key where a fleet record differs from its banked one."""
    for key in sorted(set(got) | set(want)):
        if got.get(key) != want.get(key):
            return f"{key}: {json.dumps(got.get(key))[:300]} vs " \
                   f"{json.dumps(want.get(key))[:300]}"
    return ""


def _stream_gap(torch, model, tokens) -> dict:
    """The next-token top-2 logit gap after ``tokens`` (one full
    forward of ``model``), absolute and of max |logit|."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        row = model(torch.tensor([tokens], device=dev))[0, -1].float()
    top = torch.topk(row, 2)
    gap = float(top.values[0] - top.values[1])
    return {"gap": gap, "rel_gap": gap / float(row.abs().max())}


def fleet_world(torch, K, factory, drain_mode: str, dev: str = "cuda"):
    """One run of (b): the port's ``run_serve_world`` over FLEET_WORLD
    under diurnal_serve's policy with ``drain_mode``. Returns (report,
    cluster, launches counted around the run, each round's wall ms)."""
    from horovod_tpu_torch.common import faults as faults_lib
    from horovod_tpu_torch.common import fleetsim
    from horovod_tpu_torch.serve.controller import SLOPolicy

    w = FLEET_WORLD
    policy = SLOPolicy.from_dict(dict(
        fleetsim.builtin_scenarios()["diurnal_serve"].policy,
        drain_mode=drain_mode))
    trace = fleetsim.diurnal_trace(
        w["seed"], w["requests"], w["base_rps"], w["peak_rps"],
        w["period_s"], prompt_lens=w["prompt_lens"],
        output_lens=w["output_lens"], vocab_size=50257)
    kill = faults_lib.FaultInjector(
        faults_lib.FaultPlan.from_json(json.dumps(w["kill"])), log_path="",
        rank="driver", host="sim")
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    stamps = []
    sync()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rep, _hm, cluster = fleetsim.run_serve_world(
        factory=factory, policy=policy, trace=trace,
        hosts=[f"host{i}" for i in range(w["hosts"])],
        replicas=w["replicas"], kill_injector=kill,
        on_round=lambda c, i: stamps.append(time.perf_counter()))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rep["wall_s"] = wall
    rep["kill_injections"] = len(kill.injections)
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return rep, cluster, launches, ms, trace


def phase_fleet(torch, K, out_dir: str, model, dev: str = "cuda") -> dict:
    """Phase 16: (a) the banked fleet scenarios through the port's
    ``run_scenario``; (b) the fleet serving world on phase 5's GPT-2
    medium ``model`` (migrate twice, local once); (c) the MXNet shim in a
    one-rank NCCL world. Returns the record with ``launches`` (K2/K4 and
    K5 over (a)'s serve scenarios and (b)'s runs) and
    ``mxnet_launches`` (K1 over (c))."""
    import numpy as np

    from horovod_tpu_torch.common import fleetsim
    from horovod_tpu_torch.serve.engine import make_engine_factory

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    total = {k: 0 for k in K.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (a) Each banked record, exactly, on the port with no jax here.
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results", "fleetsim")
    scen = {}
    for name in FLEET_SCENARIOS:
        with open(os.path.join(root, f"{name}.json")) as f:
            want = json.load(f)
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if want["kind"] == "serve":
            got, rep = fleetsim.serve_scenario_report(name, device=dev)
        else:
            got, rep = fleetsim.run_scenario(name, device=dev), {}
        sync()
        secs = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        check(got == want, f"fleet (a): {name} differs from "
                           f"results/fleetsim/{name}.json at "
                           f"{_fleet_record_diff(got, want)}")
        moved = sum(1 for e in rep.get("events", ()) if e[1] == "migrate")
        if dev == "cuda":
            check(launches["dequantize_int8"] == moved
                  and launches["quantize_int8"] >= moved,
                  f"fleet (a): {name} migrated {moved} sequences; K2/K4 "
                  f"launched {launches['quantize_int8']}/"
                  f"{launches['dequantize_int8']}")
        add(launches)
        scen[name] = {"s": secs, "decisions": len(got["decisions"]),
                      "migrated": moved, "launches": launches}
        print(f"fleet (a): {name} equals the banked record "
              f"({len(got['decisions'])} decisions, {moved} migrated) in "
              f"{secs:.2f} s", flush=True)

    # (b) The serving world at full width: migrate twice, local once.
    w = FLEET_WORLD
    factory = make_engine_factory(model, device=dev, slots=w["slots"],
                                  max_len=w["max_len"],
                                  max_prompt_len=w["max_prompt_len"],
                                  kv_kind="fp32")
    runs = {}
    for arm in ("migrate", "migrate_again", "local"):
        rep, cluster, launches, ms, trace = fleet_world(
            torch, K, factory, "local" if arm == "local" else "migrate", dev)
        by_rid = {}
        for r in cluster.completed:
            check(r.rid not in by_rid, f"fleet (b) {arm}: rid {r.rid} "
                                       "completed twice")
            by_rid[r.rid] = list(r.tokens)
        check(rep["dropped"] == 0 and sorted(by_rid) == sorted(
            r.rid for r in trace.requests),
              f"fleet (b) {arm}: dropped {rep['dropped']}, completed "
              f"{len(by_rid)} of {len(trace.requests)}")
        for req in trace.requests:
            check(len(by_rid[req.rid]) == req.max_new_tokens,
                  f"fleet (b) {arm}: rid {req.rid} {len(by_rid[req.rid])} "
                  f"tokens of {req.max_new_tokens}")
        moved = [e[2] for e in rep["events"] if e[1] == "migrate"]
        if dev == "cuda":
            check(launches["dequantize_int8"] == len(moved)
                  and launches["quantize_int8"] >= len(moved),
                  f"fleet (b) {arm}: {len(moved)} migrated; K2/K4 "
                  f"launched {launches['quantize_int8']}/"
                  f"{launches['dequantize_int8']}")
        if arm != "local":
            add(launches)
        runs[arm] = {"rep": rep, "tokens": by_rid, "moved": moved,
                     "launches": launches, "round_ms": ms}
    a, b, loc = runs["migrate"], runs["migrate_again"], runs["local"]
    check(a["moved"], "fleet (b): no drain migrated a sequence")
    check(a["rep"]["kill_injections"] == 1
          and any(e[1] == "replica_kill" for e in a["rep"]["events"]),
          "fleet (b): the replica_kill did not land")
    check(json.dumps(a["rep"]["decisions"]) ==
          json.dumps(b["rep"]["decisions"])
          and a["rep"]["events"] == b["rep"]["events"],
          "fleet (b): two runs of the migrate arm gave different decision "
          "logs or events")
    # Migrated streams against the same requests drained locally.
    prompts = {r.rid: list(r.prompt)[-w["max_prompt_len"]:]
               for r in trace.requests}
    same, parted = 0, []
    for rid in a["moved"]:
        x, y = a["tokens"][rid], loc["tokens"][rid]
        if x == y:
            same += 1
            continue
        i = next(j for j in range(len(y)) if x[j] != y[j])
        parted.append(dict(_stream_gap(torch, model, prompts[rid] + y[:i]),
                           rid=rid, position=i, migrate=x[i], local=y[i]))
    gen = a["rep"]["generated_tokens"]
    res_b = {
        "model": "gpt_medium", "layers": model.num_layers,
        "kv_kind": "fp32", **{k: v for k, v in w.items() if k != "kill"},
        "kill": w["kill"], "policy": "diurnal_serve",
        "decisions": a["rep"]["decisions"],
        "decision_actions": [json.loads(d)["action"]
                             for d in a["rep"]["decisions"]],
        "rounds": a["rep"]["rounds"], "generated_tokens": gen,
        "wall_s": {k: r["rep"]["wall_s"] for k, r in runs.items()},
        "tokens_per_wall_s": {k: r["rep"]["generated_tokens"]
                              / r["rep"]["wall_s"] for k, r in runs.items()},
        "round_ms_median": {k: statistics.median(r["round_ms"])
                            for k, r in runs.items()},
        "latency_p99_s": a["rep"]["latency_p99_s"],
        "migrated": len(a["moved"]), "migrated_rids": a["moved"],
        "local_migrated": len(loc["moved"]),
        "launches": {k: r["launches"] for k, r in runs.items()},
        "streams_equal_local": same, "streams_parted": parted,
        "repeat_identical": True}
    print(f"fleet (b): gpt_medium {w['requests']} requests over "
          f"{a['rep']['rounds']} rounds, {len(a['moved'])} migrated "
          f"(K2/K4 {a['launches']['quantize_int8']}/"
          f"{a['launches']['dequantize_int8']}), dropped 0; "
          f"{res_b['tokens_per_wall_s']['migrate']:.1f} tok/s, "
          f"{res_b['round_ms_median']['migrate']:.1f} ms a round (median); "
          f"decision log identical over two runs; {same} of "
          f"{len(a['moved'])} migrated streams equal the local drain's"
          + "".join(f"; rid {p['rid']} parts at token {p['position']} "
                    f"(top-2 gap {p['gap']:.4g} = {p['rel_gap']:.3g} of "
                    f"max|logit|)" for p in parted), flush=True)

    # (c) The MXNet shim on a one-rank NCCL world: numpy in, K1 on the
    # card for each scaled allreduce's pre- and postscale.
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.mxnet as hvdm

    ctx = hvd.init(device=None if dev == "cuda" else dev)
    check(hvdm.size() == 1 and (dev != "cuda" or ctx.backend == "nccl"),
          f"fleet (c): world {hvdm.size()} over {ctx.backend}")
    g = np.random.default_rng(160)
    cases = 0
    t0 = time.perf_counter()
    sync()
    K.reset_launch_counts()
    for dt in (np.float32, np.float16):
        x = (g.standard_normal(MX_ELEMENTS) * 3).astype(dt)
        pre, post = dt(MX_PRE), dt(MX_POST)
        for average in (False, True):
            got = hvdm.allreduce(x, average=average, name=f"mx.{dt.__name__}"
                                 f".{average}", prescale_factor=MX_PRE,
                                 postscale_factor=MX_POST)
            check(got.dtype == x.dtype and np.array_equal(
                got, (x * pre) * post),
                  f"fleet (c): allreduce {dt.__name__} average={average} "
                  "differs from (x * pre) * post")
            cases += 1
        t = x.copy()
        ret = hvdm.allreduce_(t, average=False, name=f"mx_.{dt.__name__}",
                              prescale_factor=MX_PRE,
                              postscale_factor=MX_POST)
        check(ret is t and np.array_equal(t, (x * pre) * post),
              f"fleet (c): allreduce_ {dt.__name__} differs")
        u = np.zeros_like(x)
        hvdm.broadcast_(u, root_rank=0, name=f"mxb.{dt.__name__}")
        check(np.array_equal(u, np.zeros_like(x))
              and np.array_equal(hvdm.broadcast(x, 0, name=f"mxb2."
                                                f"{dt.__name__}"), x),
              f"fleet (c): broadcast {dt.__name__} differs")
        ag = hvdm.allgather(x.reshape(1024, -1), name=f"mxg.{dt.__name__}")
        check(np.array_equal(ag, x.reshape(1024, -1)),
              f"fleet (c): allgather {dt.__name__} differs")
        cases += 3
    mx_launches = (sync(), dict(K.LAUNCHES))[1]
    mx_s = time.perf_counter() - t0

    class _SGD:
        """A duck-typed mx.optimizer.Optimizer."""
        lr, rescale_grad = 0.1, 1.0

        def update(self, index, weight, grad, state):
            weight -= np.float32(self.lr * self.rescale_grad) * grad

    opt = hvdm.DistributedOptimizer(_SGD())
    w0 = g.standard_normal(MX_ELEMENTS).astype(np.float32)
    grad = g.standard_normal(MX_ELEMENTS).astype(np.float32)
    wt = w0.copy()
    opt.update(0, wt, grad.copy(), None)
    check(np.array_equal(wt, w0 - np.float32(0.1) * grad),
          "fleet (c): DistributedOptimizer's step differs from SGD's")
    cases += 1
    scaled = 2 * 3                    # two dtypes x three scaled calls
    if dev == "cuda":
        check(mx_launches["scale_buffer"] == 2 * scaled,
              f"fleet (c): K1 launched {mx_launches['scale_buffer']} times, "
              f"expected 2 x {scaled} (pre- and postscale)")
    hvd.shutdown()
    print(f"fleet (c): the MXNet shim on a one-rank {ctx.backend} world, "
          f"{cases} results equal their hand values, K1 "
          f"{mx_launches['scale_buffer']} launches, {mx_s:.2f} s",
          flush=True)

    rec = {"scenarios": scen, "world": res_b,
           "mxnet": {"cases": cases, "elements": MX_ELEMENTS,
                     "launches": mx_launches, "s": mx_s},
           "launches": total, "mxnet_launches": mx_launches,
           "phase_s": time.perf_counter() - t_phase}
    with open(os.path.join(out_dir, "chip_smoke_fleet.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"fleet: K2/K4 {total['quantize_int8']}/"
          f"{total['dequantize_int8']} launches, K5 {total['flash_fwd']} "
          f"over (a) and (b); phase {rec['phase_s']:.1f} s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the full JSON records")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve run and two extra training "
                         "steps of each trained model with "
                         "torch.profiler (slows the host; the serve "
                         "run's wall numbers are then not the unprofiled "
                         "ones)")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--zygote"]:
        zygote_main(main, *argv[1:2])
        return 0
    if argv[:1] == ["--via-zygote"]:
        return via_zygote(argv[1:])
    if argv[:1] == ["--module"]:
        # ``python -m MODULE ARGS`` in this process (a zygote's fork).
        import runpy

        sys.argv = list(argv[1:])
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        return 0
    if argv[:1] == ["--cluster-worlds"]:
        cluster_worlds(argv[1])
        return 0
    if argv[:1] == ["--elastic-worker"]:
        elastic_worker(argv[1])
        return 0
    if argv[:1] == ["--hybrid-elastic-worker"]:
        hybrid_elastic_worker(argv[1])
        return 0
    if argv[:1] == ["--telemetry-worker"]:
        telemetry_worker(argv[1])
        return 0
    if argv[:1] == ["--autotune-worker"]:
        autotune_worker(argv[1])
        return 0
    if argv[:1] == ["--rank-worker"]:
        worker = {"n2_eager": eager_worker, "n2_join": join_worker,
                  MESH_CONFIG: mesh_worker, ZERO_CONFIG: zero_worker,
                  OVERLAP_N2: overlap_worker,
                  OVERLAP_N4: overlap_worker,
                  PARALLEL_CONFIG: parallel_worker,
                  PIPE_CONFIG: pipeline_worker,
                  MOE_REF_CONFIG: pipeline_worker,
                  SERVE_TP_CONFIG: serve_tp_worker}.get(argv[1],
                                                        rank_worker)
        worker(argv[1], int(argv[2]), argv[3])
        return 0
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    try:
        from horovod_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        from concurrent.futures import ThreadPoolExecutor

        from horovod_tpu_torch import native

        warm = bytecode_cache()
        zygote()
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                # The native host library (g++) beside the kernels (nvcc).
                host = pool.submit(lambda: (native.build(),
                                            time.perf_counter() - t0))
                libs = K.build_all()
                built = time.perf_counter() - t0
                host_lib, host_s = host.result()
            # The warm-up and the zygote's imports end before the first
            # timed phase starts.
            warm_err = warm.communicate(timeout=600)[1]
            zygote().wait_ready()
        finally:
            if warm.poll() is None:
                warm.kill()
                warm.wait()
        check(warm.returncode == 0, f"bytecode warm-up: exit "
                                    f"{warm.returncode}:\n{warm_err[-3000:]}")
        print(f"build: {', '.join(lib.name for lib in libs)} in "
              f"{built:.1f} s; native {host_lib.name} in {host_s:.1f} s; "
              f"bytecode cache warm at {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(native.available(), "the native library does not load")
        from horovod_tpu_torch.ops import collectives as C

        marks = [time.perf_counter()]
        phase_s = {}

        def mark(name: str) -> None:
            # Each phase's seconds: the smoke runs against a time limit.
            marks.append(time.perf_counter())
            phase_s[name] = marks[-1] - marks[-2]
            print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

        records = phase_scale_kernel(torch, K, C)
        records.update(phase_kernels(torch, K))
        records.update(phase_flash(torch, K))
        records.update(phase_reduce_kernels(torch, K))
        mark("kernels")
        keep = {}
        serve = phase_serve(torch, K, args.out, args.profile, keep)
        levers = phase_serve_levers(torch, K, args.out, keep["model"])
        mark("serve, serve levers")
        # Phase 16 on phase 5's model, while it is on the card.
        fleet = phase_fleet(torch, K, args.out, keep.pop("model"))
        torch.cuda.empty_cache()
        mark("fleet, shims")
        train = phase_train(torch, K, args.out, args.profile)
        integ = phase_integrity(torch, K, args.out, args.profile)
        mark("train, integrity")
        bert = phase_bert(torch, K, args.out, args.profile)
        vit = phase_vit(torch, K, args.out, args.profile)
        resnet = phase_resnet(torch, K, args.out, args.profile)
        zoo = phase_zoo(torch)
        mark("zoo")
        multi = phase_multirank(torch, args.out)
        eager = phase_eager(torch, args.out)
        mark("multi-rank, eager")
        mesh = phase_mesh(torch, args.out)
        zero = phase_zero(torch, args.out)
        mark("mesh, zero")
        overlap = phase_overlap(torch, args.out)
        mark("overlap")
        elastic = phase_elastic(torch, args.out)
        mark("elastic")
        telemetry = phase_telemetry(torch, args.out)
        mark("telemetry")
        autotune = phase_autotune(torch, args.out)
        mark("autotune")
        parallel = phase_parallel(torch, args.out)
        mark("parallel")
        pipe = phase_pipeline(torch, args.out)
        mark("pipeline")
        hybrid = phase_elastic_hybrid(torch, args.out)
        mark("elastic hybrid")
        cluster = phase_cluster(torch, K, args.out)
        mark("cluster")
        n2 = multi["n2_gpt_medium"]["modes"]
        # Every path a kernel runs on, each counted from zero around it;
        # the mesh path (phase 7b) is one of them for K1-K4, K8 and K9.
        paths = {"quantize_int8": {"serve": serve["launches"],
                                   **levers["launches"]},
                 "dequantize_int8": {"serve": serve["launches"],
                                     **levers["launches"]},
                 "quantize_int8_stochastic": {
                     "multirank_n2": n2["int8_ef"]["launches"]},
                 "adasum_dot_norms": {
                     "multirank_n2": n2["adasum"]["launches"]},
                 "adasum_combine": {
                     "multirank_n2": n2["adasum"]["launches"]}}
        integ_runs = integ["runs"]
        flash_paths = {"gpt_train": train["launches"],
                       "bert": bert["launches"], "vit": vit["launches"],
                       "integrity_none": integ_runs["none/scale_backoff"][
                           "launches"],
                       "integrity_full": integ_runs["full/scale_backoff"][
                           "launches"],
                       "zero": zero["launches"],
                       "overlap": overlap["launches"],
                       "elastic": elastic["launches"],
                       "telemetry": telemetry["launches"],
                       "autotune": autotune["launches"],
                       "parallel": parallel["launches"],
                       "pipeline": pipe["launches"]["pipeline"],
                       "moe": pipe["launches"]["moe"],
                       "elastic_hybrid": hybrid["launches"],
                       # Phase 15 (a): rank 0 of the TorchEstimator fit.
                       "cluster": cluster["launches"]["cluster"]}
        # K1 runs on the eager path (pre/postscale) and as the guard's
        # unscale on the integrity path.
        paths["scale_buffer"] = {
            "eager": eager["launches"],
            "integrity_unscale": {"scale_buffer": sum(
                r["launches"]["scale_buffer"] for r in integ_runs.values())},
            # Phase 15 (c) and (d): rank 0 of the spark.run and
            # RayExecutor worlds (pre- and postscale).
            "spark": cluster["launches"]["spark"],
            "ray": cluster["launches"]["ray"],
            # Phase 16 (c): the MXNet shim's scaled allreduces.
            "mxnet": fleet["mxnet_launches"]}
        for name in ("scale_buffer", "quantize_int8", "dequantize_int8",
                     "quantize_int8_stochastic", "adasum_dot_norms",
                     "adasum_combine"):
            paths[name]["mesh"] = mesh["launches"]
        # The ZeRO path (phase 7c): K3 in (c)'s quantized reduce-scatter,
        # K1 as (e)'s unscale.
        for name in ("scale_buffer", "quantize_int8_stochastic"):
            paths[name]["zero"] = zero["launches"]
        # Phase 7d: K1 (the Adasum guard's unscale), K3, K8, K9; phase 8:
        # K3 (the flash kernels take both through flash_paths).
        for name in ("scale_buffer", "quantize_int8_stochastic",
                     "adasum_dot_norms", "adasum_combine"):
            paths[name]["overlap"] = overlap["launches"]
        paths["quantize_int8_stochastic"]["elastic"] = elastic["launches"]
        # Phase 9 (b): K3 and the flash kernels, rank 0's first epoch.
        paths["quantize_int8_stochastic"]["telemetry"] = \
            telemetry["launches"]
        # Phase 10: K3 and the flash kernels, rank 0 over the whole run.
        paths["quantize_int8_stochastic"]["autotune"] = autotune["launches"]
        # Phase 13: K3 on the int8 dp hop and the flash kernels, the
        # dp0/pp0 rank of both worlds.
        paths["quantize_int8_stochastic"]["elastic_hybrid"] = \
            hybrid["launches"]
        # Phase 11: the flash kernels on every arm (through flash_paths),
        # K2 and K4 on the ring_int8 arm's K/V hops.
        for name in ("quantize_int8", "dequantize_int8"):
            paths[name]["parallel"] = parallel["launches"]
            # Phase 12: the pp_int8 arm's stage boundary and the
            # moe_ep_int8 arm's ep exchanges.
            paths[name]["pipeline"] = pipe["launches"]["pipeline"]
            paths[name]["moe"] = pipe["launches"]["moe"]
            # Phase 16: the fleet serving world's migrate drains (and
            # (a)'s serve scenarios, whose drains find none in flight).
            paths[name]["fleet"] = fleet["launches"]
        for name in FLASH_NAMES:
            paths[name] = flash_paths
        for name, rec in records.items():
            # Each path a kernel is on must launch it.
            by_path = {p: c[name] for p, c in paths[name].items()}
            check(min(by_path.values()) > 0,
                  f"{name}: no launch on a path: {by_path}")
            rec["launches_by_path"] = by_path
            rec["launches"] = sum(by_path.values())
        for name in ("quantize_int8", "dequantize_int8"):
            records[name]["leaves_on_path"] = serve["codec_leaves"][name]
    except (SmokeError, RuntimeError, OSError, ValueError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    finally:
        close_zygote()
    kernels = {"kernels": list(records.values())}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "phase_s": phase_s,
                   "phases_total_s": sum(phase_s.values()), **kernels,
                   "serve": serve, "serve_levers": levers,
                   "train": train, "integrity": integ,
                   "bert": bert,
                   "vit": vit, "resnet": resnet, "zoo": zoo,
                   "multirank": {c: {k: v for k, v in r.items()
                                     if k != "modes"}
                                 for c, r in multi.items()},
                   "eager": {k: v for k, v in eager.items()
                             if k not in ("ranks", "join")},
                   "mesh": mesh, "zero": zero, "overlap": overlap,
                   "elastic": elastic, "telemetry": telemetry,
                   "autotune": autotune, "parallel": parallel,
                   "pipeline": pipe, "elastic_hybrid": hybrid,
                   "cluster": cluster, "fleet": fleet}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
