#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure exits non-zero and prints no result line):

1. Card: print the card's name and power limit (nvidia-smi) and build
   the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc, one
   compiler per source, side by side.
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
   tensor, and D = 128 causal; bounds fp32 2e-4 (forward) and 5e-3
   (gradients), bf16 2e-2. K6 and K7 are held there both as two calls
   and as the training path's one backward call (``flash_bwd``). Each
   record names its route by dtype. Times at the training shape in
   bf16: CUDA graph replay over 8 distinct input sets, eager, the plain
   version, and the library call ``scaled_dot_product_attention(
   is_causal=True)`` (its forward against K5, its backward — a graph of
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
   card, not of NCCL or NVLink.
8. Eager engine: the script relaunches itself as 2 gloo rank workers
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
   begin/end pair per gradient. Then MoE-shaped exchanges of (4096, 1024)
   tokens per rank (``alltoall`` on the none/bf16/int8 wires — int8 must
   launch K2 and K4 — with uneven splits, an Average ``reducescatter``,
   a ragged ``allgatherv``), held against plain results from every rank's
   input; ``broadcast_object`` of the optimizer's hyperparameters; and a
   mismatch (rank 1 submits ``"probe"`` with another shape: both ranks
   raise ``MismatchError`` naming rank 1 within the controller timeout,
   and the next collective succeeds). A second configuration
   (``n2_join``) runs ``init(join_mode=True)``: rank 1 trains 2 steps and
   joins, rank 0 trains 3 and joins; rank 0's third-step gradients must
   be bitwise ``plain(plain(g0, 1/3) + 0, 1.5)`` and ``join()`` must
   return 0 on both. Step times are gloo with 2 processes on one card.
9. Result lines: the per-kernel JSON record (K1-K9, each with its
   launches on its path), the card line, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` also traces the serve run and two extra training steps
with torch.profiler (after the timed steps, so the timed numbers stay
unprofiled) and prints the device busy share and the top device ops.

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


# (B, S, H, D), dtype name, causal, key mask, nonzero dlse, and whether
# q, k, v are ``split`` views of one (B, S, 3 H D) tensor, as
# ``CausalSelfAttention`` makes them (row stride 3 H D: the TMA strides)
FLASH_PATH = (8, 512, 16, 64)       # the training path's attention shape
FLASH_CASES = (
    (FLASH_PATH, "bfloat16", True, False, False, False),
    (FLASH_PATH, "float32", True, False, False, False),
    ((2, 256, 4, 64), "float32", False, True, False, False),
    ((2, 256, 4, 128), "float32", True, False, True, False),
    ((2, 200, 4, 64), "float32", True, True, True, False),
    ((2, 200, 4, 128), "bfloat16", False, False, True, False),
    ((2, 200, 4, 64), "bfloat16", True, True, True, False),
    (FLASH_PATH, "bfloat16", True, False, False, True),
    ((2, 256, 4, 128), "bfloat16", True, False, False, False),
)
FLASH_TOL = {"float32": (2e-4, 5e-3), "bfloat16": (2e-2, 2e-2)}
FLASH_TIMING_SETS = 8               # distinct inputs per graph replay


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


def flash_inputs(torch, shape, dtype, mask_on, dlse_on, gen,
                 fused=False):
    b, s, h, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    if fused:
        qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, -1))
    mask = None
    if mask_on:
        mask = (torch.rand((b, s), generator=gen, device="cuda") > 0.3
                ).float()
        mask[:, 0] = 1.0
    dlse = torch.randn((b, h, s), generator=gen, device="cuda") \
        if dlse_on else None
    return q, k, v, do, mask, dlse


def flash_work(shape) -> dict:
    """Bytes each kernel must move (inputs read once, outputs written
    once) and FLOPs the causal work needs, at bf16 q/k/v/do/o/dq/dk/dv
    and fp32 lse/delta, without dlse."""
    b, s, h, d = shape
    x = b * s * h * d * 2                  # one bf16 (B, S, H, D) tensor
    row = b * h * s * 4                    # one fp32 (B, H, S) vector
    pairs = b * h * s * (s + 1) // 2       # causal (query, key) pairs
    return {"flash_fwd": (4 * x + row, 4 * pairs * d),
            "flash_bwd_dq": (5 * x + 2 * row, 6 * pairs * d),
            "flash_bwd_dkv": (6 * x + 2 * row, 8 * pairs * d)}


def phase_flash(torch, K) -> dict:
    """Hold K5/K6/K7 against their plain versions on the card; time them
    at the training path's shape."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape, dname, causal, mask_on, dlse_on, fused in FLASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v, do, mask, dlse = flash_inputs(torch, shape, dtype, mask_on,
                                               dlse_on, gen, fused)
        fwd_tol, grad_tol = FLASH_TOL[dname]
        what = (f"{shape} {dname} causal={causal} mask={mask_on} "
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
    print(f"kernels: K5/K6/K7 agree with plain on {len(FLASH_CASES)} cases; "
          f"max abs err {json.dumps(errs)}", flush=True)

    sets = []
    for _ in range(FLASH_TIMING_SETS):
        q, k, v, do, _, _ = flash_inputs(torch, FLASH_PATH, torch.bfloat16,
                                         False, False, gen)
        o, lse = K._flash_fwd_plain(q, k, v, None, True)
        sets.append((q, k, v, do, o, lse, K.flash_delta(o, do)))
    torch.cuda.synchronize()
    fns = {
        "flash_fwd": (
            lambda x: K.flash_fwd(x[0], x[1], x[2], None, True),
            lambda x: K._flash_fwd_plain(x[0], x[1], x[2], None, True)),
        "flash_bwd_dq": (
            lambda x: K.flash_bwd_dq(x[0], x[1], x[2], None, True, x[3],
                                     x[5], x[6]),
            lambda x: K._flash_bwd_dq_plain(x[0], x[1], x[2], None, True,
                                            x[3], x[5], x[6])),
        "flash_bwd_dkv": (
            lambda x: K.flash_bwd_dkv(x[0], x[1], x[2], None, True, x[3],
                                      x[5], x[6]),
            lambda x: K._flash_bwd_dkv_plain(x[0], x[1], x[2], None, True,
                                             x[3], x[5], x[6])),
    }
    # The yardstick: one PyTorch call of the same function on the same
    # (B, S, H, D) tensors, viewed as (B, H, S, D). Timed only; the port
    # never calls it. Its backward is the device time of a graph of
    # forward + backward less that of the forward alone.
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd(x):
        return sdpa(*(t.transpose(1, 2) for t in x[:3]), is_causal=True)

    def lib_fwd_bwd(x):
        q, k, v = (t.transpose(1, 2).detach().requires_grad_()
                   for t in x[:3])
        o = sdpa(q, k, v, is_causal=True)
        return torch.autograd.grad(o, (q, k, v), x[3].transpose(1, 2))

    fwd_ms = graph_ms(torch, lib_fwd, sets)
    bwd_ms = graph_ms(torch, lib_fwd_bwd, sets) - fwd_ms
    library = {"flash_fwd": fwd_ms, "flash_bwd_dq": bwd_ms,
               "flash_bwd_dkv": bwd_ms}
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
    # The training path's backward: K6 then K7 in one call.
    bwd_one = [graph_ms(torch, lambda x: K.flash_bwd(
        x[0], x[1], x[2], None, True, x[4], x[5], x[3]), sets)
        for _ in range(2)]
    records = {}
    for name, (nbytes, flops) in flash_work(FLASH_PATH).items():
        fn, plain = fns[name]
        # Turns: plain, kernel, kernel, plain (one card, one call).
        p1 = graph_ms(torch, plain, sets)
        k1 = graph_ms(torch, fn, sets)
        k2 = graph_ms(torch, fn, sets)
        p2 = graph_ms(torch, plain, sets)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / BF16_OPS_PER_S * 1e3
        records[name] = {
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{lines[name]}",
            "launches": 0,
            "design": designs[name],
            "max_abs_err": errs[name],
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops
            else "operations",
            "library_ms": library[name],
            "library_call": "scaled_dot_product_attention(is_causal=True) "
                            + ("forward" if name == "flash_fwd" else
                               "backward (dq, dk, dv: K6 + K7 together)"),
            "eager_ms": eager_ms(torch, fn, sets),
            "plain_eager_ms": eager_ms(torch, plain, sets),
            "bytes": nbytes, "flops": flops,
            "shape": list(FLASH_PATH), "dtype": "bfloat16", "causal": True,
        }
        if name != "flash_fwd":
            # delta = rowsum(do * o) included, as in SDPA's backward
            records[name]["bwd_one_call_ms"] = min(bwd_one)
        r = records[name]
        print(f"kernel {name}: {r['ms'] * 1e3:.1f} us/launch (graph) vs "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); plain "
              f"{r['plain_ms'] * 1e3:.1f} us; library "
              f"{r['library_ms'] * 1e3:.1f} us; eager "
              f"{r['eager_ms'] * 1e3:.1f} us; {r['design']}", flush=True)
    print(f"kernel flash_bwd (K6 + K7, one call, delta included): "
          f"{min(bwd_one) * 1e3:.1f} us (graph) vs SDPA backward "
          f"{bwd_ms * 1e3:.1f} us", flush=True)
    del sets
    torch.cuda.empty_cache()
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


def phase_serve(torch, K, out_dir: str, profile: bool = False) -> dict:
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

    # Wall-clock view of the virtual-time run: a round's wall span is
    # hook(r) .. hook(r + 1).
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
    wall_s = round_t[-1] - round_t[0]
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
    return result


TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# Flash vs plain attention, one forward and backward, by compute dtype:
# (loss relative error, per-parameter relative Frobenius gradient error).
REF_RTOL = {"bfloat16": (1e-3, 2e-2), "float32": (1e-5, 1e-3)}


def reference_step(torch, model, tokens, gpt_mod, fa) -> dict:
    """One forward and backward on the same weights and batch, with the
    flash kernels and with the plain attention; returns the loss gap and
    the worst per-parameter relative Frobenius gradient error."""
    def plain_attend(q, k, v, mask=None):
        return fa.reference_attention(q, k, v, mask, causal=True)

    out = {}
    for label, attend in (("flash", None), ("plain", plain_attend)):
        model.attend_fn = attend
        model.zero_grad(set_to_none=True)
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
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
    ref = {}
    for dname, m in (("bfloat16", model), ("float32", fp32_model)):
        r = ref[dname] = reference_step(torch, m, tokens, gpt_mod, fa)
        loss_tol, grad_tol = REF_RTOL[dname]
        print(f"reference ({dname}): flash vs plain attention loss rel "
              f"err {r['loss_rel_err']:.3g} (limit {loss_tol}); worst grad "
              f"rel err {r['grad_rel_err_max']:.3g} on "
              f"{r['grad_rel_err_param']} (limit {grad_tol})", flush=True)
        check(r["loss_rel_err"] <= loss_tol,
              f"reference ({dname}): loss rel err {r['loss_rel_err']} > "
              f"{loss_tol}")
        check(r["grad_rel_err_max"] <= grad_tol,
              f"reference ({dname}): {r['grad_rel_err_param']} gradient "
              f"rel err {r['grad_rel_err_max']} > {grad_tol}")
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


# -- multi-rank phase: n processes on the one card, collectives over gloo --

MULTI_WARMUP, MULTI_STEPS = 1, 3
MULTI_CONFIGS = {
    # n, model, per-rank batch, sequence length, worker timeout (s)
    "n2_gpt_medium": (2, "gpt_medium", 8, 512, 600),
    "n4_gpt_tiny": (4, "gpt_tiny", 8, 128, 300),
}
ADASUM_REF_RTOL = 1e-5              # reduced delta vs the fp64 reference


def _make_model(torch, gpt_mod, name):
    with torch.device("cuda"):
        model = gpt_mod.gpt_medium() if name == "gpt_medium" else \
            gpt_mod.gpt_tiny(hidden=128, num_heads=2)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return model


class _Digest:
    """Per-tensor fingerprints of the parameters, on the card: the int32
    bit patterns of each tensor summed plain and weighted by a fixed
    pseudo-random int64 sequence (integer sums: exact in any order).
    Equal parameters give equal digests; a one-bit difference changes
    them."""

    def __init__(self, torch, params):
        n = max(p.numel() for p in params)
        idx = torch.arange(n, device="cuda", dtype=torch.int64)
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
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def run_workers(config: str, n: int, timeout: float, out_dir: str):
    """Relaunch this script as the n rank workers of ``config`` on the
    one card, each with HVD_TPU_COORDINATOR/NUM_PROC/PROC_ID; any
    worker's failure or overrun fails the phase. Returns each rank's JSON
    record and the wall seconds; the logs go to
    ``multirank_<config>.log``."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC=str(n))
    paths = [os.path.join(out_dir, f"multirank_{config}_rank{r}.json")
             for r in range(n)]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker",
         config, str(r), paths[r]],
        env=dict(env, HVD_TPU_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = [""] * n
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0]
    except subprocess.TimeoutExpired:
        raise SmokeError(f"multi-rank {config}: a worker passed its "
                         f"{timeout} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(out_dir, f"multirank_{config}.log"), "w") as f:
        f.write("\n".join(f"--- rank {r}\n{log}"
                          for r, log in enumerate(logs)))
    for r, p in enumerate(procs):
        check(p.returncode == 0,
              f"multi-rank {config}: rank {r} exited {p.returncode}:\n"
              f"{logs[r][-3000:]}")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


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
        results[config] = res
    with open(os.path.join(out_dir, "chip_smoke_multirank.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


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


def eager_worker(config: str, rank: int, out_path: str) -> None:
    """One rank of the eager phase (``--rank-worker n2_eager``): GPT-2
    medium trained 1 checked + 3 timed steps in Horovod's PyTorch loop,
    then the timeline, the MoE-shaped exchanges, an object broadcast and a
    mismatch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, model_name, batch, seq, _ = EAGER_CONFIGS[config]
    ctx, model, opt, named, fwd_bwd = _eager_setup(torch, hvd, gpt_mod,
                                                   config, rank)
    ctl = ctx.controller
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
        "timeline_tensors": len(phases), "hyperparameters": repr(hp)})
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
           "mismatch": r0["mismatch"], "ranks": ranks}
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
          f"check {json.dumps(res['check'])}; mismatch "
          f"{json.dumps(res['mismatch'])}; moe exchanges "
          f"{res['moe']['seconds']:.2f} s; launches "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the full JSON records")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve run and two extra training "
                         "steps with torch.profiler (slows the host; the "
                         "serve run's wall numbers are then not the "
                         "unprofiled ones)")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-worker"]:
        worker = {"n2_eager": eager_worker, "n2_join": join_worker}.get(
            argv[1], rank_worker)
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
        libs = K.build_all()
        print(f"build: {', '.join(lib.name for lib in libs)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        from horovod_tpu_torch.ops import collectives as C

        records = phase_scale_kernel(torch, K, C)
        records.update(phase_kernels(torch, K))
        records.update(phase_flash(torch, K))
        records.update(phase_reduce_kernels(torch, K))
        serve = phase_serve(torch, K, args.out, args.profile)
        train = phase_train(torch, K, args.out, args.profile)
        multi = phase_multirank(torch, args.out)
        eager = phase_eager(torch, args.out)
        n2 = multi["n2_gpt_medium"]["modes"]
        paths = {"scale_buffer": eager["launches"],
                 "quantize_int8": serve["launches"],
                 "dequantize_int8": serve["launches"],
                 "quantize_int8_stochastic": n2["int8_ef"]["launches"],
                 "adasum_dot_norms": n2["adasum"]["launches"],
                 "adasum_combine": n2["adasum"]["launches"]}
        for name, rec in records.items():
            rec["launches"] = paths.get(name, train["launches"])[name]
            check(rec["launches"] > 0, f"{name}: no launch on its path")
        for name in ("quantize_int8", "dequantize_int8"):
            records[name]["leaves_on_path"] = serve["codec_leaves"][name]
    except (SmokeError, RuntimeError, OSError, ValueError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    kernels = {"kernels": list(records.values())}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, **kernels,
                   "serve": serve, "train": train,
                   "multirank": {c: {k: v for k, v in r.items()
                                     if k != "modes"}
                                 for c, r in multi.items()},
                   "eager": {k: v for k, v in eager.items()
                             if k not in ("ranks", "join")}}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
