#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. Card: print the card's name and power limit (nvidia-smi) and build
   the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc.
2. Kernels against their plain PyTorch versions, on the card, at the
   shapes of the serve path: one K/V leaf of GPT-2 medium,
   (max_len=1024, 16 heads, 64) bf16, plus ragged sizes. Codes and
   dequantized outputs must match bitwise, scales to 1e-6. Times: CUDA
   graph replay of one handoff's 48 launches over 48 distinct leaves
   (device time per launch), the same eager (host launch included), the
   plain version the same way, and the memory bound at 3.35 TB/s.
3. End to end: disaggregated serving (one prefill and one decode
   replica) of GPT-2 medium at full width — 24 layers, hidden 1024,
   16 heads, MLP 4096, vocab 50257, bf16 compute over fp32 weights from
   a seeded generator — with a 1024-line cache, 8 slots and prompts up
   to 256 tokens, over a seeded Poisson trace of 16 requests. The kernel
   launch counters are zeroed just before this run and read just after
   it; both kernels must have launched. Every request must complete with
   its full token count, with zero drops and at least one handoff. A
   reference check holds the bf16 cache-path logits against the same
   weights in fp32 on a short prompt.
4. Result lines: the per-kernel JSON record, the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12              # non-tensor-core fp32 peak
HANDOFF_LEAVES = 48                 # gpt_medium: 24 layers x (k, v)
LEAF = (1024, 16, 64)               # (max_len, heads, head_dim)
RAGGED = ((37, 16, 64), (5000,), (1,))
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


def phase_kernels(torch, K) -> dict:
    """Hold K2/K4 against their plain versions on the card; time them."""
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
    print(f"kernels: K2/K4 bitwise equal to plain on {len(cases)} shapes",
          flush=True)

    leaves = [torch.randn(LEAF, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(HANDOFF_LEAVES)]
    blobs = [K.quantize_int8(x) for x in leaves]
    torch.cuda.synchronize()

    def quant(x):
        return K.quantize_int8(x)

    def quant_plain(x):
        return K._quantize_plain(x)

    def deq(b):
        return K.dequantize_int8(b[0], b[1], b[2], LEAF, torch.bfloat16)

    def deq_plain(b):
        return K._dequantize_plain(b[0], b[1], b[2], LEAF, torch.bfloat16)

    n = leaves[0].numel()
    nblocks = -(-n // K.BLOCK)
    q_bytes = n * 2 + nblocks * K.BLOCK + nblocks * 4
    d_bytes = nblocks * K.BLOCK + nblocks * 4 + n * 2
    records = {}
    for name, fn, plain, inputs, nbytes, ops, err, line in (
            ("quantize_int8", quant, quant_plain, leaves, q_bytes, 6 * n,
             q_err, 225),
            ("dequantize_int8", deq, deq_plain, blobs, d_bytes, 2 * n,
             deq_err, 233)):
        # Turns: plain, kernel, kernel, plain (one card, one call).
        p1 = graph_ms(torch, plain, inputs)
        k1 = graph_ms(torch, fn, inputs)
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
            "shape": list(LEAF), "dtype": "bfloat16",
        }
        print(f"kernel {name}: {records[name]['ms'] * 1e3:.2f} us/launch "
              f"(graph) vs bound {records[name]['bound_ms'] * 1e3:.2f} us "
              f"({records[name]['bound_by']}); plain "
              f"{records[name]['plain_ms'] * 1e3:.2f} us; eager "
              f"{records[name]['eager_ms'] * 1e3:.2f} us", flush=True)
    return records


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
    for name, count in launches.items():
        check(count > 0, f"{name}: no kernel launch on the main path")
    leaves = 2 * model.num_layers
    check(launches["quantize_int8"] == leaves * rep["handoffs"],
          f"quantize launches {launches['quantize_int8']} != "
          f"{leaves} x {rep['handoffs']} handoffs")

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the full JSON records")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve run with torch.profiler and "
                         "time its phases (slows the host; its wall "
                         "numbers are not the unprofiled ones)")
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
        lib = K.build_library()
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        records = phase_kernels(torch, K)
        serve = phase_serve(torch, K, args.out, args.profile)
        for name, rec in records.items():
            rec["launches"] = serve["launches"][name]
    except (SmokeError, RuntimeError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    kernels = {"kernels": list(records.values())}
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, **kernels,
                   "serve": serve}, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
