#!/usr/bin/env python3
"""Compare two trees of the port on one card: one prefill -> decode KV
handoff of GPT-2 medium through ``serve/kvcache.py`` (the int8 wire
codec K2/K4 and what surrounds it).

Run on a machine with one NVIDIA GPU, once per tree, in turns (A, B, B,
A) on one card, one after another, for example with the parent commit
unpacked into an ignored directory:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 chip_ab_handoff.py $t; done

Each run imports ``horovod_tpu_torch`` from TREE, builds its int8 codec,
makes two bf16 caches of the serve cell's geometry (GPT-2 medium's 24
layers x (k, v) = 48 K/V leaves of (8 slots, 1024 lines, 16 heads, 64)),
fills them from a seed, and prints one line ``AB {json}``:

- ``handoff_graph_us``: device µs per handoff, ``export_slot(src, 3)``
  then ``import_slot(dst, 5, blob)``, 8 handoffs captured in one CUDA
  graph, the median of 20 replays over 8;
- ``export_host_us``, ``import_host_us``: host µs per call, to its
  return without a synchronize (argument checks, allocation, launches),
  the median of 50;
- ``handoff_wall_us``: export, import and a synchronize, the median of
  50;
- ``launches``: K2 and K4 launches per handoff;
- ``digest``: sha256 of the destination slot after one handoff, equal
  across trees whose codec computes the same bits.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

LAYERS, SLOTS, MAX_LEN, HEADS, HEAD_DIM = 24, 8, 1024, 16, 64
SRC_SLOT, DST_SLOT = 3, 5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(tree: str) -> int:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.serve import kvcache as kv

    if not K.__file__.startswith(root):
        print(f"chip_ab_handoff: imported {K.__file__}, not {root}'s port",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_handoff: no CUDA device", file=sys.stderr)
        return 2
    K.build_library("int8_codec.cu")
    out = {"tree": tree, "card": card_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    src, dst = (kv.init_cache(LAYERS, SLOTS, MAX_LEN, HEADS, HEAD_DIM,
                              dtype=torch.bfloat16, device="cuda")
                for _ in range(2))
    for layer in src["layers"]:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda"))

    def handoff():
        kv.import_slot(dst, DST_SLOT, kv.export_slot(src, SRC_SLOT))

    K.reset_launch_counts()
    handoff()
    torch.cuda.synchronize()
    out["launches"] = {name: K.LAUNCHES[name]
                       for name in ("quantize_int8", "dequantize_int8")}
    digest = hashlib.sha256()
    for layer in dst["layers"]:
        for leaf in layer.values():
            digest.update(leaf[DST_SLOT].view(torch.int16).cpu().numpy()
                          .tobytes())
    out["digest"] = digest.hexdigest()[:16]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        handoff()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(8):
            handoff()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / 8)
    out["handoff_graph_us"] = statistics.median(times)
    del graph

    exp, imp, wall = [], [], []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = kv.export_slot(src, SRC_SLOT)
        t1 = time.perf_counter()
        kv.import_slot(dst, DST_SLOT, blob)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        exp.append((t1 - t0) * 1e6)
        imp.append((t2 - t1) * 1e6)
        wall.append((t3 - t0) * 1e6)
    out["export_host_us"] = statistics.median(exp)
    out["import_host_us"] = statistics.median(imp)
    out["handoff_wall_us"] = statistics.median(wall)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
