#!/usr/bin/env python3
"""Compare two trees of the port on one card: the flash wrappers' host
time per call and ``chip_smoke.py``'s training phase.

Run on a machine with one NVIDIA GPU, once per tree, in turns (A, B, B,
A) on one card, one after another, for example with the parent commit
unpacked into an ignored directory:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 chip_ab_train.py $t; done

Each run imports ``chip_smoke`` and ``horovod_tpu_torch`` from TREE,
builds its kernels, and prints one line ``AB {json}``:

- ``{fwd,dq,dkv,bwd}_{S}_host_us``: host µs per call of
  ``flash_fwd``/``flash_bwd_dq``/``flash_bwd_dkv``/``flash_bwd`` (the
  training path's backward: delta, K6 and K7; bf16, causal),
  launched back to back without a synchronize, at (1, 64, 1, 64), where
  the device work is negligible, and at the training shape (8, 512, 16,
  64); ``..._wall_us`` the same up to the synchronize after the last
  call;
- ``step_ms``: the five timed GPT-2-medium training steps of
  ``chip_smoke.phase_train`` (B = 8, S = 512, AdamW, NCCL world of one).
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(tree: str) -> int:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as C
    from horovod_tpu_torch.ops import kernels as K

    if not K.__file__.startswith(root):
        print(f"chip_ab_train: imported {K.__file__}, not {root}'s port",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_train: no CUDA device", file=sys.stderr)
        return 2
    K.build_all()
    out = {"tree": tree, "card": C.card_line()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((1, 64, 1, 64), C.FLASH_PATH):
        q, k, v, do, _, _ = C.flash_inputs(torch, shape, torch.bfloat16,
                                           False, False, gen)
        o, lse = K._flash_fwd_plain(q, k, v, None, True)
        delta = K.flash_delta(o, do)
        fns = {
            "fwd": lambda: K.flash_fwd(q, k, v, None, True),
            "dq": lambda: K.flash_bwd_dq(q, k, v, None, True, do, lse,
                                         delta),
            "dkv": lambda: K.flash_bwd_dkv(q, k, v, None, True, do, lse,
                                           delta),
            "bwd": lambda: K.flash_bwd(q, k, v, None, True, o, lse, do),
        }
        n = 200 if shape[0] == 1 else 50
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[f"{name}_{shape[1]}_host_us"] = (t1 - t0) / n * 1e6
            out[f"{name}_{shape[1]}_wall_us"] = (t2 - t0) / n * 1e6
    out_dir = os.path.join(root, "build", "chip_ab")
    os.makedirs(out_dir, exist_ok=True)
    r = C.phase_train(torch, K, out_dir, False)
    out["step_ms"] = r["step_ms"]
    out["step_ms_median"] = r["step_ms_median"]
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
