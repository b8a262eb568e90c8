#!/usr/bin/env python3
"""Where a gloo world's start-up goes on one card, with and without a
bytecode cache.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_startup.py [--out DIR]

It starts, one after another, a world of 2 rank processes three times:
``cold`` (``PYTHONDONTWRITEBYTECODE=1`` and an empty
``PYTHONPYCACHEPREFIX``: every module compiled from source, as on a
machine that keeps no ``.pyc`` beside torch), then once with
``chip_smoke.bytecode_cache()``'s cache after its warm-up (``cached``,
twice). Each rank marks the seconds since its parent's ``Popen``:
``import_torch``, ``import_port`` (``horovod_tpu_torch``, its GPT and
``chip_smoke``), ``cuda`` (a context and one tensor on the card),
``init`` (``hvd.init(backend="gloo")``), ``model`` (GPT-2 medium's
widths at 2 layers on the card), ``optimizer`` (an int8_ef
``DistributedOptimizer`` over AdamW: torch's first ``torch.optim``
call imports ``torch._dynamo``) and ``step1``-``step3`` (B = 4, S = 512).
Prints one line ``STARTUP {json}`` a world (each rank's marks, the
world's wall seconds), the warm-up's seconds, the card line, and last
``{"ok": true}``. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

STEPS = 3


def rank_main(rank: int, out: str) -> None:
    t_launch = float(os.environ["STARTUP_T0"])
    marks = {}

    def mark(name: str) -> None:
        marks[name] = time.time() - t_launch

    import torch
    mark("import_torch")
    import chip_smoke as C
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt as gpt_mod
    mark("import_port")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    mark("cuda")
    hvd.init(backend="gloo")
    mark("init")
    model = C.integrity_model(torch, gpt_mod, "cuda", layers=2)
    torch.cuda.synchronize()
    mark("model")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4),
        named_parameters=model.named_parameters(), compression="int8_ef")
    mark("optimizer")
    for s in range(STEPS):
        tokens = torch.randint(0, model.vocab_size, (4, 513),
                               generator=torch.Generator().manual_seed(
                                   100 * s + rank)).to("cuda")
        loss = gpt_mod.next_token_loss(model(tokens[:, :-1]), tokens[:, 1:])
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        mark(f"step{s + 1}")
    hvd.shutdown()
    with open(out, "w") as f:
        json.dump({k: round(v, 3) for k, v in marks.items()}, f)


def world(label: str, env_extra: dict, out_dir: str, n: int = 2) -> dict:
    """Start ``n`` rank processes at once and wait for them; returns each
    rank's marks and the world's wall seconds."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    outs = [os.path.join(out_dir, f"startup_{label}_rank{r}.json")
            for r in range(n)]
    t0 = time.time()
    env = dict(os.environ, **env_extra, STARTUP_T0=repr(t0),
               HVD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               HVD_TPU_NUM_PROC=str(n))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         outs[r]], cwd=root, env=dict(env, HVD_TPU_PROC_ID=str(r)))
        for r in range(n)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"{label}: a rank exited {rcs}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return {"label": label, "n": n, "wall_s": round(time.time() - t0, 3),
            "ranks": ranks}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        rank_main(int(argv[1]), argv[2])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/startup")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_startup: torch unavailable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_startup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C

    os.makedirs(args.out, exist_ok=True)
    empty = tempfile.mkdtemp(prefix="hvd_nopyc_")
    try:
        print("STARTUP " + json.dumps(world(
            "cold", {"PYTHONDONTWRITEBYTECODE": "1",
                     "PYTHONPYCACHEPREFIX": empty}, args.out)), flush=True)
    finally:
        shutil.rmtree(empty, ignore_errors=True)
    t = time.time()
    warm = C.bytecode_cache()
    err = warm.communicate(timeout=600)[1]
    if warm.returncode != 0:
        print(f"chip_startup: warm-up failed:\n{err[-3000:]}",
              file=sys.stderr)
        return 1
    print(f"warm-up: {time.time() - t:.1f} s into "
          f"{os.environ['PYTHONPYCACHEPREFIX']}", flush=True)
    for i in (1, 2):
        print("STARTUP " + json.dumps(world(f"cached{i}", {}, args.out)),
              flush=True)
    print(C.card_line())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
