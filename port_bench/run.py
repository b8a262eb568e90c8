#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the card's name, power limit and link topology once the run is
over (outside its set-up and its window), then, as the last line of
standard output, one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the checks are also
the last lines of standard error. Exits non-zero and prints no result when
the machine lacks the cell's GPUs, the run fails, or a JAX module was
loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import card, registry  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def spec_for(name: str, seed: int, seconds: float, trace: int,
             t_start: float):
    """``(BENCHMARK.json, the run's spec)``: the cell's files, the run's
    arguments, the port on the GPUs."""
    bench = registry.benchmark()
    entry, wl, cfg, tr = registry.resolve(bench, name)
    return bench, {"cell": entry, "workload": wl, "config": cfg,
                   "traffic": tr, "seed": seed, "seconds": seconds,
                   "trace": trace, "t_start": t_start, "device": "cuda",
                   "program": "port"}


def finite(x):
    """The object with every non-finite float as None (JSON has no NaN)."""
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    card.pin_caches()
    args = parse(argv)
    bench, spec = spec_for(args.workload, args.seed, args.seconds,
                           args.trace, T_START)
    import torch

    chips = spec["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    drv = registry.loop(spec["workload"]["loop"])
    kind = "per_layer" if args.trace else "end_to_end"
    ranks = drv.launch(spec)
    out = drv.report(spec, ranks, registry.metrics_for(bench, args.workload,
                                                       kind))
    print(card.card_lines(), flush=True)
    found = sorted(set(out["forbidden"]) | set(card.forbidden_modules()))
    if found:
        print(f"port_bench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    for note in out["notes"]:
        print(note, file=sys.stderr)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out["result"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
