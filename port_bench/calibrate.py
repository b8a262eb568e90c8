#!/usr/bin/env python3
"""Readings of ``correct.py``'s numbers over many seeds, for setting a
cell's limits: the program's (``port``), the control's (the reference
with fp8 operands in the program's place) and each planted fault's
(``unchanged``, ``half``, ``noexchange``, ``altered``, ``lr``), each on
its first ``COMPARED_STEPS`` steps through the window's call and feed,
against one plain reference a seed. No window is run. One JSON line a seed, worst
over the ranks.

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --programs port,control,half,unchanged,noexchange
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import card, run  # noqa: E402


def main(argv=None) -> int:
    card.pin_caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--programs", default="port,control,half,unchanged,"
                    "noexchange,altered")
    args = ap.parse_args(argv)
    _, spec = run.spec_for(args.workload, 0, 0.0, 0, T_START)
    spec.update(calibrate=True,
                seeds=[int(s) for s in args.seeds.split(",")],
                programs=args.programs.split(","))
    from port_bench import registry

    drv = registry.loop(spec["workload"]["loop"])
    print(card.card_lines(), flush=True)
    ranks = drv.launch(spec)
    for i, seed in enumerate(spec["seeds"]):
        line = {"seed": seed}
        for name in spec["programs"]:
            per_rank = [r["calibration"][i] for r in ranks
                        if name in r["calibration"][i]]
            if per_rank:
                line[name] = drv.worst([c[name] for c in per_rank])
                line[name + "_leaves"] = per_rank[0][name + "_leaves"]
        for name in spec["programs"]:
            per_rank = [r["calibration"][i][name + "_levels"] for r in ranks
                        if name + "_levels" in r["calibration"][i]]
            if per_rank:
                line[name + "_levels"] = {
                    q: drv.worst([c[q] for c in per_rank])
                    for q in per_rank[0]}
        line["reference_losses"] = [r["calibration"][i]["reference_losses"]
                                    for r in ranks]
        print("CAL " + json.dumps(run.finite(line)), flush=True)
    found = sorted({m for r in ranks for m in r["forbidden"]}
                   | set(card.forbidden_modules()))
    if found:
        print(f"JAX modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
