"""Collectives (``ops/collectives.py`` over NCCL): milliseconds a step in
which an NCCL kernel ran and no other kernel did, mean over the ranks.
Kernels are told apart by name (``nccl`` in it)."""

import statistics

from port_bench import trace


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(ctx):
    per_rank = [trace.exposed(t, is_nccl) * 1e-3 / t["steps"]
                for t in ctx.traces()
                if t["steps"] and any(is_nccl(d[0]) for d in t["device"])]
    return statistics.fmean(per_rank) if per_rank else None
