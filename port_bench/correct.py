"""How ``correct`` is decided for a training cell.

The timed program's first ``COMPARED_STEPS`` steps (made in set-up through
the window's own step and feed) are held against the plain reference's
steps from the same weights and batches. Three numbers, each against the
cell's limit (``workloads/<cell>.json`` ``limits``):

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  steps and the ranks;
* ``grad_norm_gap``: over the leaves, the largest gap between the norm of
  the first gradient as the optimizer got it (its first moment after one
  step over ``1 - beta1``) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``update_norm_gap``: the same of the norm of each leaf's change over the
  compared steps, counted on both sides over the elements whose reference
  first gradient is at least ``QUIET`` of the median leaf's RMS gradient
  (the others, such as the key's part of a fused QKV bias under softmax,
  move under Adam by round-off alone; the rule reads the reference's
  gradient, never a name);
* ``update_median_gap``: the median over the leaves of that gap.

A reading that is not a number fails its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

#: Shares of the median leaf's RMS first gradient at which the change is
#: read; the compared numbers use ``QUIET``, the others are printed beside.
LEVELS = (0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
QUIET = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's ``|prog - ref|`` over the larger of its reference norm
    and the median leaf's."""
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, float("nan")) - ref[n]) / max(ref[n], floor)
            for n in names}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Sequence[str]):
    """``(gap, leaf)``: the worst leaf's gap and its name."""
    worst, where = 0.0, None
    for n, gap in leaf_gaps(prog, ref, names).items():
        if not gap <= worst:        # NaN is the worst
            worst, where = gap, n
    return worst, where


def readings(prog: dict, ref: dict):
    """``(values, worst leaves)``: ``prog``/``ref`` hold ``losses`` (per
    rank, per step), ``grad_norms`` and ``update_norms`` (leaf name ->
    norm)."""
    loss_gap = 0.0
    for p_rank, r_rank in zip(prog["losses"], ref["losses"]):
        for p, r in zip(p_rank, r_rank):
            gap = abs(p - r) / abs(r)
            if not gap <= loss_gap:
                loss_gap = gap
    names = list(ref["grad_norms"])
    grad, grad_leaf = norm_gap(prog["grad_norms"], ref["grad_norms"], names)
    update, update_leaf = norm_gap(prog["update_norms"], ref["update_norms"],
                                   names)
    gaps = leaf_gaps(prog["update_norms"], ref["update_norms"], names)
    median = (float("nan") if any(g != g for g in gaps.values())
              else statistics.median(gaps.values()))
    return {"loss_gap": loss_gap, "grad_norm_gap": grad,
            "update_norm_gap": update, "update_median_gap": median}, {"grad_norm_gap": grad_leaf,
                                         "update_norm_gap": update_leaf}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every reading at or under its limit; the
    checks in a fixed order, each ``{"value", "limit"}``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(isinstance(c["value"], float) and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
