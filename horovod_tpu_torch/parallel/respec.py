"""Elastic reshape solver — re-solving dp x pp x tp (x sp) after capacity
loss; the port of ``horovod_tpu/parallel/respec.py``'s solver.

A flat elastic world reruns with ``np - slots`` after a host goes. Under
a hybrid :class:`~.spec.ParallelSpec` that is wrong twice over: a lost
host orphans a whole dp replica (its pp/tp peers hold parameters nothing
else has), and an arbitrary surviving count may admit no dp x pp x tp
factorization at all (7 ranks cannot host a 2x2x2 mesh). Given the
DECLARED spec and the surviving capacity, :func:`solve_respec`
deterministically re-solves the spec through a preference ladder:

``shed_dp``
    Drop whole data-parallel replicas first: the model still fits, only
    throughput shrinks. Refuses to go below ``min_dp``
    (``HVD_TPU_RESPEC_MIN_DP``).
``fold_pp``
    Fold pipeline stages onto fewer ranks: ``pp`` drops to its largest
    proper divisor that fits (the fewest folds).
``fold_sp``
    Fold sequence shards onto fewer ranks (pp already folded to 1):
    parameters stay replicated over sp, so the fold migrates no weights,
    which is why sp folds before tp drops.
``drop_tp``
    Give up tensor-parallel width: ``tp`` drops to a smaller divisor.
``dp_only``
    The last resort: every non-dp role collapses to 1 and the world runs
    as a flat dp mesh over whatever capacity remains.

Every rung yields a valid mesh by construction; a rung that cannot fit
defers to the next, and capacity that covers the declared spec answers
``keep``. Knobs: ``HVD_TPU_RESPEC`` (``0`` pins the declared mesh),
``HVD_TPU_RESPEC_ORDER`` (the permitted rungs, in order),
``HVD_TPU_RESPEC_MIN_DP`` (the replica floor; ``dp_only`` ignores it).
``hvd_tpu_respec_total{from,to}`` counts applied reshapes.

The autoscale engine's ``plan_respec`` applies a decision and the
elastic driver's respec epochs relaunch the world on the solved spec
(``common/autoscale.py``, ``runner/elastic_driver.py``). Stdlib-only at
import.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

from ..common import metrics as metrics_lib
from .spec import ParallelSpec

ENV_ENABLE = "HVD_TPU_RESPEC"
ENV_ORDER = "HVD_TPU_RESPEC_ORDER"
ENV_MIN_DP = "HVD_TPU_RESPEC_MIN_DP"

# The preference ladder, in its canonical (and default) order.
RUNGS = ("shed_dp", "fold_pp", "fold_sp", "drop_tp", "dp_only")

_M_RESPEC = metrics_lib.counter(
    "hvd_tpu_respec_total",
    "applied elastic mesh reshapes by (from,to) parallel spec",
    labels=("from", "to"))


@dataclasses.dataclass(frozen=True)
class RespecDecision:
    """One solver answer: the rung that fired (``keep`` when the declared
    spec still fits), the solved spec, and its world size."""

    action: str    # keep | shed_dp | fold_pp | fold_sp | drop_tp | dp_only
    spec: ParallelSpec
    np: int                  # spec.total — the world the driver assigns

    def describe(self) -> str:
        return f"{self.action}:{self.spec.describe()}"


def note_respec(prev: str, new: str) -> None:
    """Count an APPLIED reshape (the control plane calls it when a solved
    spec replaces the running one)."""
    _M_RESPEC.labels(**{"from": prev, "to": new}).inc()


def respec_enabled(env=None) -> bool:
    env = os.environ if env is None else env
    raw = (env.get(ENV_ENABLE) or "").strip().lower()
    return raw not in ("0", "false", "no", "off")


def respec_order(env=None) -> Tuple[str, ...]:
    """The permitted rungs, validated: an unknown rung name raises (a
    typo'd order that silently pinned the mesh would be worse)."""
    env = os.environ if env is None else env
    raw = env.get(ENV_ORDER)
    if not raw:
        return RUNGS
    rungs = tuple(p.strip() for p in raw.split(",") if p.strip())
    bad = [r for r in rungs if r not in RUNGS]
    if bad:
        raise ValueError(
            f"{ENV_ORDER}: unknown rung(s) {bad}; choose from {RUNGS}")
    return rungs


def respec_min_dp(env=None) -> int:
    env = os.environ if env is None else env
    try:
        return max(1, int(env.get(ENV_MIN_DP, "1")))
    except ValueError:
        return 1


def _divisors_desc(n: int) -> list:
    """Proper divisors of n, largest first (the fewest-folds order)."""
    return [d for d in range(n - 1, 0, -1) if n % d == 0]


def _rebuild(spec: ParallelSpec, sizes: dict) -> ParallelSpec:
    """The declared spec with per-role sizes overridden; the role order
    (slow -> fast placement) is kept."""
    return ParallelSpec(tuple((r, int(sizes.get(r, s)))
                              for r, s in spec.dims))


def solve_respec(spec: ParallelSpec, capacity: int,
                 min_dp: Optional[int] = None,
                 order: Optional[Sequence[str]] = None
                 ) -> Optional[RespecDecision]:
    """Re-solve ``spec`` for ``capacity`` surviving slots: the first rung
    (in ``order``) that admits a valid mesh, or None when no permitted
    rung fits (capacity < 1, or the order forbids every viable
    degradation) — the caller then waits for capacity.

    The returned spec's total is <= capacity, every size >= 1, the
    pp/sp/tp sizes divide the declared ones, and the same (spec,
    capacity, knobs) always gives the same answer."""
    if min_dp is None:
        min_dp = respec_min_dp()
    rungs = tuple(order) if order is not None else respec_order()
    bad = [r for r in rungs if r not in RUNGS]
    if bad:
        raise ValueError(f"unknown respec rung(s) {bad}; choose from "
                         f"{RUNGS}")
    capacity = int(capacity)
    if capacity < 1:
        return None
    if capacity >= spec.total:
        return RespecDecision("keep", spec, spec.total)

    d = spec.size_of("dp")
    pp = spec.size_of("pp")
    tp = spec.size_of("tp")
    sp = spec.size_of("sp")
    # The non-dp block no rung folds (ep and any size-1 declared roles):
    # ep is never degraded short of the dp_only rung.
    fixed = 1
    for role, size in spec.dims:
        if role not in ("dp", "pp", "tp", "sp"):
            fixed *= size

    def fit_dp(block: int) -> int:
        """Largest dp (<= declared) whose world fits the capacity."""
        return min(d, capacity // block) if block > 0 else 0

    for rung in rungs:
        if rung == "shed_dp":
            block = pp * tp * sp * fixed
            nd = fit_dp(block)
            if nd >= max(1, min_dp):
                return RespecDecision(
                    "shed_dp", _rebuild(spec, {"dp": nd}), nd * block)
        elif rung == "fold_pp":
            for npp in _divisors_desc(pp):
                block = npp * tp * sp * fixed
                nd = fit_dp(block)
                if nd >= max(1, min_dp):
                    return RespecDecision(
                        "fold_pp", _rebuild(spec, {"dp": nd, "pp": npp}),
                        nd * block)
        elif rung == "fold_sp":
            # With pp folded flat; nsp = 1 keeps the FULL tp, which is
            # what tells this rung from drop_tp.
            for nsp in _divisors_desc(sp):
                block = nsp * tp * fixed
                nd = fit_dp(block)
                if nd >= max(1, min_dp):
                    return RespecDecision(
                        "fold_sp",
                        _rebuild(spec, {"dp": nd, "pp": 1, "sp": nsp}),
                        nd * block)
        elif rung == "drop_tp":
            for ntp in _divisors_desc(tp):
                if ntp == 1:
                    continue    # tp=1 with pp=sp=1 is the dp_only rung
                block = ntp * fixed
                nd = fit_dp(block)
                if nd >= max(1, min_dp):
                    return RespecDecision(
                        "drop_tp",
                        _rebuild(spec, {"dp": nd, "pp": 1, "sp": 1,
                                        "tp": ntp}),
                        nd * block)
        elif rung == "dp_only":
            sizes = {r: 1 for r, _ in spec.dims}
            sizes["dp"] = capacity
            return RespecDecision(
                "dp_only", _rebuild(spec, sizes), capacity)
    return None


def min_world(spec: ParallelSpec, min_dp: Optional[int] = None,
              order: Optional[Sequence[str]] = None) -> int:
    """The smallest world the configured ladder can reshape down to: the
    driver's hard wait floor under involuntary capacity loss."""
    if min_dp is None:
        min_dp = respec_min_dp()
    rungs = tuple(order) if order is not None else respec_order()
    lo = spec.total
    for cap in range(spec.total, 0, -1):
        dec = solve_respec(spec, cap, min_dp=min_dp, order=rungs)
        if dec is None:
            break
        lo = dec.np if dec.np < lo else lo
    return lo
