"""Overload control for the serve plane: multi-tenant SLO classes,
deadline-aware admission, and the brownout degradation ladder
(docs/serve.md "Overload & tenancy").

The port's copy of ``horovod_tpu/serve/overload.py``.

Horovod's core robustness idea — degrade deterministically instead of
failing (the join op / elastic shrink) — applied to serving. Three
mechanisms, each data-driven off :class:`~.controller.SLOPolicy`:

* **SLO classes** — ``latency`` / ``throughput`` / ``batch`` tenancy
  tiers. Each class carries a priority (strict across classes), a
  default deadline, and a retry budget (shed / re-route attempts are
  self-limiting so retries cannot amplify an overload). The class
  table is pure data: :func:`classes_from_policy` materializes it from
  the policy's per-class scalar fields.
* **Deadline-aware admission** — :func:`admission_estimate` prices a
  request from the controller's windowed per-phase percentiles
  (queue-wait + TTFT residual + ``max_new_tokens`` x TPOT); the
  cluster SHEDS requests that cannot feasibly meet their deadline
  *before* spending prefill on them
  (``hvd_tpu_serve_shed_total{slo_class,reason}``).
* **Brownout ladder** — :class:`BrownoutLadder`, a deterministic
  hysteresis-gated state machine over :data:`BROWNOUT_RUNGS`. Under
  sustained queue pressure the cluster climbs one rung per controller
  tick (disable speculative decode -> clamp throughput-tier
  ``max_new_tokens`` -> shed the batch tier -> reject non-latency
  admission) and descends the same way once pressure clears. Every
  transition is a ``brownout`` line in the serve decision log — the
  same ``{"seq", "action", "target", "reason"}`` contract as
  autoscale/respec, byte-identical under seeded ``--repeat`` runs.

No wall-clock reads, no RNG: every transition is a pure function of
(policy, observed queue depth, tick count), which is what lets the
chaos soak byte-compare decision sequences across repeats.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..common import metrics as metrics_lib
from ..common.config import runtime_env

#: Tenancy tiers, priority order (first = most protected).
SLO_CLASSES = ("latency", "throughput", "batch")

#: The degradation ladder, mildest rung first. Level N means rungs
#: [0, N) are active; the ladder moves at most ONE rung per controller
#: tick in either direction (hysteresis-gated), so decision logs stay
#: byte-identical under seeded repeats.
BROWNOUT_RUNGS = ("spec_off", "clamp_tokens", "shed_batch",
                  "reject_admission")

_M_SHED = metrics_lib.counter(
    "hvd_tpu_serve_shed_total",
    "requests shed by overload control before spending prefill, by "
    "SLO class and reason (deadline = infeasible at admission, "
    "brownout = ladder shed the tier, retry_budget = re-route budget "
    "exhausted) — docs/serve.md 'Overload & tenancy'",
    labels=("slo_class", "reason"))
_M_BROWNOUT_LEVEL = metrics_lib.gauge(
    "hvd_tpu_serve_brownout_level",
    "current brownout ladder level (0 = off; level N = the first N "
    "rungs of spec_off -> clamp_tokens -> shed_batch -> "
    "reject_admission are active)")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One tenancy tier, materialized from the policy's scalar fields.

    ``priority`` orders classes strictly (lower = served first);
    ``deadline_s`` is the class default stamped onto requests that
    arrive without one (0 = none); ``retry_budget`` bounds how many
    re-route / re-prefill attempts a request of this class may burn
    before it is shed (``retry_budget`` reroutes are allowed; the
    next one sheds)."""

    name: str
    priority: int
    deadline_s: float
    retry_budget: int


def classes_from_policy(policy) -> Dict[str, SLOClass]:
    """The class table as data: one :class:`SLOClass` per tier from
    the policy's ``<class>_deadline_s`` / ``<class>_priority`` /
    ``<class>_retry_budget`` scalar fields."""
    return {
        name: SLOClass(
            name=name,
            priority=int(getattr(policy, f"{name}_priority")),
            deadline_s=float(getattr(policy, f"{name}_deadline_s")),
            retry_budget=int(getattr(policy, f"{name}_retry_budget")))
        for name in SLO_CLASSES
    }


def class_priorities(policy) -> Dict[str, int]:
    """name -> priority, the strict cross-class order the class-aware
    ``RequestQueue`` sorts by (unclassed requests rank as priority 0,
    i.e. with the latency tier — legacy traffic is never starved by
    classed traffic)."""
    return {name: cls.priority
            for name, cls in classes_from_policy(policy).items()}


def record_shed(slo_class: str, reason: str) -> None:
    """One shed, attributed (docs/metrics.md)."""
    _M_SHED.labels(slo_class=slo_class or "latency", reason=reason).inc()


def admission_estimate(controller,
                       max_new_tokens: int) -> Optional[float]:
    """Estimated request completion latency (virtual seconds) from the
    controller's windowed per-phase p99s: queue-wait + TTFT residual
    (prefill cost net of the queue wait already inside TTFT) +
    ``max_new_tokens`` x TPOT. ``None`` until the window has evidence
    for both TTFT and TPOT — with no evidence the gate admits (the
    first requests of a run must never be shed by an empty window)."""
    ttft = controller.windowed_ttft_p99()
    tpot = controller.windowed_tpot_p99()
    if ttft is None or tpot is None:
        return None
    qwait = controller.windowed_queue_wait_p99() or 0.0
    prefill = max(0.0, ttft - qwait)
    return qwait + prefill + max(0, int(max_new_tokens)) * tpot


class BrownoutLadder:
    """Deterministic, hysteresis-gated degradation state machine.

    ``tick(queue_depth)`` is called once per controller tick. Depth at
    or above ``brownout_enter_depth`` for ``brownout_enter_ticks``
    consecutive ticks climbs ONE rung; depth at or below
    ``brownout_exit_depth`` for ``brownout_exit_ticks`` consecutive
    ticks descends one. Anything in between resets both streaks (the
    hysteresis band). Returns ``(level, rung, direction)`` on a
    transition, ``None`` otherwise — the controller turns transitions
    into ``brownout`` decision-log lines.

    ``HVD_TPU_SERVE_BROWNOUT`` (docs/serve.md) pins the level for
    operator override — the runbook's "force the ladder" lever; the
    pin also moves one rung per tick so the decision log still reads
    as a sequence."""

    def __init__(self, policy):
        self.policy = policy
        self.level = 0
        self.max_level = 0
        self._hot = 0
        self._cool = 0

    def active(self, rung: str) -> bool:
        """Is ``rung`` (a :data:`BROWNOUT_RUNGS` name) in effect?"""
        return self.level > BROWNOUT_RUNGS.index(rung)

    def rung_name(self) -> str:
        """The deepest active rung ('' at level 0)."""
        return BROWNOUT_RUNGS[self.level - 1] if self.level else ""

    def _pinned(self) -> Optional[int]:
        raw = runtime_env("SERVE_BROWNOUT", "")
        if raw is None or raw == "":
            return None
        try:
            return max(0, min(len(BROWNOUT_RUNGS), int(raw)))
        except ValueError:
            return None

    def tick(self, queue_depth: int
             ) -> Optional[Tuple[int, str, str]]:
        p = self.policy
        pin = self._pinned()
        if pin is not None:
            if pin > self.level:
                return self._climb("pinned")
            if pin < self.level:
                return self._descend("pinned")
            return None
        enter = int(p.brownout_enter_depth)
        if enter <= 0:
            return None  # ladder disabled
        exit_d = int(p.brownout_exit_depth)
        if queue_depth >= enter:
            self._hot += 1
            self._cool = 0
            if self._hot >= int(p.brownout_enter_ticks) \
                    and self.level < len(BROWNOUT_RUNGS):
                self._hot = 0
                return self._climb(f"queue_depth={queue_depth}")
        elif queue_depth <= exit_d:
            self._cool += 1
            self._hot = 0
            if self._cool >= int(p.brownout_exit_ticks) \
                    and self.level > 0:
                self._cool = 0
                return self._descend(f"queue_depth={queue_depth}")
        else:
            # Hysteresis band: neither streak accumulates.
            self._hot = 0
            self._cool = 0
        return None

    def _climb(self, why: str) -> Tuple[int, str, str]:
        self.level += 1
        self.max_level = max(self.max_level, self.level)
        _M_BROWNOUT_LEVEL.set(self.level)
        return (self.level, BROWNOUT_RUNGS[self.level - 1],
                f"enter:{why}")

    def _descend(self, why: str) -> Tuple[int, str, str]:
        rung = BROWNOUT_RUNGS[self.level - 1]
        self.level -= 1
        _M_BROWNOUT_LEVEL.set(self.level)
        return (self.level, rung, f"exit:{why}")
