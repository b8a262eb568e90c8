"""Request admission plane: the ``DeviceInfeed`` background-feed
pattern generalized to inference requests (docs/serve.md).

The port's copy of ``horovod_tpu/serve/queue.py``: host Python, the
same behaviour and metric names.

``DeviceInfeed`` (data.py) keeps a bounded queue of ready batches ahead
of a consumer and measures the consumer's wait; a serving replica needs
the same shape with requests instead of batches — a bounded FIFO the
router feeds asynchronously, the batcher drains into free decode slots,
and telemetry measures (queue depth, time-in-queue, deadline misses).
Unlike the infeed the queue must also run BACKWARD: a draining replica
re-routes its unstarted requests to peers (``drain()``), which is why
admission hands out ``Request`` objects rather than opaque batches.

Deterministic by construction: FIFO order, integer virtual-time stamps,
no wall-clock reads — the chaos soak's byte-identity contract
(docs/serve.md) starts here.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..common import metrics as metrics_lib
from . import tracing

_M_QUEUE_DEPTH = metrics_lib.gauge(
    "hvd_tpu_serve_queue_depth",
    "requests queued ahead of the decode slots, summed over this "
    "process's replicas")
_M_LATENCY = metrics_lib.histogram(
    "hvd_tpu_serve_latency_seconds",
    "end-to-end request latency: arrival -> last generated token "
    "(virtual time in simulation, wall time live)")
_M_DEADLINE_MISSES = metrics_lib.counter(
    "hvd_tpu_serve_deadline_misses_total",
    "requests whose deadline (deadline_s from arrival; 0 = none) was "
    "missed, by where the miss was detected: reason=retire (completed "
    "late) or reason=shed (admission control judged the deadline "
    "infeasible and shed before prefill) — honest under load shedding "
    "(docs/serve.md 'Overload & tenancy')",
    labels=("reason",))
_M_REJECTED = metrics_lib.counter(
    "hvd_tpu_serve_rejected_total",
    "typed request rejections, by reason: queue_full = a bounded "
    "RequestQueue refused a submit (the router tries the next replica "
    "or overflows — never an unrecorded drop), brownout = the ladder's "
    "reject_admission rung refused a non-latency-tier request at "
    "cluster admission (docs/serve.md)",
    labels=("reason",))
for _reason in ("retire", "shed"):
    _M_DEADLINE_MISSES.labels(reason=_reason)
for _reason in ("queue_full", "brownout"):
    _M_REJECTED.labels(reason=_reason)
del _reason


@dataclasses.dataclass
class Request:
    """One inference request. ``arrival_t`` is stamped by the traffic
    source (virtual seconds); ``deadline_s`` is the per-request latency
    budget from arrival (0 = none) the batcher tracks."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_t: float = 0.0
    deadline_s: float = 0.0
    # Sampling lane (docs/serve.md): temperature 0 = greedy argmax
    # (the historical default — byte-identical to pre-sampling
    # engines); > 0 samples from softmax(logits / temperature) under a
    # per-request PRNG lane seeded by (sample_seed, rid, position) —
    # deterministic per request regardless of batching, slot
    # assignment, or mid-sequence migration, so the seeded-repeat
    # event-digest contract keeps holding.
    temperature: float = 0.0
    sample_seed: int = 0
    # Filled at completion.
    tokens: Tuple[int, ...] = ()
    finish_t: Optional[float] = None
    replica: Optional[str] = None
    reroutes: int = 0
    migrations: int = 0
    # Per-phase timeline (virtual seconds). ``admit_t`` is stamped by
    # ``RequestQueue.take`` at every admission (a re-admission after a
    # kill or reroute overwrites it — the phases below describe the
    # attempt that completed); ``first_token_t`` by the prefill that
    # emitted token 0.
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    # Multi-tenancy (docs/serve.md "Overload & tenancy"): the SLO
    # class this request bills to ("latency" / "throughput" / "batch";
    # "" = unclassed legacy traffic, which ranks with the latency
    # tier). ``outcome`` is stamped exactly once by whichever terminal
    # path ends the journey: finished | shed | rejected (the
    # zero-silent-drops accounting contract).
    slo_class: str = ""
    outcome: str = ""

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.arrival_t

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Arrival -> (last) admission onto a replica's decode slots."""
        if self.admit_t is None:
            return None
        return self.admit_t - self.arrival_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: arrival -> prefill emits token 0."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if (self.finish_t is None or self.first_token_t is None
                or len(self.tokens) < 2):
            return None
        return ((self.finish_t - self.first_token_t)
                / (len(self.tokens) - 1))

    @property
    def deadline_missed(self) -> bool:
        return bool(self.deadline_s > 0 and self.latency_s is not None
                    and self.latency_s > self.deadline_s)


class RequestQueue:
    """Bounded FIFO between the router and one replica's batcher.

    ``submit`` enqueues (router side, any thread); ``take(n, now)``
    dequeues up to n for admission (batcher side) and records each
    request's time-in-queue; ``drain()`` empties the queue for
    re-routing — the unstarted half of a graceful drain. Thread-safe;
    iteration order is strict FIFO so a seeded run replays exactly.

    **Class-aware mode** (docs/serve.md "Overload & tenancy"):
    ``set_classes(name -> priority)`` switches ``take`` from FIFO to
    strict priority across SLO classes with earliest-deadline-first
    inside a class. The sort key is ``(priority, arrival_t +
    deadline_s, arrival_t, rid)`` — every component is fixed at
    arrival (the deadline clock never restarts), so a re-admitted
    request (``insert_by_arrival``) competes at exactly the position
    it held before losing its slot: the arrival-position contract is
    preserved by construction. Unclassed requests rank as priority 0
    (with the latency tier); no-deadline requests sort after
    deadlined peers of their class."""

    def __init__(self, maxsize: int = 0):
        self._q: deque = deque()
        self._maxsize = int(maxsize)
        self._lock = threading.Lock()
        self.submitted = 0
        self.rejected = 0
        self._class_order: Optional[Dict[str, int]] = None
        # Stamped by the owning batcher so admission telemetry carries
        # the replica identity (standalone queues default to "mixed").
        self.role = "mixed"
        self.replica = ""

    def set_classes(self,
                    priorities: Optional[Dict[str, int]]) -> None:
        """Enable class-aware ordering (name -> strict priority, lower
        first); ``None`` restores plain FIFO."""
        with self._lock:
            self._class_order = (dict(priorities)
                                 if priorities is not None else None)

    def _class_key(self, req: Request) -> Tuple:
        order = self._class_order or {}
        deadline = (req.arrival_t + req.deadline_s
                    if req.deadline_s > 0 else float("inf"))
        return (order.get(req.slo_class, 0), deadline,
                req.arrival_t, req.rid)

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Enqueue; False when the queue is at maxsize. A refusal is
        TYPED, never silent: the rejected counter, the
        ``hvd_tpu_serve_rejected_total{reason="queue_full"}`` metric,
        and an ``abort`` span (detail ``queue_full``) all record it —
        the router tries the next replica or overflows; a standalone
        caller owns shedding loudly (docs/serve.md)."""
        with self._lock:
            if self._maxsize and len(self._q) >= self._maxsize:
                self.rejected += 1
                full = True
            else:
                self._q.append(req)
                self.submitted += 1
                _M_QUEUE_DEPTH.inc()
                full = False
        if not full:
            return True
        _M_REJECTED.labels(reason="queue_full").inc()
        tr = tracing.tracer()
        if tr.enabled:
            t = now if now is not None else req.arrival_t
            tr.abort(req, self.replica, t, cause="queue_full")
        return False

    def take(self, n: int, now: float = 0.0) -> List[Request]:
        """Dequeue up to ``n`` requests for admission at virtual time
        ``now``: stamps ``admit_t`` on each request and records its
        time-in-queue (the queue-wait histogram + a ``queue`` span).
        Class-aware mode picks the ``n`` best by the class key instead
        of the queue head (stable: FIFO breaks exact-key ties)."""
        out: List[Request] = []
        with self._lock:
            if self._class_order is not None and len(self._q) > 1:
                ranked = sorted(self._q, key=self._class_key)
                out = ranked[:int(n)]
                for req in out:
                    self._q.remove(req)
            else:
                while self._q and len(out) < int(n):
                    out.append(self._q.popleft())
            _M_QUEUE_DEPTH.dec(len(out))
        if out:
            tr = tracing.tracer()
            for req in out:
                req.admit_t = now
                if tr.enabled:
                    tr.queue_admit(req, self.replica, now)
        return out

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put re-routed requests BACK at the head (they already waited
        elsewhere; FIFO fairness follows arrival, not re-route time)."""
        with self._lock:
            for req in reversed(reqs):
                self._q.appendleft(req)
            _M_QUEUE_DEPTH.inc(len(reqs))

    def insert_by_arrival(self, req: Request) -> None:
        """Re-insert a re-routed / fallback-re-prefill request at its
        ARRIVAL position: the deadline clock runs from ``arrival_t``
        and never restarts, so a request that already waited (and then
        lost its slot to a kill, drain, or failed warm handoff) must
        not also wait behind requests that arrived after it. Bypasses
        ``maxsize`` — this is work the cluster already admitted once;
        shedding it here would drop a request, and the drain runbook's
        contract is zero drops (docs/serve.md)."""
        key = (req.arrival_t, req.rid)
        with self._lock:
            idx = len(self._q)
            for i, queued in enumerate(self._q):
                if (queued.arrival_t, queued.rid) > key:
                    idx = i
                    break
            self._q.insert(idx, req)
            _M_QUEUE_DEPTH.inc()

    def drain(self) -> List[Request]:
        """Empty the queue for re-routing (graceful-drain step 1)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            _M_QUEUE_DEPTH.dec(len(out))
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def __len__(self) -> int:
        return self.depth()


def record_completion(req: Request) -> None:
    """Completion telemetry shared by every retire/finish path: latency
    histogram + deadline-miss counter (one definition of 'done')."""
    lat = req.latency_s
    if lat is not None:
        _M_LATENCY.observe(lat)
    if req.deadline_missed:
        _M_DEADLINE_MISSES.labels(reason="retire").inc()


def record_rejection(reason: str) -> None:
    """A typed terminal rejection at cluster admission (e.g. the
    brownout ladder's reject_admission rung) — same counter as the
    queue-full refusals, different reason."""
    _M_REJECTED.labels(reason=reason).inc()


def record_shed_miss() -> None:
    """A deadline miss detected AT ADMISSION (the request was shed as
    infeasible before prefill) — counted under reason="shed" so the
    miss metric stays honest under load shedding (docs/serve.md)."""
    _M_DEADLINE_MISSES.labels(reason="shed").inc()
