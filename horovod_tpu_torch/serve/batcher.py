"""Continuous batching: the per-replica serving loop (docs/serve.md).

The port's copy of ``horovod_tpu/serve/batcher.py``.

Static batching decodes a batch until its LONGEST sequence finishes —
short requests pay the long tail's latency and finished slots burn
compute. Continuous batching retires a sequence the step it finishes
and admits a queued request into the freed slot on the very next step,
which is where serving throughput actually comes from (Orca/vLLM's
core scheduling idea). The loop per decode round:

    admit (queue -> free slots, unless draining)
    decode (one batched step across all slots)
    retire (finished sequences complete + free their slots)

Graceful drain (the controller's shrink path and the replica-kill
runbook): ``start_drain()`` stops admission and empties the queue for
re-routing; in-flight sequences keep decoding locally until
``drained``. Every transition lands in a deterministic event list —
``(step, event, ...)`` integer tuples — the byte-identity surface
seeded runs are compared on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..common import metrics as metrics_lib
from .engine import DecodeEngine
from .queue import Request, RequestQueue

_M_DRAINS = metrics_lib.counter(
    "hvd_tpu_serve_drains_total",
    "replica drains started, by cause (shrink = SLO scale-down, "
    "kill = replica loss)",
    labels=("cause",))
for _c in ("shrink", "kill"):
    _M_DRAINS.labels(cause=_c)
del _c
_M_OCCUPANCY = metrics_lib.gauge(
    "hvd_tpu_serve_batch_occupancy",
    "active decode slots / total slots of the last decode round, "
    "by replica",
    labels=("replica",))
_M_MIGRATIONS = metrics_lib.counter(
    "hvd_tpu_serve_kv_migrations_total",
    "in-flight sequences moved between replicas with their warm KV "
    "cache (int8 wire export/import) instead of a re-prefill — the "
    "default graceful-drain path (docs/serve.md)")


ROLES = ("mixed", "prefill", "decode")


class ContinuousBatcher:
    """One replica's admission + decode + retire loop over a
    :class:`DecodeEngine` and its :class:`RequestQueue`.

    ``role`` splits the loop for prefill/decode disaggregation
    (docs/serve.md): a ``"prefill"`` replica admits + prefills, then
    immediately exports each finished slot (warm-KV wire blob) into
    its ``outbox`` for the cluster to hand to the decode pool — its
    slots free every round, so prefill throughput is slots/round. A
    ``"decode"`` replica never admits from its queue; sequences arrive
    only via ``admit_migrated``. ``"mixed"`` (the default) is the
    classic combined loop."""

    def __init__(self, engine: DecodeEngine,
                 queue: Optional[RequestQueue] = None,
                 role: str = "mixed",
                 class_priorities=None):
        if role not in ROLES:
            raise ValueError(
                f"unknown batcher role {role!r}; known: {ROLES}")
        self.engine = engine
        self.queue = queue if queue is not None else RequestQueue()
        self.name = engine.name
        self.role = role
        # Admission telemetry (queue spans / queue-wait histogram)
        # carries the replica identity via the queue.
        self.queue.role = role
        self.queue.replica = self.name
        if class_priorities is not None:
            # Multi-tenant overload control (docs/serve.md "Overload &
            # tenancy"): admission becomes strict-priority across SLO
            # classes, EDF within one.
            self.queue.set_classes(class_priorities)
        self.draining = False
        # Goodput attribution for the last run_step round: "prefill" /
        # "decode" when the round did useful work, "idle" when slots
        # sat empty, "drain" while draining (tracing.GOODPUT_STATES).
        self.last_round_state = "idle"
        self.completed: List[Request] = []
        self.events: List[Tuple] = []
        self.outbox: List[Tuple] = []
        self.steps = 0
        self._occ_sum = 0.0
        self._occ_n = 0

    # -- drain lifecycle -----------------------------------------------------

    def start_drain(self, cause: str = "shrink") -> List[Request]:
        """Stop admitting; hand back the queued (unstarted) requests
        for re-routing. In-flight sequences keep decoding here until
        :attr:`drained`."""
        if not self.draining:
            self.draining = True
            _M_DRAINS.labels(cause=cause).inc()
            self.events.append((self.steps, "drain_start", cause))
        rerouted = self.queue.drain()
        for req in rerouted:
            req.reroutes += 1
            self.events.append((self.steps, "reroute", req.rid))
        return rerouted

    @property
    def drained(self) -> bool:
        return (self.draining and self.engine.active_count() == 0
                and len(self.queue) == 0)

    def migrate_requests(self, now: Optional[float] = None) -> List[Tuple]:
        """Graceful-drain step 2, warm-handoff form (the DEFAULT —
        docs/serve.md): every in-flight sequence leaves WITH its int8
        block-scaled cache blob and generated-so-far tokens, so a peer
        continues mid-sequence instead of re-prefilling (or instead of
        this replica lingering until its longest sequence finishes).
        Returns ``[(request, wire_blob, generated), ...]``; the cluster
        places them on peers with free slots."""
        out = []
        for slot, req in enumerate(self.engine.requests):
            if req is None:
                continue
            req, blob, generated = self.engine.migrate_out(
                slot, now, kind="migrate")
            self.events.append((self.steps, "migrate_out", req.rid,
                                len(generated)))
            out.append((req, blob, generated))
        return out

    def admit_migrated(self, req, blob, generated,
                       now: float = 0.0) -> int:
        """Land a migrated sequence (warm cache + decode state) in one
        of this replica's free slots."""
        slot = self.engine.admit_migrated(req, blob, generated, now)
        _M_MIGRATIONS.inc()
        self.events.append((self.steps, "migrate_in", req.rid, slot))
        return slot

    def migratable_slots(self) -> int:
        """Free slots available to receive migrated sequences (serving
        replicas only — a draining replica never admits)."""
        return 0 if self.draining else len(self.engine.free_slots())

    def abort(self, now: Optional[float] = None) -> List[Request]:
        """Replica kill: queued AND in-flight requests come back for
        re-routing (in-flight restart from their prompts on a peer —
        zero dropped requests)."""
        out = self.start_drain(cause="kill")
        aborted = self.engine.abort_all(now)
        for req in aborted:
            self.events.append((self.steps, "abort", req.rid))
        return out + aborted

    # -- the serving loop ----------------------------------------------------

    def run_step(self, now: float = 0.0) -> List[Request]:
        """One admit/decode/retire round; returns the requests that
        completed this round."""
        finished: List[Request] = []
        admitted = 0
        if not self.draining and self.role != "decode":
            for req in self.queue.take(len(self.engine.free_slots()),
                                       now):
                slot = self.engine.admit(req, now)
                admitted += 1
                self.events.append((self.steps, "admit", req.rid, slot))
                if self.engine.request_done(slot):
                    # 1-token/instant-EOS request: complete at prefill.
                    finished.append(self.engine.retire(slot, now))
                elif self.role == "prefill":
                    # Disaggregation: the freshly prefilled slot leaves
                    # NOW as a warm-KV wire blob; the cluster hands it
                    # to the decode pool this same round.
                    handoff = self.engine.migrate_out(slot, now,
                                                      kind="handoff")
                    self.outbox.append(handoff)
                    self.events.append((self.steps, "handoff_out",
                                        handoff[0].rid))
        occ = self.engine.active_count() / max(1, self.engine.slots)
        self._occ_sum += occ
        self._occ_n += 1
        _M_OCCUPANCY.labels(replica=self.name).set(occ)
        if self.role != "prefill":
            finished.extend(self.engine.step(now))
        if self.draining:
            self.last_round_state = "drain"
        elif self.role == "prefill":
            self.last_round_state = "prefill" if admitted else "idle"
        elif occ > 0.0 or finished:
            # A round that prefilled into a mixed replica still decodes
            # the same step, so "decode" wins the attribution.
            self.last_round_state = "decode"
        else:
            self.last_round_state = "idle"
        for req in finished:
            self.events.append((self.steps, "finish", req.rid,
                                len(req.tokens)))
        self.completed.extend(finished)
        self.steps += 1
        return finished

    def mean_occupancy(self) -> float:
        return self._occ_sum / self._occ_n if self._occ_n else 0.0

    def close(self) -> None:
        """Zero this replica's labeled gauges on departure (kill or
        finished drain) — replica names are monotonic, so stale series
        would otherwise accumulate one dead gauge per departed replica
        for the life of the process."""
        _M_OCCUPANCY.labels(replica=self.name).set(0)
        self.engine.close()
