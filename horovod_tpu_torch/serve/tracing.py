"""Request-scoped tracing + goodput attribution for the serve plane.

The port's copy of ``horovod_tpu/serve/tracing.py``: the same span
schema, knobs and metric names.

Every request that enters a :class:`~.controller.ServeCluster` leaves a
*span ledger* here: enqueue -> queue wait -> prefill (first token) ->
prefix fork -> handoff export / wire / import -> decode -> speculative
rounds -> migration -> retire.  A journey that crosses the prefill and
decode pools reassembles into ONE trace because the trace stamp rides
the warm-KV blob through ``migrate_out`` / ``admit_migrated`` (the same
transport ``export_slot`` / ``import_slot`` already use), keyed by the
request id.

Design rules (the flightrec / metrics philosophy):

* **NOOP singleton** — with ``HVD_TPU_SERVE_TRACE=0`` every call site
  shares one disabled tracer and hot paths pay a single bool check.
  Nothing is recorded, no metric is observed, and the seeded event
  digests are bit-identical to a tree without this module.
* **Clock injection** — the tracer never reads a wall clock on a span
  path.  Callers pass the serve plane's virtual ``now`` explicitly; the
  injected ``clock`` exists only as a fallback for interactive use.
  Seeded repeat runs therefore produce
  byte-identical :meth:`ServeTracer.summary` ledgers.
* **Metrics derive from spans** — the TTFT / TPOT / queue-wait /
  handoff histograms and the per-replica goodput ledger below are
  observed at span-record time, never from a second code path.

The span schema is the JAX package's, so ``tools/analyze_serve.py``
reads a dump from either package.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..common import metrics as metrics_lib
from ..common.config import runtime_env

# The JAX package's schema (tools/analyze_serve.py reads both).
TRACE_SCHEMA_VERSION = 1
TRACE_SPAN_KEYS = ("rid", "phase", "replica", "role", "t0", "t1", "detail")

#: Every phase a span may carry, in journey order.  ``enqueue``/``retire``
#: and the ``*_export``/``*_import`` landings are point spans (t0 == t1);
#: the rest are intervals measured in the cluster's virtual seconds.
TRACE_PHASES = (
    "enqueue",        # request routed to a replica queue (t = arrival)
    "queue",          # enqueue/abort -> admission on a replica
    "prefill",        # prompt prefill; emits the first token
    "prefix_fork",    # prefix-cache hit forked warm KV (detail = base len)
    "handoff_export", # warm-KV blob packed for a pool handoff / migration
    "handoff_wire",   # export -> import wait across the handoff transport
    "handoff_import", # blob landed on the destination replica
    "decode",         # first token / import -> last token
    "spec",           # one speculative round (detail = accepted/proposed)
    "migrate",        # drain-driven migration wire wait (export -> import)
    "abort",          # replica loss dropped in-flight state (salvage start)
    "retire",         # completion (detail = generated token count)
    "shed",           # overload control shed the request (detail = reason)
    "reject",         # admission refused the request (detail = reason)
    "brownout",       # ladder transition, rid -1 (detail = dir:rung:level)
)

#: Phases that CLOSE a journey: a rid with any of these (and no
#: pending warm-KV export) is not an orphan. ``brownout`` spans are
#: cluster-scoped (rid -1), never a request journey.
TRACE_TERMINAL_PHASES = ("retire", "shed", "reject", "brownout")

GOODPUT_STATES = ("decode", "prefill", "idle", "drain")
_ROLES = ("mixed", "prefill", "decode")

_M_TTFT = metrics_lib.histogram(
    "hvd_tpu_serve_ttft_seconds",
    "time to first token (arrival -> prefill emits token 0), by the "
    "role of the replica that prefilled (docs/serve.md)",
    labels=("role",))
_M_TPOT = metrics_lib.histogram(
    "hvd_tpu_serve_tpot_seconds",
    "time per output token after the first (decode cadence), by the "
    "role of the replica that retired the request",
    labels=("role",))
_M_QUEUE_WAIT = metrics_lib.histogram(
    "hvd_tpu_serve_queue_wait_seconds",
    "time spent queued before admission (re-admissions after a kill "
    "or reroute observe the wait since the abort), by admitting role",
    labels=("role",))
_M_HANDOFF = metrics_lib.histogram(
    "hvd_tpu_serve_handoff_seconds",
    "warm-KV export -> import wire wait across pools, by the role of "
    "the importing replica",
    labels=("role",))
for _r in _ROLES:
    _M_TTFT.labels(role=_r)
    _M_TPOT.labels(role=_r)
    _M_QUEUE_WAIT.labels(role=_r)
    _M_HANDOFF.labels(role=_r)
del _r
_M_GOODPUT = metrics_lib.counter(
    "hvd_tpu_serve_goodput_seconds_total",
    "virtual seconds each replica spent per state (decode / prefill "
    "= goodput, idle / drain = overhead); the pod goodput fraction on "
    "/pod/serve is (decode+prefill) / total",
    labels=("replica", "state"))

_TRACE_DUMP_NAME = "serve_trace.jsonl"


def _round6(v: float) -> float:
    return round(float(v), 6)


class ServeTracer:
    """Per-request span ledger + per-replica goodput accounting.

    All record methods take the caller's virtual ``now``; the injected
    ``clock`` is only a fallback when no time is supplied.  Methods
    no-op when ``enabled`` is False — call sites may also pre-check the
    bool to skip argument construction on hot paths.
    """

    def __init__(self, enabled: bool = True, size: Optional[int] = None,
                 clock=None):
        self.enabled = bool(enabled)
        if size is None:
            size = int(runtime_env("SERVE_TRACE_SIZE", "4096"))
        self.size = max(1, int(size))
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._spans: Dict[int, List[Dict[str, Any]]] = {}
        self._order: List[int] = []          # rid insertion order
        self._done: deque = deque()          # retired rids, oldest first
        self._roles: Dict[str, str] = {}     # replica name -> role
        self._pending_export: Dict[int, Tuple[float, str]] = {}
        self._decode_start: Dict[int, float] = {}
        self._goodput: Dict[str, Dict[str, float]] = {}
        self.dropped_traces = 0
        # Last ladder level seen (overload control; 0 = no brownout) —
        # tracked even when disabled so /pod/serve stays honest.
        self.brownout_level = 0

    # -- plumbing ------------------------------------------------------------

    def begin_session(self) -> None:
        """Reset ledgers for a fresh cluster run (keeps the enabled bit)."""
        with self._lock:
            self._spans.clear()
            self._order.clear()
            self._done.clear()
            self._roles.clear()
            self._pending_export.clear()
            self._decode_start.clear()
            self._goodput.clear()
            self.dropped_traces = 0
            self.brownout_level = 0

    def set_role(self, replica: str, role: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._roles[replica] = role

    def role_of(self, replica: str) -> str:
        return self._roles.get(replica, "mixed")

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else now

    def span(self, rid: int, phase: str, replica: str, t0: float,
             t1: float, detail: str = "") -> None:
        """Append one span to ``rid``'s ledger (the only write path)."""
        if not self.enabled:
            return
        role = self.role_of(replica)
        rec = {"rid": int(rid), "phase": phase, "replica": replica,
               "role": role, "t0": _round6(t0), "t1": _round6(t1),
               "detail": str(detail)}
        with self._lock:
            if rid not in self._spans:
                self._spans[rid] = []
                self._order.append(rid)
            self._spans[rid].append(rec)

    def _last_t(self, rid: int, default: float) -> float:
        spans = self._spans.get(rid)
        if not spans:
            return default
        return spans[-1]["t1"]

    # -- journey record points (callers pass virtual time) -------------------

    def enqueue(self, req, now: Optional[float] = None) -> None:
        if not self.enabled:
            return
        t = req.arrival_t if req.arrival_t is not None else self._now(now)
        # Router-side: no replica is assigned yet (and a re-run over the
        # same trace objects must not see run-1's placement).
        self.span(req.rid, "enqueue", "", t, t)

    def queue_admit(self, req, replica: str, now: Optional[float]) -> None:
        """Admission off a replica queue; observes the queue-wait hist."""
        if not self.enabled:
            return
        t1 = self._now(now)
        t0 = self._last_t(req.rid, req.arrival_t)
        self.span(req.rid, "queue", replica, t0, t1,
                  detail=str(req.reroutes))
        _M_QUEUE_WAIT.labels(role=self.role_of(replica)).observe(
            max(0.0, t1 - t0))

    def prefill(self, req, replica: str, now: Optional[float],
                ntokens: int) -> None:
        """Prompt prefill emitted the first token; observes TTFT."""
        if not self.enabled:
            return
        t = self._now(now)
        self.span(req.rid, "prefill", replica, t, t, detail=str(ntokens))
        with self._lock:
            self._decode_start[req.rid] = t
        _M_TTFT.labels(role=self.role_of(replica)).observe(
            max(0.0, t - req.arrival_t))

    def prefix_fork(self, rid: int, replica: str, now: Optional[float],
                    base_len: int) -> None:
        if not self.enabled:
            return
        t = self._now(now)
        self.span(rid, "prefix_fork", replica, t, t, detail=str(base_len))

    def spec_round(self, rid: int, replica: str, now: Optional[float],
                   accepted: int, proposed: int) -> None:
        if not self.enabled:
            return
        t = self._now(now)
        self.span(rid, "spec", replica, t, t,
                  detail=f"{accepted}/{proposed}")

    def export(self, req, replica: str, now: Optional[float],
               kind: str) -> Optional[Dict[str, Any]]:
        """Warm-KV blob leaves ``replica``.  Returns the stamp that rides
        the blob through the handoff transport (None when disabled)."""
        if not self.enabled:
            return None
        t = self._now(now)
        self.span(req.rid, "handoff_export", replica, t, t, detail=kind)
        with self._lock:
            self._pending_export[req.rid] = (t, kind)
        return {"rid": int(req.rid), "t": _round6(t), "kind": kind}

    def import_blob(self, req, replica: str, now: Optional[float],
                    stamp: Optional[Dict[str, Any]]) -> None:
        """Warm-KV blob landed on ``replica``; closes the wire span."""
        if not self.enabled:
            return
        t = self._now(now)
        if stamp is None:
            with self._lock:
                pend = self._pending_export.pop(req.rid, None)
        else:
            pend = (float(stamp.get("t", t)), str(stamp.get("kind",
                                                            "handoff")))
            with self._lock:
                self._pending_export.pop(req.rid, None)
        if pend is not None:
            t0, kind = pend
            phase = "migrate" if kind == "migrate" else "handoff_wire"
            self.span(req.rid, phase, replica, t0, t)
            if kind != "migrate":
                _M_HANDOFF.labels(role=self.role_of(replica)).observe(
                    max(0.0, t - t0))
        self.span(req.rid, "handoff_import", replica, t, t)
        with self._lock:
            self._decode_start[req.rid] = t

    def abort(self, req, replica: str, now: Optional[float],
              cause: str = "replica_lost") -> None:
        """In-flight state dropped (replica kill); the salvage journey
        (re-prefill or re-import) continues under the same rid."""
        if not self.enabled:
            return
        t = self._now(now)
        self.span(req.rid, "abort", replica, t, t, detail=cause)
        with self._lock:
            self._decode_start.pop(req.rid, None)

    def retire(self, req, replica: str, now: Optional[float]) -> None:
        """Request completed; closes the decode span, observes TPOT."""
        if not self.enabled:
            return
        t = self._now(now)
        with self._lock:
            d0 = self._decode_start.pop(req.rid, None)
        if d0 is None:
            d0 = req.admit_t if req.admit_t is not None else t
        ntok = len(req.tokens)
        self.span(req.rid, "decode", replica, d0, t, detail=str(ntok))
        self.span(req.rid, "retire", replica, t, t, detail=str(ntok))
        tpot = req.tpot_s
        if tpot is not None:
            _M_TPOT.labels(role=self.role_of(replica)).observe(tpot)
        self._close(req.rid)

    def _close(self, rid: int) -> None:
        """Shared terminal bookkeeping: drop in-flight state and evict
        the oldest closed journeys past the retention cap."""
        with self._lock:
            self._pending_export.pop(rid, None)
            self._decode_start.pop(rid, None)
            self._done.append(rid)
            while len(self._done) > self.size:
                old = self._done.popleft()
                if self._spans.pop(old, None) is not None:
                    self._order.remove(old)
                    self.dropped_traces += 1

    def shed(self, req, now: Optional[float],
             reason: str = "deadline") -> None:
        """Overload control shed the request before prefill — a
        TERMINAL span (the journey is closed, not orphaned)."""
        if not self.enabled:
            return
        t = self._now(now)
        self.span(req.rid, "shed", "", t, t, detail=reason)
        self._close(req.rid)

    def reject(self, req, now: Optional[float],
               reason: str = "brownout") -> None:
        """Admission refused the request — a TERMINAL span."""
        if not self.enabled:
            return
        t = self._now(now)
        self.span(req.rid, "reject", "", t, t, detail=reason)
        self._close(req.rid)

    def brownout(self, level: int, rung: str, direction: str,
                 now: Optional[float]) -> None:
        """Ladder transition, recorded cluster-scoped under rid -1 so
        /pod/serve and the trace ledger show when each rung engaged
        (docs/serve.md 'Overload & tenancy')."""
        self.brownout_level = int(level)
        if not self.enabled:
            return
        t = self._now(now)
        self.span(-1, "brownout", "", t, t,
                  detail=f"{direction}:{rung}:level={level}")

    # -- goodput -------------------------------------------------------------

    def account(self, replica: str, state: str, dt: float) -> None:
        """Attribute ``dt`` virtual seconds of ``replica`` to ``state``."""
        if not self.enabled:
            return
        with self._lock:
            per = self._goodput.setdefault(replica, {})
            per[state] = per.get(state, 0.0) + dt
        _M_GOODPUT.labels(replica=replica, state=state).inc(dt)

    def goodput_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {rep: {st: _round6(v) for st, v in sorted(per.items())}
                    for rep, per in sorted(self._goodput.items())}

    def goodput_fraction(self) -> Optional[float]:
        """(decode + prefill) / total over every replica; None if empty."""
        total = useful = 0.0
        for per in self.goodput_snapshot().values():
            for st, v in per.items():
                total += v
                if st in ("decode", "prefill"):
                    useful += v
        if total <= 0.0:
            return None
        return _round6(useful / total)

    # -- read side -----------------------------------------------------------

    def trace(self, rid: int) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans.get(rid, ()))

    def rids(self) -> List[int]:
        with self._lock:
            return list(self._order)

    def orphans(self) -> List[int]:
        """Rids whose journey never closed: no terminal span (retire /
        shed / reject), or a warm-KV export that was never imported.
        Empty after a clean run — also under overload, where shed and
        rejected requests close their journeys explicitly."""
        out = []
        with self._lock:
            for rid in self._order:
                phases = {s["phase"] for s in self._spans[rid]}
                if phases.isdisjoint(TRACE_TERMINAL_PHASES) \
                        or rid in self._pending_export:
                    out.append(rid)
        return out

    def span_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._spans.values())

    def summary(self) -> Dict[str, Any]:
        """Deterministic ledger snapshot (the byte-identity surface)."""
        with self._lock:
            spans = [[s[k] for k in TRACE_SPAN_KEYS]
                     for rid in sorted(self._spans)
                     for s in self._spans[rid]]
        return {"schema": TRACE_SCHEMA_VERSION,
                "spans": spans,
                "goodput": self.goodput_snapshot(),
                "dropped_traces": self.dropped_traces}

    def digest(self) -> str:
        blob = json.dumps(self.summary(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def pod_view(self, exemplars: int = 3) -> Dict[str, Any]:
        """The /pod/serve aggregation: per-role percentiles over span
        durations, goodput fraction, and slowest-request exemplars."""
        per_role: Dict[str, Dict[str, List[float]]] = {}
        journeys: List[Tuple[float, int]] = []
        with self._lock:
            items = [(rid, list(self._spans[rid]))
                     for rid in self._order if rid >= 0]
        shed = rejected = 0
        for rid, spans in items:
            for s in spans:
                if s["phase"] == "shed":
                    shed += 1
                elif s["phase"] == "reject":
                    rejected += 1
            t_first = min(s["t0"] for s in spans)
            t_last = max(s["t1"] for s in spans)
            journeys.append((_round6(t_last - t_first), rid))
            for s in spans:
                metric = {"queue": "queue_wait", "handoff_wire": "handoff",
                          "decode": "decode"}.get(s["phase"])
                if metric is None:
                    continue
                bucket = per_role.setdefault(s["role"], {})
                bucket.setdefault(metric, []).append(s["t1"] - s["t0"])
        roles_out: Dict[str, Dict[str, float]] = {}
        for role, buckets in sorted(per_role.items()):
            row: Dict[str, float] = {}
            for metric, vals in sorted(buckets.items()):
                vals.sort()
                row[f"{metric}_p50_s"] = _round6(_pct(vals, 0.50))
                row[f"{metric}_p99_s"] = _round6(_pct(vals, 0.99))
            roles_out[role] = row
        journeys.sort(reverse=True)
        slowest = []
        for total, rid in journeys[:max(0, int(exemplars))]:
            spans = self.trace(rid)
            slowest.append({
                "rid": rid, "total_s": total,
                "spans": [{k: s[k] for k in TRACE_SPAN_KEYS}
                          for s in spans]})
        return {"enabled": self.enabled,
                "requests": len(items),
                "spans": self.span_count(),
                "orphans": len(self.orphans()),
                "shed": shed,
                "rejected": rejected,
                "brownout_level": self.brownout_level,
                "roles": roles_out,
                "goodput": self.goodput_snapshot(),
                "goodput_fraction": self.goodput_fraction(),
                "slowest": slowest}

    # -- persistence ---------------------------------------------------------

    def dump(self, path: str) -> str:
        """Write one JSONL line per request trace plus a head meta line."""
        tmp = path + ".tmp"
        with self._lock:
            items = [(rid, list(self._spans[rid])) for rid in self._order]
        with open(tmp, "w") as f:
            f.write(json.dumps({"schema": TRACE_SCHEMA_VERSION,
                                "goodput": self.goodput_snapshot(),
                                "roles": dict(sorted(self._roles.items()))},
                               sort_keys=True) + "\n")
            for rid, spans in items:
                f.write(json.dumps({"rid": rid, "spans": spans},
                                   sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    def maybe_dump(self) -> Optional[str]:
        """Dump to ``$HVD_TPU_SERVE_TRACE_DIR/serve_trace.jsonl`` if the
        knob is set (called by the cluster at end of run)."""
        if not self.enabled:
            return None
        directory = runtime_env("SERVE_TRACE_DIR", "")
        if not directory:
            return None
        os.makedirs(directory, exist_ok=True)
        return self.dump(os.path.join(directory, _TRACE_DUMP_NAME))


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


# -- module singleton (the flightrec `recorder()` pattern) -------------------

_TRACER: Optional[ServeTracer] = None
_NOOP: Optional[ServeTracer] = None
_SINGLETON_LOCK = threading.Lock()


def _truthy(raw: Optional[str], default: bool) -> bool:
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


def tracer() -> ServeTracer:
    """The process-wide tracer.  With ``HVD_TPU_SERVE_TRACE=0`` this is
    one shared no-op instance: every record method returns after a
    single bool check and nothing is ever allocated."""
    global _TRACER, _NOOP
    with _SINGLETON_LOCK:
        if not _truthy(runtime_env("SERVE_TRACE"), True):
            if _NOOP is None:
                _NOOP = ServeTracer(enabled=False, size=1)
            return _NOOP
        if _TRACER is None:
            _TRACER = ServeTracer(enabled=True)
        return _TRACER


def reset() -> None:
    """Drop both singletons (tests flip the knob between runs)."""
    global _TRACER, _NOOP
    with _SINGLETON_LOCK:
        _TRACER = None
        _NOOP = None
