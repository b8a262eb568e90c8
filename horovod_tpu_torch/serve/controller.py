"""SLO-driven replica control: the autoscale decision machinery
repurposed for serving (docs/serve.md).

The port's copy of ``horovod_tpu/serve/controller.py``; the
decision log and the event list are byte-identical to the JAX
package's for the same trace.

Training autoscaling (common/autoscale.py) turns per-rank step-time
telemetry into ``keep | grow | shrink | evict`` through policies-as-
data and a deterministic decision log. Serving needs the same control
plane with different signals — request-latency SLOs (p99 over a
completion window) and queue depth instead of step-time skew — and one
different mechanism: replicas leave by GRACEFUL DRAIN (stop admitting,
finish in-flight, re-route the queue) rather than eviction, because a
replica holds irreplaceable in-flight state the way a training rank
does not.

Same contracts as the training plane, deliberately:

* :class:`SLOPolicy` — every threshold is data
  (``HVD_TPU_SERVE_POLICY`` file/inline JSON +
  ``HVD_TPU_SERVE_<FIELD>`` env overrides), validation names the bad
  field.
* Decisions reuse ``common/autoscale.Decision`` — the same
  ``{"seq", "action", "target", "reason"}`` JSON-lines log
  (``HVD_TPU_SERVE_LOG``), deterministic fields only, so a seeded
  run replays byte-identically.
* An elastic host manager plugs in (duck-typed: ``current_hosts``,
  ``blacklist``, ``update_available_hosts``): a killed replica's
  host is blacklisted with the same TTL/strike machinery, and grow
  consults the usable-host set before starting a replica.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..common.autoscale import Decision
from ..common import metrics as metrics_lib
from . import overload as overload_lib
from . import tracing
from .batcher import ContinuousBatcher
from .engine import DecodeEngine
from . import queue as queue_lib
from .queue import Request
from .traffic import TrafficTrace
from ..common.config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")

_M_HANDOFFS = metrics_lib.counter(
    "hvd_tpu_serve_handoffs_total",
    "prefilled sequences handed from the prefill pool to the decode "
    "pool over the warm-KV int8 wire (disaggregated serving, "
    "docs/serve.md)")

ENV_POLICY = "HVD_TPU_SERVE_POLICY"   # policy file path or inline JSON
ENV_LOG = "HVD_TPU_SERVE_LOG"         # decision log (JSONL)


def _truthy(raw: Optional[str]) -> bool:
    return (raw or "").strip().lower() in ("1", "true", "yes", "on")


def _count_by(items) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for it in items:
        out[str(it)] = out.get(str(it), 0) + 1
    return out


@dataclasses.dataclass
class SLOPolicy:
    """Every serving-SLO threshold — data, not code (docs/serve.md has
    the schema table and recipes)."""

    enabled: bool = True
    # Controller cadence (virtual seconds in simulation).
    tick_interval_s: float = 0.25
    # Completion window the latency percentiles cover.
    window: int = 16
    # Grow when the windowed p99 exceeds this (0 = off).
    target_p99_s: float = 0.0
    # Per-phase SLOs over the same completion window (0 = off), fed by
    # the request timeline the tracer stamps (docs/serve.md "Tracing &
    # goodput"). TTFT pressure is admission/prefill pressure — grow the
    # PREFILL pool; TPOT pressure is decode cadence pressure — grow the
    # DECODE pool. Classic (non-disagg) clusters grow an undifferentiated
    # replica either way.
    ttft_target_s: float = 0.0
    tpot_target_s: float = 0.0
    # Grow when total queued requests exceed this (0 = off).
    max_queue_depth: int = 0
    # Drain one replica when instantaneous slot occupancy falls below
    # this AND every queue is empty (0 = never shrink on load).
    low_occupancy: float = 0.0
    # Replica-count floor/ceiling. A kill that drops the cluster below
    # min_replicas restores capacity immediately (no cooldown).
    min_replicas: int = 1
    max_replicas: int = 4
    grow_cooldown_s: float = 1.0
    shrink_cooldown_s: float = 2.0
    # How a graceful drain relocates IN-FLIGHT sequences
    # (docs/serve.md): "migrate" (the DEFAULT) hands each one to a peer
    # WITH its warm KV cache over the int8 wire
    # (kvcache.export_slot/import_slot) — decode continues
    # mid-sequence, no re-prefill, and the drained replica leaves on
    # the next tick instead of lingering until its longest sequence
    # finishes; "local" keeps the historical behavior (in-flight
    # sequences finish on the draining replica). Sequences that find
    # no free peer slot fall back to a re-prefill re-route — never
    # dropped.
    drain_mode: str = "migrate"
    # Disaggregated pools only (docs/serve.md): grow the DECODE pool
    # when prefilled sequences waiting for a decode slot exceed this
    # (0 = off). Queue-depth pressure grows the PREFILL pool; this is
    # the matching back-pressure signal for the other pool.
    max_handoff_depth: int = 0
    # --- Overload control & multi-tenancy (docs/serve.md "Overload &
    # tenancy"; horovod_tpu/serve/overload.py). ``overload`` is the
    # master switch: off (the default) keeps every pre-existing
    # cluster byte-identical. Each SLO class is three scalars —
    # deadline default (0 = none), strict cross-class priority (lower
    # = served first), and retry budget (re-route attempts allowed
    # before the request is shed; self-limiting retries).
    overload: bool = False
    latency_deadline_s: float = 0.0
    latency_priority: int = 0
    latency_retry_budget: int = 4
    throughput_deadline_s: float = 0.0
    throughput_priority: int = 1
    throughput_retry_budget: int = 2
    batch_deadline_s: float = 0.0
    batch_priority: int = 2
    batch_retry_budget: int = 1
    # Deadline-aware admission: shed when safety x estimated latency
    # (queue-wait + TTFT residual + max_new_tokens x TPOT, windowed
    # p99s) exceeds the request's remaining deadline budget.
    admission_safety: float = 1.0
    # Brownout ladder (overload.BROWNOUT_RUNGS): queue depth >=
    # enter_depth for enter_ticks consecutive ticks climbs one rung;
    # depth <= exit_depth for exit_ticks descends one. enter_depth 0
    # disables the ladder; the band between the thresholds is the
    # hysteresis dead zone.
    brownout_enter_depth: int = 0
    brownout_exit_depth: int = 0
    brownout_enter_ticks: int = 2
    brownout_exit_ticks: int = 2
    # The clamp_tokens rung caps throughput-tier max_new_tokens at
    # this while active (brownout partial answers over timeouts).
    brownout_clamp_tokens: int = 4

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_dict(cls, data: Dict) -> "SLOPolicy":
        if not isinstance(data, dict):
            raise ValueError(
                f"serve policy must be a JSON object, got "
                f"{type(data).__name__}")
        known = cls.field_names()
        unknown = sorted(set(data) - set(known))
        if unknown:
            raise ValueError(
                f"serve policy: unknown field(s) {unknown}; known "
                f"fields: {sorted(known)}")
        policy = cls()
        for name, value in data.items():
            default = getattr(policy, name)
            try:
                if isinstance(default, bool):
                    if isinstance(value, str):
                        value = _truthy(value)
                    value = bool(value)
                elif isinstance(default, int):
                    value = int(value)
                elif isinstance(default, float):
                    value = float(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"serve policy: field {name!r} must be a "
                    f"{type(default).__name__}, got {value!r}")
            setattr(policy, name, value)
        policy.validate()
        return policy

    def validate(self) -> "SLOPolicy":
        for name in ("tick_interval_s", "target_p99_s", "ttft_target_s",
                     "tpot_target_s", "low_occupancy",
                     "grow_cooldown_s", "shrink_cooldown_s",
                     "latency_deadline_s", "throughput_deadline_s",
                     "batch_deadline_s", "latency_retry_budget",
                     "throughput_retry_budget", "batch_retry_budget",
                     "brownout_enter_depth", "brownout_exit_depth",
                     "brownout_clamp_tokens"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"serve policy: field {name!r} must be >= 0, got "
                    f"{getattr(self, name)}")
        for name in ("window", "min_replicas", "max_replicas"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"serve policy: field {name!r} must be >= 1, got "
                    f"{getattr(self, name)}")
        if self.max_queue_depth < 0:
            raise ValueError(
                "serve policy: field 'max_queue_depth' must be >= 0 "
                f"(0 disables), got {self.max_queue_depth}")
        if self.max_handoff_depth < 0:
            raise ValueError(
                "serve policy: field 'max_handoff_depth' must be >= 0 "
                f"(0 disables), got {self.max_handoff_depth}")
        for name in ("brownout_enter_ticks", "brownout_exit_ticks"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"serve policy: field {name!r} must be >= 1 "
                    f"(hysteresis streak length), got "
                    f"{getattr(self, name)}")
        if self.admission_safety <= 0:
            raise ValueError(
                "serve policy: field 'admission_safety' must be > 0 "
                f"(a latency-estimate multiplier), got "
                f"{self.admission_safety}")
        if 0 < self.brownout_enter_depth <= self.brownout_exit_depth:
            raise ValueError(
                "serve policy: brownout_exit_depth "
                f"{self.brownout_exit_depth} must be < "
                f"brownout_enter_depth {self.brownout_enter_depth} "
                "(the gap is the hysteresis band)")
        if self.low_occupancy > 1.0:
            raise ValueError(
                "serve policy: field 'low_occupancy' is a fraction in "
                f"[0, 1], got {self.low_occupancy}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"serve policy: max_replicas {self.max_replicas} < "
                f"min_replicas {self.min_replicas}")
        if self.drain_mode not in ("migrate", "local"):
            raise ValueError(
                "serve policy: field 'drain_mode' must be 'migrate' "
                f"(warm-KV handoff, the default) or 'local', got "
                f"{self.drain_mode!r}")
        return self

    @classmethod
    def from_json(cls, text: str) -> "SLOPolicy":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"serve policy: invalid JSON ({e})")
        return cls.from_dict(data)

    @classmethod
    def load(cls, source: str) -> "SLOPolicy":
        source = source.strip()
        if source.startswith("@"):
            with open(source[1:]) as f:
                return cls.from_json(f.read())
        if source.startswith("{"):
            return cls.from_json(source)
        with open(source) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_env(cls, env=None) -> "SLOPolicy":
        """``HVD_TPU_SERVE_POLICY`` (file or inline JSON) as the base,
        then any ``HVD_TPU_SERVE_<FIELD>`` env knob overrides its
        field — the JAX package's layering and knob names."""
        env = os.environ if env is None else env
        raw = env.get(ENV_POLICY)
        policy = cls.load(raw) if raw else cls()
        overrides: Dict = {}
        for name in cls.field_names():
            val = env.get("HVD_TPU_SERVE_" + name.upper())
            if val is not None:
                overrides[name] = val
        if overrides:
            merged = dataclasses.asdict(policy)
            merged.update(overrides)
            policy = cls.from_dict(merged)
        return policy

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


class ServeController:
    """Turns cluster telemetry (windowed latency percentiles, queue
    depths, occupancy, replica loss) into deterministic
    ``keep | grow | drain`` decisions, logged exactly like the training
    autoscaler's."""

    def __init__(self, policy: SLOPolicy,
                 log_path: Optional[str] = None):
        self.policy = policy
        self._log_path = (log_path if log_path is not None
                          else runtime_env("SERVE_LOG") or None)
        self.decisions: List[Decision] = []
        self._seq = 0
        self._latencies: deque = deque(maxlen=max(1, policy.window))
        self._ttfts: deque = deque(maxlen=max(1, policy.window))
        self._tpots: deque = deque(maxlen=max(1, policy.window))
        self._queue_waits: deque = deque(maxlen=max(1, policy.window))
        # Overload control (docs/serve.md "Overload & tenancy"): the
        # brownout ladder lives with the controller so its transitions
        # share the decision log's seq space with grow/drain.
        self.brownout = overload_lib.BrownoutLadder(policy)
        self._last_grow_t = -float("inf")
        self._last_shrink_t = -float("inf")
        self._last_tick_t = -float("inf")

    # -- evidence feeds ------------------------------------------------------

    def observe_completion(self, req: Request) -> None:
        if req.latency_s is not None:
            self._latencies.append(req.latency_s)
        if req.ttft_s is not None:
            self._ttfts.append(req.ttft_s)
        if req.tpot_s is not None:
            self._tpots.append(req.tpot_s)
        if req.queue_wait_s is not None:
            self._queue_waits.append(req.queue_wait_s)

    @staticmethod
    def _windowed(window: deque) -> Optional[float]:
        if not window:
            return None
        return float(np.percentile(np.asarray(window), 99))

    def windowed_p99(self) -> Optional[float]:
        return self._windowed(self._latencies)

    def windowed_ttft_p99(self) -> Optional[float]:
        return self._windowed(self._ttfts)

    def windowed_tpot_p99(self) -> Optional[float]:
        return self._windowed(self._tpots)

    def windowed_queue_wait_p99(self) -> Optional[float]:
        return self._windowed(self._queue_waits)

    # -- decision plumbing (the autoscale contract) --------------------------

    def _record(self, decision: Decision) -> Decision:
        if decision.action != "keep":
            self._seq += 1
            decision.seq = self._seq
            self.decisions.append(decision)
            logger.warning("serve: decision #%d %s target=%s (%s)",
                           decision.seq, decision.action,
                           decision.target, decision.reason)
            if self._log_path:
                try:
                    with open(self._log_path, "a") as f:
                        f.write(decision.log_line() + "\n")
                except OSError:
                    pass  # the log is evidence, never a failure mode
        return decision

    def decision_log(self) -> List[str]:
        return [d.log_line() for d in self.decisions
                if d.action != "keep"]

    # -- triggers ------------------------------------------------------------

    def note_replica_lost(self, name: str) -> Decision:
        """A replica died mid-stream: the kill IS a drain (its queue
        and in-flight re-route) — record it so the log names the kill
        before the restoring grow."""
        return self._record(Decision(action="drain", target=name,
                                     reason="replica_lost"))

    def tick(self, now: float, live: int, draining: int,
             queue_depth: int, occupancy: float,
             below_min: bool,
             shrink_candidate: Optional[str] = None,
             handoff_depth: int = 0,
             restore_role: Optional[str] = None,
             disagg: bool = False) -> Decision:
        """One control evaluation. Returns the (single) decision; the
        cluster applies grow/drain. At most one reshape per tick —
        reshape, then re-measure, same hysteresis discipline as the
        training engine.

        Disaggregated mode (``disagg=True``, docs/serve.md): the same
        single policy governs BOTH pools, but each signal names the
        pool it grows — queue depth is admission pressure (grow
        ``prefill``), p99 and handoff depth are decode pressure (grow
        ``decode``), and a restore names the role that fell below its
        floor (``restore_role``). Targets become ``"role:1"`` strings;
        classic mode keeps the historical ``"1"``."""
        p = self.policy
        if now - self._last_tick_t < p.tick_interval_s \
                and not below_min:
            return Decision(action="keep")
        self._last_tick_t = now
        active = live - draining
        if p.overload:
            # Brownout ladder: evaluated every full tick, logged like
            # grow/drain but never consuming the one-reshape budget —
            # degradation and capacity decisions compose.
            moved = self.brownout.tick(queue_depth)
            if moved is not None:
                level, rung, why = moved
                self._record(Decision(
                    action="brownout", target=f"level:{level}",
                    reason=f"{rung}:{why}"))
                tracing.tracer().brownout(level, rung, why, now)

        def _grow_target(role: str) -> str:
            return f"{role}:1" if disagg else "1"

        if below_min:
            # Restore the floor immediately — a kill must not wait out
            # a cooldown while requests queue on the survivors.
            self._last_grow_t = now
            target = (f"{restore_role}:1" if disagg and restore_role
                      else "1")
            return self._record(Decision(
                action="grow", target=target,
                reason="restore_capacity"))
        grow_ok = (active < p.max_replicas
                   and now - self._last_grow_t >= p.grow_cooldown_s)
        if grow_ok and p.target_p99_s > 0:
            p99 = self.windowed_p99()
            if p99 is not None and p99 > p.target_p99_s:
                self._last_grow_t = now
                return self._record(Decision(
                    action="grow", target=_grow_target("decode"),
                    reason="slo_p99"))
        if grow_ok and p.ttft_target_s > 0:
            # TTFT = arrival -> first token: the pressure lives in
            # admission + prefill, so the prefill pool grows.
            ttft = self.windowed_ttft_p99()
            if ttft is not None and ttft > p.ttft_target_s:
                self._last_grow_t = now
                return self._record(Decision(
                    action="grow", target=_grow_target("prefill"),
                    reason="slo_ttft"))
        if grow_ok and p.tpot_target_s > 0:
            # TPOT = decode cadence after the first token: decode
            # slots are the bottleneck, so the decode pool grows.
            tpot = self.windowed_tpot_p99()
            if tpot is not None and tpot > p.tpot_target_s:
                self._last_grow_t = now
                return self._record(Decision(
                    action="grow", target=_grow_target("decode"),
                    reason="slo_tpot"))
        if grow_ok and p.max_queue_depth > 0 \
                and queue_depth > p.max_queue_depth:
            self._last_grow_t = now
            return self._record(Decision(
                action="grow", target=_grow_target("prefill"),
                reason="queue_depth"))
        if grow_ok and disagg and p.max_handoff_depth > 0 \
                and handoff_depth > p.max_handoff_depth:
            self._last_grow_t = now
            return self._record(Decision(
                action="grow", target="decode:1",
                reason="handoff_depth"))
        if (p.low_occupancy > 0 and active > p.min_replicas
                and queue_depth == 0 and handoff_depth == 0
                and occupancy < p.low_occupancy
                and shrink_candidate is not None
                and now - self._last_shrink_t >= p.shrink_cooldown_s):
            self._last_shrink_t = now
            return self._record(Decision(
                action="drain", target=shrink_candidate,
                reason="low_occupancy"))
        return Decision(action="keep")


class ServeCluster:
    """Multi-replica serving: a router over per-replica batchers, the
    SLO controller, and a virtual-time run loop (the CPU-simulated
    server of docs/serve.md — deterministic by construction: the clock
    is decode rounds x ``step_s``).

    ``engine_factory(name) -> DecodeEngine`` starts replicas (grow and
    kill-restore reuse it); ``host_manager`` (optional, the elastic
    ``HostManager``) maps replicas onto hosts — a killed replica
    blacklists its host and grow requires a usable one.

    ``roles`` switches on prefill/decode DISAGGREGATION
    (docs/serve.md): ``{"prefill": 1, "decode": 2}`` starts one
    prefill-role and two decode-role replicas instead of ``replicas``
    mixed ones. Prefill replicas admit + prefill and export every
    finished slot as a warm-KV wire blob; the cluster hands each blob
    to the decode replica with the most free slots the same round
    (``pending_handoffs`` buffers the overflow — its depth is the
    back-pressure signal ``max_handoff_depth`` watches). The per-role
    counts are FLOORS: a kill restores the lost role, growth lands in
    the role each decision names, and shrink only touches the decode
    pool above its floor. ``roles=None`` (default) is the classic
    mixed cluster, byte-identical to before.
    """

    def __init__(self, engine_factory: Callable[[str], DecodeEngine],
                 policy: Optional[SLOPolicy] = None, replicas: int = 2,
                 step_s: float = 0.05, log_path: Optional[str] = None,
                 host_manager=None,
                 host_of: Optional[Callable[[str], str]] = None,
                 roles: Optional[Dict[str, int]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.factory = engine_factory
        # Wall-clock source for the run() report only; a virtual-time
        # harness injects its own so the report stays deterministic.
        self._clock = clock if clock is not None else time.monotonic
        self.policy = policy if policy is not None \
            else SLOPolicy.from_env()
        self.step_s = float(step_s)
        self._now = 0.0
        # Every rank of a tp replica runs this cluster over the same
        # trace on the virtual clock, so their decisions agree by
        # construction; only tp rank 0 writes the decision log and the
        # trace dump.
        self._writes_logs = getattr(engine_factory, "tp_rank", 0) == 0
        self.controller = ServeController(
            self.policy, log_path=log_path if self._writes_logs else "")
        # A cluster run is one trace session: the ledger resets here so
        # seeded repeat runs produce byte-identical summaries.
        self.tracer = tracing.tracer()
        self.tracer.begin_session()
        self.host_manager = host_manager
        self.host_of = host_of or (lambda name: name)
        self.batchers: Dict[str, ContinuousBatcher] = {}
        self.events: List[Tuple] = []
        self.completed: List[Request] = []
        # Overload-control terminal outcomes (docs/serve.md "Overload
        # & tenancy"): every admitted request lands in exactly one of
        # completed / shed / rejected — report() asserts the zero-
        # silent-drops identity over the three.
        self.shed: List[Request] = []
        self.rejected: List[Request] = []
        self._classes = (overload_lib.classes_from_policy(self.policy)
                         if self.policy.overload else {})
        self._class_priorities = (
            overload_lib.class_priorities(self.policy)
            if self.policy.overload else None)
        self.overflow: deque = deque()
        # Prefilled sequences awaiting a decode slot:
        # (request, wire_blob, generated) FIFO — disaggregation only.
        self.pending_handoffs: deque = deque()
        self.rounds = 0
        self._next_id = 0
        self._handoffs_done = 0
        # Counters from replicas that already left (kill / finished
        # drain) so report() totals survive replica churn.
        self._closed_prefill_tokens = 0
        self._closed_spec_proposed = 0
        self._closed_spec_accepted = 0
        self.disagg = roles is not None
        if self.disagg:
            unknown = sorted(set(roles) - {"prefill", "decode"})
            if unknown:
                raise ValueError(
                    f"serve roles: unknown role(s) {unknown}; known: "
                    f"['decode', 'prefill']")
            self.role_floor = {"prefill": int(roles.get("prefill", 1)),
                               "decode": int(roles.get("decode", 1))}
            for role, count in self.role_floor.items():
                if count < 1:
                    raise ValueError(
                        f"serve roles: role {role!r} needs >= 1 "
                        f"replica, got {count}")
            for _ in range(self.role_floor["prefill"]):
                self._start_replica("prefill")
            for _ in range(self.role_floor["decode"]):
                self._start_replica("decode")
        else:
            self.role_floor = {}
            for _ in range(max(1, int(replicas))):
                self._start_replica()

    # -- replica lifecycle ---------------------------------------------------

    # How many candidate replica ids _start_replica scans for one
    # whose host is usable before declaring growth blocked (replica
    # ids are monotonic; skipped ids are simply never used).
    _GROW_SCAN = 16

    def _start_replica(self, role: Optional[str] = None
                       ) -> Optional[str]:
        name = f"r{self._next_id}"
        consumed = 1
        if self.host_manager is not None:
            # The new replica's OWN host must be usable (not
            # blacklisted) and not already hosting a replica — scan
            # forward through candidate ids until one maps to such a
            # host (deterministic: a pure function of cluster state).
            usable = set(self.host_manager.current_hosts())
            used = {self.host_of(n) for n in self.batchers}
            for k in range(self._GROW_SCAN):
                cand = f"r{self._next_id + k}"
                host = self.host_of(cand)
                if host in usable and host not in used:
                    name, consumed = cand, k + 1
                    break
            else:
                self.events.append((self.rounds, "grow_blocked",
                                    "no_usable_host"))
                return None
        self._next_id += consumed
        b_role = role or "mixed"
        self.batchers[name] = ContinuousBatcher(
            self.factory(name), role=b_role,
            class_priorities=self._class_priorities)
        self.tracer.set_role(name, b_role)
        if self.disagg:
            self.events.append((self.rounds, "replica_start", name,
                                b_role))
        else:
            self.events.append((self.rounds, "replica_start", name))
        return name

    def live(self) -> List[str]:
        return sorted(self.batchers)

    def serving(self) -> List[str]:
        """Replicas accepting new ROUTED work (live, not draining, and
        not decode-role — decode replicas receive sequences only via
        the warm-KV handoff, never from the router)."""
        return sorted(n for n, b in self.batchers.items()
                      if not b.draining and b.role != "decode")

    def pool(self, role: str) -> List[str]:
        """Live non-draining replicas of one role (disaggregation)."""
        return sorted(n for n, b in self.batchers.items()
                      if not b.draining and b.role == role)

    def _close_batcher(self, b: ContinuousBatcher) -> None:
        """Fold a departing replica's monotonic counters into the
        cluster totals (report() must survive replica churn), then
        close it."""
        eng = b.engine
        self._closed_prefill_tokens += getattr(eng, "prefill_tokens", 0)
        self._closed_spec_proposed += getattr(eng, "spec_proposed", 0)
        self._closed_spec_accepted += getattr(eng, "spec_accepted", 0)
        b.close()

    def kill_replica(self, name: str) -> None:
        """Hard replica loss (the chaos site): queued + in-flight
        requests re-route to peers, the host is blacklisted, the
        controller logs the kill; the next tick restores capacity.
        Disaggregation: blobs this replica already exported into
        ``pending_handoffs`` stay valid (the wire blob is
        self-contained host data) — only its queued/in-flight requests
        re-route, and a killed prefill replica's sequences re-prefill
        from the queue at their ORIGINAL arrival position
        (``insert_by_arrival``) — zero dropped requests."""
        b = self.batchers.pop(name, None)
        if b is None:
            return
        rerouted = b.abort(self._now)
        if b.outbox:
            # Blobs exported this round but not yet pumped: still
            # valid, deliver them normally.
            self.pending_handoffs.extend(b.outbox)
            b.outbox = []
        self._close_batcher(b)
        self.events.append((self.rounds, "replica_kill", name,
                            len(rerouted)))
        self.events.extend((self.rounds, "batcher", name) + e
                           for e in b.events)
        if self.host_manager is not None:
            self.host_manager.blacklist(self.host_of(name))
        self.controller.note_replica_lost(name)
        self._reroute(rerouted)

    def _reroute(self, reqs: List[Request]) -> None:
        for req in reqs:
            req.replica = None
            if self.policy.overload and self._retry_exhausted(req):
                continue
            if not self._route(req):
                self.overflow.append(req)

    # -- overload control: admission + terminal outcomes ---------------------

    def _class_of(self, req: Request):
        return self._classes.get(req.slo_class or "latency")

    def _retry_exhausted(self, req: Request) -> bool:
        """Per-class retry budgets make shed/re-routed retries
        self-limiting: a request past its budget is SHED (a typed
        terminal outcome) instead of circling the cluster amplifying
        the overload."""
        cls = self._class_of(req)
        if cls is None or req.reroutes <= cls.retry_budget:
            return False
        self._shed(req, "retry_budget")
        return True

    def _shed(self, req: Request, reason: str) -> None:
        req.outcome = "shed"
        self.shed.append(req)
        overload_lib.record_shed(req.slo_class, reason)
        if reason == "deadline":
            # The miss is already certain at admission — count it now
            # so the miss metric stays honest under shedding.
            queue_lib.record_shed_miss()
        self.events.append((self.rounds, "shed", req.rid, reason))
        if self.tracer.enabled:
            self.tracer.shed(req, self._now, reason)

    def _reject(self, req: Request, reason: str) -> None:
        req.outcome = "rejected"
        self.rejected.append(req)
        queue_lib.record_rejection(reason)
        self.events.append((self.rounds, "reject", req.rid, reason))
        if self.tracer.enabled:
            self.tracer.reject(req, self._now, reason)

    def _admission_gate(self, req: Request) -> bool:
        """Deadline-aware admission (docs/serve.md "Overload &
        tenancy"): stamp the class deadline, apply the active brownout
        rungs, and shed requests that cannot feasibly meet their
        deadline BEFORE spending prefill on them. Returns True when
        the request reached a terminal outcome here."""
        p = self.policy
        cls = self._class_of(req)
        if cls is not None and req.deadline_s == 0 \
                and cls.deadline_s > 0:
            req.deadline_s = cls.deadline_s
        ladder = self.controller.brownout
        if ladder.active("reject_admission") \
                and req.slo_class not in ("", "latency"):
            self._reject(req, "brownout")
            return True
        if ladder.active("shed_batch") and req.slo_class == "batch":
            self._shed(req, "brownout")
            return True
        if ladder.active("clamp_tokens") \
                and req.slo_class == "throughput":
            req.max_new_tokens = min(req.max_new_tokens,
                                     max(1, p.brownout_clamp_tokens))
        if req.deadline_s > 0:
            est = overload_lib.admission_estimate(
                self.controller, req.max_new_tokens)
            if est is not None:
                budget = (req.arrival_t + req.deadline_s) - self._now
                if p.admission_safety * est > budget:
                    self._shed(req, "deadline")
                    return True
        return False

    # -- routing -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self.tracer.enabled:
            self.tracer.enqueue(req, self._now)
        if self.policy.overload and self._admission_gate(req):
            return
        if not self._route(req):
            self.overflow.append(req)

    def _route(self, req: Request) -> bool:
        """Least-loaded live non-draining replica (queued + active),
        name order breaking ties — deterministic. A bounded queue may
        refuse (``submit`` returns False); the next-least-loaded
        replica is tried before the request overflows.

        A request that already held a slot once (``reroutes`` or
        ``migrations`` > 0 — kill, drain, or no-free-slot re-prefill
        fallback) re-enters at its ARRIVAL position via
        ``insert_by_arrival``: its deadline clock has been running
        since ``arrival_t``, so it must not queue behind requests that
        arrived after it."""
        order = sorted(self.serving(), key=lambda n: (
            len(self.batchers[n].queue)
            + self.batchers[n].engine.active_count(), n))
        readmit = bool(req.reroutes or req.migrations)
        for name in order:
            if readmit:
                self.batchers[name].queue.insert_by_arrival(req)
                ok = True
            else:
                ok = self.batchers[name].queue.submit(req,
                                                      now=self._now)
            if ok:
                self.events.append((self.rounds, "route", req.rid,
                                    name, req.reroutes))
                return True
        return False

    # -- control -------------------------------------------------------------

    def queue_depth(self) -> int:
        return (sum(len(b.queue) for b in self.batchers.values())
                + len(self.overflow))

    def occupancy(self, role: Optional[str] = None) -> float:
        bs = [b for b in self.batchers.values()
              if role is None or b.role == role]
        if not bs:
            return 0.0
        return (sum(b.engine.active_count() for b in bs)
                / max(1, sum(b.engine.slots for b in bs)))

    def _shrink_candidate(self) -> Optional[str]:
        """Deterministic drain victim: the newest serving replica —
        disaggregation shrinks only the DECODE pool (a prefill replica
        is the admission path; its floor is load-bearing) and respects
        the decode floor."""
        if self.disagg:
            decode = self.pool("decode")
            if len(decode) <= self.role_floor["decode"]:
                return None
            return max(decode, key=lambda n: (int(n[1:]), n))
        serving = self.serving()
        if len(serving) <= self.policy.min_replicas:
            return None
        return max(serving, key=lambda n: (int(n[1:]), n))

    def _apply(self, decision) -> None:
        if decision.action == "grow":
            target = str(decision.target or "")
            role = target.split(":", 1)[0] if ":" in target else None
            self._start_replica(role)
        elif decision.action == "drain" \
                and decision.reason == "low_occupancy" \
                and decision.target in self.batchers:
            self.events.append((self.rounds, "drain", decision.target))
            b = self.batchers[decision.target]
            self._reroute(b.start_drain("shrink"))
            if self.policy.drain_mode == "migrate":
                self._migrate_inflight(decision.target)

    def _migrate_inflight(self, target: str) -> None:
        """The warm-KV drain default (docs/serve.md): each of the
        draining replica's in-flight sequences moves to the peer with
        the most free slots (name order breaking ties — deterministic)
        WITH its int8-wire cache blob; a sequence with no free peer
        slot falls back to a re-prefill re-route. Either way the
        drained replica empties NOW and leaves on the next tick."""
        moved = self.batchers[target].migrate_requests(self._now)
        t_role = self.batchers[target].role
        for req, blob, generated in moved:
            # A warm blob must land on a like-for-like peer: in
            # disaggregated mode a decode replica's sequences move to
            # other DECODE replicas (prefill slots never hold decoding
            # sequences); classic mode uses any serving peer.
            if self.disagg:
                peer_names = [n for n in self.pool(t_role)
                              if n != target]
            else:
                peer_names = [n for n in self.serving() if n != target]
            peers = sorted(
                peer_names,
                key=lambda n: (-self.batchers[n].migratable_slots(), n))
            placed = False
            for name in peers:
                if self.batchers[name].migratable_slots() <= 0:
                    continue
                self.batchers[name].admit_migrated(req, blob,
                                                   generated, self._now)
                self.events.append((self.rounds, "migrate", req.rid,
                                    target, name))
                placed = True
                break
            if not placed:
                # No warm landing spot: re-prefill on a peer (the
                # historical path) — zero dropped requests either way.
                req.reroutes += 1
                req.replica = None
                self._reroute([req])

    def tick(self) -> None:
        if self.host_manager is not None:
            self.host_manager.update_available_hosts()
        live = len(self.batchers)
        draining = sum(1 for b in self.batchers.values() if b.draining)
        if self.disagg:
            below_role = None
            for role in ("prefill", "decode"):
                if len(self.pool(role)) < self.role_floor[role]:
                    below_role = role
                    break
            decision = self.controller.tick(
                self._now, live, draining, self.queue_depth(),
                self.occupancy(role="decode"),
                below_role is not None,
                shrink_candidate=self._shrink_candidate(),
                handoff_depth=len(self.pending_handoffs),
                restore_role=below_role, disagg=True)
        else:
            below_min = (live - draining) < self.policy.min_replicas
            decision = self.controller.tick(
                self._now, live, draining, self.queue_depth(),
                self.occupancy(), below_min,
                shrink_candidate=self._shrink_candidate())
        self._apply(decision)
        if self.policy.overload:
            # The spec_off rung flips every engine's runtime flag (the
            # mildest rung: lose the speculative speedup, keep every
            # request); exit restores it the same way.
            spec_on = not self.controller.brownout.active("spec_off")
            for b in self.batchers.values():
                b.engine.spec_enabled = spec_on
        # Finished drains leave the cluster.
        for name in self.live():
            b = self.batchers[name]
            if b.draining and b.drained:
                self._close_batcher(b)
                self.events.append((self.rounds, "drained", name))
                self.events.extend((self.rounds, "batcher", name) + e
                                   for e in b.events)
                self.batchers.pop(name)

    # -- disaggregation: the prefill -> decode handoff wire ------------------

    def _pump_handoffs(self) -> None:
        """Deliver pending prefilled sequences to the decode pool,
        FIFO, each to the decode replica with the most free slots (name
        order breaking ties — deterministic). A blob with no free
        decode slot this round WAITS in ``pending_handoffs`` — its KV
        is already computed, so re-prefilling would waste the work; the
        deque's depth is the controller's ``max_handoff_depth``
        back-pressure signal."""
        while self.pending_handoffs:
            req, blob, generated = self.pending_handoffs[0]
            peers = sorted(
                self.pool("decode"),
                key=lambda n: (-self.batchers[n].migratable_slots(), n))
            dst = next((n for n in peers
                        if self.batchers[n].migratable_slots() > 0),
                       None)
            if dst is None:
                break
            self.pending_handoffs.popleft()
            self.batchers[dst].admit_migrated(req, blob, generated,
                                              self._now)
            _M_HANDOFFS.inc()
            self._handoffs_done += 1
            self.events.append((self.rounds, "handoff", req.rid, dst))

    # -- the run loop --------------------------------------------------------

    def run(self, trace: TrafficTrace, max_rounds: int = 100000,
            round_hook: Optional[Callable[["ServeCluster", int],
                                          None]] = None) -> Dict:
        """Drive the seeded open-loop trace to completion in virtual
        time. ``round_hook(cluster, round_idx)`` is the chaos injection
        point (e.g. kill a replica at round k). Returns the report —
        latency percentiles, token counts, occupancy, the deterministic
        event list, and the decision log."""
        pending = deque(trace.requests)
        wall0 = self._clock()
        while self.rounds < max_rounds:
            while pending and pending[0].arrival_t <= self._now:
                self.submit(pending.popleft())
            if self.overflow:
                self._reroute([self.overflow.popleft()
                               for _ in range(len(self.overflow))])
            if round_hook is not None:
                round_hook(self, self.rounds)
            self.tick()
            # Disaggregation runs the round in wire order: prefill
            # replicas first (their outboxes fill), then the handoff
            # pump, then decode replicas — a sequence prefilled this
            # round starts decoding this same round. Classic mode is
            # the historical single pass (every batcher is "mixed", so
            # the decode pass matches nothing).
            for name in self.live():
                b = self.batchers[name]
                if b.role == "decode":
                    continue
                for req in b.run_step(self._now):
                    self.completed.append(req)
                    self.controller.observe_completion(req)
                if self.tracer.enabled:
                    self.tracer.account(name, b.last_round_state,
                                        self.step_s)
                if b.outbox:
                    self.pending_handoffs.extend(b.outbox)
                    b.outbox = []
            if self.disagg:
                self._pump_handoffs()
                for name in self.live():
                    b = self.batchers[name]
                    if b.role != "decode":
                        continue
                    for req in b.run_step(self._now):
                        self.completed.append(req)
                        self.controller.observe_completion(req)
                    if self.tracer.enabled:
                        self.tracer.account(name, b.last_round_state,
                                            self.step_s)
            self.rounds += 1
            self._now += self.step_s
            if not pending and not self.queue_depth() \
                    and not self.pending_handoffs \
                    and all(b.engine.active_count() == 0
                            for b in self.batchers.values()):
                break
        wall_s = self._clock() - wall0
        if self._writes_logs:
            self.tracer.maybe_dump()
        return self.report(len(trace.requests), wall_s)

    def report(self, submitted: int, wall_s: float = 0.0) -> Dict:
        lats = [r.latency_s for r in self.completed
                if r.latency_s is not None]
        arr = np.asarray(lats) if lats else np.zeros((1,))

        def _pcts(vals):
            a = np.asarray(vals) if vals else np.zeros((1,))
            return (round(float(np.percentile(a, 50)), 6),
                    round(float(np.percentile(a, 99)), 6))

        ttft_p50, ttft_p99 = _pcts(
            [r.ttft_s for r in self.completed if r.ttft_s is not None])
        tpot_p50, tpot_p99 = _pcts(
            [r.tpot_s for r in self.completed if r.tpot_s is not None])
        qw_p50, qw_p99 = _pcts(
            [r.queue_wait_s for r in self.completed
             if r.queue_wait_s is not None])
        gen_tokens = sum(len(r.tokens) for r in self.completed)
        occ = [b.mean_occupancy() for b in self.batchers.values()
               if b.steps]
        for name in self.live():
            self.events.extend(
                (self.rounds, "batcher", name) + e
                for e in self.batchers[name].events)
        prefill_tokens = self._closed_prefill_tokens + sum(
            getattr(b.engine, "prefill_tokens", 0)
            for b in self.batchers.values())
        spec_proposed = self._closed_spec_proposed + sum(
            getattr(b.engine, "spec_proposed", 0)
            for b in self.batchers.values())
        spec_accepted = self._closed_spec_accepted + sum(
            getattr(b.engine, "spec_accepted", 0)
            for b in self.batchers.values())
        extra = {}
        if self.disagg:
            extra = {"handoffs": self._handoffs_done,
                     "pending_handoffs": len(self.pending_handoffs)}
        if self.policy.overload:
            # Terminal-outcome accounting + per-class latency tails
            # (the A/B evidence surface): completed + shed + rejected
            # must equal submitted — "dropped" means SILENTLY lost and
            # the overload chaos family asserts it stays 0.
            by_class: Dict[str, List[float]] = {}
            for r in self.completed:
                if r.latency_s is not None:
                    by_class.setdefault(r.slo_class or "latency",
                                        []).append(r.latency_s)
            extra = {
                **extra,
                "shed": len(self.shed),
                "rejected": len(self.rejected),
                "shed_by_reason": dict(sorted(
                    _count_by(e[3] for e in self.events
                              if e[1] == "shed").items())),
                "brownout_level": self.controller.brownout.level,
                "brownout_max_level":
                    self.controller.brownout.max_level,
                "class_latency_p99_s": {
                    cls: round(float(np.percentile(
                        np.asarray(vals), 99)), 6)
                    for cls, vals in sorted(by_class.items())},
                "class_completed": {
                    cls: len(vals)
                    for cls, vals in sorted(by_class.items())},
            }
        terminal = (len(self.completed) + len(self.shed)
                    + len(self.rejected))
        return {
            **extra,
            "prefill_tokens": prefill_tokens,
            "spec_proposed": spec_proposed,
            "spec_accepted": spec_accepted,
            "spec_acceptance_rate": round(
                spec_accepted / spec_proposed, 4)
            if spec_proposed else 0.0,
            "submitted": submitted,
            "completed": len(self.completed),
            "dropped": submitted - terminal,
            "rounds": self.rounds,
            "virtual_s": round(self._now, 6),
            "wall_s": round(wall_s, 3),
            "latency_p50_s": round(float(np.percentile(arr, 50)), 6),
            "latency_p99_s": round(float(np.percentile(arr, 99)), 6),
            # Per-phase percentiles from the request timeline (the
            # tracer's span metrics aggregate the same stamps).
            "ttft_p50_s": ttft_p50,
            "ttft_p99_s": ttft_p99,
            "tpot_p50_s": tpot_p50,
            "tpot_p99_s": tpot_p99,
            "queue_wait_p50_s": qw_p50,
            "queue_wait_p99_s": qw_p99,
            # Per-replica goodput attribution ({} with tracing off).
            "goodput": self.tracer.goodput_snapshot(),
            "generated_tokens": gen_tokens,
            "tokens_per_virtual_s": round(
                gen_tokens / self._now, 3) if self._now else 0.0,
            "tokens_per_wall_s": round(
                gen_tokens / wall_s, 3) if wall_s else 0.0,
            "mean_occupancy": round(
                sum(occ) / len(occ), 4) if occ else 0.0,
            "max_reroutes": max((r.reroutes for r in self.completed),
                                default=0),
            "deadline_misses": sum(1 for r in self.completed
                                   if r.deadline_missed),
            "events": self.events,
            "decisions": self.controller.decision_log(),
        }
